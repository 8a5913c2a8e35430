"""Hierarchical KV offload: host-RAM and disk tiers behind the prefix
cache.

Twin of ``apex_tpu/serving/offload.py`` (host only: numpy and the
standard library).  The prefix cache (:mod:`serving.prefix_cache`) lives
only in pool bytes, so device memory, not compute, caps how many
conversations stay warm.  An :class:`OffloadStore` holds exported KV
block payloads (:meth:`DecodeEngine.export_blocks` dicts: host numpy
leaves, their dtypes and a crc32 a leaf) in a bounded host-RAM LRU,
spilling the coldest entries to an optional disk tier.  The prefix cache
**demotes** a cold evictable block into the store at the moment eviction
would have destroyed it, and **promotes** it back through the
checksummed ``import_blocks`` path into a fresh device block when a
later admission's radix walk wants it: a cache hit spans device, host
and disk at a fixed pool size.

Keys are the radix index's chain hashes (``blake2b`` over ``parent_hash
+ chunk tokens``): a function of token CONTENT only, so they survive
block-id reuse, allocator resets and, for the disk tier, process
restarts.  Payload integrity is checked twice: the disk tier writes a
per-leaf checksum manifest and verifies it on load (a torn spill is
deleted whole and reads as a miss), and ``import_blocks`` re-verifies
the export-time crc32s before it scatters anything.  Either failure
falls back to cold prefill, so the offload tier can decline to
accelerate generation but never change it.

A payload of a bf16 pool carries its leaves as uint16 bits with
``payload["dtypes"]`` naming them (the port's export); merge, split and
the disk tier carry ``dtypes`` through.

Disk writes stage every entry under a ``.tmp-`` sibling, fsync it and
``os.rename`` it into place: a crash mid-spill leaves a stale temporary
directory (swept at startup), never a half-readable entry.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.utils.checkpoint import leaf_checksum
from apex_tpu_torch.utils.meters import CounterMeter

__all__ = ["KV_OFFLOAD_ENV", "OffloadStore", "resolve_kv_offload"]

# fleet-wide enable twin of the ``enable_kv_offload=`` kwarg (the
# reference's name, as APEX_TPU_KV_QUANT kept its): a provided kwarg
# wins; the environment only fills in a None ("not provided") kwarg
KV_OFFLOAD_ENV = "APEX_TPU_KV_OFFLOAD"

MANIFEST_FILE = "manifest.json"
_TMP_PREFIX = ".tmp-"


def resolve_kv_offload(value) -> bool:
    """Normalize an ``enable_kv_offload`` kwarg or environment value to
    a bool.

    ``None``, ``""``, ``"0"``, ``"off"``, ``"none"``, ``"false"`` and
    ``"no"`` disable; ``"1"``, ``"on"``, ``"true"`` and ``"yes"``
    enable; anything else raises (a mistyped environment variable must
    not silently run the fleet without its offload tier)."""
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("", "0", "off", "none", "false", "no"):
        return False
    if v in ("1", "on", "true", "yes"):
        return True
    raise ValueError(
        f"unknown KV offload mode {value!r} (from kwarg or "
        f"{KV_OFFLOAD_ENV}): use '1'/'on' or '0'/'off'")


def payload_nbytes(payload: dict) -> int:
    """Host bytes one exported payload occupies (every cache leaf)."""
    return sum(int(np.asarray(a).nbytes)
               for a in payload["leaves"].values())


def verify_payload(payload: dict) -> None:
    """Check one exported payload against its RECORDED per-leaf crc32s
    on the host — the test ``import_blocks`` runs, hoisted out so the
    promote walk rejects a torn payload before any device or index state
    moves.  Raises :class:`ValueError` naming the first rotten leaf."""
    for name, arr in payload["leaves"].items():
        got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        want = payload["crc"].get(name)
        if got != want:
            raise ValueError(
                f"torn offload payload: leaf {name!r} has checksum "
                f"{got} (actual) != {want} (expected); payload "
                f"rejected whole")


def _with_dtypes(out: dict, payload: dict) -> dict:
    """``out`` with ``payload``'s leaf dtype names, when it has them."""
    if payload.get("dtypes") is not None:
        out["dtypes"] = dict(payload["dtypes"])
    return out


def merge_payloads(payloads: List[dict]) -> dict:
    """Concatenate per-block payloads into one multi-block payload for a
    single batched ``import_blocks``.  The merged crcs are RECOMPUTED
    from the concatenated bytes, so callers verify each input against
    its stored checksums first (:func:`verify_payload`): the merge is
    dispatch economy, not an integrity step."""
    if len(payloads) == 1:
        return payloads[0]
    leaves = {name: np.concatenate(
        [p["leaves"][name] for p in payloads], axis=1)
        for name in payloads[0]["leaves"]}
    return _with_dtypes({
        "num_blocks": sum(p["num_blocks"] for p in payloads),
        "block_size": payloads[0]["block_size"],
        "leaves": leaves,
        "crc": {name: zlib.crc32(np.ascontiguousarray(a).tobytes())
                for name, a in leaves.items()},
    }, payloads[0])


def split_payload(payload: dict) -> List[dict]:
    """Slice one batched :meth:`DecodeEngine.export_blocks` payload into
    per-block payloads, :func:`merge_payloads`' dual on the demote path:
    eviction gathers a whole victim batch off the device at once, then
    stores each block under its own content hash.  Each slice carries
    the crc the ENGINE recorded for that block at export time
    (``block_crc``), so rot after the export is still caught per block;
    a payload without ``block_crc`` falls back to checksumming each
    slice here."""
    n = payload["num_blocks"]
    if n == 1:
        return [payload]
    bs = payload["block_size"]
    bc = payload.get("block_crc")
    out = []
    for i in range(n):
        leaves = {name: np.ascontiguousarray(
            arr[:, i * bs:(i + 1) * bs])
            for name, arr in payload["leaves"].items()}
        out.append(_with_dtypes({
            "num_blocks": 1,
            "block_size": bs,
            "leaves": leaves,
            "crc": ({name: bc[name][i] for name in leaves}
                    if bc is not None else
                    {name: zlib.crc32(a.tobytes())
                     for name, a in leaves.items()}),
        }, payload))
    return out


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class OffloadStore:
    """Bounded host-RAM tier and optional disk spill tier for exported
    KV block payloads, keyed by the prefix cache's chain hashes.

    - :meth:`put` inserts at the hot end of the host LRU; past
      ``host_bytes`` the coldest entries spill to ``spill_dir`` (atomic
      write-tmp -> rename, per-leaf checksum manifest) or, with no disk
      tier, are dropped and counted.
    - :meth:`take` pops an entry (host first, then disk): tiers are
      exclusive, so a promoted payload leaves the store; a disk entry
      failing its manifest is deleted whole and reads as a miss
      (``disk_torn``).
    - keys are content hashes, so surviving disk entries are adopted on
      construction (a restarted server keeps its cold tier).

    ``counters`` (normally the server's offload meter) accumulates
    ``spills``, ``host_dropped`` and ``disk_torn``; the demote and
    promote counts live with the prefix cache, which drives this store.
    """

    def __init__(self, host_bytes: int = 64 << 20,
                 spill_dir: Optional[str] = None,
                 counters: Optional[CounterMeter] = None):
        if int(host_bytes) < 0:
            raise ValueError(
                f"host_bytes must be >= 0, got {host_bytes}")
        self.host_bytes = int(host_bytes)
        self.spill_dir = spill_dir
        self.counters = (counters if counters is not None
                         else CounterMeter())
        self._host: "OrderedDict[bytes, dict]" = OrderedDict()
        self._host_used = 0
        self._disk: Dict[bytes, None] = {}
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            for name in sorted(os.listdir(spill_dir)):
                path = os.path.join(spill_dir, name)
                if name.startswith(_TMP_PREFIX):
                    # a crash mid-spill: never renamed, never valid
                    shutil.rmtree(path, ignore_errors=True)
                    continue
                try:
                    key = bytes.fromhex(name)
                except ValueError:
                    continue    # a foreign file, not ours to manage
                if os.path.isfile(os.path.join(path, MANIFEST_FILE)):
                    self._disk[key] = None

    # -- introspection ----------------------------------------------------

    @property
    def host_entries(self) -> int:
        return len(self._host)

    @property
    def host_used_bytes(self) -> int:
        return self._host_used

    @property
    def disk_entries(self) -> int:
        return len(self._disk)

    def __contains__(self, key: bytes) -> bool:
        return key in self._host or key in self._disk

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def stats(self) -> dict:
        return {
            "host_entries": len(self._host),
            "host_bytes": self._host_used,
            "host_bytes_cap": self.host_bytes,
            "disk_entries": len(self._disk),
            "spill_dir": self.spill_dir,
        }

    # -- the store --------------------------------------------------------

    def put(self, key: bytes, payload: dict) -> None:
        """Insert ``payload`` at the hot end of the host tier, spilling
        (or dropping) the coldest entries past the byte bound.
        Content-addressed: re-putting a present key only refreshes its
        recency."""
        if key in self._host:
            self._host.move_to_end(key)
            return
        if key in self._disk:
            return
        nbytes = payload_nbytes(payload)
        if nbytes > self.host_bytes:
            # would never fit the host tier: straight to disk (or
            # dropped: an oversized payload must not wedge the LRU)
            if not self._spill(key, payload):
                self.counters.incr("host_dropped")
            return
        self._host[key] = payload
        self._host_used += nbytes
        while self._host_used > self.host_bytes and self._host:
            vkey, victim = self._host.popitem(last=False)
            self._host_used -= payload_nbytes(victim)
            if not self._spill(vkey, victim):
                self.counters.incr("host_dropped")

    def take(self, key: bytes) -> Optional[Tuple[dict, str]]:
        """Pop ``key``'s payload and the tier it came from (``"host"`` /
        ``"disk"``), or None on a miss.  A disk entry that fails its
        manifest is deleted and reads as a miss."""
        payload = self._host.pop(key, None)
        if payload is not None:
            self._host_used -= payload_nbytes(payload)
            return payload, "host"
        if key in self._disk:
            payload = self._load(key)
            if payload is not None:
                return payload, "disk"
        return None

    def clear(self) -> None:
        """Drop the host tier (disk entries stay: content-addressed,
        they remain valid across allocator resets)."""
        self._host.clear()
        self._host_used = 0

    # -- disk tier --------------------------------------------------------

    def _spill(self, key: bytes, payload: dict) -> bool:
        """Atomically publish ``payload`` as ``spill_dir/<key.hex()>/``
        (write-tmp -> fsync -> rename) with a per-leaf checksum manifest
        that also records the leaf dtype names.  False = no disk tier
        (the caller counts the drop)."""
        if self.spill_dir is None:
            return False
        hexkey = key.hex()
        final = os.path.join(self.spill_dir, hexkey)
        if key in self._disk and os.path.isdir(final):
            return True         # content-addressed: already published
        tmp = os.path.join(self.spill_dir, _TMP_PREFIX + hexkey)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {
            "num_blocks": int(payload["num_blocks"]),
            "block_size": int(payload["block_size"]),
            "crc": {name: int(c)
                    for name, c in payload["crc"].items()},
            "leaves": {},
        }
        if payload.get("dtypes") is not None:
            manifest["dtypes"] = dict(payload["dtypes"])
        for i, name in enumerate(sorted(payload["leaves"])):
            arr = np.ascontiguousarray(
                np.asarray(payload["leaves"][name]))
            fname = f"leaf{i}.npy"
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][name] = {
                "file": fname, "checksum": leaf_checksum(arr)}
        mpath = os.path.join(tmp, MANIFEST_FILE)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        os.rename(tmp, final)
        _fsync_path(self.spill_dir)
        self._disk[key] = None
        self.counters.incr("spills")
        return True

    def _load(self, key: bytes) -> Optional[dict]:
        """Read one disk entry back, verifying every leaf against the
        checksum its MANIFEST recorded at write time (the only reference
        that can convict torn bytes).  Any failure deletes the entry
        whole and returns None; success deletes it too (tiers are
        exclusive: the payload is leaving the store)."""
        root = os.path.join(self.spill_dir, key.hex())
        try:
            with open(os.path.join(root, MANIFEST_FILE)) as f:
                manifest = json.load(f)
            leaves = {}
            for name, ent in manifest["leaves"].items():
                arr = np.load(os.path.join(root, ent["file"]))
                got = leaf_checksum(arr)
                if got != ent["checksum"]:
                    raise ValueError(
                        f"offload spill {key.hex()} leaf {name!r}: "
                        f"checksum {got} != recorded "
                        f"{ent['checksum']}")
                leaves[name] = arr
            payload = _with_dtypes({
                "num_blocks": int(manifest["num_blocks"]),
                "block_size": int(manifest["block_size"]),
                "leaves": leaves,
                "crc": {name: int(c)
                        for name, c in manifest["crc"].items()},
            }, manifest)
        except (OSError, ValueError, KeyError):
            self.counters.incr("disk_torn")
            self._disk.pop(key, None)
            shutil.rmtree(root, ignore_errors=True)
            return None
        self._disk.pop(key, None)
        shutil.rmtree(root, ignore_errors=True)
        return payload
