"""The port's ImageFolder loader (``apex_tpu_torch.data.
image_folder_loader``) against ``tests/L0/test_image_folder.py``'s cases
and against the JAX package's loader with ``native=False`` (its PIL
pool), on a tree of JPEGs written into the test's temporary directory.

The batches must equal the JAX package's bit for bit: train (crops,
flips and the per-item seeds), eval (one pass with a short last batch)
and two shards over two epochs.
"""

import hashlib

import numpy as np
import pytest

from apex_tpu.data import image_folder_loader as jax_loader
from apex_tpu_torch.data import image_folder_loader

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgfolder")
    rng = np.random.RandomState(0)
    for cls in range(3):
        d = root / f"class{cls}"
        d.mkdir()
        for i in range(5):
            arr = (rng.randn(37, 51, 3) * 20 + 60 * cls + 40).clip(0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"i{i}.jpg")
    (root / "class0" / "notes.txt").write_text("ignore me")
    return str(root)


def _batches(it, n):
    return [next(it) for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.uint8
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_train_batches_equal_jax(dataset):
    kw = dict(batch_size=4, image_size=32, train=True, seed=3,
              num_workers=2)
    # 3 full batches an epoch: 7 batches cross two epoch boundaries
    _assert_same(_batches(image_folder_loader(dataset, **kw), 7),
                 _batches(jax_loader(dataset, native=False, **kw), 7))


def test_eval_pass_equals_jax(dataset):
    kw = dict(batch_size=4, image_size=32, train=False, loop=False)
    got = list(image_folder_loader(dataset, **kw))
    _assert_same(got, list(jax_loader(dataset, native=False, **kw)))
    assert [x.shape[0] for x, _ in got] == [4, 4, 4, 3]


def test_two_shards_two_epochs_equal_jax(dataset):
    for shard in range(2):
        kw = dict(batch_size=3, image_size=16, train=True, seed=5,
                  num_shards=2, shard_index=shard, num_workers=2)
        # 15 images / 2 shards: 7 each, 2 full batches an epoch
        _assert_same(_batches(image_folder_loader(dataset, **kw), 4),
                     _batches(jax_loader(dataset, native=False, **kw), 4))


def test_labels_follow_sorted_classes(dataset):
    x, y = next(image_folder_loader(dataset, batch_size=15, image_size=32,
                                    train=False, loop=False, shuffle=False))
    np.testing.assert_array_equal(y, np.repeat([0, 1, 2], 5))
    means = [x[y == c].mean() for c in range(3)]
    assert means[0] < means[1] < means[2]


def test_augmentation_independent_of_workers(dataset):
    a = next(image_folder_loader(dataset, batch_size=8, image_size=32,
                                 train=True, seed=7, num_workers=8))
    b = next(image_folder_loader(dataset, batch_size=8, image_size=32,
                                 train=True, seed=7, num_workers=2))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_shards_disjoint_and_cover(dataset):
    def keys(shard):
        it = image_folder_loader(dataset, batch_size=3, image_size=16,
                                 train=False, shuffle=True, seed=7,
                                 loop=False, num_shards=3, shard_index=shard)
        return [(int(lab), hashlib.md5(row.tobytes()).hexdigest())
                for x, y in it for row, lab in zip(x, y)]

    a, b, c = keys(0), keys(1), keys(2)
    assert len(a) == len(b) == len(c) == 5
    assert not (set(a) & set(b)) and not (set(a) & set(c)) \
        and not (set(b) & set(c))
    assert len(set(a) | set(b) | set(c)) == 15


def test_errors(dataset, tmp_path):
    with pytest.raises(FileNotFoundError):
        next(image_folder_loader(str(tmp_path / "missing"), batch_size=2))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no class directories"):
        image_folder_loader(str(tmp_path / "empty"), batch_size=2)
    with pytest.raises(ValueError, match="zero batches"):
        image_folder_loader(dataset, batch_size=64, train=True)
    with pytest.raises(ValueError, match="shard_index"):
        image_folder_loader(dataset, batch_size=2, num_shards=2,
                            shard_index=2)
