"""The port stands alone: ``apex_tpu_torch`` (its ``parallel``, ``data``
and ``fp16_utils`` subpackages and ``entry.py`` included) and
``chip_smoke.py`` import neither JAX, flax, optax nor anything of
``apex_tpu``, and the port's entry points run on the card unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from apex_tpu_torch import entry
from apex_tpu_torch.examples import bert_main_amp, dcgan_main_amp, \
    gpt_main_amp, imagenet_main_amp, simple_main_amp
from apex_tpu_torch.data import prefetch_to_device
from apex_tpu_torch.models import MLP, BertConfig, BertForPreTraining, \
    Discriminator, Generator, GPTConfig, GPTLMHeadModel, ResNet50
from apex_tpu_torch.serving import DecodeEngine, InferenceServer

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apex_tpu")

TINY = GPTConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32)


def _sources():
    yield REPO / "chip_smoke.py"
    yield from sorted((REPO / "apex_tpu_torch").rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None        # any import of them raises
        import apex_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            apex_tpu_torch.__path__, "apex_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        for m in ("amp", "optimizers", "utils", "examples.gpt_main_amp",
                  "ops.flatten", "ops.multi_tensor", "models.bert",
                  "optimizers.fused_lamb", "optimizers.param_groups",
                  "examples.bert_main_amp", "ops.kv_quant", "entry",
                  "parallel", "parallel.LARC", "parallel.collectives",
                  "parallel.distributed", "parallel.mesh",
                  "parallel.multiproc", "parallel.sync_batchnorm", "data",
                  "data.loaders", "models.resnet", "optimizers.transforms",
                  "examples.imagenet_main_amp", "examples.ddp_simple",
                  "amp.lists", "amp.patch", "amp.functional",
                  "amp.compat_api", "fp16_utils", "fp16_utils.fp16util",
                  "fp16_utils.loss_scaler", "fp16_utils.fp16_optimizer",
                  "models.mlp", "examples.simple_main_amp",
                  "ops.unpatched", "utils.checkpoint",
                  "utils.torch_interop", "models.dcgan",
                  "examples.dcgan_main_amp"):
            assert "apex_tpu_torch." + m in mods, m
        leaked = [m for m in sys.modules
                  if m == "apex_tpu" or m.startswith("apex_tpu.")]
        assert not leaked, leaked
        print(len(mods))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 66


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    sd = GPTLMHeadModel(TINY, device="cpu", seed=0).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(TINY, sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(TINY, sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTLMHeadModel(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt_main_amp.train(TINY, batch=1, seq_len=8, steps=1)
    bert = BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertForPreTraining(bert)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bert_main_amp.train(bert, batch=1, seq_len=8, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imagenet_main_amp.train(imagenet_main_amp.parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(iter([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MLP()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simple_main_amp.train(epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Discriminator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dcgan_main_amp.train(dcgan_main_amp.parse_args([]))
    DecodeEngine(TINY, sd, device="cpu")       # asked for: fine
