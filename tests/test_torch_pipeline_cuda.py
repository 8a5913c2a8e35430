"""The pipeline schedules on the card, in a world of one process.

These run only where CUDA is available (marker ``cuda``; each test skips
elsewhere) and import no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_pipeline_cuda.py

BERT-tiny with 4 layers (vocab 1024, hidden 128, 2 heads of 64, the
kernels' head dim, MLP 256) as a one-stage ``PipelinedBert`` (M 2,
flash attention, batch 4, sequence 128), fp32: 1F1B's gradients equal
GPipe's autograd within 2e-5 scale-aware, with and without dropout 0.1,
and each schedule launches exactly the kernels its ticks run (the
formulas ``chip_smoke.py``'s ``train_pp`` checks at two stages).
"""

import pytest
import torch
import torch.nn.functional as F

from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
from apex_tpu_torch.models import BertConfig, PipelinedBert
from apex_tpu_torch.ops import make_flash_attention

pytestmark = pytest.mark.cuda

B, S, M, L = 4, 128, 2, 4
TOL = 2e-5


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def make(dropout):
        cfg = BertConfig(vocab_size=1024, hidden_size=128,
                         num_hidden_layers=L, num_attention_heads=2,
                         intermediate_size=256, max_position_embeddings=S,
                         hidden_dropout_prob=dropout,
                         attention_probs_dropout_prob=dropout)
        return PipelinedBert(cfg, None, 1, M,
                             attention_fn=make_flash_attention(),
                             device="cuda", seed=0)
    return make


def _loss(mlm, nsp, tgt):
    return F.cross_entropy(mlm.float().reshape(-1, mlm.shape[-1]),
                           tgt["mlm"].reshape(-1).long()) \
        + F.cross_entropy(nsp.float(), tgt["nsp"].long())


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1)).item()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_onef1b_matches_gpipe_and_counts(model, dropout):
    pb = model(dropout)
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 1024, (B, S), device="cuda", generator=g)
    tgt = {"mlm": torch.randint(0, 1024, (B, S), device="cuda", generator=g),
           "nsp": torch.randint(0, 2, (B,), device="cuda", generator=g)}
    kw = dict(deterministic=dropout == 0.0, dropout_key=(0, 7))
    params = dict(pb.named_parameters())
    torch.cuda.synchronize()
    reset_launch_counts()
    mlm, nsp = pb(ids, **kw)
    gpipe = dict(zip(params, torch.autograd.grad(_loss(mlm, nsp, tgt),
                                                 list(params.values()))))
    torch.cuda.synchronize()
    counts = {"gpipe": launch_counts()}
    reset_launch_counts()
    loss, grads = pb.loss_and_grad_1f1b(ids, _loss, tgt, **kw)
    torch.cuda.synchronize()
    counts["1f1b"] = launch_counts()
    assert abs(loss.item() - _loss(mlm, nsp, tgt).item()) <= TOL * 10
    for k in params:
        assert rel_err(grads[k], gpipe[k]) <= TOL, k
    sfx = "_dropout" if dropout else ""
    # one stage is the last: 1F1B's forward tick only saves the input,
    # so the stage forward runs once a microbatch under either schedule
    for schedule, fwd, heads in (("gpipe", 1, 1), ("1f1b", 1, M)):
        want = {"layer_norm_fwd": 1 + fwd * 2 * L * M + heads,
                "layer_norm_bwd": 1 + 2 * L * M + heads,
                f"flash_fwd{sfx}": fwd * L * M,
                f"flash_bwd_dq{sfx}": L * M, f"flash_bwd_dkv{sfx}": L * M}
        if dropout:
            want["threefry_dropout"] = 2 + (fwd + 1) * 2 * L * M
        got = {k: v for k, v in counts[schedule].items() if v}
        assert got == want, schedule
