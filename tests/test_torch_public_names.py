"""Public names the ported modules lacked, and the threefry primitives'
default device, each against the JAX object.

- ``AmpModel.properties`` and ``AmpModel.unwrapped``;
- ``DistributedDataParallel.unwrapped``;
- ``ProcessGroup.group_size``: None for the world, the group length
  otherwise (``size()`` is unchanged);
- ``FusedAdam(amsgrad=True)`` raises the JAX package's ``RuntimeError``;
- the sequence-parallel names of ``apex_tpu.parallel`` (``ring_attention``,
  ``ulysses_attention``, ``make_ring_attention``,
  ``make_ulysses_attention``) are the port's ``parallel`` names too, with
  the adapters' ``onef1b_compatible`` marks, beside the new collectives
  ``ppermute_g`` and ``all_to_all_g``;
- the pipeline names (``gpipe_spmd``, ``onef1b_spmd``,
  ``onef1b_loss_and_grad``, ``pipeline_apply``; ``PipelinedBert``,
  ``PipelinedGPT`` and their stage modules) are the port's too, beside
  the hop ``shift_g``;
- the names tensor parallelism inside the pipeline adds:
  ``parallel.tensor_parallel.pipeline_param_specs`` (``parallel.
  pipeline_param_specs``), the pipelined models' ``param_spec_tree``,
  ``shard_variables`` and ``constrain_grads``, ``BertForPreTraining(tp=)``
  with ``tp_specs``/``tp_places``, ``parallel.gather_from_group``,
  ``FusedLAMB.with_tensor_parallel``/``with_zero``; the Megatron blocks
  still import from ``models.gpt``;
- the serving names of the engine's remaining programs and of
  stochastic sampling: ``ops.SamplingParams``/``sample_tokens``
  (``serving.SamplingParams`` too), the engine's methods and copy width,
  the server's ``enable_chunked_prefill``/``prefill_chunk`` defaults,
  ``submit``/``generate``'s ``sampling``, the scheduler's ``chunk_size``
  and sampling packers, each beside the JAX object;
- the pipelined loop's and the breaker's names: ``resilience`` exports
  ``CircuitBreaker`` as the JAX package does, the server's
  ``enable_pipeline``, ``enable_breaker``, ``breaker`` and ``sample_fn``
  defaults are the JAX server's, and ``serving`` exports none of them;
- disaggregation's and streaming's names: ``serving.streaming`` exports
  ``StreamBroker`` and ``TokenStream`` as the JAX package does (and
  ``serving`` neither), the server's ``enable_disagg``,
  ``disagg_prefill_blocks``, ``prefill_max_concurrent``,
  ``enable_streaming`` and ``stream_queue_tokens`` defaults and the
  broker's are the JAX ones, and both schedulers have the hand-off;
- the offload tier's and the KV transport's names: ``serving`` exports
  ``OffloadStore`` and ``resolve_kv_offload``, ``serving.transport`` the
  reference's names, ``resilience`` ``RetryError`` and ``retry``, each
  beside the JAX object; the server's ``enable_kv_offload``,
  ``kv_offload_host_bytes``, ``kv_offload_dir`` and ``kv_transport``
  defaults, ``TransportPolicy``'s, ``OffloadStore``'s and ``retry``'s
  are the JAX ones; the prefix cache has ``attach_offload`` and
  ``promote``;
- ``ops.threefry``'s ``random_bits``, ``uniform`` and ``bernoulli`` run
  on the card unless asked for the CPU, as ``jax.random`` draws on the
  default device: without CUDA the default raises, and ``device="cpu"``
  gives ``jax.random``'s bits; ``ops.sampling.sample_tokens_host``
  likewise samples on the card unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import optax

from apex_tpu import amp as jamp
from apex_tpu import optimizers as joptimizers
from apex_tpu import parallel as jparallel
from apex_tpu.models import MLP as JaxMLP
from apex_tpu_torch import amp, parallel
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.models import MLP
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.optimizers import FusedAdam, transforms


@pytest.fixture(autouse=True)
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def test_amp_model_properties_and_unwrapped():
    jmodule = JaxMLP(features=(8,))
    jmodel, _ = jamp.initialize(jmodule, optax.sgd(0.1), opt_level="O2",
                                verbosity=0)
    module = MLP(features=(8,), device="cpu")
    model, _ = amp.initialize(module, transforms.sgd(0.1), opt_level="O2",
                              verbosity=0)
    assert jmodel.unwrapped is jmodule and model.unwrapped is module
    got, want = model.properties.options, jmodel.properties.options
    assert set(got) == set(want)
    for k in want:          # the half dtype is each framework's bfloat16
        assert str(got[k]).replace("torch.", "") == str(
            getattr(want[k], "__name__", want[k])), k
    jddp = jparallel.DistributedDataParallel(jmodel)
    ddp = parallel.DistributedDataParallel(model)
    assert jddp.unwrapped is jmodel and ddp.unwrapped is model


def test_process_group_size():
    world = jparallel.ProcessGroup()
    grouped = jparallel.ProcessGroup("data", ((0, 1), (2, 3)))
    assert parallel.ProcessGroup().group_size is world.group_size is None
    assert parallel.ProcessGroup(((0, 1), (2, 3))).group_size \
        == grouped.group_size == 2


def test_fused_adam_refuses_amsgrad():
    with pytest.raises(RuntimeError) as want:
        joptimizers.FusedAdam(amsgrad=True)
    with pytest.raises(RuntimeError) as got:
        FusedAdam(amsgrad=True)
    assert str(got.value) == str(want.value) \
        == "FusedAdam does not support the AMSGrad variant."


def test_threefry_draws_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = threefry.PRNGKey(3)
    for draw in (lambda: threefry.random_bits(key, (4,)),
                 lambda: threefry.uniform(key, (4,)),
                 lambda: threefry.bernoulli(key, 0.5, (4,))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            draw()
    jkey = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        threefry.random_bits(key, (4,), device="cpu").numpy()
        .astype(np.uint32),
        np.asarray(jax.random.bits(jkey, (4,), np.uint32)))
    np.testing.assert_array_equal(
        threefry.bernoulli(key, 0.5, (4,), device="cpu").numpy(),
        np.asarray(jax.random.bernoulli(jkey, 0.5, (4,))))


def test_sample_tokens_host_samples_on_the_card_unless_asked(monkeypatch):
    from apex_tpu.ops import sampling as jsampling
    from apex_tpu_torch.ops import sampling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lg = np.random.default_rng(0).standard_normal((3, 17)).astype(np.float32)
    args = (lg, np.array([0.0, 0.8, 1.0], np.float32),
            np.array([0, 5, 0], np.int32), np.array([1.0, 1.0, 0.9],
                                                     np.float32),
            np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampling.sample_tokens_host(*args)
    ids, fin = sampling.sample_tokens_host(*args, device="cpu")
    assert ids.device.type == "cpu" and bool(fin.all())
    assert ids[0].item() == int(np.argmax(lg[0]))
    want, _ = jsampling.sample_tokens_host(*args)
    assert ids.numpy().tolist() == np.asarray(want).tolist()


def test_sequence_parallel_names():
    names = ("ring_attention", "ulysses_attention", "make_ring_attention",
             "make_ulysses_attention")
    for name in names:
        assert name in jparallel.__all__ and name in parallel.__all__, name
        assert callable(getattr(parallel, name))
    for name in ("ppermute_g", "all_to_all_g"):
        assert name in parallel.__all__
    for make in ("make_ring_attention", "make_ulysses_attention"):
        assert getattr(parallel, make)(None).onef1b_compatible == \
            getattr(jparallel, make)("sp").onef1b_compatible


def test_pipeline_names():
    """The pipeline names of ``apex_tpu.parallel`` and ``apex_tpu.models``
    (and the stage modules of its ``bert`` and ``gpt``) are the port's
    too; the port adds the hop and the unstacked forms."""
    from apex_tpu import models as jmodels
    from apex_tpu_torch import models
    for name in ("gpipe_spmd", "onef1b_spmd", "onef1b_loss_and_grad",
                 "pipeline_apply"):
        assert name in jparallel.__all__ and name in parallel.__all__, name
        assert callable(getattr(parallel, name))
    for name in ("shift_g", "gpipe", "onef1b"):
        assert name in parallel.__all__
    from apex_tpu.models import bert as jbert, gpt as jgpt
    for name in ("PipelinedBert", "PipelinedGPT"):
        assert hasattr(jmodels, name) and name in models.__all__, name
    for mod, names in ((jbert, ("BertEmbeddings", "BertStage",
                                "BertHeads")),
                       (jgpt, ("GPTEmbed", "GPTStage"))):
        for name in names:
            assert hasattr(mod, name) and name in models.__all__, name
    for name in ("_microbatch_ids", "_stage_dropout_key", "_dropout_setup"):
        assert hasattr(jmodels.PipelinedBert, name)
        assert hasattr(models.PipelinedBert, name)
        assert hasattr(models.PipelinedGPT, name)


def test_sequence_shard_names():
    """The names the composed axes add: ``ops.vocab_parallel_lm_loss_shard``
    (at a world of one, the sum of ``models.gpt.lm_loss_shard``'s and the
    JAX ``lm_loss`` times ``B * (S - 1)``), ``models.pipelined_common.
    gather_seq`` (the tensor itself at a world of one) and the mesh's
    ``"data_sp"`` group (the model-index group of the reduction)."""
    import jax.numpy as jnp
    from apex_tpu import models as jmodels
    from apex_tpu_torch import ops
    from apex_tpu_torch.models import gpt as tg
    from apex_tpu_torch.models.pipelined_common import gather_seq
    assert "vocab_parallel_lm_loss_shard" in ops.__all__
    rng = np.random.RandomState(0)
    hidden = torch.from_numpy(rng.standard_normal((2, 8, 16))
                              .astype(np.float32))
    wte = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 24, (2, 8)))
    mesh = parallel.Mesh({"model": 1, "sp": 1},
                         {"model": parallel.mesh.WORLD,
                          "sp": parallel.mesh.WORLD})
    got = ops.vocab_parallel_lm_loss_shard(hidden, wte, ids, mesh)
    logits = hidden @ wte.T
    assert torch.allclose(got, tg.lm_loss_shard(logits, ids, 0, 1),
                          rtol=1e-6)
    want = float(jmodels.lm_loss(jnp.asarray(logits.numpy()),
                                 jnp.asarray(ids.numpy()))) * 2 * 7
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    assert gather_seq(hidden, None) is hidden
    assert "data_sp" in parallel.Mesh.__doc__


def test_tensor_parallel_pipeline_names():
    """TP inside the pipeline: the JAX names are the port's, and at a
    world of one the new pieces are the plain model's."""
    import inspect

    from apex_tpu import models as jmodels
    from apex_tpu.parallel import tensor_parallel as jtp
    from apex_tpu_torch import models
    from apex_tpu_torch.models import bert as tb, gpt as tg
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import tensor_parallel as tp
    assert callable(jtp.pipeline_param_specs)
    assert parallel.pipeline_param_specs is tp.pipeline_param_specs
    assert "pipeline_param_specs" in parallel.__all__
    assert "gather_from_group" in parallel.__all__
    for name in ("param_spec_tree", "shard_variables", "constrain_grads"):
        assert hasattr(jmodels.PipelinedBert, name)
        assert hasattr(models.PipelinedBert, name), name
        assert hasattr(models.PipelinedGPT, name), name
    assert "tp" in inspect.signature(models.BertForPreTraining).parameters
    for name in ("RowParallelLinear", "VocabParallelEmbedding", "_TP",
                 "_head_slice_dropout", "_tp_place"):
        assert hasattr(tg, name), name
    for name in ("with_tensor_parallel", "with_zero"):
        assert callable(getattr(FusedLAMB(), name))
    cfg = tb.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=16)
    model = tb.BertForPreTraining(cfg, device="cpu", seed=0)
    assert model.tp_specs() == {}
    assert all(not p.spec for p in model.tp_places().values())
    x = torch.ones(2, 3)
    assert parallel.gather_from_group(x, None) is x
    specs = parallel.pipeline_param_specs(
        {"stages.layer_0.intermediate.weight": torch.empty(64, 32),
         "embed.word_embeddings.weight": torch.empty(64, 32),
         "heads.pooler.weight": torch.empty(32, 32)},
        parallel.Mesh({"pipe": 2, "model": 2}), parallel.bert_tp_rules(),
        "pipe")
    assert specs == {"stages.layer_0.intermediate.weight":
                     ("pipe", "model", None),
                     "embed.word_embeddings.weight": ("model", None),
                     "heads.pooler.weight": ()}
    sd = {"encoder.layer_0.intermediate.weight": torch.arange(64.)
          .reshape(8, 8)}
    assert tp.tp_slice(sd, parallel.bert_tp_rules(), 2, 1, 0) == sd
    half = tp.tp_slice(sd, parallel.bert_tp_rules(), 2, 2, 1)
    assert torch.equal(half["encoder.layer_0.intermediate.weight"],
                       sd["encoder.layer_0.intermediate.weight"][4:])


def test_serving_programs_and_sampling_names_match_jax():
    import inspect

    from apex_tpu import ops as jops
    from apex_tpu import serving as jserving
    from apex_tpu.serving import api as japi
    from apex_tpu.serving import engine as jengine
    from apex_tpu_torch import ops, serving
    from apex_tpu_torch.serving import api, engine

    for name in ("SamplingParams", "sample_tokens", "finite_rows",
                 "greedy_argmax"):
        assert name in jops.__all__ and name in ops.__all__, name
    for name in ("processed_logits", "sample_tokens_host",
                 "sampling_noise"):
        assert hasattr(jops.sampling, name) and name in ops.__all__, name
    assert "SamplingParams" in jserving.__all__
    assert serving.SamplingParams is ops.SamplingParams
    assert [f.name for f in dataclasses.fields(ops.SamplingParams)] == \
        [f.name for f in dataclasses.fields(jops.SamplingParams)]
    assert engine._COPY_WIDTH == jengine._COPY_WIDTH
    assert api.DEFAULT_PREFILL_CHUNK == japi.DEFAULT_PREFILL_CHUNK
    for name in ("chunk_prefill", "chunk_prefill_sampled", "verify",
                 "verify_sampled", "copy_blocks", "copy_blocks_from",
                 "export_blocks", "import_blocks", "swap_params",
                 "_block_slots"):
        want = inspect.signature(getattr(jengine.DecodeEngine, name))
        got = inspect.signature(getattr(engine.DecodeEngine, name))
        assert list(got.parameters) == list(want.parameters), name
    for name in ("prefill_sampled", "decode_sampled"):
        assert "sampling" in inspect.signature(
            getattr(engine.DecodeEngine, name)).parameters
    assert "prefill_buckets" in inspect.signature(
        engine.DecodeEngine).parameters
    want = inspect.signature(jserving.InferenceServer).parameters
    got = inspect.signature(serving.InferenceServer).parameters
    for name in ("enable_chunked_prefill", "prefill_chunk"):
        assert got[name].default == want[name].default, name
    for method in ("submit", "generate"):
        assert "sampling" in inspect.signature(
            getattr(serving.InferenceServer, method)).parameters
    sched = inspect.signature(serving.Scheduler).parameters
    assert sched["chunk_size"].default is None
    for name in ("prefill_plan", "chunk_done", "sampling_inputs",
                 "prefill_sampling", "_pack_sampling"):
        assert hasattr(serving.Scheduler, name) and \
            hasattr(jserving.Scheduler, name), name
    fields = {f.name for f in dataclasses.fields(serving.Request)}
    assert {"sampling", "prefill_ctx", "prefill_sample"} <= fields


def test_pipeline_and_breaker_names_match_jax():
    import inspect

    import apex_tpu_torch
    from apex_tpu import resilience as jresilience
    from apex_tpu import serving as jserving
    from apex_tpu_torch import resilience, serving

    assert resilience.__all__ == ["CircuitBreaker", "RetryError", "retry"]
    assert set(resilience.__all__) <= set(jresilience.__all__)
    assert "resilience" in apex_tpu_torch.__all__
    assert apex_tpu_torch.resilience is resilience
    for name in ("CircuitBreaker", "OOM_ERRORS"):
        assert name not in serving.__all__ and name not in jserving.__all__
    want = inspect.signature(jserving.InferenceServer).parameters
    got = inspect.signature(serving.InferenceServer).parameters
    for name in ("enable_pipeline", "enable_breaker", "breaker",
                 "sample_fn"):
        assert got[name].default == want[name].default, name
    assert got["enable_pipeline"].default is True
    assert got["enable_breaker"].default is True
    for name in ("hold_inflight", "release_inflight"):
        assert hasattr(serving.Scheduler, name) and \
            hasattr(jserving.Scheduler, name), name
    want = inspect.signature(jresilience.CircuitBreaker).parameters
    got = inspect.signature(resilience.CircuitBreaker).parameters
    assert {k: v.default for k, v in got.items()} == \
        {k: v.default for k, v in want.items()}


def test_disagg_and_streaming_names_match_jax():
    import inspect

    from apex_tpu import serving as jserving
    from apex_tpu.serving import streaming as jstreaming
    from apex_tpu_torch import serving
    from apex_tpu_torch.serving import streaming

    assert streaming.__all__ == jstreaming.__all__ == ["StreamBroker",
                                                        "TokenStream"]
    for name in streaming.__all__:
        assert name not in serving.__all__ and name not in jserving.__all__
    want = inspect.signature(jserving.InferenceServer).parameters
    got = inspect.signature(serving.InferenceServer).parameters
    for name in ("enable_disagg", "disagg_prefill_blocks",
                 "prefill_max_concurrent", "enable_streaming",
                 "stream_queue_tokens"):
        assert got[name].default == want[name].default, name
    assert got["enable_disagg"].default is False
    assert got["enable_streaming"].default is True
    for name in ("has_free_slot", "admit_handoff", "release_handoff"):
        assert hasattr(serving.Scheduler, name) and \
            hasattr(jserving.Scheduler, name), name
    for name in ("stream", "cancel", "audit"):
        assert hasattr(serving.InferenceServer, name) and \
            hasattr(jserving.InferenceServer, name), name
    want = inspect.signature(jstreaming.StreamBroker).parameters
    got = inspect.signature(streaming.StreamBroker).parameters
    assert {k: v.default for k, v in got.items()} == \
        {k: v.default for k, v in want.items()}


def test_offload_and_transport_names_match_jax():
    import dataclasses as dc
    import inspect

    from apex_tpu import resilience as jresilience
    from apex_tpu import serving as jserving
    from apex_tpu.serving import offload as joffload
    from apex_tpu.serving import transport as jtransport
    from apex_tpu_torch import resilience, serving
    from apex_tpu_torch.serving import offload, transport

    for name in ("OffloadStore", "resolve_kv_offload"):
        assert name in serving.__all__ and name in jserving.__all__, name
    assert transport.__all__ == jtransport.__all__
    assert offload.__all__ == joffload.__all__
    assert offload.KV_OFFLOAD_ENV == joffload.KV_OFFLOAD_ENV
    assert transport.MAX_FRAME_BYTES == jtransport.MAX_FRAME_BYTES
    want = inspect.signature(jserving.InferenceServer).parameters
    got = inspect.signature(serving.InferenceServer).parameters
    for name in ("enable_kv_offload", "kv_offload_host_bytes",
                 "kv_offload_dir", "kv_transport"):
        assert got[name].default == want[name].default, name
    assert got["enable_kv_offload"].default is None
    assert got["kv_offload_host_bytes"].default == 64 << 20

    def defaults(fn):
        return {k: v.default
                for k, v in inspect.signature(fn).parameters.items()}

    assert defaults(offload.OffloadStore) == \
        defaults(joffload.OffloadStore)
    assert defaults(resilience.retry) == defaults(jresilience.retry)
    assert issubclass(resilience.RetryError, OSError)
    fields = {f.name: f.default
              for f in dc.fields(transport.TransportPolicy)}
    assert fields == {f.name: f.default
                      for f in dc.fields(jtransport.TransportPolicy)}
    assert defaults(transport.SocketTransport) == \
        defaults(jtransport.SocketTransport)
    for name in ("attach_offload", "promote"):
        assert hasattr(serving.PrefixCache, name) and \
            hasattr(jserving.PrefixCache, name), name
    assert issubclass(transport.TransportError, RuntimeError)
    for name in ("TransportConnectionError", "TransportTimeoutError",
                 "TransportFrameError"):
        assert issubclass(getattr(transport, name),
                          transport.TransportError), name
