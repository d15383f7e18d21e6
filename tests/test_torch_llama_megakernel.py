"""The port's megakernel decode path on LLaMA and over int8 KV pages
against the JAX package's.

Both engines serve the same workloads on the same weights with
``megakernel=True``, on the geometries of ``tests/test_quant_serving.py``:
the fp LLaMA with GQA (vocab 96, hidden 32, 2 layers, 4 heads on 2 kv
heads) with fp32 pools and with int8 pools (``kv_quant``), and the 2-layer
GPT with int8 pools on the slot-contention workload. Token streams,
finish reasons and every ``stats`` counter must be EXACTLY equal to the
JAX engine's, and, with the GPT over fp32 pools too, to the port's own
``megakernel=False`` engine on the same workloads (the fused and unfused
decode paths pick the same tokens). The GPT megakernel over fp32 pools is
held against the JAX engine in tests/test_torch_engine.py. Each side runs
its workloads in one fixed order on one model per family, so all see the
same decode-bootstrap history; the JAX engines compile each geometry once
per module (interpret-mode Pallas, ~45 s for the three), the GPT one in a
spawned process of its own while this one compiles the LLaMA ones.

One decode step of the JAX ``_llama_decode_fused`` (its Pallas kernels in
interpret mode, as the JAX tests run them) is held against the port's on
the same weights and pools, fp32 and int8: logits within 1e-5, tokens and
bad flags exact, fp32 pools within 1e-5, int8 pool bytes exact and the
scales within 1e-6 relative on these tiny inputs.
"""
import numpy as np
import pytest
import torch
from test_torch_jax_refs import jax_gpt, jax_gpt_beside, named_arrays

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_gpt_from_jax,
                                     load_llama_from_jax)
from paddle_tpu_torch.models import generation as tgen

TOL = dict(rtol=1e-5, atol=1e-5)
GPT_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)
LLAMA_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                 num_kv_heads=2, max_seq_len=64)
# tests/test_quant_serving.py's engine geometries
G_GPT = dict(max_slots=2, page_size=4, max_seq_len=32, decode_window=4,
             prefill_chunk=8, q_block=2)
G_LLAMA = dict(max_slots=2, page_size=8, max_seq_len=32, decode_window=3,
               prefill_chunk=6, q_block=2, pages_per_block=1)
NAMES = ["llama_fp", "llama_kvq", "gpt_fp", "gpt_kvq"]
JAX_NAMES = ["llama_fp", "llama_kvq", "gpt_kvq"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, (n,)).astype(np.int32) for n in sizes]


def _serve(make, geo, prompts, new, **kw):
    eng = make(**geo, **kw)
    for p, n in zip(prompts, new):
        eng.add_request(p, n)
    done = eng.run()
    st = eng.stats
    eng._cache.check()
    return {"out": {rid: (c.tokens.tolist(), c.finish_reason)
                    for rid, c in done.items()},
            "stats": st,
            "conserved": (st["pages_in_use"] == 0 and st["pages_in_use"]
                          + st["pages_free"] + st["cached_pages"]
                          == eng.total_pages - 1)}


def _workloads(make_llama, make_gpt, megakernel, names=NAMES):
    """Each family's workloads in one fixed order on one model."""
    res = {}
    llama = (_prompts(3, (7, 4, 11)), (5, 6, 4))
    gpt = (_prompts(0, (5, 9, 3, 12)), (6, 4, 7, 5))
    for name, make, geo, (prompts, new), kvq in (
            ("llama_fp", make_llama, G_LLAMA, llama, False),
            ("llama_kvq", make_llama, G_LLAMA, llama, True),
            ("gpt_fp", make_gpt, G_GPT, gpt, False),
            ("gpt_kvq", make_gpt, G_GPT, gpt, True)):
        if name not in names:
            continue
        res[name] = _serve(make, geo, prompts, new, kv_quant=kvq,
                           megakernel=megakernel)
    return res


def _jax_gpt_workloads(make):
    """The JAX GPT workload of :func:`results`, run by
    :func:`jax_gpt_beside` in a process of its own."""
    return _workloads(None, make, True, ["gpt_kvq"])


@pytest.fixture(scope="module")
def jax_models():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JLConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama

    paddle.seed(0)
    jl = JLlama(JLConfig(**LLAMA_CFG))
    jl.eval()
    return {"llama": jl, "llama_named": named_arrays(jl),
            "gpt_named": named_arrays(jax_gpt(GPT_CFG))}


def _port_llama(named):
    m = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG), device="cpu")
    return load_llama_from_jax(m, named)


def _port_gpt(named):
    m = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    return load_gpt_from_jax(m, named)


@pytest.fixture(scope="module")
def results(jax_models, tmp_path_factory):
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    jm = jax_models

    def jmake(model):
        return lambda **kw: JEngine(model, **kw)

    def tmake(model):
        return lambda **kw: ContinuousBatchingEngine(model, device="cpu",
                                                     **kw)

    gpt_ref, jax_res = jax_gpt_beside(
        tmp_path_factory.mktemp("llama_megakernel"), GPT_CFG,
        _jax_gpt_workloads, jm["gpt_named"],
        lambda: _workloads(jmake(jm["llama"]), None, True,
                           ["llama_fp", "llama_kvq"]))
    res = {"jax": {**jax_res, **gpt_ref}}
    for mk in (True, False):   # a fresh pair of models per side
        res[mk] = _workloads(tmake(_port_llama(jm["llama_named"])),
                             tmake(_port_gpt(jm["gpt_named"])), mk)
    return res


@pytest.mark.parametrize("name", JAX_NAMES)
def test_megakernel_engine_matches_jax(results, name):
    j, t = results["jax"][name], results[True][name]
    assert t["out"] == j["out"]
    assert list(t["stats"].items()) == list(j["stats"].items())
    assert t["conserved"] and j["conserved"]
    assert t["stats"]["kv_quant"] is name.endswith("kvq")


@pytest.mark.parametrize("name", NAMES)
def test_megakernel_engine_matches_unfused(results, name):
    f, u = results[True][name], results[False][name]
    assert f["out"] == u["out"]
    assert list(f["stats"].items()) == list(u["stats"].items())


def _step_inputs(int8, seed=3, P=14, ps=8, NP=4):
    """One decode step over 3 slots: slot 0 at position 6, slot 1 idle
    (position 0, its table row the null page), slot 2 at position 10
    (across a page boundary) with its guard lane poisoned; random pools
    (int8 bytes and scales with ``int8``) of 2 kv heads of 8."""
    rng = np.random.default_rng(seed)
    shape = (2, P, ps, 8)
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(4)]
        pools += [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32)
                  for _ in range(4)]
    else:
        pools = [rng.normal(size=shape).astype(np.float32)
                 for _ in range(4)]
    bt = (rng.permutation(np.arange(1, P))[:3 * NP]
          .reshape(3, NP).astype(np.int32))
    bt[1] = 0
    tok = np.asarray([[17], [0], [42]], np.int64)
    pos = np.asarray([6, 0, 10], np.int64)
    poison = np.asarray([0.0, 0.0, np.nan], np.float32)
    return pools, bt, tok, pos, poison


@pytest.mark.parametrize("int8", [False, True])
def test_llama_decode_step_matches_jax(jax_models, int8):
    """The slice at the step level: JAX ``_llama_decode_fused`` (Pallas
    interpret) against the port's (plain versions) on the same weights
    and pools."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.models.generation import _llama_decode_fused as j_step

    tm = _port_llama(jax_models["llama_named"])
    pools, bt, tok, pos, poison = _step_inputs(int8)

    def jt(a):
        return Tensor(jnp.asarray(a))

    def tt(a):
        return torch.tensor(np.ascontiguousarray(a))

    with paddle.no_grad():
        jl, jn, jb, jc = j_step(jax_models["llama"],
                                jt(tok.astype(np.int32)),
                                jt(pos.astype(np.int32)), jt(bt),
                                [jt(p) for p in pools], jt(poison))
    with torch.no_grad():
        tl, tn, tb, tc = tgen._llama_decode_fused(
            tm, tt(tok), tt(pos), tt(bt), [tt(p) for p in pools],
            tt(poison))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn.numpy()))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb.numpy()))
    assert tb.tolist() == [False, False, True]
    assert len(tc) == len(jc) == len(pools)
    for j, t in zip(jc, tc):
        j = np.asarray(j.numpy())
        if j.dtype == np.int8:
            np.testing.assert_array_equal(t.numpy(), j)
        elif int8:
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(t.numpy(), j, **TOL)


def test_fused_llama_step_reads_every_parameter():
    """Every parameter of the LLaMA (embedding, each layer's norms, q/k/v/o
    and gate/up/down projections, the final norm and the untied head) is
    on the port's fused step: changing any one of them changes it, as in
    the JAX package's ``_llama_decode_fused``."""
    gen = torch.Generator().manual_seed(0)
    m = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG), device="cpu",
                         generator=gen)
    pools, bt, tok, pos, _ = _step_inputs(False)

    def tt(a):
        return torch.tensor(np.ascontiguousarray(a))

    def step():
        with torch.no_grad():
            lg, *_ = tgen._llama_decode_fused(
                m, tt(tok), tt(pos), tt(bt), [tt(p) for p in pools],
                torch.zeros(3))
        return lg

    base = step()
    for name, p in m.named_parameters():
        keep = p.detach().clone()
        with torch.no_grad():
            p.add_(0.5)
        assert not torch.equal(step(), base), name
        with torch.no_grad():
            p.copy_(keep)
