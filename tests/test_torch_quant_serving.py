"""The port's LLaMA and quantized serving against the JAX package's.

Both engines serve the same workloads on the same weights, on the
geometries of ``tests/test_quant_serving.py``: a fp LLaMA with GQA
(vocab 96, hidden 32, 2 layers, 4 heads, 2 kv heads), that LLaMA with
int8 KV pages (``kv_quant``), a weight-only-quantized twin of it
(``quantization.weight_only_quantize``, the JAX package's default: every
projection and the untied ``lm_head``) with ``kv_quant``, and the
2-layer GPT with ``kv_quant`` on the slot-contention and the
shared-prefix / copy-on-write workloads. Token streams, finish reasons
and every ``stats`` counter must be EXACTLY equal; the int8 pool bytes
equal except where a rounding tie of ``kv_quantize`` flips one step
(|delta| <= 1, the count reported), the scales within 1e-6 relative (the
K/V vectors come out of another summation order).

The JAX engines compile each geometry once per module (interpret-mode
Pallas), and each side's workloads run in one fixed order on one model
per family, so both see the same decode-bootstrap history. The JAX GPT
workloads run in a spawned process of their own while this one runs the
LLaMA ones.
"""
import numpy as np
import pytest
import torch
from test_torch_jax_refs import jax_gpt, jax_gpt_beside, named_arrays

from paddle_tpu_torch.core import state as t_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_gpt_from_jax,
                                     load_llama_from_jax)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.quantization import (WeightOnlyLinear,
                                           weight_only_quantize)

GPT_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)
LLAMA_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                 num_kv_heads=2, max_seq_len=64)
# tests/test_quant_serving.py's engine geometries
G_GPT = dict(max_slots=2, page_size=4, max_seq_len=32, decode_window=4,
             prefill_chunk=8, q_block=2)
G_LLAMA = dict(max_slots=2, page_size=8, max_seq_len=32, decode_window=3,
               prefill_chunk=6, q_block=2, pages_per_block=1)


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


def _summary(eng, done):
    st = eng.stats
    eng._cache.check()
    return {
        "out": {rid: (c.tokens.tolist(), c.finish_reason)
                for rid, c in done.items()},
        "stats": st,
        "conserved": (st["pages_in_use"] == 0 and st["pages_in_use"]
                      + st["pages_free"] + st["cached_pages"]
                      == eng.total_pages - 1),
    }


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.numpy())


def _serve(make, geo, prompts, new, res, name, **kw):
    eng = make(**geo, **kw)
    for p, n in zip(prompts, new):
        eng.add_request(p, n)
    res[name] = _summary(eng, eng.run())
    res[name]["pools"] = [_np(p) for p in eng._caches]


def _llama_workloads(make_fp, make_wo, res):
    prompts = _prompts(3, (7, 4, 11))
    new = (5, 6, 4)
    _serve(make_fp, G_LLAMA, prompts, new, res, "llama_fp")
    _serve(make_fp, G_LLAMA, prompts, new, res, "llama_kvq", kv_quant=True)
    _serve(make_wo, G_LLAMA, prompts, new, res, "llama_wo_kvq",
           kv_quant=True)


def _gpt_workloads(make, res):
    _serve(make, G_GPT, _prompts(0, (5, 9, 3, 12)), (6, 4, 7, 5), res,
           "gpt_kvq", kv_quant=True)
    # shared prefix (3 full pages) then a page-aligned full hit, whose
    # divergence page is copied (copy-on-write, scale pools included)
    rng = np.random.default_rng(29)
    shared = rng.integers(0, 96, (12,)).astype(np.int32)
    tails = [rng.integers(0, 96, (n,)).astype(np.int32)
             for n in (3, 2, 5, 1)]
    cow = rng.integers(0, 96, (8,)).astype(np.int32)
    eng = make(**G_GPT, kv_quant=True)
    for t, n in zip(tails, (6, 5, 4, 6)):
        eng.add_request(np.concatenate([shared, t]), n)
    done = eng.run()
    eng.add_request(cow, 6)
    done.update(eng.run())
    base = eng.stats["prefill_tokens_computed"]
    eng.add_request(cow, 6)
    done.update(eng.run())
    res["gpt_kvq_prefix"] = _summary(eng, done)
    res["gpt_kvq_prefix"]["cow_recompute"] = \
        eng.stats["prefill_tokens_computed"] - base
    res["gpt_kvq_prefix"]["pools"] = [_np(p) for p in eng._caches]


def _jax_named_quantized(jm):
    """The JAX model's arrays by name, with each WeightOnlyLinear's
    ``qweight`` and ``scale`` (its ``state_dict()`` leaves them out)."""
    from paddle_tpu.quantization import WeightOnlyLinear as JWOL
    named = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, sub in jm.named_sublayers():
        if isinstance(sub, JWOL):
            named[name + ".qweight"] = np.asarray(sub.qweight.numpy())
            named[name + ".scale"] = np.asarray(sub.scale.numpy())
    return named


def _jax_gpt_workloads(make):
    """The JAX GPT workloads of :func:`results`, run by
    :func:`jax_gpt_beside` in a process of their own."""
    res = {}
    _gpt_workloads(make, res)
    return res


@pytest.fixture(scope="module")
def jax_models():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JLConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu.quantization import weight_only_quantize as j_woq

    paddle.seed(0)
    jl = JLlama(JLConfig(**LLAMA_CFG))
    jl.eval()
    paddle.seed(0)
    jwo = j_woq(JLlama(JLConfig(**LLAMA_CFG)))
    jwo.eval()
    jg = jax_gpt(GPT_CFG)
    return {"llama": jl, "llama_wo": jwo, "gpt": jg,
            "llama_named": named_arrays(jl),
            "llama_wo_named": _jax_named_quantized(jwo),
            "gpt_named": named_arrays(jg)}


def _port_llama(named, quantized=False):
    m = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG), device="cpu")
    if quantized:
        weight_only_quantize(m)
    return load_llama_from_jax(m, named)


@pytest.fixture(scope="module")
def results(jax_models, tmp_path_factory):
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    jm = jax_models
    res = {"jax": {}, "port": {}}

    def jmake(model):
        return lambda **kw: JEngine(model, **kw)

    def tmake(model):
        return lambda **kw: ContinuousBatchingEngine(model, device="cpu",
                                                     **kw)

    gpt_refs, _ = jax_gpt_beside(
        tmp_path_factory.mktemp("quant_serving"), GPT_CFG,
        _jax_gpt_workloads, jm["gpt_named"],
        lambda: _llama_workloads(jmake(jm["llama"]), jmake(jm["llama_wo"]),
                                 res["jax"]))
    res["jax"].update(gpt_refs)
    tg = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    load_gpt_from_jax(tg, jm["gpt_named"])
    _llama_workloads(tmake(_port_llama(jm["llama_named"])),
                     tmake(_port_llama(jm["llama_wo_named"], True)),
                     res["port"])
    _gpt_workloads(tmake(tg), res["port"])
    return res


NAMES = ["llama_fp", "llama_kvq", "llama_wo_kvq", "gpt_kvq",
         "gpt_kvq_prefix"]


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax(results, name):
    j, t = results["jax"][name], results["port"][name]
    assert t["out"] == j["out"]
    assert list(t["stats"].items()) == list(j["stats"].items())
    assert t["conserved"] and j["conserved"]
    assert t["stats"]["kv_quant"] is name.endswith(("kvq", "kvq_prefix"))


def test_workloads_exercise_their_paths(results):
    t = results["port"]
    for name in NAMES:
        st = t[name]["stats"]
        assert all(r == "length" for _, r in t[name]["out"].values())
        assert st["mixed_steps"] >= 2 and st["decode_dispatches"] > \
            st["mixed_steps"] or name == "gpt_kvq_prefix"
    pre = t["gpt_kvq_prefix"]
    assert pre["stats"]["cache_hits"] >= 3
    assert pre["cow_recompute"] == results["jax"]["gpt_kvq_prefix"][
        "cow_recompute"] == 1
    # a tiny model's int8 KV and int8 weights leave its greedy streams
    # where the fp engine put them
    assert t["llama_kvq"]["out"] == t["llama_fp"]["out"]


@pytest.mark.parametrize("name", ["llama_kvq", "llama_wo_kvq", "gpt_kvq",
                                  "gpt_kvq_prefix"])
def test_int8_pools_match_jax(results, name):
    jp, tp = results["jax"][name]["pools"], results["port"][name]["pools"]
    n = len(tp) // 2
    assert len(tp) == len(jp) == 4 * 2 and n == 4
    flips = 0
    for j, t in zip(jp[:n], tp[:n]):
        assert t.dtype == np.int8 and j.dtype == np.int8
        # page 0 is the null page every padding token writes: skip it
        d = np.abs(t[:, 1:].astype(np.int32) - j[:, 1:].astype(np.int32))
        assert d.max() <= 1
        flips += int((d > 0).sum())
    for j, t in zip(jp[n:], tp[n:]):
        assert t.dtype == np.float32
        np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=1e-6, atol=0)
    total = sum(t[:, 1:].size for t in tp[:n])
    print(f"{name}: {flips} of {total} int8 pool bytes differ by one step "
          f"from the JAX engine's")
    assert flips <= total // 1000


def test_quant_engine_layout(jax_models):
    tg = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    fp = ContinuousBatchingEngine(tg, device="cpu", **G_GPT)
    q = ContinuousBatchingEngine(tg, device="cpu", kv_quant=True, **G_GPT)
    L, d = 2, 8
    assert len(fp._caches) == 2 * L and len(q._caches) == 4 * L
    assert all(p.dtype == torch.int8 and p.dim() == 4
               for p in q._caches[:2 * L])
    assert all(p.dtype == torch.float32 and p.dim() == 3
               for p in q._caches[2 * L:])
    assert q._caches[2 * L].shape == q._caches[0].shape[:3]
    fs, qs = fp.stats, q.stats
    assert qs["kv_page_bytes"] == fs["kv_page_bytes"] * (d + 4) // (4 * d)
    assert qs["kv_page_bytes"] * 2 <= fs["kv_page_bytes"]
    assert qs["kv_quant"] is True and fs["kv_quant"] is False
    assert fp._geometry() != q._geometry()
    # the JAX engine's byte accounting and key order on the same geometry
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    jst = JEngine(jax_models["gpt"], kv_quant=True, **G_GPT).stats
    assert list(jst) == list(qs) and jst["kv_page_bytes"] == \
        qs["kv_page_bytes"]


def test_kv_quant_flag_kwarg_and_strict_spelling():
    tg = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")

    def eng(**kw):
        return ContinuousBatchingEngine(tg, device="cpu", **G_GPT, **kw)

    assert t_state.get_flag("serving_kv_quant") is False
    assert eng().kv_quant is False
    old = t_state.get_flag("serving_kv_quant")
    try:
        t_state.set_flags({"serving_kv_quant": True})
        assert eng().kv_quant is True
        assert eng(kv_quant="off").kv_quant is False      # kwarg wins
    finally:
        t_state.set_flags({"serving_kv_quant": old})
    for spelling in ("on", "true", "1", "yes", "ON", True):
        assert eng(kv_quant=spelling).kv_quant is True
    for spelling in ("off", "false", "0", "no", False):
        assert eng(kv_quant=spelling).kv_quant is False
    with pytest.raises(ValueError, match="kv_quant"):
        eng(kv_quant="disabled")


def test_cow_copies_data_and_scale_pools():
    tg = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    eng = ContinuousBatchingEngine(tg, device="cpu", kv_quant=True,
                                   **G_GPT)
    g = torch.Generator().manual_seed(0)
    for p in eng._caches:
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=g))
        else:
            p.copy_(torch.rand(p.shape, generator=g))
    before = [p.clone() for p in eng._caches]
    eng._cow_page(3, 5)
    for p, b in zip(eng._caches, before):
        assert torch.equal(p[:, 5], b[:, 3])
        keep = [i for i in range(p.shape[1]) if i != 5]
        assert torch.equal(p[:, keep], b[:, keep])


def test_quantized_weights_carry_across_bitwise(jax_models):
    named = jax_models["llama_wo_named"]
    tm = _port_llama(named, quantized=True)
    mods = dict(tm.named_modules())
    n = 0
    for key, arr in named.items():
        if not key.endswith((".qweight", ".scale")):
            continue
        mod, attr = key.rsplit(".", 1)
        tmod = mods[mod.replace("layer_", "layers.")]
        assert isinstance(tmod, WeightOnlyLinear)
        got = getattr(tmod, attr).numpy()
        np.testing.assert_array_equal(got.T if attr == "qweight" else got,
                                      arr)
        n += 1
    assert n == 2 * (7 * 2 + 1)
    # a float weight where an int8 one belongs is refused
    bad = dict(named)
    key = "llama.layer_0.attn.q_proj.qweight"
    bad[key] = bad[key].astype(np.float32)
    with pytest.raises(TypeError, match="int8"):
        _port_llama(bad, quantized=True)
    # into a float model: the keys do not match
    with pytest.raises(KeyError, match="unexpected"):
        _port_llama(named)


def _jt(a):
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import Tensor
    return Tensor(jnp.asarray(a))


@pytest.mark.parametrize("quant", [False, True])
def test_llama_ragged_and_decode_steps_match_jax(jax_models, quant):
    """One mixed step (a 5-token and a 7-token prefill) then one decode
    step of the weight-only LLaMA, fp32 or int8 pools, through the JAX
    forwards (Pallas in interpret mode) and the port's: logits within
    1e-4, fp32 pools within 1e-5 (two layers, other summation orders)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.generation import _llama_decode as j_decode
    from paddle_tpu.models.generation import _llama_ragged_forward as j_rf
    from paddle_tpu.models.generation import paged_slot_attention as j_psa

    jm = jax_models["llama_wo"]
    tm = _port_llama(jax_models["llama_wo_named"], quantized=True)
    ps, P, hk, hd = 8, 8, 2, 8
    dt = np.int8 if quant else np.float32
    pools = [np.zeros((hk, P, ps, hd), dt) for _ in range(4)]
    if quant:
        pools += [np.zeros((hk, P, ps), np.float32) for _ in range(4)]
    jc = [_jt(p) for p in pools]
    tc = [torch.tensor(p) for p in pools]
    bt = np.asarray([[3, 5, 0], [0, 0, 0], [2, 7, 4]], np.int32)
    rng = np.random.default_rng(1)
    T = 16
    ids = np.zeros(T, np.int32)
    tpos, tslot, tvalid = (np.zeros(T, np.int32) for _ in range(3))
    ids[:5], ids[6:13] = rng.integers(0, 96, 5), rng.integers(0, 96, 7)
    tpos[:5], tpos[6:13] = np.arange(5), np.arange(7)
    tslot[6:13] = 2
    tvalid[:5] = tvalid[6:13] = 1
    kv = np.asarray([5, 1, 7], np.int32)
    ql = np.asarray([5, 0, 7], np.int32)
    rows = np.r_[0:5, 6:13]
    with paddle.no_grad():
        jl, jc = j_rf(jm, _jt(ids[None]), _jt(tpos), _jt(tslot),
                      _jt(tvalid), _jt(kv), _jt(ql), _jt(bt), jc, 2)
    with torch.no_grad():
        tl, tc = tgen._llama_ragged_forward(
            tm, torch.tensor(ids[None]).long(), torch.tensor(tpos),
            torch.tensor(tslot), torch.tensor(tvalid), torch.tensor(kv),
            torch.tensor(ql), torch.tensor(bt), tc, 2)
    np.testing.assert_allclose(tl.numpy()[rows],
                               np.asarray(jl.numpy())[rows], rtol=1e-4,
                               atol=1e-4)
    tok = np.asarray([[11], [0], [42]], np.int32)
    pos = np.asarray([5, 0, 7], np.int32)
    jbt, tbt = _jt(bt), torch.tensor(bt)

    def j_attend(q, k, v, kc, vc, p, ks=None, vs=None):
        return j_psa(q, k, v, kc, vc, p, jbt, k_scales=ks, v_scales=vs)

    def t_attend(q, k, v, kc, vc, p, ks=None, vs=None):
        return tgen.paged_slot_attention(q, k, v, kc, vc, p, tbt,
                                         k_scales=ks, v_scales=vs)

    with paddle.no_grad():
        jl, jc = j_decode(jm, _jt(tok), _jt(pos), jc, attend=j_attend)
    with torch.no_grad():
        tl, tc = tgen._llama_decode(tm, torch.tensor(tok).long(),
                                    torch.tensor(pos).long(), tc, t_attend)
    np.testing.assert_allclose(tl.numpy()[[0, 2]],
                               np.asarray(jl.numpy())[[0, 2]], rtol=1e-4,
                               atol=1e-4)
    for j, t in zip(jc, tc):
        j = np.asarray(j.numpy())
        if t.dtype == torch.int8:
            assert np.abs(t.numpy()[:, 1:].astype(int)
                          - j[:, 1:].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy()[:, 1:], j[:, 1:],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_quantized_llama_engine_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops.cuda.paged_attention import \
        ragged_paged_attention
    from paddle_tpu_torch.ops.cuda.quant_matmul import weight_only_matmul

    gen = torch.Generator().manual_seed(0)
    cfg = LlamaConfig(**{**LLAMA_CFG, "hidden_size": 64})
    cpu = weight_only_quantize(LlamaForCausalLM(cfg, device="cpu",
                                                generator=gen))
    card = weight_only_quantize(LlamaForCausalLM(cfg, device="cuda"))
    card.load_state_dict(cpu.state_dict())
    outs = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        eng = ContinuousBatchingEngine(model, device=dev, kv_quant=True,
                                       **G_LLAMA)
        for p, n in zip(_prompts(3, (7, 4, 11)), (5, 6, 4)):
            eng.add_request(p, n)
        before = (ragged_paged_attention.launches,
                  weight_only_matmul.launches)
        done = eng.run()
        outs.append({rid: c.tokens.tolist() for rid, c in done.items()})
        after = (ragged_paged_attention.launches,
                 weight_only_matmul.launches)
        assert (after[0] > before[0]) == (after[1] > before[1]) == \
            (dev == "cuda")
    assert outs[0] == outs[1]
