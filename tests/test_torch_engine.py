"""The port's continuous-batching engine against the JAX engine.

Both engines serve the same workloads on the same weights (the 2-layer
``serving_gpt`` geometry, a FRESH model per side so both see the same
engine history: the single-step decode bootstrap runs once per (model,
geometry)). Token streams, finish reasons, error codes and every
``stats`` counter must be EXACTLY equal. The JAX side runs once per
module (each engine geometry compiles for ~15 s in interpret mode).

The port's megakernel engine (``megakernel=True``, on another fresh
model) serves the slot-contention and shared-prefix/COW workloads and is
held against the same JAX results: the JAX package holds its megakernel
engine bitwise equal to its unfused one on these workloads
(``tests/test_decode_megakernel.py``), so no JAX megakernel engine is
compiled here.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import state as t_state
from paddle_tpu_torch.core.errors import PageBudgetError, QueueFullError
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import faults as t_faults

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
G1 = dict(max_slots=2, page_size=8, max_seq_len=32, decode_window=4,
          prefill_chunk=8, q_block=2)
G2 = dict(max_slots=3, page_size=4, max_seq_len=16, total_pages=9,
          decode_window=4, prefill_chunk=8, q_block=2)
G3 = dict(max_slots=1, page_size=8, max_seq_len=32, total_pages=3)


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
    return {
        "out": {rid: (c.tokens.tolist(), c.finish_reason,
                      getattr(c.error, "error_code", None))
                for rid, c in done.items()},
        "stats": eng.stats,
    }


def _conserved(eng):
    st = eng.stats
    eng._cache.check()
    return (st["pages_in_use"] + st["pages_free"] + st["cached_pages"]
            == eng.total_pages - 1 and st["pages_in_use"] == 0)


def _contention(eng_, res):
    """Slot contention: 4 ragged requests through 2 slots."""
    prompts = _prompts(0, (5, 9, 3, 12))
    eng = eng_(**G1)
    rids = [eng.add_request(p, n) for p, n in zip(prompts, (6, 4, 7, 5))]
    res["contention"] = _summary(eng, eng.run())
    res["contention"]["conserved"] = _conserved(eng)
    return prompts, rids


def _prefix(eng_, res):
    """Shared prefix: a retired request publishes its pages; later ones
    map them, and a page-aligned full hit copies the divergence page."""
    base = _prompts(5, (16,))[0]
    eng = eng_(**G1)
    eng.add_request(np.concatenate([base, [1, 2, 3]]), 4)
    first = eng.run()
    eng.add_request(np.concatenate([base, [7, 8, 9, 10]]), 3)
    eng.add_request(base, 5)
    res["prefix"] = _summary(eng, {**first, **eng.run()})
    res["prefix"]["conserved"] = _conserved(eng)


def _workloads(Engine, model, faults, extra):
    """Every workload in one fixed order (the decode-bootstrap history
    depends on it). ``extra`` carries the port's ``device=``."""
    res = {}

    def eng_(**kw):
        return Engine(model, **kw, **extra)

    prompts, rids = _contention(eng_, res)

    # eos early retire: eos = the first token in a stream that differs
    # from that stream's first token
    streams = [res["contention"]["out"][r][0] for r in rids]
    eos = next((t for s in streams for t in s if t != s[0]), streams[0][0])
    eng = eng_(**G1)
    for p, n in zip(prompts, (6, 4, 7, 5)):
        eng.add_request(p, n, eos_token_id=eos)
    res["eos"] = _summary(eng, eng.run())
    res["eos"]["conserved"] = _conserved(eng)

    _prefix(eng_, res)

    # preempt-requeue: the pool holds 8 usable pages for 3 slots whose
    # worst case is 12
    eng = eng_(**G2)
    for p, n in zip(_prompts(7, (6, 8, 5, 7)), (8, 7, 8, 6)):
        eng.add_request(p, n)
    res["preempt"] = _summary(eng, eng.run())
    res["preempt"]["conserved"] = _conserved(eng)

    # PDT-E016: a request the pool can never hold fails at add_request
    eng = eng_(**G3)
    try:
        eng.add_request(np.zeros(20, np.int32), 4)
        code = None
    except Exception as e:
        code = getattr(e, "error_code", repr(e))
    res["budget"] = {"code": code, "stats": eng.stats}

    # PDT-E017: a bounded queue under 'reject'
    eng = eng_(**G1, max_queue=2, queue_policy="reject")
    qp = _prompts(8, (4, 6, 5))
    eng.add_request(qp[0], 3)
    eng.add_request(qp[1], 3)
    try:
        eng.add_request(qp[2], 3)
        code = None
    except Exception as e:
        code = getattr(e, "error_code", repr(e))
    res["queue_full"] = _summary(eng, eng.run())
    res["queue_full"]["code"] = code

    # cancel one resident and one queued request mid-flight
    eng = eng_(**G1)
    for p in _prompts(9, (6, 10, 4)):
        eng.add_request(p, 6)
    done = {}
    for _ in range(2):
        done.update({c.request_id: c for c in eng.step()})
    res["cancel_ok"] = (eng.cancel(0), eng.cancel(2), eng.cancel(99))
    done.update(eng.run())
    res["cancel"] = _summary(eng, done)
    res["cancel"]["conserved"] = _conserved(eng)

    # decode guard: one request's logits go NaN for one dispatch; it
    # fails alone (PDT-E018), the others finish
    faults.clear()
    faults.inject("engine_nan_decode", match="1", at=3)
    eng = eng_(**G1)
    for p, n in zip(prompts[:3], (6, 8, 5)):
        eng.add_request(p, n)
    res["nan"] = _summary(eng, eng.run())
    faults.reset()
    return res


@pytest.fixture(scope="module")
def results():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    from paddle_tpu.models.gpt import GPTConfig as JConfig
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    from paddle_tpu.resilience import faults as j_faults

    from paddle_tpu_torch.models import load_gpt_from_jax

    paddle.seed(0)
    jm = JGPT(JConfig(**CFG, dropout=0.0))
    jm.eval()
    named = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_gpt_from_jax(tm, named)
    # the megakernel engine on its own fresh model, in the order the
    # JAX history saw the two workloads (contention bootstraps the
    # decode geometry; prefix then runs windows only)
    mk = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_gpt_from_jax(mk, named)
    mk_res = {}

    def mk_eng(**kw):
        return ContinuousBatchingEngine(mk, device="cpu", megakernel=True,
                                        **kw)

    _contention(mk_eng, mk_res)
    _prefix(mk_eng, mk_res)
    return {"jax": _workloads(JEngine, jm, j_faults, {}),
            "port": _workloads(ContinuousBatchingEngine, tm, t_faults,
                               {"device": "cpu"}),
            "megakernel": mk_res}


@pytest.mark.parametrize("name", ["contention", "eos", "prefix", "preempt",
                                  "queue_full", "cancel", "nan"])
def test_engine_matches_jax(results, name):
    j, t = results["jax"][name], results["port"][name]
    assert t["out"] == j["out"]
    assert list(t["stats"].items()) == list(j["stats"].items())
    if "conserved" in t:
        assert t["conserved"] and j["conserved"]


@pytest.mark.parametrize("name", ["contention", "prefix"])
def test_megakernel_engine_matches_jax(results, name):
    j, t = results["jax"][name], results["megakernel"][name]
    assert t["out"] == j["out"]
    assert list(t["stats"].items()) == list(j["stats"].items())
    assert t["conserved"] and j["conserved"]


def test_workloads_exercise_their_paths(results):
    t = results["port"]
    assert all(r == "length" for _, r, _ in t["contention"]["out"].values())
    assert t["contention"]["stats"]["mixed_steps"] >= 2
    assert any(r == "stop" for _, r, _ in t["eos"]["out"].values())
    assert t["prefix"]["stats"]["cache_hits"] >= 2
    assert t["prefix"]["stats"]["cache_hit_tokens"] >= 16 + 15
    assert t["preempt"]["stats"]["preemptions"] > 0
    reasons = {rid: r for rid, (_, r, _) in t["cancel"]["out"].items()}
    assert reasons == {0: "cancelled", 1: "length", 2: "cancelled"}
    assert t["cancel"]["stats"]["cancelled"] == 2
    assert results["port"]["cancel_ok"] == results["jax"]["cancel_ok"] \
        == (True, True, False)
    nan = t["nan"]["out"]
    assert nan[1][1:] == ("failed", "PDT-E018")
    assert nan[0][1] == nan[2][1] == "length"


def test_coded_rejections_match_jax(results):
    for name, code in (("budget", "PDT-E016"), ("queue_full", "PDT-E017")):
        j, t = results["jax"][name], results["port"][name]
        assert t["code"] == j["code"] == code
        assert t["stats"]["rejected"] == j["stats"]["rejected"] == 1
    assert PageBudgetError.error_code == "PDT-E016"
    assert QueueFullError.error_code == "PDT-E017"


def test_left_out_subsystems_raise():
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    for kw in ({"kv_quant": True}, {"kv_quant": "on"},
               {"kv_quant": True, "megakernel": True}, {"spec_decode": True},
               {"spec_k": 4}, {"spec_proposer": "ngram"},
               {"mesh": object()}, {"slo": "ttft_p99<100ms"},
               {"watchdog_ms": 50}):
        with pytest.raises(NotImplementedError):
            ContinuousBatchingEngine(tm, device="cpu", **G1, **kw)
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatchingEngine(tm, device="cpu", kv_quant="maybe", **G1)
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant="off",
                                   megakernel=False, **G1)
    assert eng.stats["kv_quant"] is False


def test_megakernel_off_spelling_restores_default_geometry():
    """An off-spelling is indistinguishable from the default: the same
    parsed value and the same decode geometry key; an on-spelling is a
    geometry of its own (its own decode bootstrap)."""
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    base = ContinuousBatchingEngine(tm, device="cpu", **G1)
    for spelling in ("off", "false", "0", "no", False):
        eng = ContinuousBatchingEngine(tm, device="cpu",
                                       megakernel=spelling, **G1)
        assert eng.megakernel is False
        assert eng._geometry() == base._geometry()
    for spelling in ("on", "true", "1", "yes", True, "ON"):
        eng = ContinuousBatchingEngine(tm, device="cpu",
                                       megakernel=spelling, **G1)
        assert eng.megakernel is True
        assert eng._geometry() != base._geometry()


def test_megakernel_flag_and_strict_spelling():
    """The ``serving_megakernel`` flag sets the default (the kwarg still
    wins); a typo raises instead of silently picking a decode path."""
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    assert t_state.MEGAKERNEL_ON_SPELLINGS == t_state.KV_QUANT_ON_SPELLINGS
    assert t_state.MEGAKERNEL_OFF_SPELLINGS == \
        t_state.KV_QUANT_OFF_SPELLINGS
    old = t_state.get_flag("serving_megakernel")
    assert old is False
    try:
        t_state.set_flags({"serving_megakernel": True})
        assert ContinuousBatchingEngine(
            tm, device="cpu", **G1).megakernel is True
        assert ContinuousBatchingEngine(
            tm, device="cpu", megakernel="off", **G1).megakernel is False
    finally:
        t_state.set_flags({"serving_megakernel": old})
    with pytest.raises(ValueError, match="megakernel"):
        ContinuousBatchingEngine(tm, device="cpu", megakernel="fast", **G1)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops.cuda.paged_attention import \
        ragged_paged_attention

    gen = torch.Generator().manual_seed(0)
    cpu = GPTForCausalLM(GPTConfig(**CFG), device="cpu", generator=gen)
    card = GPTForCausalLM(GPTConfig(**CFG), device="cuda")
    card.load_state_dict(cpu.state_dict())
    outs = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        eng = ContinuousBatchingEngine(model, device=dev, **G1)
        for p, n in zip(_prompts(0, (5, 9, 3, 12)), (6, 4, 7, 5)):
            eng.add_request(p, n)
        before = ragged_paged_attention.launches
        outs.append(_summary(eng, eng.run()))
        launched = ragged_paged_attention.launches - before
        assert (launched > 0) == (dev == "cuda")
    assert outs[0] == outs[1]
