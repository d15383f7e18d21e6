"""The port's GPT serving forwards against the JAX package's.

The JAX model's weights (the 2-layer ``serving_gpt`` geometry of
``tests/conftest.py``) load into the port through
``load_gpt_from_jax``; the same packed inputs then go through the JAX
``_gpt_ragged_forward`` / ``_gpt_decode`` + ``paged_slot_attention``
(Pallas in interpret mode) and the port's counterparts on the CPU.
Logits agree within atol 1e-4, written page pools within 1e-5 (fp32,
other summation orders across two layers).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_state_from_jax, load_gpt_from_jax)
from paddle_tpu_torch.models import generation as tgen

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
PS, NP, P = 8, 4, 14   # page size, table width, pool pages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(serving_gpt):
    named = {k: np.asarray(v.numpy())
             for k, v in serving_gpt.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_gpt_from_jax(tm, named)
    return serving_gpt, tm, named


def _jt(a):
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import Tensor
    return Tensor(jnp.asarray(a))


def test_state_from_jax_maps_all_keys(models):
    _, tm, named = models
    assert len(named) == 28
    state = gpt_state_from_jax(named)
    assert sorted(state) == sorted(tm.state_dict())
    for key, arr in named.items():
        tkey = key.replace("block_", "blocks.")
        got = state[tkey].numpy()
        linear = arr.ndim == 2 and key not in ("gpt.wte.weight",
                                               "gpt.wpe.weight")
        np.testing.assert_array_equal(got, arr.T if linear else arr)
    # fused qkv keeps the JAX column order [3, heads, head_dim]
    qkv = state["gpt.blocks.0.attn.qkv.weight"]
    assert qkv.shape == (3 * 32, 32)


@pytest.mark.parametrize("edit,exc,match", [
    (lambda d: d.pop("gpt.ln_f.bias"), KeyError, "missing"),
    (lambda d: d.__setitem__("gpt.block_2.ln1.weight", np.ones(32)),
     KeyError, "unexpected"),
    (lambda d: d.__setitem__("gpt.block_0.mlp.fc1.weight",
                             np.ones((32, 64), np.float32)),
     ValueError, "shape"),
    (lambda d: d.__setitem__("head.weight", np.ones(3)), KeyError,
     "unexpected key"),
])
def test_load_rejects_bad_state(models, edit, exc, match):
    _, _, named = models
    bad = dict(named)
    edit(bad)
    fresh = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    before = fresh.gpt.ln_f.weight.clone()
    with pytest.raises(exc, match=match):
        load_gpt_from_jax(fresh, bad)
    assert torch.equal(fresh.gpt.ln_f.weight, before)


def test_model_surface(models):
    jm, tm, _ = models
    assert tm.num_params() == jm.num_params()
    assert tm.lm_head is None and len(tm.gpt.blocks) == 2
    # the full-sequence forward (the training slice's) gives the JAX
    # model's logits
    ids = np.array([[1, 2, 3, 4]], np.int32)
    np.testing.assert_allclose(
        tm(torch.tensor(ids).long()).detach().numpy(),
        np.asarray(jm(_jt(ids)).numpy()), rtol=0, atol=1e-4)
    with pytest.raises(TypeError, match="LLaMA"):
        tgen._ragged_fn(torch.nn.Linear(2, 2))
    with pytest.raises(TypeError, match="LLaMA"):
        tgen._decode_fn(torch.nn.Linear(2, 2))


def _pools(n_layers, hk=4, hd=8):
    return [np.zeros((hk, P, PS, hd), np.float32)
            for _ in range(2 * n_layers)]


def _block_table(seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, P))[:3 * NP].reshape(
        3, NP).astype(np.int32)


# two mixed steps over 3 slots (q_block 2): slot 0 prefills 5 then
# decodes 1; slot 1 sits out (kv 1, q 0); slot 2 prefills 7 then 3
STEPS = [
    # (slot, pos0, n) per live segment
    [(0, 0, 5), (2, 0, 7)],
    [(0, 5, 1), (2, 7, 3)],
]


def _pack(rng, step, qb=2, T=16, B=3):
    ids = np.zeros(T, np.int32)
    tpos = np.zeros(T, np.int32)
    tslot = np.zeros(T, np.int32)
    tvalid = np.zeros(T, np.int32)
    kv = np.ones(B, np.int32)
    ql = np.zeros(B, np.int32)
    rows, cur = [], 0
    for b, pos0, n in step:
        ids[cur:cur + n] = rng.integers(0, 96, n)
        tpos[cur:cur + n] = pos0 + np.arange(n)
        tslot[cur:cur + n] = b
        tvalid[cur:cur + n] = 1
        kv[b], ql[b] = pos0 + n, n
        rows.extend(range(cur, cur + n))
        cur += -(-n // qb) * qb
    return (ids, tpos, tslot, tvalid, kv, ql), np.asarray(rows)


def _run_ragged_both(models, seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.models.generation import _gpt_ragged_forward

    jm, tm, _ = models
    rng = np.random.default_rng(seed)
    bt = _block_table(seed)
    jc = [_jt(p) for p in _pools(2)]
    tc = [torch.tensor(p) for p in _pools(2)]
    outs = []
    for step in STEPS:
        (ids, tpos, tslot, tvalid, kv, ql), rows = _pack(rng, step)
        with paddle.no_grad():
            jl, jc = _gpt_ragged_forward(
                jm, _jt(ids[None]), _jt(tpos), _jt(tslot), _jt(tvalid),
                _jt(kv), _jt(ql), _jt(bt), jc, 2)
        with torch.no_grad():
            tl, tc = tgen._gpt_ragged_forward(
                tm, torch.tensor(ids[None]).long(), torch.tensor(tpos),
                torch.tensor(tslot), torch.tensor(tvalid),
                torch.tensor(kv), torch.tensor(ql), torch.tensor(bt), tc,
                2)
        outs.append((np.asarray(jl.numpy())[rows], tl.numpy()[rows]))
    return outs, jc, tc, bt


def _assert_pools_close(jc, tc):
    for j, t in zip(jc, tc):
        # page 0 is the null page every padding token writes: skip it
        np.testing.assert_allclose(t.numpy()[:, 1:],
                                   np.asarray(j.numpy())[:, 1:],
                                   rtol=1e-5, atol=1e-5)


def test_ragged_forward_matches_jax(models):
    outs, jc, tc, _ = _run_ragged_both(models)
    for jl, tl in outs:
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    _assert_pools_close(jc, tc)


def test_decode_matches_jax(models):
    import paddle_tpu as paddle
    from paddle_tpu.models.generation import _gpt_decode
    from paddle_tpu.models.generation import \
        paged_slot_attention as j_attn

    jm, tm, _ = models
    _, jc, tc, bt = _run_ragged_both(models, seed=1)
    # slots 0 and 2 decode their next token at positions 6 and 10;
    # slot 1 is idle (position 0, its table row the null page)
    bt[1] = 0
    tok = np.asarray([[17], [0], [42]], np.int32)
    pos = np.asarray([6, 0, 10], np.int32)
    jbt = _jt(bt)

    def j_attend(q, k, v, kc, vc, p):
        return j_attn(q, k, v, kc, vc, p, jbt)

    tbt = torch.tensor(bt)

    def t_attend(q, k, v, kc, vc, p):
        return tgen.paged_slot_attention(q, k, v, kc, vc, p, tbt)

    for _ in range(2):
        with paddle.no_grad():
            jl, jc = _gpt_decode(jm, _jt(tok), _jt(pos), jc,
                                 attend=j_attend)
        with torch.no_grad():
            tl, tc = tgen._gpt_decode(tm, torch.tensor(tok).long(),
                                      torch.tensor(pos).long(), tc,
                                      t_attend)
        jl = np.asarray(jl.numpy())
        np.testing.assert_allclose(tl.numpy()[[0, 2]], jl[[0, 2]],
                                   rtol=1e-4, atol=1e-4)
        tok = jl.argmax(-1).astype(np.int32)[:, None]
        pos = pos + np.asarray([1, 0, 1], np.int32)
    _assert_pools_close(jc, tc)


def test_guarded_argmax_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu.models.generation import guarded_argmax as j_ga

    lg = np.asarray([[0.5, 2.0, 2.0, -1.0],     # tie: first max wins
                     [1.0, np.inf, 0.0, 0.0],   # non-finite row
                     [-3.0, -2.0, -2.5, -9.0],
                     [0.0, 0.0, 0.0, 0.0]], np.float32)
    poison = np.asarray([0.0, 0.0, 0.0, np.nan], np.float32)
    with paddle.no_grad():
        jn, jb = j_ga(_jt(lg), _jt(poison))
    tn, tb = tgen.guarded_argmax(torch.tensor(lg), torch.tensor(poison))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn.numpy()))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb.numpy()))
    assert tn.tolist() == [1, 0, 1, 0] and tb.tolist() == [0, 1, 0, 1]
