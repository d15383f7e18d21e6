"""The port's ragged paged attention against the JAX package's.

On the CPU, the port's wrapper runs its plain PyTorch version; it is
held against ``paddle_tpu.ops.pallas.paged_attention`` run as the JAX
tests run it on the CPU (Pallas interpret mode), on the same numpy
inputs: rtol = atol = 1e-5 (fp32, another summation order). On a card
(``-m gpu``) the CUDA kernel is held against the plain version.

JAX is imported inside a fixture, so this file also collects on a
machine without JAX (the card's), where only the ``gpu`` tests run:
``python -m pytest --noconftest -m gpu tests/test_torch_*.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention, ragged_paged_attention,
    ragged_paged_attention_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


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
def pga():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import paged_attention
    return paged_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed, kv_lens, q_lens, hq, hk, d, ps, q_block, extra_pages=3):
    """Pools with shuffled page ids, block tables, packed q (segments at
    q_block edges, a trailing padding q block) and the valid rows."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    npg = [-(-kv // ps) for kv in kv_lens]
    NP = max(npg) + 1
    P = 1 + sum(npg) + extra_pages
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, NP), np.int32)
    at = 0
    for b in range(B):
        bt[b, :npg[b]] = perm[at:at + npg[b]]
        at += npg[b]
    k = rng.normal(size=(hk, P, ps, d)).astype(np.float32)
    v = rng.normal(size=(hk, P, ps, d)).astype(np.float32)
    segs = [-(-ql // q_block) * q_block for ql in q_lens]
    starts = np.cumsum([0] + segs[:-1])
    T = sum(segs) + q_block
    q = rng.normal(size=(T, hq, d)).astype(np.float32)
    rows = np.concatenate([np.arange(s, s + n)
                           for s, n in zip(starts, q_lens)])
    return (q, k, v, bt, np.asarray(kv_lens, np.int32),
            np.asarray(q_lens, np.int32), rows)


CASES = {
    # name: (kv_lens, q_lens, hq, hk, d, page_size, q_block)
    "mixed_qb2": ([13, 6, 21, 1], [5, 1, 9, 1], 4, 4, 16, 8, 2),
    "mixed_qb8": ([40, 7, 19], [17, 1, 8], 4, 4, 16, 8, 8),
    "zero_qlen_slot": ([10, 9, 12], [2, 0, 3], 2, 2, 16, 8, 2),
    "page_edges": ([8, 16, 17, 31, 32], [8, 1, 1, 15, 2], 2, 2, 16, 8, 4),
    "page16": ([33, 5, 48], [16, 5, 1], 4, 4, 32, 16, 8),
    "gqa_rep2": ([20, 11], [6, 1], 4, 2, 16, 8, 2),
    "gqa_rep4": ([26, 9, 3], [9, 2, 3], 8, 2, 16, 16, 4),
    "gqa_rep3_row_pad": ([15, 22], [3, 7], 6, 2, 16, 8, 2),
}


def _torch_args(q, k, v, bt, kvl, ql, device="cpu"):
    return [torch.tensor(a, device=device) for a in (q, k, v, bt, kvl, ql)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_matches_jax(pga, name):
    kv_lens, q_lens, hq, hk, d, ps, qb = CASES[name]
    q, k, v, bt, kvl, ql, rows = _case(7, kv_lens, q_lens, hq, hk, d,
                                       ps, qb)
    ref = np.asarray(pga.ragged_paged_attention(
        q, k, v, bt, kvl, ql, q_block=qb, interpret=True))
    out = ragged_paged_attention(*_torch_args(q, k, v, bt, kvl, ql),
                                 q_block=qb).numpy()
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)
    # rows past the live segments are written 0
    assert not out[len(q) - qb:].any()


@pytest.mark.parametrize("hq,hk,ps", [(4, 4, 8), (8, 2, 16)])
def test_decode_matches_jax(pga, hq, hk, ps):
    kv_lens = [1, 7, 8, 9, 25]
    q, k, v, bt, kvl, _, _ = _case(3, kv_lens, [1] * 5, hq, hk, 16, ps, 1)
    q = q[:5]
    ref = np.asarray(pga.paged_decode_attention(q, k, v, bt, kvl,
                                                interpret=True))
    tq, tk, tv, tbt, tkvl = (torch.tensor(a) for a in (q, k, v, bt, kvl))
    out = paged_decode_attention(tq, tk, tv, tbt, tkvl).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_scale_and_pages_per_block_parity(pga):
    q, k, v, bt, kvl, ql, rows = _case(11, [18, 5], [4, 1], 4, 2, 16, 8, 2)
    ref = np.asarray(pga.ragged_paged_attention(
        q, k, v, bt, kvl, ql, q_block=2, pages_per_block=1, scale=0.3,
        interpret=True))
    out = ragged_paged_attention(*_torch_args(q, k, v, bt, kvl, ql),
                                 q_block=2, pages_per_block=1,
                                 scale=0.3).numpy()
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)


def _small():
    q, k, v, bt, kvl, ql, _ = _case(1, [9, 4], [3, 1], 4, 2, 16, 8, 2)
    return _torch_args(q, k, v, bt, kvl, ql)


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError, "float32"),
    (lambda a: a.__setitem__(1, a[1].half()), TypeError, "float32"),
    (lambda a: a.__setitem__(3, a[3].float()), TypeError, "integer"),
    (lambda a: a.__setitem__(0, a[0][:, :3]), ValueError, "multiple"),
    (lambda a: a.__setitem__(0, a[0][..., :8]), ValueError, "head_dim"),
    (lambda a: a.__setitem__(2, a[2][:, :-1]), ValueError, "pool shapes"),
    (lambda a: a.__setitem__(4, a[4][:1]), ValueError, "kv_lens"),
    (lambda a: a.__setitem__(3, a[3][0]), ValueError, "block_tables"),
    (lambda a: a.__setitem__(0, a[0][0]), ValueError, "q must be"),
    (lambda a: a.__setitem__(1, a[1].to("meta")), ValueError, "devices"),
])
def test_wrapper_validation(mutate, exc, match):
    args = _small()
    mutate(args)
    with pytest.raises(exc, match=match):
        ragged_paged_attention(*args, q_block=2)


def test_wrapper_rejects_tpu_only_arguments():
    args = _small()
    # scale pools are ported (int8 pools, tests/test_torch_quantization.py)
    # and belong with int8 pools only: fp32 pools with scales are refused
    scales = torch.ones(tuple(args[1].shape[:3]))
    for kw in ({"interpret": True}, {"item_budget": 4},
               {"k_scales": scales, "v_scales": scales}):
        with pytest.raises(TypeError):
            ragged_paged_attention(*args, q_block=2, **kw)
    with pytest.raises(ValueError, match="q_block"):
        ragged_paged_attention(*args, q_block=0)


def test_wrapper_counts_only_kernel_launches():
    before = ragged_paged_attention.launches
    ragged_paged_attention(*_small(), q_block=2)   # CPU: plain version
    assert ragged_paged_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda, name):
    kv_lens, q_lens, hq, hk, d, ps, qb = CASES[name]
    q, k, v, bt, kvl, ql, rows = _case(7, kv_lens, q_lens, hq, hk, d,
                                       ps, qb)
    args = _torch_args(q, k, v, bt, kvl, ql, device=cuda)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, q_block=qb)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    ref = ragged_paged_attention_plain(*args, q_block=qb)
    # fp32, another summation order: the same 1e-5 as against JAX; rows
    # of segment padding are compared too (both write the same rows)
    torch.testing.assert_close(out, ref, **TOL)
