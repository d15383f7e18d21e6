"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch versions; they are
held against ``paddle_tpu.ops.pallas.flash_attention`` run as the JAX
tests run it on the CPU: the Pallas forward ``_fwd`` and the public
``flash_attention`` in interpret mode, the backward through
``flash_attention_bwd_jnp`` (the kernel's jnp twin) and through
``jax.grad`` of the interpret-mode kernel, on the same numpy inputs.
The JAX side runs with 32 x 32 tiles, so S = 40 leaves a padded tail.
Tolerances: fp32 o and lse 1e-5 max abs, grads 1e-4 (another summation
order); bf16 one bf16 rounding of the result (2**-8 of the largest
reference value) plus 1e-4, since both sides round an fp32 result that
may differ in its last bits.

On a card (``-m gpu``) the CUDA kernels are held against the plain
versions, with TF32 off, each case on the route ``tc_route`` gives it:
the CUDA-core kernels (fp32; bf16 head_dim 20, 32 and 96) fp32 o and
lse within 2e-5, grads within 1e-4, bf16 as above, against the plain
version run in fp32 on the same bf16 inputs; the tensor-core kernels
(bf16, head_dim 64 or 128) round P and dS to bf16 before their
products, so o, dq, dk and dv are held element by element to
``tc_tolerances`` (that rounding carried through each product, from the
plain version's own p and ds, plus one bf16 rounding of the element and
1e-4), lse within 2e-5 as before. The route rule, and that those limits
admit the rounding and refuse a kernel's likely faults, are tested on
the CPU. JAX is imported inside a fixture, so this
file also collects on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

FP32 = dict(o=1e-5, lse=1e-5, grad=1e-4)
BLOCKS = (32, 32)


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
def jfa():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import flash_attention
    return flash_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, sq, sk, hq, hk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


def _attending_rows(sq, sk, causal):
    """q rows that attend at least one key."""
    rows = np.arange(sq)
    return rows[rows + (sk - sq) >= 0] if causal else rows


def _bf16_close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    lim = 2.0 ** -8 * np.abs(ref).max() + 1e-4
    assert err <= lim, f"{what}: max abs err {err:.3g} > {lim:.3g}"


CASES = {
    # name: (b, sq, sk, hq, hk, d, causal)
    "causal": (2, 40, 40, 4, 4, 16, True),
    "noncausal": (2, 40, 40, 4, 4, 16, False),
    "gqa_4_2_causal": (2, 40, 40, 4, 2, 16, True),
    "gqa_4_2_noncausal": (1, 33, 33, 4, 2, 8, False),
    "sq_lt_sk_causal": (2, 24, 40, 4, 2, 16, True),
    "sq_gt_sk_causal": (1, 40, 24, 2, 2, 16, True),
    "sq_ne_sk_noncausal": (1, 17, 40, 2, 1, 16, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_pallas_fwd(jfa, name):
    import jax.numpy as jnp
    b, sq, sk, hq, hk, d, causal = CASES[name]
    q, k, v, _ = _inputs(1, b, sq, sk, hq, hk, d)
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jfa._fwd(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                          for x in (q, k, v)), None, None, scale, causal,
                        True, BLOCKS)
    o, lse = tfa.flash_attention_fwd(*map(torch.tensor, (q, k, v)), causal)
    rows = _attending_rows(sq, sk, causal)
    np.testing.assert_allclose(
        o.numpy()[:, rows], np.swapaxes(np.asarray(jo), 1, 2)[:, rows],
        rtol=0, atol=FP32["o"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-7,
                               atol=FP32["lse"])
    dead = np.setdiff1d(np.arange(sq), rows)
    assert (o.numpy()[:, dead] == 0).all()
    assert (lse.numpy()[:, :, dead] == tfa.NEG_INF).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jnp_twin(jfa, name):
    import jax.numpy as jnp
    b, sq, sk, hq, hk, d, causal = CASES[name]
    q, k, v, do = _inputs(2, b, sq, sk, hq, hk, d)
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jfa._fwd(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                          for x in (q, k, v)), None, None, scale, causal,
                        True, BLOCKS)
    o = np.swapaxes(np.asarray(jo), 1, 2)
    lse = np.asarray(jlse)
    want = jfa.flash_attention_bwd_jnp(
        *map(jnp.asarray, (q, k, v, do, o, lse)), scale=scale,
        causal=causal, blocks=BLOCKS)
    got = tfa.flash_attention_bwd(*map(torch.tensor, (q, k, v, do, o, lse)),
                                  causal)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FP32["grad"], err_msg=n)


@pytest.mark.parametrize("name", ["gqa_4_2_causal", "sq_lt_sk_causal",
                                  "noncausal"])
def test_autograd_matches_jax_grad_through_interpret_kernel(jfa, name):
    import jax
    import jax.numpy as jnp
    b, sq, sk, hq, hk, d, causal = CASES[name]
    q, k, v, do = _inputs(3, b, sq, sk, hq, hk, d)

    def loss(a, bb, cc):
        o = jfa.flash_attention(a, bb, cc, causal=causal, interpret=True,
                                blocks=BLOCKS)
        return jnp.sum(o * jnp.asarray(do))

    jo = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             interpret=True, blocks=BLOCKS)
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    (o * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=FP32["o"])
    for g, w, n in zip((tq.grad, tk.grad, tv.grad), jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FP32["grad"], err_msg=n)


def test_bf16_inputs_match_interpret_kernel(jfa):
    import jax
    import jax.numpy as jnp
    b, sq, sk, hq, hk, d, causal = 2, 40, 40, 4, 2, 16, True
    q, k, v, do = _inputs(4, b, sq, sk, hq, hk, d)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))

    def loss(a, bb, cc):
        o = jfa.flash_attention(a, bb, cc, causal=causal, interpret=True,
                                blocks=BLOCKS)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    jo = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True,
                             blocks=BLOCKS)
    jg = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(np.asarray(x.astype(jnp.float32)))
                  .to(torch.bfloat16).requires_grad_()
                  for x in (jq, jk, jv))
    tdo = torch.tensor(np.asarray(jdo.astype(jnp.float32)))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert o.dtype == torch.bfloat16
    (o.float() * tdo).sum().backward()
    _bf16_close(o.detach().float(), jo.astype(jnp.float32), "o")
    for g, w, n in zip((tq.grad, tk.grad, tv.grad), jg, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        _bf16_close(g.float(), w.astype(jnp.float32), n)


def test_wrapper_validation():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of key/value heads"):
        tfa.flash_attention(q, kv, kv)
    big = torch.zeros(1, 8, 2, 136)
    with pytest.raises(ValueError, match="head_dim 136"):
        tfa.flash_attention(big, big, big)
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="interpret"):
        tfa.flash_attention(x, x, x, interpret=True)
    with pytest.raises(NotImplementedError, match="flash_attn_unpadded"):
        tfa.flash_attention(x, x, x, segment_ids=torch.zeros(1, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(x.half(), x.half(), x.half())
    # blocks / bwd_blocks are accepted and not read
    o = tfa.flash_attention(x, x, x, causal=True, blocks=(16, 16),
                            bwd_blocks=(8, 8))
    assert o.shape == x.shape


def _route_case(kind):
    """CPU tensors q, k, v, do (paddle layout) for one route-rule case."""
    bf, f32 = torch.bfloat16, torch.float32

    def t(*shape, dtype=bf):
        return torch.zeros(*shape, dtype=dtype)
    if kind == "gpt_packed_qkv_views":
        q, k, v = t(2, 16, 3, 4, 64).unbind(2)
        return q, k, v, t(2, 16, 4, 64)
    if kind == "misaligned_base":      # 8 bytes past a 16-byte boundary
        x = t(2 * 16 * 4 * 64 + 4)[4:].view(2, 16, 4, 64)
        return x, t(2, 16, 4, 64), t(2, 16, 4, 64), t(2, 16, 4, 64)
    if kind == "head_stride_136_bytes":    # heads 68 apart, 64 read
        x = t(2, 16, 4, 68)[..., :64]
        return x, x, x, t(2, 16, 4, 64)
    if kind == "zero_batch_stride":
        x = t(1, 16, 4, 64).expand(2, 16, 4, 64)
        return x, x, x, t(2, 16, 4, 64)
    if kind == "fp32_do":
        x = t(2, 16, 4, 64)
        return x, x, x, t(2, 16, 4, 64, dtype=f32)
    dtype, d = {"bf16_d64": (bf, 64), "bf16_d128": (bf, 128),
                "bf16_d96": (bf, 96), "bf16_d20": (bf, 20),
                "fp32_d64": (f32, 64)}[kind]
    x = t(2, 16, 4, d, dtype=dtype)
    return x, t(2, 16, 2, d, dtype=dtype), t(2, 16, 2, d, dtype=dtype), x


@pytest.mark.parametrize("kind,want", [
    ("bf16_d64", True), ("bf16_d128", True), ("gpt_packed_qkv_views", True),
    ("bf16_d96", False), ("bf16_d20", False), ("fp32_d64", False),
    ("misaligned_base", False), ("head_stride_136_bytes", False),
    ("zero_batch_stride", False), ("fp32_do", False)])
def test_tc_route_rule(kind, want):
    """The pre-launch rule of the tensor-core route: bf16, head_dim 64 or
    128, 16-byte aligned base pointers and positive (batch, seq, head)
    strides that are multiples of 16 bytes (the forward asks it of q, k,
    v; the backward of do as well)."""
    q, k, v, do = _route_case(kind)
    assert tfa.tc_route(q, k, v, do) is want
    if kind != "fp32_do":
        assert tfa.tc_route(q, k, v) is want


def _tc_worst(got, ref, lim):
    """The largest ratio of |got - ref| to its element's limit."""
    return float(((got.float() - ref).abs() / lim).max())


def _tc_emulation(q, k, v, do, o, lse, fault=None):
    """``(o, dq, dk, dv)`` of causal square attention, ``[B, S, H, D]``
    rounded to bf16 as the tensor-core kernels write them, formed as
    those kernels form them: the forward over 128-key tiles with the
    online-softmax rescale of O, P and dS rounded to bf16 before their
    products, the backward's P and delta from the ``o`` and ``lse``
    given. ``fault`` puts in one mistake such a kernel could make."""
    b, s, hq, d = q.shape
    rep, scale = hq // k.shape[2], d ** -0.5

    def bf(x):
        return x.to(torch.bfloat16).float()
    qt, dot = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kt, vt = (x.float().transpose(1, 2).repeat_interleave(rep, 1)
              for x in (k, v))
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    sc = (qt @ kt.transpose(-1, -2) * scale).masked_fill(~mask, -np.inf)
    m = torch.full((b, hq, s, 1), -np.inf)
    l, acc = torch.zeros(b, hq, s, 1), torch.zeros(b, hq, s, d)
    for t in range(0, s, 128):
        st = sc[..., t:t + 128]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new)
        m, l = m_new, l * alpha + p.sum(-1, keepdim=True)
        if fault != "no_alpha_rescale":
            acc = acc * alpha
        pv = bf(p) @ vt[..., t:t + 128, :]
        acc = acc + (2 * pv if fault == "doubled_late_key_tile"
                     and t + 128 >= s else pv)
    o_tc = acc / l
    p = torch.exp(sc - lse[..., None])
    delta = (dot * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dot @ vt.transpose(-1, -2) - delta)
    p, ds = bf(p), bf(ds)
    if fault == "dropped_late_q_tile":     # the last 64 q rows
        p[..., s - 64:, :] = 0.0
        ds[..., s - 64:, :] = 0.0
    dv, dk = p.transpose(-1, -2) @ dot, ds.transpose(-1, -2) @ qt * scale
    dq = ds @ kt * scale
    if rep > 1:
        dk, dv = (x.reshape(b, hq // rep, rep, s, d).sum(2) for x in (dk, dv))
    return tuple(bf(x.transpose(1, 2)) for x in (o_tc, dq, dk, dv))


@pytest.mark.parametrize("fault,caught", [
    (None, set()), ("no_alpha_rescale", {"o"}),
    ("doubled_late_key_tile", {"o"}),
    ("dropped_late_q_tile", {"dq", "dk", "dv"})])
def test_tc_tolerances_hold_rounding_and_catch_faults(fault, caught):
    """``tc_tolerances`` (element by element) admits the bf16 rounding of
    P and dS that the tensor-core route makes, and refuses a kernel that
    misses the rescale of O, adds a late K tile twice or drops the last
    q tile: causal, 384 rows, GQA 2 on 1, head_dim 64, on the CPU."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(5, 1, 384, 384, 2, 1, 64))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    lims, refs = tfa.tc_tolerances(q, k, v, do, o, lse, True)
    got = _tc_emulation(q, k, v, do, o, lse, fault)
    worst = {n: _tc_worst(g, r, lims[n])
             for n, g, r in zip(("o", "dq", "dk", "dv"), got, refs)}
    assert {n for n, w in worst.items() if w > 1} == caught, worst


# ------------------------------------------------------------ card --
GPU_CASES = {
    # name: (b, sq, sk, hq, hk, d, causal, dtype); square cases with as
    # many kv heads as q heads take the unbound views of a packed qkv
    "causal_f32_d64": (2, 100, 100, 4, 4, 64, True, torch.float32),
    "noncausal_f32_d64": (2, 100, 100, 4, 4, 64, False, torch.float32),
    "causal_bf16_d64": (2, 130, 130, 4, 4, 64, True, torch.bfloat16),
    "gqa_8_2_bf16_d128": (1, 130, 130, 8, 2, 128, True, torch.bfloat16),
    "sq_lt_sk_f32_d16": (2, 70, 130, 4, 2, 16, True, torch.float32),
    "sq_gt_sk_f32_d40": (1, 130, 70, 2, 1, 40, True, torch.float32),
    # rows of 40 bytes: not whole 16-byte chunks, the scalar-load path
    "scalar_loads_bf16_d20": (2, 90, 90, 4, 2, 20, True, torch.bfloat16),
    # bf16 head dims the tensor-core route refuses: the CUDA-core
    # kernels' 16-byte vector loads
    "vec_loads_bf16_d96": (2, 130, 130, 4, 2, 96, True, torch.bfloat16),
    "vec_loads_bf16_d32": (2, 100, 100, 4, 4, 32, False, torch.bfloat16),
    # the tensor-core route: ragged tiles, rows that attend nothing
    # (Sq > Sk causal), non-causal, GQA 32 on 8, GPT's packed views
    "tc_ragged_130_d128": (1, 130, 130, 2, 1, 128, True, torch.bfloat16),
    "tc_ragged_1000_d64": (1, 1000, 1000, 2, 2, 64, True, torch.bfloat16),
    "tc_ragged_1000_d128": (1, 1000, 1000, 4, 2, 128, True,
                            torch.bfloat16),
    "tc_sq_lt_sk_d64": (2, 70, 300, 4, 2, 64, True, torch.bfloat16),
    "tc_sq_lt_sk_d128": (1, 130, 260, 2, 2, 128, True, torch.bfloat16),
    "tc_sq_gt_sk_d64": (1, 260, 130, 4, 4, 64, True, torch.bfloat16),
    "tc_sq_gt_sk_d128": (1, 300, 70, 4, 2, 128, True, torch.bfloat16),
    "tc_noncausal_d64": (2, 200, 200, 4, 4, 64, False, torch.bfloat16),
    "tc_noncausal_sq_ne_sk_d128": (1, 90, 260, 4, 2, 128, False,
                                   torch.bfloat16),
    "tc_gqa_32_8_d128": (1, 256, 256, 32, 8, 128, True, torch.bfloat16),
    "tc_gqa_32_8_d64": (1, 192, 192, 32, 8, 64, False, torch.bfloat16),
    "tc_gpt_views_d64": (2, 256, 256, 12, 12, 64, True, torch.bfloat16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_kernels_match_plain_on_card(cuda, name):
    b, sq, sk, hq, hk, d, causal, dtype = GPU_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    # q, k, v as unbound views of a packed tensor (the GPT qkv layout)
    if sq == sk and hq == hk:
        qkv = torch.randn(b, sq, 3, hq, d, generator=gen, device=cuda)
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
        k = torch.randn(b, sk, hk, d, generator=gen, device=cuda).to(dtype)
        v = torch.randn(b, sk, hk, d, generator=gen, device=cuda).to(dtype)
    do = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd
    n = (fwd.launches, bwd.launches, fwd.tc_launches, bwd.tc_launches)
    assert tfa._vec_ok((q, k, v, do)) == (d % (16 // q.element_size())
                                          == 0)
    tc = dtype == torch.bfloat16 and d in (64, 128)
    assert tfa.tc_route(q, k, v, do) is tc
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    grads = tfa.flash_attention_bwd(q, k, v, do, o, lse, causal)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, fwd.tc_launches,
            bwd.tc_launches) == (n[0] + 1, n[1] + 1, n[2] + tc, n[3] + tc)
    f32 = [x.float() for x in (q, k, v, do)]
    ro, rlse = tfa.flash_attention_fwd_plain(*f32[:3], causal)
    if tc:
        lims, (ro, *rgrads) = tfa.tc_tolerances(q, k, v, do, o, lse, causal)
        for g, r, name in zip((o, *grads), (ro, *rgrads),
                              ("o", "dq", "dk", "dv")):
            assert g.dtype == dtype
            worst = _tc_worst(g, r, lims[name])
            assert worst <= 1, f"{name}: error {worst:.3g} x its limit"
        torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=2e-5)
        rows = _attending_rows(sq, sk, causal)
        dead = np.setdiff1d(np.arange(sq), rows)
        assert (o[:, dead] == 0).all() and (grads[0][:, dead] == 0).all()
        assert (lse[:, :, dead] == tfa.NEG_INF).all()
        return
    rgrads = tfa.flash_attention_bwd_plain(*f32, o.float(), lse, causal)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, rtol=0, atol=2e-5)
        torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=2e-5)
        for g, r in zip(grads, rgrads):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    else:
        _bf16_close(o.float().cpu(), ro.cpu(), "o")
        torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=2e-5)
        for g, r, n in zip(grads, rgrads, ("dq", "dk", "dv")):
            assert g.dtype == dtype
            _bf16_close(g.float().cpu(), r.cpu(), n)
