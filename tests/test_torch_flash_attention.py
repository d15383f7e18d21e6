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
versions, with TF32 off: fp32 o and lse within 2e-5, grads within 1e-4;
bf16 as above, against the plain version run in fp32 on the same bf16
inputs. JAX is imported inside a fixture, so this file also collects on
a machine without JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

FP32 = dict(o=1e-5, lse=1e-5, grad=1e-4)
BLOCKS = (32, 32)


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


# ------------------------------------------------------------ card --
GPU_CASES = {
    # name: (b, sq, sk, hq, hk, d, causal, dtype)
    "causal_f32_d64": (2, 100, 100, 4, 4, 64, True, torch.float32),
    "noncausal_f32_d64": (2, 100, 100, 4, 4, 64, False, torch.float32),
    "causal_bf16_d64": (2, 130, 130, 4, 4, 64, True, torch.bfloat16),
    "gqa_8_2_bf16_d128": (1, 130, 130, 8, 2, 128, True, torch.bfloat16),
    "sq_lt_sk_f32_d16": (2, 70, 130, 4, 2, 16, True, torch.float32),
    "sq_gt_sk_f32_d40": (1, 130, 70, 2, 1, 40, True, torch.float32),
    # rows of 40 bytes: not whole 16-byte chunks, the scalar-load path
    "scalar_loads_bf16_d20": (2, 90, 90, 4, 2, 20, True, torch.bfloat16),
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
    n_fwd = tfa.flash_attention_fwd.launches
    n_bwd = tfa.flash_attention_bwd.launches
    assert tfa._vec_ok((q, k, v, do)) == (d % (16 // q.element_size())
                                          == 0)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    grads = tfa.flash_attention_bwd(q, k, v, do, o, lse, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == n_fwd + 1
    assert tfa.flash_attention_bwd.launches == n_bwd + 1
    f32 = [x.float() for x in (q, k, v, do)]
    ro, rlse = tfa.flash_attention_fwd_plain(*f32[:3], causal)
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
