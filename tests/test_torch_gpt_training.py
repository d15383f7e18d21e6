"""The port's GPT training step against the JAX package's.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 128, S 32, batch 2) is
built by the JAX package from its seed; its weights move into the port
through ``load_gpt_from_jax``, and the same numpy batches go through
both. On the CPU the JAX attention is its plain XLA path and the port's
is the flash kernel's plain version.

* fp32 logits and loss within 1e-5, every parameter grad within 1e-4
  (another summation order through two layers);
* the port with ``recompute=True`` under each ported policy gives the
  grads of no recompute within 1e-6, and ``dots_and_kernels_saveable``
  runs the attention forward once per layer (its output is kept);
* a 3-step AdamW trajectory: losses and final params within 1e-4;
* O2 (bf16 params, fp32 master weights): losses over 3 steps within
  2e-2 relative (the two frameworks round to bf16 at other places);
* ``train_glue_fusion`` on (the fused residual + LayerNorm pair): fp32
  logits and loss within 1e-5 and every grad within 1e-4 of the JAX
  glue-fused GPT, the grads of each recompute policy within 1e-6 of no
  recompute, and the O2 losses over 2 steps within 2e-2 relative;
* the dtype of every parameter's grad after one O2 backward, glue off
  and on, equals the JAX package's (an fp32 LayerNorm weight that
  reaches the fused pair gets a bf16 grad there);
* ``cross_entropy`` takes a float ``[N, 1]`` label as a hard label, as
  the JAX package does (within 1e-6), and still refuses soft labels.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import state as tstate
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_state_to_jax, load_gpt_from_jax)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_residual_norm as tfr

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32, dropout=0.0)
B, S = 2, 32
POLICIES = ["full", "dots_saveable", "dots_and_kernels_saveable"]


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
def jax_weights():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    paddle.seed(0)
    jm = JGPT(JCfg(**CFG))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batches(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64),
             rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64))
            for _ in range(n)]


def _jax_model(weights, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    jm = JGPT(JCfg(**CFG, **kw))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    jm.train()
    return jm


def _port_model(weights, **kw):
    tm = GPTForCausalLM(GPTConfig(**CFG, **kw), device="cpu")
    load_gpt_from_jax(tm, weights)
    return tm


def _port_grads(tm):
    return gpt_state_to_jax({n: p.grad for n, p in tm.named_parameters()})


def _dtype_name(dt):
    return str(dt).split(".")[-1]


def _jax_train(weights, steps, o2=False, lr=1e-3, glue=False):
    """Losses, final params and the first step's logits, grads and grad
    dtypes, with ``train_glue_fusion`` set to ``glue``."""
    import paddle_tpu as paddle
    from paddle_tpu import amp
    from paddle_tpu.core import state as jstate
    from paddle_tpu.nn import functional as JF
    jm = _jax_model(weights)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    if o2:
        jm, opt = amp.decorate(models=jm, optimizers=opt, level="O2",
                               dtype="bfloat16", master_weight=True)
    losses, first = [], {}
    old = jstate.get_flag("train_glue_fusion")
    jstate.set_flags({"train_glue_fusion": glue})
    try:
        for ids, lab in _batches(steps):
            with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
                # forward(ids, labels) as logits + cross-entropy, to keep
                # the logits of the first step
                logits = jm.logits(paddle.to_tensor(ids))
                loss = JF.cross_entropy(
                    logits.reshape([-1, CFG["vocab_size"]]),
                    paddle.to_tensor(lab).reshape([-1]))
            loss.backward()
            if not first:
                params = list(jm.named_parameters())
                first = dict(
                    logits=np.asarray(logits.astype("float32").numpy()),
                    grads={n: np.asarray(p.grad.astype("float32").numpy())
                           for n, p in params},
                    grad_dtypes={n: _dtype_name(p.grad.dtype)
                                 for n, p in params})
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    finally:
        jstate.set_flags({"train_glue_fusion": old})
    final = {k: np.asarray(v.astype("float32").numpy())
             for k, v in jm.state_dict().items()}
    return losses, final, first


@pytest.fixture(scope="module")
def jax_fp32_run(jax_weights):
    return _jax_train(jax_weights, 3)


@pytest.fixture(scope="module")
def jax_glue_step(jax_weights):
    return _jax_train(jax_weights, 1, glue=True)


@pytest.fixture(scope="module")
def jax_o2_run(jax_weights):
    return _jax_train(jax_weights, 3, o2=True)


@pytest.fixture(scope="module")
def jax_o2_glue_run(jax_weights):
    return _jax_train(jax_weights, 2, o2=True, glue=True)


class _Glue:
    """``train_glue_fusion`` set for a block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = tstate.get_flag("train_glue_fusion")
        tstate.set_flags({"train_glue_fusion": self.on})

    def __exit__(self, *exc):
        tstate.set_flags({"train_glue_fusion": self.old})


def _port_train(weights, steps, o2=False, lr=1e-3, glue=False, **kw):
    """Losses, final params and the optimizer; ``dtypes`` on the
    optimizer: the first step's grad dtype of each parameter (JAX
    names)."""
    tm = _port_model(weights, **kw)
    opt = topt.AdamW(learning_rate=lr, parameters=tm.parameters())
    if o2:
        tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                                dtype="bfloat16", master_weight=True)
    losses = []
    with _Glue(glue):
        for ids, lab in _batches(steps):
            with tamp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
                loss = tm(torch.tensor(ids), torch.tensor(lab))
            loss.backward()
            if not losses:
                params = list(tm.named_parameters())
                jnames = gpt_state_to_jax({n: torch.zeros(1)
                                           for n, _ in params})
                opt.dtypes = {j: _dtype_name(tamp.grad_of(p).dtype)
                              for j, (_, p) in zip(jnames, params)}
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    return losses, gpt_state_to_jax(tm.state_dict()), opt


def test_fp32_logits_loss_and_grads_match_jax(jax_weights, jax_fp32_run):
    jlosses, _, first = jax_fp32_run
    ids, lab = _batches(1)[0]
    tm = _port_model(jax_weights)
    assert tm.training
    logits = tm(torch.tensor(ids))
    np.testing.assert_allclose(logits.detach().numpy(), first["logits"],
                               rtol=0, atol=1e-5)
    loss = tm(torch.tensor(ids), torch.tensor(lab))
    assert abs(float(loss.detach()) - jlosses[0]) <= 1e-5
    loss.backward()
    grads = _port_grads(tm)
    assert sorted(grads) == sorted(first["grads"])
    for k, g in first["grads"].items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_policies_keep_grads(jax_weights, policy, monkeypatch):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    ref = _port_model(jax_weights)
    ref(ids, lab).backward()
    want = _port_grads(ref)
    tm = _port_model(jax_weights, recompute=True, recompute_policy=policy)
    calls = []
    plain = tfa.flash_attention_fwd_plain
    monkeypatch.setattr(tfa, "flash_attention_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tm(ids, lab).backward()
    got = _port_grads(tm)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-6, err_msg=k)
    # the attention forward runs again in backward unless it is kept
    kept = policy == "dots_and_kernels_saveable"
    assert len(calls) == CFG["num_layers"] * (1 if kept else 2)


def test_recompute_refuses_other_policies(jax_weights):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    for policy, exc in (("transformer_saveable", NotImplementedError),
                        ("no_such_policy", ValueError)):
        tm = _port_model(jax_weights, recompute=True,
                         recompute_policy=policy)
        with pytest.raises(exc, match=policy):
            tm(ids, lab)


def test_adamw_trajectory_fp32_matches_jax(jax_weights, jax_fp32_run):
    jl, jfinal, _ = jax_fp32_run
    tl, tfinal, opt = _port_train(jax_weights, 3, recompute=True,
                                  recompute_policy="dots_and_kernels_saveable")
    assert opt._flat and len(opt._flat) == 1
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for k, w in jfinal.items():
        np.testing.assert_allclose(tfinal[k], w, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_adamw_trajectory_o2_matches_jax(jax_weights, jax_o2_run):
    jl, _, _ = jax_o2_run
    tl, _, opt = _port_train(jax_weights, 3, o2=True, recompute=True,
                             recompute_policy="dots_and_kernels_saveable")
    # two buckets: bf16 with fp32 masters, fp32 LayerNorm params
    assert sorted((str(g.dtype), g.use_master) for g in opt._flat) == [
        ("torch.bfloat16", True), ("torch.float32", False)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]


def test_o2_casts_at_functional_boundaries(jax_weights):
    tm = _port_model(jax_weights)
    opt = topt.AdamW(parameters=tm.parameters())
    tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                            dtype="bfloat16")
    assert opt._multi_precision
    assert tm.gpt.wte.weight.dtype == torch.bfloat16
    assert tm.gpt.blocks[0].ln1.weight.dtype == torch.float32
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        logits = tm(ids)
        loss = tm(ids, lab)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert tm.gpt.wte.weight.grad.dtype == torch.bfloat16
    assert tm.gpt.ln_f.weight.grad.dtype == torch.float32


def test_unfused_attention_backend_matches_the_kernel_path(jax_weights):
    """``use_flash_attention=False`` routes attention to the plain
    softmax path (``backend="xla"``); fp32 logits agree within 1e-5."""
    ids = torch.tensor(_batches(1)[0][0])
    flash = _port_model(jax_weights)(ids)
    plain = _port_model(jax_weights, use_flash_attention=False)(ids)
    np.testing.assert_allclose(plain.detach().numpy(),
                               flash.detach().numpy(), rtol=0, atol=1e-5)


def test_refusals(monkeypatch):
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTForCausalLM(GPTConfig(**CFG, num_experts=2), device="cpu")
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ids = torch.tensor(_batches(1)[0][0])
    unfused = tm(ids)
    calls = _spy_fused_ln(monkeypatch)
    with _Glue(True):
        # the glue-fused forward computes the unfused one's logits
        fused = tm(ids)
        assert len(calls) == 2 * CFG["num_layers"]
        tm.eval()
        assert torch.equal(tm(ids), unfused.detach())
    assert len(calls) == 2 * CFG["num_layers"]   # eval ignores the flag
    np.testing.assert_allclose(fused.detach().numpy(),
                               unfused.detach().numpy(), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="dropout"):
        GPTForCausalLM(GPTConfig(**dict(CFG, dropout=0.1)),
                       device="cpu")(ids)


def _spy_fused_ln(monkeypatch):
    """Count the fused residual + LayerNorm forward's calls."""
    calls = []
    real = tfr.fused_residual_layer_norm_fwd

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_residual_layer_norm_fwd", spy)
    return calls


def test_glue_fused_logits_loss_and_grads_match_jax(jax_weights,
                                                    jax_glue_step):
    jlosses, _, first = jax_glue_step
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    tm = _port_model(jax_weights)
    with _Glue(True):
        logits = tm(ids)
        np.testing.assert_allclose(logits.detach().numpy(), first["logits"],
                                   rtol=0, atol=1e-5)
        loss = tm(ids, lab)
        assert abs(float(loss.detach()) - jlosses[0]) <= 1e-5
        loss.backward()
    grads = _port_grads(tm)
    assert sorted(grads) == sorted(first["grads"])
    for k, g in first["grads"].items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_glue_recompute_policies_keep_grads(jax_weights, policy,
                                            monkeypatch):
    """With glue on, each policy gives the grads of no recompute within
    1e-6; ``dots_and_kernels_saveable`` runs the fused residual +
    LayerNorm forward once per use (L - 1 ln1, L ln2 and ln_f: 2 L),
    the others run the blocks' ones again in backward."""
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    with _Glue(True):
        ref = _port_model(jax_weights)
        ref(ids, lab).backward()
        want = _port_grads(ref)
        tm = _port_model(jax_weights, recompute=True,
                         recompute_policy=policy)
        calls = _spy_fused_ln(monkeypatch)
        tm(ids, lab).backward()
    got = _port_grads(tm)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-6, err_msg=k)
    L = CFG["num_layers"]
    kept = policy == "dots_and_kernels_saveable"
    assert len(calls) == (2 * L if kept else 4 * L - 1)


def test_glue_o2_losses_match_jax(jax_weights, jax_o2_glue_run):
    jl, _, _ = jax_o2_glue_run
    tl, _, opt = _port_train(jax_weights, 2, o2=True, glue=True,
                             recompute=True,
                             recompute_policy="dots_and_kernels_saveable")
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


@pytest.mark.parametrize("glue", [False, True])
def test_o2_grad_dtypes_match_jax(jax_weights, jax_o2_run, jax_o2_glue_run,
                                  glue):
    """The dtype of every grad after one O2 backward equals the JAX
    package's: the fp32 LayerNorm weights keep fp32 grads through the
    black-listed ``layer_norm``, and get bf16 ones where the fused pair
    casts them to bf16 (glue on: all but block 0's ln1)."""
    want = (jax_o2_glue_run if glue else jax_o2_run)[2]["grad_dtypes"]
    _, _, opt = _port_train(jax_weights, 1, o2=True, glue=glue)
    assert opt.dtypes == want
    narrowed = sorted(k for k, v in want.items() if v == "bfloat16"
                      and ("ln" in k))
    assert narrowed == (sorted(
        f"gpt.{blk}.{ln}.{p}" for blk, ln in
        [("block_0", "ln2"), ("block_1", "ln1"), ("block_1", "ln2")]
        for p in ("weight", "bias")) + ["gpt.ln_f.bias", "gpt.ln_f.weight"]
        if glue else [])


def test_cross_entropy_float_hard_labels_match_jax():
    """A float ``[N, 1]`` label has one entry on the class axis, not
    ``n_class``: a hard label, as the JAX package reads it."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    lab = rng.integers(0, 5, (6, 1)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        want = JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), reduction=red)
        got = TF.cross_entropy(torch.tensor(logits), torch.tensor(lab),
                               reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=0, atol=1e-6, err_msg=red)


def test_cross_entropy_still_refuses_soft_labels():
    logits = torch.zeros(6, 5)
    with pytest.raises(NotImplementedError, match="soft labels"):
        TF.cross_entropy(logits, torch.full((6, 5), 0.2))
    with pytest.raises(NotImplementedError, match="soft labels"):
        TF.cross_entropy(logits, torch.zeros(6, 1), soft_label=True)
