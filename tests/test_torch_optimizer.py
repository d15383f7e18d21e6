"""The port's fused optimizer update and optimizers against the JAX
package's.

``fused_update``'s plain version (the CPU path of the port's wrapper) is
held against the JAX ``fused_update`` with ``impl="jnp"`` and
``impl="pallas_interpret"`` for every kind, with and without master
weights, clip and L2/L1, on the same numpy inputs. The arithmetic is the
same op for op, so the tolerance is 1e-6 of the array's largest value
(fp32 state) and one bf16 rounding for bf16 weights. Then 3-step
trajectories of the port's optimizers (fused and per-param paths) over
a few parameters are held against the JAX optimizers: params, moments,
master weights and beta powers within 1e-6 of their largest value, in
fp32 and with bf16 params and fp32 master weights.

On a card (``-m gpu``) the CUDA kernel is held against the plain
version on the same inputs: the kernel performs the plain version's
operations in its order without FMA contraction, so the tolerance is
1e-6 relative for fp32 state and one bf16 rounding for bf16 weights.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo

N = 2048
REL = 1e-6


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
def jfo():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import fused_optimizer
    return fused_optimizer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


SPECS = {
    "sgd": dict(kind="sgd"),
    "sgd_l2": dict(kind="sgd", reg="l2", reg_coeff=0.01),
    "momentum": dict(kind="momentum", momentum=0.9),
    "momentum_nesterov_rescale": dict(kind="momentum", momentum=0.8,
                                      nesterov=True, rescale=0.5),
    "momentum_l1": dict(kind="momentum", reg="l1", reg_coeff=0.003),
    "adam": dict(kind="adam"),
    "adam_l2": dict(kind="adam", reg="l2", reg_coeff=0.02),
    "adamw": dict(kind="adamw", decay=0.01),
    "adamw_l1": dict(kind="adamw", decay=0.1, reg="l1", reg_coeff=0.001),
}


def _state(seed, spec, master):
    """Flat numpy inputs; w is bf16-representable when there are master
    weights (the bf16 bucket), and a zero sits in w for sign(0)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=N).astype(np.float32)
    w[7] = 0.0
    g = (rng.normal(size=N) * 0.1).astype(np.float32)
    m = (rng.normal(size=N) * 0.01).astype(np.float32)
    v = np.abs(rng.normal(size=N) * 1e-4).astype(np.float32)
    if master:
        w = torch.tensor(w).to(torch.bfloat16).float().numpy()
        g = torch.tensor(g).to(torch.bfloat16).float().numpy()
    return w, g, m, v


def _close(got, want, bf16, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    # relative to the array's largest value: interpret-mode Pallas may
    # contract a multiply-add, which moves a near-cancelled element by
    # an ulp of its inputs, not of its own size
    lim = (2.0 ** -8 * np.abs(want) + 1e-30 if bf16
           else REL * np.abs(want).max() + 1e-30)
    bad = np.abs(got - want) > lim
    assert not bad.any(), (f"{what}: {bad.sum()} elements off, max abs "
                           f"err {np.abs(got - want).max():.3g}")


def _port_update(spec_kw, master, clip, w, g, m, v, device="cpu"):
    spec = tfo.UpdateSpec(**spec_kw, use_master=master,
                          has_clip=clip is not None)
    dt = torch.bfloat16 if master else torch.float32
    tw = torch.tensor(w, device=device).to(dt)
    tg = torch.tensor(g, device=device).to(dt)
    tm = torch.tensor(m, device=device)
    tv = torch.tensor(v, device=device)
    tmw = torch.tensor(w, device=device) if master else None
    b1p = torch.tensor(0.9 ** 3, dtype=torch.float32, device=device)
    b2p = torch.tensor(0.999 ** 3, dtype=torch.float32, device=device)
    out = tfo.fused_update(spec, w=tw, g=tg, lr=1e-3, clip_scale=clip,
                           master=tmw, m=tm, v=tv, b1p=b1p, b2p=b2p)
    return spec, out


@pytest.mark.parametrize("clip", [None, 0.37], ids=["noclip", "clip"])
@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_fused_update_plain_matches_jax(jfo, name, master, clip):
    import jax.numpy as jnp
    spec_kw = SPECS[name]
    w, g, m, v = _state(sorted(SPECS).index(name), spec_kw, master)
    spec, out = _port_update(spec_kw, master, clip, w, g, m, v)
    jspec = jfo.UpdateSpec(**spec_kw, use_master=master,
                           has_clip=clip is not None)
    jdt = jnp.bfloat16 if master else jnp.float32
    for impl in ("jnp", "pallas_interpret"):
        want = jfo.fused_update(
            jspec, w=jnp.asarray(w, jdt), g=jnp.asarray(g, jdt), lr=1e-3,
            clip_scale=clip, master=jnp.asarray(w) if master else None,
            m=jnp.asarray(m), v=jnp.asarray(v),
            b1p=jnp.float32(0.9 ** 3), b2p=jnp.float32(0.999 ** 3),
            impl=impl)
        for i, what in enumerate(("w", "master", "m", "v", "b1p", "b2p")):
            if want[i] is None:
                assert out[i] is None, what
                continue
            got = out[i].float().numpy()
            exp = np.asarray(want[i].astype(jnp.float32))
            _close(got, exp, master and what == "w", f"{impl} {what}")


def test_fused_update_updates_in_place_and_validates():
    spec = tfo.UpdateSpec(kind="adamw", decay=0.01)
    w, g = torch.ones(8), torch.full((8,), 0.5)
    m, v = torch.zeros(8), torch.zeros(8)
    b1p = torch.tensor(1.0)
    out = tfo.fused_update(spec, w=w, g=g, lr=0.1, m=m, v=v, b1p=b1p,
                           b2p=b1p)
    assert out[0] is w and out[2] is m and out[3] is v and out[1] is None
    assert float(out[4]) == pytest.approx(0.9) and (w < 1).all()
    assert (m != 0).all() and (v != 0).all()
    with pytest.raises(ValueError, match="needs v"):
        tfo.fused_update(spec, w=w, g=g, lr=0.1, m=m, b1p=b1p, b2p=b1p)
    with pytest.raises(ValueError, match="1-D"):
        tfo.fused_update(tfo.UpdateSpec(kind="sgd"), w=w[None], g=g[None],
                         lr=0.1)
    with pytest.raises(ValueError, match="must match"):
        tfo.fused_update(tfo.UpdateSpec(kind="sgd"), w=w,
                         g=g.to(torch.bfloat16), lr=0.1)


# ------------------------------------------------------------ card --
@pytest.mark.gpu
@pytest.mark.parametrize("clip", [None, 0.37], ids=["noclip", "clip"])
@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_matches_plain_on_card(cuda, name, master, clip):
    spec_kw = SPECS[name]
    w, g, m, v = _state(7, spec_kw, master)
    n0 = tfo.fused_update.launches
    _, got = _port_update(spec_kw, master, clip, w, g, m, v, device=cuda)
    torch.cuda.synchronize()
    assert tfo.fused_update.launches == n0 + 1
    _, want = _port_update(spec_kw, master, clip, w, g, m, v, device="cpu")
    for i, what in enumerate(("w", "master", "m", "v")):
        if want[i] is None:
            continue
        _close(got[i].float().cpu().numpy(), want[i].float().numpy(),
               master and what == "w", what)


# ---------------------------------------------------- trajectories --
SHAPES = [(6, 3), (17,), (2, 2, 2)]
KINDS = ["sgd", "momentum", "adam", "adamw"]
MOMENTS = {"sgd": (), "momentum": ("velocity",),
           "adam": ("moment1", "moment2"), "adamw": ("moment1", "moment2")}


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return [(rng.normal(size=s) * 0.5).astype(np.float32) for s in SHAPES]


def _make(mod, name, ps, clip, clip_cls, multi):
    kw = dict(parameters=ps, multi_precision=multi)
    if clip:
        kw["grad_clip"] = clip_cls(1.0)
    return {"sgd": lambda: mod.SGD(0.1, **kw),
            "momentum": lambda: mod.Momentum(0.1, 0.9, use_nesterov=True,
                                             **kw),
            "adam": lambda: mod.Adam(0.05, **kw),
            "adamw": lambda: mod.AdamW(0.05, weight_decay=0.1, **kw)}[name]()


def _jax_run(name, dtype, clip, steps=3):
    import paddle_tpu as pt
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.nn import ClipGradByGlobalNorm
    ps = []
    for v in _values():
        p = pt.Parameter(v)
        if dtype == "bfloat16":
            p._write(p._read().astype(dtype))
        ps.append(p)
    o = _make(jopt, name, ps, clip, ClipGradByGlobalNorm,
              dtype == "bfloat16")
    for i in range(steps):
        for p, g in zip(ps, _grads(i)):
            p.grad = pt.to_tensor(g if dtype == "float32"
                                  else g.astype(dtype))
        o.step()
        o.clear_grad()
    for i, p in enumerate(ps):
        p.name = f"w{i}"
    sd = {k: np.asarray(t._read().astype("float32"))
          for k, t in o.state_dict().items()
          if k not in ("@step", "LR_Scheduler")}
    return [np.asarray(p._read().astype("float32")) for p in ps], sd


def _port_run(name, dtype, clip, steps=3):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    dt = getattr(torch, dtype)
    ps = [torch.nn.Parameter(torch.tensor(v).to(dt)) for v in _values()]
    o = _make(topt, name, ps, clip, ClipGradByGlobalNorm,
              dtype == "bfloat16")
    for i in range(steps):
        for p, g in zip(ps, _grads(i)):
            p.grad = torch.tensor(g).to(dt)
        o.step()
        o.clear_grad()
    sd = {}
    idx = {id(p): i for i, p in enumerate(ps)}
    for acc, store in o._accumulators.items():
        for p, t in store.items():
            sd[f"w{idx[id(p)]}.{acc}"] = t.float().numpy()
    for p, t in o._master_weights.items():
        sd[f"w{idx[id(p)]}.master_weight"] = t.numpy()
    for grp in o._flat or ():
        if grp.b1p is not None:
            for p in grp.params:
                sd[f"w{idx[id(p)]}.beta1_pow"] = grp.b1p.numpy()
                sd[f"w{idx[id(p)]}.beta2_pow"] = grp.b2p.numpy()
    return [p.detach().float().numpy() for p in ps], sd, o


@pytest.fixture(params=[True, False], ids=["fused", "per_param"])
def fused(request):
    from paddle_tpu_torch.core import state
    state.set_flags({"fused_opt": request.param})
    yield request.param
    state.set_flags({"fused_opt": True})


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", KINDS)
def test_trajectory_matches_jax(jfo, name, dtype, clip, fused):
    jps, jsd = _jax_run(name, dtype, clip)
    tps, tsd, o = _port_run(name, dtype, clip)
    assert bool(o._flat) == fused
    for i, (a, b) in enumerate(zip(tps, jps)):
        _close(a, b, dtype == "bfloat16", f"w{i}")
    want = {k for k in jsd if k.rsplit(".", 1)[1] in
            MOMENTS[name] + ("master_weight", "beta1_pow", "beta2_pow")}
    assert want <= set(tsd), sorted(want - set(tsd))
    for k in want:
        _close(tsd[k].ravel()[:1] if "_pow" in k else tsd[k],
               jsd[k].ravel()[:1] if "_pow" in k else jsd[k], False, k)


def test_master_weights_come_from_the_bf16_params():
    from paddle_tpu_torch import amp, optimizer as topt
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.fill_(0.1234567)
    opt = topt.AdamW(learning_rate=0.0, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    model(torch.ones(2, 4, dtype=torch.bfloat16)).float().sum().backward()
    opt.step()
    master = opt._master_weights[model.weight]
    assert master.dtype == torch.float32
    # made from the bf16-cast parameter, not from the fp32 0.1234567
    assert torch.equal(master, model.weight.float())
    assert float(master[0, 0]) != pytest.approx(0.1234567, abs=1e-6)


def test_fused_path_reads_this_steps_grads():
    """Grads are gathered into the bucket every step with one cat:
    after clear_grad() drops them, autograd makes fresh tensors, and
    the kernel must read those (and the fused and per-param paths must
    agree step for step)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core import state
    ps_f = [torch.nn.Parameter(torch.tensor(v)) for v in _values()]
    ps_p = [torch.nn.Parameter(torch.tensor(v)) for v in _values()]
    of = topt.AdamW(0.05, parameters=ps_f)
    op = topt.AdamW(0.05, parameters=ps_p)
    x = torch.tensor(_values(5)[0])
    for step in range(3):
        for ps, o, fused in ((ps_f, of, True), (ps_p, op, False)):
            state.set_flags({"fused_opt": fused})
            try:
                loss = (ps[0] * x * (step + 1)).sum() + sum(
                    (p * (step + 2)).square().sum() for p in ps[1:])
                loss.backward()
                grads = [p.grad.clone() for p in ps]
                o.step()
                if fused:
                    grp = o._flat[0]
                    np.testing.assert_array_equal(
                        grp.grad_flat[:grp.total].numpy(),
                        torch.cat([g.reshape(-1) for g in grads]).numpy())
                o.clear_grad()
            finally:
                state.set_flags({"fused_opt": True})
        for a, b in zip(ps_f, ps_p):
            np.testing.assert_array_equal(a.detach().numpy(),
                                          b.detach().numpy())
    assert of._flat and not op._flat
    # the parameters are views of the flat param buffer
    grp = of._flat[0]
    assert all(grp.owns(p, i) for i, p in enumerate(ps_f))
