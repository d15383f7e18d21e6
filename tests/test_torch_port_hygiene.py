"""The port stands alone: no JAX, no ``paddle_tpu``, no silent CPU
fallback, and a clear error where the CUDA toolchain is missing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
BANNED = ("jax", "jaxlib", "paddle_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path) if m in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.ops.cuda.paged_attention\n"
            "import paddle_tpu_torch.ops.cuda.flash_attention\n"
            "import paddle_tpu_torch.ops.cuda.fused_optimizer\n"
            "import paddle_tpu_torch.ops.cuda.fused_decode_qkv\n"
            "import paddle_tpu_torch.ops.cuda.fused_decode_mlp\n"
            "import paddle_tpu_torch.ops.cuda.rope\n"
            "import paddle_tpu_torch.ops.cuda.fused_residual_norm\n"
            "import paddle_tpu_torch.ops.cuda.norms\n"
            "import paddle_tpu_torch.ops.cuda.quant_matmul\n"
            "import paddle_tpu_torch.quantization\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.models.llama\n"
            "import paddle_tpu_torch.nn.layers\n"
            "import paddle_tpu_torch.ops.cuda._build\n"
            "import paddle_tpu_torch.amp, paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.distributed.collective\n"
            "import paddle_tpu_torch.distributed.parallel\n"
            "import paddle_tpu_torch.core.dtype\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n"
            "from paddle_tpu_torch.ops.cuda import _build, rope, "
            "fused_residual_norm, norms, quant_matmul\n"
            "assert _build._loaded == {}, _build._loaded\n"
            "assert rope._fn is None and fused_residual_norm._fns is None\n"
            "assert norms._fns is None\n"
            "assert quant_matmul._fn is None and quant_matmul._tc_fn is None\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_card_no_fallback(monkeypatch):
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        GPTForCausalLM(cfg)
    model = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ContinuousBatchingEngine(model, max_slots=1, page_size=4)
    eng = ContinuousBatchingEngine(model, max_slots=1, page_size=4,
                                   decode_window=2, prefill_chunk=4,
                                   q_block=2, device="cpu")
    eng.add_request([1, 2, 3], 3)
    (done,) = eng.run().values()
    assert done.finish_reason == "length" and done.tokens.size == 3


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    """The training slice's wrappers run their plain version only for
    CPU tensors; any other device gets the kernel or an error."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fo.fused_update)
    before = [w.launches for w in wrappers]
    x = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_fwd(x, x, x)
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_bwd(x, x, x, x, x, lse)
    w = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fo.fused_update(fo.UpdateSpec(kind="sgd"), w=w, g=w, lr=0.1)
    assert [w.launches for w in wrappers] == before


def _decode_args(device):
    """Tiny inputs of the three fused decode wrappers on ``device``."""
    def z(*s, dtype=torch.float32):
        return torch.zeros(*s, dtype=dtype, device=device)
    qkv = (z(2, 8), z(8), z(8), z(24, 8), z(24), z(2, dtype=torch.int64),
           z(2, 2, dtype=torch.int32), z(1, 5, 4, 8), z(1, 5, 4, 8))
    mlp = (z(2, 8), z(2, 8), z(8, 8), z(8), z(8), z(8), z(32, 8), z(32),
           z(8, 32), z(8))
    epi = (z(2, 8), z(8), z(8), z(16, 8), None, z(2))
    return qkv, mlp, epi


def test_decode_wrappers_refuse_devices_without_a_kernel():
    """The megakernel slice's wrappers run their plain version only for
    CPU tensors; any other device gets the kernel or an error."""
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq

    wrappers = (fq.fused_decode_qkv, fm.fused_decode_mlp,
                fm.fused_decode_epilogue)
    before = [w.launches for w in wrappers]
    qkv, mlp, epi = _decode_args("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fq.fused_decode_qkv(*qkv, n_heads=1, n_kv_heads=1, head_dim=8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fm.fused_decode_mlp(*mlp)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fm.fused_decode_epilogue(*epi, transpose_lm=True)
    assert [w.launches for w in wrappers] == before
    # on the CPU the same calls run the plain versions, and count nothing
    qkv, mlp, epi = _decode_args("cpu")
    fq.fused_decode_qkv(*qkv, n_heads=1, n_kv_heads=1, head_dim=8)
    fm.fused_decode_mlp(*mlp)
    fm.fused_decode_epilogue(*epi, transpose_lm=True)
    assert [w.launches for w in wrappers] == before


def _branch_calls():
    """The fused decode wrappers' branches beyond GPT with fp32 pools, on
    tiny CPU inputs, by name."""
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq

    qkv, mlp, epi = _decode_args("cpu")
    kw = dict(n_heads=1, n_kv_heads=1, head_dim=8)
    pool8 = torch.zeros(1, 5, 4, 8, dtype=torch.int8)
    poolb = torch.zeros(1, 5, 4, 8, dtype=torch.bfloat16)
    scales = (torch.ones(1, 5, 4), torch.ones(1, 5, 4))
    w_up = torch.zeros(32, 8)
    return {
        "qkv_rope": lambda: fq.fused_decode_qkv(*qkv, rope_theta=1e4, **kw),
        "qkv_rms": lambda: fq.fused_decode_qkv(*qkv, norm="rms", **kw),
        "qkv_split": lambda: fq.fused_decode_qkv(
            *qkv[:3], [qkv[3][:8]] * 3, [], *qkv[5:], **kw),
        "qkv_int8": lambda: fq.fused_decode_qkv(*qkv[:7], pool8,
                                                pool8.clone(), *scales,
                                                **kw),
        "qkv_int8_without_scales": lambda: fq.fused_decode_qkv(
            *qkv[:7], pool8, pool8, **kw),
        "qkv_scales_on_fp32_pools": lambda: fq.fused_decode_qkv(
            *qkv, *scales, **kw),
        "qkv_bf16": lambda: fq.fused_decode_qkv(*qkv[:7], poolb, poolb,
                                                **kw),
        "mlp_llama": lambda: fm.fused_decode_mlp(*mlp, w_up, arch="llama"),
        "mlp_llama_without_w_up": lambda: fm.fused_decode_mlp(
            *mlp, arch="llama"),
        "mlp_rms": lambda: fm.fused_decode_mlp(*mlp, norm="rms"),
        "epi_rms": lambda: fm.fused_decode_epilogue(*epi, norm="rms"),
        "decode_fused_fn": lambda: gen._decode_fused_fn(
            torch.nn.Linear(2, 2)),
        "decode_fused_fn_weight_only": lambda: gen._decode_fused_fn(
            _weight_only_llama()),
        "paged_attend_scales": lambda: gen.paged_attend(
            torch.zeros(2, 1, 8), pool8, pool8, qkv[6], qkv[5],
            k_scales=scales[0], v_scales=scales[1]),
    }


def _weight_only_llama():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import weight_only_quantize
    m = LlamaForCausalLM(LlamaConfig(vocab_size=32, hidden_size=16,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=16), device="cpu")
    return weight_only_quantize(m)


@pytest.mark.parametrize("call,slice_name", [
    ("qkv_bf16", "bf16 variant of the paged attention"),
    ("decode_fused_fn", "LLaMA"),
    ("decode_fused_fn_weight_only", "dense projections only, as in the "
                                    "JAX package"),
    ("qkv_int8_without_scales", "int8 pools go with scale pools"),
    ("qkv_scales_on_fp32_pools", "int8 pools go with scale pools"),
    ("mlp_llama_without_w_up", "takes w_up"),
])
def test_unported_decode_branches_name_their_slice(call, slice_name):
    """What the fused decode path still refuses says why: bf16 pools wait
    for a bf16 attention; a model of another family, and a weight-only
    model (the fused kernels read dense projections, as the JAX
    package's do, so no later slice brings it), are not served by the
    megakernel; mismatched pools and weights are caller errors."""
    exc = {"qkv_bf16": NotImplementedError, "decode_fused_fn": TypeError,
           "decode_fused_fn_weight_only": NotImplementedError}.get(
        call, ValueError)
    with pytest.raises(exc, match=slice_name):
        _branch_calls()[call]()


@pytest.mark.parametrize("call", [
    "qkv_rope", "qkv_rms", "qkv_split", "qkv_int8", "mlp_llama", "mlp_rms",
    "epi_rms", "paged_attend_scales"])
def test_ported_decode_branches_run_on_cpu(call):
    """The LLaMA and int8 branches of the fused decode wrappers run their
    plain versions on CPU tensors (their values are held against the JAX
    twins in tests/test_torch_fused_decode.py), counting no launch."""
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq

    wrappers = (fq.fused_decode_qkv, fm.fused_decode_mlp,
                fm.fused_decode_epilogue)
    before = [w.launches for w in wrappers]
    out = _branch_calls()[call]()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t.float()).all() for t in outs)
    assert [w.launches for w in wrappers] == before


def test_engine_refuses_a_model_on_another_device():
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(vocab_size=32, hidden_size=16,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=16), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        ContinuousBatchingEngine(model, device="meta")


def test_chip_smoke_serve_phase_rehearses_on_cpu():
    """chip_smoke's serve phase (engine drive, pool checks, teacher-forced
    check against a plain forward) at a tiny width on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=96)
    out = chip_smoke.serve_phase(0, cfg=cfg, device="cpu")
    assert out["tokens"] == 16 * 32 and out["launches"] == 0


def test_chip_smoke_megakernel_serve_phase_rehearses_on_cpu():
    """chip_smoke's megakernel serve phase (the same drive and checks
    with ``megakernel=True``) at a tiny width on the CPU: the same
    tokens as the unfused phase."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=96)
    model = chip_smoke.serve_model(0, cfg, "cpu")
    out = chip_smoke.serve_phase(0, device="cpu", megakernel=True,
                                 model=model)
    assert out["megakernel"] and out["tokens"] == 16 * 32
    assert set(out["counts"].values()) == {0}
    assert out["near_ties"] == 0 and out["decode_dispatches"] > 0


def test_chip_smoke_train_phase_rehearses_on_cpu():
    """chip_smoke's train phase (O2 AdamW steps through the Paddle entry
    points, loss and finiteness checks) at a tiny width on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=32, recompute=True,
                    recompute_policy="dots_and_kernels_saveable")
    out = chip_smoke.train_phase(0, cfg=cfg, device="cpu", batch=2,
                                 seq=32, warmup=1, steps=2)
    assert len(out["losses"]) == 3 and out["buckets"] == 2
    assert out["mfu"] is None and set(out["counts"].values()) == {0}
    # the first-loss check against the unfused attention
    plain = chip_smoke.train_phase(0, cfg=cfg, device="cpu", batch=2,
                                   seq=32, warmup=1, steps=2, flash=False)
    assert plain["flash"] is False and out["flash"] is True
    cmp = chip_smoke._compare_runs("train", out, plain, "no flash")
    assert cmp["first_loss_gap"] <= chip_smoke.FIRST_LOSS_GAP


@pytest.mark.parametrize("glue", [False, True])
def test_chip_smoke_llama_train_phase_rehearses_on_cpu(glue):
    """chip_smoke's LLaMA train phase (O2 AdamW steps with
    ``train_glue_fusion`` off or on, loss and finiteness checks) at a
    tiny width on the CPU; the flag is restored after."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.core import state
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=32,
                      recompute=True,
                      recompute_policy="dots_and_kernels_saveable")
    out = chip_smoke.llama_train_phase(0, glue, cfg=cfg, device="cpu",
                                       batch=2, seq=32, warmup=1, steps=2)
    assert len(out["losses"]) == 3 and out["buckets"] == 1
    assert out["mfu"] is None and set(out["counts"].values()) == {0}
    assert state.get_flag("train_glue_fusion") is False


@pytest.mark.parametrize("phase", ["gpt_glue", "gpt_norm_backend",
                                   "llama_norm_backend"])
def test_chip_smoke_glue_and_norm_backend_phases_rehearse_on_cpu(phase):
    """chip_smoke's GPT glue-on train phase and its norm-backend phases
    (GPT and LLaMA, ``PDTPU_NORM_BACKEND=pallas`` set for the phase) at a
    tiny width on the CPU, where the switch takes the plain path; the
    flag and the variable are restored after."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.core import state
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig

    small = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=32, recompute=True,
                 recompute_policy="dots_and_kernels_saveable")
    env = os.environ.get("PDTPU_NORM_BACKEND")
    kw = dict(device="cpu", batch=2, seq=32, warmup=1, steps=2)
    if phase == "llama_norm_backend":
        out = chip_smoke.llama_train_phase(
            0, False, cfg=LlamaConfig(num_kv_heads=2, **small),
            norm_backend=True, **kw)
        assert out["buckets"] == 1 and out["norm_backend"]
    else:
        glue = phase == "gpt_glue"
        out = chip_smoke.train_phase(0, cfg=GPTConfig(**small), glue=glue,
                                     norm_backend=not glue, **kw)
        assert out["buckets"] == 2 and out["glue"] is glue
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["mfu"] is None and set(out["counts"].values()) == {0}
    assert state.get_flag("train_glue_fusion") is False
    assert os.environ.get("PDTPU_NORM_BACKEND") == env


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS",
                        (str(tmp_path / "nvcc"),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found") as ei:
        _build.build_all()
    assert "sm_90a" in str(ei.value)
    assert _build.sources() == ["flash_attention", "flash_attention_sm90",
                                "fused_decode_mlp",
                                "fused_decode_qkv", "fused_optimizer",
                                "fused_residual_norm", "norms",
                                "paged_attention", "quant_matmul",
                                "quant_matmul_sm90", "rope"]


def test_failed_build_names_command_and_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler said no' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError) as ei:
        _build.build_all(["paged_attention"])
    msg = str(ei.value)
    assert "fake compiler said no" in msg and "paged_attention.cu" in msg
    assert "arch=compute_90a,code=sm_90a" in msg
    assert not list((tmp_path / "build").glob("*"))


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_sm90",
                                  "fused_optimizer",
                                  "fused_decode_qkv", "fused_decode_mlp",
                                  "rope", "fused_residual_norm",
                                  "quant_matmul", "norms"])
def test_failed_build_of_training_kernels_raises(monkeypatch, tmp_path,
                                                 name):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler said no' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError) as ei:
        _build.load(name)
    msg = str(ei.value)
    assert f"$ {fake}" in msg and f"{name}.cu" in msg
    assert "fake compiler said no" in msg
    assert "arch=compute_90a,code=sm_90a" in msg


def test_weight_only_matmul_defaults_to_the_card(monkeypatch):
    """The weight-only matmul runs its plain version only for CPU
    tensors; the entry points that reach it default to the card and
    raise without one."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    before = qm.weight_only_matmul.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qm.weight_only_matmul(torch.zeros(2, 8, device="meta"),
                              torch.zeros(8, 4, dtype=torch.int8,
                                          device="meta"),
                              torch.ones(4, device="meta"))
    assert qm.weight_only_matmul.launches == before
    cfg = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1,
                      num_heads=2, max_seq_len=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ContinuousBatchingEngine(model, max_slots=1, page_size=4,
                                 kv_quant=True)


def _tiny_serving_models():
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    gpt = GPTForCausalLM(GPTConfig(vocab_size=32, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_seq_len=16), device="cpu")
    llama = LlamaForCausalLM(LlamaConfig(vocab_size=32, hidden_size=16,
                                         num_layers=1, num_heads=2,
                                         max_seq_len=16), device="cpu")
    return gpt, llama


@pytest.mark.parametrize("case,slice_name", [
    ("megakernel_weight_only", "dense projections only"),
    ("megakernel_llama_weight_only", "dense projections only"),
    ("weight_only_int4", "int4 weight-only slice"),
])
def test_unported_serving_switches_name_their_slice(case, slice_name):
    """The megakernel serves dense projections only, as the JAX
    package's does (its fused kernels read each projection's float
    weight), so a weight-only model is refused with that reason and no
    promise of a later slice; int4 names its slice."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.quantization import weight_only_quantize

    geo = dict(max_slots=1, page_size=4, device="cpu")
    gpt, llama = _tiny_serving_models()
    calls = {
        "megakernel_weight_only": lambda: ContinuousBatchingEngine(
            weight_only_quantize(gpt), megakernel=True, **geo),
        "megakernel_llama_weight_only": lambda: ContinuousBatchingEngine(
            weight_only_quantize(llama), megakernel=True, kv_quant=True,
            **geo),
        "weight_only_int4": lambda: weight_only_quantize(
            gpt, algo="weight_only_int4"),
    }
    with pytest.raises(NotImplementedError, match=slice_name) as err:
        calls[case]()
    assert "later slice" not in str(err.value)


@pytest.mark.parametrize("family,kv_quant", [("gpt", True), ("llama", False),
                                             ("llama", True)])
def test_megakernel_serves_llama_and_int8_pools(family, kv_quant):
    """``megakernel=True`` builds an engine for LLaMA and over int8 pools
    (the decode geometry keeps the switch), and serves a request."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    gpt, llama = _tiny_serving_models()
    eng = ContinuousBatchingEngine(
        gpt if family == "gpt" else llama, megakernel=True,
        kv_quant=kv_quant, max_slots=1, page_size=4, decode_window=2,
        prefill_chunk=4, q_block=2, device="cpu")
    assert eng.megakernel is True and eng.kv_quant is kv_quant
    assert eng._geometry()[-2:] == (kv_quant, True)
    eng.add_request([1, 2, 3], 4)
    (done,) = eng.run().values()
    assert done.finish_reason == "length" and done.tokens.size == 4


def test_chip_smoke_llama_serve_phases_rehearse_on_cpu():
    """chip_smoke's LLaMA serve phases at a tiny LlamaConfig on the CPU:
    the weight-only int8 model with int8 KV pages (weights drawn and
    quantized layer by layer, the teacher-forced check against the plain
    forward that replays the quantization) and the fp model."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=96)
    q = chip_smoke.llama_serve_phase(0, cfg=cfg, device="cpu",
                                     quantized=True)
    assert q["tokens"] == 16 * 32 and q["kv_quant"] and q["quantized"]
    assert set(q["counts"].values()) == {0}
    fp = chip_smoke.llama_serve_phase(0, cfg=cfg, device="cpu",
                                      quantized=False)
    assert fp["tokens"] == 16 * 32 and not fp["kv_quant"]


def test_chip_smoke_llama_megakernel_phases_rehearse_on_cpu():
    """chip_smoke's fp32 LLaMA megakernel phases at a tiny LlamaConfig on
    the CPU: fp32 pools unfused and through the megakernel, then int8
    pools unfused and through the megakernel, each with the serve checks
    and the teacher-forced check (the one over int8 pools replaying the
    quantization); all four serve the same tokens here."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=96)
    model = chip_smoke.llama_serve_model(0, cfg, "cpu", quantized=False)
    runs = chip_smoke.llama_megakernel_phases(0, model, device="cpu")
    assert sorted(runs) == ["fp32", "fp32_megakernel", "int8_kv",
                            "int8_kv_megakernel"]
    for name, r in runs.items():
        assert r["tokens"] == 16 * 32 and r["near_ties"] == 0, name
        assert r["megakernel"] is name.endswith("megakernel")
        assert r["kv_quant"] is name.startswith("int8")
        assert set(r["counts"].values()) == {0}
    assert runs["fp32"]["logit_gap"] < 1e-4
    assert runs["fp32_megakernel"]["logit_gap"] < 1e-4
    assert 0 <= runs["int8_kv_megakernel"]["logit_gap"] < 1


def test_chip_smoke_gpt_megakernel_int8_serve_rehearses_on_cpu():
    """chip_smoke's GPT megakernel serve over int8 KV pages at a tiny
    width on the CPU, its teacher replaying the quantization, its near-tie
    margin twice the logit gap measured along the fused decode path."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=96)
    out = chip_smoke.serve_phase(0, cfg=cfg, device="cpu", megakernel=True,
                                 kv_quant=True)
    assert out["megakernel"] and out["kv_quant"]
    assert out["tokens"] == 16 * 32 and out["near_ties"] == 0
    assert 0 <= out["logit_gap"] < 1
    assert out["margin"] == max(chip_smoke.MARGIN, 2 * out["logit_gap"])


def test_chip_smoke_tp_serve_phases_rehearse_on_cpu():
    """chip_smoke's TP serve phase at tiny configs on the CPU: two ranks,
    spawned, over gloo, serve a GPT leg (megakernel over int8 pools) and
    a LLaMA leg (megakernel over fp32 pools) with the per-dispatch
    all-reduce check; the phase itself fails if a rank imported JAX or
    the JAX package, if the ranks' streams or stats differ, or if a
    served token is not the unsharded plain forward's pick (margin twice
    the TP path's measured gap). tests/test_torch_tp_serving.py holds
    every leg against the JAX engine."""
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig
    sys.path.insert(0, str(ROOT))     # the spawned ranks import it too
    try:
        import chip_smoke
        legs = tuple(leg for leg in chip_smoke.TP_LEGS if leg[0] in (
            "gpt_tp2_megakernel_int8_kv", "llama7b_tp2_megakernel"))
        requests = {"gpt": 4, "llama": 3}
        served = chip_smoke.tp_serve_phases(
            0, device="cpu",
            gpt_cfg=GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                              num_heads=4, max_seq_len=96),
            llama_cfg=LlamaConfig(vocab_size=64, hidden_size=32,
                                  num_layers=2, num_heads=4, num_kv_heads=2,
                                  max_seq_len=96),
            legs=legs, requests=requests)
    finally:
        sys.path.remove(str(ROOT))
    assert len(legs) == 2 and sorted(served) == sorted(n for n, *_ in legs)
    for (name, fam, _mk, _kvq) in legs:
        res, n = served[name], requests[fam]
        assert res["requests"] == n
        assert res["checked"] == n * chip_smoke.NEW_TOKENS, name
        assert res["stats"]["tokens_generated"] == n * chip_smoke.NEW_TOKENS
        assert 0 <= res["logit_gap"] < 1e-4, name
        assert res["margin"] == max(chip_smoke.MARGIN, 2 * res["logit_gap"])
