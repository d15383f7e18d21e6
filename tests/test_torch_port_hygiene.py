"""The port stands alone: no JAX, no ``paddle_tpu``, no silent CPU
fallback, and a clear error where the CUDA toolchain is missing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.models.llama\n"
            "import paddle_tpu_torch.nn.layers\n"
            "import paddle_tpu_torch.ops.cuda._build\n"
            "import paddle_tpu_torch.amp, paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.core.dtype\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n"
            "from paddle_tpu_torch.ops.cuda import _build, rope, "
            "fused_residual_norm\n"
            "assert _build._loaded == {}, _build._loaded\n"
            "assert rope._fn is None and fused_residual_norm._fns is None\n"
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


@pytest.mark.parametrize("call,slice_name", [
    ("qkv_rope", "LLaMA"), ("qkv_rms", "LLaMA"), ("qkv_split", "LLaMA"),
    ("qkv_int8", "kv_quant"), ("qkv_scales", "kv_quant"),
    ("qkv_bf16", "bf16 variant of the paged attention"),
    ("mlp_llama", "LLaMA"), ("mlp_rms", "LLaMA"), ("epi_rms", "LLaMA"),
    ("decode_fused_fn", "LLaMA"), ("paged_attend_scales", "kv_quant"),
])
def test_unported_decode_branches_name_their_slice(call, slice_name):
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq

    qkv, mlp, epi = _decode_args("cpu")
    kw = dict(n_heads=1, n_kv_heads=1, head_dim=8)
    pool8 = torch.zeros(1, 5, 4, 8, dtype=torch.int8)
    poolb = torch.zeros(1, 5, 4, 8, dtype=torch.bfloat16)
    calls = {
        "qkv_rope": lambda: fq.fused_decode_qkv(*qkv, rope_theta=1e4, **kw),
        "qkv_rms": lambda: fq.fused_decode_qkv(*qkv, norm="rms", **kw),
        "qkv_split": lambda: fq.fused_decode_qkv(
            *qkv[:3], [qkv[3][:8]] * 3, [], *qkv[5:], **kw),
        "qkv_int8": lambda: fq.fused_decode_qkv(*qkv[:7], pool8, pool8,
                                                **kw),
        "qkv_scales": lambda: fq.fused_decode_qkv(
            *qkv, torch.ones(1, 5, 4), torch.ones(1, 5, 4), **kw),
        "qkv_bf16": lambda: fq.fused_decode_qkv(*qkv[:7], poolb, poolb,
                                                **kw),
        "mlp_llama": lambda: fm.fused_decode_mlp(*mlp, arch="llama"),
        "mlp_rms": lambda: fm.fused_decode_mlp(*mlp, norm="rms"),
        "epi_rms": lambda: fm.fused_decode_epilogue(*epi, norm="rms"),
        "decode_fused_fn": lambda: gen._decode_fused_fn(
            torch.nn.Linear(2, 2)),
        "paged_attend_scales": lambda: gen.paged_attend(
            torch.zeros(2, 1, 8), qkv[7], qkv[8], qkv[6], qkv[5],
            k_scales=torch.ones(1, 5, 4), v_scales=torch.ones(1, 5, 4)),
    }
    exc = TypeError if call == "decode_fused_fn" else NotImplementedError
    with pytest.raises(exc, match=slice_name):
        calls[call]()


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
    assert _build.sources() == ["flash_attention", "fused_decode_mlp",
                                "fused_decode_qkv", "fused_optimizer",
                                "fused_residual_norm", "paged_attention",
                                "rope"]


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


@pytest.mark.parametrize("name", ["flash_attention", "fused_optimizer",
                                  "fused_decode_qkv", "fused_decode_mlp",
                                  "rope", "fused_residual_norm"])
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
