"""``scrubvae_torch.utils.retry`` against the JAX package's
``scrubvae_tpu/utils/retry.py``: one case for each of
``tests/test_retry.py``'s, on this stack's transient failures (``nvcc``
killed by a signal, a busy build file, a rendezvous timing out), and the
kernel build's ``retry_build`` on a ``subprocess.run`` that fails as nvcc
would."""

import subprocess

import pytest

from scrubvae_tpu.utils import retry as jax_retry
from scrubvae_torch.ops import fused_adamw as fa
from scrubvae_torch.utils import cuda_build, profiling
from scrubvae_torch.utils import retry as retry_mod
from scrubvae_torch.utils.retry import is_transient_backend_error, retry_build, with_backend_retry


class FakeBackendError(RuntimeError):
    pass


def _no_sleep(_):
    pass


@pytest.mark.parametrize(
    "msg",
    [
        "nvcc killed by signal 9 (nvcc -gencode arch=compute_90a,code=sm_90a ...)",
        "[Errno 26] Text file busy: 'build/kernels/fused_adamw_0123.so'",
        "[Errno 16] Device or resource busy",
        "DistStoreError: Timed out after 1801 seconds waiting for clients. 1/2 clients joined.",
        "Socket Timeout",
        "DistNetworkError: Connection refused",
        "Connection reset by peer",
    ],
)
def test_transient_patterns_match(msg):
    assert is_transient_backend_error(FakeBackendError(msg))


@pytest.mark.parametrize(
    "msg",
    [
        "mat1 and mat2 shapes cannot be multiplied (16x32 and 64x8)",
        "expected scalar type Float but found BFloat16",
        "CUDA out of memory. Tried to allocate 12.30 GiB",
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: device-side assert triggered",
        "CUDA error: initialization error",
        "RuntimeError: No CUDA GPUs are available",
        "nvcc failed (nvcc ...):\nfused_adamw.cu(12): error: identifier \"x\" is undefined",
        # sticky whatever else the text says
        "CUDA error: an illegal memory access was encountered; Connection reset by peer",
    ],
)
def test_real_bugs_are_not_transient(msg):
    assert not is_transient_backend_error(FakeBackendError(msg))


def test_one_transient_failure_then_success():
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 1:
            raise FakeBackendError("nvcc killed by signal 9")
        return "ok"

    assert with_backend_retry(body, retries=2, reset_backend=False, sleep=_no_sleep) == "ok"
    assert len(calls) == 2


def test_non_transient_propagates_immediately():
    calls = []

    def body():
        calls.append(1)
        raise ValueError("shape mismatch: (3,) vs (4,)")

    with pytest.raises(ValueError):
        with_backend_retry(body, retries=3, reset_backend=False, sleep=_no_sleep)
    assert len(calls) == 1


def test_exhaustion_reraises_original_error(capsys):
    calls = []
    err = FakeBackendError("DistStoreError: Socket Timeout")

    def body():
        calls.append(1)
        raise err

    with pytest.raises(FakeBackendError) as info:
        with_backend_retry(body, retries=2, reset_backend=False, sleep=_no_sleep)
    assert info.value is err
    assert len(calls) == 3  # 1 try + 2 retries, then a non-zero exit
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 2 and all("Socket Timeout" in line for line in lines)
    assert "attempt 1/3" in lines[0] and "attempt 2/3" in lines[1]


@pytest.mark.parametrize("retries,base_delay", [(2, 10.0), (3, 15.0), (4, 0.5)])
def test_backoff_schedule_equals_the_jax_modules(retries, base_delay):
    """The same delays for the same arguments, ``time.sleep`` replaced by
    a recorder in both modules."""
    got, want = [], []

    def port_body():
        raise FakeBackendError("Connection reset by peer")

    def jax_body():
        raise FakeBackendError("Connection reset by peer")

    with pytest.raises(FakeBackendError):
        with_backend_retry(port_body, retries=retries, base_delay=base_delay, reset_backend=False, sleep=got.append)
    with pytest.raises(FakeBackendError):
        jax_retry.with_backend_retry(
            jax_body, retries=retries, base_delay=base_delay, reset_backend=False, sleep=want.append
        )
    assert got == want == [base_delay * 2**i for i in range(retries)]


def test_backend_reset_runs_between_attempts(monkeypatch):
    resets = []
    monkeypatch.setattr(retry_mod, "_reset_backend", lambda: resets.append(1))
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 1:
            raise FakeBackendError("Text file busy")
        return 7

    assert with_backend_retry(body, retries=2, sleep=_no_sleep) == 7
    assert resets == [1]


def test_reset_drops_the_kernel_library(monkeypatch):
    """The reset itself: every kernel's library handle is forgotten (the
    next launch loads the build again); nothing else changes on the CPU."""
    monkeypatch.setattr(fa.LIBRARY, "handle", object())
    monkeypatch.setattr(profiling.STAMP_LIBRARY, "handle", object())
    retry_mod._reset_backend()
    assert fa.LIBRARY.handle is None and profiling.STAMP_LIBRARY.handle is None


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """``fused_adamw.build`` (``utils.cuda_build``) into ``tmp_path`` with
    ``subprocess.run`` answering from ``codes`` (a return code a call: 0
    writes the output file as nvcc would)."""
    codes, calls = [], []

    def run(cmd, **kw):
        calls.append(cmd)
        rc = codes.pop(0)
        if rc == 0:
            open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, rc, "", "ptxas info: 0 bytes stack frame" if rc == 0 else "error")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", run)
    return codes, calls


def test_retry_build_retries_nvcc_killed_by_a_signal(fake_nvcc, capsys):
    codes, calls = fake_nvcc
    codes += [-9, 0]
    out = retry_build(lambda: fa.build(force=True), sleep=_no_sleep)
    assert out.exists() and out.parent == cuda_build.BUILD_DIR and len(calls) == 2
    assert "nvcc killed by signal 9" in capsys.readouterr().err


def test_retry_build_does_not_retry_a_compile_error(fake_nvcc):
    codes, calls = fake_nvcc
    codes += [2, 0]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        retry_build(lambda: fa.build(force=True), sleep=_no_sleep)
    assert len(calls) == 1
