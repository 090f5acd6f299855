"""Build, load and check the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``where2edit_tpu_torch/_build/``
as a shared library named after the hash of the source and the shared
headers (``csrc/*.cuh``), and loaded with ctypes.
Several sources build in parallel (one ``nvcc`` each, started together). No
``nvcc`` means no kernel: the caller gets an error, never a fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from where2edit_tpu_torch.ops.fused_act import fused_leaky_relu

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNEL_SOURCES = ("modconv3x3", "conv3x3", "modconv1x1", "upfirdn2d", "upconv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

        if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def cuda_tool(name: str) -> str:
    """A tool of the CUDA toolkit that holds ``nvcc`` (e.g. ``cuobjdump``)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named source that has no library yet, all in parallel.
    Returns {name: seconds} for what was compiled (0.0 when cached); the
    compiler's register/shared-memory report lands in ``_build/<name>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")  # noqa: SIM115
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, symbol: str, argtypes: list,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, building it first
    if needed."""
    fn = _functions.get((name, symbol))
    if fn is None:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[(name, symbol)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_count(name: str, b: int, h: int, wd: int, cin: int, cout: int,
                device_index: int, bf16: bool = False) -> int:
    """How many blocks share each output tile's Cin range in the 3x3 core of
    ``csrc/<name>.cu`` (its ``w2e_<name>_splits``), per shape, card and
    form (fp32 or bf16)."""
    return load(name, f"w2e_{name}_splits", [ctypes.c_int] * 7)(
        b, h, wd, cin, cout, sm_count(device_index), int(bf16))


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """The form of a kernel call, from its input: fp32 or bf16 (one dtype
    per call; every other operand but the output stays fp32)."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def upcast(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor in fp32 (exactly); any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def check_cuda_tensor(name: str, t: torch.Tensor, shape: tuple,
                      device: torch.device,
                      dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned ``dtype`` tensor
    of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def plain_epilogue(y: torch.Tensor, noise: torch.Tensor | None,
                   noise_weight: torch.Tensor | None, bias: torch.Tensor | None,
                   act: bool, residual: torch.Tensor | None = None) -> torch.Tensor:
    """act(y + noise_weight·noise + bias) + residual, channels last, in y's
    dtype; ``noise`` has y's shape without the channel axis (batch may be
    1)."""
    if noise is not None:
        y = y + (noise_weight * noise[..., None]).to(y.dtype)
    if act:
        y = fused_leaky_relu(y, bias)
    elif bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def lrelu_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """dy · d(lrelu(z, 0.2)·√2)/dz, read from the output y (same sign as z).
    Linear in dy, so it can be differentiated again."""
    return torch.where(y >= 0, dy, dy * 0.2) * math.sqrt(2.0)


def noise_grads(dz: torch.Tensor, noise: torch.Tensor | None,
                noise_weight: torch.Tensor | None, need_noise: bool,
                need_weight: bool):
    """Gradients of ``noise`` (B or 1, *spatial) and ``noise_weight`` (1,)
    in ``z = ... + noise_weight·noise[..., None]`` (channels last), given
    dz; None where not needed."""
    if noise is None or not (need_noise or need_weight):
        return None, None
    dsum = dz.sum(-1)
    dn = dnw = None
    if need_noise:
        dn = noise_weight * dsum
        if noise.shape[0] != dn.shape[0]:
            dn = dn.sum(0, keepdim=True)
    if need_weight:
        dnw = (dsum * noise).sum().reshape(1)
    return dn, dnw


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude, then clear them (the sign bit is apart, so this rounds
    the magnitude for either sign)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tc_prepared_plain(w: torch.Tensor, scale: float = 1.0,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of the weight preparation of the tensor-core kernels, for
    the tests. fp32 (``csrc/conv3x3_tc.cuh``, ``conv3x3_tc_prep``): w
    (3,3,Cin,Cout)·scale split into big = tf32(v) and small = tf32(v - big),
    flat in the kernel's layout [Cout tile][chunk][tap][part][nb][kh][r][q]
    (part 0 big, 1 small) for output channel tile·BN + 8·nb + r and input
    channel chunk·8 + 2·q + kh, zeros past Cin and Cout. With ``dtype``
    bf16 (``csrc/conv3x3_bf16.cuh``, ``conv3x3_bf16_prep``): round(w·scale)
    to bf16, no split, [Cout tile][slice][tap][n][k], K-major, for output
    channel tile·BN + n and input channel slice·KC + k, KC 32 where Cin ≤ 32,
    else 64 (the bf16 core's ``slice_k``). BN is 32, 64 or 128 by Cout in
    both, and in bf16 256 where Cout > 128 and Cin ≤ 128 (the bf16 core's
    ``tile_n``: one accumulator over K there)."""
    cin, cout = w.shape[2], w.shape[3]
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    if dtype == torch.bfloat16:
        bn = 256 if cout > 128 and cin <= 128 else bn
        kc = 32 if cin <= 32 else 64
        slices, tiles = -(-cin // kc), -(-cout // bn)
        v = torch.zeros(9, slices * kc, tiles * bn, dtype=torch.float32)
        v[:, :cin, :cout] = (w.float().cpu() * scale).reshape(9, cin, cout)
        v = v.to(torch.bfloat16).reshape(9, slices, kc, tiles, bn)
        # (tap, slice, k, tile, n) -> (tile, slice, tap, n, k)
        return v.permute(3, 1, 0, 4, 2).reshape(-1)
    chunks, tiles = -(-cin // 8), -(-cout // bn)
    v = torch.zeros(9, chunks * 8, tiles * bn, dtype=torch.float32)
    v[:, :cin, :cout] = (w.float().cpu() * scale).reshape(9, cin, cout)
    big = tf32_rna(v)
    parts = torch.stack([big, tf32_rna(v - big)])  # (part, tap, ci, n)
    # ci = chunk·8 + 2q + kh, n = tile·bn + 8·nb + r
    parts = parts.reshape(2, 9, chunks, 4, 2, tiles, bn // 8, 8)
    # (part, tap, chunk, q, kh, tile, nb, r) -> (tile, chunk, tap, part, nb, kh, r, q)
    return parts.permute(5, 2, 1, 0, 6, 4, 7, 3).reshape(-1)
