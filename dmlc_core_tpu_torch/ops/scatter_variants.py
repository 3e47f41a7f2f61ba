"""Variants of the gradient scatters K2 and K4, timed on one NVIDIA GPU.

    python3 -m dmlc_core_tpu_torch.ops.scatter_variants

Each variant is ``csrc/ell_kernels.cu`` with named text substitutions (a
design choice undone, or one phase removed), compiled with ``_build``'s
nvcc flags into ``.build/variants/`` at the checkout root, all builds
started together. Each is timed at the Criteo slice (B=2048, K=39, E=16,
D=2^20, f32 values, 13 dense columns in every row) as the FM step runs
it: the dense gradient zero-filled, then the kernel, 20 times under
torch.profiler, twice; the kernels' mean device µs per call are printed
as one JSON line per variant, with the largest difference of its
gradients from the committed kernel's. A variant that removes a phase
computes wrong gradients: it times what the phase costs, nothing else.
It needs the card and the CUDA toolkit, and ends with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _build

B, K, E, D = 2048, 39, 16, 1 << 20
N_DENSE = 13

_HOIST = """#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (at[q] >= 0) atomicAdd(sum + at[q], add[q]);
"""
_ADD = "add[q] = en.gx * (srow[en.row * kChunk + e] - __fmul_rn(en.x, vrow[i * kChunk + e]));"
_S_COPY = """    for (int u = threadIdx.x; u < nrows * (kChunk / CW); u += kTile) {
      const int r = u / (kChunk / CW), c = u % (kChunk / CW) * CW;
      if (c < ec) copy_async<COPY>(srow + r * kChunk + c, s + (rows.row0 + r) * E + c0 + c);
    }
"""
# name -> [(text in the source, its replacement)]
VARIANTS = {
    "committed": [],
    "tile 128": [("constexpr int kTile = 256;", "constexpr int kTile = 128;"),
                 ("constexpr int kTableLog = 9;", "constexpr int kTableLog = 8;")],
    "tile 512": [("constexpr int kTile = 256;", "constexpr int kTile = 512;"),
                 ("constexpr int kTableLog = 9;", "constexpr int kTableLog = 10;")],
    "s per entry": [(_S_COPY, ""), ("srow[en.row * kChunk + e]",
                                    "__ldg(s + (rows.row0 + en.row) * E + c0 + e)")],
    "atomics not hoisted": [(_HOIST, ""), (_ADD, _ADD + "\n      if (at[q] >= 0) atomicAdd(sum + at[q], add[q]);")],
    "no L2 prefetch": [("""    if (claimed)
      for (int c = 0; c < ec; c += 8) prefetch_l2(gv + j * E + c0 + c);
""", "")],
    "no flush (wrong)": [("const int slots = *tb.count;", "const int slots = 0;"),
                         ("if (static_cast<int>(threadIdx.x) < *tb.count)", "if (false)")],
    "no shared atomics (wrong)": [
        ("if (at[q] >= 0) atomicAdd(sum + at[q], add[q]);", "if (at[q] >= 0) sum[at[q]] += add[q];"),
        ("if (pos >= 0) atomicAdd(sum + tb.slot_at[pos], c);", "if (pos >= 0) sum[tb.slot_at[pos]] += c;")],
}


def _source(subs) -> str:
    src = _build._SRC.read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"scatter_variants: {old[:60]!r} is not in {_build._SRC.name}")
        src = src.replace(old, new)
    return src


def build_all(out: Path) -> dict:
    """Compiles every variant, all at once; returns name -> library path."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(_source(subs))
        procs[name] = (out / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-o", str(out / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"scatter_variants: {name} does not build:\n{log[-3000:]}")
        libs[name] = so
    return libs


def inputs(dev):
    rng = np.random.default_rng(0)
    idx = np.empty((B, K), np.int64)
    idx[:, :N_DENSE] = np.arange(N_DENSE)
    idx[:, N_DENSE:] = rng.integers(N_DENSE, D, (B, K - N_DENSE))
    val = np.ones((B, K), np.float32)
    val[:, :N_DENSE] = rng.uniform(0, 1, (B, N_DENSE))
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(dev)
    val_t = torch.from_numpy(val).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(D, E, generator=gen, device=dev) * 0.01
    g = torch.randn(B, generator=gen, device=dev)
    s = (v[idx_t.long()] * val_t[..., None]).sum(1)
    return idx_t, val_t, v, s, g


def time_variant(so: Path, dev, data) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx, val, v, s, g = data
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.KERNELS.items():
        getattr(lib, name).argtypes = argtypes
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k4():
        gv = torch.zeros(D, E, device=dev)
        rc = lib.fm_pair_bwd(idx.data_ptr(), val.data_ptr(), 0, v.data_ptr(), s.data_ptr(),
                             g.data_ptr(), gv.data_ptr(), B, K, E, D, stream)
        if rc:
            raise SystemExit(f"scatter_variants: fm_pair_bwd failed to launch: {rc}")
        return gv

    def k2():
        gw = torch.zeros(D, device=dev)
        rc = lib.ell_matvec_bwd(idx.data_ptr(), val.data_ptr(), 0, g.data_ptr(),
                                gw.data_ptr(), B, K, D, stream)
        if rc:
            raise SystemExit(f"scatter_variants: ell_matvec_bwd failed to launch: {rc}")
        return gw

    grads = (k4(), k2())
    for _ in range(5):
        k4()
        k2()
    torch.cuda.synchronize()
    us = {"fm_pair_bwd": [], "ell_matvec_bwd": []}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k4()
                k2()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for name in us:
                if ev.device_type == DeviceType.CUDA and f"{name}_kernel" in ev.key:
                    us[name].append(ev.self_device_time_total / ev.count)
    return {"us": us, "grads": grads}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("scatter_variants: torch.cuda.is_available() is False: this needs a GPU")
    dev = torch.device("cuda", 0)
    libs = build_all(_build._BUILD_DIR.parent / "variants")
    data = inputs(dev)
    ref = None
    for name, so in libs.items():
        res = time_variant(so, dev, data)
        if ref is None:
            ref = res["grads"]
        diff = [float((a - b).abs().max()) for a, b in zip(res["grads"], ref)]
        print(json.dumps({"variant": name, "in_step_us": res["us"],
                          "max_abs_diff": {"fm_pair_bwd": diff[0], "ell_matvec_bwd": diff[1]}}))
        sys.stdout.flush()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
