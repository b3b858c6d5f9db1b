#!/usr/bin/env python3
"""Where the time of the f32 (3xTF32) ``flash_attention`` kernel goes.

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
into ``build/flash_tf32_products/`` (the sources in the repository are
not touched) and times the attention kernel at ChatGLM3-6B's prefill
shape (b 4, 32/2 heads, S 2048, D 128, causal) and the D 64 / D 256
shapes of ``chip_smoke.py`` phase 9 (Gemma-2B's at S 4096 last): a call
of the wrapper (``flash_attention.flash_attention`` on the variant's
library, its ``split_kv`` pre-pass included) less a call of
``split_kv`` alone:

* ``as is`` — the kernel;
* ``select in P's split`` — P's lo plane made as the pre-pass makes it,
  ``isfinite(hi) ? rna(p - hi) : 0``: ptxas then serialises every wgmma
  (its C7513 warning is counted);
* ``no P·V restarts`` — at D 256, P·V chained into o over every key,
  never committed to the output (``kChain`` out of reach): what the
  restarts every 1 024 keys cost;
* ``scores 1 product``, ``P·V 1 product``, ``both 1 product`` — only the
  hi·hi product of the scores, of P·V, or of both (wrong on purpose):
  the time each product costs, and what is left when one of each runs.

Needs one NVIDIA card and nvcc; run from the repository root::

    python3 scripts/flash_tf32_products.py

Prints one line a variant and the card's name and power limit.
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = (((4, 32, 2048, 128), (4, 2, 2048, 128)),
          ((4, 32, 2048, 64), (4, 4, 2048, 64)),
          ((4, 8, 2048, 256), (4, 1, 2048, 256)),
          ((1, 8, 4096, 256), (1, 1, 4096, 256)))
QK3 = """      qk<BKV>(s, desc_sw128(ql + oq, 16, 1024), desc_sw128(kh + ok, 16, 1024), kk > 0);
      qk<BKV>(s, desc_sw128(qh + oq, 16, 1024), desc_sw128(kl + ok, 16, 1024), 1);
      qk<BKV>(s, desc_sw128(qh + oq, 16, 1024), desc_sw128(kh + ok, 16, 1024), 1);"""
QK1 = """      qk<BKV>(s, desc_sw128(qh + oq, 16, 1024), desc_sw128(kh + ok, 16, 1024), kk > 0);"""
PV3 = """      pv<D>(acc, pl[tt], v_desc(vh, tt), tt > 0 || first_scale);
      pv<D>(acc, ph[tt], v_desc(vl, tt), 1);
      pv<D>(acc, ph[tt], v_desc(vh, tt), 1);"""
PV1 = """      pv<D>(acc, ph[tt], v_desc(vh, tt), tt > 0 || first_scale);"""
LO = """        pl[q][e] = __float_as_uint(tf32_rna(x[e] - hi));"""
LO_SELECT = """        pl[q][e] = __float_as_uint(isfinite(hi) ? tf32_rna(x[e] - hi) : 0.0f);"""
CHAIN = """  static constexpr int kChain = 1024 / BKV;"""
NO_CHAIN = """  static constexpr int kChain = 1 << 24;"""
VARIANTS = {"as is": [], "select in P's split": [(LO, LO_SELECT)],
            "no P·V restarts": [(CHAIN, NO_CHAIN)],
            "scores 1 product": [(QK3, QK1)], "P·V 1 product": [(PV3, PV1)],
            "both 1 product": [(QK3, QK1), (PV3, PV1)]}


def mean_ms(fn, reps=20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_variant(path: str) -> str:
    """Mean ms of the attention kernel at each of SHAPES with the library
    at ``path`` (runs in its own process): the wrapper's call less its
    pre-pass."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    real = _build.lib
    _build.lib = lambda n: ctypes.CDLL(path) if n == "flash_attention" else real(n)
    fa._lib.cache_clear()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for qs, ks in SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device=dev) for s in (qs, ks, ks))
        call = mean_ms(lambda: fa.flash_attention(q, k, v, True, qs[3] ** -0.5, 0))
        split = mean_ms(lambda: fa.split_kv(k, v))
        out.append(f"D {qs[3]} S {qs[2]} {call - split:.3f} ms")
    return ", ".join(out)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(time_variant(sys.argv[2]), flush=True)
        return 0
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    src = open(os.path.join(_build.CSRC, "flash_attention.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        d = os.path.join(ROOT, "build", "flash_tf32_products", str(len(procs)))
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_build.CSRC):
            shutil.copy(os.path.join(_build.CSRC, f), d)
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: the kernel source no longer has the text to patch")
            text = text.replace(old, new)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libflash_attention.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", d, "-o", lib, os.path.join(d, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    failed = False
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}")
            failed = True
            continue
        serial = sum("C7513" in line and "flash_tf32" in line for line in log.splitlines())
        times = subprocess.run([sys.executable, __file__, "--time", lib], check=True,
                               capture_output=True, text=True, timeout=300).stdout.strip()
        print(f"{name}: {times} (ptxas serialised {serial} of 3 kernels)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
