#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. setup — build the ten CUDA kernels from the six sources in
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel), print each kernel's registers, shared memory and spills
   (``-Xptxas=-v``, and any warning that it serialised a kernel's
   ``wgmma`` instructions), the warpgroup MMA instructions of each
   tensor-core kernel (``cuobjdump -sass``: HGMMA in ``matmul`` and the
   bf16 and 3xTF32 ``flash_attention`` kernels, IGMMA in the int8
   vertex counts; none fails), and the card.
2. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes: ``fd_round_wing``/``fd_round_tip`` on the
   packed wing-60k / tip-1m partition stacks, round by round to the
   fixed point, every output compared; ``support_update`` and
   ``wedge_count`` on the wing-60k slot matrices; ``wedge_count_tile``
   on the slot matrix of tip-1m's largest wedge tile, built on the card
   from the ingested TSV.  All comparisons are ``torch.equal`` (every
   output is an exact integer).  Times each, and the one PyTorch call
   that computes the same function where there is one.
3. goldens — every cell of ``tests/goldens/peel_goldens.json``: the 72
   csr cells (fused kernels on for the device/vmapped drivers), the 8
   beindex and 24 dense cells, plus kernel-route reruns
   (``use_pallas``) of one wing and one tip graph.
4. tip-1m and 5. wing-60k — the CLI's main path (``repro_torch.launch.
   peel``: the fused device driver, then vmapped and ``--use-pallas``),
   θ and PeelStats held to the JAX package's values in
   ``tests/goldens/torch_fullsize.json``.  tip-1m's default run again
   with ``--trace``: θ, stats and launch counts equal to the untraced
   run, ``cd.round`` spans == ρ_cd and
   ``fd.round`` events == ρ_fd_total, the seconds of each span category
   and the peel's seconds traced against untraced.
6. fd-drivers — from one CD per graph, Phase 2 under every FD driver
   (fused and unfused device/vmapped, and the kernel-free host driver),
   each held to the same JAX values and timed.
7. real-graphs — the ``--edges ... --emit-hierarchy`` path of the CLI:
   ``datasets/southern_women.tsv`` (wing and tip, ``--use-pallas``), the
   tip-1m graph written as a TSV (host tiled init, fused FD, hierarchy
   on the card), the tiled init of tip-1m through ``wedge_count_tile``
   (``tiled_butterfly_init(use_pallas=True)``), the 60k graph as wing
   and tip with ``--use-pallas``; then every artifact loaded back and a
   seeded batch of queries served through ``HierarchyService`` on the
   card.  Every step is held to ``tests/goldens/torch_realdata.json``
   (recorded by ``tests/goldens/record_torch_realdata.py``) and
   ``tests/goldens/real_graphs.json``.
8. engines — the dense and beindex engines and the four butterfly
   kernels at full size, held to ``tests/goldens/torch_engines.json``
   (recorded by ``tests/goldens/record_torch_engines.py``) and
   ``torch_fullsize.json``: dense-16k (16 384² adjacency) through
   ``--kind tip --engine dense`` (its ⋈init, and each batch re-count,
   one ``vertex_count`` launch, counted), then ``ops.vertex_butterflies``,
   ``ops.vertex_butterflies_tiled`` and ``ops.edge_wedge_matrix`` on its
   adjacency (``vertex_count``, ``vertex_count_tile`` — int8 on the
   tensor cores, timed through the f32 interface, on pre-packed int8
   operands, the pack alone, the 16-strip tiled count, and
   ``torch._int_mm`` as a yardstick of the int8 product — and
   ``matmul``, 3xTF32 on the tensor cores, its bound beside the 3xTF32
   and exact-f32 ones), each
   held ``torch.equal`` to its plain version (for the whole-graph counts,
   the route ``core.counting`` itself takes) and to the JAX counts;
   wing-60k through ``--kind wing`` (beindex, the default) and
   ``--engine dense``; its BE-Index built on the card (torch ops, no
   kernel launch, counted), then through ``ops.bloom_update`` round by
   round over seeded peel sets, held to the plain version and to the
   engine's own update every round.
9. lm — the dense-family LM serving path and the ``flash_attention``
   kernel: the kernel against its plain version at ChatGLM3-6B's prefill
   shape, D = 64 (GQA), D = 256 (MQA), a ragged non-causal and an offset
   case, each in bf16 (tensor cores) and f32 (3xTF32 on the tensor
   cores; its ``split_kv`` pre-pass also timed alone, and the call held
   against its 1xTF32, 3xTF32, FP32 and memory bounds), timed beside
   the plain version and SDPA; ChatGLM3-6B at full width and depth 7 of
   its 28 (random weights from a ``torch.Generator``), f32: ``prefill`` at
   b=4, s=2048 (7 kernel launches a call), ``forward``'s logits at 129 of
   the first 512 positions and a prefill of those 512 held to
   teacher-forced ``serve_step``;
   ``ContinuousBatcher`` serving 8 requests through 4 slots, then again
   with an EOS; the same model at full depth in bf16 (12.5 GB):
   ``prefill`` at b=4,
   s=2048 timed twice (28 launches each), and at 256 positions its
   logits and ``forward``'s held to a bf16 teacher-forced decode within
   relative 3e-2; the depth-2 model on ``numpy_params`` held to the JAX
   package's logits in ``tests/goldens/torch_lm.json`` (recorded by
   ``tests/goldens/record_torch_lm.py``); and ``python -m
   repro_torch.launch.serve --arch chatglm3_6b`` in its own process.
10. stream — the streaming updater (``repro_torch.streaming``): the 60k
   graph as wing (csr, device FD driver) and as tip (the same, CD through
   ``wedge_count``, which must launch in every epoch), 4 epochs of 512
   random events each, every epoch (and the initial peel) held to a
   from-scratch re-peel and rebuild on the card — θ, partition, ⋈init,
   ranges, PeelStats and the 15 packed-forest arrays, density allclose —
   and to the JAX package's digests in ``tests/goldens/torch_stream.json``
   (recorded by ``tests/goldens/record_torch_stream.py``); tip-1m's
   generator at a quarter of its scale (``STREAM_LARGE``: 250 000 edges)
   for one epoch of 2 048 events, θ and stats held every
   epoch, the forest at the last, each epoch's report beside the
   re-peel's seconds; then ``python -m repro_torch.launch.stream
   --dryrun`` in its own process.
11. multitenant — the multi-tenant hierarchy service
   (``repro_torch.hierarchy.pool`` / ``multiserve``, ``launch.hserve``):
   the small fixed tenant set of ``tests/goldens/torch_multiserve.json``
   (recorded by ``tests/goldens/record_torch_multiserve.py``, replayed by
   ``tests/goldens/multiserve_replay.py``) to its buckets, stats,
   dispatch signatures and answers' sha256; 8 tip
   (``powerlaw_bipartite(2_000, 1_000, 15_000)``) and 8 wing (``(600,
   400, 3_000)``) graphs peeled on the card with the fused FD rounds
   (``fd_round_tip``, ``fd_round_wing``), θ and stats held bit for bit to
   the same peels on the CPU (the rounds' plain versions), and built into
   forests; with
   phase 7's five artifacts, 64 tenants cycling the 21 decompositions,
   tip-1m pinned; 50 000 mixed queries over all 64 through a 32-slot pool
   at batch 1 024 (cold) and 4 096 (warm), every answer held to a
   per-tenant ``HierarchyService``, the dispatch signatures and the
   pinned tenant checked chunk by chunk; the ``slot_upload`` A/B; one
   ``HierarchyService`` on tip-1m as a yardstick; the CLI (200 000
   queries at batch 4 096, ``--metrics --trace --out``, its checksum held
   to the oracle) and ``--dryrun`` (storage and uploads unmoved by a
   cold same-bucket load, no host sync in a dispatch) in their own
   processes.
12. distributed — the distributed peel (``repro_torch.core.
   distributed``) on ``torch.distributed``.  World 1 on NCCL in this
   process (1-D ``("peel",)`` mesh): every cell of
   ``tests/goldens/torch_distributed.json`` (recorded by
   ``tests/goldens/record_torch_distributed.py`` on 8 JAX devices; θ,
   partition, ranges, ⋈init, stats), then phase 10's tip-250k (csr,
   vertex-aligned; θ held to the stream's single-device initial peel),
   the 60k graph as wing (csr pair-aligned, beindex bloom-aligned, and
   csr on the (1, 1) ``("grp", "loc")`` mesh) and as tip (csr aligned,
   device and vmapped FD), and dense-16k (dense), each with the obs
   layer on: θ held to ``torch_fullsize.json`` / ``torch_engines.json``,
   the module's collectives counted (ρ_cd × 1 or 2, the dense recount 3
   a round; none in FD), no kernel launched, and the seconds of spec,
   CD (``cd.round`` spans) and FD.  Then the peel CLI's ``run`` on four
   gloo ranks sharing the card (``torch.distributed.run``,
   ``distributed_replay.py --graph``), the 60k graph as wing and tip
   with ``--aligned``: θ, stats and the ``--emit-hierarchy`` artifact's
   partition, ranges and ⋈init equal to world 1.  Then ``launch.peel
   --dryrun`` in its own process (512 fake ranks, CPU), and
   ``csr.edge_butterflies_csr(use_pallas=True)`` on the 60k graph's
   wedge list (all alive and a seeded mask): ``wedge_count`` launches
   and the result is ``torch.equal`` to the plain route.
13. train — training on the dense family and the PBNG → LM bridge.
   ``repro_torch.launch.train --arch tinyllama_1_1b --steps 8 --batch 4
   --seq 2048`` (full width, f32, remat ``full``; the CLI's ``train`` in
   this process): every loss finite, the last three steps' mean below
   the first, ``flash_attention`` launched 2 × 22 times a step (the
   forward and the recompute); seconds a step, tokens/s, peak allocated
   memory; one more step under ``torch.profiler``, its device time by
   class (GEMM, the attention kernel, the attention backward, the
   optimizer, the rest), and one layer's attention forward and backward
   timed alone.  At full width and depth 2, every gradient leaf through
   the kernel route against torch autograd through the plain version
   (relative L2 ≤ 1e-4).  The CLI's crash and resume in its own
   processes (``--reduced --steps 30 --ckpt-every 10 --crash-at 15``:
   exit 42, latest step 10, then ``resumed from step 10`` and step 30).
   The 60k graph through ``interaction_curriculum`` (θ held to the
   golden, the levels to its quantile buckets) and
   ``curriculum_sequences`` (each interaction in one sequence), then one
   epoch of a reduced TinyLlama over the node vocabulary (the loss must
   fall); ``moe_affinity`` of a seeded router with DeepSeek-V2's shape
   (160 experts, top-6, 65 536 tokens) on the card equal to the CPU's,
   and ``tests/test_system.py``'s assignment equal to the port's BUP
   oracle (``core/ref.py``).
14. moe — the MoE family at full width (random weights from a seeded
   ``torch.Generator`` unless said).  ``flash_attention`` at DeepSeek-V2's
   MLA prefill shape (128/128 heads, S 2 048, q/k 192 dims, v 128: the
   wrapper zero-pads to the D 256 instance and cuts the output to 128),
   bf16 and f32, against its plain version at b 1 (phase 9's gates),
   timed at b 1 and b 4 beside SDPA.  DeepSeek-V2 at depth 2 in f32
   (36.6 GB): ``prefill`` at b=4, s=2048 twice (2 launches each); layer
   0's ``moe_layer`` on the forward's hidden states (C 96 at the published
   capacity factor 1.25) held to an independent per-expert loop within
   ``MOE_RTOL``, with the dropped (token, expert) pairs counted (> 0);
   ``forward`` at 17 of the first 256 positions held to teacher-forced
   ``serve_step`` through the naive and the absorbed MLA decode, and the
   two held to each other, at capacity factor E / k (C >= s: nothing is
   dropped, as the JAX test's ``reduced`` does with 8.0); the
   ``ContinuousBatcher`` (8 requests, 4 slots, then the EOS rerun); the
   router's top 6 of the prefill's 8 192 tokens through ``moe_affinity``
   on the card equal to the CPU's.  The same weights in bf16: ``prefill``
   twice, its last-position logits within relative 3e-2 of the f32 ones.
   DBRX at depth 1 in f32 (18 GB): ``prefill`` of b=4 × s=2048 Zipf
   tokens (the port's synthetic stream, a text-like load) twice (GQA
   48/8 at D 128), its ``moe_layer`` held to the loop (C 640).
   ``python -m repro_torch.launch.serve --arch deepseek_v2_236b
   --reduced`` in its own process.  DeepSeek-V2 at depth 1 on
   ``numpy_params`` held to
   the JAX package's logits in ``tests/goldens/torch_moe.json``
   (recorded by ``tests/goldens/record_torch_moe.py``; B 2, S 128, C 8:
   the forward drops pairs; the least router margin printed).  Then
   training (``MOE["train"]``): DBRX and DeepSeek-V2 at full width and
   depth 1, f32, one gradient of ``train_loss`` at b 1 × s 2 048 each
   (remat ``full``: two ``flash_attention`` launches a layer), every
   leaf held to the plain route's (``TRAIN_GRAD_RTOL``) and to remat
   ``none``'s (``MOE_REMAT_RTOL``), the peak memory printed; DeepSeek-V2's
   layer 0 ``moe_layer`` gradients (x, router, ``we1`` / ``we3`` /
   ``we2``) held to autograd through the per-expert loop (C 96, drops
   > 0); ``python -m repro_torch.launch.train --arch dbrx_132b|
   deepseek_v2_236b --reduced`` (8 steps) in their own processes, the
   loss falling.  The golden's numpy weights are drawn on a host thread
   started before phase 12.
15. ssm — the SSM and hybrid families.  ``flash_attention`` at Zamba2's
   shared-attention prefill (32/32 heads, S 2 048, D 112: the wrapper
   zero-pads to the D 128 instance), bf16 and f32, held to its plain
   version at b 1, timed at b 1 and 4 beside SDPA, both bounds.
   xLSTM-1.3B and Zamba2-7B at full width and full depth (48 and 81
   layers, f32, random weights from a seeded ``torch.Generator``):
   ``prefill`` at b=4, s=2048 twice (Zamba2: 13 launches a call, one
   each shared-block application; xLSTM none); ``chunked_recurrence``
   at one layer's shape held to the sequential ``recurrence_step`` loop
   (``RECURRENCE_TOL``); ``forward`` at 17 of the first 256 positions
   held to teacher-forced ``serve_step`` (``SSM_DECODE_TOL``, the JAX
   test's); Zamba2's ``ContinuousBatcher`` (8 requests, 4 slots, then
   the EOS rerun) and its bf16 prefill (timed, 13 launches, finite).
   xLSTM at depth 8 and Zamba2 at depth 6 on ``numpy_params`` held to
   the JAX package's logits in ``tests/goldens/torch_ssm.json``
   (recorded by ``tests/goldens/record_torch_ssm.py``; B 2, S 128: two
   chunks), forward and decode, and Zamba2's in bf16 against its f32
   within a multiple of the reference's own bf16 drift
   (``BF16_DRIFT``).  ``python -m repro_torch.launch.serve --arch
   zamba2_7b --reduced`` in its own process.
16. audio-vlm — the audio and VLM families.  ``flash_attention`` at
   their shapes, bf16 and f32, each against its plain version and timed
   beside SDPA: Whisper's encoder (b 4, 20/20 heads of D 64, S 1 500,
   non-causal), its cross-attention of a 448-token prompt and of one
   decode row against the 1 500 frames, Qwen2-VL's prefill (64/8 heads
   of D 128, S 2 048, causal).  Whisper-large-v3 at full width and depth
   (32 + 32 layers, f32, random weights and frames from a seeded
   ``torch.Generator``): ``encode`` alone, ``prefill`` at b=4, s=448
   twice (96 launches a call: the encoder's 32, the decoder's 32 self-
   and 32 cross-attentions), 64 teacher-forced decode steps (32
   cross-attention launches each) held to the forward at every position
   (``WHISPER_DECODE_TOL``, the JAX test's), the ``ContinuousBatcher``
   (8 requests, 4 slots, then the EOS rerun), the decode step's device
   time by kernel class, and the same weights in bf16 (last-position
   logits within relative ``BF16_LOGIT_RTOL`` of f32).  Qwen2-VL-72B at
   full width and depth 8 of 80 (38 GB f32): ``prefill`` at b=4, s=2048
   with M-RoPE positions holding a 32 x 32 image block
   (``mrope_image_positions``) twice, 64 text-only decode steps held to
   the forward, and bf16 against f32 as for Whisper.  Whisper (4 + 4
   layers) and Qwen2-VL (depth 1) on ``numpy_params`` held to the JAX
   package's logits in ``tests/goldens/torch_audio_vlm.json`` (recorded
   by ``tests/goldens/record_torch_audio_vlm.py``; B 2, S 128; Whisper
   over 1 500 recorded-seed frames, its encoder output sampled; Qwen2-VL
   with and without an image block), forward and decode, and in bf16
   within ``golden_bf16``'s limit.  ``python -m repro_torch.launch.serve
   --arch whisper_large_v3 --batch 4 --prompt-len 16 --gen 16`` (full
   size) and ``--arch qwen2_vl_72b --reduced`` in their own processes.
   The goldens' numpy weights are drawn on the host thread of phases
   14-15.  Training: one gradient of Whisper-large-v3 at full width and
   depth (b 2 × 448 tokens over 1 500 seeded frames) and of Qwen2-VL-72B
   at full width, depth 1 (b 2 × 2 048 with the image block's
   positions), f32, remat ``full`` (192 and 2 launches: every attention
   forward and recomputed), each leaf held to the plain route's within
   ``TRAIN_GRAD_RTOL`` and to remat ``none``'s; beside them ``python -m
   repro_torch.launch.train --arch whisper_large_v3|qwen2_vl_72b
   --reduced`` in their own processes, each loss falling.
17. lm-mesh — the LM distribution layer.  A world-1 NCCL group:
   ``make_local_mesh`` (1, 1); ``remesh`` of TinyLlama-1.1B's full-width
   f32 parameters and AdamW state onto it, each ``DTensor`` leaf equal
   to its input; a train step from the re-placed state equal to the
   plain step bit for bit.  Beside it ``python -m
   repro_torch.launch.dryrun --arch tinyllama_1_1b`` (fake groups of 256
   and 512 ranks, the CPU): train_4k's per-device argument bytes on
   16×16 and 2×16×16 equal to JAX's (``LM_MESH``).

Launch counts are set to 0 before each main-path run and read after it.
The last lines are the ``kernels`` JSON, the card's name and power limit
as nvidia-smi prints them, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate at the full 700 W

FP32_FLOP_PER_S = 67e12      # H100 SXM FP32 CUDA-core peak (dense)
TF32_FLOP_PER_S = 495e12     # H100 SXM TF32 tensor-core peak (dense)
INT8_OP_PER_S = 1979e12      # H100 SXM int8 tensor-core peak (dense)

KERNEL_INFO = {
    "fd_round_wing": ("src/repro_torch/kernels/csrc/fd_round.cu",
                      "src/repro/kernels/fd_round.py:111"),
    "fd_round_tip": ("src/repro_torch/kernels/csrc/fd_round.cu",
                     "src/repro/kernels/fd_round.py:172"),
    "support_update": ("src/repro_torch/kernels/csrc/support_update.cu",
                       "src/repro/kernels/support_update.py:82"),
    "wedge_count": ("src/repro_torch/kernels/csrc/wedge_count.cu",
                    "src/repro/kernels/wedge_count.py:89"),
    "wedge_count_tile": ("src/repro_torch/kernels/csrc/wedge_count.cu",
                         "src/repro/kernels/wedge_count.py:59"),
    "bloom_update": ("src/repro_torch/kernels/csrc/bloom_update.cu",
                     "src/repro/kernels/bloom_update.py:47"),
    "vertex_count": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
                     "src/repro/kernels/butterfly_count.py:54"),
    "vertex_count_tile": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
                          "src/repro/kernels/butterfly_count.py:98"),
    "matmul": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
               "src/repro/kernels/butterfly_count.py:149"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:65"),
    # no JAX kernel: the JAX package peels each dense tip partition from
    # a host loop
    "fd_tip_dense": ("src/repro_torch/kernels/csrc/fd_tip_dense.cu",
                     "src/repro/core/peel.py:702"),
    # no JAX kernel: the JAX package peels each beindex partition from a
    # host loop
    "fd_wing_beindex": ("src/repro_torch/kernels/csrc/fd_wing_beindex.cu",
                        "src/repro/core/peel.py:1546"),
}
STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")
INGEST_FILES = ("edges", "off_u", "off_v", "nbr_v", "eid_v")
TILE_FIELDS = ("n_tiles", "n_wedges", "n_pairs", "peak_tile_wedges")
GOLDEN_FIELDS = ("theta", "part", "ranges", "support_init") + STAT_FIELDS


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's seconds when it ends; a failure propagates."""

    seconds: dict = {}

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[smoke] phase {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        Phase.seconds[self.name] = round(dt, 3)
        if exc_type is None:
            log(f"[smoke] phase {self.name}: ok in {dt:.1f} s")
        return False


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def ptxas_resources(log_text: str) -> list:
    """(kernel, "N registers, ... spill ...") for each entry function in an
    ``nvcc -Xptxas=-v`` log.  A kernel that raises its register count with
    ``setmaxnreg`` reports the count it launches with."""
    out, fn, res = [], None, []
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn, res = line.split("'")[1], []
        elif fn and ("spill" in line or "Used" in line):
            res.append(line.split(":", 1)[-1].strip() if "Used" in line
                       else line.strip())
            if "Used" in line:
                out.append((fn, "; ".join(res)))
                fn = None
    return out


# (source, kernel name fragment, instruction): each kernel of the
# tensor-core designs and the warpgroup MMA its machine code must hold —
# HGMMA accumulates in f32 (matmul's TF32, flash_attention's bf16 and
# TF32), IGMMA in s32 (the int8 vertex counts)
TENSOR_CORE_KERNELS = (("butterfly_count", "matmul_tf32x3_kernel", "HGMMA"),
                       ("butterfly_count", "vertex_count_kernel", "IGMMA"),
                       ("flash_attention", "flash_tc_kernel", "HGMMA"),
                       ("flash_attention", "flash_tf32_kernel", "HGMMA"))


def tensor_core_sass(paths: dict) -> dict:
    """The warpgroup MMA instructions (HGMMA, IGMMA, ...) of each kernel
    in the machine code of the tensor-core sources, from ``cuobjdump
    -sass``, as {source: {kernel: {instruction: count}}}; fails if a
    kernel of ``TENSOR_CORE_KERNELS`` has none of its instruction (the
    tensor cores would go unused).  Where the toolkit has no
    ``cuobjdump`` the counts are not measured (None)."""
    import re

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name in sorted({src for src, _, _ in TENSOR_CORE_KERNELS}):
        if not os.path.exists(tool):
            counts[name] = None
            continue
        sass = subprocess.run([tool, "-sass", paths[name]], check=True,
                              capture_output=True, text=True).stdout
        fns, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = fns.setdefault(m.group(1), {})
            elif fn is not None:
                for op in re.findall(r"\b([A-Z]*GMMA)\b", line):
                    fn[op] = fn.get(op, 0) + 1
        counts[name] = {f: c for f, c in fns.items() if c}
        for src, frag, op in TENSOR_CORE_KERNELS:
            if src != name:
                continue
            found = [f for f in fns if frag in f]
            if not found or any(fns[f].get(op, 0) == 0 for f in found):
                raise AssertionError(
                    f"{name}: no {op} instruction in the SASS of {frag} "
                    f"({ {f: fns[f] for f in found} })")
    log(f"[smoke]   warpgroup MMA instructions (cuobjdump -sass): {counts}")
    return counts


def serialized_wgmma(log_text: str) -> list:
    """ptxas's warnings that it serialised a kernel's wgmmas (C75xx): the
    kernel stays right but loses the overlap its design relies on."""
    return [line.strip() for line in log_text.splitlines()
            if "wgmma" in line and "serialized" in line]


def smem_bytes() -> dict:
    """Dynamic shared memory of the tensor-core kernels' blocks (and of
    the CUDA-core attention kernel that D 32 takes), from the constants
    the launch functions use."""
    import ctypes

    from repro_torch.kernels import _build

    mm, fa = _build.lib("butterfly_count"), _build.lib("flash_attention")
    for fn in (mm.matmul_smem_bytes, mm.vertex_count_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    fa.flash_attention_smem_bytes.restype = ctypes.c_longlong
    fa.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    out = {"matmul": int(mm.matmul_smem_bytes()),
           "vertex_count / vertex_count_tile": int(
               mm.vertex_count_smem_bytes())}
    for d in (64, 128, 256):
        out[f"flash_attention bf16 D={d}"] = int(
            fa.flash_attention_smem_bytes(d, 1))
    for d in (32, 64, 128, 256):
        out[f"flash_attention f32 D={d}"] = int(
            fa.flash_attention_smem_bytes(d, 0))
    return out


def require_equal(kernel: str, got, want, where: str) -> None:
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            err = (a.double() - b.double()).abs().max().item()
            raise AssertionError(
                f"{kernel}: output {i} differs from the plain version "
                f"{where} (max abs err {err})")


# ---------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------
def check_fd_round(name, state0, statics, step_kernel, step_plain,
                   round_bytes):
    """Iterate kernel and plain version to the fixed point from the same
    state, comparing all outputs every round; then time both over the
    whole cascade.  Returns the kernel's row of the kernels line."""
    import torch

    sk = tuple(t.clone() for t in state0)
    sp = tuple(t.clone() for t in state0)
    rounds, nbytes = 0, 0
    while bool(sk[1].any()):
        nbytes += round_bytes(sk)
        want = step_plain(*sp, *statics)
        step_kernel(*sk, *statics)
        require_equal(name, sk, want, f"at round {rounds}")
        sp = want
        rounds += 1
        if rounds > 100_000:
            raise AssertionError(f"{name}: cascade did not drain")
    require_equal(name, sk, sp, "after the last round")

    def cascade(step, functional):
        s = tuple(t.clone() for t in state0)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(rounds):
            out = step(*s, *statics)
            if functional:
                s = out
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / rounds

    ms = cascade(step_kernel, False)
    plain_ms = cascade(step_plain, True)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=nbytes / rounds
               / HBM_BYTES_PER_S * 1e3, bytes_per_call=nbytes / rounds,
               calls_checked=rounds, max_abs_err=0.0)
    log(f"[smoke]   {name}: {rounds} rounds equal to the plain version; "
        f"kernel {ms:.4f} ms/round, plain {plain_ms:.4f} ms/round, "
        f"{row['bytes_per_call'] / 1e6:.1f} MB/round -> bound "
        f"{row['bound_ms']:.4f} ms")
    return row


def check_rows_kernel(name, kernel, plain, inputs, nbytes, reps=20,
                      library=None):
    """One call of a row-parallel kernel against its plain version, then
    both timed over ``reps`` calls, and ``library`` (one PyTorch call
    computing the same function) where there is one."""
    got = kernel(*inputs)
    want = plain(*inputs)
    require_equal(name, got, want, "on the main path's slot matrix")
    ms = cuda_ms(lambda: kernel(*inputs), reps)
    plain_ms = cuda_ms(lambda: plain(*inputs), reps)
    library_ms = (None if library is None
                  else cuda_ms(lambda: library(*inputs), reps))
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bytes_per_call=nbytes, calls_checked=1, max_abs_err=0.0)
    log(f"[smoke]   {name}: equal to the plain version on "
        f"{tuple(inputs[0].shape)}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms, {nbytes / 1e6:.1f} MB "
        f"-> bound {row['bound_ms']:.4f} ms")
    return row


def prepare(fullsize, name, dev, cache: dict) -> dict:
    """Graph, wedge list and one CD run of a full-size graph, built once
    and shared by the phases that need them (kernel inputs, FD drivers)."""
    if name not in cache:
        from repro_torch.core import csr, peel, peelspec
        from repro_torch.core.graph import powerlaw_bipartite

        want = fullsize[name]
        g = powerlaw_bipartite(**want["graph"])
        if cli_sha(g) != want["edges_sha256"]:
            raise AssertionError(f"{name}: the generator gave other edges "
                                 "than the JAX package's")
        wed = csr.build_wedges(g)
        stats = peelspec.PeelStats()
        spec = peel.build_peel_spec(g, want["kind"], stats, engine="csr",
                                    wed=wed, device=dev)
        part, sup_init, _, n_parts = peelspec.cd_loop(spec, want["P"], stats)
        cache[name] = dict(g=g, wed=wed, sup0=spec.sup0, part=part,
                           sup_init=sup_init, n_parts=n_parts,
                           cd_updates=stats.updates)
    return cache[name]


def phase_kernels(fullsize, realdata, dev, cache, tmp):
    import numpy as np
    import torch

    from repro_torch.core import csr, peel
    from repro_torch.core.fdpack import (pack_fd_partitions_csr,
                                         pack_fd_partitions_tip_csr)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.support_update import support_update
    from repro_torch.kernels.wedge_count import wedge_count

    rows = {}
    i32, f32 = torch.int32, torch.float32

    # fd_round_wing on the wing-60k vmapped stack
    pw = prepare(fullsize, "wing-60k", dev, cache)
    g, wed = pw["g"], pw["wed"]
    part, sup_init, n_parts = pw["part"], pw["sup_init"], pw["n_parts"]
    p = pack_fd_partitions_csr(wed, part, sup_init, n_parts, bucket=True,
                               slots=True)
    st = ops.state_from_numpy(
        {k: p[k] for k in ("slot_e1", "slot_e2", "slot_valid", "mine",
                           "sup0")}, dev)
    B, R, K = st["slot_e1"].shape
    E = st["sup0"].shape[1]
    log(f"[smoke]   wing-60k stack: B={B} E={E} R={R} K={K} "
        f"({R * K / 1e6:.1f} M slots per partition)")
    state0 = (*peel._fused_state(st["mine"], st["sup0"], 3),
              st["slot_valid"].to(i32),
              torch.from_numpy(peel._w_rows(p, n_parts)).to(dev, f32))
    del p

    def wing_bytes(s):
        return 4 * (5 * B * E + B * R * K + 2 * int(s[6].sum()) + 2 * B * R)

    rows["fd_round_wing"] = check_fd_round(
        "fd_round_wing", state0, (st["slot_e1"], st["slot_e2"]),
        ops.fd_round_wing, ref.fd_round_wing_ref, wing_bytes)
    del state0, st
    torch.cuda.empty_cache()

    # support_update on the wing-60k CD slot matrix, a seeded peel mask
    rng = np.random.default_rng(0)
    slots = csr.pack_update_slots(wed)
    peeled = torch.from_numpy(rng.random(g.m) < 0.05).to(dev)
    pe = torch.cat([peeled, peeled.new_zeros((1,))])
    e1 = torch.from_numpy(slots["e1"]).to(dev)
    e2 = torch.from_numpy(slots["e2"]).to(dev)
    W_rows = torch.zeros(e1.shape[0], dtype=f32, device=dev)
    W_rows[:wed.n_pairs] = torch.from_numpy(wed.W0).to(dev, f32)
    su_in = (ops._pad2(pe[e1], 128, 128), ops._pad2(pe[e2], 128, 128),
             ops._pad2(torch.from_numpy(slots["valid"]).to(dev), 128, 128),
             ops._pad_to(W_rows, 128, 0).contiguous())
    n, K = su_in[0].shape
    del slots, e1, e2
    rows["support_update"] = check_rows_kernel(
        "support_update", support_update, ref.support_update_ref, su_in,
        4 * (5 * n * K + 2 * n))
    del su_in

    # wedge_count on the vertex-major tip slots of the same graph
    bf0 = wed.pair_butterflies0()
    tslots = csr.pack_tip_slots(wed, bf0)
    peeled_u = torch.from_numpy(rng.random(g.n_u) < 0.05).to(dev)
    pu = torch.cat([peeled_u, peeled_u.new_zeros((1,))])
    vals = torch.where(pu[torch.from_numpy(tslots["partner"]).to(dev)],
                       torch.from_numpy(tslots["bf"]).to(dev), 0)
    wc_in = (ops._pad2(vals, 128, 128),)
    n, K = wc_in[0].shape
    rows["wedge_count"] = check_rows_kernel(
        "wedge_count", wedge_count, ref.pair_wedge_counts_ref, wc_in,
        4 * n * K + 8 * n)
    del wc_in, vals
    torch.cuda.empty_cache()

    # fd_round_tip on the tip-1m vmapped stack
    pt = prepare(fullsize, "tip-1m", dev, cache)
    wed = pt["wed"]
    part, sup_init, n_parts = pt["part"], pt["sup_init"], pt["n_parts"]
    p = pack_fd_partitions_tip_csr(wed, wed.pair_butterflies0(), part,
                                   sup_init, n_parts, bucket=True,
                                   stacked=True)
    st = ops.state_from_numpy(
        {k: p[k] for k in ("st_pa", "st_pb", "st_bf", "mine", "sup0")}, dev)
    B, L = st["st_pa"].shape
    E = st["sup0"].shape[1]
    log(f"[smoke]   tip-1m stack: B={B} E={E} L={L}")
    state0 = peel._fused_state(st["mine"], st["sup0"], 2)
    rows["fd_round_tip"] = check_fd_round(
        "fd_round_tip", state0, (st["st_pa"], st["st_pb"], st["st_bf"]),
        ops.fd_round_tip, ref.fd_round_tip_ref,
        lambda s: 4 * (5 * B * E + 3 * B * L))
    del state0, st
    torch.cuda.empty_cache()

    rows["wedge_count_tile"] = check_tile_kernel(realdata, dev, tmp)
    return rows


def check_tile_kernel(realdata, dev, tmp):
    """``wedge_count_tile`` on the slot matrix of tip-1m's largest wedge
    tile (from the ingested TSV), built on the card as the tiled init
    builds it; timed beside its plain version and ``torch.sum``."""
    import torch

    from repro_torch.core import csr
    from repro_torch.data import ingest_edges
    from repro_torch.kernels import ref
    from repro_torch.kernels.wedge_count import wedge_count_tile

    want = realdata["tip-1m"]
    ig = ingest_edges(write_tsv(realdata, "tip-1m", tmp),
                      out_dir=os.path.join(tmp, "tile-check.ingest"))
    a = b = None
    for ta, tb, _, _ in csr.iter_wedge_tiles(ig, want["tile_wedges"]):
        if a is None or ta.size > a.size:
            a, b = ta, tb
    if a.size != want["tiled_init"]["peak_tile_wedges"]:
        raise AssertionError(f"tip-1m peak tile has {a.size} wedges, JAX "
                             f"{want['tiled_init']['peak_tile_wedges']}")
    lay = csr.tile_layout(a, b, ig.n_u, 512, dev)
    slots = csr.tile_slot_matrix(lay)
    n, width = lay.n_rows, slots.shape[1]
    log(f"[smoke]   tip-1m peak tile: {a.size} wedges, {n} slot rows x "
        f"{width} ({slots.shape[0]} rows after the bucket)")
    row = check_rows_kernel(
        "wedge_count_tile", lambda s: (wedge_count_tile(s, n),),
        lambda s: (ref.tile_row_counts_ref(s[:n]),), (slots,),
        4 * n * width + 4 * n,
        library=lambda s: s[:n].sum(1, dtype=torch.int32))
    del slots, lay
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------
# phase 3: the csr golden cells
# ---------------------------------------------------------------------
GOLDEN_GRAPHS = {
    "rb30": ("random_bipartite", (30, 24, 140), dict(seed=0)),
    "rb25": ("random_bipartite", (25, 20, 100), dict(seed=1)),
    "pl80": ("powerlaw_bipartite", (80, 40, 350), dict(seed=2)),
    "pl60": ("powerlaw_bipartite", (60, 50, 300), dict(seed=3)),
}


def snapshot(res) -> dict:
    import numpy as np

    s = res.stats
    out = dict(theta=np.asarray(res.theta).tolist(),
               part=np.asarray(res.part).tolist(),
               ranges=np.asarray(res.ranges).tolist(),
               support_init=np.asarray(res.support_init).tolist())
    out.update({f: int(getattr(s, f)) for f in STAT_FIELDS})
    return out


def phase_goldens(dev):
    import repro_torch.core.graph as G
    from repro_torch.core.peel import tip_decomposition, wing_decomposition

    with open(os.path.join(ROOT, "tests", "goldens",
                           "peel_goldens.json")) as f:
        goldens = json.load(f)
    graphs = {k: getattr(G, fn)(*a, **kw)
              for k, (fn, a, kw) in GOLDEN_GRAPHS.items()}

    def run(key, use_pallas=False, fused=None):
        parts = key.split(".")
        g, engine, fd = graphs[parts[1]], parts[-2], parts[-1]
        P = int(parts[2][1:])
        if fused is None:
            fused = engine == "csr" and fd != "host"
        kw = dict(P=P, engine=engine, fd_driver=fd, fused=fused,
                  use_pallas=use_pallas, device=dev)
        if parts[0] == "wing":
            res = wing_decomposition(g, **kw)
        else:
            res = tip_decomposition(g, side=parts[3], **kw)
        got = snapshot(res)
        bad = [f for f in GOLDEN_FIELDS if got[f] != goldens[key][f]]
        if bad:
            raise AssertionError(f"golden cell {key} (use_pallas="
                                 f"{use_pallas}, fused={fused}): {bad}")

    cells = sorted(k for k in goldens if "csr" in k.split("."))
    others = sorted(k for k in goldens if "csr" not in k.split("."))
    n_be = sum("beindex" in k.split(".") for k in others)
    if (len(cells), n_be, len(others) - n_be) != (72, 8, 24):
        raise AssertionError(f"expected 72 csr, 8 beindex and 24 dense "
                             f"golden cells, found {len(cells)}, {n_be} "
                             f"and {len(others) - n_be}")
    for key in cells + others:
        run(key)
    # kernel-route reruns: CD through support_update / wedge_count, and the
    # unfused vmapped wing FD with support_update inside the loop
    extra = [k for k in cells if k.split(".")[1] == "pl80"]
    for key in extra:
        run(key, use_pallas=True, fused=False)
    log(f"[smoke]   {len(cells)} csr golden cells equal field for field "
        f"(fused on for device/vmapped), and {len(others)} beindex and "
        f"dense cells; {len(extra)} pl80 cells again with use_pallas")


# ---------------------------------------------------------------------
# phases 4-5: the main path at full size
# ---------------------------------------------------------------------
def cli_peel(g, argv, dev):
    """One CLI run on ``g``.  Launch counts are zeroed just before and
    read just after.  Returns (digests, launch counts, seconds, output)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import peel as cli

    args = cli.build_parser().parse_args([*argv, "--device", dev])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run(args, g=g)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = out["result"]
    got = dict(theta_sha256=out["theta_sha256"],
               part_sha256=cli.sha256_int64(res.part),
               support_init_sha256=cli.sha256_int64(res.support_init),
               ranges=[int(x) for x in res.ranges],
               stats={f: int(out[f]) for f in STAT_FIELDS})
    return got, counts, dt, out


def hold(label, got, want, stats=STAT_FIELDS) -> None:
    """θ, partition, ⋈init and ranges equal to the recorded JAX run, and
    the ``stats`` fields of its PeelStats."""
    for key in ("theta_sha256", "part_sha256", "support_init_sha256",
                "ranges"):
        expect(label, key, got[key], want[key])
    expect(label, "stats", {f: got["stats"][f] for f in stats},
           {f: want["stats"][f] for f in stats})


def main_path(fullsize, name, g, flags, launches, dev):
    """One CLI run on ``g``; held to the recorded JAX values.  Returns
    (launch counts, seconds, the CLI's stats row)."""
    want = fullsize[name]
    got, counts, dt, out = cli_peel(
        g, ["--kind", want["kind"], "--parts", str(want["P"]), *flags], dev)
    hold(f"{name} {flags}", got, want)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[smoke]   {name} {' '.join(flags) or '(defaults)'}: matches the "
        f"JAX package in {dt:.1f} s; launches {counts}")
    return counts, dt, out


# span categories whose seconds split a traced peel run (nested: peel ⊃
# cd ⊃ cd.round, peel ⊃ fd ⊃ fd.launch); the hierarchy spans are split
# by name (hierarchy.build ⊃ hierarchy.labels, hierarchy.node_stats)
SPAN_CATS = ("peel", "cd", "cd.round", "fd", "fd.launch")


def traced_main_path(fullsize, name, g, untraced, launches, dev, tmp):
    """The CLI's default run of ``name`` again with ``--trace``: θ and
    stats equal to the golden (so to the untraced run), the same kernel
    launches, ``cd.round`` spans == ρ_cd and ``fd.round`` events ==
    ρ_fd_total.  ``untraced`` is ``main_path``'s return for the same
    flags.  Returns the seconds of each span category and the peel's
    seconds traced and untraced.  (The hierarchy of the same graph is
    built, and its seconds split, in phase 7's tip-1m ``--edges`` run.)"""
    want = fullsize[name]
    path = os.path.join(tmp, f"{name}.trace.json")
    got, counts, dt, out = cli_peel(
        g, ["--kind", want["kind"], "--parts", str(want["P"]), "--trace",
            path], dev)
    hold(f"{name} --trace", got, want)
    expect(f"{name} --trace", "launches", counts, untraced[0])
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    s = out["result"].stats
    tracer = out["trace"]
    tl = out["result"].timeline
    spans = (tracer.count("cd.round", ph="X"), tracer.count("fd.round",
                                                            ph="i"))
    expect(f"{name} --trace", "(cd.round spans, fd.round events)", spans,
           (s.rho_cd, s.rho_fd_total))
    expect(f"{name} --trace", "timeline (cd, fd) rounds",
           (tl.cd_rounds, tl.fd_rounds_total()), spans)
    secs = {cat: round(sum(e["dur"] for e in tracer.spans(cat, ph="X"))
                       / 1e6, 4) for cat in SPAN_CATS}
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    info = dict(span_seconds=secs, events=n_events,
                timeline=tl.summary(), seconds_traced=dt,
                peel_traced=out["seconds"]["peel"],
                peel_untraced=untraced[2]["seconds"]["peel"],
                untraced=untraced[1])
    log(f"[smoke]   {name} --trace: matches the JAX "
        f"package and the untraced run (launches {counts}); "
        f"{n_events} trace events, cd.round {spans[0]} = rho_cd, fd.round "
        f"{spans[1]} = rho_fd_total; seconds by span category {secs}; "
        f"peel {info['peel_traced']:.3f} s traced against "
        f"{info['peel_untraced']:.3f} s untraced (whole run {dt:.1f} s, "
        f"{untraced[1]:.1f} s untraced)")
    return info


# ---------------------------------------------------------------------
# phase 8: the dense and beindex engines and the butterfly kernels
# ---------------------------------------------------------------------
# PeelStats fields that do not depend on the engine (the csr recording
# holds them for the dense and beindex runs; updates/recounts do depend)
ENGINE_FREE_STATS = ("rho_cd", "rho_fd_total", "rho_fd_max", "p_effective")


def check_compute_kernel(name, kernel, plain, inputs, ops_count, nbytes,
                         peak, reps, library=None, fp32_bound=False):
    """One call of a compute-bound kernel against its plain version, then
    kernel, plain version and ``library`` timed over ``reps`` calls.  The
    bound is the larger of ``ops_count`` at ``peak`` and ``nbytes`` at
    the memory rate; with ``fp32_bound`` the row also carries the bound at
    the FP32 CUDA-core peak this kernel's design runs at."""
    got = kernel(*inputs)
    want = plain(*inputs)
    require_equal(name, got, want, "at the main path's shapes")
    del got, want
    ms = cuda_ms(lambda: kernel(*inputs), reps)
    plain_ms = cuda_ms(lambda: plain(*inputs), reps)
    library_ms = (None if library is None
                  else cuda_ms(lambda: library(*inputs), reps))
    bound_ms = max(ops_count / peak, nbytes / HBM_BYTES_PER_S) * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by="operations",
               ops_per_call=ops_count, bytes_per_call=nbytes,
               calls_checked=1, max_abs_err=0.0)
    if fp32_bound:
        row["bound_fp32_ms"] = ops_count / FP32_FLOP_PER_S * 1e3
    log(f"[smoke]   {name}: equal to the plain version on "
        f"{[tuple(t.shape) for t in inputs]}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {library_ms} ms; "
        f"{ops_count / 1e12:.3f} T ops -> bound {bound_ms:.3f} ms"
        + (f" (FP32 {row['bound_fp32_ms']:.1f} ms)" if fp32_bound else ""))
    return row


# (m, n, k) of the random-f32 accuracy check of matmul
MATMUL_ERR_SHAPES = ((1000, 777, 1333), (512, 512, 16384))


def matmul_random_error(dev) -> dict:
    """‖C − C₆₄‖ / ‖C₆₄‖ of ``matmul`` on seeded N(0, 1) f32 inputs, each
    layout, against an f64 product, beside the plain (full-f32)
    version's, and the kernel's worst max |C − C₆₄| / Σ_k |a||b| in units
    of 2⁻²³ (what ``tests/test_torch_cuda.py::tf32x3_bound`` allows is
    6 + 108 + ⌈K/32⌉/2 of those).  The graph products are exact; this is
    the error on general f32 data (3xTF32 drops lo·lo and rounds on the
    tensor cores)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.butterfly_count import matmul

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for m, n, k in MATMUL_ERR_SHAPES:
        for trans_b in (False, True):
            a = torch.randn((m, k), generator=gen, device=dev)
            b = torch.randn((n, k) if trans_b else (k, n), generator=gen,
                            device=dev)
            b_kn = b.double().T if trans_b else b.double()
            exact = a.double() @ b_kn
            delta = matmul(a, b, trans_b).double() - exact
            errs = [(d.norm() / exact.norm()).item() for d in (
                delta, ref.matmul_ref(a, b, trans_b).double() - exact)]
            worst = (delta.abs() / (a.double().abs() @ b_kn.abs())).max()
            out[f"{m}x{n}x{k}{' trans_b' if trans_b else ''}"] = dict(
                kernel=errs[0], plain=errs[1],
                kernel_max_vs_sum_abs_ulp23=worst.item() * 2.0 ** 23)
            del delta, exact
    log(f"[smoke]   matmul on random f32, relative error (kernel, plain "
        f"full f32): {out}")
    return out


def engines_cli(label, g, argv, engine, wants, dev, launches, seconds):
    """A CLI run of the dense or beindex engine; θ, partition, ⋈init,
    ranges and the engine-independent stats held to ``wants[0]``, every
    stat to ``wants[1]`` (the JAX run of the same engine) where given.
    The kernel launches counted on the card: the dense tip counts its
    ⋈init and each §5.1 batch re-count with one ``vertex_count`` and
    peels its FD phase with one ``fd_tip_dense``, the beindex engine
    peels its FD phase with one ``fd_wing_beindex``, and nothing else
    launches a kernel.
    Returns the run's PeelResult."""
    import torch

    from repro_torch.kernels import ops

    got, counts, dt, out = cli_peel(g, argv, dev)
    expect(label, "engine", out["engine"], engine)
    hold(label, got, wants[0], stats=ENGINE_FREE_STATS)
    if wants[1] is not None:
        hold(label, got, wants[1])
    want = dict.fromkeys(ops.KERNELS, 0)
    if torch.device(dev).type == "cuda":
        if engine == "dense" and "tip" in argv:
            want["vertex_count"] = 1 + got["stats"]["recounts"]
            want["fd_tip_dense"] = 1
        if engine == "beindex":
            want["fd_wing_beindex"] = 1
    expect(label, "kernel launches", counts, want)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    seconds[label] = {k: round(v, 3) for k, v in out["seconds"].items()}
    log(f"[smoke]   {label}: θ, partition, ⋈init, ranges and stats match "
        f"the JAX package in {dt:.1f} s ({seconds[label]}); stats "
        f"{got['stats']}")
    return out["result"]


def phase_engines(engines, fullsize, dev, launches):
    """Phase 8; returns (kernel rows, seconds)."""
    import numpy as np
    import torch

    from repro_torch.core import counting
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.butterfly_count import (matmul, pack_s8,
                                                     vertex_count,
                                                     vertex_count_tile)
    from repro_torch.launch.peel import sha256_int64

    rows, seconds = {}, {}
    i64 = torch.int64

    # ---- dense-16k: the dense tip engine through the CLI
    want = engines["dense-16k"]
    g = powerlaw_bipartite(**want["graph"])
    expect("dense-16k", "edges sha256", sha256_int64(g.edges),
           want["edges_sha256"])
    res = engines_cli("dense-16k --kind tip --engine dense", g,
                      ["--kind", "tip", "--side", want["side"], "--engine",
                       "dense", "--parts", str(want["P"])], "dense",
                      (want["csr"], want.get("dense")), dev, launches,
                      seconds)

    # the kernels' main path: the public ops entry points on its adjacency
    A = torch.from_numpy(g.adjacency()).to(dev)
    edges = torch.from_numpy(g.edges).to(dev, i64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vb = ops.vertex_butterflies(A)
    vt = ops.vertex_butterflies_tiled(A, tile_rows=1024)
    M = ops.edge_wedge_matrix(A)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    n, k = A.shape
    on_card = torch.device(dev).type == "cuda"
    expect("dense-16k ops", "launches",
           {key: counts[key] for key in ("vertex_count", "vertex_count_tile",
                                         "matmul")},
           dict(vertex_count=int(on_card),
                vertex_count_tile=-(-n // 1024) * on_card,
                matmul=2 * on_card))
    for key, v in counts.items():
        launches[key] = launches.get(key, 0) + v
    seconds["dense-16k ops (vertex_butterflies, _tiled, edge_wedge_matrix)"] \
        = round(dt, 3)
    require_equal("vertex_count_tile", (vt,), (vb,),
                  "as ops.vertex_butterflies_tiled vs ops.vertex_butterflies")
    expect("dense-16k", "vertex butterflies sha256",
           sha256_int64(vt.cpu().numpy()), want["vertex_butterflies_sha256"])
    du = A.sum(dim=1)
    u, v = edges[:, 0], edges[:, 1]
    per_edge = M[u, v] - (du[u] - 1.0)
    del M
    require_equal("matmul", (per_edge,), (counting.edge_butterflies(A, edges),),
                  "as ops.edge_wedge_matrix vs core.counting")
    expect("dense-16k", "edge butterflies sha256",
           sha256_int64(np.rint(per_edge.cpu().numpy())),
           want["edge_butterflies_sha256"])
    log(f"[smoke]   dense-16k ops: vertex_butterflies equals _tiled (16 "
        f"strips) and edge_wedge_matrix core.counting; both counts equal the "
        f"JAX ones; {dt:.2f} s, launches {counts}")
    del vb, vt, per_edge
    torch.cuda.empty_cache()

    # each kernel against its plain version at these shapes, timed.  The
    # plain vertex count is core.counting's dense route (no single
    # library call); W = A·Aᵀ is symmetric, so its function needs only
    # the n(n−1)/2 off-diagonal pairs: n(n−1)k operations, not 2n²k.
    # The bound prices the f32 interface (pack included, int64 counts
    # out); beside it the kernels on pre-packed int8 operands, the pack
    # alone, and torch._int_mm of the packed operands (the whole int8
    # product, a yardstick only: it does not compute these functions).
    rows["fd_tip_dense"] = check_fd_tip_dense(A, res, dev)
    rows["vertex_count"] = check_compute_kernel(
        "vertex_count", lambda a: (vertex_count(a),),
        lambda a: (ref.vertex_butterflies_ref(a),), (A,),
        float(n * (n - 1) * k), 4 * n * k + 8 * n, INT8_OP_PER_S, 3,
        fp32_bound=True)
    rows["vertex_count"]["library"] = \
        "none (no single call; the plain version is core.counting's route)"
    strip = A[:1024]
    rows["vertex_count_tile"] = check_compute_kernel(
        "vertex_count_tile", lambda s, a: (vertex_count_tile(s, a),),
        lambda s, a: (ref.vertex_count_tile_ref(s, a),), (strip, A),
        2.0 * 1024 * n * k, 4 * (1024 + n) * k + 8 * 1024, INT8_OP_PER_S, 5,
        fp32_bound=True)
    A8 = pack_s8(A)
    require_equal("pack_s8", (A8,), (ref.pack_s8_ref(A)[0],),
                  "as pack_s8")
    pack_ms = cuda_ms(lambda: (pack_s8(A),), 10)
    for name, kernel, plain, args, reps, int_mm in (
            ("vertex_count", vertex_count, ref.vertex_butterflies_ref,
             (A8,), 5, lambda: (torch._int_mm(A8, A8.T),)),
            ("vertex_count_tile", vertex_count_tile,
             ref.vertex_count_tile_ref, (A8[:1024], A8), 10,
             lambda: (torch._int_mm(A8[:1024], A8.T),))):
        want = plain(*(x.float() for x in args))
        require_equal(name, (kernel(*args),), (want,),
                      "on pre-packed int8 operands")
        del want
        row = rows[name]
        row.update(ms_packed=cuda_ms(lambda: (kernel(*args),), reps),
                   pack_ms=pack_ms)
        try:
            row["int_mm_ms"] = cuda_ms(int_mm, 3)
        except RuntimeError as exc:  # not on every PyTorch build
            row["int_mm_ms"] = f"not measured: {exc}"[:200]
    rows["vertex_count_tile"]["tiled_e2e_ms"] = cuda_ms(
        lambda: (ops.vertex_butterflies_tiled(A, tile_rows=1024),), 3)
    for name in ("vertex_count", "vertex_count_tile"):
        row = rows[name]
        log(f"[smoke]   {name}: f32 interface {row['ms']:.3f} ms, on "
            f"pre-packed int8 {row['ms_packed']:.3f} ms, pack_s8 alone "
            f"{row['pack_ms']:.3f} ms, torch._int_mm of the packed "
            f"operands {row['int_mm_ms']} ms"
            + (f", ops.vertex_butterflies_tiled (16 strips) "
               f"{row['tiled_e2e_ms']:.3f} ms" if "tiled_e2e_ms" in row
               else ""))
    del A8, args, int_mm
    # matmul's two products, each bound by its 2n²k operations at the
    # peak of the operands' tensor-core type: int8 for A·Aᵀ (both 0/1, as
    # vertex_count's row counts), TF32 for W·A (W's counts overflow
    # int8).  Beside them: the kernel's own work, three TF32 products
    # (it skips a lo plane of zeros, so it runs one for A·Aᵀ and two for
    # W·A), and the exact-f32 product at the FP32 CUDA-core peak.
    flops = 2.0 * n * n * k
    row = check_compute_kernel(
        "matmul", lambda a, b: (matmul(a, b, trans_b=True),),
        lambda a, b: (ref.matmul_ref(a, b, True),), (A, A),
        flops, 4 * (2 * n * k + n * n), INT8_OP_PER_S, 3,
        library=lambda a, b: (torch.matmul(a, b.T),))
    W = matmul(A, A, trans_b=True)
    row2 = check_compute_kernel(
        "matmul", lambda w, a: (matmul(w, a),),
        lambda w, a: (ref.matmul_ref(w, a),), (W, A), flops,
        4 * (n * n + 2 * n * k), TF32_FLOP_PER_S, 3,
        library=lambda w, a: (torch.matmul(w, a),))
    row.update(ms=(row["ms"] + row2["ms"]) / 2,
               plain_ms=(row["plain_ms"] + row2["plain_ms"]) / 2,
               library_ms=(row["library_ms"] + row2["library_ms"]) / 2,
               bound_ms=(row["bound_ms"] + row2["bound_ms"]) / 2,
               ms_by_product=dict(a_at=row["ms"], w_a=row2["ms"]),
               bound_by_product=dict(a_at=row["bound_ms"],
                                     w_a=row2["bound_ms"]),
               bound_3xtf32_ms=3 * flops / TF32_FLOP_PER_S * 1e3,
               bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3,
               ops_per_call=flops, calls_checked=2,
               library="torch.matmul, TF32 off")
    row["random_f32_rel_err"] = matmul_random_error(dev)
    log(f"[smoke]   matmul: {row['ms']:.3f} ms a product (A·Aᵀ "
        f"{row['ms_by_product']['a_at']:.3f}, W·A "
        f"{row['ms_by_product']['w_a']:.3f}); bound {row['bound_ms']:.2f} ms "
        f"(int8 {row['bound_by_product']['a_at']:.2f}, TF32 "
        f"{row['bound_by_product']['w_a']:.2f}), 3xTF32 "
        f"{row['bound_3xtf32_ms']:.1f} ms, exact f32 at the FP32 peak "
        f"{row['bound_fp32_ms']:.1f} ms; torch.matmul "
        f"{row['library_ms']:.3f} ms")
    rows["matmul"] = row
    del A, W, strip, edges
    torch.cuda.empty_cache()

    # ---- wing-60k: the beindex (default) and dense wing engines
    wf, we = fullsize["wing-60k"], engines["wing-60k"]
    g = powerlaw_bipartite(**wf["graph"])
    res = {}
    for argv, engine in ((["--kind", "wing"], "beindex"),
                         (["--kind", "wing", "--engine", "dense"], "dense")):
        res[engine] = engines_cli(f"wing-60k {' '.join(argv)}", g,
                                  [*argv, "--parts", str(wf["P"])], engine,
                                  (wf, we.get(engine)), dev, launches,
                                  seconds)
    rows["bloom_update"] = check_bloom_rounds(we, g, dev, launches, seconds)
    rows["fd_wing_beindex"] = check_fd_wing_beindex(g, res["beindex"], dev)
    return rows, seconds


def check_fd_wing_beindex(g, res, dev):
    """``ops.fd_wing_beindex`` on the FD phase of the beindex wing run
    ``res`` (its partition and FD initial supports, the pack of ``g``'s
    BE-Index on ``dev``) against its plain version, entry for entry, then
    both timed.  θ equals the run's, and the rounds its ρ_fd.  The bound
    is the bytes it has to move: 16 a link (the pair members and
    segments, the edge-major entries, the pair flags) and 8 an update (a
    support's atomic and its read)."""
    import numpy as np
    import torch

    from repro_torch.core import peel
    from repro_torch.core.beindex import build_beindex
    from repro_torch.kernels import ops, ref

    be = build_beindex(g, dev)
    le, lt, lb = peel._wing_links(be, dev)
    inputs = peel._wing_fd_pack(le, lt, lb, be.nb, np.asarray(res.part),
                                np.asarray(res.support_init))
    theta, rounds, updates, _ = ops.fd_wing_beindex(*inputs)
    require_equal("fd_wing_beindex", (theta.cpu().to(torch.int64),),
                  (torch.from_numpy(np.asarray(res.theta, np.int64)),),
                  "θ as the beindex wing run's")
    expect("fd_wing_beindex", "(rho_fd_total, rho_fd_max)",
           (int(rounds.sum()), int(rounds.max())),
           (res.stats.rho_fd_total, res.stats.rho_fd_max))
    nbytes = 16 * be.n_links + 8 * int(updates.sum())
    row = check_rows_kernel("fd_wing_beindex", ops.fd_wing_beindex,
                            ref.fd_wing_beindex_ref, inputs, nbytes, reps=3)
    row.update(bound_by="bytes", partitions=int(rounds.numel()),
               links=be.n_links, rounds=int(rounds.sum()),
               updates=int(updates.sum()))
    del inputs, le, lt, lb
    return row


def check_fd_tip_dense(A, res, dev):
    """``ops.fd_tip_dense`` on the FD phase of the dense tip run ``res``
    (its partition and FD initial supports, the pair matrix of ``A``)
    against its plain version, entry for entry, then both timed.  θ
    equals the run's.  The bound is the bytes it has to move: each pair
    entry inside a partition read once (8 bytes), the supports and ids
    read, θ and the round records written."""
    import numpy as np
    import torch

    from repro_torch.core import peel
    from repro_torch.kernels import ops, ref

    part = np.asarray(res.part, dtype=np.int64)
    P = int(part.max()) + 1
    order = np.argsort(part, kind="stable")
    sizes = np.bincount(part, minlength=P)
    off = np.concatenate([[0], np.cumsum(sizes)])
    pair = peel._pair_butterflies(A)
    inputs = (pair,
              torch.from_numpy(order.astype(np.int32)).to(dev),
              torch.from_numpy(off).to(dev),
              torch.from_numpy(np.asarray(res.support_init, np.int64)[order])
              .to(dev))
    theta = np.empty(part.size, dtype=np.int64)
    theta[order] = ops.fd_tip_dense(*inputs)[0].cpu().numpy()
    require_equal("fd_tip_dense", (torch.from_numpy(theta),),
                  (torch.from_numpy(np.asarray(res.theta, np.int64)),),
                  "θ as the dense tip run's")
    # pair entries; ids, supports, θ and records a vertex; off, rounds
    nbytes = (8 * int((sizes ** 2).sum()) + (4 + 8 + 8 + 24) * part.size
              + 8 * (P + 1) + 4 * P)
    row = check_rows_kernel("fd_tip_dense", ops.fd_tip_dense,
                            ref.fd_tip_dense_ref, inputs, nbytes, reps=3)
    row.update(bound_by="bytes", partitions=P)
    del pair, inputs
    return row


def check_bloom_rounds(we, g, dev, launches, seconds):
    """The BE-Index of wing-60k (held to the JAX index), then
    ``ops.bloom_update`` round by round over seeded peel sets at the
    fractions 0, 1/6, 1/2 and 1 of the edges, carrying the alive pairs
    and bloom numbers; every round ``sup − loss`` and the bloom numbers
    equal the engine's own update (``core.peel._wing_update``), and the
    kernel equals its plain version on each round's inputs."""
    import numpy as np
    import torch

    from repro_torch.core import peel
    from repro_torch.core.beindex import build_beindex
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bloom_update import bloom_update

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    be = build_beindex(g, dev)
    sync(dev)
    seconds["wing-60k build_beindex"] = round(time.perf_counter() - t0, 3)
    got = dict(nb=be.nb, n_links=be.n_links, max_pairs=int(be.bloom_k.max()))
    got.update({f"{k}_sha256": sha_bytes(getattr(be, k))
                for k in ("bloom_k", "link_edge", "link_twin", "link_bloom")})
    expect("wing-60k", "BE-Index", got, we["index"])
    m, nb = g.m, be.nb
    p = ops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom, nb)
    le, lt, valid, canon = (torch.from_numpy(p[key]).to(dev)
                            for key in ("le", "lt", "valid", "canon"))
    nb_pad, K = le.shape
    k_alive = torch.zeros(nb_pad, dtype=torch.float32, device=dev)
    k_alive[:nb] = torch.from_numpy(be.bloom_k).to(dev, torch.float32)
    alive_pair = valid
    links = [torch.from_numpy(x).to(dev) for x in
             (be.link_edge, be.link_twin, be.link_bloom)]
    eng = (torch.ones(be.n_links, dtype=torch.bool, device=dev),
           torch.from_numpy(be.bloom_k).to(dev),
           torch.from_numpy(be.edge_support(m).astype(np.int32)).to(dev))
    sup = eng[2].clone()
    perm = np.random.default_rng(0).permutation(m)
    cuts = [0, 0, m // 6, m // 2, m]   # fractions 0, 1/6, 1/2, 1
    saved = []
    for r in range(4):
        peeled = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        peeled[torch.from_numpy(perm[cuts[r]:cuts[r + 1]]).to(dev)] = True
        saved.append((peeled, alive_pair, k_alive))
        loss, c, alive_pair = ops.bloom_update(peeled, alive_pair, k_alive,
                                               le, lt, canon)
        k_alive = k_alive - c
        sup = sup - loss.to(torch.int32)
        alive_l, k_l, sup_l, _ = peel._wing_update(
            peeled[:m], *eng, *links, max(nb, 1), m)
        eng = (alive_l, k_l, sup_l)
        require_equal("bloom_update", (sup, k_alive[:nb].to(torch.int32)),
                      (sup_l, k_l), f"(sup − loss, k) vs the engine update "
                      f"at round {r}")
    sync(dev)
    counts = ops.launch_counts()
    on_card = torch.device(dev).type == "cuda"
    expect("wing-60k build and bloom rounds", "launches", counts,
           dict(dict.fromkeys(ops.KERNELS, 0), bloom_update=4 * on_card))
    for key, v in counts.items():
        launches[key] = launches.get(key, 0) + v
    sent = m
    lei = torch.where(le < 0, sent, le)
    lti = torch.where(lt < 0, sent, lt)

    def flags(peeled, alive, kk):
        return (ops._u8(peeled[lei]), ops._u8(peeled[lti]), ops._u8(alive),
                ops._u8(canon), kk)

    for r, state in enumerate(saved):
        inputs = flags(*state)
        require_equal("bloom_update", bloom_update(*inputs),
                      ref.bloom_update_ref(*inputs), f"at round {r}")
    nbytes = 8 * nb_pad * K + 8 * nb_pad
    row = check_rows_kernel("bloom_update", bloom_update,
                            ref.bloom_update_ref, flags(*saved[2]), nbytes,
                            reps=50)
    row.update(calls_checked=4, bound_by="bytes")
    log(f"[smoke]   wing-60k BE-Index: {nb} blooms, {be.n_links} links, "
        f"K={K}, {nb_pad} rows; 4 bloom_update rounds equal the engine "
        f"update and the plain version")
    return row


# ---------------------------------------------------------------------
# phase 7: real graphs — edge list → ingest → tiled init → peel →
# hierarchy → served queries
# ---------------------------------------------------------------------
def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sha_bytes(a) -> str:
    """sha256 of an array's raw bytes in its own dtype."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def sha_int64(a) -> str:
    import numpy as np

    return sha_bytes(np.asarray(a, dtype=np.int64))


def write_tsv(realdata, name, tmp) -> str:
    """A recorded graph's edge list as a KONECT-style TSV (a header, then
    1-based ``u<TAB>v`` rows), byte for byte the recorder's file."""
    import numpy as np

    from repro_torch.core.graph import powerlaw_bipartite

    path = os.path.join(tmp, f"{name}.tsv")
    if not os.path.exists(path):
        edges = powerlaw_bipartite(**realdata[name]["graph"]).edges
        with open(path, "w") as f:
            f.write("% bip unweighted\n")
            np.savetxt(f, np.asarray(edges, dtype=np.int64) + 1, fmt="%d",
                       delimiter="\t")
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    expect(name, "TSV sha256", sha, realdata[name]["tsv_sha256"])
    return path


def query_batch_inputs(n_entities, n_nodes, n, seed):
    """The recorder's seeded batch of mixed ``HierarchyService`` queries:
    op codes 0..4, entity ids (node ids for op 4) and second entity ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 5, size=n)
    a_ent = rng.integers(0, n_entities, size=n)
    a_node = rng.integers(0, n_nodes, size=n)
    b = rng.integers(0, n_entities, size=n)
    a = np.where(ops == 4, a_node, a_ent)
    return ops.astype(np.int32), a.astype(np.int32), b.astype(np.int32)


def expect(name, what, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: {what} {got} != JAX {want}")


def check_ingest(name, want, ingest_dir) -> None:
    from repro_torch.data import load_ingested

    ig = load_ingested(ingest_dir)
    got = dict(n_u=ig.n_u, n_v=ig.n_v, m=ig.m)
    got.update({f"{k}_sha256": sha_bytes(getattr(ig, k))
                for k in INGEST_FILES})
    expect(name, "ingest", got, want["ingest"])


def check_tiled(name, want, total, ts, sup_e=None, sup_u=None) -> None:
    w = want["tiled_init"]
    got = dict(total=int(total), **{f: getattr(ts, f) for f in TILE_FIELDS})
    expect(name, "tiled init", got, {k: w[k] for k in got})
    for key, arr in (("sup_e", sup_e), ("sup_u", sup_u)):
        if arr is not None:
            expect(name, f"{key} sha256", sha_int64(arr), w[f"{key}_sha256"])


def check_hierarchy(name, want, h) -> None:
    import numpy as np

    from repro_torch.hierarchy.query import depth_and_up
    from repro_torch.hierarchy.serialize import _ARRAY_FIELDS

    depth, up = depth_and_up(np.asarray(h.parent))
    got = dict(n_nodes=h.n_nodes, n_levels=int(h.levels.size),
               arrays={f: sha_bytes(getattr(h, f)) for f in _ARRAY_FIELDS},
               pack_depth_sha256=sha_bytes(depth),
               pack_up_sha256=sha_bytes(up))
    expect(name, "hierarchy", got, want["hierarchy"])


def real_cli(realdata, name, tsv, flags, dev, tmp, launches, seconds):
    """One ``--edges ... --emit-hierarchy`` CLI run, every step held to
    the recorded JAX values.  Launch counts are zeroed just before and
    read just after.  Returns (launch counts, CLI output, artifact)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import peel as cli

    want = realdata[name]
    ingest_dir = os.path.join(tmp, f"{name}.ingest")
    art = os.path.join(tmp, f"{name}.npz")
    args = cli.build_parser().parse_args(
        ["--kind", want["kind"], "--side", want["side"], "--parts",
         str(want["P"]), "--tile-wedges", str(want["tile_wedges"]),
         "--edges", tsv, "--ingest-dir", ingest_dir, "--emit-hierarchy", art,
         "--device", dev, *flags])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run(args)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    res, ti = out["result"], out["tiled_init"]
    check_ingest(name, want, ingest_dir)
    sup = {("sup_e" if want["kind"] == "wing" else "sup_u"): ti["sup0"]}
    check_tiled(name, want, ti["butterflies"], ti["stats"], **sup)
    got = dict(theta_sha256=out["theta_sha256"],
               part_sha256=sha_int64(res.part),
               support_init_sha256=sha_int64(res.support_init),
               ranges=[int(x) for x in res.ranges],
               stats={f: int(out[f]) for f in STAT_FIELDS})
    expect(name, "peel", got, {k: want[k] for k in got})
    check_hierarchy(name, want, out["hierarchy"])
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    seconds[name] = {k: round(v, 3) for k, v in out["seconds"].items()}
    log(f"[smoke]   {name} --edges {' '.join(flags)}: ingest, tiled init, "
        f"θ, stats and hierarchy match the JAX package in {dt:.1f} s; "
        f"seconds {seconds[name]}; launches {counts}")
    return counts, out, art


def serve_artifact(realdata, name, art, dev, seconds) -> None:
    """Load an artifact back and serve the recorded query batch on
    ``dev``; the arrays and the answers must equal the JAX package's."""
    from repro_torch.hierarchy import HierarchyService, load_hierarchy

    want = realdata[name]
    h = load_hierarchy(art)
    check_hierarchy(f"{name} (loaded)", want, h)
    for key in ("pack_depth", "pack_up"):
        expect(name, f"loaded {key}", sha_bytes(h.meta[key]),
               want["hierarchy"][f"{key}_sha256"])
    svc = HierarchyService(h, device=dev)
    q = want["queries"]
    ops, a, b = query_batch_inputs(h.n_entities, h.n_nodes, q["n"], q["seed"])
    t0 = time.perf_counter()
    ans = svc.query_batch(ops, a, b)
    dt = time.perf_counter() - t0
    expect(name, "served answers sha256", sha_int64(ans),
           q["answers_sha256"])
    seconds.setdefault(name, {})["serving"] = round(dt, 4)
    log(f"[smoke]   {name}: artifact loads back equal; {q['n']} mixed "
        f"queries served in {dt * 1e3:.1f} ms, answers equal")


def phase_real_graphs(realdata, dev, tmp, launches):
    """Phase 7; returns the seconds of each step per run and the
    artifacts it wrote ({name: path})."""
    from repro_torch.core import csr
    from repro_torch.data import load_ingested
    from repro_torch.kernels import ops

    seconds: dict = {}
    arts = {}
    with open(os.path.join(ROOT, "tests", "goldens",
                           "real_graphs.json")) as f:
        sw = json.load(f)["southern_women"]
    sw_tsv = os.path.join(ROOT, "datasets", "southern_women.tsv")
    for kind, key in (("wing", "theta_wing_sha256"),
                      ("tip", "theta_tip_u_sha256")):
        name = f"southern_women-{kind}"
        _, out, arts[name] = real_cli(realdata, name, sw_tsv, ["--use-pallas"],
                                      dev, tmp, launches, seconds)
        expect(name, "θ sha256 (real_graphs.json)", out["theta_sha256"],
               sw[key])
        expect(name, "butterflies (real_graphs.json)",
               out["tiled_init"]["butterflies"], sw["total_butterflies"])

    # tip-1m from its TSV: host tiled init, fused FD, hierarchy on the card
    c, _, arts["tip-1m"] = real_cli(
        realdata, "tip-1m", write_tsv(realdata, "tip-1m", tmp), [], dev, tmp,
        launches, seconds)
    if c["fd_round_tip"] == 0:
        raise AssertionError("tip-1m --edges launched no fd_round_tip")

    # tip-1m's tiled init through wedge_count_tile, at full size
    want = realdata["tip-1m"]
    ig = load_ingested(os.path.join(tmp, "tip-1m.ingest"))
    t0 = time.perf_counter()
    for _ in csr.iter_wedge_tiles(ig, want["tile_wedges"]):
        pass
    host_tiles = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sup_e, sup_u, total, ts = csr.tiled_butterfly_init(
        ig, tile_wedges=want["tile_wedges"], use_pallas=True, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    c = ops.launch_counts()
    check_tiled("tip-1m tiled init (use_pallas)", want, total, ts,
                sup_e=sup_e, sup_u=sup_u)
    if c["wedge_count_tile"] != ts.n_tiles:
        raise AssertionError(f"tiled init launched wedge_count_tile "
                             f"{c['wedge_count_tile']} times for "
                             f"{ts.n_tiles} tiles")
    for k, v in c.items():
        launches[k] = launches.get(k, 0) + v
    seconds["tip-1m tiled init, use_pallas"] = dict(
        total=round(dt, 3), host_tile_generation=round(host_tiles, 3))
    log(f"[smoke]   tip-1m tiled_butterfly_init(use_pallas=True): "
        f"{ts.n_tiles} tiles through wedge_count_tile, sup_e/sup_u equal "
        f"to the JAX package in {dt:.2f} s, of which generating the tiles "
        f"on the host alone takes {host_tiles:.2f} s (peak slot matrix "
        f"{ts.peak_slot_bytes / 1e9:.2f} GB)")

    # the 60k graph through the kernel routes of the CLI
    for name, cd_kernel in (("wing-60k", "support_update"),
                            ("tip-60k", "wedge_count")):
        c, _, arts[name] = real_cli(
            realdata, name, write_tsv(realdata, name, tmp), ["--use-pallas"],
            dev, tmp, launches, seconds)
        for k in ("wedge_count_tile", cd_kernel):
            if c[k] == 0:
                raise AssertionError(f"{name} --edges --use-pallas launched "
                                     f"no {k}")

    for name, art in arts.items():
        serve_artifact(realdata, name, art, dev, seconds)
    return seconds, arts


# ---------------------------------------------------------------------
# phase 9: the LM serving path (dense family) and the flash_attention
# kernel
# ---------------------------------------------------------------------
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor-core peak (dense)
LOGIT_ATOL = 2e-3  # f32 logits of two routes: rounding only (module docstring)
ATTN_ATOL = {"float32": 2e-3, "bfloat16": 3e-2}  # the JAX package's kernel tolerances
# and beside it, every output row's ‖Δ‖/‖ref‖: a row's typical value
# shrinks as it sees more keys (≈ sqrt(1/keys) on these N(0, 1) inputs),
# so the absolute tolerance alone would pass a wrong late row.  bf16
# rounds P and the output once each (2⁻⁹ relative): 1e-2 is five of those;
# f32 rounds at 2⁻²⁴.
ATTN_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}

BF16_LOGIT_RTOL = 3e-2  # bf16 logits of two routes: ‖Δ‖/‖ref‖ (issue 15's gate)
# a model whose bf16 logits drift from its f32 ones in the JAX package
# too (Zamba2): the port's bf16 within this multiple of the reference's
# recorded drift (port against JAX at reduced width: 0.97–1.20×)
BF16_DRIFT = 2.0

# (label, q shape, kv shape, causal, offset, dtype); the first is the row
# of the kernels line (ChatGLM3-6B's prefill attention in bf16, on the
# tensor cores), the f32 case of the same shapes beside it.  Gemma-2B's
# shape at the configs' max_seq holds the D 256 f32 route's longest P·V
# chains; the reduced presets' prefill (D 32) holds the CUDA-core kernel.
_ATTN_SHAPES = (
    ("chatglm3-6b prefill", (4, 32, 2048, 128), (4, 2, 2048, 128), True, None),
    ("D=64 GQA 32/4", (4, 32, 2048, 64), (4, 4, 2048, 64), True, None),
    ("D=256 MQA 8/1", (4, 8, 2048, 256), (4, 1, 2048, 256), True, None),
    ("gemma-2b D=256 S=4096", (1, 8, 4096, 256), (1, 1, 4096, 256), True,
     None),
    ("reduced prefill D=32", (4, 4, 128, 32), (4, 2, 128, 32), True, None),
    ("ragged non-causal S=1500", (2, 16, 1500, 128), (2, 16, 1500, 128),
     False, None),
    ("offset sq=128 < sk=384", (4, 32, 128, 128), (4, 2, 384, 128), True,
     None),
)
LM = dict(
    # the f32 model (prefill, the decode check, the batcher, the decode
    # profile) at full width and f32_layers of the 28 layers; the bf16
    # model at full depth
    arch="chatglm3_6b", batch=4, seq=2048, stride=4, f32_layers=7,
    f32_check_seq=512, bf16_check_seq=256,
    kernel_cases=tuple((f"{label} {tag}", qs, ks, causal, offset, dt)
                       for label, qs, ks, causal, offset in _ATTN_SHAPES
                       for tag, dt in (("bf16", "bfloat16"),
                                       ("f32", "float32"))),
    serve=dict(slots=4, requests=8, prompt=(16, 128), max_new=32, max_seq=256,
               eos_request=1, eos_index=7),
    cli=["--arch", "chatglm3_6b", "--batch", "4", "--prompt-len", "16",
         "--gen", "16"],
)


def attention_case(case, dev, gen):
    """A kernel case's inputs, drawn on ``dev`` from ``gen``."""
    import torch

    _, qs, ks, causal, offset, dt = case
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in (qs, ks, ks))
    return q, k, v, causal, offset


def attention_work(q_shape, k_shape, dv, elt, causal, offset):
    """(operations, bytes) attention needs on q [B, H, sq, D], k [B, KVH,
    sk, D] and v of head dim ``dv``, ``elt`` bytes an element: two
    multiply-adds per visible (query, key) pair for each of q·k's D and
    p·v's dv dims; q, k, v read and the output written once."""
    B, H, sq, D = q_shape
    KVH, sk = k_shape[1], k_shape[2]
    off = sk - sq if offset is None else offset
    if causal:
        seen = sum(max(0, min(sk, i + off + 1)) for i in range(sq))
    else:
        seen = sq * sk
    ops_count = 2.0 * B * H * seen * (D + dv)
    nbytes = elt * (B * H * sq * (D + dv) + B * KVH * sk * (D + dv))
    return ops_count, nbytes


def defined_rows(q, k, causal, offset):
    """Query rows that see at least one key (the JAX oracle leaves the
    others NaN)."""
    import torch

    sq, sk = q.shape[2], k.shape[2]
    off = sk - sq if offset is None else offset
    rows = torch.arange(sq, device=q.device)
    return rows + off >= 0 if causal else rows >= 0


def check_attention(cases, dev, reps):
    """Each case through ``ops.flash_attention`` against its plain
    version on the same inputs, timed with the plain version and SDPA
    where that is the same function: every non-causal case, and a causal
    one where sq == sk (SDPA's causal mask is top-left aligned).  An f32 case (3xTF32 on the tensor cores)
    also times its ``split_kv`` pre-pass alone and carries the bounds of
    one and of three TF32 products, of the FP32 CUDA cores and of memory.
    Returns the kernels-line row (the first case) with every case's
    numbers under ``cases``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for case in cases:
        label, dt = case[0], case[5]
        q, k, v, causal, offset = attention_case(case, dev, gen)
        got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
        want = ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
        rows = defined_rows(q, k, causal, offset)
        delta = got[:, :, rows].float() - want[:, :, rows].float()
        err = delta.abs().max().item()
        row_err = (delta.norm(dim=-1)
                   / want[:, :, rows].float().norm(dim=-1)).max().item()
        if not (err <= ATTN_ATOL[dt] and row_err <= ATTN_ROW_RTOL[dt]):
            raise AssertionError(
                f"flash_attention {label}: max abs err {err} (limit "
                f"{ATTN_ATOL[dt]}), worst row's relative err {row_err} "
                f"(limit {ATTN_ROW_RTOL[dt]}) against the plain version")
        del got, want, delta
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 offset=offset), reps)
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, offset=offset), max(1, reps // 4))
        library_ms = None
        if not causal or q.shape[2] == k.shape[2]:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps)
        ops_count, nbytes = attention_work(q.shape, k.shape, v.shape[-1],
                                           q.element_size(), causal, offset)
        fp32 = ops_count / FP32_FLOP_PER_S * 1e3
        bf16 = ops_count / BF16_FLOP_PER_S * 1e3
        tf32 = ops_count / TF32_FLOP_PER_S * 1e3
        mem = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(case=label, shape_q=list(q.shape), shape_kv=list(k.shape),
                   dtype=dt, route=(fa.route(q.dtype, q.shape[-1])
                                    if q.is_cuda else "plain version"),
                   causal=causal, offset=offset, max_abs_err=err,
                   row_rel_err=row_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_fp32_ms=max(fp32, mem), bound_bf16_ms=max(bf16, mem),
                   bound_hbm_ms=mem, ops_per_call=ops_count, bytes_per_call=nbytes)
        if row["route"] == fa.ROUTES[2]:
            # the split pass: k and v read once, their four planes written
            split_ms = cuda_ms(lambda: fa.split_kv(k, v), reps)
            row.update(bound_1xtf32_ms=max(tf32, mem),
                       bound_3xtf32_ms=max(3 * tf32, mem), split_ms=split_ms,
                       split_bytes=3 * 2 * k.numel() * k.element_size())
        log(f"[smoke]   flash_attention {label} ({row['route']}): max abs err "
            f"{err:.2e} (tol {ATTN_ATOL[dt]}), worst row {row_err:.2e} "
            f"relative (tol {ATTN_ROW_RTOL[dt]}); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA {library_ms} ms; {ops_count / 1e9:.1f} "
            f"G ops, {nbytes / 1e6:.1f} MB -> bound {row['bound_fp32_ms']:.3f} "
            f"ms FP32, {row['bound_bf16_ms']:.3f} ms bf16 tensor cores, "
            f"{mem:.3f} ms memory"
            + (f"; 1xTF32 {row['bound_1xtf32_ms']:.3f} ms, 3xTF32 "
               f"{row['bound_3xtf32_ms']:.3f} ms; split_kv {split_ms:.4f} ms "
               f"({row['split_bytes'] / 1e6:.1f} MB)"
               if "split_ms" in row else ""))
        out.append(row)
        del q, k, v
    first = out[0]
    bound = _design_bound(first)
    # the first case's shapes in each dtype (bf16 and 3xTF32 on the tensor
    # cores), each with the bound of its design, and the rest beside it
    by_dtype = {r["dtype"]: dict(
        ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
        max_abs_err=r["max_abs_err"], row_rel_err=r["row_rel_err"],
        route=r["route"], bound_ms=_design_bound(r),
        **{k: r[k] for k in ("bound_1xtf32_ms", "bound_3xtf32_ms",
                             "bound_fp32_ms", "bound_bf16_ms", "bound_hbm_ms",
                             "split_ms", "split_bytes") if k in r})
        for r in out if (r["shape_q"], r["shape_kv"], r["causal"],
                         r["offset"]) == (first["shape_q"],
                                          first["shape_kv"],
                                          first["causal"], first["offset"])}
    return dict(ms=first["ms"], plain_ms=first["plain_ms"], by_dtype=by_dtype,
                library_ms=first["library_ms"], bound_ms=bound,
                bound_by="operations", max_abs_err=max(r["max_abs_err"]
                                                      for r in out),
                bound_fp32_ms=first["bound_fp32_ms"],
                bound_bf16_ms=first["bound_bf16_ms"],
                ops_per_call=first["ops_per_call"],
                bytes_per_call=first["bytes_per_call"],
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=causal, enable_gqa=True); causal where "
                        "sq == sk only",
                calls_checked=len(out), cases=out)


def _design_bound(row) -> float:
    """The bound of the units an attention case runs on, by its route:
    three TF32 products for the f32 tensor-core kernel, the bf16 tensor
    cores for the bf16 one, the FP32 CUDA cores for D 32 in either
    dtype."""
    return row[{"3xtf32 tensor cores": "bound_3xtf32_ms",
                "bf16 tensor cores": "bound_bf16_ms"}.get(row["route"],
                                                          "bound_fp32_ms")]


def close_logits(label, got, want, atol=LOGIT_ATOL) -> float:
    err = (got.double() - want.double()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{label}: logits differ by {err} > {atol}")
    return err


def hold_golden(label, logits, want, ids) -> float:
    """``logits`` [b, len(positions), V] held to a recorded summary:
    the subset logits and logsumexp within ``LOGIT_ATOL``, the argmax
    where the recorded top-2 gap exceeds twice that."""
    import numpy as np
    import torch

    x = logits.double().cpu()
    err = close_logits(f"{label} subset", x[..., ids],
                       torch.tensor(want["subset"], dtype=torch.float64))
    lse = torch.logsumexp(x, dim=-1)
    err = max(err, close_logits(f"{label} logsumexp", lse,
                                torch.tensor(want["logsumexp"],
                                             dtype=torch.float64)))
    gap = np.asarray(want["top2_gap"])
    amax = x.argmax(dim=-1).numpy()
    sure = gap > 2 * LOGIT_ATOL
    if not np.array_equal(amax[sure], np.asarray(want["argmax"])[sure]):
        raise AssertionError(f"{label}: argmax {amax.tolist()} != JAX "
                             f"{want['argmax']} (gaps {gap.tolist()})")
    return err


def teacher_forced(model, tokens, positions, dev, dtype=None, enc_out=None):
    """Logits [b, len(positions), V] of ``serve_step`` fed ``tokens`` one
    position at a time (no attention kernel on this route but Whisper's
    cross-attention), with a cache of ``dtype`` (default f32) whose
    ``enc_out`` is ``enc_out`` where given (Whisper)."""
    import torch

    from repro_torch.models import init_cache

    b, s = tokens.shape
    cache = init_cache(model.cfg, b, s, dev, dtype or torch.float32)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    want = set(positions)
    out = []
    with torch.no_grad():
        for i in range(max(positions) + 1):
            logits, cache = model.serve_step(cache, tokens[:, i], i)
            if i in want:
                out.append(logits)
    return torch.stack(out, dim=1)


def profile_decode(model, tokens, seq, dev, steps=8) -> dict:
    """Device time of ``steps`` decode steps against a ``seq``-slot cache
    by kernel class (``torch.profiler``, CUDA activity only), beside the
    window's host-clock time; None where the profiler saw no device time
    (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache

    if torch.device(dev).type != "cuda":  # a CPU rehearsal has no kernels
        return dict(device_ms_per_step=None)
    cache = init_cache(model.cfg, tokens.shape[0], seq, dev, torch.float32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.serve_step(cache, tokens[:, i], i)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        log("[smoke]   decode profile: the profiler saw no device time "
            "(not measured)")
        return dict(device_ms_per_step=None)
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(device_ms_per_step=device_ms / steps,
               gemm_ms_per_step=gemm_ms / steps,
               wall_ms_per_step=wall_ms / steps,
               busy_share=device_ms / wall_ms,
               top_kernels={e.key[:60]: e.self_device_time_total / 1e3 / steps
                            for e in top})
    log(f"[smoke]   decode profile ({steps} steps, cache {seq}): device "
        f"{out['device_ms_per_step']:.2f} ms/step, of it GEMM "
        f"{out['gemm_ms_per_step']:.2f}; host clock "
        f"{out['wall_ms_per_step']:.2f} ms/step under the profiler (busy "
        f"share {out['busy_share']:.3f}); top kernels ms/step "
        f"{out['top_kernels']}")
    return out


def golden_tree(golden, cfg):
    """``numpy_params`` of ``cfg`` at the golden's seed, after the
    recorded weights' checks (host numpy only: it may run in a thread
    beside device work, numpy's generator releases the interpreter
    lock)."""
    import numpy as np

    from repro_torch.models.convert import numpy_params

    tree = numpy_params(cfg, seed=golden["seed"])
    for path, want in golden["param_check"].items():
        node = tree
        for p in path.split("."):
            node = node[p]
        first = [float(x) for x in node.reshape(-1)[:4]]
        total = float(node.sum(dtype=np.float64))
        # the float64 sum's order may differ between numpy builds
        if first != want["first"] or abs(total - want["sum"]) > 1e-6 * (
                1 + abs(want["sum"])):
            got = dict(first=first, sum=total)
            raise AssertionError(f"numpy_params {path}: {got} != the "
                                 f"recorder's {want} (another numpy stream)")
    return tree


def golden_model(golden, cfg, dev, tree=None):
    """``cfg`` on the golden's weights (``golden_tree``, made here unless
    given) as a ``DenseLM`` on ``dev``; and the seconds that took."""
    from repro_torch.models import DenseLM
    from repro_torch.models.convert import params_from_numpy

    t0 = time.perf_counter()
    if tree is None:
        tree = golden_tree(golden, cfg)
    model = DenseLM(cfg, params_from_numpy(tree, cfg, dev))
    del tree
    return model, time.perf_counter() - t0


def hold_lm_golden(golden, model, dev, forward_vs_decode=True) -> dict:
    """``model``'s forward and teacher-forced decode held to the JAX
    package's recorded logits (and to each other where
    ``forward_vs_decode``: not where the forward drops MoE pairs)."""
    import torch

    tokens = torch.tensor(golden["tokens"], device=dev)
    pos, ids = golden["positions"], golden["ids"]
    with torch.no_grad():
        fwd = model(tokens)[:, pos]
    dec = teacher_forced(model, tokens, pos, dev)
    errs = dict(forward=hold_golden("golden forward", fwd, golden["forward"], ids),
                decode=hold_golden("golden decode", dec, golden["decode"], ids))
    if forward_vs_decode:
        errs["forward_vs_decode"] = close_logits("golden forward vs decode",
                                                 fwd, dec)
    return errs


def lm_golden_phase(golden, cfg, dev) -> dict:
    """Depth-2 ChatGLM3-6B at full width on ``numpy_params``: forward and
    teacher-forced decode held to the JAX package's recorded logits."""
    model, gen_s = golden_model(golden, cfg, dev)
    errs = hold_lm_golden(golden, model, dev)
    log(f"[smoke]   golden (depth {cfg.n_layers}, full width): forward and "
        f"serve_step held to the JAX package's logits, max abs errs {errs}; "
        f"weights made in {gen_s:.1f} s")
    return errs


def serve_requests(cfg, params, spec, dev, vocab):
    """``ContinuousBatcher`` serving ``spec['requests']`` seeded prompts
    through ``spec['slots']`` slots; then the first batch again with an
    EOS on one request, which must stop at its first generated EOS while
    the others repeat their tokens."""
    import numpy as np

    from repro_torch.serve import ContinuousBatcher, Request

    rng = np.random.default_rng(3)
    lo, hi = spec["prompt"]
    prompts = [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(spec["requests"])]

    def run(reqs):
        eng = ContinuousBatcher(cfg, params, n_slots=spec["slots"],
                                max_seq=spec["max_seq"], device=dev)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run()
        sync(dev)
        return done, time.perf_counter() - t0, eng.steps

    done, dt, steps = run([Request(uid=i, prompt=p, max_new=spec["max_new"])
                           for i, p in enumerate(prompts)])
    if [r.uid for r in done] != list(range(len(prompts))) or any(
            len(r.output) != spec["max_new"] for r in done):
        raise AssertionError(f"serving: {len(done)} of {len(prompts)} "
                             "requests completed with max_new tokens")
    e, k = spec["eos_request"], spec["eos_index"]
    eos = done[e].output[k]
    stop = done[e].output.index(eos)
    again, dt2, steps2 = run([
        Request(uid=i, prompt=prompts[i], max_new=spec["max_new"],
                eos=eos if i == e else None) for i in range(spec["slots"])])
    for r in again:
        want = done[r.uid].output[:stop + 1] if r.uid == e else done[r.uid].output
        if r.output != want:
            raise AssertionError(f"serving with EOS: request {r.uid} gave "
                                 f"{r.output}, expected {want}")
    tokens = sum(len(p) + spec["max_new"] for p in prompts)
    log(f"[smoke]   serving: {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}) through {spec['slots']} slots in "
        f"{steps} steps, {dt:.2f} s ({tokens / dt:.1f} tok/s incl. prompts); "
        f"EOS rerun of the first batch: request {e} stopped after "
        f"{stop + 1} tokens, {steps2} steps, {dt2:.2f} s")
    return dict(requests=len(prompts), steps=steps, seconds=dt,
                tokens_per_s=tokens / dt, eos_steps=steps2, eos_seconds=dt2)


def bf16_model(cfg, lm, dev, launches) -> dict:
    """``cfg`` at full width in bf16 (random weights from a seeded
    ``torch.Generator``): prefill at (batch, seq) twice, timed, with one
    ``flash_attention`` launch a layer; then at ``bf16_check_seq``
    positions the forward's logits (every position) and the prefill's
    (the last) held to a bf16 teacher-forced decode of the same tokens
    (plain decode attention, bf16 cache) within ``BF16_LOGIT_RTOL``,
    relative in the 2-norm."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import DenseLM, init_params

    on_card = torch.device(dev).type == "cuda"
    want = {k: (cfg.n_layers * on_card if k == "flash_attention" else 0)
            for k in ops.KERNELS}

    def counted(label, fn):
        ops.reset_launch_counts()
        out = fn()
        sync(dev)
        counts = ops.launch_counts()
        expect(label, "kernel launches", counts, want)
        launches["flash_attention"] = (launches.get("flash_attention", 0)
                                       + counts["flash_attention"])
        return out

    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.bfloat16))
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = lm["batch"], lm["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill_s = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            counted("bf16 prefill", lambda: model.prefill(tokens))
            prefill_s.append(time.perf_counter() - t0)
        n = min(lm["bf16_check_seq"], s)
        ids = tokens[:, :n].contiguous()
        fwd = counted("bf16 forward", lambda: model(ids)).float()
        last = counted("bf16 prefill (check)",
                       lambda: model.prefill(ids)).float()
    t0 = time.perf_counter()
    dec = teacher_forced(model, ids, list(range(n)), dev,
                         torch.bfloat16).float()
    sync(dev)
    decode_s = time.perf_counter() - t0

    def rel(label, got, ref):
        err = ((got - ref).norm() / ref.norm()).item()
        if not err <= BF16_LOGIT_RTOL:
            raise AssertionError(f"{label}: relative logit error {err} > "
                                 f"{BF16_LOGIT_RTOL}")
        return err

    info.update(
        prefill_s=prefill_s, prefill_tok_s=[b * s / t for t in prefill_s],
        check_positions=n, decode_s=decode_s,
        forward_vs_decode_rel=rel("bf16 forward vs teacher-forced decode",
                                  fwd, dec),
        prefill_vs_decode_rel=rel("bf16 prefill vs teacher-forced decode",
                                  last, dec[:, -1]))
    log(f"[smoke]   {cfg.name} bf16 ({info['weights_gb']:.2f} GB): prefill "
        f"b={b} s={s} in {prefill_s} s ({info['prefill_tok_s']} tok/s), "
        f"{cfg.n_layers} flash_attention launches each; at {n} positions "
        f"forward / prefill vs bf16 teacher-forced decode ({decode_s:.1f} s) "
        f"relative error {info['forward_vs_decode_rel']:.3e} / "
        f"{info['prefill_vs_decode_rel']:.3e} (rtol {BF16_LOGIT_RTOL})")
    del model
    return info


def phase_lm(golden, dev, launches, cfg=None, golden_cfg=None, lm=LM,
             reps=10) -> tuple:
    """Phase 9; returns (the flash_attention row, the LM numbers)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import DenseLM, init_params

    row = check_attention(lm["kernel_cases"], dev, reps)
    info = {}

    # ---- the full-width model, cut to f32_layers: prefill and forward
    # against the decode path
    full = cfg or get_config(lm["arch"])
    cfg = dataclasses.replace(full, n_layers=min(full.n_layers,
                                                 lm["f32_layers"]))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, torch.float32)
    model = DenseLM(cfg, params)
    sync(dev)
    info["init_s"] = time.perf_counter() - t0
    b, s = lm["batch"], lm["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    last, prefill_s = counted_prefills("prefill", model, tokens, dev,
                                       launches)
    with torch.no_grad():
        # the decode check runs over the first f32_check_seq positions
        # (a decode step costs ~38 ms at this width)
        n = min(lm["f32_check_seq"], s)
        pos = sorted(set(range(0, n, lm["stride"])) | {n - 1})
        fwd = model(tokens)[:, pos]
        if n < s:
            last = model.prefill(tokens[:, :n].contiguous())
    t0 = time.perf_counter()
    dec = teacher_forced(model, tokens[:, :n].contiguous(), pos, dev)
    sync(dev)
    decode_s = time.perf_counter() - t0
    info.update(
        prefill_s=prefill_s, prefill_tok_s=[b * s / t for t in prefill_s],
        decode_s=decode_s, decode_tok_s=b * n / decode_s,
        positions_compared=len(pos),
        prefill_vs_decode=close_logits("prefill vs teacher-forced decode",
                                       last, dec[:, -1]),
        forward_vs_decode=close_logits("forward vs teacher-forced decode",
                                       fwd, dec))
    del fwd, dec, last
    log(f"[smoke]   {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads): prefill b={b} s={s} in "
        f"{prefill_s} s ({info['prefill_tok_s']} tok/s), {cfg.n_layers} "
        f"flash_attention launches each; {n} teacher-forced decode steps in "
        f"{decode_s:.2f} s ({info['decode_tok_s']:.1f} tok/s); prefill and "
        f"forward ({len(pos)} positions) vs decode max abs err "
        f"{info['prefill_vs_decode']:.2e} / {info['forward_vs_decode']:.2e} "
        f"(atol {LOGIT_ATOL})")

    info["serve"] = serve_requests(cfg, params, lm["serve"], dev, cfg.vocab)
    info["decode_profile"] = profile_decode(model, tokens, s, dev)
    del model, params
    torch.cuda.empty_cache()

    # ---- the same architecture in bf16: prefill on the tensor-core kernel
    info["bf16"] = bf16_model(full, lm, dev, launches)
    torch.cuda.empty_cache()

    # ---- the recorded depth-2 golden
    golden_cfg = golden_cfg or dataclasses.replace(
        get_config(golden["arch"]), n_layers=golden["n_layers"])
    info["golden"] = lm_golden_phase(golden, golden_cfg, dev)
    torch.cuda.empty_cache()

    # ---- the CLI, in its own process
    info["cli_s"], info["cli"] = serve_cli(lm["cli"], dev)
    return row, info


def serve_cli(args, dev) -> tuple:
    """``python -m repro_torch.launch.serve`` with ``args`` on ``dev`` in
    its own process; it must exit 0 and print a sample.  Returns its
    seconds and output lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args,
           "--device", str(dev)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0 or "[serve] sample:" not in proc.stdout:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    dt = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"[smoke]   {' '.join(cmd[1:])}: exit 0 in {dt:.1f} s: {lines}")
    return dt, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("[smoke] src/repro_torch not found beside chip_smoke.py; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_fullsize.json")) as f:
        fullsize = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_realdata.json")) as f:
        realdata = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_engines.json")) as f:
        engines = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens", "torch_lm.json")) as f:
        lm_golden = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_stream.json")) as f:
        streams = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_multiserve.json")) as f:
        mt_golden = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens", "torch_moe.json")) as f:
        moe_golden = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens", "torch_ssm.json")) as f:
        ssm_golden = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_audio_vlm.json")) as f:
        av_golden = json.load(f)
    smi = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        return run_phases(fullsize, realdata, engines, lm_golden, streams,
                          mt_golden, moe_golden, ssm_golden, av_golden, dev,
                          smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(fullsize, realdata, engines, lm_golden, streams, mt_golden,
               moe_golden, ssm_golden, av_golden, dev, smi, tmp) -> int:
    import concurrent.futures

    import torch

    with Phase("1-setup"):
        from repro_torch.kernels import _build, ops

        t0 = time.perf_counter()
        _build.build_all()
        log(f"[smoke]   built {len(_build.SOURCES)} kernel libraries in "
            f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
        for name in _build.SOURCES:
            path = os.path.join(_build.BUILD_DIR, f"{name}.log")
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                for fn, res in ptxas_resources(text):
                    log(f"[smoke]   ptxas {name}: {fn}: {res}")
                for line in serialized_wgmma(text):
                    log(f"[smoke]   ptxas {name} WARNING: {line}")
        gmma = tensor_core_sass(_build.build_all())
        log(f"[smoke]   dynamic shared memory a block: {smem_bytes()}")
        log(f"[smoke]   torch {torch.__version__} cuda {torch.version.cuda} "
            f"on {torch.cuda.get_device_name(0)} ({smi})")

    with Phase("2-kernels"):
        cache: dict = {}
        rows = phase_kernels(fullsize, realdata, dev, cache, tmp)

    with Phase("3-goldens"):
        phase_goldens(dev)

    launches: dict = {}
    with Phase("4-tip-1m"):
        g = prepare(fullsize, "tip-1m", dev, cache)["g"]
        base = main_path(fullsize, "tip-1m", g, [], launches, dev)
        if base[0]["fd_round_tip"] == 0:
            raise AssertionError("tip-1m default path launched no "
                                 "fd_round_tip")
        main_path(fullsize, "tip-1m", g, ["--fd-driver", "vmapped"],
                  launches, dev)
        trace_info = traced_main_path(fullsize, "tip-1m", g, base, launches,
                                      dev, tmp)

    with Phase("5-wing-60k"):
        g = prepare(fullsize, "wing-60k", dev, cache)["g"]
        c, _, _ = main_path(fullsize, "wing-60k", g, ["--engine", "csr"],
                            launches, dev)
        if c["fd_round_wing"] == 0:
            raise AssertionError("wing-60k default path launched no "
                                 "fd_round_wing")
        main_path(fullsize, "wing-60k", g,
                  ["--engine", "csr", "--fd-driver", "vmapped"], launches,
                  dev)
        c, _, _ = main_path(fullsize, "wing-60k", g,
                            ["--engine", "csr", "--use-pallas"], launches,
                            dev)
        if c["support_update"] == 0:
            raise AssertionError("--use-pallas wing launched no "
                                 "support_update")
        c, _, _ = main_path(fullsize, "tip-60k", g, ["--use-pallas"],
                            launches, dev)
        if c["wedge_count"] == 0:
            raise AssertionError("--use-pallas tip launched no wedge_count")

    with Phase("6-fd-drivers"):
        fd_times = phase_fd_drivers(fullsize, dev, cache)
    cache.clear()

    with Phase("7-real-graphs"):
        real_seconds, arts = phase_real_graphs(realdata, dev, tmp, launches)

    with Phase("8-engines"):
        engine_rows, engine_seconds = phase_engines(engines, fullsize, dev,
                                                    launches)
        rows.update(engine_rows)

    with Phase("9-lm"):
        rows["flash_attention"], lm_info = phase_lm(lm_golden, dev, launches)

    with Phase("10-stream"):
        stream_info = phase_stream(streams, fullsize, dev, launches)

    with Phase("11-multitenant"):
        mt_info = phase_multitenant(mt_golden, arts, dev, tmp, smi)
        for k in ("fd_round_tip", "fd_round_wing"):
            if mt_info["launches"].get(k, 0) == 0:
                raise AssertionError(f"the tenants' peels launched no {k}")
        for k, v in mt_info["launches"].items():
            launches[k] = launches.get(k, 0) + v

    # phases 14's, 15's and 16's golden weights (5.1 G, 1.7 G and 3.6 G
    # numpy normals) drawn on one host thread from here on, beside phases
    # 12-15
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    dry = card = None
    try:
        moe_tree = pool.submit(golden_tree, moe_golden,
                               moe_golden_config(moe_golden))
        ssm_trees = {arch: pool.submit(golden_tree, ssm_golden[arch], cfg)
                     for arch, cfg in ssm_golden_configs(ssm_golden).items()}
        av_trees = {arch: pool.submit(golden_tree, av_golden[arch], cfg)
                    for arch, cfg in av_golden_configs(av_golden).items()}

        with Phase("12-distributed"):
            large = dict(STREAM_LARGE, theta_sha256=stream_info[
                STREAM_LARGE["name"]]["initial_theta_sha256"])
            dist_info = phase_distributed(fullsize, engines, large, dev, tmp,
                                          launches)

        with Phase("13-train"):
            train_info = phase_train(fullsize, dev, tmp, launches, smi=smi)
            rows["flash_attention"]["training_launches"] = dict(
                cli=train_info["cli"]["flash_attention_launches"],
                curriculum=train_info["curriculum"][
                    "flash_attention_launches"])

        with Phase("14-moe"):
            launched = launches.get("flash_attention", 0)
            rows["flash_attention"]["mla"], moe_info = phase_moe(
                moe_golden, dev, launches, tree=moe_tree)
            del moe_tree
            rows["flash_attention"]["mla"]["launches"] = (
                launches["flash_attention"] - launched)
            rows["flash_attention"]["training_launches"]["moe"] = sum(
                moe_info["train"][k]["launches_full"]
                + moe_info["train"][k]["launches_none"]
                for k in moe_info["train"] if k != "cli")

        # phase 17's four ranks (CPU work once gloo fails on the card, bar
        # a probe and the plain reference there) in their own processes
        # from here on
        card = start_card(tmp)
        with Phase("15-ssm"):
            rows["flash_attention"]["zamba2"], ssm_info = phase_ssm(
                ssm_golden, dev, launches, trees=ssm_trees)
            del ssm_trees

        # phase 17's dry-run (CPU only) in its own process from here on
        dry = start_dryrun(tmp)
        with Phase("16-audio-vlm"):
            rows["flash_attention"]["audio_vlm"], av_info = phase_audio_vlm(
                av_golden, dev, launches, trees=av_trees)
            del av_trees
            rows["flash_attention"]["training_launches"]["audio_vlm"] = rows[
                "flash_attention"]["audio_vlm"]["launches"]["training"]
    except BaseException:
        for proc in (dry, card):
            if proc is not None and proc[0].poll() is None:
                proc[0].kill()
                proc[0].wait()
        raise
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    with Phase("17-lm-mesh"):
        launched = launches.get("flash_attention", 0)
        mesh_info = phase_lm_mesh(dev, tmp, dry=dry, launches=launches,
                                  card=card)
        rows["flash_attention"]["lm_mesh"] = dict(
            launches=launches["flash_attention"] - launched,
            world1=mesh_info["launches"],
            ranks=mesh_info["ranks"].get("launches"))

    missing = [k for k in KERNEL_INFO if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=int(launches[name]), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms"),
            **{key: r[key] for key in ("bytes_per_call", "ops_per_call",
                                       "bound_fp32_ms", "bound_bf16_ms",
                                       "by_dtype", "ms_by_product",
                                       "bound_by_product", "bound_3xtf32_ms",
                                       "random_f32_rel_err", "library",
                                       "ms_packed", "pack_ms", "int_mm_ms",
                                       "tiled_e2e_ms", "training_launches",
                                       "mla", "zamba2", "audio_vlm",
                                       "lm_mesh")
               if key in r}))
    log(json.dumps(dict(phase_seconds=Phase.seconds, gmma=gmma,
                        fd_driver_seconds=fd_times,
                        real_graph_seconds=real_seconds,
                        engine_seconds=engine_seconds, lm=lm_info,
                        traced_tip_1m=trace_info, stream=stream_info,
                        multitenant=mt_info, distributed=dist_info,
                        train=train_info, moe=moe_info, ssm=ssm_info,
                        audio_vlm=av_info, lm_mesh=mesh_info)))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------
# phase 10: the streaming updater
# ---------------------------------------------------------------------
# the packed-forest arrays an incremental epoch must reproduce
FOREST_FIELDS = ("node_level", "parent", "entity_node", "member_off",
                 "member_ids", "child_off", "child_ids", "tin", "tout",
                 "ent_order", "estart", "eend", "node_m", "node_nu",
                 "node_nv")
# the large tip stream: tip-1m's generator at a quarter of its scale (an
# epoch of tip-1m itself, with its initial peel and the re-peels, took
# ~150 s of the smoke's 1 200), its P; epochs, events an epoch, seed of
# epoch 0's events
STREAM_LARGE = dict(name="tip-250k",
                    graph=dict(n_u=25_000, n_v=12_500, m=250_000, alpha=0.6,
                               seed=0),
                    P=16, epochs=1, batch=2048, event_seed=2000)


def sha16(a) -> str:
    """The stream goldens' digest: sha256 of the int64 bytes, 16 hex."""
    return sha_int64(a)[:16]


def forest_sha(h) -> str:
    """The stream goldens' forest digest (every packed-forest array)."""
    import numpy as np

    hsh = hashlib.sha256()
    for f in FOREST_FIELDS:
        hsh.update(f.encode())
        hsh.update(np.ascontiguousarray(getattr(h, f)).astype(
            np.int64, copy=False).tobytes())
    return hsh.hexdigest()[:16]


def stream_record(st, rep) -> dict:
    """One epoch's digests, in the format of ``torch_stream.json``."""
    return dict(
        epoch=rep.epoch, net=[rep.n_inserts, rep.n_deletes], m=int(st.g.m),
        theta_sha=sha16(st.result.theta), part_sha=sha16(st.result.part),
        sup_init_sha=sha16(st.result.support_init),
        stats=st.result.stats.as_dict(), forest_sha=forest_sha(st.hierarchy),
        partitions_dirty=rep.partitions_dirty, levels_dirty=rep.levels_dirty)


def scratch_peel(g, cfg, dev):
    """The from-scratch re-peel of the materialized graph that a stream
    epoch is held to: the same engine, FD driver and kernel route."""
    from repro_torch.core.peel import tip_decomposition, wing_decomposition

    kw = dict(P=cfg.P, engine=cfg.engine, fd_driver=cfg.fd_driver,
              use_pallas=cfg.use_pallas, device=dev)
    if cfg.kind == "wing":
        return wing_decomposition(g, **kw)
    return tip_decomposition(g, side=cfg.side, **kw)


def hold_scratch(label, st, ref, h_ref=None) -> None:
    """θ, partition, ⋈init, ranges and the PeelStats row equal to the
    re-peel; with ``h_ref`` every forest array too (density allclose)."""
    import numpy as np

    res = st.result
    for f in ("theta", "part", "support_init", "ranges"):
        if not np.array_equal(getattr(res, f), getattr(ref, f)):
            raise AssertionError(f"{label}: {f} differs from the "
                                 "from-scratch re-peel")
    expect(label, "stats", res.stats.as_dict(), ref.stats.as_dict())
    if h_ref is not None:
        h = st.hierarchy
        bad = [f for f in FOREST_FIELDS
               if not np.array_equal(getattr(h, f), getattr(h_ref, f))]
        if bad or not np.allclose(h.density, h_ref.density):
            raise AssertionError(f"{label}: forest fields {bad} (or "
                                 "density) differ from the rebuild")


def span_ms(fn):
    """Run ``fn()`` with the obs layer on; returns (its result, the
    milliseconds of its spans by name, ``fd.partition[i]`` summed as
    ``fd.launch``)."""
    from repro_torch import obs

    tracer = obs.enable()
    try:
        res = fn()
    finally:
        obs.disable()
    ms: dict = {}
    for e in tracer.spans(ph="X"):
        key = "fd.launch" if e["cat"] == "fd.launch" else e["name"]
        ms[key] = round(ms.get(key, 0.0) + e["dur"] / 1e3, 1)
    return res, ms


def stream_case(label, g, cfg, epochs, batch, event_seed, dev, launches,
                want=None, kernel=None, forest_every=True) -> dict:
    """A stream of ``epochs`` micro-epochs of ``batch`` random events on
    ``g``.  Launch counts are zeroed before each epoch and read after it;
    every epoch (and, with ``forest_every``, the initial peel) is held to
    a from-scratch re-peel on the card, its forest too where
    ``forest_every`` or at the last epoch, and to the JAX package's
    digests ``want``; ``kernel`` must launch in every epoch.  The stream's
    own epochs run with the obs layer on (a few spans an epoch; no FD
    rings, since the stream installs no timeline collector), the
    re-peels with it off.  Returns the seconds, the per-epoch reports and
    their span milliseconds."""
    from repro_torch.hierarchy import build_hierarchy
    from repro_torch.kernels import ops
    from repro_torch.streaming import StreamState, make_random_events

    def rebuild(st, ref):
        return build_hierarchy(st.g, ref, kind=cfg.kind, side=cfg.side,
                               device=dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st, ms = span_ms(lambda: StreamState.initial(g, cfg, device=dev))
    sync(dev)
    out = dict(initial_s=round(time.perf_counter() - t0, 3), initial_ms=ms,
               initial_theta_sha256=sha_int64(st.result.theta), epochs=[])
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    if forest_every:
        ref = scratch_peel(st.g, cfg, dev)
        hold_scratch(f"{label} initial", st, ref, rebuild(st, ref))
    log(f"[smoke]   {label} stream initial peel + forest in "
        f"{out['initial_s']:.2f} s ({st.hierarchy.n_nodes} nodes, "
        f"{int(st.hierarchy.levels.size)} levels); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for e in range(epochs):
        events = make_random_events(st.g, batch, seed=event_seed + e)
        ops.reset_launch_counts()
        rep, ms = span_ms(lambda: st.apply_epoch(events))
        sync(dev)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if kernel is not None and counts[kernel] == 0:
            raise AssertionError(f"{label} epoch {rep.epoch} launched no "
                                 f"{kernel}")
        t1 = time.perf_counter()
        ref = scratch_peel(st.g, cfg, dev)
        sync(dev)
        scratch_s = time.perf_counter() - t1
        forest = forest_every or e == epochs - 1
        hold_scratch(f"{label} epoch {rep.epoch}", st, ref,
                     rebuild(st, ref) if forest else None)
        if want is not None:
            expect(label, f"epoch {rep.epoch} digests", stream_record(st, rep),
                   want[e])
        row = dict(rep.as_dict(), scratch_peel_s=round(scratch_s, 3),
                   forest_held=forest, span_ms=ms,
                   launches={k: v for k, v in counts.items() if v})
        out["epochs"].append(row)
        log(f"[smoke]   {label} epoch {rep.epoch}: net +{rep.n_inserts}/"
            f"-{rep.n_deletes}, dirty {rep.partitions_dirty}/{rep.p_eff} "
            f"partitions, {rep.levels_dirty}/{rep.levels_total} levels; "
            f"repair {rep.repair_ms:.1f} ms, epoch {rep.epoch_ms:.1f} ms, "
            f"scratch re-peel {scratch_s * 1e3:.1f} ms; equal to the "
            f"re-peel (θ, stats{', forest' if forest else ''})"
            f"{' and the JAX digests' if want is not None else ''}; "
            f"launches {row['launches']}; span ms {ms}")
    return out


def stream_dryrun(dev) -> float:
    """``python -m repro_torch.launch.stream --dryrun`` in its own
    process; returns its seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--dryrun",
         "--device", dev], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    dt = time.perf_counter() - t0
    if (out.returncode != 0 or "incremental maintenance = from-scratch"
            not in out.stdout):
        raise AssertionError(f"launch.stream --dryrun failed "
                             f"(rc {out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        log(f"[smoke]   {line}")
    return round(dt, 3)


def phase_stream(streams, fullsize, dev, launches) -> dict:
    """The streaming updater on the card: the 60k graph as wing and as
    tip (``wedge_count`` in every epoch), each epoch held to a re-peel
    and to ``torch_stream.json``; ``STREAM_LARGE``; then ``--dryrun``."""
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.streaming import StreamConfig

    info = {}
    g = powerlaw_bipartite(**streams["graph"])
    expect("stream 60k", "edges sha256", cli_sha(g),
           fullsize["wing-60k"]["edges_sha256"])
    for name, conf in streams["config"].items():
        cfg = StreamConfig(kind=conf["kind"], engine="csr", P=streams["P"],
                           fd_driver="device", use_pallas=conf["use_pallas"])
        info[name] = stream_case(
            name, g, cfg, streams["epochs"], streams["batch"],
            streams["event_seed"], dev, launches,
            want=streams["cases"][name],
            kernel="wedge_count" if cfg.kind == "tip" else None)
    big = STREAM_LARGE
    g = powerlaw_bipartite(**big["graph"])
    cfg = StreamConfig(kind="tip", engine="csr", P=big["P"],
                       fd_driver="device")
    info[big["name"]] = stream_case(big["name"], g, cfg, big["epochs"],
                                    big["batch"], big["event_seed"], dev,
                                    launches, forest_every=False)
    info["dryrun_s"] = stream_dryrun(dev)
    return info


def cli_sha(g) -> str:
    from repro_torch.launch.peel import sha256_int64

    return sha256_int64(g.edges)


def phase_fd_drivers(fullsize, dev, cache) -> dict:
    """Phase 2 of each full-size graph under every FD driver, from one CD
    run: θ, the FD round counts and the update count must equal the JAX
    package's; returns the FD seconds (host clock, synchronized, packing
    included) per graph and driver."""
    import numpy as np
    import torch

    from repro_torch.core import peel, peelspec
    from repro_torch.launch.peel import sha256_int64

    drivers = (("device", True), ("device", False), ("vmapped", True),
               ("vmapped", False), ("host", False))
    out = {}
    for name, kind in (("wing-60k", "wing"), ("tip-1m", "tip")):
        want = fullsize[name]
        pre = prepare(fullsize, name, dev, cache)
        times = {}
        for fd, fused in drivers:
            stats = peelspec.PeelStats()
            spec = peel.build_peel_spec(
                pre["g"], kind, stats, engine="csr", fd_driver=fd,
                fused=fused, sup0=pre["sup0"], wed=pre["wed"], device=dev)
            theta = np.zeros(spec.n, dtype=np.int64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            peelspec.run_fd(spec, pre["part"], pre["sup_init"], theta,
                            pre["n_parts"], stats, fd_driver=fd)
            torch.cuda.synchronize()
            key = f"{fd}{'+fused' if fused else ''}"
            times[key] = round(time.perf_counter() - t0, 4)
            got = (sha256_int64(theta), stats.rho_fd_total, stats.rho_fd_max,
                   pre["cd_updates"] + stats.updates)
            exp = (want["theta_sha256"], want["stats"]["rho_fd_total"],
                   want["stats"]["rho_fd_max"], want["stats"]["updates"])
            if got != exp:
                raise AssertionError(f"{name} FD driver {key}: (θ sha, "
                                     f"ρ_fd_total, ρ_fd_max, updates) {got} "
                                     f"!= JAX {exp}")
        out[name] = times
        log(f"[smoke]   {name}: every FD driver matches the JAX package; "
            f"FD seconds by driver: {times}")
    return out


# ---------------------------------------------------------------------
# phase 11: the multi-tenant hierarchy service
# ---------------------------------------------------------------------
# benchmarks/serve.py's deployment (64 tenant artifacts cycling distinct
# decompositions behind one endpoint) at forest sizes users serve: the
# phase's own 16 tip and wing graphs, peeled on the card with the fused
# FD rounds, and phase 7's five artifacts (tip-1m first, so tenant t00
# is the pinned 100 000-entity forest).  A 32-slot pool, so tenants
# churn through the LRU cache mid-stream; the stream walks windows of
# ``window`` tenants (t00 in every one) ``stride`` tenants at a time,
# one segment of ``queries / segments`` queries each, so no dispatch
# chunk touches more tenants than the pool holds.
MT = dict(
    graphs=dict(tip=dict(n_u=2_000, n_v=1_000, m=15_000, alpha=0.6),
                wing=dict(n_u=600, n_v=400, m=3_000, alpha=0.6)),
    seeds=8, P=16, tenants=64, slots=32, queries=50_000, segments=10,
    window=16, stride=8, batches=(1024, 4096),
    cli_batch=4096, cli_queries=200_000,
    reused=("tip-1m", "wing-60k", "tip-60k", "southern_women-wing",
            "southern_women-tip"),
)


def load_module(name, path):
    """The Python file at ``path`` as a module named ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_peel(dev):
    """``peel(nu, nv, m, seed, P)`` → (graph, wing result) on ``dev``,
    as ``multiserve_replay.write_tenants`` takes it."""
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.core.peel import wing_decomposition

    def peel(nu, nv, m, seed, P):
        g = powerlaw_bipartite(nu, nv, m, seed=seed)
        return g, wing_decomposition(g, P=P, engine="csr", device=dev)
    return peel


def multiserve_golden(golden, dev, tmp) -> dict:
    """The small fixed tenant set of ``tests/goldens/torch_multiserve.json``
    replayed through the port on ``dev`` (``multiserve_replay.py``, the
    replay the JAX recorder ran); every recorded field must equal the JAX
    package's."""
    from repro_torch.hierarchy import (ForestPool, MultiTenantService,
                                       build_hierarchy, multiserve,
                                       save_hierarchy)
    from repro_torch.launch.hserve import _mixed_workload

    rec = load_module("multiserve_replay", os.path.join(
        ROOT, "tests", "goldens", "multiserve_replay.py"))
    recipe = golden["recipe"]
    d = os.path.join(tmp, "multiserve_golden")
    os.makedirs(d, exist_ok=True)
    rec.write_tenants(recipe, d, port_peel(dev),
                      lambda g, r: build_hierarchy(g, r, device=dev),
                      save_hierarchy)
    multiserve.reset_dispatch_count()
    pool = ForestPool(slots=recipe["slots"], artifact_dir=d, device=dev)
    svc = MultiTenantService(pool, batch=recipe["batch"])
    got = rec.replay(recipe, pool, svc, _mixed_workload)
    got["compiled_dispatch_count"] = multiserve.compiled_dispatch_count()
    expect("multiserve golden", "record", got,
           {k: golden[k] for k in got})
    return got


def mt_peel(mt, dev):
    """The phase's own decompositions, peeled on ``dev`` with the fused
    FD rounds (``fd_round_tip`` / ``fd_round_wing``) and built into
    forests.  Launch counts are zeroed just before and read just after.
    Then each graph is peeled again on the CPU, where the same driver
    runs the rounds' plain versions (``ref.fd_round_*_ref``) on the same
    inputs: θ and ``PeelStats`` must be equal bit for bit.  Returns
    ({name: Hierarchy}, launch counts, seconds of the peels on ``dev``,
    seconds of the plain peels)."""
    import numpy as np

    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.core.peel import tip_decomposition, wing_decomposition
    from repro_torch.hierarchy import build_hierarchy
    from repro_torch.kernels import ops

    def peel_all(device):
        for kind, graph in mt["graphs"].items():
            peel = tip_decomposition if kind == "tip" else wing_decomposition
            for s in range(mt["seeds"]):
                g = powerlaw_bipartite(**graph, seed=s)
                yield kind, s, g, peel(g, P=mt["P"], engine="csr",
                                       fused=True, device=device)

    hs, got = {}, {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for kind, s, g, res in peel_all(dev):
        hs[f"{kind}{s}"] = build_hierarchy(g, res, kind=kind, device=dev)
        got[f"{kind}{s}"] = res
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    for kind, s, _, want in peel_all("cpu"):
        res = got[f"{kind}{s}"]
        if not (np.array_equal(np.asarray(res.theta), np.asarray(want.theta))
                and res.stats == want.stats):
            raise AssertionError(
                f"{kind}{s}: the fused peel on {dev} differs from the plain "
                f"rounds' on the CPU: stats {res.stats} != {want.stats} or θ")
    return hs, counts, dt, time.perf_counter() - t0


def mt_layout(mt, hs, arts, tmp):
    """Every decomposition's artifact, and ``mt["tenants"]`` tenant
    artifacts cycling them.  Returns (tenant directory, {tenant:
    decomposition}, {decomposition: artifact path})."""
    from repro_torch.hierarchy import save_hierarchy

    d = os.path.join(tmp, "tenants")
    own = os.path.join(tmp, "decompositions")
    os.makedirs(d)
    os.makedirs(own)
    src = {name: arts[name] for name in mt["reused"]}
    for name, h in hs.items():
        src[name] = os.path.join(own, f"{name}.npz")
        save_hierarchy(src[name], h)
    order = [mt["reused"][0], *hs, *mt["reused"][1:]]
    of = {}
    for i in range(mt["tenants"]):
        t = f"t{i:02d}"
        of[t] = order[i % len(order)]
        shutil.copyfile(src[of[t]], os.path.join(d, f"{t}.npz"))
    return d, of, src


def mt_oracle(svcs, of, t_col, ops, a, b):
    """Each slot answered by its decomposition's own ``HierarchyService``:
    one batched call per decomposition, not one per slot."""
    import numpy as np

    name = np.array([of[t] for t in t_col])
    want = np.full(len(t_col), -2, np.int32)
    for key, svc in svcs.items():
        m = name == key
        if m.any():
            want[m] = svc.query_batch(ops[m], a[m], b[m])
    return want


def mt_stream(mt, pool):
    """The in-process stream: segment k draws ``queries / segments``
    mixed queries (the CLI's seeded ``_mixed_workload``, seed k) over t00
    and ``window`` tenants starting at ``k * stride``.  ``pool`` has
    loaded every tenant once (it keeps an evicted tenant's dims)."""
    import numpy as np

    from repro_torch.launch.hserve import _mixed_workload

    tenants = sorted(pool.meta)
    rest = tenants[1:]
    n = mt["queries"] // mt["segments"]
    parts = []
    for k in range(mt["segments"]):
        window = [tenants[0]] + [rest[(k * mt["stride"] + j) % len(rest)]
                                 for j in range(mt["window"])]
        parts.append(_mixed_workload(pool, window, n, seed=k))
    t_col = [t for p in parts for t in p[0]]
    if set(t_col) != set(tenants):
        raise AssertionError("the stream misses tenants: "
                             f"{sorted(set(tenants) - set(t_col))}")
    return (t_col, *(np.concatenate([p[i] for p in parts])
                     for i in (1, 2, 3)))


def mt_serve(pool, stream, want, batch, pinned):
    """Serve ``stream`` through ``pool`` in ``batch``-query calls, every
    answer held to ``want``.  Chunk by chunk: the dispatch-signature
    count must equal the distinct (bucket, capacity) pairs dispatched
    since the count was reset (nothing else varies), so a cold load into
    a bucket that did not grow adds none, and ``pinned`` keeps its slot.
    (The dry-run holds such a load to the bucket's storage and uploads.)
    Returns the row (metrics of this run alone)."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.hierarchy import MultiTenantService, multiserve

    t_col, ops, a, b = stream
    pool.metrics = obs.MetricsRegistry()
    svc = MultiTenantService(pool, batch=batch)
    multiserve.reset_dispatch_count()
    before = pool.stats()
    pin_slot = pool.meta[pinned].slot
    seen = set()
    got = np.zeros(len(t_col), np.int32)
    cold_same = grew = 0
    sync(pool.device)
    t0 = time.perf_counter()
    for lo in range(0, len(t_col), batch):
        hi = min(lo + batch, len(t_col))
        caps = {k: bk.cap for k, bk in pool.buckets.items()}
        cold = {t for t in t_col[lo:hi] if not pool.resident(t)}
        got[lo:hi] = svc.query_batch(t_col[lo:hi], ops[lo:hi], a[lo:hi],
                                     b[lo:hi])
        keys = {pool.meta[t].bucket for t in set(t_col[lo:hi])}
        seen |= {(k, pool.buckets[k].cap) for k in keys}
        if multiserve.compiled_dispatch_count() != len(seen):
            raise AssertionError(
                f"{multiserve.compiled_dispatch_count()} dispatch "
                f"signatures for {len(seen)} (bucket, capacity) pairs")
        steady = {k for k, c in caps.items() if pool.buckets[k].cap == c}
        grew += len(caps) - len(steady)
        cold_same += sum(pool.meta[t].bucket in steady for t in cold)
        if not pool.resident(pinned) or pool.meta[pinned].slot != pin_slot:
            raise AssertionError(f"pinned {pinned} lost its slot")
    sync(pool.device)
    dt = time.perf_counter() - t0
    bad = np.flatnonzero(got != want)
    if bad.size:
        i = int(bad[0])
        raise AssertionError(
            f"batch {batch}: {bad.size} answers differ from the per-tenant "
            f"HierarchyService, first at {i}: tenant {t_col[i]} op "
            f"{int(ops[i])} a {int(a[i])} b {int(b[i])}: {int(got[i])} != "
            f"{int(want[i])}")
    snap = pool.metrics.snapshot()
    return dict(
        batch=batch, queries=len(t_col), seconds=round(dt, 4),
        qps=round(len(t_col) / dt, 1), dispatches=svc.dispatches,
        slots_padded=snap["serve.slots_padded"]["value"],
        signatures=multiserve.compiled_dispatch_count(),
        buckets=len(pool.buckets), grown=grew,
        cold_same_bucket_loads=cold_same,
        dispatch_ms=hist_row(pool.metrics, "serve.dispatch_ms"),
        load_ms=hist_row(pool.metrics, "pool.load_ms"),
        stats={k: pool.stats()[k] - before[k]
               for k in ("hits", "misses", "evictions")})


def hist_row(metrics, name) -> dict:
    """Count, p50, p99 and mean of a latency histogram (count 0 before
    its first sample)."""
    h = metrics.get(name)
    if h is None:
        return dict(count=0)
    s = h.snapshot()
    return {k: s[k] for k in ("count", "p50_ms", "p99_ms", "mean_ms")}


def mt_upload_ab(mt, tenant_dir, svcs, of, dev) -> dict:
    """The ``slot_upload`` A/B: in each mode a pool warms the first
    ``slots`` tenants and dispatches once for each (every bucket on the
    device), then admits the other tenants one at a time, each by one
    query (a cold load and an eviction).  Per admission the slot mode
    copies one slot row (``pool.admission_upload_ms``), the bucket mode
    re-uploads the bucket at the next dispatch
    (``pool.bucket_upload_ms``).  Every answer held to the oracle."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.hierarchy import ForestPool, MultiTenantService

    tenants = sorted(of)
    one = np.zeros(1, np.int32)
    out = {}
    for mode, su in (("slot", True), ("bucket", False)):
        pool = ForestPool(slots=mt["slots"], artifact_dir=tenant_dir,
                          slot_upload=su, device=dev)
        pool.pin(tenants[0])
        svc = MultiTenantService(pool, batch=mt["batches"][0])
        for t in tenants[:mt["slots"]]:
            svc.query_batch([t], one, one)
        pool.metrics = svc.metrics = obs.MetricsRegistry()
        for t in tenants[mt["slots"]:]:
            got = svc.query_batch([t], one, one)
            want = svcs[of[t]].query_batch(one, one)
            expect(f"upload A/B {mode}", f"{t} max_k(0)", int(got[0]),
                   int(want[0]))
        out[mode] = {name: hist_row(pool.metrics, f"pool.{name}")
                     for name in ("admission_upload_ms", "bucket_upload_ms",
                                  "load_ms")}
    return out


def mt_single_tenant(svc, queries, batch) -> float:
    """q/s of one ``HierarchyService`` answering ``queries`` mixed
    queries (``query_batch_inputs``, seed 0) ``batch`` at a time."""
    f = svc.forest
    ops, a, b = query_batch_inputs(f.n_entities, f.n_nodes, queries, 0)
    sync(f.device)
    t0 = time.perf_counter()
    for lo in range(0, queries, batch):
        svc.query_batch(ops[lo:lo + batch], a[lo:lo + batch],
                        b[lo:lo + batch])
    sync(f.device)
    return round(queries / (time.perf_counter() - t0), 1)


def hserve_process(argv, timeout=900):
    """``python -m repro_torch.launch.hserve ARGV`` in its own process;
    returns (stdout, seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hserve", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"launch.hserve {' '.join(argv)} failed (rc "
                             f"{out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("[hserve"):
            log(f"[smoke]   {line}")
    return out.stdout, round(dt, 3)


def mt_cli(mt, tenant_dir, pool, svcs, of, dev, tmp) -> dict:
    """The CLI in its own process at ``--pool-slots`` tenants; its answer
    checksum held to the oracle on the same seeded workload (drawn over
    ``pool``'s tenant dims), its metrics snapshot and trace read back."""
    import numpy as np

    from repro_torch.launch.hserve import _mixed_workload

    paths = {k: os.path.join(tmp, f"hserve_{k}.json")
             for k in ("out", "metrics", "trace")}
    _, dt = hserve_process(
        ["--artifact-dir", tenant_dir, "--pool-slots", str(mt["slots"]),
         "--batch", str(mt["cli_batch"]), "--queries",
         str(mt["cli_queries"]), "--device", dev,
         *(x for k, p in paths.items() for x in (f"--{k}", p))])
    with open(paths["out"]) as f:
        out = json.load(f)
    with open(paths["metrics"]) as f:
        snap = json.load(f)
    with open(paths["trace"]) as f:
        events = json.load(f)["traceEvents"]
    warm = sorted(of)[:mt["slots"]]
    t_col, ops, a, b = _mixed_workload(pool, warm, mt["cli_queries"])
    want = int(mt_oracle(svcs, of, t_col, ops, a, b).astype(np.int64).sum())
    expect("hserve CLI", "served, tenants, checksum",
           (out["served"], out["n_tenants"], out["answers_checksum"]),
           (mt["cli_queries"], mt["slots"], want))
    spans = sum(e["name"] == "serve.dispatch" for e in events)
    expect("hserve CLI", "serve.dispatch spans",
           spans, snap["serve.dispatches"]["value"])
    return dict(seconds=dt, qps=round(out["qps"], 1),
                dispatches=snap["serve.dispatches"]["value"],
                dispatch_ms={k: snap["serve.dispatch_ms"][k]
                             for k in ("count", "p50_ms", "p99_ms")},
                trace_events=len(events),
                stats={k: out[k] for k in ("hits", "misses", "evictions",
                                           "resident")})


def phase_multitenant(golden, arts, dev, tmp, smi, mt=MT) -> dict:
    """Phase 11: tenants peeled on the card, laid out as ``mt["tenants"]``
    artifacts, then served: the golden's small fixed set, the in-process
    stream at each batch size, the upload A/B, a single-tenant yardstick,
    the CLI and its dry-run.  Returns the numbers and the launch counts
    of the peels."""
    from repro_torch.hierarchy import (ForestPool, HierarchyService,
                                       load_hierarchy)

    info = dict(golden=multiserve_golden(golden, dev, tmp))
    log(f"[smoke]   multiserve golden: {golden['recipe']['tenants']} "
        f"tenants, {len(golden['buckets'])} buckets, stats, dispatch "
        f"signatures ({golden['compiled_dispatch_count']}) and the answers' "
        f"sha256 equal the JAX package's")
    hs, counts, dt, plain_dt = mt_peel(mt, dev)
    info.update(peel_seconds=round(dt, 3), plain_peel_seconds=round(
        plain_dt, 3), launches={k: v for k, v in counts.items() if v})
    log(f"[smoke]   {len(hs)} tenant graphs peeled (csr, fused FD, P="
        f"{mt['P']}) and built on {dev} in {dt:.2f} s; launches "
        f"{info['launches']}; θ and stats equal to the plain rounds' peels "
        f"on the CPU ({plain_dt:.2f} s)")
    tenant_dir, of, src = mt_layout(mt, hs, arts, tmp)
    svcs = {name: HierarchyService(load_hierarchy(path), device=dev)
            for name, path in src.items()}
    pinned = sorted(of)[0]
    pool = ForestPool(slots=mt["slots"], artifact_dir=tenant_dir, device=dev)
    pool.pin(pinned)
    for t in sorted(of):                    # every tenant's dims, on the host
        pool.ensure(t)
    stream = mt_stream(mt, pool)
    want = mt_oracle(svcs, of, *stream)
    rows = []
    for batch in mt["batches"]:
        # the first batch size starts the pool cold; the next finds it warm
        rows.append(mt_serve(pool, stream, want, batch, pinned))
        r = rows[-1]
        log(f"[smoke]   {len(of)} tenants ({len(src)} decompositions, "
            f"{r['buckets']} buckets), {mt['slots']} slots, batch {batch}: "
            f"{r['queries']} queries in {r['seconds']:.3f} s = {r['qps']:.0f}"
            f" q/s ({smi}); all equal to the per-tenant HierarchyService; "
            f"{r['dispatches']} dispatches, {r['slots_padded']} padded "
            f"slots; serve.dispatch_ms {r['dispatch_ms']}; pool.load_ms "
            f"{r['load_ms']}; {r['signatures']} dispatch signatures "
            f"({r['grown']} capacity steps), "
            f"{r['cold_same_bucket_loads']} cold same-bucket loads added "
            f"none; cache {r['stats']}")
    info["serve"] = rows
    if rows[-1]["signatures"] != rows[-1]["buckets"]:
        raise AssertionError(f"{rows[-1]['signatures']} dispatch signatures "
                             f"on the warm pool for {rows[-1]['buckets']} "
                             f"buckets")
    info["upload_ab"] = mt_upload_ab(mt, tenant_dir, svcs, of, dev)
    log(f"[smoke]   slot_upload A/B {info['upload_ab']} ({smi})")
    info["single_tenant_qps"] = {
        batch: mt_single_tenant(
            HierarchyService(svcs[of[pinned]].forest, batch=batch),
            mt["queries"], batch)
        for batch in mt["batches"]}
    log(f"[smoke]   yardstick: one HierarchyService on {of[pinned]}, "
        f"{mt['queries']} queries: q/s by batch "
        f"{info['single_tenant_qps']} ({smi})")
    info["cli"] = mt_cli(mt, tenant_dir, pool, svcs, of, dev, tmp)
    log(f"[smoke]   hserve CLI: {mt['cli_queries']} queries at batch "
        f"{mt['cli_batch']}, checksum equal to the oracle's: "
        f"{info['cli']} ({smi})")
    _, info["dryrun_s"] = hserve_process(["--dryrun", "--device", dev])
    return info


# ---------------------------------------------------------------------
# phase 12: the distributed peel (torch.distributed)
# ---------------------------------------------------------------------
# the 60k graph's four-rank CLI runs: (label, CLI flags); each is held to
# the world-1 run of the same kind
DIST_CLI = (("wing", ["--kind", "wing", "--engine", "csr"]),
            ("tip", ["--kind", "tip"]))


def dist_run(label, fn, g, mesh, axis, kw, want_theta, per_round, dev,
             dense=False, vmapped=False) -> dict:
    """One world-1 distributed decomposition with the obs layer on (for
    the ``cd.round`` span seconds): θ's sha256 held to the golden, the
    collectives counted (``per_round`` a CD round, the dense recount 3
    a round and 3 at ⋈init; none in FD; one result gather, none for the
    vmapped tip FD) and the kernel launches counted: none (the BE-Index
    build is torch ops and the distributed bodies are segment sums, as
    the JAX package's).  Returns θ, stats, the PeelResult and the
    seconds."""
    from repro_torch import obs
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    D.reset_collective_counts()
    tracer = obs.enable()
    try:
        t0 = time.perf_counter()
        theta, stats, res = fn(g, mesh, axis=axis, **kw, return_result=True)
        sync(dev)
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    expect(label, "theta sha256", sha_int64(theta), want_theta)
    rho = stats["rho_cd"]
    expect(label, "collectives", D.collective_counts(), dict(
        cd=3 * (rho + 1) if dense else per_round * rho, fd=0,
        result=0 if vmapped else 1))
    expect(label, "kernel launches", ops.launch_counts(),
           dict.fromkeys(ops.KERNELS, 0))
    expect(label, "cd.round spans", tracer.count("cd.round", ph="X"), rho)
    secs = dict(total=round(dt, 3),
                **{k: round(v, 3) for k, v in res.seconds.items()},
                cd_round=round(sum(e["dur"] for e in tracer.spans(
                    "cd.round", ph="X")) / 1e6, 3))
    log(f"[smoke]   {label}: θ equals its golden; rho_cd {rho}, "
        f"rho_fd_max {stats['rho_fd_max']}, collectives "
        f"{D.collective_counts()}; seconds {secs}")
    return dict(theta=theta, stats=stats, res=res, seconds=secs, rho_cd=rho)


def dist_cli(label, flags, graph, want, tmp) -> dict:
    """The peel CLI's ``run`` on four gloo ranks sharing the card
    (``torch.distributed.run``, ``distributed_replay.py --graph``): θ,
    every stat but n_dev, and the artifact's partition, ranges and ⋈init
    equal to the world-1 run ``want``; rank 0's ``--trace`` gives the
    CD rounds' seconds.  Returns the seconds and the span split."""
    import numpy as np

    from repro_torch.hierarchy import load_hierarchy

    out = os.path.join(tmp, f"dist4-{label}.json")
    art = os.path.join(tmp, f"dist4-{label}.npz")
    trace = os.path.join(tmp, f"dist4-{label}.trace.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4",
         os.path.join(ROOT, "tests", "goldens", "distributed_replay.py"),
         "--graph", *(str(graph[k]) for k in ("n_u", "n_v", "m", "alpha",
                                             "seed")),
         *flags, "--aligned", "--parts", "16", "--backend", "gloo",
         "--device", "cuda", "--out", out, "--emit-hierarchy", art,
         "--trace", trace],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"4-rank {label} failed (rc {p.returncode}): "
                             f"{p.stdout[-2000:]}{p.stderr[-3000:]}")
    with open(out) as f:
        got = json.load(f)
    name = f"4 gloo ranks, {label}"
    expect(name, "theta", got["theta"], np.asarray(want["theta"]).tolist())
    drop = ("n_dev", "timeline", "theta_sha256")
    expect(name, "stats", {k: v for k, v in got["stats"].items()
                           if k not in drop},
           {k: v for k, v in want["stats"].items() if k not in drop})
    expect(name, "n_dev", got["stats"]["n_dev"], 4)
    h = load_hierarchy(art)
    for key in ("part", "ranges", "support_init"):
        expect(name, key, np.asarray(h.meta[key]).tolist(),
               np.asarray(getattr(want["res"], key)).tolist())
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    secs = {cat: round(sum(e["dur"] for e in events if e.get("cat") == cat
                           and e.get("ph") == "X") / 1e6, 4)
            for cat in ("cd", "cd.round", "fd")}
    n_rounds = sum(1 for e in events
                   if e.get("cat") == "cd.round" and e.get("ph") == "X")
    expect(name, "cd.round spans", n_rounds, got["stats"]["rho_cd"])
    info = dict(seconds=round(dt, 3), span_seconds=secs,
                cd_round_ms=round(1e3 * secs["cd.round"] / max(n_rounds, 1),
                                  3))
    log(f"[smoke]   {name} (CLI, gloo on one card, --trace): θ, stats, "
        f"partition, ranges and ⋈init equal the world-1 run; {info}")
    return info


def dist_dryrun() -> float:
    """``python -m repro_torch.launch.peel --dryrun`` in its own process
    (CPU, a 512-rank fake process group); returns its seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.peel", "--dryrun"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if p.returncode != 0 or "all structural checks passed" not in p.stdout:
        raise AssertionError(f"launch.peel --dryrun failed (rc "
                             f"{p.returncode}): {p.stdout[-2000:]}"
                             f"{p.stderr[-3000:]}")
    for line in p.stdout.splitlines():
        log(f"[smoke]   {line}")
    return round(dt, 3)


def edge_butterflies_route(wed, dev, launches) -> dict:
    """``csr.edge_butterflies_csr`` through ``wedge_count``
    (``use_pallas``) on the 60k graph's wedge list, all alive and under
    a seeded alive mask: ``torch.equal`` to the plain route (and, all
    alive, to ``edge_butterflies0``); the kernel must launch."""
    import numpy as np
    import torch

    from repro_torch.core import csr
    from repro_torch.kernels import ops

    rng = np.random.default_rng(12)
    info = {}
    for label, alive in (("all alive", None), ("seeded mask", torch.from_numpy(
            rng.random(wed.m) > 0.3).to(dev))):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = csr.edge_butterflies_csr(wed, alive, use_pallas=True,
                                       device=dev)
        sync(dev)
        t1 = time.perf_counter()
        counts = ops.launch_counts()
        if counts["wedge_count"] == 0:
            raise AssertionError("edge_butterflies_csr(use_pallas=True) "
                                 "launched no wedge_count")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        want = csr.edge_butterflies_csr(wed, alive, device=dev)
        sync(dev)
        t2 = time.perf_counter()
        if not torch.equal(got, want):
            raise AssertionError(f"edge_butterflies_csr {label}: the "
                                 "wedge_count route differs from the plain")
        if alive is None and not np.array_equal(got.cpu().numpy(),
                                                csr.edge_butterflies0(wed)):
            raise AssertionError("edge_butterflies_csr != edge_butterflies0")
        info[label] = dict(kernel_route_s=round(t1 - t0, 4),
                           plain_route_s=round(t2 - t1, 4),
                           wedge_count=counts["wedge_count"])
        log(f"[smoke]   edge_butterflies_csr ({label}, {wed.n_wedges} "
            f"wedges): wedge_count route equals the plain route; "
            f"{info[label]}")
    return info


def phase_distributed(fullsize, engines, large, dev, tmp, launches) -> dict:
    """World 1 on NCCL, in this process: every small golden cell, then
    the large tip graph (``large``: phase 10's ``STREAM_LARGE`` and the
    θ sha256 of its single-device initial peel), the 60k graph (wing csr
    and beindex, tip device and vmapped, the (1, 1) mesh) and dense-16k,
    each held to its θ; the 60k graph on four gloo ranks sharing the
    card, held to world 1; the 512-rank dry-run;
    ``edge_butterflies_csr``'s kernel route."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import csr
    from repro_torch.core import distributed as D
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.launch.mesh import make_peel_mesh, make_peel_mesh_2d

    rp = load_module("distributed_replay", os.path.join(
        ROOT, "tests", "goldens", "distributed_replay.py"))
    info: dict = {}
    gl = powerlaw_bipartite(**large["graph"])
    g60 = powerlaw_bipartite(**fullsize["wing-60k"]["graph"])
    g16 = powerlaw_bipartite(**engines["dense-16k"]["graph"])
    for name, g, sha in (("wing-60k", g60, fullsize["wing-60k"]),
                         ("dense-16k", g16, engines["dense-16k"])):
        expect(name, "edges sha256", cli_sha(g), sha["edges_sha256"])
    wing, tip = D.distributed_wing_decomposition, D.distributed_tip_decomposition
    th = dict(large=large["theta_sha256"],
              wing60=fullsize["wing-60k"]["theta_sha256"],
              tip60=fullsize["tip-60k"]["theta_sha256"],
              dense16=engines["dense-16k"]["dense"]["theta_sha256"])

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_peel_mesh(device="cuda")
        mesh2 = make_peel_mesh_2d(device="cuda")
        golden = rp.load_golden()
        t0 = time.perf_counter()
        cells = rp.replay(golden, mesh, "peel")
        for key, want in golden["results"].items():
            for f in ("theta", "part", "ranges", "support_init", "stats"):
                expect(f"golden cell {key}", f, cells[key][f], want[f])
        info["golden_cells_s"] = round(time.perf_counter() - t0, 3)
        log(f"[smoke]   {len(cells)} golden cells on NCCL, world 1: θ, "
            f"part, ranges, ⋈init and stats equal the JAX package's "
            f"(8 devices) in {info['golden_cells_s']:.1f} s")

        runs = {}
        runs[f"{large['name']} csr aligned"] = dist_run(
            f"{large['name']} csr aligned (θ of the stream's initial peel)",
            tip, gl, mesh, "peel",
            dict(P_parts=large["P"], engine="csr", aligned=True),
            th["large"], 1, dev)
        runs["wing-60k csr pair_aligned"] = dist_run(
            "wing-60k csr pair_aligned", wing, g60, mesh, "peel",
            dict(P_parts=16, engine="csr", pair_aligned=True), th["wing60"],
            1, dev)
        runs["wing-60k beindex bloom_aligned"] = dist_run(
            "wing-60k beindex bloom_aligned", wing, g60, mesh, "peel",
            dict(P_parts=16, engine="beindex", bloom_aligned=True),
            th["wing60"], 1, dev)
        runs["wing-60k csr pair_aligned (1, 1) mesh"] = r2 = dist_run(
            "wing-60k csr pair_aligned (1, 1) mesh", wing, g60, mesh2,
            ("grp", "loc"), dict(P_parts=16, engine="csr",
                                 pair_aligned=True), th["wing60"], 2, dev)
        r1 = runs["wing-60k csr pair_aligned"]
        for key in ("part", "ranges", "support_init"):
            expect("(1, 1) mesh", key,
                   sha_int64(getattr(r2["res"], key)),
                   sha_int64(getattr(r1["res"], key)))
        expect("(1, 1) mesh", "stats", r2["stats"], r1["stats"])
        runs["tip-60k csr aligned"] = dist_run(
            "tip-60k csr aligned", tip, g60, mesh, "peel",
            dict(P_parts=16, engine="csr", aligned=True), th["tip60"], 1,
            dev)
        runs["tip-60k csr aligned vmapped"] = dist_run(
            "tip-60k csr aligned vmapped", tip, g60, mesh, "peel",
            dict(P_parts=16, engine="csr", aligned=True,
                 fd_driver="vmapped"), th["tip60"], 1, dev, vmapped=True)
        runs["dense-16k"] = dist_run(
            "dense-16k", tip, g16, mesh, "peel",
            dict(P_parts=16, engine="dense"), th["dense16"], 0, dev,
            dense=True)
        # what one large-graph CD round's reduction costs next to the
        # round's device→host support copy
        x = torch.zeros((gl.n_u + 1,), dtype=torch.int32, device=dev)
        grp = mesh.get_group("peel")
        t0 = time.perf_counter()
        for _ in range(200):
            x.cpu()
        info["support_copy_ms"] = round(
            (time.perf_counter() - t0) / 200 * 1e3, 4)
        info["all_reduce_ms"] = round(cuda_ms(
            lambda: dist.all_reduce(x, group=grp), 200), 4)
        log(f"[smoke]   NCCL world 1, one int32 all_reduce of "
            f"{large['name']}'s {x.numel()} supports: {info['all_reduce_ms']} ms (device); "
            f"its copy to the host {info['support_copy_ms']} ms (host "
            "clock)")
    finally:
        dist.destroy_process_group()
    info["world1"] = {k: dict(rho_cd=v["rho_cd"], seconds=v["seconds"])
                      for k, v in runs.items()}

    graph60 = fullsize["wing-60k"]["graph"]
    info["four_ranks"] = {
        label: dist_cli(label, flags, graph60, runs[
            "wing-60k csr pair_aligned" if label == "wing"
            else "tip-60k csr aligned"], tmp)
        for label, flags in DIST_CLI}
    info["dryrun_s"] = dist_dryrun()
    info["edge_butterflies_csr"] = edge_butterflies_route(
        csr.build_wedges(g60), dev, launches)
    return info



# ---------------------------------------------------------------------
# phase 13: training (dense family) and the PBNG → LM bridge
# ---------------------------------------------------------------------
# the CLI's full-width run (TinyLlama-1.1B as published, f32, default
# remat), the depth of the gradient check, the crash/resume run, the
# curriculum on the 60k graph (examples/graph_curriculum.py's recipe) and
# a router of DeepSeek-V2's shape (160 routed experts, top-6) over b 32 ×
# s 2 048 tokens
TRAIN = dict(
    cli=["--arch", "tinyllama_1_1b", "--steps", "8", "--batch", "4",
         "--seq", "2048", "--log-every", "1"],
    grad=dict(arch="tinyllama_1_1b", overrides=dict(n_layers=2), batch=4,
              seq=2048),
    resume=["--arch", "tinyllama_1_1b", "--reduced", "--steps", "30",
            "--batch", "4", "--seq", "32", "--ckpt-every", "10",
            "--log-every", "5"],
    crash_at=15, resumed_at=10,
    curriculum=dict(graph="wing-60k", n_levels=4, P=8, max_len=32, batch=16,
                    n_layers=2, lr=1e-2),
    moe=dict(experts=160, top_k=6, tokens=32 * 2048, width=64, P=8, seed=0),
)
# relative L2 of a gradient leaf through the kernel route against torch
# autograd through the plain version: the f32 forward's gate is 1e-4 a
# row (ATTN_ROW_RTOL), the backward the same torch ops on both routes
TRAIN_GRAD_RTOL = 1e-4
# a kernel of a profiled step: its class by name (cuBLAS / CUTLASS GEMMs;
# the port's flash_attention kernels and their split_kv pre-pass)
GEMM_NAMES = ("gemm", "cutlass", "xmma", "gemv")
ATTN_NAMES = ("flash_attention_kernel", "flash_tc_kernel",
              "flash_tf32_kernel", "split_kv_kernel")


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in name for k in ATTN_NAMES):
        return "attention_kernel"
    if any(k in low for k in GEMM_NAMES):
        return "gemm"
    return "rest"


def _range_kernels(events, name):
    """(kernel name, µs) of every kernel launched from inside the CPU
    ranges called ``name`` (``record_function`` labels), children
    included."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for ch in e.cpu_children:
            walk(ch)
    for e in events:
        if e.name == name and e.device_type == e.device_type.CPU:
            walk(e)
    return out


def step_device_split(events, wall_ms) -> dict:
    """One profiled train step's device ms by class: the attention
    kernel (the port's flash_attention and split_kv kernels, by name), the
    attention backward (kernels under ``flash_attention.backward``), the
    optimizer (under ``adamw_update``), the GEMMs outside those two, and
    the rest; with the step's host-clock ms and the device's busy share.
    None where the profiler saw no device time (not measured)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # device events less the device-side copies of the record_function
    # labels (they span the kernels they hold)
    kernels = [(e.name, e.self_device_time_total) for e in events
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
    total = sum(us for _, us in kernels)
    if total == 0:
        return dict(device_ms=None)
    bwd = _range_kernels(events, "flash_attention.backward")
    opt = _range_kernels(events, "adamw_update")
    inside = {}
    for name, us in bwd + opt:
        inside[kernel_class(name)] = inside.get(kernel_class(name), 0) + us
    by_name = {}
    for name, us in kernels:
        c = kernel_class(name)
        by_name[c] = by_name.get(c, 0) + us
    split = dict(
        attention_kernel=by_name.get("attention_kernel", 0)
        - inside.get("attention_kernel", 0),
        attention_backward=sum(us for _, us in bwd),
        optimizer=sum(us for _, us in opt),
        gemm=by_name.get("gemm", 0) - inside.get("gemm", 0))
    split["rest"] = total - sum(split.values())
    top = {}
    for name, us in kernels:
        top[name[:70]] = top.get(name[:70], 0) + us
    return dict(device_ms=total / 1e3, wall_ms=wall_ms,
                busy_share=total / 1e3 / wall_ms,
                split_ms={k: v / 1e3 for k, v in split.items()},
                top_kernels_ms={k: v / 1e3 for k, v in sorted(
                    top.items(), key=lambda kv: -kv[1])[:8]})


def profile_train_step(cfg, dev, batch_size, seq) -> dict:
    """One full-width train step under ``torch.profiler`` (CPU and CUDA
    activity), after a warm step, on fresh weights; its device split."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step)

    if torch.device(dev).type != "cuda":  # a CPU rehearsal has no kernels
        return dict(device_ms=None)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(lr=3e-3)))
    data = synthetic_batches(DataConfig(batch=batch_size, seq=seq,
                                        vocab=cfg.vocab, seed=1))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
               for _ in range(2)]
    params, opt, _ = step(params, opt, batches[0])
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[1])
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = step_device_split(prof.events(), wall_ms)
    if out["device_ms"] is None:
        log("[smoke]   train step profile: the profiler saw no device time "
            "(not measured)")
    return out


def attention_backward_ms(cfg, batch, seq, dev, reps=5) -> dict:
    """CUDA-event ms of one layer's attention at the training shape:
    the kernel forward and ``attention_backward`` (its torch ops), on
    seeded inputs."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    if torch.device(dev).type != "cuda":
        return {}
    gen = torch.Generator(device=dev).manual_seed(2)
    hd = cfg.resolved_head_dim
    q = torch.randn((batch, cfg.n_heads, seq, hd), generator=gen, device=dev)
    k, v = (torch.randn((batch, cfg.n_kv_heads, seq, hd), generator=gen,
                        device=dev) for _ in range(2))
    scale = hd ** -0.5
    out = fa.flash_attention(q, k, v, True, scale, 0)
    dout = torch.randn(out.shape, generator=gen, device=dev)
    return dict(
        forward_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, True, scale,
                                                      0), reps),
        backward_ms=cuda_ms(lambda: fa.attention_backward(
            q, k, v, out, dout, True, scale, 0), reps))


def train_cli(argv, dev, launches) -> dict:
    """``repro_torch.launch.train``'s run in this process (the CLI's
    ``train``; the card's memory is its own): launch counts zeroed just
    before and read just after, the peak allocated memory, the losses
    and step seconds.  Gates: every loss finite, the last three steps'
    mean below the first step's, two ``flash_attention`` launches a layer
    and step (the forward and the full-remat recompute); and that it
    learned: the loss on a held-out batch (the one the step after the
    last would see) lower with the run's last weights than with its
    first (drawn again from ``--seed``), and every leaf moved by a
    finite, non-zero amount."""
    import math

    import numpy as np
    import torch

    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import init_params, train_loss
    from repro_torch.train.tree import tree_leaves

    args = T.parse_args([*argv, "--device", dev])
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = T.train(args)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() if torch.device(dev).type ==
            "cuda" else None)
    cfg, last = rec["cfg"], rec.pop("params")
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train CLI: a loss is not finite: {losses}")
    want = (2 * cfg.n_layers * len(losses) if torch.device(dev).type ==
            "cuda" else 0)
    expect("train CLI", "flash_attention launches",
           counts["flash_attention"], want)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    first = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    held = {k: torch.from_numpy(v).to(dev) for k, v in next(synthetic_batches(
        DataConfig(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                   seed=args.seed), start_step=args.steps)).items()}
    with torch.no_grad():
        held_before = float(train_loss(first, held, cfg))
        held_after = float(train_loss(last, held, cfg))
        moved = [float((b - a).norm()) for a, b in zip(tree_leaves(first),
                                                       tree_leaves(last))]
    del first, last
    if not held_after < held_before:
        raise AssertionError(f"train CLI: the held-out batch's loss did not "
                             f"fall ({held_before} -> {held_after})")
    if not all(math.isfinite(x) and x > 0 for x in moved):
        raise AssertionError(f"train CLI: a leaf did not move by a finite, "
                             f"non-zero amount: {moved}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train CLI: the loss did not fall: {losses}")
    secs = rec["step_seconds"]
    tokens = args.batch * args.seq
    steady = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    return dict(seconds=round(dt, 3), losses=losses,
                step_seconds=[round(x, 4) for x in secs],
                steady_step_s=steady, tokens_per_s=tokens / steady,
                max_memory_allocated=peak,
                flash_attention_launches=counts["flash_attention"],
                held_out_loss=[held_before, held_after],
                min_leaf_move=min(moved))


def kernel_route_grads(label, cfg, params, batch, dev) -> dict:
    """Every leaf's gradient of ``train_loss`` on ``batch`` through the
    kernel route (``FlashAttention``, the kernel forward) against torch
    autograd through the plain version (``ref.flash_attention_ref``, in
    place of the kernel for the second run), both on ``dev``; relative
    L2 per leaf within ``TRAIN_GRAD_RTOL``.  Its launches are counted
    here only, not on the main path's count."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers, train_loss
    from repro_torch.train.tree import tree_leaves, tree_map

    def grads():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = train_loss(leaves, batch, cfg)
        return loss.item(), torch.autograd.grad(loss, tree_leaves(leaves))

    ops.reset_launch_counts()
    loss_k, g_k = grads()
    n = ops.launch_counts()["flash_attention"]
    plain = lambda q, k, v, causal=True, offset=None: ref.flash_attention_ref(
        q, k, v, causal=causal, offset=offset)
    with mock.patch.object(layers.ops, "flash_attention", plain):
        loss_p, g_p = grads()
    worst = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_k, g_p))
    if torch.device(dev).type == "cuda":
        expect(label, "flash_attention launches", n, 2 * cfg.n_layers)
    if not worst <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"{label}: a leaf's relative L2 {worst} > "
                             f"{TRAIN_GRAD_RTOL} against plain autograd")
    return dict(worst_rel_l2=worst, loss_kernel=loss_k, loss_plain=loss_p,
                leaves=len(g_k), launches=n,
                tokens_shape=list(batch["tokens"].shape))


def train_grads_check(spec, dev) -> dict:
    """``kernel_route_grads`` at full width and the depth of
    ``spec["overrides"]``, on one seeded batch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(spec["arch"]), max_seq=spec["seq"],
                              **spec["overrides"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), dev)
    data = synthetic_batches(DataConfig(batch=spec["batch"], seq=spec["seq"],
                                        vocab=cfg.vocab, seed=3))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    return kernel_route_grads("train grads", cfg, params, batch, dev)


def train_resume(argv, crash_at, resumed_at, dev, tmp) -> dict:
    """``python -m repro_torch.launch.train`` in its own processes, as
    ``tests/test_train.py`` runs the JAX CLI: with ``--crash-at`` it exits
    42 with the checkpoint of ``resumed_at`` the latest; rerun, it prints
    ``resumed from step`` and ends at the last step."""
    from repro_torch.train import latest_step

    ckpt = os.path.join(tmp, "train-ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    args = [sys.executable, "-m", "repro_torch.launch.train", *argv,
            "--ckpt-dir", ckpt, "--device", dev]
    steps = int(argv[argv.index("--steps") + 1])
    t0 = time.perf_counter()
    out1 = subprocess.run(args + ["--crash-at", str(crash_at)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    t1 = time.perf_counter()
    expect("train crash", "exit code", out1.returncode, 42)
    expect("train crash", "latest step", latest_step(ckpt), resumed_at)
    out2 = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    t2 = time.perf_counter()
    if out2.returncode != 0:
        raise AssertionError(f"train resume failed (rc {out2.returncode}): "
                             f"{out2.stdout[-2000:]}{out2.stderr[-3000:]}")
    expect("train resume", "resumed line",
           f"resumed from step {resumed_at}" in out2.stdout, True)
    expect("train resume", "latest step", latest_step(ckpt), steps)
    done = [ln for ln in out2.stdout.splitlines() if "done: loss" in ln]
    log(f"[smoke]   crash at {crash_at}: exit 42, latest {resumed_at}; "
        f"resumed: {done[-1] if done else out2.stdout[-200:]}")
    return dict(crash_s=round(t1 - t0, 3), resume_s=round(t2 - t1, 3))


def train_curriculum(fullsize, spec, dev, launches) -> dict:
    """The PBNG → LM bridge on the card (``examples/graph_curriculum.py``
    on the 60k graph): θ of the wing peel held to the golden, the levels
    of ``interaction_curriculum`` to θ's quantile buckets, every
    interaction in exactly one of ``curriculum_sequences``' sequences,
    the kernel route's gradients on the epoch's first batch against plain
    autograd (``kernel_route_grads``), then one epoch of a reduced
    TinyLlama over the node vocabulary; the loss must fall (the last ten
    steps' mean below the first ten's)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.analysis import (curriculum_levels,
                                           interaction_curriculum)
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.core.peel import wing_decomposition
    from repro_torch.data import curriculum_sequences, sequence_batches
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, reduced
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step)

    want = fullsize[spec["graph"]]
    g = powerlaw_bipartite(**want["graph"])
    t0 = time.perf_counter()
    theta = wing_decomposition(g, P=spec["P"], engine="beindex",
                               device=dev).theta
    expect("curriculum", "theta sha256", sha_int64(theta),
           want["theta_sha256"])
    t1 = time.perf_counter()
    level, bounds = interaction_curriculum(g, spec["n_levels"], spec["P"],
                                           device=dev)
    want_level, want_bounds = curriculum_levels(theta, spec["n_levels"])
    expect("curriculum", "levels", sha_int64(level), sha_int64(want_level))
    expect("curriculum", "bounds", bounds.tolist(), want_bounds.tolist())
    t2 = time.perf_counter()
    seqs = curriculum_sequences(g, spec["n_levels"], spec["P"],
                                spec["max_len"], device=dev)
    t3 = time.perf_counter()
    pairs = np.concatenate([np.stack([np.full(s.size - 1, s[0]),
                                      s[1:] - g.n_u], 1) for s in seqs])
    expect("curriculum", "interactions",
           sha_int64(pairs[np.lexsort(pairs.T[::-1])]),
           sha_int64(g.edges[np.lexsort(g.edges.T[::-1])]))
    cfg = reduced(get_config("tinyllama_1_1b"), vocab=g.n_u + g.n_v,
                  n_layers=spec["n_layers"], max_seq=spec["max_len"])
    batches = list(sequence_batches(seqs, spec["batch"], spec["max_len"] - 1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # the epoch's attention shape (S = max_len - 1, not a whole tile):
    # the kernel route's gradients against plain autograd on its first
    # batch, before the epoch's launches are counted
    grads = kernel_route_grads(
        "curriculum grads", cfg, params,
        {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}, dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=spec["lr"], total_steps=len(batches))))
    ops.reset_launch_counts()
    losses = []
    t4 = time.perf_counter()
    for batch in batches:
        params, opt, m = step(params, opt, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    t5 = time.perf_counter()
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError(f"curriculum: the loss did not fall "
                             f"({first} -> {last})")
    info = dict(sequences=len(seqs), steps=len(batches),
                levels=np.bincount(level, minlength=spec["n_levels"]).tolist(),
                bounds=bounds.tolist(), loss_first10=first, loss_last10=last,
                peel_s=round(t1 - t0, 3), curriculum_s=round(t2 - t1, 3),
                sequences_s=round(t3 - t2, 3), epoch_s=round(t5 - t4, 3),
                step_ms=round((t5 - t4) / len(batches) * 1e3, 3),
                flash_attention_launches=counts["flash_attention"],
                grads=grads)
    log(f"[smoke]   curriculum on the 60k graph ({dev}): θ equals the "
        f"golden; levels {info['levels']}, bounds {info['bounds']}; "
        f"{len(seqs)} sequences hold each of the {g.m} interactions once; "
        f"{len(batches)} steps of a reduced TinyLlama (vocab {cfg.vocab}), "
        f"loss {first:.4f} -> {last:.4f}; {info}")
    return info


def moe_router(spec):
    """A seeded top-k router: (tokens, k) expert ids of the largest
    logits of token features · a gate, plus a per-expert skew."""
    import numpy as np

    rng = np.random.default_rng(spec["seed"])
    h = rng.standard_normal((spec["tokens"], spec["width"]), np.float32)
    w = rng.standard_normal((spec["width"], spec["experts"]), np.float32)
    logits = h @ w + np.linspace(0.0, 2.0, spec["experts"], dtype=np.float32)
    return np.argpartition(-logits, spec["top_k"], axis=1)[:, :spec["top_k"]]


def train_moe(spec, dev) -> dict:
    """``moe_affinity`` of a router with DeepSeek-V2's shape on the card
    equals the same call on the CPU; ``tests/test_system.py``'s small
    assignment equals the port's BUP oracle (``core/ref.py``)."""
    import numpy as np

    from repro_torch.core import ref
    from repro_torch.core.analysis import moe_affinity, routing_graph

    assign = moe_router(spec)
    t0 = time.perf_counter()
    got = moe_affinity(assign, spec["experts"], P=spec["P"], device=dev)
    t1 = time.perf_counter()
    want = moe_affinity(assign, spec["experts"], P=spec["P"], device="cpu")
    t2 = time.perf_counter()
    expect("moe_affinity", f"θ of {spec['experts']} experts",
           np.asarray(got).tolist(), np.asarray(want).tolist())
    rng = np.random.default_rng(0)
    small = np.concatenate([rng.integers(0, 4, (50, 2)),
                            rng.integers(4, 8, (50, 2))])
    expect("moe_affinity", "test_system's assignment",
           np.asarray(moe_affinity(small, 8, P=4, device=dev)).tolist(),
           ref.bup_tip_ref(routing_graph(small, 8), side="v").tolist())
    info = dict(tokens=int(assign.shape[0]), experts=spec["experts"],
                top_k=spec["top_k"], theta_max=int(np.max(got)),
                distinct_theta=int(np.unique(got).size),
                device_s=round(t1 - t0, 3), cpu_s=round(t2 - t1, 3))
    log(f"[smoke]   moe_affinity, {info['tokens']} tokens × "
        f"{spec['experts']} experts top-{spec['top_k']}: {dev} equals the "
        f"CPU; the small assignment equals bup_tip_ref; {info}")
    return info


def phase_train(fullsize, dev, tmp, launches, tr=TRAIN, smi="") -> dict:
    """Phase 13: the training CLI at full width (its device split under
    the profiler, attention's forward and backward timed alone), the
    kernel route's gradients against plain autograd, crash and resume,
    the curriculum on the 60k graph and the MoE affinity."""
    import dataclasses

    from repro_torch.configs import get_config

    info = dict(cli=train_cli(tr["cli"], dev, launches))
    c = info["cli"]
    log(f"[smoke]   launch.train {' '.join(tr['cli'])} ({dev}): losses "
        f"{[round(x, 4) for x in c['losses']]}; step seconds "
        f"{c['step_seconds']}; {c['tokens_per_s']:.1f} tokens/s at the "
        f"median step {c['steady_step_s']:.4f} s; max_memory_allocated "
        f"{c['max_memory_allocated']}; flash_attention launches "
        f"{c['flash_attention_launches']}; held-out batch's loss "
        f"{c['held_out_loss'][0]:.4f} -> {c['held_out_loss'][1]:.4f}, the "
        f"least leaf move {c['min_leaf_move']:.3e} ({smi})")
    argv = tr["cli"]
    cfg = get_config(argv[argv.index("--arch") + 1])
    if "--reduced" in argv:
        from repro_torch.models import reduced

        cfg = reduced(cfg)
    b, s = (int(argv[argv.index(f) + 1]) for f in ("--batch", "--seq"))
    cfg = dataclasses.replace(cfg, max_seq=s)
    info["profile"] = profile_train_step(cfg, dev, b, s)
    info["attention_alone"] = attention_backward_ms(cfg, b, s, dev)
    log(f"[smoke]   one train step's device split: {info['profile']}; one "
        f"layer's attention alone: {info['attention_alone']} ({smi})")
    info["grads"] = train_grads_check(tr["grad"], dev)
    log(f"[smoke]   kernel-route gradients at full width, depth "
        f"{tr['grad']['overrides']['n_layers']}: {info['grads']} (limit "
        f"{TRAIN_GRAD_RTOL})")
    info["resume"] = train_resume(tr["resume"], tr["crash_at"],
                                  tr["resumed_at"], dev, tmp)
    info["curriculum"] = train_curriculum(fullsize, tr["curriculum"], dev,
                                          launches)
    info["moe"] = train_moe(tr["moe"], dev)
    return info


# ---------------------------------------------------------------------
# phase 14: the MoE family (DeepSeek-V2 with MLA, DBRX) and
# flash_attention at MLA's head dims
# ---------------------------------------------------------------------
# moe_layer against the per-expert loop: ‖Δ‖/‖loop‖ (f32; only the
# summation order of the products differs)
MOE_RTOL = 1e-4
MOE = dict(
    # the kernel at DeepSeek-V2's prefill attention: 128/128 heads, q/k of
    # 128 + 64 dims, v of 128; checked against its plain version at b 1
    # (the plain f32 scores at b 4 would take 8.6 GB), timed at b 1 and
    # at the prefill's b 4
    attention=dict(label="deepseek-v2 MLA prefill", heads=128, seq=2048,
                   dqk=192, dv=128, check_batch=1, time_batch=4, reps=10),
    deepseek=dict(arch="deepseek_v2_236b", n_layers=2, batch=4, seq=2048,
                  seed=0, check_seq=256, stride=16,
                  serve=dict(slots=4, requests=8, prompt=(16, 128),
                             max_new=32, max_seq=256, eos_request=1,
                             eos_index=7)),
    dbrx=dict(arch="dbrx_132b", n_layers=1, batch=4, seq=2048, seed=1),
    affinity_P=8,
    cli=["--arch", "deepseek_v2_236b", "--reduced"],
    # training: one gradient of each model at full width and depth 1 (the
    # parameters and their gradients fit a card, an AdamW step does not),
    # layer 0's moe_layer against the loop under autograd, and the CLI's
    # AdamW steps at --reduced in their own processes
    train=dict(models=(("dbrx_132b", 1), ("deepseek_v2_236b", 1)),
               batch=1, seq=2048, seed=5, layer_seed=6,
               cli=[["--arch", "dbrx_132b", "--reduced"],
                    ["--arch", "deepseek_v2_236b", "--reduced"]],
               cli_flags=["--steps", "8", "--batch", "4", "--seq", "128",
                          "--log-every", "1"]),
)
# a gradient with remat "full" against "none": the recompute routes
# every token as the forward did, so only the summation order differs
MOE_REMAT_RTOL = 1e-5


def check_padded_attention(spec, dev) -> dict:
    """``ops.flash_attention`` at head dims it has no instance of (q/k
    ``dqk``, v ``dv``: MLA's 192 / 128, Zamba2's 112; zero-padded to the
    next instance by the wrapper) against its plain version, in bf16 and
    f32, at ``check_batch``; timed there beside the plain version and
    SDPA, and at the prefill's ``time_batch`` beside SDPA.  Each dtype's
    bound from the true work and from the padded work, on the units its
    route runs on."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    H, S, dqk, dv = spec["heads"], spec["seq"], spec["dqk"], spec["dv"]
    P = fa.padded_head_dim(dqk, dv)
    reps = spec["reps"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rates = {"bfloat16": BF16_FLOP_PER_S, "float32": TF32_FLOP_PER_S / 3}
    cases = []
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)

        def draw(B):
            return [torch.randn((B, H, S, d), generator=gen,
                                device=dev).to(dtype) for d in (dqk, dqk, dv)]

        q, k, v = draw(spec["check_batch"])
        got = ops.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        if got.shape != want.shape:
            raise AssertionError(f"flash_attention MLA {dt}: shape "
                                 f"{tuple(got.shape)} != {tuple(want.shape)}")
        delta = got.float() - want.float()
        err = delta.abs().max().item()
        row_err = (delta.norm(dim=-1) / want.float().norm(dim=-1)).max().item()
        if not (err <= ATTN_ATOL[dt] and row_err <= ATTN_ROW_RTOL[dt]):
            raise AssertionError(
                f"flash_attention MLA {dt}: max abs err {err} (limit "
                f"{ATTN_ATOL[dt]}), worst row's relative err {row_err} "
                f"(limit {ATTN_ROW_RTOL[dt]}) against the plain version")
        del got, want, delta
        row = dict(case=spec["label"], dtype=dt, head_dims=[dqk, dv],
                   padded_head_dim=P,
                   route=(fa.route(dtype, P) if q.is_cuda
                          else "plain version"),
                   max_abs_err=err, row_rel_err=row_err)
        for tag, B in (("check", spec["check_batch"]),
                       ("prefill", spec["time_batch"])):
            if tag == "prefill":
                del q, k, v
                q, k, v = draw(B)
            ops_true, bytes_true = attention_work(
                q.shape, k.shape, dv, q.element_size(), True, None)
            ops_pad, bytes_pad = attention_work(
                (B, H, S, P), (B, H, S, P), P, q.element_size(), True, None)
            mem = bytes_true / HBM_BYTES_PER_S * 1e3
            instance_ms = None
            if tag == "prefill":
                # the D P instance alone on inputs padded beforehand: the
                # wrapper's call less its three pads
                padded = fa.pad_head_dims(q, k, v)
                instance_ms = cuda_ms(lambda: ops.flash_attention(
                    *padded, causal=True, scale=dqk ** -0.5), reps)
                del padded
            row[tag] = dict(
                batch=B, ms=cuda_ms(lambda: ops.flash_attention(
                    q, k, v, causal=True), reps),
                plain_ms=(cuda_ms(lambda: ref.flash_attention_ref(
                    q, k, v, causal=True), max(1, reps // 4))
                          if tag == "check" else None),
                library_ms=(cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), reps) if q.is_cuda else None),
                ops_true=ops_true, ops_padded=ops_pad, bytes=bytes_true,
                instance_ms=instance_ms,
                bound_ms=max(ops_true / rates[dt] * 1e3, mem),
                bound_padded_ms=max(ops_pad / rates[dt] * 1e3,
                                    bytes_pad / HBM_BYTES_PER_S * 1e3),
                bound_hbm_ms=mem)
        log(f"[smoke]   flash_attention {spec['label']} {dt} (D {dqk} / Dv "
            f"{dv} padded to {P}, {row['route']}): max abs err {err:.2e} "
            f"(tol {ATTN_ATOL[dt]}), worst row {row_err:.2e} relative (tol "
            f"{ATTN_ROW_RTOL[dt]}); b {row['check']['batch']}: "
            f"{row['check']}; b {row['prefill']['batch']}: {row['prefill']}")
        cases.append(row)
        del q, k, v
    first = cases[0]["check"]
    return dict(ms=first["ms"], plain_ms=first["plain_ms"],
                library_ms=first["library_ms"], bound_ms=first["bound_ms"],
                max_abs_err=max(c["max_abs_err"] for c in cases),
                cases=cases)


def ffn_input(model, tokens):
    """The hidden states layer 0's FFN reads in a forward of ``tokens``:
    rms_norm(x + attention(rms_norm(x))), one attention launch."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import _positions
    from repro_torch.models.transformer import attention, mla_attention

    cfg = model.cfg
    p = model.blocks[0].tree()
    pos = _positions(cfg, *tokens.shape, tokens.device)
    x = model.embed_tokens(tokens)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + (mla_attention if cfg.is_mla else attention)(h, p["attn"], cfg,
                                                         pos)
    return rms_norm(x, p["norm2"], cfg.norm_eps)


def expert_loop(x, p, cfg, keep_last=False):
    """An independent MoE layer: for each group and expert, the tokens
    whose top k (``torch.topk`` of the f32 router softmax, gates
    renormalised) hold the expert, in sequence order; the first C of them
    (the last C with ``keep_last``: a planted fault) through the expert's
    FFN, weighted by their gate; plus the shared experts.  Returns the
    output and the number of (token, expert) pairs dropped."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import matmul_f32
    from repro_torch.models.layers import mlp
    from repro_torch.models.moe import capacity

    b, s, _ = x.shape
    C = capacity(cfg, s)
    probs = torch.softmax(matmul_f32(x.float(), p["router"].float()), dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    dropped = 0
    for e in range(cfg.n_experts):
        hit = idx == e                                   # [b, s, k]
        w = (gates * hit).sum(dim=-1)                    # [b, s]
        for i in range(b):
            toks = torch.nonzero(hit[i].any(dim=-1)).flatten()
            dropped += max(0, toks.numel() - C)
            toks = toks[-C:] if keep_last else toks[:C]
            if toks.numel() == 0:
                continue
            xe = x[i, toks]
            g = matmul_f32(xe, p["we1"][e])
            g = (F.silu(g) if cfg.mlp_type == "swiglu"
                 else F.gelu(g, approximate="tanh"))
            y = matmul_f32(g * matmul_f32(xe, p["we3"][e]), p["we2"][e])
            out[i, toks] += w[i, toks, None].to(x.dtype) * y
    if cfg.n_shared_experts:
        out = out + mlp(x, p["shared"], cfg.mlp_type)
    return out, dropped


def router_margin(x, p, cfg) -> float:
    """The least gap, over the tokens of x, between the k-th and the
    (k+1)-th router probability: a near-tie there can send a token to
    another expert under another summation order."""
    import torch

    from repro_torch.kernels.ref import matmul_f32

    probs = torch.softmax(matmul_f32(x.float(), p["router"].float()), dim=-1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    return (top[..., -2] - top[..., -1]).min().item()


def moe_layer_check(label, model, tokens, dev) -> dict:
    """Layer 0's ``moe_layer`` on the forward's hidden states held to
    ``expert_loop`` within ``MOE_RTOL`` relative L2; the drops counted,
    and at least one needed (the check is of the capacity too)."""
    import torch

    from repro_torch.models.moe import capacity, moe_layer

    cfg = model.cfg
    with torch.no_grad():
        x = ffn_input(model, tokens)
        p = model.blocks[0].tree()["ffn"]
        sync(dev)
        t0 = time.perf_counter()
        got = moe_layer(x, p, cfg)
        sync(dev)
        layer_s = time.perf_counter() - t0
        want, dropped = expert_loop(x, p, cfg)
    rel = ((got - want).norm() / want.norm()).item()
    C = capacity(cfg, tokens.shape[1])
    out = dict(capacity=C, dropped=dropped,
               pairs=tokens.numel() * cfg.top_k, rel_l2=rel,
               moe_layer_s=layer_s, router_margin=router_margin(x, p, cfg))
    log(f"[smoke]   {label} layer 0 moe_layer (E {cfg.n_experts}, top-"
        f"{cfg.top_k}, C {C} at capacity_factor {cfg.capacity_factor}) vs "
        f"the per-expert loop: relative L2 {rel:.3e} (limit {MOE_RTOL}); "
        f"{dropped} of {out['pairs']} (token, expert) pairs dropped; "
        f"{layer_s * 1e3:.1f} ms; router margin {out['router_margin']:.3e}")
    if not rel <= MOE_RTOL:
        raise AssertionError(f"{label}: moe_layer differs from the "
                             f"per-expert loop by {rel} > {MOE_RTOL}")
    if dropped == 0:
        raise AssertionError(f"{label}: no (token, expert) pair dropped at "
                             f"C {C}: the capacity is not exercised")
    return out


def counted_prefills(label, model, tokens, dev, launches, n=2,
                     per_call=None, **inputs):
    """``n`` timed prefills of ``tokens`` (and ``inputs``: M-RoPE
    positions, Whisper's frames), each launching ``flash_attention``
    ``per_call`` times (default once a layer) on the card (none on the
    CPU) and no other kernel; returns the last logits and the
    seconds."""
    import torch

    from repro_torch.kernels import ops

    per_call = model.cfg.n_layers if per_call is None else per_call
    want = {k: (per_call * (torch.device(dev).type == "cuda")
                if k == "flash_attention" else 0) for k in ops.KERNELS}
    secs = []
    with torch.no_grad():
        for _ in range(n):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            last = model.prefill(tokens, **inputs)
            sync(dev)
            secs.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            expect(label, "kernel launches", counts, want)
            launches["flash_attention"] = (launches.get("flash_attention", 0)
                                           + counts["flash_attention"])
    return last, secs


def zipf_tokens(b, s, vocab, seed, dev):
    """[b, s] tokens of the port's synthetic stream (``data.pipeline``,
    Zipf 1.3 as text is: a quarter of them one token): a text-like,
    skewed load on the experts."""
    import torch

    from repro_torch.data.pipeline import DataConfig, synthetic_batches

    toks = next(synthetic_batches(DataConfig(b, s, vocab, seed)))["tokens"]
    return torch.from_numpy(toks).to(device=dev, dtype=torch.int64)


def _moe_config(spec):
    import dataclasses

    from repro_torch.configs import get_config

    return spec.get("cfg") or dataclasses.replace(
        get_config(spec["arch"]), n_layers=spec["n_layers"])


def _free(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def deepseek_f32(spec, dev, launches, affinity_P) -> tuple:
    """DeepSeek-V2 in f32 (random weights from a seeded
    ``torch.Generator``): timed prefills, layer 0's MoE against the
    per-expert loop, decode against forward without drops, the batcher,
    the router's top k through ``moe_affinity``.  Returns the numbers,
    the prefill's last-position logits and the tokens."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.analysis import moe_affinity
    from repro_torch.models import DenseLM, init_params
    from repro_torch.models.moe import capacity, route

    cfg = _moe_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, torch.float32)
    model = DenseLM(cfg, params)
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = spec["batch"], spec["seq"]
    # uniform tokens: the router's top k of Zipf tokens share experts so
    # much that moe_affinity's butterfly counts pass f32's exact range,
    # where the JAX package's dense engine raises OverflowError (the
    # port's are int64, exact to 2^53)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    last, info["prefill_s"] = counted_prefills(
        f"{cfg.name} f32 prefill", model, tokens, dev, launches)
    info["prefill_tok_s"] = [b * s / t for t in info["prefill_s"]]
    log(f"[smoke]   {cfg.name} f32, depth {cfg.n_layers} at full width "
        f"({info['weights_gb']:.2f} GB, made in {info['init_s']:.1f} s): "
        f"prefill b={b} s={s} in {info['prefill_s']} s "
        f"({info['prefill_tok_s']} tok/s), {cfg.n_layers} flash_attention "
        f"launches each")
    info["moe"] = moe_layer_check(f"{cfg.name} f32", model, tokens, dev)

    # decode against forward where nothing is dropped: capacity_factor
    # E / k gives C >= s (what the JAX test's reduced() does with 8.0)
    nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    n = min(spec["check_seq"], s)
    if capacity(nd, n) < n:
        raise AssertionError(f"capacity {capacity(nd, n)} < {n}")
    pos = sorted(set(range(0, n, spec["stride"])) | {n - 1})
    ids = tokens[:, :n].contiguous()
    with torch.no_grad():
        fwd = DenseLM(nd, params)(ids)[:, pos]
    t0 = time.perf_counter()
    naive = teacher_forced(DenseLM(nd, params), ids, pos, dev)
    sync(dev)
    t1 = time.perf_counter()
    absorbed = teacher_forced(
        DenseLM(dataclasses.replace(nd, mla_absorb=True), params), ids, pos,
        dev)
    sync(dev)
    t2 = time.perf_counter()
    info["decode"] = dict(
        capacity_factor=nd.capacity_factor, positions=len(pos), steps=n,
        naive_s=t1 - t0, absorbed_s=t2 - t1,
        forward_vs_naive=close_logits("forward vs naive MLA decode", fwd,
                                      naive),
        forward_vs_absorbed=close_logits("forward vs absorbed MLA decode",
                                         fwd, absorbed),
        absorbed_vs_naive=close_logits("absorbed vs naive MLA decode",
                                       absorbed, naive))
    del fwd, naive, absorbed
    log(f"[smoke]   {cfg.name} f32 decode vs forward at capacity_factor "
        f"{nd.capacity_factor:.4g} (C >= s, no drops), {len(pos)} of the "
        f"first {n} positions: {info['decode']} (atol {LOGIT_ATOL})")

    info["serve"] = serve_requests(cfg, params, spec["serve"], dev, cfg.vocab)

    with torch.no_grad():
        x = ffn_input(model, tokens)
        _, idx = route(x, model.blocks[0].tree()["ffn"]["router"], cfg)
    assign = idx.reshape(-1, cfg.top_k).cpu().numpy()
    t0 = time.perf_counter()
    got = moe_affinity(assign, cfg.n_experts, P=affinity_P, device=dev)
    t1 = time.perf_counter()
    want = moe_affinity(assign, cfg.n_experts, P=affinity_P, device="cpu")
    expect("moe_affinity of the router's top k", "θ",
           np.asarray(got).tolist(), np.asarray(want).tolist())
    info["affinity"] = dict(tokens=int(assign.shape[0]),
                            theta_max=int(np.max(got)),
                            distinct_theta=int(np.unique(got).size),
                            device_s=t1 - t0)
    log(f"[smoke]   layer 0's router top-{cfg.top_k} of the prefill's "
        f"tokens through moe_affinity on {dev} equal to the CPU's: "
        f"{info['affinity']}")
    last = last.float()
    del model, params, x
    _free(dev)
    return info, last, tokens


def deepseek_bf16(spec, dev, launches, last32, tokens) -> dict:
    """The same weights in bf16 (the generator redrawn, then rounded):
    timed prefills, the last-position logits within ``BF16_LOGIT_RTOL``
    of the f32 model's, relative in the 2-norm."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _moe_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.bfloat16))
    last, secs = counted_prefills(f"{cfg.name} bf16 prefill", model, tokens,
                                  dev, launches)
    rel = ((last.float() - last32).norm() / last32.norm()).item()
    b, s = tokens.shape
    info = dict(prefill_s=secs, prefill_tok_s=[b * s / t for t in secs],
                rel=rel)
    log(f"[smoke]   {cfg.name} bf16: prefill b={b} s={s} in {secs} s "
        f"({info['prefill_tok_s']} tok/s), {cfg.n_layers} flash_attention "
        f"launches each; last-position logits vs f32 relative L2 {rel:.3e} "
        f"(limit {BF16_LOGIT_RTOL})")
    if not rel <= BF16_LOGIT_RTOL:
        raise AssertionError(f"{cfg.name} bf16 prefill: relative logit error "
                             f"{rel} > {BF16_LOGIT_RTOL} against f32")
    del model
    _free(dev)
    return info


def dbrx_f32(spec, dev, launches) -> dict:
    """DBRX in f32: timed prefills (GQA through the kernel) and layer 0's
    MoE against the per-expert loop."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _moe_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.float32))
    b, s = spec["batch"], spec["seq"]
    tokens = zipf_tokens(b, s, cfg.vocab, spec["seed"], dev)
    _, secs = counted_prefills(f"{cfg.name} f32 prefill", model, tokens, dev,
                               launches)
    info = dict(prefill_s=secs, prefill_tok_s=[b * s / t for t in secs])
    log(f"[smoke]   {cfg.name} f32, depth {cfg.n_layers} at full width: "
        f"prefill b={b} s={s} in {secs} s ({info['prefill_tok_s']} tok/s)")
    info["moe"] = moe_layer_check(f"{cfg.name} f32", model, tokens, dev)
    del model
    _free(dev)
    return info


def grads_against(cfg, params, batch, against=None):
    """One backward of ``train_loss`` on ``batch`` through fresh leaves
    of ``params`` (views, no copies).  Without ``against``: (the loss,
    the leaves' gradients in ``tree_leaves`` order).  With it: each
    leaf's gradient is held to ``against[i]`` as it lands (relative L2)
    and freed at once, so two full gradient sets never live together;
    returns (the loss, the relative L2 of each leaf)."""
    import torch

    from repro_torch.models import train_loss
    from repro_torch.train.tree import tree_leaves, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = tree_leaves(leaves)
    rel = [None] * len(flat)
    if against is not None:
        def landed(i):
            def hold(t):
                want = against[i]
                rel[i] = (t.grad - want).norm() / want.norm().clamp_min(1e-30)
                t.grad = None
            return hold
        for i, t in enumerate(flat):
            t.register_post_accumulate_grad_hook(landed(i))
    loss = train_loss(leaves, batch, cfg)
    loss.backward()
    if against is None:
        return loss.item(), [t.grad for t in flat]
    return loss.item(), [r.item() for r in rel]


def model_train_grads(cfg, spec, dev, launches, extra=None) -> dict:
    """``cfg`` (full width, cut in depth), f32, random weights: one
    gradient of ``train_loss`` at b ``batch`` × s ``seq`` (plus
    ``extra(b, s, gen)``'s inputs: Whisper's frames, M-RoPE positions)
    through the kernel route (remat ``full``: ``flash_attention``
    launches twice an attention, the forward and the recompute), held
    leaf by leaf to the plain route's (``ref.flash_attention_ref`` under
    autograd) within ``TRAIN_GRAD_RTOL`` and to remat ``none``'s (one
    launch an attention) within ``MOE_REMAT_RTOL``.  Returns the numbers
    and the parameters (for ``moe_layer_grads``)."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params, layers
    from repro_torch.models.moe import capacity

    cfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
    n_layers = cfg.n_layers
    cuda = torch.device(dev).type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    params = init_params(cfg, gen, dev, torch.float32)
    b, s = spec["batch"], spec["seq"]
    ids = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device=dev)
    batch = dict(tokens=ids[:, :-1], labels=ids[:, 1:])
    if extra is not None:
        batch.update(extra(b, s, gen))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, g = grads_against(cfg, params, batch)
    sync(dev)
    info = dict(params=sum(p.numel() for p in g), seconds=time.perf_counter()
                - t0, capacity=capacity(cfg, s) if cfg.is_moe else None,
                loss=loss,
                launches_full=ops.launch_counts()["flash_attention"],
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
    plain = lambda q, k, v, causal=True, offset=None: ref.flash_attention_ref(
        q, k, v, causal=causal, offset=offset)
    t0 = time.perf_counter()
    with mock.patch.object(layers.ops, "flash_attention", plain):
        info["loss_plain"], rel = grads_against(cfg, params, batch, g)
    sync(dev)
    info["seconds_plain"] = time.perf_counter() - t0
    info["plain_worst_rel_l2"] = max(rel)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    info["loss_remat_none"], rel = grads_against(
        dataclasses.replace(cfg, remat_policy="none"), params, batch, g)
    sync(dev)
    info["seconds_remat_none"] = time.perf_counter() - t0
    info["remat_worst_rel_l2"] = max(rel)
    info["launches_none"] = ops.launch_counts()["flash_attention"]
    if cuda:
        info["peak_bytes_all"] = torch.cuda.max_memory_allocated()
    del g
    log(f"[smoke]   {cfg.name} training, full width, depth {n_layers}, f32, "
        f"b {b} × s {s} (C {info['capacity']}, inputs {sorted(batch)}): "
        f"{info['params']} parameters; "
        f"the gradient in {info['seconds']:.2f} s (plain route "
        f"{info['seconds_plain']:.2f}, remat none "
        f"{info['seconds_remat_none']:.2f}), loss {loss:.5f} (plain "
        f"{info['loss_plain']:.5f}, remat none "
        f"{info['loss_remat_none']:.5f}); worst leaf vs the plain route "
        f"{info['plain_worst_rel_l2']:.3e} (limit {TRAIN_GRAD_RTOL}), remat "
        f"full vs none {info['remat_worst_rel_l2']:.3e} (limit "
        f"{MOE_REMAT_RTOL}); flash_attention launches {info['launches_full']}"
        f" (remat full) / {info['launches_none']} (none); peak allocated "
        f"{info['peak_bytes']} B with one gradient set, "
        f"{info.get('peak_bytes_all')} B over the three")
    if cuda:
        calls = _av_calls(cfg)
        expect(f"{cfg.name} training", "flash_attention launches",
               (info["launches_full"], info["launches_none"]),
               (2 * calls, calls))
        launches["flash_attention"] = (launches.get("flash_attention", 0)
                                       + info["launches_full"]
                                       + info["launches_none"])
    if not info["plain_worst_rel_l2"] <= TRAIN_GRAD_RTOL:
        raise AssertionError(
            f"{cfg.name}: a leaf's gradient differs from the plain route's "
            f"by {info['plain_worst_rel_l2']} > {TRAIN_GRAD_RTOL}")
    if not info["remat_worst_rel_l2"] <= MOE_REMAT_RTOL:
        raise AssertionError(
            f"{cfg.name}: remat full against none: a leaf's gradient "
            f"differs by {info['remat_worst_rel_l2']} > {MOE_REMAT_RTOL}")
    return info, cfg, params


def moe_layer_grads(cfg, params, s, seed, dev) -> dict:
    """Layer 0's ``moe_layer`` on a seeded input x [1, s, d] with a
    shared component (so the router favours some experts and C drops
    pairs): the gradients of x, the router and ``we1`` / ``we3`` /
    ``we2`` under a seeded cotangent, held to autograd through
    ``expert_loop`` within ``MOE_RTOL`` relative L2."""
    import torch

    from repro_torch.models.moe import capacity, moe_layer

    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((1, s, d), generator=gen, device=dev)
         + 2 * torch.randn((d,), generator=gen, device=dev))
    w = torch.randn((1, s, d), generator=gen, device=dev)
    p0 = {k: v[0] for k, v in params["blocks"]["ffn"].items() if k != "shared"}
    if "shared" in params["blocks"]["ffn"]:
        p0["shared"] = {k: v[0] for k, v in
                        params["blocks"]["ffn"]["shared"].items()}
    names = ("router", "we1", "we3", "we2")
    dropped = []

    def grads(fn):
        leaves = {k: p0[k].detach().requires_grad_() for k in names}
        xl = x.clone().requires_grad_()
        fn(xl, dict(p0, **leaves)).backward(w)
        return [xl.grad] + [leaves[k].grad for k in names]

    t0 = time.perf_counter()
    got = grads(lambda xl, p: moe_layer(xl, p, cfg))
    sync(dev)
    t1 = time.perf_counter()

    def loop(xl, p):
        out, n = expert_loop(xl, p, cfg)
        dropped.append(n)
        return out
    want = grads(loop)
    rel = {name: ((a - b).norm() / b.norm()).item()
           for name, a, b in zip(("x",) + names, got, want)}
    del got, want
    info = dict(capacity=capacity(cfg, s), dropped=dropped[0],
                pairs=s * cfg.top_k, rel_l2=rel, backward_s=t1 - t0)
    log(f"[smoke]   {cfg.name} layer 0 moe_layer gradients (C "
        f"{info['capacity']}, {info['dropped']} of {info['pairs']} pairs "
        f"dropped) vs autograd through the per-expert loop: relative L2 "
        f"{rel} (limit {MOE_RTOL}); moe_layer forward + backward "
        f"{info['backward_s'] * 1e3:.1f} ms")
    if not max(rel.values()) <= MOE_RTOL:
        raise AssertionError(f"{cfg.name}: moe_layer's gradients differ from "
                             f"the per-expert loop's: {rel} > {MOE_RTOL}")
    if info["dropped"] == 0:
        raise AssertionError(f"{cfg.name}: no pair dropped at C "
                             f"{info['capacity']}: the capacity is not "
                             "exercised")
    return info


def start_train_cli(runs, flags, dev) -> list:
    """``python -m repro_torch.launch.train`` with each of ``runs``' args
    and ``flags``, each in its own process, all started now; returns
    the (command, process) pairs for ``finish_train_cli``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for args in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
               *flags, "--device", str(dev)]
        procs.append((cmd, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def finish_train_cli(procs, t0) -> dict:
    """Each of ``start_train_cli``'s processes must exit 0 with every
    loss finite and the mean of its last three steps' losses below its
    first three's (``tests/test_archs.py``'s behaviour)."""
    import math

    out = {}
    for cmd, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        losses = [float(line.split()[4]) for line in stdout.splitlines()
                  if line.startswith("[train] step ")]
        out[cmd[cmd.index("--arch") + 1]] = dict(
            args=cmd[3:], losses=losses, seconds=time.perf_counter() - t0)
        if proc.returncode != 0 or not losses or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"{' '.join(cmd)} exited "
                                 f"{proc.returncode}:\n{stdout}\n{stderr}")
        if not sum(losses[-3:]) < sum(losses[:3]):
            raise AssertionError(f"{' '.join(cmd)}: the loss did not fall: "
                                 f"{losses}")
    log(f"[smoke]   launch.train, each in its own process: {out}")
    return out


def moe_training(spec, dev, launches) -> dict:
    """Phase 14's training steps: the CLI's reduced runs started in
    their own processes, each model's full-width gradient checks beside
    them, DeepSeek-V2's layer 0 ``moe_layer`` gradients; the parameters
    are freed before the next model loads."""
    import dataclasses

    from repro_torch.configs import get_config

    info = {}
    t0 = time.perf_counter()
    procs = start_train_cli(spec["cli"], spec["cli_flags"], dev)
    try:
        for cfg in spec.get("cfgs") or [
                dataclasses.replace(get_config(arch), n_layers=n)
                for arch, n in spec["models"]]:
            t1 = time.perf_counter()
            info[cfg.name], cfg, params = model_train_grads(cfg, spec, dev,
                                                            launches)
            if cfg.is_mla:
                info[cfg.name]["moe_layer"] = moe_layer_grads(
                    cfg, params, spec["seq"], spec["layer_seed"], dev)
            del params
            _free(dev)
            info[cfg.name]["step_s"] = time.perf_counter() - t1
        info["cli"] = finish_train_cli(procs, t0)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return info


def moe_golden_config(golden):
    """The configuration ``torch_moe.json`` was recorded at."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config(golden["arch"]), n_layers=golden["n_layers"],
        capacity_factor=golden["capacity_factor"])


def phase_moe(golden, dev, launches, spec=MOE, golden_cfg=None,
              tree=None) -> tuple:
    """Phase 14; returns (the MLA flash_attention numbers, the rest).  The
    golden's numpy weights (5.1 G normals at full width) are ``tree``, a
    future the caller started early, or drawn here in a thread while the
    card runs the random-weight models and the CLI runs in its own
    process.  Training comes after the serving steps."""
    import concurrent.futures

    import torch

    from repro_torch.models.moe import capacity

    golden_cfg = golden_cfg or moe_golden_config(golden)
    seconds = {}
    info = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        t_tree = time.perf_counter()
        if tree is None:
            tree = pool.submit(golden_tree, golden, golden_cfg)

        t0 = time.perf_counter()
        row = check_padded_attention(spec["attention"], dev)
        _free(dev)
        seconds["attention"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["deepseek"], last32, tokens = deepseek_f32(
            spec["deepseek"], dev, launches, spec["affinity_P"])
        seconds["deepseek_f32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["deepseek_bf16"] = deepseek_bf16(spec["deepseek"], dev,
                                              launches, last32, tokens)
        seconds["deepseek_bf16"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["dbrx"] = dbrx_f32(spec["dbrx"], dev, launches)
        seconds["dbrx_f32"] = time.perf_counter() - t0

        # ---- the CLI, in its own process
        seconds["cli"], info["cli"] = serve_cli(spec["cli"], dev)

        # ---- the recorded depth-1 golden at full width (drops in the
        # forward)
        t0 = time.perf_counter()
        tree = tree.result()
        seconds["golden_weights_wait"] = time.perf_counter() - t0
        seconds["golden_weights_ready"] = time.perf_counter() - t_tree
    t0 = time.perf_counter()
    model, upload_s = golden_model(golden, golden_cfg, dev, tree)
    del tree
    g_tokens = torch.tensor(golden["tokens"], device=dev)
    with torch.no_grad():
        x = ffn_input(model, g_tokens)
        p = model.blocks[0].tree()["ffn"]
        _, info["golden_dropped"] = expert_loop(x, p, golden_cfg)
        info["golden_router_margin"] = router_margin(x, p, golden_cfg)
    del x, p  # p holds the golden's expert weights (15 GB)
    log(f"[smoke]   golden {golden_cfg.name} (depth {golden_cfg.n_layers}, "
        f"full width; numpy weights drawn beside the rest, ready "
        f"{seconds['golden_weights_ready']:.1f} s into the phase, "
        f"{seconds['golden_weights_wait']:.1f} s of it waited for; on the "
        f"card in {upload_s:.1f} s): the forward drops "
        f"{info['golden_dropped']} (token, expert) pairs at C "
        f"{capacity(golden_cfg, g_tokens.shape[1])}; the least router "
        f"margin (k-th - (k+1)-th probability) "
        f"{info['golden_router_margin']:.3e}")
    info["golden"] = hold_lm_golden(golden, model, dev,
                                    forward_vs_decode=False)
    log(f"[smoke]   golden forward and serve_step held to the JAX package's "
        f"logits, max abs errs {info['golden']}")
    del model
    _free(dev)
    seconds["golden"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["train"] = moe_training(spec["train"], dev, launches)
    seconds["train"] = time.perf_counter() - t0
    info["seconds"] = seconds
    log(f"[smoke]   phase 14 seconds by step: {seconds}")
    return row, info

# ---------------------------------------------------------------------
# phase 15: the SSM (xLSTM) and hybrid (Zamba2) families
# ---------------------------------------------------------------------
# decode against forward (tests/test_archs.py:92) and the chunked
# recurrence against the sequential loop (tests/test_archs.py:134), the
# JAX package's own tolerances for these models
SSM_DECODE_TOL = dict(atol=5e-2, rtol=2e-2)
RECURRENCE_TOL = dict(atol=1e-3, rtol=1e-3)
SSM = dict(
    # the kernel at Zamba2's shared attention: 32/32 heads of D 112, no
    # instance of it: zero-padded to the D 128 one
    attention=dict(label="zamba2-7b shared attention prefill", heads=32,
                   seq=2048, dqk=112, dv=112, check_batch=1, time_batch=4,
                   reps=10),
    # decode against forward over the first 128 positions at stride 8 (17
    # positions), which keeps the script inside its time limit
    xlstm=dict(arch="xlstm_1_3b", batch=4, seq=2048, seed=0, check_batch=2,
               check_seq=128, stride=8,
               # one mLSTM layer's chunked recurrence: 4 heads of 1 024
               recurrence=dict(heads=4, dk=1024, dv=1024, seq=2048)),
    zamba=dict(arch="zamba2_7b", batch=4, seq=2048, seed=1, check_batch=2,
               check_seq=128, stride=8,
               # one Mamba2 layer's: 112 heads, state 64, head dim 64
               recurrence=dict(heads=112, dk=64, dv=64, seq=2048),
               serve=dict(slots=4, requests=8, prompt=(8, 32), max_new=16,
                          max_seq=64, eos_request=1, eos_index=5)),
    cli=["--arch", "zamba2_7b", "--reduced"],
)


def recurrence_check(label, spec, chunk, dev, seed) -> dict:
    """``ssm.chunked_recurrence`` at a layer's shape (b 1) against the
    sequential ``recurrence_step`` loop within ``RECURRENCE_TOL``, both
    timed: q scaled by dk^-1/2 (as mLSTM's), decays in [0.5, 1), gains in
    [0.1, 1)."""
    import torch

    from repro_torch.models import ssm

    h, dk, dv, s = spec["heads"], spec["dk"], spec["dv"], spec["seq"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, h, s, dk), generator=gen, device=dev) * dk ** -0.5
    k = torch.randn((1, h, s, dk), generator=gen, device=dev)
    v = torch.randn((1, h, s, dv), generator=gen, device=dev)
    decay = 0.5 + 0.5 * torch.rand((1, h, s), generator=gen, device=dev)
    gain = 0.1 + 0.9 * torch.rand((1, h, s), generator=gen, device=dev)
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        got = ssm.chunked_recurrence(q, k, v, decay, gain, chunk=chunk)
        sync(dev)
        t1 = time.perf_counter()
        S = torch.zeros((1, h, dk, dv), device=dev)
        want = torch.empty_like(got)
        for t in range(s):
            S, want[:, :, t] = ssm.recurrence_step(
                S, q[:, :, t], k[:, :, t], v[:, :, t], decay[:, :, t],
                gain[:, :, t])
        sync(dev)
        t2 = time.perf_counter()
    err = (got - want).abs().max().item()
    info = dict(shape=[1, h, s, dk, dv], chunk=chunk, max_abs_err=err,
                max_abs=want.abs().max().item(), chunked_ms=(t1 - t0) * 1e3,
                sequential_ms=(t2 - t1) * 1e3)
    log(f"[smoke]   {label} chunked_recurrence vs the sequential loop: "
        f"{info}")
    torch.testing.assert_close(got, want, **RECURRENCE_TOL)
    return info


def decode_vs_forward(label, model, tokens, spec, dev) -> dict:
    """``forward``'s logits at every ``stride``-th of the first
    ``check_seq`` positions of ``check_batch`` rows held to a
    teacher-forced ``serve_step`` within ``SSM_DECODE_TOL``."""
    import torch

    n = spec["check_seq"]
    pos = sorted(set(range(0, n, spec["stride"])) | {n - 1})
    ids = tokens[:spec["check_batch"], :n].contiguous()
    with torch.no_grad():
        fwd = model(ids)[:, pos]
    t0 = time.perf_counter()
    dec = teacher_forced(model, ids, pos, dev)
    sync(dev)
    info = dict(positions=len(pos), steps=n, decode_s=time.perf_counter() - t0,
                max_abs_err=(fwd - dec).abs().max().item(),
                max_abs=fwd.abs().max().item())
    log(f"[smoke]   {label} decode vs forward, {len(pos)} of the first {n} "
        f"positions: {info} (atol {SSM_DECODE_TOL['atol']}, rtol "
        f"{SSM_DECODE_TOL['rtol']})")
    torch.testing.assert_close(dec, fwd, **SSM_DECODE_TOL)
    return info


def _ssm_config(spec):
    from repro_torch.configs import get_config

    return spec.get("cfg") or get_config(spec["arch"])


def _attention_calls(cfg) -> int:
    """``flash_attention`` launches a forward of ``cfg`` makes: one each
    application of Zamba2's shared block, none in xLSTM."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0


def ssm_f32(spec, dev, launches) -> tuple:
    """A recurrent model at full width and full depth in f32 (random
    weights from a seeded ``torch.Generator``): timed prefills with their
    launches counted, the chunked recurrence at one layer's shape,
    decode against forward, and (``serve``) the batcher.  Returns the
    numbers, the last-position logits and the tokens."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _ssm_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, torch.float32)
    model = DenseLM(cfg, params)
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = spec["batch"], spec["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    per_call = _attention_calls(cfg)
    last, info["prefill_s"] = counted_prefills(
        f"{cfg.name} f32 prefill", model, tokens, dev, launches,
        per_call=per_call)
    info["prefill_tok_s"] = [b * s / t for t in info["prefill_s"]]
    info["launches_per_prefill"] = per_call
    log(f"[smoke]   {cfg.name} f32 at full width and depth {cfg.n_layers} "
        f"({info['weights_gb']:.2f} GB, made in {info['init_s']:.1f} s): "
        f"prefill b={b} s={s} in {info['prefill_s']} s "
        f"({info['prefill_tok_s']} tok/s), {per_call} flash_attention "
        f"launches each")
    info["recurrence"] = recurrence_check(cfg.name, spec["recurrence"],
                                          cfg.ssm_chunk, dev, spec["seed"])
    info["decode"] = decode_vs_forward(cfg.name, model, tokens, spec, dev)
    if "serve" in spec:
        info["serve"] = serve_requests(cfg, params, spec["serve"], dev,
                                       cfg.vocab)
    last = last.float()
    del model, params
    _free(dev)
    return info, last, tokens


def ssm_bf16(spec, dev, launches, last32, tokens) -> dict:
    """The same weights in bf16 (the generator redrawn, then rounded):
    timed prefills (the shared block through the bf16 tensor-core route
    at D 112 padded to 128), finite logits; their relative L2 against
    the f32 model's last-position logits is printed, not gated: at 81
    random layers this model's bf16 logits drift from its f32 ones by
    O(1) in the JAX package too (115 % at reduced width); the gate is
    ``golden_bf16``'s, at the golden's depth."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _ssm_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.bfloat16))
    last, secs = counted_prefills(f"{cfg.name} bf16 prefill", model, tokens,
                                  dev, launches,
                                  per_call=_attention_calls(cfg))
    rel = ((last.float() - last32).norm() / last32.norm()).item()
    b, s = tokens.shape
    info = dict(prefill_s=secs, prefill_tok_s=[b * s / t for t in secs],
                rel=rel)
    log(f"[smoke]   {cfg.name} bf16: prefill b={b} s={s} in {secs} s "
        f"({info['prefill_tok_s']} tok/s); last-position logits vs f32 "
        f"relative L2 {rel:.3e} (not gated at this depth)")
    del model
    _free(dev)
    if not torch.isfinite(last).all():
        raise AssertionError(f"{cfg.name} bf16 prefill: non-finite logits")
    return info


def golden_bf16(golden, cfg, tree, last32, dev, **inputs) -> dict:
    """The golden's weights rounded to bf16: the last-position logits of
    a prefill of the golden's tokens (and ``inputs``, floating ones
    rounded to bf16 too) within relative L2 ``max(BF16_LOGIT_RTOL,
    BF16_DRIFT * r)`` of the f32 model's ``last32``, ``r`` the JAX
    package's own bf16-against-f32 drift on the same weights and inputs
    (``bf16_prefill_rel``, recorded)."""
    import torch

    from repro_torch.models import DenseLM
    from repro_torch.models.convert import params_from_numpy

    model = DenseLM(cfg, params_from_numpy(tree, cfg, dev, torch.bfloat16))
    tokens = torch.tensor(golden["tokens"], device=dev)
    inputs = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in inputs.items()}
    with torch.no_grad():
        last = model.prefill(tokens, **inputs).float()
    rel = ((last - last32).norm() / last32.norm()).item()
    jax_rel = golden["bf16_prefill_rel"]
    limit = max(BF16_LOGIT_RTOL, BF16_DRIFT * jax_rel)
    log(f"[smoke]   golden {cfg.name} bf16 prefill vs f32: relative L2 "
        f"{rel:.3e} (the JAX package's own {jax_rel:.3e}; limit "
        f"{limit:.3e})")
    del model
    if not rel <= limit:
        raise AssertionError(f"{cfg.name} bf16 golden prefill: relative logit "
                             f"error {rel} > {limit} against f32")
    return dict(rel=rel, jax_rel=jax_rel, limit=limit)


def ssm_golden_configs(golden) -> dict:
    """The configurations ``torch_ssm.json`` was recorded at, by arch."""
    import dataclasses

    from repro_torch.configs import get_config

    return {arch: dataclasses.replace(get_config(arch),
                                      n_layers=rec["n_layers"])
            for arch, rec in golden.items()}


def phase_ssm(golden, dev, launches, spec=SSM, golden_cfgs=None,
              trees=None) -> tuple:
    """Phase 15; returns (the D 112 flash_attention numbers, the rest).
    The goldens' numpy weights are ``trees`` (futures by arch, started
    early by the caller) or drawn here in a thread beside the card's
    work."""
    import concurrent.futures

    import torch

    golden_cfgs = golden_cfgs or ssm_golden_configs(golden)
    seconds = {}
    info = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        if trees is None:
            trees = {arch: pool.submit(golden_tree, golden[arch], c)
                     for arch, c in golden_cfgs.items()}
        t0 = time.perf_counter()
        launched = launches.get("flash_attention", 0)
        row = check_padded_attention(spec["attention"], dev)
        _free(dev)
        seconds["attention"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["xlstm"], _, _ = ssm_f32(spec["xlstm"], dev, launches)
        seconds["xlstm_f32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["zamba"], last32, tokens = ssm_f32(spec["zamba"], dev, launches)
        seconds["zamba_f32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["zamba_bf16"] = ssm_bf16(spec["zamba"], dev, launches, last32,
                                      tokens)
        seconds["zamba_bf16"] = time.perf_counter() - t0

        # ---- the goldens at full width, cut in depth
        info["golden"] = {}
        for arch, cfg in golden_cfgs.items():
            t0 = time.perf_counter()
            tree = trees[arch].result()
            seconds[f"{arch}_golden_wait"] = time.perf_counter() - t0
            model, upload_s = golden_model(golden[arch], cfg, dev, tree)
            info["golden"][arch] = hold_lm_golden(golden[arch], model, dev)
            if "bf16_prefill_rel" in golden[arch]:
                with torch.no_grad():
                    last32 = model.prefill(torch.tensor(
                        golden[arch]["tokens"], device=dev)).float()
                info["golden"][arch]["bf16"] = golden_bf16(
                    golden[arch], cfg, tree, last32, dev)
            del model, tree
            _free(dev)
            seconds[f"{arch}_golden"] = time.perf_counter() - t0
            log(f"[smoke]   golden {cfg.name} (depth {cfg.n_layers}, full "
                f"width, numpy weights on the card in {upload_s:.1f} s): "
                f"forward and serve_step held to the JAX package's logits "
                f"and to each other, max abs errs {info['golden'][arch]}")

    row["launches"] = launches.get("flash_attention", 0) - launched
    # ---- the CLI, in its own process
    seconds["cli"], info["cli"] = serve_cli(spec["cli"], dev)
    info["seconds"] = seconds
    log(f"[smoke]   phase 15 seconds by step: {seconds}")
    return row, info



# ---------------------------------------------------------------------
# phase 16: the audio (Whisper) and VLM (Qwen2-VL) families
# ---------------------------------------------------------------------
def mrope_image_positions(b, s, start, grid):
    """Qwen2-VL's M-RoPE positions [b, 3, s] (int32 numpy) for text, then
    an image of ``grid`` (h, w) patches from ``start``, then text: text
    positions are equal on the (t, h, w) streams; a patch at (row, col)
    sits at (start, start + row, start + col); the text after resumes at
    start + max(h, w) on all three (Qwen2-VL's ``get_rope_index`` for one
    image of one frame)."""
    import numpy as np

    gh, gw = grid
    n = gh * gw
    if start + n > s:
        raise ValueError(f"an image of {n} patches at {start} does not fit "
                         f"in {s} positions")
    pos = np.empty((3, s), np.int64)
    pos[:, :start] = np.arange(start)
    row, col = np.divmod(np.arange(n), gw)
    pos[0, start:start + n] = start
    pos[1, start:start + n] = start + row
    pos[2, start:start + n] = start + col
    pos[:, start + n:] = start + max(gh, gw) + np.arange(s - start - n)
    return np.ascontiguousarray(np.broadcast_to(
        pos[None], (b, 3, s)).astype(np.int32))



# Whisper's decode against its forward: tests/test_archs.py's
# test_whisper_decode_matches_forward tolerance
WHISPER_DECODE_TOL = dict(atol=2e-2, rtol=1e-2)
# (label, q shape, kv shape, causal, offset): the attention shapes of
# this phase's main paths (Whisper at b 4: its encoder, non-causal over
# 1 500 frames; cross-attention of a 448-token prompt and of one decode
# row against them; Qwen2-VL's 64/8 GQA prefill)
_AV_SHAPES = (
    ("whisper encoder", (4, 20, 1500, 64), (4, 20, 1500, 64), False, None),
    ("whisper cross prefill", (4, 20, 448, 64), (4, 20, 1500, 64), False,
     None),
    ("whisper cross decode", (4, 20, 1, 64), (4, 20, 1500, 64), False, None),
    ("qwen2-vl-72b prefill", (4, 64, 2048, 128), (4, 8, 2048, 128), True,
     None),
)
AUDIO_VLM = dict(
    kernel_cases=tuple((f"{label} {tag}", qs, ks, causal, offset, dt)
                       for label, qs, ks, causal, offset in _AV_SHAPES
                       for tag, dt in (("bf16", "bfloat16"),
                                       ("f32", "float32"))),
    reps=10,
    # full width and full depth; the prompt at Whisper's text context
    whisper=dict(arch="whisper_large_v3", batch=4, seq=448, seed=0,
                 check_batch=2, check_seq=64,
                 serve=dict(slots=4, requests=8, prompt=(8, 24), max_new=12,
                            max_seq=48, eos_request=1, eos_index=5)),
    # full width at depth 8 of 80 (full depth is 291 GB in f32); an
    # image of 32 x 32 patches from position 512
    qwen=dict(arch="qwen2_vl_72b", n_layers=8, batch=4, seq=2048, seed=1,
              image=dict(start=512, grid=(32, 32)), check_batch=2,
              check_seq=64),
    cli=(["--arch", "whisper_large_v3", "--batch", "4", "--prompt-len", "16",
          "--gen", "16"],
         ["--arch", "qwen2_vl_72b", "--reduced"]),
    # training: one gradient of Whisper at full width and depth (b 2 × 448
    # tokens over 1 500 frames) and of Qwen2-VL at full width, depth 1
    # (its f32 weights and gradients at depth 1 are 27 GB), each against
    # the plain route and remat none; the reduced train CLI of each in
    # its own process beside them
    train=dict(
        models=(dict(arch="whisper_large_v3", batch=2, seq=448, seed=5),
                dict(arch="qwen2_vl_72b", n_layers=1, batch=2, seq=2048,
                     seed=6, image=dict(start=512, grid=(32, 32)))),
        cli=[["--arch", "whisper_large_v3", "--reduced"],
             ["--arch", "qwen2_vl_72b", "--reduced"]],
        cli_flags=["--steps", "8", "--batch", "4", "--seq", "128",
                   "--log-every", "1"]),
)


def _av_config(spec):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = spec.get("cfg") or get_config(spec["arch"])
    return (dataclasses.replace(cfg, n_layers=spec["n_layers"])
            if "n_layers" in spec else cfg)


def _av_calls(cfg) -> int:
    """``flash_attention`` launches of a prefill: Whisper's encoder
    layers and each decoder layer's self- and cross-attention; one a
    layer for Qwen2-VL."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def counted_decode(label, model, tokens, pos, dev, launches, enc_out=None):
    """``teacher_forced`` over ``tokens`` with its ``flash_attention``
    launches counted: one a layer and step for Whisper (its
    cross-attention), none for a decoder-only model (plain decode
    attention).  Returns the logits and the seconds."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    steps = max(pos) + 1
    per_step = cfg.n_layers if cfg.family == "audio" else 0
    want = {k: (steps * per_step * (torch.device(dev).type == "cuda")
                if k == "flash_attention" else 0) for k in ops.KERNELS}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dec = teacher_forced(model, tokens, pos, dev, enc_out=enc_out)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect(label, "kernel launches", counts, want)
    launches["flash_attention"] = (launches.get("flash_attention", 0)
                                   + counts["flash_attention"])
    return dec, secs


def whisper_f32(spec, dev, launches) -> tuple:
    """Whisper-large-v3 at full width and depth in f32 (random weights
    from a seeded ``torch.Generator``, frames ``randn · 0.02`` from it):
    ``encode`` alone, timed prefills with their launches counted (one
    each encoder layer, two each decoder layer), ``check_seq``
    teacher-forced decode steps held to the forward at every position
    (``WHISPER_DECODE_TOL``), the batcher, the decode step's device time
    by kernel class.  Returns the numbers, the last-position logits, the
    tokens and the frames."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _av_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, torch.float32)
    model = DenseLM(cfg, params)
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = spec["batch"], spec["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev) * 0.02
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        model.encode(frames)
        sync(dev)
        info["encode_s"] = time.perf_counter() - t0
    per_call = _av_calls(cfg)
    last, info["prefill_s"] = counted_prefills(
        f"{cfg.name} f32 prefill", model, tokens, dev, launches,
        per_call=per_call, frames=frames)
    info["prefill_tok_s"] = [b * s / t for t in info["prefill_s"]]
    info["launches_per_prefill"] = per_call
    log(f"[smoke]   {cfg.name} f32 at full width and depth ({cfg.encoder_layers}"
        f" + {cfg.n_layers} layers, {info['weights_gb']:.2f} GB, made in "
        f"{info['init_s']:.1f} s): encode b={b} x {cfg.encoder_seq} frames "
        f"{info['encode_s']:.3f} s; prefill b={b} s={s} in "
        f"{info['prefill_s']} s ({info['prefill_tok_s']} tok/s), {per_call} "
        f"flash_attention launches each")

    # ---- decode against forward, at every one of the first check_seq
    n, cb = spec["check_seq"], spec["check_batch"]
    ids, fr = tokens[:cb, :n].contiguous(), frames[:cb].contiguous()
    with torch.no_grad():
        fwd = model(ids, frames=fr)
        enc = model.encode(fr)
    dec, decode_s = counted_decode(f"{cfg.name} decode", model, ids,
                                   list(range(n)), dev, launches, enc_out=enc)
    info["decode"] = dict(steps=n, batch=cb, decode_s=decode_s,
                          ms_per_step=decode_s / n * 1e3,
                          max_abs_err=(fwd - dec).abs().max().item(),
                          max_abs=fwd.abs().max().item())
    log(f"[smoke]   {cfg.name} decode vs forward, all {n} positions of "
        f"{cb} rows ({n} steps, {cfg.n_layers} cross-attention launches "
        f"each): {info['decode']} (atol {WHISPER_DECODE_TOL['atol']}, rtol "
        f"{WHISPER_DECODE_TOL['rtol']})")
    torch.testing.assert_close(dec, fwd, **WHISPER_DECODE_TOL)
    del fwd, dec, enc
    info["serve"] = serve_requests(cfg, params, spec["serve"], dev, cfg.vocab)
    info["decode_profile"] = profile_decode(model, tokens, s, dev)
    last = last.float()
    del model, params
    _free(dev)
    return info, last, tokens, frames


def qwen_f32(spec, dev, launches) -> tuple:
    """Qwen2-VL-72B at full width, cut in depth, in f32 (random weights
    from a seeded ``torch.Generator``): timed prefills with the image
    block's M-RoPE positions (``mrope_image_positions``), one launch a
    layer; ``check_seq`` teacher-forced decode steps on text-only
    positions held to the forward there (``LOGIT_ATOL``).  Returns the
    numbers, the last-position logits, the tokens and the positions."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _av_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.float32))
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = spec["batch"], spec["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    image = spec["image"]
    positions = torch.from_numpy(mrope_image_positions(
        b, s, image["start"], image["grid"])).to(dev)
    last, info["prefill_s"] = counted_prefills(
        f"{cfg.name} f32 prefill", model, tokens, dev, launches,
        positions=positions)
    info["prefill_tok_s"] = [b * s / t for t in info["prefill_s"]]
    log(f"[smoke]   {cfg.name} f32 at full width, depth {cfg.n_layers} "
        f"({info['weights_gb']:.2f} GB, made in {info['init_s']:.1f} s): "
        f"prefill b={b} s={s} with an image of {image['grid']} patches at "
        f"{image['start']} in {info['prefill_s']} s ({info['prefill_tok_s']}"
        f" tok/s), {cfg.n_layers} flash_attention launches each")
    n, cb = spec["check_seq"], spec["check_batch"]
    ids = tokens[:cb, :n].contiguous()
    with torch.no_grad():
        fwd = model(ids)
    dec, decode_s = counted_decode(f"{cfg.name} decode", model, ids,
                                   list(range(n)), dev, launches)
    info["decode"] = dict(steps=n, batch=cb, decode_s=decode_s,
                          ms_per_step=decode_s / n * 1e3,
                          max_abs_err=close_logits(
                              f"{cfg.name} text-only forward vs decode", fwd,
                              dec),
                          max_abs=fwd.abs().max().item())
    log(f"[smoke]   {cfg.name} text-only decode vs forward, all {n} "
        f"positions of {cb} rows: {info['decode']} (atol {LOGIT_ATOL})")
    del model, fwd, dec
    _free(dev)
    return info, last.float(), tokens, positions


def av_bf16(spec, dev, launches, last32, tokens, **inputs) -> dict:
    """The same weights in bf16 (the generator redrawn, then rounded),
    the f32 run's inputs (frames rounded to bf16): timed prefills, their
    launches counted, the last-position logits within relative L2
    ``BF16_LOGIT_RTOL`` of the f32 model's ``last32``."""
    import torch

    from repro_torch.models import DenseLM, init_params

    cfg = _av_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.bfloat16))
    inputs = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in inputs.items()}
    last, secs = counted_prefills(f"{cfg.name} bf16 prefill", model, tokens,
                                  dev, launches, per_call=_av_calls(cfg),
                                  **inputs)
    rel = ((last.float() - last32).norm() / last32.norm()).item()
    b, s = tokens.shape
    info = dict(prefill_s=secs, prefill_tok_s=[b * s / t for t in secs],
                rel=rel)
    log(f"[smoke]   {cfg.name} bf16: prefill b={b} s={s} in {secs} s "
        f"({info['prefill_tok_s']} tok/s); last-position logits vs f32 "
        f"relative L2 {rel:.3e} (rtol {BF16_LOGIT_RTOL})")
    del model
    _free(dev)
    if not rel <= BF16_LOGIT_RTOL:
        raise AssertionError(f"{cfg.name} bf16 prefill: relative logit error "
                             f"{rel} > {BF16_LOGIT_RTOL} against f32")
    return info


def golden_frames(golden, cfg, dev):
    """The Whisper golden's frames (the recorder's numpy draw), after the
    recorded checks of their first values and sum."""
    import numpy as np
    import torch

    spec = golden["frames"]
    b = len(golden["tokens"])
    fr = (np.random.default_rng(spec["seed"]).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)) * spec["scale"]).astype(
            np.float32)
    first = [float(x) for x in fr.reshape(-1)[:4]]
    total = float(fr.sum(dtype=np.float64))
    if first != spec["first"] or abs(total - spec["sum"]) > 1e-6 * (
            1 + abs(spec["sum"])):
        raise AssertionError(f"golden frames: {first}, {total} != the "
                             f"recorder's {spec} (another numpy stream)")
    return torch.from_numpy(fr).to(dev)


def hold_av_golden(golden, cfg, tree, dev) -> dict:
    """``cfg`` on the golden's weights held to the JAX package's
    recorded logits: Whisper's encoder sample, forward and teacher-forced
    decode (its cache's ``enc_out`` the encoder's output) on the
    recorded frames; Qwen2-VL's forward with the image block's positions,
    and forward and decode on text-only ones; forward and decode held to
    each other; then the weights in bf16 (``golden_bf16``)."""
    import torch

    model, upload_s = golden_model(golden, cfg, dev, tree)
    tokens = torch.tensor(golden["tokens"], device=dev)
    pos, ids = golden["positions"], golden["ids"]
    errs = {}
    with torch.no_grad():
        if cfg.family == "audio":
            inputs = dict(frames=golden_frames(golden, cfg, dev))
            enc = model.encode(inputs["frames"])
            sample = golden["encoder"]
            got = enc[:, sample["frames"]][:, :, sample["channels"]].cpu()
            errs["encoder"] = close_logits(
                "golden encoder output", got,
                torch.tensor(sample["values"], dtype=torch.float64))
        else:
            inputs = dict(positions=torch.tensor(golden["mrope_positions"],
                                                 device=dev))
            enc = None
            errs["image_forward"] = hold_golden(
                "golden image forward", model(tokens, **inputs)[:, pos],
                golden["image_forward"], ids)
        text = inputs if cfg.family == "audio" else {}
        fwd = model(tokens, **text)[:, pos]
        last32 = model.prefill(tokens, **inputs).float()
    dec = teacher_forced(model, tokens, pos, dev, enc_out=enc)
    errs.update(forward=hold_golden("golden forward", fwd, golden["forward"],
                                    ids),
                decode=hold_golden("golden decode", dec, golden["decode"], ids),
                forward_vs_decode=close_logits("golden forward vs decode",
                                               fwd, dec))
    del model, enc, fwd, dec
    _free(dev)
    errs["bf16"] = golden_bf16(golden, cfg, tree, last32, dev, **inputs)
    errs["upload_s"] = upload_s
    return errs


def av_golden_configs(golden) -> dict:
    """The configurations ``torch_audio_vlm.json`` was recorded at."""
    import dataclasses

    from repro_torch.configs import get_config

    return {arch: dataclasses.replace(
        get_config(arch), n_layers=rec["n_layers"],
        **({"encoder_layers": rec["encoder_layers"]}
           if "encoder_layers" in rec else {}))
        for arch, rec in golden.items()}


def av_training(spec, dev, launches, procs) -> dict:
    """Phase 16's training: each model's full-width gradient
    (``model_train_grads``: Whisper with seeded frames ``randn · 0.02``,
    Qwen2-VL with an image block's M-RoPE positions), the parameters
    freed before the next model loads, beside the reduced train CLIs'
    processes ``procs`` (``start_train_cli``), then those checked."""
    import torch

    info = {}
    t0 = time.perf_counter()
    for m in spec["models"]:
        t1 = time.perf_counter()
        cfg = _av_config(m)

        def extra(b, s, gen, cfg=cfg, m=m):
            if cfg.family == "audio":
                return dict(frames=torch.randn(
                    (b, cfg.encoder_seq, cfg.d_model), generator=gen,
                    device=dev) * 0.02)
            return dict(positions=torch.from_numpy(mrope_image_positions(
                b, s, m["image"]["start"], m["image"]["grid"])).to(dev))
        info[cfg.name], _, params = model_train_grads(cfg, m, dev, launches,
                                                      extra)
        del params
        _free(dev)
        info[cfg.name]["step_s"] = time.perf_counter() - t1
    info["cli"] = finish_train_cli(procs, t0)
    return info


def phase_audio_vlm(golden, dev, launches, spec=AUDIO_VLM, golden_cfgs=None,
                    trees=None) -> tuple:
    """Phase 16; returns (the flash_attention numbers at its shapes, with
    the launches of its serving and training runs; the rest).  The
    goldens' numpy weights are ``trees`` (futures by arch, started early
    by the caller) or drawn here in a thread beside the card's work."""
    import concurrent.futures

    golden_cfgs = golden_cfgs or av_golden_configs(golden)
    seconds = {}
    info = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        if trees is None:
            trees = {arch: pool.submit(golden_tree, golden[arch], c)
                     for arch, c in golden_cfgs.items()}
        t0 = time.perf_counter()
        row = check_attention(spec["kernel_cases"], dev, spec["reps"])
        _free(dev)
        seconds["attention"] = time.perf_counter() - t0
        launched = launches.get("flash_attention", 0)
        t0 = time.perf_counter()
        info["whisper"], last32, tokens, frames = whisper_f32(
            spec["whisper"], dev, launches)
        seconds["whisper_f32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["whisper_bf16"] = av_bf16(spec["whisper"], dev, launches, last32,
                                       tokens, frames=frames)
        del frames
        seconds["whisper_bf16"] = time.perf_counter() - t0
        row["launches"] = {"whisper": launches.get("flash_attention", 0)
                           - launched}
        launched = launches.get("flash_attention", 0)
        t0 = time.perf_counter()
        info["qwen"], last32, tokens, positions = qwen_f32(spec["qwen"], dev,
                                                           launches)
        seconds["qwen_f32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["qwen_bf16"] = av_bf16(spec["qwen"], dev, launches, last32,
                                    tokens, positions=positions)
        seconds["qwen_bf16"] = time.perf_counter() - t0
        row["launches"]["qwen"] = launches.get("flash_attention", 0) - launched

        # ---- the serving and the reduced train CLIs, each in its own
        # process, beside the goldens and the gradients (after the timed
        # runs above)
        clis = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(spec["cli"]))
        procs = start_train_cli(spec["train"]["cli"],
                                spec["train"]["cli_flags"], dev)
        try:
            served = [clis.submit(serve_cli, args, dev)
                      for args in spec["cli"]]

            # ---- the goldens at full width, cut in depth
            info["golden"] = {}
            for arch, cfg in golden_cfgs.items():
                t0 = time.perf_counter()
                tree = trees[arch].result()
                seconds[f"{arch}_golden_wait"] = time.perf_counter() - t0
                info["golden"][arch] = hold_av_golden(golden[arch], cfg,
                                                      tree, dev)
                del tree
                _free(dev)
                seconds[f"{arch}_golden"] = time.perf_counter() - t0
                log(f"[smoke]   golden {cfg.name} (depth {cfg.n_layers}, "
                    f"full width): held to the JAX package's logits, max abs "
                    f"errs {info['golden'][arch]}")

            # ---- training: the gradients at full width
            launched = launches.get("flash_attention", 0)
            t0 = time.perf_counter()
            info["train"] = av_training(spec["train"], dev, launches, procs)
            seconds["train"] = time.perf_counter() - t0
            row["launches"]["training"] = (launches.get("flash_attention", 0)
                                           - launched)
            info["cli"] = []
            for args, fut in zip(spec["cli"], served):
                seconds[f"cli {args[1]}"], lines = fut.result()
                info["cli"].append(lines)
        finally:
            clis.shutdown(wait=True)
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    info["seconds"] = seconds
    log(f"[smoke]   phase 16 seconds by step: {seconds}")
    return row, info



# ---------------------------------------------------------------------
# phase 17: the LM distribution layer (meshes, shardings, remesh, sharded
# compute, the dry-run and the roofline)
# ---------------------------------------------------------------------
LM_MESH = dict(
    arch="tinyllama_1_1b", seed=7, batch=1, seq=512, lr=1e-2, decode_steps=8,
    dryrun=["--arch", "tinyllama_1_1b"], roofline=["--arch", "tinyllama_1_1b"],
    # train_4k's per-device argument bytes on 16×16 and 2×16×16: JAX's
    # Σ NamedSharding.shard_shape × itemsize over what its dry-run places
    # (tests/test_torch_dryrun.py holds these to JAX)
    argument_bytes={"16x16": 44412932, "2x16x16": 44150788},
    # the four gloo ranks' step (shard_compute_replay.CARD) against the
    # plain step: the loss's relative error; each gradient leaf's
    # relative L2 is held to TRAIN_GRAD_RTOL
    card_loss_rtol=1e-5, card=None,
)
# the H100's peaks the roofline divides by (launch/roofline.py) and the
# FP32 peak of the world-1 step's full-f32 products (PERF.md §6)
FP32_PEAK = 67e12

_DRY = """
import json, os, sys
os.nice(10)  # beside the smoke: the host's idle cores, not its main thread's
from repro_torch.launch import dryrun, roofline
a = json.loads(sys.argv[1])
dryrun.main(a["dryrun"] + ["--no-count", "--out", a["out"]["dryrun"]])
for mp, key in (([], "roofline_1"), (["--multi-pod"], "roofline_2")):
    roofline.main(a["roofline"] + mp + ["--out", a["out"][key]])
one = dryrun.dryrun_cell(a["arch"], "train_4k", verbose=False,
                         mesh_shape=((1, 1), ("data", "model")),
                         batch=a["batch"], seq=a["seq"])
json.dump(one, open(a["out"]["one"], "w"))
"""


def start_dryrun(tmp, spec=LM_MESH) -> tuple:
    """One CPU process, started now: ``python -m repro_torch.launch.dryrun``
    over ``spec["dryrun"]`` (the arguments placed, ``--no-count``), the
    roofline CLI for that arch on both production meshes, and the
    dry-run's count of the world-1 step's shape on the (1, 1) mesh;
    returns (the process, its output files) for ``phase_lm_mesh``."""
    out = {k: os.path.join(tmp, f"{k}.json")
           for k in ("dryrun", "roofline_1", "roofline_2", "one")}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = dict(dryrun=spec["dryrun"], roofline=spec["roofline"],
                arch=spec["arch"], batch=spec["batch"], seq=spec["seq"],
                out=out)
    return subprocess.Popen(
        [sys.executable, "-c", _DRY, json.dumps(args)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out


def _placed_like(tree, mesh):
    """``tree`` (a batch or cache) placed by ``batch_shardings``."""
    from repro_torch.sharding import batch_shardings, distribute
    from repro_torch.train.tree import tree_map

    return tree_map(distribute, tree, batch_shardings(tree, mesh))


def lm_mesh_world1(dev, tmp, spec, launches) -> dict:
    """Phase 17's world-1 part (NCCL on the card, gloo on the CPU):
    ``make_local_mesh`` is (1, 1) ``("data", "model")``; ``remesh`` of the
    full-width f32 parameters and ``adamw_init`` state gives ``DTensor``s
    each ``torch.equal`` to its input; the train step on those
    ``DTensor``s themselves (``constrain`` and ``local_map`` live) equals
    the plain step bit for bit; so do a prefill and ``decode_steps``
    decode steps through the mesh path.  Launches of the mesh path are
    the main path's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (init_cache, init_params, logical_axes,
                                    prefill, serve_step)
    from repro_torch.sharding import cache_shardings, distribute, use_mesh
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step, remesh)
    from repro_torch.train.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    info = {}
    cuda = torch.device(dev).type == "cuda"

    def count():
        n = ops.launch_counts()["flash_attention"]
        launches["flash_attention"] = launches.get("flash_attention", 0) + n
        ops.reset_launch_counts()
        return n

    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{tmp}/mesh-rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device=dev)
        sync(dev)
        info["group_s"] = time.perf_counter() - t0
        expect("local mesh", "shape and names",
               (tuple(mesh.shape), mesh.mesh_dim_names),
               ((1, 1), ("data", "model")))
        cfg = spec.get("cfg") or get_config(spec["arch"])
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        params = init_params(cfg, gen, dev, torch.float32)
        opt = adamw_init(params)
        flat = lambda p, o: tree_leaves(p) + tree_leaves(o)
        sync(dev)
        t1 = time.perf_counter()
        p1, o1 = remesh(params, opt, logical_axes(cfg), mesh)
        sync(dev)
        info["remesh_s"] = time.perf_counter() - t1
        info["leaves"] = len(flat(p1, o1))
        info["params"] = sum(x.numel() for x in tree_leaves(params))
        for a, b in zip(flat(params, opt), flat(p1, o1), strict=True):
            if not (isinstance(b, DTensor) and b.device_mesh is mesh
                    and torch.equal(b.to_local(), a)):
                raise AssertionError("remesh: a leaf is not its input "
                                     "placed on the local mesh")
        ids = torch.randint(0, cfg.vocab, (spec["batch"], spec["seq"] + 1),
                            generator=gen, device=dev)
        batch = dict(tokens=ids[:, :-1], labels=ids[:, 1:])
        step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
            lr=spec["lr"], warmup_steps=1)))
        ops.reset_launch_counts()
        placed = _placed_like(batch, mesh)
        sync(dev)
        t1 = time.perf_counter()
        got = step(p1, o1, placed)
        sync(dev)
        info["step_cold_s"] = time.perf_counter() - t1
        info["launches"] = dict(step=count())
        t1 = time.perf_counter()    # again, DTensor's sharding plans cached
        again = step(p1, o1, placed)
        sync(dev)
        info["step_s"] = time.perf_counter() - t1
        info["launches"]["step_warm"] = count()
        same_again = all(torch.equal(a.to_local(), b.to_local()) for a, b in
                         zip(flat(*got[:2]), flat(*again[:2]), strict=True))
        del o1, again
        t1 = time.perf_counter()
        want = step(params, opt, batch)
        sync(dev)
        info["plain_step_s"] = time.perf_counter() - t1
        ops.reset_launch_counts()
        del opt
        same = all(torch.equal(a.to_local(), b) for a, b in zip(
            flat(*got[:2]), flat(*want[:2]), strict=True))
        info["loss"] = [got[2]["loss"].to_local().item(),
                        want[2]["loss"].item()]
        del got, want
        _free(dev)
        if not (same and same_again and info["loss"][0] == info["loss"][1]):
            raise AssertionError(f"the sharded step on the local mesh "
                                 f"differs from the plain step: "
                                 f"{info['loss']}")
        with torch.no_grad():
            tokens = batch["tokens"]
            want = prefill(params, tokens, cfg)
            ops.reset_launch_counts()
            with use_mesh(mesh):
                got = prefill(p1, _placed_like(dict(t=tokens), mesh)["t"],
                              cfg)
            info["launches"]["prefill"] = count()
            same_prefill = torch.equal(got.to_local(), want)
            n = spec["decode_steps"]
            b = tokens.shape[0]
            cache = init_cache(cfg, b, n, dev, torch.float32)
            cache_m = tree_map(distribute, init_cache(
                cfg, b, n, dev, torch.float32), cache_shardings(
                    cache, mesh, cfg))
            same_decode = []
            for t in range(n):
                tok = tokens[:, t].contiguous()
                lp, cache = serve_step(params, cache, tok, t, cfg)
                with use_mesh(mesh):
                    lm, cache_m = serve_step(
                        p1, cache_m, _placed_like(dict(t=tok), mesh)["t"],
                        t, cfg)
                same_decode.append(torch.equal(lm.to_local(), lp))
            same_decode.append(all(torch.equal(cache_m[k].to_local(), v)
                                   for k, v in cache.items()))
            ops.reset_launch_counts()
        del params, p1, cache, cache_m
        _free(dev)
        info["prefill_equal"], info["decode_equal"] = same_prefill, same_decode
        if not (same_prefill and all(same_decode)):
            raise AssertionError(f"the mesh path's prefill ({same_prefill}) "
                                 f"or decode steps and cache ({same_decode}) "
                                 "differ from the plain path's")
    finally:
        dist.destroy_process_group()
    info["seconds"] = time.perf_counter() - t0
    return info


def start_card(tmp, spec=LM_MESH) -> tuple:
    """``tests/goldens/shard_compute_replay.py --card`` (the four gloo
    ranks of phase 17: mostly CPU work once gloo refuses the card) in
    its own process, started now; returns (the process, its case
    directory, the start time) for ``lm_mesh_ranks``."""
    case = os.path.join(tmp, "card")
    os.makedirs(case, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    argv = [sys.executable, os.path.join(ROOT, "tests", "goldens",
                                         "shard_compute_replay.py"),
            "--card", "--case", case]
    if spec.get("card"):
        argv += ["--card-spec", json.dumps(spec["card"])]
    return (subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), case,
            time.perf_counter())


def lm_mesh_ranks(dev, tmp, spec, launches, card=None) -> dict:
    """Phase 17's four ranks: ``tests/goldens/shard_compute_replay.py
    --card`` (gloo, sharing the card, a (2, 2) mesh, TinyLlama-1.1B at
    full width and depth 2, b 4 × 512).  The loss within
    ``card_loss_rtol`` and every gradient leaf within ``TRAIN_GRAD_RTOL``
    (relative L2) of the plain step on the same weights and batch; on the
    card ``flash_attention`` launched on every rank's local shard (twice a
    layer: forward and remat).  Gloo's collectives are probed on CUDA
    tensors first; where one that ``DTensor`` needs fails (or kills its
    rank), it is named and the ranks run on the CPU instead."""
    import torch

    proc, case, t0 = card or start_card(tmp, spec)
    t1 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs, waited = time.perf_counter() - t0, time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"four ranks failed (rc {proc.returncode}): "
                             f"{stdout[-2000:]}{stderr[-3000:]}")
    sys.path.insert(0, os.path.join(ROOT, "tests", "goldens"))
    try:
        import shard_compute_replay as replay
    finally:
        sys.path.pop(0)
    card = dict(replay.CARD, **(spec.get("card") or {}))
    with open(os.path.join(case, "probe.json")) as f:
        probe = json.load(f)
    ran = probe.pop("ran_on")
    ranks = [json.load(open(os.path.join(case, f"card-{ran}-rank{r}.json")))
             for r in range(card["world"])]
    bad = [r.get("error") for r in ranks if "error" in r]
    if bad:
        raise AssertionError(f"four ranks on {ran}: {bad[0]}\n"
                             f"{ranks[0].get('trace', '')}")
    r0 = ranks[0]
    info = dict(device=ran, probe_cuda=probe, seconds=round(secs, 3),
                waited_s=round(waited, 3), step_s=[r["step_s"] for r in ranks],
                collective_counts=r0["collective_counts"],
                collective_bytes=r0["collective_bytes"],
                loss=[r0["loss_sharded"], r0["loss_plain"]],
                worst_rel_l2=r0["worst_rel_l2"], leaves=r0["leaves"],
                flash_launches=[r["flash_launches"] for r in ranks])
    if torch.device(dev).type == "cuda" and ran == "cuda":
        for r, n in enumerate(info["flash_launches"]):
            expect(f"rank {r} of four", "flash_attention launches on its "
                   "shard", n, 2 * card["depth"])
        n = sum(r["flash_launches_total"] for r in ranks)
        launches["flash_attention"] = launches.get("flash_attention", 0) + n
        info["launches"] = n
    rel = abs(info["loss"][0] - info["loss"][1]) / abs(info["loss"][1])
    if not (rel <= spec["card_loss_rtol"]
            and info["worst_rel_l2"] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"four ranks: loss {info['loss']} (rel {rel}), "
                             f"worst leaf {info['worst_rel_l2']} against the "
                             "plain step")
    return info


def phase_lm_mesh(dev, tmp, spec=LM_MESH, dry=None, launches=None,
                  card=None) -> dict:
    """Phase 17: ``lm_mesh_world1`` (the world-1 mesh path bit-equal to
    the plain one), ``lm_mesh_ranks`` (four gloo ranks on a (2, 2) mesh
    against the plain step), and beside them, in their own CPU process
    (``dry``: ``start_dryrun``'s, started early by the caller), the
    dry-run CLI over every shape of ``spec["dryrun"]``'s arch on both
    production meshes (no cell in error, train_4k's per-device argument
    bytes JAX's), the roofline CLI for that arch on both (no cell in
    error; each cell's bottleneck and terms printed) and the dry-run's
    FLOPs of the world-1 step, whose time at the peaks stands beside the
    step's measured seconds.  ``card``: ``start_card``'s, started early
    by the caller (else started here, beside the world-1 part)."""
    t0 = time.perf_counter()
    launches = {} if launches is None else launches
    dry, out = dry or start_dryrun(tmp, spec)
    card = card or start_card(tmp, spec)
    try:
        info = lm_mesh_world1(dev, tmp, spec, launches)
        info["ranks"] = lm_mesh_ranks(dev, tmp, spec, launches, card)
        t1 = time.perf_counter()
        stdout, stderr = dry.communicate(timeout=600)
        info["dryrun_wait_s"] = time.perf_counter() - t1
        if dry.returncode != 0:
            raise AssertionError(f"the dry-run process exited "
                                 f"{dry.returncode}:\n{stdout[-3000:]}\n"
                                 f"{stderr[-3000:]}")
        recs = {}
        for k, path in out.items():
            with open(path) as f:
                recs[k] = json.load(f)
    finally:
        for proc in (dry, card[0]):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    info["dryrun"] = {
        f"{r['shape']} {'2x16x16' if r['multi_pod'] else '16x16'}":
        r.get("mem", {}).get("argument_bytes", r["status"])
        for r in recs["dryrun"]}
    bad = [r for r in recs["dryrun"] + recs["roofline_1"] + recs["roofline_2"]
           if r["status"] not in ("ok", "skipped")]
    got = {mesh: info["dryrun"][f"train_4k {mesh}"]
           for mesh in spec["argument_bytes"]}
    info["roofline"] = {
        f"{r['shape']} {'2x16x16' if r.get('multi_pod') else '16x16'}":
        (dict(bottleneck=r["bottleneck"], t_compute_s=r["t_compute_s"],
              t_memory_s=r["t_memory_s"], t_collective_s=r["t_collective_s"],
              model_flops_per_chip=r["model_flops_per_chip"],
              flops_per_chip=r["flops_per_chip"])
         if r["status"] == "ok" else r["status"])
        for r in recs["roofline_1"] + recs["roofline_2"]}
    one = recs["one"]
    info["one_card"] = dict(flops=one["flops"],
                            t_bf16_peak_s=one["flops"] / 989e12,
                            t_fp32_peak_s=one["flops"] / FP32_PEAK,
                            measured_step_s=info["step_s"])
    info["seconds"] = time.perf_counter() - t0
    ranks = info["ranks"]
    for cell, r in info["roofline"].items():
        log(f"[smoke]   roofline {spec['arch']} {cell}: "
            + (f"{r['bottleneck']} (t_compute {r['t_compute_s']:.3e} s, "
               f"t_memory {r['t_memory_s']:.3e} s, t_collective "
               f"{r['t_collective_s']:.3e} s)" if isinstance(r, dict)
               else r))
    log(f"[smoke]   {spec['arch']} at full width ({info['params']} "
        f"parameters, {info['leaves']} leaves with AdamW's moments) remeshed "
        f"onto the local (1, 1) mesh in {info['remesh_s']:.3f} s, every leaf "
        f"equal; the train step on those DTensors at b {spec['batch']} × s "
        f"{spec['seq']} in {info['step_s']:.3f} s (the first, DTensor's "
        f"plans not yet cached, {info['step_cold_s']:.3f} s; plain "
        f"{info['plain_step_s']:.3f} s) equal to the plain step bit for bit "
        f"(loss {info['loss'][0]:.6f}), its prefill and "
        f"{spec['decode_steps']} decode steps too; flash_attention launches "
        f"on the mesh path {info['launches']}; the dry-run's count of that "
        f"step {one['flops']:.4e} FLOPs: {info['one_card']['t_bf16_peak_s']:.4f}"
        f" s at the bf16 peak, {info['one_card']['t_fp32_peak_s']:.4f} s at "
        f"FP32's, measured {info['step_s']:.4f} s")
    log(f"[smoke]   four gloo ranks on {ranks['device']} ((2, 2) mesh; gloo "
        f"on CUDA tensors: {ranks['probe_cuda']}): loss {ranks['loss']}, "
        f"worst leaf {ranks['worst_rel_l2']:.3e} (limit {TRAIN_GRAD_RTOL}), "
        f"step seconds by rank {ranks['step_s']}, collectives by kind "
        f"{ranks['collective_counts']} ({ranks['collective_bytes']} bytes), "
        f"flash_attention a rank {ranks['flash_launches']} ({ranks['seconds']}"
        f" s from its start, {ranks['waited_s']} s waited for); the dry-run's "
        f"per-device argument bytes {info['dryrun']}; phase 17 "
        f"{info['seconds']:.1f} s (waiting for the dry-run "
        f"{info['dryrun_wait_s']:.1f})")
    if bad:
        raise AssertionError(f"dry-run or roofline cells in error: {bad}")
    expect("dry-run train_4k", "argument bytes", got, spec["argument_bytes"])
    return info

if __name__ == "__main__":
    sys.exit(main())
