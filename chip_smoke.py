"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Runs from the root of a checkout (it puts ``src/`` on the path itself)
and imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing one JSON line with its seconds; any failure raises and the
script exits non-zero:

1. environment: the card, its power limit, torch/CUDA versions, and the
   build of every CUDA source of the port (one ``nvcc`` each, all started
   together, at first use);
2. the water-fill kernel (K1) against its plain PyTorch version on the
   card, bitwise, single calls and pairs (both phases of a cell step in
   one launch), at widths 8 ... 5120 (a warp per row up to 256 lanes, a
   block per row above), B = 1 rows at 8, 128 and 1024, rows whose guard
   is false at entry and degenerate rows, with reruns and the launch
   counter (one per call or pair);
3. the accel path: the 4 seeds x 4 policies x 4 error alphas = 64-cell
   matrix on the full paper FB workload (100 jobs, 100 machines, 400 map
   and 200 reduce slots) through ``run_cells_accel(device="cuda")``,
   cold (each cell synthesized on the host, as users call it), then
   warm and once more with the plain water-fill, both handed the cold
   run's cells (``cells=``), which must give the same summaries; every job completes and hfsp and srpt beat
   fifo on mean sojourn at alpha 0 on every seed; one K1 launch per hfsp
   step by counter (and by name in a profile of the hfsp batch, in
   phase 9);
4. wide rows: 4 hfsp cells of 1000 ``fb_scaled`` jobs on 100 machines
   (width 1024) through the same entry point, kernel and plain version;
5. the discrete-event path (``des_main_path``): paper-fb at full width
   (``paper_fb_base()``: 100 jobs on 100 machines) through
   ``run_scenario(device="cuda")`` with ``vc_backend="torch"`` under fifo,
   fair, hfsp, hfsp with kill preemption, srpt, las and psbs; every job
   completes, each report equals the port's own ``vc_backend="numpy"``
   run field for field (wall time and spec aside), and hfsp beats fifo
   on mean sojourn; then the scheduler-overhead stress cell of
   benchmarks/bench_sched_overhead.py (``fb_scaled``, 5000 jobs on 1000
   machines, hfsp, stopped at 10000 of the benchmark's 20000 events)
   with torch and numpy virtual clusters,
   each timed on its own: equal completions and passes, events/s and the
   mean and p99 pass times of both.  On each cell, K1's and the projection kernel's launch
   counters are > 0 and equal to the calls counted at the
   ``vcluster_torch`` entry points;
6. the projection kernel against its plain PyTorch version on the card,
   bitwise (``project_kernel_vs_plain``): B = 1 at widths 8, 256 and 1024
   and at 5120 in segments with host compaction, batches with
   ``n_valid``, rows of only infinite-size jobs, of zero weights and
   resumed at a level, a width that is not a bucket width, rows
   stopped at a floor, a row of only infinite-size jobs, a row whose
   jobs all finish in one event, ragged widths 33, 257 and 1025, B = 3
   rows of different live counts and rows with lanes not present, of no
   work and of zero weight, with reruns and the launch counter; its
   one-launch segmented route (``project_segmented_cases``: 1024, 2048,
   5120, B = 2) against the host-segmented plain path, every output
   bitwise, and ``vcluster_torch.project_finish_times`` at 2048 jobs: one
   call, one launch, the bits of the CPU's host segment loop; its time
   at widths 16, 256, 1024 and 128 (graph-replayed) beside its bound (the
   operations on the lanes the work touches) and the plain version, with
   the events a call runs, µs per event and the split of an event's
   cycles among its phases (the ``project_clocks`` build's stamps:
   level rounds, divisions, least-time rounds, commits, compactions);
   the segmented route at 2048 and 5120 lanes, one launch against the
   host's segments; one call of ``vcluster_torch.water_fill`` and
   ``project_finish_times`` (numpy in and out, the host round trip
   included) against the numpy loops' at 4 to 8192 live jobs
   (``vcluster_wrapped_calls``), with the "auto" latch's threshold each
   kernel's numbers give beside the one in ``core/vcluster.py``; then the
   stress cell once more under the profiler (the device's busy share of
   the wall, the same launches as the timed run) with its projection
   calls recorded, and the kernel timed on them (graph-replayed) beside
   its bound, the plain version and the phase split;
7. the scenario engine's entry points (``scenarios_cli``), at paper
   scale (100 FB jobs on 100 machines, nothing cut): (a)
   ``run_worker(paper-estimation-error, compute="accel",
   accel_batch=32)`` into a sqlite store runs its 30 hfsp cells in one
   batch (K1 launches by counter = the batch's steps, 512 a chunk) and
   its fair cell in a spawned attempt, each batch report equal (wall
   aside) to a direct ``run_cells_accel`` of the same specs and cells;
   (b) ``python -m repro_torch.scenarios run
   paper-estimation-error-disciplines --workers 4`` with ``REPRO_VC_BACKEND=torch``, alone on the host,
   exits 0; its spawned attempts, summed (each writes its counters
   through the sweep hook's ``launch_counts``), launch K1 and the
   projection kernel > 0 times and exactly as often as their virtual
   clusters call them; its 10 reports equal an inline ``run_sweep`` with
   numpy virtual clusters, and one hfsp cell of it in-process launches
   as its virtual clusters call; (c) ``sweep-status`` reports both stores
   converged, nothing quarantined; (d) under "auto", a
   paper-cluster-size cell with up to 37 live jobs a phase (10 machines)
   runs the projection kernel and no K1, and paper-fb's hfsp cell (at
   most 14) launches nothing, each report equal to numpy's and each
   timed against numpy in turns after an untimed run (numpy, auto,
   auto, numpy);
8. the live service (``service_main_path``): paper-fb's cluster and 100
   FB jobs (``paper_fb_base()``) through ``repro_torch.service`` in this
   process, as users run it: ``LiveEngine.create(policy="hfsp",
   device="cuda")`` with ``REPRO_VC_BACKEND=torch``, a ``Master``, worker
   agents on all 100 machines, 4 users submitting their jobs over the
   wire with tags at arrival / 100 (the time scale, cut from production's
   1.0: ~19 s of wall), machine 7's worker killed a third of the way in
   and rejoined; all 100 jobs complete, the journal holds the crash and
   the recover, ``replay_journal`` of the journal on the card with torch
   and with numpy virtual clusters gives the live fingerprint and
   completions, K1's and the projection kernel's launches are > 0 and
   equal their calls, and with ``CUDA_VISIBLE_DEVICES=""`` ``python -m
   repro_torch.service master --device cuda`` exits non-zero without a
   ``LISTENING`` line; it prints the decision latency (p50, p99), the
   session's wall and the launches;
9. K1 timing on inputs captured from the accel path (the hfsp batch's
   first 256 steps at 16 x 128 and the wide cells' at 4 x 1024), as
   pairs and as single-phase calls, graph-replayed, beside the bound of
   the work, the host time per step and the floor any launch pays (a
   one-element ``add_``); the main path's hfsp batch once more, each
   chunk of 512 steps captured in a CUDA graph whose kernel nodes the
   libcuda names (one K1 launch per step by name), the kernels of
   one hfsp step
   counted in a CUDA graph, and a short profile of the hfsp step;
10. the flash attention kernel (K2) against its plain PyTorch version on
   the card, f32 (the CUDA-core kernel ``flash_fwd``, atol = rtol = 2e-5)
   and bf16 (the tensor-core kernel ``flash_tc``, both atol 2e-2 and
   atol 4e-3 with rtol 1.6e-2), on the shapes of tests/test_kernels.py,
   three windows, a window over eight 128-row kv tiles, a non-causal call,
   olmo-1b's (4, 16, 4096, 128), starcoder2-3b's GQA (4, 24 -> 2, 4096,
   128), head dim 80 (a small GQA case and zamba2-2.7b's (4, 32, 4096,
   80)), granite-moe-3b's (4, 24 -> 8, 4096, 64), llava-next-34b's
   (1, 56 -> 8, 4096, 128) and command-r-35b's (4, 64 -> 8, 4096, 128),
   with bitwise reruns and both launch counters;
   besides the elementwise bounds, the relative error of every output row
   of every head must stay within ``FLASH_ROW_REL`` (1e-4 f32, 1.6e-2
   bf16); at the six model shapes, outputs of deliberately wrong
   attention (a kv tile dropped, the diagonal key dropped past row 1024,
   the last kv tile dropped for the last 128 rows of one head) must fail
   both the bf16 tolerance and the row bound, with the margins printed;
11. the serving path: olmo-1b at its published widths (16 layers, d_model
   2048, vocab 50304; random weights from ``--seed``) through
   ``make_prefill_step(use_flash=True, last_token_only=True)`` on 4 x 4096
   prompt tokens in bf16, cold and warm (16 launches of the tensor-core
   K2 per prefill and none of the CUDA-core one, by counter and by name in
   the profile), a profile of one prefill, then ``greedy_generate`` for 4
   requests of 64 prompt and 32 new tokens;
12. serving cross-checks in f32 on the same weights: prefill logits with K2
   (its f32 route) against the plain version (atol 1e-3), and the last
   prompt position's prefill logits against the decode-cache route's (atol
   1e-3); then in bf16 on 1 x 1024: prefill logits with the tensor-core K2
   against the same prefill through K2's plain version, within 2e-2 of
   max |logit|;
13. K2 timing at the olmo shape beside its bound, the plain version and
   ``F.scaled_dot_product_attention`` (timed only, never on the path): its
   achieved TFLOP/s, share of the bound and ratio to SDPA, and the f32
   route's time on the same inputs in f32;
14. the RWKV6 WKV scan kernel (K3: ``rwkv6_scan``, one block per chunk,
    head and batch row, the entering state handed from block to block
    through a two-slot ring per head) against its plain PyTorch version on
    the card, f32 output and state at atol = rtol = 1e-4 and bf16 r/k/v
    (f32 w) at atol = rtol = 2e-2, on the shapes of tests/test_kernels.py,
    strong decays at chunk 16, a ragged 16-chunk scan over 16 heads
    (2, 8, 1000, 64) and rwkv6-1.6b's (4, 32, 4096, 64) at chunk 64 with
    test_kernels.py's decays (sharpness 2) and with the model's (sharpness
    6, w ~ 0.9975), with bitwise reruns and the launch counter; at
    rwkv6-1.6b's shape, at both decays, three faulty outputs (a late
    chunk's entering state zeroed, one channel of the state missing a
    chunk's decay, a chunk's bonus diagonal dropped) must fail the output
    tolerance;
15. the rwkv6 serving path, after olmo-1b's weights are freed: rwkv6-1.6b
    at its published widths (24 layers, d_model 2048, 32 heads of 64,
    d_ff 7168, vocab 65536, untied head; 1,583,941,632 parameters, random
    from ``--seed``) through ``make_prefill_step(use_scan_kernel=True,
    last_token_only=True)`` on 4 x 4096 prompt tokens in bf16, cold and
    warm (24 K3 launches per prefill, by counter and by ``rwkv6_scan``'s
    name in the profile, and the replaced ``rwkv6_fwd`` none), a profile
    of one prefill, then ``greedy_generate`` for 4 requests of 64 prompt
    and 32 new tokens;
16. rwkv6 cross-checks in f32 on the same weights: 1 x 1024 prefill
    logits with K3 against the plain version and the ``rwkv_scan_chunked``
    route, and the last prompt position's prefill logits against the
    decode route's on 200 tokens (atol 1e-3 each);
17. K3 timing at the rwkv6 shape beside its bound (and its share of it)
    and the plain version (no single PyTorch call computes the scan, so no
    library time), in bf16 and with f32 inputs, each against the bound of
    its own input bytes;
18. the Mamba2 SSD scan (K4: two kernels, ``ssd_cb`` and ``ssd_scan``,
    one launch count) against its plain PyTorch version on
    the card, f32 y and state at atol = rtol = 1e-4 and bf16 x/B/C (f32
    dt/a) at atol = rtol = 2e-2, on the shapes of tests/test_kernels.py,
    strong decays at chunk 16 and zamba2-2.7b's (4, 80, 4096, 64, 64) at
    chunk 64 (with the model's decays, and with weaker ones held at 1e-4
    of y's scale), with bitwise reruns and the launch counter; at
    zamba2-2.7b's shape, three faulty outputs (a late chunk's entering
    state zeroed, one p-slice missing a chunk's decay, a chunk's diagonal
    scores dropped) must fail the y tolerance;
19. the zamba2 serving path, after rwkv6's weights are freed: zamba2-2.7b
    at its published widths (54 mamba2 layers, d_model 2560, ssm_state 64,
    heads of 64; one shared attention+MLP block of 32 heads of 80 and
    d_ff 10240 after every 6th layer; vocab 32000, tied embeddings;
    2,340,750,240 parameters, random from ``--seed``) through
    ``make_prefill_step(use_flash=True, use_scan_kernel=True,
    last_token_only=True)`` on 4 x 4096 prompt tokens in bf16, cold and
    warm (54 K4 launches per prefill, each of K4's two kernels 54 times
    by name and the replaced ``ssd_fwd`` none, 9 tensor-core K2 launches
    and none of the CUDA-core K2), profiles of a prefill and
    a decode step, then ``greedy_generate`` for 4 requests of 64 prompt
    and 32 new tokens;
20. zamba2 cross-checks in f32 on the same weights: 1 x 1024 prefill
    logits with K4 and K2 against K4's plain version, the
    ``ssd_scan_chunked`` route and K2's plain version, and the last prompt
    position's prefill logits against the decode route's on 200 tokens
    (atol 1e-3 each);
21. K4 timing at the zamba2 shape beside its bound and the plain version
    (no single PyTorch call computes the scan, so no library time), in
    bf16 and with f32 inputs, and each of its kernels' profiled time per
    launch, and
    K2 at zamba2's head dim 80 beside its bound, its plain version and
    ``F.scaled_dot_product_attention``, with the same fields as phase 13;
22. training (``train_main_path``), after zamba2's weights are freed:
    olmo-1b at its published widths (16 layers, d_model 2048, 16 heads of
    128, d_ff 8192, vocab 50304; random weights from ``--seed``) through
    ``make_train_step`` with ``TrainConfig(remat="block")`` and
    ``OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50)``, bf16
    activations and f32 master weights and moments, five steps on one
    4 x 4096 ``SyntheticLM`` batch: finite losses, the fifth below the
    first, no launch of K2, K3 or K4 (the training path has no kernel:
    their wrappers refuse grads); step ms cold and warm, tokens/s, peak
    memory, the model FLOPs of a step (``train_flops``) as TFLOP/s and
    as a share of the bf16 peak, and a profile of one step; then the
    EAGER suspension at published widths, cut to 2 of 16 layers (the
    snapshot's disk round trip took ~50 s at full depth): from a fresh
    state, two steps, ``CheckpointStore.save`` of the whole state, the
    state dropped from the card, restored and two more steps, bitwise
    equal to four uninterrupted steps from the same state (save and
    restore seconds and bytes); and ``flash_attention_cuda`` refuses a
    bf16 input that requires grad (``KernelInputError``) and runs under
    ``torch.no_grad()``;
23. the gang runtime (``gang_main_path``): ``GangRuntime`` on the card
    under ``HFSPScheduler(HFSPConfig(sample_set_size=1,
    vc_backend="torch"))`` on one machine with two map slots
    (``GANG_JOBS``: olmo_1b, rwkv6_1b6 and zamba2_2b7 SMOKE jobs in f32
    of 8, 4 and 2 steps, quanta of 2, 64 x 8 tokens a step): every job
    completes, HFSP suspends a job (offloads and restores >= 1), each
    job's final state equals the same steps run straight through
    ``make_train_step`` on the card, bitwise, and K1's and P's launches
    are > 0 and equal their virtual clusters' calls;
24. ``ml_workload``: the ``ml-workload`` preset's three cells (fifo,
    fair, hfsp; 40 ML jobs on 8 machines) through
    ``run_scenario(device="cuda")`` with torch and with numpy virtual
    clusters: reports equal (wall aside), every job completes, and the
    hfsp cell launches K1 and P as often as it calls them;
25. the MoE serving path (``moe_serve_main_path``), after the gang
    runtime's and ml-workload's: granite-moe-3b-a800m at its published
    widths and depth (32 layers, d_model 1536, 24 heads of 64 -> 8 kv
    heads, 40 experts top-8 of d_ff 512, vocab 49155 padded to 49168,
    tied; 3,298,813,440 parameters, random from ``--seed``) through
    ``serve_main_path`` with ``use_flash=True``: 32 tensor-core K2
    launches per 4 x 4096 prefill, by counter and by name, cold and warm,
    ``greedy_generate`` for 4 x (64 + 32), profiles of a prefill and a
    decode step; then one more prefill with the routing recorded
    (capacity 4096 per expert, the share of choices dropped by layer) and
    profiles of a prefill and a decode step by the MoE layer's parts
    (scatter ``scatter_add``, gather ``gather``, ``cumsum``, the
    top-k's ``sort``, ``one_hot``, the expert ``bmm``s) and the layer's
    whole share of device time;
26. MoE cross-checks in f32 on the same weights, 1 x 1024
    (``moe_serve_crosscheck``): prefill logits with K2's f32 route
    against K2's plain version (atol 1e-3; where a routing decision of
    the plain run went another way within the f32 noise, the plain run
    is routed as the kernel's run was, and the count is printed), and the
    first MoE layer on its input in that run, on the card against the
    same call on the CPU: the same experts and kept set, outputs within
    1e-4 of max |out|, and the count of tokens whose top-8 margin is
    below 1e-6;
27. the other configs (``families_serve``), each at its published widths
    (``FAMILIES`` says what was cut and why), its weights freed before
    the next one's: gemma2-2b (nothing cut; 2 x 8192, the plain route),
    whisper-base (nothing cut; 4 x 1500 frame embeddings, 4 x 448
    decoder tokens, the plain route) and llama4-scout-17b-a16e (2 of 48
    layers: 213.5 GB even in bf16; 4 x 4096, top-1 with the shared
    expert, K2 2 per prefill): prefill cold and warm, K2's launches per
    prefill by counter, peak memory, ``greedy_generate`` for 4 x (64 + 32)
    (``GENERATE``, as in ``full_depth_serve``), finite prefill and decode
    logits and a profile of 2 warm decode steps;
28. the multi-device layout and the dry-run (``dryrun_main_path``): (a)
    ``python -m repro_torch.launch.dryrun`` on the host, with no card, for
    olmo-1b x train_4k on both production meshes, granite-moe-3b x
    prefill_32k on the multi-pod mesh (``--skip-cost``: its MoE group pin
    over ("pod", "data")) and zamba2-2.7b x long_500k (batch 1: the
    caches' sequence over data), the three processes started together,
    every cell OK, each cell's per-device bytes, FLOPs, collectives,
    roofline terms and useful ratio printed; (b) ``make_host_mesh()`` is
    a (1, 1) ``cuda`` mesh, and olmo-1b at its published widths, traced
    by the dry-run for a 1 x 4096 prefill on it, is held to the card:
    its real f32 ``ParamTree`` distributed by ``param_specs`` (and the
    tokens by ``batch_specs``) takes exactly the trace's argument bytes
    (the caching allocator's requested bytes; ``memory_allocated``, which
    rounds each block up, beside them); the same prefill on the plain
    route on plain tensors peaks (``max_memory_allocated`` less the
    arguments) within 10% or 256 MiB of the trace's temp bytes;
    ``FlopCounterMode`` counts the trace's FLOPs exactly; the prefill's
    time beside the roofline's bound (not gated), and no kernel launched;
29. K2 at granite-moe-3b's head dim 64 (4, 24 -> 8, 4096, 64) beside its
    bound, its plain version and ``F.scaled_dot_product_attention``, with
    the same fields as phase 13;
30. bf16 weight storage (``bf16_storage_check``): command-r-35b and
    llava-next-34b cut to 2 layers, f32 weights from ``--seed``, prefill
    logits in bf16 with the tensor-core K2 in both layers (1 x 4096, and
    1216 text tokens after 2880 patch embeddings), then the same tree cast
    to bf16 (``param_dtype="bfloat16"``) and the prefill again: the
    logits must be bitwise equal;
31. the configs at their published depth (``full_depth_serve``, after
    every phase that holds large tensors; ``FULL_DEPTH``), each through
    ``make_prefill_step(use_flash=True, last_token_only=True)`` and
    ``greedy_generate``, its weights freed before the next one's:
    starcoder2-3b (30 layers, f32 weights; 4 x 4096, 30 tensor-core K2
    launches per prefill), command-r-35b (40 layers, weights stored in
    bf16; 4 x 4096, 40 a prefill) and llava-next-34b (60 layers, weights
    stored in bf16; 2880 patch embeddings and 1216 text tokens, 60 a
    prefill): parameters, init seconds and peak memory, prefill cold and
    warm (seconds, tokens/s, K2 launches by counter), ``greedy_generate``
    for 4 requests of 64 prompt and 32 new tokens (new tokens/s), one
    decode step's logits at position 0, a profile of the 2 warm decode
    steps after it (the device's busy share, its time a step and the top
    kernels), finite logits, greedy outputs in range and peak memory below
    the card's total (``torch.cuda.mem_get_info``); it raises, and never
    cuts a layer, where a model does not fit;
32. K2 at command-r-35b's prefill call (4, 64 -> 8, 4096, 128) beside its
    bound, its plain version and ``F.scaled_dot_product_attention``, with
    the same fields as phase 13;
33. the ``{"kernels": [...]}`` line (K1, K2, K3, K4 and the projection
    kernel), the card's name and power limit, and the final ``{"ok":
    true, ...}`` line.

Each main path (the accel matrix, the wide rows, the discrete-event
path's two cells, the scenario worker's batch, the CLI sweep's hfsp
cell, the "auto" latch's cell, the live service's session, olmo-1b
serving, rwkv6 serving, zamba2 serving, olmo-1b training, the gang
runtime, ml-workload's cells, granite-moe-3b serving, each config of
``families_serve``, the dry-run's olmo-1b prefill on the plain route,
each config of ``full_depth_serve``)
runs with every kernel's launch count set to 0 just before it and read
just after.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks: HBM3 bandwidth, and f64 outside the tensor
#: cores (the water-fill is f64 element-wise work).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12
#: bf16 dense tensor-core peak (the yardstick for attention's bound).
PEAK_BF16_PER_S = 989e12
#: f64 operations per lane per round of the water-fill as the plain
#: version writes it: the weight sum's add, the share's multiply and
#: divide, headroom and headroom-minus-eps subtractions, the capped
#: compare, the grant sum's add and the allocation's add.
WF_OPS_PER_LANE_ROUND = 8

POLICIES = ("fifo", "hfsp", "srpt", "las")
SEEDS = (0, 1, 2, 3)
ALPHAS = (0.0, 0.1, 0.3, 0.5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, replays: int = 10) -> float:
    """Mean device time of the launches ``fn()`` issues, captured once in
    a CUDA graph and replayed: no host time between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


class KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of libcuda's graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def graph_kernel_names(graph) -> list[str]:
    """The (mangled) names of the kernel nodes of ``graph``, a
    ``torch.cuda.CUDAGraph(keep_graph=True)`` after its capture, as the
    libcuda's graph API reports them (no profiler)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed ({rc})")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    names = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:  # a library kernel (CUkernel) the node launches as it is
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names


def graph_kernels(fn) -> list[str]:
    """The kernels ``fn()`` launches, by name: the kernel nodes of a CUDA
    graph it is captured in (``graph_kernel_names``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    names = graph_kernel_names(graph)
    torch.cuda.synchronize()
    return names


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int64)


def reset_counts() -> None:
    """Set every kernel's launch count to 0, just before a main path."""
    from repro_torch.accel import waterfill as wf
    from repro_torch.core import projection as pj
    from repro_torch.core import vcluster_torch as vt
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rwkv6 import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk

    wf.launches = fk.launches = fk.launches_tc = rk.launches = 0
    sk.launches = pj.launches = 0
    vt.calls.update(water_fill=0, project=0)


def drop_wall(results: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in results]


#: The cells ``synthesize_cell`` made while ``recording_cells`` was on, by
#: spec.  A spec is synthesized once, on the host, by the entry point that
#: first runs it; every later run of it (warm, plain, packed, captured,
#: direct) is handed the recorded cell through ``run_cells_accel(cells=)``.
SYNTHESIZED: dict[str, dict] = {}


def spec_key(spec) -> str:
    return json.dumps(spec.to_dict(), sort_keys=True, default=str)


@contextlib.contextmanager
def recording_cells():
    """Record in ``SYNTHESIZED`` every cell the entry points synthesize
    while the context lasts; yields a list whose one item becomes the
    host seconds they spent synthesizing."""
    from repro_torch.accel import sweep_exec

    spent = [0.0]

    def wrap(original):
        def synthesize_cell(spec):
            t0 = time.perf_counter()
            cell = original(spec)
            spent[0] += time.perf_counter() - t0
            SYNTHESIZED[spec_key(spec)] = cell
            return cell
        return synthesize_cell

    with patched(sweep_exec, "synthesize_cell", wrap):
        yield spent


def cells_of(specs) -> list[dict]:
    """The cells of ``specs``, from ``SYNTHESIZED`` where recorded."""
    from repro_torch.accel import synthesize_cell

    out = []
    for s in specs:
        key = spec_key(s)
        if key not in SYNTHESIZED:
            SYNTHESIZED[key] = synthesize_cell(s)
        out.append(SYNTHESIZED[key])
    return out


# ---------------------------------------------------------------------------
def phase_environment():
    from repro_torch import _build

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for info in _build.BUILD_INFO.values()
        for line in info["log"].splitlines()
        if "spill" in line or "Used" in line or "Compiling" in line
    ]
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         build_s=round(build_s, 3),
         builds={k: round(v["seconds"], 3)
                 for k, v in _build.BUILD_INFO.items()},
         ptxas=ptxas)
    return card


def wf_rows(rng, b, w):
    caps = rng.integers(0, 50, (b, w)).astype(np.float64)
    caps[rng.random((b, w)) < 0.2] = 0.0
    ws = rng.uniform(0.5, 2.0, (b, w))
    live = rng.random((b, w)) < 0.7
    slots = rng.uniform(0.0, caps.sum(1) * 1.2 + 1.0)
    return caps, ws, slots, live


def to_dev(caps, ws, slots, live, dev):
    return (torch.as_tensor(caps, dtype=torch.float64, device=dev),
            torch.as_tensor(ws, dtype=torch.float64, device=dev),
            torch.as_tensor(slots, dtype=torch.float64, device=dev),
            torch.as_tensor(live, dtype=torch.bool, device=dev))


def wf_bound(launches) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops) over water-fill launches, each
    ``(ws, phases)`` with ``phases`` a list of ``(caps, slots, live)``
    (one for a single call, two for a pair): ``ws`` read once, each
    phase's caps, live mask and slots read once and its output written
    once, and the rounds these inputs need (counted by the plain
    version)."""
    from repro_torch.accel import waterfill as wf

    nbytes = ops = 0
    for ws, phases in launches:
        b, w = ws.shape
        nbytes += b * w * 8
        for caps, slots, live in phases:
            nbytes += b * w * (8 + 1 + 8) + b * 8
            _, rounds = wf._fill_rounds(
                *wf._padded(caps, ws, slots, live)[:4])
            ops += int(rounds.sum()) * wf._bucket(w) * WF_OPS_PER_LANE_ROUND
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F64_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def pair_launch(pair):
    """A captured pair ``(caps_m, caps_r, ws, slots_m, slots_r, live_m,
    live_r)`` as :func:`wf_bound` takes it."""
    caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r = pair
    return ws, [(caps_m, slots_m, live_m), (caps_r, slots_r, live_r)]


def phase_kernel_vs_plain():
    from repro_torch.accel import waterfill as wf

    dev = torch.device("cuda")
    rng = np.random.default_rng(2013)
    cases = []
    for b, w in ((64, 8), (64, 32), (64, 128), (64, 1024), (64, 3072),
                 (64, 5120), (1, 8), (1, 128), (1, 1024)):
        m, r = wf_rows(rng, b, w), wf_rows(rng, b, w)
        if b > 1:  # rows whose guard is false at entry
            m[3][0] = False  # no live lane
            r[2][1] = 0.0  # no free slot
        cases.append((f"random-B{b}-W{w}", m, r))
    # The degenerate rows of tests/test_accel.py: no live entries, no
    # free slots, slots exceeding total caps.
    for name, slots, live in (("no-live", 10.0, np.zeros(8, bool)),
                              ("no-slots", 0.0, np.ones(8, bool)),
                              ("excess-slots", 1e6, np.ones(8, bool))):
        rows = (np.arange(8.0)[None], np.ones((1, 8)), np.array([slots]),
                live[None])
        cases.append((name, rows, rows))
    for name, m, r in cases:
        caps_m, ws, slots_m, live_m = to_dev(*m, dev)
        caps_r, _, slots_r, live_r = to_dev(*r, dev)
        pair = (caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r)
        before = wf.launches
        got = wf.water_fill_cuda(caps_m, ws, slots_m, live_m)
        again = wf.water_fill_cuda(caps_m, ws, slots_m, live_m)
        got_pair = wf.water_fill_pair_cuda(*pair)
        again_pair = wf.water_fill_pair_cuda(*pair)
        want = wf.water_fill_pair_reference(*pair)
        torch.cuda.synchronize()
        if wf.launches != before + 4:
            raise AssertionError(f"{name}: launch counter did not advance "
                                 "by one per call and pair")
        for label, g, w in (("single", got, want[0]),
                            ("pair MAP", got_pair[0], want[0]),
                            ("pair REDUCE", got_pair[1], want[1])):
            if not torch.equal(bits(g), bits(w)):
                err = (g - w).abs().max().item()
                raise AssertionError(f"{name}: {label} != plain ({err})")
        for g, a in ((got, again), *zip(got_pair, again_pair)):
            if not torch.equal(bits(g), bits(a)):
                raise AssertionError(f"{name}: kernel rerun not bitwise equal")
        single = (caps_m, ws, slots_m, live_m)
        ms = graph_ms(lambda: [wf.water_fill_cuda(*single)
                               for _ in range(20)]) / 20
        pair_ms = graph_ms(lambda: [wf.launch_pair(*pair)
                                    for _ in range(20)]) / 20
        call_ms = cuda_ms(lambda: wf.water_fill_cuda(*single), 50)
        plain_ms = cuda_ms(lambda: wf.water_fill_reference(*single), 5)
        bound_ms, bound_by, _, _ = wf_bound(
            [(ws, [(caps_m, slots_m, live_m)])])
        emit("kernel_vs_plain", case=name, shape=list(ws.shape),
             bitwise_equal=True, max_abs_err=0.0, ms=ms, pair_ms=pair_ms,
             call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
             bound_by=bound_by)


def main_matrix():
    from repro_torch.scenarios.presets import paper_fb_base
    from repro_torch.scenarios.spec import SweepSpec

    sweep = SweepSpec(
        name="accel-bench",
        base=paper_fb_base(seed=0),  # full scale: 100 jobs, 100 machines
        grids=(SweepSpec.grid(**{
            "workload.seed": SEEDS,
            "scheduler.policy": POLICIES,
            "scheduler.error_alpha": ALPHAS,
        }),),
    )
    return [s for _, s in sweep.expand()]


def check_matrix(specs, results, n_jobs):
    by = {}
    for spec, res in zip(specs, results):
        if res["compute"] != "accel" or res["jobs_completed"] != n_jobs \
                or res["jobs_lost"] != 0:
            raise AssertionError(f"incomplete cell {spec.to_dict()}: {res}")
        if not np.isfinite(res["mean_sojourn_s"]) or res["mean_sojourn_s"] <= 0:
            raise AssertionError(f"bad sojourn {res}")
        by[(spec.workload.seed, spec.scheduler.policy,
            spec.scheduler.error_alpha)] = res
    return by


def phase_main_path():
    from repro_torch.accel import run_cells_accel
    from repro_torch.accel import waterfill as wf

    specs = main_matrix()
    assert len(specs) == 64
    reset_counts()
    t0 = time.perf_counter()
    with recording_cells() as synth:
        cold = run_cells_accel(specs, device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    synth_s = synth[0]
    launches = wf.launches

    # Warm and plain: the same call handed the cells the cold run made.
    cells = cells_of(specs)
    t0 = time.perf_counter()
    warm = run_cells_accel(specs, device="cuda", cells=cells)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    plain = run_cells_accel(specs, device="cuda", impl="torch", cells=cells)

    if drop_wall(cold) != drop_wall(warm):
        raise AssertionError("warm rerun differs from cold run")
    if drop_wall(cold) != drop_wall(plain):
        raise AssertionError("plain water-fill run differs from kernel run")
    by = check_matrix(specs, cold, 100)
    ordering = {}
    for seed in SEEDS:
        fifo = by[(seed, "fifo", 0.0)]["mean_sojourn_s"]
        for pol in ("hfsp", "srpt"):
            if not by[(seed, pol, 0.0)]["mean_sojourn_s"] < fifo:
                raise AssertionError(f"seed {seed}: {pol} not below fifo")
        ordering[seed] = {p: by[(seed, p, 0.0)]["mean_sojourn_s"]
                          for p in POLICIES}
    # The device path alone: each compute class's packed batch through
    # run_packed, synthesis excluded.
    from repro_torch.accel import cell_step

    stepping = {}
    for klass, impl in (("plain", "none"), ("hfsp", None)):
        packed = cell_step.pack_cells(cells_of([
            s for s in specs
            if (s.scheduler.policy == "hfsp") == (klass == "hfsp")]))
        params = cell_step.params_from_numpy(packed, "cuda")
        t0 = time.perf_counter()
        final = cell_step.run_packed(params, impl=impl)
        stepping[klass] = {
            "cells": int(packed["arrival"].shape[0]),
            "width": int(packed["arrival"].shape[1]),
            "steps_run": int(final["steps"].max() + 511) // 512 * 512,
            "wall_s": time.perf_counter() - t0,
        }
    hfsp_steps = sum(by[(s, "hfsp", a)]["accel_steps"]
                     for s in SEEDS for a in ALPHAS)
    max_hfsp_steps = max(by[(s, "hfsp", a)]["accel_steps"]
                         for s in SEEDS for a in ALPHAS)
    # One K1 launch (both virtual clusters) per step of the hfsp batch,
    # which runs whole chunks of 512 steps until its last cell is done.
    steps_run = -(-max_hfsp_steps // 512) * 512
    if launches != steps_run:
        raise AssertionError(f"main path: {launches} water-fill launches, "
                             f"want one per hfsp step ({steps_run})")
    emit("main_path", cells=len(specs), jobs_per_cell=100,
         cold_s=cold_s, warm_cells_given_s=warm_s,
         cold_cells_per_s=len(specs) / cold_s,
         warm_cells_given_cells_per_s=len(specs) / warm_s,
         synthesize_s=synth_s, run_packed=stepping,
         waterfill_launches=launches,
         max_hfsp_steps=max_hfsp_steps, hfsp_cell_steps=hfsp_steps,
         steps={f"{s}/{p}": by[(s, p, 0.0)]["accel_steps"]
                for s in SEEDS for p in POLICIES},
         mean_sojourn_alpha0=ordering,
         plain_equal=True)
    return launches


def phase_wide_rows():
    from repro_torch.accel import run_cells_accel
    from repro_torch.accel import waterfill as wf
    from repro_torch.scenarios.presets import paper_fb_base

    specs = [
        paper_fb_base(seed=seed).override(**{
            "workload.kind": "fb_scaled", "workload.num_jobs": 1000,
            "cluster.num_machines": 100,
        })
        for seed in range(4)
    ]
    reset_counts()
    t0 = time.perf_counter()
    with recording_cells():
        res = run_cells_accel(specs, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wf.launches
    plain = run_cells_accel(specs, device="cuda", impl="torch",
                            cells=cells_of(specs))
    if launches <= 0:
        raise AssertionError("wide path launched no water-fill kernel")
    if drop_wall(res) != drop_wall(plain):
        raise AssertionError("wide rows: plain water-fill run differs")
    check_matrix(specs, res, 1000)
    emit("wide_rows", cells=len(specs), jobs_per_cell=1000, width=1024,
         wall_s=wall, waterfill_launches=launches,
         steps=[r["accel_steps"] for r in res],
         mean_sojourn_s=[r["mean_sojourn_s"] for r in res],
         plain_equal=True)
    return specs


def captured_calls(specs, n_steps: int):
    """Water-fill inputs of the packed batch of ``specs`` as the cell step
    hands them to K1, one pair ``(caps_m, caps_r, ws, slots_m, slots_r,
    live_m, live_r)`` per step, over its first ``n_steps`` steps."""
    from repro_torch.accel import cell_step
    from repro_torch.accel import waterfill as wf

    params = cell_step.params_from_numpy(
        cell_step.pack_cells(cells_of(specs)), "cuda")
    state = cell_step._to_tensors(
        cell_step.init_state({k: v.cpu().numpy() for k, v in params.items()}),
        params["arrival"].device)
    wf.check_batch(params["weight"], params["map_slots"], params["red_slots"])
    calls = []

    def record(*pair):
        calls.append(pair)
        return wf.launch_pair(*pair)

    with torch.no_grad():
        for _ in range(n_steps):
            state = cell_step._cell_step(params, state, record)
    torch.cuda.synchronize()
    return params, state, calls


def k1_timing(pairs) -> dict:
    """K1 on captured pairs: bitwise against the plain version as pairs
    and as single-phase calls; device time per pair launch and per
    single-phase call, each replayed from a CUDA graph; host time per step
    as the main path pays it (one ``launch_pair``) and as two checked
    single calls pay it; the plain version's time; the bound; and the
    rounds the inputs need."""
    from repro_torch.accel import waterfill as wf

    singles = [c for p in pairs
               for c in ((p[0], p[2], p[3], p[5]), (p[1], p[2], p[4], p[6]))]
    got = [wf.launch_pair(*p) for p in pairs]
    got_singles = [wf.water_fill_cuda(*c) for c in singles]
    want = [wf.water_fill_pair_reference(*p) for p in pairs]
    torch.cuda.synchronize()
    flat_want = [w for pair in want for w in pair]
    flat_got = [g for pair in got for g in pair]
    max_err = max((g - w).abs().max().item()
                  for g, w in zip(flat_got, flat_want))
    if not all(torch.equal(bits(g), bits(w))
               for g, w in zip(flat_got + got_singles, flat_want * 2)):
        raise AssertionError(f"captured inputs: kernel != plain ({max_err})")

    def run_all(fn, calls):
        return lambda: [fn(*c) for c in calls]

    def host_s(fn, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in calls:
            fn(*c)
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t

    n = len(pairs)
    pair_ms = graph_ms(run_all(wf.launch_pair, pairs)) / n
    single_ms = graph_ms(run_all(wf.water_fill_cuda, singles)) / len(singles)
    host_pair = min(host_s(wf.launch_pair, pairs) for _ in range(3)) / n
    host_singles = min(host_s(wf.water_fill_cuda, singles)
                       for _ in range(3)) / n
    call_ms = cuda_ms(run_all(wf.launch_pair, pairs), 5) / n
    plain_ms = cuda_ms(run_all(wf.water_fill_pair_reference, pairs), 2) / n
    bound_total, bound_by, nbytes, ops = wf_bound(
        [pair_launch(p) for p in pairs])
    slowest = []  # rounds of the slowest row of each launch
    for caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r in pairs:
        _, r = wf._fill_rounds(torch.cat([caps_m, caps_r]),
                               torch.cat([ws, ws]),
                               torch.cat([slots_m, slots_r]),
                               torch.cat([live_m, live_r]))
        slowest.append(int(r.max()))
    return {
        "shape": list(pairs[0][2].shape), "steps": n,
        "ms_per_launch": pair_ms, "ms_per_hfsp_step": pair_ms,
        "single_phase_ms": single_ms, "two_singles_ms_per_step": 2 * single_ms,
        "host_us_per_step": host_pair * 1e6,
        "two_singles_host_us_per_step": host_singles * 1e6,
        "call_ms": call_ms, "plain_ms": plain_ms,
        "bound_ms": bound_total / n, "bound_by": bound_by,
        "bytes_per_launch": nbytes / n, "ops_per_launch": ops / n,
        "max_abs_err": max_err,
        "rounds_slowest_row": {"sum": sum(slowest), "max": max(slowest),
                               "mean": sum(slowest) / n},
    }


def hfsp_batch_by_name(specs) -> tuple[int, int]:
    """The K1 kernels the packed batch of ``specs`` launches, by name:
    ``run_packed`` runs it with each chunk captured in a CUDA graph, whose
    kernel nodes libcuda names (``graph_kernel_names``), then replayed.
    Returns (the kernels whose name holds "waterfill", the chunks)."""
    from repro_torch.accel import cell_step

    by_chunk = []

    def in_graph(chunk, state):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = chunk(state)
        by_chunk.append(sum("waterfill" in n
                            for n in graph_kernel_names(graph)))
        graph.replay()
        return out

    cell_step.run_packed(cell_step.params_from_numpy(
        cell_step.pack_cells(cells_of(specs)), "cuda"), run_chunk=in_graph)
    return sum(by_chunk), len(by_chunk)


def phase_kernel_timing(main_launches: int, wide_specs):
    from repro_torch.accel import cell_step
    from repro_torch.accel import waterfill as wf

    hfsp_specs = [s for s in main_matrix() if s.scheduler.policy == "hfsp"]
    params, state, pairs = captured_calls(hfsp_specs, 256)
    paper = k1_timing(pairs)
    emit("k1_timing", cell="paper-64 hfsp batch", **paper)
    del pairs
    _, _, wide_pairs = captured_calls(wide_specs, 256)
    wide = k1_timing(wide_pairs)
    emit("k1_timing", cell="fb-1000-wide", **wide)
    del wide_pairs
    # The floor any launch pays: a one-element add_, graph-replayed as K1.
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda: [one.add_(1.0) for _ in range(256)]) / 256
    emit("launch_floor", op="one-element add_", ms_per_launch=floor_ms)

    # The main path's K1 launches by kernel name: its hfsp batch once more,
    # counted by libcuda's graph API in graphs of its chunks.  The
    # profiler is no count: it has lost K1 records at random (1021 of
    # 1024 over the whole batch, 1022 summed over windows of 64 steps).
    by_name, chunks = hfsp_batch_by_name(hfsp_specs)
    if by_name != main_launches:
        raise AssertionError(f"hfsp batch: {by_name} water-fill kernels by "
                             f"name in {chunks} chunk graphs, want "
                             f"{main_launches}")
    emit("main_path_by_name", waterfill_launches=by_name, chunks=chunks,
         counted_by="libcuda, kernel nodes of each chunk's graph")
    # The kernels one hfsp step launches, by name, counted by libcuda's
    # graph API in a graph of the step (the profiler's count below may
    # miss a few): K1 once.
    with torch.no_grad():
        step_kernels = graph_kernels(
            lambda: cell_step._cell_step(params, state, wf.launch_pair))
    step_k1 = sum("waterfill" in n for n in step_kernels)
    if step_k1 != 1:
        raise AssertionError(f"one hfsp step's graph holds {step_k1} "
                             "water-fill kernels, want 1")

    # Short profile of the hfsp step: device time by kernel and the
    # device's busy share of the wall.
    from torch.profiler import ProfilerActivity, profile

    n_prof = 32
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n_prof):
                state = cell_step._cell_step(params, state, wf.launch_pair)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    total_dev_us = sum(ev.self_device_time_total for ev in kernels)
    wf_events = [ev for ev in kernels if "waterfill" in ev.key]
    wf_us = sum(ev.self_device_time_total for ev in wf_events)
    wf_count = sum(ev.count for ev in wf_events)
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:5]
    measured = total_dev_us > 0
    emit("profile_hfsp_step", steps=n_prof, batch=list(params["arrival"].shape),
         wall_ms_per_step=wall / n_prof * 1e3,
         device_ms_per_step=(total_dev_us / n_prof / 1e3) if measured
         else "not measured",
         device_busy_share=(total_dev_us / 1e6 / wall) if measured
         else "not measured",
         kernel_launches_per_step=sum(ev.count for ev in kernels) / n_prof,
         kernel_launches_per_step_by_graph=len(step_kernels),
         waterfill_launches_per_step_by_graph=step_k1,
         waterfill_launches_per_step=wf_count / n_prof,
         waterfill_share_of_device=(wf_us / total_dev_us) if measured
         else "not measured",
         waterfill_device_us_per_launch=(wf_us / wf_count) if wf_count
         else "not measured",
         top_kernels_us=[[ev.key[:70], ev.count, ev.self_device_time_total]
                         for ev in top])

    return {
        "name": "waterfill",
        "route": "cuda",
        "source": "src/repro_torch/accel/csrc/waterfill.cu",
        "replaces": "src/repro/accel/waterfill_pallas.py:77",
        "launches": main_launches,
        "max_abs_err": max(paper["max_abs_err"], wide["max_abs_err"]),
        "ms": paper["ms_per_launch"],
        "plain_ms": paper["plain_ms"],
        "bound_ms": paper["bound_ms"],
        "bound_by": paper["bound_by"],
        "library_ms": None,
        "call_ms": paper["call_ms"],
        "shape": [2] + paper["shape"],
        "timed_launches": paper["steps"],
        "bytes_per_launch": paper["bytes_per_launch"],
        "ops_per_launch": paper["ops_per_launch"],
        "single_phase_ms": paper["single_phase_ms"],
        "host_us_per_step": paper["host_us_per_step"],
        "launch_floor_ms": floor_ms,
        "wide_4x1024": {k: wide[k] for k in (
            "ms_per_launch", "single_phase_ms", "plain_ms", "bound_ms",
            "bound_by")},
    }


# ---------------------------------------------------------------------------
# The discrete-event path: the simulator, HFSP's virtual clusters on K1
# and the projection kernel
# ---------------------------------------------------------------------------
#: f64 operations of the projection per lane its work touches, as the
#: plain version writes it: per level step and part lane (live, weight >
#: 0), the two masked sums' adds and the below-level test's multiply, add
#: and compare; per event and part lane, the allocation's multiply and
#: min; per event and live lane, the event time's divide, the least-time
#: compare, the ageing's multiply, subtract and max, and the finish
#: test's compare.  Finished and padding lanes do nothing.
PROJ_OPS_PER_PART_LANE_LEVEL = 5
PROJ_OPS_PER_PART_LANE_EVENT = 2
PROJ_OPS_PER_LIVE_LANE_EVENT = 6
#: The paper-fb disciplines of the discrete-event path: (name, spec
#: overrides).
DES_POLICIES = (
    ("fifo", {"scheduler.policy": "fifo"}),
    ("fair", {"scheduler.policy": "fair"}),
    ("hfsp", {"scheduler.policy": "hfsp"}),
    ("hfsp-kill", {"scheduler.policy": "hfsp",
                   "scheduler.preemption": "kill"}),
    ("srpt", {"scheduler.policy": "srpt"}),
    ("las", {"scheduler.policy": "las"}),
    ("psbs", {"scheduler.policy": "psbs"}),
)
#: The scheduler-overhead stress cell of benchmarks/bench_sched_overhead.py:
#: fb_scaled, 5000 jobs on 1000 machines, hfsp; stopped at 10000 events
#: (the benchmark's budget is 20000, cut for the script's time limit).
STRESS_JOBS, STRESS_MACHINES, STRESS_EVENTS = 5000, 1000, 10000


def project_rows(rng, b, w, *, inf_frac=0.1, zero_w=0.1):
    """Random projection rows (numpy, as the projection takes them): rem
    with a share of infinite-size jobs, integer caps (some 0), weights
    (some 0), all lanes present, slots, now and lam0 = 0."""
    rem = rng.uniform(0.0, 400.0, (b, w))
    rem[rng.random((b, w)) < inf_frac] = np.inf
    caps = rng.integers(0, 15, (b, w)).astype(np.float64)
    ws = rng.uniform(0.5, 2.0, (b, w))
    ws[rng.random((b, w)) < zero_w] = 0.0
    slots = rng.integers(1, max(2, w // 2), b).astype(np.float64)
    return [rem, caps, ws, np.ones((b, w), bool), slots,
            rng.uniform(0.0, 1e4, b), np.zeros(b)]


def project_cases(seed: int = 2013):
    """(name, rows, floor) cases of the projection kernel against its
    plain version: B = 1 at widths 8, 256 and 1024, and at 5120 (run in
    segments with host compaction, as ``vcluster_torch.segments`` runs
    it); batches with ``n_valid`` (a row with no present lane); a row of
    only infinite-size jobs, a row of zero weights and a row resumed at a
    level lam0 > 0; a width that is not a bucket width; two rows stopped
    at a floor; a row of only infinite-size jobs on its own; a row whose
    jobs all finish in one event; ragged widths 33, 257 and 1025; B = 3
    rows of 300, 120 and 7 present lanes; rows with lanes not present,
    of no work and of zero weight."""
    rng = np.random.default_rng(seed)
    cases = [(f"B1-W{w}", project_rows(rng, 1, w), 0) for w in (8, 256, 1024)]
    cases.append(("B1-W5120-segmented", project_rows(rng, 1, 5120), None))
    rows = project_rows(rng, 3, 200)
    for i, nv in enumerate((200, 50, 0)):
        rows[3][i, nv:] = False
    cases.append(("B3-W200-n_valid", rows, 0))
    cases.append(("B2-W256-two-phases", project_rows(rng, 2, 256), 0))
    rows = project_rows(rng, 4, 64)
    rows[0][0] = np.inf  # only infinite-size jobs
    rows[2][1] = 0.0  # zero weights
    rows[6][2] = 0.05  # resumed at a level
    cases.append(("B4-W64-inf-zero-weights-lam0", rows, 0))
    cases.append(("B4-W77-padded", project_rows(rng, 4, 77), 0))
    cases.append(("B2-W1024-floor512", project_rows(rng, 2, 1024), 512))
    rows = project_rows(rng, 1, 128)
    rows[0][:] = np.inf
    rows[1][rows[1] == 0.0] = 1.0  # every job live, none finishes
    cases.append(("B1-W128-only-infinite", rows, 0))
    rows = project_rows(rng, 1, 64)
    rows[1][rows[1] == 0.0] = 1.0
    rows[2][rows[2] == 0.0] = 1.0
    rows[0] = 3.0 * rows[1]  # all capped, all done at now + 3
    rows[4][:] = rows[1].sum() + 1.0
    cases.append(("B1-W64-one-event", rows, 0))
    for w in (33, 257, 1025):
        cases.append((f"B1-W{w}-ragged", project_rows(rng, 1, w), 0))
    rows = project_rows(rng, 3, 300)
    for i, nv in enumerate((300, 120, 7)):
        rows[3][i, nv:] = False
    cases.append(("B3-W300-live-counts", rows, 0))
    rows = project_rows(rng, 2, 128)
    rows[3][rng.random((2, 128)) < 0.3] = False
    rows[0][rng.random((2, 128)) < 0.1] = 0.0
    rows[2][rng.random((2, 128)) < 0.3] = 0.0
    cases.append(("B2-W128-dead-zero-weight", rows, 0))
    return cases


def project_segmented_cases(seed: int = 2025):
    """(name, rows) cases of the kernel's one-launch segmented route
    against the host-segmented plain path: B = 1 at widths 1024, 2048
    and 5120, and B = 2 rows of 2048 lanes, the second with 700 present."""
    rng = np.random.default_rng(seed)
    cases = [(f"B1-W{w}-device-segments", project_rows(rng, 1, w))
             for w in (1024, 2048, 5120)]
    rows = project_rows(rng, 2, 2048)
    rows[3][1, 700:] = False
    cases.append(("B2-W2048-device-segments", rows))
    return cases


def project_tensors(rows, dev):
    rem, caps, ws, present, slots, now, lam0 = rows
    f = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    return [f(rem), f(caps), f(ws),
            torch.as_tensor(present, dtype=torch.bool, device=dev),
            f(slots), f(now), f(lam0)]


def carry_equal(got, want) -> bool:
    """The projection's carries ``(t, rem, fin, live, lam, n_live, run)``
    are equal bit for bit."""
    for g, w in zip(got, want):
        if g.dtype == torch.float64:
            g, w = bits(g), bits(w)
        if g.shape != w.shape or not torch.equal(g, w):
            return False
    return True


def fin_err(got, want) -> float:
    """The largest difference of the finite finish times of two carries."""
    fin = torch.isfinite(want[2])
    if not bool(fin.any()):
        return 0.0
    return (got[2][fin] - want[2][fin]).abs().max().item()


def project_segments(pj, args):
    """A B = 1 row in segments through ``vcluster_torch.segments``, the
    host loop ``project_finish_times`` runs on the CPU: each segment's
    kernel call repeated and held bitwise against the plain version.
    Returns the segments' calls ``(args, floor, False)``."""
    from repro_torch.core import vcluster_torch as vt

    calls = []
    for _, seg, floor, got in vt.segments(args):
        again = pj.project_cuda(*seg, floor)
        want = pj.project_reference(*seg, floor)
        if not (carry_equal(got, want) and carry_equal(again, got)):
            raise AssertionError(f"segment {len(calls)} at width "
                                 f"{seg[0].shape[1]}: kernel != plain")
        calls.append((seg, floor, False))
    return calls


def project_segmented_check(pj, args) -> None:
    """The kernel's one-launch segmented route on CUDA tensors ``args``
    against the host-segmented plain path (``project_segmented_reference``
    on the same device), bitwise on every output, with a bitwise rerun and
    one launch a call."""
    before = pj.launches
    got = pj.project_cuda(*args, 0, segmented=True)
    again = pj.project_cuda(*args, 0, segmented=True)
    torch.cuda.synchronize()
    if pj.launches != before + 2:
        raise AssertionError("segmented route: not one launch a call")
    want = pj.project_segmented_reference(*args)
    if not carry_equal(got, want):
        raise AssertionError(f"segmented route != host segments "
                             f"({fin_err(got, want)})")
    if not carry_equal(again, got):
        raise AssertionError("segmented route: rerun not bitwise equal")


def proj_bound(calls) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops) over projection calls ``(args,
    floor, segmented)``: each row's rem, caps, ws (8 bytes a lane),
    present (1) and slots, now, lam0 read once, and rem, fin (8), live
    (1), t, lam, n_live (8) and run (1) written once; the lanes that the
    level steps and events these inputs need touch (counted by the plain
    version on the CPU, in segments where the call is segmented) at
    ``PROJ_OPS_PER_*`` operations each."""
    from repro_torch.core import projection as pj

    nbytes = ops = 0
    for args, floor, segmented in calls:
        cpu = [a.cpu() for a in args]
        b, w = cpu[0].shape
        nbytes += b * (w * (25 + 17) + 24 + 25)
        counts = {}
        if segmented:
            pj.project_segmented_reference(*cpu, counts=counts)
        else:
            pj.project_reference(*cpu, floor, counts=counts)
        ops += (counts.get("level_lanes", 0) * PROJ_OPS_PER_PART_LANE_LEVEL
                + counts.get("event_part_lanes", 0)
                * PROJ_OPS_PER_PART_LANE_EVENT
                + counts.get("event_live_lanes", 0)
                * PROJ_OPS_PER_LIVE_LANE_EVENT)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F64_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def project_split(calls) -> dict:
    """Where an event's cycles go, over projection calls ``(args, floor,
    segmented)``: each call once through the ``project_clocks`` build
    (its carry must equal the main build's bitwise), every row's phase
    cycles summed (``projection.CLOCK_FIELDS``; thread 0's ``clock64``
    stamps).  Returns the events and level steps per call, the cycles per
    event of each phase and of the whole kernel, and each phase's share of
    the kernel's cycles."""
    from repro_torch.core import projection as pj

    fields = pj.CLOCK_FIELDS
    total = dict.fromkeys(fields, 0)
    for args, floor, segmented in calls:
        clocks = torch.zeros((args[0].shape[0], len(fields)),
                             dtype=torch.int64, device=args[0].device)
        got = pj.project_cuda(*args, floor, segmented=segmented,
                              clocks=clocks)
        want = pj.project_cuda(*args, floor, segmented=segmented)
        if not carry_equal(got, want):
            raise AssertionError("the clocks build's carry != the kernel's")
        for f, v in zip(fields, clocks.sum(dim=0).tolist()):
            total[f] += v
    events = max(1, total["events"])
    phases = fields[2:]
    return {
        "events_per_call": total["events"] / len(calls),
        "level_steps_per_call": total["level_steps"] / len(calls),
        "cycles_per_event": {f: total[f] / events for f in phases},
        "share_of_cycles": {f: total[f] / max(1, total["total"])
                            for f in phases[:-1]},
    }


def des_counts() -> dict:
    """K1's and the projection kernel's launches, and the calls the
    virtual clusters made at the ``vcluster_torch`` entry points."""
    from repro_torch.accel import waterfill as wf
    from repro_torch.core import projection as pj
    from repro_torch.core import vcluster_torch as vt

    return {"k1_launches": wf.launches, "project_launches": pj.launches,
            "water_fill_calls": vt.calls["water_fill"],
            "project_calls": vt.calls["project"]}


def check_des_counts(cell: str, c: dict) -> None:
    if not (c["k1_launches"] > 0 and c["project_launches"] > 0):
        raise AssertionError(f"{cell}: a kernel of the path did not launch: "
                             f"{c}")
    if c["k1_launches"] != c["water_fill_calls"] or \
            c["project_launches"] != c["project_calls"]:
        raise AssertionError(f"{cell}: launches != calls at the vcluster_torch "
                             f"entry points: {c}")


class TimedScheduler:
    """A scheduler whose every ``schedule()`` pass is timed, as
    benchmarks/bench_sched_overhead.py's ``_TimedScheduler`` does."""

    def __init__(self, inner):
        self._inner = inner
        self.pass_times: list[float] = []

    def schedule(self, view, now):
        t0 = time.perf_counter()
        actions = self._inner.schedule(view, now)
        self.pass_times.append(time.perf_counter() - t0)
        return actions

    def __getattr__(self, name):
        return getattr(self._inner, name)


def stress_cell(backend: str) -> dict:
    """The stress cell with ``backend``'s virtual clusters (on the card
    for "torch"), stopped at its event budget as bench_sched_overhead's
    ``run_cell`` stops it."""
    from repro_torch.core import HFSPConfig, HFSPScheduler, Simulator
    from repro_torch.core.simulator import EventLimitReached
    from repro_torch.core.types import ClusterSpec
    from repro_torch.workload import fb_scaled_dataset

    jobs, _ = fb_scaled_dataset(seed=0, num_jobs=STRESS_JOBS,
                                num_machines=STRESS_MACHINES)
    cluster = ClusterSpec(num_machines=STRESS_MACHINES)
    sch = TimedScheduler(HFSPScheduler(cluster, HFSPConfig(
        vc_backend=backend, vc_device="cuda")))
    sim = Simulator(cluster, sch, jobs)
    t0 = time.perf_counter()
    try:
        sim.run(max_events=STRESS_EVENTS)
    except EventLimitReached:
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = sorted(sch.pass_times)
    n = len(times)
    return {
        "completion": dict(sim.result.completion), "passes": sim.passes,
        "events": sim.events_processed, "sim_t": sim._now, "wall_s": wall,
        "events_per_s": sim.events_processed / wall,
        "mean_pass_ms": 1e3 * sum(times) / n,
        "p99_pass_ms": 1e3 * times[min(n - 1, int(0.99 * n))],
    }


def phase_des_main_path():
    """paper-fb at full width under every discipline and the stress cell,
    each through the port's discrete-event path with the torch virtual
    clusters on the card, against the port's own numpy virtual clusters.
    Returns the launches by cell."""
    from repro_torch.scenarios.presets import paper_fb_base
    from repro_torch.scenarios.runner import run_scenario

    base = paper_fb_base()  # 100 jobs on 100 machines
    specs = {name: base.override(**over) for name, over in DES_POLICIES}
    reset_counts()
    got, torch_s = {}, {}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        got[name] = run_scenario(
            spec.override(**{"scheduler.vc_backend": "torch"}), device="cuda")
        torch_s[name] = time.perf_counter() - t0
    paper = des_counts()
    check_des_counts("paper-fb", paper)
    numpy_s = {}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        want = run_scenario(
            spec.override(**{"scheduler.vc_backend": "numpy"}), device="cuda")
        numpy_s[name] = time.perf_counter() - t0
        g, w = ({k: v for k, v in r.items() if k not in ("spec", "wall_s")}
                for r in (got[name], want))
        if g != w:
            raise AssertionError(f"paper-fb {name}: torch report != numpy: "
                                 f"{[k for k in g if g[k] != w[k]]}")
        if g["jobs_completed"] != 100 or g["jobs_lost"] != 0:
            raise AssertionError(f"paper-fb {name}: incomplete {g}")
    sojourn = {n: r["mean_sojourn_s"] for n, r in got.items()}
    if not sojourn["hfsp"] < sojourn["fifo"]:
        raise AssertionError(f"paper-fb: hfsp not below fifo: {sojourn}")
    emit("des_paper_fb", jobs=100, machines=100, reports_equal=True,
         mean_sojourn_s=sojourn,
         passes={n: r["scheduler_passes"] for n, r in got.items()},
         torch_wall_s=torch_s, numpy_wall_s=numpy_s, **paper)

    # The stress cell, torch then numpy, each timed on its own.
    reset_counts()
    cuda_run = stress_cell("torch")
    stress = des_counts()
    check_des_counts("stress", stress)
    numpy_run = stress_cell("numpy")
    if cuda_run["completion"] != numpy_run["completion"] or \
            cuda_run["passes"] != numpy_run["passes"]:
        raise AssertionError("stress cell: torch and numpy runs differ")

    emit("des_stress", jobs=STRESS_JOBS, machines=STRESS_MACHINES,
         max_events=STRESS_EVENTS, completions=len(cuda_run["completion"]),
         completions_equal=True, passes_equal=True,
         **{f"torch_{k}": v for k, v in cuda_run.items() if k != "completion"},
         **{f"numpy_{k}": v for k, v in numpy_run.items()
            if k != "completion"}, **stress)
    return {"paper-fb": paper, "stress": stress}


def profiled_stress(stress: dict):
    """The stress cell once more with the torch virtual clusters, under
    the profiler: the device's busy share of the wall, and every
    projection's padded inputs recorded (the kernel only reads them, and
    nothing writes to them after the call).  The launches must equal the
    timed run's ``stress``.  Returns the recorded calls ``(args, floor,
    segmented)``."""
    from repro_torch.core import projection as pj

    captured = []
    project = pj.project

    def record(*args, segmented=False):
        captured.append((list(args[:7]), args[7], segmented))
        return project(*args, segmented=segmented)

    reset_counts()
    pj.project = record
    try:
        profiled = profile_device(
            lambda: stress_cell("torch"), 1,
            {"project_share_of_device": ("project_narrow", "project_rows"),
             "k1_share_of_device": "waterfill"})
    finally:
        pj.project = project
    if des_counts() != stress:
        raise AssertionError(f"profiled stress run: launches {des_counts()} "
                             f"!= {stress}")
    emit("des_stress_profile", widest_projection=max(
        a[0].shape[1] for a, _, _ in captured),
        segmented_projections=sum(seg for _, _, seg in captured), **profiled)
    return captured


def wrapped_call_us(fn, reps: int) -> float:
    """Host wall time of one call of a numpy-in, numpy-out ``fn``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


#: Live-job counts at which the wrapped calls are timed against numpy's.
WRAPPED_JOBS = (4, 8, 16, 64, 256, 1024, 2048, 4096, 8192)


def crossover(wrapped: dict, ours: str, numpy_key: str):
    """The least job count from which the wrapped call beats numpy's at
    every larger count measured; None if numpy wins at the largest."""
    at = None
    for n in sorted(wrapped, reverse=True):
        if wrapped[n][ours] >= wrapped[n][numpy_key]:
            break
        at = n
    return at


def phase_vcluster_wrapped_calls():
    """One call of ``vcluster_torch.water_fill`` and
    ``project_finish_times`` (numpy in and out, the host round trip
    included) against the numpy loops', by job count, and the "auto"
    latch's threshold each kernel's numbers give beside the one in
    ``core/vcluster.py``."""
    from repro_torch.core import vcluster as vc
    from repro_torch.core import vcluster_torch as vt

    rng = np.random.default_rng(11)
    wrapped = {}
    for n in WRAPPED_JOBS:
        rem, caps, ws, _, slots, now, _ = project_rows(rng, 1, n)
        rem, caps, ws = rem[0], caps[0], ws[0]
        s, t0 = float(slots[0]), float(now[0])
        reps = 200 if n <= 256 else 20
        preps = 50 if n <= 64 else (5 if n <= 1024 else 1)
        wrapped[n] = {
            "water_fill_us": wrapped_call_us(
                lambda: vt.water_fill(caps, ws, s, device="cuda"), reps),
            "numpy_water_fill_us": wrapped_call_us(
                lambda: vc._water_fill(caps, ws, s), reps),
            "project_us": wrapped_call_us(
                lambda: vt.project_finish_times(rem, caps, ws, s, t0,
                                                device="cuda"), preps),
            "numpy_project_us": wrapped_call_us(
                lambda: vc._project_array(rem, caps, ws, s, t0), preps),
        }
    measured = {
        "fill": crossover(wrapped, "water_fill_us", "numpy_water_fill_us"),
        "project": crossover(wrapped, "project_us", "numpy_project_us"),
    }
    in_code = {"fill": vc.AUTO_FILL_THRESHOLD,
               "project": vc.AUTO_PROJECT_THRESHOLD}
    emit("vcluster_wrapped_calls", by_jobs=wrapped,
         thresholds_this_run=measured, thresholds_in_code=in_code)
    return measured


def phase_project_kernel_vs_plain(des_launches: dict):
    from repro_torch.core import projection as pj
    from repro_torch.core import vcluster_torch as vt

    dev = torch.device("cuda")
    for name, rows, floor in project_cases():
        args = project_tensors(rows, dev)
        before = pj.launches
        if floor is None:
            segs = project_segments(pj, args)
            emit("project_kernel_vs_plain", case=name, segments=len(segs),
                 widths=[a[0].shape[1] for a, _, _ in segs],
                 bitwise_equal=True)
            continue
        got = pj.project_cuda(*args, floor)
        again = pj.project_cuda(*args, floor)
        want = pj.project_reference(*args, floor)
        torch.cuda.synchronize()
        if pj.launches != before + 2:
            raise AssertionError(f"{name}: launch counter did not advance by "
                                 "one per call")
        if not carry_equal(got, want):
            raise AssertionError(f"{name}: kernel != plain "
                                 f"({fin_err(got, want)})")
        if not carry_equal(again, got):
            raise AssertionError(f"{name}: kernel rerun not bitwise equal")
        emit("project_kernel_vs_plain", case=name, shape=list(args[0].shape),
             floor=floor, bitwise_equal=True, max_abs_err=0.0,
             n_live=got[5].tolist(), run=got[6].tolist())
    # The segmented route: one launch against the host's segments.
    for name, rows in project_segmented_cases():
        args = project_tensors(rows, dev)
        project_segmented_check(pj, args)
        emit("project_kernel_vs_plain", case=name, shape=list(args[0].shape),
             segmented=True, launches_per_call=1, bitwise_equal=True,
             max_abs_err=0.0)
    # ... and through the entry point: one call, one launch, the bits of
    # the host's segment loop on the CPU.
    rem, caps, ws, _, slots, now, _ = project_segmented_cases()[1][1]
    one = (rem[0], caps[0], ws[0], float(slots[0]), float(now[0]))
    calls, launches = vt.calls["project"], pj.launches
    got = vt.project_finish_times(*one, device="cuda")
    made = (vt.calls["project"] - calls, pj.launches - launches)
    want = vt.project_finish_times(*one, device="cpu")
    if made != (1, 1) or got.tobytes() != want.tobytes():
        raise AssertionError(f"project_finish_times at 2048 jobs: calls and "
                             f"launches {made}, equal to the CPU's "
                             f"{got.tobytes() == want.tobytes()}")
    emit("project_kernel_vs_plain", case="project_finish_times-2048",
         calls_and_launches=list(made), bitwise_equal_to_cpu=True)

    # Time at widths 16, 256 and 1024 (B = 1, random rows), with the
    # events a call runs and where an event's cycles go.
    rng = np.random.default_rng(7)
    by_width = {}
    for w in (16, 256, 1024, 128):  # 128 drawn last: the others keep their rows
        args = project_tensors(project_rows(rng, 1, w), dev)
        ms = graph_ms(lambda: [pj.project_cuda(*args) for _ in range(10)]) / 10
        plain_ms = cuda_ms(lambda: pj.project_reference(*args), 1)
        bound_ms, bound_by, nbytes, ops = proj_bound([(args, 0, False)])
        split = project_split([(args, 0, False)])
        by_width[w] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                       "us_per_event": 1e3 * ms / max(
                           1.0, split["events_per_call"]), **split}
    emit("project_timing", by_width=by_width)
    # The segmented route at 2048 and 5120 lanes: one launch (graph-
    # replayed) against the host's segments (a launch, a copy back and a
    # compaction each), both host wall to a synchronize.
    segmented = {}
    for name, rows in project_segmented_cases()[1:3]:
        args = project_tensors(rows, dev)

        def host_segments():
            for _ in vt.segments(args):
                pass
            torch.cuda.synchronize()

        def one_launch():
            pj.project_cuda(*args, 0, segmented=True)
            torch.cuda.synchronize()

        segmented[args[0].shape[1]] = {
            "ms": graph_ms(lambda: pj.project_cuda(*args, 0, segmented=True)),
            "one_launch_wall_us": wrapped_call_us(one_launch, 5),
            "host_segments_wall_us": wrapped_call_us(host_segments, 5),
            "host_segments": sum(1 for _ in vt.segments(args)),
            **project_split([(args, 0, True)])}
    emit("project_timing", segmented_route=segmented)

    phase_vcluster_wrapped_calls()
    # On the stress cell's own calls: all of them graph-replayed, and an
    # even subset beside the plain version and the bound.
    calls = profiled_stress(des_launches["stress"])

    def replay(chosen):
        return [pj.project_cuda(*a, f, segmented=s) for a, f, s in chosen]

    all_ms = graph_ms(lambda: replay(calls), replays=3) / len(calls)
    subset = calls[::max(1, len(calls) // 24)]
    ms = graph_ms(lambda: replay(subset)) / len(subset)
    plain_ms = cuda_ms(lambda: [
        (pj.project_segmented_reference(*a) if s
         else pj.project_reference(*a, f)) for a, f, s in subset], 1) \
        / len(subset)
    check = [(pj.project_cuda(*a, f, segmented=s),
              pj.project_segmented_reference(*a) if s
              else pj.project_reference(*a, f)) for a, f, s in subset]
    if not all(carry_equal(g, w) for g, w in check):
        raise AssertionError("stress cell's captured calls: kernel != plain")
    bound_total, bound_by, nbytes, ops = proj_bound(subset)
    split = project_split(calls)
    widths = [a[0].shape[1] for a, _, _ in calls]
    emit("project_timing", cell="stress", calls=len(calls),
         widths={str(w): widths.count(w) for w in sorted(set(widths))},
         segmented_calls=sum(s for _, _, s in calls),
         ms_all_calls=all_ms, subset=len(subset), ms=ms, plain_ms=plain_ms,
         bound_ms=bound_total / len(subset), bound_by=bound_by,
         bytes_per_call=nbytes / len(subset), ops_per_call=ops / len(subset),
         us_per_event=1e3 * all_ms / max(1.0, split["events_per_call"]),
         **split)

    launches = sum(c["project_launches"] for c in des_launches.values())
    return {
        "name": "project",
        "route": "cuda",
        "source": "src/repro_torch/core/csrc/project.cu",
        "replaces": "src/repro/core/vcluster_jax.py:155 (XLA lax.while_loop "
                    "_project_kernel, not a Pallas kernel)",
        "launches": launches,
        "launches_by_path": {k: c["project_launches"]
                             for k, c in des_launches.items()},
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_total / len(subset),
        "bound_by": bound_by,
        "library_ms": None,
        "ms_all_stress_calls": all_ms,
        "by_width": {w: {k: v for k, v in r.items()
                         if k in ("ms", "plain_ms", "bound_ms",
                                  "events_per_call", "us_per_event")}
                     for w, r in by_width.items()},
    }

# ---------------------------------------------------------------------------
# The scenario engine's entry points
# ---------------------------------------------------------------------------
#: A cell of ``paper-cluster-size`` with more live jobs a phase than the
#: "auto" latch's projection threshold: 100 FB jobs on 10 machines.
LATCH_CELL = ("paper-cluster-size",
              "cluster.num_machines=10,scheduler.policy=hfsp")
#: The order of the timed runs of each latch cell, after an untimed one.
LATCH_ORDER = ("numpy", "auto", "auto", "numpy")
#: Spawned workers of the CLI's sweep (the card's host has 8 cores).
CLI_WORKERS = 4


@contextlib.contextmanager
def vc_backend_env(backend: str):
    """``REPRO_VC_BACKEND`` set to ``backend`` inside the block."""
    import os

    old = os.environ.get("REPRO_VC_BACKEND")
    os.environ["REPRO_VC_BACKEND"] = backend
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_VC_BACKEND"]
        else:
            os.environ["REPRO_VC_BACKEND"] = old


@contextlib.contextmanager
def cli_process(*args: str, env: dict | None = None):
    """``python -m repro_torch.scenarios *args`` started from the
    checkout's root, as users run it, in a process group of its own:
    yields (process, start time) and, on leaving the block, kills the
    group (the CLI and its spawned workers) if it still runs."""
    import os
    import signal

    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.scenarios", *args], cwd=ROOT,
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        yield proc, time.perf_counter()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def finish_cli(started, timeout: float = 300.0):
    """Wait for a ``cli_process``; returns (seconds, stdout), raising on a
    non-zero exit."""
    proc, t0 = started
    out, err = proc.communicate(timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args[3:]} exited {proc.returncode}:"
                             f"\n{out[-2000:]}\n{err[-4000:]}")
    return seconds, out


def stored_reports(path) -> dict:
    """{cell id: report} of a sweep store."""
    from repro_torch.scenarios.store import open_store

    return {cid: r for (cid, _), r in open_store(path).load().items()}


def json_equal(a, b) -> bool:
    """Equal once both went through JSON (a store holds JSON)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def phase_scenarios_cli():
    """The scenario engine's entry points at paper scale on the card (see
    the module docstring).  Returns the launches by path."""
    import tempfile

    from repro_torch.accel import run_cells_accel
    from repro_torch.accel import waterfill as wf
    from repro_torch.scenarios.presets import get_preset
    from repro_torch.scenarios.runner import run_scenario
    from repro_torch.scenarios.sweep import run_sweep
    from repro_torch.scenarios.worker import run_worker

    tmp = Path(tempfile.mkdtemp(prefix="scenarios_cli-"))

    # (a) One worker with the accel executor: the 30 hfsp cells of
    # paper-estimation-error in one batch, its fair cell spawned.
    sweep = get_preset("paper-estimation-error")
    specs = dict(sweep.expand())
    worker_store = tmp / "worker.sqlite"
    reset_counts()
    t0 = time.perf_counter()
    with recording_cells():
        summary = run_worker(sweep, worker_store, compute="accel",
                             accel_batch=32, device="cuda")
    torch.cuda.synchronize()
    worker_s = time.perf_counter() - t0
    k1_worker = wf.launches
    fair = "scheduler.policy=fair"
    hfsp = [cid for cid in specs if cid != fair]
    if summary["stalled"] or sorted(summary["computed"]) != sorted(specs):
        raise AssertionError(f"worker did not converge: {summary}")
    if (summary["accel_batches"], summary["accel_cells"],
            list(summary["accel_fallbacks"])) != (1, 30, [fair]):
        raise AssertionError(f"not one batch of 30 hfsp cells: {summary}")
    stored = stored_reports(worker_store)
    steps = [stored[cid]["accel_steps"] for cid in hfsp]
    steps_run = -(-max(steps) // 512) * 512  # whole chunks of 512 steps
    if not 0 < k1_worker == steps_run:
        raise AssertionError(f"worker batch: {k1_worker} K1 launches, want "
                             f"one per hfsp step ({steps_run})")
    batch_s = sum(stored[cid]["wall_s"] for cid in hfsp)
    t0 = time.perf_counter()
    direct = run_cells_accel([specs[cid] for cid in hfsp], device="cuda",
                             cells=cells_of([specs[cid] for cid in hfsp]))
    direct_s = time.perf_counter() - t0
    for cid, want in zip(hfsp, drop_wall(direct)):
        if not json_equal(drop_wall([stored[cid]]), [want]):
            raise AssertionError(f"{cid}: worker's accel report != a direct "
                                 "run_cells_accel")
    if stored[fair].get("compute") or stored[fair]["jobs_completed"] != 100:
        raise AssertionError(f"fair cell: {stored[fair]}")
    emit("scenarios_worker_accel", preset=sweep.name, cells=len(specs),
         accel_cells=30, fallbacks=summary["accel_fallbacks"],
         worker_s=worker_s, batch_s=batch_s, batch_cells_per_s=30 / batch_s,
         direct_run_cells_accel_s=direct_s, k1_launches=k1_worker,
         max_accel_steps=max(steps), reports_equal_direct=True)

    # (b) As users run it, alone on the host: the CLI, two spawned
    # workers, the virtual clusters on the card.  Each attempt writes its
    # kernels' launches and the virtual clusters' calls (the hook's
    # ``launch_counts``), its counters dying with it.
    name = "paper-estimation-error-disciplines"
    run_store = tmp / "run.jsonl"
    witness = tmp / "cli_launches"
    witness.mkdir()
    hook = tmp / "hook.json"
    hook.write_text(json.dumps({"launch_counts": True,
                                "state_dir": str(witness)}))
    with cli_process("run", name, "--workers", str(CLI_WORKERS), "--store",
                     str(run_store),
                     env={"REPRO_VC_BACKEND": "torch",
                          "_REPRO_SWEEP_TEST_HOOK": str(hook)}) as started:
        cli_s, out = finish_cli(started)
    per_attempt = [json.loads(f.read_text())
                   for f in sorted(witness.glob("launches-*.json"))]
    cli_counts = {k: sum(c[k] for c in per_attempt)
                  for k in ("k1_launches", "project_launches",
                            "water_fill_calls", "project_calls")}
    check_des_counts(f"{name} (CLI, spawned attempts)", cli_counts)
    # A straggler's racing attempt may count too: every cell once or more.
    if {c["cell_id"] for c in per_attempt} != \
            {cid for cid, _ in get_preset(name).expand()}:
        raise AssertionError(f"{name}: a cell has no counted attempt: "
                             f"{[c['cell_id'] for c in per_attempt]}")

    # The CLI's reference: an inline sweep with numpy virtual clusters.
    with vc_backend_env("numpy"):
        t0 = time.perf_counter()
        want = run_sweep(get_preset(name), workers=0, device="cuda")
        numpy_inline_s = time.perf_counter() - t0
    got = stored_reports(run_store)
    if set(got) != set(want) or len(want) != 10:
        raise AssertionError(f"{name}: cells {sorted(got)} != {sorted(want)}")
    for c in want:
        if not json_equal(drop_wall([got[c]]), drop_wall([want[c]])):
            raise AssertionError(f"{name} {c}: spawned torch report != "
                                 "inline numpy report")
    # One hfsp cell of it in-process: the kernels' launches equal the
    # virtual clusters' calls.
    cell = "scheduler.error_alpha=0.5,scheduler.policy=hfsp"
    reset_counts()
    with vc_backend_env("torch"):
        report = run_scenario(dict(get_preset(name).expand())[cell],
                              device="cuda")
    hfsp_cell = des_counts()
    check_des_counts(f"{name} {cell}", hfsp_cell)
    if not json_equal(drop_wall([report]), drop_wall([want[cell]])):
        raise AssertionError(f"{cell}: in-process report != numpy's")
    emit("scenarios_cli_run", preset=name, cells=len(want),
         workers=CLI_WORKERS,
         cli_wall_s=cli_s, numpy_inline_s=numpy_inline_s,
         reports_equal=True, printed_tail=out.splitlines()[-1],
         cli_attempts=len(per_attempt), cli_counts=cli_counts,
         hfsp_cell=cell, **hfsp_cell)

    # (d) The "auto" latch on the card, timed against numpy in turns: a
    # cell whose phases hold more live jobs than the projection's
    # threshold runs the projection kernel and no K1; paper-fb's hfsp
    # cell stays below it and launches nothing.  Reports equal numpy's.
    latch_cells = {}
    for preset, cid, latches in (LATCH_CELL + (True,),
                                 ("paper-fb", "scheduler.policy=hfsp",
                                  False)):
        spec = dict(get_preset(preset).expand())[cid]
        walls = {"auto": [], "numpy": []}
        reports, counts = {}, []
        with vc_backend_env("numpy"):
            run_scenario(spec, device="cuda")  # warm: untimed
        for backend in LATCH_ORDER:
            reset_counts()
            with vc_backend_env(backend):
                t0 = time.perf_counter()
                reports[backend] = run_scenario(spec, device="cuda")
                torch.cuda.synchronize()
                walls[backend].append(time.perf_counter() - t0)
            if backend == "auto":
                counts.append(des_counts())
        c = counts[0]
        if latches:
            ok = 0 < c["project_launches"] == c["project_calls"] \
                and c["k1_launches"] == c["water_fill_calls"] == 0
        else:
            ok = not any(c.values())
        if not ok or any(other != c for other in counts):
            raise AssertionError(f"auto latch on {preset} {cid}: {counts}")
        if not json_equal(drop_wall([reports["auto"]]),
                          drop_wall([reports["numpy"]])):
            raise AssertionError(f"auto on {preset} {cid}: report != numpy's")
        latch_cells[f"{preset} {cid}"] = {
            "auto_s": walls["auto"], "numpy_s": walls["numpy"],
            "auto_over_numpy": sum(walls["auto"]) / sum(walls["numpy"]),
            "latched": latches, **c}
    emit("scenarios_auto_latch", order=" ".join(LATCH_ORDER),
         reports_equal=True, cells=latch_cells)
    latch = latch_cells[" ".join(LATCH_CELL)]

    # (c) The coordinator's view of both stores.
    status = {}
    with cli_process("sweep-status", sweep.name, "--store",
                     str(worker_store), "--json-out") as first, \
            cli_process("sweep-status", name, "--store", str(run_store),
                        "--json-out") as second:
        for preset, started in ((sweep.name, first), (name, second)):
            st = json.loads(finish_cli(started)[1])
            if not st["converged"] or st["quarantined"] or \
                    len(st["done"]) != st["cells"]:
                raise AssertionError(f"sweep-status {preset}: {st}")
            status[preset] = {k: st[k] for k in ("cells", "stats")}
    emit("scenarios_sweep_status", all_done=True, quarantined=0, **status)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {"k1": {"scenarios worker": k1_worker,
                   "scenarios CLI": cli_counts["k1_launches"],
                   "scenarios hfsp cell": hfsp_cell["k1_launches"]},
            "project": {"scenarios CLI": cli_counts["project_launches"],
                        "scenarios hfsp cell": hfsp_cell["project_launches"],
                        "scenarios auto latch": latch["project_launches"]}}


# ---------------------------------------------------------------------------
# The live service (repro_torch.service)
# ---------------------------------------------------------------------------
#: The live session's virtual seconds per wall second: paper-fb's 1891
#: virtual seconds of makespan in ~19 s of wall (production runs at 1).
SERVICE_TIME_SCALE = 100.0
SERVICE_USERS = 4
#: Machine 7's worker dies a third of the way into the session (wall s
#: after the first submission could go out) and rejoins at two thirds,
#: once its death was declared.
SERVICE_KILL = (7, 6.0, 12.0)
#: Heartbeat silence (wall s) after which the master declares a worker
#: dead.  The master reads heartbeats on the event loop its advances
#: hold: on the card's host single advances took up to ~0.6 s (p999),
#: and one run declared two live workers dead at 1 s.
SERVICE_DEAD_WALL = 5.0


async def live_session(journal, device: str) -> dict:
    """paper-fb's 100 jobs through a live master in this process, as users
    run it: worker agents on all 100 machines, four users submitting their
    jobs over the wire at arrival / SERVICE_TIME_SCALE, machine 7's worker
    killed and rejoined.  Returns what the session showed."""
    import asyncio

    from repro_torch.scenarios.presets import paper_fb_base
    from repro_torch.scenarios.runner import build_cluster, build_workload
    from repro_torch.scenarios.trace import job_record
    from repro_torch.service import (LiveEngine, Master, MasterConfig,
                                     WorkerAgent, live_fingerprint)
    from repro_torch.service.protocol import ServiceClient

    spec = paper_fb_base()
    cluster = build_cluster(spec)
    jobs, _ = build_workload(spec)
    engine = LiveEngine.create(journal, "hfsp", cluster,
                               time_scale=SERVICE_TIME_SCALE, device=device)
    master = Master(engine, MasterConfig(worker_dead_wall=SERVICE_DEAD_WALL))
    await master.start()
    workers = {}
    for m in range(cluster.num_machines):
        workers[m] = WorkerAgent("127.0.0.1", master.port, m)
        await workers[m].start()
    while len(master.workers) < cluster.num_machines:
        await asyncio.sleep(0.01)
    replies = []
    t0 = time.monotonic()

    def submit_all(user: int) -> None:
        mine = sorted((j for j in jobs if j.job_id % SERVICE_USERS == user),
                      key=lambda j: j.arrival_time)
        with ServiceClient("127.0.0.1", master.port, timeout=60.0) as c:
            for job in mine:
                delay = t0 + job.arrival_time / SERVICE_TIME_SCALE \
                    - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                payload = {k: v for k, v in job_record(job).items()
                           if k not in ("job_id", "arrival_time")}
                replies.append(c.call({
                    "op": "submit", "user": f"user{user}",
                    "tag": f"fb-{job.job_id}", "job": payload}))

    loop = asyncio.get_running_loop()
    clients = [loop.run_in_executor(None, submit_all, u)
               for u in range(SERVICE_USERS)]
    machine, kill_s, rejoin_s = SERVICE_KILL
    counters = master.telemetry.counters
    await asyncio.sleep(max(0.0, t0 + kill_s - time.monotonic()))
    await workers[machine].die()
    await asyncio.sleep(max(0.0, t0 + rejoin_s - time.monotonic()))
    while counters["worker_crashes"] == 0:
        if time.monotonic() - t0 > kill_s + 3 * SERVICE_DEAD_WALL:
            raise AssertionError("service: machine 7's death was not "
                                 "declared")
        await asyncio.sleep(0.01)
    workers[machine] = WorkerAgent("127.0.0.1", master.port, machine)
    await workers[machine].start()
    await asyncio.gather(*clients)
    completion = engine.sim.result.completion
    while len(completion) < len(jobs) and time.monotonic() - t0 < 120.0:
        await asyncio.sleep(0.01)
    wall = time.monotonic() - t0
    snap = master.telemetry.snapshot(workers=master._worker_block())
    out = {"fingerprint": live_fingerprint(engine.sim),
           "completion": dict(completion), "jobs": len(jobs),
           "replies": replies, "wall_s": wall, "snapshot": snap,
           "advance_s": sum(engine.decision_latency_s),
           "max_advance_ms": 1e3 * max(engine.decision_latency_s),
           "machines": cluster.num_machines,
           "worker_crashes": counters["worker_crashes"],
           "worker_rejoins": counters["worker_rejoins"]}
    await master.stop()
    for w in workers.values():
        await w.die()
    return out


def phase_service_main_path():
    """The live service at paper scale on the card (see the module
    docstring).  Returns the launches of the live session."""
    import asyncio
    import os
    import tempfile

    from repro_torch.service import (live_fingerprint, read_journal,
                                     replay_journal)

    tmp = Path(tempfile.mkdtemp(prefix="service-"))
    journal = tmp / "live.jsonl"
    with vc_backend_env("torch"):
        reset_counts()
        live = asyncio.run(asyncio.wait_for(live_session(journal, "cuda"),
                                            180.0))
        torch.cuda.synchronize()
        counts = des_counts()
    check_des_counts("service paper-fb-live", counts)
    bad = [r for r in live["replies"] if not r.get("ok")]
    if bad or not len(live["completion"]) == live["jobs"] == 100:
        raise AssertionError(f"service: {len(live['completion'])} of "
                             f"{live['jobs']} jobs completed; refused {bad}")
    if not (live["worker_crashes"] == live["worker_rejoins"] == 1):
        raise AssertionError(f"service: crashes {live['worker_crashes']}, "
                             f"rejoins {live['worker_rejoins']}, want 1 each")
    kinds = {e.get("event") for e in read_journal(journal)[1]}
    if not {"crash", "recover"} <= kinds:
        raise AssertionError(f"service: journal events {kinds}")

    # The device rule over the CLI, beside the twins: without a card the
    # master exits non-zero and never listens.
    nocard = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "master", "--device",
         "cuda", "--journal", str(tmp / "nocard.jsonl")], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    twins = {}
    for backend in ("torch", "numpy"):
        with vc_backend_env(backend):
            t0 = time.perf_counter()
            sim = replay_journal(journal, device="cuda")
            torch.cuda.synchronize()
            twins[backend] = {"wall_s": time.perf_counter() - t0,
                              "fingerprint": live_fingerprint(sim),
                              "equal": live_fingerprint(sim)
                              == live["fingerprint"]
                              and dict(sim.result.completion)
                              == live["completion"]}
        if not twins[backend]["equal"]:
            raise AssertionError(f"service: the {backend} twin != live: "
                                 f"{twins[backend]} vs {live['fingerprint']}")
    try:
        out, err = nocard.communicate(timeout=60)
    finally:
        if nocard.poll() is None:
            nocard.kill()
            nocard.communicate()
    if nocard.returncode == 0 or "LISTENING" in out or \
            (tmp / "nocard.jsonl").exists():
        raise AssertionError(f"service without a card: rc "
                             f"{nocard.returncode}, {out!r}, {err[-500:]!r}")

    lat = live["snapshot"]["decision_latency_ms"]
    card = card_line()
    print(f"service paper-fb-live: decision latency p50 {lat['p50']} ms, "
          f"p99 {lat['p99']} ms over {lat['count']} advances", flush=True)
    print(f"service paper-fb-live: session wall {live['wall_s']} s",
          flush=True)
    print(f"service paper-fb-live: launches K1 {counts['k1_launches']}, "
          f"P {counts['project_launches']}", flush=True)
    print(card, flush=True)
    emit("service_main_path", cell="paper-fb-live", policy="hfsp",
         jobs=live["jobs"], completed=len(live["completion"]),
         machines=live["machines"], users=SERVICE_USERS,
         reduced={"time_scale": SERVICE_TIME_SCALE},
         session_wall_s=live["wall_s"], decision_latency_ms=lat,
         max_advance_ms=live["max_advance_ms"],
         advance_s=live["advance_s"],
         sojourn=live["snapshot"]["sojourn"],
         passes=live["snapshot"]["passes"],
         events=live["snapshot"]["events"],
         event_epsilon=live["snapshot"]["event_epsilon"],
         decisions={d: sum(r.get("decision") == d for r in live["replies"])
                    for d in ("admit", "queued")},
         worker_crashes=live["worker_crashes"],
         worker_rejoins=live["worker_rejoins"],
         live_fingerprint=live["fingerprint"], twins=twins,
         nocard_rc=nocard.returncode, card=card,
         **counts)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# Flash attention (K2) and the dense serving path
# ---------------------------------------------------------------------------
#: (name, b, h, kvh, s, hd, block_q, block_kv, window, causal): the shapes
#: of tests/test_kernels.py, its three windows, a window that spans
#: several of the tensor-core kernel's 128-row kv tiles (so that whole
#: tiles before the window are skipped), a non-causal call, and the model
#: shapes.
FLASH_CASES = (
    ("mha", 1, 2, 2, 64, 32, 32, 32, None, True),
    ("gqa-2:1", 2, 4, 2, 128, 64, 64, 32, None, True),
    ("mqa", 1, 8, 1, 128, 32, 32, 64, None, True),
    ("3-block", 2, 2, 2, 96, 32, 32, 32, None, True),
    ("ragged-q80", 1, 2, 2, 80, 32, 32, 32, None, True),
    ("window16", 1, 2, 2, 128, 32, 32, 32, 16, True),
    ("window48", 1, 2, 2, 128, 32, 32, 32, 48, True),
    ("window100", 1, 2, 2, 128, 32, 32, 32, 100, True),
    ("window300-8tiles", 1, 4, 2, 1024, 64, 128, 128, 300, True),
    ("non-causal", 1, 4, 2, 384, 64, 128, 128, None, False),
    ("olmo-1b", 4, 16, 16, 4096, 128, 512, 512, None, True),
    ("starcoder2-3b", 4, 24, 2, 4096, 128, 512, 512, None, True),
    ("hd80", 1, 4, 2, 96, 80, 32, 32, None, True),
    ("zamba2-2.7b", 4, 32, 32, 4096, 80, 512, 512, None, True),
    ("granite-moe-3b", 4, 24, 8, 4096, 64, 512, 512, None, True),
    ("llava-next-34b", 1, 56, 8, 4096, 128, 512, 512, None, True),
    ("command-r-35b", 4, 64, 8, 4096, 128, 512, 512, None, True),
)
#: dtype -> the (atol, rtol) pairs K2 must meet against its plain
#: version, each elementwise: f32 sums in another order; bf16 rounds P
#: before P V (at most 2**-9 of each term, which matters where a row of
#: few keys cancels to near 0) and rounds the output once (one bf16 step
#: is at most 2**-7 of the value).  The bf16 route is held to atol 2e-2
#: and, tighter at the small outputs of late causal rows, to atol 4e-3 with
#: rtol 1.6e-2 (two bf16 steps).
FLASH_TOL = {torch.float32: ((2e-5, 2e-5),),
             torch.bfloat16: ((2e-2, 0.0), (4e-3, 1.6e-2))}
#: dtype -> the bound on the relative error of each output row of each
#: head, ``|got_r - want_r| / |want_r|`` over the head dim
#: (``row_rel_ratio``).  A fault confined to a few rows of one head, whose
#: outputs are small late in a causal sequence, moves few elements by
#: little in absolute terms; this bound holds each row to its own scale.
#: On the CPU the bf16 arithmetic of the tensor-core route (P rounded
#: before P V, the output rounded once) stays below 4.8e-3 per row at head
#: dims 64, 80 and 128, and every fault of ``WRONG_KERNELS`` reaches 0.31
#: or more in the head it hits (scripts/k2_bf16_tolerance_study.py).
FLASH_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
#: dtype -> the K2 kernel that takes it (its name in the profiles).
KERNEL_OF = {torch.float32: "flash_fwd", torch.bfloat16: "flash_tc"}
SERVE_TOL = 1e-3  # f32 logits, kernel vs plain and prefill vs decode route
#: bf16 logits with K2 against the plain version, as a share of max |logit|:
#: P in bf16 and bf16 activations through 16 layers.
SERVE_TOL_BF16 = 2e-2


def tol_ratio(got, want, tols) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over the
    elements and the (atol, rtol) pairs ``tols``: at most 1 where every
    pair holds."""
    diff = (got.float() - want.float()).abs()
    return max((diff / (atol + rtol * want.float().abs())).max().item()
               for atol, rtol in tols)


def row_rel_ratio(got, want, rel: float) -> tuple[float, list[int]]:
    """The largest relative error of an output row over the head dim,
    ``|got_r - want_r| / |want_r|``, as a share of ``rel``, and the
    (batch, head) where it lies: at most 1 where every row of every head
    holds.  A row whose wanted output is all zeros (no key to attend to)
    has no scale of its own and is left to the elementwise bounds."""
    errs = []
    for g, w in zip(got.unbind(0), want.unbind(0)):  # a batch row at a time
        w = w.float()
        diff = (g.float() - w).norm(dim=-1)
        norm = w.norm(dim=-1)
        errs.append(torch.where(norm > 0, diff / norm, 0.0).amax(dim=-1))
    per_head = torch.stack(errs)  # (b, h)
    worst = int(per_head.argmax())
    return (per_head.max().item() / rel,
            [worst // per_head.shape[1], worst % per_head.shape[1]])


def wrong_attention(q, k, v, scale, drop) -> torch.Tensor:
    """Causal attention of bf16 q, k, v with the extra (head, row, key)
    pairs of ``drop(h, s)`` (a bool mask) masked as well, in f32, one
    batch row at a time, rounded to the input dtype: the output of a
    kernel with that fault."""
    b, h, s, _ = q.shape
    pos = torch.arange(s, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & ~drop(h, s, pos)
    groups = h // k.shape[1]
    out = torch.empty_like(q)
    for i in range(b):
        kf = k[i].float().repeat_interleave(groups, 0)
        vf = v[i].float().repeat_interleave(groups, 0)
        scores = (q[i].float() @ kf.transpose(-1, -2)) * scale
        scores.masked_fill_(~keep, float("-inf"))
        out[i] = (torch.softmax(scores, dim=-1) @ vf).to(q.dtype)
        del scores
    return out


#: name -> the extra (head, row, key) pairs a faulty kernel would mask,
#: as a function of (h, s, positions): the faults a loose bf16 tolerance
#: would let through at the model shapes, where late causal rows average
#: over thousands of keys to outputs of ~0.03.
WRONG_KERNELS = {
    "kv tile 8 dropped": lambda h, s, pos: (
        (pos[None, :] >= 1024) & (pos[None, :] < 1152)).expand(h, s, s),
    "diagonal key dropped from row 1024": lambda h, s, pos: (
        (pos[None, :] == pos[:, None]) & (pos[:, None] >= 1024)).expand(
            h, s, s),
    "last kv tile dropped, last 128 rows of head 0": lambda h, s, pos: (
        (torch.arange(h, device=pos.device)[:, None, None] == 0)
        & (pos[:, None] >= s - 128) & (pos[None, :] >= s - 128)),
}


def flash_inputs(gen, b, h, kvh, s, hd, dtype):
    """q, k, v as the model-layout adapter passes them: (b, h, s, hd)
    views of (b, s, h, hd) tensors."""
    def one(heads):
        x = torch.randn((b, s, heads, hd), generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)
    return one(h), one(kvh), one(kvh)


def flash_bound(b, h, kvh, s, hd, dtype) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, flops) of one causal call: each input
    read once and the output written once; two products over the s(s+1)/2
    unmasked (q, k) pairs of each head."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * s * hd + 2 * b * kvh * s * hd) * esize
    flops = 4 * b * h * hd * (s * (s + 1) // 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def phase_flash_kernel_vs_plain(seed: int):
    from repro_torch.kernels.flash_attention import kernel as fk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype, tols in FLASH_TOL.items():
        for name, b, h, kvh, s, hd, bq, bkv, window, causal in FLASH_CASES:
            q, k, v = flash_inputs(gen, b, h, kvh, s, hd, dtype)
            kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                      block_q=bq, block_kv=bkv)
            before, before_tc = fk.launches, fk.launches_tc
            got = fk.flash_attention_cuda(q, k, v, **kw)
            again = fk.flash_attention_cuda(q, k, v, **kw)
            want = fk.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tc = 2 if dtype == torch.bfloat16 else 0
            if (fk.launches, fk.launches_tc) != (before + 2, before_tc + tc):
                raise AssertionError(f"{name} {dtype}: launch counters did "
                                     "not advance by route")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: kernel rerun not bitwise equal")
            err = (got.float() - want.float()).abs().max().item()
            ratio = tol_ratio(got, want, tols)
            rel = FLASH_ROW_REL[dtype]
            row_ratio, row_at = row_rel_ratio(got, want, rel)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"{name} {dtype}: kernel != plain version (max abs err "
                    f"{err}, {ratio} of the (atol, rtol) bound {tols})")
            if not row_ratio <= 1.0:
                raise AssertionError(
                    f"{name} {dtype}: a row of (batch, head) {row_at} is "
                    f"{row_ratio} of the relative bound {rel} from the plain "
                    "version")
            wrong = {}
            if dtype == torch.bfloat16 and s >= 2048:
                for fault, drop in WRONG_KERNELS.items():
                    bad = wrong_attention(q, k, v, kw["scale"], drop)
                    bad_row, bad_at = row_rel_ratio(bad, want, rel)
                    wrong[fault] = {
                        "max_abs_err": (bad.float() - want.float()).abs()
                        .max().item(),
                        "tol_ratio": tol_ratio(bad, want, tols),
                        "tol_ratio_atol_2e-2_only":
                            tol_ratio(bad, want, tols[:1]),
                        "row_rel_ratio": bad_row, "row_rel_at": bad_at}
                    if not (wrong[fault]["tol_ratio"] > 1.0
                            and bad_row > 1.0):
                        raise AssertionError(
                            f"{name}: the bf16 tolerance {tols} or the row "
                            f"bound {rel} lets a kernel with a fault "
                            f"through ({fault}): {wrong[fault]}")
                    print(f"K2 {name}: fault {fault!r} fails the elementwise "
                          f"bound {wrong[fault]['tol_ratio']:.3g}x and the "
                          f"row bound {bad_row:.3g}x", flush=True)
                    del bad
            emit("flash_kernel_vs_plain", case=name,
                 dtype=str(dtype).replace("torch.", ""),
                 kernel=KERNEL_OF[dtype], shape=[b, h, kvh, s, hd],
                 window=window, causal=causal, max_abs_err=err,
                 tolerances=tols, tol_ratio=ratio, row_rel_bound=rel,
                 row_rel_ratio=row_ratio, rerun_bitwise_equal=True,
                 **({"faulty_kernels_vs_plain": wrong} if wrong else {}))


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.<name>`` replaced by ``wrap(original)`` while the context
    lasts: another route, or an instrument, for one run of a path."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def plain_route(ops, name: str, plain):
    """Route the model's path through ``ops.<name>`` (a model-layout
    adapter's dispatch to a kernel) to the kernel's plain version ``plain``
    (on the card) while the context lasts, for the cross-check against the
    kernel."""
    return patched(ops, name, lambda _: plain)


def names_of(kernel) -> tuple[str, ...]:
    """A kernel's names in a profile: one name, or a tuple of the names of
    the kernels that together make it."""
    return (kernel,) if isinstance(kernel, str) else tuple(kernel)


def profile_device(fn, steps: int, shares: dict, top: int = 6):
    """Device time by kernel over ``steps`` calls of ``fn()``, the
    device's busy share of their wall, and for each ``share: kernel`` of
    ``shares`` the share of device time of the kernels whose name holds
    one of ``names_of(kernel)`` and (``launches_by_kernel``) the launches
    per step of each such name.  Only the device's activity is recorded:
    kernels' names and times are all this reads, and recording every host
    op as well slows the host-bound steps it times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(ev.self_device_time_total for ev in kernels)
    measured = total_us > 0
    share_of = {
        share: sum(ev.self_device_time_total for ev in kernels
                   if any(one in ev.key for one in names_of(kernel)))
        / total_us if measured else "not measured"
        for share, kernel in shares.items()}
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:top]
    return {
        "launches_by_kernel": {
            one: sum(ev.count for ev in kernels if one in ev.key) / steps
            for kernel in shares.values() for one in names_of(kernel)},
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": total_us / 1e3 / steps if measured
        else "not measured",
        "device_busy_share": total_us / 1e6 / wall if measured
        else "not measured",
        **share_of,
        "kernel_launches_per_step": sum(ev.count for ev in kernels) / steps,
        "top_kernels_us": [[ev.key[:70], ev.count, ev.self_device_time_total]
                           for ev in top],
    }


def k2_counts(fk, per_prefill: int) -> dict:
    """K2's entries of ``serve_main_path``'s ``kernels`` on a bf16 path:
    ``per_prefill`` launches of the tensor-core kernel (``flash_tc``) and
    none of the CUDA-core one (``flash_fwd``, the f32 route)."""
    return {"k2": (lambda: fk.launches_tc, KERNEL_OF[torch.bfloat16],
                   per_prefill),
            "k2_cuda_core": (lambda: fk.launches - fk.launches_tc,
                             KERNEL_OF[torch.float32], 0)}


def serve_main_path(phase: str, arch: str, seed: int, kernels: dict,
                    **prefill_kw):
    """Serve ``arch`` at its published widths (bf16 activations, random
    weights from ``seed``): a 4 x 4096 prefill through
    ``make_prefill_step(**prefill_kw, last_token_only=True)``, cold and
    warm, then ``greedy_generate`` for 4 requests of 64 prompt and 32 new
    tokens, with every launch count set to 0 just before and read just
    after.  ``kernels`` maps a tag to (a function reading the kernel's
    launch count, the kernel's name in the profile or a tuple of the names
    of the kernels one launch runs, launches each prefill must make, by
    the count and by each name in the profile).  Then profiles of
    a prefill and a decode step, with each kernel's share of device time
    as ``<tag>_share_of_device``.  Emits
    ``phase`` and returns (cfg, params, {tag: launches}, {tag: launches
    per prefill})."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_model
    from repro_torch.serve import (
        greedy_generate,
        make_decode_step,
        make_prefill_step,
    )

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    b, s = 4, 4096
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                            device="cuda")
    prefill = make_prefill_step(cfg, **prefill_kw, last_token_only=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    per_prefill = {tag: [] for tag in kernels}
    for _ in range(2):  # cold, warm
        before = {tag: count() for tag, (count, _, _) in kernels.items()}
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for tag, (count, _, _) in kernels.items():
            per_prefill[tag].append(count() - before[tag])
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompts, 32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {tag: count() for tag, (count, _, _) in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for tag, (_, _, expected) in kernels.items():
        if per_prefill[tag] != [expected] * 2:
            raise AssertionError(f"{tag.upper()} launches per prefill "
                                 f"{per_prefill[tag]}, expected {expected}")
    if logits.shape != (b, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    if out.shape != (4, 96) or not torch.equal(out[:, :64], prompts) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad greedy output {tuple(out.shape)}")
    shares = {f"{tag}_share_of_device": name
              for tag, (_, name, _) in kernels.items()}
    prof_prefill = profile_device(lambda: prefill(params, {"tokens": tokens}),
                                  steps=1, shares=shares)
    if prof_prefill["device_ms_per_step"] == "not measured":
        raise AssertionError("the profiler saw no device time in the "
                             "prefill, so the launches by kernel name "
                             "cannot be checked")
    for tag, (_, name, expected) in kernels.items():
        for one in names_of(name):
            seen = prof_prefill["launches_by_kernel"][one]
            if seen != expected:
                raise AssertionError(f"the profiled prefill launched {one} "
                                     f"{seen} times, expected {expected}")
    # Decode steps of the greedy loop's shape: 4 rows at position 63 of a
    # 96-slot cache (the ssm family's state does not grow).
    step = make_decode_step(cfg)
    cache = init_cache(cfg, 4, 96, device="cuda")
    pos = torch.full((4,), 63, dtype=torch.long, device="cuda")
    prof_decode = profile_device(
        lambda: step(params, prompts[:, -1:], pos, cache), steps=8,
        shares=shares)
    emit(phase, model=cfg.name, params=n_params,
         param_count_analytic=cfg.param_count(),
         param_dtype=cfg.param_dtype, dtype=cfg.dtype, init_s=init_s,
         prefill_batch=[b, s], prefill_cold_s=walls[0],
         prefill_warm_s=walls[1],
         prefill_cold_tokens_per_s=b * s / walls[0],
         prefill_warm_tokens_per_s=b * s / walls[1],
         **{f"{tag}_launches_per_prefill": n for tag, n in per_prefill.items()},
         generate_requests=4, generate_prompt=64, generate_new=32,
         generate_s=gen_s, decode_steps=64 + 32 - 1,
         decode_new_tokens_per_s=4 * 32 / gen_s,
         decode_steps_per_s=(64 + 32 - 1) / gen_s,
         peak_memory_gb=peak_gb,
         **{f"{tag}_launches": n for tag, n in launches.items()},
         profile_warm_prefill=prof_prefill, profile_decode_step=prof_decode)
    return cfg, params, launches, {tag: n[0] for tag, n in per_prefill.items()}


def phase_serve_main_path(seed: int):
    from repro_torch.kernels.flash_attention import kernel as fk

    cfg, params, launches, per_prefill = serve_main_path(
        "serve_main_path", "olmo_1b", seed, k2_counts(fk, 16), use_flash=True)
    return cfg, params, launches["k2"], per_prefill["k2"]


def phase_serve_crosscheck(cfg, params, seed: int):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, s = 2, 300  # ragged against the kernel's 64-row tiles
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    before, before_tc = fk.launches, fk.launches_tc
    flash = make_prefill_step(cfg32, use_flash=True)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if (fk.launches - before, fk.launches_tc) != (cfg.num_layers, before_tc):
        raise AssertionError("f32 prefill did not run K2's f32 route in "
                             "every layer")
    with plain_route(fops, "flash_attention_bhsd", fk.flash_attention_plain):
        plain = make_prefill_step(cfg32, use_flash=True)(
            params, {"tokens": tokens})
    dense = make_prefill_step(cfg32)(params, {"tokens": tokens})
    err_plain = (flash - plain).abs().max().item()
    err_dense = (flash - dense).abs().max().item()

    cache = init_cache(cfg32, b, s, device="cuda")
    step = make_decode_step(cfg32)
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.long, device="cuda")
        logits, cache = step(params, tokens[:, t:t + 1], pos, cache)
    err_decode = (flash[:, -1] - logits[:, -1]).abs().max().item()
    torch.cuda.synchronize()
    for what, err in (("plain version", err_plain),
                      ("non-flash path", err_dense),
                      ("decode route", err_decode)):
        if not err <= SERVE_TOL:
            raise AssertionError(f"f32 prefill with K2 vs {what}: max abs "
                                 f"err {err} > {SERVE_TOL}")
    emit("serve_crosscheck", dtype="float32", batch=[b, s],
         logits_abs_max=flash.abs().max().item(), atol=SERVE_TOL,
         k2_vs_plain_max_abs_err=err_plain,
         k2_vs_nonflash_max_abs_err=err_dense,
         prefill_last_vs_decode_route_max_abs_err=err_decode)


def phase_serve_crosscheck_bf16(cfg, params, seed: int):
    """olmo-1b's bf16 prefill logits on 1 x 1024 with K2's tensor-core
    kernel against the same prefill through K2's plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.serve import make_prefill_step

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    before_tc = fk.launches_tc
    kern = make_prefill_step(cfg, use_flash=True)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if fk.launches_tc - before_tc != cfg.num_layers:
        raise AssertionError("bf16 prefill did not run the tensor-core K2 in "
                             "every layer")
    with plain_route(fops, "flash_attention_bhsd", fk.flash_attention_plain):
        plain = make_prefill_step(cfg, use_flash=True)(params,
                                                      {"tokens": tokens})
    torch.cuda.synchronize()
    err = (kern.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    print(f"bf16 olmo-1b prefill, tensor-core K2 vs plain: max abs err {err} "
          f"(max |logit| {scale})", flush=True)
    if not err <= SERVE_TOL_BF16 * scale:
        raise AssertionError(f"bf16 prefill with K2 vs its plain version: max "
                             f"abs err {err} > {SERVE_TOL_BF16} x {scale}")
    emit("serve_crosscheck_bf16", dtype="bfloat16", batch=[1, 1024],
         logits_abs_max=scale, k2_vs_plain_max_abs_err=err,
         tol_share_of_max=SERVE_TOL_BF16)


def flash_speed(fk, q, k, v, kw, library_ms: float, dtype) -> dict:
    """The fields of a K2 timing entry: the tensor-core kernel's time,
    achieved rate, share of the bound, ratio to the library call, and the
    f32 route's time on the same inputs in f32."""
    b, h, s, hd = q.shape
    ms = cuda_ms(lambda: fk.flash_attention_cuda(q, k, v, **kw), 10)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    ms_f32 = cuda_ms(lambda: fk.flash_attention_cuda(q32, k32, v32, **kw), 3)
    bound_ms, bound_by, nbytes, flops = flash_bound(b, h, k.shape[1], s, hd,
                                                    dtype)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes_per_call": nbytes,
            "flops_per_call": flops,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms,
            "ratio_to_library": ms / library_ms,
            "ms_float32_inputs": ms_f32}


def phase_flash_timing(seed: int, serve_launches: int, per_prefill: int):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    b, h, kvh, s, hd = 4, 16, 16, 4096, 128  # olmo-1b's prefill call
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    q, k, v = flash_inputs(gen, b, h, kvh, s, hd, dtype)
    kw = dict(scale=hd ** -0.5)
    got = fk.flash_attention_cuda(q, k, v, **kw)
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    max_err = (got.float() - want.float()).abs().max().item()
    plain_ms = cuda_ms(lambda: fk.flash_attention_plain(q, k, v, **kw), 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=kw["scale"]), 10)
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": serve_launches,
        "max_abs_err": max_err,
        "plain_ms": plain_ms,
        **flash_speed(fk, q, k, v, kw, library_ms, dtype),
        "tensor_cores": "wgmma, K/V by TMA (the bf16 route)",
        "float32_route_source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "shape": [b, h, kvh, s, hd],
        "dtype": "bfloat16",
        "launches_per_prefill": per_prefill,
    }
    emit("flash_timing", **entry)
    return entry


# ---------------------------------------------------------------------------
# The RWKV6 WKV scan (K3) and the rwkv6 serving path
# ---------------------------------------------------------------------------
#: (name, b, h, t, d, chunk, decay sharpness): the four shapes of
#: tests/test_kernels.py, strong decays at chunk 16 (w down to ~1e-16), a
#: ragged scan of 16 chunks over 16 (batch, head) rows, whose blocks wait on
#: one another's states, and rwkv6-1.6b's prefill call with
#: test_kernels.py's decays and with the model's (``wd_bias = -6``: w ~
#: 0.9975, a state that remembers hundreds of tokens, so a fault in it
#: carries over many chunks).
RWKV_CASES = (
    ("tiny", 1, 1, 32, 8, 16, 2.0),
    ("3-chunk", 2, 3, 100, 16, 32, 2.0),
    ("one-chunk", 1, 2, 64, 32, 64, 2.0),
    ("ragged-t65", 2, 2, 65, 16, 32, 2.0),
    ("strong-decay", 1, 2, 128, 16, 16, 0.0),
    ("ring-t1000", 2, 8, 1000, 64, 64, 2.0),
    ("rwkv6-1.6b", 4, 32, 4096, 64, 64, 2.0),
    ("rwkv6-1.6b-model-decays", 4, 32, 4096, 64, 64, 6.0),
)
#: dtype of r/k/v -> (atol, rtol) of K3's output against its plain
#: version: f32 sums in another order; bf16 adds one rounding of the
#: output, which is relative (one bf16 step is 0.25 at the outputs of
#: 32 to 64 that the rwkv6 shape reaches).  The f32 state is held at
#: 1e-4 abs and rel in both.
RWKV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
RWKV_PARAMS = 1_583_941_632  # the rwkv6-1.6b tree (param_count() says 1.342e9)
#: f32 peak outside the tensor cores, K3's yardstick: the reference
#: computes the chunked form in f32.
PEAK_F32_PER_S = 67e12


def rwkv_inputs(gen, b, h, t, d, sharpness, dtype):
    """r, k, v (dtype), w, u, s0 (f32) as the model-layout adapter passes
    them: (b, h, t, d) views of (b, t, h, d) tensors."""
    def seq():
        return torch.randn((b, t, h, d), generator=gen, device="cuda")
    r, k, v = (seq().to(dtype).transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(seq() - sharpness)).transpose(1, 2)
    u = 0.1 * torch.randn((h, d), generator=gen, device="cuda")
    s0 = 0.1 * torch.randn((b, h, d, d), generator=gen, device="cuda")
    return r, k, v, w, u, s0


def rwkv_bound(b, h, t, d, chunk, dtype) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, flops) of one call: r, k, v, w, u and s0
    read once, o and the state written once; per chunk of n rows the
    inter-chunk and state products (2 n d^2 flops each) and the scores
    and intra-chunk products over the n (n - 1) / 2 pairs of the strictly
    lower triangle (2 d flops per pair each)."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (b * h * t * d * (4 * esize + 4) + h * d * 4
              + 2 * b * h * d * d * 4)
    c = min(chunk, t)
    rows = [c] * (t // c) + ([t % c] if t % c else [])
    per_bh = sum(4 * n * d * d + 4 * d * (n * (n - 1) // 2) for n in rows)
    flops = b * h * per_bh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def wrong_rwkv6(rk, args, chunk: int) -> dict:
    """Outputs (o, state) of three faulty K3s on ``args`` (at least 4
    batch rows, 12 heads and 5 chunks), built from the plain version: the
    faults a chunk-parallel K3 makes possible.

    * The state entering one late chunk of one (batch, head) taken as 0.
    * One channel (row of the state) of one head misses one chunk's
      exp(total) decay (S <- S + dS there), and the miss carries into every
      later chunk.
    * One chunk's bonus diagonal (sum_d r u k) v dropped, for one (batch,
      head)."""
    r, k, v, w, u, s0 = args
    t = r.shape[2]
    nc = -(-t // chunk)
    late, mid = nc - 4, nc // 2

    def run(lo, hi, s):  # the plain version on chunks [lo, hi) from s
        rows = slice(lo * chunk, min(hi * chunk, t))
        return rk.rwkv6_plain(r[:, :, rows], k[:, :, rows], v[:, :, rows],
                              w[:, :, rows], u, s, chunk=chunk)

    wrong = {}
    o1, s1 = run(0, late, s0)
    s1[1, 5] = 0.0
    o2, s2 = run(late, nc, s1)
    wrong[f"state entering chunk {late} of (batch 1, head 5) taken as 0"] = (
        torch.cat([o1, o2], dim=2), s2)

    o1, s1 = run(0, mid, s0)
    o2, s2 = run(mid, mid + 1, s1)
    _, ds = run(mid, mid + 1, torch.zeros_like(s0))
    s2[2, 7, 3] = s1[2, 7, 3] + ds[2, 7, 3]
    o3, s3 = run(mid + 1, nc, s2)
    wrong[f"channel 3 of (batch 2, head 7) misses chunk {mid}'s decay"] = (
        torch.cat([o1, o2, o3], dim=2), s3)

    o, s = rk.rwkv6_plain(*args, chunk=chunk)
    rows = slice(mid * chunk, (mid + 1) * chunk)
    diag = (r[3, 11, rows].float() * u[11] * k[3, 11, rows].float()).sum(-1)
    o[3, 11, rows] = (o[3, 11, rows].float()
                      - diag[:, None] * v[3, 11, rows].float()).to(o.dtype)
    wrong[f"bonus diagonal of chunk {mid} dropped, (batch 3, head 11)"] = (
        o, s)
    return wrong


def phase_rwkv6_kernel_vs_plain(seed: int):
    from repro_torch.kernels.rwkv6 import kernel as rk

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    for dtype, (atol, rtol) in RWKV_TOL.items():
        for name, b, h, t, d, chunk, sharp in RWKV_CASES:
            args = rwkv_inputs(gen, b, h, t, d, sharp, dtype)
            before = rk.launches
            got_o, got_s = rk.rwkv6_cuda(*args, chunk=chunk)
            again_o, again_s = rk.rwkv6_cuda(*args, chunk=chunk)
            want_o, want_s = rk.rwkv6_plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            if rk.launches != before + 2:
                raise AssertionError(f"{name}: launch counter did not advance")
            if not (torch.equal(got_o, again_o) and torch.equal(got_s, again_s)):
                raise AssertionError(f"{name}: kernel rerun not bitwise equal")
            if got_o.dtype != dtype or got_s.dtype != torch.float32:
                raise AssertionError(f"{name}: output dtypes {got_o.dtype}, "
                                     f"{got_s.dtype}")
            diff = (got_o.float() - want_o.float()).abs()
            err = diff.max().item()
            diff_s = (got_s - want_s).abs()
            err_s = diff_s.max().item()
            if not bool((diff <= atol + rtol * want_o.float().abs()).all()):
                raise AssertionError(
                    f"{name} {dtype}: kernel output != plain version (max abs "
                    f"err {err}, atol {atol}, rtol {rtol})")
            if not bool((diff_s <= 1e-4 + 1e-4 * want_s.abs()).all()):
                raise AssertionError(
                    f"{name} {dtype}: kernel state != plain version (max abs "
                    f"err {err_s}, atol = rtol = 1e-4)")
            wrong = {}
            if name.startswith("rwkv6-1.6b"):
                for what, (bad_o, bad_s) in wrong_rwkv6(rk, args,
                                                        chunk).items():
                    ratio = tol_ratio(bad_o, want_o, [(atol, rtol)])
                    wrong[what] = {
                        "tol_ratio": ratio,
                        "state_tol_ratio": tol_ratio(bad_s, want_s,
                                                     [(1e-4, 1e-4)])}
                    if not ratio > 1.0:
                        raise AssertionError(
                            f"{name} {dtype}: the output tolerance lets a "
                            f"faulty kernel through ({what}: {ratio:.3g} of "
                            "it)")
            emit("rwkv6_kernel_vs_plain", case=name,
                 dtype=str(dtype).replace("torch.", ""), shape=[b, h, t, d],
                 chunk=chunk, decay_sharpness=sharp,
                 min_w=args[3].min().item(), max_w=args[3].max().item(),
                 max_abs_err=err, o_abs_max=want_o.float().abs().max().item(),
                 tol_ratio=tol_ratio(got_o, want_o, [(atol, rtol)]),
                 state_max_abs_err=err_s, atol=atol, rtol=rtol,
                 rerun_bitwise_equal=True,
                 **({"faulty_kernels_vs_plain": wrong} if wrong else {}))


def phase_rwkv_serve_main_path(seed: int):
    from repro_torch.kernels.rwkv6 import kernel as rk

    cfg, params, launches, per_prefill = serve_main_path(
        "rwkv_serve_main_path", "rwkv6_1b6", seed,
        {"k3": (lambda: rk.launches, rk.KERNEL_NAME, 24),
         # The kernel K3 was before: launched by no prefill.
         "k3_old_kernel": (lambda: 0, "rwkv6_fwd", 0)},
        use_scan_kernel=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"rwkv6-1.6b parameters: {n_params}", flush=True)
    if n_params != RWKV_PARAMS:
        raise AssertionError(f"rwkv6-1.6b tree holds {n_params} parameters, "
                             f"expected {RWKV_PARAMS}")
    return cfg, params, launches["k3"], per_prefill["k3"]


def phase_rwkv_serve_crosscheck(cfg, params, seed: int):
    from repro_torch.kernels.rwkv6 import kernel as rk
    from repro_torch.kernels.rwkv6 import ops as rops
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    b, s = 1, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    before = rk.launches
    kern = make_prefill_step(cfg32, use_scan_kernel=True)(
        params, {"tokens": tokens})
    torch.cuda.synchronize()
    if rk.launches - before != cfg.num_layers:
        raise AssertionError("f32 prefill did not run K3 in every layer")
    with plain_route(rops, "rwkv6_chunked_bhtd", rk.rwkv6_plain):
        plain = make_prefill_step(cfg32, use_scan_kernel=True)(
            params, {"tokens": tokens})
    chunked = make_prefill_step(cfg32)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if rk.launches - before != cfg.num_layers:
        raise AssertionError("the plain and chunked routes launched K3")
    err_plain = (kern - plain).abs().max().item()
    err_chunked = (kern - chunked).abs().max().item()

    # The decode route carries the state token by token; 200 tokens are
    # three full chunks and a ragged fourth in the prefill.
    s_dec = 200
    short = tokens[:, :s_dec]
    pre = make_prefill_step(cfg32, use_scan_kernel=True, last_token_only=True)(
        params, {"tokens": short})
    cache = init_cache(cfg32, b, s_dec, device="cuda")
    step = make_decode_step(cfg32)
    for t in range(s_dec):
        pos = torch.full((b,), t, dtype=torch.long, device="cuda")
        logits, cache = step(params, short[:, t:t + 1], pos, cache)
    err_decode = (pre[:, -1] - logits[:, -1]).abs().max().item()
    torch.cuda.synchronize()
    for what, err in (("plain version", err_plain),
                      ("rwkv_scan_chunked route", err_chunked),
                      ("decode route", err_decode)):
        if not err <= SERVE_TOL:
            raise AssertionError(f"f32 prefill with K3 vs {what}: max abs "
                                 f"err {err} > {SERVE_TOL}")
    emit("rwkv_serve_crosscheck", dtype="float32", batch=[b, s],
         decode_prompt=s_dec, logits_abs_max=kern.abs().max().item(),
         atol=SERVE_TOL, k3_vs_plain_max_abs_err=err_plain,
         k3_vs_chunked_max_abs_err=err_chunked,
         plain_vs_chunked_max_abs_err=(plain - chunked).abs().max().item(),
         prefill_last_vs_decode_route_max_abs_err=err_decode)


def phase_rwkv6_timing(seed: int, serve_launches: int, per_prefill: int):
    from repro_torch.kernels.rwkv6 import kernel as rk

    b, h, t, d, chunk = 4, 32, 4096, 64, 64  # rwkv6-1.6b's prefill call
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    args = rwkv_inputs(gen, b, h, t, d, 2.0, dtype)
    got, _ = rk.rwkv6_cuda(*args, chunk=chunk)
    want, _ = rk.rwkv6_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    max_err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: rk.rwkv6_cuda(*args, chunk=chunk), 10)
    args32 = [x.float() for x in args[:3]] + list(args[3:])
    ms_f32 = cuda_ms(lambda: rk.rwkv6_cuda(*args32, chunk=chunk), 10)
    plain_ms = cuda_ms(lambda: rk.rwkv6_plain(*args, chunk=chunk), 3)
    bound_ms, bound_by, nbytes, flops = rwkv_bound(b, h, t, d, chunk, dtype)
    bound32_ms, bound32_by, _, _ = rwkv_bound(b, h, t, d, chunk, torch.float32)
    entry = {
        "name": "rwkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:30",
        "launches": serve_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the WKV scan
        "shape": [b, h, t, d],
        "chunk": chunk,
        "dtype": "bfloat16",
        "launches_per_prefill": per_prefill,
        "bytes_per_call": nbytes,
        "flops_per_call": flops,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "share_of_bound": bound_ms / ms,
        "ms_float32_inputs": ms_f32,
        "bound_ms_float32_inputs": bound32_ms,
        "bound_by_float32_inputs": bound32_by,
        "share_of_bound_float32_inputs": bound32_ms / ms_f32,
        "kernel": rk.KERNEL_NAME,
    }
    emit("rwkv6_timing", **entry)
    return entry


# ---------------------------------------------------------------------------
# The Mamba2 SSD scan (K4) and the zamba2 serving path
# ---------------------------------------------------------------------------
#: (name, b, h, t, p, n, chunk, decay sharpening, atol of y's scale): the
#: four shapes of tests/test_kernels.py, strong decays at chunk 16 (a down
#: to ~1e-13), and zamba2-2.7b's prefill call twice: with the decays the
#: model makes at its init (sharpening None: a = exp(-dt), A_log = 0), and
#: with test_kernels.py's weaker ones.  With n = 64 and unit-normal B and
#: C, y there reaches ~200 and its terms more; their f32 sums cancel in
#: small outputs to errors of ~1e-3 in the kernel and in the plain version
#: alike (each is held against the plain version computed in f64, and
#: both errors are reported), so atol is taken there as 1e-4 of max |y|,
#: or the dtype's atol where that is larger (rtol stays the dtype's).
SSD_CASES = (
    ("tiny", 1, 1, 32, 8, 8, 16, 0.0, False),
    ("3-chunk-t100", 2, 3, 100, 16, 8, 32, 0.0, False),
    ("one-chunk", 1, 2, 64, 32, 16, 64, 0.0, False),
    ("ragged-t70", 1, 2, 70, 16, 8, 32, 0.0, False),
    ("strong-decay", 1, 2, 128, 16, 8, 16, 1.5, False),
    ("zamba2-2.7b", 4, 80, 4096, 64, 64, 64, None, True),
    ("zamba2-2.7b-weak-decays", 4, 80, 4096, 64, 64, 64, 0.0, True),
)
#: dtype of x/B/C -> (atol, rtol) of K4's y against its plain version: f32
#: sums in another order; bf16 adds one rounding of y, which is relative.
#: The f32 state is held at 1e-4 abs and rel in both.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
ZAMBA_PARAMS = 2_340_750_240  # the zamba2-2.7b tree (param_count() says 2.3455e9)


def ssd_inputs(gen, b, h, t, p, n, sharpen, dtype):
    """x, B, C (dtype), dt, a, s0 (f32) as the model-layout adapter passes
    them: x (b, h, t, p) and dt, a (b, h, t) views of (b, t, h, *) tensors;
    dt = softplus(N), a = exp(-exp(N - 1 + sharpen) dt) as
    tests/test_kernels.py draws them, or a = exp(-dt) (the model's at
    A_log = 0) when ``sharpen`` is None."""
    def seq(*tail):
        return torch.randn((b, t, h, *tail), generator=gen, device="cuda")
    x = seq(p).to(dtype).transpose(1, 2)
    dt = torch.nn.functional.softplus(seq()).transpose(1, 2)
    rate = (1.0 if sharpen is None
            else torch.exp(seq().transpose(1, 2) - 1.0 + sharpen))
    a = torch.exp(-rate * dt)
    B, C = (torch.randn((b, t, n), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    s0 = 0.1 * torch.randn((b, h, p, n), generator=gen, device="cuda")
    return x, dt, a, B, C, s0


def ssd_bound(b, h, t, p, n, chunk, dtype) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, flops) of one call: x, dt, a, B, C and
    s0 read once, y and the state written once; per chunk of m rows the
    lower triangle (m (m + 1) / 2 pairs) of C B^T once per batch row (B and
    C are shared across heads) and of scores x per head (2 n and 2 p flops
    per pair), and C S^T and the state update in full (2 m p n each)."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * t * p * esize + 2 * b * h * t * 4
              + 2 * b * t * n * esize + 2 * b * h * p * n * 4)
    c = min(chunk, t)
    rows = [c] * (t // c) + ([t % c] if t % c else [])
    pairs = [m * (m + 1) // 2 for m in rows]
    flops = (b * sum(2 * n * q for q in pairs)
             + b * h * sum(2 * p * q + 4 * m * p * n
                           for m, q in zip(rows, pairs)))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def wrong_ssd(sk, args, chunk: int) -> dict:
    """Outputs (y, state) of three faulty K4s on ``args``, built from the
    plain version: the faults a chunk-parallel K4 makes possible.

    * The state entering one late chunk of one (batch, head) taken as 0.
    * One 16-column p-slice of one head misses one chunk's exp(total)
      decay (S <- S + s_new there), and the miss carries into every later
      chunk.
    * The diagonal term (j = i) of one chunk's scores dropped, for one
      (batch, head)."""
    x, dt, a, B, C, s0 = args
    t = x.shape[2]
    nc = -(-t // chunk)
    late, mid = nc - 4, nc // 2

    def run(lo, hi, s):  # the plain version on chunks [lo, hi) from s
        rows = slice(lo * chunk, min(hi * chunk, t))
        return sk.ssd_plain(x[:, :, rows], dt[:, :, rows], a[:, :, rows],
                            B[:, rows], C[:, rows], s, chunk=chunk)

    wrong = {}
    y1, s1 = run(0, late, s0)
    s1[1, 5] = 0.0
    y2, s2 = run(late, nc, s1)
    wrong[f"state entering chunk {late} of (batch 1, head 5) taken as 0"] = (
        torch.cat([y1, y2], dim=2), s2)

    y1, s1 = run(0, mid, s0)
    y2, s2 = run(mid, mid + 1, s1)
    _, s_new = run(mid, mid + 1, torch.zeros_like(s0))
    cols = slice(16, 32)
    s2[2, 7, cols] = s1[2, 7, cols] + s_new[2, 7, cols]
    y3, s3 = run(mid + 1, nc, s2)
    wrong[f"columns 16-31 of (batch 2, head 7) miss chunk {mid}'s decay"] = (
        torch.cat([y1, y2, y3], dim=2), s3)

    y, s = sk.ssd_plain(*args, chunk=chunk)
    rows = slice(mid * chunk, (mid + 1) * chunk)
    diag = (C[3, rows].float() * B[3, rows].float()).sum(-1) * dt[3, 11, rows]
    y[3, 11, rows] = (y[3, 11, rows].float()
                      - diag[:, None] * x[3, 11, rows].float()).to(y.dtype)
    wrong[f"diagonal of chunk {mid}'s scores dropped, (batch 3, head 11)"] = (
        y, s)
    return wrong


def phase_ssd_kernel_vs_plain(seed: int):
    from repro_torch.kernels.ssd import kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    for dtype, (atol, rtol) in SSD_TOL.items():
        for name, b, h, t, p, n, chunk, sharpen, of_scale in SSD_CASES:
            args = ssd_inputs(gen, b, h, t, p, n, sharpen, dtype)
            before = sk.launches
            got_y, got_s = sk.ssd_cuda(*args, chunk=chunk)
            again_y, again_s = sk.ssd_cuda(*args, chunk=chunk)
            want_y, want_s = sk.ssd_plain(*args, chunk=chunk)
            y64, _ = sk.ssd_plain(*(v.double() for v in args), chunk=chunk)
            torch.cuda.synchronize()
            if sk.launches != before + 2:
                raise AssertionError(f"{name}: launch counter did not advance")
            if not (torch.equal(got_y, again_y) and torch.equal(got_s, again_s)):
                raise AssertionError(f"{name}: kernel rerun not bitwise equal")
            if got_y.dtype != dtype or got_s.dtype != torch.float32:
                raise AssertionError(f"{name}: output dtypes {got_y.dtype}, "
                                     f"{got_s.dtype}")
            diff = (got_y.float() - want_y.float()).abs()
            err = diff.max().item()
            diff_s = (got_s - want_s).abs()
            err_s = diff_s.max().item()
            y_max = want_y.float().abs().max().item()
            y_atol = max(atol, 1e-4 * y_max) if of_scale else atol
            if not bool((diff <= y_atol + rtol * want_y.float().abs()).all()):
                raise AssertionError(
                    f"{name} {dtype}: kernel y != plain version (max abs err "
                    f"{err}, atol {y_atol}, rtol {rtol})")
            if not bool((diff_s <= 1e-4 + 1e-4 * want_s.abs()).all()):
                raise AssertionError(
                    f"{name} {dtype}: kernel state != plain version (max abs "
                    f"err {err_s}, atol = rtol = 1e-4)")
            wrong = {}
            if name == "zamba2-2.7b":
                for what, (bad_y, bad_s) in wrong_ssd(sk, args, chunk).items():
                    ratio = tol_ratio(bad_y, want_y, [(y_atol, rtol)])
                    wrong[what] = {
                        "y_tol_ratio": ratio,
                        "state_tol_ratio": tol_ratio(bad_s, want_s,
                                                     [(1e-4, 1e-4)])}
                    if not ratio > 1.0:
                        raise AssertionError(
                            f"{name} {dtype}: the y tolerance lets a faulty "
                            f"kernel through ({what}: {ratio:.3g} of it)")
            emit("ssd_kernel_vs_plain", case=name,
                 dtype=str(dtype).replace("torch.", ""),
                 shape=[b, h, t, p, n], chunk=chunk, decay_sharpening=sharpen,
                 min_a=args[2].min().item(), max_abs_err=err,
                 y_abs_max=y_max, state_max_abs_err=err_s, atol=y_atol,
                 rtol=rtol, rerun_bitwise_equal=True,
                 kernel_vs_f64_max_abs_err=(got_y.double() - y64).abs().max().item(),
                 plain_vs_f64_max_abs_err=(want_y.double() - y64).abs().max().item(),
                 **({"faulty_kernels_vs_plain": wrong} if wrong else {}))


def phase_zamba_serve_main_path(seed: int):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk

    cfg, params, launches, per_prefill = serve_main_path(
        "zamba_serve_main_path", "zamba2_2b7", seed,
        {"k4": (lambda: sk.launches, sk.KERNEL_NAMES, 54),
         # The single kernel K4 was before: launched by no prefill.
         "k4_single_kernel": (lambda: 0, "ssd_fwd", 0),
         **k2_counts(fk, 9)},
        use_flash=True, use_scan_kernel=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"zamba2-2.7b parameters: {n_params}", flush=True)
    if n_params != ZAMBA_PARAMS:
        raise AssertionError(f"zamba2-2.7b tree holds {n_params} parameters, "
                             f"expected {ZAMBA_PARAMS}")
    return cfg, params, launches, per_prefill


def phase_zamba_serve_crosscheck(cfg, params, seed: int):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    b, s = 1, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    both = dict(use_flash=True, use_scan_kernel=True)
    k4_0, k2_0 = sk.launches, fk.launches
    kern = make_prefill_step(cfg32, **both)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if (sk.launches - k4_0, fk.launches - k2_0) != (54, 9):
        raise AssertionError("f32 prefill did not run K4 in every layer and "
                             "K2 in every shared block")
    with plain_route(sops, "ssd_chunked_bhtp", sk.ssd_plain):
        plain4 = make_prefill_step(cfg32, **both)(params, {"tokens": tokens})
    chunked = make_prefill_step(cfg32, use_flash=True)(params,
                                                       {"tokens": tokens})
    torch.cuda.synchronize()
    if sk.launches - k4_0 != 54:
        raise AssertionError("the plain and chunked routes launched K4")
    k2_1 = fk.launches
    with plain_route(fops, "flash_attention_bhsd", fk.flash_attention_plain):
        plain2 = make_prefill_step(cfg32, **both)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if fk.launches != k2_1:
        raise AssertionError("K2's plain route launched K2")
    err_plain4 = (kern - plain4).abs().max().item()
    err_chunked = (kern - chunked).abs().max().item()
    err_plain2 = (kern - plain2).abs().max().item()

    # The decode route carries the SSD and conv states token by token and
    # the shared block's KV caches; 200 tokens are three full chunks and a
    # ragged fourth in the prefill.
    s_dec = 200
    short = tokens[:, :s_dec]
    pre = make_prefill_step(cfg32, **both, last_token_only=True)(
        params, {"tokens": short})
    cache = init_cache(cfg32, b, s_dec, device="cuda")
    step = make_decode_step(cfg32)
    for t in range(s_dec):
        pos = torch.full((b,), t, dtype=torch.long, device="cuda")
        logits, cache = step(params, short[:, t:t + 1], pos, cache)
    err_decode = (pre[:, -1] - logits[:, -1]).abs().max().item()
    torch.cuda.synchronize()
    for what, err in (("K4's plain version", err_plain4),
                      ("ssd_scan_chunked route", err_chunked),
                      ("K2's plain version", err_plain2),
                      ("decode route", err_decode)):
        if not err <= SERVE_TOL:
            raise AssertionError(f"f32 prefill with K4 and K2 vs {what}: max "
                                 f"abs err {err} > {SERVE_TOL}")
    emit("zamba_serve_crosscheck", dtype="float32", batch=[b, s],
         decode_prompt=s_dec, logits_abs_max=kern.abs().max().item(),
         atol=SERVE_TOL, k4_vs_plain_max_abs_err=err_plain4,
         k4_vs_chunked_max_abs_err=err_chunked,
         k2_vs_plain_max_abs_err=err_plain2,
         prefill_last_vs_decode_route_max_abs_err=err_decode)


def phase_ssd_timing(seed: int, serve_launches: int, per_prefill: int):
    from repro_torch.kernels.ssd import kernel as sk

    b, h, t, p, n, chunk = 4, 80, 4096, 64, 64, 64  # zamba2-2.7b's call
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    args = ssd_inputs(gen, b, h, t, p, n, None, dtype)
    got, _ = sk.ssd_cuda(*args, chunk=chunk)
    want, _ = sk.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    max_err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: sk.ssd_cuda(*args, chunk=chunk), 10)
    args32 = [args[0].float(), *args[1:3], args[3].float(), args[4].float(),
              args[5]]
    ms_f32 = cuda_ms(lambda: sk.ssd_cuda(*args32, chunk=chunk), 10)
    plain_ms = cuda_ms(lambda: sk.ssd_plain(*args, chunk=chunk), 3)
    bound_ms, bound_by, nbytes, flops = ssd_bound(b, h, t, p, n, chunk, dtype)
    # Per launch: device time over launches seen, which holds when the
    # profiler misses the first calls of a short window.
    prof = profile_device(lambda: sk.ssd_cuda(*args, chunk=chunk), steps=20,
                          shares={name: name for name in sk.KERNEL_NAMES})
    seen = prof["launches_by_kernel"]
    by_kernel = {
        name: prof["device_ms_per_step"] * prof[name] / seen[name]
        if seen[name] and prof["device_ms_per_step"] != "not measured"
        else "not measured" for name in sk.KERNEL_NAMES}
    entry = {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:27",
        "launches": serve_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "shape": [b, h, t, p, n],
        "chunk": chunk,
        "dtype": "bfloat16",
        "launches_per_prefill": per_prefill,
        "bytes_per_call": nbytes,
        "flops_per_call": flops,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "ms_float32_inputs": ms_f32,
        "kernels": list(sk.KERNEL_NAMES),
        "profiled_ms_per_launch": by_kernel,
    }
    emit("ssd_timing", **entry)
    return entry


# ---------------------------------------------------------------------------
# Training (olmo-1b at full width), the gang runtime and ml-workload
# ---------------------------------------------------------------------------
TRAIN_BATCH = (4, 4096)  # the reference's train_4k length
TRAIN_STEPS = 5
#: Layers of olmo-1b (of 16) in the suspension's snapshot round trip: its
#: ~14 GB at full depth took ~50 s of disk on the card's host.
SUSPEND_LAYERS = 2
#: The gang cell: (arch, total steps, arrival s) at SMOKE widths in f32,
#: quanta of 2 steps, 64 x 8 tokens a step.  One machine with two map
#: slots: a granted quantum waits in its slot until the runtime's next
#: pass runs it, so a job that arrives meanwhile can make HFSP suspend it
#: (with one slot a quantum runs in the pass that grants it, and nothing
#: is ever suspended).  The arrivals fall inside the first job's first
#: quantum.
#: Kinds of kernel in a profiled train step, by name: the shares of
#: device time may overlap (a copy or cast is an elementwise kernel).
TRAIN_KERNEL_KINDS = {
    "gemm_share": ("gemm", "nvjet", "xmma", "cutlass"),
    "softmax_share": ("SoftMax",),
    "elementwise_share": ("elementwise_kernel",),
    "copy_cast_share": ("direct_copy",),
    "reduce_share": ("reduce_kernel",),
}
GANG_JOBS = (("olmo_1b", 8, 0.0), ("rwkv6_1b6", 4, 0.01),
             ("zamba2_2b7", 2, 0.02))


def model_kernel_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rwkv6 import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk

    return {"k2": fk.launches, "k3": rk.launches, "k4": sk.launches}


def train_flops(cfg, b: int, s: int) -> dict:
    """Model FLOPs of one train step with per-layer remat and the plain
    attention: 6 N T for the products with weights (N counts the tied
    unembedding once, as its product runs once), the layers' forward
    once more (remat), and the attention products (full s x s scores, as
    the plain attention computes them) forward, backward (2x) and again
    under remat."""
    d, L, hd = cfg.d_model, cfg.num_layers, cfg.head_size
    h, kvh, dff, v = cfg.num_heads, cfg.kv_heads, cfg.d_ff, cfg.padded_vocab
    glu = 3 if cfg.act.endswith("_glu") else 2
    layer_n = d * (h + 2 * kvh) * hd + h * hd * d + glu * d * dff
    n = L * layer_n + d * v
    tokens = b * s
    attn_fwd = L * 4 * b * h * s * s * hd
    out = {"weights_6NT": 6 * n * tokens, "remat_forward": 2 * L * layer_n
           * tokens, "attention": 4 * attn_fwd, "matmul_params": n}
    out["total"] = out["weights_6NT"] + out["remat_forward"] + out["attention"]
    return out


def tree_leaves(tree) -> list:
    from repro_torch.models.params import tree_flatten

    return tree_flatten(tree)[1]


def tree_bits_equal(a, b) -> bool:
    from repro_torch.models.params import tree_flatten

    pa, la = tree_flatten(a)
    pb, lb = tree_flatten(b)
    return pa == pb and all(torch.equal(x, y) for x, y in zip(la, lb))


def phase_train_main_path(seed: int):
    """olmo-1b trains at its published widths (see the module docstring)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch import KernelInputError
    from repro_torch.train import (OptimizerConfig, TrainConfig,
                                   init_train_state, make_train_step,
                                   train_state_to_device)

    cfg = get_config("olmo_1b")
    b, s = TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_train_state(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=50),
                           TrainConfig(remat="block"))
    data = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=seed))
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = model_kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        raise AssertionError(f"the train step launched a model kernel: "
                             f"{launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}")
    flops = train_flops(cfg, b, s)
    warm = min(walls[1:])
    prof = profile_device(lambda: step(state, batch), steps=1,
                          shares=TRAIN_KERNEL_KINDS, top=12)
    card = card_line()
    print(f"train olmo-1b {b} x {s}: step {walls[0] * 1e3:.1f} ms cold, "
          f"{warm * 1e3:.1f} ms warm, {b * s / warm:.0f} tokens/s, "
          f"{flops['total'] / warm / 1e12:.1f} TFLOP/s, peak "
          f"{peak_gb:.2f} GB", flush=True)
    print(card, flush=True)
    emit("train_main_path", model=cfg.name, params=n_params,
         param_dtype=cfg.param_dtype, dtype=cfg.dtype, remat="block",
         batch=[b, s], steps=TRAIN_STEPS, losses=losses,
         step_ms=[w * 1e3 for w in walls], step_cold_ms=walls[0] * 1e3,
         step_warm_ms=warm * 1e3, tokens_per_s_warm=b * s / warm,
         tokens_per_s_cold=b * s / walls[0], model_flops=flops,
         model_tflops_per_s=flops["total"] / warm / 1e12,
         share_of_bf16_peak=flops["total"] / warm / PEAK_BF16_PER_S,
         peak_memory_gb=peak_gb, kernel_launches=launches,
         profile_step=prof, card=card)

    # EAGER suspension at published widths, cut to SUSPEND_LAYERS layers
    # (the snapshot's disk round trip is the cost, not the card): from one
    # start, two steps, a snapshot of the whole state, the state dropped
    # from the card and restored, two more steps; against four
    # uninterrupted steps.
    state = None
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, num_layers=SUSPEND_LAYERS)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=50),
                           TrainConfig(remat="block"))
    tmp = Path(tempfile.mkdtemp(prefix="train-ckpt-"))
    try:
        store = CheckpointStore(str(tmp), keep=1)
        start = init_train_state(cfg, gen, device="cuda")
        x = start
        for _ in range(2):
            x, _ = step(x, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save("olmo", 7, x)
        save_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(x))
        held = torch.cuda.memory_allocated()
        x = state = None  # the last references: no garbage collection
        dropped = held - torch.cuda.memory_allocated()
        if dropped < state_bytes:
            raise AssertionError(f"dropping the state freed {dropped} bytes "
                                 f"of its {state_bytes}")
        t0 = time.perf_counter()
        restored_step, tree = store.restore("olmo")
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = train_state_to_device(tree, "cuda")
        torch.cuda.synchronize()
        to_device_s = time.perf_counter() - t0
        del tree
        for _ in range(2):
            x, _ = step(x, batch)
        resumed = x
        x = start
        start = None
        for _ in range(4):
            x, _ = step(x, batch)
        torch.cuda.synchronize()
        equal = tree_bits_equal(resumed, x)
        if restored_step != 7 or not equal:
            raise AssertionError(f"resumed run != uninterrupted (step "
                                 f"{restored_step}, equal {equal})")
        emit("train_suspend_resume", layers=cfg.num_layers,
             published_layers=get_config("olmo_1b").num_layers,
             snapshot_bytes=nbytes, save_s=save_s,
             restore_read_s=read_s, restore_to_device_s=to_device_s,
             state_bytes=state_bytes, device_bytes_freed=dropped,
             bitwise_equal=True,
             deterministic_algorithms=False, dir_free_bytes=shutil.disk_usage(
                 tmp).free)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del x, resumed

    # The kernel wrappers refuse gradients on the card.
    q = torch.randn((1, 2, 256, 128), device="cuda",
                    dtype=torch.bfloat16).requires_grad_(True)
    try:
        flash_attention_cuda(q, q, q, scale=0.125)
    except KernelInputError:
        pass
    else:
        raise AssertionError("flash_attention_cuda took an input that "
                             "requires grad")
    with torch.no_grad():
        flash_attention_cuda(q, q, q, scale=0.125)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"step_warm_ms": warm * 1e3, "tokens_per_s": b * s / warm}


def phase_gang_main_path(seed: int):
    """The gang runtime runs real training jobs on the card under HFSP,
    its virtual clusters on K1 and P (see the module docstring).
    Returns K1's and P's launches."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_smoke
    from repro_torch.core import ClusterSpec, HFSPConfig, HFSPScheduler
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime import GangRuntime, MLJob
    from repro_torch.train import (OptimizerConfig, TrainConfig,
                                   init_train_state, make_train_step)

    cluster = ClusterSpec(num_machines=1, map_slots_per_machine=2,
                          reduce_slots_per_machine=0)
    jobs = [MLJob(i, dataclasses.replace(get_smoke(name), dtype="float32"),
                  total_steps=steps, steps_per_quantum=2, arrival_time=arr,
                  seq_len=64, global_batch=8, seed=seed + i, name=name)
            for i, (name, steps, arr) in enumerate(GANG_JOBS)]
    tmp = tempfile.mkdtemp(prefix="gang-")
    try:
        sch = HFSPScheduler(cluster, HFSPConfig(sample_set_size=1,
                                                vc_backend="torch"))
        reset_counts()
        rtm = GangRuntime(cluster, sch, jobs, CheckpointStore(tmp),
                          device="cuda")
        t0 = time.perf_counter()
        rep = rtm.run(max_wall_s=120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = des_counts()
        kernels = model_kernel_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_des_counts("gang hfsp", counts)
    st = rep["stats"]
    if sorted(rep["sojourn"]) != list(range(len(jobs))):
        raise AssertionError(f"gang: completed {sorted(rep['sojourn'])}")
    if not (st["offloads"] >= 1 and st["restores"] >= 1):
        raise AssertionError(f"gang: HFSP suspended nothing: {st}")
    if any(kernels.values()):
        raise AssertionError(f"gang: a model kernel launched: {kernels}")
    for job in jobs:
        step = make_train_step(job.cfg, OptimizerConfig(
            warmup_steps=5, total_steps=job.total_steps),
            TrainConfig(remat="none"))
        state = init_train_state(
            job.cfg, torch.Generator(device="cuda").manual_seed(job.seed),
            device="cuda")
        data = SyntheticLM(job.cfg, DataConfig(
            seq_len=job.seq_len, global_batch=job.global_batch,
            seed=job.seed))
        for i in range(job.total_steps):
            state, _ = step(state, {k: torch.from_numpy(v).to("cuda")
                                    for k, v in data.batch(i).items()})
        if not tree_bits_equal(rtm.rt[job.job_id].state, state):
            raise AssertionError(f"gang: {job.name}'s final state != the "
                                 "same steps run straight through")
    mean = rep["mean_sojourn"]
    print(f"gang hfsp: sojourns {rep['sojourn']}, mean {mean:.3f} s, wall "
          f"{wall:.3f} s, offloads {st['offloads']}, restores "
          f"{st['restores']}, launches K1 {counts['k1_launches']}, P "
          f"{counts['project_launches']}", flush=True)
    emit("gang_main_path", policy="hfsp", machines=1, map_slots=2,
         jobs=[{"name": j.name, "steps": j.total_steps, "arrival_s":
                j.arrival_time, "quantum_s": rtm.rt[j.job_id].quantum_times}
               for j in jobs],
         sojourn_s=rep["sojourn"], mean_sojourn_s=mean, wall_s=wall,
         stats=st, final_params_equal_straight_run=True,
         events=[list(e) for e in rep["events"]], **counts)
    return counts


def phase_ml_workload():
    """The ml-workload preset's three cells (40 ML jobs on 8 machines)
    through run_scenario on the card, torch virtual clusters against
    numpy's.  Returns the hfsp cell's launches."""
    from repro_torch.scenarios import presets
    from repro_torch.scenarios.runner import run_scenario

    specs = dict(presets.get_preset("ml-workload").expand())
    out, hfsp = {}, None
    for cid, spec in specs.items():
        reset_counts()
        t0 = time.perf_counter()
        got = run_scenario(spec.override(**{"scheduler.vc_backend": "torch"}),
                           device="cuda")
        torch.cuda.synchronize()
        torch_s = time.perf_counter() - t0
        counts = des_counts()
        t0 = time.perf_counter()
        want = run_scenario(spec.override(**{"scheduler.vc_backend": "numpy"}),
                            device="cuda")
        numpy_s = time.perf_counter() - t0
        g, w = ({k: v for k, v in r.items() if k not in ("spec", "wall_s")}
                for r in (got, want))
        if g != w:
            raise AssertionError(f"ml-workload {cid}: torch report != numpy: "
                                 f"{[k for k in g if g[k] != w[k]]}")
        if g["jobs_completed"] != spec.workload.num_jobs or g["jobs_lost"]:
            raise AssertionError(f"ml-workload {cid}: incomplete {g}")
        if spec.scheduler.policy == "hfsp":
            check_des_counts("ml-workload hfsp", counts)
            hfsp = counts
        out[cid] = {"mean_sojourn_s": g["mean_sojourn_s"], "torch_wall_s":
                    torch_s, "numpy_wall_s": numpy_s, **counts}
    emit("ml_workload", jobs=40, machines=8, reports_equal=True, cells=out)
    return hfsp


# ---------------------------------------------------------------------------
# The other model families: granite-moe-3b serving (its MoE layer and K2 at
# head dim 64), the five other configs, and K2 timed at head dim 64
# ---------------------------------------------------------------------------
#: The granite-moe-3b tree (``param_count()`` says 3,298,693,632: it
#: leaves out the norms and the 13 padded vocab rows).
GRANITE_PARAMS = 3_298_813_440
#: The MoE layer's parts by the aten op whose launches make each of them
#: (within the layer).
MOE_OPS = {
    "scatter": "aten::scatter_add",
    "gather": "aten::gather",
    "cumsum": "aten::cumsum",
    "topk": "aten::sort",
    "one_hot": "aten::one_hot",
    "expert_bmm": "aten::bmm",
}
#: (config, layers kept (None: all), prefill (b, text tokens), K2 launches
#: per prefill, what was cut and why).
FAMILIES = (
    ("gemma2_2b", None, (2, 8192), 0,
     "nothing cut; 2 x 8192 so the 4096 window binds on its 13 local "
     "layers; its attention softcap keeps every layer on the plain route"),
    ("whisper_base", None, (4, 448), 0,
     "nothing cut; frame embeddings (4, 1500, 512) bf16 from --seed stand "
     "in for the conv frontend (a stub in both packages); the decoder "
     "prefill is whisper's 448-token context; encdec attention is the "
     "plain route"),
    ("llama4_scout_17b", 2, (4, 4096), 2,
     "2 of 48 layers at published widths: 106.7 B parameters (213.5 GB "
     "even in bf16) do not fit in 80 GB"),
)
#: The configs ``full_depth_serve`` runs whole, after every phase that
#: holds large tensors: (config, prefill (b, text tokens), K2 launches per
#: prefill (one a layer), the dtype its weights are stored in, what was
#: cut and why).  command-r-35b and llava-next-34b store bf16 weights
#: (``param_dtype``, the reference's own field): their f32 trees (121.1 and
#: 135.7 GB) do not fit in 80 GB, and ``bf16_storage_check`` shows the
#: products bitwise those of f32 storage.
FULL_DEPTH = (
    ("starcoder2_3b", (4, 4096), 30, "float32",
     "nothing cut; its f32 weights (12.1 GB)"),
    ("command_r_35b", (4, 4096), 40, "bfloat16",
     "nothing cut; weights stored in bf16 (param_dtype): 60.6 GB where f32 "
     "takes 121.1 GB; products bitwise those of f32 storage"),
    ("llava_next_34b", (1, 1216), 60, "bfloat16",
     "nothing cut; weights stored in bf16 (param_dtype): 67.9 GB where f32 "
     "takes 135.7 GB; products bitwise those of f32 storage; 2880 patch "
     "embeddings (bf16, from --seed, the vision tower is a stub) and 1216 "
     "text tokens make 4096"),
)
#: (prompt, new) tokens of the 4 requests ``greedy_generate`` serves in
#: ``family_serve``: those of ``serve_main_path``, so that decode tokens/s
#: compare across the serving phases.
GENERATE = (64, 32)
#: Warm decode steps ``family_serve`` profiles.
DECODE_PROFILE_STEPS = 2


def recording(out: list):
    """A wrapper of ``moe.route`` that appends each call's routing."""
    def wrap(route):
        def run(cfg, p, x):
            r = route(cfg, p, x)
            out.append(r)
            return r
        return run
    return wrap


def moe_profile(fn) -> dict:
    """Device time of one ``fn()`` call, the MoE layer's share of it (each
    call of ``moe_ffn`` under a ``record_function`` range) and the share
    of each of its parts by ``MOE_OPS``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import transformer as T

    def traced(moe_ffn):
        def run(*args):
            with record_function("moe_ffn"):
                return moe_ffn(*args)
        return run

    torch.cuda.synchronize()
    with patched(T, "moe_ffn", traced), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.key != "moe_ffn")
    if not total_us > 0:
        return {"device_ms": "not measured"}
    cpu = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CPU]

    def in_moe(ev) -> bool:
        parent = ev.cpu_parent
        while parent is not None:
            if parent.name == "moe_ffn":
                return True
            parent = parent.cpu_parent
        return False

    layers = [ev for ev in cpu if ev.name == "moe_ffn"]
    moe_us = sum(ev.device_time_total for ev in layers)
    parts = {kind: sum(ev.device_time_total for ev in cpu
                       if ev.name == op and in_moe(ev)) / total_us
             for kind, op in MOE_OPS.items()}
    return {"device_ms": total_us / 1e3, "moe_layers": len(layers),
            "moe_share_of_device": moe_us / total_us,
            "moe_part_share_of_device": parts,
            "moe_parts_share_of_moe": sum(parts.values()) * total_us / moe_us
            if moe_us else "not measured"}


def phase_moe_serve_main_path(seed: int):
    """granite-moe-3b-a800m at its published widths and depth through
    ``serve_main_path`` (32 tensor-core K2 launches per prefill), then one
    more warm 4 x 4096 prefill with its routing recorded (capacity, the
    share of choices dropped) and profiles of a prefill and a decode step
    by the MoE layer's parts."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import init_cache, moe
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg, params, launches, per_prefill = serve_main_path(
        "moe_serve_main_path", "granite_moe_3b", seed, k2_counts(fk, 32),
        use_flash=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"granite-moe-3b parameters: {n_params}", flush=True)
    if n_params != GRANITE_PARAMS:
        raise AssertionError(f"granite-moe-3b tree holds {n_params} "
                             f"parameters, expected {GRANITE_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4096), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg, use_flash=True, last_token_only=True)
    routes: list = []
    with patched(moe, "route", recording(routes)):
        prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    capacity = sorted({r.capacity for r in routes})
    dropped = [1.0 - r.keep.float().mean().item() for r in routes]
    if len(routes) != cfg.num_layers or capacity != [4096]:
        raise AssertionError(f"{len(routes)} MoE layers routed at capacity "
                             f"{capacity}, expected {cfg.num_layers} at 4096")
    del routes
    prof_prefill = moe_profile(lambda: prefill(params, {"tokens": tokens}))
    step = make_decode_step(cfg)
    cache = init_cache(cfg, 4, 96, device="cuda")
    pos = torch.full((4,), 63, dtype=torch.long, device="cuda")
    decode_routes: list = []
    with patched(moe, "route", recording(decode_routes)):
        step(params, tokens[:, -1:], pos, cache)
    torch.cuda.synchronize()
    decode_dropped = [1.0 - r.keep.float().mean().item()
                      for r in decode_routes]
    prof_decode = moe_profile(lambda: step(params, tokens[:, -1:], pos,
                                           cache))
    emit("moe_serve_layer", model=cfg.name, experts=cfg.num_experts,
         top_k=cfg.top_k, prefill_batch=[4, 4096], capacity=capacity[0],
         dropped_share_mean=sum(dropped) / len(dropped),
         dropped_share_by_layer=dropped,
         decode_batch=4, decode_capacity=decode_routes[0].capacity,
         decode_dropped_share_mean=sum(decode_dropped) / len(decode_dropped),
         profile_warm_prefill=prof_prefill, profile_decode_step=prof_decode)
    return cfg, params, launches, per_prefill


def phase_moe_serve_crosscheck(cfg, params, seed: int):
    """granite-moe-3b in f32 on the same weights, 1 x 1024: prefill logits
    with K2's f32 route against K2's plain version (atol 1e-3), and the
    first MoE layer on the card against the same call on the CPU."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serve import make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg32, use_flash=True)
    inputs: list = []

    def first_input(moe_ffn):
        def run(cfg_, p, x):
            if not inputs:
                inputs.append(x.detach().clone())
            return moe_ffn(cfg_, p, x)
        return run

    k2_routes: list = []
    before, before_tc = fk.launches, fk.launches_tc
    with patched(moe, "route", recording(k2_routes)), \
            patched(T, "moe_ffn", first_input):
        flash = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if (fk.launches - before, fk.launches_tc) != (cfg.num_layers, before_tc):
        raise AssertionError("f32 prefill did not run K2's f32 route in "
                             "every layer")
    plain_routes: list = []
    with plain_route(fops, "flash_attention_bhsd", fk.flash_attention_plain), \
            patched(moe, "route", recording(plain_routes)):
        plain = prefill(params, {"tokens": tokens})
    # A routing decision within the f32 noise of the attention can go
    # another way in the plain run; the comparison of the kernel is then
    # made with the plain run routed as the kernel's run was.
    flipped = sum(int((a.idx != b.idx).sum()) + int((a.keep != b.keep).sum())
                  for a, b in zip(k2_routes, plain_routes))
    if flipped:
        replay = iter(k2_routes)
        with plain_route(fops, "flash_attention_bhsd",
                         fk.flash_attention_plain), \
                patched(moe, "route", lambda _: lambda *a: next(replay)):
            plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    err_plain = (flash - plain).abs().max().item()
    if not err_plain <= SERVE_TOL:
        raise AssertionError(f"f32 granite prefill with K2 vs its plain "
                             f"version: max abs err {err_plain} > "
                             f"{SERVE_TOL}")

    # The first MoE layer, card against CPU, on its input in that run.
    x = inputs[0]
    p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
    p0_cpu = {k: v.detach().cpu() for k, v in p0.items()}
    with torch.no_grad():
        out, aux = moe.moe_ffn(cfg32, p0, x)
        r = moe.route(cfg32, p0, x)
        out_cpu, aux_cpu = moe.moe_ffn(cfg32, p0_cpu, x.cpu())
        r_cpu = moe.route(cfg32, p0_cpu, x.cpu())
        probs = torch.softmax(x.reshape(-1, cfg.d_model).cpu()
                              @ p0_cpu["router"], dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    margin = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
    near_ties = int((margin < 1e-6).sum())
    scale = out_cpu.abs().max().item()
    err_moe = (out.cpu() - out_cpu).abs().max().item()
    same_kept = torch.equal(r.keep.cpu(), r_cpu.keep)
    same_idx = torch.equal(r.idx.cpu(), r_cpu.idx)
    print(f"granite MoE layer 0, card vs CPU: max abs err {err_moe} (max "
          f"|out| {scale}), same experts {same_idx}, same kept set "
          f"{same_kept}, tokens with a top-{cfg.top_k} margin below 1e-6: "
          f"{near_ties}", flush=True)
    if not (same_kept and same_idx):
        raise AssertionError(f"the MoE layer on the card keeps another set "
                             f"than on the CPU ({near_ties} tokens within "
                             "1e-6 of a tie)")
    if not err_moe <= 1e-4 * scale:
        raise AssertionError(f"MoE layer card vs CPU: max abs err {err_moe} "
                             f"> 1e-4 x {scale}")
    emit("moe_serve_crosscheck", dtype="float32", batch=[1, 1024],
         logits_abs_max=flash[..., :cfg.vocab_size].abs().max().item(),
         atol=SERVE_TOL,
         k2_vs_plain_max_abs_err=err_plain,
         routing_choices_differing_unpinned=flipped,
         plain_run_routed_as_kernel_run=bool(flipped),
         moe_layer_card_vs_cpu_max_abs_err=err_moe,
         moe_layer_out_abs_max=scale, moe_layer_tol_share_of_max=1e-4,
         moe_layer_same_experts=same_idx, moe_layer_same_kept_set=same_kept,
         moe_layer_capacity=r.capacity,
         moe_layer_dropped_share=1.0 - r_cpu.keep.float().mean().item(),
         aux_card=aux.item(), aux_cpu=aux_cpu.item(),
         tokens_top_k_margin_below_1e_6=near_ties)


def family_serve(phase: str, name: str, layers, shape, k2_per_prefill: int,
                 cut: str, seed: int, *, param_dtype: str = "float32"
                 ) -> tuple[str, int, int]:
    """One config at its published widths (``layers`` deep when cut, its
    weights stored in ``param_dtype``): prefill cold and warm with K2's
    launches per prefill, then ``greedy_generate`` for 4 requests of
    ``GENERATE`` (prompt, new) tokens, one decode step's logits at
    position 0 of an empty cache, and a profile of the
    ``DECODE_PROFILE_STEPS`` warm decode steps that follow it over the
    next prompt tokens.  Raises where the model does not fit or K2 does
    not run in every attention layer.  Returns (the model's name, its K2
    launches, K2 launches per prefill)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import init_cache, init_model, moe
    from repro_torch.serve import (
        greedy_generate,
        make_decode_step,
        make_prefill_step,
    )

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), param_dtype=param_dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in params.parameters())
    dtypes = sorted({str(p.dtype) for p in params.parameters()})
    if dtypes != [f"torch.{param_dtype}"]:
        raise AssertionError(f"{name}: weights stored in {dtypes}, expected "
                             f"{param_dtype}")
    b, s = shape
    act = cfg.activation_dtype()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.num_patches, cfg.d_model), generator=gen,
            device="cuda").to(act)
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn(
            (b, cfg.num_frames, cfg.d_model), generator=gen,
            device="cuda").to(act)
    n_prompt, n_new = GENERATE
    prompts = torch.randint(0, cfg.vocab_size, (4, n_prompt), generator=gen,
                            device="cuda")
    prefill = make_prefill_step(cfg, use_flash=True, last_token_only=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, per_prefill, routes = [], [], []
    for _ in range(2):  # cold, warm
        before = (fk.launches, fk.launches_tc)
        t0 = time.perf_counter()
        with patched(moe, "route", recording(routes)):
            logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_prefill.append([fk.launches - before[0],
                            fk.launches_tc - before[1]])
    moe_fields = {} if not routes else {
        "moe_capacity": sorted({r.capacity for r in routes}),
        "moe_dropped_share_mean": sum(
            1.0 - r.keep.float().mean().item() for r in routes) / len(routes)}
    del routes
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    step = make_decode_step(cfg)
    positions = torch.arange(n_prompt, device="cuda")[:, None].repeat(1, 4)
    cache = init_cache(cfg, 4, n_prompt + n_new, device="cuda")
    step_logits, cache = step(params, prompts[:, :1], positions[0], cache)
    torch.cuda.synchronize()
    launches = fk.launches
    decoded = [cache, 0]  # the cache and the last position written

    def decode_next():
        decoded[1] += 1
        _, decoded[0] = step(params, prompts[:, decoded[1]:decoded[1] + 1],
                             positions[decoded[1]], decoded[0])

    prof_decode = profile_device(
        decode_next, steps=DECODE_PROFILE_STEPS,
        shares={"k2_share_of_device": KERNEL_OF[torch.bfloat16]})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.mem_get_info()[1] / 1e9
    tokens = b * (s + cfg.num_patches if cfg.family == "vlm" else s)
    if per_prefill != [[k2_per_prefill, k2_per_prefill]] * 2:
        raise AssertionError(f"{name}: K2 launches per prefill (all, "
                             f"tensor-core) {per_prefill}, expected "
                             f"{k2_per_prefill} tensor-core each")
    for what, x in (("prefill", logits), ("decode", step_logits)):
        if x.shape != (b if what == "prefill" else 4, 1, cfg.padded_vocab) \
                or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: bad {what} logits "
                                 f"{tuple(x.shape)}")
    if out.shape != (4, n_prompt + n_new) or \
            not torch.equal(out[:, :n_prompt], prompts) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{name}: bad greedy output {tuple(out.shape)}")
    if not max(init_peak_gb, peak_gb) < total_gb:
        raise AssertionError(f"{name}: peak memory {peak_gb} GB (init "
                             f"{init_peak_gb} GB) beyond the card's "
                             f"{total_gb} GB")
    emit(phase, model=cfg.name, family=cfg.family,
         layers=cfg.num_layers, published_layers=get_config(name).num_layers,
         reduced=cut, d_model=cfg.d_model, heads=[cfg.num_heads,
                                                  cfg.kv_heads],
         head_dim=cfg.head_size, params=n_params, param_dtype=param_dtype,
         dtype=cfg.dtype, init_s=init_s, init_peak_memory_gb=init_peak_gb,
         prefill_batch=[b, s], prefill_tokens=tokens,
         prefill_cold_s=walls[0], prefill_warm_s=walls[1],
         prefill_cold_tokens_per_s=tokens / walls[0],
         prefill_warm_tokens_per_s=tokens / walls[1],
         k2_launches_per_prefill=per_prefill[0][1], k2_launches=launches,
         generate_requests=4, generate_prompt=n_prompt, generate_new=n_new,
         generate_s=gen_s, decode_new_tokens_per_s=4 * n_new / gen_s,
         peak_memory_gb=peak_gb, memory_total_gb=total_gb, **moe_fields,
         profile_decode_step=prof_decode,
         seconds=time.perf_counter() - t_start)
    del params, cache, decoded, logits, step_logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    return cfg.name, launches, per_prefill[0][1]


def phase_families_serve(seed: int) -> dict:
    """Every config of ``FAMILIES`` through the port, one after another,
    each model's weights freed before the next one's are built.  Returns
    K2's launches by model."""
    return {model: launches for model, launches, _ in (
        family_serve("families_serve", *entry, seed + i)
        for i, entry in enumerate(FAMILIES))}


def phase_full_depth_serve(seed: int) -> dict:
    """Every config of ``FULL_DEPTH`` at its published depth and widths
    through ``family_serve``.  Returns (K2's launches, K2's launches per
    prefill) by model."""
    out = {}
    for i, (name, shape, k2, param_dtype, cut) in enumerate(FULL_DEPTH):
        model, launches, per_prefill = family_serve(
            "full_depth_serve", name, None, shape, k2, cut, seed + 30 + i,
            param_dtype=param_dtype)
        out[model] = (launches, per_prefill)
    return out


def phase_bf16_storage_check(seed: int) -> None:
    """command-r-35b and llava-next-34b cut to 2 layers, f32 weights from
    ``seed``: the bf16 prefill with K2 on the f32-stored tree and on the
    same tree cast to bf16 give bitwise the same logits (every product
    casts its weight to the activation dtype at use), which is what lets
    ``full_depth_serve`` store their weights in bf16."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import init_model
    from repro_torch.serve import make_prefill_step

    for i, (name, shape) in enumerate((("command_r_35b", (1, 4096)),
                                       ("llava_next_34b", (1, 1216)))):
        cfg32 = dataclasses.replace(get_config(name), num_layers=2)
        cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16")
        gen = torch.Generator(device="cuda").manual_seed(seed + 40 + i)
        params = init_model(cfg32, gen, device="cuda")
        batch = {"tokens": torch.randint(0, cfg32.vocab_size, shape,
                                         generator=gen, device="cuda")}
        if cfg32.family == "vlm":
            batch["patch_embeds"] = torch.randn(
                (shape[0], cfg32.num_patches, cfg32.d_model), generator=gen,
                device="cuda").to(cfg32.activation_dtype())
        runs = []
        for cfg in (cfg32, cfg16):
            if cfg is cfg16:
                params = params.to(torch.bfloat16)
            before = fk.launches_tc
            runs.append(make_prefill_step(cfg, use_flash=True)(params, batch))
            torch.cuda.synchronize()
            if fk.launches_tc - before != cfg.num_layers:
                raise AssertionError(f"{name}: the {cfg.param_dtype}-stored "
                                     "prefill did not run the tensor-core "
                                     "K2 in every layer")
        f32_stored, bf16_stored = runs
        equal = torch.equal(f32_stored, bf16_stored)
        diff = (f32_stored.float() - bf16_stored.float()).abs().max().item()
        finite = bool(torch.isfinite(f32_stored).all())
        emit("bf16_storage_check", model=cfg32.name, layers=2,
             batch=list(shape), logits_shape=list(f32_stored.shape),
             dtype=cfg32.dtype, logits_bitwise_equal=equal,
             max_abs_diff=diff, logits_finite=finite)
        if not (equal and finite):
            raise AssertionError(f"{name}: bf16-stored prefill logits differ "
                                 f"from the f32-stored tree's (max abs diff "
                                 f"{diff}, finite {finite})")
        del params, runs, f32_stored, bf16_stored, batch
        gc.collect()
        torch.cuda.empty_cache()


#: The dry-run's cells on the card's host: (arch, shape, flags).  olmo-1b
#: trains on both production meshes with the cost samples; granite's MoE
#: group pin runs over ("pod", "data") on the multi-pod mesh (memory
#: only, as the reference's help gives --skip-cost for that pass); and
#: zamba2's long_500k (batch 1) shards the caches' sequence over data.
DRYRUN_CELLS = (
    ("olmo-1b", "train_4k", ("--both-meshes",)),
    ("granite-moe-3b", "prefill_32k", ("--multi-pod", "--skip-cost")),
    ("zamba2-2.7b", "long_500k", ()),
)
#: How far the card's peak may sit from the dry-run's temp bytes.
DRYRUN_TEMP_REL = 0.10
DRYRUN_TEMP_ABS = 256 * 2**20


def dryrun_cells() -> list[dict]:
    """(a) ``python -m repro_torch.launch.dryrun`` on each of
    ``DRYRUN_CELLS``, all started together on the host (no card: they
    trace ``meta`` tensors under a fake process group of 512 ranks);
    every cell must be OK.  Returns the reports."""
    import os
    import signal
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    (ROOT / "build").mkdir(exist_ok=True)
    outdir = Path(tempfile.mkdtemp(prefix="dryrun-", dir=ROOT / "build"))
    procs = []
    try:
        for arch, shape, flags in DRYRUN_CELLS:
            out = outdir / f"{arch}-{shape}.json"
            procs.append((out, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, *flags, "--out", str(out)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)))
        reports = []
        for out, t0, proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(
                    f"{proc.args[3:]} exited {proc.returncode}:\n"
                    f"{stdout[-2000:]}\n{stderr[-4000:]}")
            for r in json.loads(out.read_text()):
                if r["status"] != "OK":
                    raise AssertionError(f"dry-run cell not OK: {r}")
                r["process_s"] = time.perf_counter() - t0
                reports.append(r)
        return reports
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


def phase_dryrun_main_path(seed: int) -> dict:
    """(a) the dry-run's cells on the host (``dryrun_cells``), each cell's
    per-device bytes, FLOPs, collectives, roofline terms and useful ratio
    printed; (b) on the card, ``make_host_mesh()`` is a (1, 1) ``cuda``
    mesh, and olmo-1b at its published widths, traced by the dry-run for
    a 1 x 4096 prefill on that mesh, is held to the real thing: its f32
    ``ParamTree`` distributed by ``param_specs``, and the tokens by
    ``batch_specs``, take exactly the trace's argument bytes (the bytes
    their tensors requested of the caching allocator; its
    ``memory_allocated``, which rounds each block up, printed beside
    them); the same prefill on the same plain
    route on plain tensors peaks (``max_memory_allocated`` less the
    arguments) within 10% or 256 MiB of its temp bytes, whichever is
    larger; ``FlopCounterMode`` counts the trace's (depth-extrapolated)
    FLOPs exactly.  The prefill's time is printed beside the roofline's
    bound, not gated.  No kernel runs on this path: the counters stay 0."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_host_mesh, make_host_mesh
    from repro_torch.models import init_model
    from repro_torch.serve import make_prefill_step
    from repro_torch.sharding.specs import (
        batch_specs,
        distribute,
        distribute_tree,
        param_specs,
    )

    t_start = time.perf_counter()
    cells = dryrun_cells()
    for r in cells:
        emit("dryrun_cell", **{k: r.get(k) for k in (
            "arch", "shape", "multi_pod", "chips", "argument_bytes",
            "output_bytes", "temp_bytes", "flops", "bytes", "coll_bytes",
            "collective_counts", "compute_s", "memory_s", "collective_s",
            "dominant", "model_flops", "useful_ratio", "compile_s",
            "cost_compile_s", "process_s")})

    mesh = make_host_mesh()
    try:
        if mesh.device_type != "cuda" or tuple(mesh.mesh.shape) != (1, 1):
            raise AssertionError(f"host mesh {mesh}")
        cfg = get_config("olmo_1b")
        shape = ShapeConfig("prefill_4k", 4096, 1, "prefill")
        report = dryrun.lower_cell("olmo-1b", shape.name, cfg=cfg,
                                   shape=shape, mesh=mesh, verbose=False)
        full = dryrun.trace_cell(cfg, shape, mesh)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        base_req = requested_bytes()
        gen = torch.Generator(device="cuda").manual_seed(seed + 24)
        params = init_model(cfg, gen, device="cuda")
        dparams = distribute_tree(params, mesh,
                                  param_specs(cfg, mesh, params))
        tokens = torch.randint(0, cfg.vocab_size, (1, shape.seq_len),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        dtokens = distribute(tokens, mesh,
                             batch_specs(cfg, mesh, shape)["tokens"])
        del params, tokens
        gc.collect()
        torch.cuda.synchronize()
        # The allocator's blocks round the tensors up (a large block keeps
        # a segment's tail of up to 1 MiB), so the exact count is the
        # bytes its live tensors requested; memory_allocated is beside it.
        args_bytes = requested_bytes() - base_req
        args_blocks = torch.cuda.memory_allocated() - base
        if args_bytes != report["argument_bytes"]:
            raise AssertionError(
                f"argument bytes: card {args_bytes} requested "
                f"({args_blocks} in blocks), dry-run "
                f"{report['argument_bytes']}")

        plain = dryrun_plain_tree(dparams)
        batch = {"tokens": dtokens.to_local()}
        step = make_prefill_step(cfg)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        logits = step(plain, batch)
        torch.cuda.synchronize()
        peak_temp = torch.cuda.max_memory_allocated() - base - args_blocks
        launches = model_kernel_launches()
        if any(launches.values()):
            raise AssertionError(f"kernels on the plain route: {launches}")
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError("non-finite logits")
        del logits
        gap = abs(peak_temp - report["temp_bytes"])
        allowed = max(DRYRUN_TEMP_REL * report["temp_bytes"],
                      DRYRUN_TEMP_ABS)
        if gap > allowed:
            raise AssertionError(
                f"temp bytes: card peak {peak_temp}, dry-run "
                f"{report['temp_bytes']} (allowed {allowed:.0f})")
        with FlopCounterMode(display=False) as fc:
            step(plain, batch)
        card_flops = fc.get_total_flops()
        if card_flops != report["flops"] or \
                card_flops != full.roofline.flops:
            raise AssertionError(
                f"FLOPs: FlopCounterMode {card_flops}, dry-run "
                f"{report['flops']} (full-depth trace "
                f"{full.roofline.flops})")
        prefill_ms = cuda_ms(lambda: step(plain, batch), 3)
        entry = {"mesh": [1, 1], "device_type": mesh.device_type,
                 "model": cfg.name, "prefill": [1, shape.seq_len],
                 "argument_bytes": args_bytes,
                 "argument_block_bytes": args_blocks,
                 "dryrun_argument_bytes": report["argument_bytes"],
                 "peak_temp_bytes": peak_temp,
                 "dryrun_temp_bytes": report["temp_bytes"],
                 "temp_gap_bytes": gap, "temp_allowed_bytes": allowed,
                 "flops": card_flops, "dryrun_flops": report["flops"],
                 "dryrun_bytes": report["bytes"],
                 "dryrun_output_bytes": report["output_bytes"],
                 "prefill_ms": prefill_ms,
                 "roofline_bound_ms": 1e3 * max(
                     report["compute_s"], report["memory_s"],
                     report["collective_s"]),
                 "dominant": report["dominant"],
                 "cells": len(cells),
                 "seconds": time.perf_counter() - t_start}
        emit("dryrun_main_path", **entry)
        del plain, batch, dparams, dtokens
        gc.collect()
        torch.cuda.empty_cache()
        return entry
    finally:
        close_host_mesh()


def requested_bytes() -> int:
    """The bytes the live CUDA tensors asked the caching allocator for."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dryrun_plain_tree(tree):
    """A ParamTree of DTensors on a one-device mesh as plain tensors
    (each local shard is the whole tensor there), sharing their storage."""
    from repro_torch.models.params import ParamTree

    def plain(node):
        if isinstance(node, (dict, ParamTree)):
            return {k: plain(v) for k, v in node.items()}
        return node.to_local()

    return ParamTree(plain(tree))


def phase_flash_timing_model(phase: str, shape, seed: int,
                             serve_launches: int, per_prefill: int) -> dict:
    """K2 bf16 at a model's prefill call ``shape`` (b, h, kvh, s, hd),
    causal: its time beside its bound, its plain version and
    ``F.scaled_dot_product_attention``, with the fields of phase 13."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    b, h, kvh, s, hd = shape
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = flash_inputs(gen, b, h, kvh, s, hd, dtype)
    kw = dict(scale=hd ** -0.5)
    got = fk.flash_attention_cuda(q, k, v, **kw)
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    max_err = (got.float() - want.float()).abs().max().item()
    plain_ms = cuda_ms(lambda: fk.flash_attention_plain(q, k, v, **kw), 2)
    gqa = {"enable_gqa": True} if kvh != h else {}
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=kw["scale"], **gqa), 10)
    entry = {"shape": [b, h, kvh, s, hd], "dtype": "bfloat16",
             "launches": serve_launches, "launches_per_prefill": per_prefill,
             "max_abs_err": max_err, "plain_ms": plain_ms,
             **flash_speed(fk, q, k, v, kw, library_ms, dtype)}
    emit(phase, **entry)
    return entry


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    emit("phase_seconds", of=name, seconds=time.perf_counter() - t0)
    return out




def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the serving path's weights and inputs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "checks the port on a CUDA GPU", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = run_phase("environment", phase_environment)
    run_phase("kernel_vs_plain", phase_kernel_vs_plain)
    main_launches = run_phase("main_path", phase_main_path)
    wide_specs = run_phase("wide_rows", phase_wide_rows)
    des_launches = run_phase("des_main_path", phase_des_main_path)
    kp = run_phase("project_kernel_vs_plain", phase_project_kernel_vs_plain,
                   des_launches)
    scenario_launches = run_phase("scenarios_cli", phase_scenarios_cli)
    kp["launches_by_path"].update(scenario_launches["project"])
    service = run_phase("service_main_path", phase_service_main_path)
    kp["launches_by_path"]["service paper-fb-live"] = \
        service["project_launches"]
    kp["launches"] = sum(kp["launches_by_path"].values())
    k1 = run_phase("kernel_timing", phase_kernel_timing, main_launches,
                   wide_specs)
    # K1 runs on the accel matrix, both cells of the discrete-event path
    # (one call per virtual-cluster water-fill) and the scenario entry
    # points (the worker's accel batch, one hfsp cell of the CLI's sweep)
    # and the live service's session.
    k1["launches_by_path"] = {"accel paper-64": main_launches, **{
        f"des {cell}": c["k1_launches"] for cell, c in des_launches.items()},
        **scenario_launches["k1"],
        "service paper-fb-live": service["k1_launches"]}
    k1["launches"] = sum(k1["launches_by_path"].values())
    run_phase("flash_kernel_vs_plain", phase_flash_kernel_vs_plain, args.seed)
    cfg, params, serve_launches, per_prefill = run_phase(
        "serve_main_path", phase_serve_main_path, args.seed)
    run_phase("serve_crosscheck", phase_serve_crosscheck, cfg, params,
              args.seed)
    run_phase("serve_crosscheck_bf16", phase_serve_crosscheck_bf16, cfg,
              params, args.seed)
    del params
    k2 = run_phase("flash_timing", phase_flash_timing, args.seed,
                   serve_launches, per_prefill)
    torch.cuda.empty_cache()  # olmo-1b's weights are gone before rwkv6's
    run_phase("rwkv6_kernel_vs_plain", phase_rwkv6_kernel_vs_plain, args.seed)
    cfg, params, serve_launches, per_prefill = run_phase(
        "rwkv_serve_main_path", phase_rwkv_serve_main_path, args.seed)
    run_phase("rwkv_serve_crosscheck", phase_rwkv_serve_crosscheck, cfg,
              params, args.seed)
    del params
    torch.cuda.empty_cache()
    k3 = run_phase("rwkv6_timing", phase_rwkv6_timing, args.seed,
                   serve_launches, per_prefill)
    run_phase("ssd_kernel_vs_plain", phase_ssd_kernel_vs_plain, args.seed)
    cfg, params, zamba_launches, zamba_per_prefill = run_phase(
        "zamba_serve_main_path", phase_zamba_serve_main_path, args.seed)
    run_phase("zamba_serve_crosscheck", phase_zamba_serve_crosscheck, cfg,
              params, args.seed)
    del params
    torch.cuda.empty_cache()
    k4 = run_phase("ssd_timing", phase_ssd_timing, args.seed,
                   zamba_launches["k4"], zamba_per_prefill["k4"])
    # K2 runs on two main paths: olmo-1b's prefill (hd 128) and zamba2's
    # shared block (hd 80).
    k2["zamba2_hd80"] = run_phase(
        "flash_timing_hd80", phase_flash_timing_model, "flash_timing_hd80",
        (4, 32, 32, 4096, 80), args.seed + 9, zamba_launches["k2"],
        zamba_per_prefill["k2"])
    k2["launches_by_path"] = {"olmo-1b": k2["launches"],
                              "zamba2-2.7b": zamba_launches["k2"]}
    k2["launches"] += zamba_launches["k2"]
    run_phase("train_main_path", phase_train_main_path, args.seed)
    gang = run_phase("gang_main_path", phase_gang_main_path, args.seed)
    ml = run_phase("ml_workload", phase_ml_workload)
    # HFSP's virtual clusters run K1 and P in the gang runtime and in
    # ml-workload's hfsp cell too.
    for entry, key in ((k1, "k1_launches"), (kp, "project_launches")):
        entry["launches_by_path"]["gang hfsp"] = gang[key]
        entry["launches_by_path"]["ml-workload hfsp"] = ml[key]
        entry["launches"] = sum(entry["launches_by_path"].values())
    cfg, params, moe_launches, moe_per_prefill = run_phase(
        "moe_serve_main_path", phase_moe_serve_main_path, args.seed)
    run_phase("moe_serve_crosscheck", phase_moe_serve_crosscheck, cfg,
              params, args.seed)
    del params
    torch.cuda.empty_cache()  # granite's weights are gone before the others'
    family_launches = run_phase("families_serve", phase_families_serve,
                                args.seed)
    run_phase("dryrun_main_path", phase_dryrun_main_path, args.seed)
    # K2 runs at head dim 64 on granite's prefill.
    k2["granite_hd64"] = run_phase(
        "flash_timing_hd64", phase_flash_timing_model, "flash_timing_hd64",
        (4, 24, 8, 4096, 64), args.seed + 11, moe_launches["k2"],
        moe_per_prefill["k2"])
    run_phase("bf16_storage_check", phase_bf16_storage_check, args.seed)
    full_depth = run_phase("full_depth_serve", phase_full_depth_serve,
                           args.seed)
    # K2 at command-r-35b's prefill call, the widest attention served.
    k2["command_r_hd128"] = run_phase(
        "flash_timing_command_r", phase_flash_timing_model,
        "flash_timing_command_r", (4, 64, 8, 4096, 128), args.seed + 12,
        *full_depth["command-r-35b"])
    k2["launches_by_path"][cfg.name] = moe_launches["k2"]
    k2["launches_by_path"].update(
        {name: n for name, n in family_launches.items() if n})
    k2["launches_by_path"].update(
        {name: n for name, (n, _) in full_depth.items()})
    k2["launches"] = sum(k2["launches_by_path"].values())
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [k1, k2, k3, k4, kp]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
