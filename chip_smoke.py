"""Chip smoke test of rabit_tpu_torch: builds the CUDA kernels and drives
the port's paths on one NVIDIA GPU -- the gradient-histogram allreduce,
the flagship transformer's training step, the histogram measurement
path (the sweep, the bench and the kernel proof), the robust engine, the
bucketed and overlapped train steps of the flagship and the MLP, the
parallelism families (sequence parallelism, the pipeline, the MoE, the
multichip dryrun), the telemetry and profiling plane, the skew plane
with the live plane that feeds it, the watchdog's ladder with the
flight recorder and the overlap bench, elastic membership with the
in-process resize, the tracker's write-ahead log with a world that
keeps computing through a tracker crash, and the hot standby with the
chaos front proxy, through which a world computes across the loss of
its leader with no respawn.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. build        nvcc every ``rabit_tpu_torch/csrc/*.cu`` into
                ``build/rabit_tpu_torch/`` (one nvcc a source, all
                started together); ptxas's registers and spills of every
                kernel (a flash or binning kernel may spill none); the
                tensor-core instructions (``HMMA``) of each flash forward
                and backward kernel in its SASS (``cuobjdump -sass``),
                which must be above 0.
1b. tile        the 3xTF32 score-tile function alone
                (``csrc/flash_mma.cuh``): one [64, DP] x [64, DP]^T tile
                against a torch f64 product at each DP, before the
                kernels built on it run; the forward's m' on the same
                tiles equal to the tile's row max, bit for bit.
2. kernel       each kernel against its plain PyTorch version on the card:
                the histogram at the main path's shapes and an edge case;
                the bin count (mask_only) exactly equal at the sweep's six
                shapes and at two edge cases (ragged rows in an unaligned
                view, ids -1, nbins, nbins + 40 and 2^30; 1000 bins, and
                120,000 bins over three shared-memory tiles); then
                torch.profiler counts the device operations of one window
                of five calls of each binning kernel at its main shapes,
                each call on inputs of its own: one kind of kernel, no
                memset or second kernel, the wrapper's launch count equal
                to the calls and each call's output agreeing with its
                plain version;
                the flash block forward and backward at the training shape
                (B*H 64, T = S 512, D 32, causal), the ring chain's block
                (H 8, T = S 1024, D 128, no mask), a causal mask whose
                first row is fully masked at m = NEG_INF (where masked
                tiles may not be skipped), the fully masked first-step row
                with an exact tie, a ragged case (T 100, S 72, D 16), a
                causal case at D 64, and a wide-range case (q and k x 4,
                so that s spans about +-100) at D 128.
3. main path    ``distributed_histogram`` through a world-1 NCCL group at
                the two full-width shapes, against the f64 host histogram.
4. rounds       ``init(engine="torch")`` on the card, then three boosting
                rounds at each boosted-round shape, each histogram against
                numpy ``bincount`` in f64; ``load_checkpoint`` ends at
                version 3.
5. transformer  ``train_flagship``: the full-width flagship (vocab 256, 2 x
                d_model 256, 8 x 32 heads, d_ff 1024, seq 512, batch 8)
                takes 16 SGD steps on a world-1 NCCL mesh and its loss
                falls; then one step through the kernels against the same
                step through the plain block update (loss and parameters
                within 5e-4), and a profile of three steps.
6. sweep        ``tools.histogram_sweep`` at its full grid (rows 2^20, 2^21
                x bins 256, 1024, 4096; mask_only, fast, high), no
                artifact: its six rows and its exact count check.
7. bench        ``rabit_tpu_torch.bench`` at full size (2^21 x 1024): its
                JSON line, which must say correct, no artifact.
8. proof        ``tools.kernel_hw_proof`` at full size, no artifact, and
                the flash kernels' launches on its chains.
9. timing       CUDA-event medians of each kernel, its plain version and
                one PyTorch call that computes the same function, beside
                the least time the card could take; for mask_only also
                the sweep's slope; for the flash backward also SDPA's
                backward alone (one ``autograd.grad`` over a retained
                graph a call, from saved forward outputs); the training
                step.
10. collectives the collective layer (``parallel/``) on the card: the wire
                codec (bf16 and int8, blocks 1024 and 512) against its
                plain CPU version bit for bit at the histogram payloads
                and 2^21 floats; every method through the dispatcher
                ``allreduce`` in an NCCL world of 1 (which returns x);
                ``dispatch.resolve`` over a table in a temporary file;
                with two cards or more, ``tools.collective_sweep
                --smoke`` at world min(4, cards) over NCCL, its rows.
11. robust      the robust engine under the port: the native core's build
                (g++, beside the nvccs of phase 1); ``tools.boosted_trees``
                at the headline shape (64 features x 16 buckets x 32,768
                rows: 2^21 entries into 1024 bins a rank), six rounds,
                under the port's launcher at world 1 (mock engine,
                ``rabit_ckpt_dir``): a kill at round 3, the respawn's cold
                restart from the durable store at version 3, trees equal to
                the run without a kill bit for bit, the histogram kernel
                launched every round; the histogram payload through
                ``TorchEngine`` at world 1; with two cards or more, at world
                min(4, cards) with the torch data plane over NCCL
                (``rabit_dataplane_minbytes=0``): a run without a kill, a
                kill of rank 1 at round 3 and a scripted data-plane failure
                end with the same trees on every rank, the epoch advanced;
                the allreduce's host-paced ms through the robust engine and
                through ``TorchEngine``, the seconds from the kill to the
                first collective of the re-formed world and to form the
                NCCL world.
12. bucket      the bucketed and overlapped train steps: (a) the
                full-width flagship (1,836,288 f32 parameters in 20
                leaves, one 7.35 MB bucket) on a world-1 NCCL mesh, 4 steps
                each of ``"psum"``, ``"bucket"`` and the async bucket step
                (``RABIT_ASYNC_COLLECTIVES=1``) from the same weights and
                data: equal bit for bit (at world 1 every sum is the
                identity), flash_block and flash_block_bwd launched 2 x 4
                times in each run, each step's ms on CUDA events; an async
                allreduce issued behind a sleeping stream, not ready until
                the stream ran; (b) the MLP 256 -> 512 -> 128, batch 64,
                under ``"psum"``, ``"ring"``, ``"bucket"`` and async bucket,
                4 steps each, within tests/test_models.py's bounds of its
                single-device step, bucket = ring and async = bucket bit
                for bit; (c) with two cards or more, at world min(4,
                cards) over NCCL: every device and async entry point on
                f32 and i32 payloads of 4,096 and 2,097,152 elements (hier
                at 2 x 2, a mixed-dtype tree) equal to the same calls on a
                gloo world bit for bit; the flagship's bucket step within
                5e-4 of its psum step and the async step equal to the
                bucket step bit for bit at (dp, tp, sp) = (2, 1, 2); the
                MLP at (2, 2, 1) as in (b); the step times, and one
                ``device_allreduce_tree`` of the flagship's gradient tree
                by "auto", "tree" and "ring". With one card it prints that
                (c) did not run.
13. parallel    the parallelism families, one process a card over NCCL at
                world p = min(4, cards): ``sequence_parallel_attention``,
                ring and Ulysses, causal, at the flash chain's width (T
                8192, H 8, D 128) and at ``tools.long_context``'s (T 512
                p, H 8, D 32), forward and the gradients of sum(out * ct)
                against the dense oracle (forward 1e-4, gradients 1e-3 of
                the largest) and against each other, the ring's flash
                launches of one call p forward and p backward block steps
                on every rank (counted from 0 around the call), the ms of
                forward and forward + backward; the MoE at the dryrun's
                shapes against the dense oracle without drops (2e-5) and
                timed steps at d_model 256, d_ff 1024, 4096 tokens a rank,
                capacity factor 2.0; the pipeline at the dryrun's shapes
                against the stages composed on one card (forward 1e-5,
                gradient 1e-4) and timed steps at d 1024, 8 microbatches
                of 512 rows; then ``entry.dryrun_multichip(p)``. With one
                card it runs the p = 1 paths and says so.
14. telemetry   the telemetry and profiling plane (``rabit_telemetry=1``,
                ``rabit_profile=1``): (a) in a fresh process of an NCCL
                world of 1, each kernel library loaded twice through its
                wrapper (the profile's ``build:<name>``: one miss and one
                compile sample, hits after), then ``allreduce`` (tree and
                ring), ``device_allreduce_tree``, ``device_broadcast``,
                ``bucket_allreduce_async`` and ``device_allreduce_async``
                with the planes off and on: results bit for bit, one span
                a call with JAX's name, round and ``cost_*`` attributes,
                each async handle's exposed + overlapped within 1 us of
                its span, and under ``torch.profiler`` no kernel inside a
                ``rabit_*`` range that the run without lacks and as many
                host launches; the host us of one ``telemetry.span`` (a
                loop of 10,000, recorder on and off); (b) ``train_flagship``
                (16 steps, psum) with the planes off, on, on, off: losses
                and flash launches equal, ``device_mem.live_bytes`` equal
                to ``torch.cuda.memory_allocated()`` at the sample and the
                peak at least the parameters' bytes; then the same step
                in 12 turns off/on/on/off, 8 steps a turn, its ms on CUDA
                events and host wall, one step profiled each way; (c)
                with two cards or more, the histogram rounds (131,072 x
                28 x 256, 3 rounds, ``tools.histogram_rounds``) at world
                min(4, cards) under the port's launcher and tracker with
                ``TorchEngine`` over NCCL, planes off then on
                (``RABIT_TELEMETRY_EXPORT`` a temporary directory): the
                histograms bit for bit, the kernel launched every round on
                every rank, both files a rank with the JAX package's
                schema ids, one summary a rank through ``metrics``, the
                fleet table printed once with ``engine.allreduce`` 3 x
                ranks.
15. skew        the skew plane and the live plane (``telemetry/skew.py``,
                ``live.py``; no kernel): (a) in a fresh process of an
                NCCL world of 1, with ``rabit_skew_adapt`` off and a digest
                in the environment, ``allreduce`` and the issue of
                ``device_allreduce_async`` never enter the skew plane (its
                hooks made to raise), launch no broadcast kernel, make no
                host synchronisation and advance no dispatch counter; with
                the knob on, the agreement boundary adopts the local
                candidate with no broadcast and no host synchronisation;
                ``adapt_plan`` re-roots the tree at world 2 (the JAX
                package's skew smoke); the rank endpoint answers
                ``/metrics``, ``/healthz`` and ``/summary``; (b) with two
                cards or more, at world p = min(4, cards) over NCCL, a
                forced digest naming rank p - 1, one boundary a call: on
                f32 and i32 integer-valued payloads of 4,096 and 2,097,152
                elements, ``allreduce`` by "auto", ring, bidir, swing, hier
                at 2 x 2 (``RABIT_HIER_GROUP``) and preagg for SUM, MAX and
                MIN, ``device_reduce_scatter``, ``device_allgather``,
                ``device_allreduce_async`` and ``bucket_allreduce_async``,
                adapted, equal to the flat run and to the same calls on a
                gloo world bit for bit, the same plans on every rank and on
                gloo, one broadcast a boundary (its NCCL kernels under
                ``torch.profiler`` printed), and a boundary's host cost: a
                rotated ring allreduce of 4,096 f32 with the knob off, on
                between boundaries and on with a boundary every call, in
                turns; then every rank forces a
                candidate that accuses itself and after the boundary every
                rank applies rank 0's; at world 4, with those candidates,
                calls over the pairs {0, 1}, {2, 3} and the crossing pairs
                {0, 2}, {1, 3} plan nothing and broadcast nothing (a
                sub-group adopts no digest); (c) ``tools.skew_bench`` at world p
                (2,000,000 f32, rank 2 80 ms late, 6 rounds after 2), flat
                against adapted, each series' mean and rounds; (d) the
                tracker-driven run: ``tools.skew_round_worker --mode
                tracker`` under the port's launcher and tracker
                (``metrics_port`` 0, ``RABIT_METRICS_POLL_MS`` 200; the
                workers ``rabit_telemetry=1 rabit_metrics_port=0
                rabit_skew_adapt=1 rabit_skew_poll_ms=100
                rabit_skew_sync_rounds=4``, no forced digest), rank 2 (p -
                1 below world 4) 80 ms late before each of 40 allreduces of
                2,000,000 f32: the tracker's ``/straggler`` names it, its
                ``skew`` digest has it with an epoch of at least 1, every
                rank counts ``dispatch.skew_sync`` and
                ``dispatch.skew_adapted``, adopts at the same round, and
                every round's result is its exact sum with equal CRCs on
                every rank; the round of adoption. With one card it prints
                that (b)-(d) did not run.
16. watchdog    the watchdog's escalation ladder, the flight recorder and
                the overlap bench (``utils/watchdog.py``,
                ``telemetry/flight.py``, ``tools/overlap_bench.py``; no
                kernel; the stalls are ``tests/workers/torch_stall_worker.py``;
                every deadline well below the process groups' own timeouts):
                (a) ``python -m rabit_tpu_torch.telemetry --smoke``;
                ``overlap_bench``'s smoke on the card's tensors at world
                min(4, cards) (async = sync bit for bit, a live guard
                untripped, the in-flight window drained, async hier = sync
                hier); the robust engine's hung bootstrap with
                ``rabit_device=cuda`` (a tracker of 2 slots, one worker,
                ``rabit_deadline_ms`` 1500): exit 86 within 1.5 + 2 x 1.5 s
                plus 5 s and one ``watchdog_abort`` bundle naming
                ``engine.init`` with the threads' stacks; the host us of a
                guard armed and of ``NULL_GUARD``; (b) with two cards or
                more, at world p = min(4, cards) over NCCL: the overlap
                bench at the JAX worker's defaults (4 buckets of 1,000,000
                f32, compute dim 384, 5 steps after 2), both paths (the
                host API through ``TorchEngine``'s worker; device tensors
                through ``bucket_allreduce_async``), sync and overlap equal
                bit for bit and exact, the recorder's exposed/overlapped
                split and one bucket's compute and allreduce alone; the
                device path again at the least compute dim (384, 512, 768,
                ..., 3072) whose chain on card 0 takes at least a bucket's
                allreduce; ``TorchEngine`` with rank
                p - 1 asleep 5 s before an allreduce (deadline 2000 ms,
                abort off): every survivor's retry and reform rungs with
                their counters, events and notes, every sum exact; rank p -
                1 stopped with SIGSTOP (deadline 2000 ms): every survivor
                exits 86 within 2 + 2 x 2 + 5 s of the stall with a bundle
                whose stacks show the allreduce, then the stopped rank is
                killed and no worker holds a card (``nvidia-smi
                --query-compute-apps=pid``); the robust engine with the
                torch data plane, rank p - 1's data plane asleep 7 s inside
                a collective (deadline 6000 ms): every rank's retry rung
                marks the NCCL world aborted, the round fails once its
                collective ends and replays at a new epoch, every result
                equal to the clean run's bit for bit. With one
                card it says that (b) did not run.
17. elastic     elastic membership and the in-process resize
                (``tracker/membership.py``, the tracker's ``world``/
                ``evict``/``join``, the launcher's ``elastic``,
                ``rabit_tpu_torch.resize``): (a) in a fresh process on the
                card at world 1, ``resize("recover")``, ``("join")`` and
                ``("grow")`` under ``robust_torch`` (world 1 stays; a
                ValueError), ``empty`` and ``torch`` (NotImplementedError),
                as the JAX package's engines do; ``python -m
                rabit_tpu_torch.tracker.membership --smoke``; (b) with three
                cards or more, at world p = min(4, cards):
                ``tests/workers/torch_resize_worker.py`` under the port's
                launcher with ``elastic=True``, the robust engine,
                ``rabit_dataplane=torch`` and ``rabit_device=cuda``, once
                in a fixed world and once p -> p - 1 -> p in process (task
                1 evicts itself, the survivors ``resize("recover")``, task
                1 ``resize("join")``); each round an int64 allreduce of 256
                and a histogram of 2^21 rows x 1024 bins a rank built on
                the rank's card by the ``histogram`` kernel (grad and hess
                integers in [-8, 8] from the seed and the rank, so every
                f32 sum is exact) and allreduced over NCCL: every MID round
                its exact sum, every POST round equal to the fixed world's
                bit for bit, no respawn, each process on one card before,
                between and after the resizes (its current device and its
                data plane's), no two members of an epoch on one card, the
                kernel launched once a round on every member, a formation
                at every new epoch, and no worker left on a card
                (``nvidia-smi --query-compute-apps=pid``); the seconds from
                the victim's evict to the survivors' first MID collective,
                from its join to the first POST collective, and of each
                formation (``recovery.world_reform``). With fewer than
                three cards it says that (b) did not run.
18. resume      the tracker's write-ahead log and resume
                (``tracker/wal.py``, the tracker's journal, ``resume=True``
                and the ``resume`` handshake, the launcher's supervisor):
                ``python -m rabit_tpu_torch.tracker.wal --smoke``; then
                ``tests/workers/torch_resume_worker.py`` under the port's
                launcher (the robust engine, ``rabit_dataplane=torch``,
                ``rabit_device=cuda``), 30 rounds 200 ms apart, each an
                int64 allreduce of 256 and a histogram of 2^21 rows x 1024
                bins built on the rank's card by the ``histogram`` kernel
                (grad and hess integers in [-8, 8] from the seed and the
                rank) and allreduced, once uninterrupted without a WAL and
                once with ``RABIT_TRACKER_WAL_DIR``, the supervisor killing
                the tracker once every rank has logged round 5 and resuming
                it on the same port 1500 ms later: every round present and
                bit for bit the uninterrupted run's, one restart, no
                respawn, the kernel launched once a round, and ``resume``,
                ``epoch``, ``topo`` and a ``down`` a rank that shut down in
                the replayed journal; (a) at world 1 on card 0 (no
                eviction, epoch 1 throughout); (b) with two cards or more,
                at p = min(4, cards) with ``elastic=True``: after the
                resume task 1 evicts itself at round 20 and leaves, the
                survivors ``resize("recover")`` through the resumed
                tracker, which hosts epoch 2's store, and stream the rest
                at p - 1 (the one scripted eviction, epoch 2 at the end,
                each process on one card, no worker left on a card). Each
                part prints the outage as the workers saw it, the replay's
                records and ms, the journal's ms, and epoch 1's ``init``
                and formation s with the WAL off and on. With one card it
                says that (b) did not run.
19. failover    the hot standby and the chaos front proxy
                (``tracker/standby.py``, the leader's lease and ``repl``
                stream, the supervisor's adoption, the skew poller's
                failover, ``chaos/``): ``python -m
                rabit_tpu_torch.tracker.standby --smoke``; 8 MiB each way
                through a ``ChaosProxy`` with an empty schedule, byte for
                byte; then phase 18's worker, rounds and histogram under
                the port's launcher with a WAL, ``RABIT_TRACKER_STANDBY=1``,
                ``RABIT_LEASE_MS=800``, ``elastic=True`` and the chaos
                front proxy, each run against phase 18's uninterrupted run
                at the same world, seed and rounds (run here when the phase
                runs alone): (a) world 1 on card 0, once with
                ``tracker_kill`` (``delay_ms`` 4000, the cold respawn the
                adoption cancels) once every rank has logged round 5, once
                with ``tracker_partition`` over rounds 5-15: every round
                bit for bit, 1 failover, 0 restarts, 0 respawns, epoch 1,
                the kernel launched once a round, ``assign``, ``lease``,
                ``epoch`` and ``promoted`` in the standby's journal and a
                ``down`` a rank after the promotion (``finalize`` through
                the retargeted proxy), the deposed leader fenced in the
                partition run; (b) with two cards or more, at p = min(4,
                cards), the kill, then task 1 evicts itself at round 20
                and the survivors ``resize("recover")`` through the
                promoted standby, which hosts epoch 2's store (each process
                on one card, no two members of an epoch on one card, no
                worker left on a card). Each run prints the failover as the
                tracker measured it, the outage as the workers saw it, the
                deposed leader's acked seq and lag, the promotion's replay
                and, in (b), epoch 2's formation s. With one card it says
                that (b) did not run.
20. kernels     one JSON line of every kernel with its main-path launches
                (and, for the flash kernels, phase 12's and phase 13's; for
                the histogram, phase 17 (b)'s, null where (b) did not run,
                phase 18's killed runs', (b)'s null where it did not run,
                and phase 19's runs, (b)'s null where it did not run).

Launch counters are set to 0 just before each path (phases 3-4, phase 5,
phase 6, each run of phase 12, each ring call of phase 13, in its rank's
process, each run of phase 14 (b)) and read just after it, so a kernel's
count is its own path's alone: mask_only's is the sweep's. Phase 11's
histogram launches are counted in its workers, each a fresh process (so
from 0), and printed there; phases 17's, 18's and 19's in their
workers, a launch a round a member. The last line is the device JSON.
Without CUDA, or without the package beside this file, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores, same source
# f32 accuracy on the tensor cores: 495 TFLOP/s of TF32 (same source) over
# the three products of the 3xTF32 split
TF32X3_OPS_PER_S = 495e12 / 3
REPLACES = {"histogram": "rabit_tpu/ops/pallas_kernels.py:133",
            "flash_block": "rabit_tpu/ops/pallas_kernels.py:398",
            "flash_block_bwd": "rabit_tpu/ops/pallas_kernels.py:345",
            "mask_only": "tools/histogram_sweep.py:79"}
SOURCES = {"histogram": "rabit_tpu_torch/csrc/histogram.cu",
           "flash_block": "rabit_tpu_torch/csrc/flash_block.cu",
           "flash_block_bwd": "rabit_tpu_torch/csrc/flash_block_bwd.cu",
           "mask_only": "rabit_tpu_torch/csrc/mask_only.cu"}

# (rows, nbins): bench.py's headline, and the HIGGS gpu_hist contribution
# count (131,072 rows x 28 features) over 28 x 256 bins
FULL_WIDTH = [(1 << 21, 1024), (3_670_016, 7168)]
# the JAX tests' widest histogram, one bin tile of 133,120 B of shared memory
WIDE = (100_000, 16_640)
# the sweep's grid (tools/histogram_sweep.py:126-127), and the bin count's
# edge cases: ragged rows (no multiple of 4 or 16384) in an unaligned view,
# with 1000 bins (no multiple of 128) and with 120,000 (three tiles of
# 57,344 bins of shared memory)
SWEEP_GRID = [(n, nb) for n in (1 << 20, 1 << 21) for nb in (256, 1024, 4096)]
MASK_EDGES = [(1_000_003, 1000), (1_000_003, 120_000)]
# mask_only's timing rows: the sweep's headline and its most contended
MASK_TIMING = [(1 << 21, 1024), (1 << 20, 256)]
# boosted_round_worker.py: rows, features, buckets
ROUND_SHAPES = [(131_072, 16, 64), (131_072, 28, 256)]
N_ROUNDS = 3
# kernel vs plain version: f32 sums of the same (bf16-rounded for "fast")
# values in two atomic orders, which change from run to run. The rounding
# error grows like sqrt(rows per bin) ulps of the partial sums: rtol covers
# the large hess sums (~1e3 at 2^21 rows over 1024 bins), atol the grad
# sums near zero.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-3)
TIMING_REPS = 20
# flash block shapes (B*H, T, S, D, causal): the training step's (batch 8
# x 8 heads, seq 512, d_head 32) and the ring chain's block of
# tools/kernel_hw_proof.py:156 (8 heads, 1024, d_head 128)
FLASH_MAIN = (64, 512, 512, 32, True)
FLASH_CHAIN = (8, 1024, 1024, 128, False)
# the forward against its plain version (tests/test_ring_attention.py's
# tolerance); each backward gradient within max|diff| / max|ref| (the
# bound tools/kernel_hw_proof.py:131-135 holds the TPU kernel to)
FLASH_FWD_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_BWD_REL = 1e-3
# the 3xTF32 tile product against f64, max|diff| / max|ref| (the split
# keeps about 2^-22 of each operand; 1xTF32 gives about 3e-4)
MMA_TILE_REL = 1e-5
# one training step through the kernels vs through the plain block update
# (tests/test_transformer.py:69-73)
STEP_TOL = 5e-4
FLAGSHIP_STEPS = 16
# kernels that may not spill registers
NO_SPILL = ("flash_bwd_", "flash_fwd_", "histogram_kernel", "mask_only_kernel")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bench_tol(rows_total: int, nbins: int) -> dict:
    """bench.py's spot-check tolerance against the f64 host histogram."""
    return dict(rtol=1e-3, atol=4e-3 * math.sqrt(rows_total / nbins))


def assert_close(got, want, what: str, rtol: float, atol: float) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(err - rtol * np.abs(want)))
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} values off; worst "
            f"at {np.unravel_index(i, got.shape)}: {got.flat[i]} vs "
            f"{want.flat[i]} (rtol {rtol}, atol {atol})")
    return float(err.max())


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from rabit_tpu_torch.engine import _native_build
    from rabit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    # the native core (one g++) compiles while the kernels' nvccs run
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native_build.build)
        built = _build.build()
        native_s = native.result()
    phase("build", f"{sorted(_build.sources())} ready in "
          f"{time.perf_counter() - t0:.2f} s (per kernel, s: "
          f"{ {k: round(v, 2) for k, v in built.items()} })")
    phase("build", f"native core {_native_build.library_path().name}: "
          f"g++ {native_s:.2f} s (0 = already built), beside the nvccs")
    for name in sorted(_build.sources()):
        summary = ptxas_summary(_build.ptxas_log(name).read_text())
        phase("build", f"ptxas {name}: " + "; ".join(summary))
        spilled = [s for s in summary if s.startswith(NO_SPILL)
                   and not s.endswith(" 0 B spilled")]
        if spilled:
            raise AssertionError(f"kernels spill registers: {spilled}")
    # every instantiation: 4 DP x mask / no mask; the backward has two
    # kernels of each
    for name, prefix, expect in (("flash_block", "flash_fwd_", 8),
                                 ("flash_block_bwd", "flash_bwd_", 16)):
        hmma = {k: n for k, n in sass_counts(
            _build.library_path(name), "HMMA").items()
            if k.startswith(prefix)}
        phase("build", f"HMMA instructions in the SASS of {name}: {hmma}")
        if len(hmma) != expect or min(hmma.values()) == 0:
            raise AssertionError(f"a {prefix}* kernel runs no tensor-core "
                                 f"product (HMMA counts {hmma}; {expect} "
                                 f"kernels expected)")


def sass_counts(library: Path, opcode: str) -> dict:
    """Kernel -> its count of ``opcode`` instructions, from the SASS that
    ``cuobjdump -sass`` (beside nvcc) prints of the library."""
    from rabit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            kernel = demangled(fn.group(1))
            counts[kernel] = 0
        elif kernel and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


def phase_tile(dev) -> None:
    """The backward's score-tile function alone (``csrc/flash_mma.cuh``
    through the library's check entry ``rabit_flash_mma_tile_f32``): a
    [64, d] x [64, d]^T tile of normals against a torch f64 product, at
    d = DP = 16, 32, 64, 128 and at d = 99 (4-byte copies). Beside it,
    what 1xTF32 (each operand rounded to TF32 once) gives on the same
    tile. Then the forward's s is the backward's s: a first-step forward
    (m = NEG_INF, l = o = 0, no mask, scale 1) on the same tiles gives an
    m' equal to the tile's row max, bit for bit."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import flash as F
    p = ctypes.c_void_p
    fn = _build.entry("flash_block_bwd", "rabit_flash_mma_tile_f32",
                      [p, p, ctypes.c_int, p, p])
    gen = torch.Generator(device=dev).manual_seed(30)

    def tf32(x):   # to nearest, ties away, 10 mantissa bits
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    for d in (16, 32, 64, 128, 99):
        a, b = (torch.randn((64, d), generator=gen, device=dev)
                for _ in range(2))
        got = torch.empty((64, 64), device=dev)
        err = fn(a.data_ptr(), b.data_ptr(), d, got.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "flash_block_bwd")
        torch.cuda.synchronize()
        ref = a.double() @ b.double().T
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        one = tf32(a).double() @ tf32(b).double().T
        rel1 = float((one - ref).abs().max() / ref.abs().max())
        mo, _, _ = F.flash_block(
            a[None], b[None], torch.randn((1, 64, d), generator=gen,
                                          device=dev),
            torch.full((1, 64), F.NEG_INF, device=dev),
            torch.zeros((1, 64), device=dev),
            torch.zeros((1, 64, d), device=dev), None, 1.0)
        torch.cuda.synchronize()
        same = torch.equal(mo[0], got.amax(dim=1))
        phase("tile", f"3xTF32 score tile [64, {d}] x [64, {d}]^T: "
              f"max|diff|/max|ref| {rel:.3g} against f64 (limit "
              f"{MMA_TILE_REL}; 1xTF32 on the same tile {rel1:.3g}); the "
              f"forward's m' equals its row max bit for bit: {same}")
        if not rel <= MMA_TILE_REL:
            raise AssertionError(f"score tile d={d}: {rel:.3g} > "
                                 f"{MMA_TILE_REL}")
        if not same:
            raise AssertionError(
                f"d={d}: the forward's m' differs from the tile function's "
                f"row max in {int((mo[0] != got.amax(dim=1)).sum())} of 64 "
                f"rows")


def demangled(symbol: str) -> str:
    """'name<args>' of a kernel template's mangled symbol (integer and
    bool arguments): the identifier whose length prefix ends where its
    template arguments begin; 'name' of a plain function in a namespace
    (the last of its length-prefixed names)."""
    args = re.search(r"I((?:L[a-z]\d+E)+)E", symbol)
    if not args:
        names, i = [], 3
        while symbol.startswith("_ZN") and i < len(symbol) \
                and symbol[i].isdigit():
            digits = re.match(r"\d+", symbol[i:]).group()
            i += len(digits)
            names.append(symbol[i:i + int(digits)])
            i += int(digits)
        return names[-1] if names else symbol
    values = ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1)))
    end = args.start()
    for start in range(end - 1, 0, -1):
        if symbol[:start].endswith(str(end - start)):
            return f"{symbol[start:end]}<{values}>"
    return symbol


def ptxas_summary(log: str) -> list:
    """'kernel<D>: N registers, B B spilled' for each kernel in ptxas's
    -v output."""
    out, kernel = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = demangled(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and kernel:
            spilled = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            out.append(f"{kernel} {regs.group(1)} registers, "
                       f"{spilled} B spilled")
            kernel = None
    return out


def _hist_case(n: int, nbins: int, seed: int, dev, edge: bool = False):
    from rabit_tpu_torch import convert
    from rabit_tpu_torch.models.histogram import make_inputs
    g, h, b = make_inputs(n + 1 if edge else n, nbins, p=1, seed=seed)
    if edge:
        b = b.copy()
        b[0, ::7] = nbins                        # the padding id
        b[0, 3::11] = -1
        b[0, 5::13] = np.iinfo(np.int32).min
    g, h, b = convert.inputs_from_numpy(g, h, b, rank=0, device=dev)
    if edge:  # one element in: pointers off 16-byte alignment
        g, h, b = g[1:], h[1:], b[1:]
    return b, g, h


def phase_kernel(dev) -> float:
    """Kernel vs plain version; returns the largest absolute difference."""
    from rabit_tpu_torch.ops import histogram as K
    cases = [(n, nb, False) for n, nb in FULL_WIDTH + [WIDE]]
    cases.append((1_000_003, 1024, True))
    worst = 0.0
    for i, (n, nbins, edge) in enumerate(cases):
        bins, grad, hess = _hist_case(n, nbins, 10 + i, dev, edge)
        for precision in ("high", "fast"):
            got = K.histogram(bins, grad, hess, nbins, precision)
            want = K.histogram_reference(bins, grad, hess, nbins, precision)
            torch.cuda.synchronize()
            err = assert_close(got.cpu(), want.cpu(),
                               f"histogram {n}x{nbins} {precision}",
                               **KERNEL_TOL)
            worst = max(worst, err)
            phase("kernel", f"histogram rows={n} nbins={nbins} "
                  f"{'edge ' if edge else ''}{precision}: max |diff| "
                  f"{err:.3g} (rtol {KERNEL_TOL['rtol']}, atol "
                  f"{KERNEL_TOL['atol']})")
    return worst


def _ids_case(n: int, nbins: int, seed: int, dev, edge: bool = False):
    """Bin ids on the card from a seed: all in [0, nbins), or for an edge
    case from -3 to nbins + 40 with -1, nbins, nbins + 40, 2^30 and the
    int32 minimum among them, in a view one element in (off 16-byte
    alignment)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (-3, nbins + 41) if edge else (0, nbins)
    b = torch.randint(lo, hi, (n + int(edge),), generator=gen,
                      dtype=torch.int32, device=dev)
    if edge:
        b[1:6] = torch.tensor([-1, nbins, nbins + 40, 1 << 30,
                               np.iinfo(np.int32).min], dtype=torch.int32)
        b = b[1:]
    return b


def phase_mask_kernel(dev) -> float:
    """The bin count against its plain version, bit for bit: both count
    exactly (integers below 2^24 in f32). Returns the largest difference,
    0."""
    from rabit_tpu_torch.ops import histogram as K
    cases = [(n, nb, False) for n, nb in SWEEP_GRID]
    cases += [(n, nb, True) for n, nb in MASK_EDGES]
    for i, (n, nbins, edge) in enumerate(cases):
        bins = _ids_case(n, nbins, 40 + i, dev, edge)
        got = K.mask_only(bins, nbins)
        want = K.mask_only_reference(bins, nbins)
        torch.cuda.synchronize()
        valid = int(((bins >= 0) & (bins < nbins)).sum())
        if got.shape != want.shape or not torch.equal(got, want):
            off = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"mask_only {n}x{nbins}: {off} of {nbins} "
                                 f"counts differ from the plain version")
        if int(want.sum()) != valid:
            raise AssertionError(f"mask_only {n}x{nbins}: counted "
                                 f"{int(want.sum())} of {valid} valid ids")
        phase("kernel", f"mask_only rows={n} nbins={nbins} "
              f"{'edge (unaligned, out-of-range ids) ' if edge else ''}"
              f"exactly equal to the plain version ({valid} ids counted)")
    return 0.0


def phase_device_ops(dev) -> None:
    """One device operation a call: ``torch.profiler`` over one window of
    a few calls of ``histogram`` (both precisions, the main path's two
    shapes) and of ``mask_only`` (its two timing shapes) sees one kind of
    kernel, one a call, and nothing else (no memset, no fill, no second
    pass). Each call of a window has inputs of its own, and two witnesses
    stand beside the profiler: the wrapper's launch count over the window
    must equal the calls, and each call's output must agree with the
    plain version on its own inputs (a call whose kernel did not run
    leaves whatever its buffer held: every output of this phase is
    poisoned with NaN before it is freed, so no buffer holds an earlier
    call's result). A window in which the profiler recorded fewer kernels
    than that, all of the one kind, passes on those witnesses and says so
    (see PERF.md §7); more operations than calls, or a second kind,
    fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rabit_tpu_torch.ops import histogram as K
    calls = 5
    runs = []
    for n, nbins in FULL_WIDTH:
        cases = [_hist_case(n, nbins, 2 + i, dev) for i in range(calls)]
        for precision in ("high", "fast"):
            runs.append((f"histogram {n}x{nbins} {precision}", K.histogram,
                         [c + (nbins, precision) for c in cases],
                         lambda b, g, h, nb, p: K.histogram_reference(
                             b, g, h, nb, p).cpu(), KERNEL_TOL))
    for n, nbins in MASK_TIMING:
        runs.append((f"mask_only {n}x{nbins}", K.mask_only,
                     [(_ids_case(n, nbins, 2 + i, dev), nbins)
                      for i in range(calls)],
                     lambda b, nb: K.mask_only_reference(b, nb).cpu(),
                     dict(rtol=0.0, atol=0.0)))
    for label, wrapper, arg_sets, plain, tol in runs:
        # the first call of a shape asks the library once
        warm = wrapper(*arg_sets[0])
        torch.cuda.synchronize()
        launched = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs = [wrapper(*args) for args in arg_sets]
            torch.cuda.synchronize()
        launched = wrapper.launches - launched
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        seen = sum(ops.values())
        if seen == 0:
            raise AssertionError(f"{label}: torch.profiler saw no device "
                                 f"operation")
        if len(ops) != 1 or seen > calls:
            raise AssertionError(f"{label}: {calls} calls made the device "
                                 f"operations {ops}, not one kernel a call")
        if launched != calls:
            raise AssertionError(f"{label}: the wrapper counted {launched} "
                                 f"launches for {calls} calls")
        for i, (out, args) in enumerate(zip(outs, arg_sets)):
            assert_close(out.cpu(), plain(*args), f"{label} call {i}", **tol)
        for out in outs + [warm]:
            out.fill_(float("nan"))
        witness = (f"the wrapper counted {launched} launches and each "
                   f"call's output agreed with the plain version")
        if seen < calls:
            witness = (f"torch.profiler recorded {seen} of the {calls} "
                       f"kernels; {witness}")
        phase("ops", f"{label}: {calls} calls, device operations {ops}; "
              f"{witness}")


def flash_case(bh: int, t: int, s: int, d: int, mask_kind, seed: int, dev,
               first_step: bool = False, spread: float = 1.0):
    """Inputs (q, k, v, m, l, o, mask) and cotangents (cm, cl, co) of one
    block step, from a seed; q and k are normals times ``spread``.
    ``first_step``: the ring's first step (m = NEG_INF, l = o = 0);
    otherwise a running state. ``mask_kind`` is None,
    "causal", "causal, row 0 masked" (the kernels skip the tiles above the
    diagonal, but not for the first row block, whose row 0 keeps m =
    NEG_INF) or "tie": a random mask whose row 0 is fully masked with m =
    NEG_INF (both max ops tie exactly there), and an exact tie across two
    unmasked lanes of row 1."""
    from rabit_tpu_torch.ops.flash import NEG_INF
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = normal(bh, t, d), normal(bh, s, d), normal(bh, s, d)
    q, k = q * spread, k * spread
    if first_step:
        m = torch.full((bh, t), NEG_INF, device=dev)
        l, o = torch.zeros(bh, t, device=dev), torch.zeros(bh, t, d,
                                                           device=dev)
    else:
        m, o = normal(bh, t), normal(bh, t, d)
        l = torch.rand((bh, t), generator=gen, device=dev) + 0.5
    mask = None
    if mask_kind == "causal":
        mask = torch.ones(t, s, dtype=torch.bool, device=dev).triu(1)
    elif mask_kind == "causal, row 0 masked":
        mask = torch.ones(t, s, dtype=torch.bool, device=dev).triu(1)
        mask[0] = True
    elif mask_kind == "tie":
        mask = torch.rand((t, s), generator=gen, device=dev) < 0.3
        mask[0] = True
        m[:, 0] = NEG_INF
        k[:, 5] = k[:, 3]
        mask[1, 3] = mask[1, 5] = False
    return (q, k, v, m, l, o, mask), (normal(bh, t), normal(bh, t),
                                      normal(bh, t, d))


# (label, (B*H, T, S, D), mask, first step, spread of q and k)
FLASH_CASES = [
    ("training shape", FLASH_MAIN[:4], "causal", True, 1.0),
    ("chain block", FLASH_CHAIN[:4], None, False, 1.0),
    ("fully masked first row", (4, 192, 192, 32), "causal, row 0 masked",
     True, 1.0),
    ("tie row", (2, 64, 64, 32), "tie", False, 1.0),
    ("ragged", (3, 100, 72, 16), "tie", False, 1.0),
    ("D 64", (4, 256, 320, 64), "causal", True, 1.0),
    # s = q.k / sqrt(D) with a spread of about 16 (|s| up to about 100),
    # where a split's error grows with |s|
    ("wide range", (2, 256, 256, 128), None, False, 4.0),
]


def phase_flash_kernel(dev) -> dict:
    """Both flash kernels against their plain versions; returns the
    largest absolute difference of each."""
    from rabit_tpu_torch.ops import flash as F
    worst = {"flash_block": 0.0, "flash_block_bwd": 0.0}
    for i, (label, (bh, t, s, d), mask_kind, first, spread) in \
            enumerate(FLASH_CASES):
        ins, cts = flash_case(bh, t, s, d, mask_kind, 20 + i, dev, first,
                              spread)
        sm = d ** -0.5
        got = F.flash_block(*ins, sm)
        want = F.block_update_reference(*ins, sm)
        torch.cuda.synchronize()
        for name, g, w in zip(("m'", "l'", "o'"), got, want):
            err = assert_close(g.cpu(), w.cpu(), f"flash_block {label} {name}",
                               **FLASH_FWD_TOL)
            worst["flash_block"] = max(worst["flash_block"], err)
        got = F.flash_block_bwd(*ins, sm, *cts)
        want = F.block_update_bwd_reference(*ins, sm, *cts)
        torch.cuda.synchronize()
        rels = {}
        for name, g, w in zip(("dq", "dk", "dv", "dm", "dl", "do"), got,
                              want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"flash_block_bwd {label} {name}: "
                                     f"non-finite values")
            diff = float((g - w).abs().max())
            rels[name] = diff / max(float(w.abs().max()), 1e-30)
            worst["flash_block_bwd"] = max(worst["flash_block_bwd"], diff)
            if rels[name] > FLASH_BWD_REL:
                raise AssertionError(
                    f"flash_block_bwd {label} {name}: max|diff|/max|ref| "
                    f"{rels[name]:.3g} > {FLASH_BWD_REL}")
        phase("kernel", f"flash {label} (B*H {bh}, T {t}, S {s}, D {d}, "
              f"mask {mask_kind}, q k x {spread}): forward within rtol/atol "
              f"{FLASH_FWD_TOL['rtol']}; backward max|diff|/max|ref| "
              + ", ".join(f"{n} {r:.2g}" for n, r in rels.items()))
    return worst


def reset_launches() -> None:
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.ops import histogram as K
    K.histogram.launches = 0
    K.mask_only.launches = 0
    F.flash_block.launches = 0
    F.flash_block_bwd.launches = 0


def read_launches() -> dict:
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.ops import histogram as K
    return {"histogram": K.histogram.launches,
            "mask_only": K.mask_only.launches,
            "flash_block": F.flash_block.launches,
            "flash_block_bwd": F.flash_block_bwd.launches}


def phase_sweep(dev) -> dict:
    """The histogram measurement path: the sweep at its full grid, no
    artifact. Returns its rows and the launches of the run."""
    from rabit_tpu_torch.tools import histogram_sweep
    reset_launches()
    t0 = time.perf_counter()
    out = histogram_sweep.sweep(dev, emit=lambda line: phase("sweep", line))
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["mask_only"] < 1:
        raise AssertionError("kernel mask_only was not launched on the "
                             "sweep path")
    phase("sweep", f"{len(out['table'])} rows in {wall:.1f} s wall, slopes "
          f"K={out['k'][0]}->{out['k'][1]} on {out['clock']}, pools "
          f"{out['pool_datasets']} (rows -> datasets); launches {launches}")
    return {"table": out["table"], "launches": launches}


def phase_bench(dev) -> dict:
    """The bench twin at full size, no artifact: its JSON line, which must
    say correct."""
    from rabit_tpu_torch import bench
    out = bench.bench(dev)
    line, doc = out["line"], out["artifact"]
    phase("bench", json.dumps(line))
    phase("bench", f"headline {doc['headline']}; host-paced "
          f"{doc['host_paced']['value']:.3f} GB/s (vs_baseline "
          f"{doc['host_paced']['vs_baseline']:.3f}); ms a call "
          f"{doc['t_ms']}; GB/s by rows {doc['bandwidth_vs_rows']} "
          f"(host-paced {doc['bandwidth_vs_rows_host_paced']}); numpy "
          f"host {doc['t_host_ms']:.2f} ms")
    if line["correct"] is not True:
        raise AssertionError(f"bench: the histogram allreduce is not "
                             f"correct: {line}")
    return doc


def phase_proof(dev) -> dict:
    """``kernel_hw_proof`` at full size, no artifact, with the flash
    kernels' launches on its chains (the chain block's launch counts)."""
    from rabit_tpu_torch.tools import kernel_hw_proof
    reset_launches()
    t0 = time.perf_counter()
    evidence = kernel_hw_proof.prove(dev)
    if not evidence["complete"]:
        raise AssertionError("kernel_hw_proof did not complete")
    launches = read_launches()
    phase("proof", f"every stage passed in {time.perf_counter() - t0:.1f} "
          f"s; launches {launches}")
    evidence["launches"] = launches
    return evidence


def phase_transformer(dev) -> dict:
    """The flagship training run (the main path), then the checks and the
    profile. Returns the launches of the run and the step times."""
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.parallel.mesh import make_mesh
    import torch.distributed as dist
    reset_launches()
    t0 = time.perf_counter()
    out = E.train_flagship(FLAGSHIP_STEPS, dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_layers = E.FLAGSHIP_SIZES["n_layers"]
    for name in ("flash_block", "flash_block_bwd"):
        if launches[name] != FLAGSHIP_STEPS * n_layers:
            raise AssertionError(
                f"{name} launched {launches[name]} times in "
                f"{FLAGSHIP_STEPS} steps of {n_layers} layers")
    losses = out["losses"]
    step_ms = float(np.median(out["step_ms"][1:]))
    phase("transformer", f"train_flagship {FLAGSHIP_STEPS} steps on "
          f"{out['device']}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (tail "
          f"mean {np.mean(losses[-4:]):.4f}, must be < {losses[0] - 0.8:.4f})"
          f"; step {step_ms:.3f} ms median on CUDA events (first "
          f"{out['step_ms'][0]:.1f} ms, build included); {wall:.1f} s wall; "
          f"launches {launches}")

    # one step through the kernels against the same step through the
    # plain block update, on the card
    params = tf.init_params(1, **E.FLAGSHIP_SIZES)
    x, y = (torch.from_numpy(a).to(dev) for a in E.flagship_data(1))
    mesh = make_mesh((1, 1, 1), dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"expected an NCCL group, got "
                                 f"{dist.get_backend()}")
        models, step_losses = [], []
        for plain in (False, True):
            model = tf.model_on(params, dev)
            step = tf.make_train_step(mesh, lr=E.FLAGSHIP_LR)
            with F.plain_block_step() if plain else contextlib.nullcontext():
                step_losses.append(float(step(model, x, y)))
            models.append(model.params())
        dloss = abs(step_losses[0] - step_losses[1])
        if dloss >= STEP_TOL:
            raise AssertionError(f"step loss kernel {step_losses[0]} vs "
                                 f"plain {step_losses[1]}")
        worst = 0.0
        for name, w in models[1].items():
            worst = max(worst, assert_close(
                models[0][name].detach().cpu(), w.detach().cpu(),
                f"step parameter {name}", STEP_TOL, STEP_TOL))
        phase("transformer", f"one step, kernels vs plain block update: "
              f"|d loss| {dloss:.3g}, parameters max |diff| {worst:.3g} "
              f"(within {STEP_TOL})")
        model = tf.model_on(params, dev)
        step = tf.make_train_step(mesh, lr=E.FLAGSHIP_LR)
        profile = phase_profile(lambda: step(model, x, y))
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "step_ms": step_ms,
            "first_step_ms": out["step_ms"][0], "losses": losses,
            "profile": profile}


def phase_profile(run_step, steps: int = 3) -> dict:
    """``torch.profiler`` over a few training steps: device time by kernel
    and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device's own events (kernels, copies), not the host ops that
    # launched them
    rows = sorted(((float(evt.self_device_time_total), evt.key,
                    int(evt.count)) for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        phase("profile", "torch.profiler saw no device time: not measured")
        return {"device_us_per_step": None}
    flash = sum(r[0] for r in rows if "flash_" in r[1])
    phase("profile", f"{steps} steps: device busy {total / steps:.1f} us a "
          f"step of {wall_us / steps:.1f} us host wall under the profiler "
          f"({total / wall_us:.1%}); flash kernels {flash / steps:.1f} us "
          f"({flash / total:.1%} of the device time)")
    for dev_us, key, count in rows[:12]:
        phase("profile", f"  {dev_us / steps:9.1f} us/step "
              f"{dev_us / total:6.1%}  x{count // steps:<4d} {key[:90]}")
    return {"device_us_per_step": total / steps,
            "flash_us_per_step": flash / steps,
            "wall_us_per_step": wall_us / steps,
            "top": [{"us_per_step": d / steps, "kernel": k[:120],
                     "calls_per_step": c // steps} for d, k, c in rows[:12]]}


def phase_main_path(dev) -> None:
    import torch.distributed as dist
    from rabit_tpu_torch import convert
    from rabit_tpu_torch.models.histogram import (
        distributed_histogram, host_histogram, make_inputs)
    from rabit_tpu_torch.parallel.mesh import make_group
    group, dev = make_group(dev)
    try:
        if dist.get_backend(group) != "nccl":
            raise AssertionError(f"expected an NCCL group, got "
                                 f"{dist.get_backend(group)}")
        for n, nbins in FULL_WIDTH:
            g, h, b = make_inputs(n, nbins, p=1, seed=1)
            tg, th, tb = convert.inputs_from_numpy(g, h, b, rank=0,
                                                   device=dev)
            t0 = time.perf_counter()
            got = distributed_histogram(tg, th, tb, nbins, group)
            got = got.cpu().numpy()
            wall = time.perf_counter() - t0
            want = host_histogram(g[0], h[0], b[0], nbins).astype(np.float64)
            err = assert_close(got, want, f"distributed_histogram {n}x{nbins}",
                               **bench_tol(n, nbins))
            phase("main path", f"distributed_histogram rows={n} "
                  f"nbins={nbins} world={dist.get_world_size(group)} "
                  f"nccl: max |err| vs f64 host {err:.3g}, {wall * 1e3:.1f} "
                  f"ms host wall incl. copy back")
    finally:
        dist.destroy_process_group()


def phase_rounds(dev) -> None:
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.models.histogram import local_histogram
    for rows, n_feat, n_buckets in ROUND_SHAPES:
        nbins = n_feat * n_buckets
        rabit.init([], engine="torch")   # the card by default
        try:
            gen = torch.Generator(device=dev).manual_seed(100 + nbins)
            x = torch.rand((rows, n_feat), generator=gen, device=dev)
            y = (torch.rand(rows, generator=gen, device=dev) < 0.5).float()
            buckets = (x * n_buckets).long().clamp_(max=n_buckets - 1)
            flat = (buckets + torch.arange(n_feat, device=dev) * n_buckets
                    ).reshape(-1).to(torch.int32)
            flat_np = flat.cpu().numpy()
            margin = torch.zeros(rows, device=dev)
            for rnd in range(N_ROUNDS):
                p = torch.sigmoid(margin)
                g, h = p - y, p * (1.0 - p)
                gw = g.repeat_interleave(n_feat)
                hw = h.repeat_interleave(n_feat)
                t0 = time.perf_counter()
                hist = local_histogram(gw, hw, flat, nbins)
                hist = rabit.allreduce(hist.cpu().numpy(), rabit.SUM)
                wall = time.perf_counter() - t0
                want = np.stack([
                    np.bincount(flat_np, weights=gw.double().cpu().numpy(),
                                minlength=nbins),
                    np.bincount(flat_np, weights=hw.double().cpu().numpy(),
                                minlength=nbins)], axis=1)
                err = assert_close(hist, want,
                                   f"round {rnd} {rows}x{n_feat}x{n_buckets}",
                                   **bench_tol(rows * n_feat, nbins))
                hd = torch.from_numpy(hist).to(dev)
                best = int(torch.argmax(hd[:, 0] ** 2 / (hd[:, 1] + 1.0)))
                f, bk = divmod(best, n_buckets)
                margin += 0.3 * torch.where(buckets[:, f] <= bk, -0.1, 0.1)
                rabit.checkpoint({"round": rnd, "split": (f, bk)})
                phase("rounds", f"{rows}x{n_feat}x{n_buckets} round {rnd}: "
                      f"split ({f}, {bk}), max |err| vs bincount f64 "
                      f"{err:.3g}, histogram+allreduce {wall * 1e3:.2f} ms "
                      f"host wall")
            version, model = rabit.load_checkpoint()
            if version != N_ROUNDS or model["round"] != N_ROUNDS - 1:
                raise AssertionError(f"checkpoint at version {version}, "
                                     f"model {model}")
            if not torch.isfinite(margin).all():
                raise AssertionError("margin went non-finite")
            phase("rounds", f"{rows}x{n_feat}x{n_buckets}: load_checkpoint "
                  f"-> version {version}")
        finally:
            rabit.finalize()


def time_ms(fn, args_sets) -> float:
    """Median device ms of ``fn(*args)`` over TIMING_REPS runs, cycling
    through copies of the inputs (together larger than the 50 MB L2, so
    each run reads from device memory). A sleep kernel ahead of each start
    event keeps the host's launch work off the measured interval."""
    for a in args_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for i in range(TIMING_REPS):
        a = args_sets[i % len(args_sets)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(dev, power: str):
    from rabit_tpu_torch.ops import histogram as K
    rows = []
    for n, nbins in FULL_WIDTH:
        bins, grad, hess = _hist_case(n, nbins, 3, dev)
        copies = max(4, math.ceil(150e6 / (12 * n)))
        sets = [(bins.clone(), grad.clone(), hess.clone())
                for _ in range(copies)]
        kernel = time_ms(lambda b, g, h: K.histogram(b, g, h, nbins), sets)
        plain = time_ms(
            lambda b, g, h: K.histogram_reference(b, g, h, nbins), sets)
        lib_sets = [(b, torch.stack([g, h], dim=1)) for b, g, h in sets]
        library = time_ms(
            lambda b, gh: torch.zeros((nbins, 2), device=dev).index_add_(
                0, b.long(), gh), lib_sets)
        nbytes = 12 * n + 8 * nbins   # each input read once, output once
        ops = 2 * n                   # one f32 add per value
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / F32_OPS_PER_S else "operations")
        rows.append(dict(rows=n, nbins=nbins, ms=kernel, plain_ms=plain,
                         library_ms=library, bound_ms=bound,
                         bound_by=bound_by, bytes=nbytes))
        phase("timing", f"histogram rows={n} nbins={nbins}: kernel "
              f"{kernel:.4f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{nbytes} B; {bound / kernel:.1%} of it), plain "
              f"{plain:.4f} ms, library index_add_ {library:.4f} ms "
              f"[{power}]")
    return rows


def phase_mask_timing(dev, power: str, sweep_rows) -> list:
    """The bin count, its plain version and ``torch.bincount`` (the
    yardstick; the port never calls it), per launch, beside the bound and
    the sweep's slope at the same shape (the bound lies below one launch's
    latency)."""
    from rabit_tpu_torch.ops import histogram as K
    rows = []
    for n, nbins in MASK_TIMING:
        bins = _ids_case(n, nbins, 5, dev)
        sets = [(bins.clone(),) for _ in range(math.ceil(150e6 / (4 * n)))]
        kernel = time_ms(lambda b: K.mask_only(b, nbins), sets)
        plain = time_ms(lambda b: K.mask_only_reference(b, nbins), sets)
        library = time_ms(lambda b: torch.bincount(b, minlength=nbins), sets)
        nbytes = 4 * n + 4 * nbins    # each id read once, each count written
        # one integer add a row, at the f32 rate outside the tensor cores
        # (the data sheet gives no int32 rate); the bytes bound it ~40x over
        ops = n
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / F32_OPS_PER_S else "operations")
        slope = next(r["mask_only_ms"] for r in sweep_rows
                     if (r["rows"], r["nbins"]) == (n, nbins))
        rows.append(dict(rows=n, nbins=nbins, ms=kernel, slope_ms=slope,
                         plain_ms=plain, library_ms=library, bound_ms=bound,
                         bound_by=bound_by, bytes=nbytes))
        phase("timing", f"mask_only rows={n} nbins={nbins}: kernel "
              f"{kernel:.4f} ms a launch, {slope:.4f} ms a call by the "
              f"sweep's slope, bound {bound:.4f} ms ({bound_by}, {nbytes} B;"
              f" {bound / kernel:.1%} of the launch, {bound / slope:.1%} of "
              f"the slope), plain {plain:.4f} ms, library bincount "
              f"{library:.4f} ms [{power}]")
    return rows


def flash_bound(bh: int, t: int, s: int, d: int, mask, backward: bool):
    """(bound ms, what bounds it, flops, bytes) of one call: 4 D flops
    forward and 10 D backward (two and five products) for each (query,
    key) pair that the mask leaves (about half of T S under a causal mask:
    a masked pair adds exactly 0 once its row's max is finite), against
    each input read once and each output written once at the memory rate.
    The flops are reckoned at the 3xTF32 tensor-core rate, not at the f32
    rate of the CUDA cores: the card can do this work at f32 accuracy on
    its tensor cores (each product as three TF32 products of split
    operands), so that is the least time it could take."""
    pairs = bh * (t * s if mask is None else int((~mask).sum()))
    rows, keys = bh * t * (2 + d), bh * s * 2 * d   # m, l, o; k, v
    nbytes = 4 * (bh * t * d + keys + rows) + (0 if mask is None else t * s)
    if backward:
        nbytes += 4 * (bh * t * (2 + d)        # cm, cl, co
                       + bh * t * d + keys + rows)  # dq; dk, dv; dm, dl, do
        flops = 10 * pairs * d
    else:
        nbytes += 4 * rows                     # m', l', o'
        flops = 4 * pairs * d
    by_ops, by_bytes = flops / TF32X3_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", flops, nbytes)


def phase_flash_timing(dev, power: str) -> dict:
    """Each flash kernel, its plain version and a PyTorch yardstick the
    port never calls (``scaled_dot_product_attention`` forward, forward +
    backward, and the backward alone from saved forward outputs, on the
    same q/k/v and mask in f32) at the training shape and the chain
    block."""
    import torch.nn.functional as TF
    from rabit_tpu_torch.ops import flash as F
    out = {"flash_block": [], "flash_block_bwd": []}
    for bh, t, s, d, causal in (FLASH_MAIN, FLASH_CHAIN):
        ins, cts = flash_case(bh, t, s, d, "causal" if causal else None, 3,
                              dev, first_step=True)
        per_set = sum(x.numel() * 4 for x in (*ins[:6], *cts))
        copies = max(2, math.ceil(150e6 / per_set))
        sets = [tuple(None if x is None else x.clone()
                      for x in (*ins, *cts)) for _ in range(copies)]
        sm = d ** -0.5
        fwd = time_ms(lambda *a: F.flash_block(*a[:7], sm), sets)
        fwd_plain = time_ms(lambda *a: F.block_update_reference(*a[:7], sm),
                            sets)
        bwd = time_ms(lambda *a: F.flash_block_bwd(*a[:7], sm, *a[7:]),
                      sets)
        bwd_plain = time_ms(
            lambda *a: F.block_update_bwd_reference(*a[:7], sm, *a[7:]),
            sets)
        lib_sets = [(q.clone().requires_grad_(), k.clone().requires_grad_(),
                     v.clone().requires_grad_(),
                     None if mask is None else ~mask, co)
                    for q, k, v, m, l, o, mask, cm, cl, co in sets]

        def sdpa(q, k, v, keep, co):
            return TF.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                   scale=sm)

        def sdpa_fwd_bwd(q, k, v, keep, co):
            sdpa(q, k, v, keep, co).backward(co)

        with torch.no_grad():
            lib_fwd = time_ms(sdpa, lib_sets)
        lib_bwd = time_ms(sdpa_fwd_bwd, lib_sets)
        # SDPA's backward alone, on its own: the forward runs once a set,
        # untimed, and each timed call is one autograd.grad over its
        # retained graph
        bwd_sets = [(sdpa(q, k, v, keep, co), (q, k, v), co)
                    for q, k, v, keep, co in lib_sets]

        def sdpa_bwd(out, inputs, co):
            torch.autograd.grad(out, inputs, co, retain_graph=True)

        lib_bwd_alone = time_ms(sdpa_bwd, bwd_sets)
        del bwd_sets
        for name, ms, plain, lib, backward in (
                ("flash_block", fwd, fwd_plain, lib_fwd, False),
                ("flash_block_bwd", bwd, bwd_plain, lib_bwd, True)):
            bound, bound_by, flops, nbytes = flash_bound(bh, t, s, d, ins[6],
                                                         backward)
            row = dict(shape=[bh, t, s, d], causal=causal, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by=bound_by, flops=flops, bytes=nbytes)
            lib_note = f"sdpa {'fwd+bwd' if backward else 'fwd'} {lib:.4f} ms"
            if backward:
                row["library_bwd_ms"] = lib_bwd_alone
                lib_note += (f", sdpa bwd alone {lib_bwd_alone:.4f} ms "
                             f"(fwd+bwd - fwd {lib - lib_fwd:.4f} ms)")
            out[name].append(row)
            phase("timing", f"{name} B*H {bh} T {t} S {s} D {d} "
                  f"{'causal' if causal else 'no mask'}: kernel {ms:.4f} ms,"
                  f" bound {bound:.4f} ms ({bound_by}; {bound / ms:.1%} of "
                  f"it), plain {plain:.4f} ms, {lib_note} [{power}]")
    return out


CODEC_CASES = [("bf16", 1024), ("bf16", 512), ("int8", 1024), ("int8", 512)]
CODEC_SIZES = (2048, 14336, 1 << 21)   # the headline payloads, 8 MB


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits on the CPU, as integers (so -0.0 differs from 0.0)."""
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def phase_collectives(dev) -> None:
    """The collective layer on the card (see the module's phase 10)."""
    import os
    import tempfile
    import torch.distributed as dist
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel import dispatch, wire
    from rabit_tpu_torch.parallel.mesh import make_group
    gen = torch.Generator().manual_seed(8)
    for n in CODEC_SIZES:
        # blocks of every magnitude from 2^-30 to 2^29, a zero block, and
        # quotients that fall on .5 (round half to even)
        x = torch.randn(n, generator=gen)
        x = x * torch.exp2(torch.arange(n) // 512 % 60 - 30.0)
        x[:512] = 0.0
        x[512:1024] = torch.arange(512) * 0.5
        for codec, block in CODEC_CASES:
            plain = wire.encode(x, codec, block)
            card = wire.encode(x.to(dev), codec, block)
            for a, b in zip(plain, card):
                if not torch.equal(_bits(a), _bits(b)):
                    raise AssertionError(f"wire {codec}@{block} n={n}: the "
                                         f"card's encoding differs")
            got = wire.decode(card, codec, x.shape)
            if not torch.equal(_bits(wire.decode(plain, codec, x.shape)),
                               _bits(got)):
                raise AssertionError(f"wire {codec}@{block} n={n}: the "
                                     f"card's decoding differs")
        phase("collectives", f"wire codec n={n}: {CODEC_CASES} on the card "
              f"equal to the CPU bit for bit")
    group, dev = make_group(dev)
    try:
        x = torch.randn(40_000, generator=gen).to(dev)
        for method in dispatch.EXPLICIT_METHODS:
            for w in (None, "int8:bf16@512"):
                out = C.allreduce(x, group, SUM, method=method, wire=w)
                if not torch.equal(out, x):
                    raise AssertionError(f"allreduce {method} wire={w} at "
                                         f"world 1 changed x")
        phase("collectives", f"allreduce at world 1 over "
              f"{dist.get_backend(group)}: {dispatch.EXPLICIT_METHODS} "
              f"return x")
    finally:
        dist.destroy_process_group()
    table = {"float_sum": [
        {"max_n": 10_000, "method": "tree", "wire": None},
        {"max_n": 1_000_000, "method": "swing", "wire": "int8"},
        {"max_n": None, "method": "hier", "wire": None, "flat": "bidir"}],
        "other": [{"max_n": None, "method": "ring", "wire": None}]}
    hier = ((0, 1), (2, 3))
    cases = [((2048, torch.float32, 4, None), ("tree", None)),
             ((500_000, torch.float32, 4, None), ("swing", "int8")),
             ((500_000, torch.float32, 3, None), ("ring", "int8")),
             ((4_000_000, torch.float32, 4, hier), ("hier", None)),
             ((4_000_000, torch.float32, 4, None), ("bidir", None)),
             ((100, torch.int32, 4, None), ("ring", None))]
    env = {"RABIT_DISPATCH_TABLE": None, "RABIT_DATAPLANE_WIRE": "int8"}
    saved = {k: os.environ.get(k) for k in env}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "COLLECTIVE_SWEEP_table.json")
        with open(path, "w") as f:
            json.dump({"schema": dispatch.SCHEMA, "table": table}, f)
        env["RABIT_DISPATCH_TABLE"] = path
        os.environ.update(env)
        try:
            for (n, dtype, p, groups), want in cases:
                got = dispatch.resolve(n, dtype, SUM, p, groups=groups)
                if got != want:
                    raise AssertionError(f"resolve({n}, {dtype}, p={p}, "
                                         f"{groups}) = {got}, want {want}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            dispatch.clear_cache()
    phase("collectives", f"dispatch.resolve over a table file: {len(cases)} "
          f"cases as expected")
    count = torch.cuda.device_count()
    if count < 2:
        phase("collectives", "one card: the NCCL sweep needs two or more")
        return
    world = min(4, count)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tools.collective_sweep",
         "--smoke", "--world", str(world)], capture_output=True, text=True,
        timeout=600, cwd=Path(__file__).resolve().parent)
    for line in res.stdout.splitlines():
        phase("collectives", line)
    if res.returncode != 0 or "smoke ok" not in res.stdout:
        raise AssertionError(f"collective_sweep --smoke --world {world} "
                             f"failed (rc {res.returncode}):\n"
                             f"{res.stderr[-4000:]}")
    phase("collectives", f"collective_sweep --smoke --world {world} over "
          f"NCCL in {time.perf_counter() - t0:.1f} s")


# the robust phase: tools/boosted_trees.py at the headline shape (64
# features x 16 buckets x 32,768 rows a rank: 2^21 entries into 1024 bins),
# six rounds, a kill at round 3
BOOST_SHAPE = ("--features", "64", "--rows", "32768", "--bins", "16")
BOOST_ROUNDS = 6
BOOST_KILL = 3
BOOST_TIMEOUT_S = 300


def _launch_boost(n: int, args, env: dict) -> tuple:
    """``tools.boosted_trees`` as ``n`` workers under the port's launcher:
    each rank's result document (a respawned rank's last), read from the
    file the worker writes into ``RABIT_RESULT_DIR`` (the ranks share the
    launcher's stdout, where one process's output can break into another's
    line), and the wall clock of every worker death the launcher saw."""
    import os
    import signal
    import tempfile
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tracker.launch", "-n",
           str(n), "--timeout", str(BOOST_TIMEOUT_S - 30), sys.executable,
           "-m", "rabit_tpu_torch.tools.boosted_trees", *BOOST_SHAPE, *args]
    with tempfile.TemporaryDirectory() as out_dir:
        full_env = dict(os.environ, N_ROUNDS=str(BOOST_ROUNDS),
                        RABIT_RESULT_DIR=out_dir, **env)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=full_env,
                                cwd=Path(__file__).resolve().parent,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=BOOST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)  # the launcher and workers
            proc.communicate()
            raise AssertionError(f"boosted_trees {args} at world {n} "
                                 f"outlasted {BOOST_TIMEOUT_S} s")
        if proc.returncode != 0:
            raise AssertionError(f"boosted_trees {args} at world {n} failed "
                                 f"(rc {proc.returncode}):\n{err[-4000:]}")
        docs = {}
        for path in Path(out_dir).glob("rank*.json"):
            doc = json.loads(path.read_text())
            docs[doc["rank"]] = doc
    if sorted(docs) != list(range(n)):
        raise AssertionError(f"boosted_trees {args}: documents of ranks "
                             f"{sorted(docs)} of {n}")
    deaths = [float(t) for t in re.findall(r"died rc=\S+ at ([0-9.]+)",
                                           err)]
    return docs, deaths


def _same_model(docs: dict, want: dict, what: str) -> None:
    for r, d in docs.items():
        if d["trees"] != want["trees"] or d["digest"] != want["digest"]:
            raise AssertionError(f"{what}: rank {r}'s trees differ from the "
                                 f"run without a kill:\n{d['trees']}\n"
                                 f"{want['trees']}")


def phase_robust(dev, power: str) -> None:
    """The robust engine under the port (see the module's phase 11)."""
    import tempfile
    import torch.distributed as dist
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.engine import _native_build
    t0 = time.perf_counter()
    built = _native_build.build()
    phase("robust", f"native core {_native_build.library_path().name} "
          f"ready in {time.perf_counter() - t0:.2f} s (g++ {built:.2f} s "
          f"in this phase; 0 = built in phase 1)")
    with tempfile.TemporaryDirectory() as tmp:
        clean, _ = _launch_boost(1, ["rabit_engine=mock",
                                     f"rabit_ckpt_dir={tmp}/clean"], {})
        kill, deaths = _launch_boost(
            1, ["rabit_engine=mock", f"rabit_ckpt_dir={tmp}/kill",
                f"mock=0,{BOOST_KILL},0,0"], {})
    c, k = clean[0], kill[0]
    if c["device"] != "cuda:0" or k["device"] != "cuda:0":
        raise AssertionError(f"histograms built on {c['device']}, "
                             f"{k['device']}, not the card")
    if len(deaths) != 1 or k["version"] != BOOST_KILL:
        raise AssertionError(f"the kill: {len(deaths)} deaths, respawn "
                             f"resumed at version {k['version']}, want 1 "
                             f"and {BOOST_KILL}")
    if c["launches"] < BOOST_ROUNDS or \
            k["launches"] < BOOST_ROUNDS - BOOST_KILL:
        raise AssertionError(f"histogram launches {c['launches']} and "
                             f"{k['launches']} for {BOOST_ROUNDS} and "
                             f"{BOOST_ROUNDS - BOOST_KILL} rounds")
    _same_model(kill, c, "world 1, cold restart")
    phase("robust", f"world 1 (mock engine, rabit_ckpt_dir): killed at "
          f"round {BOOST_KILL}, respawned, cold-restarted from the durable "
          f"store at version {k['version']}, {BOOST_ROUNDS} trees equal to "
          f"the run without a kill bit for bit (digest {c['digest']}); "
          f"histogram kernel launches {c['launches']} (clean) and "
          f"{k['launches']} (after the respawn); death to the respawned "
          f"worker's first round {k['first_round_at'] - deaths[0]:.2f} s; "
          f"robust allreduce of the {2048 * 4} B histogram at world 1 "
          f"{float(np.median(c['allreduce_ms'])):.4f} ms a round "
          f"host-paced (local: no peer) [{power}]")
    # the histogram payload through TorchEngine at world 1, and the
    # formation of an NCCL world of 1
    t0 = time.perf_counter()
    rabit.init([], engine="torch")
    form_s = time.perf_counter() - t0
    try:
        hist = np.zeros(2048, np.float32)
        rabit.allreduce(hist, rabit.SUM)
        t0 = time.perf_counter()
        for _ in range(20):
            rabit.allreduce(hist, rabit.SUM)
        te_ms = (time.perf_counter() - t0) * 1e3 / 20
        backend = dist.get_backend()
    finally:
        rabit.finalize()
    phase("robust", f"TorchEngine at world 1 ({backend}): the histogram "
          f"payload {te_ms:.4f} ms a call host-paced (returns at world 1); "
          f"init with its NCCL world of 1 {form_s:.3f} s [{power}]")

    count = torch.cuda.device_count()
    if count < 2:
        phase("robust", "one card: the torch data plane's NCCL world "
              "(rabit_dataplane=torch) needs two or more")
        return
    phase_robust_world(min(4, count), power)


def phase_robust_world(p: int, power: str) -> None:
    """The torch data plane over NCCL at world ``p``, one rank a card."""
    args = ["rabit_engine=robust_torch", "rabit_dataplane_minbytes=0"]
    clean, _ = _launch_boost(p, args, {})
    kill, deaths = _launch_boost(p, args + [f"mock=1,{BOOST_KILL},0,0"], {})
    fail, _ = _launch_boost(p, args, {"RABIT_DATAPLANE_FAIL_AT": "5"})
    ref = clean[0]
    for what, docs in (("clean", clean), ("kill", kill), ("fail", fail)):
        _same_model(docs, ref, f"world {p}, {what}")
        backends = {d["dataplane"]["backend"] for d in docs.values()}
        if backends != {"nccl"}:
            raise AssertionError(f"world {p} {what}: backends {backends}")
    for what, docs in (("kill", kill), ("fail", fail)):
        epochs = {d["epoch"] for d in docs.values()}
        if min(epochs) < 2 or len(epochs) != 1:
            raise AssertionError(f"world {p} {what}: epochs {epochs} "
                                 f"(want one, advanced past 1)")
    if len(deaths) != 1 or min(d["launches"] for d in clean.values()) \
            < BOOST_ROUNDS:
        raise AssertionError(f"world {p}: {len(deaths)} deaths, launches "
                             f"{[d['launches'] for d in clean.values()]}")
    robust_ms = float(np.median([np.median(d["allreduce_ms"])
                                 for d in clean.values()]))
    direct = [d["timing"] for d in clean.values()]
    recover_s = max(d["dataplane"]["first_collective_at"]
                    for d in kill.values()) - deaths[0]
    form_s = max(d["dataplane"]["form_seconds"] for d in clean.values())
    phase("robust", f"world {p} (robust_torch, rabit_dataplane_minbytes=0, "
          f"NCCL, one rank a card): the run without a kill, a kill of rank "
          f"1 at round {BOOST_KILL} and RABIT_DATAPLANE_FAIL_AT=5 end with "
          f"the same trees bit for bit on every rank (digest "
          f"{ref['digest']}); epochs {kill[0]['epoch']} and "
          f"{fail[0]['epoch']}")
    phase("robust", f"world {p}: histogram allreduce ({2048 * 4} B) "
          f"{robust_ms:.4f} ms a round host-paced through the robust "
          f"engine (median of ranks' medians over {BOOST_ROUNDS} rounds); "
          f"20 calls each: robust "
          f"{max(t['robust_ms'] for t in direct):.4f} ms, TorchEngine on "
          f"the same world {max(t['torch_engine_ms'] for t in direct):.4f} "
          f"ms, the same on a group without blocking waits "
          f"{max(t['no_blocking_wait_ms'] for t in direct):.4f} ms a call "
          f"(slowest rank); kill to the first collective of the "
          f"re-formed world {recover_s:.2f} s; NCCL world formed in "
          f"{form_s:.3f} s (slowest rank) [{power}]")


# phase 12: the bucketed and overlapped train steps. The flagship at full
# width (tools/flagship_hw_proof.py:37-47), each grad sync from the same
# weights and data for BUCKET_STEPS steps; the MLP at the JAX package's
# full width (rabit_tpu/models/mlp.py:33-34, make_sharded_inputs' batch)
BUCKET_STEPS = 4
FLAGSHIP_PARAMS = (1_836_288, 20)        # f32 elements, leaves
MLP_SIZES = dict(in_dim=256, hidden=512, out_dim=128)
MLP_BATCH, MLP_LR = 64, 0.1
# the MLP's sharded step against the single-device step
# (tests/test_models.py:96-100)
MLP_LOSS_TOL = dict(rtol=2e-2, atol=1e-3)
MLP_PARAM_TOL = dict(rtol=5e-2, atol=5e-3)
# the collectives at world > 1: the histogram's and the 8 MB payloads of
# the collective sweep (tools/collective_sweep.py:72)
BUCKET_COLL_SIZES = (4096, 2_097_152)
BUCKET_WORLD_TIMEOUT_S = 600


@contextlib.contextmanager
def _async_collectives(on: bool):
    import os
    saved = os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
    if on:
        os.environ["RABIT_ASYNC_COLLECTIVES"] = "1"
    try:
        yield
    finally:
        os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
        if saved is not None:
            os.environ["RABIT_ASYNC_COLLECTIVES"] = saved


def _make_step(module, mesh, lr: float, sync: str):
    """``module.make_train_step`` for a grad sync, ``"async"`` being the
    bucket sync with ``RABIT_ASYNC_COLLECTIVES=1``."""
    with _async_collectives(sync == "async"):
        return module.make_train_step(mesh, lr, "bucket" if sync == "async"
                                      else sync)


def _timed_steps(step, model, x, y, steps: int) -> tuple:
    """(losses, ms a step on CUDA events) of ``steps`` steps."""
    losses, ms = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(model, x, y)
        end.record()
        losses.append(float(loss))
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return losses, ms


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _equal_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_bucket(dev, power: str) -> dict:
    """The bucketed and overlapped train steps (see the module's phase
    12). Returns the flagship runs' medians and launches."""
    import torch.distributed as dist
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((1, 1, 1), dev)
    try:
        params = tf.init_params(0, **E.FLAGSHIP_SIZES)
        n = sum(a.size for a in params.values())
        if (n, len(params)) != FLAGSHIP_PARAMS:
            raise AssertionError(f"flagship parameters {n} in {len(params)} "
                                 f"leaves, want {FLAGSHIP_PARAMS}")
        x, y = (torch.from_numpy(a).to(dev) for a in E.flagship_data(
            0, E.FLAGSHIP_BATCH, E.FLAGSHIP_SEQ, E.FLAGSHIP_SIZES["vocab"]))
        runs = {}
        for sync in ("psum", "bucket", "async"):
            model = tf.model_on(params, dev)
            step = _make_step(tf, mesh, E.FLAGSHIP_LR, sync)
            reset_launches()
            losses, ms = _timed_steps(step, model, x, y, BUCKET_STEPS)
            launches = read_launches()
            want = 2 * BUCKET_STEPS
            if (launches["flash_block"], launches["flash_block_bwd"]) != \
                    (want, want):
                raise AssertionError(f"flagship {sync}: flash launches "
                                     f"{launches}, want {want} each")
            runs[sync] = {"losses": losses, "ms": ms,
                          "median_ms": float(np.median(ms[1:])),
                          "launches": launches, "state": _state(model)}
        for sync in ("bucket", "async"):
            if not _equal_bits(runs[sync]["state"], runs["psum"]["state"]) \
                    or runs[sync]["losses"] != runs["psum"]["losses"]:
                raise AssertionError(f"flagship {sync} differs from psum at "
                                     f"world 1, where every sum is the "
                                     f"identity")
        phase("bucket", f"flagship at world 1 ({n} f32 parameters in "
              f"{len(params)} leaves, one {n * 4 / 1e6:.2f} MB bucket): "
              f"psum, bucket and async bucket ({BUCKET_STEPS} steps each "
              f"from the same weights) equal bit for bit, loss "
              f"{runs['psum']['losses'][0]:.4f} -> "
              f"{runs['psum']['losses'][-1]:.4f}; flash_block and "
              f"flash_block_bwd launched {2 * BUCKET_STEPS} times in each "
              f"run")
        each = {s: ", ".join(f"{v:.2f}" for v in r["ms"])
                for s, r in runs.items()}
        phase("bucket", "flagship step ms, median of steps 2-"
              f"{BUCKET_STEPS} on CUDA events: " + ", ".join(
                  f"{s} {r['median_ms']:.3f} ({each[s]})"
                  for s, r in runs.items()) + f" [{power}]")
        _async_issue_probe(dev)
        phase_bucket_mlp(mesh, dev, power)
    finally:
        dist.destroy_process_group()
    count = torch.cuda.device_count()
    if count < 2:
        phase("bucket", "(c) did not run: one card; the NCCL world of the "
              "device entry points and the steps needs two or more")
    else:
        phase_bucket_world(min(4, count), power)
    return {s: {k: r[k] for k in ("median_ms", "ms", "launches", "losses")}
            for s, r in runs.items()}


def _async_issue_probe(dev) -> None:
    """Rule (b) of the async layer: issuing waits for no device work. The
    caller's stream is held busy, so the collective cannot have run when
    the issue returns."""
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    probe = torch.ones(1 << 20, device=dev)
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    h = C.device_allreduce_async(probe, None, SUM, method="ring")
    issue_ms = (time.perf_counter() - t0) * 1e3
    early = h.ready()
    out = h.wait()
    if early or not h.ready() or not torch.equal(out, probe):
        raise AssertionError(f"async allreduce behind a busy stream: ready "
                             f"at issue {early}")
    phase("bucket", f"device_allreduce_async behind a sleeping stream: "
          f"issued in {issue_ms:.3f} ms, not ready until the stream ran "
          f"(rule (b)); its value the sync result")


def phase_bucket_mlp(mesh, dev, power: str) -> None:
    """The MLP at full width on the world-1 mesh: each grad sync against
    the port's single-device ``reference_train_step``."""
    from rabit_tpu_torch.models import mlp
    params = mlp.init_params(0, **MLP_SIZES)
    _, x, y = mlp.make_sharded_inputs(mesh, MLP_BATCH, seed=0, **MLP_SIZES)
    ref = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    ref_losses = []
    for _ in range(BUCKET_STEPS):
        ref, loss = mlp.reference_train_step(ref, x, y, MLP_LR)
        ref_losses.append(float(loss))
    runs, worst = {}, {}
    for sync in ("psum", "ring", "bucket", "async"):
        model = mlp.model_on(params, dev)
        losses, ms = _timed_steps(_make_step(mlp, mesh, MLP_LR, sync), model,
                                  x, y, BUCKET_STEPS)
        np.testing.assert_allclose(losses, ref_losses, **MLP_LOSS_TOL)
        state = _state(model)
        worst[sync] = 0.0
        for k, v in state.items():
            np.testing.assert_allclose(v.cpu().numpy(), ref[k].cpu().numpy(),
                                       **MLP_PARAM_TOL, err_msg=f"{sync} {k}")
            worst[sync] = max(worst[sync],
                              float((v - ref[k]).abs().max()))
        runs[sync] = (state, float(np.median(ms[1:])))
    for a, b in (("bucket", "ring"), ("async", "bucket")):
        if not _equal_bits(runs[a][0], runs[b][0]):
            raise AssertionError(f"MLP {a} differs from {b}")
    phase("bucket", f"MLP {MLP_SIZES['in_dim']} -> {MLP_SIZES['hidden']} -> "
          f"{MLP_SIZES['out_dim']}, batch {MLP_BATCH}, {BUCKET_STEPS} steps "
          f"at world 1: psum, ring, bucket, async within the single-device "
          f"step's bounds (max |diff| " + ", ".join(
              f"{s} {w:.2e}" for s, w in worst.items()) + "); bucket = ring "
          "and async = bucket bit for bit; ms a step " + ", ".join(
              f"{s} {r[1]:.3f}" for s, r in runs.items()) + f" [{power}]")


def _bucket_payloads(rank: int, p: int, n: int) -> dict:
    rng = np.random.default_rng([rank, n])
    return {"f32": rng.standard_normal(n).astype(np.float32),
            "i32": rng.integers(-1 << 20, 1 << 20, n).astype(np.int32),
            "w": rng.standard_normal((33, 5)).astype(np.float32),
            "steps": rng.integers(0, 1000, 9).astype(np.int32)}


def _bucket_cases_rank(rank: int, p: int, device) -> dict:
    """Every device entry point and async entry point at world ``p`` on
    this rank's payloads (on ``device``): f32 by the hand-scheduled ring
    (local torch arithmetic, so NCCL's world must equal gloo's bit for
    bit), i32 exactly."""
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    groups = ((0, 1), (2, 3)) if p == 4 else ((0, 1),)
    got = {}
    for n in BUCKET_COLL_SIZES:
        pay = {k: torch.from_numpy(v).to(device)
               for k, v in _bucket_payloads(rank, p, n).items()}
        for dt in ("f32", "i32"):
            x = pay[dt]
            tree = {"a": x, "w": pay["w"], "steps": pay["steps"]}
            out = {
                "rs": C.device_reduce_scatter(x, None, SUM),
                "ag": C.device_allgather(x[:n // p], None),
                "hier": C.device_hier_allreduce(x, None, SUM, groups=groups),
                "bcast": C.device_broadcast(x, None, root=p - 1),
                "async": C.device_allreduce_async(
                    x, None, SUM, method="ring").wait(),
                "grad_bucket": C.grad_bucket_allreduce_async(x, None,
                                                             SUM).wait(),
                "hier_async": C.device_hier_allreduce_async(
                    x, None, SUM, groups=groups).wait()}
            for name, fn in (
                    ("tree", lambda: C.device_allreduce_tree(
                        tree, None, SUM, method="ring")),
                    ("bucket", lambda: C.bucket_allreduce(
                        tree, None, SUM, method="ring")),
                    ("tree_async", lambda: C.bucket_allreduce_async(
                        tree, None, SUM, method="ring").wait())):
                for k, v in fn().items():
                    out[f"{name}.{k}"] = v
            for k, v in out.items():
                got[f"{n}.{dt}.{k}"] = v.cpu().numpy()
    return got


def _bucket_steps_rank(rank: int, p: int, device) -> dict:
    """The flagship's psum, bucket and async bucket steps at (2, 1, 2) (at
    world 2: (2, 1, 1)) and the MLP's four syncs at (2, 2, 1) ((2, 1, 1)),
    BUCKET_STEPS steps each; the flagship's gradient tree through
    ``device_allreduce_tree`` by "auto", "tree" and "ring"."""
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.models import mlp
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel import dispatch
    from rabit_tpu_torch.parallel.mesh import make_mesh
    got = {}
    shape = (2, 1, 2) if p == 4 else (2, 1, 1)
    mesh = make_mesh(shape, device)
    params = tf.init_params(0, **E.FLAGSHIP_SIZES)
    xs, ys = E.flagship_data(0, E.FLAGSHIP_BATCH, E.FLAGSHIP_SEQ,
                             E.FLAGSHIP_SIZES["vocab"])
    x, y = (tf.shard_tokens(a, mesh, device) for a in (xs, ys))
    for sync in ("psum", "bucket", "async"):
        model = tf.model_on(params, device)
        losses, ms = _timed_steps(_make_step(tf, mesh, E.FLAGSHIP_LR, sync),
                                  model, x, y, BUCKET_STEPS)
        got[f"tf.{sync}.losses"] = np.array(losses)
        got[f"tf.{sync}.ms"] = np.array(ms)
        for k, v in model.state_dict().items():
            got[f"tf.{sync}|{k}"] = v.cpu().numpy()
    # the gradient tree's allreduce: CUDA-event medians of single calls
    grads = {k: torch.randn(a.shape, device=device,
                            generator=torch.Generator(device).manual_seed(
                                rank)) for k, a in params.items()}
    n = sum(a.size for a in params.values())
    got["tree.auto_method"] = np.array(dispatch.resolve(
        n, torch.float32, SUM, p)[0])
    for method in ("auto", "tree", "ring"):
        reps = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            C.device_allreduce_tree(grads, None, SUM, method=method)
            end.record()
            end.synchronize()
            reps.append(start.elapsed_time(end))
        got[f"tree.{method}.ms"] = np.array(reps)
    # the MLP
    mshape = (2, 2, 1) if p == 4 else (2, 1, 1)
    mmesh = make_mesh(mshape, device)
    mparams = mlp.init_params(0, **MLP_SIZES)
    ref = {k: torch.from_numpy(v).to(device) for k, v in mparams.items()}
    npr = np.random.default_rng(0)   # make_sharded_inputs' draws, whole
    full_x = torch.from_numpy(npr.standard_normal(
        (MLP_BATCH, MLP_SIZES["in_dim"])).astype(np.float32)).to(device)
    full_y = torch.from_numpy(npr.integers(
        0, MLP_SIZES["out_dim"], size=(MLP_BATCH,))).to(device)
    _, mx, my = mlp.make_sharded_inputs(mmesh, MLP_BATCH, seed=0,
                                        **MLP_SIZES)
    for _ in range(BUCKET_STEPS):
        ref, _ = mlp.reference_train_step(ref, full_x, full_y, MLP_LR)
    want = _mlp_shard(ref, mmesh)
    for sync in ("psum", "ring", "bucket", "async"):
        model = mlp.model_on(mparams, device, mmesh.index("tp"),
                             mmesh.size("tp"))
        _, ms = _timed_steps(_make_step(mlp, mmesh, MLP_LR, sync), model,
                             mx, my, BUCKET_STEPS)
        got[f"mlp.{sync}.ms"] = np.array(ms)
        for k, v in model.state_dict().items():
            got[f"mlp.{sync}|{k}"] = v.cpu().numpy()
            got[f"mlp.ref|{k}"] = want[k]
    return got


def _mlp_shard(ref: dict, mesh) -> dict:
    """This rank's tp shard of the MLP's full parameters."""
    from rabit_tpu_torch.convert import mlp_params_from_jax
    return {k: v.cpu().numpy() for k, v in mlp_params_from_jax(
        {k: v.cpu().numpy() for k, v in ref.items()}, mesh.index("tp"),
        mesh.size("tp"), "cpu").items()}


def phase_bucket_world(p: int, power: str) -> None:
    """Phase 12 (c): the device and async entry points over NCCL at world
    ``p`` against the same calls on a gloo world, and the bucketed steps
    on the cards."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.tools import run_world
    _build.build(["flash_block", "flash_block_bwd"])  # once, not per rank
    t0 = time.perf_counter()
    nccl = run_world(_bucket_cases_rank, p, "cuda", arrays=True,
                     timeout_s=BUCKET_WORLD_TIMEOUT_S)
    gloo = run_world(_bucket_cases_rank, p, "cpu", arrays=True,
                     timeout_s=BUCKET_WORLD_TIMEOUT_S)
    for r in range(p):
        for k, v in gloo[r].items():
            if nccl[r][k].tobytes() != v.tobytes():
                raise AssertionError(f"world {p}: {k} on rank {r} over NCCL "
                                     f"differs from gloo")
    phase("bucket", f"world {p} over NCCL: device_reduce_scatter, "
          f"device_allgather, device_hier_allreduce (groups "
          f"{'2 x 2' if p == 4 else 'one group'}), device_allreduce_tree "
          f"and bucket_allreduce (mixed f32/i32 tree), device_broadcast "
          f"and the four async entry points on f32 and i32 payloads of "
          f"{' and '.join(map(str, BUCKET_COLL_SIZES))} elements equal to "
          f"a gloo world bit for bit ({len(gloo[0])} results a rank, "
          f"{time.perf_counter() - t0:.1f} s)")
    steps = run_world(_bucket_steps_rank, p, "cuda", arrays=True,
                      timeout_s=BUCKET_WORLD_TIMEOUT_S)
    shape = "(2, 1, 2)" if p == 4 else "(2, 1, 1)"
    names = [k.split("|", 1)[1] for k in steps[0] if k.startswith("tf.psum|")]
    worst = 0.0
    for r, got in enumerate(steps):
        for k in names:
            a, b = got[f"tf.bucket|{k}"], got[f"tf.async|{k}"]
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"world {p}: async {k} differs from "
                                     f"bucket on rank {r}")
            np.testing.assert_allclose(a, got[f"tf.psum|{k}"], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=k)
            worst = max(worst, float(np.abs(a - got[f"tf.psum|{k}"]).max()))
        for sync in ("psum", "ring", "bucket", "async"):
            for k in ("w1", "b1", "w2", "b2"):
                np.testing.assert_allclose(got[f"mlp.{sync}|{k}"],
                                           got[f"mlp.ref|{k}"],
                                           **MLP_PARAM_TOL,
                                           err_msg=f"mlp {sync} {k}")
        for a, b in (("bucket", "ring"), ("async", "bucket")):
            for k in ("w1", "b1", "w2", "b2"):
                if got[f"mlp.{a}|{k}"].tobytes() != \
                        got[f"mlp.{b}|{k}"].tobytes():
                    raise AssertionError(f"MLP {a} {k} differs from {b}")

    def med(key):   # the slowest rank's median of steps 2..
        return max(float(np.median(g[key][1:])) for g in steps)
    phase("bucket", f"world {p}, flagship at (dp, tp, sp) = {shape}: bucket "
          f"within {STEP_TOL} of psum (max |diff| {worst:.2e}), async = "
          f"bucket bit for bit; ms a step (slowest rank's median of steps "
          f"2-{BUCKET_STEPS}, CUDA events): psum {med('tf.psum.ms'):.3f}, "
          f"bucket {med('tf.bucket.ms'):.3f}, async bucket "
          f"{med('tf.async.ms'):.3f} [{power}]")
    mshape = "(2, 2, 1)" if p == 4 else "(2, 1, 1)"
    phase("bucket", f"world {p}, MLP at {mshape}: "
          f"psum, ring, bucket, async within the single-device step's "
          f"bounds; bucket = ring, async = bucket bit for bit; ms a step "
          + ", ".join(f"{s} {med(f'mlp.{s}.ms'):.3f}"
                      for s in ("psum", "ring", "bucket", "async")))
    tree = {m: max(float(np.median(g[f"tree.{m}.ms"][1:])) for g in steps)
            for m in ("auto", "tree", "ring")}
    phase("bucket", f"world {p}: device_allreduce_tree of the flagship's "
          f"gradient tree ({FLAGSHIP_PARAMS[0] * 4 / 1e6:.2f} MB f32, "
          f"{FLAGSHIP_PARAMS[1]} leaves): auto (resolves to "
          f"{steps[0]['tree.auto_method']}) {tree['auto']:.3f} ms, tree "
          f"{tree['tree']:.3f} ms, ring {tree['ring']:.3f} ms a call (slowest "
          f"rank's median of 5 CUDA-event calls) [{power}]")


# phase 13: the parallelism families. Sequence-parallel attention at the
# flash chain's width (tools/kernel_hw_proof.py:156: T 8192, H 8, D 128)
# and at tools/long_context.py's (T 512 a rank, H 8, D 32), causal; the MoE
# and the pipeline at the dryrun's shapes against their oracles, and one
# timed step each at the flagship's widths (MoE: d_model 256, d_ff 1024,
# batch 8 x seq 512 tokens a rank) and at d 1024 (the pipeline)
SP_SHAPES = [(8192, 8, 128), ("512p", 8, 32)]
SP_FWD_TOL = dict(rtol=1e-4, atol=1e-4)
SP_REPS = 5
MOE_TOL = dict(rtol=2e-5, atol=2e-5)        # tests/test_pipeline_moe.py:126
PIPE_FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_pipeline_moe.py:54
PIPE_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pipeline_moe.py:84
MOE_STEP = dict(d_model=256, d_ff=1024, tokens=8 * 512, cf=2.0)
PIPE_STEP = dict(d=1024, n_micro=8, rows=512)
PARALLEL_STEPS = 5
PARALLEL_TIMEOUT_S = 900


def _events_ms(fn, reps: int) -> list:
    """CUDA-event ms of each of ``reps`` calls of ``fn`` (after one
    warm-up call)."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _sp_case(rank: int, p: int, device, shape) -> dict:
    """Both impls of ``sequence_parallel_attention`` at one global shape,
    causal: forward and the gradients of sum(out * ct) against the dense
    oracle and against each other; the ring's flash launches of one call;
    CUDA-event ms of forward and of forward + backward."""
    from rabit_tpu_torch.parallel.mesh import make_mesh
    from rabit_tpu_torch.parallel import ring_attention as R
    t, h, d = shape
    t = 512 * p if t == "512p" else t
    mesh = make_mesh((p,), device, axes=("sp",))
    gen = torch.Generator(device).manual_seed(13)
    q, k, v, ct = (torch.randn((t, h, d), generator=gen, device=device)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = R.reference_attention(*leaves, causal=True)
    want_g = torch.autograd.grad((want * ct).sum(), leaves)
    want = want.detach()
    got, ms = {}, {}
    for impl in R.IMPLS:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        reset_launches()
        out = R.sequence_parallel_attention(*leaves, mesh, True, impl=impl)
        grads = torch.autograd.grad((out * ct).sum(), leaves)
        launches = read_launches()
        torch.testing.assert_close(out, want, **SP_FWD_TOL,
                                   msg=lambda m: f"{impl} {shape}: {m}")
        rel = [_rel_err(g, w) for g, w in zip(grads, want_g)]
        if max(rel) > FLASH_BWD_REL:
            raise AssertionError(f"{impl} {shape}: gradients {rel} of the "
                                 f"largest from the dense oracle")
        got[impl] = (out.detach(), grads, rel, launches)

        def fwd():
            with torch.no_grad():
                R.sequence_parallel_attention(q, k, v, mesh, True, impl=impl)

        def fwd_bwd():
            xs = [x.requires_grad_() for x in (q.detach(), k.detach(),
                                              v.detach())]
            o = R.sequence_parallel_attention(*xs, mesh, True, impl=impl)
            torch.autograd.grad((o * ct).sum(), xs)

        ms[impl] = {"fwd": _events_ms(fwd, SP_REPS),
                    "fwd_bwd": _events_ms(fwd_bwd, SP_REPS)}
    torch.testing.assert_close(got["ring"][0], got["ulysses"][0],
                               **SP_FWD_TOL)
    ring_vs = max(_rel_err(a, b) for a, b in zip(got["ring"][1],
                                                 got["ulysses"][1]))
    if ring_vs > FLASH_BWD_REL:
        raise AssertionError(f"{shape}: ring and Ulysses gradients "
                             f"{ring_vs} of the largest apart")
    return {"shape": [t, h, d],
            "fwd_err": {i: float((got[i][0] - want).abs().max())
                        for i in R.IMPLS},
            "grad_rel": {i: got[i][2] for i in R.IMPLS},
            "ring_vs_ulysses_grad_rel": ring_vs,
            "ring_launches": got["ring"][3], "ms": ms}


def _moe_case(rank: int, p: int, device) -> dict:
    """The MoE at the dryrun's shapes (d 16, d_ff 32, 8 tokens a rank,
    capacity factor p: nothing dropped) against the dense oracle on this
    rank's tokens; then PARALLEL_STEPS timed SGD steps at the flagship's
    widths (capacity factor 2.0)."""
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel import moe
    from rabit_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((p,), device, axes=("ep",))
    full = moe.init_moe_params(7, d_model=16, d_ff=32, n_experts=p)
    xs = np.random.default_rng(8).standard_normal((8 * p, 16)).astype(
        np.float32)
    x = torch.from_numpy(xs[rank * 8:(rank + 1) * 8]).to(device)
    with torch.no_grad():
        y, _ = moe.make_moe_fn(mesh, capacity_factor=float(p))(
            moe.place_moe_params(mesh, full), x)
    want = moe.moe_reference({k: torch.from_numpy(v).to(device)
                              for k, v in full.items()}, x)
    torch.testing.assert_close(y, want, **MOE_TOL)
    err = float((y - want).abs().max())
    w = MOE_STEP
    params = moe.place_moe_params(mesh, moe.init_moe_params(
        0, w["d_model"], w["d_ff"], p))
    gen = torch.Generator(device).manual_seed(rank)
    x = torch.randn((w["tokens"], w["d_model"]), generator=gen,
                    device=device)
    fn = moe.make_moe_fn(mesh, capacity_factor=w["cf"])
    group = mesh.group("ep")
    losses = []

    def step():
        y, aux = fn(params, x)
        loss = C.psum_identity_grad((y * y).sum(), group) / (y.numel() * p) \
            + 0.01 * aux
        loss.backward()
        with torch.no_grad():
            for v in params.values():
                v -= 0.1 * v.grad
                v.grad = None
        losses.append(loss.detach())

    ms = _events_ms(step, PARALLEL_STEPS)
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"MoE step losses {losses}")
    return {"oracle_err": err, "step_ms": ms, "losses": losses}


def _pipe_case(rank: int, p: int, device) -> dict:
    """The pipeline at the dryrun's shapes (d 16, 6 microbatches of 4 rows,
    tanh(x w)) against the stages composed on this card, forward and this
    rank's stage gradient; then PARALLEL_STEPS timed SGD steps at d 1024,
    8 microbatches of 512 rows."""
    from rabit_tpu_torch.parallel import pipeline
    from rabit_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((p,), device, axes=("pp",))
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.standard_normal((16, 16)) / 4).astype(np.float32)}
              for _ in range(p)]
    xm = torch.from_numpy(rng.standard_normal((6, 4, 16)).astype(
        np.float32)).to(device)

    def stage_fn(prm, h):
        return torch.tanh(h @ prm["w"])

    placed = pipeline.place_pipeline_params(mesh, stages)
    y = pipeline.make_pipeline_fn(mesh, stage_fn)(placed, xm)
    (y * y).mean().backward()
    ws = [torch.from_numpy(s["w"]).to(device).requires_grad_()
          for s in stages]
    h = xm
    for w in ws:
        h = torch.tanh(h @ w)
    (h * h).mean().backward()
    torch.testing.assert_close(y.detach(), h.detach(), **PIPE_FWD_TOL)
    torch.testing.assert_close(placed["w"].grad[0], ws[rank].grad,
                               **PIPE_GRAD_TOL)
    err = {"fwd": float((y - h).abs().max()),
           "grad": float((placed["w"].grad[0] - ws[rank].grad).abs().max())}
    w = PIPE_STEP
    big = [{"w": (rng.standard_normal((w["d"], w["d"])) / np.sqrt(
        w["d"])).astype(np.float32)} for _ in range(p)]
    placed = pipeline.place_pipeline_params(mesh, big)
    fn = pipeline.make_pipeline_fn(mesh, stage_fn)
    gen = torch.Generator(device).manual_seed(5)
    xb = torch.randn((w["n_micro"], w["rows"], w["d"]), generator=gen,
                     device=device)
    losses = []

    def step():
        y = fn(placed, xb)
        loss = (y * y).mean()
        loss.backward()
        with torch.no_grad():
            for v in placed.values():
                v -= 0.1 * v.grad
                v.grad = None
        losses.append(loss.detach())

    ms = _events_ms(step, PARALLEL_STEPS)
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"pipeline step losses {losses}")
    return {"err": err, "step_ms": ms, "losses": losses}


def _parallel_rank(rank: int, p: int, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"sp": [_sp_case(rank, p, device, s) for s in SP_SHAPES],
            "moe": _moe_case(rank, p, device),
            "pipeline": _pipe_case(rank, p, device)}


def phase_parallel(power: str) -> dict:
    """The parallelism families over min(4, cards) processes, one a card
    over NCCL (see the module's phase 13). Returns the ring's flash
    launches and the measurements."""
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.tools import run_world
    p = min(4, torch.cuda.device_count())
    _build.build(["flash_block", "flash_block_bwd"])  # once, not per rank
    t0 = time.perf_counter()
    ranks = run_world(_parallel_rank, p, "cuda",
                      timeout_s=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = {"flash_block": 0, "flash_block_bwd": 0}
    for r, got in enumerate(ranks):
        for case in got["sp"]:
            seen = case["ring_launches"]
            if (seen["flash_block"], seen["flash_block_bwd"]) != (p, p):
                raise AssertionError(f"rank {r} {case['shape']}: the ring's "
                                     f"flash launches {seen}, want {p} "
                                     f"forward and {p} backward block steps")
            for k in launches:
                launches[k] += seen[k]

    def med(xs):
        return float(np.median(xs))

    for i, shape in enumerate(ranks[0]["sp"]):
        t, h, d = shape["shape"]
        worst = {impl: max(max(g["sp"][i]["grad_rel"][impl]) for g in ranks)
                 for impl in ("ring", "ulysses")}
        ms = {impl: {k: max(med(g["sp"][i]["ms"][impl][k]) for g in ranks)
                     for k in ("fwd", "fwd_bwd")}
              for impl in ("ring", "ulysses")}
        fwd = {k: max(g["sp"][i]["fwd_err"][k] for g in ranks)
               for k in ("ring", "ulysses")}
        apart = max(g["sp"][i]["ring_vs_ulysses_grad_rel"] for g in ranks)
        phase("parallel", f"sequence_parallel_attention T {t} H {h} D {d} "
              f"causal at world {p}: ring and ulysses against the dense "
              f"oracle (forward within {SP_FWD_TOL['atol']}: max |diff| "
              f"ring {fwd['ring']:.2e}, ulysses {fwd['ulysses']:.2e}; "
              f"gradients of the largest: ring {worst['ring']:.2e}, "
              f"ulysses {worst['ulysses']:.2e}), ring vs ulysses gradients "
              f"{apart:.2e}; the ring's flash launches a call {p} + {p} on "
              f"every rank")
        phase("parallel", f"  ms (slowest rank's median of {SP_REPS} CUDA-"
              f"event calls): ring fwd {ms['ring']['fwd']:.3f}, fwd+bwd "
              f"{ms['ring']['fwd_bwd']:.3f}; ulysses fwd "
              f"{ms['ulysses']['fwd']:.3f}, fwd+bwd "
              f"{ms['ulysses']['fwd_bwd']:.3f} [{power}]")
    moe_ms = max(med(g["moe"]["step_ms"]) for g in ranks)
    pipe_ms = max(med(g["pipeline"]["step_ms"]) for g in ranks)
    phase("parallel", f"MoE at world {p}: the dryrun's shapes within "
          f"{MOE_TOL['atol']} of the dense oracle without drops (max |diff| "
          f"{max(g['moe']['oracle_err'] for g in ranks):.2e}); a step at "
          f"d_model {MOE_STEP['d_model']}, d_ff {MOE_STEP['d_ff']}, "
          f"{MOE_STEP['tokens']} tokens a rank, cf {MOE_STEP['cf']}: "
          f"{moe_ms:.3f} ms (slowest rank's median of {PARALLEL_STEPS}), "
          f"loss {ranks[0]['moe']['losses'][0]:.4f} -> "
          f"{ranks[0]['moe']['losses'][-1]:.4f} [{power}]")
    phase("parallel", f"pipeline at world {p}: the dryrun's shapes against "
          f"the stages composed on one card (forward max |diff| "
          f"{max(g['pipeline']['err']['fwd'] for g in ranks):.2e}, stage "
          f"gradients {max(g['pipeline']['err']['grad'] for g in ranks):.2e});"
          f" a step at d {PIPE_STEP['d']}, {PIPE_STEP['n_micro']} "
          f"microbatches of {PIPE_STEP['rows']} rows: {pipe_ms:.3f} ms "
          f"(slowest rank's median of {PARALLEL_STEPS}) [{power}]")
    t1 = time.perf_counter()
    E.dryrun_multichip(p)
    dry = time.perf_counter() - t1
    phase("parallel", f"dryrun_multichip({p}) over NCCL: every family ok in "
          f"{dry:.1f} s wall (the world's spawn included); the phase's "
          f"world {wall:.1f} s")
    if p < 2:
        phase("parallel", "one card: the p = 1 paths only; worlds of 2 and "
              "4 need as many cards")
    return {"world": p, "launches": launches, "dryrun_s": dry,
            "sp": [{k: c[k] for k in ("shape", "ms")} for c in ranks[0]["sp"]],
            "moe_step_ms": moe_ms, "pipeline_step_ms": pipe_ms}


# ---------------------------------------------------------------------------
# Phase 14: the telemetry and profiling plane (rabit_tpu_torch/telemetry/)
# ---------------------------------------------------------------------------

TEL_SPAN_LOOP = 10_000
TEL_STEPS = 8          # timed steps a turn in (b)
TEL_TURNS = (False, True, True, False) * 3   # (b)'s turns: planes on?
TEL_ROUNDS = dict(rows=131_072, features=28, buckets=256, rounds=3)
TEL_TIMEOUT_S = 300
# the entry points of (a) and what JAX's twins record for one call: the
# span's name, whether it carries cost_* attributes, and whether a round
TEL_SPANS = {"allreduce tree": ("allreduce", True, False),
             "allreduce ring": ("allreduce", True, False),
             "device_allreduce_tree": ("allreduce_tree", False, False),
             "device_broadcast": ("broadcast", False, False),
             "bucket_allreduce_async": ("bucket_allreduce", True, True),
             "device_allreduce_async": ("allreduce", True, True)}


def _ops_profile(fn) -> dict:
    """``fn()`` under ``torch.profiler``: the device kernels by name, the
    ``rabit_*`` ranges, the host's kernel launches (runtime and driver API
    events) and the names of the kernels launched by host operations inside
    a ``rabit_*`` range."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    ranges = [e for e in evs if e.device_type == DeviceType.CPU
              and e.name.startswith("rabit_")]
    inside = set()

    def walk(e):
        inside.update(k.name for k in e.kernels)
        for c in e.cpu_children:
            walk(c)
    for r in ranges:
        walk(r)
    return {"kernels": Counter(e.name for e in evs
                               if e.device_type == DeviceType.CUDA),
            "ranges": len(ranges), "inside": sorted(inside),
            "launches": sum(1 for e in evs if e.device_type == DeviceType.CPU
                            and "Launch" in e.name)}


def _same_launches(on: dict, off: dict, what: str) -> None:
    """No kernel inside a ``rabit_*`` range that the run with the planes off
    lacks, and the host's launch count unchanged."""
    extra = [k for k in on["inside"] if k not in off["kernels"]]
    if extra or on["launches"] != off["launches"]:
        raise AssertionError(f"{what}: with telemetry on, kernels {extra} "
                             f"inside rabit_* ranges that the run without "
                             f"lacks, launches {on['launches']} against "
                             f"{off['launches']}")


def _tree_bits(out) -> list:
    leaves = [out[k] for k in sorted(out)] if isinstance(out, dict) else [out]
    return [_bits(t) for t in leaves]


def _telemetry_entry_rank(rank: int, p: int, device) -> dict:
    """Phase 14 (a), in a fresh process of an NCCL world of 1: the kernel
    libraries' compile probes, then the entry points with the planes off
    and on."""
    from rabit_tpu_torch import telemetry as T
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.ops import histogram as K
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.telemetry import profile as P
    dev = device
    T.reset(capacity=4096, enabled=True)
    P.reset(enabled=True)
    # each library loaded twice through its wrapper: the first load is this
    # process's dlopen (the build is phase 1's), a compile sample and a miss
    bins, g, h = _hist_case(1 << 16, 1024, 5, dev)
    ins, cts = flash_case(8, 128, 128, 32, "causal", 5, dev)
    for _ in range(2):
        K.histogram(bins, g, h, 1024)
        K.mask_only(bins, 1024)
        F.flash_block(*ins, 32 ** -0.5)
        F.flash_block_bwd(*ins, 32 ** -0.5, *cts)
    torch.cuda.synchronize()
    prof = P.snapshot()
    build = {r["fn"]: r for r in prof["jit_cache"]
             if r["fn"].startswith("build:")}
    want = {f"build:{n}" for n in _build.sources()}
    compiles = {r["fn"]: r["count"] for r in prof["compile"]}
    if set(build) != want or any(
            r["misses"] != 1 or r["hits"] < 1 or compiles.get(f) != 1
            for f, r in build.items()):
        raise AssertionError(f"build probes {build}, compiles {compiles}: "
                             f"want one miss and one compile a library of "
                             f"{sorted(want)}, hits after")
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(1 << 20, generator=gen, device=dev)
    tree = {"w": torch.randn(256, 256, generator=gen, device=dev),
            "b": torch.randn(256, generator=gen, device=dev),
            "i": torch.arange(4096, device=dev, dtype=torch.int32)}
    calls = {"allreduce tree": lambda: C.allreduce(x, None, SUM,
                                                   method="tree"),
             "allreduce ring": lambda: C.allreduce(x, None, SUM,
                                                   method="ring"),
             "device_allreduce_tree": lambda: C.device_allreduce_tree(
                 tree, None, SUM),
             "device_broadcast": lambda: C.device_broadcast(x, None, 0),
             "bucket_allreduce_async": lambda: C.bucket_allreduce_async(
                 tree, None, SUM).wait(),
             "device_allreduce_async": lambda: C.device_allreduce_async(
                 x, None, SUM).wait()}
    out = {}
    for on in (False, True):
        T.reset(capacity=4096, enabled=on)
        P.reset(enabled=on)
        bits, spans = {}, {}
        for name, fn in calls.items():
            before = len(T.snapshot()["spans"])
            bits[name] = _tree_bits(fn())
            torch.cuda.synchronize()
            spans[name] = T.snapshot()["spans"][before:]
        out[on] = {"bits": bits, "spans": spans,
                   "profile": _ops_profile(lambda: [fn() for fn in
                                                    calls.values()])}
    for name in calls:
        if not all(torch.equal(a, b) for a, b in
                   zip(out[True]["bits"][name], out[False]["bits"][name])):
            raise AssertionError(f"{name}: results differ with telemetry on")
        if out[False]["spans"][name]:
            raise AssertionError(f"{name}: spans with telemetry off")
        span, costed, rounded = TEL_SPANS[name]
        got = [s for s in out[True]["spans"][name]
               if not s["name"].endswith(".issue")]
        attrs = got[0].get("attrs", {}) if len(got) >= 1 else {}
        n_calls = 2 if name == "bucket_allreduce_async" else 1  # 2 dtypes
        if (len(got) != n_calls or {s["name"] for s in got} != {span}
                or costed != ("cost_wire_bytes" in attrs)
                or rounded != ("round" in attrs)):
            raise AssertionError(f"{name}: spans {got}, want {n_calls} "
                                 f"{span!r} (cost {costed}, round "
                                 f"{rounded})")
        for s in got if rounded else []:   # the async handles' spans
            a = s["attrs"]
            split = a["wire_exposed_ms"] + a["wire_overlapped_ms"]
            if abs(split - s["dur"] * 1e3) > 1e-3:
                raise AssertionError(f"{name}: exposed + overlapped "
                                     f"{split} ms against the span's "
                                     f"{s['dur'] * 1e3} ms")
    on, off = out[True]["profile"], out[False]["profile"]
    _same_launches(on, off, "the entry points")
    return {"build": {f: [r["misses"], r["hits"], compiles[f]]
                      for f, r in sorted(build.items())},
            "ranges": on["ranges"], "inside": on["inside"],
            "launches": [on["launches"], off["launches"]],
            "spans": {n: len(out[True]["spans"][n]) for n in calls}}


def _span_host_us(T) -> tuple:
    """Host µs of one ``telemetry.span`` enter/exit, recorder on and off,
    over ``TEL_SPAN_LOOP`` spans each."""
    us = []
    for on in (True, False):
        T.reset(capacity=4096, enabled=on)
        t0 = time.perf_counter()
        for _ in range(TEL_SPAN_LOOP):
            with T.span("allreduce", nbytes=4096, op="sum", method="ring"):
                pass
        us.append((time.perf_counter() - t0) * 1e6 / TEL_SPAN_LOOP)
    return tuple(us)


def _flagship_turns(dev, power: str) -> dict:
    """Phase 14 (b): ``train_flagship`` with the planes off, on, on, off."""
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch import telemetry as T
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.parallel.mesh import make_mesh
    from rabit_tpu_torch.telemetry import profile as P
    runs, mem = [], None
    param_bytes = FLAGSHIP_PARAMS[0] * 4
    for on in (False, True, True, False):
        T.reset(enabled=on)
        P.reset(enabled=on)
        reset_launches()
        got = E.train_flagship(FLAGSHIP_STEPS, dev)
        runs.append({"on": on, "losses": got["losses"],
                     "launches": read_launches()})
        if on:
            sample = P.sample_memory()
            alloc = sum(torch.cuda.memory_allocated(d)
                        for d in range(torch.cuda.device_count()))
            peak = P.snapshot()["device_mem"]["peak_bytes"]
            if sample is None or sample["live_bytes"] != alloc \
                    or peak < param_bytes:
                raise AssertionError(f"device_mem {sample} against "
                                     f"memory_allocated {alloc}, peak "
                                     f"{peak} below the parameters' "
                                     f"{param_bytes} B")
            mem = {"live_bytes": alloc, "peak_bytes": peak}
    for r in runs[1:]:
        if r["losses"] != runs[0]["losses"] or r["launches"] != \
                runs[0]["launches"]:
            raise AssertionError(f"flagship with telemetry {r['on']}: "
                                 f"losses or launches {r['launches']} differ "
                                 f"from {runs[0]['launches']}")
    # train_flagship's step in turns (TEL_TURNS), timed on CUDA events and
    # on the host's clock (each step synchronised); the first turn each way
    # also profiles one step
    mesh = make_mesh((1, 1, 1), dev)
    try:
        prof, timed = {}, []
        x, y = (torch.from_numpy(a).to(dev) for a in E.flagship_data(
            0, E.FLAGSHIP_BATCH, E.FLAGSHIP_SEQ, E.FLAGSHIP_SIZES["vocab"]))
        for on in TEL_TURNS:
            T.reset(enabled=on)
            P.reset(enabled=on)
            model = tf.model_on(tf.init_params(0, **E.FLAGSHIP_SIZES), dev)
            step = tf.make_train_step(mesh, lr=E.FLAGSHIP_LR)
            step(model, x, y)
            torch.cuda.synchronize()
            ms, wall = [], []
            for _ in range(TEL_STEPS):
                t0 = time.perf_counter()
                ms += _timed_steps(step, model, x, y, 1)[1]
                wall.append((time.perf_counter() - t0) * 1e3)
            timed.append({"on": on, "ms": float(np.median(ms)),
                          "wall_ms": float(np.median(wall))})
            if on not in prof:
                prof[on] = _ops_profile(lambda: step(model, x, y))
        _same_launches(prof[True], prof[False], "the flagship's step")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
        T.reset(enabled=False)
        P.reset(enabled=False)
    return {"runs": timed, "mem": mem, "ranges": prof[True]["ranges"],
            "launches_a_run": runs[0]["launches"],
            "launches": prof[True]["launches"],
            "kernels": sum(prof[True]["kernels"].values())}


def _telemetry_rounds(p: int, on: bool, tmp: Path) -> tuple:
    """Phase 14 (c): the histogram rounds under the port's launcher and
    tracker with ``TorchEngine`` over NCCL, the planes on or off."""
    import socket
    from rabit_tpu_torch.tracker.launch import launch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tag = "on" if on else "off"
    res, exp = tmp / f"res_{tag}", tmp / f"exp_{tag}"
    stats = {}
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tools.histogram_rounds",
           "--rows", str(TEL_ROUNDS["rows"]),
           "--features", str(TEL_ROUNDS["features"]),
           "--buckets", str(TEL_ROUNDS["buckets"]),
           "--rounds", str(TEL_ROUNDS["rounds"]), "rabit_engine=torch",
           f"rabit_coordinator=127.0.0.1:{port}",
           f"rabit_num_processes={p}", f"rabit_telemetry={int(on)}",
           f"rabit_profile={int(on)}"]
    import os
    path = os.pathsep.join(filter(None, [str(Path(__file__).resolve().parent),
                                         os.environ.get("PYTHONPATH")]))
    launch(p, cmd, max_attempts=0, timeout=TEL_TIMEOUT_S, quiet=True,
           stats=stats, env={"RABIT_RESULT_DIR": str(res),
                             "RABIT_TELEMETRY_EXPORT": str(exp),
                             "PYTHONPATH": path})
    docs = [json.loads((res / f"rank{r}.json").read_text())
            for r in range(p)]
    return docs, stats, exp


def _rounds_checks(p: int, tmp: Path, power: str) -> None:
    from rabit_tpu_torch.telemetry import matches
    off, _, _ = _telemetry_rounds(p, False, tmp)
    on, stats, exp = _telemetry_rounds(p, True, tmp)
    rounds = TEL_ROUNDS["rounds"]
    for r in range(p):
        if on[r]["hist_sha256"] != off[r]["hist_sha256"]:
            raise AssertionError(f"rank {r}: histograms differ with "
                                 f"telemetry on")
        if on[r]["launches"] < rounds or off[r]["launches"] < rounds:
            raise AssertionError(f"rank {r}: histogram launches "
                                 f"{on[r]['launches']} / "
                                 f"{off[r]['launches']}, want {rounds}")
        for kind in ("summary", "trace"):
            doc = json.loads((exp / f"telemetry_{kind}_rank{r}.json")
                             .read_text())
            if not matches(doc, f"telemetry_{kind}"):
                raise AssertionError(f"rank {r}: {kind} schema "
                                     f"{doc.get('schema')}")
    fleet = stats["fleet"]
    counts = {c["name"]: c["count"] for c in fleet["counters"]}
    tables = [m for m in stats["messages"] if m.startswith("telemetry:")]
    if sorted(fleet["ranks"]) != list(range(p)) or len(tables) != 1 \
            or counts.get("engine.allreduce") != rounds * p:
        raise AssertionError(f"fleet ranks {fleet['ranks']}, tables "
                             f"{len(tables)}, engine.allreduce "
                             f"{counts.get('engine.allreduce')}, want "
                             f"{rounds} x {p}")
    ms = {k: float(np.median([d["allreduce_ms"][1:] for d in docs]))
          for k, docs in (("off", off), ("on", on))}
    phase("telemetry", f"(c) world {p}, {TEL_ROUNDS['rows']} x "
          f"{TEL_ROUNDS['features']} x {TEL_ROUNDS['buckets']}, {rounds} "
          f"rounds through the launcher and tracker (TorchEngine over "
          f"NCCL): histograms equal to the run without telemetry bit for "
          f"bit, the kernel launched {rounds} times on every rank, both "
          f"files a rank ({fleet['num_ranks']} summaries through metrics); "
          f"allreduce host-paced ms (median of rounds 2-{rounds}) off "
          f"{ms['off']:.3f}, on {ms['on']:.3f} [{power}]")
    for line in tables[0].splitlines():
        phase("telemetry", "  " + line)


def phase_telemetry(dev, power: str) -> dict:
    """The telemetry and profiling plane (see the module's phase 14)."""
    import tempfile
    from rabit_tpu_torch import telemetry as T
    from rabit_tpu_torch.tools import run_world
    a = run_world(_telemetry_entry_rank, 1, "cuda",
                  timeout_s=TEL_TIMEOUT_S)[0]
    phase("telemetry", f"(a) world 1 over NCCL, planes off then on: "
          f"{len(TEL_SPANS)} entry points bit for bit, one span a call "
          f"with JAX's name, round and cost_* attributes (spans a call "
          f"{a['spans']}), exposed + overlapped = the span within 1 us; "
          f"build probes [misses, hits, compiles] {a['build']}; "
          f"torch.profiler: {a['ranges']} rabit_* ranges, kernels inside "
          f"{a['inside']} all in the run without, host launches on/off "
          f"{a['launches']}")
    on_us, off_us = _span_host_us(T)
    T.reset(enabled=False)
    phase("telemetry", f"host cost of telemetry.span: {on_us:.3f} us a "
          f"span with the recorder on, {off_us:.3f} us off (loops of "
          f"{TEL_SPAN_LOOP}) [{power}]")
    b = _flagship_turns(dev, power)
    each = "; ".join(
        f"{side} " + ", ".join(f"{r['ms']:.3f} ({r['wall_ms']:.3f})"
                               for r in b["runs"] if r["on"] == on)
        + f": median {np.median([r['ms'] for r in b['runs'] if r['on'] == on]):.3f}"
        for side, on in (("off", False), ("on", True)))
    phase("telemetry", f"(b) train_flagship x {FLAGSHIP_STEPS} steps in "
          f"turns off/on/on/off: losses equal bit for bit, launches "
          f"{b['launches_a_run']} in each; device_mem live "
          f"{b['mem']['live_bytes']} B = torch.cuda.memory_allocated(), "
          f"peak {b['mem']['peak_bytes']} B; one step profiled each way: "
          f"{b['ranges']} rabit_* ranges (world 1: the psum step's sums "
          f"are the identity), {b['launches']} host launches and "
          f"{b['kernels']} kernels, the same off")
    phase("telemetry", f"(b) the flagship's step ms in {len(TEL_TURNS)} "
          f"turns off/on/on/off, each the median of {TEL_STEPS} on CUDA "
          f"events (host wall of the synchronised step): {each} [{power}]")
    count = torch.cuda.device_count()
    if count < 2:
        phase("telemetry", "(c) did not run: one card; the histogram "
              "rounds' world needs two or more")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            _rounds_checks(min(4, count), Path(tmp), power)
    return {"entry": a, "span_host_us": {"on": on_us, "off": off_us},
            "flagship": {"runs": [{k: r[k] for k in ("on", "ms", "wall_ms")}
                                  for r in b["runs"]], "mem": b["mem"]}}


# ---------------------------------------------------------------------------
# Phase 15: the skew plane and the live plane that feeds it
# (rabit_tpu_torch/telemetry/skew.py, live.py; the tracker's poll loop)
# ---------------------------------------------------------------------------

SKEW_SIZES = (4096, 2_097_152)   # tools/collective_sweep.py:72's end sizes
SKEW_LAG_MS = 80                 # benchmarks/skew_round_worker.py's lag
SKEW_TRACKER_ROUNDS = 40
SKEW_TIMEOUT_S = 300
SKEW_BOUNDARY_TURNS = 4          # (b)'s boundary cost: turns a mode
SKEW_BOUNDARY_CALLS = 50         # calls a turn
SKEW_ENV = ("RABIT_SKEW_ADAPT", "RABIT_SKEW_DIGEST", "RABIT_SKEW_PREAGG_MS",
            "RABIT_SKEW_SYNC_ROUNDS", "RABIT_HIER_GROUP")


def _skew_digest(p: int, lag: int, epoch: int = 1) -> str:
    return json.dumps({"epoch": epoch, "laggard": lag, "offsets_ms": {
        str(r): (float(SKEW_LAG_MS) if r == lag else 0.0) for r in range(p)}})


def _skew_set(on: bool, p: int, lag: int, preagg: str = "0",
              sync_rounds: str = "1") -> None:
    import os
    from rabit_tpu_torch.telemetry import skew
    for k in SKEW_ENV:
        os.environ.pop(k, None)
    if on:
        os.environ.update({"RABIT_SKEW_ADAPT": "1",
                           "RABIT_SKEW_PREAGG_MS": preagg,
                           "RABIT_SKEW_SYNC_ROUNDS": sync_rounds,
                           "RABIT_SKEW_DIGEST": _skew_digest(p, lag)})
    skew.reset_monitor()


_SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
          "cudaEventSynchronize", "cudaMemcpy")


def _host_syncs(prof: dict, empty: dict) -> int:
    """The host's waits on the card in a ``_cpu_ops`` profile beyond those
    of an empty window (the profiler's own and the closing one)."""
    return sum(prof["cpu"].get(k, 0) - empty["cpu"].get(k, 0)
               for k in _SYNCS)


def _cpu_ops(fn) -> dict:
    """``fn()`` under ``torch.profiler``, closed by one device
    synchronisation: the host's operations and runtime calls by name, and
    the device kernels by name."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    return {"cpu": Counter(e.name for e in evs
                           if e.device_type == DeviceType.CPU
                           and e.name != "Activity Buffer Request"),
            "kernels": Counter(e.name for e in evs
                               if e.device_type == DeviceType.CUDA)}


def _skew_one_card_rank(rank: int, p: int, device) -> dict:
    """Phase 15 (a), in a fresh process of an NCCL world of 1."""
    import os
    import torch.distributed as dist
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.telemetry import live, skew
    os.environ["RABIT_DISPATCH_TABLE"] = "none"
    x = torch.arange(1 << 20, dtype=torch.float32, device=device)
    handles = []    # the async issue is profiled, its wait() after
    calls = {"allreduce": lambda: C.allreduce(x, None, SUM),
             "device_allreduce_async": lambda: handles.append(
                 C.device_allreduce_async(x, None, SUM))}
    # the plan the JAX package's smoke holds at world 2 (pre-aggregation
    # off): the re-rooted tree
    os.environ["RABIT_SKEW_PREAGG_MS"] = "0"
    plan = skew.adapt_plan("tree", 2, 256, "sum", digest=skew.parse_digest(
        {"epoch": 1, "offsets_ms": {"0": 40.0, "1": 0.0}, "laggard": 0}))
    os.environ.pop("RABIT_SKEW_PREAGG_MS")
    if plan is None or plan["kind"] != "tree_reroot" or plan["root"] != 1:
        raise AssertionError(f"adapt_plan at world 2: {plan}")
    empty = _cpu_ops(lambda: None)
    # the knob off, a digest present: the skew plane is never entered
    _skew_set(False, p, 0)
    os.environ["RABIT_SKEW_DIGEST"] = _skew_digest(1, 0)
    hooks = (C._skew_sync_point, skew.adapt_plan, skew.note_applied)

    def entered(*a, **k):
        raise AssertionError("the skew plane was entered with the knob off")
    off = {}
    try:
        C._skew_sync_point = skew.adapt_plan = skew.note_applied = entered
        for name, fn in calls.items():
            fn()
            off[name] = _cpu_ops(fn)
    finally:
        C._skew_sync_point, skew.adapt_plan, skew.note_applied = hooks
    while handles:
        handles.pop().wait()
    for name, prof in off.items():
        bcast = [k for k in prof["kernels"] if "roadcast" in k]
        if bcast or _host_syncs(prof, empty) or skew._dispatch_round:
            raise AssertionError(f"{name} with the knob off: broadcast "
                                 f"kernels {bcast}, host syncs "
                                 f"{_host_syncs(prof, empty)} "
                                 f"({dict(prof['cpu'])}), dispatch counter "
                                 f"{skew._dispatch_round}")
    # the knob on at world 1: the boundary adopts the local candidate
    _skew_set(True, p, 0)
    os.environ.pop("RABIT_SKEW_DIGEST")
    skew.reset_monitor()
    skew.monitor().observe(json.loads(_skew_digest(1, 0, epoch=3)))
    sent = []
    real = dist.broadcast
    dist.broadcast = lambda *a, **k: sent.append(a) or real(*a, **k)
    try:
        on = {name: _cpu_ops(fn) for name, fn in calls.items()}
    finally:
        dist.broadcast = real
    while handles:
        handles.pop().wait()
    applied = skew.monitor().applied()
    # at world 1 the plane adds no operation: the same host operations and
    # kernels as with the knob off
    if sent or applied is None or applied["epoch"] != 3 \
            or skew.last_applied() is not None \
            or any(on[n]["cpu"] != off[n]["cpu"]
                   or on[n]["kernels"] != off[n]["kernels"] for n in on):
        raise AssertionError(f"world 1, knob on: {len(sent)} broadcasts, "
                             f"applied {applied}, tag {skew.last_applied()}, "
                             f"operations {[dict(on[n]['cpu']) for n in on]} "
                             f"against {[dict(off[n]['cpu']) for n in off]}")
    _skew_set(False, p, 0)
    # the rank's endpoint
    from rabit_tpu_torch import telemetry
    telemetry.reset(capacity=64, enabled=True)
    C.allreduce(x, None, SUM)
    srv = live.start_rank_server(0, 0, 1)
    try:
        import urllib.request
        got = {}
        for path in ("/metrics", "/healthz", "/summary"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=5) as r:
                got[path] = r.read().decode()
    finally:
        srv.stop()
        telemetry.reset(enabled=False)
    if 'rabit_collective_total{rank="0",name="allreduce"' not in \
            got["/metrics"] or json.loads(got["/healthz"])["world"] != 1 \
            or json.loads(got["/summary"])["rank"] != 0:
        raise AssertionError(f"rank endpoint: {got}")
    return {"ops": {n: dict(p_["cpu"]) for n, p_ in off.items()},
            "endpoint_bytes": {k: len(v) for k, v in got.items()}}


def _skew_payloads(rank: int) -> dict:
    out = {}
    for n in SKEW_SIZES:
        ints = np.random.default_rng([15, n, rank]).integers(-60, 60, n)
        out[f"f32_{n}"] = ints.astype(np.float32)
        out[f"i32_{n}"] = (ints * 3).astype(np.int32)
    return out


def _skew_cases(p: int) -> dict:
    """name -> (entry point, kwargs, the preagg threshold, payload key)."""
    from rabit_tpu_torch.ops.reducers import MAX, MIN, SUM
    c = {}
    for key in _skew_payloads(0):
        for m in ("auto", "ring", "bidir", "swing"):
            c[f"{m}.{key}"] = ("allreduce", {"method": m}, "0", key)
        if p == 4:
            c[f"hier.{key}"] = ("allreduce", {"method": "hier"}, "0", key)
        for op, name in ((SUM, "sum"), (MAX, "max"), (MIN, "min")):
            c[f"preagg_{name}.{key}"] = ("allreduce", {
                "op": op, "method": "preagg" if op != SUM else "auto"},
                "0.0001", key)
        c[f"rs.{key}"] = ("device_reduce_scatter", {}, "0", key)
        c[f"ag.{key}"] = ("device_allgather", {}, "0", key)
        c[f"async.{key}"] = ("device_allreduce_async", {}, "0", key)
    c["bucket_async"] = ("bucket_allreduce_async", {}, "0",
                         f"f32_{SKEW_SIZES[1]},i32_{SKEW_SIZES[0]}")
    return c


def _skew_call(fn: str, kw: dict, pay: dict, key: str, p: int, lag: int):
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.telemetry import skew
    kw = dict(kw)
    if kw.get("method") == "preagg":
        kw["groups"] = skew.preagg_groups(p, lag)
    if "," in key:
        out = C.bucket_allreduce_async({k: pay[k] for k in key.split(",")},
                                       None).wait()
        return {f"|{k}": v for k, v in out.items()}
    out = getattr(C, fn)(pay[key], None, **kw)
    return {"": out.wait() if hasattr(out, "wait") else out}


def _skew_world_rank(rank: int, p: int, device) -> dict:
    """Phase 15 (b) on one rank of a world of ``p`` (NCCL or gloo): every
    case flat, then adapted around laggard p - 1 (one agreement boundary a
    call), then divergent candidates."""
    import os
    import torch.distributed as dist
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.telemetry import skew
    os.environ["RABIT_DISPATCH_TABLE"] = "none"
    lag = p - 1
    pay = {k: torch.from_numpy(v).to(device)
           for k, v in _skew_payloads(rank).items()}
    sent = []
    real = dist.broadcast

    def counted(*a, **k):
        sent.append(1)
        return real(*a, **k)
    dist.broadcast = counted
    got, tags = {}, []
    try:
        for adapted in (False, True):
            for name, (fn, kw, preagg, key) in _skew_cases(p).items():
                _skew_set(adapted, p, lag, preagg)
                if p == 4 and name.startswith("hier"):
                    os.environ["RABIT_HIER_GROUP"] = "0,1|2,3"
                before = len(sent)
                out = _skew_call(fn, kw, pay, key, p, lag)
                if adapted:
                    tags.append(f"{name}={skew.last_applied()}:"
                                f"{len(sent) - before}")
                for k, v in out.items():
                    got[f"{'adapted' if adapted else 'flat'}|{name}{k}"] = \
                        v.cpu().numpy()
        # divergent candidates: each rank accuses itself, rank 0's wins
        _skew_set(True, p, rank, sync_rounds="32")
        os.environ["RABIT_SKEW_DIGEST"] = _skew_digest(p, rank, epoch=2)
        skew.reset_monitor()
        skew.monitor().current()
        os.environ.pop("RABIT_SKEW_DIGEST")
        before = len(sent)
        x = pay[f"i32_{SKEW_SIZES[1]}"]
        got["divergent"] = C.allreduce(x, None, SUM,
                                       method="ring").cpu().numpy()
        applied = skew.monitor().applied()
        got["divergent_state"] = np.array(
            [applied["laggard"], applied["epoch"], len(sent) - before])
        got["divergent_tag"] = np.array(str(skew.last_applied()))
        if p == 4:
            _skew_subgroups(rank, x, got, sent)
        # one boundary, profiled: one broadcast call, and the broadcast
        # kernels the profiler records for it
        if device.type == "cuda":
            _skew_set(True, p, lag)
            before = len(sent)
            prof = _cpu_ops(lambda: C.allreduce(x, None, SUM, method="ring"))
            got["boundary_calls"] = np.array(len(sent) - before)
            got["boundary_kernels"] = np.array(sorted(
                f"{k} x{n}" for k, n in prof["kernels"].items()
                if "roadcast" in k))
            got["boundary_ms"] = _boundary_ms(
                pay[f"f32_{SKEW_SIZES[0]}"], p, lag)
    finally:
        dist.broadcast = real
        _skew_set(False, p, lag)
    got["tags"] = np.array(tags)
    return got


SKEW_SUBGROUPS = ("; with them, calls over pairs and crossing pairs planned "
                  "and broadcast nothing")


def _skew_subgroups(rank: int, x: torch.Tensor, got: dict,
                    sent: list) -> None:
    """Phase 15 (b) at world 4: each rank's candidate accuses itself (the
    divergent case above), a boundary every call, and calls over the
    pairs {0, 1}, {2, 3}, then over the crossing pairs {0, 2}, {1, 3}:
    a sub-group adopts no digest and plans nothing, so no member runs
    another ring than its peer, and nothing is broadcast."""
    import os
    import torch.distributed as dist
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.telemetry import skew
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    crossing = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    os.environ["RABIT_SKEW_SYNC_ROUNDS"] = "1"
    before, tags = len(sent), []
    for name, g in (("pair", pairs[rank // 2]),
                    ("cross", crossing[rank % 2])):
        for method in ("ring", "auto"):
            got[f"sub|{name}_{method}"] = C.allreduce(
                x, g, SUM, method=method).cpu().numpy()
            tags.append(f"{name}_{method}={skew.last_applied()}")
    got["sub_tags"] = np.array(tags)
    got["sub_state"] = np.array([len(sent) - before,
                                 int(skew.monitor().applied() is None)])


def _boundary_ms(x: torch.Tensor, p: int, lag: int) -> np.ndarray:
    """The host ms of one rotated-ring allreduce of ``x``, a boundary
    every call (``sync_rounds`` 1) against none (the knob off, and on
    with the boundary passed): ``SKEW_BOUNDARY_TURNS`` turns of
    ``SKEW_BOUNDARY_CALLS`` calls each way, rows [off, on without, on
    with a boundary]. A turn's calls run back to back and end with a
    device synchronisation."""
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    modes = ((False, "1"), (True, str(1 << 30)), (True, "1"))
    out = np.zeros((len(modes), SKEW_BOUNDARY_TURNS))
    for t in range(SKEW_BOUNDARY_TURNS):
        for m, (on, rounds) in enumerate(modes):
            _skew_set(on, p, lag, sync_rounds=rounds)
            C.allreduce(x, None, SUM, method="ring")   # the first boundary
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SKEW_BOUNDARY_CALLS):
                C.allreduce(x, None, SUM, method="ring")
            torch.cuda.synchronize()
            out[m, t] = (time.perf_counter() - t0) * 1e3 / SKEW_BOUNDARY_CALLS
    return out


def _skew_world(p: int) -> dict:
    """Phase 15 (b): the world over NCCL against the same world over gloo."""
    from rabit_tpu_torch.tools import run_world
    t0 = time.perf_counter()
    nccl = run_world(_skew_world_rank, p, "cuda", arrays=True,
                     timeout_s=SKEW_TIMEOUT_S)
    gloo = run_world(_skew_world_rank, p, "cpu", arrays=True,
                     timeout_s=SKEW_TIMEOUT_S)
    lag, n_cases = p - 1, 0
    for r in range(p):
        for key, flat in nccl[r].items():
            if not key.startswith("flat|"):
                continue
            n_cases += 1
            name = key[len("flat|"):]
            for what, other in (("adapted", nccl[r]["adapted|" + name]),
                                ("gloo", gloo[r][key]),
                                ("gloo adapted", gloo[r]["adapted|" + name])):
                if other.dtype != flat.dtype or \
                        other.tobytes() != flat.tobytes():
                    raise AssertionError(f"world {p} rank {r}: {name} "
                                         f"{what} differs from the flat run")
        tags = nccl[r]["tags"].tolist()
        if tags != nccl[0]["tags"].tolist() or \
                tags != gloo[r]["tags"].tolist():
            raise AssertionError(f"rank {r}: plans {tags} differ")
        for t in tags:
            name, rest = t.rsplit("=", 1)
            plan, bcasts = rest.rsplit(":", 1)
            explicit = name.startswith(("preagg_max", "preagg_min",
                                        "bucket_async"))
            if bcasts != "1" or (plan == "None") != explicit or \
                    (not explicit and not plan.endswith(f"@{lag}")):
                raise AssertionError(f"{t}: want one boundary and a plan "
                                     f"around laggard {lag}")
        state = nccl[r]["divergent_state"].tolist()
        if state != [0, 2, 1] or str(nccl[r]["divergent_tag"]) != "rotate@0" \
                or nccl[r]["divergent"].tobytes() != \
                gloo[r]["divergent"].tobytes():
            raise AssertionError(f"rank {r}: divergent candidates gave "
                                 f"{state}, {nccl[r]['divergent_tag']}")
        if p == 4:
            x = np.stack([_skew_payloads(q)[f"i32_{SKEW_SIZES[1]}"]
                          for q in range(p)])
            want = {"pair": x[r // 2 * 2] + x[r // 2 * 2 + 1],
                    "cross": x[r % 2] + x[r % 2 + 2]}
            for key, out in nccl[r].items():
                if key.startswith("sub|") and out.tobytes() != \
                        want[key[4:].split("_")[0]].tobytes():
                    raise AssertionError(f"rank {r}: {key} is not its "
                                         f"group's sum")
            sub = [t.split("=", 1)[1] for t in nccl[r]["sub_tags"].tolist()]
            if set(sub) != {"None"} or \
                    nccl[r]["sub_state"].tolist() != [0, 1]:
                raise AssertionError(f"rank {r}: sub-groups planned "
                                     f"{nccl[r]['sub_tags']}, state "
                                     f"{nccl[r]['sub_state']}")
        if int(nccl[r]["boundary_calls"]) != 1 or \
                not nccl[r]["boundary_kernels"].size:
            raise AssertionError(f"rank {r}: {nccl[r]['boundary_calls']} "
                                 f"broadcasts at one boundary, kernels "
                                 f"{nccl[r]['boundary_kernels']}")
    plans = sorted({t.rsplit("=", 1)[1].rsplit(":", 1)[0]
                    for t in nccl[0]["tags"].tolist()})
    # the slowest rank's median turn, a mode
    bms = np.max([np.median(g["boundary_ms"], axis=1) for g in nccl], axis=0)
    return {"cases": n_cases // p, "plans": plans,
            "boundary_kernels": nccl[0]["boundary_kernels"].tolist(),
            "boundary_ms": bms.tolist(),
            "boundary_turns_ms": nccl[0]["boundary_ms"].tolist(),
            "wall_s": time.perf_counter() - t0}


def _skew_tracker_run(p: int) -> dict:
    """Phase 15 (d): the launcher and tracker, no forced digest."""
    import os
    import socket
    import tempfile
    from rabit_tpu_torch.tools.skew_bench import worker_env
    from rabit_tpu_torch.tracker.launch import launch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tools.skew_round_worker",
           "--mode", "tracker", "rabit_engine=torch",
           f"rabit_coordinator=127.0.0.1:{port}", f"rabit_num_processes={p}",
           "rabit_telemetry=1", "rabit_metrics_port=0", "rabit_skew_adapt=1",
           "rabit_skew_poll_ms=100", "rabit_skew_sync_rounds=4"]
    stats = {}
    saved = os.environ.get("RABIT_METRICS_POLL_MS")
    os.environ["RABIT_METRICS_POLL_MS"] = "200"   # the tracker's sweep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            launch(p, cmd, max_attempts=0, timeout=SKEW_TIMEOUT_S, quiet=True,
                   stats=stats, metrics_port=0,
                   env=dict(worker_env(), RABIT_RESULT_DIR=tmp,
                            N_ROUNDS=str(SKEW_TRACKER_ROUNDS),
                            LAG_MS=str(SKEW_LAG_MS)))
            docs = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                    for r in range(p)]
    finally:
        if saved is None:
            os.environ.pop("RABIT_METRICS_POLL_MS", None)
        else:
            os.environ["RABIT_METRICS_POLL_MS"] = saved
    lag = docs[0]["lag_rank"]
    live = stats["live"]
    adopted = {d["adopted_round"] for d in docs}
    bad = [d["rank"] for d in docs
           if not (d["exact"] and d["crc_agree"]
                   and d["counts"].get("dispatch.skew_sync", 0) > 0
                   and d["counts"].get("dispatch.skew_adapted", 0) > 0
                   and d["tags"] == docs[0]["tags"])]
    if live["straggler"]["lagging_rank"] != lag or \
            live["skew"].get("laggard") != lag or \
            live["skew"].get("epoch", 0) < 1 or len(adopted) != 1 or \
            None in adopted or bad:
        raise AssertionError(f"tracker-driven run: straggler "
                             f"{live['straggler']}, digest {live['skew']}, "
                             f"adopted at {adopted}, ranks at fault {bad}")
    return {"lag_rank": lag, "adopted_round": adopted.pop(),
            "digest": live["skew"], "polls": live["polls"],
            "busy_skew_s": live["straggler"]["busy_skew_s"],
            "tags": sorted({t for t in docs[0]["tags"] if t}),
            "counts": docs[0]["counts"], "device": docs[0]["device"]}


def phase_skew(dev, power: str) -> dict:
    """The skew plane and the live plane (see the module's phase 15)."""
    from rabit_tpu_torch.tools import run_world
    from rabit_tpu_torch.tools import skew_bench
    a = run_world(_skew_one_card_rank, 1, "cuda", timeout_s=SKEW_TIMEOUT_S)[0]
    phase("skew", f"(a) world 1 over NCCL: with the knob off allreduce and "
          f"device_allreduce_async never enter the skew plane (its hooks "
          f"raise), no broadcast kernel, no host synchronisation beyond "
          f"an empty profile's, no counter advance (host operations "
          f"{a['ops']}); on, the boundary adopts the local candidate with "
          f"no broadcast and the same operations; adapt_plan re-roots the "
          f"tree at "
          f"world 2; the rank endpoint answers /metrics, /healthz, /summary "
          f"({a['endpoint_bytes']} B)")
    count = torch.cuda.device_count()
    if count < 2:
        phase("skew", "(b)-(d) did not run: one card; the NCCL world of the "
              "adapted schedules, the skew bench and the tracker-driven run "
              "need two or more")
        return {"a": a}
    p = min(4, count)
    b = _skew_world(p)
    phase("skew", f"(b) world {p} over NCCL, forced digest naming rank "
          f"{p - 1}: {b['cases']} calls (allreduce by auto, ring, bidir, "
          f"swing{', hier 2 x 2' if p == 4 else ''}, preagg SUM/MAX/MIN; "
          f"reduce-scatter, all-gather, the async allreduce and bucket "
          f"tree; f32 and i32 of {' and '.join(map(str, SKEW_SIZES))}) "
          f"adapted equal to the flat run and to gloo bit for bit, plans "
          f"{b['plans']}, one broadcast a boundary (its kernels under "
          f"torch.profiler: {b['boundary_kernels']}); divergent "
          f"candidates reconciled to rank 0's on every rank"
          f"{SKEW_SUBGROUPS if p == 4 else ''} ({b['wall_s']:.1f} s)")
    off, quiet, every = b["boundary_ms"]
    phase("skew", f"(b) a rotated ring allreduce of {SKEW_SIZES[0]} f32, "
          f"host ms a call (slowest rank's median of "
          f"{SKEW_BOUNDARY_TURNS} turns of {SKEW_BOUNDARY_CALLS}, the "
          f"modes in turns): knob off {off:.4f}, on between boundaries "
          f"{quiet:.4f}, on with a boundary every call {every:.4f}: a "
          f"boundary {every - quiet:.4f} ms (rank 0's turns "
          f"{[[round(v, 4) for v in r] for r in b['boundary_turns_ms']]}) "
          f"[{power}]")
    ranks = skew_bench.run_fleet(p, torch.device("cuda", 0), smoke=False)
    c = skew_bench.summary(ranks)
    if not c["correct"]:
        raise AssertionError("skew bench: a round's result was not exact")
    phase("skew", f"(c) skew bench, world {p} over NCCL, "
          f"{c['payload_elems']} f32 a rank, rank {c['lag_rank']} "
          f"{c['lag_ms']:.0f} ms late, {c['rounds']} rounds after "
          f"{c['warmup']}: flat {c['skew_round_ms_flat']:.3f} ms "
          f"{[round(v, 3) for v in c['round_ms']['flat']]}, adapted "
          f"({c['applied']}) {c['skew_round_ms_adapted']:.3f} ms "
          f"{[round(v, 3) for v in c['round_ms']['adapted']]} [{power}]")
    d = _skew_tracker_run(p)
    phase("skew", f"(d) tracker-driven, world {p} over NCCL: rank "
          f"{d['lag_rank']} {SKEW_LAG_MS} ms late in {SKEW_TRACKER_ROUNDS} "
          f"rounds of 2000000 f32; the tracker's /straggler names it (busy "
          f"skew {d['busy_skew_s']:.3f} s, {d['polls']} sweeps), its skew "
          f"digest {d['digest']}; every rank adopted at round "
          f"{d['adopted_round']} with plans {d['tags']}, counts "
          f"{d['counts']}, every result exact and equal across ranks "
          f"[{power}]")
    return {"a": a, "b": b, "c": c, "d": d}


# phase 16: the watchdog's ladder, the flight recorder and the overlap bench
STALL_WORKER = Path(__file__).resolve().parent / "tests" / "workers" / \
    "torch_stall_worker.py"
# deadlines well below the process groups' own timeouts (the data plane's
# 30 s TIMEOUT_S, NCCL's 10 min default for TorchEngine), so the ladder
# acts first
WD_BOOT_MS = 1500               # the hung bootstrap: exit at 1.5 + 2 x 1.5 s
WD_STALL = (2000, 5.0)          # TorchEngine: rungs at 2 s and 4 s, a 5 s sleep
WD_STOP_MS = 2000               # SIGSTOP: the abort rung at 2 + 2 x 2 = 6 s
WD_EXIT_MARGIN_S = 5.0          # the bundle's dump, the exit, the clocks' skew
# the data plane: retry at 6 s, a 7 s sleep. The deadline must clear the
# first collective, which forms the NCCL world under the same guard: on
# four H100s that took over 3 s in 2 of 4 runs, and a 3 s deadline then
# fired a retry rung before the scripted sleep began
WD_ROBUST = (6000, 7.0)
WD_TIMEOUT_S = 300
WD_GUARD_LOOP = 10_000
OVERLAP_DEVICE_DIMS = (384, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072)
OVERLAP_TIMEOUT_S = 900


def _stall_env(**kw) -> dict:
    import os
    path = os.pathsep.join(filter(None, [str(STALL_WORKER.parents[2]),
                                         os.environ.get("PYTHONPATH")]))
    return dict(os.environ, PYTHONPATH=path,
                **{k: str(v) for k, v in kw.items()})


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_bound(deadline_ms: int) -> float:
    d = deadline_ms / 1e3
    return d + 2 * max(0.5, d) + WD_EXIT_MARGIN_S


def _guard_host_us() -> dict:
    """Host us of one guard around nothing: armed (a 60 s deadline) and
    the disabled watchdog's shared no-op guard."""
    from rabit_tpu_torch.utils.watchdog import Watchdog
    out = {}
    for name, wd in (("null", Watchdog()),
                     ("armed", Watchdog(floor_ms=60000, abort=False))):
        t0 = time.perf_counter()
        for _ in range(WD_GUARD_LOOP):
            with wd.guard("engine.allreduce", nbytes=8192):
                pass
        out[name] = (time.perf_counter() - t0) / WD_GUARD_LOOP * 1e6
        wd.close()
    return out


def _wd_bootstrap(tmp: Path) -> dict:
    """The robust engine with the torch data plane on the card, its
    tracker waiting for a second worker that never comes."""
    from rabit_tpu_torch.tracker.tracker import Tracker
    fdir = tmp / "flight"
    tr = Tracker(2, ready_timeout=120.0).start()
    try:
        env = _stall_env(RABIT_TELEMETRY=1, RABIT_FLIGHT_DIR=fdir)
        env.update(tr.env(task_id="0"))
        p = subprocess.run(
            [sys.executable, str(STALL_WORKER), "bootstrap",
             f"rabit_deadline_ms={WD_BOOT_MS}", "rabit_dataplane=torch",
             "rabit_device=cuda"], env=env, capture_output=True, text=True,
            timeout=WD_TIMEOUT_S)
        t_exit = time.time()
    finally:
        tr.stop()
    bundles = sorted(fdir.glob("*_watchdog_abort.json")) \
        if fdir.is_dir() else []
    if p.returncode != 86 or len(bundles) != 1:
        raise AssertionError(f"hung bootstrap: exit {p.returncode}, bundles "
                             f"{bundles}:\n{p.stderr[-3000:]}")
    doc = json.loads(bundles[0].read_text())
    notes = {e["kind"]: e["t_unix"] for e in doc["events"]}
    if doc["reason"] != "watchdog_abort" or "engine.init" not in \
            doc["detail"] or "Thread" not in doc["stacks"] or \
            "watchdog_expired" not in notes:
        raise AssertionError(f"hung bootstrap's bundle: {doc['reason']}, "
                             f"{doc['detail']}, notes {list(notes)}")
    t0 = notes["watchdog_expired"] - WD_BOOT_MS / 1e3
    return {"exit_s": t_exit - t0, "bundle": bundles[0].name,
            "bound_s": _exit_bound(WD_BOOT_MS)}


def _proc_evidence(pid: int) -> dict:
    """What ``/proc`` says of a process that has not ended: its state,
    where it waits, its threads' states, and whether it still runs
    Python (its command line); read only, and best-effort."""
    base = Path(f"/proc/{pid}")
    doc = {"pid": pid}
    try:
        status = (base / "status").read_text().splitlines()
        doc["status"] = [ln for ln in status if ln.split(":")[0] in
                         ("State", "Threads", "VmRSS", "SigPnd", "ShdPnd")]
        doc["wchan"] = (base / "wchan").read_text()
        doc["cmdline"] = (base / "cmdline").read_bytes().replace(
            b"\0", b" ").decode(errors="replace")[:200]
        threads = {}
        for t in sorted((base / "task").iterdir()):
            fields = (t / "stat").read_text().rsplit(")", 1)[1].split()
            name = (t / "comm").read_text().strip()
            threads[f"{t.name}:{name}"] = fields[0]
        doc["threads"] = threads
    except OSError as e:
        doc["error"] = f"{type(e).__name__}: {e}"
    return doc


def _stall_world(p: int, mode: str, tmp: Path, args: list, env: dict,
                 wait_for: int) -> tuple:
    """``p`` stall workers of ``mode`` (rank r on card r), their output in
    files; waits for the first ``wait_for`` ranks and returns the
    processes and each waited rank's exit time."""
    port = _free_port()
    procs, logs = [], []
    for r in range(p):
        log = open(tmp / f"log{r}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(STALL_WORKER), mode, "rabit_device=cuda",
             f"rabit_coordinator=127.0.0.1:{port}",
             f"rabit_num_processes={p}", f"rabit_process_id={r}", *args],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            # a session of its own: a worker that stops itself (SIGSTOP)
            # in this script's process group would have the kernel send
            # the whole group SIGHUP, this script too, once the group is
            # orphaned (its parent shell exits)
            start_new_session=True))
    exits = {}
    deadline = time.monotonic() + WD_TIMEOUT_S
    try:
        while len(exits) < wait_for:
            for r in range(wait_for):
                if r not in exits and procs[r].poll() is not None:
                    exits[r] = time.time()
            if time.monotonic() > deadline:
                # the evidence, read before the kill: a process stuck in
                # its exit (a thread in state D or Z, the interpreter
                # gone) waits on the CUDA context's teardown; a live
                # interpreter is the watchdog's
                late = sorted(set(range(wait_for)) - set(exits))
                bundles = sorted(x.name for x in tmp.rglob("*.json"))
                logs_tail = {r: (tmp / f"log{r}.txt").read_text()[-1500:]
                             for r in late}
                raise AssertionError(
                    f"{mode} world: ranks {late} did not end in "
                    f"{WD_TIMEOUT_S} s; /proc: "
                    f"{[_proc_evidence(procs[r].pid) for r in late]}; "
                    f"files {bundles}; logs {logs_tail}")
            time.sleep(0.02)
    except BaseException:
        for q in procs:
            q.kill()
        raise
    finally:
        for log in logs:
            log.close()
    return procs, exits


def _wd_engine_stall(p: int, tmp: Path) -> dict:
    """TorchEngine over NCCL: rank p - 1 sleeps before op 2, abort off."""
    deadline_ms, sleep_s = WD_STALL
    env = _stall_env(RABIT_RESULT_DIR=tmp, STALL_RANK=p - 1, STALL_S=sleep_s)
    procs, _ = _stall_world(
        p, "engine", tmp, [f"rabit_deadline_ms={deadline_ms}",
                           "rabit_watchdog_abort=0", "rabit_telemetry=1",
                           "rabit_events=1"], env, p)
    bad = [r for r, q in enumerate(procs) if q.returncode != 0]
    if bad:
        raise AssertionError(f"TorchEngine stall: ranks {bad} failed:\n" +
                             (tmp / f"log{bad[0]}.txt").read_text()[-3000:])
    docs = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(p)]
    rungs = []
    for d in docs[:-1]:
        c, kinds = d["counters"], [n["kind"] for n in d["notes"]]
        if not d["exact"] or d["crcs"] != docs[-1]["crcs"] or \
                c.get("watchdog.expired|engine.allreduce") != 1 or \
                c.get("watchdog.reform|engine.allreduce") != 1 or \
                d["events"] != ["watchdog.retry", "watchdog.reform"] or \
                kinds != ["watchdog_expired", "watchdog.stall"]:
            raise AssertionError(f"TorchEngine stall, rank {d['rank']}: "
                                 f"exact {d['exact']}, counters {c}, events "
                                 f"{d['events']}, notes {kinds}")
        rungs.append([round(n["t_unix"] - d["t_call"], 3)
                      for n in d["notes"]])
    if not docs[-1]["exact"] or docs[-1]["expired_total"] != 0:
        raise AssertionError(f"TorchEngine stall, the sleeper: {docs[-1]}")
    return {"rungs_s": rungs,
            "done_s": [round(d["t_done"] - d["t_call"], 3) for d in docs]}


def _wd_stop(p: int, tmp: Path) -> dict:
    """TorchEngine over NCCL: rank p - 1 stops itself (SIGSTOP) before op
    2; the survivors' abort rung ends them with exit 86 and a bundle."""
    fdir = tmp / "flight"
    env = _stall_env(RABIT_RESULT_DIR=tmp, STALL_RANK=p - 1,
                     RABIT_FLIGHT_DIR=fdir)
    procs, exits = _stall_world(
        p, "stop", tmp, [f"rabit_deadline_ms={WD_STOP_MS}",
                         "rabit_telemetry=1"], env, p - 1)
    stopped = procs[-1]
    try:
        t_stall = json.loads((tmp / f"rank{p - 1}.json").read_text())[
            "t_stall"]
        if stopped.poll() is not None:
            raise AssertionError(f"the stopped rank exited "
                                 f"{stopped.returncode}")
    finally:
        stopped.kill()   # SIGKILL ends a stopped process
        stopped.wait(timeout=60)
    codes = [q.returncode for q in procs[:-1]]
    exit_s = [exits[r] - t_stall for r in range(p - 1)]
    bound = _exit_bound(WD_STOP_MS)
    if any(c != 86 for c in codes) or max(exit_s) > bound:
        raise AssertionError(f"SIGSTOP: survivors' exits {codes} after "
                             f"{exit_s} s (bound {bound} s)")
    stacks_ok = []
    for r in range(p - 1):
        bundles = list(fdir.glob(f"*_rank{r}_watchdog_abort.json"))
        if len(bundles) != 1:
            raise AssertionError(f"SIGSTOP: rank {r} left {bundles}")
        doc = json.loads(bundles[0].read_text())
        stacks_ok.append("allreduce" in doc["stacks"] and
                         "engine.allreduce" in doc["detail"])
    if not all(stacks_ok):
        raise AssertionError(f"SIGSTOP: a bundle's stacks lack the "
                             f"allreduce: {stacks_ok}")
    pids = {q.pid for q in procs}
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()
    held = [int(x) for x in smi if x.isdigit() and int(x) in pids]
    if held:
        raise AssertionError(f"SIGSTOP: workers {held} still hold a card")
    return {"exit_s": [round(x, 3) for x in exit_s], "bound_s": bound,
            "codes": codes, "compute_apps": smi}


def _wd_robust(p: int, tmp: Path) -> dict:
    """The robust engine over NCCL: rank p - 1's data plane sleeps inside
    a collective; the retry rung marks the NCCL world aborted and the
    round replays to the clean run's bits."""
    from rabit_tpu_torch.tracker.launch import launch
    deadline_ms, sleep_s = WD_ROBUST
    cmd = [sys.executable, str(STALL_WORKER), "robust",
           "rabit_dataplane=torch", "rabit_dataplane_minbytes=0",
           "rabit_device=cuda", f"rabit_deadline_ms={deadline_ms}",
           "rabit_watchdog_abort=0", "rabit_telemetry=1", "rabit_events=1"]
    runs = {}
    for name, stall in (("clean", 0), ("stall", sleep_s)):
        out = tmp / name
        out.mkdir()
        stats = {}
        t0 = time.monotonic()
        launch(p, cmd, max_attempts=0, timeout=WD_TIMEOUT_S, quiet=True,
               stats=stats, env={"PYTHONPATH": _stall_env()["PYTHONPATH"],
                                 "STALL_S": str(stall),
                                 "STALL_RANK": str(p - 1),
                                 "RABIT_RESULT_DIR": str(out)})
        docs = [json.loads((out / f"rank{r}.json").read_text())
                for r in range(p)]
        runs[name] = (docs, stats, time.monotonic() - t0)
    clean, stall = runs["clean"][0], runs["stall"][0]
    epoch = runs["stall"][1]["epoch"]
    bad = [d["rank"] for d in stall
           if d["crcs"] != clean[0]["crcs"] or not d["exact"]
           or d["counters"].get("recovery.retry|watchdog_rung") != 1
           or d["epoch"] < 2]
    if bad or epoch < 2 or any(d["crcs"] != clean[0]["crcs"] for d in clean):
        raise AssertionError(f"robust stall: ranks {bad} at fault (epoch "
                             f"{epoch}): {stall}")
    t_stall = stall[-1]["t_stall"]
    retry = [round(next(n["t_unix"] for n in d["notes"]
                        if n["kind"] == "watchdog_expired") - t_stall, 3)
             for d in stall]
    return {"epoch": epoch, "retry_s": retry,
            "replayed_s": [round(d["t_done"] - t_stall, 3) for d in stall],
            "formations": [d["formations"] for d in stall],
            "wall_s": {k: round(v[2], 1) for k, v in runs.items()}}


def _chain_ms(dim: int, reps: int, dev) -> float:
    """Median ms of the overlap worker's device chain (``reps`` f32
    products of [dim, dim], TF32 off) on ``dev``, synchronised."""
    a = torch.full((dim, dim), 1.0 / dim, device=dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        acc = a
        for _ in range(reps):
            acc = torch.matmul(acc, a)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _device_dim(allreduce_ms: float, reps: int, dev) -> tuple:
    """The least dim of ``OVERLAP_DEVICE_DIMS`` whose chain on the card
    takes at least one bucket's allreduce (the largest if none does):
    at the worker's 384 the chain is bound by its launches, so its time
    says nothing of the dim that would match."""
    chain = {}
    for dim in OVERLAP_DEVICE_DIMS:
        chain[dim] = _chain_ms(dim, reps, dev)
        if chain[dim] >= allreduce_ms:
            break
    return dim, chain


def _overlap_line(tag: str, res: dict, power: str) -> None:
    for name, q in res["paths"].items():
        phase("watchdog", f"{tag} {name}: step ms sync "
              f"{q['bucket_step_ms_sync']:.3f} "
              f"{[round(v, 3) for v in q['step_ms_sync']]}, overlap "
              f"{q['bucket_step_ms_overlap']:.3f} "
              f"{[round(v, 3) for v in q['step_ms_overlap']]}, "
              f"overlap/sync {q['overlap_over_sync']:.3f}; the recorder's "
              f"split a step: wire exposed {q['wire_exposed_ms']:.3f} ms, "
              f"overlapped {q['wire_overlapped_ms']:.3f} ms "
              f"({q['async_ops']} async ops); one bucket alone: compute "
              f"{q['compute_ms']:.3f} ms, allreduce {q['allreduce_ms']:.3f} "
              f"ms; sync = overlap bit for bit and exact [{power}]")


def phase_watchdog(dev, power: str) -> dict:
    """The watchdog, the flight recorder and the overlap bench (see the
    module's phase 16)."""
    import tempfile
    from rabit_tpu_torch.tools import overlap_bench as B
    from rabit_tpu_torch.tools import overlap_round_worker as W
    r = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.telemetry",
                        "--smoke"], env=_stall_env(), capture_output=True,
                       text=True, timeout=WD_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"telemetry --smoke: {r.stdout}{r.stderr}")
    count = torch.cuda.device_count()
    p = min(4, count)
    B.smoke(torch.device("cuda", 0), p)
    guard_us = _guard_host_us()
    with tempfile.TemporaryDirectory() as tmp:
        boot = _wd_bootstrap(Path(tmp))
    phase("watchdog", f"(a) telemetry --smoke ok; overlap_bench --smoke at "
          f"world {p} over NCCL ok (async = sync bit for bit, a live guard "
          f"untripped, the window drained); the robust engine's hung "
          f"bootstrap (rabit_device=cuda, deadline {WD_BOOT_MS} ms) exited "
          f"86 {boot['exit_s']:.3f} s after its guard armed (bound "
          f"{boot['bound_s']:.1f} s) with bundle {boot['bundle']} naming "
          f"engine.init; host us a guard around nothing (loops of "
          f"{WD_GUARD_LOOP}): armed {guard_us['armed']:.3f}, NULL_GUARD "
          f"{guard_us['null']:.3f} [{power}]")
    doc = {"bootstrap": boot, "guard_us": guard_us}
    if count < 2:
        phase("watchdog", "(b) did not run: one card; the overlap bench's "
              "world and the stall scenarios need two or more")
        return doc
    cfg = W.config({})
    base = B.run(dev, p, cfg)
    ddim, chain = _device_dim(base["paths"]["device"]["allreduce_ms"],
                              cfg["COMPUTE_REPS"], dev)
    matched = B.run(dev, p, dict(cfg, COMPUTE_DIM=ddim, PATHS=("device",)))
    for res in (base, matched):
        if not res["correct"]:
            raise AssertionError(f"overlap bench: {res['paths']}")
    _overlap_line(f"(b) overlap bench, world {p} over NCCL, "
                  f"{cfg['N_BUCKETS']} buckets of {cfg['BUCKET_ELEMS']} f32, "
                  f"compute dim {cfg['COMPUTE_DIM']}:", base, power)
    phase("watchdog", f"(b) the device chain's ms by dim on card 0: "
          f"{ {d: round(t, 3) for d, t in chain.items()} }")
    _overlap_line(f"(b) overlap bench, compute dim {ddim} (a bucket's compute "
                  f"on the card about its allreduce):", matched, power)
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "e").mkdir()
        (Path(tmp) / "s").mkdir()
        (Path(tmp) / "r").mkdir()
        eng = _wd_engine_stall(p, Path(tmp) / "e")
        stop = _wd_stop(p, Path(tmp) / "s")
        rob = _wd_robust(p, Path(tmp) / "r")
    phase("watchdog", f"(b) TorchEngine over NCCL, rank {p - 1} asleep "
          f"{WD_STALL[1]} s before an allreduce, deadline {WD_STALL[0]} ms, "
          f"abort off: every survivor counted watchdog.expired and "
          f"watchdog.reform, emitted watchdog.retry and watchdog.reform, "
          f"noted watchdog.stall; seconds from its call to each rung "
          f"{eng['rungs_s']}, to the result {eng['done_s']}; every sum "
          f"exact [{power}]")
    phase("watchdog", f"(b) rank {p - 1} stopped (SIGSTOP), deadline "
          f"{WD_STOP_MS} ms: the survivors exited {stop['codes']} "
          f"{stop['exit_s']} s after the stall (bound {stop['bound_s']:.1f} "
          f"s), each bundle's stacks in the allreduce; the stopped rank "
          f"killed, no worker holds a card (compute apps "
          f"{stop['compute_apps']}) [{power}]")
    phase("watchdog", f"(b) the robust engine over NCCL, rank {p - 1}'s data "
          f"plane asleep {WD_ROBUST[1]} s inside a collective, deadline "
          f"{WD_ROBUST[0]} ms: the retry rung on every rank "
          f"{rob['retry_s']} s after the stall marked the NCCL world "
          f"aborted, the round failed and replayed at epoch {rob['epoch']} "
          f"{rob['replayed_s']} s after the stall (formations "
          f"{rob['formations']}); every result equal to the clean run's "
          f"bit for bit (wall s {rob['wall_s']}) [{power}]")
    doc.update(overlap={"base": base, "matched": matched, "chain_ms": chain},
               engine_stall=eng, stop=stop, robust=rob)
    return doc


# phase 17: elastic membership and the in-process resize. The worker of
# tests/test_torch_resize.py at the headline histogram (bench.py:311-312)
RESIZE_WORKER = Path(__file__).resolve().parent / "tests" / "workers" / \
    "torch_resize_worker.py"
RESIZE_HIST = (1 << 21, 1024)
RESIZE_SEED = 17
RESIZE_TIMEOUT_S = 300


def _resize_world_one() -> dict:
    """Phase 17 (a), in a fresh process on the card at world 1: what
    ``rabit_tpu_torch.resize`` does under each engine, as JAX's does."""
    code = (
        "import json, torch, rabit_tpu_torch as R\n"
        "out = {}\n"
        "for eng, args in (('robust_torch', ['rabit_device=cuda']),\n"
        "                  ('empty', []), ('torch', ['rabit_device=cuda'])):\n"
        "    R.init(args, engine=eng)\n"
        "    got = []\n"
        "    for cmd in ('recover', 'join', 'grow'):\n"
        "        try:\n"
        "            R.resize(cmd)\n"
        "            got.append(R.get_world_size())\n"
        "        except (NotImplementedError, ValueError) as e:\n"
        "            got.append(type(e).__name__)\n"
        "    R.finalize()\n"
        "    out[eng] = got\n"
        "out['cuda'] = torch.cuda.is_initialized()\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], env=_stall_env(),
                       capture_output=True, text=True,
                       timeout=RESIZE_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"resize at world 1: {r.stdout}{r.stderr}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    want = {"robust_torch": [1, 1, "ValueError"],
            "empty": ["NotImplementedError"] * 3,
            "torch": ["NotImplementedError"] * 3, "cuda": True}
    if got != want:
        raise AssertionError(f"resize at world 1: {got}, want {want}")
    r = subprocess.run([sys.executable, "-m",
                        "rabit_tpu_torch.tracker.membership", "--smoke"],
                       env=_stall_env(), capture_output=True, text=True,
                       timeout=RESIZE_TIMEOUT_S)
    if r.returncode != 0 or "elastic smoke ok" not in r.stdout:
        raise AssertionError(f"membership --smoke: {r.stdout}{r.stderr}")
    return got


def _resize_run(p: int, tmp: Path, resize: bool) -> tuple:
    """The resize worker as ``p`` ranks under the port's launcher with
    elastic membership, the robust engine and the torch data plane on
    the cards; each task's document and the launcher's stats."""
    from rabit_tpu_torch.tracker.launch import launch
    out = tmp / ("resize" if resize else "base")
    out.mkdir()
    env = {"RESIZE_OUT": str(out), "KILL_TASK": "1",
           "RESIZE_DEADLINE": str(RESIZE_TIMEOUT_S - 60),
           "RESIZE_HIST_ROWS": str(RESIZE_HIST[0]),
           "RESIZE_HIST_BINS": str(RESIZE_HIST[1]),
           "RESIZE_SEED": str(RESIZE_SEED),
           "PYTHONPATH": _stall_env()["PYTHONPATH"]}
    if resize:
        env["RESIZE_ENABLE"] = "1"
    stats = {}
    launch(p, [sys.executable, str(RESIZE_WORKER), "rabit_device=cuda",
               "rabit_telemetry=1"], max_attempts=0,
           timeout=RESIZE_TIMEOUT_S, quiet=True, stats=stats, env=env,
           elastic=True)
    docs = {t: json.loads((out / f"r{t}.json").read_text())
            for t in range(p)}
    return docs, stats


def _resize_checks(p: int, base: dict, docs: dict, stats: dict) -> dict:
    """Phase 17 (b)'s verdicts on the resize run against the baseline."""
    victim = docs[1]
    if stats["total_attempts"] != 0 or stats["membership"]["epoch"] != 3 \
            or stats["membership"]["world"] != p:
        raise AssertionError(f"resize: attempts {stats['total_attempts']}, "
                             f"membership {stats['membership']}")
    launches = 0
    for t, d in docs.items():
        post = [(r["round"], r["crc"], r["hist_crc"])
                for r in d["rounds"] if r["tag"] == "post"]
        want = [(r["round"], r["crc"], r["hist_crc"])
                for r in base[t]["rounds"] if r["tag"] == "post"]
        if post != want or len(post) != 5:
            raise AssertionError(f"task {t}: POST rounds {post} differ from "
                                 f"the fixed world's {want}")
        mids = [r for r in d["rounds"] if r["tag"] == "mid"]
        if len(mids) != (0 if t == 1 else 3) or \
                any(r["world"] != p - 1 for r in mids):
            raise AssertionError(f"task {t}: MID rounds {mids}")
        cards = {(x["current"], x["dataplane"]) for x in d["devices"]}
        if len(cards) != 1 or len(d["devices"]) != 3:
            raise AssertionError(f"task {t} changed its card: "
                                 f"{d['devices']}")
        cur, dpdev = cards.pop()
        if dpdev != f"cuda:{cur}":
            raise AssertionError(f"task {t}: current device {cur}, data "
                                 f"plane {dpdev}")
        if d["backend"] != "nccl" or d["launches"] != \
                [1] * len(d["rounds"]):
            raise AssertionError(f"task {t}: backend {d['backend']}, "
                                 f"histogram launches {d['launches']}")
        launches += sum(d["launches"])
        epochs = [w["epoch"] for w in d["world_reform"]]
        if epochs != ([1, 3] if t == 1 else [1, 2, 3]):
            raise AssertionError(f"task {t}: formations at epochs {epochs}")
    cards = [d["devices"][0]["current"] for d in docs.values()]
    if len(set(cards)) != p:
        raise AssertionError(f"two members on one card: {cards}")
    survivors = [d for t, d in docs.items() if t != 1]

    def first(d, tag):
        return next(r for r in d["rounds"] if r["tag"] == tag)

    def slowest(values):
        return round(max(values), 4)

    join = victim["resizes"][0]
    return {"shrink_s": max(first(d, "mid")["t_int64"] for d in survivors)
            - victim["evicted_at"],
            "grow_s": max(first(d, "post")["t_int64"]
                          for d in docs.values()) - join["t0"],
            # the slowest member's share of each step: the evict to its
            # resize call (the world-doc poll), the resize, the first
            # collective of the new world (its formation inside)
            "shrink_split": {
                "to_resize": slowest(d["resizes"][0]["t0"]
                                     - victim["evicted_at"]
                                     for d in survivors),
                "resize": slowest(d["resizes"][0]["t1"]
                                  - d["resizes"][0]["t0"]
                                  for d in survivors),
                "first_collective": slowest(
                    first(d, "mid")["t_int64"] - first(d, "mid")["t_start"]
                    for d in survivors)},
            "grow_split": {
                "to_resize": slowest(d["resizes"][1]["t0"] - join["t0"]
                                     for d in survivors),
                "resize": slowest([d["resizes"][1]["t1"]
                                   - d["resizes"][1]["t0"]
                                   for d in survivors]
                                  + [join["t1"] - join["t0"]]),
                "first_collective": slowest(
                    first(d, "post")["t_int64"] - first(d, "post")["t_start"]
                    for d in docs.values())},
            "formations": {t: [round(w["dur"], 4) for w in d["world_reform"]]
                           for t, d in docs.items()},
            "cards": cards, "launches": launches,
            "pids": [d["pid"] for d in docs.values()]}


def phase_elastic(power: str) -> dict:
    """Elastic membership and the in-process resize (see the module's
    phase 17)."""
    import tempfile
    one = _resize_world_one()
    phase("elastic", f"(a) world 1 on the card: resize('recover'), "
          f"('join') and ('grow') under robust_torch {one['robust_torch']}, "
          f"under empty {one['empty']} and torch {one['torch']}, as JAX's "
          f"engines; membership --smoke ok (a tracker of 2: 2 -> 1 -> 2)")
    count = torch.cuda.device_count()
    if count < 3:
        phase("elastic", f"(b) did not run: {count} card(s); the resize "
              f"p -> p - 1 -> p needs three or more")
        return {"world_one": one, "launches": None}
    p = min(4, count)
    with tempfile.TemporaryDirectory() as tmp:
        base, bstats = _resize_run(p, Path(tmp), False)
        docs, stats = _resize_run(p, Path(tmp), True)
    if bstats["total_attempts"] != 0:
        raise AssertionError(f"the fixed-world run respawned: {bstats}")
    res = _resize_checks(p, base, docs, stats)
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()
    pids = set(res["pids"]) | {d["pid"] for d in base.values()}
    held = [int(x) for x in smi if x.isdigit() and int(x) in pids]
    if held:
        raise AssertionError(f"resize: workers {held} still hold a card")
    phase("elastic", f"(b) world {p} -> {p - 1} -> {p} in process (robust "
          f"engine, rabit_dataplane=torch over NCCL, the launcher elastic): "
          f"each round an int64 allreduce of 256 and a histogram of "
          f"{RESIZE_HIST[0]} x {RESIZE_HIST[1]} a rank by the kernel on the "
          f"rank's card, allreduced; MID rounds exact, POST equal to the "
          f"fixed world's bit for bit, 0 respawns, cards {res['cards']} "
          f"kept by every process through both resizes, the kernel "
          f"launched once a round on every member ({res['launches']} in "
          f"all), no worker left on a card (compute apps {smi})")
    phase("elastic", f"(b) the victim's evict to the survivors' first MID "
          f"collective {res['shrink_s']:.3f} s (slowest survivor's s to its "
          f"resize call, in it, in the first collective: "
          f"{res['shrink_split']}); its join to the first POST collective "
          f"{res['grow_s']:.3f} s ({res['grow_split']}); each formation's s "
          f"(recovery.world_reform, by task) {res['formations']} [{power}]")
    return dict(res, world_one=one)


# phase 18: the tracker's write-ahead log and resume. The worker of
# tests/test_torch_resume.py at the headline histogram, as phase 17's
RESUME_WORKER = Path(__file__).resolve().parent / "tests" / "workers" / \
    "torch_resume_worker.py"
RESUME_ROUNDS = 30
RESUME_SLEEP_MS = 200
RESUME_KILL_AFTER = 5     # the supervisor's kill once every rank has
RESUME_OUTAGE_MS = 1500   # logged this round, and the outage it sets
RESUME_SHRINK_AT = 20     # (b): task 1 leaves at this round
RESUME_TIMEOUT_S = 300


def _logged_round(out: Path, p: int) -> int:
    """The least round every one of ``p`` tasks has logged (-1: none)."""
    least = None
    for t in range(p):
        path = out / f"r{t}.log"
        done = [int(m.group(1)) for m in re.finditer(
            r"^round=(\d+) ", path.read_text() if path.exists() else "",
            re.M)]
        least = min(least if least is not None else 1 << 30,
                    max(done, default=-1))
    return -1 if least is None else least


def _resume_env(out: Path, hist) -> dict:
    """The resume worker's environment: its output, rounds, histogram and
    seed, and the skew poller's cadence."""
    return {"RESUME_OUT": str(out), "RESUME_ROUNDS": str(RESUME_ROUNDS),
            "RESUME_ROUND_SLEEP_MS": str(RESUME_SLEEP_MS),
            "RESUME_HIST_ROWS": str(hist[0]),
            "RESUME_HIST_BINS": str(hist[1]),
            "RESUME_SEED": str(RESIZE_SEED),
            "RESUME_DEADLINE": str(RESUME_TIMEOUT_S - 60),
            "RABIT_SKEW_POLL_MS": "200",
            "PYTHONPATH": _stall_env()["PYTHONPATH"]}


def _resume_run(p: int, tmp: Path, tag: str, wal: bool, elastic: bool,
                device: str = "cuda", hist=RESIZE_HIST) -> tuple:
    """The resume worker as ``p`` ranks under the port's launcher (the
    robust engine, the torch data plane on ``device``); with ``wal`` the
    tracker journals into a directory of its own and the supervisor kills
    it once every rank has logged round ``RESUME_KILL_AFTER``, resuming it
    ``RESUME_OUTAGE_MS`` later. ``elastic``: task 1 leaves at round
    ``RESUME_SHRINK_AT`` and the survivors resize (after the resume, when
    there is a kill). Each task's document, the launcher's stats and the
    journal's directory."""
    import os
    from rabit_tpu_torch.tracker.launch import launch
    from rabit_tpu_torch.tracker.wal import WAL_DIR_ENV
    out = tmp / tag
    out.mkdir()
    env = _resume_env(out, hist)
    resumed = out / "resumed"
    if elastic:
        env.update(RESUME_SHRINK_AT=str(RESUME_SHRINK_AT), KILL_TASK="1")
        if wal:
            env["RESUME_AWAIT"] = str(resumed)
    def tick(sup):
        if not wal or resumed.exists():
            return
        if not sup.killed_at:
            if _logged_round(out, p) >= RESUME_KILL_AFTER:
                sup.kill(RESUME_OUTAGE_MS)
        elif sup.restarts:
            resumed.write_text("1")

    wal_dir = tmp / f"{tag}.wal"
    old = os.environ.pop(WAL_DIR_ENV, None)
    if wal:
        os.environ[WAL_DIR_ENV] = str(wal_dir)
    stats = {}
    try:
        launch(p, [sys.executable, str(RESUME_WORKER),
                   f"rabit_device={device}", "rabit_dataplane=torch",
                   "rabit_telemetry=1"], max_attempts=0,
               timeout=RESUME_TIMEOUT_S, quiet=True, stats=stats, env=env,
               elastic=elastic, tick=tick)
    finally:
        os.environ.pop(WAL_DIR_ENV, None)
        if old is not None:
            os.environ[WAL_DIR_ENV] = old
    docs = {t: json.loads((out / f"r{t}.json").read_text())
            for t in range(p)}
    return docs, stats, wal_dir


def _stream_checks(p: int, base: dict, docs: dict, elastic: bool,
                   device: str) -> tuple:
    """Each task's rounds against the uninterrupted twin's, bit for bit,
    with a launch a round, the formations at the expected epochs, one
    device for the kernel and the data plane kept for the run, the shrunk
    world's rounds at p - 1 (``elastic``), and distinct cards; the
    launches in all and the cards by task."""
    launches, cards = 0, []
    for t, d in docs.items():
        got = [(r["round"], r["world"], r["crc"], r["hist_crc"])
               for r in d["rounds"]]
        want = [(r["round"], r["world"], r["crc"], r["hist_crc"])
                for r in base[t]["rounds"]]
        n = RESUME_SHRINK_AT if elastic and t == 1 else RESUME_ROUNDS
        if got != want or [g[0] for g in got] != list(range(n)):
            raise AssertionError(f"task {t}: rounds {got} differ from the "
                                 f"uninterrupted run's {want}")
        # the wrapper counts the kernel's launches: none on the CPU
        if d["launches"] != [int(device == "cuda")] * n:
            raise AssertionError(f"task {t}: histogram launches "
                                 f"{d['launches']}")
        launches += sum(d["launches"])
        epochs = [s["epoch"] for s in d["world_reform"]]
        # at world 1 the native core reduces nothing, and no torch world
        # forms
        want = [] if p == 1 else [1, 2] if elastic and t != 1 else [1]
        if epochs != want:
            raise AssertionError(f"task {t}: formations at epochs {epochs}")
        # one device for the kernel and the data plane (none at world 1),
        # kept for the run
        devs = {(x["hist"], x["dataplane"] or x["hist"]) for x in d["devices"]}
        card, dp = devs.pop() if len(devs) == 1 else (None, None)
        if card != dp or not card.startswith(device):
            raise AssertionError(f"task {t}: devices {d['devices']}")
        cards.append(card)
        if elastic and t != 1 and any(
                r["world"] != p - 1 for r in d["rounds"][RESUME_SHRINK_AT:]):
            raise AssertionError(f"task {t}: the shrunk world's rounds")
    if device == "cuda" and len(set(cards)) != p:
        raise AssertionError(f"two members on one card: {cards}")
    return launches, cards


def _resume_checks(p: int, base: dict, docs: dict, stats: dict,
                   wal_dir: Path, elastic: bool, device: str) -> dict:
    """Phase 18's verdicts on a killed run against its uninterrupted
    twin: every round present and bit for bit the twin's, one restart,
    no respawn, the expected epochs and evictions, a launch a round, the
    journal's records."""
    from rabit_tpu_torch.tracker.wal import WriteAheadLog
    w = stats["tracker_wal"]
    if stats["tracker_restarts"] != 1 or w["restarts"] != 1 or \
            w["records"] <= 0 or stats["total_attempts"] != 0 or \
            stats["readmissions"] != 0:
        raise AssertionError(f"resume: restarts {stats['tracker_restarts']}"
                             f", journal {w}, attempts "
                             f"{stats['total_attempts']}, re-admissions "
                             f"{stats['readmissions']}")
    member = stats["membership"]
    want_evicted = [docs[1]["rounds"][0]["rank"]] if elastic else []
    if member["evicted"] != want_evicted or \
            member["epoch"] != (2 if elastic else 1):
        raise AssertionError(f"resume: membership {member}")
    launches, cards = _stream_checks(p, base, docs, elastic, device)
    kinds = [k for k, _ in WriteAheadLog(str(wal_dir)).replay()]
    # the evicted task leaves without a shutdown
    downs = kinds.count("down")
    if kinds.count("resume") != 1 or "epoch" not in kinds or \
            "topo" not in kinds or downs != (p - 1 if elastic else p):
        raise AssertionError(f"resume: journal kinds {kinds}")
    return {"launches": launches, "cards": cards,
            "kinds": {k: kinds.count(k) for k in sorted(set(kinds))}}


def _resume_numbers(base: dict, docs: dict, stats: dict) -> dict:
    """The outage as each worker saw it, the replay, and epoch 1's
    formation with the WAL off (``base``) and on (``docs``)."""
    def epoch1(d):
        return next((round(s["dur"], 4) for s in d["world_reform"]
                     if s["epoch"] == 1), None)

    w = stats["tracker_wal"]
    return {
        "outage_s": {t: [round(o["s"], 4) for o in d["outages"]]
                     for t, d in docs.items()},
        "kill_to_resume_s": round(w["resumed_at"][0] - w["killed_at"][0], 4),
        "replayed": w["replayed"], "replay_ms": round(w["replay_ms"], 3),
        # the killed incarnation's journaling: the formation's records
        # (an assign a rank, the epoch, the topology) and nothing else
        "formation_journal_ms": round(w["journal_s"][0] * 1e3, 3),
        "journal_ms": round(sum(w["journal_s"]) * 1e3, 3),
        "records": w["records"],
        "init_s": {"wal_off": [round(d["init_s"], 4) for d in base.values()],
                   "wal_on": [round(d["init_s"], 4) for d in docs.values()]},
        "formation_s": {
            "wal_off": [epoch1(d) for d in base.values()],
            "wal_on": [epoch1(d) for d in docs.values()]}}


def _resume_pair(p: int, tmp: Path, elastic: bool, device: str = "cuda",
                 hist=RESIZE_HIST) -> tuple:
    """Phase 18's uninterrupted run and its killed twin: the verdicts and
    numbers, and the uninterrupted run's documents (phase 19's reference
    at the same world, seed and rounds)."""
    tag = "elastic" if elastic else "fixed"
    base, bstats, _ = _resume_run(p, tmp, f"{tag}_base", False, elastic,
                                  device, hist)
    if bstats["total_attempts"] != 0 or bstats["tracker_restarts"] != 0:
        raise AssertionError(f"the uninterrupted run: {bstats}")
    docs, stats, wal_dir = _resume_run(p, tmp, f"{tag}_kill", True, elastic,
                                       device, hist)
    res = _resume_checks(p, base, docs, stats, wal_dir, elastic, device)
    res.update(_resume_numbers(base, docs, stats))
    res["pids"] = [d["pid"] for d in list(base.values())
                   + list(docs.values())]
    return res, base


def phase_resume(power: str) -> dict:
    """The tracker's write-ahead log and resume (see the module's phase
    18). Its summary, and the uninterrupted runs' documents by part."""
    import tempfile
    r = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.tracker.wal",
                        "--smoke"], env=_stall_env(), capture_output=True,
                       text=True, timeout=RESUME_TIMEOUT_S)
    if r.returncode != 0 or "wal smoke ok" not in r.stdout:
        raise AssertionError(f"wal --smoke: {r.stdout}{r.stderr}")
    out, bases = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        a, bases["a"] = _resume_pair(1, Path(tmp), False)
    out["a"] = a
    phase("resume", f"(a) wal --smoke ok; world 1 on card 0 under the "
          f"launcher with RABIT_TRACKER_WAL_DIR (robust engine, "
          f"rabit_dataplane=torch; at world 1 no torch world forms): "
          f"{RESUME_ROUNDS} rounds of an "
          f"int64 allreduce of 256 and a histogram of {RESIZE_HIST[0]} x "
          f"{RESIZE_HIST[1]} by the kernel, the tracker killed after round "
          f"{RESUME_KILL_AFTER} and resumed {RESUME_OUTAGE_MS} ms later: "
          f"every round bit for bit the uninterrupted run's, 1 restart, 0 "
          f"respawns, 0 evictions, epoch 1 throughout, the kernel launched "
          f"once a round ({a['launches']}), journal {a['kinds']}")
    phase("resume", f"(a) the outage as the worker saw it {a['outage_s']} "
          f"s (kill to resume {a['kill_to_resume_s']} s); the replay "
          f"{a['replayed']} records in {a['replay_ms']} ms; journaling "
          f"{a['journal_ms']} ms in all ({a['records']} records), of which "
          f"the formation's {a['formation_journal_ms']} ms; epoch 1's "
          f"init s WAL off {a['init_s']['wal_off']} / on "
          f"{a['init_s']['wal_on']}, formation s (recovery.world_reform) "
          f"off {a['formation_s']['wal_off']} / on "
          f"{a['formation_s']['wal_on']} [{power}]")
    count = torch.cuda.device_count()
    if count < 2:
        phase("resume", f"(b) did not run: {count} card(s); the shrink "
              f"through the resumed tracker needs two or more")
        out["b"] = None
        out["launches"] = {"a": a["launches"], "b": None}
        return out, bases
    p = min(4, count)
    with tempfile.TemporaryDirectory() as tmp:
        b, bases["b"] = _resume_pair(p, Path(tmp), True)
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()
    held = [int(x) for x in smi if x.isdigit() and int(x) in b["pids"]]
    if held:
        raise AssertionError(f"resume: workers {held} still hold a card")
    out["b"] = b
    out["launches"] = {"a": a["launches"], "b": b["launches"]}
    phase("resume", f"(b) world {p} elastic, the same kill and resume, then "
          f"task 1 evicted itself at round {RESUME_SHRINK_AT} and the "
          f"survivors resize('recover') through the resumed tracker, which "
          f"hosted epoch 2's store: every round bit for bit the "
          f"uninterrupted run's (the shrunk world's exact), 1 restart, 0 "
          f"respawns, the one scripted eviction, cards {b['cards']} kept, "
          f"the kernel launched once a round ({b['launches']}), journal "
          f"{b['kinds']}, no worker left on a card (compute apps {smi})")
    phase("resume", f"(b) outage by task {b['outage_s']} s (kill to resume "
          f"{b['kill_to_resume_s']} s); replay {b['replayed']} records in "
          f"{b['replay_ms']} ms; the formation's journaling "
          f"{b['formation_journal_ms']} ms (the run's "
          f"{b['journal_ms']} ms); epoch 1's init s off "
          f"{b['init_s']['wal_off']}"
          f" / on {b['init_s']['wal_on']}, formation s off "
          f"{b['formation_s']['wal_off']} / on {b['formation_s']['wal_on']}"
          f" [{power}]")
    return out, bases


# phase 19: the hot standby and the chaos front proxy. Phase 18's worker,
# rounds and histogram, under a WAL, a standby and the front proxy
FAILOVER_LEASE_MS = 800
FAILOVER_KILL_DELAY_MS = 4000     # the cold respawn the adoption cancels
FAILOVER_PARTITION = (RESUME_KILL_AFTER, 15)   # the rounds it covers
FAILOVER_GRACE_MS = 15000
FAILOVER_NEVER = [1e9, 1e9 + 1]   # a rule's window before the tick opens it
FAILOVER_CHAOS = {
    "kill": {"seed": 11, "rules": [
        {"kind": "tracker_kill", "target": "tracker",
         "window_s": FAILOVER_NEVER, "delay_ms": FAILOVER_KILL_DELAY_MS}]},
    "partition": {"seed": 13, "rules": [
        {"kind": "tracker_partition", "window_s": FAILOVER_NEVER}]}}


def _set_window(proxy, kind: str, start: float, end: float) -> None:
    """Move ``kind``'s window of the front proxy's schedule."""
    for rule in proxy.schedule.rules:
        if rule.kind == kind:
            rule.window_s = (start, end)


def _failover_run(p: int, tmp: Path, tag: str, mode: str, elastic: bool,
                  device: str = "cuda", hist=RESIZE_HIST) -> tuple:
    """The resume worker as ``p`` ranks under the port's launcher with a
    WAL, a hot standby (``RABIT_TRACKER_STANDBY=1``, a lease of
    ``FAILOVER_LEASE_MS``) and the chaos front proxy: once every rank has
    logged round ``RESUME_KILL_AFTER`` the tick opens the schedule's
    window, ``tracker_kill`` from then on, or ``tracker_partition`` until
    every rank has logged round ``FAILOVER_PARTITION[1]``. ``elastic``:
    task 1 leaves at round ``RESUME_SHRINK_AT``, once the standby has been
    adopted. Each task's document, the launcher's stats, the journal's
    directory and the tick's proxy clocks."""
    import os
    from rabit_tpu_torch.tracker.launch import launch
    from rabit_tpu_torch.tracker.wal import WAL_DIR_ENV
    out = tmp / tag
    out.mkdir()
    env = _resume_env(out, hist)
    adopted = out / "adopted"
    if elastic:
        env.update(RESUME_SHRINK_AT=str(RESUME_SHRINK_AT), KILL_TASK="1",
                   RESUME_AWAIT=str(adopted))
    clocks = {}

    def tick(sup):
        if sup.failovers and not adopted.exists():
            adopted.write_text("1")
        rnd = _logged_round(out, p)
        proxy = sup.proxy
        if "opened" not in clocks and rnd >= RESUME_KILL_AFTER:
            clocks["opened"] = proxy.elapsed()
            kind = "tracker_kill" if mode == "kill" else "tracker_partition"
            _set_window(proxy, kind, clocks["opened"], 1e9)
        if mode == "partition" and "opened" in clocks and \
                "closed" not in clocks and rnd >= FAILOVER_PARTITION[1]:
            clocks["closed"] = proxy.elapsed()
            _set_window(proxy, "tracker_partition", clocks["opened"],
                        clocks["closed"])

    wal_dir = tmp / f"{tag}.wal"
    knobs = {WAL_DIR_ENV: str(wal_dir), "RABIT_TRACKER_STANDBY": "1",
             "RABIT_LEASE_MS": str(FAILOVER_LEASE_MS),
             "RABIT_TRACKER_RESUME_GRACE_MS": str(FAILOVER_GRACE_MS)}
    old = {k: os.environ.pop(k, None) for k in knobs}
    os.environ.update(knobs)
    stats = {}
    try:
        launch(p, [sys.executable, str(RESUME_WORKER),
                   f"rabit_device={device}", "rabit_dataplane=torch",
                   "rabit_telemetry=1"], max_attempts=0,
               timeout=RESUME_TIMEOUT_S, quiet=True, stats=stats, env=env,
               elastic=elastic, tick=tick, chaos=FAILOVER_CHAOS[mode])
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    docs = {t: json.loads((out / f"r{t}.json").read_text())
            for t in range(p)}
    return docs, stats, wal_dir, clocks


def _failover_checks(p: int, mode: str, base: dict, docs: dict,
                     stats: dict, wal_dir: Path, clocks: dict,
                     elastic: bool, device: str = "cuda") -> dict:
    """Phase 19's verdicts on one run against its uninterrupted twin, and
    its numbers: the failover as the tracker measured it, the outage as
    the workers saw it through the front proxy, the deposed leader's
    acked seq and lag, the promotion's replay, epoch 2's formation."""
    from rabit_tpu_torch.tracker.wal import WriteAheadLog
    fo = stats["failover"]
    if not (fo["standby"] and fo["promoted"]) or fo["failovers"] != 1 or \
            fo["acked_seq"] <= 0 or stats["tracker_restarts"] != 0 or \
            stats["total_attempts"] != 0 or stats["readmissions"] != 0 or \
            stats["chaos"]["events"] < 1 or \
            fo["fenced"] != (1 if mode == "partition" else 0):
        raise AssertionError(f"failover ({mode}): {fo}, restarts "
                             f"{stats['tracker_restarts']}, attempts "
                             f"{stats['total_attempts']}, re-admissions "
                             f"{stats['readmissions']}, chaos "
                             f"{stats['chaos']}")
    member = stats["membership"]
    want_evicted = [docs[1]["rounds"][0]["rank"]] if elastic else []
    if member["evicted"] != want_evicted or \
            member["epoch"] != (2 if elastic else 1):
        raise AssertionError(f"failover ({mode}): membership {member}")
    launches, cards = _stream_checks(p, base, docs, elastic, device)
    # the promoted tracker's journal: the replicated formation, the
    # promotion, then every shutdown, which the native core's finalize
    # sends to the address it was launched with: the retargeted proxy
    kinds = [k for k, _ in WriteAheadLog(str(wal_dir / "standby")).replay()]
    after = kinds[kinds.index("promoted"):] if "promoted" in kinds else []
    downs = p - 1 if elastic else p
    if not {"assign", "lease", "epoch"} <= set(kinds) or \
            kinds.count("promoted") != 1 or after.count("down") != downs:
        raise AssertionError(f"failover ({mode}): standby journal {kinds}")
    if elastic and "evict" not in after:
        raise AssertionError(f"failover ({mode}): the eviction was not "
                             f"journaled by the promoted tracker: {kinds}")
    leader = [k for k, _ in WriteAheadLog(str(wal_dir)).replay()]
    if "down" in leader or "promoted" in leader:
        raise AssertionError(f"failover ({mode}): the deposed leader "
                             f"journaled {leader}")
    epoch2 = [round(s["dur"], 4) for d in docs.values()
              for s in d["world_reform"] if s["epoch"] == 2]
    return {"launches": launches, "cards": cards,
            "failover_ms": round(fo["failover_ms"], 3),
            "outage_s": {t: [round(o["s"], 4) for o in d["outages"]]
                         for t, d in docs.items()},
            "acked_seq": fo["acked_seq"], "leader_repl": fo["leader_repl"],
            "resyncs": fo["resyncs"],
            "replay_ms": round(stats["tracker_wal"]["replay_ms"], 3),
            "replayed": stats["tracker_wal"]["replayed"],
            "window_s": [round(clocks.get(k, -1.0), 3)
                         for k in ("opened", "closed")],
            "epoch2_formation_s": epoch2,
            "chaos": stats["chaos"],
            "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
            "pids": [d["pid"] for d in docs.values()]}


def _failover_line(tag: str, r: dict, power: str) -> None:
    phase("failover", f"{tag} the failover as the tracker measured it "
          f"{r['failover_ms']} ms; the outage as the workers saw it through "
          f"the front proxy {r['outage_s']} s (window {r['window_s']} s on "
          f"the proxy's clock); the deposed leader's replication "
          f"{r['leader_repl']} (standby acked {r['acked_seq']}, "
          f"{r['resyncs']} resyncs); the promotion's replay "
          f"{r['replayed']} records in {r['replay_ms']} ms; epoch 2's "
          f"formation s {r['epoch2_formation_s'] or 'none'} [{power}]")


def _proxy_byte_exact() -> dict:
    """The chaos proxy with an empty schedule forwards 8 MiB each way
    byte for byte, through an echo server on this machine."""
    import socket
    import threading
    from rabit_tpu_torch.chaos import ChaosProxy, Schedule
    payload = np.random.default_rng(19).integers(
        0, 256, 8 << 20, dtype=np.uint8).tobytes()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def echo():
        conn, _ = srv.accept()
        with conn:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                conn.sendall(data)

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    got = bytearray()
    try:
        with ChaosProxy(*srv.getsockname(), Schedule()) as proxy:
            with socket.create_connection((proxy.host, proxy.port),
                                          timeout=60) as c:
                sender = threading.Thread(
                    target=lambda: (c.sendall(payload),
                                    c.shutdown(socket.SHUT_WR)))
                sender.start()
                while True:
                    chunk = c.recv(1 << 16)
                    if not chunk:
                        break
                    got += chunk
                sender.join(timeout=60)
            deadline = time.monotonic() + 10
            while proxy.bytes_forwarded < 2 * len(payload) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            fwd, events = proxy.bytes_forwarded, list(proxy.events)
    finally:
        srv.close()
        t.join(timeout=10)
    if bytes(got) != payload or fwd != 2 * len(payload) or events:
        raise AssertionError(f"the chaos proxy: {len(got)} of "
                             f"{len(payload)} bytes back, equal "
                             f"{bytes(got) == payload}, {fwd} forwarded, "
                             f"events {events}")
    return {"bytes": len(payload), "forwarded": fwd}


def phase_failover(power: str, bases: dict | None = None) -> dict:
    """The hot standby and the chaos front proxy (see the module's phase
    19). ``bases``: phase 18's uninterrupted runs by part, the reference
    at the same world, seed and rounds; run here when absent (the phase
    alone)."""
    import tempfile
    bases = dict(bases or {})
    r = subprocess.run([sys.executable, "-m",
                        "rabit_tpu_torch.tracker.standby", "--smoke"],
                       env=_stall_env(), capture_output=True, text=True,
                       timeout=RESUME_TIMEOUT_S)
    if r.returncode != 0 or "failover smoke ok" not in r.stdout:
        raise AssertionError(f"standby --smoke: {r.stdout}{r.stderr}")
    exact = _proxy_byte_exact()
    phase("failover", f"standby --smoke ok; the chaos proxy forwarded "
          f"{exact['bytes']} bytes each way byte for byte "
          f"({exact['forwarded']} in all)")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if bases.get("a") is None:
            bases["a"] = _resume_run(1, tmp, "base", False, False)[0]
        for mode in ("kill", "partition"):
            docs, stats, wal_dir, clocks = _failover_run(1, tmp, mode, mode,
                                                         False)
            out[mode] = _failover_checks(1, mode, bases["a"], docs, stats,
                                         wal_dir, clocks, False)
    for mode in ("kill", "partition"):
        r = out[mode]
        what = (f"tracker_kill (delay_ms {FAILOVER_KILL_DELAY_MS}) once "
                f"every rank had logged round {RESUME_KILL_AFTER}"
                if mode == "kill" else
                f"tracker_partition over rounds {FAILOVER_PARTITION[0]}-"
                f"{FAILOVER_PARTITION[1]}")
        phase("failover", f"(a) {mode}: world 1 on card 0 under the "
              f"launcher with a WAL, RABIT_TRACKER_STANDBY=1, "
              f"RABIT_LEASE_MS={FAILOVER_LEASE_MS} and the chaos front "
              f"proxy, {what}: {RESUME_ROUNDS} rounds bit for bit the "
              f"uninterrupted run's, 1 failover, 0 restarts, 0 respawns, "
              f"epoch 1, "
              + ("the deposed leader fenced, " if mode == "partition"
                 else "")
              + f"the kernel launched once a round ({r['launches']}), "
              f"finalize through the retargeted proxy (the standby's "
              f"journal {r['kinds']}, chaos {r['chaos']})")
        _failover_line(f"(a) {mode}:", r, power)
    count = torch.cuda.device_count()
    if count < 2:
        phase("failover", f"(b) did not run: {count} card(s); the shrink "
              f"through the promoted standby needs two or more")
        out["b"] = None
        out["launches"] = {"a": [out["kill"]["launches"],
                                 out["partition"]["launches"]], "b": None}
        return _failover_doc(out)
    p = min(4, count)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if bases.get("b") is None:
            bases["b"] = _resume_run(p, tmp, "base", False, True)[0]
        docs, stats, wal_dir, clocks = _failover_run(p, tmp, "kill_b",
                                                     "kill", True)
        b = _failover_checks(p, "kill", bases["b"], docs, stats, wal_dir,
                             clocks, True)
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()
    held = [int(x) for x in smi if x.isdigit() and int(x) in b["pids"]]
    if held:
        raise AssertionError(f"failover: workers {held} still hold a card")
    out["b"] = b
    out["launches"] = {"a": [out["kill"]["launches"],
                             out["partition"]["launches"]],
                       "b": b["launches"]}
    phase("failover", f"(b) world {p} elastic, tracker_kill after round "
          f"{RESUME_KILL_AFTER}, then task 1 evicted itself at round "
          f"{RESUME_SHRINK_AT} and the survivors resize('recover') through "
          f"the promoted standby, which hosted epoch 2's store: every round "
          f"bit for bit the uninterrupted run's (the shrunk world's exact), "
          f"1 failover, 0 restarts, 0 respawns, the one scripted eviction, "
          f"cards {b['cards']} kept, the kernel launched once a round "
          f"({b['launches']}), the standby's journal {b['kinds']}, no "
          f"worker left on a card (compute apps {smi})")
    _failover_line(f"(b) world {p}:", b, power)
    return _failover_doc(out)


def _failover_doc(out: dict) -> dict:
    """Phase 19's summary for the JSON line: the pids dropped."""
    return {k: ({kk: vv for kk, vv in v.items() if kk != "pids"}
                if isinstance(v, dict) and "pids" in v else v)
            for k, v in out.items()}


def card_power() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    power = card_power()
    phase("device", f"{torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_tile(dev)
    max_err = {"histogram": phase_kernel(dev),
               "mask_only": phase_mask_kernel(dev)}
    phase_device_ops(dev)
    max_err.update(phase_flash_kernel(dev))

    reset_launches()
    phase_main_path(dev)
    phase_rounds(dev)
    hist_launches = read_launches()
    if hist_launches["histogram"] < 1:
        raise AssertionError("kernel histogram was not launched on the "
                             "histogram path")
    phase("main path", f"kernel launches on the histogram path: "
          f"{hist_launches}")
    tf_run = phase_transformer(dev)
    sweep = phase_sweep(dev)
    launches = {"histogram": hist_launches["histogram"],
                "flash_block": tf_run["launches"]["flash_block"],
                "flash_block_bwd": tf_run["launches"]["flash_block_bwd"],
                "mask_only": sweep["launches"]["mask_only"]}
    phase("main path", f"kernel launches, each on its own path: {launches}")
    phase_bench(dev)
    proof = phase_proof(dev)

    timing = {"histogram": phase_timing(dev, power),
              "mask_only": phase_mask_timing(dev, power, sweep["table"])}
    timing.update(phase_flash_timing(dev, power))
    phase("timing", f"training step (flagship, batch 8 x seq 512): "
          f"{tf_run['step_ms']:.3f} ms median of steps 2-"
          f"{FLAGSHIP_STEPS} on CUDA events [{power}]")
    phase_collectives(dev)
    phase_robust(dev, power)
    bucket = phase_bucket(dev, power)
    par = phase_parallel(power)
    tel = phase_telemetry(dev, power)
    skew_doc = phase_skew(dev, power)
    phase_watchdog(dev, power)
    elastic = phase_elastic(power)
    resume, bases = phase_resume(power)
    failover = phase_failover(power, bases)
    kernels = []
    for name in ("histogram", "flash_block", "flash_block_bwd", "mask_only"):
        head = timing[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "by_shape": timing[name]})
    for k in kernels:
        head = k["by_shape"][0]
        k["shape"] = head.get("shape", [head.get("rows"), head.get("nbins")])
    # phase 17 (b)'s resize run: a launch a round on every member; null
    # where (b) did not run (fewer than three cards)
    kernels[0]["elastic_launches"] = elastic["launches"]
    # phase 18's killed runs: a launch a round on every member; (b) null
    # where it did not run (one card)
    kernels[0]["resume_launches"] = resume["launches"]
    # phase 19's runs: (a)'s kill and partition, (b)'s kill and shrink,
    # null where (b) did not run (one card)
    kernels[0]["failover_launches"] = failover["launches"]
    kernels[3]["slope_ms"] = timing["mask_only"][0]["slope_ms"]
    kernels[2]["library_bwd_ms"] = timing["flash_block_bwd"][0][
        "library_bwd_ms"]
    for k in kernels[1:3]:   # the chain block's row: the proof's chains
        k["by_shape"][1]["launches"] = proof["launches"][k["name"]]
        # phase 12's paths: each bucketed run, counted from 0
        k["bucket_launches"] = {s: r["launches"][k["name"]]
                                for s, r in bucket.items()}
        # phase 13's ring calls, summed over its shapes and ranks
        k["parallel_launches"] = par["launches"][k["name"]]
    print(json.dumps({"train_step": {
        "step_ms": tf_run["step_ms"], "first_step_ms": tf_run["first_step_ms"],
        "losses": tf_run["losses"], "profile": tf_run["profile"]},
        "bucket_steps": {s: {k: r[k] for k in ("median_ms", "ms", "losses")}
                         for s, r in bucket.items()},
        "parallel": par, "telemetry": tel, "skew": skew_doc,
        "elastic": elastic, "resume": resume, "failover": failover}),
        flush=True)
    print(power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
