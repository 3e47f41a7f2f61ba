"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only parallel,autoscale,autoscale

(``--only``: the builds, then the named phases alone, in that order, each
line printed as it ends; no kernels line.)

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi) and device name;
2. build the hand-written CUDA kernels (ops/csrc/ell_kernels.cu) and
   report each instance's registers, spills and shared memory (ptxas);
3. each kernel at the Criteo slice's shapes (B=2048, K=39, E=16, D=2^20)
   against its plain PyTorch version on the card, on inputs with
   duplicate, padding, wrapped-negative and out-of-range indices and
   f32 and f16 values, and again at the edge shapes the kernels' designs
   branch on (K in {1, 33, 39, 64}, E in {1, 5, 8, 16}, E = 33 and 64 in
   chunks of the gradient scatters, B a multiple of no block's rows nor
   B*K of the scatters' tiles), on the scatters' own edge inputs (every
   row naming the same K rows; every entry naming its own row, so a
   tile holds a whole tile of runs) and on a dense gradient that is not
   16-byte aligned; the scatters' determinism gate: K2 and K4 launched
   20 times each on three batches (Criteo rows, every entry naming one
   row, NaN values beside out-of-range indices), every output
   bit-identical to the first launch's, and again from two host threads
   on one stream; then the kernel, the plain version and a one-call
   PyTorch yardstick timed with CUDA events on Criteo-shaped inputs,
   beside the time of an empty launch (``floor_us``) and, for the
   scatters, of the zero-fill of their dense gradient (``zero_fill_us``)
   and of the yardstick under ``torch.use_deterministic_algorithms``
   (``library_deterministic_ms``: a scatter whose bits are fixed too);
4. the native producers on the host alone (no card): Criteo rowrec → ELL
   (f16 and f32), Criteo sparse libsvm and libfm → ELL, HIGGS libsvm and
   csv → dense, each held bit for bit against its plain version
   (``plain_batches``: the numpy rowrec decoder, or the text parser's
   Python grammar → ``FixedShapeBatcher``; neither runs the native parse
   core) on one block of rows, then timed in rows/s over a file of 2^18
   rows with one producer and with the thread count ``picked_threads``
   gives, and the plain version timed over the block, beside the host's
   CPU counts;
5. the slices, each producer → ``StagingPipeline(device="cuda")`` → SGD
   steps, after a warm-up pass once with one producer thread and once
   with ``picked_threads`` sub-shards (the main run: the kernels' launch counts read around it,
   finite falling loss, row-weighted, and the first staged batch equal
   to the host bytes): a synthetic
   Criteo-shaped rowrec shard (32 batches of rows, written 4 times over) → ``ell_batches`` → FactorizationMachine
   (f32 values) and LogisticRegression (f16 values); the same rows as
   sparse libsvm → ``ell_batches(format="libsvm")`` → FactorizationMachine;
   on these ELL paths the first step's loss and gradients are held
   against the plain versions on the card. Then HIGGS csv →
   ``dense_batches`` → LogisticRegression on ``x`` at B = 32768, whose
   first step is held against the same step on the CPU;
6. the indexed, shuffled path at the Criteo width: 2^18 rows written as
   rowrec with its index (``FileStream``, ``write_rowrec(index_stream=)``);
   ``ell_batches`` over the plain file and over ``?index=…&shuffle=``
   record, batch and window, each bit for bit against its plain version
   (one seek per record, the numpy decode and ``FixedShapeBatcher``) with
   one thread and with ``picked_threads`` sub-shards, then timed in
   rows/s on the host beside its ``io_stats`` (``gather_fallback_batches``
   must be 0); then FM SGD on the card over ``shuffle=batch``: a timed
   pass, an uninterrupted pass, and a pass that ``save_async``s params
   and position every 4 steps and stops at step 64, restored by a fresh
   ``Checkpointer`` into a new pipeline with ``skip_records``, whose
   batches must equal steps 65-128 of the uninterrupted pass, with the
   restored params equal to the saved ones, the loss falling and K1-K4
   launched per step as on the sequential FM path;
7. the compressed and multi-file inputs at the Criteo width: the shuffle
   phase's 2^18 rows written again through the port's
   ``IndexedRecordIOWriter`` as zlib blocks of 1 MiB (bench.py's
   ``rec_zlib``) and as gzip blocks of the writer's default 256 KiB; for
   each, ``ell_batches`` sequential and over ``shuffle=record|batch|
   window`` with one thread and ``picked_threads`` sub-shards, bit for
   bit against the uncompressed file's batches (sequential sub-shards
   against the plain version on the same compressed file: each block
   decoded with ``decode_block``, frames walked in Python,
   ``FixedShapeBatcher``), the indexed modes also at 3 parts; rows/s on
   the host beside the uncompressed file, the compression ratio and the
   seconds to decode every block; a second pass of ``shuffle=window``
   served from the decoded-block cache; FM SGD on the card over the zlib
   file with ``shuffle=batch`` (K1-K4 once a step, the loss falling, the
   first step held against the plain versions) beside the uncompressed
   pass; and the same rows as libsvm in one file, in 4 files read as a
   directory and as a regex, and through a ``#cachefile`` for two
   epochs (the second replayed from the cache), each into FM SGD, with
   batches equal to the one file's;
8. the example ports (``dmlc_core_tpu_torch.examples``) on the card at
   their own sizes: HIGGS and Criteo for two epochs each, and the online
   FM in demo mode (its generator on a thread, the FM following the live
   stream to EOS);
9. multi-worker training through the port's launcher (``python -m
   dmlc_core_tpu_torch.tracker.submit --cluster local``) and collective,
   each worker a process of its own on the card: 2 workers at the Criteo
   width take 16 steps each over their part of 2^17 indexed rows
   (``shuffle=batch``, 2 parts), allreducing ``[grads, 1]`` (71 MB) a step,
   once over the tree and once over the ring; both ranks' params must be
   bit-identical, every rank must launch K1-K4 once a step, and the params
   must equal a one-process simulation on the card (both parts'
   gradients with the same kernels, folded in ``reference_allreduce``'s
   order) within ``PARAM_REL``; each step is split into gradient, D2H,
   allreduce and H2D + update. Then the Criteo example's chaos drill (3
   workers over the tree, twice clean and once with rank 2 SIGKILLed at
   the start of round 4, relaunched and bootstrapped from a peer; ranks
   bit-identical in every run, kill against clean within ``PARAM_REL``
   beside the clean-against-clean gap) and the HIGGS example with 2
   workers;
10. telemetry at the Criteo width (the FM path of phase 5 with its
   native producer, pinned staging and K1-K4): (a) 32 steps under
   ``utils.profiler.trace`` (CPU and CUDA activity), whose Chrome trace
   must hold each kernel's device events and the ``dmlc:*`` spans (each
   kernel's in-step µs from the trace beside phase 3's time); (b) the
   128-step pass with the flight recorder off, on, and on with span
   histograms, three times in turns: the registry's ``staging.rows``
   equal to the rows staged, the stage histograms one sample a batch, no
   event recorded while off, the traced pass's ``stall_report``, the
   transfer thread's two stages timed alone beside their in-pipeline
   times; (c) 2 workers at full width over the ring for 8 steps under
   ``submit --trace-dir`` with ``DMLC_METRICS_PORT`` and
   ``DMLC_METRICS_REPORT``, a heartbeat every 2 steps, rank 0 reading
   ``/metrics.json?window=5`` and ``tools top --once --json`` mid-run:
   the report's per-rank collective counters equal to each rank's
   ``io_stats()``, ``tools trace merge`` holding spans of the tracker and
   both workers with flow arrows between the ranks, ``tools info``
   naming the card;
11. tracker-leased micro-shards at the Criteo width (2^16 indexed rows,
   ``shuffle=batch``, ``&dynamic_shards=1``, 4
   micro-shards a worker; native producer, pinned staging, K1-K4): (a)
   one worker and a port ``RabitTracker`` in this process, each leased
   micro-shard's batches bit for bit the static part ``(i, 4)``'s, no
   gather fallback, the ledger holding each shard once, K1-K4 once a
   step, the ``dmlc:shard_lease_wait`` spans summed from the flight
   recorder; in turns with the same pass over a static drain (static,
   leased, static, leased), timed; (b) 2 worker processes through the
   launcher, allreducing ``[grads, 1]`` each step, once over their
   static parts and once with ``--shard-oversplit 4``: ranks
   bit-identical and within ``PARAM_REL`` of a one-process replay of the
   batches each rank trained, the union of the ranks' batch digests the
   static ``(i, 8)`` parts' once each, the tracker's report ``completed
   == granted == 8`` with no duplicate, the loss falling; (c) (b) with
   ``--tracker-journal`` and the tracker process SIGKILLed once its WAL
   holds 3 or more ``shard_done`` records, the ranks paused after 2
   recorded micro-shards: at that shard boundary with no lease open
   (every batch trained once as in (b), no lease expired), and again
   holding the next lease (the replay expires one or more leases; each
   re-served micro-shard is drained again in full and its second done
   answers duplicate, and the count of batches trained twice is
   printed); the ranks ride the outage, the supervisor relaunches the
   tracker once from the journal and the report holds a ``recovery``
   section; (d) the Criteo example with ``DMLC_DYNAMIC_SHARDS=1``, 2
   workers, 2 epochs, each epoch's micro-shards done once;
12. dsserve at the Criteo width over the shuffle phase's 2^18 indexed
   rows (``shuffle=batch``), the servers separate ``python -m
   dmlc_core_tpu_torch.tools dsserve serve`` processes: (a) one server in
   static mode, FM SGD on the card for 128 steps from
   ``dsserve://127.0.0.1:<port>/<file>?index=...`` with every received
   slot adopted by the staging pipeline (the host→device copy straight
   from the pooled, page-locked receive buffer), each batch's digest
   equal to the local ``ell_batches`` batch's and the params within
   ``PARAM_REL`` of a local pass over the same batches; (b) four arms,
   TCP or shared memory (``DMLC_DSSERVE_SHM``) by adoption on or off
   (off: the client behind a wrapper that declares no ``adopt_slots``),
   each twice in turns beside a local-file pass, 128 steps a pass:
   staged rows/s, wait share, step ms, the
   ``dispatch_pack`` and ``dispatch_put`` seconds, the client's receive
   wait, the adopted slots (all of them with adoption on, none off),
   the copies (none with adoption on), the slots shared memory carried
   (some on the shm arms) and what was page-locked; (c) ``submit
   --dsserve 2`` with one trainer on the card over the file cut into 8
   leased micro-shards, the tier's first server SIGKILLed once the
   trainer took 8 steps: every micro-shard committed once, each equal
   to the static part, K1-K4 once a step, the params within
   ``PARAM_REL`` of a one-process replay of the batches trained;
13. ``fault://`` at the Criteo width over the shuffle phase's 2^18
   indexed rows: (a) FM SGD for 128 steps over ``shuffle=batch`` through
   seeded chaos (open 5xx, mid-read resets, short reads; the retry
   backoff at test speed), each batch's digest equal to the same pass
   over the clean file, ``io_stats()`` showing faults fired and retries
   healed, the params within ``PARAM_REL`` of the clean pass; (b) window
   loads (``shuffle=window``, window 1024, one span a record) behind
   ``fault://`` latency, serial (``DMLC_FETCH_THREADS=1``) and with the
   span fetcher's default threads, twice in turns, FM over part 0 of 16
   (8 steps) a pass:
   staged rows/s, wait share, step ms, the ``dmlc:fetch_wait`` seconds,
   the spans fetched and the fetch concurrency peak, each pass's batches
   equal across the arms and to the clean file's;
14. the autoscale loop (``bench.py``'s autoscale_phase_shift with the
   card's FM as the trainer): one trainer launched by the port's
   ``submit`` drains the same rows through ``dsserve://``
   (``shuffle=record``, 6 micro-shards an epoch, each step paced to
   10 ms), 3 cheap epochs over the plain file then 4 expensive ones over
   its ``fault://`` latency wrap; once with ``--dsserve 2`` and once
   with ``--autoscale 1:2``. Gates: the autoscaled run scales up at
   least once, first in the expensive phase (the tracker's
   ``dmlc:autoscale_decision`` instants), with at most 2 direction
   changes, and ``tools autoscale replay`` of its report scales up first
   in the expensive phase too; in both runs every (epoch, micro-shard)
   is trained once with the local producer's batches, each batch's
   bytes on the device (hashed from the staged tensor after its
   host-to-device copy) those it was received as, no duplicate, K1-K4
   once a step, the params within ``PARAM_REL`` of a one-process
   replay. It prints both runs' expensive-phase makespans and their
   ratio, the recv wait share per phase and the controller's spend;
15. the remote filesystems and the host block cache at the Criteo width
   over the shuffle phase's 2^18 indexed rows: (a) a fake S3 of this
   script's own (``FAKE_S3``: ranged GET, HEAD with an ETag, PUT,
   multipart, copy, ListObjectsV2, DELETE; a process of its own on the
   loopback, not a real bucket) takes the file and its index through the
   port's multipart upload; FM SGD for 128 steps over ``s3://`` and over
   ``fault://inner=s3`` chaos (FAULT_CHAOS), each batch's digest equal
   to the local file's pass and the params within ``PARAM_REL`` of it,
   ``reopens`` > 0 and, under chaos, retries > 0; a pass saving to
   ``Checkpointer("s3://bkt/ckpt")`` every 16 steps stops at step 64 and
   a fresh Checkpointer's restore resumes it with ``skip_records``, its
   batches those of the uninterrupted ``s3://`` pass; (b) decode once a
   host over the rows' zlib copy (1 MiB blocks): a ``tools cached serve``
   daemon, a publisher, then a second reader and a control
   (``DMLC_BLOCK_CACHE=off``) in turns, twice each, each an FM trainer of
   its own process on the card: the second reader decodes no block at a
   daemon hit rate of 1.0, the batches are equal across the three and
   the params within ``PARAM_REL``; then ``submit --block-cache`` with
   two colocated trainers (rank 1 starting at rank 0's step 8) decodes
   fewer than twice the file's blocks and leaves no socket directory;
16. live streams at the Criteo width: (a) a writer process (the port's
   ``StreamWriter``: zlib, a commit every 8192 records, rotation at
   STREAM_ROTATE_BYTES) appends 2^17 Criteo rows paced at about 100 k
   rows/s and closes with EOS, while this process trains the FM over
   ``ell_batches(dir/manifest.json?shuffle=window&window=16384&seed=7)``:
   a drain of the sealed stream afterwards gives the live pass's batch
   digests in the same order and its params within ``PARAM_REL``; the
   follower saw 2 or more rotations and waited on the writer at least
   once; the lag's p99 (the ``stream.lag_seconds`` gauge a step) is under
   2 s (``bench.py``'s stream_online bound); (b) two FM trainers under
   ``submit`` follow another such stream with ``&dynamic_shards=1`` while
   its writer writes: each generation's micro-shards completed once with
   no duplicate, and the multiset of the records the two ranks trained
   equal to the sealed drain's, generation by generation;
17. point lookups over the shuffle phase's rows in zlib blocks of 1 MiB
   with their index: ``tools serve --port-file --metrics-port --warm 64``
   as a process; ``bench.py``'s point_lookup_zipf key sequence (Zipf 1.1
   over a permuted key space, 360 keys in batches of 60, negatives at
   ``keys[7::61]``) through a ``LookupClient``, an in-process
   ``RecordLookup`` and the naive per-key read, one sha256 each, all
   equal, every negative None; then 300 requests of 16 keys on the warm
   server; a ``/metrics`` scrape with ``dmlc_io_lookup_request_seconds``;
   SIGTERM ending the server with rc 0 and a last JSON stats line;
   ``tools info`` with the corpus's geometry, and "growing" on a stream's
   live shard with no commit. It runs no kernel;
18. the FM over a rank mesh (``parallel/``) at the Criteo width, each job
   through the launcher with its ranks on this card, in (a)-(d) every
   rank reading the global batches of an indexed rowrec file and staging
   its own rows (``StagingPipeline(mesh=)``) into
   ``data_parallel_step``: (a) one rank
   over NCCL, mesh (1, 1), 32 steps; (b) two ranks over gloo, mesh (1, 2),
   ``v`` split into two [D, 8] blocks, 32 steps; (c) four ranks over
   gloo, mesh (2, 2), 16 steps, a sharded ``save_async`` with ``meta`` at
   step 8; (d) a (1, 2) job that restores (c)'s ``.d`` by template and
   runs to step 16. Gates: params within ``PARAM_REL`` of a one-process
   replay of the same global batches ((d): of (c)'s final params), the
   replicas bit-identical, each rank's K1-K4 once a step and one copy a
   batch on the packed-shard path; (c)'s ``.d`` the manifest and 4 shard
   files, each chunk once from its block's replica 0, the manifest last;
   a restore without a template equal to (c)'s params at step 8 bit for
   bit, ``restore_meta`` what was saved; ``python -m
   dmlc_core_tpu_torch.tools ckpt ls`` and ``ckpt show`` of that ``.d``
   giving ``Checkpointer.steps_info()`` and the global shapes ``w``
   [D], ``v`` [D, 16], ``b`` with the meta. (e) ``dp_tp_local``: (c)'s
   mesh and file, each rank reading only part ``process_shard(mesh)``
   (its data coordinate's of two) at B/2 rows a batch and staging it
   with ``local_rows=True``, 16 steps. Gates: each rank's producer
   parsed and staged only its part's rows (half the file), the ranks of
   a model line staged the same bytes, each model line's per-row digests
   read back from the staged device tensors are the file's rows once
   each, one copy a batch with no padding batch, K1-K4 once a step, the
   replicas bit-identical and the params within ``PARAM_REL`` of a
   one-process replay of the global batches (part 0's batch i, then part
   1's). It prints each job's step ms per rank and the share of the step
   its collectives took, and for (c) and (e) the rows each rank parsed
   and its producer's host seconds. Last, the port of
   ``dryrun_multichip(4)`` on the card (4 gloo ranks, its own small FM
   on a (2, 2) mesh) and its report;
19. the cluster backends: the Criteo FM at full width, 2 workers on the
   card for 4 steps over the tree, launched by ``python -m
   dmlc_core_tpu_torch.tracker.submit`` on the local cluster and then on
   ``ssh``, ``slurm`` and ``mpi`` side by side, each through a fake
   binary that runs the payload on this host (``FAKE_BINARIES``, the
   test suite's, which the CPU tests hold equal): every job ends 0, every rank launches K1-K4 once
   a step, its ranks are bit-identical and its params within
   ``PARAM_REL`` of the local job's (whether bit-identical is printed);
   the same job with one worker, twice, gives bit-identical params (the
   gradient scatters fix their order of summation); and ``submit
   --dry-run`` on sge, mesos, kubernetes, tpu-pod, yarn and yarn over
   ``DMLC_YARN_REST`` prints what the JAX package's submit prints
   (``tests/data/torch_submit_dry_runs.json``, recorded and checked on
   the CPU), apart from the AM module string;
20. the library interface at the Criteo width (``api``): a libsvm file
   of N_BATCHES batches of rows (the slice phase's generator). (a)
   ``create_parser(type="libsvm")``, threaded, read for two epochs with
   ``before_first()`` between them: epoch 2's blocks equal epoch 1's (a
   digest a block) and ``bytes_read()`` never falls within an epoch and
   ends each at the file's size; (b) its blocks through
   ``FixedShapeBatcher`` → ``StagingPipeline`` → FM SGD, beside the same
   FM over the native producer for two epochs, both from one set of
   params made on the CPU and placed by ``staging.device_put``: the
   batches byte-equal, the params bit-identical, K1-K4 launched on both;
   (c) ``create_row_block_iter`` read twice through ``before_first``
   with a ``set_log_sink`` sink: its progress lines' megabytes are the
   10 MB rule over the split's chunks (the source's bytes); (d) over the
   same rows written as indexed rowrec (``write_indexed``), a whole
   epoch of ``next_batch(B)`` equals one of ``next_batch_ex(B)`` under
   ``shuffle=batch``, and ``StagingPipeline.io_stats()`` over the native
   producer carries the split's counters and ``"staging"``. It prints
   both arms' staged rows/s and step ms and the phase's seconds;
21. the ``entry()`` forward on the card against the CPU.

The native parse core (``dmlc_core_tpu_torch/native/fastparse.cc``) is
built with g++ beside the kernels' nvcc build, and its stamped source hash
must equal the sha256 of the file. It fails if any kernel instance spills
registers. It prints a ``{"ptxas": [...]}`` (with the scatters' dynamic
shared memory), a ``{"kernels": [...]}``, a ``{"producers": {...}}``, a
``{"slice": {...}}``, a ``{"shuffle": {...}}``, a ``{"codec": {...}}``,
an ``{"examples": {...}}``, a ``{"collective": {...}}``, a
``{"telemetry": {...}}``, a ``{"shards": {...}}``, a ``{"dsserve":
{...}}``, a ``{"faults": {...}}``, an ``{"autoscale": {...}}``, a
``{"remote": {...}}``, a ``{"stream": {...}}``, a ``{"lookup":
{...}}``, a ``{"parallel": {...}}``, a ``{"backends": {...}}``, an
``{"api": {...}}`` and a ``{"phase_seconds": {...}}`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``, after
checking that it loaded no module of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shlex
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, K, E, D = 2048, 39, 16, 1 << 20
N_DENSE = 13  # Criteo: 13 dense columns in every row + 26 categorical
N_BATCHES = 32
# the Criteo slice's file holds its N_BATCHES batches this many times over,
# so each pass times 128 steps
SLICE_REPEATS = 4
# HIGGS: 28 dense features, staged 32768 rows a batch (bench.py:47)
HIGGS_D, HIGGS_B, HIGGS_BATCHES = 28, 32768, 16
# the producer phase: plain versions run one block of rows, the native
# producers are timed over a file of the block repeated to 2^18 rows
BLOCK_ROWS, PRODUCER_ROWS = 1 << 15, 1 << 18
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SRC = "dmlc_core_tpu_torch/ops/csrc/ell_kernels.cu"
# (B, K, E, D) of the edge inputs beside the slice's: K below, at and
# above a warp and the Criteo width, E scalar-lane (1, 5), the half of the
# Criteo E that each rank of a (., 2) mesh holds (8), and 16-byte-lane
# (16), E in more than one of K4's 16-column chunks with a scalar (33) and
# a float4 (64) flush, B a multiple of neither K1's 16 rows a block nor
# K3's 8, and B*K a multiple of none of K2's and K4's 256-entry tiles
KERNEL_NAMES = ("ell_matvec_fwd", "ell_matvec_bwd", "fm_pair_fwd", "fm_pair_bwd")
EDGE_SHAPES = [(1037, k, e, 1000) for k in (1, 33, 39, 64) for e in (1, 5, 8, 16)]
EDGE_SHAPES += [(1037, 39, e, 1000) for e in (33, 64)]
# the gradient scatters' own edge inputs (see scatter_inputs)
SCATTER_KINDS = ("contention", "distinct")
# forward: elementwise |kernel - plain| <= FWD_ABS + FWD_REL·scale, where
# scale is the sum of the magnitudes of the terms summed (the sums run in
# another order, and the pair term ½Σ(s² − q) cancels, so its rounding
# error scales with s², not with the result); gradients: <= GRAD_REL ·
# max|plain| (the scatters sum a row's entries in another order than the
# plain index_add_, and the partials of a row that several tiles name
# exactly, rounded once)
FWD_REL, FWD_ABS, GRAD_REL = 1e-5, 1e-6, 1e-4
# the scatters' determinism gate: launches of K2 and of K4 on each of its
# batches, every output bit-identical to the first launch's
DETERMINISM_LAUNCHES = 20
# top-level packages this script and the port must never load
FOREIGN_MODULES = ("jax", "jaxlib", "flax", "dmlc_core_tpu")

# stand-ins for ssh, srun and mpirun that run the payload on this host
# (the same scripts as the test suite's, tests/test_backend_fakes.py)
FAKE_BINARIES = {
    "ssh": """#!/bin/sh
# ssh stand-in: skip options (-o X, -p N), then host, then the command
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-p) shift 2 ;;
    -*) shift ;;
    *) break ;;
  esac
done
host="$1"; shift
exec sh -c "$@"
""",
    "srun": """#!/usr/bin/env python3
import os, subprocess, sys

args = sys.argv[1:]
ntasks = 1
cmd = []
for i, a in enumerate(args):
    if a.startswith("--ntasks="):
        ntasks = int(a.split("=", 1)[1])
    elif a.startswith("--nodes="):
        pass
    elif a.startswith("--export="):
        spec = a.split("=", 1)[1]
        for kv in spec.split(",")[1:]:  # first token is ALL
            k, v = kv.split("=", 1)
            os.environ[k] = v
    else:
        cmd = args[i:]
        break
procs = []
for rank in range(ntasks):
    env = dict(os.environ)
    env["SLURM_PROCID"] = str(rank)
    procs.append(subprocess.Popen(cmd, env=env))
codes = [p.wait() for p in procs]  # wait for ALL tasks, like real srun
sys.exit(next((c for c in codes if c), 0))
""",
    "mpirun": """#!/usr/bin/env python3
# mpirun stand-in (openmpi arg surface): `mpirun -n N -x K=V ... cmd`
# spawns N local copies with the -x env applied, waits for all.
import os, subprocess, sys

args = sys.argv[1:]
n = 1
env = dict(os.environ)
cmd = []
i = 0
while i < len(args):
    a = args[i]
    if a == "--version":
        print("mpirun (Open MPI) 4.1-fake"); sys.exit(0)
    if a == "-n":
        n = int(args[i + 1]); i += 2
    elif a == "-x":
        k, v = args[i + 1].split("=", 1); env[k] = v; i += 2
    elif a == "--hostfile":
        i += 2
    else:
        cmd = args[i:]; break
procs = [subprocess.Popen(cmd, env=env) for _ in range(n)]
codes = [p.wait() for p in procs]
sys.exit(next((c for c in codes if c), 0))
""",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def close_enough(got, want, kind: str, what: str, scale=None) -> float:
    """Max |got - want| over finite entries, after requiring NaN at the
    same places; fails the run beyond the stated tolerance (``scale``
    defaults to |want|)."""
    got, want = got.float(), want.float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        fail(f"{what}: NaN pattern differs ({int(nan_g.sum())} vs {int(nan_w.sum())})")
    fin = ~nan_w
    if not fin.any():
        return 0.0
    err = (got[fin] - want[fin]).abs()
    if kind == "fwd":
        ref = want.abs() if scale is None else scale.float()
        bad = err > FWD_ABS + FWD_REL * ref[fin]
    else:
        bad = err > GRAD_REL * float(want[fin].abs().max())
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} entries beyond tolerance (max err {float(err.max())})")
    return float(err.max())


def criteo_rows(rng, n: int, num_features: int):
    """Criteo-shaped rows: 13 dense columns (ids 0-12, values in [0,1))
    and 26 categorical ids with value 1; labels from a planted model."""
    idx = np.empty((n, K), dtype=np.int64)
    idx[:, :N_DENSE] = np.arange(N_DENSE)
    idx[:, N_DENSE:] = rng.integers(N_DENSE, num_features, (n, K - N_DENSE))
    val = np.ones((n, K), dtype=np.float32)
    val[:, :N_DENSE] = rng.uniform(0, 1, (n, N_DENSE))
    return idx, val


def edge_inputs(rng, dev, f16: bool):
    """ELL inputs at the slice shape with the cases the kernels must get
    right: duplicates in a row, padding slots and rows (index 0, value
    0), wrapped negatives in [-D, -1], and out-of-range indices (>= D and
    < -D) whose rows read NaN."""
    idx, val = criteo_rows(rng, B, D)
    val[:, N_DENSE:] = rng.normal(size=(B, K - N_DENSE))
    idx[16:48, 20:30] = idx[16:48, 20:21]           # duplicates
    idx[48:80, 30:] = 0                              # padding slots
    val[48:80, 30:] = 0
    idx[B - 64:] = 0                                  # padding rows
    val[B - 64:] = 0
    neg = rng.integers(1, D + 1, (32, 8))
    idx[80:112, 13:21] = -neg                         # wrapped negatives
    # out-of-range rows use no hot (dense) columns, so their NaN stays
    # in their own rows' gradient entries
    idx[:8, :N_DENSE] = rng.integers(N_DENSE, D, (8, N_DENSE))
    idx[:4, 5] = D + rng.integers(0, 1000, 4)
    idx[4:8, 6] = -D - 1 - rng.integers(0, 1000, 4)
    v_dtype = torch.float16 if f16 else torch.float32
    return (
        torch.from_numpy(idx.astype(np.int32)).to(dev),
        torch.from_numpy(val).to(dev, v_dtype),
    )


def edge_shape_inputs(rng, dev, f16: bool, b: int, k: int, d: int):
    """ELL inputs at an edge shape: indices over [-d, d) (half of them
    wrapped negatives), a row of duplicates, padding slots and rows, and
    one index above and one below the range in rows 3 and 4."""
    idx = rng.integers(-d, d, (b, k))
    val = rng.normal(size=(b, k)).astype(np.float32)
    idx[1] = idx[1, 0]                                 # duplicates
    idx[2, k // 2:] = 0                                # padding slots
    val[2, k // 2:] = 0
    idx[b - 3:] = 0                                    # padding rows
    val[b - 3:] = 0
    idx[3, 0] = d + 5                                  # out of range
    idx[4, k - 1] = -d - 5
    return (
        torch.from_numpy(idx.astype(np.int32)).to(dev),
        torch.from_numpy(val).to(dev, torch.float16 if f16 else torch.float32),
    )


def scatter_inputs(rng, dev, f16: bool, kind: str):
    """ELL inputs at the slice's B and K for the gradient scatters' tile
    tables: ``contention``, every row naming the same K rows (each tile
    names each row ~6.5 times); ``distinct``, every entry naming its own
    row of D = B*K (each tile's table holds a whole tile of keys).
    Returns (idx, val, D)."""
    if kind == "contention":
        d = 1000
        idx = np.broadcast_to(rng.integers(-d, d, K), (B, K))
    else:
        d = B * K
        idx = rng.permutation(d).reshape(B, K)
    val = rng.normal(size=(B, K)).astype(np.float32)
    return (
        torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(dev),
        torch.from_numpy(val).to(dev, torch.float16 if f16 else torch.float32),
        d,
    )


def shifted(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def check_unaligned_scatters(idx, val, v, s, g, err: dict) -> None:
    """K2 and K4 into zeroed dense gradients that are not 16-byte aligned
    (the wrappers' own are), against the plain versions."""
    from dmlc_core_tpu_torch.ops import fm as opfm, sparse as ops

    d, e = v.shape
    gw = shifted(torch.zeros(d, device=v.device))
    gv = shifted(torch.zeros(d, e, device=v.device))
    if not (gw.data_ptr() % 16 and gv.data_ptr() % 16):
        fail("the shifted dense gradients are 16-byte aligned")
    ops.ell_matvec_bwd_into(idx, val, g, gw)
    opfm.fm_pair_bwd_into(idx, val, v, s, g, gv)
    err["ell_matvec_bwd"] = max(err["ell_matvec_bwd"], close_enough(
        gw, ops.ell_matvec_bwd_plain(idx, val, g, d), "grad", "K2 unaligned gw"))
    err["fm_pair_bwd"] = max(err["fm_pair_bwd"], close_enough(
        gv, opfm.fm_pair_bwd_plain(idx, val, v, s, g), "grad", "K4 unaligned gv"))


def check_kernels(idx, val, w, v, g, tag: str, err: dict) -> None:
    """K1-K4 against their plain versions on one input; the largest
    errors are kept in ``err``."""
    from dmlc_core_tpu_torch.ops import fm as opfm, sparse as ops

    d = w.shape[0]
    # magnitudes of the summed terms (NaN in out-of-range rows, whose
    # entries are compared by their NaN pattern alone)
    scale_k1 = ops.ell_matvec_fwd_plain(idx, val.abs(), w.abs())
    scale_s = opfm.fm_pair_fwd_plain(idx, val.abs(), v.abs())[1]
    err["ell_matvec_fwd"] = max(err["ell_matvec_fwd"], close_enough(
        ops.ell_matvec_fwd_kernel(idx, val, w),
        ops.ell_matvec_fwd_plain(idx, val, w), "fwd", f"K1 {tag}", scale_k1))
    err["ell_matvec_bwd"] = max(err["ell_matvec_bwd"], close_enough(
        ops.ell_matvec_bwd_kernel(idx, val, g, d),
        ops.ell_matvec_bwd_plain(idx, val, g, d), "grad", f"K2 {tag}"))
    pk, sk = opfm.fm_pair_fwd_kernel(idx, val, v)
    pp, sp = opfm.fm_pair_fwd_plain(idx, val, v)
    err["fm_pair_fwd"] = max(err["fm_pair_fwd"],
                             close_enough(pk, pp, "fwd", f"K3 pair {tag}",
                                          (scale_s ** 2).sum(-1)),
                             close_enough(sk, sp, "fwd", f"K3 s {tag}", scale_s))
    err["fm_pair_bwd"] = max(err["fm_pair_bwd"], close_enough(
        opfm.fm_pair_bwd_kernel(idx, val, v, sp, g),
        opfm.fm_pair_bwd_plain(idx, val, v, sp, g), "grad", f"K4 {tag}"))


def time_ms(fn, flush, n: int = 30) -> float:
    """Median device time of ``fn()`` over ``n`` calls (CUDA events),
    with the 50 MB L2 flushed before each so it starts cold. A device
    sleep before the start event lets the host enqueue the whole call
    first, so host overhead does not show up as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def two_threads(kern, bits, what: str) -> dict:
    """``kern`` launched DETERMINISM_LAUNCHES times from each of two host
    threads on one stream, interleaved as the threads run: every output
    must equal ``bits`` (int32)."""
    got = {t: [] for t in range(2)}

    def launch(t):
        for _ in range(DETERMINISM_LAUNCHES):
            got[t].append(kern())

    threads = [threading.Thread(target=launch, args=(t,)) for t in got]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if not all(torch.equal(o.view(torch.int32), bits) for outs in got.values() for o in outs):
        fail(f"{what} from two threads on one stream differs from one thread's launch")
    return {"launches": 2 * DETERMINISM_LAUNCHES, "bit_identical": True}


def scatter_determinism(rng, dev, v, g) -> dict:
    """K2 and K4 launched DETERMINISM_LAUNCHES times each on three batches
    at the slice's B, K and D: Criteo rows (13 dense columns in every
    row), a batch whose every entry names one row, and ``edge_inputs``
    (out-of-range indices) with NaN values in 8 rows. Every launch's
    output must equal the first's bit for bit (compared as int32), and the
    first must lie within tolerance of the plain version. On the Criteo
    batch, two host threads then launch each on one stream, every output
    again bit-identical. Returns, per batch and kernel, the launches and
    the largest |kernel - plain|."""
    from dmlc_core_tpu_torch.ops import fm as opfm, sparse as ops

    idx_c, val_c = criteo_rows(rng, B, D)
    idx_n, val_n = edge_inputs(rng, dev, False)
    val_n[200:208, 20] = float("nan")
    batches = {
        "criteo": (torch.from_numpy(idx_c.astype(np.int32)).to(dev),
                   torch.from_numpy(val_c).to(dev)),
        "one_row": (torch.full((B, K), int(rng.integers(D)), dtype=torch.int32, device=dev),
                    torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(dev)),
        "nan_oob": (idx_n, val_n),
    }
    out = {}
    for name, (idx, val) in batches.items():
        s = opfm.fm_pair_fwd_plain(idx, val, v)[1]
        pairs = {
            "ell_matvec_bwd": (lambda: ops.ell_matvec_bwd_kernel(idx, val, g, D),
                               lambda: ops.ell_matvec_bwd_plain(idx, val, g, D)),
            "fm_pair_bwd": (lambda: opfm.fm_pair_bwd_kernel(idx, val, v, s, g),
                            lambda: opfm.fm_pair_bwd_plain(idx, val, v, s, g)),
        }
        out[name] = {}
        for kname, (kern, plain) in pairs.items():
            first = kern()
            err = close_enough(first, plain(), "grad", f"{kname} determinism {name}")
            bits = first.view(torch.int32)
            for i in range(1, DETERMINISM_LAUNCHES):
                if not torch.equal(kern().view(torch.int32), bits):
                    fail(f"{kname} on the {name} batch: launch {i} differs from launch 0")
            out[name][kname] = {"launches": DETERMINISM_LAUNCHES, "bit_identical": True,
                                "max_abs_err": err}
            if name == "criteo":
                out[name][kname]["two_threads_one_stream"] = two_threads(kern, bits, kname)
    return out


def deterministic(fn):
    """``fn()`` under ``torch.use_deterministic_algorithms(True)``, the
    mode restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(was)


def kernel_phase(dev, flush):
    """Compare K1-K4 with their plain versions on edge inputs, then time
    kernel / plain / library on Criteo-shaped inputs, beside an empty
    launch. Returns rows of the kernels line (without launches)."""
    import torch.nn.functional as F

    from dmlc_core_tpu_torch.ops import _build, fm as opfm, sparse as ops

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn(D, generator=gen, device=dev) * 0.01
    v = torch.randn(D, E, generator=gen, device=dev) * 0.01
    g = torch.randn(B, generator=gen, device=dev)
    err = dict.fromkeys(KERNEL_NAMES, 0.0)
    by_e = {}  # the edge shapes' largest errors by E
    for f16 in (False, True):
        tag = "f16" if f16 else "f32"
        idx, val = edge_inputs(rng, dev, f16)
        check_kernels(idx, val, w, v, g, tag, err)
        check_unaligned_scatters(idx, val, v, opfm.fm_pair_fwd_plain(idx, val, v)[1], g, err)
        for b, k, e, d in EDGE_SHAPES:
            idx_e, val_e = edge_shape_inputs(rng, dev, f16, b, k, d)
            check_kernels(idx_e, val_e, torch.randn(d, generator=gen, device=dev),
                          torch.randn(d, e, generator=gen, device=dev),
                          torch.randn(b, generator=gen, device=dev),
                          f"{tag} B={b} K={k} E={e}",
                          by_e.setdefault(e, dict.fromkeys(KERNEL_NAMES, 0.0)))
        for kind in SCATTER_KINDS:
            idx_s, val_s, d = scatter_inputs(rng, dev, f16, kind)
            check_kernels(idx_s, val_s, torch.randn(d, generator=gen, device=dev),
                          torch.randn(d, E, generator=gen, device=dev), g,
                          f"{tag} {kind}", err)
    determinism = scatter_determinism(rng, dev, v, g)
    torch.cuda.synchronize()
    for e_err in by_e.values():
        for name in KERNEL_NAMES:
            err[name] = max(err[name], e_err[name])
    for per_kernel in determinism.values():
        for name, d in per_kernel.items():
            err[name] = max(err[name], d["max_abs_err"])

    # timing inputs: the main path's shape and data (f32 values)
    idx_np, val_np = criteo_rows(rng, B, D)
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    val = torch.from_numpy(val_np).to(dev)
    _, s = opfm.fm_pair_fwd_plain(idx, val, v)
    uniq = int(np.unique(idx_np).size)
    bk, vb = B * K, 4
    j = idx.reshape(-1).long()
    contrib_w = (g[:, None] * val).reshape(-1)
    contrib_v = (g[:, None, None] * val[..., None]
                 * (s[:, None, :] - val[..., None] * v[idx.long()])).reshape(-1, E)
    # (name, site, kernel, plain, library, bytes, operations, zero-fill of
    # the dense gradient the wrapper allocates or None)
    rows = [
        ("ell_matvec_fwd", "dmlc_core_tpu/ops/sparse.py:17",
         lambda: ops.ell_matvec_fwd_kernel(idx, val, w),
         lambda: ops.ell_matvec_fwd_plain(idx, val, w),
         lambda: F.embedding_bag(idx, w[:, None], per_sample_weights=val, mode="sum"),
         bk * (4 + vb) + uniq * 4 + B * 4, 2 * bk, None),
        ("ell_matvec_bwd", "dmlc_core_tpu/ops/sparse.py:17",
         lambda: ops.ell_matvec_bwd_kernel(idx, val, g, D),
         lambda: ops.ell_matvec_bwd_plain(idx, val, g, D),
         lambda: torch.zeros(D, device=dev).index_add_(0, j, contrib_w),
         bk * (4 + vb) + B * 4 + D * 4, 2 * bk,
         lambda: torch.zeros(D, dtype=torch.float32, device=dev)),
        ("fm_pair_fwd", "dmlc_core_tpu/models/fm.py:46",
         lambda: opfm.fm_pair_fwd_kernel(idx, val, v),
         lambda: opfm.fm_pair_fwd_plain(idx, val, v),
         lambda: F.embedding_bag(idx, v, per_sample_weights=val, mode="sum"),
         bk * (4 + vb) + uniq * E * 4 + B * 4 + B * E * 4, 4 * bk * E + 3 * B * E, None),
        ("fm_pair_bwd", "dmlc_core_tpu/models/fm.py:46",
         lambda: opfm.fm_pair_bwd_kernel(idx, val, v, s, g),
         lambda: opfm.fm_pair_bwd_plain(idx, val, v, s, g),
         lambda: torch.zeros(D, E, device=dev).index_add_(0, j, contrib_v),
         bk * (4 + vb) + B * 4 + B * E * 4 + uniq * E * 4 + D * E * 4, 5 * bk * E,
         lambda: torch.zeros(D, E, dtype=torch.float32, device=dev)),
    ]
    floor_ms = time_ms(lambda: _build.empty_launch(dev), flush)
    out = []
    for name, replaces, kern, plain, lib, nbytes, nops, zero_fill in rows:
        ms = time_ms(kern, flush)
        bound_ms, bound_by = bound(nbytes, nops)
        out.append({
            "name": name, "route": "cuda", "source": SRC, "replaces": replaces,
            "launches": 0, "max_abs_err": err[name],
            "max_abs_err_by_e": {str(e): by_e[e][name] for e in sorted(by_e)},
            "ms": ms, "plain_ms": time_ms(plain, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib, flush),
            "kernel_ms": ms, "bound_us": bound_ms * 1e3,
            "floor_us": floor_ms * 1e3,
            "zero_fill_us": None if zero_fill is None else time_ms(zero_fill, flush) * 1e3,
        })
        if name in determinism["criteo"]:
            out[-1]["determinism"] = {b: d[name] for b, d in determinism.items()}
            try:
                out[-1]["library_deterministic_ms"] = deterministic(lambda: time_ms(lib, flush))
            except RuntimeError as e:  # a torch without a deterministic index_add_
                out[-1]["library_deterministic_ms"] = None
                out[-1]["library_deterministic_error"] = str(e)[:200]
    return out


def criteo_data(rng, rows: int, num_features: int):
    """Criteo-shaped rows (``criteo_rows``) with labels from a planted
    model whose dense columns carry most of the signal."""
    idx, val = criteo_rows(rng, rows, num_features)
    planted = rng.normal(size=num_features).astype(np.float32)
    planted[:N_DENSE] *= 4.0
    labels = ((planted[idx] * val).sum(1) > 0).astype(np.float32)
    return idx, val, labels


def rowrec_bytes(idx, val, labels) -> bytes:
    import io

    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec

    n = len(labels)
    blk = RowBlock(
        offset=np.arange(n + 1, dtype=np.int64) * K, label=labels,
        index=idx.reshape(-1).astype(np.uint32), value=val.reshape(-1),
    )
    out = io.BytesIO()
    write_rowrec(out, [blk])
    return out.getvalue()


def text_lines(cols, sep: str) -> bytes:
    """Columns of strings → the lines of a text file."""
    return "".join(sep.join(r) + "\n" for r in zip(*[c.tolist() for c in cols])).encode()


def criteo_text(idx, val, labels, fmt: str) -> bytes:
    """Criteo rows as sparse libsvm (13 ``j:val`` tokens and 26 bare ids,
    value 1) or libfm (``field:id:val`` and ``field:id``), as bench.py
    writes them."""
    cols = [np.char.mod("%d", labels.astype(np.int64))]
    for j in range(N_DENSE):
        tag = f"{j}:{j}" if fmt == "libfm" else f"{j}"
        cols.append(np.char.mod(f"{tag}:%.6f", val[:, j]))
    for j in range(N_DENSE, K):
        cols.append(np.char.mod(f"{j}:%d" if fmt == "libfm" else "%d", idx[:, j]))
    return text_lines(cols, " ")


def higgs_data(rng, rows: int):
    """HIGGS-shaped rows: 28 N(0,1) features, labels from a planted model."""
    x = rng.normal(size=(rows, HIGGS_D)).astype(np.float32)
    labels = (x @ rng.normal(size=HIGGS_D) > 0).astype(np.float32)
    return x, labels


def higgs_text(x, labels, fmt: str) -> bytes:
    """HIGGS rows as libsvm (``j:val``, ids 0-27) or csv (label first)."""
    cols = [np.char.mod("%d", labels.astype(np.int64))]
    for j in range(HIGGS_D):
        cols.append(np.char.mod("%.6f" if fmt == "csv" else f"{j}:%.6f", x[:, j]))
    return text_lines(cols, "," if fmt == "csv" else " ")


def write_file(path: str, block: bytes, repeats: int = 1) -> str:
    with open(path, "wb") as f:
        for _ in range(repeats):
            f.write(block)
    return path


def picked_threads(rows: int, batch: int) -> int:
    """The producer fan-out for a file of ``rows`` rows (bench.py's rule):
    every usable CPU, but no more sub-shards than leave each four full
    batches."""
    from dmlc_core_tpu_torch.utils.cpus import parse_threads

    return parse_threads(max(1, rows // (batch * 4)))


def native_source(uri, spec, nthread=None):
    from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches

    if spec.layout == "dense":
        return dense_batches(uri, spec, nthread=nthread)
    return ell_batches(uri, spec, nthread=nthread)


def rows_per_sec(source) -> float:
    """Drain a producer alone; its rows over the wall time."""
    t0 = time.perf_counter()
    rows = sum(b.n_valid for b in source)
    dt = time.perf_counter() - t0
    source.close()
    return rows / dt


def batch_bits(batch):
    """A batch's arrays as bytes, with the sign of a zero value dropped:
    the native libsvm → dense kernel adds a row's features into a zeroed
    row, so a -0.0 feature stages as +0.0 (as in the JAX package)."""
    return [batch.n_valid] + [
        (v + v.dtype.type(0) if v.dtype.kind == "f" else v).tobytes()
        for v in batch.as_dict().values()]


def same_batches(native, plain, what: str) -> int:
    """Native and plain producer batches equal bit for bit (each checked
    as it is yielded: both recycle ring slots); returns the batch count."""
    n = 0
    for a, b in zip(native, plain, strict=True):
        if batch_bits(a) != batch_bits(b):
            fail(f"{what}: native batch {n} differs from the plain version")
        n += 1
    native.close()
    plain.close()
    return n


def producer_phase():
    """Every native producer against its plain version, and its rows/s on
    the host with one thread and with ``picked_threads``."""
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import plain_batches

    rng = np.random.default_rng(2)
    idx, val, labels = criteo_data(rng, BLOCK_ROWS, D)
    x, ylab = higgs_data(rng, BLOCK_ROWS)
    blocks = {
        "criteo.rec": rowrec_bytes(idx, val, labels),
        "criteo.libsvm": criteo_text(idx, val, labels, "libsvm"),
        "criteo.libfm": criteo_text(idx, val, labels, "libfm"),
        "higgs.libsvm": higgs_text(x, ylab, "libsvm"),
        "higgs.csv": higgs_text(x, ylab, "csv"),
    }
    ell = lambda vdt: BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)  # noqa: E731
    dense = lambda vdt: BatchSpec(batch_size=HIGGS_B, layout="dense",  # noqa: E731
                                  num_features=HIGGS_D, value_dtype=vdt)
    streams = [
        ("rowrec_f16", "criteo.rec", "", ell(np.float16)),
        ("rowrec_f32", "criteo.rec", "", ell(np.float32)),
        ("criteo_libsvm_f32", "criteo.libsvm", "?format=libsvm", ell(np.float32)),
        ("criteo_libfm_f32", "criteo.libfm", "?format=libfm", ell(np.float32)),
        ("higgs_libsvm_f16", "higgs.libsvm", "", dense(np.float16)),
        ("higgs_csv_f32", "higgs.csv", "?format=csv&label_column=0", dense(np.float32)),
    ]
    out = {"host_cpus": os.cpu_count(), "affinity_cpus": len(os.sched_getaffinity(0)),
           "block_rows": BLOCK_ROWS, "rows": PRODUCER_ROWS, "streams": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, block in blocks.items():
            write_file(os.path.join(tmp, "block-" + name), block)
            write_file(os.path.join(tmp, name), block, PRODUCER_ROWS // BLOCK_ROWS)
        for name, fname, query, spec in streams:
            small = os.path.join(tmp, "block-" + fname) + query
            big = os.path.join(tmp, fname) + query
            n = same_batches(native_source(small, spec), plain_batches(small, spec), name)
            threads = picked_threads(PRODUCER_ROWS, spec.batch_size)
            out["streams"][name] = {
                "batches_compared": n,
                "native_rows_per_sec_1thread": rows_per_sec(native_source(big, spec)),
                "nthread": threads,
                "native_rows_per_sec": rows_per_sec(native_source(big, spec, threads)),
                "plain_rows_per_sec": rows_per_sec(plain_batches(small, spec)),
            }
    return out


def plain_loss(params, batch):
    """The model's loss with every kernel replaced by its plain version
    (differentiable PyTorch ops; their gradient is PyTorch's own)."""
    from dmlc_core_tpu_torch.models.common import bce_with_logits
    from dmlc_core_tpu_torch.ops.fm import fm_pair_fwd_plain
    from dmlc_core_tpu_torch.ops.sparse import ell_matvec_fwd_plain, weighted_mean

    idx, val = batch["indices"], batch["values"]
    scores = ell_matvec_fwd_plain(idx, val, params["w"]) + params["b"]
    if "v" in params:
        scores = scores + fm_pair_fwd_plain(idx, val, params["v"])[0]
    return weighted_mean(bce_with_logits(scores, batch["labels"]), batch["weights"])


class RowLog:
    """A producer that notes each batch's valid rows (and, with
    ``digests``, a hash of its packed bytes) as the staging thread pulls
    it (on the host: the timed loop gains no device work)."""

    def __init__(self, source, digests: bool = False) -> None:
        self.source, self.rows = source, []
        self.digests = [] if digests else None
        # the producer contract the pipeline reads: a ring's size, or a
        # dsserve client's adoptable slots
        self.ring_slots = getattr(source, "ring_slots", None)
        self.adopt_slots = getattr(source, "adopt_slots", False)

    def __iter__(self):
        for batch in self.source:
            self.rows.append(batch.n_valid)
            if self.digests is not None:
                self.digests.append(hashlib.blake2b(batch.packed).hexdigest())
            yield batch


def drive(name, model, source, dev, lr, min_steps: int = 20, stop_after=None,
          on_step=None, digests: bool = False, must_fall: bool = True):
    """One pass of a path: producer → StagingPipeline → SGD steps, ended
    early after ``stop_after`` steps; ``on_step(step, batch)`` runs after
    each step. Returns (stats, first batch, params before the first
    step); with ``digests`` the stats hold the hashes of the batches the
    steps took."""
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    log = RowLog(source, digests)
    pipe = StagingPipeline(log, device=dev)
    losses, step_s, wait_s, first_wait = [], [], 0.0, None
    first = params0 = None
    _build.reset_launches()
    t_start = time.perf_counter()
    it = iter(pipe)
    while stop_after is None or len(losses) < stop_after:
        t0 = time.perf_counter()
        batch = next(it, None)
        t1 = time.perf_counter()
        wait_s += t1 - t0
        if batch is None:
            break
        if first is None:
            first_wait = t1 - t0
            first = {k: t.clone() for k, t in batch.items()}
            params0 = {k: p.detach().clone() for k, p in model.params().items()}
        losses.append(float(model.sgd_step(batch, lr=lr)))  # syncs the step
        step_s.append(time.perf_counter() - t1)
        if on_step is not None:
            on_step(len(losses), batch)
    wall = time.perf_counter() - t_start
    launches = dict(_build.launches)
    thr = pipe.throughput()
    staging = pipe.staging_stats()
    if not drain_close(pipe, source):
        fail("staging pipeline did not close cleanly")
    n = len(losses)
    if n < min_steps:
        fail(f"{name}: only {n} steps ran")
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss: {losses}")
    # row-weighted: a sub-shard's short tail batch counts by its rows
    rows = log.rows[:n]
    head = np.average(losses[:4], weights=rows[:4])
    tail = np.average(losses[-4:], weights=rows[-4:])
    if must_fall and not tail < head:
        fail(f"{name}: loss did not fall: first steps {head}, last steps {tail}: {losses}")
    extra = {} if log.digests is None else {"digests": log.digests[:n]}
    return {**extra,
        "steps": n, "step_ms": statistics.median(step_s) * 1e3,
        "step_ms_first": step_s[0] * 1e3, "steps_s_total": sum(step_s),
        "staged_rows_per_sec": thr["rows_per_sec"],
        "rows_staged": int(thr["rows"]), "batches_staged": int(thr["batches"]),
        "wait_share": wait_s / wall, "wall_s": wall, "first_batch_wait_s": first_wait,
        "stage_seconds": {k[5:]: v for k, v in thr.items() if k.startswith("secs_")},
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "staging": staging,
    }, first, params0


def check_first_step(model, first, params0):
    """The first step's loss and gradients with the kernels against the
    same step with the plain versions, on the card."""
    model.load_state_dict(params0)
    loss_k, grads_k = model.loss_and_grads(first)
    params = {k: p.clone().requires_grad_() for k, p in params0.items()}
    loss_p = plain_loss(params, first)
    grads_p = dict(zip(params, torch.autograd.grad(loss_p, list(params.values()))))
    close_enough(loss_k.reshape(1), loss_p.detach().reshape(1), "fwd", "first-step loss")
    for k in grads_p:
        close_enough(grads_k[k], grads_p[k], "grad", f"first-step grad {k}")


def check_first_step_on_cpu(model, make, first, params0):
    """The first step's loss and gradients on the card against the same
    step on the CPU (a dense model: no kernel, a matmul in another
    order)."""
    model.load_state_dict(params0)
    loss_d, grads_d = model.loss_and_grads(first)
    cpu = make("cpu")
    cpu.load_state_dict({k: p.cpu() for k, p in params0.items()})
    loss_c, grads_c = cpu.loss_and_grads({k: t.cpu() for k, t in first.items()})
    close_enough(loss_d.cpu().reshape(1), loss_c.reshape(1), "fwd", "first-step loss vs CPU")
    for k in grads_c:
        close_enough(grads_d[k].cpu(), grads_c[k], "grad", f"first-step grad {k} vs CPU")


def profile_steps(model, batch, lr: float, n: int = 8):
    """Device time by kernel over ``n`` back-to-back SGD steps on one
    staged batch (torch.profiler), and the device's busy share of the
    window's wall time (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        model.sgd_step(batch, lr=lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.sgd_step(batch, lr=lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t in dev) * 1e-6
    return {
        "steps": n, "wall_ms_per_step": wall / n * 1e3,
        "device_ms_per_step": busy / n * 1e3, "device_busy_share": busy / wall,
        # K1-K4 by name (their share of the step is this over the above)
        "kernel_ms_per_step": {
            name: sum(t for key, t in dev
                      if any(part in key for part in kernel_parts(name))) * 1e-3 / n
            for name in KERNEL_NAMES},
        "top": [{"name": k[:90], "ms_per_step": t * 1e-3 / n}
                for k, t in sorted(dev, key=lambda kt: -kt[1])[:8]],
    }


def check_staged(uri, spec, first) -> None:
    """The first staged batch equals the first host batch's bytes."""
    src = native_source(uri, spec)
    host = next(iter(src)).as_dict()
    for k, v in host.items():
        if not np.array_equal(first[k].cpu().numpy(), v):
            fail(f"staged {k} differs from the host batch")
    src.close()


def slice_phase(dev, num_features: int = D, embed_dim: int = E,
                n_batches: int = N_BATCHES):
    """Each path at full width: (name, uri, spec, model, lr, first-step
    check), driven through its native producer three times: a warm-up
    pass, a pass with one thread (``one_thread``) and a pass with the
    thread count ``picked_threads`` gives (the main run: checks, profile
    and launches)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def fm(d):
        return FactorizationMachine(num_features, embed_dim, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    def lr_sparse(d):
        return LogisticRegression(num_features, device=d,
                                  generator=torch.Generator(device=d).manual_seed(0))

    def lr_dense(d):
        return LogisticRegression(HIGGS_D, device=d,
                                  generator=torch.Generator(device=d).manual_seed(0))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        idx, val, labels = criteo_data(rng, n_batches * B, num_features)
        rows = n_batches * B * SLICE_REPEATS
        rec = write_file(os.path.join(tmp, "criteo.rec"), rowrec_bytes(idx, val, labels),
                         SLICE_REPEATS)
        svm = write_file(os.path.join(tmp, "criteo.libsvm"),
                         criteo_text(idx, val, labels, "libsvm"), SLICE_REPEATS)
        x, ylab = higgs_data(rng, HIGGS_B)
        csv = write_file(os.path.join(tmp, "higgs.csv"), higgs_text(x, ylab, "csv"),
                         HIGGS_BATCHES)
        ell = lambda vdt: BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)  # noqa: E731
        paths = [
            ("fm", rec, ell(np.float32), fm, 0.5, "kernels"),
            ("lr", rec, ell(np.float16), lr_sparse, 0.5, "kernels"),
            ("libsvm_fm", svm + "?format=libsvm", ell(np.float32), fm, 0.5, "kernels"),
            ("csv_lr", csv + "?format=csv&label_column=0",
             BatchSpec(batch_size=HIGGS_B, layout="dense", num_features=HIGGS_D),
             lr_dense, 1.0, "cpu"),
        ]
        for name, uri, spec, make, lr, check in paths:
            n_rows = HIGGS_B * HIGGS_BATCHES if spec.layout == "dense" else rows
            threads = picked_threads(n_rows, spec.batch_size)
            min_steps = HIGGS_BATCHES - 2 if spec.layout == "dense" else 20
            # a pass that pays the path's first-use costs (allocator
            # growth, library handles), so the two timed passes start warm
            drive(name, make(dev), native_source(uri, spec), dev, lr, min_steps)
            one, _, _ = drive(name, make(dev), native_source(uri, spec), dev, lr, min_steps)
            model = make(dev)
            stats, first, params0 = drive(
                name, model, native_source(uri, spec, threads), dev, lr, min_steps)
            stats["nthread"] = threads
            stats["one_thread"] = one
            check_staged(uri, spec, first)
            if check == "kernels":
                check_first_step(model, first, params0)
            else:
                check_first_step_on_cpu(model, make, first, params0)
            stats["profile"] = profile_steps(model, first, lr)
            out[name] = stats
    return out


SHUFFLE_MODES = ("record", "batch", "window")


def write_indexed(path: str, idx, val, labels) -> str:
    """Criteo rows as rowrec with its ``.idx`` index, through the port's
    ``FileStream`` and ``write_rowrec(index_stream=)``; returns the path."""
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec
    from dmlc_core_tpu_torch.io.stream import FileStream

    n = len(labels)
    blk = RowBlock(offset=np.arange(n + 1, dtype=np.int64) * K, label=labels,
                   index=idx.reshape(-1).astype(np.uint32), value=val.reshape(-1))
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        write_rowrec(f, [blk], index_stream=fi)
    return path


class Interleaved:
    """The plain versions of ``n`` sub-parts, batches taken round-robin as
    ``ShardedFusedBatches`` takes them from its sub-producers."""

    def __init__(self, uri: str, spec, n: int) -> None:
        from dmlc_core_tpu_torch.staging.fused import plain_batches

        self.parts = [plain_batches(uri, spec, t, n) for t in range(n)]

    def __iter__(self):
        iters = [iter(p) for p in self.parts]
        while iters:
            still = []
            for it in iters:
                batch = next(it, None)
                if batch is not None:
                    still.append(it)
                    yield batch
            iters = still

    def close(self) -> None:
        for p in self.parts:
            p.close()


def drain_stats(source):
    """Drain a producer alone: (rows/s, its io_stats) after the drain."""
    t0 = time.perf_counter()
    rows = sum(b.n_valid for b in source)
    dt = time.perf_counter() - t0
    stats = source.io_stats()
    source.close()
    return rows / dt, stats


def shuffle_producers(rec: str, spec):
    """Each shuffle mode's producer beside the sequential one: bit for bit
    against the plain version (one thread, and ``picked_threads``
    sub-shards against the plain sub-parts interleaved), then rows/s and
    the split's counters; ``gather_fallback_batches`` must stay 0."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches, plain_batches

    threads = picked_threads(PRODUCER_ROWS, spec.batch_size)
    out = {"rows": PRODUCER_ROWS, "nthread": threads, "modes": {}}
    for mode in ("sequential",) + SHUFFLE_MODES:
        uri = rec if mode == "sequential" else f"{rec}?index={rec}.idx&shuffle={mode}&seed=3"
        row = {"batches_compared": same_batches(
            ell_batches(uri, spec), plain_batches(uri, spec), f"shuffle {mode}")}
        row["batches_compared_threads"] = same_batches(
            ell_batches(uri, spec, nthread=threads), Interleaved(uri, spec, threads),
            f"shuffle {mode} x{threads}")
        row["rows_per_sec_1thread"], row["io_stats_1thread"] = drain_stats(
            ell_batches(uri, spec))
        row["rows_per_sec"], row["io_stats"] = drain_stats(
            ell_batches(uri, spec, nthread=threads))
        for key in ("io_stats_1thread", "io_stats"):
            st = row[key]
            if mode != "sequential" and not (
                    st.get("gather_batches", 0) > 0
                    and st.get("gather_fallback_batches") == 0):
                fail(f"shuffle {mode}: not every batch took the gather path: {st}")
        out["modes"][mode] = row
    return out


def resumable_fm(rec: str, spec, dev, make, lr: float, tmp: str):
    """FM SGD on the card over ``shuffle=batch`` (the example's URI):
    a timed pass; an uninterrupted pass noting each batch; a pass that
    saves params and position every 4 steps with ``save_async`` and
    stops at step 64; then a fresh ``Checkpointer`` restores, and a new
    pipeline with ``skip_records`` takes the remaining steps, whose
    batches must equal the uninterrupted pass's."""
    from dmlc_core_tpu_torch.checkpoint import Checkpointer
    from dmlc_core_tpu_torch.convert import params_from_jax
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    uri = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    timed, first, _ = drive("shuffle_fm", make(dev), ell_batches(uri, spec), dev, lr)
    check_staged(uri, spec, first)
    full, _, _ = drive("shuffle_fm full", make(dev), ell_batches(uri, spec), dev, lr,
                       digests=True)
    ck_dir = os.path.join(tmp, "ckpt")
    ck = Checkpointer(ck_dir, keep=2)
    model = make(dev)
    stop = full["steps"] // 2

    def save(step, batch):
        if step % 4 == 0:
            ck.save_async(step, model.params(),
                          meta={"epoch": 0, "records": step * B})

    head, _, _ = drive("shuffle_fm head", model, ell_batches(uri, spec), dev, lr,
                       stop_after=stop, on_step=save, digests=True)
    ck.wait()
    saved = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    fresh = Checkpointer(ck_dir, keep=2)
    step, tree = fresh.restore()
    meta = fresh.restore_meta()
    if step != stop or meta != {"epoch": 0, "records": stop * B}:
        fail(f"restored step {step} meta {meta}, saved step {stop}")
    for k, v in saved.items():
        if not np.array_equal(tree[k], v):
            fail(f"restored param {k} differs from the saved one")
    resumed = make(dev)
    resumed.load_state_dict(params_from_jax(tree, dev))
    tail, _, _ = drive("shuffle_fm tail", resumed,
                       ell_batches(f"{uri}&skip_records={meta['records']}", spec),
                       dev, lr, min_steps=1, digests=True, must_fall=False)
    if head["digests"] != full["digests"][:stop]:
        fail("the interrupted pass read other batches than the uninterrupted one")
    if tail["digests"] != full["digests"][stop:]:
        fail(f"the {tail['steps']} batches after the resume differ from steps "
             f"{stop + 1}-{full['steps']} of the uninterrupted pass")
    for s in (head, tail, full):
        del s["digests"]
    return {"uri": uri, "timed": timed, "uninterrupted": full, "head": head,
            "resumed": tail, "checkpoint": {"step": step, "meta": meta,
                                            "steps_kept": fresh.steps()}}


def shuffle_phase(dev, sequential_fm):
    """The indexed, shuffled path at the Criteo width: its producers on the
    host, and resumable FM SGD on the card; K1-K4 launch per step as on
    the sequential FM path (``sequential_fm``, the slice phase's)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def fm(d):
        return FactorizationMachine(D, E, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(3)
        t0 = time.perf_counter()
        rec = write_indexed(os.path.join(tmp, "criteo.rec"), *criteo_data(rng, PRODUCER_ROWS, D))
        out = {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(rec)}
        out["producers"] = shuffle_producers(rec, spec)
        out["fm"] = resumable_fm(rec, spec, dev, fm, 0.5, tmp)
    per_step = lambda s: {k: n / s["steps"] for k, n in s["launches"].items()}  # noqa: E731
    want = per_step(sequential_fm)
    for name in ("timed", "uninterrupted", "head", "resumed"):
        got = per_step(out["fm"][name])
        if got != want:
            fail(f"shuffled FM {name}: launches per step {got}, sequential {want}")
    return out


CODEC_BLOCK = 1 << 20  # bench.py's rec_zlib packing (bench.py:342-349)
MULTI_FILES = 4


def write_compressed(rec: str, dst: str, codec_name: str, block_bytes=None) -> str:
    """``rec``'s v1 frames, cut at its index's offsets, written again in
    compressed blocks by the port's ``IndexedRecordIOWriter`` (with its
    ``block:in`` index), as bench.py builds ``rec_zlib``."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    with open(rec + ".idx") as f:
        offs = np.asarray(f.read().split()[1::2], dtype=np.int64)
    with open(rec, "rb") as f:
        data = f.read()
    kw = {} if block_bytes is None else {"block_bytes": block_bytes}
    with FileStream(dst, "w") as f, FileStream(dst + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec=codec_name, **kw)
        w.write_framed_block(data, np.sort(offs))
        w.flush()
    return dst


def decode_seconds(path: str):
    """Seconds to decode every block of a compressed file after reading
    it: walking its frames and decoding block by block on this thread,
    and on the decode pool; and the block count."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.io.recordio import scan_compressed_blob

    with open(path, "rb") as f:
        view = memoryview(f.read())
    blobs, pos = [], 0
    while pos < len(view):
        blob, pos = scan_compressed_blob(view, pos)
        blobs.append(blob)
    t0 = time.perf_counter()
    raw = sum(len(codec.decode_block(b)[0]) for b in blobs)
    one = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = sum(len(r) for r, _n in codec.decode_blocks(blobs))
    pool = time.perf_counter() - t0
    if pooled != raw:
        fail(f"{path}: the pool decoded {pooled} bytes, one thread {raw}")
    return {"blocks": len(blobs), "raw_bytes": raw, "decode_s_1thread": one,
            "decode_s_pool": pool, "pool_threads": codec.decode_threads()}


def codec_producers(files, spec, threads: int):
    """Each compressed file's batches bit for bit against the
    uncompressed file's, sequential and in each shuffle mode, one thread
    and ``threads`` sub-shards (sequential sub-shards against the plain
    version on the same compressed file), the indexed modes also at 3
    parts; then rows/s of all three files alone on the host, the
    decoded-block cache emptied before each pass."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    def uri(path, mode):
        return path if mode == "sequential" else f"{path}?index={path}.idx&shuffle={mode}&seed=3"

    out = {}
    for name in ("zlib", "gzip"):
        rows = {}
        for mode in ("sequential",) + SHUFFLE_MODES:
            got, want = uri(files[name], mode), uri(files["v1"], mode)
            row = {"batches_compared": same_batches(ell_batches(got, spec),
                                                    ell_batches(want, spec), f"{name} {mode}")}
            ref = (Interleaved(got, spec, threads) if mode == "sequential"
                   else ell_batches(want, spec, nthread=threads))
            row["batches_compared_threads"] = same_batches(
                ell_batches(got, spec, nthread=threads), ref, f"{name} {mode} x{threads}")
            if mode != "sequential":
                row["batches_compared_3parts"] = sum(
                    same_batches(ell_batches(got, spec, part, 3),
                                 ell_batches(want, spec, part, 3), f"{name} {mode} part {part}/3")
                    for part in range(3))
            rows[mode] = row
        out[name] = rows
    for mode in ("sequential",) + SHUFFLE_MODES:
        for name in ("v1", "zlib", "gzip"):
            row = out.setdefault(name, {}).setdefault(mode, {})
            # each pass decodes its blocks: none comes from an earlier one
            codec.default_decode_cache().clear()
            row["rows_per_sec_1thread"], row["io_stats_1thread"] = drain_stats(
                ell_batches(uri(files[name], mode), spec))
            row["rows_per_sec"], row["io_stats"] = drain_stats(
                ell_batches(uri(files[name], mode), spec, nthread=threads))
            for key in ("io_stats_1thread", "io_stats"):
                st = row[key]
                if mode != "sequential" and not (st.get("gather_batches", 0) > 0
                                                 and st.get("gather_fallback_batches") == 0):
                    fail(f"{name} {mode}: not every batch took the gather path: {st}")
    return out


def second_pass_from_cache(path: str, spec):
    """Two passes of ``shuffle=window`` over the zlib file with the same
    seed and epoch, the decoded-block cache cleared before the first:
    the second's batches equal the first's and its blocks come from the
    cache."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    codec.default_decode_cache().clear()
    uri = f"{path}?index={path}.idx&shuffle=window&seed=5&epoch=0"
    passes = []
    for _ in range(2):
        src = ell_batches(uri, spec)
        t0 = time.perf_counter()
        digests = [hashlib.blake2b(b.packed).hexdigest() for b in src]
        dt = time.perf_counter() - t0
        st = src.io_stats()
        src.close()
        passes.append({"rows_per_sec": len(digests) * spec.batch_size / dt, "batches": len(digests),
                       "decode_cache_hits": st["decode_cache_hits"],
                       "decode_cache_misses": st["decode_cache_misses"], "digests": digests})
    first, second = passes
    if second.pop("digests") != first.pop("digests"):
        fail("the second pass over the zlib file read other batches than the first")
    if not second["decode_cache_hits"] > 10 * max(second["decode_cache_misses"], 1):
        fail(f"the second pass was not served from the decoded-block cache: {second}")
    return {"uri": uri, "first": first, "second": second,
            "cache_mb": codec.default_decode_cache().max_bytes >> 20}


class Epochs:
    """A producer iterated ``n`` times in a row, as one stream of batches."""

    def __init__(self, source, n: int) -> None:
        self.source, self.n = source, n
        self.ring_slots = source.ring_slots

    def __iter__(self):
        for _ in range(self.n):
            yield from self.source

    def close(self) -> None:
        self.source.close()


def codec_phase(dev, sequential_fm):
    """Compressed, multi-file and cached inputs at the Criteo width: the
    producers on the host, then FM SGD on the card from each."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    def fm(d):
        return FactorizationMachine(D, E, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    threads = picked_threads(PRODUCER_ROWS, B)
    out = {"available_codecs": codec.available_codecs(), "rows": PRODUCER_ROWS, "nthread": threads}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(3)
        idx, val, labels = criteo_data(rng, PRODUCER_ROWS, D)
        files = {"v1": write_indexed(os.path.join(tmp, "criteo.rec"), idx, val, labels)}
        for name, block in (("zlib", CODEC_BLOCK), ("gzip", None)):
            t0 = time.perf_counter()
            files[name] = write_compressed(files["v1"], os.path.join(tmp, f"criteo.{name}.rec"),
                                           name, block)
            out[name] = {"write_s": time.perf_counter() - t0,
                         "block_bytes": block or "default",
                         "bytes": os.path.getsize(files[name]),
                         "ratio": os.path.getsize(files["v1"]) / os.path.getsize(files[name]),
                         **decode_seconds(files[name])}
        out["v1_bytes"] = os.path.getsize(files["v1"])
        out["producers"] = codec_producers(files, spec, threads)
        out["second_pass"] = second_pass_from_cache(files["zlib"], spec)
        fm_runs = {}
        for name in ("v1", "zlib"):
            uri = f"{files[name]}?index={files[name]}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
            codec.default_decode_cache().clear()  # the pass decodes its blocks
            model = fm(dev)
            fm_runs[name], first, params0 = drive(f"codec_fm {name}", model,
                                                  ell_batches(uri, spec), dev, 0.5, digests=True)
            if name == "zlib":
                check_first_step(model, first, params0)
                check_staged(uri, spec, first)
        if fm_runs["zlib"]["digests"] != fm_runs["v1"]["digests"]:
            fail("FM over the zlib file took other batches than over the uncompressed file")
        # the same rows as libsvm: one file, 4 files (a directory, a regex)
        # and a #cachefile read for two epochs, each into FM
        text = criteo_text(idx, val, labels, "libsvm")
        svm = write_file(os.path.join(tmp, "criteo.libsvm"), text)
        parts = os.path.join(tmp, "parts")
        os.mkdir(parts)
        lines = text.splitlines(keepends=True)
        cut = np.linspace(0, len(lines), MULTI_FILES + 1).astype(int)
        for i in range(MULTI_FILES):
            write_file(os.path.join(parts, f"part-{i}"), b"".join(lines[cut[i]:cut[i + 1]]))
        text_runs = {}
        for name, u in (("one_file", svm), ("directory", parts),
                        ("regex", os.path.join(parts, "part-.*"))):
            text_runs[name], _, _ = drive(f"codec_fm {name}", fm(dev),
                                          ell_batches(u + "?format=libsvm", spec), dev, 0.5,
                                          digests=True)
            if text_runs[name]["digests"] != text_runs["one_file"]["digests"]:
                fail(f"FM over the libsvm {name} took other batches than over one file")
        cached = ell_batches(f"{svm}?format=libsvm#{os.path.join(tmp, 'svm.cache')}", spec)
        text_runs["cachefile_2_epochs"], _, _ = drive(
            "codec_fm cachefile", fm(dev), Epochs(cached, 2), dev, 0.5, digests=True)
        replays = cached.io_stats()["cache_epochs_replayed"]
        run = text_runs["cachefile_2_epochs"]
        half = run["steps"] // 2
        if replays != 1 or run["digests"] != text_runs["one_file"]["digests"] * 2:
            fail(f"the #cachefile's epochs ({replays} replayed) did not repeat the one file's "
                 "batches")
        run["cache_epochs_replayed"] = replays
        run["steps_per_epoch"] = half
    for s in (*fm_runs.values(), *text_runs.values()):
        del s["digests"]
    out["fm"] = fm_runs
    out["text_fm"] = text_runs
    per_step = lambda s: {k: n / s["steps"] for k, n in s["launches"].items()}  # noqa: E731
    want = per_step(sequential_fm)
    for name, s in (*fm_runs.items(), *text_runs.items()):
        got = per_step(s)
        if got != want or any(got[k] != 1 for k in KERNEL_NAMES):
            fail(f"codec FM {name}: launches per step {got}, sequential {want}")
    return out


def examples_phase(dev):
    """The example ports on the card at their own sizes, in a scratch
    directory: HIGGS and Criteo for two epochs (wall time, final loss,
    latest checkpoint), then the online FM (``online_example``)."""
    from dmlc_core_tpu_torch.examples import train_criteo_rec, train_higgs

    out = {}
    old = os.environ.get("DMLC_SGD_EPOCHS")
    os.environ["DMLC_SGD_EPOCHS"] = "2"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, mod, fname in (("train_higgs", train_higgs, "higgs.libsvm"),
                                     ("train_criteo_rec", train_criteo_rec, "criteo.rec")):
                t0 = time.perf_counter()
                res = mod.main([os.path.join(tmp, fname)], device=dev)
                wall = time.perf_counter() - t0
                losses = [x for x in res["losses"] if x is not None]
                if not losses or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                    fail(f"{name}: losses {res['losses']}")
                out[name] = {"wall_s": wall, "loss_first": losses[0],
                             "loss_last": losses[-1], "latest_step": res["latest_step"]}
        out["train_online_fm"] = online_example(dev)
    finally:
        if old is None:
            os.environ.pop("DMLC_SGD_EPOCHS")
        else:
            os.environ["DMLC_SGD_EPOCHS"] = old
    return out


def online_example(dev):
    """The online FM example in demo mode on the card (its generator on a
    thread, the FM following the live stream to EOS), in a scratch
    directory: wall s, rows, steps, final loss and K1-K4's launches."""
    from dmlc_core_tpu_torch.examples import train_online_fm
    from dmlc_core_tpu_torch.ops import _build

    old = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp  # the demo's stream directory goes here
        try:
            _build.reset_launches()
            t0 = time.perf_counter()
            res = train_online_fm.main([], device=dev)
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
        finally:
            tempfile.tempdir = old
    losses = res["losses"]
    if res["rows"] != 8000 or not losses or not all(np.isfinite(losses)):
        fail(f"train_online_fm: {res['rows']} rows, losses {losses}")
    if any(launches[k] != res["steps"] for k in KERNEL_NAMES):
        fail(f"train_online_fm: launches {launches} for {res['steps']} steps")
    return {"wall_s": wall, "rows": res["rows"], "steps": res["steps"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "follow_s": res["wall_s"], "launches": launches,
            "rotations_seen": res["io_stats"]["rotations_seen"]}


# the collective phase: COLL_WORKERS workers at full width take
# COLL_STEPS steps each over their part of a file of COLL_ROWS indexed
# rows (the shuffle phase's rows cut to half, for time), once over the
# tree and once over the ring; the example's drill runs
# DRILL_WORKERS workers over DRILL_ROWS rows (5 full batches a rank, so a
# span-aligned peer checkpoint exists at step 4 when DRILL_FAULTS kills
# rank 2 at the start of round 4) for two epochs, twice clean and once
# with the kill; HIGGS runs HIGGS_WORKERS workers
COLL_WORKERS, COLL_STEPS, COLL_LR, COLL_ROWS = 2, 16, 0.5, 1 << 17
DRILL_WORKERS, DRILL_ROWS = 3, 3 * 5 * 2048
DRILL_FAULTS = "kill_seq=4,kill_rank=2,kill_phase=start"
HIGGS_WORKERS = 2
# final params against the one-process simulation, across two clean runs
# and kill against clean: max |a - b| <= PARAM_REL · max|b| per tensor
# (tests/test_torch_slice.py's tolerance: a replay folds the ranks'
# gradients in another order, and a relaunched rank bootstraps from a
# peer's checkpoint). Across the ranks of one run: bit for bit.
PARAM_REL = 1e-4
JOB_TIMEOUT = 300

COLL_WORKER = '''
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.examples.train_criteo_rec import FlatGrads
from dmlc_core_tpu_torch.models import FactorizationMachine, sgd_update
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.collective import Collective

rec, out, path, steps, lr, dev, d, e, b, k = sys.argv[1:11]
steps, lr, d, e, b, k = int(steps), float(lr), int(d), int(e), int(b), int(k)
# the telemetry phase: a heartbeat every ``beat`` steps (0: none), and
# rank 0 reads the tracker's endpoint on ``metrics_port`` mid-run
beat, metrics_port = (int(a) for a in (sys.argv[11:13] or ("0", "0")))
dev = torch.device(dev)
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
w = RabitWorker()
rank = w.start()
coll = Collective(w)
model = FactorizationMachine(d, e, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
flat = FlatGrads(model.params())
uri = f"{{rec}}?index={{rec}}.idx&shuffle=batch&batch_size={{b}}&seed=1&epoch=0"
src = ell_batches(uri, BatchSpec(batch_size=b, max_nnz=k, value_dtype=np.float32),
                  part_index=rank, num_parts=w.world_size)
pipe = StagingPipeline(src, device=dev)
it = iter(pipe)
split = {{"grad": [], "d2h": [], "allreduce": [], "h2d_update": [], "step": []}}
losses = []
_build.reset_launches()
for _ in range(steps):
    batch = next(it)
    sync()
    t0 = time.perf_counter()
    loss, grads = model.loss_and_grads(batch)
    losses.append(float(loss))  # syncs the gradient
    t1 = time.perf_counter()
    host = flat.stage(grads)
    t2 = time.perf_counter()
    summed = coll.allreduce(host, "sum", path=path)
    t3 = time.perf_counter()
    sgd_update(model.params(), flat.unflatten(summed[:-1] / summed[-1]), lr)
    sync()
    t4 = time.perf_counter()
    for key, dt in (("grad", t1 - t0), ("d2h", t2 - t1), ("allreduce", t3 - t2),
                    ("h2d_update", t4 - t3), ("step", t4 - t0)):
        split[key].append(dt)
    n = len(losses)
    if beat and n % beat == 0:
        w.heartbeat()
    if rank == 0 and metrics_port and n == steps // 2:
        import subprocess
        from dmlc_core_tpu_torch.io import retry
        with retry.request(f"http://127.0.0.1:{{metrics_port}}/metrics.json?window=5",
                           timeout=30.0) as resp:
            mid = json.loads(resp.read().decode())
        top = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "top",
                              str(metrics_port), "--once", "--json", "--window", "5"],
                             capture_output=True, text=True, timeout=60)
        with open(f"{{out}}.mid.json", "w") as f:
            json.dump({{"metrics": mid, "top_rc": top.returncode, "top": top.stdout,
                       "top_err": top.stderr[-2000:]}}, f)
launches = dict(_build.launches)
drain_close(pipe, src)
np.savez(f"{{out}}.rank{{rank}}.npz",
         **{{n: p.detach().cpu().numpy() for n, p in model.params().items()}})
coll.close()
with open(f"{{out}}.rank{{rank}}.json", "w") as f:
    json.dump({{"rank": rank, "launches": launches, "split_s": split, "losses": losses,
               "vector_bytes": int(host.nbytes), "io_stats": coll.io_stats()}}, f)
if beat:
    w.heartbeat()  # the last one carries every round's counters
w.shutdown()
'''


def submit_job(args, env=None, timeout: float = JOB_TIMEOUT, cluster: str = "local"):
    """``python -m dmlc_core_tpu_torch.tracker.submit --cluster <cluster>
    --host-ip 127.0.0.1 args`` from the checkout's root, in a process
    group of its own that is killed whole past ``timeout``; fails on a
    non-zero exit. Returns (stdout, wall seconds)."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ, PYTHONPATH=repo, **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", cluster,
         "--host-ip", "127.0.0.1", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full_env, cwd=repo,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and every worker
        stdout, stderr = proc.communicate()
        fail(f"launched job {args[:6]} ran past {timeout} s:\n{stdout[-3000:]}\n"
             f"{stderr[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"launched job {args[:6]} exited {proc.returncode}:\n{stdout[-3000:]}\n"
             f"{stderr[-3000:]}")
    print(f"{cluster}: job {' '.join(args[:4])} ... done in {wall:.1f} s", file=sys.stderr)
    return stdout, wall


def rank_files(prefix: str, n: int):
    """Each rank's ``<prefix>.rank<r>.npz``, checked bit-identical across
    the ranks; returns rank 0's arrays."""
    models = [dict(np.load(f"{prefix}.rank{r}.npz")) for r in range(n)]
    for r in range(1, n):
        for key, v in models[0].items():
            if models[r][key].tobytes() != v.tobytes():
                fail(f"{prefix}: rank {r}'s {key} differs from rank 0's")
    return models[0]


def param_gap(got, want) -> dict:
    """max |got - want| per tensor, each beside PARAM_REL · max |want|."""
    return {k: {"max_abs": float(np.abs(got[k].astype(np.float64) - want[k]).max()),
                "tol": PARAM_REL * float(np.abs(want[k]).max())}
            for k in want if k != "gstep"}


def check_gap(gap: dict, what: str) -> None:
    for key, g in gap.items():
        if not g["max_abs"] <= g["tol"]:
            fail(f"{what}: {key} differs by {g['max_abs']} > {g['tol']}")


def collective_sim(rec, dev, path, steps, num_features, embed_dim, lr):
    """The full-width job in this process: each rank's gradient with the
    same kernels on its part's batches, ``[grads, 1]`` folded in
    ``reference_allreduce``'s order, divided by the contributor count and
    applied with ``sgd_update``; returns the final params."""
    from dmlc_core_tpu_torch.examples.train_criteo_rec import FlatGrads
    from dmlc_core_tpu_torch.models import FactorizationMachine, sgd_update
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
    from dmlc_core_tpu_torch.tracker.collective import reference_allreduce

    model = FactorizationMachine(num_features, embed_dim, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    flat = FlatGrads(model.params())
    uri = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    srcs = [ell_batches(uri, spec, part_index=r, num_parts=COLL_WORKERS)
            for r in range(COLL_WORKERS)]
    pipes = [StagingPipeline(s, device=dev) for s in srcs]
    its = [iter(p) for p in pipes]
    for _ in range(steps):
        vecs = [flat.stage(model.loss_and_grads(next(it))[1]).copy() for it in its]
        summed = reference_allreduce(vecs, "sum", path)
        sgd_update(model.params(), flat.unflatten(summed[:-1] / summed[-1]), lr)
    for p, s in zip(pipes, srcs):
        if not drain_close(p, s):
            fail("the simulation's staging pipeline did not close cleanly")
    return {k: p.detach().cpu().numpy() for k, p in model.params().items()}


def full_width_jobs(rec, dev, tmp, steps=COLL_STEPS, num_features=D, embed_dim=E):
    """COLL_WORKERS workers at full width through the launcher, once over
    each path: ranks bit-identical, every rank launching K1-K4 once a
    step, params within PARAM_REL of the one-process simulation; each
    rank's step split into gradient (device, synced), D2H, allreduce and
    H2D + update."""
    script = os.path.join(tmp, "coll_worker.py")
    with open(script, "w") as f:
        f.write(COLL_WORKER.format(repo=os.path.dirname(os.path.abspath(__file__))))
    out = {}
    finals = {}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for path in ("tree", "ring"):
        prefix = os.path.join(tmp, f"coll_{path}")
        _, wall = submit_job(["--num-workers", str(COLL_WORKERS), sys.executable, script, rec,
                              prefix, path, str(steps), str(COLL_LR), dev.type,
                              str(num_features), str(embed_dim), str(B), str(K)])
        finals[path] = rank_files(prefix, COLL_WORKERS)
        ranks = []
        for r in range(COLL_WORKERS):
            with open(f"{prefix}.rank{r}.json") as f:
                res = json.load(f)
            if any(res["launches"][k] != steps for k in KERNEL_NAMES):
                fail(f"collective {path} rank {r}: launches {res['launches']}, want {steps} each")
            for k in KERNEL_NAMES:
                launches[k] += res["launches"][k]
            if not all(np.isfinite(res["losses"])) or not (
                    np.mean(res["losses"][-4:]) < np.mean(res["losses"][:4])):
                fail(f"collective {path} rank {r}: losses {res['losses']}")
            split = {k: statistics.median(v) * 1e3 for k, v in res["split_s"].items()}
            ranks.append({
                "rank": r, "steps": steps, "launches": res["launches"],
                "median_ms": split,
                "allreduce_mb_per_s": res["vector_bytes"] / 1e6 / (split["allreduce"] / 1e3),
                "vector_bytes": res["vector_bytes"], "io_stats": res["io_stats"],
                "loss_first": res["losses"][0], "loss_last": res["losses"][-1]})
        sim = collective_sim(rec, dev, path, steps, num_features, embed_dim, COLL_LR)
        gap = param_gap(finals[path], sim)
        check_gap(gap, f"collective {path} against the one-process simulation")
        out[path] = {"wall_s": wall, "ranks": ranks, "vs_simulation": gap}
    # for two ranks both paths add the same two numbers, so tree against
    # ring is a clean-against-clean gap
    out["tree_vs_ring"] = param_gap(finals["ring"], finals["tree"])
    return out, launches


def drill(tmp):
    """The port's Criteo example with DRILL_WORKERS workers over the tree,
    ``--local-num-attempt 2``: twice clean, once with DRILL_FAULTS. Every
    run's ranks are bit-identical; the kill is relaunched and bootstraps
    from a peer; kill against clean within PARAM_REL, beside the
    clean-against-clean gap."""
    from dmlc_core_tpu_torch.examples import train_criteo_rec

    data = os.path.join(tmp, "drill.rec")
    train_criteo_rec.synth(data, DRILL_ROWS)
    out, finals = {}, {}
    for tag, faults in (("clean1", ""), ("clean2", ""), ("kill", DRILL_FAULTS)):
        prefix = os.path.join(tmp, f"drill_{tag}")
        stdout, wall = submit_job(
            ["--num-workers", str(DRILL_WORKERS), "--local-num-attempt", "2",
             sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_criteo_rec", data],
            env={"DMLC_SGD_PATH": "tree", "DMLC_SGD_OUT": prefix, "DMLC_SGD_EPOCHS": "2",
                 "DMLC_COLLECTIVE_FAULTS": faults})
        finals[tag] = rank_files(prefix, DRILL_WORKERS)
        boot = re.findall(r"bootstrapped from peer at version \d+[^\n]*", stdout)
        if (tag == "kill") != bool(boot):
            fail(f"drill {tag}: bootstrap lines {boot}")
        out[tag] = {"wall_s": wall, "gstep": int(finals[tag]["gstep"]), "bootstrap": boot}
    out["clean_vs_clean"] = param_gap(finals["clean2"], finals["clean1"])
    out["kill_vs_clean"] = param_gap(finals["kill"], finals["clean1"])
    check_gap(out["clean_vs_clean"], "drill clean against clean")
    check_gap(out["kill_vs_clean"], "drill kill against clean")
    return out


def higgs_launch(tmp):
    """The port's HIGGS example with HIGGS_WORKERS workers: each rank
    trains its shard for two epochs; task 0 writes the checkpoints."""
    from dmlc_core_tpu_torch.checkpoint import Checkpointer
    from dmlc_core_tpu_torch.examples import train_higgs

    data = os.path.join(tmp, "higgs.libsvm")
    train_higgs.synth(data)
    stdout, wall = submit_job(
        ["--num-workers", str(HIGGS_WORKERS), sys.executable, "-m",
         "dmlc_core_tpu_torch.examples.train_higgs", data], env={"DMLC_SGD_EPOCHS": "2"})
    losses = {}
    for r in range(HIGGS_WORKERS):
        got = [float(x) for x in re.findall(rf"rank {r} epoch \d: loss=([0-9.]+)", stdout)]
        if len(got) != 2 or not all(np.isfinite(got)) or not got[1] < got[0]:
            fail(f"HIGGS rank {r}: epoch losses {got}")
        losses[r] = got
    steps = Checkpointer(os.path.join(tmp, "higgs_ckpts_torch")).steps()
    if steps != [0, 1]:
        fail(f"HIGGS under the launcher left checkpoints {steps}")
    return {"wall_s": wall, "losses": losses, "checkpoints": steps}


def collective_phase(dev):
    """Multi-worker training through the port's launcher and collective:
    the full-width jobs, the example's chaos drill and HIGGS. Returns the
    ``{"collective": ...}`` line and the full-width workers' launches."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), COLL_ROWS, D))
        out, launches = full_width_jobs(rec, dev, tmp)
        out["rows"] = COLL_ROWS
        out["drill"] = drill(tmp)
        out["higgs"] = higgs_launch(tmp)
    return out, launches


# the telemetry phase: the Criteo FM pass with tracing off, on, and on
# with span histograms, alternated this many times; the full-width
# collective job under --trace-dir takes TELEMETRY_STEPS steps a rank
# over the ring, heartbeating every TELEMETRY_BEAT steps
TELEMETRY_REPEATS, TELEMETRY_STEPS, TELEMETRY_BEAT = 3, 8, 2
TRACE_MODES = (("off", False, False), ("on", True, False), ("on_hist", True, True))
# the staging stages whose histogram counts one sample a staged batch
BATCH_STAGES = ("dispatch_pack", "dispatch_put", "transfer_wait")


def registry_delta(before, after, kind, key, field=None):
    now, was = after[kind].get(key), before[kind].get(key)
    if field is not None:
        now, was = (now or {}).get(field, 0), (was or {}).get(field, 0)
    return (now or 0) - (was or 0)


def kernel_parts(name: str):
    """The device kernels one launch of kernel ``name`` runs, as
    substrings of their mangled names: the gradient scatters run their
    tile kernel, then their flush."""
    return (f"{name}_kernel",) + ((f"{name}_flush_kernel",) if name.endswith("_bwd") else ())


def trace_kernels(events):
    """Device µs of K1-K4 a launch in a torch Chrome trace: kernel events
    matched by substring of their mangled names; a scatter's µs add its
    tile kernel's and its flush's, and its events count the tile
    kernel's."""
    out = {}
    for name in KERNEL_NAMES:
        durs = [[e["dur"] for e in events if e.get("cat") == "kernel"
                 and part in e.get("name", "")] for part in kernel_parts(name)]
        n = len(durs[0])
        out[name] = {"events": n,
                     "us_mean": sum(sum(d) for d in durs) / n if n else None,
                     "us_median": sum(float(np.median(d)) for d in durs if d) if n else None}
    return out


def traced_fm_pass(rec, spec, make, dev, tmp, threads):
    """(a) The FM pass under ``profiler.trace``: the capture must hold
    K1-K4's device events and the ``dmlc:*`` spans."""
    from dmlc_core_tpu_torch.telemetry import tracing
    from dmlc_core_tpu_torch.utils import profiler

    tracing.set_enabled(True)
    tracing.reset()
    t0 = time.perf_counter()
    with profiler.trace(os.path.join(tmp, "profile"), device=dev) as cap:
        # CUPTI may miss kernels launched just after it starts: settle it
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        stats, _, _ = drive("telemetry_trace", make(), native_source(rec, spec, threads),
                            dev, 0.5, stop_after=32)
        torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with open(cap.path) as f:
        events = json.load(f)["traceEvents"]
    kern = trace_kernels(events)
    for name, k in kern.items():
        k["launches"] = stats["launches"][name]
        if not 0 < k["events"] <= k["launches"]:
            fail(f"the torch trace holds {k['events']} {name} device events, "
                 f"{k['launches']} were launched")
    spans = {}
    for e in events:
        if str(e.get("name", "")).startswith("dmlc:"):
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    if "dmlc:transfer_wait" not in spans:
        fail(f"the torch trace holds no dmlc:transfer_wait span: {sorted(spans)}")
    return {"steps": stats["steps"], "launches": stats["launches"],
            "capture_s": capture_s, "trace_mb": os.path.getsize(cap.path) / 1e6,
            "kernel_us": kern, "dmlc_spans": spans,
            "staging_thread_spans_in_capture": sorted(
                n for n in spans if n != "dmlc:transfer_wait")}


def tracing_cost(rec, spec, make, dev, threads):
    """(b) The same pass with tracing off, on, and on with span
    histograms, in turns: the registry against the pipeline's own
    counters, no event while off, and the traced pass's stall report."""
    from dmlc_core_tpu_torch.telemetry import default_registry, tracing
    from dmlc_core_tpu_torch.utils import profiler

    runs = {mode: [] for mode, _, _ in TRACE_MODES}
    report = None
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    try:
        for _ in range(TELEMETRY_REPEATS):
            for mode, on, hist in TRACE_MODES:
                tracing.set_enabled(on)
                profiler.enable_histograms(hist)
                tracing.reset()
                before = default_registry().snapshot()
                stats, _, _ = drive(f"telemetry_{mode}", make(),
                                    native_source(rec, spec, threads), dev, 0.5)
                after = default_registry().snapshot()
                for k in KERNEL_NAMES:
                    launches[k] += stats["launches"][k]
                rows = registry_delta(before, after, "counters", "staging.rows")
                if rows != stats["rows_staged"]:
                    fail(f"{mode}: registry staging.rows moved {rows}, "
                         f"the pipeline staged {stats['rows_staged']}")
                counts = {st: registry_delta(before, after, "histograms",
                                             f'staging.stage_seconds{{stage="{st}"}}', "count")
                          for st in (*BATCH_STAGES, "host_pull")}
                nb = stats["batches_staged"]
                if any(counts[st] != nb for st in BATCH_STAGES) or counts["host_pull"] != nb + 1:
                    fail(f"{mode}: stage histogram counts {counts}, {nb} batches")
                events = tracing.stats()["total_events"]
                if not on and events:
                    fail(f"tracing off recorded {events} events")
                spans = registry_delta(before, after, "histograms",
                                       'profiler.span_seconds{span="dmlc:transfer_wait"}', "count")
                # the consumer's span also covers the wait for the end of
                # the stream, which no stage histogram counts
                if hist and spans != nb + 1:
                    fail(f"{mode}: {spans} transfer_wait span samples, {nb} batches")
                runs[mode].append({k: stats[k] for k in (
                    "staged_rows_per_sec", "step_ms", "wait_share", "steps")}
                    | {"events": events, "span_hist_samples": spans,
                       "stage_ms_per_batch": {st: v / nb * 1e3 for st, v in
                                              stats["stage_seconds"].items()}})
                if mode == "on" and report is None:
                    report = tracing.stall_report(tracing.to_chrome_trace(), gap_ms=1.0)
    finally:
        tracing.set_enabled(None)
        profiler.enable_histograms(None)
        tracing.reset()

    def spread(mode, key):
        xs = [r[key] for r in runs[mode]]
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    summary = {mode: {k: spread(mode, k) for k in ("staged_rows_per_sec", "step_ms",
                                                    "wait_share")} for mode in runs}
    for mode in runs:
        summary[mode]["stage_ms_per_batch"] = {
            st: statistics.median(r["stage_ms_per_batch"][st] for r in runs[mode])
            for st in runs[mode][0]["stage_ms_per_batch"]}
    off = summary["off"]["staged_rows_per_sec"]["median"]
    for mode in ("on", "on_hist"):
        summary[mode]["rows_per_sec_cost"] = 1 - summary[mode]["staged_rows_per_sec"][
            "median"] / off
    stall = {
        "threads": {name: {k: t[k] for k in ("busy_seconds", "idle_seconds", "wall_seconds")}
                    for name, t in report["threads"].items()},
        "busy_seconds_by_stage": report["busy_seconds_by_stage"],
        "stall_seconds_by_stage": report["stall_seconds_by_stage"],
        "starvation_gaps_over_1ms": len(report["starvation_gaps"]),
    }
    return {"runs": runs, "summary": summary, "stall_report": stall}, launches


def dispatch_alone(rec, spec, dev, n: int = 64):
    """The transfer thread's two stages alone on this thread, on one
    producer batch: the copy into a pinned slot (``dispatch_pack``) and
    the side-stream host→device copy's enqueue (``dispatch_put``), each
    after the previous copy has completed. Against the same stages
    inside the pipeline, the difference is what the other threads
    (the step, the producer) cost them: the GIL and the memory bus."""
    from dmlc_core_tpu_torch.staging.pipeline import _PinnedSlot

    src = native_source(rec, spec)
    packed = next(iter(src)).packed.copy()
    src.close()
    slot, stream = _PinnedSlot(), torch.cuda.Stream(dev)
    pack, put = [], []
    for _ in range(n):
        slot.wait()
        t0 = time.perf_counter()
        buf = slot.get(packed.nbytes)
        buf.copy_(torch.from_numpy(packed))
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            u8 = torch.empty(buf.numel(), dtype=torch.uint8, device=dev)
            u8.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        slot.event = event
        put.append(time.perf_counter() - t1)
        pack.append(t1 - t0)
    torch.cuda.synchronize()
    return {"bytes": int(packed.nbytes), "dispatch_pack_ms": statistics.median(pack) * 1e3,
            "dispatch_put_ms": statistics.median(put) * 1e3,
            "pack_gb_per_s": packed.nbytes / statistics.median(pack) / 1e9}


def traced_job(dev, tmp):
    """(c) COLL_WORKERS workers at full width over the ring under
    ``submit --trace-dir`` with DMLC_METRICS_PORT and DMLC_METRICS_REPORT:
    the report's per-rank collective counters equal each rank's
    io_stats(); ``tools trace merge`` holds all three processes with flow
    arrows between the ranks; ``tools top`` and ``tools info`` run."""
    import socket

    rec = write_indexed(os.path.join(tmp, "tele.rec"),
                        *criteo_data(np.random.default_rng(5), 1 << 16, D))
    script = os.path.join(tmp, "coll_worker.py")
    with open(script, "w") as f:
        f.write(COLL_WORKER.format(repo=os.path.dirname(os.path.abspath(__file__))))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    prefix, traces = os.path.join(tmp, "tele"), os.path.join(tmp, "traces")
    report_path = os.path.join(tmp, "report.json")
    _, wall = submit_job(
        ["--num-workers", str(COLL_WORKERS), "--trace-dir", traces, sys.executable, script,
         rec, prefix, "ring", str(TELEMETRY_STEPS), str(COLL_LR), dev.type, str(D), str(E),
         str(B), str(K), str(TELEMETRY_BEAT), str(port)],
        env={"DMLC_METRICS_PORT": str(port), "DMLC_METRICS_REPORT": report_path,
             "DMLC_TS_INTERVAL": "0.5", "DMLC_TRACE": "on"})
    rank_files(prefix, COLL_WORKERS)
    with open(report_path) as f:
        report = json.load(f)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    ranks = {}
    for r in range(COLL_WORKERS):
        with open(f"{prefix}.rank{r}.json") as f:
            res = json.load(f)
        if any(res["launches"][k] != TELEMETRY_STEPS for k in KERNEL_NAMES):
            fail(f"traced job rank {r}: launches {res['launches']}")
        for k in KERNEL_NAMES:
            launches[k] += res["launches"][k]
        got = report["per_rank"][str(r)]["counters"]
        io = res["io_stats"]
        seen = {"bytes": got.get("tracker.collective.bytes"),
                "ring_rounds": got.get('tracker.collective.rounds{path="ring"}'),
                "recoveries": got.get("tracker.collective.recoveries", 0)}
        want = {"bytes": io["bytes"], "ring_rounds": io["rounds"]["ring"],
                "recoveries": io["recoveries"]}
        if seen != want:
            fail(f"traced job rank {r}: the tracker's report {seen}, io_stats {want}")
        ranks[r] = {"report": seen, "step_ms": statistics.median(res["split_s"]["step"]) * 1e3}
    with open(f"{prefix}.mid.json") as f:
        mid = json.load(f)
    if mid["top_rc"] != 0:
        fail(f"tools top --once --json exited {mid['top_rc']}: {mid['top_err']}")
    top = json.loads(mid["top"])
    win = mid["metrics"]["windowed"]["per_rank"]
    if not {"0", "1"} <= set(win):
        fail(f"/metrics.json?window=5 mid-run holds ranks {sorted(win)}")
    files = sorted(os.path.join(traces, f) for f in os.listdir(traces)
                   if f.startswith("dmlc-trace-"))
    merged_path = os.path.join(tmp, "merged.json")
    tool = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "trace", "merge",
                           *files, "-o", merged_path], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    if tool.returncode != 0:
        fail(f"tools trace merge exited {tool.returncode}: {tool.stderr[-2000:]}")
    with open(merged_path) as f:
        evs = json.load(f)["traceEvents"]
    labels = {e["pid"]: e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    spans_by = {}
    for e in evs:
        if e["ph"] == "X":
            spans_by.setdefault(labels.get(e["pid"], "?"), set()).add(e["name"])
    want_procs = {"tracker", "worker0", "worker1"}
    if not want_procs <= {lb.split()[0] for lb in spans_by}:
        fail(f"the merged trace holds spans of {sorted(spans_by)}")
    starts = {e["id"]: labels.get(e["pid"]) for e in evs if e["ph"] == "s"}
    between = sum(1 for e in evs if e["ph"] == "f" and e["id"] in starts
                  and starts[e["id"]] != labels.get(e["pid"])
                  and str(starts[e["id"]]).startswith("worker")
                  and str(labels.get(e["pid"])).startswith("worker"))
    if not between:
        fail("the merged trace has no flow arrow between the ranks")
    info = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "info"],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if info.returncode != 0:
        fail(f"tools info exited {info.returncode}: {info.stderr[-2000:]}")
    build = json.loads(info.stdout)
    if not build["torch"]["devices"] or build["kernels"]["library"] is None:
        fail(f"tools info reports no device or no built kernels: {build['torch']}")
    report_rep = tracing_report(merged_path)
    return {"wall_s": wall, "steps": TELEMETRY_STEPS, "ranks": ranks,
            "trace_files": len(files), "processes": sorted(spans_by),
            "flows_between_ranks": between,
            "mid_run_window": {r: v["derived"] for r, v in win.items()},
            "top": top["ranks"], "info_devices": build["torch"]["devices"],
            "merged_stall": report_rep}, launches


def tracing_report(path):
    """Per-stage stall seconds of a merged trace (``tools trace report``)."""
    from dmlc_core_tpu_torch.telemetry import tracing

    rep = tracing.stall_report(tracing.load_trace(path), gap_ms=1.0)
    return {"stall_seconds_by_stage": rep["stall_seconds_by_stage"],
            "critical_path": {p: {"wall_seconds": c["wall_seconds"],
                                  "bottleneck_thread": c["bottleneck_thread"]}
                              for p, c in rep["critical_path"].items()}}


def telemetry_phase(dev, kernels):
    """The Criteo-width FM path with telemetry on: (a) under
    ``profiler.trace``, (b) tracing off / on / on with histograms in
    turns, (c) the traced, scraped full-width collective job. Returns the
    ``{"telemetry": ...}`` line and the phase's launches."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        idx, val, labels = criteo_data(rng, N_BATCHES * B, D)
        rec = write_file(os.path.join(tmp, "criteo.rec"), rowrec_bytes(idx, val, labels),
                         SLICE_REPEATS)
        spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
        threads = picked_threads(N_BATCHES * B * SLICE_REPEATS, B)
        drive("telemetry_warm", make(), native_source(rec, spec, threads), dev, 0.5)
        out = {"trace": traced_fm_pass(rec, spec, make, dev, tmp, threads)}
        for name, k in out["trace"]["kernel_us"].items():
            k["kernel_phase_us"] = next(r["ms"] for r in kernels if r["name"] == name) * 1e3
        out["cost"], launches = tracing_cost(rec, spec, make, dev, threads)
        out["cost"]["dispatch_alone"] = dispatch_alone(rec, spec, dev)
        out["job"], job_launches = traced_job(dev, tmp)
    for k in KERNEL_NAMES:
        launches[k] += out["trace"]["launches"][k] + job_launches[k]
    return out, launches


def ptxas_summary(log: str):
    """Registers, spill bytes and shared memory of each compiled kernel
    instance, from nvcc's ``-Xptxas -v`` output."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads\s+ptxas info\s+: Used (\d+) registers"
        r"(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", log, re.S):
        name, stores, loads, regs, smem = m.groups()
        short = re.search(r"\d((?:ell_matvec|fm_pair|empty)\w*?_kernel(?:I\w*?E)?)(?:E*v|E)", name)
        out.append({"function": short.group(1) if short else name,
                    "registers": int(regs), "spill_bytes": int(stores) + int(loads),
                    "smem_bytes": int(smem or 0)})
    return out


# the shards phase: tracker-leased micro-shards of SHARD_ROWS indexed
# rows (the shuffle phase's rows cut to a quarter, for time; shuffle=batch),
# SHARD_OVERSPLIT a worker; (a) one
# worker in this process, in turns with a static drain of the same file,
# (b) SHARD_WORKERS workers through the launcher beside the same job over
# static parts, (c) the same with --tracker-journal and the tracker
# SIGKILLed once each rank has SHARD_PAUSE micro-shards recorded: at a
# shard boundary with no lease open, and again with each rank holding the
# lease after them, (d) the Criteo example. SHARD_TTL (s) is above the
# drill's outage; so is SHARD_OPEN_TTL, the open-lease drill's, which
# also bounds the stall there: after the replay re-serves a shard, a rank
# left with no lease to take blocks its trainer, and through the lockstep
# allreduce the holder of the last shard, until that lease expires
SHARD_OVERSPLIT, SHARD_WORKERS, SHARD_PAUSE, SHARD_TTL, SHARD_LR = 4, 2, 2, 120, 0.5
SHARD_ROWS = 1 << 16
SHARD_OPEN_TTL = 30
SHARD_EXAMPLE_ROWS = 8 * 2 * 2048  # 2 batches a micro-shard at 2 workers x 4

SHARD_WORKER = """
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.examples.train_criteo_rec import FlatGrads
from dmlc_core_tpu_torch.models import FactorizationMachine, sgd_update
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.collective import Collective

# placement: "dynamic" (leased micro-shards) or "static" (part rank of
# world); drill: "none", "boundary" (pause after `pause` recorded
# micro-shards, no lease open) or "open" (pause holding the lease after them)
rec, out, lr, pause = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
dev, placement, drill = torch.device(sys.argv[5]), sys.argv[6], sys.argv[7]
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
w = RabitWorker()
rank = w.start()
coll = Collective(w)
model = FactorizationMachine({d}, {e}, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
flat = FlatGrads(model.params())
uri = f"{{rec}}?index={{rec}}.idx&shuffle=batch&batch_size={b}&seed=1&epoch=0"
spec = BatchSpec(batch_size={b}, max_nnz={k}, value_dtype=np.float32)
if placement == "dynamic":
    src = ell_batches(uri + "&dynamic_shards=1", spec)
    split = src._split  # the DynamicShardSource the producer reads
else:
    src = ell_batches(uri, spec, part_index=rank, num_parts=w.world_size)
    split = None
leases, recorded, digests = [], [], []
paused = False

def hold():
    # the drill: hold here until the tracker was killed and the resume
    # file appears
    global paused
    paused = True
    open(f"{{out}}.rank{{rank}}.paused", "w").close()
    t0 = time.monotonic()
    while not os.path.exists(f"{{out}}.resume"):
        if time.monotonic() - t0 > 300:
            raise RuntimeError("no resume after the pause")
        time.sleep(0.02)
    leases.append({{"resumed": time.time()}})

def on_lease(shard, num_shards):
    leases.append({{"shard": shard, "num_shards": num_shards, "wall": time.time()}})
    if drill == "open" and not paused and len(recorded) == pause:
        hold()

def on_done(shard, status):
    recorded.append((shard, status))
    if drill == "boundary" and not paused and len(recorded) == pause:
        hold()

if split is not None:
    split.on_lease, split.on_shard_done = on_lease, on_done

class Digests:
    ring_slots = src.ring_slots

    def __iter__(self):
        for batch in src:
            shard = None if split is None else split.current_shard
            digests.append((shard, hashlib.blake2b(batch.packed).hexdigest()))
            yield batch

pipe = StagingPipeline(Digests(), device=dev)
it = iter(pipe)
losses, step_s, rounds = [], [], 0
_build.reset_launches()
t_start = time.perf_counter()
while True:
    batch = next(it, None)
    sync()
    t0 = time.perf_counter()
    grads = None
    if batch is not None:
        loss, grads = model.loss_and_grads(batch)
        losses.append(float(loss))
    summed = coll.allreduce(flat.stage(grads), "sum", path="ring")
    rounds += 1
    n = float(summed[-1])
    if n == 0:
        break
    sgd_update(model.params(), flat.unflatten(summed[:-1] / n), lr)
    sync()
    if batch is not None:
        step_s.append(time.perf_counter() - t0)
wall = time.perf_counter() - t_start
launches = dict(_build.launches)
stats = src.io_stats()
drain_close(pipe, src)
np.savez(f"{{out}}.rank{{rank}}.npz",
         **{{n: p.detach().cpu().numpy() for n, p in model.params().items()}})
coll.close()
with open(f"{{out}}.rank{{rank}}.json", "w") as f:
    json.dump({{"rank": rank, "launches": launches, "losses": losses, "step_s": step_s,
               "rounds": rounds, "wall_s": wall, "rows": len(losses) * {b},
               "leases": leases, "recorded": recorded, "digests": digests,
               "io_stats": stats}}, f)
w.shutdown()
"""


def restore_env(old) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def static_part_digests(rec: str, spec, m: int, keep=None):
    """Each static part (i, m) of the ``shuffle=batch`` read: its batches'
    digests in order, from the same native producer; with ``keep`` (a
    dict) a copy of each batch is kept there under its digest."""
    from dmlc_core_tpu_torch.staging.batcher import alloc_ell_slot, ell_batch
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    uri = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    out = []
    for i in range(m):
        src = ell_batches(uri, spec, part_index=i, num_parts=m)
        part = []
        for b in src:
            h = hashlib.blake2b(b.packed).hexdigest()
            part.append(h)
            if keep is not None:
                packed, views = alloc_ell_slot(spec)
                np.copyto(packed, b.packed)
                keep[h] = ell_batch(packed, views, b.n_valid)
        out.append(part)
        src.close()
    return out


def shard_replay(dev, batches, trained):
    """A 2-worker job of the shards phase in this process, on the card:
    round ``i`` takes each rank's ``i``-th trained batch (``trained[r]``,
    digests in the order rank ``r`` trained them; ``batches`` maps a
    digest to the batch) and its gradients with the same kernels; the
    contributors' gradients are summed (two addends: the ring's fold
    order gives the same f32 sum), divided by their count and applied
    with ``sgd_update``; the job ends on the round nobody contributes
    to. Returns the params, the rounds and the replay's seconds."""
    from dmlc_core_tpu_torch.models import FactorizationMachine, sgd_update
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    t0 = time.perf_counter()
    model = FactorizationMachine(D, E, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    pipes = [StagingPipeline([batches[h] for h in hs], device=dev) for hs in trained]
    its = [iter(p) for p in pipes]
    rounds = 0
    while True:
        grads = [model.loss_and_grads(b)[1] for b in (next(it, None) for it in its)
                 if b is not None]
        rounds += 1
        if not grads:
            break
        summed = {k: sum(g[k] for g in grads) for k in grads[0]}
        sgd_update(model.params(), {k: v / len(grads) for k, v in summed.items()}, SHARD_LR)
    for p in pipes:
        if not drain_close(p):
            fail("the replay's staging pipeline did not close cleanly")
    params = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    return params, rounds, time.perf_counter() - t0


def one_worker_shards(rec: str, spec, dev, make):
    """(a) One worker and a port tracker in this process: FM SGD over the
    leased micro-shards, traced; each shard's batches equal the static
    part's, the gather path takes every batch, the ledger holds each
    shard once, and K1-K4 launch once a step. In turns with it, the same
    pass over a static drain of the file: static, leased, static, leased
    (the second leased pass reads epoch 1, a fresh ledger, and is timed
    only)."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.telemetry import tracing
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    m = SHARD_OVERSPLIT
    static = static_part_digests(rec, spec, m)
    keys = ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_TASK_ID", "DMLC_SHARD_RANK",
            "DMLC_SHARD_OVERSPLIT")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["DMLC_SHARD_OVERSPLIT"] = str(m)
    os.environ.pop("DMLC_SHARD_RANK", None)
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    os.environ.update({"DMLC_TRACKER_URI": "127.0.0.1", "DMLC_TRACKER_PORT": str(tracker.port),
                       "DMLC_TASK_ID": "0"})
    turns = {"static": [], "leased": []}
    tracing.set_enabled(True)
    try:
        for epoch in (0, 1):
            uri = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch={epoch}"
            run, _, _ = drive(f"shards_static_{epoch}", make(), ell_batches(uri, spec), dev,
                              SHARD_LR)
            turns["static"].append(run)
            src = ell_batches(uri + "&dynamic_shards=1", spec)
            leased = []
            src._split.on_lease = lambda shard, n: leased.append(shard)
            tracing.reset()
            run, _, _ = drive(f"shards_one_worker_{epoch}", make(), src, dev, SHARD_LR,
                              digests=epoch == 0)
            turns["leased"].append(run)
            if epoch == 0:
                stats, first_leased = run, leased
                events = tracing.to_chrome_trace()["traceEvents"]
                io = src.io_stats()
        summary = tracker.shards.summary()
    finally:
        tracing.set_enabled(None)
        restore_env(old)
        tracker.close()
        if not tracker.join(timeout=60):
            fail("the shards phase's tracker did not stop")
    leased = first_leased
    waits = [e["dur"] for e in events
             if e.get("name") == "dmlc:shard_lease_wait" and e.get("ph") == "X"]
    if sorted(leased) != list(range(m)):
        fail(f"one worker leased {leased}, want each of {m} micro-shards once")
    at = 0
    for shard in leased:
        got = stats["digests"][at:at + len(static[shard])]
        if got != static[shard]:
            fail(f"micro-shard {shard}'s batches differ from the static part ({shard}, {m})")
        at += len(static[shard])
    if at != stats["steps"]:
        fail(f"{stats['steps']} steps, the static parts hold {at} batches")
    if not (io["mode"].startswith("dynamic:") and io.get("gather_fallback_batches") == 0
            and io.get("gather_batches", 0) > 0):
        fail(f"the leased drain did not take the gather path alone: {io}")
    if not (summary["completed"] == summary["granted"] == 2 * m
            and summary["duplicates"] == 0):
        fail(f"one worker's ledger over 2 epochs: {summary}")
    if any(stats["launches"][k] != stats["steps"] for k in KERNEL_NAMES):
        fail(f"one worker: launches {stats['launches']} for {stats['steps']} steps")
    if len(waits) < m:
        fail(f"the flight recorder holds {len(waits)} dmlc:shard_lease_wait spans")
    del stats["digests"]
    pick = ("step_ms", "staged_rows_per_sec", "wait_share", "wall_s")
    launches = {k: sum(r["launches"][k] for runs in turns.values() for r in runs)
                for k in KERNEL_NAMES}
    return {"leased": leased, "run": stats, "io_stats": io, "ledger": summary,
            "launches": launches,
            "shard_lease_wait_s": sum(waits) / 1e6, "shard_lease_wait_spans": len(waits),
            "turns": {t: [{k: r[k] for k in pick} for r in runs]
                      for t, runs in turns.items()}}


def tracker_pid(journal: str):
    """The pid of the supervised tracker process serving ``journal``."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--journal" in argv and journal.encode() in argv:
            return int(pid)
    return None


def drill_kill(proc, prefix: str, jdir: str):
    """(c) Wait until every rank paused (after SHARD_PAUSE recorded
    micro-shards, with or without the next lease held), check the WAL
    holds 3 or more shard_done records, SIGKILL the supervised tracker
    and resume the ranks."""
    import signal

    from dmlc_core_tpu_torch.tracker.journal import inspect_journal

    deadline = time.monotonic() + JOB_TIMEOUT
    while not all(os.path.exists(f"{prefix}.rank{r}.paused") for r in range(SHARD_WORKERS)):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError("the drill's ranks never reached their pause")
        time.sleep(0.05)
    wal = inspect_journal(jdir)
    kinds = [r["kind"] for r in wal["records"]]
    pid = tracker_pid(jdir)
    if kinds.count("shard_done") < 3 or pid is None:
        raise RuntimeError(f"drill: {kinds.count('shard_done')} shard_done in the WAL, "
                           f"tracker pid {pid}")
    kill = {"wall": time.time(), "wal_shard_done": kinds.count("shard_done"),
            "wal_shard_grant": kinds.count("shard_grant"), "wal_records": len(kinds)}
    os.kill(pid, signal.SIGKILL)
    open(f"{prefix}.resume", "w").close()
    return kill


def shard_job(rec: str, dev, tmp: str, tag: str, static, batches,
              placement: str = "dynamic", drill: str = "none"):
    """(b) SHARD_WORKERS workers through the launcher over the leased
    micro-shards, or over static parts with ``placement="static"``; with
    ``drill`` (c), under ``--tracker-journal`` with the tracker SIGKILLed
    while the ranks pause at a shard boundary ("boundary") or holding a
    lease ("open"). Ranks bit-identical and within PARAM_REL of a
    one-process replay of the batches each rank trained; K1-K4 once a
    trained batch; the loss falling. Leased: every micro-shard's batches
    equal the static part's, the ledger completing each shard once, and
    every batch trained once, except that a lease the replay expired and
    served again is drained again in full (its second done answers
    duplicate): trained = the static parts + the re-served shards'. The
    drill: one relaunch from the journal, with the recovery in the
    report. ``static``: the static (i, M) parts' digests, M = the
    micro-shard count, or the (r, SHARD_WORKERS) parts' for a static job;
    ``batches``: their batches by digest."""
    import signal
    from collections import Counter

    journal = drill != "none"
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "shard_worker.py")
    with open(script, "w") as f:
        f.write(SHARD_WORKER.format(repo=repo, d=D, e=E, b=B, k=K))
    prefix = os.path.join(tmp, f"shards_{tag}")
    report_path = prefix + ".report.json"
    jdir = os.path.join(tmp, f"journal_{tag}")
    ttl = SHARD_OPEN_TTL if drill == "open" else SHARD_TTL
    args = ["--num-workers", str(SHARD_WORKERS), "--shard-oversplit", str(SHARD_OVERSPLIT),
            "--shard-lease-ttl", str(ttl)]
    if journal:
        args += ["--tracker-journal", jdir]
    args += [sys.executable, script, rec, prefix, str(SHARD_LR), str(SHARD_PAUSE), dev.type,
             placement, drill]
    env = dict(os.environ, PYTHONPATH=repo, DMLC_METRICS_REPORT=report_path)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--host-ip", "127.0.0.1", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=repo,
        start_new_session=True)
    kill = None
    try:
        if journal:
            kill = drill_kill(proc, prefix, jdir)
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except (subprocess.TimeoutExpired, RuntimeError) as e:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        fail(f"shards {tag}: {e}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"shards {tag} exited {proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    params = rank_files(prefix, SHARD_WORKERS)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    ranks, trained, losses, per_rank = [], [], [], []
    leases = Counter()
    for r in range(SHARD_WORKERS):
        with open(f"{prefix}.rank{r}.json") as f:
            res = json.load(f)
        n = len(res["losses"])
        if any(res["launches"][k] != n for k in KERNEL_NAMES):
            fail(f"shards {tag} rank {r}: launches {res['launches']} for {n} batches")
        for k in KERNEL_NAMES:
            launches[k] += res["launches"][k]
        if not all(np.isfinite(res["losses"])):
            fail(f"shards {tag} rank {r}: losses {res['losses']}")
        losses.append(res["losses"])
        trained += [tuple(d) for d in res["digests"]]
        per_rank.append([h for _, h in res["digests"]])
        leases.update(x["shard"] for x in res["leases"] if "shard" in x)
        resumed = [x["resumed"] for x in res["leases"] if "resumed" in x]
        after = [x["wall"] for x in res["leases"]
                 if "shard" in x and resumed and x["wall"] >= resumed[0]]
        ranks.append({"rank": r, "micro_shards": [x["shard"] for x in res["leases"]
                                                  if "shard" in x],
                      "batches": n, "rows_per_sec": res["rows"] / res["wall_s"],
                      "step_ms": statistics.median(res["step_s"]) * 1e3,
                      "rounds": res["rounds"], "wall_s": res["wall_s"],
                      "lease_wait_s": res["io_stats"].get("lease_wait_secs"),
                      "renews_lost": res["io_stats"].get("renews_lost"),
                      "first_lease_after_resume": min(after) if after else None,
                      "loss_first": res["losses"][0], "loss_last": res["losses"][-1]})
    for r, ls in enumerate(losses):
        if not np.mean(ls[-4:]) < np.mean(ls[:4]):
            fail(f"shards {tag} rank {r}: the loss did not fall: {ls}")
    want, rounds, replay_s = shard_replay(dev, batches, per_rank)
    gap = param_gap(params, want)
    check_gap(gap, f"shards {tag} against the one-process replay")
    if any(x["rounds"] != rounds for x in ranks):
        fail(f"shards {tag}: ranks took {[x['rounds'] for x in ranks]} rounds, "
             f"the replay {rounds}")
    out = {"wall_s": wall, "ranks": ranks, "batches": len(trained),
           "replay_gap": gap, "replay_rounds": rounds, "replay_s": replay_s}
    if placement == "static":
        if per_rank != static:
            fail(f"shards {tag}: a rank's batches differ from its static part")
        return out, launches
    m = SHARD_OVERSPLIT * SHARD_WORKERS
    with open(report_path) as f:
        report = json.load(f)
    ledger = report.get("shards") or {}
    reserved = sum(leases.values()) - m
    if sorted(leases) != list(range(m)) or reserved < 0:
        fail(f"shards {tag}: the ranks leased {dict(leases)}")
    want_trained = Counter()
    for i, part in enumerate(static):
        want_trained.update(part * leases[i])
        if leases[i] == 1 and [h for s, h in trained if s == i] != part:
            fail(f"shards {tag}: micro-shard {i}'s batches differ from the static part")
    if Counter(h for _, h in trained) != want_trained:
        fail(f"shards {tag}: the ranks trained {len(trained)} batches, not the "
             f"{sum(map(len, static))} static batches once and each re-served shard's again")
    # each served lease is a grant; a re-served shard's second done is a
    # duplicate; every shard completes once
    if not (ledger.get("completed") == m and ledger.get("granted") == m + reserved
            and ledger.get("duplicates") == reserved):
        fail(f"shards {tag}: the tracker's ledger {ledger} with {reserved} re-served")
    out.update({"ledger": ledger, "re_served_shards": reserved,
                "batches_trained_twice": len(trained) - sum(map(len, static))})
    if not journal:
        if reserved:
            fail(f"shards {tag}: {reserved} micro-shards served twice with no fault")
        return out, launches
    relaunches = len(re.findall(r"relaunching on port \d+ from journal", stderr))
    rec_sec = report.get("recovery")
    firsts = [x["first_lease_after_resume"] for x in ranks
              if x["first_lease_after_resume"] is not None]
    if relaunches != 1 or not rec_sec or not firsts:
        fail(f"drill {tag}: {relaunches} relaunches, recovery {rec_sec}, leases after "
             f"the kill {firsts}:\n{stderr[-3000:]}")
    expired = rec_sec.get("leases_expired", 0)
    if drill == "boundary" and (expired or reserved):
        fail(f"drill {tag}: no lease was open at the kill, yet {expired} expired and "
             f"{reserved} re-served")
    if drill == "open" and not expired >= 1:
        fail(f"drill {tag}: the ranks held leases at the kill, recovery {rec_sec}")
    out.update({"kill": kill, "relaunches": relaunches, "recovery": rec_sec,
                "outage_s": min(firsts) - kill["wall"]})
    return out, launches


def shard_example(tmp: str):
    """(d) The port's Criteo example with DMLC_DYNAMIC_SHARDS=1, 2
    workers, 2 epochs: exit 0, each epoch's micro-shards done once."""
    from dmlc_core_tpu_torch.examples import train_criteo_rec

    data = os.path.join(tmp, "example.rec")
    train_criteo_rec.synth(data, SHARD_EXAMPLE_ROWS)
    report = os.path.join(tmp, "example.report.json")
    prefix = os.path.join(tmp, "example")
    stdout, wall = submit_job(
        ["--num-workers", "2", "--shard-oversplit", str(SHARD_OVERSPLIT), sys.executable,
         "-m", "dmlc_core_tpu_torch.examples.train_criteo_rec", data],
        env={"DMLC_DYNAMIC_SHARDS": "1", "DMLC_SGD_EPOCHS": "2", "DMLC_SGD_OUT": prefix,
             "DMLC_METRICS_REPORT": report})
    rank_files(prefix, 2)
    with open(report) as f:
        ledger = json.load(f)["shards"]
    m = 2 * SHARD_OVERSPLIT
    if not (ledger["n_shards"] == m and ledger["epochs"] == [0, 1]
            and ledger["completed"] == ledger["granted"] == 2 * m
            and ledger["duplicates"] == 0):
        fail(f"the Criteo example over leased micro-shards: ledger {ledger}")
    losses = [float(x) for x in re.findall(r"rank \d epoch \d: loss=([0-9.]+)", stdout)]
    if len(losses) != 4 or not all(np.isfinite(losses)):
        fail(f"the Criteo example over leased micro-shards: epoch losses {losses}")
    return {"wall_s": wall, "ledger": ledger, "epoch_losses": losses}


def shards_phase(dev):
    """Tracker-leased micro-shards at the Criteo width: (a) one worker
    beside a static drain, (b) 2 workers beside the same job over static
    parts, (c) the tracker-kill drill at a shard boundary and with leases
    open, (d) the example. Returns the ``{"shards": ...}`` line and the
    launches of (a), (b) and (c)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    jobs = (("static", "static", "none"), ("clean", "dynamic", "none"),
            ("drill", "dynamic", "boundary"), ("drill_open", "dynamic", "open"))
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), SHARD_ROWS, D))
        out = {"rows": SHARD_ROWS, "oversplit": SHARD_OVERSPLIT,
               "one_worker": one_worker_shards(rec, spec, dev, make)}
        launches = dict(out["one_worker"]["launches"])
        batches = {}
        parts = {"static": static_part_digests(rec, spec, SHARD_WORKERS, batches),
                 "dynamic": static_part_digests(rec, spec, SHARD_OVERSPLIT * SHARD_WORKERS,
                                                batches)}
        for tag, placement, drill in jobs:
            out[tag], job_launches = shard_job(rec, dev, tmp, tag, parts[placement],
                                               batches, placement, drill)
            for k in KERNEL_NAMES:
                launches[k] += job_launches[k]
        del batches
        out["example"] = shard_example(tmp)
    tags = [t for t, _, _ in jobs]
    out["summary"] = {
        "rows_per_sec_per_rank": {t: [r["rows_per_sec"] for r in out[t]["ranks"]]
                                  for t in tags},
        "step_ms_per_rank": {t: [r["step_ms"] for r in out[t]["ranks"]] for t in tags},
        "one_worker_step_ms": {t: [r["step_ms"] for r in runs]
                               for t, runs in out["one_worker"]["turns"].items()},
        "shard_lease_wait_s_traced": out["one_worker"]["shard_lease_wait_s"],
        "micro_shards_per_rank": {t: [len(r["micro_shards"]) for r in out[t]["ranks"]]
                                  for t in tags[1:]},
        "drill_outage_s": {t: out[t]["outage_s"] for t in ("drill", "drill_open")},
        "drill_open": {k: out["drill_open"][k] for k in
                       ("re_served_shards", "batches_trained_twice")},
        "leases_expired": {t: out[t]["recovery"]["leases_expired"]
                           for t in ("drill", "drill_open")},
        "lease_wait_s_per_rank": {t: [r["lease_wait_s"] for r in out[t]["ranks"]]
                                  for t in tags[1:]},
        "job_wall_s": {t: out[t]["wall_s"] for t in tags},
        "replay_s": {t: out[t]["replay_s"] for t in tags},
        "replay_max_abs": {t: max(g["max_abs"] for g in out[t]["replay_gap"].values())
                           for t in tags},
    }
    return out, launches


DSSERVE_ARMS = (("tcp", "on"), ("shm", "on"), ("tcp", "off"), ("shm", "off"))
DSSERVE_OVERSPLIT, DSSERVE_TTL, DSSERVE_KILL_AT = 8, 5, 8

DSSERVE_WORKER = """
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

# a trainer over the job's dsserve tier: it writes <out>.step once it has
# taken kill_at steps (this script then SIGKILLs one server), and logs the
# digest of each batch it trained with the micro-shard that carried it
inner, out, lr, kill_at, dev = (sys.argv[1], sys.argv[2], float(sys.argv[3]),
                                int(sys.argv[4]), torch.device(sys.argv[5]))
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
model = FactorizationMachine({d}, {e}, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
spec = BatchSpec(batch_size={b}, max_nnz={k}, value_dtype=np.float32)
src = ell_batches("dsserve://" + os.environ["DMLC_DSSERVE"] + inner, spec)
trained, done = [], []
src.on_slot = lambda shard, seq, payload: trained.append(
    (shard, hashlib.blake2b(payload).hexdigest()))
src.on_shard_done = lambda shard, status: done.append((shard, status))
pipe = StagingPipeline(src, device=dev)
losses, step_s = [], []
_build.reset_launches()
t_start = time.perf_counter()
for batch in pipe:
    t0 = time.perf_counter()
    losses.append(float(model.sgd_step(batch, lr=lr)))
    sync()
    step_s.append(time.perf_counter() - t0)
    if len(losses) == kill_at:
        open(out + ".step", "w").close()
wall = time.perf_counter() - t_start
launches = dict(_build.launches)
stats, staging = src.io_stats(), pipe.staging_stats()
drain_close(pipe, src)
np.savez(out + ".npz", **{{n: p.detach().cpu().numpy() for n, p in model.params().items()}})
with open(out + ".json", "w") as f:
    json.dump({{"launches": launches, "losses": losses, "step_s": step_s, "wall_s": wall,
               "trained": trained, "done": done, "io_stats": stats,
               "staging": staging}}, f)
"""


def dsserve_server(tmp: str, env: dict):
    """One ``python -m dmlc_core_tpu_torch.tools dsserve serve`` process
    with no tracker in its environment (static stripes): (process,
    "127.0.0.1:port")."""
    repo = os.path.dirname(os.path.abspath(__file__))
    pf = os.path.join(tmp, "dsserve.port")
    full = {k: v for k, v in os.environ.items()
            if k not in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT")}
    full.update(env, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools", "dsserve", "serve",
         "--port", "0", "--port-file", pf], env=full, cwd=repo)
    deadline = time.monotonic() + 60
    while not os.path.exists(pf):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            fail("the dsserve server did not start")
        time.sleep(0.05)
    with open(pf) as f:
        ep = json.load(f)
    return proc, f"{ep['host']}:{ep['port']}"


def stop_process(proc, what: str) -> None:
    """SIGTERM (a dsserve server's graceful retire), then SIGKILL past 30 s."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"{what} ignored SIGTERM for 30 s")


class Unadopted:
    """A dsserve client passed through by a wrapper that declares no
    ``adopt_slots``: the pipeline packs each received slot."""

    def __init__(self, source) -> None:
        self.source = source

    def __iter__(self):
        return iter(self.source)

    def close(self) -> None:
        self.source.close()


def dsserve_pass(name, endpoint: str, inner: str, spec, dev, model, transport: str,
                 adopt: str, digests: bool = False):
    """One FM pass over ``dsserve://endpoint/inner`` (static mode, one
    server) with the client's transport (``DMLC_DSSERVE_SHM``) set for
    it; adopt off passes the client through a wrapper that declares no
    ``adopt_slots``. Gates: adopt on, every batch adopted and none
    copied; adopt off, none adopted; shm, slots carried by shared
    memory."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.staging.pipeline import host_pinning_stats
    from dmlc_core_tpu_torch.telemetry import default_registry

    old = {"DMLC_DSSERVE_SHM": os.environ.get("DMLC_DSSERVE_SHM")}
    os.environ["DMLC_DSSERVE_SHM"] = "on" if transport == "shm" else "off"
    reg = default_registry()
    copies0 = reg.snapshot()["counters"].get("dsserve.slot_copies", 0)
    pin0 = host_pinning_stats()
    try:
        src = ell_batches(f"dsserve://{endpoint}{inner}", spec)
        stats, _, _ = drive(name, model, src if adopt == "on" else Unadopted(src), dev,
                            SHARD_LR, digests=digests)
    finally:
        restore_env(old)
    io = src.io_stats()
    pin1 = host_pinning_stats()
    n = stats["batches_staged"]
    adopted = stats["staging"]["slots_adopted"]
    copies = reg.snapshot()["counters"].get("dsserve.slot_copies", 0) - copies0
    row = {"transport": transport, "adopt": adopt, "batches": n, "adopted": adopted,
           "adopted_pinned": stats["staging"]["slots_adopted_pinned"],
           "slot_copies": copies, "shm_slots": io["shm_slots"], "tcp_slots": io["tcp_slots"],
           "recv_wait_s": io["recv_wait_secs"], "recv_alloc_bytes": io["recv_alloc_bytes"],
           "pool_banks": io["pool_banks"],
           "pinned": {k: pin1[k] - pin0[k] for k in pin1}}
    if adopt == "on" and not (adopted == n and copies == 0):
        fail(f"{name}: {adopted} of {n} batches adopted, {copies} copied")
    if adopt == "off" and adopted:
        fail(f"{name}: {adopted} batches adopted through a wrapper with no adopt_slots")
    if transport == "shm" and not io["shm_slots"] > 0:
        fail(f"{name}: no slot came through shared memory: {io}")
    if transport == "tcp" and io["shm_slots"]:
        fail(f"{name}: {io['shm_slots']} slots came through shared memory on TCP")
    stats["dsserve"] = row
    return stats


def dsserve_static(rec: str, spec, dev, make, tmp: str):
    """(a) and (b): one static server process. (a) FM over its stream
    (TCP, adopted) against a local pass over the same file: each batch's
    digest equal, the params within PARAM_REL. (b) the four arms
    (transport x adopt) twice in turns, beside a local pass each time."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    inner = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    proc, endpoint = dsserve_server(tmp, {"DMLC_DSSERVE_SHM": "on",
                                          "DMLC_DSSERVE_SHM_SLOTS": "32",
                                          "DMLC_DSSERVE_WIRE_CODEC": "off"})
    params = lambda m: {k: p.detach().cpu().numpy() for k, p in m.params().items()}  # noqa: E731
    pick = ("steps", "step_ms", "staged_rows_per_sec", "wait_share", "wall_s")
    try:
        local_model, remote_model = make(), make()
        local, _, _ = drive("dsserve_local", local_model, ell_batches(inner, spec), dev,
                            SHARD_LR, digests=True)
        remote = dsserve_pass("dsserve_static", endpoint, inner, spec, dev, remote_model,
                              "tcp", "on", digests=True)
        if remote["digests"] != local["digests"]:
            diff = sum(a != b for a, b in zip(remote["digests"], local["digests"]))
            fail(f"dsserve static: {diff} of {len(local['digests'])} received slots differ "
                 f"from the local producer's ({len(remote['digests'])} received)")
        gap = param_gap(params(remote_model), params(local_model))
        check_gap(gap, "dsserve static against the local pass")
        static = {"steps": remote["steps"], "param_gap": gap,
                  "launches": remote["launches"], "dsserve": remote["dsserve"],
                  **{k: remote[k] for k in pick}, "local": {k: local[k] for k in pick}}
        arms = {"local": []}
        arms.update({f"{t}_adopt_{a}": [] for t, a in DSSERVE_ARMS})
        launches = dict.fromkeys(KERNEL_NAMES, 0)
        for rep in range(2):
            run, _, _ = drive(f"dsserve_arm_local_{rep}", make(), ell_batches(inner, spec), dev,
                              SHARD_LR)
            arms["local"].append(run)
            for transport, adopt in DSSERVE_ARMS:
                run = dsserve_pass(f"dsserve_arm_{transport}_{adopt}_{rep}", endpoint, inner,
                                   spec, dev, make(), transport, adopt)
                arms[f"{transport}_adopt_{adopt}"].append(run)
                for k in KERNEL_NAMES:
                    launches[k] += run["launches"][k]
    finally:
        stop_process(proc, "the dsserve server")
    for k in KERNEL_NAMES:
        launches[k] += remote["launches"][k]
        if remote["launches"][k] != remote["steps"]:
            fail(f"dsserve static: launches {remote['launches']} for {remote['steps']} steps")
    table = {}
    for arm, runs in arms.items():
        table[arm] = [{**{k: r[k] for k in pick},
                       "dispatch_pack_s": r["stage_seconds"]["dispatch_pack"],
                       "dispatch_put_s": r["stage_seconds"]["dispatch_put"],
                       "transfer_wait_s": r["stage_seconds"]["transfer_wait"],
                       **r.get("dsserve", {})} for r in runs]
    return {"uri": inner, "static": static, "arms": table}, launches


def server_pid(port_file_name: str):
    """The pid of the dsserve server launched with ``--port-file`` naming
    ``port_file_name``."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"dsserve" in argv and any(a.endswith(port_file_name.encode()) for a in argv):
            return int(pid)
    return None


def dsserve_lease(rec: str, spec, dev, tmp: str):
    """(c) ``submit --dsserve 2`` with one trainer over the file cut into
    DSSERVE_OVERSPLIT micro-shards; the tier's first server (task 1000)
    SIGKILLed once the trainer took DSSERVE_KILL_AT steps. Gates: the
    ledger completes every micro-shard once (no duplicate), each
    micro-shard's batches equal the static part's, K1-K4 once a step, and
    the params within PARAM_REL of a one-process replay of the batches
    trained."""
    import signal
    from collections import defaultdict

    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "dsserve_worker.py")
    with open(script, "w") as f:
        f.write(DSSERVE_WORKER.format(repo=repo, d=D, e=E, b=B, k=K))
    inner = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    prefix = os.path.join(tmp, "dsserve_lease")
    report_path = prefix + ".report.json"
    env = dict(os.environ, PYTHONPATH=repo, DMLC_METRICS_REPORT=report_path)
    for k in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_SHARD_RANK", "DMLC_TASK_ID"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--host-ip", "127.0.0.1", "--num-workers", "1", "--dsserve", "2",
         "--shard-oversplit", str(DSSERVE_OVERSPLIT), "--shard-lease-ttl", str(DSSERVE_TTL),
         # the backend runs the command through bash: quote the URI's "&"
         sys.executable, script, shlex.quote(inner), prefix, str(SHARD_LR),
         str(DSSERVE_KILL_AT), dev.type],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=repo,
        start_new_session=True)
    killed = None
    try:
        deadline = time.monotonic() + JOB_TIMEOUT
        while not os.path.exists(prefix + ".step"):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"the trainer never reached step {DSSERVE_KILL_AT}")
            time.sleep(0.02)
        pid = server_pid("server1000.port")
        if pid is None:
            raise RuntimeError("no dsserve server of task 1000 to kill")
        os.kill(pid, signal.SIGKILL)
        killed = {"pid": pid, "at_step": DSSERVE_KILL_AT, "wall": time.time()}
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except (subprocess.TimeoutExpired, RuntimeError) as e:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        fail(f"dsserve lease job: {e}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dsserve lease job exited {proc.returncode}:\n{stdout[-3000:]}\n"
             f"{stderr[-3000:]}")
    with open(prefix + ".json") as f:
        res = json.load(f)
    with open(report_path) as f:
        ledger = json.load(f).get("shards") or {}
    m = DSSERVE_OVERSPLIT
    batches = {}
    static = static_part_digests(rec, spec, m, batches)
    by_shard = defaultdict(list)
    for shard, h in res["trained"]:
        by_shard[shard].append(h)
    if [by_shard[i] for i in range(m)] != static or sorted(by_shard) != list(range(m)):
        fail("dsserve lease: a micro-shard's batches differ from the static part "
             f"(shards {sorted(by_shard)})")
    io = res["io_stats"]
    if not (ledger.get("completed") == m and ledger.get("duplicates") == 0
            and io["shards_recorded"] == m and sorted(s for s, _ in res["done"]) == list(range(m))
            and all(st == "recorded" for _, st in res["done"])):
        fail(f"dsserve lease: not exactly once: ledger {ledger}, client {io}, "
             f"dones {res['done']}")
    n = len(res["losses"])
    if n != sum(map(len, static)) or any(res["launches"][k] != n for k in KERNEL_NAMES):
        fail(f"dsserve lease: {n} steps, launches {res['launches']}")
    if not np.mean(res["losses"][-4:]) < np.mean(res["losses"][:4]):
        fail(f"dsserve lease: the loss did not fall: {res['losses']}")
    params = dict(np.load(prefix + ".npz"))
    want, rounds, replay_s = shard_replay(dev, batches, [[h for _, h in res["trained"]]])
    del batches
    gap = param_gap(params, want)
    check_gap(gap, "dsserve lease against the one-process replay")
    out = {"wall_s": wall, "killed": killed, "ledger": ledger, "io_stats": io,
           "staging": res["staging"], "steps": n,
           "step_ms": statistics.median(res["step_s"]) * 1e3,
           "rows_per_sec": n * B / res["wall_s"], "trainer_wall_s": res["wall_s"],
           "shard_order": [s for s, _ in res["done"]],
           "replay_gap": gap, "replay_rounds": rounds, "replay_s": replay_s,
           "loss_first": res["losses"][0], "loss_last": res["losses"][-1]}
    return out, res["launches"]


def dsserve_phase(dev, card: str):
    """dsserve at the Criteo width over the shuffle phase's 2^18 indexed
    rows: (a) and (b) from one static server process, (c) a leased tier
    through the launcher with a server killed mid-stream. Returns the
    ``{"dsserve": ...}`` line and the launches of (a), (b) and (c)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), PRODUCER_ROWS, D))
        out, launches = dsserve_static(rec, spec, dev, make, tmp)
        out["lease"], lease_launches = dsserve_lease(rec, spec, dev, tmp)
    for k in KERNEL_NAMES:
        launches[k] += lease_launches[k]
    out["card"] = card
    out["rows"] = PRODUCER_ROWS
    med = lambda xs: statistics.median(xs)  # noqa: E731
    out["summary"] = {
        arm: {"staged_rows_per_sec": [r["staged_rows_per_sec"] for r in runs],
              "wait_share": [r["wait_share"] for r in runs],
              "step_ms": [r["step_ms"] for r in runs],
              "dispatch_pack_s": [r["dispatch_pack_s"] for r in runs],
              "dispatch_put_s": [r["dispatch_put_s"] for r in runs],
              "recv_wait_s": [r.get("recv_wait_s") for r in runs],
              "median_rows_per_sec": med([r["staged_rows_per_sec"] for r in runs])}
        for arm, runs in out["arms"].items()}
    return out, launches


# -- the faults phase: fault:// chaos and the span fetcher ---------------------------
# (a) seeded chaos on every stream: 3 open 5xx, 2 mid-read resets and 2
# short reads, healed by the retry layer
FAULT_CHAOS = "resets=2,short=2,errors=3,seed=7"
# ... with the retry backoff at test speed (the policy's env knobs): the
# default 0.1 s base grows to seconds over a stream's 5 retries
FAULT_RETRY = {"DMLC_RETRY_BASE_SECS": "0.01", "DMLC_RETRY_CAP_SECS": "0.05"}
# (b) latency on about 2 reads in 5 of every stream (a spike every 2-3
# read ordinals, more spikes than reads), one span a record, over part 0
# of FETCH_PARTS (8 batches, 16 windows; a pass runs to its end, so no
# window load is left in flight when the pipeline closes)
FETCH_FAULT = "latency_ms=1,spikes=100000,seed=3"
FETCH_WINDOW, FETCH_PARTS = 1024, 16


def stall_seconds(stage: str) -> float:
    """This process's ``trace.stall_seconds`` counter of ``stage``."""
    from dmlc_core_tpu_torch.telemetry import default_registry

    key = f'trace.stall_seconds{{stage="{stage}"}}'
    return default_registry().snapshot()["counters"].get(key, 0.0)


def fetch_arm(name: str, uri: str, spec, dev, model, threads):
    """One FM pass over part 0 of FETCH_PARTS of ``uri`` with
    ``DMLC_FETCH_THREADS`` set to ``threads`` (None: the default), the
    split's counters read at each step, before the pass closes it."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.telemetry import default_registry

    old = {"DMLC_FETCH_THREADS": os.environ.get("DMLC_FETCH_THREADS")}
    if threads is None:
        os.environ.pop("DMLC_FETCH_THREADS", None)
    else:
        os.environ["DMLC_FETCH_THREADS"] = str(threads)
    peak = default_registry().gauge("io.fetch.concurrency_peak")
    peak.reset_max()
    wait0 = stall_seconds("fetch_wait")
    io = {}
    try:
        src = ell_batches(uri, spec, part_index=0, num_parts=FETCH_PARTS)
        stats, _, _ = drive(name, model, src, dev, SHARD_LR, min_steps=1, digests=True,
                            must_fall=False, on_step=lambda _s, _b: io.update(src.io_stats()))
    finally:
        restore_env(old)
    from dmlc_core_tpu_torch.io.spanfetch import fetch_threads

    stats["fetch"] = {
        "threads": threads or fetch_threads(), "fetch_wait_s": stall_seconds("fetch_wait") - wait0,
        "fetch_spans": io.get("fetch_spans", 0), "spans": io.get("spans"),
        "split_concurrency_peak": io.get("fetch_concurrency_peak", 1),
        "concurrency_peak_gauge": peak.value(), "faults_injected": io.get("faults_injected"),
    }
    return stats


def faults_phase(dev, card: str):
    """The shuffle phase's 2^18 indexed rows behind ``fault://`` on the
    card: (a) FM SGD for 128 steps over ``shuffle=batch`` through seeded
    chaos (FAULT_CHAOS), each batch's digest equal to the same pass over
    the clean file, faults fired and retries healed in ``io_stats()``, the
    params within PARAM_REL of the clean pass; (b) window loads
    (``shuffle=window``, one span a record) behind FETCH_FAULT latency,
    serial (``DMLC_FETCH_THREADS=1``) and with the default fetch threads,
    twice in turns, each pass's batches equal across the arms and to the
    clean file's. Returns the ``{"faults": ...}`` line and the launches
    of every pass."""
    from dmlc_core_tpu_torch.io.faults import wrap_uri
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    params = lambda m: {k: p.detach().cpu().numpy() for k, p in m.params().items()}  # noqa: E731
    pick = ("steps", "step_ms", "staged_rows_per_sec", "wait_share", "wall_s")
    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), PRODUCER_ROWS, D))
        query = f"?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
        clean_model, chaos_model = make(), make()
        clean, _, _ = drive("faults_clean", clean_model, ell_batches(rec + query, spec), dev,
                            SHARD_LR, digests=True)
        old = {k: os.environ.get(k) for k in FAULT_RETRY}
        os.environ.update(FAULT_RETRY)
        try:
            src = ell_batches(wrap_uri(rec, FAULT_CHAOS) + query, spec)
            chaos, _, _ = drive("faults_chaos", chaos_model, src, dev, SHARD_LR, digests=True)
        finally:
            restore_env(old)
        io = src.io_stats()
        runs += [clean, chaos]
        if chaos["digests"] != clean["digests"] or chaos["steps"] != PRODUCER_ROWS // B:
            diff = sum(a != b for a, b in zip(chaos["digests"], clean["digests"]))
            fail(f"faults chaos: {diff} of {clean['steps']} batches differ from the clean "
                 f"pass ({chaos['steps']} steps)")
        if not (io.get("faults_injected", 0) > 0 and io.get("retries", 0) > 0):
            fail(f"faults chaos: no fault fired or healed: {io}")
        gap = param_gap(params(chaos_model), params(clean_model))
        check_gap(gap, "faults chaos against the clean pass")
        del chaos["digests"], clean["digests"]
        chaos_out = {"uri": f"fault://{FAULT_CHAOS}<rec>{query.replace(rec, '<rec>')}",
                     "retry_env": FAULT_RETRY, "io_stats": io, "param_gap": gap,
                     "chaos": {k: chaos[k] for k in pick}, "clean": {k: clean[k] for k in pick}}

        fquery = (f"?index={rec}.idx&shuffle=window&window={FETCH_WINDOW}&merge_gap=0"
                  "&seed=1&epoch=0")
        ref, _, _ = drive("fetch_clean", make(),
                          ell_batches(rec + fquery, spec, part_index=0, num_parts=FETCH_PARTS),
                          dev, SHARD_LR, min_steps=1, digests=True, must_fall=False)
        runs.append(ref)
        slow = wrap_uri(rec, FETCH_FAULT) + fquery
        arms = {"threads_1": [], "threads_default": []}
        for rep in range(2):
            for arm, threads in (("threads_1", 1), ("threads_default", None)):
                run = fetch_arm(f"fetch_{arm}_{rep}", slow, spec, dev, make(), threads)
                if run["digests"] != ref["digests"]:
                    fail(f"fetch {arm} pass {rep}: batches differ from the clean file's")
                runs.append(run)
                arms[arm].append({**{k: run[k] for k in pick}, **run["fetch"]})
        for run in arms["threads_default"]:
            if not (run["fetch_spans"] > 0 and run["split_concurrency_peak"] > 1
                    and run["concurrency_peak_gauge"] > 1):
                fail(f"fetch default arm: the span fetcher did not go parallel: {run}")
    for run in runs:
        for k in KERNEL_NAMES:
            launches[k] += run["launches"][k]
            if run["launches"][k] != run["steps"]:
                fail(f"faults phase: launches {run['launches']} for {run['steps']} steps")
    ref_out = {k: ref[k] for k in pick}
    summary = {arm: {key: [r[key] for r in rs] for key in
                     ("staged_rows_per_sec", "wait_share", "step_ms", "fetch_wait_s",
                      "fetch_spans", "split_concurrency_peak", "concurrency_peak_gauge",
                      "wall_s")} for arm, rs in arms.items()}
    return {"card": card, "rows": PRODUCER_ROWS, "chaos": chaos_out,
            "fetch": {"fault": FETCH_FAULT, "window": FETCH_WINDOW, "parts": FETCH_PARTS,
                      "clean": ref_out, "arms": arms, "summary": summary}}, launches


# -- the remote phase: the FM from an object store, and decode once per host -----------
# a small S3 of this script's own, run as a process of its own on the loopback
# (so its handler threads do not share the trainer's interpreter): path-style
# /bucket/key, ranged GET, HEAD with an ETag, PUT, multipart upload, server-side
# copy, ListObjectsV2 with paging, DELETE and DeleteObjects; every request must
# carry a SigV4 Authorization header. GET /?fake-stats answers its request counts.
FAKE_S3 = r'''
import base64, hashlib, json, os, sys, threading, urllib.parse
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

STORE, ETAGS, UPLOADS, COUNTS = {}, {}, {}, {}
LOCK = threading.Lock()
MAX_KEYS = 1000


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def reply(self, code, body=b"", headers=()):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def parse(self):
        with LOCK:
            COUNTS[self.command] = COUNTS.get(self.command, 0) + 1
        u = urllib.parse.urlsplit(self.path)
        q = urllib.parse.parse_qs(u.query, keep_blank_values=True)
        if "fake-stats" in q:
            return None, q
        if not self.headers.get("Authorization", "").startswith("AWS4-HMAC-SHA256 Credential="):
            self.reply(403, b"<Error><Code>AccessDenied</Code></Error>")
            return False, q
        return urllib.parse.unquote(u.path).lstrip("/"), q

    def body(self):
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def put_object(self, key, data):
        with LOCK:
            STORE[key] = data
            ETAGS[key] = '"%s"' % hashlib.md5(data).hexdigest()
            return ETAGS[key]

    def do_HEAD(self):
        key, _ = self.parse()
        if key is False:
            return
        data = STORE.get(key)
        if data is None:
            return self.reply(404)
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("ETag", ETAGS[key])
        self.end_headers()

    def do_GET(self):
        key, q = self.parse()
        if key is None:
            with LOCK:
                return self.reply(200, json.dumps(COUNTS).encode())
        if key is False:
            return
        if "list-type" in q:
            return self.list_objects(key.rstrip("/"), q)
        data = STORE.get(key)
        if data is None:
            return self.reply(404)
        start, end, code = 0, len(data), 200
        rng = self.headers.get("Range")
        if rng:
            a, _, b = rng.split("=", 1)[1].partition("-")
            start, end, code = int(a), min(int(b) + 1 if b else len(data), len(data)), 206
            if start >= len(data):
                return self.reply(416)
        self.send_response(code)
        if code == 206:
            self.send_header("Content-Range", "bytes %d-%d/%d" % (start, end - 1, len(data)))
        self.send_header("Content-Length", str(end - start))
        self.send_header("ETag", ETAGS[key])
        self.end_headers()
        view = memoryview(data)
        try:  # a reader that seeks away closes the connection mid-body
            for at in range(start, end, 1 << 20):
                self.wfile.write(view[at:min(at + (1 << 20), end)])
        except (BrokenPipeError, ConnectionResetError):
            pass

    def list_objects(self, bucket, q):
        prefix = q.get("prefix", [""])[0]
        delim = q.get("delimiter", [""])[0]
        after = q.get("continuation-token", [""])[0]
        with LOCK:
            keys = sorted(k[len(bucket) + 1:] for k in STORE
                          if k.startswith(bucket + "/" + prefix))
        entries = []
        for k in keys:
            tail = k[len(prefix):]
            name = prefix + tail.split(delim, 1)[0] + delim if delim and delim in tail else k
            if name > after and (not entries or entries[-1] != name):
                entries.append(name)
        page, more = entries[:MAX_KEYS], len(entries) > MAX_KEYS
        parts = ["<ListBucketResult><IsTruncated>%s</IsTruncated>" % ("true" if more else "false")]
        if more:
            parts.append("<NextContinuationToken>%s</NextContinuationToken>" % escape(page[-1]))
        for name in page:
            if delim and name.endswith(delim) and name not in keys:
                parts.append("<CommonPrefixes><Prefix>%s</Prefix></CommonPrefixes>" % escape(name))
            else:
                full = bucket + "/" + name
                parts.append("<Contents><Key>%s</Key><Size>%d</Size><ETag>%s</ETag></Contents>"
                             % (escape(name), len(STORE[full]), escape(ETAGS[full])))
        self.reply(200, ("".join(parts) + "</ListBucketResult>").encode())

    def do_PUT(self):
        key, q = self.parse()
        if key is False:
            return
        data = self.body()
        if "partNumber" in q:
            with LOCK:
                UPLOADS[q["uploadId"][0]][int(q["partNumber"][0])] = data
            return self.reply(200, headers=[("ETag", '"%s"' % hashlib.md5(data).hexdigest())])
        src = self.headers.get("x-amz-copy-source")
        if src:
            src = urllib.parse.unquote(src).lstrip("/")
            if src not in STORE:
                return self.reply(404)
            etag = self.put_object(key, STORE[src])
            return self.reply(200, ("<CopyObjectResult><ETag>%s</ETag></CopyObjectResult>"
                                    % escape(etag)).encode())
        self.reply(200, headers=[("ETag", self.put_object(key, data))])

    def do_DELETE(self):
        key, _ = self.parse()
        if key is False:
            return
        with LOCK:
            STORE.pop(key, None)
            ETAGS.pop(key, None)
        self.reply(204)

    def do_POST(self):
        key, q = self.parse()
        if key is False:
            return
        data = self.body()
        if "delete" in q:
            want = base64.b64encode(hashlib.md5(data).digest()).decode()
            if self.headers.get("Content-MD5") != want:
                return self.reply(400, b"<Error><Code>InvalidDigest</Code></Error>")
            bucket = key.split("/", 1)[0]
            with LOCK:
                for obj in ET.fromstring(data).iter("Object"):
                    full = bucket + "/" + (obj.findtext("Key") or "")
                    STORE.pop(full, None)
                    ETAGS.pop(full, None)
            return self.reply(200, b"<DeleteResult/>")
        if "uploads" in q:
            with LOCK:
                uid = "upload-%d" % len(UPLOADS)
                UPLOADS[uid] = {}
            return self.reply(200, ("<InitiateMultipartUploadResult><UploadId>%s</UploadId>"
                                    "</InitiateMultipartUploadResult>" % uid).encode())
        with LOCK:
            parts = UPLOADS.pop(q["uploadId"][0])
        self.put_object(key, b"".join(parts[n] for n in sorted(parts)))
        self.reply(200, b"<CompleteMultipartUploadResult/>")


class Server(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        pass  # a client gone mid-request is the client's business


srv = Server(("127.0.0.1", 0), Handler)
with open(sys.argv[1] + ".tmp", "w") as f:
    json.dump({"port": srv.server_address[1], "pid": os.getpid()}, f)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
srv.serve_forever()
'''

# an FM trainer of its own process over a compressed file (the decode-once
# arms and the --block-cache job): the JSON config names the URI, the card,
# the widths and, in a job, the flag file rank 1 waits for; it writes its
# pass's stats, its codec and block-cache counters and its params
REMOTE_TRAINER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import chip_smoke as cs
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.telemetry import default_registry

with open(sys.argv[1]) as f:
    cfg = json.load(f)
dev = torch.device(cfg["dev"])
out = cfg["out"]
worker = None
if cfg.get("rabit"):
    from dmlc_core_tpu_torch.tracker.client import RabitWorker
    worker = RabitWorker()
    rank = worker.start()
    out += str(rank)
    if rank == 1:  # the second colocated reader starts behind the first
        end = time.monotonic() + 300
        while not os.path.exists(cfg["flag"]):
            if time.monotonic() > end:
                sys.exit("rank 0 never reached its flag step")
            time.sleep(0.02)
model = FactorizationMachine(cfg["d"], cfg["e"], device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
spec = BatchSpec(batch_size=cfg["b"], max_nnz=cfg["k"], value_dtype=np.float32)
reg = default_registry()


def flag(step, _batch):
    if cfg.get("flag") and step == cfg["flag_step"] and not os.path.exists(cfg["flag"]):
        open(cfg["flag"], "w").close()


stats, _, _ = cs.drive(cfg["name"], model, ell_batches(cfg["uri"], spec), dev, cfg["lr"],
                       digests=True, on_step=flag)
stats.update(
    decodes=reg.histogram("io.codec.decode_seconds").snapshot()["count"],
    blockcache_hits=sum(reg.counter_values("io.blockcache.hits").values()),
    blockcache_misses=sum(reg.counter_values("io.blockcache.misses").values()),
    blockcache_publishes=sum(reg.counter_values("io.blockcache.publishes").values()),
    sock=os.environ.get("DMLC_BLOCK_CACHE_SOCK", ""),
    block_cache_env=os.environ.get("DMLC_BLOCK_CACHE", ""))
np.savez(out + ".npz", **{{n: p.detach().cpu().numpy() for n, p in model.params().items()}})
with open(out + ".json.tmp", "w") as f:
    json.dump(stats, f)
os.replace(out + ".json.tmp", out + ".json")
if worker is not None:
    worker.shutdown()
"""

REMOTE_CKPT_EVERY = 16  # the head pass saves to s3:// every this many steps
REMOTE_FLAG_STEP = 8    # in the --block-cache job rank 1 starts at rank 0's step 8


def fake_s3(tmp: str):
    """The FAKE_S3 process: (process, endpoint URL)."""
    pf = os.path.join(tmp, "fake_s3.json")
    proc = subprocess.Popen([sys.executable, "-c", FAKE_S3, pf])
    deadline = time.monotonic() + 60
    while not os.path.exists(pf):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            fail("the fake S3 did not start")
        time.sleep(0.05)
    with open(pf) as f:
        return proc, f"http://127.0.0.1:{json.load(f)['port']}"


def fake_s3_counts(endpoint: str) -> dict:
    from dmlc_core_tpu_torch.io import retry

    with retry.request(f"{endpoint}/?fake-stats", timeout=30.0) as resp:
        return json.loads(resp.read().decode())


def upload(src: str, uri: str) -> None:
    """A local file to ``uri`` through the port's filesystems (a
    multipart upload past 16 MiB)."""
    from dmlc_core_tpu_torch.io.stream import Stream

    with open(src, "rb") as f, Stream.create(uri, "w") as w:
        while chunk := f.read(4 << 20):
            w.write(chunk)


def fm_params(m):
    return {k: p.detach().cpu().numpy() for k, p in m.params().items()}


def count_blocks(path: str) -> int:
    from dmlc_core_tpu_torch.io.recordio import scan_compressed_blob

    with open(path, "rb") as f:
        view = memoryview(f.read())
    n = pos = 0
    while pos < len(view):
        _, pos = scan_compressed_blob(view, pos)
        n += 1
    return n


def remote_object_store(rec: str, spec, dev, make, tmp: str, endpoint: str):
    """(a): the FM from ``s3://`` (clean, then through fault:// chaos)
    beside the local file's pass, and a pass checkpointed to ``s3://``
    every REMOTE_CKPT_EVERY steps, stopped halfway and resumed."""
    from dmlc_core_tpu_torch.checkpoint import Checkpointer
    from dmlc_core_tpu_torch.convert import params_from_jax
    from dmlc_core_tpu_torch.io.filesystem import FileSystem
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    pick = ("steps", "step_ms", "staged_rows_per_sec", "wait_share", "wall_s")
    query = f"shuffle=batch&batch_size={B}&seed=1&epoch=0"
    t0 = time.perf_counter()
    upload(rec, "s3://bkt/shuffle.rec")
    upload(rec + ".idx", "s3://bkt/shuffle.idx")
    upload_s = time.perf_counter() - t0
    info = FileSystem.get_instance("s3://bkt/shuffle.rec").get_path_info("s3://bkt/shuffle.rec")
    if info.size != os.path.getsize(rec) or not info.etag:
        fail(f"s3://bkt/shuffle.rec: stat {info} for a {os.path.getsize(rec)}-byte file")
    s3_uri = f"s3://bkt/shuffle.rec?index=s3://bkt/shuffle.idx&{query}"
    chaos_uri = f"fault://inner=s3,{FAULT_CHAOS}/bkt/shuffle.rec?index=s3://bkt/shuffle.idx&{query}"
    arms, models, io, runs = {}, {}, {}, []
    for arm, uri in (("local", f"{rec}?index={rec}.idx&{query}"), ("s3", s3_uri),
                     ("chaos", chaos_uri)):
        old = {k: os.environ.get(k) for k in FAULT_RETRY}
        if arm == "chaos":
            os.environ.update(FAULT_RETRY)
        wait0 = stall_seconds("fetch_wait")
        try:
            models[arm] = make()
            src = ell_batches(uri, spec)
            run, _, _ = drive(f"remote_{arm}", models[arm], src, dev, SHARD_LR, digests=True)
        finally:
            restore_env(old)
        io[arm] = src.io_stats()
        run["fetch_wait_s"] = stall_seconds("fetch_wait") - wait0
        arms[arm] = run
        runs.append(run)
    for arm in ("s3", "chaos"):
        if arms[arm]["digests"] != arms["local"]["digests"]:
            diff = sum(a != b for a, b in zip(arms[arm]["digests"], arms["local"]["digests"]))
            fail(f"remote {arm}: {diff} of {arms['local']['steps']} batches differ from the "
                 f"local file's ({arms[arm]['steps']} steps)")
    if not io["s3"].get("reopens", 0) > 0:
        fail(f"remote s3: no stream was reopened by a seek: {io['s3']}")
    if not (io["chaos"].get("faults_injected", 0) > 0 and io["chaos"].get("retries", 0) > 0):
        fail(f"remote chaos: no fault fired or healed: {io['chaos']}")
    gaps = {arm: param_gap(fm_params(models[arm]), fm_params(models["local"]))
            for arm in ("s3", "chaos")}
    for arm, gap in gaps.items():
        check_gap(gap, f"remote {arm} against the local pass")

    # a pass that checkpoints to s3:// and stops halfway, then a fresh
    # Checkpointer restores it and a new pipeline resumes with skip_records
    full = arms["s3"]
    stop = full["steps"] // 2
    ck = Checkpointer("s3://bkt/ckpt", keep=2)
    model = make()
    saves = []

    def save(step, _batch):
        if step % REMOTE_CKPT_EVERY == 0 and step <= stop:
            t = time.perf_counter()
            ck.save(step, model.params(), meta={"epoch": 0, "records": step * B})
            saves.append(time.perf_counter() - t)

    head, _, _ = drive("remote_head", model, ell_batches(s3_uri, spec), dev, SHARD_LR,
                       stop_after=stop, on_step=save, digests=True)
    saved = fm_params(model)
    t = time.perf_counter()
    fresh = Checkpointer("s3://bkt/ckpt", keep=2)
    step, tree = fresh.restore()
    meta = fresh.restore_meta()
    restore_s = time.perf_counter() - t
    want_steps = [s for s in range(REMOTE_CKPT_EVERY, stop + 1, REMOTE_CKPT_EVERY)][-2:]
    if step != stop or meta != {"epoch": 0, "records": stop * B} or fresh.steps() != want_steps:
        fail(f"s3 checkpoint: restored step {step} meta {meta} steps {fresh.steps()}, "
             f"saved up to step {stop}")
    for k, v in saved.items():
        if not np.array_equal(tree[k], v):
            fail(f"s3 checkpoint: restored param {k} differs from the saved one")
    resumed = make()
    resumed.load_state_dict(params_from_jax(tree, dev))
    tail, _, _ = drive("remote_tail", resumed,
                       ell_batches(f"{s3_uri}&skip_records={meta['records']}", spec), dev,
                       SHARD_LR, min_steps=1, digests=True, must_fall=False)
    if head["digests"] != full["digests"][:stop] or tail["digests"] != full["digests"][stop:]:
        fail("s3 resume: the interrupted and resumed passes read other batches than the "
             "uninterrupted one")
    gaps["resumed"] = param_gap(fm_params(resumed), fm_params(models["s3"]))
    check_gap(gaps["resumed"], "the resumed s3 pass against the uninterrupted one")
    runs += [head, tail]
    keys = sorted(FileSystem.get_instance("s3://bkt/ckpt").list_directory("s3://bkt/ckpt"))
    return {
        "data_bytes": os.path.getsize(rec), "upload_s": upload_s, "etag": info.etag,
        "uri": s3_uri, "chaos_uri": chaos_uri, "retry_env": FAULT_RETRY,
        "arms": {arm: {**{k: r[k] for k in pick}, "fetch_wait_s": r["fetch_wait_s"],
                       "io_stats": io[arm]} for arm, r in arms.items()},
        "param_gap": gaps,
        "resume": {"stop": stop, "saves": len(saves), "save_s": saves, "restore_s": restore_s,
                   "steps_kept": fresh.steps(), "objects": [i.path for i in keys],
                   "head": {k: head[k] for k in pick}, "tail": {k: tail[k] for k in pick}},
    }, runs


def trainer(tmp: str, name: str, uri: str, dev, env: dict, timeout: float = JOB_TIMEOUT):
    """One REMOTE_TRAINER process over ``uri`` with ``env``; its stats."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "remote_trainer.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(REMOTE_TRAINER.format(repo=repo))
    out = os.path.join(tmp, name)
    cfg = {"name": name, "uri": uri, "out": out, "dev": str(dev), "d": D, "e": E, "b": B,
           "k": K, "lr": SHARD_LR}
    with open(out + ".cfg", "w") as f:
        json.dump(cfg, f)
    full = dict(os.environ, PYTHONPATH=repo, **env)
    proc = subprocess.run([sys.executable, script, out + ".cfg"], env=full, cwd=repo,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"remote trainer {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    with open(out + ".json") as f:
        stats = json.load(f)
    stats["params"] = dict(np.load(out + ".npz"))
    return stats


def remote_decode_once(dev, tmp: str, zrec: str, blocks: int):
    """(b): ``bench.py``'s _shared_cache_bench with FM trainers on the
    card: a ``tools cached serve`` daemon, a publisher, then a second
    reader and a control (``DMLC_BLOCK_CACHE=off``) in turns, twice each;
    then a ``submit --block-cache`` job of two colocated trainers."""
    from dmlc_core_tpu_torch.io.blockcache import BlockCacheClient

    repo = os.path.dirname(os.path.abspath(__file__))
    sock = os.path.join(tmp, "blockcache.sock")
    daemon = subprocess.Popen([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "cached",
                               "serve", "--socket", sock, "--budget-mb", "2048"],
                              env=dict(os.environ, PYTHONPATH=repo), cwd=repo)
    uri = f"{zrec}?index={zrec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    pick = ("steps", "step_ms", "staged_rows_per_sec", "wait_share", "wall_s", "decodes",
            "blockcache_hits", "blockcache_misses", "blockcache_publishes")
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            if daemon.poll() is not None or time.monotonic() > deadline:
                fail("the block-cache daemon did not start")
            time.sleep(0.05)
        query = BlockCacheClient(sock, tenant="smoke")
        on = {"DMLC_BLOCK_CACHE_SOCK": sock, "DMLC_BLOCK_CACHE": "auto"}
        runs = {"publisher": [trainer(tmp, "publisher", uri, dev,
                                      {**on, "DMLC_BLOCK_CACHE_TENANT": "publisher"})],
                "second_reader": [], "control": []}
        after_publish = query.stats()
        for rep in range(2):
            for arm, env in (("second_reader", {**on, "DMLC_BLOCK_CACHE_TENANT": "reader"}),
                             ("control", {"DMLC_BLOCK_CACHE": "off"})):
                before = query.stats()
                run = trainer(tmp, f"{arm}_{rep}", uri, dev, env)
                after = query.stats()
                dh, dm = after["hits"] - before["hits"], after["misses"] - before["misses"]
                run["daemon_hit_rate"] = dh / (dh + dm) if dh + dm else None
                runs[arm].append(run)
        daemon_stats = query.stats()
        query.close()
    finally:
        stop_process(daemon, "the block-cache daemon")
    pub = runs["publisher"][0]
    if pub["decodes"] != blocks or pub["blockcache_publishes"] != blocks:
        fail(f"decode once: the publisher decoded {pub['decodes']} and published "
             f"{pub['blockcache_publishes']} of {blocks} blocks")
    for run in runs["second_reader"]:
        if run["decodes"] != 0 or run["daemon_hit_rate"] != 1.0:
            fail(f"decode once: a second reader decoded {run['decodes']} blocks at a daemon "
                 f"hit rate of {run['daemon_hit_rate']}")
    for run in runs["control"]:
        if run["decodes"] != blocks or run["blockcache_hits"] or run["daemon_hit_rate"] is not None:
            fail(f"decode once: the control decoded {run['decodes']} of {blocks} blocks with "
                 f"{run['blockcache_hits']} daemon hits")
    every = [r for rs in runs.values() for r in rs]
    for run in every:
        if run["digests"] != pub["digests"]:
            fail("decode once: the trainers took different batches")
        check_gap(param_gap(run["params"], pub["params"]), "decode once against the publisher")
    job = remote_cache_job(dev, tmp, uri, blocks)
    med = lambda rs, k: statistics.median(r[k] for r in rs)  # noqa: E731
    summary = {arm: {k: [r[k] for r in rs] for k in pick} for arm, rs in runs.items()}
    for arm, rs in runs.items():
        for r in rs:
            summary[arm].setdefault("daemon_hit_rate", []).append(r.get("daemon_hit_rate"))
    return {
        "blocks": blocks, "uri": uri, "daemon": {k: daemon_stats[k] for k in (
            "entries", "bytes", "hits", "misses", "publishes", "evictions", "rejected")},
        "after_publish_entries": after_publish["entries"],
        "arms": summary,
        "shared_cache_speedup": med(runs["control"], "wall_s") / med(runs["second_reader"],
                                                                       "wall_s"),
        "job": job,
    }, every + job.pop("runs")


def remote_cache_job(dev, tmp: str, uri: str, blocks: int):
    """``submit --block-cache`` with two colocated FM trainers over the
    zlib file, rank 1 starting at rank 0's step REMOTE_FLAG_STEP: their
    decodes, and the daemon's socket directory gone after the job."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "remote_trainer.py")
    out = os.path.join(tmp, "job_rank")
    cfg = {"name": "job", "uri": uri, "out": out, "dev": str(dev), "d": D, "e": E, "b": B,
           "k": K, "lr": SHARD_LR, "rabit": True, "flag": out + ".flag",
           "flag_step": REMOTE_FLAG_STEP}
    with open(out + ".cfg", "w") as f:
        json.dump(cfg, f)
    _, wall = submit_job(["--num-workers", "2", "--block-cache", "--block-cache-mb", "2048",
                          sys.executable, script, out + ".cfg"])
    ranks = []
    for r in range(2):
        with open(f"{out}{r}.json") as f:
            ranks.append(json.load(f))
        ranks[-1]["params"] = dict(np.load(f"{out}{r}.npz"))
    sock = ranks[0]["sock"]
    if not sock or sock != ranks[1]["sock"] or os.path.exists(os.path.dirname(sock)):
        fail(f"--block-cache job: socket {sock!r} / {ranks[1]['sock']!r}, its directory still "
             f"there: {os.path.exists(os.path.dirname(sock or '/nonexistent'))}")
    decodes = [r["decodes"] for r in ranks]
    if not sum(decodes) < 2 * blocks:
        fail(f"--block-cache job: the two trainers decoded {decodes} of {blocks} blocks each")
    if ranks[1]["digests"] != ranks[0]["digests"]:
        fail("--block-cache job: the two trainers took different batches")
    check_gap(param_gap(ranks[1]["params"], ranks[0]["params"]), "--block-cache job ranks")
    return {"wall_s": wall, "decodes": decodes, "blocks": blocks,
            "hits": [r["blockcache_hits"] for r in ranks],
            "misses": [r["blockcache_misses"] for r in ranks],
            "staged_rows_per_sec": [r["staged_rows_per_sec"] for r in ranks],
            "wait_share": [r["wait_share"] for r in ranks],
            "socket_dir_removed": True, "runs": ranks}


def remote_phase(dev, card: str):
    """The FM at the Criteo width on the shuffle phase's 2^18 indexed rows
    (a) from a fake S3 on the loopback (a process of this script's own,
    not a real bucket): ``s3://`` and ``fault://inner=s3`` chaos beside the
    local file, checkpointed to ``s3://`` and resumed; (b) decode once per
    host over the rows' zlib copy (1 MiB blocks): a publisher, a second
    reader and a control in processes of their own, and a ``submit
    --block-cache`` job. Returns the ``{"remote": ...}`` line and the
    launches of every pass."""
    from dmlc_core_tpu_torch.io import cloudfs
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), PRODUCER_ROWS, D))
        store, endpoint = fake_s3(tmp)
        env = {"S3_ENDPOINT": endpoint, "AWS_ACCESS_KEY_ID": "AKIDSMOKE",
               "AWS_SECRET_ACCESS_KEY": "smoke-secret", "AWS_REGION": "us-east-1"}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        cloudfs.reset_singletons()
        try:
            store_out, runs = remote_object_store(rec, spec, dev, make, tmp, endpoint)
            store_out["requests"] = fake_s3_counts(endpoint)
        finally:
            restore_env(old)
            cloudfs.reset_singletons()
            stop_process(store, "the fake S3")
        zrec = write_compressed(rec, os.path.join(tmp, "criteo.zlib.rec"), "zlib", CODEC_BLOCK)
        once, trainer_runs = remote_decode_once(dev, tmp, zrec, count_blocks(zrec))
    for run in runs + trainer_runs:
        for k in KERNEL_NAMES:
            launches[k] += run["launches"][k]
            if run["launches"][k] != run["steps"]:
                fail(f"remote phase: launches {run['launches']} for {run['steps']} steps")
    return {"card": card, "rows": PRODUCER_ROWS,
            "store": "a fake S3 in a process of its own on the loopback, not a real bucket",
            "object_store": store_out, "decode_once": once,
            "seconds": time.perf_counter() - t_phase}, launches


# -- the autoscale phase: submit --autoscale over a phase-shifting input --------------
# bench.py's autoscale_phase_shift knobs (bench.py:1615-1627)
AUTOSCALE_KNOBS = {"DMLC_AUTOSCALE_INTERVAL": "0.25", "DMLC_AUTOSCALE_WINDOW": "1.5",
                   "DMLC_AUTOSCALE_DWELL": "10", "DMLC_TS_INTERVAL": "0.1"}
AUTOSCALE_OVERSPLIT, AUTOSCALE_CHEAP, AUTOSCALE_EXPENSIVE = 6, 3, 4
# the expensive phase: a latency spike on about 2 reads in 5 of each
# micro-shard's read (65536-byte reads, more spikes than reads); chosen so
# that one server alone holds the trainer back (PERF.md §4)
AUTOSCALE_FAULT = "latency_ms=6,spikes=400,cap=65536,seed=5"
# each step is paced to this period: the cheap phase stays bound by the
# trainer, as bench.py paces its drain (25 ms a step there)
AUTOSCALE_PACE_MS = 10.0

AUTOSCALE_WORKER = """
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.dsserve import DsServeBatches
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
from dmlc_core_tpu_torch.telemetry import default_registry
from dmlc_core_tpu_torch.tracker.client import RabitWorker

# one trainer over the job's dsserve tier, epoch by epoch: cheap epochs
# over the plain file, then expensive ones over its fault:// latency wrap;
# a heartbeat every 0.2 s ships the time series the controller reads. The
# worker joins the rendezvous, and so starts sampling its time series and
# heartbeating, after its first 16 steps: neither the controller nor a
# replay of the report sees the wait for the servers' first producers
cheap_uri, slow_uri, out = sys.argv[1], sys.argv[2], sys.argv[3]
lr, n_cheap, n_slow = float(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
pace, dev = float(sys.argv[7]) / 1e3, torch.device(sys.argv[8])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
model = FactorizationMachine({d}, {e}, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
spec = BatchSpec(batch_size={b}, max_nnz={k}, value_dtype=np.float32)
reg = default_registry()
recv_key = 'trace.stall_seconds{{stage="dsserve_recv_wait"}}'
recv = lambda: reg.snapshot()["counters"].get(recv_key, 0.0)
w, joined = RabitWorker(), False
_build.reset_launches()
trained, staged, epochs, losses, step_s = [], [], [], [], []
last_hb, epoch = 0.0, 0
for phase, n, inner in (("cheap", n_cheap, cheap_uri), ("expensive", n_slow, slow_uri)):
    for _ in range(n):
        src = DsServeBatches("dsserve://" + os.environ["DMLC_DSSERVE"] + "/" + inner.lstrip("/"),
                             spec, epoch=epoch, mode="lease")
        src.on_slot = lambda shard, seq, payload, e=epoch: trained.append(
            (e, shard, hashlib.blake2b(payload).hexdigest()))
        pipe = StagingPipeline(src, device=dev)
        t0, r0, wall0, steps = time.perf_counter(), recv(), time.time(), 0
        for batch in pipe:
            # the batch's digest again, from its bytes on the device after
            # the host-to-device copy (the u8 tensor its views share)
            u8 = torch.empty(0, dtype=torch.uint8, device=dev).set_(
                batch["labels"].untyped_storage())
            staged.append(hashlib.blake2b(u8.cpu().numpy()).hexdigest())
            t1 = time.perf_counter()
            losses.append(float(model.sgd_step(batch, lr=lr)))
            sync()
            step_s.append(time.perf_counter() - t1)
            rest = pace - (time.perf_counter() - t1)
            if rest > 0:
                time.sleep(rest)
            steps += 1
            if not joined and steps == 16:
                w.start()
                joined = True
            now = time.monotonic()
            if joined and now - last_hb > 0.2:
                w.heartbeat()
                last_hb = now
        secs = time.perf_counter() - t0
        stats = src.io_stats()
        drain_close(pipe, src)
        epochs.append({{"phase": phase, "epoch": epoch, "steps": steps, "secs": secs,
                       "start_wall": wall0, "end_wall": time.time(),
                       "recv_wait_s": recv() - r0, "shards_recorded": stats["shards_recorded"]}})
        epoch += 1
launches = dict(_build.launches)
w.heartbeat()
np.savez(out + ".npz", **{{n: p.detach().cpu().numpy() for n, p in model.params().items()}})
with open(out + ".json", "w") as f:
    json.dump({{"launches": launches, "losses": losses, "step_s": step_s, "epochs": epochs,
               "trained": trained, "staged": staged}}, f)
w.shutdown()
"""


def autoscale_job(rec: str, dev, tmp: str, tag: str, fleet, fault: str,
                  n_cheap: int = AUTOSCALE_CHEAP, n_slow: int = AUTOSCALE_EXPENSIVE):
    """One trainer launched by ``submit`` (``fleet``: its tier flags) over
    ``dsserve://``: ``n_cheap`` epochs over the plain file, then
    ``n_slow`` over ``fault://<fault>``. Returns the trainer's record, the
    end-of-job report, the tracker's ``dmlc:autoscale_decision`` instants
    and the job's wall seconds."""
    import glob
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "autoscale_worker.py")
    with open(script, "w") as f:
        f.write(AUTOSCALE_WORKER.format(repo=repo, d=D, e=E, b=B, k=K))
    query = f"?index={rec}.idx&shuffle=record&seed=3"
    cheap, slow = rec + query, f"fault://{fault}{rec}{query}"
    prefix = os.path.join(tmp, f"autoscale_{tag}")
    trace_dir = prefix + ".trace"
    env = dict(os.environ, PYTHONPATH=repo, DMLC_METRICS_REPORT=prefix + ".report.json",
               **AUTOSCALE_KNOBS)
    for k in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_SHARD_RANK", "DMLC_TASK_ID",
              "DMLC_DSSERVE", "DMLC_DSSERVE_FILE", "DMLC_AUTOSCALE"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--host-ip", "127.0.0.1", "--num-workers", "1", *fleet,
         "--shard-oversplit", str(AUTOSCALE_OVERSPLIT), "--trace-dir", trace_dir,
         # the backend runs the command through bash: quote the URIs' "&"
         sys.executable, script, shlex.quote(cheap), shlex.quote(slow), prefix,
         str(SHARD_LR), str(n_cheap), str(n_slow), str(AUTOSCALE_PACE_MS), dev.type],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=repo,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        fail(f"autoscale {tag}: the job did not end in {JOB_TIMEOUT} s\n{stderr[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"autoscale {tag} exited {proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    with open(prefix + ".json") as f:
        res = json.load(f)
    with open(prefix + ".report.json") as f:
        report = json.load(f)
    instants = []
    for path in glob.glob(os.path.join(trace_dir, "dmlc-trace-tracker-*.json")):
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        instants += [{"wall": ev["ts"] / 1e6, **(ev.get("args") or {})} for ev in events
                     if ev.get("name") == "dmlc:autoscale_decision"]
    instants.sort(key=lambda ev: ev["wall"])
    return res, report, instants, wall, prefix + ".report.json"


def local_epoch_digests(rec: str, spec, n_epochs: int, m: int, keep: dict):
    """Each (epoch, micro-shard) of the autoscale phase's read as the
    local producer gives it: part ``i`` of ``m`` of ``shuffle=record``
    with the epoch on the URI, as a dsserve server builds it; each batch
    kept in ``keep`` under its digest."""
    from dmlc_core_tpu_torch.staging.batcher import alloc_ell_slot, ell_batch
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    out = {}
    for epoch in range(n_epochs):
        uri = f"{rec}?index={rec}.idx&shuffle=record&seed=3" + (f"&epoch={epoch}" if epoch else "")
        for i in range(m):
            src = ell_batches(uri, spec, part_index=i, num_parts=m)
            part = []
            for b in src:
                h = hashlib.blake2b(b.packed).hexdigest()
                part.append(h)
                packed, views = alloc_ell_slot(spec)
                np.copyto(packed, b.packed)
                keep[h] = ell_batch(packed, views, b.n_valid)
            src.close()
            out[(epoch, i)] = part
    return out


def autoscale_run(tag: str, res, report, instants, wall, local, batches, dev):
    """Gates of one run (each (epoch, micro-shard) trained once, equal to
    the local producer's; no duplicate; K1-K4 once a step; the params
    within PARAM_REL of a one-process replay of the batches trained) and
    its numbers."""
    from collections import defaultdict

    by_shard = defaultdict(list)
    for epoch, shard, h in res["trained"]:
        by_shard[(epoch, shard)].append(h)
    if dict(by_shard) != local:
        bad = sorted(k for k in set(by_shard) | set(local) if by_shard.get(k) != local.get(k))
        fail(f"autoscale {tag}: (epoch, micro-shard) batches differ from the local "
             f"producer's: {bad[:8]}")
    received = [h for _e, _s, h in res["trained"]]
    if res["staged"] != received:
        bad = [i for i, (a, b) in enumerate(zip(res["staged"], received)) if a != b]
        fail(f"autoscale {tag}: {len(bad)} of {len(received)} batches changed between their "
             f"receipt and the device (first at step {bad[:1]}; {len(res['staged'])} staged)")
    ledger = report.get("shards") or {}
    if ledger.get("duplicates", 0) != 0:
        fail(f"autoscale {tag}: duplicates in the ledger: {ledger}")
    if any(ep["shards_recorded"] != AUTOSCALE_OVERSPLIT for ep in res["epochs"]):
        fail(f"autoscale {tag}: an epoch did not record each micro-shard once: "
             f"{res['epochs']}")
    n = len(res["losses"])
    if any(res["launches"][k] != n for k in KERNEL_NAMES):
        fail(f"autoscale {tag}: {n} steps, launches {res['launches']}")
    if not np.mean(res["losses"][-4:]) < np.mean(res["losses"][:4]):
        fail(f"autoscale {tag}: the loss did not fall")
    params = dict(np.load(res["npz"]))
    want, rounds, replay_s = shard_replay(dev, batches, [[h for _e, _s, h in res["trained"]]])
    gap = param_gap(params, want)
    check_gap(gap, f"autoscale {tag} against the one-process replay")
    phases = {}
    for ph in ("cheap", "expensive"):
        eps = [ep for ep in res["epochs"] if ep["phase"] == ph]
        secs = sum(ep["secs"] for ep in eps)
        phases[ph] = {"epoch_secs": [ep["secs"] for ep in eps], "makespan_s": secs,
                      "recv_wait_share": sum(ep["recv_wait_s"] for ep in eps) / secs,
                      "start_wall": eps[0]["start_wall"], "end_wall": eps[-1]["end_wall"]}
    return {"wall_s": wall, "steps": n, "step_ms": statistics.median(res["step_s"]) * 1e3,
            "staged_digests_equal": True, "phases": phases, "ledger": ledger, "autoscale": report.get("autoscale"),
            "replay_gap": gap, "replay_rounds": rounds, "replay_s": replay_s,
            "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
            "actions": [ev for ev in instants if ev.get("kind") != "hold"],
            "holds": {r: sum(1 for ev in instants if ev.get("kind") == "hold"
                             and ev.get("reason") == r)
                      for r in sorted({ev.get("reason") for ev in instants
                                       if ev.get("kind") == "hold"})}}


def autoscale_replay(report_path: str, cfg_args):
    """``python -m dmlc_core_tpu_torch.tools autoscale replay`` over an
    end-of-job report: its decisions, each with its wall time (the
    replay's ``t`` counts from the report's first sample)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools", "autoscale", "replay",
         report_path, *cfg_args, "--json"],
        capture_output=True, text=True, timeout=120, cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo))
    if proc.returncode != 0:
        fail(f"tools autoscale replay exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(report_path) as f:
        series = json.load(f)["timeseries"]["per_rank"]
    t0 = min(s["t"] for rank in series.values() for s in rank)
    return [{**d, "wall": t0 + d["t"]} for d in json.loads(proc.stdout)]


def autoscale_phase(dev, card: str):
    """``bench.py``'s autoscale_phase_shift with the card's FM as the
    trainer: one worker, launched by the port's ``submit``, drains the
    shuffle phase's 2^18 indexed rows through ``dsserve://``
    (``shuffle=record``, AUTOSCALE_OVERSPLIT micro-shards an epoch):
    AUTOSCALE_CHEAP epochs over the plain file, then AUTOSCALE_EXPENSIVE
    over ``fault://AUTOSCALE_FAULT``. Two runs: fixed (``--dsserve 2``)
    and autoscaled (``--autoscale 1:2``). Gates: the autoscaled run makes
    a ``scale_up``, its first in the expensive phase (the tracker's
    ``dmlc:autoscale_decision`` instants) and at most 2 direction
    changes; ``tools autoscale replay`` of its report also scales up
    first in the expensive phase; both runs' (epoch, micro-shard)
    batches equal the local producer's, no duplicate, and the params
    within PARAM_REL of a one-process replay. Returns the
    ``{"autoscale": ...}`` line and the launches of both trainers."""
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    out = {"card": card, "rows": PRODUCER_ROWS, "fault": AUTOSCALE_FAULT,
           "pace_ms": AUTOSCALE_PACE_MS, "knobs": AUTOSCALE_KNOBS,
           "oversplit": AUTOSCALE_OVERSPLIT, "epochs": [AUTOSCALE_CHEAP, AUTOSCALE_EXPENSIVE]}
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), PRODUCER_ROWS, D))
        batches = {}
        local = local_epoch_digests(rec, spec, AUTOSCALE_CHEAP + AUTOSCALE_EXPENSIVE,
                                    AUTOSCALE_OVERSPLIT, batches)
        for tag, fleet in (("fixed", ["--dsserve", "2"]),
                           ("autoscaled", ["--autoscale", "1:2"])):
            res, report, instants, wall, report_path = autoscale_job(
                rec, dev, tmp, tag, fleet, AUTOSCALE_FAULT)
            res["npz"] = os.path.join(tmp, f"autoscale_{tag}.npz")
            out[tag] = autoscale_run(tag, res, report, instants, wall, local, batches, dev)
            for k in KERNEL_NAMES:
                launches[k] += res["launches"][k]
            if tag == "autoscaled":
                out["replay"] = autoscale_replay(report_path, [
                    "--fleet", "1:2", "--interval", AUTOSCALE_KNOBS["DMLC_AUTOSCALE_INTERVAL"],
                    "--window", AUTOSCALE_KNOBS["DMLC_AUTOSCALE_WINDOW"],
                    "--dwell", AUTOSCALE_KNOBS["DMLC_AUTOSCALE_DWELL"]])
        del batches
    auto = out["autoscaled"]
    status = auto["autoscale"] or {}
    start = auto["phases"]["expensive"]["start_wall"]
    ups = [ev for ev in auto["actions"] if ev.get("kind") == "scale_up"]
    if not (status.get("decisions", {}).get("scale_up", 0) >= 1 and ups):
        fail(f"autoscale: no scale_up: {status}, actions {auto['actions']}")
    if not ups[0]["wall"] >= start:
        fail(f"autoscale: the first scale_up ({ups[0]}) came before the expensive phase "
             f"began ({start})")
    if status.get("direction_changes", 0) > 2:
        fail(f"autoscale: {status['direction_changes']} direction changes")
    replay_ups = [d for d in out["replay"] if d["kind"] == "scale_up"]
    if not (replay_ups and replay_ups[0]["wall"] >= start):
        fail(f"autoscale: the replay's first scale_up {replay_ups[:1]} is not in the "
             f"expensive phase (from {start})")
    fixed_ms = out["fixed"]["phases"]["expensive"]["makespan_s"]
    auto_ms = auto["phases"]["expensive"]["makespan_s"]
    out["summary"] = {
        "expensive_makespan_fixed_s": fixed_ms, "expensive_makespan_autoscaled_s": auto_ms,
        "makespan_ratio": auto_ms / fixed_ms, "bench_expectation": "<= 1.25",
        "held": auto_ms / fixed_ms <= 1.25,
        "first_scale_up_after_expensive_start_s": ups[0]["wall"] - start,
        "replay_first_scale_up_after_expensive_start_s": replay_ups[0]["wall"] - start,
        "cost_spent": status.get("cost_spent"),
        "recv_wait_share": {tag: {ph: out[tag]["phases"][ph]["recv_wait_share"]
                                  for ph in ("cheap", "expensive")}
                            for tag in ("fixed", "autoscaled")},
    }
    out["replay"] = [d for d in out["replay"] if d["kind"] != "hold"]
    return out, launches


# -- the stream phase: the FM follows a live stream ------------------------------------
# a writer process appends STREAM_ROWS Criteo rows (43 MB of rowrec) paced
# at STREAM_RATE rows/s, committing every STREAM_COMMIT records; zlib packs
# these rows to about 0.42 of their size (18 MB), so it rotates every
# STREAM_ROTATE_BYTES of compressed shard: 3 times a run, then the seal at
# EOS (at 16 MiB it would rotate once). The follower reads windows of
# STREAM_WINDOW records (8 batches), fails after STREAM_IDLE s with no
# writer progress, and its lag's p99 must stay under STREAM_LAG_P99 s
# (bench.py's stream_online bound, bench.py:2087)
STREAM_ROWS, STREAM_RATE, STREAM_COMMIT = 1 << 17, 100_000.0, 8192
STREAM_ROTATE_BYTES, STREAM_WINDOW, STREAM_IDLE, STREAM_LAG_P99 = 5 << 20, 16384, 120.0, 2.0
STREAM_LR, STREAM_OVERSPLIT = 0.5, 4

STREAM_WRITER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import chip_smoke as cs
from dmlc_core_tpu_torch.stream import StreamWriter

# the stream directory, the rows' seed and a file to wait for: the
# writer makes its rows, says so in <go>.ready and starts once <go> exists
d, seed, go = sys.argv[1], int(sys.argv[2]), sys.argv[3]
payloads = cs.row_payloads(*cs.criteo_data(np.random.default_rng(seed), {rows}, {d_}))
open(go + ".ready", "w").close()
t0 = time.monotonic()
while not os.path.exists(go):
    if time.monotonic() - t0 > 300:
        sys.exit("the followers never started")
    time.sleep(0.02)
t0 = time.perf_counter()
with StreamWriter(d, codec="zlib", commit_records={commit}, rotate_bytes={rotate}) as w:
    for i, p in enumerate(payloads):
        w.append(p)
        if i % 1024 == 1023:
            ahead = t0 + (i + 1) / {rate} - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
print(json.dumps({{"wall_s": time.perf_counter() - t0, **w.stats()}}))
"""

STREAM_TRAINER = """
import hashlib, json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.io.recordio import RecordIOChunkReader
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
from dmlc_core_tpu_torch.stream import manifest as sm
from dmlc_core_tpu_torch.tracker.client import RabitWorker

d, out, go, dev = sys.argv[1], sys.argv[2], sys.argv[3], torch.device(sys.argv[4])
w = RabitWorker()
rank = w.start()
src = ell_batches(d + "/manifest.json?dynamic_shards=1&shuffle=window&window={window}&seed=7",
                  BatchSpec(batch_size={b}, max_nnz={k}, value_dtype=np.float32))
split = src._split  # the StreamSource the producer follows
split._max_idle = {idle}
by_gen, events = {{}}, []
split.on_shard_done = lambda gen, shard, status: events.append([gen, shard, status])
pull = split.next_gather_batch

def spy(n):
    # each record the producer takes, by the generation it came from
    g = pull(n)
    if g is not None:
        buf, starts, sizes = g
        digests = by_gen.setdefault(str(split.generation), [])
        for s0, z in zip(starts.tolist(), sizes.tolist()):
            frame = buf[s0:s0 + z]
            p = sm.frame_payload(frame)
            rec = (p.tobytes() if p is not None
                   else bytes(RecordIOChunkReader(frame.tobytes()).next_record()))
            digests.append(hashlib.blake2b(rec, digest_size=8).hexdigest())
    return g

split.next_gather_batch = spy
if rank == 0:
    open(go, "w").close()  # the writer starts now
model = FactorizationMachine({d_}, {e}, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
pipe = StagingPipeline(src, device=dev)
losses = []
_build.reset_launches()
t0 = time.perf_counter()
for batch in pipe:
    losses.append(float(model.sgd_step(batch, lr={lr})))
wall = time.perf_counter() - t0
launches = dict(_build.launches)
stats = split.io_stats()
drain_close(pipe, src)
with open(f"{{out}}.rank{{rank}}.json", "w") as f:
    json.dump({{"rank": rank, "by_gen": by_gen, "events": events, "losses": losses,
               "launches": launches, "wall_s": wall, "io_stats": stats}}, f)
w.shutdown()
"""


def row_payloads(idx, val, labels) -> list:
    """Each Criteo row's rowrec record (what a stream writer appends)."""
    from dmlc_core_tpu_torch.io.recordio import RecordIOChunkReader
    from dmlc_core_tpu_torch.stream import manifest as sm

    framed = rowrec_bytes(idx, val, labels)
    view = memoryview(framed)
    out = []
    for s0, z in zip(*(a.tolist() for a in sm.walk_frames(framed))):
        p = sm.frame_payload(view[s0:s0 + z])
        out.append(bytes(p) if p is not None
                   else bytes(RecordIOChunkReader(bytes(view[s0:s0 + z])).next_record()))
    return out


def stream_writer(tmp: str, d: str, seed: int, go: str):
    """The STREAM_WRITER process into ``d`` (made here); it appends once
    the file ``go`` exists."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "stream_writer.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(STREAM_WRITER.format(repo=repo, rows=STREAM_ROWS, d_=D,
                                         commit=STREAM_COMMIT, rotate=STREAM_ROTATE_BYTES,
                                         rate=STREAM_RATE))
    os.makedirs(d)
    return subprocess.Popen([sys.executable, script, d, str(seed), go],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=repo), cwd=repo)


def writer_stats(proc, what: str) -> dict:
    """The writer's last stdout line (its stats) once it exited 0."""
    try:
        out, err = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        fail(f"{what}: the stream writer ran past {JOB_TIMEOUT} s")
    if proc.returncode != 0:
        fail(f"{what}: the stream writer exited {proc.returncode}:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def sealed_record_digests(d: str) -> dict:
    """The sealed stream's record digests by generation, each shard read
    alone as an indexed file."""
    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.stream import manifest as sm

    m = sm.read_manifest(d)
    if not (m["eos"] and m["live"] is None):
        fail(f"stream {d} was not sealed: {m}")
    out = {}
    for ent in m["sealed"]:
        sp = io_split.create(sm.join(d, ent["data"]), type="recordio",
                             index_uri=sm.join(d, ent["index"]), threaded=False)
        out[str(ent["gen"])] = sorted(hashlib.blake2b(bytes(r), digest_size=8).hexdigest()
                                      for r in iter(sp.next_record, None))
        sp.close()
    return out


def stream_live(dev, tmp: str, make, spec):
    """(a): the FM follows the writer's stream live, then the same model
    seed over a drain of the sealed stream; the lag sampled a step."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.stream import manifest as sm
    from dmlc_core_tpu_torch.telemetry import default_registry

    d, go = os.path.join(tmp, "live"), os.path.join(tmp, "live.go")
    uri = f"{d}/manifest.json?shuffle=window&window={STREAM_WINDOW}&seed=7"
    gauge = default_registry().gauge("stream.lag_seconds")
    lags = []
    writer = stream_writer(tmp, d, 5, go)
    model = make()
    try:
        deadline = time.monotonic() + JOB_TIMEOUT
        while not os.path.exists(go + ".ready"):  # the writer made its rows
            if writer.poll() is not None or time.monotonic() > deadline:
                fail(f"stream (a): the writer did not get ready: {writer.communicate()[1]}")
            time.sleep(0.02)
        src = ell_batches(uri, spec)
        split = src._split  # the StreamSource the producer follows
        split._max_idle = STREAM_IDLE
        open(go, "w").close()
        live, _, _ = drive("stream_live", model, src, dev, STREAM_LR, digests=True,
                           on_step=lambda step, batch: lags.append(gauge.value()))
    except BaseException:
        writer.kill()
        writer.communicate()
        raise
    io = split.io_stats()
    wstats = writer_stats(writer, "stream (a)")
    m = sm.read_manifest(d)
    replay_model = make()
    post, _, _ = drive("stream_posthoc", replay_model, ell_batches(uri, spec), dev, STREAM_LR,
                       digests=True)
    if live["digests"] != post["digests"]:
        fail("stream (a): the live pass's batches differ from the sealed stream's drain")
    gap = param_gap(fm_params(model), fm_params(replay_model))
    check_gap(gap, "stream (a): the live FM against the replay over the sealed drain")
    if live["rows_staged"] != STREAM_ROWS or sum(e["records"] for e in m["sealed"]) != STREAM_ROWS:
        fail(f"stream (a): {live['rows_staged']} rows staged, manifest {m['sealed']}")
    lag = {"p50_s": float(np.percentile(lags, 50)), "p99_s": float(np.percentile(lags, 99)),
           "max_s": float(max(lags)), "samples": len(lags)}
    if io["rotations_seen"] < 2 or not io["tail_wait_secs"] > 0:
        fail(f"stream (a): the follower saw {io['rotations_seen']} rotations and waited "
             f"{io['tail_wait_secs']} s on the writer")
    if not lag["p99_s"] < STREAM_LAG_P99:
        fail(f"stream (a): lag p99 {lag['p99_s']} s >= {STREAM_LAG_P99} s")
    pick = ("steps", "step_ms", "staged_rows_per_sec", "wait_share", "wall_s", "rows_staged",
            "loss_first", "loss_last")
    return {"live": {k: live[k] for k in pick}, "posthoc": {k: post[k] for k in pick},
            "writer": wstats, "generations": len(m["sealed"]),
            "stream_tail_wait_s": io["tail_wait_secs"],
            "commits_seen": io["commits_seen"], "rotations_seen": io["rotations_seen"],
            "extents": io["extents"], "lag": lag, "vs_posthoc": gap,
            "batches_equal": len(live["digests"])}, [live, post]


def stream_leased(dev, tmp: str):
    """(b): two FM trainers under ``submit`` follow a stream with
    ``&dynamic_shards=1`` while its writer writes (the writer starts once
    rank 0 is up)."""
    from collections import Counter

    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "stream_trainer.py")
    with open(script, "w") as f:
        f.write(STREAM_TRAINER.format(repo=repo, window=STREAM_WINDOW, b=B, k=K, d_=D, e=E,
                                      idle=STREAM_IDLE, lr=STREAM_LR))
    d, go = os.path.join(tmp, "leased"), os.path.join(tmp, "leased.go")
    prefix, report_path = os.path.join(tmp, "leased"), os.path.join(tmp, "leased.report.json")
    writer = stream_writer(tmp, d, 6, go)
    try:
        _, wall = submit_job(["--num-workers", "2", "--shard-oversplit", str(STREAM_OVERSPLIT),
                              sys.executable, script, d, prefix, go, dev.type],
                             env={"DMLC_METRICS_REPORT": report_path})
    except BaseException:
        writer.kill()
        writer.communicate()
        raise
    wstats = writer_stats(writer, "stream (b)")
    want = sealed_record_digests(d)
    n_gen, m = len(want), 2 * STREAM_OVERSPLIT
    with open(report_path) as f:
        ledger = json.load(f).get("shards") or {}
    ranks, got, recorded = [], {}, []
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for r in range(2):
        with open(f"{prefix}.rank{r}.json") as f:
            res = json.load(f)
        n = len(res["losses"])
        if any(res["launches"][k] != n for k in KERNEL_NAMES) or not all(
                np.isfinite(res["losses"])):
            fail(f"stream (b) rank {r}: launches {res['launches']} for {n} steps, "
                 f"losses {res['losses'][:4]}...")
        for k in KERNEL_NAMES:
            launches[k] += n
        for gen, ds in res["by_gen"].items():
            got.setdefault(gen, []).extend(ds)
        recorded += [(g, s) for g, s, st in res["events"] if st == "recorded"]
        ranks.append({"rank": r, "steps": n, "wall_s": res["wall_s"],
                      "rows": sum(map(len, res["by_gen"].values())),
                      "generations": sorted(res["by_gen"]),
                      "lease_wait_s": res["io_stats"].get("dyn_lease_wait_secs"),
                      "tail_wait_s": res["io_stats"]["tail_wait_secs"],
                      "loss_first": res["losses"][0], "loss_last": res["losses"][-1]})
    for gen, ds in want.items():
        if sorted(got.get(gen, [])) != ds:
            fail(f"stream (b): generation {gen}: the ranks trained {len(got.get(gen, []))} "
                 f"records, not the sealed shard's {len(ds)} once each")
    if set(got) != set(want):
        fail(f"stream (b): the ranks trained generations {sorted(got)}, sealed {sorted(want)}")
    per_gen = Counter(g for g, _ in recorded)
    if len(recorded) != len(set(recorded)) or any(per_gen[int(g)] != m for g in want):
        fail(f"stream (b): micro-shards recorded {sorted(recorded)}")
    if not (ledger.get("duplicates") == 0
            and ledger.get("completed") == ledger.get("granted") == m * n_gen):
        fail(f"stream (b): the tracker's ledger {ledger} for {n_gen} generations of {m}")
    return {"wall_s": wall, "writer": wstats, "generations": n_gen, "micro_shards": m,
            "ledger": ledger, "ranks": ranks,
            "records": sum(len(v) for v in want.values())}, launches


def stream_phase(dev, card: str):
    """Live streams at the Criteo width: (a) the FM follows a writer
    process's stream in this process, (b) two leased trainers under
    ``submit``. Returns the ``{"stream": ...}`` line and the launches of
    every FM step."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def make():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        live, runs = stream_live(dev, tmp, make, spec)
        leased, launches = stream_leased(dev, tmp)
    for run in runs:
        for k in KERNEL_NAMES:
            if run["launches"][k] != run["steps"]:
                fail(f"stream phase: launches {run['launches']} for {run['steps']} steps")
            launches[k] += run["launches"][k]
    return {"card": card, "rows": STREAM_ROWS, "rate_target": STREAM_RATE,
            "commit_records": STREAM_COMMIT, "rotate_bytes": STREAM_ROTATE_BYTES,
            "window": STREAM_WINDOW, "live": live, "leased": leased,
            "seconds": time.perf_counter() - t_phase}, launches


# -- the lookup phase: point reads over the zlib corpus -------------------------------
# bench.py's point_lookup_zipf (bench.py:597-640): Zipf(LOOKUP_ALPHA) over a
# permuted key space, LOOKUP_KEYS keys in batches of LOOKUP_BATCH with
# negatives at keys[7::61]; then its served part, LOOKUP_REQUESTS requests of
# LOOKUP_REQ_BATCH keys on the warm server (bench.py:720-750)
LOOKUP_ALPHA, LOOKUP_KEYS, LOOKUP_BATCH = 1.1, 360, 60
LOOKUP_REQUESTS, LOOKUP_REQ_BATCH, LOOKUP_WARM = 300, 16, 64
LOOKUP_GROWING_ROWS = 200


def lookup_keys(n: int):
    """bench.py's key sequence over ``n`` keys, and its served requests."""
    rng = np.random.default_rng(29)
    scatter = rng.permutation(n)
    p = 1.0 / np.arange(1, n + 1) ** LOOKUP_ALPHA
    p /= p.sum()
    keys = scatter[rng.choice(n, size=LOOKUP_KEYS, p=p)].tolist()
    keys[7::61] = [n * 10 + i for i in range(len(keys[7::61]))]
    return keys, scatter[rng.choice(n, size=(LOOKUP_REQUESTS, LOOKUP_REQ_BATCH), p=p)]


def answers_sha(keys, answers) -> str:
    sha = hashlib.sha256()
    for k, v in zip(keys, answers):
        sha.update(b"%d:" % k)
        sha.update(b"<none>" if v is None else v)
    return sha.hexdigest()


def naive_lookup(handle, path: str, keys) -> list:
    """bench.py's run_naive: per key, open the shard, seek to the
    record's block, read, decode and slice it (key resolution through the
    handle's index)."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.io.recordio import RecordIOChunkReader, scan_compressed_blob
    from dmlc_core_tpu_torch.io.stream import Stream

    sp = handle._sp
    out = []
    for k in keys:
        hit, recs = handle._resolve([k])
        if not bool(hit[0]):
            out.append(None)
            continue
        rec = int(recs[0])
        bid = int(sp._rec_block[rec])
        with Stream.create(path, "r") as s:
            s.seek(int(sp._block_offs[bid]))
            data = s.read_exact(int(sp._block_sizes[bid]))
        blob, _end = scan_compressed_blob(memoryview(data), 0)
        raw, _n = codec.decode_block(blob)
        start, end = int(sp._rec_inoff[rec]), int(sp._rec_next[rec])
        framed = raw[start:] if end < 0 else raw[start:end]
        out.append(bytes(RecordIOChunkReader(framed, 0, 1).next_record()))
    return out


def tools_info(uri: str) -> dict:
    """``python -m dmlc_core_tpu_torch.tools info uri``'s shard section."""
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "info", uri],
                          capture_output=True, text=True, timeout=120, cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo))
    if proc.returncode != 0:
        fail(f"tools info {uri} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)["shard"]


def lookup_server(tmp: str, zrec: str, metrics_port: int):
    """``tools serve`` as a process: (process, port) once its port file
    names the endpoint."""
    repo = os.path.dirname(os.path.abspath(__file__))
    pf = os.path.join(tmp, "lookup.port.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools", "serve", zrec, "--port-file", pf,
         "--metrics-port", str(metrics_port), "--warm", str(LOOKUP_WARM)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo))
    deadline = time.monotonic() + 120
    while not os.path.exists(pf):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            fail(f"tools serve did not start: {proc.communicate()[1][-2000:]}")
        time.sleep(0.05)
    with open(pf) as f:
        return proc, json.load(f)["port"]


def growing_shard(tmp: str) -> dict:
    """``tools info`` on a stream's live shard whose tail was never
    committed: 'growing'; once the writer seals it, its geometry
    (``RecordLookup.describe``, what ``tools info`` prints)."""
    from dmlc_core_tpu_torch.io.lookup import RecordLookup
    from dmlc_core_tpu_torch.stream import StreamWriter
    from dmlc_core_tpu_torch.stream import manifest as sm

    d = os.path.join(tmp, "growing")
    os.makedirs(d)
    rows = row_payloads(*criteo_data(np.random.default_rng(8), LOOKUP_GROWING_ROWS, D))
    # blocks of 16 KiB: several reach the file, their index lines stay in
    # the writer's buffer
    w = StreamWriter(d, codec="zlib", block_bytes=16 << 10, commit_records=0)
    try:
        for row in rows:
            w.append(row)
        live = sm.read_manifest(d)["live"]
        growing = tools_info(sm.join(d, live["data"]))
    finally:
        w.close(eos=True)
    # the sealed shard's geometry in this process: what tools info prints
    h = RecordLookup(sm.join(d, sm.read_manifest(d)["sealed"][0]["data"]))
    sealed = h.describe()
    h.close()
    if not str(growing.get("status", "")).startswith("growing") or live["bytes"] != 0:
        fail(f"tools info on a live shard with no commit: {growing}, watermark {live}")
    if sealed.get("records") != LOOKUP_GROWING_ROWS or "status" in sealed:
        fail(f"tools info on the sealed shard: {sealed}")
    return {"live": growing, "sealed": sealed}


def lookup_phase(card: str):
    """Point lookups over the shuffle phase's rows in zlib blocks of 1 MiB:
    ``tools serve`` as a process, a client, an in-process handle and the
    naive per-key read on bench.py's Zipf keys; ``/metrics``; SIGTERM;
    ``tools info``. No kernel runs here. Returns the ``{"lookup": ...}``
    line."""
    import signal
    import socket

    from dmlc_core_tpu_torch.io import codec, retry
    from dmlc_core_tpu_torch.io.lookup import LookupClient, RecordLookup

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(3), PRODUCER_ROWS, D))
        zrec = write_compressed(rec, os.path.join(tmp, "criteo.zlib.rec"), "zlib", CODEC_BLOCK)
        blocks = count_blocks(zrec)
        keys, requests = lookup_keys(PRODUCER_ROWS)
        negatives = set(range(7, LOOKUP_KEYS, 61))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            mport = sock.getsockname()[1]
        proc, port = lookup_server(tmp, zrec, mport)
        try:
            client = LookupClient("127.0.0.1", port)
            seq_lat, served_lat, answers = [], [], []
            t0 = time.perf_counter()
            for at in range(0, LOOKUP_KEYS, LOOKUP_BATCH):
                t1 = time.perf_counter()
                answers += client.lookup(keys[at:at + LOOKUP_BATCH])
                seq_lat.append(time.perf_counter() - t1)
            seq_s = time.perf_counter() - t0
            client.warm(requests.ravel().tolist())
            t0 = time.perf_counter()
            for r in range(LOOKUP_REQUESTS):
                t1 = time.perf_counter()
                client.lookup(requests[r].tolist())
                served_lat.append(time.perf_counter() - t1)
            served_s = time.perf_counter() - t0
            server_stats = client.stats()
            client.close()
            with retry.request(f"http://127.0.0.1:{mport}/metrics", timeout=30.0) as resp:
                metrics = resp.read().decode()
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                _, err = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                fail("tools serve ignored SIGTERM for 60 s")
        if proc.returncode != 0:
            fail(f"tools serve exited {proc.returncode} on SIGTERM: {err[-2000:]}")
        final = json.loads(err.strip().splitlines()[-1])
        h = RecordLookup(zrec, merge_gap=0, decode_ctx=codec.DecodeContext(
            cache=codec.DecodedBlockCache(256 << 20), shared=None))
        try:
            t0 = time.perf_counter()
            handle_answers = []
            for at in range(0, LOOKUP_KEYS, LOOKUP_BATCH):
                handle_answers += h.lookup(keys[at:at + LOOKUP_BATCH])
            batched_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            naive = naive_lookup(h, zrec, keys)
            naive_s = time.perf_counter() - t0
            hstats = h.io_stats()
        finally:
            h.close()
        shas = {"server": answers_sha(keys, answers),
                "handle": answers_sha(keys, handle_answers),
                "naive": answers_sha(keys, naive)}
        if len(set(shas.values())) != 1:
            fail(f"lookup: the server, the handle and the naive read disagree: {shas}")
        if {i for i, v in enumerate(answers) if v is None} != negatives:
            fail("lookup: the negatives are not exactly keys[7::61]")
        if "dmlc_io_lookup_request_seconds" not in metrics:
            fail("lookup: /metrics has no dmlc_io_lookup_request_seconds")
        info = tools_info(zrec)
        if not (info["records"] == PRODUCER_ROWS and info["codec"] == "zlib"
                and info["blocks"] == blocks):
            fail(f"lookup: tools info says {info}, the corpus has {blocks} blocks")
        growing = growing_shard(tmp)

    def ms(lat, q):
        return float(np.percentile(lat, q)) * 1e3

    return {"card": card, "rows": PRODUCER_ROWS, "blocks": blocks, "alpha": LOOKUP_ALPHA,
            "kernels": "none: the lookup path serves bytes and runs no kernel",
            "sequence": {"keys": LOOKUP_KEYS, "batch": LOOKUP_BATCH,
                         "negatives": len(negatives), "sha256": shas["server"],
                         "p50_ms": ms(seq_lat, 50), "p99_ms": ms(seq_lat, 99),
                         "qps": len(seq_lat) / seq_s, "client_s": seq_s,
                         "batched_s": batched_s, "naive_s": naive_s,
                         "batched_speedup": naive_s / batched_s,
                         "handle_block_misses": hstats["block_cache_misses"],
                         "handle_spans": hstats["spans"]},
            "served": {"requests": LOOKUP_REQUESTS, "keys_per_request": LOOKUP_REQ_BATCH,
                       "p50_ms": ms(served_lat, 50), "p99_ms": ms(served_lat, 99),
                       "qps": LOOKUP_REQUESTS / served_s},
            "server": {k: server_stats[k] for k in ("requests", "p50_ms", "p99_ms",
                                                    "block_cache_hits", "block_cache_misses")},
            "sigterm_rc": proc.returncode, "final_stats_requests": final["requests"],
            "info": info, "growing": growing,
            "seconds": time.perf_counter() - t_phase}


# -- the parallel phase: the FM over a rank mesh through torch.distributed -----------
# the jobs' lengths: (a) and (b) drain a file of PAR_LONG batches, (c) one of
# PAR_SHORT, saving at PAR_SAVE_STEP; (d) resumes (c) there and runs to its end
PAR_LONG, PAR_SHORT, PAR_SAVE_STEP, PAR_LR = 32, 16, 8, 0.5

PAR_WORKER = """
import hashlib, json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.parallel import (P, data_parallel_step, destroy_process_group,
                                          init_process_group, make_mesh, place_model,
                                          process_shard)
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

uri, out, backend, shape, lr, save_step, ck_dir, restore, rows = sys.argv[1:10]
local = rows == "local"  # this rank reads and stages only its own rows
shape = tuple(int(x) for x in shape.split("x"))
lr, save_step = float(lr), int(save_step)
if not torch.cuda.is_available():
    raise SystemExit("a rank found no GPU")
rank, world = init_process_group(backend=backend)  # no other backend is tried
mesh = make_mesh(shape, ("data", "model"))
# the backend's own collective, checked: the NCCL or gloo all_reduce on the card
probe = torch.full((4,), float(rank + 1), device=mesh.device)
dist.all_reduce(probe)
if probe.tolist() != [world * (world + 1) / 2] * 4:
    raise SystemExit(f"all_reduce on {{backend}} gave {{probe.tolist()}}")
model = FactorizationMachine({d}, {e}, device=mesh.device,
                             generator=torch.Generator(device=mesh.device).manual_seed(0))
rules = {{"v": P(None, "model")}} if mesh.shape["model"] > 1 else None
place_model(model, mesh, rules)
first = 0
if restore != "-":
    ck = Checkpointer(restore)
    _, tree = ck.restore(template=model.placed())
    model.load_placed(tree)
    first = ck.restore_meta()["batches"]
    uri += f"&skip_records={{first * {b}}}"
step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=lr), mesh, "data", rules)
part, nparts = process_shard(mesh) if local else (0, 1)
src = ell_batches(uri, BatchSpec(batch_size={b} // nparts, max_nnz={k}, value_dtype=np.float32),
                  part_index=part, num_parts=nparts)

class Producer:
    # the rank's producer, timed: the rows it parsed and the host seconds
    # its batches took to come out of it
    def __init__(self, src):
        self.src, self.rows, self.seconds = src, 0, 0.0
        self.ring_slots, self.spec = src.ring_slots, getattr(src, "spec", None)

    def __iter__(self):
        it = iter(self.src)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            self.seconds += time.perf_counter() - t0
            if b is None:
                return
            self.rows += b.n_valid
            yield b

prod = Producer(src)
pipe = StagingPipeline(prod, mesh=mesh, local_rows=local)

def blocks(tag):
    np.savez(f"{{out}}.{{tag}}.rank{{rank}}.npz",
             **{{n: p.local.cpu().numpy() for n, p in model.placed().items()}},
             **{{n + "__index": np.array([[s.start, s.stop] for s in p.index])
                for n, p in model.placed().items()}})

# the collectives' time on the step's stream, from CUDA events around
# each all_reduce the step makes (no host sync added to the step)
coll_events = []
_all_reduce = dist.all_reduce
in_step = [False]  # the pipeline's end-of-part exchange is not the step's

def timed_all_reduce(*args, **kwargs):
    if not in_step[0]:
        return _all_reduce(*args, **kwargs)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = _all_reduce(*args, **kwargs)
    e1.record()
    coll_events.append((e0, e1))
    return out

dist.all_reduce = timed_all_reduce
_build.reset_launches()
losses, step_s, handle = [], [], None
batch_digests, row_digests = [], []
n = first
for batch in pipe:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    in_step[0] = True
    losses.append(float(step(model, batch)))  # syncs the step
    in_step[0] = False
    step_s.append(time.perf_counter() - t0)
    if local:  # what this rank staged, read back from the device tensors
        host = {{k: t.cpu().numpy() for k, t in batch.items()}}
        batch_digests.append(hashlib.blake2b(
            b"".join(host[k].tobytes() for k in sorted(host))).hexdigest())
        for i in np.flatnonzero(host["weights"] > 0):
            row_digests.append(hashlib.blake2b(
                host["indices"][i].tobytes() + host["values"][i].tobytes()
                + host["labels"][i].tobytes(), digest_size=16).hexdigest())
    n += 1
    if n == save_step:
        blocks(f"step{{n}}")
        handle = Checkpointer(ck_dir).save_async(n, model.placed(), meta={{"batches": n}})
launches = dict(_build.launches)
dist.all_reduce = _all_reduce
torch.cuda.synchronize()
coll_s = sum(e0.elapsed_time(e1) for e0, e1 in coll_events) / 1e3
staging = pipe.staging_stats()
rows_staged = pipe.rows_staged
drain_close(pipe, src)
if handle is not None:
    handle.result(timeout=120)
blocks("final")
with open(f"{{out}}.rank{{rank}}.json", "w") as f:
    json.dump({{"rank": rank, "world": world, "coords": mesh.coords, "backend": backend,
               "device": str(mesh.device), "launches": launches, "losses": losses,
               "step_s": step_s, "collectives": model.spmd.stats, "collective_s": coll_s,
               "staging": staging, "local": local, "part": [part, nparts],
               "rows_staged": rows_staged, "producer_rows": prod.rows,
               "producer_s": prod.seconds, "batch_digests": batch_digests,
               "row_digests": row_digests}}, f)
destroy_process_group()
"""


def par_gather(prefix: str, tag: str, n: int) -> dict:
    """The global params from the ranks' ``<prefix>.<tag>.rank<r>.npz``
    blocks (each block written where its index says)."""
    parts = [dict(np.load(f"{prefix}.{tag}.rank{r}.npz")) for r in range(n)]
    out = {}
    for name in ("w", "v", "b"):
        shape = tuple(int(hi) for _lo, hi in parts[0][name + "__index"])
        for p in parts[1:]:
            shape = tuple(max(s, int(hi)) for s, (_lo, hi) in zip(shape, p[name + "__index"]))
        full = np.empty(shape, np.float32)
        for p in parts:
            full[tuple(slice(int(lo), int(hi)) for lo, hi in p[name + "__index"])] = p[name]
        out[name] = full
    return out, parts


def par_replicas(parts, shape, what: str) -> None:
    """Bit-identical replicas: ``w`` and ``b`` on every rank (a model line
    and a data line both), each ``v`` block down its data line."""
    n_model = shape[1]
    for r, p in enumerate(parts):
        for name in ("w", "b"):
            if p[name].tobytes() != parts[0][name].tobytes():
                fail(f"{what}: rank {r}'s {name} differs from rank 0's")
        if p["v"].tobytes() != parts[r % n_model]["v"].tobytes():
            fail(f"{what}: rank {r}'s v block differs from rank {r % n_model}'s")


def par_job(tag: str, uri: str, tmp: str, backend: str, shape, restore: str = "-",
            save_step: int = 0, local: bool = False):
    """One meshed FM job through the port's launcher: ``prod(shape)``
    ranks on the card over ``backend``; with ``local`` each rank reads
    part ``process_shard(mesh)`` at B / (data axis) rows a batch and
    stages it with local rows. Returns (prefix, ranks' records, wall
    seconds); gates each rank's K1-K4 once a step, one host→device copy
    a batch (on the packed-shard path, or with local rows the one-device
    packed path with no padding batch), finite losses."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "par_worker.py")
    with open(script, "w") as f:
        f.write(PAR_WORKER.format(repo=repo, d=D, e=E, b=B, k=K))
    prefix = os.path.join(tmp, f"par_{tag}")
    n = int(np.prod(shape))
    _, wall = submit_job(["--num-workers", str(n), sys.executable, script, shlex.quote(uri),
                          prefix, backend, "x".join(map(str, shape)), str(PAR_LR),
                          str(save_step), os.path.join(tmp, "par_ck"), restore,
                          "local" if local else "global"])
    ranks = []
    for r in range(n):
        with open(f"{prefix}.rank{r}.json") as f:
            res = json.load(f)
        steps = len(res["losses"])
        if res["backend"] != backend or not res["device"].startswith("cuda"):
            fail(f"parallel {tag} rank {r}: ran on {res['device']} over {res['backend']}")
        if any(res["launches"][k] != steps for k in KERNEL_NAMES):
            fail(f"parallel {tag} rank {r}: {steps} steps, launches {res['launches']}")
        st = res["staging"]
        path = "packed_batches" if local else "packed_shard_batches"
        if not (st[path] == steps and st["device_puts"] == steps
                and st["per_array_batches"] == 0 and st.get("padding_batches", 0) == 0):
            fail(f"parallel {tag} rank {r}: {steps} steps, staging {st}")
        if not all(np.isfinite(res["losses"])):
            fail(f"parallel {tag} rank {r}: losses {res['losses']}")
        ranks.append(res)
    return prefix, ranks, wall


def par_summary(ranks, wall: float, gap=None) -> dict:
    """A job's numbers: step ms per rank (median) and the share of the
    step its collectives took (their CUDA-event time on the step's stream)."""
    return {"wall_s": wall, "steps": len(ranks[0]["losses"]),
            "loss_first": ranks[0]["losses"][0], "loss_last": ranks[0]["losses"][-1],
            "step_ms": [statistics.median(r["step_s"]) * 1e3 for r in ranks],
            "collective_share": [r["collective_s"] / sum(r["step_s"]) for r in ranks],
            "collectives_per_step": ranks[0]["collectives"]["collectives"] / len(ranks[0]["losses"]),
            "collective_mb_per_step": ranks[0]["collectives"]["bytes"] / 1e6 / len(ranks[0]["losses"]),
            "launches": ranks[0]["launches"], "vs_replay": gap}


class PartsInterleaved:
    """The global batches of a local-rows job on a data axis of two: part
    0's batch i, then part 1's, each of B/2 rows of the file (the JAX
    package's ``make_array_from_process_local_data`` order)."""

    def __init__(self, uri: str, spec) -> None:
        self.uri, self.spec = uri, spec

    def __iter__(self):
        from dmlc_core_tpu_torch.staging.batcher import Batch, BatchSpec, alloc_ell_slot
        from dmlc_core_tpu_torch.staging.fused import ell_batches

        half = BatchSpec(batch_size=self.spec.batch_size // 2, max_nnz=self.spec.max_nnz,
                         value_dtype=self.spec.value_dtype)
        srcs = [ell_batches(self.uri, half, part_index=d, num_parts=2) for d in range(2)]
        try:
            for pair in zip(*srcs):
                buf, views = alloc_ell_slot(self.spec)
                for name, v in views.items():
                    v[...] = np.concatenate([getattr(b, name) for b in pair])
                yield Batch(n_valid=sum(b.n_valid for b in pair), packed=buf, **views)
        finally:
            for s in srcs:
                s.close()

    def close(self) -> None:
        pass


def local_rows_gates(ranks, data, n_rows: int) -> dict:
    """The local-rows job's own gates, on a (2, 2) mesh over the first
    ``n_rows`` rows of ``data``: each rank parsed and staged only its
    part (half the rows); the ranks of a model line staged the same
    bytes; each model line's per-row digests, taken from the staged device
    tensors, are the file's rows once each."""
    from collections import Counter

    idx, val, labels = (a[:n_rows] for a in data)
    want = Counter(hashlib.blake2b(idx[i].astype(np.int32).tobytes() + val[i].tobytes()
                                   + labels[i].tobytes(), digest_size=16).hexdigest()
                   for i in range(n_rows))
    for r, res in enumerate(ranks):
        if res["part"] != [r // 2, 2]:
            fail(f"parallel dp_tp_local rank {r}: read part {res['part']}")
        if not res["producer_rows"] == res["rows_staged"] == n_rows // 2:
            fail(f"parallel dp_tp_local rank {r}: parsed {res['producer_rows']} and staged "
                 f"{res['rows_staged']} rows of a part of {n_rows // 2}")
        if res["batch_digests"] != ranks[r - r % 2]["batch_digests"]:
            fail(f"parallel dp_tp_local: rank {r} staged other bytes than rank {r - r % 2}")
    for m in range(2):
        got = Counter(ranks[m]["row_digests"] + ranks[2 + m]["row_digests"])
        if got != want:
            fail(f"parallel dp_tp_local: model line {m}'s staged rows are not the file's "
                 f"rows once each ({sum((got - want).values())} extra, "
                 f"{sum((want - got).values())} missing)")
    return {"rows_parsed": [r["producer_rows"] for r in ranks],
            "rows_staged": [r["rows_staged"] for r in ranks],
            "staged_rows_per_model_line": n_rows}


def tools_ckpt(base: str, ck) -> dict:
    """``python -m dmlc_core_tpu_torch.tools ckpt ls|show`` on the sharded
    save: the listing is ``ck.steps_info()``, the tree the global shapes
    with the saved meta."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    runs = [subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "ckpt", *argv],
                           capture_output=True, text=True, timeout=120, cwd=repo, env=env)
            for argv in (["ls", base], ["show", base, "--step", str(PAR_SAVE_STEP)])]
    for r in runs:
        if r.returncode != 0:
            fail(f"tools ckpt {r.args[4]} exited {r.returncode}: {r.stderr[-2000:]}")
    listing, shown = (json.loads(r.stdout) for r in runs)
    if listing != ck.steps_info() or [e["layout"] for e in listing] != ["sharded"]:
        fail(f"tools ckpt ls gave {listing}, the Checkpointer {ck.steps_info()}")
    want = {"step": PAR_SAVE_STEP, "tree": {"w": f"float32[{D}]", "v": f"float32[{D}, {E}]",
                                            "b": "float32[]"},
            "meta": {"batches": PAR_SAVE_STEP}}
    if shown != want:
        fail(f"tools ckpt show gave {shown}, not {want}")
    return {"ls": listing, "show": shown}


def parallel_phase(dev, card: str):
    """The FM at the Criteo width over a rank mesh, each job through the
    port's launcher with its ranks on this card (read global batches,
    ``StagingPipeline(mesh=)``, ``data_parallel_step``): (a) ``world1``,
    one rank over NCCL, mesh (1, 1), PAR_LONG steps; (b) ``tp``, two
    ranks over gloo, mesh (1, 2), ``v`` as two [D, E/2] blocks, PAR_LONG
    steps; (c) ``dp_tp``, four ranks over gloo, mesh (2, 2), PAR_SHORT
    steps, a sharded ``save_async`` with ``meta`` at PAR_SAVE_STEP; (d)
    ``reshard``, a (1, 2) job that restores (c)'s ``.d`` by template and
    runs to its end; (e) ``dp_tp_local``, (c) with each rank reading and
    staging only its own rows (``local_rows_gates``). Gates: params
    within PARAM_REL of a one-process replay of the same global batches
    ((d): of (c)'s final params); replicas bit-identical; each rank's
    K1-K4 once a step and one copy a batch; (c)'s ``.d`` holds the
    manifest and 4 shard files, each chunk once, written by its block's
    replica 0, the manifest last; a restore without a template in this
    process equals (c)'s params at the save bit for bit, ``restore_meta``
    what was saved, and ``tools ckpt ls|show`` agree with them. Returns
    the ``{"parallel": ...}`` line and the ranks' launches."""
    from dmlc_core_tpu_torch.checkpoint import Checkpointer, load_pytree
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    out = {"card": card, "shape": {"B": B, "K": K, "E": E, "D": D}, "lr": PAR_LR}

    def fm():
        return FactorizationMachine(D, E, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    def replay(source):
        model = fm()
        drive("parallel replay", model, ell_batches(source, spec)
              if isinstance(source, str) else source, dev, PAR_LR, min_steps=PAR_SHORT)
        return {k: p.detach().cpu().numpy() for k, p in model.params().items()}

    def count(ranks):
        for res in ranks:
            for k in KERNEL_NAMES:
                launches[k] += res["launches"][k]

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        data = criteo_data(rng, PAR_LONG * B, D)
        long_rec = write_indexed(os.path.join(tmp, "long.rec"), *data)
        short_rec = write_indexed(os.path.join(tmp, "short.rec"),
                                  *(a[:PAR_SHORT * B] for a in data))
        long_uri, short_uri = f"{long_rec}?index={long_rec}.idx", f"{short_rec}?index={short_rec}.idx"
        want_long, want_short = replay(long_uri), replay(short_uri)
        for tag, backend, shape in (("world1", "nccl", (1, 1)), ("tp", "gloo", (1, 2))):
            prefix, ranks, wall = par_job(tag, long_uri, tmp, backend, shape)
            got, parts = par_gather(prefix, "final", len(ranks))
            par_replicas(parts, shape, f"parallel {tag}")
            gap = param_gap(got, want_long)
            check_gap(gap, f"parallel {tag} against the one-process replay")
            out[tag] = {"backend": backend, "mesh": shape, **par_summary(ranks, wall, gap)}
            count(ranks)
        prefix, ranks, wall = par_job("dp_tp", short_uri, tmp, "gloo", (2, 2),
                                      save_step=PAR_SAVE_STEP)
        final_c, parts = par_gather(prefix, "final", 4)
        par_replicas(parts, (2, 2), "parallel dp_tp")
        gap = param_gap(final_c, want_short)
        check_gap(gap, "parallel dp_tp against the one-process replay")
        out["dp_tp"] = {"backend": "gloo", "mesh": (2, 2), **par_summary(ranks, wall, gap)}
        count(ranks)
        saved, _ = par_gather(prefix, f"step{PAR_SAVE_STEP}", 4)
        d = os.path.join(tmp, "par_ck", f"ckpt-{PAR_SAVE_STEP:010d}.d")
        names = sorted(os.listdir(d))
        if names != ["MANIFEST.bin"] + [f"shard-{r:05d}.bin" for r in range(4)]:
            fail(f"parallel dp_tp: the .d holds {names}")
        mtimes = {x: os.stat(os.path.join(d, x)).st_mtime_ns for x in names}
        if mtimes["MANIFEST.bin"] < max(mtimes.values()):
            fail(f"parallel dp_tp: the manifest landed before a shard: {mtimes}")
        # each chunk once, from its block's replica 0: w and b on rank 0,
        # v's two column blocks on the ranks of data coordinate 0
        leaves = {int(k["__dmlc_sharded_leaf__"]): name for name, k in
                  load_pytree(os.path.join(d, "MANIFEST.bin"))["tree"].items()}
        chunks = {r: sorted(leaves[int(i)] for i in load_pytree(
            os.path.join(d, f"shard-{r:05d}.bin"))["chunks"]) for r in range(4)}
        if chunks != {0: ["b", "v", "w"], 1: ["v"], 2: [], 3: []}:
            fail(f"parallel dp_tp: chunks by shard file {chunks}")
        ck = Checkpointer(os.path.join(tmp, "par_ck"))
        step_no, host = ck.restore()
        if step_no != PAR_SAVE_STEP or ck.restore_meta() != {"batches": PAR_SAVE_STEP}:
            fail(f"parallel: restored step {step_no}, meta {ck.restore_meta()}")
        for name in saved:
            if host[name].tobytes() != saved[name].tobytes():
                fail(f"parallel: the untemplated restore's {name} differs from the saved one")
        out["dp_tp"]["checkpoint"] = {"files": names, "chunks": chunks,
                                      "bytes": sum(os.path.getsize(os.path.join(d, x))
                                                   for x in names)}
        out["dp_tp"]["tools_ckpt"] = tools_ckpt(os.path.join(tmp, "par_ck"), ck)
        # (e) dp_tp_local: the (2, 2) job again, each rank reading only its
        # data coordinate's part of the same file at B/2 rows a batch
        prefix, ranks_l, wall = par_job("dp_tp_local", short_uri, tmp, "gloo", (2, 2),
                                        local=True)
        got, parts = par_gather(prefix, "final", 4)
        par_replicas(parts, (2, 2), "parallel dp_tp_local")
        gap = param_gap(got, replay(PartsInterleaved(short_uri, spec)))
        check_gap(gap, "parallel dp_tp_local against the one-process replay")
        own = local_rows_gates(ranks_l, data, PAR_SHORT * B)
        out["dp_tp_local"] = {"backend": "gloo", "mesh": (2, 2), **own,
                              **par_summary(ranks_l, wall, gap)}
        count(ranks_l)
        out["local_vs_global"] = {t: {
            "step_ms": [statistics.median(r["step_s"]) * 1e3 for r in rs],
            "collective_share": [r["collective_s"] / sum(r["step_s"]) for r in rs],
            "rows_parsed": [r["producer_rows"] for r in rs],
            "producer_s": [r["producer_s"] for r in rs]}
            for t, rs in (("dp_tp", ranks), ("dp_tp_local", ranks_l))}
        prefix, ranks, wall = par_job("reshard", short_uri, tmp, "gloo", (1, 2),
                                      restore=os.path.join(tmp, "par_ck"))
        if len(ranks[0]["losses"]) != PAR_SHORT - PAR_SAVE_STEP:
            fail(f"parallel reshard: {len(ranks[0]['losses'])} steps after the restore")
        got, parts = par_gather(prefix, "final", 2)
        par_replicas(parts, (1, 2), "parallel reshard")
        gap = param_gap(got, final_c)
        check_gap(gap, "parallel reshard against dp_tp's final params")
        out["reshard"] = {"backend": "gloo", "mesh": (1, 2), **par_summary(ranks, wall, gap)}
        count(ranks)
    # the port of __graft_entry__.dryrun_multichip on this card: 4 gloo
    # ranks through the launcher, its own small FM on a (2, 2) mesh
    from dmlc_core_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    report = dryrun_multichip(4)
    if not (report["ok"] and report["mesh"] == {"data": 2, "model": 2}
            and report["steps"] == 2 and report["packed_shard_dma"]
            and report["packed_shard_batches"] == 2 and report["device_puts"] == 8
            and report["backend"] == "gloo" and report["foreign_modules"] == []
            and np.isfinite(report["loss_exact"])):
        fail(f"parallel: dryrun_multichip(4) reported {report}")
    out["dryrun"] = {k: report[k] for k in ("mesh", "steps", "loss_exact", "device_puts",
                                            "puts_per_device", "backend")}
    out["dryrun"]["wall_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


# the backends phase: BACKEND_WORKERS workers at the Criteo width take
# BACKEND_STEPS steps each over their part of BACKEND_ROWS indexed rows,
# launched through submit on the local cluster, then on each of
# BACKEND_CLUSTERS side by side (FAKE_BINARIES' ssh, srun and mpirun on
# PATH run the payload on this host), allreducing [grads, 1]
# over the tree a step; then the same job with one worker, twice side by
# side
BACKEND_CLUSTERS = ("ssh", "slurm", "mpi")
BACKEND_WORKERS, BACKEND_STEPS = 2, 4
BACKEND_ROWS = BACKEND_WORKERS * 2 * BACKEND_STEPS * B
# the clusters whose submit --dry-run is held to the JAX package's output,
# recorded on the CPU into DRY_RUN_GOLDEN (tests/test_torch_launch.py holds
# the JAX submit and the port's to it); "yarn-rest": yarn with
# DMLC_YARN_REST set, whose context names the port's AM module
DRY_RUN_CLUSTERS = ("sge", "mesos", "kubernetes", "tpu-pod", "yarn", "yarn-rest")
DRY_RUN_GOLDEN = os.path.join("tests", "data", "torch_submit_dry_runs.json")
PORT_AM, JAX_AM = "dmlc_core_tpu_torch.tracker.yarn_am", "dmlc_core_tpu.tracker.yarn_am"


def submit_dry_run(module: str, cluster: str) -> str:
    """The stdout of ``python -m <module> --cluster <cluster> ... --dry-run``
    (``module``: a package's ``tracker.submit``) for a 2-worker job, run
    from the checkout's root with every knob its output reads pinned."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMLC_YARN_REST", "MESOS_MASTER", "DMLC_SUBMIT_CLUSTER")}
    env.update(PYTHONPATH=repo, DMLC_MAX_ATTEMPT="3", DMLC_YARN_PYTHON="python3")
    if cluster == "yarn-rest":
        env["DMLC_YARN_REST"] = "http://rm.invalid:8088"
    flags = {"mesos": ["--mesos-master", "master:5050"],
             "tpu-pod": ["--tpu-name", "pod", "--tpu-zone", "us-central2-b"]}.get(cluster, [])
    proc = subprocess.run(
        [sys.executable, "-m", module, "--cluster", cluster.replace("-rest", ""),
         "--num-workers", "2", "--num-servers", "0" if cluster == "tpu-pod" else "1",
         "--host-ip", "127.0.0.1", "--dry-run", *flags, "python", "train.py", "--name", "run 1"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=120)
    if proc.returncode != 0:
        fail(f"{module} --cluster {cluster} --dry-run exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return proc.stdout


def backends_phase(dev):
    """The Criteo FM through the cluster backends: BACKEND_WORKERS workers
    on the card launched by submit on the local cluster and on each of
    BACKEND_CLUSTERS over the same file, each rank launching K1-K4 once a
    step, its ranks bit-identical and its params within PARAM_REL of the
    local job's (and whether bit-identical printed); the 1-worker local job
    twice, bit-identical; then each of DRY_RUN_CLUSTERS' dry runs equal to
    the JAX package's output, apart from the AM module string. Returns the
    ``{"backends": ...}`` line and the workers' launches."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        bindir = os.path.join(tmp, "bin")
        os.mkdir(bindir)
        for name, body in FAKE_BINARIES.items():
            with open(os.path.join(bindir, name), "w") as f:
                f.write(body)
            os.chmod(os.path.join(bindir, name), 0o755)
        hosts = os.path.join(tmp, "hosts")
        with open(hosts, "w") as f:
            f.write("127.0.0.1\n127.0.0.1\n")
        rec = write_indexed(os.path.join(tmp, "criteo.rec"),
                            *criteo_data(np.random.default_rng(5), BACKEND_ROWS, D))
        script = os.path.join(tmp, "coll_worker.py")
        with open(script, "w") as f:
            f.write(COLL_WORKER.format(repo=repo))
        env = {"PATH": f"{bindir}:{os.environ.get('PATH', '')}"}

        def job(cluster, workers, tag):
            """(rank 0's params, the job's line, its ranks' launches)."""
            prefix = os.path.join(tmp, f"backend_{tag}")
            extra = ["--host-file", hosts] if cluster == "ssh" else []
            _, wall = submit_job(
                [*extra, "--num-workers", str(workers), sys.executable, script, rec, prefix,
                 "tree", str(BACKEND_STEPS), str(COLL_LR), dev.type, str(D), str(E), str(B),
                 str(K)], env=env, cluster=cluster)
            params = rank_files(prefix, workers)
            ranks, ran = [], dict.fromkeys(KERNEL_NAMES, 0)
            for r in range(workers):
                with open(f"{prefix}.rank{r}.json") as f:
                    res = json.load(f)
                if any(res["launches"][k] != BACKEND_STEPS for k in KERNEL_NAMES):
                    fail(f"backend {tag} rank {r}: launches {res['launches']}, "
                         f"want {BACKEND_STEPS} each")
                for k in KERNEL_NAMES:
                    ran[k] += res["launches"][k]
                if not all(np.isfinite(res["losses"])):
                    fail(f"backend {tag} rank {r}: losses {res['losses']}")
                ranks.append({"rank": r, "launches": res["launches"],
                              "step_ms": statistics.median(res["split_s"]["step"]) * 1e3,
                              "loss_first": res["losses"][0], "loss_last": res["losses"][-1]})
            return params, {"wall_s": wall, "ranks": ranks}, ran

        def jobs(specs):
            """The jobs (cluster, workers, tag) side by side on the card,
            their launches added up."""
            with ThreadPoolExecutor(len(specs)) as pool:
                done = list(pool.map(lambda spec: job(*spec), specs))
            for _, _, ran in done:
                for k in KERNEL_NAMES:
                    launches[k] += ran[k]
            return [(params, line) for params, line, _ in done]

        [(ref, out["local"])] = jobs([("local", BACKEND_WORKERS, "local")])
        for cluster, (params, line) in zip(BACKEND_CLUSTERS, jobs(
                [(c, BACKEND_WORKERS, c) for c in BACKEND_CLUSTERS])):
            gap = param_gap(params, ref)
            check_gap(gap, f"backend {cluster} against the local job")
            out[cluster] = dict(line, vs_local=gap, bit_identical_to_local=all(
                params[k].tobytes() == ref[k].tobytes() for k in ref))
        (once, _), (twice, _) = jobs([("local", 1, f"one_worker_{i}") for i in range(2)])
        if any(once[k].tobytes() != twice[k].tobytes() for k in once):
            fail("two runs of the same 1-worker job gave params that differ: "
                 f"{param_gap(twice, once)}")
        out["one_worker_twice_bit_identical"] = True
    with open(os.path.join(repo, DRY_RUN_GOLDEN)) as f:
        golden = json.load(f)
    for cluster in DRY_RUN_CLUSTERS:
        got = submit_dry_run("dmlc_core_tpu_torch.tracker.submit", cluster)
        if cluster == "yarn-rest":
            if PORT_AM not in got:
                fail(f"the yarn REST dry run names no {PORT_AM}")
            got = got.replace(PORT_AM, JAX_AM)
        if got != golden[cluster]:
            fail(f"submit --cluster {cluster} --dry-run differs from the JAX package's:\n"
                 f"{got[:1500]}")
    out["dry_runs_equal_to_jax"] = list(DRY_RUN_CLUSTERS)
    return out, launches


API_EPOCHS = 2
# the row iterators log every this many bytes of source read
API_LOG_STEP = 10 << 20


def block_digest(blk) -> str:
    """A RowBlock's arrays (and which are absent) as one hash."""
    h = hashlib.blake2b()
    for name in ("offset", "label", "index", "value", "weight", "qid", "field"):
        a = getattr(blk, name)
        h.update(name.encode() + (b"-" if a is None else str(a.dtype).encode() + a.tobytes()))
    return h.hexdigest()


class ParserEpochs:
    """A ``create_parser`` parser's blocks through ``FixedShapeBatcher``
    for ``n`` epochs, ``before_first()`` between them; for each epoch the
    digest of every block and ``bytes_read()`` after every ``parse_next``
    (taken on the staging thread, which drives the parser)."""

    def __init__(self, parser, spec, n: int) -> None:
        self.parser, self.spec, self.n = parser, spec, n
        self.digests, self.bytes = [], []

    def _blocks(self):
        digests, seen = [], []
        self.digests.append(digests)
        self.bytes.append(seen)
        while True:
            got = self.parser.parse_next()
            if got is None:
                return
            seen.append(self.parser.bytes_read())
            for blk in got:
                if blk.size:
                    digests.append(block_digest(blk))
                    yield blk

    def __iter__(self):
        from dmlc_core_tpu_torch.staging.batcher import FixedShapeBatcher

        for e in range(self.n):
            if e:
                self.parser.before_first()
            yield from FixedShapeBatcher(self.spec).batches(self._blocks())

    def close(self) -> None:
        self.parser.close()


def api_parser_arms(svm: str, size: int, spec, dev, lr: float):
    """Gates (a) and (b): the threaded ``create_parser`` over the libsvm
    file for API_EPOCHS epochs → ``FixedShapeBatcher`` →
    ``StagingPipeline`` → FM SGD, beside the same FM over the native
    producer for as many epochs; both FMs start from one set of params
    made on the CPU and placed by ``staging.device_put``."""
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging import device_put

    init = FactorizationMachine(D, E, device="cpu",
                                generator=torch.Generator().manual_seed(18)).params()
    init = {k: p.detach().numpy().copy() for k, p in init.items()}

    def fm():
        model = FactorizationMachine(D, E, device=dev)
        model.load_state_dict(device_put(init, dev))
        return model

    arms, params = {}, {}
    source = ParserEpochs(create_parser(svm, type="libsvm"), spec, API_EPOCHS)
    model = fm()
    arms["parser"], _, _ = drive("api_parser", model, source, dev, lr, digests=True)
    params["parser"] = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    model = fm()
    arms["native"], _, _ = drive("api_native", model, Epochs(
        native_source(svm + "?format=libsvm", spec), API_EPOCHS), dev, lr, digests=True)
    params["native"] = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    # (a) epoch 2's blocks are epoch 1's; bytes_read ends at the file's
    # size and never falls within an epoch
    if len(source.digests) != API_EPOCHS or source.digests[1] != source.digests[0]:
        fail("api: the parser's second epoch gave other blocks than its first")
    for e, seen in enumerate(source.bytes):
        if seen != sorted(seen) or seen[-1] != size:
            fail(f"api: epoch {e} bytes_read {seen[:4]}...{seen[-2:]}, file {size} bytes")
    # (b) byte-equal batches, bit-identical params
    if arms["parser"]["digests"] != arms["native"]["digests"]:
        fail("api: the parser path's batches differ from the native producer's")
    diff = [k for k in params["native"]
            if params["parser"][k].tobytes() != params["native"][k].tobytes()]
    if diff:
        fail(f"api: params after {API_EPOCHS} epochs differ between the arms: {diff} "
             f"{param_gap(params['parser'], params['native'])}")
    launches = {k: arms["parser"]["launches"][k] + arms["native"]["launches"][k]
                for k in KERNEL_NAMES}
    line = {"epochs": API_EPOCHS, "blocks_an_epoch": len(source.digests[0]),
            "parse_next_an_epoch": len(source.bytes[0]),
            "bytes_read_after_each_epoch": [seen[-1] for seen in source.bytes],
            "epoch2_equals_epoch1": True, "batches_byte_equal": True,
            "params_bit_identical": True}
    for name, st in arms.items():
        st.pop("digests")
        line[name] = {k: st[k] for k in ("steps", "staged_rows_per_sec", "step_ms",
                                         "wait_share", "wall_s", "loss_first",
                                         "loss_last", "launches")}
    return line, launches


def api_row_iter(svm: str, size: int):
    """Gate (c): ``create_row_block_iter`` read twice through
    ``before_first`` with a ``set_log_sink`` sink; its progress lines'
    megabytes are those the 10 MB rule gives over the split's chunks (the
    source's bytes, not the parsed blocks')."""
    from dmlc_core_tpu_torch.data import create_row_block_iter
    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.utils.logging import set_log_sink

    lines = []
    set_log_sink(lambda sev, msg: lines.append((sev, msg)))
    try:
        it = create_row_block_iter(svm)
        epochs = []
        for _ in range(API_EPOCHS):
            it.before_first()
            epochs.append([block_digest(b) for b in it])
        it.close()
    finally:
        set_log_sink(None)
    if epochs[1] != epochs[0]:
        fail("api: the row iterator's second pass differs from its first")
    sp = io_split.create(svm, type="text", threaded=False)
    want, total, at = [], 0, API_LOG_STEP
    for chunk in iter(sp.next_chunk, None):
        total += len(chunk)
        if total >= at:
            want.append(total >> 20)
            at += API_LOG_STEP
    sp.close()
    got = [int(m.group(1)) for _, msg in lines if (m := re.match(r"(\d+)MB read", msg))]
    if total != size or got != want or not lines or lines[-1][0] != "INFO" \
            or not lines[-1][1].startswith("finish reading at"):
        fail(f"api: row iterator log lines {lines}, want MB {want} of {size} bytes")
    return {"log_lines": [msg for _, msg in lines], "mb_logged": got}


def api_next_batch(rec: str, rows: int, spec, dev):
    """Gate (d): over the indexed rowrec file, a whole epoch of
    ``next_batch(B)`` equals one of ``next_batch_ex(B)``; then
    ``StagingPipeline.io_stats()`` over the native producer carries the
    split's counters and ``"staging"``."""
    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    uri = f"{rec}?index={rec}.idx&shuffle=batch&seed=7"
    drains = {}
    for method in ("next_batch", "next_batch_ex"):
        sp = io_split.create(uri, type="recordio", threaded=False)
        if not isinstance(sp, io_split.InputSplit):
            fail(f"api: {type(sp).__name__} is no InputSplit")
        out, n = [], 0
        while (chunk := getattr(sp, method)(B)) is not None:
            out.append(hashlib.blake2b(chunk).hexdigest())
            n += sum(1 for _ in sp.extract_records(chunk))
        sp.close()
        drains[method] = (out, n)
    if drains["next_batch"] != drains["next_batch_ex"] or drains["next_batch"][1] != rows:
        fail(f"api: next_batch and next_batch_ex drains differ: "
             f"{[(len(d), n) for d, n in drains.values()]}")
    src = ell_batches(uri, spec)
    pipe = StagingPipeline(src, device=dev)
    for _ in pipe:
        pass
    st = pipe.io_stats()
    if not drain_close(pipe, src):
        fail("api: staging pipeline did not close cleanly")
    staging = st.get("staging", {})
    if (st.get("records") != rows or st.get("mode") != "batch"
            or staging.get("packed_batches") != rows // B):
        fail(f"api: StagingPipeline.io_stats() lacks the split's counters: {st}")
    return {"batches": len(drains["next_batch"][0]), "records": rows,
            "next_batch_equals_next_batch_ex": True, "io_stats": st}


def api_phase(dev, card: str):
    """The library interface on the card at full width: a libsvm Criteo
    file of N_BATCHES batches of rows (the slice phase's generator) read
    for two epochs by ``create_parser`` and trained beside the native
    producer (gates a, b), the row iterator's progress through a log sink
    (c), and ``next_batch`` over the shuffle phase's kind of indexed file
    (d). Returns the ``{"api": ...}`` line and its K1-K4 launches."""
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    t0 = time.perf_counter()
    rows = N_BATCHES * B
    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        idx, val, labels = criteo_data(np.random.default_rng(18), rows, D)
        svm = write_file(os.path.join(tmp, "criteo.libsvm"),
                         criteo_text(idx, val, labels, "libsvm"))
        size = os.path.getsize(svm)
        out = {"rows": rows, "file_bytes": size, "card": card}
        out["parser"], launches = api_parser_arms(svm, size, spec, dev, 0.5)
        out["row_iter"] = api_row_iter(svm, size)
        rec = write_indexed(os.path.join(tmp, "criteo.rec"), idx, val, labels)
        out["next_batch"] = api_next_batch(rec, rows, spec, dev)
    if any(launches[k] == 0 for k in KERNEL_NAMES):
        fail(f"api: the phase did not launch every kernel: {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def entry_phase(dev) -> None:
    from dmlc_core_tpu_torch.entry import entry

    f_gpu, (p_gpu, b_gpu) = entry(dev)
    f_cpu, (_, b_cpu) = entry("cpu")
    p_cpu = {k: t.detach().cpu() for k, t in p_gpu.items()}
    close_enough(f_gpu(p_gpu, b_gpu).detach().cpu(), f_cpu(p_cpu, b_cpu).detach(),
                 "fwd", "entry forward")


def run_only(names, dev, smi_line: str, timed) -> None:
    """``--only a,b,...``: the named phases alone, in that order (a name
    may repeat), each line printed as it ends; no kernels line."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    calls = {
        "kernels": lambda: kernel_phase(dev, flush),
        "producers": producer_phase,
        "slice": lambda: slice_phase(dev),
        "examples": lambda: examples_phase(dev),
        "collective": lambda: collective_phase(dev)[0],
        "shards": lambda: shards_phase(dev)[0],
        "dsserve": lambda: dsserve_phase(dev, smi_line)[0],
        "faults": lambda: faults_phase(dev, smi_line)[0],
        "autoscale": lambda: autoscale_phase(dev, smi_line)[0],
        "remote": lambda: remote_phase(dev, smi_line)[0],
        "stream": lambda: stream_phase(dev, smi_line)[0],
        "lookup": lambda: lookup_phase(smi_line),
        "parallel": lambda: parallel_phase(dev, smi_line)[0],
        "backends": lambda: backends_phase(dev)[0],
        "api": lambda: api_phase(dev, smi_line)[0],
        "entry": lambda: entry_phase(dev),
    }
    unknown = [n for n in names if n not in calls]
    if unknown:
        fail(f"--only: unknown phases {unknown}; known: {sorted(calls)}")
    for i, name in enumerate(names):
        print(json.dumps({name: timed(f"{name}.{i}", calls[name])}), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            fail(f"usage: python3 chip_smoke.py [--only phase,phase,...], not {argv}")
        only = argv[1].split(",")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmlc_core_tpu_torch.data import native
    from dmlc_core_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {smi_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        builds = [pool.submit(_build.build), pool.submit(native.build)]
        so, native_so = (b.result() for b in builds)
    print(f"kernel and native builds: {time.perf_counter() - t0:.1f} s -> "
          f"{so.name}, {native_so.name}")
    if native.source_hash() != native.source_sha256():
        fail(f"{native.library_path()} was not built from the checkout's fastparse.cc")
    ptxas = ptxas_summary(_build.build_log)
    print(json.dumps({"ptxas": ptxas, "dynamic_smem_bytes": _build.scatter_smem_bytes(K)}))
    if not ptxas:
        fail("no register report from the compiler (-Xptxas -v)")
    spills = [p["function"] for p in ptxas if p["spill_bytes"]]
    if spills:
        fail(f"kernel instances spill registers: {spills}")

    seconds = {"builds": time.perf_counter() - t0}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    if only is not None:
        run_only(only, dev, smi_line, timed)
        seconds["total"] = time.perf_counter() - t0
        print(json.dumps({"phase_seconds": seconds}))
        print(smi_line)
        print(json.dumps({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    kernels = timed("kernels", kernel_phase, dev, flush)
    del flush
    producers = timed("producers", producer_phase)
    slice_stats = timed("slice", slice_phase, dev)
    shuffle = timed("shuffle", shuffle_phase, dev, slice_stats["fm"])
    codec = timed("codec", codec_phase, dev, slice_stats["fm"])
    examples = timed("examples", examples_phase, dev)
    collective, coll_launches = timed("collective", collective_phase, dev)
    telemetry, tele_launches = timed("telemetry", telemetry_phase, dev, kernels)
    shards, shard_launches = timed("shards", shards_phase, dev)
    dsserve, dsserve_launches = timed("dsserve", dsserve_phase, dev, smi_line)
    faults, fault_launches = timed("faults", faults_phase, dev, smi_line)
    autoscale, autoscale_launches = timed("autoscale", autoscale_phase, dev, smi_line)
    remote, remote_launches = timed("remote", remote_phase, dev, smi_line)
    stream, stream_launches = timed("stream", stream_phase, dev, smi_line)
    lookup = timed("lookup", lookup_phase, smi_line)
    parallel, par_launches = timed("parallel", parallel_phase, dev, smi_line)
    backends, backend_launches = timed("backends", backends_phase, dev)
    api, api_launches = timed("api", api_phase, dev, smi_line)
    timed("entry", entry_phase, dev)
    torch.cuda.synchronize()
    seconds["total"] = time.perf_counter() - t0

    main_runs = [*slice_stats.values(), shuffle["fm"]["timed"], codec["fm"]["zlib"]]
    for row in kernels:
        # the full-width collective workers count in their own processes
        n = (sum(s["launches"][row["name"]] for s in main_runs)
             + coll_launches[row["name"]] + tele_launches[row["name"]]
             + shard_launches[row["name"]] + dsserve_launches[row["name"]]
             + fault_launches[row["name"]] + autoscale_launches[row["name"]]
             + remote_launches[row["name"]] + stream_launches[row["name"]]
             + par_launches[row["name"]] + backend_launches[row["name"]]
             + api_launches[row["name"]] + examples["train_online_fm"]["launches"][row["name"]])
        if n == 0:
            fail(f"kernel {row['name']} was not launched on the main path")
        row["launches"] = n
    for name, s in slice_stats.items():
        # K1/K2 on every ELL path, K3/K4 on the FM ones, none on dense
        want = (() if name == "csv_lr" else KERNEL_NAMES if "fm" in name
                else KERNEL_NAMES[:2])
        if any(s["launches"][k] == 0 for k in want):
            fail(f"{name} path did not launch {want}: {s['launches']}")
        if name == "csv_lr" and any(s["launches"].values()):
            fail(f"the dense path launched ELL kernels: {s['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"producers": producers}))
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"shuffle": shuffle}))
    print(json.dumps({"codec": codec}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"collective": collective}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"shards": shards}))
    print(json.dumps({"dsserve": dsserve}))
    print(json.dumps({"faults": faults}))
    print(json.dumps({"autoscale": autoscale}))
    print(json.dumps({"remote": remote}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"lookup": lookup}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"backends": backends}))
    print(json.dumps({"api": api}))
    print(json.dumps({"phase_seconds": seconds}))
    foreign = sorted(n for n in sys.modules if n.split(".")[0] in FOREIGN_MODULES)
    if foreign:
        fail(f"the run loaded modules of JAX or of the JAX package: {foreign[:20]}")
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
