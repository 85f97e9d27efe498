#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tnco_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit; build the CUDA kernels from
   ``tnco_tpu_torch/csrc`` into ``build/kernels/`` (one ``nvcc`` per
   source, all started together);
2. every kernel against its plain PyTorch version on the card, bitwise,
   at the main-path shapes plus edge cases: K1 and K3 by every route
   (the cases of ``tnco_tpu_torch.testing.kernel_cases``, which the card
   tests run too), K2 at that module's cases (n at 1, around its 2048-
   column slices, 3241, 3328 and 20000; duplicates, -1, out-of-range
   ids, Q = n, Q > n), then the walker K5-IM
   against ``run_walker_plain`` on the same pre-drawn streams (a small
   mixed-dims lattice at B=4, P=8 and P=128, 'greedy', and the edge
   cases P=1 and B=1, then the Sycamore shapes at B=64, P=8, 'mh' and
   'greedy', and at the walker apps' B=APP_RUNS, P=8, 'mh'; two chunks of K=16 each; then a 7001-tensor hyper-index
   chain on dims 2 and 3, whose topology exceeds shared memory, at B=2
   and K=8), then the
   finite-width walker K5-FW against ``run_walker_fw_plain`` the same
   way (reslices inside the chunks: every 5 steps on the lattice with
   max_width 10, every 10 on Sycamore with max_width 30), then the
   out-of-place row scatter K4 (132 planes of [64, 3328], a plane range,
   float32 NaN payloads, B=1/Q=1 on a ragged N, duplicate ids; the
   caller's planes unchanged) and the row-read probe P1 at the cases of
   ``kernel_cases`` (P, R at (128, 256), (1, 1), (129, 7), (454, 3) on
   N = 3328, 3241 and 40, and (8, 3) on N = 40; rounds of 128 ids from 4
   rows; N = 60000, the global route), every route of the loop kernel
   and both impls through the wrapper, the caller's state unchanged
   after every call; then the claim kernel against
   ``claim_disjoint_plain`` at ``CLAIM_SHAPES`` (the FW walks cell's
   B=2048, P=128; P=32 and the multi-walk P=8) and edge cases (dense
   conflicts, all and none accepted, NULLs, [P, B] views, P=130, 320, 1,
   B=1), one launch a call;
3. the finite-width (FW) path through the user entry point:
   ``Optimizer(max_width=30).optimize`` on the Sycamore-like m=20
   network (N=3241, W=64) with every result audited (valid path, exact
   bigint cost, widths within the cap after slicing), with the kernels'
   launch counts read around it; then K1 and K3 bitwise against their
   plain versions at each shape it launched them, and at B=64 (as in
   phases 5, 7, 11-12, 19-20 and 22-24);
4. the FW flagship: ``ReplicaRunnerFW`` at B=64 replicas, P=128 walks,
   reslice every 2 steps, with proposals/s and applied/s;
5. the infinite-memory (IM) path through the user entry point:
   ``Optimizer().optimize`` (``max_width=None``) on the same network,
   APP_RUNS runs of 32 steps, 'auto' resolving to the walker; every result
   and every replica's best tree audited (valid path, exact bigint cost,
   device min total within 1e-3 in log2 of the exact one);
6. the IM flagship: ``ReplicaRunner`` at B=64, P=8 in chunks of 128
   iterations, with ms per chunk, proposals/s and applied/s;
7. the FW walker path through the user entry point:
   ``Optimizer(max_width=30, engine='walker')``, APP_RUNS runs of 32
   steps,
   reslice every 10, every result and every replica's best state
   audited as in phases 3 and 5;
8. the FW walker flagship: ``ReplicaRunnerFW(engine='walker')`` at B=64,
   P=8, reslice every 10 steps, chunks of 128 iterations: ms per chunk,
   proposals/s, applied/s and the chunk's split between kernel segments
   and reslices (CUDA events);
9. the bench path: ``tnco_tpu_torch.bench.main()`` at its card sizes
   (8x8 lattice, B=8192, P=16, 512 iterations) with its kernel identity
   check (K5-IM, K1, K4 against their plain versions), then the row-read
   probe's ``main()`` (ns per row op);
10. kernel, plain-version, library-call and bound times at the main-path
   shapes, printed as one ``{"kernels": [...]}`` line; K1's row also
   holds, under ``shapes``, its times at the slicer's sorted-space gather,
   at a small pull and at the lockstep sweep's row read (K3's row: its
   row write; the two rows' ``launches`` sum the FW walks app, the two
   default-fuse apps and phases 15-17), and K1's and K3's rows the bytes
   of the 32-byte sectors their accesses touch (``sector_bytes``, beside
   the word bound); each K5 row also holds, under ``tree_route``, its times on a
   mixed log2-dims table of the same shape (the kernel's tree width
   route, which no main-path launch takes on Sycamore's dims); the
   rows of P1 and K2 also hold a measured floor (``floor_ms``: the loop's
   barriers with no memory work, the take's row bytes at the card's L2
   read rate after an empty kernel on its grid, an empty kernel on K2's
   grid; kernels of
   ``scripts/probe_inv_first_design.cu``); the claim kernel's row holds
   its times at ``CLAIM_SHAPES`` (the plain version's also eager, between
   events) against 22 B a walk;
11. the FW app at its default fuse: ``Optimizer(max_width=30,
   seed=0).optimize`` with no ``fuse=`` argument, which fuses Sycamore
   m=20 to N=855, W=26, where 'auto' picks the lockstep 'batched'
   engine; APP_RUNS runs x BATCHED_APP_STEPS sweeps, reslice every 10;
   K1 (the
   row reads) and K3 (the row writes) must launch; every result and
   every replica's best state audited;
12. the IM app the same way (``Optimizer(seed=0)``), audited as in
   phase 5;
13. both batched flagships at full width, B=64 on the fused network
   (FW: max_width=30, reslice every 10), BATCHED_SWEEPS timed sweeps
   after a warm-up: ms per sweep, walk steps and moves per sweep,
   moves/s, and the FW reslices' share of the sweeps (CUDA events);
   every replica audited; after phase 10, a few more sweeps of each
   under ``torch.profiler`` give kernel launches per sweep and the
   kernels' busy share (last, since a profiler session slows the host's
   later launches);
14. one batched sweep (IM, then FW with a reslice) on the card and on
   the CPU from one state and the same draws, at B=64 on the fused
   network: integer and bit state bitwise equal, totals within 1e-5;
15. the FW product point on the full network (``fuse=0``, B=64, P=128,
   reslice every 2, the walks engine): chunks of PRODUCT_K iterations,
   each observed by ``IslandStallKicker(islands=4, window_chunks=10,
   min_delta=10, cooldown_chunks=60)``, and every 4 chunks
   ``exchange_best_fw`` over the islands it leaves active, until every
   island was kicked once (at least 12 chunks); then one kick with the
   host slicer.  Min totals never rise across an exchange or a kick;
   each kicked lane's written total is the exact cost of its (tree,
   slices) within 1e-3; every replica audited; ms per chunk, per exchange
   and per kick (both slicers), K1 launches inside the kicks (> 0),
   proposals/s and applied/s;
16. the FW throughput point: K1 and K3 against their plain versions at
   P=320's shapes (routes printed), then ``fw_slicer='ref'``, P=320,
   reslice every 8: a warm-up, THROUGHPUT_ITERS timed iterations,
   proposals/s and applied/s, every replica audited;
17. walks-FW chunks of the product point's runner on
   ``TemperingLadder(64, beta_max=60)`` rows, swapping on the current
   totals between chunks: the swap rate, every replica audited;
18. one exchange (islands 4, island 1 gated) and one device-slicer kick
   (jitter drawn once) from the product point's state on the card and on
   the CPU: integer and bit state bitwise equal, totals within 1e-5 (run
   after phase 15, on copies of the runner);
19. circuits at full width through ``load_tn`` and ``Optimizer``: the
   Sycamore-53 m=20 circuit as an fSim gate list (``Optimizer(max_width=
   30, seed=0)``) and as QASM text with cz couplers (``Optimizer(seed=
   0)``) at the default fuse, and QAOA-26 p=4 at fuse=3 (``Optimizer(
   max_width=30, seed=0)``), APP_RUNS runs x BATCHED_APP_STEPS sweeps
   each:
   load seconds, N, W, tensors, hyper-indices and the engine 'auto'
   picks ('batched', whose K1 and K3 must launch); every result audited
   as in phases 3 and 5; then K1 and K3 bitwise against their plain
   versions, by every route, at each shape the ``optimize`` launched
   them (recorded by ``kernel_cases.recorded_cases``);
20. the CLI as a subprocess: ``python3 -m tnco_tpu_torch.app.cli
   optimize`` on the Sycamore QASM file (max_width 30, APP_RUNS runs x
   32 sweeps), its network equal to ``load_tn``'s and its best result
   audited, with its wall time, then the same command through
   ``cli.main`` in this process, K1 and K3 held at the shapes it
   launched (its output discarded); ``sample`` on a 3-qubit GHZ circuit,
   whose hits must lie in {000, 111};
21. the BGL ``Sampler`` (QAOA with each ZZ written CX, Rz, CX; the
   checks' prefix networks optimized with 8 sweeps): every probability
   the sampling loop contracts on QAOA-10 p=2 equals the statevector's
   within 1e-10; the same circuit under a width cap two below its widest
   contraction, one lower at a time (at most twice) while it forces no
   slice (sliced amplitudes within 1e-10 relative of the unsliced
   ones); 1000 samples of QAOA-4 p=2 within 0.15 of the statevector's
   distribution in total variation; a timed run on QAOA-26 at depth
   SAMPLER_P (cut from 4) with the CLI's ``sample`` betas, 8 sweeps a
   prefix network (cut from its 50): seconds to build the state (one
   card optimization per non-classical gate; K1 and K3 must launch) and
   per sample, each of SAMPLER_SAMPLES samples timed alone (median, min,
   max); then K1 and
   K3 bitwise against their plain versions at each shape the phase
   launched them, as in phase 19;
22. sparse networks: the Sycamore-53 m=20 fSim circuit and QAOA-26 p=4
   through ``load_tn`` with open outputs, unfused, the outputs marked
   sparse (N=3135, W=64 and N=623, W=15): (a) ``Optimizer(seed=0)`` and
   ``Optimizer(max_width=30, seed=0)`` with ``n_projs=2**20``, APP_RUNS
   runs x SPARSE_APP_STEPS sweeps each, where 'auto' picks 'vmapped' (K1 and
   K3 must launch): load seconds, N, W, ms a sweep; every result audited
   by the sparse exact bigint cost (the cost model's
   ``contraction_cost`` over the tree) and, finite width, its widths
   within the cap after slicing; (b) QAOA-26 FW (max_width 30,
   ``n_projs=2**10``), where 'auto' picks 'batched', audited the same
   way; (c) the sparse walks point: ``ReplicaRunnerFW(engine='walks')``
   from (a)'s best trees repeated to B=64, P=128, reslice every 2 (the
   reference slicer), ms per iteration, proposals/s and applied/s over
   SPARSE_WALKS_ITERS iterations, every replica audited; (d) one
   'vmapped' IM sweep, one 'vmapped' FW sweep with a reslice and one
   walks-FW iteration on the card and on the CPU from one state and the
   same draws (SPARSE_CHECK_B replicas): integer and bit state bitwise,
   totals within 1e-5; (e) K1 and K3 bitwise against their plain
   versions at each shape the phase launched them;
23. the walk variants and float64 state on the full network (N=3241,
   W=64): (a) ``Optimizer(seed=0, engine='walks', n_walks=32)``,
   APP_RUNS runs x 32 steps at the IM walks runner's default P=32 (the
   app's own default is 8 for every walk engine; ``fuse=0``), every result and
   replica audited as in phase 5; (b) from copies of that runner's state
   (repeated to B=64), each
   variant of the walks engine (the default, ``on_block`` 'restart' and
   'dedup', ``accept_rule='chained'``, ``prob_kind`` 'greedy', 'base'
   and 'mh_local', ``claim='pairwise'`` through ``run_walks``), and from
   copies of the FW product runner's state (P=128, reslice every 2) the
   default, 'dedup', 'chained' and ``claim='pairwise'`` (through
   ``run_walks_fw``): a warm-up, VARIANT_ITERS timed iterations, ms an
   iteration, proposals/s and applied/s, every replica audited; (c)
   under the float64 mode (``bitops.enable_float64``):
   ``Optimizer(max_width=30, seed=0)`` on the full network ('auto':
   'walks', float64; APP_RUNS runs x 16 steps, reslice every 2) and
   ``Optimizer(seed=0)``, ``Optimizer(max_width=30, seed=0)`` at the
   default fuse ('batched', float64; APP_RUNS runs x BATCHED_APP_STEPS
   sweeps): the state's dtype float64, every result audited, every
   replica's device log2 total within F64_AUDIT of its exact bigint
   cost, the largest gap printed beside the float32 runs'; (d) at
   VARIANT_CHECK_B replicas, on the card and on the CPU from one state
   and the same draws: one IM walks iteration per variant of (b), one FW
   walks iteration with 'chained' and 'dedup', one float64 'batched'
   sweep IM and FW (a reslice) and one float64 walks-FW iteration:
   integer and bit state bitwise, totals within 1e-5 (float32) or
   F64_CARD (float64); (e) K1 and K3 bitwise against their plain
   versions at each shape the phase launched them, the float64 plane
   counts included;
24. the synchronous 'sweep' engine, the single optimizers and a
   checkpoint on the card (full network, N=3241, W=64): (a)
   ``Optimizer(seed=0, engine='sweep')`` and ``Optimizer(max_width=30,
   seed=0, engine='sweep')`` (reslice every 10 rounds), APP_RUNS runs
   x 32 rounds each ('mh_local', K1 must launch), every result and
   every replica's best state audited; (b) each app's runner, its
   replicas repeated to B=64, as the flagship: a warm-up round and
   SWEEP_TIMED timed rounds in
   chunks of SWEEP_CHUNK, ms a round, proposals/s (NI * B a round),
   applied/s, K1 launches a round and, FW, the reslice's share (CUDA
   events); (c) one IM round and one FW round with a reslice from the
   first SWEEP_CHECK_B replicas of each, on the card and on the CPU
   with the same draws: integer and bit state bitwise, totals within
   1e-5; (d) ``tnco_tpu_torch.optimize``'s IM and FW (max_width 30)
   ``Optimizer`` on one full-network tree: OPT_UPDATES updates and an
   ``update_many`` of as many betas (ms an update), ``is_valid()``, the
   exact min cost, and a pickled copy and a ``prng_state`` copy that
   continue bitwise for 4 updates; (e) an IM 'batched' runner at the
   default fuse checkpointed after CKPT_K sweeps and resumed equals one
   that ran 2 * CKPT_K straight, bitwise; (f) K1 and K3 bitwise against
   their plain versions at each shape the phase launched them;
25. the native CPU engine and the replica mesh: (a) 'native' on the
   card's host (the library built with g++ into ``build/native/``): the
   flagship trees (full network, B=64), IM and FW (max_width 30, reslice
   every 10), NATIVE_SWEEPS sweeps in chunks of NATIVE_CHUNK, sweeps/s
   and moves/s beside ``os.cpu_count()`` and the thread count, every
   replica audited (valid, within the cap after its slices, the exact
   bigint total within 1e-3 in log2 of the best, ``native.total_cost``
   equal to the bigint); ``n_threads=1`` equal to all threads bitwise
   (NATIVE_CHECK_B replicas x NATIVE_CHECK_SWEEPS sweeps, IM and FW);
   ``ReplicaRunnerFW(max_number_new_slices=2)`` under 'auto' on the card
   resolves to 'native'; ``Optimizer(seed=0, engine='native')`` on a
   QAOA circuit; (b) one NCCL rank (``mesh.spawn``): 'batched', 'walks'
   FW, 'walker' IM and FW on ``make_mesh()`` equal the same runners
   without a mesh, bitwise (default fuse, MESH_ONE_B replicas), and the
   sharded exchanges equal ``exchange_best(_fw)``; (c) four gloo ranks
   sharing the card on a (2, 2) ('dcn', 'ici') mesh, full network at B:
   'walks' FW (MESH_FW_ITERS iterations, the 'ici' exchange every chunk)
   and 'walker' IM (MESH_K iterations) equal the one-device runs bitwise
   (the one-device FW run exchanges as the mesh does,
   ``mesh_cases.exchange_blocks``); in (b) and (c) each rank holds K1
   and K3 bitwise against their plain versions at every shape it
   launched and K5 on its block, and the phase prints which all-reduce
   gloo does not take on CUDA tensors (none is copied across); (d) the
   global draw stream's cost to a rank: ms of a draw of the whole
   replica axis kept to a block of B/4, against the block's own draw and
   the whole axis, at (c)'s 'walks' FW and 'walker' IM shapes.  A rank's
   failure fails the phase;
26. the examples' flows and the host API on the card: (a) the three
   flows of ``examples/`` at their own sizes and seeds through
   ``tnco_tpu_torch.testing.examples`` with ``device='cuda'``:
   ``base_optimization`` (the chain's tree, ``max_width()``, exact cost,
   100 IM and 100 FW ``update`` calls of the single optimizers, a pickle
   round trip), ``optimization`` (the app's ``Optimizer`` by default,
   with ``max_width=3.0``, 'multiwalk' and 'walks', 64 runs each) and
   ``sampling`` (``Sampler`` plain and under ``max_width=2.0``), each
   audited (valid trees, exact bigint costs, widths within the cap after
   slicing, every contracted amplitude within 1e-10 of a statevector and
   the frequencies within 0.35 of its distribution in total variation);
   (b) the host API on the full network: an FW min tree of phase 24
   within its cap after its slices (``max_width()``, ``get_max_width``),
   the log2-sum of ``contraction_log2_costs()`` within 1e-9 of log2 of
   the exact total on six trees of phases 4 and 24, four ``swap_with_nn``
   moves on a copy of a phase 4 tree, each moved structure valid and
   each swap back restoring the tree; (c) the eight random networks of
   the JAX package's tests (``examples.RANDOM_SHAPES``) through
   ``Optimizer(device='cuda')`` IM and FW (max_width 3), every result
   audited; (d) K1 and K3 bitwise against their plain versions at each
   shape the phase launched them.  The phase prints its wall seconds and
   each flow's launch counts;
27. the reference's batch stacking helpers on the card at full width
   (phase 4's flagship trees, N=3241, W=64, B=64): (a) ``from_states``
   of every replica's ``init_state(device='cuda')`` equals
   ``init_batch`` bitwise in every field, and ``from_states_fw`` of
   ``init_state_fw`` (max_width 30, the batch's initial slices) equals
   ``init_batch_fw``; ``replica_state(_fw)`` of each batch equals every
   replica's state; (b) from one stacked batch and the same draws,
   STACK_SWEEPS sweeps over a beta ramp of the lockstep
   ``run_sweeps_batched`` and the 'vmapped' ``run_sweeps_batch`` (FW:
   ``run_sweeps_fw_batched`` and ``run_sweeps_fw_batch``, a reslice
   after the first sweep): integer state and min trees bitwise, totals
   within 1e-5, the moves equal, ``replica_state(_fw)(out, 0)`` equal to
   the vmapped replica 0, every replica audited (valid, exact bigint
   total within 1e-3 in log2, FW widths within the cap); (c) both batch
   builders called without ``device`` put the batch on ``cuda:0``; (d)
   ``Sampler(optimization_backend='numpy', device='cuda')`` and
   ``Sampler(device='cuda')``, one seed, sample the same bitstrings of
   QAOA-4 p=2 at phase 21's settings, every visited probability within
   1e-10 of the statevector; (e) K1 and K3 bitwise against their plain
   versions at each shape the phase launched them.  The phase prints its
   wall seconds and launch counts.

Every app phase (3, 5, 7, 11-12, 19, 20, 22-24) runs APP_RUNS runs and
holds K1 and K3 at the shapes it launched, and at B=64 replicas too;
phase 2 holds K5-IM and K5-FW at the walker apps' B=APP_RUNS.
Phases 11-27 run between phases 9 and 10, whose kernel line carries
every phase's launch counts (K1's and K3's rows add phases 15-17's, 19's,
21's, 22's, 23's, 24's, 25's, 26's and 27's, K5's 25's); phase 13's
profiled sweeps run after 10.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from concurrent.futures import ThreadPoolExecutor
from decimal import Decimal
import functools
import json
import math
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate

# TPU kernels the port's kernels replace (file:line of the pallas_call).
REPLACES = {
    'gather_gbn': 'tnco_tpu/kernels/pallas_gather.py:112',
    'inv_ids': 'tnco_tpu/kernels/pallas_scatter.py:116',
    'scatter_rows_inplace': 'tnco_tpu/kernels/pallas_scatter.py:354',
    'walker_im': 'tnco_tpu/kernels/pallas_walker.py:595',
    'walker_fw': 'tnco_tpu/kernels/pallas_walker.py:802',
    'scatter_rows_gbn': 'tnco_tpu/kernels/pallas_scatter.py:228,248',
    'probe_loop': 'benchmarks/pallas_gather_probe.py:70',
    'probe_take': 'benchmarks/pallas_gather_probe.py:82',
    'claim_disjoint': 'tnco_tpu/kernels/sa_multiwalk.py:282-302 (a '
                      'fori_loop; no pallas_call)',
}
SOURCES = {
    'gather_gbn': 'tnco_tpu_torch/csrc/gather.cu',
    'inv_ids': 'tnco_tpu_torch/csrc/scatter.cu',
    'scatter_rows_inplace': 'tnco_tpu_torch/csrc/scatter.cu',
    'walker_im': 'tnco_tpu_torch/csrc/walker.cu',
    'walker_fw': 'tnco_tpu_torch/csrc/walker.cu',
    'scatter_rows_gbn': 'tnco_tpu_torch/csrc/scatter.cu',
    'probe_loop': 'tnco_tpu_torch/csrc/probe.cu',
    'probe_take': 'tnco_tpu_torch/csrc/probe.cu',
    'claim_disjoint': 'tnco_tpu_torch/csrc/claim.cu',
}
# The kernels each path runs (every one must launch in its phase).
FW_KERNELS = ('gather_gbn', 'scatter_rows_inplace', 'claim_disjoint')
IM_KERNELS = ('gather_gbn', 'walker_im')
FW_WALKER_KERNELS = ('gather_gbn', 'walker_fw')
BENCH_KERNELS = ('gather_gbn', 'inv_ids', 'scatter_rows_gbn', 'walker_im',
                 'probe_loop', 'probe_take')
# The lockstep 'batched' engines: K1 reads the rows of every walk step,
# refreshes hyper after each chunk and reads rows in the FW reslice; K3
# writes the accepted rows.
BATCHED_KERNELS = ('gather_gbn', 'scatter_rows_inplace')
# The main paths whose launches a kernel's row reports (default: the FW
# walks app, phase 3).
CIRCUIT_PATHS = ('circuit_fsim', 'circuit_qasm', 'circuit_qaoa', 'sampler')
SPARSE_PATHS = ('sparse_im', 'sparse_fw', 'sparse_qaoa', 'sparse_walks')
# Phase 23: the IM walks app, the walk variants, the float64 apps.
PHASE23_PATHS = ('im_walks_app', 'walk_variants', 'f64_fw_walks',
                 'f64_batched_im', 'f64_batched_fw')
# Phase 24: the 'sweep' apps (K1 only), the single optimizers and the
# checkpoint (K1 and K3, the lockstep sweep).
PHASE24_K3_PATHS = ('single_optimizers', 'checkpoint')
PHASE24_PATHS = ('sweep_im_app', 'sweep_fw_app', *PHASE24_K3_PATHS)
# Phase 25: the runners on a one-rank NCCL mesh ('batched', 'walks' FW,
# 'walker' IM and FW) and on four gloo ranks ('walks' FW, 'walker' IM).
MESH_PATHS = ('mesh_one_rank', 'mesh_four_ranks')
# Phase 26: the examples' flows and the random networks through
# ``Optimizer`` (K1 and K3: the single optimizers' and the app's sweeps).
PHASE26_PATHS = ('example_base', 'example_optimization', 'example_sampling',
                 'random_networks')
# Phase 27: the stacking helpers' lockstep and 'vmapped' sweeps and the
# sampler with optimization_backend (K1 and K3).
PHASE27_PATHS = ('stacking',)
MAIN_PATHS = {'gather_gbn': ('fw_app', 'batched_fw_app', 'batched_im_app',
                             'fw_product', 'fw_throughput', 'fw_tempering',
                             *CIRCUIT_PATHS, *SPARSE_PATHS, *PHASE23_PATHS,
                             *PHASE24_PATHS, *MESH_PATHS, *PHASE26_PATHS,
                             *PHASE27_PATHS),
              'scatter_rows_inplace': ('fw_app', 'batched_fw_app',
                                       'batched_im_app', 'fw_product',
                                       'fw_throughput', 'fw_tempering',
                                       *CIRCUIT_PATHS, *SPARSE_PATHS,
                                       *PHASE23_PATHS, *PHASE24_K3_PATHS,
                                       *MESH_PATHS, *PHASE26_PATHS,
                                       *PHASE27_PATHS),
              'walker_im': ('im_app', *MESH_PATHS),
              'walker_fw': ('fw_walker_app', 'mesh_one_rank'),
              'inv_ids': ('bench',), 'scatter_rows_gbn': ('bench',),
              'probe_loop': ('bench',), 'probe_take': ('bench',),
              'claim_disjoint': ('fw_app', 'fw_product', 'fw_throughput',
                                 'fw_tempering', *PHASE23_PATHS[:2])}

# Main-path shapes (Sycamore m=20 at B=64, P=128: W=64 index planes,
# N padded to 3328, 132 planes below par in the FW state).
B, P, W, N_PAD, F_APPLY = 64, 128, 64, 3328, 132
# IM walker: P=8 walks (the runner's default), K5 checked on chunks of
# K_CHECK iterations and timed on chunks of K_CHUNK (the runner's).
P_IM, K_CHECK, K_CHUNK = 8, 16, 128
# The walker checks' network above the shared-memory topology limit is
# checked on chunks of K_BIG iterations (B=2).
K_BIG = 8
# FW walker: reslice every 10 steps (the app's default); K5-FW timed on
# a segment of that length.
UPDATE_SLICES = 10
# The default-fuse phases (Sycamore m=20 fused to N=855, W=26): sweeps
# of the two app phases, and timed sweeps of each batched flagship; the
# FW sweep state has W + 5 planes.
BATCHED_APP_STEPS = 32
BATCHED_SWEEPS = 20
# Runs of every app phase (``optimize(n_runs=...)``: phases 3, 5, 7,
# 11-12, 19, 20, 22-24; cut from 64, and 32 in phases 23's float64 app on
# the full network and 24, for the whole run's time limit: most of an
# app phase is host work per run, its paths, set-up and audits).  The
# flagships, the operating points and the runners built from an app's
# trees keep B=64 (an app's runner is repeated to B where a later step
# times it), and the K1/K3 shapes an app launched at APP_RUNS replicas
# are held at B replicas as well.
APP_RUNS = 16
N_BATCHED, F_BATCHED = 855, 26 + 5
# P1: the probe's Sycamore-sized state [3328, 128] and its default P=128
# row ops per round over R=256 rounds.
PROBE_P, PROBE_R = 128, 256
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate (no tensor cores)
# Phase 25: the 'native' runners sweep the full network NATIVE_SWEEPS
# times in chunks of NATIVE_CHUNK; the threads check runs NATIVE_CHECK_B
# replicas x NATIVE_CHECK_SWEEPS sweeps.  The one-rank mesh runs
# MESH_ONE_B replicas of the default-fuse network; the four ranks run
# the full network at B: MESH_FW_ITERS walks-FW iterations in chunks of 2
# (the 'ici' exchange after the first) and MESH_K walker-IM iterations in
# two chunks.
NATIVE_SWEEPS, NATIVE_CHUNK = 32, 8
NATIVE_CHECK_B, NATIVE_CHECK_SWEEPS = 8, 4
MESH_ONE_B, MESH_FW_ITERS, MESH_K = 8, 4, 8


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def phase_card_and_build(torch):
    from tnco_tpu_torch import native
    from tnco_tpu_torch.device import card_info
    from tnco_tpu_torch.kernels import build
    smi = ', '.join(card_info(torch.device('cuda')).values())
    log(f'card: {smi}')
    t0 = time.perf_counter()
    build.load()
    log(f'build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}')
    for line in build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')
    # The native library too, here: ContractionTree.is_valid calls it, so
    # its g++ build would otherwise land in the first phase that audits.
    t0 = time.perf_counter()
    if not native.available():
        fail('native: the library is not available')
    log(f'build native: {time.perf_counter() - t0:.1f} s into '
        f"{native.LIB_PATH} (g++ {' '.join(native.CXX_FLAGS)})")
    return smi


def _rand_ids(torch, gen, b, q, n, frac_null=0.1, frac_high=0.05):
    dev = gen.device
    ids = torch.randint(0, n, (b, q), generator=gen, device=dev,
                        dtype=torch.int32)
    r = torch.rand((b, q), generator=gen, device=dev)
    ids = torch.where(r < frac_null, -1, ids)
    return torch.where(r > 1 - frac_high, n + 7, ids).contiguous()


def _unique_ids(torch, gen, b, q, n, keep=0.5):
    """Per-row unique in-range ids (a kept-walk apply), -1 elsewhere."""
    dev = gen.device
    perm = torch.argsort(torch.rand((b, n), generator=gen, device=dev),
                         dim=1)[:, :q].to(torch.int32)
    r = torch.rand((b, q), generator=gen, device=dev)
    return torch.where(r < keep, perm, -1).contiguous()


def phase_kernels(torch):
    from tnco_tpu_torch.kernels import scatter as ks
    from tnco_tpu_torch.testing import kernel_cases as kc
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    n_checks = 0
    # K1 and K3: every route at the main path's shapes (the walks
    # engine's index gather and pulls, the slicer's gathers, the applies)
    # and the edge cases of tnco_tpu_torch.testing.kernel_cases, which the
    # card tests run too.
    for kind, cases, check in (('gather_gbn', kc.GATHER_CASES,
                                kc.check_gather),
                               ('scatter_rows_inplace', kc.SCATTER_CASES,
                                kc.check_scatter)):
        for case in cases:
            for dtype in (torch.int32, torch.float32):
                bad = check(case, dtype, dev)
                torch.cuda.synchronize()
                if bad:
                    fail(f'{kind} != plain in case {case.name!r} '
                         f'({dtype}) by {bad}')
                n_checks += 1
    # K2: the bench's K4 call (ids [64, 256] -> [64, 3328]) and the edge
    # cases of kernel_cases.
    for case in kc.INV_CASES:
        bad = kc.check_inv(case, dev)
        torch.cuda.synchronize()
        if bad:
            fail(f'inv_ids != plain in case {case.name!r}')
        n_checks += 1
    log(f'kernels: {n_checks} checks bitwise equal to the plain versions')


def _audit_result(res, tn, max_width):
    """Valid path, exact cost recompute (``_exact_total``: bigints over
    the index words), widths within the cap after the result's slices."""
    from tnco_tpu_torch.ctree import ContractionTree

    ctree = ContractionTree(res.path, tn.ts_inds, tn.dims,
                            output_inds=tn.output_inds)
    ok, msg = ctree.is_valid(return_message=True)
    if not ok:
        fail(f'invalid path: {msg}')
    width, total = _exact_total(ctree, _label_lanes(ctree, res.slices))
    # The per-component costs are exact; the total is their Decimal sum
    # (context precision, as in the JAX package's results).
    if sum(int(c) for c in res.disconnected_costs) != total or \
            res.cost != Decimal(0) + Decimal(total):
        fail(f'cost {res.cost} != exact recompute {total}')
    if width > max_width + 1e-9:
        fail(f'width {width} > {max_width} after slicing')


def phase_app(torch):
    import numpy as np

    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.parallel.replicas import resolve_engine
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    # fuse=0 keeps the full network (N=3241) on the walks engine, as in
    # every earlier run; the default fuse=4 shrinks it to N*W = 22230,
    # which 'auto' routes to the 'batched' engine (phase 11).
    loaded = load_tn(tn, fuse=0, seed=0)
    n_nodes = 2 * loaded.n_tensors - 1
    n_lanes = -(-loaded.n_inds // 32)
    engine = resolve_engine(n_nodes, n_lanes, accel=True, native=False,
                            sparse=False, max_new_slices=0,
                            disable_shared_inds=False, prob_kind=None)
    log(f'app: N={n_nodes} W={n_lanes} N*W={n_nodes * n_lanes} '
        f'-> engine {engine!r}')
    if engine != 'walks':
        fail(f"'auto' resolved to {engine!r}, expected 'walks'")

    opt = Optimizer(max_width=30, seed=0)
    with recorded_cases() as seen:
        reset_launch_counts()
        t0 = time.perf_counter()
        _, res = opt.optimize(tn, betas=(0, 60), n_steps=16,
                              n_runs=APP_RUNS, update_slices=2, fuse=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    log(f'app: {APP_RUNS} runs x 16 steps in {wall:.2f} s (runner set-up + '
        f'anneal {res[0].runtime_s:.2f} s; the rest is paths and audits '
        f'on the host); launches {counts}')
    if not all(counts[k] > 0 for k in FW_KERNELS):
        fail(f'a kernel of the path was never launched: {counts}')
    _check_recorded(torch, seen, 'app', widen=B)
    t0 = time.perf_counter()
    for r in res:
        _audit_result(r, loaded, 30)
    costs = np.asarray([math.log2(int(r.cost)) for r in res])
    log(f'app: {len(res)} results audited in '
        f'{time.perf_counter() - t0:.1f} s; '
        f'log2 cost best {costs.min():.4f} median {np.median(costs):.4f}')
    return counts


def _int_widths(tree):
    """``width(x)``: the sum of ``tree``'s log2 dims over the set bits of
    index words ``x [..., W]`` as int64, from per-byte popcounts of the
    words (one mask per log2 value); None unless every log2 dim is an
    integer."""
    import numpy as np

    log2d = tree.log2_dims_array
    if not np.array_equal(log2d, np.round(log2d)):
        return None
    pop8 = np.asarray([bin(i).count('1') for i in range(256)], np.int64)
    log2i = np.zeros(32 * tree.inds_array.shape[1], dtype=np.int64)
    log2i[:len(log2d)] = np.round(log2d)
    masks = [(v, np.packbits(log2i == v, bitorder='little').view(np.uint32))
             for v in np.unique(log2i[log2i > 0])]

    def width(x):                                  # [..., W] -> int [...]
        out = np.zeros(x.shape[:-1], dtype=np.int64)
        for v, mask in masks:
            out += v * pop8[(x & mask).view(np.uint8)].sum(axis=-1)
        return out

    return width


def _exact_total(tree, lanes=None):
    """``(largest width after slicing, exact bigint sliced total)`` of
    ``tree`` under the slice lanes ``lanes`` (None: no slices), the
    total as ``ContractionTree.total_cost_exact`` defines it times the
    sliced dims' product.  On integer log2 dims every contraction costs
    ``2**width``: widths come from ``_int_widths`` and the total from a
    count per width; other dims multiply node by node."""
    import numpy as np

    log2d = tree.log2_dims_array
    words = tree.inds_array                                  # uint32 [N, W]
    w = words.shape[1]
    sl = (np.zeros(w, dtype=np.uint32) if lanes is None else
          np.asarray(lanes, dtype=np.uint32))
    nodes = tree.nodes_array
    inner = nodes[nodes[:, 0] >= 0]
    union = (words[inner[:, 0]] | words[inner[:, 1]]) & ~sl
    width = _int_widths(tree)
    if width is None:
        dims_l = tree.dims_array

        def bits(x):
            return np.unpackbits(x.view(np.uint8), axis=-1,
                                 bitorder='little')[..., :len(log2d)]

        total = sum(math.prod(int(d) for d in dims_l[u.astype(bool)])
                    for u in bits(union))
        sl_mul = math.prod(int(d) for d in dims_l[bits(sl).astype(bool)])
        return (bits(words & ~sl) @ log2d).max(), total * sl_mul
    counts = np.bincount(width(union))
    total = sum(int(c) << k for k, c in enumerate(counts) if c)
    return float(width(words & ~sl).max()), total << int(width(sl))


def _label_lanes(tree, labels):
    """The index words of ``tree`` that hold ``labels`` (uint32 [W])."""
    from tnco_tpu_torch.bitset import Bitset

    order = tree.inds_order
    return Bitset([order.index(x) for x in labels], n=len(order)).lanes(
        tree.inds_array.shape[1])


def _exact_sliced(tree, lanes):
    """``(largest width after slicing, exact log2 of the sliced total)``
    of ``tree`` under the slice lanes ``lanes`` (bigint products)."""
    width, total = _exact_total(tree, lanes)
    return width, math.log2(total)


def _audit_fw_runner(runner, max_width, what):
    """Every replica's best tree is valid, fits the cap after its min
    slices, and its exact sliced bigint total is within 1e-3 in log2 of
    the device's min total.  Returns the largest difference."""
    import numpy as np

    mins = runner.log2_min_totals()
    worst = 0.0
    for r in range(runner.n_replicas):
        best = runner.min_ctree(r)
        ok, msg = best.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: replica {r}: invalid min tree: {msg}')
        width, exact = _exact_sliced(best, runner.min_slices_lanes(r))
        if width > max_width + 1e-9:
            fail(f'{what}: replica {r}: width over the cap after slicing')
        worst = max(worst, abs(exact - float(mins[r])))
    if worst > 1e-3:
        fail(f'{what}: device min totals differ from the exact recompute by '
             f'{worst}')
    return worst


def phase_flagship(torch, card):
    import numpy as np

    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW

    ts, out, dims, _ = _sycamore()
    seeds = list(range(B))
    t0 = time.perf_counter()
    paths = _flagship_paths()
    ctrees = [ContractionTree(p[0], ts, dims, output_inds=out)
              for p in paths]
    cm = SimpleCostModel(max_width=30)
    runner = ReplicaRunnerFW(ctrees, seeds, cmodel=cm, n_walks=P)
    log(f'flagship: N={len(ctrees[0])} W={ctrees[0].inds_array.shape[1]} '
        f'B={B} P={P} engine={runner.engine!r} set-up '
        f'{time.perf_counter() - t0:.1f} s')
    if runner.engine != 'walks':
        fail(f'flagship engine {runner.engine!r}')
    betas = np.linspace(0.0, 60.0, 26)
    runner.run(betas[:2], update_slices=2)          # warm-up
    torch.cuda.synchronize()
    moves0, applied0 = runner.moves_done, runner.applied_done
    reset_launch_counts()
    t0 = time.perf_counter()
    runner.run(betas[2:], update_slices=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    moves = runner.moves_done - moves0
    applied = runner.applied_done - applied0
    log(f'flagship: {len(betas) - 2} iterations in {dt:.3f} s '
        f'({1e3 * dt / (len(betas) - 2):.2f} ms/iteration) on {card}; '
        f'launches {counts}')
    log(f'proposals/s: {moves / dt:.6g} ({card})')
    log(f'applied/s: {applied / dt:.6g} ({card})')
    if not all(counts[k] > 0 for k in FW_KERNELS):
        fail(f'a kernel of the flagship path was never launched: {counts}')
    worst = _audit_fw_runner(runner, 30, 'flagship')
    mins = runner.log2_min_totals()
    log(f'flagship: {B} replicas audited; best log2 total {mins.min():.4f};'
        f' |device - exact| <= {worst:.2e}')
    return counts, ctrees, [p[0] for p in paths]


@functools.lru_cache(maxsize=1)
def _flagship_paths():
    """The initial paths of the B flagship runs on the full network (seeds
    0 to B - 1, one list per component), built once, in phase 4, for
    phases 4, 6 and 8."""
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths

    return tuple(_build_run_paths(_sycamore()[3], list(range(B)), -1))


def _sycamore():
    """The Sycamore-like m=20 network: ``(ts, out, dims, tn)``."""
    from tnco_tpu_torch.app.tn import Tensor, TensorNetwork
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    ts, out, dims = sycamore_like_tn(20)
    tn = TensorNetwork([Tensor(xs, tuple(dims[x] for x in xs)) for xs in ts],
                       output_inds=out)
    return ts, out, dims, tn


def _im_setup(torch, ts, out, dims, path_seeds):
    """An IM batch on the card from random paths of ``path_seeds`` (one
    replica each): ``(batch, cfg, log2d_w32)``."""
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
    from tnco_tpu_torch.ops import bitops
    from tnco_tpu_torch.utils.tn import get_random_contraction_path

    dev = torch.device('cuda')
    trees = {s: ContractionTree(get_random_contraction_path(ts, out, seed=s),
                                ts, dims, output_inds=out)
             for s in set(path_seeds)}
    ctrees = [trees[s] for s in path_seeds]
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = bitops.pad_log2_dims(t.log2_dims_array, w, torch.float32, dev)
    batch = sb.init_batch(ctrees, list(range(len(ctrees))),
                          log2d.cpu().numpy(), device=dev)
    return batch, SweepConfig(n_leaves=t.n_leaves, n_lanes=w), \
        log2d.reshape(w, 32)


def _batch_err(torch, got, want):
    """Largest word difference over every field of two batches."""
    return max(_max_abs_err(torch, getattr(got, f), getattr(want, f))
               for f in type(got).field_names())


def _walker_cases(np):
    """The walker checks' networks and operating points: ``(name,
    network, one path seed per replica, walks, prob_kind, K)``.  The
    mixed-dims lattice takes the kernel's tree width route, the dim-2
    networks its popcount route; P=1 and B=1 are the edge cases where a
    transposed [P, B] tensor needs no copy; P=128 gives every warp 16
    walks and the claim scan its longest run; 'greedy' keeps improving,
    so that many dirty-row snapshots run per launch; the 7001-tensor
    hyper-index chain (N=14001, W=110) is too large for the topology in
    shared memory and runs the kernel's global-topology instantiation, on
    dims 2 (popcount widths) and dims 3 (tree widths)."""
    from tnco_tpu_torch.testing.networks import (hyper_chain_tn, lattice_2d,
                                                 sycamore_like_tn)

    rng = np.random.default_rng(0)
    ts, out, dims = lattice_2d(6, 6)
    mixed = (ts, out, {x: int(rng.integers(2, 6)) for x in sorted(dims)})
    syc = sycamore_like_tn(20)
    return [('mixed-dims 6x6 lattice', mixed, [0, 1, 2, 3], P_IM, 'mh',
             K_CHECK),
            ('mixed-dims 6x6 lattice', mixed, [0, 1, 2], 1, 'mh', K_CHECK),
            ('mixed-dims 6x6 lattice', mixed, [0], 40, 'mh', K_CHECK),
            ('mixed-dims 6x6 lattice', mixed, [0, 1, 2, 3], P, 'mh',
             K_CHECK),
            ('mixed-dims 6x6 lattice', mixed, [0, 1, 2, 3], P, 'greedy',
             K_CHECK),
            ('Sycamore m=20', syc, [0, 1, 2, 3] * 16, P_IM, 'mh', K_CHECK),
            ('Sycamore m=20', syc, [0, 1, 2, 3] * 16, P_IM, 'greedy',
             K_CHECK),
            ('Sycamore m=20', syc, [0, 1, 2, 3] * (APP_RUNS // 4), P_IM,
             'mh', K_CHECK),
            ('hyper-index chain', hyper_chain_tn(7001), [0, 1], P_IM, 'mh',
             K_BIG),
            ('hyper-index chain, dims 3', hyper_chain_tn(7001, 3), [0, 1],
             P_IM, 'mh', K_BIG)]


def phase_walker_checks(torch):
    """K5 against its plain version on the same pre-drawn streams: state,
    min state, totals, pos, moves and applied, bitwise, over two chained
    chunks (the second starts mid-walk)."""
    import dataclasses

    import numpy as np

    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw

    dev = torch.device('cuda')
    for name, (ts, out, dims), path_seeds, p, kind, k in _walker_cases(np):
        batch, cfg, log2d_w32 = _im_setup(torch, ts, out, dims, path_seeds)
        cfg = dataclasses.replace(cfg, prob_kind=kind)
        n, b = batch.c0.shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
        applied = 0
        for chunk in range(2):
            betas = torch.linspace(10.0 * chunk, 10.0 * chunk + 10.0,
                                   k, device=dev)
            draws = smw.draw_chunk(gen, cfg.n_leaves, k, p, b)
            pos0 = pos.clone()
            got, mg = kw.run_walker(batch, betas, log2d_w32, cfg, p, pos,
                                    draws=draws)
            want, mw = kw.run_walker_plain(batch, betas, log2d_w32, cfg, p,
                                           pos, draws=draws)
            err = max(_batch_err(torch, got, want),
                      _max_abs_err(torch, mg['pos'], mw['pos']),
                      _max_abs_err(torch, pos, pos0))
            if err or mg['moves'] != mw['moves'] or \
                    int(mg['applied']) != int(mw['applied']):
                fail(f'walker_im != plain on {name}, chunk {chunk}: word '
                     f'error {err}, applied {int(mg["applied"])} vs '
                     f'{int(mw["applied"])}')
            applied += int(mg['applied'])
            batch, pos = got, mg['pos']
        if not applied:
            fail(f'walker_im check on {name} applied no move')
        log(f'kernels: walker_im == plain bitwise on {name} (N={n}, '
            f'W={cfg.n_lanes}, B={b}, P={p}, {kind}, 2 x K={k}, '
            f'{applied} moves applied)')


def _record_runners(module, name):
    """Replaces the runner class ``module.<name>`` by a subclass that
    records its instances, each with the host seconds of its set-up
    (``setup_s``) and of its ``run`` calls (``run_s``, which end in a
    read of the min totals); returns ``(runners, restore)``."""
    cls = getattr(module, name)
    runners = []

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            self.setup_s = time.perf_counter() - t0
            self.run_s = 0.0
            runners.append(self)

        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().run(*args, **kwargs)
            self.run_s += time.perf_counter() - t0
            return out

    setattr(module, name, Recorded)
    return runners, lambda: setattr(module, name, cls)


def _audit_im_runner(runner, what):
    """Every replica's best tree is valid and its exact bigint cost is
    within 1e-3 in log2 of the device's min total."""
    mins = runner.log2_min_totals()
    worst = 0.0
    exact = []
    for r in range(runner.n_replicas):
        best = runner.min_ctree(r)
        ok, msg = best.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: replica {r}: invalid min tree: {msg}')
        exact.append(_exact_total(best)[1])
        worst = max(worst, abs(math.log2(exact[-1]) - float(mins[r])))
    if worst > 1e-3:
        fail(f'{what}: device min totals differ from the exact recompute '
             f'by {worst}')
    return exact, worst


def phase_app_im(torch):
    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.parallel.replicas import resolve_engine
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    _, _, _, tn = _sycamore()
    loaded = load_tn(tn, fuse=0, seed=0)
    n_nodes = 2 * loaded.n_tensors - 1
    n_lanes = -(-loaded.n_inds // 32)
    engine = resolve_engine(n_nodes, n_lanes, accel=True, native=False,
                            sparse=False, max_new_slices=0,
                            disable_shared_inds=False, prob_kind=None,
                            fw=False)
    log(f'app IM: N={n_nodes} W={n_lanes} -> engine {engine!r}')
    if engine != 'walker':
        fail(f"'auto' resolved to {engine!r}, expected 'walker'")
    runners, restore = _record_runners(im_sa, 'ReplicaRunner')
    try:
        opt = Optimizer(seed=0)
        with recorded_cases() as seen:
            reset_launch_counts()
            t0 = time.perf_counter()
            _, res = opt.optimize(tn, betas=(0, 60), n_steps=32,
                                  n_runs=APP_RUNS, fuse=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        restore()
    (runner,) = runners
    log(f'app IM: {APP_RUNS} runs x 32 steps in {wall:.2f} s (runner '
        f'set-up + '
        f'anneal {res[0].runtime_s:.2f} s); engine {runner.engine!r}, '
        f'P={runner.n_walks}; launches {counts}')
    if runner.engine != 'walker':
        fail(f'app IM runner engine {runner.engine!r}')
    if not all(counts[k] > 0 for k in IM_KERNELS):
        fail(f'a kernel of the IM path was never launched: {counts}')
    _check_recorded(torch, seen, 'app IM', widen=B)
    _audit_im_results(res, loaded, runner, 'app IM')
    return counts


def _audit_im_results(res, loaded, runner, what):
    """Every IM app result is a valid path of ``loaded`` at its exact
    cost, and the results' costs are the replicas' best trees' costs
    (each within 1e-3 in log2 of the device min total)."""
    import numpy as np

    from tnco_tpu_torch.ctree import ContractionTree

    t0 = time.perf_counter()
    for r in res:
        ctree = ContractionTree(r.path, loaded.ts_inds, loaded.dims,
                                output_inds=loaded.output_inds)
        ok, msg = ctree.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: invalid path: {msg}')
        total = _exact_total(ctree)[1]
        if sum(int(c) for c in r.disconnected_costs) != total or \
                r.cost != Decimal(0) + Decimal(total):
            fail(f'{what}: cost {r.cost} != exact recompute {total}')
    exact, worst = _audit_im_runner(runner, what)
    # r.cost is a Decimal sum at context precision; the per-component
    # costs are the exact bigints.
    if sorted(sum(int(c) for c in r.disconnected_costs) for r in res) != \
            sorted(exact):
        fail(f'{what}: result costs are not the replicas\' best costs')
    costs = np.asarray([math.log2(int(r.cost)) for r in res])
    log(f'{what}: {len(res)} results audited in '
        f'{time.perf_counter() - t0:.1f} s; log2 cost best {costs.min():.4f}'
        f' median {np.median(costs):.4f}; |device - exact| <= {worst:.2e}')


def phase_flagship_im(torch, card):
    import numpy as np

    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.parallel import ReplicaRunner

    ts, out, dims, _ = _sycamore()
    seeds = list(range(B))
    t0 = time.perf_counter()
    paths = _flagship_paths()
    ctrees = [ContractionTree(p[0], ts, dims, output_inds=out)
              for p in paths]
    runner = ReplicaRunner(ctrees, seeds)
    setup = time.perf_counter() - t0
    log(f'flagship IM: N={len(ctrees[0])} W={ctrees[0].inds_array.shape[1]}'
        f' B={B} P={runner.n_walks} engine={runner.engine!r} set-up '
        f'{setup:.1f} s')
    if runner.engine != 'walker' or runner.n_walks != P_IM:
        fail(f'flagship IM engine {runner.engine!r}, P={runner.n_walks}')
    betas = np.linspace(0.0, 60.0, 3 * K_CHUNK)
    runner.run(betas[:K_CHUNK])                      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    rates = []
    for i in (1, 2):
        moves0, applied0 = runner.moves_done, runner.applied_done
        t0 = time.perf_counter()
        runner.run(betas[i * K_CHUNK:(i + 1) * K_CHUNK])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moves = runner.moves_done - moves0
        applied = runner.applied_done - applied0
        rates.append((dt, moves / dt, applied / dt))
        log(f'flagship IM: chunk {i} of {K_CHUNK} iterations in '
            f'{1e3 * dt:.3f} ms on {card}')
        log(f'proposals/s IM: {moves / dt:.6g} ({card})')
        log(f'applied/s IM: {applied / dt:.6g} ({card})')
    counts = launch_counts()
    log(f'flagship IM: launches {counts}')
    if not all(counts[k] > 0 for k in IM_KERNELS):
        fail(f'a kernel of the IM flagship was never launched: {counts}')
    _, worst = _audit_im_runner(runner, 'flagship IM')
    log(f'flagship IM: {B} replicas audited; best log2 total '
        f'{runner.log2_min_totals().min():.4f}; |device - exact| <= '
        f'{worst:.2e}')
    return counts, runner


def _fw_setup(torch, ts, out, dims, path_seeds, max_width):
    """An FW batch on the card from random paths of ``path_seeds`` (one
    replica each): ``(batch, cfg, log2d_w32, uniform_log2)``."""
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW
    from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
    from tnco_tpu_torch.ops import bitops
    from tnco_tpu_torch.utils.tn import get_random_contraction_path

    dev = torch.device('cuda')
    trees = {s: ContractionTree(get_random_contraction_path(ts, out, seed=s),
                                ts, dims, output_inds=out)
             for s in set(path_seeds)}
    ctrees = [trees[s] for s in path_seeds]
    t = ctrees[0]
    w = t.inds_array.shape[1]
    log2d = bitops.pad_log2_dims(t.log2_dims_array, w, torch.float32, dev)
    batch = sfb.init_batch_fw(ctrees, list(range(len(ctrees))), max_width,
                              log2d.cpu().numpy(), device=dev)
    return (batch, SweepConfigFW(n_leaves=t.n_leaves, n_lanes=w),
            log2d.reshape(w, 32), uniform_log2_dim(t.log2_dims_array))


def _count_reslices(kw):
    """Wraps ``kw.walker_fw_reslice`` to count the reslices run and the
    replicas whose slices changed; returns ``(stats, restore)``."""
    orig = kw.walker_fw_reslice
    stats = {'reslices': 0, 'taken': 0}

    def counted(seg, *args, **kwargs):
        n = seg['rows'].shape[1] - 1
        before = seg['rows'][:, n].clone()
        orig(seg, *args, **kwargs)
        stats['reslices'] += 1
        stats['taken'] += int((seg['rows'][:, n] != before).any(dim=1).sum())

    kw.walker_fw_reslice = counted
    return stats, lambda: setattr(kw, 'walker_fw_reslice', orig)


def phase_walker_fw_checks(torch):
    """K5-FW against its plain version on the same pre-drawn streams:
    state, min state, widths, slices, min slices, totals, pos, moves and
    applied, bitwise, over two chained chunks with reslices inside (the
    cases of the IM checks, each with its width cap and reslice cadence:
    lattice 10 every 5, Sycamore 30 every 10, the chain 4 every 4)."""
    import dataclasses

    import numpy as np

    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw

    dev = torch.device('cuda')
    caps = {'mixed-dims 6x6 lattice': (10.0, 5),
            'Sycamore m=20': (30.0, UPDATE_SLICES),
            'hyper-index chain': (4.0, 4),
            'hyper-index chain, dims 3': (4.0, 4)}
    stats, restore = _count_reslices(kw)
    try:
        for name, (ts, out, dims), path_seeds, p, kind, k in \
                _walker_cases(np):
            mw, upd = caps[name]
            batch, cfg, log2d_w32, ul = _fw_setup(torch, ts, out, dims,
                                                  path_seeds, mw)
            cfg = dataclasses.replace(cfg, prob_kind=kind)
            n, b = batch.c0.shape
            skip = torch.zeros(cfg.n_lanes, dtype=torch.int32, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            pos = torch.full((p, b), -1, dtype=torch.int32, device=dev)
            applied = 0
            stats.update(reslices=0, taken=0)
            for chunk in range(2):
                it = np.arange(chunk * k, (chunk + 1) * k)
                mask = it % upd == 0
                betas = torch.linspace(10.0 * chunk, 10.0 * chunk + 10.0,
                                       k, device=dev)
                draws = smw.draw_chunk_fw(gen, cfg.n_leaves, k, p, b,
                                          cfg.n_lanes * 32,
                                          int(mask.sum()))
                pos0 = pos.clone()
                args = (batch, betas, mask, mw, log2d_w32, skip, cfg, p, pos)
                got, mg = kw.run_walker_fw(*args, uniform_log2=ul,
                                           draws=draws)
                want, mw_ = kw.run_walker_fw_plain(*args, uniform_log2=ul,
                                                   draws=draws)
                err = max(_batch_err(torch, got, want),
                          _max_abs_err(torch, mg['pos'], mw_['pos']),
                          _max_abs_err(torch, pos, pos0))
                if err or mg['moves'] != mw_['moves'] or \
                        int(mg['applied']) != int(mw_['applied']):
                    fail(f'walker_fw != plain on {name}, chunk {chunk}: word '
                         f'error {err}, applied {int(mg["applied"])} vs '
                         f'{int(mw_["applied"])}')
                applied += int(mg['applied'])
                batch, pos = got, mg['pos']
            if not applied:
                fail(f'walker_fw check on {name} applied no move')
            if not stats['reslices']:
                fail(f'walker_fw check on {name} ran no reslice')
            log(f'kernels: walker_fw == plain bitwise on {name} (N={n}, '
                f'W={cfg.n_lanes}, B={b}, P={p}, {kind}, max_width {mw}, '
                f'2 x K={k}, reslice every {upd}: {stats["reslices"]} '
                f'reslices run, {stats["taken"]} replica reslices taken; '
                f'{applied} moves applied)')
    finally:
        restore()


def phase_k4_p1_checks(torch):
    """K4 and P1 against their plain versions on the card, bitwise."""
    from tnco_tpu_torch.kernels import scatter as ks
    from tnco_tpu_torch.testing import kernel_cases as kc
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rand_words(shape, nan_payloads=False):
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          device=dev, dtype=torch.int32)
        if not nan_payloads:
            return x
        # quiet and signalling NaNs with payloads, -inf, -0
        special = torch.tensor([0x7FC12345, 0x7F800001, 0xFF800000 - 2**32,
                                0x80000000 - 2**32], device=dev,
                               dtype=torch.int32)
        k = min(4, shape[-1])
        x[..., :k] = special[:k]
        return x.view(torch.float32)

    q = 2 * P
    ids = _unique_ids(torch, gen, B, q, N_PAD, keep=0.9)
    r = torch.rand((B, q), generator=gen, device=dev)
    ids = torch.where(r < 0.05, N_PAD + 7, ids).contiguous()
    dup = ids.clone()
    dup[:, q // 2:] = dup[:, :q // 2]
    tiny = torch.randint(0, 3241, (1, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    # (what, G, B, N, ids, planes, NaN payloads)
    cases = [('main shape', F_APPLY, B, N_PAD, ids, None, False),
             ('plane range', F_APPLY, B, N_PAD, ids, (5, 40), False),
             ('float32', F_APPLY, B, N_PAD, ids, (0, 8), True),
             ('B=1 Q=1 N=3241', 3, 1, 3241, tiny, None, True),
             ('duplicate ids', 8, B, N_PAD, dup, None, False)]
    for what, g, b, n, ids_, planes, nan in cases:
        lo, hi = (0, g) if planes is None else planes
        vals = rand_words((g, b, n), nan)
        upd = rand_words((hi - lo, b, ids_.shape[1]), nan)
        before = vals.clone()
        got = ks.scatter_rows_gbn(vals, ids_, upd, planes=planes)
        want = ks.scatter_rows_gbn_plain(vals, ids_, upd, planes)
        err = max(_max_abs_err(torch, got, want),
                  _max_abs_err(torch, vals, before))
        if err or got.shape != (hi - lo, b, n) or got.dtype != vals.dtype:
            fail(f'scatter_rows_gbn != plain ({what}): word error {err}, '
                 f'shape {tuple(got.shape)} {got.dtype}')
    log(f'kernels: scatter_rows_gbn == plain bitwise in {len(cases)} cases '
        '(the caller\'s planes unchanged)')
    for case in kc.PROBE_CASES:
        bad = kc.check_probe(case, dev)
        torch.cuda.synchronize()
        if bad:
            fail(f'probe != plain (or the state changed) in case '
                 f'{case.name!r}: {bad}')
    log(f'kernels: probe loop (every route) and take == '
        f'plain bitwise in {len(kc.PROBE_CASES)} cases, the state unchanged')


# The claim kernel's shapes: the FW walks cell (B=2048, P=128 on the
# published Sycamore-53 m=20 map, N=3297), the FW flagship, the walks IM
# runner's default P=32 and the multi-walk runners' P=8 (the IM cell's
# B=1024); node ids drawn from [0, n).
CLAIM_SHAPES = (('walks FW cell', 2048, 128, 3297),
                ('walks FW flagship', B, 128, 3241),
                ('walks IM', B, 32, 3241), ('multiwalk', 1024, 8, 3297))


def _claim_case(torch, gen, b, p, n, frac_null=0.1, frac_accept=0.5):
    """``(accept, ev)`` on the card: ids in ``[0, n)`` with ``frac_null``
    of each plane NULL, on accepted and rejected walks alike."""
    dev = gen.device
    ev = {}
    for k in 'abcde':
        ids = torch.randint(0, n, (b, p), generator=gen, device=dev,
                            dtype=torch.int32)
        r = torch.rand((b, p), generator=gen, device=dev)
        ev[k] = torch.where(r < frac_null, -1, ids).contiguous()
    accept = torch.rand((b, p), generator=gen, device=dev) < frac_accept
    return accept, ev


def phase_claim_checks(torch):
    """The claim kernel against its plain version on the card, bitwise,
    at CLAIM_SHAPES and the edge cases, and the launch count."""
    from tnco_tpu_torch.kernels import claim as kc
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # (what, B, P, n, NULL share, accept share, layout)
    cases = [(what, b, p, n, 0.1, 0.5, 'rows')
             for what, b, p, n in CLAIM_SHAPES]
    cases += [('dense conflicts', 2048, 128, 129, 0.1, 0.5, 'rows'),
              ('all accepted', 64, 128, 3241, 0.05, 1.0, 'rows'),
              ('none accepted', 64, 128, 3241, 0.1, 0.0, 'rows'),
              ('many NULLs', 64, 32, 3241, 0.5, 0.9, 'rows'),
              ('multiwalk [P, B] views', 1024, 8, 3297, 0.1, 0.5, 'cols'),
              ('P=130', 64, 130, 400, 0.1, 0.6, 'rows'),
              ('throughput P=320', B, 320, 3241, 0.1, 0.5, 'rows'),
              ('P=1', 8, 1, 4, 0.3, 0.5, 'rows'),
              ('B=1', 1, 128, 300, 0.1, 0.5, 'rows')]
    reset_launch_counts()
    for what, b, p, n, frac_null, frac_accept, layout in cases:
        accept, ev = _claim_case(torch, gen, b, p, n, frac_null,
                                 frac_accept)
        if layout == 'cols':
            accept = accept.T.contiguous().T
            ev = {k: v.T.contiguous().T for k, v in ev.items()}
        got = kc.claim_disjoint(accept, ev)
        want = kc.claim_disjoint_plain(accept, ev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f'claim_disjoint != plain ({what}, B={b} P={p}): '
                 f'{int((got != want).sum())} walks differ')
        if frac_accept == 0.0 and got.any():
            fail(f'claim_disjoint kept a rejected walk ({what})')
    if launch_counts()['claim_disjoint'] != len(cases):
        fail(f"claim_disjoint launches {launch_counts()['claim_disjoint']} "
             f'!= {len(cases)} calls')
    log(f'kernels: claim_disjoint == plain bitwise in {len(cases)} cases, '
        'one launch a call')


def phase_bench(torch):
    """The bench path: ``tnco_tpu_torch.bench.main()`` (its kernel
    identity check must read "ok") and the probe's ``main()``."""
    from tnco_tpu_torch import bench
    from tnco_tpu_torch.benchmarks import gather_probe
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    line = bench.main()
    t1 = time.perf_counter()
    gather_probe.main([])
    t2 = time.perf_counter()
    counts = launch_counts()
    log(f'bench: {t1 - t0:.1f} s, probe {t2 - t1:.3f} s; launches {counts}')
    if line.get('kernel_identity') != 'ok':
        fail(f"bench kernel identity: {line.get('kernel_identity')}")
    if 'vs_baseline' in line or 'vs_prev_round' in line:
        fail('the bench line compares with TPU figures')
    if not all(counts[k] > 0 for k in BENCH_KERNELS):
        fail(f'a kernel of the bench path was never launched: {counts}')
    return counts


def phase_app_fw_walker(torch):
    import numpy as np

    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    _, _, _, tn = _sycamore()
    loaded = load_tn(tn, fuse=0, seed=0)
    runners, restore = _record_runners(fw_sa, 'ReplicaRunnerFW')
    try:
        opt = Optimizer(max_width=30, engine='walker', seed=0)
        with recorded_cases() as seen:
            reset_launch_counts()
            t0 = time.perf_counter()
            _, res = opt.optimize(tn, betas=(0, 60), n_steps=32,
                                  n_runs=APP_RUNS,
                                  update_slices=UPDATE_SLICES, fuse=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        restore()
    (runner,) = runners
    log(f'app FW walker: {APP_RUNS} runs x 32 steps in {wall:.2f} s (runner '
        f'set-up '
        f'+ anneal {res[0].runtime_s:.2f} s); engine {runner.engine!r}, '
        f'P={runner.n_walks}; launches {counts}')
    if runner.engine != 'walker':
        fail(f'app FW walker runner engine {runner.engine!r}')
    if not all(counts[k] > 0 for k in FW_WALKER_KERNELS):
        fail(f'a kernel of the FW walker path was never launched: {counts}')
    _check_recorded(torch, seen, 'app FW walker', widen=B)
    t0 = time.perf_counter()
    for r in res:
        _audit_result(r, loaded, 30)
    worst = _audit_fw_runner(runner, 30, 'app FW walker')
    costs = np.asarray([math.log2(int(r.cost)) for r in res])
    log(f'app FW walker: {len(res)} results audited in '
        f'{time.perf_counter() - t0:.1f} s; log2 cost best '
        f'{costs.min():.4f} median {np.median(costs):.4f};'
        f' |device - exact| <= {worst:.2e}')
    return counts


def phase_flagship_fw_walker(torch, card):
    import numpy as np

    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.kernels import walker as kw
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW

    ts, out, dims, _ = _sycamore()
    seeds = list(range(B))
    t0 = time.perf_counter()
    paths = _flagship_paths()
    ctrees = [ContractionTree(p[0], ts, dims, output_inds=out)
              for p in paths]
    t1 = time.perf_counter()
    runner = ReplicaRunnerFW(ctrees, seeds, cmodel=SimpleCostModel(
        max_width=30), engine='walker')
    setup = time.perf_counter() - t1
    log(f'flagship FW walker: N={len(ctrees[0])} '
        f'W={ctrees[0].inds_array.shape[1]} B={B} P={runner.n_walks} '
        f'update_slices={UPDATE_SLICES} set-up {setup:.1f} s (+ '
        f'{t1 - t0:.1f} s of initial paths)')
    if runner.engine != 'walker' or runner.n_walks != P_IM:
        fail(f'flagship FW walker engine {runner.engine!r}, '
             f'P={runner.n_walks}')

    # CUDA events around each segment and each reslice of a chunk.
    spans = {'segment': [], 'reslice': []}
    originals = {'segment': kw.walker_fw_segment,
                 'reslice': kw.walker_fw_reslice}

    def timed(name):
        def fn(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            originals[name](*args, **kwargs)
            e.record()
            spans[name].append((s, e))
        return fn

    betas = np.linspace(0.0, 60.0, 3 * K_CHUNK)
    runner.run(betas[:K_CHUNK], update_slices=UPDATE_SLICES)      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    kw.walker_fw_segment = timed('segment')
    kw.walker_fw_reslice = timed('reslice')
    try:
        for i in (1, 2):
            for v in spans.values():
                v.clear()
            moves0, applied0 = runner.moves_done, runner.applied_done
            t0 = time.perf_counter()
            runner.run(betas[i * K_CHUNK:(i + 1) * K_CHUNK],
                       update_slices=UPDATE_SLICES)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            split = {k: sum(s.elapsed_time(e) for s, e in v)
                     for k, v in spans.items()}
            moves = runner.moves_done - moves0
            applied = runner.applied_done - applied0
            log(f'flagship FW walker: chunk {i} of {K_CHUNK} iterations in '
                f'{1e3 * dt:.3f} ms on {card}: kernel segments '
                f'{split["segment"]:.3f} ms ({len(spans["segment"])}), '
                f'reslices {split["reslice"]:.3f} ms '
                f'({len(spans["reslice"])}), rest '
                f'{1e3 * dt - split["segment"] - split["reslice"]:.3f} ms')
            log(f'proposals/s FW walker: {moves / dt:.6g} ({card})')
            log(f'applied/s FW walker: {applied / dt:.6g} ({card})')
    finally:
        kw.walker_fw_segment = originals['segment']
        kw.walker_fw_reslice = originals['reslice']
    counts = launch_counts()
    log(f'flagship FW walker: launches {counts} (2 chunks)')
    if not all(counts[k] > 0 for k in FW_WALKER_KERNELS):
        fail(f'a kernel of the FW walker flagship was never launched: '
             f'{counts}')
    worst = _audit_fw_runner(runner, 30, 'flagship FW walker')
    log(f'flagship FW walker: {B} replicas audited; best log2 total '
        f'{runner.log2_min_totals().min():.4f}; |device - exact| <= '
        f'{worst:.2e}')
    return counts, runner


def _sycamore_fused(fw):
    """Sycamore-like m=20 loaded at the app's default fuse with seed 0,
    as ``Optimizer(seed=0)`` loads it: ``(tn, loaded)``.  Fails unless
    'auto' routes it to the lockstep 'batched' engine."""
    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.parallel.replicas import resolve_engine

    _, _, _, tn = _sycamore()
    loaded = load_tn(tn, seed=0)
    n_nodes = 2 * loaded.n_tensors - 1
    n_lanes = -(-loaded.n_inds // 32)
    engine = resolve_engine(n_nodes, n_lanes, accel=True, native=False,
                            sparse=False, max_new_slices=0,
                            disable_shared_inds=False, prob_kind=None, fw=fw)
    log(f"default fuse ({'FW' if fw else 'IM'}): N={n_nodes} W={n_lanes} "
        f"N*W={n_nodes * n_lanes} -> engine {engine!r}")
    if engine != 'batched':
        fail(f"'auto' resolved to {engine!r}, expected 'batched'")
    return tn, loaded


def phase_app_batched(torch, fw):
    """The app at its default fuse: ``Optimizer(max_width=30, seed=0)``
    (``fw``) or ``Optimizer(seed=0)``, APP_RUNS runs, no ``fuse=``
    argument."""
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    what = f"app batched {'FW' if fw else 'IM'}"
    tn, loaded = _sycamore_fused(fw)
    runners, restore = (_record_runners(fw_sa, 'ReplicaRunnerFW') if fw else
                        _record_runners(im_sa, 'ReplicaRunner'))
    try:
        opt = Optimizer(max_width=30, seed=0) if fw else Optimizer(seed=0)
        with recorded_cases() as seen:
            reset_launch_counts()
            t0 = time.perf_counter()
            tn_out, res = opt.optimize(tn, betas=(0, 60),
                                       n_steps=BATCHED_APP_STEPS,
                                       n_runs=APP_RUNS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        restore()
    (runner,) = runners
    log(f'{what}: {APP_RUNS} runs x {BATCHED_APP_STEPS} sweeps in '
        f'{wall:.2f} s (runner set-up + anneal {res[0].runtime_s:.2f} s); '
        'engine '
        f'{runner.engine!r}; launches {counts}')
    if runner.engine != 'batched':
        fail(f'{what}: runner engine {runner.engine!r}')
    if not all(counts[k] > 0 for k in BATCHED_KERNELS):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    _check_recorded(torch, seen, what, widen=B)
    if tn_out.n_tensors != loaded.n_tensors:
        fail(f'{what}: the app loaded {tn_out.n_tensors} tensors, expected '
             f'{loaded.n_tensors}')
    if fw:
        import numpy as np
        t0 = time.perf_counter()
        for r in res:
            _audit_result(r, tn_out, 30)
        worst = _audit_fw_runner(runner, 30, what)
        costs = np.asarray([math.log2(int(r.cost)) for r in res])
        log(f'{what}: {len(res)} results audited in '
            f'{time.perf_counter() - t0:.1f} s; log2 cost best '
            f'{costs.min():.4f} median {np.median(costs):.4f}; '
            f'|device - exact| <= {worst:.2e}')
    else:
        _audit_im_results(res, tn_out, runner, what)
    return counts


def _kernel_launches(torch, fn):
    """Runs ``fn`` under ``torch.profiler``: ``(kernel launches, summed
    kernel ms, wall ms)`` (copies and fills not counted as launches)."""
    from torch.profiler import ProfilerActivity, profile

    # The device's activity alone: the host ops' events (several a
    # launch) would take the profiler tens of seconds to collect.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n, busy = 0, 0.0
    for ev in prof.events():
        if ev.device_type.name != 'CUDA':
            continue
        us = getattr(ev, 'device_time_total', None)
        us = ev.cuda_time_total if us is None else us
        if us <= 0:
            continue
        busy += us / 1e3
        n += not ev.name.startswith(('Memcpy', 'Memset'))
    return n, busy, 1e3 * wall


def phase_flagship_batched(torch, card, fw):
    """A lockstep flagship at full width: B=64 on the fused network,
    ``ReplicaRunnerFW(engine='batched')`` (max_width=30, reslice every
    UPDATE_SLICES sweeps) or ``ReplicaRunner(engine='batched')``: ms per
    sweep, walk steps per sweep, moves/s, launches per sweep and, FW, the
    reslice's share of the sweeps (CUDA events)."""
    import numpy as np

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW

    what = f"flagship batched {'FW' if fw else 'IM'}"
    _, loaded = _sycamore_fused(fw)
    seeds = list(range(B))
    t0 = time.perf_counter()
    paths = _build_run_paths(loaded, seeds, -1)
    order = tuple(dict.fromkeys(x for xs in loaded.ts_inds for x in xs))
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds,
                              check_shared_inds=True, inds_order=order)
              for p in paths]
    t1 = time.perf_counter()
    runner = (ReplicaRunnerFW(ctrees, seeds, engine='batched',
                              cmodel=SimpleCostModel(max_width=30))
              if fw else ReplicaRunner(ctrees, seeds, engine='batched'))
    log(f'{what}: N={len(ctrees[0])} W={ctrees[0].inds_array.shape[1]} '
        f'B={B} set-up {time.perf_counter() - t1:.1f} s (+ {t1 - t0:.1f} s '
        f'of initial paths)')

    def run(betas):
        if fw:
            runner.run(betas, update_slices=UPDATE_SLICES)
        else:
            runner.run(betas)

    k = BATCHED_SWEEPS
    betas = np.linspace(0.0, 60.0, 3 * k)
    run(betas[:UPDATE_SLICES])                                # warm-up
    torch.cuda.synchronize()
    steps = [0]
    spans = []
    originals = (sb._propose, sfb._greedy_slices_b, sfb._lcc_fw_b)

    def counted(*args, **kwargs):
        steps[0] += 1
        return originals[0](*args, **kwargs)

    def timed(fn):
        def wrapped(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            spans.append((s, e))
            return out
        return wrapped

    sb._propose = counted
    sfb._greedy_slices_b = timed(originals[1])
    sfb._lcc_fw_b = timed(originals[2])
    try:
        reset_launch_counts()
        moves0 = runner.moves_done
        t0 = time.perf_counter()
        run(betas[k:2 * k])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        sb._propose, sfb._greedy_slices_b, sfb._lcc_fw_b = originals
    moves = runner.moves_done - moves0
    reslice_ms = sum(s.elapsed_time(e) for s, e in spans)
    stats = dict(ms_per_sweep=1e3 * dt / k, steps_per_sweep=steps[0] / k,
                 moves_per_sweep=moves / k, moves_per_s=moves / dt)
    log(f'{what}: {k} sweeps in {1e3 * dt:.3f} ms '
        f"({stats['ms_per_sweep']:.3f} ms/sweep) on {card}; "
        f"{stats['steps_per_sweep']:.2f} walk steps and "
        f"{stats['moves_per_sweep']:.1f} moves per sweep; launches "
        f'{counts}')
    log(f"moves/s {what}: {stats['moves_per_s']:.6g} ({card})")
    if fw:
        stats['reslice_share'] = reslice_ms / (1e3 * dt)
        log(f'{what}: reslices {reslice_ms:.3f} ms ({len(spans) // 2} '
            f'reslices, {100 * stats["reslice_share"]:.1f}% of the '
            f'{k} sweeps)')
    if not all(counts[name] > 0 for name in BATCHED_KERNELS):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    if fw:
        worst = _audit_fw_runner(runner, 30, what)
    else:
        _, worst = _audit_im_runner(runner, what)
    log(f'{what}: {B} replicas audited; best log2 total '
        f'{runner.log2_min_totals().min():.4f}; |device - exact| <= '
        f'{worst:.2e}')
    n_prof = UPDATE_SLICES if fw else 4
    return counts, ctrees, dict(what=what, stats=stats, n_prof=n_prof,
                                run=lambda: run(betas[2 * k:2 * k + n_prof]))


def phase_batched_launches(torch, card, flagships):
    """Kernel launches per sweep and the kernels' busy share of each
    batched flagship, over a few more sweeps under ``torch.profiler``.
    Last of all phases: a profiler session leaves the host's later
    launches slower for the rest of the process
    (``scripts/profile_torch_batched.py`` measures it)."""
    for f in flagships:
        launches, busy, wall = _kernel_launches(torch, f['run'])
        stats = dict(f['stats'], launches_per_sweep=launches / f['n_prof'],
                     device_busy_share=busy / wall)
        log(f"{f['what']}: {stats['launches_per_sweep']:.1f} kernel "
            f"launches per sweep, kernels busy "
            f"{100 * stats['device_busy_share']:.1f}% of {wall:.3f} ms "
            f"over {f['n_prof']} profiled sweeps")
        log(json.dumps({'flagship': f['what'], 'card': card, **stats}))


def phase_batched_card_vs_cpu(torch, ctrees):
    """One batched sweep (IM, then FW with its reslice) on the card and
    on the CPU from one state and the same draws: integer and bit state
    bitwise, totals within 1e-5 in log2 (the float bound of exp2/log2)."""
    import numpy as np

    from tnco_tpu_torch.convert import batch_fw_to_numpy, batch_to_numpy
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels.sa_finite import SweepConfigFW
    from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim
    from tnco_tpu_torch.kernels.sa_infinite import SweepConfig
    from tnco_tpu_torch.ops import bitops

    t = ctrees[0]
    w = t.inds_array.shape[1]
    n_leaves = t.n_leaves
    ul = uniform_log2_dim(t.log2_dims_array)
    log2d = bitops.pad_log2_dims(t.log2_dims_array, w).numpy()
    log2d_w32 = torch.from_numpy(log2d.reshape(w, 32))
    seeds = list(range(len(ctrees)))
    gen = torch.Generator().manual_seed(5)
    dr_im = {k: v[None] for k, v in sb.draw_sweep(gen, n_leaves, B).items()}
    dr_fw = {k: v[None] for k, v in sfb.draw_sweep_fw(
        gen, n_leaves, B, 32 * w, True, False).items()}
    skip = torch.zeros(w, dtype=torch.int32)
    start = np.stack([c.nodes_array[:, 0] for c in ctrees], axis=1)
    outs = {'IM': [], 'FW': []}
    for dev in ('cpu', 'cuda'):
        t0 = time.perf_counter()
        b = sb.init_batch(ctrees, seeds, log2d, device=dev)
        got, m_im = sb.run_sweeps_batched(
            b, [20.0], log2d_w32.to(dev),
            SweepConfig(n_leaves=n_leaves, n_lanes=w), uniform_log2=ul,
            draws={k: v.to(dev) for k, v in dr_im.items()})
        outs['IM'].append((batch_to_numpy(got), int(m_im['moves'][0])))
        b = sfb.init_batch_fw(ctrees, seeds, 30.0, log2d, device=dev)
        got, m_fw = sfb.run_sweeps_fw_batched(
            b, [20.0], [True], 30.0, log2d_w32.to(dev), skip.to(dev),
            SweepConfigFW(n_leaves=n_leaves, n_lanes=w), uniform_log2=ul,
            draws={k: v.to(dev) for k, v in dr_fw.items()})
        outs['FW'].append((batch_fw_to_numpy(got), int(m_fw['moves'][0])))
        log(f'card vs CPU: one IM and one FW sweep on {dev} in '
            f'{time.perf_counter() - t0:.2f} s (set-up included)')
    for what, ((cpu, m_cpu), (card, m_card)) in outs.items():
        if m_cpu != m_card:
            fail(f'card vs CPU {what}: moves {m_card} != {m_cpu}')
        worst = 0.0
        for k, v in cpu.items():
            if k in ('log2_total', 'min_log2_total'):
                worst = max(worst, float(np.abs(card[k] - v).max()))
            elif not np.array_equal(card[k], v):
                fail(f'card vs CPU {what}: {k} differs in '
                     f'{int((card[k] != v).sum())} entries')
        if worst > 1e-5:
            fail(f'card vs CPU {what}: totals differ by {worst}')
        changed = int((cpu['c0'] != start).sum())
        if not changed:
            fail(f'card vs CPU {what}: the sweep applied no move')
        log(f'card vs CPU {what}: B={B}, N={len(t)}, W={w}, {m_cpu} moves, '
            f'{changed} child entries changed: integer and bit state bitwise '
            f'equal, totals within {worst:.2e}')


# The round-5 FW operating points on the full Sycamore network at B=64:
# the product point (P=128, reslice every 2 iterations, exchange every
# EXCHANGE_EVERY chunks over ISLANDS islands, the periodic kick: window 10
# chunks, delta 10 bits, cooldown 60 chunks) and the throughput point
# (P=320, slicer 'ref', reslice every 8).  Only the run length is cut: the
# product point's chunks are PRODUCT_K iterations (256 in
# benchmarks/quality.py), run until every island was kicked once (at least
# PRODUCT_MIN_CHUNKS chunks, at most PRODUCT_MAX_CHUNKS, the beta ramp
# 0..60 spread over the most); the throughput point runs
# THROUGHPUT_ITERS timed iterations; the ladder TEMPER_CHUNKS chunks of
# TEMPER_K iterations.
PRODUCT_K, PRODUCT_MIN_CHUNKS, PRODUCT_MAX_CHUNKS = 2, 12, 48
EXCHANGE_EVERY, ISLANDS = 4, 4
P_THROUGHPUT, THROUGHPUT_US, THROUGHPUT_ITERS = 320, 8, 16
TEMPER_CHUNKS, TEMPER_K = 8, 2


def _fw_runner(torch, ctrees, what, **kw):
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW

    t0 = time.perf_counter()
    runner = ReplicaRunnerFW(ctrees, list(range(B)), engine='walks',
                             cmodel=SimpleCostModel(max_width=30), **kw)
    log(f'{what}: N={len(ctrees[0])} W={ctrees[0].inds_array.shape[1]} '
        f'B={B} P={runner.n_walks} engine={runner.engine!r} '
        f'slicer={runner.fw_slicer!r} set-up '
        f'{time.perf_counter() - t0:.1f} s')
    return runner


def _synced_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _check_mins(runner, before, what):
    after = runner.log2_min_totals()
    if (after > before).any():
        fail(f'{what} raised a min total: {before} -> {after}')


def _audit_kicked(runner, lanes, what):
    """Each kicked lane's written total is the exact cost of its current
    (tree, slices) within 1e-3 in log2, widths within the cap."""
    lt = runner.states.log2_total.cpu().numpy()
    worst = 0.0
    for v in lanes:
        tree = runner.ctree(v)
        ok, msg = tree.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: lane {v}: invalid tree: {msg}')
        width, exact = _exact_sliced(tree, runner.slices_lanes(v))
        if width > 30 + 1e-9:
            fail(f'{what}: lane {v}: width {width} over the cap')
        worst = max(worst, abs(exact - float(lt[v])))
    if worst > 1e-3:
        fail(f'{what}: written totals differ from the exact cost by {worst}')
    return worst


def phase_product_point(torch, card, ctrees):
    """The FW product point driven chunk by chunk as ``parallel/stall.py``
    and ``benchmarks/quality.py`` drive it: a chunk, the kicker's
    observation, and every EXCHANGE_EVERY chunks ``exchange_best_fw`` over
    the islands the kicker leaves active; then one kick with the host
    slicer.  Returns ``(launch counts, runner)``."""
    import numpy as np

    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.parallel import replicas, stall

    what = 'product point'
    runner = _fw_runner(torch, ctrees, what, n_walks=P)
    kicker = stall.IslandStallKicker(runner, islands=ISLANDS,
                                     window_chunks=10, min_delta=10,
                                     cooldown_chunks=60)
    betas = np.linspace(0.0, 60.0, PRODUCT_MAX_CHUNKS * PRODUCT_K)
    runner.run(betas[:PRODUCT_K], update_slices=2)           # warm-up
    torch.cuda.synchronize()
    kicks, chunk_ms, exchange_ms = [], [], []
    kick = stall.kick_lanes_fw

    def timed_kick(r, lanes, src, seed, **kw):
        before = r.log2_min_totals()
        k1 = launch_counts()['gather_gbn']
        ms = _synced_ms(torch, lambda: kick(r, lanes, src, seed, **kw))
        kicks.append(dict(ms=ms, lanes=sorted(int(x) for x in lanes),
                          k1=launch_counts()['gather_gbn'] - k1))
        _check_mins(r, before, f'{what}: a kick')
        kicks[-1]['err'] = _audit_kicked(r, kicks[-1]['lanes'], what)

    moves0, applied0 = runner.moves_done, runner.applied_done
    stall.kick_lanes_fw = timed_kick
    try:
        reset_launch_counts()
        chunk = 0
        while chunk < PRODUCT_MAX_CHUNKS:
            lo = chunk * PRODUCT_K
            chunk += 1
            chunk_ms.append(_synced_ms(torch, lambda: runner.run(
                betas[lo:lo + PRODUCT_K], update_slices=2)))
            kicker.observe(chunk, (chunk - 1) / PRODUCT_MAX_CHUNKS)
            if chunk % EXCHANGE_EVERY == 0:
                before = runner.log2_min_totals()
                active = kicker.exchange_active(chunk)

                def exchange():
                    runner.states = replicas.exchange_best_fw(
                        runner.states, islands=ISLANDS, active=active)
                exchange_ms.append(_synced_ms(torch, exchange))
                _check_mins(runner, before, f'{what}: an exchange')
            kicked = {k['island'] for k in kicker.kicks}
            if chunk >= PRODUCT_MIN_CHUNKS and len(kicked) == ISLANDS:
                break
        counts = launch_counts()
    finally:
        stall.kick_lanes_fw = kick
    moves = runner.moves_done - moves0
    applied = runner.applied_done - applied0
    if len({k['island'] for k in kicker.kicks}) != ISLANDS:
        fail(f'{what}: islands kicked {kicker.kicks} in {chunk} chunks, '
             f'not all {ISLANDS}')
    if not all(counts[k] > 0 for k in FW_KERNELS):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    k1_kicks = sum(k['k1'] for k in kicks)
    if not all(k['k1'] > 0 for k in kicks):
        fail(f'{what}: a device kick launched no K1: {kicks}')

    # One kick with the host slicer: island 0's lanes but its two leaders
    # from its best, as the kicker picks them.
    lt = runner.states.log2_total.cpu().numpy()
    bg = B // ISLANDS
    order = np.argsort(lt[:bg], kind='stable')
    lanes, src = [int(x) for x in order[2:]], int(order[0])
    before = runner.log2_min_totals()
    host_ms = _synced_ms(torch, lambda: replicas.kick_lanes_fw(
        runner, lanes, src, seed=12345, slicer='host'))
    _check_mins(runner, before, f'{what}: the host kick')
    host_err = _audit_kicked(runner, lanes, what)
    worst = _audit_fw_runner(runner, 30, what)

    anneal_s = sum(chunk_ms) / 1e3
    dev_ms = [k['ms'] for k in kicks]
    stats = dict(
        card=card, chunks=chunk, iterations_per_chunk=PRODUCT_K,
        ms_per_chunk=float(np.median(chunk_ms)),
        ms_per_chunk_min_max=[min(chunk_ms), max(chunk_ms)],
        exchanges=len(exchange_ms),
        ms_per_exchange=float(np.median(exchange_ms)),
        kicks_device=len(kicks), victims_per_kick=len(kicks[0]['lanes']),
        ms_per_kick_device=float(np.median(dev_ms)),
        ms_per_kick_device_min_max=[min(dev_ms), max(dev_ms)],
        ms_per_kick_host=host_ms, k1_launches_in_kicks=k1_kicks,
        kicks=[dict(k, ms=m) for k, m in zip(kicker.kicks, dev_ms)],
        proposals_per_s=moves / anneal_s, applied_per_s=applied / anneal_s,
        best_log2_total=float(runner.log2_min_totals().min()))
    log(f'{what}: {chunk} chunks of {PRODUCT_K} iterations, '
        f"{stats['ms_per_chunk']:.3f} ms/chunk (median; "
        f'{min(chunk_ms):.3f}-{max(chunk_ms):.3f}) on {card}; launches '
        f'{counts}')
    log(f"{what}: {len(exchange_ms)} exchanges, "
        f"{stats['ms_per_exchange']:.3f} ms each (median); {len(kicks)} "
        f"device kicks of {stats['victims_per_kick']} lanes, "
        f"{stats['ms_per_kick_device']:.3f} ms each (median; "
        f'{min(dev_ms):.3f}-{max(dev_ms):.3f}), K1 launches inside the '
        f"kicks {k1_kicks}; one host kick of {len(lanes)} lanes "
        f'{host_ms:.3f} ms')
    log(f"proposals/s {what}: {stats['proposals_per_s']:.6g} ({card})")
    log(f"applied/s {what}: {stats['applied_per_s']:.6g} ({card})")
    log(f'{what}: kicks {kicker.kicks}; kicked totals within '
        f"{max(host_err, *(k['err'] for k in kicks)):.2e} of the exact "
        f'cost; {B} replicas audited; best log2 total '
        f"{stats['best_log2_total']:.4f}; |device - exact| <= {worst:.2e}")
    log(json.dumps({'phase': what, **stats}))
    return counts, runner


def _check_rows_at(torch, p):
    """K1 and K3 against their plain versions at the throughput point's
    shapes (P=p, no union planes): the index gather at Q=5p and the merged
    apply at Q=2p over the W+4 planes below par.  Returns the routes."""
    from tnco_tpu_torch.kernels import gather as kg
    from tnco_tpu_torch.kernels import scatter as ks

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    f = W + 5
    vals = torch.randint(-2**31, 2**31 - 1, (f, B, N_PAD), generator=gen,
                         device=dev, dtype=torch.int32)
    ids = _rand_ids(torch, gen, B, 5 * p, 3241, frac_high=0.0)
    if _max_abs_err(torch, kg.gather_gbn(vals, ids, planes=(0, W)),
                    kg.gather_plain(vals, ids, (0, W))) != 0:
        fail(f'gather_gbn != plain at P={p}')
    ids = _unique_ids(torch, gen, B, 2 * p, 3241)
    upd = torch.randint(-2**31, 2**31 - 1, (f - 1, B, 2 * p), generator=gen,
                        device=dev, dtype=torch.int32)
    v1, v2 = vals.clone(), vals.clone()
    ks.scatter_rows_inplace(v1, ids, upd, planes=(0, f - 1))
    ks.scatter_rows_inplace_plain(v2, ids, upd, (0, f - 1))
    if _max_abs_err(torch, v1, v2) != 0:
        fail(f'scatter_rows_inplace != plain at P={p}')
    return dict(gather_gbn=kg.gather_route(N_PAD, 5 * p),
                scatter_rows_inplace=ks.scatter_route(N_PAD, 2 * p))


def phase_throughput_point(torch, card, ctrees):
    """The FW throughput point: ``fw_slicer='ref'`` (no union planes; the
    reslice unpacks the state), P=320, reslice every 8; a warm-up, then
    THROUGHPUT_ITERS timed iterations, audited."""
    import numpy as np

    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts

    what = 'throughput point'
    routes = _check_rows_at(torch, P_THROUGHPUT)
    log(f'{what}: K1 and K3 == plain bitwise at P={P_THROUGHPUT} (routes '
        f'{routes})')
    runner = _fw_runner(torch, ctrees, what, n_walks=P_THROUGHPUT,
                        fw_slicer='ref')
    betas = np.linspace(0.0, 60.0, THROUGHPUT_US + THROUGHPUT_ITERS)
    runner.run(betas[:THROUGHPUT_US], update_slices=THROUGHPUT_US)
    torch.cuda.synchronize()
    moves0, applied0 = runner.moves_done, runner.applied_done
    reset_launch_counts()
    ms = _synced_ms(torch, lambda: runner.run(
        betas[THROUGHPUT_US:], update_slices=THROUGHPUT_US))
    counts = launch_counts()
    if not all(counts[k] > 0 for k in FW_KERNELS):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    moves = runner.moves_done - moves0
    applied = runner.applied_done - applied0
    worst = _audit_fw_runner(runner, 30, what)
    stats = dict(card=card, iterations=THROUGHPUT_ITERS,
                 ms_per_iteration=ms / THROUGHPUT_ITERS,
                 proposals_per_s=moves / (ms / 1e3),
                 applied_per_s=applied / (ms / 1e3), routes=routes,
                 best_log2_total=float(runner.log2_min_totals().min()))
    log(f'{what}: {THROUGHPUT_ITERS} iterations in {ms:.3f} ms '
        f"({stats['ms_per_iteration']:.2f} ms/iteration) on {card}; "
        f'launches {counts}')
    log(f"proposals/s {what}: {stats['proposals_per_s']:.6g} ({card})")
    log(f"applied/s {what}: {stats['applied_per_s']:.6g} ({card})")
    log(f'{what}: {B} replicas audited; best log2 total '
        f"{stats['best_log2_total']:.4f}; |device - exact| <= {worst:.2e}")
    log(json.dumps({'phase': what, **stats}))
    return counts


def phase_tempering(torch, card, runner):
    """Walks-FW chunks of the product point's runner (B=64, P=128, its
    state as phase 15 left it) on a ``TemperingLadder(64, beta_max=60)``,
    swapping on the current totals between chunks: the swap rate,
    audited."""
    import numpy as np

    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.parallel.tempering import TemperingLadder

    what = 'tempering'
    ladder = TemperingLadder(B, beta_max=60.0)
    chunk_ms, accepted = [], []
    reset_launch_counts()
    for _ in range(TEMPER_CHUNKS):
        chunk_ms.append(_synced_ms(torch, lambda: runner.run(
            ladder.betas_for(TEMPER_K), update_slices=2)))
        accepted.append(ladder.swap(runner.states.log2_total.cpu().numpy()))
    counts = launch_counts()
    if not all(counts[k] > 0 for k in FW_KERNELS):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    if sorted(ladder.lane_betas()) != sorted(ladder.ladder):
        fail(f'{what}: the lane betas are no longer the ladder')
    worst = _audit_fw_runner(runner, 30, what)
    stats = dict(card=card, chunks=TEMPER_CHUNKS,
                 iterations_per_chunk=TEMPER_K,
                 ms_per_chunk=float(np.median(chunk_ms)),
                 swaps_proposed=ladder.swaps_proposed,
                 swaps_accepted=ladder.swaps_accepted,
                 swap_rate=ladder.swap_rate,
                 best_log2_total=float(runner.log2_min_totals().min()))
    log(f'{what}: {TEMPER_CHUNKS} chunks of {TEMPER_K} iterations, '
        f"{stats['ms_per_chunk']:.3f} ms/chunk (median) on {card}; swaps "
        f'accepted per chunk {accepted}, swap rate {ladder.swap_rate:.4f} '
        f'({ladder.swaps_accepted}/{ladder.swaps_proposed}); launches '
        f'{counts}')
    log(f'{what}: {B} replicas audited; best log2 total '
        f"{stats['best_log2_total']:.4f}; |device - exact| <= {worst:.2e}")
    log(json.dumps({'phase': what, **stats}))
    return counts


def _runner_on(torch, runner, dev):
    """A copy of ``runner`` with its state and tables on ``dev``."""
    import copy

    out = copy.copy(runner)
    s = runner.states
    out.states = type(s)(**{k: getattr(s, k).to(dev)
                            for k in s.field_names()})
    for name in ('_mw_pos', 'log2d', 'log2d_w32', 'max_width',
                 'skip_lanes'):
        setattr(out, name, getattr(runner, name).to(dev))
    out.device = torch.device(dev)
    return out


def phase_exchange_kick_card_vs_cpu(torch, runner):
    """One exchange (ISLANDS islands, island 1 gated) and one device-
    slicer kick (island 1's lanes but its two leaders, jitter drawn once on
    the host) from the product point's state, on the card and on the CPU:
    integer and bit state bitwise, totals within 1e-5."""
    import numpy as np

    from tnco_tpu_torch.convert import batch_fw_to_numpy
    from tnco_tpu_torch.parallel import replicas

    t0 = time.perf_counter()
    card = _runner_on(torch, runner, 'cuda')
    cpu = _runner_on(torch, runner, 'cpu')
    start = batch_fw_to_numpy(cpu.states)
    active = np.array([True, False, True, True])
    bg = B // ISLANDS

    def compare(what):
        want, got = (batch_fw_to_numpy(r.states) for r in (cpu, card))
        worst = 0.0
        for k, v in want.items():
            if k in ('log2_total', 'min_log2_total'):
                worst = max(worst, float(np.abs(got[k] - v).max()))
            elif not np.array_equal(got[k], v):
                fail(f'card vs CPU {what}: {k} differs in '
                     f'{int((got[k] != v).sum())} entries')
        if worst > 1e-5 or not torch.equal(card._mw_pos.cpu(), cpu._mw_pos):
            fail(f'card vs CPU {what}: totals differ by {worst} or walk '
                 'positions differ')
        return want, worst

    for r in (cpu, card):
        r.states = replicas.exchange_best_fw(r.states, islands=ISLANDS,
                                             active=active)
    after, worst_x = compare('exchange')
    moved = np.flatnonzero((after['c0'] != start['c0']).any(axis=0))
    if not moved.size or (moved // bg == 1).any():
        fail(f'card vs CPU exchange: lanes moved {moved.tolist()}')
    lt = after['log2_total']
    order = bg + np.argsort(lt[bg:2 * bg], kind='stable')
    lanes, src = [int(x) for x in order[2:]], int(order[0])
    jitter = torch.rand((runner.log2d_w32.numel(), len(lanes)),
                        generator=torch.Generator().manual_seed(9))
    for r in (cpu, card):
        replicas.kick_lanes_fw(r, lanes, src, seed=77, jitter=jitter)
    kicked, worst_k = compare('kick')
    if np.array_equal(kicked['slices'][:, lanes], after['slices'][:, lanes]):
        fail('card vs CPU kick: no victim took a new slice set')
    log(f'card vs CPU exchange and kick: B={B}, islands {ISLANDS} (island 1 '
        f'gated), {moved.size} lanes exchanged, {len(lanes)} lanes kicked '
        f'from lane {src}: integer and bit state bitwise equal, totals '
        f'within {max(worst_x, worst_k):.2e} '
        f'({time.perf_counter() - t0:.2f} s)')


# The circuit front door (phases 19-21): Sycamore-53 m=20 as an fSim gate
# list and as QASM text (cz), QAOA-26 p=4 at fuse=3 (benchmarks/run.py's
# set-up); the sampler's checks on QAOA in its CX form.
CIRCUIT_M, QAOA_N, QAOA_P = 20, 26, 4
# Optimizer options of the sampler's prefix networks, for the checks
# (whose amplitudes do not depend on the path's quality) and the timed
# run: the CLI's `sample` defaults but 8 sweeps (cut from its 50 for the
# whole script's time).
SAMPLER_OPT = dict(betas=(0, 50), n_steps=8, n_runs=1)
# Phase 21's timed run on QAOA-26: depth cut from QAOA_P to fit the
# phase's budget, and the samples it times one by one.
SAMPLER_P, SAMPLER_SAMPLES = 1, 10


def _hyper_count(tn):
    """Indices of ``tn`` shared by more than two tensors."""
    from tnco_tpu_torch.utils.tn import get_hyper_count
    return sum(c > 1 for c in get_hyper_count(tn.ts_inds).values())


def _check_recorded(torch, seen, what, widen=None):
    """K1 and K3 against their plain versions, bitwise, by every route,
    at each distinct shape ``seen`` recorded on the main path
    (``kernel_cases.recorded_cases``), on fresh inputs; with ``widen``,
    each shape of fewer replicas also at ``widen`` replicas (the shapes
    of an app's APP_RUNS replicas at the flagships' B)."""
    from tnco_tpu_torch.testing import kernel_cases as kc

    if not seen:
        fail(f'{what}: no K1 or K3 launch was recorded')
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    # A widened shape that was launched too, or that two smaller B widen
    # to, is checked once (shapes compared without their names).
    shapes = {(c._replace(name=''), dt) for c, dt in seen}
    wide = {}
    for c, dt in seen:
        if widen is not None and c.b < widen:
            key = (c._replace(b=widen, name=''), dt)
            if key not in shapes:
                wide.setdefault(key, (c._replace(
                    b=widen, name=f'{c.name} at B={widen}'), dt))
    wide = set(wide.values())
    for case, dtype in sorted(set(seen) | wide, key=repr):
        check = kc.check_gather if isinstance(case, kc.GatherCase) else \
            kc.check_scatter
        bad = check(case, dtype, dev)
        torch.cuda.synchronize()
        if bad:
            fail(f'{what}: {type(case).__name__} {case.name} ({dtype}) != '
                 f'plain by {bad}')
    n_k1 = sum(isinstance(c, kc.GatherCase) for c, _ in seen)
    ns = sorted({c.n for c, _ in seen})
    widened = (f'; {len(wide)} of them widened to B={widen} as well'
               if wide else '')
    log(f'{what}: K1 and K3 == plain bitwise at the {n_k1} K1 and '
        f'{len(seen) - n_k1} K3 shapes the path launched (N from {ns[0]} '
        f'to {ns[-1]}){widened}; {time.perf_counter() - t0:.2f} s')


def phase_circuits(torch):
    """Phase 19: Sycamore-53 m=20 (fSim gate list, QASM text) and
    QAOA-26 p=4 through ``load_tn`` and ``Optimizer`` on the card."""
    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases
    from tnco_tpu_torch.testing.networks import (qaoa_circuit,
                                                 sycamore_circuit,
                                                 sycamore_qasm)

    cases = (('circuit_fsim', f'Sycamore-53 m={CIRCUIT_M} fSim',
              sycamore_circuit(CIRCUIT_M, 0), {}, 30.0),
             ('circuit_qasm', f'Sycamore-53 m={CIRCUIT_M} QASM (cz)',
              sycamore_qasm(CIRCUIT_M, 0), {}, None),
             ('circuit_qaoa', f'QAOA-{QAOA_N} p={QAOA_P}',
              qaoa_circuit(QAOA_N, QAOA_P, 0),
              dict(fuse=3, simplify_circuit=False), 30.0))
    counts = {}
    for key, what, circuit, load_kw, max_width in cases:
        fw = max_width is not None
        t0 = time.perf_counter()
        loaded = load_tn(circuit, seed=0, **load_kw)
        load_s = time.perf_counter() - t0
        log(f'{what}: load_tn {load_s:.3f} s; {loaded.n_tensors} tensors, '
            f'{_hyper_count(loaded)} hyper-indices, N='
            f'{2 * loaded.n_tensors - 1} W={-(-loaded.n_inds // 32)}')
        runners, restore = (_record_runners(fw_sa, 'ReplicaRunnerFW') if fw
                            else _record_runners(im_sa, 'ReplicaRunner'))
        try:
            opt = (Optimizer(max_width=max_width, seed=0) if fw else
                   Optimizer(seed=0))
            with recorded_cases() as seen:
                reset_launch_counts()
                t0 = time.perf_counter()
                tn_out, res = opt.optimize(circuit, betas=(0, 60),
                                           n_steps=BATCHED_APP_STEPS,
                                           n_runs=APP_RUNS, **load_kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts[key] = launch_counts()
        finally:
            restore()
        (runner,) = runners
        log(f'{what}: optimize {APP_RUNS} runs x {BATCHED_APP_STEPS} sweeps '
            f'in {wall:.2f} s incl. load (runner set-up + anneal '
            f'{res[0].runtime_s:.2f} s); engine {runner.engine!r}; '
            f'launches {counts[key]}')
        if runner.engine != 'batched':
            fail(f"{what}: 'auto' picked {runner.engine!r}, not 'batched'")
        if not all(counts[key][k] > 0 for k in BATCHED_KERNELS):
            fail(f'{what}: a kernel of the path was never launched')
        _check_recorded(torch, seen, what, widen=B)
        if tn_out.ts_inds != loaded.ts_inds:
            fail(f'{what}: optimize loaded another network')
        if fw:
            for r in res:
                _audit_result(r, tn_out, max_width)
            worst = _audit_fw_runner(runner, max_width, what)
            log(f'{what}: {len(res)} results audited; best log2 cost '
                f'{math.log2(int(res[0].cost)):.4f}; |device - exact| <= '
                f'{worst:.2e}')
        else:
            _audit_im_results(res, tn_out, runner, what)
    return counts


def _tuples(x):
    """JSON lists back to the tuples they were."""
    return tuple(_tuples(y) for y in x) if isinstance(x, list) else x


def _run_cli(*args):
    """``python3 -m tnco_tpu_torch.app.cli *args`` from the repository
    root: ``(parsed JSON of its output, wall seconds)``; fails unless it
    exits 0."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'tnco_tpu_torch.app.cli',
                           *args], cwd=root, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f'cli {args[0]} exited {proc.returncode}: '
             f'{proc.stderr[-2000:]}')
    return json.loads(proc.stdout), wall


def phase_cli(torch):
    """Phase 20: the CLI as a subprocess: ``optimize`` on the Sycamore
    QASM file (FW, max_width 30) with its best result audited, then the
    same command in this process to hold K1 and K3 at the shapes it
    launches, and ``sample`` on a 3-qubit GHZ circuit."""
    import contextlib
    import io
    import os
    from types import SimpleNamespace

    from tnco_tpu_torch.app import cli, load_tn
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases
    from tnco_tpu_torch.testing.networks import sycamore_qasm

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, 'build', 'smoke')
    os.makedirs(out_dir, exist_ok=True)
    qasm = os.path.join(out_dir, f'sycamore_m{CIRCUIT_M}.qasm')
    with open(qasm, 'w') as f:
        f.write(sycamore_qasm(CIRCUIT_M, 0))
    args = ('optimize', qasm, '--max-width', '30', '--betas', '(0, 60)',
            '--n-steps', '32', '--n-runs', str(APP_RUNS), '--seed', '0')
    out, wall = _run_cli(*args)
    tn = load_tn(qasm, seed=0)
    if out['tn'] != json.loads(tn.to_json()):
        fail('cli optimize: its network differs from load_tn of the file')
    best = out['res'][0]
    if len(out['res']) != APP_RUNS or \
            [Decimal(r['cost']) for r in out['res']] != sorted(
                Decimal(r['cost']) for r in out['res']):
        fail('cli optimize: results missing or not sorted by cost')
    _audit_result(SimpleNamespace(
        path=[tuple(p) for p in best['path']],
        slices=frozenset(_tuples(x) for x in best['slices']),
        cost=Decimal(best['cost']),
        disconnected_costs=[int(Decimal(best['cost']))]), tn, 30.0)
    log(f'cli optimize (Sycamore m={CIRCUIT_M} QASM, max_width 30, '
        f'{APP_RUNS} runs '
        f'x 32 sweeps): exit 0 in {wall:.2f} s wall incl. interpreter start '
        f'and kernel load; best log2 cost '
        f'{math.log2(int(Decimal(best["cost"]))):.4f}, '
        f'{len(best["slices"])} slices, audited')
    with recorded_cases() as seen, \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(list(args))
        torch.cuda.synchronize()
    if rc != 0:
        fail(f'cli optimize in process exited {rc}')
    _check_recorded(torch, seen, 'cli optimize', widen=B)
    ghz = os.path.join(out_dir, 'ghz3.qasm')
    with open(ghz, 'w') as f:
        f.write('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[3];\n'
                'h q[0];\ncx q[0],q[1];\ncx q[1],q[2];\n')
    out, wall = _run_cli('sample', ghz, '--n-samples', '40', '--seed', '0')
    if not set(out['hits']) <= {'000', '111'} or \
            abs(sum(out['hits'].values()) - 1) > 1e-9:
        fail(f'cli sample GHZ: hits {out["hits"]}')
    log(f'cli sample (GHZ-3, 40 samples): exit 0 in {wall:.2f} s; hits '
        f'{out["hits"]}')


def _widest(tree):
    """The largest log2 width of a node of ``tree``."""
    import numpy as np

    n = len(tree.inds_order)
    bits = np.unpackbits(tree.inds_array.view(np.uint8), axis=1,
                         bitorder='little')[:, :n].astype(bool)
    return float((bits @ tree.log2_dims_array).max())


def phase_sampler(torch):
    """Phase 21: the BGL ``Sampler`` on the card: visited probabilities
    against a statevector (QAOA-10, p=2), sampled frequencies against it
    (QAOA-4, p=2, 1000 samples), the sliced amplitudes against the
    unsliced ones, and a timed run on QAOA-26 at depth SAMPLER_P; then K1
    and K3 at every shape the phase launched them."""
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    with recorded_cases() as seen:
        counts = _sampler_runs(torch)
    _check_recorded(torch, seen, 'sampler')
    return counts


def _sampler_runs(torch):
    """The runs of phase 21; returns the timed run's launch counts."""
    import statistics

    from tnco_tpu_torch.app.circuit import Sampler
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing import sampling as ts
    from tnco_tpu_torch.testing.networks import qaoa_sampling_circuit

    def state_of(sampler, gates):
        t0 = time.perf_counter()
        state = sampler.sample(gates, return_intermediate_state_only=True,
                               **SAMPLER_OPT)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    def n_prefix(state):
        return sum(e[0] is not None for e in state)

    # Visited probabilities: QAOA-10, p=2.
    gates = qaoa_sampling_circuit(10, 2, 0)
    order = tuple(range(10))
    state, secs = state_of(Sampler(seed=0), gates)
    with ts.recorded_amplitudes(state) as unsliced:
        Sampler(seed=0).sample(state, n_samples=20, qubit_order=order)
    err = ts.visited_probability_error(unsliced, gates, order)
    log(f'sampler QAOA-10 p=2: state of {n_prefix(state)} prefix networks '
        f'in {secs:.2f} s; {len(unsliced)} visited probabilities within '
        f'{err:.2e} of the statevector')
    if err > 1e-10:
        fail(f'sampler: visited probabilities differ by {err}')

    # Sliced against unsliced, same circuit and sampler seed: a cap two
    # under the widest unsliced contraction, one lower at a time (at most
    # two more) while it forces no slice.  The prefix networks, and so
    # the paths and their widths, follow the process's hash seed (ROADMAP
    # queue 3): on the card one whole run found paths within the cap.
    widest = max(_widest(ContractionTree(e[1].path, e[0].ts_inds, e[0].dims,
                                         output_inds=()))
                 for e in state if e[0] is not None)
    for cap in (widest - 2, widest - 3, widest - 4):
        sliced_state, secs = state_of(Sampler(seed=0, max_width=cap), gates)
        n_sliced = sum(bool(e[1].slices) for e in sliced_state
                       if e[0] is not None)
        if n_sliced:
            break
        log(f'sampler: max_width {cap} forced no slice; one lower')
    if not n_sliced:
        fail(f'sampler: max_width {cap} forced no slice')
    with ts.recorded_amplitudes(sliced_state) as sliced:
        Sampler(seed=0, max_width=cap).sample(sliced_state, n_samples=2,
                                              qubit_order=order)
    if [r[:2] for r in sliced] != [r[:2] for r in unsliced[:len(sliced)]]:
        fail('sampler: the sliced run visited other bitstrings')
    rel = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-300)
              for a, b in zip(sliced, unsliced))
    log(f'sampler QAOA-10 p=2, max_width {cap:g} (widest unsliced '
        f'{widest:g}): {n_sliced} sliced prefix networks, state in '
        f'{secs:.2f} s; {len(sliced)} amplitudes within {rel:.2e} relative '
        'of the unsliced ones')
    if rel > 1e-10:
        fail(f'sampler: sliced amplitudes differ by {rel} relative')

    # Distribution: QAOA-4, p=2, 1000 samples.
    gates = qaoa_sampling_circuit(4, 2, 0)
    order = tuple(range(4))
    sampler = Sampler(seed=1)
    state, _ = state_of(sampler, gates)
    t0 = time.perf_counter()
    hits, _ = sampler.sample(state, n_samples=1000, qubit_order=order,
                             normalize=False)
    tv = ts.tv_distance(hits, order, gates)
    log(f'sampler QAOA-4 p=2: 1000 samples in '
        f'{time.perf_counter() - t0:.2f} s, total variation {tv:.4f} from '
        'the statevector (bound 0.15, about 0.05 expected)')
    if tv > 0.15:
        fail(f'sampler: total variation {tv}')

    # Timed: QAOA-26 at depth SAMPLER_P.
    gates = qaoa_sampling_circuit(QAOA_N, SAMPLER_P, 0)
    sampler = Sampler(seed=2)
    reset_launch_counts()
    state, secs = state_of(sampler, gates)
    counts = launch_counts()
    # One sample a call, each timed: the spread of the per-sample time.
    secs_each, n_hits = [], 0
    for _ in range(SAMPLER_SAMPLES):
        t0 = time.perf_counter()
        hits, _ = sampler.sample(state, n_samples=1, normalize=False)
        secs_each.append(time.perf_counter() - t0)
        n_hits += sum(hits.values())
    log(f'sampler QAOA-{QAOA_N} p={SAMPLER_P} (cut from p={QAOA_P}): '
        f'{len(gates)} gates, state of {n_prefix(state)} prefix networks '
        f'optimized on the card in {secs:.2f} s '
        f'({secs / n_prefix(state):.3f} s each); s per sample over '
        f'{SAMPLER_SAMPLES} samples (host numpy contractions): median '
        f'{statistics.median(secs_each):.3f}, min {min(secs_each):.3f}, '
        f'max {max(secs_each):.3f}, mean '
        f'{sum(secs_each) / SAMPLER_SAMPLES:.3f}; launches {counts}')
    if not all(counts[k] > 0 for k in BATCHED_KERNELS):
        fail('sampler: a kernel of the path was never launched')
    if n_hits != SAMPLER_SAMPLES:
        fail(f'sampler: {n_hits} hits in {SAMPLER_SAMPLES} samples')
    return counts


# Phase 22: sparse networks.  Sycamore-53 m=20 (fSim) and QAOA-26 p=4
# with open outputs, uncut (fuse=0; sparse networks are never fused), the
# outputs marked sparse: n_projs bitstrings of their amplitudes, about a
# million for Sycamore (the order of the Sycamore experiment's sample
# sets, Arute et al., Nature 574, 505, 2019), 1024 for QAOA.  The two
# Sycamore calls run SPARSE_APP_STEPS sweeps (cut from BATCHED_APP_STEPS
# for the phase's time; QAOA keeps it); the walks point runs
# SPARSE_WALKS_ITERS timed iterations after SPARSE_WALKS_WARM; the card
# is held against the CPU at SPARSE_CHECK_B replicas.
SPARSE_N_PROJS, SPARSE_QAOA_N_PROJS = 2 ** 20, 2 ** 10
SPARSE_APP_STEPS = 16
SPARSE_WALKS_WARM, SPARSE_WALKS_ITERS, SPARSE_US = 2, 4, 2
SPARSE_CHECK_B = 16


def _sparse_tn(circuit):
    """``circuit`` through ``load_tn`` with open outputs, unfused, the
    outputs marked sparse; returns ``(network, load seconds)``."""
    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.app.tn import TensorNetwork

    t0 = time.perf_counter()
    tn = load_tn(circuit, final_state=None, fuse=0,
                 decompose_hyper_inds=False)
    load_s = time.perf_counter() - t0
    return TensorNetwork(tn.tensors, output_inds=tn.output_inds,
                         sparse_inds=tn.output_inds, tags=tn.tags), load_s


def _sparse_cost(tree, cm, slices=frozenset()):
    """Exact bigint total of ``tree`` under the sparse cost model ``cm``
    (``contraction_cost`` summed over the tree's contractions: the dense
    dims' product times min(the sparse dims' product, n_projs) over
    ``in1 | in2 | slices``), from integer widths of the index words
    (``_int_widths``) where the dims allow it, else node by node."""
    import numpy as np

    width = _int_widths(tree)
    if width is None:
        inds, dims = list(tree.inds), tree.dims
        return sum(cm.contraction_cost(inds[n.children[0]],
                                       inds[n.children[1]], inds[p], dims,
                                       slices)
                   for p, n in enumerate(tree.nodes) if not n.is_leaf())
    order = set(tree.inds_order)
    sp = _label_lanes(tree, cm.sparse_inds & order)
    words, nodes = tree.inds_array, tree.nodes_array
    inner = nodes[nodes[:, 0] >= 0]
    union = words[inner[:, 0]] | words[inner[:, 1]] | _label_lanes(tree,
                                                                   slices)
    pairs, counts = np.unique(
        np.stack([width(union & ~sp), width(union & sp)], axis=1), axis=0,
        return_counts=True)
    return sum(int(c) * (1 << int(d)) * min(1 << int(e), cm.n_projs)
               for (d, e), c in zip(pairs, counts))


def _sparse_width(tree, cm, slices=frozenset()):
    """Largest width of ``tree`` after ``slices``, the sparse part capped
    at log2(n_projs) (``cm.width`` of every node, on the bit matrix)."""
    import numpy as np

    order = tree.inds_order
    bits = np.unpackbits(tree.inds_array.view(np.uint8), axis=1,
                         bitorder='little')[:, :len(order)].astype(bool)
    bits &= ~np.asarray([x in slices for x in order])
    sp = np.asarray([x in cm.sparse_inds for x in order])
    log2d = tree.log2_dims_array
    return float(((bits & ~sp) @ log2d + np.minimum(
        (bits & sp) @ log2d, math.log2(cm.n_projs))).max())


def _audit_sparse(res, tn, cm, runner, what):
    """Every result is a valid path of ``tn`` whose cost is the sparse
    exact bigint cost, its widths within the cap after its slices (finite
    width), and the results' log2 costs are the replicas' device min
    totals (within 1e-3)."""
    import numpy as np

    from tnco_tpu_torch.ctree import ContractionTree

    t0 = time.perf_counter()
    fw = math.isfinite(cm.max_width)
    costs = []
    for r in res:
        tree = ContractionTree(r.path, tn.ts_inds, tn.dims,
                               output_inds=tn.output_inds)
        ok, msg = tree.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: invalid path: {msg}')
        slices = r.slices if fw else frozenset()
        total = _sparse_cost(tree, cm, slices)
        if r.cost != Decimal(0) + Decimal(total):
            fail(f'{what}: cost {r.cost} != sparse exact recompute {total}')
        if fw and _sparse_width(tree, cm, slices) > cm.max_width + 1e-9:
            fail(f'{what}: width over the cap after slicing')
        costs.append(math.log2(total))
    gap = float(np.abs(np.sort(costs) -
                       np.sort(runner.log2_min_totals())).max())
    if gap > 1e-3:
        fail(f'{what}: result costs differ from the device min totals by '
             f'{gap}')
    log(f'{what}: {len(res)} results audited by the sparse exact cost in '
        f'{time.perf_counter() - t0:.1f} s; log2 cost best {min(costs):.4f}'
        f' median {float(np.median(costs)):.4f}; |device - exact| <= '
        f'{gap:.2e}')
    return min(costs)


def _audit_sparse_runner(runner, cm, what):
    """Every replica's best tree is valid, fits the cap after its min
    slices (sparse part capped), and its sparse exact bigint total is
    within 1e-3 in log2 of the device min total."""
    from tnco_tpu_torch.bitset import Bitset

    order = runner.template.inds_order
    mins = runner.log2_min_totals()
    worst = 0.0
    for r in range(runner.n_replicas):
        tree = runner.min_ctree(r)
        ok, msg = tree.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: replica {r}: invalid min tree: {msg}')
        slices = frozenset(order[p] for p in Bitset.from_lanes(
            runner.min_slices_lanes(r), len(order)).positions())
        if _sparse_width(tree, cm, slices) > cm.max_width + 1e-9:
            fail(f'{what}: replica {r}: width over the cap after slicing')
        worst = max(worst, abs(math.log2(_sparse_cost(tree, cm, slices)) -
                               float(mins[r])))
    if worst > 1e-3:
        fail(f'{what}: device min totals differ from the sparse exact '
             f'recompute by {worst}')
    return worst


def _states_on(torch, states, dev, b):
    """Replicas ``[:b]`` of a state (replica-major, or lane-major with
    ``keys`` replica-first) as a copy on ``dev``."""
    lane_major = hasattr(states, 'keys')

    def take(name, x):
        if not lane_major or name == 'keys':
            return x[:b].to(dev)
        return x[..., :b].to(dev)

    return type(states)(**{k: take(k, getattr(states, k))
                           for k in states.field_names()})


def _fields_cpu(states):
    return {k: getattr(states, k).cpu() for k in states.field_names()}


def _same_on_card(torch, runs, what, atol=1e-5):
    """``runs``: ``{'cpu': (state, metrics), 'cuda': ...}``: integer and
    bit state bitwise equal, totals within ``atol``; returns the worst
    total difference."""
    (cpu, m_cpu), (card, m_card) = runs['cpu'], runs['cuda']
    a, b = _fields_cpu(cpu), _fields_cpu(card)
    worst = 0.0
    for k, v in a.items():
        if k in ('log2_total', 'min_log2_total'):
            worst = max(worst, float((b[k] - v).abs().max()))
        elif not torch.equal(b[k], v):
            fail(f'card vs CPU {what}: {k} differs in '
                 f'{int((b[k] != v).sum())} entries')
    for k in ('moves', 'applied', 'pos'):
        if k in m_cpu and not torch.equal(
                torch.as_tensor(m_card[k]).cpu(),
                torch.as_tensor(m_cpu[k]).cpu()):
            fail(f'card vs CPU {what}: {k} differs')
    if worst > atol:
        fail(f'card vs CPU {what}: totals differ by {worst}')
    return worst


def _sparse_card_vs_cpu(torch, im_runner, fw_runner, walks):
    """Phase 22d: one 'vmapped' IM sweep, one 'vmapped' FW sweep with a
    reslice and one sparse walks-FW iteration with a reslice, each from
    one state (the first SPARSE_CHECK_B replicas of the phase's runners)
    with the same draws on the card and on the CPU."""
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite as saf
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels import sa_infinite as sa
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import sa_walks as swk

    b = SPARSE_CHECK_B
    n_leaves = im_runner.cfg.n_leaves
    n_bits = im_runner.log2d.numel()
    gen = torch.Generator().manual_seed(22)
    dr_im = {k: v[None] for k, v in sb.draw_sweep(gen, n_leaves, b).items()}
    dr_fw = {k: v[None] for k, v in sfb.draw_sweep_fw(
        gen, n_leaves, b, n_bits, True, False).items()}
    dr_wk = {k: v[None] for k, v in smw.draw_walks(
        gen, n_leaves, b, walks.n_walks, n_bits).items()}
    runs = {'IM sweep': {}, 'FW sweep': {}, 'walks iteration': {}}
    t0 = time.perf_counter()
    for dev in ('cpu', 'cuda'):
        def on(x):
            return None if x is None else x.to(dev)

        def draws(d):
            return {k: v.to(dev) for k, v in d.items()}

        r = im_runner
        runs['IM sweep'][dev] = sa.run_sweeps_batch(
            _states_on(torch, r.states, dev, b), [20.0], on(r.log2d), r.cfg,
            on(r.sparse_lanes), r.log2_n_projs, uniform_log2=r.uniform_log2,
            draws=draws(dr_im))
        r = fw_runner
        runs['FW sweep'][dev] = saf.run_sweeps_fw_batch(
            _states_on(torch, r.states, dev, b), [20.0], [True],
            on(r.max_width), on(r.log2d), on(r.skip_lanes), r.cfg,
            on(r.sparse_lanes), r.log2_n_projs, uniform_log2=r.uniform_log2,
            draws=draws(dr_fw))
        r = walks
        runs['walks iteration'][dev] = swk.run_walks_fw(
            _states_on(torch, r.states, dev, b), [20.0], [True],
            on(r.max_width), on(r.log2d_w32), on(r.skip_lanes), r.cfg,
            r._mw_pos[:, :b].to(dev), on(r.sparse_wb), r.log2_n_projs,
            uniform_log2=r.uniform_log2, slicer=r.fw_slicer,
            draws=draws(dr_wk), device=dev)
        torch.cuda.synchronize()
    worst = max(_same_on_card(torch, v, f'sparse {k}')
                for k, v in runs.items())
    moved = int((runs['IM sweep']['cpu'][0].nodes !=
                 _states_on(torch, im_runner.states, 'cpu', b).nodes).sum())
    if not moved:
        fail('sparse card vs CPU: the IM sweep applied no move')
    log(f'sparse card vs CPU: B={b}: one vmapped IM sweep ({moved} node '
        'entries changed), one vmapped FW sweep with a reslice and one '
        f'walks-FW iteration (P={walks.n_walks}, the reference slicer, '
        'reslice): integer and bit state bitwise '
        f'equal, totals within {worst:.2e} '
        f'({time.perf_counter() - t0:.2f} s)')


def phase_sparse(torch):
    """Phase 22: sparse networks through ``Optimizer`` ('auto' ->
    'vmapped' on Sycamore, 'batched' on QAOA), the sparse walks point,
    the card against the CPU, and K1 and K3 at every shape launched."""
    import numpy as np

    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunnerFW
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases
    from tnco_tpu_torch.testing.networks import (qaoa_circuit,
                                                 sycamore_circuit)

    syc, syc_s = _sparse_tn(sycamore_circuit(CIRCUIT_M, 0))
    qaoa, qaoa_s = _sparse_tn(qaoa_circuit(QAOA_N, QAOA_P, 0))
    counts, runners, seen_all = {}, {}, set()
    cases = (('sparse_im', f'sparse Sycamore-53 m={CIRCUIT_M} IM', syc,
              syc_s, None, SPARSE_N_PROJS, SPARSE_APP_STEPS, 'vmapped'),
             ('sparse_fw', f'sparse Sycamore-53 m={CIRCUIT_M} FW', syc,
              syc_s, 30.0, SPARSE_N_PROJS, SPARSE_APP_STEPS, 'vmapped'),
             ('sparse_qaoa', f'sparse QAOA-{QAOA_N} p={QAOA_P} FW', qaoa,
              qaoa_s, 30.0, SPARSE_QAOA_N_PROJS, BATCHED_APP_STEPS,
              'batched'))
    for key, what, tn, load_s, max_width, n_projs, steps, engine in cases:
        fw = max_width is not None
        log(f'{what}: load_tn {load_s:.3f} s; {tn.n_tensors} tensors, '
            f'{len(tn.sparse_inds)} sparse outputs, n_projs={n_projs}, '
            f'N={2 * tn.n_tensors - 1} W={-(-tn.n_inds // 32)}')
        recorded, restore = (_record_runners(fw_sa, 'ReplicaRunnerFW') if fw
                             else _record_runners(im_sa, 'ReplicaRunner'))
        try:
            opt = (Optimizer(max_width=max_width, seed=0) if fw else
                   Optimizer(seed=0))
            with recorded_cases() as seen:
                reset_launch_counts()
                t0 = time.perf_counter()
                tn_out, res = opt.optimize(tn, betas=(0, 60), n_steps=steps,
                                           n_runs=APP_RUNS, n_projs=n_projs,
                                           fuse=False,
                                           decompose_hyper_inds=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts[key] = launch_counts()
            seen_all |= seen
        finally:
            restore()
        (runner,) = recorded
        runners[key] = runner
        log(f'{what}: optimize {APP_RUNS} runs x {steps} sweeps in '
        f'{wall:.2f} s '
            f'(runner set-up {runner.setup_s:.2f} s, anneal '
            f'{runner.run_s:.2f} s: {1e3 * runner.run_s / steps:.1f} ms a '
            f'sweep); engine {runner.engine!r}; launches {counts[key]}')
        if runner.engine != engine:
            fail(f"{what}: 'auto' picked {runner.engine!r}, not {engine!r}")
        if not all(counts[key][k] > 0 for k in BATCHED_KERNELS):
            fail(f'{what}: a kernel of the path was never launched')
        cm = SimpleCostModel(max_width=max_width if fw else float('inf'),
                             sparse_inds=tn.sparse_inds, n_projs=n_projs)
        _audit_sparse(res, tn_out, cm, runner, what)

    # The sparse walks point: the FW runner's best trees, each repeated to
    # B=64, P=128, reslice every SPARSE_US iterations ('auto' takes the
    # reference slicer for sparse indices).
    fw_app = runners['sparse_fw']
    cm = SimpleCostModel(max_width=30.0, sparse_inds=syc.sparse_inds,
                         n_projs=SPARSE_N_PROJS)
    t0 = time.perf_counter()
    best = [fw_app.min_ctree(r) for r in range(APP_RUNS)]
    walks = ReplicaRunnerFW([best[r % APP_RUNS] for r in range(B)],
                            list(range(B)), cmodel=cm, engine='walks',
                            n_walks=P)
    set_up = time.perf_counter() - t0
    betas = np.linspace(10, 60, SPARSE_WALKS_WARM + SPARSE_WALKS_ITERS,
                        dtype=np.float32)
    with recorded_cases() as seen:
        reset_launch_counts()
        walks.run(betas[:SPARSE_WALKS_WARM], update_slices=SPARSE_US,
                  chunk_size=SPARSE_WALKS_WARM)
        applied0 = walks.applied_done
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walks.run(betas[SPARSE_WALKS_WARM:], update_slices=SPARSE_US,
                  chunk_size=SPARSE_WALKS_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts['sparse_walks'] = launch_counts()
    seen_all |= seen
    if not all(counts['sparse_walks'][k] > 0 for k in FW_KERNELS):
        fail('sparse walks: a kernel of the path was never launched')
    worst = _audit_sparse_runner(walks, cm, 'sparse walks')
    applied = walks.applied_done - applied0
    log(f'sparse walks: N={len(walks.template)} B={B} P={walks.n_walks} '
        f'engine {walks.engine!r}, reslice every {SPARSE_US} (the '
        f'reference slicer), set-up {set_up:.1f} s: '
        f'{1e3 * secs / SPARSE_WALKS_ITERS:.2f} ms per iteration over '
        f'{SPARSE_WALKS_ITERS}, {B * P * SPARSE_WALKS_ITERS / secs:.0f} '
        f'proposals/s, {applied / secs:.0f} applied/s; every replica '
        f'audited (|device - exact| <= {worst:.2e}); launches '
        f'{counts["sparse_walks"]}')
    _sparse_card_vs_cpu(torch, runners['sparse_im'], fw_app, walks)
    _check_recorded(torch, seen_all, 'sparse (phase 22)', widen=B)
    return counts


# Phase 23: the walk variants and float64 state on the full network.
PRODUCT_US = 2         # the product point's reslice cadence (phase 15)
VARIANT_WARM, VARIANT_ITERS = 1, 4
VARIANT_CHECK_B = 16
F64_AUDIT = 1e-6       # float64 device totals against the exact bigint
F64_CARD = 1e-12       # float64 totals, card against CPU
# Each variant of the walks engines: the runners' options, and the claim
# (which only run_walks(_fw) takes).
IM_VARIANTS = (('default', {}), ('restart', {'on_block': 'restart'}),
               ('dedup', {'on_block': 'dedup'}),
               ('chained', {'accept_rule': 'chained'}),
               ('greedy', {'prob_kind': 'greedy'}),
               ('base', {'prob_kind': 'base'}),
               ('mh_local', {'prob_kind': 'mh_local'}),
               ('pairwise', {'claim': 'pairwise'}))
FW_VARIANTS = (('default', {}), ('dedup', {'on_block': 'dedup'}),
               ('chained', {'accept_rule': 'chained'}),
               ('pairwise', {'claim': 'pairwise'}))


def _variant(torch, runner, kw):
    """A copy of ``runner`` on copies of its state and walk positions,
    with its own generator and the variant's options (``claim`` is kept
    for :func:`_run_variant`, which calls ``run_walks(_fw)`` itself)."""
    import copy
    import dataclasses

    v = copy.copy(runner)
    s = runner.states
    v.states = dataclasses.replace(s, **{k: getattr(s, k).clone()
                                         for k in s.field_names()})
    v._mw_pos = runner._mw_pos.clone()
    v.generator = torch.Generator(device=runner.device).manual_seed(23)
    v.on_block = kw.get('on_block', runner.on_block)
    v.accept_rule = kw.get('accept_rule', runner.accept_rule)
    v.cfg = dataclasses.replace(runner.cfg, prob_kind=kw.get(
        'prob_kind', runner.cfg.prob_kind))
    v.claim = kw.get('claim', 'sequential')
    v.moves_done, v.applied_done = 0, 0
    return v


def _run_variant(v, betas, fw, update_slices=PRODUCT_US):
    """``len(betas)`` iterations of the variant runner ``v``: its own
    ``run`` under the sequential claim, else ``run_walks(_fw)`` with
    ``claim`` on its state (the reslice mask as the runner's)."""
    import numpy as np

    from tnco_tpu_torch.kernels import sa_walks as swk

    if v.claim == 'sequential':
        if fw:
            v.run(betas, update_slices=update_slices, chunk_size=len(betas))
        else:
            v.run(betas, chunk_size=len(betas))
        return
    sp = (v.sparse_wb, v.log2_n_projs)
    opts = dict(claim=v.claim, on_block=v.on_block,
                accept_rule=v.accept_rule, uniform_log2=v.uniform_log2,
                generator=v.generator, device=v.device)
    if fw:
        mask = np.arange(len(betas)) % update_slices == 0
        v.states, m = swk.run_walks_fw(
            v.states, betas, mask, v.max_width, v.log2d_w32, v.skip_lanes,
            v.cfg, v._mw_pos, *sp, slicer=v.fw_slicer, **opts)
    else:
        v.states, m = swk.run_walks(v.states, betas, v.log2d_w32, v.cfg,
                                    v._mw_pos, *sp, **opts)
    v._mw_pos = m['pos']
    v.moves_done += int(m['moves'])
    v.applied_done += int(m['applied'])


def _time_variants(torch, card, runner, variants, fw, what):
    """Each variant from a copy of ``runner``'s state: a warm-up, then
    VARIANT_ITERS timed iterations (ms an iteration, proposals/s,
    applied/s), every replica audited.  Returns ``{name: ms}``."""
    import numpy as np

    betas = np.linspace(20.0, 60.0, VARIANT_WARM + VARIANT_ITERS)
    out = {}
    for name, kw in variants:
        v = _variant(torch, runner, kw)
        _run_variant(v, betas[:VARIANT_WARM], fw)
        moves0, applied0 = v.moves_done, v.applied_done
        ms = _synced_ms(torch, lambda: _run_variant(
            v, betas[VARIANT_WARM:], fw))
        secs = ms / 1e3
        if fw:
            worst = _audit_fw_runner(v, 30, f'{what} {name}')
        else:
            worst = _audit_im_runner(v, f'{what} {name}')[1]
        out[name] = ms / VARIANT_ITERS
        log(f'{what} {name}: {out[name]:.2f} ms per iteration over '
            f'{VARIANT_ITERS}, {(v.moves_done - moves0) / secs:.0f} '
            f'proposals/s, {(v.applied_done - applied0) / secs:.0f} '
            f'applied/s ({card}); every replica audited (|device - exact| '
            f'<= {worst:.2e})')
    base = out['default']
    log(f'{what}: ms per iteration relative to the default: ' + ', '.join(
        f'{k} {ms / base:.2f}' for k, ms in out.items() if k != 'default'))
    return out


def _as_dtype(torch, runner, dtype):
    """A copy of ``runner`` (:func:`_variant`) whose float state, log2
    dims and cap are cast to ``dtype``: the same trees and slices, for
    timing one float type against the other."""
    import dataclasses

    v = _variant(torch, runner, {})
    s = v.states
    v.states = dataclasses.replace(s, **{
        k: getattr(s, k).to(dtype) for k in s.field_names()
        if getattr(s, k).is_floating_point()})
    v.log2d = runner.log2d.to(dtype)
    v.log2d_w32 = runner.log2d_w32.to(dtype)
    if hasattr(runner, 'max_width'):
        v.max_width = runner.max_width.to(dtype)
    v.dtype = dtype
    return v


def _time_dtypes(torch, card, runner, fw, iters, what):
    """float32 against float64 on copies of ``runner``'s state, in turns
    (float32, float64, float64, float32): a warm-up, then ``iters``
    timed iterations (sweeps for 'batched') each turn.  Returns ``{dtype
    name: mean ms an iteration}``."""
    import numpy as np

    betas = np.linspace(20.0, 60.0, 1 + iters)
    times = {'float32': [], 'float64': []}
    for name in ('float32', 'float64', 'float64', 'float32'):
        v = _as_dtype(torch, runner, getattr(torch, name))
        _run_variant(v, betas[:1], fw)
        times[name].append(_synced_ms(torch, lambda: _run_variant(
            v, betas[1:], fw)) / iters)
    out = {k: float(np.mean(t)) for k, t in times.items()}
    log(f'{what}, float32 against float64 in turns: ' + ', '.join(
        f'{k} {"/".join(f"{x:.2f}" for x in t)} ms' for k, t in
        times.items()) + f' an iteration; float64 / float32 '
        f'{out["float64"] / out["float32"]:.2f} ({card})')
    return out


def _audit_f64_fw(runner, what):
    """Every replica of a float64 FW runner: valid best tree within the
    cap, its exact sliced total within F64_AUDIT in log2 of the device
    min total; returns the largest gap."""
    worst = _audit_fw_runner(runner, 30, what)
    if worst > F64_AUDIT:
        fail(f'{what}: float64 device totals differ from the exact cost by '
             f'{worst}')
    return worst


def _f64_optimize(torch, tn, what, fw, **kw):
    """``Optimizer(seed=0, ...)`` (``max_width=30`` if ``fw``) on ``tn``
    under the float64 mode with the ``optimize`` keywords ``kw``, its
    runner recorded: ``(results, runner, launch counts, seen K1/K3
    shapes)``; fails unless the state is float64 and K1 and K3
    launched."""
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.ops import bitops
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    recorded, restore = (_record_runners(fw_sa, 'ReplicaRunnerFW') if fw
                         else _record_runners(im_sa, 'ReplicaRunner'))
    try:
        with bitops.enable_float64(), recorded_cases() as seen:
            opt = (Optimizer(max_width=30, seed=0) if fw else
                   Optimizer(seed=0))
            reset_launch_counts()
            t0 = time.perf_counter()
            _, res = opt.optimize(tn, betas=(0, 60), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        restore()
    (runner,) = recorded
    dtype = runner.states.lcc.dtype
    log(f'{what}: {len(res)} runs in {wall:.2f} s (set-up '
        f'{runner.setup_s:.2f} s, anneal {runner.run_s:.2f} s); engine '
        f'{runner.engine!r}, state {dtype}; launches {counts}')
    if dtype != torch.float64:
        fail(f'{what}: the state is {dtype}, not float64')
    if not all(counts[k] > 0 for k in BATCHED_KERNELS):
        fail(f'{what}: a kernel of the path was never launched')
    return res, runner, counts, seen


def _phase23_card_vs_cpu(torch, im, fw, f64_walks, f64_im, f64_fw):
    """Phase 23d: the first VARIANT_CHECK_B replicas of each runner on
    the card and on the CPU from one state with the same draws: one IM
    walks iteration per variant, one FW walks iteration with 'chained'
    and 'dedup', one float64 'batched' sweep IM and FW (a reslice) and
    one float64 walks-FW iteration."""
    import dataclasses

    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import sa_walks as swk

    b = VARIANT_CHECK_B
    n_leaves = im.cfg.n_leaves
    n_bits = im.log2d.numel()
    f64 = torch.float64
    gen = torch.Generator().manual_seed(23)
    draws = {
        'im': smw.draw_walks(gen, n_leaves, b, im.n_walks),
        'fw': smw.draw_walks(gen, n_leaves, b, fw.n_walks, n_bits),
        'f64 walks': smw.draw_walks(gen, n_leaves, b, f64_walks.n_walks,
                                    n_bits, f64),
        'f64 IM sweep': sb.draw_sweep(gen, f64_im.cfg.n_leaves, b, f64),
        'f64 FW sweep': sfb.draw_sweep_fw(gen, f64_fw.cfg.n_leaves, b,
                                          f64_fw.log2d.numel(), True, False,
                                          f64)}
    runs = {}
    t0 = time.perf_counter()
    for dev in ('cpu', 'cuda'):
        def on(x):
            return None if x is None else x.to(dev)

        def dr(name):
            return {k: v[None].to(dev) for k, v in draws[name].items()}

        for name, kw in IM_VARIANTS[1:]:
            cfg = dataclasses.replace(im.cfg, prob_kind=kw.get(
                'prob_kind', 'mh'))
            runs.setdefault(f'IM walks {name}', {})[dev] = swk.run_walks(
                _states_on(torch, im.states, dev, b), [20.0],
                on(im.log2d_w32), cfg, im._mw_pos[:, :b].to(dev),
                uniform_log2=im.uniform_log2, draws=dr('im'), device=dev,
                claim=kw.get('claim', 'sequential'),
                on_block=kw.get('on_block', 'advance'),
                accept_rule=kw.get('accept_rule', 'round'))
        for key, r, name in (('FW walks chained dedup', fw, 'fw'),
                             ('float64 walks-FW', f64_walks, 'f64 walks')):
            opts = (dict(on_block='dedup', accept_rule='chained')
                    if r is fw else {})
            runs.setdefault(key, {})[dev] = swk.run_walks_fw(
                _states_on(torch, r.states, dev, b), [20.0], [True],
                on(r.max_width), on(r.log2d_w32), on(r.skip_lanes), r.cfg,
                r._mw_pos[:, :b].to(dev), uniform_log2=r.uniform_log2,
                slicer=r.fw_slicer, draws=dr(name), device=dev, **opts)
        r = f64_im
        runs.setdefault('float64 batched IM sweep', {})[dev] = \
            sb.run_sweeps_batched(
                _states_on(torch, r.states, dev, b), [20.0],
                on(r.log2d_w32), r.cfg, uniform_log2=r.uniform_log2,
                draws=dr('f64 IM sweep'))
        r = f64_fw
        runs.setdefault('float64 batched FW sweep', {})[dev] = \
            sfb.run_sweeps_fw_batched(
                _states_on(torch, r.states, dev, b), [20.0], [True],
                on(r.max_width), on(r.log2d_w32), on(r.skip_lanes), r.cfg,
                uniform_log2=r.uniform_log2, draws=dr('f64 FW sweep'))
        torch.cuda.synchronize()
    worst = {}
    for key, v in runs.items():
        atol = F64_CARD if key.startswith('float64') else 1e-5
        worst[key] = _same_on_card(torch, v, key, atol)
    log(f'phase 23 card vs CPU: B={b}: ' + '; '.join(
        f'{k} (totals within {w:.2e})' for k, w in worst.items()) +
        ': integer and bit state bitwise equal '
        f'({time.perf_counter() - t0:.2f} s)')


def phase_walk_variants_float64(torch, card, product=None):
    """Phase 23: the IM walks engine through ``Optimizer``, every walk
    variant on the IM and the FW product runners, float64 state through
    ``Optimizer`` under the float64 mode (walks on the full network,
    'batched' at the default fuse), the card against the CPU, and K1
    and K3 at every shape launched.  Without ``product`` (the phase run
    alone) the FW product runner is built here, as phase 15 builds it,
    and warmed by 4 chunks."""
    import numpy as np

    from tnco_tpu_torch.app import Optimizer, load_tn
    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    ts, out, dims, tn = _sycamore()
    if product is None:
        paths = _build_run_paths(tn, list(range(B)), -1)
        product = _fw_runner(torch, [ContractionTree(
            p[0], ts, dims, output_inds=out) for p in paths],
            'product point', n_walks=P)
        product.run(np.linspace(0.0, 20.0, 4 * PRODUCT_K),
                    update_slices=PRODUCT_US, chunk_size=PRODUCT_K)
    loaded = load_tn(tn, fuse=0, seed=0)
    counts, seen_all, t_phase = {}, set(), time.perf_counter()

    # (a) The IM walks engine through the app: APP_RUNS runs x 32 steps at
    # the runner's IM default P=32 (the app passes its own n_walks, 8 by
    # default, to every walk engine, as the JAX app does).
    recorded, restore = _record_runners(im_sa, 'ReplicaRunner')
    try:
        with recorded_cases() as seen:
            reset_launch_counts()
            t0 = time.perf_counter()
            _, res = Optimizer(seed=0, engine='walks', n_walks=32).optimize(
                tn, betas=(0, 60), n_steps=32, n_runs=APP_RUNS, fuse=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts['im_walks_app'] = launch_counts()
        seen_all |= seen
    finally:
        restore()
    (im,) = recorded
    log(f'IM walks app: {APP_RUNS} runs x 32 steps in {wall:.2f} s (set-up '
        f'{im.setup_s:.2f} s, anneal {im.run_s:.2f} s: '
        f'{1e3 * im.run_s / 32:.2f} ms an iteration); engine '
        f'{im.engine!r}, P={im.n_walks}; launches {counts["im_walks_app"]}')
    if im.engine != 'walks' or im.n_walks != 32:
        fail(f'IM walks app: engine {im.engine!r}, P={im.n_walks}')
    if not all(counts['im_walks_app'][k] > 0 for k in FW_KERNELS):
        fail('IM walks app: a kernel of the path was never launched')
    _audit_im_results(res, loaded, im, 'IM walks app')
    f32_gaps = {'IM walks app': _audit_im_runner(im, 'IM walks app')[1]}

    # (b) Every variant from copies of the IM runner's state, repeated to
    # B=64, and of the FW product runner's.
    _widen(torch, im, B)
    with recorded_cases() as seen:
        reset_launch_counts()
        _time_variants(torch, card, im, IM_VARIANTS, False, 'IM walks')
        _time_variants(torch, card, product, FW_VARIANTS, True,
                       f'FW walks (P={product.n_walks}, reslice every '
                       f'{PRODUCT_US})')
        torch.cuda.synchronize()
        counts['walk_variants'] = launch_counts()
    seen_all |= seen
    f32_gaps['FW product runner'] = _audit_fw_runner(product, 30,
                                                     'FW product runner')

    # (c) Float64 under the float64 mode.
    res, f64_walks, counts['f64_fw_walks'], seen = _f64_optimize(
        torch, tn, 'float64 FW full network', True, n_steps=16,
        n_runs=APP_RUNS, update_slices=PRODUCT_US, fuse=0)
    seen_all |= seen
    if f64_walks.engine != 'walks':
        fail(f"float64 FW full network: 'auto' picked {f64_walks.engine!r}")
    for r in res:
        _audit_result(r, loaded, 30)
    gaps = {'FW walks, full network':
            _audit_f64_fw(f64_walks, 'float64 FW full network')}
    tn_f, loaded_f = _sycamore_fused(fw=False)
    res, f64_im, counts['f64_batched_im'], seen = _f64_optimize(
        torch, tn_f, 'float64 IM default fuse', False,
        n_steps=BATCHED_APP_STEPS, n_runs=APP_RUNS)
    seen_all |= seen
    _audit_im_results(res, loaded_f, f64_im, 'float64 IM default fuse')
    gaps['batched IM, default fuse'] = _audit_im_runner(
        f64_im, 'float64 IM default fuse')[1]
    res, f64_fw, counts['f64_batched_fw'], seen = _f64_optimize(
        torch, tn_f, 'float64 FW default fuse', True,
        n_steps=BATCHED_APP_STEPS, n_runs=APP_RUNS,
        update_slices=UPDATE_SLICES)
    seen_all |= seen
    for r in res:
        _audit_result(r, loaded_f, 30)
    gaps['batched FW, default fuse'] = _audit_f64_fw(
        f64_fw, 'float64 FW default fuse')
    for what, r in (('IM default fuse', f64_im), ('FW default fuse', f64_fw)):
        if r.engine != 'batched':
            fail(f"float64 {what}: 'auto' picked {r.engine!r}")
    if max(gaps.values()) > F64_AUDIT:
        fail(f'float64 audits: {gaps}')
    _widen(torch, f64_im, B)
    _time_dtypes(torch, card, f64_im, False, 4,
                 f"'batched' IM sweep (default fuse, B={B})")
    _time_dtypes(torch, card, product, True, VARIANT_ITERS,
                 f'walks-FW iteration (P={product.n_walks}, reslice every '
                 f'{PRODUCT_US})')
    log('float64 largest |device - exact| in log2: ' + ', '.join(
        f'{k} {v:.3e}' for k, v in gaps.items()) + '; float32 runs of this '
        'phase: ' + ', '.join(f'{k} {v:.3e}' for k, v in f32_gaps.items()))
    planes = sorted({c.g for c, dt in seen_all})
    log(f'phase 23 K1/K3 plane counts seen: {planes}')

    # (d) The card against the CPU; (e) K1 and K3 at every shape.
    _phase23_card_vs_cpu(torch, im, product, f64_walks, f64_im, f64_fw)
    _check_recorded(torch, seen_all, 'walk variants and float64 (phase 23)',
                    widen=B)
    log(f'phase 23: {time.perf_counter() - t_phase:.1f} s')
    return counts


# Phase 24: the 'sweep' engine (IM and FW) through the app and as the
# flagships, the single optimizers and a checkpoint, on the card.
SWEEP_TIMED = 16       # timed rounds of each flagship, after 1 warm-up
SWEEP_CHUNK = 64       # rounds a chunk (benchmarks/quality.py:345)
SWEEP_CHECK_B = 16     # replicas of the card-vs-CPU rounds
OPT_UPDATES = 8        # updates (and betas of update_many) an optimizer
CKPT_K = 4             # sweeps before and after the checkpoint


def _sweep_app(torch, tn, loaded, fw):
    """Phase 24a: ``Optimizer(seed=0, engine='sweep')`` (``max_width=30``,
    reslice every UPDATE_SLICES rounds, if ``fw``), APP_RUNS runs x
    32 rounds on the full network, every result and every replica's best
    state audited: ``(runner, launch counts, seen K1 shapes)``."""
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.app.finite_width import sa as fw_sa
    from tnco_tpu_torch.app.infinite_memory import sa as im_sa
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    what = f"sweep {'FW' if fw else 'IM'} app"
    recorded, restore = (_record_runners(fw_sa, 'ReplicaRunnerFW') if fw
                         else _record_runners(im_sa, 'ReplicaRunner'))
    try:
        with recorded_cases() as seen:
            opt = (Optimizer(max_width=30, seed=0, engine='sweep') if fw
                   else Optimizer(seed=0, engine='sweep'))
            kw = dict(update_slices=UPDATE_SLICES) if fw else {}
            reset_launch_counts()
            t0 = time.perf_counter()
            _, res = opt.optimize(tn, betas=(0, 60), n_steps=32,
                                  n_runs=APP_RUNS, fuse=0, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        restore()
    (runner,) = recorded
    log(f'{what}: {APP_RUNS} runs x 32 rounds in {wall:.2f} s (set-up '
        f'{runner.setup_s:.2f} s, anneal {runner.run_s:.2f} s: '
        f'{1e3 * runner.run_s / 32:.2f} ms a round); engine '
        f'{runner.engine!r}, prob_kind {runner.cfg.prob_kind!r}; launches '
        f'{counts}')
    if runner.engine != 'sweep' or runner.cfg.prob_kind != 'mh_local':
        fail(f'{what}: engine {runner.engine!r}, prob_kind '
             f'{runner.cfg.prob_kind!r}')
    if counts['gather_gbn'] == 0:
        fail(f'{what}: K1 was never launched')
    if fw:
        for r in res:
            _audit_result(r, loaded, 30)
        _audit_fw_runner(runner, 30, what)
        log(f'{what}: {len(res)} results and {runner.n_replicas} replicas '
            'audited')
    else:
        _audit_im_results(res, loaded, runner, what)
    return runner, counts, seen


def _widen(torch, runner, b):
    """The app's runner as a B=``b`` flagship, in place: its replicas'
    states repeated across ``b`` lanes (their draws differ from there
    on), with no second host set-up."""
    reps = b // runner.n_replicas
    s = runner.states
    runner.states = type(s)(**{
        k: (getattr(s, k).repeat(reps, 1) if k == 'keys' else
            torch.cat([getattr(s, k)] * reps, dim=-1))
        for k in s.field_names()})
    runner._mw_pos = torch.cat([runner._mw_pos] * reps, dim=1)
    runner.n_replicas = b


def _sweep_flagship(torch, card, runner, fw):
    """Phase 24b: the app's runner widened to B=64 (:func:`_widen`;
    'mh_local') as the flagship: one
    warm-up round, then SWEEP_TIMED rounds in chunks of SWEEP_CHUNK (FW:
    reslice every UPDATE_SLICES rounds): ms a round, proposals/s,
    applied/s, K1 launches a round and, FW, the reslice's share of the
    rounds (CUDA events around the slicer and its recost)."""
    import numpy as np

    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb

    what = f"sweep {'FW' if fw else 'IM'} flagship"
    _widen(torch, runner, B)
    kw = dict(update_slices=UPDATE_SLICES) if fw else {}
    betas = np.linspace(20.0, 60.0, 1 + SWEEP_TIMED)
    runner.run(betas[:1], chunk_size=SWEEP_CHUNK, **kw)       # warm-up
    torch.cuda.synchronize()
    spans, originals = [], {}

    def timed(fn):
        def call(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.append(ev)
            return out
        return call

    if fw:
        for name in ('_greedy_slices_b', '_lcc_fw_b'):
            originals[name] = getattr(sfb, name)
            setattr(sfb, name, timed(originals[name]))
    try:
        reset_launch_counts()
        moves0, applied0 = runner.moves_done, runner.applied_done
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        runner.run(betas[1:], chunk_size=SWEEP_CHUNK, **kw)
        end.record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(sfb, name, fn)
    dev_ms = start.elapsed_time(end)
    moves = runner.moves_done - moves0
    applied = runner.applied_done - applied0
    n = len(runner.template)
    log(f'{what}: N={n} W={runner.cfg.n_lanes} B={runner.n_replicas}, '
        f'{SWEEP_TIMED} rounds in {1e3 * dt:.3f} ms: '
        f'{1e3 * dt / SWEEP_TIMED:.4f} ms a round (events '
        f'{dev_ms / SWEEP_TIMED:.4f}) on {card}')
    log(f'proposals/s {what}: {moves / dt:.6g} ({card})')
    log(f'applied/s {what}: {applied / dt:.6g} ({card})')
    log(f"{what}: K1 launches {counts['gather_gbn']} "
        f"({counts['gather_gbn'] / SWEEP_TIMED:.3g} a round)")
    if moves != SWEEP_TIMED * (n - runner.template.n_leaves) * \
            runner.n_replicas or counts['gather_gbn'] == 0:
        fail(f'{what}: moves {moves}, launches {counts}')
    if fw:
        share = sum(a.elapsed_time(b) for a, b in spans)
        log(f'{what}: reslice {share:.3f} ms over {len(spans) // 2} '
            f'reslices, {100 * share / dev_ms:.1f}% of the rounds')
        _audit_fw_runner(runner, 30, what)
    else:
        _audit_im_runner(runner, what)
    return {'ms': 1e3 * dt / SWEEP_TIMED, 'prop_s': moves / dt,
            'applied_s': applied / dt}


def _sweep_card_vs_cpu(torch, im, fw):
    """Phase 24c: one IM round, and one FW round with a reslice, from the
    first SWEEP_CHECK_B replicas of each flagship's state with the same
    draws (drawn once on the host), on the card and on the CPU: integer
    and bit state bitwise, totals within 1e-5."""
    from tnco_tpu_torch.kernels import sa_fullsweep as sfs

    gen = torch.Generator().manual_seed(24)
    b = SWEEP_CHECK_B
    for runner, is_fw in ((im, False), (fw, True)):
        what = f"sweep {'FW round with a reslice' if is_fw else 'IM round'}"
        n = runner.states.c0.shape[0]
        ni = n - runner.cfg.n_leaves
        dtype = runner.states.lcc.dtype
        dr = {'u': torch.rand((1, b, ni), generator=gen, dtype=dtype),
              'bits': torch.randint(-2**31, 2**31, (1, b, ni), generator=gen,
                                    dtype=torch.int32)}
        if is_fw:
            dr['jitter'] = torch.rand((1, runner.log2d_w32.numel(), b),
                                      generator=gen, dtype=dtype)
        runs = {}
        for dev in ('cpu', 'cuda'):
            st = _states_on(torch, runner.states, dev, b)
            d = {k: v.to(dev) for k, v in dr.items()}
            kw = dict(uniform_log2=runner.uniform_log2, draws=d)
            if is_fw:
                if not bool((st.slices != 0).any()):
                    fail(f'{what}: no replica holds slices')
                runs[dev] = sfs.run_fullsweep_fw(
                    st, [30.0], [True], runner.max_width.to(dev),
                    runner.log2d_w32.to(dev), runner.skip_lanes.to(dev),
                    runner.cfg, **kw)
            else:
                runs[dev] = sfs.run_fullsweep(
                    st, [30.0], runner.log2d_w32.to(dev), runner.cfg, **kw)
        torch.cuda.synchronize()
        worst = _same_on_card(torch, runs, what)
        log(f'card vs CPU {what} ({b} replicas): integer and bit state '
            f'bitwise equal, applied {int(runs["cuda"][1]["applied"])}, '
            f'totals within {worst:.2e}')


def _single_optimizers(torch, card, ctree):
    """Phase 24d: the IM ``Optimizer`` and the FW ``Optimizer`` (max_width
    30) of ``tnco_tpu_torch.optimize`` on one full-network tree: OPT_UPDATES
    ``update(MetropolisHastings(beta))`` and one ``update_many`` of as
    many betas, ``is_valid()`` and the exact min cost; then a pickled
    copy and a copy from ``prng_state`` continue bitwise with the
    original for 4 more updates."""
    import pickle

    import numpy as np

    from tnco_tpu_torch.optimize import finite_width as ofw
    from tnco_tpu_torch.optimize import infinite_memory as oim
    from tnco_tpu_torch.optimize.prob import MetropolisHastings as MH

    betas = np.linspace(1.0, 8.0, OPT_UPDATES)
    for fw in (False, True):
        what = f"single optimizer {'FW' if fw else 'IM'}"
        t0 = time.perf_counter()
        opt = (ofw.Optimizer(ctree, ofw.SimpleCostModel(max_width=30),
                             seed=0) if fw else
               oim.Optimizer(ctree, oim.SimpleCostModel(), seed=0))
        setup = time.perf_counter() - t0
        if not opt.prng_state.startswith('torchgen:cuda:'):
            fail(f'{what}: prng_state {opt.prng_state[:20]!r}')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for beta in betas:
            opt.update(MH(beta=beta))
        torch.cuda.synchronize()
        upd = (time.perf_counter() - t0) / OPT_UPDATES
        t0 = time.perf_counter()
        opt.update_many(MH(), betas)
        torch.cuda.synchronize()
        many = (time.perf_counter() - t0) / OPT_UPDATES
        ok, msg = opt.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: is_valid: {msg}')
        gap = abs(opt.log2_min_total_cost -
                  math.log2(int(opt.min_total_cost)))
        if gap > 1e-3:
            fail(f'{what}: min total {opt.log2_min_total_cost} vs exact '
                 f'(gap {gap})')
        clone = pickle.loads(pickle.dumps(opt))
        kw = (dict(slices=opt.slices, min_slices=opt.min_slices) if fw
              else {})
        again = type(opt)(opt.ctree, opt.cmodel, seed=opt.prng_state,
                          min_ctree=opt.min_ctree, **kw)
        for _ in range(4):
            for o in (opt, clone, again):
                o.update(MH(beta=8.0))
        for o, name in ((clone, 'pickled copy'), (again, 'prng_state copy')):
            if o != opt or o.log2_total_cost != opt.log2_total_cost:
                fail(f'{what}: the {name} did not continue bitwise')
        log(f'{what}: N={len(ctree)}, set-up {setup:.2f} s, '
            f'{1e3 * upd:.2f} ms an update, {1e3 * many:.2f} ms a sweep of '
            f'update_many, log2 min total {opt.log2_min_total_cost:.4f} '
            f'(exact within {gap:.2e}); pickled and prng_state copies '
            f'continue bitwise ({card})')


def _checkpoint_on_card(torch):
    """Phase 24e: an IM 'batched' runner at the default fuse (B=64) runs
    2 * CKPT_K sweeps; a second runner runs CKPT_K, ``save_runner``,
    ``load_runner`` into a fresh runner, then CKPT_K more: the two end
    bitwise equal."""
    import os

    import numpy as np

    from tnco_tpu_torch.app.finite_width.sa import _build_run_paths
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.parallel import ReplicaRunner
    from tnco_tpu_torch.parallel.checkpoint import load_runner, save_runner

    _, loaded = _sycamore_fused(fw=False)
    seeds = list(range(B))
    ctrees = [ContractionTree(p[0], loaded.ts_inds, loaded.dims,
                              output_inds=loaded.output_inds)
              for p in _build_run_paths(loaded, seeds, -1)]
    betas = np.linspace(1.0, 30.0, 2 * CKPT_K)

    def runner():
        r = ReplicaRunner(ctrees, seeds, engine='batched')
        if r.engine != 'batched':
            fail(f'checkpoint: engine {r.engine!r}')
        return r

    whole = runner()
    whole.run(betas, chunk_size=CKPT_K)
    first = runner()
    first.run(betas[:CKPT_K], chunk_size=CKPT_K)
    os.makedirs('build/smoke', exist_ok=True)
    path = 'build/smoke/ckpt.npz'
    t0 = time.perf_counter()
    save_runner(path, first)
    resumed = runner()
    load_runner(path, resumed)
    io = time.perf_counter() - t0
    resumed.run(betas[CKPT_K:], chunk_size=CKPT_K)
    torch.cuda.synchronize()
    a, b = _fields_cpu(whole.states), _fields_cpu(resumed.states)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if bad or whole.sweeps_done != resumed.sweeps_done or \
            whole.moves_done != resumed.moves_done:
        fail(f'checkpoint: the resumed runner differs in {bad}')
    log(f'checkpoint: B={B} N={len(ctrees[0])}, {CKPT_K} + {CKPT_K} '
        f'sweeps through save_runner/load_runner ({os.path.getsize(path)} '
        f'bytes, {io:.2f} s) equal to {2 * CKPT_K} straight, bitwise')


def phase_sweep(torch, card):
    """Phase 24: the 'sweep' engine through ``Optimizer`` and as the
    flagships, the card against the CPU, the single optimizers and a
    checkpoint on the card, and K1 (and K3) at every shape launched.
    Returns the launch counts and the two apps' runners (IM, FW)."""
    from tnco_tpu_torch.app import load_tn
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    _, _, _, tn = _sycamore()
    loaded = load_tn(tn, fuse=0, seed=0)
    counts, seen_all, t_phase = {}, set(), time.perf_counter()
    im, counts['sweep_im_app'], seen = _sweep_app(torch, tn, loaded, False)
    seen_all |= seen
    fw, counts['sweep_fw_app'], seen = _sweep_app(torch, tn, loaded, True)
    seen_all |= seen
    t_apps = time.perf_counter()
    with recorded_cases() as seen:
        _sweep_flagship(torch, card, im, False)
        _sweep_flagship(torch, card, fw, True)
    seen_all |= seen
    t_flag = time.perf_counter()
    _sweep_card_vs_cpu(torch, im, fw)
    t_cpu = time.perf_counter()
    with recorded_cases() as seen:
        reset_launch_counts()
        _single_optimizers(torch, card, im.min_ctree(0))
        torch.cuda.synchronize()
        counts['single_optimizers'] = launch_counts()
        t_opt = time.perf_counter()
        reset_launch_counts()
        _checkpoint_on_card(torch)
        torch.cuda.synchronize()
        counts['checkpoint'] = launch_counts()
    seen_all |= seen
    for name in ('single_optimizers', 'checkpoint'):
        if not all(counts[name][k] > 0 for k in BATCHED_KERNELS):
            fail(f'{name}: a kernel of the path was never launched')
    _check_recorded(torch, seen_all, "'sweep', optimizers and checkpoint "
                    '(phase 24)', widen=B)
    planes = sorted({c.g for c, dt in seen_all})
    log(f'phase 24 K1/K3 plane counts seen: {planes}')
    log(f'phase 24: {time.perf_counter() - t_phase:.1f} s (apps '
        f'{t_apps - t_phase:.1f}, flagships {t_flag - t_apps:.1f}, card vs '
        f'CPU {t_cpu - t_flag:.1f}, optimizers {t_opt - t_cpu:.1f}, '
        f'checkpoint {time.perf_counter() - t_opt:.1f} s)')
    return counts, (im, fw)


def _native_audit(runner, fw, what):
    """Phase 25a's audit: every replica's best tree valid (and, FW, within
    the cap after its slices), its exact bigint total (sliced, FW) within
    1e-3 in log2 of the runner's best, and ``native.total_cost`` of the
    tree equal to the Python bigint total."""
    from tnco_tpu_torch import native

    worst = (_audit_fw_runner(runner, 30, what) if fw else
             _audit_im_runner(runner, what)[1])
    for r in range(runner.n_replicas):
        best = runner.min_ctree(r)
        dec, log2 = native.total_cost(best.nodes_array, best.inds_array,
                                      best.dims_array)
        exact = _exact_total(best)[1]
        if int(dec) != exact or abs(log2 - math.log2(exact)) > 1e-9:
            fail(f'{what}: replica {r}: native.total_cost {dec} != the '
                 f'bigint {exact}')
    return worst


def _phase_native(torch, card, ctrees, device='cuda'):
    """Phase 25a: the 'native' engine on the card's host (the runner
    resolves the card by the device rule; the C++ engine's state is host
    numpy), IM and FW (max_width 30) on the full network at B, audited;
    the threads check; 'auto' with new slices on the card; one circuit
    through ``Optimizer(engine='native')``."""
    import os

    import numpy as np

    from tnco_tpu_torch import native
    from tnco_tpu_torch.app import Optimizer
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.parallel import ReplicaRunner, ReplicaRunnerFW
    from tnco_tpu_torch.testing.networks import qaoa_circuit

    if not native.available():
        fail('native: the library is not available')
    seeds = list(range(len(ctrees)))
    betas = np.linspace(0.0, 60.0, NATIVE_SWEEPS)
    runners = {}
    for fw in (False, True):
        what = f"native {'FW' if fw else 'IM'}"
        t0 = time.perf_counter()
        runner = (ReplicaRunnerFW(ctrees, seeds, engine='native',
                                  cmodel=SimpleCostModel(max_width=30),
                                  device=device)
                  if fw else ReplicaRunner(ctrees, seeds, engine='native',
                                           device=device))
        t1 = time.perf_counter()
        kw = dict(update_slices=UPDATE_SLICES) if fw else {}
        info = runner.run(betas, chunk_size=NATIVE_CHUNK, **kw)
        dt = time.perf_counter() - t1
        worst = _native_audit(runner, fw, what)
        log(f'{what}: N={len(ctrees[0])} W={ctrees[0].inds_array.shape[1]} '
            f'B={runner.n_replicas}, {info["sweeps"]} sweeps in chunks of '
            f'{NATIVE_CHUNK} in {dt:.4f} s on the host of {card} '
            f'(os.cpu_count() {os.cpu_count()}, n_threads 0: all '
            'hardware threads): '
            f'{info["sweeps"] / dt:.6g} sweeps/s, {info["moves"] / dt:.6g} '
            f'moves/s ({info["moves"]} moves); set-up {t1 - t0:.2f} s; best '
            f'log2 total {info["log2_min_total"].min():.4f}; every replica '
            f'audited (|best - exact| <= {worst:.2e}, native.total_cost == '
            'bigint)')
        runners[fw] = runner
    k = NATIVE_CHECK_B
    chunk = betas[:NATIVE_CHECK_SWEEPS]
    im, fwr = runners[False], runners[True]
    seeds_k = np.arange(k, dtype=np.uint64) + 7
    skip = np.zeros(ctrees[0].inds_array.shape[1], np.uint32)
    outs = [native.sa_run(im._nat_nodes[:k].copy(), im._nat_inds[:k].copy(),
                          ctrees[0].log2_dims_array, chunk, seeds_k,
                          n_threads=t, return_final=True) for t in (1, 0)]
    outs_fw = [native.sa_run_fw(
        fwr._nat_nodes[:k].copy(), fwr._nat_inds[:k].copy(),
        fwr._nat_slices[:k].copy(), ctrees[0].log2_dims_array, skip, 30.0,
        chunk, seeds_k, reslice_every=2, n_threads=t, return_final=True)
        for t in (1, 0)]
    for a, b in (outs, outs_fw):
        for x, y in zip(a, b):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                fail('native: n_threads=1 and all threads differ')
    log(f'native: n_threads=1 == all threads bitwise (IM and FW, {k} '
        f'replicas x {NATIVE_CHECK_SWEEPS} sweeps; {outs[0][1]} and '
        f'{outs_fw[0][1]} moves)')
    auto = ReplicaRunnerFW(ctrees[:2], [0, 1],
                           cmodel=SimpleCostModel(max_width=30),
                           max_number_new_slices=2, device=device)
    if auto.engine != 'native' or auto.device.type != device:
        fail(f"native: 'auto' with new slices on the card resolved to "
             f'{auto.engine!r} on {auto.device}')
    log("native: ReplicaRunnerFW(max_number_new_slices=2) under 'auto' on "
        f"the card resolves to {auto.engine!r}, as the JAX rule does")
    t0 = time.perf_counter()
    _, res = Optimizer(seed=0, engine='native', device=device).optimize(
        qaoa_circuit(n_qubits=12, p_layers=2), betas=(0, 20), n_steps=16,
        n_runs=8)
    costs = [r.disconnected_costs for r in res]
    if len(res) != 8 or res != sorted(res) or not all(c for c in costs):
        fail(f'native: Optimizer(engine=native) results {costs}')
    log(f"native: Optimizer(seed=0, engine='native') on QAOA-12 (p=2): 8 "
        f'runs x 16 sweeps in {time.perf_counter() - t0:.2f} s, best cost '
        f'{res[0].cost}')


def _card_mesh(torch, spec, n_ranks, backend, what):
    """Runs ``mesh_cases.card_runs`` on ``n_ranks`` ranks; fails unless
    every rank held K1, K3 (and K5) against their plain versions; returns
    the ranks' results and their summed launch counts."""
    from tnco_tpu_torch import mesh as tmesh
    from tnco_tpu_torch.testing import mesh_cases as mc

    t0 = time.perf_counter()
    try:
        ranks = tmesh.spawn(mc.card_runs, n_ranks, (spec,), backend=backend,
                            timeout=400, threads=2)
    except RuntimeError as e:
        fail(f'{what}: {e}')
    counts = {k: sum(r['counts'][k] for r in ranks) for k in ranks[0]['counts']}
    for i, r in enumerate(ranks):
        if r['bad']:
            fail(f'{what}: rank {i}: K1/K3 != plain: {r["bad"]}')
        if not all(c['equal'] for c in r['k5']):
            fail(f'{what}: rank {i}: K5 != plain: {r["k5"]}')
    probe = ranks[0]['probe']
    copied = [k for k, v in probe.items() if v != 'ok']
    log(f'{what}: {n_ranks} {backend} ranks on {[r["device"] for r in ranks]}'
        f' in {time.perf_counter() - t0:.1f} s (rank set-up '
        f'{max(r["setup_s"] for r in ranks):.1f} s, runs '
        f'{max(r["run_s"] for r in ranks):.2f} s); K1/K3 == plain at '
        f'{ranks[0]["n_shapes"]} shapes a rank, K5 == plain on '
        f'{len(ranks[0]["k5"])} walker block(s) a rank; launches {counts}')
    log(f"{what}: all-reduce on {ranks[0]['device']} tensors over {backend} "
        f'(sum/min/max; int32, int64, float32): '
        + ('every op taken on the device, none copied across' if not copied
           else f'not taken: {copied} ({[probe[k] for k in copied]})'))
    if copied:
        fail(f'{what}: the mesh needs these all-reduces on the card: '
             f'{copied}')
    return ranks, counts


def _mesh_one_rank(torch, device='cuda', backend='nccl'):
    """Phase 25b: a one-rank NCCL group on the card: 'batched', 'walks'
    FW, 'walker' IM and FW with ``mesh=make_mesh()`` equal the same
    runners without a mesh, bitwise, and the sharded exchanges equal
    ``exchange_best(_fw)``."""
    import numpy as np

    from tnco_tpu_torch.testing import mesh_cases as mc
    from tnco_tpu_torch.utils.tn import get_random_contraction_path

    _, loaded = _sycamore_fused(True)
    ts, out, dims = loaded.ts_inds, loaded.output_inds, loaded.dims
    paths = [get_random_contraction_path(ts, out, seed=s)
             for s in range(MESH_ONE_B)]
    b4, b8 = list(np.linspace(0, 10, 4)), list(np.linspace(0, 10, 8))
    cases = [dict(fw=False, engine='batched', betas=b4,
                  run=dict(chunk_size=2)),
             dict(fw=True, engine='walks', max_width=30.0, betas=b4,
                  kw=dict(n_walks=32), run=dict(chunk_size=2,
                                                update_slices=2)),
             dict(fw=False, engine='walker', betas=b8,
                  run=dict(chunk_size=4)),
             dict(fw=True, engine='walker', max_width=30.0, betas=b8,
                  run=dict(chunk_size=4, update_slices=2))]
    spec = dict(net=mc.network(ts, out, dims, paths), cases=cases,
                seeds=list(range(MESH_ONE_B)), device=device,
                one_device=True)
    what = f'mesh (one {backend} rank)'
    (r,), counts = _card_mesh(torch, spec, 1, backend, what)
    if not all(r['one_device_equal']) or not all(r['exchange_equal']):
        fail(f"{what}: mesh != one device: {r['one_device_equal']}, "
             f"exchanges {r['exchange_equal']}")
    if device == 'cuda' and not all(counts[k] > 0 for k in (
            'gather_gbn', 'scatter_rows_inplace', 'walker_im', 'walker_fw')):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    log(f"{what}: 'batched', 'walks' FW, 'walker' IM and FW on "
        f'N={2 * len(ts) - 1}, B={MESH_ONE_B} equal the runners without a '
        'mesh bitwise; exchange_best(_fw)_sharded == exchange_best(_fw)')
    return counts


def _mesh_four_ranks(torch, paths, device='cuda'):
    """Phase 25c: four gloo ranks on the one card, a (2, 2) ('dcn',
    'ici') mesh, the full network at B: 'walks' FW with the 'ici'
    exchange every chunk and 'walker' IM equal the one-device runs
    bitwise (the one-device FW run exchanges as the mesh does,
    ``mesh_cases.exchange_blocks``); K1, K3 and K5 held against their
    plain versions in each rank."""
    import numpy as np

    from tnco_tpu_torch.testing import mesh_cases as mc
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    ts, out, dims = sycamore_like_tn(20)
    net = mc.network(ts, out, dims, paths)
    seeds = list(range(len(paths)))
    shape, names = (2, 2), ('dcn', 'ici')
    cases = [dict(fw=True, engine='walks', max_width=30.0,
                  betas=list(np.linspace(0, 60, MESH_FW_ITERS)),
                  run=dict(chunk_size=2, update_slices=2, exchange_every=1,
                           exchange_axes=('ici',))),
             dict(fw=False, engine='walker',
                  betas=list(np.linspace(0, 60, MESH_K)),
                  run=dict(chunk_size=MESH_K // 2))]
    spec = dict(net=net, seeds=seeds, cases=cases, shape=shape,
                axis_names=names, device=device)
    what = 'mesh (four gloo ranks, one card)'
    # The one-device runs go on in this process while the ranks run (the
    # host set-up of both is most of the phase).
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(_card_mesh, torch, spec, 4, 'gloo', what)
        t0 = time.perf_counter()
        ctrees = mc.trees(net)
        refs = []
        for case in cases:
            one = mc.build_runner(case, ctrees, seeds, None, device)
            info = mc.run_case(one, case, (shape, names))
            refs.append((info, mc.local_fields(one.states),
                         one._mw_pos.cpu().numpy()))
        t_ref = time.perf_counter() - t0
        ranks, counts = job.result()
    if device == 'cuda' and not all(counts[k] > 0 for k in (
            'gather_gbn', 'scatter_rows_inplace', 'walker_im')):
        fail(f'{what}: a kernel of the path was never launched: {counts}')
    for i, (case, (info, want, want_pos)) in enumerate(zip(cases, refs)):
        got = mc.join_blocks([r['local'][i] for r in ranks])
        pos = np.concatenate([r['pos'][i] for r in ranks], axis=1)
        bad = [f for f in want if not np.array_equal(got[f], want[f])]
        if bad or not np.array_equal(pos, want_pos):
            fail(f"{what}: {case['engine']}: sharded != one device in {bad}")
        for r in ranks:
            ri = r['infos'][i]
            if (ri['sweeps'], ri['moves'], ri['applied']) != (
                    info['sweeps'], info['moves'], info['applied']) or \
                    not np.array_equal(ri['log2_min_total'],
                                       info['log2_min_total']):
                fail(f"{what}: {case['engine']}: counts {ri} != {info}")
    log(f"{what}: 'walks' FW ({MESH_FW_ITERS} iterations, 'ici' exchange "
        f"every chunk) and 'walker' IM ({MESH_K} iterations) at "
        f'B={len(paths)}, N={len(ctrees[0])} equal the one-device runs '
        f'bitwise (one-device runs {t_ref:.1f} s, beside the ranks)')
    return counts


def _block_draws(torch, card, ctrees, n_ranks=4, reps=200):
    """Phase 25d: what the global draw stream costs a rank.  On a mesh of
    ``n_ranks`` each rank draws the whole replica axis and keeps its
    block (``ops/rng.BlockGenerator``); timed on the card against the
    draw of the block alone and of the whole axis, at phase 25c's shapes:
    one 'walks' FW iteration (``draw_walks``, P=128, the reslice jitter
    over the W*32 bits) and one 'walker' IM chunk (``draw_chunk``, K =
    MESH_K // 2, P=8), B replicas.  Wall ms a draw (host and card, the
    mean of ``reps`` after a warm-up), the card synchronised at both
    ends."""
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.ops import rng

    b = len(ctrees)
    blk = b // n_ranks
    nl, n_bits = ctrees[0].n_leaves, 32 * ctrees[0].inds_array.shape[1]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    sites = {
        'walks FW iteration': lambda g, n: smw.draw_walks(g, nl, n, 128,
                                                          n_bits),
        'walker IM chunk': lambda g, n: smw.draw_chunk(g, nl, MESH_K // 2,
                                                       8, n)}
    out = {}
    for site, draw in sites.items():
        arms = {'whole': (gen, b), 'own block': (gen, blk),
                'block of the whole': (rng.BlockGenerator(gen, 0, blk, b),
                                       blk)}
        ms = {}
        for arm, (g, n) in arms.items():
            for _ in range(10):
                draw(g, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                draw(g, n)
            torch.cuda.synchronize()
            ms[arm] = (time.perf_counter() - t0) * 1e3 / reps
        out[site] = ms
        log(f'draws ({site}, B={b}, a rank\'s block {blk} of {n_ranks}; '
            f'{card}): whole {ms["whole"]:.4f} ms, own block '
            f'{ms["own block"]:.4f} ms, the block of the whole '
            f'{ms["block of the whole"]:.4f} ms a draw; the global stream '
            f'costs a rank {ms["block of the whole"] - ms["own block"]:.4f}'
            ' ms a draw')
    return out


def phase_native_mesh(torch, card, ctrees, paths):
    """Phase 25: (a) 'native' on the card's host, (b) a one-rank NCCL
    mesh, (c) four gloo ranks on the card; returns the launch counts of
    (b) and (c)."""
    t0 = time.perf_counter()
    _phase_native(torch, card, ctrees)
    t1 = time.perf_counter()
    counts = {'mesh_one_rank': _mesh_one_rank(torch)}
    t2 = time.perf_counter()
    counts['mesh_four_ranks'] = _mesh_four_ranks(torch, paths)
    t3 = time.perf_counter()
    _block_draws(torch, card, ctrees)
    log(f'phase 25: {time.perf_counter() - t0:.1f} s (native '
        f'{t1 - t0:.1f}, one rank {t2 - t1:.1f}, four ranks '
        f'{t3 - t2:.1f}, draws {time.perf_counter() - t3:.1f} s)')
    return counts


def _log2_sum_gap(tree):
    """``|log2(sum 2**c) - log2(total_cost_exact())|`` over the tree's
    ``contraction_log2_costs()`` ``c``, which must be -inf on exactly
    the leaves."""
    import numpy as np

    c = tree.contraction_log2_costs()
    leaves = tree.nodes_array[:, 0] < 0
    if not (np.isneginf(c[leaves]).all() and np.isfinite(c[~leaves]).all()):
        fail('contraction_log2_costs: -inf not on exactly the leaves')
    top = c[~leaves].max()
    got = top + math.log2(float(np.exp2(c[~leaves] - top).sum()))
    return abs(got - math.log2(tree.total_cost_exact()))


def _host_api_full_width(fw_trees, sweep_runners):
    """Phase 26b: the host API on the full network (N=3241, W=64): an FW
    min tree of phase 24's 'sweep' FW runner within its cap after its
    slices (``max_width()`` of the tree with the slices' bits cleared,
    the cost model's ``get_max_width``, the popcount recompute); the
    log2-sum of ``contraction_log2_costs()`` against the exact bigint
    total on that tree, the 'sweep' IM runner's best and four of phase
    4's trees; ``swap_with_nn`` on a copy of a phase 4 tree: each swap's
    structure builds a valid tree through ``path()`` and the swap back
    restores the copy, which stays valid."""
    import numpy as np

    from tnco_tpu_torch.bitset import Bitset
    from tnco_tpu_torch.ctree import ContractionTree
    from tnco_tpu_torch.optimize.finite_width import SimpleCostModel
    from tnco_tpu_torch.testing.networks import sycamore_like_tn

    im, fw = sweep_runners
    cm = SimpleCostModel(max_width=30)
    r = int(np.argmin(fw.log2_min_totals()))
    tree = fw.min_ctree(r)
    lanes = np.asarray(fw.min_slices_lanes(r), dtype=np.uint32)
    order = tree.inds_order
    slices = frozenset(order[p] for p in Bitset.from_lanes(
        lanes, len(order)).positions())
    full = tree.max_width()
    sliced = tree.replace_arrays(tree.nodes_array,
                                 tree.inds_array & ~lanes).max_width()
    by_model = cm.get_max_width([xs - slices for xs in tree.inds], tree.dims)
    want, _ = _exact_total(tree, lanes)
    if abs(full - cm.get_max_width(tree.inds, tree.dims)) > 1e-9 or \
            abs(sliced - by_model) > 1e-9 or abs(sliced - want) > 1e-9:
        fail(f'FW min tree widths disagree: max_width {full}, sliced '
             f'{sliced}, get_max_width {by_model}, popcount {want}')
    if sliced > cm.max_width + 1e-9:
        fail(f'FW min tree: width {sliced} after its slices over the cap')
    log(f'host API: FW min tree (phase 24, replica {r}): max_width() '
        f'{full} unsliced, {sliced} after its {len(slices)} slices '
        f'(cap {cm.max_width}); get_max_width and the popcount agree')
    trees = [('FW min', tree), ('IM min', im.min_ctree(im.best()[0]))]
    trees += [(f'phase 4 tree {i}', t) for i, t in enumerate(fw_trees[:4])]
    gaps = {name: _log2_sum_gap(t) for name, t in trees}
    if max(gaps.values()) > 1e-9:
        fail(f'log2-sum of contraction_log2_costs() vs log2 of the exact '
             f'total: {gaps}')
    log(f'host API: log2-sum of contraction_log2_costs() == log2 '
        f'total_cost_exact() within {max(gaps.values()):.3g} on '
        f'{len(trees)} trees (N={len(tree)})')
    ts, out, dims = sycamore_like_tn(20)
    base = fw_trees[0]
    copy = base.replace_arrays(base.nodes_array.copy(),
                               base.inds_array.copy())
    nodes = copy.nodes_array
    rng = np.random.default_rng(26)
    movable = [d for d in range(len(copy)) if nodes[d, 2] >= 0 and
               nodes[nodes[d, 2], 2] >= 0]
    for d in rng.choice(movable, size=4, replace=False):
        b = nodes[d, 2]
        a = nodes[b, 2]
        c = nodes[a, 1] if nodes[a, 0] == b else nodes[a, 0]
        copy.swap_with_nn(int(d))
        if nodes[d, 2] != a or nodes[c, 2] != b:
            fail(f'swap_with_nn({d}): parents not exchanged')
        moved = ContractionTree(copy.path(), ts, dims, output_inds=out)
        ok, msg = moved.is_valid(return_message=True)
        if not ok or _log2_sum_gap(moved) > 1e-9:
            fail(f'swap_with_nn({d}): the moved tree: {msg}')
        copy.swap_with_nn(int(c))
        if not np.array_equal(nodes, base.nodes_array) or \
                not copy.is_valid():
            fail(f'swap_with_nn({d}) then ({c}) did not restore the tree')
    log('host API: 4 swap_with_nn moves on a copy of a phase 4 tree: each '
        'moved structure valid, each swap back restored the tree')


def phase_examples_host_api(torch, card, fw_trees, sweep_runners):
    """Phase 26: (a) the three flows of ``examples/`` on the card
    (``tnco_tpu_torch.testing.examples``), each audited; (b) the host API
    at full width (``_host_api_full_width``); (c) the random networks of
    the JAX package's tests through ``Optimizer(device='cuda')``, IM and
    FW, every result audited; (d) K1 and K3 bitwise against their plain
    versions at each shape the phase launched them.  Runs (a), (c), then
    (b), which launches no kernel.  Returns the launch counts of (a) and
    (c)."""
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing import examples as ex
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    t_phase = time.perf_counter()
    counts, seen_all, walls = {}, set(), {}

    def base():
        out = ex.base_optimization('cuda')
        for name in ('opt', 'fw'):
            if not out[name].prng_state.startswith('torchgen:cuda:'):
                fail(f'base_optimization: the {name} optimizer is not on '
                     'the card')
        ex.audit_base_optimization(out)
        return (f"max_width {out['max_width']}, cost {out['cost']}, IM min "
                f"{out['opt'].min_total_cost}, FW min "
                f"{out['fw'].min_total_cost} slices "
                f"{sorted(out['fw'].min_slices)}")

    def optimization():
        tn, runs = ex.optimization('cuda')
        ex.audit_optimization(tn, runs)
        return ', '.join(f'{k} {v[1][0].cost}' for k, v in runs.items())

    def sampling():
        out = ex.sampling('cuda')
        err = ex.audit_sampling(out)
        return (f'{len(out["records"])} amplitudes within {err:.3g} of the '
                f'statevector, {len(out["hits"])} and '
                f'{len(out["hits_capped"])} bitstrings')

    def random_networks():
        runs = ex.random_networks('cuda')
        return (f'{len(ex.RANDOM_SHAPES)} networks x IM/FW, '
                f'{ex.audit_random_networks(runs)} results audited')

    for key, flow in (('example_base', base),
                      ('example_optimization', optimization),
                      ('example_sampling', sampling),
                      ('random_networks', random_networks)):
        t0 = time.perf_counter()
        with recorded_cases() as seen:
            reset_launch_counts()
            try:
                said = flow()
            except AssertionError as exc:
                fail(f'{key}: audit failed: {exc}')
            torch.cuda.synchronize()
            counts[key] = launch_counts()
        seen_all |= seen
        walls[key] = round(time.perf_counter() - t0, 1)
        log(f'{key}: {said}; {walls[key]} s; launches {counts[key]} '
            f'({card})')
        # The sampler's prefix networks (4 qubits) fuse (fuse=3) to two
        # tensors, one contraction: their sweeps read rows (K1) but have
        # no move to write (K3).
        needs = ('gather_gbn',) if key == 'example_sampling' else \
            BATCHED_KERNELS
        if not all(counts[key][k] > 0 for k in needs):
            fail(f'{key}: a kernel of the path was never launched')
    t0 = time.perf_counter()
    _host_api_full_width(fw_trees, sweep_runners)
    walls['host_api'] = round(time.perf_counter() - t0, 1)
    _check_recorded(torch, seen_all, 'examples and random networks '
                    '(phase 26)')
    log(f'phase 26: {time.perf_counter() - t_phase:.1f} s ({walls})')
    return counts


# Phase 27: the reference's batch stacking helpers on the card at full
# width, on phase 4's flagship trees (N=3241, W=64, B=64): the batch
# builders against the stacked states, STACK_SWEEPS lockstep and
# 'vmapped' sweeps from one stacked batch, and the sampler's
# optimization_backend on QAOA-4 p=2 at phase 21's settings,
# STACK_SAMPLES samples a sampler.
STACK_SWEEPS, STACK_SAMPLES = 2, 100
STACK_CAP = 30.0       # the FW states' max_width


def _same_fields(torch, got, want, what, atol=None):
    """Every field of two states or batches equal: shape, dtype, device
    and every word; with ``atol``, the totals within it instead.  Returns
    the largest total difference."""
    worst = 0.0
    for k in type(want).field_names():
        a, b = getattr(got, k), getattr(want, k)
        if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
            fail(f'{what}: {k} is {tuple(a.shape)} {a.dtype} on {a.device},'
                 f' expected {tuple(b.shape)} {b.dtype} on {b.device}')
        if atol is not None and k in ('log2_total', 'min_log2_total'):
            worst = max(worst, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            fail(f'{what}: {k} differs in {int((a != b).sum())} entries')
    if atol is not None and worst > atol:
        fail(f'{what}: totals differ by {worst}')
    return worst


def _audit_batch(torch, batch, template, what, max_width=None):
    """Every replica's best tree in a lane-major batch is valid, fits
    ``max_width`` after its min slices (FW), and its exact bigint total
    (sliced) is within 1e-3 in log2 of the batch's min total; returns the
    largest difference."""
    import numpy as np

    def host(x):
        return x.cpu().numpy()

    nodes = np.stack([host(batch.min_c0), host(batch.min_c1),
                      host(batch.min_par)], axis=1)            # [N, 3, B]
    inds = host(batch.min_inds).view(np.uint32)                # [N, W, B]
    slices = (host(batch.min_slices).view(np.uint32) if max_width else
              None)
    mins = host(batch.min_log2_total)
    worst = 0.0
    for r in range(mins.shape[0]):
        tree = template.replace_arrays(np.ascontiguousarray(nodes[..., r]),
                                       np.ascontiguousarray(inds[..., r]))
        ok, msg = tree.is_valid(return_message=True)
        if not ok:
            fail(f'{what}: replica {r}: invalid min tree: {msg}')
        width, exact = _exact_sliced(tree, None if slices is None else
                                     slices[:, r])
        if max_width is not None and width > max_width + 1e-9:
            fail(f'{what}: replica {r}: width {width} over the cap after '
                 'slicing')
        worst = max(worst, abs(exact - float(mins[r])))
    if worst > 1e-3:
        fail(f'{what}: min totals differ from the exact recompute by '
             f'{worst}')
    return worst


def _stacking_builders(torch, trees, device='cuda'):
    """Phase 27a and c: ``init_batch`` and ``init_batch_fw`` called
    without ``device`` (the card, ``cuda:0``) equal ``from_states(_fw)``
    of every replica's ``init_state(_fw)`` on ``device`` (FW: with the
    batch's own initial slices), field by field, and ``replica_state(_fw)``
    of the batch equals each replica's state.  Returns the IM and FW
    states and the padded log2 dims (host)."""
    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite as saf
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels import sa_infinite as sa
    from tnco_tpu_torch.ops import bitops

    card0 = torch.empty(0, device=device).device
    t = trees[0]
    log2d = bitops.pad_log2_dims(t.log2_dims_array, t.inds_array.shape[1])
    seeds = list(range(len(trees)))
    out = []
    for what, build, make, join, pick in (
            ('IM', lambda: sb.init_batch(trees, seeds, log2d.numpy()),
             lambda tr, s, i, b: sa.init_state(tr, s, log2d, device=device),
             sb.from_states, sb.replica_state),
            ('FW', lambda: sfb.init_batch_fw(trees, seeds, STACK_CAP,
                                             log2d.numpy()),
             lambda tr, s, i, b: saf.init_state_fw(
                 tr, s, STACK_CAP, log2d, slices=b.slices[:, i].clone(),
                 device=device),
             sfb.from_states_fw, sfb.replica_state_fw)):
        t0 = time.perf_counter()
        batch = build()
        t1 = time.perf_counter()
        devs = {getattr(batch, k).device for k in type(batch).field_names()}
        if devs != {card0}:
            fail(f'phase 27 {what}: the batch built without device= lies '
                 f'on {devs}, not on {card0}')
        states = [make(tr, s, i, batch)
                  for i, (tr, s) in enumerate(zip(trees, seeds))]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _same_fields(torch, join(states), batch, f'phase 27 {what} '
                     'from_states against the batch builder')
        for i, st in enumerate(states):
            _same_fields(torch, pick(batch, i), st,
                         f'phase 27 {what} replica_state({i})')
        torch.cuda.synchronize()
        log(f'phase 27 {what}: the batch builder without device= put '
            f'B={len(trees)} on {card0} in {t1 - t0:.2f} s; '
            f'{len(states)} init_state on {card0} in {t2 - t1:.2f} s; '
            f'from_states equal to it and replica_state equal to every '
            f'state, bitwise in every field ({time.perf_counter() - t2:.2f}'
            f' s; N={len(t)}, W={t.inds_array.shape[1]})')
        out.append(states)
    return out[0], out[1], log2d


def _stacking_sweeps(torch, card, trees, states, states_fw, log2d,
                     device='cuda'):
    """Phase 27b: from one stacked batch and the same draws, the lockstep
    ``run_sweeps_batched`` (``run_sweeps_fw_batched``, a reslice after
    the first sweep) and the 'vmapped' ``run_sweeps_batch``
    (``run_sweeps_fw_batch``): integer state and min trees bitwise,
    totals within 1e-5, the moves equal, ``replica_state(_fw)(out, 0)``
    equal to the vmapped state's replica 0; every replica audited.
    Returns the audits' largest differences."""
    import numpy as np

    from tnco_tpu_torch.kernels import sa_batched as sb
    from tnco_tpu_torch.kernels import sa_finite as saf
    from tnco_tpu_torch.kernels import sa_finite_batched as sfb
    from tnco_tpu_torch.kernels import sa_infinite as sa
    from tnco_tpu_torch.kernels.sa_fullsweep import uniform_log2_dim

    dev = torch.device(device)
    t = trees[0]
    w, b, k = t.inds_array.shape[1], len(states), STACK_SWEEPS
    ul = uniform_log2_dim(t.log2_dims_array)
    log2d = log2d.to(dev)
    log2d_w32 = log2d.reshape(w, 32)
    skip = torch.zeros(w, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(27)

    def stacked(draws):
        return {key: torch.stack([d[key] for d in draws])
                for key in draws[0]}

    dr = stacked([sb.draw_sweep(gen, t.n_leaves, b) for _ in range(k)])
    dr_fw = stacked([sfb.draw_sweep_fw(gen, t.n_leaves, b, 32 * w, True,
                                       False) for _ in range(k)])
    betas = np.linspace(10.0, 60.0, k).tolist()
    mask = [i == 0 for i in range(k)]
    cfg = sa.SweepConfig(n_leaves=t.n_leaves, n_lanes=w)
    cfg_fw = saf.SweepConfigFW(n_leaves=t.n_leaves, n_lanes=w)
    runs = (
        ('IM', lambda: sb.run_sweeps_batched(
            sb.from_states(states), betas, log2d_w32, cfg, uniform_log2=ul,
            draws=dr),
         lambda: sa.run_sweeps_batch(
             sa.stack(states), betas, log2d, cfg, uniform_log2=ul,
             draws=dr), sa.to_batch, sb.replica_state, None),
        ('FW', lambda: sfb.run_sweeps_fw_batched(
            sfb.from_states_fw(states_fw), betas, mask, STACK_CAP,
            log2d_w32, skip, cfg_fw, uniform_log2=ul, draws=dr_fw),
         lambda: saf.run_sweeps_fw_batch(
             sa.stack(states_fw), betas, mask, STACK_CAP, log2d, skip,
             cfg_fw, uniform_log2=ul, draws=dr_fw), saf.to_batch_fw,
         sfb.replica_state_fw, STACK_CAP))
    gaps = {}
    for what, lockstep, vmapped, to_batch, pick, cap in runs:
        t0 = time.perf_counter()
        lock, lm = lockstep()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vm, vmm = vmapped()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        name = f'phase 27 {what} lockstep against vmapped'
        worst = _same_fields(torch, to_batch(vm), lock, name, atol=1e-5)
        moves, vmoves = int(lm['moves'].sum()), int(vmm['moves'].sum())
        if moves != vmoves or not moves:
            fail(f'{name}: moves {moves} and {vmoves}')
        _same_fields(torch, pick(lock, 0), sa.unstack(vm, 0),
                     f'phase 27 {what} replica_state(out, 0)', atol=1e-5)
        gaps[what] = _audit_batch(torch, lock, t, f'phase 27 {what}', cap)
        log(f'phase 27 {what}: {k} sweeps at B={b} (betas {betas}'
            f"{', a reslice after the first' if cap else ''}): lockstep "
            f'{1e3 * (t1 - t0):.1f} ms, vmapped {1e3 * (t2 - t1):.1f} ms '
            f'incl. stacking ({card}); integer state and min trees bitwise '
            f'equal, totals within {worst:.2e}, {moves} moves on both; '
            f'replica_state(out, 0) == the vmapped replica 0; every '
            f'replica audited (|device - exact| <= {gaps[what]:.2e})')
    return gaps


def _stacking_sampler(torch, card, device='cuda'):
    """Phase 27d: ``Sampler(optimization_backend='numpy', device=device)``
    and ``Sampler(device=device)`` with one seed on QAOA-4 p=2 at phase
    21's settings sample the same bitstrings; every amplitude each
    contracts is within 1e-10 of the statevector."""
    from tnco_tpu_torch.app.circuit import Sampler
    from tnco_tpu_torch.testing import sampling as ts
    from tnco_tpu_torch.testing.networks import qaoa_sampling_circuit

    gates = qaoa_sampling_circuit(4, 2, 0)
    order = tuple(range(4))
    hits, secs, err = [], [], 0.0
    for kw in ({'optimization_backend': 'numpy'}, {}):
        t0 = time.perf_counter()
        sampler = Sampler(seed=1, device=device, **kw)
        if sampler._optimizer.backend != kw.get('optimization_backend'):
            fail(f'phase 27 sampler {kw}: the optimizer has backend '
                 f'{sampler._optimizer.backend!r}')
        state = sampler.sample(gates, return_intermediate_state_only=True,
                               **SAMPLER_OPT)
        with ts.recorded_amplitudes(state) as seen:
            got, _ = sampler.sample(state, n_samples=STACK_SAMPLES,
                                    qubit_order=order, normalize=False)
        torch.cuda.synchronize()
        err = max(err, ts.visited_probability_error(seen, gates, order))
        hits.append(got)
        secs.append(time.perf_counter() - t0)
    if hits[0] != hits[1] or sum(hits[0].values()) != STACK_SAMPLES:
        fail(f'phase 27 sampler: optimization_backend changed the samples: '
             f'{hits}')
    if err > 1e-10:
        fail(f'phase 27 sampler: visited probabilities differ by {err}')
    log(f"phase 27 sampler QAOA-4 p=2: Sampler(optimization_backend='numpy',"
        f' device={device!r}) and Sampler(device={device!r}), seed 1: the '
        'same '
        f'{len(hits[0])} bitstrings over {STACK_SAMPLES} samples each, '
        f'every visited probability within {err:.2e} of the statevector '
        f'({secs[0]:.2f} and {secs[1]:.2f} s with the state; {card})')


def phase_stacking(torch, card, fw_trees):
    """Phase 27: the batch stacking helpers and the batch builders'
    device rule at full width (``_stacking_builders``), the lockstep and
    'vmapped' engines from one stacked batch (``_stacking_sweeps``), the
    sampler's ``optimization_backend`` (``_stacking_sampler``), then K1
    and K3 bitwise against their plain versions at each shape the phase
    launched them.  Returns ``{'stacking': launch counts}``."""
    from tnco_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tnco_tpu_torch.testing.kernel_cases import recorded_cases

    t_phase = time.perf_counter()
    walls = {}
    with recorded_cases() as seen:
        reset_launch_counts()
        states, states_fw, log2d = _stacking_builders(torch, fw_trees)
        walls['builders'] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        _stacking_sweeps(torch, card, fw_trees, states, states_fw, log2d)
        walls['sweeps'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _stacking_sampler(torch, card)
        walls['sampler'] = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
    if not all(counts[k] > 0 for k in BATCHED_KERNELS):
        fail(f'phase 27: a kernel of the path was never launched: {counts}')
    _check_recorded(torch, seen, 'stacking (phase 27)')
    log(f'phase 27: {time.perf_counter() - t_phase:.1f} s (' + ', '.join(
        f'{k} {v:.1f}' for k, v in walls.items()) + f' s; {card}); '
        f'launches {counts}')
    return {'stacking': counts}


def _time_ms(torch, fn, reps=50, rounds=11):
    """Device ms of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed between two events, median over ``rounds``.

    The graph keeps the host's issue time (Python wrapper, ctypes) out of
    the number: a single call timed alone would measure the wrapper.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    times.sort()
    return times[len(times) // 2]


# The first designs of P1 and K2 and the floors measured beside them
# (phase 10 and scripts/profile_torch_probe_inv.py), built at first use
# into build/kernels/; nothing on the main path loads them.
PROBE_INV_BASELINE = 'scripts/probe_inv_first_design.cu'


@functools.lru_cache(maxsize=None)
def probe_inv_baseline_lib():
    """The ctypes library of ``PROBE_INV_BASELINE``."""
    import ctypes
    from pathlib import Path
    from tnco_tpu_torch.kernels import build
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    path = build.build(
        (str(Path(__file__).resolve().parent / PROBE_INV_BASELINE),), (),
        'libtnco_probe_inv_first.so')
    return build._bind(path, {
        'tnco_probe_loop_first': (ptr,) * 4 + (i32,) * 3 + (ptr,),
        'tnco_probe_take_first': (ptr,) * 3 + (i32,) * 3 + (ptr,),
        'tnco_inv_ids_first': (ptr, ptr, i32, i32, i32, ptr),
        'tnco_probe_loop_form': (ptr,) * 3 + (i32,) * 7 + (ptr,),
        'tnco_barrier_floor': (ptr, i32, i32, i32, ptr),
        'tnco_l2_read': (ptr, ctypes.c_longlong, i32, ptr, i32, i32, ptr),
        'tnco_empty_floor': (i32, i32, ptr)})


def _floor_call(torch, name, *args):
    """One launch of a baseline-library kernel on the current stream."""
    rc = getattr(probe_inv_baseline_lib(), name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f'{name} failed to launch (cudaError {rc})')


def probe_floors(torch, state, p, rounds, inv_blocks):
    """The floors beside P1 and K2 at their timed shapes: the loop's grid
    doing its 2 R barriers alone; the card's L2 read rate (the state read
    10 and 40 times with 16-byte loads that skip L1: the bytes of the 30
    extra passes over the extra time) and the take's floor, an empty kernel
    on its grid plus its row bytes at that rate; an empty kernel on K2's
    grid of ``inv_blocks`` blocks."""
    from tnco_tpu_torch.benchmarks import gather_probe as gp
    threads = gp.loop_threads(p)
    sink = torch.zeros(gp.COLS, dtype=torch.int32, device=state.device)
    loop_ms = _time_ms(torch, lambda: _floor_call(
        torch, 'tnco_barrier_floor', sink.data_ptr(), gp.COLS, threads,
        rounds))
    l2_ms = [_time_ms(torch, lambda: _floor_call(
        torch, 'tnco_l2_read', state.data_ptr(), state.numel(), passes,
        sink.data_ptr(), 4 * 132, 256)) for passes in (10, 40)]
    l2_rate = 30 * 4 * state.numel() / (l2_ms[1] - l2_ms[0]) / 1e9  # TB/s
    take_bytes = 4 * rounds * p * gp.COLS
    take_empty_ms = _time_ms(torch, lambda: _floor_call(
        torch, 'tnco_empty_floor', p, 256))
    empty_ms = _time_ms(torch, lambda: _floor_call(
        torch, 'tnco_empty_floor', inv_blocks, 256))
    return dict(loop_ms=loop_ms, loop_grid=f'{gp.COLS} x {threads}',
                l2_tb_per_s=l2_rate, take_bytes=take_bytes,
                take_ms=take_empty_ms + take_bytes / l2_rate / 1e9,
                empty_ms=empty_ms)


def _max_abs_err(torch, got, want):
    """Largest difference of the 32-bit words (0 iff bitwise equal)."""
    torch.cuda.synchronize()
    d = got.view(torch.int32).long() - want.view(torch.int32).long()
    return float(d.abs().max()) if d.numel() else 0.0


def _eager_ms(torch, fn, calls=3):
    """Per-call ms of eager ``fn`` between CUDA events: the median of
    ``calls`` calls, and all of them."""
    times = []
    for _ in range(calls):
        s0 = torch.cuda.Event(enable_timing=True)
        e0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        fn()
        e0.record()
        e0.synchronize()
        times.append(s0.elapsed_time(e0))
    return sorted(times)[len(times) // 2], times


def _gather_traffic(torch, ids, n, lo, g, b):
    """Bytes of K1 on a ``[*, b, n]`` vals at planes ``lo..lo+g``: the
    word bound (the ids, each distinct addressed word and each output word
    once) and the 32-byte sectors the reads touch (information beside the
    bound: the access pattern's floor)."""
    q = ids.shape[1]
    dev = ids.device
    ok = (ids >= 0) & (ids < n)
    bi, qi = ok.nonzero(as_tuple=True)
    col = ids[bi, qi].long()
    uniq = int(torch.unique(bi * n + col).numel())
    words = 4 * (b * q + g * uniq + g * b * q)
    gi = torch.arange(lo, lo + g, device=dev)[:, None]
    addr = (gi * b + bi[None]) * n + col[None]
    sectors = int(torch.unique(addr >> 3).numel())
    return words, 32 * sectors + 4 * (b * q + g * b * q)


def _scatter_traffic(torch, ids, n, lo, g, b):
    """Bytes of K3 (the in-place scatter with its winners resolved): the
    word bound (the ids, and each winner's update word read and vals word
    written once per plane) and the 32-byte sectors touched by the update
    reads and the vals writes."""
    q = ids.shape[1]
    dev = ids.device
    qi_all = torch.arange(q, device=dev).expand(b, q)
    ok = (ids >= 0) & (ids < n)
    key = torch.where(ok, torch.arange(b, device=dev)[:, None] * n + ids,
                      -1).long()
    # The last q of each (b, id) wins.
    last = torch.full((b * n + 1,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, torch.where(ok, key, b * n).reshape(-1),
                         qi_all.reshape(-1), reduce='amax')
    win = ok & (last[torch.where(ok, key, b * n)] == qi_all)
    bi, qi = win.nonzero(as_tuple=True)
    col = ids[bi, qi].long()
    k = int(bi.numel())
    words = 4 * (b * q + 2 * g * k)
    gi = torch.arange(g, device=dev)[:, None]
    out_addr = ((gi + lo) * b + bi[None]) * n + col[None]
    upd_addr = (gi * b + bi[None]) * q + qi[None]
    sectors = int(torch.unique(out_addr >> 3).numel() +
                  torch.unique(upd_addr >> 3).numel())
    return words, 32 * sectors + 4 * b * q


def _changed_words(torch, before, after):
    """The 32-bit words in which two buffers differ."""
    torch.cuda.synchronize()
    return int((before.view(torch.int32) != after.view(torch.int32)).sum())


def _walker_bound(n_rows, r_words, n_int_pad, wp, k, b, n_widths, w,
                  changed):
    """K5's bound (ms, 'bytes' or 'operations').  Bytes: the rows read
    once; the words of the rows and of the min rows that this run's launch
    changed, written once (the min rows are never read, and a word that a
    launch leaves as it was needs no write); the draws, betas and log2
    dims read once; pos, min_lt and applied read and written once.
    Operations: the width trees per walk (W*32 terms and adds each, over
    pow2(W) words) and the total's exp2 and adds per iteration, in
    float32."""
    nbytes = 4 * (b * n_rows * r_words + changed + 3 * k * P_IM * b + k +
                  32 * w + 2 * b * P_IM + 4 * b)
    flops = k * b * (P_IM * (n_widths * 2 * wp * 32 + 16) + 2 * n_int_pad)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_OPS_PER_S
    log(f'  bound: bytes {nbytes} ({t_bytes:.4f} ms), float32 operations '
        f'{flops} ({t_ops:.4f} ms)')
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def _time_walker_im(torch, gen, im_runner, log2d_w32, width_route):
    """One K5-IM timing: ``(ms, plain_ms, bound_ms, bound_by, err)`` (see
    phase_times)."""
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw
    dev = torch.device('cuda')
    st, pos, cfg = im_runner.states, im_runner._mw_pos, im_runner.cfg
    n, b = st.c0.shape
    w = cfg.n_lanes
    betas = torch.linspace(0.0, 60.0, K_CHUNK, device=dev)
    draws = smw.draw_chunk(gen, cfg.n_leaves, K_CHUNK, P_IM, b)
    got, mg = kw.run_walker(st, betas, log2d_w32, cfg, P_IM, pos,
                            draws=draws)
    want, mw = kw.run_walker_plain(st, betas, log2d_w32, cfg, P_IM, pos,
                                   draws=draws)
    err = max(_batch_err(torch, got, want),
              _max_abs_err(torch, mg['pos'], mw['pos']),
              abs(int(mg['applied']) - int(mw['applied'])))

    def launch(ops):
        kw.launch_walker(ops['rows'], ops['min_rows'], ops['pos_bp'],
                         ops['min_lt'], ops['applied'], ops['draws'],
                         ops['betas'], ops['log2d'], cfg, n, w)

    # The words one launch changes, for the bound.
    ops = kw.kernel_inputs(st, betas, log2d_w32, pos, draws)
    before = ops['rows'].clone(), ops['min_rows'].clone()
    launch(ops)
    changed = (_changed_words(torch, before[0], ops['rows']) +
               _changed_words(torch, before[1], ops['min_rows']))
    del before
    ops = kw.kernel_inputs(st, betas, log2d_w32, pos, draws)
    ms = _time_ms(torch, lambda: launch(ops), reps=3, rounds=5)
    plain, plain_times = _eager_ms(torch, lambda: kw.run_walker_plain(
        st, betas, log2d_w32, cfg, P_IM, pos, draws=draws))
    log(f'time walker_im ({width_route} widths): plain calls (ms) '
        f'{plain_times}; words changed by one launch {changed}')
    bound, by = _walker_bound(n, ops['rows'].shape[2],
                              1 << max(0, (n - cfg.n_leaves - 1).bit_length()),
                              1 << max(0, (w - 1).bit_length()), K_CHUNK, b,
                              2, w, changed)
    return ms, plain, bound, by, float(err)


def _time_walker_fw(torch, gen, fw_runner, log2d_w32, ul, width_route):
    """One K5-FW timing, as :func:`_time_walker_im`."""
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import walker as kw
    dev = torch.device('cuda')
    st, pos, cfg = fw_runner.states, fw_runner._mw_pos, fw_runner.cfg
    n, b = st.c0.shape
    w = cfg.n_lanes
    k = UPDATE_SLICES
    betas = torch.linspace(30.0, 60.0, k, device=dev)
    dr = {name: x.to(torch.float32 if name == 'u' else torch.int32)
          .contiguous() for name, x in
          smw.draw_chunk(gen, cfg.n_leaves, k, P_IM, b).items()}
    mw = float(fw_runner.max_width)
    seg_k = kw.kernel_inputs_fw(st, pos)
    seg_p = kw.kernel_inputs_fw(st, pos)
    kw.launch_walker_fw(seg_k, dr, betas, log2d_w32, cfg, mw, False)
    kw.walker_fw_segment_plain(seg_p, dr, betas, log2d_w32, cfg, mw, False,
                               ul)
    err = max(_max_abs_err(torch, seg_k[x], seg_p[x])
              for x in ('rows', 'pos_bp', 'min_lt', 'applied'))
    got = kw.unpack_rows_fw(seg_k['min_rows'], w)
    want = kw.unpack_rows_fw(seg_p['min_rows'], w)
    err = max([err] + [_max_abs_err(torch, got[i], want[i])
                       for i in (0, 1, 2, 4, 6)])
    seg_t = kw.kernel_inputs_fw(st, pos)
    # seg_t is seg_k before its launch: the words that launch changed.
    changed = (_changed_words(torch, seg_t['rows'], seg_k['rows']) +
               _changed_words(torch, seg_t['min_rows'], seg_k['min_rows']))
    ms = _time_ms(torch, lambda: kw.launch_walker_fw(
        seg_t, dr, betas, log2d_w32, cfg, mw, False), reps=3, rounds=5)
    plain, plain_times = _eager_ms(torch, lambda: kw.walker_fw_segment_plain(
        seg_p, dr, betas, log2d_w32, cfg, mw, False, ul))
    log(f'time walker_fw ({width_route} widths): K={k}; plain calls (ms) '
        f'{plain_times}; words changed by one launch {changed}')
    # As K5-IM on the FW rows (N + 1 rows of R words), with four width
    # trees per walk (new, sliced new, and the two costs).
    n1, r_words = seg_t['rows'].shape[1:]
    bound, by = _walker_bound(n1, r_words,
                              1 << max(0, (n - cfg.n_leaves - 1).bit_length()),
                              1 << max(0, (w - 1).bit_length()), k, b, 4, w,
                              changed)
    return ms, plain, bound, by, float(err)


def claim_times(torch):
    """The claim kernel at CLAIM_SHAPES: device ms a launch (CUDA graph,
    median), the plain version's (graph, and eager between events: the
    host's issue time of its ~5 launches a walk is what the engines paid),
    and the bound, 22 B a walk (five int32 ids and the accept byte in, the
    keep byte out) over the HBM rate.  No single PyTorch call computes the
    scan, so no library time."""
    from tnco_tpu_torch.kernels import claim as kc
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = []
    for what, b, p, n in CLAIM_SHAPES:
        accept, ev = _claim_case(torch, gen, b, p, n)
        ids = [ev[k] for k in 'abcde']
        keep = torch.empty((b, p), dtype=torch.bool, device=dev)
        want = kc.claim_disjoint_plain(accept, ev)
        kc._launch(accept, ids, keep)
        err = _max_abs_err(torch, keep.int(), want.int())
        ms = _time_ms(torch, lambda: kc._launch(accept, ids, keep))
        plain = _time_ms(torch, lambda: kc.claim_disjoint_plain(accept, ev),
                         reps=2, rounds=5)
        eager, _ = _eager_ms(torch, lambda: kc.claim_disjoint_plain(
            accept, ev), calls=5)
        out.append(dict(shape=what, dims=f'B={b} P={p} n={n}',
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        plain_eager_ms=eager,
                        bound_ms=1e3 * 22 * b * p / HBM_BYTES_PER_S,
                        bound_by='bytes', library_ms=None))
        log(f'time claim_disjoint ({what}, B={b} P={p}): kernel {ms:.4f} '
            f'ms, plain {plain:.4f} ms (graph), {eager:.4f} ms (eager), '
            f"bound {out[-1]['bound_ms']:.4f} ms")
    return out


def phase_times(torch, counts, im_runner, fw_runner):
    """Kernel, plain, library and bound times at the main-path shapes;
    ``counts`` maps each path's phase to its launch counts."""
    from tnco_tpu_torch.kernels import gather as kg
    from tnco_tpu_torch.kernels import sa_multiwalk as smw
    from tnco_tpu_torch.kernels import scatter as ks
    from tnco_tpu_torch.kernels import walker as kw
    from tnco_tpu_torch.testing.utils import mixed_log2d_table
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []

    def row(name, ms, plain_ms, lib_ms, bound_ms, bound_by, err):
        paths = MAIN_PATHS.get(name, ('fw_app',))
        rows.append(dict(
            name=name, route='cuda', source=SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(counts[p][name] for p in paths),
            paths={k: v[name] for k, v in counts.items()}, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))

    def byte_row(name, ms, plain_ms, lib_ms, nbytes, err):
        row(name, ms, plain_ms, lib_ms, 1e3 * nbytes / HBM_BYTES_PER_S,
            'bytes', err)

    # K1 at its three shape classes on the main path: the walks engine's
    # W-plane index gather at {B, A, C, c0(B), c1(B)} (Q = 5P; the row's
    # own numbers), and, under 'shapes', the plane slicer's sorted-space
    # gather of [K=128, B, w] rows at [B, nbp] word ids (the row route)
    # and a small pull (the scalar rows at B: 5 planes, Q = P).  Each
    # shape has its word bound and, beside it, the bytes of the 32-byte
    # sectors its reads touch.
    f = 2 * W + 5
    vals = torch.randint(-2**31, 2**31 - 1, (f, B, N_PAD), generator=gen,
                         device=dev, dtype=torch.int32)
    rows_wb = torch.randint(-2**31, 2**31 - 1, (128, B, W), generator=gen,
                            device=dev, dtype=torch.int32)
    word_q = torch.randint(0, W, (B, 32 * W), generator=gen, device=dev,
                           dtype=torch.int32)
    # The lockstep sweep's state at the default fuse: F_BATCHED planes of
    # [64, 855]; a walk step reads one row of every plane, writes rows a
    # and b of every plane (about half the replicas accept: -1 for the
    # rest).
    vals_b = torch.randint(-2**31, 2**31 - 1, (F_BATCHED, B, N_BATCHED),
                           generator=gen, device=dev, dtype=torch.int32)
    k1 = []
    for what, v, (lo, hi), ids in (
            ('walks index', vals, (0, W),
             _rand_ids(torch, gen, B, 5 * P, 3241, frac_high=0.0)),
            ('slicer sorted', rows_wb, (0, 128), word_q),
            ('small pull', vals, (2 * W, f),
             _rand_ids(torch, gen, B, P, 3241, frac_high=0.0)),
            ('batched row', vals_b, (0, F_BATCHED),
             _unique_ids(torch, gen, B, 1, N_BATCHED, keep=1.0))):
        n, q = v.shape[2], ids.shape[1]
        got = kg.gather_gbn(v, ids, planes=(lo, hi))
        err = _max_abs_err(torch, got, kg.gather_plain(v, ids, (lo, hi)))
        words, sectors = _gather_traffic(torch, ids, n, lo, hi - lo, B)
        safe = ids.clamp(0, n - 1).long()[None].expand(hi - lo, -1, -1)
        v0 = v[lo:hi]
        ms = _time_ms(torch, lambda: kg.gather_gbn(v, ids, planes=(lo, hi)))
        plain = _time_ms(torch, lambda: kg.gather_plain(v, ids, (lo, hi)))
        lib = _time_ms(torch, lambda: torch.gather(v0, 2, safe))
        k1.append(dict(shape=what, route=kg.gather_route(n, q),
                       dims=f'G={hi - lo} B={B} N={n} Q={q}',
                       max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=1e3 * words / HBM_BYTES_PER_S,
                       bound_by='bytes', library_ms=lib,
                       sector_bytes=sectors))
    main, more = k1[0], k1[1:]
    row('gather_gbn', main['ms'], main['plain_ms'], main['library_ms'],
        main['bound_ms'], 'bytes', main['max_abs_err'])
    rows[-1].update(shape=main['shape'], route_taken=main['route'],
                    sector_bytes=main['sector_bytes'], shapes=more)

    # K2: ids [64, 256] -> [64, 3328] (the {B, A} merged apply's ids; on
    # the bench path since the in-place scatter resolves its own winners).
    # Floor: an empty kernel on its grid (measured with P1's floors below).
    ids = _unique_ids(torch, gen, B, 2 * P, 3241)
    inv = ks.inv_ids(ids, N_PAD)
    err = _max_abs_err(torch, inv, ks.inv_ids_plain(ids, N_PAD))
    nbytes = 4 * (B * 2 * P + B * N_PAD)
    ok = (ids >= 0) & (ids < N_PAD)
    safe = torch.where(ok, ids, N_PAD).long()
    qi = torch.arange(2 * P, device=dev,
                      dtype=torch.int32).expand(B, 2 * P).contiguous()
    buf = torch.full((B, N_PAD + 1), -1, dtype=torch.int32, device=dev)
    ms = _time_ms(torch, lambda: ks.inv_ids(ids, N_PAD))
    plain = _time_ms(torch, lambda: ks.inv_ids_plain(ids, N_PAD))
    lib = _time_ms(torch, lambda: buf.scatter_reduce_(1, safe, qi, 'amax'))
    byte_row('inv_ids', ms, plain, lib, nbytes, err)
    inv_row = rows[-1]
    inv_row.update(route_taken='sliced',
                   grid=f'{B * ks.inv_slices(N_PAD)} x 256')

    # K3: the merged {B, A} apply, 132 planes, Q = 2P, in place: the whole
    # scatter_rows_inplace call, one launch that resolves its winners
    # (the first design's call was K2 then K3: 0.0021 + 0.0642 ms in
    # PERF.md).
    upd = torch.randint(-2**31, 2**31 - 1, (F_APPLY, B, 2 * P),
                        generator=gen, device=dev, dtype=torch.int32)
    v1 = vals.clone()
    v2 = vals.clone()
    ks.scatter_rows_inplace(v1, ids, upd, planes=(0, F_APPLY))
    ks.scatter_rows_inplace_plain(v2, ids, upd, (0, F_APPLY))
    err = _max_abs_err(torch, v1, v2)
    nbytes, sectors = _scatter_traffic(torch, ids, N_PAD, 0, F_APPLY, B)
    route = ks.scatter_route(N_PAD, 2 * P)
    ms = _time_ms(torch, lambda: ks._launch_scatter(
        v1, ids, upd, 0, F_APPLY, route))
    plain = _time_ms(torch, lambda: ks.scatter_rows_inplace_plain(
        v2, ids, upd, (0, F_APPLY)))
    k = int(ok.sum())
    bi, qi_ = ok.nonzero(as_tuple=True)
    ni = ids[bi, qi_].long()
    gi = torch.arange(F_APPLY, device=dev)[:, None].expand(-1, k)
    vals_k = upd[:, bi, qi_].contiguous()
    v3 = vals.clone()
    lib = _time_ms(torch, lambda: v3.index_put_(
        (gi, bi.expand(F_APPLY, -1), ni.expand(F_APPLY, -1)), vals_k))
    byte_row('scatter_rows_inplace', ms, plain, lib, nbytes, err)
    rows[-1].update(route_taken=route, sector_bytes=sectors)
    # K3 at the lockstep sweep's write of rows a and b over every plane.
    ids_b = _unique_ids(torch, gen, B, 2, N_BATCHED, keep=0.5)
    upd_b = torch.randint(-2**31, 2**31 - 1, (F_BATCHED, B, 2),
                          generator=gen, device=dev, dtype=torch.int32)
    w1, w2 = vals_b.clone(), vals_b.clone()
    ks.scatter_rows_inplace(w1, ids_b, upd_b)
    ks.scatter_rows_inplace_plain(w2, ids_b, upd_b)
    err_b = _max_abs_err(torch, w1, w2)
    words, sectors = _scatter_traffic(torch, ids_b, N_BATCHED, 0, F_BATCHED,
                                      B)
    route = ks.scatter_route(N_BATCHED, 2)
    ok = ids_b >= 0
    bi, qi_ = ok.nonzero(as_tuple=True)
    gi = torch.arange(F_BATCHED, device=dev)[:, None].expand(-1, bi.numel())
    idx = (gi, bi.expand(F_BATCHED, -1),
           ids_b[bi, qi_].long().expand(F_BATCHED, -1))
    vals_k = upd_b[:, bi, qi_].contiguous()
    rows[-1]['shapes'] = [dict(
        shape='batched rows', route=route,
        dims=f'G={F_BATCHED} B={B} N={N_BATCHED} Q=2', max_abs_err=err_b,
        ms=_time_ms(torch, lambda: ks._launch_scatter(
            w1, ids_b, upd_b, 0, F_BATCHED, route)),
        plain_ms=_time_ms(torch, lambda: ks.scatter_rows_inplace_plain(
            w2, ids_b, upd_b)),
        bound_ms=1e3 * words / HBM_BYTES_PER_S, bound_by='bytes',
        library_ms=_time_ms(torch, lambda: w2.index_put_(idx, vals_k)),
        sector_bytes=sectors)]
    log(f'time scatter_rows_inplace: one launch per call, {ms:.4f} ms '
        '(first design: inv_ids 0.0021 + K3 0.0642 = 0.0663 ms, PERF.md)')

    # K4: the same 132 planes out of place, on NULL-free unique ids (so
    # that one index_put, out of place, computes the same function).  The
    # kernel is timed with its inversion precomputed (K2 has its own row).
    ids = _unique_ids(torch, gen, B, 2 * P, N_PAD, keep=1.0)
    inv = ks.inv_ids(ids, N_PAD)
    v4 = vals[:F_APPLY]
    out = torch.empty_like(v4)
    got = ks.scatter_rows_gbn(vals, ids, upd, planes=(0, F_APPLY))
    err = _max_abs_err(torch, got, ks.scatter_rows_gbn_plain(
        vals, ids, upd, (0, F_APPLY)))
    nbytes = 4 * (2 * F_APPLY * B * N_PAD + B * N_PAD + F_APPLY * B * 2 * P +
                  B * 2 * P)
    ms = _time_ms(torch, lambda: ks._launch_scatter_gbn(vals, inv, upd, out,
                                                        0))
    plain = _time_ms(torch, lambda: ks.scatter_rows_gbn_plain(
        vals, ids, upd, (0, F_APPLY)))
    bi = torch.arange(B, device=dev)[:, None].expand(B, 2 * P).reshape(-1)
    ni = ids.reshape(-1).long()
    gi = torch.arange(F_APPLY, device=dev)[:, None].expand(-1, bi.numel())
    vals_k = upd.reshape(F_APPLY, -1)
    idx = (gi, bi.expand(F_APPLY, -1), ni.expand(F_APPLY, -1))
    err = max(err, _max_abs_err(torch, v4.index_put(idx, vals_k), got))
    lib = _time_ms(torch, lambda: v4.index_put(idx, vals_k))
    byte_row('scatter_rows_gbn', ms, plain, lib, nbytes, err)
    log(f'time scatter_rows_gbn: bytes {nbytes}')

    # P1 at the probe's default shape: state [3328, 128], ids [256, 128]
    # with repeats.  Bound: the state, the ids and the output once each;
    # the probe's own figure is ns per row op (loop 2 R P, take R P).
    # Floors: the loop's 2 R barriers alone on its grid; an empty kernel
    # on the take's grid plus its row bytes at the card's L2 read rate.
    # No single PyTorch call computes the round loop, or gathers and sums
    # int32 rows (state[ids].sum(0, dtype=torch.int32) is two calls), so
    # neither row has a library time.
    from tnco_tpu_torch.benchmarks import gather_probe as gp
    state = torch.randint(0, 1 << 20, (N_PAD, gp.COLS), generator=gen,
                          device=dev, dtype=torch.int32)
    pids = torch.randint(0, N_PAD, (PROBE_R, PROBE_P), generator=gen,
                         device=dev, dtype=torch.int32)
    floors = probe_floors(torch, state, PROBE_P, PROBE_R,
                          B * ks.inv_slices(N_PAD))
    inv_row.update(floor_ms=floors['empty_ms'],
                   floor='an empty kernel on the same grid')
    nbytes = 4 * (N_PAD * gp.COLS + PROBE_R * PROBE_P + PROBE_P * gp.COLS)
    for impl, reps in (('loop', 20), ('take', 50)):
        err = _max_abs_err(torch, gp.probe(state, pids, impl),
                           gp.probe_plain(state, pids, impl))
        ms = _time_ms(torch, lambda: gp.probe(state, pids, impl), reps=reps,
                      rounds=5)
        plain = _time_ms(torch, lambda: gp.probe_plain(state, pids, impl),
                         reps=reps if impl == 'take' else 1, rounds=5)
        byte_row(f'probe_{impl}', ms, plain, None, nbytes, err)
        rows[-1]['library_note'] = (
            'none: no single PyTorch call computes the round loop' if
            impl == 'loop' else 'none: no single PyTorch call gathers and '
            'sums int32 rows (state[ids].sum(0, dtype=torch.int32) is two '
            'calls)')
        if impl == 'loop':
            rows[-1].update(
                route_taken=gp.loop_route(N_PAD, PROBE_P),
                grid=f"{floors['loop_grid']} (one column a block)",
                floor_ms=floors['loop_ms'],
                floor=f'{2 * PROBE_R} barriers alone on the same grid')
        else:
            rows[-1].update(
                floor_ms=floors['take_ms'], l2_tb_per_s=floors['l2_tb_per_s'],
                floor=f"an empty kernel on its grid plus "
                f"{floors['take_bytes']} B of rows at the L2 read rate "
                f"{floors['l2_tb_per_s']:.3f} TB/s")
        n_ops = PROBE_R * PROBE_P * (2 if impl == 'loop' else 1)
        log(f'time probe_{impl}: {n_ops} row ops, {1e6 * ms / n_ops:.4f} '
            f"ns/row; bytes {nbytes}; floor {rows[-1]['floor_ms']:.4f} ms "
            f"({rows[-1]['floor']})")
    log(f"time inv_ids: floor {floors['empty_ms']:.4f} ms (an empty kernel "
        f"on its grid of {inv_row['grid']} threads)")

    # K5 at the IM flagship's shape and state: B=64, P=8, K=128, with
    # the network's log2 dims (all 1: the kernel's popcount width route,
    # the one every main-path launch took) and, under the row's
    # 'tree_route', with a mixed table of the same shape (the tree route;
    # the kernel picks it from the data, so no main-path launch took it).
    # Each timing starts from the flagship's state; the launches update
    # their buffers in place, so the timed launches go on annealing it.
    # The plain version is timed per call with events around it: it is
    # eager PyTorch whose host issue time is part of what it costs.
    # K5-FW at the FW walker flagship's state the same two ways: one
    # segment of UPDATE_SLICES iterations (the segment between two
    # reslices), B=64, P=8, no deferred snapshot.
    im = (_time_walker_im(torch, gen, im_runner, im_runner.log2d_w32,
                          'popcount'),
          _time_walker_im(torch, gen, im_runner,
                          mixed_log2d_table(im_runner.log2d_w32), 'tree'))
    fw = (_time_walker_fw(torch, gen, fw_runner, fw_runner.log2d_w32,
                          fw_runner.uniform_log2, 'popcount'),
          _time_walker_fw(torch, gen, fw_runner,
                          mixed_log2d_table(fw_runner.log2d_w32), None,
                          'tree'))
    for name, (popcount, tree) in (('walker_im', im), ('walker_fw', fw)):
        ms, plain, bound, by, err = popcount
        row(name, ms, plain, None, bound, by, err)
        ms, plain, bound, by, err = tree
        rows[-1].update(width_route='popcount', tree_route=dict(
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None))
    claim = claim_times(torch)
    main = claim[0]
    row('claim_disjoint', main['ms'], main['plain_ms'], None,
        main['bound_ms'], 'bytes', main['max_abs_err'])
    rows[-1].update(shape=main['shape'], dims=main['dims'],
                    plain_eager_ms=main['plain_eager_ms'], shapes=claim[1:],
                    library_note='none: no single PyTorch call computes '
                    'the priority scan')
    log(f'time walker_fw: launches per app phase '
        f'{counts["fw_walker_app"]["walker_fw"]}, per flagship chunk '
        f'{counts["fw_walker_flagship"]["walker_fw"] / 2}')
    for r in rows:
        name = r['name']
        for what, x in ([(name, r), (f'{name} (tree route)',
                                      r.get('tree_route'))] +
                        [(f"{name} ({x['shape']})", x)
                         for x in r.get('shapes', ())]):
            if x is None:
                continue
            if x['max_abs_err'] != 0:
                fail(f'{what}: timing inputs disagree with the plain '
                     'version')
            lib = 'none' if x['library_ms'] is None else \
                f"{x['library_ms']:.4f} ms"
            sec = '' if 'sector_bytes' not in x else \
                f", sectors {x['sector_bytes']} B " \
                f"({1e3 * x['sector_bytes'] / HBM_BYTES_PER_S:.4f} ms)"
            log(f"time {what}: kernel {x['ms']:.4f} ms, plain "
                f"{x['plain_ms']:.4f} ms, library {lib}, "
                f"bound {x['bound_ms']:.4f} ms ({x['bound_by']}){sec}")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    try:
        import tnco_tpu_torch  # noqa: F401
    except ImportError:
        print('chip_smoke: run from the repository root (tnco_tpu_torch '
              'not found)', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    walls, last = {}, [t_start]

    def lap(name):
        """Records the wall seconds since the last lap under ``name``."""
        now = time.perf_counter()
        walls[name] = round(now - last[0], 1)
        last[0] = now

    try:
        card = phase_card_and_build(torch)
        lap('1 card and build')
        phase_kernels(torch)
        phase_walker_checks(torch)
        phase_walker_fw_checks(torch)
        phase_k4_p1_checks(torch)
        phase_claim_checks(torch)
        lap('2 kernel checks')
        counts = {'fw_app': phase_app(torch)}
        lap('3 FW app')
        counts['fw_flagship'], fw_trees, fw_paths = phase_flagship(torch,
                                                                   card)
        lap('4 FW flagship')
        counts['im_app'] = phase_app_im(torch)
        lap('5 IM app')
        counts['im_flagship'], im_runner = phase_flagship_im(torch, card)
        lap('6 IM flagship')
        counts['fw_walker_app'] = phase_app_fw_walker(torch)
        lap('7 FW walker app')
        counts['fw_walker_flagship'], fw_runner = phase_flagship_fw_walker(
            torch, card)
        lap('8 FW walker flagship')
        counts['bench'] = phase_bench(torch)
        lap('9 bench')
        counts['batched_fw_app'] = phase_app_batched(torch, fw=True)
        counts['batched_im_app'] = phase_app_batched(torch, fw=False)
        lap('11-12 batched apps')
        counts['batched_fw_flagship'], ctrees, fw_prof = \
            phase_flagship_batched(torch, card, fw=True)
        counts['batched_im_flagship'], _, im_prof = phase_flagship_batched(
            torch, card, fw=False)
        lap('13 batched flagships')
        phase_batched_card_vs_cpu(torch, ctrees)
        lap('14 batched card vs CPU')
        counts['fw_product'], product = phase_product_point(torch, card,
                                                            fw_trees)
        lap('15 product point')
        phase_exchange_kick_card_vs_cpu(torch, product)
        lap('18 exchange and kick card vs CPU')
        counts['fw_throughput'] = phase_throughput_point(torch, card,
                                                         fw_trees)
        lap('16 throughput point')
        counts['fw_tempering'] = phase_tempering(torch, card, product)
        lap('17 tempering')
        counts.update(phase_circuits(torch))
        lap('19 circuits')
        phase_cli(torch)
        lap('20 CLI')
        counts['sampler'] = phase_sampler(torch)
        lap('21 sampler')
        counts.update(phase_sparse(torch))
        lap('22 sparse')
        counts.update(phase_walk_variants_float64(torch, card, product))
        lap('23 walk variants and float64')
        sweep_counts, sweep_runners = phase_sweep(torch, card)
        counts.update(sweep_counts)
        lap('24 sweep')
        counts.update(phase_native_mesh(torch, card, fw_trees, fw_paths))
        lap('25 native and mesh')
        counts.update(phase_examples_host_api(torch, card, fw_trees,
                                              sweep_runners))
        lap('26 examples and host API')
        counts.update(phase_stacking(torch, card, fw_trees))
        lap('27 stacking')
        rows = phase_times(torch, counts, im_runner, fw_runner)
        lap('10 kernel times')
        phase_batched_launches(torch, card, (fw_prof, im_prof))
        lap('13 batched launches')
    finally:
        try:
            from joblib.externals.loky import get_reusable_executor
            get_reusable_executor().shutdown(wait=True)
        except ImportError:
            pass
    log(f'phase wall s: {json.dumps(walls)}')
    log(f'total: {time.perf_counter() - t_start:.1f} s')
    print(card)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
