#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnngls_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--k4_against SRC]

Phases, each printed with the elapsed seconds; any failure exits non-zero
and prints no result line:
  0. the card (nvidia-smi name and power limit); build the kernels with nvcc.
  1. the GAT group kernel against its plain twin on the card: layer-0
     activations of the shipped tsp100 checkpoint (B=2, n=100, H=8, F=16) and
     seeded inputs with a 10x spread (B=3, n=20, H=4, F=8).
  2. the whole-GLS kernel against its plain twin on the card, for
     (n, B, iters, pm) in (20, 8, 5, 4), (50, 4, 5, 8), (100, 2, 3, 20) under
     the weight guide, a regret-like guide and a two-guide cycle: tours,
     moves, traces and work counters identical.
  3. the main path: gnngls_tpu_torch.evaluate.evaluate on the 500 tsp100 test
     instances with the shipped checkpoint, guide regret_pred, n_iters=100,
     perturbation_moves=20, batch_size=64, with the launch counts reset just
     before and read just after; tours checked, and instances 0-63 held
     against the committed JAX fixture (mean gap within 0.1 pp); the gap
     and the fixture count printed beside those of the kernels before K1's
     and K2's redesign for the H100.
  4. both kernels timed (CUDA events) and held against their twins at the
     main path's shapes (K2: B=64 n=100 H=8 F=16; K1: B=500 n=100 G=1
     n_iters=100 pm=20), with their bounds.
  5. K3's route, the sorted-prefix GAT kernel (csrc/gat_sorted.cu), against
     its plain twin and against K3's plain arithmetic on the card: layer-0
     activations of the checkpoint on two seeded n=500 instances (gs=16)
     and seeded inputs with a 10x spread (n=40 H=4 F=8 gs=8).
  6. the whole-GLS kernel's global layout: bit for bit equal to the shared
     layout at n=100 (B=8, weight guide and a two-guide cycle), to its plain
     twin at n=500 (B=2, n_iters=3, pm=30), and valid tours at n=1000.
  7. the tsp500 path, with the launch counts reset just before and read just
     after: generate_instances(128, 500, seed=3, solver="gls",
     opt_iters=100) (the GLS oracle), TSPDataset.from_arrays with the tsp100
     scalers and zero regret, and evaluate(guide regret_pred, n_iters=40,
     perturbation_moves=20, batch_size=16); tours checked, gaps against the
     oracle (the mean beside the one before K1's and K2's redesign), moves/s,
     edges/s, stage times and peak memory.
  8. the n=200 JAX fixture: predictions within 5e-4 and best costs of the
     search equal to gnngls_tpu's (gnngls_tpu_torch/testdata/).
  9. K3's route (the sorted-prefix kernel), K2 (the route's alternative) and
     K1's global layout timed at the tsp500 path's shapes and held against
     their twins there (K3's route also against K3's arithmetic), with
     bounds.
 10. the per-head matmul partials (K4, on the tensor cores in 3xTF32)
     against their plain twin on seeded inputs at n = 3, 10, 50, 100, 111
     (B=2); K4 merged against K2 merged on the checkpoint's layer 0 at B=64
     n=100, both timed there, with K4's tensor-core operations (and, with
     --k4_against SRC, K4 built from SRC, held and timed in turns with
     them); the pallas_mxu route at n=120, which warns and runs K3; and K4 at n=2074
     (H=1, F=16), the first n whose block does not fit, which raises
     ValueError.
 11. the tsp100 pallas_mxu path, with the launch counts reset just before and
     read just after: predict_regret(gat_impl="pallas_mxu") over the 500
     test instances at batch 64 (64 K4 launches, no K2), the predictions
     against phase 3's, then nearest neighbour on the regret and the search
     (n_iters 100, pm 20); instances 0-63 held against the JAX fixture.
 12. K5's route, the sorted-prefix kernel with f32 and bf16 payloads,
     against its plain twin and against K5's plain arithmetic (the
     threshold masks): seeded inputs with a 10x logit spread at n = 10 and
     100, constant features (tied maxima), the checkpoint's layer 0 on two
     n=500 instances and on the n=200 fixture, and seeded inputs at n=900
     F=32 (past K5's old block) and n=1100 F=16 (scanned in column slices);
     both modes timed at B=4 n=500, the f32 payloads also on the n=200
     fixture (the shape of its launches in phase 13); at n=3100, past the
     kernel's range, it raises ValueError.
 13. the tsp500 pallas_sep_fast path (benchmarks/tsp500_e2e.py's default
     forward) on phase 7's instances, with the launch counts reset just
     before and read just after: predict_regret(gat_impl="pallas_sep_fast",
     batch_size=4) (256 K5 launches, no K3), the predictions against phase
     7's K3 ones (max abs difference within 5e-3, Spearman at least
     0.9999), the search (n_iters 40,
     pm 20) and its gap against the oracle; then gat_impl="pallas_sep" on the
     n=200 JAX fixture, predictions within 5e-4.
 14. the rest of evaluation: (a) the per-move engine on the card against
     the same engine on the CPU, seeded (n, B) = (20, 8) and (50, 4), 5
     iterations, pm 8, both first_improvement values, one guide and a
     two-guide cycle: trace counts, chunk moves, best tours and trace costs
     identical; (b) run_fixed (the per-move engine) against
     run_fixed_kernel (K1) on tsp100 test instances 0-63 with phase 3's
     regret guide, n_iters 100, pm 20: accepted moves, best tours and the
     search's own best costs identical, and the JAX fixture held as in
     phase 3; (c) the default main path, with the launch counts reset just
     before and read just after: evaluate over the 500 instances, guide
     regret_pred, the default time_limit of 10 s, batch 64 (64 K2
     launches, no K1): tours, chunk boundaries, the deadline, progress
     rows, moves/s; (d) first-improvement: evaluate(guide weight,
     n_iters 20, pm 20) on instances 0-15 against the committed JAX
     fixture (moves equal, best costs within rtol 1e-6); (e) the 10 s
     protocol: calibrate_protocol_iters on the 500 instances at
     REFERENCE_10S_MOVES[100], weight guide, through K1; (f) the shipped
     checkpoint exported to a reference .pt under build/ and loaded back:
     predictions on instances 0-63 equal to the npz model's bit for bit.
 15. training (autograd through the plain routes; the sep routes' backward
     launches the rank-sums kernel, no other runs): (a) one train step on the
     card against the CPU (embed 32, 4 heads, depth 4, n=20, batch 8,
     seeded), in float64 and float32: loss,
     every gradient leaf and the BatchNorm running statistics; (b)
     train_model resumed from the shipped checkpoint (Adam at count 1638) on
     data/tsp100's 2000 train and 200 val instances at the shipped
     params.json settings (embed 128, 8 heads, depth 8, batch 32, the val
     set monitored) for exactly epoch 26, 63 steps, into a temporary run
     directory: start epoch, lr and the Adam count checked, losses finite
     and within twice the checkpoint's, steps/s, training edges/s and peak
     device memory printed; (c) that run's checkpoint through
     models.convert.load_model: K2's predictions on the 500 test instances
     (batch 64) against the fast route's, then evaluate at n_iters 100 and
     its mean gap; (d) epoch 26 resumed from the shipped checkpoint (Adam
     state included) through each route that trains, `fast`, `sep`,
     `sep_fast` and `bf16`, on the same batches: data/tsp100's first 512
     train instances (16 steps at batch 32) and its 200 val instances, with
     the launch counts reset just before each run and read just after (2
     rank-sums launches a layer a step in the sep routes, no other kernel);
     per route steps/s and training edges/s (the warm-up
     steps left out), peak device memory, train and val loss (each within
     twice the checkpoint's) and their relative distance from the `fast`
     run's; then the `sep_fast`-trained weights served through K2 and K1 on
     tsp100 test instances 0-63 (n_iters 100, pm 20), launches counted, tours
     checked, the mean gap beside phase 3's on the same instances; (e) the
     rank-sums kernel (the sep routes' adjoint) on the arguments of its first
     call in a sep train step on train instances 0-31, against its twin on
     the CPU bit for bit and timed beside it and torch.scatter_add; then sep
     and sep_fast steps with either adjoint, kernel or twin, in turns: two
     steps from one state (the kernel's must give the same gradients) and
     steps/s.
 16. data generation and regret labels (K1 with its k input): (a) K1 given a
     k per lane against its plain twin on the card, move for move: the warm
     forced-edge lanes of raw tsp100 instances 0-1 (all 4,950 edges, both
     splices: 19,800 lanes) at n_iters 2 and 0 (pm 20), the cold lanes of
     instance 0 at n_iters 10 pm 30; k=None equal to k set to the kernel's
     own default; (b) the production label path, with the launch counts
     reset just before and read just after: warm_labels_chunked on raw tsp100
     instances 0-63 from their shipped opt_tour (warm_gls_iters 0, dual
     splice, pm 20, chunk 250: 633,600 K1 lanes); instances 0-7 held to the
     committed JAX fixture (regret and opt_cost within 4 ulps of f32 at the
     big-M over opt_cost), agreement with the shipped labels printed, with
     instances/s, forced-edge problems/s, launches and peak device memory;
     K1 and its twin timed at one launch of that path, beside the time to
     build the launch's reduced matrices; (c) both data CLIs on the card:
     cli/generate_instances.py (32 instances, n=100, GLS oracle at
     opt_iters 100, warm labels), cli/preprocess_dataset.py, the result read
     with its scalers.json and one predict_regret batch through K2; (d) the
     native C++ oracle built on the card's host, against the numpy Held-Karp
     at n=12.
 17. the last slice (no new kernel; every number beside the card's name and
     power limit): (a) the `chunked` route: predict_regret(gat_impl=
     "chunked", batch 16) on phase 7's first 16 n=500 instances (city chunks
     of 10), within 5e-4 of phase 7's K3 predictions with Spearman at least
     0.9999, the search as phase 7's (n_iters 40, pm 20, K1's global layout)
     with valid tours and its mean gap beside phase 7's, edges/s, one
     forward's time and peak memory; then the n=200 JAX fixture through it,
     within 5e-4; (b) the `bf16` route over the 500 tsp100 test instances at
     batch 64: Spearman and max abs difference against phase 3's K2
     predictions, instances 0-1 within 2e-3 of the scale of the same route
     on the CPU, the search (n_iters 100, pm 20) and its gap beside phase 3's,
     edges/s, peak memory; (c) one `chunked` train step on the card against
     the CPU at phase 15a's shape and bars; one train step through each bf16
     route (`sep_fast`, `bf16`) at that shape, card against CPU: in float64
     within 1e-6 of each leaf, in float32 the loss and the largest gradient
     miss each within twice the CPU's own spread when the input features
     move by 1e-7 (relative, 16 seeded perturbations); their
     GATConv's gradient (x and the parameters) on the card equals the CPU's
     in float64 within 1e-4 of each leaf's scale; (d)
     best_probabilistic_nearest_neighbour (64 samples) on tsp100 instance 0
     under phase 3's regret, Gumbel noise from a seeded CPU generator: the
     card's tour equals the CPU's and is valid; (e) device_trace around one
     predict_regret batch (K2) and one run_fixed_kernel call (K1) in
     nested annotate regions: the exported Chrome trace holds the regions,
     the program's own spans (gnngls.predict, gnngls.search.kernel, ...)
     and CUDA kernels named gat_group and gls_whole; (f) a NCCL
     process group of one rank (multihost.initialize at a free local port),
     make_mesh(("data", "model")); forward_ring, forward_tp (after
     shard_params_tp) on tsp100 instances 0-3 at full width and
     gat_conv_sharded on the checkpoint's layer-0 input, each within 5e-4 of
     the `fast` route on the card; (g) make_sharded_gls (n_iters 100, pm 20)
     on instances 0-63 with phase 3's guide, launch counts reset just before
     and read just after: tours, costs and moves identical to
     run_fixed_kernel's (phase 14b's call); one make_dp_train_step step equal
     to train_step on the same batch in float64 (within 1e-6 of each leaf);
     then destroy_process_group.
 18. the repeat phase: each path twice in this process from the same inputs,
     compared bit for bit: (a) predict_regret on tsp100 test instances 0-63
     through auto (K2), pallas_mxu (K4), pallas_sep and pallas_sep_fast (K5),
     fast and bf16, and on phase 7's first 16 n=500 instances through K3's
     route, launches counted each time; (b) search_on_predictions (nearest
     neighbour, then K1) on those predictions, the shared layout at n_iters
     100 pm 20 and the global layout at n_iters 40 pm 20, and the per-move
     engine at phase 14b's call against phase 14b's run: tours, costs, moves,
     traces and work counters; (c) the label path (phase 16b's call) on raw
     tsp100 instances 0-7; (d) phase 15d's epoch once more through each route:
     every checkpoint array (parameters, BatchNorm running statistics, Adam
     state) and the losses equal to phase 15d's, each route's arrays printed
     as a sha256 so that two runs of the script compare too; then the second
     sep_fast run's weights through K2 and K1 on instances 0-63: the same
     tours and gaps.  Left out: the default 10 s path, whose deadline makes
     the move count depend on the clock, and the four-card layer.
 19. K1 and its callers past 1024 cities, and the caller's precision: (a) K1's
     global layout against its twin on the card, bit for bit, at n=1100 (two
     guides cycled) and n=2100 (k given); (b) each caller of K1
     (gls_oracle, gls_fixed_edge_costs, warm_fixed_edge_costs_batch at the
     MAX_D2_BYTES lane cap, make_sharded_gls under a new one-rank NCCL
     group, search_on_predictions) on seeded n=1100 instances through K1:
     launches, valid tours, seconds and peak memory; then gls_oracle on 512
     of them (the generator's default chunk), cut into launches by
     MAX_D2_BYTES; (c) a caller at set_float32_matmul_precision("high"),
     where a plain product moves (TF32), and at "highest": a tsp100 forward through
     K2, predict_regret on 64 instances and one `sep` train step give the
     same bits, and the caller's setting reads back after each call.
 20. nearest-neighbour construction (csrc/nearest_neighbor.cu) against its
     plain twin, the n - 1 steps of batched ops, at the fixed cells' request
     shapes (64 x 100, 16 x 500, 128 x 100): one launch, the same tours,
     both timed.
     Then the `kernels` JSON line and the result line.
It imports neither jax nor gnngls_tpu, pandas, networkx or matplotlib.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

T0 = time.time()
ROOT = pathlib.Path(__file__).resolve().parent
N_ITERS, PM, BATCH = 100, 20, 64
# the tsp500 path (benchmarks/tsp500_e2e.py's evaluation through the port)
N500, N_INST500, SEED500, ORACLE_ITERS, ORACLE_PM = 500, 128, 3, 100, 30
N_ITERS500, BATCH500 = 40, 16
PRED_TOL = 5e-4  # predictions against the JAX fixture (benchmarks/PARITY.md's scale)
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s on the tensor cores, at 700 W
K2_REL_TOL = 1e-5  # max |kernel - plain| <= K2_REL_TOL * max |plain|
K3_REL_TOL = 1e-5  # the same for K3's route, the sorted-prefix kernel (m equal)
K4_REL_TOL = 1e-5  # the same for the per-head matmul partials, and K4 merged vs K2 merged
K5_REL_TOL = 1e-5  # the same for K5's route, either payload type (m equal)
BATCH_SEP = 4  # tsp500_e2e.py's batch
# What the kernels before the H100 redesign of K1 and K2 gave on these paths (NVIDIA H100
# 80GB HBM3): printed beside this run's figures, which keep the same bits, and not held.
PARENT_GAP100, PARENT_FIXTURE_EQ, PARENT_GAP500 = (0.3743, 0.1621, 3.6090), 61, 1.2368
# K5-bf16 predictions against K3's at n=500: rank agreement, max abs difference
SPEARMAN_MIN, SEP_FAST_PRED_TOL = 0.9999, 5e-3
FORBIDDEN = ("jax", "gnngls_tpu", "pandas", "networkx", "matplotlib")
FIXTURE100 = "gnngls_tpu_torch/testdata/jax_tsp100_test64_it100.json"
FI_FIXTURE = "gnngls_tpu_torch/testdata/jax_tsp100_test16_fi_it20.json"
FI_RTOL = 1e-6  # best costs of the first-improvement search against the JAX fixture
# Training on the card against the CPU (phase 15a): the loss within TRAIN_LOSS_RTOL;
# each gradient leaf and running statistic within TRAIN_TOL64 (float64) or TRAIN_TOL32
# (float32) of its largest value, or of the largest over all leaves where its own is
# below VANISHING of that (a gradient that vanishes in exact arithmetic, as a bias
# before a BatchNorm has, holds only rounding noise).  float32 needs the wider bar:
# the two devices' f32 forwards may take different sides of a ReLU kink, which moves
# that FFN's gradients by about 1e-3 of their scale (1.2e-3 for the CPU's own f32
# against its f64 at this shape).
TRAIN_LOSS_RTOL, TRAIN_TOL64, TRAIN_TOL32, VANISHING = 1e-5, 1e-6, 1e-2, 1e-4
RESUME_EPOCH = 26  # the shipped checkpoint ends at epoch 25 (count 1638 = 26 x 63)
TRAIN_WARMUP = 3  # train steps left out of the steps/s figure
# Phase 15d: epoch 26 through each route that trains, on the first ROUTE_TRAIN_INST of
# data/tsp100's 2,000 train instances (16 steps at batch 32) and its 200 val instances.
TRAINED_ROUTES, ROUTE_TRAIN_INST = ("fast", "sep", "sep_fast", "bf16"), 512
STEP_TURNS = 6  # phase 15e: timed steps of each turn, either adjoint of the sep routes
# Phase 17c: a bf16 route's float32 train step on the card against the CPU.  A bf16
# rounding is a step, so the bar is the CPU's own spread: the largest relative change
# of its loss, and the largest per-leaf miss of its gradient, when the input features
# move by NOISE (relative, N_NOISE seeded perturbations), times SPREAD_FACTOR
# (tests/test_torch_train_bf16.py's bar against JAX).
# A leaf's miss is its error over GRAD_TOL of its scale, or over VANISHING_TOL of the
# largest where the f32 twin route's gradient of it is below VANISHING of the largest.
NOISE, N_NOISE, SPREAD_FACTOR, GRAD_TOL, VANISHING_TOL = 1e-7, 16, 2.0, 1e-4, 1e-5
F32_TWIN = {"bf16": "fast", "sep_fast": "sep"}
# The label path (phase 16b): raw tsp100 instances 0-63, the production settings.
LABEL_INST, LABEL_CHUNK, LABEL_PM = 64, 250, 20
LABEL_FIXTURE = "gnngls_tpu_torch/testdata/jax_tsp100_labels_0to7.npz"
# Label lanes are held to JAX within TIE_ULPS ulps of f32 at the lane's big-M: the
# packages' f32 cost sums differ in order, so of two tied tours they may keep either
# (tests/test_torch_labels.py).
TIE_ULPS = 4
# Phase 17: the bf16 route on the card against the CPU (tests/test_torch_gat_sep.py's
# BF16_VS_F32: eight layers carry the card's f32 noise through bf16 roundings); the
# bf16 routes' GATConv gradient, card against CPU in float64 (the CPU test's bar
# against JAX); the n=500 chunked predictions' batch; the construction's samples.
BF16_CARD_TOL, BF16_GRAD_TOL, BATCH_CHUNKED, N_CHUNKED, PNN_SAMPLES = 2e-3, 1e-4, 16, 16, 64
# What the sorted-prefix routes trained at in phase 15d before their fixed-order adjoint
# (NVIDIA H100 80GB HBM3, 700 W): printed beside this run's figures, not held.
PARENT_SEP_STEPS = {"sep": 4.544, "sep_fast": 4.331}
# Phase 18, the repeat phase: each path twice from the same inputs, compared bit for
# bit.  The routes predicted on tsp100 instances 0-63 and the kernel each launches
# (None: a plain route); the label path on raw tsp100 instances 0-7.
REPEAT_ROUTES = (("auto", "gat_group"), ("pallas_mxu", "gat_group_mxu"),
                 ("pallas_sep", "gat_sep"), ("pallas_sep_fast", "gat_sep"), ("fast", None),
                 ("bf16", None))
REPEAT_LABEL_INST = 8
# Phase 19: K1 and its callers past 1024 cities, and the caller's precision.  (a) K1
# against its twin at n = BEYOND_N and BEYOND_N2; (b) each caller on BEYOND_INST seeded
# instances at n = BEYOND_N, and the GLS oracle on ORACLE_CHUNK of them (the default
# chunk of data/generate.generate_instances_sharded); (c) ROUTE_INST tsp100 instances.
BEYOND_N, BEYOND_N2, BEYOND_INST, ORACLE_CHUNK, ROUTE_INST = 1100, 2100, 2, 512, 8
# Phase 20: construction at the fixed cells' request shapes (B, n).
CONSTRUCT_SHAPES = ((64, 100), (16, 500), (128, 100))


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errs(a, b):
    """(max abs error, max abs error / max |b|)."""
    d = float((a.double() - b.double()).abs().max())
    return d, d / max(float(b.double().abs().max()), 1e-30)


def hold(tag, got, wants, topo, tol):
    """The sorted-prefix kernel's partials against each (name, partials) of
    wants: m equal, z, num and the merge of the two groups of each edge
    within tol of the largest reference value, all finite.  Returns the
    largest absolute difference."""
    import torch

    from gnngls_tpu_torch.ops.gat_group import merge_group_partials

    worst = 0.0
    merged = merge_group_partials(*got, topo)
    for ref, want in wants:
        require(torch.equal(got[0], want[0]), f"{tag} vs {ref}: the maxima differ")
        parts = dict(zip(("z", "num"), zip(got[1:], want[1:])))
        parts["merged"] = (merged, merge_group_partials(*want, topo))
        for key, (a, b) in parts.items():
            require(bool(torch.isfinite(a).all()), f"{tag}: {key} not finite")
            ab, rel = errs(a, b)
            worst = max(worst, ab)
            log(f"  {tag} vs {ref}: {key:6s} max abs {ab:.3e}  rel {rel:.3e}")
            require(rel <= tol, f"{tag} vs {ref} {key}: rel err {rel:.3e} > {tol}")
    return worst


def gat_partials_work(B, n, H, F, h_bytes=4):
    """(operations, bytes) of the group partials' function (K2-K5 compute the
    same m, z, num) at this shape, its operations counted in the cheapest form
    known, the sorted prefix sums of ops/gat_sep.py.  Per (batch, city, head)
    group of K = n-1 edges: a sort of el (K log2 K compares); per source A, C
    (2 exps), the two payloads (2F products) and their prefix and suffix sums
    (2F+2 adds); per target a binary search (log2 K compares), m, B, D (10
    operations), z and num from the sums less the self term (4F+7).  el, er,
    h (h_bytes per element) read once, m, z, num written once."""
    K, E = n - 1, n * (n - 1) // 2
    lg = math.ceil(math.log2(K))
    ops = B * n * H * K * (2 * lg + 8 * F + 21)
    nbytes = (4 * (2 * B * E * H + n * K + 2 * B * n * K * H + B * n * K * H * F)
              + h_bytes * B * E * H * F)
    return ops, nbytes


def mxu_tensor_core_flop(B, n, H, F):
    """K4's products as csrc/gat_group_mxu.cu issues them: per (batch, city,
    head), ceil(g/8) tiles of 8 targets x ceil(g/8) steps of 8 sources x
    ceil(F/16) tiles of 16 features x 3 mma.sync m16n8k8 (3xTF32), 2*16*8*8
    FLOP each."""
    g = n - 1
    return B * n * H * (-(-g // 8)) ** 2 * -(-F // 16) * 3 * 2 * 16 * 8 * 8


def gls_work(work, n, G, n_iters):
    """(operations, bytes) of the whole GLS for this run's data: its
    local-search and perturbation rounds (the kernel reports them) times the
    additions of their scans; D and the G guides read once (a guide that is
    D itself counts as none), tours, costs and traces written once."""
    rounds = work.double().sum(dim=0).tolist()  # (local-search, perturbation) rounds
    B = work.shape[0]
    per_ls = 3 * (n - 2) * (n - 3) / 2 + 5 * (n - 2) ** 2  # adds over all a2a candidates
    per_pert = 46 * n  # utility, two o2a scans under D + k*P per endpoint, re-costs
    ops = rounds[0] * per_ls + rounds[1] * per_pert
    nbytes = 4 * (B * n * n * (1 + G) + 2 * B * (n + 1) + B * (4 + 2 * n_iters))
    return ops, nbytes


def bound(ops, nbytes):
    """(ms, what bounds it): the larger of the operations over the f32 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def row(name, source, replaces, launches, err, ms, plain, ops, nbytes, shape, **extra):
    """One entry of the `kernels` JSON line."""
    bound_ms, bound_by = bound(ops, nbytes)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "shape": shape,
            **extra}


def phase0_build():
    from gnngls_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t = time.time()
    path = kernels.build()
    kernels.library()
    log(f"phase 0: kernels built in {time.time() - t:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line:
            log("  ptxas: " + line.strip())
    return card


def phase1_gat(model, ds, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials,
                                                gat_group_partials_plain,
                                                merge_group_partials)

    worst = 0.0
    layer0 = model.layers[0].gat.params()
    rng = np.random.default_rng(0)
    cases = []
    with torch.no_grad():
        x = torch.as_tensor(ds.get_scaled_batch([0, 1])["features"], device=dev)
        cases.append(("checkpoint layer 0, B=2 n=100 H=8 F=16", 100,
                      project(layer0, model.embed(x), 8)))
        n, H, F = 20, 4, 8
        E = n * (n - 1) // 2
        rnd = lambda *shape: torch.as_tensor(  # noqa: E731
            10 * rng.standard_normal(shape), dtype=torch.float32, device=dev)
        cases.append(("seeded x10 spread, B=3 n=20 H=4 F=8", n,
                      (rnd(3, E, H, F), rnd(3, E, H), rnd(3, E, H))))
        for name, n, (h, el, er) in cases:
            topo = build_topology(n)
            city = torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev)
            args = (el.contiguous(), er.contiguous(), h.contiguous(), city)
            got = gat_group_partials(*args)
            torch.cuda.synchronize()
            want = gat_group_partials_plain(*args)
            parts = dict(zip(("m", "z", "num"), zip(got, want)))
            parts["merged"] = (merge_group_partials(*got, topo),
                               merge_group_partials(*want, topo))
            for key, (a, b) in parts.items():
                ab, rel = errs(a, b)
                worst = max(worst, ab)
                log(f"  K2 {name}: {key:6s} max abs {ab:.3e}  rel {rel:.3e}")
                require(rel <= K2_REL_TOL, f"K2 {name} {key}: rel err {rel:.3e} > {K2_REL_TOL}")
    log(f"phase 1: K2 matches its plain twin (rel tol {K2_REL_TOL})")
    return worst


def phase2_gls(dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    worst = 0.0
    for n, B, iters, pm in ((20, 8, 5, 4), (50, 4, 5, 8), (100, 2, 3, 20)):
        rng = np.random.default_rng(n)
        D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
        noise = rng.random((B, n, n)).astype(np.float32)
        regret = np.maximum(D + 0.3 * (noise + noise.transpose(0, 2, 1)) - 0.4, 0.0)
        regret = regret.astype(np.float32)
        for gname, G in (("weight", D[:, None]), ("regret-like", regret[:, None]),
                         ("cycle of 2", np.stack([regret, D], axis=1))):
            Dt = torch.as_tensor(D, device=dev)
            Gt = torch.as_tensor(np.ascontiguousarray(G), device=dev)
            T = nearest_neighbor_batch(Gt[:, 0])
            got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
            torch.cuda.synchronize()
            want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
            for key in ("best_tours", "moves", "trace_costs", "trace_moves", "work"):
                require(torch.equal(getattr(got, key), getattr(want, key)),
                        f"K1 n={n} {gname}: {key} differs from the plain twin")
            ulp = torch.finfo(torch.float32).eps * want.best_costs.abs()
            dc = (got.best_costs - want.best_costs).abs()
            require(bool((dc <= ulp).all()), f"K1 n={n} {gname}: best costs differ by > 1 ulp")
            worst = max(worst, float(dc.max()))
            log(f"  K1 n={n} B={B} iters={iters} pm={pm} {gname}: identical "
                f"(moves {got.moves.tolist()})")
    log("phase 2: K1 matches its plain twin move for move")
    return worst


def phase3_main(model, ds, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=N_ITERS,
                   perturbation_moves=PM, batch_size=BATCH, device=dev)
    wall = time.time() - t
    counts = dict(kernels.launches)
    log(f"phase 3: evaluate on {len(ds)} instances in {wall:.1f} s; launches {counts}")
    require(counts.get("gat_group", 0) > 0 and counts.get("gls_whole", 0) > 0
            and counts.get("nearest_neighbor", 0) == 1,
            f"a kernel of the main path did not launch (construction once): {counts}")
    n = ds.n_nodes
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix

    D = coords_to_distance_matrix(ds.coords).astype(np.float64)
    tours = out["best_tours"]
    for b in range(len(ds)):
        require(is_valid_tour(n, tours[b]), f"instance {b}: invalid tour")
    exact = D[np.arange(len(ds))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)
    require(np.allclose(out["best_costs"], exact, rtol=1e-6),
            "best costs differ from the tours' costs")
    kc = out["result"].search_costs
    require(np.abs(kc - out["best_costs"]).max() < 1e-3,
            "the kernel's cost accounting drifted from the tours' costs")
    gaps = out["gaps"]
    tm = out["timings"]
    moves = int(out["moves"].sum())
    edges = len(ds) * n * (n - 1) // 2
    before = " / ".join(f"{x:.4f}" for x in PARENT_GAP100)
    log(f"  gap mean {gaps.mean():.4f}%  median {np.median(gaps):.4f}%  max {gaps.max():.4f}% "
        f"(before the redesign of K1 and K2: {before}%)")
    log(f"  inference {tm['inference_s']:.3f} s ({edges / tm['inference_s']:.4g} edges/s); "
        f"search {tm['search_s']:.3f} s ({moves} accepted moves, "
        f"{moves / tm['search_s']:.4g} moves/s)")

    fx = json.loads((ROOT / "gnngls_tpu_torch/testdata/jax_tsp100_test64_it100.json").read_text())
    k = min(len(fx["best_cost"]), len(ds))
    mine = np.float32(out["best_costs"][:k])
    theirs = np.float32(fx["best_cost"][:k])
    eq = int((mine == theirs).sum())
    my_gap = float(((out["best_costs"][:k] / ds.opt_cost[:k]) - 1.0).mean() * 100.0)
    log(f"  vs JAX fixture (instances 0-{k - 1}): {eq}/{k} best costs equal, largest "
        f"difference {float(np.abs(mine - theirs).max()):.3e}; mean gap {my_gap:.4f}% "
        f"vs {fx['mean_gap']:.4f}% (before the redesign: {PARENT_FIXTURE_EQ}/{k} equal)")
    require(k == len(fx["best_cost"]) and abs(my_gap - fx["mean_gap"]) <= 0.1,
            "mean gap over 0-63 differs from the JAX fixture by more than 0.1 pp")
    return out, counts


def phase4_timings(model, ds, dev, out, counts, k2_err, k1_err):
    """Time both kernels and their twins at the main path's shapes, and hold
    each kernel against its twin there too."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group import gat_group_partials, gat_group_partials_plain
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    n = ds.n_nodes
    g = n - 1
    topo = build_topology(n)
    with torch.no_grad():
        x = torch.as_tensor(ds.get_scaled_batch(np.arange(BATCH))["features"], device=dev)
        h, el, er = project(model.layers[0].gat.params(), model.embed(x), model.cfg.n_heads)
        args = (el.contiguous(), er.contiguous(), h.contiguous(),
                torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev))
        B, E, H, F = h.shape
        k2_ms = cuda_ms(lambda: gat_group_partials(*args), reps=10, warmup=2)
        k2_plain = cuda_ms(lambda: gat_group_partials_plain(*args), reps=2)
        for key, a, b in zip(("m", "z", "num"), gat_group_partials(*args),
                             gat_group_partials_plain(*args)):
            ab, rel = errs(a, b)
            k2_err = max(k2_err, ab)
            require(rel <= K2_REL_TOL, f"K2 at B={B}: {key} rel err {rel:.3e} > {K2_REL_TOL}")
    k2_ops, k2_bytes = gat_partials_work(B, n, H, F)
    log(f"  K2 at B={B} n={n} H={H} F={F}: {k2_ms:.4f} ms/launch, plain {k2_plain:.3f} ms; "
        f"agree within rel {K2_REL_TOL}")

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix

    Dt = torch.as_tensor(coords_to_distance_matrix(ds.coords), device=dev)
    Gt = torch.as_tensor(np.ascontiguousarray(out["guide_stack"], dtype=np.float32), device=dev)
    Tt = torch.as_tensor(np.ascontiguousarray(out["init_tours"], dtype=np.int32), device=dev)
    res = {}

    def run(fn, key):
        res[key] = fn(Dt, Gt, Tt, n_iters=N_ITERS, perturbation_moves=PM)

    k1_ms = cuda_ms(lambda: run(gls_whole, "kernel"), reps=3, warmup=1)
    k1_plain = cuda_ms(lambda: run(gls_fixed_plain, "plain"), reps=1, warmup=0)
    for key in ("best_tours", "moves", "trace_costs", "trace_moves", "work", "best_costs"):
        require(torch.equal(getattr(res["kernel"], key), getattr(res["plain"], key)),
                f"K1 at the main path's shape: {key} differs from the plain twin")
    Bk = Dt.shape[0]
    k1_ops, k1_bytes = gls_work(res["kernel"].work, n, Gt.shape[1], N_ITERS)
    log(f"  K1 at B={Bk} n={n} n_iters={N_ITERS} pm={PM}: {k1_ms:.2f} ms/launch, plain "
        f"{k1_plain:.1f} ms; identical outputs")

    return [
        row("gat_group", "gnngls_tpu_torch/csrc/gat_group.cu",
            "gnngls_tpu/ops/pallas_gat.py:41", counts.get("gat_group", 0), k2_err,
            k2_ms, k2_plain, k2_ops, k2_bytes, f"B={B} n={n} H={H} F={F}"),
        row("gls_whole", "gnngls_tpu_torch/csrc/gls_whole.cu",
            "gnngls_tpu/search/pallas_gls.py:257", counts.get("gls_whole", 0), k1_err,
            k1_ms, k1_plain, k1_ops, k1_bytes,
            f"shared layout, B={Bk} n={n} G=1 n_iters={N_ITERS} pm={PM}"),
    ]


def layer0_embedding(model, coords, dev):
    """The checkpoint's embedding (layer 0's input) on these instances."""
    import numpy as np
    import torch

    B, n, _ = coords.shape
    ds = generated_dataset({"coords": coords, "opt_cost": np.ones(B),
                         "in_solution": np.zeros((B, n * (n - 1) // 2), bool)})
    with torch.no_grad():
        return model.embed(torch.as_tensor(ds.get_scaled_batch(np.arange(B))["features"],
                                           device=dev))


def layer0_inputs(model, coords, dev):
    """The checkpoint's layer-0 el, er, h and city_edges on these instances."""
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project

    with torch.no_grad():
        h, el, er = project(model.layers[0].gat.params(), layer0_embedding(model, coords, dev),
                            model.cfg.n_heads)
    city = torch.as_tensor(build_topology(coords.shape[1]).city_edges, dtype=torch.int32,
                           device=dev)
    return el.contiguous(), er.contiguous(), h.contiguous(), city


def predictions(out, n):
    """The per-edge predictions an evaluate used: its regret guide, read back
    at the upper triangle."""
    import numpy as np

    us, vs = np.triu_indices(n, k=1)
    return out["guide_stack"][:, 0, us, vs]


def phase5_gat_chunked(model, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials_chunked,
                                                gat_group_partials_chunked_plain,
                                                source_chunk)
    from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials_plain

    worst = 0.0
    coords = np.random.default_rng(SEED500).random((2, N500, 2)).astype(np.float32)
    gs500 = source_chunk(N500, model.cfg.embed_dim)
    require(gs500 > 0, f"n={N500} does not take the source-chunked partials")
    rng = np.random.default_rng(40)
    n, H, F = 40, 4, 8
    E = n * (n - 1) // 2
    rnd = lambda *shape: torch.as_tensor(  # noqa: E731
        10 * rng.standard_normal(shape), dtype=torch.float32, device=dev)
    city40 = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=dev)
    cases = [(f"checkpoint layer 0, B=2 n={N500} H=8 F=16 gs={gs500}", N500, gs500,
              layer0_inputs(model, coords, dev)),
             ("seeded x10 spread, B=3 n=40 H=4 F=8 gs=8", n, 8,
              (rnd(3, E, H), rnd(3, E, H), rnd(3, E, H, F), city40))]
    with torch.no_grad():
        for name, n, gs, args in cases:
            got = gat_group_partials_chunked(*args, gs)
            torch.cuda.synchronize()
            wants = [("its twin", gat_sorted_partials_plain(*args)),
                     ("K3's twin", gat_group_partials_chunked_plain(*args, gs))]
            worst = max(worst, hold(f"K3 route {name}", got, wants, build_topology(n),
                                    K3_REL_TOL))
    log(f"phase 5: K3's route matches its twin and K3's arithmetic (rel tol {K3_REL_TOL})")
    return worst


def phase6_gls_global(dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain
    from gnngls_tpu_torch.utils import is_valid_tour

    def case(n, B, seed):
        rng = np.random.default_rng(seed)
        D = torch.as_tensor(coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32)),
                            device=dev)
        noise = torch.as_tensor(rng.random((B, n, n)), dtype=torch.float32, device=dev)
        regret = torch.clamp(D + 0.3 * (noise + noise.transpose(1, 2)) - 0.4, min=0.0)
        return D, regret, nearest_neighbor_batch(D)

    def same(a, b, what):
        for key in a._fields:
            require(torch.equal(getattr(a, key), getattr(b, key)), f"K1 {what}: {key} differs")

    D, regret, T = case(100, 8, 100)
    for gname, G in (("weight", D[:, None]), ("cycle of 2", torch.stack([regret, D], 1))):
        kw = dict(n_iters=5, perturbation_moves=PM)
        same(gls_whole(D, G.contiguous(), T, layout="global", **kw),
             gls_whole(D, G.contiguous(), T, layout="shared", **kw),
             f"n=100 B=8 {gname}, global vs shared layout")
        log(f"  K1 n=100 B=8 {gname}: global layout == shared layout, bit for bit")
    D, _, T = case(N500, 2, N500)
    kw = dict(n_iters=3, perturbation_moves=ORACLE_PM)
    got = gls_whole(D, D[:, None].contiguous(), T, **kw)
    torch.cuda.synchronize()
    same(got, gls_fixed_plain(D, D[:, None], T, **kw), f"n={N500} B=2, global vs plain")
    log(f"  K1 n={N500} B=2 n_iters=3 pm={ORACLE_PM}: global layout == plain twin, bit for "
        f"bit (moves {got.moves.tolist()})")
    D, _, T = case(1000, 1, 1000)
    got = gls_whole(D, D[:, None].contiguous(), T, n_iters=1, perturbation_moves=PM)
    tour = got.best_tours[0].cpu().numpy()
    require(is_valid_tour(1000, tour), "K1 n=1000: invalid tour")
    cost = float(D[0][got.best_tours[0, :-1].long(), got.best_tours[0, 1:].long()].sum())
    init = float(D[0][T[0, :-1].long(), T[0, 1:].long()].sum())
    require(cost < init, "K1 n=1000: the search did not improve the start")
    log(f"  K1 n=1000 B=1 n_iters=1: valid tour, cost {cost:.4f} from {init:.4f} "
        f"({int(got.moves[0])} moves)")
    log("phase 6: K1's global layout matches the shared layout and the plain twin")


def generated_dataset(data, k=None):
    """Generated instances (the first k) as a dataset with the tsp100 scalers
    and zero regret labels."""
    import numpy as np

    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset

    d = {key: np.asarray(v)[:k] if np.ndim(v) else v for key, v in data.items()}
    d["regret"] = np.zeros_like(np.asarray(d["in_solution"], np.float32))
    return TSPDataset.from_arrays(d, scalers=load_scalers(ROOT / "models/tsp100/scalers.json"))


def phase7_tsp500(model, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix, generate_instances
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    data = generate_instances(N_INST500, N500, seed=SEED500, solver="gls",
                              opt_iters=ORACLE_ITERS, device=dev)
    oracle_s = time.time() - t
    ds = generated_dataset(data)
    t = time.time()
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=N_ITERS500,
                   perturbation_moves=20, batch_size=BATCH500, device=dev)
    eval_s = time.time() - t
    counts = dict(kernels.launches)
    batches = -(-N_INST500 // BATCH500)
    log(f"phase 7: tsp500 path, {N_INST500} instances: oracle {oracle_s:.1f} s, evaluate "
        f"{eval_s:.1f} s; launches {counts}")
    want = {"gat_group_chunked": model.cfg.depth * batches, "gat_group": 0, "gls_whole": 2,
            "nearest_neighbor": 2}
    require(all(counts.get(k, 0) == v for k, v in want.items()),
            f"tsp500 path launches {counts}, expected {want}")
    D = coords_to_distance_matrix(ds.coords).astype(np.float64)
    for name, tours in (("oracle", data["opt_tour"]), ("eval", out["best_tours"])):
        for b in range(N_INST500):
            require(is_valid_tour(N500, tours[b]), f"tsp500 {name} instance {b}: invalid tour")
    exact = D[np.arange(N_INST500)[:, None], out["best_tours"][:, :-1],
              out["best_tours"][:, 1:]].sum(-1)
    require(np.allclose(out["best_costs"], exact, rtol=1e-6),
            "tsp500: best costs differ from the tours' costs")
    gaps = out["gaps"]
    require(bool(np.isfinite(gaps).all()), "tsp500: gaps are not finite")
    tm = out["timings"]
    moves = int(out["moves"].sum())
    edges = N_INST500 * N500 * (N500 - 1) // 2
    log(f"  gap vs the oracle (n_iters={ORACLE_ITERS}): mean {gaps.mean():.4f}%  median "
        f"{np.median(gaps):.4f}%  max {gaps.max():.4f}% (mean before the redesign of K1 and "
        f"K2: {PARENT_GAP500:.4f}%)")
    log(f"  inference {tm['inference_s']:.3f} s ({edges / tm['inference_s']:.4g} edges/s); "
        f"search {tm['search_s']:.3f} s ({moves} accepted moves, "
        f"{moves / tm['search_s']:.4g} moves/s); total {tm['total_s']:.3f} s; peak device "
        f"memory {tm['peak_device_bytes'] / 2 ** 30:.3f} GiB")
    return data, out, counts


def phase8_fixture200(model, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import edge_vector_to_matrix
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.search import batched

    fx = np.load(ROOT / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")
    B, n, _ = fx["coords"].shape
    coords = np.random.default_rng(SEED500).random((B, n, 2)).astype(np.float32)
    require(np.array_equal(coords, fx["coords"]), "n=200 fixture: other coordinates")
    ds = generated_dataset({"coords": coords, "opt_cost": np.ones(B),
                         "in_solution": np.zeros((B, n * (n - 1) // 2), bool)})
    n_iters, pm = int(fx["n_iters"]), int(fx["perturbation_moves"])
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=n_iters,
                   perturbation_moves=pm, batch_size=B, device=dev)
    err = float(np.abs(predictions(out, n) - fx["pred"]).max())
    log(f"  n={n} predictions vs the JAX fixture: max abs {err:.3e} (tol {PRED_TOL})")
    require(err <= PRED_TOL, f"n={n} predictions differ from JAX by {err:.3e}")
    mine = np.float32(out["best_costs"])
    eq = mine == fx["best_cost"]
    log(f"  n={n} search (n_iters={n_iters}, pm={pm}): best costs {mine.tolist()} vs JAX "
        f"{fx['best_cost'].tolist()}; moves {out['moves'].tolist()} vs {fx['moves'].tolist()}")
    if not eq.all():
        # explained only if the search on JAX's own predictions gives JAX's costs:
        # then the predictions' last-bit rounding on the card moved the search
        Ds = coords_to_distance_matrix(coords)
        R = edge_vector_to_matrix(fx["pred"], n)
        inits = batched.nearest_neighbor_batch(torch.as_tensor(R, device=dev)).cpu().numpy()
        res = batched.run_fixed_kernel(Ds, R[:, None], inits, n_iters=n_iters,
                                       perturbation_moves=pm, device=dev)
        require(np.array_equal(np.float32(res.best_costs), fx["best_cost"]),
                f"n={n}: the card's search on JAX's predictions differs from the fixture")
        log(f"  instances {np.flatnonzero(~eq).tolist()} differ through the predictions' "
            "rounding: the card's search on JAX's own predictions gives JAX's best costs")
    log(f"phase 8: the n={n} JAX fixture holds ({int(eq.sum())}/{B} best costs equal)")


def phase9_timings500(model, data, out, counts7, k3_err, dev):
    """K3's route (the sorted-prefix kernel) and K2 at B=16 n=500 H=8 F=16 on
    the path's layer-0 activations; K1's global layout at the eval and the
    oracle launches."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials, gat_group_partials_chunked,
                                                gat_group_partials_chunked_plain,
                                                merge_group_partials, source_chunk)
    from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials_plain
    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    n = N500
    gs = source_chunk(n, model.cfg.embed_dim)
    args = layer0_inputs(model, data["coords"][:BATCH500], dev)
    B, E, H, F = args[2].shape
    topo = build_topology(n)
    tag = f"K3 route at B={B} n={n}"
    with torch.no_grad():
        k3_ms = cuda_ms(lambda: gat_group_partials_chunked(*args, gs), reps=5, warmup=1)
        k2_ms = cuda_ms(lambda: gat_group_partials(*args), reps=5, warmup=1)
        k3_plain = cuda_ms(lambda: gat_sorted_partials_plain(*args), reps=1)
        k3_twin_ms = cuda_ms(lambda: gat_group_partials_chunked_plain(*args, gs), reps=1)
        got = gat_group_partials_chunked(*args, gs)
        k3_err = max(k3_err, hold(tag, got, [("its twin", gat_sorted_partials_plain(*args))],
                                  topo, K3_REL_TOL))
        k3_err = max(k3_err, hold(tag, got, [
            ("K3's twin", gat_group_partials_chunked_plain(*args, gs))], topo, K3_REL_TOL))
        ab, rel = errs(merge_group_partials(*got, topo),
                       merge_group_partials(*gat_group_partials(*args), topo))
        require(rel <= K3_REL_TOL, f"K3's route and K2 at n={n} disagree: rel {rel:.3e}")
        del got
    k3_ops, k3_bytes = gat_partials_work(B, n, H, F)
    log(f"  K3 route (csrc/gat_sorted.cu) at B={B} n={n} H={H} F={F} gs={gs}: {k3_ms:.4f} "
        f"ms/launch, its twin {k3_plain:.3f} ms, K3's arithmetic {k3_twin_ms:.3f} ms; K2 "
        f"(one-shot) at the same shape {k2_ms:.4f} ms; merged vs K2 rel {rel:.3e}")

    rows = [row("gat_group_chunked", "gnngls_tpu_torch/csrc/gat_sorted.cu",
                "gnngls_tpu/ops/pallas_gat.py:79", counts7.get("gat_group_chunked", 0), k3_err,
                k3_ms, k3_plain, k3_ops, k3_bytes, f"B={B} n={n} H={H} F={F} gs={gs}",
                one_shot_k2_ms=k2_ms, k3_arithmetic_plain_ms=k3_twin_ms)]
    Dt = torch.as_tensor(coords_to_distance_matrix(data["coords"]), device=dev)
    launches = (
        ("eval", torch.as_tensor(np.ascontiguousarray(out["guide_stack"], dtype=np.float32),
                                 device=dev),
         torch.as_tensor(out["init_tours"], device=dev), N_ITERS500, 20),
        ("oracle", Dt[:, None].contiguous(), nearest_neighbor_batch(Dt), ORACLE_ITERS,
         ORACLE_PM))
    for name, Gt, Tt, iters, pm in launches:
        res = {}

        def run(fn, key):
            res[key] = fn(Dt, Gt, Tt, n_iters=iters, perturbation_moves=pm)

        ms = cuda_ms(lambda: run(gls_whole, "kernel"), reps=2, warmup=1)
        plain = cuda_ms(lambda: run(gls_fixed_plain, "plain"), reps=1, warmup=0)
        for key in res["kernel"]._fields:
            require(torch.equal(getattr(res["kernel"], key), getattr(res["plain"], key)),
                    f"K1 global layout at the {name} launch: {key} differs from the twin")
        ops, nbytes = gls_work(res["kernel"].work, n, Gt.shape[1], iters)
        shape = f"global layout, {name} launch: B={Dt.shape[0]} n={n} G={Gt.shape[1]} " \
                f"n_iters={iters} pm={pm}"
        log(f"  K1 {shape}: {ms:.2f} ms/launch, plain {plain:.1f} ms; identical outputs")
        # both launches of the tsp500 path run this layout: counts7 holds the two
        rows.append(row(f"gls_whole_global_{name}", "gnngls_tpu_torch/csrc/gls_whole.cu",
                        "gnngls_tpu/search/pallas_gls.py:257", counts7.get("gls_whole", 0),
                        0.0, ms, plain, ops, nbytes, shape))
    return rows


def require_too_large(partials, n, F, dev, *extra):
    """A launcher refuses a block that does not fit the device's shared
    memory, and the wrapper raises ValueError for it; nothing is launched."""
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.core.graph import build_topology

    E = n * (n - 1) // 2
    el = torch.zeros((1, E, 1), device=dev)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=dev)
    before = dict(kernels.launches)
    try:
        partials(el, el, torch.zeros((1, E, 1, F), device=dev), city, *extra)
    except ValueError as e:
        require("shared memory" in str(e), f"{partials.__name__} at n={n}: {e}")
        require(dict(kernels.launches) == before, f"{partials.__name__} at n={n} counted a launch")
        log(f"  {partials.__name__} at n={n} F={F}: ValueError ({e})")
        return
    raise SmokeFailure(f"{partials.__name__} at n={n} F={F} did not raise")


def k4_built_from(src):
    """K4's launcher compiled from another source of csrc/gat_group_mxu.cu
    (an older version, say), in a library of its own, behind a wrapper with
    gat_group_partials_mxu's signature that counts no launch."""
    import ctypes

    import torch

    from gnngls_tpu_torch import kernels

    launch = ctypes.CDLL(str(kernels.build([src]))).gat_group_mxu_launch
    launch.argtypes = kernels.library().gat_group_mxu_launch.argtypes
    launch.restype = ctypes.c_int

    def partials(el, er, h, city):
        B, E, H, F = h.shape
        n, g = city.shape
        m, z = (torch.empty((B, n, g, H), device=h.device) for _ in range(2))
        num = torch.empty((B, n, g, H, F), device=h.device)
        kernels.check(launch(el.data_ptr(), er.data_ptr(), h.data_ptr(), city.data_ptr(), B, n,
                             E, H, F, m.data_ptr(), z.data_ptr(), num.data_ptr(),
                             h.device.index, kernels.stream_of(el)), f"K4 from {src}")
        return m, z, num

    return partials


def phase10_mxu(model, ds, dev, k4_against=None):
    """K4 against its twin, K4 merged against K2 merged, the n=120 route; K4
    and K2 timed at the main path's shape, and K4 built from `k4_against`
    when it is given."""
    import warnings

    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group import (gat_conv_group, gat_group_partials,
                                                gat_group_partials_mxu,
                                                gat_group_partials_mxu_plain,
                                                merge_group_partials)

    worst = 0.0
    rng = np.random.default_rng(10)
    with torch.no_grad():
        for n, H, F in ((3, 8, 16), (10, 8, 16), (10, 4, 8), (50, 8, 16), (100, 8, 16),
                        (111, 8, 16)):
            E = n * (n - 1) // 2
            rnd = lambda *shape: torch.as_tensor(  # noqa: E731
                rng.standard_normal(shape), dtype=torch.float32, device=dev)
            topo = build_topology(n)
            city = torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev)
            args = (3 * rnd(2, E, H), 3 * rnd(2, E, H), rnd(2, E, H, F), city)
            got = gat_group_partials_mxu(*args)
            torch.cuda.synchronize()
            want = gat_group_partials_mxu_plain(*args)
            require(torch.equal(got[0], want[0]), f"K4 n={n}: the maxima differ")
            parts = dict(zip(("m", "z", "num"), zip(got, want)))
            parts["merged"] = (merge_group_partials(*got, topo),
                               merge_group_partials(*want, topo))
            for key, (a, b) in parts.items():
                ab, rel = errs(a, b)
                worst = max(worst, ab)
                require(rel <= K4_REL_TOL, f"K4 n={n} H={H} F={F} {key}: rel err {rel:.3e}")
            log(f"  K4 seeded B=2 n={n} H={H} F={F}: m equal, z/num/merged within rel "
                f"{K4_REL_TOL} (worst abs so far {worst:.3e})")

        n = ds.n_nodes
        topo = build_topology(n)
        x = torch.as_tensor(ds.get_scaled_batch(np.arange(BATCH))["features"], device=dev)
        h, el, er = project(model.layers[0].gat.params(), model.embed(x), model.cfg.n_heads)
        args = (el.contiguous(), er.contiguous(), h.contiguous(),
                torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev))
        B, E, H, F = h.shape
        k4_ms = cuda_ms(lambda: gat_group_partials_mxu(*args), reps=10, warmup=2)
        k2_ms = cuda_ms(lambda: gat_group_partials(*args), reps=10, warmup=2)
        k4_plain = cuda_ms(lambda: gat_group_partials_mxu_plain(*args), reps=2)
        got = gat_group_partials_mxu(*args)
        for key, a, b in zip(("m", "z", "num"), got, gat_group_partials_mxu_plain(*args)):
            ab, rel = errs(a, b)
            worst = max(worst, ab)
            require(rel <= K4_REL_TOL, f"K4 at B={B} n={n}: {key} rel err {rel:.3e}")
        ab, rel = errs(merge_group_partials(*got, topo),
                       merge_group_partials(*gat_group_partials(*args), topo))
        require(rel <= K4_REL_TOL, f"K4 merged vs K2 merged at B={B} n={n}: rel {rel:.3e}")
        log(f"  K4 at B={B} n={n} H={H} F={F}: {k4_ms:.4f} ms/launch, plain {k4_plain:.3f} ms; "
            f"K2 at the same shape {k2_ms:.4f} ms; K4 merged vs K2 merged max abs {ab:.3e} "
            f"rel {rel:.3e}")
        if k4_against:
            other = k4_built_from(k4_against)
            o = other(*args)
            rel = max(errs(a, b)[1] for a, b in zip(o[1:], gat_group_partials_mxu_plain(*args)[1:]))
            require(torch.equal(o[0], got[0]) and rel <= K4_REL_TOL,
                    f"K4 from {k4_against} disagrees with the plain twin (rel {rel:.3e})")
            ms = [cuda_ms(lambda: fn(*args), reps=10, warmup=2)
                  for fn in (other, gat_group_partials_mxu, gat_group_partials, other)]
            log(f"  K4 from {k4_against}: m equal, z/num rel {rel:.3e}; in turns it, this K4, "
                f"K2, it: {', '.join(f'{t:.4f}' for t in ms)} ms/launch")

        n = 120
        topo = build_topology(n)
        coords = np.random.default_rng(120).random((2, n, 2)).astype(np.float32)
        h0 = layer0_embedding(model, coords, dev)
        params = model.layers[0].gat.params()
        kernels.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            routed = gat_conv_group(params, topo, h0, model.cfg.n_heads, mxu=True)
        counts = dict(kernels.launches)
        require(any("source-chunked" in str(w.message) for w in caught),
                f"pallas_mxu at n={n}: no warning")
        require(counts == {"gat_group_chunked": 1}, f"pallas_mxu at n={n} launched {counts}")
        require(torch.equal(routed, gat_conv_group(params, topo, h0, model.cfg.n_heads)),
                f"pallas_mxu at n={n} differs from the K3 route")
        log(f"  pallas_mxu at n={n}: warned and ran K3 ({counts}), equal to the K3 route")
        require_too_large(gat_group_partials_mxu, 2074, 16, dev)
    log(f"phase 10: K4 matches its plain twin and K2 (rel tol {K4_REL_TOL})")
    k4_ops, k4_bytes = gat_partials_work(B, ds.n_nodes, H, F)
    k4_tc = mxu_tensor_core_flop(B, ds.n_nodes, H, F)
    log(f"  K4's tensor-core work at B={B} n={ds.n_nodes}: {k4_tc:.4g} FLOP of TF32, "
        f"{k4_tc / PEAK_TF32 * 1e3:.4f} ms at {PEAK_TF32:.3g} FLOP/s; K4 at "
        f"{k4_tc / (k4_ms * 1e-3):.4g} FLOP/s")
    return worst, k4_ms, k4_plain, k2_ms, k4_ops, k4_bytes, f"B={B} n={ds.n_nodes} H={H} F={F}"


def phase11_mxu_path(model, ds, dev, k2_preds):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import predict_regret, search_on_predictions
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    preds = predict_regret(model, ds, batch_size=BATCH, device=dev, gat_impl="pallas_mxu")
    infer_s = time.time() - t
    counts = dict(kernels.launches)
    batches = -(-len(ds) // BATCH)
    want = {"gat_group_mxu": model.cfg.depth * batches}
    require(counts == want, f"pallas_mxu path launches {counts}, expected {want}")
    diff = float(np.abs(preds - k2_preds).max())
    log(f"phase 11: pallas_mxu predictions on {len(ds)} tsp100 instances in {infer_s:.3f} s "
        f"({len(ds) * preds.shape[1] / infer_s:.4g} edges/s); launches {counts}; max abs "
        f"difference from phase 3's K2 predictions {diff:.3e}")
    require(diff <= PRED_TOL, f"pallas_mxu predictions differ from K2's by {diff:.3e}")
    res, search_s = search_on_predictions(preds, ds.coords, n_iters=N_ITERS,
                                           perturbation_moves=PM, device=dev)
    n = ds.n_nodes
    for b in range(len(ds)):
        require(is_valid_tour(n, res.best_tours[b]), f"pallas_mxu path instance {b}: invalid tour")
    gaps = (res.best_costs / ds.opt_cost - 1.0) * 100.0
    fx = json.loads((ROOT / "gnngls_tpu_torch/testdata/jax_tsp100_test64_it100.json").read_text())
    k = len(fx["best_cost"])
    eq = int((np.float32(res.best_costs[:k]) == np.float32(fx["best_cost"])).sum())
    my_gap = float(gaps[:k].mean())
    log(f"  search (n_iters {N_ITERS}, pm {PM}) {search_s:.3f} s: gap mean {gaps.mean():.4f}%; "
        f"instances 0-{k - 1}: mean gap {my_gap:.4f}% vs JAX {fx['mean_gap']:.4f}%, {eq}/{k} "
        "best costs equal")
    require(abs(my_gap - fx["mean_gap"]) <= 0.1,
            "pallas_mxu path: mean gap over 0-63 differs from the JAX fixture by more than 0.1 pp")
    return counts


def phase12_sep(model, data, dev):
    """K5's route (the sorted-prefix kernel) against its twin and K5's
    arithmetic in both payload modes; both timed at B=4 n=500, the f32
    payloads also at B=2 n=200, the shape of the path that counts their
    launches (phase 13's n=200 fixture prediction)."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group_sep import gat_sep_partials, gat_sep_partials_plain
    from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials_plain

    worst = {False: 0.0, True: 0.0}
    rng = np.random.default_rng(12)
    layer0 = model.layers[0].gat.params()
    H = model.cfg.n_heads
    cases = []
    with torch.no_grad():
        rnd = lambda *shape: torch.as_tensor(  # noqa: E731
            rng.standard_normal(shape), dtype=torch.float32, device=dev)
        for B, n, Hs, F, spread in ((2, 10, 8, 16, 10), (2, 100, 8, 16, 10), (1, 900, 2, 32, 3),
                                    (1, 1100, 2, 16, 3)):
            E = n * (n - 1) // 2
            cases.append((f"seeded x{spread} spread, B={B} n={n} H={Hs} F={F}", n,
                          (spread * rnd(B, E, Hs), spread * rnd(B, E, Hs), rnd(B, E, Hs, F))))
        n = 20
        ones = torch.ones((2, n * (n - 1) // 2, model.cfg.embed_dim), device=dev)
        h, el, er = project(layer0, ones, H)
        cases.append((f"constant features (tied maxima), B=2 n={n}", n, (el, er, h)))
        coords = np.random.default_rng(SEED500).random((2, N500, 2)).astype(np.float32)
        h, el, er = project(layer0, layer0_embedding(model, coords, dev), H)
        cases.append((f"checkpoint layer 0, B=2 n={N500}", N500, (el, er, h)))
        fx_coords = np.load(ROOT / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")["coords"]
        fx_args = layer0_inputs(model, fx_coords, dev)
        n_fx = fx_coords.shape[1]
        cases.append((f"checkpoint layer 0, the n={n_fx} fixture, B={fx_coords.shape[0]}",
                      n_fx, fx_args[:3]))
        for name, n, (el, er, h) in cases:
            topo = build_topology(n)
            city = torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev)
            args = (el.contiguous(), er.contiguous(), h.contiguous(), city)
            for fast in (False, True):
                got = gat_sep_partials(*args, fast)
                torch.cuda.synchronize()
                wants = [("its twin", gat_sorted_partials_plain(*args, fast)),
                         ("K5's twin", gat_sep_partials_plain(*args, fast))]
                tag = f"K5 route {'bf16' if fast else 'f32'} {name}"
                worst[fast] = max(worst[fast], hold(tag, got, wants, topo, K5_REL_TOL))
                del got, wants
        args = layer0_inputs(model, data["coords"][:BATCH_SEP], dev)
        B, E, H, F = args[2].shape
        topo = build_topology(N500)
        timed = {}
        for fast in (False, True):
            mode = "bf16" if fast else "f32"
            ms = cuda_ms(lambda: gat_sep_partials(*args, fast), reps=10, warmup=2)
            plain = cuda_ms(lambda: gat_sorted_partials_plain(*args, fast), reps=1)
            k5_plain = cuda_ms(lambda: gat_sep_partials_plain(*args, fast), reps=1)
            wants = [("its twin", gat_sorted_partials_plain(*args, fast)),
                     ("K5's twin", gat_sep_partials_plain(*args, fast))]
            worst[fast] = max(worst[fast], hold(f"K5 route {mode} at B={B} n={N500}",
                                                gat_sep_partials(*args, fast), wants, topo,
                                                K5_REL_TOL))
            timed[fast] = (ms, plain, *gat_partials_work(B, N500, H, F, 2 if fast else 4),
                           k5_plain)
            log(f"  K5 route {mode} at B={B} n={N500} H={H} F={F}: {ms:.4f} ms/launch, its "
                f"twin {plain:.3f} ms, K5's arithmetic {k5_plain:.3f} ms")
        fx_ms = cuda_ms(lambda: gat_sep_partials(*fx_args, False), reps=10, warmup=2)
        fx_plain = cuda_ms(lambda: gat_sorted_partials_plain(*fx_args, False), reps=1)
        fx_shape = f"B={fx_coords.shape[0]} n={n_fx} H={H} F={F}"
        log(f"  K5 route f32 at {fx_shape}: {fx_ms:.4f} ms/launch, its twin {fx_plain:.3f} ms")
        require_too_large(gat_sep_partials, 3100, 8, dev, False)
    log(f"phase 12: K5's route matches its twin and K5's arithmetic in both modes (rel tol "
        f"{K5_REL_TOL}), n=900 F=32 and n=1100 F=16 included")
    fx_bound = bound(*gat_partials_work(fx_coords.shape[0], n_fx, H, F))[0]
    return worst, timed, f"B={B} n={N500} H={H} F={F}", (fx_ms, fx_plain, fx_bound, fx_shape)


def rank_agreement(preds, ref, dev):
    """(max abs difference, Spearman rank correlation) of two prediction arrays."""
    import torch

    a, b = (torch.as_tensor(v, device=dev).reshape(-1) for v in (preds, ref))
    diff = float((a.double() - b.double()).abs().max())
    ranks = [torch.argsort(torch.argsort(v, stable=True), stable=True).double() for v in (a, b)]
    return diff, float(torch.corrcoef(torch.stack(ranks))[0, 1])


def phase13_sep_path(model, data, out500, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import predict_regret, search_on_predictions
    from gnngls_tpu_torch.utils import is_valid_tour

    ds = generated_dataset(data)
    kernels.reset_launch_counts()
    t = time.time()
    preds = predict_regret(model, ds, batch_size=BATCH_SEP, device=dev,
                           gat_impl="pallas_sep_fast")
    infer_s = time.time() - t
    counts = dict(kernels.launches)
    want = {"gat_sep": model.cfg.depth * -(-len(ds) // BATCH_SEP)}
    require(counts == want, f"pallas_sep_fast path launches {counts}, expected {want}")
    diff, rho = rank_agreement(preds, predictions(out500, N500), dev)
    log(f"phase 13: pallas_sep_fast predictions on {len(ds)} n={N500} instances at batch "
        f"{BATCH_SEP} in {infer_s:.3f} s ({preds.size / infer_s:.4g} edges/s); launches "
        f"{counts}; vs phase 7's K3 predictions: max abs difference {diff:.3e}, Spearman "
        f"{rho:.6f}")
    require(bool(np.isfinite(preds).all()), "pallas_sep_fast predictions are not finite")
    require(rho >= SPEARMAN_MIN, f"Spearman {rho:.6f} against K3's predictions < {SPEARMAN_MIN}")
    require(diff <= SEP_FAST_PRED_TOL,
            f"pallas_sep_fast predictions differ from K3's by {diff:.3e} > {SEP_FAST_PRED_TOL}")
    res, search_s = search_on_predictions(preds, ds.coords, n_iters=N_ITERS500,
                                           perturbation_moves=20, device=dev)
    for i in range(len(ds)):
        require(is_valid_tour(N500, res.best_tours[i]), f"sep path instance {i}: invalid tour")
    gaps = (res.best_costs / data["opt_cost"] - 1.0) * 100.0
    require(bool(np.isfinite(gaps).all()), "sep path: gaps are not finite")
    log(f"  search (n_iters {N_ITERS500}, pm 20) {search_s:.3f} s: gap vs the oracle mean "
        f"{gaps.mean():.4f}%  median {np.median(gaps):.4f}%  max {gaps.max():.4f}% (the K3 "
        f"path's: {out500['gaps'].mean():.4f}%)")

    fx = np.load(ROOT / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")
    B, n, _ = fx["coords"].shape
    ds200 = generated_dataset({"coords": fx["coords"], "opt_cost": np.ones(B),
                            "in_solution": np.zeros((B, n * (n - 1) // 2), bool)})
    kernels.reset_launch_counts()
    p200 = predict_regret(model, ds200, batch_size=B, device=dev, gat_impl="pallas_sep")
    counts200 = dict(kernels.launches)
    err = float(np.abs(p200 - fx["pred"]).max())
    log(f"  pallas_sep (f32) on the n={n} JAX fixture: predictions max abs {err:.3e} (tol "
        f"{PRED_TOL}); launches {counts200}")
    require(counts200 == {"gat_sep": model.cfg.depth}, f"pallas_sep launches {counts200}")
    require(err <= PRED_TOL, f"pallas_sep predictions at n={n} differ from JAX by {err:.3e}")
    return counts, counts200


def head(ds, k):
    """The first k instances of a dataset."""
    return dataclasses.replace(ds, coords=ds.coords[:k], features=ds.features[:k],
                               regret=ds.regret[:k], in_solution=ds.in_solution[:k],
                               opt_cost=ds.opt_cost[:k])


def phase14a_per_move_devices(dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.batched import run_fixed
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch

    for n, B in ((20, 8), (50, 4)):
        rng = np.random.default_rng(140 + n)
        D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
        noise = rng.random((B, n, n)).astype(np.float32)
        regret = np.maximum(D + 0.3 * (noise + noise.transpose(0, 2, 1)) - 0.4, 0.0)
        inits = nearest_neighbor_batch(torch.as_tensor(D)).numpy()
        for gname, G in (("weight", D[:, None]),
                         ("cycle of 2", np.stack([regret.astype(np.float32), D], axis=1))):
            for fi in (False, True):
                kw = dict(n_iters=5, perturbation_moves=8, first_improvement=fi)
                got = run_fixed(D, G, inits, device=dev, **kw)
                want = run_fixed(D, G, inits, device="cpu", **kw)
                for key in ("trace_n", "chunk_moves", "best_tours", "trace_costs",
                            "best_costs"):
                    require(np.array_equal(getattr(got, key), getattr(want, key)),
                            f"per-move engine n={n} {gname} first_improvement={fi}: {key} "
                            "differs between the card and the CPU")
                log(f"  per-move n={n} B={B} {gname} first_improvement={fi}: card == CPU "
                    f"(moves {got.trace_n.tolist()})")
    log("phase 14a: the per-move engine gives the same bits on the card and the CPU")


def phase14b_against_k1(ds, dev, guide64, init64):
    import numpy as np

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.batched import run_fixed, run_fixed_kernel

    k = len(guide64)
    D = coords_to_distance_matrix(ds.coords[:k]).astype(np.float32)
    res = run_fixed(D, guide64, init64, n_iters=N_ITERS, perturbation_moves=PM, device=dev)
    ker = run_fixed_kernel(D, guide64, init64, n_iters=N_ITERS, perturbation_moves=PM,
                           device=dev)
    require(np.array_equal(res.trace_n, ker.chunk_moves[:, -1]),
            "per-move engine vs K1: accepted moves differ")
    require(np.array_equal(res.best_tours, ker.best_tours),
            "per-move engine vs K1: best tours differ")
    require(np.array_equal(res.best_costs, ker.search_costs),
            "per-move engine vs K1: the search's best costs differ")
    search_s = res.chunk_times[-1] - res.chunk_times[0]
    moves = int(res.trace_n.sum())
    fx = json.loads((ROOT / FIXTURE100).read_text())
    costs = D[np.arange(k)[:, None], res.best_tours[:, :-1], res.best_tours[:, 1:]].sum(-1)
    eq = int((np.float32(costs) == np.float32(fx["best_cost"][:k])).sum())
    gap = float((costs.astype(np.float64) / ds.opt_cost[:k] - 1.0).mean() * 100.0)
    log(f"phase 14b: per-move engine == K1 on instances 0-{k - 1} (n_iters {N_ITERS}, pm "
        f"{PM}): {moves} accepted moves in {search_s:.3f} s ({moves / search_s:.4g} moves/s, "
        f"B={k}); vs JAX fixture: {eq}/{k} best costs equal, mean gap {gap:.4f}% vs "
        f"{fx['mean_gap']:.4f}%")
    require(k == len(fx["best_cost"]) and abs(gap - fx["mean_gap"]) <= 0.1,
            "per-move engine: mean gap over 0-63 differs from the JAX fixture by more than 0.1 pp")
    return res


def phase14c_wall_clock(model, ds, dev):
    import warnings

    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import evaluate, search_progress_records
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    out = evaluate(ds, model=model, guides=["regret_pred"], batch_size=BATCH, device=dev)
    wall = time.time() - t
    counts = dict(kernels.launches)
    want = {"gat_group": model.cfg.depth * -(-len(ds) // BATCH), "nearest_neighbor": 1}
    log(f"phase 14c: evaluate with the default time limit on {len(ds)} instances in "
        f"{wall:.1f} s; launches {counts}")
    require(counts == want, f"wall-clock main path launches {counts}, expected {want}")
    require(out["engine"] == "xla" and out["trace_mode"] == "per-move",
            f"wall-clock evaluate ran engine {out['engine']!r}")
    res = out["result"]
    for b in range(len(ds)):
        require(is_valid_tour(ds.n_nodes, out["best_tours"][b]), f"instance {b}: invalid tour")
    times = res.chunk_times
    require(len(times) >= 2 and all(b > a for a, b in zip(times, times[1:])),
            "chunk boundaries do not increase")
    require(times[-2] < res.deadline <= times[-1],
            "the last chunk boundary is not the first at or past the deadline")
    require(bool((np.diff(res.chunk_moves, axis=1) >= 0).all()), "chunk moves fell")
    cap = res.trace_costs.shape[1]
    saturated = int((res.trace_n > cap).sum())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = time.time()
        rows = search_progress_records(ds, out)
        rows_s = time.time() - t
    require(len(rows) == int(np.minimum(res.trace_n, cap).sum()), "progress rows missing")
    require(all(math.isfinite(r["time"]) and math.isfinite(r["cost"]) for r in rows[:: 997]),
            "progress rows not finite")
    chunks = len(times) - 1
    search_s = times[-1] - times[0]
    moved = int((res.chunk_moves[:, -1] - res.chunk_moves[:, 0]).sum())
    gaps = out["gaps"]
    log(f"  {chunks} chunks = {chunks} iterations in {search_s:.3f} s after the initial "
        f"local search; {int(res.chunk_moves[:, -1].sum())} accepted moves in all, {moved} in "
        f"the chunks ({moved / search_s:.4g} moves/s, B={len(ds)}); inference "
        f"{out['timings']['inference_s']:.3f} s; deadline {res.deadline - times[0]:.3f} s "
        f"after the first boundary, last boundary {times[-1] - res.deadline:.3f} s past it")
    log(f"  gap mean {gaps.mean():.4f}%  median {np.median(gaps):.4f}%  max {gaps.max():.4f}%; "
        f"{saturated}/{len(ds)} traces saturated (cap {cap}); {len(rows)} progress rows in "
        f"{rows_s:.2f} s")
    return counts


def phase14d_first_improvement(ds, dev):
    import numpy as np

    from gnngls_tpu_torch.evaluate import evaluate

    fx = json.loads((ROOT / FI_FIXTURE).read_text())
    k = len(fx["instances"])
    out = evaluate(head(ds, k), guides=["weight"], n_iters=20, perturbation_moves=20,
                   first_improvement=True, device=dev)
    require(out["engine"] == "xla", f"first-improvement ran engine {out['engine']!r}")
    moves = out["result"].trace_n
    require(np.array_equal(moves, fx["moves"]), "first-improvement moves differ from JAX's")
    rel = float(np.abs(out["best_costs"] / np.asarray(fx["best_cost"]) - 1.0).max())
    tours = sum(np.array_equal(a, b) for a, b in zip(out["best_tours"], fx["best_tours"]))
    log(f"phase 14d: first-improvement on instances 0-{k - 1}: moves equal to the JAX fixture "
        f"({int(moves.sum())}), best costs within rel {rel:.3e} (tol {FI_RTOL}), {tours}/{k} "
        f"best tours equal; search {out['timings']['search_s']:.3f} s")
    require(rel <= FI_RTOL, f"first-improvement best costs differ from JAX's by {rel:.3e}")


def phase14e_protocol(ds, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import (REFERENCE_10S_MOVES, calibrate_protocol_iters,
                                           evaluate)

    target = REFERENCE_10S_MOVES[ds.n_nodes]
    kernels.reset_launch_counts()
    t = time.time()
    budget = calibrate_protocol_iters(ds, target_moves=target, guides=["weight"], device=dev)
    calib_s = time.time() - t
    counts = dict(kernels.launches)
    require(counts.get("gls_whole", 0) >= 2 and set(counts) == {"gls_whole", "nearest_neighbor"}
            and counts["nearest_neighbor"] == counts["gls_whole"],
            f"the calibration's probes did not run through construction and K1 alone: {counts}")
    out = evaluate(ds, guides=["weight"], n_iters=budget, device=dev)
    reached = float(np.mean(out["moves"]))
    log(f"phase 14e: 10 s protocol at n={ds.n_nodes}: n_iters={budget} reaches {reached:.1f} "
        f"mean accepted moves (target {target:.0f}) in {calib_s:.1f} s of calibration, "
        f"{counts['gls_whole']} K1 launches; weight-guided gap at that budget "
        f"{out['mean_gap']:.4f}%")
    require(reached >= target, "the calibrated budget misses the move target")


def phase14f_pt_checkpoint(model, ds, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import predict_regret
    from gnngls_tpu_torch.models import torch_import

    path = kernels.build_dir() / "tsp100_checkpoint_best_val.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": torch_import.state_dict_from_params(model)}, path)
    back, _ = torch_import.load_checkpoint(path, model.cfg, device=dev)
    sub = head(ds, BATCH)
    a = predict_regret(back, sub, batch_size=BATCH, device=dev)
    b = predict_regret(model, sub, batch_size=BATCH, device=dev)
    require(np.array_equal(a, b), "the .pt model's predictions differ from the npz model's")
    log(f"phase 14f: {path.name} ({path.stat().st_size} bytes) predicts instances "
        f"0-{BATCH - 1} bit for bit as the npz checkpoint")


def train_step_on(model, dev, dtype, x, y, gat_impl="fast"):
    """One train step of a copy of `model` on `dev` in `dtype`: (loss, the
    gradient of every leaf, the BatchNorm running statistics), in float64
    on the host."""
    import copy

    import torch

    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    m = copy.deepcopy(model).to(device=dev, dtype=dtype)
    loss = train_step(m, make_optimizer(m), torch.as_tensor(x, dtype=dtype, device=dev),
                      torch.as_tensor(y, dtype=dtype, device=dev), gat_impl=gat_impl)
    grads = {k: p.grad.double().cpu() for k, p in m.named_parameters()}
    stats = {k: t.double().cpu() for k, t in m.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return float(loss), grads, stats


def hold_train_step(got, want, tol, what):
    """Two train_step_on results: the loss within TRAIN_LOSS_RTOL, each leaf
    within tol of its largest value, or of the largest over all leaves where
    its own is below VANISHING of that.  Returns (loss rel, worst of each
    kind over its bar times tol)."""
    rel = abs(got[0] - want[0]) / abs(want[0])
    require(math.isfinite(got[0]) and rel <= TRAIN_LOSS_RTOL,
            f"{what}: loss {got[0]} vs {want[0]}")
    worst = {}
    for kind, a, b in (("grad", got[1], want[1]), ("bn", got[2], want[2])):
        top = max(float(v.abs().max()) for v in b.values())
        for key in b:
            scale = float(b[key].abs().max())
            bar = tol * (scale if scale >= VANISHING * top else top)
            err = float((a[key] - b[key]).abs().max())
            require(err <= bar, f"{what}: {kind} {key} differs by {err:.3e} > {bar:.3e}")
            worst[kind] = max(worst.get(kind, 0.0), err / (bar / tol))
    return rel, worst


def phase15a_train_step(dev):
    """One train step on the card against the same step on the CPU, at embed
    32, 4 heads, depth 4, n=20, batch 8, from a seeded init_params and
    seeded inputs, in float64 and in the trainer's float32."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params

    n, B = 20, 8
    rng = np.random.default_rng(15)
    x = rng.random((B, n * (n - 1) // 2, 1)).astype(np.float32)
    y = rng.random((B, n * (n - 1) // 2, 1)).astype(np.float32)
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4), torch.Generator().manual_seed(15))
    for dtype, tol in ((torch.float64, TRAIN_TOL64), (torch.float32, TRAIN_TOL32)):
        got, want = train_step_on(model, dev, dtype, x, y), train_step_on(model, "cpu", dtype, x, y)
        rel, worst = hold_train_step(got, want, tol, f"train step {dtype}")
        log(f"  train step {str(dtype)[6:]}: card vs CPU loss rel {rel:.3e}, gradients within "
            f"{worst['grad']:.3e} and running statistics within {worst['bn']:.3e} of each "
            f"leaf's largest value (bar {tol})")
    log("phase 15a: one train step on the card matches the CPU")


def phase15b_resume(dev, run_dir):
    """train_model resumed from the shipped checkpoint on data/tsp100 at the
    shipped params.json settings for exactly epoch 26 (63 steps)."""
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.train import loop

    pj = json.loads((ROOT / "models/tsp100/params.json").read_text())
    cfg = loop.TrainConfig(**{**pj, "n_epochs": RESUME_EPOCH + 1})
    scalers = ROOT / "data/tsp100/scalers.json"
    sets = [TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                ROOT / f"data/tsp100/{split}.txt", scalers_file=scalers)
            for split in ("train", "val")]
    ckpt = ROOT / "models/tsp100/checkpoint_best_val.npz"
    with np.load(ckpt) as z:
        shipped = json.loads(bytes(z["__meta__"].tobytes()).decode())
        count0 = int(z["opt_state::count"])
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    stamps = []
    t = time.time()
    _, history = loop.train_model(*sets, cfg, run_dir, verbose=False, resume_from=ckpt,
                                  device=dev, step_times=stamps)
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k: v for k, v in kernels.launches.items() if v}
    require([r["epoch"] for r in history] == [RESUME_EPOCH],
            f"resumed run trained epochs {[r['epoch'] for r in history]}, expected [26]")
    row_ = history[0]
    lr = cfg.lr_init * cfg.lr_decay ** RESUME_EPOCH
    require(abs(row_["lr"] - lr) <= 1e-12 * lr, f"resumed lr {row_['lr']} != {lr}")
    require(math.isfinite(row_["loss"]) and math.isfinite(row_["val_loss"]), "loss not finite")
    N, bs = len(sets[0]), cfg.batch_size
    sizes = [min(bs, N - s) for s in range(0, N, bs)]
    require(len(stamps) == len(sizes), f"{len(stamps)} train steps, expected {len(sizes)}")
    timed = len(sizes) - TRAIN_WARMUP - 1
    span = stamps[-1] - stamps[TRAIN_WARMUP]
    edges = sum(sizes[TRAIN_WARMUP + 1:]) * sets[0].features.shape[1]
    with np.load(run_dir / "checkpoint_final.npz") as z:
        count = int(z["opt_state::count"])
    log(f"phase 15b: epoch {row_['epoch']} resumed from the shipped checkpoint (count {count0} "
        f"-> {count}) in {wall:.1f} s: train loss {row_['loss']:.6f} (checkpoint "
        f"{shipped['loss']:.6f}), val loss {row_['val_loss']:.6f} (checkpoint "
        f"{shipped['val_loss']:.6f}), lr {row_['lr']:.6e}; kernel launches {counts}")
    log(f"  {len(sizes)} steps at batch {bs}, n={sets[0].n_nodes}; steps {TRAIN_WARMUP + 1}-"
        f"{len(sizes)}: {timed / span:.4g} steps/s, {edges / span:.4g} training edges/s; "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    require(count == count0 + len(sizes), f"Adam count {count}, expected {count0 + len(sizes)}")
    require(row_["loss"] <= 2 * shipped["loss"] and row_["val_loss"] <= 2 * shipped["val_loss"],
            "the resumed epoch's losses exceed twice the checkpoint's")


def phase15c_serve(dev, run_dir, ds):
    """The trained checkpoint on the serving path: K2's predictions against
    the fast route's, then evaluate at n_iters 100."""
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import evaluate, predict_regret
    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

    model = load_model(run_dir / "checkpoint_final.npz", RegretGNNConfig(), device=dev)
    kernels.reset_launch_counts()
    k2 = predict_regret(model, ds, batch_size=BATCH, device=dev)
    counts = dict(kernels.launches)
    want = {"gat_group": model.cfg.depth * -(-len(ds) // BATCH)}
    require(counts == want, f"trained-model prediction launches {counts}, expected {want}")
    fast = predict_regret(model, ds, batch_size=BATCH, device=dev, gat_impl="fast")
    ab, rel = errs(torch.as_tensor(k2), torch.as_tensor(fast))
    log(f"phase 15c: the trained weights through K2 on {len(ds)} instances ({counts}): max abs "
        f"difference from the fast route {ab:.3e}, rel {rel:.3e} (tol {K2_REL_TOL})")
    require(bool(np.isfinite(k2).all()) and rel <= K2_REL_TOL,
            "K2's predictions with the trained weights differ from the fast route's")
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=N_ITERS,
                   perturbation_moves=PM, batch_size=BATCH, device=dev)
    gaps = out["gaps"]
    log(f"  evaluate (n_iters {N_ITERS}, pm {PM}): gap mean {gaps.mean():.4f}%  median "
        f"{np.median(gaps):.4f}%  max {gaps.max():.4f}% (shipped weights, phase 3: "
        f"{PARENT_GAP100[0]:.4f}%)")


def route_training_sets():
    """Phase 15d's data: data/tsp100's first ROUTE_TRAIN_INST train instances
    and its val instances."""
    from gnngls_tpu_torch.data.dataset import TSPDataset

    scalers = ROOT / "data/tsp100/scalers.json"
    train, val = (TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                      ROOT / f"data/tsp100/{split}.txt", scalers_file=scalers)
                  for split in ("train", "val"))
    return head(train, ROUTE_TRAIN_INST), val


def train_route(route, train, val, run_dir, dev):
    """Epoch 26 resumed from the shipped checkpoint (Adam state included)
    through `route` into run_dir: (config, history, step stamps, peak device
    bytes, kernel launches, every array of the final checkpoint: parameters,
    BatchNorm running statistics, Adam state)."""
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.train import loop

    pj = json.loads((ROOT / "models/tsp100/params.json").read_text())
    cfg = loop.TrainConfig(**{**pj, "n_epochs": RESUME_EPOCH + 1, "gat_impl": route})
    kernels.reset_launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stamps = []
    _, history = loop.train_model(train, val, cfg, run_dir, verbose=False,
                                  resume_from=ROOT / "models/tsp100/checkpoint_best_val.npz",
                                  device=dev, step_times=stamps)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k: v for k, v in kernels.launches.items() if v}
    with np.load(run_dir / "checkpoint_final.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return cfg, history, stamps, peak, counts, arrays


def serve_trained(model, sub, dev):
    """evaluate with the trained weights through K2 and K1 (n_iters 100, pm
    20), launches counted and tours checked."""
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    out = evaluate(sub, model=model, guides=["regret_pred"], n_iters=N_ITERS,
                   perturbation_moves=PM, batch_size=BATCH, device=dev)
    counts = {k: v for k, v in kernels.launches.items() if v}
    want = {"gat_group": model.cfg.depth, "gls_whole": 1, "nearest_neighbor": 1}
    require(counts == want, f"trained weights served with launches {counts}, expected {want}")
    for b in range(len(sub)):
        require(is_valid_tour(sub.n_nodes, out["best_tours"][b]), f"instance {b}: invalid tour")
    require(bool(np.isfinite(out["gaps"]).all()), "the served gaps are not finite")
    return out, counts


def phase15d_train_routes(dev, ds, gap64, card):
    """Epoch 26 resumed from the shipped checkpoint through each route that
    trains, on the same batches; then the sep_fast-trained weights served
    through K2 and K1 on tsp100 test instances 0-63.  Returns each route's
    (history, checkpoint arrays) and the served result, for phase 18, and the
    `sep` run's rank-sums launches."""
    import numpy as np

    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

    train, val = route_training_sets()
    with np.load(ROOT / "models/tsp100/checkpoint_best_val.npz") as z:
        shipped = json.loads(bytes(z["__meta__"].tobytes()).decode())
    E = train.features.shape[1]
    runs, first, launched = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for route in TRAINED_ROUTES:
            cfg, history, stamps, peak, counts, arrays = train_route(
                route, train, val, pathlib.Path(tmp) / route, dev)
            sizes = [min(cfg.batch_size, len(train) - s)
                     for s in range(0, len(train), cfg.batch_size)]
            require([r["epoch"] for r in history] == [RESUME_EPOCH] and len(stamps) == len(sizes),
                    f"{route}: trained epochs {[r['epoch'] for r in history]} in {len(stamps)} "
                    f"steps, expected [{RESUME_EPOCH}] in {len(sizes)}")
            # the sorted-prefix routes' adjoint: two rank-sums launches a layer a step
            depth = RegretGNNConfig(n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                                    depth_from_heads=cfg.depth_from_heads).depth
            want = ({"rank_sums": 2 * len(sizes) * depth} if route in ("sep", "sep_fast")
                    else {})
            require(counts == want, f"{route}: training launched {counts}, expected {want}")
            launched[route] = counts
            row_ = history[0]
            require(math.isfinite(row_["loss"]) and math.isfinite(row_["val_loss"])
                    and row_["loss"] <= 2 * shipped["loss"]
                    and row_["val_loss"] <= 2 * shipped["val_loss"],
                    f"{route}: losses {row_['loss']}, {row_['val_loss']} not within twice the "
                    f"checkpoint's")
            span = stamps[-1] - stamps[TRAIN_WARMUP]
            runs[route] = (row_, (len(sizes) - TRAIN_WARMUP - 1) / span,
                           sum(sizes[TRAIN_WARMUP + 1:]) * E / span, peak)
            first[route] = (history, arrays)
            if route == "sep_fast":
                model = load_model(pathlib.Path(tmp) / route / "checkpoint_final.npz",
                                   RegretGNNConfig(), device=dev)
    log(f"phase 15d ({card}): epoch {RESUME_EPOCH} resumed from the shipped checkpoint through "
        f"each route on the first {len(train)} train instances ({len(sizes)} steps at batch "
        f"{cfg.batch_size}, n={train.n_nodes}) and {len(val)} val instances; steps "
        f"{TRAIN_WARMUP + 1}-{len(sizes)} timed; launches {launched}; checkpoint train loss "
        f"{shipped['loss']:.6f}, val loss {shipped['val_loss']:.6f}")
    base = runs["fast"][0]
    for route, (row_, steps_s, edges_s, peak) in runs.items():
        before = (f" (before the fixed-order adjoint: {PARENT_SEP_STEPS[route]} steps/s)"
                  if route in PARENT_SEP_STEPS else "")
        log(f"  {route:8s} {steps_s:.4g} steps/s{before}, {edges_s:.4g} training edges/s, peak "
            f"device memory {peak} bytes ({peak / 2**30:.2f} GiB); train loss "
            f"{row_['loss']:.6f} (rel {abs(row_['loss'] - base['loss']) / base['loss']:.3e} from "
            f"fast's), val loss {row_['val_loss']:.6f} (rel "
            f"{abs(row_['val_loss'] - base['val_loss']) / base['val_loss']:.3e})")
    out, counts = serve_trained(model, head(ds, BATCH), dev)
    log(f"  the sep_fast-trained weights through K2 and K1 on instances 0-{BATCH - 1} "
        f"({counts}; n_iters {N_ITERS}, pm {PM}): mean gap {out['gaps'].mean():.4f}% (shipped "
        f"weights, phase 3, on the same instances: {gap64:.4f}%)")
    return first, out, launched["sep"].get("rank_sums", 0)


def phase15e_rank_sums(model, dev, launches):
    """The rank-sums kernel (the sorted-prefix routes' adjoint) at phase 15d's
    shape: the first call of a `sep` train step on data/tsp100's train
    instances 0-31, caught on its way in; against its twin on the CPU bit for
    bit, twice; timed beside its twin and torch's scatter-add on the card.
    Then whole `sep` and `sep_fast` steps on that batch with either adjoint,
    the kernel or its twin on the card (autograd's own adjoint of the
    gathers, which the route had before the kernel): whether two steps from
    one state give the same gradients, and steps/s in turns."""
    import copy

    import numpy as np
    import torch

    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.ops import gat_sep
    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    train = TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz", ROOT / "data/tsp100/train.txt",
                                scalers_file=ROOT / "data/tsp100/scalers.json")
    batch = train.get_scaled_batch(np.arange(32))
    x, y = (torch.as_tensor(batch[k], device=dev) for k in ("features", "regret"))
    caught, kernel = [], gat_sep.rank_sums

    def catch(idx, g, gh):
        if not caught:
            caught.append(tuple(t.detach().clone() for t in (idx, g, gh)))
        return kernel(idx, g, gh)

    gat_sep.rank_sums = catch
    try:
        m = copy.deepcopy(model)
        train_step(m, make_optimizer(m), x, y, gat_impl="sep")
    finally:
        gat_sep.rank_sums = kernel
    del m
    idx, g, gh = caught[0]
    got, again = gat_sep.rank_sums(idx, g, gh), gat_sep.rank_sums(idx, g, gh)
    want = gat_sep.rank_sums_plain(*(t.cpu() for t in (idx, g, gh)))
    for a, b, c in zip(got, again, want):
        require(torch.equal(a.cpu(), c) and torch.equal(a, b),
                "rank_sums: the kernel differs from its twin on the CPU or from itself")
    ms = cuda_ms(lambda: gat_sep.rank_sums(idx, g, gh), reps=20, warmup=2)
    plain = cuda_ms(lambda: gat_sep.rank_sums_plain(idx, g, gh), reps=20, warmup=2)
    gz, ghz, idx_h = torch.zeros_like(g), torch.zeros_like(gh), idx[..., None].expand(gh.shape)
    library = cuda_ms(lambda: (torch.scatter_add(gz, -2, idx, g),
                               torch.scatter_add(ghz, -3, idx_h, gh)), reps=20, warmup=2)
    K, H, F = gh.shape[-3:]
    R = g.numel() // (K * H)
    shared = (idx[..., None, :, :] == torch.arange(K, device=dev)[:, None, None]).sum(-2).amax()
    ops = R * K * H * (F + 1)  # one add a target and column
    nbytes = R * K * H * (8 + 2 * 4 * (F + 1))  # idx read, g and gh read, gs and gsh written
    log(f"phase 15e: the rank-sums kernel at R={R} (B=32 x n=100) K={K} H={H} F={F} (at most "
        f"{int(shared)} targets on a rank): equal to its twin on the CPU bit for bit, and to "
        f"itself; {ms:.4f} ms/launch, the twin (torch's scatter-add, atomics) on the card "
        f"{plain:.4f} ms, two torch.scatter_add calls {library:.4f} ms; {launches} launches "
        f"in phase 15d's sep run")
    del caught, got, again, want, gz, ghz
    adjoints = {"kernel": kernel, "scatter-add": gat_sep.rank_sums_plain}

    def steps(route, adjoint, n):
        """n steps from the shipped state: (the first step's gradients, steps/s of
        the rest after one more)."""
        gat_sep.rank_sums = adjoints[adjoint]
        try:
            m = copy.deepcopy(model)
            opt = make_optimizer(m)
            train_step(m, opt, x, y, gat_impl=route)
            grads = [q.grad.clone() for q in m.parameters()]
            train_step(m, opt, x, y, gat_impl=route)
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            for _ in range(n):
                train_step(m, opt, x, y, gat_impl=route)
            torch.cuda.synchronize(dev)
            return grads, n / (time.perf_counter() - t)
        finally:
            gat_sep.rank_sums = kernel

    for route in ("sep", "sep_fast"):
        runs = {a: [] for a in adjoints}
        for adjoint in ("kernel", "scatter-add", "scatter-add", "kernel"):
            runs[adjoint].append(steps(route, adjoint, STEP_TURNS))
        differ = {a: [int(not torch.equal(p, q)) for p, q in zip(r[0][0], r[1][0])]
                  for a, r in runs.items()}
        require(not any(differ["kernel"]), f"{route}: two steps through the rank-sums kernel "
                f"give other gradients")
        log(f"  {route:8s} step (B=32): two from one state give {sum(differ['kernel'])} "
            f"differing gradient leaves with the kernel, {sum(differ['scatter-add'])} of "
            f"{len(differ['scatter-add'])} with torch's scatter-add; steps/s in turns: kernel "
            f"{runs['kernel'][0][1]:.4g}, scatter-add {runs['scatter-add'][0][1]:.4g}, "
            f"scatter-add {runs['scatter-add'][1][1]:.4g}, kernel {runs['kernel'][1][1]:.4g}")
    return row("rank_sums", "gnngls_tpu_torch/csrc/rank_sums.cu",
               "gnngls_tpu/ops/gat_sep.py:176", launches, 0.0, ms, plain, ops, nbytes,
               f"R={R} K={K} H={H} F={F} f32; the adjoint of the sep routes' reads at rank, "
               f"XLA's transpose of take_along_axis in the JAX package (no Pallas kernel); "
               f"launches from phase 15d's sep run", library_ms=library)


def tie(M):
    import numpy as np

    return TIE_ULPS * float(np.spacing(np.float32(M)))


def raw_tsp100(k):
    """Rows 0..k-1 of data/tsp100/instances.npz (the shipped labels included)."""
    import numpy as np

    with np.load(ROOT / "data/tsp100/instances.npz") as z:
        return {key: z[key][:k] for key in ("coords", "opt_tour", "opt_cost", "in_solution",
                                            "regret")}


def phase16a_k_input(dev, raw):
    """K1 given a k per lane against its plain twin on the card, move for move."""
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data import solvers
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    edges = build_topology(100).edges
    D = coords_to_distance_matrix(raw["coords"][:2]).astype("float64")
    # 19,800 and 4,950 lanes: each one launch under solvers.MAX_D2_BYTES
    (_, _, W2, winit, wk), = solvers.warm_lanes(D, edges, raw["opt_tour"][:2],
                                                dual_splice=True, device=dev)
    (_, _, C2, cinit, ck), = solvers.cold_lanes(D[0], edges, device=dev)
    cases = [("warm lanes of instances 0-1", W2, winit, wk, 2, LABEL_PM),
             ("warm lanes of instances 0-1", W2, winit, wk, 0, LABEL_PM),
             ("cold lanes of instance 0", C2, cinit, ck, 10, 30)]
    for name, D2, init, k, iters, pm in cases:
        got = gls_whole(D2, D2, init, n_iters=iters, perturbation_moves=pm, k=k)
        torch.cuda.synchronize()
        want = gls_fixed_plain(D2, D2, init, n_iters=iters, perturbation_moves=pm, k=k)
        for key in got._fields:
            require(torch.equal(getattr(got, key), getattr(want, key)),
                    f"K1 with k, {name}, n_iters {iters}: {key} differs from the plain twin")
        log(f"  K1 with k, {name} (B={D2.shape[0]}, n_iters {iters}, pm {pm}): identical to "
            f"the twin ({int(got.moves.sum())} moves, {int(got.work[:, 0].sum())} "
            f"local-search rounds)")
    # k=None: the kernel computes k itself, as before the k input; given that same k
    # explicitly it must give the same bits (the twin's k=None path is unchanged)
    from gnngls_tpu_torch.search.local_search import penalty_scale
    from gnngls_tpu_torch.search.moves import tour_costs

    k0 = penalty_scale(tour_costs(W2, winit.long()), 100)
    own = gls_whole(W2, W2, winit, n_iters=2, perturbation_moves=LABEL_PM)
    given = gls_whole(W2, W2, winit, n_iters=2, perturbation_moves=LABEL_PM, k=k0)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(own, given)),
            "K1 with k=None differs from K1 given its own default k")
    log("phase 16a: K1 with a k input matches its twin move for move; k=None keeps its bits")


def stage_clock(secs):
    """Wraps the label path's stages in their modules until the returned
    function restores them: host-clock seconds added to `secs` under "lanes"
    (warm_lanes: the reduced matrices and splices of each launch), "k1",
    "recost" (the f64 re-costing), "uses_edge" and "batch" (the whole
    warm_fixed_edge_costs_batch call).  Each stage synchronises the card
    where it ends, as the copy of K1's results to the host does anyway."""
    import torch

    from gnngls_tpu_torch.data import solvers
    from gnngls_tpu_torch.search import gls_whole

    def clocked(key, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t
            return out
        return call

    def lanes(*args, **kw):
        launches = old[solvers, "warm_lanes"](*args, **kw)
        while True:
            t = time.perf_counter()
            item = next(launches, None)
            torch.cuda.synchronize()
            secs["lanes"] += time.perf_counter() - t
            if item is None:
                return
            yield item
            del item  # one launch's stack at a time, as in warm_lanes

    old = {(solvers, "warm_lanes"): solvers.warm_lanes,
           (solvers, "_costs64"): solvers._costs64,
           (solvers, "_uses_edge"): solvers._uses_edge,
           (solvers, "warm_fixed_edge_costs_batch"): solvers.warm_fixed_edge_costs_batch,
           (gls_whole, "gls_whole"): gls_whole.gls_whole}
    new = {"warm_lanes": lanes, "_costs64": clocked("recost", solvers._costs64),
           "_uses_edge": clocked("uses_edge", solvers._uses_edge),
           "warm_fixed_edge_costs_batch": clocked("batch", solvers.warm_fixed_edge_costs_batch),
           "gls_whole": clocked("k1", gls_whole.gls_whole)}
    for (mod, name) in old:
        setattr(mod, name, new[name])
    return lambda: [setattr(mod, name, fn) for (mod, name), fn in old.items()]


def phase16b_labels(dev, raw):
    """The production label path over 64 raw tsp100 instances, its stages
    on the host clock."""
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.data.labels import warm_labels_chunked
    from gnngls_tpu_torch.utils import is_valid_tour

    N, n = LABEL_INST, 100
    E = n * (n - 1) // 2
    data = {k: np.array(v) for k, v in raw.items() if k != "regret"}
    secs = dict.fromkeys(("lanes", "k1", "recost", "uses_edge", "batch"), 0.0)
    restore = stage_clock(secs)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            out = warm_labels_chunked(data, tmp, chunk=LABEL_CHUNK, warm_gls_iters=0,
                                      dual_splice=True, perturbation_moves=LABEL_PM,
                                      device=dev)
            wall = time.perf_counter() - t
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(dev)
    counts = dict(kernels.launches)
    require(counts.get("gls_whole", 0) > 0, f"the label path did not launch K1: {counts}")
    regret, tours, opt = out["regret"], out["opt_tour"], out["opt_cost"]
    D = coords_to_distance_matrix(raw["coords"]).astype(np.float64)
    require(regret.shape == (N, E) and bool(np.isfinite(regret).all()) and (regret >= 0).all(),
            "labels: regret not finite and non-negative of shape (64, 4950)")
    require(not regret[out["in_solution"]].any(), "labels: solution edges with regret")
    for b in range(N):
        require(is_valid_tour(n, tours[b]), f"labels: instance {b}'s best tour is invalid")
    exact = D[np.arange(N)[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)
    require(np.allclose(exact, opt, rtol=1e-12, atol=0), "labels: opt_cost is not its tour's cost")
    refined = int((opt < raw["opt_cost"] - 1e-9).sum())
    with np.load(ROOT / LABEL_FIXTURE) as fx:
        fx = {k: fx[k] for k in fx.files}
    k = len(fx["opt_cost"])
    worst, same = 0.0, 0
    for b in range(k):
        M = n * D[b].max() + 1.0
        d = float(np.abs(regret[b] - fx["regret"][b]).max())
        worst = max(worst, d)
        same += int(np.array_equal(regret[b], fx["regret"][b]))
        require(abs(opt[b] - fx["opt_cost"][b]) <= tie(M) and d <= tie(M) / fx["opt_cost"][b],
                f"labels: instance {b} differs from the JAX fixture beyond {TIE_ULPS} ulps "
                f"at M (regret by {d:.3e}, opt_cost by {abs(opt[b] - fx['opt_cost'][b]):.3e})")
    shipped = np.abs(regret - raw["regret"]).max(axis=1)
    lanes = N * E * 2
    log(f"phase 16b: {N} tsp100 instances labelled in {wall:.2f} s ({N / wall:.4g} instances/s, "
        f"{N * E / wall:.4g} forced-edge problems/s, {lanes / wall:.4g} K1 lanes/s, "
        f"{wall / N:.4f} s/instance); launches {counts}; peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); {refined} best tours refined")
    inner = secs["lanes"] + secs["k1"] + secs["recost"] + secs["uses_edge"]
    log(f"  stages (host clock, s): reduced matrices and splices {secs['lanes']:.4f}, K1 "
        f"{secs['k1']:.4f}, f64 re-costing {secs['recost']:.4f}, forced-edge check "
        f"{secs['uses_edge']:.4f}, the oracle call's rest (copies to the host, the "
        f"splices' choice) {secs['batch'] - inner:.4f}; outside the oracle (distances, "
        f"refinement, regrets, shard files) {wall - secs['batch']:.4f}")
    log(f"  vs JAX fixture (instances 0-{k - 1}): {same}/{k} regret rows identical, largest "
        f"difference {worst:.3e} (tol {TIE_ULPS} ulps at M over opt_cost)")
    log(f"  vs shipped labels: {int((shipped <= 1e-8).sum())}/{N} instances within 1e-8, "
        f"{int((shipped <= 1e-6).sum())}/{N} within 1e-6; "
        f"{float((np.abs(regret - raw['regret']) <= 1e-6).mean()):.4f} of all edges within 1e-6")
    return counts.get("gls_whole", 0), wall


def phase16b_timing(dev, raw):
    """K1 and its twin at one launch of the label path (its first: the most
    lanes a launch takes), beside the time to build that launch's inputs."""
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data import solvers
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    edges = build_topology(100).edges
    D = coords_to_distance_matrix(raw["coords"]).astype("float64")

    def first_launch():
        return next(solvers.warm_lanes(D, edges, raw["opt_tour"], dual_splice=True,
                                       device=dev))

    build_ms = cuda_ms(first_launch, reps=3)
    _, e, D2, init, k = first_launch()
    res = {}

    def run(fn, key):
        res[key] = fn(D2, D2, init, n_iters=0, perturbation_moves=LABEL_PM, k=k)

    ms = cuda_ms(lambda: run(gls_whole, "kernel"), reps=3)
    plain = cuda_ms(lambda: run(gls_fixed_plain, "plain"), reps=1, warmup=0)
    for key in res["kernel"]._fields:
        require(torch.equal(getattr(res["kernel"], key), getattr(res["plain"], key)),
                f"K1 at the label path's launch: {key} differs from the plain twin")
    ops, nbytes = gls_work(res["kernel"].work, 100, 0, 0)  # the guide is D2 itself: read once
    err = float((res["kernel"].best_costs - res["plain"].best_costs).abs().max())
    log(f"  K1 at the label launch (B={e} n=100 n_iters 0, k given): {ms:.3f} ms, plain "
        f"{plain:.1f} ms, identical; building its reduced matrices and splices {build_ms:.3f} ms")
    return e, err, ms, plain, ops, nbytes, build_ms


def phase16c_clis(dev, model):
    """Both data CLIs on the card, then the result read and predicted through K2."""
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.cli import generate_instances, preprocess_dataset
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix, load_dataset
    from gnngls_tpu_torch.evaluate import predict_regret

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp) / "tsp100_generated"
        kernels.reset_launch_counts()
        t = time.time()
        generate_instances.main(["32", "100", str(root), "--solver", "gls",
                                 "--opt_iters", "100", "--seed", "7"])
        gen_s = time.time() - t
        counts = dict(kernels.launches)
        require(counts.get("gls_whole", 0) >= 2,
                f"generation did not run the GLS oracle and the labels on K1: {counts}")
        preprocess_dataset.main([str(root), "--n_train", "24", "--n_test", "4",
                                 "--n_val", "4", "--seed", "0"])
        data = load_dataset(root / "instances.npz")
        D = coords_to_distance_matrix(data["coords"]).astype(np.float64)
        t_ = data["opt_tour"]
        cost = D[np.arange(32)[:, None], t_[:, :-1], t_[:, 1:]].sum(-1)
        require(data["regret"].shape == (32, 4950) and bool(np.isfinite(data["regret"]).all())
                and (data["regret"] >= 0).all() and not data["regret"][data["in_solution"]].any(),
                "generated labels are not finite, non-negative and zero on the tours")
        require(np.allclose(cost, data["opt_cost"], rtol=1e-6), "opt_cost is not its tour's cost")
        sizes = [len(np.loadtxt(root / f"{s}.txt", ndmin=1)) for s in ("train", "val", "test")]
        require(sizes == [24, 4, 4], f"split sizes {sizes}")
        ds = TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
        kernels.reset_launch_counts()
        pred = predict_regret(model, ds, batch_size=len(ds), device=dev)
        pcounts = dict(kernels.launches)
    require(pcounts == {"gat_group": model.cfg.depth}, f"prediction launches {pcounts}")
    require(pred.shape == (4, 4950) and bool(np.isfinite(pred).all()) and (pred >= 0).all(),
            "predictions on the generated set are not finite and non-negative")
    log(f"phase 16c: generate_instances (32 instances, n=100) in {gen_s:.2f} s, launches "
        f"{counts}; preprocess_dataset split {sizes}; predict_regret on the test split "
        f"{pcounts}, mean prediction {float(pred.mean()):.4f}")


def phase16d_native():
    """The native C++ oracle built on this host against the numpy Held-Karp."""
    import numpy as np

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data import native_oracle, solvers
    from gnngls_tpu_torch.utils import is_valid_tour, tour_cost

    t = time.time()
    require(native_oracle.build() and native_oracle.available(), "the native oracle did not build")
    build_s = time.time() - t
    n = 12
    pos = np.random.default_rng(16).random((n, 2))
    D = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    tour, cost = native_oracle.held_karp(D)
    _, want = solvers.held_karp(D)
    require(abs(cost - want) <= 1e-9 and is_valid_tour(n, tour)
            and abs(tour_cost(D, tour) - cost) <= 1e-9, "native Held-Karp differs from numpy's")
    costs, base = native_oracle.regret_costs(D)
    edges = build_topology(n).edges
    for e in range(0, len(edges), 11):
        _, c = solvers.held_karp_fixed_edge(D, tuple(edges[e]))
        require(abs(costs[e] - c) <= 1e-9, f"native forced-edge cost of edge {e} differs")
    log(f"phase 16d: native oracle built in {build_s:.1f} s; Held-Karp and forced-edge costs "
        f"at n={n} equal numpy's (optimum {cost:.6f})")


def timed_predictions(model, ds, dev, batch, gat_impl):
    """(predictions, seconds, peak device bytes) of predict_regret."""
    import torch

    from gnngls_tpu_torch.evaluate import predict_regret

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.time()
    preds = predict_regret(model, ds, batch_size=batch, device=dev, gat_impl=gat_impl)
    secs = time.time() - t
    return preds, secs, torch.cuda.max_memory_allocated(dev)


def searched_gap(preds, coords, opt_cost, n_iters, dev, what):
    """The search on the predictions (nearest neighbour on the regret, K1 with
    it as the only guide): valid tours, and the mean gap in percent."""
    import numpy as np

    from gnngls_tpu_torch.evaluate import search_on_predictions
    from gnngls_tpu_torch.utils import is_valid_tour

    res, search_s = search_on_predictions(preds, coords, n_iters=n_iters,
                                           perturbation_moves=20, device=dev)
    n = coords.shape[1]
    for i in range(len(coords)):
        require(is_valid_tour(n, res.best_tours[i]), f"{what} instance {i}: invalid tour")
    gaps = (res.best_costs / opt_cost - 1.0) * 100.0
    require(bool(np.isfinite(gaps).all()), f"{what}: gaps are not finite")
    return float(gaps.mean()), search_s


def phase17a_chunked(model, data, out500, dev, card):
    import numpy as np

    from gnngls_tpu_torch.evaluate import predict_regret

    k = N_CHUNKED
    ds = generated_dataset(data, k)
    predict_regret(model, generated_dataset(data, 1), batch_size=1, device=dev,
                   gat_impl="chunked")  # warm-up
    preds, secs, peak = timed_predictions(model, ds, dev, BATCH_CHUNKED, "chunked")
    diff, rho = rank_agreement(preds, predictions(out500, N500)[:k], dev)
    log(f"phase 17a ({card}): chunked predictions on {k} n={N500} instances at batch "
        f"{BATCH_CHUNKED} (city chunks of 10): one forward {secs:.3f} s, "
        f"{preds.size / secs:.4g} edges/s, peak device memory {peak} bytes; vs phase 7's K3 "
        f"predictions: max abs difference {diff:.3e}, Spearman {rho:.7f}")
    require(bool(np.isfinite(preds).all()), "chunked predictions are not finite")
    require(diff <= PRED_TOL, f"chunked predictions differ from K3's by {diff:.3e} > {PRED_TOL}")
    require(rho >= SPEARMAN_MIN, f"chunked: Spearman {rho:.6f} against K3's < {SPEARMAN_MIN}")
    gap, search_s = searched_gap(preds, ds.coords, np.asarray(data["opt_cost"])[:k],
                                 N_ITERS500, dev, "chunked path")
    log(f"  search (n_iters {N_ITERS500}, pm 20, K1's global layout) {search_s:.3f} s: mean "
        f"gap {gap:.4f}% vs the oracle (phase 7 on these {k}: "
        f"{float(out500['gaps'][:k].mean()):.4f}%)")

    fx = np.load(ROOT / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")
    B, n, _ = fx["coords"].shape
    ds200 = generated_dataset({"coords": fx["coords"], "opt_cost": np.ones(B),
                            "in_solution": np.zeros((B, n * (n - 1) // 2), bool)})
    p200 = predict_regret(model, ds200, batch_size=B, device=dev, gat_impl="chunked")
    err = float(np.abs(p200 - fx["pred"]).max())
    log(f"  chunked on the n={n} JAX fixture: predictions max abs {err:.3e} (tol {PRED_TOL})")
    require(err <= PRED_TOL, f"chunked predictions at n={n} differ from JAX by {err:.3e}")


def phase17b_bf16(model, ds, k2_preds, gap3, dev, card):
    import copy

    import numpy as np
    import torch

    preds, secs, peak = timed_predictions(model, ds, dev, BATCH, "bf16")
    diff, rho = rank_agreement(preds, k2_preds, dev)
    log(f"phase 17b ({card}): bf16 predictions on {len(ds)} tsp100 instances at batch {BATCH} "
        f"in {secs:.3f} s ({preds.size / secs:.4g} edges/s), peak device memory {peak} "
        f"bytes; vs phase 3's K2 predictions: max abs difference {diff:.3e}, Spearman "
        f"{rho:.7f}")
    require(bool(np.isfinite(preds).all()), "bf16 predictions are not finite")
    x = ds.get_scaled_batch([0, 1])["features"]
    with torch.no_grad():
        got = model(torch.as_tensor(x, device=dev), gat_impl="bf16").cpu().numpy()
        cpu = copy.deepcopy(model).cpu()
        want = cpu(torch.as_tensor(x), gat_impl="bf16").numpy()
    err = float(np.abs(got - want).max())
    bar = BF16_CARD_TOL * max(1.0, float(np.abs(want).max()))
    log(f"  instances 0-1, bf16 route on the card vs the CPU: max abs {err:.3e} (bar {bar:.3e})")
    require(err <= bar, f"bf16 route: card vs CPU {err:.3e} > {bar:.3e}")
    gap, search_s = searched_gap(preds, ds.coords, ds.opt_cost, N_ITERS, dev, "bf16 path")
    log(f"  search (n_iters {N_ITERS}, pm {PM}) {search_s:.3f} s: mean gap {gap:.4f}% (phase "
        f"3's through K2: {gap3:.4f}%)")


def conv_grads_on(route, dev, dtype, arrays, x, ct, n, H):
    """The gradient of sum(GATConv(x) * ct) over (fc_w, attn_l, attn_r, x)."""
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.models.regret_gat import gat_conv_for
    from gnngls_tpu_torch.ops.gat import GATParams

    leaves = [torch.tensor(a, dtype=dtype, device=dev, requires_grad=True) for a in (*arrays, x)]
    out = gat_conv_for(route)(GATParams(*leaves[:3]), build_topology(n), leaves[3], H)
    (out * torch.as_tensor(ct, dtype=dtype, device=dev)).sum().backward()
    return [t.grad.double().cpu() for t in leaves]


def leaf_misses(got, want, twin):
    """The largest miss over the gradient leaves: a leaf's error over
    GRAD_TOL of its scale, times GRAD_TOL, or over VANISHING_TOL of the
    largest where the f32 twin's gradient of the leaf is below VANISHING of
    its largest (tests/test_torch_train_bf16.py)."""
    top = max(float(v.abs().max()) for v in want.values())
    twin_top = max(float(v.abs().max()) for v in twin.values())
    worst = 0.0
    for key, w in want.items():
        vanishing = float(twin[key].abs().max()) < VANISHING * twin_top
        bar = VANISHING_TOL * top if vanishing else GRAD_TOL * float(w.abs().max())
        worst = max(worst, GRAD_TOL * float((got[key] - w).abs().max()) / bar)
    return worst


def phase17c_train_routes(dev, card):
    import numpy as np
    import torch

    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params

    n, B = 20, 8
    rng = np.random.default_rng(15)
    E = n * (n - 1) // 2
    x = rng.random((B, E, 1)).astype(np.float32)
    y = rng.random((B, E, 1)).astype(np.float32)
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4),
                        torch.Generator().manual_seed(15))
    for dtype, tol in ((torch.float64, TRAIN_TOL64), (torch.float32, TRAIN_TOL32)):
        got = train_step_on(model, dev, dtype, x, y, gat_impl="chunked")
        want = train_step_on(model, "cpu", dtype, x, y, gat_impl="chunked")
        rel, worst = hold_train_step(got, want, tol, f"chunked train step {dtype}")
        log(f"  chunked train step {str(dtype)[6:]}: card vs CPU loss rel {rel:.3e}, gradients "
            f"within {worst['grad']:.3e} and running statistics within {worst['bn']:.3e} of "
            f"each leaf's largest value (bar {tol})")
    for route in F32_TWIN:
        got = train_step_on(model, dev, torch.float64, x, y, gat_impl=route)
        want = train_step_on(model, "cpu", torch.float64, x, y, gat_impl=route)
        rel, worst = hold_train_step(got, want, TRAIN_TOL64, f"{route} train step float64")
        log(f"  {route} train step float64: card vs CPU loss rel {rel:.3e}, gradients within "
            f"{worst['grad']:.3e}, running statistics within {worst['bn']:.3e} (bar "
            f"{TRAIN_TOL64})")
        want = train_step_on(model, "cpu", torch.float32, x, y, gat_impl=route)
        twin = train_step_on(model, "cpu", torch.float32, x, y, gat_impl=F32_TWIN[route])[1]
        spread = loss_spread = 0.0
        for seed in range(N_NOISE):
            noise = np.random.default_rng(seed).standard_normal(x.shape)
            moved = train_step_on(model, "cpu", torch.float32,
                                  (x * (1.0 + NOISE * noise)).astype(np.float32), y,
                                  gat_impl=route)
            spread = max(spread, leaf_misses(moved[1], want[1], twin))
            loss_spread = max(loss_spread, abs(moved[0] - want[0]) / abs(want[0]))
        got = train_step_on(model, dev, torch.float32, x, y, gat_impl=route)
        miss = leaf_misses(got[1], want[1], twin)
        rel = abs(got[0] - want[0]) / abs(want[0])
        log(f"  {route} train step float32: card vs CPU loss rel {rel:.3e}, largest gradient "
            f"miss {miss:.3e}; the CPU's own spread under {NOISE:g} input noise ({N_NOISE} "
            f"seeds): loss {loss_spread:.3e}, gradients {spread:.3e} (bars {SPREAD_FACTOR} x "
            f"spread)")
        require(math.isfinite(got[0]) and rel <= SPREAD_FACTOR * loss_spread,
                f"{route} float32 train step: loss {got[0]} vs {want[0]}, rel {rel:.3e} over "
                f"{SPREAD_FACTOR} x the CPU's spread {loss_spread:.3e}")
        require(miss <= SPREAD_FACTOR * spread,
                f"{route} float32 train step: card vs CPU miss {miss:.3e} exceeds "
                f"{SPREAD_FACTOR} x the CPU's spread {spread:.3e}")
    H, F = 4, 8
    arrays = [rng.normal(size=s) * 0.5 for s in ((H * F, H * F), (H, F), (H, F))]
    xc, ct = rng.normal(size=(B, E, H * F)), rng.normal(size=(B, E, H * F))
    for route in F32_TWIN:
        got = conv_grads_on(route, dev, torch.float64, arrays, xc, ct, n, H)
        want = conv_grads_on(route, "cpu", torch.float64, arrays, xc, ct, n, H)
        worst = 0.0
        for a, b, name in zip(got, want, ("fc_w", "attn_l", "attn_r", "x")):
            err = float((a - b).abs().max()) / float(b.abs().max())
            require(err <= BF16_GRAD_TOL, f"{route} GATConv gradient {name}: card vs CPU "
                    f"{err:.3e} > {BF16_GRAD_TOL} of its scale")
            worst = max(worst, err)
        log(f"  {route}: its GATConv gradient in float64 on the card within {worst:.3e} of "
            f"each leaf's scale of the CPU's (bar {BF16_GRAD_TOL})")
    log(f"phase 17c ({card}): chunked, bf16 and sep_fast train on the card as on the CPU")


def phase17d_construction(ds, k2_preds, dev, card):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import edge_vector_to_matrix
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import (best_probabilistic_nearest_neighbour,
                                                   gumbel_noise)
    from gnngls_tpu_torch.utils import is_valid_tour

    n = ds.n_nodes
    W = coords_to_distance_matrix(ds.coords[:1])[0].astype(np.float32)
    R = edge_vector_to_matrix(k2_preds[0].astype(np.float32), n)
    noise = gumbel_noise((PNN_SAMPLES, n - 1, n), torch.Generator().manual_seed(17))
    tours = []
    for d in (dev, torch.device("cpu")):
        tours.append(best_probabilistic_nearest_neighbour(
            torch.as_tensor(W, device=d), 0, PNN_SAMPLES, guide=torch.as_tensor(R, device=d),
            noise=noise).cpu())
    require(torch.equal(tours[0], tours[1]), "probabilistic nearest neighbour: the card's "
            "tour differs from the CPU's on the same noise")
    t = tours[0].numpy()
    require(is_valid_tour(n, t), "probabilistic nearest neighbour: invalid tour")
    cost = float(W[t[:-1], t[1:]].astype(np.float64).sum())
    log(f"phase 17d ({card}): best of {PNN_SAMPLES} probabilistic nearest-neighbour tours on "
        f"tsp100 instance 0 under the regret: the card's equals the CPU's, cost {cost:.4f} "
        f"(gap {(cost / ds.opt_cost[0] - 1) * 100:.3f}%)")


def phase17e_profiling(model, ds, guide64, init64, dev, card):
    import numpy as np

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.evaluate import predict_regret
    from gnngls_tpu_torch.search.batched import run_fixed_kernel
    from gnngls_tpu_torch.utils.profiling import annotate, device_trace

    k = len(guide64)
    D = coords_to_distance_matrix(ds.coords[:k]).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            with annotate("smoke_inference"):
                predict_regret(model, head(ds, BATCH), batch_size=BATCH, device=dev)
            with annotate("smoke_search#0"):
                run_fixed_kernel(D, guide64, init64, n_iters=N_ITERS, perturbation_moves=PM,
                                 device=dev)
        traces = list(pathlib.Path(tmp).glob("*.pt.trace.json"))
        require(len(traces) == 1, f"device_trace wrote {traces}")
        size = traces[0].stat().st_size
        events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {key: sum(key in e["name"] for e in kernels) for key in ("gat_group", "gls_whole")}
    regions = ("smoke_inference", "smoke_search#0", "gnngls.predict", "gnngls.predict.fetch",
               "gnngls.search", "gnngls.search.kernel")
    log(f"phase 17e ({card}): device_trace wrote {size} bytes, {len(events)} events, "
        f"{len(kernels)} CUDA kernels; regions present: "
        f"{sorted(r for r in regions if r in names)}; kernel events by name {found}")
    require(set(regions) <= names, "annotated regions missing")
    require(all(found.values()), f"the trace lacks a kernel: {found}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase17f_multi_device(model, ds, dev, card):
    import torch
    import torch.distributed as dist

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.models.regret_gat import forward_ring, forward_tp, shard_params_tp
    from gnngls_tpu_torch.ops import gat_ring
    from gnngls_tpu_torch.ops.gat import gat_conv
    from gnngls_tpu_torch.ops.gat_sharded import gat_conv_sharded
    from gnngls_tpu_torch.parallel import mesh as pm
    from gnngls_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{free_port()}", num_processes=1,
                         process_id=0)
    require(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}")
    mesh = pm.make_mesh(axes=("data", "model"))
    require((mesh["data"].size(), mesh["model"].size()) == (1, 1), f"mesh {mesh}")
    n = ds.n_nodes
    x = torch.as_tensor(ds.get_scaled_batch(list(range(4)))["features"], device=dev)
    model = model.eval()
    with torch.no_grad():
        taps = []
        want = model(x, taps=taps, gat_impl="fast")
        outs = {"forward_ring": forward_ring(model, gat_ring.edge_sharding(
                    gat_ring.ring_pad(x, 1), mesh), n, mesh=mesh),
                "forward_tp": forward_tp(shard_params_tp(model, mesh), x, mesh=mesh)}
        layer0, topo = model.layers[0].gat.params(), build_topology(n)
        outs["gat_conv_sharded"] = gat_conv_sharded(layer0, topo, taps[0], 8, mesh)
        wants = {"forward_ring": want, "forward_tp": want,
                 "gat_conv_sharded": gat_conv(layer0, topo, taps[0], 8)}
    for name, got in outs.items():
        err = float((got - wants[name]).abs().max())
        log(f"  {name} at world size 1 (NCCL), tsp100 instances 0-3: max abs {err:.3e} "
            f"against the fast route (tol {PRED_TOL})")
        require(bool(torch.isfinite(got).all()) and err <= PRED_TOL,
                f"{name}: {err:.3e} from the fast route")
    log(f"phase 17f ({card}): ring, tensor-parallel and city-sharded forwards hold")
    return mesh


def phase17g_sharded(ds, guide64, init64, mesh, dev, card):
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params
    from gnngls_tpu_torch.parallel.eval_shard import make_sharded_gls
    from gnngls_tpu_torch.parallel.train_dp import make_dp_train_step
    from gnngls_tpu_torch.search.batched import run_fixed_kernel
    from gnngls_tpu_torch.train.step import make_optimizer

    k = len(guide64)
    D = coords_to_distance_matrix(ds.coords[:k]).astype(np.float32)
    run = make_sharded_gls(mesh, n_iters=N_ITERS, perturbation_moves=PM)
    kernels.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t = time.time()
    tours, costs, moves = run(D, guide64, init64)
    wall = time.time() - t
    counts = dict(kernels.launches)
    ref = run_fixed_kernel(D, guide64, init64, n_iters=N_ITERS, perturbation_moves=PM,
                           device=dev)
    require(counts == {"gls_whole": 1}, f"make_sharded_gls launches {counts}")
    require(np.array_equal(tours, ref.best_tours), "make_sharded_gls: tours differ from K1's")
    require(np.array_equal(costs, np.float32(ref.best_costs)), "make_sharded_gls: costs differ")
    require(np.array_equal(moves, ref.chunk_moves[:, -1]), "make_sharded_gls: moves differ")
    log(f"phase 17g ({card}): make_sharded_gls on instances 0-{k - 1} (n_iters {N_ITERS}, pm "
        f"{PM}) in {wall:.3f} s (host clock, the all_gather included); launches {counts}; "
        f"tours, costs and moves identical to run_fixed_kernel's ({int(moves.sum())} moves)")

    n, B = 20, 8
    rng = np.random.default_rng(17)
    x = rng.random((B, n * (n - 1) // 2, 1))
    y = rng.random((B, n * (n - 1) // 2, 1))
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4),
                        torch.Generator().manual_seed(17)).to(device=dev, dtype=torch.float64)
    dp_model = copy.deepcopy(model)
    step, _ = make_dp_train_step(dp_model, make_optimizer(dp_model), mesh)
    xt, yt = (torch.as_tensor(a, device=dev) for a in (x, y))
    dp_loss = float(step(xt, yt))
    want = train_step_on(model, dev, torch.float64, x, y)
    got = (dp_loss, {k: p.grad.double().cpu() for k, p in dp_model.named_parameters()},
           {k: t.double().cpu() for k, t in dp_model.state_dict().items()
            if k.endswith((".mean", ".var"))})
    rel, worst = hold_train_step(got, want, TRAIN_TOL64, "data-parallel train step")
    log(f"  make_dp_train_step at world size 1 (float64) vs train_step: loss rel {rel:.3e}, "
        f"gradients within {worst['grad']:.3e}, running statistics within {worst['bn']:.3e} "
        f"(bar {TRAIN_TOL64})")
    dist.destroy_process_group()
    log("phase 17g: process group destroyed")



def same_bits(a, b) -> bool:
    """Two arrays of the same dtype, shape and bytes."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def state_sha256(arrays) -> str:
    """sha256 over a checkpoint's arrays, by key: names, dtypes, shapes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(f"{key}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def same_search(a, b, what):
    """Two BatchResults with the same tours, costs, moves, traces and work
    counters (the clock stamps left out)."""
    for key in ("best_tours", "best_costs", "trace_costs", "trace_n", "chunk_moves",
                "trace_moves", "work", "search_costs"):
        x, y = getattr(a, key), getattr(b, key)
        require((x is None and y is None) or (x is not None and y is not None
                                              and same_bits(x, y)),
                f"{what}: {key} differs between two runs")


def phase18a_predictions(model, ds, data, dev):
    """predict_regret twice through each route on tsp100 instances 0-63, and
    through K3's route on phase 7's first 16 n=500 instances."""
    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import predict_regret

    sub100, sub500 = head(ds, BATCH), generated_dataset(data, N_CHUNKED)
    cases = [(route, kernel, sub100, BATCH) for route, kernel in REPEAT_ROUTES]
    cases.append(("auto", "gat_group_chunked", sub500, BATCH500))
    preds = {}
    for route, kernel, sub, batch in cases:
        runs = []
        for _ in range(2):
            kernels.reset_launch_counts()
            runs.append(predict_regret(model, sub, batch_size=batch, device=dev, gat_impl=route))
            counts = {k: v for k, v in kernels.launches.items() if v}
            want = {kernel: model.cfg.depth * -(-len(sub) // batch)} if kernel else {}
            require(counts == want, f"{route} at n={sub.n_nodes}: launches {counts}, "
                    f"expected {want}")
        require(same_bits(*runs), f"{route} predictions at n={sub.n_nodes} differ between two "
                f"runs")
        log(f"  predict_regret {route} (launches {want or 'none'}) on {len(sub)} instances, "
            f"n={sub.n_nodes}: equal bit for bit")
        preds[route, sub.n_nodes] = runs[0]
    return preds[("auto", ds.n_nodes)], preds[("auto", N500)]


def phase18b_search(ds, data, preds100, preds500, per_move, guide64, init64, dev):
    """K1 twice through search_on_predictions on 18a's predictions, shared
    and global layout; the per-move engine once more at phase 14b's call."""
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.evaluate import search_on_predictions
    from gnngls_tpu_torch.search.batched import run_fixed

    for what, preds, coords, n_iters in (
            ("K1 shared layout", preds100, ds.coords[:BATCH], N_ITERS),
            ("K1 global layout", preds500, np.asarray(data["coords"])[:N_CHUNKED], N_ITERS500)):
        runs = []
        for _ in range(2):
            kernels.reset_launch_counts()
            runs.append(search_on_predictions(preds, coords, n_iters=n_iters,
                                              perturbation_moves=PM, device=dev)[0])
            counts = {k: v for k, v in kernels.launches.items() if v}
            require(counts == {"gls_whole": 1, "nearest_neighbor": 1},
                    f"{what}: launches {counts}")
        same_search(*runs, what)
        log(f"  {what}: search_on_predictions on {len(coords)} instances, n={coords.shape[1]} "
            f"(n_iters {n_iters}, pm {PM}): tours, costs, moves and traces equal "
            f"({int(runs[0].chunk_moves[:, -1].sum())} moves)")
    D = coords_to_distance_matrix(ds.coords[:len(guide64)]).astype(np.float32)
    again = run_fixed(D, guide64, init64, n_iters=N_ITERS, perturbation_moves=PM, device=dev)
    same_search(per_move, again, "per-move engine")
    log(f"  per-move engine: run_fixed on instances 0-{len(guide64) - 1} (n_iters {N_ITERS}, pm "
        f"{PM}) equal to phase 14b's run ({int(again.trace_n.sum())} moves)")


def phase18c_labels(dev, raw):
    """The label path (phase 16b's call) twice on raw tsp100 instances 0-7."""
    import numpy as np

    from gnngls_tpu_torch.data.labels import warm_labels_chunked

    runs = []
    for _ in range(2):
        data = {k: np.array(v[:REPEAT_LABEL_INST]) for k, v in raw.items() if k != "regret"}
        with tempfile.TemporaryDirectory() as tmp:
            runs.append(warm_labels_chunked(data, tmp, chunk=LABEL_CHUNK, warm_gls_iters=0,
                                            dual_splice=True, perturbation_moves=LABEL_PM,
                                            device=dev))
    keys = sorted(k for k, v in runs[0].items() if isinstance(v, np.ndarray))
    require(keys == sorted(k for k, v in runs[1].items() if isinstance(v, np.ndarray)),
            "labels: the two runs return different arrays")
    differ = [k for k in keys if not same_bits(runs[0][k], runs[1][k])]
    require(not differ, f"labels: {differ} differ between two runs")
    log(f"  labels: warm_labels_chunked on raw instances 0-{REPEAT_LABEL_INST - 1}: {keys} "
        f"equal bit for bit")


def phase18d_training(dev, ds, first, served):
    """Phase 15d's epoch once more through each route: every checkpoint
    array and the losses equal to the first run's; the sep_fast weights
    served again, the same tours and gaps."""
    import numpy as np

    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

    train, val = route_training_sets()
    hashes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for route in TRAINED_ROUTES:
            _, history, _, _, _, arrays = train_route(route, train, val,
                                                      pathlib.Path(tmp) / route, dev)
            history0, arrays0 = first[route]
            require(sorted(arrays) == sorted(arrays0), f"{route}: checkpoint keys differ")
            differ = [k for k in sorted(arrays0) if not same_bits(arrays0[k], arrays[k])]
            require(not differ, f"{route}: {len(differ)} of {len(arrays0)} checkpoint arrays "
                    f"differ between two runs, first {differ[:4]}")
            keys = ("epoch", "loss", "val_loss", "lr")  # not the wall time
            require([[r[k] for k in keys] for r in history] ==
                    [[r[k] for k in keys] for r in history0],
                    f"{route}: losses differ between two runs: {history0} vs {history}")
            kinds = {k.split("::")[0] for k in arrays0}
            hashes[route] = state_sha256(arrays0)
            log(f"  {route:8s} {len(arrays0)} checkpoint arrays ({', '.join(sorted(kinds))}) "
                f"and the losses (train {history0[0]['loss']!r}, val "
                f"{history0[0]['val_loss']!r}) equal bit for bit; state sha256 "
                f"{hashes[route]}")
            if route == "sep_fast":
                model = load_model(pathlib.Path(tmp) / route / "checkpoint_final.npz",
                                   RegretGNNConfig(), device=dev)
    out, _ = serve_trained(model, head(ds, BATCH), dev)
    require(same_bits(out["best_tours"], served["best_tours"])
            and same_bits(out["gaps"], served["gaps"]),
            f"the second sep_fast run's weights serve other tours or gaps: mean gap "
            f"{out['gaps'].mean()!r} vs {served['gaps'].mean()!r}")
    log(f"  the second sep_fast run's weights through K2 and K1 on instances 0-{BATCH - 1}: the "
        f"same tours and gaps, mean gap {out['gaps'].mean():.4f}%")
    return hashes, float(out["gaps"].mean())


def phase18_repeat(model, ds, data, raw, per_move, guide64, init64, first, served, dev, card):
    log(f"phase 18 ({card}): each path twice in this process from the same inputs, compared "
        f"bit for bit")
    preds100, preds500 = phase18a_predictions(model, ds, data, dev)
    phase18b_search(ds, data, preds100, preds500, per_move, guide64, init64, dev)
    phase18c_labels(dev, raw)
    hashes, gap = phase18d_training(dev, ds, first, served)
    log("  left out: the default 10 s path (phase 14c), whose deadline makes the move count "
        "depend on the host clock, and the four-card layer (this run has one card)")
    log(f"phase 18: every path repeats bit for bit on {card}")
    # two runs of the script repeat when these lines agree
    log("phase 18 hashes: " + " ".join(f"{r}={h}" for r, h in hashes.items())
        + f" sep_fast_served_gap={gap!r}")


def valid_tours(tours, n) -> bool:
    import numpy as np

    tours = np.asarray(tours).reshape(-1, n + 1)
    return bool((tours[:, 0] == 0).all() and (tours[:, -1] == 0).all()
                and (np.sort(tours[:, :-1], axis=1) == np.arange(n)).all())


def beyond_distances(B, seed, dev):
    """B seeded uniform instances at n = BEYOND_N: their (B, n, n) f32
    Euclidean distances, computed on the card 32 instances at a time, and
    their coordinates."""
    import numpy as np
    import torch

    coords = np.random.default_rng(seed).random((B, BEYOND_N, 2)).astype(np.float32)
    D = np.empty((B, BEYOND_N, BEYOND_N), dtype=np.float32)
    for s in range(0, B, 32):
        c = torch.as_tensor(coords[s:s + 32], device=dev)
        d = c[:, :, None] - c[:, None]
        D[s:s + 32] = torch.sqrt((d * d).sum(-1)).cpu().numpy()
    return D, coords


def phase19a_past_1024(dev, card):
    """K1's global layout past the block's 1024 threads against its twin on
    the card, bit for bit: n = BEYOND_N with two guides cycled, and n =
    BEYOND_N2 (past the tour cost's stack of five levels that served n <=
    1024) with k given."""
    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    for n, B, G, iters, with_k in ((BEYOND_N, 2, 2, 2, False), (BEYOND_N2, 1, 1, 1, True)):
        rng = np.random.default_rng(n)
        D = torch.as_tensor(coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32)),
                            device=dev)
        R = torch.as_tensor(rng.random((B, n, n)), dtype=torch.float32, device=dev)
        guides = torch.stack([D, R + R.transpose(1, 2)][:G], 1).contiguous()
        T = nearest_neighbor_batch(D)
        k = torch.full((B,), 0.02, device=dev) if with_k else None
        kw = dict(n_iters=iters, perturbation_moves=PM, k=k)
        kernels.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t = time.time()
        got = gls_whole(D, guides, T, **kw)
        torch.cuda.synchronize(dev)
        k1_s = time.time() - t
        require(kernels.launches["gls_whole"] == 1, f"K1 n={n}: {dict(kernels.launches)}")
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        want = gls_fixed_plain(D, guides, T, **kw)
        torch.cuda.synchronize(dev)
        twin_s, peak = time.time() - t, torch.cuda.max_memory_allocated(dev)
        for key in got._fields:
            require(torch.equal(getattr(got, key), getattr(want, key)),
                    f"K1 n={n}: {key} differs from the twin's")
        require(valid_tours(got.best_tours.cpu(), n), f"K1 n={n}: invalid tours")
        log(f"  K1 n={n} B={B} G={G} n_iters={iters} pm={PM}{' k given' if with_k else ''}: "
            f"global layout == plain twin on the card, bit for bit (moves "
            f"{got.moves.tolist()}); K1 {k1_s:.3f} s, twin {twin_s:.3f} s (peak "
            f"{peak / 1e9:.3f} GB)")
    log(f"phase 19a ({card}): K1 past 1024 cities matches its twin")


def phase19b_callers(dev, card):
    """Each caller of K1 at n = BEYOND_N through K1 (at least one launch each,
    valid tours): the GLS oracle on BEYOND_INST instances, the cold label
    oracle on two edges, one warm label launch at the MAX_D2_BYTES lane cap
    (a local search and one GLS iteration a lane), the instance-sharded
    search under a new one-rank NCCL group and the search on given
    predictions; then the GLS oracle at the generator's default chunk
    (ORACLE_CHUNK instances), cut into launches by MAX_D2_BYTES.  Seconds
    and peak device memory for the oracle and the labels."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data import solvers
    from gnngls_tpu_torch.evaluate import search_on_predictions
    from gnngls_tpu_torch.parallel import mesh as pm
    from gnngls_tpu_torch.parallel import multihost
    from gnngls_tpu_torch.parallel.eval_shard import make_sharded_gls
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch

    n = BEYOND_N
    D, coords = beyond_distances(BEYOND_INST, 19, dev)
    nn = nearest_neighbor_batch(torch.as_tensor(D)).numpy()
    nn_cost = D[np.arange(BEYOND_INST)[:, None], nn[:, :-1], nn[:, 1:]].sum(-1)

    def measured(what, call, launches=1):
        kernels.reset_launch_counts()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        out = call()
        torch.cuda.synchronize(dev)
        secs, peak = time.time() - t, torch.cuda.max_memory_allocated(dev)
        k1 = kernels.launches["gls_whole"]
        require(k1 == launches, f"{what} at n={n}: {dict(kernels.launches)}")
        return out, secs, peak

    (tours, costs), secs, peak = measured(
        "gls_oracle", lambda: solvers.gls_oracle(D, n_iters=1, device=dev))
    require(valid_tours(tours, n) and bool(np.isfinite(costs).all())
            and bool((costs < nn_cost).all()),
            f"gls_oracle at n={n}: invalid tours or no gain on nearest neighbour")
    log(f"  gls_oracle on {BEYOND_INST} instances at n={n} (n_iters 1, pm 30), one K1 launch: "
        f"{secs:.3f} s, peak {peak / 1e9:.3f} GB, valid tours, costs "
        f"{costs.round(4).tolist()} against nearest neighbour's {nn_cost.round(4).tolist()}")
    edges = build_topology(n).edges[::300000][:2]
    (_, used), secs, _ = measured("gls_fixed_edge_costs", lambda: solvers.gls_fixed_edge_costs(
        D[0].astype(np.float64), edges, n_iters=1, device=dev))
    require(bool(used.all()), f"gls_fixed_edge_costs at n={n}: a lane without its edge")
    log(f"  gls_fixed_edge_costs at n={n} on 2 edges (n_iters 1, pm 30), one K1 launch: "
        f"{secs:.3f} s, each tour through its edge")
    width = solvers.MAX_D2_BYTES // (4 * n * n)
    us, vs = np.triu_indices(n, k=1)
    pick = np.linspace(0, len(us) - 1, width).astype(np.int64)
    edges = np.stack([us[pick], vs[pick]], axis=1)
    (lane_costs, used, lane_tours), secs, peak = measured(
        "warm_fixed_edge_costs_batch", lambda: solvers.warm_fixed_edge_costs_batch(
            D[:1].astype(np.float64), edges, tours[:1], n_gls_iters=1, dual_splice=False,
            device=dev))
    require(valid_tours(lane_tours, n) and bool(used.all())
            and bool(np.isfinite(lane_costs).all()),
            f"labels at n={n}: invalid lane tours or a lane without its edge")
    log(f"  warm_fixed_edge_costs_batch at n={n} (n_gls_iters 1, pm 20): {width} lanes in one "
        f"K1 launch at MAX_D2_BYTES ({solvers.MAX_D2_BYTES / 2**30:.0f} GiB of reduced "
        f"matrices): {secs:.3f} s, peak {peak / 1e9:.3f} GB, every lane tour valid and "
        f"holding its edge")
    multihost.initialize(coordinator_address=f"localhost:{free_port()}", num_processes=1,
                         process_id=0)
    try:
        sharded = make_sharded_gls(pm.make_mesh(), n_iters=1, perturbation_moves=PM)
        (sh_tours, _, _), secs, _ = measured("make_sharded_gls",
                                             lambda: sharded(D, D[:, None], nn))
    finally:
        dist.destroy_process_group()
    require(valid_tours(sh_tours, n), f"make_sharded_gls at n={n}: invalid tours")
    preds = np.random.default_rng(20).random((BEYOND_INST, n * (n - 1) // 2)).astype(np.float32)
    (res, _), secs2, _ = measured("search_on_predictions", lambda: search_on_predictions(
        preds, coords, n_iters=1, perturbation_moves=PM, device=dev))
    require(valid_tours(res.best_tours, n), f"search_on_predictions at n={n}: invalid tours")
    log(f"  make_sharded_gls ({secs:.3f} s) and search_on_predictions ({secs2:.3f} s) on "
        f"{BEYOND_INST} instances at n={n} (n_iters 1, pm {PM}), one K1 launch each: valid "
        f"tours")
    D, _ = beyond_distances(ORACLE_CHUNK, 21, dev)
    cut = -(-ORACLE_CHUNK // width)
    (tours, costs), secs, peak = measured(
        "gls_oracle", lambda: solvers.gls_oracle(D, n_iters=1, device=dev), launches=cut)
    require(valid_tours(tours, n) and bool(np.isfinite(costs).all()),
            f"gls_oracle on {ORACLE_CHUNK} instances at n={n}: invalid tours")
    log(f"  gls_oracle on {ORACLE_CHUNK} instances at n={n} (the generator's default chunk; "
        f"n_iters 1, pm 30): {cut} K1 launches of at most {width} lanes, {secs:.3f} s, peak "
        f"{peak / 1e9:.3f} GB, valid tours")
    log(f"phase 19b ({card}): every caller of K1 runs it past 1024 cities")


def phase19c_precision(model, ds, dev, card):
    """A caller at "high" (TF32 in cuBLAS) and at "highest": a tsp100 forward
    through K2, predict_regret and one `sep` train step give the same bits,
    and the caller's setting reads back after each call."""
    import copy

    import numpy as np
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import predict_regret
    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    model.eval()
    batch = ds.get_scaled_batch(np.arange(ROUTE_INST))
    x, y = (torch.as_tensor(batch[k], device=dev) for k in ("features", "regret"))
    sub = head(ds, BATCH)
    a = torch.randn((1024, 1024), device=dev, generator=torch.Generator(device=dev).manual_seed(19))

    def each(setting):
        torch.set_float32_matmul_precision(setting)
        out = {"a caller's product": a @ a}
        with torch.no_grad():
            out["forward (K2)"] = model(x)
        require(torch.get_float32_matmul_precision() == setting, "forward: precision moved")
        out["predict_regret"] = torch.as_tensor(predict_regret(model, sub, device=dev))
        require(torch.get_float32_matmul_precision() == setting, "predict_regret: precision moved")
        m = copy.deepcopy(model)
        out["sep step loss"] = train_step(m, make_optimizer(m), x, y, gat_impl="sep")
        require(torch.get_float32_matmul_precision() == setting, "train_step: precision moved")
        out.update({f"grad {k}": p.grad for k, p in m.named_parameters()})
        out.update({f"after the step {k}": t for k, t in m.state_dict().items()})
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    kernels.reset_launch_counts()
    try:
        highest, high = each("highest"), each("high")
    finally:
        torch.set_float32_matmul_precision("highest")
    launches = kernels.launches["gat_group"]
    require(launches >= 4, f"K2 launches {launches}")
    tf32 = float(np.abs(high["a caller's product"] - highest["a caller's product"]).max())
    require(tf32 > 0, "the caller's 'high' left a plain product unchanged")
    moved = [k for k in highest if k != "a caller's product" and not same_bits(high[k],
                                                                                 highest[k])]
    require(not moved, f"outputs moved under the caller's 'high': {moved}")
    log(f"phase 19c ({card}): at the caller's 'high' a plain 1024x1024 product moves by "
        f"{tf32:.3e} (TF32); the forward through K2 ({launches} K2 launches in all), "
        f"predict_regret on {BATCH} instances and one sep train step ({len(highest) - 1} "
        f"arrays: outputs, gradients, weights, statistics) equal those at 'highest' bit for "
        f"bit, and the caller's setting reads back after each call")


def phase19(model, ds, dev, card):
    t = time.time()
    phase19a_past_1024(dev, card)
    phase19b_callers(dev, card)
    phase19c_precision(model, ds, dev, card)
    log(f"phase 19: done in {time.time() - t:.1f} s on {card}")


def phase20_construction(dev, card, launches):
    """The nearest-neighbour kernel against its twin, the old chain of
    batched ops, at the fixed cells' request shapes on their guides'
    kind (uniform regret-like values, f32), bit for bit; both timed with
    CUDA events, the twin's time its host dispatch of n - 1 steps."""
    import torch

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch, nearest_neighbor_plain

    rows = []
    for B, n in CONSTRUCT_SHAPES:
        W = torch.rand((B, n, n), generator=torch.Generator().manual_seed(B * n)).to(dev)
        kernels.reset_launch_counts()
        got = nearest_neighbor_batch(W)
        require(dict(kernels.launches) == {"nearest_neighbor": 1},
                f"construction at B={B} n={n}: launches {dict(kernels.launches)}")
        require(torch.equal(got, nearest_neighbor_plain(W)),
                f"construction at B={B} n={n}: the kernel's tours differ from the twin's")
        ms = cuda_ms(lambda: nearest_neighbor_batch(W), reps=20)
        plain = cuda_ms(lambda: nearest_neighbor_plain(W), reps=3)
        steps = B * (n - 1) * n  # each step reads one row of n entries
        log(f"phase 20 ({card}): construction B={B} n={n}: kernel {ms:.4f} ms, the twin's "
            f"{n - 1} steps {plain:.3f} ms ({plain / ms:.1f}x), tours equal")
        rows.append(row("nearest_neighbor", "gnngls_tpu_torch/csrc/nearest_neighbor.cu",
                        "none: jax.lax.scan, gnngls_tpu/search/construct.py:19", launches, 0.0,
                        ms, plain, 2 * steps, 4 * steps,
                        f"B={B} n={n} f32; launches from phase 3's evaluate"))
    return rows


def drive(k4_against) -> int:
    """Every phase in order, then the `kernels` line and the result line."""
    import torch

    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

    dev = torch.device("cuda")
    card = phase0_build()
    ds = TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                             ROOT / "data/tsp100/test.txt",
                             scalers_file=ROOT / "data/tsp100/scalers.json")
    model = load_model(ROOT / "models/tsp100/checkpoint_best_val.npz",
                       RegretGNNConfig(), device=dev)
    log(f"loaded {len(ds)} tsp100 test instances and the checkpoint")
    k2_err = phase1_gat(model, ds, dev)
    k1_err = phase2_gls(dev)
    out, counts = phase3_main(model, ds, dev)
    rows = phase4_timings(model, ds, dev, out, counts, k2_err, k1_err)
    log("phase 4: the tsp100 path's kernels timed")
    k2_preds = predictions(out, ds.n_nodes)
    guide64, init64 = out["guide_stack"][:BATCH], out["init_tours"][:BATCH]
    gap3, gap64 = float(out["gaps"].mean()), float(out["gaps"][:BATCH].mean())
    del out
    k3_err = phase5_gat_chunked(model, dev)
    phase6_gls_global(dev)
    data, out500, counts500 = phase7_tsp500(model, dev)
    phase8_fixture200(model, dev)
    rows += phase9_timings500(model, data, out500, counts500, k3_err, dev)
    log("phase 9: the tsp500 path's kernels timed")
    k4_err, k4_ms, k4_plain, k2_same, k4_ops, k4_bytes, k4_shape = phase10_mxu(
        model, ds, dev, k4_against)
    counts11 = phase11_mxu_path(model, ds, dev, k2_preds)
    k5_err, k5_timed, k5_shape, k5_fx = phase12_sep(model, data, dev)
    counts13, counts200 = phase13_sep_path(model, data, out500, dev)
    rows.append(row("gat_group_mxu", "gnngls_tpu_torch/csrc/gat_group_mxu.cu",
                    "gnngls_tpu/ops/pallas_gat.py:143", counts11.get("gat_group_mxu", 0),
                    k4_err, k4_ms, k4_plain, k4_ops, k4_bytes, k4_shape,
                    k2_same_shape_ms=k2_same))
    ms, plain, ops, nbytes, k5_plain = k5_timed[True]
    rows.append(row("gat_sep", "gnngls_tpu_torch/csrc/gat_sorted.cu",
                    "gnngls_tpu/ops/pallas_gat_sep.py:48", counts13.get("gat_sep", 0),
                    k5_err[True], ms, plain, ops, nbytes,
                    f"bf16 payloads, {k5_shape}; launches from phase 13's n=500 path",
                    k5_arithmetic_plain_ms=k5_plain))
    ms, plain, ops, nbytes, k5_plain = k5_timed[False]
    fx_ms, fx_plain, fx_bound, fx_shape = k5_fx
    rows.append(row("gat_sep_f32", "gnngls_tpu_torch/csrc/gat_sorted.cu",
                    "gnngls_tpu/ops/pallas_gat_sep.py:48", counts200.get("gat_sep", 0),
                    k5_err[False], ms, plain, ops, nbytes,
                    f"f32 payloads, {k5_shape}; launches from phase 13's pallas_sep "
                    f"prediction of the n=200 fixture ({fx_shape}, timed there too)",
                    k5_arithmetic_plain_ms=k5_plain, launch_shape_ms=fx_ms,
                    launch_shape_plain_ms=fx_plain, launch_shape_bound_ms=fx_bound))
    log("phase 13: done")
    phase14a_per_move_devices(dev)
    per_move = phase14b_against_k1(ds, dev, guide64, init64)
    phase14c_wall_clock(model, ds, dev)
    phase14d_first_improvement(ds, dev)
    phase14e_protocol(ds, dev)
    phase14f_pt_checkpoint(model, ds, dev)
    log("phase 14: done")
    phase15a_train_step(dev)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = pathlib.Path(tmp) / "train"
        phase15b_resume(dev, run_dir)
        phase15c_serve(dev, run_dir, ds)
    first, served, rank_launches = phase15d_train_routes(dev, ds, gap64, card)
    rows.append(phase15e_rank_sums(model, dev, rank_launches))
    log(f"phase 15: done on {card}")
    raw = raw_tsp100(LABEL_INST)
    phase16a_k_input(dev, raw)
    label_launches, _ = phase16b_labels(dev, raw)
    B, err, ms, plain, ops, nbytes, build_ms = phase16b_timing(dev, raw)
    rows.append(row("gls_whole_labels", "gnngls_tpu_torch/csrc/gls_whole.cu",
                    "gnngls_tpu/search/pallas_gls.py:257", label_launches, err, ms, plain,
                    ops, nbytes, f"labels: shared layout, k given, B={B} n=100, the guide "
                    f"D2 itself, n_iters=0; launches from phase 16b's 64 instances",
                    reduced_matrices_ms=build_ms))
    phase16c_clis(dev, model)
    phase16d_native()
    log(f"phase 16: done on {card}")
    phase17a_chunked(model, data, out500, dev, card)
    phase17b_bf16(model, ds, k2_preds, gap3, dev, card)
    phase17c_train_routes(dev, card)
    phase17d_construction(ds, k2_preds, dev, card)
    phase17e_profiling(model, ds, guide64, init64, dev, card)
    mesh = phase17f_multi_device(model, ds, dev, card)
    phase17g_sharded(ds, guide64, init64, mesh, dev, card)
    log(f"phase 17: done on {card}")
    phase18_repeat(model, ds, data, raw, per_move, guide64, init64, first, served, dev,
                   card)
    phase19(model, ds, dev, card)
    rows += phase20_construction(dev, card, counts.get("nearest_neighbor", 0))
    bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
    require(not bad, f"imported modules the port must not use: {bad}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k4_against", metavar="SRC",
                    help="another source of csrc/gat_group_mxu.cu (e.g. an older commit's, "
                    "from git show): phase 10 builds it alone, holds it against the plain "
                    "twin and times it in turns with this K4 and K2")
    k4_against = ap.parse_args(argv).k4_against
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "gnngls_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from gnngls_tpu_torch.models.regret_gat import exact_f32_matmuls

        with exact_f32_matmuls():  # full f32, as the JAX model's HIGHEST, restored after
            return drive(k4_against)
    except Exception:  # the smoke test's boundary: report and fail
        traceback.print_exc()
        print(f"chip_smoke: FAILED after {time.time() - T0:.1f} s", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
