"""On-card smoke run of the PyTorch/CUDA port (g3py_tpu_torch).

Drives the port's paths on one CUDA card — exact GP and warped-GP
regression served from one factorization, trained by ``dlogp`` and
``find_MAP`` and sampled, the Student-t, transport, copula and marginal
process families, the whole catalogue of kernels, metrics, means and
warpings with the shared registry, streaming updates, pathwise draws, the
exported predictor, draws over rows, ``fix_vars`` and the non-centered
sampler, NUTS, NeuTra, ADVI, HMC and the batched L-BFGS of
``find_MAP(engine='jax')``, and the matrix-free path at n=50,000
(``nll_iterative``, ``find_MAP(engine='iterative')``, the
``IterativePredictor``), and the sparse families at n=100,000 (the SGPR
collapsed bound, its Predictor and ``fit_svgp``, the sparse variational
processes, the linear model of coregionalization), deep kernels, the
datatrace toolkit and the Experiment harness, the state-space families
(exact O(n) time-series GPs by parallel Kalman scans, their multi-output
and spatio-temporal forms) and their Laplace forms for non-gaussian
observations, the Kronecker grid and SKI families, and Bayesian
optimization, the fused split-training grid, the kernel structure search
and the utils (checkpoints, model files, debug, profiling) — through the
hand-written kernels K1
(stationary gram) and K2 (blocked panel Cholesky), and checks them:

  phase 0  require a CUDA card; print its name and power limit
  phase 1  build both kernels from csrc/ with nvcc (in parallel)
  phase 2  K1 vs its plain PyTorch version: 4 families x f32/f64 x 5 shapes,
           CUDA-event and profiler times, autograd check
  phase 2b K2 vs its plain version: f32/f64 at n = 64, 1000, 4096 (and
           16384 in f32) on SE grams + noise; residual, L, D_k L_kk = I,
           info on a negative pivot and on NaN; times vs plain and
           torch.linalg.cholesky_ex, the diagonal-tile kernel's device time
           a launch and the per-panel chain at n=4096 (profiler trace); an
           ill-conditioned f32 gram (noise 1e-4) held to tolerances scaled
           by its measured condition number
  phase 3  serving path, GP(Bias, SE) at n=16384, d=8: logp, Predictor, 8
           query batches of 256 points
  phase 4  serving path, WGP(Bias, MAT52, BoxCoxLinear) at n=4096; then a
           GP at n=4096 held against a float64 numpy/scipy recomputation
  phase 5  training path: GP(Bias, SE) and WGP(Bias, MAT52, BoxCoxLinear) at
           n=4096 (logp+dlogp, find_MAP, 8 batches from the trained
           params), GP(Bias, SE) at n=16384 (logp+dlogp); per-op device
           times; then the f32 dlogp at n=2048 against central differences
           of a float64 host logp
  phase 6a K1 batched over hyperparameter rows vs its plain version: 4
           families x f32/f64, R=16 at (125,125,8), R=3 at (1000,777,8),
           R=16 at (4096,4096,8) (f32); times
  phase 6b K2 batched vs its plain version row by row: f32 n=125 R=16, f32
           n=4096 R=11, f64 n=1000 R=3; a batch with one failing row; times
           of the batch, of R single calls and of cholesky_ex on the batch
  phase 6c Bayesian path: the reference sampler workload, WGP(Bias, SE,
           BoxCoxLinear) at n=125, d=8, 32 walkers x 400 iterations through
           sample_hypers (one K1 and one K2 launch per batched logp call),
           ESS/s, R-hat, acceptance, burn-in; 4 temperatures x 50
  phase 6d full width: GP(Bias, SE) at n=4096, 22 walkers x 20 from the
           MAP of phase 5, the lnprob of every final walker inside the
           prior's support vs the float64 host logp; the averaged predictor
           over 16 datatrace rows vs 16 single Predictors (float64), and in
           float32 vs the single Predictors' own float32 rounding
  phase 7a the reference's recorded sunsets experiment on the card: all 16
           rows (GP, WGP1-3 with WarpingTanh, TGP1-3) scored in float32 on
           the test split against the reference's own scores (the JAX
           test's tolerances) and on the train split (finite, guard-free);
           the three sunspots_gp_* pins within 1e-3
  phase 7b full width: GP(Bias, SE) at n=4096 from phase 5's MAP: LOO value
           and gradient vs the float64 host (GPML 5.10-5.13; float32 at the
           default params and at the MAP, float64 at the MAP; at the MAP
           float32 is held to a float32 host recomputation's own gaps),
           find_MAP(objective='loo') in float32 and float64, scores on 512
           held-out points vs the host, predict(cov=True, samples=64,
           noise=True) at m=1024 (symmetry; draws vs loc + L z of the
           float64 host)
  phase 7c full width: WGP(Bias, SE, WarpingTanh n=3) at n=4096: logp and
           dlogp vs the float64 host; Predictor batches of 256 (mean,
           median, quantiles) through the Newton inverse on the card, its
           share of a batch, its idle share, the round trip T^-1(T(x))
  phase 8  the other process families at full width (n=4096, d=8, phase 5's
           data), each logp and dlogp against a float64 host recomputation
           (the Student-t gradient analytic, the others' along two random
           directions by central differences): 8a TP(Bias, SE) with
           find_MAP and Predictor batches of 256 vs the host posterior (at
           the MAP within 4x a float32 host witness) and its per-op
           profile; 8b WTP(Bias, MAT52, BoxCoxLinear); 8c TGP(TLocation(Bias)
           @ TKernel(SE, noisy)), the pure TKernel TGP vs the zero-mean GP,
           predict(quantiles, simulations=30) at m=256 vs a float64 host
           replay of the same numpy draws; 8d CGP and CSTP(SE, Normal), the
           CGP's quantiles vs the host and its find_MAP, and MP(StudentT)
           (logp vs scipy.stats.t, betainc vs scipy.special.betainc, no
           kernel launch); 8e the TP sampler at n=125, 32 walkers x 400
           (one batched K1 and K2 call a half-ensemble), the final walkers
           vs the host logp (within 4x a float32 witness where nu's lgamma
           difference cancels), the averaged predictor over 16 rows vs 16
           single Predictors (float64)
  phase 9  the rest of the hypers catalogue at full width (phase 5's data),
           every check against a float64 host recomputation of every factor
           (the host walks the port's component tree with its own formulas):
           K1 vs its plain version on the algebra's inputs (a dims-restricted
           slice, a shared rate Param, a 0-d amplitude beside 32 rate rows);
           9a GP(Linear + Bias, SE * SIN + 2 MAT52 + LIN + 0.1) at n=4096,
           logp/dlogp (K1 x2 and K2 x1 each), find_MAP and 8 Predictor
           batches of 256 from the MAP (float32 within 4x the float32 host
           witness, float64 at 1e-5); 9b every kernel of tests/test_zoo.py's
           KERNELS, every distance metric under SE, every dot metric under
           KernelDot, KernelMax and the index kernels in a GP at n=4096 (logp;
           K1 x1 for SE/MAT32/MAT52/RQ on ARD_L2, x0 for the others); 9c
           tutorial 08, two GPs with active=True sharing one rate Param
           (joint logp and dlogp K1 x2 and K2 x2 each, against the two host
           logps; the joint find_MAP); 9d 9a's composite at n=125, 32 walkers
           x 50 through sample_hypers (K1 x2 and K2 x1 a batched call), the
           final walkers vs the host; 9e a WGP(Bias, SE) at n=4096 with each
           other warping (logp, and dlogp along the warping's coordinates),
           the inv-only ones served through the Newton inverse
  phase 10 the rest of serving and the device half of the Bayesian toolbox at
           full width (phase 5's data and MAP, phase 6d's rows, phase 6c's
           n=125 workload), each against a float64 host recomputation: 10a
           Predictor.updated (3840 + 256 points) vs a fresh Predictor on 4096
           (float64 at 1e-8) and the host (float32 within 4x the float32
           witness), K2 on the 256 x 256 block only; 10b pathwise_sampler,
           600 paths x 512 queries (K1 once a call; injected draws vs the
           host's replay of Matheron's update, float32 within 4x the
           float32 witness; moments; one seed is one path across batches);
           10c batch_sample and particles over 16 rows at 1024 queries vs
           the host's coloured draws of the same normals (float32 within 4x
           the card's float32 witness through torch), average(samples=2)
           through the row loop; 10d fix_vars over the 8 SE rates on 16
           rows: fixed_logp/fixed_dlogp vs the host's row mean (one batched
           K1 and K2 launch each; the float32 gradient within 4x the card's
           witness), find_MAP and an 8 x 5 sampler over the other dims;
           10e reparam='noncentered'
           on the n=125 workload, 32 x 400 (every _ll the logp at its row);
           10f export of the GP, a WGP(BoxCoxLinear) and a WGP(WarpingTanh)
           Predictor, loaded in a fresh process with no model code, batches
           of 1, 256 and 1000 vs the live Predictors (K1 once a batch)
  phase 11 the gradient half of the Bayesian toolbox, every chain, MC row or
           start of an evaluation in one batched K1 and K2 launch, each
           run's launches equal to its predicted evaluations: 11a NUTS on
           the n=125 sampler workload (non-centered, dense mass, 0.95, depth
           7, 4 chains, warmup 4 + 4 samples), ESS/s, a leaf's wall and
           device time, every 10th lnprob vs a float64 host logp; 11b the
           same sampler through sample_hypers in float64 on the card and
           replayed on the CPU from the same numpy draws (1e-8); 11c NUTS on
           GP n=4096 from phase 5's MAP in float32 and float64; 11d
           find_MAP(engine='jax') by logp and by LOO at n=4096 vs the scipy
           optima; 11e ADVI at n=125; 11f NeuTra through neutra_nuts
           (ensemble warmup 32 x 200, a 6-coupling flow fitted once, NUTS in
           latent space, 4 + 4) and its replay through the same flow
           (float64 card vs CPU at 1e-8, float32 and the whitening beside
           it, 6 + 3); 11g HMC 4 x 50
           x 10; 11h sample_hypers(method='nuts' | 'advi' | 'neutra')
           non-centered
  phase 12 the matrix-free path (ops/iterative.py) at bench.py's
           mo_gp_nll_grad_evals_per_sec_n50k_p2 workload, an ICM GP over 2
           outputs of 25,000 points (rank 80, block 2048, cg_iters 100,
           probes 8): 12a every function of ops/iterative.py in float64 at
           n=1024, card vs CPU (1e-8); K1 at the slab shape (2048,50000,2)
           against its plain form and its bound; 12b nll_iterative value
           and gradient at n=50,000: seconds an evaluation, K1 launches
           against the slab passes' prediction, host reads, peak allocated
           memory below 5.0 GB, the float64 value of the same estimator;
           12c nll_iterative against the exact NLL (K2) of GP(Bias, SE) at
           n=16384 in float64, a step along -gradient, the gradient's error;
           12d find_MAP(engine='iterative') with loop='host' and 'device' at
           n=4096; 12e IterativePredictor against the dense Predictor at
           n=4096 (float32 and dtype='float64'), its pathwise draws'
           moments, and at n=50,000 its set-up, a batch of 256 with each
           exact_var and the peak memory
  phase 13 the sparse families at bench.py's
           sgpr_elbo_grad_evals_per_sec_n100k_m512 workload, SGP(Bias, SE)
           at n=100,000, d=8, m=512 trainable inducing inputs: 13a the
           collapsed bound and its gradient (into the inducing inputs
           through K1's backward) against a float64 host recomputation
           (1e-3, and 1e-2 along two random directions), seconds an
           evaluation, K1 x2 and K2 x2 an evaluation, peak memory; K1 at
           (512,100000,8) and K2 at m=512 against their plain forms and
           bounds, K2 beside cholesky_ex; 13b the SGP Predictor (batches of
           256 vs the host's sparse posterior), updated with 256 points vs a
           fresh state, 512 pathwise paths' moments; 13c fit_svgp, Adam and
           natgrad=0.2 at batch 1024 (the loss falls), and natgrad=1.0 in
           full batch at n=4096 (one step is the collapsed optimum); 13d
           SVP(StudentTLik), SVP(BernoulliLik), MulticlassSVP(3 classes) and
           HeteroscedasticSVP at n=100,000, m=512: ELBO and gradient vs the
           float64 host; 13e sample_hypers on SGP at n=4096, m=256, 16 x 20,
           one batched K1 and K2 call a half-ensemble
  phase 14 items 8 and 12 (deep kernels, the LMC, the SVP family's rows, the
           datatrace toolkit, the Experiment harness), each against a float64
           host recomputation (values 1e-3, gradients 1e-2 along two random
           directions): 14a GP(Bias, DeepKernel(SE, widths=(32, 32, 2))) at
           phase 5's n=4096: logp and dlogp (K1 x1 over the features, K2 x1
           an evaluation), K1's gradient into both inputs of the square gram
           against its plain form, find_MAP(engine='jax') raising the logp,
           a Predictor batch of 256 vs the host posterior, the moments of 512
           pathwise paths; 14b LMCSVP at bench's sparse width (P=2 outputs of
           50,000 rows, d=8, m=512, Q=2), one shared SE kernel and one a
           latent: ELBO and gradient (K1 x2, K2 x1 an evaluation: the
           latents' grams one batched K1 launch each, their Kuu one batched
           K2 launch), seconds an evaluation, peak memory, fit_svgp at batch
           1024 for 50 steps (the loss falls), task_correlations; the
           per-latent K1 launches at (2,512,512,8) and (2,512,100000,8) and
           the K2 launch over the (2,512,512) Kuu, as the model makes them,
           against their plain forms row by row, timed beside their bounds
           (the latents records); 14c
           sample_hypers on SVP(GaussianLik) at n=4096, m=256, 16 x 20 (K1
           x2, K2 x1 a half-ensemble), 16 rows of logp_chain vs 16 single
           logps; 14d on phase 6c's datatrace both mixtures through
           cluster_datatrace, a KDE round trip of 1000 draws (K1 and K2 once
           a refill), find_candidates, a .npz round trip, then
           errors_datatrace over phase 6d's 16 rows at n=4096 (one batched
           factorization) vs the host's 16 single-row errors; 14e the
           Experiment harness, GP(Bias, SE) and WGP(Bias, MAT52,
           BoxCoxLinear) at n=4096, p=0.5, 2 simulations, engines 'scipy'
           and 'jax' (every row finite; a second run from the same file adds
           no row)
  phase 15 the state-space families (item 13's gaussian half), each against
           a float64 witness (the port on the CPU for 15a-c and 15f, the card
           in float64 for 15d-e; values 1e-3, gradients 1e-2 along two random
           directions): 15a bench.py:352-381's StateSpaceGP(MAT32 + OU) at
           n=16384, default params, logp and gradient (ms an evaluation,
           device events, idle share, peak memory); 15b bench.py:392-428's
           MultiStateSpaceGP, 9830 + 6554 events, measured the same way; 15c
           serving on 15a's model: a Predictor batch of mean and variance at
           1024 query times, quantiler, 16 joint sampler draws (host normals;
           float32 draws within 4x the CPU's own float32 gap); 15d
           SpatioTemporalSSGP at m=32 sites in 2-D (MAT32 x SE, S=64) with
           512 events a site: logp and gradient (K1 x1, K2 x1 an evaluation),
           the field at 256 off-site points (K1 x2, K2 x1), one evaluation of
           SparseSpatioTemporalSSGP with 16384 off-site rows (K1 x2, K2 x1),
           K1 at (32,32,2) and (32,256,2) and K2 at m=32 against their plain
           forms; 15e StateSpaceGP at n=2,097,152, the chunked NLL (8 blocks)
           and its gradient against parallel_kalman_nll in float64, the
           chunked smoother at 1024 queries against the plain one; 15f one
           batched evaluation over 16 rows at n=16384 against its 16 single
           evaluations
  phase 16 the Laplace state-space family (item 13b), against the card in
           float64: 16a NonGaussianSSGP(MAT32, PoissonLik) on
           benchmarks/ngssm_scale.py's data at n=262,144 (8 Newton steps),
           1 timed evaluation, the script's chunked-vs-plain gate at
           n=8192 and the gaussian identity with StateSpaceGP; 16b the
           chunked route at n=2^20; 16c NonGaussianMultiSSGP(Poisson,
           Bernoulli) at 9830 + 6554 events; 16d the Cox process
           NonGaussianSTSSGP at 32 sites, S=64, 32 events a site (K1 x1,
           K2 x1 an evaluation; field_rate K1 x2, K2 x1), K1 at (32,32,2)
           and K2 at m=32 against their plain forms; 16e serving at 1024
           queries; 16f 16 rows at n=16384
  phase 17 the Kronecker grid and SKI families (item 14), against the card
           in float64: 17a bench.py:437-471's GridGP 256 x 256 MAT52 x SE
           (K1 x2 an evaluation; K1 at (256,256,1) against its plain form),
           17b the same with 10% of the cells dropped (the CG residual),
           17c bench.py:479-511's SKIGP at n=100,000 on 128 x 128 (K1 at
           (128,128,1)), 17d serving at 1024 queries
  phase 18 item 15: 18a BayesOpt at full width on phase 5's GP at its MAP
           (logEI q=4 by the kriging believer, UCB q=1; 2048 candidates,
           16 starts x 60 Adam steps; the gram factored once a
           conditioning set, n = 4096..4099; the acquisitions and their
           derivatives at the final starts and the believer's lie vs
           float64 numpy/scipy; K2 once a conditioning set, K1 by shape as
           predicted), 18b Thompson q=4, 18c BayesOpt.run on tutorial
           18's warped 2-D problem (10 iterations, a find_MAP refit each),
           18d fit_splits on benchmarks/fit_splits_probe.py's grid (n=512,
           8 x 4 pairs; each split vs the float64 host, the masked logp vs
           the subset's; one batched K1 and K2 an evaluation), 18e
           Experiment.run_fanout on 14e's experiment (vs 14e's run()),
           18f search_kernel (tutorial 03's search at depth 1 vs the CPU
           port's winner from a process of its own; phase 5's data at
           n=4096), 18g checkpoints, a model file, debug_mode and
           profile_trace on the card
  phase 19 item 16a, the band-sharded exact GP/TP objective over
           torch.distributed ranks (g3py_tpu_torch/parallel/, the ranks'
           code in g3py_tpu_torch/tools/dist_smoke.py, each world started
           by parallel.launch.run_local in fresh interpreters with a file
           store and a 120 s collective timeout): 19a a world of one over
           NCCL, GP(Bias, SE) at n=16384, d=8, block 256 (64 panels):
           nll_distributed's value and gradient against the single-device
           loglike in float32 and in float64 on the card (1e-3, and 1e-2
           along two random directions), ms an evaluation, peak memory,
           K1 x2 (the band gram, and again for the backward's vjp) and K2
           x64 (the diagonal tiles) an evaluation; 19b four gloo ranks
           sharing the card at phase 5's n=4096: the GP and TP band NLLs
           against 19a's world of one and float64, ms an evaluation and the
           host-clock share of its collectives, find_MAP(engine=
           'distributed', 30 iterations at most, from the objectives' point
           10% off the MAP) within 2 nats of phase 5's scipy optimum, predictor_distributed on 256 queries against the
           single-device Predictor (2e-3 at the defaults; at phase 5's MAP
           against the float64 Predictor within 4x the float32 Predictor's
           own gap); K1 at the band shapes
           (1024,4096,8) and (16384,16384,8) and K2 on a (256,256) diagonal
           tile against their plain forms (K2 beside cholesky_ex +
           solve_triangular); 19c the host-facing statistics on the card
           (host arrays that numpy reduces: fault F3). Every phase calls
           the statistics as a user does (host arrays); a check that
           compares device tensors puts them back on the card (on_card)

The kernel counts are set to 0 just before each path (phases 3-4, phase 5)
and read just after; the Bayesian path's counts are zeroed and read around
each of its runs (the two n=125 samplers, the n=4096 sampler, the averaged
predictor's set-up and batches), and phase 7's around each float32 run of
the main path (the oracle scoring, LOO, find_MAP, scores, predict, the WGP's
logp/dlogp and Predictor), and phase 8's around each float32 family run
(8e's batched launches go to the batched records), and phase 9's around
each float32 catalogue run (9d's to the batched records), and phase 10's
around each float32 run (10c-10e's batched ones to the batched records,
the artifact's query batches counted in the loading process), and phase
11's around each float32 run (to the batched records), and phase 12's
around 12b's timed evaluations, 12d's fits and 12e's float32 predictors
(the slab record), and phase 13's around 13a's timed evaluations, 13b's
serving, 13c's fits, 13d's evaluations (the cross-gram and m=512 records)
and 13e's sampler (the batched records), and phase 14's around 14a's
evaluations, Predictor and paths, 14b's shared-kernel evaluations and
fits and 14e's scipy experiments (the single records), 14a's and 14e's
find_MAP(engine='jax'), 14b's per-latent ones (the latents a launch's
rows), 14c's sampler and rows, 14d's KDE refills and errors (the batched
records), and phase 15's around 15d's float32 evaluations, field and sparse
evaluation (15a-c, 15e and 15f are held to no launch: their Matern time
kernels have no K1 gram), and phase 16's around 16d's float32 evaluation
and field_rate (16a-c, 16e-f are held to no launch), and phase 17's around
17a-c's float32 evaluations and 17d's serving, and phase 18's around
18a's suggest calls and 18f's searches (and 18d's and 18e's fan-outs, to
the batched records), and phase 19's in each rank around 19a's timed
evaluation and 19b's evaluations, MAP search and predictor (the band
records), so warm-ups, profiles,
float64 twins and reference checks are not counted.  10f's loader process runs beside phase 11 and is
read after it.  The shape records count a subset of the two
totals of their kernel: the slab (phase 12's), the cross gram and m=512
(phase 13's), the features (14a's timed evaluations), the latents
(14b's per-latent launches), the sites (15d's site grams, its cross
grams and its m=32 factorizations), the Laplace sites (16d's), the grid
axes (17a-b's (256,256,1) grams by kind) and the SKI axes (17c's), BO's
screen and ascent (18a's (2048,n,8) and (16,n,8) grams), its ragged
factorizations (n = 4097..4099) and the fan-outs' batched grams and
factorizations (18d's at n=512, 18e's at n=4096).  Each kernel must have
launched on each path.  Every check raises on failure.  The last lines are
the kernel record, the card and ``{"ok": true, "device": {...}}``.  Run from
the repository root:

    python3 chip_smoke.py
"""

import atexit
import collections
import concurrent.futures
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import g3py_tpu_torch as g3t
import g3py_tpu_torch.ops.iterative as ITER
from g3py_tpu_torch.ops import _build
from g3py_tpu_torch.ops.linalg import mvn_loo, safe_cholesky_panels
from g3py_tpu_torch.tools.k2_chain import timeline
from g3py_tpu_torch.ops.panel_cholesky import panel_cholesky, _plain_form as k2_plain_form
from g3py_tpu_torch.ops.stationary_gram import (KINDS, stationary_gram, _launch, _plain_form,
                                                _prepare)

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SHAPES = [(4096, 4096, 8), (256, 16384, 8), (1000, 777, 8), (300, 200, 1), (129, 65, 37)]
TIMED_SHAPES = SHAPES[:2]
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-14)}  # rtol, atol/var
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12     # H100 SXM FP32 outside the tensor cores, flop/s
PEAK_FP64 = 67e12     # H100 SXM FP64 on the tensor cores (same precision), flop/s (data sheet)
K2_NAMES = ("prep_kernel", "diag_kernel", "sgemm_rows_16", "sgemm_nt_128", "nt_tile_kernel",
            "finish_kernel", "copy_panel_kernel")


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _self_device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(evt, attr, None)
        if t is not None:
            return float(t)
    return 0.0


def profile(fn, reps=1):
    """``torch.profiler`` over ``reps`` calls of ``fn`` (after one warm-up);
    returns the key averages."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def per_call_ms(averages, names, once):
    """Profiler device time a call (ms): the device time of the events whose
    name holds one of ``names``, over the count of the events named
    ``once``, a kernel that each call launches once, so that a trace which
    kept only some of the calls (torch clears events at the end of each
    cycle) still reads a call's time; None when the profiler saw none."""
    calls = sum(e.count for e in averages if _on_device(e) and once in e.key)
    total = sum(_self_device_us(e) for e in averages
                if _on_device(e) and any(n in e.key for n in names))
    return total / 1e3 / calls if calls and total > 0 else None


def launch_ms(averages, name):
    """Profiler device time a launch (ms) of the kernel events named ``name``."""
    return per_call_ms(averages, (name,), name)


def back_to_back_ms(fn, calls=20, reps=5):
    """CUDA-event time a call of ``fn`` over ``calls`` calls back to back on
    the device: the stream first sleeps until the host has enqueued every
    call (the sleep doubles until the start event is still pending when the
    last call is in), so the events time the device's work and not the
    host's enqueue rate (a K1 launch takes more host time than the kernel
    at (256,16384,8))."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        ahead = not start.query()
        end.record()
        torch.cuda.synchronize()
        if ahead or cycles >= 1 << 32:
            times.append(start.elapsed_time(end) / calls)
        else:
            cycles *= 2
    return statistics.median(times)


def k1_kernel(kind, x1, x2, rate, var, extra=None):
    """A callable that launches K1's kernel alone, on the inputs that the
    wrapper prepares (the port's ``_prepare``: rate-scaled, centred)."""
    s1, s2 = _prepare(x1, x2, rate)
    return lambda: _launch(kind, s1, s2, var, extra)


def k1_bound_ms(m, n, d, rows=1, width=4):
    """K1's bound: the inputs read once and the (rows, m, n) grams written
    once, over 3.35 TB/s (the work is a few flop an output)."""
    return (rows * m * n + (m + n) * d) * width / PEAK_BYTES * 1e3


def k2_bound(n, width=4, rows=1, peak=PEAK_FP32, block=128):
    """K2's bound (ms) and what sets it: the larger of rows n^3/3 flop over
    the peak and the bytes a factorization must move (the lower triangle
    read, L and the diagonal-panel inverses written) over 3.35 TB/s."""
    nb = -(-n // block)
    t_flop = rows * n ** 3 / 3 / peak * 1e3
    t_byte = rows * (n * (n + 1) // 2 + n * n + nb * block * block) * width / PEAK_BYTES * 1e3
    return max(t_flop, t_byte), "operations" if t_flop >= t_byte else "bytes"


def _on_device(evt):
    return "CPU" not in str(getattr(evt, "device_type", "CPU"))


def top_ops(averages, label, count=12):
    """Print the device events (kernels, copies) of a profile by device time;
    the CPU-side ops that launched them are left out, so nothing is counted
    twice."""
    rows = sorted((e for e in averages if _on_device(e)), key=_self_device_us, reverse=True)
    total = sum(_self_device_us(e) for e in rows)
    lines = [f"  {label}: device time {total / 1e3:.3f} ms in all; top ops:"]
    for e in rows[:count]:
        t = _self_device_us(e)
        if t <= 0:
            break
        lines.append(f"    {t / 1e3:10.3f} ms  {100 * t / total:5.1f}%  x{e.count:<5d} "
                     f"{e.key[:90]}")
    print("\n".join(lines), flush=True)
    return total / 1e3


def finite(t):
    if isinstance(t, np.ndarray):
        return bool(np.isfinite(t).all())
    return bool(torch.isfinite(t).all())


def host64(value):
    """A statistic (a host array or a tensor anywhere) as a float64 host
    array."""
    if isinstance(value, torch.Tensor):
        return value.detach().double().cpu().numpy()
    return np.asarray(value, np.float64)


def on_card(value):
    """A host-facing statistic's host arrays (those of a dict, tuple or
    list too) as tensors on the card, for the checks that compare device
    tensors: the user's call, its host copy included, has run first."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device="cuda")
    if isinstance(value, dict):
        return type(value)({k: on_card(v) for k, v in value.items()})
    if isinstance(value, (tuple, list)):
        return type(value)(on_card(v) for v in value)
    return value


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


# ---------------------------------------------------------------- phase 2
def phase2():
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    timing = {}
    for dtype in (torch.float32, torch.float64):
        rtol, atol_rel = TOL[dtype]
        for m, n, d in SHAPES:
            x1 = torch.randn(m, d, generator=gen, device=dev, dtype=dtype)
            x2 = torch.randn(n, d, generator=gen, device=dev, dtype=dtype)
            rate = 0.3 + 0.7 * torch.rand(d, generator=gen, device=dev, dtype=dtype)
            var = torch.tensor(1.7, device=dev, dtype=dtype)
            alpha = torch.tensor(0.8, device=dev, dtype=dtype)
            for kind in KINDS:
                extra = alpha if kind == "rq" else None
                out = stationary_gram(kind, x1, x2, rate, var, extra)
                torch.cuda.synchronize()
                ref = _plain_form(kind, x1, x2, rate, var, extra)
                err = (out - ref).abs()
                max_err = float(err.max())
                ok = bool((err <= atol_rel * 1.7 + rtol * ref.abs()).all())
                print(f"  {str(dtype)[6:]:8s} {kind:5s} ({m},{n},{d}) max_abs_err={max_err:.3e}",
                      flush=True)
                require(ok and finite(out) and out.shape == (m, n),
                        f"{kind} {dtype} ({m},{n},{d}) disagrees with the plain form "
                        f"(max abs err {max_err:.3e})")
                worst = max(worst, max_err)
                if dtype == torch.float32 and (m, n, d) in TIMED_SHAPES:
                    call = lambda: stationary_gram(kind, x1, x2, rate, var, extra)
                    t_k = event_ms(call)
                    t_p = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra))
                    t_pn = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra,
                                                        exact=False))
                    t_dev = launch_ms(profile(call, reps=10), "stationary_gram_kernel")
                    t_b2b = back_to_back_ms(k1_kernel(kind, x1, x2, rate, var, extra))
                    timing[(kind, (m, n, d))] = dict(ms=t_b2b, device_ms=t_dev,
                                                     wrapper_ms=t_k, plain_ms=t_p)
                    print(f"    time f32 {kind} ({m},{n},{d}): kernel {t_b2b:.4f} ms (events, "
                          f"back to back), device {fmt_ms(t_dev)} (profiler, a launch), "
                          f"wrapper {t_k:.4f} ms, plain {t_p:.4f} ms (norm decomposition "
                          f"{t_pn:.4f} ms)", flush=True)
    # autograd: the Function's backward vs the plain form's autograd
    for kind in ("se", "rq"):
        m, n, d = 129, 65, 37
        base = [torch.randn(m, d, generator=gen, device=dev, dtype=torch.float64),
                torch.randn(n, d, generator=gen, device=dev, dtype=torch.float64),
                0.3 + 0.7 * torch.rand(d, generator=gen, device=dev, dtype=torch.float64),
                torch.tensor(1.7, device=dev, dtype=torch.float64),
                torch.tensor(0.8, device=dev, dtype=torch.float64)]
        w = torch.randn(m, n, generator=gen, device=dev, dtype=torch.float64)
        grads = []
        for fn in (stationary_gram, _plain_form):
            leaves = [t.clone().requires_grad_(True) for t in base]
            extra = leaves[4] if kind == "rq" else None
            (fn(kind, *leaves[:4], extra) * w).sum().backward()
            grads.append([t.grad for t in leaves[:4]] + ([leaves[4].grad] if extra is not None else []))
        for gk, gp in zip(*grads):
            require(torch.allclose(gk, gp, rtol=1e-10, atol=1e-12),
                    f"{kind} gradient disagrees with the plain form's autograd")
        print(f"  autograd {kind}: gradients of x1, x2, rate, var"
              f"{', alpha' if kind == 'rq' else ''} match the plain form", flush=True)
    return worst, timing


# ---------------------------------------------------------------- phase 2b
# Tolerances of K2 against its plain version (cholesky_ex tiles + cuBLAS
# products) on SE grams + 0.1 noise:
#  residual |L L^T - A|_F / |A|_F <= 4 sqrt(n) eps: a backward-stable
#    factorization leaves O(eps) here whatever the conditioning, growing
#    like sqrt(n) with the length of its rounded sums;
#  |L - L_plain|_F / |L_plain|_F: two stable factorizations that sum in
#    different orders differ by up to cond(A) * eps; the grams here have
#    cond ~ 1e2-1e3, so 1e-3 (f32) and 1e-11 (f64);
#  max |D_k L_kk - I|: each tile has cond ~ sqrt(cond(A)); 1e-4 (f32) and
#    1e-12 (f64).
# The ill-conditioned case (f32, noise 1e-4) keeps the residual bound,
# which does not depend on the conditioning, and scales the D_k L_kk bound
# by sqrt(cond(A) / 1e3), cond(A) measured in float64: the bound above was
# set for cond ~ 1e3, and a tile's error grows with its own cond ~
# sqrt(cond(A)).  This is the case where the order of the sums inside the
# diagonal tile (leaf inverses, blocked products) shows.
K2_TOL = {torch.float32: (1e-3, 1e-4), torch.float64: (1e-11, 1e-12)}
K2_COND_REF = 1e3


def se_gram_plus_noise(n, dtype, seed, noise=0.1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, 8, generator=gen, device="cuda", dtype=dtype)
    rate = torch.full((8,), 1.0, device="cuda", dtype=dtype)
    var = torch.tensor(1.0, device="cuda", dtype=dtype)
    a = _plain_form("se", x, x, rate, var)
    a.diagonal().add_(noise)
    return a


def k2_checks(lk, dinv, a):
    """Residual |L L^T - A|_F / |A|_F and max |D_k L_kk - I| of a K2-shaped
    result (L, dinv) of ``a``."""
    n = a.shape[0]
    res = float(torch.linalg.matrix_norm(lk @ lk.T - a) / torch.linalg.matrix_norm(a))
    nb, bs = dinv.shape[0], dinv.shape[1]
    lpad = torch.eye(nb * bs, dtype=a.dtype, device=a.device)
    lpad[:n, :n] = lk
    tiles = torch.stack([lpad[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] for k in range(nb)])
    d_err = float((dinv @ tiles - torch.eye(bs, dtype=a.dtype, device=a.device)).abs().max())
    return res, d_err


def ill_conditioned_check():
    """K2 and its plain version on an f32 SE gram at n=4096 with noise 1e-4."""
    n, dtype = 4096, torch.float32
    a = se_gram_plus_noise(n, dtype, seed=n, noise=1e-4)
    ev = torch.linalg.eigvalsh(a.double())
    cond = float(ev[-1] / ev[0])
    eps = torch.finfo(dtype).eps
    res_tol = 4 * math.sqrt(n) * eps
    d_tol = K2_TOL[dtype][1] * max(1.0, math.sqrt(cond / K2_COND_REF))
    lk, dinv, info = panel_cholesky(a)
    torch.cuda.synchronize()
    lp, dinv_p, info_p = k2_plain_form(a)
    require(int(info) == 0 and int(info_p) == 0, f"K2 info {int(info)} on the ill-conditioned gram")
    res, d_err = k2_checks(lk, dinv, a)
    res_p, d_err_p = k2_checks(lp, dinv_p, a)
    l_gap = float(torch.linalg.matrix_norm(lk - lp) / torch.linalg.matrix_norm(lp))
    print(f"  K2 float32 n={n} noise 1e-4 (cond {cond:.3e}): residual {res:.3e} (plain "
          f"{res_p:.3e}, bound {res_tol:.3e}), max|D L_kk - I| {d_err:.3e} (plain {d_err_p:.3e}, "
          f"bound {d_tol:.3e}), |L-Lp|/|Lp| {l_gap:.3e} (cond*eps {cond * eps:.3e})", flush=True)
    require(res <= res_tol, f"K2 residual {res:.3e} > {res_tol:.3e} on the ill-conditioned gram")
    require(d_err <= d_tol, f"K2 panel inverse error {d_err:.3e} > {d_tol:.3e} "
            "on the ill-conditioned gram")
    require(finite(lk) and float(torch.triu(lk, 1).abs().max()) == 0.0,
            "K2 L on the ill-conditioned gram is not finite and lower-triangular")


def phase2b():
    worst = 0.0
    timing = {}
    for dtype, sizes in ((torch.float32, (64, 1000, 4096, 16384)),
                         (torch.float64, (64, 1000, 4096))):
        l_tol, d_tol = K2_TOL[dtype]
        eps = torch.finfo(dtype).eps
        for n in sizes:
            res_tol = 4 * math.sqrt(n) * eps
            a = se_gram_plus_noise(n, dtype, seed=n)
            a_copy = a.clone()
            lk, dinv, info = panel_cholesky(a)
            torch.cuda.synchronize()
            lp, dinv_p, info_p = k2_plain_form(a)
            require(torch.equal(a, a_copy), f"K2 changed its input (n={n})")
            require(int(info) == 0 and int(info_p) == 0, f"K2 info {int(info)} on an SPD gram")
            res, d_err = k2_checks(lk, dinv, a)
            l_gap = float(torch.linalg.matrix_norm(lk - lp) / torch.linalg.matrix_norm(lp))
            max_err = float((lk - lp).abs().max())
            nb, bs = dinv.shape[0], dinv.shape[1]
            upper = float(torch.triu(lk, 1).abs().max()) if n > 1 else 0.0
            print(f"  K2 {str(dtype)[6:]:8s} n={n:5d}: residual {res:.3e}, |L-Lp|/|Lp| "
                  f"{l_gap:.3e}, max abs err {max_err:.3e}, max|D L_kk - I| {d_err:.3e}",
                  flush=True)
            require(res <= res_tol, f"K2 residual {res:.3e} > {res_tol} ({dtype}, n={n})")
            require(l_gap <= l_tol, f"K2 L differs from plain {l_gap:.3e} > {l_tol}")
            require(d_err <= d_tol, f"K2 panel inverse error {d_err:.3e} > {d_tol}")
            require(upper == 0.0 and finite(lk) and lk.shape == (n, n),
                    "K2 L is not a finite lower-triangular (n, n) matrix")
            worst = max(worst, max_err) if dtype == torch.float32 else worst
            if dtype == torch.float32 and n in (4096, 16384):
                reps = 10 if n == 4096 else 3
                t_k = event_ms(lambda: panel_cholesky(a), reps=reps, warmup=1)
                prof = profile(lambda: panel_cholesky(a), reps=reps)
                t_dev = per_call_ms(prof, K2_NAMES, "prep_kernel")
                parts = {nm: per_call_ms(prof, (nm,), "prep_kernel") for nm in K2_NAMES}
                t_p = event_ms(lambda: k2_plain_form(a), reps=reps, warmup=1)
                t_lib = event_ms(lambda: torch.linalg.cholesky_ex(a), reps=reps, warmup=1)
                flops = n ** 3 / 3
                bound, bound_by = k2_bound(n, block=bs)
                timing[n] = dict(ms=t_k, device_ms=t_dev, plain_ms=t_p, library_ms=t_lib,
                                 bound_ms=bound, bound_by=bound_by)
                print(f"    time f32 n={n}: kernel {t_k:.4f} ms (events), device "
                      f"{fmt_ms(t_dev)} (profiler, a call); plain {t_p:.4f} ms; cholesky_ex "
                      f"{t_lib:.4f} ms; bound {bound:.4f} ms ({flops / t_k / 1e9:.1f} "
                      f"TFLOP/s)", flush=True)
                print("    K2 device time by kernel (ms per factorization): "
                      + ", ".join(f"{nm} {fmt_ms(t)}" for nm, t in parts.items()), flush=True)
                diag_us = None if parts["diag_kernel"] is None else parts["diag_kernel"] * 1e3 / nb
                timing[n]["diag_us"] = diag_us
                print(f"    diag_kernel device time a launch: "
                      f"{'not measured' if diag_us is None else f'{diag_us:.2f} us'} "
                      f"({nb} launches a factorization)", flush=True)
                if n == 4096:
                    timing[n]["chain"] = timeline(n, ROOT / "build" / "k2_trace", panels=False)
        # info: a symmetric input whose pivot j is negative, and a NaN input
        n, j = 1000, 700
        a = se_gram_plus_noise(n, dtype, seed=7)
        a[j, :] = 0.0
        a[:, j] = 0.0
        a[j, j] = -1.0
        info = int(panel_cholesky(a)[2])
        info_p = int(k2_plain_form(a)[2])
        require(info == j + 1 and info_p == j + 1,
                f"K2 info {info} (plain {info_p}) on a negative pivot at {j}, want {j + 1}")
        a = se_gram_plus_noise(n, dtype, seed=8)
        a[300, 10] = a[10, 300] = float("nan")
        info = int(panel_cholesky(a)[2])
        require(info > 0, f"K2 info {info} on a NaN input")
        print(f"  K2 {str(dtype)[6:]} info: negative pivot at column {j} -> {j + 1}; "
              f"NaN input -> {info}", flush=True)
    ill_conditioned_check()
    return worst, timing


# ---------------------------------------------------------------- phase 3/4
def serve(process, rng, batches, m, d, label, params=None):
    """logp, Predictor and ``batches`` query batches; returns per-batch ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logp = process.logp(params)
    t_logp = time.perf_counter() - t0
    require(math.isfinite(logp) and logp > -1e29, f"{label} logp {logp} is not finite")
    t0 = time.perf_counter()
    pr = process.predictor(params)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    print(f"  {label}: logp={logp:.6f} ({t_logp * 1e3:.1f} ms), "
          f"predictor built in {t_pred * 1e3:.1f} ms", flush=True)
    times = []
    for b in range(batches):
        xq = rng.standard_normal((m, d)).astype(np.float32)
        t0 = time.perf_counter()
        out = pr(xq, mean=True, std=True, quantiles=True, quantiles_noise=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for k in ("mean", "std", "quantile_up", "quantile_down", "noise_std",
                  "noise_up", "noise_down"):
            require(isinstance(out[k], np.ndarray) and out[k].shape == (m,) and finite(out[k]),
                    f"{label} batch {b}: {k} is not a finite ({m},) host array")
        require(bool((out["std"] > 0).all()), f"{label} batch {b}: std <= 0")
        require(bool((out["quantile_down"] <= out["quantile_up"]).all()),
                f"{label} batch {b}: quantile_down > quantile_up")
        require(bool((out["noise_down"] <= out["noise_up"]).all()),
                f"{label} batch {b}: noise_down > noise_up")
    print(f"  {label}: {batches} batches of {m}: per batch median "
          f"{statistics.median(times):.3f} ms, first {times[0]:.3f} ms, "
          f"all {[round(t, 3) for t in times]}", flush=True)
    return times


def host_gram(a, b, rate, var):
    acc = np.zeros((a.shape[0], b.shape[0]), a.dtype)
    for k in range(a.shape[1]):
        acc += ((a[:, k, None] - b[None, :, k]) * rate[k]) ** 2
    return var * np.exp(-0.5 * acc)


def host_check(rng):
    """GP(Bias, SE) at n=4096 vs a float64 numpy/scipy recomputation."""
    import scipy.linalg

    n, d, m = 4096, 8, 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    xq = rng.standard_normal((m, d)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="HOSTGP")
    gp.observed(x, y)
    params = gp.params_default
    logp = gp.logp(params)
    out = gp.predictor(params)(xq)
    mean, std = np.asarray(out["mean"]), np.asarray(out["std"])

    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    bias, var = p["HOSTGP_Bias_Bias"], p["HOSTGP_SE_var"]
    rate, noise = p["HOSTGP_SE_rate"], p["HOSTGP_Noise_var"]
    x64, xq64, y64 = x.astype(np.float64), xq.astype(np.float64), y.astype(np.float64)

    chol = scipy.linalg.cholesky(host_gram(x64, x64, rate, var) + noise * np.eye(n),
                                 lower=True)
    resid = y64 - bias
    zz = scipy.linalg.solve_triangular(chol, resid, lower=True)
    ref_logp = -0.5 * n * np.log(2 * np.pi) - 0.5 * zz @ zz - np.log(np.diag(chol)).sum()
    cross = host_gram(xq64, x64, rate, var)
    alpha = scipy.linalg.cho_solve((chol, True), resid)
    ref_mean = bias + cross @ alpha
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    ref_std = np.sqrt(np.maximum(var - (v * v).sum(axis=0), 0.0))
    gaps = {"logp": abs(logp - ref_logp) / abs(ref_logp),
            "mean": float(np.abs(mean - ref_mean).max() / np.abs(ref_mean).max()),
            "std": float(np.abs(std - ref_std).max() / np.abs(ref_std).max())}
    print(f"  host f64 check GP n={n}: logp {logp:.6f} vs {ref_logp:.6f}; relative gaps "
          + ", ".join(f"{k}={v:.3e}" for k, v in gaps.items()), flush=True)
    for k, gap in gaps.items():
        require(gap <= 1e-3, f"host check: {k} relative gap {gap:.3e} > 1e-3")


# ---------------------------------------------------------------- phase 5
def train_eval_ms(proc, u, reps):
    """Median host time (ms) of one logp + dlogp pair over ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = proc.logp(u, array=True)
        grad = proc.dlogp(u)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        require(math.isfinite(val) and val > -1e29 and np.all(np.isfinite(grad)),
                f"{proc.name}: logp {val} or dlogp not finite")
    return statistics.median(times), times


def train(proc, rng, label, reps, fit=True):
    reg = proc.active
    u = reg.dict_to_array(proc.params_default)
    k1_0, k2_0 = stationary_gram.launches, panel_cholesky.launches
    med, times = train_eval_ms(proc, u, reps)
    per_eval = ((stationary_gram.launches - k1_0) / reps, (panel_cholesky.launches - k2_0) / reps)
    print(f"  {label}: logp+dlogp median {med:.2f} ms over {reps} "
          f"(all {[round(t, 2) for t in times]}); per evaluation K1 x{per_eval[0]:g}, "
          f"K2 x{per_eval[1]:g}", flush=True)
    require(per_eval[0] >= 2 and per_eval[1] >= 2,
            f"{label}: an evaluation did not launch both kernels")
    if not fit:
        return med, None, None
    before = proc.logp(u, array=True)
    t0 = time.perf_counter()
    params, points = proc.find_MAP(points=1, powell=False, display=False, return_points=True)
    t_fit = time.perf_counter() - t0
    after = proc.logp(params)
    print(f"  {label}: find_MAP logp {before:.4f} -> {after:.4f} in {t_fit:.1f} s "
          f"({[p[0] for p in points]})", flush=True)
    require(after > before, f"{label}: find_MAP did not raise logp ({before} -> {after})")
    serve(proc, rng, batches=8, m=256, d=8, label=f"{label} trained", params=params)
    return med, params, t_fit


def host_params(reg, u, dtype=np.float64):
    """Natural-space values at the unconstrained vector ``u`` (in float64,
    then cast to ``dtype``), keyed by the last two parts of each name
    (SE_rate, Bias_Bias, Noise_var, WarpingTanh_a, ...), in registry order."""
    p = {}
    start = 0
    for par in reg.ordered_params:
        seg = np.asarray(u[start:start + par.size], np.float64).reshape(par.shape)
        key = "_".join(par.name.split("_")[-2:])
        p[key] = (np.exp(seg) if par.prior.transform.name == "log" else seg).astype(dtype)
        start += par.size
    return p


def host_logp(reg, u, x, y):
    """GP(Bias, SE) logp at the unconstrained vector ``u``, in the float
    type of ``x``."""
    import scipy.linalg

    p = host_params(reg, u, x.dtype)
    n = x.shape[0]
    k = host_gram(x, x, p["SE_rate"], p["SE_var"]) + p["Noise_var"] * np.eye(n, dtype=x.dtype)
    chol = scipy.linalg.cholesky(k, lower=True)
    z = scipy.linalg.solve_triangular(chol, y - p["Bias_Bias"], lower=True)
    return -0.5 * n * np.log(2 * np.pi) - 0.5 * z @ z - np.log(np.diag(chol)).sum()


def gradient_check(rng):
    """The port's f32 dlogp at n=2048 vs central differences of a float64
    host logp in the unconstrained coordinates.  Tolerance: 1e-2 relative
    (2-norm): the f32 gradient carries ~cond(K) * eps of rounding and the
    f64 differences (h = 1e-4) a truncation error ~h^2."""
    n, d, h = 2048, 8, 1e-4
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="FDGP")
    gp.observed(x, y)
    reg = gp.active
    u = reg.dict_to_array(gp.params_default).astype(np.float64)
    g = gp.dlogp(u.astype(np.float32)).astype(np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    fd = np.empty_like(u)
    for i in range(len(u)):
        e = np.zeros_like(u)
        e[i] = h
        fd[i] = (host_logp(reg, u + e, x64, y64) - host_logp(reg, u - e, x64, y64)) / (2 * h)
    gap = float(np.linalg.norm(g - fd) / np.linalg.norm(fd))
    print(f"  dlogp vs float64 central differences (n={n}): relative gap {gap:.3e}; "
          f"port {np.round(g, 4).tolist()}, host {np.round(fd, 4).tolist()}", flush=True)
    require(gap <= 1e-2, f"dlogp relative gap {gap:.3e} > 1e-2")


def kinv_forms(n):
    """Device time of the two ways to form K^{-1} from L^{-1} (the
    mvn_quad_logdet backward): the block-column product and
    torch.cholesky_inverse from L."""
    from g3py_tpu_torch.ops.linalg import _kinv_from_linv, trtri_from_panels

    a = se_gram_plus_noise(n, torch.float32, seed=3)
    chol, dinv, _ = panel_cholesky(a)
    linv = trtri_from_panels(chol, dinv)
    t_lauum = event_ms(lambda: _kinv_from_linv(linv), reps=3, warmup=1)
    t_inv = event_ms(lambda: torch.cholesky_inverse(chol), reps=3, warmup=1)
    t_trtri = event_ms(lambda: trtri_from_panels(chol, dinv), reps=3, warmup=1)
    eye = torch.eye(n, device="cuda")
    t_solve = event_ms(lambda: torch.linalg.solve_triangular(chol, eye, upper=False),
                       reps=3, warmup=1)
    print(f"  n={n}: K^-1 block-column product {t_lauum:.3f} ms vs cholesky_inverse "
          f"{t_inv:.3f} ms; L^-1 trtri_from_panels {t_trtri:.3f} ms vs "
          f"solve_triangular(L, I) {t_solve:.3f} ms", flush=True)


def phase5(rng):
    print("phase 5: training path", flush=True)
    d = 8
    brng = np.random.default_rng(0)  # bench.py:216-220 data
    n = 4096
    x = brng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * brng.standard_normal(n)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="TRAIN_GP")
    gp.observed(x, y)
    t_gp, gp_map, map_s = train(gp, rng, "GP n=4096", reps=10)

    x2 = rng.standard_normal((n, d)).astype(np.float32)
    y2 = (np.abs(np.sin(x2[:, 0])) + 0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    wgp = g3t.WGP(space=x2[:4], location=g3t.Bias(), kernel=g3t.MAT52(x2),
                  mapping=g3t.BoxCoxLinear(y2), name="TRAIN_WGP")
    wgp.observed(x2, y2)
    t_wgp, _, _ = train(wgp, rng, "WGP n=4096", reps=10)

    n16 = 16384
    x16 = rng.standard_normal((n16, d)).astype(np.float32)
    y16 = (np.sin(x16[:, 0]) + 0.1 * rng.standard_normal(n16)).astype(np.float32)
    gp16 = g3t.GP(space=x16[:4], location=g3t.Bias(), kernel=g3t.SE(x16), name="TRAIN_GP16")
    gp16.observed(x16, y16)
    t_gp16, _, _ = train(gp16, rng, "GP n=16384", reps=3, fit=False)
    return {"gp4096": t_gp, "wgp4096": t_wgp, "gp16384": t_gp16}, (gp, gp16, gp_map, x, y,
                                                                   map_s)


def where_time_goes(gp, gp16):
    print("  where the time goes (torch.profiler, one logp + dlogp, and the "
          "predictor set-up):", flush=True)
    for proc, label in ((gp, "GP n=4096 logp+dlogp"), (gp16, "GP n=16384 logp+dlogp")):
        u = proc.active.dict_to_array(proc.params_default)
        top_ops(profile(lambda: (proc.logp(u, array=True), proc.dlogp(u))), label)
    top_ops(profile(lambda: gp16.predictor()), "GP n=16384 predictor set-up")


# ---------------------------------------------------------------- phase 6
# The Bayesian path: the ensemble sampler over the hyperparameter posterior
# and the datatrace-averaged predictor, through K1 and K2 batched over
# hyperparameter rows (one launch for all rows of a batched call).
K1_BATCH_SHAPES = ((16, 125, 125, 8), (3, 1000, 777, 8), (16, 4096, 4096, 8))


def phase6a():
    """Batched K1 against its plain version: four families, f32 and f64, a
    different rate, var and alpha for every row."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        rtol, atol_rel = TOL[dtype]
        for rows, m, n, d in K1_BATCH_SHAPES:
            if dtype == torch.float64 and m == 4096:
                continue
            x1 = torch.randn(m, d, generator=gen, device=dev, dtype=dtype)
            x2 = torch.randn(n, d, generator=gen, device=dev, dtype=dtype)
            rate = 0.3 + 0.7 * torch.rand(rows, d, generator=gen, device=dev, dtype=dtype)
            var = 0.5 + torch.rand(rows, generator=gen, device=dev, dtype=dtype)
            alpha = 0.5 + torch.rand(rows, generator=gen, device=dev, dtype=dtype)
            for kind in KINDS:
                extra = alpha if kind == "rq" else None
                out = stationary_gram(kind, x1, x2, rate, var, extra)
                torch.cuda.synchronize()
                ref = _plain_form(kind, x1, x2, rate, var, extra)
                err = (out - ref).abs()
                max_err = float(err.max())
                ok = bool((err <= atol_rel * var.max() + rtol * ref.abs()).all())
                require(ok and finite(out) and out.shape == (rows, m, n),
                        f"batched K1 {kind} {dtype} R={rows} ({m},{n},{d}) disagrees with the "
                        f"plain form (max abs err {max_err:.3e})")
                worst = max(worst, max_err) if dtype == torch.float32 else worst
                if dtype == torch.float32 and kind == "se":
                    call = lambda: stationary_gram(kind, x1, x2, rate, var, extra)
                    t_k = event_ms(call)
                    t_p = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra))
                    t_pn = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra,
                                                        exact=False))
                    t_dev = launch_ms(profile(call, reps=10), "stationary_gram_kernel")
                    t_b2b = back_to_back_ms(k1_kernel(kind, x1, x2, rate, var, extra))
                    bound = k1_bound_ms(m, n, d, rows)
                    timing[(rows, m, n, d)] = dict(ms=t_b2b, device_ms=t_dev, wrapper_ms=t_k,
                                                   plain_ms=t_p, bound_ms=bound)
                    print(f"    time f32 se R={rows} ({m},{n},{d}): kernel {t_b2b:.4f} ms "
                          f"(events, back to back), device {fmt_ms(t_dev)} (profiler, a "
                          f"launch), wrapper {t_k:.4f} ms, plain {t_p:.4f} ms (norm "
                          f"decomposition {t_pn:.4f} ms), bound {bound:.4f} ms", flush=True)
            print(f"  batched K1 {str(dtype)[6:]} R={rows} ({m},{n},{d}): 4 families match "
                  "the plain form", flush=True)
    return worst, timing


def spd_batch(rows, n, dtype, seed):
    """(rows, n, n) SE grams + 0.1 noise, one point set and rate a row."""
    return torch.stack([se_gram_plus_noise(n, dtype, seed + r) for r in range(rows)])


def phase6b():
    """Batched K2 against its plain version, row by row; one failing row;
    times of the batch, of R single calls and of cholesky_ex on the batch."""
    worst, timing = 0.0, {}
    for dtype, rows, n in ((torch.float32, 16, 125), (torch.float32, 11, 4096),
                           (torch.float64, 3, 1000)):
        l_tol, d_tol = K2_TOL[dtype]
        res_tol = 4 * math.sqrt(n) * torch.finfo(dtype).eps
        a = spd_batch(rows, n, dtype, seed=50 + n)
        lk, dinv, info = panel_cholesky(a)
        torch.cuda.synchronize()
        require(lk.shape == (rows, n, n) and info.shape == (rows,) and not bool(info.any()),
                f"batched K2 R={rows} n={n}: shape {tuple(lk.shape)}, info {info.tolist()}")
        errs = []
        for r in range(rows):
            lp, dinv_p, info_p = k2_plain_form(a[r])
            res, d_err = k2_checks(lk[r], dinv[r], a[r])
            l_gap = float(torch.linalg.matrix_norm(lk[r] - lp) / torch.linalg.matrix_norm(lp))
            require(res <= res_tol and l_gap <= l_tol and d_err <= d_tol and int(info_p) == 0,
                    f"batched K2 {dtype} n={n} row {r}: residual {res:.3e}, |L-Lp|/|Lp| "
                    f"{l_gap:.3e}, max|D L_kk - I| {d_err:.3e}")
            errs.append(float((lk[r] - lp).abs().max()))
        print(f"  batched K2 {str(dtype)[6:]} R={rows} n={n}: every row matches the plain "
              f"form (max abs err {max(errs):.3e})", flush=True)
        worst = max(worst, max(errs)) if dtype == torch.float32 else worst
        reps = 10 if n <= 1000 else 5
        t_k = event_ms(lambda: panel_cholesky(a), reps=reps, warmup=1)
        t_loop = event_ms(lambda: [panel_cholesky(a[r]) for r in range(rows)], reps=reps,
                          warmup=1)
        t_lib = event_ms(lambda: torch.linalg.cholesky_ex(a), reps=reps, warmup=1)
        t_p = event_ms(lambda: k2_plain_form(a), reps=2, warmup=1)
        t_dev = per_call_ms(profile(lambda: panel_cholesky(a), reps=reps), K2_NAMES,
                            "prep_kernel")
        f32 = dtype == torch.float32
        bound, bound_by = k2_bound(n, 4 if f32 else 8, rows, PEAK_FP32 if f32 else PEAK_FP64,
                                   dinv.shape[-1])
        timing[(str(dtype)[6:], rows, n)] = dict(
            ms=t_k, device_ms=t_dev, loop_ms=t_loop, library_ms=t_lib, plain_ms=t_p,
            bound_ms=bound, bound_by=bound_by)
        print(f"    time {str(dtype)[6:]} R={rows} n={n}: batched K2 {t_k:.4f} ms (events), "
              f"device {fmt_ms(t_dev)} (profiler, a call); {rows} single K2 calls {t_loop:.4f} ms; cholesky_ex "
              f"on the batch {t_lib:.4f} ms; plain {t_p:.4f} ms; bound {bound:.4f} ms",
              flush=True)
    # one failing row: only its info is set, the other rows are untouched
    for dtype in (torch.float32, torch.float64):
        rows, n, j, bad = 4, 1000, 700, 2
        a = spd_batch(rows, n, dtype, seed=90)
        a[bad, j, :] = 0.0
        a[bad, :, j] = 0.0
        a[bad, j, j] = -1.0
        lk, _, info = panel_cholesky(a)
        torch.cuda.synchronize()
        want = [j + 1 if r == bad else 0 for r in range(rows)]
        require(info.tolist() == want, f"batched K2 info {info.tolist()}, want {want}")
        for r in range(rows):
            if r != bad:
                lr = panel_cholesky(a[r])[0]
                gap = float(torch.linalg.matrix_norm(lk[r] - lr) / torch.linalg.matrix_norm(lr))
                require(gap <= K2_TOL[dtype][0], f"batched K2 row {r} next to a failing row "
                        f"differs from its single factorization ({gap:.3e})")
        print(f"  batched K2 {str(dtype)[6:]} info with row {bad} failing at column {j}: "
              f"{info.tolist()}; the other rows match their single factorizations", flush=True)
    return worst, timing


def bench_wgp_data(d=8):
    """The sampler workload's data: bench.py's rng stream after its n=4096
    headline arrays (bench.py:705-714)."""
    rr = np.random.default_rng(0)
    rr.standard_normal((4096, d))
    rr.standard_normal(4096)
    x = rr.standard_normal((125, d)).astype(np.float32)
    y = (np.abs(np.sin(x[:, 0])) + 0.5 + 0.1 * rr.standard_normal(125)).astype(np.float32)
    return x, y


def zero_counts():
    stationary_gram.launches = 0
    stationary_gram.by_shape.clear()
    panel_cholesky.launches = 0
    safe_cholesky_panels.retries = 0


def launches():
    return stationary_gram.launches, panel_cholesky.launches, safe_cholesky_panels.retries


def k1_shapes():
    """K1's launches since the counts were zeroed, by ``"kind (R, m, n, d)"``
    (the wrapper's ``by_shape``, counted where it launches)."""
    return {f"{k[0]} {k[1:]}": v for k, v in sorted(stationary_gram.by_shape.items())}


#: K1's launches by kind and shape on the main path of the phase being run
#: (``to_path`` adds each counted run's)
PATH_K1 = collections.Counter()


def to_path(path, k1, k2):
    """Add a counted run's K1 and K2 launches to the two-item list ``path``
    and its K1 launches by kind and shape to ``PATH_K1``."""
    path[0] += k1
    path[1] += k2
    PATH_K1.update(k1_shapes())


@contextlib.contextmanager
def counted(path):
    """Zero the kernel counts, run the block, and add its K1 and K2
    launches to the two-item list ``path``."""
    zero_counts()
    yield
    k1, k2, _ = launches()
    to_path(path, k1, k2)


@contextlib.contextmanager
def counted_calls(proc):
    """Count the batched calls of the log density that reaches the kernels
    (logp, or loglike when tempered) that ``proc``'s sampler is handed:
    yields a list that gets the rows of each call."""
    calls = []
    inner = proc._sampling_logps

    def sampling_logps(prior=False, tempered=False):
        logp, loglike, logprior = inner(prior=prior, tempered=tempered)
        dens = loglike if tempered else logp

        def counted(u):
            calls.append(u.shape[0])
            return dens(u)

        return (None, counted, logprior) if tempered else (counted, None, None)

    proc._sampling_logps = sampling_logps
    try:
        yield calls
    finally:
        del proc._sampling_logps


def moved_share(chain):
    """Share of the (chains, samples, ndim) chain's steps after the first
    that moved the walker: the acceptance rate of those moves."""
    return float((np.diff(chain, axis=1) != 0).any(-1).mean())


def iteration_profile(proc, rows, label):
    """Device time of one sampler iteration (two batched logp calls of half
    the ensemble each) by kernel, and its wall time without the profiler."""
    logp, _, _ = proc._sampling_logps()
    half = torch.as_tensor(rows[: len(rows) // 2], device="cuda")

    def one_iteration():
        logp(half)
        logp(half)
        torch.cuda.synchronize()

    busy = top_ops(profile(one_iteration, reps=3), f"{label}: 3 iterations") / 3
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        one_iteration()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times)
    print(f"    {label}: one iteration {wall:.3f} ms wall (median of 10), device busy "
          f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}", flush=True)
    return dict(wall_ms=wall, busy_ms=busy)


def host_profile(proc, rows, label, calls=50):
    """cProfile of ``calls`` batched logp calls of half the ensemble: the
    host time a call and the port's functions that take it."""
    import cProfile
    import pstats

    logp, _, _ = proc._sampling_logps()
    half = torch.as_tensor(rows[: len(rows) // 2], device="cuda")
    logp(half)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(calls):
        logp(half)
    torch.cuda.synchronize()
    prof.disable()
    per_call = (time.perf_counter() - t0) * 1e3 / calls
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    rows_out = sorted(((ct * 1e3 / calls, f"{Path(f).name}:{ln}({fn})")
                       for (f, ln, fn), (_, _, _, ct, _) in stats.items()
                       if "g3py_tpu_torch" in f), reverse=True)[:10]
    print(f"  {label}: {per_call:.3f} ms of host time a call under cProfile; cumulative "
          "ms a call: " + ", ".join(f"{name} {t:.3f}" for t, name in rows_out), flush=True)
    return per_call


def phase6c():
    """The reference sampler workload: WGP(Bias, SE, BoxCoxLinear), n=125,
    d=8, 32 walkers x 400 iterations through sample_hypers, then 4
    temperatures x 50.  Returns the measurements, the launches of the two
    runs (the warm-up and the profiles are not counted) and the process
    with its datatrace (phase 14d's)."""
    x, y = bench_wgp_data()
    wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                  mapping=g3t.BoxCoxLinear(y), name="SMOKE_BWGP")
    wgp.observed(x, y)
    start = wgp.params_default
    chains, iters = 32, 400
    wgp.sample_hypers(start=start, samples=5, chains=chains, noise_mult=0.05, seed=1)  # warm-up
    with counted_calls(wgp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        dt = wgp.sample_hypers(start=start, samples=iters, chains=chains, noise_mult=0.05,
                               seed=2)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    print(f"  WGP n=125 sampler: {len(calls)} batched logp calls of {sorted(set(calls))} rows; "
          f"K1 x{k1}, K2 x{k2} ({retries} jitter retries)", flush=True)
    require(len(calls) == 1 + 2 * iters,
            f"{len(calls)} batched logp calls, expected {1 + 2 * iters}")
    require(k1 == len(calls) and k2 - retries == len(calls),
            f"K1 x{k1}, K2 x{k2} - {retries} retries on {len(calls)} batched logp calls: the "
            "kernels did not launch once per batched call")
    path = [k1, k2]
    chain = g3t.datatrace_to_chains(wgp, dt)
    require(chain.shape == (chains, iters, wgp.active.ndim) and np.isfinite(chain).all()
            and np.isfinite(dt["_ll"]).all() and dt["_ll"].max() > -1e29,
            "sampler chain or lnprob not finite")
    from g3py_tpu_torch.bayesian.average import _mESS
    ess = sum(_mESS(chain[c, iters // 2:, :].astype(np.float64)) for c in range(chains))
    rhat = g3t.gelman_rubin(chain)
    rhat_half = g3t.gelman_rubin(chain[:, iters // 2:])
    nburn = int((~dt["_burnin"]).sum()) // chains
    acceptance = moved_share(chain)
    out = dict(evals_per_s=chains * iters / t_s, ess=ess, ess_per_s=ess / (t_s / 2),
               rhat=rhat, rhat_half=rhat_half, acceptance=acceptance, burnin=nburn,
               sampler_s=t_s)
    print(f"  WGP n=125, {chains} walkers x {iters}: sample_hypers {t_s:.3f} s (the datatrace "
          f"included); {out['evals_per_s']:.1f} logp evaluations/s; mESS (second half) "
          f"{ess:.1f}, {out['ess_per_s']:.1f} ESS/s; |R-hat - 1| {rhat:.4f} (second half "
          f"{rhat_half:.4f}); acceptance {acceptance:.3f} (moves 2-{iters}); burn-in {nburn} "
          "samples", flush=True)
    with counted_calls(wgp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain_t, lnprob_t = wgp.sample_hypers(start=start, samples=50, chains=chains, ntemps=4,
                                              noise_mult=0.05, seed=3, raw=True)
        t_t = time.perf_counter() - t0
        k1, k2, retries = launches()
    require(np.isfinite(chain_t).all() and np.isfinite(lnprob_t).all()
            and len(calls) == 1 + 2 * 50 and k1 == len(calls) and k2 - retries == len(calls),
            f"tempered run: K1 x{k1}, K2 x{k2} on {len(calls)} batched loglike calls")
    path = [path[0] + k1, path[1] + k2]
    print(f"  WGP n=125 tempered, 4 temperatures x {chains} walkers x 50: {t_t:.3f} s, "
          f"temperature 0 moved {moved_share(chain_t):.3f} of its steps, K1 x{k1}, K2 x{k2} "
          f"({len(calls)} batched loglike calls of {sorted(set(calls))} rows)", flush=True)
    out["tempered_s"] = t_t
    out["profile"] = iteration_profile(wgp, chain[:, -1, :], "WGP n=125 iteration (R=16)")
    out["host_ms"] = host_profile(wgp, chain[:, -1, :], "WGP n=125 batched logp (R=16)")
    return out, path, (wgp, dt)


def predictor_gaps(got, refs, scale):
    """max |got - ref| / scale over the query batches, for mean and std."""
    return {k: max(float((g[k] - r[k]).abs().max()) / scale[k] for g, r in zip(got, refs))
            for k in ("mean", "std")}


def phase6d(gp, gp_map, x, y):
    """Full width: GP(Bias, SE) at n=4096, 22 walkers x 20 iterations from
    the MAP of phase 5, lnprob against the float64 host logp, then the
    averaged predictor over 16 datatrace rows against 16 single Predictors.
    Returns the measurements and the launches of the sampler and of the
    averaged predictor's set-up and batches (the profile and the reference
    predictors are not counted)."""
    reg = gp.active
    with counted_calls(gp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain, lnprob = gp.sample_hypers(start=gp_map, samples=20, chains=22, seed=4, raw=True,
                                         noise_mult=0.02)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    require(np.isfinite(chain).all() and np.isfinite(lnprob).all(),
            "n=4096 sampler chain or lnprob not finite")
    require(len(calls) == 1 + 2 * 20 and k1 == len(calls) and k2 - retries == len(calls),
            f"n=4096 sampler: K1 x{k1}, K2 x{k2} on {len(calls)} batched logp calls")
    path = [k1, k2]
    print(f"  GP n=4096, 22 walkers x 20: sampler {t_s:.3f} s ({22 * 20 / t_s:.1f} logp "
          f"evaluations/s), acceptance {moved_share(chain):.3f} (moves 2-20); K1 x{k1}, "
          f"K2 x{k2} on {len(calls)} batched calls", flush=True)
    # the MAP takes ARD rates of irrelevant inputs towards 0, next to the
    # FlatExp prior's wall at 1e-6; a walker beyond it has lnprob -1e30 (the
    # prior), which the host logp (the likelihood alone) does not model.
    # Every walker inside the support is checked, four host logps at a time.
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    inside = [w for w in range(22) if lnprob[w, -1] > -1e29]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        refs = list(pool.map(lambda w: host_logp(reg, chain[w, -1], x64, y64), inside))
    gaps = [abs(lnprob[w, -1] - ref) / abs(ref) for w, ref in zip(inside, refs)]
    print(f"  final walkers' lnprob vs the float64 host logp: {len(inside)} of 22 inside the "
          f"prior's support, max relative gap {max(gaps):.3e} over all of them "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)
    require(len(inside) >= 11, f"only {len(inside)} of 22 walkers inside the prior's support")
    require(max(gaps) <= 1e-3, f"n=4096 lnprob vs host logp relative gap {max(gaps):.3e}")
    prof = iteration_profile(gp, chain[:, -1, :], "GP n=4096 iteration (R=11)")

    dt = g3t.chains_to_datatrace(gp, chain, ll=lnprob, burnin_tol=None)
    rng = np.random.default_rng(44)
    queries = [rng.standard_normal((256, 8)).astype(np.float32) for _ in range(8)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    ap = gp.averaged_predictor(dt, max_rows=16)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    times, outs = [], []
    for xq in queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ap(xq)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(on_card(out))
    k1, k2, _ = launches()
    path = [path[0] + k1, path[1] + k2]
    print(f"  averaged predictor, 16 rows of n=4096: set-up {t_setup * 1e3:.1f} ms; 8 batches "
          f"of 256: median {statistics.median(times):.3f} ms, all "
          f"{[round(t, 3) for t in times]}; K1 x{k1}, K2 x{k2}", flush=True)
    require(all(out[k].shape == (256,) and finite(out[k]) for out in outs
                for k in ("mean", "std")), "averaged predictor output is not finite")
    # The averaging against 16 single Predictors in float64, where rounding
    # leaves the machinery alone to compare (ISSUE tolerance 1e-4).  The
    # served float32 output is held to the float64 average at the float32
    # rounding of the same work: each single float32 Predictor's gap to its
    # float64 twin (at the MAP cond(K) ~ 1e5, and the posterior std's
    # k_ss - |v|^2 cancels) is the yardstick, and the averaged predictor may
    # be off by at most twice the largest of those gaps.
    rows = range(len(ap.rows))
    singles32 = [gp.predictor({k: v[i] for k, v in ap.params.items()}) for i in rows]
    got32 = [[on_card(pr(xq)) for pr in singles32] for xq in queries]
    del singles32
    g3t.settings.floatx = "float64"
    try:
        ap64 = gp.averaged_predictor(dt, max_rows=16)
        singles64 = [gp.predictor({k: v[i] for k, v in ap64.params.items()}) for i in rows]
        got64 = [[on_card(pr(xq)) for pr in singles64] for xq in queries]
        avg64 = [{k: torch.stack([r[k] for r in refs]).mean(dim=0) for k in ("mean", "std")}
                 for refs in got64]
        scale = {k: max(float(a[k].abs().max()) for a in avg64) for k in ("mean", "std")}
        machinery = predictor_gaps([on_card(ap64(xq)) for xq in queries], avg64, scale)
        del singles64, ap64
    finally:
        g3t.settings.floatx = "float32"
    single32 = {k: max(predictor_gaps(
        [{kk: b[i][kk].double() for kk in ("mean", "std")} for b in got32],
        [b[i] for b in got64], scale)[k] for i in rows) for k in ("mean", "std")}
    served32 = predictor_gaps([{k: o[k].double() for k in ("mean", "std")} for o in outs],
                              avg64, scale)
    print(f"  averaged predictor vs the average of 16 single Predictors (float64): mean "
          f"{machinery['mean']:.3e}, std {machinery['std']:.3e} relative; float32: each single "
          f"Predictor vs its float64 twin at most mean {single32['mean']:.3e}, std "
          f"{single32['std']:.3e}; the averaged predictor vs the float64 average mean "
          f"{served32['mean']:.3e}, std {served32['std']:.3e}", flush=True)
    require(max(machinery.values()) <= 1e-4,
            f"averaged predictor vs 16 single Predictors (float64): {machinery}")
    require(all(served32[k] <= 2 * single32[k] for k in served32),
            f"float32 averaged predictor vs float64 {served32}, more than twice the single "
            f"Predictors' float32 gaps {single32}")
    inside = np.flatnonzero(dt["_ll"] > -1e29)
    dt16 = dt[inside[np.linspace(0, len(inside) - 1, 16).astype(int)]]
    return dict(sampler_s=t_s, setup_ms=t_setup * 1e3, batch_ms=statistics.median(times),
                profile=prof, single32=single32, served32=served32), path, dt16


# ---------------------------------------------------------------- phase 7
# The main path's parity gate and the rest of its model surface: the
# reference's recorded sunsets experiment scored on the card, then LOO,
# scores, covariance and samples of GP(Bias, SE) and a WarpingTanh WGP at
# full width, each against a float64 host recomputation.
ORACLE_TEST_RTOL = 2e-3   # tests/test_parity_reference.py TEST_RTOL
ORACLE_NLPD_RTOL = 3e-2   # tests/test_parity_reference.py NLPD_RTOL
PINS = ("sunspots_gp_logp_ref_map", "sunspots_gp_pred_mean_sum", "sunspots_gp_pred_std_sum")


def oracle_model(name, x, y):
    """The recorded experiment's model zoo (SE kernel + Bias location)."""
    common = dict(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
    if name == "GP":
        return g3t.GP(**common)
    if name.startswith("WGP"):
        return g3t.WGP(mapping=g3t.WarpingTanh(y, n=int(name[3:])), **common)
    mapping = {"TGP1": lambda: g3t.BoxCoxLinear(y), "TGP2": lambda: g3t.ArcsinhLinear(y),
               "TGP3": lambda: g3t.BoxCoxLinear(y) @ g3t.ArcsinhLinear(y)}[name]()
    return g3t.WGP(mapping=mapping, **common)


def phase7a(path):
    """All 16 recorded rows (GP, WGP1-3, TGP1-3) scored in float32 on the
    card against the reference's own scores (their launches added to
    ``path``), and the three sunspots pins (not counted)."""
    from g3py_tpu_torch.utils import reference_io
    from g3py_tpu_torch.utils.data import data_sunspots

    rows, sims = reference_io.load_oracle()
    xs, ys = data_sunspots()
    x, y = xs.astype(np.float32), ys.astype(np.float32)
    models = {}
    worst = {"test": 0.0, "nlpd": 0.0}
    t0 = time.perf_counter()
    scored = []
    with counted(path):
        for row in rows:
            name = row["model"]
            if name not in models:
                models[name] = oracle_model(name, x, y)
            sp = models[name]
            obs_j, test_j = sims[row["n_sim"]]["obs"], sims[row["n_sim"]]["test"]
            params = reference_io.transformed_to_natural(row["params"])
            sp.observed(x[obs_j], y[obs_j])
            sp.set_space(x[test_j], hidden=y[test_j])
            test = sp.scores(params, logpred=True, bias=True, variance=True)
            sp.set_space(x[obs_j], hidden=y[obs_j])
            scored.append((row, test, sp.scores(params, logpred=True, bias=True, variance=True)))
    t_oracle = time.perf_counter() - t0
    for row, test, train in scored:
        name = row["model"]
        for key, ref in row["scores_test"].items():
            gap = abs(test[key] - ref) / abs(ref)
            tol = ORACLE_NLPD_RTOL if key == "_nlpd" else ORACLE_TEST_RTOL
            worst["nlpd" if key == "_nlpd" else "test"] = max(
                worst["nlpd" if key == "_nlpd" else "test"], gap)
            require(gap <= tol, f"oracle {name} n_sim={row['n_sim']} test {key}: "
                    f"{test[key]!r} vs recorded {ref!r} (gap {gap:.3e} > {tol})")
        for key, val in train.items():
            require(math.isfinite(val) and val > -1e29,
                    f"oracle {name} n_sim={row['n_sim']} train {key} hit a guard: {val!r}")
        for key in ("_mse", "_rmse"):
            ref = row["scores_obs"][key]
            require(abs(train[key] - ref) <= 3.0 * abs(ref),
                    f"oracle {name} train {key} off by more than 4x: {train[key]!r} vs {ref!r}")
    with open(ROOT / "tests" / "golden.json") as fh:
        golden = json.load(fh)
    row = rows[1]  # GP, n_sim=0: tests/test_golden.py's pins
    params = reference_io.transformed_to_natural(row["params"])
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="GP")
    gp.observed(x[sims[0]["obs"]], y[sims[0]["obs"]])
    gp.set_space(x[sims[0]["test"]], hidden=y[sims[0]["test"]])
    got = {"sunspots_gp_logp_ref_map": gp.logp(params),
           "sunspots_gp_pred_mean_sum": float(gp.mean(params).sum()),
           "sunspots_gp_pred_std_sum": float(gp.std(params).sum())}
    gaps = {k: abs(got[k] - golden[k]) / abs(golden[k]) for k in PINS}
    print(f"  oracle: 16 rows x 2 splits scored in {t_oracle:.2f} s; worst test-split gap "
          f"{worst['test']:.3e} (limit {ORACLE_TEST_RTOL}), _nlpd {worst['nlpd']:.3e} "
          f"(limit {ORACLE_NLPD_RTOL}); pins: "
          + ", ".join(f"{k} {got[k]:.6f} vs {golden[k]:.6f} (gap {gaps[k]:.3e})" for k in PINS),
          flush=True)
    for k, gap in gaps.items():
        require(gap <= 1e-3, f"pin {k}: relative gap {gap:.3e} > 1e-3")
    return dict(oracle_s=t_oracle, worst_test=worst["test"], worst_nlpd=worst["nlpd"],
                pin_gaps=gaps)


def host_posterior(p, x, y, xq):
    """GP(Bias, SE) posterior at ``xq`` in the float type of ``x``: (mean,
    latent covariance, noise variance) from a scipy Cholesky of the
    observed gram."""
    import scipy.linalg

    eye = np.eye(len(x), dtype=x.dtype)
    k = host_gram(x, x, p["SE_rate"], p["SE_var"]) + p["Noise_var"] * eye
    chol = scipy.linalg.cholesky(k, lower=True)
    cross = host_gram(xq, x, p["SE_rate"], p["SE_var"])
    mean = p["Bias_Bias"] + cross @ scipy.linalg.cho_solve((chol, True), y - p["Bias_Bias"])
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    cov = host_gram(xq, xq, p["SE_rate"], p["SE_var"]) - v.T @ v
    return mean, cov, p["Noise_var"]


def host_kbar(k, r):
    """LOO terms of the gram ``k`` and residual ``r`` in their float type,
    from a scipy Cholesky and inverse: (value, K_bar = dLOO/dK as GPML eq.
    5.13 gives it, K^-1 g_alpha = dLOO/dr)."""
    import scipy.linalg

    chol = scipy.linalg.cholesky(k, lower=True)
    potri = scipy.linalg.lapack.get_lapack_funcs("potri", (chol,))
    kinv, info = potri(chol, lower=1)
    require(info == 0, f"host LOO: potri info {info}")
    kinv = np.tril(kinv) + np.tril(kinv, -1).T
    alpha = kinv @ r
    kd = np.diag(kinv).copy()
    value = float(np.sum(-0.5 * np.log(2 * np.pi) + 0.5 * np.log(kd) - 0.5 * alpha ** 2 / kd))
    g_alpha = -alpha / kd
    g_kd = 0.5 * (1.0 / kd + alpha ** 2 / kd ** 2)
    kga = kinv @ g_alpha
    return value, -0.5 * (np.outer(kga, alpha) + np.outer(alpha, kga)) - (kinv * g_kd) @ kinv, kga


def host_loo(reg, u, x, y, dtype=np.float64):
    """LOO of GP(Bias, SE) (GPML eq. 5.10-5.12) at the unconstrained vector
    ``u`` and its gradient there (eq. 5.13, by dK/dtheta of each
    hyperparameter), all in ``dtype``: float64 is the reference, float32 a
    witness, independent of the port, of what float32 rounding does to the
    same formulas."""
    p = host_params(reg, u, dtype)
    x, y = x.astype(dtype), y.astype(dtype)
    k_se = host_gram(x, x, p["SE_rate"], p["SE_var"])
    value, kbar, kga = host_kbar(k_se + p["Noise_var"] * np.eye(len(x), dtype=dtype),
                                 y - p["Bias_Bias"])
    grads = {"Bias_Bias": [-kga.sum()], "SE_var": [np.sum(kbar * k_se)],
             "Noise_var": [p["Noise_var"] * np.trace(kbar)],
             "SE_rate": [np.sum(kbar * k_se * -((x[:, j, None] - x[None, :, j])
                                                * p["SE_rate"][j]) ** 2)
                         for j in range(x.shape[1])]}
    grad = np.concatenate([np.asarray(grads["_".join(par.name.split("_")[-2:])], np.float64)
                           for par in reg.ordered_params])
    return value, grad


def param_slices(reg):
    """(short name, slice of the flat vector) of each parameter, in order."""
    out, start = [], 0
    for par in reg.ordered_params:
        out.append(("_".join(par.name.split("_")[-2:]), slice(start, start + par.size)))
        start += par.size
    return out


def kbar_gaps(reg, u, x, y):
    """dLOO/dK in float32 on one float32 gram against float64 on the same
    gram (relative Frobenius norm): the port's (K1's gram + noise, K2 and
    its L^-1 through mvn_loo's backward, on the card) and the float32 host
    witness's; and how far the SE_var gradient's sum of K_bar * K_se
    magnifies an error of K_bar (sum of |terms| over |sum|)."""
    p = host_params(reg, u, np.float32)
    dev = g3t.settings.device
    fro = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    xt = torch.as_tensor(x, device=dev)
    k = (stationary_gram("se", xt, xt, torch.as_tensor(p["SE_rate"], device=dev),
                         torch.as_tensor(p["SE_var"], device=dev), None)
         + float(p["Noise_var"]) * torch.eye(len(x), device=dev)).requires_grad_(True)
    r = torch.as_tensor(y - p["Bias_Bias"], device=dev)
    mvn_loo(k, r)[0].backward()
    k64 = k.detach().double().cpu().numpy()
    _, ref, _ = host_kbar(k64, r.double().cpu().numpy())
    port = fro(k.grad.double().cpu().numpy(), ref)
    terms = ref * (k64 - float(p["Noise_var"]) * np.eye(len(x)))
    magnify = float(np.abs(terms).sum() / abs(terms.sum()))
    kh = host_gram(x, x, p["SE_rate"], p["SE_var"]) + p["Noise_var"] * np.eye(len(x),
                                                                             dtype=np.float32)
    rh = y - p["Bias_Bias"]
    witness = fro(host_kbar(kh, rh)[1], host_kbar(kh.astype(np.float64), rh.astype(np.float64))[1])
    return port, witness, magnify


def host_wgp_logp(reg, u, x, y):
    """float64 logp of WGP(Bias, SE, WarpingTanh) at ``u`` and its gradient
    there: the gaussian of z = y + sum_k a_k tanh(b_k (y + c_k)) plus
    sum log dz/dy, differentiated by hand."""
    import scipy.linalg

    p = host_params(reg, u)
    a, b, c = p["WarpingTanh_a"], p["WarpingTanh_b"], p["WarpingTanh_c"]
    n = len(x)
    arg = y[:, None] + c
    t = np.tanh(b * arg)
    sech2 = 1.0 - t * t
    z = y + t @ a
    dzdy = 1.0 + (a * b * sech2).sum(axis=1)
    k_se = host_gram(x, x, p["SE_rate"], p["SE_var"])
    chol = scipy.linalg.cholesky(k_se + p["Noise_var"] * np.eye(n), lower=True)
    r = z - p["Bias_Bias"]
    alpha = scipy.linalg.cho_solve((chol, True), r)
    value = float(-0.5 * n * np.log(2 * np.pi) - 0.5 * r @ alpha - np.log(np.diag(chol)).sum()
                  + np.log(dzdy).sum())
    kinv, info = scipy.linalg.lapack.dpotri(chol, lower=1)
    require(info == 0, f"host WGP: dpotri info {info}")
    kinv = np.tril(kinv) + np.tril(kinv, -1).T
    w = 0.5 * (np.outer(alpha, alpha) - kinv)
    dz = {"a": t, "b": a * sech2 * arg, "c": a * sech2 * b}          # (n, k) each
    dj = {"a": b * sech2, "b": a * sech2 * (1.0 - 2.0 * b * t * arg),  # d(dz/dy)/d.
          "c": -2.0 * a * b * b * t * sech2}
    scale = {"a": a, "b": b, "c": np.ones_like(c)}                     # log transforms
    grads = {"Bias_Bias": [alpha.sum()], "SE_var": [np.sum(w * k_se)],
             "Noise_var": [p["Noise_var"] * np.trace(w)],
             "SE_rate": [np.sum(w * k_se * -((x[:, j, None] - x[None, :, j])
                                             * p["SE_rate"][j]) ** 2)
                         for j in range(x.shape[1])]}
    for q in ("a", "b", "c"):
        grads["WarpingTanh_" + q] = scale[q] * (-(alpha @ dz[q]) + (dj[q] / dzdy[:, None]).sum(0))
    grad = np.concatenate([np.ravel(grads["_".join(par.name.split("_")[-2:])])
                           for par in reg.ordered_params])
    return value, grad


def rel(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b)) / np.linalg.norm(np.ravel(b)))


def host_draws(reg, u, x, y, xc, zs, dtype=np.float64):
    """The noisy posterior covariance at ``xc`` and the draws loc + L z of
    the normals ``zs``, all in ``dtype`` (float32: the rounding witness)."""
    p = host_params(reg, u, dtype)
    mean_c, cov_c, nv = host_posterior(p, x.astype(dtype), y.astype(dtype), xc.astype(dtype))
    cov_c = cov_c + nv * np.eye(len(xc), dtype=dtype)
    return cov_c, mean_c[:, None] + np.linalg.cholesky(cov_c) @ zs.astype(dtype)


def host_surface(reg, u, x, y, xh, yh, xc, zs, dtype=np.float64):
    """Host references of ``surface_run`` in ``dtype`` (float64, or the
    float32 witness): the scores at ``xh`` against ``yh`` and the draws
    loc + L z at ``xc`` (noise included)."""
    p = host_params(reg, u, dtype)
    x, y, yh = x.astype(dtype), y.astype(dtype), yh.astype(dtype)
    mean, cov, nv = host_posterior(p, x, y, xh.astype(dtype))
    resid = mean - yh
    var_n = np.diag(cov) + nv
    cov_c, draws = host_draws(reg, u, x, y, xc, zs, dtype)
    return {"_l1": np.abs(resid).mean(), "_l2": (resid ** 2).mean(),
            "_mse": (resid ** 2 + np.diag(cov)).mean(), "_logp": host_logp(reg, u, x, y),
            "_nlpd": np.mean(0.5 * np.log(2 * np.pi * var_n) + 0.5 * resid ** 2 / var_n),
            "cov": cov_c, "draws": draws}


def surface_gaps(got, refs):
    """Relative gaps of the scores, and the covariance's and draws' largest
    gaps relative to their largest values, of ``got`` against ``refs``."""
    return (
        {k: float(abs(got[k] - refs[k]) / abs(refs[k]))
         for k in ("_l1", "_l2", "_mse", "_nlpd", "_logp", "_loo")},
        {k: float(np.abs(host64(got[k]) - refs[k]).max() / np.abs(refs[k]).max())
         for k in ("cov", "draws")})


def surface_run(gp, params, xh, yh, xc, refs, path=None):
    """scores(logp, logpred, variance, median, loo) on the held-out points,
    then predict(cov=True, samples=64, noise=True) on ``xc`` and the draws
    of known normals, each against the float64 host ``refs``, in the
    active float type.  With ``path`` the launches of the scores and of
    the predict call are added to it (the draws' check is not counted)."""
    window = (lambda: counted(path)) if path is not None else contextlib.nullcontext
    gp.set_space(xh, hidden=yh)
    torch.cuda.synchronize()
    with window():
        t0 = time.perf_counter()
        sc = gp.scores(params, logp=True, logpred=True, variance=True, median=True, loo=True)
        t_scores = time.perf_counter() - t0
    require(all(math.isfinite(v) and v > -1e29 for v in sc.values()), f"scores {sc}")
    gp.set_space(xc)
    torch.cuda.synchronize()
    with window():
        t0 = time.perf_counter()
        out = gp.predict(params, mean=True, std=False, cov=True, samples=64, noise=True)
        torch.cuda.synchronize()
        t_cov = time.perf_counter() - t0
    c = host64(out["covariance"])
    require(out["samples"].shape == (1024, 64) and finite(out["samples"]) and finite(c),
            "predict(cov=True, samples=64) is not finite")
    asym = float(np.abs(c - c.T).max() / np.abs(c).max())
    require(asym <= 1e-6, f"posterior covariance not symmetric ({asym:.3e})")
    draws = gp.sampler(params, samples=64, noise=True, rng=np.random.default_rng(70))
    score_gaps, gaps = surface_gaps(dict(sc, cov=c, draws=draws), refs)
    return dict(scores_ms=t_scores * 1e3, cov_samples_ms=t_cov * 1e3, asym=asym,
                score_gaps=score_gaps, cov_gap=gaps["cov"], sample_gap=gaps["draws"])


# At phase 5's MAP (cond(K) ~ 1e5) float32 rounding alone moves the LOO
# gradient, the posterior covariance and the draws.  There each of the
# port's float32 gaps to the float64 host is held to the larger of its
# limit elsewhere and WITNESS_FACTOR times the gap of a float32 host
# recomputation of the same formulas (host_loo, host_surface in float32:
# scipy's spotrf/spotri, numpy's float32 products), which shows what
# float32 rounding alone does, independent of the port.
WITNESS_FACTOR = 4.0


def phase7b(gp, gp_map, x, y, path):
    """GP(Bias, SE) at n=4096, d=8 from phase 5's MAP: LOO and its gradient
    against the float64 host, find_MAP(objective='loo') in float32 and in
    float64, scores on 512 held-out points, covariance and 64 samples at
    m=1024.  The float32 runs of the main path (the timed LOO calls,
    find_MAP, the scores and predict at the MAP) add their launches to
    ``path``; the checks at the default params and the float64 twins do not."""
    reg = gp.active
    u = reg.dict_to_array(gp_map)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    times = []
    with counted(path):
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gp._array_loo_sampling(u)
            gp._array_dloo_sampling(u)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"  LOO value + gradient at the MAP, float32: median {statistics.median(times):.2f} "
          f"ms over 5 (all {[round(t, 2) for t in times]})", flush=True)
    # Against the float64 host: float32 at the default params (as phase 5b
    # holds dlogp) and at the MAP, float64 at the MAP; the float32 host
    # witness at the MAP sets the float32 gradient's limit there.
    gaps, host = {}, {}
    t0 = time.perf_counter()
    u_default = reg.dict_to_array(gp.params_default)
    for label, point in (("default", u_default), ("MAP", u)):
        ref_val, ref_grad = host[label] = host_loo(reg, point, x64, y64)
        runs = [("float32", gp._array_loo_sampling(point), gp._array_dloo_sampling(point))]
        if label == "MAP":
            runs.append(("float32 host witness",) + host_loo(reg, point, x, y, np.float32))
            host["MAP witness"] = runs[-1][1]
            g3t.settings.floatx = "float64"
            try:
                runs.append(("float64", gp._array_loo_sampling(point),
                             gp._array_dloo_sampling(point)))
            finally:
                g3t.settings.floatx = "float32"
        for dtype, val, grad in runs:
            gaps[f"{label} {dtype}"] = (abs(val - ref_val) / abs(ref_val), rel(grad, ref_grad))
            print(f"  LOO at the {label} params, {dtype}: {val:.4f} vs host {ref_val:.4f}; "
                  f"value gap {gaps[f'{label} {dtype}'][0]:.3e}, gradient gap "
                  f"{gaps[f'{label} {dtype}'][1]:.3e}; |error| by parameter: "
                  + ", ".join(f"{name} {np.linalg.norm(grad[sl] - ref_grad[sl]):.2e}"
                              for name, sl in param_slices(reg)), flush=True)
    print(f"  (host LOO and gradient: {time.perf_counter() - t0:.1f} s)", flush=True)
    witness = gaps.pop("MAP float32 host witness")
    kbar_port, kbar_witness, magnify = kbar_gaps(reg, u, x, y)
    print(f"  dLOO/dK at the MAP, float32 vs float64 on the same float32 gram: port "
          f"{kbar_port:.3e}, float32 host witness {kbar_witness:.3e} (relative Frobenius); the "
          f"SE_var gradient sums terms {magnify:.3e} times its value", flush=True)
    require(kbar_port <= WITNESS_FACTOR * kbar_witness,
            f"dLOO/dK at the MAP: port {kbar_port:.3e} > {WITNESS_FACTOR} x the float32 host "
            f"witness {kbar_witness:.3e}")
    for key, (g_val, g_grad) in gaps.items():
        require(g_val <= 1e-3, f"LOO value at the {key} vs the float64 host: {g_val:.3e}")
        limit = max(1e-2, WITNESS_FACTOR * witness[1] if key == "MAP float32" else 0.0)
        require(g_grad <= limit, f"LOO gradient at the {key} vs the float64 host: "
                f"{g_grad:.3e} > {limit:.3e}")

    # find_MAP(objective='loo') from the default params: float32 (the main
    # path, timed and counted), then float64 from the same start; the
    # float32 optimum's LOO is read in float64 too.
    with counted(path):
        t0 = time.perf_counter()
        fit, points = gp.find_MAP(points=1, powell=False, display=False, objective="loo",
                                  return_points=True)
        t_fit = time.perf_counter() - t0
    g3t.settings.floatx = "float64"
    try:
        t0 = time.perf_counter()
        fit64, points64 = gp.find_MAP(points=1, powell=False, display=False, objective="loo",
                                      return_points=True)
        t_fit64 = time.perf_counter() - t0
        loo32_in64 = gp._array_loo_sampling(reg.dict_to_array(fit))
    finally:
        g3t.settings.floatx = "float32"
    fits = dict(fit_s=t_fit, loo_start=points[0][1], loo_fit=points[-1][1],
                loo_fit_in64=loo32_in64, fit64_s=t_fit64, loo_fit64=points64[-1][1],
                loo_logp_map=host["MAP"][0])
    print(f"  find_MAP(objective='loo'), float32: LOO {points[0][1]:.4f} -> "
          f"{points[-1][1]:.4f} in {t_fit:.2f} s ({[pt[0] for pt in points]}), "
          f"{loo32_in64:.4f} read in float64; float64: -> {points64[-1][1]:.4f} in "
          f"{t_fit64:.2f} s; the LOO at the logp MAP {host['MAP'][0]:.4f}", flush=True)
    require(points[-1][1] > points[0][1], "find_MAP(objective='loo') did not raise the LOO")
    require(points64[-1][1] >= host["MAP"][0] - 1e-6 * abs(host["MAP"][0]),
            "float64 find_MAP(objective='loo') stopped below the LOO at the logp MAP")
    # float32 stops where its gradient is rounding (cond(K) ~ 1e5, as at the
    # logp MAP above): a guard on how far short, not a claim of accuracy
    require(loo32_in64 >= points64[-1][1] - 1e-2 * abs(points64[-1][1]),
            f"float32 find_MAP(objective='loo') stopped more than 1% below the float64 "
            f"optimum: {loo32_in64:.4f} vs {points64[-1][1]:.4f}")

    # Scores and draws against the float64 host, like the LOO: float32 at
    # the default params and at the MAP (timed, counted; held to the
    # float32 host witness there), float64 at the MAP.
    hold = np.random.default_rng(77)
    xh = hold.standard_normal((512, 8)).astype(np.float32)
    yh = (np.sin(xh[:, 0]) + 0.1 * hold.standard_normal(512)).astype(np.float32)
    xc = np.random.default_rng(78).standard_normal((1024, 8)).astype(np.float32)
    zs = np.random.default_rng(70).standard_normal((1024, 64)).astype(np.float32)
    surface = {}
    for label, params, point in (("default", gp.params_default, u_default), ("MAP", gp_map, u)):
        refs = host_surface(reg, point, x64, y64, xh, yh, xc, zs)
        refs["_loo"] = host[label][0]
        for dtype in (("float32",) if label == "default" else ("float32", "float64")):
            g3t.settings.floatx = dtype
            try:
                surface[f"{label} {dtype}"] = surface_run(
                    gp, params, xh, yh, xc, refs,
                    path if (label, dtype) == ("MAP", "float32") else None)
            finally:
                g3t.settings.floatx = "float32"
        if label == "MAP":
            refs32 = host_surface(reg, point, x, y, xh, yh, xc, zs, np.float32)
            refs32["_loo"] = host["MAP witness"]
            w_scores, w_rest = surface_gaps(refs32, refs)
            witness_surface = dict(score_gaps=w_scores, cov_gap=w_rest["cov"],
                                   sample_gap=w_rest["draws"])
    print("  float32 host witness at the MAP: score gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in w_scores.items())
          + f"; covariance gap {w_rest['cov']:.3e}, draws vs loc + L z "
          f"{w_rest['draws']:.3e} of the largest value", flush=True)
    for key, out in surface.items():
        print(f"  {key}: scores on 512 held-out points in {out['scores_ms']:.1f} ms, gaps "
              + ", ".join(f"{k} {v:.2e}" for k, v in out["score_gaps"].items())
              + f"; predict(cov=True, samples=64, noise=True) at m=1024 in "
              f"{out['cov_samples_ms']:.1f} ms, asymmetry {out['asym']:.1e}, covariance gap "
              f"{out['cov_gap']:.3e}, draws vs loc + L z {out['sample_gap']:.3e} of the largest "
              "value", flush=True)
        witnessed = key == "MAP float32"
        for k, gap in out["score_gaps"].items():
            limit = max(1e-3, WITNESS_FACTOR * w_scores[k] if witnessed else 0.0)
            require(gap <= limit, f"{key}: score {k} vs the float64 host {gap:.3e} > {limit:.3e}")
        for k in ("cov_gap", "sample_gap"):
            limit = max(1e-3, WITNESS_FACTOR * witness_surface[k] if witnessed else 0.0)
            require(out[k] <= limit, f"{key}: {k} vs the float64 host {out[k]:.3e} > {limit:.3e}")
    return dict(loo_ms=statistics.median(times), loo_gaps=gaps, loo_witness=witness,
                kbar=dict(port=kbar_port, witness=kbar_witness, magnify=magnify), fits=fits, surface=surface, surface_witness=witness_surface)


def phase7c(rng, path, n=4096):
    """WGP(Bias, SE, WarpingTanh n=3) at n=4096, d=8: logp/dlogp against the
    float64 host, then Predictor batches of 256 (mean, median, quantiles)
    through the Newton inverse on the card, its share of a batch, and the
    round trip T^-1(T(x)).  The timed logp/dlogp calls, the Predictor's
    set-up and its batches add their launches to ``path``."""
    d = 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.exp(np.sin(x[:, 0])) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                  mapping=g3t.WarpingTanh(y, n=3), name="SMOKE_TWGP")
    wgp.observed(x, y)
    params = dict(wgp.params_default)
    # a warping that bends: b 10x and a 2x the (near-linear) defaults
    params["SMOKE_TWGP_WarpingTanh_b"] = params["SMOKE_TWGP_WarpingTanh_b"] * 10.0
    params["SMOKE_TWGP_WarpingTanh_a"] = params["SMOKE_TWGP_WarpingTanh_a"] * 2.0
    reg = wgp.active
    u = reg.dict_to_array(params)
    times = []
    with counted(path):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val = wgp.logp(u, array=True)
            grad = wgp.dlogp(u)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ref_val, ref_grad = host_wgp_logp(reg, u, x.astype(np.float64), y.astype(np.float64))
    gaps = {"logp": abs(val - ref_val) / abs(ref_val), "dlogp": rel(grad, ref_grad)}
    print(f"  WGP WarpingTanh n=3, n={n}: logp {val:.4f} vs host {ref_val:.4f}; logp+dlogp "
          f"median {statistics.median(times):.2f} ms; gaps {gaps}", flush=True)
    require(gaps["logp"] <= 1e-3 and gaps["dlogp"] <= 1e-2, f"WGP vs the float64 host: {gaps}")

    with counted(path):
        pr = wgp.predictor(params)
    batch_ms, newton_ms = [], []
    resid = 0.0
    p = pr._merged
    for b in range(8):
        xq = rng.standard_normal((256, d)).astype(np.float32)
        torch.cuda.synchronize()
        with counted(path):
            t0 = time.perf_counter()
            out = pr(xq, mean=True, std=False, median=True, quantiles=True)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        out = on_card(out)
        for k in ("mean", "median", "quantile_up", "quantile_down"):
            require(out[k].shape == (256,) and finite(out[k]), f"WGP batch {b}: {k}")
        require(bool((out["quantile_down"] <= out["median"]).all()
                     and (out["median"] <= out["quantile_up"]).all()),
                f"WGP batch {b}: quantiles do not bracket the median")
        # the batch's four forward solves alone: the quadrature grid (mean),
        # the location (median) and the two quantile arguments
        loc, latent, _ = wgp._latent_moments(p, pr._space(xq), pr.inputs, pr.outputs)
        sd = torch.sqrt(latent)
        grid, _ = g3t.ops.quadrature.hermite_grid(loc, sd, g3t.settings.quadrature_degree)
        z = wgp._quantile_p(0.975)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for arg in (grid, loc, loc + z * sd, loc - z * sd):
                wgp.f_mapping(p, arg)
        torch.cuda.synchronize()
        newton_ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            back = wgp.f_mapping.inv(p, out["median"])
        resid = max(resid, float((back - loc).abs().max() / loc.abs().max()))
    share = statistics.median(newton_ms) / statistics.median(batch_ms)
    print(f"  WGP Predictor, 8 batches of 256 (mean, median, quantiles): median "
          f"{statistics.median(batch_ms):.3f} ms (all {[round(t, 2) for t in batch_ms]}); "
          f"its four Newton solves {statistics.median(newton_ms):.3f} ms ({share:.2f} of the "
          f"batch); max |T^-1(T(x)) - x| / max|x| {resid:.3e}", flush=True)
    require(resid <= 1e-4, f"Newton round trip residual {resid:.3e} > 1e-4")
    prof = profile(lambda: wgp.f_mapping(p, grid), reps=3)
    busy = top_ops(prof, "Newton solve on the (10, 256) quadrature grid, 3 calls", count=6) / 3
    t_solve = event_ms(lambda: wgp.f_mapping(p, grid), reps=10, warmup=2)
    print(f"    one Newton solve on the (10, 256) grid: {t_solve:.3f} ms (events), device busy "
          f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / t_solve):.3f}", flush=True)
    return dict(logp_dlogp_ms=statistics.median(times), gaps=gaps,
                batch_ms=statistics.median(batch_ms), newton_ms=statistics.median(newton_ms),
                newton_share=share, solve_ms=t_solve, solve_busy_ms=busy, residual=resid)


# ---------------------------------------------------------------- phase 8
# The reference's other process families at full width (bench.py:216-220's
# n=4096, d=8 data): Student-t (TP, WTP), transport (TGP) and copula (CGP,
# CSTP) through K1 and K2, the marginal family (MP) through neither, and the
# Student-t Bayesian path.  Each family's logp and dlogp are held to a
# float64 host recomputation (numpy grams, scipy factorizations and special
# functions): the Student-t processes' gradient analytically, the others'
# along two random directions by central differences of the host logp.
def host_sqdist(a, b, rate):
    """sum_k ((a_k - b_k) rate_k)^2 by scipy's cdist (differences summed in
    C, no norm decomposition), in the float type of ``a``."""
    from scipy.spatial.distance import cdist

    return cdist(a * rate, b * rate, "sqeuclidean").astype(a.dtype, copy=False)


def host_se(a, b, rate, var):
    """``host_gram`` through cdist: phase 8's central differences build
    about twenty n=4096 grams, where the per-dimension loop of ``host_gram``
    (kept for phase 7's float32 witness, which rounds each term) costs
    seconds."""
    return var * np.exp(-0.5 * host_sqdist(a, b, rate))


def host_mat52(a, b, rate, var):
    d5 = np.sqrt(5.0 * 0.5 * host_sqdist(a, b, rate))
    return var * (1.0 + d5 + d5 * d5 / 3.0) * np.exp(-d5)


def host_t_terms(nu, n, beta, dtype=np.float64):
    """The (nu-2)-normalized multivariate t's terms but the log-determinant,
    with the gaussian normalization from nu = 1e6 on, as the reference
    defines it (the lgamma difference cancels there, in float64 too); in
    ``dtype`` arithmetic, each lgamma rounded to it."""
    from scipy.special import gammaln

    f = np.dtype(dtype).type
    nu, n, beta = f(nu), f(n), f(beta)
    if nu >= 1e6:
        norm = f(-0.5) * n * f(np.log(2.0 * np.pi))
    else:
        norm = (f(gammaln((nu + n) / f(2))) - f(gammaln(nu / f(2)))
                - f(0.5) * n * np.log((nu - f(2)) * f(np.pi)))
    return f(-0.5) * (nu + n) * np.log1p(beta / (nu - f(2))) + norm


def host_tp_value(reg, u, x, y, dtype=np.float64):
    """TP(Bias, SE) logp at ``u`` in ``dtype`` arithmetic (float32: the
    rounding witness of the same formulas)."""
    import scipy.linalg

    p = host_params(reg, u, dtype)
    x, y = x.astype(dtype), y.astype(dtype)
    n = len(x)
    chol = host_factor(host_se(x, x, p["SE_rate"], p["SE_var"])
                       + p["Noise_var"] * np.eye(n, dtype=dtype))
    w = scipy.linalg.solve_triangular(chol, y - p["Bias_Bias"], lower=True)
    return float(host_t_terms(2.0 + p["Freedom_degree"], n, w @ w, dtype)
                 - np.log(np.diag(chol)).sum())


def host_factor(k):
    import scipy.linalg

    return scipy.linalg.cholesky(k, lower=True)


def host_tp(reg, u, x, y):
    """float64 logp of TP(Bias, SE) at ``u`` and its gradient there, by hand:
    with alpha = K^-1 r, beta = r'alpha and c = (nu+n)/(2(nu-2+beta)),
    dlogp/dK = c alpha alpha' - K^-1/2, dlogp/dr = -2c alpha, and the degree's
    own term through digamma."""
    import scipy.linalg
    from scipy.special import digamma

    p = host_params(reg, u)
    n = len(x)
    nu = 2.0 + p["Freedom_degree"]
    k_se = host_se(x, x, p["SE_rate"], p["SE_var"])
    chol = host_factor(k_se + p["Noise_var"] * np.eye(n))
    r = y - p["Bias_Bias"]
    alpha = scipy.linalg.cho_solve((chol, True), r)
    beta = float(r @ alpha)
    value = float(host_t_terms(nu, n, beta) - np.log(np.diag(chol)).sum())  # float64
    kinv, info = scipy.linalg.lapack.dpotri(chol, lower=1)
    require(info == 0, f"host TP: dpotri info {info}")
    kinv = np.tril(kinv) + np.tril(kinv, -1).T
    c = (nu + n) / (2.0 * (nu - 2.0 + beta))
    w = c * np.outer(alpha, alpha) - 0.5 * kinv
    dnu = (-0.5 * np.log1p(beta / (nu - 2.0))
           + 0.5 * (nu + n) * beta / ((nu - 2.0) * (nu - 2.0 + beta)))
    if nu < 1e6:
        dnu += 0.5 * digamma((nu + n) / 2.0) - 0.5 * digamma(nu / 2.0) - 0.5 * n / (nu - 2.0)
    grads = {"Bias_Bias": [2.0 * c * alpha.sum()], "SE_var": [np.sum(w * k_se)],
             "Noise_var": [p["Noise_var"] * np.trace(w)],
             "SE_rate": [np.sum(w * k_se * -((x[:, j, None] - x[None, :, j])
                                             * p["SE_rate"][j]) ** 2)
                         for j in range(x.shape[1])],
             "Freedom_degree": [p["Freedom_degree"] * dnu]}
    grad = np.concatenate([np.ravel(grads["_".join(par.name.split("_")[-2:])])
                           for par in reg.ordered_params])
    return value, grad


def host_tp_posterior(p, x, y, xq, dtype=np.float64):
    """TP(Bias, SE) posterior statistics at ``xq`` in ``dtype``, as the
    Predictor serves them: the variance scaled by (nu+beta-2)/(nu+n-2), the
    Student-t quantiles at nu+n on the unscaled sd."""
    import scipy.linalg
    from scipy import stats

    x, y, xq = x.astype(dtype), y.astype(dtype), xq.astype(dtype)
    p = {k: np.asarray(v, dtype) for k, v in p.items()}
    n = len(x)
    chol = host_factor(host_se(x, x, p["SE_rate"], p["SE_var"])
                       + p["Noise_var"] * np.eye(n, dtype=dtype))
    r = y - p["Bias_Bias"]
    z = scipy.linalg.solve_triangular(chol, r, lower=True)
    cross = host_se(xq, x, p["SE_rate"], p["SE_var"])
    loc = p["Bias_Bias"] + cross @ scipy.linalg.cho_solve((chol, True), r)
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    latent = np.maximum(p["SE_var"] - (v * v).sum(axis=0), 0.0)
    nu = 2.0 + p["Freedom_degree"]
    scale = (nu + z @ z - 2.0) / (nu + n - 2.0)
    up = float(np.float32(stats.t.ppf(0.975, nu + n)))
    down = float(np.float32(stats.t.ppf(0.025, nu + n)))
    noisy = latent + p["Noise_var"]
    return {"mean": loc, "std": np.sqrt(latent * scale), "quantile_up": loc + up * np.sqrt(latent),
            "quantile_down": loc + down * np.sqrt(latent), "noise_std": np.sqrt(noisy * scale),
            "noise_up": loc + up * np.sqrt(noisy), "noise_down": loc + down * np.sqrt(noisy)}


def stat_gap(got, ref):
    """max |got - ref| / max |ref| of each statistic."""
    return {k: float(np.abs(host64(got[k]) - ref[k]).max() / np.abs(ref[k]).max())
            for k in ref}


def directional_check(proc, host_logp_fn, u, label, seed):
    """logp at ``u`` against the float64 host, and dlogp along two random
    unit directions against central differences (h = 1e-4) of the host
    logp: relative gaps, limits 1e-3 and 1e-2."""
    reg = proc.active
    val = proc.logp(u, array=True)
    grad = proc.dlogp(u).astype(np.float64)
    u64 = np.asarray(u, np.float64)
    ref = host_logp_fn(u64)
    gaps = {"logp": abs(val - ref) / abs(ref)}
    dirs = np.random.default_rng(seed).standard_normal((2, reg.ndim))
    h = 1e-4
    for i, v in enumerate(dirs / np.linalg.norm(dirs, axis=1, keepdims=True)):
        fd = (host_logp_fn(u64 + h * v) - host_logp_fn(u64 - h * v)) / (2 * h)
        gaps[f"dlogp_dir{i}"] = abs(grad @ v - fd) / max(abs(fd), 1e-3 * np.linalg.norm(grad))
    print(f"  {label}: logp {val:.4f} vs host {ref:.4f}; gaps "
          + ", ".join(f"{k}={g:.3e}" for k, g in gaps.items()), flush=True)
    require(gaps["logp"] <= 1e-3, f"{label}: logp gap {gaps['logp']:.3e} > 1e-3")
    require(all(g <= 1e-2 for k, g in gaps.items() if k != "logp"),
            f"{label}: dlogp gaps {gaps}")
    return gaps


def timed_eval(proc, u, reps=3):
    """Median ms of one logp + dlogp pair."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.logp(u, array=True)
        proc.dlogp(u)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def family_launches(label, path, k1, k2):
    print(f"    {label}: K1 x{k1}, K2 x{k2}", flush=True)
    path[0] += k1
    path[1] += k2


def phase8a(x, y, path):
    """TP(Bias, SE) at n=4096: logp/dlogp against the float64 host, find_MAP,
    the Predictor's set-up and 8 batches of 256 against the host posterior
    (float32 at the default params within 1e-3; at the MAP within the larger
    of 1e-3 and 4x a float32 host witness's gap)."""
    tp = g3t.TP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="SMOKE_TP")
    tp.observed(x, y)
    reg = tp.active
    u = reg.dict_to_array(tp.params_default)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    zero_counts()
    t_eval = timed_eval(tp, u)
    val, grad = tp.logp(u, array=True), tp.dlogp(u)
    k1, k2, _ = launches()
    ref_val, ref_grad = host_tp(reg, u, x64, y64)
    gaps = {"logp": abs(val - ref_val) / abs(ref_val), "dlogp": rel(grad, ref_grad)}
    print(f"  TP n={len(x)}: logp {val:.4f} vs host {ref_val:.4f}; logp+dlogp median {t_eval:.2f} "
          f"ms; gaps {gaps}", flush=True)
    require(gaps["logp"] <= 1e-3 and gaps["dlogp"] <= 1e-2, f"TP vs the float64 host: {gaps}")
    require(k1 > 0 and k2 > 0, f"TP logp/dlogp: K1 x{k1}, K2 x{k2}")
    family_launches("TP logp+dlogp", path, k1, k2)
    top_ops(profile(lambda: (tp.logp(u, array=True), tp.dlogp(u))),
            f"TP n={len(x)} logp+dlogp", count=8)

    zero_counts()
    before = tp.logp(u, array=True)
    t0 = time.perf_counter()
    tp_map = tp.find_MAP(points=1, powell=False, display=False)
    t_fit = time.perf_counter() - t0
    after = tp.logp(tp_map)
    k1, k2, _ = launches()
    print(f"  TP find_MAP: logp {before:.4f} -> {after:.4f} in {t_fit:.2f} s; nu at the MAP "
          f"{2.0 + float(tp_map['SMOKE_TP_Freedom_degree']):.1f}", flush=True)
    require(after > before, f"TP find_MAP did not raise logp ({before} -> {after})")
    family_launches("TP find_MAP", path, k1, k2)

    rng = np.random.default_rng(81)
    queries = [rng.standard_normal((256, 8)).astype(np.float32) for _ in range(8)]
    out = {}
    for label, params in (("default", tp.params_default), ("MAP", tp_map)):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        pr = tp.predictor(params)
        torch.cuda.synchronize()
        t_setup = (time.perf_counter() - t0) * 1e3
        times, outs = [], []
        for xq in queries:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = pr(xq, quantiles=True, quantiles_noise=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(o)
        k1, k2, _ = launches()
        family_launches(f"TP Predictor ({label})", path, k1, k2)
        require(all(finite(o[k]) and o[k].shape == (256,) for o in outs for k in o),
                f"TP Predictor ({label}) output is not finite")
        p = {k: np.asarray(v, np.float64)
             for k, v in host_params(reg, reg.dict_to_array(params)).items()}
        ref = host_tp_posterior(p, x, y, queries[0])
        gap = stat_gap(outs[0], ref)
        limit = 1e-3
        if label == "MAP":
            witness = stat_gap({k: torch.as_tensor(v) for k, v in
                                host_tp_posterior(p, x, y, queries[0], np.float32).items()}, ref)
            limit = max(1e-3, 4 * max(witness.values()))
            print(f"    float32 host witness at the MAP: max gap {max(witness.values()):.3e}",
                  flush=True)
        print(f"  TP Predictor ({label}): set-up {t_setup:.1f} ms; 8 batches of 256 median "
              f"{statistics.median(times):.3f} ms; batch 0 vs the float64 host: max gap "
              f"{max(gap.values()):.3e} ({max(gap, key=gap.get)}; limit {limit:.3e})", flush=True)
        require(max(gap.values()) <= limit, f"TP Predictor ({label}) vs host: {gap}")
        out[label] = dict(setup_ms=t_setup, batch_ms=statistics.median(times),
                          gap=max(gap.values()))
    return dict(logp_dlogp_ms=t_eval, gaps=gaps, fit_s=t_fit, map_logp=after, **out)


def host_wtp_logp(reg, x, y):
    """float64 logp of WTP(Bias, MAT52, BoxCoxLinear) as a function of the
    unconstrained vector."""
    import scipy.linalg

    def fn(u):
        p = host_params(reg, u)
        n = len(x)
        nu = 2.0 + p["Freedom_degree"]
        s, sh, pw = p["BoxCoxLinear_scale"], p["BoxCoxLinear_shift"], p["BoxCoxLinear_power"]
        shifted = s * (y + sh)
        z = (np.sign(shifted) * np.abs(shifted) ** pw - 1.0) / pw
        logdet = (pw - 1.0) * np.log(np.abs(shifted)).sum() + n * np.log(s)
        chol = host_factor(host_mat52(x, x, p["MAT52_rate"], p["MAT52_var"])
                           + p["Noise_var"] * np.eye(n))
        w = scipy.linalg.solve_triangular(chol, z - p["Bias_Bias"], lower=True)
        return float(host_t_terms(nu, n, w @ w) - np.log(np.diag(chol)).sum() + logdet)

    return fn


def phase8b(x, y_pos, path):
    """WTP(Bias, MAT52, BoxCoxLinear) at n=4096 on y > 0: logp/dlogp against
    the float64 host, and a Predictor batch of 256."""
    wtp = g3t.WTP(space=x[:4], location=g3t.Bias(), kernel=g3t.MAT52(x),
                  mapping=g3t.BoxCoxLinear(y_pos), name="SMOKE_WTP")
    wtp.observed(x, y_pos)
    u = wtp.active.dict_to_array(wtp.params_default)
    zero_counts()
    t_eval = timed_eval(wtp, u)
    k1, k2, _ = launches()
    require(k1 > 0 and k2 > 0, f"WTP logp/dlogp: K1 x{k1}, K2 x{k2}")
    family_launches("WTP logp+dlogp", path, k1, k2)
    gaps = directional_check(wtp, host_wtp_logp(wtp.active, x.astype(np.float64),
                                                y_pos.astype(np.float64)), u, f"WTP n={len(x)}", 82)
    xq = np.random.default_rng(83).standard_normal((256, 8)).astype(np.float32)
    zero_counts()
    t0 = time.perf_counter()
    out = wtp.predictor()(xq, quantiles=True, quantiles_noise=True)
    torch.cuda.synchronize()
    t_batch = (time.perf_counter() - t0) * 1e3
    k1, k2, _ = launches()
    family_launches("WTP Predictor set-up + batch", path, k1, k2)
    require(all(finite(v) for v in out.values())
            and bool((out["quantile_down"] <= out["quantile_up"]).all()),
            "WTP Predictor batch is not finite or its quantiles cross")
    print(f"  WTP n={len(x)}: logp+dlogp median {t_eval:.2f} ms; Predictor set-up + a batch of 256 "
          f"{t_batch:.1f} ms", flush=True)
    return dict(logp_dlogp_ms=t_eval, gaps=gaps, predictor_ms=t_batch)


def host_tgp_logp(reg, x, y):
    import scipy.linalg

    def fn(u):
        p = host_params(reg, u)
        n = len(x)
        chol = host_factor(host_se(x, x, p["SE_rate"], p["SE_var"])
                           + p["NoiseSE_var"] * np.eye(n))
        w = scipy.linalg.solve_triangular(chol, y - p["Bias_Bias"], lower=True)
        return float(-0.5 * n * np.log(2 * np.pi) - 0.5 * w @ w - np.log(np.diag(chol)).sum())

    return fn


def host_tgp_draws(p, x, y, xq, rand):
    """The TGP's posterior draws of the normals ``rand`` (m, S) in float64:
    the observations whitened by the noisy observed block, stacked on the
    normals and coloured by the joint Cholesky (noise-free query block),
    plus the location."""
    import scipy.linalg

    n = len(x)
    k_obs = host_se(x, x, p["SE_rate"], p["SE_var"]) + p["NoiseSE_var"] * np.eye(n)
    white = scipy.linalg.solve_triangular(host_factor(k_obs), y - p["Bias_Bias"], lower=True)
    k_cross = host_se(x, xq, p["SE_rate"], p["SE_var"])
    joint = np.block([[k_obs, k_cross], [k_cross.T, host_se(xq, xq, p["SE_rate"], p["SE_var"])]])
    stacked = np.concatenate([np.repeat(white[:, None], rand.shape[1], axis=1), rand])
    return (host_factor(joint) @ stacked)[n:] + p["Bias_Bias"]


def phase8c(x, y, path):
    """TGP(TLocation(Bias) @ TKernel(SE, noisy=True)) at n=4096: logp/dlogp
    against the float64 host; a pure TKernel TGP against the port's own
    zero-mean GP; predict(quantiles=True, simulations=30) at m=256, timed and
    counted, against a float64 host replay of the same numpy draws."""
    tgp = g3t.TGP(space=x[:4], transport=g3t.TLocation(g3t.Bias(x))
                  @ g3t.TKernel(g3t.SE(x), noisy=True), name="SMOKE_TGP")
    tgp.observed(x, y)
    reg = tgp.active
    u = reg.dict_to_array(tgp.params_default)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    zero_counts()
    t_eval = timed_eval(tgp, u)
    k1, k2, _ = launches()
    require(k1 > 0 and k2 > 0, f"TGP logp/dlogp: K1 x{k1}, K2 x{k2}")
    family_launches("TGP logp+dlogp", path, k1, k2)
    gaps = directional_check(tgp, host_tgp_logp(reg, x64, y64), u, f"TGP n={len(x)}", 84)

    pure = g3t.TGP(space=x[:4], transport=g3t.TKernel(g3t.SE(x), noisy=True), name="SMOKE_TGPK")
    pure.observed(x, y)
    gp = g3t.GP(space=x[:4], location=g3t.Zero(), kernel=g3t.SE(x), name="SMOKE_TGPGP")
    gp.observed(x, y)
    pt = pure.params_default
    pg = {"SMOKE_TGPGP_SE_var": pt["SMOKE_TGPK_SE_var"],
          "SMOKE_TGPGP_SE_rate": pt["SMOKE_TGPK_SE_rate"],
          "SMOKE_TGPGP_Noise_var": pt["SMOKE_TGPK_NoiseSE_var"]}
    lt, lg = pure.loglike(pt), gp.loglike(pg)
    print(f"  pure TKernel TGP loglike {lt:.4f} vs the zero-mean GP's {lg:.4f}", flush=True)
    require(abs(lt - lg) <= 1e-5 * abs(lg), f"TKernel TGP {lt} vs GP {lg}")

    m, sims, seed = 256, 30, 85
    xq = np.random.default_rng(86).standard_normal((m, 8)).astype(np.float32)
    tgp.predict(space=xq[:8], quantiles=True, simulations=2, rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = tgp.predict(space=xq, quantiles=True, simulations=sims,
                      rng=np.random.default_rng(seed))
    torch.cuda.synchronize()
    t_pred = (time.perf_counter() - t0) * 1e3
    k1, k2, _ = launches()
    family_launches("TGP predict", path, k1, k2)
    require(k1 > 0 and k2 > 0, f"TGP predict: K1 x{k1}, K2 x{k2}")
    rand = np.random.default_rng(seed).standard_normal((m, sims)).astype(np.float32)
    p = host_params(reg, u)
    draws = host_tgp_draws(p, x64, y64, xq.astype(np.float64), rand.astype(np.float64))
    ref = {"mean": draws.mean(axis=1), "std": draws.std(axis=1),
           "quantile_up": np.percentile(draws, 97.5, axis=1),
           "quantile_down": np.percentile(draws, 2.5, axis=1)}
    gap = stat_gap(out, ref)
    print(f"  TGP predict(quantiles, simulations={sims}) at m={m}: {t_pred:.1f} ms, K1 x{k1}, "
          f"K2 x{k2}; vs the float64 host replay of the same draws: "
          + ", ".join(f"{k}={g:.3e}" for k, g in gap.items()), flush=True)
    require(max(gap.values()) <= 1e-3, f"TGP predict vs host replay: {gap}")
    top_ops(profile(lambda: tgp.predict(space=xq, quantiles=True, simulations=sims,
                                        rng=np.random.default_rng(seed))),
            f"TGP predict(quantiles, simulations={sims}) m={m}", count=8)
    return dict(logp_dlogp_ms=t_eval, gaps=gaps, predict_ms=t_pred, predict_gap=max(gap.values()))


def host_copula_logp(reg, x, y, student):
    """float64 logp of CGP / CSTP(SE, Normal(M, S)) as a function of the
    unconstrained vector."""
    import scipy.linalg
    from scipy import special, stats

    lo, hi = float(np.float32(1e-6)), float(np.float32(1.0) - np.float32(1e-6))

    def fn(u):
        p = host_params(reg, u)
        n = len(x)
        mu, sd = p["M_Bias"], abs(p["S_Bias"])
        z = special.ndtri(np.clip(stats.norm.cdf((y - mu) / sd), lo, hi))
        k = host_se(x, x, p["SE_rate"], p["SE_var"]) + p["Noise_var"] * np.eye(n)
        d = np.sqrt(np.diag(k))
        chol = host_factor(k / np.outer(d, d))
        w = scipy.linalg.solve_triangular(chol, z, lower=True)
        marg = stats.norm.logpdf(y, mu, sd).sum()
        logdet = np.log(np.diag(chol)).sum()
        if not student:
            return float(-0.5 * w @ w + 0.5 * z @ z - logdet + marg)
        nu = 2.0 + p["Freedom_degree"]
        joint = (special.gammaln((nu + n) / 2) - special.gammaln(nu / 2) - logdet
                 - 0.5 * (nu + n) * np.log1p(w @ w / nu))
        indep = (n * (special.gammaln((nu + 1) / 2) - special.gammaln(nu / 2))
                 - 0.5 * (nu + 1) * np.log1p(z ** 2 / nu).sum())
        return float(joint - indep + marg)

    return fn


def host_copula_quantiles(p, x, y, xq):
    """The CGP's latent posterior at ``xq`` pushed through the Normal
    marginal's ppf at 97.5% and 2.5%, in float64."""
    import scipy.linalg
    from scipy import special, stats

    lo, hi = float(np.float32(1e-6)), float(np.float32(1.0) - np.float32(1e-6))
    mu, sd = p["M_Bias"], abs(p["S_Bias"])
    z = special.ndtri(np.clip(stats.norm.cdf((y - mu) / sd), lo, hi))
    n, diag = len(x), p["SE_var"] + p["Noise_var"]
    chol = host_factor((host_se(x, x, p["SE_rate"], p["SE_var"])
                        + p["Noise_var"] * np.eye(n)) / diag)
    cross = host_se(xq, x, p["SE_rate"], p["SE_var"]) / diag
    loc = cross @ scipy.linalg.cho_solve((chol, True), z)
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    lsd = np.sqrt(np.maximum(1.0 - (v * v).sum(axis=0), 0.0))
    out = {}
    for key, q in (("quantile_up", 0.975), ("quantile_down", 0.025)):
        u = np.clip(stats.norm.cdf(loc + float(np.float32(stats.norm.ppf(q))) * lsd), 1e-6,
                    1 - 1e-6)
        out[key] = stats.norm.ppf(u, mu, sd)
    return out


def phase8d(x, y_pos, y, path):
    """CGP and CSTP(SE, Normal(Bias, Bias)) at n=4096 on y > 0: logp/dlogp
    against the float64 host, the CGP's quantiles against the host latent
    posterior, find_MAP on the CGP; then MP(StudentT) at n=4096, its logp
    against scipy.stats.t and betainc against scipy.special.betainc, with no
    kernel launch."""
    from scipy import special, stats

    x64, yp64 = x.astype(np.float64), y_pos.astype(np.float64)
    out = {}
    for cls, label in ((g3t.CGP, "CGP"), (g3t.CSTP, "CSTP")):
        proc = cls(space=x[:4], kernel=g3t.SE(x), marginal=g3t.Normal(
            mu=g3t.Bias(x, name="M"), sigma=g3t.Bias(x, name="S")), name=f"SMOKE_{label}")
        proc.observed(x, y_pos)
        u = proc.active.dict_to_array(proc.params_default)
        zero_counts()
        t_eval = timed_eval(proc, u)
        k1, k2, _ = launches()
        require(k1 > 0 and k2 > 0, f"{label} logp/dlogp: K1 x{k1}, K2 x{k2}")
        family_launches(f"{label} logp+dlogp", path, k1, k2)
        gaps = directional_check(proc, host_copula_logp(proc.active, x64, yp64, label == "CSTP"),
                                 u, f"{label} n={len(x)}", 87)
        out[label] = dict(logp_dlogp_ms=t_eval, gaps=gaps)
        if label != "CGP":
            continue
        xq = np.random.default_rng(88).standard_normal((256, 8)).astype(np.float32)
        zero_counts()
        t0 = time.perf_counter()
        got = proc.predict(space=xq, mean=False, std=False, quantiles=True)
        torch.cuda.synchronize()
        t_q = (time.perf_counter() - t0) * 1e3
        k1, k2, _ = launches()
        family_launches("CGP quantiles", path, k1, k2)
        ref = host_copula_quantiles(host_params(proc.active, u), x64, yp64, xq.astype(np.float64))
        gap = stat_gap(got, ref)
        print(f"  CGP quantiles at m=256: {t_q:.1f} ms; vs the float64 host "
              + ", ".join(f"{k}={g:.3e}" for k, g in gap.items()), flush=True)
        require(max(gap.values()) <= 1e-3, f"CGP quantiles vs host: {gap}")
        zero_counts()
        before = proc.logp(u, array=True)
        t0 = time.perf_counter()
        cmap = proc.find_MAP(points=1, powell=False, display=False)
        t_fit = time.perf_counter() - t0
        after = proc.logp(cmap)
        k1, k2, _ = launches()
        family_launches("CGP find_MAP", path, k1, k2)
        print(f"  CGP find_MAP: logp {before:.4f} -> {after:.4f} in {t_fit:.2f} s", flush=True)
        require(after > before, f"CGP find_MAP did not raise logp ({before} -> {after})")
        out[label].update(quantiles_ms=t_q, quantile_gap=max(gap.values()), fit_s=t_fit)

    mp = g3t.MP(space=x[:4], density=g3t.StudentT(mu=g3t.Bias(x, name="M"),
                                                  sigma=g3t.Bias(x, name="S"),
                                                  nu=g3t.Bias(x, name="N")), name="SMOKE_MP")
    mp.observed(x, y)
    params = {"SMOKE_MP_M_Bias": 0.1, "SMOKE_MP_S_Bias": 0.8, "SMOKE_MP_N_Bias": 5.0}
    y64 = y.astype(np.float64)
    rng = np.random.default_rng(89)
    a, b, xb = rng.uniform(0.5, 40.0, 4096), rng.uniform(0.2, 6.0, 4096), rng.uniform(0, 1, 4096)
    args = [torch.as_tensor(v, dtype=torch.float32, device=g3t.settings.device)
            for v in (a, b, xb)]
    g3t.betainc(*args)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    lp = mp.logp(params)
    cdf = mp.f_density.cdf({k: torch.tensor(v, device=g3t.settings.device)
                            for k, v in params.items()},
                           mp._device_data("inputs"), mp._device_data("outputs"))
    ib = g3t.betainc(*args)
    torch.cuda.synchronize()
    t_mp = (time.perf_counter() - t0) * 1e3
    k1, k2, _ = launches()
    ref_lp = stats.t.logpdf(y64, 5.0, 0.1, 0.8).sum()
    # scipy in float64 on the float32 inputs (its float32 loop rounds inside)
    ib_ref = special.betainc(*[v.astype(np.float32).astype(np.float64) for v in (a, b, xb)])
    gaps = {"logp": abs(lp - ref_lp) / abs(ref_lp),
            "cdf": float(np.abs(cdf.double().cpu().numpy()
                                - stats.t.cdf(y64, 5.0, 0.1, 0.8)).max()),
            "betainc": float(np.abs(ib.double().cpu().numpy() - ib_ref).max())}
    t_ib = event_ms(lambda: g3t.betainc(*args), reps=5, warmup=1)
    # the continued fraction itself: float64 on the card against scipy
    ib64 = g3t.betainc(*[t.double() for t in args]).cpu().numpy()
    gaps["betainc_f64"] = float(np.abs(ib64 - ib_ref).max())
    print(f"  MP(StudentT) n={len(x)}: logp {lp:.4f} vs scipy {ref_lp:.4f}; logp + cdf + betainc "
          f"{t_mp:.1f} ms (betainc alone {t_ib:.3f} ms, events); K1 x{k1}, K2 x{k2}; gaps "
          + ", ".join(f"{k}={g:.3e}" for k, g in gaps.items()), flush=True)
    require(k1 == 0 and k2 == 0, f"MP launched K1 x{k1}, K2 x{k2}: it runs no kernel")
    # values in [0, 1]: PERF.md's 1e-3 relative to the largest value, on the
    # float32 CDF and betainc; float64 betainc to 1e-12
    require(gaps["logp"] <= 1e-3 and gaps["cdf"] <= 1e-3 and gaps["betainc"] <= 1e-3
            and gaps["betainc_f64"] <= 1e-12, f"MP vs scipy: {gaps}")
    out["MP"] = dict(ms=t_mp, betainc_ms=t_ib, gaps=gaps)
    return out


def phase8e(path_batched):
    """The Student-t Bayesian path: TP(Bias, SE) at n=125 on bench.py:705-714's
    data, 32 walkers x 400 through sample_hypers (one batched K1 and one
    batched K2 call a half-ensemble); every final walker inside the prior's
    support against the float64 host logp; the averaged predictor over 16
    rows against 16 single Predictors in float64."""
    x, y = bench_wgp_data()
    tp = g3t.TP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="SMOKE_BTP")
    tp.observed(x, y)
    start = tp.params_default
    chains, iters = 32, 400
    tp.sample_hypers(start=start, samples=5, chains=chains, noise_mult=0.05, seed=1)  # warm-up
    with counted_calls(tp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain, lnprob = tp.sample_hypers(start=start, samples=iters, chains=chains,
                                         noise_mult=0.05, seed=2, raw=True)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    print(f"  TP n=125, {chains} walkers x {iters}: sample_hypers {t_s:.3f} s; {len(calls)} "
          f"batched logp calls; K1 x{k1}, K2 x{k2} ({retries} jitter retries)", flush=True)
    require(len(calls) == 1 + 2 * iters and k1 == len(calls) and k2 - retries == len(calls),
            f"TP sampler: K1 x{k1}, K2 x{k2} - {retries} on {len(calls)} batched calls, "
            f"expected {1 + 2 * iters}")
    path_batched[0] += k1
    path_batched[1] += k2
    require(np.isfinite(chain).all() and np.isfinite(lnprob).all(), "TP chain not finite")
    final = chain[:, -1, :]
    final_lp = tp.logp_chain(final)
    inside = [w for w in range(chains) if final_lp[w] > -1e29]
    # The degree is flat in log space and wanders to nu ~ 1e5-1e16: below
    # the gaussian switch at 1e6 the normalization's lgamma difference
    # cancels in float32 (lgamma(nu/2) ~ 1e6 at nu ~ 1e5).  Each walker is
    # held to the larger of 1e-3 and 4x a float32 host recomputation's gap.
    gaps, limits = [], []
    nus = [2.0 + float(host_params(tp.active, final[w])["Freedom_degree"]) for w in inside]
    for w in inside:
        ref = host_tp_value(tp.active, final[w], x, y)
        witness = abs(host_tp_value(tp.active, final[w], x, y, np.float32) - ref)
        gaps.append(abs(final_lp[w] - ref) / max(1.0, abs(ref)))
        limits.append(max(1e-3, 4 * witness / max(1.0, abs(ref))))
    worst = int(np.argmax(np.asarray(gaps) / np.asarray(limits)))
    print(f"  final walkers: {len(inside)} of {chains} inside the prior's support; lnprob vs "
          f"the float64 host logp max gap {max(gaps):.3e} (the worst walker {gaps[worst]:.3e} "
          f"against its limit {limits[worst]:.3e}; nu from {min(nus):.3g} to {max(nus):.3g})",
          flush=True)
    require(len(inside) >= chains // 2 and all(g <= lim for g, lim in zip(gaps, limits)),
            f"TP final walkers vs host: {len(inside)} inside, gaps {gaps}, limits {limits}")

    queries = [np.random.default_rng(90 + i).standard_normal((256, 8)).astype(np.float32)
               for i in range(4)]
    dtb = g3t.chains_to_datatrace(tp, chain, ll=lnprob, burnin_tol=None)
    zero_counts()
    t0 = time.perf_counter()
    ap = tp.averaged_predictor(dtb, max_rows=16)
    outs = [ap(xq, quantiles=True) for xq in queries]
    torch.cuda.synchronize()
    t_ap = (time.perf_counter() - t0) * 1e3
    k1, k2, _ = launches()
    path_batched[0] += k1
    path_batched[1] += k2
    require(all(finite(o[k]) for o in outs for k in o), "TP averaged predictor not finite")
    g3t.settings.floatx = "float64"
    try:
        ap64 = tp.averaged_predictor(dtb, max_rows=16)
        singles = [tp.predictor({k: v[i] for k, v in ap64.params.items()})
                   for i in range(len(ap64.rows))]
        machinery = 0.0
        for xq in queries:
            got = on_card(ap64(xq, quantiles=True))
            refs = [on_card(pr(xq, quantiles=True)) for pr in singles]
            for key in ("mean", "std"):
                avg = torch.stack([r[key] for r in refs]).mean(dim=0)
                machinery = max(machinery, float((got[key] - avg).abs().max() / avg.abs().max()))
    finally:
        g3t.settings.floatx = "float32"
    print(f"  TP averaged predictor, 16 rows: set-up + 4 batches of 256 {t_ap:.1f} ms, K1 x{k1}, "
          f"K2 x{k2}; vs 16 single Predictors (float64) {machinery:.3e}", flush=True)
    require(machinery <= 1e-4, f"TP averaged predictor vs single Predictors {machinery:.3e}")
    return dict(sampler_s=t_s, calls=len(calls), inside=len(inside), walker_gap=max(gaps),
                averaged_ms=t_ap, averaged_gap=machinery)


def phase8(x, y, path, path_batched):
    """Phase 8's runs; the single-matrix launches of 8a-8d go to ``path``,
    the batched ones of 8e to ``path_batched``."""
    y_pos = (np.abs(np.sin(x[:, 0])) + 0.5
             + 0.1 * np.random.default_rng(80).standard_normal(len(x))).astype(np.float32)
    out = {}
    for key, run in (("TP", lambda p: phase8a(x, y, p)), ("WTP", lambda p: phase8b(x, y_pos, p)),
                     ("TGP", lambda p: phase8c(x, y, p)),
                     ("copula", lambda p: phase8d(x, y_pos, y, p))):
        print(f"phase 8{'abcd'[len(out)]}: {key}", flush=True)
        t0 = time.perf_counter()
        fam = [0, 0]
        out[key] = run(fam)
        print(f"  phase 8{'abcd'[len(out) - 1]} wall {time.perf_counter() - t0:.1f} s; launches "
              f"K1 {fam[0]}, K2 {fam[1]}", flush=True)
        path[0] += fam[0]
        path[1] += fam[1]
    print("phase 8e: the Student-t Bayesian path, TP(Bias, SE) n=125", flush=True)
    t0 = time.perf_counter()
    out["bayes"] = phase8e(path_batched)
    print(f"  phase 8e wall {time.perf_counter() - t0:.1f} s", flush=True)
    return out



# ---------------------------------------------------------------- phase 9
# The rest of the hypers catalogue at full width (phase 5's n=4096, d=8
# data): a composite GP of tutorial 03's algebra (9a), the kernel zoo and
# every metric (9b), tutorial 08's two processes sharing one rate in the
# active registry (9c), the composite over sampler rows (9d) and the rest of
# the warpings (9e).  The host side walks the port's component tree and
# recomputes every factor by its own formula, in float64 torch tensors on
# the CPU (float32 for the rounding witness); it calls no port code.
KERNELS_9B = ["SE", "OU", "RQ", "MAT32", "MAT52", "WN", "BW", "VAR", "NIL", "LIN", "POL", "NN",
              "COS", "SIN", "SINC", "SM", "KernelNoise"]  # tests/test_zoo.py KERNELS
K1_FAMILIES = ("SE", "RQ", "MAT32", "MAT52")
DISTANCE_METRICS = ("ARD_L2", "ARD_L1", "L1", "L2", "PSD_L2")  # under SE
DOT_METRICS = ("ARD_Dot", "ARD_DotBias", "PSD_Dot")  # under KernelDot
MAPPINGS_9E = ("LinearMapping", "LogShifted", "BoxCoxShifted", "BoxCoxLinear2", "SinhArcsinh",
               "Logistic", "WarpingBoxCox", "MappingInvSum")
INV_ONLY_9E = ("WarpingBoxCox", "MappingInvSum")


def host_values(reg, u):
    """Natural-space float64 values at the unconstrained vector ``u``, keyed
    by the full Param name."""
    out, start = {}, 0
    for par in reg.ordered_params:
        seg = np.asarray(u[start:start + par.size], np.float64).reshape(par.shape)
        out[par.name] = np.exp(seg) if par.prior.transform.name == "log" else seg
        start += par.size
    return out


def _hv(h, vals, dtype):
    """A hyper's host value: a Param's from ``vals``, else the constant."""
    v = vals[h.name] if isinstance(h, g3t.Param) else h
    return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype)


def _active(comp, a):
    dims = comp.dims
    if dims is None or (isinstance(dims, slice) and dims == slice(None)):
        return a
    return a[:, dims] if isinstance(dims, slice) else a[:, torch.as_tensor(np.asarray(dims))]


def _per_dim(a, b, fn, reduce=torch.add, init=0.0):
    acc = torch.full((a.shape[0], b.shape[0]), init, dtype=a.dtype)
    for k in range(a.shape[1]):
        acc = reduce(acc, fn(a[:, k, None] - b[None, :, k], k, a[:, k, None], b[None, :, k]))
    return acc


def _sq(a, b):
    """Squared distances by one product on centred inputs (float64 keeps
    the decomposition's cancellation far below the checks' limits)."""
    c = 0.5 * (a.mean(0) + b.mean(0))
    a, b = a - c, b - c
    return torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T, min=0.0)


def host_metric(m, vals, a, b, eq=()):
    """The metric's (N, M) gram, by its definition."""
    name = type(m).__name__
    a, b = _active(m, a), _active(m, b)
    dt = a.dtype

    def hv(h):
        return _hv(h, vals, dt)

    if name == "ARD_L2":
        r = hv(m.rate)
        return 0.5 * _sq(a * r, b * r)
    if name == "L2":
        return 0.5 * _sq(a, b)
    if name == "L1":
        return torch.cdist(a, b, p=1)
    if name == "ARD_L1":
        r = hv(m.rate)
        return torch.cdist(a * r, b * r, p=1)
    if name in ("PSD_L2", "PSD_Dot"):
        dirs, r = hv(m.directions), hv(m.rate)
        if name == "PSD_Dot":
            return a @ (dirs.T @ dirs + torch.diag(r * r)) @ b.T
        amap = torch.cat([dirs, torch.diag(r)])
        return 0.5 * _sq(a @ amap.T, b @ amap.T)
    if name in ("ARD_Dot", "ARD_DotBias"):
        r = hv(m.rate)
        g = (a * r) @ (b * r).T
        return g + hv(m.bias) if name == "ARD_DotBias" else g
    if name == "One":
        return torch.ones((a.shape[0], b.shape[0]), dtype=dt)
    if name == "Delta":
        return _per_dim(a, b, lambda d, k, u, v: (u == v).to(dt))
    if name == "Minimum":
        return _per_dim(a, b, lambda d, k, u, v: torch.minimum(u, v), torch.mul, 1.0)
    if name == "DeltaEq":
        return _per_dim(a, b, lambda d, k, u, v: ((u == eq[0]) & (v == eq[0])).to(dt))
    if name == "DeltaEq2":
        return _per_dim(a, b, lambda d, k, u, v: ((u == eq[0]) & (v == eq[1])).to(dt)
                        + ((u == eq[1]) & (v == eq[0])).to(dt))
    raise ValueError(f"host: no metric {name}")


def host_cov(k, vals, a, b=None):
    """The kernel's gram (square when ``b`` is None), each factor by its
    definition."""
    name = type(k).__name__
    same = b is None
    bb = a if same else b
    dt = a.dtype

    def hv(h):
        return _hv(h, vals, dt)

    parts = {"KernelSum": torch.add, "KernelProd": torch.mul, "KernelMax": torch.maximum}
    if name in parts:
        return parts[name](host_cov(k.k1, vals, a, b), host_cov(k.k2, vals, a, b))
    if name == "KernelScale":
        return hv(k.element) * host_cov(k.k_inner, vals, a, b)
    if name == "KernelShift":
        return hv(k.element) + host_cov(k.k_inner, vals, a, b)
    if name in ("KernelNoise", "WN"):
        if same:
            return hv(k.var) * torch.eye(a.shape[0], dtype=dt)
        if name == "KernelNoise":
            return torch.zeros((a.shape[0], b.shape[0]), dtype=dt)
        return hv(k.var) * host_metric(k.metric, vals, a, b)
    if name == "KernelEquals":
        return host_metric(k.metric, vals, a, bb, (k.eq,))
    if name == "KernelEquals2":
        return host_metric(k.metric, vals, a, bb, (k.eq1, k.eq2))
    if name in ("COS", "SIN", "SINC", "SM"):
        s1, s2 = _active(k.metric, a), _active(k.metric, bb)
        f = hv(k.freq)
        if name == "SIN":
            # sum_j r_j sin^2(pi f_j (a_j - b_j)) = sum_j r_j / 2
            #   - (cos(2 pi f a) diag(r) cos(2 pi f b)' + the same of sin) / 2
            r = hv(k.rate)
            p1, p2 = 2 * np.pi * f * s1, 2 * np.pi * f * s2
            cross = (torch.cos(p1) * r) @ torch.cos(p2).T + (torch.sin(p1) * r) @ torch.sin(p2).T
            return hv(k.var) * torch.exp(-2.0 * (0.5 * r.sum() - 0.5 * cross))
        cosp = _per_dim(s1, s2, lambda d, j, u, v: torch.cos(2 * np.pi * d * f[j]),
                        torch.mul, 1.0)
        if name == "COS":
            return hv(k.var) * cosp
        if name == "SM":
            r = hv(k.rate)
            return hv(k.var) * torch.exp(-2 * np.pi ** 2 * _sq(s1 * r, s2 * r)) * cosp
        arg = lambda d, j: 2 * np.pi ** 2 * d * f[j]  # noqa: E731
        sinc = _per_dim(s1, s2, lambda d, j, u, v: torch.where(
            d != 0, torch.sin(arg(d, j)) / torch.where(d != 0, arg(d, j), 1.0), 1.0),
            torch.mul, 1.0)
        return hv(k.var) * sinc
    g = host_metric(k.metric, vals, a, bb)
    if name == "VAR":
        return hv(k.var) * torch.ones_like(g)
    if name == "NIL":
        return torch.zeros_like(g)
    if name in ("KernelDot", "BW", "LIN"):
        return hv(k.var) * g
    if name == "POL":
        return hv(k.var) * g ** k.p
    if name == "NN":
        r, bias = hv(k.metric.rate), hv(k.metric.bias)
        d1 = bias + ((_active(k.metric, a) * r) ** 2).sum(1)
        d2 = bias + ((_active(k.metric, bb) * r) ** 2).sum(1)
        arg = 2 * g / torch.sqrt((1 + 2 * d1)[:, None] * (1 + 2 * d2)[None, :])
        return hv(k.var) * torch.arcsin(torch.clamp(arg, -1.0, 1.0))
    if name in ("SE", "OU", "KernelStationaryExponential"):
        return hv(k.var) * torch.exp(-g)
    if name in ("MAT32", "MAT52"):
        c = 3.0 if name == "MAT32" else 5.0
        s = torch.sqrt(c * g)
        return hv(k.var) * (1 + s + (5 * g / 3 if name == "MAT52" else 0)) * torch.exp(-s)
    if name == "RQ":
        alpha = hv(k.alpha)
        return hv(k.var) * (1 + g / alpha) ** -alpha
    raise ValueError(f"host: no kernel {name}")


def host_mean(m, vals, a):
    name = type(m).__name__
    dt = a.dtype

    def hv(h):
        return _hv(h, vals, dt)

    if name in ("MeanSum", "MeanProd"):
        op = torch.add if name == "MeanSum" else torch.mul
        return op(host_mean(m.m1, vals, a), host_mean(m.m2, vals, a))
    if name in ("MeanScale", "MeanShift"):
        op = torch.mul if name == "MeanScale" else torch.add
        return op(hv(m.element), host_mean(m.m, vals, a))
    a = _active(m, a)
    if name == "Zero":
        return torch.zeros(a.shape[0], dtype=dt)
    if name == "Bias":
        return hv(m.bias) * torch.ones(a.shape[0], dtype=dt)
    if name == "Linear":
        return hv(m.constant) + a @ hv(m.coeff)
    if name == "Power":
        return hv(m.constant) + (a ** m.n) @ hv(m.coeff)
    raise ValueError(f"host: no mean {name}")


def host_mapping(t, vals, y):
    """(T^-1(y), dT^-1/dy) of a warping, both elementwise, by their closed
    forms."""
    name = type(t).__name__
    dt = y.dtype

    def hv(h):
        return _hv(h, vals, dt)

    def signed(z, p):
        return torch.sign(z) * z.abs() ** p

    if name == "Identity":
        return y, torch.ones_like(y)
    if name == "MappingInvSum":
        (i1, d1), (i2, d2) = host_mapping(t.m1, vals, y), host_mapping(t.m2, vals, y)
        return i1 + i2, d1 + d2
    if name == "LinearMapping":
        s = hv(t.scale)
        return y / s + hv(t.shift), torch.ones_like(y) / s
    if name == "LogShifted":
        z = y - hv(t.shift)
        return torch.log(z), 1 / z
    if name in ("BoxCoxShifted", "BoxCoxLinear2"):
        p = hv(t.power)
        s = hv(t.scale) if name == "BoxCoxLinear2" else torch.ones((), dtype=dt)
        z = s * y + hv(t.shift)
        return (signed(z, p) - 1) / p, s * z.abs() ** (p - 1)
    if name == "SinhArcsinh":
        s = hv(t.scale)
        inner = hv(t.shift) + s * torch.arcsinh(y)
        return torch.sinh(inner), torch.cosh(inner) * s / torch.sqrt(1 + y * y)
    if name == "Logistic":
        p = (y - hv(t.lower)) / hv(t.high)
        s = hv(t.scale)
        return hv(t.location) + s * torch.log(p / (1 - p)), s / (hv(t.high) * p * (1 - p))
    if name == "WarpingBoxCox":
        z = y[:, None] + hv(t.shift)
        p, w = hv(t.power), hv(t.w)
        return ((signed(z, p) - 1) / p) @ w, (z.abs() ** (p - 1)) @ w
    if name == "WarpingTanh":
        a, b, c = hv(t.a), hv(t.b), hv(t.c)
        th = torch.tanh(b * (y[:, None] + c))
        return y + th @ a, 1 + (1 - th * th) @ (a * b)
    raise ValueError(f"host: no mapping {name}")


def host_gp_logp(proc, vals, x, y, chol=None):
    """The GP/WGP log density at ``vals`` (its priors are 0 inside their
    support): Cholesky of the noisy gram (or the given one), the warped
    residual, the log-Jacobian."""
    if chol is None:
        chol = torch.linalg.cholesky(host_cov(proc.f_kernel_noise, vals, x))
    latent, slope = host_mapping(proc.f_mapping, vals, y)
    resid = latent - host_mean(proc.f_location, vals, x)
    w = torch.linalg.solve_triangular(chol, resid[:, None], upper=False)[:, 0]
    return float(-0.5 * w @ w - torch.log(torch.diagonal(chol)).sum()
                 - 0.5 * len(y) * np.log(2 * np.pi) + torch.log(slope).sum())


def host_logp_fn(proc, x, y, dtype=torch.float64):
    """``u -> logp`` on the host, in ``dtype`` arithmetic."""
    xt = torch.as_tensor(x.astype(np.float64), dtype=dtype)
    yt = torch.as_tensor(y.astype(np.float64), dtype=dtype)
    return lambda u: host_gp_logp(proc, host_values(proc.active, u), xt, yt)


def held(gap, limit, witness_fn, label, witness="float32 host witness"):
    """``gap`` within ``limit``, or within 4x a float32 witness's gap (the
    host's unless ``witness`` names another) where float32 rounding alone
    goes beyond the limit (cond(K) high): ``witness_fn`` is only run then.
    Returns the limit applied."""
    if gap > limit:
        limit = max(limit, WITNESS_FACTOR * witness_fn())
        print(f"    {label}: {witness} sets the limit to {limit:.3e}", flush=True)
    require(gap <= limit, f"{label}: gap {gap:.3e} > {limit:.3e}")
    return limit


def composite_9a(lib, x, name):
    """GP(Linear + Bias, SE * SIN + 2 MAT52 + LIN + 0.1): tutorial 03's
    algebra, two K1 factors (SE, MAT52) in every gram."""
    return lib.GP(space=x[:4], location=lib.Linear(x) + lib.Bias(),
                  kernel=lib.SE(x) * lib.SIN(x) + 2.0 * lib.MAT52(x) + lib.LIN(x) + 0.1,
                  name=name)


def counted_eval(proc, u, want, label):
    """One logp and one dlogp, each launching exactly ``want`` = (K1, K2)."""
    for what, fn in (("logp", lambda: proc.logp(u, array=True)), ("dlogp", lambda: proc.dlogp(u))):
        zero_counts()
        fn()
        k1, k2, retries = launches()
        require((k1, k2 - retries) == want,
                f"{label} {what}: K1 x{k1}, K2 x{k2} ({retries} retries), expected {want}")


def phase9a(x, y, path):
    """The composite GP at n=4096: logp and dlogp (two K1 launches and one
    K2 each) against the float64 host, find_MAP, 8 Predictor batches of 256
    from the MAP, batch 0 against the host posterior."""
    gp = composite_9a(g3t, x, "SMOKE_CMP")
    gp.observed(x, y)
    reg = gp.active
    u = reg.dict_to_array(gp.params_default)
    counted_eval(gp, u, (2, 1), "9a")
    zero_counts()
    t_eval = timed_eval(gp, u)
    family_launches("9a logp+dlogp (3 pairs)", path, *launches()[:2])
    host = host_logp_fn(gp, x, y)
    val, grad = gp.logp(u, array=True), gp.dlogp(u).astype(np.float64)
    ref = host(np.asarray(u, np.float64))
    gaps = {"logp": abs(val - ref) / abs(ref)}
    dirs = np.random.default_rng(91).standard_normal((1, reg.ndim))
    u64, h = np.asarray(u, np.float64), 1e-4
    for i, v in enumerate(dirs / np.linalg.norm(dirs, axis=1, keepdims=True)):
        fd = (host(u64 + h * v) - host(u64 - h * v)) / (2 * h)
        gaps[f"dlogp_dir{i}"] = abs(grad @ v - fd) / max(abs(fd), 1e-3 * np.linalg.norm(grad))
    witness32 = host_logp_fn(gp, x, y, torch.float32)
    held(gaps["logp"], 1e-3, lambda: abs(witness32(u64) - ref) / abs(ref), "9a logp")
    require(all(g <= 1e-2 for k, g in gaps.items() if k != "logp"), f"9a dlogp: {gaps}")
    print(f"  9a composite n={len(x)}: logp {val:.4f} vs host {ref:.4f}; logp+dlogp median "
          f"{t_eval:.2f} ms; gaps " + ", ".join(f"{k}={g:.3e}" for k, g in gaps.items()),
          flush=True)
    t_dev = top_ops(profile(lambda: (gp.logp(u, array=True), gp.dlogp(u))),
                    f"9a composite n={len(x)} logp+dlogp", count=10)
    print(f"    device {t_dev:.2f} ms of a {t_eval:.2f} ms pair: idle share "
          f"{max(0.0, 1 - t_dev / t_eval):.2f}", flush=True)

    zero_counts()
    before = gp.logp(u, array=True)
    t0 = time.perf_counter()
    gp_map = gp.find_MAP(points=1, powell=False, display=False)
    t_fit = time.perf_counter() - t0
    after = gp.logp(gp_map)
    family_launches("9a find_MAP", path, *launches()[:2])
    print(f"  9a find_MAP: logp {before:.4f} -> {after:.4f} in {t_fit:.2f} s; noise variance "
          f"{float(gp_map['SMOKE_CMP_Noise_var']):.4g}, LIN bias "
          f"{float(gp_map['SMOKE_CMP_LIN_bias']):.4g} at the MAP", flush=True)
    require(after > before, f"9a find_MAP did not raise logp ({before} -> {after})")

    queries = [np.random.default_rng(92 + i).standard_normal((256, 8)).astype(np.float32)
               for i in range(8)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    pr = gp.predictor(gp_map)
    torch.cuda.synchronize()
    t_setup = (time.perf_counter() - t0) * 1e3
    times, outs = [], []
    for xq in queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(pr(xq, quantiles=True))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k1, k2, _ = launches()
    family_launches("9a Predictor set-up + 8 batches", path, k1, k2)
    require(k1 == 2 * (1 + 2 * len(queries)) and all(finite(o[k]) for o in outs for k in o),
            f"9a Predictor: K1 x{k1} (2 per gram), outputs finite")

    def posterior(dtype):
        vals = host_values(reg, reg.dict_to_array(gp_map))
        xt, yt, qt = (torch.as_tensor(a.astype(np.float64), dtype=dtype)
                      for a in (x, y, queries[0]))
        chol = torch.linalg.cholesky(host_cov(gp.f_kernel_noise, vals, xt))
        resid = yt - host_mean(gp.f_location, vals, xt)
        cross = host_cov(gp.f_kernel, vals, qt, xt)
        alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
        v = torch.linalg.solve_triangular(chol, cross.T, upper=False)
        var = torch.diagonal(host_cov(gp.f_kernel, vals, qt)) - (v * v).sum(0)
        return {"mean": (host_mean(gp.f_location, vals, qt) + cross @ alpha).double().numpy(),
                "std": torch.sqrt(torch.clamp(var, min=0.0)).double().numpy()}

    # at the MAP the noise is small beside the constant and LIN terms
    # (cond(K) ~ 1e6-1e7), where float32 rounding alone moves the posterior:
    # the float32 batch is held to the float32 host witness, and the same
    # Predictor in float64 on the card to the float64 host at 1e-5 (the
    # host's own float64 rounding times cond(K) stays below 1e-8)
    ref_post = posterior(torch.float64)
    gap = stat_gap({k: outs[0][k] for k in ref_post}, ref_post)
    worst = max(gap.values())
    held(worst, 1e-3, lambda: max(stat_gap({k: torch.as_tensor(v) for k, v in
                                            posterior(torch.float32).items()}, ref_post).values()),
         "9a Predictor at the MAP")
    g3t.settings.floatx = "float64"
    try:
        out64 = gp.predictor(gp_map)(queries[0])
        gap64 = max(stat_gap({k: out64[k] for k in ref_post}, ref_post).values())
    finally:
        g3t.settings.floatx = "float32"
    require(gap64 <= 1e-5, f"9a float64 Predictor at the MAP vs the float64 host: {gap64:.3e}")
    print(f"  9a Predictor at the MAP: set-up {t_setup:.1f} ms; 8 batches of 256 median "
          f"{statistics.median(times):.3f} ms; batch 0 vs the float64 host {gap} (float32), "
          f"{gap64:.3e} (the Predictor in float64)", flush=True)
    return dict(logp_dlogp_ms=t_eval, device_ms=t_dev, gaps=gaps, fit_s=t_fit,
                map_logp=after, setup_ms=t_setup, batch_ms=statistics.median(times),
                predictor_gap=worst, predictor_gap_f64=gap64)


def zoo_9b(x_idx):
    """(label, kernel builder, K1 launches per gram) of phase 9b: every
    kernel of tests/test_zoo.py's KERNELS, every distance metric under SE
    and every dot metric under KernelDot, and the index kernels on an index
    column (KernelEquals2 with both indexes 1, so that the sum stays PSD);
    the Brownian kernel BW runs on |x| (its min-product is a covariance on
    positive inputs only)."""
    x = x_idx[:, :8]
    cases = [(k, (lambda k: lambda: getattr(g3t, k)(x))(k), int(k in K1_FAMILIES))
             for k in KERNELS_9B]
    for m in DISTANCE_METRICS:
        cases.append((f"SE/{m}", (lambda m: lambda: g3t.SE(x, metric=getattr(g3t, m)(
            x, **({"p": 2} if m == "PSD_L2" else {}))))(m), int(m == "ARD_L2")))
    for m in DOT_METRICS:
        cases.append((f"KernelDot/{m}", (lambda m: lambda: g3t.KernelDot(x, metric=getattr(
            g3t, m)(x, **({"p": 2} if m == "PSD_Dot" else {}))))(m), 0))
    cases.append(("KernelMax(SE,OU)", lambda: g3t.KernelMax(g3t.SE(x), g3t.OU(x)), 1))
    cases.append(("Equals*SE+SE", lambda: g3t.KernelEquals([8], eq=1) * g3t.SE(x, name="SEg")
                  + g3t.SE(x), 2))
    cases.append(("Equals2*SE+SE", lambda: g3t.KernelEquals2([8], eq1=1, eq2=1)
                  * g3t.SE(x, name="SEg") + g3t.SE(x), 2))
    return cases


def phase9b(x, y, path):
    """Each case of ``zoo_9b`` in GP(Bias) at n=4096: one logp (K1 launches
    as the case says, one K2) against the float64 host."""
    x_idx = np.concatenate([x, (x[:, :1] > 0).astype(np.float32)], axis=1)
    yt64, y32 = torch.as_tensor(y.astype(np.float64)), torch.as_tensor(y)
    out, checks = {}, []
    for label, build, k1_want in zoo_9b(x_idx):
        xs = np.abs(x_idx) if label == "BW" else x_idx
        gp = g3t.GP(space=xs[:4], location=g3t.Bias(), kernel=build(),
                    name="Z9" + "".join(c for c in label if c.isalnum()))
        gp.observed(xs, y)
        # a PSD metric's directions default to 0, on the wall of their
        # FlatExp prior (the reference's default): take them inside
        params = {k: np.full_like(v, 0.3) if k.endswith("_directions") else v
                  for k, v in gp.params_default.items()}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        val = gp.logp(params)
        t_ms = (time.perf_counter() - t0) * 1e3
        k1, k2, retries = launches()
        path[0] += k1
        path[1] += k2
        vals = {k: np.asarray(v, np.float64) for k, v in params.items()}
        require((k1, k2 - retries) == (k1_want, 1),
                f"9b {label}: K1 x{k1}, K2 x{k2} ({retries} retries), expected ({k1_want}, 1)")
        out[label] = dict(logp=val, ms=t_ms, k1=k1)
        checks.append((label, gp, vals, xs))
    # the float64 host recomputations, on the host's cores at once
    with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
        refs = list(pool.map(lambda c: host_gp_logp(c[1], c[2], torch.as_tensor(
            c[3].astype(np.float64)), yt64), checks))
    for (label, gp, vals, xs), ref in zip(checks, refs):
        gap = abs(out[label]["logp"] - ref) / abs(ref)
        held(gap, 1e-3, lambda: abs(host_gp_logp(gp, vals, torch.as_tensor(xs), y32) - ref)
             / abs(ref), f"9b {label}")
        out[label]["gap"] = gap
    print("  9b zoo at n=4096 (logp vs the float64 host; ms of one logp; K1 launches): "
          + "; ".join(f"{k} {v['gap']:.1e} {v['ms']:.1f}ms K1x{v['k1']}" for k, v in out.items()),
          flush=True)
    return out


def phase9c(x, y, path):
    """Tutorial 08 at n=4096: two GPs with active=True in one registry,
    sharing one ARD_L2 rate Param; a joint logp and a joint dlogp each
    launch K1 x2 and K2 x2; the joint logp against the sum of the two
    float64 host logps; the joint find_MAP."""
    y2 = (0.8 * y + 0.1 + 0.05 * np.random.default_rng(93).standard_normal(len(y))
          ).astype(np.float32)
    g3t.GraphicalModel.active = None
    try:
        shared = g3t.Param("SMOKE_G08_shared_rate", shape=(8,), prior=g3t.FlatExp())
        p1, p2 = (g3t.GP(space=x[:4], location=g3t.Bias(),
                         kernel=g3t.SE(x, metric=g3t.ARD_L2(x, rate=shared)),
                         name=name, active=True) for name in ("SMOKE_F1", "SMOKE_F2"))
        p1.observed(x, y)
        p2.observed(x, y2)
        reg = p1.active
        require(reg is p2.active is g3t.modelcontext() and reg.ndim == 2 * 3 + 8,
                f"9c: one registry of {reg.ndim} dims expected 14")
        start = dict(p1.params_default)
        start["SMOKE_G08_shared_rate"] = np.full(8, 0.5, np.float32)
        u = reg.dict_to_array(start)
        counted_eval(p1, u, (2, 2), "9c joint")
        zero_counts()
        t_eval = timed_eval(p1, u)
        family_launches("9c joint logp+dlogp (3 pairs)", path, *launches()[:2])
        vals = host_values(reg, np.asarray(u, np.float64))
        xt = torch.as_tensor(x.astype(np.float64))
        ref = sum(host_gp_logp(p, vals, xt, torch.as_tensor(yy.astype(np.float64)))
                  for p, yy in ((p1, y), (p2, y2)))
        val = p1.logp(u, array=True)
        gap = abs(val - ref) / abs(ref)
        require(gap <= 1e-3, f"9c joint logp {val} vs the host sum {ref}")
        zero_counts()
        t0 = time.perf_counter()
        gmap = p1.find_MAP(start=start, points=1, powell=False, display=False)
        t_fit = time.perf_counter() - t0
        after = p1.logp(gmap)
        family_launches("9c joint find_MAP", path, *launches()[:2])
        require(after > val, f"9c joint find_MAP did not raise logp ({val} -> {after})")
        print(f"  9c tutorial 08 n={len(x)} x 2: joint logp {val:.4f} vs the two host logps "
              f"{ref:.4f} (gap {gap:.3e}); logp+dlogp median {t_eval:.2f} ms; find_MAP "
              f"{val:.4f} -> {after:.4f} in {t_fit:.2f} s; shared rate at the MAP "
              f"{np.round(np.asarray(gmap['SMOKE_G08_shared_rate']), 3).tolist()}", flush=True)
    finally:
        g3t.GraphicalModel.active = None
    return dict(logp_dlogp_ms=t_eval, gap=gap, fit_s=t_fit, map_logp=after)


def phase9d(path_batched):
    """9a's composite at the n=125 sampler data: 32 walkers x 50 through
    sample_hypers, two batched K1 and one batched K2 a batched call; the
    final walkers inside the prior's support against the float64 host."""
    x, y = bench_wgp_data()
    gp = composite_9a(g3t, x, "SMOKE_BCMP")
    gp.observed(x, y)
    start = gp.params_default
    chains, iters = 32, 50
    gp.sample_hypers(start=start, samples=3, chains=chains, noise_mult=0.05, seed=1)  # warm-up
    with counted_calls(gp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain, lnprob = gp.sample_hypers(start=start, samples=iters, chains=chains,
                                         noise_mult=0.05, seed=2, raw=True)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    require(len(calls) == 1 + 2 * iters and k1 == 2 * len(calls)
            and k2 - retries == len(calls),
            f"9d: K1 x{k1}, K2 x{k2} - {retries} on {len(calls)} batched calls")
    path_batched[0] += k1
    path_batched[1] += k2
    require(np.isfinite(chain).all() and np.isfinite(lnprob).all(), "9d chain not finite")
    final = chain[:, -1, :]
    final_lp = gp.logp_chain(final)
    host = host_logp_fn(gp, x, y)
    witness = host_logp_fn(gp, x, y, torch.float32)
    inside = [w for w in range(chains) if final_lp[w] > -1e29]
    gaps, limits = [], []
    for w in inside:
        ref = host(final[w])
        scale = max(1.0, abs(ref))
        gaps.append(abs(final_lp[w] - ref) / scale)
        limits.append(max(1e-3, WITNESS_FACTOR * abs(witness(final[w]) - ref) / scale))
    print(f"  9d composite n=125, {chains} walkers x {iters}: sample_hypers {t_s:.3f} s; "
          f"{len(calls)} batched calls, K1 x{k1}, K2 x{k2} ({retries} retries); {len(inside)} "
          f"final walkers inside the support, lnprob vs the float64 host max gap "
          f"{max(gaps):.3e}", flush=True)
    require(len(inside) >= chains // 2 and all(g <= lim for g, lim in zip(gaps, limits)),
            f"9d final walkers vs host: {len(inside)} inside, gaps {gaps}, limits {limits}")
    return dict(sampler_s=t_s, calls=len(calls), inside=len(inside), walker_gap=max(gaps))


def mapping_9e(name, y):
    if name == "MappingInvSum":
        return g3t.MappingInvSum(g3t.WarpingTanh(y, name="Tanh"), g3t.LinearMapping(y))
    if name == "WarpingBoxCox":
        return g3t.WarpingBoxCox(y, n=2)
    return getattr(g3t, name)(y)


def phase9e(x, y_pos, path):
    """A WGP(Bias, SE) at n=4096 with each warping of ``MAPPINGS_9E``:
    logp against the float64 host, dlogp along two random directions of
    the warping's and the location's coordinates against central
    differences of the host logp (the kernel's coordinates stay, so one
    host factorization serves them all), and for an inv-only warping a
    Predictor batch of 256 through the Newton inverse: the host's
    T^-1(median) against its float64 latent location."""
    xt = torch.as_tensor(x.astype(np.float64))
    yt = torch.as_tensor(y_pos.astype(np.float64))
    chols = {}
    out = {}
    for name in MAPPINGS_9E:
        wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                      mapping=mapping_9e(name, y_pos), name="SMOKE_M" + name)
        wgp.observed(x, y_pos)
        reg = wgp.active
        u = reg.dict_to_array(wgp.params_default)
        counted_eval(wgp, u, (1, 1), f"9e {name}")
        zero_counts()
        t_eval = timed_eval(wgp, u, reps=2)
        family_launches(f"9e {name} logp+dlogp", path, *launches()[:2])
        kernel_keys = [p.name for p in wgp.f_kernel_noise.hypers]

        def host(uu):
            vals = host_values(reg, uu)
            key = tuple(np.asarray(vals[k]).tobytes() for k in kernel_keys)
            if key not in chols:
                chols[key] = torch.linalg.cholesky(host_cov(wgp.f_kernel_noise, vals, xt))
            return host_gp_logp(wgp, vals, xt, yt, chols[key])

        u64 = np.asarray(u, np.float64)
        val, grad = wgp.logp(u, array=True), wgp.dlogp(u).astype(np.float64)
        ref = host(u64)
        gaps = {"logp": abs(val - ref) / abs(ref)}
        moving = np.array([not any(p.name == k for k in kernel_keys)
                           for p in reg.ordered_params for _ in range(p.size)])
        dirs = np.random.default_rng(94).standard_normal((2, reg.ndim)) * moving
        for i, v in enumerate(dirs / np.linalg.norm(dirs, axis=1, keepdims=True)):
            fd = (host(u64 + 1e-4 * v) - host(u64 - 1e-4 * v)) / 2e-4
            gaps[f"dlogp_dir{i}"] = abs(grad @ v - fd) / max(abs(fd), 1e-3 * np.linalg.norm(grad))
        require(gaps["logp"] <= 1e-3 and all(g <= 1e-2 for k, g in gaps.items() if k != "logp"),
                f"9e {name} vs the float64 host: {gaps}")
        rec = dict(logp_dlogp_ms=t_eval, gaps=gaps)
        if name in INV_ONLY_9E:
            xq = np.random.default_rng(95).standard_normal((256, 8)).astype(np.float32)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            pr = wgp.predictor()
            got = pr(xq, median=True, quantiles=True)
            torch.cuda.synchronize()
            t_batch = (time.perf_counter() - t0) * 1e3
            family_launches(f"9e {name} Predictor set-up + batch", path, *launches()[:2])
            vals = host_values(reg, u64)
            chol = chols[tuple(np.asarray(vals[k]).tobytes() for k in kernel_keys)]
            qt = torch.as_tensor(xq.astype(np.float64))
            latent, _ = host_mapping(wgp.f_mapping, vals, yt)
            resid = latent - host_mean(wgp.f_location, vals, xt)
            loc = (host_mean(wgp.f_location, vals, qt) + host_cov(wgp.f_kernel, vals, qt, xt)
                   @ torch.cholesky_solve(resid[:, None], chol)[:, 0])
            back, _ = host_mapping(wgp.f_mapping, vals, torch.as_tensor(host64(got["median"])))
            rec["newton_gap"] = float((back - loc).abs().max() / loc.abs().max())
            rec["batch_ms"] = t_batch
            require(all(finite(v) for v in got.values()) and rec["newton_gap"] <= 1e-3,
                    f"9e {name} Predictor: T^-1(median) vs the host location "
                    f"{rec['newton_gap']:.3e}")
        out[name] = rec
        print(f"  9e WGP({name}) n={len(x)}: logp {val:.4f} vs host {ref:.4f}; logp+dlogp "
              f"median {t_eval:.2f} ms; gaps " + ", ".join(f"{k}={g:.3e}" for k, g in gaps.items())
              + (f"; Predictor set-up + a batch of 256 {rec['batch_ms']:.1f} ms, T^-1(median) vs "
                 f"the host location {rec['newton_gap']:.3e}" if "batch_ms" in rec else ""),
              flush=True)
    return out


def k1_algebra_inputs():
    """K1 against its plain version on the inputs the kernel algebra
    reaches, at the main path's shapes (float32; phase 2's tolerance): a
    dims-restricted slice (SE on dims [3] of 8, n=4096), one rate Param
    shared by two factors (SE * MAT52, whose amplitude the product pins to
    a 0-d 1), and a 0-d amplitude beside a (R, d) rate (R=32 walkers at
    n=125, every family).  Returns the largest |K1 - plain| of the single
    grams and of the batched ones."""
    rng = np.random.default_rng(96)
    dev = g3t.settings.device
    x = torch.as_tensor(rng.standard_normal((4096, 8)), dtype=torch.float32, device=dev)
    rates = torch.as_tensor(rng.uniform(0.3, 1.2, (32, 8)), dtype=torch.float32, device=dev)
    shared = g3t.Param("K1A_shared_rate", shape=(8,), prior=g3t.FlatExp())
    k = (g3t.SE([3], name="SEd") + g3t.SE(8, name="SEa", metric=g3t.ARD_L2(8, rate=shared))
         * g3t.MAT52(8, name="Ma", metric=g3t.ARD_L2(8, rate=shared)))
    k.check_hypers("K1A_")
    var = torch.tensor(1.3, device=dev)
    one = torch.ones((), device=dev)
    params = {"K1A_SEd_var": var, "K1A_SEd_rate": rates[0, 3:4], "K1A_SEa_var": var,
              "K1A_shared_rate": rates[1]}
    rtol, atol = TOL[torch.float32]
    checks = [("dims [3] + shared rate", k.cov(params, x),
               _plain_form("se", x[:, 3:4], x[:, 3:4], rates[0, 3:4], var)
               + _plain_form("se", x, x, rates[1], var)
               * _plain_form("mat52", x, x, rates[1], one),
               2 * 1.3, "single")]
    alpha = torch.tensor(0.8, device=dev)
    for kind in sorted(KINDS):
        checks.append((f"{kind} 0-d var, 32 rows", stationary_gram(kind, x[:125], x[:125], rates,
                                                                   one, alpha),
                       _plain_form(kind, x[:125], x[:125], rates, one.expand(32),
                                   alpha.expand(32)), 1.0, "batched"))
    worst = {"single": 0.0, "batched": 0.0}
    for label, got, want, scale, kind in checks:
        torch.cuda.synchronize()
        err = float(((got - want).abs() - rtol * want.abs()).max())
        worst[kind] = max(worst[kind], float((got - want).abs().max()))
        require(err <= atol * scale, f"K1 on {label}: beyond rtol {rtol}, atol {atol} x {scale}")
    print(f"  K1 vs plain on the algebra's inputs ({len(checks)} cases): max |K1 - plain| "
          f"{worst}", flush=True)
    return worst


def phase9(x, y, path, path_batched):
    """Phase 9's runs; the single-matrix launches of 9a-9c and 9e go to
    ``path``, the batched ones of 9d to ``path_batched``."""
    y_pos = (np.abs(np.sin(x[:, 0])) + 0.5
             + 0.1 * np.random.default_rng(80).standard_normal(len(x))).astype(np.float32)
    out = {"k1_algebra_err": k1_algebra_inputs()}
    runs = (("9a", "composite GP", lambda p: phase9a(x, y, p)),
            ("9b", "kernel zoo and metrics", lambda p: phase9b(x, y, p)),
            ("9c", "tutorial 08, shared rate", lambda p: phase9c(x, y, p)),
            ("9d", "composite sampler rows", phase9d),
            ("9e", "warpings", lambda p: phase9e(x, y_pos, p)))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        launched = [0, 0]
        out[key] = run(launched)
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s; launches K1 {launched[0]}, "
              f"K2 {launched[1]}", flush=True)
        target = path_batched if key == "9d" else path
        target[0] += launched[0]
        target[1] += launched[1]
    return out


# ---------------------------------------------------------------- phase 10
# The rest of serving and the device half of the Bayesian toolbox at the
# main path's full width (phase 5's GP(Bias, SE) data and MAP at n=4096,
# d=8; phase 6c's WGP n=125 sampler data): the streaming update, pathwise
# draws, draws over datatrace rows, fix_vars and reparam='noncentered',
# the exported predictor.  Each sub-phase holds its result to a float64
# host recomputation; the launches are counted around its float32 runs.
def map_params(gp_map, name):
    """Phase 5's MAP under another process name."""
    return {k.replace("TRAIN_GP", name): v for k, v in gp_map.items()}


def stat_gaps(got, ref):
    """max |got - ref| / max |ref| for each key of ``ref``."""
    return {k: float(np.abs(host64(got[k]) - ref[k]).max() / np.abs(ref[k]).max())
            for k in ref}


def host_stats(reg, u, x, y, xq, dtype=np.float64):
    """GP(Bias, SE) mean, std and 95% band at ``xq`` in ``dtype``."""
    p = host_params(reg, u, dtype)
    mean, cov, _ = host_posterior(p, x.astype(dtype), y.astype(dtype), xq.astype(dtype))
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    z = 1.959964
    return {"mean": mean, "std": std, "quantile_up": mean + z * std,
            "quantile_down": mean - z * std}


def phase10a(x, y, gp_map, path):
    """Predictor.updated: 3840 points + 256 streamed, against a fresh
    Predictor on all 4096 (float64 on the card at 1e-8) and the float64
    host (float32 within 4x a float32 host witness); K2 once, on the
    256 x 256 block."""
    from g3py_tpu_torch.ops import linalg as tlinalg

    n0, xq = len(x) - 256, np.random.default_rng(100).standard_normal((256, 8)).astype(np.float32)
    flags = dict(mean=True, std=True, quantiles=True)
    out = {}
    shapes = []
    inner = tlinalg.panel_cholesky

    def recorded(a, *args, **kw):
        shapes.append(tuple(a.shape))
        return inner(a, *args, **kw)

    for dtype in ("float64", "float32"):
        g3t.settings.floatx = dtype
        try:
            gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="UPD")
            gp.observed(x[:n0], y[:n0])
            params = map_params(gp_map, "UPD")
            pr = gp.predictor(params)
            torch.cuda.synchronize()
            tlinalg.panel_cholesky = recorded
            shapes.clear()
            with counted(path) if dtype == "float32" else contextlib.nullcontext():
                t0 = time.perf_counter()
                pr2 = pr.updated(x[n0:], y[n0:])
                torch.cuda.synchronize()
                t_up = time.perf_counter() - t0
                got = pr2(xq, **flags)
                torch.cuda.synchronize()
            tlinalg.panel_cholesky = inner
            require(shapes and all(sh[-2:] == (256, 256) for sh in shapes),
                    f"updated factored {shapes}, expected the 256 x 256 block only")
            fresh_gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="UPD")
            fresh_gp.observed(x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh = fresh_gp.predictor(params)
            torch.cuda.synchronize()
            t_fresh = time.perf_counter() - t0
            ref = fresh(xq, **flags)
            gaps = stat_gaps(got, {k: host64(v) for k, v in ref.items()})
            out[dtype] = dict(update_ms=t_up * 1e3, fresh_setup_ms=t_fresh * 1e3,
                              vs_fresh=gaps)
            print(f"  10a {dtype}: update of 256 onto 3840 {t_up * 1e3:.2f} ms, a fresh "
                  f"Predictor on 4096 {t_fresh * 1e3:.2f} ms; gaps to the fresh one {gaps}",
                  flush=True)
            if dtype == "float64":
                require(max(gaps.values()) <= 1e-8, f"10a float64 updated vs fresh {gaps}")
        finally:
            tlinalg.panel_cholesky = inner
            g3t.settings.floatx = "float32"
    reg = gp.active
    u = reg.dict_to_array(params)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    ref64 = host_stats(reg, u, x64, y64, xq)
    got = dict(pr2(xq, **flags))
    gaps = stat_gaps(got, ref64)
    for k, gap in gaps.items():
        held(gap, 1e-3, lambda k=k: stat_gaps(host_stats(reg, u, x, y, xq, np.float32),
                                              ref64)[k], f"10a float32 {k} vs the host")
    out["float32"]["vs_host"] = gaps
    print(f"  10a float32 vs the float64 host: {gaps}", flush=True)
    return out


def host_pathwise(reg, u, x, y, xq, draws, dtype=np.float64):
    """Matheron's update of the injected draws ``draws`` (one SE feature
    block) for GP(Bias, SE) at ``u`` on the host in ``dtype``, with scipy's
    Cholesky and triangular solves: the paths (m, S), and in float64 also
    the paths' standard deviation given the features (over the weights
    theta and the noise eps; the mean given the features is the posterior
    mean), sqrt(|B_i|^2 + s2 |c_i|^2) with c = K_sX (K + s2 I)^{-1} and
    B = Phi_s - c Phi_X."""
    import scipy.linalg

    p = host_params(reg, u, dtype)
    x, y, xq = x.astype(dtype), y.astype(dtype), xq.astype(dtype)
    part = draws["parts"][0]
    w = part["z"].astype(dtype) * p["SE_rate"][None, :]
    scale = np.sqrt(2 * p["SE_var"] / len(w)).astype(dtype)
    b = part["b"].astype(dtype)[None, :]
    theta = part["theta"].astype(dtype)
    nv = p["Noise_var"]
    phi_x, phi_q = (scale * np.cos(a @ w.T + b) for a in (x, xq))
    chol = (scipy.linalg.cholesky(host_gram(x, x, p["SE_rate"], p["SE_var"])
                                  + nv * np.eye(len(x), dtype=dtype), lower=True), True)
    rhs = (y - p["Bias_Bias"])[:, None] - phi_x @ theta - np.sqrt(nv) * draws["eps"].astype(dtype)
    cross = host_gram(xq, x, p["SE_rate"], p["SE_var"])
    paths = p["Bias_Bias"] + phi_q @ theta + cross @ scipy.linalg.cho_solve(chol, rhs)
    if dtype != np.float64:
        return paths, None
    c = scipy.linalg.cho_solve(chol, cross.T).T
    sd = np.sqrt(((phi_q - c @ phi_x) ** 2).sum(1) + nv * (c ** 2).sum(1))
    return paths, sd


def phase10b(gp, gp_map, path):
    """Pathwise draws: 600 paths, 4096 features, 512 queries at the MAP, K1
    once a call (float32 from a seed, timed and counted).  At the MAP the
    draws from injected numpy draws against the float64 host's replay of
    Matheron's update: float64 on the card at 1e-6 (10c's limit: the
    host takes the parameters through their float32 transform), float32 within 1e-3
    or 4x a float32 host witness (cond(K) ~ 1e6: rounding of the update
    K_sX (K + s2 I)^{-1}(...) alone moves a float32 path by more than the
    posterior std, ~3e-3 of the prior's); the float64 draws' mean within
    5 standard errors of the posterior mean and their std in (0.8, 1.2) of
    the std given the features, the JAX test's bounds (the posterior std
    there is below the random features' own error, O(var sqrt(2/F)), so
    the ratio to the Predictor's std measures the features: printed).  At
    the default params the JAX test's bounds against the Predictor, in
    float64 from a seed; one seed over two overlapping batches is one path
    (float64 at the MAP)."""
    xq = np.random.default_rng(101).standard_normal((512, 8)).astype(np.float32)
    pr = gp.predictor(gp_map)
    torch.cuda.synchronize()
    with counted(path):
        t0 = time.perf_counter()
        draws = pr.pathwise_sampler(space=xq, samples=600, key=1, n_features=4096)
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        per_call = stationary_gram.launches
    require(per_call == 1, f"pathwise_sampler launched K1 {per_call} times, expected 1")
    require(draws.shape == (512, 600) and finite(draws), "pathwise draws not finite")

    def moments(draws, mu, sd):
        d = draws.double().cpu().numpy()
        return float(np.max(np.abs(d.mean(1) - mu) / (sd / np.sqrt(600)))), d.std(1) / sd

    def stats(pr):
        ref = pr(xq)
        return host64(ref["mean"]), host64(ref["std"])

    z32, ratio32 = moments(draws, *stats(pr))
    reg = gp.active
    u = reg.dict_to_array(gp_map)
    x, y = (np.asarray(a, np.float32) for a in (gp.inputs, gp.outputs))
    rng = np.random.default_rng(11)
    inj = {"parts": [{"z": rng.standard_normal((4096, 8)).astype(np.float32),
                      "b": (2 * np.pi * rng.random(4096)).astype(np.float32),
                      "theta": rng.standard_normal((4096, 600)).astype(np.float32)}],
           "eps": rng.standard_normal((len(x), 600)).astype(np.float32)}
    t0 = time.perf_counter()
    ref, sd_feat = host_pathwise(reg, u, x, y, xq, inj)
    t_host = time.perf_counter() - t0
    scale = np.abs(ref).max()
    got32 = pr.pathwise_sampler(space=xq, samples=600, key=inj, n_features=4096)
    gap32 = float(np.abs(got32.double().cpu().numpy() - ref).max() / scale)
    witness = {}

    def witness_fn():
        witness["gap"] = float(np.abs(host_pathwise(reg, u, x, y, xq, inj, np.float32)[0]
                                      - ref).max() / scale)
        return witness["gap"]

    limit32 = held(gap32, 1e-3, witness_fn, "10b float32 paths at the MAP vs the host")
    g3t.settings.floatx = "float64"
    try:
        pr64 = gp.predictor(gp_map)
        got64 = pr64.pathwise_sampler(space=xq, samples=600, key=inj, n_features=4096)
        mu_map, sd_map = stats(pr64)
        pr_def = gp.predictor(gp.params_default)
        z, ratio = moments(pr_def.pathwise_sampler(space=xq, samples=600, key=1,
                                                   n_features=4096), *stats(pr_def))
        a = pr64.pathwise_sampler(space=xq[:300], samples=8, key=5, n_features=4096)
        b = pr64.pathwise_sampler(space=xq[200:], samples=8, key=5, n_features=4096)
        shared = float((a[200:] - b[:100]).abs().max() / a.abs().max())
    finally:
        g3t.settings.floatx = "float32"
    gap64 = float(np.abs(got64.cpu().numpy() - ref).max() / scale)
    z_map, ratio_map = moments(got64, mu_map, sd_feat)
    _, ratio_pred = moments(got64, mu_map, sd_map)
    print(f"  10b pathwise: 600 paths x 512 queries, 4096 features in {t_draw * 1e3:.1f} ms "
          f"(float32 at the MAP from a seed: mean within {z32:.2f} standard errors of the "
          f"Predictor's, std ratio [{ratio32.min():.3f}, {ratio32.max():.3f}]); at the MAP from "
          f"injected draws vs the float64 host replay ({t_host:.1f} s): float64 {gap64:.2e}, "
          f"float32 {gap32:.2e} (limit {limit32:.2e}, the float32 host's "
          f"{witness.get('gap', float('nan')):.2e}); float64 mean within {z_map:.2f} standard "
          f"errors, std ratio to the std given the features [{ratio_map.min():.3f}, "
          f"{ratio_map.max():.3f}], to the Predictor's [{ratio_pred.min():.3f}, "
          f"{ratio_pred.max():.3f}]; float64 at the default params: mean within {z:.2f} "
          f"standard errors, std ratio [{ratio.min():.3f}, {ratio.max():.3f}]; one seed over "
          f"two batches agrees at the shared points to {shared:.2e}", flush=True)
    require(gap64 <= 1e-6, f"10b float64 paths at the MAP vs the host replay {gap64:.2e}")
    require(z_map < 5 and ratio_map.min() > 0.8 and ratio_map.max() < 1.2,
            f"pathwise moments at the MAP: {z_map:.2f} standard errors, ratio to the std "
            f"given the features [{ratio_map.min()}, {ratio_map.max()}]")
    require(z < 5 and ratio.min() > 0.8 and ratio.max() < 1.2,
            f"pathwise moments: {z:.2f} standard errors, ratio [{ratio.min()}, {ratio.max()}]")
    require(shared <= 1e-8, f"pathwise draws of one seed disagree at shared points {shared}")
    return dict(draw_ms=t_draw * 1e3, z=z, ratio=[float(ratio.min()), float(ratio.max())],
                shared=shared, z32=z32, ratio32=[float(ratio32.min()), float(ratio32.max())],
                gap32=gap32, limit32=limit32, witness32=witness.get("gap"), gap64=gap64,
                z_map=z_map, ratio_map=[float(ratio_map.min()), float(ratio_map.max())],
                ratio_map_predictor=[float(ratio_pred.min()), float(ratio_pred.max())])


class _Normals:
    """Stands in for a numpy Generator: hands out fixed standard normals."""

    def __init__(self, z):
        self.z = z

    def standard_normal(self, shape):
        return self.z.reshape(shape)


def torch_rows(reg, rows):
    """Per-row float32 natural values of GP(Bias, SE) on ``settings.device``
    ((R, size) each) and their feature-by-feature SE gram ``gram(a, b)``
    (R, len(a), len(b)) in torch alone: the card witnesses' inputs."""
    f32 = dict(dtype=torch.float32, device=g3t.settings.device)
    ps = [host_params(reg, u, np.float32) for u in rows]
    col = {k: torch.as_tensor(np.stack([p[k].reshape(-1) for p in ps]), **f32) for k in ps[0]}

    def gram(a, b):
        acc = 0.0
        for k in range(a.shape[1]):
            acc = acc + ((a[None, :, k, None] - b[None, None, :, k])
                         * col["SE_rate"][:, k, None, None]) ** 2
        return col["SE_var"][:, :, None] * torch.exp(-0.5 * acc)

    return col, gram, f32


def card_witness_draws(reg, rows, x, y, xq, zs):
    """The noisy GP(Bias, SE) draws loc + chol(C) z of ``rows`` from the
    normals ``zs`` in float32 on the card through torch alone (a
    feature-by-feature gram, ``torch.linalg.cholesky``, triangular solves
    and products: cuSOLVER and cuBLAS, no kernel or code of the port),
    every row in one batch as the port batches them: the witness of what
    float32 rounding does on the card's arithmetic."""
    col, gram, f32 = torch_rows(reg, rows)
    xt, xqt, yt = (torch.as_tensor(a, **f32) for a in (x, xq, y))
    nv = col["Noise_var"][:, :, None]
    chol = torch.linalg.cholesky(gram(xt, xt) + nv * torch.eye(len(x), **f32))
    cross = gram(xqt, xt)
    alpha = torch.cholesky_solve((yt[None, :] - col["Bias_Bias"])[..., None], chol)
    v = torch.linalg.solve_triangular(chol, cross.transpose(-1, -2), upper=False)
    cov = gram(xqt, xqt) + nv * torch.eye(len(xq), **f32) - v.transpose(-1, -2) @ v
    mean = col["Bias_Bias"] + (cross @ alpha)[..., 0]
    draws = mean + (torch.linalg.cholesky(cov) @ torch.as_tensor(zs, **f32)[..., None])[..., 0]
    return draws.double().cpu().numpy()


def card_witness_grad(reg, rows, x, y, wide=torch.float32):
    """Each row's GP(Bias, SE) likelihood gradient over (Bias, log SE_var,
    log Noise_var), (R, 3), in float32 on the card through torch alone
    (``torch.linalg.cholesky``, L^{-1} by a triangular solve, K^{-1} =
    L^{-T} L^{-1} and the port's contraction 0.5 (alpha alpha' - K^{-1}) :
    dK, every row in one batch); with ``wide=torch.float64`` the product
    K^{-1} and the contraction are formed in float64 from the float32
    factor."""
    col, gram, f32 = torch_rows(reg, rows)
    xt, yt = (torch.as_tensor(a, **f32) for a in (x, y))
    eye = torch.eye(len(x), **f32)
    kse = gram(xt, xt)
    nv = col["Noise_var"][:, 0]
    chol = torch.linalg.cholesky(kse + nv[:, None, None] * eye)
    alpha = torch.cholesky_solve((yt[None, :] - col["Bias_Bias"])[..., None], chol)[..., 0]
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False).to(wide)
    del chol
    kinv = linv.transpose(-1, -2) @ linv
    del linv
    a = alpha.to(wide)
    g_var = 0.5 * torch.stack([((a[i, :, None] * a[i, None, :] - kinv[i]) * kse[i]).sum()
                               for i in range(len(a))])
    g_noise = 0.5 * nv.to(wide) * ((a * a).sum(-1) - kinv.diagonal(dim1=-2, dim2=-1).sum(-1))
    return torch.stack([a.sum(-1), g_var, g_noise], -1).double().cpu().numpy()


def phase10c(gp, dt16, x, y, path, path_batched):
    """batch_sample and particles over the 16 rows at 1024 queries (noisy
    draws, float32, timed and counted), against the float64 host's
    coloured draws of the same normals: rows 0 and 15 in float64 on the
    card at 1e-6; float32 at 1e-3 at the default params, and at the rows
    (cond(K) ~ 7e5) within 1e-3 or 4x the card's float32 witness.  There
    the posterior covariance K_ss + s2 I - V'V cancels to ~1/200 of V'V,
    and the float32 products V = L^{-1} K_Xs and V'V on the card are what
    the draws' gap is made of (``python3 -m g3py_tpu_torch.tools.f32_draws``
    swaps each stage: K1's grams, K2's factor and L^{-1} move it by
    nothing, the same products in float64 cut it 16-fold): so the witness
    is the same draws in float32 through torch on the card, batched as
    the port batches them (cuSOLVER, cuBLAS), and a scipy float32
    witness's gap is printed beside it.  Then average(samples=2) through
    the row loop against the batched average."""
    reg = gp.active
    rows = np.asarray(dt16[reg.param_names()])
    xq = np.random.default_rng(102).standard_normal((1024, 8)).astype(np.float32)
    torch.cuda.synchronize()
    with counted(path_batched):
        t0 = time.perf_counter()
        draws = gp.batch_sample(rows, space=xq, noise=True, rng=np.random.default_rng(7))
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        k1, k2, _ = launches()
    require(draws.shape == (16, 1024) and finite(draws), "batch_sample not finite")
    require((k1, k2) == (4, 2), f"batch_sample launched K1 {k1}, K2 {k2} (expected 4, 2 for "
            "one chunk: the rows' grams and states, the cross grams, the query grams and "
            "the 16 x 1024^2 posterior factors)")
    zs = np.random.default_rng(7).standard_normal((16, 1024)).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    g3t.settings.floatx = "float64"
    try:
        draws64 = gp.batch_sample(rows, space=xq, noise=True, rng=np.random.default_rng(7))
    finally:
        g3t.settings.floatx = "float32"
    card32 = card_witness_draws(reg, rows, x, y, xq, zs)
    gaps, gaps64, witness, host32, limits = {}, {}, {}, {}, {}
    for r in (0, 15):
        _, ref = host_draws(reg, rows[r], x64, y64, xq, zs[r][:, None])
        ref = ref[:, 0]
        scale = np.abs(ref).max()
        gaps64[r] = float(np.abs(draws64[r].cpu().numpy() - ref).max() / scale)
        gaps[r] = float(np.abs(draws[r].double().cpu().numpy() - ref).max() / scale)
        witness[r] = float(np.abs(card32[r] - ref).max() / scale)
        host32[r] = float(np.abs(host_draws(reg, rows[r], x, y, xq, zs[r][:, None],
                                            np.float32)[1][:, 0] - ref).max() / scale)
        require(gaps64[r] <= 1e-6, f"10c row {r} float64 draws vs the host {gaps64[r]:.3e}")
        limits[r] = held(gaps[r], 1e-3, lambda r=r: witness[r],
                         f"10c row {r} float32 draws vs the host", "the card's float32 witness")
    u_def = reg.dict_to_array(gp.params_default)
    got_def = gp.batch_sample(u_def[None], space=xq, noise=True, rng=_Normals(zs[0]))
    _, ref = host_draws(reg, u_def, x64, y64, xq, zs[0][:, None])
    gap_def = float(np.abs(got_def[0].double().cpu().numpy() - ref[:, 0]).max()
                    / np.abs(ref).max())
    require(gap_def <= 1e-3, f"10c float32 draws at the default params vs the host {gap_def}")
    with counted(path_batched):
        part = gp.particles(dt16, 16, space=xq, noise=True, rng=np.random.default_rng(7))
    require(torch.allclose(part.T, draws, rtol=1e-6, atol=1e-6),
            "particles differ from batch_sample's draws")
    # average(samples=2) through the row loop: float32 counted; the loop's
    # mean and std against the batched average in float64 (1e-8)
    gp.set_space(xq[:256])
    t0 = time.perf_counter()
    with counted(path):  # the row loop: one row's gram and factorization a statistic
        loop = gp.average(dt16, False, samples=2)
    t_avg = time.perf_counter() - t0
    require(loop["samples"].shape == (256, 2) and finite(loop["samples"])
            and finite(loop["mean"]) and finite(loop["std"]), "average(samples=2) not finite")
    g3t.settings.floatx = "float64"
    try:
        loop64 = gp.average(dt16, False, samples=2)
        batched64 = gp.average(dt16, False)
    finally:
        g3t.settings.floatx = "float32"
        gp.set_space(x[:4])
    avg_gap = {k: float((loop64[k] - batched64[k]).abs().max() / batched64[k].abs().max())
               for k in ("mean", "std")}
    require(max(avg_gap.values()) <= 1e-8, f"average's row loop vs batched (float64) {avg_gap}")
    print(f"  10c draws over 16 rows at 1024 queries: batch_sample {t_draw * 1e3:.1f} ms "
          f"(K1 x{k1}, K2 x{k2}); gaps to the float64 host: float64 rows 0, 15 {gaps64}, "
          f"float32 at the default params {gap_def:.2e}, float32 at the rows {gaps} (limits "
          f"{limits}; the card's float32 witness {witness}, scipy's in float32 {host32}); "
          f"particles = the same draws; average(samples=2) through the row loop "
          f"{t_avg:.2f} s, loop vs batched (float64) {avg_gap}", flush=True)
    return dict(draw_ms=t_draw * 1e3, gaps=gaps, limits=limits, gaps64=gaps64,
                gap_default=gap_def, card_witness=witness, host_witness=host32,
                average_s=t_avg, loop_vs_batched=avg_gap)


def host_grad_sampling(reg, u, x, y, dtype=np.float64):
    """GP(Bias, SE) likelihood and its gradient over (Bias, log SE_var,
    log Noise_var) at ``u`` in ``dtype`` (float64: the reference; float32:
    the rounding witness), analytic: alpha = K^{-1} r and tr(K^{-1}) from a
    scipy Cholesky and triangular inverse."""
    import scipy.linalg

    p = host_params(reg, u, dtype)
    x, y = x.astype(dtype), y.astype(dtype)
    n = len(x)
    kse = host_gram(x, x, p["SE_rate"], p["SE_var"])
    chol = scipy.linalg.cholesky(kse + p["Noise_var"] * np.eye(n, dtype=dtype), lower=True)
    r = y - p["Bias_Bias"]
    z = scipy.linalg.solve_triangular(chol, r, lower=True)
    alpha = scipy.linalg.solve_triangular(chol.T, z, lower=False)
    linv = scipy.linalg.solve_triangular(chol, np.eye(n, dtype=dtype), lower=True)
    tr_kinv = float((linv * linv).sum())
    ll = -0.5 * n * np.log(2 * np.pi) - 0.5 * z @ z - np.log(np.diag(chol)).sum()
    nv = p["Noise_var"]
    g_bias = alpha.sum()
    if dtype == np.float64:
        g_var = 0.5 * (alpha @ kse @ alpha - (n - nv * tr_kinv))
    else:  # the port's form: 0.5 (alpha alpha' - K^{-1}) contracted with dK/dlog(var)
        g_var = 0.5 * ((np.outer(alpha, alpha) - linv.T @ linv) * kse).sum()
    g_noise = 0.5 * nv * (alpha @ alpha - tr_kinv)
    return float(ll), np.array([g_bias, g_var, g_noise], np.float64).ravel()


def prior_terms(reg, u):
    """The registry's prior terms and their gradient at ``u`` (float64 on
    the CPU, the port's own priors)."""
    old = g3t.settings.device, g3t.settings.floatx
    g3t.settings.device, g3t.settings.floatx = "cpu", "float64"
    try:
        t = torch.tensor(np.asarray(u, np.float64), requires_grad=True)
        with torch.enable_grad():
            val = reg.logp_prior_dict(reg.array_to_dict_tensor(t))
        grad = (torch.autograd.grad(val, t)[0] if val.requires_grad
                else torch.zeros_like(t))
        return float(val), grad.numpy()
    finally:
        g3t.settings.device, g3t.settings.floatx = old


SAMPLER_10D = 3  # 10d's sampler iterations (cut from 10 for the script's time)


def phase10d(gp, gp_map, dt16, x, y, path_batched):
    """fix_vars over the 8 SE rates on the 16 rows: fixed_logp/fixed_dlogp
    at the MAP's sampling dims against the float64 host's row mean (1e-3,
    1e-2), one batched K1 and K2 launch an evaluation (float32, timed and
    counted; the float64 run on the card too).  At the MAP the gradient is
    near 0 (|g| ~ 2 against terms ~ n): the float32 gradient is held
    within 1e-2 or 4x the card's float32 witness, the port's contraction
    0.5 (alpha alpha' - K^{-1}) : dK through torch on the card, batched as
    the port batches it; printed beside it, the same with K^{-1} = L^{-T}
    L^{-1} formed in float64 (the float32 product on the card is what
    the gap is made of) and scipy's in float32 on the host;
    find_MAP under fix_vars;
    sample_hypers over the fixed dims, 8 walkers x 5, the final walkers
    against the card's float64 fixed_logp and the best one against the
    host."""
    reg = gp.active
    keys = [f"TRAIN_GP_SE_rate__{i}" for i in range(8)]
    reg.fix_vars(dt16, keys)
    try:
        sp = reg.sampling_params(gp_map)
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        chain = reg.fixed_chain.astype(np.float64)
        per_eval = {}
        t = {}
        for fn in ("fixed_logp", "fixed_dlogp"):
            torch.cuda.synchronize()
            with counted(path_batched):
                t0 = time.perf_counter()
                val = getattr(gp, fn)(sp)
                torch.cuda.synchronize()
                t[fn] = (time.perf_counter() - t0) * 1e3
                k1, k2, retries = launches()
            per_eval[fn] = (k1, k2 - retries)
            require((k1, k2 - retries) == (1, 1), f"{fn}: K1 x{k1}, K2 x{k2} ({retries} "
                    "retries), expected one batched launch of each")
            if fn == "fixed_logp":
                got_v = float(val)
            else:
                got_g = np.asarray(val, np.float64)
        g3t.settings.floatx = "float64"
        try:
            got_v64, got_g64 = float(gp.fixed_logp(sp)), np.asarray(gp.fixed_dlogp(sp))
        finally:
            g3t.settings.floatx = "float32"

        us = chain.copy()
        us[:, reg.sampling_dims] = sp
        priors = [prior_terms(reg, u) for u in us]  # the settings are global: not threaded
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
            rows = list(pool.map(lambda u: host_grad_sampling(reg, u, x64, y64), us))
        ref_v = float(np.mean([r[0] + p[0] for r, p in zip(rows, priors)]))
        ref_g = np.mean([r[1] + p[1][reg.sampling_dims] for r, p in zip(rows, priors)], axis=0)
        gap_v = abs(got_v - ref_v) / abs(ref_v)
        gap_g = float(np.linalg.norm(got_g - ref_g) / np.linalg.norm(ref_g))
        gap_v64 = abs(got_v64 - ref_v) / abs(ref_v)
        gap_g64 = float(np.linalg.norm(got_g64 - ref_g) / np.linalg.norm(ref_g))
        print(f"  10d fixed_logp {got_v:.4f} vs host {ref_v:.4f} (gap {gap_v:.2e}, "
              f"{t['fixed_logp']:.1f} ms), fixed_dlogp gap {gap_g:.2e} (|host gradient| "
              f"{np.linalg.norm(ref_g):.3e}, {t['fixed_dlogp']:.1f} ms); float64 gaps "
              f"{gap_v64:.2e}, {gap_g64:.2e}; launches {per_eval}; host "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        require(gap_v <= 1e-3 and gap_v64 <= 1e-3 and gap_g64 <= 1e-2,
                f"10d fixed logp/dlogp vs host: {gap_v:.2e}; float64 {gap_v64:.2e}, "
                f"{gap_g64:.2e}")

        def row_mean_gap(rows_g):
            g = np.mean([r + p[1][reg.sampling_dims] for r, p in zip(rows_g, priors)], axis=0)
            return float(np.linalg.norm(g - ref_g) / np.linalg.norm(ref_g))

        # the witnesses: the same contraction in float32 on the card through
        # torch (held), and with its K^{-1} product in float64 (the cause)
        witness = {"card": row_mean_gap(card_witness_grad(reg, us, x, y)),
                   "card, K^-1 in float64": row_mean_gap(card_witness_grad(reg, us, x, y,
                                                                           torch.float64))}
        print(f"  10d float32 fixed_dlogp's witnesses at the MAP: {witness}", flush=True)
        limit_g = held(gap_g, 1e-2, lambda: witness["card"],
                       "10d float32 fixed_dlogp at the MAP", "the card's float32 witness")
        with counted(path_batched):
            t0 = time.perf_counter()
            fmap = gp.find_MAP(start=gp_map, points=1, powell=False, display=False)
            t_fit = time.perf_counter() - t0
        after = float(gp.fixed_logp(reg.sampling_params(fmap)))
        require(after >= got_v - 1e-3 * abs(got_v), f"find_MAP under fix_vars lowered the "
                f"fixed logp {got_v} -> {after}")
        with counted(path_batched):
            t0 = time.perf_counter()
            ch, lnprob = gp.sample_hypers(start=fmap, samples=SAMPLER_10D, chains=8, seed=5,
                                          raw=True, noise_mult=0.02)
            t_s = time.perf_counter() - t0
        require(np.isfinite(ch).all() and np.isfinite(lnprob).all(),
                "fixed-dims sampler not finite")
        require(np.allclose(ch[:, :, reg.fixed_dims], chain[:, reg.fixed_dims].mean(0),
                            rtol=1e-6), "fixed dims of the sampler's chain moved")
        final = ch[:, -1, :][:, reg.sampling_dims]
        g3t.settings.floatx = "float64"
        try:
            ref64 = np.array([gp.fixed_logp(w) for w in final])
        finally:
            g3t.settings.floatx = "float32"
        walk_gap = float(np.max(np.abs(lnprob[:, -1] - ref64) / np.abs(ref64)))
        best = int(np.argmax(lnprob[:, -1]))
        sp_best = final[best]

        us = chain.copy()
        us[:, reg.sampling_dims] = sp_best
        priors = [prior_terms(reg, u)[0] for u in us]
        with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
            lls = list(pool.map(lambda u: host_logp(reg, u, x64, y64), us))
        host_v = float(np.mean(np.asarray(lls) + np.asarray(priors)))
        best_gap = abs(lnprob[best, -1] - host_v) / abs(host_v)
        print(f"  10d find_MAP under fix_vars {t_fit:.2f} s (fixed logp {got_v:.4f} -> "
              f"{after:.4f}); sampler 8 x {SAMPLER_10D} over 3 sampling dims {t_s:.2f} s, final walkers "
              f"vs the card's float64 {walk_gap:.2e}, the best vs the host {best_gap:.2e}",
              flush=True)
        require(walk_gap <= 1e-3 and best_gap <= 1e-3,
                f"10d final walkers: {walk_gap:.2e} / {best_gap:.2e}")
        return dict(logp_ms=t["fixed_logp"], dlogp_ms=t["fixed_dlogp"], gap_v=gap_v,
                    gap_g=gap_g, gap_g_witness=witness, limit_g=limit_g,
                    gap_v64=gap_v64, gap_g64=gap_g64, fit_s=t_fit,
                    sampler_s=t_s, walk_gap=walk_gap, best_gap=best_gap)
    finally:
        reg.fix_vars()


def phase10e(path_batched):
    """reparam='noncentered' on the reference WGP n=125 workload, 32 x 400:
    the shear round trip, every _ll the model logp at its row (the JAX
    test's rtol 1e-4, atol 1e-3)."""
    x, y = bench_wgp_data()
    wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                  mapping=g3t.BoxCoxLinear(y), name="SMOKE_NCP")
    wgp.observed(x, y)
    start = wgp.params_default
    shear, unshear = wgp._noncentered_sampling_shear()
    ndim = wgp.active.ndim
    u = torch.as_tensor(wgp.active.dict_to_array(start)[None]
                        + 0.3 * np.random.default_rng(9).standard_normal((32, ndim)),
                        dtype=torch.float32, device=g3t.settings.device)
    sheared = shear(u)
    trip = float((unshear(sheared) - u).abs().max()
                 / max(float(u.abs().max()), float(sheared.abs().max())))
    require(trip <= 1e-6, f"shear round trip {trip:.2e}")
    with counted(path_batched):
        t0 = time.perf_counter()
        dt = wgp.sample_hypers(start=start, samples=400, chains=32, noise_mult=0.05, seed=2,
                               reparam="noncentered")
        t_s = time.perf_counter() - t0
    rows = np.asarray(dt[wgp.active.param_names()])
    ll = wgp.logp_chain(rows)
    inside = dt["_ll"] > -1e29
    gap = float(np.max(np.abs(ll[inside] - dt["_ll"][inside])
                       / np.maximum(np.abs(dt["_ll"][inside]), 1.0)))
    chain = g3t.datatrace_to_chains(wgp, dt)
    print(f"  10e noncentered WGP n=125 32 x 400: {t_s:.2f} s, acceptance "
          f"{moved_share(chain):.3f}, shear round trip {trip:.2e}, every _ll vs the logp at "
          f"its row {gap:.2e} ({int(inside.sum())} rows)", flush=True)
    # the JAX test's float32 tolerance (tests/test_samplers.py:410): the logp
    # of a row in a batch of 16 and in one of 12800 rounds differently
    require(inside.mean() > 0.9 and np.allclose(ll[inside], dt["_ll"][inside], rtol=1e-4,
                                                atol=1e-3), f"10e _ll vs logp at rows: {gap:.2e}")
    return dict(sampler_s=t_s, round_trip=trip, ll_gap=gap, acceptance=moved_share(chain))


LOADER = r'''
import json, sys, time
import numpy as np, torch
import g3py_tpu_torch.serving as serving
from g3py_tpu_torch.ops.stationary_gram import stationary_gram as k1
out_dir, names, device = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
xq = np.load(out_dir + "/queries.npy")
report = {}
for name in names:
    ep = serving.load_predictor(out_dir + "/" + name, device=device)
    rec = {"launches": [], "ms": []}
    for m in (1, 256, 1000):
        ep(xq[:m]); sync()
        before = k1.launches
        t0 = time.perf_counter(); got = ep(xq[:m]); sync()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append(k1.launches - before)
        np.savez(f"{out_dir}/{name}_{m}.npz", **{k: v.cpu().numpy() for k, v in got.items()})
    report[name] = rec
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "g3py_tpu")
       or m in ("g3py_tpu_torch.models", "g3py_tpu_torch.hypers", "g3py_tpu_torch.bayesian")]
report["bad_modules"] = bad
print(json.dumps(report))
'''


def phase10f(gp, gp_map, x, path):
    """Export phase 5's GP (mean, std, quantiles, quantiles_noise), a
    WGP(BoxCoxLinear) and a WGP(WarpingTanh) Predictor on the card; load
    them in a fresh python3 process with no model code (started here and
    read by :func:`finish_phase10f`); the loaded statistics against the live
    Predictors' at batches 1, 256 and 1000 (rtol 1e-5); K1 once a query
    batch inside the artifact."""
    import shutil

    out_dir = ROOT / "build" / "chip_smoke_export"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    y_pos = (np.abs(np.sin(x[:, 0])) + 0.5
             + 0.1 * np.random.default_rng(103).standard_normal(len(x))).astype(np.float32)
    flags = dict(mean=True, std=True, quantiles=True, quantiles_noise=True)
    models = {"gp": (gp, gp_map, flags)}
    for name, mapping in (("boxcox", g3t.BoxCoxLinear(y_pos)),
                          ("tanh", g3t.WarpingTanh(y_pos, n=3))):
        w = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), mapping=mapping,
                    name="EXP_" + name.upper())
        w.observed(x, y_pos)
        models[name] = (w, w.params_default, flags if name == "boxcox"
                        else dict(mean=True, std=True, quantiles=True))
    xq = np.random.default_rng(104).standard_normal((1000, 8)).astype(np.float32)
    np.save(out_dir / "queries.npy", xq)
    live, t_export = {}, {}
    for name, (proc, params, fl) in models.items():
        pr = proc.predictor(params)
        t0 = time.perf_counter()
        pr.export(str(out_dir / name), **fl)
        t_export[name] = time.perf_counter() - t0
        live[name] = {m: dict(pr(xq[:m], **fl)) for m in (1, 256, 1000)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pr(xq[:256], **fl)
        torch.cuda.synchronize()
        live[name]["ms"] = (time.perf_counter() - t0) * 1e3
    # the loader process runs beside phase 11 (its ~26 s are mostly the
    # process's start and the artifacts' load); finish_phase10f reads it
    proc = subprocess.Popen([sys.executable, "-c", LOADER, str(out_dir), ",".join(models),
                             torch.device(g3t.settings.device).type],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(ROOT),
                            env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    return dict(_pending=(proc, time.perf_counter(), out_dir, list(models), live, t_export))


def finish_phase10f(rec, path):
    """Wait for 10f's loader process and hold the loaded statistics against
    the live Predictors' (rtol 1e-5) and K1 to once a query batch inside
    the artifact; its launches go to ``path``."""
    import shutil

    proc, t0, out_dir, models, live, t_export = rec.pop("_pending")
    stdout, stderr = proc.communicate(timeout=600)
    t_sub = time.perf_counter() - t0
    require(proc.returncode == 0, f"loader process failed:\n{stderr[-3000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    require(not report["bad_modules"], f"the loader imported {report['bad_modules']}")
    for name in models:
        gaps = {}
        for m in (1, 256, 1000):
            got = np.load(out_dir / f"{name}_{m}.npz")
            want = live[name][m]
            for k in want:
                gap = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                gaps[k] = max(gaps.get(k, 0.0), gap)
        loaded = report[name]
        require(loaded["launches"] == [1, 1, 1], f"{name}: K1 launched {loaded['launches']} "
                "times in the artifact's query batches, expected once each")
        require(max(gaps.values()) <= 1e-5, f"{name}: loaded vs live {gaps}")
        path[0] += sum(loaded["launches"])
        rec[name] = dict(export_s=t_export[name], loaded_ms=loaded["ms"],
                         live_256_ms=live[name]["ms"], gap=max(gaps.values()))
        print(f"  10f {name}: export {t_export[name]:.2f} s; loaded batches of 1/256/1000 "
              f"{[round(t, 3) for t in loaded['ms']]} ms (live batch of 256 "
              f"{live[name]['ms']:.3f} ms), K1 {loaded['launches']}, largest relative gap to "
              f"the live Predictor {max(gaps.values()):.2e}", flush=True)
    rec["loader_process_s"] = t_sub
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def phase10(gp, gp_map, x, y, dt16, path, path_batched):
    """Phase 10's runs; the launches of 10a, 10b and 10f go to ``path``,
    the batched ones of 10c-10e to ``path_batched``."""
    out = {}
    runs = (("10a", "Predictor.updated", lambda p: phase10a(x, y, gp_map, p), path),
            ("10b", "pathwise_sampler", lambda p: phase10b(gp, gp_map, p), path),
            ("10c", "draws over rows", lambda p: phase10c(gp, dt16, x, y, path, p), path_batched),
            ("10d", "fix_vars", lambda p: phase10d(gp, gp_map, dt16, x, y, p), path_batched),
            ("10e", "reparam='noncentered'", phase10e, path_batched),
            ("10f", "export", lambda p: phase10f(gp, gp_map, x, p), path))
    for key, label, run, target in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        launched = [0, 0]
        out[key] = run(launched)
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s; launches K1 {launched[0]}, "
              f"K2 {launched[1]}", flush=True)
        target[0] += launched[0]
        target[1] += launched[1]
    return out


# ---------------------------------------------------------------- phase 11
# The gradient half of the Bayesian toolbox (ROADMAP item 9): NUTS with a
# dense or diagonal mass, NeuTra, ADVI, HMC and find_MAP(engine='jax'), every
# chain, MC row or start of an evaluation in one batched K1 and K2 launch
# and one batched analytic backward.  Each run builds its model on the card
# (``settings.device``); only the replays of 11b and 11f build one on the
# CPU (replay_on_cpu), to compare with.  Each run's batched launches are
# predicted from its evaluations (a NUTS call: its leaves plus one for its
# starting points) and must match.
def card_only(fn):
    """Marks a phase-11 run: its model and tensors live on the card."""
    fn.card_only = True
    return fn


def cpu_replay(fn):
    """Marks the one phase-11 site that builds a model on the CPU: the
    replay a card run is compared with."""
    fn.cpu_replay = True
    return fn


def host_prior_wall(reg, u):
    """The prior of the GP/WGP workloads (Flat and FlatExp terms): 0 inside
    the support, -1e30 where a FlatExp value is at or below 1e-6."""
    start, wall = 0, 0.0
    for par in reg.ordered_params:
        seg = np.asarray(u[start:start + par.size], np.float64)
        if type(par.prior).__name__ == "FlatExp" and (np.exp(seg) <= 1e-6).any():
            wall = -1e30
        start += par.size
    return wall


def host_boxcox_logp(reg, u, x, y):
    """float64 logp of WGP(Bias, SE, BoxCoxLinear) at ``u``: the gaussian of
    z = boxcox(scale (y + shift), power) plus the log-Jacobian (power - 1)
    sum log|scale (y + shift)| + n log scale, plus the prior's wall."""
    import scipy.linalg

    p = host_params(reg, u)
    x, y = x.astype(np.float64), y.astype(np.float64)
    s, pw = p["BoxCoxLinear_scale"], p["BoxCoxLinear_power"]
    shifted = s * (y + p["BoxCoxLinear_shift"])
    if pw < 1e-5:
        z = np.log(np.abs(shifted) + 1e-32)
    else:
        z = (np.sign(shifted) * np.abs(shifted) ** pw - 1.0) / pw
    n = len(x)
    k = host_gram(x, x, p["SE_rate"], p["SE_var"]) + p["Noise_var"] * np.eye(n)
    chol = scipy.linalg.cholesky(k, lower=True)
    r = scipy.linalg.solve_triangular(chol, z - p["Bias_Bias"], lower=True)
    value = (-0.5 * n * np.log(2 * np.pi) - 0.5 * r @ r - np.log(np.diag(chol)).sum()
             + (pw - 1.0) * np.log(np.abs(shifted)).sum() + n * np.log(s))
    return float(value) + host_prior_wall(reg, u)


def lnprob_gap(reg, rows, lnprob, host_fn, x, y, threads=4):
    """Largest relative gap of ``lnprob`` to the float64 host logp at the
    (m, ndim) ``rows`` inside the prior's support, and how many were
    inside."""
    inside = [i for i in range(len(rows)) if lnprob[i] > -1e29]
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        refs = list(pool.map(lambda i: host_fn(reg, rows[i], x, y), inside))
    gaps = [abs(lnprob[i] - ref) / max(abs(ref), 1.0) for i, ref in zip(inside, refs)]
    return (max(gaps) if gaps else float("inf")), len(inside)


class GradCounts:
    """The phase-11 counters: batched value-and-gradient evaluations, NUTS
    leaves and host reads, L-BFGS evaluations, kernel launches and K2's
    jitter retries, zeroed on entry and read on exit."""

    def __enter__(self):
        from g3py_tpu_torch.bayesian import nuts, samplers

        self.nuts, self.samplers = nuts.nuts_sampler, samplers.value_and_grad
        self.nuts.leaves = self.nuts.reads = self.samplers.calls = 0
        zero_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.k1, self.k2, self.retries = launches()
        self.evals, self.leaves, self.reads = (self.samplers.calls, self.nuts.leaves,
                                               self.nuts.reads)

    def check(self, label, predicted, path):
        """The run's K1 launches equal ``predicted`` and its K2 launches
        ``predicted`` plus the jitter retries; both above zero.  Adds them
        to ``path``."""
        print(f"  {label}: K1 x{self.k1}, K2 x{self.k2} ({self.retries} jitter retries); "
              f"predicted {predicted} (value-and-gradient calls {self.evals}, NUTS leaves "
              f"{self.leaves}, host reads {self.reads})", flush=True)
        require(self.k1 == predicted and self.k2 - self.retries == predicted
                and self.k1 > 0 and self.k2 > 0,
                f"{label}: K1 x{self.k1}, K2 x{self.k2} - {self.retries} retries, predicted "
                f"{predicted}")
        path[0] += self.k1
        path[1] += self.k2


def bench_wgp(name):
    """The JAX package's sampler workload on the card: WGP(Bias, SE,
    BoxCoxLinear), n=125, d=8 (bench.py:697-714)."""
    x, y = bench_wgp_data()
    wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                  mapping=g3t.BoxCoxLinear(y), name=name)
    wgp.observed(x, y)
    return wgp, x, y


def card_rows(a):
    """A host array as rows on ``settings.device`` in ``settings.floatx``."""
    return torch.as_tensor(np.asarray(a), dtype=g3t.settings.dtype, device=g3t.settings.device)


def nuts_info(info):
    return {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in info.items()}


def leaf_profile(logp, z, label):
    """Wall and device ms of one leaf's evaluation (every chain's rows in
    one batched value-and-gradient call) over 20 leaves, and the device's
    idle share."""
    from g3py_tpu_torch.bayesian.samplers import value_and_grad

    def leaves():
        for _ in range(20):
            value_and_grad(logp, z)
        torch.cuda.synchronize()

    busy = top_ops(profile(leaves), f"{label}: 20 leaves", count=8) / 20
    t0 = time.perf_counter()
    leaves()
    wall = (time.perf_counter() - t0) * 1e3 / 20
    idle = max(0.0, 1.0 - busy / wall)
    print(f"    {label}: one leaf {wall:.3f} ms wall, {busy:.3f} ms on the device, idle "
          f"share {idle:.3f}", flush=True)
    return dict(leaf_wall_ms=wall, leaf_device_ms=busy, idle_share=idle)


@card_only
def phase11a(path_batched, warmup=8, samples=8):
    """The JAX package's sampler workload on NUTS (bench.py:769-800, cut
    from 400 warmup and 300 samples for time, to 4 + 4 since the Laplace,
    grid and distributed phases 16-19 came: its trees sit at depth ~7, a
    leaf is ~12-18 ms of host-bound wall): WGP n=125 non-centered, dense mass,
    target_accept 0.95, max_depth 7, 4 chains, through nuts_sampler as
    bench.py calls it, from the non-centered start that sample_hypers
    jitters (sample_hypers(method='nuts') itself runs in 11b and 11h)."""
    from g3py_tpu_torch.bayesian.average import _mESS

    wgp, x, y = bench_wgp("P11_NUTS")
    reg = wgp.active
    shear, unshear = wgp._noncentered_sampling_shear()
    logp = wgp._sampling_logps()[0]
    u0 = card_rows(reg.dict_to_array(wgp.params_default)[None])
    jitter = np.random.default_rng(1).standard_normal((4, reg.ndim))
    with torch.no_grad():
        v0 = unshear(u0).cpu().numpy() * (1 + 0.05 * jitter)
    with GradCounts() as cnt:
        vchain, lnprob, info = g3t.nuts_sampler(lambda v: logp(shear(v)), v0, samples,
                                                warmup=warmup, key=1, max_depth=7, chains=4,
                                                target_accept=0.95, adapt_mass="dense")
    cnt.check("11a NUTS n=125", 1 + cnt.leaves, path_batched)
    with torch.no_grad():  # back to the model's parameterization, as bench.py maps it
        chain = shear(card_rows(vchain.reshape(-1, reg.ndim))).cpu().numpy().reshape(
            vchain.shape)
    require(np.isfinite(chain).all() and np.isfinite(lnprob).all(), "11a: chain not finite")
    ess = sum(_mESS(chain[c, samples // 2:, :].astype(np.float64)) for c in range(4))
    frac = (samples / 2) / (samples + warmup)
    rows = chain[:, ::10, :].reshape(-1, reg.ndim)
    gap, inside = lnprob_gap(reg, rows, lnprob[:, ::10].ravel(), host_boxcox_logp, x, y)
    moved = moved_share(chain)
    out = dict(nuts_s=cnt.seconds, leaves=cnt.leaves, reads=cnt.reads,
               ms_per_leaf=cnt.seconds * 1e3 / cnt.leaves, ess=ess,
               ess_per_s=ess / (cnt.seconds * frac), info=nuts_info(info), lnprob_gap=gap,
               moved=moved)
    print(f"  11a NUTS WGP n=125, 4 chains, warmup {warmup} + {samples}: {cnt.seconds:.2f} s, "
          f"{cnt.leaves} leaves ({out['ms_per_leaf']:.3f} ms a leaf, {cnt.reads} host reads), "
          f"mESS (second half) {ess:.1f}, {out['ess_per_s']:.2f} ESS/s; acceptance "
          f"{out['info']['accept_rate']}, mean tree depth {out['info']['mean_tree_depth']}, "
          f"divergences {out['info']['divergences']}, step sizes {out['info']['step_size']}, "
          f"moved {moved:.3f} of the steps; every 10th lnprob vs the float64 host {gap:.2e} "
          f"({inside} of {len(rows)} rows)", flush=True)
    require(inside >= len(rows) // 2 and gap <= 1e-3, f"11a lnprob vs host {gap:.2e}")
    require(moved > 0, "11a: no chain moved")
    out.update(leaf_profile(lambda v: logp(shear(v)), card_rows(vchain[:, -1, :]),
                            "11a NUTS n=125 leaf (4 rows)"))
    return out


class HostDraws:
    """NUTS's draws made by numpy on the host from one seed and handed to
    the port's draw functions on the chains' device: the same numbers for a
    run on the card and its replay."""

    names = ("momentum", "direction", "select", "swap")

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def momentum(self, gen, shape, dtype, device):
        return torch.as_tensor(self.rng.standard_normal(shape), dtype=dtype, device=device)

    def direction(self, gen, shape, device):
        return torch.as_tensor(self.rng.random(shape) < 0.5, device=device)

    def select(self, gen, shape, dtype, device):
        return torch.as_tensor(self.rng.random(shape), dtype=dtype, device=device)

    swap = select

    def __enter__(self):
        from g3py_tpu_torch.bayesian import nuts

        self.saved = {k: getattr(nuts, f"_{k}_draws") for k in self.names}
        for k in self.names:
            setattr(nuts, f"_{k}_draws", getattr(self, k))
        return self

    def __exit__(self, *exc):
        from g3py_tpu_torch.bayesian import nuts

        for k, fn in self.saved.items():
            setattr(nuts, f"_{k}_draws", fn)


REPLAY = dict(samples=10, chains=2, method="nuts", nuts_warmup=10, max_depth=5,
              target_accept=0.9, nuts_mass="dense", reparam="noncentered", noise_mult=0.05,
              raw=True, seed=2)


@cpu_replay
def replay_on_cpu(run, name, flow=None):
    """A card run's comparison: ``run(model, flow)`` in float64 on the n=125
    workload built on the CPU, where the kernels' plain forms run, with
    ``flow`` (a NeuTra flow, when given) carried there."""
    old = g3t.settings.device, g3t.settings.floatx
    g3t.settings.device, g3t.settings.floatx = "cpu", "float64"
    try:
        wgp, _, _ = bench_wgp(name)
        if flow is not None:
            flow = copy.deepcopy(flow).to(device="cpu", dtype=torch.float64)
        return run(wgp, flow)
    finally:
        g3t.settings.device, g3t.settings.floatx = old


@card_only
def phase11b(path_batched):
    """Card against CPU: the 11a sampler through sample_hypers in float64 (2
    chains, warmup 10, samples 10, max_depth 5) on the card and replayed on
    the CPU from the same numpy draws; the chains agree to 1e-8."""

    def run(wgp, _):
        with HostDraws(11):
            return wgp.sample_hypers(start=wgp.params_default, **REPLAY)

    old = g3t.settings.floatx
    g3t.settings.floatx = "float64"
    try:
        wgp, _, _ = bench_wgp("P11_REPLAY")
        with GradCounts() as cnt:
            card = run(wgp, None)
    finally:
        g3t.settings.floatx = old
    cnt.check("11b float64 NUTS on the card", 1 + cnt.leaves, [0, 0])
    t0 = time.perf_counter()
    cpu = replay_on_cpu(run, "P11_REPLAY_CPU")
    t_cpu = time.perf_counter() - t0
    gap, gap_lp = (float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
                   for a, b in zip(card, cpu))
    moved = moved_share(card[0])
    print(f"  11b card vs CPU replay (float64, {cnt.leaves} leaves): chain gap {gap:.2e}, "
          f"lnprob gap {gap_lp:.2e}, moved {moved:.3f} of the steps; card {cnt.seconds:.2f} s, "
          f"CPU {t_cpu:.2f} s", flush=True)
    require(gap <= 1e-8 and gap_lp <= 1e-8 and moved > 0,
            f"11b card vs CPU: {gap:.2e} / {gap_lp:.2e} (moved {moved:.3f})")
    return dict(chain_gap=gap, lnprob_gap=gap_lp, leaves=cnt.leaves, card_s=cnt.seconds,
                cpu_s=t_cpu)


def host_gp_posterior(reg, u, x, y):
    return host_logp(reg, u, x, y) + host_prior_wall(reg, u)


@card_only
def phase11c(gp, gp_map, x, y, path_batched):
    """NUTS at full width: GP(Bias, SE), n=4096, from phase 5's MAP, 4
    chains, diagonal mass, max_depth 4, warmup 6, samples 6 (cut from 10 +
    10 for the script's time), in float32
    (counted) and float64, through nuts_sampler from the start that
    sample_hypers jitters; the final states' lnprob against the float64
    host logp."""
    reg = gp.active
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    # sample_hypers' start: the MAP jittered by noise_mult 0.02 from default_rng(seed)
    z0 = reg.dict_to_array(gp_map)[None] * (
        1 + 0.02 * np.random.default_rng(3).standard_normal((4, reg.ndim)))
    out = {}
    for dtype in ("float32", "float64"):
        g3t.settings.floatx = dtype
        try:
            with GradCounts() as cnt:
                chain, lnprob, info = g3t.nuts_sampler(gp._sampling_logps()[0], z0, 6,
                                                       warmup=6, key=3, max_depth=4, chains=4)
        finally:
            g3t.settings.floatx = "float32"
        if dtype == "float32":
            cnt.check("11c NUTS n=4096 float32", 1 + cnt.leaves, path_batched)
        else:
            cnt.check("11c NUTS n=4096 float64", 1 + cnt.leaves, [0, 0])
        info = nuts_info(info)
        require(np.isfinite(chain).all() and np.isfinite(lnprob).all(), "11c not finite")
        gap, inside = lnprob_gap(reg, chain[:, -1, :], lnprob[:, -1], host_gp_posterior,
                                 x64, y64)
        out[dtype] = dict(nuts_s=cnt.seconds, leaves=cnt.leaves,
                          ms_per_leaf=cnt.seconds * 1e3 / cnt.leaves, lnprob_gap=gap,
                          info=info)
        print(f"  11c NUTS GP n=4096 {dtype}: {cnt.seconds:.2f} s, {cnt.leaves} leaves "
              f"({out[dtype]['ms_per_leaf']:.2f} ms a leaf), acceptance "
              f"{info['accept_rate']}, divergences {info['divergences']}, step sizes "
              f"{info['step_size']}; final lnprob vs the float64 host {gap:.2e} ({inside} of "
              "4 inside the support)", flush=True)
        require(inside >= 2 and gap <= 1e-3, f"11c {dtype} final lnprob vs host {gap:.2e}")
    z = torch.as_tensor(chain[:, -1, :], dtype=torch.float32, device=g3t.settings.device)
    out.update(leaf_profile(gp._sampling_logps()[0], z, "11c NUTS n=4096 leaf (4 rows)"))
    return out


@card_only
def phase11d(gp, x, y, map_logp, map_s, loo_opt, path_batched):
    """find_MAP(engine='jax') at full width on phase 5's data: points=4,
    max_iters 100, float32, against phase 5's scipy optimum (rtol 1e-2,
    atol 0.5, tests/test_analytics.py's tolerance), then objective='loo'
    against phase 7b's scipy LOO optimum less 0.5 (tests/test_gp.py); the
    float64 twin of the logp fit."""
    from g3py_tpu_torch.bayesian.optimize_jax import lbfgs_maximize

    out = {}
    for objective in ("logp", "loo"):
        with GradCounts() as cnt:
            fit = gp.find_MAP(points=4, engine="jax", max_iters=100, display=False,
                              objective=objective)
        cnt.check(f"11d find_MAP(engine='jax', objective={objective!r})",
                  lbfgs_maximize.evaluations, path_batched)
        value = float(gp.logp(fit) if objective == "logp" else gp.loo(fit))
        out[objective] = dict(fit_s=cnt.seconds, value=value, evaluations=cnt.evals,
                              iterations=lbfgs_maximize.iterations)
    g3t.settings.floatx = "float64"
    try:
        t0 = time.perf_counter()
        fit64 = gp.find_MAP(points=4, engine="jax", max_iters=100, display=False)
        out["logp64"] = dict(fit_s=time.perf_counter() - t0, value=float(gp.logp(fit64)),
                             iterations=lbfgs_maximize.iterations)
    finally:
        g3t.settings.floatx = "float32"
    print(f"  11d find_MAP(engine='jax') n=4096, 4 starts: logp {out['logp']['value']:.4f} in "
          f"{out['logp']['fit_s']:.2f} s ({out['logp']['evaluations']} batched evaluations, "
          f"{out['logp']['iterations']} iterations) against scipy's {map_logp:.4f} in "
          f"{map_s:.2f} s (phase 5); float64 twin {out['logp64']['value']:.4f} in "
          f"{out['logp64']['fit_s']:.2f} s; LOO {out['loo']['value']:.4f} in "
          f"{out['loo']['fit_s']:.2f} s ({out['loo']['evaluations']} evaluations) against "
          f"scipy's {loo_opt:.4f} (phase 7b)", flush=True)
    require(abs(out["logp"]["value"] - map_logp) <= 0.5 + 1e-2 * abs(map_logp),
            f"11d logp {out['logp']['value']} vs scipy {map_logp}")
    require(out["loo"]["value"] >= loo_opt - 0.5,
            f"11d LOO {out['loo']['value']} vs scipy {loo_opt}")
    out["scipy_fit_s"] = map_s
    return out


@card_only
def phase11e(path_batched, steps=500):
    """ADVI on the n=125 workload: fit_advi over 500 steps, mc 8, full rank,
    then 4 x 50 draws and their logp, as sample_hypers(method='advi') makes
    them (which itself runs in 11h); the ELBO trace finite, scale_tril
    positive definite, the draws' lnprob against the float64 host."""
    wgp, x, y = bench_wgp("P11_ADVI")
    reg = wgp.active
    logp = wgp._sampling_logps()[0]
    with GradCounts() as cnt:
        t0 = time.perf_counter()
        fit = g3t.fit_advi(logp, reg.dict_to_array(wgp.params_default), steps=steps, mc=8,
                           lr=0.02, full_rank=True, seed=4)
        t_fit = time.perf_counter() - t0
        chain = g3t.advi_draws(fit, 4, 50, seed=5)
        with torch.no_grad():
            lnprob = logp(card_rows(chain.reshape(-1, reg.ndim))).cpu().numpy().reshape(4, 50)
    cnt.check("11e ADVI n=125", steps + 1, path_batched)
    eig = np.linalg.eigvalsh(fit.scale_tril @ fit.scale_tril.T)
    rows = chain[:, ::10, :].reshape(-1, reg.ndim)
    gap, inside = lnprob_gap(reg, rows, lnprob[:, ::10].ravel(), host_boxcox_logp, x, y)
    out = dict(fit_s=t_fit, ms_per_step=t_fit * 1e3 / steps,
               elbo_first=float(fit.elbo[0]), elbo_last=float(fit.elbo[-1]),
               converged=bool(fit.converged), min_eig=float(eig.min()), lnprob_gap=gap)
    print(f"  11e ADVI WGP n=125, {steps} steps x mc 8: {t_fit:.2f} s "
          f"({out['ms_per_step']:.3f} ms a step), ELBO {fit.elbo[0]:.3f} -> {fit.elbo[-1]:.3f}, "
          f"converged {fit.converged}, smallest eigenvalue of the covariance {eig.min():.3e}; "
          f"draws' lnprob vs the float64 host {gap:.2e} ({inside} of {len(rows)})", flush=True)
    require(np.isfinite(fit.elbo).all() and eig.min() > 0 and np.isfinite(chain).all(),
            "11e ADVI fit not finite or not positive definite")
    require(inside >= len(rows) // 2 and gap <= 1e-3, f"11e lnprob vs host {gap:.2e}")
    return out


NEUTRA_REPLAY = dict(warmup=10, key=0, chains=2, max_depth=5, target_accept=0.95,
                     adapt_mass="dense")


def neutra_probe(z0, rows, eps):
    """The float64 probes of 11f's replay on one model (the card's or the
    CPU's) through one flow: the pullback's value and gradient at ``rows``,
    then fixed-step NUTS (``eps``, unit mass, 2 chains, 5 samples, depth 5,
    HostDraws(13)) from ``z0`` and from ``z0`` + 1e-12."""

    def probe(wgp, flow):
        from g3py_tpu_torch.bayesian.samplers import value_and_grad

        logp = g3t.neutra_logp(wgp._sampling_logps()[0], flow)
        value, grad = value_and_grad(logp, card_rows(rows))
        chains = []
        for start in (z0, z0 + 1e-12):
            with HostDraws(13):
                chains.append(g3t.nuts_sampler(logp, start, 5, eps=eps, key=0, chains=2,
                                               max_depth=5)[0])
        return value.cpu().numpy(), grad.cpu().numpy(), chains

    return probe


def neutra_replay(flow, draws, path_batched):
    """11f's replay through ``flow`` (neutra_logp) on the n=125 workload from
    the latent images of two ensemble draws, with host draws.  Adapted NUTS
    (NEUTRA_REPLAY, 10 samples) on the card in float64 and float32, and in
    float64 through the whitening alone (no coupling): their step sizes
    tell float32 rounding and the couplings apart from the geometry of the
    draws.  The latent dynamics there is chaotic (a 1e-12 nudge to a start
    moves the CPU's own chain by ~1e-2 within a few transitions), so the
    card is held to the CPU in float64 (a) pointwise: the pullback's value
    and gradient at the adapted chain's states, to 1e-10; (b) along a
    fixed-step replay (the smallest adapted step size) to 1e-8, over the
    leading samples where the CPU's nudged replay stays within 1e-6 of its
    own (at least one)."""
    with torch.no_grad():
        flow64 = copy.deepcopy(flow).to(dtype=torch.float64)
        z0 = g3t.flow_inverse(flow64, torch.as_tensor(draws[:2], dtype=torch.float64,
                                                      device=flow64.mean.device))[0]
    z0 = z0.cpu().numpy()
    whitening, _ = g3t.fit_flow(draws, n_couplings=0)
    adapted = {}
    # the float64 replay (its states and smallest step size feed the probes)
    # takes NEUTRA_REPLAY's warmup and 6 samples; the float32 and whitening
    # ones, read for their adapted step sizes only, 4 + 2 (cut for time)
    for label, fl, dtype, samples, warmup in (
            ("float64", flow, "float64", 6, NEUTRA_REPLAY["warmup"]),
            ("float32", flow, "float32", 2, 4),
            ("whitening float64", whitening, "float64", 2, 4)):
        g3t.settings.floatx = dtype
        try:
            wgp, _, _ = bench_wgp(f"P11_NEUTRA_REPLAY_{len(adapted)}")
            fl = copy.deepcopy(fl).to(dtype=getattr(torch, dtype))
            with HostDraws(12), GradCounts() as cnt:
                adapted[label] = g3t.nuts_sampler(
                    g3t.neutra_logp(wgp._sampling_logps()[0], fl), z0, samples,
                    **dict(NEUTRA_REPLAY, warmup=warmup))
        finally:
            g3t.settings.floatx = "float32"
        cnt.check(f"11f NeuTra replay {label} on the card", 1 + cnt.leaves,
                  path_batched if dtype == "float32" else [0, 0])
    rows = adapted["float64"][0].reshape(-1, z0.shape[-1])
    eps = float(adapted["float64"][2]["step_size"].min())
    probe = neutra_probe(z0, rows, eps)
    g3t.settings.floatx = "float64"
    try:
        wgp, _, _ = bench_wgp("P11_NEUTRA_PROBE")
        with GradCounts() as cnt:
            card = probe(wgp, flow64)
    finally:
        g3t.settings.floatx = "float32"
    cnt.check("11f NeuTra probes on the card", 3 + cnt.leaves, [0, 0])
    t0 = time.perf_counter()
    cpu = replay_on_cpu(probe, "P11_NEUTRA_PROBE_CPU", flow)
    t_cpu = time.perf_counter() - t0
    gap_v, gap_g = (float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
                    for a, b in zip(card[:2], cpu[:2]))
    per_card = np.abs(card[2][0] - cpu[2][0]).max(axis=(0, 2))
    per_self = np.abs(cpu[2][1] - cpu[2][0]).max(axis=(0, 2))
    horizon = int(np.argmax(np.append(per_self, np.inf) > 1e-6))
    steps = {k: np.round(np.asarray(v[2]["step_size"], np.float64), 5).tolist()
             for k, v in adapted.items()}
    moved = {k: moved_share(v[0]) for k, v in adapted.items()}
    print(f"  11f NeuTra replay: adapted step sizes on the card {steps}, moved {moved}; "
          f"float64 card vs CPU: the pullback at the {len(rows)} adapted states, value gap "
          f"{gap_v:.2e}, gradient gap {gap_g:.2e}; fixed step {eps:.5f}, per sample card vs "
          f"CPU {np.array2string(per_card, precision=2)}, CPU vs its 1e-12-nudged start "
          f"{np.array2string(per_self, precision=2)} (held over {horizon}); CPU {t_cpu:.2f} s",
          flush=True)
    require(gap_v <= 1e-10 and gap_g <= 1e-10 and horizon >= 1
            and (per_card[:horizon] <= 1e-8).all() and min(moved.values()) > 0,
            f"11f NeuTra card vs CPU: pullback {gap_v:.2e} / {gap_g:.2e}, fixed-step "
            f"{per_card} over {horizon} (moved {moved})")
    return dict(step_size=steps, moved=moved, value_gap=gap_v, grad_gap=gap_g, eps=eps,
                fixed_step_gap=per_card.tolist(), nudge_gap=per_self.tolist(),
                horizon=horizon, cpu_s=t_cpu)


FLOW_STEPS = 500   # 11f's flow fit (bench.py:827-828 fits 1500; cut for time)


@card_only
def phase11f(path_batched, warmup=8, samples=8, ensemble=200):
    """NeuTra on the n=125 workload: 32 walkers x 200 ensemble warmup, then
    neutra_nuts on its second half through bench.py:827-828's flow (6
    couplings, hidden 32; FLOW_STEPS steps, cut from 1500 for time), fitted
    once, timed, and NUTS in the
    latent space (depth 6, target_accept 0.95, dense mass, 4 chains, warmup
    and samples 8 by default, 4 + 4 from ``phase11``: cut from 60 + 60 for
    time, its trees at depth ~6); the
    same flow gives the round trip and feeds the replay.  The ensemble's
    draws set the replay's latent geometry: 120 iterations gave a flow
    whose CPU replay left its own 1e-12-nudged twin at the first sample,
    so the replay had no horizon to hold; the ensemble costs ~1 s."""
    wgp, x, y = bench_wgp("P11_NEUTRA")
    reg = wgp.active
    with counted_calls(wgp) as calls, GradCounts() as ens:
        wchain, _ = wgp.sample_hypers(start=wgp.params_default, samples=ensemble, chains=32,
                                      noise_mult=0.05, raw=True, seed=5)
    ens.check("11f ensemble warmup", len(calls), path_batched)
    draws = wchain[:, ensemble // 2:, :].reshape(-1, reg.ndim)
    t0 = time.perf_counter()
    flow, losses = g3t.fit_flow(draws, n_couplings=6, hidden=32, steps=FLOW_STEPS, key=0)
    t_fit = time.perf_counter() - t0
    theta = card_rows(np.random.default_rng(6).standard_normal((7, reg.ndim)) * 0.5
                      + draws.mean(0))
    with torch.no_grad():
        z, ld_inv = g3t.flow_inverse(flow, theta)
        back, ld_fwd = g3t.flow_forward(flow, z)
    trip = float((back - theta).abs().max())
    trip_ld = float((ld_fwd + ld_inv).abs().max())
    require(trip <= 2e-4 + 2e-4 * float(theta.abs().max()) and trip_ld <= 1e-4 + 1e-4 * float(
        ld_fwd.abs().max()), f"11f flow round trip {trip:.2e} / {trip_ld:.2e}")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"11f NLL {losses[0]} -> {losses[-1]}")
    with GradCounts() as cnt:
        chain, lnprob, info = g3t.neutra_nuts(
            wgp._sampling_logps()[0], draws, samples, chains=4, warmup=warmup, key=7,
            max_depth=6, target_accept=0.95, n_couplings=6, hidden=32, fit_steps=FLOW_STEPS,
            adapt_mass="dense", flow=flow)
    cnt.check("11f neutra_nuts", 1 + cnt.leaves, path_batched)
    rows = chain[:, ::10, :].reshape(-1, reg.ndim)
    gap, inside = lnprob_gap(reg, rows, lnprob[:, ::10].ravel(), host_boxcox_logp, x, y)
    moved = moved_share(chain)
    info.pop("fit_nll")  # NaN: the flow came fitted
    fit_nll = float(losses[-1])
    info = nuts_info(info)
    out = dict(fit_s=t_fit, nll_first=float(losses[0]), nll_last=float(losses[-1]),
               round_trip=trip, neutra_nuts_s=cnt.seconds, fit_nll=fit_nll, leaves=cnt.leaves,
               lnprob_gap=gap, moved=moved, info=info)
    print(f"  11f NeuTra WGP n=125: ensemble 32 x {ensemble} {ens.seconds:.2f} s; fit_flow "
          f"{FLOW_STEPS} steps {t_fit:.2f} s (NLL {losses[0]:.3f} -> {losses[-1]:.3f}), round trip "
          f"{trip:.2e}; neutra_nuts through that flow {cnt.seconds:.2f} s, "
          f"{cnt.leaves} leaves, acceptance {info['accept_rate']}, mean tree "
          f"depth {info['mean_tree_depth']}, divergences {info['divergences']}, step sizes "
          f"{info['step_size']}, moved {moved:.3f}; lnprob vs the float64 host {gap:.2e} "
          f"({inside} of {len(rows)})", flush=True)
    require(np.isfinite(chain).all() and inside >= len(rows) // 2 and gap <= 1e-3,
            f"11f lnprob vs host {gap:.2e}")
    require(moved > 0, "11f: no chain moved")
    out["replay"] = neutra_replay(flow, draws, path_batched)
    return out


@card_only
def phase11g(path_batched, samples=50, steps=10):
    """hmc_sampler on the n=125 workload: 4 chains x 50 samples x 10
    leapfrog steps, one batched evaluation a leapfrog step."""
    wgp, x, y = bench_wgp("P11_HMC")
    reg = wgp.active
    u0 = reg.dict_to_array(wgp.params_default)
    with GradCounts() as cnt:
        chain, lnprob = g3t.hmc_sampler(wgp._sampling_logps()[0], u0, samples, key=8,
                                        step_size=0.01, leapfrog_steps=steps, chains=4)
    cnt.check("11g HMC n=125", 1 + samples * steps, path_batched)
    gap, inside = lnprob_gap(reg, chain[:, -1, :], lnprob[:, -1], host_boxcox_logp, x, y)
    moved = moved_share(chain)
    print(f"  11g HMC WGP n=125, 4 x {samples} x {steps}: {cnt.seconds:.2f} s "
          f"({cnt.seconds * 1e3 / cnt.evals:.3f} ms an evaluation), moved {moved:.3f}, final "
          f"lnprob vs the float64 host {gap:.2e}", flush=True)
    require(np.isfinite(lnprob).all() and inside == 4 and gap <= 1e-3,
            f"11g lnprob vs host {gap:.2e}")
    return dict(hmc_s=cnt.seconds, moved=moved, lnprob_gap=gap)


METHODS_11H = {
    "nuts": (dict(samples=6, nuts_warmup=6, max_depth=4, nuts_mass="dense",
                  target_accept=0.95), lambda leaves: 1 + leaves),
    "advi": (dict(samples=6, advi_steps=50), lambda leaves: 50 + 1),
    "neutra": (dict(samples=4, neutra_warmup=20, nuts_warmup=4, max_depth=4),
               lambda leaves: 2 * 20 + 1 + 1 + leaves)}


@card_only
def phase11h(path_batched):
    """sample_hypers(method=...) itself on the card: each gradient method on
    the n=125 workload with reparam='noncentered', 4 chains and a few
    iterations (METHODS_11H; 'neutra' with its default flow, after 20
    iterations of its ensemble).  Each run's launches equal its evaluations
    (NUTS: one a leaf and one for the starts; ADVI: one a step and one for
    the draws' lnprob; NeuTra: the ensemble's two a iteration and one for
    its starts, then NUTS's), every draw's lnprob against the float64
    host."""
    wgp, x, y = bench_wgp("P11_METHODS")
    reg = wgp.active
    out = {}
    for seed, (method, (kw, predict)) in enumerate(METHODS_11H.items(), start=9):
        with GradCounts() as cnt:
            chain, lnprob = wgp.sample_hypers(start=wgp.params_default, chains=4, method=method,
                                              reparam="noncentered", noise_mult=0.05,
                                              raw=True, seed=seed, **kw)
        cnt.check(f"11h sample_hypers(method={method!r})", predict(cnt.leaves), path_batched)
        rows = chain.reshape(-1, reg.ndim)
        gap, inside = lnprob_gap(reg, rows, lnprob.ravel(), host_boxcox_logp, x, y)
        moved = moved_share(chain)
        out[method] = dict(s=cnt.seconds, leaves=cnt.leaves, lnprob_gap=gap, moved=moved)
        print(f"  11h sample_hypers(method={method!r}) WGP n=125 non-centered, 4 x "
              f"{chain.shape[1]}: {cnt.seconds:.2f} s, lnprob vs the float64 host {gap:.2e} "
              f"({inside} of {len(rows)}), moved {moved:.3f}", flush=True)
        require(chain.shape == (4, kw["samples"], reg.ndim) and np.isfinite(chain).all()
                and inside >= len(rows) // 2 and gap <= 1e-3 and moved > 0,
                f"11h sample_hypers(method={method!r}): lnprob vs host {gap:.2e}, moved "
                f"{moved:.3f}")
    return out


PHASE11_RUNS = (phase11a, phase11b, phase11c, phase11d, phase11e, phase11f, phase11g,
                phase11h)


def phase11(gp, gp_map, x, y, map_s, loo_opt, path_batched):
    """Phase 11's runs; their batched launches go to ``path_batched``."""
    map_logp = float(gp.logp(gp_map))
    runs = (("11a", "NUTS, the n=125 sampler workload", lambda p: phase11a(p, warmup=4, samples=4)),
            ("11b", "NUTS card vs CPU replay (float64)", lambda p: phase11b(p)),
            ("11c", "NUTS at n=4096", lambda p: phase11c(gp, gp_map, x, y, p)),
            ("11d", "find_MAP(engine='jax') at n=4096",
             lambda p: phase11d(gp, x, y, map_logp, map_s, loo_opt, p)),
            ("11e", "ADVI at n=125", lambda p: phase11e(p)),
            ("11f", "NeuTra at n=125", lambda p: phase11f(p, warmup=4, samples=4)),
            ("11g", "HMC at n=125", lambda p: phase11g(p)),
            ("11h", "sample_hypers(method=...) at n=125", lambda p: phase11h(p)))
    out = {}
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        launched = [0, 0]
        out[key] = run(launched)
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s; batched launches K1 "
              f"{launched[0]}, K2 {launched[1]}", flush=True)
        path_batched[0] += launched[0]
        path_batched[1] += launched[1]
    div = {k: sum(out[k]["info"]["divergences"]) for k in ("11a", "11f")}
    print(f"  divergences of the 4 chains: NeuTra (11f) {div['11f']:g} against NUTS (11a) "
          f"{div['11a']:g}", flush=True)
    return out


# ---------------------------------------------------------------- phase 12
# The matrix-free path (ROADMAP item 11) at bench.py's
# mo_gp_nll_grad_evals_per_sec_n50k_p2 workload (bench.py:562-600): an ICM
# GP over 2 outputs of 25,000 points, SE([0]) + SE([0]) * KernelDot([1],
# Delta), noisy, Bias, Time_rate 0.3; rank 80, block 2048, cg_iters 100,
# probes 8.
MO_KW = dict(rank=80, block=2048, cg_iters=100, probes=8)
MO_N = 25_000           # points an output (n = 50,000)
CARD = "cuda"
PEAK_GB = 5.0           # half of one float32 50k x 50k gram
CARD_CPU_RTOL = 1e-8    # 12a: float64 card vs CPU, relative to each result's scale


def icm_data(n_mo, seed=0):
    """bench.py:566-575's data: one time axis, two outputs (the second
    0.6 x the first + 0.3), noise 0.05."""
    rng = np.random.default_rng(seed)
    t_ax = np.sort(rng.uniform(0, 100, n_mo)).astype(np.float32)
    x = np.concatenate([np.stack([t_ax, np.zeros(n_mo, np.float32)], 1),
                        np.stack([t_ax, np.ones(n_mo, np.float32)], 1)])
    f = np.sin(0.3 * t_ax)
    y = np.concatenate([f, 0.6 * f + 0.3]).astype(np.float32)
    y += 0.05 * rng.standard_normal(2 * n_mo).astype(np.float32)
    return x, y


def icm_gp(x, y, name):
    """bench.py:576-583's model and start (Time_rate 0.3) on the device and
    dtype of ``g3t.settings``."""
    from g3py_tpu_torch.hypers.kernels import KernelDot
    from g3py_tpu_torch.hypers.metrics import Delta

    se = g3t.SE([0], name="Time")
    gp = g3t.GP(space=x[:4], location=g3t.Bias(),
                kernel=se + se * KernelDot([1], metric=Delta, name="Coreg"), noisy=True,
                name=name)
    gp.observed(x, y)
    params = dict(gp.params_default)
    params[f"{name}_Time_rate"] = np.asarray([0.3], np.float32)
    return gp, params


def probe_draws(seed, probes, n):
    """Rademacher probes drawn by numpy on the host: the same numbers for
    every dtype and device (``slq`` and ``grad``, (probes, n))."""
    rng = np.random.default_rng(seed)
    return {k: rng.choice([-1.0, 1.0], size=(probes, n)) for k in ("slq", "grad")}


@contextlib.contextmanager
def port_on(device, floatx):
    """``g3t.settings`` on ``device`` in ``floatx`` for the block."""
    old = g3t.settings.device, g3t.settings.floatx
    g3t.settings.device, g3t.settings.floatx = device, floatx
    try:
        yield
    finally:
        g3t.settings.device, g3t.settings.floatx = old


def grams_k1(kernel, params, x):
    """K1 launches of one gram of ``kernel`` (2 for the ICM, 1 for an SE)."""
    stationary_gram.launches = 0
    kernel.cov(params, x[:4], x[:4])
    out = stationary_gram.launches
    stationary_gram.launches = 0
    return out


def predicted_k1(counts, n, block, per_gram):
    """K1 launches the slab passes predict: every lazy matvec and the
    gradient's pass build ceil(n / block) slabs, plus the diagonal's blocks
    and the pivot columns, each gram ``per_gram`` launches."""
    slabs = -(-n // block)
    return per_gram * ((counts["matvecs"] + counts["grad_passes"]) * slabs
                       + counts["diag_blocks"] + counts["columns"])


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def iterative_suite(x, y):
    """Every function of ops/iterative.py at the ICM's default params (and
    Time_rate 0.3) on n = len(x), on ``g3t.settings``' device and dtype,
    with host draws: results as host float64 arrays."""
    gp, p = icm_gp(x, y, "P12A")
    pt = gp._tensor_params(p)
    kern, xs = gp.f_kernel, gp._device_data("inputs")
    n, nv = xs.shape[0], pt["P12A_Noise_var"]
    rng = np.random.default_rng(12)
    v = g3t.config.as_tensor(rng.standard_normal((n, 4)))
    draws = probe_draws(13, 16, n)
    out = {"lazy_kernel_matvec": ITER.lazy_kernel_matvec(kern, pt, xs, v, block=600)}

    def mv(w):
        return ITER.lazy_kernel_matvec(kern, pt, xs, w, block=600) + nv * w

    diag = ITER._kernel_diag(kern, pt, xs, 600)
    lf = ITER.pivoted_cholesky(ITER._kernel_column(kern, pt, xs), diag, MO_KW["rank"])
    out["pivoted_cholesky"] = lf
    p_inv, p_isqrt, logdet_p = ITER.woodbury_preconditioner(lf, nv)
    out["woodbury_preconditioner"] = torch.cat([p_inv(v).ravel(), p_isqrt(v).ravel(),
                                                logdet_p.reshape(1)])
    out["cg_solve"] = ITER.cg_solve(mv, v.T, maxiter=300)
    out["pcg_solve"] = ITER.pcg_solve(mv, v[:, 0], p_inv, maxiter=100)
    out["pcg_solve (multi-RHS)"] = ITER.pcg_solve(mv, v.T, p_inv, maxiter=100)
    out["slq_logdet"] = ITER.slq_logdet(lambda w: p_isqrt(mv(p_isqrt(w))), n,
                                        g3t.config.as_tensor(draws["slq"]), lanczos_iters=25)
    k = (kern.cov(pt, xs) + nv * torch.eye(n, dtype=xs.dtype, device=xs.device)
         ).requires_grad_(True)
    r = g3t.config.as_tensor(y - y.mean()).requires_grad_(True)
    val = ITER.iterative_gp_nll(k, r, probes=16, cg_iters=300, lanczos_iters=30, seed=draws)
    val.backward()
    out["iterative_gp_nll"] = torch.cat([val.detach().reshape(1), k.grad.ravel(), r.grad])
    leaves = {name: t.detach().clone().requires_grad_(True) for name, t in pt.items()}
    nvl = leaves["P12A_Noise_var"]
    yl = g3t.config.as_tensor(y).requires_grad_(True)
    mean = (0.1 * torch.cos(0.05 * xs[:, 0])).requires_grad_(True)
    nll, info = ITER.preconditioned_gp_nll(kern, leaves, xs, yl, nvl, mean=mean,
                                           seed=probe_draws(14, 8, n), lanczos_iters=25,
                                           **MO_KW | dict(block=600))
    names = sorted(name for name in leaves if name != "P12A_Noise_var")
    grads = torch.autograd.grad(nll, [leaves[k] for k in names] + [nvl, yl, mean],
                                allow_unused=True)
    out["preconditioned_gp_nll"] = torch.cat(
        [nll.detach().reshape(1), info["cg_rel_residual"].reshape(1)]
        + [torch.zeros(1, dtype=xs.dtype, device=xs.device) if g is None else g.reshape(-1)
           for g in grads])
    return {key: t.detach().cpu().numpy().astype(np.float64) for key, t in out.items()}


def phase12a():
    """Every function of ops/iterative.py, float64, at n=1024 (bench's ICM,
    512 points an output, cut from 1024 for time; blocks of 600, the last
    ragged): the card
    (K1 on every slab) against the CPU (K1's plain form), each result
    within CARD_CPU_RTOL of the CPU's scale; no launch counted."""
    x, y = icm_data(512, seed=1)
    t0 = time.perf_counter()
    with port_on(CARD, "float64"):
        card = iterative_suite(x, y)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    with port_on("cpu", "float64"):
        cpu = iterative_suite(x, y)
    t_cpu = time.perf_counter() - t0
    gaps = {k: rel_gap(card[k], cpu[k]) for k in cpu}
    print(f"  12a float64 card vs CPU at n=1024 (card {t_card:.2f} s, CPU {t_cpu:.2f} s), "
          f"relative gaps: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()), flush=True)
    require(all(v <= CARD_CPU_RTOL for v in gaps.values()),
            f"12a card vs CPU above {CARD_CPU_RTOL:g}: {gaps}")
    return dict(gaps=gaps, card_s=t_card, cpu_s=t_cpu)


def k1_record(x1, x2, rate, var, label, kind="se"):
    """K1 on float32 (x1, x2), ``kind`` (SE by default), against its plain
    form: the kernel's CUDA-event time over 20 launches back to back (the
    record's), its profiler time a launch, the wrapper's and the plain
    form's CUDA-event times, and the bound (inputs read and output written
    once over 3.35 TB/s)."""
    out = stationary_gram(kind, x1, x2, rate, var)
    ref = _plain_form(kind, x1, x2, rate, var)
    err = float((out - ref).abs().max())
    require(err <= 1e-5 * float(var) and finite(out), f"{label} vs plain {err:.2e}")
    call = lambda: stationary_gram(kind, x1, x2, rate, var)
    t_wrap = event_ms(call)
    t_plain = event_ms(lambda: _plain_form(kind, x1, x2, rate, var), reps=10)
    t_dev = launch_ms(profile(call, reps=10), "stationary_gram_kernel")
    t_k = back_to_back_ms(k1_kernel(kind, x1, x2, rate, var))
    (m, d), n = x1.shape, x2.shape[0]
    bound = k1_bound_ms(m, n, d)
    print(f"  {label} ({m},{n},{d}) {kind.upper()} f32: kernel {t_k:.4f} ms (events, back to "
          f"back), "
          f"device {fmt_ms(t_dev)} (profiler, a launch), wrapper {t_wrap:.4f} ms, plain "
          f"{t_plain:.4f} ms, bound {bound:.4f} ms, max_abs_err {err:.2e}", flush=True)
    return dict(ms=t_k, device_ms=t_dev, wrapper_ms=t_wrap, plain_ms=t_plain, bound_ms=bound,
                max_abs_err=err)


def slab_k1():
    """K1 at the matrix-free path's slab shape (2048, 50000, 2)."""
    gen = torch.Generator(device=CARD).manual_seed(12)
    x1 = torch.randn(2048, 2, generator=gen, device=CARD)
    x2 = torch.randn(2 * MO_N, 2, generator=gen, device=CARD)
    return k1_record(x1, x2, torch.tensor([0.3, 0.7], device=CARD),
                     torch.tensor(1.3, device=CARD), "K1 slab")


def phase12b(path):
    """nll_iterative value and gradient at n=50,000 (bench's workload,
    float32): a warm evaluation, then timed ones, each with its K1
    launches held to the slab passes' prediction; peak allocated memory
    below PEAK_GB, the CG residual below 5e-2, a finite gradient, the value
    within 1e-2 of the same estimator in float64 (the same host draws)."""
    from g3py_tpu_torch.ops.iterative import _trace_grads

    x, y = icm_data(MO_N)
    n = len(x)
    gp, p = icm_gp(x, y, "P12B")
    reg = gp.active
    u0 = reg.dict_to_array(p)
    draws = probe_draws(7, MO_KW["probes"], n)
    xs = gp._device_data("inputs")
    per_gram = grams_k1(gp.f_kernel, gp._tensor_params(p), xs)

    def evaluate():
        u = torch.tensor(u0, device=CARD, requires_grad=True)
        value, info = gp.nll_iterative(reg.array_to_dict_tensor(u), seed=draws, **MO_KW)
        (grad,) = torch.autograd.grad(value, u)
        torch.cuda.synchronize()
        return value.detach(), info, grad

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    evaluate()  # warm
    times, runs = [], []
    for _ in range(1):
        zero_counts()
        ITER.reset_counts()
        t0 = time.perf_counter()
        value, info, grad = evaluate()
        times.append(time.perf_counter() - t0)
        counts = dict(ITER.counts)
        k1 = stationary_gram.launches
        want = predicted_k1(counts, n, MO_KW["block"], per_gram)
        runs.append(dict(k1=k1, predicted=want, **counts))
        require(k1 == want, f"12b K1 x{k1}, predicted {want} from {counts}")
        path[0] += k1
        path[1] += panel_cholesky.launches
    peak = torch.cuda.max_memory_allocated()
    t_eval = statistics.median(times)
    resid = float(info["cg_rel_residual"])
    require(peak < PEAK_GB * 1e9, f"12b peak allocated {peak / 1e9:.2f} GB >= {PEAK_GB} GB")
    require(resid < 5e-2 and finite(grad) and math.isfinite(float(value)),
            f"12b residual {resid:.2e}, gradient {grad}")
    # the slab-wise gradient pass alone, and one forward matvec, at the
    # evaluation's shapes: the pass less the matvec is the backward of the
    # slabs (the autograd of K1's plain form and the ICM's products)
    params = gp._tensor_params(p)
    leaves = [t.detach().clone().requires_grad_(True) for t in params.values()]
    w = torch.ones((n, MO_KW["probes"] + 1), device=CARD)
    t0 = time.perf_counter()
    _trace_grads(gp.f_kernel, list(params), leaves, xs, w, w, MO_KW["block"])
    torch.cuda.synchronize()
    t_grad_pass = time.perf_counter() - t0
    t0 = time.perf_counter()
    ITER.lazy_kernel_matvec(gp.f_kernel, params, xs, w, block=MO_KW["block"])
    torch.cuda.synchronize()
    t_matvec = time.perf_counter() - t0
    with port_on(CARD, "float64"), torch.no_grad():
        gp64, p64 = icm_gp(x, y, "P12B64")
        value64, info64 = gp64.nll_iterative(p64, seed=draws, **MO_KW)
    gap64 = abs(float(value) - float(value64)) / abs(float(value64))
    print(f"  12b nll_iterative value+gradient, ICM n={n} float32: {t_eval:.3f} s an "
          f"evaluation ({1 / t_eval:.3f} evals/s; all {[round(t, 3) for t in times]}); value "
          f"{float(value):.4f} (float64 {float(value64):.4f}, gap {gap64:.2e}); CG residual "
          f"{resid:.2e}; |grad| {float(grad.norm()):.4e}; peak allocated {peak / 1e9:.3f} GB "
          f"({(peak - before) / 1e9:.3f} GB above the {before / 1e9:.3f} GB before); per "
          f"evaluation {runs[-1]}; K1 launches a gram {per_gram}; the gradient's slab pass "
          f"{t_grad_pass:.3f} s against a forward matvec {t_matvec:.3f} s "
          f"(their difference {100 * (t_grad_pass - t_matvec) / t_eval:.1f}% of an "
          f"evaluation)", flush=True)
    require(gap64 <= 1e-2, f"12b float32 vs float64 value gap {gap64:.2e}")
    return dict(eval_s=t_eval, evals_per_s=1 / t_eval, times=times, value=float(value),
                value64=float(value64), gap64=gap64, residual=resid, peak_gb=peak / 1e9,
                runs=runs, per_gram=per_gram, grad_pass_s=t_grad_pass, matvec_s=t_matvec,
                backward_share=(t_grad_pass - t_matvec) / t_eval)


def phase12c(x, y):
    """GP(Bias, SE) at phase 3's n=16384, d=8, float64, probes 32: the
    matrix-free NLL against the exact -loglike through K2 (tut09's 5e-2), a
    step along its -gradient lowers the exact NLL, and its gradient's
    relative error against the exact dlogp."""
    kw = dict(rank=40, cg_iters=200, probes=32)
    with port_on(CARD, "float64"):
        gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="P12C")
        gp.observed(x, y)
        reg = gp.active
        u0 = torch.tensor(reg.dict_to_array(gp.params_default), device=CARD,
                          requires_grad=True)
        t0 = time.perf_counter()
        value, info = gp.nll_iterative(reg.array_to_dict_tensor(u0), seed=3, **kw)
        (grad,) = torch.autograd.grad(value, u0)
        value = value.detach()
        torch.cuda.synchronize()
        t_it = time.perf_counter() - t0
        u = u0.detach().cpu().numpy()
        exact = -gp.loglike(u, array=True)
        # -dlogp less the prior's gradient is the exact -dloglike
        prior_grad = gp._array_grad(gp._logp_pure(prior=True), u)
        exact_grad = -(gp.dlogp(u) - prior_grad)
        g = grad.cpu().numpy()
        step = u - 1e-3 * g / max(np.abs(g).max(), 1.0)
        lowered = -gp.loglike(step, array=True)
    gap = abs(float(value) - exact) / abs(exact)
    grad_err = float(np.linalg.norm(g - exact_grad) / np.linalg.norm(exact_grad))
    print(f"  12c GP(Bias, SE) n={len(x)} d={x.shape[1]} float64, probes 32: nll_iterative "
          f"{float(value):.4f} against the exact {exact:.4f} (gap {gap:.2e}), CG residual "
          f"{float(info['cg_rel_residual']):.2e}, {t_it:.2f} s; gradient vs exact: relative "
          f"error {grad_err:.3e}; exact NLL after a step along -grad {lowered:.4f} "
          f"({lowered - exact:+.4e})", flush=True)
    require(gap <= 5e-2, f"12c nll_iterative vs exact {gap:.2e}")
    require(lowered < exact, f"12c a step along -grad did not lower the NLL ({exact} -> {lowered})")
    return dict(value=float(value), exact=exact, gap=gap, grad_rel_err=grad_err,
                step_delta=lowered - exact, s=t_it)


def phase12d(gp, x, y, map_logp, map_s, path):
    """find_MAP(engine='iterative') at phase 5's n=4096 (float32), loop
    'host' and 'device', a few iterations each: both end trusted, the
    exact logp rises from the start, the gap to phase 5's scipy MAP; each
    run's K1 launches equal its slab passes' prediction (the device loop:
    one gradient pass an evaluation)."""
    from g3py_tpu_torch.bayesian.optimize_jax import lbfgs_minimize_guarded

    kw = dict(rank=64, block=2048, cg_iters=100, probes=8)
    start = gp.logp(gp.params_default)
    per_gram = grams_k1(gp.f_kernel, gp._tensor_params(gp.params_default),
                        gp._device_data("inputs"))
    out = {}
    for loop, iters in (("host", 4), ("device", 4)):
        zero_counts()
        ITER.reset_counts()
        lbfgs_minimize_guarded.evaluations = 0
        t0 = time.perf_counter()
        params = gp.find_MAP(engine="iterative", loop=loop, max_iters=iters, display=False, **kw)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        counts = dict(ITER.counts)
        k1 = stationary_gram.launches
        want = predicted_k1(counts, len(x), kw["block"], per_gram)
        path[0] += k1
        path[1] += panel_cholesky.launches
        after = gp.logp(params)
        out[loop] = dict(fit_s=t_fit, logp=after, k1=k1, predicted=want, **counts)
        evals = (lbfgs_minimize_guarded.evaluations if loop == "device"
                 else counts["grad_passes"])
        print(f"  12d find_MAP(engine='iterative', loop={loop!r}, max_iters={iters}) n={len(x)}: "
              f"logp {start:.4f} -> {after:.4f} in {t_fit:.2f} s (scipy MAP {map_logp:.4f} in "
              f"{map_s:.2f} s, gap {map_logp - after:.4f}); {evals} evaluations, K1 x{k1}, "
              f"predicted {want} from {counts}", flush=True)
        require(after > start and math.isfinite(after), f"12d {loop}: logp {start} -> {after}")
        require(k1 == want and counts["grad_passes"] == evals > 0,
                f"12d {loop}: K1 x{k1}, predicted {want}, {evals} evaluations, {counts}")
    return out


def phase12e(gp, gp_map, x, path):
    """IterativePredictor: at n=4096 (phase 5's GP at its MAP) against the
    dense Predictor (tut09's 5e-3) with exact_var=True, in float32 and with
    dtype='float64', and its pathwise sampler's moments; at n=50,000 (the
    ICM at bench's start) the set-up, a batch of 256 with each exact_var,
    the peak memory."""
    rng = np.random.default_rng(21)
    xq = rng.standard_normal((256, x.shape[1])).astype(np.float32)
    dense = on_card(gp.predictor(gp_map)(xq))
    out = {}
    for dtype in (None, "float64"):
        zero_counts()
        t0 = time.perf_counter()
        pr = gp.predictor_iterative(gp_map, rank=64, cg_iters=200, dtype=dtype)
        got = pr(xq, exact_var=True)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        path[0] += stationary_gram.launches
        got = on_card(got)
        gaps = {k: float((got[k] - dense[k]).abs().max()
                         / (5e-3 + 5e-3 * float(dense[k].abs().max()))) for k in ("mean", "std")}
        out[dtype or "float32"] = dict(s=t, residual=pr.cg_rel_residual, gaps=gaps)
        print(f"  12e IterativePredictor n=4096 ({dtype or 'float32'}): set-up + a batch of "
              f"256 {t:.3f} s, CG residual {pr.cg_rel_residual:.2e}; vs the dense Predictor "
              f"(share of 5e-3 + 5e-3 |x|) {gaps}", flush=True)
        require(max(gaps.values()) <= 1.0, f"12e n=4096 {dtype}: {gaps}")
    # pathwise draws against the predictor's moments
    samples = 512
    zero_counts()
    draws = on_card(pr.sampler(space=xq[:64], samples=samples, key=0, n_features=4096))
    path[0] += stationary_gram.launches
    mu, sd = on_card(pr.mean(xq[:64])), on_card(pr.std(xq[:64]))
    z_mean = float(((draws.mean(1) - mu).abs() / (sd / math.sqrt(samples))).max())
    z_std = float(((draws.std(1) - sd).abs() / (sd / math.sqrt(2 * samples))).max())
    print(f"  12e sampler: {samples} paths at 64 points, |mean - mu| {z_mean:.2f} and |std - sd| "
          f"{z_std:.2f} standard errors at most", flush=True)
    require(finite(draws) and z_mean <= 5 and z_std <= 5,
            f"12e sampler moments {z_mean:.2f} / {z_std:.2f} standard errors")
    out["sampler"] = dict(z_mean=z_mean, z_std=z_std)
    # n = 50,000: bench's ICM at its start
    xm, ym = icm_data(MO_N)
    mo, p = icm_gp(xm, ym, "P12E")
    xq = np.stack([np.linspace(0, 100, 256), np.arange(256) % 2], 1).astype(np.float32)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    pr = mo.predictor_iterative(p, rank=80, block=2048, cg_iters=200)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    batch = {}
    for exact in (True, False):
        t0 = time.perf_counter()
        got = pr(xq, exact_var=exact)
        torch.cuda.synchronize()
        batch[exact] = time.perf_counter() - t0
        require(all(finite(v) for v in got.values()) and bool((got["std"] > 0).all()),
                f"12e n=50000 exact_var={exact}: statistics not finite and positive")
    path[0] += stationary_gram.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"  12e IterativePredictor ICM n=50000: set-up {t_setup:.3f} s (CG residual "
          f"{pr.cg_rel_residual:.2e}), a batch of 256 exact_var=True {batch[True]:.3f} s, "
          f"exact_var=False {batch[False]:.3f} s; peak allocated {peak / 1e9:.3f} GB",
          flush=True)
    require(peak < PEAK_GB * 1e9, f"12e peak allocated {peak / 1e9:.2f} GB")
    out["n50000"] = dict(setup_s=t_setup, batch_exact_s=batch[True], batch_sketch_s=batch[False],
                         peak_gb=peak / 1e9, residual=pr.cg_rel_residual)
    return out


def phase12(tgp, gp_map, x_map, y_map, map_s, x3, y3, path):
    """Phase 12's runs; the K1 launches of 12b's timed evaluations, 12d's
    fits and 12e's float32 predictors go to ``path``."""
    print(f"  float32 products: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()!r} (ops/iterative.py sets 'highest' inside)",
          flush=True)
    map_logp = float(tgp.logp(gp_map))
    out = {}
    runs = (("12a", "float64 card vs CPU at n=1024", lambda: phase12a()),
            ("12k", "K1 at the slab shape", slab_k1),
            ("12b", "nll_iterative at n=50000", lambda: phase12b(path)),
            ("12c", "nll_iterative vs exact at n=16384", lambda: phase12c(x3, y3)),
            ("12d", "find_MAP(engine='iterative') at n=4096",
             lambda: phase12d(tgp, x_map, y_map, map_logp, map_s, path)),
            ("12e", "IterativePredictor", lambda: phase12e(tgp, gp_map, x_map, path)))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 13
# The sparse families (ROADMAP item 12's first half) at bench.py's
# sgpr_elbo_grad_evals_per_sec_n100k_m512 workload (bench.py:512-554): n =
# 100,000 points, d = 8, m = 512 explicit inducing inputs x[::195][:512]
# (trainable), SGP(Bias, SE).  Every check is against a float64
# recomputation on the host (torch on the CPU, the script's own formulas,
# differentiated by autograd for the gradient checks).
SP_N, SP_M, SP_D = 100_000, 512, 8
SP_SVGP_STEPS = 200       # 13c: fit_svgp steps a mode at batch 1024
HOST_THREADS = 8


def sparse_data(n=None, seed=13):
    """bench.py:518-523's data (its own rng stream) and inducing inputs."""
    n = SP_N if n is None else n
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, SP_D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y, x[::max(n // SP_M, 1)][:SP_M].copy()


def host_tvalues(reg, u):
    """Natural-space float64 CPU tensors at the unconstrained float64 tensor
    ``u`` (differentiable), keyed by the full Param name."""
    out, start = {}, 0
    for par in reg.ordered_params:
        seg = u[start:start + par.size].reshape(par.shape)
        out[par.name] = torch.exp(seg) if par.prior.transform.name == "log" else seg
        start += par.size
    return out


def host_se64(a, b, rate, var):
    """var exp(-|(a - b) rate|^2 / 2) in float64 on the host."""
    return var * torch.exp(-0.5 * _sq(a * rate, b * rate))


def host_whitened(v, name, z, x):
    """(Luu, V = Luu^{-1} Kuf) of an SE signal kernel."""
    rate, var = v[f"{name}_SE_rate"], v[f"{name}_SE_var"]
    luu = torch.linalg.cholesky(host_se64(z, z, rate, var))
    return luu, torch.linalg.solve_triangular(luu, host_se64(z, x, rate, var), upper=False)


def host_sgp_bound(reg, u, x, y, name):
    """The collapsed bound of SGP(Bias, SE) (Titsias 2009) at ``u``, float64:
    log N(r | 0, V'V + s2 I) - tr(Kff - V'V) / (2 s2) by Woodbury."""
    v = host_tvalues(reg, u)
    s2, var = v[f"{name}_Noise_var"], v[f"{name}_SE_var"]
    _, vv = host_whitened(v, name, v[f"{name}_Inducing_z"], x)
    m, n = vv.shape
    r = y - v[f"{name}_Bias_Bias"]
    lbt = torch.linalg.cholesky(s2 * torch.eye(m, dtype=x.dtype) + vv @ vv.T)
    cw = torch.linalg.solve_triangular(lbt, (vv @ r)[:, None], upper=False)[:, 0]
    quad = r @ r - cw @ cw
    trace = (var - (vv * vv).sum(0)).sum()
    return (-0.5 * n * math.log(2 * math.pi) - 0.5 * (n - m) * torch.log(s2)
            - torch.log(torch.diagonal(lbt)).sum() - 0.5 * (quad + trace) / s2)


def host_value_grad(fn, u):
    """``fn`` and its autograd gradient at the host float64 vector ``u``."""
    ut = torch.tensor(np.asarray(u, np.float64), requires_grad=True)
    with torch.enable_grad():
        val = fn(ut)
        (grad,) = torch.autograd.grad(val, ut)
    return float(val.detach()), grad.numpy()


def directional_gaps(g, ref, seed):
    """Relative gaps of the card gradient ``g`` to the host's ``ref`` along
    two random directions, and of the whole vector (2-norm)."""
    dirs = np.random.default_rng(seed).standard_normal((2, len(ref)))
    gaps = [abs(float(d @ g) - float(d @ ref)) / abs(float(d @ ref)) for d in dirs]
    return gaps, float(np.linalg.norm(g - ref) / np.linalg.norm(ref))


def card_value_grad(proc, u, like_only=True):
    """The card's float32 loglike (or logp) and gradient at ``u``, synced."""
    val, grad = proc._value_and_grad(proc._logp_pure(like_only=like_only),
                                     torch.as_tensor(u, dtype=torch.float32, device=CARD))
    torch.cuda.synchronize()
    return float(val), grad.cpu().numpy().astype(np.float64)


def with_host_threads(fn):
    old = torch.get_num_threads()
    torch.set_num_threads(HOST_THREADS)
    try:
        return fn()
    finally:
        torch.set_num_threads(old)


def sparse_k2(a, label="B~ = s2 I + V V'"):
    """K2 at m=512 on the SGP's B~ (4 panels of 128), or at another small m
    (``label`` names the matrix), float32: against its plain form; its CUDA-event time over 20 calls back to back (the
    record's), one call's, its profiler time a call, beside cholesky_ex's
    and the plain form's; and the bound (:func:`k2_bound`)."""
    n = a.shape[0]
    lk, dinv, info = panel_cholesky(a)
    lp, dinv_p, info_p = k2_plain_form(a)
    require(int(info) == 0 and int(info_p) == 0, f"K2 info {int(info)} at m={n} ({label})")
    res, d_err = k2_checks(lk, dinv, a)
    err = float((lk - lp).abs().max())
    l_gap = float(torch.linalg.matrix_norm(lk - lp) / torch.linalg.matrix_norm(lp))
    require(res <= 4 * math.sqrt(n) * torch.finfo(a.dtype).eps and l_gap <= K2_TOL[a.dtype][0]
            and d_err <= K2_TOL[a.dtype][1], f"K2 m={n} ({label}): residual {res:.2e}, |L-Lp| "
            f"{l_gap:.2e}, panels {d_err:.2e}")
    t_k = back_to_back_ms(lambda: panel_cholesky(a))
    t_one = event_ms(lambda: panel_cholesky(a), reps=20)
    t_dev = per_call_ms(profile(lambda: panel_cholesky(a), reps=10), K2_NAMES, "prep_kernel")
    t_p = event_ms(lambda: k2_plain_form(a), reps=10)
    t_lib = back_to_back_ms(lambda: torch.linalg.cholesky_ex(a))
    t_lib_one = event_ms(lambda: torch.linalg.cholesky_ex(a), reps=20)
    bound, bound_by = k2_bound(n, block=dinv.shape[-1])
    print(f"  K2 m={n} f32 ({label}): kernel {t_k:.4f} ms (events, back to back; "
          f"one call {t_one:.4f} ms), device {fmt_ms(t_dev)} (profiler, a call); plain "
          f"{t_p:.4f} ms; cholesky_ex {t_lib:.4f} ms back to back ({t_lib_one:.4f} ms one "
          f"call); bound {bound:.5f} ms ({bound_by}); residual {res:.2e}, max abs err "
          f"{err:.2e}", flush=True)
    return dict(ms=t_k, one_call_ms=t_one, device_ms=t_dev, plain_ms=t_p, library_ms=t_lib,
                library_one_call_ms=t_lib_one, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


def phase13a(x, y, z, path):
    """SGP(Bias, SE) at bench's n=100,000, d=8, m=512 (trainable inducing
    inputs), float32: the bound's value and gradient (through K1's backward
    into the inducing inputs) against the float64 host; seconds an
    evaluation (logp + gradient, as bench.py times it, the median of 5
    after a warm one), K1 and K2 launches an evaluation against the
    prediction (Kuu and Kuf: 2 K1; Kuu and B~: 2 K2; the diagonal none),
    the peak allocated memory; then K1 at (512, 100000, 8) and K2 at m=512."""
    sgp = g3t.SGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), inducing=z,
                  name="P13A")
    sgp.observed(x, y)
    reg = sgp.active
    params = sgp.params_default
    u = reg.dict_to_array(params)
    pure = sgp._logp_pure()
    ut = torch.as_tensor(u, device=CARD)

    def evaluate():
        val, grad = sgp._value_and_grad(pure, ut)
        torch.cuda.synchronize()
        return val, grad

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    evaluate()  # warm
    times, per_eval = [], []
    for _ in range(5):
        zero_counts()
        t0 = time.perf_counter()
        val, grad = evaluate()
        times.append(time.perf_counter() - t0)
        k1, k2, retries = launches()
        per_eval.append((k1, k2, retries))
        path[0] += k1
        path[1] += k2
        require(k1 == 2 and k2 == 2 + retries, f"13a an evaluation launched K1 x{k1}, K2 x{k2} "
                f"({retries} jitter retries), predicted K1 x2, K2 x2 + retries")
    peak = torch.cuda.max_memory_allocated()
    t_eval = statistics.median(times)
    require(math.isfinite(float(val)) and finite(grad), "13a value or gradient not finite")
    # where an evaluation's time goes: its device events by kernel
    t_dev = top_ops(profile(evaluate, reps=3), "13a SGP logp + gradient n=100000 (3 evaluations)")
    idle = None if t_dev <= 0 else max(0.0, 1.0 - t_dev / 3 / (t_eval * 1e3))
    # the bound alone (no prior terms) against the float64 host
    got, g = card_value_grad(sgp, u)
    x64, y64, z64 = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, z))
    t0 = time.perf_counter()
    ref, g_ref = with_host_threads(lambda: host_value_grad(
        lambda uu: host_sgp_bound(reg, uu, x64, y64, "P13A"), u))
    t_host = time.perf_counter() - t0
    gap = abs(got - ref) / abs(ref)
    dgaps, norm_gap = directional_gaps(g, g_ref, 13)
    z_grad = float(np.linalg.norm(g[-SP_M * SP_D:]))
    print(f"  13a SGP(Bias, SE) n={len(x)} d={x.shape[1]} m={len(z)} float32: logp + gradient "
          f"{t_eval * 1e3:.1f} ms an evaluation ({1 / t_eval:.2f} evals/s; all "
          f"{[round(t * 1e3, 1) for t in times]} ms); K1/K2/retries an evaluation {per_eval}; "
          f"peak allocated {peak / 1e9:.3f} GB ({(peak - before) / 1e9:.3f} GB above the "
          f"{before / 1e9:.3f} GB before); bound {got:.4f} vs the float64 host {ref:.4f} (gap "
          f"{gap:.2e}); gradient along two directions {[f'{v:.2e}' for v in dgaps]}, whole "
          f"{norm_gap:.2e}, |d/dz| {z_grad:.3e}; device {t_dev / 3:.2f} ms an evaluation "
          f"(idle share {'not measured' if idle is None else f'{idle:.3f}'}); host "
          f"{t_host:.1f} s", flush=True)
    require(gap <= 1e-3 and max(dgaps) <= 1e-2,
            f"13a bound vs host {gap:.2e}, gradient {dgaps}")
    require(z_grad > 0, "13a no gradient reached the inducing inputs")
    p = sgp._tensor_params(params)
    k1rec = k1_record(torch.as_tensor(z, device=CARD), sgp._device_data("inputs"),
                      p["P13A_SE_rate"], p["P13A_SE_var"], "13 K1 cross gram")
    state = sgp.posterior_state(params)
    k2rec = sparse_k2(state["_state_sgp_bt"].contiguous())
    out = dict(eval_s=t_eval, evals_per_s=1 / t_eval, times=times, launches=per_eval,
               peak_gb=peak / 1e9, bound=got, bound64=ref, gap=gap, grad_gaps=dgaps,
               grad_norm_gap=norm_gap, host_s=t_host, device_ms=t_dev / 3, idle=idle,
               k1=k1rec, k2=k2rec)
    return sgp, params, out


def host_sparse_posterior(reg, u, x, y, xq, name):
    """The SGPR posterior mean and latent std at ``xq`` in float64:
    loc + u2' cw and sqrt(var - |tmp1|^2 + s2 |u2|^2)."""
    v = host_tvalues(reg, torch.as_tensor(u, dtype=torch.float64))
    z = v[f"{name}_Inducing_z"]
    s2, var = v[f"{name}_Noise_var"], v[f"{name}_SE_var"]
    luu, vv = host_whitened(v, name, z, x)
    m = vv.shape[0]
    lbt = torch.linalg.cholesky(s2 * torch.eye(m, dtype=x.dtype) + vv @ vv.T)
    cw = torch.linalg.solve_triangular(lbt, (vv @ (y - v[f"{name}_Bias_Bias"]))[:, None],
                                       upper=False)[:, 0]
    tmp1 = torch.linalg.solve_triangular(luu, host_se64(z, xq, v[f"{name}_SE_rate"], var),
                                         upper=False)
    u2 = torch.linalg.solve_triangular(lbt, tmp1, upper=False)
    mean = v[f"{name}_Bias_Bias"] + u2.T @ cw
    std = torch.sqrt(torch.clamp(var - (tmp1 * tmp1).sum(0) + s2 * (u2 * u2).sum(0), min=0.0))
    return mean.numpy(), std.numpy()


def phase13b(sgp, params, x, y, z, path):
    """The SGP Predictor from 13a's params: 8 batches of 256 (mean, std,
    quantiles) against the float64 host's sparse posterior; ``updated``
    with 256 new points against a fresh state on all the points; 512
    pathwise paths at 64 points against the predictor's moments."""
    reg = sgp.active
    u = reg.dict_to_array(params)
    rng = np.random.default_rng(131)
    with counted(path):
        t0 = time.perf_counter()
        pr = sgp.predictor(params)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
    x64, y64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    times, gaps = [], []
    for b in range(8):
        xq = rng.standard_normal((256, SP_D)).astype(np.float32)
        with counted(path):
            t0 = time.perf_counter()
            out = pr(xq, quantiles=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if b < 2:
            mean, std = with_host_threads(lambda: host_sparse_posterior(
                reg, u, x64, y64, torch.as_tensor(xq, dtype=torch.float64), "P13A"))
            gaps.append({k: rel_gap(np.asarray(out[k]), ref)
                         for k, ref in (("mean", mean), ("std", std))})
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"  13b SGP Predictor n={len(x)} m={len(z)}: set-up {t_setup * 1e3:.1f} ms, a batch "
          f"of 256 (mean, std, quantiles) median {statistics.median(times) * 1e3:.2f} ms; vs "
          f"the float64 host (2 batches) {worst}", flush=True)
    require(max(worst.values()) <= 1e-3, f"13b predictor vs host {worst}")
    # streaming: 256 new points onto the first n - 256
    n0 = len(x) - 256
    old = g3t.SGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), inducing=z, name="P13A")
    old.observed(x[:n0], y[:n0])
    base = old.predictor(params)
    with counted(path):
        t0 = time.perf_counter()
        upd = base.updated(x[n0:], y[n0:])
        torch.cuda.synchronize()
        t_upd = time.perf_counter() - t0
    xq = rng.standard_normal((256, SP_D)).astype(np.float32)
    got, fresh = upd(xq), pr(xq)
    upd_gap = {k: rel_gap(got[k], fresh[k]) for k in ("mean", "std")}
    print(f"  13b updated: 256 points onto {n0} in {t_upd * 1e3:.2f} ms (a fresh set-up "
          f"{t_setup * 1e3:.1f} ms); vs the fresh state {upd_gap}", flush=True)
    require(max(upd_gap.values()) <= 1e-3, f"13b updated vs fresh {upd_gap}")
    # pathwise draws of the sparse state
    samples = 512
    with counted(path):
        t0 = time.perf_counter()
        draws = pr.pathwise_sampler(space=xq[:64], samples=samples, key=0, n_features=4096)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
    mu, sd = on_card(fresh["mean"][:64]), on_card(fresh["std"][:64])
    z_mean = float(((draws.mean(1) - mu).abs() / (sd / math.sqrt(samples))).max())
    z_std = float(((draws.std(1) - sd).abs() / (sd / math.sqrt(2 * samples))).max())
    print(f"  13b pathwise: {samples} paths at 64 points in {t_path * 1e3:.1f} ms; |mean - mu| "
          f"{z_mean:.2f} and |std - sd| {z_std:.2f} standard errors at most", flush=True)
    require(finite(draws) and z_mean <= 5 and z_std <= 5,
            f"13b pathwise moments {z_mean:.2f} / {z_std:.2f} standard errors")
    return dict(setup_s=t_setup, batch_s=statistics.median(times), host_gaps=worst,
                updated_s=t_upd, updated_gaps=upd_gap, pathwise_s=t_path, z_mean=z_mean,
                z_std=z_std)


def phase13c(sgp, x_map, y_map, path):
    """fit_svgp at bench's n=100,000 (batch 1024, SP_SVGP_STEPS steps, Adam
    and natgrad=0.2): the loss falls, the launches a step as predicted
    (Adam: K1 x2, K2 x1; natgrad: K1 x2, K2 x2); at phase 5's n=4096 in
    full batch, natgrad=1.0: one step is the collapsed optimum (its loss is
    -logp at the start, 1e-3)."""
    out = {}
    for natgrad, k2_step in ((None, 1), (0.2, 2)):
        zero_counts()
        t0 = time.perf_counter()
        _, losses = sgp.fit_svgp(batch_size=1024, steps=SP_SVGP_STEPS, lr=1e-2, key=3,
                                 natgrad=natgrad, display=False)
        t_fit = time.perf_counter() - t0
        k1, k2, retries = launches()
        path[0] += k1
        path[1] += k2
        k = max(SP_SVGP_STEPS // 10, 1)
        head, tail = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        mode = "adam" if natgrad is None else f"natgrad {natgrad}"
        out[mode] = dict(s=t_fit, ms_step=t_fit * 1e3 / SP_SVGP_STEPS, loss_head=head,
                         loss_tail=tail, k1=k1, k2=k2)
        print(f"  13c fit_svgp[{mode}] n={len(sgp.inputs)} batch 1024, {SP_SVGP_STEPS} steps: "
              f"{t_fit:.2f} s ({t_fit * 1e3 / SP_SVGP_STEPS:.2f} ms a step), -elbo (mean of {k}) "
              f"{head:.1f} -> {tail:.1f}; K1 x{k1}, K2 x{k2} ({retries} retries)", flush=True)
        require(np.isfinite(losses).all() and tail < head, f"13c {mode}: loss {head} -> {tail}")
        require(k1 == 2 * SP_SVGP_STEPS and k2 == k2_step * SP_SVGP_STEPS + retries,
                f"13c {mode}: K1 x{k1}, K2 x{k2}, predicted {2 * SP_SVGP_STEPS} / "
                f"{k2_step * SP_SVGP_STEPS} + {retries}")
    small = g3t.SGP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.SE(x_map),
                    inducing=x_map[::8][:SP_M], name="P13C")
    small.observed(x_map, y_map)
    p0 = small.params_default
    with counted(path):
        _, losses = small.fit_svgp(batch_size=len(x_map), steps=1, lr=1e-12, natgrad=1.0,
                                   display=False)
    logp = small.logp(p0)
    gap = abs(-float(losses[0]) - logp) / abs(logp)
    print(f"  13c fit_svgp natgrad=1.0 full batch n={len(x_map)} m={SP_M}: one step's -loss "
          f"{-float(losses[0]):.4f} vs the collapsed logp {logp:.4f} (gap {gap:.2e})",
          flush=True)
    require(gap <= 1e-3, f"13c natgrad one step vs the collapsed optimum {gap:.2e}")
    out["collapsed_gap"] = gap
    return out


def host_svp_elbo(reg, u, x, y, name, kind):
    """The uncollapsed ELBO of an SVP(Bias | Zero, SE) with whitened q in
    float64: sum_i E_q[log p(y_i | f_i)] - KL(q || N(0, I)), the expectation
    by 20-point Gauss-Hermite (StudentT, Bernoulli) or in closed form
    (the heteroscedastic lognormal moments, the categorical Jensen
    bound)."""
    v = host_tvalues(reg, u)
    z = v[f"{name}_Inducing_z"]
    _, vv = host_whitened(v, name, z, x)
    qm, ql = v[f"{name}_Q_qm"], v[f"{name}_Q_ql"]
    heads = qm.shape[0] if qm.ndim == 2 else None
    qm_h = qm if heads else qm[None]
    ql_h = ql if heads else ql[None]
    lq = torch.tril(ql_h, -1) + torch.diag_embed(torch.exp(torch.diagonal(ql_h, dim1=-2,
                                                                          dim2=-1)))
    loc = v.get(f"{name}_Bias_Bias", torch.zeros((), dtype=x.dtype))
    mf = loc + qm_h @ vv                                       # (H, n)
    lv = lq.transpose(-1, -2) @ vv                             # (H, m, n)
    varf = torch.clamp(v[f"{name}_SE_var"] - (vv * vv).sum(0), min=0.0) + (lv * lv).sum(1)
    kl = 0.5 * ((qm_h * qm_h).sum() + (lq * lq).sum()
                - 2.0 * torch.diagonal(ql_h, dim1=-2, dim2=-1).sum() - qm_h.numel())
    if kind == "multiclass":
        ell = (torch.gather(mf, 0, y.long()[None])[0]
               - torch.logsumexp(mf + 0.5 * varf, dim=0)).sum()
        return ell - kl
    if kind == "heteroscedastic":
        b = v[f"{name}_HetLik_bias"]
        m1, m2, v1, v2 = mf[0], mf[1] + b, varf[0], varf[1]
        prec = torch.exp(torch.clamp(-m2 + 0.5 * v2, -30.0, 30.0))
        ell = (-0.5 * (math.log(2 * math.pi) + m2) - 0.5 * ((y - m1) ** 2 + v1) * prec).sum()
        return ell - kl
    a, w = np.polynomial.hermite.hermgauss(20)
    a, w = torch.as_tensor(a), torch.as_tensor(w) / math.sqrt(math.pi)
    f = mf[0][None, :] + math.sqrt(2.0) * torch.sqrt(varf[0])[None, :] * a[:, None]
    if kind == "studentt":
        s2, nu = v[f"{name}_StudentTLik_var"], v[f"{name}_StudentTLik_nu"]
        lp = (torch.lgamma((nu + 1) / 2) - torch.lgamma(nu / 2) - 0.5 * torch.log(nu * math.pi * s2)
              - (nu + 1) / 2 * torch.log1p((y[None, :] - f) ** 2 / s2 / nu))
    else:  # bernoulli (probit)
        lp = torch.special.log_ndtr((2.0 * y[None, :] - 1.0) * f)
    return (w @ lp).sum() - kl


def svp_model(kind, x, y, z):
    name = "P13D_" + kind
    if kind == "multiclass":
        return g3t.MulticlassSVP(space=x[:4], kernel=g3t.SE(x), classes=3, inducing=z, name=name)
    if kind == "heteroscedastic":
        return g3t.HeteroscedasticSVP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x),
                                      inducing=z, name=name)
    lik = g3t.StudentTLik() if kind == "studentt" else g3t.BernoulliLik()
    return g3t.SVP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), likelihood=lik,
                   inducing=z, name=name)


def phase13d(x, f_true, z, path):
    """The sparse variational family at n=100,000, m=512, float32: SVP with
    StudentTLik (robust regression) and BernoulliLik (probit),
    MulticlassSVP (3 classes) and HeteroscedasticSVP, each at a q off the
    prior (seeded): the ELBO and its gradient against the float64 host (1e-3
    / 1e-2 along two random directions), K1 x2 and K2 x1 an evaluation,
    its seconds."""
    rng = np.random.default_rng(134)
    targets = {
        "studentt": f_true + 0.1 * rng.standard_t(3.0, len(f_true)),
        "bernoulli": (f_true + 0.3 * rng.standard_normal(len(f_true)) > 0).astype(np.float64),
        "multiclass": np.digitize(f_true, [-0.5, 0.5]).astype(np.float64),
        "heteroscedastic": f_true + (0.05 + 0.1 * np.abs(x[:, 1])) * rng.standard_normal(
            len(f_true))}
    x64 = torch.as_tensor(x, dtype=torch.float64)
    z64 = torch.as_tensor(z, dtype=torch.float64)
    out = {}
    for i, (kind, y) in enumerate(targets.items()):
        y = y.astype(np.float32)
        proc = svp_model(kind, x, y, z)
        proc.observed(x, y)
        reg = proc.active
        params = dict(proc.params_default)
        qr = np.random.default_rng(135 + i)
        for k, val in params.items():
            if k.endswith("_qm"):
                params[k] = (0.1 * qr.standard_normal(np.shape(val))).astype(np.float32)
            elif k.endswith("_ql"):
                params[k] = (0.05 * qr.standard_normal(np.shape(val))).astype(np.float32)
        u = reg.dict_to_array(params)
        card_value_grad(proc, u)  # warm
        zero_counts()
        t0 = time.perf_counter()
        got, g = card_value_grad(proc, u)
        t_eval = time.perf_counter() - t0
        k1, k2, retries = launches()
        path[0] += k1
        path[1] += k2
        y64 = torch.as_tensor(y, dtype=torch.float64)
        t0 = time.perf_counter()
        ref, g_ref = with_host_threads(lambda: host_value_grad(
            lambda uu: host_svp_elbo(reg, uu, x64, y64, proc.name, kind), u))
        t_host = time.perf_counter() - t0
        gap = abs(got - ref) / abs(ref)
        dgaps, norm_gap = directional_gaps(g, g_ref, 136 + i)
        out[kind] = dict(eval_s=t_eval, elbo=got, elbo64=ref, gap=gap, grad_gaps=dgaps,
                         grad_norm_gap=norm_gap, k1=k1, k2=k2, host_s=t_host)
        print(f"  13d {type(proc).__name__}({kind}) n={len(x)} m={len(z)} float32: ELBO + "
              f"gradient {t_eval * 1e3:.1f} ms; K1 x{k1}, K2 x{k2} ({retries} retries); ELBO "
              f"{got:.4f} vs the float64 host {ref:.4f} (gap {gap:.2e}); gradient along two "
              f"directions {[f'{v:.2e}' for v in dgaps]}, whole {norm_gap:.2e}; host "
              f"{t_host:.1f} s", flush=True)
        require(k1 == 2 and k2 == 1 + retries, f"13d {kind}: K1 x{k1}, K2 x{k2}")
        require(gap <= 1e-3 and max(dgaps) <= 1e-2,
                f"13d {kind}: ELBO vs host {gap:.2e}, gradient {dgaps}")
    return out


def phase13e(x_map, y_map, path_batched):
    """sample_hypers on SGP(Bias, SE) at phase 5's n=4096 data, m=256 fixed
    inducing inputs: 16 walkers x 20 iterations, each half-ensemble one
    batched call (K1 x2: Kuu and Kuf of all rows; K2 x2: Kuu and B~ of all
    rows, plus jitter retries)."""
    sgp = g3t.SGP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.SE(x_map),
                  inducing=x_map[::16][:256], learn_inducing=False, name="P13E")
    sgp.observed(x_map, y_map)
    with counted_calls(sgp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain, lnprob = sgp.sample_hypers(start=sgp.params_default, samples=20, chains=16,
                                          noise_mult=0.05, raw=True, seed=13)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    path_batched[0] += k1
    path_batched[1] += k2
    moved = moved_share(chain)
    print(f"  13e SGP sampler n={len(x_map)} m=256, 16 x 20: {t_s:.2f} s, {len(calls)} batched "
          f"calls of {sorted(set(calls))} rows; K1 x{k1}, K2 x{k2} ({retries} retries); moved "
          f"{moved:.3f}", flush=True)
    require(np.isfinite(lnprob).all() and moved > 0, "13e: lnprob not finite or no move")
    require(k1 == 2 * len(calls) and k2 == 2 * len(calls) + retries,
            f"13e K1 x{k1}, K2 x{k2} for {len(calls)} batched calls ({retries} retries)")
    return dict(s=t_s, calls=len(calls), k1=k1, k2=k2, moved=moved)


def phase13(x_map, y_map, path, path_batched):
    """Phase 13's runs; the launches of 13a's timed evaluations, 13b's
    predictor, 13c's fits and 13d's evaluations go to ``path``, 13e's
    batched ones to ``path_batched``."""
    x, y, z = sparse_data()
    out = {}
    print("phase 13a: SGP n=100000 m=512, the bound and its gradient", flush=True)
    t0 = time.perf_counter()
    sgp, params, out["13a"] = phase13a(x, y, z, path)
    out["13a"]["wall_s"] = time.perf_counter() - t0
    runs = (("13b", "the SGP Predictor, updated and pathwise",
             lambda: phase13b(sgp, params, x, y, z, path)),
            ("13c", "fit_svgp", lambda: phase13c(sgp, x_map, y_map, path)),
            ("13d", "the SVP family at n=100000",
             lambda: phase13d(x, np.sin(x[:, 0]).astype(np.float64), z, path)),
            ("13e", "the SGP sampler at n=4096", lambda: phase13e(x_map, y_map, path_batched)))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 14
# Items 8 and 12 of the port: deep kernel learning, the linear model of
# coregionalization, the SVP family's batched rows, the datatrace toolkit
# and the Experiment harness, each on K1 and K2 at full width against a
# float64 host recomputation.
DKL_WIDTHS = (32, 32, 2)
LMC_M = 512               # 14b: inducing inputs (bench's sparse width)
LMC_STEPS = 50            # 14b: fit_svgp steps at batch 1024
PATH_FEATURES = 16384     # 14a: random Fourier features of the pathwise prior (at 4096
#                           the fitted posterior sd is below the features' own error)


def host_dkl(v, name, x, widths=DKL_WIDTHS):
    """The DeepKernel's tanh MLP features of ``x`` from the natural values
    ``v`` (float64 on the host)."""
    h = x
    for i in range(len(widths)):
        h = h @ v[f"{name}_DeepKernel_w{i}"] + v[f"{name}_DeepKernel_b{i}"]
        if i < len(widths) - 1:
            h = torch.tanh(h)
    return h


def host_dkl_parts(v, name, x):
    f = host_dkl(v, name, x)
    rate, var = v[f"{name}_DeepKernel_SE_rate"], v[f"{name}_DeepKernel_SE_var"]
    return f, rate, var


def host_dkl_loglike(reg, u, x, y, name):
    """GP(Bias, DeepKernel(SE)) loglike at ``u`` in float64 on the host."""
    v = host_tvalues(reg, u)
    f, rate, var = host_dkl_parts(v, name, x)
    k = host_se64(f, f, rate, var) + v[f"{name}_Noise_var"] * torch.eye(len(x),
                                                                      dtype=x.dtype)
    chol = torch.linalg.cholesky(k)
    r = y - v[f"{name}_Bias_Bias"]
    z = torch.linalg.solve_triangular(chol, r[:, None], upper=False)[:, 0]
    return (-0.5 * len(x) * math.log(2 * math.pi) - 0.5 * z @ z
            - torch.log(torch.diagonal(chol)).sum())


def host_dkl_posterior(reg, u, x, y, xq, name, dtype=torch.float64):
    """The posterior mean and latent std at ``xq`` in ``dtype`` on the host."""
    with torch.no_grad():
        v = {k: t.to(dtype) for k, t in host_tvalues(reg, torch.as_tensor(
            np.asarray(u, np.float64))).items()}
        x, y, xq = (torch.as_tensor(a, dtype=dtype) for a in (x, y, xq))
        f, rate, var = host_dkl_parts(v, name, x)
        fq = host_dkl(v, name, xq)
        k = host_se64(f, f, rate, var) + v[f"{name}_Noise_var"] * torch.eye(len(x), dtype=dtype)
        chol = torch.linalg.cholesky(k)
        cross = host_se64(fq, f, rate, var)
        alpha = torch.cholesky_solve((y - v[f"{name}_Bias_Bias"])[:, None], chol)[:, 0]
        w = torch.linalg.solve_triangular(chol, cross.T, upper=False)
        mean = v[f"{name}_Bias_Bias"] + cross @ alpha
        std = torch.sqrt(torch.clamp(var - (w * w).sum(0), min=0.0))
    return {"mean": mean.numpy(), "std": std.numpy()}


def pickled_tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` through dicts, lists, tuples and
    the port's objects' attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif type(obj).__module__.startswith("g3py_tpu_torch") and hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for item in items for t in pickled_tensors(item, seen)]


def phase14a(x, y, path, path_batched):
    """GP(Bias, DeepKernel(SE, widths=(32, 32, 2))) at phase 5's n=4096,
    d=8, float32: logp and dlogp (K1 x1 over the features, K2 x1 an
    evaluation) against the float64 host (1e-3; 1e-2 along two random
    directions), K1's gradient into both inputs of the square gram against
    its plain form, find_MAP(engine='jax') raising the logp, a Predictor
    batch of 256 against the host posterior, 512 pathwise paths' moments,
    and the registry pickled with CPU tensors only; then K1 at the square
    (4096, 4096, 2) gram of the features against its plain form and its
    bound (the features record's, whose launches are those of the timed
    evaluations, one square gram each).  find_MAP's batched L-BFGS goes
    to ``path_batched`` (as 11d's and 14e's), the rest to ``path``."""
    name = "P14A"
    dgp = g3t.GP(space=x[:4], location=g3t.Bias(),
                 kernel=g3t.DeepKernel(g3t.SE, x, widths=DKL_WIDTHS), name=name)
    dgp.observed(x, y)
    reg = dgp.active
    params = dgp.params_default
    u = reg.dict_to_array(params)
    card_value_grad(dgp, u)  # warm
    times, per_eval = [], []
    for _ in range(3):
        with counted(path):
            t0 = time.perf_counter()
            got, g = card_value_grad(dgp, u)
            times.append(time.perf_counter() - t0)
            k1, k2, retries = launches()
        per_eval.append((k1, k2, retries))
        require(k1 == 1 and k2 == 1 + retries, f"14a logp+dlogp launched K1 x{k1}, K2 x{k2}")
    x64, y64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    t0 = time.perf_counter()
    ref, g_ref = with_host_threads(lambda: host_value_grad(
        lambda uu: host_dkl_loglike(reg, uu, x64, y64, name), u))
    t_host = time.perf_counter() - t0
    gap = abs(got - ref) / abs(ref)
    dgaps, norm_gap = directional_gaps(g, g_ref, 141)
    print(f"  14a DKL GP n={len(x)} widths {DKL_WIDTHS} ({reg.ndim} params) float32: logp + "
          f"dlogp {statistics.median(times) * 1e3:.1f} ms; K1/K2/retries {per_eval}; loglike "
          f"{got:.4f} vs the float64 host {ref:.4f} (gap {gap:.2e}); gradient along two "
          f"directions {[f'{v:.2e}' for v in dgaps]}, whole {norm_gap:.2e}; host "
          f"{t_host:.1f} s", flush=True)
    require(gap <= 1e-3 and max(dgaps) <= 1e-2, f"14a vs host {gap:.2e}, gradient {dgaps}")
    # K1's gradient into both inputs of the square gram (the features)
    dk = dgp.f_kernel
    p = dgp._tensor_params(params)
    rate, var = p[f"{name}_DeepKernel_SE_rate"], p[f"{name}_DeepKernel_SE_var"]
    with torch.enable_grad():
        f = dk.features(p, dgp._device_data("inputs")).detach().requires_grad_(True)
        cot = torch.randn(len(x), len(x), device=CARD, generator=torch.Generator(
            device=CARD).manual_seed(14))
        (g_k1,) = torch.autograd.grad(stationary_gram("se", f, f, rate, var), f, cot)
        (g_plain,) = torch.autograd.grad(_plain_form("se", f, f, rate, var), f, cot)
    both_gap = rel_gap(g_k1.cpu().numpy(), g_plain.cpu().numpy())
    print(f"  14a K1 gradient into both inputs ({len(x)} x {f.shape[1]} features): vs the plain form "
          f"{both_gap:.2e}", flush=True)
    require(finite(g_k1) and both_gap <= 1e-3, f"14a K1 both-input gradient {both_gap:.2e}")
    k1rec = k1_record(f.detach(), f.detach(), rate, var, "14a K1 square gram over the features")
    # find_MAP by the batched L-BFGS
    before = dgp.logp(params)
    with counted(path_batched):
        t0 = time.perf_counter()
        fit = dgp.find_MAP(start=params, points=1, engine="jax", max_iters=20, display=False)
        t_fit = time.perf_counter() - t0
        k1_fit, k2_fit, _ = launches()
    require(k1_fit > 0 and k2_fit > 0, f"14a find_MAP launched K1 x{k1_fit}, K2 x{k2_fit}")
    after = dgp.logp(fit)
    print(f"  14a find_MAP(engine='jax', 20 iterations) {t_fit:.2f} s: logp {before:.2f} -> "
          f"{after:.2f}", flush=True)
    require(after > before, f"14a find_MAP did not raise the logp ({before} -> {after})")
    # a Predictor batch and pathwise paths from the fitted params
    uf = reg.dict_to_array(fit)
    xq = np.random.default_rng(142).standard_normal((256, x.shape[1])).astype(np.float32)
    with counted(path):
        pr = dgp.predictor(fit)
        out = pr(xq)
        torch.cuda.synchronize()
    ref_s = host_dkl_posterior(reg, uf, x, y, xq, name)
    gaps = {k: rel_gap(out[k], ref_s[k]) for k in ref_s}

    def witness():
        w32 = host_dkl_posterior(reg, uf, x, y, xq, name, torch.float32)
        return max(rel_gap(w32[k], ref_s[k]) for k in ref_s)

    limit = held(max(gaps.values()), 1e-3, witness, "14a Predictor batch vs host")
    samples = 512
    with counted(path):
        t0 = time.perf_counter()
        draws = pr.pathwise_sampler(space=xq, samples=samples, key=0, n_features=PATH_FEATURES)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
    mu, sd = on_card(out["mean"]), on_card(out["std"])
    z_mean = float(((draws.mean(1) - mu).abs() / (sd / math.sqrt(samples))).max())
    z_std = float(((draws.std(1) - sd).abs() / (sd / math.sqrt(2 * samples))).max())
    print(f"  14a Predictor batch of 256 vs the float64 host {gaps} (limit {limit:.1e}); "
          f"{samples} pathwise paths in {t_path * 1e3:.1f} ms, |mean - mu| {z_mean:.2f} and "
          f"|std - sd| {z_std:.2f} standard errors at most", flush=True)
    require(finite(draws) and z_mean <= 5 and z_std <= 5,
            f"14a pathwise moments {z_mean:.2f} / {z_std:.2f} standard errors")
    # the registry pickles with every tensor on the CPU (a CPU host loads it)
    import pickle

    blob = pickle.dumps(reg)
    devices = {t.device.type for t in pickled_tensors(pickle.loads(blob))}
    loaded = pickle.loads(blob)
    reload_gap = abs(loaded.components[name].logp(fit) - after) / abs(after)
    print(f"  14a the registry pickled ({len(blob) / 1e6:.2f} MB): tensor devices {devices}; "
          f"the reloaded process's logp vs the live one {reload_gap:.1e}", flush=True)
    require(devices <= {"cpu"} and reload_gap <= 1e-6, f"14a registry pickle: {devices}, "
            f"{reload_gap:.1e}")
    return dict(eval_s=statistics.median(times), launches=per_eval, loglike=got, loglike64=ref,
                gap=gap, grad_gaps=dgaps, both_inputs_gap=both_gap, fit_s=t_fit,
                logp=[before, after], predictor_gaps=gaps, pathwise_s=t_path, z_mean=z_mean,
                z_std=z_std, host_s=t_host, k1=k1rec,
                features_launches=sum(e[0] for e in per_eval))


def lmc_data():
    """bench's sparse data split into P=2 outputs of 50,000 rows (the second
    a scaled, shifted mixture of the first's signal), its inducing
    features."""
    x, y, z = sparse_data()
    half = len(x) // 2
    y1 = (-0.6 * np.sin(x[half:, 0]) + 0.3 * np.cos(x[half:, 1]) + 0.5
          + 0.1 * np.random.default_rng(143).standard_normal(len(x) - half)).astype(np.float32)
    xs, ys = g3t.stack_outputs([x[:half], x[half:]], [y[:half], y1])
    return xs.astype(np.float32), ys.astype(np.float32), z[:LMC_M]


def host_lmc_elbo(reg, u, x, y, name, kernels):
    """The LMC's uncollapsed ELBO in float64 on the host: whitened heads of
    each latent's SE kernel (``kernels`` their names, one shared or one a
    latent), mixed per output, the analytic gaussian expectation, minus
    the heads' KL."""
    v = host_tvalues(reg, u)
    z, xf, idx = v[f"{name}_Inducing_z"], x[:, :-1], x[:, -1].long()
    qm, ql = v[f"{name}_Q_qm"], v[f"{name}_Q_ql"]
    lq = torch.tril(ql, -1) + torch.diag_embed(torch.exp(torch.diagonal(ql, dim1=-2, dim2=-1)))
    mfs, varfs, cache = [], [], {}
    for q in range(qm.shape[0]):
        kname = kernels[q % len(kernels)]
        if kname not in cache:
            rate, var = v[f"{name}_{kname}_rate"], v[f"{name}_{kname}_var"]
            luu = torch.linalg.cholesky(host_se64(z, z, rate, var))
            cache[kname] = (var, torch.linalg.solve_triangular(luu, host_se64(z, xf, rate, var),
                                                               upper=False))
        var, vv = cache[kname]
        lv = lq[q].T @ vv
        mfs.append(qm[q] @ vv)
        varfs.append(torch.clamp(var - (vv * vv).sum(0), min=0.0) + (lv * lv).sum(0))
    w, b = v[f"{name}_Mix_w"], v[f"{name}_Mix_b"]
    s2 = torch.clamp(v[f"{name}_MultiGaussLik_var"], min=1e-10)[idx]
    wr = w[idx]
    mg = v[f"{name}_Bias_Bias"] + b[idx] + sum(wr[:, q] * mfs[q] for q in range(len(mfs)))
    vg = sum(wr[:, q] ** 2 * varfs[q] for q in range(len(mfs)))
    ell = (-0.5 * (math.log(2 * math.pi) + torch.log(s2)) - ((y - mg) ** 2 + vg) / (2 * s2)).sum()
    kl = 0.5 * ((qm * qm).sum() + (lq * lq).sum()
                - 2.0 * torch.diagonal(ql, dim1=-2, dim2=-1).sum() - qm.numel())
    return ell - kl


def captured_latent_calls(lmc, u):
    """One (uncounted) evaluation of ``lmc`` at ``u`` with its K1 calls and
    its factorization's input recorded: the arguments that the kernels
    module hands to the fused gram (the latents' stacked rates and
    amplitudes on the shared inputs) and the (Q, m, m) Kuu stack that
    ``safe_cholesky`` factors."""
    import g3py_tpu_torch.hypers.kernels as kmod
    import g3py_tpu_torch.models.lmc as lmod

    grams, kuus = [], []
    inner_k1, inner_chol = kmod.stationary_gram, lmod.safe_cholesky

    def k1_spy(kind, x1, x2, rate, var, extra=None):
        grams.append((kind, x1.detach(), x2.detach(), rate.detach(), var.detach(),
                      None if extra is None else extra.detach()))
        return inner_k1(kind, x1, x2, rate, var, extra)

    def chol_spy(a, *args, **kw):
        kuus.append(a.detach())
        return inner_chol(a, *args, **kw)

    kmod.stationary_gram, lmod.safe_cholesky = k1_spy, chol_spy
    try:
        card_value_grad(lmc, u)
    finally:
        kmod.stationary_gram, lmod.safe_cholesky = inner_k1, inner_chol
    return grams, kuus


def latent_k1_record(grams, m, n):
    """The per-latent LMC's K1 launches (the latents' rates and amplitudes
    as rows on shared 2-D inputs), at the Kuu (Q, m, m) and Kuf (Q, m, n)
    shapes, against the plain form row by row (phase 6a's tolerance); the
    Kuf launch's CUDA-event time over 20 launches back to back (the
    record's), the wrapper's and the plain form's, and the bound."""
    rtol, atol_rel = TOL[torch.float32]
    err, shapes = 0.0, []
    for kind, x1, x2, rate, var, extra in grams:
        require(x1.ndim == 2 and rate.ndim == 2, f"14b latents' K1 inputs {tuple(x1.shape)}, "
                f"rates {tuple(rate.shape)}: expected shared inputs and a rate a latent")
        out = stationary_gram(kind, x1, x2, rate, var, extra)
        for q in range(rate.shape[0]):
            ref = _plain_form(kind, x1, x2, rate[q], var[q],
                              None if extra is None else extra[q])
            gap = (out[q] - ref).abs()
            require(bool((gap <= atol_rel * var.max() + rtol * ref.abs()).all())
                    and finite(out[q]), f"14b latent {q} K1 ({x1.shape[0]},{x2.shape[0]}) vs "
                    f"plain {float(gap.max()):.2e}")
            err = max(err, float(gap.max()))
        shapes.append((rate.shape[0], x1.shape[0], x2.shape[0], x1.shape[1]))
    require(sorted(s[2] for s in shapes) == [m, n], f"14b latents' K1 shapes {shapes}")
    kind, x1, x2, rate, var, extra = next(g for g in grams if g[2].shape[0] == n)
    q, d = rate.shape
    t_k = back_to_back_ms(k1_kernel(kind, x1, x2, rate, var, extra))
    t_wrap = event_ms(lambda: stationary_gram(kind, x1, x2, rate, var, extra), reps=10)
    t_plain = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra), reps=5)
    bound = k1_bound_ms(m, n, d, q)
    print(f"  14b K1 over the latents {shapes} {kind} f32: every row matches the plain form "
          f"(max abs err {err:.2e}); at ({q},{m},{n},{d}) kernel {t_k:.4f} ms (events, back to "
          f"back), wrapper {t_wrap:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms",
          flush=True)
    return dict(ms=t_k, wrapper_ms=t_wrap, plain_ms=t_plain, bound_ms=bound, bound_by="bytes",
                library_ms=None, max_abs_err=err, shapes=shapes)


def latent_k2_record(a, label="14b latent"):
    """The per-latent LMC's one batched K2 launch over the Q Kuu, against
    the plain form row by row (phase 6b's checks); its CUDA-event time over
    20 calls back to back (the record's), the plain form's, cholesky_ex's
    on the same stack (a call: the batched call waits on the host, so back
    to back would time the stream's sleep) and the bound."""
    q, m = a.shape[0], a.shape[-1]
    l_tol, d_tol = K2_TOL[a.dtype]
    lk, dinv, info = panel_cholesky(a)
    require(lk.shape == (q, m, m) and not bool(info.any()), f"{label}s' K2 info {info}")
    err = 0.0
    for r in range(q):
        lp, _, info_p = k2_plain_form(a[r])
        res, d_err = k2_checks(lk[r], dinv[r], a[r])
        l_gap = float(torch.linalg.matrix_norm(lk[r] - lp) / torch.linalg.matrix_norm(lp))
        require(res <= 4 * math.sqrt(m) * torch.finfo(a.dtype).eps and l_gap <= l_tol
                and d_err <= d_tol and int(info_p) == 0, f"{label} {r} K2: residual "
                f"{res:.2e}, |L-Lp|/|Lp| {l_gap:.2e}, panels {d_err:.2e}")
        err = max(err, float((lk[r] - lp).abs().max()))
    t_k = back_to_back_ms(lambda: panel_cholesky(a))
    t_p = event_ms(lambda: k2_plain_form(a), reps=5)
    t_lib = event_ms(lambda: torch.linalg.cholesky_ex(a))
    bound, bound_by = k2_bound(m, rows=q, block=dinv.shape[-1])
    print(f"  {label}s' K2 ({q},{m},{m}) f32: every row matches the plain form "
          f"(max abs err {err:.2e}); kernel {t_k:.4f} ms (events, back to back), plain "
          f"{t_p:.4f} ms, cholesky_ex {t_lib:.4f} ms a call, bound {bound:.5f} ms ({bound_by})",
          flush=True)
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


def phase14b(path, path_batched):
    """LMCSVP at bench's sparse width: P=2 outputs of 50,000 rows (n=100,000),
    d=8, m=512, Q=2, float32, with one shared SE kernel and with one SE
    kernel a latent: the ELBO and its gradient against the float64 host
    (1e-3; 1e-2 along two random directions), K1 x2 and K2 x1 an
    evaluation (the per-latent grams one batched K1 launch each, the two
    Kuu one batched K2 launch), seconds an evaluation, the peak allocated
    memory, fit_svgp at batch 1024 (the loss falls) and
    task_correlations; for per-latent kernels, the captured K1 launches
    (Kuu and Kuf) and the Kuu stack's K2 launch against their plain forms
    row by row (the latents records).  The shared kernel's launches go to
    ``path``, the per-latent ones (the latents are a batched launch's rows)
    to ``path_batched``, and are returned as the latents records'
    launches."""
    x, y, z = lmc_data()
    x64, y64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    out = {}
    for mode, kernels in (("shared", ("SE",)), ("per_latent", ("SA", "SB"))):
        name = "P14B_" + mode
        record = path if mode == "shared" else path_batched
        feats = x[:, :-1]
        kernel = (g3t.SE(feats) if mode == "shared"
                  else [g3t.SE(feats, name="SA"), g3t.SE(feats, name="SB")])
        lmc = g3t.LMCSVP(space=x[:4], location=g3t.Bias(), kernel=kernel, outputs_dim=2,
                         latents=2, inducing=z, name=name)
        lmc.observed(x, y)
        reg = lmc.active
        params = dict(lmc.params_default)
        qr = np.random.default_rng(144)
        for k, val in params.items():
            if k.endswith("_qm"):
                params[k] = (0.1 * qr.standard_normal(np.shape(val))).astype(np.float32)
            elif k.endswith("_ql"):
                params[k] = (0.05 * qr.standard_normal(np.shape(val))).astype(np.float32)
        u = reg.dict_to_array(params)
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if mode == "per_latent":  # warms, and captures the launches' inputs
            grams, kuus = captured_latent_calls(lmc, u)
        else:
            card_value_grad(lmc, u)  # warm
        times, per_eval = [], []
        for _ in range(3):
            with counted(record):
                t0 = time.perf_counter()
                got, g = card_value_grad(lmc, u)
                times.append(time.perf_counter() - t0)
                k1, k2, retries = launches()
            per_eval.append((k1, k2, retries))
            require(k1 == 2 and k2 == 1 + retries,
                    f"14b {mode}: an evaluation launched K1 x{k1}, K2 x{k2}")
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        ref, g_ref = with_host_threads(lambda: host_value_grad(
            lambda uu: host_lmc_elbo(reg, uu, x64, y64, name, kernels), u))
        t_host = time.perf_counter() - t0
        gap = abs(got - ref) / abs(ref)
        dgaps, norm_gap = directional_gaps(g, g_ref, 145)
        with counted(record):
            t0 = time.perf_counter()
            fit, losses = lmc.fit_svgp(batch_size=1024, steps=LMC_STEPS, lr=0.01, start=params,
                                       key=0, display=False)
            t_fit = time.perf_counter() - t0
            k1f, k2f, retries_f = launches()
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        corr = lmc.task_correlations(fit)
        print(f"  14b LMCSVP {mode} n={len(x)} P=2 Q=2 m={len(z)} float32: ELBO + gradient "
              f"{statistics.median(times) * 1e3:.1f} ms an evaluation; K1/K2/retries "
              f"{per_eval}; peak allocated {peak / 1e9:.3f} GB; ELBO {got:.2f} vs the float64 "
              f"host {ref:.2f} (gap {gap:.2e}); gradient along two directions "
              f"{[f'{v:.2e}' for v in dgaps]}, whole {norm_gap:.2e}; host {t_host:.1f} s; "
              f"fit_svgp {LMC_STEPS} steps at batch 1024 {t_fit:.2f} s (K1 x{k1f}, K2 x{k2f}), "
              f"-ELBO {first:.1f} -> {last:.1f}; task correlation {corr[0, 1]:.4f}", flush=True)
        require(gap <= 1e-3 and max(dgaps) <= 1e-2,
                f"14b {mode}: ELBO vs host {gap:.2e}, gradient {dgaps}")
        require(np.isfinite(losses).all() and last < first,
                f"14b {mode}: fit_svgp loss did not fall ({first} -> {last})")
        require(np.allclose(np.diagonal(corr), 1.0) and np.allclose(corr, corr.T)
                and np.all(np.abs(corr) <= 1 + 1e-6), f"14b {mode}: task correlations {corr}")
        out[mode] = dict(eval_s=statistics.median(times), launches=per_eval, peak_gb=peak / 1e9,
                         elbo=got, elbo64=ref, gap=gap, grad_gaps=dgaps,
                         grad_norm_gap=norm_gap, host_s=t_host, fit_s=t_fit,
                         fit_launches=[k1f, k2f], loss=[first, last],
                         task_correlation=float(corr[0, 1]))
        if mode == "per_latent":
            require(len(grams) == 2 and len(kuus) == 1 and kuus[0].shape == (2, len(z), len(z)),
                    f"14b per-latent evaluation: {len(grams)} K1 calls, Kuu stacks "
                    f"{[tuple(k.shape) for k in kuus]}")
            out[mode]["k1_latents"] = latent_k1_record(grams, len(z), len(x))
            out[mode]["k2_latents"] = latent_k2_record(kuus[0])
            out[mode]["latent_launches"] = [sum(e[0] for e in per_eval) + k1f,
                                            sum(e[1] for e in per_eval) + k2f]
    return out


def phase14c(x_map, y_map, path_batched):
    """sample_hypers on SVP(Bias, SE, GaussianLik) at phase 5's n=4096, m=256
    fixed inducing inputs: 16 walkers x 20, each half-ensemble one batched
    call (K1 x2: Kuu and Kuf of all rows; K2 x1); then 16 rows of
    logp_chain against 16 single logps."""
    svp = g3t.SVP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.SE(x_map),
                  likelihood=g3t.GaussianLik(), inducing=x_map[::16][:256],
                  learn_inducing=False, name="P14C")
    svp.observed(x_map, y_map)
    with counted_calls(svp) as calls:
        zero_counts()
        t0 = time.perf_counter()
        chain, lnprob = svp.sample_hypers(start=svp.params_default, samples=20, chains=16,
                                          noise_mult=0.05, raw=True, seed=14)
        t_s = time.perf_counter() - t0
        k1, k2, retries = launches()
    path_batched[0] += k1
    path_batched[1] += k2
    moved = moved_share(chain)
    rows = chain[:, -1, :]
    with counted(path_batched):
        batched = svp.logp_chain(rows)
        k1r, k2r, _ = launches()
    single = np.array([svp.logp(r, array=True) for r in rows])
    gap = rel_gap(batched, single)
    print(f"  14c SVP sampler n={len(x_map)} m=256 ({svp.active.ndim} dims), 16 x 20: "
          f"{t_s:.2f} s, {len(calls)} batched calls of {sorted(set(calls))} rows; K1 x{k1}, "
          f"K2 x{k2} ({retries} retries); moved {moved:.3f}; 16 rows of logp_chain (K1 x{k1r}, "
          f"K2 x{k2r}) vs 16 single logps {gap:.2e}", flush=True)
    require(np.isfinite(lnprob).all() and moved > 0, "14c: lnprob not finite or no move")
    require(k1 == 2 * len(calls) and k2 == len(calls) + retries,
            f"14c K1 x{k1}, K2 x{k2} for {len(calls)} batched calls ({retries} retries)")
    require(k1r == 2 and gap <= 1e-4, f"14c logp_chain: K1 x{k1r}, vs single {gap:.2e}")
    return dict(s=t_s, calls=len(calls), k1=k1, k2=k2, moved=moved, rows_gap=gap)


def phase14d(trace_6c, gp, dt16, x_map, y_map, path_batched):
    """The datatrace toolkit on phase 6c's datatrace (WGP n=125, 32 x 400):
    both mixtures through cluster_datatrace, a KDE (over each chain's second
    half) round trip of 1000 draws (each refill one batched logp_chain call:
    K1 and K2 once), the
    candidates and a .npz round trip; then errors_datatrace over phase 6d's
    16 rows at n=4096 on 1024 query points (one batched factorization)
    against the float64 host's 16 single-row errors."""
    import tempfile

    wgp, dt = trace_6c
    out = {}
    for bayesian in (True, False):
        np.random.seed(14)
        t0 = time.perf_counter()
        g3t.cluster_datatrace(wgp, dt, n_components=5, bayesian=bayesian)
        t_c = time.perf_counter() - t0
        sizes = np.bincount(dt["_cluster"], minlength=5)
        out["bayesian" if bayesian else "ml"] = dict(s=t_c, sizes=sizes.tolist())
        print(f"  14d cluster_datatrace({'variational' if bayesian else 'maximum likelihood'}) "
              f"over {len(dt)} rows: {t_c:.2f} s, cluster sizes {sizes.tolist()}", flush=True)
        require(sizes.sum() == len(dt) and sizes[0] > 0, "14d clusters")
    # 6c's bisection at its tol 0.001 keeps no row (|R-hat - 1| ~0.05 over
    # 400 iterations): the density is fitted to each chain's second half,
    # the rows 6c's mESS reads
    half = dt.copy()
    half["_burnin"] = half["_niter"] >= (half["_niter"].max() + 1) // 2
    kde = g3t.datatrace_to_kde(wgp, half)
    calls = []
    inner = wgp.logp_chain

    def counted_chain(chain, prior=False):
        calls.append(len(chain))
        return inner(chain, prior=prior)

    wgp.logp_chain = counted_chain
    try:
        np.random.seed(15)
        with counted(path_batched):
            t0 = time.perf_counter()
            kdt = g3t.kde_to_datatrace(wgp, kde, nsamples=1000)
            t_k = time.perf_counter() - t0
            k1, k2, retries = launches()
    finally:
        del wgp.logp_chain
    print(f"  14d KDE round trip (tophat 0.02): 1000 draws in {t_k:.2f} s, {len(calls)} batched "
          f"logp_chain calls of {calls} rows; K1 x{k1}, K2 x{k2} ({retries} retries)",
          flush=True)
    require(len(kdt) == 1000 and np.all(kdt["_ll"] > kde.min_ll) and "_cluster" in kdt,
            "14d KDE datatrace")
    require(k1 == len(calls) and k2 == len(calls) + retries,
            f"14d KDE refills: K1 x{k1}, K2 x{k2} for {len(calls)} calls")
    cand = g3t.find_candidates(dt, ll=2, mean=True)
    require(len(cand) > 0 and np.isfinite(cand["_ll"]).all(), "14d candidates")
    path_npz = str(Path(tempfile.mkdtemp()) / "dt14.npz")
    t0 = time.perf_counter()
    g3t.save_datatrace(dt, path_npz)
    back = g3t.load_datatrace(path_npz)
    t_io = time.perf_counter() - t0
    require(back.columns == dt.columns and all(np.array_equal(back[c], dt[c])
                                               for c in dt.columns), "14d .npz round trip")
    print(f"  14d find_candidates: {len(cand)} rows {list(cand.index)}; .npz round trip of "
          f"{len(dt)} x {len(dt.columns)} in {t_io * 1e3:.1f} ms", flush=True)
    out.update(kde_s=t_k, kde_calls=calls, candidates=len(cand), npz_ms=t_io * 1e3)
    # errors over phase 6d's 16 rows
    xq, yq = x_map[:1024], y_map[:1024]
    edt = dt16.copy()
    with counted(path_batched):
        t0 = time.perf_counter()
        g3t.errors_datatrace(gp, edt, space=xq, hidden=yq)
        t_e = time.perf_counter() - t0
        k1, k2, retries = launches()
    reg = gp.active
    rows = np.asarray(dt16[reg.param_names()], np.float64)

    def host_errors(dtype):
        def one(u):
            mean = host_stats(reg, u, x_map, y_map, xq, dtype)["mean"]
            return np.mean(np.abs(yq - mean)), np.mean((yq - mean) ** 2)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            return np.array(list(pool.map(one, rows)))

    ref = host_errors(np.float64)
    gaps = [rel_gap(edt["_l1"], ref[:, 0]), rel_gap(edt["_l2"], ref[:, 1])]
    limit = held(max(gaps), 1e-3, lambda: max(rel_gap(w, r) for w, r in zip(
        host_errors(np.float32).T, ref.T)), "14d errors_datatrace vs host")
    print(f"  14d errors_datatrace over 16 rows at n={len(x_map)}, 1024 points: {t_e * 1e3:.1f} "
          f"ms; K1 x{k1}, K2 x{k2} ({retries} retries); _l1/_l2 vs the float64 host's single "
          f"rows {[f'{v:.2e}' for v in gaps]} (limit {limit:.1e})", flush=True)
    require(k2 == 1 + retries and k1 == 3, f"14d errors: K1 x{k1}, K2 x{k2}, expected the "
            "observed gram and two cross grams (K1 x3) and one factorization")
    out.update(errors_ms=t_e * 1e3, errors_launches=[k1, k2], errors_gaps=gaps)
    return out


def phase14e(x_map, y_map, path, path_batched):
    """The Experiment harness: GP(Bias, SE) and WGP(Bias, MAT52, BoxCoxLinear)
    on phase 5's inputs (positive targets) at n=4096, split p=0.5, 2
    simulations, engine 'scipy' and 'jax': every result row finite; a second
    run from the same file adds no row.  The scipy runs' launches go to
    ``path``, the jax engine's (batched over starts) to ``path_batched``."""
    import tempfile

    y_pos = (np.abs(np.sin(x_map[:, 0])) + 0.5
             + 0.1 * np.random.default_rng(146).standard_normal(len(x_map))).astype(np.float32)
    folder = Path(tempfile.mkdtemp())
    out = {}

    def models():
        return [g3t.GP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.SE(x_map),
                       name="P14E_GP"),
                g3t.WGP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.MAT52(x_map),
                        mapping=g3t.BoxCoxLinear(y_pos), name="P14E_WGP")]

    for engine in ("scipy", "jax"):
        file = str(folder / f"{engine}.pkl")
        e = g3t.Experiment(models=models(), file=file)
        e.set_data(x_map, y_pos, p=0.5)
        e.set_selection(engine=engine, points=1, powell=False)
        with counted(path if engine == "scipy" else path_batched):
            t0 = time.perf_counter()
            res = e.run(n_simulations=2)
            t_run = time.perf_counter() - t0
            k1, k2, _ = launches()
        require(k1 > 0 and k2 > 0, f"14e {engine}: the run launched K1 x{k1}, K2 x{k2}")
        cols = [c for c in res.columns if c.startswith(("obs_", "test_"))]
        values = np.array([res[c].astype(np.float64) for c in cols])
        again = g3t.Experiment(models=models(), file=file)
        again.run(n_simulations=2)
        pivot = again.describe("test_l2")
        print(f"  14e Experiment engine={engine!r}: 2 models x 2 simulations in {t_run:.1f} s "
              f"(K1 x{k1}, K2 x{k2}); "
              f"{len(res)} rows, test_l2 {dict((m, pivot[m].tolist()) for m in pivot.columns[1:])}; "
              f"resumed from the file: {len(again.results)} rows", flush=True)
        require(len(res) == 4 and np.isfinite(values).all(), f"14e {engine}: result rows")
        require(len(again.results) == 4, f"14e {engine}: the resumed run added rows")
        out[engine] = dict(s=t_run, launches=[k1, k2],
                           test_l2={m: pivot[m].tolist() for m in pivot.columns[1:]})
    return out


def phase14(trace_6c, gp, dt16, x_map, y_map, path, path_batched):
    """Phase 14's runs; the launches of 14a's evaluations and serving, 14b's
    shared-kernel evaluations and fits and 14e's scipy experiments go to
    ``path``; 14a's find_MAP(engine='jax'), 14b's per-latent ones, 14c's
    sampler and rows, 14d's refills and errors and 14e's jax-engine
    experiments to ``path_batched``."""
    out = {}
    runs = (("14a", "deep kernel learning at n=4096",
             lambda: phase14a(x_map, y_map, path, path_batched)),
            ("14b", "LMCSVP at n=100000", lambda: phase14b(path, path_batched)),
            ("14c", "the SVP sampler rows at n=4096",
             lambda: phase14c(x_map, y_map, path_batched)),
            ("14d", "the datatrace toolkit",
             lambda: phase14d(trace_6c, gp, dt16, x_map, y_map, path_batched)),
            ("14e", "the Experiment harness",
             lambda: phase14e(x_map, y_map, path, path_batched)))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 15
# The state-space families (ROADMAP item 13's gaussian half): bench.py's two
# state-space rows (an exact O(n) NLL and gradient at n=16384), serving on
# the first, the spatio-temporal family at its documented size (m=32 sites,
# S=64 states), the chunked path past ssm_chunk_threshold and a params dict
# of 16 rows.  Only 15d reaches K1 (the site gram, the cross grams) and K2
# (the sites' factor); the Matern time kernels run no kernel of the port.
# Witnesses: the port on the CPU in float64 (15a-c, 15f), the card in
# float64 (15d-e: a CPU run at S=64 or n=2M takes tens of seconds).
SS_N = 16384                 # bench.py:358's n
SS_CHUNKED_N = 2_097_152     # 15e: 8 blocks of settings.ssm_chunk
ST_SITES, ST_PER_SITE = 32, 512


def ss_series(n, seed, span=None):
    """bench.py:358-362's series (its formulas, a seeded stream): t sorted
    uniform on (0, n/50), y = sin(2 pi t / 20) + 0.2 noise."""
    rng = np.random.default_rng(seed)
    span = n / 50.0 if span is None else span
    t = np.sort(rng.uniform(0, span, n)).astype(np.float32)
    return t, rng


def ssgp_model(name, n=None, seed=15):
    n = SS_N if n is None else n
    t, rng = ss_series(n, seed)
    y = (np.sin(2 * np.pi * t / 20.0) + 0.2 * rng.standard_normal(n)).astype(np.float32)
    tc = t[:, None]
    proc = g3t.StateSpaceGP(space=tc[:4], kernel=g3t.MAT32(tc) + g3t.OU(tc), name=name)
    proc.observed(tc, y)
    return proc, tc, y


def mssgp_model(name, seed=16):
    """bench.py:399-414's two channels: 9830 + 6554 events at their own
    times on (0, 327), LMC-mixed from a MAT32 and an OU latent."""
    rng = np.random.default_rng(seed)
    n0, n1 = 9830, 6554
    t0 = np.sort(rng.uniform(0, 327.0, n0)).astype(np.float32)
    t1 = np.sort(rng.uniform(0, 327.0, n1)).astype(np.float32)
    y0 = (np.sin(2 * np.pi * t0 / 20.0) + 0.2 * rng.standard_normal(n0)).astype(np.float32)
    y1 = (-0.8 * np.sin(2 * np.pi * t1 / 20.0) + 0.5
          + 0.3 * rng.standard_normal(n1)).astype(np.float32)
    x, y = g3t.stack_outputs([t0[:, None], t1[:, None]], [y0, y1])
    proc = g3t.MultiStateSpaceGP(space=x[:4], kernel=[g3t.MAT32(t0[:4, None]),
                                                       g3t.OU(t0[:4, None])],
                                 outputs_dim=2, name=name)
    proc.observed(x, y)
    return proc, x, y


def value_grad_on(build, u, device, floatx, like_only=False):
    """The model ``build()`` makes, on ``device`` in ``floatx``: its logp
    (or loglike) and gradient at the unconstrained ``u`` (host float64)."""
    t0 = time.perf_counter()
    with port_on(device, floatx):
        proc = build()[0]
        val, grad = proc._value_and_grad(proc._logp_pure(like_only=like_only),
                                         g3t.config.as_tensor(np.asarray(u)))
        out = float(val), grad.cpu().numpy().astype(np.float64)
    print(f"    the {floatx} witness on {device}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def held_value_grad(label, got, ref, gates=(1e-3, 1e-2), seed=15):
    """A value and gradient against their float64 witness: the value's
    relative gap and the gradient's along two random directions."""
    gap = abs(got[0] - ref[0]) / max(abs(ref[0]), 1e-30)
    dgaps, whole = directional_gaps(got[1], ref[1], seed)
    require(gap <= gates[0] and max(dgaps) <= gates[1],
            f"{label}: value gap {gap:.2e}, gradient gaps {dgaps}")
    return dict(gap=gap, grad_gaps=dgaps, grad_norm_gap=whole)


def device_profile(fn):
    """A CUDA-only ``torch.profiler`` trace of one call of the warm ``fn``:
    (device events, device ms).  Without the CPU activity the trace and its
    key averages take ~1/3 of the time at 50,000 events (13.6 s against
    38.9 s for 15d's evaluation on the card)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    dev = [e for e in prof.key_averages() if _on_device(e)]
    return sum(e.count for e in dev), sum(_self_device_us(e) for e in dev) / 1e3


def evaluation_record(proc, u, label, reps, path=None, predict=None, profiled=True, warm=True,
                      predict_k1=None):
    """Value and gradient through the normal entry (``_value_and_grad`` of
    ``_logp_pure``, as bench.py times it): warm-up, then ``reps`` timed
    evaluations (median), each one's K1/K2 launches against ``predict``
    (per evaluation, K2 plus its jitter retries) and, with ``predict_k1``,
    its K1 launches by kind and shape against it, added to ``path``;
    the peak allocated memory; with ``profiled``, one more evaluation's
    device events (its launches), device time and idle share."""
    import gc

    pure = proc._logp_pure()
    ut = torch.as_tensor(u, device=CARD)

    def evaluate():
        out = proc._value_and_grad(pure, ut)
        torch.cuda.synchronize()
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t_warm = time.perf_counter()
    if warm:
        evaluate()
    t_warm = time.perf_counter() - t_warm
    times, per_eval = [], []
    for _ in range(reps):
        zero_counts()
        t0 = time.perf_counter()
        val, grad = evaluate()
        times.append(time.perf_counter() - t0)
        k1, k2, retries = launches()
        per_eval.append((k1, k2, retries))
        if path is not None:
            to_path(path, k1, k2)
        want = (0, 0) if predict is None else (predict[0], predict[1] + retries)
        require((k1, k2) == want, f"{label}: an evaluation launched K1 x{k1}, K2 x{k2} "
                f"({retries} retries), predicted {want}")
        require(predict_k1 is None or k1_shapes() == predict_k1,
                f"{label}: an evaluation's K1 launches {k1_shapes()}, predicted {predict_k1}")
    peak = torch.cuda.max_memory_allocated()
    t_eval = statistics.median(times)
    require(math.isfinite(float(val)) and finite(grad), f"{label}: value or gradient not finite")
    t_prof = time.perf_counter()
    events, t_dev = device_profile(evaluate) if profiled else (None, None)
    t_prof = time.perf_counter() - t_prof
    idle = None if not t_dev else max(0.0, 1.0 - t_dev / (t_eval * 1e3))
    print(f"  {label}: logp + gradient {t_eval * 1e3:.2f} ms an evaluation ({1 / t_eval:.2f} "
          f"evals/s; all {[round(t * 1e3, 2) for t in times]} ms), K1/K2/retries an "
          f"evaluation {per_eval[0]}; device events {events} an evaluation, device "
          f"{fmt_ms(t_dev)}, idle share {'not measured' if idle is None else f'{idle:.3f}'}; "
          f"peak allocated {peak / 1e9:.3f} GB ({(peak - before) / 1e9:.3f} GB above "
          f"{before / 1e9:.3f}); the first evaluation {t_warm:.2f} s, the profile "
          f"{t_prof:.2f} s", flush=True)
    return dict(eval_ms=t_eval * 1e3, first_s=t_warm, profile_s=t_prof, evals_per_s=1 / t_eval,
                times_ms=[t * 1e3 for t in times], launches=per_eval, k1_shapes=predict_k1,
                device_events=events, device_ms=t_dev, idle=idle,
                peak_gb=peak / 1e9, value=float(val), grad=grad.cpu().numpy())


def phase15a():
    """bench.py:352-381: StateSpaceGP(MAT32 + OU) at n=16384, default params,
    logp and gradient, against the port on the CPU in float64."""
    build = lambda: ssgp_model("P15A")  # noqa: E731
    proc, t, y = build()
    u = proc.active.dict_to_array(proc.params_default)
    rec = evaluation_record(proc, u, "15a SSGP(MAT32 + OU) n=16384", reps=10)
    t0 = time.perf_counter()
    ref = value_grad_on(build, u, "cpu", "float64")
    rec["witness"] = held_value_grad("15a vs the CPU float64", (rec["value"], rec["grad"]), ref)
    rec["cpu_s"] = time.perf_counter() - t0
    print(f"  15a vs the CPU port in float64 ({rec['cpu_s']:.2f} s): {rec['witness']}",
          flush=True)
    rec.pop("grad")
    return proc, u, rec


def phase15b():
    """bench.py:392-428: MultiStateSpaceGP, 9830 + 6554 events, default
    params, logp and gradient, against the CPU port in float64."""
    build = lambda: mssgp_model("P15B")  # noqa: E731
    proc, _, _ = build()
    u = proc.active.dict_to_array(proc.params_default)
    rec = evaluation_record(proc, u, "15b MSSGP(MAT32, OU) 9830 + 6554", reps=10)
    ref = value_grad_on(build, u, "cpu", "float64")
    rec["witness"] = held_value_grad("15b vs the CPU float64", (rec["value"], rec["grad"]), ref)
    print(f"  15b vs the CPU port in float64: {rec['witness']}", flush=True)
    rec.pop("grad")
    return rec


def host_normals(samples, n, s, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((samples, n, s)), "y": rng.standard_normal((samples, n))}


def phase15c(proc):
    """Serving on 15a's model: a Predictor batch of mean and variance at
    1024 query times, quantiler, and 16 joint sampler draws (the Matheron
    simulation smoother, host normals), each timed after a warm call and
    held against the CPU port in float64 (moments relative to their scale,
    the draws with the same normals)."""
    params = proc.params_default
    tq = np.linspace(1.0, SS_N / 50.0 - 1.0, 1024).astype(np.float32)[:, None]
    pr = proc.predictor(params)
    draws = host_normals(16, SS_N + len(tq), 3, 151)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    zero_counts()
    stats, t_pr = timed(lambda: pr.predict(tq, mean=True, std=False, var=True))
    quant, t_q = timed(lambda: proc.quantiler(params, tq, q=0.975))
    samp, t_s = timed(lambda: proc.sampler(params, tq, samples=16, seed=draws))
    require(launches()[:2] == (0, 0), f"15c launched K1/K2 {launches()[:2]}, predicted none")
    with port_on("cpu", "float64"):
        cpu, _, _ = ssgp_model("P15A")
        mean64 = cpu.mean(params, tq)
        var64 = cpu.variance(params, tq)
        quant64 = cpu.quantiler(params, tq, q=0.975)
        samp64 = cpu.sampler(params, tq, samples=16, seed=draws)
    with port_on("cpu", "float32"):
        samp32 = ssgp_model("P15A")[0].sampler(params, tq, samples=16, seed=draws)
    gaps = {"mean": rel_gap(stats["mean"], mean64),
            "variance": rel_gap(stats["variance"], var64),
            "quantile": rel_gap(quant, quant64), "draws": rel_gap(samp, samp64)}
    # a float32 prior trajectory carries Q = Pinf - A Pinf A' at steps of
    # ~1/50 with its cancellation: the draws are held within WITNESS_FACTOR
    # x the CPU's own float32 gap to float64 (the same normals)
    witness = rel_gap(samp32, samp64)
    limits = {k: 1e-3 for k in gaps}
    limits["draws"] = max(1e-3, WITNESS_FACTOR * witness)
    print(f"  15c serving n=16384, 1024 queries: Predictor batch (mean, variance) {t_pr:.2f} "
          f"ms, quantiler {t_q:.2f} ms, 16 joint draws {t_s:.2f} ms; vs the CPU port in "
          f"float64 (relative to scale) {gaps}, the draws' float32 CPU witness {witness:.2e}",
          flush=True)
    require(all(np.isfinite(v) and v <= limits[k] for k, v in gaps.items()),
            f"15c gaps {gaps} over {limits}")
    return dict(predict_ms=t_pr, quantiler_ms=t_q, sampler_ms=t_s, gaps=gaps,
                draws_witness=witness)


def st_sites(seed=17):
    """32 sites on a jittered 8 x 4 grid of spacing 1 in 2-D."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(8.0), np.arange(4.0))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    return (grid + rng.uniform(-0.2, 0.2, grid.shape)).astype(np.float32)


def st_model(name, seed=18):
    """SpatioTemporalSSGP at its documented size: 32 sites, 512 events a
    site on (0, 100) (n=16384), MAT32 in time x SE over the sites (S=64);
    a smooth space-time field plus noise.  The SE's rate is set to the
    grid's spacing (the data-driven default reads the sites' listing
    order)."""
    sites = st_sites()
    rng = np.random.default_rng(seed)
    ts, ys = [], []
    for p in range(ST_SITES):
        t = np.sort(rng.uniform(0, 100.0, ST_PER_SITE)).astype(np.float32)
        ts.append(t[:, None])
        ys.append((np.sin(2 * np.pi * t / 20.0 + 0.5 * sites[p, 0]) * np.cos(0.4 * sites[p, 1])
                   + 0.2 * rng.standard_normal(ST_PER_SITE)).astype(np.float32))
    x, y = g3t.stack_outputs(ts, ys)
    proc = g3t.SpatioTemporalSSGP(space=x[:4], kernel=g3t.MAT32(x[:, :1]),
                                  space_kernel=g3t.SE(sites), sites=sites, name=name)
    proc.observed(x, y)
    params = dict(proc.params_default)
    params[f"{name}_SE_rate"] = np.ones(2, np.float32)
    return proc, params, x, y


def sparse_st_model(name, seed=19):
    """SparseSpatioTemporalSSGP over 15d's 32 sites as inducing sites, with
    16384 rows at random off-site coordinates (one global noise)."""
    sites = st_sites()
    rng = np.random.default_rng(seed)
    n = ST_SITES * ST_PER_SITE
    t = np.sort(rng.uniform(0, 100.0, n)).astype(np.float32)
    xy = rng.uniform([-0.5, -0.5], [7.5, 3.5], (n, 2)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 20.0 + 0.5 * xy[:, 0]) * np.cos(0.4 * xy[:, 1])
         + 0.2 * rng.standard_normal(n)).astype(np.float32)
    x = np.concatenate([t[:, None], xy], axis=1)
    proc = g3t.SparseSpatioTemporalSSGP(space=x[:4], kernel=g3t.MAT32(x[:, :1]),
                                        space_kernel=g3t.SE(sites), inducing=sites, name=name)
    proc.observed(x, y)
    params = dict(proc.params_default)
    params[f"{name}_SE_rate"] = np.ones(2, np.float32)
    return proc, params, x, y


def phase15d(path):
    """SpatioTemporalSSGP at m=32, S=64, n=16384: logp and gradient (K1 x1,
    the (32,32,2) site gram; K2 x1 + jitter retries, the sites' factor),
    the field at 256 off-site points (K1 x2, the site gram and the (32,256,2)
    cross gram; K2 x1), one evaluation of SparseSpatioTemporalSSGP with
    16384 off-site rows (K1 x2, the site gram and the (32,16384,2) cross
    gram; K2 x1); every value against the card in float64; K1 at (32,32,2)
    and (32,256,2) and K2 at m=32 against their plain forms."""
    proc, params, x, y = st_model("P15D")
    u = proc.active.dict_to_array(params)
    rec = evaluation_record(proc, u, "15d STSSGP m=32 S=64 n=16384", reps=1, path=path,
                            predict=(1, 1))
    ref = value_grad_on(lambda: st_model("P15D"), u, CARD, "float64")
    rec["witness"] = held_value_grad("15d vs the card's float64", (rec["value"], rec["grad"]),
                                     ref)
    rec.pop("grad")
    rng = np.random.default_rng(20)
    tq = np.sort(rng.uniform(0, 100.0, 256)).astype(np.float32)
    xq = rng.uniform([-0.5, -0.5], [7.5, 3.5], (256, 2)).astype(np.float32)
    proc.field(tq, xq, params=params)  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fm, fv = proc.field(tq, xq, params=params)
    torch.cuda.synchronize()
    t_field = (time.perf_counter() - t0) * 1e3
    k1, k2, retries = launches()
    path[0] += k1
    path[1] += k2
    require((k1, k2) == (2, 1 + retries), f"15d field launched K1 x{k1}, K2 x{k2} ({retries} "
            "retries), predicted K1 x2, K2 x1 + retries")
    with port_on(CARD, "float64"):
        p64, params64 = st_model("P15D")[:2]
        fm64, fv64 = p64.field(tq, xq, params=params64)
    field_gaps = {"mean": rel_gap(fm, fm64), "variance": rel_gap(fv, fv64)}
    print(f"  15d field at 256 off-site points: {t_field:.2f} ms, K1 x{k1}, K2 x{k2}; vs the "
          f"card's float64 {field_gaps}", flush=True)
    require(max(field_gaps.values()) <= 1e-3 and np.isfinite(fm).all(),
            f"15d field gaps {field_gaps}")
    sp, sp_params = sparse_st_model("P15DS")[:2]
    us = sp.active.dict_to_array(sp_params)
    sparse = evaluation_record(sp, us, "15d SparseSTSSGP m=32 n=16384 off-site rows", reps=1,
                               path=path, predict=(2, 1), profiled=False)
    sparse["witness"] = held_value_grad(
        "15d sparse vs the card's float64", (sparse["value"], sparse["grad"]),
        value_grad_on(lambda: sparse_st_model("P15DS"), us, CARD, "float64"))
    sparse.pop("grad")
    # the kernels at the family's shapes, against their plain forms
    t_rec = time.perf_counter()
    pt = proc._tensor_params(params)
    rate, var = pt["P15D_SE_rate"], pt["P15D_SE_var"]
    z = torch.as_tensor(st_sites(), device=CARD)
    k1_sites = k1_record(z, z, rate, var, "15d K1 site gram")
    k1_cross = k1_record(z, torch.as_tensor(xq, device=CARD), rate, var, "15d K1 field cross")
    with torch.no_grad():
        gram = proc.f_mixing.spatial_cov(pt)
    k2_sites = sparse_k2(gram.contiguous(), "K_s(sites), SE")
    print(f"    the kernel records: {time.perf_counter() - t_rec:.2f} s", flush=True)
    evals = len(rec["launches"]) + len(sparse["launches"])
    out = dict(st=rec, field=dict(ms=t_field, launches=(k1, k2), gaps=field_gaps), sparse=sparse,
               k1_sites=k1_sites, k1_cross=k1_cross, k2_sites=k2_sites,
               # the launches by shape class, as predicted and counted above
               sites_launches=evals + 1, cross_launches=1 + len(sparse["launches"]),
               k2_launches=sum(v[1] for v in rec["launches"] + sparse["launches"]) + k2)
    return out


def phase15e():
    """The chunked path: StateSpaceGP(MAT32 + OU) at n=2,097,152 (over
    ssm_chunk_threshold: 8 blocks of ssm_chunk), logp and gradient through
    chunked_kalman_nll, against parallel_kalman_nll on the same data in
    float64 on the card (the threshold raised); the chunked smoother at
    1024 queries against the plain smoother likewise."""
    require(SS_CHUNKED_N > g3t.settings.ssm_chunk_threshold
            and SS_CHUNKED_N // g3t.settings.ssm_chunk == 8, "15e is not 8 chunks")
    build = lambda: ssgp_model("P15E", n=SS_CHUNKED_N, seed=21)  # noqa: E731
    proc, t, y = build()
    u = proc.active.dict_to_array(proc.params_default)
    rec = evaluation_record(proc, u, "15e SSGP n=2097152 chunked", reps=1, profiled=False)
    old = g3t.settings.ssm_chunk_threshold
    g3t.settings.ssm_chunk_threshold = 1 << 40          # the plain scans
    try:
        t0 = time.perf_counter()
        ref = value_grad_on(build, u, CARD, "float64")
        t_plain = time.perf_counter() - t0
        # query times exact in float32: at t ~ 4e4 a float32 rounding of a
        # query moves it by ~1e-3, 5% of the MAT32's 0.02 lengthscale
        tq = np.linspace(1.0, SS_CHUNKED_N / 50.0 - 1.0, 1024).astype(np.float32)
        with port_on(CARD, "float64"), torch.no_grad():
            p64 = build()[0]
            pt = p64._tensor_params(p64.params_default)
            plain_sm = [v.cpu().numpy() for v in p64._run_smoother(
                pt, g3t.config.as_tensor(tq), p64._device_data("inputs"),
                p64._device_data("outputs"))]
    finally:
        g3t.settings.ssm_chunk_threshold = old
    rec["witness"] = held_value_grad("15e chunked vs plain float64", (rec["value"], rec["grad"]),
                                     ref)
    rec.pop("grad")
    with torch.no_grad():
        pt = proc._tensor_params(proc.params_default)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked_sm = [v.cpu().numpy() for v in proc._run_smoother(
            pt, g3t.config.as_tensor(tq), proc._device_data("inputs"),
            proc._device_data("outputs"))]
        t_sm = (time.perf_counter() - t0) * 1e3
    sm_gaps = {"mean": rel_gap(chunked_sm[0], plain_sm[0]),
               "variance": rel_gap(chunked_sm[1], plain_sm[1])}
    print(f"  15e vs the plain scan in float64 ({t_plain:.2f} s): {rec['witness']}; chunked "
          f"smoother at 1024 queries {t_sm:.1f} ms, vs the plain float64 smoother {sm_gaps}",
          flush=True)
    require(max(sm_gaps.values()) <= 1e-3, f"15e smoother gaps {sm_gaps}")
    rec.update(smoother_ms=t_sm, smoother_gaps=sm_gaps, plain_witness_s=t_plain)
    return rec


def phase15f(proc, u):
    """One batched evaluation over 16 rows at 15a's n (one scan over (16,
    16384, 3, 3)) against its 16 single evaluations on the card and against
    the CPU port's batched evaluation in float64."""
    rows = u[None, :] + 0.1 * np.random.default_rng(22).standard_normal((16, len(u)))
    rt = torch.as_tensor(rows, dtype=torch.float32, device=CARD)
    proc._rows_value_and_grad(rt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, grad = proc._rows_value_and_grad(rt)
    torch.cuda.synchronize()
    t_rows = (time.perf_counter() - t0) * 1e3
    val, grad = val.cpu().numpy().astype(np.float64), grad.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    singles = [proc._rows_value_and_grad(r) for r in rt]
    torch.cuda.synchronize()
    t_single = (time.perf_counter() - t0) * 1e3
    sv = np.array([float(v) for v, _ in singles])
    sg = np.stack([g.cpu().numpy() for _, g in singles]).astype(np.float64)
    with port_on("cpu", "float64"):
        cpu = ssgp_model("P15A")[0]
        v64, g64 = cpu._rows_value_and_grad(torch.as_tensor(rows))
        v64, g64 = v64.numpy(), g64.numpy()
    single_gap = max(rel_gap(val, sv), rel_gap(grad, sg))
    gaps = [held_value_grad(f"15f row {i}", (val[i], grad[i]), (v64[i], g64[i]), seed=i)
            for i in range(16)]
    worst = (max(g["gap"] for g in gaps), max(max(g["grad_gaps"]) for g in gaps))
    print(f"  15f 16 rows at n=16384: batched {t_rows:.2f} ms, 16 single evaluations "
          f"{t_single:.2f} ms; batched vs single (relative to scale) {single_gap:.2e}; vs the "
          f"CPU port in float64, worst value gap {worst[0]:.2e}, gradient {worst[1]:.2e}",
          flush=True)
    require(single_gap <= 1e-4, f"15f batched vs single {single_gap:.2e}")
    return dict(batched_ms=t_rows, singles_ms=t_single, single_gap=single_gap,
                worst_value_gap=worst[0], worst_grad_gap=worst[1])


def phase15(path):
    """Phase 15's runs; the launches of 15d's float32 evaluations, field and
    sparse evaluation go to ``path`` (15a-c, 15e and 15f launch neither
    kernel: the Matern time kernels have no K1 gram)."""
    out, models = {}, {}

    def first():
        proc, u, rec = phase15a()
        models.update(proc=proc, u=u)
        return rec

    runs = (("15a", "StateSpaceGP n=16384 (bench.py:352-381)", first),
            ("15b", "MultiStateSpaceGP 9830 + 6554 (bench.py:392-428)", phase15b),
            ("15c", "serving on 15a's model", lambda: phase15c(models["proc"])),
            ("15d", "SpatioTemporalSSGP m=32 S=64 n=16384, the sparse variant",
             lambda: phase15d(path)),
            ("15e", "the chunked path at n=2097152", phase15e),
            ("15f", "16 rows at n=16384", lambda: phase15f(models["proc"], models["u"])))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 16
# The Laplace state-space family (item 13b): NonGaussianSSGP on
# benchmarks/ngssm_scale.py's data (make_data(n, 50 n / 16384) from a seeded
# stream: Poisson counts on a MAT32 latent) at its first timed size with its
# 8 Newton steps, the script's chunked-vs-plain gate, the gaussian identity
# with StateSpaceGP, the chunked route at its second size, the two-channel
# Poisson + Bernoulli fusion at 15b's event counts, the spatio-temporal Cox
# process at 15d's layout (32 events a site: each Newton step is a pass of
# 15d's size), serving and 16 rows.  Only 16d reaches K1 (the site gram and
# the field's cross gram) and K2 (the sites' factor).  Witnesses: the card
# in float64 (values 1e-3, gradients 1e-2 along two random directions).
NG_N = 1 << 18                 # ngssm_scale.py's first timed size
NG_CHUNKED_N = 1 << 20         # its second, past its threshold of 2^18
NG_ITERS = 8                   # ngssm_scale.py:95-96
NG_CHUNKED_ITERS = 1           # 16b: cut in depth (Newton steps) for time
NG_GATE_N = 8192               # ngssm_scale.py:61-83's gate
NG_ROWS_N = 16384              # 16f: 15f's n
NGST_PER_SITE = 32             # 16d: cut in depth from 15d's 512


@contextlib.contextmanager
def laplace_settings(iters=NG_ITERS, threshold=None, chunk=None):
    """``ssm_laplace_iters``, ``ssm_chunk_threshold`` (``NG_N`` by default)
    and ``ssm_chunk`` for the block, as ngssm_scale.py sets them; restored
    after."""
    s = g3t.settings
    old = s.ssm_laplace_iters, s.ssm_chunk_threshold, s.ssm_chunk
    s.ssm_laplace_iters, s.ssm_chunk_threshold = iters, NG_N if threshold is None else threshold
    s.ssm_chunk = old[2] if chunk is None else chunk
    try:
        yield
    finally:
        s.ssm_laplace_iters, s.ssm_chunk_threshold, s.ssm_chunk = old


def ng_data(n, span, seed):
    """ngssm_scale.py's make_data: t sorted uniform on (0, span), counts
    ~ Poisson(exp(sin(2 pi t / 20) + 0.3 sin(t / 3) + 0.5))."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).astype(np.float32)
    f = (np.sin(2 * np.pi * t / 20.0) + 0.3 * np.sin(t / 3.0) + 0.5).astype(np.float32)
    return t[:, None], rng.poisson(np.exp(f)).astype(np.float32)


def ngssgp_model(name, n, seed=0, span=None, lik=None):
    x, y = ng_data(n, 50.0 * n / 16384 if span is None else span, seed)
    proc = g3t.NonGaussianSSGP(space=x[:4], kernel=g3t.MAT32(x[:4]),
                               likelihood=g3t.PoissonLik() if lik is None else lik, name=name)
    proc.observed(x, y)
    return proc, x, y


NG_GATE_ITERS = 4   # 16a's gate: ngssm_scale.py takes 15 Newton steps (cut in depth for time)


def ngssm_gate():
    """ngssm_scale.py:61-83: at n=8192 (``NG_GATE_ITERS`` Newton steps) the
    chunked route (threshold 1024, chunk 2048) against the plain scans,
    value and gradient, rel_v < 1e-5 and rel_g < 1e-4, float32 on the
    card."""
    def run(name):
        proc = ngssgp_model(name, NG_GATE_N, seed=1, span=400.0)[0]
        return card_value_grad(proc, proc.active.dict_to_array(proc.params_default), False)

    with laplace_settings(iters=NG_GATE_ITERS, threshold=1 << 40):
        v_p, g_p = run("P16G")
    with laplace_settings(iters=NG_GATE_ITERS, threshold=1024, chunk=2048):
        v_c, g_c = run("P16G2")
    rel_v = abs(v_c - v_p) / abs(v_p)
    rel_g = float(np.max(np.abs(g_c - g_p)) / np.max(np.abs(g_p)))
    print(f"  16a gate n={NG_GATE_N}: chunked vs plain rel_v={rel_v:.2e} rel_g={rel_g:.2e}",
          flush=True)
    require(rel_v < 1e-5 and rel_g < 1e-4, f"16a gate rel_v {rel_v:.2e}, rel_g {rel_g:.2e}")
    return dict(rel_v=rel_v, rel_g=rel_g)


def gaussian_identity():
    """The module docstring's identity: NonGaussianSSGP(GaussianLik) on 15a's
    data and params is StateSpaceGP's exact evidence (its mode is one Newton
    step), float32 on the card, within 1e-5 relative."""
    ss, t, y = ssgp_model("P16I")
    p = dict(ss.params_default)
    ng = g3t.NonGaussianSSGP(space=t[:4], kernel=g3t.MAT32(t) + g3t.OU(t),
                             likelihood=g3t.GaussianLik(), name="P16I")
    ng.observed(t, y)
    pn = {k: v for k, v in p.items() if not k.endswith("Noise_var")}
    pn["P16I_GaussLik_var"] = p["P16I_Noise_var"]
    with torch.no_grad():
        want, got = ss.loglike(p), ng.loglike(pn)
    gap = abs(got - want) / abs(want)
    print(f"  16a gaussian identity at n={SS_N}: NGSSGP(GaussianLik) {got:.6f} vs StateSpaceGP "
          f"{want:.6f} (relative {gap:.2e})", flush=True)
    require(gap <= 1e-5, f"16a gaussian identity {gap:.2e}")
    return dict(gap=gap)


def phase16a():
    """NGSSGP(MAT32, Poisson) at n=262,144 (8 Newton steps, the plain scans):
    logp + gradient over 3 evaluations against the card's float64; the
    script's gate; the gaussian identity."""
    build = lambda: ngssgp_model("P16A", NG_N)  # noqa: E731
    with laplace_settings():
        proc = build()[0]
        u = proc.active.dict_to_array(proc.params_default)
        rec = evaluation_record(proc, u, "16a NGSSGP(MAT32, Poisson) n=262144", reps=1,
                                profiled=False)
        rec["witness"] = held_value_grad("16a vs the card's float64", (rec["value"], rec["grad"]),
                                         value_grad_on(build, u, CARD, "float64"))
    rec.pop("grad")
    print(f"  16a vs the card's float64: {rec['witness']}", flush=True)
    rec["gate"] = ngssm_gate()
    rec["identity"] = gaussian_identity()
    return proc, u, rec


def phase16b():
    """The chunked route at n=2^20 (threshold 2^18: 4 blocks of ssm_chunk),
    ``NG_CHUNKED_ITERS`` Newton steps: one timed evaluation and its peak
    memory."""
    with laplace_settings(iters=NG_CHUNKED_ITERS):
        proc = ngssgp_model("P16B", NG_CHUNKED_N)[0]
        require(NG_CHUNKED_N > g3t.settings.ssm_chunk_threshold, "16b is not chunked")
        u = proc.active.dict_to_array(proc.params_default)
        rec = evaluation_record(proc, u, f"16b NGSSGP n=1048576 chunked, {NG_CHUNKED_ITERS} "
                                "Newton steps", reps=1, profiled=False, warm=False)
    rec.pop("grad")
    return rec


def ngmssgp_model(name, seed=16):
    """15b's two channels (9830 + 6554 events on (0, 327)): Poisson counts
    and Bernoulli events driven by shared MAT32 latents (Q = 2)."""
    from scipy import stats

    rng = np.random.default_rng(seed)
    n0, n1 = 9830, 6554
    t0 = np.sort(rng.uniform(0, 327.0, n0)).astype(np.float32)
    t1 = np.sort(rng.uniform(0, 327.0, n1)).astype(np.float32)
    y0 = rng.poisson(np.exp(np.sin(2 * np.pi * t0 / 20.0) + 0.5)).astype(np.float32)
    y1 = (rng.uniform(size=n1) < stats.norm.cdf(-0.8 * np.sin(2 * np.pi * t1 / 20.0))
          ).astype(np.float32)
    x, y = g3t.stack_outputs([t0[:, None], t1[:, None]], [y0, y1])
    proc = g3t.NonGaussianMultiSSGP(space=x[:4], kernel=g3t.MAT32(t0[:4, None]),
                                    likelihood=[g3t.PoissonLik(), g3t.BernoulliLik()],
                                    outputs_dim=2, name=name)
    proc.observed(x, y)
    return proc, x, y


def phase16c():
    """NGMSSGP [Poisson, Bernoulli] over MAT32 latents at 9830 + 6554 events:
    logp + gradient against the card's float64."""
    build = lambda: ngmssgp_model("P16C")  # noqa: E731
    with laplace_settings():
        proc = build()[0]
        u = proc.active.dict_to_array(proc.params_default)
        rec = evaluation_record(proc, u, "16c NGMSSGP(Poisson, Bernoulli) 9830 + 6554", reps=1,
                                profiled=False)
        rec["witness"] = held_value_grad("16c vs the card's float64", (rec["value"], rec["grad"]),
                                         value_grad_on(build, u, CARD, "float64"))
    rec.pop("grad")
    print(f"  16c vs the card's float64: {rec['witness']}", flush=True)
    return rec


def ngst_model(name, seed=23):
    """A spatio-temporal Poisson Cox process on 15d's layout: 32 sites on
    the jittered 8 x 4 grid, 32 events a site on (0, 100), intensity
    exp(0.5 + sin(2 pi t / 20 + 0.5 x) cos(0.4 y)); MAT32 x SE (S=64), the
    SE's rate at the grid's spacing."""
    sites = st_sites()
    rng = np.random.default_rng(seed)
    ts, ys = [], []
    for p in range(ST_SITES):
        t = np.sort(rng.uniform(0, 100.0, NGST_PER_SITE)).astype(np.float32)
        lam = np.exp(0.5 + np.sin(2 * np.pi * t / 20.0 + 0.5 * sites[p, 0])
                     * np.cos(0.4 * sites[p, 1]))
        ts.append(t[:, None])
        ys.append(rng.poisson(lam).astype(np.float32))
    x, y = g3t.stack_outputs(ts, ys)
    proc = g3t.NonGaussianSTSSGP(space=x[:4], kernel=g3t.MAT32(x[:, :1]),
                                 space_kernel=g3t.SE(sites), sites=sites, name=name)
    proc.observed(x, y)
    params = dict(proc.params_default)
    params[f"{name}_SE_rate"] = np.ones(2, np.float32)
    return proc, params, x, y


def phase16d(path):
    """NGSTSSGP at m=32, S=64, n=4096, 8 Newton steps: logp + gradient (K1
    x1, K2 x1 + retries) against the card's float64; field_rate at 256
    off-site points (K1 x2, K2 x1) against the card's float64; K1 at
    (32,32,2) and K2 at m=32 against their plain forms."""
    with laplace_settings():
        proc, params, _, _ = ngst_model("P16D")
        u = proc.active.dict_to_array(params)
        rec = evaluation_record(proc, u, f"16d NGSTSSGP m=32 S=64 n={ST_SITES * NGST_PER_SITE}",
                                reps=1, path=path,
                                predict=(1, 1), profiled=False, warm=False,
                                predict_k1={f"se (1, {ST_SITES}, {ST_SITES}, 2)": 1})
        rec["witness"] = held_value_grad(
            "16d vs the card's float64", (rec["value"], rec["grad"]),
            value_grad_on(lambda: ngst_model("P16D"), u, CARD, "float64"))
        rec.pop("grad")
        rng = np.random.default_rng(20)
        tq = np.sort(rng.uniform(0, 100.0, 256)).astype(np.float32)
        xq = rng.uniform([-0.5, -0.5], [7.5, 3.5], (256, 2)).astype(np.float32)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        rate_m, rate_v = proc.field_rate(tq, xq, params=params)
        torch.cuda.synchronize()
        t_rate = (time.perf_counter() - t0) * 1e3
        k1, k2, retries = launches()
        to_path(path, k1, k2)
        want_k1 = {f"se (1, {ST_SITES}, {ST_SITES}, 2)": 1, f"se (1, {ST_SITES}, 256, 2)": 1}
        require((k1, k2) == (2, 1 + retries) and k1_shapes() == want_k1,
                f"16d field_rate launched K1 x{k1} {k1_shapes()}, K2 x{k2} ({retries} "
                f"retries), predicted K1 {want_k1}, K2 x1 + retries")
        with port_on(CARD, "float64"):
            p64, params64 = ngst_model("P16D")[:2]
            m64, v64 = p64.field_rate(tq, xq, params=params64)
    gaps = {"mean": rel_gap(rate_m, m64), "variance": rel_gap(rate_v, v64)}
    print(f"  16d field_rate at 256 off-site points: {t_rate:.1f} ms, K1 x{k1}, K2 x{k2}; vs "
          f"the card's float64 {gaps}", flush=True)
    require(max(gaps.values()) <= 1e-3 and np.isfinite(rate_m).all() and (rate_m > 0).all(),
            f"16d field_rate gaps {gaps}")
    pt = proc._tensor_params(params)
    z = torch.as_tensor(st_sites(), device=CARD)
    k1_sites = k1_record(z, z, pt["P16D_SE_rate"], pt["P16D_SE_var"], "16d K1 site gram")
    with torch.no_grad():
        gram = proc.f_mixing.spatial_cov(pt)
    k2_sites = sparse_k2(gram.contiguous(), "K_s(sites), SE, the Laplace family")
    return dict(st=rec, field_rate=dict(ms=t_rate, launches=(k1, k2), gaps=gaps),
                k1_sites=k1_sites, k2_sites=k2_sites,
                k2_launches=sum(v[1] for v in rec["launches"]) + k2)


def phase16e(proc):
    """Serving on 16a's model at 1024 query times: a Predictor batch of the
    predictive mean and variance (the rate's), quantiler(q=0.975) and 16
    joint draws with noise=True (host normals, the counts from one numpy
    Generator), each timed on its first call (16a warmed the scans),
    against the card's float64
    (moments and quantiles 1e-3 relative to scale).  A float32 prior
    trajectory carries the cancellation of Q at this series' steps (15c),
    so the latent draws are held to the float64 Laplace posterior they come
    from: the squared standardized gap of their mean and their variance
    over the posterior's, averaged over the queries, within ``DRAW_MOMENTS``;
    their gap to the float64 draws is printed beside."""
    params = proc.params_default
    tq = np.linspace(1.0, NG_N * 50.0 / 16384 - 1.0, 1024).astype(np.float32)[:, None]
    draws = host_normals(16, NG_N + len(tq), 2, 161)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with laplace_settings():
        pr = proc.predictor(params)
        zero_counts()
        stats, t_pr = timed(lambda: pr.predict(tq, mean=True, std=False, var=True, noise=True))
        quant, t_q = timed(lambda: proc.quantiler(params, tq, q=0.975))
        latent, t_l = timed(lambda: proc.sampler(params, tq, samples=16, seed=draws))
        counts, t_s = timed(lambda: proc.sampler(params, tq, samples=16, seed=draws, noise=True,
                                                 rng=np.random.default_rng(162)))
        require(launches()[:2] == (0, 0), f"16e launched K1/K2 {launches()[:2]}")
        with port_on(CARD, "float64"):
            p64 = ngssgp_model("P16A", NG_N)[0]
            mean64 = p64.mean(params, tq)
            var64 = p64.variance(params, tq, noise=True)
            quant64 = p64.quantiler(params, tq, q=0.975)
            latent64 = p64.sampler(params, tq, samples=16, seed=draws)
            loc64 = p64.location(params, tq)
            kd64 = p64.kernel_diag(params, tq)
    gaps = {"mean": rel_gap(stats["mean"], mean64),
            "variance": rel_gap(stats["variance"], var64),
            "quantile": rel_gap(quant, quant64)}
    limits = {"mean": 1e-3, "variance": 1e-3, "quantile": 1e-3}
    draw_stats = {"z2": float(np.mean((latent.mean(1) - loc64) ** 2 / (kd64 / 16))),
                  "var_ratio": float(np.mean(latent.var(1, ddof=1)) / np.mean(kd64)),
                  "gap_to_float64": rel_gap(latent, latent64)}
    print(f"  16e serving n=262144, 1024 queries: Predictor batch (mean, variance) {t_pr:.1f} ms, "
          f"quantiler {t_q:.1f} ms, 16 joint latent draws {t_l:.1f} ms, 16 count draws "
          f"{t_s:.1f} ms; vs the card's float64 {gaps}; the latent draws {draw_stats}",
          flush=True)
    require(all(np.isfinite(v) and v <= limits[k] for k, v in gaps.items())
            and np.all(counts >= 0) and np.all(counts == np.round(counts)),
            f"16e gaps {gaps} over {limits}")
    require(DRAW_MOMENTS[0] <= draw_stats["z2"] <= DRAW_MOMENTS[1]
            and DRAW_MOMENTS[0] <= draw_stats["var_ratio"] <= DRAW_MOMENTS[1],
            f"16e draws {draw_stats} outside {DRAW_MOMENTS}")
    return dict(predict_ms=t_pr, quantiler_ms=t_q, latent_draws_ms=t_l, count_draws_ms=t_s,
                gaps=gaps, draws=draw_stats)


# 16 joint draws held to the posterior they come from: the squared
# standardized gap of their mean and their variance over the posterior's,
# each averaged over the queries, read 0.92-1.03 on the H100 (16e and 17d,
# host normals, so the same each run); a draw scale off by 1.15 or more
# leaves this band
DRAW_MOMENTS = (0.8, 1.25)
F16_SINGLES = (0,)             # 16f's rows also evaluated alone (cut from 16 for time)


def phase16f():
    """One batched evaluation over 16 rows at n=16384 (15f's n) against the
    single evaluations of rows ``F16_SINGLES`` on the card (a single
    evaluation costs what the batch does: ~3.2 s of host-bound launches)
    and, every row, against the card's float64 batched evaluation."""
    with laplace_settings():
        proc = ngssgp_model("P16F", NG_ROWS_N)[0]
        u = proc.active.dict_to_array(proc.params_default)
        rows = u[None, :] + 0.1 * np.random.default_rng(24).standard_normal((16, len(u)))
        rt = torch.as_tensor(rows, dtype=torch.float32, device=CARD)
        proc._rows_value_and_grad(rt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, grad = proc._rows_value_and_grad(rt)
        torch.cuda.synchronize()
        t_rows = (time.perf_counter() - t0) * 1e3
        val, grad = val.cpu().numpy().astype(np.float64), grad.cpu().numpy().astype(np.float64)
        t0 = time.perf_counter()
        singles = [proc._rows_value_and_grad(rt[i]) for i in F16_SINGLES]
        torch.cuda.synchronize()
        t_single = (time.perf_counter() - t0) * 1e3 / len(F16_SINGLES)
        sv = np.array([float(v) for v, _ in singles])
        sg = np.stack([g.cpu().numpy() for _, g in singles]).astype(np.float64)
        with port_on(CARD, "float64"):
            p64 = ngssgp_model("P16F", NG_ROWS_N)[0]
            v64, g64 = p64._rows_value_and_grad(torch.as_tensor(rows, device=CARD))
            v64, g64 = v64.cpu().numpy(), g64.cpu().numpy()
    picked = list(F16_SINGLES)
    single_gap = max(rel_gap(val[picked], sv), rel_gap(grad[picked], sg))
    gaps = [held_value_grad(f"16f row {i}", (val[i], grad[i]), (v64[i], g64[i]), seed=i)
            for i in range(16)]
    worst = (max(g["gap"] for g in gaps), max(max(g["grad_gaps"]) for g in gaps))
    print(f"  16f 16 rows at n={NG_ROWS_N}: batched {t_rows:.1f} ms, a single evaluation "
          f"{t_single:.1f} ms (rows {picked}); batched vs single (relative to scale) "
          f"{single_gap:.2e}; vs the card's float64, worst value gap {worst[0]:.2e}, gradient "
          f"{worst[1]:.2e}", flush=True)
    require(single_gap <= 1e-4, f"16f batched vs single {single_gap:.2e}")
    return dict(batched_ms=t_rows, single_ms=t_single, single_gap=single_gap,
                worst_value_gap=worst[0], worst_grad_gap=worst[1])


def phase16(path):
    """Phase 16's runs; 16d's float32 evaluation and field_rate launches go
    to ``path`` (16a-c, 16e and 16f are held to no launch: MAT32 in time has
    no K1 gram)."""
    out, models = {}, {}

    def first():
        proc, u, rec = phase16a()
        models.update(proc=proc)
        return rec

    runs = (("16a", "NonGaussianSSGP(MAT32, Poisson) n=262144 (ngssm_scale.py)", first),
            ("16b", "the chunked route at n=1048576", phase16b),
            ("16c", "NonGaussianMultiSSGP(Poisson, Bernoulli) 9830 + 6554", phase16c),
            ("16d", f"NonGaussianSTSSGP m=32 S=64 n={ST_SITES * NGST_PER_SITE} (the Cox process)",
             lambda: phase16d(path)),
            ("16e", "serving on 16a's model", lambda: phase16e(models["proc"])),
            ("16f", "16 rows at n=16384", phase16f))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 17
# The Kronecker grid and SKI families (item 14): bench.py:437-471's GridGP
# (256 x 256, MAT52 x SE, N=65,536; one K1 launch an axis, (256,256,1)), the
# same grid with 10% of its cells dropped (the masked matrix-free path),
# bench.py:479-511's SKIGP (100,000 scattered rows on a 128 x 128 grid, K1
# at (128,128,1) an axis), and serving at 1024 queries.  Witnesses: the card
# in float64 (the estimators' probes are the same integers in both dtypes).
GRID_AXIS = 256
SKI_N, SKI_GRID = 100_000, 128


def grid_model(name, masked=False, seed=25):
    """bench.py:441-455's grid: t on linspace(0, 8, 256), x on
    linspace(-2, 2, 256), y = sin(t) exp(-x^2 / 2) + 0.1 noise; ``masked``
    drops a seeded 10% of the cells."""
    rng = np.random.default_rng(seed)
    tgr = np.linspace(0, 8, GRID_AXIS).astype(np.float32)
    xgr = np.linspace(-2, 2, GRID_AXIS).astype(np.float32)
    rows = g3t.grid_rows([tgr, xgr])
    y = (np.sin(rows[:, 0]) * np.exp(-0.5 * rows[:, 1] ** 2)
         + 0.1 * rng.standard_normal(rows.shape[0])).astype(np.float32)
    proc = g3t.GridGP(axes=[tgr, xgr], kernel=[g3t.MAT52(tgr[:, None]), g3t.SE(xgr[:, None])],
                      name=name)
    if masked:
        keep = np.sort(rng.choice(rows.shape[0], int(0.9 * rows.shape[0]), replace=False))
        rows, y = rows[keep], y[keep]
    proc.observed(rows, y)
    return proc, rows, y


def ski_model(name, seed=26):
    """bench.py:484-493's scattered rows: x uniform on (0, 10) x (-3, 3),
    y = sin(x0) exp(-0.3 x1^2) + 0.1 noise; a 128 x 128 grid, MAT52 x SE."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 10, SKI_N), rng.uniform(-3, 3, SKI_N)], 1).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.exp(-0.3 * x[:, 1] ** 2)
         + 0.1 * rng.standard_normal(SKI_N)).astype(np.float32)
    proc = g3t.SKIGP(kernel=[g3t.MAT52(x[:, :1]), g3t.SE(x[:, 1:2])],
                     grid_shape=[SKI_GRID, SKI_GRID], name=name)
    proc.observed(x, y)
    return proc, x, y


@contextlib.contextmanager
def counted_solves():
    """Count the PCG iterations (operator products) of every ``pcg_solve``
    in the block: ``out["solves"]`` one entry a solve."""
    out = {"solves": []}
    orig = ITER.pcg_solve

    def wrapped(matvec, b, p_inv, tol=1e-6, maxiter=100):
        calls = [0]

        def mv(v):
            calls[0] += 1
            return matvec(v)

        res = orig(mv, b, p_inv, tol=tol, maxiter=maxiter)
        out["solves"].append(calls[0])
        return res

    ITER.pcg_solve = wrapped
    try:
        yield out
    finally:
        ITER.pcg_solve = orig


def estimator_info(proc):
    """The loglike's diagnostics (quad, logdet, the CG relative residual)
    and the iterations of its solve, one uncounted evaluation."""
    from g3py_tpu_torch.ops.kron import masked_kron_nll, ski_nll

    pt = proc._tensor_params(proc.params_default)
    x, y = proc._device_data("inputs"), proc._device_data("outputs")
    with torch.no_grad(), counted_solves() as solves:
        if isinstance(proc, g3t.SKIGP):
            idx, w = proc._taps(x)
            sk = proc._ski
            _, info = ski_nll(proc._grams(pt), proc._noise_var(pt), proc._yres(pt, x, y), idx, w,
                              proc._grid_shape(), sk["rank"], sk["cg_iters"], sk["probes"],
                              sk["lanczos_iters"], sk["seed"])
        else:
            mk = proc._masked
            _, info = masked_kron_nll(proc._grams(pt), proc._noise_var(pt), proc._yres(pt, x, y),
                                      proc._idx_stack(x), proc._grid_shape(), mk["rank"],
                                      mk["cg_iters"], mk["probes"], mk["lanczos_iters"],
                                      mk["seed"])
    return {k: float(v) for k, v in info.items()} | {"cg_iterations": solves["solves"]}


def grid_evaluation(build, label, path, reps, axis, gates=(1e-3, 1e-2)):
    """A grid-family model's logp + gradient (K1 x2 an evaluation: the
    (axis, axis, 1) MAT52 and SE grams; no K2) against the card's float64
    (``gates``: value, gradient)."""
    proc = build()[0]
    u = proc.active.dict_to_array(proc.params_default)
    rec = evaluation_record(proc, u, label, reps=reps, path=path, predict=(2, 0),
                            predict_k1={f"mat52 (1, {axis}, {axis}, 1)": 1,
                                        f"se (1, {axis}, {axis}, 1)": 1})
    rec["witness"] = held_value_grad(f"{label} vs the card's float64", (rec["value"], rec["grad"]),
                                     value_grad_on(build, u, CARD, "float64"), gates=gates)
    rec.pop("grad")
    print(f"  {label} vs the card's float64: {rec['witness']}", flush=True)
    return proc, rec


def phase17a(path):
    proc, rec = grid_evaluation(lambda: grid_model("P17A"), "17a GridGP 256 x 256 MAT52 x SE",
                                path, reps=5, axis=GRID_AXIS)
    pt = proc._tensor_params(proc.params_default)
    ax = [torch.as_tensor(a, device=CARD) for a in proc._axes]
    rec["k1_mat52"] = k1_record(ax[0], ax[0], pt["P17A_MAT52_rate"], pt["P17A_MAT52_var"],
                                "17a K1 time axis", kind="mat52")
    rec["k1_se"] = k1_record(ax[1], ax[1], pt["P17A_SE_rate"], pt["P17A_SE_var"],
                             "17a K1 space axis")
    return proc, rec


# the matrix-free estimators' value and gradient against float64 with the
# same probes (value, gradient along two directions), set from the H100's
# readings: the masked grid read 1.4e-4 and 4.4e-5 (float32 Lanczos moves
# the SLQ log-determinant), SKI 2.7e-7 and 1.6e-6
MASKED_GATES = (1e-3, 1e-3)
SKI_GATES = (1e-5, 1e-4)


def phase17b(path):
    proc, rec = grid_evaluation(lambda: grid_model("P17B", masked=True),
                                "17b GridGP 256 x 256, 10% of the cells dropped", path, reps=1,
                                axis=GRID_AXIS, gates=MASKED_GATES)
    rec["estimator"] = estimator_info(proc)
    print(f"  17b the masked estimator: {rec['estimator']}", flush=True)
    require(rec["estimator"]["cg_rel_residual"] < 5e-2, "17b CG residual over 5e-2")
    return rec


def phase17c(path):
    proc, rec = grid_evaluation(lambda: ski_model("P17C"), "17c SKIGP n=100000 grid 128 x 128",
                                path, reps=3, axis=SKI_GRID, gates=SKI_GATES)
    rec["estimator"] = estimator_info(proc)
    print(f"  17c the SKI estimator: {rec['estimator']}", flush=True)
    require(rec["estimator"]["cg_rel_residual"] < 5e-2, "17c CG residual over 5e-2")
    pt = proc._tensor_params(proc.params_default)
    ax = [torch.as_tensor(a, device=CARD) for a in proc._axes]
    rec["k1_mat52"] = k1_record(ax[0], ax[0], pt["P17C_MAT52_rate"], pt["P17C_MAT52_var"],
                                "17c K1 inducing time axis", kind="mat52")
    rec["k1_se"] = k1_record(ax[1], ax[1], pt["P17C_SE_rate"], pt["P17C_SE_var"],
                             "17c K1 inducing space axis")
    return proc, rec


def phase17d(grid, ski, path):
    """Serving at 1024 queries: GridGP's Predictor batch (mean, variance)
    and 16 joint draws (host normals on the augmented grid), SKIGP's
    Predictor batch (alpha held as its state), each timed after a warm
    call; the moments against the card's float64 (GridGP 1e-3 of scale,
    SKIGP's PCG-limited ones 1e-2).  A draw is Q sqrt(lam) eps over the
    augmented axes' eigenvectors, whose signs and order differ between
    float32 and float64, so the draws are held to the posterior they come
    from: the squared standardized gap of their mean, and their variance
    over the posterior's, each averaged over the queries, within
    ``DRAW_MOMENTS``; the warm calls are not counted."""
    rng = np.random.default_rng(27)
    xq = np.stack([rng.uniform(0.2, 7.8, 1024), rng.uniform(-1.9, 1.9, 1024)],
                  1).astype(np.float32)
    xs = np.stack([rng.uniform(0.2, 9.8, 1024), rng.uniform(-2.9, 2.9, 1024)],
                  1).astype(np.float32)
    u_size = (GRID_AXIS + 1024, GRID_AXIS + 1024)
    normals = {"field": rng.standard_normal((16,) + u_size),
               "noise": rng.standard_normal((16, GRID_AXIS * GRID_AXIS))}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        with counted(path):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

    pg, ps = grid.predictor(grid.params_default), ski.predictor(ski.params_default)
    g_stats, t_g = timed(lambda: pg.predict(xq, mean=True, std=False, var=True))
    g_draws, t_d = timed(lambda: grid.sampler(grid.params_default, xq, samples=16, seed=normals))
    s_stats, t_s = timed(lambda: ps.predict(xs, mean=True, std=False, var=True))
    with port_on(CARD, "float64"):
        g64 = grid_model("P17A")[0]
        gm64, gv64 = g64.mean(g64.params_default, xq), g64.variance(g64.params_default, xq)
        s64 = ski_model("P17C")[0]
        ps64 = s64.predictor(s64.params_default)
        s64_stats = ps64.predict(xs, mean=True, std=False, var=True)
    npy = np.asarray
    gaps = {"grid_mean": rel_gap(npy(g_stats["mean"]), npy(gm64)),
            "grid_variance": rel_gap(npy(g_stats["variance"]), npy(gv64)),
            "ski_mean": rel_gap(npy(s_stats["mean"]), npy(s64_stats["mean"])),
            "ski_variance": rel_gap(npy(s_stats["variance"]), npy(s64_stats["variance"]))}
    limits = dict(grid_mean=1e-3, grid_variance=1e-3, ski_mean=1e-2, ski_variance=1e-2)
    mu, var = npy(gm64), npy(gv64)
    draw_stats = {"z2": float(np.mean((g_draws.mean(1) - mu) ** 2 / (var / 16))),
                  "var_ratio": float(np.mean(g_draws.var(1, ddof=1)) / np.mean(var))}
    print(f"  17d serving at 1024 queries: GridGP batch (mean, variance) {t_g:.1f} ms, 16 draws "
          f"{t_d:.1f} ms, SKIGP batch (mean, variance) {t_s:.1f} ms; vs the card's float64 "
          f"{gaps}; the draws against their posterior {draw_stats}", flush=True)
    require(all(np.isfinite(v) and v <= limits[k] for k, v in gaps.items()),
            f"17d gaps {gaps} over {limits}")
    require(all(DRAW_MOMENTS[0] <= v <= DRAW_MOMENTS[1] for v in draw_stats.values()),
            f"17d draws {draw_stats} outside {DRAW_MOMENTS}")
    return dict(grid_batch_ms=t_g, grid_draws_ms=t_d, ski_batch_ms=t_s, gaps=gaps,
                draws=draw_stats)


def phase17(path):
    """Phase 17's runs; the float32 evaluations' and serving's K1 launches go
    to ``path`` (the grid families make no K2 launch)."""
    out, models = {}, {}

    def grid():
        proc, rec = phase17a(path)
        models["grid"] = proc
        return rec

    def ski():
        proc, rec = phase17c(path)
        models["ski"] = proc
        return rec

    runs = (("17a", "GridGP 256 x 256 (bench.py:437-471)", grid),
            ("17b", "the masked grid (10% dropped)", lambda: phase17b(path)),
            ("17c", "SKIGP n=100000, 128 x 128 (bench.py:479-511)", ski),
            ("17d", "serving at 1024 queries", lambda: phase17d(models["grid"], models["ski"],
                                                                path)))
    for key, label, run in runs:
        print(f"phase {key}: {label}", flush=True)
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 18
# ROADMAP item 15 on the card: Bayesian optimization at full width (phase
# 5's GP(Bias, SE) at n=4096, d=8, at its MAP), Thompson picks, BayesOpt.run
# on tutorial 18's warped 2-D problem, the fused split-training grid
# (fit_splits at benchmarks/fit_splits_probe.py's n=512, 8 x 4 pairs;
# Experiment.run_fanout on phase 14e's experiment), the kernel structure
# search (tutorial 03's additive problem, and phase 5's data at n=4096) and
# the utils on the card (checkpoints, model files, debug_mode,
# profile_trace).  Witnesses: float64 numpy/scipy on the host (18a, 18d),
# the port on the CPU in a process of its own (18f's winner), run() (18e).
BO_STEPS = 60
BO_BOUND = 3.0
ACQ_GATES = (1e-3, 1e-2)      # 18a: value, directional derivative (relative)
FANOUT_ITERS = 60             # 18d: benchmarks/fit_splits_probe.py's max_iters
RUN_FANOUT_ITERS = 40         # 18e (fit_splits' default 200, cut for time)
SEARCH_CPU = r'''
import json, sys
import numpy as np
import g3py_tpu_torch as g3t
g3t.settings.device = "cpu"
rng = np.random.default_rng(5)
n = 140
xs = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
ys = (np.sin(3 * xs[:, 0]) + 0.5 * xs[:, 1] ** 2 + 0.1 * rng.standard_normal(n)).astype(np.float32)
zoo = {"SE": g3t.SE, "SE0": (lambda x_, name=None: g3t.SE([0], name=name)),
       "SE1": (lambda x_, name=None: g3t.SE([1], name=name))}
res = g3t.search_kernel(xs, ys, bases=("SE", "SE0", "SE1"), depth=1, points=1, zoo=zoo,
                        expand="all")
print(json.dumps({"winner": res.best_name, "evaluated": len(res.table)}))
'''


def tut03_search_data():
    """Tutorial 03's additive 2-D problem at n=140 (its full size)."""
    rng = np.random.default_rng(5)
    n = 140
    xs = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    ys = (np.sin(3 * xs[:, 0]) + 0.5 * xs[:, 1] ** 2
          + 0.1 * rng.standard_normal(n)).astype(np.float32)
    zoo = {"SE": g3t.SE, "SE0": (lambda x_, name=None: g3t.SE([0], name=name)),
           "SE1": (lambda x_, name=None: g3t.SE([1], name=name))}
    return xs, ys, zoo


def host_se_factor(reg, u, x, y, dtype=np.float64):
    """GP(Bias, SE)'s observed gram factored on the host in ``dtype``
    (float32: the rounding witness): (params, inputs, Cholesky, alpha)."""
    import scipy.linalg

    p = host_params(reg, u, dtype)
    x, y = np.asarray(x, dtype), np.asarray(y, dtype)
    k = (host_gram(x, x, p["SE_rate"], p["SE_var"])
         + p["Noise_var"] * np.eye(len(x), dtype=dtype))
    chol = scipy.linalg.cholesky(k, lower=True)
    return p, x, chol, scipy.linalg.cho_solve((chol, True), y - p["Bias_Bias"])


def host_se_moments(factor, xq, dvec=None):
    """The posterior mean and latent sd at ``xq`` from a
    :func:`host_se_factor`, in its dtype; with ``dvec`` (a direction a
    query point) also their analytic derivatives along it."""
    import scipy.linalg

    p, x, chol, alpha = factor
    dtype = x.dtype
    xq = np.asarray(xq, dtype)
    cross = host_gram(xq, x, p["SE_rate"], p["SE_var"])
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    var = np.maximum(p["SE_var"] - (v * v).sum(axis=0), 0.0)
    mean, sd = p["Bias_Bias"] + cross @ alpha, np.sqrt(var)
    if dvec is None:
        return mean, sd
    # d k(q, x_j) along d_q = -k rate^2 (q - x_j) . d_q
    r2 = np.asarray(p["SE_rate"], dtype) ** 2
    diff = xq[:, None, :] - x[None, :, :]
    dcross = -cross * (diff * (r2 * np.asarray(dvec, dtype))[:, None, :]).sum(-1)
    dv = scipy.linalg.solve_triangular(chol, dcross.T, lower=True)
    dmean = dcross @ alpha
    dsd = -(v * dv).sum(axis=0) / np.maximum(sd, 1e-30)
    return mean, sd, dmean, dsd


def host_acq(kind, mean, sd, best, xi, beta, dmean=None, dsd=None):
    """BayesOpt's acquisitions (maximization) in float64 with scipy, and
    their derivatives from the mean's and the sd's along a direction."""
    from scipy import stats

    sd = np.maximum(sd, 1e-10)
    z = (mean - best - xi) / sd
    if kind == "UCB":
        return mean + beta * sd, (None if dmean is None else dmean + beta * dsd)
    h = stats.norm.pdf(z) + z * stats.norm.cdf(z)
    zs = np.minimum(z, -1.0)
    tail = (stats.norm.logpdf(zs) - 2.0 * np.log(-zs)
            + np.log1p(np.maximum(-3.0 / zs ** 2, -0.999)))
    value = np.log(sd) + np.where(z > -4.0, np.log(np.maximum(h, 1e-30)), tail)
    if dmean is None:
        return value, None
    # d log h / dz: Phi / h directly, the tail's own derivative below z = -4
    ratio = np.where(z > -4.0, stats.norm.cdf(z) / np.maximum(h, 1e-300),
                     -zs - 2.0 / zs + (6.0 / zs ** 3) / (1.0 - 3.0 / zs ** 2))
    return value, dsd / sd + ratio * (dmean - z * dsd) / sd


def k1_grad_record(x1, x2, rate, var, label):
    """:func:`k1_record`, then the forward and the x1 gradient together (the
    ascent's use: the backward differentiates the plain form) against the
    plain form's, with the gradient checked against the plain form's."""
    rec = k1_record(x1, x2, rate, var, label)
    xg = x1.clone().requires_grad_(True)

    def fwd_bwd(fn):
        with torch.enable_grad():
            return torch.autograd.grad(fn("se", xg, x2, rate, var).sum(), xg)[0]

    g, gp_ = fwd_bwd(stationary_gram), fwd_bwd(_plain_form)
    err = float((g - gp_).abs().max() / gp_.abs().max())
    require(err <= 1e-4 and finite(g), f"{label}: K1's x1 gradient vs plain {err:.2e}")
    rec.update(grad_ms=event_ms(lambda: fwd_bwd(stationary_gram), reps=10),
               plain_grad_ms=event_ms(lambda: fwd_bwd(_plain_form), reps=10), grad_rel_err=err)
    print(f"  {label} forward + x1 gradient: {rec['grad_ms']:.4f} ms (plain "
          f"{rec['plain_grad_ms']:.4f} ms), gradient vs plain {err:.2e}", flush=True)
    return rec


def batched_k1_record(x, rate, var, label):
    """K1 over R rows of (rate, var) on one shared (n, d) input against the
    plain form row by row (phase 6a's tolerance), with its CUDA-event time
    over 20 launches back to back, the wrapper's, the plain form's and the
    bound."""
    rtol, atol_rel = TOL[x.dtype]
    out = stationary_gram("se", x, x, rate, var)
    err = 0.0
    for r in range(rate.shape[0]):
        ref = _plain_form("se", x, x, rate[r], var[r])
        gap = (out[r] - ref).abs()
        require(bool((gap <= atol_rel * var.max() + rtol * ref.abs()).all()) and finite(out[r]),
                f"{label} row {r} K1 vs plain {float(gap.max()):.2e}")
        err = max(err, float(gap.max()))
    (n, d), rows = x.shape, rate.shape[0]
    t_k = back_to_back_ms(k1_kernel("se", x, x, rate, var))
    t_wrap = event_ms(lambda: stationary_gram("se", x, x, rate, var), reps=10)
    t_plain = event_ms(lambda: _plain_form("se", x, x, rate, var), reps=5)
    bound = k1_bound_ms(n, n, d, rows)
    print(f"  {label} K1 ({rows},{n},{n},{d}) SE f32: every row matches the plain form (max "
          f"abs err {err:.2e}); kernel {t_k:.4f} ms (events, back to back), wrapper "
          f"{t_wrap:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms", flush=True)
    return dict(ms=t_k, wrapper_ms=t_wrap, plain_ms=t_plain, bound_ms=bound, bound_by="bytes",
                library_ms=None, max_abs_err=err)


def fanout_kernels(x, rows, label, seed):
    """18d/18e's batched K1 and K2 at the fan-out's shapes: R rows of
    (rate, var) on the observed inputs, their grams + noise factored by one
    batched K2 call."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    xt = torch.as_tensor(x, device=CARD)
    d = xt.shape[1]
    rate = 0.5 + torch.rand(rows, d, generator=gen, device=CARD)
    var = 0.5 + torch.rand(rows, generator=gen, device=CARD)
    k1 = batched_k1_record(xt, rate, var, label)
    a = stationary_gram("se", xt, xt, rate, var)
    a.diagonal(dim1=-2, dim2=-1).add_(0.1)
    k2 = latent_k2_record(a, label=label)
    return k1, k2


def phase18a(gp, gp_map, x, y, path):
    """BO at full width: logEI q=4 (kriging believer) and UCB q=1 on phase
    5's GP at its MAP.  Gates: the picks finite and inside the bounds; at
    the UCB ascent's final starts both acquisitions and their derivatives
    along two directions against float64 numpy/scipy (the card in float64
    at the gates, in float32 at the gates or within 4x a float32 host
    witness's gaps); the believer lie
    against the float64 posterior mean, clamped; K2 once a conditioning set
    and K1 by shape as the design predicts."""
    n, d = x.shape
    reg = gp.active
    u = reg.dict_to_array(gp_map)
    bo = g3t.BayesOpt(gp, bounds=[[-BO_BOUND, BO_BOUND]] * d, maximize=True, seed=18)
    kw = dict(candidates=2048, starts=16, steps=BO_STEPS)
    out, counts = {}, {}
    for kind, q in (("logEI", 4), ("UCB", 1)):
        with counted(path):
            t0 = time.perf_counter()
            picks = np.atleast_2d(bo.suggest(gp_map, kind=kind, q=q, liar="mean", **kw))
            torch.cuda.synchronize()
            t_s = time.perf_counter() - t0
            k1, k2, retries = launches()
            counts[kind] = k1_shapes()
        require(picks.shape == (q, d) and np.isfinite(picks).all()
                and np.all(np.abs(picks) <= BO_BOUND), f"18a {kind}: picks {picks}")
        require(k2 == q and retries == 0, f"18a {kind} q={q}: K2 x{k2} ({retries} retries), "
                f"expected one factorization a conditioning set ({q})")
        want = collections.Counter()
        for i in range(q):
            m = n + i
            want[f"se (1, {m}, {m}, {d})"] += 1                  # the state's gram
            want[f"se (1, 2048, {m}, {d})"] += 1                 # the screen
            want[f"se (1, 16, {m}, {d})"] += BO_STEPS + 1        # the ascent, the final starts
            if q > 1:
                want[f"se (1, 1, {m}, {d})"] += 1                # the believer's mean
        require(counts[kind] == dict(want), f"18a {kind}: K1 by shape {counts[kind]}, the "
                f"design predicts {dict(want)}")
        out[kind] = dict(s=t_s, picks=picks.tolist(), k1=k1, k2=k2)
        print(f"  18a suggest(kind={kind!r}, q={q}): {t_s * 1e3:.1f} ms, K1 x{k1} {counts[kind]}, "
              f"K2 x{k2}", flush=True)
    # the acquisitions at the UCB ascent's final starts vs float64: the
    # card in float64 at the gates; the card in float32 (the main path)
    # at the gates, or within 4x a float32 host witness's gaps where
    # float32 rounding at the MAP (cond(K) high) goes beyond them
    xf = bo.last_starts.detach()
    inputs, outputs, best_g = bo._data()
    p0 = bo._conditioned(gp_map, inputs, outputs)
    dirs = np.random.default_rng(181).standard_normal((2,) + tuple(xf.shape))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xh = xf.double().cpu().numpy()

    factors = {}

    def host(kind, dvec, dtype=np.float64):
        if dtype not in factors:
            factors[dtype] = host_se_factor(reg, u, x, y, dtype)
        m, sd, dm, dsd = host_se_moments(factors[dtype], xh, dvec)
        return host_acq(kind, *(np.asarray(t, np.float64) for t in (m, sd)),
                        float(best_g), bo.xi, bo.beta,
                        *(np.asarray(t, np.float64) for t in (dm, dsd)))

    def card(kind, p, xq, data):
        xt = xq.clone().requires_grad_(True)
        with torch.enable_grad():
            val = bo._acq(kind, p, xt, *data)
            (grad,) = torch.autograd.grad(val.sum(), xt)
        g = grad.double().cpu().numpy()
        return val.detach().double().cpu().numpy(), [(g * dv).sum(axis=1) for dv in dirs]

    def gaps(got, refs):
        (v, ds), (rv, rds) = got, refs
        return (float(np.abs(v - rv).max() / max(np.abs(rv).max(), 1.0)),
                max(float(np.abs(d - rd).max() / max(np.abs(rd).max(), 1e-12))
                    for d, rd in zip(ds, rds)))

    g3t.settings.floatx = "float64"
    try:
        data64 = tuple(t.double() for t in (inputs, outputs, best_g))
        p64 = bo._conditioned(gp_map, *data64[:2])
        got64 = {kind: card(kind, p64, xf.double(), data64) for kind in ("UCB", "logEI")}
    finally:
        g3t.settings.floatx = "float32"
    out["acq_gaps"] = {}
    for kind in ("UCB", "logEI"):
        refs = [host(kind, dv) for dv in dirs]
        ref = (refs[0][0], [r[1] for r in refs])
        gap64 = gaps(got64[kind], ref)
        require(gap64[0] <= ACQ_GATES[0] and gap64[1] <= ACQ_GATES[1], f"18a {kind} float64 "
                f"at the final starts: value {gap64[0]:.2e}, derivative {gap64[1]:.2e}")
        gap32 = gaps(card(kind, p0, xf, (inputs, outputs, best_g)), ref)
        witness = []

        def witness_gap(i):
            if not witness:
                wit = [host(kind, dv, np.float32) for dv in dirs]
                witness.extend(gaps((wit[0][0], [w[1] for w in wit]), ref))
            return witness[i]

        for i, what in enumerate(("value", "derivative")):
            held(gap32[i], ACQ_GATES[i], lambda: witness_gap(i),
                 f"18a {kind} float32 {what} at the final starts")
        out["acq_gaps"][kind] = dict(float64=gap64, float32=gap32, witness32=witness or None)
    print(f"  18a at the 16 final starts vs float64 (value, derivative along 2 directions): "
          f"{out['acq_gaps']}", flush=True)
    # the believer's lie at the first logEI pick
    pick0 = np.asarray(out["logEI"]["picks"][0], np.float32)
    lie = float(bo._fantasy(p0, pick0, inputs, outputs, "mean"))
    mean0 = host_se_moments(factors[np.float64], pick0[None])[0][0]
    lie_ref = float(np.clip(mean0, y.min(), y.max()))
    lie_gap = abs(lie - lie_ref) / max(abs(lie_ref), 1.0)
    require(lie_gap <= ACQ_GATES[0], f"18a believer lie {lie} vs float64 {lie_ref}")
    print(f"  18a believer lie {lie:.6f} vs float64 {lie_ref:.6f}", flush=True)
    out["lie_gap"] = lie_gap
    # K1 at the screen's and the ascent's shapes, with the x1 gradient; K2 at
    # a fantasy's ragged n
    hp = host_params(reg, u, np.float32)
    rate = torch.as_tensor(hp["SE_rate"], device=CARD)
    var = torch.tensor(float(hp["SE_var"]), device=CARD)
    xt = torch.as_tensor(x, device=CARD)
    gen = torch.Generator(device=CARD).manual_seed(18)
    cand = (2 * torch.rand(2048, d, generator=gen, device=CARD) - 1) * BO_BOUND
    out["k1_screen"] = k1_grad_record(cand, xt, rate, var, "18a K1 screen")
    out["k1_ascent"] = k1_grad_record(cand[:16].contiguous(), xt, rate, var, "18a K1 ascent")
    out["k2_ragged"] = sparse_k2(se_gram_plus_noise(n + 1, torch.float32, 18),
                                 label="a fantasy's gram, ragged n")
    return out


def phase18b(gp, gp_map):
    """Thompson q=4 on 2048 candidates: each pick is the argmax of its own
    draw column (the same seed's paths drawn again on the same
    candidates)."""
    d = gp.inputs.shape[1]
    bo = g3t.BayesOpt(gp, bounds=[[-BO_BOUND, BO_BOUND]] * d, seed=181)
    stream = copy.deepcopy(bo.rng)
    t0 = time.perf_counter()
    picks = bo.suggest(gp_map, kind="thompson", q=4, candidates=2048, key=7)
    t_s = time.perf_counter() - t0
    cand = (-BO_BOUND + 2 * BO_BOUND * stream.random((2048, d))).astype(np.float32)
    draws = gp.predictor(gp_map).pathwise_sampler(space=cand, samples=4, key=7).cpu().numpy()
    require(np.isfinite(draws).all(), "18b: non-finite draws")
    require(np.array_equal(picks, cand[np.argmax(draws, axis=0)]),
            "18b: a Thompson pick is not the argmax of its own draw column")
    print(f"  18b thompson q=4 on 2048 candidates: {t_s * 1e3:.1f} ms, every pick its column's "
          f"argmax", flush=True)
    return dict(s=t_s)


def phase18c():
    """BayesOpt.run on tutorial 18's warped 2-D minimization: WGP(Bias,
    SE, BoxCoxShifted), logEI, init 8, iters 10, 1024 candidates, 30 steps,
    a find_MAP refit each iteration."""
    def f_2d(x):
        x = np.atleast_2d(x)
        return ((x[..., 0] - 1.0) ** 2 + 2.0 * (x[..., 1] - 1.5) ** 2
                + 0.3 * np.sin(4 * x[..., 0]) ** 2)

    gp2 = g3t.WGP(space=np.zeros((4, 2), np.float32), location=g3t.Bias(), kernel=g3t.SE(2),
                  noisy=True, mapping=g3t.BoxCoxShifted(), name="P18C")
    bo = g3t.BayesOpt(gp2, bounds=[[-1.0, 3.0], [-1.0, 3.5]], maximize=False, seed=2, xi=0.05)
    refits, inner = [], bo._refit

    def refit(params, kw):
        params = inner(params, kw)
        refits.append(params)
        return params

    bo._refit = refit
    t0 = time.perf_counter()
    _, hist = bo.run(f_2d, iters=10, init=8, kind="logEI", candidates=1024, steps=30)
    t_run = time.perf_counter() - t0
    best0, best = min(hist["y"][:8]), hist["best_y"][-1]
    finite_refits = all(np.isfinite(np.asarray(v, np.float64)).all()
                        for p in refits for v in p.values())
    require(len(refits) == 11 and finite_refits, "18c: a refit is not finite")
    require(best < best0, f"18c: best {best} did not improve on the initial design's {best0}")
    print(f"  18c BayesOpt.run (tutorial 18's 2-D warped problem): best {best:.4f} from the "
          f"initial design's {best0:.4f}; {t_run:.1f} s, {t_run / 10 * 1e3:.0f} ms an "
          f"iteration (suggest + a find_MAP refit)", flush=True)
    return dict(s=t_run, ms_per_iter=t_run / 10 * 1e3, best=best, best_initial=best0)


def phase18d(path):
    """fit_splits on benchmarks/fit_splits_probe.py's grid: GP(Bias, SE),
    n=512, 8 splits x 4 starts, max_iters=60.  Gates: each split's best
    value against the float64 host logp of its submatrix at the returned
    params (1e-3 relative); the masked logp on the card against the
    subset's plain logp (float32, 1e-4 relative); one batched K1 and one
    batched K2 (plus retries) an evaluation."""
    rng = np.random.default_rng(0)
    n = 512
    x = np.sort(rng.uniform(0, 50, n)).astype(np.float32).reshape(-1, 1)
    y = (np.sin(0.4 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="FSP")
    gp.observed(x, y)
    S, points = 8, 4
    masks = np.zeros((S, n), np.float32)
    for i in range(S):
        masks[i, np.sort(rng.choice(n, int(0.8 * n), replace=False))] = 1.0
    with counted(path):
        t0 = time.perf_counter()
        plist, vals, pts = g3t.fit_splits(gp, masks, points=points, max_iters=FANOUT_ITERS,
                                          return_points=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        k1, k2, retries = launches()
        shapes = k1_shapes()
    evals = g3t.lbfgs_maximize.evaluations
    require(k1 == evals and k2 == evals + retries, f"18d: K1 x{k1}, K2 x{k2} ({retries} "
            f"retries) for {evals} evaluations")
    reg, like = gp.active, gp.th_loglike_masked_fn()
    gaps, card_gaps = [], []
    for i in range(S):
        keep = masks[i].astype(bool)
        u = pts[i, int(np.argmax(vals[i]))]
        ref = host_logp(reg, u, x[keep].astype(np.float64), y[keep].astype(np.float64))
        ref += prior_terms(reg, u)[0]
        gaps.append(abs(vals[i].max() - ref) / abs(ref))
        with torch.no_grad():
            masked = float(like(reg.array_to_dict_tensor(torch.as_tensor(u, device=CARD)),
                                *gp._resolve_data(None, None, None)[1:],
                                torch.as_tensor(masks[i], device=CARD)))
        sub = g3t.GP(space=x[keep], location=g3t.Bias(), kernel=g3t.SE(x), name="FSP_SUB")
        sub.observed(x[keep], y[keep])
        plain = sub.loglike({k.replace("FSP_", "FSP_SUB_"): v for k, v in plist[i].items()})
        card_gaps.append(abs(masked - plain) / abs(plain))
    require(max(gaps) <= 1e-3, f"18d: the splits' best values vs float64 host {max(gaps):.2e}")
    require(max(card_gaps) <= 1e-4, f"18d: the masked logp vs the subset's {max(card_gaps):.2e}")
    print(f"  18d fit_splits n=512, 8 x 4 pairs, max_iters {FANOUT_ITERS}: {t_fit:.2f} s, "
          f"{evals} evaluations ({g3t.lbfgs_maximize.iterations} iterations), K1 x{k1}, K2 "
          f"x{k2}; best values vs float64 host {max(gaps):.2e}, masked vs subset logp "
          f"{max(card_gaps):.2e}; K1 by shape {shapes}", flush=True)
    k1r, k2r = fanout_kernels(x, S * points, "18d fan-out R=32 n=512", 184)
    return dict(s=t_fit, evaluations=evals, host_gap=max(gaps), card_gap=max(card_gaps),
                k1=k1r, k2=k2r, launches=[k1, k2])


def phase18e(x_map, scipy_l2, path):
    """Experiment.run_fanout on phase 14e's experiment (GP and WGP at
    n=4096, p=0.5, 2 simulations, 2 starts): every row finite; each test
    l2 within tests/test_experiment.py's rule (a < 1.5 b + 0.05) of 14e's
    run(); a second call adds no row; the peak memory."""
    y_pos = (np.abs(np.sin(x_map[:, 0])) + 0.5
             + 0.1 * np.random.default_rng(146).standard_normal(len(x_map))).astype(np.float32)
    models = [g3t.GP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.SE(x_map),
                     name="P14E_GP"),
              g3t.WGP(space=x_map[:4], location=g3t.Bias(), kernel=g3t.MAT52(x_map),
                      mapping=g3t.BoxCoxLinear(y_pos), name="P14E_WGP")]
    e = g3t.Experiment(models=models)
    e.set_data(x_map, y_pos, p=0.5)
    e.set_selection(starts=2, powell=False)
    torch.cuda.reset_peak_memory_stats()
    with counted(path):
        t0 = time.perf_counter()
        res = e.run_fanout(n_simulations=2, max_iters=RUN_FANOUT_ITERS)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        k1, k2, _ = launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    cols = [c for c in res.columns if c.startswith(("obs_", "test_"))]
    require(len(res) == 4 and np.isfinite(np.array([res[c].astype(np.float64)
                                                    for c in cols])).all(), "18e: result rows")
    fan = e.describe("test_l2")
    for m, ref in scipy_l2.items():
        for sim, (a, b) in enumerate(zip(fan[m], ref)):
            require(a < 1.5 * b + 0.05, f"18e {m} simulation {sim}: test_l2 {a} vs run()'s {b}")
    require(len(e.run_fanout(n_simulations=2)) == 4, "18e: a second call added rows")
    print(f"  18e run_fanout (GP, WGP at n=4096, 2 simulations x 2 starts): {t_run:.1f} s, K1 "
          f"x{k1}, K2 x{k2}, peak {peak:.2f} GB; test_l2 "
          f"{ {m: fan[m].tolist() for m in scipy_l2} } vs run()'s {scipy_l2}", flush=True)
    k1r, k2r = fanout_kernels(x_map, 4, "18e fan-out R=4 n=4096", 185)
    return dict(s=t_run, peak_gb=peak, launches=[k1, k2], k1=k1r, k2=k2r,
                test_l2={m: fan[m].tolist() for m in scipy_l2})


def phase18f(x_map, y_map, cpu, path):
    """The kernel structure search: (i) tutorial 03's additive 2-D problem,
    n=140, bases SE/SE0/SE1, depth 1 (9 host-bound fits; depth 2's 28 took
    41 s), expand='all' — the winner is the CPU port's (``cpu``, a process
    started earlier); (ii) phase 5's data at n=4096, bases SE and MAT52,
    depth 1, root: every candidate finite."""
    xs, ys, zoo = tut03_search_data()
    with counted(path):
        t0 = time.perf_counter()
        res = g3t.search_kernel(xs, ys, bases=("SE", "SE0", "SE1"), depth=1, points=1,
                                zoo=zoo, expand="all")
        t_i = time.perf_counter() - t0
    out_cpu, err = cpu.communicate(timeout=600)
    require(cpu.returncode == 0, f"18f: the CPU search failed: {err[-2000:]}")
    want = json.loads(out_cpu.strip().splitlines()[-1])
    require(res.best_name == want["winner"], f"18f(i): winner {res.best_name} on the card, "
            f"{want['winner']} on the CPU")
    with counted(path):
        t0 = time.perf_counter()
        big = g3t.search_kernel(x_map, y_map, bases=("SE", "MAT52"), depth=1, points=1)
        t_ii = time.perf_counter() - t0
    crits = [r["criterion"] for r in big.table]
    require(len(crits) == 6 and np.isfinite(crits).all(), f"18f(ii): criteria {crits}")
    print(f"  18f(i) tutorial 03's search: winner {res.best_name} (the CPU port's too), "
          f"{len(res.table)} structures in {t_i:.1f} s; (ii) n=4096: winner {big.best_name}, "
          f"criteria {np.round(crits, 1).tolist()} in {t_ii:.1f} s", flush=True)
    return dict(s_i=t_i, s_ii=t_ii, winner=res.best_name, winner_4096=big.best_name)


def phase18g(gp, gp_map, dt16):
    """The utils on the card: a checkpoint round trip of phase 5's MAP as
    CUDA tensors and of a datatrace; a model file saved then loaded (logp
    bit-equal; the same file loads on the CPU); debug_mode on a NaN made
    on the card; profile_trace's chrome trace."""
    import tempfile

    folder = Path(tempfile.mkdtemp())
    tensors = {k: torch.as_tensor(np.asarray(v), device=CARD) for k, v in gp_map.items()}
    for target in (str(folder / "map.npz"), str(folder / "map_dir")):
        back = g3t.load_checkpoint(g3t.save_checkpoint(tensors, target))
        require(all(np.array_equal(back[k], v.cpu().numpy()) for k, v in tensors.items()),
                f"18g: checkpoint {target}")
    back = g3t.load_checkpoint(g3t.save_checkpoint(dt16, str(folder / "dt.npz")))
    require(list(back) == dt16.columns and all(np.array_equal(back[c], dt16[c])
                                              for c in dt16.columns), "18g: datatrace")
    gp.save(str(folder / "gp.g3"))
    loaded = g3t.GP(space=gp.inputs[:4], location=g3t.Bias(), kernel=g3t.SE(gp.inputs),
                    name=gp.name, file=str(folder / "gp.g3"))
    lp, lp_loaded = gp.logp(gp_map), loaded.logp(gp_map)
    require(lp == lp_loaded, f"18g: the loaded model's logp {lp_loaded} vs {lp}")
    g3t.settings.device = "cpu"
    try:
        lp_cpu = g3t.utils.load_pkl(str(folder / "gp.g3")).logp(gp_map)
    finally:
        g3t.settings.device = CARD
    require(abs(lp_cpu - lp) <= 1e-3 * abs(lp), f"18g: the file on the CPU {lp_cpu} vs {lp}")
    try:
        with g3t.debug_mode():
            torch.log(-torch.ones(4, device=CARD))
        raise RuntimeError("chip_smoke check failed: 18g debug_mode let a NaN through")
    except FloatingPointError:
        pass
    with g3t.profile_trace(str(folder / "trace")) as tp:
        gp.logp(gp_map)
    with open(Path(tp) / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    require(any("stationary_gram" in nm for nm in names), "18g: the trace holds no K1 launch")
    print(f"  18g checkpoints (CUDA tensors, a datatrace), the model file (logp bit-equal, "
          f"{lp_cpu:.4f} on the CPU vs {lp:.4f}), debug_mode and profile_trace on the card",
          flush=True)
    return dict(logp=lp, logp_cpu=lp_cpu)


def start_search_cpu():
    """18f(i)'s CPU witness: tutorial 03's search by the port on the CPU, in
    a process of its own (started at the beginning of the run, read in
    18f)."""
    return subprocess.Popen([sys.executable, "-c", SEARCH_CPU], cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))


def phase18(gp, gp_map, x_map, y_map, dt16, scipy_l2, path, path_batched, cpu=None):
    """Phase 18's runs; the launches of 18a's suggest calls and 18f's
    searches go to ``path``, 18d's and 18e's fan-outs (batched over the
    pairs) to ``path_batched``; the CPU search of 18f(i) runs in a process
    of its own (``cpu``, :func:`start_search_cpu`; started here when
    None)."""
    cpu = start_search_cpu() if cpu is None else cpu
    out = {}
    try:
        runs = (("18a", "BO at full width, GP(Bias, SE) n=4096",
                 lambda: phase18a(gp, gp_map, x_map, y_map, path)),
                ("18b", "Thompson picks", lambda: phase18b(gp, gp_map)),
                ("18c", "BayesOpt.run, tutorial 18's 2-D warped problem", phase18c),
                ("18d", "fit_splits n=512, 8 x 4 pairs", lambda: phase18d(path_batched)),
                ("18e", "Experiment.run_fanout at n=4096",
                 lambda: phase18e(x_map, scipy_l2, path_batched)),
                ("18f", "search_kernel", lambda: phase18f(x_map, y_map, cpu, path)),
                ("18g", "utils on the card", lambda: phase18g(gp, gp_map, dt16)))
        for key, label, run in runs:
            print(f"phase {key}: {label}", flush=True)
            t0 = time.perf_counter()
            out[key] = run()
            out[key]["wall_s"] = time.perf_counter() - t0
            print(f"  phase {key} wall {out[key]['wall_s']:.1f} s", flush=True)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    return out


# ---------------------------------------------------------------- phase 19
P19_N, P19_BLOCK, P19_MAP_ITERS, P19_RANKS = 16384, 256, 30, 4


def band_k2(a):
    """K2 on one (256, 256) diagonal tile of the band Cholesky: the m=512
    record's checks and times (:func:`sparse_k2`), its library time that of
    the pair it replaces, ``cholesky_ex`` and the inverse by
    ``solve_triangular``."""
    rec = sparse_k2(a, label="the band's diagonal tile")
    eye = torch.eye(a.shape[0], device=a.device, dtype=a.dtype)

    def pair():
        lkk = torch.linalg.cholesky_ex(a)[0]
        return torch.linalg.solve_triangular(lkk, eye, upper=False)

    rec["library_ms"] = back_to_back_ms(pair)
    print(f"  cholesky_ex + solve_triangular on the tile: {rec['library_ms']:.4f} ms (events, "
          "back to back)", flush=True)
    return rec


def phase19a(x_map, y_map, u_off):
    """The world of one (NCCL) at n=16384, and the n=4096 references (the
    GP at ``u_off``, phase 5's MAP moved off its zero gradient; the TP at
    its defaults)."""
    from g3py_tpu_torch.parallel.launch import run_local

    payload = dict(seed=19, n=P19_N, d=x_map.shape[1], block=P19_BLOCK, x4=x_map, y4=y_map,
                   u4={"gp": u_off, "tp": None})
    a = run_local(1, "g3py_tpu_torch.tools.dist_smoke:world_of_one", payload,
                  backend="nccl" if CARD.startswith("cuda") else "gloo", device=CARD,
                  timeout=600, collective_timeout=120)[0]
    (v, g), (v64, g64), (v32, g32) = a["band"], a["float64"], a["single32"]
    dgaps, _ = directional_gaps(g, g64, 191)
    gap = abs(v - v64) / abs(v64)
    require(gap <= 1e-3 and max(dgaps) <= 1e-2,
            f"19a: the band NLL {v} vs float64 {v64} (gap {gap:.2e}), gradient gaps {dgaps}")
    k1, k2 = a["launches"]
    require((k1, k2) == (2, P19_N // P19_BLOCK) or not CARD.startswith("cuda"),
            f"19a: K1/K2 launches an evaluation {(k1, k2)}, predicted (2, {P19_N // P19_BLOCK})")
    single_gaps, _ = directional_gaps(g32, g64, 191)
    summary = dict(band_ms=a["band_ms"], peak_gb=a["peak_gb"], launches=a["launches"],
                   value_gap=gap, dir_gaps=dgaps, single_value_gap=abs(v32 - v64) / abs(v64),
                   single_dir_gaps=single_gaps)
    print(f"  19a world of one (NCCL), GP n={P19_N} d=8 block {P19_BLOCK}: nll_distributed + "
          f"gradient {a['band_ms']:.1f} ms an evaluation, peak {a['peak_gb'] or 0.0:.2f} GB, K1/K2 "
          f"{k1}/{k2}; vs float64: value {gap:.2e}, gradient along two directions "
          f"{[f'{t:.2e}' for t in dgaps]} (the single-device float32 path: value "
          f"{summary['single_value_gap']:.2e}, gradient {[f'{t:.2e}' for t in single_gaps]})",
          flush=True)
    return summary, a


def phase19b(x_map, y_map, u_off, gp, gp_map, a):
    """Four gloo ranks sharing the card at n=4096: the objectives at 19a's
    points, the predictor at phase 5's MAP."""
    from g3py_tpu_torch.parallel.launch import run_local

    xq = np.random.default_rng(192).standard_normal((256, x_map.shape[1])).astype(np.float32)
    payload = dict(x4=x_map, y4=y_map, u4={"gp": u_off, "tp": None}, block=P19_BLOCK,
                   max_iters=P19_MAP_ITERS, xq=xq,
                   u_pred=np.asarray(gp.active.dict_to_array(gp_map), np.float32))
    ranks = run_local(P19_RANKS, "g3py_tpu_torch.tools.dist_smoke:four_ranks", payload,
                      backend="gloo", device=CARD, timeout=600, collective_timeout=120)
    out = {"launches": [sum(r["launches"][i] for r in ranks) for i in (0, 1)]}
    nb = x_map.shape[0] // P19_BLOCK
    for r in ranks:
        require(r["eval_launches"] == (2, nb) or not CARD.startswith("cuda"),
                f"19b rank {r['rank']}: K1/K2 launches an evaluation {r['eval_launches']}, "
                f"predicted (2, {nb})")
        for kind in ("gp", "tp"):
            (v, g), (w, gw) = r[kind], a[kind + "4096"]["band"]
            (v64, g64) = a[kind + "4096"]["float64"]
            require(v == ranks[0][kind][0] and np.array_equal(g, ranks[0][kind][1]),
                    f"19b: the ranks' {kind} values differ")
            gap, gap1 = abs(v - v64) / abs(v64), abs(v - w) / abs(w)
            dgaps, _ = directional_gaps(g, g64, 193)
            require(gap <= 1e-3 and max(dgaps) <= 1e-2 and gap1 <= 1e-4,
                    f"19b {kind}: {v} vs float64 {v64} ({gap:.2e}) and the world of one {w} "
                    f"({gap1:.2e}); gradient gaps {dgaps}")
            out[kind] = dict(value_gap=gap, world_of_one_gap=gap1, dir_gaps=dgaps)
    lp_scipy = gp.logp(gp_map)
    lp_dist = gp.logp(ranks[0]["map_u"], array=True)  # the same model's registry order
    require(lp_dist >= lp_scipy - 2.0, f"19b: find_MAP(engine='distributed') logp {lp_dist} "
            f"vs the scipy optimum {lp_scipy}")
    # the band predictor against the single-device Predictor: at the
    # defaults within tutorial 11's 2e-3; at phase 5's MAP (cond(K) ~1e7 in
    # float32) both against the float64 Predictor, the band's gap within 4x
    # the single-device float32 Predictor's own (ROADMAP: f32 at an
    # ill-conditioned MAP)
    def gaps(got, want):
        return {k: float(np.max(np.abs(np.asarray(got[k], np.float64) - want[k]))
                         / (np.max(np.abs(want[k])) + 1e-9))
                for k in ("mean", "std", "quantile_up")}

    pred_gaps = gaps(ranks[0]["pred"]["default"], gp.predictor(gp.params_default)(
        xq, quantiles=True))
    require(max(pred_gaps.values()) < 2e-3, f"19b: predictor_distributed vs Predictor at the "
            f"defaults {pred_gaps}")
    g3t.set_floatx("float64")
    try:
        want64 = {k: np.asarray(v, np.float64) for k, v in gp.predictor(gp_map)(
            xq, quantiles=True).items()}
    finally:
        g3t.set_floatx("float32")
    map_gaps = gaps(ranks[0]["pred"]["map"], want64)
    witness = gaps(gp.predictor(gp_map)(xq, quantiles=True), want64)
    require(all(map_gaps[k] <= 4 * witness[k] + 1e-6 for k in map_gaps),
            f"19b: predictor_distributed at the MAP vs float64 {map_gaps}, the float32 "
            f"Predictor's {witness}")
    pred_gaps.update({f"map_{k}": v for k, v in map_gaps.items()})
    pred_gaps.update({f"map_witness_{k}": v for k, v in witness.items()})
    shares = [r["collective_share"] for r in ranks]
    out.update(eval_ms=[r["eval_ms"] for r in ranks], collective_share=shares,
               collectives=[r["collectives"] for r in ranks],
               map_s=ranks[0]["map_s"], map_logp=lp_dist, scipy_logp=lp_scipy,
               pred_gaps=pred_gaps, peak_gb=max(r["peak_gb"] or 0.0 for r in ranks))
    print(f"  19b {P19_RANKS} gloo ranks on one card, n={x_map.shape[0]}: an evaluation "
          f"{[round(t, 1) for t in out['eval_ms']]} ms (host-clock share in collectives "
          f"{[round(t, 3) for t in shares]}; rank 0's ops, calls and ms: "
          f"{ {k: (c, round(ms, 1)) for k, (c, ms) in ranks[0]['collectives'].items()} }); "
          f"GP {out['gp']}, TP {out['tp']}; find_MAP "
          f"{out['map_s']:.1f} s, logp {lp_dist:.3f} vs scipy's {lp_scipy:.3f}; the predictor "
          f"vs the Predictor {pred_gaps}; peak {out['peak_gb']:.2f} GB a rank", flush=True)
    return out


def phase19c(gp, gp_map, x_map):
    """The host-facing statistics on the card: a
    user's numpy on ``predict``, a statistic and a Predictor's batch."""
    xq = x_map[:64]
    pred = gp.predict(gp_map, space=xq, quantiles=True)
    stats = [pred[k] for k in pred] + [gp.mean(gp_map, space=xq),
                                       gp.predictor(gp_map)(xq)["std"]]
    require(all(isinstance(v, np.ndarray) and np.all(np.isfinite(v)) for v in stats),
            "19c: a statistic is not a finite host array")
    require(np.all(np.asarray(pred["quantile_up"]) >= pred["quantile_down"]), "19c: bands")
    print(f"  19c predict/mean/Predictor on the card give host arrays: "
          f"{sorted({type(v).__name__ for v in stats})}, mean of the mean "
          f"{float(np.mean(pred['mean'])):.4f}", flush=True)


def phase19(gp, gp_map, x_map, y_map, path):
    """Phase 19's runs; the ranks' main-path launches go to ``path``."""
    torch.cuda.empty_cache()  # the ranks' processes share the card with this one
    # the objectives off the MAP, where the gradient is not ~0 and a
    # directional gap is a gap of the gradient, not of its rounding
    u_off = np.asarray(gp.active.dict_to_array(
        {k: np.asarray(v) * 1.1 for k, v in gp_map.items()}), np.float32)
    print(f"phase 19a: a world of one over NCCL, GP n={P19_N}", flush=True)
    t0 = time.perf_counter()
    out = {}
    out["19a"], ranks_a = phase19a(x_map, y_map, u_off)
    out["19a"]["wall_s"] = time.perf_counter() - t0
    print(f"  phase 19a wall {out['19a']['wall_s']:.1f} s", flush=True)
    print(f"phase 19b: {P19_RANKS} gloo ranks sharing the card, n={len(x_map)}", flush=True)
    t0 = time.perf_counter()
    out["19b"] = phase19b(x_map, y_map, u_off, gp, gp_map, ranks_a)
    out["19b"]["wall_s"] = time.perf_counter() - t0
    print(f"  phase 19b wall {out['19b']['wall_s']:.1f} s", flush=True)
    for i in (0, 1):
        path[i] += out["19a"]["launches"][i] + out["19b"]["launches"][i]
    gen = torch.Generator(device=CARD).manual_seed(19)
    rate, var = torch.full((8,), 0.5, device=CARD), torch.tensor(1.1, device=CARD)
    x16 = torch.randn(P19_N, 8, generator=gen, device=CARD)
    out["k1_band"] = k1_record(x16[:1024], x16[:4096], rate, var, "K1 band (D=4)")
    out["k1_band_16384"] = k1_record(x16, x16, rate, var, "K1 band (D=1)")
    tile = se_gram_plus_noise(P19_BLOCK, torch.float32, 19).to(CARD)
    out["k2_tile"] = band_k2(tile)
    print("phase 19c: the host-facing statistics on the card (fault F3)", flush=True)
    phase19c(gp, gp_map, x_map)
    return out


def main():
    print("phase 0: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print("phase 1: build", flush=True)
    search_cpu = start_search_cpu()  # 18f(i)'s CPU witness, beside the whole run
    atexit.register(lambda: search_cpu.poll() is None and search_cpu.kill())
    t0 = time.perf_counter()
    recs = _build.build()
    print(f"  built {len(recs)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, rec in recs.items():
        print(f"  {name}: {rec.path} (cached={rec.cached})", flush=True)
        for ln in rec.log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                print("   ", ln.strip())

    print("phase 2: K1 vs plain form", flush=True)
    k1_worst, k1_timing = phase2()
    print("phase 2b: K2 vs plain form", flush=True)
    k2_worst, k2_timing = phase2b()

    g3t.settings.device = "cuda"
    g3t.settings.floatx = "float32"
    rng = np.random.default_rng(0)
    d = 8

    # ---- serving path
    stationary_gram.launches = 0
    panel_cholesky.launches = 0
    print("phase 3: GP serving n=16384 d=8", flush=True)
    n = 16384
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="SMOKE_GP16")
    gp.observed(x, y)
    serve(gp, rng, batches=8, m=256, d=d, label="GP n=16384")
    k1_gp, k2_gp = stationary_gram.launches, panel_cholesky.launches
    print(f"  launches in GP serving: K1 {k1_gp}, K2 {k2_gp}", flush=True)
    require(k1_gp >= 2 + 8, f"GP serving launched K1 {k1_gp} times, "
            "expected >= 1 (logp) + 1 (state) + 8 (batches)")
    require(k2_gp >= 2, f"GP serving launched K2 {k2_gp} times, expected >= 2 (logp, state)")

    print("phase 4: WGP serving n=4096 d=8", flush=True)
    n2 = 4096
    x2 = rng.standard_normal((n2, d)).astype(np.float32)
    y2 = (np.abs(np.sin(x2[:, 0])) + 0.5 + 0.1 * rng.standard_normal(n2)).astype(np.float32)
    wgp = g3t.WGP(space=x2[:4], location=g3t.Bias(), kernel=g3t.MAT52(x2),
                  mapping=g3t.BoxCoxLinear(y2), name="SMOKE_WGP")
    wgp.observed(x2, y2)
    serve(wgp, rng, batches=8, m=256, d=d, label="WGP n=4096")
    k1_serve, k2_serve = stationary_gram.launches, panel_cholesky.launches
    print(f"  launches in WGP serving: K1 {k1_serve - k1_gp}, K2 {k2_serve - k2_gp}", flush=True)
    require(k1_serve - k1_gp >= 2 + 8 and k2_serve - k2_gp >= 2,
            "WGP serving did not go through both kernels")
    host_check(rng)

    # ---- training path
    stationary_gram.launches = 0
    panel_cholesky.launches = 0
    train_ms, (tgp, tgp16, gp_map, x_map, y_map, map_s) = phase5(rng)
    k1_train, k2_train = stationary_gram.launches, panel_cholesky.launches
    print(f"  launches in training: K1 {k1_train}, K2 {k2_train}", flush=True)
    require(k1_train > 0 and k2_train > 0, "training did not go through both kernels")

    print("phase 5b: gradient vs host, K^-1 forms, where the time goes", flush=True)
    gradient_check(rng)
    kinv_forms(4096)
    kinv_forms(16384)
    where_time_goes(tgp, tgp16)

    print("phase 6a: batched K1 vs plain form", flush=True)
    k1b_worst, k1b_timing = phase6a()
    print("phase 6b: batched K2 vs plain form", flush=True)
    k2b_worst, k2b_timing = phase6b()

    # ---- Bayesian path: the counts are zeroed before, and read after, each
    # of its runs (two samplers at n=125, the sampler and the averaged
    # predictor at n=4096); the checks and profiles between them are not
    # counted
    print("phase 6c: ensemble sampler, WGP(Bias, SE, BoxCoxLinear) n=125 d=8", flush=True)
    bayes, path_c, trace_6c = phase6c()
    print("phase 6d: full width, GP(Bias, SE) n=4096: sampler and averaged predictor",
          flush=True)
    bayes_full, path_d, dt16 = phase6d(tgp, gp_map, x_map, y_map)
    k1_bayes, k2_bayes = path_c[0] + path_d[0], path_c[1] + path_d[1]
    print(f"  launches in the Bayesian path: K1 {k1_bayes}, K2 {k2_bayes}", flush=True)
    require(k1_bayes > 0 and k2_bayes > 0, "the Bayesian path did not go through both kernels")

    # ---- the parity gate and the model surface: the counts are zeroed
    # before, and read after, each float32 run of the main path (the oracle
    # scoring; the LOO calls, find_MAP, scores and predict at the MAP; the
    # WGP's logp/dlogp, Predictor set-up and batches); the pins, the float64
    # twins, the host witnesses and the profiles are not counted
    p7a, p7b, p7c = [0, 0], [0, 0], [0, 0]
    print("phase 7a: the sunsets oracle on the card (16 rows, float32) and the sunspots pins",
          flush=True)
    oracle = phase7a(p7a)
    print("phase 7b: full width, GP(Bias, SE) n=4096: LOO, find_MAP(objective='loo'), scores, "
          "covariance and samples", flush=True)
    surface = phase7b(tgp, gp_map, x_map, y_map, p7b)
    print("phase 7c: full width, WGP(Bias, SE, WarpingTanh n=3) n=4096: logp/dlogp and the "
          "Newton forward", flush=True)
    warped = phase7c(rng, p7c)
    k1_p7, k2_p7 = p7a[0] + p7b[0] + p7c[0], p7a[1] + p7b[1] + p7c[1]
    print(f"  launches in phase 7: K1 {k1_p7}, K2 {k2_p7} (7a {p7a}, 7b {p7b}, 7c {p7c})",
          flush=True)
    require(k1_p7 > 0 and k2_p7 > 0, "phase 7 did not go through both kernels")

    # ---- the other process families: the counts are zeroed before, and
    # read after, each float32 family run (logp/dlogp, find_MAP, Predictor,
    # predict, quantiles, the sampler and the averaged predictor); the host
    # checks, the float64 twins and the profiles are not counted
    p8, p8_batched = [0, 0], [0, 0]
    families = phase8(x_map, y_map, p8, p8_batched)
    print(f"  launches in phase 8: K1 {p8[0]}, K2 {p8[1]}; batched (8e) K1 {p8_batched[0]}, "
          f"K2 {p8_batched[1]}", flush=True)
    require(p8[0] > 0 and p8[1] > 0, "phase 8 did not go through both kernels")

    # ---- the rest of the hypers catalogue: the counts are zeroed before,
    # and read after, each float32 run (logp/dlogp, find_MAP, the
    # Predictor, each zoo logp, the sampler); the host checks and the
    # witnesses are not counted
    p9, p9_batched = [0, 0], [0, 0]
    catalogue = phase9(x_map, y_map, p9, p9_batched)
    print(f"  launches in phase 9: K1 {p9[0]}, K2 {p9[1]}; batched (9d) K1 {p9_batched[0]}, "
          f"K2 {p9_batched[1]}", flush=True)
    require(p9[0] > 0 and p9[1] > 0 and p9_batched[0] > 0 and p9_batched[1] > 0,
            "phase 9 did not go through both kernels")

    # ---- the rest of serving and the device half of the Bayesian toolbox:
    # the counts are zeroed before, and read after, each float32 run
    # (updated, pathwise, draws over rows, the fixed logps, find_MAP and
    # sampler, the non-centered sampler, the artifact's query batches); the
    # float64 twins, the host checks and the witnesses are not counted
    p10, p10_batched = [0, 0], [0, 0]
    toolbox = phase10(tgp, gp_map, x_map, y_map, dt16, p10, p10_batched)

    # ---- the gradient half of the Bayesian toolbox: the counts are zeroed
    # before, and read after, each float32 run (NUTS at n=125 and n=4096,
    # find_MAP(engine='jax') by logp and LOO, ADVI, NeuTra's ensemble warmup
    # and NUTS and its float32 replay, HMC, sample_hypers' methods), each
    # against its predicted evaluations; the float64 card runs of 11b and of
    # 11f's replay and 11c's float64 twin are checked but not counted
    p11_batched = [0, 0]
    try:
        gradient = phase11(tgp, gp_map, x_map, y_map, map_s, surface["fits"]["loo_fit"],
                           p11_batched)
    except BaseException:
        toolbox["10f"]["_pending"][0].kill()  # no process outlives a failed run
        raise
    print(f"  launches in phase 11: batched K1 {p11_batched[0]}, K2 {p11_batched[1]}",
          flush=True)
    require(p11_batched[0] > 0 and p11_batched[1] > 0,
            "phase 11 did not go through both batched kernels")

    # 10f's loader process ran beside phase 11: its checks and the
    # artifact's K1 launches now
    finish_phase10f(toolbox["10f"], p10)
    print(f"  launches in phase 10: K1 {p10[0]}, K2 {p10[1]}; batched K1 {p10_batched[0]}, "
          f"K2 {p10_batched[1]}", flush=True)
    require(p10[0] > 0 and p10[1] > 0 and p10_batched[0] > 0 and p10_batched[1] > 0,
            "phase 10 did not go through both kernels")

    # ---- the matrix-free path: the counts are zeroed before, and read
    # after, 12b's timed evaluations, 12d's fits and 12e's float32
    # predictors (12a's float64 card-vs-CPU suite, the slab timing and 12c's
    # float64 checks are not counted); each of 12b's evaluations and 12d's
    # fits is held to the launches its slab passes predict
    p12 = [0, 0]
    t12 = time.perf_counter()
    matrix_free = phase12(tgp, gp_map, x_map, y_map, map_s, x, y, p12)
    t12 = time.perf_counter() - t12
    print(f"  launches in phase 12: K1 {p12[0]}, K2 {p12[1]}; phase 12 {t12:.1f} s", flush=True)
    require(p12[0] > 0, "phase 12 did not go through K1")

    # ---- the sparse families: the counts are zeroed before, and read after,
    # 13a's timed evaluations, 13b's predictor set-up, batches, update and
    # paths, 13c's fits, 13d's timed evaluations and 13e's sampler (to the
    # batched records); the warm-ups, the float64 host checks and the
    # kernel timings are not counted
    p13, p13_batched = [0, 0], [0, 0]
    t13 = time.perf_counter()
    sparse = phase13(x_map, y_map, p13, p13_batched)
    t13 = time.perf_counter() - t13
    print(f"  launches in phase 13: K1 {p13[0]}, K2 {p13[1]}; batched (13e) K1 "
          f"{p13_batched[0]}, K2 {p13_batched[1]}; phase 13 {t13:.1f} s", flush=True)
    require(p13[0] > 0 and p13[1] > 0 and p13_batched[0] > 0 and p13_batched[1] > 0,
            "phase 13 did not go through both kernels")

    # ---- items 8 and 12: the counts are zeroed before, and read after,
    # 14a's evaluations, Predictor and paths, 14b's shared-kernel runs and
    # 14e's scipy experiments (to the single records), 14a's
    # find_MAP(engine='jax'), 14b's per-latent runs, 14c's sampler and rows,
    # 14d's KDE refills and errors and 14e's jax-engine experiments (to the
    # batched records); the warm-ups, the float64 host checks, K1's
    # both-input check and the latents' plain-form checks are not counted
    p14, p14_batched = [0, 0], [0, 0]
    t14 = time.perf_counter()
    items = phase14(trace_6c, tgp, dt16, x_map, y_map, p14, p14_batched)
    t14 = time.perf_counter() - t14
    print(f"  launches in phase 14: K1 {p14[0]}, K2 {p14[1]}; batched K1 {p14_batched[0]}, "
          f"K2 {p14_batched[1]}; phase 14 {t14:.1f} s", flush=True)
    require(p14[0] > 0 and p14[1] > 0 and p14_batched[0] > 0 and p14_batched[1] > 0,
            "phase 14 did not go through both kernels")

    # ---- the state-space families (item 13's gaussian half): the counts
    # are zeroed before, and read after, 15d's float32 evaluations, field and
    # sparse evaluation (15a-c, 15e and 15f are held to no launch); the
    # warm-ups, the float64 witnesses and the kernel records are not counted
    p15 = [0, 0]
    t15 = time.perf_counter()
    state_space = phase15(p15)
    t15 = time.perf_counter() - t15
    print(f"  launches in phase 15: K1 {p15[0]}, K2 {p15[1]}; phase 15 {t15:.1f} s", flush=True)
    require(p15[0] > 0 and p15[1] > 0, "phase 15 did not go through both kernels")

    # ---- the Laplace state-space family (item 13b): the counts are zeroed
    # before, and read after, 16d's float32 evaluation and field_rate (16a-c,
    # 16e and 16f are held to no launch); the float64 witnesses and the
    # kernel records are not counted
    p16 = [0, 0]
    PATH_K1.clear()
    t16 = time.perf_counter()
    laplace = phase16(p16)
    t16 = time.perf_counter() - t16
    p16_k1 = dict(PATH_K1)
    print(f"  launches in phase 16: K1 {p16[0]}, K2 {p16[1]}; phase 16 {t16:.1f} s", flush=True)
    require(p16[0] > 0 and p16[1] > 0, "phase 16 did not go through both kernels")

    # ---- the Kronecker grid and SKI families (item 14): the counts are
    # zeroed before, and read after, 17a-c's float32 evaluations and 17d's
    # serving; the warm-ups, the float64 witnesses, the estimator diagnostics
    # and the kernel records are not counted
    p17 = [0, 0]
    PATH_K1.clear()
    t17 = time.perf_counter()
    grids = phase17(p17)
    t17 = time.perf_counter() - t17
    p17_k1 = dict(PATH_K1)
    print(f"  launches in phase 17: K1 {p17[0]}, K2 {p17[1]}; phase 17 {t17:.1f} s", flush=True)
    require(p17[0] > 0, "phase 17 did not go through K1")

    # ---- item 15 (BO, the fan-out, the structure search, the utils): the
    # counts are zeroed before, and read after, 18a's suggest calls and 18f's
    # searches (single) and 18d's and 18e's fan-outs (batched); the float64
    # witnesses, the CPU search, 18b's redraw and the kernel records are not
    # counted
    p18, p18_batched = [0, 0], [0, 0]
    PATH_K1.clear()
    t18 = time.perf_counter()
    bayes_opt = phase18(tgp, gp_map, x_map, y_map, dt16, items["14e"]["scipy"]["test_l2"], p18,
                        p18_batched, search_cpu)
    t18 = time.perf_counter() - t18
    p18_k1 = dict(PATH_K1)
    print(f"  launches in phase 18: K1 {p18[0]}, K2 {p18[1]}; batched K1 {p18_batched[0]}, K2 "
          f"{p18_batched[1]}; phase 18 {t18:.1f} s", flush=True)
    require(min(p18 + p18_batched) > 0, "phase 18 did not go through both kernels")

    # ---- item 16a (the band-sharded objective over torch.distributed): the
    # counts are zeroed before, and read after, the main path in each rank
    # (19a's timed evaluation; 19b's evaluations, MAP search and predictor)
    p19 = [0, 0]
    t19 = time.perf_counter()
    band = phase19(tgp, gp_map, x_map, y_map, p19)
    t19 = time.perf_counter() - t19
    print(f"  launches in phase 19 (every rank): K1 {p19[0]}, K2 {p19[1]}; phase 19 "
          f"{t19:.1f} s", flush=True)
    require(p19[0] > 0 and p19[1] > 0, "phase 19 did not go through both kernels")

    shape = (4096, 4096, 8)
    k1t = dict(k1_timing[("se", shape)], bound_ms=k1_bound_ms(*shape), bound_by="bytes")
    k1b = dict(k1b_timing[(16, 4096, 4096, 8)], bound_by="bytes")
    slab = dict(matrix_free["12k"], bound_by="bytes")
    cross = dict(sparse["13a"]["k1"], bound_by="bytes")
    features = dict(items["14a"]["k1"], bound_by="bytes")
    latent = items["14b"]["per_latent"]
    k1q, k2q = latent["k1_latents"], latent["k2_latents"]
    k2t, k2b, k2m = k2_timing[4096], k2b_timing[("float32", 11, 4096)], sparse["13a"]["k2"]
    st = state_space["15d"]
    sites, sites_cross = dict(st["k1_sites"], bound_by="bytes"), dict(st["k1_cross"],
                                                                     bound_by="bytes")
    k2s = st["k2_sites"]
    ng = laplace["16d"]
    ng_sites, ng_k2 = dict(ng["k1_sites"], bound_by="bytes"), ng["k2_sites"]
    g_mat52 = dict(grids["17a"]["k1_mat52"], bound_by="bytes")
    g_se = dict(grids["17a"]["k1_se"], bound_by="bytes")
    s_mat52 = dict(grids["17c"]["k1_mat52"], bound_by="bytes")
    s_se = dict(grids["17c"]["k1_se"], bound_by="bytes")
    # the new uses' launches, counted by the wrapper by kind and shape on
    # phases 16 and 17's main paths
    sites_key = f"se (1, {ST_SITES}, {ST_SITES}, 2)"
    new_uses = {"laplace_sites": p16_k1.get(sites_key, 0),
                "grid_mat52": p17_k1.get(f"mat52 (1, {GRID_AXIS}, {GRID_AXIS}, 1)", 0),
                "grid_se": p17_k1.get(f"se (1, {GRID_AXIS}, {GRID_AXIS}, 1)", 0),
                "ski_mat52": p17_k1.get(f"mat52 (1, {SKI_GRID}, {SKI_GRID}, 1)", 0),
                "ski_se": p17_k1.get(f"se (1, {SKI_GRID}, {SKI_GRID}, 1)", 0)}
    print(f"  K1 launches by kind and shape: phase 16 {p16_k1}; phase 17 {p17_k1}", flush=True)
    def uses(test):
        return sum(v for k, v in p18_k1.items()
                   if test(tuple(int(t) for t in k.split(" ", 1)[1].strip("()").split(","))))

    n_map = len(x_map)
    new_uses.update(
        bo_screen=uses(lambda s: s[:2] == (1, 2048) and s[2] >= n_map),
        bo_ascent=uses(lambda s: s[:2] == (1, 16) and s[2] >= n_map),
        fanout_512=uses(lambda s: s[0] > 1 and s[1:3] == (512, 512)),
        fanout_4096=uses(lambda s: s[0] > 1 and s[1:3] == (n_map, n_map)))
    print(f"  K1 launches by kind and shape: phase 18 {p18_k1}", flush=True)
    require(all(v > 0 for v in new_uses.values()), f"a new K1 use was not launched: {new_uses}")
    bo = bayes_opt["18a"]
    bo_screen = dict(bo["k1_screen"], bound_by="bytes")
    bo_ascent = dict(bo["k1_ascent"], bound_by="bytes")
    bo_k2, fan_d, fan_e = bo["k2_ragged"], bayes_opt["18d"], bayes_opt["18e"]
    band_k1 = dict(band["k1_band"], bound_by="bytes")
    band_k1_16384, band_k2_rec = band["k1_band_16384"], band["k2_tile"]
    k1_src = dict(route="cuda", source="g3py_tpu_torch/csrc/stationary_gram.cu",
                  replaces="g3py_tpu/ops/pallas_gram.py:81")
    k2_src = dict(route="cuda", source="g3py_tpu_torch/csrc/panel_cholesky.cu",
                  replaces="g3py_tpu/ops/pallas_cholesky.py:165")

    def timed(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    record = {"kernels": [
        {"name": "stationary_gram", **k1_src,
         "launches": (k1_serve + k1_train + k1_p7 + p8[0] + p9[0] + p10[0] + p12[0]
                      + p13[0] + p14[0] + p15[0] + p16[0] + p17[0] + p18[0] + p19[0]),
         "max_abs_err": max(k1_worst, catalogue["k1_algebra_err"]["single"],
                            slab["max_abs_err"], cross["max_abs_err"],
                            features["max_abs_err"], sites["max_abs_err"],
                            sites_cross["max_abs_err"], ng_sites["max_abs_err"],
                            g_mat52["max_abs_err"], g_se["max_abs_err"],
                            s_mat52["max_abs_err"], s_se["max_abs_err"],
                            bo_screen["max_abs_err"], bo_ascent["max_abs_err"],
                            band_k1["max_abs_err"], band_k1_16384["max_abs_err"]),
         **timed(k1t)},
        {"name": "panel_cholesky", **k2_src,
         "launches": (k2_serve + k2_train + k2_p7 + p8[1] + p9[1] + p10[1] + p12[1]
                      + p13[1] + p14[1] + p15[1] + p16[1] + p17[1] + p18[1] + p19[1]),
         "max_abs_err": max(k2_worst, k2s["max_abs_err"], ng_k2["max_abs_err"],
                            bo_k2["max_abs_err"], band_k2_rec["max_abs_err"]), **timed(k2t)},
        {"name": "stationary_gram_batched", **k1_src,
         "launches": (k1_bayes + p8_batched[0] + p9_batched[0] + p10_batched[0]
                      + p11_batched[0] + p13_batched[0] + p14_batched[0] + p18_batched[0]),
         "max_abs_err": max(k1b_worst, catalogue["k1_algebra_err"]["batched"],
                            k1q["max_abs_err"], fan_d["k1"]["max_abs_err"],
                            fan_e["k1"]["max_abs_err"]), **timed(k1b)},
        {"name": "panel_cholesky_batched", **k2_src,
         "launches": (k2_bayes + p8_batched[1] + p9_batched[1] + p10_batched[1]
                      + p11_batched[1] + p13_batched[1] + p14_batched[1] + p18_batched[1]),
         "max_abs_err": max(k2b_worst, k2q["max_abs_err"], fan_d["k2"]["max_abs_err"],
                            fan_e["k2"]["max_abs_err"]), **timed(k2b)},
        {"name": "stationary_gram_slab", **k1_src, "launches": p12[0],
         "max_abs_err": slab["max_abs_err"], **timed(slab)},
        {"name": "stationary_gram_cross", **k1_src, "launches": p13[0],
         "max_abs_err": cross["max_abs_err"], **timed(cross)},
        {"name": "panel_cholesky_m512", **k2_src, "launches": p13[1],
         "max_abs_err": k2m["max_abs_err"], **timed(k2m)},
        {"name": "stationary_gram_features", **k1_src,
         "launches": items["14a"]["features_launches"],
         "max_abs_err": features["max_abs_err"], **timed(features)},
        {"name": "stationary_gram_latents", **k1_src,
         "launches": latent["latent_launches"][0],
         "max_abs_err": k1q["max_abs_err"], **timed(k1q)},
        {"name": "panel_cholesky_latents", **k2_src,
         "launches": latent["latent_launches"][1],
         "max_abs_err": k2q["max_abs_err"], **timed(k2q)},
        {"name": "stationary_gram_sites", **k1_src, "launches": st["sites_launches"],
         "max_abs_err": sites["max_abs_err"], **timed(sites)},
        {"name": "stationary_gram_sites_cross", **k1_src, "launches": st["cross_launches"],
         "max_abs_err": sites_cross["max_abs_err"], **timed(sites_cross)},
        {"name": "panel_cholesky_m32", **k2_src, "launches": st["k2_launches"],
         "max_abs_err": k2s["max_abs_err"], **timed(k2s)},
        {"name": "stationary_gram_laplace_sites", **k1_src, "launches": new_uses["laplace_sites"],
         "max_abs_err": ng_sites["max_abs_err"], **timed(ng_sites)},
        {"name": "panel_cholesky_laplace_m32", **k2_src, "launches": ng["k2_launches"],
         "max_abs_err": ng_k2["max_abs_err"], **timed(ng_k2)},
        {"name": "stationary_gram_grid_mat52", **k1_src, "launches": new_uses["grid_mat52"],
         "max_abs_err": g_mat52["max_abs_err"], **timed(g_mat52)},
        {"name": "stationary_gram_grid_se", **k1_src, "launches": new_uses["grid_se"],
         "max_abs_err": g_se["max_abs_err"], **timed(g_se)},
        {"name": "stationary_gram_ski_grid_mat52", **k1_src, "launches": new_uses["ski_mat52"],
         "max_abs_err": s_mat52["max_abs_err"], **timed(s_mat52)},
        {"name": "stationary_gram_ski_grid_se", **k1_src, "launches": new_uses["ski_se"],
         "max_abs_err": s_se["max_abs_err"], **timed(s_se)},
        {"name": "stationary_gram_bo_screen", **k1_src, "launches": new_uses["bo_screen"],
         "max_abs_err": bo_screen["max_abs_err"], **timed(bo_screen)},
        {"name": "stationary_gram_bo_ascent", **k1_src, "launches": new_uses["bo_ascent"],
         "max_abs_err": bo_ascent["max_abs_err"], **timed(bo_ascent)},
        {"name": "panel_cholesky_bo_ragged", **k2_src, "launches": bo["logEI"]["k2"] - 1,
         "max_abs_err": bo_k2["max_abs_err"], **timed(bo_k2)},
        {"name": "stationary_gram_fanout_r32_n512", **k1_src, "launches": new_uses["fanout_512"],
         "max_abs_err": fan_d["k1"]["max_abs_err"], **timed(fan_d["k1"])},
        {"name": "panel_cholesky_fanout_r32_n512", **k2_src, "launches": fan_d["launches"][1],
         "max_abs_err": fan_d["k2"]["max_abs_err"], **timed(fan_d["k2"])},
        {"name": "stationary_gram_fanout_n4096", **k1_src, "launches": new_uses["fanout_4096"],
         "max_abs_err": fan_e["k1"]["max_abs_err"], **timed(fan_e["k1"])},
        {"name": "panel_cholesky_fanout_n4096", **k2_src, "launches": fan_e["launches"][1],
         "max_abs_err": fan_e["k2"]["max_abs_err"], **timed(fan_e["k2"])},
        {"name": "stationary_gram_band", **k1_src, "launches": p19[0],
         "max_abs_err": max(band_k1["max_abs_err"], band_k1_16384["max_abs_err"]),
         **timed(band_k1)},
        {"name": "panel_cholesky_band_diag", **k2_src, "launches": p19[1],
         "max_abs_err": band_k2_rec["max_abs_err"], **timed(band_k2_rec)}]}
    print(f"  K1 at {shape} SE f32: kernel {k1t['ms']:.4f} ms (events, back to back), device "
          f"{fmt_ms(k1t['device_ms'])} (profiler, a launch), wrapper {k1t['wrapper_ms']:.4f} "
          f"ms, plain {k1t['plain_ms']:.4f} ms, bound {k1t['bound_ms']:.4f} ms", flush=True)
    print(f"  training logp+dlogp medians (ms): {train_ms}", flush=True)
    print(f"  Bayesian path: {json.dumps(bayes)}; full width {json.dumps(bayes_full)}",
          flush=True)
    print(f"  phase 7: oracle {json.dumps(oracle)}; GP surface {json.dumps(surface)}; WGP "
          f"{json.dumps(warped)}", flush=True)
    print(f"  phase 8: {json.dumps(families, default=float)}", flush=True)
    print(f"  phase 9: {json.dumps(catalogue, default=float)}", flush=True)
    print(f"  phase 10: {json.dumps(toolbox, default=float)}", flush=True)
    print(f"  phase 11: {json.dumps(gradient, default=float)}", flush=True)
    print(f"  phase 12: {json.dumps(matrix_free, default=float)}", flush=True)
    print(f"  phase 13: {json.dumps(sparse, default=float)}", flush=True)
    print(f"  phase 14: {json.dumps(items, default=float)}", flush=True)
    print(f"  phase 15: {json.dumps(state_space, default=float)}", flush=True)
    print(f"  phase 16: {json.dumps(laplace, default=float)}", flush=True)
    print(f"  phase 17: {json.dumps(grids, default=float)}", flush=True)
    print(f"  phase 18: {json.dumps(bayes_opt, default=float)}", flush=True)
    print(f"  phase 19: {json.dumps(band, default=float)}", flush=True)
    print(f"  command time {time.perf_counter() - T_START:.1f} s (phase 12 {t12:.1f} s, "
          f"phase 13 {t13:.1f} s, phase 14 {t14:.1f} s, phase 15 {t15:.1f} s, phase 16 "
          f"{t16:.1f} s, phase 17 {t17:.1f} s, phase 18 {t18:.1f} s, phase 19 {t19:.1f} s)",
          flush=True)
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
