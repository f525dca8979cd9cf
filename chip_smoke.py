#!/usr/bin/env python3
"""Smoke run of the PyTorch port's GMM-HMM, duration-model, streaming,
neural-HMM, general-K, long-sequence, CTC, DTW and large-state scoring
paths on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (any
sm_90a card), PyTorch built for CUDA and the CUDA toolkit. It builds the
port's CUDA kernels from ``pytorch_hmm_tpu_torch/csrc`` (one nvcc per
source, all at once), checks each kernel against its plain PyTorch
version on the card (row 2, ``smallk_viterbi``, whose chain runs
bounded, also against the plain trellis in float64, with a long-T case
at GMM scale: ``trellis_vs_f64``; row 1's mixture mode, the GMM
decode's emission with the logsumexp over components in its output
stage, against row 1 plus the plain epilogue and float64 at the
``gmm.decode.b4096`` shape and three others, and timed there against
both), then drives
``MixtureGaussianHMMLayer`` at the width of the repo's GMM-HMM
configuration (B=32, T=1000, S=12, C=4, D=80, diag covariance; random
weights from a seed):

* decode: serves a few requests and checks them against the same layer
  on the CPU in float64;
* training: gradients of ``compute_loss`` (unragged and ragged) against
  the same layer on the CPU in float64, five Adam steps with the loss
  falling, five ``em_step``s with the log-likelihood non-decreasing and
  the first step's parameters against the CPU's;

then the duration models (random weights from a seed, observations drawn
from the model's own means):

* decode: ``HSMMLayer`` (B=32, T=1000, S=10, D=20, F=80, the JAX
  bench's duration-model row) through ``forward``, unragged and ragged,
  and ``SemiMarkovHMM`` (B=24, T=800) through ``viterbi_decode``, each
  against the same model on the CPU;
* posteriors and training: ``HSMMLayer.posteriors``, ``compute_loss``
  gradients (unragged and ragged) and one ``em_step`` against the same
  layer on the CPU in float64, five ``em_step``s (fixed durations) with
  the log-likelihood non-decreasing;
* ``hsmm_smallk_fb`` (row 7) timed by phase in a probe build of its
  source (``HSMM_SMALLK_PROBE``) at S=10 D=20, D=128 and S=32, each
  chain apart: the chain's join, predecessor lse and barrier wait, the
  helpers' terms, reduction and wait;
* the training backward's cotangents (``csrc/hsmm_grads.cu``, row 24)
  against their plain version ``core.hsmm_grads_from_tables`` and
  against float64 on the card, run twice and equal bit for bit: at the
  training cell's shape (B=1024, T=1000, S=10, D=20, lengths 250-1000),
  at B=32 and at the envelope's edges (S=1, S=32, D=1, D=256, T<D,
  unragged, ragged with a length-1 row, ``g`` of mixed signs); timed
  beside the plain version and the bound at the first two;

then streaming decode at the width of the repo's streaming configuration
(``StreamingHMMProcessor(12, 80, chunk_size=160)``: beam width 8,
lookahead 5, a path history of 165 frames; random weights from a seed):

* the two chunk kernels against their plain versions on the card, bit
  for bit (headline S=12, T=160 at N=1, 8 and 16 streams; mixed path
  lengths, a short chunk, forced ties, S=128, T=1024 > H; greedy with
  and without a previous state);
* serving: twenty 160-frame chunks of one stream through
  ``process_chunk`` and ``flush_buffer``, beam and greedy, against the
  same processor on the CPU;
* fleets: ``MultiStreamDecoder.step`` at N=8 and N=16, each stream
  against the single-stream processor on the card; the fleet and
  single-stream raw-PCM steps against the CPU;

then the neural HMMs at the width of the JAX bench's NeuralHMM row
(``NeuralHMM(12, 80, hidden_dim=256)``, B=16, T=1000, static
transitions) and its contextual twin (``ContextualNeuralHMM(12, 80,
phoneme_vocab_size=64)``, time-varying (16, 1000, 12, 12) transitions;
random weights from a seed, eval mode):

* the neural emission kernel against its plain version on the card
  (headline, ragged row tiles, odd D and H, S=1, S=128, H at the top of
  its envelope) and its autograd Function's gradients; the time-varying
  modes of the trellis and fused forward-backward kernels against their
  plain versions (headline, K=32, ragged with a length-1 row, ties, -inf
  entries);
* ``__call__``, ``viterbi_decode`` and ``compute_likelihood`` of both
  models against the same models on the CPU, ``compute_loss`` gradients
  against the CPU in float64, five Adam steps in training mode with the
  loss falling; ``transformer`` and ``rnn`` transition models at T=64
  and a neural-emission ``SemiMarkovHMM`` decode against the CPU;
* ``ContextualNeuralHMM(transition_type="transformer")`` training steps
  at ``ctxtfm.train.b512``'s widths on ragged rows: the attention's
  memory-efficient launches of one step and its counters, and the
  largest B (of 512 down to 64, T=1000) at which the old unmasked
  einsums fit, with one step of each path at that B;

then the general-K path (more than 32 states) at the width of the JAX
bench's K>32 row, ``GaussianHMMLayer(64, 80)``, diag, at B=32, T=1000
(random weights from a seed, features from left-to-right walks over its
means):

* the forward, backward and Viterbi kernels of ``csrc/scan_bigk.cu``
  against their plain versions (headline K=64, K=33, 128, 256, 1024 at
  B=4 T=256, ragged with a length-1 row, T=1, all ties, a left-to-right
  ``safe_log`` matrix; Viterbi paths and scores identical) and the
  fused GMM decode of ``csrc/fused_gmm.cu`` against its plain version
  (S=64 C=2 D=80, S=128 C=1, S=40 C=2 D=13, ragged), then timed by phase
  in a probe build of that source (``FUSED_GMM_PROBE``) at the first
  three: the chain's slot and delta waits, max and argmax, the
  producers' waits, transposes, products and scores, the store warp, the
  backtrace;
* ``GaussianHMMLayer``: training-mode posteriors, ``compute_loss``
  gradients against its CPU twin in float64, five Adam steps with the
  loss falling, eval decode against the CPU; ``HMMLayer(64)`` and
  ``HMM`` at K=64 the same way; ``MixtureGaussianHMMLayer(64, 80)`` at
  C=2 (the fused decode) and C=4: decode, a ``compute_loss`` step and an
  ``em_step`` against the CPU;

then the long-sequence slice: the JAX bench's long-context rows (B=32,
T=131072, K=64) and full covariance at the width of two of its rows:

* the prob-space chains of ``csrc/scan_prob.cu`` (rows 10-12) against
  their plain versions (headline B=32 T=4096 K=64, K=33, 128, 12, T not
  a multiple of the rescale interval, K=33 at T=1001 off 16-byte
  alignment, T=1, rs=4, a finite left-to-right
  ``safe_log`` matrix, whose posteriors are also held to float64), then
  timed by phase in a probe build of that source (``SCAN_PROB_PROBE``)
  at B=32, T=4096 and K=12, 64, 128;
* ``ops.auto_forward``, ``ops.auto_log_likelihood`` and its gradient at
  B=32, T=131072, K=64, each launching its prob-space kernel once and
  the log-space chains never; two rows against float64; a ``-inf``
  transition and T=1023 running rows 8 and 9 instead (the gate);
* ``GaussianHMMLayer(64, 80, "full")`` at B=32, T=2048 and
  ``MixtureGaussianHMMLayer(12, 80, C=4, "full")`` at B=32, T=1000
  against their CPU twins (posteriors, decode, the prepared decoder,
  ``compute_loss`` gradients in float64, Adam, ``em_step``);

then CTC at the widths of the JAX bench's forced-alignment rows
(``CTCAligner(40)`` at B=16, T=500, C=40, U=50; align also at B=4,
T=2048, C=100, U=1000, the S=2001 lattice):

* the lattice chains of ``csrc/ctc_lattice.cu`` (rows 20-23) against
  their plain versions (both shapes, S=2047, ragged with a length-1 row,
  empty targets and an infeasible row, repeated labels; Viterbi through
  both rows where row 22's table fits, positions identical);
* the loss and its gradient (rows 20 and 21 once each) against the CPU
  twin in float64 and ``F.ctc_loss`` on the card, five Adam steps on the
  logits, ``align`` (row 22 at S=101, row 23 at S=2001) identical to the
  CPU, ``ctc_alignment_path`` against float64, greedy and beam decode
  identical to the CPU;

then DTW at the width of the JAX bench's DTW row (two standard normal
(500, 80) feature sequences, euclidean distances) and large-state scoring
at its K=512 row (B=48, T=2048) and at K=1024 (B=16):

* the wavefront-and-backtrace kernel of ``csrc/dtw.cu`` (row 19) against
  its plain version, bit for bit (500x500 in the three patterns, a
  Sakoe-Chiba band, 1x1, 1x300, 300x1, 37x23, 130x40, forced ties, and
  2000x1800 with the choices in device memory);
* ``DTWAligner`` on one pair and a batch of 4, ``ConstrainedDTWAligner``,
  ``dtw_distance`` and ``phoneme_audio_alignment`` (row 19 once a pair,
  the plain wavefront never), each identical to the CPU's plain path on
  the card's distances; ``soft_dtw_alignment`` at 64x64 against the CPU;
* the bf16 tensor-core chain of ``csrc/bigk_scoring.cu`` (row 15, one
  thread-block cluster of CS CTAs per 16 rows) against its plain
  version (both shapes, B and K off its tiles, K=12, K=1000 off the
  cluster's column split, K=768 on a cluster of 12, B=320 at K=1024 in
  waves of clusters, wide batches on slices of 128, 192 and 256 columns,
  log-obs in a view off 16-byte alignment) and three
  shapes against float64; ``ops.bigk_log_likelihood`` launching row 15
  once a call, and ``pallas_forward`` instead at T=2000;

and times the kernels, a decode, a ``compute_loss`` step and an
``em_step`` of each path, a duration-model ``posteriors`` call, a
streaming chunk, a fleet step, a PCM step, a NeuralHMM forward, decode
and ``compute_loss`` step (static and contextual), the general-K and
long-sequence entry points with CUDA events (rows 8-12 at T=4096 and
131072, row 12 against ``fbsum_smallk`` at K=12; row 14 against the
same decode unfused through rows 1 and 13; rows 20-23 against
``F.ctc_loss``; rows 19 and 15 and the DTW entry points; row 1, its plain
version and ``torch.addmm`` also as device time, replaying CUDA graphs,
at N=48, 64 and 256; row 15's cluster plans and a cluster-barrier probe), counts the launches of
one call of each, profiles ten beam chunks, ten NeuralHMM forwards, ten
calls each of a ``GaussianHMMLayer`` decode and ``compute_loss`` step
and a fused ``MixtureGaussianHMMLayer`` decode, one long-context
gradient call, three full-covariance calls and three CTC loss steps, and
times the prob gate's host read.

Phases, one line each: card, build, each kernel vs plain (with the
bf16 scorers on the card against the CPU after row 1), decode,
training, the segment-DP kernels and row 7's probe (a line per case and
chain), duration-model decode, duration-model training, stream
kernels, streaming serve, fleets, neural kernels, neural models,
general-K kernels and row 14's probe (a line per case), general-K
slice, prob-space kernels, the prob-space probe (a line per row and K),
long context,
full covariance, CTC kernels, CTC slice, DTW kernel, DTW slice, scoring
kernel, scoring, timing.
Any failure exits non-zero
before the last line. On success the last two lines are a JSON object
describing each kernel (with its bound from this run's inputs) and
``{"ok": true, "device": {...}}``. There is no CPU path: without a CUDA
device the script fails. It imports no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
# The GMM-HMM configuration's width: batch, frames, states, components,
# feature dim.
B, T, S, C, D = 32, 1000, 12, 4, 80
TIMED_RUNS = 20
PLAIN_SUM_RUNS = 5      # the plain sum recursions are Python loops of T steps
# Tolerance of the JAX kernel's own test (tests/test_ops_emit.py).
DQ_ATOL, DQ_RTOL = 2e-4, 1e-5
# compute_dtype=bfloat16 scores on the card against the same call on the
# CPU: the same bf16-rounded operands, float32 products and sums in
# another order.
BF16_CARD_ATOL, BF16_CARD_RTOL = 1e-3, 1e-5
# Row 1 at the other widths the main path gives it: N=256 (the S=64, C=4
# GMM decode), N=64 (GaussianHMMLayer(64, 80)) and N=10 (HSMMLayer's S=10).
DQ_WIDE = ((B, T, D, 256), (B, T, D, 64), (B, T, D, 10))
# Row 1's device time: CUDA-graph replays of this many launches, at N=48
# and at these other widths.
DQ_GRAPH_LAUNCHES = 50
DQ_DEVICE_N = (64, 256)
# Row 2 (smallk_viterbi) against the plain trellis in float64 on the same
# inputs. A score may sit half an ulp of its float32 output off (2^-24
# relative: the kernel adds what it took out of its bounded chain, in
# double, to the chain's best and rounds once), plus its bounded chain's
# rounding: values of O(1e2), a half ulp of ~4e-6 on each of two adds a
# frame, ~4e-4 nats at T=1000 as a random walk; 2e-6 a frame leaves ~5x.
# The plain float32 chain on raw scores drifts past this at GMM scale
# (~9 nats at T=4096, |log_obs| ~ 125 a frame). A path may leave the
# plain float32 path only where both score within VIT_PATH_GAP nats of
# the float64 best: a tie within the plain chain's own rounding.
VIT_F64_RTOL = 2.0 ** -24
VIT_F64_ATOL_FRAME = 2e-6
VIT_PATH_GAP = 0.01
# The long-T, GMM-scale case of row 2 (the card test's too): B, T, K, and
# the features' width behind its diagonal-Gaussian scores.
VIT_LONG = (8, 4096, 12, 80)
# Row 1's mixture mode (the GMM decode's emission with the logsumexp over
# components in its output stage) against row 1 plus the plain epilogue it
# replaces: the same row-1 sums and component scores rounded alike, so only
# the logsumexp's sum order, exp and log differ, well under an ulp of
# |score| (~7.6e-6 at 125); MIX_ATOL at |score| <= MIX_SCALE and in
# proportion above. The cases: the
# gmm.decode.b4096 cell's shape (B, T, S, C, D), ragged; two and five
# column tiles (N > 64, D % 4 != 0); one tile with padded columns.
MIX_ATOL, MIX_SCALE = 2e-5, 125.0
MIX_CASES = {"cell": (4096, 1000, 12, 4, 80), "N=80": (32, 1000, 40, 2, 80),
             "N=264 D=39": (32, 300, 33, 8, 39), "N=15 D=13": (8, 300, 5, 3, 13)}
# Sum recursions vs their plain versions: the JAX kernel tests' atol
# 2e-4 (tests/test_ops_fbsum.py), plus rtol 1e-6 (8 f32 ulps) of the
# running magnitude, which reaches ~2.5e3 at T=1000 on these inputs.
SUM_ATOL, SUM_RTOL = 2e-4, 1e-6
ADAM_STEPS = EM_STEPS = 5
# The duration models' width: the JAX bench's HSMMLayer row (B, T,
# states, max duration, feature dim) and its SemiMarkovHMM row.
HB, HT, HS, HD, HF = 32, 1000, 10, 20, 80
SEMI_B, SEMI_T = 24, 800
# Segment-DP sum tables vs their plain versions: atol 5e-4, the JAX
# kernel tests' own (tests/test_ops_hsmm.py), plus rtol 1e-6 (8 f32 ulps)
# of the running magnitude (~2.5e3 at T=1000 on these inputs). The
# kernels form segment emissions with window rings, the plain versions
# as differences of running sums: they round differently.
HSMM_SUM_ATOL, HSMM_SUM_RTOL = 5e-4, 1e-6
# Duration models on the card vs the CPU in float64. The card's f32
# posteriors, from shifted window-ring chains, sat 9.0e-4 off float64 at
# this width in a CPU check (gamma; segment_end 5.1e-4): posteriors
# atol 5e-3; gradients and EM parameters, sums over 32,000 frames of
# them, within 5e-3 of each tensor's largest entry.
HSMM_POST_ATOL = 5e-3
HSMM_GRAD_RTOL = HSMM_EM_RTOL = 5e-3
# Row 24, the training backward's cotangents, vs their plain version on
# the same tables (float32 both). Both take each posterior as exp(alpha +
# beta - log Z) from exponents of ~1e3 (ulp 6e-5), and the plain version
# the occupancy as a difference of two running sums where the kernel
# scans start - end; d_log_obs within 2e-4 of max |g| (measured 4.9e-5
# at the cell's shape). The parameters' cotangents are sums over up to
# 6.4e5 frames taken in another order (float32 partials a block, then
# float64; the plain's own float32 reductions): within 1e-5 of each
# tensor's largest entry (measured 1.3e-6). Against float64 on the same
# tables the kernel may be at most TABLE_GRADS_F64 times as far off as
# the plain version, plus 1e-7.
TABLE_GRADS_OBS_ATOL, TABLE_GRADS_RTOL, TABLE_GRADS_F64 = 2e-4, 1e-5, 1.5
# Training on the card vs the same layer on the CPU in float64. The loss
# and EM log-likelihood (mean log Z ~ -1.5e5): rtol 1e-5, about 80 f32
# ulps of a sum of 1000 frames of ~150. Gradients and EM parameters are
# compared relative to each tensor's largest entry (logits as their
# softmax): the f32 posteriors, taken on max-shifted chains, carry
# ~1e-3 absolute error at this width, and sums over 32,000 frames
# average it down.
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3
EM_RTOL = 1e-3
# EM never lowers the log-likelihood in exact arithmetic; allow f32
# rounding of the ~1.5e5 sum.
LL_SLACK = 1e-6
# The streaming configuration's width (the JAX bench's streaming rows,
# bench.py:264-362): states, features, chunk frames; the processor's
# defaults give beam width 8 and a history of max(50, 160) + 5 frames.
SS, SF, SCHUNK, SW, SH = 12, 80, 160, 8, 165
STREAM_CHUNKS = 20
FLEETS = (8, 16)
HOP = 160
# Card vs CPU: the emission MLPs round differently in their last bits,
# so decoded states agree on at least 99.9% of frames and per-chunk
# confidences (the geometric-mean frame probability) within 1e-5.
STREAM_AGREE = 0.999
STREAM_CONF_ATOL = 1e-5
# The neural configuration's width: the JAX bench's NeuralHMM row
# (bench.py:468-491): batch, frames, states, features, hidden units; the
# contextual twin's phoneme vocabulary and prosody features, and the frames
# of the transformer / rnn transition checks.
NB, NT, NS, ND, NH = 16, 1000, 12, 80, 256
VOCAB, PROSODY, SMALL_T = 64, 16, 64
# The neural emission kernel vs its plain version: rtol/atol 1e-4, the JAX
# kernel test's own (tests/test_neural.py). The neural models on the card
# vs the CPU in float64: posteriors atol 5e-3 (f32 chains on shifted
# emissions, as for the duration models), gradients within 5e-3 of each
# tensor's largest entry (sums over 16,000 frames of f32 posteriors and
# emission products).
EMIT_TOL = 1e-4
NEURAL_POST_ATOL = 5e-3
NEURAL_GRAD_RTOL = 5e-3
# The general-K slice's width: GaussianHMMLayer(64, 80), diag, at the
# headline B and T (the JAX bench's K>32 row, bench.py:497; D, B and T of
# bench.py:633-653); MixtureGaussianHMMLayer at the same S and D with
# C=2 (inside the fused decode's envelope) and C=4 (outside it).
GK, GD = 64, 80
GMM_CS = (2, 4)
# The general-K sum kernels vs their plain versions (the same prob-space
# step): atol 5e-4, the JAX kernel tests' own (tests/test_ops.py), plus
# rtol 1e-6 of the running magnitude. The fused decode vs its plain
# version (the emission summed in another order): frames agree on at
# least 99.9%, scores within rtol 1e-4, atol 5e-3 (the JAX test's own
# against its unfused route).
SCAN_ATOL, SCAN_RTOL = 5e-4, 1e-6
FUSED_AGREE, FUSED_RTOL, FUSED_ATOL = 0.999, 1e-4, 5e-3
# The timing key of the S=64, C=2 decode through rows 1 and 13, unfused.
UNFUSED = "fused_gmm_viterbi unfused route"
# The slice on the card vs its CPU twin in float64: posteriors atol 5e-3
# and gradients / EM parameters within 5e-3 of each tensor's largest
# entry (f32 prob-space chains on max-shifted emissions, sums over 32,000
# frames), as for the duration and neural models.
GENK_POST_ATOL = 5e-3
GENK_GRAD_RTOL = GENK_EM_RTOL = 5e-3
# The long-sequence slice: the JAX bench's long-context rows
# (bench.py:493-537: B=32, T=131072, K=64) through ops.auto_forward and the
# gradient of ops.auto_log_likelihood; the prob-space chains against their
# plain versions at T=4096; GaussianHMMLayer(64, 80, "full") at B=32,
# T=2048 (past the prob route's T >= 1024); the JAX bench's
# full-covariance decode row (bench.py:602-631: S=12, C=4, D=80, B=32,
# T=1000). Rows checked against float64: two of the long-context batch, four
# of the full-covariance layer's (the CPU twin's scan is a Python loop).
LB, LT, LK = 32, 131072, 64
PROB_T, FULL_T = 4096, 2048
LONG_SUB, FULL_SUB = 2, 4
LONG_RUNS = 5          # timed calls at T=131072, 30-250 ms each
# Rows 10-12 vs their plain versions (the same scaled chain, rescaled at
# the same frames), compared split as the kernels write them. The relative
# tables log(max(q, 1e-37)) keep one frame's magnitude: atol 1e-4. The
# per-frame shifts and log Z: atol 5e-4, the JAX scan tests' own, plus
# rtol 3e-5 of their magnitude: the plain version sums the shift (the
# rescales and the frames' maxima) in float32 over T frames, which at
# T=4096 reaches ~1e4, where f32 rounding of 4096 terms spreads ~1e-2.
PROB_REL_ATOL = 1e-4
PROB_ATOL, PROB_RTOL = 5e-4, 3e-5
# The long-context outputs (log Z of ops.auto_forward, of
# auto_log_likelihood with and without a gradient, and log alpha) of two
# rows against float64: rtol 1e-6 of the magnitude (|log alpha| ~2.5e5,
# where one f32 ulp is 0.016; the kernel carries its shift in double and
# rounds each frame's to f32 once, and the sums add a few roundings more)
# plus atol 0.05 for the chain's own f32 products over 131072 frames. A
# rescale or a chunk of maxima dropped from the shift (nats to hundreds of
# nats) lies far outside.
LONG_ATOL, LONG_RTOL = 0.05, 1e-6
# HMM's log-likelihood on frame probabilities (floored at 1e-8) is only
# ~1e3 in magnitude, where f32 rounding of a 1000-frame chain reaches
# ~1e-2: rtol 1e-4.
HMM_LL_RTOL = 1e-4
# The CTC slice: the JAX bench's forced-alignment rows (bench.py:413-440:
# B=16, T=500, C=40, U=50; bench.py:572-600: B=4, T=2048, C=100, U=1000, the
# S=2001 lattice) with their data: full lengths, standard normal logits
# through log_softmax, labels uniform over 1..C-1. CTCAligner takes the loss
# and its gradient, Adam, align, the posterior path and both decodes at the
# first shape, align at the second.
CTC_SHAPES = {"headline": (16, 500, 40, 50), "S=2001": (4, 2048, 100, 1000)}
CTC_BEAM = 4
# Rows 20-23 against their plain versions, and the slice against its CPU
# twin in float64: the JAX kernel tests' tolerances (tests/test_ops_ctc.py):
# alpha / beta atol 5e-4 at valid cells above -1e29, the loss (and each
# log-likelihood) rtol 1e-4 + atol 1e-3, Viterbi positions identical and
# scores atol 1e-4; the loss gradient atol 1e-4 (the JAX test of its VJP).
# Forced alignment and decodes against the CPU twin in float32: identical
# (the trellis adds and compares only). The posterior path, an argmax of
# f32 alpha + beta against float64, agrees on at least 99.9% of frames.
CTC_ATOL = 5e-4
CTC_LL_RTOL, CTC_LL_ATOL = 1e-4, 1e-3
CTC_SCORE_ATOL = 1e-4
CTC_GRAD_ATOL = 1e-4
CTC_PATH_AGREE = 0.999
# The DTW slice: the JAX bench's DTW row (bench.py:442-466): standard normal
# (500, 80) features, euclidean distances, the symmetric pattern; a batch of 4
# pairs, a Sakoe-Chiba band of 10, 40 phonemes over the 500 frames (cosine),
# soft-DTW at 64x64.
DTW_N, DTW_D, DTW_BATCH, DTW_BAND, DTW_PHONEMES, DTW_SOFT = 500, 80, 4, 10, 40, 64
# Row 19 against its plain version: identical (adds and compares only). The
# card's distances against the CPU's: atol 1e-4 + rtol 1e-5 (a float32
# product of 80 terms summed in another order; distances up to ~20).
# Soft-DTW against the CPU: the expected alignment atol 1e-4, the cost rtol
# 1e-5 (float32 logsumexp chains of 127 steps whose exp and log round in
# other last bits).
DTW_DIST_ATOL, DTW_DIST_RTOL = 1e-4, 1e-5
DTW_SOFT_ATOL, DTW_SOFT_RTOL = 1e-4, 1e-5
# Row 15: the JAX bench's large-state row (bench.py:542-570: B=48, T=2048,
# K=512, its data) and K=1024, the top of the envelope, at B=16, T=2048.
# Against its plain version: atol 0.05 + rtol 1e-4. Both round q to bf16
# each frame, but the tensor cores sum a frame's products in another order
# than the plain matmul, which can move a rounding of q by one bf16 unit
# (~2e-3 of a state's mass) that the chain then carries. Against float64
# core.log_likelihood on 4 rows: atol 0.05 + rtol 1e-3, the JAX kernel
# test's scoring tolerance (tests/test_ops_bigk.py).
BIGK_SHAPES = {"K=512": (48, 2048, 512), "K=1024": (16, 2048, 1024)}
BIGK_ATOL, BIGK_PLAIN_RTOL, BIGK_RTOL = 0.05, 1e-4, 1e-3
BIGK_F64_ROWS = 4
# The cluster layout's edges: K=1000 pads to 1024 (its last CTA's slice
# holds 40 real columns) over 17 rows (two clusters, one a single real
# row); K=768 is a cluster of 12; B=320 at K=1024 is 20 clusters of 16
# CTAs, more than the card holds at once, so they run in waves; the wide
# batches take the plan's fewer, wider slices: 4 CTAs of 128 columns at
# K=512, 2 of 192 at K=384, 1 of 256 at K=256.
BIGK_CLUSTER_CASES = {"K=1000": (17, 256, 1000), "K=768": (20, 256, 768), "multi-wave": (320, 256, 1024),
                      "K=512 B=400": (400, 128, 512), "K=384 B=400": (400, 128, 384),
                      "K=256 B=600": (600, 128, 256)}
# A log-obs view off 16-byte alignment (B, T, K).
BIGK_OFFSET_VIEW = (3, 128, 64)
# Cluster barriers timed by the probe of csrc/bigk_scoring.cu.
PROBE_ITERS = (1000, 3000)
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores, the type every kernel but row 15 computes in; bf16
# on the tensor cores (dense), row 15's products.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

KERNELS = {
    "diag_quadratic": {
        "source": "pytorch_hmm_tpu_torch/csrc/diag_quadratic.cu",
        "replaces": "pytorch_hmm_tpu/ops/emit.py:64",
    },
    "smallk_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/smallk_viterbi.cu",
        "replaces": "pytorch_hmm_tpu/ops/smallk.py:379",
    },
    "fbsum_smallk": {
        "source": "pytorch_hmm_tpu_torch/csrc/smallk_sum.cu",
        "replaces": "pytorch_hmm_tpu/ops/fbsum.py:240",
    },
    "hsmm_smallk_forward": {
        "source": "pytorch_hmm_tpu_torch/csrc/smallk_sum.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:678",
    },
    "hsmm_smallk_backward": {
        "source": "pytorch_hmm_tpu_torch/csrc/smallk_sum.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:903",
    },
    "hsmm_smallk_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/hsmm_smallk.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:435",
    },
    "hsmm_smallk_fb": {
        "source": "pytorch_hmm_tpu_torch/csrc/hsmm_smallk.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:1182",
    },
    "hsmm_smallk_forward_general": {
        "source": "pytorch_hmm_tpu_torch/csrc/hsmm_smallk.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:678",
    },
    "hsmm_smallk_backward_general": {
        "source": "pytorch_hmm_tpu_torch/csrc/hsmm_smallk.cu",
        "replaces": "pytorch_hmm_tpu/ops/hsmm_smallk.py:903",
    },
    "hsmm_table_grads": {
        "source": "pytorch_hmm_tpu_torch/csrc/hsmm_grads.cu",
        "replaces": "none (pytorch_hmm_tpu/core/hsmm.py:289, the table algebra left to XLA)",
    },
    "greedy_chunk": {
        "source": "pytorch_hmm_tpu_torch/csrc/stream_greedy.cu",
        "replaces": "pytorch_hmm_tpu/ops/stream.py:136",
    },
    "beam_chunk_multi": {
        "source": "pytorch_hmm_tpu_torch/csrc/stream_beam.cu",
        "replaces": "pytorch_hmm_tpu/ops/stream_multi.py:289",
    },
    "fused_gaussian_emission": {
        "source": "pytorch_hmm_tpu_torch/csrc/emit_mlp.cu",
        "replaces": "pytorch_hmm_tpu/ops/emit_mlp.py:133",
    },
    "pallas_forward": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_bigk.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:227",
    },
    "pallas_backward": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_bigk.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:840",
    },
    "pallas_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_bigk.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:1143",
    },
    "fused_gmm_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/fused_gmm.cu",
        "replaces": "pytorch_hmm_tpu/ops/fused.py:265",
    },
    "pallas_forward_prob": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_prob.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:453",
    },
    "pallas_backward_prob": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_prob.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:669",
    },
    "pallas_fb_prob": {
        "source": "pytorch_hmm_tpu_torch/csrc/scan_prob.cu",
        "replaces": "pytorch_hmm_tpu/ops/scan.py:1452",
    },
    "ctc_lattice_forward": {
        "source": "pytorch_hmm_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "pytorch_hmm_tpu/ops/ctc_kernel.py:1246",
    },
    "ctc_lattice_backward": {
        "source": "pytorch_hmm_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "pytorch_hmm_tpu/ops/ctc_kernel.py:1370",
    },
    "ctc_lattice_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "pytorch_hmm_tpu/ops/ctc_kernel.py:1186",
    },
    "ctc_lattice_viterbi_wide": {
        "source": "pytorch_hmm_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "pytorch_hmm_tpu/ops/ctc_kernel.py:994",
    },
    "pallas_dtw": {
        "source": "pytorch_hmm_tpu_torch/csrc/dtw.cu",
        "replaces": "pytorch_hmm_tpu/ops/dtw.py:142",
    },
    "bigk_log_likelihood": {
        "source": "pytorch_hmm_tpu_torch/csrc/bigk_scoring.cu",
        "replaces": "pytorch_hmm_tpu/ops/bigk.py:230",
    },
}
CTC_KERNELS = ("ctc_lattice_forward", "ctc_lattice_backward", "ctc_lattice_viterbi",
               "ctc_lattice_viterbi_wide")
# The general-K kernels (rows 8, 9, 13, 14); "bigk" names row 15 alone.
GENK_KERNELS = ("pallas_forward", "pallas_backward", "pallas_viterbi", "fused_gmm_viterbi")
PROB_KERNELS = ("pallas_forward_prob", "pallas_backward_prob", "pallas_fb_prob")
# Entry points of the long-sequence slice profiled for their device-busy share.
LONG_PROFILED = ("long-context gradient", "GaussianHMMLayer full decode",
                 "MixtureGaussianHMMLayer full decode", "MixtureGaussianHMMLayer full compute_loss step")
# The sum chains whose launches the long-context and gate checks count.
CHAIN_KERNELS = ("pallas_forward", "pallas_backward", *PROB_KERNELS)
# General-K entry points profiled for their device-busy share.
GENK_PROFILED = ("GaussianHMMLayer decode", "GaussianHMMLayer compute_loss step",
                 "MixtureGaussianHMMLayer C=2 decode")
# Kernels with a time-varying (B, T, K, K) mode, counted apart as well.
TIME_VARYING = ("smallk_viterbi", "fbsum_smallk")
TRAINING_KERNELS = ("diag_quadratic", "fbsum_smallk", "hsmm_smallk_forward",
                    "hsmm_smallk_backward")
DURATION_DECODE_KERNELS = ("diag_quadratic", "hsmm_smallk_viterbi")
DURATION_TRAINING_KERNELS = ("diag_quadratic", "hsmm_smallk_fb", "hsmm_smallk_forward_general",
                             "hsmm_smallk_backward_general", "hsmm_table_grads")
NEURAL_KERNELS = {
    "NeuralHMM": ("fused_gaussian_emission", "smallk_viterbi", "fbsum_smallk",
                  "hsmm_smallk_forward", "hsmm_smallk_backward"),
    "ContextualNeuralHMM": ("fused_gaussian_emission", "smallk_viterbi", "fbsum_smallk"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def must_raise(exc, fn, what: str) -> None:
    """Fail unless ``fn()`` raises ``exc``."""
    try:
        fn()
    except exc:
        return
    raise SmokeFailure(f"{what} did not raise {exc.__name__}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def cuda_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = DQ_GRAPH_LAUNCHES, replays: int = TIMED_RUNS) -> float:
    """Device time of one call of ``fn``: a CUDA graph of ``launches``
    calls, replayed ``replays`` times, each replay timed with CUDA events;
    the median over ``launches``. The host's enqueue is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_median_ms(graph.replay, runs=replays) / launches


def phase_build():
    """Build every kernel source at once, one nvcc each."""
    from pytorch_hmm_tpu_torch.ops import _build, fused, hsmm_smallk

    libs = sorted({Path(k["source"]).stem for k in KERNELS.values()})
    probes = [("scan_prob", PROBE_DEFINES), ("fused_gmm", fused.PROBE_DEFINES),
              ("hsmm_smallk", hsmm_smallk.PROBE_DEFINES)]
    jobs = [(lib, ()) for lib in libs] + probes
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for future in [pool.submit(_build.build, lib, defines) for lib, defines in jobs]:
            future.result()
    return time.perf_counter() - t0, libs + [f"{lib} (probe)" for lib, _ in probes]


def kernel_fns():
    """Each kernel's wrapper (which holds its launch count)."""
    from pytorch_hmm_tpu_torch import ops

    return {name: getattr(ops, name) for name in KERNELS}


def reset_launches():
    for fn in kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "time_varying_launches"):
            fn.time_varying_launches = 0
        if hasattr(fn, "mixture_launches"):
            fn.mixture_launches = 0


def read_launches(names):
    fns = kernel_fns()
    return {name: fns[name].launches for name in names}


def read_tv_launches():
    fns = kernel_fns()
    return {name: fns[name].time_varying_launches for name in TIME_VARYING}


def phase_diag_quadratic(dev, gen):
    """Kernel vs plain on the card at the headline and ragged shapes, then
    at the other column counts the main path gives it (``DQ_WIDE``, from
    their own generator so the later phases' data stay as they were).
    Returns the max abs error of each shape."""
    import torch
    from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic, diag_quadratic_reference

    errs = {}
    gen_wide = torch.Generator(device=dev).manual_seed(SEED + 17)
    for (b, t, d, n) in [(B, T, D, S * C), (3, 257, 77, 37), *DQ_WIDE]:
        g = gen if (b, t, d, n) in ((B, T, D, S * C), (3, 257, 77, 37)) else gen_wide
        x = torch.randn(b, t, d, device=dev, generator=g)
        wq = torch.randn(d, n, device=dev, generator=g) ** 2
        wl = torch.randn(d, n, device=dev, generator=g)
        bias = torch.randn(n, device=dev, generator=g)
        got = diag_quadratic(x, wq, wl, bias)
        want = diag_quadratic_reference(x, wq, wl, bias)
        torch.cuda.synchronize(dev)
        check(got.shape == (b, t, n), f"diag_quadratic shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        errs[(b, t, d, n)] = err
        check(torch.allclose(got, want, atol=DQ_ATOL, rtol=DQ_RTOL),
              f"diag_quadratic {(b, t, d, n)} disagrees: max abs err {err}")
    return errs


def mixture_problem(dev, gen, b, t, s, c, d, cov="diag"):
    """A GMM decode batch at the benchmark's scale: means N(0, 1), log
    variances and mixture logits 0.1·N(0, 1); each frame drawn from one
    component of a state held 8 frames, half a unit off its mean plus unit
    noise (the true state ~ -125 a frame at d=80); lengths from ``t`` down
    to a quarter, padded frames zero. Returns ``(obs, means, cov_params,
    logits, lengths)``."""
    import torch

    means = torch.randn(s, c, d, device=dev, generator=gen)
    cov_p = 0.1 * torch.randn((s, c, d) if cov == "diag" else (d,), device=dev, generator=gen)
    logits = 0.1 * torch.randn(s, c, device=dev, generator=gen)
    states = torch.randint(0, s, (b, -(-t // 8)), device=dev, generator=gen)
    states = states.repeat_interleave(8, 1)[:, :t]
    comps = torch.randint(0, c, (b, t), device=dev, generator=gen)
    off = 0.5 * torch.randn(s, c, d, device=dev, generator=gen)
    x = means[states, comps] + off[states, comps]
    x += torch.randn(b, t, d, device=dev, generator=gen)
    ln = torch.linspace(t, max(1, t // 4), b, device=dev).round().to(torch.int32)
    x *= (torch.arange(t, device=dev) < ln[:, None].long())[..., None]
    return x, means, cov_p, logits, ln


def mixture_vs_plain(obs, means, cov_p, logits, cov="diag"):
    """``emissions.gmm_log_probs`` on the card (row 1's mixture mode, one
    launch, no gradient), beside the route it replaces (row 1, then the
    plain epilogue) and the plain version in float64. Returns ``(got,
    composite, want64, launches)``, ``launches`` the change in
    ``(diag_quadratic.launches, .mixture_launches)`` of the first call."""
    import torch
    from pytorch_hmm_tpu_torch import emissions, ops
    from pytorch_hmm_tpu_torch.core.semiring import logsumexp

    dq = ops.diag_quadratic
    with torch.no_grad():
        before = dq.launches, dq.mixture_launches
        got = emissions.gmm_log_probs(obs, means, cov_p, logits, cov)
        launches = (dq.launches - before[0], dq.mixture_launches - before[1])
        comp = emissions.gmm_component_log_probs(obs, means, cov_p, cov)
        composite = logsumexp(comp + torch.log_softmax(logits, dim=-1), dim=-1)
        del comp
        tables = emissions._diag_mixture_tables(means.double(), cov_p.double(), logits.double(), cov)
        want64 = ops.emit.diag_gmm_log_probs_reference(obs.double(), *tables, means.shape[1])
    return got, composite, want64, launches


def mixture_share(got, want):
    """The worst ``|got - want|`` as a share of the mixture mode's
    tolerance (``MIX_ATOL`` at ``|want| <= MIX_SCALE``, in proportion
    above); non-finite entries must match exactly."""
    import torch

    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin].to(got.dtype)),
          "mixture scores: non-finite entries differ")
    tol = MIX_ATOL * torch.clamp(want[fin].abs() / MIX_SCALE, min=1.0)
    return ((got[fin].double() - want[fin].double()).abs() / tol).max().item()


def phase_mixture_epilogue(dev, gen):
    """Row 1's mixture mode against row 1 plus the plain epilogue on every
    ``MIX_CASES`` case (diag; tied at the cell's shape too), each launch
    counted, and both against float64; then timed at the cell's shape:
    the fused launch against row 1 alone and against row 1 plus the plain
    epilogue, and ``gmm_log_probs`` whole (the tables too) on the fused
    route against the composite. Returns ``(errs, times, launches)``:
    per case the fused result's share of the tolerance against the
    composite, and the worst abs error against float64 of the fused and
    the composite result."""
    import torch
    from pytorch_hmm_tpu_torch import emissions, ops
    from pytorch_hmm_tpu_torch.core.semiring import logsumexp

    errs, launches = {}, None
    for name, shape in [*MIX_CASES.items(), ("cell tied", MIX_CASES["cell"])]:
        cov = "tied" if name.endswith("tied") else "diag"
        obs, means, cov_p, logits, _ = mixture_problem(dev, gen, *shape, cov=cov)
        got, composite, want64, launches = mixture_vs_plain(obs, means, cov_p, logits, cov)
        torch.cuda.synchronize(dev)
        check(launches == (1, 1), f"mixture {name}: launches {launches}, expected one fused")
        check(got.shape == composite.shape == shape[:2] + (shape[2],), f"mixture {name}: shape")
        share = mixture_share(got, composite)
        check(share <= 1.0, f"mixture {name}: {share:.3g} of the tolerance off row 1 + plain")
        f64 = [(v.double() - want64).abs().max().item() for v in (got, composite)]
        check(f64[0] <= f64[1] + MIX_ATOL * max(1.0, want64.abs().max().item() / MIX_SCALE),
              f"mixture {name}: float64 error {f64[0]:.3g} past the composite's {f64[1]:.3g}")
        errs[name] = (share, *f64)
        del obs, got, composite, want64

    obs, means, cov_p, logits, _ = mixture_problem(dev, gen, *MIX_CASES["cell"])
    Cc = means.shape[1]
    with torch.no_grad():
        tables = emissions._diag_mixture_tables(means, cov_p, logits, "diag")
        wq, wl, bias, log_norm, log_w = tables

        def plain_route():
            mahal = ops.diag_quadratic(obs, wq, wl, bias)
            comp = (log_norm - 0.5 * mahal).reshape(*mahal.shape[:-1], -1, Cc)
            return logsumexp(comp + log_w.reshape(-1, Cc), dim=-1)

        def composite_call():
            comp = emissions.gmm_component_log_probs(obs, means, cov_p, "diag")
            return logsumexp(comp + torch.log_softmax(logits, dim=-1), dim=-1)

        fns = {"fused launch": lambda: ops.emit.diag_gmm_log_probs(obs, *tables, Cc),
               "row 1 alone": lambda: ops.diag_quadratic(obs, wq, wl, bias),
               "row 1 + plain epilogue": plain_route,
               "gmm_log_probs fused route": lambda: emissions.gmm_log_probs(obs, means, cov_p, logits),
               "gmm_log_probs composite": composite_call}
        times = {}
        for name in fns:
            times[name] = cuda_median_ms(fns[name])
        before = ops.diag_quadratic.mixture_launches
        emissions.gmm_log_probs(obs, means, cov_p, logits)
        launches = ops.diag_quadratic.mixture_launches - before
    return errs, times, launches


def phase_bf16_scoring(dev):
    """``emissions.gmm_log_probs(..., compute_dtype=torch.bfloat16)`` at
    the GMM width (B, T, S, C, D) for each covariance type, on CUDA
    tensors against the same call on the CPU. Full covariance is held
    through ``full_gaussian_log_probs_prepared`` on the card's own
    ``fullcov_prepare`` tables: the float32 Cholesky algebra differs in
    its last bits between the devices, and rounding the precision
    matrices to bf16 turns that into whole bf16 steps. This path is plain
    torch on every device (row 1 computes only true float32), so it also
    returns row 1's launches over the calls, 0 until row 1 has a bf16
    mode. Returns ``({cov: max abs err}, launches)``."""
    import torch
    from pytorch_hmm_tpu_torch import emissions

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    obs = torch.randn(B, T, D, device=dev, generator=g)
    means = torch.randn(S, C, D, device=dev, generator=g)
    logits = torch.randn(S, C, device=dev, generator=g)
    cov = {"diag": 0.3 * torch.randn(S, C, D, device=dev, generator=g),
           "tied": 0.3 * torch.randn(D, device=dev, generator=g),
           "spherical": 0.3 * torch.randn(S, C, device=dev, generator=g),
           "full": 0.05 * torch.randn(S, C, D * (D + 1) // 2, device=dev, generator=g)}
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a  # noqa: E731
    errs = {}
    reset_launches()
    for kind, cp in cov.items():
        args = (obs, means, cp, logits, kind)
        got = emissions.gmm_log_probs(*args, compute_dtype=bf16)
        check(got.shape == (B, T, S) and got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
              f"bf16 gmm_log_probs {kind}: {tuple(got.shape)} {got.dtype}")
        if kind == "full":
            prep = emissions.fullcov_prepare(means.reshape(S * C, D),
                                             emissions.tril_from_flat(cp.reshape(S * C, -1), D))
            got = emissions.full_gaussian_log_probs_prepared(obs, prep, compute_dtype=bf16)
            want = emissions.full_gaussian_log_probs_prepared(
                obs.cpu(), {k: cpu(v) for k, v in prep.items()}, compute_dtype=bf16)
        else:
            want = emissions.gmm_log_probs(*map(cpu, args), compute_dtype=bf16)
        errs[kind] = (got.cpu() - want).abs().max().item()
        check(torch.allclose(got.cpu(), want, atol=BF16_CARD_ATOL, rtol=BF16_CARD_RTOL),
              f"bf16 {kind} scores on the card vs the CPU: max abs err {errs[kind]}")
    torch.cuda.synchronize(dev)
    return errs, read_launches(["diag_quadratic"])["diag_quadratic"]


def _viterbi_cases(dev, gen):
    import torch

    def rand(b, t, k, lengths=None):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        return lo, la, lp, ln

    k = 6  # all ties (tests/test_ops.py:271)
    ties = (torch.zeros(2, 40, k, device=dev),
            torch.full((k, k), -torch.log(torch.tensor(float(k))).item(), device=dev),
            torch.full((k,), -torch.log(torch.tensor(float(k))).item(), device=dev), None)
    k = 4  # ties among {1..K-1} with a ~-inf diagonal (tests/test_ops.py:281)
    a = torch.full((k, k), 1.0 / (k - 1), dtype=torch.float64)
    a.fill_diagonal_(0.0)
    bracketed = (torch.zeros(2, 50, k, device=dev),
                 torch.log(a + 1e-300).float().to(dev),
                 torch.full((k,), -torch.log(torch.tensor(float(k))).item(), device=dev), None)
    return {
        "headline": rand(B, T, S),
        "K=32": rand(8, 500, 32),
        "ragged": rand(5, 300, 9, [300, 31, 164, 1, 129]),
        "T=1": rand(3, 1, 5),
        "all-ties": ties,
        "bracketed-ties": bracketed,
    }


def gmm_scale_problem(dev, gen, b, t, k, d):
    """A row-2 problem at GMM scale: diagonal-Gaussian scores (unit
    variances, means N(0, 1) in ``d`` features) of features that dwell
    8 frames in a state, each moved half a unit off its mean, so the true
    state scores ~ -125 a frame at d=80 and the others ~80 below it;
    transitions with a self-loop of ~0.9, a uniform prior, lengths from
    ``t`` down to a quarter of it (``b`` >= 2)."""
    import math

    import torch

    means = torch.randn(k, d, device=dev, generator=gen)
    states = torch.randint(0, k, (b, -(-t // 8)), device=dev, generator=gen)
    states = states.repeat_interleave(8, 1)[:, :t]
    x = (means[states] + 0.5 * torch.randn(k, d, device=dev, generator=gen)[states]
         + torch.randn(b, t, d, device=dev, generator=gen))
    quad = (x * x).sum(-1, keepdim=True) - 2.0 * x @ means.T + (means * means).sum(-1)
    lo = (-0.5 * (d * math.log(2.0 * math.pi) + quad)).contiguous()
    la = torch.log_softmax(0.1 * torch.randn(k, k, device=dev, generator=gen)
                           + math.log(99.0) * torch.eye(k, device=dev), -1)
    lp = torch.full((k,), -math.log(k), device=dev)
    ln = torch.linspace(t, t // 4, b, device=dev).round().to(torch.int32)
    return lo, la, lp, ln


def path_score64(lo, la, lp, states, lengths=None):
    """Each row's score ``(B,)`` in float64 of the frame ``states`` over
    its valid frames, under static ``(K, K)`` or time-varying ``(B, T, K,
    K)`` transitions."""
    import torch

    lo, la, lp = lo.double(), la.double(), lp.double()
    B, T, _ = lo.shape
    s = states.to(lo.device).long()
    step = lo.gather(2, s[..., None])[..., 0].clone()
    if la.ndim == 2:
        step[:, 1:] += la[s[:, :-1], s[:, 1:]]
    else:
        rows = torch.arange(B, device=lo.device)[:, None]
        step[:, 1:] += la[rows, torch.arange(1, T, device=lo.device)[None], s[:, :-1], s[:, 1:]]
    valid = torch.ones_like(step, dtype=torch.bool)
    if lengths is not None:
        valid = torch.arange(T, device=lo.device)[None] < lengths.to(lo.device).long()[:, None]
        valid[:, 0] = True
    return lp[s[:, 0]] + torch.where(valid, step, 0.0).sum(1)


def _gap(want, got):
    """``want - got`` where both are finite, 0 where they are equal
    infinities, inf elsewhere."""
    import torch

    same = want == got
    return torch.where(same, torch.zeros_like(want),
                       torch.nan_to_num(want - got, nan=float("inf")))


def score_share(best, score, t):
    """The worst row's ``|score - best|`` over its tolerance against the
    float64 ``best`` at ``t`` frames."""
    tol = VIT_F64_RTOL * best.abs() + VIT_F64_ATOL_FRAME * t
    return (_gap(best, score.to(best.device).double()).abs() / tol).max().item()


def trellis_vs_f64(what, got, lo, la, lp, lengths=None, plain=None):
    """Row 2's ``got = (states, score)`` against the plain trellis in
    float64 on the same inputs: each score within ``VIT_F64_RTOL`` and
    ``VIT_F64_ATOL_FRAME`` a frame, each path within ``VIT_PATH_GAP`` nats
    of the float64 best, scored in float64; with ``plain`` (the plain
    float32 version's states) the paths equal those but on near ties.
    Returns ``(the worst score error as a share of its tolerance, the
    worst path gap in nats, rows whose path left the plain one, the worst
    score error in nats)``."""
    from pytorch_hmm_tpu_torch import core

    states, score = got
    _, best = core.viterbi(lo.double(), la.double(), lp.double(), lengths)
    share = score_share(best, score, lo.shape[1])
    gap = _gap(best, path_score64(lo, la, lp, states, lengths))
    worst_gap = gap.max().item()
    check(share <= 1.0, f"{what}: scores off float64 by {share:.3g} of the tolerance")
    check(worst_gap <= VIT_PATH_GAP, f"{what}: a path {worst_gap:.3g} nats below the float64 best")
    left = 0
    if plain is not None:
        left = int((states.to(plain.device) != plain).any(1).sum())
    return share, worst_gap, left, _gap(best, score.to(best.device).double()).abs().max().item()


def phase_smallk_viterbi(dev, gen):
    """Kernel vs plain on identical log-obs, and both vs float64 (the
    cases of ``_viterbi_cases`` and the long-T GMM-scale ``VIT_LONG``);
    returns ``{case: (the kernel's and the plain float32 version's worst
    score error vs float64, as shares of the tolerance; the kernel's worst
    path gap; rows whose path left the plain one; the kernel's worst score
    error vs float64 in nats)}``."""
    import torch
    from pytorch_hmm_tpu_torch import core
    from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi, smallk_viterbi_reference

    cases = _viterbi_cases(dev, gen)
    cases["GMM scale T=4096"] = gmm_scale_problem(dev, gen, *VIT_LONG)
    out = {}
    for name, (lo, la, lp, ln) in cases.items():
        s1, c1 = smallk_viterbi(lo, la, lp, ln)
        s0, c0 = smallk_viterbi_reference(lo, la, lp, ln)
        torch.cuda.synchronize(dev)
        check(s1.dtype == torch.int32 and s1.shape == lo.shape[:2],
              f"smallk_viterbi {name}: states {s1.dtype} {tuple(s1.shape)}")
        share, gap, left, err = trellis_vs_f64(f"smallk_viterbi {name}", (s1, c1), lo, la, lp, ln,
                                               s0)
        _, best = core.viterbi(lo.double(), la.double(), lp.double(), ln)
        out[name] = (share, score_share(best, c0, lo.shape[1]), gap, left, err)
    return out


def make_requests(dev):
    """A decode batch drawn from a left-to-right walk over random
    Gaussians, plus ragged lengths (one full row, one of length 1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    centers = torch.randn(S, D, device=dev, generator=gen)
    seg = torch.randint(1, 2 * T // S, (B, 1), device=dev, generator=gen)
    states = (torch.arange(T, device=dev)[None, :] // seg) % S
    obs = centers[states] + torch.randn(B, T, D, device=dev, generator=gen)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0], lengths[1] = T, 1
    return obs.contiguous(), lengths


def phase_decode(dev):
    """Serve three requests through the layer on the card, count kernel
    launches, and check the results against the layer on the CPU."""
    import torch
    from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, core
    from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi

    layer = MixtureGaussianHMMLayer(
        S, D, num_components=C, covariance_type="diag",
        generator=torch.Generator().manual_seed(SEED), device=dev,
    ).eval()
    obs, lengths = make_requests(dev)

    reset_launches()
    full = layer(obs, return_log_probs=True)
    ragged = layer(obs, return_log_probs=True, lengths=lengths)
    served = layer.make_decoder()(obs, return_log_probs=True)
    torch.cuda.synchronize(dev)
    launches = read_launches(("diag_quadratic", "smallk_viterbi"))
    for name, n in launches.items():
        check(n > 0, f"the decode path never launched {name}")

    cpu = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="diag",
                                  device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    # The served results are held to the CPU twin in float64: the plain
    # float32 chain drifts by ~1e-5 of the score at this scale.
    cpu64 = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="diag",
                                    device="cpu").double().eval()
    cpu64.load_state_dict({k: v.cpu().double() for k, v in layer.state_dict().items()})
    obs_cpu, lengths_cpu = obs.cpu(), lengths.cpu()
    ref_full = cpu64(obs_cpu.double(), return_log_probs=True)
    ref_ragged = cpu64(obs_cpu.double(), return_log_probs=True, lengths=lengths_cpu)

    agreement = {}
    for name, (st, sc), (rst, rsc) in [("full", full, ref_full),
                                       ("ragged", ragged, ref_ragged),
                                       ("make_decoder", served, ref_full)]:
        st, sc = st.cpu(), sc.cpu()
        check(st.dtype == torch.int32 and st.shape == (B, T), f"{name}: states {st.dtype} {tuple(st.shape)}")
        check(sc.shape == (B,) and bool(torch.isfinite(sc).all()), f"{name}: scores not finite")
        check(int(st.min()) >= 0 and int(st.max()) < S, f"{name}: state out of range")
        agreement[name] = (st == rst).float().mean().item()
        check(agreement[name] >= 0.999, f"{name}: frame agreement {agreement[name]} < 0.999")
        check(torch.allclose(sc.double(), rsc, rtol=1e-5, atol=0.0),
              f"{name}: scores differ, max rel {((sc - rsc).abs() / rsc.abs()).max().item()}")
    # Padded frames repeat each row's last valid state.
    st = ragged[0].cpu()
    for b in range(B):
        n = int(lengths_cpu[b])
        check(bool((st[b, n - 1:] == st[b, n - 1]).all()), f"row {b}: padding not repeated")

    # The card's trellis on the CPU's log-obs gives the CPU's paths but on
    # near ties, and scores held to float64.
    dec_cpu = cpu.make_decoder()
    lo_cpu = dec_cpu.log_obs(obs_cpu)
    for ln in (None, lengths_cpu):
        rs, _ = core.viterbi(lo_cpu, dec_cpu.log_a, dec_cpu.log_pi, ln)
        got = smallk_viterbi(lo_cpu.to(dev), dec_cpu.log_a.to(dev), dec_cpu.log_pi.to(dev),
                             None if ln is None else ln.to(dev))
        trellis_vs_f64("card trellis on CPU log-obs", tuple(g.cpu() for g in got), lo_cpu,
                       dec_cpu.log_a, dec_cpu.log_pi, ln, rs)
    return layer, obs, launches, agreement


def _sum_cases(dev, gen):
    """Inputs of the sum-recursion checks: ``(log_obs, log_a, log_pi,
    lengths, log_dur)``, ``log_dur (K, 1)`` non-zero."""
    import torch

    def rand(b, t, k, lengths=None, left_to_right=False):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
        if left_to_right:
            # Self-loop and one step forward; -inf everywhere else.
            i = torch.arange(k, device=dev)
            band = (i[None, :] == i[:, None]) | (i[None, :] == i[:, None] + 1)
            la = torch.log_softmax(la.masked_fill(~band, float("-inf")), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        ld = 0.3 * torch.randn(k, 1, device=dev, generator=gen)
        return lo, la, lp, ln, ld

    return {
        "headline": rand(B, T, S),
        "K=32": rand(8, 500, 32),
        "ragged": rand(5, 300, 9, [300, 31, 164, 1, 129]),
        "T=1": rand(3, 1, 5),
        "left-to-right": rand(4, 300, S, left_to_right=True),
    }


def _sum_err(got, want, lengths, atol=SUM_ATOL, rtol=SUM_RTOL):
    """Max |got - want| over valid frames, or ``inf`` when they disagree
    beyond ``atol + rtol·|want|`` or either holds a NaN. Entries
    that are -inf in the plain version (impossible under -inf
    transitions) must be below -1e29 in the kernel's, which clamps at
    -1e30."""
    import torch

    valid = torch.ones_like(got, dtype=torch.bool)
    if lengths is not None and got.ndim == 3:
        valid = (torch.arange(got.shape[1], device=got.device)[None, :]
                 < lengths[:, None])[..., None].expand_as(got)
    if bool(torch.isnan(got[valid]).any() or torch.isnan(want[valid]).any()):
        return float("inf")
    impossible = valid & torch.isneginf(want)
    if bool((got[impossible] > -1e29).any()):
        return float("inf")
    ok = valid & ~impossible
    d = (got - want).abs()[ok]
    if bool((d > atol + rtol * want.abs()[ok]).any()):
        return float("inf")
    return d.max().item() if d.numel() else 0.0


def phase_sum_kernels(dev, gen):
    """The three sum-recursion kernels vs their plain versions on the
    same inputs; returns each kernel's max abs error at the headline
    shape."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    worst = {}
    for name, (lo, la, lp, ln, ld) in _sum_cases(dev, gen).items():
        got = {
            "fbsum_smallk": ops.fbsum_smallk(lo, la, lp, ln),
            "hsmm_smallk_forward": ops.hsmm_smallk_forward(lo, la, lp, ld, ln),
            "hsmm_smallk_backward": ops.hsmm_smallk_backward(lo, la, ld, ln),
        }
        torch.cuda.synchronize(dev)
        want = {
            "fbsum_smallk": ops.fbsum_smallk_reference(lo, la, lp, ln),
            "hsmm_smallk_forward": ops.hsmm_smallk_forward_reference(lo, la, lp, ld, ln),
            "hsmm_smallk_backward": ops.hsmm_smallk_backward_reference(lo, la, ld, ln),
        }
        for kernel, outs in got.items():
            err = max(_sum_err(g, w, ln) for g, w in zip(outs, want[kernel]))
            check(err != float("inf"), f"{kernel} {name}: disagrees with its plain version")
            if name == "headline":
                worst[kernel] = err
        # At D = 1 the backward's beta_start is log_obs + log_dur + beta*.
        bstar, bstart = got["hsmm_smallk_backward"]
        err = _sum_err(bstart, lo + ld[:, 0] + bstar, ln)
        check(err != float("inf"), f"hsmm_smallk_backward {name}: beta_start != o + beta*")
    return worst


def _grad_err(got, want):
    """Max abs difference relative to the reference's largest entry."""
    return ((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def phase_training(dev):
    """Train the layer on the card at full width: compute_loss gradients
    (diag unragged and ragged, tied) vs the CPU in float64, Adam, EM. Returns launch counts, errors, the
    loss and log-likelihood trajectories, and the layer and data."""
    import torch
    from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, ops

    def make(cov="diag"):
        return MixtureGaussianHMMLayer(
            S, D, num_components=C, covariance_type=cov,
            generator=torch.Generator().manual_seed(SEED), device=dev,
        )

    def cpu64(layer):
        ref = MixtureGaussianHMMLayer(S, D, num_components=C,
                                      covariance_type=layer.covariance_type, device="cpu").double()
        ref.load_state_dict({k: v.detach().cpu().double() for k, v in layer.state_dict().items()})
        return ref

    obs, lengths = make_requests(dev)
    obs64, lengths_cpu = obs.cpu().double(), lengths.cpu()
    layer = make()
    tied = make("tied")
    errs = {}

    reset_launches()
    # Diag unragged and ragged; tied (one shared log-variance through the
    # same emission kernel) unragged.
    for tag, lay, ln, ln_cpu in (("unragged", layer, None, None),
                                 ("ragged", layer, lengths, lengths_cpu),
                                 ("tied", tied, None, None)):
        ref = cpu64(lay)
        lay.zero_grad()
        loss = lay.compute_loss(obs, ln)
        loss.backward()
        ref_loss = ref.compute_loss(obs64, ln_cpu)
        ref_loss.backward()
        rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        check(rel <= LOSS_RTOL, f"compute_loss {tag}: {loss.item()} vs CPU {ref_loss.item()}")
        errs[f"loss {tag}"] = rel
        for (name, p), (_, q) in zip(lay.named_parameters(), ref.named_parameters()):
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{tag}: gradient of {name} missing or not finite")
            err = _grad_err(p.grad.cpu(), q.grad)
            check(err <= GRAD_RTOL, f"{tag}: gradient of {name} off by {err:.3g} of its max")
            errs[f"d{name} {tag}"] = err

    opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        loss = layer.compute_loss(obs)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    check(losses[-1] < losses[0], f"Adam: the loss did not fall: {losses}")

    em_layer = make()
    em_ref = cpu64(em_layer)
    lls = [em_layer.em_step(obs).item() for _ in range(EM_STEPS)]
    torch.cuda.synchronize(dev)
    launches = read_launches(TRAINING_KERNELS)
    for name, n in launches.items():
        check(n > 0, f"the training path never launched {name}")
    for a, b in zip(lls, lls[1:]):
        check(b >= a - LL_SLACK * abs(a), f"em_step: log-likelihood fell: {lls}")
    # The first step, repeated from the same weights on the CPU in f64.
    em_layer.load_state_dict(make().state_dict())
    ll = em_layer.em_step(obs).item()
    ref_ll = em_ref.em_step(obs64).item()
    check(abs(ll - ref_ll) <= LOSS_RTOL * abs(ref_ll), f"em_step: ll {ll} vs CPU {ref_ll}")
    errs["em ll"] = abs(ll - ref_ll) / abs(ref_ll)
    for (name, p), (_, q) in zip(em_layer.named_parameters(), em_ref.named_parameters()):
        check(bool(torch.isfinite(p).all()), f"em_step: {name} not finite")
        p, q = p.detach().cpu(), q.detach()
        if name.endswith("_logits"):
            # log(p + 1e-10) of near-zero probabilities is all rounding.
            p, q = torch.softmax(p, -1), torch.softmax(q, -1)
        err = _grad_err(p, q)
        check(err <= EM_RTOL, f"em_step: {name} off by {err:.3g} of its max")
        errs[f"em {name}"] = err

    # Shapes a kernel does not take raise before any work instead of
    # falling back.
    big = ops.MAX_K + 1
    refusals = {
        "K>1024 pallas_forward": lambda: ops.pallas_forward(
            torch.zeros(1, 4, big, device=dev), torch.zeros(big, big, device=dev),
            torch.zeros(big, device=dev)),
        "HSMM D>256": lambda: ops.hsmm_smallk_forward(
            torch.zeros(1, 4, S, device=dev), torch.zeros(S, S, device=dev),
            torch.zeros(S, device=dev), torch.zeros(S, ops.MAX_DURATION + 1, device=dev)),
        "mesh": lambda: layer.em_step(obs, mesh=object()),
    }
    for what, call in refusals.items():
        try:
            call()
        except (NotImplementedError, ValueError):
            continue
        raise SmokeFailure(f"{what} on CUDA did not raise")
    return {"launches": launches, "errs": errs, "losses": losses, "lls": lls,
            "layer": layer, "em_layer": em_layer, "obs": obs, "lengths": lengths}


def _hsmm_problem(dev, gen, b, t, k, d, lengths=None, min_duration=1):
    """``(log_obs, log_a, log_pi, log_dur, lengths)`` of a segment-DP
    check; no self-transitions."""
    import torch

    lo = torch.randn(b, t, k, device=dev, generator=gen)
    a = torch.rand(k, k, device=dev, generator=gen) + 0.1
    a.fill_diagonal_(0.0)
    la = torch.log(a / a.sum(-1, keepdim=True).clamp_min(1e-30))
    lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
    ld = torch.log_softmax(torch.randn(k, d, device=dev, generator=gen), -1)
    ld[:, : min_duration - 1] = float("-inf")
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    return lo, la, lp, ld, ln


def _hsmm_cases(dev, gen):
    """Inputs of the segment-DP kernel checks, by case."""
    def rand(*shape, **kw):
        return _hsmm_problem(dev, gen, *shape, **kw)

    return {
        "headline": rand(HB, HT, HS, HD),
        "D=128": rand(4, 600, HS, 128),
        "S=32": rand(8, 500, 32, HD),
        "ragged": rand(5, 300, 9, 15, [300, 31, 164, 1, 129]),
        "T<D": rand(3, 12, 5, HD),
        "min_duration=3": rand(4, 300, HS, HD, min_duration=3),
    }


def phase_hsmm_kernels(dev, gen):
    """The four segment-DP kernels vs their plain versions on the same
    inputs; returns each one's max abs error at the headline shape (the
    Viterbi's: of its scores) and the case names."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    worst = {}
    cases = _hsmm_cases(dev, gen)
    for name, (lo, la, lp, ld, ln) in cases.items():
        st, sc = ops.hsmm_smallk_viterbi(lo, la, lp, ld, ln)
        fb = ops.hsmm_smallk_fb(lo, la, lp, ld, ln)
        fwd = ops.hsmm_smallk_forward_general(lo, la, lp, ld, ln)
        bwd = ops.hsmm_smallk_backward_general(lo, la, ld, ln)
        torch.cuda.synchronize(dev)
        st0, sc0 = ops.hsmm_smallk_viterbi_reference(lo, la, lp, ld, ln)
        alpha0, lz0, bstar0, bstart0 = ops.hsmm_smallk_fb_reference(lo, la, lp, ld, ln)
        check(st.dtype == torch.int32 and st.shape == lo.shape[:2],
              f"hsmm_smallk_viterbi {name}: states {st.dtype} {tuple(st.shape)}")
        check(torch.equal(st, st0), f"hsmm_smallk_viterbi {name}: paths differ")
        errs = {"hsmm_smallk_viterbi": (sc - sc0).abs().max().item()}
        check(errs["hsmm_smallk_viterbi"] == 0.0,
              f"hsmm_smallk_viterbi {name}: scores differ by {errs['hsmm_smallk_viterbi']}")
        want_fb = (alpha0, lz0, bstar0, bstart0)
        for kernel, got, want in (("hsmm_smallk_fb", fb, want_fb),
                                  ("hsmm_smallk_forward_general", fwd, want_fb[:2]),
                                  ("hsmm_smallk_backward_general", bwd, want_fb[2:])):
            errs[kernel] = max(_sum_err(g, w, ln, HSMM_SUM_ATOL, HSMM_SUM_RTOL)
                               for g, w in zip(got, want))
            check(errs[kernel] != float("inf"), f"{kernel} {name}: disagrees with its plain version")
        if name == "headline":
            worst = errs
    return worst, list(cases)


def _grid_lengths(b, t, shortest):
    """``b`` lengths on an even grid from ``shortest`` to ``t``."""
    return [round(shortest + (t - shortest) * i / (b - 1)) for i in range(b)]


# Row 24's checks: (B, T, S, D, lengths, g of mixed signs). The cell's
# shape (hsmm.train.b1024: lengths on an even grid over 250-1000) and
# B=32 first, then the envelope's edges.
TABLE_GRADS_CASES = {
    "cell": (1024, HT, HS, HD, _grid_lengths(1024, HT, 250), False),
    "B=32": (HB, HT, HS, HD, _grid_lengths(HB, HT, 250), False),
    "S=1": (16, 20, 1, HD, None, False),
    "S=32": (8, 500, 32, HD, None, False),
    "D=1": (8, 300, HS, 1, [300, 31, 164, 1, 129, 300, 2, 77], False),
    "D=256": (4, 600, HS, 256, None, False),
    "S=32 D=256": (4, 700, 32, 256, [700, 300, 1, 650], False),
    "T<D": (3, 12, 5, HD, None, False),
    "unragged": (16, 300, HS, HD, None, False),
    "ragged": (5, 300, 9, 15, [300, 31, 164, 1, 129], False),
    "g mixed": (64, 400, HS, HD, _grid_lengths(64, 400, 10), True),
}
TABLE_GRADS_TIMED = ("cell", "B=32")


def table_grads_work(frames, k, dm, b):
    """Bytes and float32 operations of row 24 over ``frames`` valid
    frames: log-obs, alpha, beta* and beta_start read once and d log-obs
    written once over them, the parameters read and their cotangents
    written once, log Z and g; per frame and state the entry logsumexp
    and the transition terms (4 a predecessor), the duration terms (6 a
    duration: the window sum, four adds and the exp with its sum) and
    start, end and the occupancy (6)."""
    return (4 * (5 * frames * k + 2 * (k * k + k + k * dm) + 2 * b),
            frames * k * (4 * k + 6 * dm + 6))


def check_table_grads(dev, gen, case):
    """Row 24 vs its plain version and vs float64 on the same tables (the
    sum kernels' on max-shifted emissions, as the training backward makes
    them) at ``TABLE_GRADS_CASES[case]``, run twice and equal bit for bit,
    one count a call. Returns ``{output: (kernel vs plain, kernel vs
    float64, plain vs float64)}`` and the call's arguments."""
    import torch
    from pytorch_hmm_tpu_torch import core, ops

    b, t, k, d, lens, mixed = TABLE_GRADS_CASES[case]
    lo, la, lp, ld, ln = _hsmm_problem(dev, gen, b, t, k, d, lens)
    lo = (lo - ops._frame_shift(lo, ln)).contiguous()
    alpha, lz = ops.hsmm_smallk_forward(lo, la, lp, ld, ln)
    bstar, bstart = ops.hsmm_smallk_backward(lo, la, ld, ln)
    g = (torch.randn(b, device=dev, generator=gen) if mixed
         else torch.full((b,), 1.0 / b, device=dev))
    args = (lo, la, lp, ld, alpha, bstar, bstart, lz, ln, g)
    before = ops.hsmm_table_grads.launches
    got = ops.hsmm_table_grads(*args)
    again = ops.hsmm_table_grads(*args)
    torch.cuda.synchronize(dev)
    check(ops.hsmm_table_grads.launches == before + 2,
          f"hsmm_table_grads {case}: counted {ops.hsmm_table_grads.launches - before} of 2 calls")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"hsmm_table_grads {case}: two runs differ")
    plain = core.hsmm_grads_from_tables(*args)
    exact = core.hsmm_grads_from_tables(
        *(x.double() if x is not None and x.is_floating_point() else x for x in args))
    gmax = g.abs().max().item()
    errs = {}
    for n, x, w, e in zip(("d_log_obs", "d_log_a", "d_log_pi", "d_log_dur"), got, plain, exact):
        check(bool(torch.isfinite(x).all()), f"hsmm_table_grads {case}: {n} not finite")
        scale = gmax if n == "d_log_obs" else max(e.abs().max().item(), 1e-30)
        err = (x.double() - w.double()).abs().max().item() / scale
        err64 = (x.double() - e).abs().max().item() / scale
        plain64 = (w.double() - e).abs().max().item() / scale
        errs[n] = (err, err64, plain64)
        limit = TABLE_GRADS_OBS_ATOL if n == "d_log_obs" else TABLE_GRADS_RTOL
        check(err <= limit, f"hsmm_table_grads {case}: {n} off its plain version by {err:.3g} "
                            f"(limit {limit})")
        check(err64 <= TABLE_GRADS_F64 * plain64 + 1e-7,
              f"hsmm_table_grads {case}: {n} off float64 by {err64:.3g}, the plain version "
              f"by {plain64:.3g}")
    if ln is not None:
        pad = torch.arange(t, device=dev)[None, :] >= ln[:, None]
        check(bool((got[0][pad] == 0).all()), f"hsmm_table_grads {case}: padded frames not 0")
    return errs, args


def phase_table_grads(dev, gen):
    """Row 24 on every case of ``TABLE_GRADS_CASES``
    (:func:`check_table_grads`), timed beside its plain version and its
    bound at ``TABLE_GRADS_TIMED``. Returns the errors by case and
    ``{case: (kernel ms, plain ms, bound)}``."""
    from pytorch_hmm_tpu_torch import core, ops

    errs, timed = {}, {}
    for case in TABLE_GRADS_CASES:
        errs[case], args = check_table_grads(dev, gen, case)
        if case in TABLE_GRADS_TIMED:
            b, t, k, d, lens, _ = TABLE_GRADS_CASES[case]
            frames = b * t if lens is None else sum(lens)
            timed[case] = (cuda_median_ms(lambda: ops.hsmm_table_grads(*args)),
                           cuda_median_ms(lambda: core.hsmm_grads_from_tables(*args),
                                          runs=PLAIN_SUM_RUNS, warmup=1),
                           _bound(*table_grads_work(frames, k, d, b)))
    return errs, timed


def _segment_walk(means, b, t, seed):
    """Observations ``(b, t, F)`` from segments of 2..HD frames, each of
    a state other than the one before, and ragged lengths (one full row,
    one of length 1). Each state's frames scatter around its mean moved
    by half a unit per feature, so the model is near the data but not at
    its optimum, where the mean gradients would be noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n_states, n_feat = means.shape
    centers = means.detach().cpu() + 0.5 * torch.randn(n_states, n_feat, generator=g)
    states = torch.empty(b, t, dtype=torch.long)
    for r in range(b):
        s, u = int(torch.randint(0, n_states, (1,), generator=g)), 0
        while u < t:
            n = int(torch.randint(2, HD + 1, (1,), generator=g))
            states[r, u:u + n] = s
            u += n
            s = (s + int(torch.randint(1, n_states, (1,), generator=g))) % n_states
    obs = centers[states] + torch.randn(b, t, n_feat, generator=g)
    lengths = torch.randint(1, t + 1, (b,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = t, 1
    return obs.to(means.device).contiguous(), lengths.to(means.device)


def _make_hsmm(dev, learnable_durations=True):
    """``HSMMLayer`` at the bench row's width, random weights from the
    seed, its means at unit scale so the states are told apart."""
    import torch
    from pytorch_hmm_tpu_torch import HSMMLayer

    layer = HSMMLayer(HS, HF, max_duration=HD, learnable_duration_params=learnable_durations,
                      generator=torch.Generator().manual_seed(SEED), device=dev)
    with torch.no_grad():
        layer.observation_means.copy_(
            torch.randn(HS, HF, generator=torch.Generator().manual_seed(SEED + 5)))
    return layer


def _cpu_copy(model, cls, dtype=None, **kw):
    ref = cls(device="cpu", **kw)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if dtype is not None:
        ref = ref.to(dtype)
        state = {k: v.to(dtype) for k, v in state.items()}
    ref.load_state_dict(state)
    return ref


def phase_duration_decode(dev):
    """Decode through ``HSMMLayer.forward`` (unragged and ragged) and
    ``SemiMarkovHMM.viterbi_decode`` on the card, count launches, and
    check against the same models on the CPU."""
    import torch
    from pytorch_hmm_tpu_torch import HSMMLayer, SemiMarkovHMM, core, ops

    hsmm = _make_hsmm(dev)
    semi = SemiMarkovHMM(HS, HF, max_duration=HD, generator=torch.Generator().manual_seed(SEED),
                         device=dev)
    obs, lengths = _segment_walk(hsmm.observation_means, HB, HT, SEED + 2)
    obs_s, _ = _segment_walk(semi.observation_means, SEMI_B, SEMI_T, SEED + 3)

    reset_launches()
    full = hsmm(obs)
    ragged = hsmm(obs, lengths)
    semi_path, _, semi_score = semi.viterbi_decode(obs_s)
    torch.cuda.synchronize(dev)
    launches = read_launches(DURATION_DECODE_KERNELS)
    for name, n in launches.items():
        check(n > 0, f"the duration-model decode never launched {name}")

    kw = dict(num_states=HS, feature_dim=HF, max_duration=HD)
    hsmm_cpu = _cpu_copy(hsmm, HSMMLayer, **kw)
    semi_cpu = _cpu_copy(semi, SemiMarkovHMM, num_states=HS, observation_dim=HF, max_duration=HD)
    obs_cpu, lengths_cpu = obs.cpu(), lengths.cpu()
    ref_full = hsmm_cpu(obs_cpu)
    ref_ragged = hsmm_cpu(obs_cpu, lengths_cpu)
    ref_semi_path, _, ref_semi_score = semi_cpu.viterbi_decode(obs_s.cpu())
    agreement = {}
    for name, (st, sc), (rst, rsc), shape in [
            ("HSMMLayer", full, ref_full, (HB, HT)),
            ("HSMMLayer ragged", ragged, ref_ragged, (HB, HT)),
            ("SemiMarkovHMM", (semi_path, semi_score), (ref_semi_path, ref_semi_score),
             (SEMI_B, SEMI_T))]:
        st, sc = st.cpu(), sc.cpu()
        check(st.dtype == torch.int32 and st.shape == shape, f"{name}: states {st.dtype} {tuple(st.shape)}")
        check(bool(torch.isfinite(sc).all()), f"{name}: scores not finite")
        check(int(st.min()) >= 0 and int(st.max()) < HS, f"{name}: state out of range")
        agreement[name] = (st == rst).float().mean().item()
        check(agreement[name] >= 0.999, f"{name}: frame agreement {agreement[name]} < 0.999")
        check(torch.allclose(sc, rsc, rtol=1e-5, atol=0.0),
              f"{name}: scores differ, max rel {((sc - rsc).abs() / rsc.abs()).max().item()}")
    st = ragged[0].cpu()
    for b in range(HB):
        n = int(lengths_cpu[b])
        check(bool((st[b, n - 1:] == st[b, n - 1]).all()), f"HSMM row {b}: padding not repeated")
    # The card's kernel on the CPU's log-obs gives the CPU's paths and
    # scores, bit for bit.
    with torch.no_grad():
        args = hsmm_cpu._dp_args(obs_cpu)
    for ln in (None, lengths_cpu):
        rs, rc = core.hsmm_viterbi(*args, ln)
        gs, gc = ops.hsmm_smallk_viterbi(*(a.to(dev).contiguous() for a in args),
                                         None if ln is None else ln.to(dev))
        check(torch.equal(gs.cpu(), rs), "card segment Viterbi on CPU log-obs: paths differ")
        check(torch.equal(gc.cpu(), rc), "card segment Viterbi on CPU log-obs: scores differ")
    return {"hsmm": hsmm, "obs": obs, "lengths": lengths, "launches": launches,
            "agreement": agreement}


def phase_duration_training(dev, obs, lengths):
    """Posteriors, ``compute_loss`` gradients and ``em_step`` of
    ``HSMMLayer`` on the card vs the same layer on the CPU in float64."""
    import torch
    from pytorch_hmm_tpu_torch import HSMMLayer

    kw = dict(num_states=HS, feature_dim=HF, max_duration=HD)
    layer = _make_hsmm(dev)
    ref = _cpu_copy(layer, HSMMLayer, torch.float64, **kw)
    obs64, lengths_cpu = obs.cpu().double(), lengths.cpu()
    valid = torch.arange(HT)[None, :] < lengths_cpu[:, None]
    errs, fails = {}, []

    def bound(key, err, limit):
        errs[key] = err
        if not err <= limit:
            fails.append(f"{key} off by {err:.3g} (limit {limit})")

    reset_launches()
    for tag, ln, ln_cpu in (("unragged", None, None), ("ragged", lengths, lengths_cpu)):
        post = layer.posteriors(obs, ln)
        want = ref.posteriors(obs64, ln_cpu)
        gamma = post["gamma"].cpu()
        rows = gamma.sum(-1)
        on = valid if ln is not None else torch.ones_like(valid)
        check(bool(((rows[on] - 1.0).abs() <= 1e-5).all()), f"posteriors {tag}: gamma rows do not sum to 1")
        for key in ("gamma", "segment_end", "segment_start"):
            bound(f"{key} {tag}", (post[key].cpu().double() - want[key]).abs().max().item(),
                  HSMM_POST_ATOL)
        bound(f"log_z {tag}", ((post["log_z"].cpu().double() - want["log_z"]).abs()
                               / want["log_z"].abs()).max().item(), LOSS_RTOL)

        layer.zero_grad()
        ref.zero_grad()
        loss = layer.compute_loss(obs, ln)
        loss.backward()
        ref_loss = ref.compute_loss(obs64, ln_cpu)
        ref_loss.backward()
        bound(f"loss {tag}", abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()), LOSS_RTOL)
        for (name, p), (_, q) in zip(layer.named_parameters(), ref.named_parameters()):
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"HSMM {tag}: gradient of {name} missing or not finite")
            bound(f"d{name} {tag}", _grad_err(p.grad.cpu(), q.grad), HSMM_GRAD_RTOL)

    em_layer = _make_hsmm(dev)
    em_ref = _cpu_copy(em_layer, HSMMLayer, torch.float64, **kw)
    ll = em_layer.em_step(obs).item()
    ref_ll = em_ref.em_step(obs64).item()
    bound("em ll", abs(ll - ref_ll) / abs(ref_ll), LOSS_RTOL)
    for (name, p), (_, q) in zip(em_layer.named_parameters(), em_ref.named_parameters()):
        p, q = p.detach().cpu(), q.detach()
        if name == "transition_logits":
            # The diagonal is log(0) by design; log of near-zero
            # probabilities is all rounding, so compare probabilities.
            off = ~torch.eye(HS, dtype=torch.bool)
            check(bool(torch.isfinite(p[off]).all()), f"HSMM em_step: {name} not finite")
            p, q = torch.softmax(p, -1), torch.softmax(q, -1)
        elif name == "observation_log_vars":
            # Unit-variance data puts the log-variances near 0, where an
            # error relative to the largest is meaningless: compare the
            # variances.
            p, q = torch.exp(p), torch.exp(q)
        check(bool(torch.isfinite(p).all()), f"HSMM em_step: {name} not finite")
        bound(f"em {name}", _grad_err(p, q), HSMM_EM_RTOL)
    check(not fails, "duration-model training vs CPU float64: " + "; ".join(fails)
          + f" (all: {errs})")
    # Five steps on fixed durations: the duration update matches moments,
    # which is no exact maximization, so only the emission and transition
    # updates make EM monotone.
    mono = _make_hsmm(dev, learnable_durations=False)
    lls = [mono.em_step(obs).item() for _ in range(EM_STEPS)]
    torch.cuda.synchronize(dev)
    launches = read_launches(DURATION_TRAINING_KERNELS)
    for name, n in launches.items():
        check(n > 0, f"the duration-model training path never launched {name}")
    # Every backward on the card, one row-24 call each: two compute_loss
    # steps and the E-steps of 1 + EM_STEPS em_steps (log Z's gradients).
    check(launches["hsmm_table_grads"] == 3 + EM_STEPS,
          f"hsmm_table_grads counted {launches['hsmm_table_grads']} calls, not {3 + EM_STEPS}")
    for a, b in zip(lls, lls[1:]):
        check(b >= a - LL_SLACK * abs(a), f"HSMM em_step: log-likelihood fell: {lls}")
    return {"launches": launches, "errs": errs, "lls": lls, "layer": layer, "em_layer": em_layer}


def _beam_problem(dev, gen, n, t, s, w, h, n_valid, path_len, ties=False):
    """Inputs of a beam chunk: ``(log_a, log_obs (n, t, s), n_valid,
    carry)``; streams with ``path_len`` 0 start from the uniform prior and
    an empty history, as a fresh processor does."""
    import torch
    from pytorch_hmm_tpu_torch.ops.stream import log_num_states

    if ties:
        c = -log_num_states(s)
        la, lo = torch.full((s, s), c, device=dev), torch.full((n, t, s), c, device=dev)
    else:
        la = torch.log_softmax(torch.randn(s, s, device=dev, generator=gen), -1)
        lo = torch.log_softmax(torch.randn(n, t, s, device=dev, generator=gen), -1)
    pl = torch.tensor(path_len, dtype=torch.int32, device=dev)
    fresh = (pl == 0)[:, None]
    sc = torch.where(fresh, -log_num_states(s), torch.randn(n, w, device=dev, generator=gen))
    st = (torch.arange(w, dtype=torch.int32, device=dev) % s).expand(n, w).contiguous()
    pt = torch.randint(0, s, (n, w, h), device=dev, generator=gen, dtype=torch.int32)
    pt = torch.where(fresh[:, :, None], 0, pt)
    return la, lo, n_valid, (sc, st, pt, pl)


def _greedy_problem(dev, gen, t, s):
    import torch

    la = torch.log_softmax(torch.randn(s, s, device=dev, generator=gen), -1)
    lo = torch.log_softmax(torch.randn(t, s, device=dev, generator=gen), -1)
    return la, lo


def phase_stream_kernels(dev, gen):
    """Both chunk kernels against their plain versions on the card, bit
    for bit; returns each one's max abs score error and the case names."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    beam_cases = {
        "N=1": _beam_problem(dev, gen, 1, SCHUNK, SS, SW, SH, SCHUNK, [0]),
        "N=8 mixed path_len": _beam_problem(dev, gen, 8, SCHUNK, SS, SW, SH, SCHUNK,
                                            [0, SH, 3, 0, 100, SH, 1, 0]),
        "N=16 n_valid<T": _beam_problem(dev, gen, 16, SCHUNK, SS, SW, SH, 150, [0] * 8 + [SH] * 8),
        "per-stream n_valid": _beam_problem(
            dev, gen, 4, SCHUNK, SS, SW, SH,
            torch.tensor([160, 158, 1, 0], dtype=torch.int32, device=dev), [0, 0, SH, 7]),
        "ties": _beam_problem(dev, gen, 3, 64, 6, 4, 40, 64, [0, 5, 40], ties=True),
        "S=128": _beam_problem(dev, gen, 2, SCHUNK, 128, SW, SH, SCHUNK, [0, SH]),
        "T=1024>H": _beam_problem(dev, gen, 2, 1024, SS, SW, SH, 1000, [0, SH]),
    }
    worst = {"beam_chunk_multi": 0.0, "greedy_chunk": 0.0}
    names = ("scores", "states", "paths", "path_len")
    for name, (la, lo, nv, carry) in beam_cases.items():
        got = ops.beam_chunk_multi(la, lo, nv, carry)
        want = ops.beam_chunk_multi_reference(la, lo, nv, carry)
        torch.cuda.synchronize(dev)
        for g, w, what in zip(got, want, names):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"beam_chunk_multi {name}: {what} differ from the plain version")
        worst["beam_chunk_multi"] = max(worst["beam_chunk_multi"],
                                        (got[0] - want[0]).abs().max().item())
    greedy_cases = []
    for t, s, nv in ((SCHUNK, SS, SCHUNK), (SCHUNK, 128, 150), (1024, SS, 1000), (8, 3, 3)):
        la, lo = _greedy_problem(dev, gen, t, s)
        for has in (False, True):
            carry = (torch.tensor(2 % s, dtype=torch.int32, device=dev), torch.tensor(has, device=dev))
            (p1, h1), s1, c1 = ops.greedy_chunk(la, lo, nv, carry)
            (p0, h0), s0, c0 = ops.greedy_chunk_reference(la, lo, nv, carry)
            torch.cuda.synchronize(dev)
            case = f"T={t} S={s} n_valid={nv} has_prev={has}"
            check(s1.dtype == torch.int32 and torch.equal(s1, s0), f"greedy_chunk {case}: states differ")
            check(torch.equal(c1, c0), f"greedy_chunk {case}: scores differ")
            check(torch.equal(p1, p0) and torch.equal(h1, h0), f"greedy_chunk {case}: carry differs")
            worst["greedy_chunk"] = max(worst["greedy_chunk"], (c1 - c0).abs().max().item())
            greedy_cases.append(case)
    return worst, list(beam_cases), greedy_cases


def _stream_processor(dev, **kw):
    import torch
    from pytorch_hmm_tpu_torch import StreamingHMMProcessor

    return StreamingHMMProcessor(SS, SF, chunk_size=SCHUNK,
                                 generator=torch.Generator().manual_seed(SEED), device=dev, **kw)


def _twin(proc, dev="cpu", **kw):
    """A processor with ``proc``'s weights on ``dev``, fresh carry."""
    twin = _stream_processor(dev, **kw)
    twin.load_state_dict({k: v.detach().to(dev) for k, v in proc.state_dict().items()})
    return twin


def _stream_features(n_frames, seed, n=None):
    """Features from a seed (numpy), ``(n_frames, SF)`` or ``(n, n_frames,
    SF)``: a walk over 12 random directions plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (n_frames,) if n is None else (n, n_frames)
    centers = rng.normal(size=(SS, SF))
    walk = (np.arange(n_frames) // rng.integers(5, 30)) % SS
    return (centers[walk] + rng.normal(size=(*shape, SF))).astype(np.float32)


def _agreement(a, b) -> float:
    return (a.cpu() == b.cpu()).float().mean().item()


def phase_streaming_serve(dev):
    """Serve one stream through ``process_chunk`` and ``flush_buffer`` on
    the card, beam and greedy, counting launches, against the same
    processor on the CPU."""
    import torch

    feats = _stream_features(STREAM_CHUNKS * SCHUNK + 37, SEED + 7)
    chunks = [feats[i:i + SCHUNK] for i in range(0, len(feats), SCHUNK)]
    out = {}
    for mode, kernel in (("beam", "beam_chunk_multi"), ("greedy", "greedy_chunk")):
        card = _stream_processor(dev, use_beam_search=mode == "beam")
        cpu = _twin(card, use_beam_search=mode == "beam")
        reset_launches()
        served = [card.process_chunk(c) for c in chunks] + [card.flush_buffer()]
        torch.cuda.synchronize(dev)
        launches = read_launches(("greedy_chunk", "beam_chunk_multi"))
        check(launches[kernel] > 0, f"streaming serve ({mode}) never launched {kernel}")
        ref = [cpu.process_chunk(c) for c in chunks] + [cpu.flush_buffer()]
        got_states, want_states, conf_err = [], [], 0.0
        for r, w in zip(served, ref):
            check(r.status == w.status, f"serve {mode}: status {r.status} vs CPU {w.status}")
            if w.decoded_states is None:
                continue
            st = r.decoded_states
            check(st.device.type == "cuda" and st.dtype == torch.int32, f"serve {mode}: states {st}")
            got_states.append(st.cpu())
            want_states.append(w.decoded_states)
            conf_err = max(conf_err, abs(r.confidence - w.confidence))
        got, want = torch.cat(got_states), torch.cat(want_states)
        check(bool(((got >= 0) & (got < SS)).all()), f"serve {mode}: state out of range")
        agree = _agreement(got, want)
        check(agree >= STREAM_AGREE, f"serve {mode}: frame agreement {agree} < {STREAM_AGREE}")
        check(conf_err <= STREAM_CONF_ATOL, f"serve {mode}: confidence off by {conf_err}")
        out[mode] = {"launches": launches, "agreement": agree, "conf_err": conf_err,
                     "frames": len(got), "chunks": sum(r.status != "buffering" for r in served)}
    return out


def phase_fleets(dev):
    """``MultiStreamDecoder.step`` at N=8 and N=16, each stream against a
    single-stream processor on the card (no lookahead, so each chunk
    decodes all of its frames); then the fleet and single-stream PCM
    steps against the CPU."""
    import torch
    from pytorch_hmm_tpu_torch import MultiStreamDecoder, make_pcm_decode_step

    proc = _stream_processor(dev)
    cpu = _twin(proc)
    out = {"agreement": {}, "conf_err": {}}
    reset_launches()
    for n in FLEETS:
        dec = MultiStreamDecoder(proc, n)
        carry = dec.init_carry()
        singles = [_twin(proc, dev, lookahead_frames=0) for _ in range(n)]
        got, want, err = [], [], 0.0
        for k in range(3):
            feats = torch.from_numpy(_stream_features(SCHUNK, SEED + 10 + k, n)).to(dev)
            carry, st, cf = dec.step(carry, feats)
            for i, p in enumerate(singles):
                r = p.process_chunk(feats[i])
                got.append(st[i])
                want.append(r.decoded_states)
                err = max(err, (cf[i] - r.confidence).abs().max().item())
        agree = _agreement(torch.cat(got), torch.cat(want))
        check(agree >= STREAM_AGREE, f"fleet N={n}: frame agreement with single streams {agree}")
        check(err <= STREAM_CONF_ATOL, f"fleet N={n}: confidence off by {err}")
        out["agreement"][f"N={n}"], out["conf_err"][f"N={n}"] = agree, err

    # Raw PCM: the fleet step and the single-stream step, card vs CPU.
    import numpy as np

    n = FLEETS[0]
    rng = np.random.default_rng(SEED + 20)
    f_card, c_card = MultiStreamDecoder(proc, n).make_pcm_step()
    f_cpu, c_cpu = MultiStreamDecoder(cpu, n).make_pcm_step()
    s_card, sc_card = make_pcm_decode_step(proc, chunk_frames=SCHUNK)
    s_cpu, sc_cpu = make_pcm_decode_step(cpu, chunk_frames=SCHUNK)
    got, want, err = [], [], 0.0
    for k in range(3):
        pcm = (0.1 * rng.standard_normal((n, SCHUNK * HOP))).astype(np.float32)
        c_card, st, cf, nv = f_card(c_card, torch.from_numpy(pcm).to(dev))
        c_cpu, st0, cf0, nv0 = f_cpu(c_cpu, torch.from_numpy(pcm))
        sc_card, s1, c1, n1 = s_card(sc_card, torch.from_numpy(pcm[0]).to(dev))
        sc_cpu, s10, c10, n10 = s_cpu(sc_cpu, torch.from_numpy(pcm[0]))
        v = SCHUNK - (2 if k == 0 else 0)
        check(nv.tolist() == nv0.tolist() == [v] * n and int(n1) == int(n10) == v,
              f"PCM chunk {k}: n_valid {nv.tolist()} / {int(n1)}, expected {v}")
        got += [st[:, :v].reshape(-1), s1[:v]]
        want += [st0[:, :v].reshape(-1), s10[:v]]
        err = max(err, (cf[:, :v].cpu() - cf0[:, :v]).abs().max().item(),
                  (c1[:v].cpu() - c10[:v]).abs().max().item())
    torch.cuda.synchronize(dev)
    out["launches"] = read_launches(("beam_chunk_multi",))
    check(out["launches"]["beam_chunk_multi"] > 0, "the fleets never launched beam_chunk_multi")
    agree = _agreement(torch.cat([g.cpu() for g in got]), torch.cat(want))
    check(agree >= STREAM_AGREE, f"PCM steps: frame agreement with CPU {agree}")
    check(err <= STREAM_CONF_ATOL, f"PCM steps: confidence off by {err}")
    out["agreement"]["PCM"], out["conf_err"]["PCM"] = agree, err
    return out


def phase_stream_timing(dev, gen):
    """Kernel, plain, per-chunk, fleet and PCM times (CUDA events); the
    launches of one call of each streaming entry point; a profile of ten
    beam chunks. Returns ``(times, launches, profile, inputs)``."""
    import torch
    from pytorch_hmm_tpu_torch import MultiStreamDecoder, make_pcm_decode_step, ops

    slow = dict(runs=PLAIN_SUM_RUNS, warmup=1)
    beam = _beam_problem(dev, gen, 1, SCHUNK, SS, SW, SH, SCHUNK, [SH])
    beam_long = _beam_problem(dev, gen, 1, 1024, SS, SW, SH, 1024, [SH])
    fleet_in = {n: _beam_problem(dev, gen, n, SCHUNK, SS, SW, SH, SCHUNK, [SH] * n) for n in FLEETS}
    la, lo = _greedy_problem(dev, gen, SCHUNK, SS)
    la_l, lo_l = _greedy_problem(dev, gen, 1024, SS)
    has = (torch.tensor(0, dtype=torch.int32, device=dev), torch.tensor(True, device=dev))
    times = {
        "greedy_chunk": (cuda_median_ms(lambda: ops.greedy_chunk(la, lo, SCHUNK, has)),
                         cuda_median_ms(lambda: ops.greedy_chunk_reference(la, lo, SCHUNK, has), **slow)),
        "beam_chunk_multi": (cuda_median_ms(lambda: ops.beam_chunk_multi(*beam)),
                             cuda_median_ms(lambda: ops.beam_chunk_multi_reference(*beam), **slow)),
        "greedy T=1024": cuda_median_ms(lambda: ops.greedy_chunk(la_l, lo_l, 1024, has)),
        "beam T=1024": cuda_median_ms(lambda: ops.beam_chunk_multi(*beam_long)),
    }
    for n, args in fleet_in.items():
        times[f"beam N={n}"] = cuda_median_ms(lambda args=args: ops.beam_chunk_multi(*args))

    feats = _stream_features(40 * SCHUNK, SEED + 30)
    launches, calls = {}, {}
    for mode in ("beam", "greedy"):
        proc = _stream_processor(dev, use_beam_search=mode == "beam")
        it = iter(range(10 ** 9))

        def chunk(proc=proc, it=it):
            i = next(it) % 40
            return proc.process_chunk(feats[i * SCHUNK:(i + 1) * SCHUNK])

        times[f"process_chunk {mode}"] = cuda_median_ms(chunk)
        calls[f"process_chunk {mode}"] = chunk
    proc = _stream_processor(dev)
    for n in (1, *FLEETS):
        dec = MultiStreamDecoder(proc, n)
        carry = dec.init_carry()
        f = torch.from_numpy(_stream_features(SCHUNK, SEED + 31, n)).to(dev)
        calls[f"fleet step N={n}"] = lambda dec=dec, carry=carry, f=f: dec.step(carry, f)
        step, c0 = dec.make_pcm_step()
        pcm = 0.1 * torch.randn(n, SCHUNK * HOP, device=dev, generator=gen)
        calls[f"PCM fleet step N={n}"] = lambda step=step, c0=c0, pcm=pcm: step(c0, pcm)
    step1, c1 = make_pcm_decode_step(proc, chunk_frames=SCHUNK)
    pcm1 = 0.1 * torch.randn(SCHUNK * HOP, device=dev, generator=gen)
    calls["PCM step N=1"] = lambda: step1(c1, pcm1)
    for name, fn in calls.items():
        if name not in times:
            times[name] = cuda_median_ms(fn)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[name] = {k: v for k, v in read_launches(KERNELS).items() if v}
    return times, launches, _profile(dev, calls["process_chunk beam"]), (beam, la, lo, fleet_in)


def _profile(dev, fn, n=10):
    """Host wall, device busy and device-op count of ``n`` back-to-back
    calls under ``torch.profiler``; device busy is the sum of the device
    ops' times (one stream, so they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n if kernels else None
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:3])
    return {"host_ms": wall, "device_ms": busy, "kernels": len(kernels) / n, "top_ms": top}


def _emit_inputs(dev, gen, b, t, d, h, s):
    """Observations, weights in the ``(in, out)`` layout and the
    parameter-only tables of ``fused_gaussian_emission``."""
    import torch
    from pytorch_hmm_tpu_torch.ops.emit_mlp import gaussian_tables

    def w(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    obs = w(b, t, d)
    w1, b1 = w(d, h, scale=d ** -0.5), w(h, scale=0.1)
    w2, b2 = w(h, h, scale=h ** -0.5), w(h, scale=0.1)
    wm, bm = w(h, d, scale=h ** -0.5), w(d, scale=0.1)
    wlv, blv = w(h, d, scale=0.3 * h ** -0.5), w(d, scale=0.1)
    tables = gaussian_tables(w(s, h, scale=h ** -0.5), wm, wlv)
    return [obs, w1, b1, w2, b2, wm, bm, wlv, blv] + [x.contiguous() for x in tables]


EMIT_CASES = {
    "headline": (NB, NT, ND, NH, NS),
    "ragged tiles, odd D and H": (3, 77, 13, 48, 5),
    "S=1": (2, 100, ND, NH, 1),
    "S=128": (2, 100, ND, NH, 128),
    "H=352 (envelope top)": (2, 50, ND, 352, NS),
}


def phase_emit_mlp(dev, gen):
    """The neural emission kernel vs its plain version on the card, and
    its Function's gradients vs autograd through the plain version;
    returns the headline max abs error."""
    import torch
    from pytorch_hmm_tpu_torch.ops import emit_mlp

    errs = {}
    for name, shape in EMIT_CASES.items():
        args = _emit_inputs(dev, gen, *shape)
        got = emit_mlp.fused_gaussian_emission(*args)
        want = emit_mlp.fused_gaussian_emission_reference(*args)
        torch.cuda.synchronize(dev)
        check(got.shape == shape[:2] + (shape[4],), f"fused_gaussian_emission {name}: shape")
        errs[name] = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=EMIT_TOL, atol=EMIT_TOL),
              f"fused_gaussian_emission {name} disagrees: max abs err {errs[name]}")
    args = [a.requires_grad_(True) for a in _emit_inputs(dev, gen, 2, 100, ND, NH, NS)]
    cot = torch.randn(2, 100, NS, device=dev, generator=gen)
    got = torch.autograd.grad((emit_mlp.fused_gaussian_emission(*args) * cot).sum(), args)
    want = torch.autograd.grad((emit_mlp.fused_gaussian_emission_reference(*args) * cot).sum(), args)
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.allclose(g, w, rtol=EMIT_TOL, atol=EMIT_TOL * float(w.abs().max())),
              f"fused_gaussian_emission: gradient of input {i} disagrees with autograd")
    return errs


def _tv_cases(dev, gen):
    """Inputs of the time-varying checks: ``(log_obs, log_a (B, T, K, K),
    log_pi, lengths)``."""
    import torch

    def rand(b, t, k, lengths=None, band=False):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        logits = torch.randn(b, t, k, k, device=dev, generator=gen)
        if band:
            # Self-loop and two steps forward; -inf everywhere else.
            i = torch.arange(k, device=dev)
            keep = (i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + 2)
            logits = logits.masked_fill(~keep, float("-inf"))
        la = torch.log_softmax(logits, -1).contiguous()
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        return lo, la, lp, ln

    k = 6
    c = -torch.log(torch.tensor(float(k))).item()
    ties = (torch.zeros(2, 40, k, device=dev), torch.full((2, 40, k, k), c, device=dev),
            torch.full((k,), c, device=dev), None)
    return {
        "headline": rand(NB, NT, NS),
        "K=32": rand(8, 500, 32),
        "ragged": rand(5, 300, 9, [300, 31, 164, 1, 129]),
        "ties": ties,
        "-inf band": rand(4, 300, NS, [300, 299, 7, 1], band=True),
    }


def phase_tv_kernels(dev, gen):
    """The time-varying modes of ``smallk_viterbi`` and ``fbsum_smallk``
    vs their plain versions (the Viterbi's also vs float64,
    :func:`trellis_vs_f64`); returns each one's headline error (the
    Viterbi's worst score error vs float64) and the case names."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    worst = {}
    cases = _tv_cases(dev, gen)
    for name, (lo, la, lp, ln) in cases.items():
        s1, c1 = ops.smallk_viterbi(lo, la, lp, ln)
        fb = ops.fbsum_smallk(lo, la, lp, ln)
        torch.cuda.synchronize(dev)
        s0, c0 = ops.smallk_viterbi_reference(lo, la, lp, ln)
        fb0 = ops.fbsum_smallk_reference(lo, la, lp, ln)
        _, _, _, vit_err = trellis_vs_f64(f"smallk_viterbi time-varying {name}", (s1, c1), lo, la,
                                          lp, ln, s0)
        err = max(_sum_err(g, w, ln) for g, w in zip(fb, fb0))
        check(err != float("inf"), f"fbsum_smallk time-varying {name}: disagrees with its plain version")
        if name == "headline":
            worst = {"smallk_viterbi": vit_err, "fbsum_smallk": err}
    return worst, list(cases)


def _neural_data(dev, seed):
    """Observations ``(NB, NT, ND)`` from a walk over NS random centres
    plus noise; phonemes ``(NB, NT)`` in segments of 3-12 frames; prosody
    ``(NB, NT, PROSODY)`` (numpy, from a seed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(NS, ND))
    seg = rng.integers(5, 40, size=(NB, 1))
    obs = centers[(np.arange(NT)[None, :] // seg) % NS] + rng.normal(size=(NB, NT, ND))
    ph = (np.arange(NT)[None, :] // rng.integers(3, 13, size=(NB, 1))
          + rng.integers(0, VOCAB, size=(NB, 1))) % VOCAB
    pros = rng.normal(size=(NB, NT, PROSODY))
    return (torch.from_numpy(obs.astype(np.float32)).to(dev), torch.from_numpy(ph).to(dev),
            torch.from_numpy(pros.astype(np.float32)).to(dev))


def _neural_model(cls, dev, **kw):
    import torch

    return cls(generator=torch.Generator().manual_seed(SEED), device=dev, **kw).eval()


NEURAL_KW = {
    "NeuralHMM": dict(num_states=NS, observation_dim=ND, hidden_dim=NH),
    "ContextualNeuralHMM": dict(num_states=NS, observation_dim=ND, phoneme_vocab_size=VOCAB),
}


def phase_neural(dev):
    """NeuralHMM (static) and ContextualNeuralHMM (time-varying) at the
    slice's width: the inference entry points against the CPU, the
    trellis on the CPU's inputs, ``compute_loss`` gradients against the
    CPU in float64, five Adam steps; a ragged likelihood and decode on the
    packed route against the CPU in float64; then the transformer and rnn
    transition models at T=64 and a neural-emission SemiMarkovHMM decode
    against the CPU."""
    import torch
    from pytorch_hmm_tpu_torch import ContextualNeuralHMM, NeuralHMM, SemiMarkovHMM, core, ops

    classes = {"NeuralHMM": NeuralHMM, "ContextualNeuralHMM": ContextualNeuralHMM}
    obs, ph, pros = _neural_data(dev, SEED + 40)
    obs_cpu, ph_cpu, pros_cpu = obs.cpu(), ph.cpu(), pros.cpu()
    out = {"launches": {}, "tv_launches": {}, "agreement": {}, "errs": {}, "losses": {}}
    fails = []

    def bound(key, err, limit):
        out["errs"][key] = err
        if not err <= limit:
            fails.append(f"{key} off by {err:.3g} (limit {limit})")

    for name, cls in classes.items():
        kw = NEURAL_KW[name]
        m = _neural_model(cls, dev, **kw)
        cpu = _cpu_copy(m, cls, **kw).eval()
        cpu64 = _cpu_copy(m, cls, torch.float64, **kw).eval()
        contextual = name == "ContextualNeuralHMM"

        def ctx_of(model, p, q):
            return model.encode_context(p, q) if contextual else None

        with torch.no_grad():
            c, c_cpu = ctx_of(m, ph, pros), ctx_of(cpu, ph_cpu, pros_cpu)
            c64 = ctx_of(cpu64, ph_cpu, pros_cpu.double())
        reset_launches()
        post, alpha, beta = (m.forward_with_context(obs, ph, pros) if contextual else m(obs))
        states, score = m.viterbi_decode(obs, c)
        ll = m.compute_likelihood(obs, c)
        # compute_loss gradients in eval mode (the fused emission's
        # Function), checked against the CPU in float64 below.
        m.zero_grad()
        m.compute_loss(obs, ctx_of(m, ph, pros)).backward()
        torch.cuda.synchronize(dev)
        out["launches"][name] = read_launches(NEURAL_KERNELS[name])
        out["tv_launches"][name] = read_tv_launches()
        for k, n in out["launches"][name].items():
            check(n > 0, f"the {name} path never launched {k}")
        if contextual:
            for k, n in out["tv_launches"][name].items():
                check(n > 0, f"the {name} path never launched the time-varying {k}")
        for t in (post, alpha, beta, ll):
            check(bool(torch.isfinite(t).all()), f"{name}: outputs not finite")
        check(post.shape == (NB, NT, NS) and states.shape == (NB, NT) and ll.shape == (NB,),
              f"{name}: shapes {tuple(post.shape)} {tuple(states.shape)} {tuple(ll.shape)}")
        # Rows sum to 1 up to the f32 rounding of log Z (~1e3-1e4 here).
        check(bool(((post.sum(-1) - 1.0).abs() <= 1e-3).all()), f"{name}: posteriors do not sum to 1")

        # Held to the CPU twin in float64: the plain float32 chain drifts
        # by ~1e-5 of the score at T=1000.
        st0, sc0 = cpu64.viterbi_decode(obs_cpu.double(), c64)
        out["agreement"][name] = (states.cpu() == st0).float().mean().item()
        check(out["agreement"][name] >= 0.999, f"{name}: frame agreement {out['agreement'][name]}")
        check(torch.allclose(score.cpu().double(), sc0, rtol=1e-5, atol=0.0),
              f"{name}: decode scores differ")
        post64 = cpu64(obs_cpu.double(), c64)[0]
        bound(f"{name} posteriors", (post.cpu().double() - post64).abs().max().item(),
              NEURAL_POST_ATOL)
        ll64 = cpu64.compute_likelihood(obs_cpu.double(), c64).detach()
        bound(f"{name} log-likelihood", ((ll.detach().cpu().double() - ll64).abs()
                                         / ll64.abs()).max().item(), LOSS_RTOL)
        # The card's trellis on the CPU's inputs gives the CPU's paths but on
        # near ties, and scores held to float64.
        with torch.no_grad():
            lo, la, lp = cpu._dp_args(obs_cpu, c_cpu, None)
        rs, _ = core.viterbi(lo, la, lp)
        got = ops.smallk_viterbi(lo.to(dev), la.to(dev).contiguous(), lp.to(dev))
        trellis_vs_f64(f"{name}: card trellis on CPU inputs", tuple(g.cpu() for g in got), lo, la,
                       lp, None, rs)

        ref_loss = cpu64.compute_loss(obs_cpu.double(), ctx_of(cpu64, ph_cpu, pros_cpu.double()))
        ref_loss.backward()
        for (pn, p), (_, q) in zip(m.named_parameters(), cpu64.named_parameters()):
            if q.grad is None:
                check(p.grad is None, f"{name}: {pn} has a gradient the CPU lacks")
                continue
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{name}: gradient of {pn} missing or not finite")
            bound(f"{name} d{pn}", _grad_err(p.grad.cpu(), q.grad), NEURAL_GRAD_RTOL)

        # Five Adam steps in training mode, dropout on.
        tm = _neural_model(cls, dev, **kw).train()
        opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
        losses = []
        for _ in range(ADAM_STEPS):
            opt.zero_grad()
            loss = tm.compute_loss(obs, ctx_of(tm, ph, pros))
            loss.backward()
            opt.step()
            losses.append(loss.item())
        check(losses[-1] < losses[0], f"{name} Adam: the loss did not fall: {losses}")
        out["losses"][name] = losses
        out[name] = m

    # The packed route: a ragged likelihood and decode of the contextual
    # model (eval mode, row 16 on the packed frames) against its CPU twin in
    # float64 on the same lengths; each call packs its valid frames once.
    from pytorch_hmm_tpu_torch.models import neural

    kw = NEURAL_KW["ContextualNeuralHMM"]
    m = out["ContextualNeuralHMM"]
    cpu64 = _cpu_copy(m, ContextualNeuralHMM, torch.float64, **kw).eval()
    ln = torch.linspace(NT, NT // 4, NB).round().to(torch.int32)
    packs = (neural.pack_calls, neural.pack_rows_skipped)
    with torch.no_grad():
        c = m.encode_context(ph, pros)
        ll = m.compute_likelihood(obs, c, lengths=ln.to(dev))
        st, sc = m.viterbi_decode(obs, c, lengths=ln.to(dev))
        torch.cuda.synchronize(dev)
        out["pack"] = (neural.pack_calls - packs[0], neural.pack_rows_skipped - packs[1])
        check(out["pack"] == (2, 2 * (NB * NT - int(ln.sum()))),
              f"packed route: pack_calls, pack_rows_skipped moved by {out['pack']}")
        c64 = cpu64.encode_context(ph_cpu, pros_cpu.double())
        ll64 = cpu64.compute_likelihood(obs_cpu.double(), c64, lengths=ln)
        bound("packed log-likelihood", ((ll.cpu().double() - ll64).abs() / ll64.abs()).max().item(),
              LOSS_RTOL)
        st0, sc0 = cpu64.viterbi_decode(obs_cpu.double(), c64, lengths=ln)
    valid = torch.arange(NT)[None] < ln[:, None]
    out["agreement"]["packed decode"] = (st.cpu() == st0)[valid].float().mean().item()
    check(out["agreement"]["packed decode"] >= 0.999,
          f"packed decode: frame agreement {out['agreement']['packed decode']}")
    check(torch.allclose(sc.cpu().double(), sc0, rtol=1e-5, atol=0.0), "packed decode: scores")

    # Transformer and rnn transition models at T=64 against the CPU.
    for tt in ("transformer", "rnn"):
        kw = dict(num_states=NS, observation_dim=ND, context_dim=PROSODY, hidden_dim=NH,
                  transition_type=tt)
        m = _neural_model(NeuralHMM, dev, **kw)
        cpu = _cpu_copy(m, NeuralHMM, **kw).eval()
        cpu64 = _cpu_copy(m, NeuralHMM, torch.float64, **kw).eval()
        x, c = obs[:4, :SMALL_T].contiguous(), pros[:4, :SMALL_T].contiguous()
        reset_launches()
        post = m(x, c)[0]
        st, sc = m.viterbi_decode(x, c)
        ll = m.compute_likelihood(x, c)
        torch.cuda.synchronize(dev)
        tv = read_tv_launches()
        check(all(n > 0 for n in tv.values()), f"{tt}: no time-varying launches {tv}")
        x64, c64 = x.cpu().double(), c.cpu().double()
        st0, sc0 = cpu64.viterbi_decode(x64, c64)
        out["agreement"][tt] = (st.cpu() == st0).float().mean().item()
        check(out["agreement"][tt] >= 0.99, f"{tt}: frame agreement {out['agreement'][tt]}")
        check(torch.allclose(sc.cpu().double(), sc0, rtol=1e-5, atol=0.0),
              f"{tt}: decode scores differ")
        with torch.no_grad():
            lo, la, lp = cpu._dp_args(x.cpu(), c.cpu(), None)
        rs, _ = core.viterbi(lo, la, lp)
        got = ops.smallk_viterbi(lo.to(dev), la.to(dev).contiguous(), lp.to(dev))
        trellis_vs_f64(f"{tt}: card trellis on CPU inputs", tuple(g.cpu() for g in got), lo, la, lp,
                       None, rs)
        bound(f"{tt} posteriors", (post.cpu().double() - cpu64(x64, c64)[0]).abs().max().item(),
              NEURAL_POST_ATOL)
        bound(f"{tt} log-likelihood", ((ll.detach().cpu().double()
                                        - cpu64.compute_likelihood(x64, c64).detach()).abs()
                                       / ll.detach().cpu().double().abs()).max().item(), LOSS_RTOL)

    # SemiMarkovHMM with neural emissions: decode against the CPU.
    kw = dict(num_states=HS, observation_dim=HF, max_duration=HD, observation_model="neural")
    semi = SemiMarkovHMM(generator=torch.Generator().manual_seed(SEED), device=dev, **kw).eval()
    semi_cpu = _cpu_copy(semi, SemiMarkovHMM, **kw).eval()
    x = obs[:, :SEMI_T, :HF].contiguous()
    reset_launches()
    path, _, sc = semi.viterbi_decode(x)
    torch.cuda.synchronize(dev)
    out["launches"]["SemiMarkovHMM neural"] = read_launches(("fused_gaussian_emission",
                                                             "hsmm_smallk_viterbi"))
    for k, n in out["launches"]["SemiMarkovHMM neural"].items():
        check(n > 0, f"the neural SemiMarkovHMM decode never launched {k}")
    path0, _, sc0 = semi_cpu.viterbi_decode(x.cpu())
    out["agreement"]["SemiMarkovHMM neural"] = (path.cpu() == path0).float().mean().item()
    check(out["agreement"]["SemiMarkovHMM neural"] >= 0.999, "neural SemiMarkovHMM: agreement")
    check(torch.allclose(sc.cpu(), sc0, rtol=1e-5, atol=0.0), "neural SemiMarkovHMM: scores")
    check(not fails, "neural models vs CPU float64: " + "; ".join(fails) + f" (all: {out['errs']})")
    out["obs"], out["ph"], out["pros"] = obs, ph, pros
    return out


# The attention transitions' step at the cell's widths (ctxtfm.train.b512:
# ContextualNeuralHMM(12, 80, 64, hidden_dim=256), 3 blocks of 8 heads),
# T=1000, lengths on the cell's grid; the old einsum path's batch sweep.
ATTN_T, ATTN_B = 1000, 64
ATTN_SWEEP = (512, 448, 384, 320, 256, 192, 128, 64)
ATTN_PATTERN = r"fmha_cutlass[FB]"


def phase_neural_attention(dev):
    """``ContextualNeuralHMM(transition_type="transformer")`` training
    steps at the cell's widths on ragged rows: the attention's device
    launches of one profiled step (``masked_attention``'s memory-efficient
    kernels over each row's own frames, forward and backward), their
    device ms, and its counters; then the batch sweep
    of the old path, the unmasked einsums that build ``(B, H, T, T)``
    logits, from B=512 down to the first that fits, and at that B one
    step of each path, timed with CUDA events, with its peak memory, in
    this one process."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_hmm_tpu_torch import ContextualNeuralHMM
    from pytorch_hmm_tpu_torch.models import neural
    from pytorch_hmm_tpu_torch.ops import attention

    hmm = ContextualNeuralHMM(NS, ND, VOCAB, hidden_dim=NH, transition_type="transformer",
                              dropout=0.0, generator=torch.Generator().manual_seed(SEED),
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    largest = ATTN_SWEEP[0]
    obs = torch.randn((largest, ATTN_T, ND), generator=gen, device=dev)
    ph = torch.randint(0, VOCAB, (largest, ATTN_T), generator=gen, device=dev)
    pros = torch.randn((largest, ATTN_T, PROSODY), generator=gen, device=dev)
    lengths = torch.linspace(ATTN_T, ATTN_T // 4, largest, device=dev).round().to(torch.int32)

    def step(b):
        hmm.zero_grad(set_to_none=True)
        loss = hmm.compute_loss(obs[:b], hmm.encode_context(ph[:b], pros[:b]),
                                lengths=lengths[:b])
        loss.backward()
        return loss

    out = {}
    step(ATTN_B)
    torch.cuda.synchronize(dev)
    calls, masked = attention.attention_calls, attention.attention_masked_keys
    varlen, skipped = attention.attention_varlen_calls, attention.attention_pairs_skipped
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(ATTN_B)
        torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and re.search(ATTN_PATTERN, e.name)]
    out["launches"] = len(kernels)
    out["kernels"] = sorted({e.name.split("(")[0] for e in kernels})
    for side, tag in (("forward", "fmha_cutlassF"), ("backward", "fmha_cutlassB")):
        out[f"{side}_ms"] = sum(e.time_range.elapsed_us() for e in kernels
                                if tag in e.name) / 1e3
    layers = len(hmm.transition_model.blocks)
    check(attention.attention_calls - calls == layers,
          f"attention_calls moved by {attention.attention_calls - calls}, not {layers}")
    n = lengths[:ATTN_B].tolist()
    want = layers * (ATTN_B * ATTN_T - sum(n))
    check(attention.attention_masked_keys - masked == want,
          f"attention_masked_keys moved by {attention.attention_masked_keys - masked}, not {want}")
    out["varlen_calls"] = attention.attention_varlen_calls - varlen
    out["pairs_skipped"] = attention.attention_pairs_skipped - skipped
    check(out["varlen_calls"] == layers,
          f"attention_varlen_calls moved by {out['varlen_calls']}, not {layers}")
    want = layers * (ATTN_B * ATTN_T * ATTN_T - sum(x * x for x in n))
    check(out["pairs_skipped"] == want,
          f"attention_pairs_skipped moved by {out['pairs_skipped']}, not {want}")
    check(out["launches"] == 2 * layers,
          f"{out['launches']} attention launches a step, not {2 * layers}: {out['kernels']}")

    fused = neural.masked_attention

    def einsum(q, k, v, lengths=None):
        return attention.masked_attention_reference(q, k, v)

    def timed(b):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_median_ms(lambda: step(b), runs=3, warmup=1)
        return ms, torch.cuda.max_memory_allocated(dev) - base

    neural.masked_attention = einsum
    try:
        for b in ATTN_SWEEP:
            try:
                out["einsum"] = timed(b)
            except torch.cuda.OutOfMemoryError:
                hmm.zero_grad(set_to_none=True)
                continue
            out["largest_b"] = b
            break
    finally:
        neural.masked_attention = fused
    check("largest_b" in out, f"the einsum path fits no B of {ATTN_SWEEP}")
    out["fused"] = timed(out["largest_b"])
    out["fused_b512"] = timed(largest)
    return out


def phase_neural_timing(dev, gen, neural):
    """Row 16 and the time-varying modes against their plain versions;
    a NeuralHMM forward, decode and compute_loss step, static and
    contextual; launches per call; a profile of ten NeuralHMM forwards.
    Returns ``(times, launches, profile, inputs)``."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    slow = dict(runs=PLAIN_SUM_RUNS, warmup=1)
    emit = _emit_inputs(dev, gen, NB, NT, ND, NH, NS)
    lo, la, lp, _ = _tv_cases(dev, gen)["headline"]
    times = {
        "fused_gaussian_emission": (
            cuda_median_ms(lambda: ops.fused_gaussian_emission(*emit)),
            cuda_median_ms(lambda: ops.fused_gaussian_emission_reference(*emit))),
        "smallk_viterbi tv": (cuda_median_ms(lambda: ops.smallk_viterbi(lo, la, lp)),
                              cuda_median_ms(lambda: ops.smallk_viterbi_reference(lo, la, lp),
                                             **slow)),
        "fbsum_smallk tv": (cuda_median_ms(lambda: ops.fbsum_smallk(lo, la, lp)),
                            cuda_median_ms(lambda: ops.fbsum_smallk_reference(lo, la, lp), **slow)),
    }
    obs, ph, pros = neural["obs"], neural["ph"], neural["pros"]
    static, ctx = neural["NeuralHMM"], neural["ContextualNeuralHMM"]
    with torch.no_grad():
        context = ctx.encode_context(ph, pros)

    def step(m, c):
        m.zero_grad()
        m.compute_loss(obs, c() if c else None).backward()

    calls = {
        "NeuralHMM forward": lambda: static(obs),
        "NeuralHMM decode": lambda: static.viterbi_decode(obs),
        "NeuralHMM compute_loss step": lambda: step(static, None),
        "ContextualNeuralHMM forward": lambda: ctx.forward_with_context(obs, ph, pros),
        "ContextualNeuralHMM decode": lambda: ctx.viterbi_decode(obs, context),
        "ContextualNeuralHMM compute_loss step": lambda: step(
            ctx, lambda: ctx.encode_context(ph, pros)),
    }
    launches = {}
    for name, fn in calls.items():
        times[name] = cuda_median_ms(fn)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[name] = {k: v for k, v in read_launches(KERNELS).items() if v}
        tv = {k: v for k, v in read_tv_launches().items() if v}
        if tv:
            launches[name]["time-varying"] = tv
    return times, launches, _profile(dev, calls["NeuralHMM forward"]), (emit, lo, la)


def _scan_cases(dev, gen):
    """Inputs of the general-K chain checks: ``(log_obs, log_a, log_pi,
    lengths)``."""
    import torch

    def rand(b, t, k, lengths=None):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        return lo, la, lp, ln

    k = 40
    c = -torch.log(torch.tensor(float(k))).item()
    ties = (torch.zeros(2, 60, k, device=dev), torch.full((k, k), c, device=dev),
            torch.full((k,), c, device=dev), None)
    # A left-to-right matrix through safe_log: self-loop 0.6, 0.4 forward,
    # 1e-8 elsewhere, as HMMLayer's initial topology.
    from pytorch_hmm_tpu_torch import create_left_to_right_matrix

    l2r = torch.log(create_left_to_right_matrix(GK, 0.6).to(dev) + 1e-8)
    lo, _, lp, _ = rand(4, 300, GK)
    return {
        "headline": rand(B, T, GK),
        "K=33": rand(8, 500, 33),
        "K=128": rand(8, 500, 128),
        "K=256": rand(4, 300, 256),
        "K=1024": rand(4, 256, 1024),
        "ragged": rand(5, 300, 40, [300, 31, 164, 1, 129]),
        "T=1": rand(3, 1, GK),
        "ties": ties,
        "left-to-right": (3.0 * lo, l2r, lp, None),
    }


def phase_scan_kernels(dev, gen):
    """Rows 8, 9 and 13 vs their plain versions on the same inputs;
    returns each one's headline max abs error (the Viterbi's of its
    scores) and the case names."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    worst = {}
    cases = _scan_cases(dev, gen)
    for name, (lo, la, lp, ln) in cases.items():
        alpha, lz = ops.pallas_forward(lo, la, lp, ln)
        beta = ops.pallas_backward(lo, la, ln)
        st, sc = ops.pallas_viterbi(lo, la, lp, ln)
        torch.cuda.synchronize(dev)
        alpha0, lz0 = ops.pallas_forward_reference(lo, la, lp, ln)
        beta0 = ops.pallas_backward_reference(lo, la, ln)
        st0, sc0 = ops.pallas_viterbi_reference(lo, la, lp, ln)
        check(st.dtype == torch.int32 and st.shape == lo.shape[:2],
              f"pallas_viterbi {name}: states {st.dtype} {tuple(st.shape)}")
        check(torch.equal(st, st0), f"pallas_viterbi {name}: paths differ")
        check(torch.equal(sc, sc0), f"pallas_viterbi {name}: scores differ by "
              f"{(sc - sc0).abs().max().item()}")
        errs = {"pallas_viterbi": (sc - sc0).abs().max().item()}
        for kernel, got, want in (("pallas_forward", (alpha, lz), (alpha0, lz0)),
                                  ("pallas_backward", (beta,), (beta0,))):
            # Frozen past each row's end (alpha) or zero (beta): every frame
            # is compared.
            errs[kernel] = max(_sum_err(g, w, None, SCAN_ATOL, SCAN_RTOL) for g, w in zip(got, want))
            check(errs[kernel] != float("inf"), f"{kernel} {name}: disagrees with its plain version")
        if name == "headline":
            worst = errs
    return worst, list(cases)


def _gmm_inputs(dev, gen, b, t, s, c, d, lengths=None):
    import torch

    obs = torch.randn(b, t, d, device=dev, generator=gen)
    means = torch.randn(s, c, d, device=dev, generator=gen)
    log_vars = 0.1 * torch.randn(s, c, d, device=dev, generator=gen)
    log_w = torch.log_softmax(torch.randn(s, c, device=dev, generator=gen), -1)
    la = torch.log_softmax(torch.randn(s, s, device=dev, generator=gen), -1)
    lp = torch.log_softmax(torch.randn(s, device=dev, generator=gen), -1)
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    return obs, means, log_vars, log_w, la, lp, ln


FUSED_CASES = {
    "S=64 C=2 D=80": (B, T, GK, 2, GD, None),
    "S=128 C=1": (8, 300, 128, 1, GD, None),
    "S=40 C=2 D=13": (4, 300, 40, 2, 13, None),
    "ragged": (5, 300, GK, 2, GD, [300, 31, 164, 1, 129]),
}


def phase_fused_kernel(dev, gen):
    """Row 14 vs its plain version (the emission in another summation
    order): frame agreement and scores; returns the headline's max abs
    score error, each case's agreement and, recorded and not checked, the
    headline's ``score_err`` against the plain version in float64 (the
    worst row's ``|score - best| / |best|``) of the kernel and of the
    plain version in float32."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    agree, worst, score_err = {}, 0.0, {}
    for name, shape in FUSED_CASES.items():
        args = _gmm_inputs(dev, gen, *shape)
        st, sc = ops.fused_gmm_viterbi(*args)
        torch.cuda.synchronize(dev)
        st0, sc0 = ops.fused_gmm_viterbi_reference(*args)
        check(st.dtype == torch.int32 and st.shape == shape[:2], f"fused_gmm_viterbi {name}: states")
        agree[name] = (st == st0).float().mean().item()
        check(agree[name] >= FUSED_AGREE, f"fused_gmm_viterbi {name}: frame agreement {agree[name]}")
        check(torch.allclose(sc, sc0, rtol=FUSED_RTOL, atol=FUSED_ATOL),
              f"fused_gmm_viterbi {name}: scores differ by {(sc - sc0).abs().max().item()}")
        if name == "S=64 C=2 D=80":
            worst = (sc - sc0).abs().max().item()
            _, best = ops.fused_gmm_viterbi_reference(
                *(a.double() if a.is_floating_point() else a for a in args[:6]), args[6])
            score_err = {k: ((v.double() - best).abs() / best.abs()).max().item()
                         for k, v in (("kernel", sc), ("plain float32", sc0))}
    return worst, agree, score_err


# The phase probes of rows 14 and 7 (separate builds of csrc/fused_gmm.cu
# and csrc/hsmm_smallk.cu with FUSED_GMM_PROBE and HSMM_SMALLK_PROBE
# defined): each role stamps its own phases with clock64(), summed here
# per 64-frame chunk. FUSED_PROBE_CLOCK and HSMM_PROBE_CLOCK name the
# phases whose sum spans a block's run, from which the SM clock.
FUSED_PROBE_PHASES = ("chain slot wait", "chain delta wait", "chain max", "chain argmax", "producer wait",
                      "producer transpose", "producer products", "producer scores", "store work", "backtrace")
FUSED_PROBE_CLOCK = (0, 1, 2, 3, 9)
HSMM_PROBE_PHASES = ("chain join", "chain predecessor lse", "chain wait", "helper terms", "helper reduce",
                     "helper wait")
HSMM_PROBE_CLOCK = (0, 1, 2)
FUSED_PROBE_CASES = {"S=64 C=2 D=80": (B, T, GK, 2, GD), "S=128 C=1": (8, 300, 128, 1, GD),
                     "S=40 C=2 D=13": (4, 300, 40, 2, 13)}
HSMM_PROBE_CASES = {"headline": (HB, HT, HS, HD), "D=128": (4, 600, HS, 128), "S=32": (8, 500, 32, HD)}


def probe_summary(cycles, ms, frames, names, clock):
    """A probed launch's phases: ``cycles`` (blocks, chunks, phases) int64
    from one launch, ``ms`` its time. Per block, each phase's cycles over
    all chunks per frame; the median over blocks, as cycles a 64-frame
    chunk and µs a frame at the SM clock the run implies (the median
    block's ``clock`` phases over ``ms``)."""
    c = cycles.double()
    mhz = c[..., list(clock)].sum(dim=(1, 2)).median().item() / (ms * 1e3)
    per_frame = (c.sum(dim=1) / frames).median(dim=0).values.tolist()
    return {"ms": ms, "mhz": mhz, "cycles": {n: f * 64 for n, f in zip(names, per_frame)},
            "us_frame": {n: f / mhz for n, f in zip(names, per_frame)}, "total_us_frame": ms * 1e3 / frames}


def probe_line(what, r, card):
    return (f"{what}: {r['ms']:.4f} ms, {r['total_us_frame']:.4f} us a frame at {r['mhz']:.0f} MHz; "
            "a 64-frame chunk: " + ", ".join(f"{n} {c:.0f} cycles ({r['us_frame'][n]:.4f} us a frame)"
                                            for n, c in r["cycles"].items()) + f" on {card}")


def phase_fused_probe(dev, gen):
    """Row 14 timed by phase at ``FUSED_PROBE_CASES``: lines of
    :func:`probe_line`."""
    import torch
    from pytorch_hmm_tpu_torch.ops import fused

    out = {}
    for name, (b, t, s, c, d) in FUSED_PROBE_CASES.items():
        obs, means, lv, lw, la, lp, _ = _gmm_inputs(dev, gen, b, t, s, c, d)
        probe = torch.zeros(b, -(-t // 64), len(FUSED_PROBE_PHASES), dtype=torch.int64, device=dev)
        run = lambda: fused._launch(obs, means, lv, lw, la, lp, None, probe)  # noqa: E731
        ms = cuda_median_ms(run, runs=5, warmup=1)
        probe.zero_()
        run()
        torch.cuda.synchronize(dev)
        out[f"fused probe {name} (B={b}, T={t})"] = probe_summary(probe, ms, t, FUSED_PROBE_PHASES,
                                                                  FUSED_PROBE_CLOCK)
    return out


def phase_hsmm_probe(dev, gen):
    """Row 7 timed by phase at ``HSMM_PROBE_CASES``, each chain apart:
    lines of :func:`probe_line`."""
    import torch
    from pytorch_hmm_tpu_torch.ops import hsmm_smallk

    out = {}
    for name, (b, t, k, d) in HSMM_PROBE_CASES.items():
        lo, la, lp, ld, _ = _hsmm_problem(dev, gen, b, t, k, d)
        probe = torch.zeros(2, b, -(-t // 64), len(HSMM_PROBE_PHASES), dtype=torch.int64, device=dev)

        def run():
            probe.zero_()
            hsmm_smallk._fb_launch(lo, la, lp, ld, None, probe)

        ms = cuda_median_ms(run, runs=5, warmup=1)
        run()
        torch.cuda.synchronize(dev)
        for i, chain in enumerate(("forward", "backward")):
            out[f"hsmm probe {name} {chain} (B={b}, T={t}, S={k}, D={d})"] = probe_summary(
                probe[i], ms, t, HSMM_PROBE_PHASES, HSMM_PROBE_CLOCK)
    return out


def _l2r_walk(means, b, t, seed):
    """Features ``(b, t, F)`` from left-to-right walks: each row visits
    the states in order, a random 8-24 frames each, and stays in the
    last. Each state's frames scatter with unit noise around its mean
    moved by half a unit per feature, so the model is near the data but
    not at its optimum, where the mean gradients would be noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n_states, n_feat = means.shape
    seg = torch.randint(8, 25, (b, n_states), generator=g)
    ends = torch.cumsum(seg, 1)
    states = torch.searchsorted(ends, torch.arange(t).expand(b, t).contiguous(), right=True)
    states = states.clamp_max(n_states - 1)
    centers = means.detach().cpu() + 0.5 * torch.randn(n_states, n_feat, generator=g)
    obs = centers[states] + torch.randn(b, t, n_feat, generator=g)
    return obs.to(means.device).contiguous()


def _max_rel(got, want) -> float:
    return ((got.double().cpu() - want).abs() / want.abs()).max().item()


def phase_genk_slice(dev):
    """The K=64 slice against its CPU twins: GaussianHMMLayer(64, 80)
    (train-mode posteriors, compute_loss gradients in float64, five Adam
    steps, eval decode), HMMLayer(64), HMM at K=64, and
    MixtureGaussianHMMLayer(64, 80) at C=2 and C=4 (decode, a
    compute_loss step and an em_step)."""
    import torch
    from pytorch_hmm_tpu_torch import (HMM, GaussianHMMLayer, HMMLayer, MixtureGaussianHMMLayer,
                                       core, create_left_to_right_matrix, ops)
    from pytorch_hmm_tpu_torch.core.semiring import safe_log

    out = {"launches": {}, "agreement": {}, "errs": {}, "losses": {}}
    fails = []

    def bound(key, err, limit):
        out["errs"][key] = err
        if not err <= limit:
            fails.append(f"{key} off by {err:.3g} (limit {limit})")

    def grads(tag, model, ref):
        for (name, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{tag}: gradient of {name} missing or not finite")
            bound(f"{tag} d{name}", _grad_err(p.grad.cpu(), q.grad), GENK_GRAD_RTOL)

    def launched(tag, names):
        torch.cuda.synchronize(dev)
        out["launches"][tag] = read_launches(names)
        for k, n in out["launches"][tag].items():
            check(n > 0, f"{tag} never launched {k}")

    # GaussianHMMLayer(64, 80): weights from the seed, data walking its means.
    layer = GaussianHMMLayer(GK, GD, generator=torch.Generator().manual_seed(SEED), device=dev)
    obs = _l2r_walk(layer.means, B, T, SEED + 50)
    obs64 = obs.cpu().double()
    twin = _cpu_copy(layer, GaussianHMMLayer, num_states=GK, feature_dim=GD)
    twin64 = _cpu_copy(layer, GaussianHMMLayer, torch.float64, num_states=GK, feature_dim=GD)
    reset_launches()
    with torch.no_grad():
        post = layer(obs)
    launched("GaussianHMMLayer posteriors", ("diag_quadratic", "pallas_forward", "pallas_backward"))
    with torch.no_grad():
        post64 = twin64(obs64)
    check(bool(torch.isfinite(post).all()) and post.shape == (B, T, GK), "posteriors not finite")
    bound("GaussianHMMLayer posteriors", (post.cpu().double() - post64).abs().max().item(),
          GENK_POST_ATOL)
    must_raise(NotImplementedError, lambda: layer(obs), "train-mode posteriors under autograd")
    reset_launches()
    layer.zero_grad()
    loss = layer.compute_loss(obs)
    loss.backward()
    launched("GaussianHMMLayer compute_loss", ("diag_quadratic", "pallas_forward", "pallas_backward"))
    ref_loss = twin64.compute_loss(obs64)
    ref_loss.backward()
    bound("GaussianHMMLayer loss", abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
          LOSS_RTOL)
    grads("GaussianHMMLayer", layer, twin64)
    trainee = GaussianHMMLayer(GK, GD, generator=torch.Generator().manual_seed(SEED), device=dev)
    opt = torch.optim.Adam(trainee.parameters(), lr=1e-2)
    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        step_loss = trainee.compute_loss(obs)
        step_loss.backward()
        opt.step()
        losses.append(step_loss.item())
    check(losses[-1] < losses[0], f"GaussianHMMLayer Adam: the loss did not fall: {losses}")
    out["losses"]["GaussianHMMLayer"] = losses
    layer.eval()
    twin.eval()
    reset_launches()
    onehot = layer(obs)
    launched("GaussianHMMLayer decode", ("diag_quadratic", "pallas_viterbi"))
    check(bool((onehot.sum(-1) == 1).all()), "decode: not one-hot")
    out["agreement"]["GaussianHMMLayer"] = (onehot.argmax(-1).cpu() == twin(obs.cpu()).argmax(-1)
                                            ).float().mean().item()
    check(out["agreement"]["GaussianHMMLayer"] >= 0.999,
          f"GaussianHMMLayer decode: frame agreement {out['agreement']['GaussianHMMLayer']}")
    # The card's trellis on the CPU's log-obs gives the CPU's paths and
    # scores, bit for bit.
    with torch.no_grad():
        lo_cpu = twin._compute_gaussian_log_probs(obs.cpu())
        la_cpu, lp_cpu = twin.hmm_layer._log_params()
        rs, rc = core.viterbi(lo_cpu, la_cpu, lp_cpu)
        gs, gc = ops.pallas_viterbi(lo_cpu.to(dev), la_cpu.to(dev), lp_cpu.to(dev))
    check(torch.equal(gs.cpu(), rs) and torch.equal(gc.cpu(), rc),
          "GaussianHMMLayer: card trellis on CPU log-obs differs")
    out["layer"], out["obs"] = layer, obs

    # HMMLayer(64) over per-state scores: the layer's log-obs, rescaled.
    with torch.no_grad():
        scores = (layer._compute_gaussian_log_probs(obs) / GD).contiguous()
    hl = HMMLayer(GK, device=dev)
    hl64 = _cpu_copy(hl, HMMLayer, torch.float64, num_states=GK)
    reset_launches()
    with torch.no_grad():
        hpost = hl(scores)
    hl.zero_grad()
    hloss = hl.compute_loss(scores)
    hloss.backward()
    launched("HMMLayer", ("pallas_forward", "pallas_backward"))
    with torch.no_grad():
        bound("HMMLayer posteriors", (hpost.cpu().double() - hl64(scores.cpu().double())).abs()
              .max().item(), GENK_POST_ATOL)
    ref = hl64.compute_loss(scores.cpu().double())
    ref.backward()
    bound("HMMLayer loss", abs(hloss.item() - ref.item()) / abs(ref.item()), LOSS_RTOL)
    grads("HMMLayer", hl, hl64)
    must_raise(NotImplementedError,
               lambda: hl.compute_loss(scores, torch.zeros(B, T, dtype=torch.long, device=dev)),
               "supervised HMMLayer loss under autograd")
    hl.eval()
    reset_launches()
    hs, hsc = hl.align(scores)
    launched("HMMLayer align", ("pallas_viterbi",))
    hl_cpu = _cpu_copy(hl, HMMLayer, num_states=GK).eval()
    rs, rsc = hl_cpu.align(scores.cpu())
    out["agreement"]["HMMLayer"] = (hs.cpu() == rs).float().mean().item()
    check(out["agreement"]["HMMLayer"] >= 0.999, f"HMMLayer align: agreement {out['agreement']}")
    check(torch.allclose(hsc.cpu(), rsc, rtol=1e-5, atol=0.0), "HMMLayer align: scores differ")

    # HMM(create_left_to_right_matrix(64)) on the layer's frame probabilities.
    P = create_left_to_right_matrix(GK)
    with torch.no_grad():
        probs = torch.softmax(layer._compute_gaussian_log_probs(obs), -1).contiguous()
    hmm = HMM(P, device=dev)
    hmm64 = HMM(P, dtype=torch.float64, device="cpu")
    hmm32 = HMM(P, device="cpu")
    reset_launches()
    gamma, _, _ = hmm.forward_backward(probs)
    vs, vsc = hmm.viterbi_decode(probs)
    ll = hmm.compute_likelihood(probs)
    launched("HMM", ("pallas_forward", "pallas_backward", "pallas_viterbi"))
    p64 = probs.cpu().double()
    bound("HMM posteriors", (gamma.cpu().double() - hmm64.forward_backward(p64)[0]).abs().max()
          .item(), GENK_POST_ATOL)
    bound("HMM log-likelihood", _max_rel(ll, hmm64.compute_likelihood(p64)), HMM_LL_RTOL)
    rs, rsc = hmm32.viterbi_decode(probs.cpu())
    out["agreement"]["HMM"] = (vs.cpu() == rs).float().mean().item()
    check(out["agreement"]["HMM"] >= 0.999, f"HMM decode: agreement {out['agreement']['HMM']}")
    check(torch.allclose(vsc.cpu(), rsc, rtol=1e-5, atol=0.0), "HMM decode: scores differ")
    gs, gc = ops.pallas_viterbi(safe_log(probs.cpu()).to(dev), hmm32.log_P.to(dev),
                                hmm32.log_p0.to(dev))
    check(torch.equal(gs.cpu(), rs) and torch.equal(gc.cpu(), rsc),
          "HMM: card trellis on CPU log-obs differs")
    out["hmm"], out["probs"] = hmm, probs

    # MixtureGaussianHMMLayer(64, 80) at C=2 (fused decode) and C=4.
    gobs, glen = None, None
    for c in GMM_CS:
        tag = f"MixtureGaussianHMMLayer C={c}"
        gmm = MixtureGaussianHMMLayer(GK, GD, num_components=c,
                                      generator=torch.Generator().manual_seed(SEED), device=dev)
        if gobs is None:
            gobs = _l2r_walk(gmm.means[:, 0], B, T, SEED + 51)
            glen = torch.randint(1, T + 1, (B,), generator=torch.Generator().manual_seed(SEED + 52),
                                 dtype=torch.int32).to(dev)
            glen[0], glen[1] = T, 1
        kw = dict(num_states=GK, feature_dim=GD, num_components=c)
        cpu = _cpu_copy(gmm, MixtureGaussianHMMLayer, **kw).eval()
        cpu64 = _cpu_copy(gmm, MixtureGaussianHMMLayer, torch.float64, **kw)
        decode = "fused_gmm_viterbi" if c == 2 else "pallas_viterbi"
        reset_launches()
        full = gmm(gobs, return_log_probs=True)
        ragged = gmm(gobs, return_log_probs=True, lengths=glen)
        launched(f"{tag} decode", (decode,) if c == 2 else ("diag_quadratic", decode))
        for name, (st, sc), ln in (("full", full, None), ("ragged", ragged, glen.cpu())):
            rst, rsc = cpu(gobs.cpu(), return_log_probs=True, lengths=ln)
            agree = (st.cpu() == rst).float().mean().item()
            out["agreement"][f"{tag} {name}"] = agree
            check(agree >= 0.999, f"{tag} {name}: frame agreement {agree}")
            check(torch.allclose(sc.cpu(), rsc, rtol=1e-5, atol=0.0), f"{tag} {name}: scores differ")
        reset_launches()
        gmm.zero_grad()
        gl = gmm.compute_loss(gobs)
        gl.backward()
        launched(f"{tag} compute_loss", ("diag_quadratic", "pallas_forward", "pallas_backward"))
        rl = cpu64.compute_loss(gobs.cpu().double())
        rl.backward()
        bound(f"{tag} loss", abs(gl.item() - rl.item()) / abs(rl.item()), LOSS_RTOL)
        grads(tag, gmm, cpu64)
        em = _cpu_copy(gmm, MixtureGaussianHMMLayer, torch.float64, **kw)
        reset_launches()
        ll = gmm.em_step(gobs).item()
        launched(f"{tag} em_step", ("diag_quadratic", "pallas_forward", "pallas_backward"))
        ref_ll = em.em_step(gobs.cpu().double()).item()
        bound(f"{tag} em ll", abs(ll - ref_ll) / abs(ref_ll), LOSS_RTOL)
        for (name, p), (_, q) in zip(gmm.named_parameters(), em.named_parameters()):
            p, q = p.detach().cpu(), q.detach()
            check(bool(torch.isfinite(p).all()), f"{tag} em_step: {name} not finite")
            if name.endswith("_logits"):
                p, q = torch.softmax(p, -1), torch.softmax(q, -1)
            bound(f"{tag} em {name}", _grad_err(p, q), GENK_EM_RTOL)
        out[f"gmm C={c}"] = gmm
    out["gobs"] = gobs
    check(not fails, "general-K slice vs CPU: " + "; ".join(fails) + f" (all: {out['errs']})")
    return out


def phase_genk_timing(dev, gen, slice_out):
    """Rows 8, 9, 13 and 14 against their plain versions at the slice's
    width, the chains at K=256 and 1024 as well, row 14's decode through
    rows 1 and 13 unfused; the slice's entry points; launches per call.
    Returns ``(times, launches, profiles of the GENK_PROFILED calls,
    inputs)``."""
    import torch
    from pytorch_hmm_tpu_torch import emissions, ops

    slow = dict(runs=PLAIN_SUM_RUNS, warmup=1)
    cases = _scan_cases(dev, gen)
    lo, la, lp, _ = cases["headline"]
    gmm_in = _gmm_inputs(dev, gen, B, T, GK, 2, GD)
    times = {
        "pallas_forward": (cuda_median_ms(lambda: ops.pallas_forward(lo, la, lp)),
                           cuda_median_ms(lambda: ops.pallas_forward_reference(lo, la, lp), **slow)),
        "pallas_backward": (cuda_median_ms(lambda: ops.pallas_backward(lo, la)),
                            cuda_median_ms(lambda: ops.pallas_backward_reference(lo, la), **slow)),
        "pallas_viterbi": (cuda_median_ms(lambda: ops.pallas_viterbi(lo, la, lp)),
                           cuda_median_ms(lambda: ops.pallas_viterbi_reference(lo, la, lp), **slow)),
        "fused_gmm_viterbi": (cuda_median_ms(lambda: ops.fused_gmm_viterbi(*gmm_in)),
                              cuda_median_ms(lambda: ops.fused_gmm_viterbi_reference(*gmm_in),
                                             **slow)),
        # The same decode unfused: row 1 and the logsumexp over C, then row 13.
        UNFUSED: cuda_median_ms(lambda: ops.pallas_viterbi(
            emissions.gmm_log_probs(*gmm_in[:4], "diag"), *gmm_in[4:6])),
    }
    for k in ("K=256", "K=1024"):
        klo, kla, klp, _ = cases[k]
        times[f"pallas_forward {k}"] = cuda_median_ms(lambda: ops.pallas_forward(klo, kla, klp))
        times[f"pallas_backward {k}"] = cuda_median_ms(lambda: ops.pallas_backward(klo, kla))
        times[f"pallas_viterbi {k}"] = cuda_median_ms(lambda: ops.pallas_viterbi(klo, kla, klp))
    layer, obs, gobs = slice_out["layer"], slice_out["obs"], slice_out["gobs"]
    hmm, probs = slice_out["hmm"], slice_out["probs"]
    trainee = slice_out["layer"]

    def loss_step(model, x):
        model.zero_grad()
        model.compute_loss(x).backward()

    def posteriors():
        trainee.train()
        with torch.no_grad():
            out = trainee(obs)
        trainee.eval()
        return out

    calls = {
        "GaussianHMMLayer decode": lambda: layer(obs),
        "GaussianHMMLayer posteriors": posteriors,
        "GaussianHMMLayer compute_loss step": lambda: loss_step(layer, obs),
        "HMM forward_backward": lambda: hmm.forward_backward(probs),
    }
    for c in GMM_CS:
        gmm = slice_out[f"gmm C={c}"]
        calls[f"MixtureGaussianHMMLayer C={c} decode"] = lambda gmm=gmm: gmm(gobs, True)
        calls[f"MixtureGaussianHMMLayer C={c} compute_loss step"] = (
            lambda gmm=gmm: loss_step(gmm, gobs))
        calls[f"MixtureGaussianHMMLayer C={c} em_step"] = lambda gmm=gmm: gmm.em_step(gobs)
    launches = {}
    for name, fn in calls.items():
        times[name] = cuda_median_ms(fn)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[name] = {k: v for k, v in read_launches(KERNELS).items() if v}
    profiles = {name: _profile(dev, calls[name]) for name in GENK_PROFILED}
    return times, launches, profiles, {"scan": (lo, la, lp), "gmm": gmm_in}


# -- the long-sequence slice: rows 10-12 and full covariance ----------------------


def _prob_cases(dev, gen):
    """Inputs of the prob-space chain checks: ``(log_obs, log_a, log_pi,
    rs)``."""
    import torch
    from pytorch_hmm_tpu_torch import create_left_to_right_matrix

    def rand(b, t, k, rs=8):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        return lo, la, lp, rs

    # A finite left-to-right matrix through safe_log (off-band entries
    # log 1e-8 ~ -18.4, rows renormalized), with emissions that disagree
    # with the chain's states by up to 6 nats a frame.
    l2r = torch.log_softmax(torch.log(create_left_to_right_matrix(LK, 0.6).to(dev) + 1e-8), -1)
    mismatched = -6.0 * torch.rand(4, 1000, LK, device=dev, generator=gen)
    return {
        "headline": rand(LB, PROB_T, LK),
        "K=33": rand(8, 1000, 33),
        # T K odd: every other sequence starts off 16-byte alignment and the
        # last chunk (41 rows of 33) is no multiple of 16 bytes, so the
        # warp-specialised producer stages them by 4-byte cp.async.
        "K=33 T=1001": rand(4, 1001, 33),
        "K=128": rand(8, 1000, 128),
        "K=12": rand(8, 1000, 12),
        "T=1001": rand(8, 1001, LK),
        "T=1": rand(3, 1, LK),
        "rs=4": rand(8, 1000, LK, rs=4),
        "left-to-right": (mismatched, l2r, torch.full((LK,), -math.log(LK), device=dev), 8),
    }


def phase_prob_kernels(dev, gen):
    """Rows 10, 11 and 12 vs their plain versions on the same inputs (the
    relative tables, shifts and log Z as the kernels write them), the
    fused launch's tables equal to the single chains', and the finite
    left-to-right case's posteriors against ``core`` in float64. Returns
    the headline max abs errors of the summed tables and of the split
    outputs, the left-to-right posterior error, the case names and the
    headline inputs."""
    import torch
    from pytorch_hmm_tpu_torch import core, ops
    from pytorch_hmm_tpu_torch.ops import scan

    cases = _prob_cases(dev, gen)
    for name, (lo, la, lp, rs) in cases.items():
        alpha, lz = ops.pallas_forward_prob(lo, la, lp, rs=rs)
        beta = ops.pallas_backward_prob(lo, la, rs=rs)
        f_alpha, f_beta, f_lz = ops.pallas_fb_prob(lo, la, lp, rs=rs)
        torch.cuda.synchronize(dev)
        rel_a, sh_a, rel_b, sh_b = ops.pallas_fb_prob_split(lo, la, lp, rs=rs)
        check(torch.equal(f_alpha, alpha) and torch.equal(f_beta, beta) and torch.equal(f_lz, lz),
              f"pallas_fb_prob {name}: tables differ from the single chains'")
        check(torch.equal(rel_a + sh_a[..., None], alpha) and torch.equal(rel_b + sh_b[..., None], beta),
              f"pallas_fb_prob {name}: split tables do not sum to the tables")
        # The plain versions' own split (pallas_*_prob_reference return its
        # sums); the single chains equal the fused launch's, bit for bit.
        rel_a0, sh_a0 = scan._forward_prob_split(lo, la, lp, rs)
        rel_b0, sh_b0 = scan._backward_prob_split(lo, la, rs)
        alpha0, beta0 = rel_a0 + sh_a0[..., None], rel_b0 + sh_b0[..., None]
        lz0 = torch.logsumexp(alpha0[:, -1], dim=-1)
        split = {}
        for what, got, want, atol, rtol in (
                ("relative alpha", rel_a, rel_a0, PROB_REL_ATOL, 0.0),
                ("relative beta", rel_b, rel_b0, PROB_REL_ATOL, 0.0),
                ("alpha shift", sh_a, sh_a0, PROB_ATOL, PROB_RTOL),
                ("beta shift", sh_b, sh_b0, PROB_ATOL, PROB_RTOL),
                ("log Z", lz, lz0, PROB_ATOL, PROB_RTOL)):
            split[what] = _sum_err(got, want, None, atol, rtol)
            check(split[what] != float("inf"),
                  f"pallas_fb_prob {name}: {what} disagrees with its plain version")
        errs = {
            "pallas_forward_prob": max((alpha - alpha0).abs().max().item(),
                                       (lz - lz0).abs().max().item()),
            "pallas_backward_prob": (beta - beta0).abs().max().item(),
        }
        errs["pallas_fb_prob"] = max(errs.values())
        if name == "headline":
            worst, worst_split = errs, split
    lo, la, lp, _ = cases["left-to-right"]
    f_alpha, f_beta, _ = ops.pallas_fb_prob(lo, la, lp)
    g64 = torch.exp(core.forward_backward(lo.double(), la.double(), lp.double())[0])
    l2r_err = (torch.softmax(f_alpha + f_beta, -1).double() - g64).abs().max().item()
    check(l2r_err <= GENK_POST_ATOL, f"left-to-right posteriors off float64 by {l2r_err}")
    return worst, worst_split, l2r_err, list(cases), cases["headline"][:3]


# The phase probe of rows 10-12 (a separate build of csrc/scan_prob.cu with
# SCAN_PROB_PROBE defined) at B=32, T=4096: each role of the chain's block
# stamps its own phases of a chunk.
PROBE_DEFINES = ("SCAN_PROB_PROBE",)
PROBE_KS = (12, 64, 128)
PROBE_PHASES = ("chain wait", "frame loop", "producer wait", "producer work", "epilogue work")
PROBE_CHAINS = {"pallas_forward_prob": 1, "pallas_backward_prob": 2, "pallas_fb_prob": 3}


def phase_prob_probe(dev, gen):
    """Rows 10-12 timed by phase: per (row, K), each phase's median cycles
    a chunk over every block and chunk, the kernel's time (CUDA events
    around the probed launch) and the SM clock that time implies (the
    median block's chain cycles, its wait and frame loop, over it), from
    which each phase's µs a frame."""
    import ctypes

    import torch
    from pytorch_hmm_tpu_torch.ops import _build

    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib = _build.Library("scan_prob", {"scan_prob_probe_f32": [_P] * 8 + [_I] * 6 + [_P]},
                         PROBE_DEFINES)
    out = {}
    for k in PROBE_KS:
        lo = torch.randn(LB, PROB_T, k, device=dev, generator=gen)
        pa = torch.softmax(torch.randn(k, k, device=dev, generator=gen), -1).contiguous()
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        tables = [torch.empty(LB, PROB_T, k, device=dev) for _ in range(2)]
        shifts = [torch.empty(LB, PROB_T, device=dev) for _ in range(2)]
        nch = -(-PROB_T // 64)
        for row, chains in PROBE_CHAINS.items():
            blocks = 2 * LB if chains == 3 else LB
            probe = torch.zeros(blocks, nch, len(PROBE_PHASES), dtype=torch.int64, device=dev)

            def run():
                lib.launch("scan_prob_probe_f32", "probe", lo, pa, lp, *tables, *shifts, probe,
                           LB, PROB_T, k, 8, chains)

            ms = cuda_median_ms(run, runs=5, warmup=1)
            cycles = probe.double()
            mhz = cycles[..., :2].sum(dim=(1, 2)).median().item() / (ms * 1e3)
            med = cycles.reshape(-1, len(PROBE_PHASES)).median(dim=0).values.tolist()
            out[(row, k)] = {"ms": ms, "mhz": mhz, "cycles": dict(zip(PROBE_PHASES, med)),
                             "us_frame": {n: c / 64 / mhz for n, c in zip(PROBE_PHASES, med)},
                             "total_us_frame": ms * 1e3 / PROB_T}
    return out


def probe_lines(probe, card):
    """One line per probed (row, K)."""
    return [f"prob probe {row} (B={LB}, T={PROB_T}, K={k}): {r['ms']:.4f} ms, "
            f"{r['total_us_frame']:.4f} us a frame at {r['mhz']:.0f} MHz; median a chunk: "
            + ", ".join(f"{n} {c:.0f} cycles ({r['us_frame'][n]:.4f} us a frame)" for n, c in r["cycles"].items())
            + f" on {card}"
            for (row, k), r in probe.items()]


def _ll_grads(lo, la, lp):
    """``ops.auto_log_likelihood(...)`` ``(B,)`` and the gradients of its
    sum with respect to all three inputs."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    args = [t.detach().clone().requires_grad_(True) for t in (lo, la, lp)]
    ll = ops.auto_log_likelihood(*args)
    return ll.detach(), torch.autograd.grad(ll.sum(), args)


def phase_long_context(dev):
    """The JAX bench's long-context rows through the entry points a user
    calls, at B=32, T=131072, K=64: ``ops.auto_forward`` (row 10 once, row
    8 never), ``ops.auto_log_likelihood`` under no_grad (row 10) and the
    gradient of its sum (row 12 once, rows 8 and 9 never); for two rows
    against float64, the three calls' log Z, ``auto_forward``'s log alpha,
    the posteriors and the gradient; the gate: a -inf ``log_a`` and T=1023
    run rows 8 and 9 instead."""
    import torch
    from pytorch_hmm_tpu_torch import core, ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    lo = torch.randn(LB, LT, LK, device=dev, generator=gen)
    la = torch.log_softmax(torch.randn(LK, LK, device=dev, generator=gen), -1)
    lp = torch.log_softmax(torch.randn(LK, device=dev, generator=gen), -1)
    out = {"launches": {}, "errs": {}, "inputs": (lo, la, lp)}

    def run(tag, fn, want):
        reset_launches()
        res = fn()
        torch.cuda.synchronize(dev)
        got = read_launches(CHAIN_KERNELS)
        out["launches"][tag] = got
        for k in CHAIN_KERNELS:
            check(got[k] == want.get(k, 0), f"{tag}: {k} launched {got[k]} times (all: {got})")
        return res

    alpha, log_z = run("long-context forward", lambda: ops.auto_forward(lo, la, lp),
                       {"pallas_forward_prob": 1})
    check(alpha.shape == (LB, LT, LK) and bool(torch.isfinite(alpha).all())
          and bool(torch.isfinite(log_z).all()), "long-context forward: not finite")
    with torch.no_grad():
        ll = run("long-context likelihood, no gradient", lambda: ops.auto_log_likelihood(lo, la, lp),
                 {"pallas_forward_prob": 1})
    check(bool(torch.isfinite(ll).all()), "long-context likelihood: not finite")
    ll_g, grads = run("long-context gradient", lambda: _ll_grads(lo, la, lp), {"pallas_fb_prob": 1})
    check(all(bool(torch.isfinite(g).all()) for g in grads), "long-context gradient: not finite")
    # Two rows against float64 (the plain core on the card): log Z of the
    # three calls and auto_forward's log alpha, posteriors from
    # auto_forward_backward, and the gradient of those rows' sum.
    sub = lo[:LONG_SUB].contiguous()
    with torch.no_grad():
        post = torch.exp(ops.auto_forward_backward(sub, la, lp)[0])
        lg64, a64, b64, lz64 = core.forward_backward(sub.double(), la.double(), lp.double())
        g64 = torch.exp(lg64)
        want = (g64, core.xi_sum(a64, b64, sub.double(), la.double()), g64[:, 0].sum(0))
    for name, got, ref in (("log Z auto_forward", log_z, lz64), ("log Z no gradient", ll, lz64),
                           ("log Z gradient", ll_g, lz64), ("log alpha", alpha, a64)):
        d = (got[:LONG_SUB].double() - ref).abs()
        out["errs"][name] = d.max().item()
        check(bool((d <= LONG_ATOL + LONG_RTOL * ref.abs()).all()),
              f"long-context {name} off float64 by {out['errs'][name]:.3g} "
              f"(atol {LONG_ATOL} + rtol {LONG_RTOL} of |{ref.abs().max().item():.6g}|)")
    del a64, b64
    out["errs"]["posteriors"] = (post.double() - g64).abs().max().item()
    check(out["errs"]["posteriors"] <= GENK_POST_ATOL,
          f"long-context posteriors off float64 by {out['errs']['posteriors']}")
    for name, g, w in zip(("dlog_obs", "dlog_a", "dlog_pi"), _ll_grads(sub, la, lp)[1], want):
        out["errs"][name] = _grad_err(g, w)
        check(out["errs"][name] <= GENK_GRAD_RTOL,
              f"long-context {name} off float64 by {out['errs'][name]:.3g} of its max")
    # The gate: a -inf transition, and one frame short of the envelope.
    la_inf = la.clone()
    la_inf[0, -1] = float("-inf")
    la_inf = torch.log_softmax(la_inf, -1)
    short = lo[:, :1023].contiguous()
    run("gate -inf log_a: forward", lambda: ops.auto_forward(lo, la_inf, lp), {"pallas_forward": 1})
    run("gate -inf log_a: gradient", lambda: _ll_grads(lo, la_inf, lp),
        {"pallas_forward": 1, "pallas_backward": 1})
    run("gate T=1023: forward", lambda: ops.auto_forward(short, la, lp), {"pallas_forward": 1})
    run("gate T=1023: gradient", lambda: _ll_grads(short, la, lp),
        {"pallas_forward": 1, "pallas_backward": 1})
    return out


def phase_fullcov(dev):
    """Full covariance at the width of two configurations against the CPU:
    ``GaussianHMMLayer(64, 80, "full")`` at B=32, T=2048 (posteriors under
    no_grad on row 12, ``compute_loss`` gradients against its CPU twin in
    float64 on four rows, five Adam steps, eval decode on row 13) and
    ``MixtureGaussianHMMLayer(12, 80, C=4, "full")`` at B=32, T=1000
    (``make_decoder`` decode on row 2 against the CPU and the live path,
    ``compute_loss`` gradients, five ``em_step``s and the first against
    float64, one ``em_step`` at T=2048 on row 12)."""
    import torch
    from pytorch_hmm_tpu_torch import GaussianHMMLayer, MixtureGaussianHMMLayer

    out = {"launches": {}, "agreement": {}, "errs": {}, "losses": {}, "lls": {}}
    fails = []

    def bound(key, err, limit):
        out["errs"][key] = err
        if not err <= limit:
            fails.append(f"{key} off by {err:.3g} (limit {limit})")

    def grads(tag, model, ref):
        for (name, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{tag}: gradient of {name} missing or not finite")
            bound(f"{tag} d{name}", _grad_err(p.grad.cpu(), q.grad), GENK_GRAD_RTOL)

    def launched(tag, names, absent=()):
        torch.cuda.synchronize(dev)
        counts = read_launches((*names, *absent))
        out["launches"][tag] = counts
        for k in names:
            check(counts[k] > 0, f"{tag} never launched {k}")
        for k in absent:
            check(counts[k] == 0, f"{tag} launched {k}")

    # GaussianHMMLayer(64, 80, "full"), Cholesky parameters off the
    # identity, data walking its means.
    def make_layer():
        lay = GaussianHMMLayer(GK, GD, covariance_type="full",
                               generator=torch.Generator().manual_seed(SEED), device=dev)
        with torch.no_grad():
            g = torch.Generator().manual_seed(SEED + 80)
            lay.log_scales.copy_(0.05 * torch.randn(GK, GD, GD, generator=g))
        return lay

    layer = make_layer()
    kw = dict(num_states=GK, feature_dim=GD, covariance_type="full")
    obs = _l2r_walk(layer.means, B, FULL_T, SEED + 81)
    sub = obs[:FULL_SUB].contiguous()
    twin = _cpu_copy(layer, GaussianHMMLayer, **kw)
    twin64 = _cpu_copy(layer, GaussianHMMLayer, torch.float64, **kw)
    reset_launches()
    with torch.no_grad():
        post = layer(obs)
    launched("GaussianHMMLayer full posteriors", ("pallas_fb_prob",), ("pallas_forward",))
    check(bool(torch.isfinite(post).all()) and post.shape == (B, FULL_T, GK), "posteriors not finite")
    with torch.no_grad():
        post64 = twin64(sub.cpu().double())
    bound("GaussianHMMLayer full posteriors",
          (post[:FULL_SUB].cpu().double() - post64).abs().max().item(), GENK_POST_ATOL)
    reset_launches()
    layer.zero_grad()
    layer.compute_loss(obs).backward()
    launched("GaussianHMMLayer full compute_loss", ("pallas_fb_prob",),
             ("pallas_forward", "pallas_backward"))
    layer.zero_grad()
    loss = layer.compute_loss(sub)
    loss.backward()
    ref_loss = twin64.compute_loss(sub.cpu().double())
    ref_loss.backward()
    bound("GaussianHMMLayer full loss", abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
          LOSS_RTOL)
    grads("GaussianHMMLayer full", layer, twin64)
    trainee = make_layer()
    opt = torch.optim.Adam(trainee.parameters(), lr=1e-2)
    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        step_loss = trainee.compute_loss(obs)
        step_loss.backward()
        opt.step()
        losses.append(step_loss.item())
    check(losses[-1] < losses[0], f"GaussianHMMLayer full Adam: the loss did not fall: {losses}")
    out["losses"]["GaussianHMMLayer full"] = losses
    layer.eval()
    twin.eval()
    reset_launches()
    onehot = layer(obs)
    launched("GaussianHMMLayer full decode", ("pallas_viterbi",))
    check(bool((onehot.sum(-1) == 1).all()), "full decode: not one-hot")
    agree = (onehot.argmax(-1).cpu() == twin(obs.cpu()).argmax(-1)).float().mean().item()
    out["agreement"]["GaussianHMMLayer full"] = agree
    check(agree >= 0.999, f"GaussianHMMLayer full decode: frame agreement {agree}")
    out["layer"], out["obs"] = layer, obs

    # MixtureGaussianHMMLayer(12, 80, C=4, "full"), Cholesky parameters off
    # their initial identity.
    gmm = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="full",
                                  generator=torch.Generator().manual_seed(SEED), device=dev)
    with torch.no_grad():
        g = torch.Generator().manual_seed(SEED + 82)
        gmm.cov_params.add_(0.05 * torch.randn(gmm.cov_params.shape, generator=g).to(dev))
    gkw = dict(num_states=S, feature_dim=D, num_components=C, covariance_type="full")
    gobs, _ = make_requests(dev)
    cpu = _cpu_copy(gmm, MixtureGaussianHMMLayer, **gkw).eval()
    cpu64 = _cpu_copy(gmm, MixtureGaussianHMMLayer, torch.float64, **gkw)
    gmm.eval()
    reset_launches()
    decoder = gmm.make_decoder()
    served = decoder(gobs, True)
    live = gmm(gobs, True)
    launched("MixtureGaussianHMMLayer full decode", ("smallk_viterbi",))
    check("prec" in decoder.emission_tables, "full decoder does not hold the prepared tables")
    # Held to the CPU twin in float64: the plain float32 chain drifts by
    # ~1e-5 of the score at this scale.
    rst, rsc = cpu64.make_decoder()(gobs.cpu().double(), True)
    for name, (st, sc), (wst, wsc) in (("vs CPU", served, (rst, rsc.float())),
                                       ("vs live path", served, (live[0].cpu(), live[1].cpu()))):
        agree = (st.cpu() == wst).float().mean().item()
        out["agreement"][f"MixtureGaussianHMMLayer full {name}"] = agree
        check(agree >= 0.999, f"full GMM decode {name}: frame agreement {agree}")
        check(torch.allclose(sc.cpu(), wsc, rtol=1e-5, atol=0.0), f"full GMM decode {name}: scores")
    reset_launches()
    gmm.zero_grad()
    gl = gmm.compute_loss(gobs)
    gl.backward()
    launched("MixtureGaussianHMMLayer full compute_loss", ("hsmm_smallk_forward", "hsmm_smallk_backward"))
    rl = cpu64.compute_loss(gobs.cpu().double())
    rl.backward()
    bound("MixtureGaussianHMMLayer full loss", abs(gl.item() - rl.item()) / abs(rl.item()), LOSS_RTOL)
    grads("MixtureGaussianHMMLayer full", gmm, cpu64)
    em = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="full", device=dev)
    em.load_state_dict(gmm.state_dict())
    em64 = _cpu_copy(gmm, MixtureGaussianHMMLayer, torch.float64, **gkw)
    reset_launches()
    lls = [em.em_step(gobs).item() for _ in range(EM_STEPS)]
    launched("MixtureGaussianHMMLayer full em_step", ("fbsum_smallk",), ("pallas_fb_prob",))
    for a, b in zip(lls, lls[1:]):
        check(b >= a - LL_SLACK * abs(a), f"full em_step: log-likelihood fell: {lls}")
    out["lls"]["MixtureGaussianHMMLayer full"] = lls
    em.load_state_dict(gmm.state_dict())
    ll = em.em_step(gobs).item()
    ref_ll = em64.em_step(gobs.cpu().double()).item()
    bound("MixtureGaussianHMMLayer full em ll", abs(ll - ref_ll) / abs(ref_ll), LOSS_RTOL)
    for (name, p), (_, q) in zip(em.named_parameters(), em64.named_parameters()):
        p, q = p.detach().cpu(), q.detach()
        check(bool(torch.isfinite(p).all()), f"full em_step: {name} not finite")
        if name.endswith("_logits"):
            p, q = torch.softmax(p, -1), torch.softmax(q, -1)
        bound(f"MixtureGaussianHMMLayer full em {name}", _grad_err(p, q), GENK_EM_RTOL)
    long_obs = gobs.repeat(1, -(-FULL_T // T), 1)[:, :FULL_T].contiguous()
    reset_launches()
    check(math.isfinite(em.em_step(long_obs).item()), "full em_step at T=2048: not finite")
    launched("MixtureGaussianHMMLayer full em_step T=2048", ("pallas_fb_prob",), ("fbsum_smallk",))
    out["gmm"], out["em"], out["gobs"], out["long_obs"] = gmm, em, gobs, long_obs
    check(not fails, "full covariance vs CPU: " + "; ".join(fails) + f" (all: {out['errs']})")
    return out


def phase_long_timing(dev, gen, prob_inputs, long_out, full_out):
    """Rows 10-12 and rows 8-9 at T=4096 and T=131072 (B=32, K=64; the plain
    versions at T=4096 only: T-step Python loops), row 12 against
    ``fbsum_smallk`` at K=12, the slice's entry points with their launches,
    profiles of one long-context gradient call and of three
    full-covariance calls, and the gate's sync. Returns ``(times,
    launches, profiles, gate)``."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    slow = dict(runs=PLAIN_SUM_RUNS, warmup=1)
    longr = dict(runs=LONG_RUNS, warmup=1)
    lo4, la4, lp4 = prob_inputs
    lo, la, lp = long_out["inputs"]
    times = {
        "pallas_forward_prob": (cuda_median_ms(lambda: ops.pallas_forward_prob(lo4, la4, lp4)),
                                cuda_median_ms(lambda: ops.pallas_forward_prob_reference(
                                    lo4, la4, lp4), **slow)),
        "pallas_backward_prob": (cuda_median_ms(lambda: ops.pallas_backward_prob(lo4, la4)),
                                 cuda_median_ms(lambda: ops.pallas_backward_prob_reference(
                                     lo4, la4), **slow)),
        "pallas_fb_prob": (cuda_median_ms(lambda: ops.pallas_fb_prob(lo4, la4, lp4)),
                           cuda_median_ms(lambda: ops.pallas_fb_prob_reference(lo4, la4, lp4),
                                          **slow)),
        "pallas_forward T=4096": cuda_median_ms(lambda: ops.pallas_forward(lo4, la4, lp4)),
        "pallas_backward T=4096": cuda_median_ms(lambda: ops.pallas_backward(lo4, la4)),
    }
    for name, fn in (("pallas_forward_prob", lambda: ops.pallas_forward_prob(lo, la, lp)),
                     ("pallas_backward_prob", lambda: ops.pallas_backward_prob(lo, la)),
                     ("pallas_fb_prob", lambda: ops.pallas_fb_prob(lo, la, lp)),
                     ("pallas_forward", lambda: ops.pallas_forward(lo, la, lp)),
                     ("pallas_backward", lambda: ops.pallas_backward(lo, la))):
        times[f"{name} T={LT}"] = cuda_median_ms(fn, **longr)
    lo12 = torch.randn(LB, PROB_T, S, device=dev, generator=gen)
    la12 = torch.log_softmax(torch.randn(S, S, device=dev, generator=gen), -1)
    lp12 = torch.log_softmax(torch.randn(S, device=dev, generator=gen), -1)
    times["pallas_fb_prob K=12"] = cuda_median_ms(lambda: ops.pallas_fb_prob(lo12, la12, lp12))
    times["fbsum_smallk K=12 T=4096"] = cuda_median_ms(lambda: ops.fbsum_smallk(lo12, la12, lp12))

    layer, obs = full_out["layer"], full_out["obs"]
    gmm, em, gobs, long_obs = full_out["gmm"], full_out["em"], full_out["gobs"], full_out["long_obs"]
    decoder = gmm.make_decoder()

    def loss_step(model, x):
        model.zero_grad()
        model.compute_loss(x).backward()

    def posteriors():
        layer.train()
        with torch.no_grad():
            res = layer(obs)
        layer.eval()
        return res

    calls = {
        "long-context forward": (lambda: ops.auto_forward(lo, la, lp), longr),
        "long-context gradient": (lambda: _ll_grads(lo, la, lp), longr),
        "GaussianHMMLayer full decode": (lambda: layer(obs), {}),
        "GaussianHMMLayer full posteriors": (posteriors, {}),
        "GaussianHMMLayer full compute_loss step": (lambda: loss_step(layer, obs), {}),
        "MixtureGaussianHMMLayer full decode": (lambda: decoder(gobs, True), {}),
        "MixtureGaussianHMMLayer full compute_loss step": (lambda: loss_step(gmm, gobs), {}),
        "MixtureGaussianHMMLayer full em_step": (lambda: em.em_step(gobs), {}),
        "MixtureGaussianHMMLayer full em_step T=2048": (lambda: em.em_step(long_obs), {}),
    }
    launches = {}
    for name, (fn, kw) in calls.items():
        times[name] = cuda_median_ms(fn, **kw)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[name] = {k: v for k, v in read_launches(KERNELS).items() if v}
    prof = {name: _profile(dev, calls[name][0], n=1 if name.startswith("long") else 3)
            for name in LONG_PROFILED}
    # The gate's finiteness read: one device sync per call that gets that
    # far, host clock around calls on an idle stream.
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(100):
        ops._finite(la)
    gate = {"finite read us": (time.perf_counter() - t0) * 1e4}
    t0 = time.perf_counter()
    for _ in range(100):
        ops._sum_route(lo4, la4)
    gate["route us"] = (time.perf_counter() - t0) * 1e4
    return times, launches, prof, gate


def _ctc_problem(dev, gen, b, t, c, u, in_lens=None, tgt_lens=None, repeats=False):
    """``(log_probs (T, B, C), targets (B, U), input_lengths, target_lengths)``
    on the card: standard normal logits through log_softmax, labels uniform
    over 1..C-1 (``repeats``: each label twice in a row, so no skip between
    them), full lengths unless given."""
    import torch

    logits = torch.randn(t, b, c, device=dev, generator=gen)
    targets = torch.randint(1, c, (b, u), device=dev, generator=gen)
    if repeats:
        targets[:, 1::2] = targets[:, 0::2][:, : u // 2]
    il = torch.full((b,), t, device=dev) if in_lens is None else torch.tensor(in_lens, device=dev)
    tl = torch.full((b,), u, device=dev) if tgt_lens is None else torch.tensor(tgt_lens, device=dev)
    return torch.log_softmax(logits, -1), targets, il, tl


def _ctc_kernel_inputs(log_probs, targets, il, tl):
    """The lattice kernels' inputs as ``alignment.ctc`` builds them, and
    the mask of valid cells ``(B, T, S)``."""
    import torch
    from pytorch_hmm_tpu_torch.alignment import ctc

    il, tl, _, skip_ok, valid, lp = ctc._lattice(log_probs, targets, il, tl, 0)
    skip_add, vmask = ctc._masks(skip_ok, valid, lp.dtype)
    skip_fwd, bT = ctc._backward_rows(skip_ok, tl, lp.dtype)
    end1, end2 = ctc._ends(tl)
    cells = valid[:, None, :] & (torch.arange(lp.shape[1], device=lp.device)[None, :, None]
                                 < il[:, None, None])
    return {"lp": lp, "skip_add": skip_add, "skip_fwd": ctc._masks(skip_fwd, valid, lp.dtype)[0],
            "vmask": vmask, "a0": ctc._initial_row(lp, valid, tl), "bT": bT, "il": il,
            "end1": end1, "end2": end2, "cells": cells}


def _ctc_calls(k, reference=False):
    """Each CTC kernel's call on the inputs ``k`` (or its plain version's)."""
    from pytorch_hmm_tpu_torch import ops

    fwd, bwd, vit, wide = ((ops.ctc_lattice_forward_reference, ops.ctc_lattice_backward_reference,
                            ops.ctc_lattice_viterbi_reference, ops.ctc_lattice_viterbi_reference)
                           if reference else (ops.ctc_lattice_forward, ops.ctc_lattice_backward,
                                              ops.ctc_lattice_viterbi, ops.ctc_lattice_viterbi_wide))
    vargs = (k["lp"], k["skip_add"], k["vmask"], k["a0"], k["il"], k["end1"], k["end2"])
    return {
        "ctc_lattice_forward": lambda: fwd(k["lp"], k["skip_add"], k["vmask"], k["a0"], k["il"]),
        "ctc_lattice_backward": lambda: bwd(k["lp"], k["skip_fwd"], k["vmask"], k["bT"], k["il"]),
        "ctc_lattice_viterbi": lambda: vit(*vargs),
        "ctc_lattice_viterbi_wide": lambda: wide(*vargs),
    }


def phase_ctc_kernels(dev, gen):
    """Rows 20-23 against their plain versions on the card: alpha and beta
    at valid cells, Viterbi positions identical and scores, each Viterbi
    case through both rows where row 22's table fits. Returns the max abs
    errors per case and the kernels' inputs of the two slice shapes."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    cases = {
        "headline": _ctc_problem(dev, gen, *CTC_SHAPES["headline"]),
        "S=2001": _ctc_problem(dev, gen, *CTC_SHAPES["S=2001"]),
        "S=2047": _ctc_problem(dev, gen, 2, 2100, 100, 1023),
        # A length-1 row, zero-length targets, an infeasible row (60 frames
        # for 2U+1 = 81) and one that fits exactly (81 frames).
        "ragged": _ctc_problem(dev, gen, 8, 300, 30, 40, in_lens=[300, 1, 250, 60, 299, 81, 170, 2],
                               tgt_lens=[40, 0, 33, 40, 12, 40, 1, 0]),
        "repeats": _ctc_problem(dev, gen, 4, 200, 30, 30, repeats=True),
    }
    errs, inputs = {}, {}
    for name, problem in cases.items():
        k = _ctc_kernel_inputs(*problem)
        B, T, S = k["lp"].shape
        got, want = _ctc_calls(k), _ctc_calls(k, reference=True)
        err = {}
        for kern in ("ctc_lattice_forward", "ctc_lattice_backward"):
            g, w = got[kern](), want[kern]()
            torch.cuda.synchronize(dev)
            check(not bool(torch.isnan(g).any()), f"{kern} {name}: NaN")
            sel = k["cells"] & (w > -1e29)
            err[kern] = (g - w)[sel].abs().max().item() if bool(sel.any()) else 0.0
            check(err[kern] <= CTC_ATOL, f"{kern} {name}: max abs err {err[kern]} at valid cells")
        pos0, score0 = want["ctc_lattice_viterbi"]()
        vits = (["ctc_lattice_viterbi"] if ops.ctc_viterbi_kernel_supported(T, B, S) else []) + \
            ["ctc_lattice_viterbi_wide"]
        for kern in vits:
            pos, score = got[kern]()
            torch.cuda.synchronize(dev)
            check(torch.equal(pos, pos0), f"{kern} {name}: positions differ from the plain version's")
            err[kern] = (score - score0).abs().max().item()
            check(err[kern] <= CTC_SCORE_ATOL, f"{kern} {name}: score err {err[kern]}")
        errs[name] = err
        if name in CTC_SHAPES:
            inputs[name] = (k, problem)
    return errs, inputs


def phase_ctc_slice(dev):
    """``CTCAligner`` at the JAX bench's widths through the entry points a
    user calls, each launch-counted: the loss and its gradient (rows 20 and
    21 once each) against the CPU twin in float64 and ``F.ctc_loss`` on the
    card, five Adam steps on the logits, ``align`` at S=101 (row 22) and
    S=2001 (row 23) identical to the CPU, ``ctc_alignment_path`` (rows 20
    and 21) against float64, greedy and beam decode identical to the CPU."""
    import torch
    import torch.nn.functional as F
    from pytorch_hmm_tpu_torch import CTCAligner, alignment

    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    out = {"launches": {}, "errs": {}}

    def run(tag, fn, want):
        reset_launches()
        res = fn()
        torch.cuda.synchronize(dev)
        got = read_launches(CTC_KERNELS)
        out["launches"][tag] = got
        for kern in CTC_KERNELS:
            check(got[kern] == want.get(kern, 0), f"{tag}: {kern} launched {got[kern]} times (all: {got})")
        return res

    b, t, c, u = CTC_SHAPES["headline"]
    logits = torch.randn(t, b, c, device=dev, generator=gen)
    targets = torch.randint(1, c, (b, u), device=dev, generator=gen)
    il, tl = torch.full((b,), t, device=dev), torch.full((b,), u, device=dev)
    host = [x.cpu() for x in (targets, il, tl)]
    aligner, twin = CTCAligner(c), CTCAligner(c, device="cpu")
    check(aligner.device.type == "cuda", "CTCAligner did not default to the card")
    x = logits.clone().requires_grad_(True)

    def loss_step():
        x.grad = None
        loss = aligner(torch.log_softmax(x, -1), targets, il, tl)
        loss.backward()
        return loss.detach()

    loss = run("loss step", loss_step, {"ctc_lattice_forward": 1, "ctc_lattice_backward": 1})
    x64 = logits.detach().cpu().double().requires_grad_(True)
    loss64 = twin(torch.log_softmax(x64, -1), *host)
    loss64.backward()
    out["errs"]["loss vs float64"] = abs(loss.item() - loss64.item())
    check(out["errs"]["loss vs float64"] <= CTC_LL_ATOL + CTC_LL_RTOL * abs(loss64.item()),
          f"CTC loss {loss.item()} vs float64 {loss64.item()}")
    out["errs"]["gradient vs float64"] = (x.grad.cpu().double() - x64.grad).abs().max().item()
    check(out["errs"]["gradient vs float64"] <= CTC_GRAD_ATOL,
          f"CTC gradient off float64 by {out['errs']['gradient vs float64']}")
    y = logits.clone().requires_grad_(True)
    lib = F.ctc_loss(torch.log_softmax(y, -1), targets, il, tl, reduction="mean")
    lib.backward()
    out["errs"]["loss vs F.ctc_loss"] = abs(loss.item() - lib.item())
    out["errs"]["gradient vs F.ctc_loss"] = (x.grad - y.grad).abs().max().item()
    check(out["errs"]["loss vs F.ctc_loss"] <= CTC_LL_ATOL + CTC_LL_RTOL * abs(lib.item())
          and out["errs"]["gradient vs F.ctc_loss"] <= CTC_GRAD_ATOL,
          f"CTC loss / gradient disagree with F.ctc_loss: {out['errs']}")

    p = logits.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=0.05)
    out["losses"] = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        step_loss = aligner(torch.log_softmax(p, -1), targets, il, tl)
        step_loss.backward()
        opt.step()
        out["losses"].append(round(step_loss.item(), 4))
    check(all(b_ < a_ for a_, b_ in zip(out["losses"], out["losses"][1:])),
          f"CTC Adam losses not decreasing: {out['losses']}")

    lp = torch.log_softmax(logits, -1)
    got = run("align S=101", lambda: aligner.align(lp, targets, il, tl), {"ctc_lattice_viterbi": 1})
    want = twin.align(lp.cpu(), *host)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), "align S=101 differs from the CPU")
    check(all(alignment.ctc_decode_sequence(g.cpu()).tolist() == r.tolist()
              for g, r in zip(got, host[0])), "align S=101 does not decode to its targets")

    b2, t2, c2, u2 = CTC_SHAPES["S=2001"]
    lp2 = torch.log_softmax(torch.randn(t2, b2, c2, device=dev, generator=gen), -1)
    targets2 = torch.randint(1, c2, (b2, u2), device=dev, generator=gen)
    il2, tl2 = torch.full((b2,), t2, device=dev), torch.full((b2,), u2, device=dev)
    aligner2 = CTCAligner(c2)
    got = run("align S=2001", lambda: aligner2.align(lp2, targets2, il2, tl2),
              {"ctc_lattice_viterbi_wide": 1})
    want = CTCAligner(c2, device="cpu").align(lp2.cpu(), targets2.cpu(), il2.cpu(), tl2.cpu())
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), "align S=2001 differs from the CPU")

    paths = run("ctc_alignment_path", lambda: alignment.ctc_alignment_path(lp, targets, il, tl),
                {"ctc_lattice_forward": 1, "ctc_lattice_backward": 1})
    want = alignment.ctc_alignment_path(lp.cpu().double(), *host)
    agree = sum(int((g.cpu() == w).sum()) for g, w in zip(paths, want)) / (b * t)
    out["path agreement"] = agree
    check(agree >= CTC_PATH_AGREE, f"ctc_alignment_path agrees with float64 on {agree} of frames")

    for width in (1, CTC_BEAM):
        tag = "decode greedy" if width == 1 else f"decode beam W={width}"
        got = run(tag, lambda: aligner.decode(lp, il, width), {})
        want = twin.decode(lp.cpu(), host[1], width)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), f"{tag} differs from the CPU")
    out["calls"] = {
        "loss step": loss_step,
        "align S=101": lambda: aligner.align(lp, targets, il, tl),
        "align S=2001": lambda: aligner2.align(lp2, targets2, il2, tl2),
        "ctc_alignment_path": lambda: alignment.ctc_alignment_path(lp, targets, il, tl),
        "decode greedy": lambda: aligner.decode(lp, il),
        f"decode beam W={CTC_BEAM}": lambda: aligner.decode(lp, il, CTC_BEAM),
    }
    return out


def phase_ctc_timing(dev, kernel_inputs, ctc):
    """Rows 20-22 at the headline and rows 20, 21, 23 at S=2001 against
    their plain versions, ``F.ctc_loss`` forward and backward at both, the
    slice's entry points with their launches, and a profile of one loss
    step. Returns ``(times, launches, profile)``."""
    import torch
    import torch.nn.functional as F

    slow = dict(runs=3, warmup=1)
    times = {}
    for shape, (k, (log_probs, targets, il, tl)) in kernel_inputs.items():
        got, plain = _ctc_calls(k), _ctc_calls(k, reference=True)
        names = CTC_KERNELS[:2] + (CTC_KERNELS[2:] if shape == "headline" else CTC_KERNELS[3:])
        for name in names:
            times[f"{name} {shape}"] = (cuda_median_ms(got[name]), cuda_median_ms(plain[name], **slow))
        x = log_probs.detach().clone().requires_grad_(True)
        times[f"library F.ctc_loss forward {shape}"] = cuda_median_ms(
            lambda: F.ctc_loss(x, targets, il, tl, reduction="sum"))
        lib = F.ctc_loss(x, targets, il, tl, reduction="sum")
        times[f"library F.ctc_loss backward {shape}"] = cuda_median_ms(
            lambda: torch.autograd.grad(lib, x, retain_graph=True))
    launches = {}
    for name, fn in ctc["calls"].items():
        times[name] = cuda_median_ms(fn, **(slow if name.startswith("decode beam") else {}))
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[f"CTC {name}"] = {k: v for k, v in read_launches(KERNELS).items() if v}
    return times, launches, _profile(dev, ctc["calls"]["loss step"], n=3)


def _dtw_features(dev, gen, n):
    """``(n, DTW_D)`` standard normal features on the card."""
    import torch

    return torch.randn(n, DTW_D, device=dev, generator=gen)


def phase_dtw_kernel(dev, gen):
    """Row 19 against its plain version on the card, bit for bit (paths,
    length, cost): the JAX bench's 500x500 at D=80 in all three patterns,
    a ``ConstrainedDTWAligner`` band, the edge shapes, an integer matrix
    with forced ties, and a shape past the shared-memory table (the choices
    in device memory). Returns the max abs cost error, the case names and
    the 500x500 distance matrix."""
    import torch
    from pytorch_hmm_tpu_torch import ops
    from pytorch_hmm_tpu_torch.alignment import dtw as tdtw

    def dist(n, m):
        return tdtw.compute_distance_matrix(_dtw_features(dev, gen, n), _dtw_features(dev, gen, m))

    d500 = dist(DTW_N, DTW_N)
    cases = {f"{DTW_N}x{DTW_N} {p}": (d500, p) for p in ("symmetric", "asymmetric", "rabiner_juang")}
    cases[f"band={DTW_BAND}"] = (tdtw._bandwidth_mask(d500, DTW_BAND), "symmetric")
    for n, m in ((1, 1), (1, 300), (300, 1), (37, 23), (130, 40)):
        cases[f"{n}x{m}"] = (dist(n, m), "rabiner_juang" if n == 37 else "symmetric")
    cases["ties 200x150"] = (torch.randint(0, 3, (200, 150), device=dev, generator=gen).float(),
                             "symmetric")
    cases["2000x1800 device table"] = (dist(2000, 1800), "symmetric")
    err = 0.0
    for name, (d, pattern) in cases.items():
        got = ops.pallas_dtw(d, pattern)
        want = ops.pallas_dtw_reference(d, pattern)
        torch.cuda.synchronize(dev)
        for what, g, w in zip(("path_i", "path_j", "length"), got, want):
            check(torch.equal(g, w), f"pallas_dtw {name}: {what} differs from the plain version's")
        check(got[3].item() == want[3].item(),
              f"pallas_dtw {name}: cost {got[3].item()} vs plain {want[3].item()}")
        err = max(err, abs(got[3].item() - want[3].item()))
    return err, list(cases), d500


def phase_dtw_slice(dev):
    """The DTW entry points a user calls, at the JAX bench's width
    (standard normal (500, 80) features, euclidean): ``DTWAligner`` on one
    pair and on a batch of 4, ``ConstrainedDTWAligner(bandwidth=10)``,
    ``dtw_distance``, ``phoneme_audio_alignment`` (40 phonemes, 500 frames,
    cosine), each launching row 19 once per pair and never the plain
    wavefront; against the CPU twin: the distance matrices within
    tolerance, and the card's distances through the CPU's plain path
    identical. ``soft_dtw_alignment`` at 64x64 against the CPU."""
    from unittest import mock

    import torch
    from pytorch_hmm_tpu_torch import ConstrainedDTWAligner, DTWAligner, alignment
    from pytorch_hmm_tpu_torch.alignment import dtw as tdtw

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    out = {"launches": {}, "errs": {"distances": 0.0}}

    def run(tag, fn, pairs):
        reset_launches()
        with mock.patch.object(tdtw, "_dtw_wavefront", wraps=tdtw._dtw_wavefront) as plain:
            res = fn()
            torch.cuda.synchronize(dev)
        got = read_launches(("pallas_dtw", "bigk_log_likelihood"))
        out["launches"][tag] = got
        check(got["pallas_dtw"] == pairs and got["bigk_log_likelihood"] == 0,
              f"{tag}: pallas_dtw launched {got['pallas_dtw']} times for {pairs} pairs")
        check(plain.call_count == 0, f"{tag}: the plain wavefront ran {plain.call_count} times")
        return res

    def same_as_cpu(tag, got, x, y, metric="euclidean", band=None):
        """The card's distances within tolerance of the CPU's, and its path
        and cost equal the CPU plain path's on the card's distances."""
        d = tdtw.compute_distance_matrix(x, y, metric)
        d_cpu = tdtw.compute_distance_matrix(x.cpu(), y.cpu(), metric)
        err = (d.cpu() - d_cpu).abs().max().item()
        check(err <= DTW_DIST_ATOL + DTW_DIST_RTOL * d_cpu.abs().max().item(),
              f"{tag}: distances off the CPU's by {err}")
        out["errs"]["distances"] = max(out["errs"]["distances"], err)
        if band is not None:
            d = tdtw._bandwidth_mask(d, band)
        pi, pj, length, cost = tdtw.dtw_path_padded(d.cpu())
        n_pad = pi.shape[0] - int(length)
        check(torch.equal(got[0].cpu(), pi[n_pad:]) and torch.equal(got[1].cpu(), pj[n_pad:])
              and got[2].item() == cost.item(), f"{tag}: differs from the CPU plain path")

    x, y = _dtw_features(dev, gen, DTW_N), _dtw_features(dev, gen, DTW_N)
    aligner = DTWAligner()
    check(aligner.device.type == "cuda", "DTWAligner did not default to the card")
    pair = run("DTWAligner pair", lambda: aligner(x, y), 1)
    same_as_cpu("DTWAligner pair", pair, x, y)

    xb = torch.randn(DTW_BATCH, DTW_N, DTW_D, device=dev, generator=gen)
    yb = torch.randn(DTW_BATCH, DTW_N, DTW_D, device=dev, generator=gen)
    paths_i, paths_j, costs = run(f"DTWAligner batch of {DTW_BATCH}", lambda: aligner(xb, yb),
                                  DTW_BATCH)
    for b in range(DTW_BATCH):
        same_as_cpu(f"DTWAligner batch row {b}", (paths_i[b], paths_j[b], costs[b]), xb[b], yb[b])

    band = ConstrainedDTWAligner(bandwidth=DTW_BAND)
    got = run(f"ConstrainedDTWAligner(bandwidth={DTW_BAND})", lambda: band(x, y), 1)
    same_as_cpu("ConstrainedDTWAligner", got, x, y, band=DTW_BAND)

    cost = run("dtw_distance", lambda: alignment.dtw_distance(x, y), 1)
    check(cost.item() == pair[2].item(), "dtw_distance differs from DTWAligner's cost")

    ph = _dtw_features(dev, gen, DTW_PHONEMES)
    align, bounds_ = run("phoneme_audio_alignment", lambda: alignment.phoneme_audio_alignment(ph, x), 1)
    d_cos = tdtw.compute_distance_matrix(ph, x, "cosine")
    with mock.patch.object(tdtw, "compute_distance_matrix", return_value=d_cos.cpu()):
        want = alignment.phoneme_audio_alignment(ph.cpu(), x.cpu())
    check(torch.equal(align.cpu(), want[0]) and torch.equal(bounds_.cpu(), want[1]),
          "phoneme_audio_alignment differs from the CPU on the card's distances")
    durations = alignment.extract_phoneme_durations(align, DTW_PHONEMES)
    check(int(durations.sum()) == DTW_N, f"phoneme durations sum to {int(durations.sum())}")
    out["phonemes aligned"] = int((durations > 0).sum())

    xs, ys = _dtw_features(dev, gen, DTW_SOFT), _dtw_features(dev, gen, DTW_SOFT)
    soft, soft_cost = run("soft_dtw_alignment 64x64", lambda: alignment.soft_dtw_alignment(xs, ys), 0)
    soft_cpu, soft_cost_cpu = alignment.soft_dtw_alignment(xs.cpu(), ys.cpu())
    out["errs"]["soft alignment"] = (soft.cpu() - soft_cpu).abs().max().item()
    out["errs"]["soft cost rel"] = abs(soft_cost.item() - soft_cost_cpu.item()) / abs(soft_cost_cpu.item())
    check(out["errs"]["soft alignment"] <= DTW_SOFT_ATOL and out["errs"]["soft cost rel"] <= DTW_SOFT_RTOL,
          f"soft_dtw_alignment off the CPU: {out['errs']}")

    out["calls"] = {
        "bench DTW call": lambda: tdtw.dtw_path_padded(tdtw.compute_distance_matrix(x, y)),
        "DTWAligner pair": lambda: aligner(x, y),
        f"DTWAligner batch of {DTW_BATCH}": lambda: aligner(xb, yb),
        f"ConstrainedDTWAligner(bandwidth={DTW_BAND})": lambda: band(x, y),
        "dtw_distance": lambda: alignment.dtw_distance(x, y),
        "phoneme_audio_alignment": lambda: alignment.phoneme_audio_alignment(ph, x),
    }
    return out


def _bigk_problem(dev, gen, b, t, k):
    """The JAX bench's scoring data (bench.py:542-570): standard normal
    log-obs, ``log_softmax`` of standard normal transitions, a uniform
    prior."""
    import torch

    lo = torch.randn(b, t, k, device=dev, generator=gen)
    la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
    lp = torch.full((k,), -math.log(k), device=dev)
    return lo, la, lp


def phase_bigk_kernel(dev, gen):
    """Row 15 against its plain version on the card (the JAX bench's
    K=512 shape, K=1024, and shapes whose B and K are off the kernel's
    16-row and 64-state tiles, K=12), and two of them against float64
    ``core.log_likelihood``. Returns the max abs errors and the inputs of
    the two timed shapes."""
    import torch
    from pytorch_hmm_tpu_torch import core, ops

    cases = {**BIGK_SHAPES, "8x256x256": (8, 256, 256), "5x384x96": (5, 384, 96), "3x128x33": (3, 128, 33),
             "K=12": (4, 256, 12), **BIGK_CLUSTER_CASES}
    errs, inputs = {}, {}
    for name, (b, t, k) in cases.items():
        args = _bigk_problem(dev, gen, b, t, k)
        got = ops.bigk_log_likelihood(*args)
        want = ops.bigk_log_likelihood_reference(*args)
        torch.cuda.synchronize(dev)
        check(bool(torch.isfinite(got).all()), f"bigk_log_likelihood {name}: non-finite")
        err = (got - want).abs()
        errs[name] = err.max().item()
        check(bool((err <= BIGK_ATOL + BIGK_PLAIN_RTOL * want.abs()).all()),
              f"bigk_log_likelihood {name}: max abs err {errs[name]} vs plain")
        if name in ("K=512", "8x256x256", "K=1000"):
            rows = slice(0, BIGK_F64_ROWS)
            lo, la, lp = (a.double() for a in args)
            exact = core.log_likelihood(lo[rows], la, lp)
            err64 = (got[rows].double() - exact).abs()
            errs[f"{name} vs float64"] = err64.max().item()
            check(bool((err64 <= BIGK_ATOL + BIGK_RTOL * exact.abs()).all()),
                  f"bigk_log_likelihood {name}: {errs[f'{name} vs float64']} off float64")
        if name in BIGK_SHAPES:
            inputs[name] = args
    # Log-obs in a contiguous view that starts 4 bytes past an aligned
    # address: K % 4 == 0, but the kernel must read them with scalar loads.
    lo, la, lp = _bigk_problem(dev, gen, *BIGK_OFFSET_VIEW)
    view = torch.empty(lo.numel() + 1, device=dev)[1:].view(lo.shape)
    view.copy_(lo)
    got, want = ops.bigk_log_likelihood(view, la, lp), ops.bigk_log_likelihood_reference(lo, la, lp)
    err = (got - want).abs()
    errs["offset view"] = err.max().item()
    check(bool((err <= BIGK_ATOL + BIGK_PLAIN_RTOL * want.abs()).all()),
          f"bigk_log_likelihood offset view: max abs err {errs['offset view']} vs plain")
    return errs, inputs


def phase_bigk_scoring(dev, inputs):
    """``ops.bigk_log_likelihood`` as a user calls it, at both timed
    shapes (row 15 once each) and at T=2000, off the 128-frame chunk grid
    (row 15 never, ``pallas_forward`` once). Returns launch counts."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    names = ("bigk_log_likelihood", "pallas_forward", "pallas_dtw")
    cases = [(f"scoring {k}", a, {"bigk_log_likelihood": 1}) for k, a in inputs.items()]
    lo, la, lp = inputs["K=512"]
    cases.append(("scoring T=2000", (lo[:, :2000].contiguous(), la, lp), {"pallas_forward": 1}))
    launches = {}
    for tag, args, want in cases:
        reset_launches()
        z = ops.bigk_log_likelihood(*args)
        torch.cuda.synchronize(dev)
        got = read_launches(names)
        launches[tag] = got
        check(all(got[n] == want.get(n, 0) for n in names), f"{tag}: launches {got}")
        check(z.shape == (args[0].shape[0],) and bool(torch.isfinite(z).all()), f"{tag}: bad output")
    return launches


def phase_bigk_cluster(dev):
    """Row 15's cluster plan at each timed K, the clusters the card holds
    at once, and what a cluster barrier costs alone and after a frame's q
    exchange (the probe: one cluster of CS CTAs running N barriers; the
    difference of two N over their difference)."""
    import ctypes

    import torch
    from pytorch_hmm_tpu_torch import ops
    from pytorch_hmm_tpu_torch.ops import _build
    from pytorch_hmm_tpu_torch.ops import bigk as tbigk

    lib = _build.Library("bigk_scoring", {"bigk_cluster_probe": [ctypes.c_int] * 4 + [ctypes.c_void_p]})
    out = {"plans": {}, "barrier_us": {}}
    for name, (b, _, k) in {**BIGK_SHAPES, **BIGK_CLUSTER_CASES}.items():
        plan = tbigk.cluster_plan(k, b)
        out["plans"][name] = (plan, tbigk.active_clusters(k, plan, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    for name, (b, t, k) in BIGK_CLUSTER_CASES.items():
        args = _bigk_problem(dev, gen, b, t, k)
        out[f"bigk_log_likelihood {name}"] = cuda_median_ms(lambda: ops.bigk_log_likelihood(*args), runs=5)
    for cs in sorted({p.cs for p, _ in out["plans"].values()}):
        for push in (0, 1):
            def run(iters, cs=cs, push=push):
                lib.launch("bigk_cluster_probe", "cluster probe", cs, iters, push)
            lo_ms, hi_ms = (cuda_median_ms(lambda n=n: run(n), runs=5) for n in PROBE_ITERS)
            out["barrier_us"][(cs, push)] = (hi_ms - lo_ms) * 1e3 / (PROBE_ITERS[1] - PROBE_ITERS[0])
    return out


def phase_dtw_bigk_timing(dev, d500, dtw, bigk_inputs):
    """Rows 19 (500x500) and 15 (both shapes) and their plain versions, the
    DTW entry points with their launches. Returns ``(times, launches)``."""
    import torch
    from pytorch_hmm_tpu_torch import ops

    slow = dict(runs=3, warmup=1)
    times = {"pallas_dtw": (cuda_median_ms(lambda: ops.pallas_dtw(d500)),
                            cuda_median_ms(lambda: ops.pallas_dtw_reference(d500), **slow))}
    for name, args in bigk_inputs.items():
        times[f"bigk_log_likelihood {name}"] = (
            cuda_median_ms(lambda: ops.bigk_log_likelihood(*args)),
            cuda_median_ms(lambda: ops.bigk_log_likelihood_reference(*args), **slow))
    launches = {}
    for name, fn in dtw["calls"].items():
        times[f"DTW {name}"] = cuda_median_ms(fn)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[f"DTW {name}"] = {k: v for k, v in read_launches(KERNELS).items() if v}
    return times, launches


def dq_work(rows, d, n):
    """Bytes and float32 operations of row 1 over ``rows`` rows: x, Wq,
    Wl, b in; ``(rows, n)`` out; x², two products, the bias."""
    return 4 * (rows * d + 2 * d * n + n + rows * n), rows * d + 4 * rows * d * n + rows * n


def dtw_work(n, m):
    """Bytes and float32 operations of row 19 on an ``(n, m)`` matrix: the
    distances in, both paths, the length and the cost out; per cell three
    adds and two minima."""
    return 4 * (n * m + 2 * (n + m - 1) + 2), 5 * n * m


def bigk_work(b, t, k):
    """Bytes and operations of row 15 at ``(b, t, k)``: log-obs, log_a and
    log_pi in, ``(b,)`` out; per frame after the first a ``(b, k) @ (k, k)``
    bf16 product (two operations a multiply-add, at the bf16 peak) and per
    element the max, subtract, exp and multiply (float32). Returns
    ``(bytes, seconds of operations)`` for :func:`_bound_s`."""
    nbytes = 4 * (b * t * k + k * k + k + b)
    return nbytes, 2 * b * (t - 1) * k * k / BF16_OPS_PER_S + 4 * b * t * k / F32_OPS_PER_S


def ctc_work(b, t, s):
    """Bytes and float32 operations of rows 20-23 on ``b`` full-length rows
    of ``t`` frames over an ``s``-position lattice: ``lp`` and the three
    ``(B, S)`` rows and the lengths in; the table out (forward, backward),
    or the positions and scores out (Viterbi, with the two end positions
    in). Per cell the sum chains take the three-way logsumexp (two max,
    three subtracts, three exps, two adds, a log and an add), the skip
    mask, the emission and the validity mask: 14; the trellis two max,
    three adds and two compares: 7."""
    f, cells, rows = 4, b * t * s, b * s
    sums = (f * (2 * cells + 3 * rows + b), 14 * cells)
    vit = (f * (cells + 3 * rows + 3 * b + b * t + b), 7 * cells)
    return {"ctc_lattice_forward": sums, "ctc_lattice_backward": sums,
            "ctc_lattice_viterbi": vit, "ctc_lattice_viterbi_wide": vit}


def prob_work(b, t, k):
    """Bytes and float32 operations of rows 10-12 at ``(b, t, k)``: log-obs,
    P and (forward) log_pi in, each table (and log Z) out; per frame and
    state a K-long multiply-add, then the exp, the multiply, the log and
    the shift's add."""
    f, bk = 4, b * t * k
    ops_ = 2 * bk * k + 4 * bk
    return {
        "pallas_forward_prob": (f * (bk + k * k + k + bk + b), ops_),
        "pallas_backward_prob": (f * (bk + k * k + bk), ops_),
        "pallas_fb_prob": (f * (bk + k * k + k + 2 * bk + b), 2 * ops_),
    }


def _bound_s(nbytes, ops_seconds):
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    HBM rate and the operations' seconds at their peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_seconds * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound(nbytes, ops_):
    """:func:`_bound_s` of float32 operations."""
    return _bound_s(nbytes, ops_ / F32_OPS_PER_S)


def bounds(inputs, neural_inputs, genk_inputs, prob_inputs):
    """Each kernel's least time on the card for this run's timed inputs,
    ``(ms, "bytes" or "operations")``: the larger of the bytes it must
    move (each input read once, each output written once) over the HBM
    rate and its float32 operations over the float32 peak. Operations
    are counted as the algorithm needs them: one per add, compare, exp
    or multiply; a product's multiply-add counts two."""
    B_, T_, K_, D_, N_ = B, T, S, D, S * C
    HB_, HT_, HS_, HD_ = HB, HT, HS, HD
    (beam, la, lo, _fleets) = inputs
    emit, tv_lo, tv_la = neural_inputs
    glo = genk_inputs["scan"][0]
    gb, gt, gk = glo.shape
    gbt, gbk = gb * gt, glo.numel()
    fobs, fmeans = genk_inputs["gmm"][0], genk_inputs["gmm"][1]
    fb, ft, _ = fobs.shape
    fs, fc, _ = fmeans.shape
    er, es = emit[0].shape[0] * emit[0].shape[1], emit[9].shape[1]   # rows, states
    n_valid = beam[2]
    beam_n, beam_t, beam_s = beam[1].shape
    bt, bk = B_ * T_, B_ * T_ * K_
    hbt, hbk = HB_ * HT_, HB_ * HT_ * HS_
    f = 4   # bytes of a float32 or int32
    work = {
        "diag_quadratic": dq_work(bt, D_, N_),
        # log-obs, log_a, log_pi in; states, score out. Add and max per
        # predecessor, then the emission.
        "smallk_viterbi": (f * (bk + K_ * K_ + K_ + bt + B_), 2 * bk * K_ + bk),
        # Two chains (add, exp, sum per predecessor; log and emission per
        # state); alpha, beta, log Z out.
        "fbsum_smallk": (f * (bk + K_ * K_ + K_ + 2 * bk + B_), 2 * (3 * bk * K_ + 2 * bk)),
        "hsmm_smallk_forward": (f * (bk + K_ * K_ + 2 * K_ + bk + B_), 3 * bk * K_ + 2 * bk),
        "hsmm_smallk_backward": (f * (bk + K_ * K_ + K_ + 2 * bk), 3 * bk * K_ + 2 * bk),
        # Segment DP at general D: per frame and state, the S-way entry
        # over predecessors and D durations (window sum, duration score,
        # and max or add/exp/sum).
        "hsmm_smallk_viterbi": (f * (hbk + HS_ * HS_ + HS_ + HS_ * HD_ + hbt + HB_),
                                hbk * (2 * HS_ + 3 * HD_)),
        "hsmm_smallk_forward_general": (f * (hbk + HS_ * HS_ + HS_ + HS_ * HD_ + hbk + HB_),
                                        hbk * (3 * HS_ + 4 * HD_)),
        "hsmm_smallk_backward_general": (f * (hbk + HS_ * HS_ + HS_ * HD_ + 2 * hbk),
                                         hbk * (3 * HS_ + 4 * HD_)),
        "hsmm_smallk_fb": (f * (hbk + HS_ * HS_ + HS_ + HS_ * HD_ + 3 * hbk + HB_),
                           2 * hbk * (3 * HS_ + 4 * HD_)),
        # log_a, log-obs, n_valid and the carry in; states, scores, carry
        # out. An add and a compare per state and frame.
        "greedy_chunk": (f * (SS * SS + lo.numel() + 3 + 2 * lo.shape[0] + 2),
                         2 * lo.numel()),
        # log_a, log-obs, n_valid, scores, states, paths, path_len in, the
        # carry out. Per valid frame: two adds and a compare per (slot,
        # state), then W compares per state for the top W.
        "beam_chunk_multi": (
            f * (beam_s * beam_s + beam[1].numel() + 2 * beam_n * (2 * SW + SW * SH + 1) + beam_n),
            beam_n * n_valid * 4 * SW * beam_s),
        # obs, the 13 weights and tables in; (R, S) scores out. The four
        # layers' and three head products' multiply-adds, then per row and
        # feature the centring, exp and products (about 8), and per score
        # the clamp and the sums (about 6).
        "fused_gaussian_emission": (
            f * (sum(t.numel() for t in emit) + er * es),
            2 * er * (ND * NH + NH * NH + 2 * NH * ND + 3 * ND * es) + 8 * er * ND + 6 * er * es),
        # The time-varying modes read a (K, K) matrix a frame as well.
        "smallk_viterbi tv": (f * (tv_lo.numel() + tv_la.numel() + NS + NB * NT + NB),
                              2 * tv_lo.numel() * NS + tv_lo.numel()),
        "fbsum_smallk tv": (f * (tv_lo.numel() + tv_la.numel() + NS + 2 * tv_lo.numel() + NB),
                            2 * (3 * tv_lo.numel() * NS + 2 * tv_lo.numel())),
        # log-obs, P (or log_a), log_pi in; alpha and log Z, beta, or states
        # and score out. Per frame and state a K-long multiply-add (sum
        # chains) or add-and-compare (trellis), then the exp, log and
        # emission (sum chains) or the emission (trellis).
        "pallas_forward": (f * (gbk + gk * gk + gk + gbk + gb), 2 * gbk * gk + 3 * gbk),
        "pallas_backward": (f * (gbk + gk * gk + gbk), 2 * gbk * gk + 3 * gbk),
        "pallas_viterbi": (f * (gbk + gk * gk + gk + gbt + gb), 2 * gbk * gk + gbk),
        # obs, the diag parameters, log_a, log_pi in; states and score out.
        # The emission's x² and two multiply-adds per (frame, state,
        # component, feature), the C-way logsumexp (max, exp, add), then
        # the trellis.
        "fused_gmm_viterbi": (f * (fobs.numel() + 2 * fmeans.numel() + fs * fc + fs * fs + fs
                                   + fb * ft + fb),
                              fb * ft * fs * fc * (4 * fmeans.shape[-1] + 3) + 2 * fb * ft * fs * fs),
        **prob_work(*prob_inputs[0].shape),
    }
    return {name: _bound(*w) for name, w in work.items()}


def phase_timing(dev, gen, layer, obs, train, dur, dur_train):
    import torch
    from pytorch_hmm_tpu_torch import ops

    n = S * C
    x = torch.randn(B, T, D, device=dev, generator=gen)
    wq = torch.rand(D, n, device=dev, generator=gen) + 0.5
    wl = torch.randn(D, n, device=dev, generator=gen)
    bias = torch.randn(n, device=dev, generator=gen)
    lo = torch.randn(B, T, S, device=dev, generator=gen)
    la = torch.log_softmax(torch.randn(S, S, device=dev, generator=gen), -1)
    lp = torch.log_softmax(torch.randn(S, device=dev, generator=gen), -1)
    ld = torch.zeros(S, 1, device=dev)
    slow = dict(runs=PLAIN_SUM_RUNS, warmup=1)
    tl, tobs = train["layer"], train["obs"]

    def step():
        tl.zero_grad()
        tl.compute_loss(tobs).backward()

    hsmm, hobs = dur["hsmm"], dur["obs"]
    with torch.no_grad():
        hlo, hla, hlp, hld = (t.contiguous() for t in hsmm._dp_args(hobs))
    hl = dur_train["layer"]

    def hsmm_step():
        hl.zero_grad()
        hl.compute_loss(hobs).backward()

    times = {
        "hsmm_smallk_viterbi": (
            cuda_median_ms(lambda: ops.hsmm_smallk_viterbi(hlo, hla, hlp, hld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_viterbi_reference(hlo, hla, hlp, hld), **slow)),
        "hsmm_smallk_fb": (
            cuda_median_ms(lambda: ops.hsmm_smallk_fb(hlo, hla, hlp, hld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_fb_reference(hlo, hla, hlp, hld), **slow)),
        "hsmm_smallk_forward_general": (
            cuda_median_ms(lambda: ops.hsmm_smallk_forward_general(hlo, hla, hlp, hld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_forward_general_reference(hlo, hla, hlp, hld),
                           **slow)),
        "hsmm_smallk_backward_general": (
            cuda_median_ms(lambda: ops.hsmm_smallk_backward_general(hlo, hla, hld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_backward_general_reference(hlo, hla, hld),
                           **slow)),
        "diag_quadratic": (cuda_median_ms(lambda: ops.diag_quadratic(x, wq, wl, bias)),
                           cuda_median_ms(lambda: ops.diag_quadratic_reference(x, wq, wl, bias))),
        "smallk_viterbi": (cuda_median_ms(lambda: ops.smallk_viterbi(lo, la, lp)),
                           cuda_median_ms(lambda: ops.smallk_viterbi_reference(lo, la, lp))),
        "fbsum_smallk": (cuda_median_ms(lambda: ops.fbsum_smallk(lo, la, lp)),
                         cuda_median_ms(lambda: ops.fbsum_smallk_reference(lo, la, lp), **slow)),
        "hsmm_smallk_forward": (
            cuda_median_ms(lambda: ops.hsmm_smallk_forward(lo, la, lp, ld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_forward_reference(lo, la, lp, ld), **slow)),
        "hsmm_smallk_backward": (
            cuda_median_ms(lambda: ops.hsmm_smallk_backward(lo, la, ld)),
            cuda_median_ms(lambda: ops.hsmm_smallk_backward_reference(lo, la, ld), **slow)),
    }
    # The library call for row 1: one torch.addmm of [x², x] @ [Wq; Wl] + b
    # computes the same function (the port never calls it).
    xx = torch.cat([x * x, x], dim=-1).reshape(B * T, 2 * D)
    w2 = torch.cat([wq, wl], dim=0)
    lib = torch.addmm(bias, xx, w2).reshape(B, T, n)
    check(torch.allclose(lib, ops.diag_quadratic(x, wq, wl, bias), atol=DQ_ATOL, rtol=DQ_RTOL),
          "torch.addmm disagrees with diag_quadratic")
    times["library diag_quadratic"] = cuda_median_ms(lambda: torch.addmm(bias, xx, w2))
    # Row 1's device time beside the same of its plain version and of
    # torch.addmm, at N=48, 64 (GaussianHMMLayer(64, 80)) and 256 (S=64,
    # C=4): the calls above carry the host's enqueue, which at ~0.02-0.05
    # ms is most of a call. Call times at N=64 and 256 ride beside them.
    wide = {"N=48": (x, wq, wl, bias, xx, w2)}
    for n_ in DQ_DEVICE_N:
        g_ = torch.Generator(device=dev).manual_seed(SEED + 19 + n_)
        xa = torch.randn(B, T, D, device=dev, generator=g_)
        qa = torch.rand(D, n_, device=dev, generator=g_) + 0.5
        la = torch.randn(D, n_, device=dev, generator=g_)
        ba = torch.randn(n_, device=dev, generator=g_)
        xxa = torch.cat([xa * xa, xa], dim=-1).reshape(B * T, 2 * D)
        wa = torch.cat([qa, la], dim=0)
        check(torch.allclose(torch.addmm(ba, xxa, wa).reshape(B, T, n_),
                             ops.diag_quadratic(xa, qa, la, ba), atol=DQ_ATOL, rtol=DQ_RTOL),
              f"torch.addmm disagrees with diag_quadratic at N={n_}")
        wide[f"N={n_}"] = (xa, qa, la, ba, xxa, wa)
    for tag, (xa, qa, la, ba, xxa, wa) in wide.items():
        times[f"diag_quadratic device {tag}"] = graph_ms(lambda: ops.diag_quadratic(xa, qa, la, ba))
        times[f"diag_quadratic plain device {tag}"] = graph_ms(
            lambda: ops.diag_quadratic_reference(xa, qa, la, ba))
        times[f"library diag_quadratic device {tag}"] = graph_ms(lambda: torch.addmm(ba, xxa, wa))
        if tag != "N=48":
            times[f"diag_quadratic call {tag}"] = cuda_median_ms(lambda: ops.diag_quadratic(xa, qa, la, ba))
            times[f"library diag_quadratic call {tag}"] = cuda_median_ms(lambda: torch.addmm(ba, xxa, wa))
    calls = {
        "decode": lambda: layer(obs, return_log_probs=True),
        "compute_loss step": step,
        "em_step": lambda: train["em_layer"].em_step(tobs),
        "HSMM decode": lambda: hsmm(hobs),
        "HSMM posteriors": lambda: hsmm.posteriors(hobs),
        "HSMM compute_loss step": hsmm_step,
        "HSMM em_step": lambda: dur_train["em_layer"].em_step(hobs),
    }
    launches = {}
    for name, fn in calls.items():
        times[name] = cuda_median_ms(fn)
        reset_launches()
        fn()
        torch.cuda.synchronize(dev)
        launches[name] = {k: v for k, v in read_launches(KERNELS).items() if v}
    return times, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import pytorch_hmm_tpu_torch

    pkg_root = Path(pytorch_hmm_tpu_torch.__file__).resolve().parent.parent
    check(pkg_root == HERE, f"pytorch_hmm_tpu_torch imported from {pkg_root}, not this checkout")
    check("jax" not in sys.modules, "the port imported jax")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"nvidia-smi: {card}", flush=True)

    seconds, libs = phase_build()
    print(f"build: {seconds:.1f} s for {', '.join(libs)} (nvcc, sm_90a, in parallel)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    dq_errs = phase_diag_quadratic(dev, gen)
    print("diag_quadratic vs plain: ok, max abs err "
          + ", ".join(f"{k}: {v:.3g}" for k, v in dq_errs.items())
          + f" (atol {DQ_ATOL}, rtol {DQ_RTOL}, TF32 off)", flush=True)
    mix_errs, mix_times, mix_launches = phase_mixture_epilogue(
        dev, torch.Generator(device=dev).manual_seed(SEED + 18))
    print("mixture epilogue (row 1's mixture mode, gmm_log_probs on the card) vs row 1 + the plain "
          f"epilogue: ok; per case the share of the tolerance (atol {MIX_ATOL} at |score| <= "
          f"{MIX_SCALE}, in proportion above) and the max abs err vs float64 of the fused / the "
          "composite result: " + "; ".join(f"{k} {MIX_CASES.get(k.split(' tied')[0])} {a:.3g}, "
                                           f"{b:.3g} / {c:.3g}" for k, (a, b, c) in mix_errs.items()),
          flush=True)
    print(f"timing mixture epilogue at gmm.decode.b4096's shape (B, T, S, C, D = "
          f"{MIX_CASES['cell']}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in mix_times.items())
          + f" (median of {TIMED_RUNS}, CUDA events); mixture_launches a gmm_log_probs call "
          f"{mix_launches}; on {card}", flush=True)
    bf16_errs, bf16_dq = phase_bf16_scoring(dev)
    print(f"bf16 scoring (gmm_log_probs, compute_dtype=bfloat16, B={B} T={T} S={S} C={C} D={D}; full "
          "from the card's prepared tables) on the "
          "card vs the CPU: ok, max abs err " + ", ".join(f"{k}: {v:.3g}" for k, v in bf16_errs.items())
          + f" (atol {BF16_CARD_ATOL}, rtol {BF16_CARD_RTOL}); plain torch on the card, diag_quadratic "
          f"launches {bf16_dq} (row 1 has no bf16 mode)", flush=True)

    vit = phase_smallk_viterbi(dev, gen)
    vit_err = vit["headline"][4]
    print(f"smallk_viterbi vs plain and float64: ok on {len(vit)} cases; per case the kernel's and "
          "the plain float32 version's worst score error vs float64 as shares of the tolerance "
          f"(rtol {VIT_F64_RTOL:.3g} + {VIT_F64_ATOL_FRAME} a frame), the kernel's worst path gap "
          f"(limit {VIT_PATH_GAP} nats) and rows off the plain path: "
          + "; ".join(f"{k} {a:.3g} / {b:.3g}, gap {g:.3g}, {n} rows" for k, (a, b, g, n, _) in vit.items()),
          flush=True)

    sum_errs = phase_sum_kernels(dev, gen)
    print("fbsum_smallk, hsmm_smallk_forward/backward (D=1) vs plain: ok on 5 cases "
          "(headline, K=32, ragged with a length-1 row, T=1, left-to-right with -inf); "
          "headline max abs err " + ", ".join(f"{k}: {v:.3g}" for k, v in sum_errs.items())
          + f" (atol {SUM_ATOL} + rtol {SUM_RTOL})", flush=True)

    layer, obs, dec_launches, agreement = phase_decode(dev)
    print(f"decode (B={B}, T={T}, S={S}, C={C}, D={D}): ok, launches {dec_launches}, "
          f"frame agreement with CPU {agreement}", flush=True)

    train = phase_training(dev)
    print(f"training (B={B}, T={T}, S={S}, C={C}, D={D}, diag): ok, launches {train['launches']}, "
          f"Adam losses {train['losses']}, em_step log-likelihoods {train['lls']}", flush=True)
    print("training vs CPU float64 (relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in train["errs"].items())
          + f" (loss/ll rtol {LOSS_RTOL}, grad rtol {GRAD_RTOL}, EM rtol {EM_RTOL})", flush=True)

    hsmm_errs, hsmm_cases = phase_hsmm_kernels(dev, gen)
    print(f"hsmm_smallk_viterbi vs plain: ok, paths and scores identical on {len(hsmm_cases)} "
          f"cases ({', '.join(hsmm_cases)}); headline max abs score err "
          f"{hsmm_errs['hsmm_smallk_viterbi']:.3g}", flush=True)
    print("hsmm_smallk_fb, hsmm_smallk_forward/backward_general vs plain: ok on the same cases; "
          "headline max abs err " + ", ".join(f"{k}: {v:.3g}" for k, v in hsmm_errs.items()
                                              if k != "hsmm_smallk_viterbi")
          + f" (atol {HSMM_SUM_ATOL} + rtol {HSMM_SUM_RTOL})", flush=True)
    for what, r in phase_hsmm_probe(dev, torch.Generator(device=dev).manual_seed(SEED + 13)).items():
        print(probe_line(what, r, card), flush=True)
    grads_errs, grads_times = phase_table_grads(dev, torch.Generator(device=dev).manual_seed(SEED + 14))
    for case, e in grads_errs.items():
        print(f"hsmm_table_grads vs plain {case} {TABLE_GRADS_CASES[case][:4]}: ok, bit-identical "
              "twice; max abs err over max |g| (d_log_obs) or the tensor's largest entry, kernel vs "
              "plain / kernel vs float64 / plain vs float64: "
              + ", ".join(f"{n} {a:.3g} / {b_:.3g} / {c:.3g}" for n, (a, b_, c) in e.items())
              + f" (limits {TABLE_GRADS_OBS_ATOL}, {TABLE_GRADS_RTOL}; float64 within "
              f"{TABLE_GRADS_F64}x the plain's)", flush=True)
    for case, (ms, plain, (b_ms, b_by)) in grads_times.items():
        print(f"timing hsmm_table_grads {case} {TABLE_GRADS_CASES[case][:4]}: {ms:.4f} ms kernel "
              f"(two launches), {plain:.4f} ms plain torch, bound {b_ms:.6f} ms ({b_by}) (median, "
              f"CUDA events) on {card}", flush=True)

    dur = phase_duration_decode(dev)
    print(f"duration-model decode (HSMMLayer B={HB}, T={HT}, S={HS}, D={HD}, F={HF}; "
          f"SemiMarkovHMM B={SEMI_B}, T={SEMI_T}): ok, launches {dur['launches']}, "
          f"frame agreement with CPU {dur['agreement']}", flush=True)

    dur_train = phase_duration_training(dev, dur["obs"], dur["lengths"])
    print(f"duration-model training (HSMMLayer B={HB}, T={HT}, S={HS}, D={HD}, F={HF}): ok, "
          f"launches {dur_train['launches']}, em_step log-likelihoods {dur_train['lls']}", flush=True)
    print("duration-model posteriors and training vs CPU float64 (posteriors max abs; gradients "
          "and EM relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in dur_train["errs"].items())
          + f" (posteriors atol {HSMM_POST_ATOL}, grad rtol {HSMM_GRAD_RTOL}, "
          f"EM rtol {HSMM_EM_RTOL})", flush=True)

    stream_errs, beam_cases, greedy_cases = phase_stream_kernels(dev, gen)
    print(f"beam_chunk_multi vs plain: ok, scores, states, paths and path_len identical on "
          f"{len(beam_cases)} cases ({', '.join(beam_cases)}); greedy_chunk vs plain: ok, states, "
          f"scores and carry identical on {len(greedy_cases)} cases (T, S, n_valid in "
          f"(160, 12, 160), (160, 128, 150), (1024, 12, 1000), (8, 3, 3), with and without "
          f"has_prev); max abs score err {stream_errs}", flush=True)

    serve = phase_streaming_serve(dev)
    for mode, r in serve.items():
        print(f"streaming serve ({mode}, StreamingHMMProcessor({SS}, {SF}, chunk_size={SCHUNK}), "
              f"{STREAM_CHUNKS} chunks and a flush): ok, {r['chunks']} decoded chunks, "
              f"{r['frames']} frames, launches {r['launches']}, frame agreement with CPU "
              f"{r['agreement']}, max confidence err {r['conf_err']:.3g}", flush=True)

    fleets = phase_fleets(dev)
    print(f"fleets (MultiStreamDecoder N={FLEETS}, 3 chunks each vs single-stream processors on the "
          f"card; PCM fleet N={FLEETS[0]} and single-stream PCM step, 3 chunks vs CPU): ok, launches "
          f"{fleets['launches']}, frame agreement {fleets['agreement']}, max confidence err "
          f"{fleets['conf_err']}", flush=True)

    emit_errs = phase_emit_mlp(dev, gen)
    print(f"fused_gaussian_emission vs plain: ok on {len(EMIT_CASES)} cases (B, T, D, H, S): "
          + ", ".join(f"{k} {EMIT_CASES[k]}: {v:.3g}" for k, v in emit_errs.items())
          + f" max abs err (rtol/atol {EMIT_TOL}, TF32 off); its Function's gradients vs autograd "
          "through the plain version: ok", flush=True)
    tv_errs, tv_cases = phase_tv_kernels(dev, gen)
    print(f"smallk_viterbi time-varying vs plain and float64: ok on {len(tv_cases)} cases "
          f"({', '.join(tv_cases)}); fbsum_smallk time-varying vs plain: ok on the same "
          f"cases; headline max abs err {tv_errs} (the Viterbi's scores vs float64; fbsum's vs "
          f"plain, atol {SUM_ATOL} + rtol {SUM_RTOL})", flush=True)
    neural = phase_neural(dev)
    for name in NEURAL_KERNELS:
        print(f"{name} (B={NB}, T={NT}, S={NS}, D={ND}, H={NH}): ok, launches "
              f"{neural['launches'][name]}, time-varying launches {neural['tv_launches'][name]}, "
              f"decode frame agreement with CPU {neural['agreement'][name]}, Adam losses "
              f"{neural['losses'][name]}", flush=True)
    print(f"transformer / rnn transitions (B=4, T={SMALL_T}) and SemiMarkovHMM neural emissions "
          f"(B={NB}, T={SEMI_T}, S={HS}, D={HD}): ok, launches "
          f"{neural['launches']['SemiMarkovHMM neural']}, decode frame agreement "
          + ", ".join(f"{k}: {v}" for k, v in neural["agreement"].items()
                      if k not in NEURAL_KERNELS), flush=True)
    att = phase_neural_attention(dev)
    print(f"ContextualNeuralHMM transformer transitions (S={NS}, D={ND}, H={NH}, 3 blocks of 8 "
          f"heads, T={ATTN_T}, ragged): {att['launches']} attention launches a step "
          f"({', '.join(att['kernels'])}), at B={ATTN_B} forward {att['forward_ms']:.3f} ms, "
          f"backward {att['backward_ms']:.3f} ms a step (profiled); counters ok "
          f"(attention_varlen_calls +{att['varlen_calls']}, attention_pairs_skipped +{att['pairs_skipped']}); "
          f"the old einsum path fits B="
          f"{att['largest_b']} at most (tried {ATTN_SWEEP}); a step at that B: einsum "
          f"{att['einsum'][0]:.2f} ms, peak +{att['einsum'][1]} B; fused {att['fused'][0]:.2f} ms, "
          f"peak +{att['fused'][1]} B; fused at B={ATTN_SWEEP[0]} {att['fused_b512'][0]:.2f} ms, "
          f"peak +{att['fused_b512'][1]} B (median of 3, CUDA events)", flush=True)
    print("neural models vs CPU float64 (posteriors max abs; log-likelihood max rel; gradients "
          "relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in neural["errs"].items())
          + f" (posteriors atol {NEURAL_POST_ATOL}, ll rtol {LOSS_RTOL}, grad rtol "
          f"{NEURAL_GRAD_RTOL})", flush=True)

    scan_errs, scan_cases = phase_scan_kernels(dev, gen)
    print(f"pallas_viterbi vs plain: ok, paths and scores identical on {len(scan_cases)} cases "
          f"({', '.join(scan_cases)}); pallas_forward / pallas_backward vs plain: ok on the same "
          f"cases; headline (B={B}, T={T}, K={GK}) max abs err "
          + ", ".join(f"{k}: {v:.3g}" for k, v in scan_errs.items())
          + f" (atol {SCAN_ATOL} + rtol {SCAN_RTOL})", flush=True)
    fused_err, fused_agree, fused_f64 = phase_fused_kernel(dev, gen)
    print(f"fused_gmm_viterbi vs plain: ok on {len(FUSED_CASES)} cases, frame agreement "
          f"{fused_agree} (>= {FUSED_AGREE}), headline max abs score err {fused_err:.3g} "
          f"(rtol {FUSED_RTOL}, atol {FUSED_ATOL}); headline score_err vs float64 (recorded, "
          "not checked): " + ", ".join(f"{k} {v:.4g}" for k, v in fused_f64.items()), flush=True)
    for what, r in phase_fused_probe(dev, torch.Generator(device=dev).manual_seed(SEED + 12)).items():
        print(probe_line(what, r, card), flush=True)
    genk = phase_genk_slice(dev)
    print(f"general-K slice (GaussianHMMLayer({GK}, {GD}), HMMLayer({GK}), HMM K={GK}, "
          f"MixtureGaussianHMMLayer({GK}, {GD}, C={GMM_CS}); B={B}, T={T}): ok, launches "
          f"{genk['launches']}, decode frame agreement with CPU {genk['agreement']}, Adam losses "
          f"{genk['losses']}", flush=True)
    print("general-K slice vs CPU float64 (posteriors max abs; loss / log-likelihood max rel; "
          "gradients and EM relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in genk["errs"].items())
          + f" (posteriors atol {GENK_POST_ATOL}, loss rtol {LOSS_RTOL}, HMM log-likelihood rtol "
          f"{HMM_LL_RTOL}, grad rtol {GENK_GRAD_RTOL}, EM rtol {GENK_EM_RTOL})", flush=True)

    prob_errs, prob_split, l2r_err, prob_cases, prob_inputs = phase_prob_kernels(dev, gen)
    print(f"pallas_forward_prob / pallas_backward_prob / pallas_fb_prob vs plain: ok on "
          f"{len(prob_cases)} cases ({', '.join(prob_cases)}); the fused launch's tables equal the "
          f"single chains' and its split tables sum to them, bit for bit; headline (B={LB}, "
          f"T={PROB_T}, K={LK}) max abs err "
          + ", ".join(f"{k}: {v:.3g}" for k, v in prob_errs.items())
          + "; split as written: " + ", ".join(f"{k}: {v:.3g}" for k, v in prob_split.items())
          + f" (relative tables atol {PROB_REL_ATOL}; shifts and log Z atol {PROB_ATOL} + rtol "
          f"{PROB_RTOL}); left-to-right safe_log case posteriors vs "
          f"float64 {l2r_err:.3g} (atol {GENK_POST_ATOL})", flush=True)
    for line in probe_lines(phase_prob_probe(dev, torch.Generator(device=dev).manual_seed(SEED + 11)), card):
        print(line, flush=True)
    long = phase_long_context(dev)
    print(f"long context (B={LB}, T={LT}, K={LK}; ops.auto_forward, auto_log_likelihood and its "
          f"gradient): ok, launches {long['launches']}; {LONG_SUB} rows vs float64 (log Z, log alpha "
          "and posteriors max abs, gradients relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in long["errs"].items())
          + f" (log Z / log alpha atol {LONG_ATOL} + rtol {LONG_RTOL}, posteriors atol "
          f"{GENK_POST_ATOL}, grad rtol {GENK_GRAD_RTOL})", flush=True)
    full = phase_fullcov(dev)
    print(f"full covariance (GaussianHMMLayer({GK}, {GD}, 'full') B={B} T={FULL_T}; "
          f"MixtureGaussianHMMLayer({S}, {D}, C={C}, 'full') B={B} T={T}): ok, launches "
          f"{full['launches']}, decode frame agreement {full['agreement']}, Adam losses "
          f"{full['losses']}, em_step log-likelihoods {full['lls']}", flush=True)
    print(f"full covariance vs CPU float64 (GaussianHMMLayer on {FULL_SUB} rows; posteriors max "
          "abs; loss / log-likelihood max rel; gradients and EM relative to each tensor's max): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in full["errs"].items())
          + f" (posteriors atol {GENK_POST_ATOL}, loss rtol {LOSS_RTOL}, grad rtol "
          f"{GENK_GRAD_RTOL}, EM rtol {GENK_EM_RTOL})", flush=True)

    t_ctc = time.perf_counter()
    ctc_errs, ctc_inputs = phase_ctc_kernels(dev, gen)
    print("ctc_lattice_forward / ctc_lattice_backward / ctc_lattice_viterbi(_wide) vs plain: ok on "
          f"{len(ctc_errs)} cases (B, T, C, U: headline {CTC_SHAPES['headline']}, S=2001 "
          f"{CTC_SHAPES['S=2001']}, S=2047 (2, 2100, 100, 1023), ragged with a length-1 row, empty "
          "targets and an infeasible row, repeated labels; Viterbi through both rows where row 22 "
          "fits, positions identical); max abs err "
          + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.3g}" for n, v in e.items())
                      for k, e in ctc_errs.items())
          + f" (alpha / beta atol {CTC_ATOL} at valid cells, scores atol {CTC_SCORE_ATOL})",
          flush=True)
    ctc = phase_ctc_slice(dev)
    print(f"CTC slice (CTCAligner({CTC_SHAPES['headline'][2]}) at B, T, C, U = "
          f"{CTC_SHAPES['headline']}; align also at {CTC_SHAPES['S=2001']}): ok, launches "
          f"{ctc['launches']}, Adam losses {ctc['losses']}, posterior path agreement with float64 "
          f"{ctc['path agreement']}; align and decodes identical to the CPU; "
          + ", ".join(f"{k}: {v:.3g}" for k, v in ctc["errs"].items())
          + f" (loss atol {CTC_LL_ATOL} + rtol {CTC_LL_RTOL}, gradient atol {CTC_GRAD_ATOL}); "
          f"CTC checks {time.perf_counter() - t_ctc:.1f} s", flush=True)

    t_new = time.perf_counter()
    # The DTW and scoring phases draw from their own generator, so the
    # phases after them see the inputs they always had.
    gen_new = torch.Generator(device=dev).manual_seed(SEED + 91)
    dtw_err, dtw_cases, d500 = phase_dtw_kernel(dev, gen_new)
    print(f"pallas_dtw vs plain: ok, paths, lengths and costs identical on {len(dtw_cases)} cases "
          f"({', '.join(dtw_cases)})", flush=True)
    dtw = phase_dtw_slice(dev)
    print(f"DTW slice (DTWAligner on ({DTW_N}, {DTW_D}) x ({DTW_N}, {DTW_D}), one pair and a batch of "
          f"{DTW_BATCH}; ConstrainedDTWAligner(bandwidth={DTW_BAND}); dtw_distance; "
          f"phoneme_audio_alignment, {DTW_PHONEMES} phonemes over {DTW_N} frames; soft_dtw_alignment "
          f"{DTW_SOFT}x{DTW_SOFT}): ok, launches {dtw['launches']}, the plain wavefront never ran; "
          "paths and costs identical to the CPU plain path on the card's distances; "
          f"{dtw['phonemes aligned']} of {DTW_PHONEMES} phonemes hold frames; "
          + ", ".join(f"{k}: {v:.3g}" for k, v in dtw["errs"].items())
          + f" (distances atol {DTW_DIST_ATOL} + rtol {DTW_DIST_RTOL}, soft alignment atol "
          f"{DTW_SOFT_ATOL}, soft cost rtol {DTW_SOFT_RTOL})", flush=True)
    bigk_errs, bigk_inputs = phase_bigk_kernel(dev, gen_new)
    print(f"bigk_log_likelihood vs plain: ok on {len([k for k in bigk_errs if 'float64' not in k])} "
          f"cases (B, T, K: {', '.join(f'{k} {v}' for k, v in BIGK_SHAPES.items())}, 8x256x256, "
          f"5x384x96, 3x128x33, K=12, {', '.join(f'{k} {v}' for k, v in BIGK_CLUSTER_CASES.items())}, "
          f"offset view {BIGK_OFFSET_VIEW});"
          " max abs err "
          + ", ".join(f"{k}: {v:.3g}" for k, v in bigk_errs.items())
          + f" (vs plain atol {BIGK_ATOL} + rtol {BIGK_PLAIN_RTOL}; vs float64 on {BIGK_F64_ROWS} rows "
          f"atol {BIGK_ATOL} + rtol {BIGK_RTOL})", flush=True)
    scoring = phase_bigk_scoring(dev, bigk_inputs)
    print(f"scoring (ops.bigk_log_likelihood at {', '.join(map(str, BIGK_SHAPES.values()))} and at "
          f"T=2000): ok, launches {scoring}; DTW and scoring checks "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    times, launches_per_call = phase_timing(dev, gen, layer, obs, train, dur, dur_train)
    stimes, slaunches, prof, stream_inputs = phase_stream_timing(dev, gen)
    ntimes, nlaunches, nprof, neural_inputs = phase_neural_timing(dev, gen, neural)
    btimes, blaunches, bprof, genk_inputs = phase_genk_timing(dev, gen, genk)
    ltimes, llaunches, lprof, gate = phase_long_timing(dev, gen, prob_inputs, long, full)
    t_ctc = time.perf_counter()
    ctimes, claunches, cprof = phase_ctc_timing(dev, ctc_inputs, ctc)
    t_ctc = time.perf_counter() - t_ctc
    t_new = time.perf_counter()
    dtimes, dlaunches = phase_dtw_bigk_timing(dev, d500, dtw, bigk_inputs)
    cluster = phase_bigk_cluster(dev)
    t_new = time.perf_counter() - t_new
    times.update(ctimes)
    times.update(dtimes)
    launches_per_call.update(claunches)
    launches_per_call.update(dlaunches)
    launches_per_call.update({tag: {k: v for k, v in got.items() if v} for tag, got in scoring.items()})
    times.update(stimes)
    times.update(ntimes)
    times.update(btimes)
    times.update(ltimes)
    launches_per_call.update(slaunches)
    launches_per_call.update(nlaunches)
    launches_per_call.update(blaunches)
    launches_per_call.update(llaunches)
    bound = bounds(stream_inputs, neural_inputs, genk_inputs, prob_inputs)
    times["hsmm_table_grads"] = grads_times["cell"][:2]
    bound["hsmm_table_grads"] = grads_times["cell"][2]
    # Rows 20-22 at the headline, row 23 at S=2001: each at the shape its
    # entry point runs it.
    ctc_main = {name: "S=2001" if name == "ctc_lattice_viterbi_wide" else "headline"
                for name in CTC_KERNELS}
    ctc_bound = {shape: {n: _bound(*w) for n, w in ctc_work(*k["lp"].shape).items()}
                 for shape, (k, _) in ctc_inputs.items()}
    for name in CTC_KERNELS:
        bound[name] = ctc_bound[ctc_main[name]][name]
        times[name] = times[f"{name} {ctc_main[name]}"]
    bound["pallas_dtw"] = _bound(*dtw_work(*d500.shape))
    bigk_bound = {k: _bound_s(*bigk_work(*a[0].shape)) for k, a in bigk_inputs.items()}
    bound["bigk_log_likelihood"] = bigk_bound["K=512"]
    times["bigk_log_likelihood"] = times["bigk_log_likelihood K=512"]
    for name in KERNELS:
        ms, plain = times[name]
        print(f"timing {name}: {ms:.4f} ms kernel, {plain:.4f} ms plain torch, bound "
              f"{bound[name][0]:.6f} ms ({bound[name][1]}) (median, CUDA events) on {card}",
              flush=True)
    for name in TIME_VARYING:
        ms, plain = times[f"{name} tv"]
        b_ms, b_by = bound[f"{name} tv"]
        print(f"timing {name} time-varying (B={NB}, T={NT}, K={NS}): {ms:.4f} ms kernel, "
              f"{plain:.4f} ms plain torch, bound {b_ms:.6f} ms ({b_by}) (median, CUDA events) "
              f"on {card}", flush=True)
    print(f"timing library torch.addmm for diag_quadratic: {times['library diag_quadratic']:.4f} ms "
          f"on {card}", flush=True)
    dq_tags = {"N=48": S * C, **{f"N={n_}": n_ for n_ in DQ_DEVICE_N}}
    dq_bound = {tag: _bound(*dq_work(B * T, D, n_)) for tag, n_ in dq_tags.items()}
    print("timing diag_quadratic device time (B, T, D = "
          f"{B}, {T}, {D}; CUDA graph of {DQ_GRAPH_LAUNCHES} launches, median of {TIMED_RUNS} replays): "
          + "; ".join(f"{tag} kernel {times[f'diag_quadratic device {tag}']:.4f} ms, plain "
                      f"{times[f'diag_quadratic plain device {tag}']:.4f} ms, torch.addmm "
                      f"{times[f'library diag_quadratic device {tag}']:.4f} ms, bound "
                      f"{dq_bound[tag][0]:.6f} ms ({dq_bound[tag][1]})" for tag in dq_bound)
          + "; call time " + ", ".join(
              f"{tag} kernel {times[f'diag_quadratic call {tag}']:.4f} ms, torch.addmm "
              f"{times[f'library diag_quadratic call {tag}']:.4f} ms" for tag in dq_bound if tag != "N=48")
          + f" on {card}", flush=True)
    for name, what, shape in (
            ("decode", "request", (B, T)), ("compute_loss step", "forward+backward", (B, T)),
            ("em_step", "step", (B, T)), ("HSMM decode", "request", (HB, HT)),
            ("HSMM posteriors", "call", (HB, HT)),
            ("HSMM compute_loss step", "forward+backward", (HB, HT)),
            ("HSMM em_step", "step", (HB, HT))):
        print(f"timing {name}: {times[name]:.4f} ms per {what} of {shape[0]}x{shape[1]} frames "
              f"(median of {TIMED_RUNS}, CUDA events) on {card}", flush=True)
    per_frame = {k: (times[f"{k} T=1024"] - times[t][0]) / (1024 - SCHUNK) * 1e3
                 for k, t in (("greedy", "greedy_chunk"), ("beam", "beam_chunk_multi"))}
    print(f"timing stream kernels (S={SS}, W={SW}, H={SH}): greedy T=160 "
          f"{times['greedy_chunk'][0]:.4f} ms, T=1024 {times['greedy T=1024']:.4f} ms; beam N=1 "
          f"T=160 {times['beam_chunk_multi'][0]:.4f} ms, T=1024 {times['beam T=1024']:.4f} ms, "
          + ", ".join(f"N={n} {times[f'beam N={n}']:.4f} ms" for n in FLEETS)
          + f"; chain per frame (T=1024 minus T=160): greedy {per_frame['greedy']:.4f} us, beam "
          f"{per_frame['beam']:.4f} us on {card}", flush=True)
    for name in ("process_chunk beam", "process_chunk greedy",
                 *(f"fleet step N={n}" for n in (1, *FLEETS)),
                 *(f"PCM fleet step N={n}" for n in (1, *FLEETS)), "PCM step N=1"):
        print(f"timing {name}: {times[name]:.4f} ms per {SCHUNK}-frame chunk (median of "
              f"{TIMED_RUNS}, CUDA events) on {card}", flush=True)
    print("launches per call: " + "; ".join(f"{k} {v}" for k, v in launches_per_call.items()),
          flush=True)
    print(f"profile of 10 beam chunks through process_chunk: host wall {prof['host_ms']:.4f} ms, "
          f"device busy {prof['device_ms']} ms, {prof['kernels']} device ops per chunk, top "
          f"{prof['top_ms']} on {card}", flush=True)
    for name in (f"{m} {c}" for m in NEURAL_KERNELS
                 for c in ("forward", "decode", "compute_loss step")):
        what = "forward+backward" if "step" in name else "call"
        print(f"timing {name}: {times[name]:.4f} ms per {what} of {NB}x{NT} frames (median of "
              f"{TIMED_RUNS}, CUDA events) on {card}", flush=True)
    print(f"profile of 10 NeuralHMM forwards (B={NB}, T={NT}): host wall {nprof['host_ms']:.4f} ms, "
          f"device busy {nprof['device_ms']} ms, {nprof['kernels']} device ops per call, top "
          f"{nprof['top_ms']} on {card}", flush=True)
    print(f"timing fused_gmm_viterbi (B={B}, T={T}, S={GK}, C=2, D={GD}): {times['fused_gmm_viterbi'][0]:.4f} ms "
          f"fused, {times[UNFUSED]:.4f} ms unfused (gmm_log_probs: diag_quadratic with the logsumexp over C, "
          f"then pallas_viterbi) (median, CUDA events) on {card}", flush=True)
    print("timing general-K chains (B=4): "
          + ", ".join(f"{k} {times[k]:.4f} ms" for k in btimes if " K=" in k)
          + f" (K=256 at T=300, K=1024 at T=256; median, CUDA events) on {card}", flush=True)
    for name in (k for k in btimes if k not in GENK_KERNELS and " K=" not in k and k != UNFUSED):
        what = "forward+backward" if "step" in name else "call"
        print(f"timing {name}: {times[name]:.4f} ms per {what} of {B}x{T} frames (median of "
              f"{TIMED_RUNS}, CUDA events) on {card}", flush=True)
    for name, p in bprof.items():
        print(f"profile of 10 calls of {name} (B={B}, T={T}): host wall {p['host_ms']:.4f} ms, "
              f"device busy {p['device_ms']} ms, {p['kernels']} device ops per call, top "
              f"{p['top_ms']} on {card}", flush=True)
    long_bound = {k: _bound(*w) for k, w in prob_work(LB, LT, LK).items()}
    print(f"timing prob-space chains (B={LB}, K={LK}): "
          + ", ".join(f"{k} T={LT} {times[f'{k} T={LT}']:.4f} ms (bound {long_bound[k][0]:.4f} "
                      f"ms, {long_bound[k][1]})" for k in PROB_KERNELS)
          + f"; log-space pallas_forward T={PROB_T} {times['pallas_forward T=4096']:.4f} ms, "
          f"T={LT} {times[f'pallas_forward T={LT}']:.4f} ms; pallas_backward T={PROB_T} "
          f"{times['pallas_backward T=4096']:.4f} ms, T={LT} {times[f'pallas_backward T={LT}']:.4f} "
          f"ms; at K={S}, T={PROB_T}: pallas_fb_prob {times['pallas_fb_prob K=12']:.4f} ms, "
          f"fbsum_smallk {times['fbsum_smallk K=12 T=4096']:.4f} ms (median, CUDA events) on {card}",
          flush=True)
    for name in (k for k in ltimes if k.startswith(("long-context", "GaussianHMMLayer full",
                                                    "MixtureGaussianHMMLayer full"))):
        shape = ((LB, LT) if name.startswith("long") else
                 (B, FULL_T) if name.startswith("Gaussian") or name.endswith("T=2048") else (B, T))
        what = "forward+backward" if "step" in name or "gradient" in name else "call"
        print(f"timing {name}: {times[name]:.4f} ms per {what} of {shape[0]}x{shape[1]} frames "
              f"(median, CUDA events) on {card}", flush=True)
    for name, p in lprof.items():
        print(f"profile of {name}: host wall {p['host_ms']:.4f} ms, device busy {p['device_ms']} "
              f"ms, {p['kernels']} device ops per call, top {p['top_ms']} on {card}", flush=True)
    print(f"gate: the finiteness read of log_a {gate['finite read us']:.2f} us per call, the whole "
          f"route decision {gate['route us']:.2f} us (host clock, 100 calls, idle stream) on "
          f"{card}", flush=True)

    for shape in CTC_SHAPES:
        kerns = [n for n in CTC_KERNELS if f"{n} {shape}" in times]
        print(f"timing CTC kernels at {shape} (B, T, S = {tuple(ctc_inputs[shape][0]['lp'].shape)}): "
              + ", ".join(f"{n} {times[f'{n} {shape}'][0]:.4f} ms (plain {times[f'{n} {shape}'][1]:.4f}, "
                          f"bound {ctc_bound[shape][n][0]:.6f}, {ctc_bound[shape][n][1]})" for n in kerns)
              + f"; library F.ctc_loss forward {times[f'library F.ctc_loss forward {shape}']:.4f} ms, "
              f"backward {times[f'library F.ctc_loss backward {shape}']:.4f} ms (median, CUDA events) "
              f"on {card}", flush=True)
    for name in ctc["calls"]:
        shape = CTC_SHAPES["S=2001" if name.endswith("S=2001") else "headline"]
        what = "forward+backward" if "step" in name else "call"
        print(f"timing CTC {name}: {times[name]:.4f} ms per {what} of {shape[0]}x{shape[1]} frames "
              f"(median, CUDA events) on {card}", flush=True)
    print(f"profile of 3 CTC loss steps (B={CTC_SHAPES['headline'][0]}, T={CTC_SHAPES['headline'][1]}): "
          f"host wall {cprof['host_ms']:.4f} ms, device busy {cprof['device_ms']} ms, "
          f"{cprof['kernels']} device ops per call, top {cprof['top_ms']} on {card}; CTC timing "
          f"{t_ctc:.1f} s", flush=True)

    print("timing bigk_log_likelihood: " + ", ".join(
        f"{k} (B, T, K = {tuple(a[0].shape)}) {times[f'bigk_log_likelihood {k}'][0]:.4f} ms (plain "
        f"{times[f'bigk_log_likelihood {k}'][1]:.4f}, bound {bigk_bound[k][0]:.6f}, {bigk_bound[k][1]}; "
        f"{times[f'bigk_log_likelihood {k}'][0] * 1e3 / a[0].shape[1]:.3f} us a frame)"
        for k, a in bigk_inputs.items()) + f" (median, CUDA events) on {card}", flush=True)
    for name, (plan, active) in cluster["plans"].items():
        b, t, k = {**BIGK_SHAPES, **BIGK_CLUSTER_CASES}[name]
        ms = (times[f"bigk_log_likelihood {name}"][0] if name in BIGK_SHAPES
              else cluster[f"bigk_log_likelihood {name}"])
        print(f"bigk_log_likelihood cluster plan {name} (B, T, K = {b}, {t}, {k}): CS={plan.cs} CTAs a "
              f"cluster, {plan.clusters} clusters of {plan.rows} rows, {plan.smem} bytes of shared memory "
              f"a CTA ({plan.kp * (plan.kp // plan.cs) * 2} of them P's slice, resident), {active} clusters "
              f"held at once; "
              f"{ms:.4f} ms, {ms * 1e3 / t:.3f} us a frame (median, CUDA events) on {card}", flush=True)
    print("cluster barrier (one cluster, probe): " + ", ".join(
        f"CS={cs} {us:.3f} us" + (" after a Kp=1024 q exchange" if push else " alone")
        for (cs, push), us in cluster["barrier_us"].items()) + f" on {card}", flush=True)
    for name in dtw["calls"]:
        print(f"timing DTW {name}: {times[f'DTW {name}']:.4f} ms per call ({DTW_N}x{DTW_N} frames "
              f"a pair; median of {TIMED_RUNS}, CUDA events) on {card}", flush=True)
    print(f"DTW and scoring timing {t_new:.1f} s", flush=True)

    errs = {"diag_quadratic": dq_errs[(B, T, D, S * C)], "smallk_viterbi": vit_err, **sum_errs,
            **hsmm_errs, "hsmm_table_grads": grads_errs["cell"]["d_log_obs"][0], **stream_errs, "fused_gaussian_emission": emit_errs["headline"],
            **scan_errs, "fused_gmm_viterbi": fused_err, **prob_errs,
            **{n: ctc_errs[ctc_main[n]][n] for n in CTC_KERNELS}, "pallas_dtw": dtw_err,
            "bigk_log_likelihood": bigk_errs["K=512"]}
    launches = {name: sum(run.get(name, 0) for run in (
        dec_launches, train["launches"], dur["launches"], dur_train["launches"],
        serve["beam"]["launches"], serve["greedy"]["launches"], fleets["launches"],
        *neural["launches"].values(), *genk["launches"].values(),
        *long["launches"].values(), *full["launches"].values(), *ctc["launches"].values(),
        *dtw["launches"].values(), *scoring.values()))
        for name in KERNELS}
    # Row 1's device times (graph replays) of the kernel, its plain version
    # and torch.addmm ride beside its call times.
    device_ms = {"diag_quadratic": {
        "device_ms": times["diag_quadratic device N=48"],
        "plain_device_ms": times["diag_quadratic plain device N=48"],
        "library_device_ms": times["library diag_quadratic device N=48"]}}
    library = {"diag_quadratic": times["library diag_quadratic"],
               "ctc_lattice_forward": times["library F.ctc_loss forward headline"],
               "ctc_lattice_backward": times["library F.ctc_loss backward headline"]}
    time_varying = {name: {
        "launches": sum(run[name] for run in neural["tv_launches"].values()),
        "max_abs_err": tv_errs[name], "ms": times[f"{name} tv"][0],
        "plain_ms": times[f"{name} tv"][1], "bound_ms": bound[f"{name} tv"][0],
        "bound_by": bound[f"{name} tv"][1]} for name in TIME_VARYING}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bound[name][0], "bound_by": bound[name][1],
         "library_ms": library.get(name), **device_ms.get(name, {}),
         **({"time_varying": time_varying[name]} if name in time_varying else {})}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
