#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``tlie_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tlie_tpu_torch/ops/csrc`` with
``nvcc`` (into ``tlie_tpu_torch/_build/``, one ``nvcc`` per source, all at
once), holds each kernel against its plain PyTorch version on the card
(the diagonal scan forward and backward, the three kernels of the fused
decoder + cross-entropy head on float32 and on bfloat16 operands, the three
of the SSD's decay attention on float32 and on bfloat16 operands (the
float32 ones also at the CIFAR, ListOps and IMDB Mamba-2's shapes) and the
three of the flash attention), the scan's two kernels also on a decay that
varies by example and is constant in time and at S5's shapes (MQAR,
ListOps and Speech Commands) and at Mamba-1's (B, L, d_inner·N) view, holds
the ``vmap`` rules of the scan's, the decay attention's and the flash
attention's Functions (a stacked sweep's grid of 4 points in one launch of
each kernel) to the points' separate calls and times each kernel at the
grid's folded shape, and drives twenty-five models (all but one at their
published widths) along thirty-nine paths, each with the launch counts set
to 0 just before it and read just after (paths 37-39 also in the processes
they start):

1. the MQAR LRU (``MQAR_LRU_FULL``: L=512, d_model=128, N=128, 2 layers,
   vocab 8192, batch 64, weights from the config's seed): evaluation,
   eigen-analysis and serving of the random-weight model;
2. the same model trained through ``tlie_tpu_torch.training.train`` (100
   steps, an eval every 50, on a train split cut to 8,192 examples), the
   checkpoint, and eval_eig and serving of the trained weights;
3. the WikiText-103 LRU language model (``WIKITEXT_LRU_SHORT``: 6 layers,
   d_model and N 512, block 1024, batch 8, the GPT-2 vocabulary of 50,257,
   BatchNorm, the synthetic token stream) trained with ``fused_xent: true``
   for 20 steps and one eval (perplexity), then eigen-analysed from its
   checkpoint and served;
4. the MQAR Mamba-2 (``MQAR_MAMBA2_FULL``: 2 layers, d_model 128, N 128, one
   head of 128, vocab 8192, L 512, batch 64): its forward on the test batch,
   100 training steps (AdamW behind the global-norm clip, the sparse head) on
   the same cut train split, the checkpoint reloaded and eigen-analysed from
   activations, and served from it (``Decoder.from_checkpoint``: 64 prompts
   of 384 tokens, three chunks of 128, and of 496, 31 chunks of 16, each
   prefill through the decay attention's forward once a layer and held to
   the forward and to the step path's state, 16 greedy tokens with their
   step path held to the forward, seeded sampling with top-k and top-p, and
   ``python -m tlie_tpu_torch.tools.generate`` in a subprocess); then its
   untrained pseudo-LTI variant (``SSD_LTI``) served the same way;
5. the MQAR softmax transformer (``MQAR_SM_ATTENTION_FULL``: 2 layers,
   d_model 128, one head of 128, vocab 8192, position table 512, L 512,
   batch 64, dropout 0.1): its forward on the test batch, 100 training steps
   (AdamW behind the clip, the sparse head) on the same cut train split, the
   checkpoint reloaded and eigen-analysed from activations, and serving (64
   prompts cut to 384 tokens, prefill plus 16 greedy tokens over the KV
   cache, the step path against the full forward);
6. the MQAR linear attention transformer (``MQAR_LIN_ATTENTION_FULL``: the
   transformer's widths and position table, elu+1 features, the chunked
   linear attention with its normaliser): its forward on the test batch,
   100 training steps, the checkpoint eigen-analysed (η of the normaliser
   from activations) and serving (64 prompts of 496 tokens, prefill plus 16
   greedy tokens over the O(1) state), then the step's time and its six
   largest device kernels;
7. the MQAR norm attention transformer (``MQAR_NORM_ATTENTION_CONV_FULL``:
   the learned softplus decay with its offset, conv 4, no position table)
   along the same phases with 50 training steps;
8. the WikiText-103 Mamba-2 LM (``configs/wikitext-mamba2-short.yaml``: 6
   layers, d_model and N 512, 8 heads of 64, block 1024, batch 8, vocab
   50,257, the dense head, float32): 20 training steps and one perplexity
   eval through the decay attention's float32 kernels, the checkpoint
   eigen-analysed, serving (8 prompts of a whole block, one chunk of 1,024,
   through the decay attention's forward, held to the forward and the step
   path, 16 greedy tokens, with the state in float32 and in bfloat16), the
   step's time, idle share and the decay attention's share of device time;
9. the same model in bfloat16 (``configs/wikitext-mamba2-short-bf16.yaml``,
   ``compute_dtype: bfloat16``) along the same phases, through the decay
   attention's bfloat16 kernels and no float32 one, its checkpoint
   eigen-analysed in float32;
10. the stacked seed sweep (``tlie_tpu_torch.parallel.run_sweep``, ``launch
   --sweep_parallel``) of ``MQAR_LIN_ATTENTION_FULL`` over bench.py's four
   seeds: 100 stacked steps with an eval every 50, each point
   checkpointed, journaled and eigen-analysed, its point-steps/s; a rerun
   that skips every point; one point at dropout 0 against its serial run;
   the stacked step's time against a serial step's;
11. the bfloat16 WikiText Mamba-2 through the fused head
   (``configs/wikitext-mamba2-short-bf16-fused.yaml``, ``fused_xent: true``)
   along path 9's phases, through the decay attention's and the fused
   head's bfloat16 kernels alone (the head's once each per training step,
   none in the dense perplexity eval, no float32 head kernel, no training
   step through the dense head); its step is timed in the same run as path
   9's dense head, with the head's share of device time;
12. the MQAR S5 (``MQAR_S5_FULL``: 2 layers, d_model 128, state 128, P 64
   complex channels after conj-sym, ZOH, vocab 8192, L 512, batch 64,
   BatchNorm, dropout 0.1): its forward on the test batch, 100 training
   steps with an eval every 50 on the cut train split (the scan's forward
   and backward kernels, two of each a step, at a (P,) decay), the
   checkpoint reloaded and eigen-analysed at init and trained, serving (64
   prompts of 496 tokens, prefill through the scan plus 16 greedy tokens,
   the step path against the full forward), the card step against the CPU
   step, the step's time, and the scan kernels held to their plain
   versions and timed at its shape (64, 512, 64), forward, reverse and
   backward;
13. the MQAR S4 (``MQAR_S4_FULL``: the same widths, N 128 DPLR, the CNN
   mode through ``torch.fft``) along path 12's phases (serving: the dense
   DPLR recurrence, prefill step by step), with the generating-function
   kernel's share of the step;
14. the ListOps S5 (``LISTOPS_S5_FULL``: 6 layers, d_model 128, state 64, P
   32 after conj-sym, ZOH, BatchNorm, a masked mean pool, batch 50, l_max
   2048, 10 classes) on ListOps generated natively (lengths 500-2000, the
   train split cut to 1,500 examples and the test split to 250): its
   forward on a test batch, 3 epochs of training (30 steps each, 1 of
   warmup, an eval at each epoch's end; the scan's forward and backward
   kernels, six of each a step), the checkpoint reloaded and
   eigen-analysed at init and trained, a resume from the snapshot written
   at step 60 held to the uninterrupted run, the card step against the
   CPU step (5 examples), the step's time and idle share, and the scan
   kernels held to their plain versions and timed at (50, 2048, 32);
15. the ListOps S4 (``LISTOPS_S4_FULL``: the same widths, N 64 DPLR)
   along path 14's phases but the kernels', with the generating function's
   share of the step;
16. the WikiText-103 norm-attention LM (``WIKITEXT_NORM_ATTENTION_SHORT``:
   6 layers, d_model and d_qk 512, 8 heads, the MLP mixer of 512, conv 4,
   block 1024, batch 8, vocab 50,257, the dense head; about 61M
   parameters): 20 training steps and one perplexity eval, the checkpoint
   eigen-analysed (η of the learned decay), serving (prefill of 1,008
   tokens plus 16 greedy ones against the forward's argmax), the card step
   against the CPU step, the step's time, idle share and norm attention's
   share;
17. the stacked sweep ``configs/sweep/wikitext-norm-attention-seeds-lrs.yaml``
   (2 seeds × 2 rates of path 16's LM) in one wave of four points: 10
   steps and one eval, each point checkpointed, journaled and
   eigen-analysed, the wave's peak memory and point-steps/s, each point's
   stacked step against its serial step, the stacked step's time;
   then ``lm_attention_spectra`` (the pretrained-LM spectroscopy) on a
   Llama-layout stand-in at the LM's widths, held to the CPU and resumed
   from its cache;
18. the MQAR Mamba-1 (``MQAR_MAMBA1_SMALL``: 2 layers, d_model 64, d_state
   16, d_inner 128, L 64, vocab 256, batch 32, dropout 0.1) on its own
   split: its forward (card against CPU), 200 training steps through the
   scan's forward and backward kernels on the (32, 64, 2048) view with a
   decay that varies in time (2 + 2 a step), the checkpoint reloaded and
   eigen-analysed, serving (32 prompts of 48 tokens, the prefill through
   the scan's forward once a layer on the (32, 48, 2048) view, held to the
   forward and the step path, 16 greedy tokens), the card step against the
   CPU step, the step's time, and the scan kernels held to their plain
   versions and timed at the trained model's own decay and the forward at
   the prefill's;
19. the sequential CIFAR-10 Mamba-2 classifier (``CIFAR_MAMBA2_FULL``: 6
   layers, d_model 512, 4 heads of 128, N 64, conv 4, GLU, post-norm, the
   dense encoder from one grayscale feature, a mean pool, 10 classes, batch
   50, L 1024) on the loader's synthetic split (2,048 / 512 images; the
   CIFAR-10 files are not in the repository), the train split cut to 1,024
   images: its forward (card against CPU, and the same weights at four
   chunks of 256, the SSD's inter-chunk arm, against the card's own one
   chunk of 1,024), 1 epoch of 20 steps
   through the decay attention's float32 kernels (6 + 6 + 6 a step), the
   checkpoint eigen-analysed on 64 float images, the kernels at the
   trained model's steepest layer, the card step against the CPU step at
   chunk 256, the step's time and the decay attention's share;
20. its pseudo-LTI variant (``CIFAR_MAMBA2_LTI_FULL``, ``SSD_LTI``) along
   path 19's phases at 1 epoch, its spectra held to exp(−softplus(A)) of
   the checkpoint;
21. the CIFAR-10 S4 (``CIFAR_S4_FULL``: 6 layers, d_model 512, N 64,
   BatchNorm, a mean pool) along the same phases at 1 epoch, no port
   kernel, with the generating function's share of the step;
22. the CIFAR-10 softmax transformer classifier
   (``CIFAR_SM_ATTENTION_FULL``: 6 layers, d_model 512, 4 heads, d_qk 64,
   so head_dim 16 beside v_dim 128 and the softmax materialised, the MLP
   mixer of 128, a position table of 1,024, the tokenized grey levels, a
   mean pool into the classifier MLP of 128, batch 50) along path 19's
   phases at 1 epoch (the forward, 20 steps, eval_eig's η on 64 images,
   the card step against the CPU step, the step's time and the
   attention's share): no port kernel, the flash kernels none;
23. the CIFAR-10 norm attention classifier with the SiLU gate
   (``CIFAR_NORM_ATTENTION_GATING_FULL``: softplus decay with its offset,
   conv 4, ``use_gate``) along path 22's phases, on the tokenized grey
   levels (its YAML asks for float pixels, which the token embedding
   refuses, as in ``tlie_tpu``);
24. the ListOps Mamba-2 classifier (``LISTOPS_MAMBA2_FULL``: 6 layers,
   d_model 128, 4 heads of 32, N 64, pre-norm, GLU, a mean pool over the
   padding, batch 50, l_max 2048) on padded ``(tokens, lengths)`` of
   path 14's cut ListOps split: the forward (and the same weights at
   chunks of 256 against the card's own four of 512), 1 epoch of 30 steps
   through the decay attention's float32 kernels at (200, 512, 64, 4, 32),
   6 + 6 + 6 a step, eval_eig on 32 examples, the kernels at the trained
   weights, the card step against the CPU step, the step's time;
25. the IMDB Mamba-2 classifier (``IMDB_MAMBA2_FULL``: 4 layers of path
   24's widths, batch 6, l_max 4096) on the loader's synthetic char-level
   corpus (2,048 / 512 reviews; the IMDB files are not in the repository)
   along path 24's phases, cut to 1,200 / 256 reviews, 1 epoch of 200
   steps, the decay attention at (24, 1024, 64, 4, 32), 4 + 4 + 4 a step;
26. the LRA PathFinder S4 (``PATHFINDER_S4_FULL``: 4 layers, d_model 256,
   N 64, ``full_glu``, BatchNorm, a mean pool, batch 50, L 1,024 centred
   pixels, 2 classes) on the loader's synthetic connected-path images
   (16,384 / 2,048; the LRA files are not in the repository), cut to 2,048
   / 512: path 21's phases at 1 epoch of 40 steps, no port kernel;
27. the LRA AAN retrieval transformer (``AAN_TRANSFORMER_FULL``: 4 layers,
   d_model 128, 4 heads, linear attention, the GLU mixer of 128, a position
   table of 4,000, the classifier MLP of 128 and the dual ``MATCH`` head,
   batch 8 pairs, 16 documents of 4,000 characters) on the loader's
   synthetic topic-matched pairs cut to 512 / 128: the pairs folded into the
   batch, path 22's phases at 1 epoch of 64 steps (η from the pair-folded
   analysis batch of 8 pairs), no port kernel and no flash kernel; then a
   dual Mamba-2 at ``LISTOPS_MAMBA2_FULL``'s widths (the ``MATCH`` head of 2
   → 1 → 2) on the first 160 of those pairs cut to 1,024 tokens a document:
   path 24's phases at 1 epoch of 20 steps through the decay attention's
   float32 kernels, 6 + 6 + 6 a step;
28. the Speech Commands S5 (``SC_S5_MFCC_FULL``: 4 layers, H 96, state 96,
   P 48 after conj-sym, ZOH, ``half_glu1``, lecun_normal C, BatchNorm, a
   mean pool, batch 32, 161 MFCC frames of 20, 10 classes) on the loader's
   synthetic keyword clips (2,048 / 512; the corpus is not in the
   repository) cut to 1,024 / 256: the forward, 1 epoch of 32 steps through
   the scan's kernels at (32, 161, 48), 4 + 4 a step, the checkpoint
   eigen-analysed, the card step against the CPU step, the step's time, and
   the scan's forward, reverse and backward held to their plain versions
   and to float64 and timed at the trained layer's Λ̄;
29. the stacked seed sweep of the MQAR LRU (``MQAR_LRU_FULL`` over bench.py's
   four seeds, ``launch --sweep_parallel``): 100 stacked steps with an eval
   every 50 through the scan's kernels, 2 + 2 launches a stacked step for
   all four points, each point checkpointed, journaled and eigen-analysed,
   the rerun that skips every point, one point at dropout 0 against its
   serial run (BatchNorm statistics too), a stacked step's launches against
   a serial step's, point-steps/s against serial steps/s and the wave's
   peak memory;
30. ``configs/sweep/mqar-mamba2-layers.yaml`` (4 rates × ``num_layers`` 1
   and 4, two waves of four MQAR Mamba-2s) along path 29's phases, 50
   stacked steps with an eval every 25 (the decay attention's float32
   kernels, 1 + 1 + 1 and 4 + 4 + 4 a stacked step);
31. ``configs/sweep/mqar-sm-attention-seeds.yaml`` (four seeds of the MQAR
   softmax transformer) along path 30's phases (the flash kernels, 2 + 2 +
   2 a stacked step);
32. path 3's WikiText LRU LM with ``compute_dtype: bfloat16`` and
   ``fused_xent: true`` (a temporary copy of its YAML) through ``python -m
   tlie_tpu_torch.tools.run_truncated``: 20 steps through the fused head's
   three bfloat16 kernels (once each a step, no float32 head kernel) and
   the scan's two (6 + 6 a step, the forward also 6 an eval batch), one
   perplexity eval, the checkpoint and eval_eig of the trained weights (the
   float32 extraction), serving from the checkpoint in float32 (8 prompts
   of 1,008 tokens, 16 greedy tokens, the step path held to the float32
   forward), one card step against the CPU step at the bf16 tolerances, a
   step traced by ``profile_trace`` with ``annotate`` regions, and the
   step's time, device time and idle share beside path 3's float32 step;
33. path 5's MQAR softmax transformer in bfloat16: its log-probs against
   the float32 model's on the same weights, 100 training steps through the
   float32 flash kernels (a bf16 transformer upcasts q, k and v, as
   ``tlie_tpu`` does; no materialised softmax), the checkpoint
   eigen-analysed and served in float32 (64 prompts of 384 tokens, 16
   greedy tokens), one card step against the CPU step;
34. a stacked wave of four bf16 seeds of ``MQAR_LIN_ATTENTION_FULL``
   (BASELINE.json's primary config) along path 10's phases at 50 steps,
   the point against its serial run at the bf16 tolerances, then one bf16
   step of the MQAR S5 (a pre-norm stack: its residual stream stays
   bfloat16) against its CPU step through the scan's kernels;
35. path 18's MQAR Mamba-1 in bfloat16 (its recurrence float32): its
   log-probs against the float32 model's, 50 training steps through the
   scan's kernels (2 + 2 a step), the checkpoint eigen-analysed and served
   in float32, one bf16 card step against the CPU step;
36. ``configs/tasks/cifar/cifar-sm-attention.yaml`` at its widths with the
   hybrid mixer (``LAMBDA``) and the dense encoder on the float grey levels
   (``embedding: false``, ``tokenize: false``), d_qk 512 so that the flash
   kernels take its heads: the forward (card against CPU), 1 epoch of 10
   steps through the flash kernels, ``mixer_alpha_{i}`` in the run logger,
   the checkpoint eigen-analysed, one card step against the CPU step;
37. data parallelism on the one card: the MQAR LRU (``MQAR_LRU_FULL``,
   BatchNorm, dropout, the sparse head) trained 20 steps in one process,
   then through the data-parallel route in a group of one over NCCL and in
   two gloo processes sharing the card, each against the one-process run
   (weights, BatchNorm statistics, losses; the ranks' states equal), the
   scan's launches counted per rank; then four seeds as one stacked sweep
   spread over the two ranks against the one-process stacked sweep;
38. sequence parallelism on the one card: the time-sharded primitives, then
   the MQAR LRU and softmax transformer trained 20 steps with
   ``train.sequence_parallel: 2`` in two gloo processes sharing the card,
   against the one-process runs;
39. vocab tensor parallelism on the one card: the vocab-parallel
   embedding, decoder, CE and argmax at the MQAR shapes, and the route at
   m = 1, in a group of one over NCCL; then four gloo processes sharing the
   card (2 × 2): the primitives, the MQAR softmax transformer (the flash
   kernels) trained 20 steps with ``train.model_parallel: 2``, its gathered
   checkpoint eigen-analysed, and the one-process checkpoint served over
   two data ranks; then two of them (1 × 2) train the MQAR LRU (the scan's
   kernels) 20 steps; each against the one-process run, each rank's
   launches counted.
Paths 6, 7, 10, 13, 15, 16, 17, 21, 22, 23, 26 and 27's transformer reach
no Pallas kernel in ``tlie_tpu``: no port kernel launches on them, and the
script checks that.  The decay attention's forward is also held and timed at the serving
prefills' own operands (path 4's (192, 128, 128, 1, 128) and (1984, 16, 128,
1, 128)).  The decay attention's three
kernels are also held on bfloat16 operands against the plain bfloat16
version (the WikiText Mamba-2, MQAR and a ragged shape) and timed against
the bfloat16 tensor-core bound, and so are the fused head's three bfloat16
kernels (the LM's shape, a vocabulary below one tile and a ragged one).

It also checks one MQAR training step of the LRU, of the Mamba-2, of the
transformers and of S5 and S4, one ListOps step of S5 and S4, and one step
of each classifier of paths 19-28 and 36, on the card against the same step
on the CPU, one bf16 step of the WikiText LRU LM, the MQAR softmax
transformer, S5 and Mamba-1 against the same bf16 step on the CPU (paths
32-35), one fused-head
WikiText step against the dense-head step on the card, and times each kernel
against its bound, its plain version and, where one exists, the PyTorch
library call computing the same function.  Each
phase prints one line with its wall seconds; any failed check raises and
the exit code is non-zero.  The last three lines are the kernel table as
JSON, the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it fails and
prints no result.  It writes nothing inside the checkout except the kernel
build and the training runs' records under ``logs/`` (the run logger's, as
``tlie_tpu`` writes them; ignored by git); the checkpoints, the traces and
the eigen-analysis artifacts go to temporary directories that are removed
at the end.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores.  Bounds are stated against them; the power limit is printed
# beside every time.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# dense TF32 on the tensor cores (the same data sheet): the fused head's, the
# flash attention's and the decay attention's three kernels each run their
# products there, as three TF32 products each (the split x = big + small
# that keeps float32 accuracy)
TF32_FLOPS_PER_S = 495e12
# dense bfloat16 on the tensor cores (the same data sheet): the decay
# attention's bfloat16 kernels take one bfloat16 product a product
BF16_FLOPS_PER_S = 989e12

# kernel vs plain on the card: f32 sequential and chunked accumulation over
# up to ~1000 steps with |a| < 1; rounding grows like sqrt(steps) * eps, so
# 1e-5 of max|h| leaves a wide margin (the CPU tests hold the plain version
# to tlie_tpu at the same tolerance)
SCAN_RTOL_OF_MAX = 1e-5
# port on the card vs the port on the CPU (plain scan), and the serving step
# path vs the full forward: f32 matmuls summed in other orders; the same
# bound tests/test_decode.py holds the JAX step path to
LOGIT_ATOL = 2e-4
LOGIT_RTOL = 2e-4
# backward kernel vs plain: d within 1e-5 of max|d| (as h above); da within
# 1e-5 of sum(max|d| |h_{t-1}| + |d_t| max|h|) over the axes it is summed
# along, the first-order bound from the errors of d and h (tests/test_torch_scan_bwd.py)
# gradients of the card route (kernels) vs the plain route on the card: per
# leaf within 1e-4 of its max|g| (f32 sums in other orders; the CPU tests
# hold the port to JAX so)
GRAD_RTOL_OF_MAX = 1e-4
# one step's gradients, card vs CPU: both f32 are held to the same step in
# float64 on the CPU.  Some leaves are sums over all 64*512 rows that cancel
# (the BatchNorm backward has zero mean over the rows), so their f32 error is
# large beside their own max|g|; the card's error may then be at most
# GRAD_F64_FACTOR times the CPU's, or 1e-5 of the leaf's max|g|.
GRAD_F64_FACTOR = 8.0
# one optimiser step, card vs CPU: Adam moves each element by about lr*g/|g|,
# so where |g| is at least 1e-2 of its leaf's max (far above the 1e-4 noise)
# the two steps agree to f32 rounding of the weights (1e-6); elsewhere
# within the movement bound 2*lr + 1e-6.  BatchNorm statistics: 1e-5 of
# max(1, |x|).  In step_card_vs_cpu the determined elements are also held
# to the same step taken in float64 on the CPU: a leaf's card error there
# may be GRAD_F64_FACTOR times the CPU's own float32 error, or 1e-6.  Where
# a leaf's gradients are small (PathFinder S4's: max|g| 2e-5 to 1e-3 on two
# images) the float32 step on the CPU itself misses the float64 step by up
# to 3.9e-6 at such elements (Lambda_im, whose |w| reach 32 and beyond, and
# elements with |g| near 1e-7, where Adam's lr·g/(|g| + 1e-8) still follows
# g's rounding), so card and CPU, both float32, may differ by more than 1e-6.
PARAM_ATOL = 1e-6
STATS_RTOL = 1e-5
# (200 steps with an eval every 100 until paths 22-25 came, for this path
# and paths 4-6)
TRAIN_STEPS, EVAL_EVERY, TRAIN_EXAMPLES = 100, 50, 8192
# the WikiText LM path: 20 steps and one eval (the config runs 1,500 with an
# eval every 500); its train and test streams are the config's own
LM_STEPS = 20
# the fused head's kernels against their plain version: the LM's (B·L, D, V)
# and two small shapes, a vocabulary below one 128-wide tile and a ragged one
XENT_SHAPES = {"m8192_d512_v50257": (8192, 512, 50257), "m128_d512_v300": (128, 512, 300),
               "m1024_d512_v1000": (1024, 512, 1000)}
LM_BLOCK = 1024  # a -100 label ends each block of the LM's shifted labels
# the fused-head step against the dense-head step (and both against float64
# on the CPU) on LM_STEP_BLOCKS of the batch's 8 blocks (all 8 until paths
# 22-25 came: the float64 step took 15 s of CPU); the step is timed on all 8
LM_STEP_BLOCKS = 2
# fused head vs plain: loss and lse within 1e-5 relative.  A gradient element
# sums V (dh) or M (dW, db) terms t·x with t = softmax - onehot; it is held to
# XENT_RTOL of the sum of its terms' magnitudes for the rounding of that sum,
# plus the rounding of t itself: t's relative error is the absolute error of
# its logit, a float32 sum of D products, at most about sqrt(D)·u·Z with
# Z = max|h_m|·max|W_v| + max|b| (Cauchy-Schwarz) and u = 2^-24.
XENT_RTOL = 1e-5
F32_UNIT = 2.0 ** -24
# the fused head's bfloat16 kernels against the plain bfloat16 version: the
# LM's (B·L, D, V) (path 11's), a vocabulary below one 128-wide tile and a
# ragged one whose D (100) is no multiple of 8, so its tiles land by ordinary
# loads.  dh, dW and db are rounded to bfloat16, and so is t inside: each
# element within the float32 tolerance above plus BF16_STEP of (|value| +
# its term sums), and at least BF16_EQUAL_SHARE of each equal to the plain
# version's bit for bit (without the rounding of t the CPU tests find 63-77
# % against tlie_tpu); loss and lse as for float32
XENT_BF16_SHAPES = {"m8192_d512_v50257": (8192, 512, 50257), "m128_d512_v100": (128, 512, 100),
                    "m384_d100_v2001": (384, 100, 2001)}
# fused-head step vs dense-head step on the card: both are held to the
# dense step in float64 on the CPU, leaf by leaf; the fused step's error may
# be at most GRAD_F64_FACTOR times the dense float32 step's own, or 1e-5 of
# the leaf's max (the leaves next to a BatchNorm are row sums that cancel, so
# their float32 error is large beside their max, as in the MQAR step check)
# the decay attention's three kernels against their plain version: the MQAR
# Mamba-2 shape, the WikiText Mamba-2 shape and a ragged small one (BG, Q, N,
# Hg, P)
SSD_SHAPES = {"mqar_bg64_q512_n128_hg1_p128": (64, 512, 128, 1, 128),
              "wikitext_bg8_q1024_n512_hg8_p64": (8, 1024, 512, 8, 64),
              "ragged_bg3_q77_n40_hg3_p33": (3, 77, 40, 3, 33),
              # the CIFAR Mamba-2 (paths 19, 20: 4 heads of 128, N 64) at
              # batch 50: the card's own chunk, one of 1,024, and tlie_tpu's
              # and the CPU's, four of 256
              "f32_bg50_q1024_n64_hg4_p128": (50, 1024, 64, 4, 128),
              "f32_bg200_q256_n64_hg4_p128": (200, 256, 64, 4, 128),
              # the padded Mamba-2 classifiers (4 heads of 32, N 64): ListOps
              # (path 24) at batch 50 and L 2048 in the card's four chunks of
              # 512, IMDB (path 25) at batch 6 and L 4096 in four of 1,024
              "listops_bg200_q512_n64_hg4_p32": (200, 512, 64, 4, 32),
              "imdb_bg24_q1024_n64_hg4_p32": (24, 1024, 64, 4, 32)}
# the shapes the decay attention's float32 kernels are also held to the
# plain version in float64 at, and timed at beside the MQAR shape
SSD_F64_SHAPES = ("ragged_bg3_q77_n40_hg3_p33", "f32_bg50_q1024_n64_hg4_p128",
                  "f32_bg200_q256_n64_hg4_p128", "listops_bg200_q512_n64_hg4_p32",
                  "imdb_bg24_q1024_n64_hg4_p32")
SSD_TIMED_SHAPES = ("wikitext_bg8_q1024_n512_hg8_p64", "f32_bg50_q1024_n64_hg4_p128",
                    "f32_bg200_q256_n64_hg4_p128", "listops_bg200_q512_n64_hg4_p32",
                    "imdb_bg24_q1024_n64_hg4_p32")
# decay attention vs plain: each output element (y, dC, dcs_i, dB, dxdt,
# dcs_j) within SSD_RTOL of the sum of its terms' magnitudes
# (decay_attention.term_scales): float32 sums of up to N + Q terms (C·B over
# N, then the scores over j), rounded in another order; the decay exp(cs_i -
# cs_j) is formed from the same difference on both sides
SSD_RTOL = 1e-5
# the bfloat16 kernels against the plain bfloat16 version: y, dC, dB and dxdt
# are rounded to bfloat16, and so are the scores and dCB inside; the two sum
# in float32 in other orders, so a sum (or a score) near a rounding midpoint
# may round one bfloat16 step apart (at most 2^-7 of the value): each of
# those outputs within SSD_RTOL of its term sums plus BF16_STEP of (|value| +
# its term sums); dcs_i and dcs_j, float32 sums of float32 terms, within
# SSD_RTOL alone.  That band is wider than leaving out the rounding of the
# score or of dCB would move an output, so at least BF16_EQUAL_SHARE of each
# bfloat16 output must also equal the plain version's bit for bit: the card gave
# 0.9998-1.0000, and the plain version without those two roundings gives
# 0.60-0.64 against itself with them (on the CPU, at three shapes).  The
# WikiText Mamba-2 shape (path 9's), the MQAR shape and the ragged one.
BF16_STEP = 2.0 ** -7
BF16_EQUAL_SHARE = 0.99
SSD_BF16_SHAPES = {"wikitext_bg8_q1024_n512_hg8_p64": (8, 1024, 512, 8, 64),
                   "mqar_bg64_q512_n128_hg1_p128": (64, 512, 128, 1, 128),
                   "ragged_bg3_q77_n40_hg3_p33": (3, 77, 40, 3, 33)}
# one Mamba-2 step's gradients, card vs CPU, both held to float64 on the
# CPU: the card's error may be GRAD_F64_FACTOR times the CPU's, or 1e-4 of
# the leaf's max, the tolerance the CPU tests hold the port's gradients to
# JAX's with.  dt_bias and A_log are one number per head summed over all
# 64*512 positions through dcs = dcs_i + dcs_j, two sums that cancel, so one
# float32 draw of the CPU's error says little about the card's.
MAMBA_GRAD_RTOL_OF_MAX = 1e-4
# the MQAR Mamba-2 path: 100 steps and an eval every 50 (the config runs
# 40,000 with an eval every 200), on the same train split cut as the LRU's
MAMBA_STEPS, MAMBA_EVAL_EVERY = 100, 50
# the flash attention's three kernels against their plain version: the MQAR
# transformer's (B, L, H, D), a multi-head shape and a ragged one
ATTN_SHAPES = {"mqar_b64_l512_h1_d128": (64, 512, 1, 128),
               "heads_b4_l1024_h4_d64": (4, 1024, 4, 64),
               "ragged_b3_l77_h3_d40": (3, 77, 3, 40)}
# flash attention vs plain: each output element (o, dq, dk, dv) within
# ATTN_RTOL plus attention.logit_rtol of the sum of its terms' magnitudes
# (attention.term_scales): float32 sums of up to D + L terms rounded in
# another order, and the rounding of the logits, which enter P's exponent;
# lse within the same fraction of max(1, |lse|)
ATTN_RTOL = 1e-5
# the MQAR transformer path: 100 steps and an eval every 50 (the config runs
# 40,000 with an eval every 200), on the same train split cut as the LRU's;
# serving takes the test batch's prompts cut to 384 tokens (a multiple of the
# TPU kernel's 128-row block) and 16 greedy tokens, inside max_pos_embed 512
TF_STEPS, TF_EVAL_EVERY, TF_PROMPT = 100, 50, 384
# the MQAR linear and norm attention paths: 100 and 50 steps with 2 evals each
# (the configs run 40,000 with an eval every 200), on the same train split
# cut as the LRU's; serving takes the test batch's prompts cut to 496 tokens
# and 16 greedy tokens, which fills the linear attention's position table of
# 512 (the norm attention has none)
LIN_STEPS, LIN_EVAL_EVERY = 100, 50
NORM_STEPS, NORM_EVAL_EVERY = 50, 25
# the WikiText Mamba-2 paths (8: float32, 9: bfloat16): 20 steps and one
# perplexity eval each (the configs run 3,000 and 1,500 with an eval every 500)
WT_STEPS = 20
# the stacked sweep (path 10): bench.py's four seeds of the linear attention
# grid at the config's rate, 100 stacked steps with an eval every 50 (the
# north-star sweep runs 8,000; 200 with an eval every 100 until paths 22-25
# came), on the train split cut as the LRU's; its card check trains the same
# grid at dropout 0 for 20 steps and holds the first point to its serial run
SWEEP_SEEDS = (1919, 2222, 2929, 1717)
SWEEP_STEPS, SWEEP_EVAL_EVERY, SWEEP_CHECK_STEPS = 100, 50, 20
# a stacked point against its serial run, as tests/test_torch_sweep.py holds
# it: the train loss, test loss and test accuracy of every eval within 1e-5
# relative or 1e-7 absolute (pytest.approx's rule), and every parameter
# within 1e-5 absolute (the stacked step batches the same float32 products,
# so its sums may run in another order)
SWEEP_RTOL, SWEEP_ATOL, SWEEP_PARAM_ATOL = 1e-5, 1e-7, 1e-5
# the vmap-rule phase and paths 29-31: GRID points a wave, as run_sweep
# stacks them; the rules' path shapes: the scan at the MQAR LRU's (B, L, N),
# the decay attention at the MQAR Mamba-2's and, on bfloat16 operands, the
# WikiText Mamba-2's (BG, Q, N, Hg, P), the flash attention at the MQAR
# transformer's (B, L, H, D)
GRID = 4
VMAP_SCAN_SHAPE = (64, 512, 128)
VMAP_DECAY_SHAPE = (64, 512, 128, 1, 128)
VMAP_DECAY_BF16_SHAPE = (8, 1024, 512, 8, 64)
VMAP_ATTN_SHAPE = (64, 512, 1, 128)
# a rule's grid against the points' separate calls: each output and gradient
# within 1e-5 of its max|.| (float32 sums in other orders: the scan's da sums
# each point's batch in PyTorch where a lone call sums it in the kernel's
# second launch), bfloat16 outputs within one bfloat16 step (BF16_STEP)
VMAP_RTOL_OF_MAX = 1e-5
# the stacked sweeps of the kernel families: path 29 (the MQAR LRU's seeds)
# as path 10 runs, 100 stacked steps with an eval every 50; paths 30 and 31
# (configs/sweep/mqar-mamba2-layers.yaml and mqar-sm-attention-seeds.yaml,
# whose configs run 40,000 steps with an eval every 200) cut in steps alone,
# to 50 with an eval every 25; each holds its first group's first point to
# its serial run over SWEEP_CHECK_STEPS at dropout 0, as path 10 does
KSWEEP_STEPS, KSWEEP_EVAL_EVERY = 100, 50
KSWEEP_SHORT_STEPS, KSWEEP_SHORT_EVAL_EVERY = 50, 25
MAMBA2_LAYERS_SWEEP = os.path.join("configs", "sweep", "mqar-mamba2-layers.yaml")
SM_SEEDS_SWEEP = os.path.join("configs", "sweep", "mqar-sm-attention-seeds.yaml")
ATT_PROMPT = 496
# the MQAR S5 and S4 paths (12, 13): 100 steps with an eval every 50 (the
# configs run 40,000 with an eval every 200; 200 and 100 until paths 22-25
# came) on the train split cut as the LRU's; serving takes ATT_PROMPT tokens
# and 16 greedy ones
SSM_STEPS, SSM_EVAL_EVERY = 100, 50
# the ListOps S5 and S4 paths (14, 15): the train split cut to 1,500 examples
# (96,000) and the test split to 250 (2,000), 3 epochs (50) with 1 of warmup
# (5): 30 steps an epoch, 90 in all, 3 evals; a resume snapshot every 60
# steps (4,800), so one at step 60; the card-vs-CPU step on 5 examples
# (until paths 22-25 came: 4,000 and 500 examples, 240 steps, the snapshot
# at 160, 10 examples)
LISTOPS_TRAIN, LISTOPS_TEST = 1500, 250
LISTOPS_EPOCHS, LISTOPS_WARMUP, LISTOPS_SNAPSHOT = 3, 1, 60
LISTOPS_STEP_EXAMPLES = 5
# a resumed run against the uninterrupted one on the card: the same float32
# operations on the same data from the same state, so the same bits are
# expected (cuBLAS and the scan kernels fix their reduction order); every
# parameter, BatchNorm statistic and eval number within 1e-6 absolute
RESUME_PARAM_ATOL = 1e-6
# one transformer step's gradients, card vs CPU, both held to float64 on the
# CPU: the card's error may be GRAD_F64_FACTOR times the CPU's, or 1e-4 of
# the leaf's max, the tolerance the CPU tests hold the port's gradients to
# JAX's with
TF_GRAD_RTOL_OF_MAX = 1e-4
# the WikiText norm-attention LM (path 16): 20 steps and one perplexity eval
# (the config runs 2,000 with an eval every 500), serving 16 greedy tokens
# after prompts of 1,008, and its card-vs-CPU step on the first 512 tokens
# of 1 of the batch's 8 blocks (2 whole blocks until paths 22-25 came; the
# float32 and float64 steps of a 61M-parameter LM run on the card machine's
# CPU; norm attention has no position table, so any length runs)
WTN_STEPS, WTN_NEW, WTN_STEP_BLOCKS, WTN_STEP_TOKENS = 20, 16, 1, 512
# the stacked WikiText sweep (path 17): the four points of
# configs/sweep/wikitext-norm-attention-seeds-lrs.yaml in one wave, 5 steps
# and one eval (the sweep runs 2,000 with an eval every 500; 10 steps until
# paths 22-25 came)
WTS_STEPS = 5
WTS_SWEEP = os.path.join("configs", "sweep", "wikitext-norm-attention-seeds-lrs.yaml")
# the lm_spectra phase: a Llama-layout stand-in at the WikiText LM's widths,
# 2 batches of 2 blocks; η from the same q and k on the card and on the CPU
# within 1e-5 relative (the spectra tolerance of the CPU tests), the whole
# run within that plus 6 times the runs' largest score difference
LMS_LAYERS, LMS_D, LMS_HEADS, LMS_BLOCK, LMS_BATCHES, LMS_BSZ = 6, 512, 8, 1024, 2, 2
LMS_RTOL = 1e-5
# the MQAR Mamba-1 (path 18): 200 steps with an eval every 100 (the config
# runs 8,000 with an eval every 400) on its own split; the analysis batch is
# 16 test examples (configs/analysis/mqar.yaml's 64 until paths 22-25 came:
# each spectrum is (B, 64, 2048, 2), 67 MB at 64)
M1_STEPS, M1_EVAL_EVERY, M1_ANALYSIS_BATCH = 200, 100, 16
# serving the Mamba family (paths 4, 8 and 18, and the untrained pseudo-LTI
# variant beside path 4): MAMBA_NEW greedy tokens after each prompt; path 4
# prefills TF_PROMPT tokens (the chunk 128, three chunks) and
# MAMBA_PROMPT_Q16 (16 · 31: the chunk 16, 31 chunks), samples at
# SAMPLE_ARGS from generators seeded SAMPLE_SEED, and the pseudo-LTI variant
# draws its weights from LTI_SEED (MQAR_MAMBA2_FULL's seed; no config sets
# pseudoLTI for an LM); path 8 prefills WT_SERVE_ROWS whole blocks (one chunk
# of 1,024) and holds WT_CHECK_ROWS generated rows to the forward; path 18
# prefills M1_PROMPT tokens of its test batch
MAMBA_NEW, MAMBA_PROMPT_Q16 = 16, 496
# the serving times are the best of SERVE_REPEATS calls after a warm one: a
# step is host-paced, and one call's time moves with the host
SERVE_REPEATS = 3
SAMPLE_ARGS, SAMPLE_SEED = {"temperature": 0.8, "top_k": 40, "top_p": 0.9}, 28
LTI_SEED = 1919
WT_SERVE_ROWS, WT_CHECK_ROWS = 8, 2
M1_PROMPT = 48
# a prefill's decode state against the state the step path reaches after
# the same tokens, layer by layer: the conv's tail and h each within
# STATE_RTOL_OF_MAX of the step path's max|.|.  Both are float32 sums in
# other orders (the chunked scan's products over a chunk, or the scan
# kernel's fold, against one update a step); on the CPU they agree to
# 1e-6 of max|h| at the MQAR and WikiText widths over 384 and 1,024 steps,
# so 1e-4 leaves the margin LOGIT_RTOL leaves the logits
STATE_RTOL_OF_MAX = 1e-4
# the sequential CIFAR-10 paths (19: the Mamba-2, 20: its pseudo-LTI
# variant, 21: S4, 22-23: the transformer classifiers) on the loader's
# synthetic split (2,048 train and 512 test images; the CIFAR-10 files are
# not in the repository), the train split cut to CIFAR_TRAIN images (all
# 2,048, 40 steps an epoch, until paths 22-25 came): 20 steps an epoch at
# batch 50, CIFAR_EPOCHS epochs (the configs run 50) with CIFAR_WARMUP of
# warmup (5); the analysis batch is configs/analysis/cifar.yaml's 64 test
# images; the card-vs-CPU step on CIFAR_STEP_EXAMPLES of the batch's 50
# images at dropout 0 and, for the Mamba-2, at the chunk CIFAR_STEP_CHUNK on
# both sides (the card picks 1,024 for the full batch, the CPU 256)
# (path 19 ran 2 epochs until paths 22-25 came; its second epoch repeated
# the first's launches and checks)
CIFAR_EPOCHS = {"cifar_mamba2": 1, "cifar_mamba2_lti": 1, "cifar_s4": 1,
                "cifar_sm_attention": 1, "cifar_norm_attention_gating": 1}
CIFAR_WARMUP, CIFAR_ANALYSIS_BATCH, CIFAR_TRAIN = 1, 64, 1024
# (the card-vs-CPU step took 4 images until paths 22-25 came; the CPU's
# float32 and float64 steps of these 6-layer d 512 models at L 1024 are the
# slow part)
CIFAR_STEP_EXAMPLES, CIFAR_STEP_CHUNK = 2, 256
# the padded Mamba-2 classifiers (24: ListOps on the train split cut as
# path 14's, 30 steps an epoch; 25: IMDB on the synthetic corpus cut to
# IMDB_TRAIN and IMDB_TEST reviews (2,048 and 512), 200 steps an epoch at
# batch 6): LRA_EPOCHS epochs each (the configs run 50 and 30), the analysis
# batch configs/analysis/{listops,imdb}.yaml's 32 test examples, the
# card-vs-CPU step on CIFAR_STEP_EXAMPLES at chunk CIFAR_STEP_CHUNK
LRA_EPOCHS, LRA_ANALYSIS_BATCH = 1, 32
IMDB_TRAIN, IMDB_TEST = 1200, 256
# the last three LRA-style tasks, each on its loader's synthetic split (the
# LRA and Speech Commands files are not in the repository), LRA_EPOCHS
# epochs each (the configs run 20) with CIFAR_WARMUP of warmup (2, 2, 1),
# the card-vs-CPU step on CIFAR_STEP_EXAMPLES examples (pairs for AAN):
# 26, PathFinder S4: the split cut to PF_TRAIN / PF_TEST images (16,384 /
# 2,048), 40 steps an epoch at batch 50;
PF_TRAIN, PF_TEST = 2048, 512
# 27, the AAN transformer: the pair corpus cut to AAN_TRAIN / AAN_TEST pairs
# (4,096 / 512), 64 steps an epoch at batch 8 pairs, the analysis batch
# AAN_ANALYSIS_BATCH test pairs (16 documents; the repository has no AAN
# analysis config); then a dual Mamba-2 at LISTOPS_MAMBA2_FULL's widths on
# the first AAN_MAMBA_TRAIN of those pairs, each document cut to its first
# AAN_MAMBA_L tokens (4,000), 20 steps at batch 8 pairs, and all the test
# pairs so cut;
AAN_TRAIN, AAN_TEST, AAN_ANALYSIS_BATCH = 512, 128, 8
AAN_MAMBA_TRAIN, AAN_MAMBA_L = 160, 1024
# the dual Mamba-2's weights come from seed AAN_MAMBA_SEED: its MATCH head
# (2 → 1 → 2, as in tlie_tpu) has one middle ReLU unit, and at LISTOPS_MAMBA2_FULL's
# seed 1919 that unit is dead on every pair, so no gradient reaches the
# backbone (ROADMAP Queue 3); at 7 it and the two encoder units are live at
# init.  The path records the live share at both seeds.
AAN_MAMBA_SEED = 7
# 28, Speech Commands S5: the keyword corpus cut to SC_TRAIN / SC_TEST clips
# (2,048 / 512), 32 steps an epoch at batch 32
SC_TRAIN, SC_TEST = 1024, 256
# device kernels of a training step by kind, from their names (first match)
# paths 32-34, model.compute_dtype: bfloat16 for the LRU, S5, S4 and
# transformer families (the parameters float32, the activations bfloat16)
BF16_U = 2.0 ** -8  # bfloat16's unit roundoff, half the spacing of its values
# a bf16 model's log-probs against the float32 model's on the same weights,
# as the CPU tests hold the bf16 families to tlie_tpu's bf16 models
# (tests/test_torch_bf16_families.py): each within two roundings (2u) of the
# largest |log-prob|, their mean within 0.004 (0.0019 and a largest 0.013
# of 12.6 for the MQAR softmax transformer at init on the CPU)
BF16_LOGPROB_MEAN = 4e-3
# one bf16 training step on the card against the same bf16 step on the CPU
# (the same rounding points, GEMMs that sum in other orders), both beside the
# float32 step's gradients on the CPU (step_card_vs_cpu_bf16): the loss within
# 1e-3 relative; each gradient within four times the CPU's bf16 distance from
# float32 (a bias summed over 32k positions keeps as little as 0.2 of its
# value in bf16: the MQAR S5's out1.bias on the CPU, 0.803 of its max) or ten
# bfloat16 roundings (0.04) of its leaf's max|g|, the tests' bound, but never
# more than the leaf's max|g| (BF16_GRAD_CAP_OF_MAX), so that no leaf passes
# whatever the card returns (a sign flip of its largest element or twice its
# scale fails); a leaf whose four CPU distances reach the cap is named, and
# fails where a kernel of the path writes its gradient.  Not half the max: the
# WikiText LRU LM's layer-0 out1.bias, summed over 8,192 positions, is 0.638
# of its max from float32 on the CPU and 0.58 from the CPU on the card;
# the weights within BF16_PARAM_ATOL where the float32 gradient fixes Adam's
# step, within the movement bound 2·lr everywhere; the BatchNorm statistics
# within 1e-3 (relative above 1)
BF16_LOSS_RTOL, BF16_GRAD_FACTOR, BF16_GRAD_RTOL_OF_MAX = 1e-3, 4.0, 0.04
BF16_GRAD_CAP_OF_MAX = 1.0
BF16_PARAM_ATOL, BF16_STATS_ATOL = 1e-6, 1e-3
# a stacked bf16 point against its serial run (path 34, and
# tests/test_torch_bf16.py's bound): the metrics within 2e-2 relative and 99 %
# of the elements within 1e-3
BF16_SWEEP_RTOL, BF16_SWEEP_ATOL, BF16_SWEEP_SHARE = 2e-2, 1e-3, 0.99
WT_BF16_PROMPT = 1008  # path 32's prompts: a block of 1,024 less the 16 new tokens
P34_STEPS, P34_EVAL_EVERY = 50, 25
# path 35, the bf16 MQAR Mamba-1: its steps and eval cadence, and the prompt
# and analysis batch of path 18
P35_STEPS, P35_EVAL_EVERY = 50, 25
# path 36, the hybrid dense-encoder CIFAR-10 classifier: one epoch of the
# train split cut to P36_TRAIN images (P36_TRAIN // 50 steps), eval_eig on
# CIFAR_ANALYSIS_BATCH images, the card step on CIFAR_STEP_EXAMPLES; its
# copy of the YAML sets d_qk to d_model (P36_D_QK), since the YAML's 64 over
# 4 heads gives a head dim of 16 beside the value's 128, which the flash
# kernels do not take (both packages then materialise the softmax, as path
# 22 does)
P36_TRAIN, P36_D_QK = 500, 512
# path 37, data parallelism: DP_STEPS steps (one eval at the end) of the
# MQAR LRU with DP_WARMUP steps of warmup (the config's 4,000 would leave the
# weights where they started), on DP_TRAIN_EXAMPLES / DP_TEST_EXAMPLES drawn
# natively from its config's dataset; a run through the route against the
# one-process run from the same seed: the train and test losses within
# DP_LOSS_RTOL, the weights within the movement bound 2·Σ lr everywhere and
# within DP_PARAM_ATOL at DP_PARAM_SHARE of the elements at least (the group's
# sums add in another order; Adam's lr·g/(|g| + eps) may follow an element's
# rounding where its gradient is near zero), the BatchNorm statistics within
# STATS_RTOL, and the ranks' states equal bit for bit
DP_STEPS, DP_WARMUP, DP_TRAIN_EXAMPLES, DP_TEST_EXAMPLES = 20, 2, 2048, 256
DP_LOSS_RTOL, DP_PARAM_ATOL, DP_PARAM_SHARE = 1e-4, 2e-5, 0.999
# path 38, sequence parallelism: the primitives at the MQAR paths' shapes,
# each output and gradient within SP_RTOL_OF_MAX of its one-process value's
# largest magnitude (float32 sums taken in another order, over up to 64·512
# terms for a decay's gradient: about √(32768)·2^-24 = 1e-5 of the max);
# then the MQAR LRU and softmax transformer trained SP_STEPS steps (SP_WARMUP
# of warmup) over two ranks against the one-process run from the same seed,
# held to path 37's bounds (DP_*)
SP_STEPS, SP_WARMUP, SP_TRAIN_EXAMPLES, SP_TEST_EXAMPLES = 20, 2, 2048, 256
SP_RTOL_OF_MAX = 5e-5
# path 39, vocab tensor parallelism: the primitives at the MQAR shapes
# TP_PRIM_SHAPE (B, L, V, d), each output and gradient within TP_RTOL_OF_MAX
# of its one-process value's largest magnitude (float32 sums over the model
# group's shards and the vocabulary in another order), the argmax equal;
# the route at m = 1 over NCCL TP_NCCL_STEPS steps; then the MQAR softmax
# transformer (2 × 2) and LRU (1 × 2) trained TP_STEPS steps (TP_WARMUP of
# warmup) against the one-process run from the same seed, held to path 37's
# bounds (DP_*); the gathered checkpoint's η on TP_EIG_BATCH test sequences
# within TP_SPECTRA_RTOL of the largest of the one-process checkpoint's; the
# one-process checkpoint served over two data ranks (64 prompts of
# TP_PROMPT tokens + TP_NEW, greedy and sampled), its tokens equal
TP_STEPS, TP_WARMUP, TP_TRAIN_EXAMPLES, TP_TEST_EXAMPLES = 20, 2, 2048, 256
TP_PRIM_SHAPE = (64, 512, 8192, 128)
TP_RTOL_OF_MAX, TP_SPECTRA_RTOL = 5e-5, 1e-3
TP_NCCL_STEPS, TP_EIG_BATCH, TP_PROMPT, TP_NEW = 2, 8, 384, 16

OP_KINDS = (
    ("scan kernels", ("diag_scan", "sum_rows")),
    ("decay attention kernels", ("decay_attention",)),
    ("flash attention kernels", ("flash_attention",)),
    ("fused head kernels", ("xent",)),
    ("matmul", ("gemm", "Kernel2", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("sort, gather, scatter", ("sort", "Sort", "radix", "index", "gather", "scatter",
                               "embedding")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


class Phase:
    """Prints one line per phase with its wall seconds."""

    def __init__(self, name: str):
        self.name = name
        self.fields = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            secs = time.perf_counter() - self.t0
            extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
            print(f"[phase] {self.name}: {secs:.2f} s {extra}".rstrip(), flush=True)
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# the tensor-core kernels, by the name tensor_core_hmma gives each, and the
# library that holds each
TC_KERNELS = {"fwd_p64": "fused_xent", "dh_p64": "fused_xent", "dh_p32": "fused_xent",
              "dw_p64": "fused_xent", "dw_p32": "fused_xent",
              "fwd_p128_bf16": "fused_xent_bf16", "fwd_p64_bf16": "fused_xent_bf16",
              "dh_p64_bf16": "fused_xent_bf16",
              "dh_p32_bf16": "fused_xent_bf16", "dw_v64_bf16": "fused_xent_bf16",
              "dw_v32_bf16": "fused_xent_bf16",
              "flash_fwd": "flash_attention", "flash_bwd_dkv": "flash_attention",
              "flash_bwd_dq": "flash_attention",
              "decay_fwd": "decay_attention", "decay_bwd_i": "decay_attention",
              "decay_bwd_j": "decay_attention", "decay_fwd_bf16": "decay_attention_bf16",
              "decay_bwd_i_bf16": "decay_attention_bf16",
              "decay_bwd_j_bf16": "decay_attention_bf16"}
# the HMMA each tensor-core kernel must hold: TF32 for the float32 kernels,
# bfloat16 for the decay attention's bfloat16 kernels (decay_attention_bf16.cu)
# and the fused head's bfloat16 kernels
TC_HMMA = {name: "HMMA.16816.F32.BF16" if name.endswith("_bf16") else "HMMA.1688.F32.TF32"
           for name in TC_KERNELS}
# the kernels whose products may run on wgmma instead: a bfloat16 HGMMA
# (HGMMA.<shape>.F32.BF16) stands for their HMMA (the 64-row dW/db and dh,
# the forward at 128 rows of h a block and at 64)
TC_HGMMA = {"dw_v64_bf16", "dh_p64_bf16", "fwd_p128_bf16", "fwd_p64_bf16"}


def tensor_core_ops_ok(hmma: dict) -> bool:
    """Whether every tensor-core kernel of TC_KERNELS holds its HMMA, or,
    for those of TC_HGMMA, a bfloat16 HGMMA: a kernel with neither fails."""
    return sorted(hmma) == sorted(TC_KERNELS) and all(
        hmma[name].get(op, 0) > 0 or (name in TC_HGMMA and any(
            o.startswith("HGMMA.") and o.endswith(".F32.BF16") and n > 0
            for o, n in hmma[name].items()))
        for name, op in TC_HMMA.items())


def ptxas_spills(log: str) -> list:
    """The bytes each function of a ``nvcc -Xptxas -v`` report spills, stores
    and loads together, in the report's order."""
    return [int(m.group(1)) + int(m.group(2)) for m in
            re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one, with the template's integer and
    bool arguments: ``xent_dh_bf16_kernel<64>``, ``..._kernel<2, 1>``."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        pos = start + int(m.group())
        if mangled[start:pos].endswith("_kernel"):
            block = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
            args = re.findall(r"(\d+)E", block.group(1)) if block else []
            return mangled[start:pos] + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_kernels(log: str) -> dict:
    """Each entry function of a ``nvcc -Xptxas -v`` report, by
    :func:`kernel_name`, with its registers and the bytes it spills (stores
    and loads together): {"xent_dh_bf16_kernel<64>": (224, 0), ...}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = [0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name][1] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def tensor_core_hmma(lib_paths, nvcc: str) -> dict:
    """The HMMA and HGMMA opcodes, with their counts, of each tensor-core kernel in the
    built libraries, from ``cuobjdump -sass`` (beside ``nvcc``): each
    instantiation of the fused head's forward and backward kernels on
    float32 and on bfloat16 operands (on bfloat16 by rows a block: the
    forward's ``fwd_p128_bf16`` and ``fwd_p64_bf16``, dh's ``dh_p64_bf16``
    and ``dh_p32_bf16``, dW/db's ``dw_v64_bf16`` and ``dw_v32_bf16``), the flash attention's three, and the decay attention's
    forward, bwd_i and bwd_j on float32 and on bfloat16 operands (every
    instantiation of ``decay_attention_bf16.cu``'s three counted under one
    name each), {"dh_p64": {"HMMA.1688.F32.TF32": 192}, ...}."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    instr = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?((?:HMMA|HGMMA)\S*)")
    names = ((re.compile(r"xent_bwd_kernelILb([01])ELi(\d+)E"),
              lambda m: f"{'dw' if m.group(1) == '1' else 'dh'}_p{m.group(2)}"),
             (re.compile(r"xent_fwd_kernelILi(\d+)E"), lambda m: f"fwd_p{m.group(1)}"),
             (re.compile(r"xent_dh_bf16_kernelILi(\d+)E"), lambda m: f"dh_p{m.group(1)}_bf16"),
             (re.compile(r"xent_fwd_bf16_kernelILi(\d+)E"), lambda m: f"fwd_p{m.group(1)}_bf16"),
             (re.compile(r"xent_dw_bf16_kernelILi(\d+)E"), lambda m: f"dw_v{m.group(1)}_bf16"),
             (re.compile(r"flash_attention_fwd_kernel"), lambda m: "flash_fwd"),
             (re.compile(r"flash_attention_bwd_dkv_kernel"), lambda m: "flash_bwd_dkv"),
             (re.compile(r"flash_attention_bwd_dq_kernel"), lambda m: "flash_bwd_dq"),
             (re.compile(r"decay_attention_(fwd|bwd_i|bwd_j)_kernelE"),
              lambda m: f"decay_{m.group(1)}"),
             (re.compile(r"decay_attention_(fwd|bwd_i|bwd_j)_bf16_kernelILi\d+E"),
              lambda m: f"decay_{m.group(1)}_bf16"))
    counts = {}
    for lib_path in lib_paths:
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        ops = None
        for line in sass.splitlines():
            if "Function :" in line:
                ops = None
                for pattern, key in names:
                    m = pattern.search(line)
                    if m:
                        ops = counts.setdefault(key(m), {})
                        break
            elif ops is not None:
                m = instr.search(line)
                if m:
                    ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return counts


def cuda_ms(fn, repeat: int, flush: torch.Tensor = None):
    """Per-call device times (ms) of ``fn`` from CUDA events, one call per
    pair of events.  Before each call ``flush`` is overwritten, where given,
    which leaves the L2 cache cold, and then the stream sleeps on the device
    (about 0.6 ms, which touches no memory), so the host enqueues the call
    before the start event fires and the time is the device's, not the
    wrapper's host overhead (the flush alone, 256 MB of writes in about 0.08
    ms, is shorter than some wrappers' Python).  One untimed call comes
    first, so the series starts on a card that has just run ``fn``, not on
    one coming from host-side work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeat):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def top_device_ops(fn, k: int = 6):
    """The ``k`` device kernels with the most device time in one call of
    ``fn``, from ``torch.profiler`` (empty when it sees no device time).
    User-annotated ranges such as the optimiser's step are left out: their
    kernels are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((ev.self_device_time_total, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and not getattr(ev, "is_user_annotation", False)),  # ranges, not kernels
        reverse=True,
    )
    return [(name, round(us / 1e3, 4)) for us, name in rows[:k]]


def short(ops):
    """(name, ms) rows with the kernel names cut to 48 characters, for printing."""
    return [(name[:48], ms) for name, ms in ops]


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a stride-0 broadcast counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


def scan_err(h, ref):
    """(max abs error, max|ref|) over the planes of two scan results."""
    err = max((x - y).abs().max().item() for x, y in zip(_planes(h), _planes(ref)))
    scale = max(y.abs().max().item() for y in _planes(ref))
    return err, scale


def bwd_err(a, h, da, d, da_ref, d_ref, reverse):
    """(d error, d tolerance, da error, worst da error over its tolerance) of
    the backward kernel against the plain version."""
    from tlie_tpu_torch.ops.scan import _shift, _sum_to

    d_e, d_scale = scan_err(d, d_ref)
    h_prev = sum(_shift(x, 1 if reverse else -1).abs() for x in _planes(h))
    d_abs = sum(x.abs() for x in _planes(d_ref))
    h_max = max(x.abs().max() for x in _planes(h))
    tol = SCAN_RTOL_OF_MAX * _sum_to(d_abs.max() * h_prev + d_abs * h_max,
                                     _planes(a)[0].shape)
    da_e = max((x - y).abs().max().item() for x, y in zip(_planes(da), _planes(da_ref)))
    ratio = max(((x - y).abs() / tol).max().item() for x, y in zip(_planes(da), _planes(da_ref)))
    return d_e, SCAN_RTOL_OF_MAX * d_scale, da_e, ratio


def grad_err(got, want):
    """Worst per-leaf max|got - want| / max|want| over two gradient dicts;
    raises where a gradient is missing."""
    worst = 0.0
    for name, w in want.items():
        g = got.get(name)
        if g is None or w is None:
            raise AssertionError(f"no gradient for {name}")
        worst = max(worst, (g.cpu() - w.cpu()).abs().max().item() / max(w.abs().max().item(), 1e-30))
    return worst


def median(xs):
    return sorted(xs)[len(xs) // 2]


def time_scan_kernel(kernel, plain, n_bytes: int, flops: int, flush):
    """One scan kernel's L2-cold and warm medians of 21 launches, the plain
    loop's best of 2 and the bound from the bytes and float32 operations
    given: (ms, warm_ms, plain_ms, bound_ms, bound_by)."""
    cold = median(cuda_ms(kernel, 21, flush))
    warm = median(cuda_ms(kernel, 21))
    plain_ms = min(cuda_ms(plain, 2))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (cold, warm, plain_ms, max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def scan_timing_fields(t, n_bytes: int) -> str:
    """One entry of ``time_scan_kernel`` as a phase field."""
    ms, warm, plain_ms, bound, by = t
    return (f"cold_median={ms:.5f},warm_median={warm:.5f},plain_ms={plain_ms:.3f},"
            f"bound_ms={bound:.5f}({by}),over_bound={ms / bound:.3f},bytes={n_bytes}")


def xent_inputs(dev, gen, M, D, V, dtype=torch.float32):
    """h (M, D), the decoder weight as nn.Linear keeps it (V, D) with w its
    (D, V) transpose, b (V,), all in ``dtype``, labels (M,) with -100 on the
    last row of each block (or of the whole batch where it is shorter than a
    block)."""
    h = torch.randn(M, D, device=dev, generator=gen).to(dtype)
    weight = (torch.randn(V, D, device=dev, generator=gen) / math.sqrt(D)).to(dtype)
    b = (0.1 * torch.randn(V, device=dev, generator=gen)).to(dtype)
    labels = torch.randint(0, V, (M,), device=dev, generator=gen)
    labels[min(M, LM_BLOCK) - 1::LM_BLOCK] = -100
    return h, weight, b, labels


def xent_grad_rtol(h, w, b) -> float:
    """The stated tolerance of a fused-head gradient element, as a multiple
    of the sum of its terms' magnitudes (see XENT_RTOL)."""
    h, w, b = h.float(), w.float(), b.float()
    z = (h.norm(dim=1).max() * w.norm(dim=0).max() + b.abs().max()).item()
    return XENT_RTOL + math.sqrt(h.shape[1]) * F32_UNIT * z


def check_fused_xent(fx, h, w, b, labels, f64: bool):
    """Each of the three kernels against the plain version on the same
    inputs: (fields, max abs errors by kernel's launch name).  With ``f64``
    both are also held to the same function in float64, for the record.  On
    bfloat16 operands the gradients take BF16_STEP more, and at least
    BF16_EQUAL_SHARE of them must equal the plain version's (see
    XENT_BF16_SHAPES)."""
    loss, lse = fx.fused_xent_fwd_cuda(h, w, b, labels)
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    n_valid = int((labels != -100).sum())
    gscale = torch.full((1,), 1.0 / n_valid, device=h.device)
    dh = fx.fused_xent_dh_cuda(h, w, b, labels, ref_lse, gscale)
    dw, db = fx.fused_xent_dw_cuda(h, w, b, labels, ref_lse, gscale)
    torch.cuda.synchronize()
    ref = fx.fused_xent_bwd_plain(h, w, b, labels, ref_lse, gscale)
    scales = fx.grad_term_scales(h, w, b, labels, ref_lse, gscale)
    rtol = xent_grad_rtol(h, w, b)
    loss_rel = abs(loss.sum().item() - ref_loss.sum().item()) / abs(ref_loss.sum().item())
    lse_rel = ((lse - ref_lse).abs() / ref_lse.abs()).max().item()
    rows_ratio = ((loss - ref_loss).abs()
                  / (XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse))).max().item()
    fields = {"loss_rel": f"{loss_rel:.2e}", "lse_rel": f"{lse_rel:.2e}",
              "loss_rows_err_over_tol": f"{rows_ratio:.3f}",
              "grad_rtol_of_term_sums": f"{rtol:.2e}"}
    kernel_of = {k: fx.launch_name(k, h.dtype) for k in ("fwd", "dh", "dw")}
    errs = {kernel_of["fwd"]: max((loss - ref_loss).abs().max().item(),
                                  (lse - ref_lse).abs().max().item()),
            kernel_of["dh"]: 0.0, kernel_of["dw"]: 0.0}
    ok = loss_rel <= XENT_RTOL and lse_rel <= XENT_RTOL and rows_ratio <= 1.0
    for name, got, want, scale in zip(("dh", "dw", "db"), (dh, dw, db), ref, scales):
        tol = rtol * scale + 1e-30
        if want.dtype == torch.bfloat16:
            tol = tol + BF16_STEP * (want.float().abs() + scale)
            share = (got == want).float().mean().item()
            fields[f"{name}_equal_share"] = f"{share:.4f}"
            ok = ok and share >= BF16_EQUAL_SHARE and got.dtype == torch.bfloat16
        got, want = got.float(), want.float()
        ratio = ((got - want).abs() / tol).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3f}"
        kernel = kernel_of["dh" if name == "dh" else "dw"]
        errs[kernel] = max(errs[kernel], (got - want).abs().max().item())
        ok = ok and ratio <= 1.0 and bool(torch.isfinite(got).all())
    if f64:
        h64, w64, b64 = h.double(), w.double(), b.double()
        loss64, lse64 = fx.fused_xent_fwd_plain(h64, w64, b64, labels)
        ref64 = fx.fused_xent_bwd_plain(h64, w64, b64, labels, lse64, gscale.double())
        s64 = fx.grad_term_scales(h64, w64, b64, labels, lse64, gscale.double())
        for name, got, plain, want, scale in zip(("dh", "dw", "db"), (dh, dw, db), ref, ref64, s64):
            k_e = ((got.double() - want).abs() / (scale + 1e-300)).max().item()
            p_e = ((plain.double() - want).abs() / (scale + 1e-300)).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
        fields["lse_vs_f64_rel"] = (
            f"kernel={((lse.double() - lse64).abs() / lse64.abs()).max().item():.2e},"
            f"plain={((ref_lse.double() - lse64).abs() / lse64.abs()).max().item():.2e}")
        rows64 = fx.loss_term_scales(loss64, lse64)
        fields["loss_rows_vs_f64_over_term_sums"] = (
            f"kernel={((loss.double() - loss64).abs() / rows64).max().item():.2e},"
            f"plain={((ref_loss.double() - loss64).abs() / rows64).max().item():.2e}")
        del loss64, ref64, s64
    if not ok:
        raise AssertionError(f"fused_xent kernels vs plain: {fields}")
    return fields, errs, (ref_lse, gscale)


def time_fused_xent(fx, h, w, b, labels, lse, gscale, flush):
    """L2-cold medians of 21 launches of each kernel, its warm median, the
    cold medians of its plain version and of the library call computing the
    same function, and each kernel's bound: {kernel's launch name: (ms,
    warm_ms, plain_ms, library_ms, bound_ms, bound_by, bytes, flops,
    bound_f32_ms)}.  The library call is the dense head: ``addmm`` and
    ``F.cross_entropy`` on float32 operands, bfloat16 ``addmm`` and the
    port's ``cross_entropy_loss`` (its float32 reduction of bfloat16 logits,
    ``RowNLLWide``) on bfloat16 ones, autograd for the gradients.  Each
    kernel runs its products on the tensor cores, on float32 operands as
    three TF32 products each (its bound_ms is the lesser of that and float32
    outside them, bound_f32_ms at FP32_FLOPS_PER_S), on bfloat16 operands as
    one bfloat16 product (the bound is that, and the bytes count 2 for each
    bfloat16 element)."""
    import torch.nn.functional as F

    from tlie_tpu_torch.training.steps import cross_entropy_loss

    M, D = h.shape
    V = w.shape[1]
    dt = h.dtype
    bf16 = dt == torch.bfloat16
    name = {k: fx.launch_name(k, dt) for k in ("fwd", "dh", "dw")}
    n_valid = int((labels != -100).sum())
    hw, ww = fx._widen(h, w)
    ms = {
        "fwd": lambda: fx.fused_xent_fwd_cuda(h, w, b, labels),
        "dh": lambda: fx.fused_xent_dh_cuda(h, w, b, labels, lse, gscale),
        "dw": lambda: fx.fused_xent_dw_cuda(h, w, b, labels, lse, gscale),
    }

    def plain_t():
        return fx._round_t(fx._dlogits_plain(h, w, b, labels, lse, gscale), dt)

    plain = {
        "fwd": lambda: fx.fused_xent_fwd_plain(h, w, b, labels),
        "dh": lambda: (plain_t() @ ww.t()).to(dt),
        "dw": lambda: (lambda t: ((t.t() @ hw).to(dt).t(), t.sum(0).to(dt)))(plain_t()),
    }

    def dense(hh, ww_, bb):
        if bf16:
            return cross_entropy_loss(torch.addmm(bb, hh, ww_), labels)
        return F.cross_entropy(torch.addmm(bb, hh, ww_), labels, ignore_index=-100)

    hl = h.clone().requires_grad_()
    weight = w.t().detach().clone().requires_grad_()
    bl = b.clone().requires_grad_()
    lib_loss = dense(hl, weight.t(), bl)
    library = {
        "fwd": lambda: dense(h, w, b),
        "dh": lambda: torch.autograd.grad(lib_loss, hl, retain_graph=True),
        "dw": lambda: torch.autograd.grad(lib_loss, (weight, bl), retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products (2·M·D·V for the forward's logits over every row, which all
    # get an lse; the backward recomputes the logits and does one more
    # product, over the valid rows its output needs)
    e, f4, i8 = h.element_size(), 4, 8
    in_bytes = (M * D + D * V + V) * e + M * i8
    io = {"fwd": (in_bytes + 2 * M * f4, 2 * M * D * V),
          "dh": (in_bytes + (M + 1) * f4 + M * D * e, 4 * n_valid * D * V),
          "dw": (in_bytes + (M + 1) * f4 + (D * V + V) * e, 4 * n_valid * D * V)}
    out = {}
    for k in ms:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[k], 21, flush))
            w_ms = median(cuda_ms(ms[k], 21))
            p_ms = median(cuda_ms(plain[k], 21, flush))
        l_ms = median(cuda_ms(library[k], 21, flush))
        n_bytes, flops = io[k]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        if bf16:
            flops_ms = flops / BF16_FLOPS_PER_S * 1e3
        else:
            flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        out[name[k]] = (k_ms, w_ms, p_ms, l_ms, max(bytes_ms, flops_ms),
                        "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    del lib_loss
    return out


def decay_inputs(dev, gen, BG, Q, N, Hg, P, dtype=torch.float32, c_offset_bytes=16):
    """C as a row-strided view (the SSD slices C and B out of the conv
    output), B, cs as the within-chunk cumsum of dt·A with dt in [0, 0.1)
    and A in (-16, -1] (|cs| reaches hundreds at Q = 512), xdt and a
    cotangent dy; all but cs (float32) in ``dtype``.  C starts
    ``c_offset_bytes`` into rows of N + 2 · that many bytes' elements: 16,
    as ops/ssd.py's views of the conv output are aligned (4 float32 or 8
    bfloat16 elements); 8 puts a bfloat16 C off a 16-byte boundary."""
    off = c_offset_bytes // torch.empty(0, dtype=dtype).element_size()
    C = torch.randn(BG, Q, N + 2 * off, device=dev, generator=gen).to(dtype)[:, :, off:off + N]
    B = torch.randn(BG, Q, N, device=dev, generator=gen).to(dtype)
    dt = 0.1 * torch.rand(BG, Hg, Q, device=dev, generator=gen)
    A = -1 - 15 * torch.rand(1, Hg, 1, device=dev, generator=gen)
    cs = torch.cumsum(dt * A, -1).contiguous()
    x = torch.randn(BG, Hg, Q, P, device=dev, generator=gen).to(dtype)
    dy = torch.randn(BG, Hg, Q, P, device=dev, generator=gen).to(dtype)
    return C, B, cs, x, dy


DECAY_OUTPUTS = (("y", "decay_attention_fwd"), ("dC", "decay_attention_bwd_i"),
                 ("dcs_i", "decay_attention_bwd_i"), ("dB", "decay_attention_bwd_j"),
                 ("dxdt", "decay_attention_bwd_j"), ("dcs_j", "decay_attention_bwd_j"))


def check_decay_attention(dattn, C, B, cs, x, dy, f64: bool):
    """The three kernels against the plain version on the same inputs:
    (fields, max abs error by kernel's launch name).  With ``f64`` both are
    also held to the plain version in float64, for the record.  On bfloat16
    operands the bfloat16 outputs take BF16_STEP more, and at least
    BF16_EQUAL_SHARE of them must equal the plain version's (see there)."""
    got = ((dattn.decay_attention_fwd_cuda(C, B, cs, x),)
           + dattn.decay_attention_bwd_i_cuda(C, B, cs, x, dy)
           + dattn.decay_attention_bwd_j_cuda(C, B, cs, x, dy))
    torch.cuda.synchronize()
    want = ((dattn.decay_attention_plain(C, B, cs, x),)
            + dattn.decay_attention_bwd_plain(C, B, cs, x, dy))
    scales = dattn.term_scales(C, B, cs, x, dy)
    fields, errs, ok = {}, {}, True
    for (name, kernel), a, b, sc in zip(DECAY_OUTPUTS, got, want, scales):
        kernel = dattn.launch_name(kernel[len("decay_attention_"):], x.dtype)
        tol = SSD_RTOL * sc + 1e-30
        if b.dtype == torch.bfloat16:
            fields["load_route"] = dattn.load_route(C, B, x, dy)
            tol = tol + BF16_STEP * (b.float().abs() + sc)
            share = (a == b).float().mean().item()
            fields[f"{name}_equal_share"] = f"{share:.4f}"
            ok = ok and share >= BF16_EQUAL_SHARE
        a, b = a.float(), b.float()
        ratio = ((a - b).abs() / tol).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3e}"
        errs[kernel] = max(errs.get(kernel, 0.0), (a - b).abs().max().item())
        ok = ok and ratio <= 1.0 and bool(torch.isfinite(a).all())
    if f64:
        ref = (C.double(), B.double(), cs.double(), x.double(), dy.double())
        ref = ((dattn.decay_attention_plain(*ref[:4]).cpu(),)
               + tuple(t.cpu() for t in dattn.decay_attention_bwd_plain(*ref)))
        for (name, _), a, b, r, sc in zip(DECAY_OUTPUTS, got, want, ref, scales):
            sc = sc.cpu().double() + 1e-300
            k_e = ((a.cpu().double() - r).abs() / sc).max().item()
            p_e = ((b.cpu().double() - r).abs() / sc).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
    if not ok:
        raise AssertionError(f"decay attention kernels vs plain: {fields}")
    return fields, errs


def decay_einsum(C, B, cs, x):
    """The materialised form as tlie_tpu's XLA path writes it
    (ops/ssd.py:215-223), in einsums: cuBLAS products, autograd backward;
    the decay in the operands' dtype, as tlie_tpu casts it to ``mm_dtype``."""
    Q = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    scores = torch.einsum("bin,bjn->bij", C, B)[:, None] * torch.exp(
        seg.masked_fill(~causal, float("-inf"))).to(C.dtype)
    return torch.einsum("bhij,bhjp->bhip", scores, x)


# the decay attention's kernels, all on the tensor cores (three TF32 products
# a product)
DECAY_TC = ("decay_attention_fwd", "decay_attention_bwd_i", "decay_attention_bwd_j")


def time_decay_attention(dattn, C, B, cs, x, dy, flush, kernels=DECAY_TC):
    """L2-cold medians of 21 launches of each of ``kernels`` (all three by
    default; the forward alone needs no dy), warm medians, the plain
    version's and the einsum form's cold medians, and each kernel's bound:
    {kernel's launch name: (ms, warm_ms, plain_ms, einsum_ms, bound_ms,
    bound_by, bytes, flops, bound_f32_ms)}.  The kernels of DECAY_TC run
    their products on the tensor cores, on float32 operands as three TF32
    products each (the bound is the lesser of that and float32 outside
    them), on bfloat16 operands as one bfloat16 product (the bound is that,
    and the bytes count 2 for each bfloat16 element)."""
    BG, Hg, Q, P = x.shape
    N = C.shape[2]
    bf16 = x.dtype == torch.bfloat16
    ms = {
        "decay_attention_fwd": lambda: dattn.decay_attention_fwd_cuda(C, B, cs, x),
        "decay_attention_bwd_i": lambda: dattn.decay_attention_bwd_i_cuda(C, B, cs, x, dy),
        "decay_attention_bwd_j": lambda: dattn.decay_attention_bwd_j_cuda(C, B, cs, x, dy),
    }
    plain = {
        "decay_attention_fwd": lambda: dattn.decay_attention_plain(C, B, cs, x),
        "decay_attention_bwd_i": lambda: dattn.decay_attention_bwd_i_plain(C, B, cs, x, dy),
        "decay_attention_bwd_j": lambda: dattn.decay_attention_bwd_j_plain(C, B, cs, x, dy),
    }
    leaves = [t.detach().clone().requires_grad_() for t in (C, B, cs, x)]
    y_lib = decay_einsum(*leaves) if kernels != ("decay_attention_fwd",) else None
    einsum = {
        "decay_attention_fwd": lambda: decay_einsum(C, B, cs, x),
        "decay_attention_bwd_i": lambda: torch.autograd.grad(
            y_lib, (leaves[0], leaves[2]), dy, retain_graph=True),
        "decay_attention_bwd_j": lambda: torch.autograd.grad(
            y_lib, (leaves[1], leaves[3], leaves[2]), dy, retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products over the causal pairs (j <= i), per group for C·B and its
    # gradients (2N each), per head for the P-wide ones (2P each)
    f4, e = 4, x.element_size()  # cs and dcs are float32; the rest in x's dtype
    pairs = BG * Q * (Q + 1) // 2
    ins = (2 * BG * Q * N + BG * Hg * Q * P) * e + BG * Hg * Q * f4  # C, B, x, cs
    io = {"decay_attention_fwd": (ins + BG * Hg * Q * P * e, pairs * (2 * N + 2 * Hg * P)),
          "decay_attention_bwd_i": (ins + BG * Hg * Q * P * e + BG * Q * N * e + BG * Hg * Q * f4,
                                    pairs * (4 * N + 2 * Hg * P)),
          "decay_attention_bwd_j": (ins + BG * Hg * Q * P * e
                                    + (BG * Q * N + BG * Hg * Q * P) * e + BG * Hg * Q * f4,
                                    pairs * (4 * N + 4 * Hg * P))}
    out = {}
    for name in kernels:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[name], 21, flush))
            w_ms = median(cuda_ms(ms[name], 21))
            p_ms = median(cuda_ms(plain[name], 21, flush))
        e_ms = median(cuda_ms(einsum[name], 21, flush))
        n_bytes, flops = io[name]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        flops_ms = f32_ms
        if bf16:
            flops_ms = flops / BF16_FLOPS_PER_S * 1e3
        elif name in DECAY_TC:
            flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        key = dattn.launch_name(name[len("decay_attention_"):], x.dtype)
        out[key] = (k_ms, w_ms, p_ms, e_ms, max(bytes_ms, flops_ms),
                    "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    del y_lib, leaves
    return out


def timing_fields(t, library: str, over: str) -> str:
    """One kernel's entry of ``time_decay_attention``,
    ``time_flash_attention`` or ``time_fused_xent`` as a phase field, the
    library call's time and the kernel's ratio to it under the names
    given."""
    k_ms, w_ms, p_ms, l_ms, bound, by, n_bytes, flops, f32 = t
    return (f"ms_cold_median={k_ms:.5f},ms_warm_median={w_ms:.5f},plain_ms={p_ms:.5f},"
            f"{library}={l_ms:.5f},{over}={k_ms / l_ms:.3f},"
            f"bound_ms={bound:.5f}({by}),over_bound={k_ms / bound:.3f},"
            f"bound_f32_ms={f32:.5f},gflop={flops / 1e9:.3f},"
            f"mbytes={n_bytes / 1e6:.1f},tflops={flops / k_ms / 1e9:.2f}")


def attention_inputs(dev, gen, B, L, H, D):
    """q, k, v as head-strided views of one projection (MHA splits them out
    of Wqkv, and the kernels read them in place) and a cotangent do."""
    qkv = torch.randn(B, L, 3 * H * D + 8, device=dev, generator=gen)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, L, H, D) for i in range(3))
    return q, k, v, torch.randn(B, L, H, D, device=dev, generator=gen)


ATTN_OUTPUTS = (("o", "flash_attention_fwd"), ("dq", "flash_attention_bwd_dq"),
                ("dk", "flash_attention_bwd_dkv"), ("dv", "flash_attention_bwd_dkv"))


def check_flash_attention(fa, q, k, v, do, f64: bool):
    """The three kernels against the plain version on the same inputs (the
    backward kernels on the plain forward's lse and di): (fields, max abs
    error by kernel, (lse, di)).  With ``f64`` both are also held to the
    plain version in float64, for the record."""
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    di = fa.attention_di(o_ref, do)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse_ref, di, scale)
    dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse_ref, di, scale)
    want = (o_ref, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, di, scale), dk_ref,
            dv_ref)
    got = (o, dq, dk, dv)
    scales = fa.term_scales(q, k, v, do, lse_ref, scale)
    rtol = ATTN_RTOL + fa.logit_rtol(q, k, scale)
    lse_ratio = ((lse - lse_ref).abs() / (rtol * lse_ref.abs().clamp_min(1.0))).max().item()
    fields = {"rtol_of_term_sums": f"{rtol:.2e}", "lse_err_over_tol": f"{lse_ratio:.3e}"}
    errs = {"flash_attention_fwd": (lse - lse_ref).abs().max().item()}
    ok = lse_ratio <= 1.0
    for (name, kernel), a, b, sc in zip(ATTN_OUTPUTS, got, want, scales):
        ratio = ((a - b).abs() / (rtol * sc + 1e-30)).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3e}"
        errs[kernel] = max(errs.get(kernel, 0.0), (a - b).abs().max().item())
        ok = ok and ratio <= 1.0 and bool(torch.isfinite(a).all()) and a.abs().max().item() > 0
    if f64:
        q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
        o64, lse64 = fa.flash_attention_plain(q64, k64, v64, scale)
        di64 = fa.attention_di(o64, do64)
        dk64, dv64 = fa.flash_attention_bwd_dkv_plain(q64, k64, v64, do64, lse64, di64, scale)
        ref = (o64, fa.flash_attention_bwd_dq_plain(q64, k64, v64, do64, lse64, di64, scale),
               dk64, dv64)
        for (name, _), a, b, r, sc in zip(ATTN_OUTPUTS, got, want, ref, scales):
            sc = sc.double() + 1e-300
            k_e = ((a.double() - r).abs() / sc).max().item()
            p_e = ((b.double() - r).abs() / sc).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
    if not ok:
        raise AssertionError(f"flash attention kernels vs plain: {fields}")
    return fields, errs, (lse_ref, di)


# the flash attention's kernels on the tensor cores (three TF32 products a
# product)
ATTN_TC = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def time_flash_attention(fa, q, k, v, do, lse, di, flush):
    """L2-cold medians of 21 launches of each kernel, warm medians, the
    plain version's and the library call's cold medians (F.scaled_dot_product_attention
    with is_causal=True in float32, its autograd for the gradients), and each
    kernel's bound: ({kernel: (ms, warm_ms, plain_ms, library_ms, bound_ms,
    bound_by, bytes, flops, bound_f32_ms)}, (SDPA's backend for these
    inputs, the device kernels its forward ran, by name, from
    ``torch.profiler``)).  The kernels of ATTN_TC run their products on
    the tensor cores as three TF32 products each: their bound is the lesser
    of that and float32 outside them."""
    import torch.nn.functional as F

    B, L, H, D = q.shape
    scale = D ** -0.5
    ms = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd_cuda(q, k, v, scale),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, di,
                                                                           scale),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, di,
                                                                         scale),
    }
    plain = {
        "flash_attention_fwd": lambda: fa.flash_attention_plain(q, k, v, scale),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di,
                                                                            scale),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, di,
                                                                          scale),
    }
    # SDPA takes (B, H, L, D): the same tensors, transposed views
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = {
        "flash_attention_fwd": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True),
        "flash_attention_bwd_dkv": lambda: torch.autograd.grad(o_lib, (kt, vt), dot,
                                                               retain_graph=True),
        "flash_attention_bwd_dq": lambda: torch.autograd.grad(o_lib, qt, dot, retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products over the causal pairs (j <= i): q.k and p v forward (4D a
    # pair), q.k, do.v, p^T do and ds^T q for dK/dV (8D), q.k, do.v and ds k
    # for dQ (6D)
    f4, n = 4, B * L * H * D
    pairs = B * H * L * (L + 1) // 2
    rows = B * H * L
    io = {"flash_attention_fwd": ((3 * n + n + rows) * f4, 4 * D * pairs),
          "flash_attention_bwd_dkv": ((4 * n + 2 * rows + 2 * n) * f4, 8 * D * pairs),
          "flash_attention_bwd_dq": ((4 * n + 2 * rows + n) * f4, 6 * D * pairs)}
    out = {}
    for name in ms:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[name], 21, flush))
            w_ms = median(cuda_ms(ms[name], 21))
            p_ms = median(cuda_ms(plain[name], 21, flush))
        l_ms = median(cuda_ms(library[name], 21, flush))
        n_bytes, flops = io[name]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        flops_ms = f32_ms
        if name in ATTN_TC:
            flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        out[name] = (k_ms, w_ms, p_ms, l_ms, max(bytes_ms, flops_ms),
                     "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    # SDPA's backend, as its dispatcher picks it, and its kernels by name from
    # torch.profiler (which late in a long run has seen no device time)
    from torch.nn.attention import SDPBackend

    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, None, 0.0, True)).name
    with torch.no_grad():
        sdpa_kernels = top_device_ops(library["flash_attention_fwd"]) or "not seen"
    del o_lib, qt, kt, vt
    return out, (backend, sdpa_kernels)


def step_profile(one_step, tokens_per_step: int, kernel_pattern, kernel_field: str,
                 n_warm: int = 3, n_timed: int = 20, n_top: int = 12, also=None):
    """Fields of a training step's timing phase: ms per step from CUDA events
    around ``n_timed`` back-to-back steps after ``n_warm`` warm ones, train
    tokens/s, and from ``torch.profiler`` over one step the device busy time,
    the idle share, the time and share of the kernels whose names hold
    ``kernel_pattern`` (where one is given; ``also`` maps more fields to
    their patterns), device time by kind, and the ``n_top`` kernels with the
    most device time, by name."""
    for _ in range(n_warm):
        one_step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_timed):
        one_step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_timed
    ops = top_device_ops(one_step, k=1000)
    busy = sum(t for _, t in ops)
    fields = {"ms_per_step": f"{step_ms:.3f}",
              "train_tokens_per_s": f"{tokens_per_step / step_ms * 1e3:.0f}"}
    if busy <= 0:  # the profiler saw no device time: the CUDA-event time stands alone
        fields["device_busy_ms"] = "not measured"
        return fields
    by_kind = {}
    for name, t in ops:
        op_kind = next((k for k, pats in OP_KINDS if any(p in name for p in pats)), "other")
        by_kind[op_kind] = round(by_kind.get(op_kind, 0.0) + t, 4)
    fields.update({"device_busy_ms": f"{busy:.4f}",
                   "idle_share": f"{max(0.0, 1 - busy / step_ms):.3f}"})
    patterns = dict(also or {})
    if kernel_pattern is not None:
        patterns = {kernel_field: kernel_pattern, **patterns}
    for field, pattern in patterns.items():
        k_ms = sum(t for name, t in ops if pattern in name)
        fields.update({f"{field}_ms": f"{k_ms:.4f}",
                       f"{field}_share_of_device": f"{k_ms / busy:.4f}"})
    fields.update({"device_ms_by_kind": repr(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                   "top_device_ops_ms": repr(short(ops[:n_top]))})
    return fields


def step_card_vs_cpu(ph, what: str, fresh, dev, x_step, y_step, lrs, sparse_k,
                     rtol_of_max: float, watch=None, check_stats: bool = False):
    """One training step (sparse head, AdamW behind the global-norm clip)
    from the same weights and batch on the card and on the CPU (``x_step``
    the tokens or features, or a padded model's ``(tokens, lengths)``), both held
    to the same step in float64 on the CPU: each gradient's error on the
    card may be GRAD_F64_FACTOR times the CPU's or ``rtol_of_max`` of the
    leaf's max|g|; the parameters within PARAM_ATOL where |g| is at least
    1e-2 of its leaf's max and within the movement bound 2·lr + PARAM_ATOL
    everywhere, or, leaf by leaf at those elements, within GRAD_F64_FACTOR
    times the CPU's own distance from the same step in float64 (the
    optimiser's step taken on the float64 model).  ``fresh(device)`` gives
    (model, optimizer, clip norm);
    ``watch`` is (field, name predicate) for leaves whose error ratios are
    printed one by one; with ``check_stats`` the BatchNorm statistics must
    agree within STATS_RTOL.  Fills ``ph.fields``, raises on a failed check, and
    returns the card's (model, optimizer, clip norm) after its step."""
    from tlie_tpu_torch.training import train_step
    from tlie_tpu_torch.training.state import clip_by_global_norm_, set_group_learning_rates
    from tlie_tpu_torch.training.steps import cross_entropy_loss, head_logits

    card_m, card_opt, clip = fresh(dev)
    cpu_m, cpu_opt, _ = fresh("cpu")
    train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip)
    t0 = time.perf_counter()
    x_cpu = tuple(t.cpu() for t in x_step) if isinstance(x_step, tuple) else x_step.cpu()
    train_step(cpu_m, cpu_opt, x_cpu, y_step.cpu(), lrs, sparse_k, clip_norm=clip)
    cpu_g = {n: p.grad for n, p in cpu_m.named_parameters()}
    card_g = {n: p.grad.cpu() for n, p in card_m.named_parameters()}
    ref_m, ref_opt, _ = fresh("cpu")
    ref_m.double()
    x_ref = x_cpu.double() if torch.is_tensor(x_cpu) and x_cpu.is_floating_point() else x_cpu
    cross_entropy_loss(*head_logits(ref_m, x_ref, y_step.cpu(), sparse_k)).backward()
    if clip is None:  # the SSM families take no clip
        raw_norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in ref_m.parameters()])))
    else:
        raw_norm = float(clip_by_global_norm_(ref_m.parameters(), clip))
    set_group_learning_rates(ref_opt, lrs)
    ref_opt.step()  # the same step in float64
    cpu_s = time.perf_counter() - t0
    g_ratio, g_leaf, watched = 0.0, "", {}
    for n, p in ref_m.named_parameters():
        g64 = p.grad
        e_card = (card_g[n].double() - g64).abs().max().item()
        e_cpu = (cpu_g[n].double() - g64).abs().max().item()
        allowed = max(GRAD_F64_FACTOR * e_cpu, rtol_of_max * g64.abs().max().item())
        if watch is not None and watch[1](n):
            watched[n] = round(e_card / allowed, 4)
        if e_card / allowed > g_ratio:
            g_ratio, g_leaf = e_card / allowed, n
    g_worst = grad_err(card_g, cpu_g)
    p_worst = p_anywhere = p_ratio = 0.0
    p_leaf = ""
    for (n, p), q, r in zip(card_m.named_parameters(), cpu_m.parameters(), ref_m.parameters()):
        p_card, p_cpu, p64 = p.detach().cpu().double(), q.detach().double(), r.detach()
        p_err = (p_card - p_cpu).abs()
        g_abs = cpu_g[n].abs()
        det = g_abs >= 1e-2 * g_abs.max()
        p_anywhere = max(p_anywhere, p_err.max().item())
        if not bool(det.any()):
            continue
        leaf_worst = p_err[det].max().item()
        p_worst = max(p_worst, leaf_worst)
        # the card as near the float64 step as the CPU's float32 step is
        e_card = (p_card - p64).abs()[det].max().item()
        e_cpu = (p_cpu - p64).abs()[det].max().item()
        ratio = min(leaf_worst / PARAM_ATOL, e_card / max(GRAD_F64_FACTOR * e_cpu, PARAM_ATOL))
        if ratio > p_ratio:
            p_ratio, p_leaf = ratio, n
    ph.fields.update(raw_grad_norm_f64=f"{raw_norm:.4f}", clip=clip,
                     grad_err_over_allowed=f"{g_ratio:.3f}({g_leaf})")
    if watch is not None:
        ph.fields[watch[0]] = repr(watched)
    ph.fields.update(grad_card_vs_cpu_worst_rel_to_leaf_max=f"{g_worst:.3e}",
                     param_worst_where_grad_determined=f"{p_worst:.3e}",
                     param_err_over_allowed=f"{p_ratio:.3f}({p_leaf})",
                     param_worst_anywhere=f"{p_anywhere:.3e}", cpu_steps_s=f"{cpu_s:.1f}")
    s_worst = 0.0
    if check_stats:  # BatchNorm's running statistics after the step
        s_worst = max(((b.cpu() - c).abs() / c.abs().clamp_min(1.0)).max().item()
                      for b, c in zip(card_m.buffers(), cpu_m.buffers()))
        ph.fields["batch_stats_worst_rel"] = f"{s_worst:.3e}"
    # each group moves an element by at most its own learning rate
    if not (g_ratio <= 1.0 and p_ratio <= 1.0
            and p_anywhere <= 2 * max(lrs.values()) + PARAM_ATOL and s_worst <= STATS_RTOL):
        raise AssertionError(f"{what} card vs CPU step: {ph.fields}")
    return card_m, card_opt, clip


def transformer_path(dev, gen, flush, test_x, test_y, train_split, want_files):
    """Main path 5, the full-width MQAR softmax transformer
    (``MQAR_SM_ATTENTION_FULL``: 2 layers, d_model 128, one head of 128,
    vocab 8192, position table 512, L 512, batch 64, dropout 0.1, weights
    from seed 1919) through the three flash-attention kernels: first each
    kernel against its plain version at three shapes; then, with every
    launch count set to 0, the forward on the test batch (card against CPU),
    TF_STEPS training steps with 2 evals, the checkpoint reloaded and
    eigen-analysed, and serving; the counts are read there.  Then one card
    step against the CPU step, the step's time and where it goes, and the
    kernels' times.  Returns (launches of the path, kernel times, max abs
    errors by kernel)."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import MQAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    with Phase("flash_attention_vs_plain") as ph:
        attn_errs, second = {}, None
        for name, (B, L, H, D) in ATTN_SHAPES.items():
            ins = attention_inputs(dev, gen, B, L, H, D)
            # float64 for the record at the MQAR and the ragged shape
            fields, errs, rows = check_flash_attention(fa, *ins,
                                                       f64=not name.startswith("heads"))
            ph.fields[name] = repr(fields)
            if not attn_errs:  # the MQAR shape comes first
                attn_errs, attn_io = errs, ins + rows
            elif second is None:  # the multi-head shape: dK/dV's time there, for the record
                second = name, ins + rows
            del ins, rows
        torch.cuda.empty_cache()

    sm = MQAR_SM_ATTENTION_FULL
    smm = sm["model"]
    n_layers, bsz, L = smm["num_layers"], sm["train"]["batch_size"], smm["seq_len"]
    _, model, _ = build_models(smm, generator=torch.Generator().manual_seed(sm["seed"]), device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, smm["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("tf_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention_fwd"] != n_layers:
            raise AssertionError(f"the transformer's forward launched flash_attention_fwd "
                                 f"{LAUNCHES['flash_attention_fwd']} times, expected {n_layers}")
        if logits.shape != (bsz, L, smm["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"transformer forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top = top_device_ops(lambda: model(inputs))
        _, cpu_model, _ = build_models(smm, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"transformer card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         flash_attention_fwd_launches_per_forward=n_layers,
                         vs_cpu_max_abs=f"{cpu_err:.3e}", top_device_ops_ms=repr(short(top)))
        del cpu_model, ref

    tcfg = copy.deepcopy(sm)
    tmp = tempfile.mkdtemp(prefix="tlie_tf_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-sm-attention")
    tcfg["train"].update(total_steps=TF_STEPS, eval_every=TF_EVAL_EVERY)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    test_split = (test_x, test_y)
    try:
        with Phase("tf_train") as ph:
            fwd_before = LAUNCHES["flash_attention_fwd"]
            t0 = time.perf_counter()
            result = train(tcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            path5 = dict(LAUNCHES)
            n_eval_batches = len(result.history) * (len(test_x) // bsz)
            # one forward launch per layer per step and eval batch, one of each
            # backward per layer per step; no other kernel
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(flash_attention_fwd=fwd_before + n_layers * (TF_STEPS + n_eval_batches),
                        flash_attention_bwd_dkv=n_layers * TF_STEPS,
                        flash_attention_bwd_dq=n_layers * TF_STEPS)
            if path5 != want:
                raise AssertionError(f"transformer training launches {path5}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite transformer training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(smm, generator=torch.Generator().manual_seed(sm["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"transformer parameters that did not move: {frozen}")
            ph.fields.update(steps=TF_STEPS, seconds=f"{train_s:.2f}", eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(path5))

        with Phase("tf_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"transformer checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(tmp, "analysis")
            before = LAUNCHES["flash_attention_fwd"]
            eig, eig_init, perc, perc_init, _, _ = eval_eig(
                tcfg, {"save_path": eig_dir}, perf, ckpt_path, device=dev, batch=test_x[:bsz])
            if LAUNCHES["flash_attention_fwd"] - before != 2 * n_layers:
                raise AssertionError("eval_eig's two forwards did not go through the kernel")
            live = extract_attention_family(result.eval_model, inputs, smm)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L - 1, smm["num_heads"], n_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"transformer spectra {eig.shape}, {eig_init.shape}")
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if not (np.array_equal(saved, eig) and live_rel <= 1e-6):
                raise AssertionError(f"transformer spectra from the checkpoint differ from the "
                                     f"live model's: {live_rel}")
            if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()):
                raise AssertionError("transformer η not finite and positive")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{smm['hidden_dim']}"):
                raise AssertionError(f"transformer artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())

        with Phase("tf_serving") as ph:
            n_new = 16
            dec = Decoder(smm, result.eval_model)
            prompts = inputs[:, :TF_PROMPT]
            before = LAUNCHES["flash_attention_fwd"]
            _, last = dec.prefill(prompts, TF_PROMPT + n_new)
            torch.cuda.synchronize()
            if LAUNCHES["flash_attention_fwd"] - before != n_layers:
                raise AssertionError("prefill did not go through flash_attention_fwd once a layer")
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"transformer prefill vs forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, TF_PROMPT + n_new) or not torch.equal(out[:, :TF_PROMPT], prompts):
                raise AssertionError(f"transformer generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= smm["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            # the step path over the KV cache against the full forward on the
            # generated tokens, every position
            n_check = 8
            sw = dec.stepwise_logits(out[:n_check])
            with torch.no_grad():
                full = result.eval_model(out[:n_check])
            step_err = (sw - full).abs().max().item()
            if not torch.allclose(sw, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"transformer stepwise vs forward: {step_err}")
            try:
                dec.generate(inputs[:2], n_new)  # 512 + 16 positions against a table of 512
                raise AssertionError("generation past max_pos_embed did not raise")
            except ValueError:
                pass
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_forward_max_abs=f"{step_err:.3e}",
                             past_max_pos_embed="ValueError")
        path5_all = dict(LAUNCHES)
        print(f"[launches] transformer forward and training: {path5}; with eval_eig, serving: "
              f"{path5_all}", flush=True)
        if any(path5_all[k] for k in LAUNCHES if k not in kernels):
            raise AssertionError(f"path 5 launched other kernels: {path5_all}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (sparse head, AdamW behind the global-norm clip) from the same
    # weights and batch at dropout 0, on the card (kernels) and on the CPU
    # (plain versions), both held to the same step in float64 on the CPU
    step_cfg = dict(smm, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(smm, train_split[1], test_y)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg, generator=torch.Generator().manual_seed(sm["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase("tf_train_step_card_vs_cpu") as ph:
        # Wqkv: the projection that the dK/dV kernel's gradients sum into
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, "transformer", fresh, dev, x_step, y_step, lrs, sparse_k, TF_GRAD_RTOL_OF_MAX,
            watch=("wqkv_grad_err_over_allowed", lambda n: "Wqkv" in n))

    with Phase("tf_train_step_timing") as ph:
        ph.fields.update(step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, "flash_attention", "flash_attention"))
        del card_m, card_opt

    # the kernels at the MQAR shape: time, bound, plain version and SDPA
    with Phase("flash_attention_timing") as ph:
        attn_times, sdpa_kernels = time_flash_attention(fa, *attn_io, flush)
        for name, t in attn_times.items():
            ph.fields[name] = timing_fields(t, "sdpa_ms", "over_library")
        # which SDPA backend ran for float32, and its device kernels by name
        ph.fields["sdpa_fwd_backend"] = sdpa_kernels[0]
        ph.fields["sdpa_fwd_device_kernels_ms"] = repr(sdpa_kernels[1])
        # the same at ATTN_SHAPES' second shape, for the record
        second_name, second_io = second
        for name, t in time_flash_attention(fa, *second_io, flush)[0].items():
            ph.fields[f"{name}_{second_name}"] = timing_fields(t, "sdpa_ms", "over_library")
        del attn_io, second, second_io
        torch.cuda.empty_cache()
    return path5_all, attn_times, attn_errs


def attention_family_path(dev, test_x, test_y, train_split, want_files, full, tag: str,
                          steps: int, eval_every: int):
    """Main path 6 (``MQAR_LIN_ATTENTION_FULL``: 2 layers, d_model 128, one
    head of 128, vocab 8192, position table 512, L 512, batch 64, dropout
    0.1) or 7 (``MQAR_NORM_ATTENTION_CONV_FULL``: the same widths, softplus
    decay with its offset, elu features, scale_B, conv 4, no position table),
    weights from seed 1919.  Neither reaches a Pallas kernel in tlie_tpu (the
    chunked linear attention is XLA einsums there, PyTorch matmuls here), so
    no port kernel may launch on it: with every launch count set to 0, the
    forward on the test batch (card against CPU), ``steps`` training steps
    with 2 evals, the checkpoint reloaded and eigen-analysed (η from
    activations, against the live model's), and serving (64 prompts of 496
    tokens, prefill plus 16 greedy tokens, the step path against the full
    forward); the counts are read and printed there.  Then one card step
    against the CPU step and the step's time, device busy time, idle share
    and six largest device kernels, and the chunked linear attention's
    forward and backward alone, with its share of the step's device time.
    Returns the path's launch counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops.linear_attention import chunked_linear_attention
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    mc = full["model"]
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                               device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if logits.shape != (bsz, L, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top = top_device_ops(lambda: model(inputs))
        _, cpu_model, _ = build_models(mc, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         vs_cpu_max_abs=f"{cpu_err:.3e}", top_device_ops_ms=repr(short(top)))
        del cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    tcfg["train"].update(total_steps=steps, eval_every=eval_every)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    try:
        with Phase(f"{tag}_train") as ph:
            t0 = time.perf_counter()
            result = train(tcfg, train_split, (test_x, test_y), device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"{tag} parameters that did not move: {frozen}")
            ph.fields.update(steps=steps, seconds=f"{train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]))

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, perc, perc_init, _, _ = eval_eig(
                tcfg, {"save_path": eig_dir}, perf, ckpt_path, device=dev, batch=test_x[:bsz])
            live = extract_attention_family(result.eval_model, inputs, mc)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L - 1, mc["num_heads"], n_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"{tag} spectra {eig.shape}, {eig_init.shape}")
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if not (np.array_equal(saved, eig) and live_rel <= 1e-6):
                raise AssertionError(f"{tag} spectra from the checkpoint differ from the live "
                                     f"model's: {live_rel}")
            if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()
                    and np.isfinite(eig_init).all()):
                raise AssertionError(f"{tag} η not finite and positive")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{mc['hidden_dim']}"):
                raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             eta_median_init_trained=f"{np.median(eig_init):.4g},"
                                                     f"{np.median(eig):.4g}",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())

        with Phase(f"{tag}_serving") as ph:
            n_new = 16
            dec = Decoder(mc, result.eval_model)
            prompts = inputs[:, :ATT_PROMPT]
            _, last = dec.prefill(prompts, ATT_PROMPT + n_new)
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} prefill vs forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, ATT_PROMPT + n_new) or not torch.equal(out[:, :ATT_PROMPT],
                                                                         prompts):
                raise AssertionError(f"{tag} generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= mc["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            # the step path over the O(1) state against the full forward on
            # the generated tokens, every position
            n_check = 4
            sw = dec.stepwise_logits(out[:n_check])
            with torch.no_grad():
                full_logits = result.eval_model(out[:n_check])
            step_err = (sw - full_logits).abs().max().item()
            if not torch.allclose(sw, full_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} stepwise vs forward: {step_err}")
            past = "no position table"
            if mc["max_pos_embed"] > 0:
                try:
                    dec.generate(inputs[:2], n_new)  # 512 + 16 positions, a table of 512
                    raise AssertionError("generation past max_pos_embed did not raise")
                except ValueError:
                    past = "ValueError"
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_forward_max_abs=f"{step_err:.3e}",
                             past_max_pos_embed=past)
        launches = dict(LAUNCHES)
        print(f"[launches] {tag} attention forward, training, eval_eig and serving: {launches} "
              "(expected: none; tlie_tpu reaches no Pallas kernel on this path)", flush=True)
        if any(launches.values()):
            raise AssertionError(f"the {tag} attention path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (sparse head, AdamW behind the global-norm clip) from the same
    # weights and batch at dropout 0, on the card and on the CPU, both held to
    # the same step in float64 on the CPU
    step_cfg = dict(mc, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg,
                                    generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        card_m, card_opt, clip = step_card_vs_cpu(ph, tag, fresh, dev, x_step, y_step, lrs,
                                                  sparse_k, TF_GRAD_RTOL_OF_MAX)

    with Phase(f"{tag}_train_step_timing") as ph:
        fields = step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, None, "", n_top=6)
        ph.fields.update(fields)
        # the chunked linear attention alone, forward and backward, at the
        # path's (B, L, H, head_dim) with positive features and the layer's
        # normaliser choice: its share of the step's device time, the
        # number that says whether the op earns a kernel
        att = card_m.layers[0].attention
        normalizer = not hasattr(att, "Wvqkn")
        g = torch.Generator(device=dev).manual_seed(7)
        qkv = [torch.randn(bsz, L, att.num_heads, d, device=dev, generator=g)
               for d in (att.head_dim, att.head_dim, att.v_dim)]
        q, k = (torch.nn.functional.elu(x) + 1 for x in qkv[:2])
        leaves = [x.requires_grad_() for x in (q, k, qkv[2])]
        cot = torch.randn(bsz, L, att.num_heads, att.v_dim, device=dev, generator=g)

        def fwd_bwd():
            out = chunked_linear_attention(*leaves, return_normalizer=normalizer)
            y = out[0] / out[1][..., None] if normalizer else out
            torch.autograd.grad((y * cot).sum(), leaves)

        # between events (host waits inside it included) and, from the
        # profiler, the device time of its own kernels
        op_ms = median(cuda_ms(fwd_bwd, 11))
        op_busy = sum(t for _, t in top_device_ops(fwd_bwd, k=1000))
        ph.fields["chunked_linear_attention_fwd_bwd_ms"] = f"{op_ms:.4f}"
        ph.fields["chunked_linear_attention_fwd_bwd_device_busy_ms"] = f"{op_busy:.4f}"
        if fields["device_busy_ms"] != "not measured" and op_busy > 0:
            share = n_layers * op_busy / float(fields["device_busy_ms"])
            ph.fields["chunked_linear_attention_share_of_device"] = f"{share:.4f}"
        del card_m, card_opt, leaves, qkv, q, k, cot
        torch.cuda.empty_cache()
    return launches


def scan_s5_phase(dev, seq, u, flush, tag: str = "s5", f64: bool = False):
    """The scan kernels at S5's shape, from the S5 layer ``seq`` at its
    inputs ``u`` (B, L, H): Λ̄ as its (P,) pair (batch and time stride 0),
    B̄u as (B, L, P) pair planes.  Forward and reverse against the plain
    loop, the backward against the plain backward with da summed to (P,)
    (with ``f64`` each also against the plain loop in float64 on the same
    inputs, within the same tolerances), then their L2-cold and warm
    medians of 21 against the bytes bound, in the phases
    ``{tag}_scan_kernels_vs_plain`` and ``{tag}_scan_kernel_timing``.
    Returns {name: time_scan_kernel's tuple} and the worst errors."""
    from tlie_tpu_torch.ops.scan import (
        diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda, diag_scan_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    with torch.no_grad():
        lam_bar, b_bar = seq.discretized()
        a = (lam_bar.real.contiguous(), lam_bar.imag.contiguous())
        b = (u @ b_bar.real.T, u @ b_bar.imag.T)
    times, errs = {}, {}
    with Phase(f"{tag}_scan_kernels_vs_plain") as ph, torch.no_grad():
        for rev in (False, True):
            mode = "rev" if rev else "fwd"
            h = diag_scan_cuda(a, b, reverse=rev)
            ref = diag_scan_plain(a, b, reverse=rev)
            torch.cuda.synchronize()
            err, scale = scan_err(h, ref)
            g = tuple(torch.randn(x.shape, device=dev, generator=gen) for x in b)
            da, d = diag_scan_bwd_cuda(a, ref, g, reverse=rev)
            da_ref, d_ref = diag_scan_bwd_plain(a, ref, g, reverse=rev)
            d_e, d_tol, da_e, da_ratio = bwd_err(a, ref, da, d, da_ref, d_ref, rev)
            shape_ok = all(x.shape == a[0].shape for x in da)
            ph.fields[mode] = (f"h_rel={err / scale:.2e},d_abs={d_e:.2e}/tol={d_tol:.2e},"
                               f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                               f"da_shape={tuple(da[0].shape)}")
            ok = (err <= SCAN_RTOL_OF_MAX * scale and d_e <= d_tol and da_ratio <= 1.0
                  and shape_ok)
            if f64:  # the same inputs in float64 through the plain loops
                dbl = lambda xs: tuple(x.double() for x in xs)  # noqa: E731
                h64 = diag_scan_plain(dbl(a), dbl(b), reverse=rev)
                e64, s64 = scan_err(h, tuple(x.float() for x in h64))
                da64, d64 = diag_scan_bwd_plain(dbl(a), h64, dbl(g), reverse=rev)
                d_e64, d_tol64, _, da_ratio64 = bwd_err(
                    a, tuple(x.float() for x in h64), da, d, tuple(x.float() for x in da64),
                    tuple(x.float() for x in d64), rev)
                ph.fields[f"{mode}_vs_f64"] = (f"h_rel={e64 / s64:.2e},d_abs={d_e64:.2e}/"
                                               f"tol={d_tol64:.2e},"
                                               f"da_err_over_tol={da_ratio64:.3f}")
                ok = (ok and e64 <= SCAN_RTOL_OF_MAX * s64 and d_e64 <= d_tol64
                      and da_ratio64 <= 1.0)
            if not ok:
                raise AssertionError(f"scan kernels at S5's shape, {mode}: {ph.fields}")
            errs[mode] = (err, max(d_e, da_e))
        ph.fields.update(shape=f"b={tuple(b[0].shape)}x2,a={tuple(a[0].shape)}x2")
    with Phase(f"{tag}_scan_kernel_timing") as ph, torch.no_grad():
        h = diag_scan_cuda(a, b)
        g = tuple(torch.randn(x.shape, device=dev, generator=gen) for x in b)
        da, d = diag_scan_bwd_cuda(a, h, g)
        fwd_bytes = sum(distinct_bytes(t) for t in a + b + h)
        for rev in (False, True):
            name = "diag_scan" + ("_rev" if rev else "")
            times[name] = time_scan_kernel(lambda: diag_scan_cuda(a, b, reverse=rev),
                                           lambda: diag_scan_plain(a, b, reverse=rev),
                                           fwd_bytes, 8 * b[0].numel(), flush)
            ph.fields[name] = scan_timing_fields(times[name], fwd_bytes)
        bwd_bytes = sum(distinct_bytes(t) for t in a + h + g + da + d)
        times["diag_scan_bwd"] = time_scan_kernel(lambda: diag_scan_bwd_cuda(a, h, g),
                                                  lambda: diag_scan_bwd_plain(a, h, g),
                                                  bwd_bytes, 16 * g[0].numel(), flush)
        ph.fields["diag_scan_bwd"] = scan_timing_fields(times["diag_scan_bwd"], bwd_bytes)
    return times, errs


def ssm_checkpoint_eval_eig(ph, tag: str, dev, result, trained, tcfg, tmp: str, want_files):
    """An S5 or S4 run's checkpoint reloaded, each entry held to the live
    weights, and eigen-analysed at init and trained into ``tmp``: the
    spectra (P or N, layers) equal to the live model's, finite, inside the
    unit disc at init, and the artifact files named after the dataset.
    Fills ``ph.fields``."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
    from tlie_tpu_torch.training import restore_checkpoint

    mc = tcfg["model"]
    ckpt_path, perf = result
    ckpt = restore_checkpoint(ckpt_path)
    for k, v in trained.items():
        if not torch.equal(ckpt["model"][k], v.cpu()):
            raise AssertionError(f"{tag} checkpoint entry {k} differs from the live weights")
    eig_dir = os.path.join(tmp, "analysis")
    eig, eig_init, perc, perc_init, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf,
                                                    ckpt_path, device=dev)
    live = extract_ssm_family(ssm_layer_params({k: v.cpu() for k, v in trained.items()}), mc)
    (run_dir,) = os.listdir(eig_dir)
    files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
    saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
    conj = mc["layer"] == "s5" and mc.get("conj_sym", True)
    n_eig = mc["state_dim"] // 2 if conj else mc["state_dim"]
    if eig.shape != (n_eig, mc["num_layers"]) or eig_init.shape != eig.shape:
        raise AssertionError(f"{tag} spectra {eig.shape}, {eig_init.shape}")
    if not (np.array_equal(saved, eig) and np.array_equal(eig, live)):
        raise AssertionError(f"{tag} spectra from the checkpoint differ from the live model's")
    r_init, r = np.abs(eig_init), np.abs(eig)
    if not (np.isfinite(r).all() and np.all(r_init < 1) and np.all(r_init > 0)):
        raise AssertionError(f"{tag} spectra not finite or outside the unit disc")
    prefix = f"{tcfg['dataset']['name']}dmodel{mc['hidden_dim']}"
    if files != want_files or not run_dir.startswith(prefix):
        raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
    ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                     artifacts=run_dir, n_files=len(files), eig_shape=eig.shape,
                     radius_range_init=f"[{r_init.min():.5f}, {r_init.max():.5f}]",
                     radius_range_trained=f"[{r.min():.5f}, {r.max():.5f}]",
                     radius_pct_layer0=np.round(perc[:, 0], 1).tolist(),
                     radius_pct_init_layer0=np.round(perc_init[:, 0], 1).tolist())


def s4_kernel_share(ph, seq, n_layers: int, busy_ms):
    """S4's generating-function kernel alone (the Cauchy reduction over the
    (H, L, N) cube, then the inverse FFT), forward and backward, at the
    layer ``seq``'s parameters: its time and, from the step's device busy
    time ``busy_ms``, its share of the step (one a layer).  Fills
    ``ph.fields``."""
    from tlie_tpu_torch.models.s4 import s4_kernel_dplr

    params = list(seq.parameters())

    def kernel_fwd_bwd():
        K = s4_kernel_dplr(*seq.parameters_complex(), seq.l_max)
        torch.autograd.grad(K.sum(), params, allow_unused=True)

    op_ms = median(cuda_ms(kernel_fwd_bwd, 11))
    op_busy = sum(t for _, t in top_device_ops(kernel_fwd_bwd, k=1000))
    ph.fields["s4_kernel_fwd_bwd_ms"] = f"{op_ms:.4f}"
    ph.fields["s4_kernel_fwd_bwd_device_busy_ms"] = f"{op_busy:.4f}"
    if busy_ms != "not measured" and op_busy > 0:
        ph.fields["s4_kernel_share_of_device"] = f"{n_layers * op_busy / float(busy_ms):.4f}"


def ssm_family_path(dev, test_x, test_y, train_split, want_files, full, tag: str, steps: int,
                    eval_every: int, flush=None):
    """Main path 12 (``MQAR_S5_FULL``: 2 layers, d_model 128, state 128 (P 64
    complex channels after conj-sym), ZOH, vocab 8192, L 512, batch 64,
    BatchNorm, dropout 0.1, full_glu) or 13 (``MQAR_S4_FULL``: the same
    widths, N 128 DPLR, the CNN mode), weights from seed 1919.  With every
    launch count set to 0: the forward on the test batch (card against
    CPU), ``steps`` training steps with an eval every ``eval_every``, the
    checkpoint reloaded and eigen-analysed at init and trained (against the
    live model's spectra), serving (64 prompts of ATT_PROMPT tokens, prefill
    plus 16 greedy tokens, the step path against the full forward); the
    counts are read there.  S5 launches the scan's forward kernel once a
    layer a forward and its backward once a layer a step; S4 launches no
    port kernel (its FFT and Cauchy reduction are XLA code in tlie_tpu,
    library calls here).  Then one card step against the CPU step and the
    step's time, device busy time, idle share and six largest kernels; for
    S4 the generating-function kernel (Cauchy reduction and inverse FFT)
    alone with its share of the step; for S5 the scan kernels at its shape
    (:func:`scan_s5_phase`).  Returns (launches, S5's kernel times and
    errors or None)."""
    from tlie_tpu_torch.config import derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import prep_batch, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    mc = full["model"]
    is_s5 = mc["layer"] == "s5"
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                               device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != (n_layers if is_s5 else 0):
            raise AssertionError(f"{tag} forward launched diag_scan {LAUNCHES['diag_scan']} times")
        if logits.shape != (bsz, L, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top = top_device_ops(lambda: model(inputs))
        _, cpu_model, _ = build_models(mc, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         vs_cpu_max_abs=f"{cpu_err:.3e}", top_device_ops_ms=repr(short(top)))
        del cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    tcfg["train"].update(total_steps=steps, eval_every=eval_every)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    try:
        with Phase(f"{tag}_train") as ph:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            result = train(tcfg, train_split, (test_x, test_y), device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            n_eval_batches = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            if is_s5:  # the sparse head; one forward a layer per step and eval batch
                want.update(diag_scan=n_layers * (steps + n_eval_batches),
                            diag_scan_bwd=n_layers * steps)
            if trained_launches != want:
                raise AssertionError(f"{tag} training launches {trained_launches}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"{tag} parameters that did not move: {frozen}")
            ph.fields.update(steps=steps, seconds=f"{train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(trained_launches))

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ssm_checkpoint_eval_eig(ph, tag, dev, result, trained, tcfg, tmp, want_files)

        with Phase(f"{tag}_serving") as ph:
            n_new = 16
            dec = Decoder(mc, result.eval_model)
            prompts = inputs[:, :ATT_PROMPT]
            before = LAUNCHES["diag_scan"]
            _, last = dec.prefill(prompts)
            torch.cuda.synchronize()
            if LAUNCHES["diag_scan"] - before != (n_layers if is_s5 else 0):
                raise AssertionError(f"{tag} prefill launched diag_scan "
                                     f"{LAUNCHES['diag_scan'] - before} times")
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            # S4's prefill and step path run the dense DPLR recurrence (C̄
            # through (I − Ā^L)⁻¹), its forward the generating function: at
            # these weights they agree within the same bound as S5's
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} prefill vs forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, ATT_PROMPT + n_new) or not torch.equal(out[:, :ATT_PROMPT],
                                                                         prompts):
                raise AssertionError(f"{tag} generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= mc["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            # the step path against the full forward on the generated
            # tokens, every position
            n_check = 4
            sw = dec.stepwise_logits(out[:n_check])
            with torch.no_grad():
                full_logits = result.eval_model(out[:n_check])
            step_err = (sw - full_logits).abs().max().item()
            if not torch.allclose(sw, full_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} stepwise vs forward: {step_err}")
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_forward_max_abs=f"{step_err:.3e}",
                             logits_max_abs=f"{full_logits.abs().max().item():.3e}")
        launches = dict(LAUNCHES)
        if is_s5:
            print(f"[launches] {tag} forward, training, eval_eig and serving: {launches}; "
                  f"training alone: {trained_launches} ({n_layers} + {n_layers} a step)",
                  flush=True)
            # the forward, training and prefill counts were checked in their
            # phases; the backward launches only in training, the forward
            # also in the forward phase and serving; no other kernel
            others = {k: v for k, v in launches.items() if not k.startswith("diag_scan") and v}
            if (launches["diag_scan_bwd"] != want["diag_scan_bwd"] or want["diag_scan_bwd"] == 0
                    or launches["diag_scan"] < want["diag_scan"] + 2 * n_layers or others):
                raise AssertionError(f"the {tag} path's launches {launches}")
        else:
            print(f"[launches] {tag} forward, training, eval_eig and serving: {launches} "
                  "(expected: none; tlie_tpu reaches no Pallas kernel on this path)", flush=True)
            if any(launches.values()):
                raise AssertionError(f"the {tag} path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (sparse head, the family's groups, no clip) from the same
    # weights and batch at dropout 0, on the card and on the CPU, both held to
    # the same step in float64 on the CPU
    step_cfg = dict(mc, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
    lrs = {"regular": f["lr"], "ssm": f["ssm_lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg,
                                    generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        card_m, card_opt, clip = step_card_vs_cpu(ph, tag, fresh, dev, x_step, y_step, lrs,
                                                  sparse_k, TF_GRAD_RTOL_OF_MAX,
                                                  check_stats=True)

    with Phase(f"{tag}_train_step_timing") as ph:
        fields = step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, "diag_scan" if is_s5 else None, "scan_kernels", n_top=6)
        ph.fields.update(fields)
        if not is_s5:
            s4_kernel_share(ph, card_m.encoder.layers[0].seq, n_layers, fields["device_busy_ms"])
        del card_m, card_opt
        torch.cuda.empty_cache()

    s5_times = None
    if is_s5:
        with torch.no_grad():
            u = model.encoder.encoder(inputs)
        s5_times = scan_s5_phase(dev, model.encoder.layers[0].seq, u, flush)
    return launches, s5_times


def listops_path(dev, want_files, full, tag: str, flush=None):
    """Main path 14 (``LISTOPS_S5_FULL``: 6 layers, d_model 128, state 64 (P
    32 complex channels after conj-sym), ZOH, 8 blocks, BatchNorm, a masked
    mean pool, batch 50, l_max 2048, 10 classes) or 15 (``LISTOPS_S4_FULL``:
    the same widths, N 64 DPLR, the CNN mode), weights from seed 1919, on
    ListOps generated natively with the config's lengths (500-2000 tokens)
    and l_max.  Cuts, each against the config: LISTOPS_TRAIN training and
    LISTOPS_TEST test examples (96,000 and 2,000), LISTOPS_EPOCHS epochs
    (50) with LISTOPS_WARMUP of warmup (5), so 30 steps an epoch and 90 in
    all, an eval at each epoch's end; a resume snapshot every
    LISTOPS_SNAPSHOT steps (4,800), so one at step 60; the card-vs-CPU
    step on LISTOPS_STEP_EXAMPLES of the batch's 50 examples (the CPU runs
    the plain scan, 2,048 steps a layer, in Python).

    With every launch count set to 0: the forward on a test batch (card
    against CPU), training through ``train`` (the snapshot at step 60 kept
    as it is written), the checkpoint reloaded and eigen-analysed at init
    and trained, and the resume: the kept snapshot put back and the run
    resumed to its end, its final weights, BatchNorm statistics and eval
    lines held to the uninterrupted run's within RESUME_PARAM_ATOL; the
    counts are read there.  S5 launches the scan's forward kernel once a
    layer a forward and its backward once a layer a step; S4 no port
    kernel.  Then one card step against the CPU step, the step's time,
    device busy time and idle share (S4: the generating function's share),
    and for S5 the scan kernels held to their plain versions and timed at
    (50, 2048, 32) (:func:`scan_s5_phase`).  Returns (launches, S5's kernel
    times and errors or None)."""
    import tlie_tpu_torch.training.loop as loop_mod
    from tlie_tpu_torch.config import derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import ListOps, argmax_accuracy
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import prep_batch, train, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    mc = full["model"]
    is_s5 = mc["layer"] == "s5"
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    with Phase(f"{tag}_data") as ph:
        data = ListOps(**dict(full["dataset"], num_train=LISTOPS_TRAIN, num_test=LISTOPS_TEST))
        train_split, test_split = data.split("train"), data.split("test")
        lengths = np.concatenate([train_split[2], test_split[2]])
        ph.fields.update(generator=data.source, vocab_size=data.vocab_size,
                         train=f"{len(train_split[0])}(cut_from_96000)",
                         test=f"{len(test_split[0])}(cut_from_2000)",
                         l_max=data.l_max, lengths=f"[{lengths.min()}, {lengths.max()}]")
        # tlie_tpu generates with the native generator wherever c++ builds it
        if data.source != "native" or data.l_max != L or data.vocab_size > mc["input_dim"]:
            raise AssertionError(f"ListOps data: {ph.fields}")

    _, model, _ = build_models(mc, True, generator=torch.Generator().manual_seed(full["seed"]),
                               device=dev)
    test_batch = (test_split[0][:bsz], test_split[1][:bsz], {"lengths": test_split[2][:bsz]})
    inputs, labels = prep_batch(test_batch, L, mc["input_dim"], device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != (n_layers if is_s5 else 0):
            raise AssertionError(f"{tag} forward launched diag_scan {LAUNCHES['diag_scan']} times")
        if logits.shape != (bsz, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        acc = float(argmax_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        _, cpu_model, _ = build_models(mc, True, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model((inputs[0][:2].cpu(), inputs[1][:2].cpu()))
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(accuracy=f"{acc:.4f}", forward_ms=f"{fwd_ms:.3f}",
                         vs_cpu_max_abs=f"{cpu_err:.3e}")
        del cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    tcfg["train"].update(num_epochs=LISTOPS_EPOCHS, warmup=LISTOPS_WARMUP,
                         checkpoint_every=LISTOPS_SNAPSHOT)
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    f = train_fields(tcfg)
    kept = []
    save_resume = loop_mod.save_resume

    def keep_snapshot(path, model, optimizer, meta):
        out = save_resume(path, model, optimizer, meta)
        shutil.copyfile(out, out + ".kept")
        kept.append((out, meta["step"]))
        return out

    try:
        with Phase(f"{tag}_train") as ph:
            before = dict(LAUNCHES)
            loop_mod.save_resume = keep_snapshot
            try:
                t0 = time.perf_counter()
                result = train(tcfg, train_split, test_split, device=dev)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            finally:
                loop_mod.save_resume = save_resume
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            steps = f["total_steps"]
            n_eval_batches = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            if is_s5:  # one forward a layer per step and eval batch, one backward a step
                want.update(diag_scan=n_layers * (steps + n_eval_batches),
                            diag_scan_bwd=n_layers * steps)
            if trained_launches != want:
                raise AssertionError(f"{tag} training launches {trained_launches}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            if (len(result.history) != LISTOPS_EPOCHS or len(kept) != 1
                    or os.path.exists(kept[0][0])):
                raise AssertionError(f"{tag}: {len(result.history)} evals, snapshots {kept} "
                                     "(one expected, removed at the end)")
            trained = result.model.state_dict()
            init = build_models(mc, True, generator=torch.Generator().manual_seed(full["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"{tag} parameters that did not move: {frozen}")
            ph.fields.update(steps=steps, steps_per_epoch=f["eval_every"], warmup=f["warmup"],
                             seconds=f"{train_s:.2f}", steps_per_s=f"{steps / train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in trained_launches.items() if v}))

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ssm_checkpoint_eval_eig(ph, tag, dev, result, trained, tcfg, tmp, want_files)

        with Phase(f"{tag}_resume") as ph:
            # the run stopped at its snapshot and picked up with resume: true
            snap, snap_step = kept[0]
            os.replace(snap + ".kept", snap)
            rcfg = copy.deepcopy(tcfg)
            rcfg["train"]["resume"] = True
            rcfg["save"] = tcfg["save"]
            resumed = train(rcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            p_err = max((a.cpu() - b.cpu()).abs().max().item()
                        for a, b in zip(resumed.model.state_dict().values(), trained.values()))
            differ = [k for (k, a), b in zip(resumed.model.state_dict().items(),
                                             trained.values()) if not torch.equal(a, b)]
            h_err = max(abs(a[k] - b[k]) for a, b in zip(resumed.history, result.history)
                        for k in ("step", "train_loss", "test_loss", "test_perf"))
            ph.fields.update(resumed_at_step=snap_step,
                             evals=len(resumed.history), param_max_abs=f"{p_err:.3e}",
                             entries_not_bit_equal=f"{len(differ)}/{len(trained)}",
                             first_not_bit_equal=differ[:4], history_max_abs=f"{h_err:.3e}")
            if (len(resumed.history) != len(result.history) or p_err > RESUME_PARAM_ATOL
                    or h_err > RESUME_PARAM_ATOL or os.path.exists(snap)):
                raise AssertionError(f"{tag} resumed run vs the uninterrupted one: {ph.fields}")
        launches = dict(LAUNCHES)
        nonzero = {k: v for k, v in launches.items() if v}
        print(f"[launches] {tag} forward, training, eval_eig and resume: {nonzero}; training "
              f"alone: {({k: v for k, v in trained_launches.items() if v})}"
              + (f" ({n_layers} + {n_layers} a step)" if is_s5 else " (expected: none)"),
              flush=True)
        if is_s5:
            others = {k: v for k, v in launches.items() if not k.startswith("diag_scan") and v}
            if launches["diag_scan_bwd"] <= want["diag_scan_bwd"] or others:
                raise AssertionError(f"the {tag} path's launches {launches}")
        elif any(launches.values()):
            raise AssertionError(f"the {tag} path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step from the same weights on LISTOPS_STEP_EXAMPLES examples, on
    # the card and on the CPU, both held to the same step in float64
    lrs = {"regular": f["lr"], "ssm": f["ssm_lr"]}
    n = LISTOPS_STEP_EXAMPLES
    x_step = (torch.as_tensor(train_split[0][:n], device=dev).long(),
              torch.as_tensor(train_split[2][:n], device=dev).float())
    y_step = torch.as_tensor(train_split[1][:n], device=dev).long()

    def fresh(device):
        m, _, family = build_models(mc, True,
                                    generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mc, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        card_m, card_opt, clip = step_card_vs_cpu(ph, tag, fresh, dev, x_step, y_step, lrs,
                                                  None, TF_GRAD_RTOL_OF_MAX, check_stats=True)
        ph.fields["examples"] = n

    with Phase(f"{tag}_train_step_timing") as ph:
        x_full = (torch.as_tensor(train_split[0][:bsz], device=dev).long(),
                  torch.as_tensor(train_split[2][:bsz], device=dev).float())
        y_full = torch.as_tensor(train_split[1][:bsz], device=dev).long()
        fields = step_profile(
            lambda: train_step(card_m, card_opt, x_full, y_full, lrs, None, clip_norm=clip),
            bsz * L, "diag_scan" if is_s5 else None, "scan_kernels", n_top=6)
        ph.fields.update(fields)
        if not is_s5:
            s4_kernel_share(ph, card_m.encoder.layers[0].seq, n_layers, fields["device_busy_ms"])
        del card_m, card_opt
        torch.cuda.empty_cache()

    s5_times = None
    if is_s5:
        with torch.no_grad():
            u = model.encoder.encoder(inputs[0])
        s5_times = scan_s5_phase(dev, model.encoder.layers[0].seq, u, flush, tag)
    return launches, s5_times


def launches_since(before) -> dict:
    """The port's kernel launches since the counts ``before`` (a copy of
    ``LAUNCHES``), those that moved."""
    from tlie_tpu_torch.ops import LAUNCHES

    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}


def rel_state_err(cache, ref) -> float:
    """Worst max|a − b| / max|b| over the layers and entries (conv tail, h)
    of two Mamba decode caches, ``ref`` the step path's."""
    return max((a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
               for ca, cb in zip(cache, ref) for a, b in zip(ca, cb))


def mamba_prefill_vs_step(ph, dec, model, prompts, kernel, n_layers: int, key: str = ""):
    """The prefill of ``prompts`` through ``dec``: it must launch ``kernel``
    exactly ``n_layers`` times and no other kernel; its last logits are held
    to the full forward's, and its logits and its cache, layer by layer, to
    the step path's (which launches no kernel) after the same tokens (conv
    tail and h within STATE_RTOL_OF_MAX of the step path's max).  Fields
    under ``key``; returns the prefill's wall seconds."""
    from tlie_tpu_torch.ops import LAUNCHES

    bsz, L = prompts.shape
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = dec.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launched = launches_since(before)
    if launched != {kernel: n_layers}:
        raise AssertionError(f"{key}prefill launched {launched}, expected {kernel} {n_layers} "
                             "times and nothing else")
    with torch.no_grad():
        full = model(prompts)[:, -1]
    prefill_err = (last - full).abs().max().item()
    if not torch.allclose(last, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"{key}prefill vs forward: {prefill_err}")
    before = dict(LAUNCHES)
    stepped = dec.init_cache(bsz)
    for t in range(L):
        stepped, logits = dec.step(stepped, prompts[:, t])
    torch.cuda.synchronize()
    if launches_since(before):
        raise AssertionError(f"{key}step path launched {launches_since(before)}")
    step_err = (last - logits).abs().max().item()
    if not torch.allclose(last, logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"{key}prefill vs step path logits: {step_err}")
    state_err = rel_state_err(cache, stepped)
    if state_err > STATE_RTOL_OF_MAX:
        raise AssertionError(f"{key}prefill state vs step path: {state_err} of max")
    ph.fields.update({f"{key}prefill_shape": (bsz, L), f"{key}prefill_s": f"{prefill_s:.4f}",
                      f"{key}prefill_launches": repr(launched),
                      f"{key}prefill_vs_forward_max_abs": f"{prefill_err:.3e}",
                      f"{key}prefill_vs_step_logits_max_abs": f"{step_err:.3e}",
                      f"{key}state_vs_step_max_over_max": f"{state_err:.3e}"})
    return prefill_s


def mamba_generate(ph, dec, model, prompts, n_new: int, n_check: int, vocab: int, key: str = ""):
    """Greedy generation of ``n_new`` tokens after ``prompts`` (one warm
    call, then the prefill and the whole generation timed apart, the best
    of SERVE_REPEATS each), the output's shape, prompt and ids checked, and
    ``stepwise_logits`` of its first ``n_check`` rows held to the full
    forward at every position.  Fields under ``key``: the prefill's and the
    generation's seconds, the tokens/s and the time of one decode step;
    returns the output."""
    bsz, L0 = prompts.shape
    dec.generate(prompts, n_new)  # warm
    prefill_s, gen_s = [], []
    for _ in range(SERVE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.prefill(prompts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = dec.generate(prompts, n_new)
        torch.cuda.synchronize()
        prefill_s.append(t1 - t0)
        gen_s.append(time.perf_counter() - t1)
    prefill_s, gen_s = min(prefill_s), min(gen_s)
    if out.shape != (bsz, L0 + n_new) or not torch.equal(out[:, :L0], prompts):
        raise AssertionError(f"{key}generate output {tuple(out.shape)}")
    if int(out.min()) < 0 or int(out.max()) >= vocab:
        raise AssertionError(f"{key}generated ids out of the vocab")
    ph.fields.update({f"{key}warm_prefill_s": f"{prefill_s:.4f}",
                      f"{key}prefill_plus_generate_s": f"{gen_s:.4f}",
                      f"{key}tokens_per_s": f"{bsz * n_new / gen_s:.1f}",
                      f"{key}decode_step_ms": f"{(gen_s - prefill_s) / (n_new - 1) * 1e3:.3f}"})
    if n_check:
        sw = dec.stepwise_logits(out[:n_check])
        with torch.no_grad():
            full = model(out[:n_check])
        step_err = (sw - full).abs().max().item()
        if not torch.allclose(sw, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{key}stepwise vs forward: {step_err}")
        ph.fields.update({f"{key}stepwise_vs_forward_max_abs": f"{step_err:.3e}",
                          f"{key}stepwise_rows": (n_check, L0 + n_new)})
    return out


def decode_step_profile(ph, dec, cache, tok, key: str):
    """One decode step's time from CUDA events around 20 back-to-back steps
    from ``cache`` (:func:`step_profile`), and from ``torch.profiler`` its
    device busy time, idle share and device time by kind, under ``key``:
    how far the host paces a step."""
    fields = step_profile(lambda: dec.step(cache, tok), tok.shape[0], None, "", n_top=8)
    fields.pop("train_tokens_per_s")
    ph.fields.update({key + k: v for k, v in fields.items()})


def mqar_mamba_serving(dev, ckpt_path, model, inputs, n_layers: int, vocab: int):
    """Path 4's serving (``mamba_serving``): the decoder from the
    checkpoint (``Decoder.from_checkpoint``), the prefill of the first
    TF_PROMPT tokens of ``inputs`` (the chunk 128, three chunks) held to the
    forward and to the step path, MAMBA_NEW greedy tokens and their
    stepwise logits against the forward, the prefill of MAMBA_PROMPT_Q16
    tokens (the chunk 16, 31 chunks) likewise, sampling at SAMPLE_ARGS from
    a seeded generator (the ids in the vocabulary, a second generator of
    the same seed drawing the same tokens, top_k 1 equal to greedy), and
    ``python -m tlie_tpu_torch.tools.generate`` on the checkpoint in a
    subprocess (64 rows of TF_PROMPT + MAMBA_NEW ids), and a decode step's
    profile (:func:`decode_step_profile`).  Returns the decoder."""
    from tlie_tpu_torch.inference import Decoder

    with Phase("mamba_serving") as ph:
        dec = Decoder.from_checkpoint(ckpt_path, device=dev)
        bsz = inputs.shape[0]
        prompts = inputs[:, :TF_PROMPT]
        mamba_prefill_vs_step(ph, dec, model, prompts, "decay_attention_fwd", n_layers)
        greedy = mamba_generate(ph, dec, model, prompts, MAMBA_NEW, 4, vocab)
        decode_step_profile(ph, dec, dec.prefill(prompts)[0], greedy[:, TF_PROMPT],
                            "decode_step_")
        mamba_prefill_vs_step(ph, dec, model, inputs[:, :MAMBA_PROMPT_Q16],
                              "decay_attention_fwd", n_layers, key="q16_")
        draws = [dec.generate(prompts, MAMBA_NEW, generator=torch.Generator(
            device=dev).manual_seed(SAMPLE_SEED), **SAMPLE_ARGS) for _ in range(2)]
        if not torch.equal(draws[0], draws[1]):
            raise AssertionError("two generators of one seed drew different tokens")
        if int(draws[0].min()) < 0 or int(draws[0].max()) >= vocab:
            raise AssertionError("sampled ids out of the vocab")
        top1 = dec.generate(prompts, MAMBA_NEW, temperature=SAMPLE_ARGS["temperature"], top_k=1,
                            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))
        if not torch.equal(top1, greedy):
            raise AssertionError("top_k 1 sampling differs from greedy generation")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tlie_tpu_torch.tools.generate", ckpt_path, "--n_new",
             str(MAMBA_NEW), "--batch", str(bsz), "--prompt_len", str(TF_PROMPT), "--seed", "0",
             "--device", dev.type],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        rows = [[int(t) for t in line.split()] for line in proc.stdout.splitlines()]
        if proc.returncode != 0 or len(rows) != bsz or any(
                len(r) != TF_PROMPT + MAMBA_NEW or min(r) < 0 or max(r) >= vocab for r in rows):
            raise AssertionError(f"tools.generate: exit {proc.returncode}, {len(rows)} rows; "
                                 f"{proc.stderr[-2000:]}")
        ph.fields.update(sampled=f"{SAMPLE_ARGS},seed={SAMPLE_SEED}:repeats,in_vocab",
                         sampled_differs_from_greedy=not torch.equal(draws[0], greedy),
                         top_k_1="greedy", cli_rows=(len(rows), len(rows[0])),
                         cli_s=f"{cli_s:.2f}")
    return dec


def mamba_lti_serving(dev, mm, inputs, n_layers: int):
    """The pseudo-LTI variant (``SSD_LTI``) at path 4's widths, untrained,
    weights from LTI_SEED (``mamba_lti_serving``): the prefill of
    TF_PROMPT tokens held to the forward and the step path, with its
    launches, then MAMBA_NEW greedy tokens and their stepwise logits
    against the forward.  Returns (decoder, model)."""
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models

    with Phase("mamba_lti_serving") as ph:
        cfg = dict(mm, pseudoLTI=True)
        _, model, _ = build_models(cfg, generator=torch.Generator().manual_seed(LTI_SEED),
                                   device=dev)
        dec = Decoder(cfg, model, device=dev)
        prompts = inputs[:, :TF_PROMPT]
        mamba_prefill_vs_step(ph, dec, model, prompts, "decay_attention_fwd", n_layers)
        mamba_generate(ph, dec, model, prompts, MAMBA_NEW, 4, cfg["output_dim"])
    return dec, model


def wt_mamba2_serving(dev, m, model, blocks):
    """Path 8's serving (``wt_mamba2_serving``): WT_SERVE_ROWS prompts of a
    whole block (one chunk of 1,024) and MAMBA_NEW greedy tokens, the
    prefill held to the forward and the step path, the stepwise logits of
    WT_CHECK_ROWS generated rows to the forward at every position, then the
    same with the state stored in bfloat16 (``state_dtype``): its times and
    its largest logit drift from the float32 state over the MAMBA_NEW steps
    of the float32 state's tokens; then a decode step's profile with each
    state (:func:`decode_step_profile`)."""
    from tlie_tpu_torch.inference import Decoder

    with Phase("wt_mamba2_serving") as ph:
        prompts = torch.as_tensor(np.asarray(blocks[:WT_SERVE_ROWS]), device=dev).long()
        n_layers = m["num_layers"]
        dec = Decoder(m, model, device=dev)
        mamba_prefill_vs_step(ph, dec, model, prompts, "decay_attention_fwd", n_layers)
        out = mamba_generate(ph, dec, model, prompts, MAMBA_NEW, WT_CHECK_ROWS, m["output_dim"])
        dec16 = Decoder(m, model, device=dev, state_dtype=torch.bfloat16)
        out16 = mamba_generate(ph, dec16, model, prompts, MAMBA_NEW, 0, m["output_dim"],
                               key="bf16_state_")
        L0 = prompts.shape[1]
        (c32, lg32), (c16, lg16) = dec.prefill(prompts), dec16.prefill(prompts)
        if {h.dtype for _, h in c16} != {torch.bfloat16}:
            raise AssertionError("the bfloat16 state is not stored in bfloat16")
        drift = []
        for i in range(MAMBA_NEW):
            drift.append((lg16 - lg32).abs().max().item())
            if i + 1 < MAMBA_NEW:
                tok = out[:, L0 + i]
                c32, lg32 = dec.step(c32, tok)
                c16, lg16 = dec16.step(c16, tok)
        for key, d, c in (("f32_state_step_", dec, c32), ("bf16_state_step_", dec16, c16)):
            decode_step_profile(ph, d, c, out[:, -1], key)
        ph.fields.update(bf16_state_logit_drift_max_abs=f"{max(drift):.3e}",
                         bf16_state_logit_drift_by_step=[f"{d:.2e}" for d in drift],
                         bf16_state_tokens_equal_share=f"{(out16 == out).float().mean().item():.4f}")
    return dec


def mamba1_serving(dev, mc, model, prompts):
    """Path 18's serving (``mamba1_serving``): the prefill of ``prompts``
    through the scan's forward kernel on the (B, L, d_inner·N) view, held to
    the forward and the step path, MAMBA_NEW greedy tokens and the stepwise
    logits of 4 generated rows against the forward.  Returns the
    decoder."""
    from tlie_tpu_torch.inference import Decoder

    with Phase("mamba1_serving") as ph:
        dec = Decoder(mc, model, device=dev)
        mamba_prefill_vs_step(ph, dec, model, prompts, "diag_scan", mc["num_layers"])
        mamba_generate(ph, dec, model, prompts, MAMBA_NEW, 4, mc["output_dim"])
        ph.fields["scan_view"] = (prompts.shape[0], prompts.shape[1],
                                  mc["expansion"] * mc["hidden_dim"] * mc["state_dim"])
    return dec


def prefill_operands(module, name: str, dec, prompts):
    """The operands of the first call of ``module.name`` (the decay
    attention inside the SSD's chunked scan, or Mamba-1's scan) in one
    prefill of ``prompts``: the kernel's inputs at the serving shape."""
    seen, real = [], getattr(module, name)
    setattr(module, name, lambda *a, **kw: (seen.append(a), real(*a, **kw))[1])
    try:
        dec.prefill(prompts)
    finally:
        setattr(module, name, real)
    return seen[0]


def decay_fwd_at_prefill(ph, dattn, dec, prompts, flush, key: str):
    """The decay attention's forward kernel at a prefill's own operands:
    held to the plain version (each element within SSD_RTOL of its term
    sums) and timed against its bound and the plain version
    (:func:`time_decay_attention`)."""
    import tlie_tpu_torch.ops.ssd as ssd_mod

    C, B, cs, x = prefill_operands(ssd_mod, "decay_attention", dec, prompts)
    y = dattn.decay_attention_fwd_cuda(C, B, cs, x)
    want = dattn.decay_attention_plain(C, B, cs, x)
    scale = dattn.term_scales(C, B, cs, x, torch.zeros_like(x))[0]
    ratio = ((y - want).abs() / (SSD_RTOL * scale + 1e-30)).max().item()
    if not (ratio <= 1.0 and bool(torch.isfinite(y).all())):
        raise AssertionError(f"decay_attention_fwd at {key}: err over tol {ratio}")
    t = time_decay_attention(dattn, C, B, cs, x, None, flush, kernels=("decay_attention_fwd",))
    shape = (x.shape[0], x.shape[2], C.shape[2], x.shape[1], x.shape[3])  # (BG, Q, N, Hg, P)
    ph.fields[f"{key}_bg_q_n_hg_p"] = shape
    ph.fields[f"{key}_err_over_tol"] = f"{ratio:.3e}"
    ph.fields[f"{key}_max_abs_err"] = f"{(y - want).abs().max().item():.3e}"
    ph.fields[key] = timing_fields(t["decay_attention_fwd"], "einsum_ms", "over_einsum")
    return t["decay_attention_fwd"]


def scan_fwd_at_prefill(ph, dec, prompts, flush, key: str):
    """The scan's forward kernel at a Mamba-1 prefill's own decay and input
    ((B, L, d_inner·N), a full and varying in time): held to the plain
    version (within SCAN_RTOL_OF_MAX of max|h|) and timed against its bytes
    bound and the plain loop (:func:`time_scan_kernel`)."""
    import tlie_tpu_torch.models.mamba2 as m2
    from tlie_tpu_torch.ops.scan import diag_scan_cuda, diag_scan_plain

    a, b = (t.contiguous() for t in prefill_operands(m2, "diag_linear_scan", dec, prompts))
    h = diag_scan_cuda(a, b)
    err, scale = scan_err(h, diag_scan_plain(a, b))
    if not err <= SCAN_RTOL_OF_MAX * scale:
        raise AssertionError(f"diag_scan at {key}: {err} of max {scale}")
    n_bytes = sum(distinct_bytes(t) for t in (a, b, h))
    t = time_scan_kernel(lambda: diag_scan_cuda(a, b), lambda: diag_scan_plain(a, b), n_bytes,
                         2 * b.numel(), flush)
    ph.fields[f"{key}_shape"] = tuple(b.shape)
    ph.fields[f"{key}_rel_err"] = f"{err / scale:.3e}"
    ph.fields[key] = scan_timing_fields(t, n_bytes)
    return t


REPO = os.path.dirname(os.path.abspath(__file__))


def wikitext_splits():
    """The synthetic WikiText-103 stream of ``configs/wikitext-mamba2-short.yaml``
    (block 1024), built once for paths 8 and 9: (train, test, l_max)."""
    from tlie_tpu_torch.config import load_yaml
    from tlie_tpu_torch.data import WikiText

    with Phase("wt_mamba2_data") as ph:
        cfg = load_yaml(os.path.join(REPO, "configs", "wikitext-mamba2-short.yaml"))
        data = WikiText(**cfg["dataset"])
        train_split, test_split = data.split("train"), data.split("test")
        ph.fields.update(train_blocks=len(train_split[0]), test_blocks=len(test_split[0]),
                         block=data.l_max, vocab=data.d_output)
    return train_split, test_split, data.l_max


def wikitext_mamba2_path(dev, splits, config: str, tag: str, want_files, serve: bool = False):
    """Main path 8 (``configs/wikitext-mamba2-short.yaml``: 6 layers, d_model
    and N 512, 8 heads of 64, block 1024, batch 8, vocab 50,257, the dense
    head, float32), 9 (``configs/wikitext-mamba2-short-bf16.yaml``, the
    same model with ``compute_dtype: bfloat16``) or 11
    (``configs/wikitext-mamba2-short-bf16-fused.yaml``, the bfloat16 model
    with ``fused_xent: true``), weights from seed 1919, on the synthetic
    stream: with every count set to 0, ``WT_STEPS`` training steps and one
    perplexity eval (the dense forward, as tlie_tpu evaluates); the counts
    read there must be the decay attention's three kernels of the path's
    dtype alone (the forward once per layer per step and eval batch, each
    backward once per layer per step) and, on path 11, the fused head's
    three bfloat16 kernels once each per step, no float32 head kernel and
    no training step through the dense head.  Then the checkpoint reloaded
    and eigen-analysed (float32, as tlie_tpu extracts: the analysis launches
    the float32 forward, counted apart), and a training step's time, idle
    share and the decay attention's (and the fused head's) share of device
    time.  With ``serve`` (path 8) the trained model is served after the
    eigen-analysis (:func:`wt_mamba2_serving`).  Returns the counts after
    the eigen-analysis (training's and the analysis's float32 forwards) and
    the serving."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import derive_runtime_fields, load_yaml, train_fields
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import fused_xent as fx
    from tlie_tpu_torch.ops.decay_attention import LOAD_ROUTES, launch_name
    from tlie_tpu_torch.training import restore_checkpoint, steps, train, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    train_split, test_split, l_max = splits
    cfg = load_yaml(os.path.join(REPO, "configs", config))
    m = cfg["model"]
    bsz, layers = cfg["train"]["batch_size"], m["num_layers"]
    dtype = torch.bfloat16 if m.get("compute_dtype") == "bfloat16" else torch.float32
    fused = bool(cfg["train"].get("fused_xent", False))
    names = {k: launch_name(k, dtype) for k in ("fwd", "bwd_i", "bwd_j")}
    head_names = [fx.launch_name(k, dtype) for k in ("fwd", "dh", "dw")] if fused else []
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    cfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(cfg["save"]))
    cfg["train"].update(total_steps=WT_STEPS, eval_every=WT_STEPS)
    cfg = derive_runtime_fields(cfg, l_max, len(train_split[0]))
    m = cfg["model"]
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LOAD_ROUTES.clear()
        with Phase(f"{tag}_train") as ph:
            dense_steps = []  # training steps through the dense head
            real_head_logits = steps.head_logits
            steps.head_logits = lambda *a: (dense_steps.append(1), real_head_logits(*a))[1]
            try:
                t0 = time.perf_counter()
                result = train(cfg, train_split, test_split, device=dev)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            finally:
                steps.head_logits = real_head_logits
            launches = dict(LAUNCHES)
            n_eval = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update({names["fwd"]: layers * (WT_STEPS + n_eval),
                         names["bwd_i"]: layers * WT_STEPS, names["bwd_j"]: layers * WT_STEPS})
            want.update(dict.fromkeys(head_names, WT_STEPS))
            if launches != want:
                raise AssertionError(f"{tag} training launches {launches}, expected {want}")
            # how the bfloat16 kernels' tiles landed: by 16-byte cp.async, C
            # and B (views into the conv output), xdt and dy alike
            routes = dict(LOAD_ROUTES)
            if dtype == torch.bfloat16 and (
                    sum(routes.values()) != sum(launches[n] for n in names.values())
                    or any(not k.endswith(":cp.async16") for k in routes)):
                raise AssertionError(f"{tag} bfloat16 load routes {routes}")
            if len(dense_steps) != (0 if fused else WT_STEPS):
                raise AssertionError(f"{tag}: {len(dense_steps)} training steps through the "
                                     "dense head")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"{tag} training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(m, generator=torch.Generator().manual_seed(cfg["seed"]),
                                device=dev)[0].state_dict()
            bad = [k for k, v in trained.items()
                   if v.dtype != torch.float32 or torch.equal(v, init[k])]
            if bad:
                raise AssertionError(f"{tag} parameters not float32 or not moved: {bad}")
            ph.fields.update(steps=WT_STEPS, seconds=f"{train_s:.2f}", eval_batches=n_eval,
                             compute_dtype=str(dtype), fused_head=fused,
                             dense_head_steps=len(dense_steps), load_routes=repr(routes),
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in launches.items() if v}))
            del init

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                         "weights")
            batch = test_split[0][:bsz]  # configs/analysis/wikitext.yaml's batch_size: 8
            before = dict(LAUNCHES)
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, perc, perc_init, _, _ = eval_eig(cfg, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            eig_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                            if LAUNCHES[k] != before[k]}
            path_all = dict(LAUNCHES)  # the path's: training and the analysis
            # the spectra of the trained weights in a float32 model
            f32_cfg = {k: v for k, v in m.items() if k != "compute_dtype"}
            _, f32_model, _ = build_models(f32_cfg, generator=torch.Generator(), device=dev)
            f32_model.load_state_dict(ckpt["model"])
            live = extract_attention_family(
                f32_model, torch.as_tensor(np.asarray(batch), device=dev).long(), f32_cfg)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            want_shape = (bsz, m["seq_len"], m["num_heads"], layers)
            if eig.shape != want_shape or eig.dtype != np.float32 or not np.array_equal(eig, live):
                raise AssertionError(f"{tag} spectra {eig.shape} {eig.dtype} differ from the "
                                     "float32 extraction of the trained weights")
            if not (np.all((eig_init > 0) & (eig_init <= 1)) and np.all((eig > 0) & (eig <= 1))):
                raise AssertionError(f"{tag} eigenvalues outside (0, 1]")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
            if eig_launches != {"decay_attention_fwd": 2 * layers}:
                raise AssertionError(f"{tag} eigen-analysis launches {eig_launches}, expected "
                                     "the float32 forward of the init and trained models")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perplexity=f"{perf:.3f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_launches=repr(eig_launches),
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
            del f32_model, ckpt

        if serve:
            wt_mamba2_serving(dev, m, result.eval_model, test_split[0])
            path_all = dict(LAUNCHES)

        with Phase(f"{tag}_train_step_timing") as ph:
            f = train_fields(cfg)
            opt, clip = make_family_optimizer(result.model, "mamba", m, cfg["train"], f)
            x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
            y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
            lrs = {"regular": f["lr"]}
            ph.fields.update(step_profile(
                lambda: train_step(result.model, opt, x, y, lrs, None, fused_head=fused,
                                   clip_norm=clip),
                bsz * m["seq_len"], "decay_attention", "decay_attention", n_warm=2, n_timed=5,
                also={"fused_head": "xent"} if fused else None))
            del opt, x, y
        print(f"[launches] {tag} training: {launches}; eval_eig (float32): {eig_launches}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result
    torch.cuda.empty_cache()
    return path_all


def sweep_path(dev, test_x, test_y, train_split, want_files):
    """Main path 10: ``tlie_tpu_torch.parallel.run_sweep`` (``launch
    --sweep_parallel``) on the four seeds of ``bench.py::_bench_sweep_grid``
    (SWEEP_SEEDS) of ``MQAR_LIN_ATTENTION_FULL`` at its rate, stacked on the
    card, along :func:`kernel_sweep_path`'s phases: SWEEP_STEPS steps with an
    eval every SWEEP_EVAL_EVERY, no port kernel launched (the linear
    attention reaches none), the rerun from the journal, one point against
    its serial run at dropout 0 and the stacked step against a serial step.
    Returns the counts."""
    from tlie_tpu_torch.config import MQAR_LIN_ATTENTION_FULL

    return kernel_sweep_path(dev, "sweep", MQAR_LIN_ATTENTION_FULL,
                             [{("seed",): seed} for seed in SWEEP_SEEDS], train_split,
                             (test_x, test_y), want_files, SWEEP_STEPS, SWEEP_EVAL_EVERY,
                             lambda mc: {})


def gradient_free(name: str, model_cfg, shape) -> torch.Tensor:
    """The elements of parameter ``name`` whose gradient is 0 in exact
    arithmetic, so that their float32 gradient is rounding noise, which
    Adam (dividing each element by its own magnitude) turns into steps of
    ±lr that two runs need not share: the softmax attention's key bias
    (adding it shifts every score of a query by one constant, which the
    softmax removes).  A bool mask of ``shape``, on the CPU."""
    free = torch.zeros(shape, dtype=torch.bool)
    if model_cfg.get("attention_fn") == "sm-attention" and name.endswith("attention.Wqkv.bias"):
        d_qk = (shape[0] - model_cfg["hidden_dim"]) // 2
        free[d_qk:2 * d_qk] = True
    return free


def _flat(xs):
    return [t for x in xs for t in (x if isinstance(x, (list, tuple)) else [x])]


def vmap_check(ph, tag: str, loss, args, n_diff: int, per_point, launches, rtol_of_max: float):
    """One vmap rule at a path shape: ``torch.func.vmap(grad_and_value(loss,
    has_aux=True))`` over ``args`` (each (GRID, ...)), whose aux is the
    kernel's output, against ``per_point(g)`` (the output and gradients of
    point g's own call; the first ``n_diff`` arguments differentiated), each
    output and gradient within ``rtol_of_max``
    of its max|.|; the launches of the grid's one call must be
    ``launches`` exactly.  Records the worst error over its tolerance and
    whether every tensor came out bit for bit."""
    from tlie_tpu_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    grads, (_, out) = torch.func.vmap(
        torch.func.grad_and_value(loss, argnums=tuple(range(n_diff)), has_aux=True))(*args)
    torch.cuda.synchronize()
    got = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES if LAUNCHES[k] != before.get(k, 0)}
    if got != launches:
        raise AssertionError(f"vmap rule {tag}: the grid launched {got}, not {launches}")
    worst, bitwise = 0.0, True
    for g in range(GRID):
        want_out, want_grads = per_point(g)
        for a, b in zip([out] + _flat(grads), [want_out] + _flat(want_grads), strict=True):
            a, b = a[g].float(), b.float()
            bitwise = bitwise and torch.equal(a, b)
            worst = max(worst, (a - b).abs().max().item()
                        / max(rtol_of_max * b.abs().max().item(), 1e-30))
    ph.fields[tag] = f"launches={got},err_over_tol={worst:.3e},bitwise={bitwise}"
    if worst > 1.0:
        raise AssertionError(f"vmap rule {tag}: {ph.fields[tag]}")
    return worst


def vmap_rules_phase(dev, flush):
    """The vmap rules of the scan's, the decay attention's and the flash
    attention's Functions at one path shape each, GRID points with their own
    operands under ``vmap(grad_and_value)`` as a stacked sweep runs them,
    against each point's own call (output and every gradient, VMAP_RTOL_OF_MAX
    of max|.|, or one bfloat16 step on bfloat16 outputs): the scan, (re, im)
    pairs at the MQAR LRU's (64, 512, 128) and real at the same shape, each
    point its own (N,) decay; the decay attention's float32 kernels at the
    MQAR Mamba-2's (64, 512, 128, 1, 128) and bfloat16 ones at the WikiText
    Mamba-2's (8, 1024, 512, 8, 64); the flash kernels at the MQAR
    transformer's (64, 512, 1, 128).  The grid takes one launch of each
    kernel.  Then each kernel is timed at the grid's folded shape against
    its bound.  Returns the folded timings {name: (ms, warm_ms, plain_ms,
    library_ms or None, bound_ms, bound_by)}."""
    from tlie_tpu_torch.ops import attention as fa
    from tlie_tpu_torch.ops import decay_attention as dattn
    from tlie_tpu_torch.ops.scan import (
        diag_linear_scan, diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda,
        diag_scan_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(29)
    G = GRID
    with Phase("vmap_rules") as ph:
        B, L, N = VMAP_SCAN_SHAPE
        for pair in (True, False):
            planes = 2 if pair else 1
            r = 0.9 + 0.09 * torch.rand(G, N, device=dev, generator=gen)
            th = 6.28 * torch.rand(G, N, device=dev, generator=gen)
            a = [r * torch.cos(th), r * torch.sin(th)][:planes] if pair else [r]
            b = [torch.randn(G, B, L, N, device=dev, generator=gen) for _ in range(planes)]
            w = torch.randn(B, L, N, device=dev, generator=gen)

            def scan_loss(a, b, pair=pair, w=w):
                h = diag_linear_scan(tuple(a) if pair else a[0], tuple(b) if pair else b[0])
                h0 = h[0] if pair else h
                return (h0 * w).sum() + ((h[1] * w).sum() if pair else 0.0), h0

            def scan_point(g, a=a, b=b, scan_loss=scan_loss):
                leaves = [[t[g].clone().requires_grad_() for t in x] for x in (a, b)]
                value, h0 = scan_loss(*leaves)
                value.backward()
                return h0.detach(), [[t.grad for t in x] for x in leaves]

            vmap_check(ph, f"scan_{'pair' if pair else 'real'}_g{G}_b{B}_l{L}_n{N}", scan_loss,
                       [a, b], 2, scan_point, {"diag_scan": 1, "diag_scan_bwd": 1},
                       VMAP_RTOL_OF_MAX)
            del a, b

        for dtype, (BG, Q, Nd, Hg, P) in ((torch.float32, VMAP_DECAY_SHAPE),
                                          (torch.bfloat16, VMAP_DECAY_BF16_SHAPE)):
            # the grid's operands: C a row-strided view, as the SSD's
            C, Bm, cs, x, dy = (t.reshape(G, BG, *t.shape[1:]) for t in decay_inputs(
                dev, gen, G * BG, Q, Nd, Hg, P, dtype))

            def decay_loss(C, Bm, cs, x, dy=dy):
                y = dattn.decay_attention(C, Bm, cs, x)
                return (y.float() * dy.float()).sum(), y

            def decay_point(g, C=C, Bm=Bm, cs=cs, x=x, decay_loss=decay_loss):
                leaves = [t[g].clone().requires_grad_() for t in (C, Bm, cs, x)]
                value, y = decay_loss(*leaves, dy=dy[g])
                value.backward()
                return y.detach(), [t.grad for t in leaves]

            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            vmap_check(ph, f"decay_attention{suffix}_g{G}_bg{BG}_q{Q}_n{Nd}_hg{Hg}_p{P}",
                       lambda C, Bm, cs, x, dy: decay_loss(C, Bm, cs, x, dy),
                       [C, Bm, cs, x, dy], 4, decay_point,
                       {f"decay_attention_{k}{suffix}": 1 for k in ("fwd", "bwd_i", "bwd_j")},
                       BF16_STEP if dtype == torch.bfloat16 else VMAP_RTOL_OF_MAX)
            del C, Bm, cs, x, dy

        Ba, La, H, D = VMAP_ATTN_SHAPE
        qkv = torch.randn(G, Ba, La, 3 * H * D + 8, device=dev, generator=gen)
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(G, Ba, La, H, D)
                   for i in range(3))
        do = torch.randn(G, Ba, La, H, D, device=dev, generator=gen)

        def attn_loss(q, k, v, do):
            o = fa.causal_softmax_attention(q, k, v)
            return (o * do).sum(), o

        def attn_point(g):
            leaves = [t[g].clone().requires_grad_() for t in (q, k, v)]
            value, o = attn_loss(*leaves, do[g])
            value.backward()
            return o.detach(), [t.grad for t in leaves]

        vmap_check(ph, f"flash_attention_g{G}_b{Ba}_l{La}_h{H}_d{D}", attn_loss, [q, k, v, do],
                   3, attn_point, {f"flash_attention_{k}": 1 for k in ("fwd", "bwd_dkv", "bwd_dq")},
                   VMAP_RTOL_OF_MAX)
        del qkv, q, k, v, do
        torch.cuda.empty_cache()

    # each kernel at the grid's folded shape: GRID points' batch in one launch
    folded = {}
    with Phase("vmap_fold_timing") as ph:
        B, L, N = VMAP_SCAN_SHAPE
        r = 0.9 + 0.09 * torch.rand(G, 1, 1, N, device=dev, generator=gen)
        th = 6.28 * torch.rand(G, 1, 1, N, device=dev, generator=gen)
        # the rule's a: each point's (N,) decay broadcast over its batch
        a = tuple((r * f(th)).expand(G, B, 1, N).contiguous() for f in (torch.cos, torch.sin))
        b = tuple(torch.randn(G, B, L, N, device=dev, generator=gen) for _ in range(2))
        g = tuple(torch.randn(G, B, L, N, device=dev, generator=gen) for _ in range(2))
        with torch.no_grad():
            h = diag_scan_cuda(a, b)
            da, d = diag_scan_bwd_cuda(a, h, g)
        fwd_bytes = sum(distinct_bytes(t) for t in a + b + h)
        bwd_bytes = sum(distinct_bytes(t) for t in a + h + g + da + d)
        for name, fn, plain, n_bytes, flops in (
                ("diag_scan", lambda: diag_scan_cuda(a, b), lambda: diag_scan_plain(a, b),
                 fwd_bytes, 8 * b[0].numel()),
                ("diag_scan_bwd", lambda: diag_scan_bwd_cuda(a, h, g),
                 lambda: diag_scan_bwd_plain(a, h, g), bwd_bytes, 16 * g[0].numel())):
            t = time_scan_kernel(fn, plain, n_bytes, flops, flush)
            folded[name] = (t[0], t[1], t[2], None, t[3], t[4])
            ph.fields[f"{name}_g{G}_b{G * B}_l{L}_n{N}"] = scan_timing_fields(t, n_bytes)
        del a, b, h, g, da, d
        for dtype, (BG, Q, Nd, Hg, P) in ((torch.float32, VMAP_DECAY_SHAPE),
                                          (torch.bfloat16, VMAP_DECAY_BF16_SHAPE)):
            ins = decay_inputs(dev, gen, G * BG, Q, Nd, Hg, P, dtype)
            for name, t in time_decay_attention(dattn, *ins, flush).items():
                folded[name] = (t[0], t[1], t[2], None, t[4], t[5])
                ph.fields[f"{name}_bg{G * BG}_q{Q}_n{Nd}_hg{Hg}_p{P}"] = timing_fields(
                    t, "einsum_ms", "over_einsum")
            del ins
        Ba, La, H, D = VMAP_ATTN_SHAPE
        q, k, v, do = attention_inputs(dev, gen, G * Ba, La, H, D)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, 1.0 / math.sqrt(D))
        for name, t in time_flash_attention(fa, q, k, v, do, lse, fa.attention_di(o, do),
                                            flush)[0].items():
            folded[name] = (t[0], t[1], t[2], t[3], t[4], t[5])
            ph.fields[f"{name}_b{G * Ba}_l{La}_h{H}_d{D}"] = timing_fields(t, "sdpa_ms",
                                                                          "over_library")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return folded


def kernel_sweep_specs():
    """Paths 29-31 as ``{tag: (base config, points, steps, eval_every,
    per_step)}``, ``per_step`` giving a model config's kernel launches a
    training step: the MQAR LRU's seeds (SWEEP_SEEDS; the scan's two
    kernels, one of each a layer), ``configs/sweep/mqar-mamba2-layers.yaml``
    (the decay attention's three, one of each a layer) and
    ``configs/sweep/mqar-sm-attention-seeds.yaml`` (the flash attention's
    three, one of each a layer)."""
    from tlie_tpu_torch.config import MQAR_LRU_FULL, expand_sweep, load_sweep

    specs = {"lru_sweep": (MQAR_LRU_FULL, [{("seed",): s} for s in SWEEP_SEEDS], KSWEEP_STEPS,
                           KSWEEP_EVAL_EVERY, lambda mc: {"diag_scan": mc["num_layers"],
                                                          "diag_scan_bwd": mc["num_layers"]})}
    for tag, sweep_file, kinds in (
            ("mamba2_layers_sweep", MAMBA2_LAYERS_SWEEP,
             ("decay_attention_fwd", "decay_attention_bwd_i", "decay_attention_bwd_j")),
            ("sm_seeds_sweep", SM_SEEDS_SWEEP,
             ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"))):
        base, spec = load_sweep(os.path.join(REPO, sweep_file),
                                config_root=os.path.join(REPO, "configs"))
        specs[tag] = (base.raw, expand_sweep(spec), KSWEEP_SHORT_STEPS, KSWEEP_SHORT_EVAL_EVERY,
                      lambda mc, kinds=kinds: dict.fromkeys(kinds, mc["num_layers"]))
    return specs


def kernel_sweep_path(dev, tag: str, base_raw, points, train_split, test_split, want_files,
                      steps: int, eval_every: int, per_step):
    """Main paths 10 and 29-31: a stacked sweep through
    ``tlie_tpu_torch.parallel.run_sweep`` (``launch --sweep_parallel``):
    ``points`` over ``base_raw`` (waves of GRID points, one for each group of
    the sweep), ``steps`` stacked steps with an eval every ``eval_every``,
    each point checkpointed, journaled and eigen-analysed, the waves'
    point-steps/s and peak device memory; the counts set to 0 before and
    read after, each backward kernel launched exactly ``per_step(model
    config)`` times a stacked step and no kernel outside ``per_step``.  Then the sweep again, which must skip
    every point from the journal; the first group at dropout 0 for
    SWEEP_CHECK_STEPS, its first point against the same point trained alone
    (losses, metrics, parameters and BatchNorm statistics); and for each
    group one stacked step's launches against one serial step's (both
    ``per_step``), and the two steps timed.  Returns the counts."""
    from tlie_tpu_torch.config import (
        ExperimentConfig, apply_sweep_point, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import run_sweep
    from tlie_tpu_torch.parallel.sweep import (
        _group_signature, _journal_path, _load_journal, _stacked_state, optimizer_groups,
        stacked_adamw_step, stacked_grads,
    )
    from tlie_tpu_torch.training import restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    L = train_split[0].shape[1]
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    raw = copy.deepcopy(base_raw)
    raw["save"] = os.path.join(tmp, "checkpoint", tag)
    raw["train"].update(total_steps=steps, eval_every=eval_every)
    raw["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    base = ExperimentConfig(raw)
    derived = [derive_runtime_fields(apply_sweep_point(base, p).raw, L, len(train_split[0]))
               for p in points]
    groups = {}
    for p, c in zip(points, derived):
        groups.setdefault(_group_signature(ExperimentConfig(c)), []).append((p, c))
    groups = list(groups.values())
    bsz = raw["train"]["batch_size"]
    conf = {"batch_size": bsz, "save_path": os.path.join(tmp, "analysis")}
    G = len(points)
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase(f"{tag}_train") as ph:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res, waves = run_sweep(base, points, train_split, test_split, L, conf, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            launches = dict(LAUNCHES)
            if [len(w["points"]) for w in waves] != [len(m) for m in groups]:
                raise AssertionError(f"{tag}: waves of {[len(w['points']) for w in waves]} "
                                     f"points, groups of {[len(m) for m in groups]}")
            # the training steps' launches: per_step of each wave's model
            # times its stacked steps, whatever the grid's size; every
            # backward launch is a step's, and the forward kernels launch in
            # the evals and eval_eig as well
            want = {}
            for wave, members in zip(waves, groups):
                for name, n in per_step(members[0][1]["model"]).items():
                    want[name] = want.get(name, 0) + n * wave["steps"]
            if not all(launches.get(name, 0) == n if "bwd" in name else
                       launches.get(name, 0) >= n for name, n in want.items()) or any(
                    n for name, n in launches.items() if name not in want):
                raise AssertionError(f"{tag}: launches {launches}, the steps' {want} and "
                                     "no other kernel")
            journal = _load_journal(_journal_path(base))
            runs = sorted(os.listdir(conf["save_path"]))
            if len(journal) != G or len(runs) != G:
                raise AssertionError(f"{tag}: journal {len(journal)} lines, {len(runs)} analyses")
            hists = [h for w in waves for h in w["histories"]]
            for (path, perf), point, cfg in zip(res, points, derived):
                ckpt = restore_checkpoint(path)["config"]
                if ckpt["train"]["lr"] != cfg["train"]["lr"]:
                    raise AssertionError(f"{tag}: checkpoint {path} for {point}")
                for key, value in point.items():
                    ok = (f"-seed-{value}-" in path if key == ("seed",) else
                          ckpt[{"dataset": "data"}.get(key[0], key[0])][key[-1]] == value)
                    if not ok:
                        raise AssertionError(f"{tag}: checkpoint {path} for {point}")
            for hist in hists:
                if not hist or not all(np.isfinite(v) for r in hist for v in r.values()):
                    raise AssertionError(f"{tag}: history {hist}")
            for run in runs:
                if sorted(os.listdir(os.path.join(conf["save_path"], run))) != want_files:
                    raise AssertionError(f"{tag}: artifacts {run}")
            ph.fields.update(points=G, groups=len(groups), steps=[w["steps"] for w in waves],
                             train_seconds=[round(w["train_seconds"], 2) for w in waves],
                             point_steps_per_s=[round(w["point_steps_per_s"], 1) for w in waves],
                             peak_memory_gib=f"{peak / 2**30:.2f}",
                             wall_seconds_with_evals_checkpoints_eval_eig=f"{wall:.2f}",
                             launches=launches, perfs=repr([round(p, 4) for _, p in res]))

        with Phase(f"{tag}_resume") as ph:
            again, again_waves = run_sweep(base, points, train_split, test_split, L, conf,
                                           device=dev)
            if again_waves or again != res or len(_load_journal(_journal_path(base))) != G:
                raise AssertionError(f"{tag}: the rerun trained points in its journal")
            ph.fields.update(skipped=G)

        with Phase(f"{tag}_point_vs_serial") as ph:
            check = copy.deepcopy(raw)
            check["model"]["dropout"] = 0.0
            check["save"] = os.path.join(tmp, "check", tag)
            check["train"].update(total_steps=SWEEP_CHECK_STEPS, eval_every=SWEEP_CHECK_STEPS)
            first = [p for p, _ in groups[0]]
            stacked, stacked_waves = run_sweep(ExperimentConfig(check), first, train_split,
                                               test_split, L, device=dev)
            one = derive_runtime_fields(apply_sweep_point(ExperimentConfig(check), first[0]).raw,
                                        L, len(train_split[0]))
            one["save"] = None
            serial = train(one, train_split, test_split, device=dev)
            hist, ser = stacked_waves[0]["histories"][0], serial.history
            # a bf16 point: batched bfloat16 products round apart from the
            # serial ones, so the metrics within BF16_SWEEP_RTOL and a share
            # of the elements within BF16_SWEEP_ATOL (a weight whose gradient
            # is bfloat16 noise takes Adam's ±lr either way)
            bf16 = one["model"].get("compute_dtype") == "bfloat16"
            rtol = BF16_SWEEP_RTOL if bf16 else SWEEP_RTOL
            over = max(abs(h[k] - s[k]) / max(rtol * abs(s[k]), SWEEP_ATOL)
                       for h, s in zip(hist, ser) for k in ("train_loss", "test_loss", "test_perf"))
            got = restore_checkpoint(stacked[0][0])["model"]
            lr = max(one["train"]["lr"], one["train"].get("ssm_lr", one["train"]["lr"]))
            bound = 2 * SWEEP_CHECK_STEPS * lr + SWEEP_PARAM_ATOL
            param_worst = anywhere = 0.0
            close = count = 0
            for n, v in serial.model.state_dict().items():
                err = (got[n] - v.cpu()).abs()
                free = gradient_free(n, one["model"], err.shape)
                param_worst = max(param_worst, err[~free].max().item() if bool((~free).any())
                                  else 0.0)
                anywhere = max(anywhere, err.max().item() / bound)
                close, count = close + int((err <= BF16_SWEEP_ATOL).sum()), count + err.numel()
            ph.fields.update(points=len(first), evals=len(hist),
                             compute_dtype="bfloat16" if bf16 else "float32",
                             metric_err_over_tol=f"{over:.3e}", param_worst=f"{param_worst:.3e}",
                             param_worst_anywhere_over_movement_bound=f"{anywhere:.3e}",
                             share_within_bf16_sweep_atol=f"{close / count:.4f}")
            params_ok = (close >= BF16_SWEEP_SHARE * count if bf16
                         else param_worst <= SWEEP_PARAM_ATOL)
            if not (len(hist) == len(ser) and over <= 1.0 and params_ok and anywhere <= 1.0):
                raise AssertionError(f"{tag}: stacked point vs serial run: {ph.fields}")
            del serial, stacked, got

        for gi, members in enumerate(groups):
            with Phase(f"{tag}_step_timing_group{gi}") as ph:
                grid = [dict(c, model=dict(c["model"], dropout=0.0)) for _, c in members]
                mc, f = grid[0]["model"], train_fields(grid[0])
                family = mc["layer"]
                sparse_k = sparse_head_k_for(mc, train_split[1], test_split[1])
                model0, _, _, params, buffers = _stacked_state(
                    [ExperimentConfig(c) for c in grid], list(range(len(grid))), dev)
                group_of, clip = optimizer_groups(model0, family, mc, grid[0]["train"], f)
                moments = {n: (torch.zeros_like(p), torch.zeros_like(p))
                           for n, p in params.items()}
                grads_fn = stacked_grads(model0, sparse_k)
                x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
                y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
                xs, ys = x.expand(len(grid), -1, -1), y.expand(len(grid), -1, -1)
                lrs = {name: torch.tensor([train_fields(c)[key] for c in grid], device=dev)
                       for name, key in (("regular", "lr"), ("ssm", "ssm_lr"))}
                n_step = [0]

                def stacked_step():
                    n_step[0] += 1
                    g, _ = grads_fn(params, buffers, xs, ys)
                    stacked_adamw_step(params, g, moments, n_step[0], lrs, group_of, f["betas"],
                                       clip)

                serial_m = build_models(mc, generator=torch.Generator().manual_seed(
                    grid[0]["seed"]), device=dev)[0]
                serial_opt, serial_clip = make_family_optimizer(serial_m, family, mc,
                                                                grid[0]["train"], f)

                def serial_step():
                    train_step(serial_m, serial_opt, x, y, {"regular": f["lr"], "ssm": f["ssm_lr"]},
                               sparse_k, clip_norm=serial_clip)

                counts = []
                for step in (stacked_step, serial_step):
                    for k in LAUNCHES:
                        LAUNCHES[k] = 0
                    step()
                    torch.cuda.synchronize()
                    counts.append({k: v for k, v in LAUNCHES.items() if v})
                if not counts[0] == counts[1] == per_step(mc):
                    raise AssertionError(f"{tag}: a stacked step launched {counts[0]}, a serial "
                                         f"step {counts[1]}, expected {per_step(mc)}")
                stacked_fields = step_profile(stacked_step, len(grid) * bsz * L, None, "",
                                              n_top=6)
                serial_fields = step_profile(serial_step, bsz * L, None, "", n_top=6)
                stacked_ms, serial_ms = (float(stacked_fields["ms_per_step"]),
                                         float(serial_fields["ms_per_step"]))
                ph.fields.update(points=len(grid), num_layers=mc["num_layers"],
                                 launches_per_stacked_step=counts[0],
                                 launches_per_serial_step=counts[1])
                ph.fields.update({f"stacked_{k}": v for k, v in stacked_fields.items()})
                ph.fields.update({f"serial_{k}": v for k, v in serial_fields.items()})
                ph.fields.update(
                    stacked_point_steps_per_s=f"{len(grid) * 1e3 / stacked_ms:.1f}",
                    serial_steps_per_s=f"{1e3 / serial_ms:.1f}",
                    stacking_gain=f"{len(grid) * serial_ms / stacked_ms:.3f}")
                del model0, params, buffers, moments, grads_fn, serial_m, serial_opt
                torch.cuda.empty_cache()
        print(f"[launches] {tag}: {launches}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def norm_attention_share(ph, att, bsz: int, L: int, n_layers: int, busy_ms, dev,
                         name: str = "norm_attention"):
    """Norm attention alone (``MHNA.attend``: the chunked linear attention
    of the features times the learned decay; or another layer's ``attend``,
    such as ``MHA``'s materialised softmax, under ``name``), forward and
    backward, at the path's (B, L, d_model) on random inputs through the
    layer ``att``'s own projections: its time and, from the step's device
    busy time ``busy_ms``, its share of the step (one a layer).  Fills
    ``ph.fields``."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(bsz, L, att.d_model, device=dev, generator=g)
    with torch.no_grad():
        qkv = att.heads(x)
    leaves = [t.detach().clone().requires_grad_() for t in qkv]
    cot = torch.randn(qkv[2].shape, device=dev, generator=g)

    def fwd_bwd():
        torch.autograd.grad((att.attend(*leaves) * cot).sum(), leaves)

    op_ms = median(cuda_ms(fwd_bwd, 11))
    op_busy = sum(t for _, t in top_device_ops(fwd_bwd, k=1000))
    ph.fields[f"{name}_fwd_bwd_ms"] = f"{op_ms:.4f}"
    ph.fields[f"{name}_fwd_bwd_device_busy_ms"] = f"{op_busy:.4f}"
    if busy_ms != "not measured" and op_busy > 0:
        ph.fields[f"{name}_share_of_device"] = f"{n_layers * op_busy / float(busy_ms):.4f}"


def greedy_vs_argmax(model, out, n_prompt: int):
    """Tokens ``out[:, n_prompt:]`` generated greedily against the argmax of
    the full forward over ``out`` at the positions before them: (mismatches,
    worst gap).  A token may differ only where the forward's top logit beats
    the generated token's by at most LOGIT_ATOL + LOGIT_RTOL·max|logit| (a
    near tie that the step path's rounding may break the other way)."""
    with torch.no_grad():
        logits = model(out)[:, n_prompt - 1: -1]
    gen = out[:, n_prompt:]
    picked = torch.gather(logits, -1, gen[..., None])[..., 0]
    gap = logits.amax(-1) - picked
    mism = int((logits.argmax(-1) != gen).sum())
    tol = LOGIT_ATOL + LOGIT_RTOL * logits.abs().max().item()
    worst = gap.max().item()
    if worst > tol:
        raise AssertionError(f"greedy tokens off the forward's argmax: gap {worst} > {tol}")
    return mism, worst


def wikitext_norm_attention_path(dev, splits, want_files):
    """Main path 16 (``WIKITEXT_NORM_ATTENTION_SHORT``: 6 layers, d_model
    and d_qk 512, 8 heads of 64, the MLP mixer of 512, softplus decay with
    its offset, elu features, conv 4, no position table, block 1024, batch
    8, vocab 50,257, the dense head; about 61M parameters), weights from
    seed 1919, on the synthetic stream.  tlie_tpu reaches no Pallas kernel
    on it (norm attention is einsums there, PyTorch products here; the
    config trains through the dense head), so no port kernel may launch:
    with every count set to 0, WTN_STEPS training steps and one perplexity
    eval, the checkpoint reloaded and eigen-analysed (η of the learned
    decay from activations, 8 blocks of 1,024, against the live model's),
    and serving (8 prompts of 1,008 tokens, prefill plus WTN_NEW greedy
    tokens, each against the full forward's argmax); the counts are read
    there.  Then one step on the card against the CPU step (WTN_STEP_BLOCKS
    blocks) and the step's time, idle share and norm attention's share of
    device time.  Returns the counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import (
        WIKITEXT_NORM_ATTENTION_SHORT, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    train_split, test_split, l_max = splits
    full = WIKITEXT_NORM_ATTENTION_SHORT
    cfg = copy.deepcopy(full)
    mc = cfg["model"]
    bsz, layers, heads = cfg["train"]["batch_size"], mc["num_layers"], mc["num_heads"]
    tmp = tempfile.mkdtemp(prefix="tlie_wt_norm_")
    cfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    cfg["train"].update(total_steps=WTN_STEPS, eval_every=WTN_STEPS)
    cfg = derive_runtime_fields(cfg, l_max, len(train_split[0]))
    if cfg["train"]["train_size"] != full["train"]["train_size"]:
        raise AssertionError("the synthetic stream is not the config's")
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("wt_norm_train") as ph:
            t0 = time.perf_counter()
            result = train(cfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"wt_norm training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(cfg["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"wt_norm parameters that did not move: {frozen}")
            n_params = sum(v.numel() for v in trained.values())
            ph.fields.update(steps=WTN_STEPS, seconds=f"{train_s:.2f}", params=n_params,
                             eval_batches=len(result.history) * (len(test_split[0]) // bsz),
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]))
            del init

        with Phase("wt_norm_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"wt_norm checkpoint entry {k} differs from the live "
                                         "weights")
            batch = test_split[0][:bsz]  # configs/analysis/wikitext.yaml's batch_size: 8
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, perc, perc_init, _, _ = eval_eig(cfg, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            live = extract_attention_family(
                result.eval_model, torch.as_tensor(batch, device=dev).long(), mc)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, l_max - 1, heads, layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"wt_norm spectra {eig.shape}, {eig_init.shape}")
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if not (np.array_equal(saved, eig) and live_rel <= 1e-6):
                raise AssertionError(f"wt_norm spectra from the checkpoint differ from the live "
                                     f"model's: {live_rel}")
            if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()
                    and np.isfinite(eig_init).all()):
                raise AssertionError("wt_norm η not finite and positive")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"wt_norm artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perplexity=f"{perf:.3f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             eta_median_init_trained=f"{np.median(eig_init):.4g},"
                                                     f"{np.median(eig):.4g}",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
            del ckpt

        with Phase("wt_norm_serving") as ph:
            n_prompt = l_max - WTN_NEW
            dec = Decoder(mc, result.eval_model)
            prompts = torch.as_tensor(test_split[0][:bsz, :n_prompt], device=dev)
            _, last = dec.prefill(prompts, l_max)
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"wt_norm prefill vs forward: {prefill_err}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, WTN_NEW)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, l_max) or not torch.equal(out[:, :n_prompt], prompts):
                raise AssertionError(f"wt_norm generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= mc["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            mism, gap = greedy_vs_argmax(result.eval_model, out, n_prompt)
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * WTN_NEW / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             greedy_vs_argmax_mismatches=mism,
                             greedy_vs_argmax_worst_gap=f"{gap:.3e}")
        launches = dict(LAUNCHES)
        print(f"[launches] wt_norm training, eval_eig and serving: {launches} (expected: none; "
              "tlie_tpu reaches no Pallas kernel on this path)", flush=True)
        if any(launches.values()):
            raise AssertionError(f"the WikiText norm-attention path launched port kernels: "
                                 f"{launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result, trained
    torch.cuda.empty_cache()

    # one step (the dense head, AdamW behind the global-norm clip) from the
    # same weights on the first WTN_STEP_TOKENS tokens of WTN_STEP_BLOCKS
    # blocks, on the card and on the CPU, both held to the same step in
    # float64 on the CPU
    f = train_fields(cfg)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:WTN_STEP_BLOCKS, :WTN_STEP_TOKENS],
                             device=dev).long()
    y_step = torch.as_tensor(train_split[1][:WTN_STEP_BLOCKS, :WTN_STEP_TOKENS],
                             device=dev).long()

    def fresh(device):
        m, _, family = build_models(mc, generator=torch.Generator().manual_seed(cfg["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mc, cfg["train"], f)
        return m, opt, clip

    with Phase("wt_norm_train_step_card_vs_cpu") as ph:
        card_m, card_opt, clip = step_card_vs_cpu(ph, "wt_norm", fresh, dev, x_step, y_step, lrs,
                                                  None, TF_GRAD_RTOL_OF_MAX)
    with Phase("wt_norm_train_step_timing") as ph:
        x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
        y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
        fields = step_profile(lambda: train_step(card_m, card_opt, x, y, lrs, None, clip_norm=clip),
                              bsz * l_max, None, "", n_warm=2, n_timed=5, n_top=6)
        ph.fields.update(fields)
        norm_attention_share(ph, card_m.layers[0].attention, bsz, l_max, layers,
                             fields["device_busy_ms"], dev)
        del card_m, card_opt, x, y
    torch.cuda.empty_cache()
    return launches


def wikitext_sweep_path(dev, splits, want_files):
    """Main path 17: ``WTS_SWEEP``, ``configs/sweep/wikitext-norm-attention-seeds-lrs.yaml``
    (two seeds × two rates of path 16's LM), through
    ``tlie_tpu_torch.parallel.run_sweep`` (``launch --sweep_parallel``), its
    four 61M-parameter points stacked in one wave: WTS_STEPS steps and one
    eval, each point checkpointed, journaled and eigen-analysed, the wave's
    point-steps/s and peak device memory; no port kernel may launch (the
    counts are set to 0 before and read after).  Then each point's first
    step in the stacked step against the same point's serial ``train_step``
    on the same batch (the config's dropout is 0): loss and every
    parameter; and the stacked step's time against a serial step's.
    Returns the counts."""
    from tlie_tpu_torch.config import (
        ExperimentConfig, apply_sweep_point, derive_runtime_fields, expand_sweep, load_sweep,
        train_fields,
    )
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import run_sweep
    from tlie_tpu_torch.parallel.sweep import (
        _journal_path, _load_journal, _stacked_state, optimizer_groups, stacked_adamw_step,
        stacked_grads,
    )
    from tlie_tpu_torch.training import restore_checkpoint, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    train_split, test_split, l_max = splits
    base, sweep = load_sweep(os.path.join(REPO, WTS_SWEEP),
                             config_root=os.path.join(REPO, "configs"))
    points = expand_sweep(sweep)
    G = len(points)
    raw = copy.deepcopy(base.raw)
    mc, bsz = raw["model"], raw["train"]["batch_size"]
    tmp = tempfile.mkdtemp(prefix="tlie_wt_sweep_")
    raw["save"] = os.path.join(tmp, "checkpoint", "wikitext-norm-attention-short")
    raw["train"].update(total_steps=WTS_STEPS, eval_every=WTS_STEPS)
    base = ExperimentConfig(raw)
    conf = {"batch_size": bsz, "save_path": os.path.join(tmp, "analysis")}
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("wt_sweep_train") as ph:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res, waves = run_sweep(base, points, train_split, test_split, l_max, conf, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            launches = dict(LAUNCHES)
            if any(launches.values()):
                raise AssertionError(f"the stacked WikiText sweep launched port kernels: "
                                     f"{launches}")
            if len(waves) != 1 or len(waves[0]["points"]) != G:
                raise AssertionError(f"the {G} points did not train in one wave: "
                                     f"{[len(w['points']) for w in waves]}")
            (wave,) = waves
            journal = _load_journal(_journal_path(base))
            runs = sorted(os.listdir(conf["save_path"]))
            if len(journal) != G or len(runs) != G:
                raise AssertionError(f"sweep journal {len(journal)} lines, {len(runs)} analyses")
            for (path, perf), point, hist in zip(res, points, wave["histories"]):
                ckpt = restore_checkpoint(path)["config"]
                if (ckpt["train"]["lr"] != point[("train", "lr")]
                        or f"-seed-{point[('seed',)]}-" not in path):
                    raise AssertionError(f"sweep checkpoint {path} for {point}")
                if not hist or not all(np.isfinite(v) for r in hist for v in r.values()):
                    raise AssertionError(f"sweep history {hist}")
            for run in runs:
                if sorted(os.listdir(os.path.join(conf["save_path"], run))) != want_files:
                    raise AssertionError(f"sweep artifacts {run}")
            ph.fields.update(points=G, steps=wave["steps"],
                             train_seconds=f"{wave['train_seconds']:.2f}",
                             point_steps_per_s=f"{wave['point_steps_per_s']:.3f}",
                             peak_memory_gib=f"{peak / 2**30:.2f}",
                             wall_seconds_with_evals_checkpoints_eval_eig=f"{wall:.2f}",
                             perplexities=repr([round(p, 4) for _, p in res]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    with Phase("wt_sweep_step_vs_serial") as ph:
        grid = [derive_runtime_fields(apply_sweep_point(base, p).raw, l_max, len(train_split[0]))
                for p in points]
        fs = [train_fields(c) for c in grid]
        model0, _, _, params, buffers = _stacked_state([ExperimentConfig(c) for c in grid],
                                                       list(range(G)), dev)
        group_of, clip = optimizer_groups(model0, "transformer", mc, raw["train"], fs[0])
        moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
        grads_fn = stacked_grads(model0, None)
        x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
        y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
        xs, ys = x.expand(G, -1, -1), y.expand(G, -1, -1)
        lrs = {"regular": torch.tensor([f["lr"] for f in fs], device=dev)}
        grads, losses = grads_fn(params, buffers, xs, ys)
        stacked_adamw_step(params, grads, moments, 1, lrs, group_of, fs[0]["betas"], clip)
        del grads
        loss_rel = p_worst = p_anywhere = 0.0
        for i, c in enumerate(grid):
            m = build_models(mc, generator=torch.Generator().manual_seed(c["seed"]),
                             device=dev)[0]
            opt, serial_clip = make_family_optimizer(m, "transformer", mc, c["train"], fs[i])
            loss = float(train_step(m, opt, x, y, {"regular": fs[i]["lr"]}, None,
                                    clip_norm=serial_clip))
            loss_rel = max(loss_rel, abs(float(losses[i]) - loss) / abs(loss))
            # Adam moves an element by about lr·g/|g|: where |g| is at least
            # 1e-2 of its leaf's max the two steps agree to SWEEP_PARAM_ATOL,
            # elsewhere within the movement bound 2·lr + SWEEP_PARAM_ATOL
            for n, p in m.named_parameters():
                err = (params[n][i] - p.detach()).abs()
                g = p.grad.abs()
                det = g >= 1e-2 * g.max()
                p_worst = max(p_worst, err[det].max().item() if bool(det.any()) else 0.0)
                p_anywhere = max(p_anywhere, err.max().item() / (2 * fs[i]["lr"]
                                                                 + SWEEP_PARAM_ATOL))
            del m, opt
        ph.fields.update(points=G, loss_worst_rel=f"{loss_rel:.3e}",
                         param_worst_where_grad_determined=f"{p_worst:.3e}",
                         param_worst_anywhere_over_movement_bound=f"{p_anywhere:.3e}")
        if not (loss_rel <= SWEEP_RTOL and p_worst <= SWEEP_PARAM_ATOL and p_anywhere <= 1.0):
            raise AssertionError(f"stacked WikiText points vs their serial steps: {ph.fields}")
        torch.cuda.empty_cache()

    with Phase("wt_sweep_step_timing") as ph:
        n_step = [1]

        def stacked_step():
            n_step[0] += 1
            g, _ = grads_fn(params, buffers, xs, ys)
            stacked_adamw_step(params, g, moments, n_step[0], lrs, group_of, fs[0]["betas"],
                               clip)

        stacked_fields = step_profile(stacked_step, G * bsz * l_max, None, "", n_warm=1,
                                      n_timed=3, n_top=6)
        ph.fields.update({f"stacked_{k}": v for k, v in stacked_fields.items()})
        del model0, params, buffers, moments, grads_fn
        torch.cuda.empty_cache()
        serial_m = build_models(mc, generator=torch.Generator().manual_seed(grid[0]["seed"]),
                                device=dev)[0]
        serial_opt, serial_clip = make_family_optimizer(serial_m, "transformer", mc,
                                                        raw["train"], fs[0])
        serial_fields = step_profile(
            lambda: train_step(serial_m, serial_opt, x, y, {"regular": fs[0]["lr"]}, None,
                               clip_norm=serial_clip), bsz * l_max, None, "", n_warm=1,
            n_timed=3, n_top=6)
        ph.fields.update({f"serial_{k}": v for k, v in serial_fields.items()})
        stacked_ms, serial_ms = (float(stacked_fields["ms_per_step"]),
                                 float(serial_fields["ms_per_step"]))
        ph.fields.update(stacked_point_steps_per_s=f"{G * 1e3 / stacked_ms:.3f}",
                         serial_steps_per_s=f"{1e3 / serial_ms:.3f}",
                         stacking_gain=f"{G * serial_ms / stacked_ms:.3f}")
        del serial_m, serial_opt
    print(f"[launches] stacked WikiText sweep: {launches} (expected: none)", flush=True)
    torch.cuda.empty_cache()
    return launches


class LlamaStandIn(torch.nn.Module):
    """A Llama-layout causal LM for ``lm_attention_spectra`` (no pretrained
    model is in the repository): token embeddings, then per layer a pre-norm
    softmax attention whose projections sit at
    ``model.layers[i].self_attn.{q,k,v,o}_proj`` and a GELU MLP, residual
    around each; returns the last hidden states.  Weights are torch's
    default distributions drawn from ``generator``."""

    def __init__(self, vocab: int, d: int, n_layers: int, heads: int, generator):
        super().__init__()
        nn = torch.nn
        self.embed = nn.Embedding(vocab, d)
        self.heads = heads
        self.model = nn.Module()
        self.model.layers = nn.ModuleList()
        for _ in range(n_layers):
            layer = nn.Module()
            layer.norm = nn.LayerNorm(d)
            layer.self_attn = nn.Module()
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                setattr(layer.self_attn, name, nn.Linear(d, d))
            layer.mlp = nn.Sequential(nn.LayerNorm(d), nn.Linear(d, 2 * d), nn.GELU(),
                                      nn.Linear(2 * d, d))
            self.model.layers.append(layer)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = 1.0 / math.sqrt(m.in_features)
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, ids):
        x = self.embed(ids)
        B, L, d = x.shape
        for layer in self.model.layers:
            a = layer.self_attn
            h = layer.norm(x)
            q, k, v = (p(h).reshape(B, L, self.heads, -1).transpose(1, 2)
                       for p in (a.q_proj, a.k_proj, a.v_proj))
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + a.o_proj(o.transpose(1, 2).reshape(B, L, d))
            x = x + layer.mlp(x)
        return x


def lm_spectra_phase(dev):
    """``lm_attention_spectra`` on the card with a Llama-layout stand-in
    (:class:`LlamaStandIn`) at the WikiText LM's widths (LMS_LAYERS layers,
    d LMS_D, LMS_HEADS heads, block LMS_BLOCK, the GPT-2 vocabulary),
    LMS_BATCHES batches of LMS_BSZ.  The cache resumes (a first call of one
    batch, a second that runs only the others, a third that runs none and
    gives the same spectra).  η (B, L−1, H, layers) from the card's own q
    and k is held to η of the same q and k on the CPU within LMS_RTOL
    relative; the whole run to the same weights' run on the CPU within
    LMS_RTOL + 6·δs relative, δs the largest difference of a score q·k
    between the two runs (log η is a difference of two log-sums of exp of
    a row's scores and its row max, each moved by at most 2·δs).  No port
    kernel may launch."""
    from tlie_tpu_torch.analysis.lm_spectra import (
        QKHooks, bin_lm_spectra, eta_from_torch_qk, lm_attention_spectra,
    )
    from tlie_tpu_torch.ops import LAUNCHES

    model = LlamaStandIn(50257, LMS_D, LMS_LAYERS, LMS_HEADS,
                         torch.Generator().manual_seed(24))
    rng = np.random.default_rng(24)
    batches = [rng.integers(0, 50257, (LMS_BSZ, LMS_BLOCK)) for _ in range(LMS_BATCHES)]
    card = copy.deepcopy(model).to(dev)
    tmp = tempfile.mkdtemp(prefix="tlie_lm_spectra_")
    before = dict(LAUNCHES)
    try:
        with Phase("lm_spectra") as ph:
            calls = []
            hook = card.register_forward_hook(lambda *a: calls.append(1))
            runs = []
            for max_batches in (1, None, None):
                n0 = len(calls)
                t0 = time.perf_counter()
                eigs = lm_attention_spectra(card, batches, LMS_HEADS, os.path.join(tmp, "card"),
                                            max_batches=max_batches)
                torch.cuda.synchronize()
                runs.append((len(calls) - n0, time.perf_counter() - t0, eigs))
            hook.remove()
            if [r[0] for r in runs] != [1, LMS_BATCHES - 1, 0]:
                raise AssertionError(f"the cache did not resume: forwards {[r[0] for r in runs]}")
            eigs = runs[1][2]
            if not np.array_equal(runs[2][2], eigs):
                raise AssertionError("the resumed spectra differ from the computed ones")
            t0 = time.perf_counter()
            cpu = lm_attention_spectra(model, batches, LMS_HEADS, os.path.join(tmp, "cpu"))
            cpu_s = time.perf_counter() - t0
            model_rel = float(np.max(np.abs(eigs - cpu) / np.abs(cpu)))
            # each batch's q and k from both runs: η of the card's on the CPU,
            # and the largest score difference
            extract_rel = d_score = 0.0
            causal = torch.ones(LMS_BLOCK, LMS_BLOCK, dtype=torch.bool).tril()[None, :, :, None]
            hooks = (QKHooks(card), QKHooks(model))
            try:
                for batch in batches:
                    with torch.no_grad():
                        card(torch.as_tensor(batch, device=dev))
                        model(torch.as_tensor(batch))
                    for (qc, kc), (q, k) in zip(hooks[0].pop_qk(LMS_HEADS),
                                                hooks[1].pop_qk(LMS_HEADS)):
                        on_card = eta_from_torch_qk(qc, kc)
                        on_cpu = eta_from_torch_qk(qc.cpu(), kc.cpu())
                        extract_rel = max(extract_rel, float(np.max(np.abs(on_card - on_cpu)
                                                                    / np.abs(on_cpu))))
                        diff = (torch.einsum("bthd,bshd->btsh", qc.cpu(), kc.cpu())
                                - torch.einsum("bthd,bshd->btsh", q, k)).abs()
                        d_score = max(d_score, torch.where(causal, diff, 0.0).max().item())
            finally:
                for h in hooks:
                    h.remove()
            model_tol = LMS_RTOL + 6 * d_score
            stats = bin_lm_spectra(eigs)
            ph.fields.update(shape=eigs.shape, extract_card_vs_cpu_max_rel=f"{extract_rel:.3e}",
                             run_card_vs_cpu_max_rel=f"{model_rel:.3e}",
                             score_card_vs_cpu_max_abs=f"{d_score:.3e}",
                             run_tol=f"{model_tol:.3e}", tol=LMS_RTOL,
                             card_seconds=f"{runs[1][1]:.3f}", cpu_seconds=f"{cpu_s:.2f}",
                             eta_range=f"[{eigs.min():.4g}, {eigs.max():.4g}]",
                             pct_mean_layer0_head0=np.round(
                                 stats["percentage_mean"][:, 0, 0], 2).tolist())
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
            want_shape = (LMS_BATCHES * LMS_BSZ, LMS_BLOCK - 1, LMS_HEADS, LMS_LAYERS)
            if (eigs.shape != want_shape or not np.isfinite(eigs).all()
                    or extract_rel > LMS_RTOL or model_rel > model_tol):
                raise AssertionError(f"lm_spectra on the card: {ph.fields}")
            if launched:
                raise AssertionError(f"lm_attention_spectra launched port kernels: {launched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, card
    torch.cuda.empty_cache()


def mamba1_scan_phase(dev, model, inputs, flush):
    """The scan kernels where Mamba-1 runs them: the trained model's own
    decay a (time-varying, (B, L, d_inner·N), real) and input bx, captured
    from its first block's call of ``diag_linear_scan`` on ``inputs``, forward
    and reversed, and the backward against the plain versions; then their
    L2-cold and warm medians of 21 against the bytes bound.  Returns
    ({name: time_scan_kernel's tuple}, worst errors, a's range)."""
    import tlie_tpu_torch.models.mamba2 as m2
    from tlie_tpu_torch.ops.scan import (
        diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda, diag_scan_plain,
    )

    seen, real = [], m2.diag_linear_scan
    m2.diag_linear_scan = lambda a, b, **kw: (seen.append((a, b)), real(a, b, **kw))[1]
    try:
        with torch.no_grad():
            model(inputs)
    finally:
        m2.diag_linear_scan = real
    a, b = (t.contiguous() for t in seen[0])
    gen = torch.Generator(device=dev).manual_seed(18)
    times, errs = {}, {}
    with Phase("mamba1_scan_kernels_vs_plain") as ph, torch.no_grad():
        for rev in (False, True):
            mode = "rev" if rev else "fwd"
            h = diag_scan_cuda(a, b, reverse=rev)
            ref = diag_scan_plain(a, b, reverse=rev)
            torch.cuda.synchronize()
            err, scale = scan_err(h, ref)
            g = torch.randn(b.shape, device=dev, generator=gen)
            da, d = diag_scan_bwd_cuda(a, ref, g, reverse=rev)
            da_ref, d_ref = diag_scan_bwd_plain(a, ref, g, reverse=rev)
            d_e, d_tol, da_e, da_ratio = bwd_err(a, ref, da, d, da_ref, d_ref, rev)
            ph.fields[mode] = (f"h_rel={err / scale:.2e},d_abs={d_e:.2e}/tol={d_tol:.2e},"
                               f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                               f"da_shape={tuple(da.shape)}")
            if not (err <= SCAN_RTOL_OF_MAX * scale and d_e <= d_tol and da_ratio <= 1.0
                    and da.shape == a.shape):
                raise AssertionError(f"scan kernels at Mamba-1's trained a, {mode}: "
                                     f"{ph.fields[mode]}")
            errs[mode] = (err, max(d_e, da_e))
        a_range = (a.min().item(), a.max().item())
        ph.fields.update(shape=tuple(b.shape), a_range=f"[{a_range[0]:.4g}, {a_range[1]:.4g}]")
    with Phase("mamba1_scan_kernel_timing") as ph, torch.no_grad():
        h = diag_scan_cuda(a, b)
        g = torch.randn(b.shape, device=dev, generator=gen)
        da, d = diag_scan_bwd_cuda(a, h, g)
        # each input read once (a, b; a, h, g), each output written once (h;
        # d, da at a's full shape); one multiply-add a step, two backward
        fwd_bytes = sum(distinct_bytes(t) for t in (a, b, h))
        for rev in (False, True):
            name = "diag_scan" + ("_rev" if rev else "")
            times[name] = time_scan_kernel(lambda: diag_scan_cuda(a, b, reverse=rev),
                                           lambda: diag_scan_plain(a, b, reverse=rev),
                                           fwd_bytes, 2 * b.numel(), flush)
            ph.fields[name] = scan_timing_fields(times[name], fwd_bytes)
        bwd_bytes = sum(distinct_bytes(t) for t in (a, h, g, da, d))
        times["diag_scan_bwd"] = time_scan_kernel(lambda: diag_scan_bwd_cuda(a, h, g),
                                                  lambda: diag_scan_bwd_plain(a, h, g),
                                                  bwd_bytes, 4 * g.numel(), flush)
        ph.fields["diag_scan_bwd"] = scan_timing_fields(times["diag_scan_bwd"], bwd_bytes)
    return times, errs, a_range


def mamba1_path(dev, want_files, flush):
    """Main path 18 (``MQAR_MAMBA1_SMALL``: 2 layers, d_model 64, d_state
    16, d_inner 128, dt_rank 4, conv 4, GLU, prenorm, L 64, 8 pairs, vocab
    256, batch 32, dropout 0.1), weights from seed 1919, on its own natively
    drawn split (20,000 train and 512 test examples).  Its scan runs on the
    (B, L, d_inner·N) = (32, 64, 2048) view with a decay that varies in
    time: the scan's forward kernel once a layer a forward, its backward
    once a layer a step.  With every count set to 0: the forward on a test
    batch (card against CPU), M1_STEPS training steps at dropout 0.1 with
    an eval every M1_EVAL_EVERY, the checkpoint reloaded and eigen-analysed
    (λ over the (d_inner, N) lattice from activations, against the live
    model's) and served (:func:`mamba1_serving`: the prefill of M1_PROMPT
    tokens of the test batch, one scan launch a layer); the counts are read
    there (2 + 2 a training step).  Then one card step against the CPU
    step at dropout 0, the step's time, idle share and the scan kernels'
    share, the kernels at the trained model's own a
    (:func:`mamba1_scan_phase`) and the forward kernel at the prefill's
    (32, M1_PROMPT, 2048).  Returns (launches, kernel times, errors)."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import MQAR_MAMBA1_SMALL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import MQAR, masked_accuracy
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    full = MQAR_MAMBA1_SMALL
    mc = full["model"]
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    lattice = mc["expansion"] * mc["hidden_dim"] * mc["state_dim"]
    with Phase("mamba1_data") as ph:
        data = MQAR(**full["dataset"])
        train_split, (test_x, test_y) = data.split("train"), data.split("test")
        if data.generator != "native":
            raise AssertionError(f"MQAR drew with {data.generator}, not the native generator")
        ph.fields.update(generator=data.generator, train_examples=len(train_split[0]),
                         test_examples=len(test_x))
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                               device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("mamba1_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != n_layers:
            raise AssertionError(f"the Mamba-1 forward launched diag_scan "
                                 f"{LAUNCHES['diag_scan']} times, expected {n_layers}")
        if logits.shape != (bsz, L, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"Mamba-1 forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        _, cpu_model, _ = build_models(mc, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:4].cpu())
        cpu_err = (logits[:4].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:4].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"Mamba-1 card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         scan_view=(bsz, L, lattice), vs_cpu_max_abs=f"{cpu_err:.3e}")
        del cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix="tlie_mamba1_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    tcfg["train"].update(total_steps=M1_STEPS, eval_every=M1_EVAL_EVERY)
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    try:
        with Phase("mamba1_train") as ph:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            result = train(tcfg, train_split, (test_x, test_y), device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            n_eval_batches = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(diag_scan=n_layers * (M1_STEPS + n_eval_batches),
                        diag_scan_bwd=n_layers * M1_STEPS)
            if trained_launches != want:
                raise AssertionError(f"Mamba-1 training launches {trained_launches}, expected "
                                     f"{want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite Mamba-1 training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"Mamba-1 parameters that did not move: {frozen}")
            ph.fields.update(steps=M1_STEPS, seconds=f"{train_s:.2f}",
                             steps_per_s=f"{M1_STEPS / train_s:.1f}", eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(trained_launches))

        with Phase("mamba1_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"Mamba-1 checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(tmp, "analysis")
            batch = test_x[:M1_ANALYSIS_BATCH]
            eig, eig_init, perc, perc_init, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            live = extract_attention_family(result.eval_model,
                                            torch.as_tensor(batch, device=dev).long(), mc)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (M1_ANALYSIS_BATCH, L, lattice, n_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"Mamba-1 spectra {eig.shape}, {eig_init.shape}")
            if not (np.array_equal(saved, eig) and np.abs(eig - live).max() <= 1e-6):
                raise AssertionError("Mamba-1 spectra from the checkpoint differ from the live "
                                     "model's")
            if not (np.all((eig_init > 0) & (eig_init < 1)) and np.all((eig >= 0) & (eig < 1))):
                raise AssertionError("Mamba-1 eigenvalues outside [0, 1)")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{mc['hidden_dim']}"):
                raise AssertionError(f"Mamba-1 artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_abs=f"{np.abs(eig - live).max():.3e}",
                             lambda_range_init=f"[{eig_init.min():.4g}, {eig_init.max():.4g}]",
                             lambda_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
        m1_dec = mamba1_serving(dev, mc, result.eval_model, inputs[:, :M1_PROMPT])
        launches = dict(LAUNCHES)
        print(f"[launches] Mamba-1 forward, training, eval_eig and serving: {launches}; training "
              f"alone: {trained_launches} ({n_layers} + {n_layers} a step)", flush=True)
        others = {k: v for k, v in launches.items() if not k.startswith("diag_scan") and v}
        if launches["diag_scan_bwd"] != want["diag_scan_bwd"] or others:
            raise AssertionError(f"the Mamba-1 path's launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (the sparse head, AdamW behind the global-norm clip) from the
    # same weights and batch at dropout 0, on the card and on the CPU, both
    # held to the same step in float64 on the CPU
    step_cfg = dict(mc, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg,
                                    generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase("mamba1_train_step_card_vs_cpu") as ph:
        # dt_proj and A_log: the leaves the backward kernel's da feeds
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, "Mamba-1", fresh, dev, x_step, y_step, lrs, sparse_k, MAMBA_GRAD_RTOL_OF_MAX,
            watch=("dt_proj_a_log_grad_err_over_allowed",
                   lambda n: n.endswith(("dt_proj.weight", "dt_proj.bias", "A_log"))))
    with Phase("mamba1_train_step_timing") as ph:
        ph.fields.update(step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, "diag_scan", "scan_kernels", n_top=6))
        del card_m, card_opt
    times, errs, a_range = mamba1_scan_phase(dev, result.eval_model, inputs, flush)
    # the scan's forward kernel at the serving prefill's own (B, L, d_inner·N)
    with Phase("mamba1_scan_kernel_prefill_timing") as ph, torch.no_grad():
        scan_fwd_at_prefill(ph, m1_dec, inputs[:, :M1_PROMPT], flush, "diag_scan_prefill")
    del result, m1_dec
    torch.cuda.empty_cache()
    return launches, (times, errs, a_range)


def steepest_decay_operands(model, inputs):
    """The decay attention's operands (C, B, cs, xdt) as ``model``'s
    forward on ``inputs`` hands them to the kernels, at the layer whose cs
    falls furthest within a chunk (the steepest decay), and that fall."""
    import tlie_tpu_torch.ops.ssd as ssd_mod

    seen = []
    real = ssd_mod.decay_attention

    def grab(*args):
        seen.append(args)
        return real(*args)

    ssd_mod.decay_attention = grab
    try:
        with torch.no_grad():
            model(inputs)
    finally:
        ssd_mod.decay_attention = real
    falls = [float(ops[2].min()) for ops in seen]
    i = int(np.argmin(falls))
    return seen[i], falls[i]


def cifar_splits(full, tag: str):
    """The config's CIFAR-10 splits from the loader's synthetic images
    (2,048 / 512; the CIFAR-10 files are not in the repository), the train
    split cut to its first CIFAR_TRAIN images: float pixels (N, 1024, 1),
    or with ``tokenize`` the grey levels as int64 tokens (N, 1024)."""
    from tlie_tpu_torch.data import CIFAR10

    mc, L = full["model"], full["model"]["seq_len"]
    with Phase(f"{tag}_data") as ph:
        data = CIFAR10(**dict(full["dataset"], synthetic=True))
        train_split = tuple(a[:CIFAR_TRAIN] for a in data.split("train"))
        test_split = data.split("test")
        ph.fields.update(train=train_split[0].shape, test=test_split[0].shape,
                         dtype=str(train_split[0].dtype), d_input=data.d_input)
        tokens = full["dataset"].get("tokenize", False)
        row = (L,) if tokens else (L, mc["input_dim"])
        n_train = min(CIFAR_TRAIN, full["train"]["train_size"])
        if (train_split[0].shape != (n_train,) + row
                or test_split[0].shape != (data.synthetic_test,) + row
                or train_split[0].dtype != (np.int64 if tokens else np.float32)
                or train_split[1].dtype != np.int64
                or (tokens and int(train_split[0].max()) >= mc["vocab_size"])):
            raise AssertionError(f"{tag} data: {ph.fields}")
    return train_split, test_split


def cifar_path(dev, want_files, full, tag: str, flush=None):
    """Main paths 19-23 on the CIFAR-10 splits of ``full`` (:func:`cifar_splits`)
    through :func:`classifier_path`, CIFAR_EPOCHS[tag] epochs, an analysis
    batch of CIFAR_ANALYSIS_BATCH images and a card-vs-CPU step on
    CIFAR_STEP_EXAMPLES of them.  Returns the path's launch counts."""
    return classifier_path(dev, want_files, full, tag, cifar_splits(full, tag),
                           CIFAR_EPOCHS[tag], CIFAR_ANALYSIS_BATCH, CIFAR_STEP_EXAMPLES, flush)


def lra_mamba2_splits(full, tag: str):
    """The padded splits of path 24 (``LISTOPS_MAMBA2_FULL``: ListOps
    generated natively with the config's lengths, the train split cut to
    LISTOPS_TRAIN examples and the test split to LISTOPS_TEST, as path 14
    cuts it) or path 25 (``IMDB_MAMBA2_FULL``: the loader's synthetic
    corpus at char level, since the IMDB files are not in the repository,
    cut to IMDB_TRAIN and IMDB_TEST reviews (2,048 and 512)): (tokens,
    labels, lengths) each."""
    from tlie_tpu_torch.data import IMDB, ListOps

    mc, L = full["model"], full["model"]["seq_len"]
    with Phase(f"{tag}_data") as ph:
        listops = full["dataset"]["_name_"] == "listops"
        if listops:
            data = ListOps(**dict(full["dataset"], num_train=LISTOPS_TRAIN,
                                  num_test=LISTOPS_TEST))
            want_train = LISTOPS_TRAIN
        else:
            data = IMDB(**dict(full["dataset"], synthetic=True, synthetic_train=IMDB_TRAIN,
                               synthetic_test=IMDB_TEST))
            want_train = IMDB_TRAIN
        train_split, test_split = data.split("train"), data.split("test")
        # tlie_tpu generates ListOps with the native generator wherever c++
        # builds it
        source = data.source if listops else "synthetic"
        lengths = np.concatenate([train_split[2], test_split[2]])
        ph.fields.update(source=source, vocab_size=data.vocab_size,
                         train=train_split[0].shape, test=test_split[0].shape,
                         l_max=data.l_max, lengths=f"[{lengths.min()}, {lengths.max()}]")
        if (train_split[0].shape != (want_train, L) or data.l_max != L
                or data.vocab_size > mc["vocab_size"] or lengths.max() > L
                or (listops and source != "native")):
            raise AssertionError(f"{tag} data: {ph.fields}")
    return train_split, test_split


def classifier_path(dev, want_files, full, tag: str, splits, epochs: int,
                    analysis_batch: int, step_examples: int, flush=None, out=None):
    """A pooled classifier's main path on ``splits`` ((inputs, labels) or,
    padded, (tokens, labels, lengths) for the train and the test split),
    weights from the config's seed 1919, ``epochs`` epochs with CIFAR_WARMUP
    of warmup (each path names its cuts).  The families:

    - the Mamba-2 (paths 19, 24, 25, and the dual one of 27) and its
      pseudo-LTI variant (20): the decay attention's float32 kernels, the
      forward once a layer a forward and each backward once a layer a step
      (n + n + n a step);
    - S4 (21, 26): no port kernel;
    - S5 (28): the scan's forward kernel once a layer a forward and its
      backward once a layer a step (n + n a step); after the step's time,
      both held to their plain versions and to float64 and timed at the
      trained layer 0's Λ̄ and inputs (:func:`scan_s5_phase`), their times
      and errors put in ``out["scan"]``;
    - the transformer classifier (22: softmax attention, materialised since
      its head dims differ; 23: norm attention with the SiLU gate; 27: AAN's
      linear attention with the dual MATCH head): no port kernel, the flash
      kernels among them.

    A dual model's inputs are pairs (B, 2, L): its logits are (B, classes),
    its spectra have 2B document rows, and a step runs 2B documents.

    With every count set to 0: the forward on a test batch (card against
    CPU; for the Mamba-2 also the same weights at chunk 256, the
    inter-chunk arm, against the card's own chunk), training through
    ``train`` with an eval at each epoch's end, the checkpoint reloaded and
    eigen-analysed on the first ``analysis_batch`` test examples (tokens
    alone for a padded split, as ``launch`` hands them; the pseudo-LTI
    spectra held to exp(−softplus(A)) of the checkpoint, constant over the
    batch and time); the counts are read there.  Then (not counted) the
    three kernels held to their plain versions at the trained Mamba-2's
    steepest layer, one card step against the CPU step on
    ``step_examples`` examples (the Mamba-2 at chunk CIFAR_STEP_CHUNK on
    both sides), and the step's time, idle share and the decay attention's
    (S4: the generating function's; the transformers: one attention's)
    share of device time.  Returns the counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import argmax_accuracy
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import decay_attention as dattn
    from tlie_tpu_torch.ops.ssd import _auto_chunk
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    mc = full["model"]
    is_mamba, lti = mc["layer"] == "mamba", mc.get("pseudoLTI", False)
    is_tf, is_s5 = mc["layer"] == "transformer", mc["layer"] == "s5"
    docs = 2 if mc.get("dual", False) else 1  # documents an example
    # the kernel the forward launches once a layer, and the backward's
    fwd_kernel, bwd_kernels = (("decay_attention_fwd", ("decay_attention_bwd_i",
                                                        "decay_attention_bwd_j")) if is_mamba
                               else ("diag_scan", ("diag_scan_bwd",)) if is_s5 else (None, ()))
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    heads = mc.get("num_heads", 1)
    seed = full["seed"]
    train_split, test_split = splits
    padded = len(test_split) == 3
    test_x, test_y = test_split[0], test_split[1]

    _, model, _ = build_models(mc, padded, generator=torch.Generator().manual_seed(seed),
                               device=dev)
    aux = {"lengths": test_split[2][:bsz]} if padded else {}
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz], aux), L, mc["input_dim"],
                                device=dev)
    if padded != isinstance(inputs, tuple):
        raise AssertionError(f"{tag}: prep_batch gave {type(inputs)} for a padded={padded} split")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        want_fwd = {fwd_kernel: n_layers} if fwd_kernel else {}
        if {k: v for k, v in LAUNCHES.items() if v} != want_fwd:
            raise AssertionError(f"{tag} forward launches {LAUNCHES}")
        if logits.shape != (bsz, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        acc = float(argmax_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        _, cpu_model, _ = build_models(mc, padded, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(tuple(t[:2].cpu() for t in inputs) if padded else inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(accuracy=f"{acc:.4f}", forward_ms=f"{fwd_ms:.3f}",
                         vs_cpu_max_abs=f"{cpu_err:.3e}")
        if padded:  # the lengths are dropped: the tokens alone give the same logits
            same = torch.equal(model(inputs[0]), logits)
            ph.fields["lengths_change_nothing"] = same
            if not same:
                raise AssertionError(f"{tag}: the lengths changed the logits")
        if is_mamba:
            ph.fields.update(chunk=_auto_chunk(bsz, L, heads, dev),
                             chunk_cpu_2_examples=_auto_chunk(2, L, heads, "cpu"),
                             chunk_cpu_full_batch=_auto_chunk(bsz, L, heads, "cpu"))
        del cpu_model, ref

    if is_mamba:
        # the inter-chunk arm on the card: the same weights at chunks of 256
        # against the card's own chunk
        with Phase(f"{tag}_chunk256_vs_auto") as ph, torch.no_grad():
            _, m256, _ = build_models(dict(mc, chunk_size=256), padded,
                                      generator=torch.Generator(), device=dev)
            m256.load_state_dict(model.state_dict())
            before = LAUNCHES["decay_attention_fwd"]
            l256, f256 = m256(inputs), m256.features(inputs)
            f_auto = model.features(inputs)
            torch.cuda.synchronize()
            l_err = (l256 - logits).abs().max().item()
            f_err = (f256 - f_auto).abs().max().item()
            auto = _auto_chunk(bsz, L, heads, dev)
            ph.fields.update(chunks=f"{L // 256}x256_vs_{L // auto}x{auto}",
                             logits_max_abs=f"{l_err:.3e}", features_max_abs=f"{f_err:.3e}",
                             features_max=f"{f_auto.abs().max().item():.3f}",
                             launches=LAUNCHES["decay_attention_fwd"] - before)
            if not (torch.allclose(l256, logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
                    and torch.allclose(f256, f_auto, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)):
                raise AssertionError(f"{tag} chunk 256 vs the auto chunk: {ph.fields}")
            del m256, l256, f256, f_auto

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    if full["dataset"]["_name_"] in ("cifar", "imdb", "sc"):  # the loader's synthetic split
        tcfg["dataset"]["synthetic"] = True
    tcfg["train"].update(num_epochs=epochs, warmup=CIFAR_WARMUP)
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    f = train_fields(tcfg)
    try:
        with Phase(f"{tag}_train") as ph:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            result = train(tcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            steps = f["total_steps"]
            n_eval_batches = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            if fwd_kernel:  # n + n (+ n) a step, the forward also per eval batch
                want[fwd_kernel] = n_layers * (steps + n_eval_batches)
                want.update(dict.fromkeys(bwd_kernels, n_layers * steps))
            if trained_launches != want:
                raise AssertionError(f"{tag} training launches {trained_launches}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            if len(result.history) != epochs:
                raise AssertionError(f"{tag}: {len(result.history)} evals")
            trained = result.model.state_dict()
            init = build_models(mc, padded, generator=torch.Generator().manual_seed(seed),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"{tag} parameters that did not move: {frozen}")
            ph.fields.update(steps=steps, steps_per_epoch=f["eval_every"], warmup=f["warmup"],
                             seconds=f"{train_s:.2f}", steps_per_s=f"{steps / train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in trained_launches.items() if v}))
            del init

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            if not (is_mamba or is_tf):
                ssm_checkpoint_eval_eig(ph, tag, dev, result, trained, tcfg, tmp, want_files)
            else:
                ckpt_path, perf = result
                ckpt = restore_checkpoint(ckpt_path)
                for k, v in trained.items():
                    if not torch.equal(ckpt["model"][k], v.cpu()):
                        raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                             "weights")
                # the analysis config's batch_size of test examples, tokens
                # alone for a padded split
                batch = test_x[:analysis_batch]
                eig_dir = os.path.join(tmp, "analysis")
                eig, eig_init, perc, perc_init, _, _ = eval_eig(
                    tcfg, {"save_path": eig_dir}, perf, ckpt_path, device=dev, batch=batch)
                live = extract_attention_family(result.eval_model,
                                                torch.as_tensor(batch, device=dev), mc)
                (run_dir,) = os.listdir(eig_dir)
                files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
                saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
                want_shape = (docs * analysis_batch, L - 1 if is_tf else L, heads, n_layers)
                if eig.shape != want_shape or eig_init.shape != want_shape:
                    raise AssertionError(f"{tag} spectra {eig.shape}, {eig_init.shape}")
                live_err = (float(np.max(np.abs(eig - live) / np.abs(live))) if is_tf
                            else float(np.abs(eig - live).max()))
                if not (np.array_equal(saved, eig) and live_err <= 1e-6):
                    raise AssertionError(f"{tag} spectra from the checkpoint differ from the "
                                         f"live model's: {live_err}")
                if is_tf:
                    if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()
                            and np.isfinite(eig_init).all()):
                        raise AssertionError(f"{tag} η not finite and positive")
                # λ = exp(dt·A): in (0, 1] at init; a trained dt can take
                # dt·A below float32's exp range, where λ is 0 (IMDB's)
                elif not (np.all((eig_init > 0) & (eig_init <= 1))
                          and np.all((eig >= 0) & (eig <= 1))):
                    raise AssertionError(f"{tag} eigenvalues outside (0, 1] at init or "
                                         "[0, 1] trained")
                if not is_tf:
                    ph.fields["lambda_zero_share_trained"] = f"{float(np.mean(eig == 0)):.3e}"
                prefix = f"{full['dataset']['name']}dmodel{mc['hidden_dim']}"
                if files != want_files or not run_dir.startswith(prefix):
                    raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
                if lti:
                    # exp(−softplus(A)) of the checkpoint's A, constant over
                    # the batch and time, within the spectra's 1e-5
                    lam = np.stack([torch.exp(-torch.nn.functional.softplus(
                        ckpt["model"][f"blocks.{i}.mamba.A"].double())).numpy()
                        for i in range(n_layers)], -1)  # (heads, layers)
                    flat = eig.reshape(-1, heads, n_layers)
                    lti_err = float(np.abs(flat - lam[None]).max() / lam.max())
                    constant = bool((flat == flat[:1]).all())
                    ph.fields.update(lti_vs_exp_neg_softplus_a_rel=f"{lti_err:.3e}",
                                     lti_constant_over_batch_and_time=constant,
                                     lambda_trained=np.round(lam, 5).tolist())
                    if not (constant and lti_err <= 1e-5):
                        raise AssertionError(f"{tag} pseudo-LTI spectra: {ph.fields}")
                name = "eta" if is_tf else "lambda"
                ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                                 artifacts=run_dir, n_files=len(files),
                                 eig_vs_live=f"{live_err:.3e}",
                                 **{f"{name}_range_init": f"[{eig_init.min():.4g}, "
                                                          f"{eig_init.max():.4g}]",
                                    f"{name}_range_trained": f"[{eig.min():.4g}, "
                                                             f"{eig.max():.4g}]"},
                                 radius_pct_mean_layer0=np.round(
                                     perc[:, :, 0, 0].mean(1), 2).tolist())
                del ckpt
        launches = dict(LAUNCHES)
        nonzero = {k: v for k, v in launches.items() if v}
        print(f"[launches] {tag} forward, training and eval_eig: {nonzero}; training alone: "
              f"{({k: v for k, v in trained_launches.items() if v})}"
              + (f" ({' + '.join([str(n_layers)] * (1 + len(bwd_kernels)))} a step)"
                 if fwd_kernel else " (expected: none; the flash kernels 0)" if is_tf
                 else " (expected: none)"), flush=True)
        if fwd_kernel:
            others = set(nonzero) - {fwd_kernel, *bwd_kernels}
            if any(launches[k] != want[k] for k in bwd_kernels) or others:
                raise AssertionError(f"the {tag} path's launches {launches}")
        elif nonzero:
            raise AssertionError(f"the {tag} path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if is_mamba:
        # the three kernels against their plain versions on the operands the
        # trained model hands them at its steepest layer (cs falls furthest)
        with Phase(f"{tag}_decay_attention_at_trained_weights") as ph:
            (C, B, cs, xdt), fall = steepest_decay_operands(result.eval_model, inputs)
            dy = torch.randn(xdt.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
            fields, _ = check_decay_attention(dattn, C, B, cs, xdt, dy, f64=False)
            ph.fields.update(shape=tuple(xdt.shape), cs_min=f"{fall:.2f}", **fields)
            del C, B, cs, xdt, dy

    # one step from the same weights at dropout 0 on step_examples examples,
    # on the card and on the CPU, both held to the same step in float64; the
    # Mamba-2 at CIFAR_STEP_CHUNK on both sides
    step_cfg = dict(mc, dropout=0.0)
    if is_mamba:
        step_cfg["chunk_size"] = CIFAR_STEP_CHUNK
    lrs = {"regular": f["lr"], "ssm": f["ssm_lr"]}

    def on_card(split, n):
        x = torch.as_tensor(split[0][:n], device=dev)
        if padded:
            x = (x, torch.as_tensor(split[2][:n], device=dev).float())
        return x, torch.as_tensor(split[1][:n], device=dev)

    x_step, y_step = on_card(train_split, step_examples)

    def fresh(device):
        m, _, family = build_models(step_cfg, padded,
                                    generator=torch.Generator().manual_seed(seed), device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        watch = (("dt_bias_a_grad_err_over_allowed",
                  lambda k: k.endswith(("dt_bias", "mamba.A", "A_log"))) if is_mamba else None)
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, tag, fresh, dev, x_step, y_step, lrs, None,
            MAMBA_GRAD_RTOL_OF_MAX if is_mamba else TF_GRAD_RTOL_OF_MAX, watch=watch,
            check_stats=not (is_mamba or is_tf))
        ph.fields.update(examples=step_examples, chunk=step_cfg.get("chunk_size", "none"))

    with Phase(f"{tag}_train_step_timing") as ph:
        if is_mamba:  # the timed step at the card's own chunk, as training runs it
            card_m = build_models(mc, padded, generator=torch.Generator().manual_seed(seed),
                                  device=dev)[0]
            card_opt, clip = make_family_optimizer(card_m, "mamba", mc, tcfg["train"], f)
        x_full, y_full = on_card(train_split, bsz)
        fields = step_profile(
            lambda: train_step(card_m, card_opt, x_full, y_full, lrs, None, clip_norm=clip),
            docs * bsz * L, "decay_attention" if is_mamba else "diag_scan" if is_s5 else None,
            "decay_attention" if is_mamba else "scan_kernels", n_warm=2, n_timed=10, n_top=8)
        ph.fields.update(fields)
        if is_tf:
            att = card_m.layers[0].attention
            name = ("norm_attention" if hasattr(att, "Wvqkn") else "linear_attention"
                    if att.lin_att else "softmax_attention")
            norm_attention_share(ph, att, docs * bsz, L, n_layers, fields["device_busy_ms"], dev,
                                 name=name)
        elif not (is_mamba or is_s5):
            s4_kernel_share(ph, card_m.encoder.layers[0].seq, n_layers, fields["device_busy_ms"])
        del card_m, card_opt
    if is_s5:  # the scan kernels at the trained layer 0's Λ̄ and inputs
        trained_m = result.eval_model
        with torch.no_grad():
            u = trained_m.encoder.encoder(inputs)
        scan = scan_s5_phase(dev, trained_m.encoder.layers[0].seq, u, flush, tag, f64=True)
        if out is not None:
            out["scan"] = scan
        del trained_m, u
    del result, model
    torch.cuda.empty_cache()
    return launches


def synthetic_splits(full, tag: str, n_train: int, n_test: int):
    """The splits of path 26 (PathFinder: float pixels (n, 1024, 1)), 27
    (AAN: token pairs (n, 2, 4000)) or 28 (Speech Commands: MFCC frames (n,
    161, 20)) from the loader of the dataset ``full`` names, on its
    synthetic split of ``n_train`` and ``n_test`` examples (the LRA and
    Speech Commands files are not in the repository), built once and
    timed: (inputs, labels) each, and the loader."""
    from tlie_tpu_torch.data import DATASETS

    mc, L = full["model"], full["model"]["seq_len"]
    with Phase(f"{tag}_data") as ph:
        t0 = time.perf_counter()
        data = DATASETS[full["dataset"]["_name_"]](**dict(
            full["dataset"], synthetic=True, synthetic_train=n_train, synthetic_test=n_test))
        train_split, test_split = data.split("train"), data.split("test")
        build_s = time.perf_counter() - t0
        pairs = mc.get("dual", False)
        row = (2, L) if pairs else (L, mc["input_dim"])
        ph.fields.update(train=train_split[0].shape, test=test_split[0].shape,
                         dtype=str(train_split[0].dtype), l_max=data.l_max,
                         classes=data.d_output, build_s=f"{build_s:.2f}")
        if pairs:
            ph.fields["vocab_size"] = data.vocab_size
        if (train_split[0].shape != (n_train,) + row or test_split[0].shape != (n_test,) + row
                or train_split[0].dtype != (np.int64 if pairs else np.float32)
                or data.l_max != L or data.d_output != mc["output_dim"]
                or set(np.unique(train_split[1])) != set(range(mc["output_dim"]))
                or (pairs and data.vocab_size > mc["vocab_size"])):
            raise AssertionError(f"{tag} data: {ph.fields}")
    return (train_split, test_split), data


def aan_mamba2_dual(vocab_size: int):
    """A dual Mamba-2 classifier for AAN's pairs at LISTOPS_MAMBA2_FULL's
    widths and training settings (6 layers, d_model 128, 4 heads of 32, N
    64, pre-norm, GLU, a mean pool, the MATCH head of 2 → 1 → 2), batch 8
    pairs, on documents cut to AAN_MAMBA_L tokens, weights from
    AAN_MAMBA_SEED; the repository has no such config: the card's check of
    the Mamba-2's dual head."""
    from tlie_tpu_torch.config import AAN_TRANSFORMER_FULL, LISTOPS_MAMBA2_FULL

    full = copy.deepcopy(LISTOPS_MAMBA2_FULL)
    full["seed"] = AAN_MAMBA_SEED
    full["save"] = "./checkpoint/aan-mamba2-dual"
    full["dataset"] = dict(AAN_TRANSFORMER_FULL["dataset"], l_max=AAN_MAMBA_L)
    full["train"].update(batch_size=AAN_TRANSFORMER_FULL["train"]["batch_size"], padded=False,
                         train_size=AAN_MAMBA_TRAIN)
    full["model"].update(dual=True, output_dim=2, vocab_size=vocab_size,
                         max_pos_embed=AAN_MAMBA_L, seq_len=AAN_MAMBA_L)
    return full


def aan_path(dev, want_files, flush=None):
    """Main path 27: the AAN transformer (``AAN_TRANSFORMER_FULL``: 4 layers,
    d_model 128, 4 heads, linear attention, the GLU mixer, a position table
    of 4,000, the classifier MLP of 128 and the dual MATCH head; batch 8
    pairs, 16 documents of 4,000 tokens) on AAN_TRAIN / AAN_TEST synthetic
    pairs through :func:`classifier_path` (no port kernel, no flash
    kernel), then the dual Mamba-2 (:func:`aan_mamba2_dual`) on the same
    pairs cut as its docstring says, 20 steps through the decay attention's
    float32 kernels, n + n + n launches a step counted exactly.  Returns
    {tag: launch counts}."""
    from tlie_tpu_torch.config import AAN_TRANSFORMER_FULL

    splits, data = synthetic_splits(AAN_TRANSFORMER_FULL, "aan_transformer", AAN_TRAIN,
                                    AAN_TEST)
    out = {"aan_transformer": classifier_path(
        dev, want_files, AAN_TRANSFORMER_FULL, "aan_transformer", splits, LRA_EPOCHS,
        AAN_ANALYSIS_BATCH, CIFAR_STEP_EXAMPLES, flush)}
    (tr_x, tr_y), (te_x, te_y) = splits
    cut = ((np.ascontiguousarray(tr_x[:AAN_MAMBA_TRAIN, :, :AAN_MAMBA_L]), tr_y[:AAN_MAMBA_TRAIN]),
           (np.ascontiguousarray(te_x[:, :, :AAN_MAMBA_L]), te_y))
    full = aan_mamba2_dual(AAN_TRANSFORMER_FULL["model"]["vocab_size"])
    with Phase("aan_mamba2_dual_match_units") as ph:
        # the share of test pairs on which each ReLU of the MATCH head is live
        # at init, at the config's seed and at the path's
        x = torch.as_tensor(cut[1][0][:AAN_ANALYSIS_BATCH], device=dev)
        for seed in (1919, AAN_MAMBA_SEED):
            live = match_live_share(dict(full["model"]), seed, x, dev)
            ph.fields[f"seed_{seed}"] = repr(live)
        if min(live.values()) <= 0:
            raise AssertionError(f"a MATCH unit is dead at seed {AAN_MAMBA_SEED}: {ph.fields}")
    out["aan_mamba2_dual"] = classifier_path(
        dev, want_files, full, "aan_mamba2_dual", cut, LRA_EPOCHS, AAN_ANALYSIS_BATCH,
        CIFAR_STEP_EXAMPLES, flush)
    return out


def match_live_share(model_cfg, seed: int, x, dev):
    """{"encoder": …, "middle": …}: the share of the pairs ``x`` on which
    the MATCH head's encoder units (any of them) and its middle unit(s) are
    live (ReLU input > 0), for the model of ``model_cfg`` drawn from
    ``seed``, in eval mode."""
    from tlie_tpu_torch.models import build_models

    _, model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(seed),
                               device=dev)
    seen = {}
    hooks = [getattr(model.match, name).register_forward_hook(
        lambda mod, inp, out, name=name: seen.__setitem__(name, out)) for name in
        ("encoder", "middle")]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return {name: round(float((out > 0).any(-1).float().mean()), 4) for name, out in seen.items()}


def step_card_vs_cpu_bf16(ph, what: str, fresh, dev, x_step, y_step, lrs, kernel_leaves,
                          sparse_k=None, fused: bool = False):
    """One bf16 training step (``fused``: through the fused head) from the
    same weights and batch on the card (its kernels) and on the CPU (their
    plain versions).  A float64 model is no reference for a bf16 one; the
    same weights and step in float32 on the CPU are: each bf16 gradient's
    error on the card against the CPU's may be BF16_GRAD_FACTOR times the
    CPU's own distance from the float32 gradient (a sum of many bfloat16
    terms that cancel, as a bias's over 32k positions, keeps little of its
    value in either), or BF16_GRAD_RTOL_OF_MAX of the leaf's max|g|, and
    at most BF16_GRAD_CAP_OF_MAX of it; a leaf whose BF16_GRAD_FACTOR CPU
    distances reach that cap is listed (``grad_capped_leaves``) and fails
    where its name holds one of ``kernel_leaves`` (the leaves whose
    gradients the path's kernels write, or feed at first hand); the
    loss within BF16_LOSS_RTOL; where the float32 gradient exceeds
    (BF16_GRAD_FACTOR + 1) times that distance (so both bf16 gradients have
    its sign), the float32 weights within BF16_GRAD_FACTOR times the CPU's
    own distance from the float32 step there, or BF16_PARAM_ATOL; within
    the movement bound 2·lr everywhere; the BatchNorm statistics within
    BF16_STATS_ATOL.  ``fresh(device, float32=False)`` gives (model,
    optimizer, clip norm), the model in float32 with ``float32``.  Fills
    ``ph.fields``, raises on a failed check, and returns the launches of
    the card's step."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import train_step

    card_m, card_opt, clip = fresh(dev)
    cpu_m, cpu_opt, _ = fresh("cpu")
    before = dict(LAUNCHES)
    card_loss = float(train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k,
                                 fused_head=fused, clip_norm=clip))
    torch.cuda.synchronize()
    card_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    t0 = time.perf_counter()
    x_cpu, y_cpu = x_step.cpu(), y_step.cpu()
    cpu_loss = float(train_step(cpu_m, cpu_opt, x_cpu, y_cpu, lrs, sparse_k, fused_head=fused,
                                clip_norm=clip))
    # the same weights and step in float32
    ref_m, ref_opt, _ = fresh("cpu", float32=True)
    ref_loss = float(train_step(ref_m, ref_opt, x_cpu, y_cpu, lrs, sparse_k, fused_head=fused,
                                clip_norm=clip))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    g_ratio, g_leaf, p_ratio, p_leaf, p_anywhere, n_det, n_all = 0.0, "", 0.0, "", 0.0, 0, 0
    not_f32, capped = [], {}
    for (n, p), q, r in zip(card_m.named_parameters(), cpu_m.parameters(), ref_m.parameters()):
        if p.dtype != torch.float32 or p.grad.dtype != torch.float32:
            not_f32.append(n)
        g_card, g_cpu, g32 = p.grad.cpu(), q.grad, r.grad
        e_cpu = (g_cpu - g32).abs().max().item()  # the CPU's bf16 error in this leaf
        g_max = g_cpu.abs().max().item()
        if BF16_GRAD_FACTOR * e_cpu >= BF16_GRAD_CAP_OF_MAX * g_max:
            capped[n] = round(e_cpu / max(g_max, 1e-30), 3)  # the CPU's distance over max|g|
        allowed = min(max(BF16_GRAD_FACTOR * e_cpu, BF16_GRAD_RTOL_OF_MAX * g_max),
                      BF16_GRAD_CAP_OF_MAX * g_max)
        ratio = (g_card - g_cpu).abs().max().item() / (allowed + 1e-30)
        if ratio > g_ratio:
            g_ratio, g_leaf = ratio, n
        err = (p.detach().cpu() - q.detach()).abs()
        p_anywhere = max(p_anywhere, err.max().item())
        # where the float32 gradient fixes the sign of both bf16 ones, the
        # card's weight as near the CPU's as the CPU's is to the float32 step
        # (Adam's eps weighs gradients near 1e-8 apart), or BF16_PARAM_ATOL
        det = g32.abs() > (BF16_GRAD_FACTOR + 1) * e_cpu
        n_det, n_all = n_det + int(det.sum()), n_all + det.numel()
        if not bool(det.any()):
            continue
        e_step = (q.detach() - r.detach()).abs()[det].max().item()
        ratio = err[det].max().item() / max(BF16_PARAM_ATOL, BF16_GRAD_FACTOR * e_step)
        if ratio > p_ratio:
            p_ratio, p_leaf = ratio, n
    s_worst = max([((b.cpu() - c).abs() / c.abs().clamp_min(1.0)).max().item()
                   for b, c in zip(card_m.buffers(), cpu_m.buffers())], default=0.0)
    ph.fields.update(loss_card=f"{card_loss:.6f}", loss_cpu=f"{cpu_loss:.6f}",
                     loss_f32_cpu=f"{ref_loss:.6f}", loss_rel=f"{loss_rel:.2e}",
                     grad_err_over_allowed=f"{g_ratio:.3f}({g_leaf})",
                     grad_capped_leaves=f"{len(capped)}{capped}",
                     param_err_over_allowed_where_grad_determined=f"{p_ratio:.3f}({p_leaf})",
                     determined_share=f"{n_det / n_all:.3f}",
                     param_worst_anywhere=f"{p_anywhere:.3e}",
                     batch_stats_worst_rel=f"{s_worst:.3e}", cpu_steps_s=f"{cpu_s:.1f}",
                     card_step_launches=repr(card_launches))
    if not (loss_rel <= BF16_LOSS_RTOL and g_ratio <= 1.0 and p_ratio <= 1.0
            and p_anywhere <= 2 * max(lrs.values()) + BF16_PARAM_ATOL
            and s_worst <= BF16_STATS_ATOL and not not_f32
            and not [n for n in capped if any(k in n for k in kernel_leaves)]):
        raise AssertionError(f"{what} bf16 card vs CPU step (leaves not float32: "
                             f"{not_f32}): {ph.fields}")
    return card_launches


def bf16_logprobs_vs_float32(ph, model16, model32, inputs):
    """A bf16 model's log-probs on ``inputs`` against the float32 model's on
    the same weights: within 2u of the largest |log-prob| each, their mean
    within BF16_LOGPROB_MEAN; the bf16 model's logits bfloat16."""
    with torch.no_grad():
        logits = model16(inputs)
        lp16 = torch.log_softmax(logits.float(), -1)
        lp32 = torch.log_softmax(model32(inputs).float(), -1)
    err = (lp16 - lp32).abs()
    top = lp32.abs().max().item()
    ph.fields.update(logits_dtype=str(logits.dtype), logprob_max_abs_diff=f"{err.max().item():.3e}",
                     logprob_mean_abs_diff=f"{err.mean().item():.3e}", max_abs_logprob=f"{top:.3f}",
                     logprob_tol=f"{2 * BF16_U * top:.3e}")
    if not (logits.dtype == torch.bfloat16 and err.max().item() <= 2 * BF16_U * top
            and err.mean().item() <= BF16_LOGPROB_MEAN):
        raise AssertionError(f"bf16 log-probs against float32: {ph.fields}")
    return logits


def float32_copy(model_cfg, state, dev):
    """The float32 eval model of ``model_cfg`` (its ``compute_dtype``
    dropped) carrying ``state``: the model ``tlie_tpu`` serves and
    eigen-analyses for a bf16 checkpoint."""
    from tlie_tpu_torch.models import build_models

    cfg = {k: v for k, v in model_cfg.items() if k != "compute_dtype"}
    _, model, _ = build_models(cfg, generator=torch.Generator(), device=dev)
    model.load_state_dict(state)
    return model


def wikitext_lru_bf16_path(dev, splits, want_files, f32_step):
    """Main path 32, the WikiText-103 LRU LM (``WIKITEXT_LRU_SHORT``: 6
    layers, d_model and N 512, block 1024, batch 8, the GPT-2 vocabulary of
    50,257, post-norm BatchNorm) with ``compute_dtype: bfloat16`` and
    ``fused_xent: true`` set in a temporary copy of its YAML, weights from
    seed 1919, on path 8's synthetic stream (``splits``).  With every count
    set to 0 it goes through ``python -m tlie_tpu_torch.tools.run_truncated``
    (:func:`run`): LM_STEPS training steps through the fused head's three
    bfloat16 kernels (once each a step, no float32 head kernel) and the
    scan's two kernels (each once a layer a step, the forward also once a
    layer an eval batch), one perplexity eval, the checkpoint, and eval_eig
    of the trained weights (the float32 extraction, no launch), then
    serving from the checkpoint in float32 (8 prompts of WT_BF16_PROMPT
    tokens through the scan's forward once a layer, 16 greedy tokens, the
    step path held to the float32 forward); the counts are read there.
    Then one card step against the CPU step on LM_STEP_BLOCKS blocks
    through the fused head (the bf16 tolerances), one step traced by
    ``profile_trace`` with ``annotate`` regions into a temporary directory,
    and the step's time, device time, idle share and head share beside path
    3's float32 figures (``f32_step``).  Returns the path's launch counts
    and its step fields."""
    import yaml

    from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
    from tlie_tpu_torch.config import derive_runtime_fields, load_yaml, train_fields
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import fused_xent as fx
    from tlie_tpu_torch.tools import run_truncated
    from tlie_tpu_torch.training import restore_checkpoint, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer
    from tlie_tpu_torch.utils import annotate, profile_trace

    train_split, test_split, l_max = splits
    tmp = tempfile.mkdtemp(prefix="tlie_wt_lru_bf16_")
    raw = load_yaml(os.path.join(REPO, "configs", "wikitext-lru-short.yaml"))
    raw["model"]["compute_dtype"] = "bfloat16"
    raw["train"]["fused_xent"] = True
    raw["save"] = os.path.join(tmp, "checkpoint", "wikitext-lru-short-bf16")
    yaml_path = os.path.join(tmp, "wikitext-lru-short-bf16.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = derive_runtime_fields(load_yaml(yaml_path), l_max, len(train_split[0]))
    m = cfg["model"]
    layers, bsz, L = m["num_layers"], cfg["train"]["batch_size"], m["seq_len"]
    head = [fx.launch_name(k, torch.bfloat16) for k in ("fwd", "dh", "dw")]
    f = train_fields(cfg)
    lrs = {"regular": f["lr"], "ssm": f["ssm_lr"]}
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("wt_lru_bf16_run_truncated") as ph:
            eig_dir = os.path.join(tmp, "analysis")
            t0 = time.perf_counter()
            result, arrays = run_truncated.run(load_yaml(yaml_path), steps=LM_STEPS,
                                               analysis_batch=bsz, save_path=eig_dir, device=dev,
                                               data=(l_max, train_split, test_split))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            n_eval = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(diag_scan=layers * (LM_STEPS + n_eval), diag_scan_bwd=layers * LM_STEPS)
            want.update(dict.fromkeys(head, LM_STEPS))
            if launches != want:
                raise AssertionError(f"bf16 LRU LM launches {launches}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"bf16 LRU LM training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(m, generator=torch.Generator().manual_seed(cfg["seed"]),
                                device=dev)[0].state_dict()
            bad = [k for k, v in trained.items() if v.dtype != torch.float32
                   or (v.is_floating_point() and torch.equal(v, init[k]))]
            if bad:
                raise AssertionError(f"bf16 LRU LM parameters not float32 or not moved: {bad}")
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"bf16 LRU LM checkpoint entry {k} differs")
            live = extract_ssm_family(ssm_layer_params({k: v.cpu() for k, v in trained.items()}),
                                      m)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            # eval_eig took the live (card) weights: the float32 extraction
            # there against the same on the CPU, within float32's rounding
            eig = arrays[0]
            eig_rel = float(np.abs(eig - live).max() / np.abs(live).max())
            if eig.shape != (m["state_dim"], layers) or eig.dtype != live.dtype or eig_rel > 1e-6:
                raise AssertionError(f"bf16 LRU LM spectra differ from the float32 extraction "
                                     f"of the trained weights: {eig_rel}")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"bf16 LRU LM artifacts {run_dir}: {files}")
            ph.fields.update(steps=LM_STEPS, seconds_with_eval_eig=f"{run_s:.2f}",
                             eval_batches=n_eval, perplexity=f"{perf:.3f}",
                             eig_vs_cpu_extraction_max_rel=f"{eig_rel:.3e}",
                             checkpoint=os.path.basename(ckpt_path),
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in launches.items() if v}))
            del init

        with Phase("wt_lru_bf16_serving") as ph:
            n_new = 16
            dec = Decoder.from_checkpoint(ckpt_path, device=dev)
            f32_model = float32_copy(m, ckpt["model"], dev)
            prompts = torch.as_tensor(test_split[0][:8, :WT_BF16_PROMPT], device=dev)
            before = LAUNCHES["diag_scan"]
            _, last = dec.prefill(prompts)
            torch.cuda.synchronize()
            if LAUNCHES["diag_scan"] - before != layers:
                raise AssertionError("the bf16 LRU LM's prefill did not go through diag_scan "
                                     "once a layer")
            with torch.no_grad():
                full_prompt = f32_model(prompts)[:, -1]
                own = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if last.dtype != torch.float32 or not torch.allclose(last, full_prompt,
                                                                 rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"bf16 LRU LM prefill vs the float32 forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if (out.shape != (8, WT_BF16_PROMPT + n_new)
                    or not torch.equal(out[:, :WT_BF16_PROMPT], prompts)
                    or int(out.min()) < 0 or int(out.max()) >= m["output_dim"]):
                raise AssertionError(f"bf16 LRU LM generation {tuple(out.shape)}")
            # the O(1) step path against the float32 forward, 64 positions of 2 rows
            sw = dec.stepwise_logits(out[:2, :64])
            with torch.no_grad():
                full = f32_model(out[:2, :64])
            step_err = (sw - full).abs().max().item()
            if not torch.allclose(sw, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"bf16 LRU LM stepwise vs the float32 forward: {step_err}")
            own_err = (own.float() - full_prompt).abs().max().item()
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{8 * n_new / gen_s:.1f}",
                             prefill_vs_f32_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_f32_forward_max_abs=f"{step_err:.3e}",
                             bf16_forward_vs_f32_max_abs=f"{own_err:.3e}")
            del dec, f32_model, ckpt
        path_all = dict(LAUNCHES)  # training, eval_eig and serving

        with Phase("wt_lru_bf16_train_step_card_vs_cpu") as ph:
            x = torch.as_tensor(train_split[0][:LM_STEP_BLOCKS], device=dev)
            y = torch.as_tensor(train_split[1][:LM_STEP_BLOCKS], device=dev)

            def fresh(device, float32=False):
                mc = {k: v for k, v in m.items() if k != "compute_dtype"} if float32 else m
                model, _, family = build_models(
                    mc, generator=torch.Generator().manual_seed(cfg["seed"]), device=device)
                opt, clip = make_family_optimizer(model, family, mc, cfg["train"], f)
                return model, opt, clip

            step_launches = step_card_vs_cpu_bf16(ph, "bf16 LRU LM", fresh, dev, x, y, lrs,
                                                  ("decoder.", ".seq."), fused=True)
            want = dict.fromkeys(head, 1)
            want.update(diag_scan=layers, diag_scan_bwd=layers)
            if step_launches != want:
                raise AssertionError(f"the bf16 LRU LM's card step launched {step_launches}")

        with Phase("wt_lru_bf16_train_step_timing") as ph:
            x = torch.as_tensor(train_split[0][:bsz], device=dev)
            y = torch.as_tensor(train_split[1][:bsz], device=dev)
            opt, clip = make_family_optimizer(result.model, "lru", m, cfg["train"], f)

            def one_step():
                train_step(result.model, opt, x, y, lrs, fused_head=True, clip_norm=clip)

            one_step()
            trace_dir = os.path.join(tmp, "profile")
            with profile_trace(trace_dir):
                with annotate("wt_lru_bf16_train_step"):
                    one_step()
                with annotate("wt_lru_bf16_eval_forward"), torch.no_grad():
                    result.eval_model(x)
                torch.cuda.synchronize()
            traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
            if len(traces) != 1:
                raise AssertionError(f"profile_trace wrote {traces}")
            with open(os.path.join(trace_dir, traces[0])) as fh:
                names = {e.get("name") for e in json.load(fh).get("traceEvents", [])}
            regions = {"wt_lru_bf16_train_step", "wt_lru_bf16_eval_forward"}
            if not regions <= names:
                raise AssertionError(f"the trace lacks the annotated regions {regions - names}")
            step = step_profile(one_step, bsz * L, "xent", "fused_head", n_warm=2, n_timed=5)
            ph.fields.update(step)
            ph.fields.update(trace_file=traces[0], trace_events=len(names))
            ph.fields.update({f"f32_path3_{k}": f32_step.get(k, "not measured")
                              for k in ("ms_per_step", "device_busy_ms", "idle_share",
                                        "fused_head_share_of_device")})
            del opt, x, y

        print(f"[launches] path 32, bf16 LRU LM: {path_all}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result
    torch.cuda.empty_cache()
    return path_all, step


def sm_attention_bf16_path(dev, test_x, test_y, train_split, want_files):
    """Main path 33, the MQAR softmax transformer (``MQAR_SM_ATTENTION_FULL``:
    2 layers, d_model 128, one head of 128, vocab 8192, position table 512,
    L 512, batch 64) with ``compute_dtype: bfloat16``, weights from seed
    1919.  A bf16 transformer upcasts q, k and v to float32 before the
    softmax attention, as ``tlie_tpu`` does, so with ``use_flash`` it runs
    the float32 flash kernels (rows 8a-8c).  With every count set to 0: the
    forward on the test batch (its log-probs against the float32 model's on
    the same weights, the bf16 tolerance), TF_STEPS training steps through
    the sparse head with 2 evals (the flash forward once a layer a step and
    eval batch, each backward once a layer a step, no other kernel, and no
    call of the materialised softmax), the checkpoint eigen-analysed (the
    float32 extraction: the flash forward twice a layer) and served in
    float32 (64 prompts of TF_PROMPT tokens, prefill through the flash
    forward once a layer, 16 greedy tokens, the step path against the
    float32 forward).  Then one card step against the CPU step at the bf16
    tolerances.  Returns the path's launch counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import MQAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    sm = copy.deepcopy(MQAR_SM_ATTENTION_FULL)
    sm["model"]["compute_dtype"] = "bfloat16"
    smm = sm["model"]
    n_layers, bsz, L = smm["num_layers"], sm["train"]["batch_size"], smm["seq_len"]
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    inputs, _ = prep_batch((test_x[:bsz], test_y[:bsz]), L, smm["input_dim"], lang_model=True,
                           device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("sm_bf16_forward") as ph:
        _, model, _ = build_models(smm, generator=torch.Generator().manual_seed(sm["seed"]),
                                   device=dev)
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("bf16 transformer parameters not float32")
        bf16_logprobs_vs_float32(ph, model, float32_copy(smm, model.state_dict(), dev), inputs)
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention_fwd"] != 2 * n_layers:  # the bf16 and float32 forwards
            raise AssertionError(f"the forwards launched flash_attention_fwd "
                                 f"{LAUNCHES['flash_attention_fwd']} times")
        del model

    tcfg = copy.deepcopy(sm)
    tmp = tempfile.mkdtemp(prefix="tlie_sm_bf16_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-sm-attention-bf16")
    tcfg["train"].update(total_steps=TF_STEPS, eval_every=TF_EVAL_EVERY)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    test_split = (test_x, test_y)
    materialised = []
    real_xla = fa.xla_causal_attention
    try:
        with Phase("sm_bf16_train") as ph:
            fwd_before = LAUNCHES["flash_attention_fwd"]
            fa.xla_causal_attention = lambda *a: (materialised.append(1), real_xla(*a))[1]
            try:
                t0 = time.perf_counter()
                result = train(tcfg, train_split, test_split, device=dev)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            finally:
                fa.xla_causal_attention = real_xla
            launches = dict(LAUNCHES)
            n_eval = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(flash_attention_fwd=fwd_before + n_layers * (TF_STEPS + n_eval),
                        flash_attention_bwd_dkv=n_layers * TF_STEPS,
                        flash_attention_bwd_dq=n_layers * TF_STEPS)
            if launches != want or materialised:
                raise AssertionError(f"bf16 transformer training launches {launches}, expected "
                                     f"{want}; materialised softmax calls {len(materialised)}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite bf16 transformer numbers {rec}")
            if any(p.dtype != torch.float32 for p in result.model.parameters()):
                raise AssertionError("bf16 transformer parameters not float32 after training")
            ph.fields.update(steps=TF_STEPS, seconds=f"{train_s:.2f}", eval_batches=n_eval,
                             materialised_softmax_calls=len(materialised),
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in launches.items() if v}))

        with Phase("sm_bf16_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            eig_dir = os.path.join(tmp, "analysis")
            before = LAUNCHES["flash_attention_fwd"]
            eig, eig_init, _, _, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf, ckpt_path,
                                                 device=dev, batch=test_x[:bsz])
            if LAUNCHES["flash_attention_fwd"] - before != 2 * n_layers:
                raise AssertionError("eval_eig's two float32 forwards did not go through the "
                                     "flash kernel")
            f32_model = float32_copy(smm, ckpt["model"], dev)
            f32_cfg = {k: v for k, v in smm.items() if k != "compute_dtype"}
            live = extract_attention_family(f32_model, inputs, f32_cfg)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if (eig.shape != (bsz, L - 1, smm["num_heads"], n_layers) or eig.dtype != np.float32
                    or live_rel > 1e-6 or not np.isfinite(eig).all()):
                raise AssertionError(f"bf16 transformer spectra {eig.shape} {eig.dtype}, "
                                     f"{live_rel} from the float32 extraction")
            if files != want_files:
                raise AssertionError(f"bf16 transformer artifacts {run_dir}: {files}")
            ph.fields.update(perf=f"{perf:.4f}", artifacts=run_dir,
                             eig_vs_f32_extraction_max_rel=f"{live_rel:.3e}")

        with Phase("sm_bf16_serving") as ph:
            n_new = 16
            dec = Decoder.from_checkpoint(ckpt_path, device=dev)
            prompts = inputs[:, :TF_PROMPT]
            before = LAUNCHES["flash_attention_fwd"]
            _, last = dec.prefill(prompts, TF_PROMPT + n_new)
            torch.cuda.synchronize()
            if LAUNCHES["flash_attention_fwd"] - before != n_layers:
                raise AssertionError("the bf16 transformer's prefill did not go through "
                                     "flash_attention_fwd once a layer")
            with torch.no_grad():
                full_prompt = f32_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if last.dtype != torch.float32 or not torch.allclose(last, full_prompt,
                                                                 rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"bf16 transformer prefill vs float32 forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if (out.shape != (bsz, TF_PROMPT + n_new) or int(out.min()) < 0
                    or int(out.max()) >= smm["output_dim"]):
                raise AssertionError(f"bf16 transformer generation {tuple(out.shape)}")
            sw = dec.stepwise_logits(out[:8])
            with torch.no_grad():
                full = f32_model(out[:8])
            step_err = (sw - full).abs().max().item()
            if not torch.allclose(sw, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"bf16 transformer stepwise vs float32 forward: {step_err}")
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_f32_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_f32_forward_max_abs=f"{step_err:.3e}")
            del dec, f32_model, ckpt
        path_all = dict(LAUNCHES)
        if any(path_all[k] for k in LAUNCHES if k not in kernels):
            raise AssertionError(f"path 33 launched other kernels: {path_all}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result

    step_cfg = dict(smm, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(smm, train_split[1], test_y)
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device, float32=False):
        mc = dict(step_cfg, compute_dtype="float32") if float32 else step_cfg
        m, _, family = build_models(mc, generator=torch.Generator().manual_seed(sm["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mc, tcfg["train"], f)
        return m, opt, clip

    with Phase("sm_bf16_train_step_card_vs_cpu") as ph:
        step_launches = step_card_vs_cpu_bf16(ph, "bf16 transformer", fresh, dev, x_step,
                                              y_step, {"regular": f["lr"]}, (".attention.",),
                                              sparse_k)
        if step_launches != dict.fromkeys(kernels, n_layers):
            raise AssertionError(f"the bf16 transformer's card step launched {step_launches}")
    print(f"[launches] path 33, bf16 softmax transformer: {path_all}", flush=True)
    torch.cuda.empty_cache()
    return path_all


def bf16_wave_path(dev, test_x, test_y, train_split, want_files):
    """Main path 34: a stacked wave of four bf16 points, the seeds
    (SWEEP_SEEDS) of ``MQAR_LIN_ATTENTION_FULL`` (BASELINE.json's primary
    config) with ``compute_dtype: bfloat16`` at dropout 0, through
    :func:`kernel_sweep_path` (P34_STEPS stacked steps with an eval every
    P34_EVAL_EVERY, checkpoints, journal, eval_eig, the resume, one point
    against its serial run at the bf16 tolerances, a stacked step against a
    serial one, point-steps/s against serial steps/s and the wave's peak
    memory; no port kernel, as in ``tlie_tpu``).  Then one serial bf16 step
    of the MQAR S5 (``MQAR_S5_FULL``: a pre-norm stack, whose residual
    stream stays bfloat16) against its CPU step, its scan's two kernels
    once a layer each.  Returns the launch counts of both."""
    from tlie_tpu_torch.config import (
        MQAR_LIN_ATTENTION_FULL, MQAR_S5_FULL, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    base = copy.deepcopy(MQAR_LIN_ATTENTION_FULL)
    base["model"].update(compute_dtype="bfloat16", dropout=0.0)
    launches = kernel_sweep_path(dev, "lin_bf16_wave", base,
                                 [{("seed",): s} for s in SWEEP_SEEDS], train_split,
                                 (test_x, test_y), want_files, P34_STEPS, P34_EVAL_EVERY,
                                 lambda mc: {})

    s5 = copy.deepcopy(MQAR_S5_FULL)
    s5["model"].update(compute_dtype="bfloat16", dropout=0.0)
    s5 = derive_runtime_fields(s5, train_split[0].shape[1], len(train_split[0]))
    s5m = s5["model"]
    n_layers, bsz = s5m["num_layers"], s5["train"]["batch_size"]
    f = train_fields(s5)
    sparse_k = sparse_head_k_for(s5m, train_split[1], test_y)
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device, float32=False):
        mc = dict(s5m, compute_dtype="float32") if float32 else s5m
        m, _, family = build_models(mc, generator=torch.Generator().manual_seed(s5["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mc, s5["train"], f)
        return m, opt, clip

    with Phase("s5_bf16_train_step_card_vs_cpu") as ph:
        s5_launches = step_card_vs_cpu_bf16(ph, "bf16 S5", fresh, dev, x_step, y_step,
                                            {"regular": f["lr"], "ssm": f["ssm_lr"]}, (".seq.",),
                                            sparse_k)
        if s5_launches != {"diag_scan": n_layers, "diag_scan_bwd": n_layers}:
            raise AssertionError(f"the bf16 S5 step launched {s5_launches}")
    total = dict(launches)
    for k, v in s5_launches.items():
        total[k] = total.get(k, 0) + v
    print(f"[launches] path 34, bf16 stacked wave and the bf16 S5 step: {total}", flush=True)
    return total


def bf16_mamba1_path(dev, want_files):
    """Main path 35: path 18's MQAR Mamba-1 (``MQAR_MAMBA1_SMALL``: 2 layers,
    d_model 64, d_state 16, d_inner 128, L 64, vocab 256, batch 32, dropout
    0.1) with ``compute_dtype: bfloat16``, weights from seed 1919, on its own
    natively drawn split.  Its recurrence stays float32, so it runs the
    scan's float32 kernels on the (B, L, d_inner·N) view.  With every count
    set to 0: the log-probs on the test batch against the float32 model's on
    the same weights (the bf16 tolerance; the scan's forward once a layer a
    forward), P35_STEPS training steps with an eval every P35_EVAL_EVERY (2
    + 2 launches a step, the forward also once a layer an eval batch), the
    checkpoint (float32 weights) eigen-analysed (the float32 extraction of
    the stored weights, held to the float32 copy's live extraction) and
    served in float32 (M1_PROMPT tokens of the test batch, the prefill
    through the scan's forward once a layer and held to the float32
    forward, MAMBA_NEW greedy tokens against its argmax).  Then one bf16
    card step against the CPU step (``step_card_vs_cpu_bf16``), 2 + 2
    launches.  Returns the path's launch counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import MQAR_MAMBA1_SMALL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    full = copy.deepcopy(MQAR_MAMBA1_SMALL)
    full["model"]["compute_dtype"] = "bfloat16"
    mc = full["model"]
    f32_cfg = {k: v for k, v in mc.items() if k != "compute_dtype"}
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    lattice = mc["expansion"] * mc["hidden_dim"] * mc["state_dim"]
    with Phase("m1_bf16_data") as ph:
        data = MQAR(**full["dataset"])
        train_split, (test_x, test_y) = data.split("train"), data.split("test")
        ph.fields.update(generator=data.generator, train_examples=len(train_split[0]))
    inputs, _ = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"], lang_model=True,
                           device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("m1_bf16_forward") as ph:
        _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                   device=dev)
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("bf16 Mamba-1 parameters not float32")
        bf16_logprobs_vs_float32(ph, model, float32_copy(mc, model.state_dict(), dev), inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != 2 * n_layers:  # the bf16 and the float32 forward
            raise AssertionError(f"the forwards launched diag_scan {LAUNCHES['diag_scan']} times")
        del model

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix="tlie_m1_bf16_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-mamba1-bf16")
    tcfg["train"].update(total_steps=P35_STEPS, eval_every=P35_EVAL_EVERY)
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    try:
        with Phase("m1_bf16_train") as ph:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            result = train(tcfg, train_split, (test_x, test_y), device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            n_eval = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(diag_scan=n_layers * (P35_STEPS + n_eval),
                        diag_scan_bwd=n_layers * P35_STEPS)
            if trained_launches != want:
                raise AssertionError(f"bf16 Mamba-1 training launches {trained_launches}, "
                                     f"expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite bf16 Mamba-1 numbers {rec}")
            if any(p.dtype != torch.float32 for p in result.model.parameters()):
                raise AssertionError("bf16 Mamba-1 parameters not float32 after training")
            ph.fields.update(steps=P35_STEPS, seconds=f"{train_s:.2f}",
                             steps_per_s=f"{P35_STEPS / train_s:.1f}", eval_batches=n_eval,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in trained_launches.items() if v}))

        with Phase("m1_bf16_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            if ckpt["config"]["model"].get("compute_dtype") != "bfloat16":
                raise AssertionError("the bf16 Mamba-1 checkpoint lost its compute dtype")
            eig_dir = os.path.join(tmp, "analysis")
            batch = test_x[:M1_ANALYSIS_BATCH]
            eig, eig_init, _, _, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf, ckpt_path,
                                                 device=dev, batch=batch)
            f32_model = float32_copy(mc, ckpt["model"], dev)
            live = extract_attention_family(f32_model, torch.as_tensor(batch, device=dev).long(),
                                            f32_cfg)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            want_shape = (M1_ANALYSIS_BATCH, L, lattice, n_layers)
            live_err = float(np.abs(eig - live).max())
            if (eig.shape != want_shape or eig_init.shape != want_shape or live_err > 1e-6
                    or not (np.all((eig >= 0) & (eig < 1)))):
                raise AssertionError(f"bf16 Mamba-1 spectra {eig.shape}, {live_err} from the "
                                     "float32 extraction")
            if files != want_files:
                raise AssertionError(f"bf16 Mamba-1 artifacts {run_dir}: {files}")
            ph.fields.update(perf=f"{perf:.4f}", artifacts=run_dir,
                             eig_vs_f32_extraction_max_abs=f"{live_err:.3e}",
                             lambda_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]")

        with Phase("m1_bf16_serving") as ph:
            dec = Decoder.from_checkpoint(ckpt_path, device=dev)
            prompts = inputs[:, :M1_PROMPT]
            before = LAUNCHES["diag_scan"]
            _, last = dec.prefill(prompts, M1_PROMPT + MAMBA_NEW)
            torch.cuda.synchronize()
            if LAUNCHES["diag_scan"] - before != n_layers:
                raise AssertionError("the bf16 Mamba-1's prefill did not go through diag_scan "
                                     "once a layer")
            with torch.no_grad():
                full_prompt = f32_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if last.dtype != torch.float32 or not torch.allclose(last, full_prompt,
                                                                 rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"bf16 Mamba-1 prefill vs float32 forward: {prefill_err}")
            out = dec.generate(prompts, MAMBA_NEW)
            if out.shape != (bsz, M1_PROMPT + MAMBA_NEW):
                raise AssertionError(f"bf16 Mamba-1 generation {tuple(out.shape)}")
            mism, gap = greedy_vs_argmax(f32_model, out, M1_PROMPT)
            ph.fields.update(prefill_vs_f32_forward_max_abs=f"{prefill_err:.3e}",
                             greedy_vs_argmax_mismatches=mism, worst_gap=f"{gap:.3e}")
            del dec, f32_model, ckpt
        path_all = dict(LAUNCHES)
        if any(v for k, v in path_all.items() if not k.startswith("diag_scan")):
            raise AssertionError(f"path 35 launched other kernels: {path_all}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result

    step_cfg = dict(mc, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device, float32=False):
        m_cfg = dict(step_cfg, compute_dtype="float32") if float32 else step_cfg
        m, _, family = build_models(m_cfg, generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, m_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase("m1_bf16_train_step_card_vs_cpu") as ph:
        step_launches = step_card_vs_cpu_bf16(ph, "bf16 Mamba-1", fresh, dev, x_step, y_step,
                                              {"regular": f["lr"]}, (".mamba.",), sparse_k)
        if step_launches != {"diag_scan": n_layers, "diag_scan_bwd": n_layers}:
            raise AssertionError(f"the bf16 Mamba-1's card step launched {step_launches}")
    print(f"[launches] path 35, bf16 Mamba-1: {path_all}; training alone: "
          f"{({k: v for k, v in trained_launches.items() if v})} ({n_layers} + {n_layers} a "
          "step)", flush=True)
    torch.cuda.empty_cache()
    return path_all


def hybrid_classifier_path(dev, want_files):
    """Main path 36: ``configs/tasks/cifar/cifar-sm-attention.yaml``
    (``CIFAR_SM_ATTENTION_FULL``: 6 layers, d_model 512, 4 heads, a mean
    pool into the classifier MLP of 128, batch 50, L 1,024) in a copy that
    feeds the float grey levels (``tokenize: false``) to the dense encoder
    (``embedding: false``, input_dim 1) and mixes with ``hybrid`` (``LAMBDA``),
    its d_qk at P36_D_QK so that the head dims agree and the softmax runs
    through the flash kernels; weights from seed 1919, on the loader's
    synthetic split cut to P36_TRAIN images.  With every count set to 0: the
    forward on a test batch (card against CPU; the flash forward once a
    layer), 1 epoch (P36_TRAIN // 50 steps) with one eval (the flash forward
    once a layer a step and eval batch, its two backward kernels once a
    layer a step, no materialised softmax), ``mixer_alpha_{i}`` in the run
    logger's last record equal to σ(α) of the trained mixers, the
    checkpoint eigen-analysed (η from activations on CIFAR_ANALYSIS_BATCH
    images, held to the live model's).  Then one card step against the CPU
    step on CIFAR_STEP_EXAMPLES images.  Returns the path's launch counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import CIFAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train
    from tlie_tpu_torch.training.loop import run_name
    from tlie_tpu_torch.training.state import make_family_optimizer

    tag = "hybrid_cifar"
    full = copy.deepcopy(CIFAR_SM_ATTENTION_FULL)
    full["dataset"]["tokenize"] = False
    full["model"].update(embedding=False, mixer="hybrid", state_dim=P36_D_QK)
    mc = full["model"]
    n_layers, bsz, L, heads = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"], \
        mc["num_heads"]
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    train_split, test_split = cifar_splits(full, tag)
    train_split = tuple(a[:P36_TRAIN] for a in train_split)
    test_x, test_y = test_split
    inputs, _ = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"], device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                   device=dev)
        if inputs.shape != (bsz, L, 1) or not inputs.is_floating_point():
            raise AssertionError(f"{tag} inputs {tuple(inputs.shape)} {inputs.dtype}")
        logits = model(inputs)
        torch.cuda.synchronize()
        if {k: v for k, v in LAUNCHES.items() if v} != {"flash_attention_fwd": n_layers}:
            raise AssertionError(f"{tag} forward launches {LAUNCHES}")
        if logits.shape != (bsz, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        _, cpu_model, _ = build_models(mc, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(vs_cpu_max_abs=f"{cpu_err:.3e}",
                         alpha_init=round(float(torch.sigmoid(model.layers[0].mixer.alpha)), 6))
        del model, cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "cifar-hybrid-dense")
    tcfg["dataset"]["synthetic"] = True
    tcfg["train"].update(num_epochs=1, warmup=CIFAR_WARMUP)
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    f = train_fields(tcfg)
    materialised = []
    real_xla = fa.xla_causal_attention
    try:
        with Phase(f"{tag}_train") as ph:
            before = dict(LAUNCHES)
            fa.xla_causal_attention = lambda *a: (materialised.append(1), real_xla(*a))[1]
            try:
                t0 = time.perf_counter()
                result = train(tcfg, train_split, test_split, device=dev)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            finally:
                fa.xla_causal_attention = real_xla
            trained_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            steps = f["total_steps"]
            n_eval = len(result.history) * (len(test_x) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(flash_attention_fwd=n_layers * (steps + n_eval),
                        flash_attention_bwd_dkv=n_layers * steps,
                        flash_attention_bwd_dq=n_layers * steps)
            if trained_launches != want or materialised:
                raise AssertionError(f"{tag} training launches {trained_launches}, expected "
                                     f"{want}; materialised softmax calls {len(materialised)}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            with open(os.path.join("logs", run_name(tcfg) + ".jsonl")) as fh:
                last = json.loads(fh.readlines()[-1])
            alphas = [float(torch.sigmoid(layer.mixer.alpha.detach())[0])
                      for layer in result.model.layers]
            logged = [last.get(f"mixer_alpha_{i}") for i in range(n_layers)]
            if logged != alphas or last.get("step") != steps:
                raise AssertionError(f"{tag} mixer_alpha logged {logged}, σ(α) {alphas}")
            ph.fields.update(steps=steps, seconds=f"{train_s:.2f}",
                             steps_per_s=f"{steps / train_s:.2f}", eval_batches=n_eval,
                             mixer_alpha=[round(a, 6) for a in alphas],
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in trained_launches.items() if v}))

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in result.model.state_dict().items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                         "weights")
            batch = test_x[:CIFAR_ANALYSIS_BATCH]
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, _, _, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf, ckpt_path,
                                                 device=dev, batch=batch)
            live = extract_attention_family(result.eval_model,
                                            torch.as_tensor(batch, device=dev), mc)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            want_shape = (CIFAR_ANALYSIS_BATCH, L - 1, heads, n_layers)
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if (eig.shape != want_shape or eig_init.shape != want_shape or live_rel > 1e-6
                    or not (np.all(eig > 0) and np.isfinite(eig).all())):
                raise AssertionError(f"{tag} spectra {eig.shape}, {live_rel} from the live model")
            if files != want_files:
                raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
            ph.fields.update(perf=f"{perf:.4f}", artifacts=run_dir,
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]")
            del ckpt
        path_all = dict(LAUNCHES)
        if any(v for k, v in path_all.items() if k not in kernels):
            raise AssertionError(f"path 36 launched other kernels: {path_all}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result

    step_cfg = dict(mc, dropout=0.0)
    x_step = torch.as_tensor(train_split[0][:CIFAR_STEP_EXAMPLES], device=dev)
    y_step = torch.as_tensor(train_split[1][:CIFAR_STEP_EXAMPLES], device=dev)

    def fresh(device):
        m, _, family = build_models(step_cfg, generator=torch.Generator().manual_seed(
            full["seed"]), device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        step_card_vs_cpu(ph, tag, fresh, dev, x_step, y_step, {"regular": f["lr"]}, None,
                         TF_GRAD_RTOL_OF_MAX,
                         watch=("mixer_grad_err_over_allowed", lambda n: ".mixer." in n))
        ph.fields.update(examples=CIFAR_STEP_EXAMPLES)
    print(f"[launches] path 36, hybrid dense-encoder classifier: {path_all}; training alone: "
          f"{({k: v for k, v in trained_launches.items() if v})}", flush=True)
    torch.cuda.empty_cache()
    return path_all


def _count_plain_scan():
    """On the CPU, where no kernel launches (a rehearsal of path 37), the
    scan's plain versions counted under the kernels' names, so the counts
    are checked as on the card."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import scan as sc

    def fwd(a, b, reverse=False):
        LAUNCHES["diag_scan"] += 1
        return sc.diag_scan_plain(a, b, reverse)

    def bwd(a, h, g, reverse=False):
        LAUNCHES["diag_scan_bwd"] += 1
        return sc.diag_scan_bwd_plain(a, h, g, reverse)

    sc._on_cuda = lambda t: True
    sc.diag_scan_cuda, sc.diag_scan_bwd_cuda = fwd, bwd


def dp_rank_main(spec_path: str) -> int:
    """One rank of path 37's two-process group (``chip_smoke.py --dp-rank
    SPEC``, started by :func:`tlie_tpu_torch.parallel.mesh.spawn`): the
    spec's config trained through the data-parallel route, then the spec's
    seeds as one stacked sweep spread over the ranks.  Writes this rank's
    final state (``rank<r>.pt``) and its launch counts of each
    (``rank<r>.json``) to the spec's ``out``."""
    from tlie_tpu_torch.config import ExperimentConfig
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import mesh, run_sweep
    from tlie_tpu_torch.training import train

    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = mesh.init_process_group(spec["device"], spec["backend"])
    shard = mesh.process_shard()
    try:
        if dev.type == "cpu":
            _count_plain_scan()
        data = MQAR(**spec["cfg"]["dataset"])
        train_split, test_split = data.split("train"), data.split("test")
        out = {}
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        result = train(spec["cfg"], train_split, test_split, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["train"] = {k: v for k, v in LAUNCHES.items() if v}
        out["history"] = result.history
        torch.save({k: v.detach().cpu() for k, v in result.model.state_dict().items()},
                   os.path.join(spec["out"], f"rank{shard.rank}.pt"))
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        run_sweep(ExperimentConfig(copy.deepcopy(spec["sweep_base"])),
                  [{("seed",): s} for s in spec["seeds"]], train_split, test_split,
                  data.l_max, None, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["sweep"] = {k: v for k, v in LAUNCHES.items() if v}
        with open(os.path.join(spec["out"], f"rank{shard.rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        mesh.destroy_process_group()
    return 0


def dp_compare(ph, key: str, got, ref, lr_sum: float, got_hist=None, ref_hist=None,
               path: str = "path 37"):
    """A run through the data-parallel route (``got``, a state dict, and
    its history) against the one-process run (``ref``): path 37's bounds
    (DP_*).  Fills ``ph.fields[key]`` and raises on a failed check."""
    worst = stats = 0.0
    close = total = 0
    for name, want in ref.items():
        w, g = want.detach().cpu(), got[name].detach().cpu()
        err = (g - w).abs()
        if name.endswith(("running_mean", "running_var")):
            stats = max(stats, (err / w.abs().clamp_min(1.0)).max().item())
        else:
            worst = max(worst, err.max().item())
            close, total = close + int((err <= DP_PARAM_ATOL).sum()), total + err.numel()
    losses = 0.0
    for h, r in zip(got_hist or [], ref_hist or []):
        for k in ("train_loss", "test_loss"):
            losses = max(losses, abs(h[k] - r[k]) / abs(r[k]))
    ph.fields[key] = (f"param_max_abs={worst:.3e},share_within_{DP_PARAM_ATOL:g}="
                      f"{close / total:.6f},stats_max_rel={stats:.3e},loss_max_rel={losses:.3e}")
    if not (worst <= 2 * lr_sum + DP_PARAM_ATOL and close >= DP_PARAM_SHARE * total
            and stats <= STATS_RTOL and losses <= DP_LOSS_RTOL
            and len(got_hist or []) == len(ref_hist or [])):
        raise AssertionError(f"{path}, {key}: {ph.fields[key]}")


def data_parallel_path(dev, want_files):
    """Main path 37, data parallelism on the one card: the MQAR LRU
    (``MQAR_LRU_FULL``: 2 layers, d_model 128, N 128, L 512, batch 64,
    BatchNorm, dropout 0.1, the sparse head, the scan's kernels) trained
    DP_STEPS steps, warmup DP_WARMUP, on DP_TRAIN_EXAMPLES / DP_TEST_EXAMPLES
    examples, weights from seed 1919: first in one process (the reference),
    then through the data-parallel route in a group of one over NCCL (gloo
    on the CPU) in this process, then in a group of two gloo processes
    sharing the card (``mesh.spawn`` of ``chip_smoke.py --dp-rank``), each
    against the reference (:func:`dp_compare`; the second's ranks equal bit
    for bit), the scan's launches counted per rank (2 + 2 a step, the
    forward also once a layer an eval batch on rank 0, which evaluates).
    The two ranks then run the stacked sweep of SWEEP_SEEDS at dropout 0,
    two points a rank, rank 0 writing every checkpoint: each point against
    the same point of the one-process stacked sweep.  Returns the launch
    counts: this process's (``world_1``), each rank's (``world_2``, a list)
    and the ranks' sweep counts (``sweep_2``)."""
    from tlie_tpu_torch.config import (
        MQAR_LRU_FULL, ExperimentConfig, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import mesh, run_sweep
    from tlie_tpu_torch.training import restore_checkpoint, train
    from tlie_tpu_torch.training.schedules import lr_for_step

    tmp = tempfile.mkdtemp(prefix="tlie_dp_")
    base = copy.deepcopy(MQAR_LRU_FULL)
    base["dataset"].update(num_train_examples=DP_TRAIN_EXAMPLES,
                           num_test_examples=DP_TEST_EXAMPLES)
    base["train"].update(total_steps=DP_STEPS, eval_every=DP_STEPS, warmup_steps=DP_WARMUP)
    mc = base["model"]
    n_layers, bsz, L = mc["num_layers"], base["train"]["batch_size"], mc["seq_len"]

    def run_cfg(tag, **model):
        cfg = copy.deepcopy(base)
        cfg["model"].update(model)
        cfg["save"] = os.path.join(tmp, tag, "mqar-lru")
        return derive_runtime_fields(cfg, L, DP_TRAIN_EXAMPLES)

    launches = {}
    try:
        with Phase("dp_data") as ph:
            data = MQAR(**base["dataset"])
            train_split, test_split = data.split("train"), data.split("test")
            ph.fields.update(generator=data.generator, train=train_split[0].shape)
        n_eval = DP_TEST_EXAMPLES // bsz
        f = train_fields(run_cfg("ref"))
        lr_sum = sum(max(lr_for_step(s, f[k], f["warmup"], f["total_steps"], f["cosine"],
                                     f["lr_min"]) for k in ("lr", "ssm_lr"))
                     for s in range(DP_STEPS))
        with Phase("dp_one_process") as ph:
            ref = train(run_cfg("ref"), train_split, test_split, device=dev)
            ref_state = ref.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(base["seed"]),
                                device=dev)[0].state_dict()
            moved = max((ref_state[k] - v).abs().max().item() for k, v in init.items()
                        if not k.endswith(("running_mean", "running_var")))
            if moved <= 10 * DP_PARAM_ATOL:
                raise AssertionError(f"path 37's weights moved {moved}: nothing to compare")
            ph.fields.update(history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in ref.history]),
                             moved=f"{moved:.3e}", lr_sum=f"{lr_sum:.3e}")
        with Phase("dp_world_1") as ph:
            mesh.init_process_group(dev, rank=0, world_size=1,
                                    init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
            try:
                ph.fields["backend"] = torch.distributed.get_backend()
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
                one = train(run_cfg("one"), train_split, test_split, device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                launches["world_1"] = {k: v for k, v in LAUNCHES.items() if v}
            finally:
                mesh.destroy_process_group()
            want = {"diag_scan": n_layers * (DP_STEPS + n_eval), "diag_scan_bwd": n_layers * DP_STEPS}
            if launches["world_1"] != want:
                raise AssertionError(f"path 37, world size 1: launches {launches['world_1']}, "
                                     f"expected {want}")
            dp_compare(ph, "vs_one_process", one.model.state_dict(), ref_state, lr_sum,
                       one.history, ref.history)
            ph.fields["launches"] = repr(launches["world_1"])
            del one
        sweep_raw = run_cfg("sweep_ref", dropout=0.0)
        with Phase("dp_one_process_sweep") as ph:
            points = [{("seed",): s} for s in SWEEP_SEEDS]
            ref_sweep, _ = run_sweep(ExperimentConfig(copy.deepcopy(sweep_raw)), points,
                                     train_split, test_split, data.l_max, None, device=dev)
            ph.fields["perfs"] = [round(p, 4) for _, p in ref_sweep]
        with Phase("dp_world_2_gloo") as ph:
            out = os.path.join(tmp, "ranks")
            os.makedirs(out)
            spec = {"cfg": run_cfg("two"), "sweep_base": run_cfg("sweep_two", dropout=0.0),
                    "seeds": list(SWEEP_SEEDS), "out": out, "backend": "gloo",
                    "device": (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                               else "cpu")}
            spec_path = os.path.join(tmp, "spec.json")
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            t0 = time.perf_counter()
            code = mesh.spawn([os.path.abspath(__file__), "--dp-rank", spec_path], 2,
                              timeout=600)
            ph.fields["spawn_s"] = f"{time.perf_counter() - t0:.2f}"
            if code != 0:
                raise AssertionError(f"path 37's two gloo processes exited with {code}")
            ranks = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            states = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
                      for r in range(2)]
            unequal = [k for k, v in states[0].items() if not torch.equal(states[1][k], v)]
            if unequal:
                raise AssertionError(f"path 37: the two ranks' states differ at {unequal}")
            dp_compare(ph, "vs_one_process", states[0], ref_state, lr_sum,
                       ranks[0]["history"], ref.history)
            launches["world_2"] = [r["train"] for r in ranks]
            launches["sweep_2"] = [r["sweep"] for r in ranks]
            want = [{"diag_scan": n_layers * (DP_STEPS + n_eval),
                     "diag_scan_bwd": n_layers * DP_STEPS},
                    {"diag_scan": n_layers * DP_STEPS, "diag_scan_bwd": n_layers * DP_STEPS}]
            # the sweep: each rank's two points stacked, one launch a stacked
            # step and eval batch, evals on each rank's own points
            want_sweep = [{"diag_scan": n_layers * (DP_STEPS + n_eval),
                           "diag_scan_bwd": n_layers * DP_STEPS}] * 2
            if launches["world_2"] != want or launches["sweep_2"] != want_sweep:
                raise AssertionError(f"path 37, world size 2: launches {launches}, expected "
                                     f"{want} and {want_sweep}")
            ph.fields.update(launches_per_rank=repr(launches["world_2"]),
                             sweep_launches_per_rank=repr(launches["sweep_2"]))
        with Phase("dp_world_2_sweep_vs_one_process") as ph:
            journal = os.path.join(tmp, "sweep_two", "mqar-lru.sweep_journal.jsonl")
            with open(journal) as fh:
                recs = [json.loads(line) for line in fh]
            if len(recs) != len(SWEEP_SEEDS):
                raise AssertionError(f"path 37's 2-rank sweep journaled {len(recs)} points")
            sweep_lr = sum(lr_for_step(s, f["lr"], f["warmup"], f["total_steps"], f["cosine"],
                                       f["lr_min"]) for s in range(DP_STEPS))
            for rec, (ref_path, ref_perf) in zip(recs, ref_sweep):
                got = restore_checkpoint(rec["path"])["model"]
                want_state = restore_checkpoint(ref_path)["model"]
                key = f"seed_{json.loads(rec['point_key'])['seed']}"
                dp_compare(ph, key, got, want_state, max(lr_sum, sweep_lr))
                if abs(rec["perf"] - ref_perf) > 1e-3:
                    raise AssertionError(f"path 37 sweep {key}: perf {rec['perf']} against "
                                         f"{ref_perf}")
    finally:
        mesh.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[launches] path 37, data parallelism: {launches}", flush=True)
    return launches


def sp_primitive_cases(dev, cfg):
    """Path 38's primitives at the MQAR paths' shapes (``cfg``, the LRU's
    config: batch 64, L 512, N 128, d_model 128): {name: (global
    inputs, the time dim of each (None: whole on every rank), the function
    on a rank's steps (shard, *xs), the one-process function (*xs))}, the
    inputs drawn on ``dev`` from one seed, so every rank draws the same."""
    from tlie_tpu_torch.models.layers import DepthwiseCausalConv
    from tlie_tpu_torch.ops.attention import xla_causal_attention
    from tlie_tpu_torch.ops.linear_attention import chunked_linear_attention
    from tlie_tpu_torch.ops.scan import diag_linear_scan, sequence_parallel
    from tlie_tpu_torch.parallel import (
        ring_causal_attention, sp_diag_linear_scan, sp_linear_attention,
    )

    gen = torch.Generator(device=dev).manual_seed(38)
    mc = cfg["model"]
    B, L, N, D = cfg["train"]["batch_size"], mc["seq_len"], mc["state_dim"], mc["hidden_dim"]

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def ring(*shape):
        r = 0.9 + 0.09 * torch.rand(shape, device=dev, generator=gen)
        th = 6.28 * torch.rand(shape, device=dev, generator=gen)
        return r * torch.cos(th), r * torch.sin(th)

    def positive(*shape):
        return torch.nn.functional.elu(randn(*shape)) + 1

    layer = DepthwiseCausalConv(2 * D, 4, torch.Generator()).to(dev)

    def conv(shard, x, w, b):
        # the module's forward on the given weight and bias, differentiable in both
        run = lambda: (torch.func.functional_call(layer, {"weight": w, "bias": b}, (x,)),)  # noqa: E731
        if shard is None:
            return run()
        with sequence_parallel(shard):
            return run()

    scale = 1.0 / math.sqrt(D)
    return {
        # the LRU's: a (N,) decay pair over (B, L, N) pairs
        "scan_lru": ([*ring(N), randn(B, L, N), randn(B, L, N)], (None, None, 1, 1),
                     lambda sh, *x: sp_diag_linear_scan(x[:2], x[2:], sh),
                     lambda *x: diag_linear_scan(x[:2], x[2:])),
        # Mamba-1's: a real decay per step and channel, (B, L, d_inner·N)
        "scan_real_full": ([torch.rand(8, L, 8 * N, device=dev, generator=gen),
                            randn(8, L, 8 * N)], (1, 1),
                           lambda sh, *x: (sp_diag_linear_scan(*x, sh),),
                           lambda *x: (diag_linear_scan(*x),)),
        # the bidirectional S5's backward direction
        "scan_reverse": ([*ring(N), randn(B, L, N), randn(B, L, N)], (None, None, 1, 1),
                         lambda sh, *x: sp_diag_linear_scan(x[:2], x[2:], sh, reverse=True),
                         lambda *x: diag_linear_scan(x[:2], x[2:], reverse=True)),
        "linear_normalizer": ([positive(B, L, 1, D), positive(B, L, 1, D), randn(B, L, 1, D)],
                              (1, 1, 1),
                              lambda sh, *x: sp_linear_attention(
                                  *x, sh, scale=scale, return_normalizer=True, eps=1e-6),
                              lambda *x: chunked_linear_attention(
                                  *x, scale=scale, return_normalizer=True, eps=1e-6)),
        "ring": ([randn(B, L, 1, D), randn(B, L, 1, D), randn(B, L, 1, D)], (1, 1, 1),
                 lambda sh, *x: (ring_causal_attention(*x, sh, scale=scale),),
                 lambda *x: (xla_causal_attention(*x, scale),)),
        # Mamba-1's d_conv 4 over its d_inner 256
        "halo_conv": ([randn(B, L, 2 * D), 0.5 * randn(2 * D, 1, 4), randn(2 * D)],
                      (1, None, None),
                      lambda sh, *x: conv(sh, *x), lambda *x: conv(None, *x)),
    }


def sp_primitive_check(shard, dev, cfg) -> dict:
    """Each of :func:`sp_primitive_cases` on this rank's steps (``shard``, a
    time shard) against the one-process function on the same card: the
    outputs and the gradients of Σ out·w with respect to every input (a
    whole input's summed over the group), each within SP_RTOL_OF_MAX of
    its reference's max.  Checks that each scan call launched the forward
    and the backward kernel once.  Returns {name: "max_rel_err/bound"}."""
    from tlie_tpu_torch.ops import LAUNCHES

    gen = torch.Generator(device=dev).manual_seed(3838)
    out = {}
    for name, (inputs, dims, f_sp, f_one) in sp_primitive_cases(dev, cfg).items():
        ref_in = [x.clone().requires_grad_() for x in inputs]
        ref = f_one(*ref_in)
        ws = [torch.randn(o.shape, device=dev, generator=gen) for o in ref]
        ref_g = torch.autograd.grad(sum((o * w).sum() for o, w in zip(ref, ws)), ref_in)
        local = [(shard.steps(x, d) if d is not None else x).clone().requires_grad_()
                 for x, d in zip(inputs, dims)]
        before = dict(LAUNCHES)
        got = f_sp(shard, *local)
        got_g = torch.autograd.grad(sum((o * shard.steps(w)).sum() for o, w in zip(got, ws)),
                                    local)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if name.startswith("scan") and (LAUNCHES["diag_scan"] != before["diag_scan"] + 1 or
                                        LAUNCHES["diag_scan_bwd"] != before["diag_scan_bwd"] + 1):
            raise AssertionError(f"path 38 {name}: the local scan did not launch each kernel "
                                 "once")
        worst = 0.0
        pairs = [(o, shard.steps(r)) for o, r in zip(got, ref)]
        pairs += [(shard.sum(g) if d is None else g, r if d is None else shard.steps(r, d))
                  for g, r, d in zip(got_g, ref_g, dims)]
        for g, r in pairs:
            scale = r.abs().max().item()
            worst = max(worst, (g.detach() - r.detach()).abs().max().item() / max(scale, 1e-30))
        out[name] = f"{worst:.3e}/{SP_RTOL_OF_MAX:g}"
        if not worst <= SP_RTOL_OF_MAX:
            raise AssertionError(f"path 38 {name} on rank {shard.rank} of {shard.world}: "
                                 f"{out[name]} of the max")
    return out


def sp_rank_main(spec_path: str) -> int:
    """One rank of path 38's two-process group (``chip_smoke.py --sp-rank
    SPEC``): the primitives on this rank's steps, then each of the spec's
    configs trained through the sequence-parallel route.  Writes this
    rank's final states (``<job>-rank<r>.pt``), and its primitive errors,
    launch counts and histories (``rank<r>.json``) to the spec's ``out``."""
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import mesh
    from tlie_tpu_torch.training import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = mesh.init_process_group(spec["device"], spec["backend"])
    group = mesh.process_shard()
    shard = mesh.Shard(group.rank, group.world, axis=1)
    try:
        if dev.type == "cpu":
            _count_plain_scan()
        jobs = spec["jobs"]
        out = {"primitives": sp_primitive_check(shard, dev, jobs["lru"])}
        data = MQAR(**jobs["lru"]["dataset"])
        train_split, test_split = data.split("train"), data.split("test")
        for job, cfg in jobs.items():
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            result = train(cfg, train_split, test_split, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[job] = {"launches": {k: v for k, v in LAUNCHES.items() if v},
                        "history": result.history}
            torch.save({k: v.detach().cpu() for k, v in result.model.state_dict().items()},
                       os.path.join(spec["out"], f"{job}-rank{group.rank}.pt"))
        with open(os.path.join(spec["out"], f"rank{group.rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        mesh.destroy_process_group()
    return 0


def sequence_parallel_path(dev, want_files):
    """Main path 38, sequence parallelism on the one card (ROADMAP Queue 1
    item 17b): the primitives (:func:`sp_primitive_check`: the scan real,
    as pairs with the LRU's (N,) decay and reversed, the linear attention
    with its normaliser, the ring attention with its gradients, the halo
    convolution) in a group of one over NCCL (gloo on the CPU) in this
    process, then in two gloo processes sharing the card
    (``chip_smoke.py --sp-rank``), which also train the MQAR LRU
    (``MQAR_LRU_FULL``: 2 layers, d_model 128, N 128, L 512, batch 64,
    BatchNorm, dropout 0.1, the sparse head, the scan's kernels) and the
    MQAR softmax transformer (``MQAR_SM_ATTENTION_FULL``, the ring) SP_STEPS
    steps each with ``train.sequence_parallel: 2``, weights from seed 1919;
    each against the one-process run of the same config (:func:`dp_compare`,
    the two ranks' states equal bit for bit), the scan's launches counted
    per rank (the LRU's 2 + 2 a step and 2 an eval batch, on both ranks,
    which evaluate together; the ring launches none).  Returns the launch
    counts of each rank's training runs (``world_2``: {job: [rank 0's,
    rank 1's]})."""
    from tlie_tpu_torch.config import (
        MQAR_LRU_FULL, MQAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.parallel import mesh
    from tlie_tpu_torch.training import train
    from tlie_tpu_torch.training.schedules import lr_for_step

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tlie_sp_")
    bases = {"lru": MQAR_LRU_FULL, "sm": MQAR_SM_ATTENTION_FULL}

    def run_cfg(job, sp):
        cfg = copy.deepcopy(bases[job])
        cfg["dataset"].update(num_train_examples=SP_TRAIN_EXAMPLES,
                              num_test_examples=SP_TEST_EXAMPLES)
        cfg["train"].update(total_steps=SP_STEPS, eval_every=SP_STEPS, warmup_steps=SP_WARMUP,
                            sequence_parallel=sp)
        cfg["save"] = None
        return derive_runtime_fields(cfg, cfg["model"]["seq_len"], SP_TRAIN_EXAMPLES)

    launches = {}
    try:
        lru = run_cfg("lru", 1)
        with Phase("sp_world_1_primitives") as ph:
            mesh.init_process_group(dev, rank=0, world_size=1,
                                    init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
            try:
                ph.fields["backend"] = torch.distributed.get_backend()
                ph.fields.update(sp_primitive_check(mesh.Shard(0, 1, axis=1), dev, lru))
            finally:
                mesh.destroy_process_group()
        with Phase("sp_data") as ph:
            data = MQAR(**lru["dataset"])
            train_split, test_split = data.split("train"), data.split("test")
            ph.fields.update(generator=data.generator, train=train_split[0].shape)
        refs, lr_sums = {}, {}
        with Phase("sp_one_process") as ph:
            for job in bases:
                cfg = run_cfg(job, 1)
                if cfg["dataset"] != lru["dataset"]:
                    raise AssertionError(f"path 38's {job} reads another MQAR split")
                refs[job] = train(cfg, train_split, test_split, device=dev)
                f = train_fields(cfg)
                lr_sums[job] = sum(
                    max(lr_for_step(s, f[k], f["warmup"], f["total_steps"], f["cosine"],
                                    f["lr_min"]) for k in ("lr", "ssm_lr"))
                    for s in range(SP_STEPS))
                init = build_models(cfg["model"], generator=torch.Generator().manual_seed(
                    cfg["seed"]), device=dev)[0].state_dict()
                state = refs[job].model.state_dict()
                moved = max((state[k] - v).abs().max().item() for k, v in init.items()
                            if not k.endswith(("running_mean", "running_var")))
                if moved <= 10 * DP_PARAM_ATOL:
                    raise AssertionError(f"path 38's {job} weights moved {moved}")
                ph.fields[f"{job}_history"] = repr([{k: round(v, 4) for k, v in r.items()}
                                                    for r in refs[job].history])
                ph.fields[f"{job}_moved"] = f"{moved:.3e}"
        with Phase("sp_world_2_gloo") as ph:
            out = os.path.join(tmp, "ranks")
            os.makedirs(out)
            spec = {"jobs": {job: run_cfg(job, 2) for job in bases}, "out": out,
                    "backend": "gloo",
                    "device": (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                               else "cpu")}
            spec_path = os.path.join(tmp, "spec.json")
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            t0 = time.perf_counter()
            code = mesh.spawn([os.path.abspath(__file__), "--sp-rank", spec_path], 2,
                              timeout=600)
            ph.fields["spawn_s"] = f"{time.perf_counter() - t0:.2f}"
            if code != 0:
                raise AssertionError(f"path 38's two gloo processes exited with {code}")
            ranks = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            for r, rank in enumerate(ranks):
                ph.fields[f"primitives_rank{r}"] = repr(rank["primitives"])
            n_layers = lru["model"]["num_layers"]
            n_eval = SP_TEST_EXAMPLES // lru["train"]["batch_size"]
            want = {"lru": {"diag_scan": n_layers * (SP_STEPS + n_eval),
                            "diag_scan_bwd": n_layers * SP_STEPS}, "sm": {}}
            for job in bases:
                states = [torch.load(os.path.join(out, f"{job}-rank{r}.pt"), weights_only=True)
                          for r in range(2)]
                unequal = [k for k, v in states[0].items() if not torch.equal(states[1][k], v)]
                if unequal:
                    raise AssertionError(f"path 38 {job}: the two ranks' states differ at "
                                         f"{unequal}")
                dp_compare(ph, f"{job}_vs_one_process", states[0],
                           refs[job].model.state_dict(), lr_sums[job], ranks[0][job]["history"],
                           refs[job].history, path="path 38")
                launches[job] = [rank[job]["launches"] for rank in ranks]
                if launches[job] != [want[job]] * 2:
                    raise AssertionError(f"path 38 {job}: launches per rank {launches[job]}, "
                                         f"expected {want[job]} on each")
            ph.fields["launches_per_rank"] = repr(launches)
    finally:
        mesh.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_start
    print(f"[launches] path 38, sequence parallelism: {launches}", flush=True)
    print(f"[path 38 seconds] {secs:.2f}", flush=True)
    return {"world_2": launches, "seconds": secs}


def _count_plain_flash():
    """On the CPU (a rehearsal of path 39's ranks) the flash attention's
    plain versions counted under the kernels' names."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa

    def counted(name, plain):
        def launch(*args):
            LAUNCHES[name] += 1
            return plain(*args)
        return launch

    fa._on_cuda = lambda t: True
    fa.flash_attention_fwd_cuda = counted("flash_attention_fwd", fa.flash_attention_plain)
    fa.flash_attention_bwd_dkv_cuda = counted("flash_attention_bwd_dkv",
                                              fa.flash_attention_bwd_dkv_plain)
    fa.flash_attention_bwd_dq_cuda = counted("flash_attention_bwd_dq",
                                             fa.flash_attention_bwd_dq_plain)


def tp_primitive_check(data, vocab, dev, shape) -> dict:
    """Path 39's primitives at ``shape`` (B, L, V, d) on this rank's block
    (``data``'s rows, ``vocab``'s V/m columns) of seeded global inputs,
    against the one-process dense forms on the same card: the embedding
    (its output and its table's gradient), the decoder through its copy
    into the model region (the logits, dx, dW, db), the CE on float32 and
    bfloat16 logits with MQAR's share of ``-100`` labels (the loss summed
    over the data ranks, dlogits) and the argmax, ties placed across the
    shards at every other position.  Each within TP_RTOL_OF_MAX of its
    reference's max (the argmax equal).  Returns {name: "err/bound"}."""
    import torch.nn.functional as F

    from tlie_tpu_torch.parallel.tp import (
        VocabParallelLinear, vocab_parallel_argmax, vocab_parallel_cross_entropy,
        vocab_parallel_embedding,
    )
    from tlie_tpu_torch.training.steps import cross_entropy_loss

    B, L, V, D = shape
    gen = torch.Generator(device=dev).manual_seed(39)

    def randn(*s):
        return torch.randn(s, device=dev, generator=gen)

    def cols(t, dim=-1):
        n = t.shape[dim] // vocab.world
        return t.narrow(dim, vocab.rank * n, n)

    out = {}

    def check(name, got, want):
        got, want = got.detach().float(), want.detach().float()
        err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        out[name] = f"{err:.3e}/{TP_RTOL_OF_MAX:g}"
        if not err <= TP_RTOL_OF_MAX:
            raise AssertionError(f"path 39 {name} on data rank {data.rank}, model rank "
                                 f"{vocab.rank}: {out[name]} of the max")

    ids = data.rows(torch.randint(V, (B, L), device=dev, generator=gen))
    table = randn(V, D).requires_grad_()
    w_emb = data.rows(randn(B, L, D))
    ref = F.embedding(ids, table)
    (ref_g,) = torch.autograd.grad((ref * w_emb).sum(), [table])
    local = cols(table.detach(), 0).clone().requires_grad_()
    got = vocab_parallel_embedding(ids, local, vocab)
    (got_g,) = torch.autograd.grad((got * w_emb).sum(), [local])
    check("embedding", got, ref)
    check("embedding_dtable", got_g, cols(ref_g, 0))

    x = data.rows(randn(B, L, D)).requires_grad_()
    weight, bias = randn(V, D).requires_grad_(), randn(V).requires_grad_()
    w_dec = data.rows(randn(B, L, V))
    ref = F.linear(x, weight, bias)
    ref_g = torch.autograd.grad((ref * w_dec).sum(), [x, weight, bias])
    dec = VocabParallelLinear(cols(weight.detach(), 0).clone(), cols(bias.detach(), 0).clone(),
                              vocab)
    xl = x.detach().clone().requires_grad_()
    got = dec(xl)
    got_g = torch.autograd.grad((got * cols(w_dec)).sum(), [xl, dec.weight, dec.bias])
    check("decoder", got, cols(ref))
    check("decoder_dx", got_g[0], ref_g[0])
    check("decoder_dweight", got_g[1], cols(ref_g[1], 0))
    check("decoder_dbias", got_g[2], cols(ref_g[2], 0))
    del ref, ref_g, got, got_g, w_dec

    labels = torch.randint(V, (B, L), device=dev, generator=gen)
    labels = torch.where(torch.rand(B, L, device=dev, generator=gen) < 0.125, labels, -100)
    logits = randn(B, L, V)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "ce" if dtype == torch.float32 else "ce_bf16"
        whole = logits.to(dtype).requires_grad_()
        ref = cross_entropy_loss(whole, labels)
        (ref_g,) = torch.autograd.grad(ref, [whole])
        part = cols(data.rows(whole.detach())).clone().requires_grad_()
        got = vocab_parallel_cross_entropy(part, data.rows(labels), vocab, data)
        (got_g,) = torch.autograd.grad(got, [part])
        check(tag, data.sum(got.detach()), ref)
        check(f"{tag}_dlogits", got_g, cols(data.rows(ref_g)))
        del whole, ref, ref_g, part, got_g
    ties = data.rows(logits).clone()
    ties[:, ::2, 1] = ties[:, ::2, V - 2] = 1e4  # the first and the last shard
    want = torch.argmax(ties, dim=-1)
    got = vocab_parallel_argmax(cols(ties), vocab)
    if not torch.equal(got, want) or not bool((want[:, ::2] == 1).all()):
        raise AssertionError(f"path 39 argmax on data rank {data.rank}, model rank "
                             f"{vocab.rank}: {int((got != want).sum())} positions differ")
    out["argmax"] = "equal"
    return out


def tp_route_steps(cfg, data, vocab, train_split, dev, steps: int):
    """``steps`` training steps of ``cfg``'s model on the first batches of
    the train split at the config's peak rate, through the tensor-parallel
    route's modules on the shards (``data``, ``vocab``) or, with None, in
    one process; returns the whole state (the split leaves gathered)."""
    from tlie_tpu_torch.config import train_fields
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.parallel.tp import gather_vocab_parallel
    from tlie_tpu_torch.training import train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    f = train_fields(cfg)
    model, _, family = build_models(cfg["model"],
                                    generator=torch.Generator().manual_seed(cfg["seed"]),
                                    device=dev, vocab_shard=vocab)
    if data is not None:
        data.attach(model)
    opt, clip = make_family_optimizer(model, family, cfg["model"], cfg["train"], f)
    x = torch.as_tensor(train_split[0][:steps * f["batch_size"]], device=dev).long()
    y = torch.as_tensor(train_split[1][:steps * f["batch_size"]], device=dev).long()
    for s in range(steps):
        rows = slice(s * f["batch_size"], (s + 1) * f["batch_size"])
        xs, ys = x[rows], y[rows]
        if data is not None:
            xs, ys = data.rows(xs), data.rows(ys)
        train_step(model, opt, xs, ys, {"regular": f["lr"], "ssm": f["ssm_lr"]},
                   clip_norm=clip, shard=data)
    if vocab is None:
        return model.state_dict()
    return gather_vocab_parallel(model, vocab)[0]


def tp_rank_main(spec_path: str) -> int:
    """One rank of path 39's four-process group (``chip_smoke.py --tp-rank
    SPEC``): the primitives on this rank's block of the (2 × 2) layout, the
    spec's transformer trained through the tensor-parallel route (rank 0
    writing its checkpoint), the spec's checkpoint served over this rank's
    data group; then ranks 0 and 1 start a group of two and train the
    spec's LRU (1 × 2).  Writes each run's gathered state
    (``<job>-rank<r>.pt``), the tokens (``decode-rank<r>.pt``) and this
    rank's primitive errors, launch counts, histories and checkpoint path
    (``rank<r>.json``) to the spec's ``out``."""
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import mesh
    from tlie_tpu_torch.training import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = mesh.init_process_group(spec["device"], spec["backend"])
    rank = mesh.process_shard().rank
    out_dir = spec["out"]

    def sync_counts():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        return counts

    def run(job):
        sync_counts()
        result = train(spec["jobs"][job], *splits, device=dev)
        out[job] = {"launches": sync_counts(), "history": result.history, "path": result[0]}
        torch.save({k: v.detach().cpu() for k, v in result.model.state_dict().items()},
                   os.path.join(out_dir, f"{job}-rank{rank}.pt"))

    out = {}
    try:
        if dev.type == "cpu":
            _count_plain_scan()
            _count_plain_flash()
        data, vocab = mesh.mesh_2d(2)
        out["primitives"] = tp_primitive_check(data, vocab, dev, spec["prim_shape"])
        mqar = MQAR(**spec["jobs"]["sm"]["dataset"])
        splits = (mqar.split("train"), mqar.split("test"))
        run("sm")
        dec = Decoder.from_checkpoint(spec["serve"], device=dev, shard=data)
        prompts = torch.as_tensor(splits[1][0][:spec["serve_batch"], :spec["prompt"]],
                                  device=dev)
        sync_counts()
        tokens = {"greedy": dec.generate(prompts, spec["n_new"]),
                  "sampled": dec.generate(prompts, spec["n_new"], temperature=0.8, top_k=10,
                                          generator=torch.Generator(device=dev).manual_seed(39))}
        out["decode"] = {"launches": sync_counts()}
        torch.save({k: v.cpu() for k, v in tokens.items()},
                   os.path.join(out_dir, f"decode-rank{rank}.pt"))
        if rank < 2:  # the LRU over 1 × 2: a group of the first two ranks
            mesh.destroy_process_group()
            mesh.init_process_group(spec["device"], spec["backend"], rank=rank, world_size=2,
                                    init_method=f"tcp://127.0.0.1:{spec['port']}")
            run("lru")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        mesh.destroy_process_group()
    return 0


def tensor_parallel_path(dev, want_files):
    """Main path 39, vocab tensor parallelism on the one card (ROADMAP Queue
    1 item 17c): the primitives (:func:`tp_primitive_check`) and
    TP_NCCL_STEPS steps of the MQAR softmax transformer through the route's
    modules at m = 1 (:func:`tp_route_steps`, against the same steps in one
    process) in a group of one over NCCL (gloo on the CPU), the subgroups of
    ``mesh_2d(1)`` included; then four gloo processes sharing the card
    (``chip_smoke.py --tp-rank``): the primitives at 2 × 2, the MQAR softmax
    transformer (``MQAR_SM_ATTENTION_FULL``: 2 layers, d_model 128, vocab
    8192, L 512, batch 64, dropout 0.1, the flash kernels) trained TP_STEPS
    steps with ``train.model_parallel: 2`` (2 × 2), the one-process run's
    checkpoint served over each rank's data group (tokens equal to one
    process, greedy and sampled), then the MQAR LRU (``MQAR_LRU_FULL``:
    BatchNorm, dropout 0.1, the scan's kernels) over two of them (1 × 2);
    each run against the one-process run of the same config
    (:func:`dp_compare`, every rank's gathered state equal bit for bit), the
    gathered checkpoint's η against the one-process checkpoint's, and each
    rank's launches counted (the ranks of data index 0 evaluate).  Returns
    the launch counts: the group of one's (``world_1``), each rank's
    training runs (``sm``, ``lru``: lists) and serving (``decode``)."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.config import (
        MQAR_LRU_FULL, MQAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.data import MQAR
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import mesh
    from tlie_tpu_torch.training import train
    from tlie_tpu_torch.training.schedules import lr_for_step

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tlie_tp_")
    bases = {"sm": MQAR_SM_ATTENTION_FULL, "lru": MQAR_LRU_FULL}

    def run_cfg(job, mp, save=None):
        cfg = copy.deepcopy(bases[job])
        cfg["dataset"].update(num_train_examples=TP_TRAIN_EXAMPLES,
                              num_test_examples=TP_TEST_EXAMPLES)
        cfg["train"].update(total_steps=TP_STEPS, eval_every=TP_STEPS, warmup_steps=TP_WARMUP,
                            model_parallel=mp)
        cfg["save"] = save
        return derive_runtime_fields(cfg, cfg["model"]["seq_len"], TP_TRAIN_EXAMPLES)

    def counts():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return {k: v for k, v in LAUNCHES.items() if v}

    launches = {}
    try:
        sm1 = run_cfg("sm", 1, save=os.path.join(tmp, "one", "mqar-sm-attention"))
        n_layers = sm1["model"]["num_layers"]
        bsz = sm1["train"]["batch_size"]
        n_eval = TP_TEST_EXAMPLES // bsz
        with Phase("tp_data") as ph:
            data = MQAR(**sm1["dataset"])
            train_split, test_split = data.split("train"), data.split("test")
            if run_cfg("lru", 1)["dataset"] != sm1["dataset"]:
                raise AssertionError("path 39's LRU reads another MQAR split")
            ph.fields.update(generator=data.generator, train=train_split[0].shape)
        lr_sums = {}
        for job in bases:
            f = train_fields(run_cfg(job, 1))
            lr_sums[job] = sum(max(lr_for_step(s, f[k], f["warmup"], f["total_steps"],
                                               f["cosine"], f["lr_min"]) for k in ("lr", "ssm_lr"))
                               for s in range(TP_STEPS))
        with Phase("tp_world_1_nccl") as ph:
            mesh.init_process_group(dev, rank=0, world_size=1,
                                    init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
            try:
                ph.fields["backend"] = torch.distributed.get_backend()
                data_s, vocab_s = mesh.mesh_2d(1)
                ph.fields.update(tp_primitive_check(data_s, vocab_s, dev, TP_PRIM_SHAPE))
                counts()
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
                got = tp_route_steps(sm1, data_s, vocab_s, train_split, dev, TP_NCCL_STEPS)
                launches["world_1"] = counts()
                want = {f"flash_attention_{k}": n_layers * TP_NCCL_STEPS
                        for k in ("fwd", "bwd_dkv", "bwd_dq")}
                if launches["world_1"] != want:
                    raise AssertionError(f"path 39, m = 1: launches {launches['world_1']}, "
                                         f"expected {want}")
            finally:
                mesh.destroy_process_group()
            ref = tp_route_steps(sm1, None, None, train_split, dev, TP_NCCL_STEPS)
            f = train_fields(sm1)
            dp_compare(ph, "m1_vs_one_process", got, ref, TP_NCCL_STEPS * f["lr"],
                       path="path 39")
            ph.fields["launches"] = repr(launches["world_1"])
        refs = {}
        with Phase("tp_one_process") as ph:
            for job, cfg in (("sm", sm1), ("lru", run_cfg("lru", 1))):
                refs[job] = train(cfg, train_split, test_split, device=dev)
                init = build_models(cfg["model"], generator=torch.Generator().manual_seed(
                    cfg["seed"]), device=dev)[0].state_dict()
                state = refs[job].model.state_dict()
                moved = max((state[k] - v).abs().max().item() for k, v in init.items()
                            if not k.endswith(("running_mean", "running_var")))
                if moved <= 10 * DP_PARAM_ATOL:
                    raise AssertionError(f"path 39's {job} weights moved {moved}")
                ph.fields[f"{job}_history"] = repr([{k: round(v, 4) for k, v in r.items()}
                                                    for r in refs[job].history])
                ph.fields[f"{job}_moved"] = f"{moved:.3e}"
        with Phase("tp_one_process_serving") as ph:
            dec = Decoder.from_checkpoint(refs["sm"][0], device=dev)
            prompts = torch.as_tensor(test_split[0][:bsz, :TP_PROMPT], device=dev)
            want_tokens = {"greedy": dec.generate(prompts, TP_NEW),
                           "sampled": dec.generate(prompts, TP_NEW, temperature=0.8, top_k=10,
                                                   generator=torch.Generator(
                                                       device=dev).manual_seed(39))}
            ph.fields["tokens"] = repr({k: tuple(v.shape) for k, v in want_tokens.items()})
        with Phase("tp_gloo_ranks") as ph:
            out = os.path.join(tmp, "ranks")
            os.makedirs(out)
            spec = {"jobs": {"sm": run_cfg("sm", 2, save=os.path.join(tmp, "tp",
                                                                      "mqar-sm-attention")),
                             "lru": run_cfg("lru", 2)},
                    "out": out, "backend": "gloo", "prim_shape": list(TP_PRIM_SHAPE),
                    "serve": refs["sm"][0], "serve_batch": bsz, "prompt": TP_PROMPT,
                    "n_new": TP_NEW, "port": mesh.free_port(),
                    "device": (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                               else "cpu")}
            spec_path = os.path.join(tmp, "spec.json")
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            t0 = time.perf_counter()
            code = mesh.spawn([os.path.abspath(__file__), "--tp-rank", spec_path], 4,
                              timeout=600)
            ph.fields["spawn_s"] = f"{time.perf_counter() - t0:.2f}"
            if code != 0:
                raise AssertionError(f"path 39's four gloo processes exited with {code}")
            ranks = []
            for r in range(4):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            for r, rank in enumerate(ranks):
                ph.fields[f"primitives_rank{r}"] = repr(rank["primitives"])
            flash = {f"flash_attention_{k}": n_layers * TP_STEPS
                     for k in ("fwd", "bwd_dkv", "bwd_dq")}
            evals = dict(flash, flash_attention_fwd=n_layers * (TP_STEPS + n_eval))
            lru_layers = spec["jobs"]["lru"]["model"]["num_layers"]
            want = {"sm": [evals, evals, flash, flash],
                    "lru": [{"diag_scan": lru_layers * (TP_STEPS + n_eval),
                             "diag_scan_bwd": lru_layers * TP_STEPS}] * 2}
            for job, n in (("sm", 4), ("lru", 2)):
                states = [torch.load(os.path.join(out, f"{job}-rank{r}.pt"), weights_only=True)
                          for r in range(n)]
                unequal = [k for s in states[1:] for k, v in states[0].items()
                           if not torch.equal(s[k], v)]
                if unequal:
                    raise AssertionError(f"path 39 {job}: the ranks' states differ at {unequal}")
                dp_compare(ph, f"{job}_vs_one_process", states[0], refs[job].model.state_dict(),
                           lr_sums[job], ranks[0][job]["history"], refs[job].history,
                           path="path 39")
                launches[job] = [rank[job]["launches"] for rank in ranks[:n]]
                if launches[job] != want[job]:
                    raise AssertionError(f"path 39 {job}: launches per rank {launches[job]}, "
                                         f"expected {want[job]}")
            launches["decode"] = [rank["decode"]["launches"] for rank in ranks]
            if launches["decode"] != [{"flash_attention_fwd": 2 * n_layers}] * 4:
                raise AssertionError(f"path 39 serving: launches per rank {launches['decode']}")
            for r in range(4):
                tokens = torch.load(os.path.join(out, f"decode-rank{r}.pt"), weights_only=True)
                for how, want_t in want_tokens.items():
                    if not torch.equal(tokens[how], want_t.cpu()):
                        raise AssertionError(f"path 39 serving, rank {r}: {how} tokens differ "
                                             "from one process's")
            ph.fields["launches_per_rank"] = repr(launches)
        with Phase("tp_checkpoint_eval_eig") as ph:
            tp_path = ranks[0]["sm"]["path"]
            if not tp_path or any(rank["sm"]["path"] != tp_path for rank in ranks):
                raise AssertionError(f"path 39: checkpoint paths {[r['sm']['path'] for r in ranks]}")
            batch = test_split[0][:TP_EIG_BATCH]
            eigs = []
            for tag, path in (("tp", tp_path), ("one", refs["sm"][0])):
                eig_dir = os.path.join(tmp, f"analysis_{tag}")
                eigs.append(eval_eig(sm1, {"save_path": eig_dir}, 0.0, path, device=dev,
                                     batch=batch)[0])
                (run_dir,) = os.listdir(eig_dir)
                files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
                if files != want_files:
                    raise AssertionError(f"path 39 artifacts {run_dir}: {files}")
            rel = float(np.abs(eigs[0] - eigs[1]).max() / np.abs(eigs[1]).max())
            ph.fields.update(eta_max_rel=f"{rel:.3e}/{TP_SPECTRA_RTOL:g}",
                             eta_shape=eigs[0].shape)
            if not (np.isfinite(eigs[0]).all() and rel <= TP_SPECTRA_RTOL):
                raise AssertionError(f"path 39: the gathered checkpoint's η against one "
                                     f"process's: {rel}")
    finally:
        mesh.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_start
    print(f"[launches] path 39, vocab tensor parallelism: {launches}", flush=True)
    print(f"[path 39 seconds] {secs:.2f}", flush=True)
    return dict(launches, seconds=secs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    # imported after the card check: a copy of this script alone has no package
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import (
        extract_attention_family, extract_ssm_family, ssm_layer_params,
    )
    from tlie_tpu_torch.config import (
        CIFAR_MAMBA2_FULL, CIFAR_MAMBA2_LTI_FULL, CIFAR_NORM_ATTENTION_GATING_FULL, CIFAR_S4_FULL,
        CIFAR_SM_ATTENTION_FULL, IMDB_MAMBA2_FULL, LISTOPS_MAMBA2_FULL, LISTOPS_S4_FULL,
        LISTOPS_S5_FULL, MQAR_LIN_ATTENTION_FULL, MQAR_LRU_FULL, MQAR_MAMBA2_FULL,
        MQAR_NORM_ATTENTION_CONV_FULL, MQAR_S4_FULL, MQAR_S5_FULL, PATHFINDER_S4_FULL,
        SC_S5_MFCC_FULL, WIKITEXT_LRU_SHORT, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.data import MQAR, WikiText, masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES, diag_linear_scan
    from tlie_tpu_torch.ops import decay_attention as dattn
    from tlie_tpu_torch.ops.attention import FLASH_ATTENTION
    from tlie_tpu_torch.ops import fused_xent as fx
    from tlie_tpu_torch.ops._build import find_nvcc
    from tlie_tpu_torch.ops.ssd import _auto_chunk
    from tlie_tpu_torch.ops.scan import (
        DIAG_SCAN, DIAG_SCAN_BWD, diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda,
        diag_scan_plain,
    )
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer, make_optimizer
    from tlie_tpu_torch.training.steps import cross_entropy_loss, head_logits

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    # 1. the device
    with Phase("device") as ph:
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        try:
            import yaml  # noqa: F401
            has_yaml = True
        except ImportError:
            has_yaml = False
        ph.fields.update(kind=repr(kind), smi=repr(smi), torch=torch.__version__,
                         cuda=torch.version.cuda, count=torch.cuda.device_count(),
                         yaml=has_yaml)

    # 2. the nvcc build: one nvcc per source, all started together
    with Phase("build") as ph:
        libs = {"diag_scan": DIAG_SCAN, "diag_scan_bwd": DIAG_SCAN_BWD,
                "fused_xent": fx.FUSED_XENT, "fused_xent_bf16": fx.FUSED_XENT_BF16,
                "decay_attention": dattn.DECAY_ATTENTION,
                "decay_attention_bf16": dattn.DECAY_ATTENTION_BF16,
                "flash_attention": FLASH_ATTENTION}
        nvcc, tc_libs = find_nvcc(), set(TC_KERNELS.values())

        def build_and_read(name):
            # a tensor-core library's SASS is read as soon as it is built,
            # while the slower builds go on
            report = libs[name].load()
            return report, (tensor_core_hmma([report.path], nvcc) if name in tc_libs else {})

        with ThreadPoolExecutor(len(libs)) as pool:
            built = dict(zip(libs, pool.map(build_and_read, libs)))
        reports = {name: report for name, (report, _) in built.items()}
        for name, report in reports.items():
            ph.fields[f"{name}_nvcc_s"] = f"{report.seconds:.2f}"
            ph.fields[f"{name}_ptxas"] = repr(ptxas_kernels(report.log))
            ph.fields[f"{name}_spill_bytes"] = repr(ptxas_spills(report.log))
        spilled = {name: ptxas_spills(report.log) for name, report in reports.items()
                   if any(ptxas_spills(report.log))}
        if spilled:
            raise AssertionError(f"kernels that spill registers (bytes): {spilled}")
        # the fused head's three kernels, the flash attention's three and the
        # decay attention's three run their products on the tensor cores:
        # each one's SASS holds TF32 HMMAs, and the decay attention's and
        # the fused head's bfloat16 kernels bfloat16 ones
        hmma = {}
        for name in sorted(tc_libs):
            for kernel, ops in built[name][1].items():
                merged = hmma.setdefault(kernel, {})
                for op, n in ops.items():
                    merged[op] = merged.get(op, 0) + n
        ph.fields["tensor_core_sass_hmma"] = repr(hmma)
        if not tensor_core_ops_ok(hmma):
            raise AssertionError(f"tensor-core kernels without their HMMA or HGMMA: {hmma}")

    # 3. each kernel against its plain version, at the path's shape and two others
    gen = torch.Generator(device=dev).manual_seed(0)

    def ring(shape):
        r = 0.9 + 0.09 * torch.rand(shape, device=dev, generator=gen)
        th = 6.28 * torch.rand(shape, device=dev, generator=gen)
        return r * torch.cos(th), r * torch.sin(th)

    def normal_pair(shape):
        return (torch.randn(shape, device=dev, generator=gen),
                torch.randn(shape, device=dev, generator=gen))

    with Phase("kernel_vs_plain") as ph:
        # (a, b, reverse); a block takes 16 channels of one batch row and
        # walks time in rounds of 256 steps (16 chunks of 16)
        cases = {
            "complex_b64_l512_n128_bcast_a": (ring((512, 128)), normal_pair((64, 512, 128)),
                                              False),
            "real_b64_l512_n128_full_a": (ring((64, 512, 128))[0].abs(),
                                          torch.randn(64, 512, 128, device=dev, generator=gen),
                                          False),
            "complex_b3_l997_n96_const_a": (ring((96,)), normal_pair((3, 997, 96)), False),
            # the WikiText LM's shape: 32 blocks of 16 channels a batch row,
            # four rounds each
            "complex_b8_l1024_n512_lambda": (ring((512,)), normal_pair((8, 1024, 512)), False),
            # a ragged L of five whole rounds and a sixth, ragged N, reversed,
            # with a decay that varies in time
            "complex_b3_l1301_n40_full_a_rev": (ring((3, 1301, 40)), normal_pair((3, 1301, 40)),
                                                True),
            # Speech Commands S5's shape (path 28): 161 MFCC frames fill 161
            # of a round's 256 steps, P 48 three blocks of 16 channels
            "complex_b32_l161_n48_lambda": (ring((48,)), normal_pair((32, 161, 48)), False),
        }
        # Mamba-1's (B, L, d_inner·N) view (path 18): 32 × 128 blocks, a walk
        # of a quarter round, forward and reversed, and a ragged L; decays
        # spread over (0, 1) as exp(Δ·A) spreads them
        for L_m1 in (64, 61):
            a_m1 = torch.rand((32, L_m1, 2048), device=dev, generator=gen)
            b_m1 = torch.randn(32, L_m1, 2048, device=dev, generator=gen)
            for reverse in (False, True):
                cases[f"real_b32_l{L_m1}_n2048_full_a{'_rev' if reverse else ''}"] = (
                    a_m1, b_m1, reverse)
        for name, (a, b, reverse) in cases.items():
            h = diag_scan_cuda(a, b, reverse=reverse)
            torch.cuda.synchronize()
            err, scale = scan_err(h, diag_scan_plain(a, b, reverse=reverse))
            tol = SCAN_RTOL_OF_MAX * scale
            # no atomics, a fixed fold order: a second launch gives the same bits
            same = all(torch.equal(x, y) for x, y in
                       zip(_planes(h), _planes(diag_scan_cuda(a, b, reverse=reverse))))
            ph.fields[name] = (f"max_abs={err:.3e},rel_to_max={err / scale:.3e},tol={tol:.3e},"
                               f"same_bits_twice={same}")
            if not (err <= tol and same):
                raise AssertionError(f"diag_scan {name}: {ph.fields[name]}")

    # the backward kernel against diag_scan_bwd_plain, and the forward
    # kernel's reverse mode against the plain reverse scan
    with Phase("bwd_kernel_vs_plain") as ph:
        cases = {
            "complex_b64_l512_n128_lambda": (ring((128,)), normal_pair((64, 512, 128))),
            "real_b8_l512_n128_full_a": (ring((8, 512, 128))[0].abs(),
                                         torch.randn(8, 512, 128, device=dev, generator=gen)),
            "complex_b3_l997_n96_lambda": (ring((96,)), normal_pair((3, 997, 96))),
            "complex_b8_l1024_n512_lambda": (ring((512,)), normal_pair((8, 1024, 512))),
            # Speech Commands S5's (path 28): a ragged round, da summed to (48,)
            "complex_b32_l161_n48_lambda": (ring((48,)), normal_pair((32, 161, 48))),
            # Mamba-1's view (path 18): da at a's full shape, no batch sum
            "real_b32_l64_n2048_full_a": (torch.rand((32, 64, 2048), device=dev, generator=gen),
                                          torch.randn(32, 64, 2048, device=dev, generator=gen)),
            "real_b32_l61_n2048_full_a": (torch.rand((32, 61, 2048), device=dev, generator=gen),
                                          torch.randn(32, 61, 2048, device=dev, generator=gen)),
        }
        for name, (a, b) in cases.items():
            for reverse in (False, True):
                tag = f"{name}_{'rev' if reverse else 'fwd'}"
                h = diag_scan_cuda(a, b, reverse=reverse)
                ref = diag_scan_plain(a, b, reverse=reverse)
                torch.cuda.synchronize()
                h_err, h_scale = scan_err(h, ref)
                g = tuple(torch.randn(x.shape, device=dev, generator=gen) for x in _planes(b))
                g = g if isinstance(b, tuple) else g[0]
                da, d = diag_scan_bwd_cuda(a, ref, g, reverse=reverse)
                torch.cuda.synchronize()
                da_ref, d_ref = diag_scan_bwd_plain(a, ref, g, reverse=reverse)
                d_e, d_tol, da_e, da_ratio = bwd_err(a, ref, da, d, da_ref, d_ref, reverse)
                # no atomics: a second launch gives the same bits
                da2, d2 = diag_scan_bwd_cuda(a, ref, g, reverse=reverse)
                same = all(torch.equal(x, y) for x, y in zip(_planes(da) + _planes(d),
                                                             _planes(da2) + _planes(d2)))
                ph.fields[tag] = (f"h_rel={h_err / h_scale:.2e},d_abs={d_e:.2e}/tol={d_tol:.2e},"
                                  f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                                  f"same_bits_twice={same}")
                if not (h_err <= SCAN_RTOL_OF_MAX * h_scale and d_e <= d_tol and da_ratio <= 1.0
                        and same):
                    raise AssertionError(f"diag_scan_bwd {tag}: {ph.fields[tag]}")

    # a decay that varies by example and is constant in time, (B, 1, N):
    # the forward reads it at batch stride N and time stride 0, the backward
    # sums da over time within each row; (B1, 1, 1, N) against (B1, B2, L, N)
    # fits no one batch stride and is read from a broadcast copy.  Both
    # kernels through autograd against diag_scan_plain's autograd, real and
    # complex, forward and reversed, at a ragged L.
    with Phase("scan_per_example_decay_vs_plain") as ph:
        for a_shape, shape in (((3, 1, 40), (3, 601, 40)), ((3, 1, 1, 40), (3, 2, 601, 40))):
            for complex_mode in (False, True):
                for reverse in (False, True):
                    tag = (f"{'complex' if complex_mode else 'real'}_a{'x'.join(map(str, a_shape))}"
                           f"_{'rev' if reverse else 'fwd'}")
                    a = ring(a_shape) if complex_mode else ring(a_shape)[0].abs()
                    b = normal_pair(shape) if complex_mode else torch.randn(
                        shape, device=dev, generator=gen)
                    w = tuple(torch.randn(shape, device=dev, generator=gen) for _ in _planes(b))
                    k = len(_planes(a))

                    def run(leaves, scan):
                        args = ((tuple(leaves[:k]), tuple(leaves[k:])) if complex_mode
                                else (leaves[0], leaves[1]))
                        h = scan(*args, reverse=reverse)
                        sum((x * y).sum() for x, y in zip(_planes(h), w)).backward()
                        return tuple(x.detach() for x in _planes(h))

                    leaves = [x.clone().requires_grad_() for x in _planes(a) + _planes(b)]
                    ref_leaves = [x.clone().requires_grad_() for x in _planes(a) + _planes(b)]
                    before = dict(LAUNCHES)
                    h = run(leaves, diag_linear_scan)
                    torch.cuda.synchronize()
                    if (LAUNCHES["diag_scan"] != before["diag_scan"] + 1
                            or LAUNCHES["diag_scan_bwd"] != before["diag_scan_bwd"] + 1):
                        raise AssertionError(f"scan {tag} did not go through both kernels")
                    ref = run(ref_leaves, diag_scan_plain)
                    h_err, h_scale = scan_err(h, ref)
                    db = tuple(x.grad for x in leaves[k:])
                    db_ref = tuple(x.grad for x in ref_leaves[k:])
                    d_err, d_scale = scan_err(db, db_ref)
                    da = tuple(x.grad for x in leaves[:k])
                    da_ref = tuple(x.grad for x in ref_leaves[:k])
                    _, _, da_e, da_ratio = bwd_err(a, ref, da, db, da_ref, db_ref, reverse)
                    ok_shape = all(x.shape == a_shape for x in da)
                    ph.fields[tag] = (f"h_rel={h_err / h_scale:.2e},db_rel={d_err / d_scale:.2e},"
                                      f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                                      f"da_shape_ok={ok_shape}")
                    if not (h_err <= SCAN_RTOL_OF_MAX * h_scale
                            and d_err <= SCAN_RTOL_OF_MAX * d_scale and da_ratio <= 1.0
                            and ok_shape):
                        raise AssertionError(f"scan per-example decay {tag}: {ph.fields[tag]}")

    # the fused head's three kernels against the plain version, at the LM's
    # (B·L, D, V) and two small shapes; times at the LM's shape
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB, over the 50 MB L2
    with Phase("fused_xent_vs_plain") as ph:
        xent_errs = {}
        for name, (M, D, V) in XENT_SHAPES.items():
            h, weight, b, labels = xent_inputs(dev, gen, M, D, V)
            fields, errs, (lse, gscale) = check_fused_xent(
                fx, h, weight.t(), b, labels, f64=(M, D, V) == XENT_SHAPES["m8192_d512_v50257"])
            ph.fields[name] = repr(fields)
            if not xent_errs:  # the LM's shape comes first
                xent_errs, xent_io = errs, (h, weight, b, labels, lse, gscale)
    with Phase("fused_xent_timing") as ph:
        h, weight, b, labels, lse, gscale = xent_io
        xent_times = time_fused_xent(fx, h, weight.t(), b, labels, lse, gscale, flush)
        for name, (k_ms, w_ms, p_ms, l_ms, bound, by, n_bytes, flops,
                   f32) in xent_times.items():
            ph.fields[name] = (f"ms_cold_median={k_ms:.4f},ms_warm_median={w_ms:.4f},"
                               f"plain_ms={p_ms:.4f},"
                               f"library_ms={l_ms:.4f},over_library={k_ms / l_ms:.3f},"
                               f"bound_ms={bound:.4f}({by}),over_bound={k_ms / bound:.3f},"
                               f"bound_f32_ms={f32:.4f},"
                               f"gflop={flops / 1e9:.1f},tflops={flops / k_ms / 1e9:.2f}")
        del h, weight, b, labels, lse, gscale, xent_io
        torch.cuda.empty_cache()

    # the fused head's bfloat16 kernels against the plain bfloat16 version, at
    # the LM's shape (path 11's) and two small ones; times at the LM's shape
    with Phase("fused_xent_bf16_vs_plain") as ph:
        xent_bf16_errs = {}
        for name, (M, D, V) in XENT_BF16_SHAPES.items():
            h, weight, b, labels = xent_inputs(dev, gen, M, D, V, dtype=torch.bfloat16)
            fields, errs, (lse, gscale) = check_fused_xent(fx, h, weight.t(), b, labels,
                                                           f64=False)
            ph.fields[name] = repr(fields)
            for k, v in errs.items():
                xent_bf16_errs[k] = max(xent_bf16_errs.get(k, 0.0), v)
            if name == "m8192_d512_v50257":
                xent_io = (h, weight, b, labels, lse, gscale)
            del h, weight, b, labels, lse, gscale
    with Phase("fused_xent_bf16_timing") as ph:
        h, weight, b, labels, lse, gscale = xent_io
        xent_bf16_times = time_fused_xent(fx, h, weight.t(), b, labels, lse, gscale, flush)
        for name, t in xent_bf16_times.items():
            ph.fields[name] = timing_fields(t, "library_ms", "over_library")
        del h, weight, b, labels, lse, gscale, xent_io
        torch.cuda.empty_cache()

    # the decay attention's three kernels against the plain version, at the
    # MQAR Mamba-2 shape, the WikiText Mamba-2 shape, a ragged one and the
    # CIFAR Mamba-2's two (with float64 for the record at the last three);
    # the MQAR shape's inputs are kept for the timing
    with Phase("decay_attention_vs_plain") as ph:
        decay_errs = {}
        for name, (BG, Q, N, Hg, P) in SSD_SHAPES.items():
            ins = decay_inputs(dev, gen, BG, Q, N, Hg, P)
            fields, errs = check_decay_attention(dattn, *ins, f64=name in SSD_F64_SHAPES)
            ph.fields[name] = repr(fields)
            if not decay_errs:  # the MQAR shape comes first
                decay_errs, decay_io = errs, ins
            del ins
        torch.cuda.empty_cache()

    # the decay attention's bfloat16 kernels against the plain bfloat16
    # version, at the WikiText Mamba-2 shape (path 9's), the MQAR shape and a
    # ragged one
    with Phase("decay_attention_bf16_vs_plain") as ph:
        decay_bf16_errs = {}
        for name, (BG, Q, N, Hg, P) in SSD_BF16_SHAPES.items():
            ins = decay_inputs(dev, gen, BG, Q, N, Hg, P, dtype=torch.bfloat16)
            fields, errs = check_decay_attention(dattn, *ins, f64=False)
            ph.fields[name] = repr(fields)
            for k, v in errs.items():
                decay_bf16_errs[k] = max(decay_bf16_errs.get(k, 0.0), v)
            del ins
        torch.cuda.empty_cache()

    # the full-width model, its data and its weights
    cfg = MQAR_LRU_FULL
    mcfg = cfg["model"]
    _, model, _ = build_models(mcfg, generator=torch.Generator().manual_seed(cfg["seed"]),
                               device=dev)
    data = MQAR(**cfg["dataset"])
    test_x, test_y = data.split("test")
    bsz, L = cfg["train"]["batch_size"], mcfg["seq_len"]
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mcfg["input_dim"],
                                lang_model=True, device=dev)
    n_layers = mcfg["num_layers"]
    n_new, n_check = 16, 8

    # main path 1, evaluation, eigen-analysis and serving: every count set
    # to 0 here, read after serving
    for k in LAUNCHES:
        LAUNCHES[k] = 0

    # 4. forward evaluation
    with Phase("forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != n_layers:
            raise AssertionError(f"forward launched diag_scan {LAUNCHES['diag_scan']} times, "
                                 f"expected {n_layers}")
        if logits.shape != (bsz, L, mcfg["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"forward output {tuple(logits.shape)} not finite/expected")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top_ops = top_device_ops(lambda: model(inputs))
        # the same weights on the CPU (plain scan) for two examples
        _, cpu_model, _ = build_models(mcfg, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         diag_scan_launches_per_forward=n_layers,
                         vs_cpu_max_abs=f"{cpu_err:.3e}",
                         top_device_ops_ms=repr(short(top_ops)))

    # 5. eigen-analysis into a temporary directory
    tmp = tempfile.mkdtemp(prefix="tlie_eig_")
    try:
        with Phase("eval_eig") as ph:
            eig, eig_init, perc, perc_init, ph_perc, ph_init = eval_eig(
                cfg, {"save_path": tmp}, acc, model, device=dev)
            if eig.shape != (mcfg["state_dim"], n_layers) or eig_init.shape != eig.shape:
                raise AssertionError(f"eig shape {eig.shape}")
            r = np.abs(eig_init)
            phase = np.mod(np.angle(eig_init), 2 * np.pi)
            if not (np.all(r >= mcfg["r_min"] - 1e-6) and np.all(r <= mcfg["r_max"] + 1e-6)
                    and np.all(phase <= 6.28 + 1e-5)):
                raise AssertionError("init spectra off the [r_min, r_max] ring / phase range")
            (out_dir,) = [os.path.join(tmp, d) for d in os.listdir(tmp)]
            files = sorted(os.listdir(out_dir))
            want_files = sorted([f"{k}.npy" for k in (
                "eig", "eig_init", "percentage", "percentage_init", "percentage_phase",
                "percentage_phase_init", "percentage_mean", "percentage_init_mean",
                "percentage_std", "percentage_init_std")] + ["percentage_file.txt"]
                + (["used_config.yaml"] if has_yaml else []))
            if files != want_files:
                raise AssertionError(f"artifact files {files} != {want_files}")
            ph.fields.update(eig_shape=eig.shape, n_files=len(files),
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. serving
    with Phase("serving") as ph:
        dec = Decoder(mcfg, model)
        prompts = inputs[:, : L - n_new]
        before = LAUNCHES["diag_scan"]
        _, last = dec.prefill(prompts)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] - before != n_layers:
            raise AssertionError("prefill did not go through diag_scan once per layer")
        with torch.no_grad():
            full_prompt = model(prompts)[:, -1]
        if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"prefill vs forward: {(last - full_prompt).abs().max().item()}")
        dec.generate(prompts, n_new)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.generate(prompts, n_new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if out.shape != (bsz, L) or not torch.equal(out[:, : L - n_new], prompts):
            raise AssertionError(f"generate output {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= mcfg["output_dim"]:
            raise AssertionError("generated ids out of the vocab")
        sw = dec.stepwise_logits(inputs[:n_check])
        step_err = (sw[:, -8:] - logits[:n_check, -8:]).abs().max().item()
        if not torch.allclose(sw[:, -8:], logits[:n_check, -8:], rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"stepwise vs forward, last 8 positions: {step_err}")
        ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                         tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                         prefill_vs_forward_max_abs=f"{(last - full_prompt).abs().max().item():.3e}",
                         stepwise_vs_forward_max_abs=f"{step_err:.3e}")

    path1 = dict(LAUNCHES)
    if path1["diag_scan"] == 0:
        raise AssertionError("diag_scan was not launched on the evaluation path")
    print(f"[launches] evaluation, eval_eig, serving: {path1}", flush=True)

    # 7. gradients through the kernels against autograd through the plain
    # loop, for every LRU parameter, at the path's inputs
    seq = model.encoder.layers[0].seq
    with torch.no_grad():
        u = model.encoder.encoder(inputs)
    with Phase("autograd_vs_plain") as ph:
        w = torch.randn(u.shape, device=dev, generator=gen)

        def lru_grads(scan_fn):
            seq.zero_grad(set_to_none=True)
            bn_re, bn_im = seq.input_matrix()
            h = scan_fn(seq.lam(), (u @ bn_re.T, u @ bn_im.T))
            (seq.readout(h, u) * w).sum().backward()
            return {n: None if p.grad is None else p.grad.clone()
                    for n, p in seq.named_parameters()}

        before = dict(LAUNCHES)
        kernel_g = lru_grads(diag_linear_scan)
        if (LAUNCHES["diag_scan"] - before["diag_scan"] != 1
                or LAUNCHES["diag_scan_bwd"] - before["diag_scan_bwd"] != 1):
            raise AssertionError("the LRU's gradient did not go through both kernels")
        plain_g = lru_grads(diag_scan_plain)
        worst = grad_err(kernel_g, plain_g)
        seq.zero_grad(set_to_none=True)
        ph.fields.update(params=sorted(plain_g), worst_rel_to_leaf_max=f"{worst:.3e}",
                         tol=GRAD_RTOL_OF_MAX)
        if not worst <= GRAD_RTOL_OF_MAX:
            raise AssertionError(f"kernel vs plain gradients: {worst}")

    # main path 2, training, checkpoint, eval_eig and serving of the trained
    # weights: every count set to 0 before training, read after training and
    # again after the checkpoint phase
    tcfg = copy.deepcopy(cfg)
    tmp = tempfile.mkdtemp(prefix="tlie_train_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-lru")
    tcfg["train"].update(total_steps=TRAIN_STEPS, eval_every=EVAL_EVERY)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    try:
        with Phase("train_data") as ph:
            train_data = MQAR(**tcfg["dataset"])
            train_split = train_data.split("train")
            test_split = (test_x, test_y)
            tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
            ph.fields.update(generator=train_data.generator,
                             train_examples=f"{len(train_split[0])}(cut_from_100000)",
                             test_examples=len(test_split[0]))
            # the reference draws with the native generator wherever c++
            # builds it, and the card machine has the compiler nvcc needs
            if train_data.generator != "native" or data.generator != "native":
                raise AssertionError(f"MQAR drew with {train_data.generator}, not the native "
                                     "generator the reference uses")
        init = {k: v.clone() for k, v in build_models(
            mcfg, generator=torch.Generator().manual_seed(cfg["seed"]),
            device=dev)[0].state_dict().items()}

        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("train") as ph:
            t0 = time.perf_counter()
            result = train(tcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            path2 = dict(LAUNCHES)
            n_eval_batches = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)  # the MQAR LRU trains through the sparse head
            want.update(diag_scan=n_layers * (TRAIN_STEPS + n_eval_batches),
                        diag_scan_bwd=n_layers * TRAIN_STEPS)
            if path2 != want:
                raise AssertionError(f"training launches {path2}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite training numbers {rec}")
            trained = result.model.state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"parameters that did not move: {frozen}")
            ph.fields.update(steps=TRAIN_STEPS, seconds=f"{train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(path2))

        # 8. the checkpoint, reloaded and eigen-analysed; serving from it
        with Phase("checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            if set(ckpt["config"]) != {"model", "train", "data"}:
                raise AssertionError(f"checkpoint config keys {sorted(ckpt['config'])}")
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"checkpoint entry {k} differs from the live weights")
            eig_dir = os.path.join(tmp, "analysis")
            eig, _, perc, _, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf, ckpt_path,
                                             device=dev)
            live = extract_ssm_family(
                ssm_layer_params({k: v.cpu() for k, v in trained.items()}), mcfg)
            (run_dir,) = os.listdir(eig_dir)
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            if not (np.array_equal(eig, live) and np.array_equal(saved, live)):
                raise AssertionError("trained spectra from the checkpoint differ from eig_lru "
                                     "of the live weights")
            dec = Decoder(mcfg, result.eval_model)
            prompts = inputs[:, : L - n_new]
            out = dec.generate(prompts, n_new)
            _, last = dec.prefill(prompts)
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            torch.cuda.synchronize()
            if out.shape != (bsz, L) or int(out.min()) < 0 or int(out.max()) >= mcfg["output_dim"]:
                raise AssertionError("generation from the trained weights failed")
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError("trained prefill vs forward")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist())
        path2_all = dict(LAUNCHES)
        print(f"[launches] training: {path2}; with checkpoint, eval_eig, serving: {path2_all}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 9. one step from the same weights and batch at dropout 0, on the card
    # (kernels) and on the CPU (plain versions)
    step_cfg = dict(mcfg, dropout=0.0)
    tf = tcfg["train"]
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()
    sparse_k = sparse_head_k_for(mcfg, train_split[1], test_split[1])
    lrs = {"regular": tf["lr"], "ssm": tf["ssm_lr"]}

    def fresh(device):
        m, _, _ = build_models(step_cfg, generator=torch.Generator().manual_seed(cfg["seed"]),
                               device=device)
        opt = make_optimizer(m, mcfg["ssm_lr_vars"], tf["lr"], tf["ssm_lr"], tf["wd"],
                             (0.9, 0.999))
        return m, opt

    with Phase("train_step_card_vs_cpu") as ph:
        card_m, card_opt = fresh(dev)
        cpu_m, cpu_opt = fresh("cpu")
        train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k)
        train_step(cpu_m, cpu_opt, x_step.cpu(), y_step.cpu(), lrs, sparse_k)
        cpu_g = {n: p.grad for n, p in cpu_m.named_parameters()}
        card_g = {n: p.grad.cpu() for n, p in card_m.named_parameters()}
        # the same gradients in float64 on the CPU
        ref_m = fresh("cpu")[0].double()
        cross_entropy_loss(*head_logits(ref_m, x_step.cpu(), y_step.cpu(), sparse_k)).backward()
        g_ratio, g_leaf = 0.0, ""
        for n, p in ref_m.named_parameters():
            g64 = p.grad
            e_card = (card_g[n].double() - g64).abs().max().item()
            e_cpu = (cpu_g[n].double() - g64).abs().max().item()
            allowed = max(GRAD_F64_FACTOR * e_cpu, 1e-5 * g64.abs().max().item())
            if e_card / allowed > g_ratio:
                g_ratio, g_leaf = e_card / allowed, n
        g_worst = grad_err(card_g, cpu_g)
        p_worst = p_anywhere = 0.0
        for (n, p), q in zip(card_m.named_parameters(), cpu_m.parameters()):
            err = (p.detach().cpu() - q.detach()).abs()
            g = cpu_g[n].abs()
            det = g >= 1e-2 * g.max()
            p_worst = max(p_worst, err[det].max().item() if bool(det.any()) else 0.0)
            p_anywhere = max(p_anywhere, err.max().item())
        s_worst = max(((b.cpu() - c).abs() / c.abs().clamp_min(1.0)).max().item()
                      for b, c in zip(card_m.buffers(), cpu_m.buffers()))
        ph.fields.update(grad_err_over_allowed=f"{g_ratio:.3f}({g_leaf})",
                         grad_card_vs_cpu_worst_rel_to_leaf_max=f"{g_worst:.3e}",
                         param_worst_where_grad_determined=f"{p_worst:.3e}",
                         param_worst_anywhere=f"{p_anywhere:.3e}",
                         batch_stats_worst_rel=f"{s_worst:.3e}")
        if not (g_ratio <= 1.0 and p_worst <= PARAM_ATOL
                and p_anywhere <= 2 * tf["lr"] + PARAM_ATOL and s_worst <= STATS_RTOL):
            raise AssertionError(f"card vs CPU step: {ph.fields}")

    # 10. a training step's time and where it goes (dropout 0, the path's batch)
    with Phase("train_step_timing") as ph:
        def one_step():
            train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k)

        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        n_timed = 20
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_timed):
            one_step()
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / n_timed
        t0 = time.perf_counter()
        for _ in range(n_timed):
            one_step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n_timed * 1e3
        ops = top_device_ops(one_step, k=1000)
        busy = sum(t for _, t in ops)
        bwd_ms = sum(t for name, t in ops if "diag_scan_bwd" in name or "sum_rows" in name)
        by_kind = {}
        for name, t in ops:
            op_kind = next((k for k, pats in OP_KINDS if any(p in name for p in pats)), "other")
            by_kind[op_kind] = round(by_kind.get(op_kind, 0.0) + t, 4)
        ph.fields.update(ms_per_step=f"{step_ms:.3f}", wall_ms_per_synced_step=f"{wall_ms:.3f}",
                         train_tokens_per_s=f"{bsz * L / step_ms * 1e3:.0f}")
        if busy > 0:
            ph.fields.update(device_busy_ms=f"{busy:.4f}",
                             idle_share=f"{max(0.0, 1 - busy / step_ms):.3f}",
                             bwd_kernel_ms=f"{bwd_ms:.4f}",
                             bwd_kernel_share_of_device=f"{bwd_ms / busy:.4f}",
                             device_ms_by_kind=repr(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                             top_device_ops_ms=repr(short(ops[:12])))
        else:  # the profiler saw no device time: the CUDA-event time stands alone
            ph.fields.update(device_busy_ms="not measured")

    # 11. the kernels at the path's shape: time, bound, plain version; and
    # at the LM's shape (8, 1024, 512, complex, (N,) a), for the record
    lm_a, lm_b = ring((512,)), normal_pair((8, 1024, 512))
    with Phase("kernel_timing") as ph, torch.no_grad():
        lam, (bn_re, bn_im) = seq.lam(), seq.input_matrix()
        a = lam  # the (N,) pair the LRU passes
        b = (u @ bn_re.T, u @ bn_im.T)
        h = diag_scan_plain(a, b)
        err, scale = scan_err(diag_scan_cuda(a, b), h)
        if not err <= SCAN_RTOL_OF_MAX * scale:
            raise AssertionError(f"diag_scan at the path's inputs: {err}")
        scan_times = {}
        # the reverse mode at the path's inputs, beside the forward in this run
        for tag, (ta, tb), rev in (("", (a, b), False), ("_rev", (a, b), True),
                                   ("_lm_b8_l1024_n512", (lm_a, lm_b), False)):
            # each input read once (a, b), h written once; a complex
            # multiply-add (4 mul + 4 add) per element
            n_bytes = sum(distinct_bytes(t) for t in ta + tb) + sum(distinct_bytes(t) for t in tb)
            t = time_scan_kernel(lambda: diag_scan_cuda(ta, tb, reverse=rev),
                                 lambda: diag_scan_plain(ta, tb, reverse=rev),
                                 n_bytes, 8 * tb[0].numel(), flush)
            scan_times[tag] = t
            ph.fields["ms" + tag] = scan_timing_fields(t, n_bytes)
        ph.fields["max_abs_err"] = f"{err:.3e}"

    with Phase("bwd_kernel_timing") as ph, torch.no_grad():
        g = normal_pair(h[0].shape)
        da, d = diag_scan_bwd_cuda(a, h, g)
        da_ref, d_ref = diag_scan_bwd_plain(a, h, g)
        d_e, d_tol, da_e, da_ratio = bwd_err(a, h, da, d, da_ref, d_ref, False)
        if not (d_e <= d_tol and da_ratio <= 1.0):
            raise AssertionError(f"diag_scan_bwd at the path's inputs: d {d_e}, da {da_ratio}")
        bwd_times = {}
        lm_h = diag_scan_cuda(lm_a, lm_b)
        lm_g = normal_pair(lm_b[0].shape)
        for tag, (ta, th, tg) in (("", (a, h, g)), ("_lm_b8_l1024_n512", (lm_a, lm_h, lm_g))):
            tda, td = diag_scan_bwd_cuda(ta, th, tg)
            # each input read once (a, h, g), each output written once (da,
            # d); two complex multiply-adds per element
            n_bytes = sum(distinct_bytes(t) for t in ta + th + tg + tda + td)
            t = time_scan_kernel(lambda: diag_scan_bwd_cuda(ta, th, tg),
                                 lambda: diag_scan_bwd_plain(ta, th, tg), n_bytes,
                                 16 * tg[0].numel(), flush)
            bwd_times[tag] = t
            ph.fields["ms" + tag] = scan_timing_fields(t, n_bytes)
        ph.fields.update(d_max_abs_err=f"{d_e:.3e}", da_max_abs_err=f"{da_e:.3e}")
        del lm_a, lm_b, lm_h, lm_g

    # main path 3, the WikiText LM trained through the fused head, then its
    # checkpoint eigen-analysed and served: every count set to 0 before
    # training, read after training and again after serving
    lm_cfg = copy.deepcopy(WIKITEXT_LRU_SHORT)
    lm_m = lm_cfg["model"]
    lm_bsz, lm_L, lm_layers = lm_cfg["train"]["batch_size"], lm_m["seq_len"], lm_m["num_layers"]
    lm_tmp = tempfile.mkdtemp(prefix="tlie_lm_")
    lm_cfg["save"] = os.path.join(lm_tmp, "checkpoint", "wikitext-lru-short")
    lm_cfg["train"].update(total_steps=LM_STEPS, eval_every=LM_STEPS, fused_xent=True)
    try:
        with Phase("lm_data") as ph:
            lm_data = WikiText(**lm_cfg["dataset"])
            lm_train, lm_test = lm_data.split("train"), lm_data.split("test")
            lm_cfg = derive_runtime_fields(lm_cfg, lm_data.l_max, len(lm_train[0]))
            if lm_cfg["train"]["train_size"] != WIKITEXT_LRU_SHORT["train"]["train_size"]:
                raise AssertionError("the synthetic stream is not the config's")
            ph.fields.update(train_blocks=len(lm_train[0]), test_blocks=len(lm_test[0]),
                             block=lm_L, vocab=lm_data.d_output)

        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("lm_train") as ph:
            t0 = time.perf_counter()
            lm_result = train(lm_cfg, lm_train, lm_test, device=dev)
            torch.cuda.synchronize()
            lm_train_s = time.perf_counter() - t0
            path3 = dict(LAUNCHES)
            n_eval_batches = len(lm_result.history) * (len(lm_test[0]) // lm_bsz)
            # the fused kernels once per step each and never in the eval
            # (dense head); the scans once per layer per step and eval batch
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(diag_scan=lm_layers * (LM_STEPS + n_eval_batches),
                        diag_scan_bwd=lm_layers * LM_STEPS, fused_xent_fwd=LM_STEPS,
                        fused_xent_dh=LM_STEPS, fused_xent_dw=LM_STEPS)
            if path3 != want:
                raise AssertionError(f"LM training launches {path3}, expected {want}")
            for rec in lm_result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"LM training numbers {rec}")
            ph.fields.update(steps=LM_STEPS, seconds=f"{lm_train_s:.2f}",
                             eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in lm_result.history]),
                             launches=repr(path3))

        with Phase("lm_checkpoint_eval_eig_serving") as ph:
            ckpt_path, perf = lm_result
            eig_dir = os.path.join(lm_tmp, "analysis")
            eig, eig_init, perc, _, _, _ = eval_eig(lm_cfg, {"save_path": eig_dir}, perf,
                                                    ckpt_path, device=dev)
            live = extract_ssm_family(ssm_layer_params(
                {k: v.cpu() for k, v in lm_result.model.state_dict().items()}), lm_m)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            if eig.shape != (lm_m["state_dim"], lm_layers) or not np.array_equal(eig, live):
                raise AssertionError("LM spectra from the checkpoint differ from the live weights")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"LM artifacts {run_dir}: {files}")
            dec = Decoder(lm_m, lm_result.eval_model)
            prompts = torch.as_tensor(lm_test[0][:8, : lm_L - n_new], device=dev)
            out = dec.generate(prompts, n_new)
            _, last = dec.prefill(prompts)
            with torch.no_grad():
                full_prompt = lm_result.eval_model(prompts)[:, -1]
            torch.cuda.synchronize()
            if out.shape != (8, lm_L) or int(out.min()) < 0 or int(out.max()) >= lm_m["output_dim"]:
                raise AssertionError("generation from the trained LM failed")
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(
                    f"LM prefill vs forward: {(last - full_prompt).abs().max().item()}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perplexity=f"{perf:.2f}",
                             artifacts=run_dir, n_files=len(files),
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist(),
                             prefill_vs_forward_max_abs=f"{(last - full_prompt).abs().max().item():.3e}")
        path3_all = dict(LAUNCHES)
        print(f"[launches] LM training: {path3}; with eval_eig, serving: {path3_all}", flush=True)
    finally:
        shutil.rmtree(lm_tmp, ignore_errors=True)

    # 12. one fused-head LM step against one dense-head step, on the card,
    # from the same weights (dropout 0) and batch
    # on LM_STEP_BLOCKS of the batch's blocks (the CPU's float64 step is the
    # slow part)
    with Phase("lm_fused_vs_dense_step") as ph:
        lm_x = torch.as_tensor(lm_train[0][:LM_STEP_BLOCKS], device=dev)
        lm_y = torch.as_tensor(lm_train[1][:LM_STEP_BLOCKS], device=dev)
        lt = lm_cfg["train"]
        lm_lrs = {"regular": lt["lr"], "ssm": lt["ssm_lr"]}

        def lm_step(fused):
            m, _, _ = build_models(lm_m, generator=torch.Generator().manual_seed(lm_cfg["seed"]),
                                   device=dev)
            opt = make_optimizer(m, lm_m["ssm_lr_vars"], lt["lr"], lt["ssm_lr"], lt["wd"],
                                 tuple(lt["betas"]))
            feats = []  # the backbone's features, then their gradient

            def keep(mod, inp, out):
                feats.append(out.detach())
                out.register_hook(feats.append)

            hook = m.encoder.register_forward_hook(keep)
            loss = train_step(m, opt, lm_x, lm_y, lm_lrs, fused_head=fused)
            hook.remove()
            grads = {n: p.grad for n, p in m.named_parameters()}
            return float(loss), feats[0], feats[1], grads, [b.clone() for b in m.buffers()]

        f_loss, feats, f_df, f_g, f_stats = lm_step(True)
        d_loss, _, d_df, d_g, d_stats = lm_step(False)
        # the same weights on the CPU: their decoder gives the head's term
        # sums, and the dense step in float64 is the reference
        ref_m, _, _ = build_models(lm_m, generator=torch.Generator().manual_seed(lm_cfg["seed"]),
                                   device="cpu")
        rows = feats.reshape(-1, feats.shape[-1])
        w_lm = ref_m.decoder.weight.detach().to(dev).t()
        b_lm = ref_m.decoder.bias.detach().to(dev)
        labels = lm_y.reshape(-1)
        _, lse = fx.fused_xent_fwd_plain(rows, w_lm, b_lm, labels)
        gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=dev)
        s_dh, s_dw, s_db = fx.grad_term_scales(rows, w_lm, b_lm, labels, lse, gscale)
        rtol = xent_grad_rtol(rows, w_lm, b_lm)
        head = {"features": ((f_df - d_df).reshape(-1, rows.shape[1]).abs(), s_dh),
                "decoder.weight": ((f_g["decoder.weight"] - d_g["decoder.weight"]).abs(), s_dw.t()),
                "decoder.bias": ((f_g["decoder.bias"] - d_g["decoder.bias"]).abs(), s_db)}
        head_ratio = max((err / (rtol * sc + 1e-30)).max().item() for err, sc in head.values())
        del rows, w_lm, b_lm, lse, s_dh, s_dw, s_db, head
        t0 = time.perf_counter()
        ref_m = ref_m.double()
        ref_loss = cross_entropy_loss(ref_m(lm_x.cpu()), lm_y.cpu())
        ref_loss.backward()
        f64_s = time.perf_counter() - t0
        g_ratio, g_leaf = 0.0, ""
        for n, p in ref_m.named_parameters():
            g64 = p.grad
            e_fused = (f_g[n].cpu().double() - g64).abs().max().item()
            e_dense = (d_g[n].cpu().double() - g64).abs().max().item()
            allowed = max(GRAD_F64_FACTOR * e_dense, 1e-5 * g64.abs().max().item())
            if e_fused / allowed > g_ratio:
                g_ratio, g_leaf = e_fused / allowed, n
        loss64_rel = abs(f_loss - ref_loss.item()) / abs(ref_loss.item())
        del ref_m, ref_loss
        s_worst = max(((a - c).abs() / c.abs().clamp_min(1.0)).max().item()
                      for a, c in zip(f_stats, d_stats))
        loss_rel = abs(f_loss - d_loss) / abs(d_loss)
        ph.fields.update(loss_fused=f"{f_loss:.6f}", loss_dense=f"{d_loss:.6f}",
                         loss_rel=f"{loss_rel:.2e}",
                         head_grads_err_over_tol=f"{head_ratio:.3f}(rtol_of_term_sums={rtol:.2e})",
                         loss_vs_f64_rel=f"{loss64_rel:.2e}", f64_cpu_step_s=f"{f64_s:.1f}",
                         grads_vs_f64_err_over_allowed=f"{g_ratio:.3f}({g_leaf})",
                         batch_stats_worst_rel=f"{s_worst:.2e}")
        if not (loss_rel <= XENT_RTOL and loss64_rel <= XENT_RTOL and head_ratio <= 1.0
                and g_ratio <= 1.0 and s_worst <= STATS_RTOL):
            raise AssertionError(f"fused vs dense LM step: {ph.fields}")
        del f_g, d_g, feats, f_df, d_df
        torch.cuda.empty_cache()

    # 13. an LM training step's time and the fused head's share of it
    lm_x = torch.as_tensor(lm_train[0][:lm_bsz], device=dev)
    lm_y = torch.as_tensor(lm_train[1][:lm_bsz], device=dev)
    with Phase("lm_train_step_timing") as ph:
        lm_opt = make_optimizer(lm_result.model, lm_m["ssm_lr_vars"], lt["lr"], lt["ssm_lr"],
                                lt["wd"], tuple(lt["betas"]))
        lm_step_fields = step_profile(
            lambda: train_step(lm_result.model, lm_opt, lm_x, lm_y, lm_lrs, fused_head=True),
            lm_bsz * lm_L, "xent", "fused_head", n_warm=2, n_timed=5)
        ph.fields.update(lm_step_fields)
    del lm_opt, lm_result, lm_x, lm_y
    torch.cuda.empty_cache()

    # main path 4, the MQAR Mamba-2: its forward on the test batch, then 200
    # training steps, the checkpoint reloaded and eigen-analysed; every count
    # set to 0 before the forward, read after training and again after the
    # eigen-analysis
    mam = MQAR_MAMBA2_FULL
    mm = mam["model"]
    m_layers = mm["num_layers"]
    _, mamba, _ = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]), device=dev)
    # the same dataset as the LRU's (L 512, 64 pairs): the same test split
    m_inputs, m_labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mm["input_dim"],
                                    lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("mamba_forward") as ph, torch.no_grad():
        m_logits = mamba(m_inputs)
        torch.cuda.synchronize()
        if LAUNCHES["decay_attention_fwd"] != m_layers:
            raise AssertionError(f"the Mamba-2 forward launched decay_attention_fwd "
                                 f"{LAUNCHES['decay_attention_fwd']} times, expected {m_layers}")
        if m_logits.shape != (bsz, L, mm["output_dim"]) or not torch.isfinite(m_logits).all():
            raise AssertionError(f"Mamba-2 forward output {tuple(m_logits.shape)}")
        m_acc = float(masked_accuracy(m_logits, m_labels))
        m_fwd_ms = min(cuda_ms(lambda: mamba(m_inputs), 3))
        m_top = top_device_ops(lambda: mamba(m_inputs))
        _, cpu_mamba, _ = build_models(mm, generator=torch.Generator(), device="cpu")
        cpu_mamba.load_state_dict({k: v.cpu() for k, v in mamba.state_dict().items()})
        ref = cpu_mamba(m_inputs[:2].cpu())
        m_cpu_err = (m_logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(m_logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"Mamba-2 card vs CPU forward: max abs err {m_cpu_err}")
        ph.fields.update(chunk=_auto_chunk(bsz, L, mm["num_heads"], dev),
                         chunk_on_cpu=_auto_chunk(bsz, L, mm["num_heads"], "cpu"),
                         masked_acc=f"{m_acc:.6f}", forward_ms=f"{m_fwd_ms:.3f}",
                         decay_attention_fwd_launches_per_forward=m_layers,
                         vs_cpu_max_abs=f"{m_cpu_err:.3e}", top_device_ops_ms=repr(short(m_top)))
        del cpu_mamba, ref

    mcfg4 = copy.deepcopy(mam)
    m_tmp = tempfile.mkdtemp(prefix="tlie_mamba_")
    mcfg4["save"] = os.path.join(m_tmp, "checkpoint", "mqar-mamba2")
    mcfg4["train"].update(total_steps=MAMBA_STEPS, eval_every=MAMBA_EVAL_EVERY)
    mcfg4["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    mcfg4 = derive_runtime_fields(mcfg4, L, len(train_split[0]))
    try:
        with Phase("mamba_train") as ph:
            fwd_before = LAUNCHES["decay_attention_fwd"]
            t0 = time.perf_counter()
            m_result = train(mcfg4, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            m_train_s = time.perf_counter() - t0
            path4 = dict(LAUNCHES)
            n_eval_batches = len(m_result.history) * (len(test_split[0]) // bsz)
            # one forward launch per layer per step and eval batch, one of each
            # backward per layer per step; no other kernel
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(decay_attention_fwd=fwd_before + m_layers * (MAMBA_STEPS + n_eval_batches),
                        decay_attention_bwd_i=m_layers * MAMBA_STEPS,
                        decay_attention_bwd_j=m_layers * MAMBA_STEPS)
            if path4 != want:
                raise AssertionError(f"Mamba-2 training launches {path4}, expected {want}")
            for rec in m_result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite Mamba-2 training numbers {rec}")
            m_trained = m_result.model.state_dict()
            m_init = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]),
                                  device=dev)[0].state_dict()
            frozen = [k for k, v in m_trained.items() if torch.equal(v, m_init[k])]
            if frozen:
                raise AssertionError(f"Mamba-2 parameters that did not move: {frozen}")
            ph.fields.update(steps=MAMBA_STEPS, seconds=f"{m_train_s:.2f}",
                             eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in m_result.history]),
                             launches=repr(path4))

        with Phase("mamba_checkpoint_eval_eig") as ph:
            ckpt_path, perf = m_result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in m_trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"Mamba-2 checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(m_tmp, "analysis")
            batch = test_x[:bsz]  # the analysis config's batch_size: the first 64 test examples
            eig, eig_init, perc, perc_init, _, _ = eval_eig(mcfg4, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            live = extract_attention_family(m_result.eval_model, m_inputs, mm)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L, mm["num_heads"], m_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"Mamba-2 spectra {eig.shape}, {eig_init.shape}")
            if not (np.array_equal(saved, eig) and np.abs(eig - live).max() <= 1e-6):
                raise AssertionError("Mamba-2 spectra from the checkpoint differ from the live "
                                     "model's")
            if not (np.all((eig_init > 0) & (eig_init <= 1)) and np.all((eig > 0) & (eig <= 1))):
                raise AssertionError("Mamba-2 eigenvalues outside (0, 1]")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{mm['hidden_dim']}"):
                raise AssertionError(f"Mamba-2 artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_abs=f"{np.abs(eig - live).max():.3e}",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
        # serving from the checkpoint, then the untrained pseudo-LTI variant
        m_dec = mqar_mamba_serving(dev, ckpt_path, m_result.eval_model, m_inputs, m_layers,
                                   mm["output_dim"])
        lti_dec, _ = mamba_lti_serving(dev, mm, m_inputs, m_layers)
        path4_all = dict(LAUNCHES)
        print(f"[launches] Mamba-2 forward and training: {path4}; with eval_eig and serving: "
              f"{path4_all}", flush=True)
    finally:
        shutil.rmtree(m_tmp, ignore_errors=True)

    # the decay attention's forward kernel at the serving prefills' own
    # operands: (192, 128, 128, 1, 128) after TF_PROMPT tokens, (1984, 16,
    # 128, 1, 128) after MAMBA_PROMPT_Q16, and the pseudo-LTI variant's
    with Phase("decay_attention_fwd_prefill_timing") as ph:
        for n in (TF_PROMPT, MAMBA_PROMPT_Q16):
            decay_fwd_at_prefill(ph, dattn, m_dec, m_inputs[:, :n], flush, f"prefill_{n}")
        decay_fwd_at_prefill(ph, dattn, lti_dec, m_inputs[:, :TF_PROMPT], flush,
                             f"lti_prefill_{TF_PROMPT}")
        del m_dec, lti_dec

    # one Mamba-2 step (sparse head, AdamW behind the global-norm clip) from
    # the same weights and batch, on the card (kernels) and on the CPU (plain
    # versions), both held to the same step in float64 on the CPU
    m_f = train_fields(mcfg4)
    m_sparse_k = sparse_head_k_for(mm, train_split[1], test_split[1])
    m_lrs = {"regular": m_f["lr"]}

    def m_fresh(device):
        m, _, family = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mm, mcfg4["train"], m_f)
        return m, opt, clip

    with Phase("mamba_train_step_card_vs_cpu") as ph:
        # dt_bias and A_log: the leaves that sum dcs = dcs_i + dcs_j over
        # every position
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, "Mamba-2", m_fresh, dev, x_step, y_step, m_lrs, m_sparse_k,
            MAMBA_GRAD_RTOL_OF_MAX,
            watch=("dt_bias_a_log_grad_err_over_allowed",
                   lambda n: n.endswith(("dt_bias", "A_log"))))

    # a Mamba-2 training step's time and where it goes
    with Phase("mamba_train_step_timing") as ph:
        ph.fields.update(step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, m_lrs, m_sparse_k,
                               clip_norm=clip),
            bsz * L, "decay_attention", "decay_attention"))
        del card_m, card_opt

    # the decay attention's kernels at the MQAR Mamba-2 shape and, for the
    # record, the WikiText Mamba-2 shape and the CIFAR Mamba-2's two: time,
    # bound, plain version and the einsum form
    with Phase("decay_attention_timing") as ph:
        decay_times = time_decay_attention(dattn, *decay_io, flush)
        for name, t in decay_times.items():
            ph.fields[name] = timing_fields(t, "einsum_autograd_ms", "over_einsum")
        del decay_io
        for shape in SSD_TIMED_SHAPES:
            ins = decay_inputs(dev, gen, *SSD_SHAPES[shape])
            for name, t in time_decay_attention(dattn, *ins, flush).items():
                ph.fields[f"{name}_{shape}"] = timing_fields(t, "einsum_autograd_ms",
                                                             "over_einsum")
            del ins
            torch.cuda.empty_cache()

    # the bfloat16 kernels at the WikiText Mamba-2 shape (path 9's, the one
    # the kernel line reports) and the MQAR shape: time, bound (the bfloat16
    # tensor-core rate), plain version and the bfloat16 einsum form
    with Phase("decay_attention_bf16_timing") as ph:
        for shape in ("wikitext_bg8_q1024_n512_hg8_p64", "mqar_bg64_q512_n128_hg1_p128"):
            ins = decay_inputs(dev, gen, *SSD_BF16_SHAPES[shape], dtype=torch.bfloat16)
            times = time_decay_attention(dattn, *ins, flush)
            for name, t in times.items():
                ph.fields[f"{name}_{shape}"] = timing_fields(t, "einsum_autograd_ms",
                                                             "over_einsum")
            ph.fields[f"load_route_{shape}"] = dattn.load_route(ins[0], ins[1], ins[3], ins[4])
            if shape.startswith("wikitext"):
                decay_bf16_times = times
            del ins
        # the three at the WikiText Mamba-2 shape with C 8 bytes off a
        # 16-byte boundary, so every tile lands by ordinary loads (no main
        # path hands them so): what that route costs
        ins = decay_inputs(dev, gen, *SSD_BF16_SHAPES["wikitext_bg8_q1024_n512_hg8_p64"],
                           dtype=torch.bfloat16, c_offset_bytes=8)
        ph.fields["c_8_bytes_off_load_route"] = dattn.load_route(ins[0], ins[1], ins[3], ins[4])
        with torch.no_grad():
            for name, fn in (("fwd", lambda: dattn.decay_attention_fwd_cuda(*ins[:4])),
                             ("bwd_i", lambda: dattn.decay_attention_bwd_i_cuda(*ins)),
                             ("bwd_j", lambda: dattn.decay_attention_bwd_j_cuda(*ins))):
                ph.fields[f"decay_attention_{name}_bf16_ordinary_route_ms_cold_median"] = (
                    f"{median(cuda_ms(fn, 21, flush)):.5f}")
        del ins
        torch.cuda.empty_cache()

    # main path 5, the MQAR softmax transformer through the flash kernels
    path5_all, attn_times, attn_errs = transformer_path(dev, gen, flush, test_x, test_y,
                                                        train_split, want_files)

    # main paths 6 and 7, the MQAR linear and norm attention transformers:
    # no port kernel on either
    path6_all = attention_family_path(dev, test_x, test_y, train_split, want_files,
                                      MQAR_LIN_ATTENTION_FULL, "lin", LIN_STEPS, LIN_EVAL_EVERY)
    path7_all = attention_family_path(dev, test_x, test_y, train_split, want_files,
                                      MQAR_NORM_ATTENTION_CONV_FULL, "norm", NORM_STEPS,
                                      NORM_EVAL_EVERY)

    # main paths 8 and 9, the WikiText Mamba-2 LM in float32 and in bfloat16
    # (the decay attention's float32 and bfloat16 kernels), and 10, the
    # stacked seed sweep of the MQAR linear attention (no port kernel)
    wt_splits = wikitext_splits()
    path8_all = wikitext_mamba2_path(dev, wt_splits, "wikitext-mamba2-short.yaml", "wt_mamba2",
                                     want_files, serve=True)
    path9_all = wikitext_mamba2_path(dev, wt_splits, "wikitext-mamba2-short-bf16.yaml",
                                     "wt_mamba2_bf16", want_files)
    # main path 11, the bfloat16 WikiText Mamba-2 through the fused head's
    # bfloat16 kernels, its step timed in the same run as path 9's dense head
    path11_all = wikitext_mamba2_path(dev, wt_splits, "wikitext-mamba2-short-bf16-fused.yaml",
                                      "wt_mamba2_bf16_fused", want_files)
    # main path 32, the WikiText LRU LM in bfloat16 through run_truncated: the
    # fused head's bfloat16 kernels and the scan's, beside path 3's float32
    # step; 33, the bf16 MQAR softmax transformer (the float32 flash
    # kernels); 34, a stacked wave of four bf16 linear-attention seeds and
    # one bf16 S5 step (the scan)
    bf16_s = {}
    t0 = time.perf_counter()
    path32_all, _ = wikitext_lru_bf16_path(dev, wt_splits, want_files, lm_step_fields)
    bf16_s["path_32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path33_all = sm_attention_bf16_path(dev, test_x, test_y, train_split, want_files)
    bf16_s["path_33"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path34_all = bf16_wave_path(dev, test_x, test_y, train_split, want_files)
    bf16_s["path_34"] = time.perf_counter() - t0
    print(f"[paths 32-34 seconds] {json.dumps({k: round(v, 2) for k, v in bf16_s.items()})} "
          f"total {sum(bf16_s.values()):.2f}", flush=True)
    # main path 35, the bf16 MQAR Mamba-1 (the scan's kernels); 36, the hybrid
    # dense-encoder CIFAR-10 classifier (the flash kernels); 37, data
    # parallelism in a group of one over NCCL and of two gloo processes on
    # the card (the scan's kernels, each rank's counted)
    s18 = {}
    t0 = time.perf_counter()
    path35_all = bf16_mamba1_path(dev, want_files)
    s18["path_35"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path36_all = hybrid_classifier_path(dev, want_files)
    s18["path_36"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = data_parallel_path(dev, want_files)
    path37_all = {k: dp["world_1"].get(k, 0) + sum(r.get(k, 0) for r in dp["world_2"])
                  + sum(r.get(k, 0) for r in dp["sweep_2"]) for k in LAUNCHES}
    s18["path_37"] = time.perf_counter() - t0
    # main path 38, sequence parallelism: the primitives in a group of one
    # over NCCL and of two gloo processes on the card, and the MQAR LRU (the
    # scan's kernels, each rank's counted) and softmax transformer (the ring)
    # trained over the two
    sp = sequence_parallel_path(dev, want_files)
    path38_all = {k: sum(r.get(k, 0) for runs in sp["world_2"].values() for r in runs)
                  for k in LAUNCHES}
    s18["path_38"] = sp["seconds"]
    # main path 39, vocab tensor parallelism: the route at m = 1 over NCCL,
    # then four gloo processes on the card (the softmax transformer's flash
    # kernels at 2 × 2, serving over the data ranks, the LRU's scan kernels
    # at 1 × 2), each rank's launches counted
    tp = tensor_parallel_path(dev, want_files)
    path39_all = {k: tp["world_1"].get(k, 0)
                  + sum(r.get(k, 0) for job in ("sm", "lru", "decode") for r in tp[job])
                  for k in LAUNCHES}
    s18["path_39"] = tp["seconds"]
    print(f"[paths 35-39 seconds] {json.dumps({k: round(v, 2) for k, v in s18.items()})} "
          f"total {sum(s18.values()):.2f}", flush=True)
    # main paths 16 and 17, the WikiText norm-attention LM alone and its
    # stacked seeds × rates sweep, then the pretrained-LM spectroscopy on a
    # stand-in at its widths (no port kernel on any of them)
    new_s = {}
    t0 = time.perf_counter()
    path16_all = wikitext_norm_attention_path(dev, wt_splits, want_files)
    new_s["path_16"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path17_all = wikitext_sweep_path(dev, wt_splits, want_files)
    new_s["path_17"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_spectra_phase(dev)
    new_s["lm_spectra"] = time.perf_counter() - t0
    del wt_splits
    path10_all = sweep_path(dev, test_x, test_y, train_split, want_files)

    # the vmap rules of the kernels' Functions (one launch for a grid), then
    # main paths 29-31, the stacked sweeps of the kernel families: the MQAR
    # LRU's seeds (the scan kernels, 2 + 2 a stacked step), the Mamba-2's
    # rates × layers (the decay attention's three, 1 + 1 + 1 and 4 + 4 + 4)
    # and the softmax transformer's seeds (the flash kernels, 2 + 2 + 2)
    kernel_sweep_s = {}
    t0 = time.perf_counter()
    fold_times = vmap_rules_phase(dev, flush)
    kernel_sweep_s["vmap_rules"] = time.perf_counter() - t0
    kernel_sweeps = kernel_sweep_specs()
    kernel_sweep_all = {}
    for tag, (base_raw, points, steps, every, per_step) in kernel_sweeps.items():
        t0 = time.perf_counter()
        kernel_sweep_all[tag] = kernel_sweep_path(dev, tag, base_raw, points, train_split,
                                                  (test_x, test_y), want_files, steps, every,
                                                  per_step)
        kernel_sweep_s[tag] = time.perf_counter() - t0
    print(f"[vmap rules and paths 29-31 seconds] "
          f"{json.dumps({k: round(v, 2) for k, v in kernel_sweep_s.items()})} "
          f"total {sum(kernel_sweep_s.values()):.2f}; folded kernels {fold_times}", flush=True)

    # main paths 12 and 13, the MQAR S5 (the scan kernels at P 64, a (P,)
    # decay) and S4 (no port kernel)
    path12_all, (s5_scan_times, s5_scan_errs) = ssm_family_path(
        dev, test_x, test_y, train_split, want_files, MQAR_S5_FULL, "s5", SSM_STEPS,
        SSM_EVAL_EVERY, flush)
    path13_all, _ = ssm_family_path(dev, test_x, test_y, train_split, want_files, MQAR_S4_FULL,
                                    "s4", SSM_STEPS, SSM_EVAL_EVERY, flush)
    print(f"[s5 scan kernels] {s5_scan_times} errors {s5_scan_errs}", flush=True)

    # main paths 14 and 15, the ListOps S5 (the scan kernels at (50, 2048, P
    # 32), a (P,) decay) and S4 (no port kernel): padded, mean-pooled,
    # epoch-driven, with a resume
    path14_all, (listops_scan_times, listops_scan_errs) = listops_path(
        dev, want_files, LISTOPS_S5_FULL, "listops_s5", flush)
    path15_all, _ = listops_path(dev, want_files, LISTOPS_S4_FULL, "listops_s4", flush)
    print(f"[listops s5 scan kernels] {listops_scan_times} errors {listops_scan_errs}",
          flush=True)

    # main path 18, the MQAR Mamba-1: the scan kernels where a varies in
    # time, on its (32, 64, 2048) view
    t0 = time.perf_counter()
    path18_all, (m1_scan_times, m1_scan_errs, m1_a_range) = mamba1_path(dev, want_files, flush)
    new_s["path_18"] = time.perf_counter() - t0
    print(f"[mamba1 scan kernels] {m1_scan_times} errors {m1_scan_errs} trained a in "
          f"{m1_a_range}", flush=True)
    print(f"[paths 16-18 seconds] {json.dumps({k: round(v, 2) for k, v in new_s.items()})} "
          f"total {sum(new_s.values()):.2f}", flush=True)

    # main paths 19-21, sequential CIFAR-10: the Mamba-2 classifier and its
    # pseudo-LTI variant (the decay attention's float32 kernels at 4 heads of
    # 128, N 64, L 1024) and S4 (no port kernel)
    cifar_s, cifar_all = {}, {}
    for tag, full in (("cifar_mamba2", CIFAR_MAMBA2_FULL),
                      ("cifar_mamba2_lti", CIFAR_MAMBA2_LTI_FULL), ("cifar_s4", CIFAR_S4_FULL)):
        t0 = time.perf_counter()
        cifar_all[tag] = cifar_path(dev, want_files, full, tag, flush)
        cifar_s[tag] = time.perf_counter() - t0
    print(f"[paths 19-21 seconds] {json.dumps({k: round(v, 2) for k, v in cifar_s.items()})} "
          f"total {sum(cifar_s.values()):.2f}", flush=True)

    # main paths 22 and 23, the CIFAR-10 transformer classifiers (softmax
    # attention, materialised, and norm attention with the SiLU gate: no port
    # kernel, the flash kernels among them), then 24 and 25, the padded
    # Mamba-2 classifiers on ListOps and IMDB (the decay attention's float32
    # kernels at (200, 512, 64, 4, 32) and (24, 1024, 64, 4, 32))
    cls_s, cls_all = {}, {}
    # the gated norm-attention YAML asks for no tokenize, so its float pixels
    # would reach the token embedding, which raises as in tlie_tpu: the path
    # reads the grey levels as tokens, as the softmax config does
    gating = copy.deepcopy(CIFAR_NORM_ATTENTION_GATING_FULL)
    gating["dataset"]["tokenize"] = True
    for tag, full in (("cifar_sm_attention", CIFAR_SM_ATTENTION_FULL),
                      ("cifar_norm_attention_gating", gating)):
        t0 = time.perf_counter()
        cls_all[tag] = cifar_path(dev, want_files, full, tag, flush)
        cls_s[tag] = time.perf_counter() - t0
    for tag, full in (("listops_mamba2", LISTOPS_MAMBA2_FULL), ("imdb_mamba2", IMDB_MAMBA2_FULL)):
        t0 = time.perf_counter()
        cls_all[tag] = classifier_path(dev, want_files, full, tag, lra_mamba2_splits(full, tag),
                                       LRA_EPOCHS, LRA_ANALYSIS_BATCH, CIFAR_STEP_EXAMPLES,
                                       flush)
        cls_s[tag] = time.perf_counter() - t0
    print(f"[paths 22-25 seconds] {json.dumps({k: round(v, 2) for k, v in cls_s.items()})} "
          f"total {sum(cls_s.values()):.2f}", flush=True)

    # main paths 26-28: PathFinder S4 (no port kernel); AAN, the transformer
    # with the dual MATCH head (no port kernel) and a dual Mamba-2 (the decay
    # attention's float32 kernels on 16 documents a step); Speech Commands S5
    # on MFCC frames (the scan's kernels at (32, 161, 48), 4 + 4 a step)
    lra_s = {}
    t0 = time.perf_counter()
    pf_splits, _ = synthetic_splits(PATHFINDER_S4_FULL, "pathfinder_s4", PF_TRAIN, PF_TEST)
    cls_all["pathfinder_s4"] = classifier_path(dev, want_files, PATHFINDER_S4_FULL,
                                               "pathfinder_s4", pf_splits, LRA_EPOCHS,
                                               CIFAR_ANALYSIS_BATCH, CIFAR_STEP_EXAMPLES, flush)
    lra_s["pathfinder_s4"] = time.perf_counter() - t0
    del pf_splits
    t0 = time.perf_counter()
    cls_all.update(aan_path(dev, want_files, flush))
    lra_s["aan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc_splits, _ = synthetic_splits(SC_S5_MFCC_FULL, "sc_s5", SC_TRAIN, SC_TEST)
    sc_out = {}
    cls_all["sc_s5"] = classifier_path(dev, want_files, SC_S5_MFCC_FULL, "sc_s5", sc_splits,
                                       LRA_EPOCHS, CIFAR_ANALYSIS_BATCH, CIFAR_STEP_EXAMPLES,
                                       flush, out=sc_out)
    lra_s["sc_s5"] = time.perf_counter() - t0
    del sc_splits
    print(f"[sc s5 scan kernels] {sc_out['scan'][0]} errors {sc_out['scan'][1]}", flush=True)
    print(f"[paths 26-28 seconds] {json.dumps({k: round(v, 2) for k, v in lra_s.items()})} "
          f"total {sum(lra_s.values()):.2f}", flush=True)

    def late(name):
        return (path6_all[name] + path7_all[name] + path8_all[name] + path9_all[name]
                + path10_all[name] + path11_all[name] + path12_all[name] + path13_all[name]
                + path14_all[name] + path15_all[name] + path16_all[name] + path17_all[name]
                + path18_all[name] + sum(c[name] for c in cifar_all.values())
                + sum(c[name] for c in cls_all.values())
                + sum(c[name] for c in kernel_sweep_all.values())
                + path32_all[name] + path33_all[name] + path34_all.get(name, 0)
                + path35_all[name] + path36_all[name] + path37_all[name]
                + path38_all[name] + path39_all[name])

    kernels = [{
        "name": "diag_scan",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:107",
        "launches": (path1["diag_scan"] + path2_all["diag_scan"] + path3_all["diag_scan"]
                     + late("diag_scan")),
        "max_abs_err": err,
        "ms": scan_times[""][0],
        "plain_ms": scan_times[""][2],
        "bound_ms": scan_times[""][3],
        "bound_by": scan_times[""][4],
        "library_ms": None,  # no single PyTorch call computes a diagonal linear recurrence
    }, {
        "name": "diag_scan_bwd",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan_bwd.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:192",
        "launches": (path1["diag_scan_bwd"] + path2_all["diag_scan_bwd"]
                     + path3_all["diag_scan_bwd"] + late("diag_scan_bwd")),
        "max_abs_err": max(d_e, da_e),
        "ms": bwd_times[""][0],
        "plain_ms": bwd_times[""][2],
        "bound_ms": bwd_times[""][3],
        "bound_by": bwd_times[""][4],
        "library_ms": None,  # no single PyTorch call computes the recurrence's gradient
    }]
    replaces = {"fused_xent_fwd": "tlie_tpu/ops/fused_xent.py:126",
                "fused_xent_dh": "tlie_tpu/ops/fused_xent.py:228",
                "fused_xent_dw": "tlie_tpu/ops/fused_xent.py:246"}
    for name, (k_ms, _, p_ms, l_ms, bound, by, _, _, _) in xent_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/fused_xent.cu",
            "replaces": replaces[name],
            "launches": path3_all[name] + late(name),
            "max_abs_err": xent_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": l_ms,  # addmm + F.cross_entropy, autograd for the gradients
        })
    replaces = {"fused_xent_fwd_bf16": "tlie_tpu/ops/fused_xent.py:126",
                "fused_xent_dh_bf16": "tlie_tpu/ops/fused_xent.py:228",
                "fused_xent_dw_bf16": "tlie_tpu/ops/fused_xent.py:246"}
    for name, (k_ms, _, p_ms, l_ms, bound, by, _, _, _) in xent_bf16_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/fused_xent_bf16.cu",
            "replaces": replaces[name],
            "launches": path3_all[name] + late(name),
            "max_abs_err": xent_bf16_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            # bf16 addmm + cross_entropy_loss's float32 reduction, autograd
            # for the gradients
            "library_ms": l_ms,
        })
    replaces = {"decay_attention_fwd": "tlie_tpu/ops/pallas_ssd.py:252",
                "decay_attention_bwd_i": "tlie_tpu/ops/pallas_ssd.py:272",
                "decay_attention_bwd_j": "tlie_tpu/ops/pallas_ssd.py:293"}
    for name, (k_ms, _, p_ms, _, bound, by, _, _, _) in decay_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/decay_attention.cu",
            "replaces": replaces[name],
            "launches": path4_all[name] + late(name),
            "max_abs_err": decay_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,  # no single PyTorch call computes the decay attention
        })
    replaces = {"decay_attention_fwd_bf16": "tlie_tpu/ops/pallas_ssd.py:252",
                "decay_attention_bwd_i_bf16": "tlie_tpu/ops/pallas_ssd.py:272",
                "decay_attention_bwd_j_bf16": "tlie_tpu/ops/pallas_ssd.py:293"}
    for name, (k_ms, _, p_ms, e_ms, bound, by, _, _, _) in decay_bf16_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/decay_attention_bf16.cu",
            "replaces": replaces[name],
            "launches": path4_all[name] + late(name),
            "max_abs_err": decay_bf16_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            # the einsum form is several cuBLAS calls and elementwise passes,
            # not one library call: reported in the timing phase, not here
            "library_ms": None,
        })
    replaces = {"flash_attention_fwd": "tlie_tpu/ops/attention.py:49",
                "flash_attention_bwd_dkv": "tlie_tpu/ops/attention.py:49",
                "flash_attention_bwd_dq": "tlie_tpu/ops/attention.py:49"}
    for name, (k_ms, _, p_ms, l_ms, bound, by, _, _, _) in attn_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[name],
            "launches": path5_all[name] + late(name),
            "max_abs_err": attn_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": l_ms,  # F.scaled_dot_product_attention, autograd for the gradients
        })
    print(f"[total] {time.perf_counter() - T_START:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # paths 37-39 start their ranks as ``chip_smoke.py --dp-rank SPEC``,
    # ``--sp-rank SPEC`` and ``--tp-rank SPEC``; the run itself takes no
    # arguments
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sp-rank"]:
        sys.exit(sp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2]))
    sys.exit(main())
