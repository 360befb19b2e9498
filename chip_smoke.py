#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``mxtpu_torch``): run
``python3 chip_smoke.py`` from the root of a checkout on a machine with one
NVIDIA H100.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel of ``mxtpu_torch/csrc/`` with nvcc for sm_90a, one
   nvcc per source, all at once, and prints the ptxas lines that give
   each instance's registers and spills or a performance loss.
3. Holds the hand-written fused conv kernel against its plain PyTorch
   version at the ResNet-50 shapes it serves (batch 8, float32 on the CUDA
   cores and bfloat16 on the tensor cores), on a C_out tile tail (96), on
   a view whose rows are not 16-byte aligned (element-wise staging), on an
   odd stride-2 shape and on the full epilogue with both residual types;
   times the kernel, the plain version and ``F.conv2d`` (a yardstick only)
   eagerly, by CUDA-graph replay and by the host's issue time per call;
   prints each launch's route, staging, tile and grid.
4. Serves ResNet-50 v1 (NHWC, 224x224, 1000 classes, seeded weights)
   through the port's bucketed Predictor on the card, in float32 and then
   bfloat16, each bucket one captured CUDA graph (one graph per bucket,
   and the builds at the Predictor's retrace site still equal to the
   number of buckets after all traffic), checks the logits against the
   same net on the CPU, that every forward launched the conv kernel 11
   times (the wrapper's count, which a replay carries, and the profiler's
   kernels by name) and that a replay equals the same forward run
   eagerly on the card, and times each bucket by graph replay and eagerly
   (median and p80 latency, host issue, and for b8 the device time and
   idle share), with the peak memory after warm-up.
5. Holds the hand-written flash attention kernel (out and lse) against
   its plain PyTorch version at the shapes BERT-base serves (batch 8, 12
   heads, head dim 64, T 128 and 512, causal and not; as tensors of their
   own and as the strided q/k/v views of one fused projection that the
   served model hands it), at a ragged T=77 with D=32 and with D=36 (the
   element-wise staging), at T=256 with D=128, and at b6 h12 T512 with
   D=128 and D=36 (where bfloat16 puts two warpgroups in a block), at head
   dims 160, 256, 300 and 320 (the sliced kernels; D=256 also on the
   strided views), in float32 and bfloat16; at three explicit scales
   (small, zero, negative) on a ragged T=77; and times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only) by CUDA events
   around 20 eager back-to-back calls, as every kernel of the ``kernels``
   line is timed, with each timed row's kernel/sdpa ratio and share of its
   bound; and beside that the device time by CUDA-graph replay (the host
   out of the way: one eager call's issue takes about as long as the
   kernel) and the host's issue time per call.
6. Serves the BERT-base-shaped TransformerLM (vocab 30522, dim 768, 12
   heads, 12 layers, max_len 512, bidirectional, seeded weights) through
   the port's Predictor with batch and sequence buckets (1-8 x 128, 256,
   512) on the card, in float32 and then bfloat16, 12 captured graphs
   each, with the same checks (the flash kernel 12 times a forward),
   times each bucket at seq 512 and b8 at 128 and 256 by replay and
   eagerly, and breaks one b8 x 512 forward down by kernel both ways.
   Then the rest of the serving plane: int8 weights (ResNet-50 and the
   TransformerLM in float32 with ``int8=True`` against the port's int8
   Predictor on the CPU, 1e-3 of max|logit|, beside the float32 logits,
   with each Predictor's parameter snapshot bytes and the device memory
   its build and warm-up took at peak and holds after);
   ``net.hybridize()`` (ResNet-50 bf16 at two signatures and one in
   train mode, bit-equal to eager, one graph each); the
   TransformerLM bf16 through a MicroBatcher over a one-replica
   ReplicaSet on cuda:0 (8 threads x 16 requests of random length, each
   held to its direct predict, none shed); and ResNet-50 bf16 behind the
   ModelServer on 127.0.0.1 (8 threads x 8 single-image POSTs held to
   direct predict, /healthz, /metrics, drain).
   The serving control plane: ResNet-50 bf16 through a ReplicaDispatcher
   over two replicas on cuda:0 with a ServingController (threaded, real
   clock): the latency model warmed (predicted beside observed p90),
   requests with half the predicted latency as deadline all shed
   ``predicted_miss``, r1 failed until its breaker opened and replaced by
   r2 captured on a thread of its own while r0 served (bring-up seconds,
   p50/p99 before and during), a scale-down after one idle cooldown and a
   scale-up refused on the one card (``warmup_failed``); every answer
   within 5e-2 of max|logit| of direct predict, 11 conv launches per
   forward. The model zoo: ResNet-50 and the TransformerLM in bf16 in one
   ZooScheduler on cuda:0: six alternations under a count cap of one
   (page-in seconds, footprints beside the allocated bytes, each eviction
   giving its bytes back within 64 MiB), eviction by a byte budget, a
   ResNet-50 canary split by crc32 of the request id with each arm
   answering as its version, promoted without a capture, a canary rolled
   back by the injected fault with every future answered, and HTTP by
   model name with a 404 that lists both; 11 conv / 12 flash launches per
   forward on every arm and no nvcc during the phase.
   Continuous-batching decode (slice 7, ``decode_phase``), every engine
   on cuda:0 and none of B1-B3 on its path: the phase runs after every
   other, so that each kernel of B1-B3 exists when its count is set to 0
   before it, and each count read after it goes into the ``kernels``
   line (``decode_launches``; ``fused_conv`` and ``flash_attention``
   keep one count over both types, so their two entries carry it as
   ``decode_launches_both_dtypes``): at the
   reference bench's configuration (vocab 256, dim 128, prompts up to 48,
   max_new 32, 8 slots, 80 requests, seeded weights) the card's tokens
   equal the port's CPU tokens and an eager full-prefix greedy loop on
   the card, rowed, paged, with the prefix cache and with speculation
   (fewer target steps), continuous in fewer steps than restart-per-batch,
   no capture after warm-up and no sync inside the step's dispatch
   (``set_sync_debug_mode("error")``), int8 KV equal to the CPU's int8
   at most half f32's bytes, and after an injected wedge (fake clock) the
   carry reset in place and the captured graphs decoding every request to
   the eager tokens; then the same builder at BERT-base's vocabulary and
   width, 16 slots, rowed and paged, timed over eight bursts of 64
   requests: tokens/s per burst with median and spread, TTFT p50/p99,
   step ms by replay per cohort bucket, host ms a step, the idle share of
   a profiled stretch and KV resident bytes.
7. Gluon on NDArrays: ResNet-50 v1 called on an mx.nd array on the card
   equals the tensor path bit for bit with 11 conv launches (float32 and
   bfloat16), and a Dense -> BatchNorm -> Dense net trained two steps on
   NDArrays under autograd.record() matches the same program on the CPU
   (outputs, p.grad() and moving statistics).
8. rtc: compiles user CUDA C++ at runtime through ``mxtpu_torch.rtc``
   (kernel B3: ``RTC_SOURCE``, the JAX package's rtc examples axpy,
   square, double (here ``twice``), square_backward and a bf16 axpy, as
   16-byte streaming kernels), builds it again from the cache, shows that
   CPU arrays, a dtype that disagrees with a pointer parameter and a
   source nvcc rejects raise, holds each kernel against its plain version
   (``RTC_PLAIN``) at n = ResNet-50 v1's parameter count, at n + 5 and on
   views one element off (the element-wise path), and times it beside its
   bound, its plain version, one PyTorch call and the ``__ldcs``/``__stcs``
   variant; and the host time of one launch, stage by stage.
9. imperative, the main path of slice 3: mx.nd arrays on the card, the
   runtime kernels launched on them, and square registered as a
   differentiable op (square_backward its vjp) under autograd.record()
   with grad_req write and add; one forward and one backward launch per
   step; results and gradients checked against the same program through
   mx.nd on the CPU (the op registered there with the plain versions).
10. Training, the main path of slice 4. The conv's backward: at each
   gated ResNet-50 shape (b8) and on the full epilogue, f32 and bf16, the
   gradients of the kernel path (the kernel forward, the ported
   backward) against autograd through the plain version on the card,
   forward + backward timed by CUDA-graph replay beside ``F.conv2d``'s,
   and the gradient convolutions on channels-last views beside NCHW
   copies. The flash backward: dq, dk, dv through out and lse at b8 h12
   T512 d64 on the served strided views (causal and not) and at D 160,
   against autograd through the plain version, timed beside sdpa's
   forward + backward (a yardstick). ResNet-50 v1 trained through
   ``gluon.Trainer`` (SGD-momentum): b8 f32, 2 steps on the card against
   the same steps on the CPU (losses, step-1 gradients, weights,
   momenta, BatchNorm statistics; 11 conv launches a step), a bf16 step
   against the f32 CPU step, then b64 f32 and b128 bf16 timed (step ms,
   images/s, host issue, device ms and idle share, peak memory, a
   profiled step by kernel category, train_mfu). The BERT-base-shaped
   TransformerLM trained with Adam: 2 layers at b2 x 512 f32 against the
   CPU (2 flash launches a step), then 12 layers at b8 x 512 bf16 timed.
11. The vision zoo and the rest of Gluon (slice 9). The fused conv held
   against its plain version, f32 and bf16, at one conv of each shape
   class the zoo adds (C_out 16/24/48/80/96/144, the 11x11/4 and 3x3/2
   stems on 3 channels, a 5x5, the s2d stem's 4x4 with padding (2, 1)),
   each timed by graph replay beside ``F.conv2d``. ``zoo_serve_phase``:
   alexnet, vgg16, squeezenet1_1, mobilenet1_0, mobilenet_v2_1_0,
   densenet121, inception_v3 (299x299) and resnet50_v2 built with
   ``get_model`` channels-last with seeded weights, each served through
   ``Predictor`` in one captured b8 bucket, f32 then bf16: logits against
   the CPU run, replay against eager, the conv kernel's launches per
   forward (1, 2, 19, 3, 28, 61, 28, 11), median/p80 latency, host issue,
   device ms, idle share, kernels a forward, and the kernel's convs of a
   forward by graph replay beside ``F.conv2d``'s. ``zoo_train_phase``:
   Inception v3 trained with ``hybridize()`` on net and loss and
   ``gluon.utils.clip_global_norm`` before each step: f32 b2 3 steps
   against the CPU and the card's eager step with the Dropout at rate 0;
   the Dropout gates in a captured pair (replays draw new masks, the
   kept share, the gradient mask * g / (1 - p) exactly, an unregistered
   draw raises, captured against eager draws from one generator state);
   2 steps with dropout 0.5 against the card's eager step where the draws
   agree; bf16 b64 timed eager forward/backward beside captured (28
   launches a step, 0 builds after the warm-up). ``s2d_phase``: ResNet-50
   v1 served at b8 with ``contrib.s2d_stem.apply_to_resnet`` modes 1 and 2
   beside the plain stem (11, 11, 10 launches a forward), each stem alone
   by graph replay.
12. The input path (slice 10, ``input_phase``): 1,280 raw 256x256x3
   uint8 records written to an indexed RecordIO file and read back;
   ``StreamRecordIter`` through ``DevicePrefetcher`` onto cuda:0 (inline
   and on 2 threads, after a ``worker_death`` and a ``prefetch_death``
   fault, at depth 1 under a busy consumer stream) bit-equal to its host
   batches; ``DataLoader(num_workers=4, pin_memory=True,
   prefetch_to_device=cuda:0)`` equal to ``num_workers=0``, no worker
   holding a CUDA context; ``ToTensor`` -> ``Normalize`` on the card
   against the CPU (1e-6); ResNet-50 v1 f32 b8 3 SGD steps from records in
   lockstep with the CPU; then its captured bf16 b128 step fed (a) from a
   batch resident on the card, (b) synchronously from the inline reader,
   (c) through ``StreamRecordIter`` -> ``DevicePrefetcher`` and (d)
   through the DataLoader: images/s (median of 10 after 3), ``data.wait``
   and ``data.h2d`` ms, ``data.starved``, the idle share by
   ``torch.profiler``, peak pinned and device bytes, builds after the
   warm-up (0) and B1's launches a step (11); and ``loader_only``, the
   reader's drain rate with no device work.
13. The symbolic API (slice 11, ``symbolic_phase``): ResNet-50 v1
   (seeded, hybridized, one b8 forward) exported from Gluon to
   ``-symbol.json`` + ``.params``; ``SymbolBlock.imports`` of the files
   against the Gluon logits (1e-3 of max|logit|, f32) and ``infer_shape``
   at b8 on meta tensors with no launch; ``Predictor.from_checkpoint``
   (buckets b1, b8, bf16, captured) against the same on the CPU (5e-2)
   with 11 B1 launches a forward, timed beside the Gluon Predictor of the
   same weights; ``SoftmaxOutput(load(json))`` trained through ``Module``
   (SGD-momentum, ``kvstore="local"``): 3 f32 b8 steps in lockstep with a
   CPU Module (as ``lockstep_train``), the f32 b64 step timed (captured
   executor pair + update graph, 0 builds after the warm-up, 11 B1
   launches a step) beside the captured Gluon step of this run, ``fit``
   over ``NDArrayIter`` with ``Speedometer``, ``save_checkpoint`` ->
   ``Module.load`` bit-equal; a partitioned attention symbol
   (batch_dot -> * 1/8 -> softmax -> batch_dot at q/k/v [96, 512, 64],
   f32 and bf16) with one ``_sg_flash_attention`` node and one B2 launch
   a forward, outputs and q/k/v gradients against the unpartitioned
   symbol, each forward's graph by replay beside sdpa; and one
   ``partition(·, "default")`` region of ResNet-50 against the
   unpartitioned symbol.
14. The RNN slice (slice 12, ``rnn_phase``), which launches none of B1-B3
   (each count set to 0 before it and read after it: ``rnn_b*_launches``
   in the kernels line, expected 0): bench.py's PTB language model
   (Embedding 33278 x 650, a 2-layer 650-unit LSTM over NTC, Dense over
   the vocabulary, 50.1 M seeded parameters) served through ``Predictor``
   with int32 token buckets b1 and b8 x 35, one captured graph each, f32
   and bf16 against the CPU (1e-3 and 5e-2 of max|logit|; median/p80
   latency, host issue, device ms, idle share, kernels a forward); trained
   captured (``hybridize``, ``SoftmaxCrossEntropyLoss`` over (-1, vocab),
   SGD lr 1.0): f32 b8 x 35 two steps in lockstep with the CPU, bf16 b128 x
   35 timed (tokens/s, peak memory, 0 builds after the warm-up,
   train_mfu); ``examples/rnn/lstm_bucketing.py``'s mx.rnn stack (2 x 200,
   embed 200, batch 32, vocab 10000, buckets 10-60) under
   ``BucketingModule``: two steps in lockstep with the CPU, each bucket's
   step timed (one captured pair a bucket, none on a second pass), one
   bucket through ``FusedRNNCell`` against the stack; the ``RNN`` op at
   the LM's shape (T 35, N 128, 650, 2 layers) by graph replay, forward
   and forward + backward, beside ``torch.nn.LSTM`` (cuDNN) with the same
   weights; and ``CTCLoss`` (T 100, N 32, 29 classes), a Conv2DLSTMCell
   step and ``foreach`` in a captured block against the CPU, with
   ``while_loop`` and ``cond`` refusing a capture, and a hybridized LSTM
   called with its states (captured) against the same calls eager.
15. The multi-device slice (slice 13, ROADMAP A8's first part,
   ``parallel_phase``), B1-B3's counts from 0 before it (B2 only; the
   kernels line's ``parallel_b2_launches``): B2 at the ring's block shape
   ``[b, 12, 128, 64]`` (b 2 and 16, non-causal and causal, f32 and bf16)
   against its plain version, eager and by graph replay beside sdpa, with
   its bound; (a) a world of one NCCL rank in this process: bench.py's
   BERT-base TransformerLM (bidirectional, bf16, Adam lr 1e-4, b16 x 512)
   trained 3 steps through the plain captured Trainer, ``ShardedTrainStep(
   data_parallel_mesh())`` and ``Trainer(mesh=, zero1=True)``, every
   step's loss and weights bit-equal to the plain one's, B2 12 launches a
   forward, 0 builds after the warm-up, each way's step timed (tokens/s,
   median/p80, host issue, idle share, peak GiB); (b) four ranks spawned
   on the one card over gloo (``spawn``, a ``file://`` rendezvous under
   build/, a timeout on every join) at BERT-base widths with 2 layers:
   data-parallel Adam (ZeRO-1 on and off, 3 f32 steps on the world of
   one's global batch of 8 x 512) against the world of one (the summed
   first-step gradients, each step's weight change, ZeRO-1 on against off
   within the summation-order bound), and sp 4 with the ring on B2 and on
   the dense body, causal and bidirectional, f32 and bf16, logits against
   the unsharded model (1e-3 / 5e-2 of max|logit|), the ring's attention
   alone and one step's model gradients (relative L2, the ReLU mask flips
   counted), each gate beside what a planted fault reads there, B2's
   launches per rank per layer (4 non-causal, 1 + rank causal),
   nvidia-smi's compute apps, each rank's step and transfer ms. A rank
   that fails fails the phase. On a machine
   of four cards, ``python3 chip_smoke.py parallel_four_cards`` runs part
   (b) alone with one NCCL rank a card (its reference steps first).
16. Prints one JSON line of kernels (fused_conv and flash_attention, one
   entry per type each, with graph-replay and host-issue sums beside the
   eager ones, the launches of one training step, and forward + backward
   by graph replay beside its plain version, the library's and its bound
   (the 5 gated convs once each; one non-causal b8 x 512 attention on the
   served views); one entry per rtc
   kernel; the bf16 conv entry adds its launches on the controller and
   zoo paths, the bf16 flash entry on the zoo's; each conv entry its
   launches per served zoo model, per captured Inception v3 step and per
   s2d-stem forward, its zoo shape classes and its launches on the input
   path; the conv and flash entries their launches on the symbolic path
   and the flash entries the partitioned attention's times; every entry
   the RNN path's launches of B1-B3), the card line again,
   and last ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line. It imports nothing of JAX or of the JAX package.
"""
import importlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,     # CUDA cores (TF32 is off by policy)
              "bfloat16": 989e12}   # dense tensor cores
# (name, batch, H=W, C_in, C_out, k, stride, pad, launches per forward)
RESNET50_GATED = [
    ("stem 7x7/2 3->64 @224", 8, 224, 3, 64, 7, 2, 3, 1),
    ("1x1 64->64 @56", 8, 56, 64, 64, 1, 1, 0, 1),
    ("3x3 64->64 @56", 8, 56, 64, 64, 3, 1, 1, 3),
    ("1x1 64->256 @56", 8, 56, 64, 256, 1, 1, 0, 4),
    ("1x1 256->64 @56", 8, 56, 256, 64, 1, 1, 0, 2),
]
REQUESTS = (1, 3, 8, 5, 11)
# (name, B, H, T, Tk, D, causal, launches per b8 x 512 forward, layout):
# the shapes BERT-base serves first, then the ragged tails and the largest
# head dim. Layout "qkv" is the served one: q, k and v strided views of one
# [B, T, 3, H, D] projection, as MultiHeadSelfAttention builds them (the
# 12 launches of a b8 x 512 forward run on those); "contig" is [B, H, T, D]
# tensors of their own. Rows that start with "b8" are timed.
FLASH_SHAPES = [
    ("b8 h12 T512 d64", 8, 12, 512, 512, 64, False, 0, "contig"),
    ("b8 h12 T512 d64 qkv views", 8, 12, 512, 512, 64, False, 12, "qkv"),
    ("b8 h12 T512 d64 causal", 8, 12, 512, 512, 64, True, 0, "contig"),
    ("b8 h12 T128 d64", 8, 12, 128, 128, 64, False, 0, "contig"),
    ("b8 h12 T128 d64 qkv views", 8, 12, 128, 128, 64, False, 0, "qkv"),
    ("b8 h12 T128 d64 causal", 8, 12, 128, 128, 64, True, 0, "contig"),
    ("b2 h3 T77 d32", 2, 3, 77, 77, 32, False, 0, "contig"),
    ("b2 h3 T77 d32 causal", 2, 3, 77, 77, 32, True, 0, "contig"),
    ("b2 h3 T77 d36", 2, 3, 77, 77, 36, False, 0, "contig"),
    ("b2 h3 T77 d36 causal", 2, 3, 77, 77, 36, True, 0, "contig"),
    ("b2 h4 T256 d128", 2, 4, 256, 256, 128, False, 0, "contig"),
    ("b6 h12 T512 d128", 6, 12, 512, 512, 128, False, 0, "contig"),
    ("b6 h12 T512 d36 causal", 6, 12, 512, 512, 36, True, 0, "contig"),
    # head dims past 128: 128-column slices of out, each recomputing S
    ("b2 h4 T256 d160", 2, 4, 256, 256, 160, False, 0, "contig"),
    ("b2 h4 T256 d160 causal", 2, 4, 256, 256, 160, True, 0, "contig"),
    ("b8 h12 T512 d256", 8, 12, 512, 512, 256, False, 0, "contig"),
    ("b8 h12 T512 d256 causal", 8, 12, 512, 512, 256, True, 0, "contig"),
    ("b2 h3 T77 d256 qkv views", 2, 3, 77, 77, 256, False, 0, "qkv"),
    ("b2 h3 T77 d256 qkv views causal", 2, 3, 77, 77, 256, True, 0, "qkv"),
    ("b2 h4 T200 d320", 2, 4, 200, 200, 320, False, 0, "contig"),
    ("b2 h4 T200 d320 causal", 2, 4, 200, 200, 320, True, 0, "contig"),
    ("b1 h2 T77 d300 causal", 1, 2, 77, 77, 300, True, 0, "contig"),
]
# explicit scales, each on a ragged causal and a ragged full row: the kernel
# masks after scaling, so a zero or negative scale still gives masked keys
# no weight
FLASH_SCALES = (0.05, 0.0, -0.125)
BERT_BASE = dict(vocab_size=30522, dim=768, num_heads=12, num_layers=12,
                 max_len=512, causal=False)     # bench.py's configuration
SEQ_BUCKETS = (128, 256, 512)
LM_REQUESTS = ((1, 50), (3, 200), (5, 128), (8, 512), (11, 100))

# User kernels compiled at runtime by mxtpu_torch.rtc (kernel B3): the JAX
# package's rtc examples (tests/test_contrib_python.py) as CUDA C++.
# `twice` is the JAX examples' `double`, a C++ keyword. Each is a streaming
# kernel: bound by bytes, so it moves 16-byte vectors (a float4, or 8 bf16
# in a uint4), RTC_UNROLL of each input a thread, all loaded before the
# first is used (1 measured as fast as 2-8, variant_search.py), over a
# grid that covers the array in one pass
# (rtc_launch_dims; the loop strides over the grid for any other grid);
# the ragged tail (n % vector width), and the whole array when any pointer
# is not 16-byte aligned, go element by element. The arithmetic is the
# one-element-a-thread kernels' own, so nvcc contracts it the same way and
# the results are bit-identical to theirs. LD/ST are plain loads and
# stores; RTC_STREAMING swaps in the evict-first hints __ldcs/__stcs (a
# variant chip_smoke.py times).
RTC_UNROLL = 1     # UNROLL in RTC_SOURCE
RTC_BLOCK = 256
RTC_SOURCE = r"""
#include <cuda_bf16.h>
#include <stdint.h>

#define UNROLL 1
#define LD(p) (*(p))
#define ST(p, v) (*(p) = (v))

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out[j] = f(x) with x[k] = in[k][j], over vectors j = 0 .. nv-1: each
// thread takes UNROLL vectors `step` apart (the whole grid apart), loads
// all of them (those below nv) before it uses the first, and moves a pass
// of the grid on
template <int NI, typename V, typename F>
__device__ __forceinline__ void stream_vectors(const V* const (&in)[NI], V* out,
                                               long long nv, F f) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nv; i += UNROLL * (long long)gridDim.x * blockDim.x) {
    V x[UNROLL][NI];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * step < nv) {
#pragma unroll
        for (int k = 0; k < NI; ++k) x[u][k] = LD(in[k] + i + u * step);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * step < nv) ST(out + i + u * step, f(x[u]));
    }
  }
}

// this thread's first element and the grid's stride, for the element-wise
// loops: the tail past the last whole vector, or every element when a
// pointer is not 16-byte aligned (a view at an odd offset)
#define ELEMENTS(done)                                                     \
  for (long long i = (done) + (long long)blockIdx.x * blockDim.x + threadIdx.x; \
       i < n; i += (long long)gridDim.x * blockDim.x)

extern "C" __global__ void axpy(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, long long n) {
  long long done = 0;
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    const float4* const in[2] = {reinterpret_cast<const float4*>(x),
                                 reinterpret_cast<const float4*>(y)};
    stream_vectors(in, reinterpret_cast<float4*>(out), n / 4,
                   [](const float4 (&v)[2]) {
                     return make_float4(2.5f * v[0].x + v[1].x, 2.5f * v[0].y + v[1].y,
                                        2.5f * v[0].z + v[1].z, 2.5f * v[0].w + v[1].w);
                   });
    done = n / 4 * 4;
  }
  ELEMENTS(done) out[i] = 2.5f * x[i] + y[i];
}

extern "C" __global__ void square(const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  long long done = 0;
  if (aligned16(x) && aligned16(out)) {
    const float4* const in[1] = {reinterpret_cast<const float4*>(x)};
    stream_vectors(in, reinterpret_cast<float4*>(out), n / 4,
                   [](const float4 (&v)[1]) {
                     return make_float4(v[0].x * v[0].x, v[0].y * v[0].y,
                                        v[0].z * v[0].z, v[0].w * v[0].w);
                   });
    done = n / 4 * 4;
  }
  ELEMENTS(done) out[i] = x[i] * x[i];
}

extern "C" __global__ void twice(const float* __restrict__ x,
                                 float* __restrict__ out, long long n) {
  long long done = 0;
  if (aligned16(x) && aligned16(out)) {
    const float4* const in[1] = {reinterpret_cast<const float4*>(x)};
    stream_vectors(in, reinterpret_cast<float4*>(out), n / 4,
                   [](const float4 (&v)[1]) {
                     return make_float4(2.0f * v[0].x, 2.0f * v[0].y, 2.0f * v[0].z,
                                        2.0f * v[0].w);
                   });
    done = n / 4 * 4;
  }
  ELEMENTS(done) out[i] = 2.0f * x[i];
}

// the gradient of square: dx = 2 x g
extern "C" __global__ void square_backward(const float* __restrict__ x,
                                           const float* __restrict__ g,
                                           float* __restrict__ dx,
                                           long long n) {
  long long done = 0;
  if (aligned16(x) && aligned16(g) && aligned16(dx)) {
    const float4* const in[2] = {reinterpret_cast<const float4*>(x),
                                 reinterpret_cast<const float4*>(g)};
    stream_vectors(in, reinterpret_cast<float4*>(dx), n / 4,
                   [](const float4 (&v)[2]) {
                     return make_float4(2.0f * v[0].x * v[1].x, 2.0f * v[0].y * v[1].y,
                                        2.0f * v[0].z * v[1].z, 2.0f * v[0].w * v[1].w);
                   });
    done = n / 4 * 4;
  }
  ELEMENTS(done) dx[i] = 2.0f * x[i] * g[i];
}

// axpy on bfloat16 arrays: bf16 loads and stores (8 a vector), float32
// math, one rounding to bf16 (to nearest even) at the store
__device__ __forceinline__ uint32_t axpy_bf16x2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  __nv_bfloat162 r = __floats2bfloat162_rn(fmaf(2.5f, a.x, b.x), fmaf(2.5f, a.y, b.y));
  return *reinterpret_cast<uint32_t*>(&r);
}

extern "C" __global__ void axpy_bf16(const __nv_bfloat16* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ y,
                                     __nv_bfloat16* __restrict__ out,
                                     long long n) {
  long long done = 0;
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    const uint4* const in[2] = {reinterpret_cast<const uint4*>(x),
                                reinterpret_cast<const uint4*>(y)};
    stream_vectors(in, reinterpret_cast<uint4*>(out), n / 8,
                   [](const uint4 (&v)[2]) {
                     return make_uint4(axpy_bf16x2(v[0].x, v[1].x), axpy_bf16x2(v[0].y, v[1].y),
                                       axpy_bf16x2(v[0].z, v[1].z), axpy_bf16x2(v[0].w, v[1].w));
                   });
    done = n / 8 * 8;
  }
  ELEMENTS(done) {
    out[i] = __float2bfloat16(
        fmaf(2.5f, __bfloat162float(x[i]), __bfloat162float(y[i])));
  }
}
"""
RTC_STREAMING = RTC_SOURCE.replace(
    "#define LD(p) (*(p))\n#define ST(p, v) (*(p) = (v))",
    "#define LD(p) __ldcs(p)\n#define ST(p, v) __stcs((p), (v))")
# the plain PyTorch version of each, on the same tensors
RTC_PLAIN = {
    "axpy": lambda x, y: 2.5 * x + y,
    "square": lambda x: x * x,
    "twice": lambda x: 2.0 * x,
    "square_backward": lambda x, g: 2.0 * x * g,
    "axpy_bf16": lambda x, y: (2.5 * x.float() + y.float()).to(x.dtype),
}
# (kernel, inputs, dtype, check rule of rtc_check, one-call PyTorch
# yardstick or None)
RTC_KERNELS = [
    ("axpy", 2, "float32", "rtol", lambda x, y: torch_add(y, x, 2.5)),
    ("square", 1, "float32", "exact", lambda x: x.square()),
    ("twice", 1, "float32", "exact", lambda x: x.mul(2)),
    ("square_backward", 2, "float32", "exact", None),
    ("axpy_bf16", 2, "bfloat16", "ulp", lambda x, y: torch_add(y, x, 2.5)),
]


def torch_add(a, b, alpha):
    import torch
    return torch.add(a, b, alpha=alpha)


def print_ptxas(name, log):
    """The ptxas lines of a kernel library that name an instance or give
    its registers, spills or a performance loss (wgmma serialised:
    C7520 in a divergent path, C7512 for too few registers)."""
    for line in log.splitlines():
        if any(word in line for word in ("entry function", "registers",
                                         "spill", "Loss", "C75")):
            print("  ptxas %s: %s" % (name, line.strip()))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_ms(fn, launches=20, repeats=5, warmup=3):
    """Milliseconds per fn() call on the device: CUDA events around a run
    of back-to-back calls (so the host's launch cost overlaps the device
    work), divided by the count; the median of ``repeats`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, launches=20, repeats=5):
    """Device milliseconds per fn() call with the host out of the way: the
    calls captured once into a CUDA graph of ``launches`` back-to-back
    calls, the graph replayed between CUDA events; the median of
    ``repeats`` replays. For calls whose eager issue takes longer than
    their device time, as the flash rows' do (a Python wrapper or sdpa's
    dispatch against 5-250 us of device work)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[len(times) // 2]


def host_us(fn, n=400):
    """Median host microseconds to issue one fn() call, over ``n`` calls
    after 50 warm ones, not synchronised."""
    import torch
    for _ in range(50):
        fn()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    samples.sort()
    return samples[len(samples) // 2]


def bound_ms(n_bytes, flops, dtype):
    """Least time for the work: the larger of bytes over HBM bandwidth
    and FLOPs over the card's peak for the type; and which of the two."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def conv_bound_ms(x, w, out_elems, dtype):
    """A conv's bound: each input read once, each output written once."""
    n_bytes = (x.numel() + w.numel() + out_elems) * x.element_size()
    kh, kw, cin, cout = w.shape
    flops = 2.0 * (out_elems // cout) * kh * kw * cin * cout
    return bound_ms(n_bytes, flops, dtype)


def check(got, ref, dtype, what):
    """float32: |got-ref| <= 1e-4 + 1e-4|ref|; bfloat16 (ref computed in
    float32 from the same bf16 inputs): |got-ref| <= 1e-2 max|ref|."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == "float32":
        ok = bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
    else:
        ok = bool(err.max() <= 1e-2 * ref.abs().max())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: kernel disagrees with its plain version "
                             "(max abs err %.3g, max |ref| %.3g)"
                             % (what, err.max().item(), ref.abs().max().item()))
    return err.max().item()


def conv_row_line(name, dtype, err, la):
    return ("kernel fused_conv %-24s %-8s err %.3g (%s, A %s, B %s, %dx%d "
            "tile, %d threads, K pad %d, grid %s)" % (
                name, dtype, err, "tensor cores" if la.route else "CUDA cores",
                "16-byte" if la.vec_a else "element-wise",
                "16-byte" if la.vec_b else "element-wise", la.block_m,
                la.block_n, la.threads, la.k_pad, "x".join(map(str, la.grid))))


def conv_kernel_phase():
    """Hold the conv kernel against its plain version at the gated
    ResNet-50 shapes (timed), a Cout tile tail, an unaligned view, an odd
    stride-2 shape and the full epilogue, in f32 and bf16."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.conv import (_launch_args, fused_conv,
                                             fused_conv_reference,
                                             fused_conv_with_raw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernel checks against the plain version: float32 |err| <= "
          "1e-4 + 1e-4|ref|; bfloat16 max|err| <= 1e-2 max|ref|, ref in "
          "float32 from the same bf16 inputs")
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)

        def conv_inputs(n, hw, cin, cout, k, offset=0):
            """x (at ``offset`` elements into its storage) and w."""
            buf = torch.randn(n * hw * hw * cin + offset, device="cuda",
                              generator=gen).to(dt)
            x = buf[offset:].view(n, hw, hw, cin)
            w = (torch.randn(k, k, cin, cout, device="cuda", generator=gen)
                 * math.sqrt(2.0 / (k * k * cin))).to(dt)
            return x, w

        for name, n, hw, cin, cout, k, s, p, per_fwd in RESNET50_GATED:
            x, w = conv_inputs(n, hw, cin, cout, k)
            pad = ((p, p), (p, p))
            la = _launch_args(x, w, (s, s), pad)
            out = fused_conv(x, w, (s, s), pad)
            torch.cuda.synchronize()
            ref = fused_conv_reference(x.float(), w.float(), (s, s), pad)[0]
            err = check(out, ref, dtype, "%s %s" % (name, dtype))
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            kern = lambda: fused_conv(x, w, (s, s), pad)
            lib = lambda: F.conv2d(xn, wn, stride=s, padding=p)
            bms, by = conv_bound_ms(x, w, out.numel(), dtype)
            row = dict(shape=name, dtype=dtype, per_forward=per_fwd,
                       max_abs_err=err, ms=cuda_ms(kern),
                       plain_ms=cuda_ms(lambda: fused_conv_reference(
                           x, w, (s, s), pad)),
                       library_ms=cuda_ms(lib), bound_ms=bms, bound_by=by,
                       graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                       host_us=host_us(kern), library_host_us=host_us(lib))
            rows.append(row)
            print("%s  eager: kernel %.4f ms  plain %.4f ms  F.conv2d %.4f ms;"
                  "  graph replay: kernel %.4f ms  F.conv2d %.4f ms "
                  "(kernel/F.conv2d %.3f);  bound %.4f ms (%s), share %.3f of "
                  "it by graph replay;  host issue: kernel %.1f us  F.conv2d "
                  "%.1f us;  x%d per forward" % (
                      conv_row_line(name, dtype, err, la), row["ms"],
                      row["plain_ms"], row["library_ms"], row["graph_ms"],
                      row["library_graph_ms"],
                      row["graph_ms"] / row["library_graph_ms"], bms, by,
                      bms / row["graph_ms"], row["host_us"],
                      row["library_host_us"], per_fwd), flush=True)
        # a Cout tile tail (96 = 64 + 32), and x at a storage offset that
        # breaks 16-byte alignment (element-wise A staging)
        for name, n, hw, cin, cout, k, s, p, offset in (
                ("3x3 64->96 @28 tail", 4, 28, 64, 96, 3, 1, 1, 0),
                ("1x1 64->64 @56 view+1", 2, 56, 64, 64, 1, 1, 0, 1)):
            x, w = conv_inputs(n, hw, cin, cout, k, offset)
            pad = ((p, p), (p, p))
            la = _launch_args(x, w, (s, s), pad)
            out = fused_conv(x, w, (s, s), pad)
            ref = fused_conv_reference(x.float(), w.float(), (s, s), pad)[0]
            err = check(out, ref, dtype, "%s %s" % (name, dtype))
            print(conv_row_line(name, dtype, err, la))
            rows.append(dict(shape=name, dtype=dtype, per_forward=0,
                             max_abs_err=err))
        # odd shape, stride 2, asymmetric padding, through the plain check
        x = torch.randn(3, 17, 13, 5, device="cuda", generator=gen).to(dt)
        w = (0.3 * torch.randn(3, 3, 5, 24, device="cuda",
                               generator=gen)).to(dt)
        pad = ((1, 0), (2, 1))
        la = _launch_args(x, w, (2, 2), pad)
        out = fused_conv(x, w, (2, 2), pad)
        ref = fused_conv_reference(x.float(), w.float(), (2, 2), pad)[0]
        err = check(out, ref, dtype, "odd stride-2 " + dtype)
        print(conv_row_line("odd 17x13 s2", dtype, err, la))
        rows.append(dict(shape="odd 17x13 s2", dtype=dtype, per_forward=0,
                         max_abs_err=err))
        # the full epilogue: scale + bias + residual + relu, raw conv too
        x = torch.randn(2, 28, 28, 64, device="cuda", generator=gen).to(dt)
        w = (0.05 * torch.randn(3, 3, 64, 64, device="cuda",
                                generator=gen)).to(dt)
        sc = torch.rand(64, device="cuda", generator=gen) + 0.5
        bi = 0.1 * torch.randn(64, device="cuda", generator=gen)
        for res_dt in sorted({dt, torch.float32}, key=str):
            res = torch.randn(2, 28, 28, 64, device="cuda",
                              generator=gen).to(res_dt)
            pad = ((1, 1), (1, 1))
            out, craw = fused_conv_with_raw(x, w, (1, 1), pad, scale=sc,
                                            bias=bi, residual=res, relu=True)
            r_out, r_craw = fused_conv_reference(
                x.float(), w.float(), (1, 1), pad, sc, bi, res, True)
            e1 = check(out, r_out, dtype, "epilogue out " + dtype)
            e2 = check(craw, r_craw, "float32", "epilogue raw conv " + dtype)
            print("kernel fused_conv epilogue %s residual %s err out %.3g "
                  "raw %.3g" % (dtype, str(res_dt).split(".")[-1], e1, e2))
            rows.append(dict(shape="epilogue", dtype=dtype, per_forward=0,
                             max_abs_err=max(e1, e2)))
    return rows


def build_net(arrays=None):
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import vision
    with mt.layout("NHWC"):
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():   # settle the deferred shapes at a small size
        net(torch.zeros(1, 32, 32, 3))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=0)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def serve(pred, reqs, kernel):
    """The main path: answer every request once. Returns the outputs, the
    wall seconds and the launches of ``kernel`` (a wrapper with a
    ``launches`` count) counted during exactly this run."""
    import torch
    kernel.launches = 0
    t0 = time.time()
    outs = [pred.predict(x) for x in reqs]
    torch.cuda.synchronize()
    return outs, time.time() - t0, kernel.launches


def closed_loop(pred, x, n=50):
    """One client, each request synchronised: (median ms, p80 ms, median
    host-issue ms) over ``n`` requests of ``x`` after 3 warm ones; 50
    samples give a p80 with 10 samples beyond it."""
    return closed_loop_fn(lambda: pred.predict(x), n)


def closed_loop_fn(fn, n=50):
    """closed_loop for any call ``fn`` (the eager forward beside the
    captured one)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples, enqueue = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()   # the host has issued the forward
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0))
        enqueue.append(1e3 * (t1 - t0))
    samples.sort()
    enqueue.sort()
    return samples[n // 2], samples[(4 * n) // 5], enqueue[n // 2]


def eager(pred, x):
    """The Predictor's forward over its snapshot run eagerly on ``x`` (a
    bucket-shaped input on its device): what one bucket computed before
    it was captured, for comparison only; the Predictor never serves
    this way on the card."""
    import torch
    with torch.no_grad():
        return pred._forward(x)[0]


def check_graphs(pred, spec, what):
    """One captured CUDA graph per bucket, and the builds at the
    Predictor's own retrace site still equal to the number of buckets."""
    from mxtpu_torch.graphs import CapturedGraph
    graphs = [g for g in pred._buckets.values()
              if isinstance(g, CapturedGraph)]
    compiles = pred.compile_stats()["compiles"]
    if len(graphs) != len(spec) or len(pred._buckets) != len(spec) or \
            compiles != len(spec):
        raise AssertionError("%s: %d captured graphs, %d buckets, %d builds "
                             "at %s; expected %d of each" % (
                                 what, len(graphs), len(pred._buckets),
                                 compiles, pred.site, len(spec)))
    return len(graphs)


def replay_vs_eager(pred, x, what):
    """The replayed bucket against the same forward run eagerly on the
    card; the largest difference (0 when bit-equal)."""
    got = pred.predict(x).to_torch()
    ref = eager(pred, x)
    diff = (got.float() - ref.float()).abs().max().item()
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise AssertionError("%s: replay gave %s, eager %s" % (
            what, tuple(got.shape), tuple(ref.shape)))
    return diff


def device_breakdown(pred, x, forwards=5):
    """Device kernel time per forward by kernel name, from torch.profiler
    (CUPTI), over ``forwards`` back-to-back predicts of ``x``."""
    return device_rows(lambda: pred.predict(x), forwards)


PROFILE_WARMUP_S = 0.05   # traced but not counted (see device_rows)


def device_rows(fn, reps):
    """(kernel name, device ms per call, launches per call) of ``reps``
    back-to-back calls of ``fn``, from torch.profiler (CUPTI). Calls of
    ``fn`` for at least ``PROFILE_WARMUP_S`` and then a marker kernel
    (``torch.cuda._sleep``) run first in the trace, and only the device
    events that start after the marker count: a trace loses kernels while
    tracing starts (one run counted 22 fused convs over three
    graph-replayed ResNet-50 forwards that launch 11 each; another lost a
    marker that followed one 0.5 ms imperative step)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() - t0 >= PROFILE_WARMUP_S:
                break
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    if len(marks) != 1:
        raise AssertionError("torch.profiler: %d marker kernels in the "
                             "trace, expected 1" % len(marks))
    ms, count = collections.Counter(), collections.Counter()
    for e in events:
        if e.time_range.start > marks[0] and e.time_range.elapsed_us() > 0:
            ms[e.name] += e.time_range.elapsed_us() / 1e3 / reps
            count[e.name] += 1.0 / reps
    return sorted(((k, ms[k], count[k]) for k in ms), key=lambda r: -r[1])


def served_buckets(label, pred, cases, card, kernel_key, per_forward,
                   rate):
    """Per bucket: the closed-loop latency of the captured graph and of the
    same forward run eagerly, side by side, then a profiled call of the
    largest case both ways (device ms, idle share); the builds stay at
    the number of buckets throughout. ``cases``: [(name, x, items)]."""
    parts = []
    for name, x, items in cases:
        graph = closed_loop(pred, x)
        plain = closed_loop_fn(lambda: eager(pred, x))
        idle = [1 - sum(r[1] for r in device_rows(fn, 3)) / wall
                for fn, wall in ((lambda: pred.predict(x), graph[0]),
                                 (lambda: eager(pred, x), plain[0]))]
        parts.append("%s %s/s %.0f (%.3f, %.3f, %.3f, idle %.3f) eager %.0f "
                     "(%.3f, %.3f, %.3f, idle %.3f)" % (
                         (name, rate, 1e3 * items / graph[0]) + graph
                         + (idle[0], 1e3 * items / plain[0]) + plain
                         + (idle[1],)))
        last = (x, graph, plain)
    print("serve %s on %s, per bucket: %s at the median latency (median "
          "ms, p80 ms, median host-issue ms; 50 requests; idle share of a "
          "profiled call against that median), captured graph then eager: "
          "%s" % (label, card, rate, ", ".join(parts)), flush=True)
    x, graph, plain = last
    name = cases[-1][0]
    print_breakdown("serve %s %s graph" % (label, name),
                    device_rows(lambda: pred.predict(x), 3), graph[0],
                    kernel_key, per_forward)
    print_breakdown("serve %s %s eager" % (label, name),
                    device_rows(lambda: eager(pred, x), 3), plain[0],
                    kernel_key, per_forward)
    check_graphs(pred, pred.spec, label)


def resnet_serve_phase(card):
    """Serve resnet50_v1 in f32, then bf16, each bucket a captured CUDA
    graph; returns the fused-conv launches each main-path run counted."""
    import numpy as np
    import torch
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.serving import BucketSpec, Predictor
    spec = BucketSpec.pow2(8)
    dispatches = sum(-(-b // spec.max_batch) for b in REQUESTS)
    rng = np.random.default_rng(1)
    reqs = [rng.standard_normal((b, 224, 224, 3)).astype(np.float32)
            for b in REQUESTS]
    net, arrays = build_net()
    cpu_net, _ = build_net(arrays)
    launches_by_dtype = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        dt = getattr(torch, dtype)
        if dtype == "bfloat16":
            net.cast("bfloat16")
            cpu_net.cast("bfloat16")
        cpu_pred = Predictor(cpu_net, spec, device="cpu",
                             site="cpu.resnet50." + dtype)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pred = Predictor(net, spec, example=torch.zeros(1, 224, 224, 3,
                                                        dtype=dt),
                         warmup=True, device="cuda",
                         site="serving.predict.resnet50." + dtype)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        graphs = check_graphs(pred, spec, "resnet50_v1 " + dtype)
        xs = [torch.from_numpy(x).to(dt) for x in reqs]
        outs, wall, launches = serve(pred, xs, fused_conv)
        if launches != 11 * dispatches:
            raise AssertionError("%s: fused_conv launched %d times over %d "
                                 "forwards, expected %d" % (
                                     dtype, launches, dispatches,
                                     11 * dispatches))
        check_graphs(pred, spec, "resnet50_v1 %s after traffic" % dtype)
        errs = []
        for x, out in zip(xs, outs):
            ref = cpu_pred.predict(x).to_torch().float()
            got = out.to_torch().float().cpu()
            if tuple(got.shape) != (x.shape[0], 1000) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError("%s: bad logits %s" % (dtype,
                                                            tuple(got.shape)))
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            if err > tol:
                raise AssertionError("%s: logits differ from the CPU run by "
                                     "%.3g of max|logit| (limit %g)"
                                     % (dtype, err, tol))
            errs.append(err)
        x8 = xs[-1][:spec.max_batch].to("cuda")
        diff = replay_vs_eager(pred, x8, "resnet50_v1 " + dtype)
        print("serve resnet50_v1 %s: warmup (%d graphs captured) %.2f s, "
              "peak memory after warmup %.3f GiB, %d requests %s in %.3f s, "
              "fused_conv launches %d (= 11 x %d forwards), max rel err vs "
              "CPU %.3g, b8 replay vs eager on the card max abs diff %.3g"
              % (dtype, graphs, warm_s, peak, len(REQUESTS), list(REQUESTS),
                 wall, launches, dispatches, max(errs), diff), flush=True)
        cases = [("b%d" % b, xs[-1][:b].to("cuda"), b)
                 for b in spec.batch_sizes]
        served_buckets("resnet50_v1 " + dtype, pred, cases, card,
                       "fused_conv_", 11, "images")
        launches_by_dtype[dtype] = launches
    return launches_by_dtype


def print_breakdown(label, rows, wall_ms, kernel_key, per_call=None):
    """Device ms per call, the idle share against the unprofiled median
    wall time, the named kernel's ms and the top kernels. ``per_call``:
    the named kernel's launches one call
    must show in the profiler (a graph's replayed kernels appear there by
    name, so this cross-checks the wrappers' launch counts)."""
    dev_ms = sum(r[1] for r in rows)
    if dev_ms <= 0:
        raise AssertionError("%s: torch.profiler saw no CUDA kernels"
                             % label)
    mine = sum(r[1] for r in rows if kernel_key in r[0])
    count = sum(r[2] for r in rows if kernel_key in r[0])
    if per_call is not None and round(count) != per_call:
        raise AssertionError("%s: the profiler counts %g %s kernels per "
                             "call, expected %d" % (label, count, kernel_key,
                                                    per_call))
    print("%s per call: wall %.3f ms (median, unprofiled), device "
          "kernels %.3f ms (idle share %.3f), %s %.3f ms x%g, %d kernel "
          "launches" % (label, wall_ms, dev_ms, 1 - dev_ms / wall_ms,
                        kernel_key, mine, count,
                        round(sum(r[2] for r in rows))))
    for name, ms, count in rows[:8]:
        print("  %.4f ms  x%-4g %s" % (ms, count, name[:110]))


def flash_inputs(b, h, t, tk, d, dt, layout, gen):
    """q, k, v on the card: tensors of their own, or (layout "qkv", t ==
    tk) the strided views of one [B, T, 3, H, D] projection."""
    import torch
    if layout == "qkv":
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(dt)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]
    return [torch.randn(b, h, n, d, device="cuda", generator=gen).to(dt)
            for n in (t, tk, tk)]


def flash_phase():
    """Hold the flash kernel (out and lse) against its plain version at
    every FLASH_SHAPES entry in f32 and bf16, and time the served ones."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.flash_attention import (
        _launch_args, flash_attention_reference, flash_attention_with_lse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    print("flash kernel checks against the plain version: out by the rule "
          "above, lse (float32) by the float32 rule")
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, b, h, t, tk, d, causal, per_fwd, layout in FLASH_SHAPES:
            q, k, v = flash_inputs(b, h, t, tk, d, dt, layout, gen)
            la = _launch_args(q, k, v, causal, None)
            out, lse = flash_attention_with_lse(q, k, v, causal=causal)
            torch.cuda.synchronize()
            r_out, r_lse = flash_attention_reference(
                q.float(), k.float(), v.float(), causal)
            err = check(out, r_out, dtype, "flash %s %s" % (name, dtype))
            lerr = check(lse, r_lse, "float32", "flash lse %s %s"
                         % (name, dtype))
            line = ("kernel flash_attention %-26s %-8s err %.3g lse %.3g "
                    "(%s staging, %d warpgroup(s) x %d rows, %d slice(s))"
                    % (name, dtype, err, lerr,
                       "16-byte async" if la.vec else "element-wise",
                       la.warpgroups, la.block_q, la.slices))
            if not name.startswith("b8"):
                print(line)
                rows.append(dict(shape=name, dtype=dtype, per_forward=0,
                                 max_abs_err=err))
                continue
            kern = lambda: flash_attention_with_lse(q, k, v, causal)
            sdpa = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)
            ms, lib = cuda_ms(kern), cuda_ms(sdpa)
            plain = cuda_ms(lambda: flash_attention_reference(q, k, v,
                                                              causal))
            graph, graph_lib = graph_ms(kern), graph_ms(sdpa)
            host, host_lib = host_us(kern), host_us(sdpa)
            n_bytes = (q.numel() + out.numel() + k.numel() + v.numel()) \
                * q.element_size() + 4 * lse.numel()
            flops = 4.0 * b * h * t * tk * d * (0.5 if causal else 1.0)
            bms, by = bound_ms(n_bytes, flops, dtype)
            rows.append(dict(shape=name, dtype=dtype, per_forward=per_fwd,
                             max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bms, bound_by=by,
                             graph_ms=graph, library_graph_ms=graph_lib,
                             host_us=host, library_host_us=host_lib))
            print("%s  eager back-to-back: kernel %.4f ms  plain %.4f ms  "
                  "sdpa %.4f ms  bound %.4f ms (%s)  kernel/sdpa %.3f  bound "
                  "share %.3f  x%d per b8x512 forward; graph replay: kernel "
                  "%.4f ms  sdpa %.4f ms (kernel/sdpa %.3f); host issue: "
                  "kernel %.1f us  sdpa %.1f us" % (
                      line, ms, plain, lib, bms, by, ms / lib, bms / ms,
                      per_fwd, graph, graph_lib, graph / graph_lib, host,
                      host_lib), flush=True)
        for scale in FLASH_SCALES:
            for causal in (True, False):
                q, k, v = flash_inputs(2, 3, 77, 77, 64, dt, "contig", gen)
                out, lse = flash_attention_with_lse(q, k, v, causal, scale)
                r_out, r_lse = flash_attention_reference(
                    q.float(), k.float(), v.float(), causal, scale)
                what = "scale %g%s %s" % (scale, " causal" * causal, dtype)
                err = check(out, r_out, dtype, "flash b2 h3 T77 d64 " + what)
                lerr = check(lse, r_lse, "float32", "flash lse " + what)
                print("kernel flash_attention b2 h3 T77 d64 %s err %.3g lse "
                      "%.3g" % (what, err, lerr))
                rows.append(dict(shape="T77 " + what, dtype=dtype,
                                 per_forward=0, max_abs_err=err))
    return rows


def build_lm(arrays=None):
    """The BERT-base-shaped TransformerLM on the CPU with seeded weights."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(**BERT_BASE)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():   # settle the deferred shapes at a small size
        net(torch.zeros(1, 8, dtype=torch.int32))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=0)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def lm_serve_phase(card):
    """Serve the TransformerLM in f32, then bf16, each bucket a captured
    CUDA graph; returns the flash launches each main-path run counted."""
    import numpy as np
    import torch
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.serving import BucketSpec, Predictor
    spec = BucketSpec.pow2(8, seq_lens=SEQ_BUCKETS)
    layers = BERT_BASE["num_layers"]
    dispatches = sum(-(-b // spec.max_batch) for b, _ in LM_REQUESTS)
    rng = np.random.default_rng(3)
    reqs = [torch.from_numpy(rng.integers(0, BERT_BASE["vocab_size"], (b, t),
                                          dtype=np.int32))
            for b, t in LM_REQUESTS]
    net, arrays = build_lm()
    cpu_net, _ = build_lm(arrays)
    launches_by_dtype = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        if dtype == "bfloat16":
            net.cast("bfloat16")
            cpu_net.cast("bfloat16")
        cpu_pred = Predictor(cpu_net, spec, device="cpu",
                             site="cpu.transformer_lm." + dtype)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pred = Predictor(net, spec, example=torch.zeros(1, 128,
                                                        dtype=torch.int32),
                         warmup=True, device="cuda",
                         site="serving.predict.transformer_lm." + dtype)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        graphs = check_graphs(pred, spec, "transformer_lm " + dtype)
        outs, wall, launches = serve(pred, reqs, flash_attention)
        if launches != layers * dispatches:
            raise AssertionError("%s: flash_attention launched %d times over "
                                 "%d forwards, expected %d" % (
                                     dtype, launches, dispatches,
                                     layers * dispatches))
        check_graphs(pred, spec, "transformer_lm %s after traffic" % dtype)
        errs, cpu_s = [], []
        for x, out in zip(reqs, outs):
            t0 = time.time()
            ref = cpu_pred.predict(x).to_torch().float()
            cpu_s.append(time.time() - t0)
            got = out.to_torch().float().cpu()
            shape = (x.shape[0], spec.seq_bucket(x.shape[1]),
                     BERT_BASE["vocab_size"])
            if tuple(got.shape) != shape or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError("%s: bad logits %s, expected %s"
                                     % (dtype, tuple(got.shape), shape))
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            if err > tol:
                raise AssertionError("%s: logits of request %s differ from "
                                     "the CPU run by %.3g of max|logit| "
                                     "(limit %g)" % (dtype, tuple(x.shape),
                                                     err, tol))
            errs.append(err)
        x = reqs[3].to("cuda")                     # the (8, 512) request
        diff = replay_vs_eager(pred, x, "transformer_lm " + dtype)
        print("serve transformer_lm %s: warmup (%d graphs captured) %.2f s, "
              "peak memory after warmup %.3f GiB, requests %s in %.3f s, "
              "flash_attention launches %d (= %d x %d forwards), max rel "
              "err vs CPU %.3g, b8 x 512 replay vs eager on the card max "
              "abs diff %.3g; CPU run %.1f s (%s)"
              % (dtype, graphs, warm_s, peak, list(LM_REQUESTS), wall,
                 launches, layers, dispatches, max(errs), diff, sum(cpu_s),
                 ", ".join("%.1f" % c for c in cpu_s)), flush=True)
        cells = [(b, 512) for b in spec.batch_sizes] + [(8, 128), (8, 256)]
        cases = [("b%d x %d" % (b, t), x[:b, :t], b * t) for b, t in
                 cells[-2:] + cells[:-2]]
        served_buckets("transformer_lm " + dtype, pred, cases, card,
                       "flash_attention_", layers, "tokens")
        launches_by_dtype[dtype] = launches
    return launches_by_dtype


def int8_phase():
    """int8 weights on the card: ResNet-50 v1 and the TransformerLM in
    float32 with ``int8=True``, each against the port's int8 Predictor on
    the CPU from the same weights (1e-3 of max|logit|: the dequantized
    weights are the same, the float32 forwards differ by rounding) and
    beside the float32 logits. For each card Predictor: the bytes of its
    parameter snapshot, and the device memory that its build and warm-up
    took at peak (``max_memory_allocated`` over what was allocated before)
    and that it holds after (``memory_reserved`` growth after
    ``empty_cache``: its snapshot, static buffers and graph pool)."""
    import numpy as np
    import torch
    from mxtpu_torch.serving import BucketSpec, Predictor
    rng = np.random.default_rng(7)
    cells = [
        ("resnet50_v1", build_net, BucketSpec.pow2(8),
         torch.zeros(1, 224, 224, 3),
         [torch.from_numpy(rng.standard_normal((b, 224, 224, 3)).astype(
             np.float32)) for b in (3, 8)]),
        ("transformer_lm", build_lm, BucketSpec.pow2(8, seq_lens=SEQ_BUCKETS),
         torch.zeros(1, 128, dtype=torch.int32),
         [torch.from_numpy(rng.integers(0, BERT_BASE["vocab_size"], shape,
                                        dtype=np.int32))
          for shape in ((2, 200), (1, 512))]),
    ]
    for name, build, spec, example, reqs in cells:
        net, _ = build()
        preds, mem = {}, {}
        for kind, device, int8 in (("int8", "cuda", True),
                                   ("int8 cpu", "cpu", True),
                                   ("float32", "cuda", False)):
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                alloc0 = torch.cuda.memory_allocated()
                reserved0 = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
            preds[kind] = Predictor(
                net, spec, example=example, warmup=device == "cuda",
                device=device, int8=int8,
                site="serving.predict.%s.%s" % (name, kind))
            if device == "cuda":
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - alloc0
                torch.cuda.empty_cache()
                mem[kind] = (peak, torch.cuda.memory_reserved() - reserved0)
        check_graphs(preds["int8"], spec, name + " int8")
        errs, vs_f32 = [], []
        for x in reqs:
            got = preds["int8"].predict(x).to_torch().float().cpu()
            ref = preds["int8 cpu"].predict(x).to_torch().float()
            f32 = preds["float32"].predict(x).to_torch().float().cpu()
            if got.shape != ref.shape or not bool(got.isfinite().all()):
                raise AssertionError("%s int8: bad logits %s" % (
                    name, tuple(got.shape)))
            scale = ref.abs().max().item()
            errs.append((got - ref).abs().max().item() / scale)
            vs_f32.append((got - f32).abs().max().item() / scale)
            if errs[-1] > 1e-3:
                raise AssertionError("%s int8 on the card differs from int8 "
                                     "on the CPU by %.3g of max|logit|"
                                     % (name, errs[-1]))
        check_graphs(preds["int8"], spec, name + " int8 after traffic")
        print("int8 %s: requests %s, card vs CPU int8 max rel err %.3g "
              "(limit 1e-3), int8 vs float32 logits on the card %.3g of "
              "max|logit|; parameter snapshot bytes int8 %d, float32 %d "
              "(%.3f); device bytes at peak in build+warmup int8 %d, "
              "float32 %d; held after warmup int8 %d, float32 %d" % (
                  name, [tuple(x.shape) for x in reqs], max(errs),
                  max(vs_f32), preds["int8"].param_bytes(),
                  preds["float32"].param_bytes(),
                  preds["int8"].param_bytes()
                  / preds["float32"].param_bytes(),
                  mem["int8"][0], mem["float32"][0], mem["int8"][1],
                  mem["float32"][1]), flush=True)
        del preds
        torch.cuda.empty_cache()


def hybridize_phase():
    """``net.hybridize(); net(x)`` on the card: ResNet-50 v1 in bf16, two
    input signatures called three times each with autograd's gradient
    mode on (not recording: the calls are captured all the same), equal
    to the eager forward bit for bit, one graph captured per signature
    (retrace site ``cached_op``), 11 conv launches per call; then one
    call in train mode (not recording), a graph of its own, equal to the
    eager train-mode forward (BatchNorm by the batch's statistics)."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import telemetry
    from mxtpu_torch.ops.pallas.conv import fused_conv
    net, _ = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    net.cast("bfloat16")
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy(rng.standard_normal((b, 224, 224, 3)).astype(
        np.float32)).to("cuda", torch.bfloat16) for b in (2, 8)]
    with torch.no_grad():
        # first the train-mode forward: it reads only the batch's
        # statistics, and its update of the moving ones is in place
        # before the predict-mode refs read them
        with mt.autograd.train_mode():
            ref_train = net(xs[1])
        refs = [net(x) for x in xs]
    before = (telemetry.retrace_stats("cached_op") or {}).get("compiles", 0)
    net.hybridize()
    calls = 0
    for rnd in range(3):
        if rnd == 1:   # the captures' eager warm-up runs launched too
            torch.cuda.synchronize()
            fused_conv.launches, calls = 0, 0
        for x, ref in zip(xs, refs):
            out = net(x)
            calls += 1
            if not torch.equal(out, ref):
                raise AssertionError(
                    "hybridized resnet50_v1 b%d differs from eager by "
                    "%.3g" % (x.shape[0], (out.float() - ref.float())
                              .abs().max().item()))
    torch.cuda.synchronize()
    captures = telemetry.retrace_stats("cached_op")["compiles"] - before
    if captures != len(xs) or len(net._cached_op._graphs) != len(xs) or \
            fused_conv.launches != 11 * calls:
        raise AssertionError("hybridize: %d captures for %d signatures, %d "
                             "conv launches over %d calls" % (
                                 captures, len(xs), fused_conv.launches,
                                 calls))
    launches = fused_conv.launches
    with mt.autograd.train_mode():
        out = net(xs[1])
    captures = telemetry.retrace_stats("cached_op")["compiles"] - before
    if not torch.equal(out, ref_train) or captures != len(xs) + 1:
        raise AssertionError(
            "hybridize in train mode: %d captures for %d signatures, "
            "differs from the eager train-mode forward by %.3g" % (
                captures, len(xs) + 1,
                (out.float() - ref_train.float()).abs().max().item()))
    net.hybridize(False)
    print("hybridize resnet50_v1 bf16 on the card: 6 calls at b2 and b8 "
          "with gradient mode on, bit-equal to eager, %d graphs captured "
          "(one per signature, the train-mode b8 call its own, bit-equal "
          "to eager train mode), fused_conv launches %d over the 4 calls "
          "after the first round (= 11 x %d)" % (
              captures, launches, calls), flush=True)


def _percentile(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def _stage_medians(breakdowns):
    """The median ms of each stage over the requests' breakdowns
    (``{stage: ms}`` each)."""
    stages = sorted({k for b in breakdowns for k in b})
    return ", ".join("%s %.3f" % (k.replace("serving.", ""), _percentile(
        [b.get(k, 0.0) for b in breakdowns], 0.5)) for k in stages)


def _run_clients(n_threads, per_thread, work):
    """Run ``work(k, i)`` for i < per_thread on each of n_threads threads;
    every join has a timeout and any failure raises."""
    import threading
    errors = []

    def client(k):
        for i in range(per_thread):
            try:
                work(k, i)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append("%s: %s" % (type(e).__name__, e))
                return

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("clients failed or hung: %s" % errors[:3])
    return wall


def _run_clients_for(n_threads, least, window_s, work):
    """Run ``work(k, i)`` on n_threads threads until at least ``least``
    calls have finished and ``window_s`` seconds have passed; every join
    has a timeout and any failure raises. Returns (calls, seconds)."""
    import threading
    errors, lock, done = [], threading.Lock(), [0]

    def client(k):
        i = 0
        while True:
            with lock:
                if done[0] >= least and \
                        time.perf_counter() - t0 >= window_s:
                    return
            try:
                work(k, i)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append("%s: %s" % (type(e).__name__, e))
                return
            with lock:
                done[0] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300 + window_s)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("clients failed or hung: %s" % errors[:3])
    return done[0], wall


def _spread(xs):
    """(max - min) / mean of a list of rates."""
    return (max(xs) - min(xs)) / (sum(xs) / len(xs))


def batcher_phase(card):
    """The TransformerLM in bf16 through a MicroBatcher (max_batch 8,
    max_wait 5 ms) over a one-replica ReplicaSet on cuda:0: 8 client
    threads send 16 single-sequence requests each, lengths drawn from
    {40, 100, 200, 300, 512}; each answer held to the same request's
    direct predict within 5e-2 of max|logit|; no request shed."""
    import numpy as np
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.serving import BucketSpec, ReplicaDispatcher, ReplicaSet
    net, _ = build_lm()
    net.cast("bfloat16")
    spec = BucketSpec.pow2(8, seq_lens=SEQ_BUCKETS)
    telemetry.reset()   # the phase's counters, its captures included
    rs = ReplicaSet(net, spec, n=1, example=torch.zeros(1, 128,
                                                        dtype=torch.int32))
    pred = rs.replicas[0].predictor
    if str(rs.replicas[0].device) != "cuda:0":
        raise AssertionError("the replica is on %s" % rs.replicas[0].device)
    rng = np.random.default_rng(9)
    lengths = rng.choice([40, 100, 200, 300, 512], size=(8, 16))
    reqs = [[rng.integers(0, BERT_BASE["vocab_size"], (1, int(t)),
                          dtype=np.int32) for t in row] for row in lengths]
    answers = {}
    flash_attention.launches = 0
    bat = ReplicaDispatcher(rs, max_batch_size=8, max_wait_ms=5)

    breakdowns = []

    def work(k, i):
        t0 = time.perf_counter()
        fut = bat.submit(reqs[k][i])
        out = fut.result(timeout=120)
        ms = 1e3 * (time.perf_counter() - t0)
        breakdowns.append({k_: 1e3 * v for k_, v in fut.breakdown.items()})
        # the request's own positions, copied: the answer is a view of
        # its whole batch's logits
        answers[(k, i)] = (out[:, :reqs[k][i].shape[1]].copy(), ms)

    try:
        wall = _run_clients(8, 16, work)
    finally:
        bat.close(timeout=60)
    launches = flash_attention.launches
    batches = telemetry.value("serving.batches")
    shed = telemetry.value("serving.shed")
    fill = telemetry.snapshot()["histograms"]["serving.batch_fill"]
    if len(answers) != 128 or shed != 0 or \
            launches != BERT_BASE["num_layers"] * batches:
        raise AssertionError("batcher: %d answers, %d shed, %d flash "
                             "launches over %d batches" % (
                                 len(answers), shed, launches, batches))
    check_graphs(pred, spec, "batcher transformer_lm bf16")
    worst = 0.0
    for (k, i), (out, _) in list(answers.items()):
        t = reqs[k][i].shape[1]
        ref = pred.predict(reqs[k][i]).asnumpy()[:, :t]
        answers[(k, i)] = (None, answers[(k, i)][1])
        if out.shape != ref.shape or not np.isfinite(out).all():
            raise AssertionError("batcher: answer %s vs direct %s"
                                 % (out.shape, ref.shape))
        err = float(np.abs(out - ref).max() / np.abs(ref).max())
        if err > 5e-2:
            raise AssertionError("batcher: request (%d, %d) differs from "
                                 "its direct predict by %.3g of max|logit|"
                                 % (k, i, err))
        worst = max(worst, err)
    check_graphs(pred, spec, "batcher transformer_lm bf16 after traffic")
    e2e = [ms for _, ms in answers.values()]
    print("batcher transformer_lm bf16 on %s (MicroBatcher max_batch 8, "
          "max_wait 5 ms, one replica on cuda:0; 8 threads x 16 requests, "
          "lengths %s): %.1f requests/s, end-to-end p50 %.3f ms p99 %.3f ms, "
          "%d batches, mean batch fill %.3f, shed %d, flash launches %d (= "
          "12 x %d batches), max rel err vs direct predict %.3g; median ms "
          "by stage: %s" % (
              card, sorted(set(int(t) for t in lengths.flat)), 128 / wall,
              _percentile(e2e, 0.5), _percentile(e2e, 0.99), batches,
              fill["mean"], shed, launches, batches, worst,
              _stage_medians(breakdowns)), flush=True)


def http_phase(card):
    """ModelServer on 127.0.0.1:0 over ResNet-50 v1 bf16: 8 client threads
    send 8 single-image POST /predict each, held to direct predict within
    5e-2 of max|logit|; /healthz answers ok and /metrics counts 64
    requests; after begin_drain() the requests already queued finish and
    a POST gets 503."""
    import json
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.serving import (BucketSpec, MicroBatcher, ModelServer,
                                     Predictor)
    net, _ = build_net()
    net.cast("bfloat16")
    spec = BucketSpec.pow2(8)
    telemetry.reset()   # the phase's counters, its captures included
    pred = Predictor(net, spec, example=torch.zeros(1, 224, 224, 3,
                                                    dtype=torch.bfloat16),
                     warmup=True, device="cuda",
                     site="serving.predict.http")
    srv = ModelServer(MicroBatcher(pred, max_batch_size=8, max_wait_ms=5))
    srv.start()
    url = "http://%s:%d" % srv.address
    rng = np.random.default_rng(10)
    images = [[rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
               for _ in range(8)] for _ in range(8)]
    bodies = [[json.dumps({"data": x.tolist()}).encode() for x in row]
              for row in images]
    answers = {}

    def post(body):
        req = urllib.request.Request(url + "/predict", data=body, headers={
            "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def work(k, i):
        t0 = time.perf_counter()
        code, out = post(bodies[k][i])
        if code != 200:
            raise AssertionError("POST /predict answered %d: %s"
                                 % (code, out))
        answers[(k, i)] = (np.asarray(out["outputs"][0], np.float32),
                           1e3 * (time.perf_counter() - t0), out)

    try:
        wall = _run_clients(8, 8, work)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        if health["status"] != "ok" or \
                metrics["counters"]["serving.requests"] != 64:
            raise AssertionError("healthz %s, metrics serving.requests %s"
                                 % (health, metrics["counters"].get(
                                     "serving.requests")))
        queued = [srv.batcher.submit(images[0][i]) for i in range(4)]
        drained = srv.begin_drain(timeout=60)
        done = [f.result(timeout=60) for f in queued]
        code, out = post(bodies[0][0])
        if not drained or code != 503 or len(done) != 4:
            raise AssertionError("drain: drained %s, %d queued finished, "
                                 "POST after it answered %d" % (
                                     drained, len(done), code))
    finally:
        srv.close(timeout=60)
    worst = 0.0
    for (k, i), (got, _, _) in answers.items():
        ref = pred.predict(images[k][i]).asnumpy()
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        if got.shape != (1, 1000) or err > 5e-2:
            raise AssertionError("http: answer %s differs from direct "
                                 "predict by %.3g" % (got.shape, err))
        worst = max(worst, err)
    check_graphs(pred, spec, "http resnet50_v1 bf16 after traffic")
    e2e = [ms for _, ms, _ in answers.values()]
    print("http resnet50_v1 bf16 on %s (ModelServer on 127.0.0.1, "
          "MicroBatcher max_batch 8, max_wait 5 ms; 8 threads x 8 "
          "single-image POSTs): %.1f requests/s, client p50 %.3f ms p99 "
          "%.3f ms, server e2e_ms p50 %.3f, max rel err vs direct predict "
          "%.3g; /healthz %s, /metrics serving.requests 64; drain: 4 queued "
          "finished, then 503; median ms by stage: %s" % (
              card, 64 / wall, _percentile(e2e, 0.5), _percentile(e2e, 0.99),
              _percentile([a[2]["e2e_ms"] for a in answers.values()], 0.5),
              worst, health["status"], _stage_medians(
                  [a[2]["breakdown_ms"] for a in answers.values()])),
          flush=True)


RESNET_EXAMPLE_SHAPE = (1, 224, 224, 3)
# the control plane's decay horizon in these phases: short enough that the
# predictive sheds of one step stop counting as scale-up pressure a few
# seconds later (the reference's 60 s would hold them for minutes)
CONTROL_HORIZON_S = 2.0
# the zoo's HTTP rates: runs per model, and the least seconds of each run
HTTP_RUNS = 2
HTTP_WINDOW_S = 10.0


def _log_decisions(ctrl):
    """(t, action, reason) of every decision ``ctrl`` records, in order."""
    log = []
    record = ctrl._record

    def logged(action, reason, now, mark=True):
        log.append((time.perf_counter(), action, reason))
        return record(action, reason, now, mark)

    ctrl._record = logged
    return log


def _wait_for(what, cond, timeout):
    """Poll ``cond()`` every 10 ms until true; raises after ``timeout`` s."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("timed out after %.0f s waiting for %s"
                                 % (timeout, what))
        time.sleep(0.01)
    return time.perf_counter() - t0


class _Traffic:
    """``n_threads`` closed-loop clients on a dispatcher until ``stop()``:
    each sends single-image requests from ``images`` and records (t0, ms,
    image index, answer or the error)."""

    def __init__(self, bat, images, n_threads=4):
        import threading
        self.records = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._client, daemon=True,
                                          args=(bat, images, k))
                         for k in range(n_threads)]
        for t in self._threads:
            t.start()

    def _client(self, bat, images, k):
        i = k
        while not self._stop.is_set():
            x = images[i % len(images)]
            t0 = time.perf_counter()
            try:
                out = bat.submit(x).result(timeout=120)
            except Exception as e:  # noqa: BLE001 — recorded, gated later
                out = e
            with self._lock:
                self.records.append(
                    (t0, 1e3 * (time.perf_counter() - t0),
                     i % len(images), out))
            i += len(self._threads)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(180)
        if any(t.is_alive() for t in self._threads):
            raise AssertionError("a client thread hung")
        return self.records


def controller_phase(card):
    """The serving control plane on the card: ResNet-50 v1 bf16
    (``BucketSpec.pow2(8)``) through a ReplicaDispatcher over
    ``ReplicaSet(devices=["cuda:0", "cuda:0"])`` with
    ``ServingController(min 1, max 2, replace_after 2000 ms, cooldown
    1000 ms)``, threaded with the real clock. 1) warm the latency model
    with single-image and b8 requests; 2) requests whose deadline is half
    the predicted latency all shed ``predicted_miss``, none queued; 3) r1's
    dispatches fail until its breaker opens, the controller replaces it
    with r2 on cuda:0, captured on a thread of its own while r0 serves; 4)
    traffic stops and the controller scales down to one replica; 5) a
    scale-up on the one card is recorded and refused (``warmup_failed``).
    Returns the fused_conv launches of the phase."""
    import numpy as np
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.serving import (BucketSpec, QueueFull,
                                     ReplicaDispatcher, ReplicaFailure,
                                     ReplicaSet, ServingController)
    net, _ = build_net()
    net.cast("bfloat16")
    spec = BucketSpec.pow2(8)
    telemetry.reset()   # the phase's counters, its captures included
    t0 = time.perf_counter()
    # an hour-long probe backoff: r1's breaker stays open until replaced
    rs = ReplicaSet(net, spec, devices=["cuda:0", "cuda:0"],
                    example=torch.zeros(RESNET_EXAMPLE_SHAPE,
                                        dtype=torch.bfloat16),
                    breaker_backoff_ms=3600e3)
    warm_s = time.perf_counter() - t0
    bat = ReplicaDispatcher(rs, max_batch_size=8, max_wait_ms=5)
    ctrl = ServingController(bat, min_replicas=1, max_replicas=2,
                             replace_after_ms=2000, scale_cooldown_ms=1000,
                             horizon_s=CONTROL_HORIZON_S)
    log = _log_decisions(ctrl)
    failing = {"on": False}
    execute = bat._execute

    def fail_r1(rep, joined, idx, live=()):
        # the replica_fail fault aimed at r1: the resilience schedule names
        # dispatch indices, which land on either replica in threaded mode
        if failing["on"] and rep.index == 1:
            raise ReplicaFailure("injected replica_fail on r1 (dispatch "
                                 "%d)" % idx)
        return execute(rep, joined, idx, live)

    bat._execute = fail_r1

    def shed_half(n):
        """Submit ``n`` images whose deadline is half the predicted
        latency; each submit's outcome."""
        out = []
        for i in range(n):
            p = ctrl.predicted_s(None)
            if p is None:
                raise AssertionError("the latency model went cold")
            try:
                bat.submit(images[i], deadline_ms=0.5e3 * p)
                out.append("admitted")
            except QueueFull as e:
                out.append(str(e))
        return out

    rng = np.random.default_rng(11)
    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
              for _ in range(16)]
    b8 = [rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
          for _ in range(2)]
    answers = []            # (input, answer) of every delivered request
    fused_conv.launches = 0
    try:
        # 1) warm the latency model: single images and b8 requests
        totals = {1: [], 8: []}

        def work(k, i):
            x = b8[i % 2] if (k + i) % 4 == 0 else images[(k + i) % 16]
            fut = bat.submit(x)
            out = fut.result(timeout=120)
            answers.append((x, out))
            totals[x.shape[0]].append(sum(fut.breakdown.get(s, 0.0) for s in (
                "serving.queue_wait", "serving.pad", "serving.predict")))

        _run_clients(8, 12, work)
        predicted = ctrl.predicted_s(None)
        m = ctrl._models[None]
        hist = m["total"].quantile(0.9, bat._clock())
        print("controller warm: replicas r0, r1 on cuda:0 warmed in %.2f s "
              "(%d graphs each); latency model (one bucket key: ResNet-50 "
              "has no sequence buckets) from %d samples in the %.0f s "
              "horizon: predicted %.3f ms (windowed p90 of totals %.3f ms, "
              "the live bound decides at an empty queue); observed p90 of "
              "queue wait + pad + predict: b1 requests %.3f ms (%d), b8 "
              "requests %.3f ms (%d); on %s" % (
                  warm_s, len(spec), m["total"].count(bat._clock()),
                  CONTROL_HORIZON_S, 1e3 * predicted, 1e3 * hist,
                  1e3 * _percentile(totals[1], 0.9), len(totals[1]),
                  1e3 * _percentile(totals[8], 0.9), len(totals[8]), card),
              flush=True)
        # 2) predictive admission: half the predicted latency sheds
        requests0 = telemetry.value("serving.requests")
        shed = shed_half(8)
        if shed != ["request shed: predicted_miss"] * 8 or \
                telemetry.value("serving.requests") != requests0 or \
                bat.queue_depth != 0:
            raise AssertionError("predictive admission: %s, %d queued"
                                 % (shed, telemetry.value("serving.requests")
                                    - requests0))
        print("controller predictive admission: 8 requests with deadline = "
              "predicted / 2 (%.3f ms) all shed predicted_miss at submit, "
              "none queued" % (0.5e3 * ctrl.predicted_s(None)), flush=True)
        # 3) self-healing: r1 fails until its breaker opens; replaced
        traffic = _Traffic(bat, images)
        time.sleep(1.0)
        t_fault = time.perf_counter()
        failing["on"] = True
        _wait_for("r1's breaker", lambda: rs.replicas[1].state
                  == "quarantined", 30)
        failing["on"] = False
        _wait_for("the replace decision", lambda: any(
            a == "replace" for _, a, _ in log), 30)
        t_replace = [t for t, a, _ in log if a == "replace"][0]
        _wait_for("r2", lambda: any(r.index == 2 for r in rs.replicas), 30)
        r2 = [r for r in rs.replicas if r.index == 2]
        if str(r2[0].device) != "cuda:0":
            raise AssertionError("replacement: replicas %s" % rs.states())
        bringup = _wait_for("r2 to join", lambda: r2[0].state == "healthy",
                            120)
        t_joined = time.perf_counter()
        time.sleep(1.0)
        records = traffic.stop()
        # 4) scale-down: idle for one cooldown, with nothing failed
        down = _wait_for("scale_down", lambda: any(
            a == "scale_down" for _, a, _ in log), 60)
        _wait_for("the retired replica to leave", lambda: [
            r.index for r in rs.replicas] == [0], 30)
        # 5) a scale-up on the one card: recorded, then refused
        _run_clients(4, 8, lambda k, i: answers.append(
            (images[(k + i) % 16],
             bat.submit(images[(k + i) % 16]).result(timeout=120))))
        shed_half(4)
        _wait_for("the refused scale-up", lambda: [
            a for _, a, _ in log if a in ("scale_up", "warmup_failed")]
            == ["scale_up", "warmup_failed"], 30)
    finally:
        bat.close(timeout=60)
    launches = fused_conv.launches
    batches = telemetry.value("serving.batches")
    failures = [r for r in records if isinstance(r[3], Exception)]
    ok = [r for r in records if not isinstance(r[3], Exception)]
    answers += [(images[r[2]], r[3]) for r in ok]
    actions = [a for _, a, _ in log if a != "predicted_shed"]
    if actions != ["replace", "scale_down", "scale_up", "warmup_failed"]:
        raise AssertionError("controller decisions: %s" % log)
    if any(not isinstance(r[3], ReplicaFailure) for r in failures) or \
            telemetry.value("serving.replica.failures", tag="r1") != 3:
        raise AssertionError("failures other than r1's three: %s, %s" % (
            [type(r[3]).__name__ for r in failures],
            telemetry.tagged("serving.replica.failures")))
    late = [r for r in failures if r[0] > t_replace]
    if late:
        raise AssertionError("%d requests failed after the replacement"
                             % len(late))
    # every forward: the served batches, and r2's bring-up (one eager run
    # before each capture and one run per bucket after)
    if launches != 11 * (batches + 2 * len(spec)):
        raise AssertionError("fused_conv launched %d times, expected 11 x "
                             "(%d batches + %d bring-up forwards)" % (
                                 launches, batches, 2 * len(spec)))
    for site in ("serving.predict.r0", "serving.predict.r1",
                 "serving.predict.r2"):
        if telemetry.retrace_stats(site)["compiles"] != len(spec):
            raise AssertionError("%s captured %s" % (
                site, telemetry.retrace_stats(site)))
    if telemetry.retrace_stats("serving.predict.r3") is not None:
        raise AssertionError("the refused scale-up built a replica")
    ref_pred = rs.replicas[0].predictor
    worst = 0.0
    for x, got in answers:
        ref = ref_pred.predict(x).asnumpy()
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        if got.shape != ref.shape or not np.isfinite(got).all() or \
                err > 5e-2:
            raise AssertionError("controller: answer %s differs from direct "
                                 "predict by %.3g" % (got.shape, err))
        worst = max(worst, err)
    before = [r[1] for r in ok if r[0] < t_fault]
    during = [r[1] for r in ok if t_replace <= r[0] < t_joined]
    print("controller self-healing on %s: r1's breaker opened after 3 "
          "failed dispatches (%d requests failed, all ReplicaFailure on "
          "r1); replace %.2f s after the fault; r2 on cuda:0 captured %d "
          "graphs on its own thread in %.3f s while r0 served (%d "
          "requests); client p50/p99 ms before the fault %.3f / %.3f (%d), "
          "during the bring-up %.3f / %.3f (%d); decisions %s; scale_down "
          "%.2f s after the traffic stopped; then the scale-up on one card "
          "was refused: %s" % (
              card, len(failures), t_replace - t_fault, len(spec), bringup,
              len(during), _percentile(before, 0.5),
              _percentile(before, 0.99), len(before),
              _percentile(during, 0.5) if during else float("nan"),
              _percentile(during, 0.99) if during else float("nan"),
              len(during), actions, down,
              [r for _, a, r in log if a == "warmup_failed"][0][:90]),
          flush=True)
    print("controller gates: %d answers within %.3g of max|logit| of "
          "direct predict (limit 5e-2); fused_conv launches %d = 11 x (%d "
          "batches + %d bring-up forwards); captures per site r0/r1/r2 = "
          "%d each, none on the serving path" % (
              len(answers), worst, launches, batches, 2 * len(spec),
              len(spec)), flush=True)
    return launches


def zoo_phase(card):
    """The model zoo on the card: ResNet-50 v1 bf16 (``pow2(8)``) and the
    BERT-base TransformerLM bf16 (batch 1/2/4 x seq 128/512) in one
    ZooScheduler on cuda:0, threaded. 1) count cap 1: alternating requests
    evict and page in six times (page-in seconds, footprint beside the
    change in allocated and reserved bytes, the bytes each eviction gives
    back); 2) a byte budget evicts; 3) a canary of ResNet-50 (v2: the
    classifier x 1.01) at half the traffic, split by crc32 of the request
    id, each arm answering as its own version, then promoted without a
    capture, and v2x2 (the classifier x 2) refused by the same parity
    probe; 4) a v3 canary rolled back by the injected ``canary_rollback``
    with every future answered; 5) HTTP over the zoo, requests/s per model
    over ``HTTP_RUNS`` runs of at least ``HTTP_WINDOW_S``. Returns
    (fused_conv launches, flash_attention launches) of the phase."""
    import json
    import urllib.error
    import urllib.request
    import zlib
    import numpy as np
    import torch
    from mxtpu_torch import kernels, resilience, telemetry, xprof
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.serving import (BucketSpec, ModelServer, ModelZoo,
                                     ZooScheduler)
    resnet, _ = build_net()
    resnet.cast("bfloat16")
    lm, _ = build_lm()
    lm.cast("bfloat16")
    telemetry.reset()
    zoo = ModelZoo()
    specs = {"resnet50_v1": BucketSpec.pow2(8),
             "transformer_lm": BucketSpec([1, 2, 4], seq_lens=(128, 512))}
    zoo.register("resnet50_v1", resnet, specs["resnet50_v1"],
                 example=torch.zeros(RESNET_EXAMPLE_SHAPE,
                                     dtype=torch.bfloat16))
    zoo.register("transformer_lm", lm, specs["transformer_lm"],
                 example=torch.zeros(1, 128, dtype=torch.int32))
    sched = ZooScheduler(zoo, devices=["cuda:0"], start=True,
                         max_resident=1)
    forwards = {"resnet50_v1": 0, "transformer_lm": 0}
    builds = {"resnet50_v1": 0, "transformer_lm": 0}
    pageins, evictions, mem = [], [], {}
    pagein, evict, build_arm = sched._pagein, sched._evict, sched._build_arm

    def timed_pagein(model):
        t0 = time.perf_counter()
        res = pagein(model)
        pageins.append((model, time.perf_counter() - t0))
        return res

    def levels():
        # allocated and reserved bytes with the cache emptied: reserved then
        # counts the segments still in use, the graphs' private pools too
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def measured_evict(model, reason):
        a = levels()
        n = evict(model, reason)
        b = levels()
        evictions.append((model, reason, (a[0] - b[0], a[1] - b[1]), b))
        return n

    def counted_build(model, version, dslot, site):
        before = levels()
        arm, summary = build_arm(model, version, dslot, site)
        after = levels()
        mem.setdefault(site, []).append(
            (before, (after[0] - before[0], after[1] - before[1])))
        builds[model] += 1
        pred = arm.predictor
        dispatch = pred._dispatch_one

        def counted(*args, **kw):
            forwards[model] += 1
            return dispatch(*args, **kw)

        pred._dispatch_one = counted
        return arm, summary

    sched._pagein, sched._evict = timed_pagein, measured_evict
    sched._build_arm = counted_build
    spawned = []
    spawn = kernels._spawn

    def no_nvcc(*args, **kw):
        spawned.append(args)
        return spawn(*args, **kw)

    kernels._spawn = no_nvcc
    rng = np.random.default_rng(12)
    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
              for _ in range(8)]
    tokens = [rng.integers(0, BERT_BASE["vocab_size"], (1, t),
                           dtype=np.int32) for t in (100, 300, 512, 60)]

    def request(model, i, **kw):
        x = images[i % 8] if model == "resnet50_v1" else tokens[i % 4]
        return x, sched.submit(model, x, **kw)

    fused_conv.launches = flash_attention.launches = 0
    t_phase = time.perf_counter()
    try:
        # 1) count cap: every switch evicts and pages in
        for k in range(6):
            model = ("resnet50_v1", "transformer_lm")[k % 2]
            futs = [request(model, k * 3 + j) for j in range(3)]
            for _, f in futs:
                f.result(timeout=300)
        order = [m for m, _ in pageins]
        if order != ["resnet50_v1", "transformer_lm"] * 3 or \
                [m for m, _, _, _ in evictions] != order[:5]:
            raise AssertionError("count cap: page-ins %s, evictions %s"
                                 % (order, evictions))
        lines = []
        for model in specs:
            site = "serving.predict.zoo." + model
            secs = [s for m, s in pageins if m == model]
            fp = sched._footprints[model]
            back = [(r, b) for m, _, r, b in evictions if m == model]
            # each eviction against the levels before the page-in it undid:
            # allocated, and reserved (the graphs' pools) after empty_cache
            drift = []
            for (_returned, level), (before, _grew) in zip(back, mem[site]):
                drift.append(tuple((level[j] - before[j]) / 2**20
                                   for j in (0, 1)))
                for j, what in enumerate(("allocated", "reserved")):
                    if abs(level[j] - before[j]) > 64 << 20:
                        raise AssertionError(
                            "%s: after its eviction %d bytes are %s, %d "
                            "before its page-in" % (model, level[j], what,
                                                    before[j]))
            lines.append("%s page-in %.2f s first, later %s s; "
                         "site_footprint %d bytes beside allocated +%s and "
                         "reserved +%s; evictions gave back allocated %s, "
                         "reserved %s bytes (level after minus before its "
                         "page-in, allocated/reserved: %s MiB)" % (
                             model, secs[0], ", ".join(
                                 "%.2f" % s for s in secs[1:]), fp,
                             [g[0] for _, g in mem[site]],
                             [g[1] for _, g in mem[site]],
                             [r[0] for r, _ in back],
                             [r[1] for r, _ in back],
                             ", ".join("%.1f/%.1f" % d for d in drift)))
        print("zoo count cap 1 on %s, 6 alternations (3 requests each), "
              "no future dropped: %s" % (card, "; ".join(lines)),
              flush=True)
        # 2) byte budget, no count cap
        fps = sorted(sched._footprints.values())
        budget = int(1.5 * fps[1])
        rule = "1.5 x the larger"
        if budget >= fps[0] + fps[1]:
            budget = (fps[1] + fps[0] + fps[1]) // 2
            rule = "halfway between the larger and both (1.5 x would fit both)"
        sched.max_resident, sched.hbm_budget = 0, budget
        n_evict = len(evictions)
        request("resnet50_v1", 0)[1].result(timeout=300)
        if [e[:2] for e in evictions[n_evict:]] != [
                ("transformer_lm", "capacity")]:
            raise AssertionError("byte budget: %s" % evictions[n_evict:])
        print("zoo byte budget %d bytes (%s; footprints %s), no count cap: "
              "paging ResNet-50 in evicted the TransformerLM by bytes"
              % (budget, rule, fps), flush=True)
        sched.hbm_budget = 0
        # 3) canary of v2 and promote
        name = "resnet50_v1"
        v1 = zoo.version(name, "v1").params
        head = [k for k in v1 if "dense" in k]
        zoo.add_version(name, "v2", params={
            k: v * 1.01 if k in head else v for k, v in v1.items()})
        res = sched._residents[name]
        stable = res.stable.predictor
        probe = images[0]
        v1_out = stable.predict(probe).to_torch().float()
        tol = 5e-2 * v1_out.abs().max().item()
        compiles = telemetry.retrace_stats(stable.site)["compiles"]
        out = zoo.deploy(name, "v2", canary_frac=0.5, parity_example=probe,
                         parity_tol=tol)
        if out["mode"] != "canary":
            raise AssertionError("deploy v2: %s" % out)
        routed = []
        for arm in (res.stable, res.canary):
            submit = arm.batcher.submit

            def logged(inputs, _submit=submit, **kw):
                routed.append(kw["meta"]["version"])
                return _submit(inputs, **kw)

            arm.batcher.submit = logged
        futs = []
        for i in range(64):
            futs.append((i, request(name, i, request_id=i)[1]))
        outs = [(i, f.result(timeout=300)) for i, f in futs]
        want = ["v2" if zlib.crc32(str(i).encode()) % 10**6 < 0.5 * 10**6
                else "v1" for i in range(64)]
        if routed != want:
            raise AssertionError("canary split %s, crc32 rule %s"
                                 % (routed, want))
        worst = 0.0
        for i, got in outs:
            arm = res.canary if want[i] == "v2" else res.stable
            ref = arm.predictor.predict(images[i % 8]).asnumpy()
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            if err > 5e-2:
                raise AssertionError("canary: id %d (%s) differs from its "
                                     "arm's direct predict by %.3g"
                                     % (i, want[i], err))
            worst = max(worst, err)
        v2_out = res.canary.predictor.predict(probe).to_torch().float()
        sched.promote(name)
        after = stable.predict(probe).to_torch().float()
        err_v2 = ((after - v2_out).abs().max() / v2_out.abs().max()).item()
        off_v1 = ((after - v1_out).abs().max() / v1_out.abs().max()).item()
        if res.canary is not None or err_v2 > 5e-2 or \
                telemetry.retrace_stats(stable.site)["compiles"] != compiles:
            raise AssertionError("promote: stable vs v2 %.3g, captures %s"
                                 % (err_v2, telemetry.retrace_stats(
                                     stable.site)))
        print("zoo canary v2 (classifier x 1.01, parity probe within %.4g) "
              "at 0.5: 64 requests split %d v1 / %d v2, exactly the crc32 "
              "rule; each within %.3g of max|logit| of its arm's direct "
              "predict; promote: the stable arm answers as v2 (%.3g off "
              "v2, %.3g off v1) with no new capture" % (
                  tol, want.count("v1"), want.count("v2"), worst, err_v2,
                  off_v1), flush=True)
        # the same probe and tolerance must refuse a version that is off:
        # the classifier x 2 doubles every logit
        zoo.add_version(name, "v2x2", params={
            k: v * 2 if k in head else v for k, v in v1.items()})
        out = zoo.deploy(name, "v2x2", canary_frac=0.5, parity_example=probe,
                         parity_tol=tol)
        if out["mode"] != "rolled_back" or out.get("reason") != "parity" \
                or res.canary is not None or \
                zoo.active_version(name) != "v2" or telemetry.value(
                    "zoo.rollbacks", tag="parity") != 1:
            raise AssertionError("deploy v2x2 (classifier x 2): %s" % out)
        print("zoo canary v2x2 (classifier x 2) refused by the same parity "
              "probe: rolled back (parity), diff %.4g against the tolerance "
              "%.4g; v2 stays active" % (out["diff"], tol), flush=True)
        # 4) canary v3 rolled back by the injected fault, mid-traffic
        zoo.add_version(name, "v3", params={
            k: v * 0.99 if k in head else v for k, v in v1.items()})
        if zoo.deploy(name, "v3", canary_frac=0.5)["mode"] != "canary":
            raise AssertionError("deploy v3")
        # 32 requests queued on both arms, then the fault: the next gate
        # tick rolls back while the canary's cohorts are queued or running
        futs = [request(name, 100 + i, request_id=100 + i)[1]
                for i in range(32)]
        queued = res.canary.batcher.queue_depth
        resilience.set_faults("canary_rollback@0")
        _wait_for("the rollback", lambda: telemetry.value(
            "zoo.rollbacks", tag="injected") == 1, 30)
        done = [f.result(timeout=300) for f in futs]
        if len(done) != 32 or telemetry.value(
                "zoo.rollbacks", tag="injected") != 1 or \
                zoo.active_version(name) != "v2":
            raise AssertionError("rollback: %d of 32 answered, rollbacks %s"
                                 % (len(done), telemetry.tagged(
                                     "zoo.rollbacks")))
        resilience.reset_faults()
        print("zoo canary v3 rolled back by canary_rollback with %d "
              "requests queued on its arm: 32 of 32 futures answered, none "
              "dropped or hung; v2 stays active" % queued, flush=True)
        # 5) HTTP over the zoo
        srv = ModelServer(sched).start()
        url = "http://%s:%d/predict" % srv.address

        def post(body):
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Content-Type":
                                                  "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        rates = {}
        try:
            # HTTP_RUNS runs per model, each at least min POSTs and a window
            # of seconds. The TransformerLM answers with a bucket's whole
            # logits as JSON (128 x 30522 floats for a 60-token request)
            for model, threads, least, data in (
                    ("resnet50_v1", 4, 64, images),
                    ("transformer_lm", 2, 4, [t[:, :60] for t in tokens])):
                bodies = [{"model": model, "data": x.tolist()}
                          for x in data]
                sched.ensure_resident(model)

                def work(k, i, _bodies=bodies):
                    code, out = post(_bodies[(k + i) % len(_bodies)])
                    if code != 200:
                        raise AssertionError("POST %d: %s" % (code, out))

                rates[model] = [_run_clients_for(threads, least,
                                                 HTTP_WINDOW_S, work)
                                for _ in range(HTTP_RUNS)]
            code, out = post({"model": "nope", "data": [[1]]})
            if code != 404 or sorted(out["known_models"]) != sorted(specs):
                raise AssertionError("unknown model: %d %s" % (code, out))
        finally:
            srv.close(timeout=60)
    finally:
        kernels._spawn = spawn
        sched.close(timeout=60)
    wall = time.perf_counter() - t_phase
    conv_l, flash_l = fused_conv.launches, flash_attention.launches
    want_conv = 11 * (forwards["resnet50_v1"]
                      + 2 * len(specs["resnet50_v1"]) * builds["resnet50_v1"])
    want_flash = BERT_BASE["num_layers"] * (
        forwards["transformer_lm"]
        + 2 * len(specs["transformer_lm"]) * builds["transformer_lm"])
    if conv_l != want_conv or flash_l != want_flash or spawned:
        raise AssertionError(
            "zoo launches: fused_conv %d (expected %d), flash %d (expected "
            "%d); nvcc runs during page-ins %d" % (
                conv_l, want_conv, flash_l, want_flash, len(spawned)))
    for model in specs:
        st = telemetry.retrace_stats("serving.predict.zoo." + model)
        if st["compiles"] != len(specs[model]) * sum(
                1 for m, _ in pageins if m == model):
            raise AssertionError("%s: %s captures over %d page-ins" % (
                model, st, sum(1 for m, _ in pageins if m == model)))
    print("zoo gates on %s: fused_conv launches %d = 11 x (%d forwards + "
          "2 x 4 x %d builds), flash launches %d = 12 x (%d forwards + 2 x "
          "6 x %d builds), on every arm; captures = buckets x page-ins at "
          "each model's site; no nvcc during the phase; HTTP requests/s "
          "in %d runs of at least %.0f s (ResNet-50 4 threads, single-image "
          "POSTs, at least 64 a run; the TransformerLM 2 threads, 60 "
          "tokens): %s; phase %.1f s" % (
              card, conv_l, forwards["resnet50_v1"], builds["resnet50_v1"],
              flash_l, forwards["transformer_lm"], builds["transformer_lm"],
              HTTP_RUNS, HTTP_WINDOW_S, "; ".join(
                  "%s %s (POSTs %s; spread (max - min) / mean %.3f)" % (
                      m, ", ".join("%.3f" % (n / w) for n, w in runs),
                      [n for n, _ in runs], _spread([n / w for n, w in runs]))
                  for m, runs in rates.items()), wall),
          flush=True)
    return conv_l, flash_l


# the decode workload (slice 7): the reference bench's configuration
# (tools/serve_bench.py:run_decode's defaults) for the gates, and the same
# builder at BERT-base's vocabulary and width for the timed cells
DECODE_GATE = dict(vocab=256, dim=128, max_prompt=48, max_new=32, slots=8,
                   requests=80, seed=11)
DECODE_TIMED = dict(vocab=30522, dim=768, max_len=512, slots=16,
                    requests=64, prompt=(16, 448), max_new=(2, 64), seed=5,
                    bursts=8)
DECODE_PAGE_TOKENS = 16
DECODE_SPEC_K = 4
DECODE_WEDGE_STEP = 3       # the cohort step the wedge gate wedges
DECODE_TIE_TOL = 1e-5       # of max|logit|: a divergence must be a near-tie
DECODE_INT8_TIE_TOL = 1e-3  # int8 KV: one quantum moved by float rounding


def decode_drive(eng, reqs):
    """Submit every (prompt, max_new) to a poll-mode engine at once and
    poll to the end: (token lists, decode steps)."""
    from mxtpu_torch import telemetry
    s0 = telemetry.value("serving.decode.steps")
    futs = [eng.submit(p, max_new=m) for p, m in reqs]
    polls = 0
    while not all(f.done() for f in futs):
        eng.poll()
        polls += 1
        if polls > 100000:
            raise AssertionError("decode: requests never finished")
    return ([f.result(timeout=5).tolist() for f in futs],
            telemetry.value("serving.decode.steps") - s0)


def eager_logits_fn(model, device):
    """The full-prefix forward of ``model``'s weights on ``device`` (no KV
    cache, no engine executable): prefix -> last-position logits."""
    import numpy as np
    import torch
    params = {k: v.detach().to(device) for k, v in model.named_parameters()}

    def logits(prefix):
        t = torch.tensor(np.asarray(prefix, np.int32)[None], device=device)
        with torch.no_grad():
            out = torch.func.functional_call(model, params, (t,))[0]
        return out[0, len(prefix) - 1].float().cpu().numpy()

    return logits


def eager_greedy(logits, prompt, max_new, max_len):
    """Greedy tokens by full-prefix forwards, with the engine's stop rule
    (``max_new`` tokens, the last at position ``max_len`` - 1)."""
    import numpy as np
    toks, out = list(prompt), []
    while len(out) < min(max_new, max_len - len(prompt) + 1):
        nxt = int(np.argmax(logits(toks)))
        out.append(nxt)
        toks.append(nxt)
    return out


def decode_agree(what, got, ref, reqs, oracle, tol):
    """Each request's tokens equal the reference's, or differ first at a
    near-tie: both tokens there within ``tol`` x max|logit| of the largest
    logit of ``oracle(prompt, prefix)``. Returns the near-ties as (request,
    token index, margin / max|logit|)."""
    import numpy as np
    ties = []
    for i, (g, r, (p, _m)) in enumerate(zip(got, ref, reqs)):
        if g == r:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, r)) if a != b),
                 min(len(g), len(r)))
        if j >= min(len(g), len(r)):
            raise AssertionError("%s: request %d stops at %d tokens against "
                                 "%d" % (what, i, len(g), len(r)))
        lg = oracle(p, list(g[:j]))
        top = float(lg.max())
        scale = float(np.abs(lg).max())
        gap = max(top - float(lg[g[j]]), top - float(lg[r[j]]))
        if gap > tol * scale:
            raise AssertionError(
                "%s: request %d differs at token %d (%d against %d) with a "
                "margin of %.3g of max|logit|, above %.0e" % (
                    what, i, j, g[j], r[j], gap / scale, tol))
        ties.append((i, j, gap / scale))
    return ties


def engine_logits(eng, prompt, prefix):
    """The logits an engine decided ``prefix``'s next token from: the
    prefill's for an empty prefix, else its last decode step's (slot 0 of
    an otherwise idle engine)."""
    import numpy as np
    if not prefix:
        return eng.prefill_logits(prompt)
    fut = eng.submit(prompt, max_new=len(prefix) + 1)
    while not fut.done():
        eng.poll()
    got = fut.result(timeout=5).tolist()
    if got[:len(prefix)] != list(prefix):
        raise AssertionError("engine_logits: the engine's own stream left "
                             "the prefix")
    return np.asarray(eng._last_logits[0].float().cpu().numpy())


def decode_phase(card):
    """Continuous-batching decode on the card (slice 7), every engine on
    cuda:0. (a) Gates at the reference bench's configuration (vocab 256,
    dim 128, prompts up to 48, max_new 32, a pow2 cohort of 8, the 80
    requests of ``decode_workload(seed=11)``, weights seeded on the host):
    the card's tokens equal the port's CPU tokens and an eager full-prefix
    greedy loop on the card for every request (a difference passes only as
    a near-tie, which is printed), rowed, paged (pages of 16), with the
    prefix cache on templated prompts and with speculation (k = 4, draft =
    target, strictly fewer target steps); continuous decoding takes
    strictly fewer steps than restart-per-batch; no capture at
    ``serving.decode``/``serving.draft`` after warm-up and no read inside
    the decode span (and a poll-driven stretch with
    ``torch.cuda.set_sync_debug_mode("error")`` around every step's
    dispatch); int8 KV tokens equal the CPU port's int8 tokens, at most
    half f32's bytes a slot; a wedge injected under a fake clock, rowed
    and paged, resets the carry in place and the captured graphs then
    decode all 80 requests to the eager tokens. (b) Timed, the same builder at BERT-base's
    vocabulary and width (one head, max_len 512), f32, 16 slots, rowed
    and paged: 64 requests (prompts of 16-448 tokens, max_new 2-64)
    submitted at once to a threaded engine, eight bursts over: tokens/s
    of each burst with their median and spread, TTFT p50/p99 over every
    burst's requests, step
    ms by replay per cohort bucket, host ms a step, the idle share of a
    profiled stretch of steps and KV resident bytes. Returns (b)'s
    numbers."""
    t_phase = time.perf_counter()
    decode_gates(card)
    timed = decode_timed(card)
    print("decode phase %.1f s" % (time.perf_counter() - t_phase),
          flush=True)
    return timed


def decode_gates(card):
    """Part (a) of ``decode_phase`` on cuda:0 against the CPU (see
    there)."""
    import numpy as np
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.serving import KVCacheAccountant
    from mxtpu_torch.serving.decode_bench import (build_decode_engine,
                                                  build_decode_model,
                                                  decode_workload)
    g = DECODE_GATE
    model = build_decode_model(vocab=g["vocab"], dim=g["dim"],
                               max_len=g["max_prompt"] + g["max_new"],
                               seed=0)
    reqs = decode_workload(g["requests"], g["vocab"], g["max_prompt"],
                           g["max_new"], seed=g["seed"])
    max_len = g["max_prompt"] + g["max_new"]
    rng = np.random.RandomState(3)
    tmpl = rng.randint(0, g["vocab"], 2 * DECODE_PAGE_TOKENS).astype(
        np.int32)
    templated = [(np.concatenate([tmpl, rng.randint(
        0, g["vocab"], rng.randint(1, 16)).astype(np.int32)]),
        int(rng.randint(2, g["max_new"] + 1))) for _ in range(40)]
    engines = {}

    def run(label, device, workload=reqs, guard=False, **kw):
        # each engine's builds and counters from 0 (eleven engines share
        # the serving.decode site, past the retrace budget together)
        telemetry.reset()
        acct = KVCacheAccountant(overcommit=float(len(workload)) * 64)
        eng = build_decode_engine(
            model, slots=g["slots"], max_prompt=g["max_prompt"],
            max_new=g["max_new"], accountant=acct, device=device, **kw)
        sites = (eng._site, eng._draft_site)
        c0 = [(telemetry.retrace_stats(s) or {}).get("compiles", 0)
              for s in sites]
        d0 = telemetry.value("serving.decode.d2h")
        guarded = [0]
        if guard and torch.device(device).type == "cuda":
            real = eng._dispatch_step

            def dispatch(b, ptab):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return real(b, ptab)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    guarded[0] += 1

            eng._dispatch_step = dispatch
        toks, steps = decode_drive(eng, workload)
        c1 = [(telemetry.retrace_stats(s) or {}).get("compiles", 0)
              for s in sites]
        if c1 != c0 or telemetry.value("serving.decode.d2h") != d0:
            raise AssertionError(
                "decode %s: captures %s -> %s after warm-up, %d reads "
                "inside serving.decode" % (label, c0, c1, telemetry.value(
                    "serving.decode.d2h") - d0))
        if guarded[0] and guarded[0] != steps:
            raise AssertionError("decode %s: %d guarded dispatches, %d "
                                 "steps" % (label, guarded[0], steps))
        engines[label] = eng
        return toks, steps, eng, guarded[0]

    cuda = torch.device("cuda")
    card_logits = eager_logits_fn(model, cuda)
    cpu_logits = eager_logits_fn(model, "cpu")

    def oracle(prompt, prefix):
        return cpu_logits(list(prompt) + prefix)

    ties = {}
    out = {}
    for label, kw, workload in (
            ("rowed", {}, reqs),
            ("paged", {"page_tokens": DECODE_PAGE_TOKENS}, reqs),
            ("prefix", {"page_tokens": DECODE_PAGE_TOKENS,
                        "prefix_cache": True}, templated),
            ("spec", {"page_tokens": DECODE_PAGE_TOKENS,
                      "draft_model": model, "spec_k": DECODE_SPEC_K}, reqs),
            ("int8", {"int8": True}, reqs)):
        c_toks, c_steps, _, guarded = run(label, cuda, workload,
                                          guard=label != "prefix", **kw)
        hits = telemetry.value("serving.prefix.hits")
        if label == "spec":
            proposed = telemetry.value("serving.decode.spec_proposed")
            accepted = telemetry.value("serving.decode.spec_accepted")
        h_toks, h_steps, _, _ = run(label + "_cpu", "cpu", workload, **kw)
        if label == "int8":
            ties[label] = decode_agree(
                "int8 card vs CPU", c_toks, h_toks, workload,
                lambda p, pre: engine_logits(engines["int8_cpu"], p, pre),
                DECODE_INT8_TIE_TOL)
        else:
            ties[label] = decode_agree("%s card vs CPU" % label, c_toks,
                                       h_toks, workload, oracle,
                                       DECODE_TIE_TOL)
        out[label] = (c_toks, c_steps, h_steps, guarded, hits)
        if c_steps != h_steps and not ties[label]:
            raise AssertionError("decode %s: %d steps on the card, %d on "
                                 "the CPU" % (label, c_steps, h_steps))
    t0 = time.perf_counter()
    eager = [eager_greedy(card_logits, p, m, max_len) for p, m in reqs]
    eager_s = time.perf_counter() - t0
    eager_t = [eager_greedy(card_logits, p, m, max_len)
               for p, m in templated]
    for label in ("rowed", "paged", "spec", "int8", "prefix"):
        if label == "int8":
            continue
        ties[label] += decode_agree(
            "%s card vs eager on the card" % label, out[label][0],
            eager_t if label == "prefix" else eager,
            templated if label == "prefix" else reqs, oracle,
            DECODE_TIE_TOL)
    restart, r_steps, _, _ = run("restart", cuda, continuous=False)
    ties["restart"] = decode_agree("restart vs continuous", restart,
                                   out["rowed"][0], reqs, oracle,
                                   DECODE_TIE_TOL)
    if not r_steps > out["rowed"][1]:
        raise AssertionError("decode: continuous %d steps, restart %d"
                             % (out["rowed"][1], r_steps))
    if not out["spec"][1] < out["paged"][1]:
        raise AssertionError("decode: speculation %d target steps, paged "
                             "%d" % (out["spec"][1], out["paged"][1]))
    if out["prefix"][4] < 1:
        raise AssertionError("decode: no prefix hit on templated prompts")
    kv_f32 = engines["rowed"].per_slot_kv_bytes()
    kv_int8 = engines["int8"].per_slot_kv_bytes()
    if not 2 * kv_int8 <= kv_f32:
        raise AssertionError("decode: int8 KV %d bytes a slot against f32 "
                             "%d" % (kv_int8, kv_f32))
    wedge = {layout: decode_wedge_gate(model, reqs, eager, oracle, pt)
             for layout, pt in (("rowed", 0), ("paged", DECODE_PAGE_TOKENS))}
    for layout, r in wedge.items():
        ties["wedge_" + layout] = r["ties"]
    n_tokens = sum(len(t) for t in out["rowed"][0])
    for eng in engines.values():
        eng.close(timeout=10)
    print("decode gates on %s (vocab %d, dim %d, %d requests, %d tokens, "
          "slots %d): card tokens = CPU tokens = eager full-prefix greedy "
          "on the card for rowed, paged (pages of %d), prefix (40 templated "
          "prompts, %d hits), spec (k=%d, draft = target) and int8 KV "
          "(card = CPU int8); near-ties %s; steps continuous %d / restart "
          "%d, paged %d / spec %d (target steps; spec accepted %d of %d "
          "proposed); card steps = CPU steps; no capture after warm-up at "
          "serving.decode or serving.draft, serving.decode.d2h 0, %d / %d "
          "/ %d / %d step dispatches under set_sync_debug_mode('error') "
          "(rowed / paged / spec / int8); KV bytes a slot f32 %d, int8 %d "
          "(%.3f); eager greedy on the card %.1f s; after an injected "
          "wedge at step %d (fake clock) the carry was reset in place and "
          "the %d requests replayed the captured graphs to the eager "
          "tokens, no capture added (rowed: %d failed as wedged, paged: %d)"
          % (card, g["vocab"], g["dim"], len(reqs), n_tokens, g["slots"],
             DECODE_PAGE_TOKENS, out["prefix"][4], DECODE_SPEC_K,
             {k: v for k, v in ties.items() if v} or "none",
             out["rowed"][1], r_steps, out["paged"][1], out["spec"][1],
             accepted, proposed, out["rowed"][3], out["paged"][3],
             out["spec"][3], out["int8"][3], kv_f32, kv_int8,
             kv_int8 / kv_f32, eager_s, DECODE_WEDGE_STEP, len(reqs),
             wedge["rowed"]["wedged"], wedge["paged"]["wedged"]),
          flush=True)


def decode_wedge_gate(model, reqs, eager, oracle, page_tokens):
    """A fault-injected wedge on the card under a fake clock: the cohort
    of the first ``slots`` requests is wedged at step
    ``DECODE_WEDGE_STEP``, the watchdog fails it past the dispatch
    timeout and the carry is zeroed in place; then every request of
    ``reqs`` runs through the same captured graphs, no capture is added,
    the carry keeps its storage and the tokens equal ``eager`` (the eager
    full-prefix greedy loop on the card). Returns {"wedged": futures
    failed as wedged, "ties": near-ties}."""
    import torch
    from mxtpu_torch import resilience, telemetry
    from mxtpu_torch.serving import DeadlineExceeded, KVCacheAccountant
    from mxtpu_torch.serving.decode_bench import build_decode_engine
    g = DECODE_GATE
    now = [0.0]
    telemetry.reset()
    resilience.reset_faults()
    eng = build_decode_engine(
        model, slots=g["slots"], max_prompt=g["max_prompt"],
        max_new=g["max_new"], page_tokens=page_tokens,
        accountant=KVCacheAccountant(overcommit=float(len(reqs)) * 64),
        clock=lambda: now[0], device="cuda")
    c = eng._carry
    leaves = c["kv"] + [c[k] for k in ("tok", "pos", "active", "rem")]
    ptrs = [t.data_ptr() for t in leaves]
    c0 = (telemetry.retrace_stats(eng._site) or {}).get("compiles", 0)
    what = "decode wedge (%s)" % ("paged" if page_tokens else "rowed")
    resilience.set_faults("decode_wedge@%d" % DECODE_WEDGE_STEP)
    try:
        stuck = [eng.submit(p, max_new=m) for p, m in reqs[:g["slots"]]]
        for _ in range(1000):
            if resilience.FAULT_STATS["fired"]:
                break
            eng.poll()
        if resilience.FAULT_STATS["fired"] != [("decode_wedge",
                                               DECODE_WEDGE_STEP)]:
            raise AssertionError("%s: fired %s" % (
                what, resilience.FAULT_STATS["fired"]))
    finally:
        resilience.reset_faults()
    now[0] += eng._timeout_s + 1.0
    eng.poll()
    wedged = 0
    for f in stuck:
        if not f.done():
            raise AssertionError("%s: a stuck future is still open" % what)
        try:
            f.result(timeout=0)
        except DeadlineExceeded as e:
            if "wedged" not in str(e):
                raise
            wedged += 1
    if not wedged or telemetry.value("serving.decode.wedges") != 1 or \
            not eng._carry_stale or eng.live_slots:
        raise AssertionError("%s: %d futures failed as wedged, %d wedges, "
                             "stale %s, %d live slots" % (
                                 what, wedged, telemetry.value(
                                     "serving.decode.wedges"),
                                 eng._carry_stale, eng.live_slots))
    toks, _steps = decode_drive(eng, reqs)
    ties = decode_agree(what + " vs eager on the card", toks, eager, reqs,
                        oracle, DECODE_TIE_TOL)
    c1 = (telemetry.retrace_stats(eng._site) or {}).get("compiles", 0)
    if c1 != c0 or eng._carry is not c or eng._carry_stale or \
            [t.data_ptr() for t in leaves] != ptrs or \
            bool(c["active"].any()):
        raise AssertionError("%s: captures %d -> %d, carry replaced %s, "
                             "stale %s, storage moved %s" % (
                                 what, c0, c1, eng._carry is not c,
                                 eng._carry_stale,
                                 [t.data_ptr() for t in leaves] != ptrs))
    torch.cuda.synchronize()
    eng.close(timeout=10)
    return {"wedged": wedged, "ties": ties}


def decode_timed(card):
    """Part (b) of ``decode_phase``: the BERT-base-width builder, rowed and
    paged, timed (see there). Returns the per-layout numbers."""
    import threading
    import numpy as np
    from mxtpu_torch import telemetry
    from mxtpu_torch.serving import KVCacheAccountant
    from mxtpu_torch.serving.decode_bench import (build_decode_engine,
                                                  build_decode_model)
    t = DECODE_TIMED
    t0 = time.perf_counter()
    model = build_decode_model(vocab=t["vocab"], dim=t["dim"],
                               max_len=t["max_len"], seed=0)
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(t["seed"])
    reqs = [(rng.randint(0, t["vocab"], rng.randint(
        t["prompt"][0], t["prompt"][1] + 1)).astype(np.int32),
        int(rng.randint(t["max_new"][0], t["max_new"][1] + 1)))
        for _ in range(t["requests"])]
    max_new = t["max_len"] - t["prompt"][1]
    long_new = t["max_len"] - 72     # the profiled stretch's budget
    results = {}
    for layout, pt in (("rowed", 0), ("paged", DECODE_PAGE_TOKENS)):
        telemetry.reset()
        acct = KVCacheAccountant(overcommit=float(t["requests"]))
        t0 = time.perf_counter()
        eng = build_decode_engine(model, slots=t["slots"],
                                  max_prompt=t["prompt"][1],
                                  max_new=max_new, accountant=acct,
                                  page_tokens=pt, device="cuda")
        warm_s = time.perf_counter() - t0
        # step ms by replay per cohort bucket, on the idle cohort (every
        # lane computes; the writes are masked)
        step_ms = {b: cuda_ms(lambda b=b: eng._get_step_exec(b)())
                   for b in eng._decode_spec.decode_slots}
        # a profiled stretch of full-cohort steps, poll-driven
        long = [(rng.randint(0, t["vocab"], 64).astype(np.int32), long_new)
                for _ in range(t["slots"])]
        futs = [eng.submit(p, max_new=m) for p, m in long]
        while eng.live_slots < t["slots"]:
            eng.poll()
        reps = 20
        rows = device_rows(eng.poll, reps)
        dev_ms = sum(r[1] for r in rows)
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.poll()
        wall_step = 1e3 * (time.perf_counter() - t0) / reps
        if eng.live_slots < t["slots"]:
            raise AssertionError("decode timed %s: the profiled stretch "
                                 "ended with %d live slots" % (
                                     layout, eng.live_slots))
        while not all(f.done() for f in futs):
            eng.poll()
        # the timed bursts, threaded: the same 64 requests submitted at
        # once, t["bursts"] times over
        telemetry.reset()
        eng.start()
        peak, samples, stop = [0], [], threading.Event()

        def sample():
            while not stop.is_set():
                b = acct.resident_bytes("r0")
                peak[0] = max(peak[0], b)
                samples.append(b)
                stop.wait(0.001)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        runs, ttft_all, wall_all, tokens_all = [], [], 0.0, 0
        for _ in range(t["bursts"]):
            tok0 = telemetry.value("serving.decode.tokens")
            t0 = time.perf_counter()
            futs = [eng.submit(p, max_new=m) for p, m in reqs]
            outs = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            tokens = sum(len(o) for o in outs)
            if tokens != telemetry.value("serving.decode.tokens") - tok0 \
                    or any(len(o) != m for o, (_p, m) in zip(outs, reqs)):
                raise AssertionError("decode timed %s: %d tokens delivered"
                                     % (layout, tokens))
            ttft = sorted(f.ttft_s for f in futs)
            runs.append({"tok_per_s": tokens / wall, "wall_s": wall,
                         "ttft_p50_ms": 1e3 * _percentile(ttft, 0.5),
                         "ttft_max_ms": 1e3 * ttft[-1]})
            ttft_all += ttft
            wall_all += wall
            tokens_all += tokens
        stop.set()
        sampler.join(10)
        steps = telemetry.value("serving.decode.steps")
        hist = telemetry.snapshot()["histograms"]
        rates = sorted(r["tok_per_s"] for r in runs)
        ttft_all.sort()
        results[layout] = {
            "tok_per_s_median": float(np.median(rates)),
            "tok_per_s_min": rates[0], "tok_per_s_max": rates[-1],
            "tok_per_s_spread": (rates[-1] - rates[0]) / float(
                np.median(rates)),
            "bursts": runs, "tokens_a_burst": tokens_all // len(runs),
            "steps": steps, "warm_s": warm_s,
            "ttft_p50_ms": 1e3 * _percentile(ttft_all, 0.5),
            "ttft_p99_ms": 1e3 * _percentile(ttft_all, 0.99),
            "ttft_samples": len(ttft_all),
            "step_replay_ms": step_ms,
            "decode_span_p50_ms": 1e3 * hist["serving.decode"]["p50"],
            "fetch_span_p50_ms": 1e3 * hist["serving.fetch"]["p50"],
            "wall_ms_per_step": 1e3 * wall_all / steps,
            "profiled_step_device_ms": dev_ms,
            "profiled_step_wall_ms": wall_step,
            "idle_share": 1.0 - dev_ms / wall_step,
            "kv_resident_peak_bytes": peak[0],
            "kv_resident_mean_bytes": float(np.mean(samples)),
            "kv_bytes_a_slot": eng.per_slot_kv_bytes(),
            "kv_page_bytes": eng.page_bytes() if pt else None,
            "gather_bytes_a_step_b16": (
                2 * t["slots"] * eng._maxp * pt * t["dim"] * 4 if pt else 0),
            "top_kernels": [(n[:60], round(ms, 4)) for n, ms, _c in rows[:6]],
        }
        eng.close(timeout=30)
        print("decode timed %s on %s (vocab %d, dim %d, max_len %d, %d "
              "slots, f32): %s" % (layout, card, t["vocab"], t["dim"],
                                   t["max_len"], t["slots"],
                                   json.dumps(results[layout])), flush=True)
    print("decode timed: model built on the host in %.1f s; KV resident "
          "bytes peak rowed %d / paged %d, mean rowed %.0f / paged %.0f"
          % (build_s, results["rowed"]["kv_resident_peak_bytes"],
             results["paged"]["kv_resident_peak_bytes"],
             results["rowed"]["kv_resident_mean_bytes"],
             results["paged"]["kv_resident_mean_bytes"]), flush=True)
    for layout, r in results.items():
        print("decode timed %s over %d bursts: tokens/s median %r (min %r, "
              "max %r, spread (max - min) / median %r); each burst %s; "
              "TTFT over all %d requests p50 %r ms, p99 %r ms" % (
                  layout, len(r["bursts"]), r["tok_per_s_median"],
                  r["tok_per_s_min"], r["tok_per_s_max"],
                  r["tok_per_s_spread"],
                  [round(b["tok_per_s"], 1) for b in r["bursts"]],
                  r["ttft_samples"], r["ttft_p50_ms"], r["ttft_p99_ms"]),
              flush=True)
    return results


def resnet50_param_count():
    """Trainable parameters of the port's resnet50_v1 (shapes settled by
    a 32x32 forward on the CPU; no weights drawn)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.gluon.model_zoo import vision
    with mt.layout("NHWC"):
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))
    return sum(p.data().size for p in net.collect_params().values()
               if p.grad_req != "null")


def rtc_check(got, ref, rule, what, mag=None):
    """Hold a runtime kernel against its plain version by ``rule``:
    "exact" bit for bit; "rtol" |err| <= 1e-6 mag, where mag is the plain
    version on the inputs' magnitudes (2.5|x| + |y| for axpy: an FMA and
    a rounded product differ by one ulp of the operands, not of a result
    that cancels); "ulp" within one bf16 ulp of ref."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if rule == "exact":
        ok = torch.equal(got, ref)
    elif rule == "rtol":
        ok = bool((err <= 1e-6 * mag.float()).all())
    else:   # one bf16 ulp of ref: 2^(floor(log2|ref|) - 7)
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(2.0 ** -126))) - 7)
        ok = bool((err <= ulp).all())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("rtc %s: kernel disagrees with its plain version "
                             "(rule %s, max abs err %.3g)"
                             % (what, rule, err.max().item()))
    return err.max().item()


def expect_error(what, fn, match):
    """Run ``fn``; it must raise MXNetError mentioning ``match``."""
    from mxtpu_torch.base import MXNetError
    try:
        fn()
    except MXNetError as e:
        if match not in str(e):
            raise AssertionError("%s raised %r, expected %r" % (what, str(e),
                                                                match))
        print("rtc refuses %s: %s" % (what, str(e).splitlines()[0][:120]))
        return
    raise AssertionError("%s did not raise" % what)


def rtc_launch_dims(n, dtype):
    """(grid, block) of an example kernel over n elements: RTC_BLOCK
    threads a block and enough blocks that each thread moves its
    RTC_UNROLL 16-byte vectors once (one pass; a grid of 8 blocks per SM
    walking the array measured 3-6% slower, PERF.md)."""
    per_thread = RTC_UNROLL * 16 // (4 if dtype == "float32" else 2)
    return (max(1, -(-n // (RTC_BLOCK * per_thread))),), (RTC_BLOCK,)


def rtc_launch(k, args, n, dtype, shape=None):
    """One launch of an example kernel over n elements (an output of
    ``shape``, default (n,))."""
    grid, block = rtc_launch_dims(n, dtype)
    return k.launch(args, shape or (n,), grid=grid, block=block)


def rtc_inputs(name, n, gen, offset=0):
    """The inputs of example ``name`` over n elements, each ``offset``
    elements into a storage of its own (1: a view that is not 16-byte
    aligned, so the kernel takes its element-wise path)."""
    import torch
    n_in, dtype = {r[0]: r[1:3] for r in RTC_KERNELS}[name]
    return [torch.randn(n + offset, device="cuda", generator=gen).to(
        getattr(torch, dtype))[offset:] for _ in range(n_in)]


def rtc_host_stages(k, x):
    """Host us of each stage of one eager launch of ``k`` (square) on
    [x, n], and of the whole launch: the median of 400 calls each, not
    synchronised. Returns {stage: us}."""
    import torch
    from mxtpu_torch import rtc
    from mxtpu_torch.ndarray import NDArray
    n, dev = x.numel(), x.device
    args = [x, n]
    grid, block = rtc_launch_dims(n, "float32")
    values, _ = k._inputs(args)
    outs = k._outputs(args, (n,), None, dev)
    g, b = rtc.launch_dims(grid, block, n)
    stream = rtc._current_stream(dev.index)

    def argv():
        for (h, pointer), v in zip(k._in_holders, values):
            h.value = v.data_ptr() if pointer else v
        for h, o in zip(k._out_holders, outs):
            h.value = o.data_ptr()

    stages = {
        "argument checks": lambda: k._inputs(args),
        "output allocation": lambda: k._outputs(args, (n,), None, dev),
        "argv": argv,
        "stream lookup": lambda: rtc._current_stream(dev.index),
        "device check": lambda: dev.index == rtc._current_device(),
        "ctypes call": lambda: k._run(values, outs, g, b, 0, stream),
        "NDArray wrapping": lambda: NDArray(outs[0]),
        "whole launch": lambda: k.launch(args, (n,), grid=grid, block=block),
    }
    return {name: host_us(fn) for name, fn in stages.items()}


def rtc_phase(n):
    """Build the example module at runtime (then again, from the cache),
    hold each kernel against its plain version at n elements, at a ragged
    n + 5 and on inputs offset by one element (the element-wise path), and
    time it beside its plain version, its bound, a one-call PyTorch
    yardstick and the streaming-hint variant; then the host time of one
    launch, stage by stage. Returns (module, kernels by name, rows)."""
    import torch
    from mxtpu_torch import rtc
    mod = rtc.CudaModule(RTC_SOURCE).build()
    print("rtc: built %s with nvcc (%s) in %.2f s" % (
        mod.kernel_names, mod.build_how, mod.build_seconds), flush=True)
    for line in mod.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas rtc: %s" % line.strip())
    again = rtc.CudaModule(RTC_SOURCE).build()
    if again.build_how != "memory" or again.digest != mod.digest:
        raise AssertionError("rtc: an unchanged source was rebuilt (%s)"
                             % again.build_how)
    print("rtc: the same source again: loaded from the %s cache in %.6f s"
          % (again.build_how, again.build_seconds))
    if RTC_STREAMING == RTC_SOURCE:
        raise AssertionError("rtc: the streaming variant is the plain source")
    streaming = rtc.CudaModule(RTC_STREAMING).build()
    ks = {name: mod.get_kernel(name) for name, *_ in RTC_KERNELS}
    ks_cs = {name: streaming.get_kernel(name) for name, *_ in RTC_KERNELS}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    expect_error("CPU arrays", lambda: ks["square"].launch(
        [torch.ones(4), 4], (4,)), "no CPU path")
    expect_error("a bf16 array for float*", lambda: ks["square"].launch(
        [torch.ones(4, device="cuda", dtype=torch.bfloat16), 4], (4,),
        out_dtypes="float32"), "reads torch.float32")
    expect_error("a source nvcc rejects", lambda: rtc.CudaModule(
        "__global__ void broken(float* x) { x[0] = no_such_name; }").build(),
        "nvcc failed")
    print("rtc kernel checks at n = %d (ResNet-50 v1's parameter count), "
          "at n + 5 and on views offset by one element: exact = bit-exact, "
          "rtol = |err| <= 1e-6 (2.5|x| + |y|), ulp = within one bf16 ulp "
          "of ref; launched on %s blocks of %d threads (float32; bf16 "
          "half as many)" % (n, rtc_launch_dims(n, "float32")[0][0],
                             RTC_BLOCK))
    rows = []
    for name, n_in, dtype, rule, library in RTC_KERNELS:
        k, k_cs, plain = ks[name], ks_cs[name], RTC_PLAIN[name]
        errs = []
        for m, offset in ((n, 0), (n + 5, 0), (n + 5, 1)):
            xs = rtc_inputs(name, m, gen, offset)
            for kern in (k, k_cs):
                out = rtc_launch(kern, xs + [m], m, dtype).to_torch()
                torch.cuda.synchronize()
                errs.append(rtc_check(out, plain(*xs), rule, "%s n=%d%s" % (
                    name, m, " view+1" if offset else ""),
                    mag=plain(*[t.abs() for t in xs])))
        xs = rtc_inputs(name, n, gen)
        ms = cuda_ms(lambda: rtc_launch(k, xs + [n], n, dtype))
        cs_ms = cuda_ms(lambda: rtc_launch(k_cs, xs + [n], n, dtype))
        plain_ms = cuda_ms(lambda: plain(*xs))
        lib_ms = cuda_ms(lambda: library(*xs)) if library else None
        n_bytes = (n_in + 1) * n * xs[0].element_size()
        flops = 2.0 * n if n_in == 2 else 1.0 * n
        bms, by = bound_ms(n_bytes, flops, "float32")
        rows.append(dict(name=name, dtype=dtype, max_abs_err=max(errs),
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by, streaming_ms=cs_ms))
        print("kernel rtc %-16s %-8s %-5s err %.3g  kernel %.4f ms  "
              "__ldcs/__stcs variant %.4f ms  plain %.4f ms  torch %s  "
              "bound %.4f ms (%s, %d bytes at 3.35 TB/s), share %.3f of it"
              % (name, dtype, rule, max(errs), ms, cs_ms, plain_ms,
                 "%.4f ms" % lib_ms if lib_ms is not None else "-", bms, by,
                 n_bytes, bms / ms), flush=True)
    # the host's cost of one eager launch, stage by stage
    small = torch.randn(1024, device="cuda", generator=gen)
    stages = rtc_host_stages(ks["square"], small)
    square_us = host_us(small.square)
    print("rtc host us per launch of square at n = 1024 (median of 400 "
          "calls, not synchronised), by stage: %s; torch.square %.2f us "
          "(rtc / torch.square %.2f)" % (
              ", ".join("%s %.2f" % kv for kv in stages.items()), square_us,
              stages["whole launch"] / square_us), flush=True)
    return mod, ks, rows


def imperative_phase(ks, n):
    """The main path of this slice, as an MXNet user writes it: mx.nd
    arrays on the card, the runtime kernels launched on them, and square
    registered as a differentiable op (square_backward its vjp) used under
    autograd.record(), with grad_req write and then add. Checked against
    the same computation through mx.nd on the CPU, where the op is
    registered with the plain versions. Returns the launches per kernel
    counted during exactly this run."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.contrib.external_kernel import register_external_kernel
    nd = mt.nd
    sq, sqb = ks["square"], ks["square_backward"]
    register_external_kernel(
        "rtc_square", lambda x: rtc_launch(sq, [x, x.numel()], x.numel(),
                                           "float32", x.shape),
        vjp=lambda g, x: rtc_launch(sqb, [x, g, x.numel()], x.numel(),
                                    "float32", x.shape))
    register_external_kernel(
        "rtc_square_plain", RTC_PLAIN["square"],
        vjp=lambda g, x: RTC_PLAIN["square_backward"](x, g))

    def run(ctx, op, launch):
        """The user's program on ``ctx``: (eager results, grads per req)."""
        mt.random.seed(7)
        gpu = mt.gpu(0)
        x = nd.random.normal(shape=(n,), ctx=gpu).as_in_context(ctx)
        y = nd.random.normal(shape=(n,), ctx=gpu).as_in_context(ctx)
        w = nd.random.uniform(0.5, 1.5, shape=(n,), ctx=gpu).as_in_context(
            ctx)
        u = launch("axpy", [x, y, n])
        v = launch("twice", [u, n])
        b = launch("axpy_bf16", [x.astype("bfloat16"), y.astype("bfloat16"),
                                 n])
        grads = {}
        for req, steps in (("write", 2), ("add", 2)):
            x.attach_grad(req)
            w.attach_grad(req)
            for _ in range(steps):
                before = (sq.launches, sqb.launches)
                with mt.autograd.record():
                    z = op(x) * w
                    loss = z.sum()
                loss.backward()
                if ctx.type == "cuda" and (sq.launches - before[0],
                                           sqb.launches - before[1]) != (1, 1):
                    raise AssertionError(
                        "imperative %s step launched square %d and "
                        "square_backward %d times, expected 1 and 1" % (
                            req, sq.launches - before[0],
                            sqb.launches - before[1]))
            grads[req] = (x.grad.to_torch().cpu(), w.grad.to_torch().cpu(),
                          loss.asscalar())
        host = [a.to_torch().detach().cpu() for a in (x, y, w, u, v, b)]
        return host, grads

    def card_launch(name, args):
        return rtc_launch(ks[name], args, n, {r[0]: r[2] for r in
                                              RTC_KERNELS}[name])

    def cpu_launch(name, args):
        return nd.NDArray(RTC_PLAIN[name](*[a.to_torch() for a in args[:-1]]))

    for k in ks.values():
        k.launches = 0
    t0 = time.time()
    card = run(mt.gpu(0), nd.rtc_square, card_launch)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: k.launches for name, k in ks.items()}
    print("imperative main path on the card: %.2f s, launches %s"
          % (wall, launches), flush=True)
    (x, y, w, u, v, b), grads = card
    cpu_eager, cpu_grads = run(mt.cpu(), nd.rtc_square_plain, cpu_launch)
    cu, cv, cb = cpu_eager[3:]
    mag = RTC_PLAIN["axpy"](x.abs(), y.abs())
    rtc_check(u, cu, "rtol", "imperative axpy vs CPU", mag=mag)
    rtc_check(v, cv, "rtol", "imperative twice vs CPU", mag=2 * mag)
    rtc_check(b, cb, "ulp", "imperative axpy_bf16 vs CPU")
    for req, scale in (("write", 1.0), ("add", 2.0)):
        gx, gw, loss = grads[req]
        cgx, cgw, closs = cpu_grads[req]
        checks = (("x.grad = %g * 2xw" % scale, gx, scale * 2 * x * w),
                  ("w.grad = %g * x^2" % scale, gw, scale * x * x),
                  ("x.grad vs CPU", gx, cgx), ("w.grad vs CPU", gw, cgw))
        for what, got, ref in checks:
            if tuple(got.shape) != (n,) or \
                    not bool(((got - ref).abs() <= 1e-5 * ref.abs()).all()):
                raise AssertionError("imperative %s: %s fails (max abs err "
                                     "%.3g)" % (req, what,
                                                (got - ref).abs().max()))
        print("imperative grad_req=%s (2 steps): x.grad = %g*2xw and w.grad "
              "= %g*x^2 within rtol 1e-5, and within rtol 1e-5 of the CPU "
              "run; loss %.7g (CPU %.7g)" % (req, scale, scale, loss, closs))
    # where one autograd step's time goes (after the counted run)
    xg, wg = nd.array(x, ctx=mt.gpu(0)), nd.array(w, ctx=mt.gpu(0))
    xg.attach_grad()
    wg.attach_grad()

    def step():
        with mt.autograd.record():
            loss = (nd.rtc_square(xg) * wg).sum()
        loss.backward()
    for _ in range(3):
        step()
    samples = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0))
    samples.sort()
    print_breakdown("imperative autograd step (n=%d)" % n,
                    device_rows(step, 5), samples[len(samples) // 2],
                    "square")
    return launches


def gluon_nd_phase():
    """Gluon on NDArrays on the card. ResNet-50 v1 (seeded weights) called
    on an mx.nd array equals the tensor path bit for bit and launches the
    conv kernel 11 times a forward, in float32 and bfloat16; and a Dense ->
    BatchNorm -> Dense net trained two steps on NDArrays under
    autograd.record() (training-mode BatchNorm) gives the outputs,
    ``p.grad()`` and moving statistics of the same program on the CPU
    (float32: outputs within 1e-5, gradients within 1e-4 of max(1,
    max|ref|)). Returns the conv launches of the NDArray forwards."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    nd = mt.nd
    net, _ = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    x = np.random.default_rng(5).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        xa = nd.array(x, ctx=mt.gpu(0), dtype=dtype)
        with torch.no_grad():
            ref = net(xa.to_torch())
        fused_conv.launches = 0
        out = net(xa)
        torch.cuda.synchronize()
        launches[dtype] = fused_conv.launches
        if not isinstance(out, nd.NDArray) or \
                not torch.equal(out.to_torch(), ref) or \
                launches[dtype] != 11:
            raise AssertionError(
                "gluon resnet50_v1 %s on an NDArray: %s, %d conv launches "
                "(expected 11), equal to the tensor path: %s" % (
                    dtype, type(out).__name__, launches[dtype],
                    isinstance(out, nd.NDArray)
                    and torch.equal(out.to_torch(), ref)))
        print("gluon resnet50_v1 %s net(mx.nd array) on the card: %s %s, "
              "bit-equal to net(tensor), fused_conv launches %d"
              % (dtype, out.shape, out.dtype, launches[dtype]), flush=True)

    rng = np.random.default_rng(6)
    weights = {"dense0_weight": rng.standard_normal((512, 256)) / 16,
               "dense0_bias": rng.normal(0, 0.1, 512),
               "batchnorm0_gamma": rng.uniform(0.5, 1.5, 512),
               "batchnorm0_beta": rng.normal(0, 0.1, 512),
               "batchnorm0_running_mean": np.zeros(512),
               "batchnorm0_running_var": np.ones(512),
               "dense1_weight": rng.standard_normal((10, 512)) / 22,
               "dense1_bias": rng.normal(0, 0.1, 10)}
    data = [(rng.standard_normal((64, 256)), rng.standard_normal((64, 10)))
            for _ in range(2)]

    def program(ctx):
        net = mt.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(mt.gluon.nn.Dense(512, in_units=256),
                    mt.gluon.nn.BatchNorm(in_channels=512),
                    mt.gluon.nn.Dense(10, in_units=512))
        net.initialize(ctx=ctx)
        for name, p in net.collect_params().items():
            p.set_data(weights[name[len("mlp_"):]].astype(np.float32))
        res = []
        for xs, head in data:
            with mt.autograd.record():
                out = net(nd.array(xs, ctx=ctx))
                loss = (out * nd.array(head, ctx=ctx)).sum()
            loss.backward()
            res.append({"out": out.asnumpy()})
            res[-1].update((name, p.grad().asnumpy()) for name, p in
                           net.collect_params().items()
                           if p.grad_req != "null")
        res[-1].update((name, p.data().asnumpy()) for name, p in
                       net.collect_params().items()
                       if name.endswith(("running_mean", "running_var")))
        return res

    card, host = program(mt.gpu(0)), program(mt.cpu())
    worst = {}
    for step, (c, h) in enumerate(zip(card, host)):
        for key, ref in h.items():
            tol = 1e-5 if key == "out" or "running" in key else 1e-4
            err = float(np.abs(c[key] - ref).max())
            if c[key].shape != ref.shape or not np.isfinite(c[key]).all() \
                    or err > tol * max(1.0, float(np.abs(ref).max())):
                raise AssertionError("gluon mlp step %d %s: card differs from "
                                     "the CPU by %.3g" % (step, key, err))
            worst[key] = max(worst.get(key, 0.0), err)
    print("gluon Dense(512) -> BatchNorm -> Dense(10) on NDArrays, 2 steps "
          "under autograd.record() on the card against the CPU: max abs "
          "err %s" % ", ".join("%s %.3g" % kv for kv in sorted(
              worst.items())), flush=True)
    return launches


# ------------------------------------------------------------- training
# ResNet-50 training: bench.py's count, 3 x 2 x 4.089 GMAC per image
RESNET50_TRAIN_FLOPS = 3 * 2 * 4.089e9
SGD_PARAMS = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
ADAM_PARAMS = {"learning_rate": 1e-4}
# (name, batch, H=W, C_in, C_out, k, stride, pad): the gated ResNet-50
# convs, each differentiated at b8 with the full epilogue case after them
CONV_BWD_SHAPES = [row[:8] for row in RESNET50_GATED] + [
    ("epilogue 3x3 64->64 @28", 2, 28, 64, 64, 3, 1, 1)]


def grad_check(got, ref, dtype, what):
    """A gradient against autograd through the plain version: float32
    max|err| <= 1e-4 max(1, max|ref|) (test_pallas_conv.py's 1e-4, taken
    of the largest magnitude since a gradient here sums 10^3-10^5 terms
    in two orders); bfloat16 max|err| <= 1e-2 max|ref|, since the kernel
    path rounds the cotangent and the gradient to bf16 (2^-9 relative
    each) where the plain version keeps float32."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    mag = ref.abs().max().item()
    limit = 1e-4 * max(1.0, mag) if dtype == "float32" else 1e-2 * mag
    if not err <= limit or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: gradient differs from autograd through the "
                             "plain version by %.3g (limit %.3g, max|ref| "
                             "%.3g)" % (what, err, limit, mag))
    return err


def conv_backward_phase():
    """The conv's backward on the card: at each gated ResNet-50 shape (b8)
    and on the full epilogue, f32 and bf16, the gradients of x and w (and
    scale, bias, residual) of the kernel path (``_FusedConv``: the kernel
    forward, ``fused_conv_backward``) against autograd through
    ``fused_conv_reference`` on the card; forward + backward timed by
    CUDA-graph replay beside ``F.conv2d``'s, and the gradient convolutions
    on channels-last views beside the same on NCHW copies."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.conv import (fused_conv,
                                             fused_conv_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    print("conv backward checks against autograd through the plain version "
          "(cuDNN TF32 allowed: %s): float32 max|err| <= 1e-4 max(1, "
          "max|ref|), bfloat16 max|err| <= 1e-2 max|ref|"
          % torch.backends.cudnn.allow_tf32)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, n, hw, cin, cout, k, s, p in CONV_BWD_SHAPES:
            epi = name.startswith("epilogue")
            x = torch.randn(n, hw, hw, cin, device="cuda",
                            generator=gen).to(dt)
            w = (torch.randn(k, k, cin, cout, device="cuda", generator=gen)
                 * math.sqrt(2.0 / (k * k * cin))).to(dt)
            oh = (hw + 2 * p - k) // s + 1
            extra = {}
            if epi:
                extra = dict(
                    scale=torch.rand(cout, device="cuda", generator=gen)
                    + 0.5,
                    bias=0.1 * torch.randn(cout, device="cuda",
                                           generator=gen),
                    residual=torch.randn(n, oh, oh, cout, device="cuda",
                                         generator=gen).to(dt), relu=True)
            head = torch.randn(n, oh, oh, cout, device="cuda", generator=gen)
            pad = ((p, p), (p, p))
            inputs = [x, w] + [extra[k_] for k_ in ("scale", "bias",
                                                    "residual") if epi]
            mine = [t.detach().requires_grad_() for t in inputs]
            plain = [t.detach().float().requires_grad_() for t in inputs]
            kw = dict(zip(("scale", "bias", "residual"), mine[2:]))
            out = fused_conv(mine[0], mine[1], (s, s), pad,
                             relu=extra.get("relu", False), **kw)
            got = torch.autograd.grad((out.float() * head).sum(), mine)
            pkw = dict(zip(("scale", "bias", "residual"), plain[2:]))
            ref_out = fused_conv_reference(plain[0], plain[1], (s, s), pad,
                                           relu=extra.get("relu", False),
                                           **pkw)[0]
            ref = torch.autograd.grad((ref_out.float() * head).sum(), plain)
            errs = [grad_check(g, r, dtype, "conv bwd %s %s d%s"
                               % (name, dtype, label))
                    for g, r, label in zip(got, ref, ("x", "w", "scale",
                                                      "bias", "residual"))]
            if got[0].dtype != dt or got[1].dtype != dt:
                raise AssertionError("conv bwd %s: dx %s, dw %s, expected %s"
                                     % (name, got[0].dtype, got[1].dtype, dt))
            line = ("conv backward %-24s %-8s max err %s" % (
                name, dtype, " ".join("d%s %.3g" % kv for kv in zip(
                    ("x", "w", "scale", "bias", "residual"), errs))))
            if epi:
                print(line)
                continue
            # fresh leaves: a leaf whose graph was built on the default
            # stream (the check above) cannot join a capture
            del out, got, ref, ref_out, mine, plain
            xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
            xn = x.permute(0, 3, 1, 2).detach().requires_grad_()
            wn = w.permute(3, 2, 0, 1).detach().requires_grad_()
            dz = head.to(dt)
            hn = dz.permute(0, 3, 1, 2)

            def kern():
                o = fused_conv(xg, wg, (s, s), pad)
                return torch.autograd.grad(o, (xg, wg), dz)

            def lib():
                o = F.conv2d(xn, wn, stride=s, padding=p)
                return torch.autograd.grad(o, (xn, wn), hn)

            def plain_fb():
                o = fused_conv_reference(xg, wg, (s, s), pad)[0]
                return torch.autograd.grad(o, (xg, wg), dz)
            # the two gradient convolutions alone: channels-last views
            # (what fused_conv_backward hands cuDNN) and NCHW copies
            wv = w.permute(3, 2, 0, 1)
            xv = x.permute(0, 3, 1, 2)
            dzv = dz.permute(0, 3, 1, 2)

            def grads_views():
                return torch.ops.aten.convolution_backward(
                    dzv, xv, wv, None, [s, s], [p, p], [1, 1], False,
                    [0, 0], 1, [True, True, False])

            def grads_copies():
                return torch.ops.aten.convolution_backward(
                    dzv.contiguous(), xv.contiguous(), wv.contiguous(), None,
                    [s, s], [p, p], [1, 1], False, [0, 0], 1,
                    [True, True, False])
            # forward + backward as one function: x, w and dz read once,
            # out, dx and dw written once; the forward's 2*M*K FLOPs and
            # the two gradient convs' as many again each
            out_elems = n * oh * oh * cout
            bms, by = bound_ms(
                (2 * x.numel() + 2 * w.numel() + 2 * out_elems)
                * x.element_size(),
                3 * 2.0 * n * oh * oh * k * k * cin * cout, dtype)
            row = dict(shape=name, dtype=dtype, train_graph_ms=graph_ms(kern),
                       library_train_graph_ms=graph_ms(lib),
                       plain_train_graph_ms=graph_ms(plain_fb),
                       train_bound_ms=bms, train_bound_by=by,
                       views_ms=graph_ms(grads_views),
                       copies_ms=graph_ms(grads_copies), max_abs_err=max(
                           errs))
            rows.append(row)
            print("%s;  fwd+bwd by graph replay: kernel path %.4f ms  "
                  "F.conv2d %.4f ms (ratio %.3f)  plain version %.4f ms  "
                  "bound %.4f ms (%s);  gradient convs on channels-last "
                  "views %.4f ms, on NCHW copies %.4f ms"
                  % (line, row["train_graph_ms"],
                     row["library_train_graph_ms"],
                     row["train_graph_ms"] / row["library_train_graph_ms"],
                     row["plain_train_graph_ms"], bms, by,
                     row["views_ms"], row["copies_ms"]), flush=True)
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        print("conv fwd+bwd %s, the %d gated shapes once each, by graph "
              "replay: kernel path %.4f ms, plain version %.4f ms, F.conv2d "
              "%.4f ms, bound %.4f ms" % (dtype, len(mine), *(
                  sum(r[key] for r in mine) for key in (
                      "train_graph_ms", "plain_train_graph_ms",
                      "library_train_graph_ms", "train_bound_ms"))),
              flush=True)
    return rows


# (name, B, H, T, D, causal, layout)
FLASH_BWD_SHAPES = [
    ("b8 h12 T512 d64 qkv views", 8, 12, 512, 64, False, "qkv"),
    ("b8 h12 T512 d64 qkv views causal", 8, 12, 512, 64, True, "qkv"),
    ("b2 h4 T256 d160 causal", 2, 4, 256, 160, True, "contig"),
]


def flash_backward_phase():
    """The flash backward on the card: dq, dk and dv of the kernel path
    (``_Flash``: the kernel forward, ``flash_attention_backward``) through
    out and lse, against autograd through ``flash_attention_reference`` on
    the card, at b8 h12 T512 d64 on the served strided q/k/v views (causal
    and not) and at D 160, f32 and bf16; forward + backward timed by
    CUDA-graph replay beside sdpa's (a yardstick: the port calls no
    sdpa)."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.flash_attention import (
        flash_attention, flash_attention_reference,
        flash_attention_with_lse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, b, h, t, d, causal, layout in FLASH_BWD_SHAPES:
            if layout == "qkv":
                base = torch.randn(b, t, 3, h, d, device="cuda",
                                   generator=gen).to(dt)
            else:
                base = torch.randn(3, b, h, t, d, device="cuda",
                                   generator=gen).to(dt)
            g_out = torch.randn(b, h, t, d, device="cuda", generator=gen)
            g_lse = torch.randn(b, h, t, device="cuda", generator=gen)

            def views(src):
                return src.permute(2, 0, 3, 1, 4) if layout == "qkv" \
                    else src
            mine = base.detach().requires_grad_()
            q, k, v = views(mine)
            out, lse = flash_attention_with_lse(q, k, v, causal=causal)
            got = torch.autograd.grad(
                (out.float() * g_out).sum() + (lse * g_lse).sum(), mine)[0]
            plain = base.detach().float().requires_grad_()
            rq, rk, rv = views(plain)
            r_out, r_lse = flash_attention_reference(rq, rk, rv, causal)
            ref = torch.autograd.grad(
                (r_out * g_out).sum() + (r_lse * g_lse).sum(), plain)[0]
            gv, rv_ = views(got), views(ref)
            errs = [grad_check(gv[i], rv_[i], dtype, "flash bwd %s %s d%s"
                               % (name, dtype, "qkv"[i])) for i in range(3)]
            if got.dtype != dt:
                raise AssertionError("flash bwd %s: gradient %s, expected %s"
                                     % (name, got.dtype, dt))
            line = ("flash backward %-32s %-8s max err dq %.3g dk %.3g dv "
                    "%.3g (through out and lse)" % ((name, dtype) + tuple(errs)))
            if not name.startswith("b8"):
                print(line)
                continue
            # fresh leaves, as in the conv phase
            del out, lse, got, ref, r_out, r_lse, q, k, v, mine, plain
            go = g_out.to(dt)
            leaf = base.detach().requires_grad_()
            sq, sk, sv = (x_.detach().requires_grad_() for x_ in views(base))

            def kern():
                kq, kk, kv = views(leaf)
                o = flash_attention(kq, kk, kv, causal=causal)
                return torch.autograd.grad(o, leaf, go)

            def sdpa():
                o = F.scaled_dot_product_attention(sq, sk, sv,
                                                   is_causal=causal)
                return torch.autograd.grad(o, (sq, sk, sv), go)

            def plain_fb():
                pq, pk, pv = views(leaf)
                o = flash_attention_reference(pq, pk, pv, causal)[0]
                return torch.autograd.grad(o, leaf, go)
            # forward + backward as one function: q, k, v and g read once,
            # out, lse, dq, dk and dv written once; 7 matmuls of 2BHT^2D
            # (forward QK^T, PV; backward QK^T again, P^T g, g V^T, dS K,
            # dS^T Q), half of it under the causal mask
            el = base.element_size()
            bms, by = bound_ms(
                (8 * b * h * t * d) * el + 4 * b * h * t,
                7 * 2.0 * b * h * t * t * d * (0.5 if causal else 1.0),
                dtype)
            row = dict(shape=name, dtype=dtype, max_abs_err=max(errs),
                       train_graph_ms=graph_ms(kern, launches=10),
                       library_train_graph_ms=graph_ms(sdpa, launches=10),
                       plain_train_graph_ms=graph_ms(plain_fb, launches=10),
                       train_bound_ms=bms, train_bound_by=by)
            rows.append(row)
            print("%s;  fwd+bwd by graph replay: kernel path %.4f ms  sdpa "
                  "%.4f ms (ratio %.3f)  plain version %.4f ms  bound %.4f "
                  "ms (%s)" % (
                      line, row["train_graph_ms"],
                      row["library_train_graph_ms"],
                      row["train_graph_ms"] / row["library_train_graph_ms"],
                      row["plain_train_graph_ms"], bms, by), flush=True)
    return rows


def _step_program(net, trainer, loss_fn, x, y, reshape, batch_size=None,
                  clip=None):
    """One step of the user's loop (train_cifar10.py): record, net, loss,
    backward, ``gluon.utils.clip_global_norm`` of the gradients to
    ``clip`` where given (it reads the norm back to the host), then
    trainer.step (``batch_size`` default: the labels' count). Returns
    (loss, logits) NDArrays."""
    import mxtpu_torch as mt
    with mt.autograd.record():
        logits = net(x)
        flat = logits if reshape is None else logits.reshape((-1, reshape))
        loss = loss_fn(flat, y.reshape((-1,)))
    loss.backward()
    if clip is not None:
        mt.gluon.utils.clip_global_norm(
            [p.grad() for p in net.collect_params().values()
             if p.grad_req != "null"], clip)
    trainer.step(batch_size or y.size)
    return loss, logits


def _host_copy(state, device="cpu"):
    """An optimizer state (NDArrays in nested tuples) copied to ``device``
    (default the CPU)."""
    from mxtpu_torch.ndarray import NDArray
    if isinstance(state, tuple):
        return tuple(_host_copy(s, device) for s in state)
    return None if state is None else NDArray(
        state.to_torch().detach().to(device, copy=True))


def _leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [] if state is None else [state]


# A float32 gradient of this depth is not reproducible to 1e-4: a ReLU or
# max-pool mask that flips under rounding moves its BatchNorm channel's
# gradient by a few percent. Measured on the CPU for ResNet-50 b8, step 1
# (train_sensitivity.py): float32 against float64 1.9% relative L2
# (median over the parameters, 2.7% worst; 1.9% with a two-pass
# variance too), 8 threads against 1 0.8% (1.0% of max(1, max|ref|)
# elementwise). Card and CPU are held elementwise where no gradient
# enters (losses, logits, BatchNorm statistics), and by the relative L2
# error per tensor where one does (gradients, each step's weight change,
# optimizer states).
TRAIN_L2 = 5e-2
# bf16 training-mode logits against float32's: the same net on the CPU in
# bf16 gives 0.092 of max|logit| at b8 step 1 (0.0077 in inference mode,
# with the running statistics; train_sensitivity.py), the card 0.089
BF16_VS_F32 = 0.15
# Inception v3 at b2 (299², 94 BatchNorms, the last ones over 2 x 8 x 8
# values): float32 step-1 gradients against float64 on the CPU 2.6%
# relative L2 median, 4.0% worst (train_sensitivity.py inception); its
# gate is about twice that worst, as TRAIN_L2 is about twice ResNet-50's
INCEPTION_TRAIN_L2 = 8e-2


def lockstep_train(label, card_net, cpu_net, batches, optimizer, params,
                   reshape=None, kernel=None, eager_net=None, trainers=None,
                   schedule=None, clip=None, generator=None,
                   l2_tol=TRAIN_L2):
    """The same float32 training steps on the card and on the CPU, each
    from the same state: before every step after the first the CPU takes
    the card's weights, BatchNorm statistics and optimizer states, so each
    step is held on its own (a step of lr 0.1 is chaotic enough that two
    devices' trajectories part after it). Per step, against the CPU:
    per-sample losses within 1e-5 of max|ref| and logits within 1e-4 of
    max|ref| (elementwise), BatchNorm running statistics within 1e-4 of
    max(1, max|ref|); gradients, the step's weight change and the
    optimizer states within ``l2_tol`` (TRAIN_L2 unless given) relative L2
    per tensor. ``kernel``'s
    launches are counted over each card step. ``eager_net``, when
    given, is one more reference held the same way: the same net on the
    card run eagerly (not hybridized, the fused step off) from the card's
    state; ``cpu_net`` may then be None. A hybridized ``card_net`` gets a
    hybridized loss. ``trainers`` keeps each net's (Trainer, loss) across
    calls (the captured graphs live in them); ``schedule`` gives per step
    (lr or None, batch-size multiplier) for ``trainer.step``; ``clip``
    clips the gradients by their global norm before it; ``generator``
    (the card's) is set to one state before each net's step, so the
    card's Dropout masks are drawn from the same offset. Returns
    (per-step launches, per-step mean card losses, worst errors, the CPU's
    step-1 (loss, logits))."""
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch import optimizer_fused
    nd = mt.nd
    refs = [] if cpu_net is None else [("cpu", cpu_net, mt.cpu())]
    if eager_net is not None:
        refs.append(("card eager", eager_net, mt.gpu(0)))
    nets = [("card", card_net, mt.gpu(0))] + refs
    tr = {} if trainers is None else trainers
    for dev, net, _ in nets:
        if dev not in tr:
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
            if dev == "card" and card_net._active:
                loss.hybridize()
            tr[dev] = (mt.gluon.Trainer(net.collect_params(), optimizer,
                                        dict(params)), loss)
    cps = list(card_net.collect_params().values())
    worst, launches, losses, first = {}, [], [], None

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    def elementwise(key, what, got, ref, tol, floor=0.0):
        mag = max(floor, float(np.abs(ref).max()))
        err = float(np.abs(got - ref).max()) / mag
        if got.shape != ref.shape or not np.isfinite(got).all() \
                or err > tol:
            raise AssertionError("%s %s: card differs from the CPU by %.3g "
                                 "of its scale (limit %g)" % (label, what,
                                                              err, tol))
        note(key, err)

    def l2(key, what, got, ref):
        norm = float(np.linalg.norm(ref.ravel()))
        diff = float(np.linalg.norm((got - ref).ravel()))
        err = diff / norm if norm else diff
        if got.shape != ref.shape or not np.isfinite(got).all() \
                or err > l2_tol:
            raise AssertionError("%s %s: relative L2 error %.3g against the "
                                 "CPU (limit %g)" % (label, what, err,
                                                     l2_tol))
        note(key, err)

    def host(a):
        return a.astype("float32").asnumpy()
    for step, (x, y) in enumerate(batches):
        lr, mult = (schedule[step] if schedule else (None, 1))
        for dev, net, ctx in refs:   # each reference resumes from the card
            for c, h in zip(cps, net.collect_params().values()):
                h.set_data(c.data().to_torch().detach())
            tr[dev][0]._updaters[0].states = {
                i: _host_copy(st, mt.context.resolve_device(ctx))
                for i, st in tr["card"][0]._updaters[0].states.items()}
        if lr is not None:
            for dev, _, _ in nets:
                tr[dev][0].set_learning_rate(lr)
        before = [host(p.data()) for p in cps]
        out = {}
        rng_state = None if generator is None else generator.get_state()
        for dev, net, ctx in nets:
            if rng_state is not None:
                generator.set_state(rng_state)
            xa = nd.array(x, ctx=ctx, dtype="float32" if x.dtype.kind == "f"
                          else "int32")
            start = None if kernel is None else kernel.launches
            prev = optimizer_fused.set_enabled(dev != "card eager")
            try:
                loss, logits = _step_program(
                    net, tr[dev][0], tr[dev][1], xa, nd.array(y, ctx=ctx),
                    reshape, batch_size=y.size * mult, clip=clip)
            finally:
                optimizer_fused.set_enabled(prev)
            if dev == "card" and kernel is not None:
                launches.append(kernel.launches - start)
            out[dev] = (host(loss), host(logits))
        losses.append(float(out["card"][0].mean()))
        if step == 0 and cpu_net is not None:
            first = out["cpu"]
        for dev, net, _ in refs:
            s = "step %d %s " % (step + 1, dev)
            elementwise("losses", s + "losses", out["card"][0], out[dev][0],
                        1e-5)
            elementwise("logits", s + "logits", out["card"][1],
                        out[dev][1], 1e-4)
            for c, h, b in zip(cps, net.collect_params().values(), before):
                name = s + h.name.partition("_")[2]
                if h.grad_req == "null":
                    elementwise("bn statistics", name, host(c.data()),
                                host(h.data()), 1e-4, floor=1.0)
                    continue
                l2("gradients", name + " gradient", host(c.grad()),
                   host(h.grad()))
                note("gradients elementwise (not gated)", float(np.abs(
                    host(c.grad()) - host(h.grad())).max()) / max(
                        1.0, float(np.abs(host(h.grad())).max())))
                l2("weight changes", name + " change", host(c.data()) - b,
                   host(h.data()) - b)
            for i, st in tr[dev][0]._updaters[0].states.items():
                mine = tr["card"][0]._updaters[0].states[i]
                for j, (c, h) in enumerate(zip(_leaves(mine), _leaves(st))):
                    l2("optimizer states", s + "state %d.%d" % (i, j),
                       host(c), host(h))
    return launches, losses, worst, first


def one_step(net, ctx, batch, optimizer, params, dtype, kernel=None,
             reshape=None):
    """One training step of ``net`` on ``batch``: (loss, logits) as
    float32 numpy and ``kernel``'s launches counted from 0 over it."""
    import mxtpu_torch as mt
    x, y = batch
    trainer = mt.gluon.Trainer(net.collect_params(), optimizer, dict(params))
    if kernel is not None:
        kernel.launches = 0
    loss, logits = _step_program(
        net, trainer, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
        mt.nd.array(x, ctx=ctx, dtype=dtype if x.dtype.kind == "f"
                    else "int32"), mt.nd.array(y, ctx=ctx), reshape)
    n = None if kernel is None else kernel.launches
    return (loss.astype("float32").asnumpy(),
            logits.astype("float32").asnumpy(), n)


def worst_line(worst):
    return ", ".join("%s %.3g" % kv for kv in sorted(worst.items()))


def resnet_batches(batch, steps, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 224, 224, 3)).astype(np.float32),
             rng.integers(0, 1000, batch).astype(np.float32))
            for _ in range(steps)]


def timed_steps(step, warm=3, n=10, on_warm=None):
    """(median ms, p80 ms, median host-issue ms) of ``n`` synchronised
    training steps after ``warm`` (``on_warm()`` is called between); host
    issue is the time until the step's last call returns."""
    import torch
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    if on_warm is not None:
        on_warm()
    wall, issue = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        issue.append(1e3 * (t1 - t0))
    wall.sort()
    issue.sort()
    return wall[n // 2], wall[(4 * n) // 5], issue[n // 2]


# kernel-name categories of a training step's breakdown, first match wins
STEP_CATEGORIES = [
    ("fused conv forward (B1)", ("fused_conv",)),
    ("flash forward (B2)", ("flash_attention",)),
    ("foreach optimizer update", ("multi_tensor_apply", "foreach")),
    ("cuDNN convs (fwd, dgrad, wgrad)", ("fprop", "dgrad", "wgrad", "cudnn",
                                         "conv2d", "convolution")),
    ("GEMMs", ("gemm", "cutlass", "nvjet")),
    ("reductions (BN/LN statistics, sums)", ("reduce", "Reduce")),
    ("elementwise (BN/LN apply, casts, adds, ReLU)", ("elementwise",
                                                      "vectorized", "copy",
                                                      "Elementwise")),
]


def print_step_breakdown(label, rows, wall_ms, flops_per_s, dtype, card):
    """A step's device time by category and by top kernel, its idle share
    against the unprofiled median, and train_mfu."""
    dev_ms = sum(r[1] for r in rows)
    cats = {}
    for name, ms, count in rows:
        cat = next((c for c, keys in STEP_CATEGORIES
                    if any(k_ in name for k_ in keys)), "other")
        ms0, n0 = cats.get(cat, (0.0, 0.0))
        cats[cat] = (ms0 + ms, n0 + count)
    peak = PEAK_FLOPS[dtype]
    print("%s per step: wall %.3f ms (median, unprofiled), device kernels "
          "%.3f ms (idle share %.3f), %d kernel launches; train_mfu %.4f "
          "(%.4g FLOP/s of %.4g peak %s) on %s" % (
              label, wall_ms, dev_ms, 1 - dev_ms / wall_ms,
              round(sum(r[2] for r in rows)), flops_per_s / peak,
              flops_per_s, peak, dtype, card))
    for cat, (ms, count) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print("  %-45s %.3f ms  x%g" % (cat, ms, round(count)))
    for name, ms, count in rows[:10]:
        print("    %.4f ms  x%-4g %s" % (ms, count, name[:100]))
    return dev_ms


def _builds():
    """Builds so far at the training step's two retrace sites."""
    from mxtpu_torch import telemetry
    return {site: (telemetry.retrace_stats(site) or {}).get("compiles", 0)
            for site in ("cached_op", "fused_optimizer")}


def train_timing(label, net, x, y, optimizer, params, reshape, card,
                 flops_per_item, items, dtype, kernel=None, clip=None):
    """Time ``net``'s training step on the card (3 warm-up, 10 timed),
    profile one step, and print items/s, host issue, device ms, idle
    share, peak memory and train_mfu. A hybridized ``net`` gets a
    hybridized loss, and the result also holds the builds at
    ``cached_op``/``fused_optimizer`` after the warm-up steps and
    ``kernel``'s launches in one more step. ``clip``: the gradients are
    clipped by their global norm between backward and the update (a read
    of the norm to the host each step, inside the timed step)."""
    import gc
    import torch
    import mxtpu_torch as mt
    gc.collect()   # nets dropped before (the port's blocks hold cycles)
    torch.cuda.empty_cache()
    trainer = mt.gluon.Trainer(net.collect_params(), optimizer, dict(params))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    if net._active:
        loss_fn.hybridize()

    def step():
        with mt.autograd.record():
            logits = net(x)
            if reshape is not None:
                logits = logits.reshape((-1, reshape))
            loss = loss_fn(logits, y.reshape((-1,)))
        loss.backward()
        if clip is not None:
            mt.gluon.utils.clip_global_norm(grads, clip)
        trainer.step(y.size)
    grads = [p.grad() for p in net.collect_params().values()
             if p.grad_req != "null"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = {}

    def on_warm():   # the steady peak leaves the captures' warm-up out
        warm.update(_builds(), peak=torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    med, p80, issue = timed_steps(step, on_warm=on_warm)
    steady_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_gb = max(warm.pop("peak") / 2 ** 30, steady_gb)
    rate = items * 1e3 / med
    after = _builds()
    launches = None
    if kernel is not None:
        start = kernel.launches
        step()
        torch.cuda.synchronize()
        launches = kernel.launches - start
    built = {k: after[k] - warm[k] for k in after}
    print("train %s on %s: %.1f %s/s at the median step %.3f ms (p80 %.3f, "
          "median host issue %.3f ms; 10 steps after 3), peak memory %.2f "
          "GiB (%.2f GiB over the timed steps); builds in the timed steps "
          "%s; launches in one step %s" % (
              label, card, rate, "images" if reshape is None else "tokens",
              med, p80, issue, peak_gb, steady_gb, built, launches),
          flush=True)
    dev_ms = print_step_breakdown("train " + label, device_rows(step, 2),
                                  med, flops_per_item * rate, dtype, card)
    return dict(step_ms=med, p80_ms=p80, issue_ms=issue, device_ms=dev_ms,
                rate=rate, peak_gib=peak_gb, steady_peak_gib=steady_gb,
                mfu=flops_per_item * rate / PEAK_FLOPS[dtype],
                builds_after_warmup=built, launches=launches)


def resnet_train_phase(card):
    """ResNet-50 v1 trained through gluon.Trainer (SGD lr 0.1, momentum
    0.9, wd 1e-4; SoftmaxCrossEntropyLoss): b8 f32, 2 steps on the card
    against the same 2 steps on the CPU (11 fused_conv launches a step);
    one bf16 step against the f32 CPU step; then b64 f32 and b128 bf16
    timed. Returns the fused_conv launches per step by type."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    batches = resnet_batches(8, 2, 11)
    net, arrays = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    cpu_net, _ = build_net(arrays)
    t0 = time.time()
    launches, losses, worst, (ref_loss, ref_logits) = lockstep_train(
        "resnet50 train f32", net, cpu_net, batches, "sgd", SGD_PARAMS,
        kernel=fused_conv)
    if launches != [11, 11]:
        raise AssertionError("resnet50 training: fused_conv launched %s "
                             "times per step, expected 11 each" % launches)
    print("train resnet50_v1 f32 b8, 2 SGD steps on the card, each against "
          "the same step on the CPU from the card's state (%.1f s): "
          "fused_conv launches %s; mean losses %s; worst errors "
          "(elementwise of the scale, or relative L2): %s" % (
              time.time() - t0, launches, losses, worst_line(worst)),
          flush=True)
    # bf16: one step from the same weights against the f32 CPU step
    net16, _ = build_net(arrays)
    net16.collect_params().reset_ctx(mt.gpu(0))
    net16.cast("bfloat16")
    loss16, logits16, launches16 = one_step(
        net16, mt.gpu(0), batches[0], "sgd",
        dict(SGD_PARAMS, multi_precision=True), "bfloat16", fused_conv)
    if launches16 != 11:
        raise AssertionError("resnet50 bf16 step launched fused_conv %d "
                             "times" % launches16)
    errs = {}
    for key, got, ref in (("logits", logits16, ref_logits),
                          ("loss", loss16, ref_loss)):
        errs[key] = float(np.abs(got - ref).max() / np.abs(ref).max())
        if not np.isfinite(got).all() or errs[key] > BF16_VS_F32:
            raise AssertionError("resnet50 bf16 step-1 %s differs from the "
                                 "f32 CPU step by %.3g of max|ref| (limit "
                                 "%g)" % (key, errs[key], BF16_VS_F32))
    print("train resnet50_v1 bf16 b8 step 1 against the f32 CPU step: "
          "logits %.3g, loss %.3g of max|ref| (limit %g); fused_conv "
          "launches %d" % (errs["logits"], errs["loss"], BF16_VS_F32,
                           launches16), flush=True)
    del cpu_net
    timing = {}
    for dtype, batch, params in (
            ("float32", 64, SGD_PARAMS),
            ("bfloat16", 128, dict(SGD_PARAMS, multi_precision=True))):
        tnet = net if dtype == "float32" else net16
        rng = np.random.default_rng(12)
        x = mt.nd.array(rng.standard_normal((batch, 224, 224, 3)),
                        ctx=mt.gpu(0), dtype=dtype)
        y = mt.nd.array(rng.integers(0, 1000, batch).astype(np.float32),
                        ctx=mt.gpu(0))
        timing[dtype] = train_timing(
            "resnet50_v1 %s b%d (SGD-momentum%s)" % (
                dtype, batch, ", multi_precision" if dtype != "float32"
                else ""), tnet, x, y, "sgd", params, None, card,
            RESNET50_TRAIN_FLOPS, batch, dtype)
        del x, y
        torch.cuda.empty_cache()
    return {"float32": launches[0], "bfloat16": launches16}, timing


def lm_batches(b, t, steps, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    vocab = BERT_BASE["vocab_size"]
    return [(rng.integers(0, vocab, (b, t), dtype=np.int32),
             rng.integers(0, vocab, (b, t)).astype(np.float32))
            for _ in range(steps)]


def build_train_lm(layers, arrays=None):
    """The TransformerLM at BERT-base widths with ``layers`` layers on the
    CPU, with seeded weights (or ``arrays``): (net, arrays)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(**dict(BERT_BASE, num_layers=layers))
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=0)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def lm_train_phase(card):
    """The TransformerLM trained through gluon.Trainer (Adam lr 1e-4,
    SoftmaxCrossEntropyLoss over the vocab, as bench.py's BERT-base step):
    2 layers at BERT-base widths, b2 x 512 f32, 2 steps on the card
    against the CPU (one flash launch per layer a step); then the full 12
    layers at b8 x 512 bf16 timed. Returns flash launches per step by
    type."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    vocab = BERT_BASE["vocab_size"]
    build = build_train_lm
    batches = lm_batches(2, 512, 2, 13)
    net, arrays = build(2)
    net.collect_params().reset_ctx(mt.gpu(0))
    cpu_net, _ = build(2, arrays)
    t0 = time.time()
    launches, losses, worst, _ = lockstep_train(
        "transformer_lm train f32", net, cpu_net, batches, "adam",
        ADAM_PARAMS, reshape=vocab, kernel=flash_attention)
    if launches != [2, 2]:
        raise AssertionError("transformer_lm training: flash launched %s "
                             "times per step, expected 2 each" % launches)
    print("train transformer_lm (2 layers, BERT-base widths) f32 b2 x 512, "
          "2 Adam steps on the card, each against the same step on the CPU "
          "from the card's state (%.1f s): flash launches %s; mean losses "
          "%s; worst errors (elementwise of the scale, or relative L2): %s"
          % (time.time() - t0, launches, losses, worst_line(worst)),
          flush=True)
    del net, cpu_net
    layers, b, t = BERT_BASE["num_layers"], 8, 512
    big, _ = build(layers)
    big.collect_params().reset_ctx(mt.gpu(0))
    big.cast("bfloat16")
    (tokens, labels), = lm_batches(b, t, 1, 14)
    x = mt.nd.array(tokens, ctx=mt.gpu(0), dtype="int32")
    y = mt.nd.array(labels, ctx=mt.gpu(0))
    loss, _, step_launches = one_step(
        big, mt.gpu(0), (tokens, labels), "adam",
        dict(ADAM_PARAMS, multi_precision=True), "bfloat16", flash_attention,
        reshape=vocab)
    if step_launches != layers or not np.isfinite(loss).all():
        raise AssertionError("transformer_lm bf16 step: %d flash launches "
                             "(expected %d), finite loss %s" % (
                                 step_launches, layers,
                                 np.isfinite(loss).all()))
    dim = BERT_BASE["dim"]
    flops = 3 * 2 * (layers * (12 * dim * dim + 2 * t * dim) + dim * vocab)
    timing = train_timing(
        "transformer_lm bf16 b%d x %d (12 layers, Adam, multi_precision)"
        % (b, t), big, x, y, "adam", dict(ADAM_PARAMS, multi_precision=True),
        vocab, card, flops, b * t, "bfloat16")
    return {"float32": launches[0], "bfloat16": step_launches}, timing


CAPTURED_LR = 0.05        # the lr of the schedule check's step
CAPTURED_BATCH_MULT = 2   # the batch-size check steps with 2x the labels


def captured_train_phase(card, eager_timing):
    """The training step captured (ROADMAP A2.4): ``net.hybridize()`` and
    ``loss_fn.hybridize()`` in the user's loop (``_step_program``), so each
    recorded call replays a forward/backward graph pair and each
    ``Trainer.step`` replays one update graph per parameter group.

    Gates: ResNet-50 v1 f32 b8 and the 2-layer BERT-base TransformerLM f32
    b2 x 512, two captured steps each against the same steps on the CPU
    and eagerly on the card (``lockstep_train``); then on ResNet-50 a step
    after ``set_learning_rate`` and one with twice the batch size in
    ``step``, against the card's eager step, with no new build at
    ``cached_op`` or ``fused_optimizer``; two recorded forwards before one
    backward, gradients against the eager ones (TRAIN_L2); the trained
    net saved with ``save_parameters`` and loaded into a fresh one serves
    the same logits. Timed: ResNet-50 f32 b64 and bf16 b128 and the
    12-layer TransformerLM bf16 b8 x 512 (``train_timing``, beside the
    eager numbers of this run), with 11 fused_conv / 12 flash launches
    and no build in a step after the warm-up. Returns the launches per
    captured step by kernel and type."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.serving import BucketSpec, Predictor
    import gc
    nd, gpu = mt.nd, mt.gpu(0)
    t_phase = time.time()

    def on_card(net, hybrid=False):
        net.collect_params().reset_ctx(gpu)
        if hybrid:
            net.hybridize()
        return net

    # ResNet-50 v1 f32 b8: lockstep with the CPU and the card's eager step
    gnet, arrays = build_net()
    on_card(gnet, True)
    enet = on_card(build_net(arrays)[0])
    cpu_net, _ = build_net(arrays)
    batches = resnet_batches(8, 4, 21)
    tr = {}
    t0 = time.time()
    launches, losses, worst, _ = lockstep_train(
        "resnet50 captured train f32", gnet, cpu_net, batches[:2], "sgd",
        SGD_PARAMS, kernel=fused_conv, eager_net=enet, trainers=tr)
    del cpu_net
    if launches[1] != 11:
        raise AssertionError("resnet50 captured step: fused_conv launched "
                             "%s times per step, expected 11" % launches)
    print("captured train resnet50_v1 f32 b8, 2 SGD steps, each against the "
          "same step on the CPU and eagerly on the card from the captured "
          "net's state (%.1f s): fused_conv launches %s (the first step "
          "captures); mean losses %s; builds %s; worst errors: %s" % (
              time.time() - t0, launches, losses, _builds(),
              worst_line(worst)), flush=True)
    built = _builds()
    t0 = time.time()
    launches2, losses2, worst2, _ = lockstep_train(
        "resnet50 captured train f32 (lr, batch size)", gnet, None,
        batches[2:4], "sgd", SGD_PARAMS, kernel=fused_conv, eager_net=enet,
        trainers=tr, schedule=[(CAPTURED_LR, 1), (None, CAPTURED_BATCH_MULT)])
    if _builds() != built or launches2 != [11, 11]:
        raise AssertionError(
            "resnet50 captured step after an lr change / a batch-size "
            "change: builds %s -> %s, fused_conv launches %s" % (
                built, _builds(), launches2))
    print("captured train resnet50_v1: a step at lr %g, then one with "
          "step(%d x batch), each against the card's eager step (%.1f s): "
          "no new build (%s), fused_conv launches %s; worst errors: %s" % (
              CAPTURED_LR, CAPTURED_BATCH_MULT, time.time() - t0, built,
              launches2, worst_line(worst2)), flush=True)
    # two recorded forwards of one signature before one backward
    for c, h in zip(gnet.collect_params().values(),
                    enet.collect_params().values()):
        h.set_data(c.data().to_torch().detach())
    before = _builds()
    grads = []
    for net, loss_fn in ((gnet, tr["card"][1]),
                         (enet, mt.gluon.loss.SoftmaxCrossEntropyLoss())):
        net.collect_params().zero_grad()
        with mt.autograd.record():
            total = None
            for x, y in batches[:2]:
                part = loss_fn(net(nd.array(x, ctx=gpu)), nd.array(y, ctx=gpu))
                total = part if total is None else total + part
        total.backward()
        grads.append([p.grad().asnumpy() for p in
                      net.collect_params().values() if p.grad_req != "null"])
    err = 0.0
    for a, b in zip(*grads):
        e = float(np.linalg.norm((a - b).ravel())
                  / max(np.linalg.norm(b.ravel()), 1e-30))
        err = max(err, e)
    added = {k: _builds()[k] - before[k] for k in before}
    if not np.isfinite(err) or err > TRAIN_L2:
        raise AssertionError("two forwards, one backward: gradients differ "
                             "from the eager ones by relative L2 %.3g "
                             "(limit %g)" % (err, TRAIN_L2))
    print("captured resnet50_v1: two recorded forwards before one backward: "
          "gradients against the card's eager ones, worst relative L2 %.3g "
          "(limit %g); builds added %s (the net's and the loss's second "
          "pair)" % (err, TRAIN_L2, added), flush=True)
    # save, load into a fresh net, serve both
    path = os.path.join(ROOT, "build", "captured_resnet50_v1.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    gnet.save_parameters(path)
    fresh = on_card(build_net()[0])
    fresh.load_parameters(path)
    x = np.random.default_rng(22).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)
    served = [Predictor(n, BucketSpec([8]), device=gpu).predict(x).asnumpy()
              for n in (gnet, fresh)]
    mag = float(np.abs(served[0]).max())
    err = float(np.abs(served[0] - served[1]).max())
    print("captured resnet50_v1: save_parameters (%d bytes) -> "
          "load_parameters into a fresh net: served b8 logits differ by %.3g "
          "(max|logit| %.3g)" % (os.path.getsize(path), err, mag), flush=True)
    os.remove(path)
    if not np.isfinite(served[1]).all() or err > 1e-6 * mag:
        raise AssertionError("the loaded net serves other logits (%.3g of "
                             "max|logit|)" % (err / mag))
    del fresh, enet, served, grads, tr
    # the 2-layer TransformerLM f32 b2 x 512
    vocab = BERT_BASE["vocab_size"]
    glm, lm_arrays = build_train_lm(2)
    on_card(glm, True)
    elm = on_card(build_train_lm(2, lm_arrays)[0])
    clm, _ = build_train_lm(2, lm_arrays)
    t0 = time.time()
    lm_launches, lm_losses, lm_worst, _ = lockstep_train(
        "transformer_lm captured train f32", glm, clm,
        lm_batches(2, 512, 2, 23), "adam", ADAM_PARAMS, reshape=vocab,
        kernel=flash_attention, eager_net=elm)
    if lm_launches[1] != 2:
        raise AssertionError("transformer_lm captured step: flash launched "
                             "%s times per step, expected 2" % lm_launches)
    print("captured train transformer_lm (2 layers, BERT-base widths) f32 "
          "b2 x 512, 2 Adam steps against the CPU and the card's eager step "
          "(%.1f s): flash launches %s; mean losses %s; worst errors: %s" % (
              time.time() - t0, lm_launches, lm_losses,
              worst_line(lm_worst)), flush=True)
    del glm, elm, clm, gnet
    # timed, captured, each on a fresh net
    timing = {}
    rng = np.random.default_rng(12)
    for dtype, batch in (("float32", 64), ("bfloat16", 128)):
        params = SGD_PARAMS if dtype == "float32" else dict(
            SGD_PARAMS, multi_precision=True)
        net = on_card(build_net(arrays)[0])
        net.cast(dtype)
        net.hybridize()
        x = nd.array(rng.standard_normal((batch, 224, 224, 3)), ctx=gpu,
                     dtype=dtype)
        y = nd.array(rng.integers(0, 1000, batch).astype(np.float32),
                     ctx=gpu)
        timing["resnet50 " + dtype] = train_timing(
            "resnet50_v1 %s b%d captured (SGD-momentum%s)" % (
                dtype, batch, ", multi_precision" if dtype != "float32"
                else ""), net, x, y, "sgd", params, None, card,
            RESNET50_TRAIN_FLOPS, batch, dtype, kernel=fused_conv)
        del net, x, y
    layers, b, t = BERT_BASE["num_layers"], 8, 512
    big = on_card(build_train_lm(layers)[0])
    big.cast("bfloat16")
    big.hybridize()
    (tokens, labels), = lm_batches(b, t, 1, 14)
    dim = BERT_BASE["dim"]
    flops = 3 * 2 * (layers * (12 * dim * dim + 2 * t * dim) + dim * vocab)
    timing["transformer_lm bfloat16"] = train_timing(
        "transformer_lm bf16 b%d x %d captured (12 layers, Adam, "
        "multi_precision)" % (b, t), big,
        nd.array(tokens, ctx=gpu, dtype="int32"), nd.array(labels, ctx=gpu),
        "adam", dict(ADAM_PARAMS, multi_precision=True), vocab, card, flops,
        b * t, "bfloat16", kernel=flash_attention)
    del big
    gc.collect()
    torch.cuda.empty_cache()
    want = {"resnet50 float32": 11, "resnet50 bfloat16": 11,
            "transformer_lm bfloat16": layers}
    print("captured training step beside the step of this run's training "
          "phases on %s (eager forward and backward; their Trainer's update "
          "is captured too, as every Trainer's on the card now is) "
          "(items/s, median ms, p80 ms, host issue ms, device ms, idle "
          "share, peak GiB, peak GiB over the timed steps, train_mfu):"
          % card)
    for key, tm in timing.items():
        ea = eager_timing.get(key)
        for name, row in (("captured", tm), ("eager f/b", ea)):
            if row is None:
                continue
            print("  %-24s %-9s %10.1f %9.3f %9.3f %9.3f %9.3f %6.3f %6.2f "
                  "%6.2f %.4f" % (key, name, row["rate"], row["step_ms"],
                                  row["p80_ms"], row["issue_ms"],
                                  row["device_ms"],
                                  1 - row["device_ms"] / row["step_ms"],
                                  row["peak_gib"], row["steady_peak_gib"],
                                  row["mfu"]))
        if tm["launches"] != want[key] or any(tm["builds_after_warmup"]
                                              .values()):
            raise AssertionError(
                "captured %s: %s launches in a step (expected %d), builds "
                "after the warm-up %s" % (key, tm["launches"], want[key],
                                          tm["builds_after_warmup"]))
    print("captured training phase %.1f s" % (time.time() - t_phase),
          flush=True)
    CAPTURED_TIMING.update(timing)   # the symbolic phase prints beside it
    return {"conv": {"float32": launches[1], "bfloat16":
                     timing["resnet50 bfloat16"]["launches"]},
            "flash": {"float32": lm_launches[1], "bfloat16":
                      timing["transformer_lm bfloat16"]["launches"]}}


# ---------------------------------------------------------------- slice 9
# B1's shape classes that the zoo's paths add to ResNet-50's, one conv of
# each at b8 (name, batch, H, W, C_in, C_out, kh, kw, stride, padding)
ZOO_CONV_SHAPES = [
    ("1x1 64->16 @55 squeezenet1_1", 8, 55, 55, 64, 16, 1, 1, 1,
     ((0, 0), (0, 0))),
    ("1x1 96->24 @56 mobilenet_v2", 8, 56, 56, 96, 24, 1, 1, 1,
     ((0, 0), (0, 0))),
    ("1x1 256->48 @13 squeezenet1_1", 8, 13, 13, 256, 48, 1, 1, 1,
     ((0, 0), (0, 0))),
    ("1x1 64->80 @73 inception_v3", 8, 73, 73, 64, 80, 1, 1, 1,
     ((0, 0), (0, 0))),
    ("3x3 64->96 @35 inception_v3", 8, 35, 35, 64, 96, 3, 3, 1,
     ((1, 1), (1, 1))),
    ("1x1 24->144 @56 mobilenet_v2", 8, 56, 56, 24, 144, 1, 1, 1,
     ((0, 0), (0, 0))),
    ("11x11/4 3->64 @224 alexnet", 8, 224, 224, 3, 64, 11, 11, 4,
     ((2, 2), (2, 2))),
    ("5x5 48->64 @35 inception_v3", 8, 35, 35, 48, 64, 5, 5, 1,
     ((2, 2), (2, 2))),
    ("3x3/2 3->32 @224 mobilenet", 8, 224, 224, 3, 32, 3, 3, 2,
     ((1, 1), (1, 1))),
    ("4x4 12->64 @112 s2d stem", 8, 112, 112, 12, 64, 4, 4, 1,
     ((2, 1), (2, 1))),
]
# (model, input side, B1 launches per forward at that side, channels-last)
ZOO_SERVE = [("alexnet", 224, 1), ("vgg16", 224, 2),
             ("squeezenet1_1", 224, 19), ("mobilenet1_0", 224, 3),
             ("mobilenet_v2_1_0", 224, 28), ("densenet121", 224, 61),
             ("inception_v3", 299, 28), ("resnet50_v2", 224, 11)]
INCEPTION_B1 = 28        # B1 launches per Inception v3 forward
CLIP_NORM = 1.0          # clip_global_norm's max_norm in the zoo training
DROPOUT_N = 1 << 22      # elements of the Dropout gates' input


def _lib_conv(x, w, stride, padding, bias=None):
    """``F.conv2d`` on channels-last views of the same conv (asymmetric
    padding applied first), a yardstick only."""
    import torch.nn.functional as F
    (plo, phi), (qlo, qhi) = padding
    xn = x.permute(0, 3, 1, 2)
    if plo != phi or qlo != qhi:
        xn = F.pad(xn, (qlo, qhi, plo, phi))
        pad = (0, 0)
    else:
        pad = (plo, qlo)
    wn = w.permute(3, 2, 0, 1)
    return lambda: F.conv2d(xn, wn, bias, stride=stride, padding=pad)


def zoo_conv_phase():
    """B1 against its plain version on the card, float32 and bfloat16, at
    one conv of each shape class the zoo's paths add (ZOO_CONV_SHAPES:
    C_out 16/24/48/80/96/144 tile tails, the 11x11/4 and 3x3/2 stems on 3
    channels (element-wise staging of A), a 5x5, the s2d stem's 4x4 with
    asymmetric padding); each timed by graph replay beside ``F.conv2d``.
    Returns the rows."""
    import torch
    from mxtpu_torch.ops.pallas.conv import (_launch_args, fused_conv,
                                             fused_conv_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, n, h, w_, cin, cout, kh, kw, s, pad in ZOO_CONV_SHAPES:
            x = torch.randn(n, h, w_, cin, device="cuda", generator=gen).to(dt)
            w = (torch.randn(kh, kw, cin, cout, device="cuda", generator=gen)
                 * math.sqrt(2.0 / (kh * kw * cin))).to(dt)
            la = _launch_args(x, w, (s, s), pad)
            out = fused_conv(x, w, (s, s), pad)
            torch.cuda.synchronize()
            ref = fused_conv_reference(x.float(), w.float(), (s, s), pad)[0]
            err = check(out, ref, dtype, "%s %s" % (name, dtype))
            kern = lambda: fused_conv(x, w, (s, s), pad)
            lib = _lib_conv(x, w, (s, s), pad)
            bms, by = conv_bound_ms(x, w, out.numel(), dtype)
            row = dict(shape=name, dtype=dtype, max_abs_err=err,
                       graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            print("%s  graph replay: kernel %.4f ms  F.conv2d %.4f ms "
                  "(kernel/F.conv2d %.3f); bound %.4f ms (%s)" % (
                      conv_row_line(name, dtype, err, la), row["graph_ms"],
                      row["library_graph_ms"],
                      row["graph_ms"] / row["library_graph_ms"], bms, by),
                  flush=True)
    return rows


def build_zoo(name, side, arrays=None):
    """A zoo model on the CPU, channels-last, 1000 classes, its shapes
    settled by a b1 forward at ``side``, with seeded weights
    (``convert.seeded_params``) or ``arrays``."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import vision
    with mt.layout("NHWC"):
        net = vision.get_model(name, classes=1000)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, side, side, 3))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=0)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def b1_calls(fn):
    """The B1 convs that one call of ``fn`` launches: {(x shape, w shape,
    stride, padding, biased, dtype): count}, read from the arguments of
    the wrapper's ``_forward`` (looked up at each call)."""
    import collections
    from mxtpu_torch.ops.pallas import conv as pconv
    calls = collections.Counter()
    orig = pconv._forward

    def spy(x, w, strides, padding, scale, bias, residual, relu, oh, ow):
        calls[(tuple(x.shape), tuple(w.shape), tuple(strides),
               tuple(map(tuple, padding)), bias is not None,
               str(x.dtype))] += 1
        return orig(x, w, strides, padding, scale, bias, residual, relu,
                    oh, ow)
    pconv._forward = spy
    try:
        fn()
    finally:
        pconv._forward = orig
    return calls


def b1_vs_library(calls):
    """(B1 ms, F.conv2d ms, bound ms) per forward, the times by graph
    replay, summed over ``calls`` (b1_calls) on random inputs of those
    shapes; each conv's bound is ``conv_bound_ms`` of its shapes."""
    import torch
    from mxtpu_torch.ops.pallas.conv import fused_conv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    mine = lib = bound = 0.0
    for (xs, ws, s, pad, biased, dts), count in calls.items():
        dt = getattr(torch, dts.split(".")[-1])
        x = torch.randn(*xs, device="cuda", generator=gen).to(dt)
        w = (0.1 * torch.randn(*ws, device="cuda", generator=gen)).to(dt)
        b = (torch.randn(ws[-1], device="cuda", generator=gen).to(dt)
             if biased else None)
        mine += count * graph_ms(lambda: fused_conv(x, w, s, pad, bias=b))
        lib += count * graph_ms(_lib_conv(x, w, s, pad, b))
        oh = (xs[1] + sum(pad[0]) - ws[0]) // s[0] + 1
        ow = (xs[2] + sum(pad[1]) - ws[1]) // s[1] + 1
        bound += count * conv_bound_ms(x, w, xs[0] * oh * ow * ws[3],
                                       dts.split(".")[-1])[0]
    return mine, lib, bound


def zoo_serve_phase(card):
    """Every vision family of the zoo (ZOO_SERVE) served through
    ``Predictor`` on the card, channels-last, seeded weights, 1000
    classes, one captured b8 bucket, float32 then bfloat16: the logits of
    the first two images against the same net on the CPU (1e-3 / 5e-2 of
    max|logit|), the b8 replay against the same forward run eagerly on
    the card, B1's launches per forward against ZOO_SERVE's; timed by
    closed loop (median, p80, host issue), a profiled forward (device ms,
    idle share, kernels per forward, B1's ms) and B1's convs of one
    forward by graph replay beside ``F.conv2d``'s. Returns {model: {dtype:
    B1 launches per forward}}."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.serving import BucketSpec, Predictor
    t_phase = time.time()
    rng = np.random.default_rng(31)
    launches = {}
    table = []
    for name, side, want in ZOO_SERVE:
        t0 = time.time()
        cpu_net, arrays = build_zoo(name, side)
        net, _ = build_zoo(name, side, arrays)
        x_np = rng.standard_normal((8, side, side, 3)).astype(np.float32)
        launches[name] = {}
        for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
            dt = getattr(torch, dtype)
            if dtype == "bfloat16":
                net.cast("bfloat16")
                cpu_net.cast("bfloat16")
            pred = Predictor(net, BucketSpec([8]),
                             example=torch.zeros(1, side, side, 3, dtype=dt),
                             warmup=True, device="cuda",
                             site="serving.predict.%s.%s" % (name, dtype))
            x8 = torch.from_numpy(x_np).to("cuda", dt)
            fused_conv.launches = 0
            out = pred.predict(x8).to_torch()
            torch.cuda.synchronize()
            n_b1 = fused_conv.launches
            launches[name][dtype] = n_b1
            if n_b1 != want:
                raise AssertionError("%s %s: fused_conv launched %d times in "
                                     "one forward, expected %d"
                                     % (name, dtype, n_b1, want))
            with torch.no_grad():
                ref = cpu_net(torch.from_numpy(x_np[:2]).to(dt)).float()
            got = out[:2].float().cpu()
            mag = ref.abs().max().item()
            err = (got - ref).abs().max().item() / mag
            if tuple(out.shape) != (8, 1000) or not bool(
                    torch.isfinite(out.float()).all()) or err > tol:
                raise AssertionError("%s %s: logits %s differ from the CPU "
                                     "run by %.3g of max|logit| (limit %g)"
                                     % (name, dtype, tuple(out.shape), err,
                                        tol))
            diff = replay_vs_eager(pred, x8, "%s %s" % (name, dtype))
            if diff > tol * mag:
                raise AssertionError("%s %s: replay differs from eager by "
                                     "%.3g" % (name, dtype, diff))
            med, p80, issue = closed_loop(pred, x8)
            rows = device_rows(lambda: pred.predict(x8), 3)
            dev = sum(r[1] for r in rows)
            b1_ms = sum(r[1] for r in rows if "fused_conv_" in r[0])
            kernels = round(sum(r[2] for r in rows))
            mine, lib, bound = b1_vs_library(b1_calls(lambda: eager(pred,
                                                                  x8)))
            table.append((name, dtype, med, p80, 8e3 / med, issue, dev,
                          1 - dev / med, kernels, n_b1, b1_ms, mine, lib,
                          err, diff))
            print("zoo serve %s %s b8 on %s: %.1f images/s at the median "
                  "%.3f ms (p80 %.3f, host issue %.3f ms); device %.3f ms "
                  "(idle share %.3f), %d kernels a forward; fused_conv x%d "
                  "%.3f ms in the profile, by graph replay %.3f ms beside "
                  "F.conv2d's %.3f ms for the same convs (their bound %.4f "
                  "ms); logits vs CPU %.3g of max|logit|, replay vs eager "
                  "%.3g" % (
                      name, dtype, card, 8e3 / med, med, p80, issue, dev,
                      1 - dev / med, kernels, n_b1, b1_ms, mine, lib, bound,
                      err, diff), flush=True)
            print_breakdown("zoo serve %s %s b8 graph" % (name, dtype), rows,
                            med, "fused_conv_", n_b1)
            del pred
        del net, cpu_net
        print("zoo serve %s: %.1f s" % (name, time.time() - t0), flush=True)
    print("zoo serve table on %s (model, dtype, median ms, p80 ms, "
          "images/s, host issue ms, device ms, idle share, kernels, B1 "
          "launches, B1 profiled ms, B1 graph ms, F.conv2d graph ms, logit "
          "err, replay diff):" % card)
    for row in table:
        print("  %-18s %-9s %8.3f %8.3f %9.1f %7.3f %8.3f %6.3f %5d %3d "
              "%7.3f %7.3f %7.3f %.3g %.3g" % row)
    print("zoo serve phase %.1f s" % (time.time() - t_phase), flush=True)
    return launches


def _dropouts(net, rate):
    """Set every Dropout of ``net`` to ``rate``."""
    import mxtpu_torch as mt
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.Dropout):
            m._rate = rate


def forward_flops(net, x):
    """FLOPs of one forward of ``net`` on ``x`` (2 per multiply-add of
    every conv and dense layer), counted by forward hooks."""
    import torch
    import mxtpu_torch as mt
    nn = mt.gluon.nn
    total = [0]

    def hook(block, args, out):
        w = block.weight.data().to_torch()
        per_out = w.numel() // w.shape[-1 if isinstance(
            block, nn.Conv2D) and block._channels_last else 0]
        total[0] += 2 * out.numel() * per_out
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2D, nn.Dense))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.detach()
    return total[0]


def dropout_gates():
    """A hybridized Dropout in a captured pair on the card: the first
    recorded call against the same Dropout run eagerly from the same
    generator state (whether torch's captured Philox draws equal eager's:
    reported, not gated), two replays give different masks, each kept
    share within 4 sigma of 1 - p, the input's gradient equal to
    mask * g / (1 - p) exactly, and a draw from a generator that the
    graph did not register raises. Returns whether captured and eager
    draws are equal."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import random as mrandom
    from mxtpu_torch.base import MXNetError
    p, n = 0.5, DROPOUT_N
    keep = 1 - p
    gen = mrandom.generator("cuda:0")
    eager_drop = mt.gluon.nn.Dropout(p)
    drop = mt.gluon.nn.Dropout(p)
    drop.hybridize()
    x = torch.ones(n, device="cuda", requires_grad=True)
    g = torch.randn(n, device="cuda")
    state = gen.get_state()
    with mt.autograd.record():
        ref = eager_drop(x)
    gen.set_state(state)
    masks = []
    for call in range(2):
        x.grad = None
        with mt.autograd.record():
            out = drop(x)
        out.backward(g)
        torch.cuda.synchronize()
        mask = out != 0
        share = mask.float().mean().item()
        sigma = math.sqrt(p * (1 - p) / n)
        if abs(share - keep) > 4 * sigma:
            raise AssertionError("captured Dropout call %d kept %.5f, "
                                 "expected %.2f +- 4 x %.2g"
                                 % (call + 1, share, keep, sigma))
        want = torch.where(mask, g / keep, torch.zeros_like(g))
        if not torch.equal(x.grad, want) or not torch.equal(
                out[mask], torch.full_like(out[mask], 1 / keep)):
            raise AssertionError("captured Dropout call %d: the gradient is "
                                 "not mask * g / (1 - p)" % (call + 1))
        masks.append(mask)
    if torch.equal(masks[0], masks[1]):
        raise AssertionError("two replays of the captured Dropout drew the "
                             "same mask")
    equal = bool(torch.equal(masks[0], ref != 0))
    unregistered = mt.gluon.nn.HybridLambda(
        lambda F, x: F.Dropout(x, p=p))
    unregistered.hybridize()
    try:
        with mt.autograd.record():
            unregistered(x)
    except MXNetError as e:
        if "register the generator" not in str(e):
            raise
    else:
        raise AssertionError("a draw from an unregistered generator inside "
                             "a capture did not raise")
    print("dropout gates (p %.1f, %d elements, captured pair on the card): "
          "kept shares %s, two replays differ, the gradient is mask * g / "
          "(1 - p) exactly, an unregistered draw raises; the first captured "
          "mask %s the eager mask drawn from the same generator state" % (
              p, n, [round(m.float().mean().item(), 5) for m in masks],
              "equals" if equal else "DIFFERS FROM"), flush=True)
    return equal


def zoo_train_phase(card):
    """Inception v3 (channels-last, 299x299, 1000 classes, seeded weights)
    trained through ``gluon.Trainer`` with ``hybridize()`` on net and loss
    (a captured forward/backward pair whose Dropout draws inside the
    graphs) and ``clip_global_norm`` of the gradients between backward and
    ``step``: f32 b2, 3 SGD-momentum steps against the same steps on the
    CPU and eagerly on the card with the Dropout's rate 0 (the CPU's
    draws are another stream); the Dropout gates; 2 steps with the rate
    0.5 against the card's eager step from the same generator state,
    where captured draws equal eager ones; then bf16 b64 timed, eager
    forward/backward beside captured, with 28 fused_conv launches and no
    build after the warm-up. Returns {"float32": launches of a lockstep
    step, "bfloat16": launches of a timed captured step}."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import random as mrandom
    from mxtpu_torch.ops.pallas.conv import fused_conv
    t_phase = time.time()
    gpu = mt.gpu(0)
    side = 299

    def on_card(net, hybrid=False):
        net.collect_params().reset_ctx(gpu)
        if hybrid:
            net.hybridize()
        return net
    cpu_net, arrays = build_zoo("inception_v3", side)
    flops = 3 * forward_flops(cpu_net, torch.zeros(1, side, side, 3))
    gnet = on_card(build_zoo("inception_v3", side, arrays)[0], True)
    enet = on_card(build_zoo("inception_v3", side, arrays)[0])
    for net in (gnet, enet, cpu_net):
        _dropouts(net, 0.0)
    rng = np.random.default_rng(41)
    batches = [(rng.standard_normal((2, side, side, 3)).astype(np.float32),
                rng.integers(0, 1000, 2).astype(np.float32))
               for _ in range(5)]
    tr = {}
    t0 = time.time()
    launches, losses, worst, _ = lockstep_train(
        "inception_v3 captured train f32 (dropout 0)", gnet, cpu_net,
        batches[:3], "sgd", SGD_PARAMS, kernel=fused_conv, eager_net=enet,
        trainers=tr, clip=CLIP_NORM, l2_tol=INCEPTION_TRAIN_L2)
    if launches[1:] != [INCEPTION_B1] * 2:
        raise AssertionError("inception_v3 captured step: fused_conv "
                             "launched %s times per step, expected %d"
                             % (launches, INCEPTION_B1))
    print("captured train inception_v3 f32 b2, 3 SGD steps with "
          "clip_global_norm(%g), dropout 0, each against the same step on "
          "the CPU and eagerly on the card (%.1f s): fused_conv launches %s "
          "(the first step captures); mean losses %s; builds %s; worst "
          "errors: %s" % (CLIP_NORM, time.time() - t0, launches, losses,
                          _builds(), worst_line(worst)), flush=True)
    del cpu_net
    equal = dropout_gates()
    for net in (gnet, enet):
        _dropouts(net, 0.5)
    gnet.hybridize()    # new graphs: the rate is baked into the capture
    if equal:
        t0 = time.time()
        launches2, losses2, worst2, _ = lockstep_train(
            "inception_v3 captured train f32 (dropout 0.5)", gnet, None,
            batches[3:5], "sgd", SGD_PARAMS, kernel=fused_conv,
            eager_net=enet, clip=CLIP_NORM,
            generator=mrandom.generator("cuda:0"),
            l2_tol=INCEPTION_TRAIN_L2)
        print("captured train inception_v3 f32 b2, dropout 0.5 drawing "
              "inside the graphs, 2 steps against the card's eager step "
              "from the same generator state (%.1f s): fused_conv launches "
              "%s; mean losses %s; worst errors: %s" % (
                  time.time() - t0, launches2, losses2, worst_line(worst2)),
              flush=True)
    else:
        print("captured train inception_v3: captured Philox draws differ "
              "from eager ones, so the dropout-0.5 steps are held by the "
              "Dropout gates alone", flush=True)
    del gnet, enet, tr
    timing = {}
    batch = 64
    params = dict(SGD_PARAMS, multi_precision=True)
    x = mt.nd.array(rng.standard_normal((batch, side, side, 3)), ctx=gpu,
                    dtype="bfloat16")
    y = mt.nd.array(rng.integers(0, 1000, batch).astype(np.float32),
                    ctx=gpu)
    for mode in ("eager f/b", "captured"):
        net = on_card(build_zoo("inception_v3", side, arrays)[0])
        net.cast("bfloat16")
        if mode == "captured":
            net.hybridize()
        timing[mode] = train_timing(
            "inception_v3 bf16 b%d %s (SGD-momentum, multi_precision, "
            "clip_global_norm, dropout 0.5)" % (batch, mode), net, x, y,
            "sgd", params, None, card, flops, batch, "bfloat16",
            kernel=fused_conv, clip=CLIP_NORM)
        del net
    print("inception_v3 bf16 b%d on %s (items/s, median ms, p80 ms, host "
          "issue ms, device ms, idle share, peak GiB, peak GiB over the "
          "timed steps, train_mfu, builds after the warm-up, B1 launches a "
          "step):" % (batch, card))
    for mode, row in timing.items():
        print("  %-10s %9.1f %9.3f %9.3f %9.3f %9.3f %6.3f %6.2f %6.2f "
              "%.4f %s %s" % (mode, row["rate"], row["step_ms"],
                              row["p80_ms"], row["issue_ms"],
                              row["device_ms"],
                              1 - row["device_ms"] / row["step_ms"],
                              row["peak_gib"], row["steady_peak_gib"],
                              row["mfu"], row["builds_after_warmup"],
                              row["launches"]))
    cap = timing["captured"]
    if cap["launches"] != INCEPTION_B1 or any(
            cap["builds_after_warmup"].values()):
        raise AssertionError("captured inception_v3: %s launches a step "
                             "(expected %d), builds after the warm-up %s"
                             % (cap["launches"], INCEPTION_B1,
                                cap["builds_after_warmup"]))
    print("zoo train phase %.1f s" % (time.time() - t_phase), flush=True)
    return {"float32": launches[1], "bfloat16": cap["launches"]}


def s2d_phase(card):
    """ResNet-50 v1 served at b8 (one captured bucket) in float32 and
    bfloat16 with ``contrib.s2d_stem.apply_to_resnet(net, mode)`` for
    modes 1 and 2 beside the plain stem (mode 0): logits against the
    plain stem's within the served tolerances, B1's launches per forward
    (11, 11, 10), and each stem alone by graph replay at b8. Returns
    {dtype: {mode: launches per forward}}."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.contrib import s2d_stem
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.serving import BucketSpec, Predictor
    t_phase = time.time()
    net, _ = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    x_np = np.random.default_rng(51).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)
    want = {0: 11, 1: 11, 2: 10}
    out = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        dt = getattr(torch, dtype)
        if dtype == "bfloat16":
            net.cast("bfloat16")
        x8 = torch.from_numpy(x_np).to("cuda", dt)
        w = net.features[0].weight.data().to_torch().detach()
        logits, out[dtype] = {}, {}
        for mode in (0, 1, 2):
            s2d_stem.apply_to_resnet(net, mode)
            pred = Predictor(net, BucketSpec([8]),
                             example=torch.zeros(1, 224, 224, 3, dtype=dt),
                             warmup=True, device="cuda",
                             site="serving.predict.s2d%d.%s" % (mode, dtype))
            fused_conv.launches = 0
            logits[mode] = pred.predict(x8).to_torch().float()
            torch.cuda.synchronize()
            out[dtype][mode] = fused_conv.launches
            med, p80, _ = closed_loop(pred, x8)
            stem_ms = graph_ms(lambda: s2d_stem._stem(x8, w, None, mode))
            err = ((logits[mode] - logits[0]).abs().max()
                   / logits[0].abs().max()).item()
            print("s2d stem mode %d resnet50_v1 %s b8 on %s: fused_conv x%d "
                  "a forward; served median %.3f ms (p80 %.3f); the stem "
                  "alone %.4f ms by graph replay; logits vs the plain stem "
                  "%.3g of max|logit|" % (mode, dtype, card,
                                          out[dtype][mode], med, p80,
                                          stem_ms, err), flush=True)
            if out[dtype][mode] != want[mode] or err > tol or not bool(
                    torch.isfinite(logits[mode]).all()):
                raise AssertionError(
                    "s2d stem mode %d %s: %d launches (expected %d), logits "
                    "%.3g of max|logit| from the plain stem's (limit %g)"
                    % (mode, dtype, out[dtype][mode], want[mode], err, tol))
            del pred
    print("s2d phase %.1f s" % (time.time() - t_phase), flush=True)
    return out


# --------------------------------------------------------------- slice 10
# The input path (ROADMAP A5): a record file of raw 256x256x3 uint8 images
# (no JPEG, no cv2), read by the port's streaming reader or DataLoader and
# prefetched to the card, feeding ResNet-50 v1's captured bf16 b128 step.
INPUT_RECORDS = 1280
INPUT_SIDE = 256
INPUT_CROP = 224
INPUT_BATCH = 128
INPUT_SEED = 31
INPUT_MEAN = (123.68, 116.28, 103.53)    # CreateAugmenter's mean=True
INPUT_STD = (58.395, 57.12, 57.375)      # and std=True


def write_input_records(root, n=INPUT_RECORDS, seed=INPUT_SEED):
    """``n`` records ``pack(IRHeader(0, label, i, 0), pixels)`` of seeded
    uint8 256x256x3 pixels into ``root``/input.rec and .idx (as
    tools/perf_input_pipeline.py packs raw buffers). Returns (rec, idx,
    the payloads' bytes, the labels)."""
    import numpy as np
    from mxtpu_torch import recordio
    rec, idx = os.path.join(root, "input.rec"), os.path.join(root,
                                                            "input.idx")
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 1000, n)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    payloads = []
    for i in range(n):
        body = rng.integers(0, 256, (INPUT_SIDE, INPUT_SIDE, 3),
                            dtype=np.uint8).tobytes()
        packed = recordio.pack(recordio.IRHeader(0, float(labels[i]), i, 0),
                               body)
        w.write_idx(i, packed)
        payloads.append(packed)
    w.close()
    return rec, idx, payloads, labels


def input_decode(raw, side=None, crop=None):
    """The decode of every input run: unpack, a 224x224 crop and a mirror
    drawn from (INPUT_SEED, the record's id), so a record decodes the same
    on any thread and in any process. Returns (uint8 HWC, float32 label)."""
    import numpy as np
    from mxtpu_torch import recordio
    side, crop = side or INPUT_SIDE, crop or INPUT_CROP
    header, body = recordio.unpack(raw)
    img = np.frombuffer(body, np.uint8).reshape(side, side, 3)
    rng = np.random.default_rng((INPUT_SEED, int(header.id)))
    y0, x0 = rng.integers(0, side - crop + 1, 2)
    img = img[y0:y0 + crop, x0:x0 + crop]
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img), np.float32(header.label)


class InputRecordDataset:
    """The records as a Gluon dataset for the DataLoader's spawned workers:
    the file opens in the process that reads it. In a worker process a
    read raises if that process has initialized CUDA (a worker must never
    hold a CUDA context)."""

    def __init__(self, rec, idx):
        self.rec, self.idx = rec, idx
        self.parent = os.getpid()
        self.shape = (INPUT_RECORDS, INPUT_SIDE, INPUT_CROP)
        self._r = None

    def __getstate__(self):
        return dict(self.__dict__, _r=None)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, i):
        if os.getpid() != self.parent:
            torch = sys.modules.get("torch")
            if torch is not None and torch.cuda.is_initialized():
                raise RuntimeError("DataLoader worker %d holds a CUDA "
                                   "context" % os.getpid())
        if self._r is None:
            from mxtpu_torch import recordio
            self._r = recordio.MXIndexedRecordIO(self.idx, self.rec, "r")
        return input_decode(self._r.pread_idx(i), *self.shape[1:])


def _endless(make):
    """Batches of ``make()`` (one epoch each), epoch after epoch."""
    while True:
        n = 0
        for b in make():
            n += 1
            yield b
        if not n:
            raise AssertionError("an input epoch yielded no batch")


def _normalized(x_u8, dtype):
    """uint8 NHWC on the card -> normalized ``dtype`` NHWC (the input's
    float work, on the card after the copy)."""
    import torch
    from mxtpu_torch.ndarray import NDArray
    t = x_u8.to_torch() if hasattr(x_u8, "to_torch") else x_u8
    mean = torch.tensor(INPUT_MEAN, device=t.device)
    inv_std = 1.0 / torch.tensor(INPUT_STD, device=t.device)
    return NDArray(((t.float() - mean) * inv_std).to(dtype))


def _compute_apps():
    """Pids that hold a context on the card, by nvidia-smi (empty where
    the tool shows no processes)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {int(s) for s in out.stdout.split() if s.strip().isdigit()}


def _host_equal(what, got, ref):
    """Bit-equality of two batch streams of (data, label) pairs."""
    import numpy as np
    if len(got) != len(ref):
        raise AssertionError("%s: %d batches, expected %d" % (
            what, len(got), len(ref)))
    for i, (g, r) in enumerate(zip(got, ref)):
        for a, b in zip(g, r):
            a = a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
            b = b.asnumpy() if hasattr(b, "asnumpy") else np.asarray(b)
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not np.array_equal(a, b):
                raise AssertionError("%s: batch %d differs from the host's "
                                     "(%s %s against %s %s)" % (
                                         what, i, a.dtype, a.shape, b.dtype,
                                         b.shape))


def input_gates(card, rec, idx, payloads):
    """The input path's gates: the file reads back; the streaming reader
    prefetched to the card equals its host batches inline and on two
    threads, after a worker death and after a prefetch death, and with a
    consumer that delays its stream; the DataLoader's four spawned
    workers equal its in-process batches and hold no CUDA context; ToTensor
    -> Normalize on the card equals the CPU."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import recordio, resilience
    from mxtpu_torch.io import DevicePrefetcher, StreamRecordIter
    gpu = mt.gpu(0)
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    bad = [k for k in r.keys if r.read_idx(k) != payloads[k]]
    r.close()
    if bad or len(r.keys) != len(payloads):
        raise AssertionError("records read back differ: %s" % bad[:5])
    print("input: %d records (%d bytes) read back through MXIndexedRecordIO "
          "equal to what was written" % (len(payloads), os.path.getsize(rec)),
          flush=True)

    def stream(threads, prefetch, seed=5):
        return StreamRecordIter(rec, idx, batch_size=INPUT_BATCH,
                                decode_fn=input_decode, seed=seed,
                                num_threads=threads,
                                prefetch_to_device=prefetch, sharding=gpu)

    def epoch(it):
        out = [(b.data[0], b.label[0]) for b in it]
        it.close()
        return out

    host = epoch(stream(0, False))
    for threads in (0, 2):
        got = epoch(stream(threads, True))
        if got[0][0].context != gpu:
            raise AssertionError("prefetched batch on %s" % got[0][0].context)
        _host_equal("StreamRecordIter threads %d -> DevicePrefetcher on "
                    "cuda:0" % threads, got, host)
    for fault in ("worker_death@3", "prefetch_death@2"):
        resilience.set_faults(fault)
        got = epoch(stream(2, True))
        fired = list(resilience.FAULT_STATS["fired"])
        resilience.reset_faults()
        if not fired:
            raise AssertionError("fault %s did not fire" % fault)
        _host_equal("StreamRecordIter after %s" % fault, got, host)
    # a consumer whose stream is busy when each batch arrives, with the
    # smallest ring (depth 1, two pinned slots)
    pf = DevicePrefetcher(iter([(d, lab) for d, lab in host]), depth=1,
                          sharding=gpu)
    sums = []
    for d, _ in pf:
        torch.cuda._sleep(2_000_000)
        sums.append(d.to_torch().sum(dtype=torch.int64))
    pf.close()
    want = [int(d.sum(dtype=np.int64)) for d, _ in host]
    if [int(s) for s in sums] != want:
        raise AssertionError("depth-1 prefetch under a busy consumer: "
                             "sums differ")
    print("input gates: StreamRecordIter -> DevicePrefetcher (cuda:0) "
          "batches bit-equal to the host batches, inline and on 2 threads, "
          "after worker_death@3 and prefetch_death@2, and at depth 1 under "
          "a busy consumer stream (%d batches of %d each)"
          % (len(host), INPUT_BATCH), flush=True)
    ds = InputRecordDataset(rec, idx)
    ref = [(d, lab) for d, lab in
           mt.gluon.data.DataLoader(ds, batch_size=INPUT_BATCH,
                                    batchify_fn=_np_batchify)]
    loader = mt.gluon.data.DataLoader(
        ds, batch_size=INPUT_BATCH, num_workers=4, pin_memory=True,
        prefetch_to_device=gpu)
    t0 = time.time()
    got = [(d, lab) for d, lab in loader]
    workers = [w.pid for w in loader._pool[2]]
    apps = _compute_apps()
    loader.close()
    _host_equal("DataLoader(num_workers=4, pin_memory=True, "
                "prefetch_to_device=cuda:0)", got, ref)
    if apps & set(workers):
        raise AssertionError("DataLoader workers %s hold a context on the "
                             "card (nvidia-smi: %s)" % (workers, apps))
    print("input gates: DataLoader(num_workers=4, pin_memory=True, "
          "prefetch_to_device=cuda:0) equals num_workers=0 batch for batch "
          "(%.1f s with the spawn); no worker initialized CUDA (each read "
          "checks torch.cuda.is_initialized() in the worker), worker pids "
          "%s, nvidia-smi compute apps %s" % (time.time() - t0, workers,
                                              sorted(apps)), flush=True)
    T = mt.gluon.data.vision.transforms
    chain = T.Compose([T.ToTensor(),
                       T.Normalize([m / 255 for m in INPUT_MEAN],
                                   [s / 255 for s in INPUT_STD])])
    x = host[0][0]
    on_card = chain(mt.nd.array(x, ctx=gpu)).asnumpy()
    on_cpu = chain(mt.nd.array(x, ctx=mt.cpu())).asnumpy()
    err = float(np.abs(on_card - on_cpu).max()) / max(
        1.0, float(np.abs(on_cpu).max()))
    if on_card.shape != (INPUT_BATCH, 3, INPUT_CROP, INPUT_CROP) or \
            not np.isfinite(on_card).all() or err > 1e-6:
        raise AssertionError("ToTensor -> Normalize on the card differs from "
                             "the CPU by %.3g (limit 1e-6)" % err)
    print("input gates: transforms ToTensor -> Normalize on a b%d batch, "
          "card against CPU (f32): max error %.3g of max(1, max|ref|) "
          "(limit 1e-6)" % (INPUT_BATCH, err), flush=True)
    return host


def _np_batchify(samples):
    import numpy as np
    return [np.stack([s[0] for s in samples]),
            np.asarray([s[1] for s in samples], np.float32)]


def input_lockstep(rec, idx):
    """ResNet-50 v1 f32 b8, 3 SGD-momentum steps from records (prefetched
    to the card and normalized there) against the same steps on the CPU
    (``lockstep_train``; 11 fused_conv launches a step)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.io import StreamRecordIter
    from mxtpu_torch.ops.pallas.conv import fused_conv
    it = StreamRecordIter(rec, idx, batch_size=8, decode_fn=input_decode,
                          seed=7, sharding=mt.gpu(0))
    batches = []
    for _ in range(3):
        b = it.next()
        batches.append((_normalized(b.data[0], torch.float32).asnumpy(),
                        b.label[0].asnumpy()))
    it.close()
    net, arrays = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    cpu_net, _ = build_net(arrays)
    t0 = time.time()
    launches, losses, worst, _ = lockstep_train(
        "resnet50 from records f32", net, cpu_net, batches, "sgd",
        SGD_PARAMS, kernel=fused_conv)
    if launches != [11, 11, 11]:
        raise AssertionError("resnet50 from records: fused_conv launched %s "
                             "times per step, expected 11" % launches)
    print("input lockstep: resnet50_v1 f32 b8, 3 SGD steps from records "
          "(StreamRecordIter -> cuda:0, normalized on the card) against the "
          "CPU (%.1f s): fused_conv launches %s; mean losses %s; worst "
          "errors: %s" % (time.time() - t0, launches, losses,
                          worst_line(worst)), flush=True)
    return arrays


def input_timed(card, rec, idx, arrays, host):
    """ResNet-50 v1's captured bf16 b128 step fed four ways, each the
    median of 10 steps after 3 (batch pulled, normalized to bf16 on the
    card, stepped, synchronized): (a) resident, one batch already on the
    card; (b) sync, the inline reader's host batch uploaded by the step;
    (c) overlap, StreamRecordIter -> DevicePrefetcher (depth 2, 2
    threads); (d) loader, DataLoader(num_workers=4, pin_memory=True,
    prefetch_to_device=cuda:0). Also loader_only: the reader drained with
    no device work."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import telemetry
    from mxtpu_torch.io import ShardedRecordReader, StreamRecordIter
    from mxtpu_torch.ops.pallas.conv import fused_conv
    gpu = mt.gpu(0)
    nd = mt.nd
    # loader_only: two epochs drained on the host
    rd = ShardedRecordReader(rec, idx, batch_size=INPUT_BATCH,
                             decode_fn=input_decode, seed=3, num_threads=2)
    t0 = time.perf_counter()
    n = sum(b[0].shape[0] for _ in range(2) for b in rd)
    loader_only = n / (time.perf_counter() - t0)
    rd.close()
    print("input loader_only on %s: %.1f images/s (ShardedRecordReader, 2 "
          "threads, %d images, no device work)" % (card, loader_only, n),
          flush=True)
    net = build_net(arrays)[0]
    net.collect_params().reset_ctx(gpu)
    net.cast("bfloat16")
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(SGD_PARAMS, multi_precision=True))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()

    def train(x_u8, y):
        x = _normalized(x_u8, torch.bfloat16)
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(INPUT_BATCH)

    resident = (nd.array(host[0][0], ctx=gpu), nd.array(host[0][1], ctx=gpu))
    sync_src = _endless(lambda: ShardedRecordReader(
        rec, idx, batch_size=INPUT_BATCH, decode_fn=input_decode, seed=3,
        num_threads=0))
    waits = {}

    def sync_pull():
        t0 = time.perf_counter()
        d, lab = next(sync_src)
        t1 = time.perf_counter()
        x = nd.array(d, ctx=gpu)
        y = nd.array(lab, ctx=gpu)
        torch.cuda.synchronize()
        waits.setdefault("wait", []).append(t1 - t0)
        waits.setdefault("h2d", []).append(time.perf_counter() - t1)
        return x, y

    stream = StreamRecordIter(rec, idx, batch_size=INPUT_BATCH,
                              decode_fn=input_decode, seed=3, num_threads=2,
                              depth=2, sharding=gpu)

    def stream_epochs():
        stream.reset()
        return stream

    overlap_src = _endless(stream_epochs)
    loader = mt.gluon.data.DataLoader(
        InputRecordDataset(rec, idx), batch_size=INPUT_BATCH, shuffle=True,
        num_workers=4, pin_memory=True, prefetch_to_device=gpu)
    loader_src = _endless(lambda: loader)
    runs = [("(a) resident", lambda: resident),
            ("(b) sync", sync_pull),
            ("(c) overlap", lambda: _batch_pair(next(overlap_src))),
            ("(d) loader", lambda: tuple(next(loader_src)))]
    results = {}
    for name, pull in runs:
        def step():
            train(*pull())
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        builds = _builds()
        launches0 = fused_conv.launches
        waits.clear()
        for m in ("data.wait", "data.h2d", "data.starved"):
            telemetry.reset_metric(m)
        torch.cuda.reset_peak_memory_stats()
        wall = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        per_step = (fused_conv.launches - launches0) / 10
        built = {k: _builds()[k] - builds[k] for k in builds}
        snap = telemetry.snapshot()
        hists = snap["histograms"]
        if name == "(b) sync":
            wait_ms = 1e3 * float(np.mean(waits["wait"]))
            h2d_ms = 1e3 * float(np.mean(waits["h2d"]))
            starved = None
        elif name == "(a) resident":
            wait_ms = h2d_ms = starved = None
        else:
            wait_ms = 1e3 * hists["data.wait"]["mean"]
            h2d_ms = 1e3 * hists["data.h2d"]["mean"] \
                if "data.h2d" in hists else None
            starved = telemetry.value("data.starved")
        peak_dev = torch.cuda.max_memory_allocated()
        wall.sort()
        med = wall[5]
        # the uploads run on the prefetcher's side stream beside the step;
        # everything else (kernels, device copies, memsets) is the step's
        rows = device_rows(step, 2)
        copy_ms = sum(ms for k, ms, _ in rows if k.startswith("Memcpy HtoD"))
        busy_ms = sum(ms for k, ms, _ in rows) - copy_ms
        pinned = None
        if name == "(c) overlap":
            pinned = stream._prefetcher.pinned_bytes
        elif name == "(d) loader":
            pinned = loader._prefetcher.pinned_bytes
        results[name] = dict(
            rate=INPUT_BATCH * 1e3 / med, step_ms=med, p80_ms=wall[8],
            wait_ms=wait_ms, h2d_ms=h2d_ms, starved=starved,
            idle=1 - busy_ms / med, busy_ms=busy_ms, h2d_copy_ms=copy_ms,
            pinned_bytes=pinned, peak_device_bytes=peak_dev,
            builds_after_warmup=built, b1_per_step=per_step)
        print("input %s on %s: %.1f images/s, median step %.3f ms (p80 "
              "%.3f), data.wait %s ms a step, data.h2d %s ms, data.starved "
              "%s, idle share %.3f (device busy %.3f ms besides the uploads' "
              "%.3f ms a step, torch.profiler), peak pinned %s bytes, peak "
              "device %d bytes, "
              "builds after the warm-up %s, B1 launches a step %g" % (
                  name, card, results[name]["rate"], med, wall[8],
                  _fmt(wait_ms), _fmt(h2d_ms), starved, 1 - busy_ms / med,
                  busy_ms, copy_ms, pinned, peak_dev, built, per_step),
              flush=True)
        if any(built.values()) or per_step != 11:
            raise AssertionError("input %s: builds after the warm-up %s, B1 "
                                 "launches a step %g (expected 0 and 11)"
                                 % (name, built, per_step))
    overlap_src.close()
    loader_src.close()
    stream.close()
    loader.close()
    results["loader_only"] = loader_only
    return results


def _batch_pair(b):
    return b.data[0], b.label[0]


def _fmt(v):
    return "n/a" if v is None else "%.3f" % v


def input_phase(card):
    """The input path of slice 10 (ROADMAP A5) on the card: records
    written, the gates (``input_gates``), the record-fed lockstep
    (``input_lockstep``) and the timed runs (``input_timed``). Returns the
    timed results."""
    import shutil
    import tempfile
    import gc
    import torch
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="input_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.time()
        rec, idx, payloads, _ = write_input_records(root)
        print("input: wrote %d raw records of %dx%dx3 uint8 (%d bytes) in "
              "%.1f s" % (len(payloads), INPUT_SIDE, INPUT_SIDE,
                          os.path.getsize(rec), time.time() - t0),
              flush=True)
        host = input_gates(card, rec, idx, payloads)
        del payloads
        arrays = input_lockstep(rec, idx)
        gc.collect()
        torch.cuda.empty_cache()
        results = input_timed(card, rec, idx, arrays, host)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("input phase %.1f s" % (time.time() - t_phase), flush=True)
    return results


# --------------------------------------------------------------- slice 11
# The symbolic API (ROADMAP A7) on the card: ResNet-50 v1 exported from
# Gluon, served from the files, trained through Module; a partitioned
# attention symbol on B2 at BERT-base's attention shapes
SYMBOLIC_SEED = 41
SYMBOLIC_TRAIN_BATCH = 64
ATTN_SHAPE = (96, 512, 64)    # b8 x 12 heads folded into the batch, T, D
ATTN_F32_TOL = 2e-3           # the reference's own (tests/test_subgraph.py)
SERVE_BF16_TOL = 5e-2         # of max|ref|, the serving phases' bf16 rule
CAPTURED_TIMING = {}          # captured_train_phase's timed rows, by cell


def _rel(got, ref):
    """max|got - ref| / max|ref|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def symbolic_export(card, root):
    """ResNet-50 v1 with seeded weights, hybridized on the card, one b8
    forward, ``export``; gates: ``SymbolBlock.imports`` of the files gives
    the Gluon logits within 1e-3 of max|logit|, and ``infer_shape`` at b8
    gives the Gluon parameters' shapes on meta tensors with no launch.
    Returns (prefix, arrays, the b8 input, the Gluon logits)."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    net, arrays = build_net()
    net.collect_params().reset_ctx(mt.gpu(0))
    net.hybridize()
    rng = np.random.default_rng(SYMBOLIC_SEED)
    x8 = torch.from_numpy(rng.standard_normal((8, 224, 224, 3)).astype(
        np.float32)).cuda()
    with torch.no_grad():
        ref = net(x8).clone()
    prefix = os.path.join(root, "resnet50_v1")
    t0 = time.time()
    net.export(prefix)
    export_s = time.time() - t0
    sb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                      prefix + "-0000.params", ctx=mt.gpu(0))
    start = fused_conv.launches
    with torch.no_grad():
        got = sb(x8)
    sb_launches = fused_conv.launches - start
    err = _rel(got, ref)
    if tuple(got.shape) != (8, 1000) or err > 1e-3 or sb_launches != 11:
        raise AssertionError("export: SymbolBlock logits %s differ from "
                             "Gluon's by %.3g of max|logit| (limit 1e-3), "
                             "fused_conv launches %d (expected 11)"
                             % (tuple(got.shape), err, sb_launches))
    sym = mt.sym.load(prefix + "-symbol.json")
    start = fused_conv.launches
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(data=(8, 224, 224,
                                                               3))
    inferred = dict(zip(sym.list_arguments(), arg_shapes))
    inferred.update(zip(sym.list_auxiliary_states(), aux_shapes))
    wrong = [k for k, p in net.collect_params().items()
             if tuple(p.shape) != inferred.get(k)]
    if wrong or out_shapes != [(8, 1000)] or fused_conv.launches != start:
        raise AssertionError("infer_shape: %d parameter shapes differ from "
                             "Gluon's (%s), outputs %s, %d launches" % (
                                 len(wrong), wrong[:3], out_shapes,
                                 fused_conv.launches - start))
    nodes = json.load(open(prefix + "-symbol.json"))["nodes"]
    print("symbolic export: resnet50_v1 traced and written in %.2f s (%d "
          "nodes, %d parameters, %d bytes of params); SymbolBlock.imports "
          "on the card vs the Gluon net at b8 f32: %.3g of max|logit| "
          "(limit 1e-3), fused_conv launches %d; infer_shape at b8 on meta "
          "tensors: %d argument and %d aux shapes equal to Gluon's, "
          "output %s, 0 launches" % (
              export_s, len(nodes), len(net.collect_params()),
              os.path.getsize(prefix + "-0000.params"), err, sb_launches,
              len(arg_shapes), len(aux_shapes), out_shapes[0]), flush=True)
    del net, sb
    return prefix, arrays, x8, ref


def _predictor_row(label, pred, x, card, per_forward):
    """Closed-loop median/p80/host issue of ``pred.predict(x)`` and a
    profiled call's device ms and idle share."""
    med, p80, issue = closed_loop(pred, x)
    rows = device_rows(lambda: pred.predict(x), 3)
    dev = sum(r[1] for r in rows)
    conv = sum(r[1] for r in rows if "fused_conv" in r[0])
    n_conv = sum(r[2] for r in rows if "fused_conv" in r[0])
    print("  %-34s median %.3f ms, p80 %.3f, host issue %.3f, device %.3f "
          "ms (idle share %.3f), fused_conv %.3f ms x%g (expected %d) on %s"
          % (label, med, p80, issue, dev, 1 - dev / med, conv,
             round(n_conv), per_forward, card), flush=True)
    return dict(median_ms=med, p80_ms=p80, issue_ms=issue, device_ms=dev,
                idle=1 - dev / med)


def symbolic_serve(card, prefix, arrays, x8):
    """``Predictor.from_checkpoint`` on the files, buckets b1 and b8 in
    bf16, captured: logits within 5e-2 of max|logit| of the same on the
    CPU, 11 fused_conv launches a forward; timed beside the Gluon
    Predictor of the same weights, bf16, in the same run. Returns the
    timed rows."""
    import torch
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.serving import BucketSpec, Predictor
    spec = BucketSpec([1, 8])
    bf = torch.bfloat16
    example = torch.zeros(1, 224, 224, 3, dtype=bf)
    pred = Predictor.from_checkpoint(prefix, 0, spec, dtype="bfloat16",
                                     example=example, warmup=True,
                                     device="cuda",
                                     site="serving.predict.symbolic")
    check_graphs(pred, spec, "from_checkpoint bf16")
    cpu_pred = Predictor.from_checkpoint(prefix, 0, spec, dtype="bfloat16",
                                         device="cpu", site="cpu.symbolic")
    x = x8.to(bf)
    start = fused_conv.launches
    got = [pred.predict(x).to_torch() for _ in range(3)]
    torch.cuda.synchronize()
    launches = fused_conv.launches - start
    ref = cpu_pred.predict(x.cpu()).to_torch()
    err = _rel(got[-1], ref)
    if launches != 33 or err > SERVE_BF16_TOL or \
            not bool(torch.isfinite(got[-1].float()).all()):
        raise AssertionError("from_checkpoint bf16: %d fused_conv launches "
                             "over 3 b8 forwards (expected 33), logits "
                             "%.3g of max|logit| from the CPU's (limit %g)"
                             % (launches, err, SERVE_BF16_TOL))
    print("symbolic serve: Predictor.from_checkpoint bf16 (buckets b1, b8, "
          "%d graphs) vs the same on the CPU at b8: %.3g of max|logit| "
          "(limit %g); fused_conv launches %d over 3 forwards" % (
              len(pred._buckets), err, SERVE_BF16_TOL, launches), flush=True)
    net, _ = build_net(arrays)
    net.cast("bfloat16")
    gluon = Predictor(net, spec, example=example, warmup=True,
                      device="cuda", site="serving.predict.symbolic_gluon")
    print("symbolic serve timed, b8 bf16, 50 requests after 3 (closed loop):")
    rows = {"from_checkpoint": _predictor_row(
        "Predictor.from_checkpoint", pred, x, card, 11),
        "gluon": _predictor_row("Gluon Predictor (same weights)", gluon, x,
                                card, 11)}
    check_graphs(pred, spec, "from_checkpoint bf16 after traffic")
    pred.release()
    gluon.release()
    return rows


def _module(sym, arg_params, aux_params, batch, ctx):
    import mxtpu_torch as mt
    mod = mt.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 224, 224, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(SGD_PARAMS))
    return mod


def _batch(x, y, ctx):
    import mxtpu_torch as mt
    return mt.io.DataBatch([mt.nd.array(x, ctx=ctx)],
                           [mt.nd.array(y, ctx=ctx)])


def _sync_module(dst, src):
    """``dst`` (the CPU Module) takes ``src``'s weights, statistics,
    momenta and update counts."""
    arg, aux = src.get_params()
    dst.set_params(arg, aux)
    dst._updater.states = {i: _host_copy(s)
                           for i, s in src._updater.states.items()}
    dst._updater.states_synced = dict.fromkeys(dst._updater.states, True)
    dst._optimizer._index_update_count = dict(
        src._optimizer._index_update_count)
    dst._optimizer.num_update = src._optimizer.num_update


def _l2(got, ref):
    """Relative L2 error of ``got`` against ``ref``."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / max(float(ref.norm()), 1e-30))


def symbolic_lockstep(train_sym, arg_params, aux_params, steps=3):
    """3 f32 b8 ``forward_backward`` + ``update`` steps of the Module on
    the card, each against the same step of a CPU Module from the card's
    state, held as ``lockstep_train`` holds Gluon: outputs (softmax
    probabilities) within 1e-4, BatchNorm statistics within 1e-4 of
    max(1, max|ref|), gradients, weight changes and momenta within
    TRAIN_L2 relative L2. Returns (launches per step, worst errors, the
    card Module)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    card = _module(train_sym, arg_params, aux_params, 8, mt.gpu(0))
    cpu = _module(train_sym, arg_params, aux_params, 8, mt.cpu())
    worst, launches = {}, []

    def note(key, v, tol):
        worst[key] = max(worst.get(key, 0.0), v)
        if not v <= tol:
            raise AssertionError("Module lockstep: %s %.3g (limit %g)"
                                 % (key, v, tol))
    for i, (x, y) in enumerate(resnet_batches(8, steps, SYMBOLIC_SEED + 1)):
        if i:
            _sync_module(cpu, card)
        before = {k: v.to_torch().clone() for k, v in
                  card.get_params()[0].items()}
        start = fused_conv.launches
        card.forward_backward(_batch(x, y, mt.gpu(0)))
        card.update()
        torch.cuda.synchronize()
        launches.append(fused_conv.launches - start)
        cpu.forward_backward(_batch(x, y, mt.cpu()))
        cpu.update()
        out_c = card.get_outputs()[0].to_torch()
        out_r = cpu.get_outputs()[0].to_torch()
        note("outputs", (out_c.float().cpu() - out_r).abs().max().item(),
             1e-4)
        ge, gr = card._exec.grad_dict, cpu._exec.grad_dict
        note("gradients", max(_l2(ge[k].to_torch(), gr[k].to_torch())
                              for k in gr), TRAIN_L2)
        arg_c, aux_c = card.get_params()
        arg_r, aux_r = cpu.get_params()
        note("weight changes", max(
            _l2(arg_c[k].to_torch().cpu() - before[k].cpu(),
                arg_r[k].to_torch() - before[k].cpu()) for k in arg_r),
             TRAIN_L2)
        note("BatchNorm statistics", max(
            (aux_c[k].to_torch().cpu() - aux_r[k].to_torch()).abs().max()
            .item() / max(1.0, aux_r[k].to_torch().abs().max().item())
            for k in aux_r), 1e-4)
        note("momenta", max(
            _l2(card._updater.states[j].to_torch(),
                cpu._updater.states[j].to_torch())
            for j in cpu._updater.states), TRAIN_L2)
    # the first step captures: the forward graph's warm-up run, the pair's
    # own replay and the step's replay launch 11 each
    if launches != [33] + [11] * (steps - 1):
        raise AssertionError("Module lockstep: fused_conv launches %s, "
                             "expected [33, 11, 11] (the first step "
                             "captures)" % launches)
    return launches, worst, card


def _executor_builds():
    from mxtpu_torch import telemetry
    return {site: (telemetry.retrace_stats(site) or {}).get("compiles", 0)
            for site in ("executor", "fused_optimizer")}


def module_timing(card, train_sym, arg_params, aux_params, batch):
    """The Module's f32 b``batch`` training step on the card (captured:
    the executor's pair and the update graph): 10 steps after 3, as
    ``train_timing`` times Gluon's, with the builds after the warm-up and
    fused_conv's launches in one more step."""
    import gc
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.conv import fused_conv
    gc.collect()
    torch.cuda.empty_cache()
    mod = _module(train_sym, arg_params, aux_params, batch, mt.gpu(0))
    rng = np.random.default_rng(SYMBOLIC_SEED + 2)
    batch_ = _batch(rng.standard_normal((batch, 224, 224, 3)).astype(
        np.float32), rng.integers(0, 1000, batch).astype(np.float32),
        mt.gpu(0))

    def step():
        mod.forward_backward(batch_)
        mod.update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = {}

    def on_warm():
        warm.update(_executor_builds(),
                    peak=torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    med, p80, issue = timed_steps(step, on_warm=on_warm)
    steady_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_gb = max(warm.pop("peak") / 2 ** 30, steady_gb)
    built = {k: v - warm[k] for k, v in _executor_builds().items()}
    start = fused_conv.launches
    step()
    torch.cuda.synchronize()
    launches = fused_conv.launches - start
    rate = batch * 1e3 / med
    print("train resnet50_v1 float32 b%d through Module (SGD-momentum, "
          "captured) on %s: %.1f images/s at the median step %.3f ms (p80 "
          "%.3f, median host issue %.3f ms; 10 steps after 3), peak memory "
          "%.2f GiB (%.2f GiB over the timed steps); builds in the timed "
          "steps %s; launches in one step %d" % (
              batch, card, rate, med, p80, issue, peak_gb, steady_gb, built,
              launches), flush=True)
    dev_ms = print_step_breakdown(
        "train Module resnet50_v1 float32 b%d" % batch, device_rows(step, 2),
        med, RESNET50_TRAIN_FLOPS * rate, "float32", card)
    if launches != 11 or any(built.values()):
        raise AssertionError("Module step: %d fused_conv launches (expected "
                             "11), builds after the warm-up %s"
                             % (launches, built))
    return mod, dict(step_ms=med, p80_ms=p80, issue_ms=issue,
                     device_ms=dev_ms, rate=rate, peak_gib=peak_gb,
                     steady_peak_gib=steady_gb,
                     mfu=RESNET50_TRAIN_FLOPS * rate / PEAK_FLOPS["float32"],
                     builds_after_warmup=built, launches=launches)


def symbolic_train(card, prefix):
    """``SoftmaxOutput(load(prefix-symbol.json))`` trained through
    ``Module`` from the checkpoint: the lockstep, the timed b64 step beside
    the captured Gluon step of this run, ``fit`` for one epoch of 4
    batches with ``Speedometer``, and ``save_checkpoint`` ->
    ``Module.load`` giving bit-equal predict outputs."""
    import logging
    import numpy as np
    import torch
    import mxtpu_torch as mt
    sym = mt.sym.SoftmaxOutput(mt.sym.load(prefix + "-symbol.json"),
                               name="softmax")
    _, arg_params, aux_params = mt.model.load_checkpoint(prefix, 0)
    t0 = time.time()
    launches, worst, card_mod = symbolic_lockstep(sym, arg_params,
                                                  aux_params)
    print("train resnet50_v1 f32 b8 through Module, %d SGD steps on the "
          "card, each against the same step of a CPU Module from the "
          "card's state (%.1f s): fused_conv launches %s (the first step "
          "captures); worst errors "
          "(elementwise of the scale, or relative L2): %s" % (
              len(launches), time.time() - t0, launches, worst_line(worst)),
          flush=True)
    # the checkpoint round trip: bit-equal predict outputs
    ck = prefix + "_module"
    card_mod.save_checkpoint(ck, 3)
    loaded = mt.mod.Module.load(ck, 3, context=mt.gpu(0))
    loaded.bind(data_shapes=[("data", (8, 224, 224, 3))],
                label_shapes=[("softmax_label", (8,))], for_training=False)
    loaded.init_params()
    (x, y), = resnet_batches(8, 1, SYMBOLIC_SEED + 3)
    outs = []
    for mod in (card_mod, loaded):
        mod.forward(_batch(x, y, mt.gpu(0)), is_train=False)
        outs.append(mod.get_outputs()[0].to_torch().clone())
    diff = (outs[0] - outs[1]).abs().max().item()
    if diff != 0:
        raise AssertionError("save_checkpoint -> Module.load: predict "
                             "outputs differ by %.3g" % diff)
    print("Module save_checkpoint -> Module.load: predict outputs at b8 "
          "bit-equal (max diff %g)" % diff, flush=True)
    del card_mod, loaded
    mod, timing = module_timing(card, sym, arg_params, aux_params,
                                SYMBOLIC_TRAIN_BATCH)
    gluon = CAPTURED_TIMING.get("resnet50 float32")
    print("Module step beside the captured Gluon step of this run on %s "
          "(images/s, median ms, p80 ms, host issue ms, device ms, idle "
          "share, peak GiB, peak GiB over the timed steps, train_mfu):"
          % card)
    for name, row in (("Module", timing), ("Gluon captured", gluon)):
        if row is None:
            print("  %-16s not run in this call" % name)
            continue
        print("  %-16s %10.1f %9.3f %9.3f %9.3f %9.3f %6.3f %6.2f %6.2f "
              "%.4f" % (name, row["rate"], row["step_ms"], row["p80_ms"],
                        row["issue_ms"], row["device_ms"],
                        1 - row["device_ms"] / row["step_ms"],
                        row["peak_gib"], row["steady_peak_gib"],
                        row["mfu"]))
    # fit: one epoch of 4 batches over NDArrayIter, Speedometer every 2
    rng = np.random.default_rng(SYMBOLIC_SEED + 4)
    n = 4 * SYMBOLIC_TRAIN_BATCH
    it = mt.io.NDArrayIter(
        rng.standard_normal((n, 224, 224, 3)).astype(np.float32),
        rng.integers(0, 1000, n).astype(np.float32),
        SYMBOLIC_TRAIN_BATCH, label_name="softmax_label")
    log = logging.getLogger()
    level = log.level
    log.setLevel(logging.INFO)
    seen = []
    t0 = time.time()
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(SGD_PARAMS),
                batch_end_callback=[mt.callback.Speedometer(
                    SYMBOLIC_TRAIN_BATCH, 2), lambda p: seen.append(
                        p.nbatch)])
    finally:
        log.setLevel(level)
    torch.cuda.synchronize()
    if seen != [0, 1, 2, 3]:
        raise AssertionError("Module.fit: batches %s, expected 4" % seen)
    print("Module.fit: 1 epoch of %d batches of %d over NDArrayIter in %.2f "
          "s (Speedometer every 2 batches; train accuracy %s)" % (
              len(seen), SYMBOLIC_TRAIN_BATCH, time.time() - t0,
              mod.score(it, "acc")), flush=True)
    del mod
    return {"lockstep_launches": launches, "module": timing,
            "gluon": gluon}


def _attention_symbol():
    import mxtpu_torch as mt
    s = mt.sym
    q, k, v = s.var("q"), s.var("k"), s.var("v")
    scores = s.batch_dot(q, k, transpose_b=True) * (1.0 / 8)
    return s.batch_dot(s.softmax(scores, axis=-1), v)


def _attn_close(got, ref, dtype, what):
    """f32: |got - ref| <= 2e-3 + 2e-3 |ref|; bf16: within 5e-2 of
    max|ref|."""
    import torch
    got, ref = got.float().cpu(), ref.float().cpu()
    err = (got - ref).abs()
    ok = bool((err <= ATTN_F32_TOL + ATTN_F32_TOL * ref.abs()).all()) \
        if dtype == "float32" else \
        bool(err.max() <= SERVE_BF16_TOL * ref.abs().max())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: partitioned vs unpartitioned max abs err "
                             "%.3g (max|ref| %.3g)" % (
                                 what, err.max().item(),
                                 ref.abs().max().item()))
    return err.max().item()


def symbolic_attention(card):
    """``partition(·, "flash_attention")`` of batch_dot -> * 1/8 ->
    softmax -> batch_dot at q/k/v [96, 512, 64], f32 and bf16: one
    ``_sg_flash_attention`` node, one B2 launch a forward; outputs held to
    the unpartitioned symbol on the card, and a training forward +
    backward through the Executor with q/k/v gradients held to the
    unpartitioned graph's; timed by graph replay beside the unpartitioned
    symbol and ``F.scaled_dot_product_attention``. Returns rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import mxtpu_torch as mt
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.symbol.symbol import _topo
    sym = _attention_symbol()
    part = mt.sym.partition(sym, "flash_attention")
    ops = [n.op for n in _topo(part._heads) if not n.is_var()]
    if ops != ["_sg_flash_attention"]:
        raise AssertionError("flash partition gave %s" % ops)
    b, t, d = ATTN_SHAPE
    rng = np.random.default_rng(SYMBOLIC_SEED + 5)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        feed = {n: torch.from_numpy(rng.standard_normal(ATTN_SHAPE).astype(
            np.float32)).to("cuda", dt) for n in "qkv"}
        g = torch.from_numpy(rng.standard_normal(ATTN_SHAPE).astype(
            np.float32)).to("cuda", dt)
        exes = {}
        for name, s in (("partitioned", part), ("unpartitioned", sym)):
            exes[name] = s.bind(mt.gpu(0), args={
                n: mt.nd.NDArray(v.clone()) for n, v in feed.items()})
        exes["partitioned"].forward()   # captures (its warm-up launches)
        start = flash_attention.launches
        for _ in range(3):
            out_p = exes["partitioned"].forward()[0].to_torch()
        torch.cuda.synchronize()
        fwd_launches = flash_attention.launches - start
        out_u = exes["unpartitioned"].forward()[0].to_torch()
        err = _attn_close(out_p, out_u, dtype, "attention %s out" % dtype)
        grads = {}
        for name, exe in exes.items():
            exe.forward(is_train=True)
            exe.backward(mt.nd.NDArray(g))
            grads[name] = {n: exe.grad_dict[n].to_torch().clone()
                           for n in "qkv"}
        gerr = max(_attn_close(grads["partitioned"][n],
                               grads["unpartitioned"][n], dtype,
                               "attention %s d%s" % (dtype, n))
                   for n in "qkv")
        if fwd_launches != 3:
            raise AssertionError("partitioned attention: %d flash launches "
                                 "over 3 forwards" % fwd_launches)
        q4, k4, v4 = (feed[n][:, None] for n in "qkv")
        # each executor's predict forward is one captured graph: its replay
        times = {name: cuda_ms(next(e for e in exe._entries.values()
                                    if e.pair is None).graph.replay)
                 for name, exe in exes.items()}
        times["sdpa"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0 / 8))
        el = torch.empty((), dtype=dt).element_size()
        bound, bound_by = bound_ms(4 * b * t * d * el, 4.0 * b * t * t * d,
                                   dtype)
        print("symbolic attention %s [%d, %d, %d] on %s: 1 "
              "_sg_flash_attention node, flash launches %d over 3 forwards; "
              "out vs unpartitioned max abs err %.3g, d(q,k,v) %.3g; device "
              "ms a forward: partitioned %.4f, unpartitioned %.4f, sdpa "
              "(graph) %.4f; bound %.4f (%s)" % (
                  dtype, b, t, d, card, fwd_launches, err, gerr,
                  times["partitioned"], times["unpartitioned"],
                  times["sdpa"], bound, bound_by), flush=True)
        rows.append(dict(dtype=dtype, out_err=err, grad_err=gerr,
                         launches=fwd_launches, bound_ms=bound, **times))
        del exes
    return rows


def symbolic_default_region(prefix, x8):
    """``partition(resnet50, "default")``: one ``_subgraph_exec`` region
    run inline inside the executor's captured graph, held to the
    unpartitioned symbol on the card at b8 f32."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.symbol.symbol import _topo
    sym, args, auxs = mt.model.load_checkpoint(prefix, 0)
    part = mt.sym.partition(sym, "default")
    ops = [n.op for n in _topo(part._heads) if not n.is_var()]
    if ops != ["_subgraph_exec"]:
        raise AssertionError("default partition gave %s" % ops[:5])
    outs = []
    for s in (sym, part):   # bound to the checkpoint's arrays, as the
        # partitioned graph's parameters feed its region (no shape rule)
        exe = s.bind(mt.gpu(0), args=dict(args, data=mt.nd.NDArray(x8)),
                     aux_states=auxs, grad_req="null")
        outs.append(exe.forward()[0].to_torch().clone())
    err = _rel(outs[1], outs[0])
    if err > 1e-5:
        raise AssertionError("default partition: %.3g of max|logit| from "
                             "the unpartitioned symbol" % err)
    print("symbolic default partition of resnet50_v1: 1 _subgraph_exec "
          "node, b8 f32 logits vs the unpartitioned symbol %.3g of "
          "max|logit|" % err, flush=True)


def symbolic_phase(card):
    """The symbolic API (slice 11, ROADMAP A7) on the card: export, serve
    from the files, train through Module, partitioned attention on B2
    (module docstring, item 13). Returns the phase's results."""
    import shutil
    import tempfile
    import gc
    import torch
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="symbolic_",
                            dir=os.path.join(ROOT, "build"))
    try:
        prefix, arrays, x8, _ = symbolic_export(card, root)
        serve = symbolic_serve(card, prefix, arrays, x8)
        gc.collect()
        torch.cuda.empty_cache()
        train = symbolic_train(card, prefix)
        gc.collect()
        torch.cuda.empty_cache()
        attention = symbolic_attention(card)
        symbolic_default_region(prefix, x8)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("symbolic phase %.1f s" % (time.time() - t_phase), flush=True)
    return {"serve": serve, "train": train, "attention": attention}


# ---------------------------------------------------------------- slice 12
# bench.py:246-305 bench_lstm_ptb (the reference's
# example/gluon/word_language_model defaults): 2-layer 650-unit LSTM over
# NTC, bptt 35, the PTB vocabulary, SGD lr 1.0
PTB = dict(vocab=33278, hidden=650, layers=2, bptt=35)
# training FLOPs per token, bench.py:290-293: 3 x 2 x (4 gates x (in +
# hid) x hid per layer + hid x vocab)
PTB_TRAIN_FLOPS = 3 * 2 * (4 * (650 + 650) * 650 * 2 + 650 * 33278)
RNN_SEED = 51
# examples/rnn/lstm_bucketing.py at the reference's example/rnn/bucketing
# defaults: 2 layers, 200 hidden, 200 embed, batch 32, these buckets
BUCKET_CFG = dict(layers=2, hidden=200, embed=200, batch=32, vocab=10000,
                  buckets=(10, 20, 30, 40, 50, 60))
BUCKET_OPT = {"learning_rate": 0.01, "momentum": 0.9}


def build_ptb_lm(arrays=None):
    """bench.py's RNNModel (Embedding, 2x650 LSTM over NTC, Dense over the
    vocabulary) on the CPU with seeded weights (or ``arrays``): (net,
    arrays)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon import nn, rnn

    class RNNModel(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(PTB["vocab"], PTB["hidden"])
                self.lstm = rnn.LSTM(PTB["hidden"], num_layers=PTB["layers"],
                                     layout="NTC")
                self.decoder = nn.Dense(PTB["vocab"], flatten=False)

        def hybrid_forward(self, F, tokens):
            return self.decoder(self.lstm(self.embed(tokens)))
    net = RNNModel()
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 2, dtype=torch.int32))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()},
            seed=RNN_SEED)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def ptb_tokens(b, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, PTB["vocab"], (b, PTB["bptt"]), dtype=np.int32),
            rng.integers(0, PTB["vocab"], (b, PTB["bptt"])).astype(
                np.float32))


def rnn_serve(card, arrays):
    """(a) The PTB LM served through Predictor, int32 token buckets b1 and
    b8 x 35, one captured graph each, float32 then bfloat16, against the
    same Predictor on the CPU; latency, host issue, device ms, idle share
    and kernels per forward."""
    import torch
    from mxtpu_torch.serving import BucketSpec, Predictor
    spec = BucketSpec([1, 8])
    net, _ = build_ptb_lm(arrays)
    cpu_net, _ = build_ptb_lm(arrays)
    tokens = torch.from_numpy(ptb_tokens(8, RNN_SEED + 1)[0])
    rows = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", SERVE_BF16_TOL)):
        if dtype == "bfloat16":
            net.cast("bfloat16")
            cpu_net.cast("bfloat16")
        t0 = time.time()
        pred = Predictor(net, spec, example=torch.zeros(
            1, PTB["bptt"], dtype=torch.int32), warmup=True, device="cuda",
            site="serving.predict.ptb_lm." + dtype)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        check_graphs(pred, spec, "ptb_lm " + dtype)
        cpu_pred = Predictor(cpu_net, spec, device="cpu",
                             site="cpu.ptb_lm." + dtype)
        errs = []
        for b in (1, 3, 8):
            got = pred.predict(tokens[:b]).to_torch().float().cpu()
            ref = cpu_pred.predict(tokens[:b]).to_torch().float()
            err = _rel(got, ref)
            if tuple(got.shape) != (b, PTB["bptt"], PTB["vocab"]) or \
                    not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(
                    "ptb_lm %s b%d: logits %s, %.3g of max|logit| from the "
                    "CPU's (limit %g)" % (dtype, b, tuple(got.shape), err,
                                          tol))
            errs.append(err)
        diff = replay_vs_eager(pred, tokens.cuda(), "ptb_lm " + dtype)
        print("serve ptb_lm (2x650 LSTM, vocab 33278) %s: warmup (%d graphs) "
              "%.2f s; logits vs the CPU at b1, b3, b8: %s of max|logit| "
              "(limit %g); b8 replay vs eager on the card max abs diff %.3g"
              % (dtype, len(pred._buckets), warm_s,
                 ", ".join("%.3g" % e for e in errs), tol, diff), flush=True)
        for b in (1, 8):
            x = tokens[:b].cuda()
            med, p80, issue = closed_loop(pred, x)
            kern = device_rows(lambda: pred.predict(x), 3)
            dev = sum(r[1] for r in kern)
            n_kern = round(sum(r[2] for r in kern))
            rows["%s b%d" % (dtype, b)] = dict(
                median_ms=med, p80_ms=p80, issue_ms=issue, device_ms=dev,
                idle=1 - dev / med, kernels=n_kern,
                tokens_per_s=b * PTB["bptt"] * 1e3 / med)
            print("  ptb_lm %s b%d x 35: median %.3f ms, p80 %.3f, host issue "
                  "%.3f, device %.3f ms (idle share %.3f), %d kernels a "
                  "forward, %.0f tokens/s on %s" % (
                      dtype, b, med, p80, issue, dev, 1 - dev / med, n_kern,
                      rows["%s b%d" % (dtype, b)]["tokens_per_s"], card),
                  flush=True)
        print_breakdown("serve ptb_lm %s b8" % dtype, device_rows(
            lambda: pred.predict(tokens.cuda()), 3),
            rows["%s b8" % dtype]["median_ms"], "gemm")
        # no build after the warm-up: one graph per bucket, as captured
        check_graphs(pred, spec, "ptb_lm %s after traffic" % dtype)
        pred.release()
    return rows


def rnn_train(card, arrays):
    """(b) The PTB LM trained captured (hybridize, SoftmaxCrossEntropyLoss
    over (-1, vocab), Trainer SGD lr 1.0): float32 b8 x 35 in lockstep
    with the CPU, then bfloat16 b128 x 35 timed."""
    import gc
    import numpy as np
    import torch
    import mxtpu_torch as mt
    sgd = {"learning_rate": 1.0}
    net, _ = build_ptb_lm(arrays)
    net.collect_params().reset_ctx(mt.gpu(0))
    net.hybridize()
    cpu_net, _ = build_ptb_lm(arrays)
    batches = [ptb_tokens(8, RNN_SEED + 2 + i) for i in range(2)]
    t0 = time.time()
    _, losses, worst, _ = lockstep_train(
        "ptb_lm train f32", net, cpu_net, batches, "sgd", sgd,
        reshape=PTB["vocab"])
    print("train ptb_lm f32 b8 x 35, hybridized (captured pair and update), "
          "2 SGD lr 1.0 steps on the card, each against the same step on "
          "the CPU from the card's state (%.1f s): mean losses %s; worst "
          "errors (elementwise of the scale, or relative L2): %s"
          % (time.time() - t0, losses, worst_line(worst)), flush=True)
    del cpu_net
    gc.collect()
    net.cast("bfloat16")
    tokens, labels = ptb_tokens(128, RNN_SEED + 5)
    x = mt.nd.array(tokens, ctx=mt.gpu(0), dtype="int32")
    y = mt.nd.array(labels, ctx=mt.gpu(0))
    timing = train_timing(
        "ptb_lm bf16 b128 x 35 (2x650 LSTM, SGD lr 1.0, captured)", net, x,
        y, "sgd", sgd, PTB["vocab"], card, PTB_TRAIN_FLOPS, 128 * 35,
        "bfloat16")
    if any(timing["builds_after_warmup"].values()):
        raise AssertionError("ptb_lm bf16: builds after the warm-up %s"
                             % timing["builds_after_warmup"])
    for p in net.collect_params().values():
        if not bool(torch.isfinite(p.data().to_torch().float()).all()):
            raise AssertionError("ptb_lm bf16: %s is not finite" % p.name)
    # bfloat16 weights, but the float32 begin state (as the reference's
    # nd.zeros) makes the recurrence, the second layer and the decoder
    # float32 products: read the rate against both peaks
    timing["mfu_f32_peak"] = PTB_TRAIN_FLOPS * timing["rate"] / \
        PEAK_FLOPS["float32"]
    print("train ptb_lm bf16 weights (float32 state, recurrence and "
          "decoder): %.1f tokens/s, train_mfu %.4f against the bfloat16 "
          "peak, %.4f against the float32 peak (%.4g FLOP a token, "
          "bench.py:290-293) on %s" % (
              timing["rate"], timing["mfu"], timing["mfu_f32_peak"],
              PTB_TRAIN_FLOPS, card), flush=True)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(timing, losses=losses, worst=worst)


def bucket_sym_gen(fused=False):
    """examples/rnn/lstm_bucketing.py's sym_gen at BUCKET_CFG: the mx.rnn
    LSTMCell stack (or one FusedRNNCell over the same weights, its
    forget bias in the packed blob) under SoftmaxOutput."""
    import mxtpu_torch as mt
    cfg = BUCKET_CFG
    if fused:
        stack = mt.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                                    mode="lstm", prefix="lstm_")
    else:
        stack = mt.rnn.SequentialRNNCell()
        for i in range(cfg["layers"]):
            stack.add(mt.rnn.LSTMCell(num_hidden=cfg["hidden"],
                                      prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mt.sym.var("data")
        label = mt.sym.var("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=cfg["vocab"],
                                 output_dim=cfg["embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  begin_state=stack.begin_state(
                                      batch_size=cfg["batch"]),
                                  merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, cfg["hidden"]))
        pred = mt.sym.FullyConnected(pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return stack, sym_gen


def bucket_batches(ctx):
    """Synthetic sentences over the vocabulary, two batches a bucket,
    through ``rnn.BucketSentenceIter`` onto ``ctx``: [DataBatch]."""
    import random
    import numpy as np
    import mxtpu_torch as mt
    cfg = BUCKET_CFG
    rng = np.random.default_rng(RNN_SEED + 7)
    sentences = []
    for top in cfg["buckets"]:
        for _ in range(2 * cfg["batch"]):
            n = int(rng.integers(top - 9, top + 1))
            sentences.append(rng.integers(1, cfg["vocab"], n).tolist())
    np.random.seed(RNN_SEED)
    random.seed(RNN_SEED)
    with ctx:
        it = mt.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                       buckets=list(cfg["buckets"]),
                                       invalid_label=0)
        return list(it)


def _bucket_module(sym_gen, ctx, arg_params=None):
    import mxtpu_torch as mt
    cfg = BUCKET_CFG
    top = max(cfg["buckets"])
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=top,
                                 context=ctx)
    mod.bind(data_shapes=[("data", (cfg["batch"], top))],
             label_shapes=[("softmax_label", (cfg["batch"], top))])
    mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                               magnitude=2.34),
                    arg_params=arg_params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(BUCKET_OPT))
    return mod


def _host_batch(b):
    import mxtpu_torch as mt
    out = mt.io.DataBatch([mt.nd.array(b.data[0].to_torch().cpu())],
                          [mt.nd.array(b.label[0].to_torch().cpu())],
                          bucket_key=b.bucket_key,
                          provide_data=b.provide_data,
                          provide_label=b.provide_label)
    return out


def rnn_bucketing(card):
    """(c) lstm_bucketing's mx.rnn stack under BucketingModule on the
    card: two steps in lockstep with the CPU, then every bucket timed (one
    captured pair a bucket, none after), then one bucket through
    FusedRNNCell (the RNN op reached through the executor)."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    cfg = BUCKET_CFG
    _, sym_gen = bucket_sym_gen()
    card_mod = _bucket_module(sym_gen, mt.gpu(0))
    _, cpu_gen = bucket_sym_gen()
    cpu_mod = _bucket_module(cpu_gen, mt.cpu())
    batches = bucket_batches(mt.gpu(0))
    by_key = {}
    for b in batches:
        by_key.setdefault(b.bucket_key, []).append(b)
    if sorted(by_key) != list(cfg["buckets"]):
        raise AssertionError("bucketing: batches for buckets %s"
                             % sorted(by_key))
    worst = {}

    def note(key, v, tol):
        worst[key] = max(worst.get(key, 0.0), v)
        if not v <= tol:
            raise AssertionError("bucketing lockstep: %s %.3g (limit %g)"
                                 % (key, v, tol))
    top = max(cfg["buckets"])
    for i, b in enumerate((by_key[top][0], by_key[cfg["buckets"][0]][0])):
        if i:
            _sync_module(cpu_mod._buckets[top], card_mod._buckets[top])
        before = {k: v.to_torch().clone()
                  for k, v in card_mod.get_params()[0].items()}
        card_mod.forward_backward(b)
        card_mod.update()
        torch.cuda.synchronize()
        cpu_mod.forward_backward(_host_batch(b))
        cpu_mod.update()
        out_c = card_mod.get_outputs()[0].to_torch().float().cpu()
        out_r = cpu_mod.get_outputs()[0].to_torch()
        note("outputs", (out_c - out_r).abs().max().item(), 1e-4)
        ge = card_mod._curr_module._exec.grad_dict
        gr = cpu_mod._curr_module._exec.grad_dict
        note("gradients", max(_l2(ge[k].to_torch(), gr[k].to_torch())
                              for k in gr if k in before), TRAIN_L2)
        arg_c, arg_r = card_mod.get_params()[0], cpu_mod.get_params()[0]
        note("weight changes", max(
            _l2(arg_c[k].to_torch().cpu() - before[k].cpu(),
                arg_r[k].to_torch() - before[k].cpu()) for k in arg_r),
             TRAIN_L2)
    print("bucketing (mx.rnn 2x200 LSTMCell stack, vocab 10000, b32) f32: "
          "steps on buckets %d and %d on the card, each against the same "
          "step on the CPU from the card's state: worst %s" % (
              top, cfg["buckets"][0], worst_line(worst)), flush=True)
    del cpu_mod

    def step(b):
        card_mod.forward_backward(b)
        card_mod.update()
    rows = {}
    for key in cfg["buckets"]:
        b = by_key[key][-1]
        start = _executor_builds()["executor"]
        step(b)   # a new bucket captures its pair here
        torch.cuda.synchronize()
        built = _executor_builds()["executor"] - start
        med, p80, issue = timed_steps(lambda: step(b), warm=1, n=5)
        rows[key] = dict(step_ms=med, p80_ms=p80, issue_ms=issue,
                         builds=built,
                         tokens_per_s=cfg["batch"] * key * 1e3 / med)
    start = _executor_builds()["executor"]
    for b in batches:
        step(b)
    torch.cuda.synchronize()
    rebuilt = _executor_builds()["executor"] - start
    out = card_mod.get_outputs()[0].to_torch()
    if not bool(torch.isfinite(out).all()) or rebuilt or any(
            r["builds"] > 1 for r in rows.values()):
        raise AssertionError("bucketing: finite outputs %s, builds per "
                             "bucket %s, builds over a second pass %d" % (
                                 bool(torch.isfinite(out).all()),
                                 {k: r["builds"] for k, r in rows.items()},
                                 rebuilt))
    print("bucketing on %s, per bucket (median step ms, p80, host issue, "
          "tokens/s, pairs captured at its first step here (buckets 60 and "
          "10 captured theirs in the lockstep); 5 steps after 1): %s;"
          " builds over a second pass of all %d batches: %d" % (
              card, ", ".join("%d: %.3f, %.3f, %.3f, %.0f, %d" % (
                  k, r["step_ms"], r["p80_ms"], r["issue_ms"],
                  r["tokens_per_s"], r["builds"]) for k, r in rows.items()),
              len(batches), rebuilt), flush=True)
    # one bucket through FusedRNNCell: the same weights packed, the forget
    # bias (which LSTMCell adds at run time) folded into the blob
    key = 30
    fused_cell, fused_gen = bucket_sym_gen(fused=True)
    args = {k: v.to_torch() for k, v in card_mod.get_params()[0].items()}
    for i in range(cfg["layers"]):
        bias = args["lstm_l%d_i2h_bias" % i].clone()
        bias[cfg["hidden"]:2 * cfg["hidden"]] += 1.0
        args["lstm_l%d_i2h_bias" % i] = bias
    with mt.gpu(0):
        packed = fused_cell.pack_weights(
            {k: mt.nd.array(v) for k, v in args.items()})
    fused_mod = _bucket_module(fused_gen, mt.gpu(0), arg_params=packed)
    b = by_key[key][0]
    fused_mod.forward(b, is_train=False)
    card_mod.forward(b, is_train=False)
    err = _rel(fused_mod.get_outputs()[0].to_torch(),
               card_mod.get_outputs()[0].to_torch())
    if err > 1e-4:
        raise AssertionError("FusedRNNCell bucket %d: outputs %.3g of max "
                             "from the LSTMCell stack's" % (key, err))
    start = _executor_builds()["executor"]

    def fused_step():
        fused_mod.forward_backward(b)
        fused_mod.update()
    med, p80, issue = timed_steps(fused_step, warm=2, n=5)
    fused_builds = _executor_builds()["executor"] - start
    if not bool(torch.isfinite(fused_mod.get_outputs()[0].to_torch()).all()):
        raise AssertionError("FusedRNNCell bucket: outputs not finite")
    rows["fused %d" % key] = dict(step_ms=med, p80_ms=p80, issue_ms=issue,
                                  builds=fused_builds)
    print("bucketing FusedRNNCell (the RNN op through the executor), bucket "
          "%d: predict outputs vs the LSTMCell stack %.3g of max; median step "
          "%.3f ms (p80 %.3f, host issue %.3f) against the stack's %.3f ms; "
          "builds %d (the first step's pair and update)" % (
              key, err, med, p80, issue, rows[key]["step_ms"],
              fused_builds), flush=True)
    return rows


def rnn_op_vs_cudnn(card):
    """(d) The RNN op at the PTB LM's shape (T 35, N 128, 650 -> 650, 2
    layers, LSTM) by graph replay, forward and forward + backward,
    float32 and bfloat16, beside torch.nn.LSTM (cuDNN) loaded with the
    same unpacked weights after checking that the two agree."""
    import torch
    from mxtpu_torch.ops import rnn_ops
    t_, n, h, layers = PTB["bptt"], 128, PTB["hidden"], PTB["layers"]
    size = rnn_ops.rnn_param_size("lstm", layers, h, h)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(RNN_SEED)
    rows = []
    for dtype, tol in (("float32", 1e-3), ("bfloat16", SERVE_BF16_TOL)):
        dt = getattr(torch, dtype)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(dt)
        x = rand(t_, n, h)
        params = rand(size, scale=0.05)
        h0, c0 = rand(layers, n, h), rand(layers, n, h)
        kw = dict(state_size=h, num_layers=layers, mode="lstm",
                  state_outputs=True)
        lstm = torch.nn.LSTM(h, h, num_layers=layers).to("cuda", dt)
        with torch.no_grad():
            for k, (w_ih, w_hh, b_ih, b_hh) in enumerate(
                    rnn_ops._unpack_params(params, "lstm", layers, h, h,
                                           False)):
                getattr(lstm, "weight_ih_l%d" % k).copy_(w_ih)
                getattr(lstm, "weight_hh_l%d" % k).copy_(w_hh)
                getattr(lstm, "bias_ih_l%d" % k).copy_(b_ih)
                getattr(lstm, "bias_hh_l%d" % k).copy_(b_hh)
            lstm.flatten_parameters()   # one weight buffer, as cuDNN wants
            ours = rnn_ops.RNN(x, params, h0, c0, **kw)
            ref_out, (ref_h, ref_c) = lstm(x, (h0, c0))
        errs = [_rel(a, b) for a, b in zip(ours, (ref_out, ref_h, ref_c))]
        if max(errs) > tol:
            raise AssertionError("RNN op vs torch.nn.LSTM %s: %s of max "
                                 "(limit %g)" % (dtype, errs, tol))
        leaves = [t.detach().requires_grad_() for t in (x, params, h0, c0)]
        cots = [rand(*o.shape) for o in ours]

        def op_fwd():
            with torch.no_grad():
                rnn_ops.RNN(x, params, h0, c0, **kw)

        def lib_fwd():
            with torch.no_grad():
                lstm(x, (h0, c0))

        def op_train():
            outs = rnn_ops.RNN(*leaves, **kw)
            torch.autograd.grad(outs, leaves, cots)

        lib_leaves = [leaves[0], leaves[2], leaves[3]] + list(
            lstm.parameters())

        def lib_train():
            out, (hh, cc) = lstm(leaves[0], (leaves[2], leaves[3]))
            torch.autograd.grad([out, hh, cc], lib_leaves, cots)
        # all four captured: a capture that fails ends the phase
        timed = {name: graph_ms(fn, launches=5) for name, fn in (
            ("ms", op_fwd), ("library_ms", lib_fwd), ("train_ms", op_train),
            ("library_train_ms", lib_train))}
        flops = 2 * t_ * n * 4 * h * (h + h) * layers
        n_bytes = (x.numel() + params.numel() + 2 * h0.numel()) * \
            x.element_size() + sum(o.numel() for o in ours) * \
            ours[0].element_size()
        bound, by = bound_ms(n_bytes, flops, dtype)
        train_bound, _ = bound_ms(2 * n_bytes, 3 * flops, dtype)
        row = dict(dtype=dtype, max_err=max(errs), bound_ms=bound,
                   bound_by=by, train_bound_ms=train_bound, **timed)
        rows.append(row)
        print("RNN op (ops/rnn_ops.py, LSTM T35 N128 650->650 x2) %s on %s: "
              "vs torch.nn.LSTM %.3g of max; by graph replay forward %.3f ms "
              "(cuDNN %.3f), forward + backward %.3f ms (cuDNN %.3f); bound "
              "%.4f / %.4f ms (%s)" % (
                  dtype, card, max(errs), timed["ms"], timed["library_ms"],
                  timed["train_ms"], timed["library_train_ms"], bound,
                  train_bound, by), flush=True)
    return rows


def rnn_gates(card):
    """(e) Card against CPU: CTCLoss at T 100, N 32, 29 classes (values and
    gradients), one Conv2DLSTMCell step, foreach inside a captured block;
    while_loop and cond raising inside a capture."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.gluon.contrib import rnn as crnn
    rng = np.random.default_rng(RNN_SEED + 9)
    # CTC: blank first, labels 1..28 padded with 0 to width 20
    data = rng.standard_normal((100, 32, 29)).astype(np.float32)
    label = np.zeros((32, 20), np.float32)
    for i in range(32):
        n = int(rng.integers(1, 21))
        label[i, :n] = rng.integers(1, 29, n)
    res = {}
    for dev in ("cuda", "cpu"):
        d = torch.tensor(data, device=dev, requires_grad=True)
        loss = mt.ops.CTCLoss(d, torch.tensor(label, device=dev))
        (g,) = torch.autograd.grad(loss.sum(), d)
        res[dev] = (loss.detach().cpu(), g.cpu())
    errs = [_rel(a, b) for a, b in zip(res["cuda"], res["cpu"])]
    if max(errs) > 1e-4 or not bool(torch.isfinite(res["cuda"][0]).all()):
        raise AssertionError("CTCLoss card vs CPU: values %.3g, gradients "
                             "%.3g of max" % tuple(errs))
    # one ConvLSTM step, 16 -> 32 channels over 32 x 32
    cells = []
    for ctx in (mt.gpu(0), mt.cpu()):
        cell = crnn.Conv2DLSTMCell((16, 32, 32), 32, 3, 3, i2h_pad=1,
                                   prefix="convlstm_")
        cell.initialize(mt.init.Xavier(), ctx=ctx)
        cells.append(cell)
    x = rng.standard_normal((8, 16, 32, 32)).astype(np.float32)
    outs = []
    for cell, dev in zip(cells, ("cuda", "cpu")):
        states = [torch.zeros(8, 32, 32, 32, device=dev)] * 2
        with torch.no_grad():
            out, new = cell(torch.tensor(x, device=dev), states)
        outs.append([out.cpu()] + [s.cpu() for s in new])
    conv_err = max(_rel(a, b) for a, b in zip(*outs))
    if conv_err > 1e-4:
        raise AssertionError("Conv2DLSTMCell card vs CPU: %.3g of max"
                             % conv_err)

    class Scan(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.proj = mt.gluon.nn.Dense(64, in_units=64,
                                              flatten=False)

        def hybrid_forward(self, F, xs):
            def step(x_t, h):
                h = F.tanh(self.proj(x_t) + h)
                return h, h
            return F.foreach(step, xs, F.zeros_like(xs[0]))

    class Loop(mt.gluon.HybridBlock):
        def __init__(self, kind, **kw):
            super().__init__(**kw)
            self._kind = kind

        def hybrid_forward(self, F, v):
            if self._kind == "while_loop":
                return F.while_loop(lambda u: u.sum() < 1e3,
                                    lambda u: u * 2, v)[1]
            return F.cond(v.sum() > 0, lambda u: u * 2, lambda u: -u, [v])
    scan = Scan()
    scan.initialize(mt.init.Xavier(), ctx=mt.cpu())
    seq = torch.tensor(rng.standard_normal((12, 16, 64)).astype(np.float32))
    with torch.no_grad():
        ref = scan(seq)
    scan.collect_params().reset_ctx(mt.gpu(0))
    scan.hybridize()
    with torch.no_grad():
        got = [scan(seq.cuda()) for _ in range(2)]
    xa = mt.nd.array(seq.numpy(), ctx=mt.gpu(0))
    xa.attach_grad()
    with mt.autograd.record():
        outs, last = scan(xa)
        (outs.sum() + last.sum()).backward()
    grad_c = xa.grad.to_torch().cpu()
    captured = (len(scan._cached_op._graphs), len(scan._cached_op._pairs))
    scan.hybridize(False)
    xb = mt.nd.array(seq.numpy(), ctx=mt.gpu(0))
    xb.attach_grad()
    with mt.autograd.record():
        outs_e, last_e = scan(xb)
        (outs_e.sum() + last_e.sum()).backward()
    fe_err = max(_rel(got[-1][0], ref[0]), _rel(got[-1][1], ref[1]),
                 _rel(grad_c, xb.grad.to_torch().cpu()))
    if fe_err > 1e-5 or captured != (1, 1):
        raise AssertionError("foreach captured: %.3g from eager, (graphs, "
                             "pairs) %s" % (fe_err, captured))
    from mxtpu_torch.base import MXNetError
    for kind in ("while_loop", "cond"):
        loop = Loop(kind)
        loop.hybridize()
        try:
            loop(torch.ones(4, device="cuda"))
            raise AssertionError("%s inside a captured block did not raise"
                                 % kind)
        except MXNetError as e:
            if "predicate on the host" not in str(e):
                raise
        loop.hybridize(False)
        if not bool(torch.isfinite(loop(torch.ones(4, device="cuda"))).all()):
            raise AssertionError("%s eager on the card" % kind)
    state_err = rnn_layer_states_gate()
    print("rnn gates, card vs CPU: CTCLoss T100 N32 C29 values %.3g, "
          "gradients %.3g of max; Conv2DLSTMCell step %.3g; foreach in a "
          "captured block (1 graph, 1 pair) vs eager %.3g; while_loop and "
          "cond refuse a capture; a hybridized LSTM's (x, [h, c]) captured "
          "(1 graph, 1 pair) vs eager %.3g" % (
              errs[0], errs[1], conv_err, fe_err, state_err), flush=True)
    return dict(ctc=errs, conv_lstm=conv_err, foreach=fe_err,
                layer_states=state_err)


def rnn_layer_states_gate():
    """A hybridized ``rnn.LSTM`` at the LM's widths called with its states,
    ``layer(x, [h, c])``, on the card: the nested inputs and the
    ``(outputs, states)`` pair through one captured graph (predict) and
    one captured pair (recorded), against the same calls eager; returns
    the largest difference of max."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    h = PTB["hidden"]
    layer = mt.gluon.rnn.LSTM(h, num_layers=PTB["layers"], layout="NTC",
                              input_size=h)
    layer.initialize(mt.init.Xavier(), ctx=mt.gpu(0))
    rng = np.random.default_rng(RNN_SEED + 11)
    x, h0, c0 = (rng.standard_normal(s).astype(np.float32) for s in (
        (8, PTB["bptt"], h), (PTB["layers"], 8, h), (PTB["layers"], 8, h)))
    results = []
    for hybrid in (True, False):
        layer.hybridize(hybrid)
        xt, ht, ct = (torch.tensor(a, device="cuda") for a in (x, h0, c0))
        with torch.no_grad():
            out, (h1, c1) = layer(xt, [ht, ct])
        arrays = [mt.nd.array(a, ctx=mt.gpu(0)) for a in (x, h0, c0)]
        for a in arrays:
            a.attach_grad()
        with mt.autograd.record():
            o2, (h2, c2) = layer(arrays[0], arrays[1:])
            (o2 * o2).sum().backward()
        results.append([out, h1, c1, h2.to_torch()] + [
            a.grad.to_torch() for a in arrays])
        if hybrid:
            captured = (len(layer._cached_op._graphs),
                        len(layer._cached_op._pairs))
    err = max(_rel(a, b) for a, b in zip(*results))
    if err > 1e-5 or captured != (1, 1):
        raise AssertionError("hybridized LSTM with states: %.3g from eager, "
                             "(graphs, pairs) %s" % (err, captured))
    return err


def rnn_phase(card):
    """The RNN slice (ROADMAP A6) on the card (module docstring, item 14):
    (a) the PTB LM served, (b) trained captured, (c) lstm_bucketing under
    BucketingModule with one FusedRNNCell bucket, (d) the RNN op beside
    torch.nn.LSTM, (e) CTCLoss, ConvLSTM and control flow gates. Returns
    the phase's results."""
    import gc
    import torch
    t_phase = time.time()
    _, arrays = build_ptb_lm()
    out = {"serve": rnn_serve(card, arrays)}
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = rnn_train(card, arrays)
    del arrays
    out["bucketing"] = rnn_bucketing(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["op"] = rnn_op_vs_cudnn(card)
    out["gates"] = rnn_gates(card)
    gc.collect()
    torch.cuda.empty_cache()
    print("rnn phase %.1f s" % (time.time() - t_phase), flush=True)
    return out


# --------------------------------------------------- slice 13: several ranks
PARALLEL_BATCH, PARALLEL_SEQ = 16, 512   # bench.py's BERT-base step
PARALLEL_STEPS = 3                       # the bit-equality gate's steps
PARALLEL_RANKS = 4                       # part (b): gloo ranks on one card
PARALLEL_B = dict(layers=2, dp_batch=8, seq=512, sp_batch=2, steps=3)
PARALLEL_TIMEOUT_S = 300                 # the rendezvous, and each join
ADAM_LR = 1e-4
# part (b)'s gates of A8's second part, f32, 2 layers at BERT-base widths
PARALLEL_EP = dict(batch=4)              # global b4 x 512, data 2 x expert 2
PARALLEL_TP = dict(batch=4, steps=3, lr=0.1)   # data 2 x model 2, SGD
PARALLEL_PIPE = dict(layers=8, batch=512, micro=8)   # pipe 4, d 768
PARALLEL_MODULE = dict(batch=64, steps=4)      # data 4, Dense 768-3072-10
# Switch-Base-8 (Fedus, Zoph and Shazeer, arXiv:2101.03961): 8 experts,
# capacity factor 1.25, at its d_model 768 / d_ff 3072 / 12 heads / 12
# layers, which are BERT-base's
MOE = dict(num_experts=8, capacity_factor=1.25)
MOE_EXPERTS = MOE["num_experts"]
MOE_ALPHA = 0.01                         # the aux loss's weight


def _par_batches(b, t, steps, seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (b, t), dtype=np.int32),
             rng.integers(0, vocab, (b, t)).astype(np.float32))
            for _ in range(steps)]


def _par_forward(vocab):
    """bench.py's ``forward``: the loss of the flattened logits."""
    import mxtpu_torch as mt
    loss_blk = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(block, tokens, labels):
        return loss_blk(block(tokens).reshape((-1, vocab)),
                        labels.reshape((-1,)))
    return forward


def _par_net(layers, arrays, device, dtype, mesh=None, causal=False,
             hybrid=True, experts=0):
    """bench.py's TransformerLM (BERT-base widths) with ``layers`` layers
    and the seeded ``arrays``, on ``device`` in ``dtype``; ``experts`` > 0
    the Switch MoE variant (``MOE``'s capacity factor)."""
    import torch
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    cfg = dict(BERT_BASE, num_layers=layers, causal=causal)
    if experts:
        cfg.update(MOE, num_experts=experts)
    net = TransformerLM(mesh=mesh, **cfg)
    net.initialize(ctx=device)
    with torch.no_grad():   # on the device: a split sequence's ring runs
        net(torch.zeros(1, 8, dtype=torch.int32, device=device))
    convert.load_mxtpu_params(net, arrays)
    if dtype != "float32":
        net.cast(dtype)
    if hybrid:
        net.hybridize()
    return net


def _par_arrays(layers, experts=0):
    """Seeded weights of the TransformerLM at BERT-base widths (the MoE
    variant's with ``experts``)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    cfg = dict(BERT_BASE, num_layers=layers)
    if experts:
        cfg.update(MOE, num_experts=experts)
    net = TransformerLM(**cfg)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    return convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=0)


def _weights_host(net):
    return [p.data()._data.detach().to("cpu", copy=True)
            for p in net.collect_params().values()]


def _rel_l2(got, want, dev=None):
    """Relative L2 of the concatenated ``got`` against ``want``, in
    float64 on ``dev`` (default: where they lie)."""
    import torch
    num = den = 0.0
    for a, b in zip(got, want):
        a, b = (x.to(dev or x.device, torch.float64) for x in (a, b))
        num += float(torch.sum((a - b) ** 2))
        den += float(torch.sum(b ** 2))
    return (num / max(den, 1e-300)) ** 0.5


def _par_run(kind, net, batches, mesh, vocab):
    """Train ``net`` on ``batches`` the ``kind`` way: "plain" (captured
    Trainer), "sharded" (ShardedTrainStep over ``mesh``) or "mesh"
    (Trainer(mesh=, zero1=True)). Returns (the step function, per-step
    (loss, host weights))."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.parallel import ShardedTrainStep
    forward = _par_forward(vocab)
    dev = net.collect_params().values().__iter__().__next__().data()._data \
        .device
    data = [(mt.nd.array(x, ctx=dev, dtype="int32"), mt.nd.array(y, ctx=dev))
            for x, y in batches]
    cur = [0]
    if kind == "sharded":
        st = ShardedTrainStep(net, None, mesh, optimizer="adam",
                              optimizer_params={"learning_rate": ADAM_LR},
                              forward=forward)

        def step():
            x, y = data[cur[0] % len(data)]
            cur[0] += 1
            return st(x, y)
    else:
        tr = mt.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": ADAM_LR},
                              mesh=mesh if kind == "mesh" else None,
                              zero1=True if kind == "mesh" else None)

        def step():
            x, y = data[cur[0] % len(data)]
            cur[0] += 1
            with mt.autograd.record():
                loss = forward(net, x, y).mean()
            loss.backward()
            tr.step(1)
            return loss
    trace = []
    for _ in range(len(batches)):
        loss = step()
        trace.append((float(loss.asnumpy()), _weights_host(net)))
    torch.cuda.synchronize()
    return step, trace


def parallel_world_of_one(card):
    """Part (a): a world of one NCCL rank in this process. bench.py's
    BERT-base TransformerLM (bidirectional, bf16) trained 3 Adam steps
    through the plain captured Trainer, ``ShardedTrainStep(
    data_parallel_mesh())`` and ``Trainer(mesh=, zero1=True)``, each step
    bit-equal to the plain one's (loss and every weight) under torch's
    deterministic algorithms (the embeddings' ``index_add_`` backward sums
    by atomics otherwise); then each way's b16 x 512 step timed as it
    runs by default, on a net of its own: B2 12 launches a forward, 0
    builds after the warm-up.
    Also part (b)'s reference, the world of one's steps of the 2-layer
    f32 model (``parallel_b_reference``). Destroys the group."""
    import gc
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    t_part = time.time()
    rdv = os.path.join(ROOT, "build", "par_a_rdv")
    if os.path.exists(rdv):
        os.remove(rdv)
    mt.distributed.init("file://" + rdv, num_processes=1, process_id=0,
                        backend="nccl", timeout=PARALLEL_TIMEOUT_S)
    try:
        mesh = par.data_parallel_mesh()
        print("parallel (a): world of %d, backend %s, mesh %s"
              % (mt.distributed.num_workers(), mt.distributed.backend(),
                 dict(mesh.shape)), flush=True)
        layers = BERT_BASE["num_layers"]
        vocab, dim = BERT_BASE["vocab_size"], BERT_BASE["dim"]
        b, t = PARALLEL_BATCH, PARALLEL_SEQ
        arrays = _par_arrays(layers)
        batches = _par_batches(b, t, PARALLEL_STEPS, 21, vocab)
        dev = torch.device("cuda", 0)
        flops = 3 * 2 * (layers * (12 * dim * dim + 2 * t * dim)
                         + dim * vocab)
        rows, ref = {}, None
        net = _par_net(layers, arrays, dev, "bfloat16")
        first = [p.data()._data.clone() for p in
                 net.collect_params().values()]

        def fresh():
            """The net with its first weights in new tensors (a leaf's
            gradient node from an earlier run stays on the stream it ran
            on, which a new capture cannot wait for), its captures
            dropped."""
            gc.collect()
            torch.cuda.empty_cache()
            for p, w in zip(net.collect_params().values(), first):
                p.set_data(w)
            net.hybridize()
            return net
        for kind in ("plain", "sharded", "mesh"):
            # the gate under torch's deterministic algorithms: the
            # embeddings' backward (index_add_) sums by atomics otherwise,
            # and no two runs of any way would agree bit for bit
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                step, trace = _par_run(kind, fresh(), batches, mesh, vocab)
            finally:
                torch.use_deterministic_algorithms(False)
            if ref is None:
                ref = trace
            else:
                for k, ((la, wa), (lb, wb)) in enumerate(zip(trace, ref)):
                    bad = [i for i, (x, y) in enumerate(zip(wa, wb))
                           if not torch.equal(x, y)]
                    if la != lb or bad:
                        raise AssertionError(
                            "parallel (a) %s step %d: loss %r vs plain %r, "
                            "%d weights differ" % (kind, k, la, lb,
                                                   len(bad)))
            del step, trace
            # timed as it runs by default (captured afresh)
            step, _ = _par_run(kind, fresh(), batches[:1], mesh, vocab)
            start = flash_attention.launches   # a step after the captures
            step()
            torch.cuda.synchronize()
            per_fwd = flash_attention.launches - start
            if per_fwd != layers:
                raise AssertionError("parallel (a) %s: B2 launched %s times "
                                     "a forward, expected %d"
                                     % (kind, per_fwd, layers))
            torch.cuda.reset_peak_memory_stats()
            warm = {}

            def on_warm():
                warm.update(_builds())
            med, p80, issue = timed_steps(step, on_warm=on_warm)
            built = {k: v - warm[k] for k, v in _builds().items()}
            if any(built.values()):
                raise AssertionError("parallel (a) %s: builds after the "
                                     "warm-up %s" % (kind, built))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rate = b * t * 1e3 / med
            print("parallel (a) %s: BERT-base bf16 b%d x %d Adam step on %s: "
                  "%.1f tokens/s at the median %.3f ms (p80 %.3f, median "
                  "host issue %.3f ms; 10 after 3), peak %.2f GiB, builds "
                  "after the warm-up %s, B2 launches a forward %g; %d steps "
                  "bit-equal to the plain captured Trainer's (torch's "
                  "deterministic algorithms on for that gate)" % (
                      kind, b, t, card, rate, med, p80, issue, peak, built,
                      per_fwd, PARALLEL_STEPS), flush=True)
            dev_ms = print_step_breakdown(
                "parallel (a) " + kind, device_rows(step, 2), med,
                flops * rate, "bfloat16", card)
            rows[kind] = dict(step_ms=med, p80_ms=p80, issue_ms=issue,
                              tokens_per_s=rate, device_ms=dev_ms,
                              idle=1 - dev_ms / med, peak_gib=peak,
                              b2_per_forward=per_fwd)
            del step
        del ref, net, first
        gc.collect()
        torch.cuda.empty_cache()
        parallel_b_reference(mesh)
    finally:
        mt.distributed.shutdown()
    print("parallel (a) %.1f s" % (time.time() - t_part), flush=True)
    return rows


def _dp_steps(net, mesh, batches, rows, zero, dev):
    """``ShardedTrainStep`` Adam steps over ``mesh`` on ``rows`` of each
    batch, under torch's deterministic algorithms (the embeddings'
    backward sums by atomics otherwise, and two runs would not take the
    same local gradients). Returns the losses, the step ms, this rank's
    first-step gradients before the collectives ("local") and as the
    update takes them ("summed": a ZeRO-1 parameter's as this rank's
    rows), and the host weights after each step."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    st = par.ShardedTrainStep(net, None, mesh, optimizer="adam",
                              optimizer_params={"learning_rate": ADAM_LR},
                              forward=_par_forward(BERT_BASE["vocab_size"]),
                              shard_weight_update=zero)
    upd, first = st._updater, {}
    mesh_update, update_items = upd._mesh_update, upd._update_items

    def host(grads):
        return [g._data.detach().to("cpu", copy=True) for g in grads]

    def on_mesh_update(indices, grads, weights):
        first.setdefault("local", host(grads))
        return mesh_update(indices, grads, weights)

    def on_update_items(indices, grads, weights):
        first.setdefault("summed", host(grads))
        return update_items(indices, grads, weights)
    upd._mesh_update, upd._update_items = on_mesh_update, on_update_items
    losses, ms, weights = [], [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = st(mt.nd.array(x[rows], ctx=dev, dtype="int32"),
                      mt.nd.array(y[rows], ctx=dev))
            losses.append(float(loss.asnumpy()))
            ms.append(1e3 * (time.perf_counter() - t0))
            weights.append(_weights_host(net))
    finally:
        torch.use_deterministic_algorithms(False)
    if len(first["summed"]) != len(weights[0]):
        raise AssertionError("parallel (b): a parameter without a gradient")
    return dict(losses=losses, ms=ms, weights=weights, **first)


def parallel_b_reference(mesh):
    """Part (b)'s reference, the world of one (``mesh`` of one rank): 3
    ``ShardedTrainStep`` Adam steps of the 2-layer f32 model on part (b)'s
    global batch. Saves under build/ its losses, its first step's
    gradients (``g*``) and its weights after each step (``w<step>_*``)."""
    import numpy as np
    import torch
    pb = PARALLEL_B
    dev = torch.device("cuda", 0)
    net = _par_net(pb["layers"], _par_arrays(pb["layers"]), dev, "float32",
                   hybrid=False)
    run = _dp_steps(net, mesh, _par_batches(
        pb["dp_batch"], pb["seq"], pb["steps"], 22, BERT_BASE["vocab_size"]),
        slice(None), False, dev)
    saved = {"losses": np.array(run["losses"])}
    saved.update(("g%d" % i, g.numpy()) for i, g in enumerate(run["summed"]))
    for t, ws in enumerate(run["weights"]):
        saved.update(("w%d_%d" % (t + 1, i), w.numpy())
                     for i, w in enumerate(ws))
    np.savez(os.path.join(ROOT, "build", "par_b_ref.npz"), **saved)
    # the expert-parallel gate's reference: one step of the 2-layer f32
    # MoE model on the global batch, nothing sharded
    del net, run
    net = _par_net(pb["layers"], _par_arrays(pb["layers"], MOE_EXPERTS),
                   dev, "float32", hybrid=False, experts=MOE_EXPERTS)
    run = _mesh_steps(net, mesh, _par_batches(
        PARALLEL_EP["batch"], pb["seq"], 1, 24, BERT_BASE["vocab_size"]),
        slice(None), dev, _moe_forward(BERT_BASE["vocab_size"]))
    saved = {"losses": np.array(run["losses"]), "aux": run["aux"]}
    saved.update(("g%d" % i, g.numpy()) for i, g in enumerate(run["summed"]))
    np.savez(os.path.join(ROOT, "build", "par_b_moe_ref.npz"), **saved)


def _par_transfer_timer():
    """Wrap the collectives' entry points to add their wall ms
    (synchronized) to the returned list's first item."""
    import torch
    from mxtpu_torch.parallel import collectives as col
    spent = [0.0]

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += 1e3 * (time.perf_counter() - t0)
            return out
        return call
    for name in ("all_reduce_", "all_gather_into_", "_reduce_scatter0",
                 "broadcast_", "_permute"):
        setattr(col, name, timed(getattr(col, name)))
    return spent


# Each sum over the 4 ranks is exact to gamma_3 * sum_r |g_r| in any order
# (Higham, Accuracy and Stability of Numerical Algorithms, eq. 4.4), so two
# orders (gloo's all-reduce of another buffer layout) differ by at most
# twice that, element by element
GAMMA_3 = 3 * 2.0 ** -24 / (1 - 3 * 2.0 ** -24)


def _dp_check(rank, world, mesh, dev, layers, spent):
    """Part (b)'s data-parallel numbers on this rank: ZeRO-1 off and on,
    3 Adam steps on this rank's rows of the world of one's batches, held
    to the world of one's saved run; and, for each gate, what it reads
    under a planted fault, from this run's own tensors."""
    import numpy as np
    import torch
    from mxtpu_torch.parallel import collectives as col
    pb = PARALLEL_B
    arrays = _par_arrays(layers)
    batches = _par_batches(pb["dp_batch"], pb["seq"], pb["steps"], 22,
                           BERT_BASE["vocab_size"])
    k = pb["dp_batch"] // world
    ref = np.load(os.path.join(ROOT, "build", "par_b_ref.npz"))
    n = len(arrays)
    ref_g = [torch.from_numpy(ref["g%d" % i]) for i in range(n)]
    ref_w = [[torch.from_numpy(ref["w%d_%d" % (t, i)]) for i in range(n)]
             for t in range(1, pb["steps"] + 1)]
    data = mesh.axis("data")
    out, runs = {}, {}
    for zero in (False, True):
        net = _par_net(layers, arrays, dev, "float32", hybrid=False)
        w0 = _weights_host(net)
        ref_steps = [w0] + ref_w
        spent[0] = 0.0
        run = _dp_steps(net, mesh, batches, slice(rank * k, (rank + 1) * k),
                        zero, dev)
        del net
        runs[zero] = run
        mine = [w0] + run["weights"]
        rows = [None if s.shape == w.shape else slice(
            data.index * s.shape[0], (data.index + 1) * s.shape[0])
            for s, w in zip(run["summed"], w0)]

        def cut(ts):
            return [t if r is None else t[r] for t, r in zip(ts, rows)]
        want = cut(ref_g)
        step_rel = [_rel_l2([a - b for a, b in zip(mine[t + 1], mine[t])],
                            [a - b for a, b in zip(ref_steps[t + 1],
                                                   ref_steps[t])], dev)
                    for t in range(pb["steps"])]
        d = dict(
            losses=run["losses"], step_ms=run["ms"],
            transfer_ms=spent[0] / len(run["ms"]),
            loss_err=float(np.max(np.abs(np.array(run["losses"])
                                         - ref["losses"]))),
            # the summed gradient (the update's rescale 1/world applied)
            grad_rel=_rel_l2([s / world for s in run["summed"]], want,
                             dev),
            # planted: no all-reduce, the update takes this rank's own
            planted_no_sum=_rel_l2(cut([g / world for g in run["local"]]),
                                   want, dev),
            step_rel=step_rel, sharded=sum(r is not None for r in rows))
        if zero:
            # planted: the all-gather returns the other ranks' rows stale
            stale = []
            for i, r in enumerate(rows):
                delta = mine[1][i] - w0[i]
                if r is not None:
                    keep = torch.zeros_like(delta)
                    keep[r] = delta[r]
                    delta = keep
                stale.append(delta)
            d["planted_stale_gather"] = _rel_l2(
                stale, [a - b for a, b in zip(ref_w[0], w0)], dev)
        out["z%d" % zero] = d
    # ZeRO-1 on against off: the same local gradients, summed by gloo in
    # two buffer layouts; each element within twice gamma_3 sum_r |g_r|
    off, on = runs[False], runs[True]
    if not all(torch.equal(a, b) for a, b in zip(off["local"], on["local"])):
        raise AssertionError("parallel (b) rank %d: ZeRO-1 on and off took "
                             "different local gradients" % rank)
    worst, excess = 0.0, 0
    for s_on, s_off, g in zip(on["summed"], off["summed"], off["local"]):
        a = g.to(dev).abs()
        col.all_reduce_(a, data)
        s_on, s_off = s_on.to(dev), s_off.to(dev)
        if s_on.shape != s_off.shape:
            r = slice(data.index * s_on.shape[0],
                      (data.index + 1) * s_on.shape[0])
            s_off, a = s_off[r], a[r]
        diff = (s_on.double() - s_off.double()).abs()
        bound = 2 * GAMMA_3 * a.double()
        excess += int((diff > bound).sum())
        pos = bound > 0
        if bool(pos.any()):
            worst = max(worst, float((diff[pos] / bound[pos]).max()))
    # the weights after each step, on against off; where the first step's
    # weights differ most, the world of one's gradient there (Adam's step
    # lr m/(sqrt(v) + eps) turns a rounding difference of a sum near eps
    # into one of order lr)
    dw = [(a.to(dev) - b.to(dev)).abs() for a, b in zip(on["weights"][0],
                                                        off["weights"][0])]
    i_max = max(range(n), key=lambda i: float(dw[i].max()))
    j_max = int(dw[i_max].argmax())
    moved = torch.cat([(x > 1e-6).reshape(-1) for x in dw])
    g_all = torch.cat([g.to(dev).abs().reshape(-1) for g in ref_g])
    out["zero_on_off"] = dict(
        grad_excess=excess, grad_worst_of_bound=worst,
        step_rel=[_rel_l2([a - b for a, b in zip(on["weights"][t],
                                                 on["weights"][t - 1]
                                                 if t else w0)],
                          [a - b for a, b in zip(off["weights"][t],
                                                 off["weights"][t - 1]
                                                 if t else w0)], dev)
                  for t in range(pb["steps"])],
        weight_err=float(dw[i_max].max()),
        grad_at_worst=float(ref_g[i_max].reshape(-1)[j_max]),
        share_beyond_1e6=float(moved.double().mean()),
        median_grad_beyond_1e6=float(g_all[moved].median())
        if bool(moved.any()) else 0.0,
        median_grad=float(g_all.median()))
    return out


def _ring_attention_check(sp, dev, b, t):
    """The ring's attention alone against the whole sequence's, at the
    model's per-layer shape ``[b, 12, t, 64]`` f32 (seeded q, k, v and
    cotangent, the same on every rank): the relative L2 of this rank's
    out and q, k, v gradients for the flash ring, the dense ring, and the
    flash ring with its lse gradient dropped (a planted fault). Also
    where the kernel and its plain version part: B2's lse against
    ``flash_attention_reference``'s, and ``flash_attention_backward`` fed
    the kernel's out/lse against fed the plain version's."""
    import numpy as np
    import torch
    fa = importlib.import_module("mxtpu_torch.ops.pallas.flash_attention")
    ra = importlib.import_module("mxtpu_torch.parallel.ring_attention")
    axis = sp.axis("sp")
    tl = t // axis.size
    cols = slice(axis.index * tl, (axis.index + 1) * tl)
    rng = np.random.default_rng(31)
    q, k, v, r = (torch.from_numpy(rng.standard_normal(
        (b, 12, t, 64), dtype=np.float32)).to(dev) for _ in range(4))

    def no_g_lse(*a, **kw):
        o, lse = fa.flash_attention_with_lse(*a, **kw)
        return o, lse.detach()
    out = {}
    for causal in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
        (o * r).sum().backward()
        whole = [o.detach()] + [x.grad for x in leaves]
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
        fed = [fa.flash_attention_backward(q, k, v, oo, ll, r, causal,
                                           0.125)
               for oo, ll in ((o.detach(), lse.detach()), (o_ref, lse_ref))]
        row = dict(lse_err=float((lse.detach() - lse_ref).abs().max()),
                   out_rel=_rel_l2([o.detach()], [o_ref]),
                   bwd_fed_rel=_rel_l2(fed[0], fed[1]))
        for name, body, plant in (
                ("flash", ra.ring_flash_attention, False),
                ("dense", ra.ring_attention, False),
                ("planted: flash, lse gradient dropped",
                 ra.ring_flash_attention, True)):
            mine = [x[:, :, cols].clone().requires_grad_() for x in (q, k, v)]
            if plant:
                ra.flash_attention_with_lse = no_g_lse
            try:
                o_s = body(*mine, axis, causal=causal)
            finally:
                ra.flash_attention_with_lse = fa.flash_attention_with_lse
            (o_s * r[:, :, cols]).sum().backward()
            got = [o_s.detach()] + [x.grad for x in mine]
            row[name] = max(_rel_l2([g], [w[:, :, cols]])
                            for g, w in zip(got, whole))
        out["causal=%d" % causal] = row
    return out


def _ring_model_check(sp, dev, layers, tok, lab, cols, world):
    """One step's gradients of the 2-layer f32 causal model, its
    sequence over ``sp``, against the whole model's (summed over the ring
    and scaled as the step does): the flash ring, the dense ring and the
    flash ring with its lse gradient dropped (planted), each as relative
    L2 over every parameter, its worst parameter, and the ReLU mask flips
    of each block's first MLP layer against the whole model's (a unit
    whose input rounds to the other side of 0 takes or drops its whole
    term of that layer's weight gradient)."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.optimizer_fused import _bucket_all_reduce
    fa = importlib.import_module("mxtpu_torch.ops.pallas.flash_attention")
    ra = importlib.import_module("mxtpu_torch.parallel.ring_attention")
    arrays = _par_arrays(layers)
    forward = _par_forward(BERT_BASE["vocab_size"])

    def no_g_lse(*a, **kw):
        o, lse = fa.flash_attention_with_lse(*a, **kw)
        return o, lse.detach()
    grads, masks = {}, {}
    for name, mesh_, flash, plant in (
            ("whole", None, True, False), ("again", None, True, False),
            ("flash", sp, True, False), ("dense", sp, False, False),
            ("planted", sp, True, True)):
        prev = par.set_ring_flash(flash)
        if plant:
            ra.flash_attention_with_lse = no_g_lse
        net = _par_net(layers, arrays, dev, "float32", mesh=mesh_,
                       causal=True, hybrid=False)
        seen = []
        hooks = [blk.fc1.register_forward_hook(
            lambda blk_, inp, o: seen.append(
                (getattr(o, "_data", o) > 0).cpu())) for blk in net.blocks]
        try:
            x = mt.nd.array(tok if mesh_ is None else tok[:, cols], ctx=dev,
                            dtype="int32")
            y = mt.nd.array(lab if mesh_ is None else lab[:, cols], ctx=dev)
            with mt.autograd.record():
                loss = forward(net, x, y).mean()
            loss.backward()
        finally:
            for h in hooks:
                h.detach()
            ra.flash_attention_with_lse = fa.flash_attention_with_lse
            par.set_ring_flash(prev)
        g = [p.grad()._data.clone() for p in net.collect_params().values()]
        if mesh_ is not None:
            _bucket_all_reduce(g, sp.axis("sp"))
            g = [x / world for x in g]
        grads[name] = g
        masks[name] = seen if mesh_ is not None else [m[:, cols]
                                                     for m in seen]
        names = list(net.collect_params())
        del net, g
    res = {}
    for name in ("again", "flash", "dense", "planted"):
        rel = [_rel_l2([a], [b]) for a, b in zip(grads[name],
                                                 grads["whole"])]
        res[name] = dict(
            rel_l2=_rel_l2(grads[name], grads["whole"]), worst=max(rel),
            worst_param=names[rel.index(max(rel))],
            relu_flips=sum(int((a != b).sum()) for a, b in
                           zip(masks[name], masks["whole"])))
    res["units"] = sum(int(m.numel()) for m in masks["whole"])
    return res


def _moe_forward(vocab, alpha=None):
    """The MoE model's objective: bench.py's loss plus ``alpha`` (default
    ``MOE_ALPHA``) times the Switch aux loss."""
    import mxtpu_torch as mt
    loss_blk = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    alpha = MOE_ALPHA if alpha is None else alpha

    def forward(block, tokens, labels):
        ce = loss_blk(block(tokens).reshape((-1, vocab)),
                      labels.reshape((-1,)))
        return ce + alpha * block.aux_loss()
    return forward


def _mesh_steps(net, mesh, batches, rows, dev, forward, optimizer="adam",
                params=None, param_specs=()):
    """``ShardedTrainStep`` steps over ``mesh`` on ``rows`` of each batch,
    under torch's deterministic algorithms: the losses, this rank's
    first-step gradients as the update takes them, times the step's
    ``rescale_grad`` ("summed": the gradient of the global mean loss, a
    sharded parameter's as this rank's shard), the last aux loss (MoE
    only) and the step."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    st = par.ShardedTrainStep(net, None, mesh, optimizer=optimizer,
                              optimizer_params=dict(
                                  params or {"learning_rate": ADAM_LR}),
                              param_specs=param_specs, forward=forward)
    upd, first = st._updater, {}
    update_items = upd._update_items

    def on_update_items(indices, grads, weights):
        first.setdefault("summed", [
            g._data.detach().to("cpu", copy=True) * st._opt.rescale_grad
            for g in grads])
        return update_items(indices, grads, weights)
    upd._update_items = on_update_items
    losses = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for x, y in batches:
            loss = st(mt.nd.array(x[rows], ctx=dev, dtype="int32"),
                      mt.nd.array(y[rows], ctx=dev))
            losses.append(float(loss.asnumpy()))
    finally:
        torch.use_deterministic_algorithms(False)
        upd._update_items = update_items
    aux = net.aux_loss() if getattr(net, "_moe", False) else 0.0
    aux = float(aux.asnumpy() if hasattr(aux, "asnumpy") else aux)
    return dict(losses=losses, aux=aux, step=st, **first)


def _shard_rows(whole, local, placement):
    """This rank's block of ``whole`` where ``local`` (its shard) is
    smaller: the rows or columns of its index along each split axis."""
    if placement is None or tuple(whole.shape) == tuple(local.shape):
        return whole
    for dim, name in enumerate(placement.spec):
        if name is not None:
            ax = placement.mesh.axis(name)
            k = whole.shape[dim] // ax.size
            whole = whole.narrow(dim, ax.index * k, k)
    return whole


def _ep_check(rank, world, dev):
    """Expert parallel over data 2 x expert 2, ``expert_parallel_rules``:
    one Adam step of the 2-layer f32 MoE model on this rank's data rows,
    its summed gradients (each expert shard against its slice), aux loss
    and loss against the world of one's on the global batch; then the
    same with ``psum`` planted in place of ``reduce_from``."""
    import numpy as np
    import torch
    from mxtpu_torch import parallel as par
    from mxtpu_torch.gluon.model_zoo.transformer import expert_parallel_rules
    from mxtpu_torch.parallel import collectives as col
    from mxtpu_torch.parallel import moe as tmoe
    pb, ep_cfg = PARALLEL_B, PARALLEL_EP
    vocab = BERT_BASE["vocab_size"]
    ref = np.load(os.path.join(ROOT, "build", "par_b_moe_ref.npz"))
    mesh = par.make_mesh({"data": 2, "expert": 2})
    data = mesh.axis("data")
    k = ep_cfg["batch"] // data.size
    batches = _par_batches(ep_cfg["batch"], pb["seq"], 1, 24, vocab)
    arrays = _par_arrays(pb["layers"], MOE_EXPERTS)
    out = {}
    for name in ("ep", "planted"):
        if name == "planted":
            tmoe.reduce_from = col.psum
        net = _par_net(pb["layers"], arrays, dev, "float32", hybrid=False,
                       experts=MOE_EXPERTS)
        t0 = time.perf_counter()
        try:
            run = _mesh_steps(net, mesh, batches,
                              slice(data.index * k, (data.index + 1) * k),
                              dev, _moe_forward(vocab),
                              param_specs=expert_parallel_rules("expert"))
        finally:
            tmoe.reduce_from = col.reduce_from
        params = list(net.collect_params().values())
        want = [_shard_rows(torch.from_numpy(ref["g%d" % i]), g,
                            par.train.placement(p))
                for i, (p, g) in enumerate(zip(params, run["summed"]))]
        sharded = [p.name for p in params
                   if par.train.placement(p) is not None]
        out[name] = dict(
            ms=1e3 * (time.perf_counter() - t0),
            grad_rel=_rel_l2(run["summed"], want),
            router_rel=_rel_l2([g for p, g in zip(params, run["summed"])
                                if p.name.endswith("moe_router")],
                               [w for p, w in zip(params, want)
                                if p.name.endswith("moe_router")]),
            loss=run["losses"][0], ref_loss=float(ref["losses"][0]),
            aux=run["aux"], ref_aux=float(ref["aux"]),
            sharded=len(sharded),
            shard_rows=sorted({int(p.data().shape[0]) for p in params
                               if par.train.placement(p) is not None}))
        del net, run
    return out


def _tp_check(rank, world, dev):
    """Tensor parallel over data 2 x model 2, ``tensor_parallel_rules``:
    3 SGD steps of the 2-layer f32 model against the same steps with
    every parameter replicated (losses; first-step summed gradients, each
    shard against its slice), each sharded weight's bytes on this rank
    against its whole; then a planted sum over the model axis."""
    import torch
    from mxtpu_torch import optimizer_fused
    from mxtpu_torch import parallel as par
    from mxtpu_torch.gluon.model_zoo.transformer import tensor_parallel_rules
    pb = PARALLEL_B
    vocab = BERT_BASE["vocab_size"]
    mesh = par.make_mesh({"data": 2, "model": 2})
    data = mesh.axis("data")
    k = PARALLEL_TP["batch"] // data.size
    rows = slice(data.index * k, (data.index + 1) * k)
    batches = _par_batches(PARALLEL_TP["batch"], pb["seq"],
                           PARALLEL_TP["steps"], 25, vocab)
    arrays = _par_arrays(pb["layers"])
    sgd = {"learning_rate": PARALLEL_TP["lr"]}
    runs, out = {}, {}
    plan = optimizer_fused.MeshPlan
    whole_axes = plan.WHOLE_GRADIENT_AXES
    for name, specs, steps in (
            ("repl", (), batches), ("tp", tensor_parallel_rules("model"),
                                    batches),
            ("planted", tensor_parallel_rules("model"), batches[:1])):
        if name == "planted":
            plan.WHOLE_GRADIENT_AXES = ("expert", "pipe")
        net = _par_net(pb["layers"], arrays, dev, "float32", hybrid=False)
        t0 = time.perf_counter()
        try:
            run = _mesh_steps(net, mesh, steps, rows, dev,
                              _par_forward(vocab), optimizer="sgd",
                              params=sgd, param_specs=specs)
        finally:
            plan.WHOLE_GRADIENT_AXES = whole_axes
        run["ms"] = 1e3 * (time.perf_counter() - t0)
        params = list(net.collect_params().values())
        run["placements"] = [par.train.placement(p) for p in params]
        run["bytes"] = [(p.name, p.data()._data.numel()
                         * p.data()._data.element_size(),
                         int(torch.tensor(p.shape).prod())
                         * p.data()._data.element_size())
                        for p in params
                        if par.train.placement(p) is not None]
        run.pop("step")
        runs[name] = run
        del net
    repl = runs["repl"]["summed"]
    for name in ("tp", "planted"):
        r = runs[name]
        want = [_shard_rows(w, g, pl) for w, g, pl in
                zip(repl, r["summed"], r["placements"])]
        out[name] = dict(
            ms=r["ms"], losses=r["losses"],
            loss_err=max(abs(a - b) for a, b in
                         zip(r["losses"], runs["repl"]["losses"])),
            grad_rel=_rel_l2(r["summed"], want),
            bytes=r["bytes"])
    out["repl"] = dict(ms=runs["repl"]["ms"], losses=runs["repl"]["losses"])
    return out


def _pipe_check(rank, world, dev):
    """``pipeline_apply`` over pipe 4: 8 layers ``tanh(h @ w + b)`` at d
    768, 8 microbatches, against the sequential stack on this rank: the
    output, and the gradients of sum(out^2), every row of the stack and
    the input's, whole on every rank (each relative L2); then ``psum``
    planted in place of ``reduce_from``, and the pipeline's ``copy_to``
    planted away (each rank keeps its stage's part)."""
    import numpy as np
    import torch
    from mxtpu_torch import parallel as par
    from mxtpu_torch.parallel import collectives as col
    from mxtpu_torch.parallel import pipeline as tpipe
    cfg = PARALLEL_PIPE
    n, d = cfg["layers"], BERT_BASE["dim"]
    rng = np.random.default_rng(26)
    stacked = {"w": torch.from_numpy((rng.standard_normal((n, d, d))
                                      / np.sqrt(d)).astype(np.float32)),
               "b": torch.from_numpy((rng.standard_normal((n, d)) * 0.1)
                                     .astype(np.float32))}
    x0 = torch.from_numpy(rng.standard_normal(
        (cfg["batch"], d)).astype(np.float32)).to(dev)
    mesh = par.make_mesh({"pipe": 4})

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def leaves():
        return {k: v.to(dev, copy=True).requires_grad_()
                for k, v in stacked.items()}, x0.clone().requires_grad_()
    seq, x = leaves()
    h = x
    for i in range(n):
        h = layer({k: v[i] for k, v in seq.items()}, h)
    (h ** 2).sum().backward()
    seq_out = h.detach()
    seq_g = [v.grad for v in seq.values()] + [x.grad]
    out = {}
    for name in ("pipe", "planted", "no_copy"):
        if name == "planted":
            tpipe.reduce_from = col.psum
        if name == "no_copy":
            tpipe.copy_to = lambda t, axis: t
        mine, x = leaves()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            o = par.pipeline_apply(layer, mine, x, mesh, axis="pipe",
                                   num_microbatches=cfg["micro"])
            (o ** 2).sum().backward()
        finally:
            tpipe.reduce_from = col.reduce_from
            tpipe.copy_to = col.copy_to
        torch.cuda.synchronize()
        out[name] = dict(
            ms=1e3 * (time.perf_counter() - t0),
            out_rel=_rel_l2([o.detach()], [seq_out]),
            grad_rel=_rel_l2([v.grad for v in mine.values()] + [x.grad],
                             seq_g),
            x_rel=_rel_l2([x.grad], [seq_g[-1]]))
    return out


def _module_mesh_check(rank, world, dev):
    """``Module(context=make_mesh({"data": 4}))``: 4 SGD steps of a Dense
    MLP (768 -> 3072 -> 10, b64 global) against ``context=None`` on this
    rank's card (each step's outputs, the weights after), then with the
    gradients' sum over the data axis planted away."""
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.symbol import executor as texec
    cfg = PARALLEL_MODULE
    d, hdim, classes, b = BERT_BASE["dim"], 4 * BERT_BASE["dim"], 10, \
        cfg["batch"]
    rng = np.random.default_rng(27)
    w = {"fc1_weight": rng.standard_normal((hdim, d)) / np.sqrt(d),
         "fc1_bias": np.zeros(hdim), "fc2_bias": np.zeros(classes),
         "fc2_weight": rng.standard_normal((classes, hdim)) / np.sqrt(hdim)}
    xs = rng.standard_normal((cfg["steps"], b, d)).astype(np.float32)
    ys = rng.integers(0, classes, (cfg["steps"], b)).astype(np.float32)
    s = mt.sym
    net = s.FullyConnected(s.var("data"), s.var("fc1_weight"),
                           s.var("fc1_bias"), num_hidden=hdim, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, s.var("fc2_weight"), s.var("fc2_bias"),
                           num_hidden=classes, name="fc2")
    net = s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")
    mesh = par.make_mesh({"data": 4})
    real_sum = texec.Executor._sum_grads

    def run(context):
        mod = mt.mod.Module(net, context=context)
        mod.bind(data_shapes=[("data", (b, d))],
                 label_shapes=[("softmax_label", (b,))])
        mod.init_params(arg_params={k: mt.nd.array(v.astype(np.float32),
                                                   ctx=dev)
                                    for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        outs = []
        t0 = time.perf_counter()
        for x, y in zip(xs, ys):
            mod.forward(mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                                        label=[mt.nd.array(y, ctx=dev)]),
                        is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0]._data.detach().clone())
        torch.cuda.synchronize()
        return (outs, [v._data.detach().clone()
                       for v in mod.get_params()[0].values()],
                1e3 * (time.perf_counter() - t0))
    with (mt.gpu(dev.index or 0) if dev.type == "cuda" else mt.cpu()):
        one = run(None)
        res = {}
        for name in ("mesh", "planted"):
            if name == "planted":
                texec.Executor._sum_grads = lambda self, names, grads: grads
            try:
                got = run(mesh)
            finally:
                texec.Executor._sum_grads = real_sum
            res[name] = dict(
                ms=got[2], one_ms=one[2],
                out_err=max(float((a - b_).abs().max()) for a, b_ in
                            zip(got[0], one[0])),
                weight_rel=_rel_l2(got[1], one[1]),
                out_rows=int(got[0][0].shape[0]))
    return res


def _parallel_rank(rank, world, rdv, out_dir, backend, card_per_rank):
    """Part (b), one rank over ``backend`` on card 0 (or its own card,
    ``card_per_rank``): data-parallel Adam with ZeRO-1 on and off against
    the world of one (``_dp_check``); the sp ring's logits (flash and
    dense bodies, causal and bidirectional, f32 and bf16) against the
    unsharded model and B2's launches per layer; the ring's attention
    gradients (``_ring_attention_check``) and one step's model gradients
    (``_ring_model_check``). Writes its numbers to ``out_dir`` (the
    phase's process gates them); a rank that raises exits non-zero."""
    import json as _json
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    card = rank if card_per_rank else 0
    dev = torch.device("cuda", card)
    torch.cuda.set_device(card)
    mt.distributed.init("file://" + rdv, num_processes=world,
                        process_id=rank, backend=backend,
                        local_device_ids=[card], timeout=PARALLEL_TIMEOUT_S)
    res = {"rank": rank, "pid": os.getpid()}
    try:
        torch.ones(1, device=dev)        # this rank's context on the card
        mt.distributed.barrier()
        if rank == 0:
            res["compute_apps"] = sorted(_compute_apps())
        spent = _par_transfer_timer()
        pb = PARALLEL_B
        layers, vocab = pb["layers"], BERT_BASE["vocab_size"]
        arrays = _par_arrays(layers)
        res["dp"] = _dp_check(rank, world, par.data_parallel_mesh(), dev,
                              layers, spent)
        # sequence parallel over the ranks, the ring on B2
        sp = par.make_mesh({"sp": world})
        idx = sp.axis("sp").index
        (tok, lab), = _par_batches(pb["sp_batch"], pb["seq"], 1, 23, vocab)
        tl = pb["seq"] // world
        cols = slice(idx * tl, (idx + 1) * tl)
        full = mt.nd.array(tok, ctx=dev, dtype="int32")
        mine = mt.nd.array(tok[:, cols], ctx=dev, dtype="int32")
        res["sp"] = {}
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                whole = _par_net(layers, arrays, dev, dtype, causal=causal,
                                 hybrid=False)
                with torch.no_grad():
                    ref_logits = whole(full).asnumpy()[:, cols].astype(
                        np.float32)
                del whole
                net = _par_net(layers, arrays, dev, dtype, mesh=sp,
                               causal=causal, hybrid=False)
                for flash in (True, False):
                    par.set_ring_flash(flash)
                    start = flash_attention.launches
                    with torch.no_grad():
                        got = net(mine).asnumpy().astype(np.float32)
                    n = flash_attention.launches - start
                    scale = float(np.abs(ref_logits).max())
                    err = float(np.abs(got - ref_logits).max()) / scale
                    res["sp"]["%s causal=%d flash=%d" % (
                        dtype, causal, flash)] = dict(
                            err=err, b2_per_layer=n / layers)
                par.set_ring_flash(False)
                del net
        res["attn"] = _ring_attention_check(sp, dev, pb["sp_batch"],
                                            pb["seq"])
        res["model"] = _ring_model_check(sp, dev, layers, tok, lab, cols,
                                         world)
        # A8's second part: expert and tensor parallel, the pipeline, the
        # Module on a mesh
        t0 = time.perf_counter()
        res["ep"] = _ep_check(rank, world, dev)
        res["tp"] = _tp_check(rank, world, dev)
        res["pipe"] = _pipe_check(rank, world, dev)
        res["module"] = _module_mesh_check(rank, world, dev)
        res["a8_2_s"] = time.perf_counter() - t0
        mt.distributed.barrier()
    finally:
        with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
            _json.dump(res, f)
        mt.distributed.shutdown()


PAR_B_LOSS_TOL = 1e-4        # relative, f32 losses (summation order)
# Relative L2 limits of part (b), each between what the sound runs read on
# an H100 and what a planted fault reads (PERF.md §6):
# the summed first-step gradients: 6.6e-4-7.7e-4; no all-reduce 0.83
PAR_B_DP_GRAD_L2 = 5e-3
# each step's weight change: 0.007-0.026 (Adam's step lr m/(sqrt(v) + eps)
# near |g| ~ eps turns a rounding difference into one of order lr); a
# stale ZeRO-1 all-gather 0.54, a skipped update 1
PAR_B_STEP_L2 = 0.1
# the ring's attention alone, out and q/k/v gradients: 4.7e-7-6.3e-7;
# the lse gradient dropped 0.047-0.22
PAR_B_ATTN_L2 = 1e-5
# one step's model gradients: 2.2e-4 (flash ring), 4.5e-4 (dense), with a
# ReLU mask flip on some ranks (one flip of the 1024 x 3072 units moves
# that layer's weight gradient by ~1/sqrt(1024 * 3072)); the lse gradient
# dropped 0.22
PAR_B_MODEL_GRAD_L2 = 5e-3
SERVED_TOL = {"float32": 1e-3, "bfloat16": 5e-2}   # of max|logit|
# the pipeline against the sequential stack on the same rank (f32, the
# microbatches' matmuls round apart from the whole batch's): relative L2
PAR_B_PIPE_L2 = 1e-5
# the Module on the mesh against one device: each step's outputs (max
# abs, probabilities) and the weights after (relative L2)
PAR_B_MODULE_TOL = 1e-5


def _gate(ok, what):
    if not ok:
        raise AssertionError("parallel (b) " + what)


def _gate_part_b(r, res):
    """Print rank ``r``'s numbers and gate them; every planted fault must
    fail the gate it plants into."""
    for zero in (0, 1):
        d = res["dp"]["z%d" % zero]
        print("parallel (b) rank %d data-parallel Adam ZeRO-1 %s: step ms "
              "%s, transfer ms a step %.1f, loss err %.3g; first step's "
              "summed gradients %.3g relative L2 (limit %g; planted no "
              "all-reduce %.3g); each step's weight change %s (limit %g%s)"
              " against the world of one; %d parameters row-sharded" % (
                  r, bool(zero), ["%.1f" % m for m in d["step_ms"]],
                  d["transfer_ms"], d["loss_err"], d["grad_rel"],
                  PAR_B_DP_GRAD_L2, d["planted_no_sum"],
                  ["%.3g" % x for x in d["step_rel"]], PAR_B_STEP_L2,
                  "; planted stale all-gather %.3g"
                  % d["planted_stale_gather"] if zero else "",
                  d["sharded"]), flush=True)
        _gate(d["loss_err"] <= PAR_B_LOSS_TOL * max(abs(x) for x in
                                                    d["losses"]),
              "rank %d ZeRO-1 %s: losses" % (r, zero))
        _gate(d["grad_rel"] <= PAR_B_DP_GRAD_L2 < d["planted_no_sum"],
              "rank %d ZeRO-1 %s: summed gradients" % (r, zero))
        _gate(max(d["step_rel"]) <= PAR_B_STEP_L2,
              "rank %d ZeRO-1 %s: weight changes" % (r, zero))
        _gate(not zero or d["sharded"] and
              d["planted_stale_gather"] > PAR_B_STEP_L2,
              "rank %d: a stale all-gather would pass" % r)
    z = res["dp"]["zero_on_off"]
    print("parallel (b) rank %d ZeRO-1 on against off: summed gradients %d "
          "elements beyond twice gamma_3 sum_r |g_r| (worst %.3g of it); "
          "each step's weight change %s relative L2; first step's weights "
          "%.3g apart at worst, where the world of one's gradient is %.3g "
          "(Adam's eps 1e-8); a share %.3g of the weights beyond 1e-6, "
          "their median |gradient| %.3g against %.3g over all" % (
              r, z["grad_excess"], z["grad_worst_of_bound"],
              ["%.3g" % x for x in z["step_rel"]], z["weight_err"],
              z["grad_at_worst"], z["share_beyond_1e6"],
              z["median_grad_beyond_1e6"], z["median_grad"]), flush=True)
    _gate(z["grad_excess"] == 0, "rank %d: ZeRO-1 on against off beyond "
          "the summation-order bound" % r)
    _gate(max(z["step_rel"]) <= PAR_B_STEP_L2,
          "rank %d: ZeRO-1 on against off, weight changes" % r)
    for key, v in sorted(res["sp"].items()):
        causal = "causal=1" in key
        want = (1 + r if causal else PARALLEL_RANKS) if "flash=1" in key \
            else 0
        tol = SERVED_TOL[key.split()[0]]
        print("parallel (b) rank %d sp %d %s: logits err %.3g of max|logit| "
              "(tolerance %g), B2 launches a layer %g (expected %d)" % (
                  r, PARALLEL_RANKS, key, v["err"], tol, v["b2_per_layer"],
                  want))
        _gate(v["err"] <= tol and v["b2_per_layer"] == want,
              "rank %d sp %s" % (r, key))
    for key, a in sorted(res["attn"].items()):
        planted = a["planted: flash, lse gradient dropped"]
        print("parallel (b) rank %d ring attention %s f32 [%d, 12, %d, 64] "
              "against the whole sequence's B2 (out, dq, dk, dv; worst "
              "relative L2): flash ring %.3g, dense ring %.3g (limit %g), "
              "planted lse gradient dropped %.3g; B2's lse against its "
              "plain version's %.3g, out %.3g relative L2, the backward "
              "fed B2's out/lse against fed the plain version's %.3g" % (
                  r, key, PARALLEL_B["sp_batch"], PARALLEL_B["seq"],
                  a["flash"], a["dense"], PAR_B_ATTN_L2, planted,
                  a["lse_err"], a["out_rel"], a["bwd_fed_rel"]), flush=True)
        _gate(max(a["flash"], a["dense"]) <= PAR_B_ATTN_L2 < planted,
              "rank %d ring attention %s" % (r, key))
    m = res["model"]
    for name in ("again", "flash", "dense", "planted"):
        v = m[name]
        print("parallel (b) rank %d one step's gradients, %s against the "
              "whole model: relative L2 %.3g over all (limit %g), worst "
              "parameter %.3g (%s); ReLU mask flips %d of %d units" % (
                  r, {"again": "the whole model again",
                      "flash": "flash ring", "dense": "dense ring",
                      "planted": "planted: flash ring, lse gradient "
                      "dropped,"}[name], v["rel_l2"], PAR_B_MODEL_GRAD_L2,
                  v["worst"], v["worst_param"], v["relu_flips"],
                  m["units"]), flush=True)
    _gate(max(m["flash"]["rel_l2"], m["dense"]["rel_l2"])
          <= PAR_B_MODEL_GRAD_L2 < m["planted"]["rel_l2"],
          "rank %d one step's gradients" % r)
    _gate_a8_2(r, res)


def _gate_a8_2(r, res):
    """Print and gate rank ``r``'s numbers of A8's second part; every
    planted fault must fail the gate it plants into."""
    ep, planted = res["ep"]["ep"], res["ep"]["planted"]
    print("parallel (b) rank %d expert parallel data 2 x expert 2 (2-layer "
          "f32 MoE, %d experts, b%d x %d global, Adam): first step's "
          "summed gradients %.3g relative L2 against the world of one "
          "(router %.3g; limit %g; planted psum for reduce_from %.3g), "
          "loss %.6f vs %.6f, aux %.6f vs %.6f, %d parameters sharded to "
          "%s experts a rank, %.0f ms" % (
              r, MOE_EXPERTS, PARALLEL_EP["batch"], PARALLEL_B["seq"],
              ep["grad_rel"], ep["router_rel"], PAR_B_DP_GRAD_L2,
              planted["grad_rel"], ep["loss"], ep["ref_loss"], ep["aux"],
              ep["ref_aux"], ep["sharded"], ep["shard_rows"], ep["ms"]),
          flush=True)
    _gate(ep["grad_rel"] <= PAR_B_DP_GRAD_L2 < planted["grad_rel"]
          and abs(ep["loss"] - ep["ref_loss"])
          <= PAR_B_LOSS_TOL * abs(ep["ref_loss"])
          and abs(ep["aux"] - ep["ref_aux"])
          <= PAR_B_LOSS_TOL * abs(ep["ref_aux"])
          and ep["shard_rows"] == [MOE_EXPERTS // 2]
          and ep["sharded"] == 4 * PARALLEL_B["layers"],
          "rank %d expert parallel" % r)
    tp, planted = res["tp"]["tp"], res["tp"]["planted"]
    halves = all(2 * mine == whole for _, mine, whole in tp["bytes"])
    print("parallel (b) rank %d tensor parallel data 2 x model 2 (2-layer "
          "f32, SGD lr %g, %d steps): losses %s against replicated %s "
          "(worst %.3g), first step's summed gradients %.3g relative L2 "
          "(limit %g; planted sum over model %.3g); %d weights sharded, "
          "each at half its bytes on this rank %s (%.1f of %.1f MB); "
          "%.0f ms (replicated %.0f)" % (
              r, PARALLEL_TP["lr"], PARALLEL_TP["steps"],
              ["%.6f" % x for x in tp["losses"]],
              ["%.6f" % x for x in res["tp"]["repl"]["losses"]],
              tp["loss_err"], tp["grad_rel"], PAR_B_DP_GRAD_L2,
              planted["grad_rel"], len(tp["bytes"]), halves,
              sum(m for _, m, _ in tp["bytes"]) / 1e6,
              sum(w for _, _, w in tp["bytes"]) / 1e6, tp["ms"],
              res["tp"]["repl"]["ms"]), flush=True)
    _gate(tp["loss_err"] <= PAR_B_LOSS_TOL * max(tp["losses"])
          and tp["grad_rel"] <= PAR_B_DP_GRAD_L2 < planted["grad_rel"]
          and halves and len(tp["bytes"]) >= 4 * PARALLEL_B["layers"],
          "rank %d tensor parallel" % r)
    pp, planted = res["pipe"]["pipe"], res["pipe"]["planted"]
    no_copy = res["pipe"]["no_copy"]
    print("parallel (b) rank %d pipeline pipe 4 (%d layers tanh(h @ w + b) "
          "at d %d, %d rows in %d microbatches): output %.3g, the whole "
          "stack's and the input's gradients %.3g (the input's %.3g) "
          "relative L2 against the sequential stack (limit %g; planted psum "
          "for reduce_from %.3g, copy_to planted away %.3g), %.0f ms" % (
              r, PARALLEL_PIPE["layers"], BERT_BASE["dim"],
              PARALLEL_PIPE["batch"], PARALLEL_PIPE["micro"], pp["out_rel"],
              pp["grad_rel"], pp["x_rel"], PAR_B_PIPE_L2,
              planted["grad_rel"], no_copy["grad_rel"], pp["ms"]),
          flush=True)
    _gate(max(pp["out_rel"], pp["grad_rel"]) <= PAR_B_PIPE_L2
          < min(planted["grad_rel"], no_copy["grad_rel"]),
          "rank %d pipeline" % r)
    mo, planted = res["module"]["mesh"], res["module"]["planted"]
    print("parallel (b) rank %d Module on make_mesh({'data': 4}) (%d SGD "
          "steps, b%d global): outputs %.3g max abs (%d rows gathered), "
          "weights %.3g relative L2 against context=None (limit %g; "
          "planted no sum over the data axis %.3g), %.0f ms (one device "
          "%.0f)" % (r, PARALLEL_MODULE["steps"], PARALLEL_MODULE["batch"],
                     mo["out_err"], mo["out_rows"], mo["weight_rel"],
                     PAR_B_MODULE_TOL, planted["weight_rel"], mo["ms"],
                     mo["one_ms"]), flush=True)
    _gate(mo["out_err"] <= PAR_B_MODULE_TOL and mo["weight_rel"]
          <= PAR_B_MODULE_TOL < planted["weight_rel"]
          and mo["out_rows"] == PARALLEL_MODULE["batch"],
          "rank %d Module on a mesh" % r)
    print("parallel (b) rank %d A8's second part %.1f s" % (r, res["a8_2_s"]),
          flush=True)


def parallel_four_ranks(card, backend="gloo", card_per_rank=False):
    """Part (b): ``PARALLEL_RANKS`` ranks spawned over ``backend`` on the
    one card (or one card each, ``card_per_rank``), a ``spawn`` context,
    a ``file://`` rendezvous under build/, a timeout on every join; at
    BERT-base widths with ``PARALLEL_B["layers"]`` layers. A rank that
    fails fails the phase. Returns each rank's numbers."""
    import multiprocessing
    t_part = time.time()
    out_dir = os.path.join(ROOT, "build", "par_b")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    rdv = os.path.join(out_dir, "rdv")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, PARALLEL_RANKS, rdv, out_dir, backend,
                               card_per_rank))
             for r in range(PARALLEL_RANKS)]
    for p in procs:
        p.start()
    deadline = time.time() + PARALLEL_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    results = []
    for r in range(PARALLEL_RANKS):
        path = os.path.join(out_dir, "rank%d.json" % r)
        results.append(json.load(open(path)) if os.path.exists(path)
                       else {})
    if any(codes):
        raise AssertionError("parallel (b): rank exit codes %s" % codes)
    apps = results[0].get("compute_apps", [])
    pids = sorted(r["pid"] for r in results)
    print("parallel (b): %d %s ranks on %s (%s); nvidia-smi compute apps "
          "%s (rank pids %s)" % (
              PARALLEL_RANKS, backend, card,
              "a card each" if card_per_rank else "all on card 0", apps,
              pids), flush=True)
    for r, res in enumerate(results):
        _gate_part_b(r, res)
    print("parallel (b) %.1f s" % (time.time() - t_part), flush=True)
    return results


RING_BLOCKS = (2, 16)   # batch of the ring's blocks [b, 12, 512 / 4, 64]


def ring_block_timing(card):
    """B2 at the ring's block shape ``[b, 12, 128, 64]`` (sequence 512 over
    four ranks), non-causal as each past block runs and causal as the
    diagonal one: held against its plain version, timed eagerly and by
    graph replay beside sdpa at the same shape, with its bound."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.flash_attention import (
        flash_attention_reference, flash_attention_with_lse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rows = []
    t = PARALLEL_SEQ // PARALLEL_RANKS
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for b in RING_BLOCKS:
            for causal in (False, True):
                q, k, v = flash_inputs(b, 12, t, t, 64, dt, "contig", gen)
                out, lse = flash_attention_with_lse(q, k, v, causal)
                r_out, _ = flash_attention_reference(q.float(), k.float(),
                                                     v.float(), causal)
                err = check(out, r_out, dtype, "ring block b%d" % b)
                kern = lambda: flash_attention_with_lse(q, k, v, causal)
                sdpa = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)
                n_bytes = 4 * q.numel() * q.element_size() + 4 * lse.numel()
                flops = 4.0 * b * 12 * t * t * 64 * (0.5 if causal else 1.0)
                bms, by = bound_ms(n_bytes, flops, dtype)
                row = dict(shape="[%d, 12, %d, 64]%s" % (b, t, " causal"
                                                        * causal),
                           dtype=dtype, max_abs_err=err, ms=cuda_ms(kern),
                           library_ms=cuda_ms(sdpa),
                           plain_ms=cuda_ms(lambda: flash_attention_reference(
                               q, k, v, causal)),
                           graph_ms=graph_ms(kern),
                           library_graph_ms=graph_ms(sdpa), bound_ms=bms,
                           bound_by=by)
                rows.append(row)
                print("ring block %s %s on %s: err %.3g; eager kernel %.4f ms"
                      "  sdpa %.4f  plain %.4f; graph replay kernel %.4f ms  "
                      "sdpa %.4f (kernel/sdpa %.3f); bound %.4f ms (%s)" % (
                          row["shape"], dtype, card, err, row["ms"],
                          row["library_ms"], row["plain_ms"],
                          row["graph_ms"], row["library_graph_ms"],
                          row["graph_ms"] / row["library_graph_ms"], bms,
                          by), flush=True)
    return rows


def parallel_four_cards(card):
    """Part (b) on a machine of four cards, one NCCL rank a card
    (``python3 chip_smoke.py parallel_four_cards``): the world of one's
    reference steps in this process, then the four ranks, every gate of
    part (b) as on one card."""
    import mxtpu_torch as mt
    from mxtpu_torch import kernels
    from mxtpu_torch import parallel as par
    t0 = time.time()
    print("built %s in %.1f s" % (kernels.build_all(), time.time() - t0),
          flush=True)
    rdv = os.path.join(ROOT, "build", "par4_rdv")
    if os.path.exists(rdv):
        os.remove(rdv)
    mt.distributed.init("file://" + rdv, num_processes=1, process_id=0,
                        backend="nccl", timeout=PARALLEL_TIMEOUT_S)
    try:
        parallel_b_reference(par.data_parallel_mesh())
    finally:
        mt.distributed.shutdown()
    return parallel_four_ranks(card, backend="nccl", card_per_rank=True)


def parallel_phase(card):
    """The multi-device slice (ROADMAP A8's first part, module docstring
    item 15): B2 at the ring's block shape, (a) a world of one NCCL rank,
    (b) four gloo ranks on the one card. Returns (part (a)'s rows, part
    (b)'s per-rank results, the block rows)."""
    t_phase = time.time()
    blocks = ring_block_timing(card)
    rows = parallel_world_of_one(card)
    results = parallel_four_ranks(card)
    print("parallel phase %.1f s" % (time.time() - t_phase), flush=True)
    return rows, results, blocks


# ------------------------------------- slice 14: the Switch mixture of experts
MOE_FFN = (8192, 768, 3072, MOE_EXPERTS)   # T (b16 x 512), D, H, E
MOE_FFN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of max|out|
MOE_AUX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # relative
# tokens whose own route on the CPU differs from the card's in a block:
# their share, and the widest gap of the CPU's probabilities (its own
# expert's less the card's) that a rounding difference may tip
MOE_FLIP_SHARE = 0.05
MOE_TIE_GAP = 0.05
MOE_SERVE_BATCH = 8
MOE_TRAIN_BATCH = 16


def _queue_ranks(expert, e):
    """Each token's position in its expert's queue from a stable sort (an
    independent count of what ``moe.slots`` computes)."""
    import torch
    t = expert.shape[0]
    order = torch.sort(expert, stable=True).indices
    counts = torch.bincount(expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty(t, dtype=torch.long, device=expert.device)
    ranks[order] = torch.arange(t, device=expert.device) - \
        starts[expert[order]]
    return ranks


def _aux_by_count(x, router_w):
    """The Switch aux loss counted apart from ``moe``'s routing: E times
    the sum over experts of the share of tokens whose float32 softmax
    peaks there (a bincount) times the mean probability."""
    import torch
    probs = torch.softmax((x @ router_w).float(), -1)
    t, e = probs.shape
    share = torch.bincount(probs.argmax(-1), minlength=e).double() / t
    return float(e * (share * probs.double().mean(0)).sum())


def moe_ffn_check(card):
    """``switch_ffn`` on the card against ``switch_ffn_reference`` (the
    dense (T, E, C) einsums) at T 8192, D 768, H 3072, E 8, f32 and bf16
    at the capacity factor 1.25, and f32 at 0.5 (where tokens drop): the
    slots against a stable sort's queue positions (equal), the dropped
    tokens (equal, and those whose position passes the capacity), the
    outputs within ``MOE_FFN_TOL`` of max|out| and the aux loss against
    a count of its own (``_aux_by_count``); slots halved (planted: two tokens to one slot, the reference's bfloat16
    defect) must fail. Timed by CUDA events beside the dense
    formulation, with the bound of the experts' work."""
    import torch
    from mxtpu_torch.parallel import moe as tmoe
    t, d, h, e = MOE_FFN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rows = []
    for dtype, cf in (("float32", MOE["capacity_factor"]), ("float32", 0.5),
                      ("bfloat16", MOE["capacity_factor"])):
        dt = getattr(torch, dtype)
        cap = tmoe.capacity(t, e, cf)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * scale).to(dt)
        args = (rnd(t, d), rnd(d, e, scale=d ** -0.5),
                rnd(e, d, h, scale=d ** -0.5), rnd(e, h, scale=0.1),
                rnd(e, h, d, scale=h ** -0.5), rnd(e, d, scale=0.1))
        out, aux = tmoe.switch_ffn(*args, cf)
        ref, _ = tmoe.switch_ffn_reference(*args, cf)
        expert = tmoe._route(args[0], args[1])[2]
        queue = _queue_ranks(expert, e)
        slots_equal = torch.equal(tmoe.slots(expert, e).long(), queue)
        dropped = out.abs().sum(1) == 0
        dropped_equal = torch.equal(dropped, ref.abs().sum(1) == 0) and \
            torch.equal(dropped, queue >= cap)
        scale = float(ref.float().abs().max())
        err = float((out.float() - ref.float()).abs().max()) / scale
        ind_aux = _aux_by_count(args[0], args[1])
        aux_err = abs(float(aux) - ind_aux) / ind_aux
        real = tmoe.slots
        tmoe.slots = lambda ex, n: real(ex, n) // 2
        try:
            bad, _ = tmoe.switch_ffn(*args, cf)
        finally:
            tmoe.slots = real
        planted = float((bad.float() - ref.float()).abs().max()) / scale
        ok = slots_equal and dropped_equal and \
            err <= MOE_FFN_TOL[dtype] < planted and \
            aux_err <= MOE_AUX_TOL[dtype] and bool(torch.isfinite(out).all())
        row = dict(dtype=dtype, capacity_factor=cf, err=err, planted=planted,
                   aux_err=aux_err, dropped=int(dropped.sum()), cap=cap,
                   max_queue=int(torch.bincount(expert, minlength=e).max()))
        timing = ""
        if cf == MOE["capacity_factor"]:
            main = lambda: tmoe.switch_ffn(*args, cf)
            dense = lambda: tmoe.switch_ffn_reference(*args, cf)
            size = args[0].element_size()
            n_bytes = size * (sum(a.numel() for a in args) + out.numel())
            flops = 2.0 * t * d * e + 4.0 * e * cap * d * h
            bms, by = bound_ms(n_bytes, flops, dtype)
            row.update(ms=cuda_ms(main, launches=5),
                       dense_ms=cuda_ms(dense, launches=5), bound_ms=bms,
                       bound_by=by)
            timing = "; main path %.3f ms, dense (T, E, C) einsums %.3f " \
                "ms, bound %.4f ms (%s)" % (row["ms"], row["dense_ms"], bms,
                                            by)
        rows.append(row)
        print("moe switch_ffn %s capacity factor %g T %d D %d H %d E %d "
              "(cap %d, longest queue %d, %d dropped) on %s: slots equal a "
              "stable sort's queue positions %s, dropped tokens equal %s, "
              "out err %.3g of max|out| (limit %g; planted two tokens a slot "
              "%.3g), aux err %.3g%s" % (
                  dtype, cf, t, d, h, e, cap, row["max_queue"],
                  row["dropped"], card, slots_equal, dropped_equal, err,
                  MOE_FFN_TOL[dtype], planted, aux_err, timing), flush=True)
        if not ok:
            raise AssertionError("moe switch_ffn %s: the main path "
                                 "disagrees with the dense formulation, "
                                 "or a planted fault passes" % dtype)
        del args, out, ref, bad
    return rows


def _routes(net, x, forced=None):
    """The logits of ``net`` on ``x`` (no gradient), each token's expert
    in every MoE block (tokens, blocks), the same with -1 where the token
    is dropped, and each block's router probabilities (tokens, blocks,
    experts), recorded by forward hooks that route the block's input as
    ``switch_ffn`` does. ``forced``: experts (tokens, blocks) that the
    blocks take instead of their own argmax (each gate the probability of
    the forced expert); the recorded ones stay the block's own."""
    import torch
    from mxtpu_torch.parallel import moe as tmoe
    route = tmoe._route
    seen, raw, probs_seen = [], [], []

    def hook(layer, inp, out):
        t = inp[0].reshape(-1, inp[0].shape[-1])
        probs, _, expert = route(t, layer.router.data()._data)
        cap = tmoe.capacity(t.shape[0], MOE_EXPERTS, MOE["capacity_factor"])
        kept = tmoe.slots(expert, MOE_EXPERTS) < cap
        seen.append(torch.where(kept, expert, -1).cpu())
        raw.append(expert.cpu())
        probs_seen.append(probs.float().cpu())

    def take(t, router_w):
        probs = route(t, router_w)[0]
        expert = forced[:, len(seen)].to(probs.device)
        return probs, probs.gather(1, expert[:, None])[:, 0], expert
    hooks = [blk.moe.register_forward_hook(hook) for blk in net.blocks]
    if forced is not None:
        tmoe._route = take
    try:
        with torch.no_grad():
            logits = net(x).float().cpu()
    finally:
        tmoe._route = route
        for h in hooks:
            h.detach()
    return logits, torch.stack(raw, 1), torch.stack(seen, 1), \
        torch.stack(probs_seen, 1)


def _second_best_every(k):
    """A routing fault to plant: ``moe._route`` that sends every k-th
    token to its second-best expert."""
    import torch
    from mxtpu_torch.parallel import moe as tmoe
    real = tmoe._route

    def planted(t, router_w):
        probs, gate, expert = real(t, router_w)
        top2 = probs.topk(2, dim=-1)
        hit = torch.arange(t.shape[0], device=t.device) % k == 0
        return (probs, torch.where(hit, top2.values[:, 1], gate),
                torch.where(hit, top2.indices[:, 1], expert))
    return planted


def _route_flips(card_experts, cpu_experts, cpu_probs):
    """(share of tokens whose own route on the CPU differs from the
    card's in some block, the widest gap of such a difference, the count
    of differences wider than ``MOE_TIE_GAP``). A gap is the CPU's
    probability of its own expert less that of the card's: a near-tie
    rounds either way, a wrong route leaves a wide gap."""
    differ = cpu_experts != card_experts
    gap = cpu_probs.max(-1).values - cpu_probs.gather(
        -1, card_experts[..., None])[..., 0]
    gaps = gap[differ]
    return (float(differ.any(1).float().mean()),
            float(gaps.max()) if gaps.numel() else 0.0,
            int((gaps > MOE_TIE_GAP).sum()))


def moe_lockstep(card):
    """The 2-layer MoE TransformerLM at full width (8 experts), b2 x 512,
    on the card against the same model on the CPU, the CPU's blocks taking
    the card's routes: the logits within ``SERVED_TOL`` of max|logit|
    (two tokens to one slot, planted, must fail that gate); the routes:
    where the CPU's own route of a token differs from the card's, the
    CPU's probabilities must be a near-tie, within ``MOE_TIE_GAP`` (in
    bf16 the probabilities near 1/8 are 2^-10 apart, and a rounding
    difference tips a near-tie either way), and such tokens at most
    ``MOE_FLIP_SHARE``; in bf16 a planted routing fault (every 64th token
    to its second-best expert on the card) must fail that gate; the aux
    loss, in f32 and bf16. Then one training step of CE + 0.01 aux in f32
    on both devices' own routes, its gradients (every parameter's, and
    the routers' alone) within ``TRAIN_L2`` relative L2."""
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.parallel import moe as tmoe
    vocab = BERT_BASE["vocab_size"]
    arrays = _par_arrays(2, MOE_EXPERTS)
    (tok, lab), = _par_batches(2, 512, 1, 41, vocab)
    out = {}
    for dtype in ("float32", "bfloat16"):
        nets = {where: _par_net(2, arrays, torch.device(where), dtype,
                                hybrid=False, experts=MOE_EXPERTS)
                for where in ("cuda", "cpu")}
        logits, experts, routes, _ = _routes(
            nets["cuda"], torch.from_numpy(tok).to("cuda"))
        aux = float(nets["cuda"].aux_loss())
        ref, cpu_experts, cpu_routes, cpu_probs = _routes(
            nets["cpu"], torch.from_numpy(tok), forced=experts)
        ref_aux = float(nets["cpu"].aux_loss())
        real = tmoe.slots
        tmoe.slots = lambda ex, n: real(ex, n) // 2
        try:
            bad = _routes(nets["cuda"], torch.from_numpy(tok).to("cuda"))[0]
        finally:
            tmoe.slots = real
        scale = float(ref.abs().max())
        err = float((logits - ref).abs().max()) / scale
        planted = float((bad - ref).abs().max()) / scale
        flips, gap, wide = _route_flips(experts, cpu_experts, cpu_probs)
        routes_ok = wide == 0 and flips <= MOE_FLIP_SHARE
        aux_err = abs(aux - ref_aux) / abs(ref_aux)
        row = dict(err=err, planted=planted, aux=aux, aux_err=aux_err,
                   flip_share=flips, flip_gap=gap, wide=wide)
        extra = ""
        if dtype == "bfloat16":
            route = tmoe._route
            tmoe._route = _second_best_every(64)
            try:
                p_experts = _routes(nets["cuda"],
                                    torch.from_numpy(tok).to("cuda"))[1]
            finally:
                tmoe._route = route
            _, p_cpu, _, p_probs = _routes(nets["cpu"], torch.from_numpy(tok),
                                           forced=p_experts)
            p_flips, p_gap, p_wide = _route_flips(p_experts, p_cpu, p_probs)
            row.update(planted_flip_share=p_flips, planted_gap=p_gap,
                       planted_wide=p_wide)
            routes_ok = routes_ok and (p_wide > 0
                                       or p_flips > MOE_FLIP_SHARE)
            extra = "; planted every 64th token to its second-best " \
                "expert: a share %.4g, widest gap %.4g, %d wider than " \
                "the limit" % (p_flips, p_gap, p_wide)
        if dtype == "float32":
            grads = {}
            for where, net in nets.items():
                dev = torch.device(where)
                x = mt.nd.array(tok, ctx=dev, dtype="int32")
                y = mt.nd.array(lab, ctx=dev)
                with mt.autograd.record():
                    loss = _moe_forward(vocab)(net, x, y).mean()
                loss.backward()
                grads[where] = [(n, p.grad()._data.detach().cpu())
                                for n, p in net.collect_params().items()]
            card_g = [g for _, g in grads["cuda"]]
            cpu_g = [g for _, g in grads["cpu"]]
            routers = [i for i, (n, _) in enumerate(grads["cuda"])
                       if n.endswith("moe_router")]
            row.update(grad_rel=_rel_l2(card_g, cpu_g),
                       router_rel=_rel_l2([card_g[i] for i in routers],
                                          [cpu_g[i] for i in routers]))
            extra = "; one CE + %g aux step's gradients %.3g relative L2, " \
                "the routers' %.3g (limit %g)" % (
                    MOE_ALPHA, row["grad_rel"], row["router_rel"], TRAIN_L2)
        out[dtype] = row
        print("moe lockstep 2-layer MoE LM (8 experts, BERT-base widths) %s "
              "b2 x 512 on %s against the CPU on the card's routes: logits "
              "err %.3g of max|logit| (limit %g; planted two tokens a slot "
              "%.3g), a share %.4g of the tokens the CPU routes otherwise in "
              "a block (limit %g), their widest probability gap %.4g (limit "
              "%g, %d wider), aux %.6f (rel err %.3g)%s" % (
                  dtype, card, err, SERVED_TOL[dtype], planted, flips,
                  MOE_FLIP_SHARE, gap, MOE_TIE_GAP, wide, row["aux"],
                  aux_err, extra), flush=True)
        ok = err <= SERVED_TOL[dtype] < planted and routes_ok and \
            aux_err <= MOE_AUX_TOL[dtype]
        if dtype == "float32":
            ok = ok and max(row["grad_rel"], row["router_rel"]) <= TRAIN_L2
        if not ok:
            raise AssertionError("moe lockstep %s: the card disagrees with "
                                 "the CPU, or a planted fault passes"
                                 % dtype)
        del nets
    return out


def moe_flops_per_step(b, t, layers):
    """FLOPs of one training step of the MoE LM (3 x the forward's): per
    token the attention's projections and its scores and values, the
    router and the head, per layer the experts over the E x C slots they
    compute (each slot of capacity runs, taken or not)."""
    from mxtpu_torch.parallel.moe import capacity
    d, v = BERT_BASE["dim"], BERT_BASE["vocab_size"]
    tokens = b * t
    cap = capacity(tokens, MOE_EXPERTS, MOE["capacity_factor"])
    per_token = layers * (2 * 4 * d * d + 2 * 2 * t * d
                          + 2 * d * MOE_EXPERTS) + 2 * d * v
    experts = layers * 2 * 2 * MOE_EXPERTS * cap * d * (4 * d)
    return 3.0 * (tokens * per_token + experts)


def moe_b2_timing(card):
    """B2 at the trained MoE LM's attention shape ``[16, 12, 512, 64]``
    bf16 on the served q/k/v views, held against its plain version, by
    graph replay beside sdpa at the same shape, with its bound."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.flash_attention import (
        flash_attention_reference, flash_attention_with_lse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, h, t, d = MOE_TRAIN_BATCH, 12, 512, 64
    q, k, v = flash_inputs(b, h, t, t, d, torch.bfloat16, "qkv", gen)
    out, lse = flash_attention_with_lse(q, k, v, False)
    r_out, _ = flash_attention_reference(q.float(), k.float(), v.float(),
                                         False)
    err = check(out, r_out, "bfloat16", "moe B2 [16, 12, 512, 64]")
    kern = lambda: flash_attention_with_lse(q, k, v, False)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
    n_bytes = 4 * q.numel() * q.element_size() + 4 * lse.numel()
    bms, by = bound_ms(n_bytes, 4.0 * b * h * t * t * d, "bfloat16")
    row = dict(shape="[%d, %d, %d, %d]" % (b, h, t, d), max_abs_err=err,
               graph_ms=graph_ms(kern), library_graph_ms=graph_ms(sdpa),
               bound_ms=bms, bound_by=by)
    print("moe B2 %s bf16 qkv views on %s: err %.3g; graph replay kernel "
          "%.4f ms  sdpa %.4f (kernel/sdpa %.3f); bound %.4f ms (%s)" % (
              row["shape"], card, err, row["graph_ms"],
              row["library_graph_ms"],
              row["graph_ms"] / row["library_graph_ms"], bms, by),
          flush=True)
    return row


def moe_serve(card, arrays):
    """The 12-layer bf16 MoE LM served by a Predictor with one captured
    bucket of b8 x 512: one graph, finite logits of the right shape, the
    replay against the eager forward on the card, B2's launches a forward
    (12); closed-loop median and p80 ms, tokens/s, host issue, device ms
    and idle share."""
    import numpy as np
    import torch
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    from mxtpu_torch.serving import BucketSpec, Predictor
    layers, b, t = BERT_BASE["num_layers"], MOE_SERVE_BATCH, 512
    net = _par_net(layers, arrays, torch.device("cuda"), "bfloat16",
                   hybrid=False, experts=MOE_EXPERTS)
    spec = BucketSpec(batch_sizes=[b], seq_lens=[t])
    t0 = time.time()
    pred = Predictor(net, spec, example=torch.zeros(1, t, dtype=torch.int32),
                     warmup=True, device="cuda",
                     site="serving.predict.moe_lm.bfloat16")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    graphs = check_graphs(pred, spec, "moe_lm bfloat16")
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.integers(0, BERT_BASE["vocab_size"], (b, t),
                                      dtype=np.int32)).to("cuda")
    flash_attention.launches = 0
    logits = pred.predict(x).to_torch()
    torch.cuda.synchronize()
    per_fwd = flash_attention.launches
    if tuple(logits.shape) != (b, t, BERT_BASE["vocab_size"]) or \
            not bool(torch.isfinite(logits.float()).all()) or \
            per_fwd != layers:
        raise AssertionError("moe serve: logits %s (finite %s), B2 "
                             "launches a forward %d (expected %d)" % (
                                 tuple(logits.shape),
                                 bool(torch.isfinite(logits.float()).all()),
                                 per_fwd, layers))
    diff = replay_vs_eager(pred, x, "moe_lm bfloat16")
    med, p80, issue = closed_loop(pred, x)
    rows = device_rows(lambda: pred.predict(x), 3)
    dev_ms = sum(r[1] for r in rows)
    check_graphs(pred, spec, "moe_lm bfloat16 after traffic")
    res = dict(median_ms=med, p80_ms=p80, issue_ms=issue,
               tokens_per_s=b * t * 1e3 / med, device_ms=dev_ms,
               idle=1 - dev_ms / med, graphs=graphs, b2_per_forward=per_fwd,
               warmup_s=warm_s, replay_vs_eager=diff)
    print("serve moe_lm (12 layers, 8 experts, BERT-base widths) bf16 b%d "
          "x %d on %s: %d captured graph (warm-up %.1f s), %.1f tokens/s "
          "at the median %.3f ms (p80 %.3f, median host issue %.3f ms; 50 "
          "requests), device kernels %.3f ms (idle share %.3f), B2 "
          "launches a forward %d, replay vs eager max abs diff %.3g" % (
              b, t, card, graphs, warm_s, res["tokens_per_s"], med, p80,
              issue, dev_ms, res["idle"], per_fwd, diff), flush=True)
    print_breakdown("serve moe_lm bf16 b%d x %d graph" % (b, t), rows, med,
                    "flash_attention_", layers)
    del pred, net
    return res


def moe_train(card, arrays):
    """The 12-layer bf16 MoE LM trained through ``ShardedTrainStep(
    data_parallel_mesh(), forward=CE + 0.01 aux)`` in a world of one NCCL
    rank, Adam lr 1e-4, b16 x 512 (hybridized: each step replays a
    captured pair whose second output is the aux loss): median and p80
    ms of 10 steps after 3, tokens/s, train_mfu (the experts counted over
    the E x C slots they compute), idle share, peak GiB, builds after the
    warm-up (0), B2 a forward (12) and the profiler's breakdown."""
    import gc
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    layers, b, t = BERT_BASE["num_layers"], MOE_TRAIN_BATCH, 512
    vocab = BERT_BASE["vocab_size"]
    rdv = os.path.join(ROOT, "build", "moe_rdv")
    if os.path.exists(rdv):
        os.remove(rdv)
    mt.distributed.init("file://" + rdv, num_processes=1, process_id=0,
                        backend="nccl", timeout=PARALLEL_TIMEOUT_S)
    try:
        dev = torch.device("cuda", 0)
        net = _par_net(layers, arrays, dev, "bfloat16", experts=MOE_EXPERTS)
        st = par.ShardedTrainStep(net, None, par.data_parallel_mesh(),
                                  optimizer="adam",
                                  optimizer_params={"learning_rate": ADAM_LR},
                                  forward=_moe_forward(vocab))
        (tok, lab), = _par_batches(b, t, 1, 43, vocab)
        x = mt.nd.array(tok, ctx=dev, dtype="int32")
        y = mt.nd.array(lab, ctx=dev)
        losses = [float(st(x, y).asnumpy()) for _ in range(2)]
        start = flash_attention.launches
        st(x, y)
        torch.cuda.synchronize()
        per_fwd = flash_attention.launches - start
        aux = float(net.aux_loss().asnumpy())
        torch.cuda.reset_peak_memory_stats()
        warm = {}

        def on_warm():
            warm.update(_builds())
        med, p80, issue = timed_steps(lambda: st(x, y), on_warm=on_warm)
        built = {k: v - warm[k] for k, v in _builds().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = b * t * 1e3 / med
        flops = moe_flops_per_step(b, t, layers)
        ok = per_fwd == layers and not any(built.values()) and \
            all(x_ == x_ for x_ in losses) and aux == aux
        print("train moe_lm (12 layers, 8 experts, BERT-base widths) bf16 "
              "b%d x %d ShardedTrainStep(data_parallel_mesh()) Adam on %s: "
              "%.1f tokens/s at the median %.3f ms (p80 %.3f, median host "
              "issue %.3f ms; 10 after 3), peak %.2f GiB, builds after the "
              "warm-up %s, B2 launches a forward %d, losses %s, aux %.4f; "
              "%.4g FLOP a step" % (
                  b, t, card, rate, med, p80, issue, peak, built, per_fwd,
                  ["%.4f" % v for v in losses], aux, flops), flush=True)
        dev_ms = print_step_breakdown(
            "train moe_lm bf16", device_rows(lambda: st(x, y), 2), med,
            flops / med * 1e3, "bfloat16", card)
        if not ok:
            raise AssertionError("moe train: B2 %d a forward (expected %d), "
                                 "builds %s, losses %s" % (
                                     per_fwd, layers, built, losses))
        res = dict(step_ms=med, p80_ms=p80, issue_ms=issue,
                   tokens_per_s=rate, device_ms=dev_ms, idle=1 - dev_ms / med,
                   peak_gib=peak, builds_after_warmup=built,
                   b2_per_forward=per_fwd,
                   train_mfu=flops / med * 1e3 / PEAK_FLOPS["bfloat16"])
        del st, net
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        mt.distributed.shutdown()
    return res


def moe_phase(card):
    """Slice 14's path (ROADMAP A8's second part): the Switch MoE layer
    against its dense formulation, the 2-layer MoE LM against the CPU,
    the 12-layer 8-expert bf16 MoE LM served and trained on B2. (Its
    four-rank gates run in ``parallel_phase``'s part (b).)"""
    import gc
    import torch
    t_phase = time.time()
    out = {"ffn": moe_ffn_check(card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["lockstep"] = moe_lockstep(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["b2"] = moe_b2_timing(card)
    arrays = _par_arrays(BERT_BASE["num_layers"], MOE_EXPERTS)
    out["serve"] = moe_serve(card, arrays)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = moe_train(card, arrays)
    del arrays
    print("moe phase %.1f s" % (time.time() - t_phase), flush=True)
    return out


def kernel_entries(rows, launches, train_launches, name, source, replaces,
                   bwd_rows=()):
    """One `kernels` entry per type: the per-forward shapes' numbers, each
    times its launches per forward, summed; ``train_launches`` are the
    kernel's launches in one training step of that type. ``bwd_rows``:
    forward + backward by graph replay (the kernel path, its plain
    version, the library's) and its bound, summed over the rows given."""
    entries = []
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        timed = [r for r in mine if r["per_forward"]]
        keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
        extra = [key for key in ("graph_ms", "library_graph_ms", "host_us",
                                 "library_host_us")
                 if all(key in r for r in timed)]
        tot = {key: sum(r[key] * r["per_forward"] for r in timed)
               for key in keys + extra}
        by_bytes = sum(r["bound_ms"] * r["per_forward"] for r in timed
                       if r["bound_by"] == "bytes")
        entries.append({
            "name": name % dtype, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[dtype],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            # the kind that bounds the larger share of the summed bound
            "bound_by": ("bytes" if 2 * by_bytes >= tot["bound_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"],
            "train_launches": train_launches[dtype],
        })
        # the same sums timed by CUDA-graph replay, and the host us to
        # issue the calls of one forward
        entries[-1].update((key, tot[key]) for key in extra)
        bwd = [r for r in bwd_rows if r["dtype"] == dtype]
        entries[-1].update(
            (key, sum(r[key] for r in bwd)) for key in (
                "train_graph_ms", "plain_train_graph_ms",
                "library_train_graph_ms", "train_bound_ms") if bwd)
    return entries


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_start = time.time()
    card = card_line()
    print("card:", card, flush=True)
    sys.path.insert(0, ROOT)
    import mxtpu_torch  # noqa: F401  (applies the precision policy)
    from mxtpu_torch import kernels
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                            torch.version.cuda,
                                            sys.version.split()[0]))
    t0 = time.time()
    names = kernels.build_all()
    print("built %s from mxtpu_torch/csrc with nvcc for sm_90a in %.1f s"
          % (names, time.time() - t0), flush=True)
    for name in names:
        print_ptxas(name, kernels.build_log(name))
    conv_rows = conv_kernel_phase()
    conv_launches = resnet_serve_phase(card)
    flash_rows = flash_phase()
    flash_launches = lm_serve_phase(card)
    int8_phase()
    hybridize_phase()
    batcher_phase(card)
    http_phase(card)
    controller_conv = controller_phase(card)
    zoo_conv, zoo_flash = zoo_phase(card)
    gluon_nd_phase()
    conv_bwd = conv_backward_phase()
    flash_bwd = flash_backward_phase()
    conv_train, conv_timing = resnet_train_phase(card)
    flash_train, lm_timing = lm_train_phase(card)
    # the captured training step's path: B1's and B2's launches from 0
    from mxtpu_torch.ops.pallas.conv import fused_conv
    from mxtpu_torch.ops.pallas.flash_attention import flash_attention
    fused_conv.launches = flash_attention.launches = 0
    captured = captured_train_phase(card, {
        "resnet50 float32": conv_timing["float32"],
        "resnet50 bfloat16": conv_timing["bfloat16"],
        "transformer_lm bfloat16": lm_timing})
    captured_path = {"conv": fused_conv.launches,
                     "flash": flash_attention.launches}
    print("captured training phase launches (over both types): %s"
          % captured_path, flush=True)
    if not all(captured_path.values()):
        raise AssertionError("captured training: a kernel of its path was "
                             "not launched: %s" % captured_path)
    # slice 10: the input path, B1's count from 0 just before it
    fused_conv.launches = 0
    input_results = input_phase(card)
    input_b1 = fused_conv.launches
    print("input phase fused_conv launches (the f32 lockstep and the bf16 "
          "timed runs): %d" % input_b1, flush=True)
    if not input_b1:
        raise AssertionError("the input path launched no fused_conv")
    # slice 11: the symbolic API, B1's and B2's counts from 0 just before
    fused_conv.launches = flash_attention.launches = 0
    symbolic = symbolic_phase(card)
    symbolic_path = {"conv": fused_conv.launches,
                     "flash": flash_attention.launches}
    print("symbolic phase launches (over both types): %s" % symbolic_path,
          flush=True)
    if not all(symbolic_path.values()):
        raise AssertionError("the symbolic path launched no %s: %s" % (
            " or ".join(k for k, v in symbolic_path.items() if not v),
            symbolic_path))
    # slice 12: the RNN path runs none of B1-B3; their counts from 0 just
    # before it (B3's kernels are the rtc Kernels any code would launch:
    # every launch of one passes rtc.launched)
    from mxtpu_torch import rtc as rtc_mod
    fused_conv.launches = flash_attention.launches = 0
    rtc_launches_seen = []
    rtc_launched = rtc_mod.launched
    rtc_mod.launched = lambda k: (rtc_launches_seen.append(k),
                                  rtc_launched(k))
    try:
        rnn = rnn_phase(card)
    finally:
        rtc_mod.launched = rtc_launched
    rnn_path = {"b1": fused_conv.launches, "b2": flash_attention.launches,
                "b3": len(rtc_launches_seen)}
    print("rnn phase launches of B1-B3: %s" % rnn_path, flush=True)
    if any(rnn_path.values()):
        raise AssertionError("the RNN path launched a kernel of B1-B3: %s"
                             % rnn_path)
    # slice 13: several ranks (A8's first part), B1-B3's counts from 0
    # just before it; B2 runs in the world of one's steps and the ring
    fused_conv.launches = flash_attention.launches = 0
    rtc_launches_seen = []
    rtc_mod.launched = lambda k: (rtc_launches_seen.append(k),
                                  rtc_launched(k))
    try:
        par_rows, par_ranks, par_blocks = parallel_phase(card)
    finally:
        rtc_mod.launched = rtc_launched
    parallel_path = {"b1": fused_conv.launches,
                     "b2": flash_attention.launches,
                     "b3": len(rtc_launches_seen)}
    print("parallel phase launches of B1-B3 in this process: %s"
          % parallel_path, flush=True)
    if not parallel_path["b2"] or parallel_path["b1"] or parallel_path["b3"]:
        raise AssertionError("the parallel path's launches: %s (B2 only)"
                             % parallel_path)
    # slice 14: the Switch MoE (A8's second part), B1-B3's counts from 0
    # just before it; B2 runs in the MoE LM's every forward
    fused_conv.launches = flash_attention.launches = 0
    rtc_launches_seen = []
    rtc_mod.launched = lambda k: (rtc_launches_seen.append(k),
                                  rtc_launched(k))
    try:
        moe = moe_phase(card)
    finally:
        rtc_mod.launched = rtc_launched
    moe_path = {"b1": fused_conv.launches, "b2": flash_attention.launches,
                "b3": len(rtc_launches_seen)}
    print("moe phase launches of B1-B3: %s" % moe_path, flush=True)
    if not moe_path["b2"] or moe_path["b1"] or moe_path["b3"]:
        raise AssertionError("the moe path's launches: %s (B2 only)"
                             % moe_path)
    # slice 9: the zoo's shape classes, then each path with B1's count
    # from 0 just before it and read just after
    t0 = time.time()
    zoo_conv_rows = zoo_conv_phase()
    print("zoo conv phase %.1f s" % (time.time() - t0), flush=True)
    zoo_path = {}
    fused_conv.launches = 0
    zoo_serve = zoo_serve_phase(card)
    zoo_path["zoo_serve"] = fused_conv.launches
    fused_conv.launches = 0
    zoo_train = zoo_train_phase(card)
    zoo_path["zoo_train"] = fused_conv.launches
    fused_conv.launches = 0
    s2d_launches = s2d_phase(card)
    zoo_path["s2d"] = fused_conv.launches
    print("slice 9 paths' fused_conv launches (over both types): %s"
          % zoo_path, flush=True)
    if not all(zoo_path.values()):
        raise AssertionError("a slice 9 path launched no fused_conv: %s"
                             % zoo_path)
    n = resnet50_param_count()
    _, rtc_kernels, rtc_rows = rtc_phase(n)
    rtc_launches = imperative_phase(rtc_kernels, n)
    # the decode path runs none of B1-B3 (its model is plain torch, as the
    # reference's is jnp): every kernel's launches from 0 over the phase,
    # run last so that the B3 kernels exist
    fused_conv.launches = flash_attention.launches = 0
    for k in rtc_kernels.values():
        k.launches = 0
    decode_phase(card)
    decode_launches = {"conv": fused_conv.launches,
                       "flash": flash_attention.launches}
    decode_launches.update((name, k.launches)
                           for name, k in rtc_kernels.items())
    print("decode phase launches (fused_conv and flash_attention over "
          "both types, each rtc kernel its own): %s" % decode_launches,
          flush=True)
    if any(decode_launches.values()):
        raise AssertionError("decode: a kernel of B1-B3 was launched on the "
                             "decode path: %s" % decode_launches)
    entries = kernel_entries(
        conv_rows, conv_launches, conv_train,
        "fused_conv (%s, the 11 gated convs of one b8 ResNet-50 forward)",
        "mxtpu_torch/csrc/fused_conv.cu", "mxtpu/ops/pallas/conv.py:313",
        conv_bwd)
    entries += kernel_entries(
        flash_rows, flash_launches, flash_train,
        "flash_attention (%s, the 12 attentions of one b8 x 512 BERT-base "
        "forward)", "mxtpu_torch/csrc/flash_attention.cu",
        "mxtpu/ops/pallas/flash_attention.py:125",
        [r for r in flash_bwd if r["shape"] == FLASH_BWD_SHAPES[0][0]])
    # the bf16 entries' launches on the control plane's paths (each
    # counted from 0 over its phase)
    entries[1].update(controller_launches=controller_conv,
                      zoo_launches=zoo_conv)
    entries[3].update(zoo_launches=zoo_flash)
    for i, dtype in enumerate(("float32", "bfloat16")):
        entries[i].update(
            zoo_serve_launches={m: v[dtype] for m, v in zoo_serve.items()},
            zoo_train_step_launches=zoo_train[dtype],
            s2d_serve_launches=s2d_launches[dtype],
            zoo_paths_launches_both_dtypes=zoo_path,
            zoo_shape_classes={r["shape"]: {
                k: r[k] for k in ("max_abs_err", "graph_ms",
                                  "library_graph_ms", "bound_ms")}
                for r in zoo_conv_rows if r["dtype"] == dtype})
    for i, e in enumerate(entries[:4]):
        kind = "conv" if i < 2 else "flash"
        e["symbolic_%s_launches" % ("b1" if i < 2 else "b2")] = \
            symbolic_path[kind]
    for e in entries[:2]:
        e["symbolic_b1_launches_per_forward_or_step"] = {
            "from_checkpoint_bf16_forward": 11,
            "module_f32_step": symbolic["train"]["module"]["launches"]}
    for i, dtype in enumerate(("float32", "bfloat16")):
        row = next(r for r in symbolic["attention"] if r["dtype"] == dtype)
        entries[2 + i]["symbolic_b2_launches_per_forward"] = \
            row["launches"] // 3
        entries[2 + i]["symbolic_attention_96x512x64"] = {
            k: row[k] for k in ("partitioned", "unpartitioned", "sdpa",
                                "bound_ms", "out_err", "grad_err")}
    for e in entries[:2]:
        e["input_b1_launches"] = input_b1
        e["input_b1_launches_per_step"] = {
            k: v["b1_per_step"] for k, v in input_results.items()
            if k != "loader_only"}
    for i, dtype in enumerate(("float32", "bfloat16")):
        e = entries[2 + i]
        e["parallel_b2_launches"] = {
            "this_process_both_parts": parallel_path["b2"],
            "world_of_one_bf16_per_forward": {
                k: v["b2_per_forward"] for k, v in par_rows.items()},
            "four_ranks_sp4_per_rank_per_layer": {
                str(r["rank"]): {k: v["b2_per_layer"]
                                 for k, v in r["sp"].items()
                                 if k.startswith(dtype)}
                for r in par_ranks}}
        e["ring_block_rows"] = [r for r in par_blocks
                                if r["dtype"] == dtype]
        e["moe_b2_launches"] = {
            "phase_both_types": moe_path["b2"],
            "served_bf16_per_forward": moe["serve"]["b2_per_forward"],
            "trained_bf16_per_forward": moe["train"]["b2_per_forward"]}
        if dtype == "bfloat16":
            e["moe_b2_16x12x512x64"] = moe["b2"]
    for e in entries[:2]:
        e["moe_b1_launches"] = moe_path["b1"]
    for i, e in enumerate(entries):
        kind = "conv" if i < 2 else "flash"
        e["decode_launches_both_dtypes"] = decode_launches[kind]
        e.update(("rnn_%s_launches" % k, v) for k, v in rnn_path.items())
        e["moe_b3_launches"] = moe_path["b3"]
        e["captured_train_step_launches"] = captured[kind][
            "float32" if i % 2 == 0 else "bfloat16"]
        e["captured_train_launches_both_dtypes"] = captured_path[kind]
    for r in rtc_rows:
        if rtc_launches[r["name"]] < 1:
            raise AssertionError("rtc %s was not launched on the imperative "
                                 "main path" % r["name"])
        entries.append({
            "name": "rtc %s (%s, n=%d, one user kernel launch)"
                    % (r["name"], r["dtype"], n),
            "route": "cuda", "source": "chip_smoke.py",
            "replaces": "mxtpu/rtc.py:170",
            "launches": rtc_launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "decode_launches": decode_launches[r["name"]],
            "rnn_b3_launches": rnn_path["b3"],
            "moe_b3_launches": moe_path["b3"]})
    print("rnn op beside torch.nn.LSTM (graph replay ms): %s" % json.dumps(
        rnn["op"]))
    print(json.dumps({"kernels": entries}))
    print("whole script %.1f s" % (time.time() - t_start))
    print("card:", card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def four_cards_main():
    import torch
    if torch.cuda.device_count() < PARALLEL_RANKS:
        print("chip_smoke parallel_four_cards: %d cards, %d needed"
              % (torch.cuda.device_count(), PARALLEL_RANKS), file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    parallel_four_cards(card)
    print("four cards %.1f s" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["parallel_four_cards"]:
        sys.exit(four_cards_main())
    sys.exit(main())
