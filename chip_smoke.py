#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``unigen_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``unigen_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the main paths' shapes and dtypes
(bf16; the tokenizer's encoder in fp32, the dtype of its pixels), at ragged
shapes and in fp32, and drives the main paths at the flagship width
with random weights, each with the launch counts set to 0 just before it and
read just after:

* ``flagship``: GenEval text-to-image (``build_pipeline`` ->
  ``generate_images`` -> ``decode_codes``), Qwen2.5-1.5B + MAGViTv2;
* ``flagship_int8``: the same t2i call on W8A8, the JAX package's shipped
  t2i default (``build_pipeline(quantization="int8")``: backbone and image
  head int8, ``torch._int_mm`` plus the epilogue kernel ``csrc/int8.cu``);
* ``understand``: SigLIP VQA (``build_pipeline(vision=True)`` ->
  ``quantize_unigen_params_int4`` -> ``understand``), SigLIP-SO400M + the MM
  projector + Qwen2.5-1.5B in W4A8, 8 images of 384 px, 128 new tokens
  greedy; then once more with the bf16 backbone as a yardstick;
* ``understand_int8``: the same call as JAX's ``int8+kv``
  (``build_pipeline(vision=True, quantization="int8",
  quantized_cache=True)``: tower, backbone and text head W8A8, K/V int8);
* ``flagship_ar``: the t2i call with ``mode="ar"`` (255 cached steps, one
  image token each, cond and uncond rows);
* ``understand_discrete``: VQA over the tokenizer's codes, 8 fp32 images of
  256 px through the MAGViTv2 encoder (kernel 3 at its 7 shapes in fp32,
  counted by shape), the mmu prompt right-padded to 1,603, 128 greedy tokens;
* ``understand_naflex``: VQA through the SigLIP2-NaFlex tower
  (``build_pipeline(vision="naflex")``: google/siglip2-so400m-patch16-naflex's
  shape, 26 layers whose attention is kernel 1 with a key mask a row), bf16,
  8 images of 256 px (16 x 16 patches), 128 greedy tokens: tokens/s and the
  tower's share of the call; then a tiny fp32 NaFlex run with ragged images
  in one batch, the card against the CPU;
* ``score``: ``score_continuations`` of 8 (image, question, continuation)
  requests, one cache-free forward;
* ``lmms``: the lmms-eval adapter over the NaFlex flagship on 24 uint8
  requests of 384 x 384, 256 x 512 and 640 x 256 (H x W) with budgets of
  8-64 tokens, stops and two 'concat' requests: ``generate_until`` static
  (batch 8) and served (16 slots, chunk 8) and ``loglikelihood`` batched
  and single, in bf16 with their rates and exact launches; in fp32 static =
  served strings and batched = single scores;
* ``geneval``: ``evaluation.geneval.run_geneval`` over 2 prompts x 4
  samples, every PNG read back against its batch's pixels;
* ``cot``: ``evaluation.cot.run_cot`` (CoT-V Best-of-N) on one two-colour
  GenEval prompt (4 rule questions): 20 candidates rated through the SigLIP
  tower (the candidates resized to 384 px, the Qwen system prompt, 32
  greedy tokens a rating), then 8 candidates rated over the tokenizer's codes (the
  encoder in bf16, the candidates' dtype); top 4 kept, and the selection
  also held on the table with planted answers whose scores do not tie;
* ``dpg``: ``evaluation.dpg.run_dpg`` over 2 prompts x 4 samples at the
  DPG text budget of 256, every grid PNG read back against its batch;
* ``image_serving``: ``serving.ImageServingEngine`` at batch 4, 6 requests
  from 3 threads (one full batch, one padded), each image held against the
  direct call of its padded batch under the batch's derived generator;
* ``serving``: the continuous-batching ``serving.ServingEngine`` on the JAX
  serving bench's trace (48 requests of 600 prompt ids, budgets in [32,
  224], 32 slots, chunk 16, all queued at once), greedy, in bf16 (and in
  static waves of 32 over the same trace), ``int8+int4`` (W8A8 admission,
  W4A8 decode chunks) and ``int8+kv`` (W8A8, int8 KV cache) on its
  first 16: useful
  tokens/s, requests/s, TTFT, ITL, occupancy; launch counts exact from each
  run's admissions and decode steps;
* ``serving_vqa``: 8 VQA requests through ``pipeline.vqa_serving_inputs``
  and ``submit_embeds``, 128 greedy tokens;
* ``serving_http``: ``serving.ServingHTTPServer`` over the bf16 engine and
  the image engine, replies held against ``submit`` and the direct call;
* ``serving_spec``: the engine with prompt-lookup speculation
  (``speculate_k=4``: every step a verify step of 5 queries through kernel
  1 with its per-row causal offset) on the serving phase's bf16 trace,
  beside the plain engine on the same trace: useful tokens/s, tokens
  accepted per verify step, TTFT, ITL, occupancy, 28 kernel-1 launches a
  step; the flagship's verify forward [32, 5] against 5 decode forwards from
  one cache (fp32 and bf16); then a tiny fp32 speculative engine on the card
  against the CPU and the plain engine, and a verify chunk under CUDA's sync
  debug mode;
* ``train``: PT2 pretraining (``configs/unigen_1_5b/unigen_pt2.yaml``
  through ``training.train.build_trainer`` and ``Trainer.train``,
  synthetic flows, no checkpoint written): Qwen2.5-1.5B + the frozen
  MAGViTv2, random init, bf16 parameters and AdamW state, remat and the
  chunked CE, 8 t2i + 2 lm + 6 mmu rows of 835 tokens; 2 warm and 5
  timed steps: s a step, samples/s, tokens/s, enqueue, peak memory, model
  FLOPs; exact launches a step (kernel 2 28 + 28 in the remat recompute
  and its backward kernel 28, kernel 3 80 + 80 over both encodes); one step
  through kernel 2 against the same step through the plain attention;
* ``sft``: SFT through the SFT entry's own run (``training.train_sft.SFTRun``)
  on ``configs/unigen_1_5b/unigen_sft.yaml`` (synthetic flows, random init):
  3 t2i + 1 lm rows of 1,603 tokens and 4 mmu rows of 3 + 729 + 64 = 796
  through the frozen fp32 SigLIP tower, the separate mode (two backward
  passes); 2 warm + 5 timed steps: s a step, samples/s, tokens/s, enqueue,
  peak memory, model FLOPs; exact launches a step (kernel 2 in the tower and
  in both calls with their remat recompute, kernel 3 in the t2i encode),
  finite metrics, the frozen tower and VQ unchanged bit for bit, the
  projector moved;
* ``sft_packed``: the same config with ``max_seq_length=128`` (rows of 387
  packed two a row into 7 rows of 796), the same prints and gates, one
  step's losses and grad norm against the fused (left-padded) step in fp32
  (rtol 2e-5), and a LoRA run (rank 16, all seven families) that moves only
  the adapters and the projector, its peak memory beside full SFT's;
* ``dpo``: DPO through the DPO entry's run on ``unigen_dpo.yaml`` (10 pairs of
  387-token rows, the online reference, two fp32 encodes of 10), the same
  prints; first the precomputed-reference step against the online one on 2
  batches, bit for bit;
* ``cotv_post_sft``: the SFT entry on ``unigen_cotv_post_sft.yaml`` (8 mmu rows
  of 796, no remat, ``common_length`` None), the same prints and gates;
* ``sft_naflex``: the SFT entry on ``unigen_sft.yaml`` with the SigLIP2-NaFlex
  tower (mmu rows of 3 + 256 + 64 over images of three aspects, padded
  patches), 1 warm + 2 timed steps, the same prints and gates; then a tiny
  fp32 NaFlex SFT step on the card against the CPU;
* ``images``: the committed WebP, GIF, BMP, PPM / PGM and TIFF fixtures
  (``unigen_tpu_torch/data/assets/images/``) through ``decode_image``, each
  held to the sha256 of PIL's pixels and timed on one host thread (MP/s a
  fixture and a format); a header of each format PIL reads and the port
  refuses raises ``UnsupportedImageFormat`` naming it;
* ``sft_real``: the SFT entry on files read from disk (``unigen_sft.yaml``,
  ``dataset.synthetic`` off): t2i from 4 tar shards of 64 JPEG samples of
  five sizes (one in eight a PNG of every filter, one in eight a WebP
  fixture, json and txt captions, one corrupt sample a shard) through the
  native streamer, the conversations from a LLaVA ``.jsonl`` over JPEGs,
  PNGs, a GIF named ``.jpg``, a BMP, a TIFF and a PPM at the SigLIP tower's
  384 px (mmu rows of 3 + 729 + 512); every image decoded without PIL
  (``data/decode.py``), each fixture's decodes held to PIL's hash; 1 warm + 2 timed
  steps with the sft phase's gates, the loader's seconds a batch (Python
  and native readers, LLaVA, the entry's flows) and the loop a step beside
  the step and the sft phase; the decoder held to the encoded pixels for
  every filter, the native stream to the Python reader on a pass, each
  step's pixels to the loader's (fingerprints);
* ``pt2_real`` (not in the default run): PT2 through the train entry's
  ``task_flows`` on 8 such shards (t2i 5, mmu 3, native), the lm rows the
  entry's synthetic lm texts (no pyarrow on the card), the train phase's
  gates and the same prints beside it;
* ``dpo_real`` (not in the default run): the DPO entry on 21 pairs of JPEGs,
  PNGs and lossless WebPs (one corrupt), ``training.num_epoch=2``, its
  reference precompute pass
  (exact launches) and its check that both passes see the same batches,
  1 warm + 2 timed steps with the dpo phase's gates;
* ``checkpoints``: the seed-0 flagship with the SigLIP tower written in the
  reference layouts (UniGen bf16 in 3 safetensors shards with an index,
  ``llm.model.*`` and ``mm_projector.*`` at the unified vocabulary of
  159,867; MAGViTv2 fp32 as ``pytorch_model.bin``; SigLIP-SO400M fp32 in
  HF's layout with its 27th layer, ``post_layernorm`` and head), natively,
  and by ``utils.import_weights.convert`` from the reference files, in a
  temporary directory; ``build_pipeline(config)`` of ``unigen_sft.yaml``
  from each, every leaf bit for bit the seed tree as the pipeline holds it
  (contiguous, on the card); t2i (batch 4) and understand (8 x 128) on the
  reference and the native loads with exact launches and equal codes and
  tokens; ``import_qwen2`` growing Qwen2.5-1.5B's 151,936 rows to 159,867
  (new rows the mean row within one bf16 step); a Qwen2 ``tokenizer.json``
  (byte symbols, up to 4,000 merges counted over the phase texts and
  3,000 seeded pseudo-word texts, Qwen2.5's added tokens) read by
  ``load_tokenizer`` without ``transformers``, every text round-tripping,
  its encode rate with a cold word cache over 2,000 distinct held-out texts
  and over their distinct words, each once; seconds and the host's peak RSS of each
  write, load and conversion;
* ``serve_entry``: ``python -m unigen_tpu_torch.serving.serve`` over
  ``configs/unigen_1_5b/unigen_sft.yaml`` (the flagship with the SigLIP
  tower, random init, read by the port's YAML reader) with speculation,
  W4A8 decode chunks and the image engine at the serving phase's shapes:
  as a subprocess, seconds to healthy and SIGTERM; then ``build_server``
  of the same config in this process, the three routes with exact launch
  counts, the replies held against ``submit``, the PNG against its batch's
  direct call, the subprocess's tokens against this process's;
* ``parallel``: kernels 1 and 2 at a model rank's shapes (model 2: 6 query
  heads over 1 KV head), then 2 ranks on the one card under gloo (NCCL
  refuses two ranks on one device; a TCP store on localhost): the tiny
  fp32 PT2 step on meshes (1,1,2), (2,1,1), (1,2,1) against one rank's
  (losses, grad norm, the gathered gradients before the update, every
  parameter element after it), a tiny t2i at model 2 token for token, and
  a tiny fp32 serving engine at model 2 (rank 0 decides, rank 1 follows
  its plan; greedy, sampled and embeddings requests, speculation on) token
  for token against one rank's engine, with equal decode chunks and busy
  steps on both ranks, and the flagship t2i at model 2 as the flagship
  phase runs it but for its depth (batch 4, guidance 6, 10 steps) with its
  first-step image logits against the unsharded forward, exact launches a
  rank, its codes against one rank's, the call's seconds and its collectives'
  share (gloo on one card, not a multi-card speed); the kernels at a rank's
  shapes include the serving decode step (kernel 1 at [32, 1, 6, 128], S
  896) and admission (kernel 2 at [16, 640, 6, 128], pad bits), and kernel
  4, the quantization kernel and the W8A8 epilogue at a model-2 rank's
  quantized layers (``RANK_W4A8``: kernel 4 at T 32, 160 and 6,296 on a
  column layer's fused launch or a row layer's fp32 product, the down
  projection repacked at group 128; a row layer's slice quantized with the
  global absmax; the W4A8 row epilogue; the W8A8 layer at the t2i step's
  2,064 rows), bit for bit; the tiny checks add the PT2 step of a tree with
  LoRA adapters at (1,1,2), the tiny W8A8 t2i at model 2 token for token,
  the tiny W4A8 t2i (group 64, a rank's o cut inside a group) by its first
  image logits, and the tiny engine in int8+kv and int8+int4 at model 2
  token for token, with 1 KV head a rank's cache;
* ``parallel_train`` (only when named): the flagship PT2 step at model 2
  and at fsdp 2, its first losses against one rank's and each rank's peak
  memory; then the fsdp-2 state saved by both ranks and restored by pieces
  onto model 2: its bytes, the seconds to save and restore, each rank's
  host RSS rise over the restore, every restored leaf bit for bit the
  saved one, and one step from it against the fsdp-2 mesh's next step;
* ``parallel_serving`` (only when named): the flagship serving engine at
  model 2 in bf16 on the serving phase's first 48 requests: every rank's
  tokens, chunks, busy steps and exact launches, useful tokens/s, TTFT p50,
  the collectives' share of the wall and each rank's peak memory (gloo on
  one card), beside the one-rank engine on the same requests;
* ``parallel_quant`` (only when named): the flagship W8A8 t2i at model 2
  (``build_pipeline(quantization="int8")``, batch 4, guidance 6, 50 steps,
  the int8 image head split over the codes): its first-step logits against
  the unsharded forward, its codes against the one-rank W8A8 run's, exact
  launches a rank, the collectives' share and a rank's peak memory; then the
  flagship engine in int8+int4 and int8+kv at model 2 on parallel_serving's
  48 requests beside the one-rank engines: useful tokens/s, the share of
  tokens equal to one rank's, exact launches and a rank's peak memory.

It checks that each path went through every kernel it runs (fixed launch
counts), and compares tiny fp32 runs through the kernels on the card with
the plain versions on the CPU (t2i under shared noise; W4A8 understand,
greedy; int8 t2i and understand with the int8 cache; the codes of
``encode_pixels``, AR t2i under shared noise, ``understand_discrete``
greedy and ``score_continuations``; CoT rating tokens of both raters; a
tiny serving engine with staggered admissions, an eot stop, a cancellation,
the int8 cache and a shared prefix, token for token, and one of its decode
chunks under CUDA's sync debug mode "error"; a tiny fp32 train step: losses,
grad norm and gradients, and the card's AdamW on the CPU's gradients, then
6 steps that lower the loss; the tiny fp32 SFT steps, separate and packed,
and the DPO step the same way, then 6 DPO steps that learn the preference).
Kernel 2's autograd function (the training steps' attention) is held at
PT2's [16, 835, 12, 128] and at the post-training steps' [4, 1603], [4,
796], [7, 796] (packed, segment bits) and [20, 387], with their bits: the
forward against its plain version, dq, dk, dv bit-equal to the plain
version's autograd, forward and backward timed beside SDPA's and their
bounds; kernel 3's fp32 route is timed at the encoder's shapes at batches
6, 3 and 10 (the PT2, SFT and DPO encodes). Kernel 1 is held at the
SigLIP2-NaFlex tower's [8, 256, 16, 72 -> 80] in fp32 and bf16 with
all-valid and ragged key masks, pad query rows included, and timed beside
SDPA with a boolean key mask; kernel 3's autograd function gives the plain
version's gradients bit for bit at two decoder shapes in fp32. The W8A8 epilogue is
held to its plain version bit for bit at every shape of the int8 paths and
timed with the whole layer against bf16 ``F.linear``. Kernel 4 (the
W4A8 product, its epilogue fused) and the per-token quantization are held
to their plain versions bit for bit at every shape of the W4A8 path, on
every route, and each W4A8 layer is timed whole against bf16 ``F.linear``. Kernel 3
(GroupNorm statistics + fused conv, two launches) is held to its plain version
and timed at all 11 conv shapes of the MAGViTv2 decoder and all 7 of its
encoder, and again at the CoT slice's batches (the decoder at 20, the
encoder in bf16 at 8); the flagship, understand_discrete and cot phases
count its launches by shape in their last run, and the sums of launches x ms
over a t2i batch and over an encode are taken from those counts. A path whose
call takes seconds runs once (``ONCE``), a shorter one cold and then warm; the
wall time of each phase goes to stdout and to stderr. Every check that
fails makes the exit code nonzero. The last line of stdout is a JSON object
naming the device; the line before it holds the kernels' measurements.
Without a CUDA device, or without the package beside it, the script exits
nonzero and prints no result. Kernel times (``ms``, ``plain_ms``,
``library_ms``) are device times from ``torch.profiler``; bounds are
computed from each phase's inputs against the H100 SXM's published peaks.

``--phases`` (default: build,kernels,flagship,flagship_int8,flagship_ar,
understand,understand_int8,understand_discrete,understand_naflex,score,lmms,
geneval,cot,dpg,image_serving,serving,serving_vqa,serving_http,serving_spec,
serve_entry,train,sft,sft_packed,dpo,cotv_post_sft,sft_naflex,jpeg,images,sft_real,checkpoints,
parallel,tiny)
runs a subset, for quick checks; ``pt2_real``, ``dpo_real``, ``parallel_train``,
``parallel_serving`` and ``parallel_quant`` run only when named;
adding ``profile`` traces one more warm run of each path with ``torch.profiler`` and prints
where the device time goes, by kernel and by family (the port's kernels,
cuBLAS, plain-torch copies, reductions and elementwise kernels).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import math
import subprocess
import sys
import time

PHASES = ("build", "kernels", "flagship", "flagship_int8", "flagship_ar", "understand",
          "understand_int8", "understand_discrete", "understand_naflex", "score", "lmms",
          "geneval", "cot", "dpg", "image_serving", "serving", "serving_vqa", "serving_http",
          "serving_spec", "serve_entry", "train", "sft", "sft_packed", "dpo", "cotv_post_sft",
          "sft_naflex", "jpeg", "images", "sft_real", "checkpoints", "parallel", "tiny")
OPTIONAL_PHASES = ("pt2_real", "dpo_real", "parallel_train", "parallel_serving",
                   "parallel_quant", "profile")
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
INT8_PEAK = 1979e12     # H100 SXM dense int8 tensor-core OP/s
FP32_PEAK = 67e12       # H100 SXM fp32 (non-tensor) FLOP/s
HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
PROMPTS = ("a photo of a red apple on a wooden table",
           "two dogs playing in the snow",
           "a blue bicycle leaning against a brick wall",
           "a bowl of ramen with chopsticks, studio lighting")
QUESTIONS = ("What is in this image?",
             "How many people are in the picture?",
             "What color is the car on the left?",
             "Describe the scene in one sentence.",
             "Is it day or night?",
             "What is the man holding in his hand?",
             "Which animal is sitting on the sofa?",
             "What is written on the red sign?")
NEW_TOKENS = 128
# the paths whose call takes seconds run once (their launches and output
# checked, their time a first call's); the shorter ones cold, then warm
ONCE = ("run",)
# continuations of 1-16 tokens (one byte-tokenizer token a character) scored
# after QUESTIONS by the score phase
CONTINUATIONS = ("A", "Two.", "Red.", "A busy street.", "Day", "An umbrella", "A cat",
                 "STOP, no entry!!")
# CoT-V: a two-colour GenEval prompt (4 rule questions); candidates rated
# through the SigLIP tower, and fewer over the tokenizer's codes; top-k kept
COT_PROMPT = "a photo of a red cube and a blue sphere"
COT_SAMPLES, COT_DISCRETE_SAMPLES, COT_TOPK = 20, 8, 4
COT_RATING_TOKENS = 32   # greedy tokens a rating (run_cot's default 128, cut)
DPG_TEXT_LEN = 256       # DPG-bench's text budget (GenEval's is 128)
SERVING_BATCH = 4
# the text serving engine at JAX's serving bench (bench.py::bench_serve): its
# requests of 600 random prompt ids, budgets uniform in [32, 224], 32 slots,
# chunk 16, bucket 640, cache 896, groups of up to 16 admitted at once; 48
# requests (the bench's 96, cut to keep the default run inside its time limit)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_CHUNK = 32, 48, 600, 16
SERVE_BUCKET, SERVE_MAX_LEN, SERVE_ADMIT = 640, 896, 16
SERVE_QUANT_REQUESTS = 16   # the int8+int4 and int8+kv runs: the trace's first requests
SERVE_VQA_BUCKET = 64    # vqa_serving_inputs' l2_bucket
SPEC_K = 4               # the serving_spec phase's draft length (bench.py serve spec)
# the serve_entry phase: the flagship SFT config, random init, served by a
# subprocess; its /v1/generate prompts and budget
SERVE_CONFIG = "configs/unigen_1_5b/unigen_sft.yaml"
SERVE_ENTRY_PROMPTS = ("What is a GPU?", "Repeat after me: one two three, one two three.",
                       "Name three colours.")
SERVE_ENTRY_NEW = 16
# the train phase: PT2 (8 t2i + 2 lm + 6 mmu rows of 576) at the flagship width,
# random init, synthetic flows; steps warm and timed
TRAIN_CONFIG = "configs/unigen_1_5b/unigen_pt2.yaml"
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_OUT = "output/chip_smoke_train"
# the post-training phases: the stage configs at the flagship width, random
# init, synthetic flows, no checkpoint written; steps warm and timed
SFT_CONFIG = "configs/unigen_1_5b/unigen_sft.yaml"
DPO_CONFIG = "configs/unigen_1_5b/unigen_dpo.yaml"
COTV_CONFIG = "configs/unigen_1_5b/unigen_cotv_post_sft.yaml"
PACKED_OVERRIDES = ("dataset.preprocessing.max_seq_length=128",)   # rows of 387: packed
POST_OUT = "output/chip_smoke_post"
STAGE_WARM, STAGE_TIMED = 2, 5
COTV_WARM, COTV_TIMED = 1, 2
# the NaFlex paths: SigLIP2-NaFlex at google/siglip2-so400m-patch16-naflex's shape, a
# budget of 256 patches of 16 px; understand_naflex's images are 256 px (16 x 16 patches)
NAFLEX_PATCHES, NAFLEX_PX = 256, 256
# the lmms phase: uint8 requests of three aspects (H, W), budgets in turn, the static
# route's batch, the served route's slots and chunk
LMMS_SIZES = ((384, 384), (256, 512), (640, 256))
LMMS_BUDGETS = (8, 16, 32, 64)
LMMS_REQUESTS, LMMS_BATCH, LMMS_SLOTS, LMMS_CHUNK = 24, 8, 16, 8
SFT_NAFLEX_OVERRIDES = ("model.vision_tower.name=siglip2-so400m-patch16-naflex",)
SFT_NAFLEX_WARM, SFT_NAFLEX_TIMED = 1, 2
# the real-data phases: files written under a temporary directory from the committed
# JPEG fixtures (unigen_tpu_torch/data/assets/jpeg/, written with PIL from seed 0): the
# web fixtures in the tar shards, the COCO ones in the LLaVA folder, the ImageNet ones
# in the DPO pairs, in turn; one image in REAL_PNG_EVERY a PNG of a fixture's pixels
# (the PNG filter sets in turn, all five in turn last), one truncated JPEG a shard
REAL_T2I_FIXTURES = ("web_512x512_420_q90.jpg", "web_768x512_420_q85_progressive.jpg",
                     "web_1024x768_420_q90.jpg")
REAL_LLAVA_FIXTURES = ("coco_640x480_420_q85.jpg", "coco_640x427_grey.jpg")
REAL_DPO_FIXTURES = ("imagenet_500x375_420_q75.jpg", "imagenet_500x375_cmyk.jpg")
REAL_TRUNCATED = "cov_640x480_truncated.jpg"
REAL_PNG_EVERY = 8
REAL_FILTERS = ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4))
REAL_SHARDS, REAL_SFT_SHARDS, REAL_PER_SHARD = 8, 4, 64
REAL_FORMAT_SAMPLES = 32     # each of the JPEG-only and PNG-only shards the loaders are timed on
REAL_LLAVA_IMAGES = 16
REAL_DPO_PAIRS = 21          # one with a corrupt image: 2 batches of 10 an epoch
JPEG_DECODES = 20            # the jpeg phase's decodes a fixture (their median is printed)
IMAGE_DECODES = 20           # the images phase's, likewise
# the other formats in the real-data sets (unigen_tpu_torch/data/assets/images/, written
# with PIL from seed 0): one image in REAL_OTHER_EVERY of the t2i shards and the DPO pairs
# (the WebPs in turn), one in 4 of the LLaVA folder (a GIF under a .jpg name, as OCR-VQA
# ships them, a BMP, a TIFF and a PPM in turn): (fixture, extension)
REAL_OTHER_EVERY = 8
REAL_T2I_OTHERS = (("web_640x480_q80.webp", ".webp"), ("web_500x333_q30_m6.webp", ".webp"),
                   ("web_301x203_lossless.webp", ".webp"), ("web_161x97_alpha.webp", ".webp"))
REAL_LLAVA_OTHERS = (("ocrvqa_300x450.gif", ".jpg"), ("scan_320x240_8bit.bmp", ".bmp"),
                     ("scan_321x241_lzw_predictor.tif", ".tif"), ("imagenet_200x150.ppm", ".ppm"))
REAL_DPO_OTHERS = (("web_257x129_palette.webp", ".webp"), ("web_301x203_lossless.webp", ".webp"))
# free-running: more steps than the prefetch thread holds (data/prefetch.DEPTH + 1)
REAL_WARM, REAL_TIMED, REAL_LOADER_BATCHES, REAL_FREE_STEPS = 1, 2, 3, 4
SERVING_PROMPTS = ("a photo of a red cube and a blue sphere", "a cat sleeping on a windowsill",
                   "a lighthouse at dusk", "two cups of coffee on a table",
                   "a green bus in the rain", "a watercolor of a fox")


TRAINING_PATHS = ("train", "sft", "sft_packed", "dpo", "cotv_post_sft", "sft_naflex",
                  "pt2_real", "sft_real", "dpo_real")


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def call_ms(fn, iters: int) -> float:
    """Wall time per call of back-to-back calls, between CUDA events: the
    device's time when it is the slower side, else the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class EventMs(float):
    """A time taken by CUDA events (``call_ms``) because the profiler
    recorded no device time: it counts the host's time between launches
    where the host is the slower side. ``_measured`` names such fields in
    the row's ``timed_by``."""


# calls timed by CUDA events because the profiler recorded no device time
EVENT_TIMED = []


def device_traces(fn, iters: int):
    """The device kernels that ``iters`` calls of ``fn`` launch, one
    [(name, microseconds)] list a trace (``utils/trace_analysis.py``'s
    ``device_traces``: traced until two traces agree). If no trace holds a
    device record, the caching allocator's free blocks are released and it
    traces once more; then it fails."""
    import torch
    from unigen_tpu_torch.utils import trace_analysis as TA
    try:
        return TA.device_traces(fn, iters)
    except TA.NoDeviceTime as e:
        print(f"  the profiler recorded no device time ({e}); card memory allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB; tracing again after "
              "empty_cache")
        torch.cuda.empty_cache()
        try:
            return TA.device_traces(fn, iters)
        except TA.NoDeviceTime as e2:
            raise Failed(str(e2)) from None


def time_ms(fn, iters: int) -> float:
    """Device time per call: the summed durations of the kernels that ``fn``
    launches over ``iters`` calls (``device_traces``; the mean of the fullest
    traces counts). Unlike ``call_ms`` it does not count the host's time
    between launches, which at decode shapes is longer than the kernels
    themselves. Where the profiler records no device time even after a
    retry, it times by CUDA events instead (``call_ms``, which counts the
    host's time where the host is the slower side), says so, and records
    the call in ``EVENT_TIMED``; the time is an ``EventMs``."""
    from unigen_tpu_torch.utils import trace_analysis as TA
    try:
        return TA.traces_ms(device_traces(fn, iters), iters)
    except Failed as e:
        ms = EventMs(call_ms(fn, iters))
        EVENT_TIMED.append(ms)
        print(f"  {e}: timed by CUDA events instead, {ms:.4f} ms a call")
        return ms


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _err_tol(got, ref, rtol):
    """(max |got - ref|, rtol x max(1, max |ref|))."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, rtol * max(1.0, ref.abs().max().item())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa_ms(q, k, v, mask, iters):
    """One torch call computing the same attention (a yardstick, never used by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)


def _measured(err, ms, plain_ms, lib_ms, b_ms, by, at):
    """The JSON fields of one timed kernel phase; ``at`` names the shape.
    ``timed_by`` says how each of the three times was taken: "profiler" (the
    kernels' device time) or "cuda_events" (an ``EventMs``)."""
    timed_by = {k: "cuda_events" if isinstance(t, EventMs) else "profiler"
                for k, t in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms))
                if t is not None}
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms, at=at, timed_by=timed_by)


def kv_read_bytes(k, kvalid) -> int:
    """The K and V bytes a key-masked attention must read: the visible
    slots' rows only (``kvalid`` [B, S]; k [B, S, KVH, Dh]), not the whole
    cache."""
    return int(kvalid.sum().item()) * 2 * k.shape[2] * k.shape[3] * k.element_size()


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def attn_flops(vis, h, kvh, dh):
    """The operations masked attention needs under visibility ``vis`` [B, 1,
    Lq, S]: q.k and p.v on each visible (query, key) pair of every head, and
    for a batch row with fully masked queries the mean of V over all keys
    once per KV head (every such query's output is that mean), not once per
    query."""
    dead_batches = (~vis.any(-1)).flatten(1).any(-1).sum().item()
    return 4.0 * h * dh * vis.sum().item() + 1.0 * kvh * dh * vis.shape[-1] * dead_batches


def _attn_inputs(gen, b, lq, s, h, kvh, dh, dtype):
    import torch
    q = torch.randn((b, lq, h, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kvh, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kvh, dh), generator=gen, device="cuda").to(dtype)
    return q, k, v


def phase_chunk(gen, b, lq, lp, dtype, rtol, iters, timed, at="t2i chunk step", heads=(12, 2)):
    """Chunk attention: q [b, lq, 12, 128] against a cache of lp prefix slots
    (left pads masked out) plus the lq chunk slots (``heads``: query and KV
    heads, a model rank's under tensor parallelism). The tolerance is
    relative to the largest output magnitude."""
    import torch
    from unigen_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
    (h, kvh), dh = heads, 128
    s = lp + lq
    q, k, v = _attn_inputs(gen, b, lq, s, h, kvh, dh, dtype)
    pads = torch.arange(b, device="cuda") * 7 % (lp // 2)        # left pads per row
    kvalid = torch.arange(s, device="cuda")[None] >= pads[:, None]
    got = chunk_attention(q, k, v, kvalid)
    ref = chunk_attention_plain(q, k, v, kvalid)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "chunk_attention output not finite")
    print(f"  chunk_attention {dtype} q{list(q.shape)} S={s}: max_abs_err {err:.3e} "
          f"(tol {tol:.2e})")
    check(err <= tol, f"chunk_attention {dtype} S={s} disagrees with its plain version")
    if not timed:
        return None
    ms = time_ms(lambda: chunk_attention(q, k, v, kvalid), iters)
    plain_ms = time_ms(lambda: chunk_attention_plain(q, k, v, kvalid), iters)
    lib_ms = sdpa_ms(q, k, v, kvalid[:, None, None, :], iters)
    flops = 4.0 * h * dh * lq * kvalid.sum().item()
    b_ms, by = bound(flops, kv_read_bytes(k, kvalid) + nbytes(q, kvalid, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, f"{at} q [{b},{lq},{h},{dh}], S={s}")


def phase_flash(gen, b, l, dtype, rtol, iters, timed, ragged_bits=False, heads=(12, 2),
                at="t2i prefill"):
    """Flash attention over a left-padded prefix (pad bit, causal); with
    ``ragged_bits`` also bidir_q / bidir_k / segment bits and all-pad rows."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    (h, kvh), dh = heads, 128
    q, k, v = _attn_inputs(gen, b, l, l, h, kvh, dh, dtype)
    pos = torch.arange(l, device="cuda")[None]
    pads = torch.arange(b, device="cuda")[:, None] * 11 % (l // 2)
    pad = pos < pads
    z = torch.zeros_like(pad)
    meta = M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)
    if ragged_bits:
        pad = pad.clone()
        pad[0] = True                                             # one all-pad row
        meta = M.AttnMeta(pad=pad, bidir_q=(pos % 5 == 0).expand(b, l) & ~pad,
                          bidir_k=(pos % 7 == 3).expand(b, l) & ~pad,
                          seg=(pos >= l // 3).to(torch.int32).expand(b, l))
    bits = M.pack_meta(meta)
    got = flash_attention(q, k, v, bits)
    ref = flash_attention_plain(q, k, v, bits)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "flash_attention output not finite")
    print(f"  flash_attention {dtype} q{list(q.shape)}{' omni/seg bits' if ragged_bits else ''}:"
          f" max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"flash_attention {dtype} L={l} disagrees with its plain version")
    if ragged_bits:
        g = torch.randn((b, l, h, dh), generator=gen, device="cuda").to(dtype)
        worst = flash_grads_gate(q, k, v, bits, g, f"flash backward {dtype} L={l}")[2]
        print(f"    its backward kernel: dq, dk, dv within the gate (largest err/tol {worst:.3f}), "
              "two runs bit-equal")
    if not timed:
        return None
    ms = time_ms(lambda: flash_attention(q, k, v, bits), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, bits), iters)
    vis = meta.visibility()
    lib_ms = sdpa_ms(q, k, v, vis, iters)
    b_ms, by = bound(attn_flops(vis, h, kvh, dh), nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, f"{at} q [{b},{l},{h},{dh}]")


# Every kernel-3 call of the MAGViTv2 decoder (models/magvit.py, MagvitConfig(),
# batch 4): (H = W, C, Cout, GroupNorm before the conv, launches a t2i batch).
# 44 launches, 40 with GroupNorm. The counts are what run_flagship checks its
# census against; the kernels line takes its counts from that census.
DECODER_CONVS = ((16, 512, 512, True, 10), (32, 512, 512, False, 1), (32, 512, 256, True, 1),
                 (32, 256, 256, True, 7), (64, 256, 256, False, 1), (64, 256, 256, True, 6),
                 (128, 256, 256, False, 1), (128, 256, 128, True, 1), (128, 128, 128, True, 7),
                 (256, 128, 128, False, 1), (256, 128, 128, True, 8))


# Every kernel-3 call of the MAGViTv2 encoder (models/magvit.py, MagvitConfig(),
# batch 8, the understand_discrete phase, fp32 like its pixels): (H = W, C,
# Cout, GroupNorm before the conv, launches a call): 40 launches, all with GroupNorm.
ENCODER_CONVS = ((256, 128, 128, True, 8), (128, 128, 256, True, 1), (128, 256, 256, True, 5),
                 (64, 256, 256, True, 8), (32, 256, 512, True, 1), (32, 512, 512, True, 5),
                 (16, 512, 512, True, 12))


def _conv_inputs(gen, b, h, w, c, cout, dtype, gn, shift=0.5, spread=2.0):
    import torch
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") * spread + shift).to(dtype)
    conv_p = {"kernel": (torch.randn((3, 3, c, cout), generator=gen, device="cuda")
                         * (9 * c) ** -0.5).to(dtype),
              "bias": (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(dtype)}
    gn_p = {"scale": (1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")).to(dtype),
            "bias": (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)} \
        if gn else None
    return x, conv_p, gn_p


def phase_gn(gen, b, h, w, c, dtype, shift=0.5, spread=2.0, p_dtype=None):
    """GroupNorm statistics folded into (A, B): the kernel against its plain
    version within 1e-5 of max(|A|, |B|). Returns the max abs error."""
    import torch
    from unigen_tpu_torch.ops.fused_conv import gn_affine, gn_affine_plain
    x, _, gn_p = _conv_inputs(gen, b, h, w, c, 1, dtype, True, shift, spread)
    if p_dtype is not None:
        gn_p = {k: v.to(p_dtype) for k, v in gn_p.items()}
    got, ref = gn_affine(gn_p, x), gn_affine_plain(gn_p, x)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()
    check(got.shape == (b, 2, c) and bool(torch.isfinite(got).all()), "gn_affine output")
    check(err <= tol, f"gn_affine {dtype} {[b, h, w, c]} (x = {shift} + {spread} N(0, 1)): "
          f"max_abs_err {err:.3e} > {tol:.3e}")
    return err


def phase_conv(gen, b, h, w, c, cout, dtype, rtol, iters=0, gn=True, part="decoder"):
    """Fused GN + swish + conv3x3 at [b, h, w, c] -> cout; the tolerance is
    relative to the largest output magnitude. Timed (``iters`` > 0): the
    whole wrapper (statistics + conv), its plain version, cuDNN's
    ``group_norm + silu + conv2d`` (``conv2d`` alone without GN) and, with
    GN, the statistics launch alone against its plain version."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import fused_conv as FC
    x, conv_p, gn_p = _conv_inputs(gen, b, h, w, c, cout, dtype, gn)
    got = FC.conv3x3_gn_swish(conv_p, gn_p, x)
    ref = FC.conv3x3_gn_swish_plain(conv_p, gn_p, x)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "conv3x3_gn_swish output not finite")
    print(f"  conv3x3_gn_swish {dtype} x{list(x.shape)}->{cout}{'' if gn else ' (no GN)'}: "
          f"max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"conv3x3_gn_swish {dtype} {list(x.shape)} disagrees")
    if not iters:
        return None
    ms = time_ms(lambda: FC.conv3x3_gn_swish(conv_p, gn_p, x), iters)
    plain_ms = time_ms(lambda: FC.conv3x3_gn_swish_plain(conv_p, gn_p, x), iters)
    xc = x.permute(0, 3, 1, 2)
    wc = conv_p["kernel"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        y = F.silu(F.group_norm(xc, min(32, c), gn_p["scale"], gn_p["bias"], 1e-6)) if gn else xc
        return F.conv2d(y, wc, conv_p["bias"], padding=1)
    lib_ms = time_ms(library, iters)
    ab_bytes = 2 * b * c * 4 if gn else 0
    b_ms, by = bound(2.0 * b * h * w * 9 * c * cout,
                     nbytes(x, conv_p["kernel"], conv_p["bias"], got) + ab_bytes,
                     BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
    out = dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                         f"MAGViT {part} [{b},{h},{w},{c}]->{cout}{'' if gn else ', no GN'}"
                         f"{'' if dtype == torch.bfloat16 else f', {dtype}'}"),
               launches_per_batch=None)
    line = (f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"({'group_norm+silu+conv2d' if gn else 'conv2d'}) {lib_ms:.4f}  "
            f"bound_ms {b_ms:.4f} ({by})")
    if gn:
        ab = FC.gn_affine(gn_p, x)
        ab_ref = FC.gn_affine_plain(gn_p, x)
        gn_err = (ab - ab_ref).abs().max().item()
        check(gn_err <= 1e-5 * ab_ref.abs().max().item(), f"gn_affine {list(x.shape)} disagrees")
        gn_ms = time_ms(lambda: FC.gn_affine(gn_p, x), iters)
        gn_plain = time_ms(lambda: FC.gn_affine_plain(gn_p, x), iters)
        gb_ms, gby = bound(0.0, nbytes(x, gn_p["scale"], gn_p["bias"], ab), BF16_PEAK)
        out["gn"] = dict(_measured(gn_err, gn_ms, gn_plain, None, gb_ms, gby,
                                   f"GroupNorm statistics of [{b},{h},{w},{c}]"),
                         launches_per_batch=None)
        line += (f"\n    gn_affine alone ms {gn_ms:.4f}  plain_ms {gn_plain:.4f}  "
                 f"bound_ms {gb_ms:.4f} ({gby})  max_abs_err {gn_err:.3e}")
    print(line)
    return out


def run_conv_phases(results):
    """Kernel 3 and the GroupNorm statistics at every decoder shape (bf16,
    batch 4, timed) and every encoder shape (fp32, batch 8, timed), the statistics at a large mean against the spread and at
    C < 32, and the conv at ragged shapes, C != Cout, C % 8 != 0 (plain loads)
    and in fp32."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase: kernels, conv3x3_gn_swish and gn_affine at the decoder's 11 shapes")
    shapes = [phase_conv(gen, 4, hw, hw, c, cout, bf16, 2 ** -6, 20 if hw < 128 else 5, gn)
              for hw, c, cout, gn, _ in DECODER_CONVS]
    conv_rows = [{k: v for k, v in s.items() if k != "gn"} for s in shapes]
    gn_rows = [s.get("gn") for s in shapes]
    # the last shape, [4, 256, 256, 128] -> 128 with GN, heads each kernel's row;
    # launches_per_batch and batch_ms stay null unless the flagship phase counts them
    results["conv3x3_gn_swish"] = conv_rows[-1]
    conv_rows[-1].update(shapes=conv_rows[:-1], batch_ms=None)
    results["gn_affine"] = gn_rows[-1]
    gn_rows[-1].update(shapes=[r for r in gn_rows[:-1] if r], batch_ms=None)
    results["conv_rows"] = [(key[:4], conv, gn_row)
                            for key, conv, gn_row in zip(DECODER_CONVS, conv_rows, gn_rows)]
    print("phase: kernels, conv3x3_gn_swish and gn_affine at the encoder's 7 shapes (batch 8, "
          "fp32: understand_discrete encodes fp32 pixels, and the encoder runs in their dtype)")
    enc = [phase_conv(gen, 8, hw, hw, c, cout, f32, 1e-4, 10 if hw < 128 else 3, gn,
                      part="encoder") for hw, c, cout, gn, _ in ENCODER_CONVS]
    enc_rows = [{k: v for k, v in e.items() if k != "gn"} for e in enc]
    conv_rows[-1]["shapes"] += enc_rows
    gn_rows[-1]["shapes"] += [e["gn"] for e in enc]
    results["encoder_conv_rows"] = [(key[:4], row, e["gn"])
                                    for key, row, e in zip(ENCODER_CONVS, enc_rows, enc)]
    worst = 0.0
    for b, h, w, c, dtype, shift, p_dtype in ((4, 256, 256, 128, bf16, 100.0, None),
                                              (4, 256, 256, 128, f32, 100.0, None),
                                              (2, 19, 37, 16, bf16, 100.0, None),
                                              (2, 19, 37, 12, f32, 0.5, bf16),
                                              (2, 19, 37, 96, bf16, 0.5, f32)):
        worst = max(worst, phase_gn(gen, b, h, w, c, dtype, shift, 1.0, p_dtype))
    print("  gn_affine at x = 100 + N(0, 1) (bf16 and fp32, C 128 and 16), C 12 and 96 with "
          f"scale and bias in another type: within 1e-5 of max |A|, |B| (largest err {worst:.3e})")
    phase_conv(gen, 2, 37, 37, 96, 80, bf16, 2 ** -6)         # ragged tiles, C != Cout
    phase_conv(gen, 2, 37, 37, 96, 80, bf16, 2 ** -6, gn=False)
    phase_conv(gen, 2, 19, 37, 16, 24, bf16, 2 ** -6)         # one channel chunk
    phase_conv(gen, 2, 19, 37, 24, 40, bf16, 2 ** -6)         # channels past C by cp.async
    phase_conv(gen, 2, 19, 37, 12, 20, bf16, 2 ** -6)         # C % 8 != 0: plain loads
    phase_conv(gen, 2, 64, 64, 256, 128, f32, 1e-4)
    phase_conv(gen, 2, 19, 37, 96, 80, f32, 1e-4, gn=False)


_PIPELINES = {}


def flagship_pipeline(vision=False):
    """The seed-0 bf16 flagship pipeline (with the SigLIP tower when
    ``vision``), built once and shared by the phases that drive it and by
    the kernels phase, which takes its prompt layouts from it."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    if vision not in _PIPELINES:
        t0 = time.perf_counter()
        _PIPELINES[vision] = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda",
                                            seed=0, vision=vision)
        torch.cuda.synchronize()
        print(f"  build_pipeline('flagship', vision={vision}) {time.perf_counter() - t0:.2f} s")
    return _PIPELINES[vision]


def understand_prompt_shape(pipe, questions=QUESTIONS, system_prompt_ids=None):
    """(L, prompt lengths, part1's length) of the understand prefill, from
    the pipeline's ``_vqa_parts``: part1 (the system prompt, if any, and the
    prefix), the image tokens and part2 (<|eoi|> and each question's template
    without its first token, right-padded)."""
    p = pipe.vision_cfg.num_patches
    part1, part2, q_lens = pipe._vqa_parts(questions, p, system_prompt_ids)
    return (part1.shape[1] + p + part2.shape[1], (part1.shape[1] + p + q_lens).tolist(),
            part1.shape[1])


def cot_rating_shape(vpipe):
    """(L, prompt lengths, part1's length) of the CoT vision rater's
    longest understand prefill: COT_SAMPLES rows of one rule question of
    COT_PROMPT, after the Qwen system prompt."""
    import numpy as np
    from unigen_tpu_torch.evaluation import cot
    sys_ids = np.asarray([vpipe.prompting._tokenize(cot.QWEN_SYSTEM_PROMPT)[0]])
    shapes = [understand_prompt_shape(vpipe, [cot.MMU_RATING_USER_PROMPT["rule"].format(
        context=q)] * COT_SAMPLES, sys_ids) for q in cot.geneval_prompt2questions(COT_PROMPT)]
    return max(shapes, key=lambda sh: sh[0])


def t2i_prefix_layout(pipe, prompts=PROMPTS, text_len=128, mode="ar"):
    """(Lp, left pads of each of the 2B rows) of a t2i prefill: the cond and
    uncond rows of the pipeline's ``prompt_ids`` without the image block the
    sampler cuts off: ``[img x N][eoi]`` in AR mode, ``[soi][img x N][eoi]``
    in mask mode."""
    import numpy as np
    ids, uncond = pipe.prompt_ids(list(prompts), text_len)
    cut = pipe.cfg.num_vq_tokens + (1 if mode == "ar" else 2)
    prompt = np.concatenate([ids, uncond])[:, :-cut]
    return prompt.shape[1], (prompt == pipe.prompting.pad_id).sum(axis=1).tolist()


def mmu_prompt_layout(pipe, questions=QUESTIONS):
    """(ids [B, max_seq_len], prompt lengths, <|eoi|> id) of the
    understand_discrete prompt, from the pipeline's ``_mmu_prompt`` (the
    codes' values do not move the mask)."""
    import numpy as np
    codes = np.zeros((len(questions), pipe.cfg.num_vq_tokens), np.int64)
    ids, plen = pipe._mmu_prompt(codes, questions)
    return ids, plen.tolist(), pipe.prompting.sptids_dict["<|eoi|>"]


def score_conts(pipe):
    import numpy as np
    return [np.asarray(pipe.prompting._tokenize(c)[0]) for c in CONTINUATIONS]


def score_layout(pipe, questions=QUESTIONS):
    """(L, prompt lengths) of the scoring forward, from the pipeline's
    ``_score_parts`` at ``score_continuations``' bucket: part1, the image
    tokens and part2c."""
    from unigen_tpu_torch.pipeline import SCORE_LENGTH_BUCKET
    p = pipe.vision_cfg.num_patches
    part1, part2c, _, l2_real = pipe._score_parts(questions, score_conts(pipe), p, None,
                                                  SCORE_LENGTH_BUCKET)
    off = part1.shape[1] + p
    return off + part2c.shape[1], (off + l2_real).tolist()


def phase_flash_siglip(gen, b, dtype, rtol, iters):
    """SigLIP-SO400M attention: q/k/v [b, 729, 16, 72] zero-padded to the
    kernel's head dim 80, every token bidirectional, scale 72^-1/2."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_plain,
                                                      kernel_head_dim)
    l, h, dh = 729, 16, 72
    q, k, v = _attn_inputs(gen, b, l, l, h, h, dh, dtype)
    pad = kernel_head_dim(dh) - dh
    qp, kp, vp = (F.pad(t, (0, pad)) for t in (q, k, v))
    bits = torch.full((b, l), M.BIDIRQ_BIT, dtype=torch.int32, device="cuda")
    got = flash_attention(qp, kp, vp, bits, scale=dh ** -0.5)[..., :dh]
    ref = flash_attention_plain(qp, kp, vp, bits, scale=dh ** -0.5)[..., :dh]
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "flash_attention (SigLIP) output not finite")
    print(f"  flash_attention {dtype} SigLIP q{list(q.shape)} padded to {dh + pad}: "
          f"max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, "flash_attention at the SigLIP shape disagrees with its plain version")
    ms = time_ms(lambda: flash_attention(qp, kp, vp, bits, scale=dh ** -0.5), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(qp, kp, vp, bits, scale=dh ** -0.5), 3)
    lib_ms = sdpa_ms(q, k, v, None, iters)
    b_ms, by = bound(4.0 * b * h * dh * l * l, nbytes(q, k, v, bits, got),
                     BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa, dh 72) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by,
                     f"SigLIP q/k/v [{b},{l},{h},{dh}->{dh + pad}], all bidirectional"
                     f"{'' if dtype == torch.bfloat16 else f', {dtype}'}")


def phase_flash_mmu(gen, b, l, prompt_len, dtype, rtol, iters):
    """The understanding prefill: q [b, l, 12, 128], k/v [b, l, 2, 128],
    mmu_vit metadata (729-key image block after 3 prefix tokens, pads from
    each row's prompt length)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    plen = torch.as_tensor(prompt_len, device="cuda")
    meta = M.mmu_vit_attn_meta(b, l, num_tokens=729, prefix_length=3, prompt_len=plen)
    return phase_flash_meta(gen, meta, dtype, rtol, iters,
                            f"understand prefill q [{b},{l},12,128], mmu_vit meta")


def phase_flash_meta(gen, meta, dtype, rtol, iters, at, heads=(12, 2)):
    """Flash attention of q [b, l, 12, 128], k/v [b, l, 2, 128] under the
    metadata ``meta`` (a path's prefill); timed when ``iters`` > 0.
    ``heads``: query and KV heads (a model rank's under tensor parallelism)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    (h, kvh), dh = heads, 128
    b, l = meta.pad.shape
    q, k, v = _attn_inputs(gen, b, l, l, h, kvh, dh, dtype)
    bits = M.pack_meta(meta)
    got = flash_attention(q, k, v, bits)
    ref = flash_attention_plain(q, k, v, bits)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), f"flash_attention ({at}) output not finite")
    print(f"  flash_attention {dtype} {at}: max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"flash_attention at {at} disagrees with its plain version")
    if not iters:
        return None
    ms = time_ms(lambda: flash_attention(q, k, v, bits), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, bits), 3)
    vis = meta.visibility()
    lib_ms = sdpa_ms(q, k, v, vis, iters)
    b_ms, by = bound(attn_flops(vis, h, kvh, dh), nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, at)


def phase_chunk_decode(gen, b, l, prompt_len, step, dtype, rtol, iters, timed=True,
                       new_tokens=NEW_TOKENS, masked=False, left_pads=None,
                       at="understand decode step", heads=(12, 2)):
    """One understanding decode step: q [b, 1, 12, 128] against the cache of
    l + new_tokens slots, visible = the row's prompt slots and the decoded
    slots (with ``left_pads``, the prompt slots from each row's pads on: the
    AR t2i step). Both routes of the kernel (unsplit, and split over the keys at 8
    and at 15 splits) are held against the plain version through the
    wrapper's ``_launch``; with ``masked``, keys 128..255 are invisible to
    every row (a fully masked split at 8 splits) and row 0 sees no key at
    all. Timed warm (one K/V pair, which stays in L2) and cold (a cycle of
    K/V pairs larger than L2, as the path's 28 layers' caches are), the
    chosen route only. The
    bound reads the visible slots' K/V only (``kv_read_bytes``).
    ``heads``: query and KV heads (a model rank's under tensor parallelism)."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import chunk_attention as CA
    (h, kvh), dh = heads, 128
    s = l + new_tokens
    q, k, v = _attn_inputs(gen, b, 1, s, h, kvh, dh, dtype)
    slots = torch.arange(s, device="cuda")[None]
    plen = torch.as_tensor(prompt_len, device="cuda")[:, None]
    kvalid = (slots < plen) | ((slots >= l) & (slots <= l + step))
    if left_pads is not None:
        kvalid &= slots >= torch.as_tensor(left_pads, device="cuda")[:, None]
    if masked:
        kvalid[:, 128:256] = False
        kvalid[0] = False
    ref = CA.chunk_attention_plain(q, k, v, kvalid)
    chosen = CA.kv_splits(b, 1, s, h, kvh)
    routes = sorted({1, 8, 15, chosen})
    errs = {}
    for n in routes:
        got = CA._launch(q, k, v, kvalid, n)
        torch.cuda.synchronize()
        errs[n], tol = _err_tol(got, ref, rtol)
        check(bool(torch.isfinite(got).all()), f"chunk_attention (decode, {n} splits) not finite")
        check(errs[n] <= tol, f"chunk_attention {dtype} decode S={s} with {n} splits: "
              f"max_abs_err {errs[n]:.3e} (tol {tol:.2e})")
    before = CA.chunk_attention.launches
    got = CA.chunk_attention(q, k, v, kvalid)
    check(CA.chunk_attention.launches == before + 1, "chunk_attention counted no single launch")
    check(bool(torch.equal(got, CA._launch(q, k, v, kvalid, chosen))),
          "chunk_attention did not take the route kv_splits names")
    err = errs[chosen]
    print(f"  chunk_attention {dtype} decode q{list(q.shape)} S={s}"
          f"{' (a masked split, a masked row)' if masked else ''}: the rule splits {chosen}x; "
          "max_abs_err by splits " + ", ".join(f"{n}: {e:.3e}" for n, e in errs.items())
          + f" (tol {tol:.2e})")
    if not timed:
        return None
    check(chosen > 1, f"the decode step q{list(q.shape)} S={s} did not take the split route")
    ms = time_ms(lambda: CA.chunk_attention(q, k, v, kvalid), iters)
    plain_ms = time_ms(lambda: CA.chunk_attention_plain(q, k, v, kvalid), iters)
    lib_ms = sdpa_ms(q, k, v, kvalid[:, None, None, :], iters)
    # cold: 10 K/V pairs of this shape (75 MB) against 50 MB of L2
    pairs = [(k, v)] + [tuple(_attn_inputs(gen, b, 1, s, h, kvh, dh, dtype)[1:])
                        for _ in range(9)]

    def cold(fn):
        ring = itertools.cycle(pairs)
        return time_ms(lambda: fn(*next(ring)), 5 * len(pairs))
    ms_cold = cold(lambda kk, vv: CA._launch(q, kk, vv, kvalid, chosen))
    mask4 = kvalid[:, None, None, :]
    lib_cold = cold(lambda kk, vv: F.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask4,
        enable_gqa=True))
    b_ms, by = bound(4.0 * h * dh * kvalid.sum().item(),
                     kv_read_bytes(k, kvalid) + nbytes(q, kvalid, got), BF16_PEAK)
    print(f"    ms {ms:.4f} ({chosen} splits)  plain_ms {plain_ms:.4f}  library_ms (sdpa) "
          f"{lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    print(f"    cold ms {ms_cold:.4f}; sdpa cold {lib_cold:.4f}")
    return dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                          f"{at} q [{b},1,{h},{dh}], S={s}, {chosen} splits"),
                ms_cold=ms_cold)


def phase_chunk_verify(gen, b, k, s, dtype, rtol, iters, timed, q_range=None,
                       at="speculative verify step"):
    """Kernel 1 with its per-row causal offset at the speculative verify
    step: q [b, k+1, 12, 128] against a per-row cache of s slots, every key
    valid, query j of row r seeing the slots <= q_start[r] + j, q_start
    drawn in ``q_range`` (the serving trace's indices: a 600-token prompt
    and at most 224 - k - 1 accepted tokens). Held against the plain version
    on every route (unsplit; split where the rows fit one m16 tile), and
    with a random key mask too; an offset past the last key equals the call
    without one bit for bit. Timed warm and cold (a cycle of K/V pairs
    larger than L2, as the 28 layers' caches are) against SDPA with the
    boolean [B, 1, l, S] mask."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import chunk_attention as CA
    h, kvh, dh = 12, 2, 128
    lq = k + 1
    lo, hi = q_range or (SERVE_PROMPT, SERVE_PROMPT + 224 - k)
    q, kk, v = _attn_inputs(gen, b, lq, s, h, kvh, dh, dtype)
    kvalid = torch.ones((b, s), dtype=torch.bool, device="cuda")
    q_start = torch.randint(lo, hi, (b,), generator=gen, device="cuda", dtype=torch.int32)
    rnd = torch.rand((b, s), generator=gen, device="cuda") < 0.9
    rnd[:, 0] = True
    chosen = CA.kv_splits(b, lq, s, h, kvh)
    errs = {}
    for name, mask in (("all keys", kvalid), ("random keys", rnd)):
        ref = CA.chunk_attention_plain(q, kk, v, mask, q_start)
        for n in sorted({1, chosen}):
            got = CA._launch(q, kk, v, mask, n, q_start)
            torch.cuda.synchronize()
            errs[(name, n)], tol = _err_tol(got, ref, rtol)
            check(bool(torch.isfinite(got).all()), f"chunk_attention (verify, {n} splits) not finite")
            check(errs[(name, n)] <= tol, f"chunk_attention {dtype} verify q{list(q.shape)} S={s} "
                  f"{name}, {n} splits: max_abs_err {errs[(name, n)]:.3e} (tol {tol:.2e})")
        past = torch.full((b,), s, dtype=torch.int32, device="cuda")
        for n in sorted({1, chosen}):
            check(bool(torch.equal(CA._launch(q, kk, v, mask, n, past), CA._launch(q, kk, v, mask, n))),
                  f"chunk_attention verify ({name}, {n} splits): an offset past the last key "
                  "differs from the call without one")
    before = CA.chunk_attention.launches
    got = CA.chunk_attention(q, kk, v, kvalid, q_start)
    check(CA.chunk_attention.launches == before + 1, "chunk_attention counted no single launch")
    check(bool(torch.equal(got, CA._launch(q, kk, v, kvalid, chosen, q_start))),
          "chunk_attention did not take the route kv_splits names")
    err = errs[("all keys", chosen)]
    print(f"  chunk_attention {dtype} verify q{list(q.shape)} S={s}, q_start in [{lo}, {hi}): "
          f"the rule splits {chosen}x; max_abs_err " + ", ".join(
              f"{name} {n} splits {e:.3e}" for (name, n), e in errs.items())
          + f" (tol {tol:.2e}); an offset past the last key equals none, bit for bit")
    if not timed:
        return None
    ms = time_ms(lambda: CA.chunk_attention(q, kk, v, kvalid, q_start), iters)
    plain_ms = time_ms(lambda: CA.chunk_attention_plain(q, kk, v, kvalid, q_start), iters)
    vis = (torch.arange(s, device="cuda") <= q_start[:, None, None]
           + torch.arange(lq, device="cuda")[:, None])[:, None]        # [B, 1, lq, S]
    lib_ms = sdpa_ms(q, kk, v, vis, iters)
    pairs = [(kk, v)] + [tuple(_attn_inputs(gen, b, 1, s, h, kvh, dh, dtype)[1:])
                         for _ in range(9)]

    def cold(fn):
        ring = itertools.cycle(pairs)
        return time_ms(lambda: fn(*next(ring)), 5 * len(pairs))
    ms_cold = cold(lambda k_, v_: CA.chunk_attention(q, k_, v_, kvalid, q_start))
    lib_cold = cold(lambda k_, v_: F.scaled_dot_product_attention(
        q.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2), attn_mask=vis,
        enable_gqa=True))
    # row r's queries see the slots below min(q_start[r] + lq, S): only those
    # K/V rows and key-mask entries need reading, not the whole cache
    need = int((q_start.long() + lq).clamp(max=s).sum().item())
    kv_bytes = need * (2 * kvh * dh * kk.element_size() + kvalid.element_size())
    b_ms, by = bound(4.0 * h * dh * vis.sum().item(), kv_bytes + nbytes(q, q_start, got),
                     BF16_PEAK)
    print(f"    ms {ms:.4f} (cold {ms_cold:.4f})  plain_ms {plain_ms:.4f}  library_ms (sdpa, "
          f"bool mask) {lib_ms:.4f} (cold {lib_cold:.4f})  bound_ms {b_ms:.4f} ({by})")
    return dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                          f"{at} q [{b},{lq},12,128], S={s}, per-row q_start, {chosen} splits"),
                ms_cold=ms_cold, library_ms_cold=lib_cold)


def run_spec_kernel_phases(results):
    """Kernel 1 with its per-row causal offset at the verify shapes of the
    serving trace (k 2 and 4, bf16 timed, fp32 held), at the split route's
    rows (k 1: 12 rows) and at a ragged cache; kernel 4 and the
    quantization at the verify step's T = 32 (k + 1) rows, 96 and 160 (the
    prefill body), bit for bit; kernel 2 at the admission of one request
    of 640 (serve_entry's and serving_http's admissions)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    b = SERVE_SLOTS
    print(f"phase: kernels at the speculative verify step ({b} slots, cache {SERVE_MAX_LEN}; "
          "kernel 1 with its per-row causal offset, kernel 4 at T = 32 (k + 1))")
    for k in (2, 4):
        results["chunk_attention"]["shapes"].append(
            phase_chunk_verify(gen, b, k, SERVE_MAX_LEN, bf16, 2 ** -7, 50, True))
        phase_chunk_verify(gen, b, k, SERVE_MAX_LEN, f32, 2e-5, 0, False)
    for dtype, rtol in ((bf16, 2 ** -7), (f32, 2e-5)):
        phase_chunk_verify(gen, b, 1, SERVE_MAX_LEN, dtype, rtol, 0, False)   # split route
        phase_chunk_verify(gen, 3, 2, 61, dtype, rtol, 0, False, q_range=(0, 59))
    for t in (32 * 3, 32 * 5):
        results["w4a8_matmul"]["shapes"] += [
            phase_w4a8(gen, t, 1536, 8960, 256, 50, True, "verify gate/up", bias=False),
            phase_w4a8(gen, t, 1536, 1536, 256, 50, True, "verify q/o"),
            phase_w4a8(gen, t, 1536, 256, 256, 50, True, "verify k/v"),
            phase_w4a8(gen, t, 8960, 1536, 256, 50, True, "verify down", bias=False),
            phase_w4a8(gen, t, 1536, 159867, 256, 10, True, "verify head", bias=False)]
        phase_quant(gen, t, 1536, bf16, 0, False, "verify")
        phase_quant(gen, t, 8960, bf16, 0, False, "verify down input")
    pad = torch.arange(SERVE_BUCKET, device="cuda")[None] >= SERVE_PROMPT // 10
    z = torch.zeros_like(pad)
    phase_flash_meta(gen, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z), bf16, 2 ** -7, 0,
                     f"one-request admission q [1,{SERVE_BUCKET},12,128], pad bits")


def phase_w4a8(gen, t, k, n, group, iters, timed, label="", bias=True):
    """Kernel 4 at [t, k] -> n (weights packed from a normal * k^-1/2 matrix;
    activations quantized from a bf16 normal by the plain version; a bf16
    bias, or with ``bias=False`` the fp32 zeros a layer without one gets).
    The product alone (``w4a8_matmul``, fp32 [t, Npad]) and the fused dense
    launch (``dense_int4_prequant``: product, ``* act_scale + bias``, cast;
    bf16 and, untimed, fp32 [t, n]) must equal their plain versions bit for
    bit, and at t <= 16 so must the route the wrapper does not choose (split
    over groups or not). Timed: the fused launch (what the path runs) against
    its plain version, its bound and bf16 ``F.linear`` (with the bias where
    the layer has one), and the whole layer, ``dense_int4`` (quantization +
    fused launch, what one layer enqueues), against the same ``F.linear``."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import int4
    from unigen_tpu_torch.ops.quantization import quantize_activations_plain
    bf16 = torch.bfloat16
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    dense = {"kernel": w}
    if bias:
        dense["bias"] = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(bf16)
    p = int4.quantize_dense_int4(dense, group)
    packed, scale = p[int4.KEY], p["scale4"]
    npad = packed.shape[1]
    x = torch.randn((t, k), generator=gen, device="cuda").to(bf16)
    x8, act = quantize_activations_plain(x)
    got = int4.w4a8_matmul(x8, packed, scale, group=group)
    check(bool(torch.equal(got, int4.w4a8_matmul_plain(x8, packed, scale, group=group))),
          f"w4a8_matmul {label} T={t} K={k} N={n} differs from its plain version")
    split = int4.splits_over_groups(t, npad)
    other_ms = None
    for out_dtype in ((bf16,) if timed else (bf16, torch.float32)):
        dref = int4.dense_int4_prequant_plain(p, x8, act, out_dtype)
        dgot = int4.dense_int4_prequant(p, x8, act, out_dtype)
        torch.cuda.synchronize()
        check(dgot.shape == (t, n) and bool(torch.isfinite(dgot).all()),
              f"w4a8 dense {label} output {tuple(dgot.shape)} not finite")
        check(bool(torch.equal(dgot, dref)), f"w4a8 dense {label} T={t} K={k} N={n} group {group} "
              f"{out_dtype} differs from its plain version")
        if t <= 16:    # the same layer on the route not chosen

            def other_path(od=out_dtype):
                return int4._dense_launch(x8, packed, scale, act, p["bias"], od, group, not split)
            check(bool(torch.equal(other_path(), dgot)),
                  f"w4a8 dense {label}: split and unsplit differ")
            if timed:
                other_ms = time_ms(other_path, iters)
    err = (dgot.float() - dref.float()).abs().max().item()
    layer_ref = int4.dense_int4_prequant_plain(p, x8, act, bf16)
    check(bool(torch.equal(int4.dense_int4(p, x), layer_ref)),
          f"dense_int4 {label} (quantization + fused launch) differs from the plain composition")
    print(f"  w4a8 {label} T={t} K={k} N={n} (Npad {npad}) group {group}"
          f"{', split over groups' if split else ''}: product, fused dense"
          f"{'' if timed else ' (bf16 and fp32)'}{' and the other route' if t <= 16 else ''}"
          " equal their plain versions bit for bit")
    if not timed:
        return None

    def fused():
        return int4.dense_int4_prequant(p, x8, act, bf16)
    ms = time_ms(fused, iters)
    matmul_ms = time_ms(lambda: int4.w4a8_matmul(x8, packed, scale, group=group), iters)
    plain_ms = time_ms(lambda: int4.dense_int4_prequant_plain(p, x8, act, bf16), 3)
    wb = (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).to(bf16)
    bb = p["bias"] if bias else None

    def library():
        return F.linear(x, wb, bb)
    lib_ms = time_ms(library, iters)
    layer_ms = time_ms(lambda: int4.dense_int4(p, x), iters)
    layer_call = call_ms(lambda: int4.dense_int4(p, x), iters)
    lib_call = call_ms(library, iters)
    # the first n columns of the padded weights are all the layer needs
    b_ms, by = bound(2.0 * t * k * n, nbytes(x8, packed[:, :n], scale[:, :n], act, p["bias"], dgot),
                     INT8_PEAK)
    print(f"    fused launch ms {ms:.4f}  (product alone, fp32 [T, Npad] {matmul_ms:.4f}"
          + (f"; {'unsplit' if split else 'split'} route {other_ms:.4f}" if other_ms else "")
          + f")  plain_ms {plain_ms:.4f}  library_ms (bf16 F.linear{' + bias' if bias else ''})"
          f" {lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    print(f"    layer (quantization + fused launch) device {layer_ms:.4f} ms, back to back "
          f"{layer_call:.4f} ms; bf16 F.linear back to back {lib_call:.4f} ms")
    return dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                          f"{label} T={t} K={k} N={n} group {group}"
                          + (", split over groups" if split else "")),
                matmul_ms=matmul_ms, other_route_ms=other_ms, layer_ms=layer_ms,
                layer_call_ms=layer_call, library_call_ms=lib_call)


def phase_quant(gen, t, k, dtype, iters, timed, label=""):
    """Per-token quantization of x [t, k] (normal * 3; where there are rows
    for them, an all-zero row and a row of scale 1 with exact .5 ties and
    +-127): both outputs must equal the plain version's bit for bit."""
    import torch
    from unigen_tpu_torch.ops.quantization import (quantize_activations,
                                                   quantize_activations_plain)
    x = torch.randn((t, k), generator=gen, device="cuda") * 3
    if t > 2:
        x[1] = 0.0
        ties = torch.tensor([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0], device="cuda")
        x[2] = ties.repeat(-(-k // 8))[:k]
    x = x.to(dtype)
    (q, s), (qr, sr) = quantize_activations(x), quantize_activations_plain(x)
    torch.cuda.synchronize()
    check(bool(torch.equal(q, qr)) and bool(torch.equal(s, sr)),
          f"quantize_activations {label} T={t} K={k} {dtype} differs from its plain version")
    err = float(max((q.int() - qr.int()).abs().max().item(), (s - sr).abs().max().item()))
    print(f"  quantize_activations {label} T={t} K={k} {dtype}: equal to the plain version "
          f"(max_abs_err {err})")
    if not timed:
        return None
    ms = time_ms(lambda: quantize_activations(x), iters)
    plain_ms = time_ms(lambda: quantize_activations_plain(x), iters)
    b_ms, by = bound(0.0, nbytes(x, q, s), INT8_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms none  bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, None, b_ms, by, f"{label} x [{t},{k}] {dtype}")


def phase_head_dims(gen):
    """Flash and chunk attention (both routes) at every head dim the
    wrappers' callers may pad to (``KERNEL_HEAD_DIMS``), bf16 and fp32: a dim
    that the source does not instantiate fails to launch here. The flash
    backward kernel too (``flash_grads_gate``), over bits with right pads,
    bidirectional bits and two segments."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.chunk_attention import (_launch, chunk_attention,
                                                      chunk_attention_plain)
    from unigen_tpu_torch.ops.flash_attention import (KERNEL_HEAD_DIMS, flash_attention,
                                                      flash_attention_plain)
    b, l = 2, 37
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    pad = pos < torch.tensor([[0], [5]], device="cuda")
    z = torch.zeros_like(pad)
    bits = M.pack_meta(M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z))
    rpad = pad | (pos >= torch.tensor([[30], [l]], device="cuda"))
    ragged = M.pack_meta(M.AttnMeta(pad=rpad, bidir_q=(pos % 5 == 0) & ~rpad,
                                    bidir_k=(pos % 7 == 3) & ~rpad,
                                    seg=(pos >= 12).to(torch.int32)))
    worst = worst_grad = 0.0
    for dtype, rtol in ((torch.bfloat16, 2 ** -7), (torch.float32, 2e-5)):
        for dh in KERNEL_HEAD_DIMS:
            q, k, v = _attn_inputs(gen, b, l, l, 4, 2, dh, dtype)
            q1, k1, v1 = _attn_inputs(gen, b, 1, 90, 4, 2, dh, dtype)   # one row: it may split
            seen = torch.arange(90, device="cuda")[None] >= torch.tensor([[0], [5]], device="cuda")
            for name, got, ref in (
                    ("flash", flash_attention(q, k, v, bits), flash_attention_plain(q, k, v, bits)),
                    ("chunk", chunk_attention(q, k, v, ~pad), chunk_attention_plain(q, k, v, ~pad)),
                    ("chunk (split)", _launch(q1, k1, v1, seen, 2),
                     chunk_attention_plain(q1, k1, v1, seen))):
                err, tol = _err_tol(got, ref, rtol)
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name}_attention {dtype} head dim {dh}: max_abs_err {err} (tol {tol})")
                worst = max(worst, err / tol)
            g = torch.randn((b, l, 4, dh), generator=gen, device="cuda").to(dtype)
            worst_grad = max(worst_grad, flash_grads_gate(
                q, k, v, ragged, g, f"flash backward {dtype} head dim {dh}")[2])
    print(f"  flash and chunk attention (unsplit and split) at head dims {KERNEL_HEAD_DIMS}, "
          "bf16 and fp32: all "
          f"match their plain versions (largest err/tol {worst:.3f}); the flash backward "
          f"kernel within its gate (largest err/tol {worst_grad:.3f}), two runs bit-equal")


def run_kernel_phases(results):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    # Tolerances are relative to the largest output magnitude m (at least 1).
    # bf16 keeps 8 significant bits, so one output rounding is up to 2^-8 m;
    # the plain attention also rounds P to bf16 before P.V (attention: 2^-7 m,
    # two roundings), the plain conv rounds the conv before adding its bias and
    # sums 9 C products (conv: 2^-6 m). fp32: only the order of fp32 sums
    # differs, with TF32 off (attention 2e-5 m, conv 1e-4 m as in the CPU tests).
    # Kernel 4 and the quantization: bit for bit (torch.equal), every dtype.
    print("phase: kernels (main-path shapes in bf16, a ragged shape, fp32)")
    results["chunk_attention"] = phase_chunk(gen, 8, 258, 148, bf16, 2 ** -7, 20, True)
    phase_chunk(gen, 3, 37, 61, bf16, 2 ** -7, 0, False)          # ragged: S = 98
    phase_chunk(gen, 8, 258, 148, f32, 2e-5, 0, False)
    results["flash_attention"] = phase_flash(gen, 8, 148, bf16, 2 ** -7, 20, True)
    phase_flash(gen, 3, 133, bf16, 2 ** -7, 0, False, ragged_bits=True)
    phase_flash(gen, 3, 133, f32, 2e-5, 0, False, ragged_bits=True)
    run_conv_phases(results)

    print("phase: kernels at the understanding path's shapes (bf16 unless noted)")
    pipe, vpipe = flagship_pipeline(), flagship_pipeline(vision=True)
    l, plen, _ = understand_prompt_shape(vpipe)
    b = len(QUESTIONS)
    results["chunk_attention"]["shapes"] = [
        phase_chunk_decode(gen, b, l, plen, 64, bf16, 2 ** -7, 50)]
    for dtype, rtol in ((bf16, 2 ** -7), (f32, 2e-5)):
        phase_chunk_decode(gen, b, l, plen, 64, dtype, rtol, 0, False, masked=True)
        # ragged S: 98 (two splits, the last of 34 keys), 66 (a last split of 2), 1
        phase_chunk_decode(gen, 3, 61, [61, 40, 7], 5, dtype, rtol, 0, False, new_tokens=37,
                           masked=True)
        phase_chunk_decode(gen, 3, 61, [61, 40, 7], 4, dtype, rtol, 0, False, new_tokens=5)
        phase_chunk_decode(gen, 2, 0, [0, 0], 0, dtype, rtol, 0, False, new_tokens=1)
    phase_chunk_decode(gen, b, l, plen, 64, f32, 2e-5, 0, False)
    # the fp32 row: the towers of unigen_sft.yaml (the checkpoints, SFT and
    # serve_entry phases) keep their fp32 weights, so kernel 2 runs there in fp32
    results["flash_attention"]["shapes"] = [phase_flash_siglip(gen, b, bf16, 2 ** -7, 20),
                                            phase_flash_siglip(gen, b, f32, 2e-5, 20),
                                            phase_flash_mmu(gen, b, l, plen, bf16, 2 ** -7, 20)]
    phase_flash_mmu(gen, 3, 800, [800, 741, 733], f32, 2e-5, 1)

    print("phase: kernels at the AR t2i, discrete understanding and scoring shapes (bf16)")
    from unigen_tpu_torch.ops import masks as M
    lp, pads = t2i_prefix_layout(pipe)
    rows = 2 * len(PROMPTS)
    pos = torch.arange(lp, device="cuda")[None].expand(rows, lp)
    pad = pos < torch.as_tensor(pads, device="cuda")[:, None]
    z = torch.zeros_like(pad)
    ids, mmu_plen, eoi = mmu_prompt_layout(pipe)
    l_score, score_plen = score_layout(vpipe)
    results["flash_attention"]["shapes"] += [
        phase_flash_meta(gen, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z), bf16, 2 ** -7, 20,
                         f"AR t2i prefill q [{rows},{lp},12,128], pad bits"),
        phase_flash_meta(gen, M.mmu_attn_meta(torch.as_tensor(ids, device="cuda"), eoi,
                                              torch.as_tensor(mmu_plen, device="cuda")),
                         bf16, 2 ** -7, 10,
                         f"understand_discrete prefill q [{b},{ids.shape[1]},12,128], mmu meta"),
        phase_flash_meta(gen, M.mmu_vit_attn_meta(
            b, l_score, num_tokens=729, prefix_length=3,
            prompt_len=torch.as_tensor(score_plen, device="cuda")), bf16, 2 ** -7, 20,
            f"score forward q [{b},{l_score},12,128], mmu_vit meta")]
    results["chunk_attention"]["shapes"] += [
        phase_chunk_decode(gen, rows, lp, [lp] * rows, 128, bf16, 2 ** -7, 50, new_tokens=256,
                           left_pads=pads, at="AR t2i step"),
        phase_chunk_decode(gen, b, ids.shape[1], mmu_plen, 64, bf16, 2 ** -7, 50,
                           at="understand_discrete decode step")]
    # kernel 4 and the quantization at every W4A8 shape of the understand call:
    # decode T = 8 and prefill T = 8 x 787; q/k/v carry a bf16 bias, the rest
    # the fp32 zeros a layer without one gets
    t_pre = b * l
    w4 = [phase_w4a8(gen, b, 1536, 8960, 256, 50, True, "decode gate/up", bias=False),
          phase_w4a8(gen, b, 1536, 1536, 256, 50, True, "decode q/o"),
          phase_w4a8(gen, b, 1536, 256, 256, 50, True, "decode k/v"),
          phase_w4a8(gen, b, 8960, 1536, 256, 50, True, "decode down", bias=False),
          phase_w4a8(gen, b, 1536, 159867, 256, 20, True, "decode head", bias=False),
          phase_w4a8(gen, t_pre, 1536, 1536, 256, 10, True, "prefill q/o"),
          phase_w4a8(gen, t_pre, 1536, 256, 256, 10, True, "prefill k/v"),
          phase_w4a8(gen, t_pre, 1536, 8960, 256, 10, True, "prefill gate/up", bias=False),
          phase_w4a8(gen, t_pre, 8960, 1536, 256, 10, True, "prefill down", bias=False)]
    results["w4a8_matmul"] = dict(w4[0], shapes=w4[1:])
    qa = [phase_quant(gen, b, 1536, bf16, 50, True, "decode"),
          phase_quant(gen, b, 8960, bf16, 50, True, "decode down input"),
          phase_quant(gen, t_pre, 1536, bf16, 10, True, "prefill"),
          phase_quant(gen, t_pre, 8960, bf16, 10, True, "prefill down input")]
    results["quantize_activations"] = dict(qa[0], shapes=qa[1:])
    phase_head_dims(gen)
    run_w8a8_phases(results)
    # ragged T, N and groups on every route: both routes at T 5 (split chosen),
    # the prefill body with 16-byte copies (T 37, 300) and with plain loads
    # (group 16: half-groups of 8 bytes)
    for t, k, n, group in ((5, 128, 96, 32), (5, 512, 1000, 64), (37, 512, 1000, 64),
                           (37, 256, 96, 32), (70, 256, 512, 16), (300, 1024, 1000, 256)):
        phase_w4a8(gen, t, k, n, group, 0, False, "ragged", bias=n != 1000)
    for t, k, dtype in ((1, 999, f32), (37, 1000, bf16), (6296, 8960, f32)):
        phase_quant(gen, t, k, dtype, 0, False, "ragged")
    run_slice_kernel_phases(results)
    run_serving_kernel_phases(results)
    run_spec_kernel_phases(results)
    results["flash_attention_train"] = phase_flash_train(gen, 10)
    print("phase: kernels, kernel 3 at the encoder's 7 shapes at batch 6 (fp32: the train "
          "step's mmu encode; its t2i encode is batch 8, timed above)")
    enc6 = [phase_conv(gen, 6, hw, hw, c, cout, torch.float32, 1e-4, 10 if hw < 128 else 3, gn,
                       part="encoder") for hw, c, cout, gn, _ in ENCODER_CONVS]
    results["conv3x3_gn_swish"]["shapes"] += [{k: v for k, v in e.items() if k != "gn"}
                                              for e in enc6]
    results["gn_affine"]["shapes"] += [e["gn"] for e in enc6]
    per_encode = {b: sum(n * row["ms"] for (*_, n), row in zip(ENCODER_CONVS, rows))
                  for b, rows in ((8, [r for _, r, _ in results["encoder_conv_rows"]]),
                                  (6, enc6))}
    results["conv3x3_gn_swish"]["train_encodes_ms"] = per_encode[8] + per_encode[6]
    print(f"kernel 3 over the train step's two encodes (launches x ms at each shape): batch 8 "
          f"{per_encode[8]:.4f} ms + batch 6 {per_encode[6]:.4f} ms = "
          f"{per_encode[8] + per_encode[6]:.4f} ms")
    run_post_training_kernel_phases(results, gen)
    run_naflex_kernel_phases(results)
    run_visualize_kernel_phases(results, gen)


def run_visualize_kernel_phases(results, gen):
    """The shapes of the train phase's visualize hook (``Trainer._visualize``
    at PT2's width): kernel 3's fp32 route at the decoder's 11 shapes at
    batch 8 (the VQ reconstruction and the prediction of the 8 t2i rows; its
    two encodes are the encoder's batch-8 rows) and kernel 2 at the t2i
    rows' bits, bf16, timed as the other rows."""
    import torch
    print("phase: kernels at the visualize hook's shapes (kernel 3: the decoder's 11 shapes at "
          "batch 8, fp32; kernel 2: the t2i rows' forward, bf16)")
    dec = [phase_conv(gen, 8, hw, hw, c, cout, torch.float32, 1e-4, 10 if hw < 128 else 3, gn)
           for hw, c, cout, gn, _ in DECODER_CONVS]
    results["conv3x3_gn_swish"]["shapes"] += [{k: v for k, v in e.items() if k != "gn"}
                                              for e in dec]
    results["gn_affine"]["shapes"] += [e["gn"] for e in dec if "gn" in e]
    per_decode = sum(n * e["ms"] for (*_, n), e in zip(DECODER_CONVS, dec))
    results["conv3x3_gn_swish"]["visualize_decode_ms"] = per_decode
    print(f"kernel 3 (launches x ms at each shape) over one fp32 decode of 8 rows "
          f"{per_decode:.4f} ms (the hook decodes twice)")
    t2i = train_metas(train_config())[0]
    b, l = t2i.pad.shape
    results["flash_attention"]["shapes"].append(phase_flash_meta(
        gen, t2i, torch.bfloat16, 2 ** -7, 20, f"visualize forward q [{b},{l},12,128], t2i bits"))


def run_post_training_kernel_phases(results, gen):
    """Kernel 2's autograd function at the post-training steps' shapes and
    bits (``post_training_bits``) and kernel 3's fp32 route at the encoder's
    7 shapes at batch 3 (the SFT step's t2i encode) and 10 (each of the DPO
    step's two encodes), each held and timed as the PT2 rows are."""
    import torch
    print("phase: kernels at the post-training steps' attention (kernel 2's autograd function, "
          "bf16)")
    results["flash_attention_train"]["shapes"] = [
        phase_flash_grad(gen, bits, 10 if bits.shape[1] < 1000 else 5, at)
        for at, bits in post_training_bits().items()]
    per_encode = {}
    for b in (3, 10):
        print(f"phase: kernels, kernel 3 at the encoder's 7 shapes at batch {b} (fp32: the "
              f"{'SFT' if b == 3 else 'DPO'} step's encode)")
        enc = [phase_conv(gen, b, hw, hw, c, cout, torch.float32, 1e-4, 10 if hw < 128 else 3,
                          gn, part="encoder") for hw, c, cout, gn, _ in ENCODER_CONVS]
        results["conv3x3_gn_swish"]["shapes"] += [{k: v for k, v in e.items() if k != "gn"}
                                                  for e in enc]
        results["gn_affine"]["shapes"] += [e["gn"] for e in enc]
        per_encode[b] = sum(n * e["ms"] for (*_, n), e in zip(ENCODER_CONVS, enc))
    results["conv3x3_gn_swish"].update(sft_encode_ms=per_encode[3],
                                       dpo_encodes_ms=2 * per_encode[10])
    print(f"kernel 3 (launches x ms at each shape) over the SFT step's encode (batch 3) "
          f"{per_encode[3]:.4f} ms; over the DPO step's two encodes (batch 10) "
          f"{2 * per_encode[10]:.4f} ms")


def phase_chunk_naflex(gen, dtype, ragged, rtol, iters):
    """Kernel 1 as the SigLIP2-NaFlex tower calls it: q = k = v's sequence
    [8, 256, 16, 72] zero-padded to the kernel's head dim 80, scale 72^-1/2,
    a key mask a row: all valid, or ``ragged`` (valid counts 6-256 a row, as
    ``naflex_preprocess`` pads: a full row, a 6-patch row, the rest drawn).
    Every row, pad query rows too, against the plain version; the unsplit
    route. Timed beside SDPA with the boolean key mask (head dim 72); the
    bound counts 4 h dh a visible (query, key) pair at dh 72 and reads q, the
    visible keys' k and v and the mask and writes the output once, unpadded; fp32 against the
    card's fp32 peak, bf16 against its tensor cores'."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import chunk_attention as CA
    from unigen_tpu_torch.ops.flash_attention import kernel_head_dim
    b, n, h, dh = len(QUESTIONS), NAFLEX_PATCHES, 16, 72
    q, k, v = _attn_inputs(gen, b, n, n, h, h, dh, dtype)
    pad = kernel_head_dim(dh) - dh
    qp, kp, vp = (F.pad(t, (0, pad)) for t in (q, k, v))
    counts = torch.full((b,), n, device="cuda")
    if ragged:
        counts = torch.randint(6, n + 1, (b,), generator=gen, device="cuda")
        counts[0], counts[-1] = n, 6
    kvalid = torch.arange(n, device="cuda")[None] < counts[:, None]
    check(CA.kv_splits(b, n, n, h, h) == 1, "the NaFlex tower's attention takes the split route")
    scale = dh ** -0.5
    got = CA.chunk_attention(qp, kp, vp, kvalid, scale=scale)
    ref = CA.chunk_attention_plain(qp, kp, vp, kvalid, scale=scale)
    torch.cuda.synchronize()
    err, tol = _err_tol(got[..., :dh], ref[..., :dh], rtol)
    at = (f"NaFlex tower q/k/v [{b},{n},{h},{dh}->{dh + pad}] {dtype}, "
          + (f"ragged key mask (valid {counts.tolist()})" if ragged else "all keys valid"))
    check(bool(torch.isfinite(got).all()) and bool((got[..., dh:] == 0).all()),
          f"chunk_attention at the {at}: output not finite or its padding not zero")
    print(f"  chunk_attention {at}: max_abs_err {err:.3e} (tol {tol:.2e}), pad query rows "
          "included")
    check(err <= tol, f"chunk_attention at the {at} disagrees with its plain version")
    ms = time_ms(lambda: CA.chunk_attention(qp, kp, vp, kvalid, scale=scale), iters)
    plain_ms = time_ms(lambda: CA.chunk_attention_plain(qp, kp, vp, kvalid, scale=scale), 3)
    lib_ms = sdpa_ms(q, k, v, kvalid[:, None, None, :], iters)
    pairs = n * kvalid.sum().item()
    b_ms, by = bound(4.0 * h * dh * pairs,
                     kv_read_bytes(k, kvalid) + nbytes(q, kvalid, got[..., :dh]),
                     BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa, dh 72, bool key mask) "
          f"{lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, at)


def phase_conv_grad(gen, b, hw, c, cout, iters):
    """Kernel 3's autograd function (``ops.fused_conv._ConvGnSwish``) at a
    decoder shape with GroupNorm, fp32: on inputs that require grad the
    output carries a grad_fn; for one upstream gradient, dx and the conv
    kernel, bias and GroupNorm scale and bias gradients equal the plain
    version's autograd bit for bit (cuDNN's deterministic algorithms on both
    sides for this check; the backward is the plain recompute, as JAX's
    ``_bwd``). Times forward + backward beside the plain version's (cuDNN's
    default algorithms); the bound counts the three convolutions' operations
    (forward, dx, dW) on fp32 CUDA cores and every tensor read or written once.
    The library time is ``group_norm + silu + conv2d`` forward and backward
    through autograd on the same tensors."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import fused_conv as FC
    f32 = torch.float32
    x, conv_p, gn_p = _conv_inputs(gen, b, hw, hw, c, cout, f32, True)
    leaves = [x, conv_p["kernel"], conv_p["bias"], gn_p["scale"], gn_p["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    g = torch.randn((b, hw, hw, cout), generator=gen, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = FC.conv3x3_gn_swish.launches
        out = FC.conv3x3_gn_swish(conv_p, gn_p, x)
        has_fn = out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, g)
        launched = FC.conv3x3_gn_swish.launches - before
        ref = FC.conv3x3_gn_swish_plain(conv_p, gn_p, x)
        want = torch.autograd.grad(ref, leaves, g)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err, tol = _err_tol(out.detach(), ref.detach(), 1e-4)
    equal = all(torch.equal(a, r) for a, r in zip(got, want))
    at = f"MAGViT decoder [{b},{hw},{hw},{c}]->{cout} fp32, forward + backward"
    print(f"  conv3x3_gn_swish autograd {at}: grad_fn {type(out.grad_fn).__name__}, "
          f"{launched} conv launch; forward max_abs_err {err:.3e} (tol {tol:.2e}); dx, dW, db, "
          f"dscale, dbias bit-equal to the plain version's autograd: {equal}")
    check(has_fn and launched == 1, f"kernel 3 on the card gave no gradient path at {at}")
    check(err <= tol and bool(torch.isfinite(out).all()), f"kernel 3 forward disagrees at {at}")
    check(equal, f"kernel 3's gradients differ from the plain version's autograd at {at}")

    def both(fwd):
        return lambda: torch.autograd.grad(fwd(), leaves, g)
    # the library composition of the other kernel-3 rows, NCHW views of the same
    # tensors, forward and backward through autograd
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

    def library():
        y = F.silu(F.group_norm(xc, min(32, c), gn_p["scale"], gn_p["bias"], 1e-6))
        o = F.conv2d(y, conv_p["kernel"].permute(3, 2, 0, 1), conv_p["bias"], padding=1)
        return torch.autograd.grad(o, leaves, gc)
    fwd_ms = time_ms(lambda: FC.conv3x3_gn_swish(conv_p, gn_p, x), iters)
    all_ms = time_ms(both(lambda: FC.conv3x3_gn_swish(conv_p, gn_p, x)), iters)
    plain_fwd = time_ms(lambda: FC.conv3x3_gn_swish_plain(conv_p, gn_p, x), iters)
    plain_all = time_ms(both(lambda: FC.conv3x3_gn_swish_plain(conv_p, gn_p, x)), iters)
    lib_ms = time_ms(library, iters)
    b_ms, by = bound(3 * 2.0 * b * hw * hw * 9 * c * cout,
                     nbytes(*leaves, out, g) + nbytes(*got), FP32_PEAK)
    print(f"    forward ms {fwd_ms:.4f} (plain {plain_fwd:.4f}); backward ms "
          f"{all_ms - fwd_ms:.4f} (plain {plain_all - plain_fwd:.4f}); forward + backward ms "
          f"{all_ms:.4f} (plain {plain_all:.4f}); bound_ms {b_ms:.4f} ({by}); library_ms "
          f"(group_norm+silu+conv2d, forward + backward through autograd) {lib_ms:.4f}")
    row = _measured(err, all_ms, plain_all, lib_ms, b_ms, by, at)
    row.update(forward_ms=fwd_ms, backward_ms=all_ms - fwd_ms, plain_forward_ms=plain_fwd,
               plain_backward_ms=plain_all - plain_fwd, backward_bit_equal=equal)
    return row


def run_naflex_kernel_phases(results):
    """Kernel 1 at the SigLIP2-NaFlex tower's shape (fp32, the tower's own
    dtype, and bf16, the flagship pipelines'; all-valid and ragged key
    masks), and kernel 3's gradient through its autograd function at two
    decoder shapes in fp32."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    print("phase: kernels at the SigLIP2-NaFlex tower's attention (kernel 1, key-masked)")
    results["chunk_attention"]["shapes"] += [
        phase_chunk_naflex(gen, dtype, ragged, rtol, 20)
        for dtype, rtol in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -7))
        for ragged in (False, True)]
    print("phase: kernels, kernel 3's gradient on the card (its autograd function, fp32)")
    results["conv3x3_gn_swish"]["grad_shapes"] = [phase_conv_grad(gen, 2, 16, 512, 512, 10),
                                                  phase_conv_grad(gen, 2, 32, 256, 256, 10)]


def train_config(*extra):
    """PT2's config with the train phase's overrides (no edit of the file)."""
    from unigen_tpu_torch.utils.configuration import initialize_config
    return initialize_config(TRAIN_CONFIG, ["dataset.synthetic=true", "experiment.save_every=0",
                                            f"experiment.output_dir={TRAIN_OUT}", *extra])


def train_bits(config, device="cuda"):
    """The meta bits of the train step's first synthetic batch at PT2's
    shape (``train_metas``, joined)."""
    from unigen_tpu_torch.ops import masks as M
    return M.pack_meta(M.concat_meta(*train_metas(config, device)))


def train_metas(config, device="cuda"):
    """The t2i, lm and mmu metadata of the train step's first synthetic batch
    at PT2's shape: the templates as ``Trainer.build_device_batch`` assembles
    them (the image blocks' codes never equal a pad, soi or eoi id, so the
    templates give the step's bits; the visualize hook's forward takes the
    t2i rows')."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_prompting_from_config, load_tokenizer
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.training.train import synthetic_flows
    pr = build_prompting_from_config(config, load_tokenizer(config))
    flow = next(synthetic_flows(config))
    n = config.model.unigen.num_vq_tokens
    t2i, _, _ = pr((flow["t2i_flow"]["input_ids"],
                    *(np.zeros((len(flow["t2i_flow"]["input_ids"]), n), np.int64),) * 2), "t2i")
    lm, _, _ = pr((flow["lm_flow"]["input_ids"], pr.max_seq_len), "lm")
    mmu, _, _ = pr((np.zeros((len(flow["mmu_flow"]["input_ids"]), n), np.int64),
                    flow["mmu_flow"]["input_ids"]), "mmu")
    soi, eoi = pr.sptids_dict["<|soi|>"], pr.sptids_dict["<|eoi|>"]

    def t(a):
        return torch.as_tensor(a, device=device)
    return (M.t2i_attn_meta(t(t2i), pr.pad_id, soi, eoi), M.lm_attn_meta(t(lm), pr.pad_id),
            M.mmu_train_attn_meta(t(mmu), pr.pad_id, soi, eoi))


def flash_grads_gate(q, k, v, bits, g, at):
    """Kernel 2's gradients through its autograd function (the forward
    writing the rows' log-sum-exp, then the backward kernel) against the
    gradients of the plain version on the inputs upcast to fp32 (``ref``):
    in bf16 each of dq, dk, dv within max(2 x the bf16 plain version's own
    error against ``ref``, 2^-8 max |ref|); in fp32 within 1e-5 max |ref|.
    A second backward of the same graph must give the same bits (no
    atomics). Returns (out, the kernel's grads, the largest error / tol,
    the largest max_abs_err)."""
    import torch
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, bits)
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    again = torch.autograd.grad(out, leaves, g)
    plain = torch.autograd.grad(flash_attention_plain(*leaves, bits), leaves, g)
    up = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_plain(*up, bits), up, g.float())
    torch.cuda.synchronize()
    worst = worst_err = 0.0
    for name, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        top = r.abs().max().item()
        err = (a.float() - r).abs().max().item()
        tol = (1e-5 * top if q.dtype == torch.float32
               else max(2 * (p.float() - r).abs().max().item(), 2 ** -8 * top))
        check(a.dtype == p.dtype and bool(torch.isfinite(a).all()) and err <= tol,
              f"{at}: {name} max_abs_err {err:.3e} against the fp32 plain gradients (tol "
              f"{tol:.3e}, max |ref| {top:.3e})")
        worst, worst_err = max(worst, err / tol), max(worst_err, err)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{at}: two backward runs of the kernel differ")
    return out, got, worst, worst_err


def phase_flash_grad(gen, bits, iters, at, heads=(12, 2)):
    """Kernel 2 as the training steps call it: the autograd function at
    [B, L, 12, 128] with a step's ``bits``, bf16. Forward within 2^-7 of the
    plain version; dq, dk, dv by ``flash_grads_gate`` (fp32 plain gradients,
    two runs bit for bit). Times the forward, forward + backward of the
    kernel's function, the plain version and SDPA (with the dense mask), and
    the backward kernel alone (``flash_attention_backward``) beside its plain
    version (``flash_attention_backward_plain``); the bounds count the least
    work: 4 h dh per visible pair forward, 8 backward (dV, dP, dQ, dK), 12
    both; the forward reads q, k, v and the bits and writes the output, the
    backward reads q, k, v, dO and the bits and writes dq, dk, dv, both
    together read and write each once. The row's ``backward_kernel`` holds
    the backward kernel's own fields."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_backward_plain,
        flash_attention_launch, flash_attention_plain)
    import torch.nn.functional as F
    b, l = bits.shape
    (h, kvh), dh = heads, 128
    q, k, v = (t.requires_grad_(True) for t in _attn_inputs(gen, b, l, l, h, kvh, dh,
                                                           torch.bfloat16))
    g = torch.randn((b, l, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
    out, _, worst, grad_err = flash_grads_gate(q, k, v, bits, g, at)
    ref = flash_attention_plain(q, k, v, bits)
    err, tol = _err_tol(out.detach(), ref.detach(), 2 ** -7)
    print(f"  flash_attention {at} q{list(q.shape)}: forward max_abs_err {err:.3e} (tol "
          f"{tol:.2e}); dq, dk, dv against fp32 plain gradients: max_abs_err {grad_err:.3e}, "
          f"largest err/tol {worst:.3f}; two backward runs bit-equal")
    check(err <= tol and bool(torch.isfinite(out).all()), f"{at} flash forward disagrees")
    vis = M.unpack_meta(bits).visibility()
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    gt = g.transpose(1, 2)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    lse = torch.empty((b, h, l), dtype=torch.float32, device="cuda")
    flash_attention_launch(qd, kd, vd, bits, lse=lse)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis, enable_gqa=True)

    def both(fwd, args, grad):
        return lambda: torch.autograd.grad(fwd(), args, grad)
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, bits), iters)
    all_ms = time_ms(both(lambda: flash_attention(q, k, v, bits), (q, k, v), g), iters)
    bwd_ms = time_ms(lambda: flash_attention_backward(qd, kd, vd, bits, lse, g), iters)
    plain_fwd = time_ms(lambda: flash_attention_plain(q, k, v, bits), iters)
    plain_all = time_ms(both(lambda: flash_attention_plain(q, k, v, bits), (q, k, v), g), iters)
    plain_bwd = time_ms(lambda: flash_attention_backward_plain(qd, kd, vd, bits, lse, g), iters)
    lib_fwd = time_ms(sdpa, iters)
    lib_all = time_ms(both(sdpa, (qt, kt, vt), gt), iters)
    pairs = attn_flops(vis, h, kvh, dh) / 4.0
    b_ms, by = bound(12.0 * pairs, 2 * nbytes(q, k, v, out) + nbytes(g, bits), BF16_PEAK)
    fwd_bound = bound(4.0 * pairs, nbytes(q, k, v, out, bits), BF16_PEAK)[0]
    bwd_bound, bwd_by = bound(8.0 * pairs, 2 * nbytes(q, k, v) + nbytes(g, bits), BF16_PEAK)
    print(f"    forward ms {fwd_ms:.4f} (plain {plain_fwd:.4f}, sdpa {lib_fwd:.4f}, bound "
          f"{fwd_bound:.4f}); backward kernel ms {bwd_ms:.4f} (its plain version "
          f"{plain_bwd:.4f}; the plain autograd's backward {plain_all - plain_fwd:.4f}; sdpa "
          f"{lib_all - lib_fwd:.4f}; bound {bwd_bound:.4f} ({bwd_by})); forward + backward "
          f"ms {all_ms:.4f} (plain {plain_all:.4f}, sdpa {lib_all:.4f}); bound_ms {b_ms:.4f} "
          f"({by})")
    row = _measured(max(err, grad_err), all_ms, plain_all, lib_all, b_ms, by,
                    f"{at} q [{b},{l},{h},{dh}], forward + backward")
    row.update(forward_ms=fwd_ms, backward_ms=all_ms - fwd_ms, plain_forward_ms=plain_fwd,
               plain_backward_ms=plain_all - plain_fwd, library_forward_ms=lib_fwd,
               library_backward_ms=lib_all - lib_fwd, forward_bound_ms=fwd_bound,
               backward_bound_ms=bwd_bound, backward_bound_by=bwd_by,
               backward_kernel=dict(_measured(grad_err, bwd_ms, plain_bwd, lib_all - lib_fwd,
                                              bwd_bound, bwd_by, f"{at} q [{b},{l},{h},{dh}]"),
                                    grad_err_over_tol=worst,
                                    autograd_recompute_ms=plain_all - plain_fwd))
    return row


def phase_flash_train(gen, iters):
    """Kernel 2's autograd function at PT2's [16, 835, 12, 128] with the
    step's t2i / lm / mmu bits (``phase_flash_grad``)."""
    print("phase: kernels at the train step's attention (kernel 2's autograd function, bf16)")
    return phase_flash_grad(gen, train_bits(train_config()), iters, "train step, t2i/lm/mmu bits")


def run_slice_kernel_phases(results):
    """Kernels 1-3 at the shapes the CoT, DPG and image-serving paths give
    them, bf16, each held against its plain version and timed: the t2i
    prefill and step at batch 20 (40 rows with the uncond ones), SigLIP, the
    understand prefill (the system prompt first) and its decode step at 20
    rows, the decoder's 11 convs at batch 20, the encoder's 7 in bf16 at
    batch 8 (the discrete rater encodes the candidates in their dtype), and
    the t2i prefill and step at DPG's text budget of 256."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8642)
    bf16 = torch.bfloat16
    pipe, vpipe = flagship_pipeline(), flagship_pipeline(vision=True)
    b = COT_SAMPLES
    print(f"phase: kernels at the CoT, DPG and image-serving shapes (bf16; CoT batch {b})")

    def pad_meta(prompts, text_len):
        lp, pads = t2i_prefix_layout(pipe, prompts, text_len, mode="mask")
        pos = torch.arange(lp, device="cuda")[None].expand(len(pads), lp)
        pad = pos < torch.as_tensor(pads, device="cuda")[:, None]
        z = torch.zeros_like(pad)
        return lp, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)
    lp, meta = pad_meta([COT_PROMPT] * b, 128)
    l, plen, prefix = cot_rating_shape(vpipe)
    flash = [phase_flash_meta(gen, meta, bf16, 2 ** -7, 20,
                              f"CoT t2i prefill q [{2 * b},{lp},12,128], pad bits"),
             phase_flash_siglip(gen, b, bf16, 2 ** -7, 10),
             phase_flash_meta(gen, M.mmu_vit_attn_meta(
                 b, l, num_tokens=729, prefix_length=prefix,
                 prompt_len=torch.as_tensor(plen, device="cuda")), bf16, 2 ** -7, 10,
                 f"CoT rating prefill q [{b},{l},12,128], mmu_vit meta, system prompt")]
    chunk = [phase_chunk(gen, 2 * b, 258, lp, bf16, 2 ** -7, 20, True, at="CoT t2i step"),
             phase_chunk_decode(gen, b, l, plen, COT_RATING_TOKENS // 2, bf16, 2 ** -7, 50,
                                new_tokens=COT_RATING_TOKENS, at="CoT rating decode step")]
    dlp, dmeta = pad_meta([PROMPTS[0]] * 4, DPG_TEXT_LEN)
    flash.append(phase_flash_meta(gen, dmeta, bf16, 2 ** -7, 20,
                                  f"DPG t2i prefill q [8,{dlp},12,128], pad bits"))
    chunk.append(phase_chunk(gen, 8, 258, dlp, bf16, 2 ** -7, 20, True, at="DPG t2i step"))
    results["flash_attention"]["shapes"] += flash
    results["chunk_attention"]["shapes"] += chunk
    print(f"phase: kernels, conv3x3_gn_swish and gn_affine at the decoder's 11 shapes, batch {b}")
    dec = [phase_conv(gen, b, hw, hw, c, cout, bf16, 2 ** -6, 10 if hw < 128 else 3, gn)
           for hw, c, cout, gn, _ in DECODER_CONVS]
    print("phase: kernels, conv3x3_gn_swish and gn_affine at the encoder's 7 shapes, batch "
          f"{COT_DISCRETE_SAMPLES}, bf16 (the CoT discrete rater encodes bf16 candidates)")
    enc = [phase_conv(gen, COT_DISCRETE_SAMPLES, hw, hw, c, cout, bf16, 2 ** -6,
                      10 if hw < 128 else 5, gn, part="encoder")
           for hw, c, cout, gn, _ in ENCODER_CONVS]
    for key, convs, table in (("cot_decoder_rows", dec, DECODER_CONVS),
                              ("cot_encoder_rows", enc, ENCODER_CONVS)):
        rows = [{k: v for k, v in c.items() if k != "gn"} for c in convs]
        results["conv3x3_gn_swish"]["shapes"] += rows
        results["gn_affine"]["shapes"] += [c["gn"] for c in convs if c.get("gn")]
        results[key] = [(t[:4], row, c.get("gn")) for t, row, c in zip(table, rows, convs)]

def run_serving_kernel_phases(results):
    """Kernels 1, 2 and 4 at the serving engine's shapes (bf16): kernel 1 at
    the decode step of 32 slots against the 896-slot cache, each row at its
    own key count (the per-row index); kernel 2 at a batched admission of 16
    rows of 640 (600 real tokens, pad bits) and at the VQA admission of 8
    rows of the splice with mmu_vit bits; kernel 4 and the quantization at
    T 32 (the W4A8 decode chunks of ``int8+int4``) and the W8A8 layer at 32
    rows (``int8+kv``'s decode)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9753)
    bf16 = torch.bfloat16
    b = SERVE_SLOTS
    print(f"phase: kernels at the serving engine's shapes (bf16; {b} slots, cache "
          f"{SERVE_MAX_LEN}, admission {SERVE_ADMIT} x {SERVE_BUCKET})")
    # each slot at its own age: a 600-token prompt and 0..223 decoded tokens
    ages = torch.randint(SERVE_PROMPT, SERVE_PROMPT + 224, (b,), generator=gen,
                         device="cuda").tolist()
    results["chunk_attention"]["shapes"].append(phase_chunk_decode(
        gen, b, SERVE_MAX_LEN, [a + 1 for a in ages], -1, bf16, 2 ** -7, 50, new_tokens=0,
        at="serving decode step (per-row key counts)"))
    k = SERVE_ADMIT
    pad = torch.arange(SERVE_BUCKET, device="cuda")[None].expand(k, SERVE_BUCKET) >= SERVE_PROMPT
    z = torch.zeros_like(pad)
    vpipe = flagship_pipeline(vision=True)
    l, plen, prefix = serving_vqa_shape(vpipe)
    results["flash_attention"]["shapes"] += [
        phase_flash_meta(gen, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z), bf16, 2 ** -7, 10,
                         f"serving admission q [{k},{SERVE_BUCKET},12,128], pad bits"),
        phase_flash_meta(gen, M.mmu_vit_attn_meta(
            len(QUESTIONS), l, num_tokens=729, prefix_length=prefix,
            prompt_len=torch.as_tensor(plen, device="cuda")), bf16, 2 ** -7, 10,
            f"serving VQA admission q [{len(QUESTIONS)},{l},12,128], mmu_vit bits")]
    t = b
    results["w4a8_matmul"]["shapes"] += [
        phase_w4a8(gen, t, 1536, 8960, 256, 50, True, "serving decode gate/up", bias=False),
        phase_w4a8(gen, t, 1536, 1536, 256, 50, True, "serving decode q/o"),
        phase_w4a8(gen, t, 1536, 256, 256, 50, True, "serving decode k/v"),
        phase_w4a8(gen, t, 8960, 1536, 256, 50, True, "serving decode down", bias=False),
        phase_w4a8(gen, t, 1536, 159867, 256, 20, True, "serving decode head", bias=False)]
    results["quantize_activations"]["shapes"] += [
        phase_quant(gen, t, 1536, bf16, 50, True, "serving decode"),
        phase_quant(gen, t, 8960, bf16, 50, True, "serving decode down input")]
    results["w8a8_epilogue"]["shapes"] += [
        phase_w8a8(gen, t, 1536, 8960, 50, True, "serving decode gate/up"),
        phase_w8a8(gen, t, 1536, 1536, 50, True, "serving decode q", bf16),
        phase_w8a8(gen, t, 1536, 256, 50, True, "serving decode k/v", bf16),
        phase_w8a8(gen, t, 8960, 1536, 50, True, "serving decode down"),
        phase_w8a8(gen, t, 1536, 159867, 20, True, "serving decode head")]


def phase_w8a8(gen, t, k, n, iters, timed, label="", bias_dtype=None):
    """The W8A8 layer at [t, k] -> n: weights quantized from a normal * k^-1/2
    matrix, activations from a bf16 normal by the plain quantization, a bias
    of ``bias_dtype`` or none. ``torch._int_mm`` (on rows padded to 32 at
    t <= 16) must give the exact product; the epilogue kernel must equal its
    plain version bit for bit (bf16 and, untimed, fp32 out), and so must the
    whole layer ``dense_int8`` against the plain composition. Timed: the
    epilogue launch against its plain version and its byte bound; the product
    alone; the whole layer (quantization, product, epilogue: what one layer
    enqueues) against bf16 ``F.linear`` (with the bias where the layer has
    one), on the device and back to back."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import quantization as QZ
    bf16 = torch.bfloat16
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    dense = {"kernel": w}
    if bias_dtype is not None:
        dense["bias"] = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(bias_dtype)
    p = QZ.quantize_dense(dense)
    w8, scale, bias = p[QZ.KEY], p["scale"], p.get("bias")
    x = torch.randn((t, k), generator=gen, device="cuda").to(bf16)
    x8, act = QZ.quantize_activations_plain(x)
    acc = QZ.int8_matmul(x8, w8)
    check(acc.shape == (t, w8.shape[0]) and bool(torch.equal(acc.double(),
                                                             x8.double() @ w8.double().t())),
          f"int8_matmul {label} T={t} K={k} N={n} is not the exact product")
    for out_dtype in ((bf16,) if timed else (bf16, torch.float32)):
        ref = QZ.w8a8_epilogue_plain(acc, act, scale, bias, out_dtype)
        got = QZ.w8a8_epilogue(acc, act, scale, bias, out_dtype)
        torch.cuda.synchronize()
        check(got.shape == (t, n) and bool(torch.isfinite(got).all()),
              f"w8a8_epilogue {label} output {tuple(got.shape)} not finite")
        check(bool(torch.equal(got, ref)), f"w8a8_epilogue {label} T={t} N={n} {out_dtype} "
              "differs from its plain version")
    check(bool(torch.equal(QZ.dense_int8(p, x), QZ.dense_int8_prequant_plain(p, x8, act, bf16))),
          f"dense_int8 {label} (quantization + _int_mm + epilogue) differs from the plain "
          "composition")
    print(f"  w8a8 {label} T={t} K={k} N={n} (Npad {w8.shape[0]}, bias "
          f"{'none' if bias is None else str(bias_dtype).split('.')[-1]}): exact product; "
          f"epilogue{'' if timed else ' (bf16 and fp32)'} and layer equal their plain versions "
          "bit for bit")
    if not timed:
        return None
    ms = time_ms(lambda: QZ.w8a8_epilogue(acc, act, scale, bias, bf16), iters)
    plain_ms = time_ms(lambda: QZ.w8a8_epilogue_plain(acc, act, scale, bias, bf16), iters)
    mm_ms = time_ms(lambda: QZ.int8_matmul(x8, w8), iters)
    layer_ms = time_ms(lambda: QZ.dense_int8(p, x), iters)
    layer_call = call_ms(lambda: QZ.dense_int8(p, x), iters)
    wb = w.t().contiguous().to(bf16)

    def library():
        return F.linear(x, wb, bias)
    lib_ms = time_ms(library, iters)
    lib_call = call_ms(library, iters)
    b_ms, by = bound(0.0, nbytes(acc[:, :n], act, scale, got) + (0 if bias is None else
                                                                 nbytes(bias)), INT8_PEAK)
    lb_ms, lby = bound(2.0 * t * k * n, nbytes(x, w8[:n], scale, got) + (0 if bias is None else
                                                                        nbytes(bias)), INT8_PEAK)
    print(f"    epilogue ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {b_ms:.4f} ({by})  "
          f"library_ms none")
    print(f"    layer: device {layer_ms:.4f} ms (_int_mm {mm_ms:.4f}), bound {lb_ms:.4f} ({lby}); "
          f"bf16 F.linear{' + bias' if bias is not None else ''} {lib_ms:.4f}; back to back "
          f"layer {layer_call:.4f}, F.linear {lib_call:.4f}")
    return dict(_measured(0.0, ms, plain_ms, None, b_ms, by,
                          f"{label} [{t},{n}] of [{t},{k}] x [{k},{n}]"),
                int_mm_ms=mm_ms, layer_ms=layer_ms, layer_bound_ms=lb_ms,
                linear_ms=lib_ms, layer_call_ms=layer_call, linear_call_ms=lib_call)


def phase_int_mm_layout(gen, t, k, n, iters):
    """torch._int_mm with the W8A8 leaf's weight ([Npad, K], read as its
    transpose) against the same weight stored [K, N]: the device kernels of
    each (the leaf's may hold no copy or transpose) and their times."""
    import torch
    from unigen_tpu_torch.ops import quantization as QZ
    x8 = torch.randint(-127, 128, (t, k), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    w_kn = w.t().contiguous()
    traces = device_traces(lambda: QZ.int8_matmul(x8, w), 1)
    names = max(([m for m, _ in tr] for tr in traces), key=len)
    every = {m for tr in traces for m, _ in tr}
    check(not any("copy" in m.lower() or "transpose" in m.lower() for m in every),
          f"torch._int_mm on the W8A8 weight layout launched {sorted(every)}")
    leaf_ms = time_ms(lambda: torch._int_mm(x8, w.t()), iters)
    kn_ms = time_ms(lambda: torch._int_mm(x8, w_kn), iters)
    print(f"  torch._int_mm [{t},{k}] x [{k},{n}]: the leaf's [N, K] weight {leaf_ms:.4f} ms "
          f"({names[0][:70]}), a [K, N] weight {kn_ms:.4f} ms; no copy kernel")
    return {"leaf_ms": leaf_ms, "kn_ms": kn_ms, "kernel": names[0]}


def run_w8a8_phases(results):
    """The W8A8 layer at every shape of the int8 paths: t2i (prefill 8 x 148
    rows, steps 8 x 258, the image head on 4 x 256 blended rows), the
    understand call (SigLIP 8 x 729, prefill 8 x 787, decode 8 rows and the
    159,867-wide head); timed at the t2i step and decode shapes and one
    prefill and one SigLIP shape; ragged shapes and an fp32 bias untimed."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase: kernels, the W8A8 layer (torch._int_mm + the epilogue kernel) at the int8 "
          "paths' shapes (bf16 activations)")
    l, _, _ = understand_prompt_shape(flagship_pipeline(vision=True))
    b = len(QUESTIONS)
    t_step, t_pre, t_vit = 8 * 258, b * l, b * 729
    timed = [phase_w8a8(gen, t_step, 1536, 8960, 20, True, "t2i step gate/up"),
             phase_w8a8(gen, t_step, 1536, 1536, 20, True, "t2i step q", bf16),
             phase_w8a8(gen, t_step, 1536, 256, 20, True, "t2i step k/v", bf16),
             phase_w8a8(gen, t_step, 8960, 1536, 20, True, "t2i step down"),
             phase_w8a8(gen, 4 * 256, 1536, 8192, 20, True, "t2i image head"),
             phase_w8a8(gen, b, 1536, 8960, 50, True, "decode gate/up"),
             phase_w8a8(gen, b, 1536, 1536, 50, True, "decode q", bf16),
             phase_w8a8(gen, b, 1536, 256, 50, True, "decode k/v", bf16),
             phase_w8a8(gen, b, 8960, 1536, 50, True, "decode down"),
             phase_w8a8(gen, b, 1536, 159867, 20, True, "decode head"),
             phase_w8a8(gen, t_pre, 1536, 8960, 10, True, "understand prefill gate/up"),
             phase_w8a8(gen, t_vit, 1152, 4304, 10, True, "SigLIP fc1", bf16)]
    for t, k, n, label, bias in ((8 * 148, 1536, 1536, "t2i prefill q", bf16),
                                 (8 * 148, 1536, 256, "t2i prefill k/v", bf16),
                                 (8 * 148, 1536, 8960, "t2i prefill gate/up", None),
                                 (8 * 148, 8960, 1536, "t2i prefill down", None),
                                 (t_step, 1536, 1536, "t2i step o", None),
                                 (b, 1536, 1536, "decode o", None),
                                 (t_pre, 1536, 1536, "understand prefill q", bf16),
                                 (t_pre, 1536, 256, "understand prefill k/v", bf16),
                                 (t_pre, 8960, 1536, "understand prefill down", None),
                                 (t_vit, 1152, 1152, "SigLIP q/k/v/o", bf16),
                                 (t_vit, 4304, 1152, "SigLIP fc2", bf16),
                                 (5, 128, 96, "ragged", None), (37, 512, 1000, "ragged", f32),
                                 (16, 64, 161, "ragged", bf16), (17, 96, 40, "ragged", f32),
                                 (300, 1024, 1000, "ragged", bf16)):
        phase_w8a8(gen, t, k, n, 0, False, label, bias)
    results["w8a8_epilogue"] = dict(timed[0], shapes=timed[1:],
                                    int_mm_layout=phase_int_mm_layout(gen, t_step, 1536, 8960,
                                                                      20))


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------

def _counters():
    """Every launch count a path phase reads: the port's kernels, and
    ``int8_matmul`` (the W8A8 layers' ``torch._int_mm`` calls on the card)."""
    from unigen_tpu_torch.ops.chunk_attention import chunk_attention
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from unigen_tpu_torch.ops.fused_conv import conv3x3_gn_swish, gn_affine
    from unigen_tpu_torch.ops.int4 import w4a8_matmul
    from unigen_tpu_torch.ops.quantization import (int8_matmul, quantize_activations,
                                                   w8a8_epilogue)
    return {"flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "chunk_attention": chunk_attention,
            "conv3x3_gn_swish": conv3x3_gn_swish, "gn_affine": gn_affine,
            "w4a8_matmul": w4a8_matmul, "quantize_activations": quantize_activations,
            "w8a8_epilogue": w8a8_epilogue, "int8_matmul": int8_matmul}


NO_LAUNCHES = dict.fromkeys(("flash_attention", "flash_attention_backward", "chunk_attention",
                             "conv3x3_gn_swish",
                             "gn_affine", "w4a8_matmul", "quantize_activations",
                             "w8a8_epilogue", "int8_matmul"), 0)


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


# the port's hand-written kernels: a profile prints them even below its top rows
PORT_KERNELS = ("attention_bf16_kernel", "chunk_split_bf16_kernel", "chunk_combine_kernel",
                "w4a8_", "quantize_kernel", "conv3x3", "gn_partial", "gn_finish",
                "w8a8_epilogue")
# kernel families by name, first match wins: what is the port's, cuBLAS's, and
# what is left of plain-torch elementwise work
FAMILIES = (("kernel 4 (w4a8_*)", ("w4a8_",)), ("quantization kernel", ("quantize_kernel",)),
            ("W8A8 epilogue kernel", ("w8a8_epilogue",)),
            ("cuBLAS int8 GEMMs (torch._int_mm)", ("gemm_s8", "_s8_", "i8i8")),
            ("attention kernels 1, 2", ("attention_bf16", "chunk_split", "chunk_combine",
                                        "attention_fp32")),
            ("conv kernel 3", ("conv3x3",)),
            ("GroupNorm statistics kernel", ("gn_partial", "gn_finish")),
            ("cuBLAS / cuDNN GEMMs and convs", ("gemm", "nvjet", "cutlass", "xmma", "cudnn")),
            ("plain-torch copies and casts", ("copy",)),
            ("plain-torch reductions", ("reduce",)),
            ("plain-torch elementwise", ("elementwise", "index", "scatter", "gather", "cat",
                                         "fill")))


def profile_run(run_once, warm_s: float, top: int = 12) -> None:
    """Device time by kernel over one more warm run of a path. Busy time is the
    union of the device intervals (GPU annotations overlap their kernels and
    are not counted twice); the idle share is taken against the profiled
    run's own wall (the unprofiled warm run's is printed beside it), and is
    printed as unresolved where the busy time exceeds that wall. The port's
    kernels are printed by name wherever they rank, and every kernel is
    summed into a family (``FAMILIES``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from unigen_tpu_torch.utils import trace_analysis as TA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = TA.profiler_events(prof)
    by_name = TA.kernel_times(events)
    busy, wall = TA.busy_ms(events), prof_s * 1e3
    idle = f"{1 - busy / wall:.3f}" if busy <= wall else "unresolved (busy exceeds the wall)"
    print(f"  profile: device busy {busy:.1f} ms (union of device intervals) in a profiled "
          f"wall of {wall:.1f} ms; unprofiled warm wall {warm_s * 1e3:.1f} ms; "
          f"idle share (of the profiled wall) {idle}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (ms, count)) in enumerate(ranked):
        if rank < top or any(k in name for k in PORT_KERNELS):
            print(f"    {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:100]}")
    families = {}
    for name, (ms, count) in by_name.items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES if any(k in low for k in keys)), "other")
        f_ms, f_count = families.get(fam, (0.0, 0))
        families[fam] = (f_ms + ms, f_count + count)
    print("  by family:")
    for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<7d} {fam}")


@contextlib.contextmanager
def conv_census(census):
    """Counts, while it is open, the launches of kernel 3 and of the GroupNorm
    statistics that each of the decoder's conv calls makes, by (H = W, C, Cout,
    GN) into ``census`` as [conv launches, statistics launches]."""
    from unigen_tpu_torch.models import magvit
    from unigen_tpu_torch.ops import fused_conv as FC
    real = magvit.conv3x3_gn_swish

    def counted(conv_p, gn_p, x, *args, **kw):
        conv0, gn0 = FC.conv3x3_gn_swish.launches, FC.gn_affine.launches
        out = real(conv_p, gn_p, x, *args, **kw)
        n = census.setdefault((x.shape[1], x.shape[3], conv_p["kernel"].shape[3],
                               gn_p is not None), [0, 0])
        n[0] += FC.conv3x3_gn_swish.launches - conv0
        n[1] += FC.gn_affine.launches - gn0
        return out
    magvit.conv3x3_gn_swish = counted
    try:
        yield census
    finally:
        magvit.conv3x3_gn_swish = real


def conv_batch_sums(results):
    """Fills kernel 3's and the statistics' launches_per_batch and batch_ms
    (the sum of launches x ms over a t2i batch, the decoder's),
    encoder_batch_ms (over an understand_discrete call, the encoder's), and
    cot_batch_ms and cot_encoder_batch_ms (the decoder at batch 20 and the
    bf16 encoder at batch 8, over the CoT generation and one discrete
    rating call) from the censuses of the flagship, understand_discrete and
    cot runs; they stay null where that phase or the timed shapes did not
    run."""
    for part, rows_key, census_key, field, phase in (
            ("decoder", "conv_rows", "conv_census", "batch_ms", "flagship"),
            ("encoder", "encoder_conv_rows", "encoder_census", "encoder_batch_ms",
             "understand_discrete"),
            (f"decoder at batch {COT_SAMPLES}", "cot_decoder_rows", "cot_decoder_census",
             "cot_batch_ms", "cot"),
            (f"bf16 encoder at batch {COT_DISCRETE_SAMPLES}", "cot_encoder_rows",
             "cot_encoder_census", "cot_encoder_batch_ms", "cot")):
        rows, census = results.get(rows_key), results.get(census_key)
        if not rows:
            continue
        if census is None:
            print(f"  sum of launches x ms over the {part}: not computed (the {phase} phase, "
                  "which counts the launches by shape, did not run)")
            results["conv3x3_gn_swish"][field] = results["gn_affine"][field] = None
            continue
        _conv_sum(results, part, rows, census, field)


def _conv_sum(results, part, rows, census, field):
    total = gn_total = b_total = lib_total = 0.0
    for key, conv_row, gn_row in rows:
        n_conv, n_gn = census.get(key, (0, 0))
        conv_row["launches_per_batch"] = n_conv
        total += n_conv * conv_row["ms"]
        b_total += n_conv * conv_row["bound_ms"]
        lib_total += n_conv * conv_row["library_ms"]
        if gn_row is not None:
            gn_row["launches_per_batch"] = n_gn
            gn_total += n_gn * gn_row["ms"]
    results["conv3x3_gn_swish"][field] = total
    results["gn_affine"][field] = gn_total
    print(f"kernel 3 in the {part} (the path run's launches by shape x each shape's ms): "
          f"{total:.4f} ms (statistics + conv), of it the statistics {gn_total:.4f} ms; bound "
          f"{b_total:.4f} ms; cuDNN {lib_total:.4f} ms")


def _timed_runs(name, run_once, expect, runs=("cold", "warm"), census=None, validate=None,
                work=None):
    """Runs a path ``runs`` times, each with the launch counts set to 0 just
    before and read just after, checks them against ``expect`` and each
    run's output with ``validate``; ``work`` = (count, unit) prints a rate.
    The last run also counts kernel 3's launches by shape into ``census``
    when given. Returns (the last run's output, its wall seconds, enqueue
    seconds, counts)."""
    import torch
    for run in runs:
        _reset_counts()
        torch.cuda.synchronize()
        with conv_census(census) if census is not None and run == runs[-1] else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            out = run_once()
            enqueued = time.perf_counter() - t0  # the host's share: work queued, not done
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = _read_counts()
        rate = f", {work[0] / dt:.4f} {work[1]}/s" if work else ""
        label = f"{name} {run} run" if len(runs) > 1 else f"{name} run"
        print(f"  {label}: {dt:.3f} s ({enqueued:.3f} s to enqueue){rate}, launches {counts}")
        check(counts == expect, f"{name} launch counts {counts} != {expect}")
        if validate is not None:
            validate(out)
    return out, dt, enqueued, counts


def _t2i_checker(name, pipe):
    """Checks a t2i run's (codes, pixels): codes in the codebook, finite
    pixels of 256 px."""
    import torch

    def validate(out):
        codes, pixels = out
        check(tuple(codes.shape) == (len(PROMPTS), pipe.cfg.num_vq_tokens) and
              bool(((codes >= 0) & (codes < pipe.cfg.codebook_size)).all()), f"{name} codes")
        check(tuple(pixels.shape) == (len(PROMPTS), 256, 256, 3) and
              bool(torch.isfinite(pixels).all()), f"{name} pixels")
    return validate


def _t2i_run(pipe, **kw):
    """One GenEval t2i call of the 4 prompts (guidance 6, text budget 128,
    generator seed 0) and its decode: () -> (codes, pixels)."""
    import torch

    def run_once():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        codes = pipe.generate_images(list(PROMPTS), gen, guidance_scale=6.0, max_text_len=128,
                                     return_codes=True, **kw)
        return codes, pipe.decode_codes(codes)
    return run_once


def _recording(pipe, record):
    """A copy of ``pipe`` whose ``generate_images`` appends each call's
    (prompts, output) to ``record``."""
    import dataclasses
    copy = dataclasses.replace(pipe)
    real = pipe.generate_images

    def generate_images(prompts, *a, **kw):
        record.append((list(prompts), real(prompts, *a, **kw)))
        return record[-1][1]
    copy.generate_images = generate_images
    return copy


def _t2i_launches(layers, n=1):
    """The launches of ``n`` GenEval t2i batches (50 steps, the decoder)."""
    return dict(flash_attention=n * layers, chunk_attention=n * layers * 50,
                conv3x3_gn_swish=n * 44, gn_affine=n * 40)


GUARD_CALLS = 2000


def _whole_tree_check_s(pipe):
    """Seconds on the host of the shape checks that a forward and its head
    run on a tree given no specs (``qwen2._check_whole``, ``lm_head``)."""
    from unigen_tpu_torch.models import qwen2
    llm, cfg = pipe.params["llm"], pipe.cfg.llm
    t0 = time.perf_counter()
    for _ in range(GUARD_CALLS):
        qwen2._check_whole(llm, cfg)
        qwen2.lm_head(llm, cfg)
    return (time.perf_counter() - t0) / GUARD_CALLS


def run_flagship(results, profile=False):
    import torch
    print("phase: flagship path (Qwen2.5-1.5B + MAGViTv2, random init, bf16, 4 prompts, "
          "guidance 6, 50 steps, max_text_len 128)")
    pipe = flagship_pipeline()
    expect = dict(NO_LAUNCHES, **_t2i_launches(pipe.cfg.llm.num_hidden_layers))
    census = {}
    run_once = _t2i_run(pipe, timesteps=50)
    # the warm run also counts kernel 3's launches by shape (44 wrapped Python
    # calls; their cost is within the run's noise)
    (codes, _), dt, enqueued, counts = _timed_runs(
        "flagship", run_once, expect, census=census, validate=_t2i_checker("flagship", pipe),
        work=(len(PROMPTS), "images"))
    expect_census = {(hw, c, cout, gn): [n, n if gn else 0]
                     for hw, c, cout, gn, n in DECODER_CONVS}
    print("  warm run, kernel 3 launches by (H = W, C, Cout, GN): [conv, statistics]: "
          + ", ".join(f"{k}: {v}" for k, v in sorted(census.items())))
    check(census == expect_census, f"decoder conv launches {census} != {expect_census}")
    results["conv_census"] = census
    if profile:
        profile_run(run_once, dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.decode_codes(codes)
        torch.cuda.synchronize()
        print("  profile of the decoder alone (decode_codes):")
        profile_run(lambda: pipe.decode_codes(codes), time.perf_counter() - t0)
    ids, _ = pipe.prompt_ids(list(PROMPTS), 128)
    print(f"  prompt length {ids.shape[1]} (prefix {ids.shape[1] - 258}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    guard_s = _whole_tree_check_s(pipe)
    forwards = 51                                   # the prefill and the 50 steps
    print(f"  the whole-tree check of a forward given no specs (qwen2's layer 0, final_ln, "
          f"embedding and head shapes): {guard_s * 1e6:.2f} us on the host a forward "
          f"(mean of {GUARD_CALLS}), {forwards} forwards = {forwards * guard_s / dt:.2e} of the run")
    results["flagship"] = {"seconds": dt, "enqueue_s": enqueued,
                           "images_per_s": len(PROMPTS) / dt, "guard_us": guard_s * 1e6}
    results["flagship_codes"] = codes
    return counts


def run_flagship_int8(results, profile=False):
    """The t2i flagship on W8A8, JAX's shipped t2i default
    (``build_pipeline(quantization="int8")``: backbone and image head int8):
    the same seed-0 weights, prompts and generator seed as ``run_flagship``,
    fixed launch counts, images/s, and the codes' agreement with the bf16 run
    of this call (random weights: not a gate)."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: flagship_int8 path (the flagship t2i with build_pipeline(quantization="
          "'int8'): W8A8 backbone and image head, the same weights, prompts and seeds)")
    t0 = time.perf_counter()
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8")
    torch.cuda.synchronize()
    print(f"  build_pipeline(quantization='int8') {time.perf_counter() - t0:.2f} s")
    layers, steps = pipe.cfg.llm.num_hidden_layers, 50
    # the prefill (7 projections a layer, 4 quantizations) and 50 steps, each
    # with the image head (one more of each)
    dense = 7 * layers * (steps + 1) + steps
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * steps,
                  conv3x3_gn_swish=44, gn_affine=40,
                  quantize_activations=4 * layers + steps * (4 * layers + 1),
                  w8a8_epilogue=dense, int8_matmul=dense)
    run_once = _t2i_run(pipe, timesteps=steps)
    (codes, _), dt, enqueued, counts = _timed_runs(
        "flagship_int8", run_once, expect, validate=_t2i_checker("flagship_int8", pipe),
        work=(len(PROMPTS), "images"))
    out = {"seconds": dt, "enqueue_s": enqueued, "images_per_s": len(PROMPTS) / dt}
    if "flagship_codes" in results:
        out["agreement_with_bf16"] = (codes == results["flagship_codes"]).float().mean().item()
        bf = results["flagship"]
        print(f"  beside the bf16 run of this call: {bf['seconds']:.3f} s ({bf['enqueue_s']:.3f} s "
              f"to enqueue), {bf['images_per_s']:.4f} images/s; codes agree with bf16's on "
              f"{out['agreement_with_bf16']:.4f} (random weights; not a gate)")
    if profile:
        profile_run(run_once, dt)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship_int8"] = out
    return counts


def _vqa_pixels(pipe):
    """8 uint8 images at the tower's size, from generator seed 7."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    size = pipe.vision_cfg.image_size
    return torch.randint(0, 256, (len(QUESTIONS), size, size, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)


def _token_checker(name, vocab, b=len(QUESTIONS)):
    def validate(toks):
        check(tuple(toks.shape) == (b, NEW_TOKENS) and bool(((toks >= 0) & (toks < vocab)).all()),
              f"{name} tokens {tuple(toks.shape)} out of range")
    return validate


def run_understand(results, profile=False):
    """SigLIP VQA at full width: bf16, 8 uint8 images of 384 px, 8 questions,
    128 new tokens, greedy; the backbone and text head in W4A8 (group 256),
    then the same call with the bf16 backbone as a yardstick."""
    import dataclasses
    import torch
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    print("phase: understand path (SigLIP-SO400M + projector + Qwen2.5-1.5B W4A8, random "
          f"init, bf16, {len(QUESTIONS)} images of 384 px, {NEW_TOKENS} new tokens, greedy)")
    pipe = flagship_pipeline(vision=True)
    t0 = time.perf_counter()
    qpipe = dataclasses.replace(pipe, params=quantize_unigen_params_int4(pipe.params, pipe.cfg))
    torch.cuda.synchronize()
    print(f"  quantize_unigen_params_int4 {time.perf_counter() - t0:.2f} s")
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    layers = pipe.cfg.llm.num_hidden_layers
    per_forward = 7 * layers + 1                     # q, k, v, o, gate, up, down + head
    quant_per_forward = 4 * layers + 1               # q/k/v, o, gate/up, down + head
    expect_q = dict(NO_LAUNCHES, flash_attention=pipe.vision_cfg.num_layers_used + layers,
                    chunk_attention=layers * (NEW_TOKENS - 1),
                    w4a8_matmul=per_forward * NEW_TOKENS,
                    quantize_activations=quant_per_forward * NEW_TOKENS)
    validate = _token_checker("understand", pipe.cfg.llm.vocab_size)

    def run(p):
        return p.understand(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)

    out = {}
    for name, p, expect in (("w4a8", qpipe, expect_q),
                            ("bf16", pipe, dict(expect_q, w4a8_matmul=0, quantize_activations=0))):
        toks, dt, enqueued, counts = _timed_runs(f"understand {name}", lambda p=p: run(p), expect,
                                                 runs=ONCE, validate=validate,
                                                 work=(b * NEW_TOKENS, "tokens"))
        out[name] = {"seconds": dt, "enqueue_s": enqueued, "tokens_per_s": b * NEW_TOKENS / dt,
                     "tokens": toks, "counts": counts}
    agree = (out["w4a8"]["tokens"] == out["bf16"]["tokens"]).float().mean().item()
    print(f"  W4A8 vs bf16 backbone token agreement {agree:.4f} (random weights; not a gate)")
    if profile:
        for name, p in (("w4a8", qpipe), ("bf16", pipe)):
            print(f"  profile of the {name} understand call:")
            profile_run(lambda: run(p), out[name]["seconds"])
    l, _, _ = understand_prompt_shape(pipe)
    p = pipe.vision_cfg.num_patches
    print(f"  prompt length {l} (3 + {p} image + {l - 3 - p} question), cache "
          f"{l + NEW_TOKENS} slots, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["understand"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                             for k, v in out.items()}
    results["understand_tokens"] = {k: v["tokens"] for k, v in out.items()}
    return out["w4a8"]["counts"]


def run_understand_int8(results, profile=False):
    """SigLIP VQA as JAX's ``int8+kv``: ``build_pipeline(vision=True,
    quantization="int8", quantized_cache=True)`` puts the tower, the backbone
    and the text head on W8A8 and keeps K/V in int8. The same weights,
    pixels, questions and 128 greedy tokens as ``run_understand``; tokens/s
    beside its W4A8 and bf16 runs of this call."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: understand_int8 path (SigLIP-SO400M + Qwen2.5-1.5B, all W8A8, int8 KV cache, "
          f"{len(QUESTIONS)} images of 384 px, {NEW_TOKENS} new tokens, greedy)")
    t0 = time.perf_counter()
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0, vision=True,
                          quantization="int8", quantized_cache=True)
    torch.cuda.synchronize()
    print(f"  build_pipeline(vision=True, quantization='int8', quantized_cache=True) "
          f"{time.perf_counter() - t0:.2f} s")
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    layers, vit = pipe.cfg.llm.num_hidden_layers, pipe.vision_cfg.num_layers_used
    # a forward: 7 projections and 4 quantizations a layer, and the head; the
    # tower: q/k/v, o, fc1, fc2 on 4 quantizations a layer. No chunk kernel:
    # the int8 cache's decode steps run the plain q8 attention.
    dense = (7 * layers + 1) * NEW_TOKENS + 6 * vit
    expect = dict(NO_LAUNCHES, flash_attention=vit + layers,
                  quantize_activations=(4 * layers + 1) * NEW_TOKENS + 4 * vit,
                  w8a8_epilogue=dense, int8_matmul=dense)

    def run_once():
        return pipe.understand(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)
    toks, dt, enqueued, counts = _timed_runs(
        "understand_int8 (int8+kv)", run_once, expect, runs=ONCE,
        validate=_token_checker("understand_int8", pipe.cfg.llm.vocab_size),
        work=(b * NEW_TOKENS, "tokens"))
    out = {"seconds": dt, "enqueue_s": enqueued, "tokens_per_s": b * NEW_TOKENS / dt}
    if "understand" in results:
        u = results["understand"]
        out["agreement_with_bf16"] = (
            toks == results["understand_tokens"]["bf16"]).float().mean().item()
        print(f"  beside this call's understand runs: W4A8 {u['w4a8']['tokens_per_s']:.2f} "
              f"tokens/s ({u['w4a8']['seconds']:.3f} s), bf16 {u['bf16']['tokens_per_s']:.2f} "
              f"tokens/s ({u['bf16']['seconds']:.3f} s); tokens agree with bf16's on "
              f"{out['agreement_with_bf16']:.4f} (random weights; not a gate)")
    if profile:
        profile_run(run_once, dt)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["understand_int8"] = out
    return counts


def _naflex_tiny_images(n, seed):
    """``n`` uint8 images for the tiny NaFlex tower (patch 4, 16 patches), in
    four aspects: 16 x 16, 8 x 32, 12 x 20 (15 patches) and 20 x 12."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = ((16, 16), (8, 32), (12, 20), (20, 12))
    return [rng.integers(0, 256, sizes[i % 4] + (3,), dtype=np.uint8) for i in range(n)]


def run_tiny_naflex_understand():
    """The tiny fp32 NaFlex pipeline (``build_pipeline("tiny", vision="naflex")``)
    through the kernels on the card against the plain versions on the CPU,
    greedy: 8 images of four aspects in one batch (ragged patch counts, so
    pad rows and key masks), token agreement >= 0.99 as every tiny check."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 NaFlex understand (ragged images in one batch), kernels on the card "
          "vs plain versions on the CPU, greedy")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision="naflex")
    gpu = cpu.to("cuda")
    images = _naflex_tiny_images(len(QUESTIONS), 6)
    _reset_counts()
    toks_gpu = gpu.understand(images, list(QUESTIONS), None, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _read_counts()
    toks_cpu = cpu.understand(images, list(QUESTIONS), None, max_new_tokens=32)
    agree = (toks_gpu.cpu() == toks_cpu).float().mean().item()
    vit, layers = cpu.vision_cfg.num_layers_used, cpu.cfg.llm.num_hidden_layers
    print(f"  token agreement {agree:.4f} (need >= 0.99), launches {counts}")
    check(counts == dict(NO_LAUNCHES, flash_attention=layers,
                         chunk_attention=vit + layers * 31),
          f"tiny NaFlex understand launches {counts}")
    check(agree >= 0.99, f"tiny NaFlex understand token agreement {agree}")


def run_understand_naflex(results, profile=False):
    """VQA through the SigLIP2-NaFlex tower at full width: bf16, 8 uint8
    images of 256 px (16 x 16 patches, the budget of 256), the 8 questions,
    128 greedy tokens, warm; kernel 1 in the tower (26 launches, key-masked)
    and at every decode step, kernel 2 in the prefill (28). Prints tokens/s
    and the tower's share of the call (the tower and projector alone, warm,
    over the call's wall); then the tiny fp32 run against the CPU."""
    import statistics
    import torch
    print("phase: understand_naflex path (SigLIP2-NaFlex so400m-patch16 + projector + "
          f"Qwen2.5-1.5B, random init, bf16, {len(QUESTIONS)} images of {NAFLEX_PX} px, "
          f"{NEW_TOKENS} new tokens, greedy)")
    pipe = flagship_pipeline(vision="naflex")
    b = len(QUESTIONS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    pixels = torch.randint(0, 256, (b, NAFLEX_PX, NAFLEX_PX, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    layers, vit = pipe.cfg.llm.num_hidden_layers, pipe.vision_cfg.num_layers_used
    expect = dict(NO_LAUNCHES, flash_attention=layers,
                  chunk_attention=vit + layers * (NEW_TOKENS - 1))

    def run_once():
        return pipe.understand(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)
    toks, dt, enqueued, counts = _timed_runs(
        "understand_naflex", run_once, expect, runs=ONCE,
        validate=_token_checker("understand_naflex", pipe.cfg.llm.vocab_size),
        work=(b * NEW_TOKENS, "tokens"))
    tower = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = pipe._image_embeds(pixels)
        torch.cuda.synchronize()
        tower.append(time.perf_counter() - t0)
    tower_s = statistics.median(tower)
    check(tuple(feats.shape) == (b, NAFLEX_PATCHES, pipe.cfg.llm.hidden_size)
          and bool(torch.isfinite(feats).all()), f"NaFlex image embeddings {tuple(feats.shape)}")
    print(f"  the tower + projector alone (warm, median of 3): {tower_s * 1e3:.2f} ms, "
          f"{tower_s / dt:.4f} of the call's {dt:.3f} s")
    if "understand" in results:
        u = results["understand"]["bf16"]
        print(f"  beside this call's SigLIP understand (bf16, 729 image tokens of 384 px): "
              f"{u['tokens_per_s']:.2f} tokens/s ({u['seconds']:.3f} s)")
    if profile:
        profile_run(run_once, dt)
    print(f"  prompt: 3 + {NAFLEX_PATCHES} image tokens + the question; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["understand_naflex"] = {"seconds": dt, "enqueue_s": enqueued,
                                    "tokens_per_s": b * NEW_TOKENS / dt, "tower_s": tower_s,
                                    "tower_share": tower_s / dt}
    run_tiny_naflex_understand()
    return counts


def lmms_requests(pipe):
    """LMMS_REQUESTS synthetic lmms-eval requests on ``pipe``'s device: uint8
    images from numpy seed 11, a third each of LMMS_SIZES (H, W); questions
    QUESTIONS made unique by their index; budgets LMMS_BUDGETS in turn (a
    request's budget changes every third request, so each (aspect, budget)
    pair holds two); an ``until`` stop on every fifth; two 'concat'
    requests of two images whose canvas has one of the aspects."""
    import numpy as np
    rng = np.random.default_rng(11)
    out = []
    for i in range(LMMS_REQUESTS):
        h, w = LMMS_SIZES[i % 3]
        if i in (4, 17):                          # two images side by side: h x 2w' = h x w
            images = [rng.integers(0, 256, (h, w // 2, 3), dtype=np.uint8) for _ in range(2)]
        else:
            images = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kw = {"max_new_tokens": LMMS_BUDGETS[(i // 3) % len(LMMS_BUDGETS)]}
        if i % 5 == 0:
            kw["until"] = ["\n", "."]
        out.append((f"{QUESTIONS[i % len(QUESTIONS)]} (#{i})", kw, images))
    return out


@contextlib.contextmanager
def lmms_token_census(pipe, record):
    """While open, records the tokens each request generated (up to and
    including its first eos, within its budget) into ``record`` {context:
    count}: from ``pipe.understand``'s rows (the static route; a padded
    row repeats a request) and from the serving engine's futures."""
    from unigen_tpu_torch.serving import engine as TE
    eos = pipe.prompting.eos_token_id
    real_understand, real_submit = type(pipe).understand, TE.ServingEngine.submit_embeds
    contexts = {}

    def understand(self, pixels, questions, *a, **kw):
        toks = real_understand(self, pixels, questions, *a, **kw).cpu()
        for q, row in zip(questions, toks.tolist()):
            record[q] = row.index(eos) + 1 if eos in row else len(row)
        return toks

    def submit_embeds(self, *a, **kw):
        fut = real_submit(self, *a, **kw)
        contexts[fut] = None
        return fut
    type(pipe).understand, TE.ServingEngine.submit_embeds = understand, submit_embeds
    try:
        yield contexts
    finally:
        type(pipe).understand, TE.ServingEngine.submit_embeds = real_understand, real_submit


def run_lmms(results, profile=False):
    """The lmms-eval adapter (``evaluation.lmms_adapter.UniGenLmmsAdapter``)
    at the flagship width over the NaFlex pipeline: LMMS_REQUESTS uint8
    requests in three aspects (``lmms_requests``), mixed budgets, stops and
    two 'concat' requests, greedy, the Qwen system prompt. ``generate_until``
    static (batch 8) and served (16 slots, chunk 8) in bf16: requests/s and
    useful tokens/s (tokens up to each request's eos), exact launch counts
    from the routes' calls; ``loglikelihood`` batched and one request at a
    time. Gates in fp32 on the same seed's weights, where greedy choices do
    not hang on a batch shape's rounding: static = served strings, batched =
    single log-likelihoods (rtol 1e-5, JAX's adapter test) and greedy flags."""
    import numpy as np
    import torch
    from unigen_tpu_torch.evaluation.lmms_adapter import UniGenLmmsAdapter
    from unigen_tpu_torch.launch import build_pipeline
    print(f"phase: lmms (the lmms-eval adapter over SigLIP2-NaFlex + Qwen2.5-1.5B, random init, "
          f"{LMMS_REQUESTS} requests of {', '.join(f'{h}x{w}' for h, w in LMMS_SIZES)} (H x W), "
          f"budgets {LMMS_BUDGETS}, greedy)")
    pipe = flagship_pipeline(vision="naflex")
    reqs = lmms_requests(pipe)
    layers, vit = pipe.cfg.llm.num_hidden_layers, pipe.vision_cfg.num_layers_used
    conts = [CONTINUATIONS[i % len(CONTINUATIONS)] for i in range(LMMS_REQUESTS)]
    ll_reqs = [(q, c, img) for (q, _, img), c in zip(reqs, conts)]

    def adapter(p, batch_size=LMMS_BATCH, **kw):
        return UniGenLmmsAdapter(p, batch_size=batch_size, serving_slots=LMMS_SLOTS,
                                 serving_chunk=LMMS_CHUNK, **kw)

    def static_calls(a):
        """(understand calls, their decode steps) of the static route: the
        adapter's groups by budget and prepared shape, in batches of 8."""
        groups = {}
        for q, kw, img in reqs:
            groups.setdefault((kw["max_new_tokens"], a._prepared_shape(img)), []).append(q)
        calls = [(budget, -(-len(qs) // LMMS_BATCH)) for (budget, _), qs in groups.items()]
        return sum(n for _, n in calls), sum(n * (budget - 1) for budget, n in calls)

    def tower_calls(a, rows):
        shapes = {}
        for img in rows:
            shapes[a._prepared_shape(img)] = shapes.get(a._prepared_shape(img), 0) + 1
        return sum(-(-n // LMMS_BATCH) for n in shapes.values())

    out, strings, route_counts = {}, {}, {}
    for name, serving in (("static", False), ("served", True)):
        a = adapter(pipe, serving=serving)
        record, sizes = {}, []
        _reset_counts()
        torch.cuda.synchronize()
        with lmms_token_census(pipe, record) as futs, admission_census(sizes):
            t0 = time.perf_counter()
            texts = a.generate_until(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = _read_counts()
        if serving:
            useful = sum(len(f.result(timeout=0)) for f in futs)
            steps = sum(st.slot_steps for st in a.last_stats) // LMMS_SLOTS
            expect = dict(NO_LAUNCHES, flash_attention=layers * len(sizes),
                          chunk_attention=vit * tower_calls(a, [r[2] for r in reqs])
                          + layers * steps)
        else:
            useful = sum(record.values())
            n_calls, steps = static_calls(a)
            expect = dict(NO_LAUNCHES, flash_attention=layers * n_calls,
                          chunk_attention=vit * n_calls + layers * steps)
        print(f"  generate_until {name}: {dt:.3f} s, {LMMS_REQUESTS / dt:.4f} "
              f"requests/s, {useful} useful tokens, {useful / dt:.2f} useful tokens/s; "
              f"launches {counts}")
        check(counts == expect, f"lmms {name} launch counts {counts} != {expect}")
        check(len(texts) == LMMS_REQUESTS and all(isinstance(t, str) for t in texts),
              f"lmms {name} returned {texts!r}")
        route_counts[name] = counts
        out[name] = {"seconds": dt, "requests_per_s": LMMS_REQUESTS / dt,
                     "useful_tokens": useful, "tokens_per_s": useful / dt}
        if serving:
            out[name]["latency"] = a.last_latency
        strings[name] = texts
    same = np.mean([x == y for x, y in zip(strings["static"], strings["served"])])
    print(f"  bf16 static and served strings equal on {same:.4f} of the requests (batch shapes "
          "round differently in bf16; the gate is the fp32 run below)")
    a = adapter(pipe)
    for name, fn in (("batched", lambda: a.loglikelihood(ll_reqs)),
                     ("single", lambda: [adapter(pipe, batch_size=1).loglikelihood([r])[0]
                                         for r in ll_reqs])):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        calls = tower_calls(a, [r[2] for r in ll_reqs]) if name == "batched" else LMMS_REQUESTS
        check(counts == dict(NO_LAUNCHES, flash_attention=layers * calls,
                             chunk_attention=vit * calls),
              f"lmms loglikelihood {name} launches {counts}")
        check(all(np.isfinite(lp) and lp <= 0 for lp, _ in scores), f"scores {scores}")
        print(f"  loglikelihood {name}: {dt:.3f} s, {LMMS_REQUESTS / dt:.4f} requests/s "
              f"({calls} forwards); launches {counts}")
        out[f"loglikelihood_{name}"] = {"seconds": dt, "requests_per_s": LMMS_REQUESTS / dt}
    print("  fp32 gates: the same seed's flagship in fp32")
    t0 = time.perf_counter()
    fpipe = build_pipeline("flagship", dtype=torch.float32, device="cuda", seed=0,
                           vision="naflex")
    torch.cuda.synchronize()
    print(f"  build_pipeline('flagship', fp32, vision='naflex') {time.perf_counter() - t0:.2f} s")
    static = adapter(fpipe).generate_until(reqs)
    served = adapter(fpipe, serving=True).generate_until(reqs)
    diff = [i for i, (x, y) in enumerate(zip(static, served)) if x != y]
    print(f"  fp32 generate_until: static and served strings equal on "
          f"{LMMS_REQUESTS - len(diff)} of {LMMS_REQUESTS} requests")
    check(not diff, f"fp32 static and served strings differ at requests {diff}: "
          f"{[(static[i], served[i]) for i in diff]}")
    batched = adapter(fpipe).loglikelihood(ll_reqs)
    single = [adapter(fpipe, batch_size=1).loglikelihood([r])[0] for r in ll_reqs]
    rel = max(abs(x - y) / max(abs(y), 1e-30) for (x, _), (y, _) in zip(batched, single))
    flags = all(gx == gy for (_, gx), (_, gy) in zip(batched, single))
    print(f"  fp32 loglikelihood batched vs single: max relative difference {rel:.3e} (need "
          f"<= 1e-5), greedy flags equal: {flags}")
    check(rel <= 1e-5 and flags, f"fp32 loglikelihood batched vs single: {rel}, flags {flags}")
    del fpipe
    torch.cuda.empty_cache()
    results["lmms"] = out
    # the static and served generate_until runs
    return {k: route_counts["static"][k] + route_counts["served"][k] for k in NO_LAUNCHES}


def run_flagship_ar(results, profile=False):
    """GenEval t2i with ``mode="ar"``: the 4 prompts, guidance 6, bf16; one
    prefill and 255 cached steps of 8 rows (cond and uncond), then the
    decoder."""
    import torch
    print("phase: flagship_ar path (Qwen2.5-1.5B + MAGViTv2, random init, bf16, 4 prompts, "
          "mode='ar', guidance 6, max_text_len 128)")
    pipe = flagship_pipeline()
    layers, n = pipe.cfg.llm.num_hidden_layers, pipe.cfg.num_vq_tokens
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * (n - 1),
                  conv3x3_gn_swish=44, gn_affine=40)
    run_once = _t2i_run(pipe, mode="ar")
    _, dt, enqueued, counts = _timed_runs("flagship_ar", run_once, expect, runs=ONCE,
                                          validate=_t2i_checker("flagship_ar", pipe),
                                          work=(len(PROMPTS), "images"))
    if profile:
        profile_run(run_once, dt)
    lp, _ = t2i_prefix_layout(pipe)
    print(f"  prefill [{2 * len(PROMPTS)}, {lp}], cache {lp + n} slots, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship_ar"] = {"seconds": dt, "enqueue_s": enqueued,
                              "images_per_s": len(PROMPTS) / dt}
    return counts


def run_understand_discrete(results, profile=False):
    """VQA over the tokenizer's codes: 8 fp32 images of 256 px in [-1, 1]
    through the MAGViTv2 encoder (in the pixels' dtype, batch 8), the mmu
    prompt right-padded to 1,603, the bf16 backbone, 128 greedy tokens;
    kernel 3's launches counted by shape."""
    import torch
    print("phase: understand_discrete path (MAGViTv2 encoder on fp32 pixels + Qwen2.5-1.5B bf16, "
          f"random init, {len(QUESTIONS)} images of 256 px, {NEW_TOKENS} new tokens, greedy)")
    pipe = flagship_pipeline()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    b = len(QUESTIONS)
    pixels = torch.rand((b, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    layers = pipe.cfg.llm.num_hidden_layers
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * (NEW_TOKENS - 1),
                  conv3x3_gn_swish=40, gn_affine=40)
    census = {}

    def run_once():
        return pipe.understand_discrete(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)
    _, dt, enqueued, counts = _timed_runs(
        "understand_discrete", run_once, expect, runs=ONCE, census=census,
        validate=_token_checker("understand_discrete", pipe.cfg.llm.vocab_size),
        work=(b * NEW_TOKENS, "tokens"))
    if profile:
        profile_run(run_once, dt)
        t0 = time.perf_counter()
        pipe.encode_pixels(pixels)
        torch.cuda.synchronize()
        print("  profile of the encoder alone (encode_pixels):")
        profile_run(lambda: pipe.encode_pixels(pixels), time.perf_counter() - t0)
    expect_census = {(hw, c, cout, gn): [n, n] for hw, c, cout, gn, n in ENCODER_CONVS}
    print("  kernel 3 launches by (H = W, C, Cout, GN): [conv, statistics]: "
          + ", ".join(f"{k}: {v}" for k, v in sorted(census.items())))
    check(census == expect_census, f"encoder conv launches {census} != {expect_census}")
    codes = pipe.encode_pixels(pixels)
    check(tuple(codes.shape) == (b, pipe.cfg.num_vq_tokens) and
          bool(((codes >= 0) & (codes < pipe.cfg.codebook_size)).all()), "encode_pixels codes")
    ids, _, _ = mmu_prompt_layout(pipe)
    print(f"  prefill [{b}, {ids.shape[1]}], cache {ids.shape[1] + NEW_TOKENS} slots, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["encoder_census"] = census
    results["understand_discrete"] = {"seconds": dt, "enqueue_s": enqueued,
                                      "tokens_per_s": b * NEW_TOKENS / dt}
    return counts


def run_score(results, profile=False):
    """Continuation scoring (the lmms-eval loglikelihood call): SigLIP +
    projector + one cache-free backbone forward, bf16, 8 images of 384 px x
    question x a continuation of 1-16 tokens."""
    import numpy as np
    print("phase: score path (SigLIP-SO400M + projector + Qwen2.5-1.5B, random init, bf16, "
          f"{len(QUESTIONS)} (image, question, continuation) requests)")
    pipe = flagship_pipeline(vision=True)
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    conts = score_conts(pipe)
    expect = dict(NO_LAUNCHES, flash_attention=pipe.vision_cfg.num_layers_used +
                  pipe.cfg.llm.num_hidden_layers)

    def run_once():
        return pipe.score_continuations(pixels, list(QUESTIONS), conts)

    def validate(out):
        check(len(out) == b and all(np.isfinite(lp) and lp <= 0 and isinstance(g, bool)
                                    for lp, g in out), f"score results {out}")
    out, dt, enqueued, counts = _timed_runs("score", run_once, expect, validate=validate,
                                            work=(b, "requests"))
    if profile:
        profile_run(run_once, dt)
    l_score, _ = score_layout(pipe)
    print(f"  forward [{b}, {l_score}], continuations of {[len(c) for c in conts]} tokens; "
          f"log-likelihoods {[round(lp, 3) for lp, _ in out]}")
    results["score"] = {"seconds": dt, "enqueue_s": enqueued, "requests_per_s": b / dt}
    return counts


def run_geneval(results, profile=False):
    """``evaluation.geneval.run_geneval`` over 2 metadata lines x 4 samples
    (mode mask, guidance 6, 50 steps, bf16) into a temporary directory; every
    PNG must decode back to ``pixels_to_uint8`` of its prompt's batch."""
    import os
    import tempfile
    import torch
    from unigen_tpu_torch.evaluation import geneval
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    print("phase: geneval (run_geneval, 2 prompts x 4 samples, guidance 6, 50 steps, PNG writes)")
    batches = []
    pipe = _recording(flagship_pipeline(), batches)
    metadata = [{"prompt": p} for p in PROMPTS[:2]]
    n_samples = 4
    expect = dict(NO_LAUNCHES, **_t2i_launches(pipe.cfg.llm.num_hidden_layers, len(metadata)))
    with tempfile.TemporaryDirectory() as tmp:
        def run_once():
            batches.clear()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            return geneval.run_geneval(pipe, metadata, os.path.join(tmp, "out"), gen,
                                       n_samples=n_samples)
        written, dt, enqueued, counts = _timed_runs("geneval", run_once, expect,
                                                    work=(len(metadata) * n_samples, "images"))
        if profile:
            profile_run(run_once, dt)
        check(len(written) == len(metadata) == len(batches), f"geneval wrote {written}")
        for d, md, (_, pixels) in zip(written, metadata, batches):
            want = pixels_to_uint8(pixels)
            check(geneval.load_metadata_jsonl(os.path.join(d, "metadata.jsonl")) == [md],
                  f"{d}: metadata")
            for i in range(n_samples):
                got = geneval.load_png(os.path.join(d, "samples", f"{i:05}.png"))
                check(got.shape == (256, 256, 3) and (got == want[i]).all(),
                      f"{d} sample {i}: the PNG does not decode to its batch's pixels")
        imgs = [im for _, pixels in batches for im in pixels_to_uint8(pixels)]
        t0 = time.perf_counter()
        for i, im in enumerate(imgs):
            geneval.save_png(im, os.path.join(tmp, f"{i}.png"))
        png_s = time.perf_counter() - t0
    rate = len(metadata) * n_samples / dt
    print(f"  {len(metadata) * n_samples} PNGs decode to their batches' pixels; {rate:.4f} "
          f"images/s with the PNG writes; the {len(imgs)} writes alone take {png_s:.3f} s")
    results["geneval"] = {"seconds": dt, "images_per_s": rate}
    return counts


def run_cot(results, profile=False):
    """``evaluation.cot.run_cot`` on COT_PROMPT (4 rule questions), bf16,
    guidance 6, 50 steps, text budget 128, COT_RATING_TOKENS greedy rating tokens: 20
    candidates rated through the SigLIP tower (``flagship_pipeline(vision=
    True)``), then 8 rated over the tokenizer's codes (``flagship_pipeline()``);
    top 4 kept. Checks the table's size, that every candidate is its
    generated batch in uint8 and that the selection is the top 4 by score;
    counts kernel 3's launches by shape."""
    import numpy as np
    import torch
    from unigen_tpu_torch.evaluation import cot
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    questions = cot.geneval_prompt2questions(COT_PROMPT)
    print(f"phase: cot (run_cot, {COT_PROMPT!r}: {len(questions)} rule questions, bf16, guidance "
          f"6, 50 steps, {COT_RATING_TOKENS} greedy rating tokens, top {COT_TOPK})")
    decoder = {(hw, c, cout, gn): [k, k if gn else 0] for hw, c, cout, gn, k in DECODER_CONVS}
    out = {}
    counts_by_rater = {}
    censuses = {}
    for rater, vision, n in (("vision", True, COT_SAMPLES), ("discrete", False, COT_DISCRETE_SAMPLES)):
        batches = []
        pipe = _recording(flagship_pipeline(vision=vision), batches)
        layers = pipe.cfg.llm.num_hidden_layers
        rating = dict(flash_attention=layers, chunk_attention=layers * (COT_RATING_TOKENS - 1))
        expect_census = dict(decoder)
        if vision:
            rating["flash_attention"] += pipe.vision_cfg.num_layers_used
        else:   # each question encodes the candidates again, as in JAX
            rating.update(conv3x3_gn_swish=40, gn_affine=40)
            for hw, c, cout, gn, k in ENCODER_CONVS:
                conv, stats = expect_census.get((hw, c, cout, gn), [0, 0])
                expect_census[(hw, c, cout, gn)] = [conv + len(questions) * k,
                                                    stats + len(questions) * k]
        generation = _t2i_launches(layers)
        expect = dict(NO_LAUNCHES, **{k: generation.get(k, 0) + len(questions) * rating.get(k, 0)
                                      for k in set(generation) | set(rating)})

        def run_once(pipe=pipe, vision=vision, n=n, batches=batches):
            batches.clear()
            return cot.run_cot(pipe, [COT_PROMPT], 0, n_samples=n, topk=COT_TOPK, style="rule",
                               use_vision_tower=vision, max_new_tokens=COT_RATING_TOKENS)

        def validate(result, n=n, batches=batches, rater=rater, pipe=pipe):
            (res,), table, stats = result
            check(len(batches) == 1 and batches[0][0] == [COT_PROMPT] * n,
                  f"cot {rater}: generate_images calls {[b[0] for b in batches]}")
            cands = res["candidates"]
            res_px = pipe.vq_cfg.resolution
            check(cands.shape == (n, res_px, res_px, 3) and
                  np.array_equal(cands, pixels_to_uint8(batches[0][1])),
                  f"cot {rater}: the candidates are not the generated batch in uint8")
            check(len(table) == len(questions) * n and
                  all(r["answer"] in ("yes", "no") for r in table) and
                  sorted(r["question"] for r in table) ==
                  sorted(cot.QWEN_TEMPLATE.format(user_prompt=cot.MMU_RATING_USER_PROMPT[
                      "rule"].format(context=q)).strip() for q in questions for _ in range(n)),
                  f"cot {rater}: rating table of {len(table)} rows")
            score = {int(s["image_id"].split("/")[-1][:-4]): s["score"] for s in stats}
            check(sorted(score) == list(range(n)), f"cot {rater}: stats {stats}")
            top = sorted(range(n), key=lambda i: -score[i])[:COT_TOPK]
            rest = [score[i] for i in range(n) if i not in top]
            check(np.array_equal(res["selected"], cands[top]) and
                  (not rest or min(score[i] for i in top) >= max(rest)),
                  f"cot {rater}: the selection is not the top {COT_TOPK} by score")
            # under random weights the answers can all be "no" and the scores
            # tie, so the selection is also held on the table with planted
            # answers: 4 candidates far from the stable order answer yes to
            # every question, every other candidate i to i mod 4 of them
            best = {n - 1, n // 2, 3, n - 2}
            yes_left = {i: len(questions) if i in best else i % len(questions)
                        for i in range(n)}
            planted = []
            for r in table:
                i = int(r["image_id"].split("/")[-1][:-4])
                planted.append(dict(r, answer="yes" if yes_left[i] > 0 else "no"))
                yes_left[i] -= 1
            chosen, _ = cot.greedy_samples_byscore(planted, topk=COT_TOPK)
            check({int(s.split("/")[-1][:-4]) for s in chosen} == best,
                  f"cot {rater}: on planted answers the selection is {chosen}, not {best}")
        census = censuses[rater] = {}
        result, dt, enqueued, counts = _timed_runs(
            f"cot {rater} rater ({n} candidates)", run_once, expect, runs=ONCE, census=census,
            validate=validate, work=(n, "candidates"))
        print("  kernel 3 launches by (H = W, C, Cout, GN): [conv, statistics]: "
              + ", ".join(f"{k}: {v}" for k, v in sorted(census.items())))
        check(census == expect_census, f"cot {rater} conv launches {census} != {expect_census}")
        table = result[1]
        yes = sum(r["answer"] == "yes" for r in table) / len(table)
        print(f"  {n / dt:.4f} candidates/s, {len(table) / dt:.4f} ratings/s; answers yes on "
              f"{yes:.4f} (random weights)")
        if profile:
            print(f"  profile of the {rater} CoT call:")
            profile_run(run_once, dt)
        out[rater] = {"seconds": dt, "enqueue_s": enqueued, "candidates": n,
                      "candidates_per_s": n / dt, "ratings_per_s": len(table) / dt}
        counts_by_rater[rater] = counts
    l, _, _ = cot_rating_shape(flagship_pipeline(vision=True))
    print(f"  vision rating prefill [{COT_SAMPLES}, {l}], cache {l + COT_RATING_TOKENS} slots, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # the measured censuses: the vision run's is the decoder's (one generation
    # call); the discrete run's less it is the encoder's, once per question
    results["cot_decoder_census"] = censuses["vision"]
    results["cot_encoder_census"] = {
        key: [(d - v) // len(questions) for d, v in
              zip(censuses["discrete"].get(key, [0, 0]), censuses["vision"].get(key, [0, 0]))]
        for key in {(hw, c, cout, gn) for hw, c, cout, gn, _ in ENCODER_CONVS}}
    results["cot"] = out
    return counts_by_rater


def run_dpg(results, profile=False):
    """``evaluation.dpg.run_dpg`` over 2 prompts x 4 samples (guidance 6, 50
    steps, text budget 256, bf16) into a temporary directory; every grid PNG
    must decode back to ``make_grid_2x2`` of its prompt's batch."""
    import os
    import tempfile
    import torch
    from unigen_tpu_torch.evaluation import dpg, geneval
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    print(f"phase: dpg (run_dpg, 2 prompts x 4 samples, guidance 6, 50 steps, text budget "
          f"{DPG_TEXT_LEN}, grid PNG writes)")
    batches = []
    pipe = _recording(flagship_pipeline(), batches)
    items = [{"item_id": f"dpg_{i:02}", "text": p} for i, p in enumerate(PROMPTS[:2])]
    expect = dict(NO_LAUNCHES, **_t2i_launches(pipe.cfg.llm.num_hidden_layers, len(items)))
    with tempfile.TemporaryDirectory() as tmp:
        def run_once():
            batches.clear()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            return dpg.run_dpg(pipe, items, os.path.join(tmp, "out"), gen,
                               eval_text_len=DPG_TEXT_LEN)

        def validate(written):
            check(len(written) == len(items) == len(batches), f"dpg wrote {written}")
            for path, item, (prompts, pixels) in zip(written, items, batches):
                check(os.path.basename(path) == f"{item['item_id']}.png" and
                      prompts == [item["text"]] * 4, f"dpg: {path} for {prompts}")
                got = geneval.load_png(path)
                check(got.shape == (2 * pipe.vq_cfg.resolution,) * 2 + (3,) and
                      (got == dpg.make_grid_2x2(pixels_to_uint8(pixels))).all(),
                      f"dpg: {path} does not decode to its batch's grid")
        _, dt, enqueued, counts = _timed_runs("dpg", run_once, expect, validate=validate,
                                              work=(4 * len(items), "images"))
        if profile:
            profile_run(run_once, dt)
    ids, _ = pipe.prompt_ids([PROMPTS[0]], DPG_TEXT_LEN)
    print(f"  every grid decodes to its batch; {4 * len(items) / dt:.4f} images/s with the grid "
          f"writes; prompt length {ids.shape[1]} (prefix {ids.shape[1] - 258}, cache "
          f"{ids.shape[1]} slots)")
    results["dpg"] = {"seconds": dt, "enqueue_s": enqueued, "images_per_s": 4 * len(items) / dt}
    return counts


def run_image_serving(results, profile=False):
    """``serving.ImageServingEngine`` at batch 4 and the GenEval protocol
    (bf16): 6 requests from 3 client threads, which the microbatcher serves
    as one full batch and one padded one. Each image must equal the direct
    ``generate_images`` of its padded batch under that batch's derived
    generator, and every kernel the scheduler thread launches must queue on
    the stream the direct call uses."""
    import threading
    import torch
    from unigen_tpu_torch.ops import _cuda
    from unigen_tpu_torch.ops.sampling import derived_generator
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    from unigen_tpu_torch.serving import ImageServingEngine
    print(f"phase: image_serving (ImageServingEngine batch {SERVING_BATCH}, guidance 6, 50 steps, "
          f"{len(SERVING_PROMPTS)} requests from 3 threads)")
    base = flagship_pipeline()
    batches = []
    pipe = _recording(base, batches)
    expect = dict(NO_LAUNCHES, **_t2i_launches(pipe.cfg.llm.num_hidden_layers, 2))
    streams = set()
    real_stream = _cuda.stream_of

    def stream_of(t):
        stream = real_stream(t)
        if threading.current_thread().name == "unigen-image-serving":
            streams.add(stream)
        return stream

    def run_once():
        batches.clear()
        futs = {}
        start = threading.Barrier(3)
        with ImageServingEngine(pipe, batch=SERVING_BATCH) as eng:
            def client(k):
                start.wait()
                for prompt in SERVING_PROMPTS[2 * k:2 * k + 2]:
                    futs[prompt] = eng.submit(prompt)
            clients = [threading.Thread(target=client, args=(k,)) for k in range(3)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(600)
            check(not any(c.is_alive() for c in clients), "image_serving: a client hung")
            images = {p: f.result(timeout=600) for p, f in futs.items()}
        return images, {p: f.done_t - f.submit_t for p, f in futs.items()}

    def validate(out):
        images, _ = out
        check(sorted(images) == sorted(SERVING_PROMPTS) and len(batches) == 2 and
              sorted(sum(p != "" for p in prompts) for prompts, _ in batches) == [2, 4],
              f"image_serving batches {[prompts for prompts, _ in batches]}")
        check(streams == {torch.cuda.current_stream().cuda_stream},
              f"image_serving: the engine thread queued on streams {streams}")
        for i, (prompts, _) in enumerate(list(batches)):
            direct = pixels_to_uint8(base.generate_images(
                prompts, derived_generator(0, i, device="cuda"), guidance_scale=6.0,
                timesteps=50, max_text_len=128))
            for row, prompt in enumerate(prompts):
                check(prompt == "" or (images[prompt] == direct[row]).all(),
                      f"image_serving: {prompt!r} differs from row {row} of the direct call "
                      f"of batch {i}")
    _cuda.stream_of = stream_of
    try:
        (_, latency), dt, enqueued, counts = _timed_runs(
            "image_serving", run_once, expect, runs=ONCE, validate=validate,
            work=(len(SERVING_PROMPTS), "images"))
    finally:
        _cuda.stream_of = real_stream
    print(f"  every image equals its batch's direct call; the engine thread queued on the "
          f"caller's stream; submit-to-done latency by request, s: "
          + ", ".join(f"{latency[p]:.3f}" for p in SERVING_PROMPTS))
    results["image_serving"] = {"seconds": dt, "images_per_s": len(SERVING_PROMPTS) / dt,
                                "latency_s": [latency[p] for p in SERVING_PROMPTS]}
    return counts


def serving_vqa_shape(pipe):
    """(L, prompt lengths, part1's length) of ``vqa_serving_inputs`` over
    QUESTIONS: part1, the image tokens and each question's part right-padded
    to a multiple of SERVE_VQA_BUCKET; every question in one bucket."""
    p = pipe.vision_cfg.num_patches
    shapes = set()
    plens = []
    for q in QUESTIONS:
        part1, part2, _ = pipe._vqa_parts([q], p, None)
        l2b = -(-part2.shape[1] // SERVE_VQA_BUCKET) * SERVE_VQA_BUCKET
        shapes.add((part1.shape[1] + p + l2b, part1.shape[1]))
        plens.append(part1.shape[1] + p + part2.shape[1])
    check(len(shapes) == 1, f"the VQA questions fall in several buckets: {shapes}")
    (l, prefix), = shapes
    return l, plens, prefix


def serving_trace(n=SERVE_REQUESTS):
    """bench_serve's trace (numpy seed 0): n prompts of 600 ids in [10, 1000),
    then n budgets uniform in [32, 224]."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(10, 1000, size=(SERVE_PROMPT,)).tolist() for _ in range(n)]
    return prompts, rng.integers(32, 225, size=n).tolist()


def serving_engine(params, cfg, **kw):
    """The engine of bench_serve: 32 slots, cache 896, bucket 640, chunk 16,
    seed 0, its admission signature warmed up (once a process)."""
    from unigen_tpu_torch.serving import ServingEngine
    kw = dict(dict(slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, buckets=(SERVE_BUCKET,),
                   chunk=SERVE_CHUNK, seed=0, precompile=[("ids", SERVE_BUCKET)],
                   device="cuda"), **kw)
    return ServingEngine(params, cfg, **kw)


@contextlib.contextmanager
def admission_census(sizes):
    """Records, while open, the row count of every batched admission the
    engine dispatches (``serving.engine._admit_core``) into ``sizes``."""
    from unigen_tpu_torch.serving import engine as TE
    real = TE._admit_core

    def counted(params, cfg, cache, state, inputs_embeds, *a, **kw):
        sizes.append(inputs_embeds.shape[0])
        return real(params, cfg, cache, state, inputs_embeds, *a, **kw)
    TE._admit_core = counted
    try:
        yield sizes
    finally:
        TE._admit_core = real


def _percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


def serve_run(eng, make_requests, static=False):
    """Drives one trace through ``eng`` with the launch counts set to 0 just
    before and read just after: ``make_requests()`` (called inside that
    window) gives [(submit kwargs, budget, eot)], all queued at once, or with
    ``static`` in waves of the slot count, each drained before the next. Checks that every request resolves
    with its budget's count of tokens or stops at its eot, that the engine
    thread serves until ``close`` and that no slot stays occupied after it.
    Returns the run's measures."""
    import torch
    sizes = []
    _reset_counts()
    torch.cuda.synchronize()
    with admission_census(sizes):
        t0 = time.perf_counter()
        requests = make_requests()
        futs = []
        step = eng.slots if static else len(requests)
        for w0 in range(0, len(requests), step):
            wave = [(eng.submit_embeds(**kw) if "inputs_embeds" in kw else eng.submit(**kw))
                    for kw, _, _ in requests[w0:w0 + step]]
            for f in wave:
                f.result(timeout=900)
            futs += wave
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = _read_counts()
    check(eng.healthy, "the serving engine's thread died during the trace")
    toks = [f.result(timeout=0) for f in futs]
    for (kw, budget, eot), t in zip(requests, toks):
        check(len(t) == budget or (eot is not None and 0 < len(t) < budget and t[-1] == eot
                                   and eot not in t[:-1]),
              f"a request of budget {budget} (eot {eot}) resolved with {len(t)} tokens")
    stats = eng.stats
    eng.close(timeout=120)
    check(not eng._thread.is_alive(), "the serving engine's thread outlived close")
    check(not eng._active.any() and all(r is None for r in eng._slot_req),
          "a slot stayed occupied after the trace")
    useful = sum(len(t) for t in toks)
    ttft = [f.ttft for f in futs]
    itl = [f.itl for f in futs if f.itl is not None]     # each request's mean
    return {"seconds": dt, "tokens": toks, "counts": counts, "groups": len(sizes),
            "group_sizes": sizes, "steps": stats.slot_steps // eng.slots,
            "chunks": stats.decode_chunks, "useful_tokens": useful,
            "tokens_per_s": useful / dt, "requests_per_s": len(futs) / dt,
            "ttft_p50_s": _percentile(ttft, 50), "ttft_p99_s": _percentile(ttft, 99),
            "itl_p50_s": _percentile(itl, 50), "itl_p99_s": _percentile(itl, 99),
            "occupancy": stats.occupancy, "busy_steps": stats.busy_steps,
            "tokens_per_busy_step": stats.tokens_generated / max(stats.busy_steps, 1),
            "t_admit_s": stats.t_admit, "t_dispatch_s": stats.t_dispatch,
            "t_harvest_s": stats.t_harvest}


def _serve_expect(run, layers, mode, tower=0, tp=False):
    """The launch counts of a serving run from its admissions and decode
    steps: a group prefill is one flash launch a layer, a decode step one
    chunk launch a layer (none with the int8 cache); a W8A8 forward quantizes
    4 x layers + 1 times (q/k/v, o, gate/up, down, head) and runs 7 x layers
    + 1 products and epilogues, a W4A8 one as many quantizations and kernel-4
    launches. ``mode``: bf16, int8+int4 (W8A8 admission, W4A8 decode), int8+kv.
    ``tp``: a rank at model > 1, where o and down each add the absmax pass
    (6 x layers + 1 quantization launches) and a W4A8 o or down ends in the
    epilogue kernel after the sum of kernel 4's partials."""
    g, st = run["groups"], run["steps"]
    quant, dense = (6 if tp else 4) * layers + 1, 7 * layers + 1
    out = dict(NO_LAUNCHES, flash_attention=tower + layers * g,
               chunk_attention=0 if mode == "int8+kv" else layers * st)
    if mode == "int8+int4":
        out.update(quantize_activations=quant * (g + st), w4a8_matmul=dense * st,
                   w8a8_epilogue=dense * g + (2 * layers * st if tp else 0),
                   int8_matmul=dense * g)
    elif mode == "int8+kv":
        out.update(quantize_activations=quant * (g + st), w8a8_epilogue=dense * (g + st),
                   int8_matmul=dense * (g + st))
    return out


def _serve_report(name, run, card_line=True):
    print(f"  {name}: {run['seconds']:.3f} s wall, {run['useful_tokens']} useful tokens, "
          f"{run['tokens_per_s']:.2f} tokens/s, {run['requests_per_s']:.4f} requests/s; TTFT p50 "
          f"{run['ttft_p50_s']:.3f} s, p99 {run['ttft_p99_s']:.3f} s; per-request mean ITL "
          f"p50 {run['itl_p50_s'] * 1e3:.2f} ms; occupancy {run['occupancy']:.4f}; "
          f"{run['groups']} admissions (rows {sorted(run['group_sizes'])}), {run['chunks']} "
          f"chunks, {run['steps']} decode steps; scheduler admit / dispatch / harvest "
          f"{run['t_admit_s']:.3f} / {run['t_dispatch_s']:.3f} / {run['t_harvest_s']:.3f} s")
    c, st, g = run["counts"], max(run["steps"], 1), max(run["groups"], 1)
    print(f"    launches {c}; a decode step: "
          + ", ".join(f"{k} {v / st:.2f}" for k, v in c.items() if v) + "; a request: "
          + ", ".join(f"{k} {v / len(run['tokens']):.2f}" for k, v in c.items() if v)
          + f"; an admission group averages {sum(run['group_sizes']) / g:.2f} rows")


def run_serving(results, profile=False):
    """The text serving engine at full width on bench_serve's trace:
    SERVE_REQUESTS requests of 600 prompt ids, greedy, budgets in [32, 224], all queued at
    once, 32 slots, chunk 16; bf16 (and the static-wave discipline over the
    same trace), ``int8+int4`` (W8A8 admission, W4A8 decode chunks, bf16
    cache) and ``int8+kv`` (W8A8 with the int8 cache, bench_serve's default)
    on its first SERVE_QUANT_REQUESTS requests. Launch counts exact from
    each run's admissions and decode steps. The bf16 run (with its tokens)
    is kept in ``results["serving_bf16_run"]`` for serving_spec."""
    import torch
    from unigen_tpu_torch.generation import generate_text
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    from unigen_tpu_torch.ops.quantization import quantize_unigen_params
    print(f"phase: serving (ServingEngine on Qwen2.5-1.5B, random init, bf16: {SERVE_REQUESTS} "
          f"requests of {SERVE_PROMPT} ids, budgets in [32, 224], {SERVE_SLOTS} slots, chunk "
          f"{SERVE_CHUNK}, bucket {SERVE_BUCKET}, cache {SERVE_MAX_LEN}, greedy)")
    pipe = flagship_pipeline()
    cfg, layers = pipe.cfg, pipe.cfg.llm.num_hidden_layers
    prompts, budgets = serving_trace()
    requests = [(dict(input_ids=p, max_new_tokens=b), b, None) for p, b in zip(prompts, budgets)]
    t0 = time.perf_counter()
    w8 = quantize_unigen_params(pipe.params, cfg, lm_head=True)
    w4 = quantize_unigen_params_int4(pipe.params, cfg)
    torch.cuda.synchronize()
    print(f"  W8A8 and W4A8 trees {time.perf_counter() - t0:.2f} s")
    modes = (("bf16", pipe.params, {}), ("int8+int4", w8, dict(decode_params=w4)),
             ("int8+kv", w8, dict(quantized_cache=True)))
    out = {}
    for mode, params, kw in modes:
        trace = requests if mode == "bf16" else requests[:SERVE_QUANT_REQUESTS]
        t0 = time.perf_counter()
        eng = serving_engine(params, cfg, **kw)
        warm = time.perf_counter() - t0
        run = serve_run(eng, lambda trace=trace: trace)
        run["requests"] = len(trace)
        expect = _serve_expect(run, layers, mode)
        _serve_report(f"{mode} continuous, {len(trace)} requests (engine and warm-up "
                      f"{warm:.2f} s before)", run)
        check(run["counts"] == expect, f"serving {mode} launch counts {run['counts']} != {expect}")
        out[mode] = run
    static = serve_run(serving_engine(pipe.params, cfg), lambda: requests, static=True)
    static["requests"] = len(requests)
    _serve_report(f"bf16 static waves of {SERVE_SLOTS}", static)
    check(static["counts"] == _serve_expect(static, layers, "bf16"),
          f"serving static launch counts {static['counts']}")
    check(static["tokens"] == out["bf16"]["tokens"],
          "the static-wave run's tokens differ from the continuous run's")
    ratio = out["bf16"]["tokens_per_s"] / static["tokens_per_s"]
    print(f"  continuous / static (bf16): {ratio:.4f}x useful tokens/s; occupancy "
          f"{out['bf16']['occupancy']:.4f} vs {static['occupancy']:.4f}")
    # a direct batch decode of the first 32 prompts: in bf16 the prefill and
    # decode shapes differ from the engine's, so agreement is printed, not gated
    n = SERVE_SLOTS
    ids = torch.as_tensor(prompts[:n], device="cuda")
    direct = generate_text(pipe.params, cfg, None, ids,
                           torch.full((n,), SERVE_PROMPT, device="cuda"),
                           max_new_tokens=max(budgets[:n])).cpu().tolist()
    same = sum(int(a == b) for t, d, b_ in zip(out["bf16"]["tokens"][:n], direct, budgets[:n])
               for a, b in zip(t, d[:b_]))
    print(f"  bf16 engine tokens equal to a direct batch decode of the first {n} prompts: "
          f"{same / sum(budgets[:n]):.4f} of {sum(budgets[:n])} (not a gate)")
    if profile:
        # a cut trace (the first 32 requests, a quarter of each budget), whose
        # trace the profiler reads in minutes; the bf16 run, and int8+int4's,
        # which carries kernel 4
        cut = [(dict(input_ids=p, max_new_tokens=b // 4), b // 4, None)
               for p, b in zip(prompts[:SERVE_SLOTS], budgets[:SERVE_SLOTS])]
        for mode, params, kw in modes[:2]:
            run = serve_run(serving_engine(params, cfg, **kw), lambda: cut)
            print(f"  profile of the {mode} run of the cut trace ({len(cut)} requests, budgets / "
                  f"4: {run['steps']} decode steps, {run['groups']} admissions, unprofiled wall "
                  f"{run['seconds']:.3f} s):")
            eng = serving_engine(params, cfg, **kw)
            profile_run(lambda eng=eng: serve_run(eng, lambda: cut), run["seconds"])
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["serving"] = {m: {k: v for k, v in r.items() if k != "tokens"}
                          for m, r in dict(out, static_bf16=static).items()}
    results["serving"]["continuous_over_static"] = ratio
    results["serving_bf16_run"] = out["bf16"]
    del w8, w4
    return {f"serving_{m.replace('+', '_')}": r["counts"] for m, r in out.items()}


def run_serving_vqa(results, profile=False):
    """The engine's VQA path at full width: the SigLIP flagship in bf16, 8
    uint8 images of 384 px and QUESTIONS through ``vqa_serving_inputs``
    (l2_bucket 64, one admission bucket) and ``submit_embeds``, 128 greedy
    tokens, eos as eot, 8 slots."""
    import torch
    print(f"phase: serving_vqa (vqa_serving_inputs -> submit_embeds, SigLIP-SO400M + Qwen2.5-1.5B "
          f"bf16, {len(QUESTIONS)} images of 384 px, {NEW_TOKENS} greedy tokens, eos as eot)")
    pipe = flagship_pipeline(vision=True)
    pixels = _vqa_pixels(pipe)
    eos = pipe.prompting.eos_token_id
    l, plens, _ = serving_vqa_shape(pipe)
    layers, vit = pipe.cfg.llm.num_hidden_layers, pipe.vision_cfg.num_layers_used
    from unigen_tpu_torch.serving import ServingEngine
    eng = ServingEngine(pipe.params, pipe.cfg, slots=len(QUESTIONS), max_len=l + NEW_TOKENS,
                        buckets=(l,), chunk=SERVE_CHUNK, device="cuda",
                        precompile=[("emb", l, pipe.cfg.llm.hidden_size)])
    holder = {}

    def requests():   # the tower and the splice, inside the counted window
        reqs = pipe.vqa_serving_inputs(pixels, list(QUESTIONS), l2_bucket=SERVE_VQA_BUCKET)
        holder["plens"] = [r[2] for r in reqs]
        return [(dict(inputs_embeds=e, meta_bits=m, prompt_len=pl, max_new_tokens=NEW_TOKENS,
                      eot_token=eos), NEW_TOKENS, eos) for e, m, pl in reqs]
    run = serve_run(eng, requests)
    check(holder["plens"] == plens, f"VQA prompt lengths {holder['plens']} != {plens}")
    expect = _serve_expect(run, layers, "bf16", tower=vit)
    check(run["counts"] == expect, f"serving_vqa launch counts {run['counts']} != {expect}")
    _serve_report(f"VQA (splice {l}, prompts {min(plens)}-{max(plens)})", run)
    if "understand_tokens" in results:
        ref = results["understand_tokens"]["bf16"].cpu().tolist()
        same = sum(int(a == b) for t, r in zip(run["tokens"], ref) for a, b in zip(t, r))
        print(f"  tokens equal to understand's bf16 batch call: {same / sum(map(len, run['tokens'])):.4f}"
              " (batch shapes differ in bf16; not a gate)")
    if profile:
        eng = ServingEngine(pipe.params, pipe.cfg, slots=len(QUESTIONS), max_len=l + NEW_TOKENS,
                            buckets=(l,), chunk=SERVE_CHUNK, device="cuda")
        profile_run(lambda: serve_run(eng, requests), run["seconds"])
    results["serving_vqa"] = {k: v for k, v in run.items() if k != "tokens"}
    return run["counts"]


def run_serving_http(results, profile=False):
    """``ServingHTTPServer`` on port 0 over the bf16 engine (bench_serve's,
    admitting one request at a time so that every admission has the shape of
    a direct ``submit``) and the image engine at batch 4: /v1/generate and
    /v1/chat/completions from client threads and one /v1/images; every reply
    well-formed, the tokens equal to ``submit``'s for the same ids, and the
    PNG equal to the direct call of its padded batch."""
    import base64
    import os
    import threading
    import urllib.request
    import torch
    from unigen_tpu_torch.evaluation.geneval import load_png
    from unigen_tpu_torch.ops.sampling import derived_generator
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    from unigen_tpu_torch.serving import ImageServingEngine, ServingHTTPServer
    print("phase: serving_http (ServingHTTPServer over the bf16 engine and the image engine at "
          f"batch {SERVING_BATCH}: 3 /v1/generate, 2 /v1/chat/completions, 1 /v1/images)")
    pipe = flagship_pipeline()
    base_tok = pipe.prompting.text_tokenizer

    class Tok:
        def encode(self, text):
            return list(base_tok._encode(text))

        def decode(self, ids):
            return base_tok.decode(list(ids))
    tok = Tok()
    prompts, _ = serving_trace(3)
    chats = [[{"role": "user", "content": q}] for q in QUESTIONS[:2]]
    new = 32
    eng = serving_engine(pipe.params, pipe.cfg, admit_cap=1)
    replies, errors = {}, []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ImageServingEngine(pipe, batch=SERVING_BATCH) as ieng, \
            ServingHTTPServer(eng, tokenizer=tok, image_engine=ieng) as srv:
        url = f"http://{srv.host}:{srv.port}"

        def post(key, route, body):
            try:
                req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    replies[key] = json.loads(r.read())
            except Exception as e:  # surfaced below as a failed check
                errors.append(f"{route}: {type(e).__name__}: {e}")
        jobs = ([(f"gen{i}", "/v1/generate", {"prompt_ids": p, "max_new_tokens": new})
                 for i, p in enumerate(prompts)]
                + [(f"chat{i}", "/v1/chat/completions", {"messages": m, "max_tokens": new})
                   for i, m in enumerate(chats)]
                + [("image", "/v1/images", {"prompt": SERVING_PROMPTS[0]})])
        clients = [threading.Thread(target=post, args=job) for job in jobs]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        check(not any(c.is_alive() for c in clients), "serving_http: a client hung")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        check(not errors, f"serving_http: {errors}")
        check(health["status"] == "ok" and health["stats"]["requests_completed"] == 5,
              f"serving_http /healthz {health}")
        # the same ids through submit, one at a time
        for i, p in enumerate(prompts):
            got = replies[f"gen{i}"]
            check(len(got["tokens"]) == new and got["tokens"] == eng.submit(
                p, max_new_tokens=new).result(timeout=600),
                f"serving_http /v1/generate {i} differs from submit")
        templ = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
        for i, m in enumerate(chats):
            got = replies[f"chat{i}"]
            direct = eng.submit(tok.encode(templ.format(m[0]["content"])),
                                max_new_tokens=new).result(timeout=600)
            check(got["object"] == "chat.completion" and
                  got["choices"][0]["message"] == {"role": "assistant",
                                                   "content": tok.decode(direct)} and
                  got["usage"]["completion_tokens"] == new,
                  f"serving_http /v1/chat/completions {i} differs from submit: {got}")
    eng.close()
    img = replies["image"]
    os.makedirs("output", exist_ok=True)
    path = os.path.join("output", "serving_http.png")
    with open(path, "wb") as f:
        f.write(base64.b64decode(img["image_png"]))
    arr = load_png(path)
    direct = pixels_to_uint8(pipe.generate_images(
        [SERVING_PROMPTS[0]] + [""] * (SERVING_BATCH - 1), derived_generator(0, 0, device="cuda"),
        guidance_scale=6.0, timesteps=50, max_text_len=128))[0]
    check(arr.shape == (img["height"], img["width"], 3) == direct.shape
          and bool((arr == direct).all()), "serving_http /v1/images differs from the direct call")
    print(f"  6 replies in {dt:.3f} s (the image's batch included); launches {counts}; "
          "/v1/generate and /v1/chat/completions equal submit's tokens, the PNG equals its "
          "padded batch's direct call")
    check(all(counts[k] > 0 for k in ("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                                      "gn_affine")), f"serving_http launches {counts}")
    results["serving_http"] = {"seconds": dt}
    return counts


def _tree_float(tree):
    """A copy of a parameter tree with every floating leaf in fp32."""
    import torch
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_float(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def verify_against_decode(pipe, k=SPEC_K):
    """One verify forward of the flagship backbone at the serving shapes
    (32 rows of k + 1 queries, cache 896, each row's index in [600, 820)
    over slots above it that hold stale keys, as after rejected drafts)
    against k + 1 single-query decode forwards from the same cache: kernel
    1 with its per-row causal offset (the unsplit route, 30-row blocks)
    against the split decode route, the model around them, and the T 160
    products against T 32. In fp32 (the bf16 weights and cache cast) the
    logits agree within 1e-3 of their largest magnitude; in bf16 the verify
    logits lie no farther from the fp32 decode's than twice the bf16
    decode's own largest distance from them."""
    import dataclasses
    import torch
    from unigen_tpu_torch.models import qwen2
    from unigen_tpu_torch.models.unigen import embed_tokens
    b, s, lq = SERVE_SLOTS, SERVE_MAX_LEN, k + 1
    top = SERVE_PROMPT + 224 - k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    ids = torch.randint(10, 1000, (b, top), generator=gen, device="cuda")
    index = torch.randint(SERVE_PROMPT, top, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    toks = torch.randint(10, 1000, (b, lq), generator=gen, device="cuda")
    lcfg = pipe.cfg.llm
    cache = qwen2.init_kv_cache(lcfg, b, s, torch.device("cuda"))
    _, cache = qwen2.forward(pipe.params["llm"], lcfg, inputs_embeds=embed_tokens(pipe.params, ids),
                             meta_bits=torch.zeros((b, top), dtype=torch.int32, device="cuda"),
                             cache=cache)
    c16 = cache._replace(index=index)
    c32 = c16._replace(k=c16.k.float(), v=c16.v.float())
    p32, cfg32 = _tree_float(pipe.params), dataclasses.replace(lcfg, dtype=torch.float32)

    def fresh(c):
        return c._replace(k=c.k.clone(), v=c.v.clone())

    def verify(params, cfg, c):
        h, _ = qwen2.forward(params["llm"], cfg, inputs_embeds=embed_tokens(params, toks),
                             cache=fresh(c))
        return qwen2.logits(params["llm"], cfg, h).float()

    def decode(params, cfg, c):
        c, out = fresh(c), []
        for j in range(lq):
            h, c = qwen2.forward(params["llm"], cfg, inputs_embeds=embed_tokens(
                params, toks[:, j:j + 1]), cache=c)
            out.append(qwen2.logits(params["llm"], cfg, h[:, 0]).float())
        return torch.stack(out, dim=1)
    with torch.no_grad():
        v32, d32 = verify(p32, cfg32, c32), decode(p32, cfg32, c32)
        v16, d16 = verify(pipe.params, lcfg, c16), decode(pipe.params, lcfg, c16)
    torch.cuda.synchronize()
    scale = d32.abs().max().item()
    e32 = (v32 - d32).abs().max().item()
    e_v16, e_d16 = (v16 - d32).abs().max().item(), (d16 - d32).abs().max().item()
    m_v16, m_d16 = (v16 - d32).abs().mean().item(), (d16 - d32).abs().mean().item()
    agree = (v16.argmax(-1) == d16.argmax(-1)).float().mean().item()
    print(f"  verify forward q [{b},{lq}] S={s} against {lq} decode forwards (the logits, "
          f"max |logit| {scale:.3f}): fp32 max diff {e32:.3e} (tol {1e-3 * scale:.3e}); bf16 "
          f"from the fp32 decode: verify max {e_v16:.4f} mean {m_v16:.5f}, decode max "
          f"{e_d16:.4f} mean {m_d16:.5f}; bf16 argmax agreement {agree:.4f}")
    check(all(map(torch.isfinite, (v32.sum(), v16.sum()))), "verify forward: logits not finite")
    check(e32 <= 1e-3 * scale, f"verify forward fp32 differs from the decode forwards by {e32}")
    check(e_v16 <= 2 * e_d16, f"verify forward bf16: {e_v16} from the fp32 decode, more than "
          f"twice the bf16 decode's {e_d16}")
    del p32, c32, v32, d32, v16, d16
    return {"fp32_max_diff": e32, "bf16_verify_max": e_v16, "bf16_decode_max": e_d16,
            "bf16_argmax_agreement": agree}


def run_serving_spec(results, profile=False):
    """The speculative engine at full width on the serving phase's bf16
    trace (SERVE_REQUESTS requests of 600 ids, greedy, budgets in [32, 224], 32 slots,
    chunk 16, all queued at once), ``speculate_k=4``, beside the plain
    engine on the same trace in this call (the serving phase's bf16 run when
    that phase ran: the same engine on the same trace). Launch counts exact:
    a verify step is one kernel-1 launch a layer. Then the tiny fp32 engine: the
    speculative one on the card against the CPU and against the plain one
    (greedy; sampled rows card against card), and one verify chunk under
    CUDA's sync debug mode "error". Between them, ``verify_against_decode``
    holds the full-width verify forward against decode forwards."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.models import qwen2
    from unigen_tpu_torch.serving import ServingEngine
    from unigen_tpu_torch.serving import engine as TE
    print(f"phase: serving_spec (ServingEngine speculate_k={SPEC_K} on Qwen2.5-1.5B, random "
          f"init, bf16: the serving trace, {SERVE_REQUESTS} requests, {SERVE_SLOTS} slots, "
          f"chunk {SERVE_CHUNK}; beside the plain engine)")
    pipe = flagship_pipeline()
    cfg, layers = pipe.cfg, pipe.cfg.llm.num_hidden_layers
    prompts, budgets = serving_trace()
    requests = [(dict(input_ids=p, max_new_tokens=b), b, None) for p, b in zip(prompts, budgets)]
    out = {}
    for mode, kw in (("plain", {}), ("spec", dict(speculate_k=SPEC_K))):
        if mode == "plain" and "serving_bf16_run" in results:
            out[mode] = results["serving_bf16_run"]
            print("  plain: the serving phase's bf16 continuous run of this trace, in this call")
            continue
        t0 = time.perf_counter()
        eng = serving_engine(pipe.params, cfg, **kw)
        warm = time.perf_counter() - t0
        run = serve_run(eng, lambda: requests)
        _serve_report(f"{mode} (engine and warm-up {warm:.2f} s before)", run)
        print(f"    tokens accepted per busy step {run['tokens_per_busy_step']:.4f}; "
              f"per-request mean ITL p99 {run['itl_p99_s'] * 1e3:.2f} ms")
        expect = _serve_expect(run, layers, "bf16")
        check(run["counts"] == expect, f"serving_spec {mode} launch counts {run['counts']} != "
              f"{expect}")
        out[mode] = run
    spec, plain = out["spec"], out["plain"]
    check(spec["counts"]["chunk_attention"] == layers * spec["steps"],
          "serving_spec: kernel 1 did not run 28 times a verify step")
    same = sum(int(a == b) for s_, p_ in zip(spec["tokens"], plain["tokens"])
               for a, b in zip(s_, p_))
    share = same / sum(budgets)
    ratio = spec["tokens_per_s"] / plain["tokens_per_s"]
    print(f"  speculative / plain: {ratio:.4f}x useful tokens/s; {spec['steps']} verify steps "
          f"against {plain['steps']} decode steps; greedy tokens equal to the plain engine's: "
          f"{share:.4f} of {sum(budgets)} (bf16: the verify step's 5-query attention and "
          "products round otherwise than the decode step's; not a gate)")
    forward_check = verify_against_decode(pipe)

    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3)
    gpu = cpu.to("cuda")
    rng = np.random.default_rng(8)
    tiny_prompts = [rng.integers(3, 250, size=(n,)).tolist() for n in (5, 11, 3, 9, 7, 4)]
    tiny_budgets = [12, 5, 30, 9, 16, 6]

    def tiny_run(p, dev, k, temps=(0.0,) * 6):
        with ServingEngine(p.params, p.cfg, slots=3, max_len=64, buckets=(8, 16),
                           chunk=(2, 4, 8), speculate_k=k, seed=5, device=dev) as eng:
            futs = [eng.submit(x, max_new_tokens=m, temperature=t)
                    for x, m, t in zip(tiny_prompts, tiny_budgets, temps)]
            got = [f.result(timeout=300) for f in futs]
            return got, eng.stats.tokens_generated / max(eng.stats.busy_steps, 1)
    _reset_counts()
    card, rate = tiny_run(gpu, "cuda", SPEC_K)
    torch.cuda.synchronize()
    counts = _read_counts()
    host, _ = tiny_run(cpu, "cpu", SPEC_K)
    card_plain, _ = tiny_run(gpu, "cuda", 0)
    print(f"  tiny fp32 speculative engine: card {'==' if card == host else '!='} CPU, "
          f"{'==' if card == card_plain else '!='} plain engine, over {sum(map(len, host))} "
          f"tokens; {rate:.3f} tokens a busy step; launches {counts}")
    check(card == host == card_plain, f"tiny speculative engine: card {card} vs CPU {host} vs "
          f"plain {card_plain}")
    check(counts["chunk_attention"] > 0 and counts["flash_attention"] > 0,
          f"tiny speculative launches {counts}")
    temps = (0.0, 0.8, 0.0, 1.0, 0.0, 0.7)
    sampled, plain_sampled = tiny_run(gpu, "cuda", SPEC_K, temps)[0], tiny_run(gpu, "cuda", 0,
                                                                                temps)[0]
    check(sampled == plain_sampled, "tiny speculative engine with sampled rows differs from the "
          "plain engine on the card")
    cache = qwen2.init_kv_cache(gpu.cfg.llm, 3, 24, torch.device("cuda"), per_row_index=True)
    cache = cache._replace(index=torch.tensor([4, 0, 9], dtype=torch.int32, device="cuda"))
    state = TE.init_slot_state(3, torch.device("cuda"))._replace(
        active=torch.tensor([True, False, True], device="cuda"),
        budget=torch.full((3,), 5, dtype=torch.int32, device="cuda"),
        temp=torch.tensor([0.0, 0.0, 0.8], device="cuda"))
    ctx = torch.randint(0, 5, (3, 24), device="cuda")
    ctx_start = torch.zeros((3,), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, toks, acc = TE._spec_decode_chunk(gpu.params, gpu.cfg, cache, state, ctx,
                                                ctx_start, 3, SPEC_K, None, [(2, 5, 10)])
    except RuntimeError as e:
        raise Failed(f"a verify chunk synchronised with the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(toks.shape) == (3, 3, SPEC_K + 1) and tuple(acc.shape) == (3, 3),
          f"verify chunk outputs {tuple(toks.shape)}, {tuple(acc.shape)}")
    print("  the tiny speculative engine with sampled rows equals the plain engine on the card; "
          "a verify chunk (3 slots, 3 steps, one sampling row) ran under sync debug mode "
          "'error': no host synchronisation")
    results["serving_spec"] = {m: {k: v for k, v in r.items() if k != "tokens"}
                               for m, r in out.items()}
    results["serving_spec"].update(spec_over_plain=ratio, greedy_share_equal=share,
                                   verify_forward=forward_check)
    return spec["counts"]


SERVE_ENTRY_ARGS = (f"config={SERVE_CONFIG}", "serving.host=127.0.0.1", "serving.port=0",
                    f"serving.speculate_k={SPEC_K}", "serving.int4_decode=true",
                    "serving.images=true", f"serving.image_batch={SERVING_BATCH}",
                    f"serving.slots={SERVE_SLOTS}", f"serving.max_len={SERVE_MAX_LEN}",
                    f"serving.buckets=[{SERVE_BUCKET}]", f"serving.chunk={SERVE_CHUNK}",
                    f"serving.max_new_tokens={SERVE_ENTRY_NEW}")


def _post(url, route, body=None):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + route, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_entry_process():
    """``python -m unigen_tpu_torch.serving.serve`` with SERVE_ENTRY_ARGS as
    a subprocess: the seconds from its start to an answer on /healthz, one
    /v1/generate, then SIGTERM, exit code 0 and an orderly shutdown in its
    log (``output/serve_entry.log``). Returns (seconds to healthy, the
    tokens of SERVE_ENTRY_PROMPTS[0])."""
    import os
    import select
    import signal
    os.makedirs("output", exist_ok=True)
    log_path = os.path.join("output", "serve_entry.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "unigen_tpu_torch.serving.serve",
                                 *SERVE_ENTRY_ARGS], stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 600)
        line = proc.stdout.readline() if ready else ""
        if not line.startswith("serving on "):
            proc.wait(timeout=60)
            with open(log_path) as f:
                raise Failed(f"serve_entry: the server did not come up (exit {proc.poll()}): "
                             f"{line!r}\n{f.read()[-3000:]}")
        url = "http://" + line.split()[-1]
        health = _post(url, "/healthz")
        healthy_s = time.perf_counter() - t0
        check(health["status"] == "ok", f"serve_entry process /healthz {health}")
        tokens = _post(url, "/v1/generate", {"prompt": SERVE_ENTRY_PROMPTS[0]})["tokens"]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    check(rc == 0, f"serve_entry: the server exited {rc} on SIGTERM")
    with open(log_path) as f:
        check("shutting down" in f.read(), "serve_entry: no orderly shutdown in the log")
    return healthy_s, tokens


def run_serve_entry(results, profile=False):
    """The serve entry over the flagship SFT config (SigLIP tower; random
    init; the port's YAML reader) with ``serving.speculate_k=4``,
    ``serving.int4_decode=true`` and ``serving.images=true`` at the serving
    phase's shapes (32 slots, cache 896, bucket 640, image batch 4). First
    as a subprocess (``serve_entry_process``: seconds to healthy, SIGTERM).
    Then in this process, ``serve.build_server`` of the same config with
    its HTTP server started, the launch counts set to 0 just before the
    routes and read just after: /healthz, 3 /v1/generate and one
    /v1/chat/completions one at a time, and one /v1/images. The counts are
    exact from the run's admissions (bf16, one flash launch a layer each),
    verify steps (one kernel-1 launch a layer; W4A8: 4 x layers + 1
    quantizations, 7 x layers + 1 kernel-4 launches) and the image's t2i
    batch. The replies are held against ``submit`` on the same engine, the
    PNG against the direct call of its padded batch, and the subprocess's
    tokens against the in-process server's."""
    import base64
    import os
    import torch
    from unigen_tpu_torch.evaluation.geneval import load_png
    from unigen_tpu_torch.ops.sampling import derived_generator
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    from unigen_tpu_torch.serving import serve
    from unigen_tpu_torch.utils.configuration import initialize_config
    print(f"phase: serve_entry (python -m unigen_tpu_torch.serving.serve "
          f"{' '.join(SERVE_ENTRY_ARGS)}; then serve.build_server of the same config in this "
          "process)")
    healthy_s, proc_tokens = serve_entry_process()
    t0 = time.perf_counter()
    server, eng, ieng = serve.build_server(initialize_config(SERVE_CONFIG, list(SERVE_ENTRY_ARGS)))
    build_s = time.perf_counter() - t0
    pipe, layers = ieng.pipeline, ieng.pipeline.cfg.llm.num_hidden_layers
    tok = server.tokenizer
    sizes = []
    try:
        server.start()
        url = f"http://{server.host}:{server.port}"
        torch.cuda.synchronize()
        _reset_counts()
        with admission_census(sizes):
            t1 = time.perf_counter()
            health = _post(url, "/healthz")
            gens = [_post(url, "/v1/generate", {"prompt": p}) for p in SERVE_ENTRY_PROMPTS]
            gen_s = time.perf_counter() - t1
            chat = _post(url, "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": QUESTIONS[0]}],
                          "max_tokens": 16})
            t1 = time.perf_counter()
            img = _post(url, "/v1/images", {"prompt": SERVING_PROMPTS[0]})
            img_s = time.perf_counter() - t1
            torch.cuda.synchronize()
        counts = _read_counts()
        steps = eng.stats.slot_steps // eng.slots
        check(health["status"] == "ok", f"serve_entry /healthz {health}")
        im_end = pipe.prompting.sptids_dict["<|im_end|>"]
        got = [g["tokens"] for g in gens]
        want = [eng.submit(tok.encode(p), max_new_tokens=SERVE_ENTRY_NEW,
                           eot_token=im_end).result(timeout=600) for p in SERVE_ENTRY_PROMPTS]
        check(got == want, f"serve_entry /v1/generate {got} differs from submit's {want}")
        check(proc_tokens == got[0], f"serve_entry: the subprocess served {proc_tokens}, this "
              f"process {got[0]}")
        templ = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
        direct = eng.submit(tok.encode_raw(templ.format(QUESTIONS[0])), max_new_tokens=16,
                            eot_token=im_end).result(timeout=600)
        check(chat["object"] == "chat.completion" and chat["choices"][0]["message"] ==
              {"role": "assistant", "content": tok.decode(direct)},
              f"serve_entry /v1/chat/completions {chat} differs from submit's {direct}")
    finally:
        server.close()
        eng.close()
        ieng.close()
    check(not eng._thread.is_alive() and not eng._active.any(),
          "serve_entry: the engine outlived close or kept a slot")
    path = os.path.join("output", "serve_entry.png")
    with open(path, "wb") as f:
        f.write(base64.b64decode(img["image_png"]))
    arr = load_png(path)
    ref = pixels_to_uint8(pipe.generate_images(
        [SERVING_PROMPTS[0]] + [""] * (SERVING_BATCH - 1), derived_generator(0, 0, device="cuda"),
        guidance_scale=6.0, timesteps=50, max_text_len=128))[0]
    check(arr.shape == (img["height"], img["width"], 3) == ref.shape == (256, 256, 3)
          and bool((arr == ref).all()), "serve_entry /v1/images differs from the direct call")
    g = len(sizes)
    expect = dict(NO_LAUNCHES, flash_attention=layers * g, chunk_attention=layers * steps,
                  quantize_activations=(4 * layers + 1) * steps,
                  w4a8_matmul=(7 * layers + 1) * steps)
    for name, n in _t2i_launches(layers).items():
        expect[name] += n
    print(f"  subprocess healthy {healthy_s:.2f} s after the start, exit 0 on SIGTERM, its "
          f"tokens equal this process's; build_server {build_s:.2f} s; 3 /v1/generate "
          f"{gen_s:.3f} s ({sum(map(len, got))} tokens, {steps} verify steps, {g} admissions of "
          f"rows {sizes}), /v1/images {img_s:.3f} s; the replies equal submit's, the PNG its "
          f"padded batch's direct call; launches {counts}")
    check(counts == expect, f"serve_entry launch counts {counts} != {expect}")
    results["serve_entry"] = {"healthy_s": healthy_s, "build_s": build_s, "generate_s": gen_s,
                              "image_s": img_s, "verify_steps": steps, "admissions": g}
    del pipe, server, eng, ieng
    return counts


def run_tiny_serving():
    """A tiny fp32 ServingEngine on the card against the same run on the CPU,
    token for token: staggered admissions, one eot stop, one cancellation,
    the int8 cache and a shared prefix. And one decode chunk on the card
    under ``torch.cuda.set_sync_debug_mode("error")``: it reads nothing back."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.models import qwen2
    from unigen_tpu_torch.serving import ServingEngine
    from unigen_tpu_torch.serving import engine as TE
    print("phase: tiny fp32 serving engine, kernels on the card vs plain versions on the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3)
    gpu = cpu.to("cuda")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, 250, size=(n,)).tolist() for n in (5, 11, 3, 9, 7, 4)]
    budgets = [12, 5, 8, 9, 16, 6]

    def trace(pipe, dev, eot=None, **kw):
        with ServingEngine(pipe.params, pipe.cfg, slots=3, max_len=64, buckets=(8, 16),
                           chunk=(2, 4, 8), device=dev, **kw) as eng:
            f0 = eng.submit(prompts[0], max_new_tokens=budgets[0])
            f1 = eng.submit(prompts[1], max_new_tokens=budgets[1])
            f1.result(timeout=300)                 # a slot frees while f0 decodes
            doomed = eng.submit(prompts[0][::-1], max_new_tokens=40)
            next(doomed.stream(timeout=300))
            doomed.cancel()
            rest = [eng.submit(p, max_new_tokens=b, eot_token=eot)
                    for p, b in zip(prompts[2:], budgets[2:])]
            out = [f.result(timeout=300) for f in [f0, f1] + rest]
            try:
                doomed.result(timeout=300)
                cancelled = False
            except Exception:
                cancelled = True
            return out, cancelled
    eot = trace(cpu, "cpu")[0][2][1]          # the 2nd token of request 2 stops it
    for name, kw in (("float cache", {}), ("int8 cache", dict(quantized_cache=True)),
                     ("shared prefix", dict(prefix_ids=[17, 33, 2, 99]))):
        _reset_counts()
        got, cancelled = trace(gpu, "cuda", eot, **kw)
        torch.cuda.synchronize()
        counts = _read_counts()
        want, _ = trace(cpu, "cpu", eot, **kw)
        print(f"  {name}: card {'==' if got == want else '!='} CPU over {sum(map(len, want))} "
              f"tokens; the eot request stopped at {len(got[2])}; the cancelled request failed: "
              f"{cancelled}; launches {counts}")
        check(got == want and cancelled, f"tiny serving ({name}): card {got} vs CPU {want}")
        check(counts["flash_attention"] > 0 and
              (counts["chunk_attention"] == 0) == bool(kw.get("quantized_cache")),
              f"tiny serving ({name}) launches {counts}")
    cfg, params = gpu.cfg, gpu.params
    cache = qwen2.init_kv_cache(cfg.llm, 3, 16, torch.device("cuda"), per_row_index=True)
    cache = cache._replace(index=torch.tensor([4, 0, 9], dtype=torch.int32, device="cuda"))
    state = TE.init_slot_state(3, torch.device("cuda"))._replace(
        active=torch.tensor([True, False, True], device="cuda"),
        budget=torch.full((3,), 5, dtype=torch.int32, device="cuda"),
        temp=torch.tensor([0.0, 0.0, 0.8], device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, toks = TE._decode_chunk(params, cfg, cache, state, 4, None, [(2, 5, 10)])
    except RuntimeError as e:
        raise Failed(f"a decode chunk synchronised with the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(toks.shape) == (3, 4), f"decode chunk tokens {tuple(toks.shape)}")
    print("  a decode chunk (3 slots, 4 steps, one sampling row) ran under sync debug mode "
          "'error': no host synchronisation")


def run_tiny_slice():
    """The tiny fp32 pipeline through the kernels on the card against the
    plain versions on the CPU: the codes of ``encode_pixels``, AR tokens
    under shared noise, ``understand_discrete``'s greedy tokens (agreement
    >= 0.99 each) and ``score_continuations`` (relative difference <= 1e-4)."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 encode, AR t2i, discrete understanding and scoring, kernels on the "
          "card vs plain versions on the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    gpu = cpu.to("cuda")
    b, res = len(QUESTIONS), cpu.vq_cfg.resolution
    rng = np.random.default_rng(6)
    px = rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)

    def launched(fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, _read_counts()
    codes_gpu, c_enc = launched(lambda: gpu.encode_pixels(px))
    enc = (codes_gpu.cpu() == cpu.encode_pixels(px)).float().mean().item()
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    noise = rng.random((n, len(PROMPTS), cb), dtype=np.float32)
    kw = dict(guidance_scale=6.0, max_text_len=16, mode="ar", return_codes=True)
    ar_gpu, c_ar = launched(lambda: gpu.generate_images(
        list(PROMPTS), None, noise=torch.from_numpy(noise).cuda(), **kw))
    ar = (ar_gpu.cpu() == cpu.generate_images(list(PROMPTS), None,
                                              noise=torch.from_numpy(noise), **kw)
          ).float().mean().item()
    und_gpu, c_und = launched(lambda: gpu.understand_discrete(px, list(QUESTIONS), None,
                                                              max_new_tokens=32))
    und = (und_gpu.cpu() == cpu.understand_discrete(px, list(QUESTIONS), None,
                                                    max_new_tokens=32)).float().mean().item()
    img = rng.integers(0, 256, (b, cpu.vision_cfg.image_size, cpu.vision_cfg.image_size, 3),
                       dtype=np.uint8)
    conts = score_conts(cpu)
    sc_gpu, c_sc = launched(lambda: gpu.score_continuations(img, list(QUESTIONS), conts))
    sc_cpu = cpu.score_continuations(img, list(QUESTIONS), conts)
    rel = max(abs(g - c) / max(abs(c), 1e-30) for (g, _), (c, _) in zip(sc_gpu, sc_cpu))
    flags = np.mean([g == c for (_, g), (_, c) in zip(sc_gpu, sc_cpu)])
    print(f"  encode_pixels code agreement {enc:.4f}, AR token agreement {ar:.4f}, "
          f"understand_discrete token agreement {und:.4f} (each need >= 0.99); score "
          f"log-likelihoods max relative difference {rel:.3e} (need <= 1e-4), greedy flags "
          f"agree on {flags:.4f}")
    print(f"  launches: encode {c_enc}; AR {c_ar}; understand_discrete {c_und}; score {c_sc}")
    check(c_enc["conv3x3_gn_swish"] > 0 and c_enc["gn_affine"] > 0,
          f"tiny encode skipped kernel 3: {c_enc}")
    check(c_ar["flash_attention"] > 0 and c_ar["chunk_attention"] > 0,
          f"tiny AR skipped an attention kernel: {c_ar}")
    check(all(c_und[k] > 0 for k in ("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                                     "gn_affine")), f"tiny understand_discrete launches {c_und}")
    check(c_sc["flash_attention"] > 0 and c_sc["chunk_attention"] == 0,
          f"tiny score launches {c_sc}")
    check(enc >= 0.99 and ar >= 0.99 and und >= 0.99 and rel <= 1e-4,
          f"tiny slice agreement: encode {enc}, AR {ar}, understand_discrete {und}, score {rel}")


def run_tiny_cot():
    """``evaluation.cot.rate_candidates`` on the tiny fp32 pipeline, both
    raters, the card against the CPU on the same candidates: the rating
    tokens agree (>= 0.99, as every tiny check) and the rating rows are
    printed beside them."""
    import dataclasses
    import numpy as np
    import torch
    from unigen_tpu_torch.evaluation import cot
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 CoT rating (SigLIP and discrete raters), kernels on the card vs "
          "plain versions on the CPU, greedy")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    gpu = cpu.to("cuda")
    res = cpu.vq_cfg.resolution
    px = np.random.default_rng(7).uniform(-1, 1, (4, res, res, 3)).astype(np.float32)

    def recording(p, tokens):
        p = dataclasses.replace(p)
        for name in ("understand", "understand_discrete"):
            def spy(*a, _real=getattr(p, name), **k):
                out = _real(*a, **k)
                tokens.append(out.cpu())
                return out
            setattr(p, name, spy)
        return p
    for rater, vision in (("vision", True), ("discrete", False)):
        toks_gpu, toks_cpu = [], []
        kw = dict(style="rule", max_new_tokens=32, use_vision_tower=vision)
        _reset_counts()
        rows_gpu = cot.rate_candidates(recording(gpu, toks_gpu), px, COT_PROMPT, None, **kw)
        torch.cuda.synchronize()
        counts = _read_counts()
        rows_cpu = cot.rate_candidates(recording(cpu, toks_cpu), px, COT_PROMPT, None, **kw)
        agree = (torch.cat(toks_gpu) == torch.cat(toks_cpu)).float().mean().item()
        same_rows = np.mean([g == c for g, c in zip(rows_gpu, rows_cpu)])
        print(f"  {rater} rater: {len(rows_gpu)} rows, rating token agreement {agree:.4f} (need "
              f">= 0.99), rows equal on {same_rows:.4f}, launches {counts}")
        used = ("flash_attention", "chunk_attention") + (
            () if vision else ("conv3x3_gn_swish", "gn_affine"))
        check(len(rows_gpu) == len(rows_cpu) == 4 * len(cot.geneval_prompt2questions(COT_PROMPT))
              and all(counts[k] > 0 for k in used), f"tiny cot {rater}: launches {counts}")
        check(agree >= 0.99, f"tiny cot {rater}: rating token agreement {agree}")


def run_tiny_understand():
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    print("phase: tiny fp32 W4A8 understand, kernels on the card vs plain versions on the "
          "CPU, greedy")
    import dataclasses
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    cpu = dataclasses.replace(cpu, params=quantize_unigen_params_int4(cpu.params, cpu.cfg,
                                                                      group=32))
    gpu = cpu.to("cuda")
    size = cpu.vision_cfg.image_size
    pixels = np.random.default_rng(6).integers(0, 256, (len(QUESTIONS), size, size, 3),
                                               dtype=np.uint8)
    _reset_counts()
    toks_gpu = gpu.understand(pixels, list(QUESTIONS), None, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _read_counts()
    toks_cpu = cpu.understand(pixels, list(QUESTIONS), None, max_new_tokens=32)
    agree = (toks_gpu.cpu() == toks_cpu).float().mean().item()
    print(f"  token agreement {agree:.4f} (need >= 0.99), launches {counts}")
    check(all(counts[k] > 0 for k in ("flash_attention", "chunk_attention", "w4a8_matmul",
                                      "quantize_activations")),
          f"tiny understand skipped a kernel: {counts}")
    check(agree >= 0.99, f"tiny understand token agreement {agree}")


@contextlib.contextmanager
def decode_decisions(record, force=None):
    """While open, records each step's greedy decision of
    ``generation.decode`` ([B] tokens a step) into ``record``; with ``force``
    ([B, steps] tokens) every step continues from force's token instead of
    its own, so that two runs decide each step from the same history."""
    from unigen_tpu_torch.generation import decode as TD
    real = TD._sample_step

    def spy(generator, logits, temperature, top_k, inj=None):
        tok = real(generator, logits, temperature, top_k, inj)
        record.append(tok.cpu())
        return tok if force is None else force[:, len(record) - 1].to(tok.device)
    TD._sample_step = spy
    try:
        yield record
    finally:
        TD._sample_step = real


def run_tiny_int8():
    """The tiny fp32 pipeline with ``quantization="int8"``: understand with
    W8A8 alone and with the int8 KV cache (greedy), and t2i on the int8
    image head (shared noise), through the kernels on the card against the
    plain versions on the CPU. An fp32 difference in the last bits (sums in
    another order) can move a value across an int8 rounding boundary, and a
    greedy decode then follows the moved token for the rest of its row; so
    the int8-cache run is held per decision, each step decided from the
    CPU's history (the per-step measure of JAX's int8 gates), and its
    free-running agreement is printed beside it."""
    import dataclasses
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 int8 (W8A8, int8 KV cache), kernels on the card vs plain versions on "
          "the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True,
                         quantization="int8", quantized_cache=True)
    gpu = cpu.to("cuda")
    size = cpu.vision_cfg.image_size
    pixels = np.random.default_rng(6).integers(0, 256, (len(QUESTIONS), size, size, 3),
                                               dtype=np.uint8)

    def understand(p):
        return p.understand(pixels, list(QUESTIONS), None, max_new_tokens=32).cpu()
    _reset_counts()
    toks_gpu = understand(gpu)
    torch.cuda.synchronize()
    u_counts = _read_counts()
    cpu_dec, gpu_dec = [], []
    with decode_decisions(cpu_dec):
        toks_cpu = understand(cpu)
    with decode_decisions(gpu_dec, force=toks_cpu):
        understand(gpu)
    per_decision = (torch.stack(gpu_dec, 1) == torch.stack(cpu_dec, 1)).float().mean().item()
    free = (toks_gpu == toks_cpu).float().mean().item()
    w8 = (understand(dataclasses.replace(gpu, quantized_cache=False)) ==
          understand(dataclasses.replace(cpu, quantized_cache=False))).float().mean().item()
    b, steps = len(PROMPTS), 8
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    rng = np.random.default_rng(5)
    u_sample = rng.random((steps, b, n, cb), dtype=np.float32)
    u_mask = rng.random((steps, b, n), dtype=np.float32)
    kw = dict(guidance_scale=6.0, timesteps=steps, max_text_len=16, return_codes=True)
    _reset_counts()
    codes_gpu = gpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample).cuda(), torch.from_numpy(u_mask).cuda()), **kw)
    torch.cuda.synchronize()
    t_counts = _read_counts()
    codes_cpu = cpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample), torch.from_numpy(u_mask)), **kw)
    t_agree = (codes_gpu.cpu() == codes_cpu).float().mean().item()
    print(f"  understand, W8A8 + int8 KV cache: decisions from the CPU's histories agree on "
          f"{per_decision:.4f} (need >= 0.99); free-running token agreement {free:.4f}; "
          f"launches {u_counts}")
    print(f"  understand, W8A8 alone: token agreement {w8:.4f} (need >= 0.99)")
    print(f"  t2i (int8 image head) token agreement {t_agree:.4f} (need >= 0.99), launches "
          f"{t_counts}")
    check(all(u_counts[k] > 0 for k in ("flash_attention", "w8a8_epilogue",
                                        "quantize_activations")) and
          u_counts["chunk_attention"] == 0, f"tiny int8 understand launches {u_counts}")
    check(all(t_counts[k] > 0 for k in ("flash_attention", "chunk_attention", "w8a8_epilogue",
                                        "quantize_activations")),
          f"tiny int8 t2i skipped a kernel: {t_counts}")
    check(per_decision >= 0.99 and w8 >= 0.99 and t_agree >= 0.99,
          f"tiny int8 agreement: int8-cache decisions {per_decision}, W8A8 understand {w8}, "
          f"t2i {t_agree}")


def run_tiny():
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 path, kernels on the card vs plain versions on the CPU, "
          "shared noise")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3)
    gpu = cpu.to("cuda")
    b, steps = len(PROMPTS), 8
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    rng = np.random.default_rng(5)
    u_sample = rng.random((steps, b, n, cb), dtype=np.float32)
    u_mask = rng.random((steps, b, n), dtype=np.float32)
    kw = dict(guidance_scale=6.0, timesteps=steps, max_text_len=16, return_codes=True)
    _reset_counts()
    codes_gpu = gpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample).cuda(), torch.from_numpy(u_mask).cuda()), **kw)
    pix_gpu = gpu.decode_codes(codes_gpu)
    torch.cuda.synchronize()
    counts = _read_counts()
    codes_cpu = cpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample), torch.from_numpy(u_mask)), **kw)
    pix_cpu = cpu.decode_codes(codes_gpu.cpu())
    agree = (codes_gpu.cpu() == codes_cpu).float().mean().item()
    perr = (pix_gpu.cpu() - pix_cpu).abs().max().item()
    print(f"  token agreement {agree:.4f} (need >= 0.99), launches {counts}, "
          f"decode max_abs_err {perr:.3e} (tol 1e-4)")
    check(all(counts[k] > 0 for k in ("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                                      "gn_affine")),
          f"tiny path skipped a kernel: {counts}")
    check(agree >= 0.99, f"tiny token agreement {agree}")
    check(perr <= 1e-4, f"tiny decode disagrees: {perr}")


def _train_step_flops(trainer, bits):
    """(model FLOPs, FLOPs with the recompute) of one PT2 step: the body's
    matmuls (2 N a token forward, N the non-embedding parameters), the
    chunked head over the label positions (2 D V a position) and masked
    attention (4 h dh a visible pair); model = forward + backward (x3),
    with the recompute of the layers (remat) and of the CE chunks x4."""
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.training.optimizer import named_leaves
    cfg, tcfg = trainer.cfg, trainer.tcfg
    b, l = bits.shape
    body = sum(t.numel() for p, t in named_leaves(trainer.state.params)
               if p.startswith("llm/layers/"))
    n = cfg.num_vq_tokens
    head_pos = tcfg.batch_size_t2i * n + (tcfg.batch_size_lm + tcfg.batch_size_mmu) * (l - 1)
    vis = M.unpack_meta(bits).visibility().sum().item()
    c = cfg.llm
    attn = 4.0 * c.num_attention_heads * c.head_dim * vis * c.num_hidden_layers
    fwd = 2.0 * body * b * l + 2.0 * head_pos * c.hidden_size * cfg.vocab_size + attn
    return 3 * fwd, 4 * fwd


def _train_profile(step_once, tx, warm_s):
    """One more profiled training step (``step_once()``): device busy and idle
    share, time by kernel and family (``profile_run``), then the device time
    inside the annotated parts: the encodes (``magvit.get_code``), the SigLIP
    or NaFlex tower, kernel 2's forward launches and its backward (the
    backward kernel), the chunked CE's chunks (forward and recompute; their
    backward runs in autograd's engine, outside the annotation) and the
    optimizer update."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from unigen_tpu_torch.models import magvit, siglip, siglip2, unigen
    from unigen_tpu_torch.ops import flash_attention as FA
    from unigen_tpu_torch.utils import trace_analysis as TA

    def annotated(name, fn):
        def wrapped(*a, **kw):
            with record_function(f"train::{name}"):
                return fn(*a, **kw)
        return wrapped
    patches = [(magvit, "get_code", "encode"), (siglip, "forward", "tower"),
               (siglip2, "forward_with_pos", "tower"),
               (FA, "flash_attention_launch", "attention fwd"),
               (unigen, "_chunk_label_logps", "chunked CE"), (tx, "update", "optimizer")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    real_bwd = FA._FlashAttention.backward
    try:
        for obj, attr, name in patches:
            setattr(obj, attr, annotated(name, getattr(obj, attr)))
        FA._FlashAttention.backward = staticmethod(annotated("attention bwd", real_bwd))
        profile_run(step_once, warm_s)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_once()
            torch.cuda.synchronize()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
        FA._FlashAttention.backward = staticmethod(real_bwd)
    parts = TA.annotated_ms(TA.profiler_events(prof), "train::")
    print("  device time inside the annotated parts of one step (GPU annotations): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(parts.items())))


def run_train(results, profile=False):
    """PT2 pretraining at the flagship width through the train entry's
    builder (``training.train.build_trainer``) and ``Trainer.train``:
    Qwen2.5-1.5B + the frozen MAGViTv2, random init (no
    ``output/unigen_pt1``), bf16 parameters and AdamW state, remat and the
    chunked CE, 8 t2i + 2 lm + 6 mmu rows of 576 tokens a step, synthetic
    flows; TRAIN_WARM + TRAIN_TIMED steps, each followed by a
    synchronize. Gates: exact launches a step (kernel 2: 28 forward + 28
    in the remat recompute, 28 backward; kernel 3: both encodes), finite losses and grad
    norms, a parameter moved; then one step's losses and grad norm through
    kernel 2 against the same step through the plain attention."""
    import os
    import shutil
    import statistics
    import torch
    from unigen_tpu_torch.models import qwen2
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.ops.flash_attention import flash_attention_plain
    from unigen_tpu_torch.training import train as TRAIN
    from unigen_tpu_torch.training.optimizer import global_norm, named_leaves
    steps = TRAIN_WARM + TRAIN_TIMED
    print(f"phase: train path ({TRAIN_CONFIG}: Qwen2.5-1.5B + MAGViTv2, random init, bf16 "
          f"params and AdamW state, remat, chunked CE, 8 t2i + 2 lm + 6 mmu rows, "
          f"{TRAIN_WARM} warm + {TRAIN_TIMED} timed steps)")
    check(not os.path.exists("output/unigen_pt1"), "output/unigen_pt1 exists: the train phase "
          "measures the random init")
    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    config = train_config(f"training.max_train_steps={steps}")
    resident = torch.cuda.memory_allocated()        # what earlier phases keep
    t0 = time.perf_counter()
    trainer = TRAIN.build_trainer(config)
    torch.cuda.synchronize()
    print(f"  build_trainer {time.perf_counter() - t0:.2f} s")
    check(not os.path.exists("output/unigen_pt1"), "the train phase created output/unigen_pt1")
    tcfg, cfg = trainer.tcfg, trainer.cfg
    rows = tcfg.batch_size_t2i + tcfg.batch_size_lm + tcfg.batch_size_mmu
    seq = trainer.prompting.max_seq_len
    print(f"  rows of {seq} tokens (max_seq_length {config.dataset.preprocessing.max_seq_length} "
          f"+ {cfg.num_vq_tokens} image tokens + 3), {rows * seq} a step")
    layers = cfg.llm.num_hidden_layers
    per_step = dict(NO_LAUNCHES, flash_attention=2 * layers, flash_attention_backward=layers,
                    conv3x3_gn_swish=80, gn_affine=80)
    watched = {p: t.detach().clone() for p, t in named_leaves(trainer.state.params)
               if p.startswith("llm/layers/0/") or p in ("llm/final_ln", "llm/embed")}
    records, last = [], {}
    real_step = trainer.step_fn

    def timed_step(state, vq_params, batch, key):
        last["batch"] = batch
        torch.cuda.synchronize()
        before = _read_counts()
        t0 = time.perf_counter()
        out = real_step(state, vq_params, batch, key)
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _read_counts()
        records.append(dict(seconds=dt, enqueue_s=enqueued, metrics=out[1],
                            counts={k: after[k] - before[k] for k in after}))
        return out
    trainer.step_fn = timed_step
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(TRAIN.synthetic_flows(config))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    trainer.step_fn = real_step
    peak = torch.cuda.max_memory_allocated() - resident
    check(len(records) == steps, f"{len(records)} train steps, not {steps}")
    check(counts == {k: steps * v for k, v in per_step.items()},
          f"train launch counts {counts} != {steps} x {per_step}")
    for i, r in enumerate(records):
        m = {k: float(v) for k, v in r["metrics"].items()}
        print(f"  step {i + 1}: {r['seconds']:.4f} s ({r['enqueue_s']:.4f} s to enqueue), "
              f"loss {m['loss']:.6f} (t2i {m['loss_t2i']:.6f}, lm {m['loss_lm']:.6f}, mmu "
              f"{m['loss_mmu']:.6f}), grad norm {m['grad_norm']:.6f}, masking rate "
              f"{m['avg_masking_rate']:.4f}, launches {r['counts']}")
        check(r["counts"] == per_step, f"step {i + 1} launches {r['counts']} != {per_step}")
        check(all(math.isfinite(v) for v in m.values()) and m["grad_norm"] > 0,
              f"step {i + 1} metrics {m}")
    now = dict(named_leaves(trainer.state.params))
    moved = {p: int((t != now[p]).sum()) for p, t in watched.items()}
    print(f"  elements moved after {steps} steps (of layer 0, the embedding and the final "
          f"norm): {moved}")
    check(any(moved.values()), "no parameter moved")
    timed = [r["seconds"] for r in records[TRAIN_WARM:]]
    med = statistics.median(timed)
    bits = train_bits(config)
    model_flops, hw_flops = _train_step_flops(trainer, bits)
    tokens = rows * seq
    print(f"  timed steps: median {med:.4f} s (min {min(timed):.4f}, max {max(timed):.4f}); "
          f"{rows / med:.4f} samples/s, {tokens / med:.1f} tokens/s; host enqueue median "
          f"{statistics.median(r['enqueue_s'] for r in records[TRAIN_WARM:]):.4f} s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB over the {resident / 2 ** 30:.2f} GiB that earlier "
          f"phases hold; train() wall {wall:.3f} s")
    print(f"  model FLOPs a step {model_flops / 1e12:.2f} T ({model_flops / med / 989e12:.4f} of "
          f"989 TFLOP/s, a diagnostic); with the recompute {hw_flops / 1e12:.2f} T "
          f"({hw_flops / med / 989e12:.4f})")
    results["train"] = dict(step_s=med, step_min_s=min(timed), step_max_s=max(timed),
                            samples_per_s=rows / med, tokens_per_s=tokens / med,
                            enqueue_s=statistics.median(r["enqueue_s"]
                                                        for r in records[TRAIN_WARM:]),
                            peak_gib=peak / 2 ** 30, model_tflops=model_flops / 1e12)
    hook_counts = check_visualize_hook(trainer, last["batch"], results)
    counts = {k: counts[k] + hook_counts[k] for k in counts}

    # one step's losses and grad norm through kernel 2 against the plain attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    batch = trainer.build_device_batch(next(TRAIN.synthetic_flows(config)))
    draws = MK.draw_masking(gen, tcfg.batch_size_t2i, cfg.num_vq_tokens,
                            codebook_size=cfg.codebook_size, device="cuda")

    def losses():
        grads, m = trainer.step_fn.loss_and_grads(trainer.state.params, trainer.vq_params,
                                                  batch, draws)
        m["grad_norm"] = global_norm(grads)
        return {k: float(v) for k, v in m.items()}
    got = losses()
    real = qwen2.flash_attention
    try:
        qwen2.flash_attention = lambda q, k, v, bits, scale=None: flash_attention_plain(
            q, k, v, bits, scale)
        want = losses()
    finally:
        qwen2.flash_attention = real
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in got}
    print(f"  one step through kernel 2 vs the plain attention (same batch and draws, bf16): "
          f"kernel {got}, plain {want}, relative differences {rel} (losses need <= 1e-2, the "
          "grad norm <= 5e-2)")
    check(all(rel[k] <= 1e-2 for k in ("loss_t2i", "loss_lm", "loss_mmu")) and
          rel["grad_norm"] <= 5e-2, f"the kernel step and the plain step differ: {rel}")
    if profile:
        _train_profile(lambda: trainer.step_fn(trainer.state, trainer.vq_params, batch, gen),
                       trainer.tx, med)
    del trainer
    torch.cuda.empty_cache()
    return {k: v for k, v in counts.items()}


def image_grid(images, cols=None):
    """uint8 [B, H, W, 3] on one canvas, as ``visualization.save_image_grid``
    lays it out (rows of ``min(B, 4)``)."""
    import numpy as np
    b, h, w, _ = images.shape
    cols = cols or min(b, 4)
    canvas = np.zeros((-(-b // cols) * h, cols * w, 3), np.uint8)
    for i in range(b):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i]
    return canvas


def check_visualize_hook(trainer, batch, results):
    """The Trainer's visualize hook (``Trainer._visualize``, what
    ``visualize_every`` runs) once on the last step's batch at PT2's width:
    8 t2i rows of 256 px, the frozen fp32 MAGViTv2, the bf16 backbone.
    Timed alone (its PNG write included); its launches exact (kernel 3: two
    encodes and two decodes, kernel 2: one forward); the grid PNG read back
    by ``decode_image`` equals the triptychs; and ``masked_token_diagnostics``
    over the same forward's image logits is finite, its token counts the
    masked tokens. Returns the hook's launch counts."""
    import os
    import numpy as np
    import torch
    from unigen_tpu_torch.data.decode import read_image
    from unigen_tpu_torch.models import magvit, unigen
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops import sampling as S
    from unigen_tpu_torch.training import visualization as VZ
    from unigen_tpu_torch.training.diagnostics import masked_token_diagnostics
    cfg, tcfg = trainer.cfg, trainer.tcfg
    n, b = cfg.num_vq_tokens, tcfg.batch_size_t2i
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    draws = MK.draw_masking(gen, b, n, codebook_size=cfg.codebook_size, device="cuda")
    enc = sum(k for *_, k in ENCODER_CONVS)
    want = dict(NO_LAUNCHES, flash_attention=cfg.llm.num_hidden_layers,
                conv3x3_gn_swish=2 * enc + 2 * sum(k for *_, k in DECODER_CONVS),
                gn_affine=2 * enc + 2 * sum(k for *_, gn, k in DECODER_CONVS if gn))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    trip = trainer._visualize(batch, draws)
    torch.cuda.synchronize()
    hook_s = time.perf_counter() - t0
    counts = _read_counts()
    path = os.path.join(trainer.tr.output_dir, "visualizations",
                        f"predictions_step{trainer.global_step}.png")
    png = read_image(path)
    with torch.no_grad():
        ids = VZ.masked_t2i_inputs(trainer.vq_params, trainer.vq_cfg, cfg, batch["t2i_template"],
                                   batch["t2i_pixels"], draws, mask_schedule=tcfg.mask_schedule,
                                   min_masking_rate=tcfg.min_masking_rate)
        codes = magvit.get_code(trainer.vq_params, trainer.vq_cfg, batch["t2i_pixels"])
        masked = MK.mask_or_random_replace_tokens(
            draws, codes, cfg.codebook_size, S.get_mask_schedule(tcfg.mask_schedule),
            min_masking_rate=tcfg.min_masking_rate, codebook_size=cfg.codebook_size)
        bits = M.pack_meta(M.t2i_attn_meta(ids, tcfg.pad_id, tcfg.soi_id, tcfg.eoi_id))
        logits = unigen.forward(trainer.state.params, cfg, input_ids=ids, meta_bits=bits,
                                batch_size_t2i=b)[:, -(n + 1):-1]
        if not cfg.use_gen_projector:
            logits = logits[..., cfg.text_vocab_len:cfg.text_vocab_len + cfg.codebook_size]
        diag = masked_token_diagnostics(logits, masked.labels, masked.mask_prob)
        del logits
    diag = {k: v.cpu().numpy() for k, v in diag.items()}
    n_masked = int((masked.labels != -100).sum())
    in_block = int((ids[:, -(n + 1):-1] == cfg.mask_token_id).sum())
    print(f"  visualize hook (Trainer._visualize, {b} t2i rows, {trip.shape[1]} px): "
          f"{hook_s:.4f} s alone, launches {counts}; grid {list(png.shape)} read back; "
          f"{n_masked} masked tokens; masked-token diagnostics: tokens "
          f"{diag['bucket_tokens'].astype(int).tolist()}, entropy "
          f"{np.round(diag['bucket_entropy'], 4).tolist()}, CE {np.round(diag['bucket_ce'], 4).tolist()}")
    check(counts == want, f"visualize hook launches {counts} != {want}")
    check(trip.shape == (b, trip.shape[1], 3 * trip.shape[1], 3) and
          np.array_equal(png, image_grid(trip)), "the visualize hook's PNG differs from its triptychs")
    check(all(np.isfinite(v).all() for v in diag.values()) and
          int(diag["bucket_tokens"].sum()) == n_masked == in_block > 0,
          f"masked-token diagnostics: {diag}, {n_masked} masked, {in_block} mask ids")
    results["visualize"] = dict(hook_s=hook_s, masked_tokens=n_masked,
                                bucket_tokens=diag["bucket_tokens"].tolist())
    return counts


def run_tiny_train():
    """The tiny fp32 train step on the card against the CPU, the same
    weights, batch and masking draws (made on the host): the losses and the
    grad norm within 1e-4 relative, the gradients within 1e-4 of the
    largest gradient, and the card's AdamW update of the CPU's gradients
    within 1e-5 of each leaf's largest magnitude after the CPU's update. (The
    card's own step is not held leaf by leaf: Adam's first step maps every
    gradient element to about +-lr whatever its size, so rounding-level
    differences of near-zero gradients, the k bias's is zero in exact
    arithmetic, become lr-sized; its largest leaf difference is printed.)
    Then 6 steps at lr 1e-3 on the card lower the loss."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.training import lr_schedules as LRS
    from unigen_tpu_torch.training import train_step as TS
    from unigen_tpu_torch.training.optimizer import global_norm, make_optimizer, named_leaves
    print("phase: tiny fp32 train step, kernels on the card vs plain versions on the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3)
    sp = cpu.prompting.sptids_dict
    n, seq, bt, bl, bm = cpu.cfg.num_vq_tokens, 28, 2, 2, 2
    rng = np.random.default_rng(0)
    t2i = rng.integers(3, 100, size=(bt, seq))
    t2i[:, -n - 2], t2i[:, -1], t2i[:, -n - 1:-1] = sp["<|soi|>"], sp["<|eoi|>"], 0
    t2i[0, :3] = cpu.prompting.pad_id
    mmu = rng.integers(3, 100, size=(bm, seq))
    mmu[:, 2], mmu[:, 3 + n], mmu[:, 3:3 + n] = sp["<|soi|>"], sp["<|eoi|>"], 0
    mmu_labels = np.where(rng.random((bm, seq)) < 0.5, rng.integers(3, 100, (bm, seq)), -100)
    mmu_labels[:, :4 + n] = -100
    lm = rng.integers(3, 100, size=(bl, seq))
    res = cpu.vq_cfg.resolution
    host = {"t2i_template": t2i, "t2i_labels": np.full((bt, seq), -100),
            "t2i_pixels": rng.normal(size=(bt, res, res, 3)).astype(np.float32),
            "lm_ids": lm, "lm_labels": lm.copy(), "mmu_template": mmu, "mmu_labels": mmu_labels,
            "mmu_pixels": rng.normal(size=(bm, res, res, 3)).astype(np.float32)}
    draws = MK.draw_masking(torch.Generator().manual_seed(0), bt, n,
                            codebook_size=cpu.cfg.codebook_size)
    tcfg = TS.TrainStepConfig(bt, bl, bm, max_grad_norm=1.0, pad_id=cpu.prompting.pad_id,
                              soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])

    def side(device):
        pipe = cpu if device == "cpu" else cpu.to(device)
        tx = make_optimizer(pipe.params, 1e-3, LRS.get_scheduler("constant"), max_grad_norm=1.0)
        step = TS.make_train_step(pipe.cfg, pipe.vq_cfg, tx, tcfg)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        dr = MK.MaskDraws(*(None if x is None else x.to(device) for x in draws))
        return pipe, tx, step, batch, dr, TS.init_train_state(pipe.params, tx)
    cpu_side, gpu_side = side("cpu"), side("cuda")
    (_, _, c_step, c_batch, c_draws, c_state) = cpu_side
    (g_pipe, g_tx, g_step, g_batch, g_draws, g_state) = gpu_side
    c_grads, c_m = c_step.loss_and_grads(c_state.params, cpu.vq_params, c_batch, c_draws)
    _reset_counts()
    g_grads, g_m = g_step.loss_and_grads(g_state.params, g_pipe.vq_params, g_batch, g_draws)
    torch.cuda.synchronize()
    counts = _read_counts()
    c_m["grad_norm"], g_m["grad_norm"] = global_norm(c_grads), global_norm(g_grads)
    rel = {k: abs(float(g_m[k]) - float(c_m[k])) / max(abs(float(c_m[k])), 1e-30) for k in c_m}
    gmax = max(g.abs().max().item() for g in c_grads)
    gerr = max((a.cpu() - b).abs().max().item() for a, b in zip(g_grads, c_grads))
    # the card's optimizer on the CPU's gradients against the CPU's update
    g_leaves = [t for _, t in named_leaves(g_state.params)]
    c_leaves = [t for _, t in named_leaves(c_state.params)]
    c_tx = cpu_side[1]
    c_tx.update(c_grads, c_state.opt_state, c_leaves)
    g_tx.update([g.to("cuda") for g in c_grads], g_state.opt_state, g_leaves)
    upd = max((a.detach().cpu() - b.detach()).abs().max().item()
              / max(b.detach().abs().max().item(), 1e-30) for a, b in zip(g_leaves, c_leaves))
    print(f"  launches {counts}; relative differences {rel} (need <= 1e-4); gradients max "
          f"difference {gerr:.3e} of a largest gradient {gmax:.3e} (need <= 1e-4 of it); the "
          f"card's AdamW on the CPU's gradients: {upd:.3e} of each leaf's largest magnitude "
          "(need <= 1e-5)")
    check(counts["flash_attention"] == 2 and counts["flash_attention_backward"] == 2
          and counts["conv3x3_gn_swish"] > 0 and counts["gn_affine"] > 0,
          f"tiny train step launches {counts}")
    check(all(v <= 1e-4 for v in rel.values()), f"tiny train step card vs CPU: {rel}")
    check(gerr <= 1e-4 * gmax, f"tiny train gradients differ: {gerr} of {gmax}")
    check(upd <= 1e-5, f"tiny AdamW update on the card differs: {upd}")
    own = TS.init_train_state(g_pipe.params, g_tx)
    c_own = TS.init_train_state(cpu.params, c_tx)
    own, _ = g_step(own, g_pipe.vq_params, g_batch, g_draws)
    c_own, _ = c_step(c_own, cpu.vq_params, c_batch, c_draws)
    diff = max((a.detach().cpu() - b.detach()).abs().max().item() / max(b.abs().max().item(),
                                                                          1e-30)
               for (_, a), (_, b) in zip(named_leaves(own.params), named_leaves(c_own.params)))
    print(f"  the card's own step against the CPU's (not gated): largest leaf difference "
          f"{diff:.3e} of the leaf's largest magnitude")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TS.init_train_state(g_pipe.params, g_tx)
    losses = []
    for _ in range(6):
        state, m = g_step(state, g_pipe.vq_params, g_batch, gen)
        losses.append(float(m["loss"]))
    print(f"  6 steps on the card at lr 1e-3: losses {[round(x, 5) for x in losses]}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"tiny training on the card did not lower the loss: {losses}")


# ---------------------------------------------------------------------------
# post-training: SFT, packed SFT, DPO, CoT-V post-SFT
# ---------------------------------------------------------------------------

def stage_config(path, *extra):
    """A post-training stage's config with the phases' overrides (no edit of
    the file): synthetic flows, no checkpoint, its own output directory."""
    from unigen_tpu_torch.utils.configuration import initialize_config
    return initialize_config(path, ["dataset.synthetic=true", "experiment.save_every=0",
                                    f"experiment.output_dir={POST_OUT}", *extra])


def sft_forward_bits(step, batch):
    """[(bits, head positions)] of each backbone call of one SFT step in its
    mode, from the batch's templates (the image blocks' codes never equal a
    pad, soi or eoi id, so the templates give the step's bits): separate, the
    t2i + lm call and the mmu call; packed, one call over the packed rows."""
    from unigen_tpu_torch.ops import masks as M
    tc, n = step.tcfg, step.cfg.num_vq_tokens
    bt, bl, bm = tc.batch_size_t2i, tc.batch_size_lm, tc.batch_size_mmu
    p_tokens = batch["mmu_spatial_shapes"] if step.naflex else \
        (step.vision_cfg.image_size // step.vision_cfg.patch_size) ** 2
    lm_len = batch["mmu_labels"].shape[1]
    mmu = M.mmu_vit_attn_meta(bm, lm_len, num_tokens=p_tokens,
                              prefix_length=batch["mmu_part1"].shape[1],
                              prompt_len=batch["mmu_prompt_len"]) if bm else None

    def t2i_meta(ids):
        return M.t2i_attn_meta(ids, tc.pad_id, tc.soi_id, tc.eoi_id)

    def lm_meta(ids):
        return M.lm_attn_meta(ids, tc.pad_id)
    if step.mode == "packed":
        metas, head, rows = [], 0, 0
        for rows_, key, fn in ((bt, "t2i", t2i_meta), (bl, "lm", lm_meta)):
            if rows_:
                ids = batch["t2i_template" if key == "t2i" else "lm_ids"]
                labels = batch["t2i_labels" if key == "t2i" else "lm_labels"]
                ids_p, _, meta_p, _ = step._pack(ids, labels, fn)
                metas.append(meta_p)
                head += ids_p.shape[0] * (lm_len if key == "t2i" else lm_len - 1)
        return [(M.pack_meta(M.concat_meta(*metas, mmu)), head + bm * (lm_len - 1))]
    calls = []
    if bt or bl:
        tl = [fn(batch[k]) for rows_, k, fn in ((bt, "t2i_template", t2i_meta),
                                                (bl, "lm_ids", lm_meta)) if rows_]
        length = (batch["t2i_template"] if bt else batch["lm_ids"]).shape[1]
        calls.append((M.pack_meta(M.concat_meta(*tl)), bt * n + bl * (length - 1)))
    if bm:
        calls.append((M.pack_meta(mmu), bm * (lm_len - 1)))
    return calls


def _sft_step_for(config):
    """The SFT entry's host batch and step for ``config``'s first synthetic
    batch, without weights (the configs only): for the kernel phases' bits."""
    import dataclasses as dc
    import torch
    from unigen_tpu_torch.launch import (build_prompting_from_config, build_unigen_config,
                                         load_tokenizer, vision_tower_config)
    from unigen_tpu_torch.models.magvit import MagvitConfig
    from unigen_tpu_torch.training import sft as SFT
    from unigen_tpu_torch.training.train_sft import host_batch, synthetic_batches
    pr = build_prompting_from_config(config, load_tokenizer(config))
    vs = vision_tower_config(config)
    tr = config.training
    host = host_batch(pr, config.model.unigen.num_vq_tokens, vs, 0,
                      next(synthetic_batches(config, pr, vs)))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    common = batch["mmu_labels"].shape[1]
    common = common if common >= max(batch["t2i_template"].shape[1],
                                     batch["lm_ids"].shape[1]) else None
    tcfg = SFT.SFTStepConfig(tr.batch_size_t2i, tr.batch_size_lm, tr.batch_size_mmu,
                             pad_id=pr.pad_id, soi_id=pr.sptids_dict["<|soi|>"],
                             eoi_id=pr.sptids_dict["<|eoi|>"], common_length=common)
    step = SFT.SFTStep(build_unigen_config(config, pr), MagvitConfig(), vs, None, tcfg)
    return step, batch


def post_training_bits():
    """The kernel-2 bits of the post-training steps, from the entries' own
    host assembly of their first synthetic batch: the SFT step's t2i + lm
    call [4, 1603] and its mmu call [4, 796] (mmu_vit bits; two rows here
    with a shorter prompt_len than the path's 796, for their pads), the
    packed SFT step's [7, 796] (``max_seq_length=128``: 2 t2i segments a
    row, segment ids in bits 3 and up; the lm row; the 4 mmu rows) and the
    DPO step's [20, 387] (the 10 pairs' t2i bits)."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_prompting_from_config, load_tokenizer
    from unigen_tpu_torch.ops import masks as M
    step, batch = _sft_step_for(stage_config(SFT_CONFIG))
    (tl, _), (mmu, _) = sft_forward_bits(step, batch)
    plen = batch["mmu_prompt_len"].clone()
    plen[-2:] -= torch.tensor([36, 55], device="cuda")
    short = M.pack_meta(M.mmu_vit_attn_meta(plen.shape[0], mmu.shape[1],
                                            num_tokens=step.vision_cfg.num_patches,
                                            prefix_length=3, prompt_len=plen))
    packed_step, packed_batch = _sft_step_for(stage_config(SFT_CONFIG, *PACKED_OVERRIDES))
    check(packed_step.mode == "packed", f"packed SFT runs {packed_step.mode}")
    ((packed, _),) = sft_forward_bits(packed_step, packed_batch)
    config = stage_config(DPO_CONFIG)
    pr = build_prompting_from_config(config, load_tokenizer(config))
    b = config.training.batch_size_t2i
    zeros = np.zeros((b, config.model.unigen.num_vq_tokens), np.int64)
    ids, _, _ = pr((["a red cat"] * b, zeros, zeros), "t2i")
    ids = torch.as_tensor(np.concatenate([ids, ids]), device="cuda")
    dpo = M.pack_meta(M.t2i_attn_meta(ids, pr.pad_id, pr.sptids_dict["<|soi|>"],
                                      pr.sptids_dict["<|eoi|>"]))
    return {"SFT step t2i/lm bits": tl, "SFT step mmu_vit bits, prompt_len "
            f"{plen.tolist()}": short, "packed SFT step, segment bits": packed,
            "DPO step t2i bits": dpo}


def _stage_flops(params, cfg, calls):
    """Forward FLOPs of ``calls`` ([(bits, head positions)] backbone calls):
    2 N a token (N the non-embedding parameters), 2 D V a head position and
    4 h dh a visible (query, key) pair in each layer."""
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.training.optimizer import named_leaves
    body = sum(t.numel() for p, t in named_leaves(params) if p.startswith("llm/layers/"))
    c = cfg.llm
    total = 0.0
    for bits, head in calls:
        vis = M.unpack_meta(bits).visibility().sum().item()
        total += (2.0 * body * bits.numel() + 2.0 * head * c.hidden_size * cfg.vocab_size
                  + 4.0 * c.num_attention_heads * c.head_dim * vis * c.num_hidden_layers)
    return total


def _timed_steps(run, attr="step", fp_keys=()):
    """``run.<attr>`` (the step) wrapped: each call synchronised before and
    after, its wall, enqueue time, metrics, launch counts and end time
    recorded, and with ``fp_keys`` the fingerprint of those tensors of the
    batch it consumed (``train_dpo.batch_fingerprint``, taken after the
    timing)."""
    import torch
    from unigen_tpu_torch.training.train_dpo import batch_fingerprint
    records, real = [], getattr(run, attr)

    def timed(*args):
        torch.cuda.synchronize()
        before = _read_counts()
        t0 = time.perf_counter()
        out = real(*args)
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        after = _read_counts()
        rec = dict(seconds=t_end - t0, enqueue_s=enqueued, metrics=out[1], t_end=t_end,
                   counts={k: after[k] - before[k] for k in after})
        if fp_keys:
            batch = next(a for a in args if isinstance(a, dict) and fp_keys[0] in a)
            rec["fp"] = batch_fingerprint(batch, fp_keys)
        records.append(rec)
        return out
    setattr(run, attr, timed)
    return records, real


def _loop_walls(records, warm):
    """Seconds from the end of one step to the end of the next over the
    timed steps: the loader's next batch, the host assembly and the step."""
    return [records[i]["t_end"] - records[i - 1]["t_end"]
            for i in range(max(warm, 1), len(records))]


def _snapshot(tree, keep=lambda p: True):
    from unigen_tpu_torch.training.optimizer import named_leaves
    return {p: t.detach().clone() for p, t in named_leaves(tree) if keep(p)}


def _moved(before, tree):
    from unigen_tpu_torch.training.optimizer import named_leaves
    now = dict(named_leaves(tree))
    return {p: int((now[p].detach() != t).sum()) for p, t in before.items()}


def run_stage(results, name, run, warm, timed, per_step, tokens, flops, resident,
              projector=True, profile_step=None, fp_keys=(), records_out=None):
    """Drives ``run.train`` (the entry's loop) for warm + timed steps, each
    synchronised and timed, with the launch counts set to 0 just before and
    read just after. Gates: launches exact a step, finite losses and grad
    norms, the frozen tower and VQ unchanged bit for bit, with ``projector``
    the projector moved (its zero-initialised biases: in bf16 a warm-up's
    first updates are below half an ulp of its weights). Prints s a step,
    samples/s, tokens/s, enqueue, peak memory, model FLOPs a step. With
    ``fp_keys`` each step's fingerprint of those batch tensors is recorded
    and the records appended to ``records_out``; the loop's wall a step (the
    loader's next batch included) is printed, and the profile's idle share
    is taken against it."""
    import statistics
    import torch
    steps = warm + timed
    frozen = {"vq": _snapshot(run.vq_params)}
    if getattr(run, "vs_params", None) is not None:
        frozen["tower"] = _snapshot(run.vs_params)
    proj = _snapshot(run.state.params, lambda p: p.startswith("mm_projector"))
    records, real = _timed_steps(run, fp_keys=fp_keys)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    run.step = real
    peak = torch.cuda.max_memory_allocated() - resident
    check(len(records) == steps, f"{name}: {len(records)} steps, not {steps}")
    check(counts == {k: steps * v for k, v in per_step.items()},
          f"{name} launch counts {counts} != {steps} x {per_step}")
    for i, r in enumerate(records):
        m = {k: float(v) for k, v in r["metrics"].items()}
        print(f"  step {i + 1}: {r['seconds']:.4f} s ({r['enqueue_s']:.4f} s to enqueue), "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        check(r["counts"] == per_step, f"{name} step {i + 1} launches {r['counts']} != {per_step}")
        check(all(math.isfinite(v) for v in m.values()) and m["grad_norm"] > 0,
              f"{name} step {i + 1} metrics {m}")
    for part, before in frozen.items():
        changed = {p: n for p, n in _moved(before, getattr(
            run, "vq_params" if part == "vq" else "vs_params")).items() if n}
        check(not changed, f"{name}: the frozen {part} changed: {changed}")
    moved = _moved(proj, run.state.params)
    print(f"  the frozen tower and VQ unchanged bit for bit; mm_projector elements moved: {moved}")
    check(not projector or any(moved.values()), f"{name}: the projector did not move: {moved}")
    times = [r["seconds"] for r in records[warm:]]
    med = statistics.median(times)
    rows = sum(run.config.training.get(k, 0) for k in ("batch_size_t2i", "batch_size_lm",
                                                       "batch_size_mmu"))
    enq = statistics.median(r["enqueue_s"] for r in records[warm:])
    print(f"  timed steps: median {med:.4f} s (min {min(times):.4f}, max {max(times):.4f}); "
          f"{rows / med:.4f} samples/s, {tokens / med:.1f} tokens/s ({tokens} backbone tokens a "
          f"step); host enqueue median {enq:.4f} s; peak memory {peak / 2 ** 30:.2f} GiB over the "
          f"{resident / 2 ** 30:.2f} GiB that earlier phases hold; train() wall {wall:.3f} s")
    print(f"  model FLOPs a step {flops / 1e12:.2f} T ({flops / med / 989e12:.4f} of 989 TFLOP/s, "
          f"a diagnostic); per step launches {per_step}")
    results[name] = dict(step_s=med, step_min_s=min(times), step_max_s=max(times),
                         samples_per_s=rows / med, tokens_per_s=tokens / med, enqueue_s=enq,
                         peak_gib=peak / 2 ** 30, model_tflops=flops / 1e12)
    loop = _loop_walls(records, warm)
    if fp_keys:
        results[name]["loop_s"] = statistics.median(loop)
        print(f"  the loop a step (the loader's next batch, the host assembly, the step): "
              f"{', '.join(f'{x:.4f}' for x in loop)} s; median {statistics.median(loop):.4f}")
    if records_out is not None:
        records_out.extend(records)
    if profile_step is not None:
        _train_profile(profile_step, run.tx,
                       results[name]["loop_s"] if fp_keys else med)
    return counts


def _sft_run(*extra, config_path=None):
    """The SFT entry's run (``train_sft.SFTRun``) of a stage config, its step
    resolved from the first synthetic batch as the entry does."""
    import torch
    from unigen_tpu_torch.training.train_sft import SFTRun
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run = SFTRun(stage_config(config_path or SFT_CONFIG, *extra))
    batch = run.device_batch(next(run.batches()))
    run.resolve_step(batch)
    torch.cuda.synchronize()
    print(f"  SFTRun {time.perf_counter() - t0:.2f} s; mode {run.step.mode}, common_length "
          f"{run.common_length}, rows {[tuple(batch[k].shape) for k in ('t2i_template', 'lm_ids', 'mmu_labels')]}")
    return run, batch, resident


def _sft_per_step(run):
    """Exact launches of one SFT step, from the code: kernel 2 in the SigLIP
    tower or kernel 1 in the NaFlex tower (one a layer, forward only), kernel
    2 in the backbone (one a layer a call, twice with remat: the recompute)
    and its backward kernel (one a layer a call); kernel 3 and its
    statistics 40 each a t2i encode (ENCODER_CONVS)."""
    tc, layers = run.tcfg, run.cfg.llm.num_hidden_layers
    calls = 1 if run.step.mode != "separate" else (
        (tc.batch_size_t2i > 0 or tc.batch_size_lm > 0) + (tc.batch_size_mmu > 0))
    recompute = calls * layers if tc.remat else 0
    tower = run.vs_cfg.num_layers_used if tc.batch_size_mmu else 0
    convs = sum(n for *_, n in ENCODER_CONVS) if tc.batch_size_t2i else 0
    naflex = run.step.naflex
    print(f"  launches a step from the code: kernel 2 {calls * layers} forward ({calls} backbone "
          f"call(s) x {layers} layers) + {recompute} remat recompute + {calls * layers} backward"
          + (f"; kernel 1 {tower} in the NaFlex tower" if naflex else f" + {tower} SigLIP")
          + f"; kernel 3 and its statistics {convs} each (the t2i encode)")
    return dict(NO_LAUNCHES, flash_attention=calls * layers + recompute + (0 if naflex else tower),
                flash_attention_backward=calls * layers, chunk_attention=tower if naflex else 0,
                conv3x3_gn_swish=convs, gn_affine=convs)


def _sft_stage(results, name, warm, timed, *extra, config_path=None, profile=False):
    run, batch, resident = _sft_run(f"training.max_train_steps={warm + timed}", *extra,
                                    config_path=config_path)
    calls = sft_forward_bits(run.step, batch)
    flops = 3 * _stage_flops(run.state.params, run.cfg, calls)
    tokens = sum(bits.numel() for bits, _ in calls)

    def one_step():
        run.state, _ = run.step(run.state, run.vq_params, run.vs_params, batch, run.generator)
    counts = run_stage(results, name, run, warm, timed, _sft_per_step(run), tokens, flops,
                       resident, profile_step=one_step if profile else None)
    return run, batch, counts


def run_sft(results, profile=False):
    """SFT at the flagship width through the SFT entry (``unigen_sft.yaml``:
    3 t2i + 1 lm rows of 1,603 tokens, 4 mmu rows of 3 + 729 + 64 = 796;
    ``common_length`` None: the separate mode, two backward passes a step)."""
    import torch
    print(f"phase: sft ({SFT_CONFIG}: Qwen2.5-1.5B + the frozen SigLIP-SO400M and MAGViTv2, "
          f"random init, bf16 params and AdamW state, remat; {STAGE_WARM} warm + {STAGE_TIMED} "
          "timed steps)")
    run, _, counts = _sft_stage(results, "sft", STAGE_WARM, STAGE_TIMED, profile=profile)
    check(run.step.mode == "separate", f"sft runs {run.step.mode}")
    del run
    torch.cuda.empty_cache()
    return counts


def run_sft_packed(results, profile=False):
    """SFT with ``max_seq_length=128``: t2i and lm rows of 387, packed 2 a
    row into the mmu length 796 (``loss_packed``: 7 rows). Gates beside
    ``run_stage``'s: one step's losses and grad norm against ``loss_fused``
    on the same batch and draws, in fp32 at rtol 2e-5 (JAX's
    test_sft_common_length_matches_separate) and printed in bf16; a LoRA
    step (rank 16 on all seven families), where only the adapters' a and b
    and the projector move."""
    import dataclasses as dc
    import torch
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.training import sft as SFT
    from unigen_tpu_torch.training.optimizer import global_norm
    from unigen_tpu_torch.weights import map_tree
    print(f"phase: sft_packed ({SFT_CONFIG} with {', '.join(PACKED_OVERRIDES)}; "
          f"{STAGE_WARM} warm + {STAGE_TIMED} timed steps)")
    run, batch, counts = _sft_stage(results, "sft_packed", STAGE_WARM, STAGE_TIMED,
                                    *PACKED_OVERRIDES, profile=profile)
    check(run.step.mode == "packed", f"sft_packed runs {run.step.mode}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    draws = MK.draw_masking(gen, run.tcfg.batch_size_t2i, run.cfg.num_vq_tokens,
                            codebook_size=run.cfg.codebook_size, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dc.replace(run.cfg, llm=dc.replace(run.cfg.llm, dtype=dtype))
        params = map_tree(run.state.params, lambda t: t.detach().to(dtype).requires_grad_(True))
        got = {}
        for pack in (True, False):
            step = SFT.SFTStep(cfg, run.vq_cfg, run.vs_cfg, run.tx,
                               dc.replace(run.step.tcfg, pack_rows=pack))
            grads, m = step.loss_and_grads(params, run.vq_params, run.vs_params, batch, draws)
            m["grad_norm"] = global_norm([g for g in grads if g is not None])
            got[step.mode] = {k: float(v) for k, v in m.items()}
            del grads
        rel = {k: abs(got["packed"][k] - got["fused"][k]) / max(abs(got["fused"][k]), 1e-30)
               for k in got["fused"]}
        print(f"  one step, {dtype}: packed {got['packed']}, fused {got['fused']}; relative "
              f"differences {rel}" + (" (need <= 2e-5)" if dtype == torch.float32 else
                                      " (not gated)"))
        if dtype == torch.float32:
            check(all(v <= 2e-5 for v in rel.values()), f"packed vs fused in fp32: {rel}")
        del params
        torch.cuda.empty_cache()
    full_peak = results["sft_packed"]["peak_gib"]
    del run
    torch.cuda.empty_cache()
    print("phase: sft_packed, a LoRA step (model.lora.rank=16, all seven families, "
          "1 warm + 2 timed steps)")
    lora, lbatch, resident = _sft_run(f"training.max_train_steps=3", "model.lora.rank=16",
                                      *PACKED_OVERRIDES)
    before = _snapshot(lora.state.params)
    calls = sft_forward_bits(lora.step, lbatch)
    lora_counts = run_stage(results, "sft_lora", lora, 1, 2, _sft_per_step(lora),
                            sum(b.numel() for b, _ in calls),
                            3 * _stage_flops(lora.state.params, lora.cfg, calls), resident)
    moved = {p: n for p, n in _moved(before, lora.state.params).items() if n}
    allowed = [p for p in moved if not (p.endswith(("_lora_a", "_lora_b"))
                                        or p.startswith("mm_projector"))]
    print(f"  LoRA: {len(moved)} leaves moved, {sum(p.endswith('_lora_b') for p in moved)} of "
          f"them lora_b, {sum(p.endswith('_lora_a') for p in moved)} lora_a; peak "
          f"{results['sft_lora']['peak_gib']:.2f} GiB against full SFT's {full_peak:.2f} GiB")
    check(not allowed and any(p.endswith("_lora_b") for p in moved),
          f"LoRA moved leaves it does not train: {allowed[:5]}")
    del lora
    torch.cuda.empty_cache()
    return {k: counts[k] + lora_counts[k] for k in counts}


def run_cotv_post_sft(results, profile=False):
    """CoT-V post-SFT (``unigen_cotv_post_sft.yaml``: 8 mmu rows of 796, no
    remat, ``common_length`` None) through the SFT entry."""
    import torch
    print(f"phase: cotv_post_sft ({COTV_CONFIG}; {COTV_WARM} warm + {COTV_TIMED} timed steps)")
    run, _, counts = _sft_stage(results, "cotv_post_sft", COTV_WARM, COTV_TIMED,
                                config_path=COTV_CONFIG, profile=profile)
    check(run.step.mode == "separate" and run.common_length is None,
          f"cotv_post_sft runs {run.step.mode}")
    del run
    torch.cuda.empty_cache()
    return counts


def run_tiny_sft_naflex():
    """The tiny fp32 SFT step with the NaFlex tower (separate mode: 2 t2i, 1
    lm, 3 mmu rows of 15-16 patches padded to 16) on the card against the
    CPU, the same weights, batch and masking draws: losses, the grad norm
    and the gradients within 1e-4 (relative; of the largest gradient)."""
    import numpy as np
    import torch
    from unigen_tpu_torch.data.transform import naflex_preprocess
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.models import siglip2
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.training import lr_schedules as LRS
    from unigen_tpu_torch.training import sft as SFT
    from unigen_tpu_torch.training.optimizer import global_norm, make_optimizer
    print("phase: tiny fp32 NaFlex SFT step, the card vs the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision="naflex")
    gpu = cpu.to("cuda")
    sp, n, vs = cpu.prompting.sptids_dict, cpu.cfg.num_vq_tokens, cpu.vision_cfg
    rng = np.random.default_rng(0)
    length, bt, bl, bm = 28, 2, 1, 3
    mmu_len = 3 + vs.num_patches + 20
    t2i = rng.integers(3, 100, size=(bt, length))
    t2i[:, -n - 2], t2i[:, -1], t2i[:, -n - 1:-1] = sp["<|soi|>"], sp["<|eoi|>"], 0
    mmu_labels = np.full((bm, mmu_len), -100)
    mmu_labels[:, -6:] = rng.integers(3, 100, size=(bm, 6))
    # 8 x 32, 12 x 20 and 20 x 12: 16, 15 and 15 patches
    patches = [naflex_preprocess(img, vs.patch_size, vs.num_patches)
               for img in _naflex_tiny_images(bm + 1, 8)[1:]]
    host = {"t2i_template": t2i, "t2i_labels": np.full((bt, length), -100),
            "t2i_pixels": rng.normal(size=(bt, 8, 8, 3)).astype(np.float32),
            "lm_ids": rng.integers(3, 100, size=(bl, length)),
            "lm_labels": rng.integers(3, 100, size=(bl, length)),
            "mmu_part1": rng.integers(3, 100, size=(bm, 3)),
            "mmu_part2": rng.integers(3, 100, size=(bm, 20)), "mmu_labels": mmu_labels,
            "mmu_prompt_len": np.array([mmu_len, mmu_len - 2, mmu_len - 5]),
            "mmu_pixel_values": np.stack([p["pixel_values"] for p in patches]),
            "mmu_pixel_attention_mask": np.stack([p["pixel_attention_mask"] for p in patches]),
            "mmu_spatial_shapes": np.stack([p["spatial_shapes"] for p in patches])}
    draws = MK.draw_masking(torch.Generator().manual_seed(0), bt, n,
                            codebook_size=cpu.cfg.codebook_size)
    sides = {}
    for device, pipe in (("cpu", cpu), ("cuda", gpu)):
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        batch["mmu_pos_embeds"] = siglip2.resize_positional_embeddings(
            pipe.vision_params["pos_embed"], host["mmu_spatial_shapes"], vs.num_patches)
        tx = make_optimizer(pipe.params, 1e-3, LRS.get_scheduler("constant"), max_grad_norm=1.0)
        step = SFT.SFTStep(pipe.cfg, pipe.vq_cfg, vs, tx, SFT.SFTStepConfig(
            bt, bl, bm, max_grad_norm=1.0, pad_id=pipe.prompting.pad_id, soi_id=sp["<|soi|>"],
            eoi_id=sp["<|eoi|>"]))
        _reset_counts()
        grads, m = step.loss_and_grads(
            SFT.init_sft_state(pipe.params, tx).params, pipe.vq_params, pipe.vision_params, batch,
            MK.MaskDraws(*(None if x is None else x.to(device) for x in draws)))
        m["grad_norm"] = global_norm([g for g in grads if g is not None])
        sides[device] = (grads, {k: float(v) for k, v in m.items()}, _read_counts())
    (c_g, c_m, _), (g_g, g_m, counts) = sides["cpu"], sides["cuda"]
    rel = {k: abs(g_m[k] - c_m[k]) / max(abs(c_m[k]), 1e-30) for k in c_m}
    gmax = max(g.abs().max().item() for g in c_g if g is not None)
    gerr = max((a.cpu() - b).abs().max().item() for a, b in zip(g_g, c_g) if b is not None)
    print(f"  launches {counts}; relative differences {rel} (need <= 1e-4); gradients "
          f"{gerr:.3e} of a largest {gmax:.3e} (need <= 1e-4 of it)")
    check(counts["chunk_attention"] == vs.num_layers_used and counts["flash_attention"] > 0
          and counts["conv3x3_gn_swish"] > 0, f"tiny NaFlex SFT launches {counts}")
    check(all(v <= 1e-4 for v in rel.values()), f"tiny NaFlex SFT card vs CPU: {rel}")
    check(gerr <= 1e-4 * gmax, f"tiny NaFlex SFT gradients differ: {gerr} of {gmax}")


def run_sft_naflex(results, profile=False):
    """SFT through the SFT entry with the SigLIP2-NaFlex tower
    (``unigen_sft.yaml`` with ``model.vision_tower.name`` the NaFlex one:
    3 t2i + 1 lm rows of 1,603 tokens, 4 mmu rows of 3 + 256 + 64 = 323 over
    images of 384 x 384, 256 x 512 and 640 x 256 (256, 253 and 250 patches,
    padded to 256), the separate mode); SFT_NAFLEX_WARM warm +
    SFT_NAFLEX_TIMED timed steps, the sft phase's prints and gates; then the
    tiny fp32 step on the card against the CPU."""
    print(f"phase: sft_naflex ({SFT_CONFIG} with the SigLIP2-NaFlex tower: Qwen2.5-1.5B + the "
          f"frozen tower and MAGViTv2, random init, bf16 params and AdamW state, remat; "
          f"{SFT_NAFLEX_WARM} warm + {SFT_NAFLEX_TIMED} timed steps)")
    run, batch, counts = _sft_stage(results, "sft_naflex", SFT_NAFLEX_WARM, SFT_NAFLEX_TIMED,
                                    *SFT_NAFLEX_OVERRIDES, profile=profile)
    check(run.step.naflex and run.step.mode == "separate",
          f"sft_naflex ran {run.step.mode} without the NaFlex branch")
    mask = batch["mmu_pixel_attention_mask"]
    print(f"  NaFlex rows: spatial shapes {batch['mmu_spatial_shapes'].tolist()}, valid patches "
          f"{mask.sum(1).tolist()} of {mask.shape[1]}")
    run_tiny_sft_naflex()
    del run
    return counts


def run_dpo(results, profile=False):
    """DPO through the DPO entry (``unigen_dpo.yaml``: 10 pairs, rows of
    387, the online reference, remat). First a gate on 2 batches: the
    ``precomputed_ref`` step (the references from ``make_ref_logps_fn``)
    against the online step, losses and updated parameters bit for bit
    (within 1e-6 where not, which is printed); then the timed run."""
    import dataclasses as dc
    import torch
    from unigen_tpu_torch.training import dpo as D
    from unigen_tpu_torch.training.optimizer import named_leaves
    from unigen_tpu_torch.training.sft import init_sft_state
    from unigen_tpu_torch.training.train_dpo import DPORun
    print(f"phase: dpo ({DPO_CONFIG}: 10 pairs of 387-token rows, the online reference, remat; "
          f"{STAGE_WARM} warm + {STAGE_TIMED} timed steps)")
    resident = torch.cuda.memory_allocated()
    run = DPORun(stage_config(DPO_CONFIG, f"training.max_train_steps={STAGE_WARM + STAGE_TIMED}"))
    two = list(itertools.islice(run.step_schedule(), 2))
    online, online_m = run.state, []
    for batch, draws in two:
        online, m = run.step(online, run.ref_params, run.vq_params, batch, draws)
        online_m.append(m)
    dcfg = dc.replace(run.dcfg, precomputed_ref=True)
    ref_fn = D.make_ref_logps_fn(run.cfg, run.vq_cfg, dcfg)
    refs = [ref_fn(run.ref_params, run.vq_params, b, d) for b, d in two]
    pre_step = D.make_dpo_step(run.cfg, run.vq_cfg, run.tx, dcfg)
    pre = init_sft_state(run.ref_params, run.tx)
    pre_m = []
    for (batch, draws), r in zip(two, refs):
        pre, m = pre_step(pre, None, run.vq_params, {**batch, **r}, draws)
        pre_m.append(m)
    diff = max(max(abs(float(a[k]) - float(b[k])) for k in a) for a, b in zip(pre_m, online_m))
    pdiff = max((x.detach().float() - y.detach().float()).abs().max().item()
                for (_, x), (_, y) in zip(named_leaves(pre.params), named_leaves(online.params)))
    equal = diff == 0 and pdiff == 0
    print(f"  precomputed reference vs online on 2 batches: metrics max difference {diff:.3e}, "
          f"parameters {pdiff:.3e} (bit-equal: {equal}; else need <= 1e-6)")
    check(diff <= 1e-6 and pdiff <= 1e-6, f"precomputed vs online DPO: {diff}, {pdiff}")
    del pre, online, refs
    run.state = init_sft_state(run.ref_params, run.tx)
    torch.cuda.empty_cache()
    b, n = run.config.training.batch_size_t2i, run.cfg.num_vq_tokens
    bits = two[0][0]["template"]
    from unigen_tpu_torch.ops import masks as M
    bits = M.pack_meta(M.t2i_attn_meta(torch.cat([bits, bits]), run.dcfg.pad_id,
                                       run.dcfg.soi_id, run.dcfg.eoi_id))
    fwd = _stage_flops(run.state.params, run.cfg, [(bits, 2 * b * n)])
    layers = run.cfg.llm.num_hidden_layers
    convs = 2 * sum(k for *_, k in ENCODER_CONVS)
    recompute = layers if run.dcfg.remat else 0
    print(f"  launches a step from the code: kernel 2 {layers} reference forward + {layers} policy "
          f"forward + {recompute} remat recompute + {layers} backward; kernel 3 and its "
          f"statistics {convs} each (the chosen and the rejected encode)")
    per_step = dict(NO_LAUNCHES, flash_attention=2 * layers + recompute,
                    flash_attention_backward=layers, conv3x3_gn_swish=convs, gn_affine=convs)
    profile_batch = two[0]

    def one_step():
        run.state, _ = run.step(run.state, run.ref_params, run.vq_params, *profile_batch)
    counts = run_stage(results, "dpo", run, STAGE_WARM, STAGE_TIMED, per_step, bits.numel(),
                       4 * fwd, resident, projector=False,
                       profile_step=one_step if profile else None)
    del run
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the real-data phases: the training entries on files read from disk
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jpeg_fixtures():
    """{file name: (bytes, its fixtures.json entry)} of the committed JPEG
    fixtures (the entry's sha256 is that of PIL's ``convert("RGB")`` pixels;
    null for the truncated file)."""
    import json
    from pathlib import Path
    import unigen_tpu_torch.data as data_pkg
    root = Path(data_pkg.__file__).parent / "assets" / "jpeg"
    index = json.loads((root / "fixtures.json").read_text())
    return {name: ((root / name).read_bytes(), meta) for name, meta in index.items()}


@functools.lru_cache(maxsize=None)
def image_fixtures():
    """{file name: (bytes, its fixtures.json entry)} of the committed WebP,
    GIF, BMP, PNM and TIFF fixtures (the sha256 is that of PIL's
    ``convert("RGB")`` pixels)."""
    import json
    from pathlib import Path
    import unigen_tpu_torch.data as data_pkg
    root = Path(data_pkg.__file__).parent / "assets" / "images"
    index = json.loads((root / "fixtures.json").read_text())
    return {name: ((root / name).read_bytes(), meta) for name, meta in index.items()}


@functools.lru_cache(maxsize=None)
def fixture_pixels(name):
    """A fixture's pixels by the port's decoder (held to PIL's hash by the
    jpeg phase and check_real_reading)."""
    from unigen_tpu_torch.data.decode import decode_image
    return decode_image(jpeg_fixtures()[name][0])


def real_file(fixtures, i, fmt="mixed", others=(), every=REAL_OTHER_EVERY):
    """(extension, bytes, what it holds) of the ``i``-th image of a set over
    ``fixtures``: that fixture's JPEG bytes, or (every REAL_PNG_EVERY-th with
    ``fmt`` "mixed", always with "png") a PNG of its pixels with the filter
    set of REAL_FILTERS the PNG's turn gives, or (with ``fmt`` "mixed", every
    ``every``-th from the third, always with "other") the next of
    ``others``, (image fixture, extension) pairs, in turn."""
    if others and (fmt == "other" or (fmt == "mixed" and i % every == 3)):
        name, ext = others[(i // every if fmt == "mixed" else i) % len(others)]
        return ext, image_fixtures()[name][0], ("image", name, None)
    name = fixtures[i % len(fixtures)]
    if fmt == "png" or (fmt == "mixed" and i % REAL_PNG_EVERY == REAL_PNG_EVERY - 1):
        filters = REAL_FILTERS[(i // REAL_PNG_EVERY) % len(REAL_FILTERS)]
        return ".png", png_bytes(fixture_pixels(name), filters), ("png", name, filters)
    return ".jpg", jpeg_fixtures()[name][0], ("jpeg", name, None)


def run_jpeg(results):
    """The port's JPEG decoder (``unigen_tpu_torch/csrc/jpeg.cpp``, built with
    the native library by g++) on the committed fixtures: each one's pixels
    have the sha256 of PIL's ``convert("RGB")`` pixels (PIL is not on the
    card's machine: the hashes were taken where the fixtures were written);
    the truncated one is a ``CorruptImage`` and a SOF9 header an
    ``UnsupportedImageFormat`` naming it. Each decode is timed on one host
    thread (``decode_image``, the median of JPEG_DECODES)."""
    import hashlib
    import statistics
    from unigen_tpu_torch.data import native
    from unigen_tpu_torch.data.decode import CorruptImage, UnsupportedImageFormat, decode_image
    start = time.perf_counter()
    path = native.build()
    native.load_library()
    print(f"phase: jpeg (the committed fixtures through decode_image; {path.name} ready in "
          f"{time.perf_counter() - start:.2f} s)")
    rows = {}
    for name, (data, meta) in sorted(jpeg_fixtures().items()):
        if meta["sha256"] is None:
            try:
                decode_image(data)
                raised = None
            except CorruptImage as e:
                raised = str(e)
            print(f"  {name}: {len(data)} bytes, CorruptImage: {raised}")
            check(raised is not None, f"{name}: no CorruptImage")
            continue
        arr = decode_image(data)
        sha = hashlib.sha256(arr.tobytes()).hexdigest()
        check(list(arr.shape) == meta["shape"] and sha == meta["sha256"],
              f"{name}: pixels {list(arr.shape)} sha256 {sha}, PIL's {meta['sha256']}")
        times = []
        for _ in range(JPEG_DECODES):
            t0 = time.perf_counter()
            decode_image(data)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        h, w = arr.shape[:2]
        rows[name] = dict(ms=ms, mp_per_s=h * w / 1e3 / ms, bytes=len(data), height=h, width=w)
        print(f"  {name} ({meta['use']}): {w}x{h}, {len(data)} bytes, sha256 = PIL's; decode "
              f"{ms:.4f} ms (median of {JPEG_DECODES}, one host thread), "
              f"{h * w / 1e3 / ms:.2f} MP/s")
    data = jpeg_fixtures()[REAL_T2I_FIXTURES[0]][0]
    sof = data.index(b"\xff\xc0")
    try:
        decode_image(data[:sof + 1] + b"\xc9" + data[sof + 2:])
        raised = None
    except UnsupportedImageFormat as e:
        raised = str(e)
    print(f"  the same file with a SOF9 header: UnsupportedImageFormat: {raised}")
    check(raised is not None and "arithmetic" in raised, "SOF9: no UnsupportedImageFormat")
    results["jpeg"] = rows
    print(f"  the jpeg phase: {time.perf_counter() - start:.2f} s")


def unsupported_images():
    """{what: bytes} of formats PIL reads and the port refuses (headers
    built here: the card's machine has no PIL to write them), each with the
    word its ``UnsupportedImageFormat`` names."""
    import struct

    def tiff(compression, photometric=2, bits=(8, 8, 8), sample_format=1, big=False):
        """An 8 x 8 one-strip TIFF header (the strip itself left out)."""
        e = ">" if big else "<"
        tags = {256: [8], 257: [8], 258: list(bits), 259: [compression], 262: [photometric],
                273: [8], 277: [len(bits)], 278: [8], 279: [1], 339: [sample_format] * len(bits)}
        at = 8 + 2 + 12 * len(tags) + 4
        body, extra = b"", b""
        for tag, values in sorted(tags.items()):
            packed = struct.pack(e + "H" * len(values), *values)
            body += struct.pack(e + "HHL", tag, 3, len(values))
            if len(packed) <= 4:
                body += packed.ljust(4, b"\x00")
            else:
                body += struct.pack(e + "L", at + len(extra))
                extra += packed
        head = (b"MM\x00*" if big else b"II*\x00") + struct.pack(e + "L", 8)
        return head + struct.pack(e + "H", len(tags)) + body + bytes(4) + extra
    return {
        ("JPEG 2000 image", "JPEG 2000"): b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40),
        ("JPEG 2000 codestream", "JPEG 2000"): b"\xffO\xffQ\x00/" + bytes(40),
        ("ICO", "ICO"): b"\x00\x00\x01\x00\x01\x00\x10\x10" + bytes(40),
        ("QOI", "QOI"): b"qoif\x00\x00\x00\x10\x00\x00\x00\x10\x03\x00" + bytes(8),
        ("AVIF", "AVIF"): b"\x00\x00\x00\x20ftypavif" + bytes(40),
        ("PSD", "PSD"): b"8BPS\x00\x01" + bytes(40),
        ("BigTIFF", "BigTIFF"): b"II+\x00\x08\x00\x00\x00" + bytes(24),
        ("TIFF, JPEG-compressed", "JPEG"): tiff(7),
        ("TIFF, CCITT Group 4", "Group 4"): tiff(4, 0, (1,)),
        ("TIFF, LZMA", "LZMA"): tiff(34925),
        ("TIFF, ZSTD", "ZSTD"): tiff(50000, big=True),
        ("TIFF, float samples", "float"): tiff(1, 1, (32,), 3),
        ("TIFF, YCbCr", "YCbCr"): tiff(1, 6),
        ("PFM", "PFM"): b"Pf\n2 2\n-1.0\n" + bytes(16),
    }


def run_images(results):
    """The port's WebP, GIF, BMP, PNM and TIFF decoders (``csrc/webp_lossy.cpp``,
    ``webp_lossless.cpp``, ``gif.cpp``, ``bmp.cpp``, ``tiff.cpp`` and
    ``data/webp.py``, ``pnm.py``, ``tiff.py``) on the committed fixtures:
    each one's pixels have the sha256 of PIL's ``convert("RGB")`` pixels
    (taken where the fixtures were written: the card's machine has no PIL),
    each decode timed on one host thread (``decode_image``, the median of
    IMAGE_DECODES), MP/s a fixture and a format (megapixels over the summed
    medians); then every format of ``unsupported_images`` raises
    ``UnsupportedImageFormat`` naming it."""
    import hashlib
    import statistics
    from unigen_tpu_torch.data import native
    from unigen_tpu_torch.data.decode import UnsupportedImageFormat, decode_image
    start = time.perf_counter()
    path = native.build()
    native.load_library()
    print(f"phase: images (the committed fixtures through decode_image; {path.name} ready in "
          f"{time.perf_counter() - start:.2f} s)")
    rows, by_format = {}, {}
    for name, (data, meta) in sorted(image_fixtures().items()):
        arr = decode_image(data)
        sha = hashlib.sha256(arr.tobytes()).hexdigest()
        check(list(arr.shape) == meta["shape"] and sha == meta["sha256"],
              f"{name}: pixels {list(arr.shape)} sha256 {sha}, PIL's {meta['sha256']}")
        times = []
        for _ in range(IMAGE_DECODES):
            t0 = time.perf_counter()
            decode_image(data)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        h, w = arr.shape[:2]
        rows[name] = dict(format=meta["format"], ms=ms, mp_per_s=h * w / 1e3 / ms,
                          bytes=len(data), height=h, width=w)
        fmt = by_format.setdefault(meta["format"], {"pixels": 0, "ms": 0.0, "files": 0})
        fmt["pixels"] += h * w
        fmt["ms"] += ms
        fmt["files"] += 1
        print(f"  {name} ({meta['use']}): {w}x{h}, {len(data)} bytes, sha256 = PIL's; decode "
              f"{ms:.4f} ms (median of {IMAGE_DECODES}, one host thread), "
              f"{h * w / 1e3 / ms:.2f} MP/s")
    for fmt, agg in sorted(by_format.items()):
        agg["mp_per_s"] = agg["pixels"] / 1e3 / agg["ms"]
        print(f"  {fmt}: {agg['files']} fixtures, {agg['pixels'] / 1e6:.4f} MP in "
              f"{agg['ms']:.4f} ms, {agg['mp_per_s']:.2f} MP/s on one host thread")
    refused = []
    for (what, word), data in unsupported_images().items():
        try:
            decode_image(data)
            raised = None
        except UnsupportedImageFormat as e:
            raised = str(e)
        check(raised is not None and word in raised,
              f"{what}: no UnsupportedImageFormat naming {word!r} ({raised})")
        refused.append(what)
    print(f"  UnsupportedImageFormat, naming each: {', '.join(refused)}")
    results["images"] = dict(fixtures=rows, formats=by_format)
    print(f"  the images phase: {time.perf_counter() - start:.2f} s")


def png_bytes(arr, filters):
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB), row y written with the
    filter ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth); ``zlib`` level 1. The card's machine has no PIL."""
    import struct
    import zlib
    import numpy as np
    h, w, _ = arr.shape
    rows = arr.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), rows[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), rows[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    ft = np.asarray([filters[y % len(filters)] for y in range(h)], np.uint8)
    out = np.zeros((h, w * 3 + 1), np.uint8)
    out[:, 0] = ft
    for f in set(filters):
        sel = ft == f
        out[sel, 1:] = ((rows[sel] - (preds[f][sel] if f else 0)) & 255).astype(np.uint8)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), 1)) + chunk(b"IEND", b""))


def _tar_add(tf, name, data):
    import io
    import tarfile
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_real_shards(root, prefix, n_shards, per_shard, keep=0, fmt="mixed"):
    """``n_shards`` tar shards of ``per_shard`` samples: the web t2i fixtures
    in turn (``real_file``: their JPEG bytes, one in REAL_PNG_EVERY a PNG of
    their pixels, one in REAL_OTHER_EVERY a WebP fixture of REAL_T2I_OTHERS;
    only JPEG, only PNG or only WebP with ``fmt`` "jpeg", "png" or "other");
    captions in ``.json`` (a short and a long one, or a long one with
    ``<person>`` and a prefix to strip) or ``.txt``; with ``fmt`` "mixed" one
    truncated JPEG a shard. Returns the shard paths and, for the first
    ``keep`` shards, what each key's image holds."""
    import json
    import os
    import tarfile
    paths, kept = [], {}
    truncated = jpeg_fixtures()[REAL_TRUNCATED][0]
    for s in range(n_shards):
        path = os.path.join(root, f"{prefix}-{s:04d}.tar")
        with tarfile.open(path, "w") as tf:
            for j in range(per_shard):
                key = f"{s:04d}{j:05d}"
                ext, data, holds = real_file(REAL_T2I_FIXTURES, j, fmt, REAL_T2I_OTHERS)
                if s < keep:
                    kept[key] = holds
                _tar_add(tf, key + ext, data)
                if j % 3 == 2:
                    _tar_add(tf, f"{key}.txt", f"a photo of object {key} on a table".encode())
                    continue
                meta = ({"prompt": f"The image shows a detailed scene number {key} with a red "
                                   "cup beside a window", "short_caption": f"a red cup {key}"}
                        if j % 3 == 0 else
                        {"caption": f"In this image, a <person> holds item {key}"})
                _tar_add(tf, f"{key}.json", json.dumps(meta).encode())
            if fmt == "mixed":
                _tar_add(tf, f"{s:04d}99999.jpg", truncated)
                _tar_add(tf, f"{s:04d}99999.txt", b"the caption of a truncated image")
        paths.append(path)
    return paths, kept


def format_shards(root, prefix):
    """One JPEG-only and one PNG-only shard of REAL_FORMAT_SAMPLES samples at
    the same sizes and pixels, and one of the WebP fixtures: the loaders'
    seconds a batch on each format."""
    shards = {fmt: write_real_shards(root, f"{prefix}-{fmt}", 1, REAL_FORMAT_SAMPLES,
                                     fmt=fmt)[0][0] for fmt in ("jpeg", "png", "other")}
    shards["webp"] = shards.pop("other")
    return shards


def format_loader_s(shards, batch, res):
    """The Text2ImageDataset's seconds a batch alone (python reader and
    native streamer) on the JPEG-only, the PNG-only and the WebP-only shard."""
    from unigen_tpu_torch.data.text2image import Text2ImageDataset
    return {f"t2i {reader} {fmt.upper()} ({batch} rows)": loader_s(
                lambda path=path, native=reader == "native": Text2ImageDataset(
                    [path], batch, res, use_native=native))
            for fmt, path in shards.items() for reader in ("python", "native")}


def check_other_formats(what, decodes, others):
    """``decodes`` [(fixture name, bytes)] of the image fixtures: each
    decodes to PIL's sha256, and every fixture of ``others`` is among them;
    prints the decodes by format."""
    import hashlib
    from unigen_tpu_torch.data.decode import decode_image
    by_format = {}
    for name, data in decodes:
        meta = image_fixtures()[name][1]
        arr = decode_image(data)
        check(hashlib.sha256(arr.tobytes()).hexdigest() == meta["sha256"],
              f"{what}: the decoder's pixels of {name} are not PIL's")
        by_format[meta["format"]] = by_format.get(meta["format"], 0) + 1
    seen = {name for name, _ in decodes}
    check(seen == {name for name, _ in others}, f"{what}: fixtures {sorted(seen)} read")
    print(f"  {what}: " + ", ".join(f"{n} {fmt}" for fmt, n in sorted(by_format.items()))
          + f" decodes with PIL's pixels (sha256 of {sorted(seen)})")
    return by_format


def check_real_reading(shards, kept):
    """Every kept JPEG decodes to its fixture's pixels (PIL's sha256), every
    kept PNG to the fixture pixels it was written from, for every filter set
    of REAL_FILTERS, every kept WebP to its fixture's PIL sha256 (each of
    REAL_T2I_OTHERS); the truncated JPEG of each shard is a ``CorruptImage``;
    one pass over each unresampled shard gives the same samples through the
    native streamer and the Python reader."""
    import hashlib
    import numpy as np
    from unigen_tpu_torch.data.decode import CorruptImage, decode_image
    from unigen_tpu_torch.data.native import NativeTarStream
    from unigen_tpu_torch.data.text2image import iterate_tar_samples
    fixtures = jpeg_fixtures()
    filters, names, corrupt, jpegs, pngs, others = set(), set(), 0, 0, 0, []
    for shard in shards:
        py = list(iterate_tar_samples(shard))
        native = NativeTarStream([shard], seed=0, resample=False)
        nat = list(native)
        native.close()
        check(nat == py and len(py) == REAL_PER_SHARD + 1,
              f"{shard}: the native streamer's pass ({len(nat)} samples) differs from the "
              f"Python reader's ({len(py)})")
        for sample in py:
            if sample["__key__"] not in kept:
                continue
            kind, name, fl = kept[sample["__key__"]]
            if kind == "image":
                others.append((name, sample[".webp"]))
                continue
            if kind == "jpeg":
                arr = decode_image(sample[".jpg"])
                check(hashlib.sha256(arr.tobytes()).hexdigest() == fixtures[name][1]["sha256"],
                      f"{sample['__key__']}: the decoder's pixels of {name} are not PIL's")
                jpegs += 1
            else:
                check(np.array_equal(decode_image(sample[".png"]), fixture_pixels(name)),
                      f"the decoder's pixels differ for {sample['__key__']} (filters {fl})")
                filters.add(tuple(fl))
                pngs += 1
            names.add(name)
        try:
            decode_image(py[-1][".jpg"])
            corrupt = -1
        except CorruptImage:
            corrupt += 1
    print(f"  decoder: {jpegs} JPEGs with PIL's pixels (sha256 of {sorted(names)}), {pngs} PNGs "
          f"equal to their pixels, filter sets {sorted(filters)}; the {corrupt} truncated JPEGs "
          f"raise CorruptImage; the native streamer's pass = the Python reader's on all "
          f"{len(shards)} shards")
    check(len(filters) == len(REAL_FILTERS) and corrupt == len(shards) and jpegs and
          names == set(REAL_T2I_FIXTURES),
          f"decoder checks: filter sets {filters}, corrupt {corrupt}, JPEGs {jpegs} of {names}")
    check_other_formats("the kept shards' other formats", others, REAL_T2I_OTHERS)


def loader_s(make, n=REAL_LOADER_BATCHES):
    """Seconds a batch of the iterator ``make()`` gives, over ``n`` batches
    after its first, the device idle."""
    it = iter(make())
    next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) / n


def _tap(flow, record):
    """``flow``'s batches, each also appended to ``record``."""
    for fb in flow:
        record.append(fb)
        yield fb


def check_fingerprints(name, records, taken, host):
    """The batch each step consumed has the fingerprint of the batch the
    loader yielded: ``host(flow batch)`` gives the loader's arrays of the
    fingerprinted keys, copied to the card as they are."""
    import torch
    from unigen_tpu_torch.training.train_dpo import batch_fingerprint
    check(len(taken) >= len(records), f"{name}: {len(taken)} loader batches, {len(records)} steps")
    for i, r in enumerate(records):
        want = batch_fingerprint({k: torch.as_tensor(v).to("cuda")
                                  for k, v in host(taken[i]).items()})
        check(r["fp"] == want, f"{name} step {i + 1}: consumed {r['fp']}, the loader gave {want}")
    print(f"  each of the {len(records)} steps consumed the loader's batch (fingerprints "
          f"{[r['fp'] for r in records]})")


def real_report(results, name, synthetic, loader):
    """Prints the phase's loader seconds a batch beside its step, and the
    synthetic phase of the same stage in this call."""
    r = results[name]
    r.update(loader)
    line = ", ".join(f"{k} {v:.4f} s" for k, v in loader.items())
    print(f"  {name}: loader a batch (alone, the device idle): {line}; step {r['step_s']:.4f} s, "
          f"loop {r['loop_s']:.4f} s, free-running {r['free_step_s']:.4f} s a step "
          f"(the loader in the loop {r['free_inline_step_s']:.4f}), "
          f"{r['samples_per_s']:.4f} samples/s, enqueue {r['enqueue_s']:.4f} s, peak "
          f"{r['peak_gib']:.2f} GiB")
    if synthetic in results:
        sy = results[synthetic]
        print(f"  beside {synthetic} (synthetic flows, this call): step {sy['step_s']:.4f} s, "
              f"{sy['samples_per_s']:.4f} samples/s, enqueue {sy['enqueue_s']:.4f} s, peak "
              f"{sy['peak_gib']:.2f} GiB; real / synthetic step {r['step_s'] / sy['step_s']:.4f}")


def free_running(results, name, make_loop, profile):
    """``make_loop(prefetch)()`` runs the entry's own loop (the loader's
    next batch, the host assembly, the step) with no synchronize between
    steps, as the entries run, with the entry's prefetch thread
    (``data/prefetch.py``) or with the loader read in the loop, and returns
    its number of steps. Each run opens its loader inside the timed window,
    so every batch it consumes is read there (the prefetch thread starts
    with nothing buffered). The two run in turns (without, with, with,
    without); the mean wall a step of each is the entry's seconds a step on
    files, and with ``profile`` one more prefetching run is profiled
    (``profile_run``: the idle share of its own wall)."""
    import statistics
    import torch
    loops = {False: make_loop(False), True: make_loop(True)}
    walls, steps = {False: [], True: []}, set()
    for pf in (False, True, True, False):
        t0 = time.perf_counter()
        n = loops[pf]()
        torch.cuda.synchronize()
        walls[pf].append((time.perf_counter() - t0) / n)
        steps.add(n)
    free, inline = statistics.mean(walls[True]), statistics.mean(walls[False])
    results[name].update(free_step_s=free, free_inline_step_s=inline)
    print(f"  the entry's loop free-running ({'/'.join(map(str, sorted(steps)))} steps, no "
          f"synchronize between them, the loader opened in the window), s a step: with the "
          f"prefetch thread {walls[True][0]:.4f}, {walls[True][1]:.4f}; the loader in the loop "
          f"{walls[False][0]:.4f}, {walls[False][1]:.4f}")
    if profile:
        print("  profile of the free-running loop with the prefetch thread:")
        profile_run(loops[True], free * max(steps))


def run_pt2_real(results, profile=False):
    """PT2 through the train entry on files read from disk: t2i from 5 and
    mmu (with the caption prompt) from 3 of REAL_SHARDS tar shards of
    REAL_PER_SHARD PNG samples (several sizes, every filter, one corrupt
    sample a shard) through ``training.train.task_flows`` (the native
    streamer) and ``combined_loader``; the lm rows the entry's synthetic lm
    texts (the card has no pyarrow; the parquet reader is held against JAX
    on the CPU only). REAL_WARM + REAL_TIMED steps; run_train's gates, the
    frozen VQ bit for bit, and each step's pixels the loader's."""
    import os
    import shutil
    import statistics
    import tempfile
    import torch
    from unigen_tpu_torch.data.combined import combined_loader
    from unigen_tpu_torch.data.prefetch import prefetch
    from unigen_tpu_torch.data.text2image import Text2ImageDataset
    from unigen_tpu_torch.training import train as TRAIN
    steps = REAL_WARM + REAL_TIMED
    print(f"phase: pt2_real ({TRAIN_CONFIG} on {REAL_SHARDS} tar shards of {REAL_PER_SHARD} "
          f"samples, JPEG with one PNG in {REAL_PNG_EVERY}, native streamer; lm rows from the "
          f"entry's synthetic lm texts: no pyarrow on the card; {REAL_WARM} warm + {REAL_TIMED} "
          f"timed steps)")
    root = tempfile.mkdtemp(prefix="chip_smoke_pt2_")
    try:
        t0 = time.perf_counter()
        shards, kept = write_real_shards(root, "pt2", REAL_SHARDS, REAL_PER_SHARD, keep=1)
        by_format = format_shards(root, "pt2")
        mib = sum(os.path.getsize(p) for p in shards) / 2 ** 20
        print(f"  wrote {len(shards)} shards ({mib:.1f} MiB) in {time.perf_counter() - t0:.2f} s")
        check_real_reading(shards, kept)
        t2i, mmu = (os.path.join(root, f"pt2-{{{a}..{b}}}.tar") for a, b in
                    (("0000", "0004"), ("0005", "0007")))
        shutil.rmtree(TRAIN_OUT, ignore_errors=True)
        config = train_config(f"training.max_train_steps={steps}", "dataset.synthetic=false",
                              f"dataset.params.train_t2i_shards_path_or_url={t2i}",
                              f"dataset.params.train_mmu_shards_path_or_url={mmu}",
                              "dataset.params.train_lm_shards_path_or_url=[no-pyarrow.parquet]")
        tr, res = config.training, config.dataset.preprocessing.resolution

        def flows():
            """The entry's real_flows before its prefetch thread, the lm flow
            ``synthetic_flows``' lm texts (without its random images)."""
            f = TRAIN.task_flows(config)
            check(f["t2i_flow"].use_native and f["mmu_flow"].use_native,
                  "pt2_real: the entry's flows do not use the native streamer")
            f["lm_flow"] = ({"input_ids": [f"document {i}-{j} text"
                                           for j in range(tr.batch_size_lm)]}
                            for i in itertools.count())
            return combined_loader(f)
        loader = {f"t2i python ({tr.batch_size_t2i} rows)": loader_s(
                      lambda: Text2ImageDataset([t2i], tr.batch_size_t2i, res, use_native=False)),
                  f"t2i native ({tr.batch_size_t2i} rows)": loader_s(
                      lambda: Text2ImageDataset([t2i], tr.batch_size_t2i, res, use_native=True)),
                  **format_loader_s(by_format, tr.batch_size_t2i, res),
                  "the entry's flows a step": loader_s(flows)}
        resident = torch.cuda.memory_allocated()
        trainer = TRAIN.build_trainer(config)
        layers = trainer.cfg.llm.num_hidden_layers
        per_step = dict(NO_LAUNCHES, flash_attention=2 * layers, flash_attention_backward=layers,
                        conv3x3_gn_swish=80, gn_affine=80)
        vq = _snapshot(trainer.vq_params)
        keys = ("mmu_pixels", "t2i_pixels")
        records, real_step = _timed_steps(trainer, "step_fn", keys)
        taken = []
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        torch.cuda.synchronize()
        trainer.train(_tap(prefetch(flows()), taken))
        torch.cuda.synchronize()
        counts = _read_counts()
        trainer.step_fn = real_step
        peak = torch.cuda.max_memory_allocated() - resident
        check(len(records) == steps, f"pt2_real: {len(records)} steps, not {steps}")
        check(counts == {k: steps * v for k, v in per_step.items()},
              f"pt2_real launch counts {counts} != {steps} x {per_step}")
        for i, r in enumerate(records):
            m = {k: float(v) for k, v in r["metrics"].items()}
            print(f"  step {i + 1}: {r['seconds']:.4f} s ({r['enqueue_s']:.4f} s to enqueue), "
                  + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
            check(r["counts"] == per_step, f"pt2_real step {i + 1} launches {r['counts']}")
            check(all(math.isfinite(v) for v in m.values()) and m["grad_norm"] > 0,
                  f"pt2_real step {i + 1} metrics {m}")
        changed = {p: n for p, n in _moved(vq, trainer.vq_params).items() if n}
        check(not changed, f"pt2_real: the frozen VQ changed: {changed}")
        check_fingerprints("pt2_real", records, taken, lambda fb: {
            "t2i_pixels": fb["t2i_flow"]["images"], "mmu_pixels": fb["mmu_flow"]["images"]})
        captions = [c for fb in taken for c in fb["mmu_flow"]["input_ids"]]
        print(f"  an mmu caption: {captions[0]!r}; t2i: {taken[0]['t2i_flow']['input_ids'][:2]}")
        times = [r["seconds"] for r in records[REAL_WARM:]]
        loop = _loop_walls(records, REAL_WARM)
        rows = tr.batch_size_t2i + tr.batch_size_lm + tr.batch_size_mmu
        med = statistics.median(times)
        results["pt2_real"] = dict(
            step_s=med, step_min_s=min(times), step_max_s=max(times), samples_per_s=rows / med,
            tokens_per_s=rows * trainer.prompting.max_seq_len / med,
            enqueue_s=statistics.median(r["enqueue_s"] for r in records[REAL_WARM:]),
            peak_gib=peak / 2 ** 30, loop_s=statistics.median(loop),
            model_tflops=_train_step_flops(trainer, train_bits(config))[0] / 1e12)
        print(f"  the loop a step (the loader's next batch, the host assembly, the step): "
              f"{', '.join(f'{x:.4f}' for x in loop)} s")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)

        def make_loop(pf):
            def loop():
                it = prefetch(flows()) if pf else flows()
                for _ in range(REAL_FREE_STEPS):
                    trainer.step_fn(trainer.state, trainer.vq_params,
                                    trainer.build_device_batch(next(it)), gen)
                it.close()
                return REAL_FREE_STEPS
            return loop
        free_running(results, "pt2_real", make_loop, profile)
        real_report(results, "pt2_real", "train", loader)
        del trainer
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_llava(root):
    """LLaVA conversations (``.jsonl``, one to three turns, some without an
    image key, one whose image is a truncated JPEG) over REAL_LLAVA_IMAGES
    files of the COCO fixtures in turn (``real_file``: JPEG, one in
    REAL_PNG_EVERY a PNG of their pixels, one in 4 the next of
    REAL_LLAVA_OTHERS: a GIF named .jpg, a BMP, a TIFF, a PPM). Returns the
    ``.jsonl``, the folder and [(fixture, path)] of the other formats."""
    import json
    import os
    images = os.path.join(root, "llava_images")
    os.makedirs(images)
    files, others = [], []
    for i in range(REAL_LLAVA_IMAGES):
        ext, data, holds = real_file(REAL_LLAVA_FIXTURES, i, others=REAL_LLAVA_OTHERS, every=4)
        files.append(f"img{i:03d}{ext}")
        with open(os.path.join(images, files[-1]), "wb") as f:
            f.write(data)
        if holds[0] == "image":
            others.append((holds[1], os.path.join(images, files[-1])))
    with open(os.path.join(images, "corrupt.jpg"), "wb") as f:
        f.write(jpeg_fixtures()[REAL_TRUNCATED][0])
    path = os.path.join(root, "llava.jsonl")
    with open(path, "w") as f:
        for i in range(3 * REAL_LLAVA_IMAGES):
            turns = []
            for t in range(1 + i % 3):
                turns += [{"from": "human", "value": ("<image>\n" if t == 0 else "")
                           + f"Question {t} about picture {i}: what is on the left side?"},
                          {"from": "gpt", "value": f"On the left there is object {i}-{t}, a "
                           "wooden chair beside a small table with a lamp."}]
            item = {"id": str(i), "conversations": turns}
            if i % 7 != 6:
                item["image"] = "corrupt.jpg" if i == 4 else files[i % REAL_LLAVA_IMAGES]
            f.write(json.dumps(item) + "\n")
    return path, images, others


def run_sft_real(results, profile=False):
    """SFT through the SFT entry on files read from disk (``unigen_sft.yaml``):
    t2i from REAL_SFT_SHARDS tar shards (native streamer), the conversations
    from a LLaVA ``.jsonl`` and an image folder at the SigLIP tower's 384 px
    (``LlavaDataset``, collated to 512 tokens: mmu rows of 3 + 729 + 512);
    REAL_WARM + REAL_TIMED steps, ``run_stage``'s prints and gates, each
    step's pixels the loader's."""
    import os
    import shutil
    import tempfile
    import torch
    from unigen_tpu_torch.data.llava import LlavaDataset
    from unigen_tpu_torch.data.text2image import Text2ImageDataset
    from unigen_tpu_torch.training import train_sft as SFT
    print(f"phase: sft_real ({SFT_CONFIG} on {REAL_SFT_SHARDS} tar shards and a LLaVA .jsonl over "
          f"{REAL_LLAVA_IMAGES} images, JPEG with one PNG in {REAL_PNG_EVERY}, one WebP in "
          f"{REAL_OTHER_EVERY} in the shards, a GIF named .jpg, a BMP, a TIFF and a PPM in the "
          f"folder; {REAL_WARM} warm + {REAL_TIMED} timed steps)")
    root = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    try:
        t0 = time.perf_counter()
        shards, kept = write_real_shards(root, "sft", REAL_SFT_SHARDS, REAL_PER_SHARD, keep=1)
        by_format = format_shards(root, "sft")
        llava, images, llava_others = write_llava(root)
        print(f"  wrote the shards and the conversations in {time.perf_counter() - t0:.2f} s")
        check_real_reading(shards, kept)

        def read(path):
            with open(path, "rb") as f:
                return f.read()
        check_other_formats("the LLaVA folder's other formats",
                            [(name, read(p)) for name, p in llava_others], REAL_LLAVA_OTHERS)
        t2i = os.path.join(root, f"sft-{{0000..{REAL_SFT_SHARDS - 1:04d}}}.tar")
        data = ("dataset.synthetic=false", f"dataset.params.train_t2i_shards_path_or_url={t2i}",
                f"dataset.params.llava_data_paths=[{llava}]",
                f"dataset.params.llava_image_root={images}")
        run, batch, resident = _sft_run(f"training.max_train_steps={REAL_WARM + REAL_TIMED}",
                                        *data)
        tr, res = run.config.training, run.config.dataset.preprocessing.resolution
        loader = {f"t2i python ({tr.batch_size_t2i} rows)": loader_s(
                      lambda: Text2ImageDataset([t2i], tr.batch_size_t2i, res, use_native=False)),
                  f"t2i native ({tr.batch_size_t2i} rows)": loader_s(
                      lambda: Text2ImageDataset([t2i], tr.batch_size_t2i, res, use_native=True)),
                  **format_loader_s(by_format, tr.batch_size_t2i, res),
                  f"llava ({tr.batch_size_mmu} conversations)": loader_s(
                      lambda: LlavaDataset([llava], images, run.prompting.text_tokenizer,
                                           tr.batch_size_mmu, visual_mode="siglip")),
                  "the entry's flows a step": loader_s(
                      lambda: SFT.real_batches(run.config, run.prompting, run.vs_cfg))}
        calls = sft_forward_bits(run.step, batch)
        flops = 3 * _stage_flops(run.state.params, run.cfg, calls)
        taken, records = [], []
        entry_batches = run.batches
        run.batches = lambda: _tap(entry_batches(), taken)
        counts = run_stage(results, "sft_real", run, REAL_WARM, REAL_TIMED, _sft_per_step(run),
                           sum(b.numel() for b, _ in calls), flops, resident,
                           fp_keys=("mmu_pixels", "t2i_pixels"), records_out=records)
        check_fingerprints("sft_real", records, taken, lambda fb: {
            "t2i_pixels": fb["t2i"]["images"], "mmu_pixels": fb["mmu"]["images"]})
        print(f"  mode {run.step.mode}, mmu rows {tuple(batch['mmu_labels'].shape)}, "
              f"conversation tokens {[int((l != -100).sum()) for l in taken[0]['mmu']['labels']]}")
        def make_loop(pf):
            def loop():
                it = (entry_batches() if pf else
                      SFT.real_batches(run.config, run.prompting, run.vs_cfg))
                for _ in range(REAL_FREE_STEPS):
                    run.state, _ = run.step(run.state, run.vq_params, run.vs_params,
                                            run.device_batch(next(it)), run.generator)
                it.close()
                return REAL_FREE_STEPS
            return loop
        free_running(results, "sft_real", make_loop, profile)
        real_report(results, "sft_real", "sft", loader)
        del run
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_dpo_real(results, profile=False):
    """DPO through the DPO entry on files read from disk (``unigen_dpo.yaml``:
    REAL_DPO_PAIRS pairs in a ``.jsonl``, PNGs of several sizes, one pair
    with a corrupt image; 10 pairs a step, ``training.num_epoch=2``, so the
    third step reads the second, reshuffled epoch). The entry's reference
    precompute pass first (its launches exact), then REAL_WARM +
    REAL_TIMED training steps with ``run_stage``'s gates; the entry's own
    check holds both passes to the same batches, and each step's pixels are
    the loader's."""
    import json
    import os
    import shutil
    import tempfile
    import torch
    from unigen_tpu_torch.data.dpo_data import DPODataset
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.training.train_dpo import DPORun, real_pairs
    steps = REAL_WARM + REAL_TIMED
    print(f"phase: dpo_real ({DPO_CONFIG} on {REAL_DPO_PAIRS} pairs of images, JPEG with one PNG "
          f"in {REAL_PNG_EVERY} and one lossless WebP in {REAL_OTHER_EVERY}, num_epoch 2, the "
          f"precomputed reference; {REAL_WARM} warm + {REAL_TIMED} timed steps)")
    root = tempfile.mkdtemp(prefix="chip_smoke_dpo_")
    try:
        images = os.path.join(root, "dpo_images")
        os.makedirs(images)
        t0 = time.perf_counter()
        dpo_others = []
        with open(os.path.join(root, "pairs.jsonl"), "w") as f:
            for i in range(REAL_DPO_PAIRS):
                pair = {}
                for side in ("c", "r"):
                    ext, data, holds = real_file(REAL_DPO_FIXTURES, 2 * i + (side == "r"),
                                                 others=REAL_DPO_OTHERS)
                    if holds[0] == "image":
                        dpo_others.append((holds[1], data))
                    if (i, side) == (7, "r"):
                        ext, data = ".jpg", jpeg_fixtures()[REAL_TRUNCATED][0]
                    pair[side] = f"{side}{i:03d}{ext}"
                    with open(os.path.join(images, pair[side]), "wb") as img:
                        img.write(data)
                f.write(json.dumps({"prompt": f"a photo of a red cup number {i} on a table",
                                    "chosen": pair["c"], "rejected": pair["r"]}) + "\n")
        print(f"  wrote {2 * REAL_DPO_PAIRS} images in {time.perf_counter() - t0:.2f} s")
        check_other_formats("the pairs' lossless WebPs", dpo_others, REAL_DPO_OTHERS)
        data = ("dataset.synthetic=false", f"dataset.params.dpo_data_path={root}/pairs.jsonl",
                f"dataset.params.dpo_image_root={images}", "training.num_epoch=2")
        resident = torch.cuda.memory_allocated()
        run = DPORun(stage_config(DPO_CONFIG, f"training.max_train_steps={steps}", *data))
        check(run.use_precomputed, "dpo_real does not precompute the reference")
        b = run.config.training.batch_size_t2i
        loader = {f"pairs ({b} pairs, {2 * b} images)": loader_s(
            lambda: (fb for ds in [DPODataset([f"{root}/pairs.jsonl"], images, b, 256)]
                     for _ in range(8) for fb in ds))}
        layers = run.cfg.llm.num_hidden_layers
        convs = 2 * sum(k for *_, k in ENCODER_CONVS)
        _reset_counts()
        t0 = time.perf_counter()
        run.precompute()
        torch.cuda.synchronize()
        pre = _read_counts()
        print(f"  reference precompute pass: {len(run.ref_cache)} steps in "
              f"{time.perf_counter() - t0:.2f} s; launches {pre}")
        check(pre == {k: steps * v for k, v in dict(NO_LAUNCHES, flash_attention=layers,
                                                    conv3x3_gn_swish=convs,
                                                    gn_affine=convs).items()},
              f"dpo_real precompute launches {pre}")
        recompute = layers if run.dcfg.remat else 0
        per_step = dict(NO_LAUNCHES, flash_attention=layers + recompute,
                        flash_attention_backward=layers, conv3x3_gn_swish=convs,
                        gn_affine=convs)
        first = next(run.step_schedule())[0]
        bits = M.pack_meta(M.t2i_attn_meta(torch.cat([first["template"]] * 2), run.dcfg.pad_id,
                                           run.dcfg.soi_id, run.dcfg.eoi_id))
        flops = 3 * _stage_flops(run.state.params, run.cfg, [(bits, 2 * b * run.cfg.num_vq_tokens)])
        taken, records = [], []
        entry_pairs = run.pairs
        run.pairs = lambda: _tap(entry_pairs(), taken)
        counts = run_stage(results, "dpo_real", run, REAL_WARM, REAL_TIMED, per_step, bits.numel(),
                           flops, resident, projector=False,
                           fp_keys=("chosen_pixels", "rejected_pixels"), records_out=records)
        check_fingerprints("dpo_real", records, taken, lambda fb: {
            "chosen_pixels": fb["batch_chosen_image"],
            "rejected_pixels": fb["batch_rejected_image"]})
        epochs = [fb["batch_prompt_list"][0] for fb in taken]
        print(f"  first prompts of the steps' batches: {epochs}")

        def make_loop(pf):
            def loop():
                # the schedule from its start, as far as the precomputed references go
                sched = run.step_schedule(entry_pairs() if pf else real_pairs(run.config))
                for (batch, draws), (_, refs) in zip(sched, run.ref_cache):
                    run.state, _ = run.step(run.state, None, run.vq_params, {**batch, **refs},
                                            draws)
                sched.close()
                return len(run.ref_cache)
            return loop
        free_running(results, "dpo_real", make_loop, profile)
        real_report(results, "dpo_real", "dpo", loader)
        del run
        torch.cuda.empty_cache()
        return {k: counts[k] + pre[k] for k in counts}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_tiny_post_training():
    """The tiny fp32 SFT (separate and packed) and DPO steps on the card
    against the CPU, the same weights, batch and masking draws: losses,
    the grad norm and the gradients within 1e-4 (relative; of the largest
    gradient), the card's AdamW on the CPU's gradients within 1e-5 of each
    leaf's largest magnitude (Adam's first step is not held across devices:
    ``run_tiny_train``). Then 6 tiny DPO steps on the card raise the reward
    accuracy or lower the loss."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.training import dpo as D
    from unigen_tpu_torch.training import lr_schedules as LRS
    from unigen_tpu_torch.training import sft as SFT
    from unigen_tpu_torch.training.optimizer import global_norm, make_optimizer, named_leaves
    print("phase: tiny fp32 SFT (separate, packed) and DPO steps, the card vs the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    gpu = cpu.to("cuda")
    sp, n = cpu.prompting.sptids_dict, cpu.cfg.num_vq_tokens
    pad, soi, eoi = cpu.prompting.pad_id, sp["<|soi|>"], sp["<|eoi|>"]
    rng = np.random.default_rng(0)
    length, bt, bl, bm = 28, 2, 1, 2
    p_tokens = cpu.vision_cfg.num_patches
    mmu_len = 3 + p_tokens + 50
    t2i = rng.integers(3, 100, size=(bt, length))
    t2i[:, -n - 2], t2i[:, -1], t2i[:, -n - 1:-1] = soi, eoi, 0
    t2i[1, :2] = pad
    mmu_labels = np.full((bm, mmu_len), -100)
    mmu_labels[:, -6:] = rng.integers(3, 100, size=(bm, 6))
    res, vres = cpu.vq_cfg.resolution, cpu.vision_cfg.image_size
    host = {"t2i_template": t2i, "t2i_labels": np.full((bt, length), -100),
            "t2i_pixels": rng.normal(size=(bt, res, res, 3)).astype(np.float32),
            "lm_ids": rng.integers(3, 100, size=(bl, length)),
            "lm_labels": rng.integers(3, 100, size=(bl, length)),
            "mmu_part1": rng.integers(3, 100, size=(bm, 3)),
            "mmu_part2": rng.integers(3, 100, size=(bm, 50)), "mmu_labels": mmu_labels,
            "mmu_pixels": rng.normal(size=(bm, vres, vres, 3)).astype(np.float32),
            "mmu_prompt_len": np.array([mmu_len, mmu_len - 2])}
    draws = MK.draw_masking(torch.Generator().manual_seed(0), bt, n,
                            codebook_size=cpu.cfg.codebook_size)

    def on(device, tree):
        return {k: torch.as_tensor(v, device=device) for k, v in tree.items()}

    def compare(name, make, run_grads):
        sides = {}
        for device, pipe in (("cpu", cpu), ("cuda", gpu)):
            tx = make_optimizer(pipe.params, 1e-3, LRS.get_scheduler("constant"),
                                max_grad_norm=1.0)
            state = SFT.init_sft_state(pipe.params, tx)
            _reset_counts()
            grads, m = run_grads(make(pipe, tx), state, pipe, device)
            m["grad_norm"] = global_norm([g for g in grads if g is not None])
            sides[device] = (tx, state, grads, {k: float(v) for k, v in m.items()},
                             dict(_read_counts()))
        (c_tx, c_state, c_g, c_m, _), (g_tx, g_state, g_g, g_m, counts) = \
            sides["cpu"], sides["cuda"]
        rel = {k: abs(g_m[k] - c_m[k]) / max(abs(c_m[k]), 1e-30) for k in c_m}
        gmax = max(g.abs().max().item() for g in c_g if g is not None)
        gerr = max((a.cpu() - b).abs().max().item() for a, b in zip(g_g, c_g) if b is not None)
        c_leaves = [t for _, t in named_leaves(c_state.params)]
        g_leaves = [t for _, t in named_leaves(g_state.params)]
        c_tx.update(c_g, c_state.opt_state, c_leaves)
        g_tx.update([None if g is None else g.to("cuda") for g in c_g], g_state.opt_state,
                    g_leaves)
        upd = max((a.detach().cpu() - b.detach()).abs().max().item()
                  / max(b.detach().abs().max().item(), 1e-30) for a, b in zip(g_leaves, c_leaves))
        print(f"  {name}: launches {counts}; relative differences {rel} (need <= 1e-4); "
              f"gradients {gerr:.3e} of a largest {gmax:.3e} (need <= 1e-4 of it); the card's "
              f"AdamW on the CPU's gradients {upd:.3e} of each leaf's largest magnitude "
              "(need <= 1e-5)")
        check(counts["flash_attention"] > 0 and counts["flash_attention_backward"] > 0
              and counts["conv3x3_gn_swish"] > 0, f"tiny {name} skipped a kernel: {counts}")
        check(all(v <= 1e-4 for v in rel.values()), f"tiny {name} card vs CPU: {rel}")
        check(gerr <= 1e-4 * gmax, f"tiny {name} gradients differ: {gerr} of {gmax}")
        check(upd <= 1e-5, f"tiny {name} AdamW on the card differs: {upd}")

    for common in (None, mmu_len):
        def make(pipe, tx, common=common):
            tcfg = SFT.SFTStepConfig(bt, bl, bm, max_grad_norm=1.0, pad_id=pad, soi_id=soi,
                                     eoi_id=eoi, common_length=common)
            return SFT.SFTStep(pipe.cfg, pipe.vq_cfg, pipe.vision_cfg, tx, tcfg)

        def sft_grads(step, state, pipe, device):
            dr = MK.MaskDraws(*(None if x is None else x.to(device) for x in draws))
            return step.loss_and_grads(state.params, pipe.vq_params, pipe.vision_params,
                                       on(device, host), dr)
        compare(f"SFT step ({'packed' if common else 'separate'})", make, sft_grads)

    dpo_host = {"template": t2i, "labels": np.full((bt, length), -100),
                "chosen_pixels": host["t2i_pixels"],
                "rejected_pixels": rng.normal(size=(bt, res, res, 3)).astype(np.float32)}
    pair = (draws, MK.draw_masking(torch.Generator().manual_seed(1), bt, n,
                                   codebook_size=cpu.cfg.codebook_size))
    dcfg = D.DPOConfig(beta=0.1, max_grad_norm=1.0, pad_id=pad, soi_id=soi, eoi_id=eoi)

    def dpo_grads(step, state, pipe, device):
        dr = tuple(MK.MaskDraws(*(None if x is None else x.to(device) for x in d)) for d in pair)
        return step.loss_and_grads(state.params, pipe.params, pipe.vq_params,
                                   on(device, dpo_host), dr)
    compare("DPO step", lambda pipe, tx: D.make_dpo_step(pipe.cfg, pipe.vq_cfg, tx, dcfg),
            dpo_grads)
    tx = make_optimizer(gpu.params, 5e-4, LRS.get_scheduler("constant"), max_grad_norm=1.0)
    step = D.make_dpo_step(gpu.cfg, gpu.vq_cfg, tx, dcfg)
    state = SFT.init_sft_state(gpu.params, tx)
    dr = tuple(MK.MaskDraws(*(None if x is None else x.to("cuda") for x in d)) for d in pair)
    hist = []
    for _ in range(6):
        state, m = step(state, gpu.params, gpu.vq_params, on("cuda", dpo_host), dr)
        hist.append((float(m["loss"]), float(m["reward_accuracy"])))
    print(f"  6 tiny DPO steps on the card (loss, reward accuracy): {hist}")
    check(all(math.isfinite(x) for x, _ in hist)
          and (hist[-1][0] < hist[0][0] or hist[-1][1] > hist[0][1]),
          f"tiny DPO did not learn the preference: {hist}")


# ---------------------------------------------------------------------------
# the checkpoints phase: reference / HF layouts, written from the port's trees
# ---------------------------------------------------------------------------

# HF's names of a Qwen2 layer's tensors and a SigLIP encoder layer's, by the
# port's leaf: the inverse of the converters, written out here on its own
HF_QWEN2_LAYER = (("input_ln", "input_layernorm.weight"),
                  ("post_ln", "post_attention_layernorm.weight"),
                  ("q_w", "self_attn.q_proj.weight"), ("q_b", "self_attn.q_proj.bias"),
                  ("k_w", "self_attn.k_proj.weight"), ("k_b", "self_attn.k_proj.bias"),
                  ("v_w", "self_attn.v_proj.weight"), ("v_b", "self_attn.v_proj.bias"),
                  ("o_w", "self_attn.o_proj.weight"), ("gate_w", "mlp.gate_proj.weight"),
                  ("up_w", "mlp.up_proj.weight"), ("down_w", "mlp.down_proj.weight"))
HF_SIGLIP_LAYER = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                   ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                   ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
# the checkpoints phase: UniGen in bf16 shards, the shard count; Qwen2.5-1.5B's own
# vocabulary, which import_qwen2 grows to the unified one
CKPT_UNIGEN_SHARDS = 3
TOK_TRAIN_TEXTS = 3000      # seeded texts the checkpoints phase's BPE merges are counted over
TOK_RATE_TEXTS = 2000       # distinct held-out texts its encode rate is timed over
QWEN25_VOCAB = 151936
QWEN25_ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
                "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
                "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>",
                "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
                "<|repo_name|>", "<|file_sep|>")
QWEN25_SPECIAL = 14          # the first 14 are special (skipped on decode)


def hf_unigen_state_dict(params, prefix="llm."):
    """The port's float UniGen tree -> the reference's ``unwrapped_model``
    state dict: ``llm.model.*``, ``llm.lm_head`` when untied, ``gen_embed`` /
    ``gen_projector`` / ``img_head`` and ``mm_projector`` (Sequential
    indices 0, 2, ...). Linear weights are [out, in] in both."""
    llm = params["llm"]
    sd = {f"{prefix}model.embed_tokens.weight": llm["embed"],
          f"{prefix}model.norm.weight": llm["final_ln"]}
    for i, lp in enumerate(llm["layers"]):
        for leaf, key in HF_QWEN2_LAYER:
            sd[f"{prefix}model.layers.{i}.{key}"] = lp[leaf]
    if "lm_head" in llm:
        sd[f"{prefix}lm_head.weight"] = llm["lm_head"]
    if "gen_embed" in params:
        sd["gen_embed.weight"] = params["gen_embed"]
        sd["img_head.weight"] = params["img_head"]
    for name in ("gen_projector", "mm_projector"):
        for j, p in enumerate(params.get(name, [])):
            sd[f"{name}.{2 * j}.weight"], sd[f"{name}.{2 * j}.bias"] = p["w"], p["b"]
    return sd


def hf_siglip_state_dict(params, extra_layer_gen=None, prefix="vision_model.", naflex=False):
    """The port's SigLIP (or, with ``naflex``, SigLIP2) tower -> HF's vision
    model state dict: the patch convolution HWIO -> OIHW (NaFlex: the linear
    patch embedding as it is), the layers; with ``extra_layer_gen`` also the
    layer HF has after them (drawn from that generator), ``post_layernorm``
    and the pooling head's ``head.*``, which the converters do not read."""
    import torch
    pe = params["patch_embed"]
    sd = ({f"{prefix}embeddings.patch_embedding.weight": pe["w"],
           f"{prefix}embeddings.patch_embedding.bias": pe["b"]} if naflex else
          {f"{prefix}embeddings.patch_embedding.weight": pe["kernel"].permute(3, 2, 0, 1),
           f"{prefix}embeddings.patch_embedding.bias": pe["bias"]})
    sd[f"{prefix}embeddings.position_embedding.weight"] = params["pos_embed"]
    layers = list(params["layers"])
    if extra_layer_gen is not None:
        last = layers[-1]

        def draw(t):
            return torch.randn(t.shape, generator=extra_layer_gen, device=t.device).to(t.dtype)
        layers.append({k: ({kk: draw(vv) for kk, vv in v.items()} if isinstance(v, dict)
                           else draw(v)) for k, v in last.items()})
        d = last["ln1"]["scale"]
        sd.update({f"{prefix}post_layernorm.weight": draw(d), f"{prefix}post_layernorm.bias":
                   draw(d), f"{prefix}head.probe": draw(d).reshape(1, 1, -1),
                   f"{prefix}head.layernorm.weight": draw(d)})
    for i, lp in enumerate(layers):
        at = f"{prefix}encoder.layers.{i}."
        for ln, n in (("ln1", 1), ("ln2", 2)):
            sd[f"{at}layer_norm{n}.weight"], sd[f"{at}layer_norm{n}.bias"] = \
                lp[ln]["scale"], lp[ln]["bias"]
        for leaf, module in HF_SIGLIP_LAYER:
            sd[f"{at}{module}.weight"], sd[f"{at}{module}.bias"] = lp[f"{leaf}_w"], lp[f"{leaf}_b"]
    return sd


def torch_magvit_state_dict(params):
    """The port's MAGViTv2 tree -> the reference's torch state dict: the
    tree's paths joined by ``.``, a conv's HWIO kernel as its OIHW
    ``weight``, a GroupNorm's ``scale`` as its ``weight``."""
    sd = {}

    def walk(node, name):
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
        elif "kernel" in node:
            sd[name + ".weight"] = node["kernel"].permute(3, 2, 0, 1)
            sd[name + ".bias"] = node["bias"]
        elif "scale" in node:
            sd[name + ".weight"], sd[name + ".bias"] = node["scale"], node["bias"]
        else:
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
    walk({"encoder": params["encoder"], "decoder": params["decoder"]}, "")
    return sd


def write_sharded(sd, root, n_shards, dtype=None):
    """``sd`` as ``n_shards`` safetensors files with
    ``model.safetensors.index.json`` (one ``model.safetensors`` when 1), in
    ``dtype`` when given (cast where the tensors lie), by the port's writer:
    the host holds one tensor's bytes at a time. Returns the bytes written."""
    import os
    from unigen_tpu_torch.utils.persistence import save_file
    os.makedirs(root, exist_ok=True)
    keys, size, weight_map = list(sd), 0, {}
    per = -(-len(keys) // n_shards)
    for i in range(n_shards):
        name = ("model.safetensors" if n_shards == 1
                else f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors")
        shard = {k: sd[k] if dtype is None else sd[k].to(dtype)
                 for k in keys[i * per:(i + 1) * per]}
        save_file(shard, os.path.join(root, name))
        size += sum(t.numel() * t.element_size() for t in shard.values())
        weight_map.update(dict.fromkeys(shard, name))
    if n_shards > 1:
        with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": size}, "weight_map": weight_map}, f)
    return size


def tokenizer_corpus(n_texts, seed):
    """``n_texts`` distinct seeded texts of 8-40 pseudo-words each: a
    lexicon of 30,000 words of 1-4 syllables drawn by Zipf's law (exponent
    1.1, as word counts of running text fall off), capitals, digits,
    punctuation, newlines and a few accented, CJK and emoji words."""
    import numpy as np
    rng = np.random.default_rng(seed)
    onsets = ["", "b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r", "s", "t",
              "v", "w", "st", "tr", "pl", "ch", "sh", "th", "br", "gr"]
    vowels = ["a", "e", "i", "o", "u", "ai", "ea", "ou", "oo", "y"]
    codas = ["", "n", "r", "s", "t", "l", "nd", "st", "ng", "ck"]
    odd = ["café", "naïve", "Zürich", "日本語", "東京", "😀", "Привет", "x86_64", "e-mail"]
    seps = [" "] * 12 + [", ", ". ", "\n", "  ", "'s "]
    syl = rng.integers(0, [len(onsets), len(vowels), len(codas)], size=(200000, 3))
    syl = [onsets[a] + vowels[b] + codas[c] for a, b, c in syl.tolist()]
    lens = rng.integers(1, 5, size=50000).tolist()
    lex, at = [], 0
    for n in lens:
        lex.append("".join(syl[at:at + n]))
        at += n
    lex = list(dict.fromkeys(lex))[:30000]
    p = 1.0 / np.arange(1, len(lex) + 1) ** 1.1
    out = set()
    while len(out) < n_texts:
        n = n_texts - len(out)
        sizes = rng.integers(8, 41, size=n)
        total = int(sizes.sum())
        picks = rng.choice(len(lex), total, p=p / p.sum()).tolist()
        kinds = rng.random(total).tolist()
        nums = rng.integers(0, 100000, size=total).tolist()
        odds = rng.integers(0, len(odd), size=total).tolist()
        gaps = rng.integers(0, len(seps), size=total).tolist()
        ends = rng.integers(0, 3, size=n).tolist()
        at = 0
        for t, size in enumerate(sizes.tolist()):
            words = []
            for j in range(at, at + size):
                w = (odd[odds[j]] if kinds[j] < 0.02 else str(nums[j]) if kinds[j] < 0.05
                     else lex[picks[j]].capitalize() if kinds[j] < 0.10 or j == at
                     else lex[picks[j]])
                words.append(w + (seps[gaps[j]] if j < at + size - 1 else ""))
            at += size
            out.add("".join(words) + (".", "?", "!\n")[ends[t]])
    return sorted(out)


def write_qwen_tokenizer(root, texts, n_merges=4000):
    """A tokenizer directory of Qwen2's structure (``tokenizer.json`` and
    ``tokenizer_config.json``) without ``tokenizers``: the 256 byte
    symbols, then up to ``n_merges`` BPE merges counted over ``texts`` (the
    most frequent pair first, ties to the smaller pair, pairs seen at least
    twice; pair counts kept up to date word by word, so thousands of merges
    take seconds), then Qwen2.5's 22 added tokens. Returns the merges'
    count."""
    import collections
    import heapq
    import os
    import unicodedata
    from unigen_tpu_torch.utils.qwen_tokenizer import QWEN2_PATTERN, bytes_to_unicode, split_words
    byte_chars = bytes_to_unicode()
    vocab = {byte_chars[b]: b for b in range(256)}
    counted = collections.Counter()
    for t in texts:
        for w in split_words(unicodedata.normalize("NFC", t)):
            counted[tuple(byte_chars[b] for b in w.encode("utf-8"))] += 1
    words, counts = [list(w) for w in counted], list(counted.values())
    pairs, where = collections.Counter(), collections.defaultdict(set)
    for i, w in enumerate(words):
        for p in zip(w, w[1:]):
            pairs[p] += counts[i]
            where[p].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while len(merges) < n_merges and heap:
        c, best = heapq.heappop(heap)
        if -c != pairs[best]:
            continue                        # a stale count: the current one is queued
        if -c < 2:
            break
        merges.append(best)
        joined = best[0] + best[1]
        vocab.setdefault(joined, len(vocab))
        changed = set()
        for i in where.pop(best):
            w = words[i]
            for p in zip(w, w[1:]):
                pairs[p] -= counts[i]
                changed.add(p)
            out, j = [], 0
            while j < len(w):
                if (w[j], w[j + 1] if j + 1 < len(w) else None) == best:
                    out.append(joined)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i] = out
            for p in zip(out, out[1:]):
                pairs[p] += counts[i]
                where[p].add(i)
                changed.add(p)
        for p in changed:
            if pairs[p] > 0:
                heapq.heappush(heap, (-pairs[p], p))
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": len(vocab) + i, "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": i < QWEN25_SPECIAL} for i, t in enumerate(QWEN25_ADDED)],
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
                 "invert": False}, byte_level]},
            "post_processor": byte_level, "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
                      "merges": [" ".join(m) for m in merges]}}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
                   "pad_token": "<|endoftext|>", "model_max_length": 131072,
                   "clean_up_tokenization_spaces": False}, f)
    return len(merges)


def _rss_gib(field="VmRSS"):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


@contextlib.contextmanager
def _step(what, record):
    """Times a step (ending in a synchronize) into ``record`` with the host's
    peak RSS over it, sampled every 5 ms by a thread (the peak of the whole
    process, ``VmHWM``, covers the phases before this one)."""
    import threading
    import torch
    before = _rss_gib()
    peak, stop = [before], threading.Event()

    def sample():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], _rss_gib())
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        yield
        torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    record[what] = {"s": time.perf_counter() - t0, "rss_before_gib": before,
                    "peak_rss_gib": max(peak[0], _rss_gib())}
    r = record[what]
    print(f"  {what}: {r['s']:.2f} s, host RSS {before:.2f} GiB before, peak "
          f"{r['peak_rss_gib']:.2f} GiB")


@contextlib.contextmanager
def _timed_builders(record, label):
    """Times each model's load and conversion inside ``build_pipeline(config)``."""
    import torch
    from unigen_tpu_torch import launch
    names = ("build_unigen", "build_vq", "build_vision_tower")
    real = {n: getattr(launch, n) for n in names}

    def timed(n):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[n](*a, **kw)
            torch.cuda.synchronize()
            record[f"{label} {n}"] = time.perf_counter() - t0
            return out
        return call
    for n in names:
        setattr(launch, n, timed(n))
    try:
        yield
    finally:
        for n in names:
            setattr(launch, n, real[n])


def _leaves_equal(what, got, want, dtype):
    """Every leaf of ``got`` on the card, in ``dtype``, contiguous, and bit
    for bit ``want``'s leaf cast to ``dtype``; the same paths."""
    import torch
    from unigen_tpu_torch.utils.persistence import _leaves
    a, b = list(_leaves(got)), list(_leaves(want))
    check([p for p, _ in a] == [p for p, _ in b], f"{what}: the tree's paths differ")
    for (p, x), (_, y) in zip(a, b):
        check(x.device.type == "cuda" and x.dtype == dtype and x.is_contiguous()
              and tuple(x.shape) == tuple(y.shape), f"{what} {p}: {x.device} {x.dtype} "
              f"{tuple(x.shape)} strides {x.stride()}")
        check(torch.equal(x, y.to(dtype)), f"{what} {p}: not the seed-0 leaf bit for bit")
    return len(a)


def ckpt_config(base, unigen_dir):
    from unigen_tpu_torch.utils.configuration import initialize_config
    return initialize_config(SFT_CONFIG, [f"model.ckpt_base_path={base}",
                                          f"model.unigen.pretrained_model_path={unigen_dir}"])


def run_checkpoints(results, profile=False):
    """Reference and HF checkpoints through ``build_pipeline(config)`` at full
    width: the seed-0 flagship (with the SigLIP tower) written in the
    reference layouts (UniGen bf16 in 3 shards with an index; MAGViTv2 fp32
    as a ``pytorch_model.bin``; SigLIP-SO400M fp32 with its 27th layer,
    ``post_layernorm`` and head), natively, and by ``import_weights.convert``;
    ``unigen_sft.yaml`` built from each, every leaf held to the seed tree;
    t2i and understand on the reference and native loads, equal codes and
    tokens, exact launches; ``import_qwen2``'s resize of Qwen2.5's 151,936
    rows; a Qwen2 tokenizer directory read without ``transformers``."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from unigen_tpu_torch import launch
    from unigen_tpu_torch import weights as W
    from unigen_tpu_torch.utils import import_weights
    from unigen_tpu_torch.utils.hf_import import import_qwen2
    from unigen_tpu_torch.utils.persistence import _leaves, save_pretrained
    from unigen_tpu_torch.utils.qwen_tokenizer import QwenTokenizer
    print(f"phase: checkpoints (flagship + SigLIP seed 0 written in the reference layouts, "
          f"natively and by import_weights; {SFT_CONFIG} built from each)")
    seed = flagship_pipeline(vision=True)
    conf = ckpt_config("", "")
    prompting = launch.build_prompting_from_config(conf, launch.load_tokenizer(conf))
    cfg = launch.build_unigen_config(conf, prompting)
    shapes = [tuple(t.shape) for _, t in _leaves(W.init_unigen(cfg, None, "meta"))]
    check(shapes == [tuple(t.shape) for _, t in _leaves(seed.params)] and
          cfg.llm.vocab_size == seed.cfg.llm.vocab_size == 159867,
          "unigen_sft.yaml's UniGen shapes are not the flagship's")
    vs_cfg, vq_cfg = launch.vision_tower_config(conf), launch.vq_config(conf, torch.bfloat16)
    check(dataclasses.replace(vs_cfg, dtype=torch.bfloat16) == seed.vision_cfg and
          vq_cfg == seed.vq_cfg, "unigen_sft.yaml's tower or tokenizer is not the flagship's")
    tower = conf["model"]["vision_tower"]["name"]
    rec, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ref, nat, conv = (os.path.join(tmp, d) for d in ("ref", "native", "converted"))
    try:
        free = shutil.disk_usage(tmp).free / 2 ** 30
        print(f"  {tmp}: {free:.1f} GiB free")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with _step("write the reference layouts", rec):
            sizes = {"unigen": write_sharded(hf_unigen_state_dict(seed.params),
                                             os.path.join(ref, "unigen", "unwrapped_model"),
                                             CKPT_UNIGEN_SHARDS, torch.bfloat16)}
            mv = {k: v.detach().to("cpu", torch.float32).contiguous()
                  for k, v in torch_magvit_state_dict(seed.vq_params).items()}
            os.makedirs(os.path.join(ref, "magvitv2"))
            torch.save(mv, os.path.join(ref, "magvitv2", "pytorch_model.bin"))
            sizes["magvitv2"] = sum(t.numel() * 4 for t in mv.values())
            del mv
            sizes["tower"] = write_sharded(hf_siglip_state_dict(seed.vision_params, gen),
                                           os.path.join(ref, tower), 1, torch.float32)
        print("  reference layouts: " + ", ".join(f"{k} {v / 2 ** 30:.3f} GiB"
                                                  for k, v in sizes.items()))
        with _step("write the native checkpoints", rec):
            save_pretrained(W.unigen_to_jax(seed.params, seed.cfg), os.path.join(nat, "unigen"),
                            config=seed.cfg)
            save_pretrained(W.magvit_to_jax(seed.vq_params), os.path.join(nat, "magvitv2"),
                            config=seed.vq_cfg)
            save_pretrained(W.siglip_to_jax(seed.vision_params, seed.vision_cfg),
                            os.path.join(nat, tower), config=seed.vision_cfg)
        with _step("import_weights.convert", rec):
            written = import_weights.convert(
                ckpt_config(ref, ""), unigen_src=os.path.join(ref, "unigen"),
                magvit_src=os.path.join(ref, "magvitv2"), vision_src=os.path.join(ref, tower),
                out=conv)
        check(sorted(written) == sorted(["unigen", "magvitv2", tower]),
              f"import_weights wrote {written}")
        outs = {}
        for label, base in (("reference", ref), ("native", nat), ("converted", conv)):
            with _step(f"build_pipeline(config) from the {label} checkpoints", rec), \
                    _timed_builders(times, label):
                pipe = launch.build_pipeline(ckpt_config(base, os.path.join(base, "unigen")),
                                             device="cuda")
            print("    " + ", ".join(f"{n} {times[f'{label} {n}']:.2f} s" for n in
                                      ("build_unigen", "build_vq", "build_vision_tower")))
            n = sum(_leaves_equal(f"{label} {part}", got, want, dt) for part, got, want, dt in (
                ("UniGen", pipe.params, seed.params, torch.bfloat16),
                ("MAGViTv2", pipe.vq_params, seed.vq_params, torch.bfloat16),
                ("SigLIP", pipe.vision_params, seed.vision_params, torch.float32)))
            print(f"  {label}: {n} leaves bit for bit the seed-0 tree (UniGen and MAGViTv2 "
                  "bf16, the tower fp32), contiguous, on the card")
            if label == "converted":
                break
            if label == "reference":
                lp, _ = t2i_prefix_layout(pipe, mode="mask")
                lu, _, _ = understand_prompt_shape(pipe)
                print(f"  {SFT_CONFIG}'s prompting: t2i prefix {lp}, cache "
                      f"{lp + pipe.cfg.num_vq_tokens + 2} (text budget 128); understand prompt "
                      f"{lu}, cache {lu + NEW_TOKENS}")
            layers = pipe.cfg.llm.num_hidden_layers
            out = {}
            (out["codes"], _), out["t2i_s"], _, out["t2i_counts"] = _timed_runs(
                f"checkpoints {label} t2i", _t2i_run(pipe, timesteps=50),
                dict(NO_LAUNCHES, **_t2i_launches(layers)), runs=ONCE,
                validate=_t2i_checker(f"checkpoints {label} t2i", pipe),
                work=(len(PROMPTS), "images"))
            pixels = _vqa_pixels(pipe)
            out["tokens"], out["understand_s"], _, out["understand_counts"] = _timed_runs(
                f"checkpoints {label} understand",
                lambda p=pipe: p.understand(pixels, list(QUESTIONS), None,
                                            max_new_tokens=NEW_TOKENS),
                dict(NO_LAUNCHES, flash_attention=pipe.vision_cfg.num_layers_used + layers,
                     chunk_attention=layers * (NEW_TOKENS - 1)), runs=ONCE,
                validate=_token_checker(f"checkpoints {label} understand",
                                        pipe.cfg.llm.vocab_size),
                work=(len(QUESTIONS) * NEW_TOKENS, "tokens"))
            outs[label] = out
            del pipe
        del pipe
        torch.cuda.empty_cache()
        check(torch.equal(outs["reference"]["codes"], outs["native"]["codes"]),
              "t2i codes of the reference-layout load != the native load's")
        check(torch.equal(outs["reference"]["tokens"], outs["native"]["tokens"]),
              "understand tokens of the reference-layout load != the native load's")
        print("  codes and tokens equal between the reference-layout and the native load")

        # Qwen2.5-1.5B's own vocabulary grown to the unified one on load
        embed = seed.params["llm"]["embed"]
        sd = {"model." + k[len("llm.model."):]: v
              for k, v in hf_unigen_state_dict(seed.params).items() if k.startswith("llm.model.")}
        sd["model.embed_tokens.weight"] = embed[:QWEN25_VOCAB]
        with _step(f"import_qwen2 resize {QWEN25_VOCAB} -> {seed.cfg.llm.vocab_size} rows", rec):
            grown = import_qwen2(sd, seed.cfg.llm, device="cuda")["embed"]
        mean = embed[:QWEN25_VOCAB].float().mean(0)
        step = torch.exp2(torch.floor(torch.log2(mean.abs().clamp_min(2.0 ** -126))) - 7)
        err = (grown[QWEN25_VOCAB:].float() - mean).abs()
        check(tuple(grown.shape) == tuple(embed.shape) and
              torch.equal(grown[:QWEN25_VOCAB], embed[:QWEN25_VOCAB]) and
              bool((err <= step).all()) and
              bool((grown[QWEN25_VOCAB:] == grown[QWEN25_VOCAB]).all()),
              "the resized embedding's new rows are not the mean row within one bf16 step")
        print(f"  resize: rows {QWEN25_VOCAB}..{grown.shape[0] - 1} the mean row, max |err| "
              f"{err.max().item():.3e} (within one bf16 step of the card's fp32 mean)")
        del grown, sd

        # a Qwen2 tokenizer directory, read without transformers
        texts = list(PROMPTS) + list(QUESTIONS)
        tok_dir = os.path.join(tmp, "tok", conf["model"]["unigen"]["llm_model_path"])
        t0 = time.perf_counter()
        n_merges = write_qwen_tokenizer(tok_dir, texts + tokenizer_corpus(TOK_TRAIN_TEXTS, 0))
        train_s = time.perf_counter() - t0
        tconf = ckpt_config(os.path.join(tmp, "tok"), "")
        t0 = time.perf_counter()
        tok = launch.load_tokenizer(tconf)
        load_s = time.perf_counter() - t0
        check(isinstance(tok, QwenTokenizer) and "transformers" not in sys.modules,
              f"load_tokenizer gave {type(tok).__name__}")
        import importlib.util
        print("  this machine has " + ", ".join(
            f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
            for m in ("transformers", "tokenizers", "regex", "safetensors", "yaml", "PIL",
                      "pyarrow")))
        chat = [f"<|im_start|>user\n{q}<|im_end|>\n<|im_start|>assistant\n" for q in QUESTIONS]
        for t in texts + chat:
            ids = tok(t)["input_ids"]
            check(tok.decode(ids) == t, f"tokenizer round trip of {t!r}")
        check(tok.decode(tok(chat[0])["input_ids"], skip_special_tokens=True) ==
              f"user\n{QUESTIONS[0]}\nassistant\n", "skip_special_tokens")
        # encode rates of a fresh reader (its word cache empty): over distinct
        # texts whose words repeat by Zipf's law, and over the distinct words
        # of those texts, each once, so that every word is a cache miss
        rates = {}
        held_out = tokenizer_corpus(TOK_RATE_TEXTS, 1)
        unseen = list(dict.fromkeys(w for t in held_out for w in t.split()))
        unseen = [" ".join(unseen[i:i + 24]) for i in range(0, len(unseen), 24)]
        for kind, batch in (("zipf", held_out), ("all_miss", unseen)):
            fresh = QwenTokenizer.from_pretrained(tok_dir)
            t0 = time.perf_counter()
            ids = fresh(batch)["input_ids"]
            enc_s = time.perf_counter() - t0
            n_tok = sum(map(len, ids))
            rates[kind] = dict(tokens_per_s=n_tok / enc_s, texts=len(batch), tokens=n_tok,
                               seconds=enc_s, bytes=sum(len(t.encode()) for t in batch),
                               cached_words=len(fresh._cache))
            check(all(fresh.decode(i) == t for i, t in zip(ids, batch)),
                  f"tokenizer round trip of the {kind} texts")
        pro = launch.build_prompting_from_config(tconf, tok)
        check(len(tok) == tok.vocab_size + len(QWEN25_ADDED) + 9 and pro.pad_id ==
              tok.vocab_size and pro.sptids_dict["<|soi|>"] == tok.vocab_size + len(QWEN25_ADDED),
              "the prompting's ids over the tokenizer directory")
        print(f"  tokenizer: {n_merges} merges (trained in {train_s:.2f} s over "
              f"{len(texts) + TOK_TRAIN_TEXTS} texts) + 256 bytes + {len(QWEN25_ADDED)} added, "
              f"len {len(tok)} with the 9 task tokens, read in {load_s * 1e3:.1f} ms; "
              f"{len(texts) + len(chat)} phase texts and every timed text round-trip")
        for kind, r in rates.items():
            print(f"  encode, a fresh reader, {kind}: {r['tokens_per_s']:.0f} tokens/s "
                  f"({r['texts']} distinct texts, {r['bytes']} bytes, {r['tokens']} tokens, "
                  f"{r['seconds']:.3f} s, {r['cached_words']} words cached at the end)")
        results["checkpoints"] = {"steps": rec, "builders_s": times, "sizes_bytes": sizes,
                                  "tokenizer_merges": n_merges, "encode": rates,
                                  "t2i_s": {k: v["t2i_s"] for k, v in outs.items()},
                                  "understand_s": {k: v["understand_s"] for k, v in outs.items()}}
        return {"checkpoints_t2i": outs["reference"]["t2i_counts"],
                "checkpoints_understand": outs["reference"]["understand_counts"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the parallel slice: 2 ranks on the one card
# ---------------------------------------------------------------------------

# Two ranks share the one card under gloo (NCCL refuses two ranks on one
# device), joined by a TCP store on localhost. The tiny fp32 meshes (data,
# fsdp, model) of the PT2 step; the flagship t2i at model 2; the optional
# parallel_train meshes of the flagship PT2 step.
PARALLEL_RANKS = 2
PARALLEL_TINY_MESHES = ((1, 1, 2), (2, 1, 1), (1, 2, 1))
PARALLEL_TINY_RTOL = 1e-5
PARALLEL_T2I_SEED = 21
PARALLEL_T2I_STEPS = 10      # the flagship t2i's steps at model 2 (the flagship phase's 50, cut)
PARALLEL_TRAIN_MESHES = ((1, 1, 2), (1, 2, 1))
PARALLEL_TRAIN_WARM, PARALLEL_TRAIN_TIMED = 1, 2
# the optional parallel_serving phase: the serving phase's trace, its first
# requests (the budgets as they are)
PARALLEL_SERVE_REQUESTS = 48
GLOO_NOTE = "gloo on one card, not a multi-card speed"


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_entry(rank, world, port, program, out_dir):
    """One rank: joins the gloo world on cuda:0, runs ``program(rank)`` and
    writes its JSON result; a failure writes the traceback and exits
    nonzero, which stops the other rank."""
    import os
    import traceback
    import torch
    from unigen_tpu_torch.parallel import initialize_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"localhost:{port}", world, rank, device_type="cuda",
                           backend="gloo")
    try:
        out = globals()[program](rank)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def spawn_ranks(program: str):
    """Each rank's result of ``program``: PARALLEL_RANKS processes started
    with ``spawn``, their output kept off stdout's last lines (they end
    before the parent prints anything more)."""
    import os
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        try:
            mp.start_processes(_rank_entry, args=(PARALLEL_RANKS, _free_port(), program, out_dir),
                               nprocs=PARALLEL_RANKS, start_method="spawn")
        except Exception as e:
            errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                      if f.endswith(".error")]
            raise Failed(f"{program}: a rank failed ({e})\n" + "\n".join(errors))
        return [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                for r in range(PARALLEL_RANKS)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _tiny_train_inputs(pipe, device):
    """run_tiny_train's batch (2 t2i + 2 lm + 2 mmu rows of 28) and draws."""
    import numpy as np
    import torch
    from unigen_tpu_torch.ops import masking as MK
    from unigen_tpu_torch.training import train_step as TS
    sp = pipe.prompting.sptids_dict
    n, seq, b = pipe.cfg.num_vq_tokens, 28, 2
    rng = np.random.default_rng(0)
    t2i = rng.integers(3, 100, size=(b, seq))
    t2i[:, -n - 2], t2i[:, -1], t2i[:, -n - 1:-1] = sp["<|soi|>"], sp["<|eoi|>"], 0
    t2i[0, :3] = pipe.prompting.pad_id
    mmu = rng.integers(3, 100, size=(b, seq))
    mmu[:, 2], mmu[:, 3 + n], mmu[:, 3:3 + n] = sp["<|soi|>"], sp["<|eoi|>"], 0
    mmu_labels = np.where(rng.random((b, seq)) < 0.5, rng.integers(3, 100, (b, seq)), -100)
    mmu_labels[:, :4 + n] = -100
    lm = rng.integers(3, 100, size=(b, seq))
    res = pipe.vq_cfg.resolution
    host = {"t2i_template": t2i, "t2i_labels": np.full((b, seq), -100),
            "t2i_pixels": rng.normal(size=(b, res, res, 3)).astype(np.float32),
            "lm_ids": lm, "lm_labels": lm.copy(), "mmu_template": mmu, "mmu_labels": mmu_labels,
            "mmu_pixels": rng.normal(size=(b, res, res, 3)).astype(np.float32)}
    draws = MK.draw_masking(torch.Generator().manual_seed(0), b, n,
                            codebook_size=pipe.cfg.codebook_size)
    tcfg = TS.TrainStepConfig(b, b, b, max_grad_norm=1.0, pad_id=pipe.prompting.pad_id,
                              soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])
    return ({k: torch.as_tensor(v, device=device) for k, v in host.items()},
            MK.MaskDraws(*(None if x is None else x.to(device) for x in draws)), tcfg)


def _adam_allowance(g, norm, tx, rtol):
    """The most by which AdamW's first update of a leaf can move, element by
    element, when its gradient ``g`` and the grad norm ``norm`` are each
    off by at most ``rtol`` (of the leaf's largest gradient, and of the
    norm): the clip scales both by c = min(1, max_grad_norm / norm), and
    the first update lr g / (|g| + eps), of slope lr eps / (|g| + eps)^2,
    moves by at most the slope's largest value within the error times the
    error, and never by more than 2 lr."""
    import torch
    c = min(1.0, tx.max_grad_norm / norm) if tx.max_grad_norm else 1.0
    a = c * g.abs()
    err = c * rtol * (g.abs().max() + g.abs())
    eps = tx.epsilon
    slope = eps / (torch.clamp(a - err, min=0) + eps) ** 2
    return tx.learning_rate * torch.clamp(err * slope, max=2.0)


def _parallel_tiny(rank):
    """The tiny fp32 PT2 step on each mesh against the one-rank step on the
    same batch and draws (``_mesh_steps``), and the step of a tree with
    LoRA adapters (the adapters alone trained) at (1, 1, 2); the tiny t2i at
    model 2 against one rank's tokens, float, W8A8 (its image head split
    over the codes) and W4A8 (group 64: the rank's o cuts a group, repacked
    at 32), the W4A8 tree by its first forward (``_quant_first_forward``)."""
    import dataclasses
    import torch
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    from unigen_tpu_torch.ops.quantization import quantize_unigen_params
    from unigen_tpu_torch.training import lr_schedules as LRS
    from unigen_tpu_torch.training import train_step as TS
    from unigen_tpu_torch.training.lora import add_lora, lora_tunable_parts
    from unigen_tpu_torch.training.optimizer import make_optimizer
    pipe = build_pipeline("tiny", dtype=torch.float32, device="cuda", seed=3)
    batch, draws, tcfg = _tiny_train_inputs(pipe, "cuda")
    tx = make_optimizer(pipe.params, 1e-3, LRS.get_scheduler("constant"), max_grad_norm=1.0)
    step = TS.make_train_step(pipe.cfg, pipe.vq_cfg, tx, tcfg)
    out = _mesh_steps(pipe, pipe.params, tx, step, batch, draws, PARALLEL_TINY_MESHES)
    gen = torch.Generator(device="cuda").manual_seed(5)
    llm = add_lora(pipe.params["llm"], gen, 4, dtype=torch.float32)
    for lp in llm["layers"]:
        for key in [key for key in lp if key.endswith("_lora_b")]:
            lp[key] = torch.randn(lp[key].shape, generator=gen, device="cuda") * 0.05
    lora = dict(pipe.params, llm=llm)
    tx_l = make_optimizer(lora, 1e-3, LRS.get_scheduler("constant"), max_grad_norm=1.0,
                          tunable_parts=list(lora_tunable_parts()))
    out["lora"] = _mesh_steps(pipe, lora, tx_l, TS.make_train_step(pipe.cfg, pipe.vq_cfg, tx_l,
                                                                   tcfg),
                              batch, draws, ((1, 1, 2),))["1x1x2"]
    mesh = P.make_mesh(1, 1, 2, device_type="cuda")

    def tokens(p):
        gen = torch.Generator(device="cuda").manual_seed(PARALLEL_T2I_SEED)
        return p.generate_images(list(PROMPTS[:2]), gen, guidance_scale=6.0, timesteps=8,
                                 return_codes=True).tolist()
    out["t2i_equal"] = tokens(pipe.shard(mesh)) == tokens(pipe)
    w8 = dataclasses.replace(pipe, params=quantize_unigen_params(pipe.params, pipe.cfg,
                                                                 lm_head=True))
    out["t2i_w8a8_equal"] = tokens(w8.shard(mesh)) == tokens(w8)
    w4 = dataclasses.replace(pipe, params=quantize_unigen_params_int4(pipe.params, pipe.cfg,
                                                                      group=64))
    w4_tp = w4.shard(mesh)
    out["w4a8_groups"] = w4_tp.sharding.groups
    out["t2i_w4a8"] = _quant_first_forward(w4, w4_tp)
    toks, toks_tp = tokens(w4), tokens(w4_tp)
    out["t2i_w4a8"]["codes_agree"] = sum(a == b for r, q in zip(toks, toks_tp)
                                         for a, b in zip(r, q)) / sum(map(len, toks))
    return out


def _first_image_logits(pipe, prompts):
    """The t2i call's first image logits of ``prompts`` as a function of the
    params and their spec tree (None: whole): a cache-free forward of the
    prompts and their unconditional rows (text budget 128), CFG 6 on the
    hidden states, fp32."""
    import numpy as np
    import torch
    from unigen_tpu_torch.generation import t2i as T2I
    from unigen_tpu_torch.models import unigen
    from unigen_tpu_torch.ops import masks as M
    cfg, n = pipe.cfg, pipe.cfg.num_vq_tokens
    sp = pipe.prompting.sptids_dict
    ids, uncond = pipe.prompt_ids(list(prompts), 128)
    x = torch.as_tensor(np.concatenate([ids, uncond]), device="cuda")
    bits = M.pack_meta(M.t2i_attn_meta(x, pipe.prompting.pad_id, sp["<|soi|>"], sp["<|eoi|>"]))

    @torch.no_grad()
    def logits(params, specs=None):
        h = unigen.forward(params, cfg, input_ids=x, meta_bits=bits, return_hidden=True,
                           specs=specs)
        return T2I._cfg_head_logits(params, cfg, h[:, -(n + 1):-1], len(prompts), True, 6.0,
                                    "hidden", specs).float()
    return logits


def _quant_first_forward(pipe, tp):
    """The relative difference of the first image logits of 2 prompts at
    model 2 from one rank's, and their argmax agreement."""
    logits = _first_image_logits(pipe, PROMPTS[:2])
    a, b = logits(tp.params, tp.specs), logits(pipe.params)
    return {"rel": ((a - b).abs().max() / b.abs().max()).item(),
            "argmax": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}


def _mesh_steps(pipe, params, tx, step, batch, draws, meshes):
    """The tiny fp32 PT2 step of ``params`` on each mesh against the
    one-rank step on the same batch and draws: the losses and grad norm
    (relative errors); each trained leaf's gathered gradient before the
    update (its largest difference over its largest gradient; a frozen
    scalar such as a LoRA scale sums its gradient with cancellation, which
    no update reads); each parameter element
    after the update, within 1e-5 of its leaf's largest magnitude plus what
    AdamW's first step makes of the gradient tolerance there
    (``_adam_allowance``; the leaves where that allowance is the larger are
    listed); the leaves the update moved."""
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.parallel.partition import gather_full
    from unigen_tpu_torch.training import train_step as TS
    from unigen_tpu_torch.training.optimizer import global_norm, named_leaves
    paths = [p for p, _ in named_leaves(params)]
    whole = TS.init_train_state(params, tx)
    g_whole, wm = step.grads(whole, pipe.vq_params, batch, draws)
    norm = float(global_norm(g_whole))
    allow = {p: _adam_allowance(g, norm, tx, PARALLEL_TINY_RTOL) for p, g in zip(paths, g_whole)}
    whole, wm = step.apply(whole, g_whole, wm)
    before = dict(named_leaves(params))
    out = {}
    for d, f, m in meshes:
        mesh = P.make_mesh(d, f, m, device_type="cuda")
        local, sh = P.shard_params(params, P.unigen_specs(params, pipe.cfg, mesh, fsdp=f > 1),
                                   mesh)
        state = TS.init_train_state(local, tx, sharding=sh)
        g_local, sm = step.grads(state, pipe.vq_params, batch, draws)
        grad_err = {}
        for p, g, spec, gw, train in zip(paths, g_local, sh.spec_list(state.params), g_whole,
                                         tx.trainable):
            if not train:
                continue
            full = gather_full(g, spec, mesh)
            grad_err[p] = ((full - gw).abs().max() / gw.abs().max().clamp(min=1e-30)).item()
        state, sm = step.apply(state, g_local, sm)
        got = dict(named_leaves(P.gather_params(state.params, sh)))
        param_err, loosened = {}, {}
        for p, t in named_leaves(whole.params):
            base = PARALLEL_TINY_RTOL * t.abs().max()
            diff = (got[p] - t).abs()
            param_err[p] = (diff / (base + allow[p])).max().item()
            n_loose = int((allow[p] > base).sum())
            if n_loose:
                loosened[p] = n_loose
        out[f"{d}x{f}x{m}"] = {
            "rel": {k: abs(float(sm[k]) - float(wm[k])) / max(abs(float(wm[k])), 1e-30)
                    for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")},
            "grad_err": max(grad_err.values()), "worst_grad": max(grad_err, key=grad_err.get),
            "param_err": max(param_err.values()), "worst_param": max(param_err, key=param_err.get),
            "loosened": loosened,
            "local_q_rows": int(state.params["llm"]["layers"][0]["q_w"].shape[0]),
            "moved": sorted(p for p, t in got.items() if not bool((t == before[p]).all()))}
    return out


def _parallel_flagship(rank):
    """The flagship t2i at model 2, as the flagship phase runs it but for
    its depth (batch 4, guidance 6, PARALLEL_T2I_STEPS steps, text budget
    128, generator seed 0, codes -> 256 px): the first step's image logits
    against the unsharded forward, the exact launches a rank, the call's
    seconds and its collectives' share, and (rank 0) the share of its codes
    equal to one rank's call."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.parallel import collectives as C
    pipe = flagship_pipeline()
    mesh = P.make_mesh(1, 1, PARALLEL_RANKS, device_type="cuda")
    tp = pipe.shard(mesh)
    first_step_logits = _first_image_logits(pipe, PROMPTS)
    a, b = first_step_logits(tp.params, tp.specs), first_step_logits(pipe.params)
    cos = F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
    argmax = (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    _t2i_run(tp, timesteps=1)()                               # warm: every call once
    torch.cuda.synchronize()
    _reset_counts()
    with C.timing() as coll:
        t0 = time.perf_counter()
        codes, pixels = _t2i_run(tp, timesteps=PARALLEL_T2I_STEPS)()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = _read_counts()
    out = {"cos": cos, "argmax": argmax, "counts": counts, "seconds": seconds,
           "collective_s": coll["seconds"], "collectives": coll["calls"],
           "pixels_shape": list(pixels.shape), "finite": bool(torch.isfinite(pixels).all()),
           "local_heads": int(tp.params["llm"]["layers"][0]["q_w"].shape[0]) // 128,
           "kv_rows": int(tp.params["llm"]["layers"][0]["k_w"].shape[0])}
    if rank == 0:
        one, _ = _t2i_run(pipe, timesteps=PARALLEL_T2I_STEPS)()
        out["codes_agree"] = (codes == one).float().mean().item()
    return out


def _parallel_serving_tiny(rank):
    """The tiny fp32 serving engine at model 2 (rank 0 decides, rank 1
    follows its plan) against one rank's engine on the same requests: three
    greedy text prompts, a sampled one and an embeddings prompt, speculation
    on; then int8+kv and int8+int4 on the text requests; this rank's tokens
    (a follower's from ``followed``), decode chunks, busy steps and cache
    KV heads."""
    import numpy as np
    import torch
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.models.unigen import embed_tokens
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    from unigen_tpu_torch.ops.quantization import quantize_unigen_params
    from unigen_tpu_torch.serving import ServingEngine
    pipe = build_pipeline("tiny", dtype=torch.float32, device="cuda", seed=3)
    cfg = pipe.cfg
    rng = np.random.default_rng(PARALLEL_T2I_SEED)
    prompts = [rng.integers(3, cfg.text_vocab_len - 1, size=(n,)).tolist() for n in (5, 11, 8)]
    emb = embed_tokens(pipe.params, torch.tensor([prompts[1] + [0] * 5], device="cuda"))
    pad = torch.arange(16, device="cuda")[None] >= 11
    z = torch.zeros_like(pad)
    bits = M.pack_meta(M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z))
    kw = dict(slots=2, max_len=48, buckets=(16,), chunk=(2, 4), speculate_k=2, device="cuda",
              keep_followed=True)

    def serve(params, follow, embeds=True, **extra):
        with ServingEngine(params, cfg, **dict(kw, **extra)) as eng:
            if follow:
                eng.close(timeout=None)
                toks = [f.result(0) for _, f in sorted(eng.followed.items())]
            else:
                futs = [eng.submit(p, max_new_tokens=8) for p in prompts]
                futs.append(eng.submit(prompts[0], max_new_tokens=6, temperature=0.9, seed=5))
                if embeds:
                    futs.append(eng.submit_embeds(emb, bits, 11, max_new_tokens=7,
                                                  lookup_ids=prompts[1]))
                toks = [f.result(120) for f in futs]
            return toks, eng.stats.decode_chunks, eng.stats.busy_steps, eng._cache.k.shape[3]
    whole = serve(pipe.params, False)
    mesh = P.make_mesh(1, 1, PARALLEL_RANKS, device_type="cuda")
    tp = pipe.shard(mesh)
    toks, chunks, busy, _ = serve(tp.params, rank != 0, sharding=tp.sharding)
    out = {"equal": toks == whole[0], "toks": toks, "chunks": chunks, "busy": busy,
           "one_rank_chunks": whole[1]}
    # int8+kv (W8A8, the int8 cache) and int8+int4 (W8A8 admission, W4A8 decode
    # chunks, group 32), speculation off, on the text requests
    w8 = quantize_unigen_params(pipe.params, cfg, lm_head=True)
    w4 = quantize_unigen_params_int4(pipe.params, cfg, group=32)
    l8, sh8 = P.shard_params(w8, P.unigen_specs(w8, cfg, mesh), mesh)
    l4, sh4 = P.shard_params(w4, P.unigen_specs(w4, cfg, mesh), mesh)
    for mode, (one, tp) in (("int8+kv", (dict(quantized_cache=True),) * 2),
                            ("int8+int4", (dict(decode_params=w4),
                                           dict(decode_params=l4, decode_sharding=sh4)))):
        w_toks, w_chunks, _, w_heads = serve(w8, False, False, speculate_k=0, **one)
        toks, chunks, busy, heads = serve(l8, rank != 0, False, speculate_k=0, sharding=sh8,
                                          **tp)
        out[mode] = {"equal": toks == w_toks, "toks": toks, "chunks": chunks, "busy": busy,
                     "one_rank_chunks": w_chunks, "heads": heads, "one_rank_heads": w_heads}
    return out


def _parallel_rank(rank):
    out = {}
    for name, program in (("tiny", _parallel_tiny), ("serving_tiny", _parallel_serving_tiny),
                          ("flagship", _parallel_flagship)):
        t0 = time.perf_counter()
        out[name] = program(rank)
        out[name + "_s"] = time.perf_counter() - t0
    return out


def run_parallel_kernel_phases(results):
    """Kernels 1 and 2 at a model rank's shapes under tensor parallelism at
    model 2: 6 query heads over 1 KV head (the flagship's 12 over 2): the
    t2i step and prefill, the train step's attention, and the serving
    engine's decode step (32 slots against the 896-slot cache, each row at
    its own key count) and batched admission (16 rows of 640, pad bits)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2020)
    bf16 = torch.bfloat16
    print("phase: kernels at a model rank's shapes (model 2: 6 query heads over 1 KV head)")
    ages = torch.randint(SERVE_PROMPT, SERVE_PROMPT + 224, (SERVE_SLOTS,), generator=gen,
                         device="cuda").tolist()
    pad = (torch.arange(SERVE_BUCKET, device="cuda")[None].expand(SERVE_ADMIT, SERVE_BUCKET)
           >= SERVE_PROMPT)
    z = torch.zeros_like(pad)
    rows = [("chunk_attention", phase_chunk(gen, 8, 258, 148, bf16, 2 ** -7, 10, True,
                                            at="t2i step, a rank at model 2", heads=(6, 1))),
            ("flash_attention", phase_flash(gen, 8, 148, bf16, 2 ** -7, 10, True, heads=(6, 1),
                                            at="t2i prefill, a rank at model 2")),
            ("flash_attention_train", phase_flash_grad(
                gen, train_bits(train_config()), 5, "train step, a rank at model 2",
                heads=(6, 1))),
            ("chunk_attention", phase_chunk_decode(
                gen, SERVE_SLOTS, SERVE_MAX_LEN, [a + 1 for a in ages], -1, bf16, 2 ** -7, 50,
                new_tokens=0, heads=(6, 1),
                at="serving decode step, a rank at model 2 (per-row key counts)")),
            ("flash_attention", phase_flash_meta(
                gen, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z), bf16, 2 ** -7, 10,
                f"serving admission, a rank at model 2: q [{SERVE_ADMIT},{SERVE_BUCKET},6,128], "
                "pad bits", heads=(6, 1)))]
    for name, row in rows:
        results.setdefault(name, {}).setdefault("shapes", []).append(row)


# the understand prefill's rows at the flagship: 8 questions x 787
# (``understand_prompt_shape``), a rank's rows at model 2 as on one card
UNDERSTAND_ROWS = 6296
# (label, K, N, group, bias, row parallel) of a W4A8 layer on a model-2 rank
# of the flagship: column q/k/v and gate/up on their output halves, row o
# (768 = 3 groups of 256) and down (4,480: 17.5 groups of 256, repacked at 128)
RANK_W4A8 = (("gate/up", 1536, 4480, 256, False, False), ("q", 1536, 768, 256, True, False),
             ("k/v", 1536, 128, 256, True, False), ("o", 768, 1536, 256, False, True),
             ("down", 4480, 1536, 128, False, True))


def phase_quant_rank(gen, t, k, dtype, iters, timed, label=""):
    """A row-parallel layer's quantization on a model-2 rank: x [t, k] is
    one half of a row of 2k values (normal * 3, the other half * 5, so
    that either holds the row's absmax). The absmax pass (``row_absmax``)
    and the quantization with the global absmax (``quantize_activations(x,
    amax)``) must equal their plain versions bit for bit, and the slice's
    int8 values and scales must equal those of the whole row's
    quantization. Timed: the two launches against their plain versions and
    the bytes they must move."""
    import torch
    from unigen_tpu_torch.ops.quantization import (quantize_activations,
                                                   quantize_activations_plain, row_absmax,
                                                   row_absmax_plain)
    x = torch.randn((t, k), generator=gen, device="cuda") * 3
    other = torch.randn((t, k), generator=gen, device="cuda") * 5
    x, other = x.to(dtype), other.to(dtype)
    whole = torch.cat([x, other], -1)
    amax = torch.maximum(row_absmax(x), row_absmax_plain(other))       # the MAX over the ranks
    check(bool(torch.equal(row_absmax(x), row_absmax_plain(x))),
          f"row_absmax {label} [{t},{k}] {dtype} differs from its plain version")
    q, s = quantize_activations(x, amax)
    qr, sr = quantize_activations_plain(x, amax)
    qw, sw = quantize_activations_plain(whole)
    torch.cuda.synchronize()
    check(bool(torch.equal(q, qr)) and bool(torch.equal(s, sr)),
          f"quantize_activations(x, amax) {label} [{t},{k}] {dtype} differs from its plain version")
    check(bool(torch.equal(q, qw[:, :k])) and bool(torch.equal(s, sw)),
          f"quantize_activations(x, amax) {label}: the slice's values are not the whole row's")
    print(f"  quantization of a rank's slice {label} [{t},{k}] of [{t},{2 * k}] {dtype}: the "
          "absmax pass and the quantization with the global absmax equal their plain versions "
          "and the whole row's values bit for bit")
    if not timed:
        return None

    def pair():
        return quantize_activations(x, row_absmax(x))
    ms = time_ms(pair, iters)
    plain_ms = time_ms(lambda: quantize_activations_plain(x, row_absmax_plain(x)), iters)
    b_ms, by = bound(0.0, nbytes(x, q, s, amax), INT8_PEAK)
    print(f"    the two launches ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms none  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(0.0, ms, plain_ms, None, b_ms, by,
                     f"{label} x [{t},{k}] {dtype}, absmax pass + quantization (model 2)")


def phase_row_epilogue(gen, t, n, npad, iters, timed, label=""):
    """The epilogue of a row-parallel W4A8 layer (``w8a8_epilogue`` on kernel
    4's fp32 partials summed over the ranks, no weight scale): [t, n] of
    [t, npad] against its plain version bit for bit, bf16 and fp32 out, with
    an fp32 zero bias (the layers without one) and a bf16 bias."""
    import torch
    from unigen_tpu_torch.ops.quantization import w8a8_epilogue, w8a8_epilogue_plain
    acc = torch.randn((t, npad), generator=gen, device="cuda") * 40
    act = torch.rand((t,), generator=gen, device="cuda") * 0.05
    biases = (torch.zeros((n,), device="cuda"),
              (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16))
    for bias in biases:
        for out_dtype in (torch.bfloat16, torch.float32):
            got = w8a8_epilogue(acc, act, None, bias, out_dtype)
            check(bool(torch.equal(got, w8a8_epilogue_plain(acc, act, None, bias, out_dtype))),
                  f"the W4A8 row epilogue {label} [{t},{n}] {out_dtype} differs from its plain "
                  "version")
    print(f"  the W4A8 row epilogue {label} [{t},{n}] of [{t},{npad}] fp32 partials: bf16 and "
          "fp32 out, fp32 and bf16 bias, equal to its plain version bit for bit")
    if not timed:
        return None
    bias = biases[0]
    ms = time_ms(lambda: w8a8_epilogue(acc, act, None, bias, torch.bfloat16), iters)
    plain_ms = time_ms(lambda: w8a8_epilogue_plain(acc, act, None, bias, torch.bfloat16), iters)
    b_ms, by = bound(0.0, nbytes(acc[:, :n], act, bias) + t * n * 2, INT8_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms none  bound_ms {b_ms:.4f} ({by})")
    return _measured(0.0, ms, plain_ms, None, b_ms, by,
                     f"{label} [{t},{n}] of fp32 [{t},{npad}] (W4A8 row, model 2)")


def run_parallel_quant_kernel_phases(results):
    """Kernel 4, the quantization kernel and the W8A8 epilogue at a model-2
    rank's shapes (module docstring; ``RANK_W4A8``): kernel 4 at the
    serving decode's 32 rows, the k-4 verify's 160 and the understand
    prefill's 6,296, on the route each layer runs (a column layer's fused
    dense launch, a row layer's fp32 product), the quantization of a row
    layer's slice with the global absmax at [T, 768] and [T, 4480], the
    W4A8 row epilogue, and the W8A8 layer at the t2i step's 2,064 rows; all
    bit for bit against their plain versions. Timed: the decode's gate/up
    and down, the [32, 4480] and [6296, 4480] quantizations, the W4A8 row
    epilogue at 32 rows and the t2i step's W8A8 gate/up and down."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2022)
    bf16 = torch.bfloat16
    print("phase: kernel 4, the quantization kernel and the W8A8 epilogue at a model rank's "
          "shapes (model 2)")
    rows = {"w4a8_matmul": [], "quantize_activations": [], "w8a8_epilogue": []}
    for t, at in ((SERVE_SLOTS, "serving decode"), (SERVE_SLOTS * (SPEC_K + 1), "k-4 verify"),
                  (UNDERSTAND_ROWS, "understand prefill")):
        for label, k, n, group, bias, row in RANK_W4A8:
            timed = t == SERVE_SLOTS and label in ("gate/up", "down")
            r = phase_w4a8(gen, t, k, n, group, 50 if timed else 0, timed,
                           f"{at} {label} ({'row' if row else 'column'}), a rank at model 2",
                           bias=bias)
            if r is not None:
                rows["w4a8_matmul"].append(r)
        for k in (768, 4480):
            r = phase_quant_rank(gen, t, k, bf16, 50, k == 4480 and t != SERVE_SLOTS * 5,
                                 f"{at}, a rank's row slice")
            if r is not None:
                rows["quantize_activations"].append(r)
        r = phase_row_epilogue(gen, t, 1536, 1536, 50, t == SERVE_SLOTS, f"{at} o/down")
        if r is not None:
            rows["w8a8_epilogue"].append(r)
    t_step = 8 * 258
    for label, k, n, _, bias, _ in RANK_W4A8:
        timed = label in ("gate/up", "down")
        r = phase_w8a8(gen, t_step, k, n, 20 if timed else 0, timed,
                       f"t2i step {label}, a rank at model 2", bf16 if bias else None)
        if r is not None:
            rows["w8a8_epilogue"].append(r)
    for name, shapes in rows.items():
        results.setdefault(name, {}).setdefault("shapes", []).extend(shapes)


def run_parallel(results):
    """The parallel phase (module docstring): kernels at a rank's shapes,
    then 2 ranks on the card: the tiny meshes against one rank, the
    flagship t2i at model 2. Returns rank 0's launches of the t2i call."""
    t0 = time.perf_counter()
    import torch
    run_parallel_kernel_phases(results)
    run_parallel_quant_kernel_phases(results)
    t_kernels = time.perf_counter() - t0
    print(f"phase: parallel, {PARALLEL_RANKS} ranks on the one card under gloo over a TCP store "
          "on localhost (NCCL refuses two ranks on one device)")
    ranks = spawn_ranks("_parallel_rank")
    tiny = ranks[0]["tiny"]
    steps = [(f"{d}x{f}x{m}", tiny[f"{d}x{f}x{m}"]) for d, f, m in PARALLEL_TINY_MESHES]
    for mesh_name, r in steps + [("1x1x2 with LoRA adapters", tiny["lora"])]:
        print(f"  tiny fp32 PT2 step on mesh (data, fsdp, model) = {mesh_name}: relative "
              f"differences to one rank {r['rel']}; gathered gradients before the update: the "
              f"largest leaf difference {r['grad_err']:.3e} of the leaf's largest gradient "
              f"({r['worst_grad']}); parameters after it: the largest element difference "
              f"{r['param_err']:.3e} of its bound ({r['worst_param']}; the bound is "
              f"{PARALLEL_TINY_RTOL:g} of the leaf's largest magnitude plus AdamW's first step "
              f"on a gradient off by {PARALLEL_TINY_RTOL:g}, the larger term for "
              f"{sum(r['loosened'].values())} elements: {r['loosened']}); local q rows "
              f"{r['local_q_rows']}")
        check(all(v <= PARALLEL_TINY_RTOL for v in r["rel"].values())
              and r["grad_err"] <= PARALLEL_TINY_RTOL and r["param_err"] <= 1.0,
              f"the tiny sharded step on {mesh_name} differs from one rank's: {r}")
    moved = tiny["lora"]["moved"]
    print(f"  the LoRA step moved {len(moved)} leaves, all adapters")
    check(bool(moved) and all(p.endswith(("_lora_a", "_lora_b")) for p in moved),
          f"the tiny LoRA step at model 2 moved {moved}")
    for rank, r in enumerate(ranks):
        t = r["tiny"]
        check(t["t2i_equal"], f"rank {rank}: the tiny t2i at model 2 changed tokens")
        check(t["t2i_w8a8_equal"], f"rank {rank}: the tiny W8A8 t2i at model 2 changed tokens")
        check(t["t2i_w4a8"]["rel"] <= PARALLEL_TINY_RTOL and t["t2i_w4a8"]["argmax"] == 1.0
              and t["w4a8_groups"], f"rank {rank}: the tiny W4A8 t2i at model 2: {t['t2i_w4a8']}, "
              f"repacked {t['w4a8_groups']}")
    w4 = tiny["t2i_w4a8"]
    print(f"  tiny t2i at model 2: every rank's tokens equal one rank's, float and W8A8 (the int8 "
          f"image head split over the codes); W4A8 (group 64, repacked at 32 where a rank cuts "
          f"a group: {tiny['w4a8_groups']}): first image logits {w4['rel']:.3e} of their "
          f"largest from one rank's, argmax agreement {w4['argmax']:.4f}, codes agree "
          f"{w4['codes_agree']:.4f} (not a gate: kernel 4's partials fold in another order)")
    st = [r["serving_tiny"] for r in ranks]
    for rank, r in enumerate(st):
        check(r["equal"], f"rank {rank}: the tiny serving engine at model 2 changed tokens")
        check((r["toks"], r["chunks"], r["busy"]) == (st[0]["toks"], st[0]["chunks"],
                                                      st[0]["busy"]),
              f"rank {rank}'s serving engine diverged from rank 0's: {r} against {st[0]}")
    print(f"  tiny serving engine at model 2 (rank 0's plan, rank 1 following; greedy, sampled "
          f"and embeddings requests, speculation on): every rank's tokens equal one rank's "
          f"engine; {st[0]['chunks']} decode chunks and {st[0]['busy']} busy steps on each rank "
          f"({st[0]['one_rank_chunks']} chunks on one rank)")
    for mode in ("int8+kv", "int8+int4"):
        sq = [r[mode] for r in st]
        for rank, r in enumerate(sq):
            check(r["equal"] and r["heads"] == 1 and r["one_rank_heads"] == 2,
                  f"rank {rank}: the tiny {mode} engine at model 2 changed tokens or cache "
                  f"heads: {r}")
            check((r["toks"], r["chunks"], r["busy"]) == (sq[0]["toks"], sq[0]["chunks"],
                                                          sq[0]["busy"]),
                  f"rank {rank}'s {mode} engine diverged from rank 0's")
        print(f"  tiny {mode} engine at model 2 (greedy and sampled requests): every rank's "
              f"tokens equal one rank's engine, {sq[0]['chunks']} decode chunks and "
              f"{sq[0]['busy']} busy steps on each rank, a cache of 1 KV head a rank (2 on one)")
    want = dict(NO_LAUNCHES, flash_attention=28, chunk_attention=28 * PARALLEL_T2I_STEPS,
                conv3x3_gn_swish=44, gn_affine=40)
    for rank, r in enumerate(ranks):
        f = r["flagship"]
        print(f"  flagship t2i at model 2, rank {rank}: {f['local_heads']} query heads and "
              f"{f['kv_rows'] // 128} KV head a rank; first step's image logits against the "
              f"unsharded forward: cosine {f['cos']:.6f}, argmax agreement {f['argmax']:.4f}; "
              f"launches {f['counts']}; {f['seconds']:.3f} s a call, of which collectives "
              f"{f['collective_s']:.3f} s ({f['collective_s'] / f['seconds']:.4f}, "
              f"{f['collectives']} calls; {GLOO_NOTE})")
        check(f["cos"] >= 0.999, f"rank {rank}: first-step logits cosine {f['cos']}")
        check(f["counts"] == want, f"rank {rank}: launches {f['counts']} != {want}")
        check(f["finite"] and f["pixels_shape"] == [len(PROMPTS), 256, 256, 3],
              f"rank {rank}: pixels {f['pixels_shape']} finite {f['finite']}")
    agree = ranks[0]["flagship"]["codes_agree"]
    print(f"  flagship codes at model 2 against one rank's call (same weights, prompts, seed "
          f"and {PARALLEL_T2I_STEPS} steps): {agree:.4f} agree")
    print("  collectives staged through host memory: none (gloo took CUDA tensors for every "
          "op)")
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"  the parallel phase: {seconds:.1f} s (kernels {t_kernels:.1f} s; rank 0: tiny meshes "
          f"{r0['tiny_s']:.1f} s, tiny serving {r0['serving_tiny_s']:.1f} s, flagship "
          f"{r0['flagship_s']:.1f} s of which the timed call "
          f"{r0['flagship']['seconds']:.1f} s; the rest the ranks' start and join)")
    f0 = ranks[0]["flagship"]
    results["parallel"] = {"phase_s": seconds, "t2i_s": f0["seconds"],
                           "collective_share": f0["collective_s"] / f0["seconds"],
                           "cos": [r["flagship"]["cos"] for r in ranks],
                           "argmax": [r["flagship"]["argmax"] for r in ranks],
                           "codes_agree": agree}
    return f0["counts"]


def _follow_run(eng):
    """A follower's side of ``serve_run``: the launch counts set to 0, the
    engine followed until rank 0's stop, the counts read; the requests
    mirrored from rank 0's plan, with this rank's tokens and stats."""
    import torch
    sizes = []
    _reset_counts()
    torch.cuda.synchronize()
    with admission_census(sizes):
        t0 = time.perf_counter()
        eng.close(timeout=None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    check(not eng._thread.is_alive(), "a follower's engine outlived rank 0's stop")
    stats = eng.stats
    return {"seconds": dt, "tokens": [f.result(0) for _, f in sorted(eng.followed.items())],
            "counts": _read_counts(), "groups": len(sizes), "group_sizes": sizes,
            "steps": stats.slot_steps // eng.slots, "chunks": stats.decode_chunks,
            "busy_steps": stats.busy_steps, "t_plan_s": stats.t_plan}


def _parallel_serving_rank(rank):
    """The flagship serving engine at model 2, bf16 (rank 0 decides, rank 1
    follows its plan), bench_serve's engine (32 slots, cache 896, bucket
    640, chunk 16) on the serving phase's trace cut to its first
    PARALLEL_SERVE_REQUESTS requests, all queued at once: the run with the
    launch counts set to 0 just before and read just after (exact from the
    admissions and decode steps), its collectives timed, this rank's peak
    memory over the engine and the run; then (rank 0) the same requests
    through the one-rank engine, whose tokens are compared."""
    import torch
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.parallel import collectives as C
    pipe = flagship_pipeline()
    cfg = pipe.cfg
    mesh = P.make_mesh(1, 1, PARALLEL_RANKS, device_type="cuda")
    tp = pipe.shard(mesh)
    prompts, budgets = serving_trace(PARALLEL_SERVE_REQUESTS)
    requests = [(dict(input_ids=p, max_new_tokens=b), b, None) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serving_engine(tp.params, cfg, keep_followed=True, sharding=tp.sharding)
    warm = time.perf_counter() - t0
    with C.timing() as coll:
        run = serve_run(eng, lambda: requests) if rank == 0 else _follow_run(eng)
    out = dict(run, warm_s=warm, collective_s=coll["seconds"], collectives=coll["calls"],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               resident_gib=resident / 2 ** 30, t_plan_s=eng.stats.t_plan,
               layers=cfg.llm.num_hidden_layers, local_heads=int(tp.params["llm"]["layers"][0]["q_w"].shape[0]) // 128)
    if rank == 0:
        one = serve_run(serving_engine(pipe.params, cfg), lambda: requests)
        out["one_rank"] = {k: one[k] for k in ("tokens", "seconds", "tokens_per_s",
                                               "ttft_p50_s", "chunks")}
    return out


def run_parallel_serving(results):
    """The optional parallel_serving phase (``_parallel_serving_rank``): 2
    ranks on the card under gloo; every rank's tokens, decode chunks, busy
    steps and exact launches; useful tokens/s, TTFT p50, the collectives'
    share of the wall and each rank's peak memory, beside the one-rank
    engine on the same requests."""
    t0 = time.perf_counter()
    print(f"phase: parallel_serving (ServingEngine on Qwen2.5-1.5B at model 2, bf16, random init: "
          f"the serving phase's first {PARALLEL_SERVE_REQUESTS} requests of {SERVE_PROMPT} ids, "
          f"{SERVE_SLOTS} slots, chunk {SERVE_CHUNK}, bucket {SERVE_BUCKET}, cache "
          f"{SERVE_MAX_LEN}, greedy; {PARALLEL_RANKS} ranks on the one card, {GLOO_NOTE})")
    ranks = spawn_ranks("_parallel_serving_rank")
    r0 = ranks[0]
    layers = r0["layers"]
    for rank, r in enumerate(ranks):
        expect = _serve_expect(r, layers, "bf16")
        print(f"  rank {rank} ({r['local_heads']} query heads): engine and warm-up "
              f"{r['warm_s']:.2f} s; {r['seconds']:.3f} s; collectives {r['collective_s']:.3f} s "
              f"({r['collectives']} calls, {r['collective_s'] / r['seconds']:.4f} of the wall; "
              f"{GLOO_NOTE}); the plan's broadcasts {r['t_plan_s']:.3f} s; {r['groups']} "
              f"admissions, {r['chunks']} chunks, {r['steps']} decode steps, busy steps "
              f"{r['busy_steps']}; launches {r['counts']}; peak memory {r['peak_gib']:.2f} GiB "
              f"(torch.cuda.max_memory_allocated over the engine and the run; "
              f"{r['resident_gib']:.2f} GiB held before)")
        check(r["counts"] == expect, f"rank {rank}: launches {r['counts']} != {expect}")
        check((r["tokens"], r["chunks"], r["busy_steps"]) ==
              (r0["tokens"], r0["chunks"], r0["busy_steps"]),
              f"rank {rank}'s tokens or steps differ from rank 0's")
    _serve_report(f"model 2, rank 0 ({GLOO_NOTE})", r0)
    one = r0["one_rank"]
    same = sum(int(a == b) for t, o in zip(r0["tokens"], one["tokens"]) for a, b in zip(t, o))
    agree = same / max(sum(map(len, one["tokens"])), 1)
    print(f"  one rank on the same requests: {one['seconds']:.3f} s, {one['tokens_per_s']:.2f} "
          f"useful tokens/s, TTFT p50 {one['ttft_p50_s']:.3f} s, {one['chunks']} chunks; tokens "
          f"at model 2 equal to one rank's: {agree:.4f} (bf16 sums in another order; not a gate)")
    seconds = time.perf_counter() - t0
    print(f"  the parallel_serving phase: {seconds:.1f} s")
    results["parallel_serving"] = {
        "phase_s": seconds, "tokens_per_s": r0["tokens_per_s"], "ttft_p50_s": r0["ttft_p50_s"],
        "collective_share": [r["collective_s"] / r["seconds"] for r in ranks],
        "peak_gib": [r["peak_gib"] for r in ranks], "agree_one_rank": agree,
        "one_rank_tokens_per_s": one["tokens_per_s"]}
    return r0["counts"]


def _parallel_quant_rank(rank):
    """The named-only parallel_quant phase on one rank: the flagship W8A8 t2i
    at model 2 as the flagship_int8 phase runs it (batch 4, guidance 6, 50
    steps, the int8 image head split over the codes, codes -> 256 px): the
    first step's image logits against the unsharded forward, the exact
    launches a rank, the call's seconds, its collectives' share and the
    rank's peak memory, and (rank 0) its codes against the one-rank W8A8
    run's on the same generator seed; then the flagship serving engine in
    int8+int4 (W8A8 admission, W4A8 decode chunks) and int8+kv (the int8
    cache of the rank's KV head) on the parallel_serving phase's requests,
    with (rank 0) the one-rank engines on the same requests."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    from unigen_tpu_torch.parallel import collectives as C
    out = {}
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8")
    cfg = pipe.cfg
    layers = cfg.llm.num_hidden_layers
    mesh = P.make_mesh(1, 1, PARALLEL_RANKS, device_type="cuda")
    tp = pipe.shard(mesh)
    first_step_logits = _first_image_logits(pipe, PROMPTS)
    a, b = first_step_logits(tp.params, tp.specs), first_step_logits(pipe.params)
    t2i = {"cos": F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item(),
           "argmax": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
           "logits_equal": bool(torch.equal(a, b))}
    del a, b
    _t2i_run(tp, timesteps=1)()                               # warm: every call once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with C.timing() as coll:
        t0 = time.perf_counter()
        codes, pixels = _t2i_run(tp, timesteps=50)()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    t2i.update(counts=_read_counts(), seconds=seconds, collective_s=coll["seconds"],
               collectives=coll["calls"], peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               pixels_shape=list(pixels.shape), finite=bool(torch.isfinite(pixels).all()),
               local_heads=int(tp.params["llm"]["layers"][0]["q"]["scale"].shape[0]) // 128,
               head_codes=int(tp.params["img_head_q"]["scale"].shape[0]), layers=layers)
    if rank == 0:
        one, _ = _t2i_run(pipe, timesteps=50)()
        t2i["codes_equal"] = (codes == one).float().mean().item()
    out["t2i"] = t2i
    del tp
    torch.cuda.empty_cache()

    # the serving engine: int8+int4 and int8+kv
    w8 = pipe.params
    w4 = quantize_unigen_params_int4(build_pipeline("flagship", dtype=torch.bfloat16,
                                                    device="cuda", seed=0).params, cfg)
    l8, sh8 = P.shard_params(w8, P.unigen_specs(w8, cfg, mesh), mesh)
    l4, sh4 = P.shard_params(w4, P.unigen_specs(w4, cfg, mesh), mesh)
    prompts, budgets = serving_trace(PARALLEL_SERVE_REQUESTS)
    requests = [(dict(input_ids=p, max_new_tokens=b), b, None) for p, b in zip(prompts, budgets)]
    for mode, (one_kw, tp_kw) in (("int8+int4", (dict(decode_params=w4),
                                                 dict(decode_params=l4, decode_sharding=sh4))),
                                  ("int8+kv", (dict(quantized_cache=True),) * 2)):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = serving_engine(l8, cfg, keep_followed=True, sharding=sh8, **tp_kw)
        with C.timing() as coll:
            run = serve_run(eng, lambda: requests) if rank == 0 else _follow_run(eng)
        r = dict(run, collective_s=coll["seconds"], collectives=coll["calls"],
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 resident_gib=resident / 2 ** 30, heads=int(eng._cache.k.shape[3]))
        del eng
        torch.distributed.barrier()
        if rank == 0:
            one = serve_run(serving_engine(w8, cfg, **one_kw), lambda: requests)
            r["one_rank"] = {k: one[k] for k in ("tokens", "seconds", "tokens_per_s",
                                                 "ttft_p50_s", "chunks")}
        torch.distributed.barrier()
        out[mode] = r
    return out


def run_parallel_quant(results):
    """The named-only parallel_quant phase (``_parallel_quant_rank``): 2 ranks
    on the card under gloo."""
    t0 = time.perf_counter()
    print(f"phase: parallel_quant (the flagship W8A8 t2i and the int8+int4 / int8+kv serving "
          f"engine at model 2; {PARALLEL_RANKS} ranks on the one card, {GLOO_NOTE})")
    ranks = spawn_ranks("_parallel_quant_rank")
    out = {}
    t0r = ranks[0]["t2i"]
    layers, steps = t0r["layers"], 50
    dense = 7 * layers * (steps + 1) + steps
    want = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * steps,
                conv3x3_gn_swish=44, gn_affine=40,
                quantize_activations=6 * layers + steps * (6 * layers + 1),
                w8a8_epilogue=dense, int8_matmul=dense)
    for rank, r in enumerate(ranks):
        f = r["t2i"]
        print(f"  flagship W8A8 t2i at model 2, rank {rank}: {f['local_heads']} query heads, "
              f"{f['head_codes']} of the image head's codes a rank; first step's image logits "
              f"against the unsharded forward: cosine {f['cos']:.6f}, argmax agreement "
              f"{f['argmax']:.4f}, bit for bit {f['logits_equal']}; launches {f['counts']}; "
              f"{f['seconds']:.3f} s a call, of which collectives {f['collective_s']:.3f} s "
              f"({f['collective_s'] / f['seconds']:.4f}, {f['collectives']} calls; {GLOO_NOTE}); "
              f"peak memory {f['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated over the "
              "call, both ranks' trees on the one card)")
        check(f["cos"] >= 0.999, f"rank {rank}: W8A8 first-step logits cosine {f['cos']}")
        check(f["counts"] == want, f"rank {rank}: W8A8 t2i launches {f['counts']} != {want}")
        check(f["finite"] and f["pixels_shape"] == [len(PROMPTS), 256, 256, 3],
              f"rank {rank}: pixels {f['pixels_shape']} finite {f['finite']}")
    print(f"  flagship W8A8 t2i codes at model 2 equal to the one-rank W8A8 run's (same weights, "
          f"prompts and generator seed): {t0r['codes_equal']:.4f}")
    out["t2i"] = {k: t0r[k] for k in ("cos", "argmax", "logits_equal", "seconds", "collective_s",
                                      "peak_gib", "codes_equal")}
    for mode in ("int8+int4", "int8+kv"):
        r0 = ranks[0][mode]
        for rank, r in enumerate(ranks):
            m = r[mode]
            expect = _serve_expect(m, layers, mode, tp=True)
            print(f"  {mode} at model 2, rank {rank}: {m['seconds']:.3f} s; collectives "
                  f"{m['collective_s']:.3f} s ({m['collectives']} calls, "
                  f"{m['collective_s'] / m['seconds']:.4f} of the wall; {GLOO_NOTE}); "
                  f"{m['groups']} admissions, {m['chunks']} chunks, {m['steps']} decode steps; "
                  f"cache of {m['heads']} KV head; launches {m['counts']}; peak memory "
                  f"{m['peak_gib']:.2f} GiB ({m['resident_gib']:.2f} GiB held before)")
            check(m["counts"] == expect, f"rank {rank} {mode}: launches {m['counts']} != {expect}")
            check(m["heads"] == 1, f"rank {rank} {mode}: a cache of {m['heads']} KV heads")
            check((m["tokens"], m["chunks"], m["busy_steps"]) ==
                  (r0["tokens"], r0["chunks"], r0["busy_steps"]),
                  f"rank {rank}'s {mode} tokens or steps differ from rank 0's")
        _serve_report(f"{mode} at model 2, rank 0 ({GLOO_NOTE})", r0)
        one = r0["one_rank"]
        same = sum(int(a == b) for t, o in zip(r0["tokens"], one["tokens"]) for a, b in zip(t, o))
        agree = same / max(sum(map(len, one["tokens"])), 1)
        print(f"  {mode} on one rank, the same requests: {one['seconds']:.3f} s, "
              f"{one['tokens_per_s']:.2f} useful tokens/s, TTFT p50 {one['ttft_p50_s']:.3f} s, "
              f"{one['chunks']} chunks; tokens at model 2 equal to one rank's: {agree:.4f}")
        out[mode] = {"tokens_per_s": r0["tokens_per_s"], "one_rank_tokens_per_s":
                     one["tokens_per_s"], "agree_one_rank": agree,
                     "peak_gib": [r[mode]["peak_gib"] for r in ranks],
                     "collective_share": [r[mode]["collective_s"] / r[mode]["seconds"]
                                          for r in ranks]}
    seconds = time.perf_counter() - t0
    print(f"  the parallel_quant phase: {seconds:.1f} s")
    results["parallel_quant"] = dict(out, phase_s=seconds)
    return t0r["counts"]


def _dir_bytes(path):
    import os
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _read_shares(saved, state, specs, sizes, moments):
    """What a rank's piece of ``state`` (``specs`` on a mesh of ``sizes``)
    reads of a checkpoint whose ``sharding.json`` is ``saved``, as {"inner":
    ..., "whole": ...}, each {leaf family (layer index as *): its whole
    bytes}: "inner" the leaves that the target cuts finer than the saved
    pieces along a dimension inside the leaf's outermost dimension of more
    than one element (a strided part of every saved piece, which touches
    every page it crosses), "whole" the leaves the target keeps whole (read
    and held whole by every rank). ``moments``: the trained leaves' paths,
    which name the optimizer's moments."""
    import math
    import re
    from unigen_tpu_torch.utils import checkpoint as CK

    def cuts(spec, mesh):
        return [mesh[a] if a is not None else 1 for a in spec]
    out = {"inner": {}, "whole": {}}
    for p, t in CK.state_leaves(state):
        cut, saved_cut = cuts(specs[p], sizes), cuts(saved["specs"][p], saved["mesh"])
        shape = [n * k for n, k in zip(t.shape, cut)]
        outer = next((i for i, n in enumerate(shape) if n > 1), 0)
        if any(c > s and i > outer for i, (c, s) in enumerate(zip(cut, saved_cut))):
            kind = "inner"
        elif all(c == 1 for c in cut):
            kind = "whole"
        else:
            continue
        m = re.match(r"opt_state/(mu|nu)/(\d+)$", p)
        fam = re.sub(r"/\d+/", "/*/", f"opt_state/{m[1]}/{moments[int(m[2])]}" if m else p)
        out[kind][fam] = out[kind].get(fam, 0) + math.prod(shape) * t.element_size()
    return out


def _sharded_restore(held, config, steps):
    """The sharded checkpoint across meshes on the flagship PT2 state
    (ROADMAP 15(f)): every rank saves the (1, 2, 1) trainer's state into a
    temporary directory and checks its piece against the state leaf by leaf;
    the (1, 2, 1) mesh takes its next step; the trainer is freed (``held``,
    [the trainer], is emptied here: the caller keeps no reference) and a
    (1, 1, 2) trainer restores by pieces (``utils/checkpoint.py``), each
    rank's host RSS sampled over the restore and its device memory read
    before and after the free; every restored leaf (params, moments, step)
    is gathered whole on the device one at a time and held bit for bit
    against the checkpoint's; one step from the restored state. Returns
    (the record, the (1, 1, 2) trainer)."""
    import gc
    import json
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.parallel.partition import gather_full
    from unigen_tpu_torch.training import train as TRAIN
    from unigen_tpu_torch.training.optimizer import named_leaves
    from unigen_tpu_torch.utils import checkpoint as CK
    from unigen_tpu_torch.utils.persistence import load_state_dict
    box = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box)
    root, rec = box[0], {}
    trainer = held.pop()
    try:
        state = trainer.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = CK.save_checkpoint(state, root, int(state.step))
        rec["save_s"] = time.perf_counter() - t0
        state_dir = os.path.join(path, "state")
        mesh = state.sharding.mesh
        piece = load_state_dict(os.path.join(
            state_dir, f"shard-f{mesh.coord['fsdp']}-m{mesh.coord['model']}"), mmap=True)
        saved_equal = True
        for p, t in CK.state_leaves(state):
            saved_equal &= bool(torch.equal(piece[p].to(t.device), t.detach()))
        del piece
        rec["saved_equal"] = saved_equal
        rec["bytes"] = _dir_bytes(state_dir)
        rec["next"] = steps(trainer, 1)[0][2]            # the (1, 2, 1) mesh's next step
        torch.cuda.synchronize()
        rec["held_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        rec["freed_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        dist.barrier()
        mesh = P.make_mesh(1, 1, 2, device_type="cuda")
        trainer = TRAIN.build_trainer(config, mesh=mesh)
        dist.barrier()
        timing = {}
        with _step("the restore by pieces at (1, 1, 2)", timing):
            trainer.state = CK.restore_checkpoint(path, trainer.state)
        t = timing["the restore by pieces at (1, 1, 2)"]
        rec.update(restore_s=t["s"], rss_before_gib=t["rss_before_gib"],
                   rss_rise_gib=t["peak_rss_gib"] - t["rss_before_gib"])
        specs = CK.state_specs(trainer.state)
        with open(os.path.join(state_dir, CK.SHARDING_NAME)) as f:
            saved = json.load(f)
        trained = [p for (p, _), train in zip(named_leaves(trainer.state.params),
                                              trainer.tx.trainable) if train]
        rec["reads"] = _read_shares(saved, trainer.state, specs, mesh.shape, trained)
        local = dict(CK.state_leaves(trainer.state))
        names, leaves_equal = 0, True
        for p, want in CK.read_pieces(state_dir, {p: (None,) * t.dim() for p, t in local.items()}):
            got = gather_full(local[p].detach(), specs[p], mesh)
            leaves_equal &= bool(torch.equal(want.to(got.device), got))
            names += 1
            del got, want
        del local
        rec["leaves"], rec["restored_equal"] = names, leaves_equal
        rec["restored_step"] = int(trainer.state.step)
        rec["first"] = steps(trainer, 1)[0][2]
        dist.barrier()
        return rec, trainer
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)


def _parallel_train_rank(rank):
    """The flagship PT2 step (the train phase's config) on each
    PARALLEL_TRAIN_MESHES mesh: 1 warm + 2 timed steps from one batch and a
    generator of one seed, each rank's peak memory over what it held before
    the steps; after the (1, 2, 1) mesh's steps, its state saved and restored
    onto (1, 1, 2) (``_sharded_restore``); then (rank 0) the one-rank step's
    first losses."""
    import statistics
    import torch
    from unigen_tpu_torch import parallel as P
    from unigen_tpu_torch.parallel import collectives as C
    from unigen_tpu_torch.training import train as TRAIN
    config = train_config("training.max_train_steps=3")
    batch = None
    out = {}

    def steps(trainer, n):
        gen = torch.Generator(device="cuda").manual_seed(11)
        rec = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with C.timing() as coll:
                trainer.state, m = trainer.step_fn(trainer.state, trainer.vq_params, batch, gen)
                torch.cuda.synchronize()
            rec.append((time.perf_counter() - t0, coll["seconds"],
                        {k: float(v) for k, v in m.items()}))
        return rec
    for d, f, m in PARALLEL_TRAIN_MESHES:
        mesh = P.make_mesh(d, f, m, device_type="cuda")
        trainer = TRAIN.build_trainer(config, mesh=mesh, fsdp=f > 1)
        if batch is None:
            batch = trainer.build_device_batch(next(TRAIN.synthetic_flows(config)))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()      # not the whole tree built before sharding
        _reset_counts()
        rec = steps(trainer, PARALLEL_TRAIN_WARM + PARALLEL_TRAIN_TIMED)
        timed = rec[PARALLEL_TRAIN_WARM:]
        out[f"{d}x{f}x{m}"] = {
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "resident_gib": resident / 2 ** 30, "first": rec[0][2],
            "step_s": statistics.median(t for t, _, _ in timed),
            "collective_s": statistics.median(c for _, c, _ in timed),
            "counts": _read_counts(), "layers": trainer.cfg.llm.num_hidden_layers}
        if (d, f, m) == (1, 2, 1):
            held, trainer = [trainer], None       # freed inside, before the restore
            out["restore"], trainer = _sharded_restore(held, config, steps)
        del trainer
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        P.mesh.set_mesh(None)
        trainer = TRAIN.build_trainer(config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["one_rank"] = steps(trainer, 1)[0][2]
        out["one_rank_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer
        torch.cuda.empty_cache()
    return out


def _report_restore(res):
    """Prints and checks ``_sharded_restore``'s records, one a rank."""
    r0 = res[0]
    size = r0["bytes"]
    print(f"  sharded checkpoint (ROADMAP 15(f)): the (1,2,1) state at step "
          f"{r0['restored_step']}, {size} bytes on disk ({size / 2 ** 30:.3f} GiB); saved in "
          f"{r0['save_s']:.2f} s by both ranks, restored by pieces onto (1,1,2) in "
          f"{r0['restore_s']:.2f} s (rank 0; the files just written, so the read was warm)")
    out = {"bytes": size, "save_s": r0["save_s"], "restore_s": [r["restore_s"] for r in res],
           "rss_rise_share": [], "held_gib": [r["held_gib"] for r in res],
           "freed_gib": [r["freed_gib"] for r in res]}
    for rank, r in enumerate(res):
        share = r["rss_rise_gib"] * 2 ** 30 / size
        out["rss_rise_share"].append(share)
        print(f"  rank {rank}: host RSS {r['rss_before_gib']:.2f} GiB before the restore, its rise "
              f"{r['rss_rise_gib']:.3f} GiB = {share:.3f} of the checkpoint (predicted 0.5-1.0; "
              f"VmRSS sampled every 5 ms); restore {r['restore_s']:.2f} s; its saved piece equal to "
              f"its state: {r['saved_equal']}; {r['leaves']} restored leaves gathered one at a "
              f"time, bit for bit the checkpoint's: {r['restored_equal']}; device memory "
              f"allocated {r['held_gib']:.2f} GiB with the (1,2,1) trainer, {r['freed_gib']:.2f} "
              "GiB once it was freed, before the (1,1,2) trainer was built")
        for kind, what in (("inner", "cut along an inner dimension of a saved piece"),
                           ("whole", "kept whole by every rank")):
            fams = r["reads"][kind]
            print(f"  rank {rank}: leaves {what} ({sum(fams.values()) / size:.3f} of the "
                  "checkpoint): " + ", ".join(
                      f"{k} {v / size:.3f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])
                      if v / size >= 0.001))
        check(r["saved_equal"] and r["restored_equal"]
              and r["restored_step"] == r0["restored_step"],
              f"rank {rank}: the restored (1,1,2) state differs from the saved (1,2,1) one: {r}")
    first, nxt = r0["first"], r0["next"]
    rel = {k: abs(first[k] - nxt[k]) / max(abs(nxt[k]), 1e-30)
           for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")}
    print(f"  the step from the restored state at (1,1,2) {first}, the (1,2,1) mesh's next step "
          f"{nxt}, relative differences {rel} (losses need <= 1e-2, the grad norm <= 5e-2)")
    check(all(rel[k] <= 1e-2 for k in ("loss_t2i", "loss_lm", "loss_mmu"))
          and rel["grad_norm"] <= 5e-2, f"the restored step differs from (1,2,1)'s: {rel}")
    out["rel"] = rel
    return out


def run_parallel_train(results):
    """The optional parallel_train phase: the flagship PT2 step at model 2
    and at fsdp 2, 2 ranks on the card; the first step's losses against the
    one-rank step (the train phase's bf16 bounds), each rank's peak memory,
    kernel 2's exact launches a rank (a step: 2 x layers forward with the
    remat recompute, layers backward); the (1,2,1) state's checkpoint
    restored onto (1,1,2) (``_report_restore``)."""
    t0 = time.perf_counter()
    print(f"phase: parallel_train ({TRAIN_CONFIG} at meshes {PARALLEL_TRAIN_MESHES}, "
          f"{PARALLEL_RANKS} ranks on the one card under gloo, {PARALLEL_TRAIN_WARM} warm + "
          f"{PARALLEL_TRAIN_TIMED} timed steps)")
    ranks = spawn_ranks("_parallel_train_rank")
    one = ranks[0]["one_rank"]
    print(f"  one rank (whole tree, rank 0 alone after the meshes): peak "
          f"{ranks[0]['one_rank_peak_gib']:.2f} GiB over its first step")
    out = {"one_rank_peak_gib": ranks[0]["one_rank_peak_gib"]}
    for name in (f"{d}x{f}x{m}" for d, f, m in PARALLEL_TRAIN_MESHES):
        first = ranks[0][name]["first"]
        rel = {k: abs(first[k] - one[k]) / max(abs(one[k]), 1e-30)
               for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")}
        for rank, r in enumerate(ranks):
            m = r[name]
            print(f"  mesh {name}, rank {rank}: peak {m['peak_gib']:.2f} GiB "
                  f"(torch.cuda.max_memory_allocated of the rank over its steps; "
                  f"{m['resident_gib']:.2f} GiB held before them); {m['step_s']:.3f} s a step "
                  f"(median of {PARALLEL_TRAIN_TIMED}), collectives {m['collective_s']:.3f} s "
                  f"({GLOO_NOTE}); launches {m['counts']}")
            steps = PARALLEL_TRAIN_WARM + PARALLEL_TRAIN_TIMED
            check(m["counts"]["flash_attention"] == steps * 2 * m["layers"]
                  and m["counts"]["flash_attention_backward"] == steps * m["layers"],
                  f"parallel_train {name} rank {rank}: kernel 2 launches {m['counts']} over "
                  f"{steps} steps of {m['layers']} layers")
        print(f"  mesh {name}: first step {first}, one rank {one}, relative differences {rel} "
              "(losses need <= 1e-2, the grad norm <= 5e-2)")
        check(all(rel[k] <= 1e-2 for k in ("loss_t2i", "loss_lm", "loss_mmu"))
              and rel["grad_norm"] <= 5e-2, f"parallel_train {name} differs from one rank: {rel}")
        out[name] = {"peak_gib": [r[name]["peak_gib"] for r in ranks],
                     "step_s": ranks[0][name]["step_s"], "rel": rel}
    out["restore"] = _report_restore([r["restore"] for r in ranks])
    seconds = time.perf_counter() - t0
    print(f"  the parallel_train phase: {seconds:.1f} s")
    results["parallel_train"] = dict(out, phase_s=seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES + OPTIONAL_PHASES))
    phases = set(ap.parse_args(argv).phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from unigen_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the unigen_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    # fp32 references are full fp32: TF32 off for matmuls and cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          "allow_tf32 matmul=False cudnn=False")
    results = {}
    path_counts = {}
    start, walls = time.perf_counter(), {}

    @contextlib.contextmanager
    def clock(name):
        """Times one phase: printed to stdout and to stderr, whose end a
        caller sees when the run is cut at its time limit."""
        t = time.perf_counter()
        yield
        walls[name] = time.perf_counter() - t
        line = (f"the {name} phase: {walls[name]:.1f} s "
                f"({time.perf_counter() - start:.1f} s since the start)")
        print("  " + line)
        print("chip_smoke: " + line, file=sys.stderr, flush=True)

    try:
        t0 = time.perf_counter()
        built = _cuda.build()
        for name, info in built.items():
            regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
            print(f"  built {name}.cu in {info['seconds']:.1f} s; ptxas: "
                  + " | ".join(regs))
        print(f"phase: build {time.perf_counter() - t0:.1f} s "
              f"({', '.join(_cuda.SOURCES)}, one nvcc each, in parallel)")
        if "kernels" in phases:
            with clock("kernels"):
                run_kernel_phases(results)
        if "flagship" in phases:
            with clock("flagship"):
                path_counts["t2i"] = run_flagship(results, profile="profile" in phases)
        if "flagship_int8" in phases:
            with clock("flagship_int8"):
                path_counts["t2i_int8"] = run_flagship_int8(results, profile="profile" in phases)
        if "flagship_ar" in phases:
            with clock("flagship_ar"):
                path_counts["t2i_ar"] = run_flagship_ar(results, profile="profile" in phases)
        if "understand" in phases:
            with clock("understand"):
                path_counts["understand"] = run_understand(results, profile="profile" in phases)
        if "understand_int8" in phases:
            with clock("understand_int8"):
                path_counts["understand_int8"] = run_understand_int8(results,
                                                                     profile="profile" in phases)
        if "understand_discrete" in phases:
            with clock("understand_discrete"):
                path_counts["understand_discrete"] = run_understand_discrete(
                    results, profile="profile" in phases)
        if "understand_naflex" in phases:
            with clock("understand_naflex"):
                path_counts["understand_naflex"] = run_understand_naflex(
                    results, profile="profile" in phases)
        if "score" in phases:
            with clock("score"):
                path_counts["score"] = run_score(results, profile="profile" in phases)
        if "lmms" in phases:
            with clock("lmms"):
                path_counts["lmms"] = run_lmms(results)
        if "geneval" in phases:
            with clock("geneval"):
                path_counts["geneval"] = run_geneval(results, profile="profile" in phases)
        if "cot" in phases:
            with clock("cot"):
                for rater, counts in run_cot(results, profile="profile" in phases).items():
                    path_counts[f"cot_{rater}"] = counts
        if "dpg" in phases:
            with clock("dpg"):
                path_counts["dpg"] = run_dpg(results, profile="profile" in phases)
        if "image_serving" in phases:
            with clock("image_serving"):
                path_counts["image_serving"] = run_image_serving(results)
        if "serving" in phases:
            with clock("serving"):
                path_counts.update(run_serving(results, profile="profile" in phases))
        if "serving_vqa" in phases:
            with clock("serving_vqa"):
                path_counts["serving_vqa"] = run_serving_vqa(results, profile="profile" in phases)
        if "serving_http" in phases:
            with clock("serving_http"):
                path_counts["serving_http"] = run_serving_http(results)
        if "serving_spec" in phases:
            with clock("serving_spec"):
                path_counts["serving_spec"] = run_serving_spec(results)
        if "serve_entry" in phases:
            with clock("serve_entry"):
                path_counts["serve_entry"] = run_serve_entry(results)
        if "train" in phases:
            with clock("train"):
                path_counts["train"] = run_train(results, profile="profile" in phases)
        if "jpeg" in phases:
            with clock("jpeg"):
                run_jpeg(results)
        if "images" in phases:
            with clock("images"):
                run_images(results)
        for name, fn in (("sft", run_sft), ("sft_packed", run_sft_packed), ("dpo", run_dpo),
                         ("cotv_post_sft", run_cotv_post_sft), ("sft_naflex", run_sft_naflex),
                         ("pt2_real", run_pt2_real), ("sft_real", run_sft_real),
                         ("dpo_real", run_dpo_real)):
            if name in phases:
                with clock(name):
                    path_counts[name] = fn(results, profile="profile" in phases)
        if "checkpoints" in phases:
            with clock("checkpoints"):
                path_counts.update(run_checkpoints(results))
            results["checkpoints"]["phase_s"] = walls["checkpoints"]
        if "parallel" in phases:
            with clock("parallel"):
                path_counts["parallel_t2i"] = run_parallel(results)
        if "parallel_train" in phases:
            with clock("parallel_train"):
                run_parallel_train(results)
        if "parallel_serving" in phases:
            with clock("parallel_serving"):
                path_counts["parallel_serving"] = run_parallel_serving(results)
        if "parallel_quant" in phases:
            with clock("parallel_quant"):
                path_counts["parallel_quant_t2i"] = run_parallel_quant(results)
        if "tiny" in phases:
            with clock("tiny"):
                run_tiny_train()
                run_tiny_post_training()
                run_tiny()
                run_tiny_understand()
                run_tiny_int8()
                run_tiny_slice()
                run_tiny_cot()
                run_tiny_serving()
        conv_batch_sums(results)
        print("phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
              + f"; {time.perf_counter() - start:.1f} s in all")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {"chunk_attention": "unigen_tpu/ops/chunk_attention.py:70",
                "flash_attention": "unigen_tpu/ops/flash_attention.py:95",
                "conv3x3_gn_swish": "unigen_tpu/ops/fused_conv.py:239",
                # XLA in the JAX package (the pre-pass of the Pallas conv), not Pallas
                "gn_affine": "unigen_tpu/ops/fused_conv.py:172",
                "w4a8_matmul": "unigen_tpu/ops/int4.py:95",
                # an XLA fusion in the JAX package, not a Pallas kernel
                "quantize_activations": "unigen_tpu/ops/quantization.py:50",
                # the XLA fusion that ends dense_int8_prequant, not a Pallas kernel
                "w8a8_epilogue": "unigen_tpu/ops/quantization.py:62",
                # kernel 2 under the train step: the custom_vjp (forward: the Pallas
                # kernel; backward: _flash_bwd's XLA recompute)
                "flash_attention_train": "unigen_tpu/ops/flash_attention.py:94",
                # that custom_vjp's backward, XLA's recompute in JAX, a kernel here
                "flash_attention_backward": "unigen_tpu/ops/flash_attention.py:117"}
    sources = {"chunk_attention": "unigen_tpu_torch/csrc/attention.cu",
               "flash_attention": "unigen_tpu_torch/csrc/attention.cu",
               "conv3x3_gn_swish": "unigen_tpu_torch/csrc/fused_conv.cu",
               "gn_affine": "unigen_tpu_torch/csrc/fused_conv.cu",
               "w4a8_matmul": "unigen_tpu_torch/csrc/int4.cu",
               "quantize_activations": "unigen_tpu_torch/csrc/int4.cu",
               "w8a8_epilogue": "unigen_tpu_torch/csrc/int8.cu",
               "flash_attention_train": "unigen_tpu_torch/csrc/attention.cu",
               "flash_attention_backward": "unigen_tpu_torch/csrc/attention.cu"}
    grad_rows = results.get("flash_attention_train") or {}
    grad_rows = ([grad_rows] if "backward_kernel" in grad_rows else []) + grad_rows.get("shapes", [])
    if grad_rows:
        bwd = [r["backward_kernel"] for r in grad_rows]
        results["flash_attention_backward"] = dict(bwd[0], shapes=bwd[1:])
    kernels = []
    for name in replaces:
        # launches: the sum over the main paths driven in this run (warm runs);
        # the training row counts kernel 2's launches on the train path
        if name == "flash_attention_train":
            by_path = {p: c["flash_attention"] for p, c in path_counts.items()
                       if p in TRAINING_PATHS}
        else:
            by_path = {path: c.get(name, 0) for path, c in path_counts.items()}
        row = {"name": name, "route": "cuda", "source": sources[name],
               "replaces": replaces[name],
               "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path}
        row.update(results.get(name) or {})
        kernels.append(row)
    if "flagship" in results:
        print(f"flagship: {results['flagship']['images_per_s']:.4f} images/s "
              f"({results['flagship']['seconds']:.3f} s for {len(PROMPTS)} images) on {card}")
    if "understand" in results:
        u = results["understand"]
        print(f"understand: W4A8 {u['w4a8']['tokens_per_s']:.2f} tokens/s "
              f"({u['w4a8']['seconds']:.3f} s), bf16 backbone {u['bf16']['tokens_per_s']:.2f} "
              f"tokens/s ({u['bf16']['seconds']:.3f} s), batch {len(QUESTIONS)} x "
              f"{NEW_TOKENS} tokens, on {card}")
    if "flagship_int8" in results:
        f8 = results["flagship_int8"]
        print(f"flagship_int8: {f8['images_per_s']:.4f} images/s ({f8['seconds']:.3f} s) on {card}")
    if "understand_int8" in results:
        u8 = results["understand_int8"]
        print(f"understand_int8 (int8+kv): {u8['tokens_per_s']:.2f} tokens/s "
              f"({u8['seconds']:.3f} s) on {card}")
    if "flagship_ar" in results:
        fa = results["flagship_ar"]
        print(f"flagship_ar: {fa['images_per_s']:.4f} images/s ({fa['seconds']:.3f} s for "
              f"{len(PROMPTS)} images) on {card}")
    if "understand_discrete" in results:
        ud = results["understand_discrete"]
        print(f"understand_discrete: {ud['tokens_per_s']:.2f} tokens/s ({ud['seconds']:.3f} s, "
              f"batch {len(QUESTIONS)} x {NEW_TOKENS} tokens) on {card}")
    if "understand_naflex" in results:
        un = results["understand_naflex"]
        print(f"understand_naflex: {un['tokens_per_s']:.2f} tokens/s ({un['seconds']:.3f} s, "
              f"batch {len(QUESTIONS)} x {NEW_TOKENS} tokens, {NAFLEX_PX} px), the tower "
              f"{un['tower_share']:.4f} of the call, on {card}")
    if "lmms" in results:
        lm = results["lmms"]
        for route in ("static", "served"):
            r = lm[route]
            print(f"lmms generate_until {route}: {r['requests_per_s']:.4f} requests/s, "
                  f"{r['tokens_per_s']:.2f} useful tokens/s ({r['seconds']:.3f} s for "
                  f"{LMMS_REQUESTS} requests) on {card}")
        for route in ("batched", "single"):
            r = lm[f"loglikelihood_{route}"]
            print(f"lmms loglikelihood {route}: {r['requests_per_s']:.4f} requests/s "
                  f"({r['seconds']:.3f} s) on {card}")
    if "score" in results:
        sc = results["score"]
        print(f"score: {sc['requests_per_s']:.3f} requests/s ({sc['seconds']:.3f} s for "
              f"{len(QUESTIONS)} requests) on {card}")
    if "geneval" in results:
        ge = results["geneval"]
        print(f"geneval: {ge['images_per_s']:.4f} images/s with the PNG writes "
              f"({ge['seconds']:.3f} s for 2 prompts x 4 samples) on {card}")
    if "cot" in results:
        for rater, c in results["cot"].items():
            print(f"cot, {rater} rater: {c['candidates_per_s']:.4f} candidates/s, "
                  f"{c['ratings_per_s']:.4f} ratings/s ({c['seconds']:.3f} s for "
                  f"{c['candidates']} candidates x 4 questions) on {card}")
    if "dpg" in results:
        dp = results["dpg"]
        print(f"dpg: {dp['images_per_s']:.4f} images/s with the grid writes ({dp['seconds']:.3f} "
              f"s for 2 prompts x 4 samples) on {card}")
    if "image_serving" in results:
        sv = results["image_serving"]
        print(f"image_serving: {sv['images_per_s']:.4f} images/s ({sv['seconds']:.3f} s for "
              f"{len(SERVING_PROMPTS)} requests at batch {SERVING_BATCH}), submit-to-done "
              f"{min(sv['latency_s']):.3f}-{max(sv['latency_s']):.3f} s on {card}")
    if "serving" in results:
        sv = results["serving"]
        for mode in ("bf16", "int8+int4", "int8+kv", "static_bf16"):
            r = sv[mode]
            print(f"serving {mode}: {r['tokens_per_s']:.2f} useful tokens/s, "
                  f"{r['requests_per_s']:.4f} requests/s, TTFT p50 {r['ttft_p50_s']:.3f} s p99 "
                  f"{r['ttft_p99_s']:.3f} s, per-request mean ITL p50 {r['itl_p50_s'] * 1e3:.2f} ms, "
                  f"occupancy {r['occupancy']:.4f}, wall {r['seconds']:.3f} s ({r['requests']} requests, "
                  f"{SERVE_SLOTS} slots) on {card}")
        print(f"serving continuous / static (bf16): {sv['continuous_over_static']:.4f}x on {card}")
    if "serving_vqa" in results:
        r = results["serving_vqa"]
        print(f"serving_vqa: {r['tokens_per_s']:.2f} useful tokens/s, TTFT p50 "
              f"{r['ttft_p50_s']:.3f} s, per-request mean ITL p50 {r['itl_p50_s'] * 1e3:.2f} ms, wall "
              f"{r['seconds']:.3f} s ({len(QUESTIONS)} requests) on {card}")
    if "serving_http" in results:
        print(f"serving_http: 6 replies in {results['serving_http']['seconds']:.3f} s on {card}")
    if "serving_spec" in results:
        sp = results["serving_spec"]
        for mode in ("plain", "spec"):
            r = sp[mode]
            print(f"serving_spec {mode}: {r['tokens_per_s']:.2f} useful tokens/s, "
                  f"{r['tokens_per_busy_step']:.4f} tokens a busy step, TTFT p50 "
                  f"{r['ttft_p50_s']:.3f} s p99 {r['ttft_p99_s']:.3f} s, per-request mean ITL "
                  f"p50 {r['itl_p50_s'] * 1e3:.2f} ms p99 {r['itl_p99_s'] * 1e3:.2f} ms, occupancy "
                  f"{r['occupancy']:.4f}, wall {r['seconds']:.3f} s on {card}")
        print(f"serving_spec speculative / plain: {sp['spec_over_plain']:.4f}x; greedy tokens "
              f"equal {sp['greedy_share_equal']:.4f} on {card}")
    if "serve_entry" in results:
        se = results["serve_entry"]
        print(f"serve_entry: healthy {se['healthy_s']:.2f} s after the start, 3 /v1/generate "
              f"{se['generate_s']:.3f} s, /v1/images {se['image_s']:.3f} s on {card}")
    if "checkpoints" in results:
        ck = results["checkpoints"]
        st = ck["steps"]
        print("checkpoints: " + "; ".join(
            f"{k} {v['s']:.2f} s (peak RSS {v['peak_rss_gib']:.2f} GiB)" for k, v in st.items())
              + "; " + ", ".join(f"{k} {v:.2f} s" for k, v in ck["builders_s"].items())
              + "; encode, a fresh reader, " + ", ".join(
                  f"{k} {v['tokens_per_s']:.0f} tokens/s" for k, v in ck["encode"].items())
              + f" ({ck['tokenizer_merges']} merges) on {card}")
    for name in TRAINING_PATHS + ("sft_lora",):
        if name in results:
            tr = results[name]
            real = "".join(f", {k} {v:.4f} s" for k, v in tr.items()
                           if k in ("loop_s", "free_step_s", "free_inline_step_s")
                           or k.startswith(("t2i ", "llava ", "pairs ", "the ")))
            print(f"{name}: {tr['step_s']:.4f} s a step (median; {tr['step_min_s']:.4f}"
                  f"-{tr['step_max_s']:.4f}), {tr['samples_per_s']:.4f} samples/s, "
                  f"{tr['tokens_per_s']:.1f} tokens/s, enqueue {tr['enqueue_s']:.4f} s, peak "
                  f"{tr['peak_gib']:.2f} GiB, model FLOPs {tr['model_tflops']:.2f} T a step "
                  f"(flagship width){real} on {card}")
    if EVENT_TIMED:
        print(f"{len(EVENT_TIMED)} kernel timings came from CUDA events: the profiler recorded "
              "no device time for them (printed where they were taken)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
