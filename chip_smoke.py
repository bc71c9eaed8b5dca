#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # every phase; exit 0 only if all pass
    python3 chip_smoke.py --profile   # also print torch.profiler breakdowns
                                      # of the AlexNet forwards, of decode
                                      # steps and of the llama prefill
    python3 chip_smoke.py --sweep     # only time B1/B2, B6 and B3 under every
                                      # candidate plan (the planners' tuning
                                      # data)
    python3 chip_smoke.py --windowed  # only the windowed decoders' phases
                                      # (24-28), no result line
    python3 chip_smoke.py --weight-only  # only the weight modes' phases
                                         # (29-33), no result line
    python3 chip_smoke.py --families  # only the other decoder families'
                                      # phases (34-38), no result line
    python3 chip_smoke.py --encoders  # only the encoders' and the lifecycle
                                      # levers' phases (39-43), no result
                                      # line
    python3 chip_smoke.py --levers    # only the accuracy levers' phases
                                      # (44-47), no result line
    python3 chip_smoke.py --artifact  # only the INT8 artifact's phases
                                      # (48-50), no result line
    python3 chip_smoke.py --hf        # only the HF checkpoint phases
                                      # (51-53), no result line
    python3 chip_smoke.py --ingest    # only the host ingest phases (54-58)
                                      # in full, no result line

Phases, in order (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi); a CUDA device is required;
2. build every kernel from ``int8inferenceengine_tpu_torch/csrc``, one nvcc
   per source, all started together (timed);
3. on-card numerics: ``quantize_u8`` and the epilogue vectors equal the CPU's
   bit for bit; the quantized GEMM kernel (B1) equals ``qgemm_plain``
   exactly on the eight AlexNet batch-100 GEMM shapes, on ragged shapes and
   on the narrow-grid shapes (M = 1, 8, 16, 100: the small tiles and the K
   split over a cluster), over both epilogue orders, both roundings, relu
   on/off, per-tensor and per-channel weight scales; B1's gathered conv
   equals im2col + ``qgemm_plain`` exactly over the same sixteen cases and
   the bfloat16 epilogue's eight at the five AlexNet batch-100 geometries
   and eight ragged ones;
4. the decoder's kernels against their plain versions at its shapes: B1's
   act epilogue with each of its seven activations (exact for the
   piecewise-linear ones, the 1-code/0.2% contract for sigmoid, silu,
   gelu), the merged QKV GEMM (B2) exactly at M = 8, 512 and ragged
   shapes, and the decode attention kernel (B3/B4) within the contract at
   B=8, H=12, D=64, T=512 and 4,096 (``ATTN_CASES``) over live lengths 1,
   77, 128, 511 and 4,000 where they fit, a full cache and a per-sequence
   length vector, GQA 12/2 and 12/4, four query positions, a window and a
   softcap, under ``plan_decode_attn``'s split and, for four cases, under
   every split count;
5. the AlexNet main path at full width: AlexNet-224 with seeded random
   weights — FP32 forward against its ``torch.nn`` twin (rtol 1e-4),
   prepare, calibrate on one batch of 100, convert, INT8 forward with
   exactly 8 kernel launches, the first two images' codes equal to a CPU
   copy's;
6. the decoders' card codes against a CPU copy: a small gpt2-style and a
   small llama W4A8 decoder (depth 2, dim 256, 4 heads, llama 2 kv heads,
   vocab 4096, max_len 128; batch 4, a 16-token prompt; the main paths'
   QuantConfigs; and the legs of ``CPU_GATE_LEGS``) calibrated and
   converted on the card and carried to the CPU (``export_state`` ->
   ``load_jax_state``): the prefill's logit codes, 16 greedy steps
   teacher-forced on the card's tokens and the greedy tokens themselves,
   each leg within the reference's contract (at most 1 code off on at most
   0.2%; equal tokens);
7. the decoder main path at full width (gpt2-small-ish: 768d, 12 layers, 12
   heads, vocab 50257, max_len 512) with seeded random weights, batch 8, a
   64-token prompt: FP32 forward against its twin (rtol 1e-4), prepare,
   calibrate, convert, greedy ``generate(ids, 128)`` (the first decode step
   eager, the others replaying it as a captured CUDA graph) with exactly 12
   B2, 37 B1 and 12 B3 per decode step (the wrappers count the prefill and
   the eager step, each replay adds the kernels that the capture recorded,
   and the capture adds nothing; in a profile of 4 replays of a step
   captured the same way each replay runs what it counts), then the kernel
   path's logit codes against the
   plain path's on the card, teacher-forced on its tokens, and the captured
   decode against the eager step loop: the tokens, and 128 teacher-forced
   steps' codes through a captured step, equal;
8. the 4-bit kernels against their plain versions at every shape the llama
   legs launch: B6 (W4A8 with exact per-group integer partials) exactly at
   the decode shapes, at M = 16, 64 and 128 and at ragged shapes, under
   both roundings, ``plan_w4a8_v2``'s plan and every K split it runs; B7
   (W4A8 at every other shape)
   at the prefill shapes with scalar and per-column ``mult``, at ragged
   shapes and at groups off the 32-value k-step, bit for bit equal to B6's
   plain arithmetic (``w4a8_v2_plain``, any M) and within 1 code on 0.2%
   of its own f32 plain version; B5 (W4 weight-only) within 2e-5 of the
   largest |output| at the weight-only shapes, the same edge shapes and an
   input whose magnitudes span 2^-60 ... 2^60; and at the engines' batched
   prefill shapes (M = n x bucket for the prompt lengths of 12, n up to 8
   slots: 32 to 1,024 rows) B1 and B2 at the gpt2 Linears and B6 or B7, as
   the W4A8 dispatch picks, at the llama's, under the same contracts;
9. the llama W4A8 main path at full width (bench.py's W4A8 leg: 768d, 12
   layers, 12 heads over 2 kv heads, vocab 32000, max_len 512, group 256,
   nearest rounding) with seeded random weights, batch 8, a 64-token prompt:
   FP32 forward against its twin (1e-4 of the largest logit), prepare,
   calibrate, convert, greedy ``generate(ids, 128)`` (captured, counted as
   in 7) with exactly 49 B6 and 12 B3 per decode step and 25 single-layer +
   24 merged B7 launches in the prefill, the captured decode equal to the
   eager step loop as in 7; every W4 launch of the prefill and of 16 decode
   steps replayed through its plain versions on its own operands; from one
   shared prefill cache, 128 teacher-forced decode steps whose logit codes
   must equal those of the same model with its W4 and B3 wrappers swapped
   for their plain versions; the prefill's codes against the plain path's
   (recorded, not gated);
10. the llama W4 weight-only forward (group 128) on the same weights and
   prompt: exactly 85 B5 launches, every launch replayed, logits within
   1e-4 of the largest |logit| of the plain path's;
11. timing with CUDA events: the AlexNet INT8 and FP32 batch-100 forwards,
   decode ms/step as ``(t(128 steps) - t(16 steps)) / 112`` (best of 3) and
   the prefill for both decoders, the weight-only forward, the full-context
   forwards (8 x 512 tokens: the weight-only model, and the W4A8 model's
   causal forward, B7 at M = 4096; recorded, not gated), and per kernel
   and shape the kernel (with B1's, B2's, B6's and B3's plan), its plain
   version, the bound and a library yardstick; B3 also at a full cache
   (recorded beside the step's); beside each captured decode ms/step the
   eager step loop's (see below); an empty launch through the same timer
   (the event floor); for the convs the gathered kernel beside
   im2col + B1 and the conv's own bound beside the im2col operand's
   (``bound_im2col_ms``); the yardstick for the int8 GEMMs is
   ``torch._int_mm`` (on the patch matrix, for a conv) + the eager epilogue,
   for B5 ``torch.addmm`` on the weight dequantized beforehand (f32, TF32
   off).  B3, B6 and B7 have none: no single PyTorch call computes
   attention over the u8 cache or a packed 4-bit GEMM with a requantizing
   epilogue;
12. serving the decoders (``serve.GenerationEngine``: 8 slots, chunks of
   32 captured steps, 4 chunks a host sync): the gpt2-small-ish engine
   takes 16 requests (prompts of 17-100 tokens, 64-128 new tokens; 10
   greedy, 4 sampled at temperature 0.8, top_p 0.9, top_k 40 with fixed
   seeds, 2 with an eos that their greedy run emits) twice: each greedy
   request equals ``generate()`` of its prompt alone, an eos request ends
   where that run first emits it, and the sampled ones repeat in the second
   pass; the llama W4A8 engine takes 8 greedy requests, the same gate.  Each
   then serves a saturated load (32 requests x 64 prompt tokens x 128 new
   tokens, greedy): tokens/s, time to first token p50/p99, mean slot fill;
   and a profiled replay of its greedy chunk graph must run the kernels
   that a replay counts.  The gpt2 engine also runs bench.py's engine leg
   (8 slots, 8 chunks a sync, 16 requests x 24 prompt tokens x 256 new
   tokens; tokens/s best of 2 after a warm round), the serving yardstick;
13. the small decoders of 6 served by an engine on the card and one on the
   CPU (gpt2 at 4 slots, llama W4A8 at 8 slots with a 768-wide MLP, every
   GEMM on B6): greedy tokens equal, sampled tokens recorded;
14. AlexNet-224's ``serve.InferenceEngine`` (max_batch 100, the forward
   captured per tile): requests of 1, 7, 33, 64 and 100 images equal the
   direct call exactly, and their counted launches equal the kernels that
   a profile of them saw run; images/s at a saturated load beside the
   direct call's.

15. B3 at the extend shapes (``EXT_MQ`` = 2-128 query positions x T =
   512 and 4,096 x MHA 12/12 and GQA 12/2, batch 2, D = 64): bit for bit
   against its plain twin (which must equal the composed version) under
   the planner's plan and every legal row tile, at live lengths 1 and T -
   mq + 1, a per-sequence vector and the vector with a window; timed per
   shape under the planner's plan beside its bound and the bytes its row
   tiles read;
16. the cached multi-token extend of both decoders (gpt2-small-ish and
   llama W4A8, from one shared prefill cache of the 8 x 64 prompt): m = 5
   at batch 8 and m = 64 at batch 1 give the logit codes and caches of m
   decode steps, as many kernels as a decode step; one m = 5 extend timed
   against 5 decode steps, both captured;
17. speculative decoding (k = 4, 128 tokens after the 8 x 64 prompt): the
   gpt2-small-ish target with itself as draft and with a 2-layer dim-256
   gpt_tiny draft (weights from default_rng(1)), the llama W4A8 target with
   itself: tokens equal to ``generate()``'s; tokens/s beside
   ``generate()``'s in the same call, the mean tokens per row and
   macro-step, the launches per macro-step;
18. chunked prefill and the prefix cache (``GenerationEngine`` at SERVE
   with ``prefill_chunk=64``): gpt2's 8 greedy (100-448 prompt tokens,
   equal to ``generate()``) and 4 sampled (equal to a bucketed engine's)
   requests, then a registered 256-token prefix with 16 requests of 16-64
   more tokens, each equal to the same prompt submitted cold: TTFT p50
   prefixed against cold, and of a 448-token prompt chunked against
   bucketed; the llama W4A8 engine's 8 greedy requests, equal to
   ``generate()``;
19. kernel G1 (the grouped INT8 conv, ``csrc/conv_grouped.cu``) bit for bit
   against its plain version at every grouped shape of MobileNet V1, V2,
   V3-large, V3-small, EfficientNet-B0 and ShuffleNetV2 at 224 (batch 8)
   and over a sweep (C = 3, 58, 96, 960; one or two channels a group; k 3
   and 5; stride 1 and 2), per-tensor and per-channel s_w, both roundings,
   relu on and off;
20. B1 bit for bit against ``qgemm_plain`` at every conv and Linear shape
   of ResNet-50 and MobileNetV2 at batch 100;
21. ResNet-50-224 at batch 100 (the twin's torchvision-layout state with
   BN folded at load, per-channel weight scales): FP32 forward against its
   twin, calibrate on 100 images, convert, one INT8 forward with exactly
   54 B1 launches, 4 images' codes equal to a CPU copy's; INT8 and FP32
   ms/batch, a profiled forward split into B1, the pools, the input's
   quantize and the rest of the glue; its ``InferenceEngine`` as in 14;
22. MobileNetV2-224 at batch 100, the same protocol without the engine:
   36 B1 and 17 G1 launches a forward;
23. the other 15 zoo CNNs (ResNet-18/34/101/152, VGG-11/16/19, MobileNet
   V1/V3, EfficientNet-B0, ShuffleNetV2, SqueezeNet, GoogLeNet,
   DenseNet-121), each calibrated and run once at 224, batch 2, on the card
   and against a CPU copy: equal codes.  In 11, B1 is timed at every
   ResNet-50 and MobileNetV2 shape and G1 at MobileNetV2's (beside its
   plain version, its bound, ``F.conv2d(groups=)`` in float32 + the eager
   epilogue, and, at one shape, one B1 launch a group).
24. B1 and B2 bit for bit against their plain versions at gemma-2-2b's
   decode (M = 8) and prefill (M = 512) GEMMs, the 256,000-wide head
   included, and B3 at its attention (D = 256, 8 heads over 4, window 4,096,
   softcap 50) at T = 8,192 (batch 8, every split count) and 16,384 (batch
   2), live lengths 1, 4,095, 4,096, 4,097, 8,191, T - 1, T and a
   per-sequence vector, within the contract;
25. (d) the small windowed decoders (gemma and mistral, depth 2, dim 256,
   window 32, ``ring_cache=True``, max_len 256) calibrated on the card
   against a CPU copy: prefill codes, 120 teacher-forced steps across
   three base moves of the ring, greedy tokens; and their engines (4 slots,
   prompts of 5-100 tokens) against ``generate()``, equal;
26. (a) gemma-2-2b at its published widths (``GEMMA2``; weights from a
   ``torch.Generator`` on the card, the head tied to the token table as in
   the published checkpoint), batch 8, a 64-token prompt: FP32
   forward against its twin on the card, calibrate, convert, greedy
   ``generate(ids, 128)`` captured with exactly 105 B1, 26 B2 and 26 B3 a
   step, the captured decode equal to the eager loop (24 steps); ms/step,
   tokens/s, the prefill and a profiled step beside their bounds
   (recorded, not gated);
27. (c) its ``GenerationEngine`` (8 slots) under 32 x 64 x 128 at once:
   tokens/s, TTFT p50/p99, slot fill; every request equal to
   ``generate()``;
28. (b) the ring leg: gemma-2-2b's widths at 4 blocks, max_len 16,384,
   batch 1, an 8,160-token prompt and 64 steps, ``ring_cache=True``
   against the same state with full-length caches: tokens and every step's
   codes equal; ms per captured step and KV bytes of both.  In 11, B1, B2
   and B3 are timed at gemma-2-2b's shapes.
29. B5 against its plain version at the decode shapes (M = 8 and 40, at
   gemma-2-2b's Linears with the 256,000-wide head and bench.py's llama
   widths) within 2e-5; DA (``ops/weight_only.s8_matmul``) bit for bit at
   M = 1, 8, 17, 100 and odd K and N, and DAC (``ops/conv.conv2d_s8``) at
   ResNet-50's and the zoo's grouped and depthwise shapes;
30. gpt_tiny, llama_tiny (GQA) and gemma_tiny (window, softcaps) at
   SMALL_DEC's widths in the three weight modes (W8-float, dynamic, W4
   weight-only): on the card against a CPU copy (forward and
   teacher-forced logits within ``FLOAT_RTOL``, argmax agreement), captured
   against eager bit for bit, the engine (llama also chunked and prefixed),
   an m = 5 extend and speculative decoding against ``generate()``, under
   the float contract (equal, or leaving ``generate()`` at a near-tie);
31. gemma-2-2b at its published widths, batch 8, a 64-token prompt, 128
   steps, in each weight mode from one set of FP32 weights: 183 weight
   GEMMs a step (B5 launches, or W8F / DA calls), captured against eager
   over 24 teacher-forced steps, ms per captured step (64 replays between
   CUDA events), tokens/s, the eager loop, the prefill, KV
   bytes, a profiled captured step with its busy split (weight GEMMs,
   float attention, glue) and the step's bound;
32. the W8-float gemma-2-2b served by ``GenerationEngine`` under 32 x 64 x
   128: tokens/s, TTFT, slot fill, each request against ``generate()``;
33. ResNet-50-224 at batch 100 in W8-float and dynamic: images/s, top-1
   agreement with FP32, a CPU copy at batch 2.  In 11, W8F, DA, B5 and the
   float attention are timed at gemma-2-2b's step shapes and DAC at
   ResNet-50's convs, each beside its bound.
34. B1, B2 and B3 bit for bit against their plain versions at Pythia-1.4B's
   and Mixtral's shapes: B1 at qkv 2,048 -> 6,144, proj, fc1 with its gelu
   epilogue, fc2 and the 50,304-wide head (Mixtral's proj and 32,000-wide
   head) at M = 8 and 512; B2 at both merged QKVs; B3 at 16 heads of 128
   over T = 2,048 and at 32 heads over 8 kv heads over T = 4,096, every
   split count, live lengths 1, 128, T - 1;
35. opt_tiny, neox_tiny (parallel and sequential residual), bloom_tiny
   (ALiBi) and moe_tiny (8 experts, dense and sparse dispatch) at
   SMALL_DEC's widths, calibrated on the card, against a CPU copy of their
   converted state bit for bit (prefill codes, 16 teacher-forced steps,
   greedy tokens), the captured decode against the eager loop bit for bit,
   sparse against dense equal; moe_tiny in W8-float against a CPU copy
   within FLOAT_RTOL;
36. NeoX at EleutherAI pythia-1.4b's published widths (``PYTHIA``; weights
   from a ``torch.Generator`` on the card; nothing cut), batch 8, a
   64-token prompt: FP32 forward against its twin on the card, calibrate,
   convert, greedy ``generate(ids, 128)`` captured with exactly 73 B1, 24
   B2 and 24 B3 a step, the captured decode equal to the eager loop, 16
   cached decode steps equal to a full recompute (partial rotary in the
   cache); ms/step, the eager loop, the prefill, the busy split (kernels /
   glue) beside the step's bound (recorded, not gated);
37. its ``GenerationEngine`` (8 slots) under 32 x 64 x 128: tokens/s, TTFT
   p50/p99; every request equal to ``generate()``;
38. the MoE decoder at Mixtral-8x7B-v0.1's widths cut to 4 of 32 blocks and
   max_len 4,096 (``MIXTRAL``), batch 8, a 64-token prompt, 128 tokens:
   captured (dense experts) equal to the eager loop (sparse experts at 8
   tokens), 16 cached steps equal to a full recompute, 5 B1, 4 B2 and 4 B3
   a step; ms/step and the busy split
   (expert GEMMs, router and combine, B1/B2/B3, glue) beside the step's
   bound.  In 11, B1, B2 and B3 at both models' shapes, the MoE experts
   and the ALiBi decode attention (library routes) each beside its bound.
39. B1 and B2 bit for bit against their plain versions at every GEMM of
   the ViT-B/16 and BERT-width forwards at batch 64: the patch stem's conv
   (16 x 16 / 16 over 3 channels) against im2col + ``qgemm_plain``, proj,
   fc1 with its gelu epilogue, fc2, the head, the merged QKV;
40. ViT and the text encoder at dim 256, depth 2 (``SMALL_ENCODERS``),
   calibrated on the card, against a CPU copy of their state: logit codes
   within the contract;
41. the lifecycle levers: AlexNet-224 b100 with its fc3 an FP32 island
   (``convert(skip=)``: 7 B1 and one island a forward, 4 images against a
   CPU copy within the contract), ``QuantAct(backend='lut')`` equal to
   'elementwise' on every code for each activation, a ``bias_correction``
   LeNet calibrated on the card equal to a CPU copy;
42. ViT-B/16 at its published widths (``VIT_B16``; weights from a
   ``torch.Generator`` on the card), batch 64: FP32 forward against its
   twin, calibrate, convert, one INT8 forward with exactly 38 B1, 12 B2 and
   12 composed attentions; INT8 and FP32 ms/batch, images/s, the busy
   split (B1, B2, the composed attention, glue) beside the forward's
   bound; its ``InferenceEngine`` as in 14;
43. the BERT-width text encoder (``BERT_BASE``), batch 64 x 128 tokens, the
   same protocol with 37 B1 and 12 B2 a forward.  In 11, B1 and B2 at both
   encoders' shapes, the composed attention and the FP32 island (library
   routes) each beside its bound;
44. the accuracy levers (``utils``) on AlexNet-224 b100: cross-layer
   equalization over ``ALEX_CLE_PAIRS`` (card = CPU copy bit for bit), then
   prepare, calibrate, AdaRound (``ADAROUND_ARGS``; summed layer-output
   MSE no higher than nearest's), convert and forwards of 8 B1, equal bit
   for bit to B1's plain version; lever seconds, ms/batch and INT8-vs-FP32
   agreement with and without the levers;
45. gemma-2-2b at its published widths in the outlier regime (4 hot
   channels a norm, x30, the consumers' columns /30): no lever, smooth,
   smooth + GPTQ (``GPTQ_ARGS``); smoothing keeps the FP32 logits within
   ``SMOOTH_FP32_RTOL``, the GPTQ sweep over block 1's wq equals a CPU
   sweep given the same inverse Hessian, the captured ``generate`` runs
   4 * depth + 1 B1, depth B2 and depth B3 a step (105, 26 and 26 at the
   published 26 layers, which ``--levers`` runs; the whole run cuts the
   depth to WHOLE_LEVERS_GEMMA_DEPTH) and a prefill and 4 steps give the
   plain path's codes; lever seconds, ms/step and each way's INT8-vs-FP32
   logit error and greedy agreement;
46. the llama legs of 9-10 under GPTQ's 4-bit codes: W4A8 ``generate``
   (B7, 49 B6 and 12 B3 a step; every W4 launch of a prefill and 16 steps
   replayed against its plain version) and the W4 weight-only forward (85
   B5), every Linear's GPTQ output error below ``pack_w4``'s nearest;
47. the dim-256 gemma, llama and text encoder under smooth + GPTQ and LeNet
   under CLE + AdaRound, on the card against a CPU copy handed the card's
   tapped inputs: equal weights and codes where the arithmetic is exact,
   AdaRound's codes equal on at least ``ADAROUND_MIN_EQUAL``;
48. the INT8 artifact (``utils.save`` / ``utils.load``, the JAX package's
   .npz format) of the AlexNet-224 model that 5 converts, loaded into a
   fresh ``zoo.AlexNet()`` on the card: the b100 codes equal bit for bit
   in one forward of exactly 8 B1, ``validate(model, x) == []``, the
   quantization report serialisable to JSON, ``roofline.report`` at the
   H100's peaks with the measured ms (its ``percent_of_sol`` at most 100),
   and ``trace`` + ``device_op_times`` around one forward listing B1 8
   times; the artifact's bytes, save and load seconds;
49. the artifact of the gemma-2-2b model that 26 converts, loaded into a
   fresh ``GemmaDecoder`` on the card: its 128 greedy tokens equal the
   saved model's, with 105 B1, 26 B2 and 26 B3 a step; the artifact's
   bytes, the save and load seconds and the captured ms/step of both;
50. the artifacts of the llama models of 9 and 10: the reloaded W4A8
   model's 128 greedy tokens (49 B6 and 12 B3 a step) and the reloaded W4
   forward (85 B5) equal the saved models', and every B7, B6, B3 and B5
   launch of a teacher-forced prefill and 16 steps and of the W4 forward
   returns the saved model's output bit for bit;
51. every family's Hugging Face checkpoint directory (``utils/hf``): gpt2,
   llama (with qwen2-style q/k/v biases; index-sharded safetensors),
   mistral, gemma2, gpt_neox, phi, opt (``pytorch_model.bin``) and bloom at
   SMALL_DEC's widths, written from seeded weights under the exporters'
   names and layouts, read by ``load_pretrained`` on the card: FP32
   weights equal to the natively named load's bit for bit, then calibrated
   and converted on the card against a CPU copy of the state as in 6; the
   llama also under LLAMA_W4A8 (B6 and B7 launch);
52. gemma-2-2b from an HF directory: phase 26's FP32 weights (drawn again
   from its seed on the card; the head tied to the table, no ``lm_head``)
   written as index-sharded safetensors one shard at a time with the
   published ``config.json``, read by ``load_pretrained`` into a fresh
   model on the card: the window, softcaps and head_dim from the config,
   every FP32 weight equal bit for bit, after phase 26's calibration its
   128 greedy tokens with 105 B1, 26 B2 and 26 B3 a step; the directory's
   bytes, the write and load seconds, the captured ms/step;
53. the refusals: a bfloat16 ``pytorch_model.bin`` raises ``TypeError``
   and a bfloat16 safetensors file reads widened to float32 (both as in
   the JAX package), a directory without weights or without
   ``config.json`` raises ``FileNotFoundError``, an unknown HF key
   ``KeyError``;
54. the native host ops (``int8inferenceengine_tpu_torch/native``): the
   library builds with this machine's g++ (torch's thread count unchanged
   by its OpenMP runtime) and each entry point equals its numpy twin at
   the AlexNet-224 b100 ingest shapes under ``tests/test_hostops.py``'s
   tolerance; ``os.cpu_count()`` and each op's host ms;
55. AlexNet-224 b100 fed by ``DataLoader(resize_to=224, quantize_to=input
   grid, layout_for=model)`` from 2,000 seeded u8 32 x 32 images (20
   batches; the whole run feeds 3): every batch's logits equal the same
   host-quantized batch fed without the pre-layout and a CPU copy's on the
   pre-laid-out batch (8 images), conv1 runs as B1's gathered 3 x 3 / 1
   conv over 48 channels (57 x 57) once a batch and the forward launches 8
   B1; host ms a batch (resize + quantize + space-to-depth), card ms a
   batch (pre-laid-out, u8 without it, float input), the loader's images/s
   alone and pipelined with the forward, the card's idle share over the
   pipelined run;
56. ``InferenceEngine(quantize_ingest=True)`` with tiles of 32 and 100 for
   AlexNet-224 and ResNet-18-224 (tag ('s2d', 7, 2, 3, 3): a 115 x 115 x
   12 input): 200 requests of 1-16 images from 8 threads, every result
   equal to ``model(...)`` bit for bit, every tile replayed as a captured
   graph; images/s and the staged bytes a tile, with and without ingest;
57. ``conv_backend='xla_conv'`` (another name for 'auto') on AlexNet-224
   b100 equal to 'auto' through as many B1 launches, ms a batch of both;
   the bfloat16 conv epilogue (``epilogue_dtype='bfloat16'``): B1's
   gathered-conv instance at AlexNet's five conv geometries and the
   pre-laid-out conv1, G1's at
   MobileNetV2's grouped shapes, bit for bit against their plain versions
   (the whole run runs these checks); AlexNet-224 and MobileNetV2-224 at
   b100 with every conv launch of a forward held against its plain
   version on the same operands, codes equal to a CPU copy's, the share
   of output codes that differ from the float32 epilogue and the largest
   difference, ms a batch of both epilogues;
58. EfficientNet-B0-224 b100 under ``glue_dtype='bfloat16'``: codes equal
   a CPU copy's, every glue layer (fed the float32-glue model's input to
   it) equal to the CPU copy's same layer and within 3 codes of the
   float32 glue's (the JAX package's own bfloat16 glue is 3 codes off at
   the squeeze-excite sigmoids), ms a batch of both; the
   head-split ``decode_attention`` at gpt2's (12 x 64) and llama GQA's
   (12 over 2) decode shapes equal to ``decode_attention_flat`` on the
   same operands, one B3 launch each.

Beside each captured decode ms/step the eager step loop's is timed as
``(t(32) - t(16)) / 16``, one run each.  The last lines are the nvidia-smi
line, one JSON object describing every kernel (and, under
``library_routes``, the weight modes' stock-PyTorch routes), and ``{"ok":
true, "device": {...}}``.  The script imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (dense): int8 and bf16 tensor cores, float32
# outside the tensor cores (the first port's B5 and B7 bound) and HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# the device spin before each timed launch: about 0.2 ms at the H100's
# 1.98 GHz, more than a wrapper's host time (the decode attention wrapper's
# outlasted the 256 MB flush alone)
HOST_LEAD_CYCLES = 400_000

# AlexNet-224 batch-100 GEMMs: (layer, M, K, N); a conv as the GEMM over its
# patch matrix, which the kernel gathers from the NHWC input (ALEXNET_CONVS)
ALEXNET_B100 = [
    ("conv1", 302_500, 363, 96),
    ("conv2", 72_900, 2_400, 256),
    ("conv3", 16_900, 2_304, 384),
    ("conv4", 16_900, 3_456, 384),
    ("conv5", 16_900, 3_456, 256),
    ("fc1", 100, 9_216, 4_096),
    ("fc2", 100, 4_096, 4_096),
    ("fc3", 100, 4_096, 10),
]
# the convs' geometries: (batch, h, w, c_in, kernel, stride, padding)
ALEXNET_CONVS = {"conv1": (100, 224, 224, 3, 11, 4, 2),
                 "conv2": (100, 27, 27, 96, 5, 1, 2),
                 "conv3": (100, 13, 13, 256, 3, 1, 1),
                 "conv4": (100, 13, 13, 384, 3, 1, 1),
                 "conv5": (100, 13, 13, 384, 3, 1, 1)}
RAGGED = [(7, 33, 5), (1, 16, 1), (129, 48, 130), (300, 100, 17),
          (255, 257, 129), (64, 4096, 8), (1000, 64, 1)]
# ragged conv geometries, (batch, h, w, c_in, kernel, stride, padding,
# c_out): batch 1-3, C = 3/16/48/96, odd H and W, stride 1/2/4, padding
# 0/1/2, kernel 1/3/5/11
RAGGED_CONVS = [(1, 9, 7, 16, 3, 2, 1, 20), (2, 11, 13, 3, 5, 2, 2, 33),
                (3, 10, 9, 48, 1, 1, 0, 40), (1, 35, 33, 3, 11, 4, 2, 16),
                (2, 15, 15, 96, 5, 1, 2, 64), (3, 7, 11, 16, 3, 1, 0, 24),
                (1, 5, 5, 96, 5, 1, 2, 8), (2, 31, 29, 48, 3, 2, 1, 130)]
# the narrow-grid path (16- and 64-row tiles, K split over a cluster):
# (M, K, N) at M = 1, 8, 16, 100
NARROW = [(1, 768, 50_257), (1, 4_096, 10), (8, 3_072, 768),
          (8, 768, 3_072), (16, 9_216, 4_096), (16, 768, 768),
          (100, 4_096, 10), (100, 9_216, 4_096), (100, 4_096, 4_096)]

# gpt2-small-ish decode (bench.py's decode leg): the geometry, the batch,
# the prompt and the two generate lengths of the ms/step protocol
GPT = dict(vocab_size=50257, max_len=512, dim=768, depth=12, heads=12)
DEC_BATCH, DEC_PROMPT, DEC_STEPS, DEC_SHORT = 8, 64, 128, 16
# one decode step's B1 launches: (layer, M, K, N, launches per step, act)
DEC_GEMMS = [("proj", 8, 768, 768, 12, None),
             ("fc1+gelu", 8, 768, 3072, 12, "gelu"),
             ("fc2", 8, 3072, 768, 12, None),
             ("head", 8, 768, 50257, 1, None)]
# its B2 launches (M, K, per-head N, launches per step)
DEC_QKV = (8, 768, 768, 12)
# its B3 launches; the live length is the mean over generate(ids, 128)
# after a 64-token prompt (65 ... 191)
DEC_ATTN = dict(b=8, t=512, h=12, d=64, valid=128, launches=12)
# B3's checks: (T, H, Hkv, mq, window, softcap, every split count) at B=8,
# D=64, over the live lengths that fit (and T - mq + 1) and a per-sequence
# vector; GQA 12/2 with 4 query positions at T = 4096 needs the split's
# shared memory (one share's scores, not all of T's)
ATTN_CASES = [(512, 12, 12, 1, None, None, True),
              (512, 12, 2, 1, None, None, True),
              (512, 12, 4, 1, None, None, False),
              (512, 12, 12, 4, None, None, False),
              (512, 12, 12, 1, 128, None, False),
              (512, 12, 12, 1, None, 30.0, False),
              (512, 12, 2, 4, 128, 30.0, True),
              (4096, 12, 2, 4, None, None, True),
              (4096, 12, 12, 1, None, None, False),
              (4096, 12, 2, 1, 1000, 30.0, False)]
ATTN_LIVE = (1, 77, 128, 511, 4000)
PIECEWISE = ("relu", "relu6", "hardsigmoid", "hardswish")
# output range of each activation over inputs in [-5, 5]: the act grid
ACT_RANGE = {"relu": (0.0, 5.0), "relu6": (0.0, 6.0),
             "hardsigmoid": (0.0, 1.0), "hardswish": (-0.375, 5.0),
             "sigmoid": (0.0, 1.0), "silu": (-0.28, 5.0),
             "gelu": (-0.17, 5.0)}
ATTN_PARAMS = dict(scale_q=0.021, zp_q=117, scale_k=0.034, zp_k=131,
                   scale_v=0.027, zp_v=125, scale_s=0.4, zp_s=140,
                   scale_p=0.0039, zp_p=0, scale_c=0.05, zp_c=128,
                   alpha=0.125)
# the decoder's codes, kernel path vs plain path, teacher-forced
MAX_CODE_DIFF, MAX_SHARE_DIFF = 2, 0.01
# the eager step loop's ms/step: (t(32) - t(16)) / 16, one run each; and
# gemma-2-2b's captured-vs-eager gate over 24 teacher-forced steps (an eager
# gemma-2-2b step takes ~0.1 s)
EAGER_STEPS = (16, 32)
GEMMA_CAPTURED_STEPS = 24

# bench.py's W4A8 llama leg (bench.py:258-293): geometry and config; the
# batch and prompt are the decoder's (DEC_BATCH, DEC_PROMPT)
LLAMA = dict(vocab_size=32000, max_len=512, dim=768, depth=12, heads=12,
             kv_heads=2)
LLAMA_W4A8 = dict(rounding="nearest", weight_bits=4, w4_group=256)
LLAMA_W4 = dict(weight_only=True, weight_bits=4)          # group 128
# one decode step's B6 launches: (layer, M, K, N, launches per step)
W4_DECODE = [("qkv", 8, 768, 1024, 12), ("proj", 8, 768, 768, 12),
             ("gate+up", 8, 768, 4096, 12), ("down", 8, 2048, 768, 12),
             ("head", 8, 768, 32000, 1)]
# B6 over the rest of its envelope's batch sizes (checked and swept)
W4_DECODE_M = [(f"proj M={m}", m, 768, 768, 0) for m in (16, 64, 128)]
# the prefill's B7 launches at M = 8 x 64: (layer, M, K, N, launches,
# per-column mult), the merged calls carry one mult per column
W4_PREFILL = [("qkv", 512, 768, 1024, 12, True),
              ("proj", 512, 768, 768, 12, False),
              ("gate+up", 512, 768, 4096, 12, True),
              ("down", 512, 2048, 768, 12, False),
              ("head", 512, 768, 32000, 1, False)]
# the weight-only forward's B5 launches at M = 8 x 64, group 128
W4_FORWARD = [("wq", 512, 768, 768, 12), ("wk", 512, 768, 128, 12),
              ("wv", 512, 768, 128, 12), ("proj", 512, 768, 768, 12),
              ("gate", 512, 768, 2048, 12), ("up", 512, 768, 2048, 12),
              ("down", 512, 2048, 768, 12), ("head", 512, 768, 32000, 1)]
# the llama decode's B3 launches (Hkv = 2)
LLAMA_ATTN = dict(b=8, t=512, h=12, hkv=2, d=64, valid=128, launches=12)
# B5's contract against its plain version, relative to the largest |output|
W4_RTOL = 2e-5
# the decoders on the card against a CPU copy: small models of both
# families (the llama W4A8 one with 2 kv heads), batch, prompt and steps,
# and the reference's contract (at most 1 code off on at most 0.2%)
SMALL_DEC = dict(vocab_size=4096, max_len=128, dim=256, depth=2, heads=4)
SMALL_BATCH, SMALL_PROMPT, SMALL_STEPS = 4, 16, 16
CPU_MAX_CODE, CPU_MAX_SHARE = 1, 0.002
# the legs: (family, batch, extra geometry, gated).  Batch 4 is the gate's
# own size; gpt2 at batch 8 is where a float32 LayerNorm mean and the
# card's rsqrt once moved a code (repaired: the norms' means and rsqrt, and
# every exp and erfc, run in float64 and round once); the llama at batch 8
# with a 768-wide MLP runs every W4A8 GEMM through B6 (exact on both
# sides).  At batch 4 a 768-wide MLP's decode runs B7, whose CPU path
# is its float32 plain version (B7's contract exception, not the glue's):
# recorded, not gated.
CPU_GATE_LEGS = [("gpt2", 4, {}, True), ("llama_w4a8", 4, {}, True),
                 ("gpt2", 8, {}, True),
                 ("llama_w4a8", 8, {"mlp_hidden": 768}, True),
                 ("llama_w4a8", 4, {"mlp_hidden": 768}, False)]
# the full-context forwards: the batch at the model's max_len
FULL_CONTEXT = (DEC_BATCH, LLAMA["max_len"])

# gemma-2-2b at its published widths (Hugging Face google/gemma-2-2b,
# config.json, model_type gemma2): vocab 256,000, 8,192 positions, dim 2,304,
# 26 blocks, 8 heads over 4 kv heads of 256, MLP 9,216, window 4,096 on the
# local (odd) blocks, softcaps 50 / 30, eps 1e-6, rope_theta 10,000; weights
# random from a torch.Generator on the card.  'nearest', the JAX package's
# gemma configuration (the sandwich norms add requant boundaries)
GEMMA2 = dict(vocab_size=256_000, max_len=8192, dim=2304, depth=26, heads=8,
              kv_heads=4, head_dim=256, mlp_hidden=9216, sliding_window=4096,
              attn_softcap=50.0, final_softcap=30.0, eps=1e-6,
              rope_base=10000.0)
GEMMA_CFG = dict(rounding="nearest")
# a gemma-2-2b step's B1 launches (layer, K, N, launches per step or
# prefill), its merged QKV (B2: K, per-head N, launches) and B3 at batch 8
GEMMA_GEMMS = [("proj", 2048, 2304, 26), ("gate", 2304, 9216, 26),
               ("up", 2304, 9216, 26), ("down", 9216, 2304, 26),
               ("head", 2304, 256_000, 1)]
GEMMA_QKV = (2304, (2048, 1024, 1024), 26)
# B3's checks at gemma-2's attention: (batch, T, every split count), the
# live lengths around the window's edge (and T - 1, T)
GEMMA_ATTN_CASES = [(8, 8192, True), (2, 16384, False)]
GEMMA_ATTN_LIVE = (1, 4095, 4096, 4097, 8191)
# B3 timed: the step (live 128 of 8,192: the mean over generate(ids, 128)
# after a 64-token prompt) with a full window beside it, and one local layer
# of the ring leg on its 8,192-row ring and on a full-length 16,384-row cache
_GEMMA_ATTN = dict(h=8, hkv=4, d=256, window=4096, softcap=50.0)
GEMMA_ATTN_TIMED = [
    (dict(_GEMMA_ATTN, b=8, t=8192, valid=128, launches=26),
     "gemma2_2b_decode_step", "attention"),
    (dict(_GEMMA_ATTN, b=1, t=8192, valid=4128, launches=0),
     "gemma2_2b_decode_step", "ring leg, local layer on its ring"),
    (dict(_GEMMA_ATTN, b=1, t=16384, valid=8192, launches=0),
     "gemma2_2b_decode_step", "ring leg, local layer on a full cache")]
# the ring leg: gemma-2-2b's widths at 4 blocks (2 local, 2 global), batch
# 1, max_len raised to 16,384 (at the published 8,192 the ring's
# roundup32(2 x 4,096) = 8,192 rows are no fewer than max_len): an
# 8,160-token prompt and 64 steps; the local layers' base moves at 8,192
RING = dict(GEMMA2, depth=4, max_len=16384)
RING_PROMPT, RING_STEPS = 8160, 64
# the windowed families' small card-vs-CPU gate and ring engines: window 32
# (64 ring rows; the base moves at 64, 96, 128), a 16-token prompt, 120 steps
SMALL_RING = dict(vocab_size=4096, max_len=256, dim=256, depth=2, heads=4,
                  kv_heads=2, sliding_window=32, ring_cache=True)
SMALL_RING_STEPS = 120

KERNEL_INFO = {
    "qgemm_u8s8": dict(
        source="int8inferenceengine_tpu_torch/csrc/qgemm_int8.cu",
        replaces="int8inferenceengine_tpu/ops/gemm_int8.py:111"),
    "qgemm_u8s8_vzp": dict(
        source="int8inferenceengine_tpu_torch/csrc/qgemm_int8.cu",
        replaces="int8inferenceengine_tpu/ops/gemm_int8.py:422"),
    "decode_attn_flat": dict(
        source="int8inferenceengine_tpu_torch/csrc/decode_attn.cu",
        replaces="int8inferenceengine_tpu/ops/attention.py:417",
        also_replaces="int8inferenceengine_tpu/ops/attention.py:214"),
    "w4_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:116"),
    "w4a8_v2_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:357"),
    "w4a8_v1_gemm": dict(
        source="int8inferenceengine_tpu_torch/csrc/w4_gemm.cu",
        replaces="int8inferenceengine_tpu/ops/w4.py:247"),
    # a kernel of the port that the JAX package leaves to XLA: its native
    # grouped integer conv, no pallas_call
    "conv_grouped_u8s8": dict(
        source="int8inferenceengine_tpu_torch/csrc/conv_grouped.cu",
        replaces="int8inferenceengine_tpu/ops/conv.py:111",
        tpu_kernel=None),
}


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def mark(label: str) -> None:
    """A phase's end: seconds since the script started and the card's
    allocated and reserved memory."""
    import torch
    log(json.dumps({"mark": label,
                    "t_s": round(time.perf_counter() - T_START, 1),
                    "gib_allocated": torch.cuda.memory_allocated() / 2**30,
                    "gib_reserved": torch.cuda.memory_reserved() / 2**30}))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak: float = PEAK_INT8_OPS):
    """Least time on the card (ms): the bytes at the HBM rate vs the
    operations at ``peak`` (the int8 tensor-core peak unless given), and
    which one bounds."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations"), t_ops, t_bytes


def bound_ms(m: int, k: int, n: int, vectors: int = 2):
    """A GEMM's bound: operands read once, output written once (a u8, w s8,
    ``vectors`` 4-byte [N] epilogue vectors, out u8)."""
    return bound(m * k + n * k + 4 * vectors * n + m * n, 2.0 * m * n * k)


def attn_bound_ms(b, h, hkv, d, valid, mq=1):
    """Decode attention's bound: q, the live k/v rows and the output moved
    once; QK^T and P@V as int8 operations."""
    nbytes = 2 * b * mq * h * d + 2 * b * valid * hkv * d + 4 * b
    return bound(nbytes, 4.0 * b * mq * h * valid * d)


def w4_bound_ms(kernel: str, m: int, k: int, n: int, group: int,
                simt: bool = False):
    """A 4-bit GEMM's bound: the packed weight (K/2 bytes a row), its f32
    group scales, the activations (u8, or f32 for B5), two f32 [N] vectors
    (mult and zpb, or the bias for B5) and the output (u8, or f32 for B5),
    each moved once; the operations: 2MNK int8 tensor-core ones for B6 and
    B7 (their products are integers), three bf16 passes (3 x 2MNK at the
    bf16 peak) for B5.  ``simt``: the first port's bound for B5 and B7,
    2MNK true f32 operations at the non-tensor-core peak."""
    g = min(group, k)
    x_bytes, out_bytes = (4, 4) if kernel == "w4_gemm" else (1, 1)
    vectors = 1 if kernel == "w4_gemm" else 2
    nbytes = (n * k // 2 + 4 * n * -(-k // g) + x_bytes * m * k
              + 4 * vectors * n + out_bytes * m * n)
    ops = 2.0 * m * n * k
    if simt:
        return bound(nbytes, ops, PEAK_FP32_OPS)
    if kernel == "w4_gemm":
        return bound(nbytes, 3 * ops, PEAK_BF16_OPS)
    return bound(nbytes, ops, PEAK_INT8_OPS)


def contract(torch, got, want):
    """(max |code difference|, share of codes that differ)."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int(d.max()), float((d > 0).float().mean())


def gemm_case(torch, gen, m, k, n, dev):
    """Random operands; the output scale puts the codes mid-range."""
    a = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8,
                      device=dev)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8,
                      device=dev)
    q_bias = torch.randint(-127, 128, (n,), generator=gen, dtype=torch.int8,
                           device=dev)
    s_w_pc = (torch.rand((n,), generator=gen, device=dev) * 0.015 + 0.005)
    acc_std = 74.0 * 73.6 * math.sqrt(k)
    return dict(a=a, w=w, q_bias=q_bias, s_w_pc=s_w_pc, s_a=0.02, zp_a=131,
                s_c=0.02 * 0.01 * acc_std / 60.0, zp_c=110)


def rowsum(torch, w):
    return w.to(torch.int32).sum(1, dtype=torch.int32)


def act_grid(fn: str):
    """(name, act_scale, act_zp) spanning ``fn``'s outputs over [-5, 5]."""
    lo, hi = ACT_RANGE[fn]
    act_scale = (hi - lo) / 255.0
    return fn, act_scale, int(round(-lo / act_scale))


def time_cuda(torch, fn, iters: int, flush=None) -> float:
    """Mean ms of ``fn`` over ``iters`` launches, each timed with CUDA
    events.  ``flush`` (run outside the timed span) evicts the L2 cache;
    a device-side spin after it keeps the card busy while the host runs the
    wrapper's Python, so that the span holds the device work alone."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        if flush is not None:
            flush()
            torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def he_state(torch, twin, seed: int):
    """He-scaled random weights from numpy's default_rng(seed) (AlexNet,
    VGG and the BN-free CNN families)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, p in twin.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)
        else:
            v = rng.standard_normal(shape) * 0.05
        state[key] = torch.tensor(v.astype(np.float32))
    return state


def decoder_state(torch, twin, depth: int, seed: int,
                  residual=("proj", "fc2")):
    """GPT-2-style random weights from numpy's default_rng(seed): N(0, 0.02)
    for Linear weights and embeddings (0.02/sqrt(2*depth) for the residual
    projections, proj/fc2 or the llama's proj/down), N(0, 0.01) positions
    and biases, LayerNorm and RMSNorm gains 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, p in twin.state_dict().items():
        z = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        if key.startswith("ln"):
            v = 1.0 + 0.02 * z if key.endswith("weight") else 0.02 * z
        elif key.endswith("bias") or key == "pe.weight":
            v = 0.01 * z
        elif key.startswith(residual):
            v = (0.02 / math.sqrt(2 * depth)) * z
        else:
            v = 0.02 * z
        state[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return state


def profile_rows(torch, prof):
    """Device-side rows (kernels, memcpy, memset), largest first: the aten
    op rows repeat their kernels' time, and a schedule's ``ProfilerStep``
    annotation spans them."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return rows


# -- phase 3: B1 against its plain version at the AlexNet shapes -------------

def plan_of(G, m, n, k, dev, conv=None):
    """The kernel's plan for a launch, as printed in the per-shape lines."""
    p = G.plan_qgemm(m, n, k, conv=conv, sms=G.sm_count(dev))
    return dict(variant=p.variant, tile=list(p.tile), slices=p.slices,
                k_slice=p.k_slice, loader=p.loader)


def check_alexnet_kernel(torch, G, gen, dev):
    """B1 (the GEMM variant) at the AlexNet shapes, ragged shapes and the
    narrow-grid shapes (M = 1, 8, 16, 100, split over K)."""
    max_err = 0
    n_cases = 0
    for shape in [s[1:] for s in ALEXNET_B100] + RAGGED + NARROW:
        m, k, n = shape
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        spread = None
        for order in G.DENSE_ORDERS:
            for per_channel in (False, True):
                s_w = c["s_w_pc"] if per_channel else 0.01
                ep = G.epilogue_vector(c["s_a"], s_w, c["s_c"], n, dev, order)
                for rounding in ("trunc", "nearest"):
                    for relu in (False, True):
                        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"],
                                  zp_c=c["zp_c"], relu=relu,
                                  rounding=rounding, order=order)
                        got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                        want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                        torch.cuda.synchronize()
                        err = int((got.to(torch.int32) - want.to(torch.int32)
                                   ).abs().max())
                        max_err = max(max_err, err)
                        n_cases += 1
                        if err:
                            bad = int((got != want).sum())
                            fail(f"qgemm kernel != plain at M={m} K={k} N={n} "
                                 f"order={order} per_channel={per_channel} "
                                 f"rounding={rounding} relu={relu}: {bad} "
                                 f"codes differ, max {err}")
                        if spread is None:
                            spread = int(torch.unique(want).numel())
        log(json.dumps({"phase": "kernel_vs_plain", "M": m, "K": k, "N": n,
                        "plan": plan_of(G, m, n, k, dev), "cases": 16,
                        "distinct_codes": spread, "max_abs_err": 0}))
    log(json.dumps({"phase": "kernel_vs_plain", "cases": n_cases,
                    "max_abs_err": max_err}))
    return max_err


def conv_case(torch, gen, geom, c_out, dev):
    """A u8 NHWC input and the conv's operands as for ``gemm_case``."""
    b, h, w, c, k = geom[:5]
    x = torch.randint(0, 256, (b, h, w, c), generator=gen, dtype=torch.uint8,
                      device=dev)
    return x, gemm_case(torch, gen, 1, k * k * c, c_out, dev)


def check_gathered_conv(torch, G, C, gen, dev):
    """The gathered conv (B1's conv variant, through ``conv2d_int8_gemm`` on
    the card) against im2col + ``qgemm_plain``, bit for bit, at the five
    AlexNet b100 geometries and ragged ones, over the three epilogue
    orders (the bfloat16 one included), both roundings, relu on/off and
    per-tensor and per-channel s_w."""
    geoms = [(ALEXNET_CONVS[layer], n) for layer, _, _, n in ALEXNET_B100
             if layer in ALEXNET_CONVS]
    geoms += [(g[:7], g[7]) for g in RAGGED_CONVS]
    n_cases = 0
    for geom, n in geoms:
        b, h, w, c, k, stride, pad = geom
        x, cs = conv_case(torch, gen, geom, n, dev)
        oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                              cs["s_a"], cs["zp_a"], recentered=True)
        g = G.ConvGeom(b, h, w, c, k, k, stride, pad)
        m, kk = g.gemm_shape
        plan = plan_of(G, m, n, kk, dev, conv=g)
        if plan["variant"] != "conv":
            fail(f"conv {geom} is not planned as a gathered conv: {plan}")
        spread = None
        for order in G.ORDERS:
            for per_channel in (False, True):
                s_w = cs["s_w_pc"] if per_channel else 0.01
                ep = G.epilogue_vector(cs["s_a"], s_w, cs["s_c"], n, dev,
                                       order)
                for rounding in ("trunc", "nearest"):
                    for relu in (False, True):
                        kw = dict(kh=k, kw=k, stride=stride, padding=pad,
                                  scale_a=cs["s_a"], zp_a=cs["zp_a"],
                                  scale_c=cs["s_c"], zp_c=cs["zp_c"],
                                  relu=relu, rounding=rounding, order=order)
                        before = G.qgemm.launches
                        got = C.conv2d_int8_gemm(x, cs["w"], oc, ep, **kw)
                        launched = G.qgemm.launches - before
                        want = C.conv2d_int8_gemm(x, cs["w"], oc, ep,
                                                  gemm=G.qgemm_plain, **kw)
                        torch.cuda.synchronize()
                        n_cases += 1
                        if launched != 1 or not torch.equal(got, want):
                            fail(f"gathered conv != im2col + plain at {geom} "
                                 f"N={n} order={order} per_channel="
                                 f"{per_channel} rounding={rounding} relu="
                                 f"{relu}: {int((got != want).sum())} codes "
                                 f"differ, {launched} launches")
                        if spread is None:
                            spread = int(torch.unique(want).numel())
        log(json.dumps({"phase": "gathered_conv_vs_plain", "geometry": geom,
                        "N": n, "M": m, "K": kk, "plan": plan,
                        "cases": 8 * len(G.ORDERS),
                        "distinct_codes": spread, "max_abs_err": 0}))
        del x, cs
    log(json.dumps({"phase": "gathered_conv_vs_plain", "cases": n_cases,
                    "max_abs_err": 0}))


# -- phase 4: the decoder's kernels against their plain versions ------------

def check_decoder_kernels(torch, G, A, gen, dev):
    """Returns {kernel: max |code difference|} over every case."""
    err = {"qgemm_u8s8": 0, "qgemm_u8s8_vzp": 0, "decode_attn_flat": 0}
    for fn in G.KERNEL_ACTS:
        worst = (0, 0.0)
        for m, k, n in [(8, 768, 3072), (512, 768, 3072), (37, 100, 61)]:
            c = gemm_case(torch, gen, m, k, n, dev)
            oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]),
                                  c["s_a"], c["zp_a"], recentered=True)
            # scale s_w and s_c alike: the same codes, dequantized to [-5, 5]
            f = 5.0 / (110 * c["s_c"])
            ep = G.epilogue_vector(c["s_a"], c["s_w_pc"] * f, c["s_c"] * f,
                                   n, dev, "gemm")
            for rounding in ("trunc", "nearest"):
                kw = dict(scale_a=c["s_a"], scale_c=c["s_c"] * f,
                          zp_c=c["zp_c"], rounding=rounding, act=act_grid(fn))
                got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                torch.cuda.synchronize()
                mx, share = contract(torch, got, want)
                worst = max(worst, (mx, share))
                if (fn in PIECEWISE and mx) or mx > 1 or share > 0.002:
                    fail(f"qgemm act={fn} kernel != plain at M={m} K={k} "
                         f"N={n} {rounding}: max {mx}, share {share}")
        err["qgemm_u8s8"] = max(err["qgemm_u8s8"], worst[0])
        log(json.dumps({"phase": "act_kernel_vs_plain", "act": fn,
                        "plan_at_M8": plan_of(G, 8, 3072, 768, dev),
                        "max_abs_err": worst[0], "share_differing": worst[1],
                        "contract": "exact" if fn in PIECEWISE
                        else "<=1 code on <=0.2%"}))

    check_b2(torch, G, gen, dev, [(8, 768, (768, 768, 768)),
                                  (512, 768, (768,) * 3),
                                  (37, 100, (13, 50, 7)),
                                  (1, 48, (130, 1, 64))])
    for case in ATTN_CASES:
        t, mq = case[0], case[3]
        lives = [x for x in ATTN_LIVE if x <= t - mq + 1] + [t - mq + 1]
        err["decode_attn_flat"] = max(
            err["decode_attn_flat"],
            check_attention(torch, A, gen, dev, DEC_ATTN["b"], DEC_ATTN["d"],
                            case, lives, ATTN_PARAMS, "attn_kernel_vs_plain"))
    return err


def check_b2(torch, G, gen, dev, cases):
    """B2 (the merged QKV GEMM) bit for bit against its plain version at
    each (M, K, per-head widths) of ``cases``, both roundings, one head
    with per-channel weight scales."""
    for m, k, widths in cases:
        parts = []
        for i, n in enumerate(widths):
            c = gemm_case(torch, gen, m, k, n, dev)
            parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                              rowsum=rowsum(torch, c["w"]),
                              scale_w=c["s_w_pc"] if i == 1 else 0.01,
                              scale_c=c["s_c"] * (1 + 0.3 * i),
                              zp_c=100 + 20 * i))
        merged = G.merge_parts(parts, scale_a=c["s_a"], zp_a=c["zp_a"])
        for rounding in ("trunc", "nearest"):
            got = torch.cat(G.qgemm_multi(c["a"], merged, rounding=rounding),
                            1)
            want = torch.cat(G.qgemm_multi_plain(c["a"], merged,
                                                 rounding=rounding), 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"qgemm_multi kernel != plain at M={m} K={k} "
                     f"N={widths} {rounding}: "
                     f"{int((got != want).sum())} codes differ")
        log(json.dumps({"phase": "vzp_kernel_vs_plain", "M": m, "K": k,
                        "N": list(widths), "max_abs_err": 0,
                        "plan": plan_of(G, m, sum(widths), k, dev),
                        "distinct_codes": int(torch.unique(got).numel())}))
        del parts, merged, got, want


def check_attention(torch, A, gen, dev, b, d, case, lives, params, label,
                    exact=False):
    """B3/B4 against the composed plain version at one ``case`` (T, H,
    Hkv, mq, window, softcap, every split count) of batch ``b`` and head
    width ``d``: each live length of ``lives`` and a per-sequence vector,
    both roundings, under ``plan_decode_attn``'s split and, where asked,
    every other split count; within the contract, or bit for bit where
    ``exact``.  Returns the largest code difference."""
    t, h, kv, mq, window, softcap, every_split = case
    qshape = (b, mq, h * d) if mq > 1 else (b, h * d)
    q = torch.randint(0, 256, qshape, generator=gen, dtype=torch.uint8,
                      device=dev)
    k = torch.randint(0, 256, (b, t, kv * d), generator=gen,
                      dtype=torch.uint8, device=dev)
    v = torch.randint(0, 256, (b, t, kv * d), generator=gen,
                      dtype=torch.uint8, device=dev)
    per_seq = torch.randint(1, t - mq + 2, (b,), generator=gen,
                            dtype=torch.int32, device=dev)
    kw = dict(params, n_heads=h, n_kv_heads=kv, window=window,
              softcap=softcap)
    chosen = A.plan_decode_attn(b, t, h, kv, d, mq)
    plans = [chosen] + ([A.decode_attn_plan(sp, mq, h // kv, t, d)
                         for sp in range(1, A.MAX_SPLITS + 1)
                         if sp != chosen.splits] if every_split else [])
    plans = [p for p in plans if p.smem <= A.SMEM_LIMIT]
    worst = (0, 0.0)
    for plan in plans:
        for valid in lives + [per_seq]:
            for rounding, merged in (("trunc", True), ("nearest", False)):
                got = A.decode_attention_flat(q, k, v, valid,
                                              rounding=rounding,
                                              merged=merged, plan=plan, **kw)
                want = A.decode_attention_flat(q, k, v, valid, backend="xla",
                                               rounding=rounding, **kw)
                torch.cuda.synchronize()
                mx, share = contract(torch, got, want)
                worst = max(worst, (mx, share))
                if mx > CPU_MAX_CODE or share > CPU_MAX_SHARE or \
                        (exact and mx):
                    fail(f"decode attention kernel != plain at B={b} T={t} "
                         f"H={h} Hkv={kv} D={d} mq={mq} window={window} "
                         f"softcap={softcap} {plan} valid="
                         f"{valid if isinstance(valid, int) else 'per-seq'}"
                         f" {rounding}: max {mx}, share {share}")
    log(json.dumps({"phase": label, "B": b, "T": t, "H": h, "Hkv": kv,
                    "D": d, "mq": mq, "window": window, "softcap": softcap,
                    "valid": lives + ["per-seq"], "plan": chosen._asdict(),
                    "splits_checked": [p.splits for p in plans],
                    "max_abs_err": worst[0], "share_differing": worst[1]}))
    return worst[0]


# -- phase 8: the 4-bit kernels against their plain versions ----------------

def w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=False,
            weight_only=False, wide=False):
    """Random operands of a 4-bit GEMM: N(0, 0.02) weights packed with the
    MSE scale search (the config's default), f32 N(0, 1) activations for B5
    (``wide``: magnitudes 2^U(-60, 60), random signs) or u8 codes whose
    output grid puts the results mid-range for B6/B7 (``vector_mult``: one
    mult per column, as a merged call has)."""
    w = torch.randn((n, k), generator=gen, device=dev) * 0.02
    packed, scales = W.pack_w4(w, group, optimize=True)
    bias = torch.randn((n,), generator=gen, device=dev) * 0.01
    if weight_only:
        x = torch.randn((m, k), generator=gen, device=dev)
        if wide:
            e = torch.rand((m, k), generator=gen, device=dev) * 120 - 60
            x = torch.sign(x) * torch.exp2(e)
        return dict(x=x, packed=packed, scales=scales, bias=bias, k=k,
                    group=group)
    x = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8,
                      device=dev)
    s_x, zp_x = 0.02, 117
    s_out = float(np.float32(s_x * 74.0 * 0.02 * math.sqrt(k) / 40.0))
    mult = float(np.float32(s_x) / np.float32(s_out))
    if vector_mult:
        mult = mult * (1.0 + 0.3 * torch.rand((n,), generator=gen,
                                               device=dev))
    zpb = torch.full((), 128.0, device=dev) + bias / torch.full(
        (), s_out, device=dev)
    ops = W.w4a8_operands(packed, scales, zpb, k, group, zp_x=zp_x,
                          mult=mult)
    return dict(x=x, ops=ops)


def v2_plain(W, x, ops, rounding="trunc"):
    """B6's plain version on a wrapper's operands."""
    return W.w4a8_v2_plain(x, ops["packed"], ops["scales_t"], ops["mult_v"],
                           ops["zpb_eff"], ops["k"], ops["group"], rounding)


def v1_plain(W, x, ops, rounding="trunc"):
    """B7's plain version on a wrapper's operands."""
    return W.w4a8_v1_plain(x, ops["packed"], ops["scales"], ops["zpb"],
                           ops["k"], ops["group"], zp_x=ops["zp_x"],
                           mult=ops["mult_v"], rounding=rounding)


def rel_err(torch, got, want) -> float:
    """max |got - want| over the largest |want| (B5's contract)."""
    return float((got - want).abs().max() / want.abs().max())


def check_b7(torch, W, b7, x, ops, rounding, what):
    """B7 (the wrapper ``b7``) on the card, bit for bit B6's plain
    arithmetic and within the code contract of its own plain version;
    returns (codes, max, share) of the latter."""
    got = b7(x, ops, rounding)
    exact = v2_plain(W, x, ops, rounding)
    mx, share = contract(torch, got, v1_plain(W, x, ops, rounding))
    if not torch.equal(got, exact):
        fail(f"B7 {what} {rounding}: {int((got != exact).sum())} codes "
             f"differ from w4a8_v2_plain")
    if mx > 1 or share > 0.002:
        fail(f"B7 {what} {rounding}: max {mx}, share {share} against "
             f"w4a8_v1_plain")
    return got, mx, share


def w4_plan(plan):
    """B6's plan, as printed in the per-shape lines."""
    return dict(tile=list(plan.tile), orientation=plan.orientation,
                slices=plan.slices, k_slice=plan.k_slice)


# groups off the 32-value k-step (a boundary inside a chunk, several groups
# in one chunk, a short last group), M = 1: B5 and B7 alike
W4_EDGE = [("edge", 16, 96, 40, 48), ("edge", 5, 200, 40, 48),
           ("edge", 3, 40, 24, 10), ("edge", 1, 768, 1024, 256)]


def check_w4_kernels(torch, W, gen, dev):
    """B6 exactly, B7 exactly against B6's plain arithmetic and within the
    code contract of its own, B5 within W4_RTOL of the largest |output|, at
    every shape the llama legs launch and at ragged and edge ones; returns
    {kernel: max |difference|}."""
    err = {"w4a8_v2_gemm": 0, "w4a8_v1_gemm": 0, "w4_gemm": 0.0}
    v2_cases = [(name, m, k, n, 256, name in ("qkv", "gate+up"))
                for name, m, k, n, _ in W4_DECODE + W4_DECODE_M]
    v2_cases += [("ragged", 16, 96, 70, 32, False),
                 ("ragged", 64, 768, 768, 128, True),
                 ("ragged", 24, 256, 200, 32, True)]
    for name, m, k, n, group, vec in v2_cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec)
        chosen = W.plan_w4a8_v2(m, n, k, group, sms=W.sm_count(dev))
        # the planner's plan, and its tile at every K split the kernel runs
        plans = [chosen] + [chosen._replace(slices=sl, k_slice=k // sl)
                            for sl in W.v2_slice_counts(k, group)
                            if sl != chosen.slices]
        for plan in plans:
            for rounding in ("trunc", "nearest"):
                got = W.w4a8_v2(c["x"], c["ops"], rounding, plan=plan)
                want = v2_plain(W, c["x"], c["ops"], rounding)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"B6 kernel != plain at {name} M={m} K={k} N={n} "
                         f"group={group} {plan} {rounding}: "
                         f"{int((got != want).sum())} codes differ")
        log(json.dumps({"phase": "w4a8_v2_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "per_column_mult": vec, "plan": w4_plan(chosen),
                        "slices_checked": sorted(p.slices for p in plans),
                        "max_abs_err": 0,
                        "distinct_codes": int(torch.unique(want).numel())}))

    v1_cases = [(name, m, k, n, 256, vec)
                for name, m, k, n, _, vec in W4_PREFILL]
    v1_cases += [(name, m, k, n, 256, not vec)
                 for name, m, k, n, _, vec in W4_PREFILL if name != "head"]
    v1_cases += [("ragged", 37, 200, 61, 128, True),
                 ("ragged", 1, 48, 130, 256, False),
                 ("ragged", 300, 768, 17, 256, True)]
    v1_cases += [(*e, True) for e in W4_EDGE]
    for name, m, k, n, group, vec in v1_cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec)
        worst = (0, 0.0)
        for rounding in ("trunc", "nearest"):
            got, mx, share = check_b7(
                torch, W, W.w4a8_v1, c["x"], c["ops"], rounding,
                f"at {name} M={m} K={k} N={n} group={group}")
            worst = max(worst, (mx, share))
        err["w4a8_v1_gemm"] = max(err["w4a8_v1_gemm"], worst[0])
        log(json.dumps({"phase": "w4a8_v1_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "per_column_mult": vec, "equal_to_v2_plain": True,
                        "max_abs_err_vs_v1_plain": worst[0],
                        "share_differing_vs_v1_plain": worst[1],
                        "distinct_codes": int(torch.unique(got).numel())}))

    b5_cases = [(name, m, k, n, 128, False)
                for name, m, k, n, _ in W4_FORWARD]
    b5_cases += [("ragged", 37, 200, 61, 128, False),
                 ("ragged", 1, 48, 130, 128, False)]
    b5_cases += [(*e, False) for e in W4_EDGE]
    b5_cases += [("wide range", 512, 768, 768, 128, True)]
    err["w4_gemm"] = check_b5(torch, W, gen, dev, b5_cases)
    return err


def check_b5(torch, W, gen, dev, cases):
    """B5 within W4_RTOL of the largest |output| of its plain version at
    ``cases`` (name, M, K, N, group, wide x); returns the largest
    |difference|."""
    err = 0.0
    for name, m, k, n, group, wide in cases:
        c = w4_case(torch, W, gen, m, k, n, group, dev, weight_only=True,
                    wide=wide)
        args = (c["x"], c["packed"], c["scales"], c["bias"], k, group)
        got, want = W.w4_gemm(*args), W.w4_gemm_plain(*args)
        torch.cuda.synchronize()
        rel = rel_err(torch, got, want)
        err = max(err, float((got - want).abs().max()))
        if not rel <= W4_RTOL:
            fail(f"B5 kernel != plain at {name} M={m} K={k} N={n}: "
                 f"{rel} of the largest |output|")
        log(json.dumps({"phase": "w4_gemm_kernel_vs_plain", "layer": name,
                        "M": m, "K": k, "N": n, "group": group,
                        "x": "2^-60..2^60" if wide else "N(0, 1)",
                        "max_err_rel_to_max": rel}))
        del c, got, want
    torch.cuda.empty_cache()
    return err


def engine_prefill_ms():
    """M = n x bucket of every batched prefill that the engine phases'
    GenerationEngines (8 slots) can run for their prompt lengths: each
    prompt's power-of-two bucket (``serve.generation._bucket``), n a power
    of two up to the slots (the engine's grouping)."""
    from int8inferenceengine_tpu_torch.serve.generation import _bucket
    lens = set(SERVE_PROMPTS) | {SERVE_LOAD[1], BENCH_ENGINE_LOAD[1]}
    buckets = {min(_bucket(t), GPT["max_len"]) for t in lens}
    slots = max(SERVE["slots"], BENCH_ENGINE["slots"])
    ns = [1 << i for i in range(slots.bit_length())]
    return sorted({n * b for b in buckets for n in ns})


def check_engine_prefill_kernels(torch, G, W, gen, dev):
    """The kernels at the engines' batched prefill shapes (M from
    ``engine_prefill_ms``): B1 at the gpt2 Linears (exact; the gelu
    epilogue within 1 code on 0.2%) and B2 at its merged QKV (exact); at
    the llama W4A8 Linears (group 256) the kernel that the W4A8 dispatch
    picks, B6 exactly or B7 as ``check_b7`` holds it; both roundings.
    Returns {kernel: max |code difference|}."""
    err = dict.fromkeys(("qgemm_u8s8", "qgemm_u8s8_vzp", "w4a8_v2_gemm",
                         "w4a8_v1_gemm"), 0)
    group = LLAMA_W4A8["w4_group"]
    for m in engine_prefill_ms():
        on = {"b6": [], "b7": []}
        for name, _, k, n, _, act in DEC_GEMMS:
            c = gemm_case(torch, gen, m, k, n, dev)
            oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]),
                                  c["s_a"], c["zp_a"], recentered=True)
            # an act epilogue: scale s_w and s_c alike (act_kernel_vs_plain)
            f = 5.0 / (110 * c["s_c"]) if act else 1.0
            ep = G.epilogue_vector(c["s_a"], c["s_w_pc"] * f, c["s_c"] * f,
                                   n, dev, "gemm")
            for rounding in ("trunc", "nearest"):
                kw = dict(scale_a=c["s_a"], scale_c=c["s_c"] * f,
                          zp_c=c["zp_c"], rounding=rounding,
                          act=act_grid(act) if act else None)
                got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
                want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
                torch.cuda.synchronize()
                mx, share = contract(torch, got, want)
                err["qgemm_u8s8"] = max(err["qgemm_u8s8"], mx)
                if (act is None and mx) or mx > 1 or share > 0.002:
                    fail(f"engine prefill B1 {name} kernel != plain at M={m} "
                         f"K={k} N={n} {rounding}: max {mx}, share {share}")
        _, k, n, _ = DEC_QKV
        parts = []
        for i in range(3):
            c = gemm_case(torch, gen, m, k, n, dev)
            parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                              rowsum=rowsum(torch, c["w"]),
                              scale_w=c["s_w_pc"] if i == 1 else 0.01,
                              scale_c=c["s_c"] * (1 + 0.3 * i),
                              zp_c=100 + 20 * i))
        merged = G.merge_parts(parts, scale_a=c["s_a"], zp_a=c["zp_a"])
        for rounding in ("trunc", "nearest"):
            got = torch.cat(G.qgemm_multi(c["a"], merged, rounding=rounding),
                            1)
            want = torch.cat(G.qgemm_multi_plain(c["a"], merged,
                                                 rounding=rounding), 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"engine prefill B2 kernel != plain at M={m}: "
                     f"{int((got != want).sum())} codes differ")
        for name, _, k, n, _ in W4_DECODE:
            c = w4_case(torch, W, gen, m, k, n, group, dev,
                        vector_mult=name in ("qkv", "gate+up"))
            b6 = W.use_v2(m, k, group, k // group)
            on["b6" if b6 else "b7"].append(name)
            for rounding in ("trunc", "nearest"):
                if b6:
                    got = W.w4a8_v2(c["x"], c["ops"], rounding)
                    want = v2_plain(W, c["x"], c["ops"], rounding)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"engine prefill B6 {name} kernel != plain at "
                             f"M={m} K={k} N={n} {rounding}: "
                             f"{int((got != want).sum())} codes differ")
                else:
                    _, mx, _ = check_b7(
                        torch, W, W.w4a8_v1, c["x"], c["ops"], rounding,
                        f"engine prefill {name} at M={m} K={k} N={n}")
                    err["w4a8_v1_gemm"] = max(err["w4a8_v1_gemm"], mx)
        log(json.dumps({"phase": "engine_prefill_kernels_vs_plain", "M": m,
                        "gpt2": {"b1": [g[0] for g in DEC_GEMMS],
                                 "b2": "qkv",
                                 "b1_plans": {g[0]: plan_of(G, m, g[3], g[2],
                                                            dev)
                                              for g in DEC_GEMMS}},
                        "llama_w4a8": on,
                        "max_abs_err_so_far": dict(err)}))
    return err


@contextlib.contextmanager
def swapped(module, **fns):
    """Replace module-level functions while the block runs (a harness swap:
    the layers call them by their module attribute).  A kernel wrapper adds
    to the counter of the name it is bound to, so while the swap lasts its
    launches go to the stand-in, never to the counts of the main path."""
    old = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        fn.launches = fn.merged_launches = 0
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(module, name, fn)


def replaying(torch, W, stats):
    """Stand-ins for the three 4-bit wrappers that launch the kernel and
    then run its plain version on the same operands, holding each launch to
    its contract and adding to ``stats``."""
    v2, v1, b5 = W.w4a8_v2, W.w4a8_v1, W.w4_gemm

    def note(kernel, value, share=0.0):
        s = stats.setdefault(kernel, {"launches": 0, "max_abs_err": 0,
                                      "max_share_differing": 0.0})
        s["launches"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], value)
        s["max_share_differing"] = max(s["max_share_differing"], share)

    def r_v2(x, ops, rounding="trunc"):
        got = v2(x, ops, rounding)
        want = v2_plain(W, x, ops, rounding)
        mx, share = contract(torch, got, want)
        note("w4a8_v2_gemm", mx, share)
        if mx:
            fail(f"replayed B6 launch at M={x.shape[0]} K={ops['k']} N="
                 f"{got.shape[1]}: {share} of the codes differ, max {mx}")
        return got

    def r_v1(x, ops, rounding="trunc"):
        got, mx, share = check_b7(
            torch, W, v1, x, ops, rounding,
            f"replayed launch at M={x.shape[0]} K={ops['k']} N="
            f"{ops['packed'].shape[0]}")
        note("w4a8_v1_gemm", mx, share)
        return got

    def r_b5(x, packed, scales, bias, k, group=128):
        got = b5(x, packed, scales, bias, k, group)
        rel = rel_err(torch, got, W.w4_gemm_plain(x, packed, scales, bias, k,
                                                  group))
        note("w4_gemm", rel)
        if not rel <= W4_RTOL:
            fail(f"replayed B5 launch at M={x.shape[0]} K={k} N="
                 f"{got.shape[1]}: {rel} of the largest |output|")
        return got

    return dict(w4a8_v2=r_v2, w4a8_v1=r_v1, w4_gemm=r_b5)


def plain_w4(W):
    """Stand-ins for the three 4-bit wrappers that run their plain versions
    on the card."""
    return dict(w4a8_v2=lambda x, ops, rounding="trunc":
                v2_plain(W, x, ops, rounding),
                w4a8_v1=lambda x, ops, rounding="trunc":
                v1_plain(W, x, ops, rounding),
                w4_gemm=lambda *args: W.w4_gemm_plain(*args))


def plain_attn(A):
    """A stand-in for the decode attention wrapper that runs its plain
    version on the card."""
    attn = A.decode_attention_flat

    def p_attn(*args, **kw):
        return attn(*args, **dict(kw, backend="xla"))

    return dict(decode_attention_flat=p_attn)


# -- phase 5: the AlexNet main path -----------------------------------------

def alexnet_main_path(torch, q, zoo, kernel_fns, dev):
    """The AlexNet-224 b100 lifecycle; returns (INT8 model, FP32 input,
    state, launches by kernel)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    batch = 100
    twin = zoo.torch_twin("alexnet")
    state = he_state(torch, twin, seed=0)
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    rng = np.random.default_rng(0)
    x_calib = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)
    x_test = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)

    # the launch count covers the whole lifecycle: load, FP32 forward,
    # calibration, convert (none of which launch a kernel) and one INT8
    # forward (one launch per layer)
    reset_counts(kernel_fns)
    model = zoo.AlexNet(device="cuda")
    model.load(state)
    fp32 = model(q.tensor(x_test)).data
    with torch.no_grad():
        ref = twin(torch.tensor(x_test, device=dev))
    scale = float(ref.abs().max())
    fp_err = float((fp32 - ref).abs().max()) / scale
    if not torch.allclose(fp32, ref, rtol=1e-4, atol=1e-4 * scale):
        fail(f"FP32 AlexNet differs from its torch twin: max error "
             f"{fp_err} of max |logit|")
    log(json.dumps({"phase": "fp32_vs_twin", "max_err_rel_to_max": fp_err}))

    t0 = time.perf_counter()
    model.prepare()
    model(q.tensor(x_calib))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0

    out = model(q.tensor(x_test)).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    if counts != dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": 8}:
        fail(f"INT8 AlexNet forward launched {counts}, want 8 qgemm_u8s8 "
             f"and nothing else")
    if tuple(out.shape) != (batch, 10) or not bool(torch.isfinite(out).all()):
        fail(f"INT8 output shape {tuple(out.shape)} or non-finite values")
    top1 = float((out.argmax(1) == ref.argmax(1)).float().mean())
    log(json.dumps({"phase": "int8_forward", "launches": counts,
                    "calibrate_convert_s": round(lifecycle_s, 3),
                    "top1_agreement_vs_fp32": top1,
                    "output_scale": model.fc3.scale,
                    "output_zero_point": model.fc3.zero_point}))

    cpu = zoo.AlexNet(device="cpu")
    load_jax_state(cpu, export_state(model))
    out_cpu = cpu(q.tensor(x_test[:2], device="cpu")).data
    if not torch.equal(out[:2].cpu(), out_cpu):
        fail("INT8 codes on the card differ from the CPU copy's")
    log(json.dumps({"phase": "gpu_vs_cpu_codes", "images": 2, "equal": True}))
    return model, x_test, state, counts


def alexnet_timing(torch, q, zoo, model, x_test, state, profile):
    xt = q.tensor(x_test)
    batch = x_test.shape[0]
    int8_ms = time_cuda(torch, lambda: model(xt), iters=20)
    fp_model = zoo.AlexNet(device="cuda")
    fp_model.load(state)
    fp32_ms = time_cuda(torch, lambda: fp_model(xt), iters=20)
    log(json.dumps({"model": "alexnet_cifar10_224", "batch": batch,
                    "int8_ms_per_batch": int8_ms,
                    "int8_images_per_s": batch * 1e3 / int8_ms,
                    "fp32_ms_per_batch": fp32_ms,
                    "fp32_images_per_s": batch * 1e3 / fp32_ms}))
    if not profile:
        return
    from torch.profiler import ProfilerActivity, profile as torch_profile
    reps = 5
    for name, net in (("int8", model), ("fp32", fp_model)):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                net(xt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
        rows = profile_rows(torch, prof)
        busy = sum(e.self_device_time_total for e in rows) / reps
        log(json.dumps({"profile": name, "batch": batch,
                        "wall_us_per_fwd": wall_us,
                        "device_busy_us_per_fwd": busy,
                        "device_idle_share": 1 - busy / wall_us,
                        "kernels": [{
                            "name": e.key[:90],
                            "us_per_fwd": e.self_device_time_total / reps,
                            "calls_per_fwd": e.count / reps}
                            for e in rows[:30]]}))


# -- phase 6: the decoders on the card against a CPU copy --------------------

def decoder_vs_cpu(torch, q, zoo, TD, LL, family: str, dev, batch=SMALL_BATCH,
                   **geo):
    """One small decoder of ``family`` ('gpt2' or 'llama_w4a8', with its
    main path's QuantConfig) calibrated and converted on ``dev``, and a CPU
    copy of its converted state (``export_state`` -> ``load_jax_state``):
    the prefill's logit codes at every prompt position, greedy tokens, and
    ``SMALL_STEPS`` decode steps teacher-forced on the card's tokens.
    Returns ``card_vs_cpu``'s legs."""
    geo = dict(SMALL_DEC, **geo)
    if family == "gpt2":
        name, cfg, residual = "gpt_tiny", {}, ("proj", "fc2")
        twin = TD.torch_text_decoder(**geo, seed=0)
    else:
        geo.setdefault("kv_heads", 2)
        name, cfg, residual = "llama_tiny", LLAMA_W4A8, ("proj", "down")
        twin = LL.torch_llama(**geo, seed=0)
    state = decoder_state(torch, twin, geo["depth"], seed=2,
                          residual=residual)
    ids = np.random.default_rng(2).integers(
        0, geo["vocab_size"], (batch, SMALL_PROMPT)).astype(np.int32)
    model = zoo.build(name, config=q.QuantConfig(**cfg), device=dev, **geo)
    model.load(state)
    model.prepare()
    model(q.tensor(ids, device=dev))
    model.convert()
    return card_vs_cpu(torch, zoo, model, name, geo, ids, SMALL_STEPS,
                       family)


def card_vs_cpu(torch, zoo, model, name, geo, ids, steps, family,
                cpu=None):
    """A converted model on the card against a CPU copy of its state
    (``export_state`` -> ``load_jax_state``; the copy is ``cpu``, a fresh
    CPU model of the same architecture, or ``zoo.build(name, **geo)``): the
    prefill's logit codes at every prompt position, ``steps`` decode steps
    teacher-forced on the card's greedy tokens, and the tokens.  Returns
    one result dict per leg, each with ``ok`` under the contract (at most
    CPU_MAX_CODE codes off on at most CPU_MAX_SHARE of them; tokens
    equal)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev, batch = model.device, ids.shape[0]
    if cpu is None:
        cpu = zoo.build(name, config=model.config, device="cpu", **geo)
    load_jax_state(cpu, export_state(model))

    legs = []

    def leg(what, got, want):
        mx, share = contract(torch, got.cpu(), want.cpu())
        legs.append({"phase": "decoder_card_vs_cpu", "family": family,
                     "leg": what, "batch": batch, **geo,
                     "codes": int(want.numel()), "max_abs_err": mx,
                     "share_differing": share,
                     "ok": mx <= CPU_MAX_CODE and share <= CPU_MAX_SHARE})

    prompt = torch.tensor(ids, dtype=torch.int64)
    with torch.no_grad():
        leg("prefill", model.forward(Tensor(prompt.to(dev))).data,
            cpu.forward(Tensor(prompt)).data)
    tokens = model.generate(ids, steps)
    tokens_cpu = cpu.generate(ids, steps)
    toks = torch.tensor(tokens, dtype=torch.int64)
    leg("teacher_forced_decode",
        teacher_forced(torch, model, prompt.to(dev), toks.to(dev)),
        teacher_forced(torch, cpu, prompt, toks))
    same = bool(np.array_equal(tokens, tokens_cpu))
    legs.append({"phase": "decoder_card_vs_cpu", "family": family,
                 "leg": "greedy_tokens", "batch": batch,
                 "steps": steps, "equal": same,
                 "first_step_apart": None if same else int(
                     np.argwhere((tokens != tokens_cpu).any(0))[0, 0]),
                 "ok": same})
    return legs


def decoders_vs_cpu(torch, q, zoo, TD, LL, dev):
    """The gate of the decoders' card codes against the CPU: both families
    at their small size (``CPU_GATE_LEGS``); every leg is printed before any
    failure."""
    legs = []
    for family, batch, extra, gated in CPU_GATE_LEGS:
        for r in decoder_vs_cpu(torch, q, zoo, TD, LL, family, dev,
                                batch=batch, **extra):
            legs.append(dict(r, gated=gated))
    for r in legs:
        log(json.dumps(r))
    bad = [f"{r['family']} b{r['batch']} {r['leg']}" for r in legs
           if r["gated"] and not r["ok"]]
    if bad:
        fail(f"decoder codes on the card differ from a CPU copy's beyond "
             f"the contract: {bad}")
    return legs


# -- phase 7: the decoder main path -----------------------------------------

def decode_from(torch, model, cache, t0: int, tokens):
    """The u8 logit codes [B, S, V] of decode steps fed ``tokens`` [B, S] one
    at a time from position ``t0`` through ``cache`` (updated in place)."""
    out = []
    with torch.no_grad():
        pos = torch.full((), t0, dtype=torch.int64, device=tokens.device)
        for s in range(tokens.shape[1]):
            codes, cache = model._decode_step(cache, pos, tokens[:, s])
            out.append(codes)
            pos = pos + 1
    return torch.stack(out, 1)


def teacher_forced(torch, model, prompt, tokens):
    """The u8 logit codes [B, steps, V] of ``model`` fed the prompt and then
    ``tokens`` [B, steps] one step at a time through its KV cache."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(prompt))
    return torch.cat([codes[:, None],
                      decode_from(torch, model, cache, prompt.shape[1],
                                  tokens[:, :-1])], 1)


def decoder_main_path(torch, q, zoo, TD, kernel_fns, dev):
    """The gpt2-small-ish lifecycle and greedy generate; returns (INT8
    model, prompt ids, launches by kernel)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    twin = TD.torch_text_decoder(**GPT, seed=0)
    state = decoder_state(torch, twin, GPT["depth"], seed=0)
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    ids = np.random.default_rng(0).integers(
        0, GPT["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)

    reset_counts(kernel_fns)
    t0 = time.perf_counter()
    model = zoo.build("gpt_tiny", **GPT)
    model.load(state)
    fp32 = model(q.tensor(ids)).data
    with torch.no_grad():
        ref = twin(torch.tensor(ids, dtype=torch.int64, device=dev))
    scale = float(ref.abs().max())
    fp_err = float((fp32 - ref).abs().max()) / scale
    if tuple(fp32.shape) != (DEC_BATCH, DEC_PROMPT, GPT["vocab_size"]) or \
            not torch.allclose(fp32, ref, rtol=1e-4, atol=1e-4 * scale):
        fail(f"FP32 decoder differs from its torch twin: shape "
             f"{tuple(fp32.shape)}, max error {fp_err} of max |logit|")
    log(json.dumps({"phase": "decoder_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    del twin, ref, fp32

    model.prepare()
    model(q.tensor(ids))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    # the prefill runs 37 B1 and one B2 per block; it takes the first
    # token, and each of the DEC_STEPS - 1 decode steps after it runs 37
    # B1, one B2 and one B3 per block
    depth = GPT["depth"]
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 3 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    prefill = dict(per_step, decode_attn_flat=0)
    check_captured_launches(torch, "decoder", counts, model, ids, prefill,
                            per_step, kernel_fns)
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.dtype != np.int32 \
            or tokens.min() < 0 or tokens.max() >= GPT["vocab_size"]:
        fail(f"generate returned {tokens.dtype} {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    log(json.dumps({"phase": "decoder_generate", "steps": DEC_STEPS,
                    "launches": counts,
                    "launches_per_decode_step": per_step,
                    "prepare_calibrate_convert_s": round(lifecycle_s, 3),
                    "distinct_tokens": int(np.unique(tokens).size)}))

    # the same converted state on the plain path (every kernel's plain
    # version), on the card, teacher-forced on the kernel path's tokens
    plain_cfg = q.QuantConfig(kernel_backend="xla", fuse_qkv="xla",
                              decode_attention="xla")
    plain = zoo.build("gpt_tiny", config=plain_cfg, **GPT)
    load_jax_state(plain, export_state(model))
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    got = teacher_forced(torch, model, prompt, toks)
    want_codes = teacher_forced(torch, plain, prompt, toks)
    if not torch.equal(got.argmax(-1), toks):
        fail("the kernel path's teacher-forced argmax differs from the "
             "tokens its generate() returned")
    mx, share = contract(torch, got, want_codes)
    differs = (want_codes.argmax(-1) != toks).any(0).nonzero()
    first = int(differs[0]) if differs.numel() else None
    log(json.dumps({"phase": "decoder_kernel_vs_plain_path",
                    "codes": int(got.numel()), "max_abs_err": mx,
                    "share_differing": share,
                    "first_step_with_other_greedy_token": first,
                    "limits": {"max": MAX_CODE_DIFF,
                               "share": MAX_SHARE_DIFF}}))
    if mx > MAX_CODE_DIFF or share > MAX_SHARE_DIFF:
        fail(f"decoder codes, kernel path vs plain path: max {mx}, share "
             f"{share}")
    del plain, got, want_codes
    captured_vs_eager(torch, model, ids, tokens, "decoder")
    return model, ids, counts


# -- phases 9 and 10: the llama legs ------------------------------------------

def llama_w4a8_main_path(torch, q, zoo, LL, W, A, kernel_fns, dev):
    """bench.py's W4A8 llama lifecycle and greedy generate; returns (INT8
    model, prompt ids, FP32 state, launches by kernel)."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    depth = LLAMA["depth"]
    twin = LL.torch_llama(**LLAMA, seed=0)
    state = decoder_state(torch, twin, depth, seed=0,
                          residual=("proj", "down"))
    twin.load_state_dict(state)
    twin = twin.to(dev).eval()
    ids = np.random.default_rng(0).integers(
        0, LLAMA["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)

    reset_counts(kernel_fns)
    t0 = time.perf_counter()
    model = zoo.build("llama_tiny", config=q.QuantConfig(**LLAMA_W4A8),
                      **LLAMA)
    model.load(state)
    fp32 = model(q.tensor(ids)).data
    with torch.no_grad():
        ref = twin(torch.tensor(ids, dtype=torch.int64, device=dev))
    fp_err = float((fp32 - ref).abs().max() / ref.abs().max())
    if tuple(fp32.shape) != (DEC_BATCH, DEC_PROMPT, LLAMA["vocab_size"]) \
            or not fp_err <= 1e-4:
        fail(f"FP32 llama differs from its torch twin: shape "
             f"{tuple(fp32.shape)}, max error {fp_err} of max |logit|")
    log(json.dumps({"phase": "llama_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    del twin, ref, fp32

    model.prepare()
    model(q.tensor(ids))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    merged = W.w4a8_v1.merged_launches
    # the prefill (M = 512, over B6's envelope) runs B7: proj, down and
    # the head alone, qkv and gate+up merged; each of the DEC_STEPS - 1
    # decode steps runs B6 at all 4 * depth + 1 Linears and B3 per block
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "w4a8_v2_gemm": 4 * depth + 1, "decode_attn_flat": depth}
    prefill = dict.fromkeys(kernel_fns, 0) | {"w4a8_v1_gemm": 4 * depth + 1}
    check_captured_launches(torch, "llama W4A8", counts, model, ids,
                            prefill, per_step, kernel_fns)
    if merged != 2 * depth:
        fail(f"llama W4A8 prefill: {merged} merged B7, want {2 * depth}")
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.dtype != np.int32 \
            or tokens.min() < 0 or tokens.max() >= LLAMA["vocab_size"]:
        fail(f"generate returned {tokens.dtype} {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    log(json.dumps({"phase": "llama_w4a8_generate", "steps": DEC_STEPS,
                    "launches": counts,
                    "launches_per_decode_step": {
                        k: v for k, v in per_step.items() if v},
                    "prefill_launches": {
                        "w4a8_v1_gemm single-layer": 4 * depth + 1 - merged,
                        "w4a8_v1_gemm merged": merged},
                    "prepare_calibrate_convert_s": round(lifecycle_s, 3),
                    "distinct_tokens": int(np.unique(tokens).size)}))

    # (b) every W4 launch of the prefill and of 16 decode steps, replayed
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    stats = {}
    with swapped(W, **replaying(torch, W, stats)):
        teacher_forced(torch, model, prompt, toks[:, :DEC_SHORT + 1])
    replayed = {"w4a8_v1_gemm": 4 * depth + 1,
                "w4a8_v2_gemm": DEC_SHORT * (4 * depth + 1)}
    if {k: s["launches"] for k, s in stats.items()} != replayed:
        fail(f"replayed {stats}, want {replayed} launches")
    log(json.dumps({"phase": "llama_w4a8_replayed_launches", "stats": stats,
                    "contract": {"w4a8_v2_gemm": "exact",
                                 "w4a8_v1_gemm": "equal to w4a8_v2_plain; "
                                 "<=1 code on <=0.2% of w4a8_v1_plain"}}))

    # (c) one shared prefill cache, 128 teacher-forced decode steps on the
    # kernel path and on the plain path (harness swap, same model)
    with torch.no_grad():
        codes0, cache = model._prefill(Tensor(prompt))
    cache_plain = {i: (k.clone(), v.clone()) for i, (k, v) in cache.items()}
    got = decode_from(torch, model, cache, DEC_PROMPT, toks)
    if not torch.equal(codes0.argmax(-1), toks[:, 0]) or \
            not torch.equal(got[:, :-1].argmax(-1), toks[:, 1:]):
        fail("the kernel path's teacher-forced argmax differs from the "
             "tokens its generate() returned")
    with swapped(W, **plain_w4(W)), swapped(A, **plain_attn(A)):
        want_codes = decode_from(torch, model, cache_plain, DEC_PROMPT, toks)
        with torch.no_grad():
            prefill_plain = model.forward(Tensor(prompt)).data
    mx, share = contract(torch, got, want_codes)
    log(json.dumps({"phase": "llama_w4a8_kernel_vs_plain_path",
                    "shared_prefill_cache": True,
                    "decode_steps": DEC_STEPS, "codes": int(got.numel()),
                    "max_abs_err": mx, "share_differing": share,
                    "limit": "equal"}))
    if mx:
        fail(f"llama W4A8 teacher-forced codes, kernel path vs plain path: "
             f"max {mx}, share {share}")
    # (d) the prefill run apart on each path: B7 sums in another order than
    # its f32 plain version and may move a code, which the plain path's
    # cache would carry on (recorded)
    with torch.no_grad():
        prefill_kernel = model.forward(Tensor(prompt)).data
    mx, share = contract(torch, prefill_kernel, prefill_plain)
    log(json.dumps({"phase": "llama_w4a8_prefill_kernel_vs_plain",
                    "codes": int(prefill_kernel.numel()), "max_abs_err": mx,
                    "share_differing": share, "gated": False}))
    del got, want_codes, prefill_plain, prefill_kernel, cache, cache_plain
    captured_vs_eager(torch, model, ids, tokens, "llama_w4a8")
    return model, ids, state, counts


def llama_w4_forward_path(torch, q, zoo, W, kernel_fns, state, ids):
    """The W4 weight-only llama forward on the same weights and prompt;
    returns (model, launches by kernel)."""
    depth = LLAMA["depth"]
    reset_counts(kernel_fns)
    model = zoo.build("llama_tiny", config=q.QuantConfig(**LLAMA_W4),
                      **LLAMA)
    model.load(state)
    model.convert()                    # weight-only: no calibration pass
    xt = q.tensor(ids)
    out = model(xt).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    want = dict.fromkeys(kernel_fns, 0) | {"w4_gemm": 7 * depth + 1}
    if counts != want:
        fail(f"weight-only llama forward launched {counts}, want {want}")
    if tuple(out.shape) != (DEC_BATCH, DEC_PROMPT, LLAMA["vocab_size"]) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"weight-only output {out.dtype} {tuple(out.shape)} or "
             f"non-finite values")
    stats = {}
    with swapped(W, **replaying(torch, W, stats)):
        model(xt)
    if stats["w4_gemm"]["launches"] != 7 * depth + 1:
        fail(f"replayed {stats}, want {7 * depth + 1} B5 launches")
    with swapped(W, **plain_w4(W)):
        plain = model(xt).data
    rel = rel_err(torch, out, plain)
    log(json.dumps({"phase": "llama_w4_forward", "launches": counts,
                    "replayed": stats, "max_err_rel_to_max_vs_plain": rel,
                    "limit": 1e-4}))
    if not rel <= 1e-4:
        fail(f"weight-only logits, kernel path vs plain path: {rel} of the "
             f"largest |logit|")
    return model, counts


def llama_w4_timing(torch, q, model, ids, profile):
    xt = q.tensor(ids)
    ms = time_cuda(torch, lambda: model(xt), iters=5)
    log(json.dumps({"model": "llama_w4_weight_only_forward",
                    "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "ms_per_forward": ms,
                    "tokens_per_s": DEC_BATCH * DEC_PROMPT * 1e3 / ms}))
    if profile:
        profile_forward(torch, lambda: model(xt),
                        "llama_w4_weight_only_forward")


def full_context_timing(torch, q, model, label, kernel_fns):
    """One forward over FULL_CONTEXT tokens (the model's max_len): its
    launches by kernel and its ms (CUDA events, 3 runs); recorded, not
    gated."""
    ids = np.random.default_rng(1).integers(
        0, model.vocab_size, FULL_CONTEXT).astype(np.int32)
    xt = q.tensor(ids)
    reset_counts(kernel_fns)
    out = model(xt).data
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts(kernel_fns).items() if v}
    if tuple(out.shape) != (*FULL_CONTEXT, model.vocab_size) or \
            not bool(torch.isfinite(out.to(torch.float32)).all()):
        fail(f"{label}: output {out.dtype} {tuple(out.shape)} or "
             f"non-finite values")
    del out
    ms = time_cuda(torch, lambda: model(xt), iters=3)
    tokens = FULL_CONTEXT[0] * FULL_CONTEXT[1]
    log(json.dumps({"model": label, "batch": FULL_CONTEXT[0],
                    "tokens_per_sequence": FULL_CONTEXT[1],
                    "ms_per_forward": ms, "tokens_per_s": tokens * 1e3 / ms,
                    "launches_per_forward": launches, "gated": False}))


def decoder_timing(torch, model, ids, profile, label="gpt2_small_ish_decode"):
    """Decode ms/step by bench.py's protocol, the prefill, and under
    ``profile`` the device time of decode steps by kernel.  No warm-up
    run: every ``generate()`` captures its own step graph, and the best of
    3 leaves the first out."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    vocab = model.vocab_size
    times = {}
    for steps in (DEC_SHORT, DEC_STEPS):
        best = float("inf")
        for trial in range(3):
            p2 = (ids + trial + 1) % vocab
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(p2, steps)
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    per_step = (times[DEC_STEPS] - times[DEC_SHORT]) / (DEC_STEPS - DEC_SHORT)
    prompt = Tensor(torch.tensor(ids, dtype=torch.int64, device=model.device))
    with torch.no_grad():
        prefill_ms = time_cuda(torch, lambda: model._prefill(prompt), iters=5)
    eager_ms = time_eager_steps(torch, model, ids)
    res = {"model": label, "batch": DEC_BATCH,
           "prompt": DEC_PROMPT, "decode_ms_per_step": per_step * 1e3,
           "tokens_per_s": DEC_BATCH / per_step, "prefill_ms": prefill_ms,
           "eager_step_loop_ms_per_step": eager_ms,
           "generate_s": {str(k): v for k, v in times.items()},
           "protocol": f"(t(generate {DEC_STEPS}) - t(generate {DEC_SHORT}))"
                       f" / {DEC_STEPS - DEC_SHORT}, best of 3; generate() "
                       f"replays a captured step, the eager loop launches "
                       f"every kernel from Python"}
    log(json.dumps(res))
    if profile:
        profile_captured(torch, model, ids, label)
        profile_decode(torch, model, prompt, eager_ms * 1e3, label)
        profile_forward(torch, lambda: model._prefill(prompt),
                        f"{label}: prefill")
    return res


def kernel_of(name: str):
    """The port's kernel a profiler row belongs to, or None."""
    if "decode_attn_kernel" in name:
        return "decode_attn_flat"
    if "dw_word_kernel" in name or "grouped_kernel<" in name:
        return "conv_grouped_u8s8"
    if "qgemm_kernel<" in name:
        # the template's last argument is the epilogue mode; 2 is B2's
        vzp = re.search(r"qgemm_kernel<[^>]*,\s*2>", name)
        return "qgemm_u8s8_vzp" if vzp else "qgemm_u8s8"
    if "w4a8_v2_kernel" in name:
        return "w4a8_v2_gemm"
    if "w4_tc_kernel" in name:
        # the first template argument is true for B7 (W4A8), false for B5
        b7 = re.search(r"w4_tc_kernel<(true|\(bool\)1)", name)
        return "w4a8_v1_gemm" if b7 else "w4_gemm"
    return None


def by_kernel(rows, reps):
    """{kernel: (us per rep, launches per rep)} of profiler rows."""
    out = {}
    for e in rows:
        k = kernel_of(e.key) or "other (eager glue)"
        us, n = out.get(k, (0.0, 0.0))
        out[k] = (us + e.self_device_time_total / reps, n + e.count / reps)
    return {k: {"us": us, "launches": n} for k, (us, n) in out.items()}


def profile_forward(torch, fn, label, reps=3):
    """The device time of ``fn`` by kernel under torch.profiler, and the
    device's idle share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = profile_rows(torch, prof)
    busy = sum(e.self_device_time_total for e in rows) / reps
    split = by_kernel(rows, reps)
    log(json.dumps({"profile": label, "wall_us_profiled": wall_us,
                    "device_busy_us": busy,
                    "device_idle_share_profiled": 1 - busy / wall_us,
                    "by_kernel": split,
                    "rows": [{"name": e.key[:90],
                              "us": e.self_device_time_total / reps,
                              "calls": e.count / reps} for e in rows[:20]]}))
    return busy, split


def profile_decode(torch, model, prompt, step_us, label):
    from torch.profiler import ProfilerActivity, profile as torch_profile
    reps = 8
    with torch.no_grad():
        codes, cache = model._prefill(prompt)
        tok = codes.argmax(-1)
        pos = torch.full((), prompt.shape[1], dtype=torch.int64,
                         device=model.device)
        for _ in range(2):                       # warm
            codes, cache = model._decode_step(cache, pos, tok)
            tok, pos = codes.argmax(-1), pos + 1
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                codes, cache = model._decode_step(cache, pos, tok)
                tok, pos = codes.argmax(-1), pos + 1
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = profile_rows(torch, prof)
    busy = sum(e.self_device_time_total for e in rows) / reps
    log(json.dumps({"profile": f"{label}: decode_step", "batch": DEC_BATCH,
                    "wall_us_per_step_profiled": wall_us,
                    "wall_us_per_step_unprofiled": step_us,
                    "device_busy_us_per_step": busy,
                    "device_idle_share": 1 - busy / step_us,
                    "device_idle_share_profiled": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total / reps,
                              "calls_per_step": e.count / reps}
                             for e in rows[:30]]}))


# -- captured steps and serving on the card --------------------------------

# the serving engines' defaults (the JAX package's): slots, decode steps a
# chunk, chunks a host sync
SERVE = dict(slots=8, chunk_steps=32, sync_chunks=4)
# the gpt2 engine's 16 requests: prompt lengths cycle through these, 64-128
# new tokens each; 10 greedy, 4 sampled with these knobs and fixed seeds, 2
# with an eos that the greedy run of their prompt emits
SERVE_PROMPTS = (17, 24, 40, 64, 100)
SERVE_SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=40)
# saturated load: requests x prompt tokens x new tokens, greedy
SERVE_LOAD = (32, 64, 128)
# bench.py's engine leg (bench.py:295-323), the serving yardstick that the
# JAX package's own benchmark pins: the gpt2-small-ish engine at 8 slots,
# chunks of 32 steps, 8 chunks a sync; 16 greedy requests x 24 prompt
# tokens x 256 new tokens (prompts from default_rng(7)); one warm round,
# then tokens/s best of 2
BENCH_ENGINE = dict(slots=8, chunk_steps=32, sync_chunks=8)
BENCH_ENGINE_LOAD = (16, 24, 256)
# the small decoders' engines on the card and on the CPU: (family, slots,
# extra geometry); 8 requests of up to 30 prompt tokens, 16 new tokens
SMALL_SERVE = [("gpt2", 4, {}), ("llama_w4a8", 8, {"mlp_hidden": 768})]
SMALL_SERVE_PROMPTS = (5, 9, 16, 30)
# the AlexNet engine's requests (images each) and its saturated load
# (batches of 100)
ALEX_REQUESTS = (1, 7, 33, 64, 100)
ALEX_LOAD = 30
WAIT_S = 600


# B3 at the extend shapes: query positions, T and (H, Hkv), D = 64; batch
# EXT_B in the checks, 1 in the per-shape times
EXT_MQ = (2, 5, 9, 16, 64, 128)
EXT_T = (512, 4096)
EXT_HEADS = ((12, 12), (12, 2))
EXT_B = 2
# speculative decoding's draft depth, and the engine's prefill chunk
SPEC_K = 4
PREFILL_CHUNK = 64
# B3 at the main path's two extends (T = 512, gpt2's 12 heads), for the
# kernels line: (unit, batch, query rows, live length of the first row,
# launches per unit).  A verify at batch 8 over k + 1 rows, at the decode
# leg's mean live length; a prefill chunk of one slot over 64 rows, at the
# mean first position of a 448-token prompt's chunks (0, 64, ..., 384)
EXT_UNITS = [("speculative_verify", 8, SPEC_K + 1, 128, 12),
             ("prefill_chunk", 1, PREFILL_CHUNK, 193, 12)]
# the gpt2-small-ish target's draft: 2 layers at dim 256 over its vocabulary
SPEC_DRAFT = dict(vocab_size=50257, max_len=512, dim=256, depth=2, heads=4)
SPEC_STEPS = 128
# the chunked engine: SERVE with 64-token prefill chunks; greedy and
# sampled prompt lengths (100-448 tokens) and new tokens; a prefix of
# PREFIX_LEN tokens and PREFIX_SUFFIXES requests extending it by 16-64
# tokens; the 448-token prompt's TTFT over TTFT_REPS requests
CHUNK_ENGINE = dict(SERVE, prefill_chunk=PREFILL_CHUNK)
CHUNK_GREEDY = (100, 150, 200, 256, 300, 350, 400, 448)
CHUNK_SAMPLED = (120, 230, 333, 448)
CHUNK_NEW = 32
PREFIX_LEN = 256
PREFIX_SUFFIXES = 16
TTFT_REPS = 5


# replays profiled to check a captured step's kernels
REPLAYS_PROFILED = 4


def per_replay(program, kernel_fns):
    """{kernel: launches} that each replay of a ``graphs.Captured`` program
    adds to the counts: what its capture recorded."""
    return {name: program.launches.get((fn, "launches"), 0)
            for name, fn in kernel_fns.items()}


def check_replays(label, program, kernel_fns, ran, reps, want=None):
    """A captured program's kernels, two ways: ``ran`` ({kernel:
    executions} of ``reps`` profiled replays) must equal ``reps`` times
    what each replay adds to the counts, and that must equal ``want`` (a
    step's kernels, where it is known)."""
    adds = per_replay(program, kernel_fns)
    got = {k: n // reps for k, n in ran.items()}
    if any(n % reps for n in ran.values()) or \
            got != {k: n for k, n in adds.items() if n} or \
            (want is not None and adds != want):
        fail(f"{label}: {reps} profiled replays ran {ran}; each replay "
             f"counts {adds}" + (f", want {want}" if want else ""))
    return adds


def check_captured_launches(torch, label, counts, model, ids, prefill,
                            per_step, kernel_fns):
    """The launch gate of a captured ``generate(ids, DEC_STEPS)``: the
    counts (the wrappers' for the prefill and the eager first decode step,
    ``graphs.Captured``'s for each of the DEC_STEPS - 2 replays) equal
    ``prefill`` plus DEC_STEPS - 1 steps of ``per_step`` exactly; and a
    step captured the same way (``replay_profile``) runs, in each of
    REPLAYS_PROFILED profiled replays, the kernels that a replay counts (a
    profile short of them and over none is taken again over one replay
    more, up to PROFILE_ATTEMPTS times)."""
    want = {k: prefill[k] + (DEC_STEPS - 1) * per_step[k] for k in per_step}
    if counts != want:
        fail(f"{label} launches {counts}, want {want}")
    short = []
    for attempt in range(PROFILE_ATTEMPTS):
        # the profiler can drop a kernel record of a long replay, at the
        # same record of a profile of the same length: a profile short of
        # the counts, and never over them, is taken again over one replay
        # more (as ``profile_engine_chunk`` retakes its own)
        reps = REPLAYS_PROFILED + attempt
        rows, _, program = replay_profile(torch, model, ids, reps)
        ran = executions(rows)
        lost = any(ran.get(k, 0) < reps * n for k, n in per_step.items()) \
            and all(ran.get(k, 0) <= reps * n for k, n in per_step.items()) \
            and set(ran) <= {k for k, n in per_step.items() if n}
        if not lost or attempt == PROFILE_ATTEMPTS - 1:
            break
        short.append({"replays": reps, "ran": ran, "rows": {
            e.key[:120]: e.count for e in rows
            if kernel_of(e.key) or "qgemm" in e.key or "decode_attn"
            in e.key or e.key.startswith("_Z")}})
    if short:
        log(json.dumps({"phase": f"{label}_step_profile_retaken",
                        "profiles_short_of_the_counts": short,
                        "each_replay_counts": per_step}))
    check_replays(f"{label} captured step", program, kernel_fns, ran, reps,
                  per_step)


def executions(rows):
    """{kernel: executions} of the port's kernels in a profile's device
    rows (eager launches and graph replays alike)."""
    out = {}
    for e in rows:
        k = kernel_of(e.key)
        if k is not None:
            out[k] = out.get(k, 0) + e.count
    return out


@contextlib.contextmanager
def kernel_profile(torch, warm):
    """Profile the card while the block runs; yields a dict that holds
    ``executions`` when the block ends.  ``warm()`` runs first in the same
    session, left out of the rows (``profiled``: late in this script a
    session's first records go missing)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule
    res = {}
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        yield res
        torch.cuda.synchronize()
    res.update(executions(profile_rows(torch, prof)))


def eager_generate(torch, model, ids, steps):
    """Greedy decoding as a Python loop of eager ``_decode_step`` calls (the
    parent's ``generate()``): int32 [B, steps]."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        out = [tok]
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)
        for _ in range(1, steps):
            codes, cache = model._decode_step(cache, pos, tok)
            tok = codes.argmax(-1)
            out.append(tok)
            pos = pos + 1
    return torch.stack(out, 1).cpu().numpy().astype(np.int32)


def teacher_forced_captured(torch, model, prompt, tokens):
    """``teacher_forced`` with the decode step captured as a CUDA graph
    (``graphs.run_steps``, as ``generate()`` runs it): the step reads its
    token from ``tokens`` at a column held on the card."""
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.tensor import Tensor
    b, steps = tokens.shape
    with torch.no_grad():
        codes0, cache = model._prefill(Tensor(prompt))
        out = torch.empty((b, steps, codes0.shape[-1]), dtype=codes0.dtype,
                          device=prompt.device)
        out[:, 0] = codes0
        pos = torch.full((), prompt.shape[1], dtype=torch.int64,
                         device=prompt.device)
        col = torch.ones((1,), dtype=torch.int64, device=prompt.device)
        tok = tokens[:, 0].clone()

        def step():
            codes, _ = model._decode_step(cache, pos, tok)
            out.index_copy_(1, col, codes[:, None])
            tok.copy_(tokens.index_select(1, col).reshape(-1))
            pos.add_(1)
            col.add_(1)

        program = graphs.run_steps(step, steps - 1, prompt.device)
        torch.cuda.synchronize()
    del program
    return out


def captured_vs_eager(torch, model, ids, tokens, label, steps=DEC_STEPS):
    """The captured ``generate()``'s first ``steps`` tokens against the
    eager step loop's, and ``steps`` teacher-forced steps' logits (u8 codes
    or floats) through a captured step against the eager step's: both
    equal, bit for bit."""
    eager = eager_generate(torch, model, ids, steps)
    prompt = torch.tensor(ids, dtype=torch.int64, device=model.device)
    toks = torch.tensor(tokens[:, :steps], dtype=torch.int64,
                        device=model.device)
    got = teacher_forced_captured(torch, model, prompt, toks)
    want = teacher_forced(torch, model, prompt, toks)
    same_tokens = bool(np.array_equal(tokens[:, :steps], eager))
    same = bool(torch.equal(got, want))
    log(json.dumps({"phase": f"{label}_captured_vs_eager",
                    "tokens_equal": same_tokens, "teacher_forced_steps": steps,
                    "logits": int(got.numel()), "bitwise_equal": same,
                    "max_abs_diff": float((got.float() - want.float()).abs()
                                          .max()),
                    "limit": "bitwise equal"}))
    if not (same and same_tokens):
        fail(f"{label}: the captured decode differs from the eager step "
             f"loop (tokens equal {same_tokens}, logits equal {same})")


def time_eager_steps(torch, model, ids):
    """The eager step loop's ms/step: ``(t(EAGER_STEPS[1]) -
    t(EAGER_STEPS[0])) / their difference``, one run each (an eager
    gemma-2-2b step takes ~0.1 s)."""
    times = {}
    for steps in EAGER_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_generate(torch, model, ids, steps)
        times[steps] = time.perf_counter() - t0
    lo, hi = EAGER_STEPS
    return 1e3 * (times[hi] - times[lo]) / (hi - lo)


def profiled(torch, fn, reps, warm, warm_calls=1):
    """(device rows, wall µs a call) of ``reps`` calls of ``fn`` profiled
    after ``warm_calls`` calls of ``warm`` in the same profiler session,
    which the rows leave out: late in this script a session's first
    records go missing (a long replay's first B2, all of a short graph's)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1)) as prof:
        for _ in range(warm_calls):
            warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    return profile_rows(torch, prof), wall_us


def replay_profile(torch, model, ids, reps):
    """A decode step of ``ids`` captured as ``generate()`` captures it (one
    eager step, then the capture), and ``reps`` replays profiled after a
    warm-up replay (``profiled``): (device rows, wall µs a replay, the
    ``graphs.Captured`` program)."""
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)

        def step():
            codes, _ = model._decode_step(cache, pos, tok)
            tok.copy_(codes.argmax(-1))
            pos.add_(1)

        program = graphs.run_steps(step, 1, dev)
        torch.cuda.synchronize()
        rows, wall_us = profiled(torch, program, reps, program.graph.replay)
    return rows, wall_us, program


def profile_captured(torch, model, ids, label, reps=16):
    """Device time and idle share while a captured decode step replays."""
    rows, wall_us, _ = replay_profile(torch, model, ids, reps)
    busy = sum(e.self_device_time_total for e in rows) / reps
    log(json.dumps({"profile": f"{label}: captured decode_step replay",
                    "batch": ids.shape[0], "wall_us_per_step": wall_us,
                    "device_busy_us_per_step": busy,
                    "device_idle_share": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total / reps,
                              "calls_per_step": e.count / reps}
                             for e in rows[:20]]}))


def results(futs):
    return [f.result(timeout=WAIT_S) for f in futs]


def first_new(full, lo):
    """The first index from ``lo`` whose token does not occur before it."""
    return next(j for j in range(lo, len(full))
                if int(full[j]) not in full[:j].tolist())


def saturated_load(torch, eng, vocab, label, collect=False):
    """SERVE_LOAD greedy requests submitted at once to a warm engine, each
    through ``submit_stream`` on its own thread: tokens/s over the whole
    load, time to first token (TTFT) p50/p99 and the mean slot fill.
    ``collect``: returns (result, prompts, each request's tokens)."""
    import threading
    from int8inferenceengine_tpu_torch.serve import GenerationStats
    n, t_prompt, new = SERVE_LOAD
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, t_prompt).astype(np.int32)
               for _ in range(n)]
    first = [None] * n
    counts = [0] * n
    toks = [[] for _ in range(n)]

    def consume(i, it, t0):
        for tok in it:
            if counts[i] == 0:
                first[i] = time.perf_counter() - t0
            counts[i] += 1
            toks[i].append(tok)

    eng.stats = GenerationStats()
    t0 = time.perf_counter()
    streams = [(eng.submit_stream(p, new), time.perf_counter())
               for p in prompts]
    threads = [threading.Thread(target=consume, args=(i, it, ts))
               for i, (it, ts) in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    if any(c != new for c in counts):
        fail(f"{label}: saturated load delivered {counts}, want {new} each")
    res = {"phase": f"{label}_saturated_load", "requests": n,
           "prompt_tokens": t_prompt, "new_tokens": new, **SERVE,
           "wall_s": wall, "tokens_per_s": n * new / wall,
           "ttft_ms_p50": float(np.percentile(first, 50) * 1e3),
           "ttft_ms_p99": float(np.percentile(first, 99) * 1e3),
           "mean_slot_fill": eng.stats.mean_slot_fill,
           "chunks": eng.stats.chunks, "prefills": eng.stats.prefills,
           "latency_ms": eng.stats.latency_percentiles()}
    log(json.dumps(res))
    if collect:
        return res, prompts, [np.asarray(t, np.int32) for t in toks]
    return res


def bench_engine_load(torch, model):
    """bench.py's engine leg (BENCH_ENGINE, BENCH_ENGINE_LOAD) on a new
    engine: delivered tokens / wall seconds of a round of requests
    submitted at once, best of 2 after one warm round."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    n, t_prompt, new = BENCH_ENGINE_LOAD
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.vocab_size, (t_prompt,)).astype(np.int32)
               for _ in range(n)]
    eng = GenerationEngine(model, **BENCH_ENGINE)
    try:
        def round_once():
            t0 = time.perf_counter()
            futs = [eng.submit(p, new) for p in prompts]
            ntok = sum(len(x) for x in results(futs))
            return ntok / (time.perf_counter() - t0)

        warm = round_once()
        rates = [round_once() for _ in range(2)]
    finally:
        eng.shutdown()
    log(json.dumps({"phase": "gpt2_engine_bench_protocol", "requests": n,
                    "prompt_tokens": t_prompt, "new_tokens": new,
                    **BENCH_ENGINE, "warm_round_tokens_per_s": warm,
                    "rounds_tokens_per_s": rates,
                    "tokens_per_s": max(rates)}))


def serve_decoder(torch, model, label, kernel_fns, sampled_and_eos=True,
                  profile=False):
    """A decoder's GenerationEngine at SERVE: 16 requests (gpt2: 10 greedy,
    4 sampled, 2 with an eos) or 8 greedy ones, twice through one engine
    (the second pass replays the captured chunks).  Gates: each greedy
    request equals ``generate()`` of its prompt alone; an eos request ends
    where that greedy run first emits its eos; sampled requests give the
    same tokens in both passes.  Then the saturated load, and the greedy
    chunk graph's kernels checked in a profiled replay (``check_replays``).
    Returns the launches of the first pass: its prefills, each variant's
    eager first chunk and every chunk replay (``graphs.Captured`` adds a
    replay's kernels to the counts)."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    vocab = model.vocab_size
    rng = np.random.default_rng(7)
    n_req = 16 if sampled_and_eos else 8
    reqs = []
    for i in range(n_req):
        p = rng.integers(0, vocab, SERVE_PROMPTS[i % len(SERVE_PROMPTS)])
        reqs.append(dict(prompt=p.astype(np.int32),
                         new=int(rng.integers(64, 129)), kw={}))
    if sampled_and_eos:
        for i in range(10, 14):
            reqs[i]["kw"] = dict(SERVE_SAMPLED, seed=100 + i)
        for i in (14, 15):
            full = model.generate(reqs[i]["prompt"][None], reqs[i]["new"])[0]
            j = first_new(full, 12)
            reqs[i]["kw"] = dict(eos_id=int(full[j]))
            reqs[i]["want"] = full[:j + 1]
    for r in reqs:
        if "want" not in r and not r["kw"]:
            r["want"] = model.generate(r["prompt"][None], r["new"])[0]
    eng = GenerationEngine(model, **SERVE)
    try:
        reset_counts(kernel_fns)
        t0 = time.perf_counter()
        passes = [results([eng.submit(r["prompt"], r["new"], **r["kw"])
                           for r in reqs])]
        first_s = time.perf_counter() - t0
        counts = read_counts(kernel_fns)
        stats1 = dataclass_stats(eng.stats)
        t0 = time.perf_counter()
        passes.append(results([eng.submit(r["prompt"], r["new"], **r["kw"])
                               for r in reqs]))
        second_s = time.perf_counter() - t0
        bad = []
        for i, r in enumerate(reqs):
            a, b = passes[0][i], passes[1][i]
            if not np.array_equal(a, b):
                bad.append(f"request {i} differs between passes")
            if "want" in r and not np.array_equal(a, r["want"]):
                bad.append(f"request {i} ({r['kw'] or 'greedy'}) differs "
                           f"from generate()")
        sampled_vs_generate = [
            bool(np.array_equal(passes[0][i], model.generate(
                r["prompt"][None], r["new"], **r["kw"])[0]))
            for i, r in enumerate(reqs) if "temperature" in r["kw"]]
        log(json.dumps({"phase": f"{label}_engine", "requests": n_req,
                        **SERVE, "greedy": sum("want" in r and not r["kw"]
                                               for r in reqs),
                        "sampled": sum("temperature" in r["kw"]
                                       for r in reqs),
                        "eos": sum("eos_id" in r["kw"] for r in reqs),
                        "tokens": int(sum(len(x) for x in passes[0])),
                        "first_pass_s": first_s, "second_pass_s": second_s,
                        "first_pass_stats": stats1,
                        "launches_first_pass": counts,
                        "sampled_equal_to_generate_row0":
                            sampled_vs_generate,
                        "problems": bad}))
        if bad:
            fail(f"{label} engine: {bad}")
        saturated_load(torch, eng, vocab, label)
        profile_engine_chunk(torch, eng, label, kernel_fns, 1, show=False)
        if profile:
            profile_engine_chunk(torch, eng, label, kernel_fns)
    finally:
        eng.shutdown()
    return counts


# a profile of a long graph's replay can lose kernel records (3 of the
# 1,568 B6 launches of one llama chunk replay on an H100), never add any:
# a profile short of the counts is taken again, up to this many times
PROFILE_ATTEMPTS = 3


def profile_engine_chunk(torch, eng, label, kernel_fns, reps=4, show=True):
    """Device time and idle share while the engine's greedy chunk graph
    replays with every slot active (run after the engine's last request:
    the replays only move its idle state); the kernels that the replays
    ran must be what each replay counts (``check_replays``).  A profile
    that saw fewer kernels than that, and none more, is taken again, up to
    PROFILE_ATTEMPTS times."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    chunk = eng._chunk_fns[(False, False, False)]
    adds = per_replay(chunk, kernel_fns)
    short = []
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.cuda.stream(eng._stream):
            eng._act.fill_(True)
            eng._rem.fill_(1 << 30)
            eng._pos.fill_(SERVE_LOAD[1])
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    eng._col.zero_()
                    chunk()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6 / reps
        rows = profile_rows(torch, prof)
        ran = executions(rows)
        lost = any(ran.get(k, 0) < reps * n for k, n in adds.items()) and \
            all(ran.get(k, 0) <= reps * n for k, n in adds.items()) and \
            set(ran) <= {k for k, n in adds.items() if n}
        if not lost or attempt == PROFILE_ATTEMPTS - 1:
            break
        short.append(ran)
    if short:
        log(json.dumps({"phase": f"{label}_engine_chunk_profile_retaken",
                        "profiles_short_of_the_counts": short,
                        "each_replay_counts": adds, "replays": reps}))
    adds = check_replays(f"{label} engine chunk", chunk, kernel_fns, ran,
                         reps)
    if not show:
        log(json.dumps({"phase": f"{label}_engine_chunk_replay",
                        "replays_profiled": reps, "kernels_each": adds}))
        return
    busy = sum(e.self_device_time_total for e in rows) / reps
    steps = eng.chunk_steps
    log(json.dumps({"profile": f"{label}: engine chunk replay",
                    "slots": eng.slots, "chunk_steps": steps,
                    "wall_us_per_step": wall_us / steps,
                    "device_busy_us_per_step": busy / steps,
                    "device_idle_share": 1 - busy / wall_us,
                    "by_kernel": by_kernel(rows, reps * steps),
                    "rows": [{"name": e.key[:90],
                              "us_per_step": e.self_device_time_total
                              / (reps * steps),
                              "calls_per_step": e.count / (reps * steps)}
                             for e in rows[:20]]}))


def dataclass_stats(stats):
    return {"requests": stats.requests, "tokens": stats.tokens,
            "prefills": stats.prefills, "chunks": stats.chunks,
            "mean_slot_fill": stats.mean_slot_fill}


def small_engines_vs_cpu(torch, q, zoo, TD, LL, dev):
    """The small decoders of the card-vs-CPU gate served by an engine on
    the card and by one on the CPU (its copy of the converted state): the
    greedy tokens equal (gated where every prefill dispatches as on the
    card), the sampled ones recorded."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.ops.w4 import use_v2
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    bad = []
    for family, slots, extra in SMALL_SERVE:
        geo = dict(SMALL_DEC, **extra)
        if family == "gpt2":
            name, cfg, residual = "gpt_tiny", {}, ("proj", "fc2")
            twin = TD.torch_text_decoder(**geo, seed=0)
        else:
            geo.setdefault("kv_heads", 2)
            name, cfg, residual = "llama_tiny", LLAMA_W4A8, ("proj", "down")
            twin = LL.torch_llama(**geo, seed=0)
        state = decoder_state(torch, twin, geo["depth"], seed=2,
                              residual=residual)
        ids = np.random.default_rng(2).integers(
            0, geo["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(np.int32)
        model = zoo.build(name, config=q.QuantConfig(**cfg), device=dev,
                          **geo)
        model.load(state)
        model.prepare()
        model(q.tensor(ids, device=dev))
        model.convert()
        cpu = zoo.build(name, config=q.QuantConfig(**cfg), device="cpu",
                        **geo)
        load_jax_state(cpu, export_state(model))
        rng = np.random.default_rng(5)
        reqs = [(rng.integers(0, geo["vocab_size"], SMALL_SERVE_PROMPTS[
            i % len(SMALL_SERVE_PROMPTS)]).astype(np.int32),
            {} if i < 6 else dict(SERVE_SAMPLED, seed=i)) for i in range(8)]
        outs = {}
        for where, m in (("card", model), ("cpu", cpu)):
            eng = GenerationEngine(m, slots=slots, chunk_steps=8,
                                   sync_chunks=2)
            try:
                outs[where] = results([eng.submit(p, SMALL_STEPS, **kw)
                                       for p, kw in reqs])
            finally:
                eng.shutdown()
        # the W4A8 prefill dispatches B6's function (exact on both sides)
        # where M = n x bucket is in its envelope at every K
        ks = {geo["dim"], model.mlp_hidden}
        group = cfg.get("w4_group", 128)
        on_b6 = family == "gpt2" or all(
            use_v2(n * bucket, k, group, -(-k // group))
            for k in ks for bucket in {8, 16, 32}
            for n in (1, 2, 4, 8) if n <= slots)
        greedy = [bool(np.array_equal(outs["card"][i], outs["cpu"][i]))
                  for i in range(6)]
        sampled = [bool(np.array_equal(outs["card"][i], outs["cpu"][i]))
                   for i in range(6, 8)]
        log(json.dumps({"phase": "engine_card_vs_cpu", "family": family,
                        "slots": slots, **geo, "new_tokens": SMALL_STEPS,
                        "greedy_equal": greedy, "sampled_equal": sampled,
                        "prefill_on_b6_only": on_b6, "gated": on_b6,
                        "sampled_gated": False}))
        if on_b6 and not all(greedy):
            bad.append(family)
    if bad:
        fail(f"engine greedy tokens on the card differ from the CPU's: {bad}")


def serve_cnn(torch, q, model, kernel_fns, label="alexnet"):
    """A 224 x 224 model's InferenceEngine (max_batch 100, one captured
    forward per tile; AlexNet's, ResNet-50's and ViT-B/16's): requests of
    ALEX_REQUESTS images equal the direct call on the same images exactly,
    and their launches (eager first batches and replays) equal the kernels
    that a profile of them saw run; then ALEX_LOAD batches of 100 at once,
    images/s beside the direct calls' (host input and output both ways).
    Returns the requests' launches."""
    from int8inferenceengine_tpu_torch.serve import InferenceEngine
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((n, 3, 224, 224)).astype(np.float32)
          for n in ALEX_REQUESTS]
    eng = InferenceEngine(model, max_batch=100)
    try:
        with kernel_profile(torch, lambda: model(q.tensor(xs[0]))) \
                as executed:
            reset_counts(kernel_fns)
            got = results([eng.submit(x) for x in xs])
        counts = read_counts(kernel_fns)
        if counts != {k: executed.get(k, 0) for k in counts}:
            fail(f"{label} engine: the counts {counts} differ from the "
                 f"kernels that the profile saw run {executed}")
        equal = [bool(np.array_equal(g, model(q.tensor(x)).numpy()))
                 for g, x in zip(got, xs)]
        log(json.dumps({"phase": f"{label}_engine", "requests":
                        list(ALEX_REQUESTS), "equal_to_direct": equal,
                        "steps": eng.stats.steps,
                        "padded_rows": eng.stats.padded_rows,
                        "launches": counts, "kernel_executions": executed}))
        if not all(equal):
            fail(f"{label} engine results differ from the direct call: "
                 f"{equal}")
        batch = xs[-1]
        rates = {}
        for trial in range(2):
            t0 = time.perf_counter()
            results([eng.submit(batch) for _ in range(ALEX_LOAD)])
            rates.setdefault("engine", []).append(
                ALEX_LOAD * 100 / (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALEX_LOAD):
                model(q.tensor(batch)).numpy()
            rates.setdefault("direct", []).append(
                ALEX_LOAD * 100 / (time.perf_counter() - t0))
        log(json.dumps({"phase": f"{label}_engine_saturated_load",
                        "batches": ALEX_LOAD, "images_per_batch": 100,
                        "engine_images_per_s": rates["engine"],
                        "direct_images_per_s": rates["direct"],
                        "latency_ms": eng.stats.latency_percentiles()}))
    finally:
        eng.shutdown()
    return counts


# -- phase 11: per-kernel times -----------------------------------------------

# -- phases 15-18: the cached multi-token extend -----------------------------

def captured(torch, fn, dev):
    """``fn`` as a ``graphs.Captured`` program, its first (eager) call on a
    side stream as ``graphs.run_steps`` makes it; later calls replay."""
    from int8inferenceengine_tpu_torch import graphs
    side = torch.cuda.Stream(dev)
    program = graphs.Captured(fn, side)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream(dev).wait_stream(side)
    return program


def extend_attn_bound_ms(b, t, h, hkv, d, valid, mq, plan=None):
    """The bound of B3 over mq query rows whose first position sees
    ``valid`` columns: q and the output moved once, each live K and V row
    read once (the span of the last row), QK^T and P@V over each row's own
    causal horizon as int8 operations.  With ``plan``, also the bytes its
    row tiles read (each tile reads its own span)."""
    live = min(valid + mq - 1, t)
    cols = sum(min(valid + j, t) for j in range(mq))
    res = bound(2 * b * mq * h * d + 2 * b * live * hkv * d + 4 * b,
                4.0 * b * h * d * cols)
    if plan is None:
        return res
    tile_rows = sum(min(valid + min(j0 + plan.mq_tile, mq) - 1, t)
                    for j0 in range(0, mq, plan.mq_tile))
    return res + (2 * b * tile_rows * hkv * d,)


def check_extend_attention(torch, A, gen, dev):
    """B3 at the extend shapes (EXT_MQ x EXT_T x EXT_HEADS, batch EXT_B)
    against its plain version, bit for bit: live lengths 1 and T - mq + 1,
    a per-sequence vector, the same with a window; under the planner's plan
    and under every legal row tile (``split_plan`` at each mq_tile that
    fits).  The plain twin at the planner's plan must equal the composed
    version, and the kernel at every tiling the plain twin.  Returns the
    largest |code difference| (0, or the run fails)."""
    b, d = EXT_B, 64
    for t in EXT_T:
        for h, kv in EXT_HEADS:
            grp = h // kv
            for mq in EXT_MQ:
                q = torch.randint(0, 256, (b, mq, h * d), generator=gen,
                                  dtype=torch.uint8, device=dev)
                k, v = (torch.randint(0, 256, (b, t, kv * d), generator=gen,
                                      dtype=torch.uint8, device=dev)
                        for _ in range(2))
                per_seq = torch.randint(1, t - mq + 2, (b,), generator=gen,
                                        dtype=torch.int32, device=dev)
                chosen = A.plan_decode_attn(b, t, h, kv, d, mq)
                plans = [A.split_plan(x, grp, t, d) for x in range(1, mq + 1)]
                plans = [p for p in plans if p.smem <= A.SMEM_LIMIT]
                if chosen not in plans:
                    fail(f"B3 extend: the planner's {chosen} is not a legal "
                         f"tiling at T={t} H={h} Hkv={kv} mq={mq}")
                for valid, window in ((1, None), (t - mq + 1, None),
                                      (per_seq, None), (per_seq, t // 4)):
                    kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=kv,
                              window=window)
                    want = A.decode_attention_split_plain(
                        q, k, v, valid, splits=chosen.splits,
                        mq_tile=chosen.mq_tile, **kw)
                    composed = A.decode_attention_flat(q, k, v, valid,
                                                       backend="xla", **kw)
                    if not torch.equal(want, composed):
                        fail(f"B3 extend: the plain twin differs from the "
                             f"composed version at T={t} H={h} Hkv={kv} "
                             f"mq={mq} {chosen}")
                    for plan in plans:
                        got = A.decode_attention_flat(q, k, v, valid,
                                                      plan=plan, **kw)
                        if not torch.equal(got, want):
                            fail(f"B3 extend kernel != plain at T={t} H={h} "
                                 f"Hkv={kv} mq={mq} window={window} {plan} "
                                 f"valid={valid if isinstance(valid, int) else 'per-seq'}: "
                                 f"{int((got != want).sum())} codes differ")
                log(json.dumps({"phase": "attn_extend_kernel_vs_plain",
                                "B": b, "T": t, "H": h, "Hkv": kv, "D": d,
                                "mq": mq, "plan": chosen._asdict(),
                                "mq_tiles_checked": len(plans),
                                "valid": [1, t - mq + 1, "per-seq",
                                          f"per-seq, window {t // 4}"],
                                "max_abs_err": 0, "limit": "equal"}))
    return 0


def time_extend_attention(torch, A, gen, dev, flush):
    """B3's ms a launch at every extend shape (batch 1, the last row at the
    cache's end) under the planner's plan, with its bound and the bytes its
    row tiles read; then rows for the kernels line at the main path's two
    extends (EXT_UNITS), with the plain version's time."""
    d = 64
    table = []
    for t in EXT_T:
        for h, kv in EXT_HEADS:
            for mq in EXT_MQ:
                q = torch.randint(0, 256, (1, mq, h * d), generator=gen,
                                  dtype=torch.uint8, device=dev)
                k, v = (torch.randint(0, 256, (1, t, kv * d), generator=gen,
                                      dtype=torch.uint8, device=dev)
                        for _ in range(2))
                valid = torch.full((), t - mq + 1, dtype=torch.int32,
                                   device=dev)
                kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=kv)
                plan = A.plan_decode_attn(1, t, h, kv, d, mq)
                ms = time_cuda(torch, lambda: A.decode_attention_flat(
                    q, k, v, valid, **kw), iters=10, flush=flush)
                b_ms, b_by, _, _, tile_bytes = extend_attn_bound_ms(
                    1, t, h, kv, d, t - mq + 1, mq, plan)
                table.append(dict(T=t, H=h, Hkv=kv, mq=mq,
                                  plan=plan._asdict(), ms=ms, bound_ms=b_ms,
                                  bound_by=b_by,
                                  tile_read_bytes=tile_bytes,
                                  tile_read_bound_ms=1e3 * (
                                      tile_bytes + 4 * mq * h * d)
                                  / PEAK_BYTES))
    log(json.dumps({"phase": "attn_extend_times", "B": 1, "D": d,
                    "live": "the last row sees all T", "shapes": table}))
    rows = []
    for label, b, mq, valid, per in EXT_UNITS:
        t, h, kv = DEC_ATTN["t"], DEC_ATTN["h"], DEC_ATTN["h"]
        q = torch.randint(0, 256, (b, mq, h * d), generator=gen,
                          dtype=torch.uint8, device=dev)
        k, v = (torch.randint(0, 256, (b, t, kv * d), generator=gen,
                              dtype=torch.uint8, device=dev)
                for _ in range(2))
        valid_t = torch.full((), valid, dtype=torch.int32, device=dev)
        kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=kv)
        plan = A.plan_decode_attn(b, t, h, kv, d, mq)
        ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k, v, valid_t, **kw), iters=20, flush=flush)
        plain_ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k, v, valid_t, backend="xla", **kw), iters=5, flush=flush)
        b_ms, b_by, t_ops, t_bytes, tile_bytes = extend_attn_bound_ms(
            b, t, h, kv, d, valid, mq, plan)
        rows.append(dict(kernel="decode_attn_flat", path=label,
                         layer=f"attention, {mq} query rows (live length "
                               f"{valid} of {t})", B=b, T=t, H=h, Hkv=kv,
                         D=d, mq=mq, plan=plan._asdict(),
                         launches_per_unit=per, ms=ms, bound_ms=b_ms,
                         bound_by=b_by, plain_ms=plain_ms, library_ms=None,
                         tile_read_bytes=tile_bytes, t_ops=t_ops,
                         t_bytes=t_bytes))
        log(json.dumps({k_: v_ for k_, v_ in rows[-1].items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": b_ms / ms}))
    return rows


def extend_vs_decode(torch, model, ids, label, kernel_fns):
    """From one prefill cache of ``ids``, ``_extend_step`` at m = 5 (the
    batch of ``ids``) and at m = 64 (its first row) against m
    ``_decode_step`` calls: the logit codes and every layer's cache equal.
    The m = 5 extend launches as many kernels as a decode step, B3 as
    often (one a layer).  Then the ms of one m = 5 extend against 5 decode
    steps, both captured.  Returns the m = 5 extend's launches."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    rng = np.random.default_rng(5)
    t0 = ids.shape[1]
    with torch.no_grad():
        _, cache0 = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
    res = {"phase": f"{label}_extend_vs_decode", "prompt": t0}
    scratch = {i: (kc.clone(), vc.clone()) for i, (kc, vc) in cache0.items()}
    reset_counts(kernel_fns)
    with torch.no_grad():
        model._decode_step(scratch, t0, torch.zeros(
            ids.shape[0], dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    per_step = read_counts(kernel_fns)
    del scratch
    counts = None
    for b, m in ((ids.shape[0], SPEC_K + 1), (1, PREFILL_CHUNK)):
        toks = torch.tensor(rng.integers(0, model.vocab_size, (b, m)),
                            dtype=torch.int64, device=dev)
        ext = {i: (kc[:b].clone(), vc[:b].clone())
               for i, (kc, vc) in cache0.items()}
        seq = {i: (kc[:b].clone(), vc[:b].clone())
               for i, (kc, vc) in cache0.items()}
        reset_counts(kernel_fns)
        with torch.no_grad():
            got, _ = model._extend_step(ext, t0, toks)
        torch.cuda.synchronize()
        if counts is None:
            counts = read_counts(kernel_fns)
        want = decode_from(torch, model, seq, t0, toks)
        same_cache = all(torch.equal(ext[i][0], seq[i][0])
                         and torch.equal(ext[i][1], seq[i][1]) for i in ext)
        mx, share = contract(torch, got, want)
        res[f"b{b}_m{m}"] = {"codes": int(got.numel()), "max_abs_err": mx,
                             "caches_equal": same_cache}
        if mx or not same_cache:
            fail(f"{label}: an extend of {m} rows at batch {b} differs from "
                 f"{m} decode steps (codes max {mx}, share {share}; caches "
                 f"equal: {same_cache})")
        del ext, seq
    if counts["decode_attn_flat"] != per_step["decode_attn_flat"] or \
            sum(counts.values()) != sum(per_step.values()):
        fail(f"{label}: an extend ran {counts}, a decode step {per_step}")
    # one m = 5 extend and 5 decode steps, each a captured program
    b, m = ids.shape[0], SPEC_K + 1
    cache = {i: (kc.clone(), vc.clone()) for i, (kc, vc) in cache0.items()}
    toks = torch.tensor(rng.integers(0, model.vocab_size, (b, m)),
                        dtype=torch.int64, device=dev)
    pos = torch.full((), t0, dtype=torch.int64, device=dev)
    with torch.no_grad():
        ext_prog = captured(torch, lambda: model._extend_step(cache, pos,
                                                              toks), dev)
        tok = toks[:, 0].clone()
        step_prog = captured(torch, lambda: model._decode_step(cache, pos,
                                                               tok), dev)
        res["extend_m5_ms"] = min(time_cuda(torch, ext_prog, iters=20)
                                  for _ in range(2))
        res["decode_5_steps_ms"] = min(
            time_cuda(torch, lambda: [step_prog() for _ in range(m)],
                      iters=20) for _ in range(2))
    res["launches_per_extend"] = counts
    res["launches_per_decode_step"] = per_step
    log(json.dumps(res))
    del cache, cache0, ext_prog, step_prog
    return counts


def speculative_path(torch, target, draft, ids, label, kernel_fns, k=SPEC_K,
                     steps=SPEC_STEPS):
    """``generate_speculative`` of ``ids`` with ``draft`` equal to
    ``generate()`` token for token; tokens/s of both (best of 2, the same
    call), the mean tokens emitted per row and macro-step, and the
    launches per macro-step (past the two prefills).  Returns the
    launches of the first speculative run."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    b = ids.shape[0]
    walls = {"generate": [], "speculative": []}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = target.generate(ids, steps)
        walls["generate"].append(time.perf_counter() - t0)
    counts = None
    for _ in range(2):
        reset_counts(kernel_fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = target.generate_speculative(draft, ids, steps, k=k)
        walls["speculative"].append(time.perf_counter() - t0)
        if counts is None:
            counts = read_counts(kernel_fns)
            stats = dict(target.speculative_stats)
        if not np.array_equal(got, want):
            fail(f"{label}: speculative decoding differs from generate() on "
                 f"{int((got != want).sum())} of {got.size} tokens")
    reset_counts(kernel_fns)
    prompt = Tensor(torch.tensor(ids.astype(np.int64), device=target.device))
    with torch.no_grad():
        target._prefill(prompt)
        draft._prefill(prompt)
    torch.cuda.synchronize()
    prefills = read_counts(kernel_fns)
    n = stats["macro_steps"]
    log(json.dumps({
        "phase": f"{label}_speculative", "batch": b, "prompt": ids.shape[1],
        "steps": steps, "k": k, "equal_to_generate": True,
        "generate_s": walls["generate"], "speculative_s": walls["speculative"],
        "generate_tokens_per_s": b * steps / min(walls["generate"]),
        "speculative_tokens_per_s": b * steps / min(walls["speculative"]),
        "macro_steps": n, "row_steps": stats["row_steps"],
        "emitted": stats["emitted"],
        "mean_tokens_per_row_step": stats["emitted"] / stats["row_steps"],
        "acceptance": (stats["emitted"] / stats["row_steps"] - 1) / k,
        "launches": counts,
        "launches_per_macro_step": {
            name: (counts[name] - prefills[name]) / n for name in counts}}))
    return counts


def build_draft(torch, q, zoo, TD, ids):
    """The speculative gpt2 target's draft: a gpt_tiny over the same
    vocabulary at SPEC_DRAFT, GPT-2-style weights from default_rng(1),
    calibrated on ``ids``."""
    twin = TD.torch_text_decoder(**SPEC_DRAFT, seed=1)
    model = zoo.build("gpt_tiny", **SPEC_DRAFT)
    model.load(decoder_state(torch, twin, SPEC_DRAFT["depth"], seed=1))
    model.prepare()
    model(q.tensor(ids))
    model.convert()
    return model


def ttft_of(eng, prompt, new, **kw):
    """One request alone on a warm engine: (ms to its first streamed token,
    all of its tokens)."""
    t0 = time.perf_counter()
    it = eng.submit_stream(prompt, new, **kw)
    first = next(it)
    ttft = 1e3 * (time.perf_counter() - t0)
    return ttft, np.asarray([first] + list(it), np.int32)


def engine_chunked(torch, model, label, kernel_fns, full=True):
    """The decoder's GenerationEngine with chunked prefill (CHUNK_ENGINE).
    Gates: greedy requests of CHUNK_GREEDY prompt tokens equal
    ``generate()``; with ``full``, sampled ones (CHUNK_SAMPLED) equal a
    bucketed engine's (SERVE), and PREFIX_SUFFIXES requests of a registered
    PREFIX_LEN-token prefix plus 16-64 tokens equal the same prompts
    submitted cold, one at a time, recording TTFT p50 prefixed against
    cold, and a 448-token prompt's TTFT chunked against bucketed.  Returns
    the launches of the first round."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    vocab = model.vocab_size
    rng = np.random.default_rng(17)
    new = CHUNK_NEW
    greedy = [rng.integers(0, vocab, n).astype(np.int32)
              for n in CHUNK_GREEDY]
    sampled = ([rng.integers(0, vocab, n).astype(np.int32)
                for n in CHUNK_SAMPLED] if full else [])
    skw = [dict(SERVE_SAMPLED, seed=200 + i) for i in range(len(sampled))]
    want = [model.generate(p[None], new)[0] for p in greedy]
    res = {"phase": f"{label}_engine_chunked", **CHUNK_ENGINE,
           "greedy_prompts": list(CHUNK_GREEDY), "new_tokens": new}
    bad = []
    bucketed = GenerationEngine(model, **SERVE) if full else None
    eng = GenerationEngine(model, **CHUNK_ENGINE)
    try:
        reset_counts(kernel_fns)
        t0 = time.perf_counter()
        got = results([eng.submit(p, new) for p in greedy]
                      + [eng.submit(p, new, **kw)
                         for p, kw in zip(sampled, skw)])
        res["first_round_s"] = time.perf_counter() - t0
        counts = read_counts(kernel_fns)
        res["launches_first_round"] = counts
        res["extend_program_replays"] = eng._extend_program.replays
        for i, (a, w) in enumerate(zip(got, want)):
            if not np.array_equal(a, w):
                bad.append(f"greedy request {i} ({len(greedy[i])} tokens) "
                           f"differs from generate()")
        if full:
            ref = results([bucketed.submit(p, new, **kw)
                           for p, kw in zip(sampled, skw)])
            for i, (a, w) in enumerate(zip(got[len(greedy):], ref)):
                if not np.array_equal(a, w):
                    bad.append(f"sampled request {i} differs from the "
                               f"bucketed engine's")
            prefix = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
            t0 = time.perf_counter()
            pid = eng.register_prefix(prefix)
            res["register_prefix_ms"] = 1e3 * (time.perf_counter() - t0)
            fulls = [np.concatenate([prefix, rng.integers(
                0, vocab, n).astype(np.int32)]) for n in rng.integers(
                16, 65, PREFIX_SUFFIXES)]
            ttft = {"prefixed": [], "cold": []}
            for i, p in enumerate(fulls):
                tp, a = ttft_of(eng, p, new, prefix_id=pid)
                tc, c = ttft_of(eng, p, new)
                ttft["prefixed"].append(tp)
                ttft["cold"].append(tc)
                if not np.array_equal(a, c):
                    bad.append(f"prefixed request {i} differs from cold")
            res["prefix_hits"] = eng.stats.prefix_hits
            long = greedy[-1]
            t448 = {"chunked": [], "bucketed": []}
            for _ in range(TTFT_REPS):
                t448["chunked"].append(ttft_of(eng, long, 4)[0])
                t448["bucketed"].append(ttft_of(bucketed, long, 4)[0])
            res.update({
                "prefix_tokens": PREFIX_LEN, "prefixed_requests": len(fulls),
                "ttft_ms_p50_prefixed": float(np.median(ttft["prefixed"])),
                "ttft_ms_p50_cold": float(np.median(ttft["cold"])),
                "ttft_ms": ttft,
                f"ttft_ms_p50_{len(long)}_chunked":
                    float(np.median(t448["chunked"])),
                f"ttft_ms_p50_{len(long)}_bucketed":
                    float(np.median(t448["bucketed"])),
                f"ttft_ms_{len(long)}": t448})
    finally:
        eng.shutdown()
        if bucketed is not None:
            bucketed.shutdown()
    res["problems"] = bad
    log(json.dumps(res))
    if bad:
        fail(f"{label} chunked engine: {bad}")
    return counts


def int_mm_operands(torch, a_u8, w_s8_nk):
    """cuBLAS int8 operands: a recentered to s8, M padded to 32 and K, N to
    multiples of 8 with zeros (a zero tap adds nothing)."""
    m, k = a_u8.shape
    n = w_s8_nk.shape[0]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((mp, kp), dtype=torch.int8, device=a_u8.device)
    a[:m, :k] = (a_u8.to(torch.int16) - 128).to(torch.int8)
    w = torch.zeros((np_, kp), dtype=torch.int8, device=a_u8.device)
    w[:n, :k] = w_s8_nk
    return a, w


def conv_bound_ms(geom, n: int):
    """A conv's own bound: the NHWC input, the weights and two 4-byte [N]
    epilogue vectors read once, the output written once, 2MNK operations."""
    b, h, w, c, k, stride, pad = geom
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    m, kk = b * oh * ow, k * k * c
    return bound(b * h * w * c + n * kk + 8 * n + m * n, 2.0 * m * n * kk)


def time_alexnet_gemms(torch, G, C, gen, dev, flush):
    """B1 at one AlexNet b100 forward's shapes: the Linears as GEMMs, the
    convs through the gathered kernel (the forward's route) and, beside it,
    through im2col + B1's GEMM variant (the parent's route)."""
    rows = []
    for layer, m, k, n in ALEXNET_B100:
        c = gemm_case(torch, gen, m, k, n, dev)
        conv = ALEXNET_CONVS.get(layer)
        order = "conv" if conv else "gemm"
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], 0.01, c["s_c"], n, dev, order)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  relu=layer != "fc3", rounding="trunc", order=order)
        row = dict(kernel="qgemm_u8s8", path="alexnet_b100", layer=layer,
                   M=m, K=k, N=n, launches_per_unit=1)
        if conv:
            b, h, w, ci, kk, stride, pad = conv
            g = G.ConvGeom(b, h, w, ci, kk, kk, stride, pad)
            x = torch.randint(0, 256, (b, h, w, ci), generator=gen,
                              dtype=torch.uint8, device=dev)
            ckw = dict(kw, kh=kk, kw=kk, stride=stride, padding=pad,
                       zp_a=c["zp_a"])
            a = C.im2col_nhwc(x, kk, kk, stride, pad,
                              pad_value=c["zp_a"]).reshape(m, k)
            c["a"] = a

            def fn():
                return C.qgemm_conv(x, c["w"], oc, ep, **ckw)

            def plain():
                return C.conv2d_int8_gemm(x, c["w"], oc, ep,
                                          gemm=G.qgemm_plain, **ckw)

            def im2col_b1():
                return G.qgemm(C.im2col_nhwc(x, kk, kk, stride, pad,
                                             pad_value=c["zp_a"]
                                             ).reshape(m, k), c["w"], oc,
                               ep, **kw)

            if not torch.equal(fn().reshape(m, n), im2col_b1()):
                fail(f"{layer}: the gathered conv and im2col + B1 disagree")
            row["im2col_b1_ms"] = time_cuda(torch, im2col_b1, iters=10,
                                            flush=flush)
            row["plan"] = plan_of(G, m, n, k, dev, conv=g)
            row["plan_im2col"] = plan_of(G, m, n, k, dev)
            b_ms, b_by, t_ops, t_bytes = conv_bound_ms(conv, n)
            row["bound_im2col_ms"] = bound_ms(m, k, n)[0]
        else:
            def fn():
                return G.qgemm(c["a"], c["w"], oc, ep, **kw)

            def plain():
                return G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)

            row["plan"] = plan_of(G, m, n, k, dev)
            b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n)
            row["bound_im2col_ms"] = b_ms
        ms = time_cuda(torch, fn, iters=10, flush=flush)
        plain_ms = time_cuda(torch, plain, iters=3, flush=flush)
        # the yardstick: cuBLAS int8 on the GEMM operand (for a conv, the
        # patch matrix written beforehand) and the eager epilogue
        a_s8, w_p = int_mm_operands(torch, c["a"], c["w"])

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(), fn().reshape(m, n)):
            fail(f"{layer}: torch._int_mm + epilogue disagrees with the "
                 f"kernel")
        library_ms = time_cuda(torch, library, iters=5, flush=flush)
        row.update(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                   library_ms=library_ms, t_ops=t_ops, t_bytes=t_bytes)
        rows.append(row)
        log(json.dumps({k_: v for k_, v in row.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": b_ms / ms,
                          "vs_library": ms / library_ms}))
        del c, a_s8, w_p
    tot = {key: sum(r[key] for r in rows)
           for key in ("ms", "bound_ms", "bound_im2col_ms", "plain_ms",
                       "library_ms")}
    tot["im2col_route_ms"] = sum(r.get("im2col_b1_ms", r["ms"])
                                 for r in rows)
    log(json.dumps({"kernels_per_unit": "alexnet_b100"} | tot
                   | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


def time_gemms(torch, G, gen, dev, flush, path, gemms, qkv,
               rounding="trunc"):
    """B1 at each (layer, M, K, N, launches per unit, act) of ``gemms`` and
    B2 at ``qkv`` (M, K, per-head widths, launches per unit), each launch
    timed with L2 flushed, beside its plain version, its bound and
    ``torch._int_mm`` + the eager epilogue (checked equal to the plain
    version first): a row per shape."""
    rows = []
    for layer, m, k, n, per, act_name in gemms:
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], c["s_w_pc"], c["s_c"], n, dev)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  rounding=rounding,
                  act=act_grid(act_name) if act_name else None)
        ms = time_cuda(torch, lambda: G.qgemm(c["a"], c["w"], oc, ep, **kw),
                       iters=20, flush=flush)
        plain_ms = time_cuda(
            torch, lambda: G.qgemm_plain(c["a"], c["w"], oc, ep, **kw),
            iters=3, flush=flush)
        a_s8, w_p = int_mm_operands(torch, c["a"], c["w"])

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(),
                           G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)):
            fail(f"{layer}: torch._int_mm + epilogue disagrees with the "
                 f"plain version")
        library_ms = time_cuda(torch, library, iters=10, flush=flush)
        b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n)
        rows.append(dict(kernel="qgemm_u8s8", path=path, layer=layer, M=m,
                         K=k, N=n, plan=plan_of(G, m, n, k, dev),
                         launches_per_unit=per, ms=ms, bound_ms=b_ms,
                         bound_im2col_ms=b_ms, bound_by=b_by,
                         plain_ms=plain_ms, library_ms=library_ms,
                         t_ops=t_ops, t_bytes=t_bytes))
        del c, a_s8, w_p

    m, k, widths, per = qkv
    n = sum(widths)
    parts, cases = [], []
    for i, w in enumerate(widths):
        c = gemm_case(torch, gen, m, k, w, dev)
        cases.append(c)
        parts.append(dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                          rowsum=rowsum(torch, c["w"]), scale_w=c["s_w_pc"],
                          scale_c=c["s_c"] * (1 + 0.3 * i), zp_c=110 + 9 * i))
    a = cases[0]["a"]
    merged = G.merge_parts(parts, scale_a=cases[0]["s_a"],
                           zp_a=cases[0]["zp_a"])
    ms = time_cuda(torch, lambda: G.qgemm_multi(a, merged,
                                                rounding=rounding),
                   iters=20, flush=flush)
    plain_ms = time_cuda(torch, lambda: G.qgemm_multi_plain(
        a, merged, rounding=rounding), iters=3, flush=flush)
    a_s8, w_p = int_mm_operands(torch, a, merged["w"])

    def library_multi():
        acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
        return G.vzp_epilogue(acc + merged["oc"].reshape(1, -1), merged,
                              rounding=rounding)

    if not torch.equal(library_multi(), torch.cat(
            G.qgemm_multi(a, merged, rounding=rounding), 1)):
        fail("merged QKV: torch._int_mm + epilogue disagrees with the kernel")
    library_ms = time_cuda(torch, library_multi, iters=10, flush=flush)
    b_ms, b_by, t_ops, t_bytes = bound_ms(m, k, n, vectors=3)
    rows.append(dict(kernel="qgemm_u8s8_vzp", path=path, layer="qkv", M=m,
                     K=k, N=n, plan=plan_of(G, m, n, k, dev),
                     launches_per_unit=per, ms=ms, bound_ms=b_ms,
                     bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms,
                     t_ops=t_ops, t_bytes=t_bytes))
    return rows


def log_rows(rows):
    """Print each per-shape row with its share of the bound and its time
    against the library call's."""
    for r in rows:
        log(json.dumps({k_: v for k_, v in r.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": r["bound_ms"] / r["ms"]}
                       | ({"vs_library": r["ms"] / r["library_ms"]}
                          if r["library_ms"] else {})))


def time_decode_kernels(torch, G, A, gen, dev, flush):
    """Each kernel at one decode step's shapes; a row per shape with its
    launches per step."""
    m, k, n, per_step = DEC_QKV
    rows = time_gemms(torch, G, gen, dev, flush, "decode_step", DEC_GEMMS,
                      (m, k, (n, n, n), per_step))
    rows += time_attention(torch, A, gen, dev, flush, DEC_ATTN,
                           "decode_step", "attention")
    log_rows(rows)
    step = {key: sum(r[key] * r["launches_per_unit"] for r in rows)
            for key in ("ms", "bound_ms", "plain_ms")}
    for kernel in ("qgemm_u8s8", "qgemm_u8s8_vzp"):
        mine = [r for r in rows if r["kernel"] == kernel]
        step[kernel] = {key: sum(r[key] * r["launches_per_unit"]
                                 for r in mine)
                        for key in ("ms", "bound_ms", "library_ms")}
    log(json.dumps({"decode_step_kernels": step,
                    "launches_per_step": {
                        "qgemm_u8s8": 37, "qgemm_u8s8_vzp": 12,
                        "decode_attn_flat": 12}}))
    return rows


def time_attention(torch, A, gen, dev, flush, cfg, path, label,
                   rounding="trunc"):
    """B3 at one decode step's shapes under its plan: at the step's mean
    live length (``cfg['valid']``, counted per step) and at T - 1 (a full
    cache, recorded beside it).  ``cfg`` may hold a ``window`` (the bound
    counts the window's rows) and a ``softcap``."""
    b, t, h, d = (cfg[x] for x in ("b", "t", "h", "d"))
    hkv = cfg.get("hkv", h)
    window = cfg.get("window")
    q = torch.randint(0, 256, (b, h * d), generator=gen, dtype=torch.uint8,
                      device=dev)
    k_, v_ = (torch.randint(0, 256, (b, t, hkv * d), generator=gen,
                            dtype=torch.uint8, device=dev) for _ in range(2))
    kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=hkv, rounding=rounding,
              window=window, softcap=cfg.get("softcap"))
    plan = A.plan_decode_attn(b, t, h, hkv, d)
    rows = []
    for valid, per in ((cfg["valid"], cfg["launches"]), (t - 1, 0)):
        valid_t = torch.full((), valid, dtype=torch.int32, device=dev)
        ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k_, v_, valid_t, **kw), iters=20, flush=flush)
        plain_ms = time_cuda(torch, lambda: A.decode_attention_flat(
            q, k_, v_, valid_t, backend="xla", **kw), iters=5, flush=flush)
        live = valid if window is None else min(valid, window)
        b_ms, b_by, t_ops, t_bytes = attn_bound_ms(b, h, hkv, d, live)
        rows.append(dict(kernel="decode_attn_flat", path=path,
                         layer=f"{label} (live length {valid} of {t}"
                               + (f", window {window})" if window else ")"),
                         B=b, T=t, H=h, Hkv=hkv, D=d, plan=plan._asdict(),
                         launches_per_unit=per, ms=ms, bound_ms=b_ms,
                         bound_by=b_by, plain_ms=plain_ms, library_ms=None,
                         t_ops=t_ops, t_bytes=t_bytes))
    return rows


def time_launch_floor(torch, flush):
    """An empty launch (``torch.cuda._sleep(1)``) through ``time_cuda``: the
    event floor every per-launch time sits on."""
    ms = time_cuda(torch, lambda: torch.cuda._sleep(1), iters=50, flush=flush)
    log(json.dumps({"launch_floor": "torch.cuda._sleep(1)", "ms": ms}))
    return ms


def time_w4_kernels(torch, W, A, gen, dev, flush):
    """B6 at the llama decode step's shapes, B7 at the prefill's, B5 at the
    weight-only forward's, and B3 at the llama decode (Hkv = 2); a row per
    shape with its launches per unit of work."""
    rows = []
    shapes = ([("w4a8_v2_gemm", "llama_w4a8_decode_step", name, m, k, n, 256,
                per, name in ("qkv", "gate+up"))
               for name, m, k, n, per in W4_DECODE]
              + [("w4a8_v1_gemm", "llama_w4a8_prefill", name, m, k, n, 256,
                  per, vec) for name, m, k, n, per, vec in W4_PREFILL]
              + [("w4_gemm", "llama_w4_forward", name, m, k, n, 128, per,
                  False) for name, m, k, n, per in W4_FORWARD])
    for kernel, path, name, m, k, n, group, per, vec in shapes:
        c = w4_case(torch, W, gen, m, k, n, group, dev, vector_mult=vec,
                    weight_only=kernel == "w4_gemm")
        library_ms = None
        if kernel == "w4_gemm":
            args = (c["x"], c["packed"], c["scales"], c["bias"], k, group)
            fn, plain = (lambda: W.w4_gemm(*args),
                         lambda: W.w4_gemm_plain(*args))
            # the yardstick: one f32 GEMM (TF32 off) on the weight
            # dequantized before the timed window
            w_deq = W.dequant_w4(c["packed"], c["scales"], k, group)

            def library():
                return torch.addmm(c["bias"], c["x"], w_deq.t())

            if torch.backends.cuda.matmul.allow_tf32:
                fail("TF32 is on: the B5 yardstick must be true f32")
            rel = rel_err(torch, library(), fn())
            if not rel <= W4_RTOL:
                fail(f"B5 yardstick torch.addmm differs from the kernel at "
                     f"{name}: {rel} of the largest |output|")
            library_ms = time_cuda(torch, library, iters=10, flush=flush)
        elif kernel == "w4a8_v2_gemm":
            fn, plain = (lambda: W.w4a8_v2(c["x"], c["ops"], "nearest"),
                         lambda: v2_plain(W, c["x"], c["ops"], "nearest"))
            plan = w4_plan(W.plan_w4a8_v2(m, n, k, group,
                                          sms=W.sm_count(dev)))
        else:
            fn, plain = (lambda: W.w4a8_v1(c["x"], c["ops"], "nearest"),
                         lambda: v1_plain(W, c["x"], c["ops"], "nearest"))
        ms = time_cuda(torch, fn, iters=20, flush=flush)
        plain_ms = time_cuda(torch, plain, iters=3, flush=flush)
        b_ms, b_by, t_ops, t_bytes = w4_bound_ms(kernel, m, k, n, group)
        row = dict(kernel=kernel, path=path, layer=name, M=m, K=k, N=n,
                   group=group, **({"plan": plan} if kernel == "w4a8_v2_gemm"
                                   else {}),
                   launches_per_unit=per, ms=ms, bound_ms=b_ms,
                   bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms,
                   t_ops=t_ops, t_bytes=t_bytes)
        if kernel != "w4a8_v2_gemm":
            row["bound_f32_simt_ms"] = w4_bound_ms(kernel, m, k, n, group,
                                                   simt=True)[0]
        rows.append(row)
        del c

    rows += time_attention(torch, A, gen, dev, flush, LLAMA_ATTN,
                           "llama_w4a8_decode_step", "attention GQA 12/2",
                           rounding="nearest")
    for r in rows:
        log(json.dumps({k_: v for k_, v in r.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": r["bound_ms"] / r["ms"]}))
    for path in ("llama_w4a8_decode_step", "llama_w4a8_prefill",
                 "llama_w4_forward"):
        mine = [r for r in rows if r["path"] == path]
        keys = [key for key in ("ms", "bound_ms", "bound_f32_simt_ms",
                                "plain_ms", "library_ms")
                if all(r.get(key) is not None for r in mine)]
        tot = {key: sum(r[key] * r["launches_per_unit"] for r in mine)
               for key in keys}
        log(json.dumps({"kernels_per_unit": path} | tot
                       | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


def sweep_plans(torch, G, C, W, A, gen, dev, flush):
    """``--sweep``: B1 and B2 at the main paths' shapes under every
    candidate plan (tile x K slices), B6 at the llama decode shapes and at
    M = 16, 64 and 128 under every K split it runs, and B3 at both
    decoders' shapes under every split count, at the step's mean live
    length and at a full cache; one line per shape and plan, the numbers
    ``plan_qgemm``, ``plan_w4a8_v2`` and ``plan_decode_attn`` are tuned
    from."""
    def plans(chosen, m, k):
        """The chosen plan and each tile at 1, 2, 4 and 8 K slices (one
        slice only for large M)."""
        out = [chosen]
        for tile in G.QGEMM_TILES:
            if tile[0] == 16 and m > 100:
                continue
            for want in (1, 2, 4, 8):
                k_slice = -(-(-(-k // want)) // G.QGEMM_KSTEP) * G.QGEMM_KSTEP
                slices = -(-k // k_slice)
                plan = chosen._replace(tile=tile, slices=slices,
                                       k_slice=k if slices == 1 else k_slice)
                if plan not in out and (slices == 1 or m <= 512):
                    out.append(plan)
        return out

    def report(what, shape, plan, fn):
        ms = time_cuda(torch, fn, iters=10, flush=flush)
        log(json.dumps({"sweep": what, "shape": shape, "tile": plan.tile,
                        "slices": plan.slices, "ms": ms,
                        "chosen": plan == chosen}))

    for layer, m, k, n in ALEXNET_B100:
        c = gemm_case(torch, gen, 1 if layer in ALEXNET_CONVS else m, k, n,
                      dev)
        order = "conv" if layer in ALEXNET_CONVS else "gemm"
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], 0.01, c["s_c"], n, dev, order)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  relu=True, order=order)
        if layer in ALEXNET_CONVS:
            b, h, w, ci, kk, stride, pad = ALEXNET_CONVS[layer]
            g = G.ConvGeom(b, h, w, ci, kk, kk, stride, pad)
            x = torch.randint(0, 256, (b, h, w, ci), generator=gen,
                              dtype=torch.uint8, device=dev)
            chosen = G.plan_qgemm(m, n, k, conv=g, sms=G.sm_count(dev))
            for plan in plans(chosen, m, chosen.k_slice):
                if plan.slices == 1:
                    report(layer, [m, k, n], plan, lambda: C.qgemm_conv(
                        x, c["w"], oc, ep, kh=kk, kw=kk, stride=stride,
                        padding=pad, zp_a=c["zp_a"], plan=plan, **kw))
            continue
        chosen = G.plan_qgemm(m, n, k, sms=G.sm_count(dev))
        for plan in plans(chosen, m, k):
            report(layer, [m, k, n], plan,
                   lambda: G.qgemm(c["a"], c["w"], oc, ep, plan=plan, **kw))
    for layer, m, k, n, _, act_name in DEC_GEMMS:
        c = gemm_case(torch, gen, m, k, n, dev)
        oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                              c["zp_a"], recentered=True)
        ep = G.epilogue_vector(c["s_a"], c["s_w_pc"], c["s_c"], n, dev)
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"], zp_c=c["zp_c"],
                  act=act_grid(act_name) if act_name else None)
        chosen = G.plan_qgemm(m, n, k, sms=G.sm_count(dev))
        for plan in plans(chosen, m, k):
            report(f"decode {layer}", [m, k, n], plan,
                   lambda: G.qgemm(c["a"], c["w"], oc, ep, plan=plan, **kw))
    m, k, n, _ = DEC_QKV
    c = gemm_case(torch, gen, m, k, 3 * n, dev)
    merged = G.merge_parts([dict(w_s8_nk=c["w"], q_bias=c["q_bias"],
                                 rowsum=rowsum(torch, c["w"]), scale_w=0.01,
                                 scale_c=c["s_c"], zp_c=110)],
                           scale_a=c["s_a"], zp_a=c["zp_a"])
    chosen = G.plan_qgemm(m, 3 * n, k, sms=G.sm_count(dev))
    for plan in plans(chosen, m, k):
        report("decode qkv (B2)", [m, k, 3 * n], plan,
               lambda: G.qgemm_multi(c["a"], merged, plan=plan))

    sms = G.sm_count(dev)
    for name, m, k, n, _ in W4_DECODE + W4_DECODE_M:
        c = w4_case(torch, W, gen, m, k, n, 256, dev)
        chosen = W.plan_w4a8_v2(m, n, k, 256, sms=sms)
        for sl in W.v2_slice_counts(k, 256):
            plan = chosen._replace(slices=sl, k_slice=k // sl)
            if W.v2_smem_bytes(plan, 256) > W.SMEM_LIMIT:
                continue
            ms = time_cuda(torch, lambda: W.w4a8_v2(
                c["x"], c["ops"], "nearest", plan=plan), iters=20,
                flush=flush)
            log(json.dumps({"sweep": f"B6 {name}", "shape": [m, k, n],
                            "slices": sl, "ms": ms,
                            "chosen": plan == chosen}))
    for cfg, label in ((DEC_ATTN, "B3 gpt2"), (LLAMA_ATTN, "B3 llama")):
        b, t, h, d = (cfg[x] for x in ("b", "t", "h", "d"))
        hkv = cfg.get("hkv", h)
        q = torch.randint(0, 256, (b, h * d), generator=gen,
                          dtype=torch.uint8, device=dev)
        k_, v_ = (torch.randint(0, 256, (b, t, hkv * d), generator=gen,
                                dtype=torch.uint8, device=dev)
                  for _ in range(2))
        kw = dict(ATTN_PARAMS, n_heads=h, n_kv_heads=hkv)
        chosen = A.plan_decode_attn(b, t, h, hkv, d)
        for valid in (cfg["valid"], t - 1):
            valid_t = torch.full((), valid, dtype=torch.int32, device=dev)
            for sp in range(1, A.MAX_SPLITS + 1):
                plan = A.decode_attn_plan(sp, 1, h // hkv, t, d)
                ms = time_cuda(torch, lambda: A.decode_attention_flat(
                    q, k_, v_, valid_t, plan=plan, **kw), iters=20,
                    flush=flush)
                log(json.dumps({"sweep": label, "shape": [b, t, h, hkv, d],
                                "live": valid, "splits": sp, "ms": ms,
                                "chosen": plan == chosen}))


# -- phases 19-23: the CNN zoo ------------------------------------------------

# the families with grouped (depthwise) convs, whose every grouped shape G1
# is checked at (batch 8, 224 x 224, published widths)
ZOO_GROUPED = ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_large",
               "mobilenet_v3_small", "efficientnet_b0", "shufflenet_v2")
G1_CHECK_BATCH = 8
# G1's sweep: channels, then both groupings (one channel a group and, for an
# even C, two), k 3 and 5, stride 1 and 2, on a 17 x 15 input at batch 2
G1_SWEEP_C = (3, 58, 96, 960)
# the CNN main paths' batch, the CPU copy's batch, and the rest of the zoo
# (one forward each on the card against a CPU copy at ZOO_BATCH: the CPU
# copy's im2col runs in float64)
CNN_BATCH, CNN_CPU_BATCH, ZOO_BATCH = 100, 4, 2
ZOO_REST = ("resnet18", "resnet34", "resnet101", "resnet152", "vgg11",
            "vgg16", "vgg19", "mobilenet_v1", "mobilenet_v3_large",
            "mobilenet_v3_small", "efficientnet_b0", "shufflenet_v2",
            "squeezenet", "googlenet", "densenet121")
# the MobileNetV2 depthwise shape timed as one B1 launch per group
PER_GROUP_LAYER = "dw2"
# the FP32 forward against its torch twin: BN folded at load (ResNet) and
# deep float32 chains, relative to the largest |logit|
CNN_FP32_RTOL = 1e-3


def cnn_config(q, name):
    """The zoo's configurations: per-channel weight scales for the
    ResNets (the family's recommended lever), the reference's defaults
    for the others."""
    return q.QuantConfig(weight_per_channel=name.startswith("resnet"))


def cnn_state(torch, zoo, name, seed=0):
    """(state dict, twin) for a zoo CNN: the ResNets take their twin's
    torchvision-layout state (torch.manual_seed(seed) weights, BN running
    statistics from one train-mode forward) with the BN gains and shifts
    drawn from numpy's default_rng(seed), so that the fold is exercised;
    the BN-free families take He-scaled weights from default_rng(seed)."""
    twin = zoo.torch_twin(name, seed=seed)
    if not name.startswith("resnet"):
        state = he_state(torch, twin, seed)
        twin.load_state_dict(state)
        return state, twin
    rng = np.random.default_rng(seed)
    state = twin.state_dict()
    for key in [k[:-len(".running_mean")] for k in state
                if k.endswith(".running_mean")]:
        n = state[f"{key}.weight"].shape[0]
        state[f"{key}.weight"] = torch.tensor(
            rng.uniform(0.5, 1.5, n).astype(np.float32))
        state[f"{key}.bias"] = torch.tensor(
            rng.normal(0, 0.1, n).astype(np.float32))
    twin.load_state_dict(state)
    return state, twin


def gemm_layers(torch, q, model, dev, hw=224):
    """[(name, layer, input shape)] of every Conv2d and Linear, as a batch-1
    FP32 forward at hw x hw sees it (logical NCHW, or [1, K])."""
    seen, hooks = [], []
    for name, layer in model.named_layers():
        if isinstance(layer, (q.Conv2d, q.Linear)):
            hooks.append(layer.register_forward_pre_hook(
                lambda mod, args, name=name: seen.append(
                    (name, mod, tuple(args[0].shape)))))
    try:
        model(q.tensor(np.zeros((1, 3, hw, hw), np.float32), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return seen


def launches_per_forward(q, model):
    """(B1, G1) launches one INT8 forward of ``model`` makes."""
    g1 = sum(1 for _, layer in model.named_layers()
             if isinstance(layer, q.Conv2d) and layer.groups > 1)
    b1 = sum(1 for _, layer in model.named_layers()
             if isinstance(layer, (q.Conv2d, q.Linear))) - g1
    return b1, g1


def grouped_shapes(torch, q, zoo, names, dev):
    """{(h, w, c, o, groups, k, stride): (first layer, launches)} of the
    grouped convs of ``names`` at 224 x 224."""
    shapes = {}
    for name in names:
        model = zoo.build(name, device=dev)
        for lname, layer, shape in gemm_layers(torch, q, model, dev):
            if isinstance(layer, q.Conv2d) and layer.groups > 1:
                _, c, h, w = shape
                key = (h, w, c, layer.out_channels, layer.groups,
                       layer.kernel_size, layer.stride)
                first, n = shapes.get(key, (f"{name}.{lname}", 0))
                shapes[key] = (first, n + 1)
        del model
    return shapes


def grouped_operands(torch, G, gen, batch, shape, dev):
    """A u8 NHWC input and a grouped conv's operands (as ``gemm_case``)."""
    h, w, c, o, groups, k, _ = shape
    x = torch.randint(0, 256, (batch, h, w, c), generator=gen,
                      dtype=torch.uint8, device=dev)
    cs = gemm_case(torch, gen, 1, k * k * (c // groups), o, dev)
    cs["oc"] = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                                cs["s_a"], cs["zp_a"], recentered=True)
    return x, cs


def grouped_kw(cs, shape, rounding="trunc", relu=False):
    k, stride = shape[5], shape[6]
    return dict(groups=shape[4], kh=k, kw=k, stride=stride, padding=k // 2,
                scale_a=cs["s_a"], zp_a=cs["zp_a"], scale_c=cs["s_c"],
                zp_c=cs["zp_c"], relu=relu, rounding=rounding)


def check_g1(torch, q, zoo, G, C, gen, dev):
    """Phase 19: G1 against its plain version, bit for bit, at every grouped
    shape of the zoo (batch 8) and over the sweep, per-tensor and
    per-channel s_w, both roundings, relu on and off."""
    cases = [(shape, G1_CHECK_BATCH, f"{first} (x{n})") for shape, (first, n)
             in grouped_shapes(torch, q, zoo, ZOO_GROUPED, dev).items()]
    for c in G1_SWEEP_C:
        for groups in ((c, c // 2) if c % 2 == 0 else (c,)):
            for k in (3, 5):
                for stride in (1, 2):
                    cases.append(((17, 15, c, c, groups, k, stride), 2,
                                  "sweep"))
    n_cases = 0
    for shape, batch, what in cases:
        x, cs = grouped_operands(torch, G, gen, batch, shape, dev)
        o = shape[3]
        spread = None
        for per_channel in (False, True):
            s_w = cs["s_w_pc"] if per_channel else 0.01
            ep = G.epilogue_vector(cs["s_a"], s_w, cs["s_c"], o, dev, "conv")
            for rounding in ("trunc", "nearest"):
                for relu in (False, True):
                    kw = grouped_kw(cs, shape, rounding, relu)
                    before = C.conv2d_int8_grouped.launches
                    got = C.conv2d_int8_grouped(x, cs["w"], cs["oc"], ep,
                                                **kw)
                    launched = C.conv2d_int8_grouped.launches - before
                    want = C.conv2d_int8_grouped_plain(x, cs["w"], cs["oc"],
                                                       ep, **kw)
                    torch.cuda.synchronize()
                    n_cases += 1
                    if launched != 1 or not torch.equal(got, want):
                        fail(f"G1 != plain at {shape} batch {batch} ({what}) "
                             f"per_channel={per_channel} rounding={rounding}"
                             f" relu={relu}: {int((got != want).sum())} "
                             f"codes differ, {launched} launches")
                    if spread is None:
                        spread = int(torch.unique(want).numel())
        log(json.dumps({"phase": "g1_vs_plain", "shape": list(shape),
                        "batch": batch, "layer": what, "cases": 8,
                        "distinct_codes": spread, "max_abs_err": 0}))
        del x, cs
    log(json.dumps({"phase": "g1_vs_plain", "cases": n_cases,
                    "shapes": len(cases), "max_abs_err": 0}))
    return 0


def b1_shapes(torch, q, zoo, name, dev, batch=CNN_BATCH):
    """{(kind, geometry or (M, K), N): (first layer, launches)} of the B1
    launches of one forward of ``name`` at ``batch``: ('conv', (batch, h,
    w, c, k, stride, pad), N) or ('gemm', (M, K), N)."""
    shapes = {}
    model = zoo.build(name, device=dev)
    for lname, layer, shape in gemm_layers(torch, q, model, dev):
        if isinstance(layer, q.Conv2d):
            if layer.groups > 1:
                continue
            _, c, h, w = shape
            key = ("conv", (batch, h, w, c, layer.kernel_size, layer.stride,
                            layer.padding), layer.out_channels)
        else:
            key = ("gemm", (batch, shape[1]), layer.out_channels)
        first, n = shapes.get(key, (lname, 0))
        shapes[key] = (first, n + 1)
    del model
    return shapes


def check_b1_shapes(torch, G, C, gen, dev, shapes, label):
    """B1 against ``qgemm_plain`` at every conv and Linear shape of
    ``shapes`` (``b1_shapes``' form: a CNN forward's in phase 20,
    gemma-2-2b's GEMMs in 24), bit for bit, one launch each: per-channel
    s_w with 'trunc' and relu, per-tensor with 'nearest' and no relu."""
    n_cases = 0
    for (kind, geom, n), (first, count) in shapes.items():
        for per_channel, rounding, relu in ((True, "trunc", True),
                                            (False, "nearest", False)):
            if kind == "conv":
                b, h, w, c, k, stride, pad = geom
                x, cs = conv_case(torch, gen, geom, n, dev)
                kw = dict(kh=k, kw=k, stride=stride, padding=pad,
                          zp_a=cs["zp_a"], order="conv")
            else:
                cs = gemm_case(torch, gen, geom[0], geom[1], n, dev)
                x, kw = cs["a"], dict(order="gemm")
            order = kw["order"]
            oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                                  cs["s_a"], cs["zp_a"], recentered=True)
            ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"] if per_channel
                                   else 0.01, cs["s_c"], n, dev, order)
            kw.update(scale_a=cs["s_a"], scale_c=cs["s_c"], zp_c=cs["zp_c"],
                      relu=relu, rounding=rounding)
            before = G.qgemm.launches
            if kind == "conv":
                got = C.conv2d_int8_gemm(x, cs["w"], oc, ep, **kw)
                launched = G.qgemm.launches - before
                want = C.conv2d_int8_gemm(x, cs["w"], oc, ep,
                                          gemm=G.qgemm_plain, **kw)
            else:
                got = G.qgemm(x, cs["w"], oc, ep, **kw)
                launched = G.qgemm.launches - before
                want = G.qgemm_plain(x, cs["w"], oc, ep, **kw)
            torch.cuda.synchronize()
            n_cases += 1
            if launched != 1 or not torch.equal(got, want):
                fail(f"B1 != plain at {label} {first} {kind} {geom} N={n} "
                     f"per_channel={per_channel}: "
                     f"{int((got != want).sum())} codes differ, {launched} "
                     f"launches")
            del x, cs, got, want
        log(json.dumps({"phase": f"b1_vs_plain_{label}", "layer": first,
                        "launches_per_forward": count, "kind": kind,
                        "shape": list(geom), "N": n, "cases": 2,
                        "max_abs_err": 0}))
    log(json.dumps({"phase": f"b1_vs_plain_{label}", "cases": n_cases,
                    "shapes": len(shapes), "max_abs_err": 0}))
    return 0


def cnn_main_path(torch, q, zoo, kernel_fns, dev, name):
    """Phases 21-22: a 224 x 224 CNN at batch 100 on the card: load (the
    ResNets fold BN), the FP32 forward against the twin, prepare, calibrate
    on 100 images, convert, one INT8 forward with exactly one launch per
    layer (B1 or G1), and the first CNN_CPU_BATCH images' codes equal to a
    CPU copy's (``export_state`` -> ``load_jax_state``).  Returns (INT8
    model, FP32 input, state, launches by kernel)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    state, twin = cnn_state(torch, zoo, name)
    twin = twin.to(dev).eval()
    rng = np.random.default_rng(0)
    shape = (CNN_BATCH, 3, 224, 224)
    x_calib = rng.standard_normal(shape).astype(np.float32)
    x_test = rng.standard_normal(shape).astype(np.float32)
    cfg = cnn_config(q, name)

    reset_counts(kernel_fns)
    model = zoo.build(name, config=cfg, device="cuda")
    model.load(state)
    fp32 = model(q.tensor(x_test)).data
    with torch.no_grad():
        ref = twin(torch.tensor(x_test, device=dev))
    scale = float(ref.abs().max())
    fp_err = float((fp32 - ref).abs().max()) / scale
    if fp_err > CNN_FP32_RTOL:
        fail(f"FP32 {name} differs from its torch twin: max error {fp_err} "
             f"of max |logit|")
    del twin
    t0 = time.perf_counter()
    model.prepare()
    model(q.tensor(x_calib))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    out = model(q.tensor(x_test)).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    b1, g1 = launches_per_forward(q, model)
    want = dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": b1}
    if g1:
        want["conv_grouped_u8s8"] = g1
    if counts != want:
        fail(f"INT8 {name} forward launched {counts}, want {want}")
    if tuple(out.shape) != (CNN_BATCH, 10) or not bool(
            torch.isfinite(out).all()):
        fail(f"INT8 {name} output {tuple(out.shape)} or non-finite values")
    top1 = float((out.argmax(1) == ref.argmax(1)).float().mean())
    cpu = zoo.build(name, config=cfg, device="cpu")
    load_jax_state(cpu, export_state(model))
    out_cpu = cpu(q.tensor(x_test[:CNN_CPU_BATCH], device="cpu")).data
    if not torch.equal(out[:CNN_CPU_BATCH].cpu(), out_cpu):
        fail(f"INT8 {name} codes on the card differ from the CPU copy's")
    log(json.dumps({"phase": f"{name}_b{CNN_BATCH}", "launches": counts,
                    "fp32_err_rel_to_max": fp_err,
                    "calibrate_convert_s": round(lifecycle_s, 3),
                    "top1_agreement_vs_fp32": top1,
                    "gpu_vs_cpu_codes": {"images": CNN_CPU_BATCH,
                                         "equal": True},
                    "config": {"weight_per_channel":
                               cfg.weight_per_channel}}))
    return model, x_test, state, counts


def cnn_timing(torch, q, zoo, name, model, x_test, state, dev):
    """CUDA events around 20 INT8 and 20 FP32 forwards at batch 100 (input
    on the card), and one profiled INT8 forward split by kernel: B1, G1,
    the pools and the input's quantize (each timed alone at its shapes by
    the same events) and the rest of the glue."""
    from int8inferenceengine_tpu_torch.ops import functional as F
    xt = q.tensor(x_test)
    int8_ms = time_cuda(torch, lambda: model(xt), iters=20)
    fp_model = zoo.build(name, config=cnn_config(q, name), device="cuda")
    fp_model.load(state)
    fp32_ms = time_cuda(torch, lambda: fp_model(xt), iters=20)
    del fp_model
    res = {"model": f"{name}_224", "batch": CNN_BATCH,
           "int8_ms_per_batch": int8_ms,
           "int8_images_per_s": CNN_BATCH * 1e3 / int8_ms,
           "fp32_ms_per_batch": fp32_ms,
           "fp32_images_per_s": CNN_BATCH * 1e3 / fp32_ms}
    busy, split = profile_forward(torch, lambda: model(xt),
                                  f"{name}_b{CNN_BATCH}_int8")
    cfg = model.config
    quant_ms = time_cuda(torch, lambda: F.quantize(
        xt, cfg.input_scale, cfg.input_zero_point, cfg.rounding), iters=20)
    pools_ms = sum(time_cuda(torch, fn, iters=20)
                   for fn in pool_fns(torch, q, F, name, dev))
    b1_us = split.get("qgemm_u8s8", {}).get("us", 0.0)
    g1_us = split.get("conv_grouped_u8s8", {}).get("us", 0.0)
    res["profile_split_us"] = {
        "busy": busy, "b1": b1_us, "g1": g1_us, "pools": 1e3 * pools_ms,
        "input_quantize": 1e3 * quant_ms,
        "other_glue": busy - b1_us - g1_us - 1e3 * (pools_ms + quant_ms)}
    log(json.dumps(res))
    return res


def pool_fns(torch, q, F, name, dev):
    """The pools of one forward of ``name`` at batch 100 on u8 NHWC codes
    of their shapes: the stem's 3x3/2 max-pool (ResNet) and the head's
    global average pool."""
    def codes(shape):
        return q.Tensor(torch.randint(0, 256, shape, dtype=torch.uint8,
                                      device=dev), 0.02, 3, _nhwc=True)
    fns = []
    if name.startswith("resnet"):
        stem = codes((CNN_BATCH, 112, 112, 64))
        fns.append(lambda: F.max_pool2d(stem, 3, 2, padding=1))
        head = codes((CNN_BATCH, 7, 7, 2048))
    else:
        head = codes((CNN_BATCH, 7, 7, 1280))
    fns.append(lambda: F.adaptive_avg_pool2d_1x1(head))
    return fns


def zoo_vs_cpu(torch, q, zoo, kernel_fns, dev):
    """Phase 23: the rest of the zoo, one forward each at 224 x 224 on the
    card at ZOO_BATCH (calibrated on the card at that batch) against a CPU
    copy of the converted state: equal codes.  Returns the launches of the
    card's INT8 forwards."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    rng = np.random.default_rng(4)
    total = dict.fromkeys(kernel_fns, 0)
    for name in ZOO_REST:
        t0 = time.perf_counter()
        state, _ = cnn_state(torch, zoo, name)
        cfg = cnn_config(q, name)
        x = rng.standard_normal((ZOO_BATCH, 3, 224, 224)).astype(np.float32)
        model = zoo.build(name, config=cfg, device="cuda")
        model.load(state)
        model.prepare()
        model(q.tensor(x))
        model.convert()
        reset_counts(kernel_fns)
        out = model(q.tensor(x)).data.cpu()
        counts = read_counts(kernel_fns)
        for k, v in counts.items():
            total[k] += v
        b1, g1 = launches_per_forward(q, model)
        if counts.get("qgemm_u8s8") != b1 or counts.get(
                "conv_grouped_u8s8", 0) != g1:
            fail(f"{name}: {counts}, want {b1} B1 and {g1} G1")
        cpu = zoo.build(name, config=cfg, device="cpu")
        load_jax_state(cpu, export_state(model))
        out_cpu = cpu(q.tensor(x, device="cpu")).data
        equal = torch.equal(out, out_cpu)
        log(json.dumps({"phase": "zoo_card_vs_cpu", "model": name,
                        "batch": ZOO_BATCH, "b1": b1, "g1": g1,
                        "equal_codes": equal, "finite": bool(
                            torch.isfinite(out).all()),
                        "wall_s": time.perf_counter() - t0}))
        if not equal:
            d = (out - out_cpu).abs()
            fail(f"{name}: the card's codes differ from the CPU copy's on "
                 f"{int((d > 0).sum())} logits (max {float(d.max())})")
        del model, cpu, state
        torch.cuda.empty_cache()
    return total


def g1_bound_ms(batch, shape):
    """G1's bound: the u8 input, the weights, oc and s_w and the u8 output
    moved once; 2 k k C/g operations an output at the int8 peak."""
    h, w, c, o, groups, k, stride = shape
    oh = (h + 2 * (k // 2) - k) // stride + 1
    ow = (w + 2 * (k // 2) - k) // stride + 1
    kk = k * k * (c // groups)
    m = batch * oh * ow
    return bound(batch * h * w * c + o * kk + 8 * o + m * o, 2.0 * m * o * kk)


def time_g1(torch, q, zoo, G, C, gen, dev, flush):
    """G1 at one MobileNetV2 b100 forward's depthwise shapes: the kernel,
    its plain version, the bound, and the yardstick: ``F.conv2d(groups=g)``
    in float32 on the integer-valued recentred operands (exact below 2^24;
    TF32 off) + the eager epilogue.  At PER_GROUP_LAYER also ROADMAP's
    other option, one B1 launch a group (recorded, not a path)."""
    import torch.nn.functional as tF
    rows = []
    shapes = grouped_shapes(torch, q, zoo, ("mobilenet_v2",), dev)
    for shape, (first, count) in shapes.items():
        h, w, c, o, groups, k, stride = shape
        x, cs = grouped_operands(torch, G, gen, CNN_BATCH, shape, dev)
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], o, dev,
                               "conv")
        kw = grouped_kw(cs, shape, "trunc", True)

        def fn():
            return C.conv2d_int8_grouped(x, cs["w"], cs["oc"], ep, **kw)

        def plain():
            return C.conv2d_int8_grouped_plain(x, cs["w"], cs["oc"], ep,
                                               **kw)

        pad = k // 2
        xf = tF.pad(x.permute(0, 3, 1, 2).to(torch.float32) - 128.0,
                    (pad,) * 4, value=float(cs["zp_a"] - 128))
        wf = cs["w"].reshape(o, k, k, c // groups).permute(
            0, 3, 1, 2).to(torch.float32).contiguous()

        def library():
            acc = tF.conv2d(xf, wf, stride=stride, groups=groups)
            acc = acc.permute(0, 2, 3, 1).to(torch.int32).reshape(-1, o)
            return G._requant_epilogue(
                acc + cs["oc"].reshape(1, -1), ep, scale_a=cs["s_a"],
                scale_c=cs["s_c"], zp_c=cs["zp_c"], relu=True,
                rounding="trunc", order="conv")

        got = fn()
        if not torch.equal(library().reshape(got.shape), got):
            fail(f"G1 {first}: F.conv2d + epilogue disagrees with the kernel")
        ms = time_cuda(torch, fn, iters=10, flush=flush)
        plain_ms = time_cuda(torch, plain, iters=1, flush=flush)
        library_ms = time_cuda(torch, library, iters=3, flush=flush)
        b_ms, b_by, t_ops, t_bytes = g1_bound_ms(CNN_BATCH, shape)
        row = dict(kernel="conv_grouped_u8s8", path="mobilenet_v2_b100",
                   layer=first, shape=list(shape), launches_per_unit=count,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=b_ms, bound_by=b_by, t_ops=t_ops,
                   t_bytes=t_bytes)
        if first.endswith(f".{PER_GROUP_LAYER}"):
            row["per_group_b1_ms"] = time_per_group_b1(
                torch, C, x, cs, ep, kw, got, flush)
        rows.append(row)
        log(json.dumps({k_: v for k_, v in row.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": b_ms / ms}))
        del x, cs, xf, wf, got
    tot = {key: sum(r[key] * r["launches_per_unit"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(json.dumps({"kernels_per_unit": "g1_mobilenet_v2_b100",
                    "launches": sum(r["launches_per_unit"] for r in rows)}
                   | tot | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


def time_per_group_b1(torch, C, x, cs, ep, kw, want, flush):
    """One depthwise conv as one B1 gathered-conv launch a group (the
    group's channel sliced out, padded to 4 channels by ``qgemm_conv``),
    equal to G1's codes; ms for the whole conv."""
    groups = kw["groups"]
    ckw = {k_: v for k_, v in kw.items() if k_ != "groups"}

    def fn():
        return torch.cat([C.qgemm_conv(
            x[..., g:g + 1], cs["w"][g:g + 1], cs["oc"][g:g + 1],
            ep[g:g + 1], order="conv", **ckw) for g in range(groups)],
            dim=3)

    if not torch.equal(fn(), want):
        fail("one B1 launch a group disagrees with G1")
    return time_cuda(torch, fn, iters=2, flush=flush)


def time_cnn_gemms(torch, G, C, gen, dev, flush, shapes, path):
    """B1 at one CNN forward's conv and Linear shapes (batch 100; the
    main path's per-channel 'trunc' epilogue): the kernel, its plain
    version, the bound and ``torch._int_mm`` on the patch matrix + the
    eager epilogue."""
    rows = []
    for (kind, geom, n), (first, count) in shapes.items():
        if kind == "conv":
            b, h, w, ci, k, stride, pad = geom
            x, cs = conv_case(torch, gen, geom, n, dev)
            m, kk = G.ConvGeom(b, h, w, ci, k, k, stride, pad).gemm_shape
            a = C.im2col_nhwc(x, k, k, stride, pad,
                              pad_value=cs["zp_a"]).reshape(m, kk)
            order = "conv"
        else:
            (m, kk), x = geom, None
            cs = gemm_case(torch, gen, m, kk, n, dev)
            a, order = cs["a"], "gemm"
        oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                              cs["s_a"], cs["zp_a"], recentered=True)
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], n, dev,
                               order)
        kw = dict(scale_a=cs["s_a"], scale_c=cs["s_c"], zp_c=cs["zp_c"],
                  relu=first != "fc", rounding="trunc", order=order)
        if kind == "conv":
            ckw = dict(kw, kh=k, kw=k, stride=stride, padding=pad,
                       zp_a=cs["zp_a"])

            def fn():
                return C.qgemm_conv(x, cs["w"], oc, ep, **ckw)

            def plain():
                return C.conv2d_int8_gemm(x, cs["w"], oc, ep,
                                          gemm=G.qgemm_plain, **ckw)

            b_ms, b_by, t_ops, t_bytes = conv_bound_ms(geom, n)
            plan = plan_of(G, m, n, kk, dev,
                           conv=G.ConvGeom(b, h, w, ci, k, k, stride, pad))
        else:
            def fn():
                return G.qgemm(a, cs["w"], oc, ep, **kw)

            def plain():
                return G.qgemm_plain(a, cs["w"], oc, ep, **kw)

            b_ms, b_by, t_ops, t_bytes = bound_ms(m, kk, n)
            plan = plan_of(G, m, n, kk, dev)
        a_s8, w_p = int_mm_operands(torch, a, cs["w"])

        def library():
            acc = torch._int_mm(a_s8, w_p.t())[:m, :n]
            return G._requant_epilogue(acc + oc.reshape(1, -1), ep, **kw)

        if not torch.equal(library(), fn().reshape(m, n)):
            fail(f"{path} {first}: torch._int_mm + epilogue disagrees with "
                 f"B1")
        row = dict(kernel="qgemm_u8s8", path=path, layer=first,
                   M=m, K=kk, N=n, launches_per_unit=count, plan=plan,
                   ms=time_cuda(torch, fn, iters=5, flush=flush),
                   plain_ms=time_cuda(torch, plain, iters=1, flush=flush),
                   library_ms=time_cuda(torch, library, iters=3,
                                        flush=flush),
                   bound_ms=b_ms, bound_by=b_by, t_ops=t_ops,
                   t_bytes=t_bytes)
        rows.append(row)
        log(json.dumps({k_: v for k_, v in row.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": b_ms / row["ms"]}))
        del x, cs, a, a_s8, w_p
    tot = {key: sum(r[key] * r["launches_per_unit"] for r in rows)
           for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
    log(json.dumps({"kernels_per_unit": path,
                    "launches": sum(r["launches_per_unit"] for r in rows)}
                   | tot | {"share_of_bound": tot["bound_ms"] / tot["ms"]}))
    return rows


# -- phases 24-28: the windowed decoders --------------------------------------

def gemma_state(torch, shapes, depth: int, seed: int, dev,
                tied_head=False):
    """Random weights on the card from a ``torch.Generator`` (gemma-2-2b has
    3.2 B parameters: no host draws): N(0, 0.02) for Linears and the
    embedding, 0.02 / sqrt(2 * depth) for the residual projections (proj,
    down), N(0, 0.02) unit-offset deltas for the RMSNorm gains.
    ``tied_head``: the head is a copy of the token table, as in
    ``google/gemma-2-2b`` (``tie_word_embeddings``: its checkpoint has no
    ``lm_head``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {}
    for key, shape in shapes.items():
        z = torch.randn(tuple(shape), generator=gen, device=dev)
        std = (0.02 / math.sqrt(2 * depth) if key.startswith(("proj",
                                                              "down"))
               else 0.02)
        state[key] = z.mul_(std)
    if tied_head:
        state["head.weight"] = state["embed.weight"].clone()
    return state


def twin_shapes(torch, GM, geo):
    """The parameter shapes of ``torch_gemma(**geo)``, built on the meta
    device (nothing allocated)."""
    with torch.device("meta"):
        twin = GM.torch_gemma(**geo, seed=0)
    return {k: tuple(v.shape) for k, v in twin.state_dict().items()}


def twin_kwargs(geo):
    """``geo`` without the key that only the port's model takes."""
    return {k: v for k, v in geo.items() if k != "ring_cache"}


def gemma_step_bound_ms(b=DEC_BATCH, valid=DEC_ATTN["valid"]):
    """One gemma-2-2b decode step's least time: each launch's bound (B1,
    B2, B3 at the mean live length) times its launches."""
    tot = sum(bound_ms(b, k, n)[0] * per for _, k, n, per in GEMMA_GEMMS)
    k, widths, per = GEMMA_QKV
    tot += bound_ms(b, k, sum(widths), vectors=3)[0] * per
    tot += attn_bound_ms(b, GEMMA2["heads"], GEMMA2["kv_heads"],
                         GEMMA2["head_dim"], valid)[0] * GEMMA2["depth"]
    return tot


def gemma_prefill_bound_ms(m=DEC_BATCH * DEC_PROMPT):
    """The prefill's GEMMs at M = 8 x 64: each weight read once, 2MNK int8
    operations at the tensor-core peak (the composed attention left out)."""
    shapes = [(k, n, per) for _, k, n, per in GEMMA_GEMMS]
    shapes.append((GEMMA_QKV[0], sum(GEMMA_QKV[1]), GEMMA_QKV[2]))
    nbytes = sum((m * k + n * k + m * n) * per for k, n, per in shapes)
    ops = sum(2.0 * m * n * k * per for k, n, per in shapes)
    return bound(nbytes, ops)


def check_gemma_kernels(torch, G, C, A, gen, dev):
    """Phase 24: B1 and B2 bit for bit against their plain versions at
    gemma-2-2b's decode (M = 8) and prefill (M = 512) GEMMs, the
    256,000-wide head included; B3 at its attention (D = 256, 8 heads over
    4, window 4,096, softcap 50) at T = 8,192 and 16,384 over live lengths
    around the window's edge, within the contract (the softcap's tanh and
    the exp).  Returns {kernel: max |code difference|}."""
    shapes = {("gemm", (m, k), n): (layer, per)
              for m in (DEC_BATCH, DEC_BATCH * DEC_PROMPT)
              for layer, k, n, per in GEMMA_GEMMS}
    check_b1_shapes(torch, G, C, gen, dev, shapes, "gemma2_2b")
    k, widths, _ = GEMMA_QKV
    check_b2(torch, G, gen, dev, [(DEC_BATCH, k, widths),
                                  (DEC_BATCH * DEC_PROMPT, k, widths)])
    h, kv, d = GEMMA2["heads"], GEMMA2["kv_heads"], GEMMA2["head_dim"]
    params = dict(ATTN_PARAMS, alpha=d ** -0.5)
    err = 0
    for b, t, every_split in GEMMA_ATTN_CASES:
        case = (t, h, kv, 1, GEMMA2["sliding_window"],
                GEMMA2["attn_softcap"], every_split)
        lives = sorted(set(GEMMA_ATTN_LIVE) | {t - 1, t})
        err = max(err, check_attention(torch, A, gen, dev, b, d, case, lives,
                                       params, "gemma2_attn_vs_plain"))
    return {"qgemm_u8s8": 0, "qgemm_u8s8_vzp": 0, "decode_attn_flat": err}


def build_gemma(torch, q, zoo, GM, geo, dev, seed=0, calib=None,
                twin_check=False, tied_head=False):
    """A gemma-2-family model of ``geo`` on the card with ``gemma_state``
    weights (``tied_head`` there), calibrated on ``calib`` ids and converted
    (the FP32 weights are freed).  ``twin_check``: first the FP32 forward on
    ``calib`` against ``torch_gemma`` built on the card with the same
    weights (1e-4 of the largest logit, as the other decoders' twins)."""
    twin_geo = twin_kwargs(geo)
    state = gemma_state(torch, twin_shapes(torch, GM, twin_geo), geo["depth"],
                        seed, dev, tied_head=tied_head)
    model = zoo.build("gemma_tiny", config=q.QuantConfig(**GEMMA_CFG),
                      device=dev, **geo)
    model.load(state)
    ids = q.tensor(calib, device=dev)
    if twin_check:
        with torch.device(dev):
            twin = GM.torch_gemma(**twin_geo, seed=0)
        twin.load_state_dict(state)
        fp32 = model(ids).data
        with torch.no_grad():
            ref = twin(torch.tensor(calib, dtype=torch.int64, device=dev))
        del twin
        scale = float(ref.abs().max())
        fp_err = float((fp32 - ref).abs().max()) / scale
        log(json.dumps({"phase": "gemma2_fp32_vs_twin", "depth": geo["depth"],
                        "max_err_rel_to_max": fp_err}))
        if tuple(fp32.shape) != tuple(ref.shape) or fp_err > 1e-4:
            fail(f"FP32 gemma differs from its torch twin: max error "
                 f"{fp_err} of max |logit|")
        del fp32, ref
    del state
    model.prepare()
    model(ids)
    model.convert()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return model


def gemma_main_path(torch, q, zoo, GM, kernel_fns, dev):
    """Leg (a): gemma-2-2b at its published widths, batch 8, a 64-token
    prompt: FP32 forward against its twin, calibrate, convert, greedy
    ``generate(ids, 128)`` (captured) with exactly 105 B1, 26 B2 and 26 B3
    a decode step, and the captured decode equal to the eager step loop.
    Returns (INT8 model, ids, launches)."""
    ids = np.random.default_rng(0).integers(
        0, GEMMA2["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    reset_counts(kernel_fns)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_gemma(torch, q, zoo, GM, GEMMA2, dev, calib=ids,
                        twin_check=True, tied_head=True)
    lifecycle_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    reset_counts(kernel_fns)
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    depth = GEMMA2["depth"]
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 4 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    prefill = dict(per_step, decode_attn_flat=0)
    check_captured_launches(torch, "gemma2_2b", counts, model, ids, prefill,
                            per_step, kernel_fns)
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.min() < 0 or \
            tokens.max() >= GEMMA2["vocab_size"]:
        fail(f"gemma2 generate returned {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    weights = sum(t.numel() * t.element_size() for _, layer in
                  model.named_layers() for t in (
                      getattr(layer, "qw", None),
                      getattr(layer, "q_weight", None)) if t is not None)
    log(json.dumps({"phase": "gemma2_2b_generate", **GEMMA2,
                    "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "steps": DEC_STEPS, "launches": counts,
                    "launches_per_decode_step": per_step,
                    "int8_weight_bytes": weights,
                    "fp32_lifecycle_peak_gib": peak_gb,
                    "prepare_calibrate_convert_s": lifecycle_s,
                    "distinct_tokens": int(np.unique(tokens).size)}))
    captured_vs_eager(torch, model, ids, tokens, "gemma2_2b",
                      steps=GEMMA_CAPTURED_STEPS)
    return model, ids, counts


def gemma_profile(torch, model, ids, step_ms):
    """A captured gemma-2-2b step's device time by kernel (16 profiled
    replays) beside its bound: busy, the glue's share, B1, B2 and B3."""
    reps = 16
    rows, wall_us, _ = replay_profile(torch, model, ids, reps)
    busy = sum(e.self_device_time_total for e in rows) / reps
    split = by_kernel(rows, reps)
    glue = split.get("other (eager glue)", {"us": 0.0})["us"]
    res = {"profile": "gemma2_2b: captured decode_step replay",
           "batch": DEC_BATCH, "wall_us_per_step_profiled": wall_us,
           "ms_per_step_unprofiled": step_ms,
           "device_busy_us_per_step": busy,
           "device_idle_share": 1 - busy / (step_ms * 1e3),
           "glue_us": glue, "glue_share_of_busy": glue / busy,
           "step_bound_us": gemma_step_bound_ms() * 1e3,
           "by_kernel": split,
           "rows": [{"name": e.key[:90],
                     "us_per_step": e.self_device_time_total / reps,
                     "calls_per_step": e.count / reps} for e in rows[:25]]}
    log(json.dumps(res))
    return res


def time_captured_steps(torch, model, prompt, steps):
    """ms per captured decode step after the prompt (a device tensor): the
    prefill and the first (eager) step untimed, then ``steps`` replays
    between two CUDA events."""
    from int8inferenceengine_tpu_torch import graphs
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(prompt))
        tok = codes.argmax(-1)
        pos = torch.full((), prompt.shape[1], dtype=torch.int64, device=dev)

        def step():
            codes, _ = model._decode_step(cache, pos, tok)
            tok.copy_(codes.argmax(-1))
            pos.add_(1)

        program = graphs.run_steps(step, 1, dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            program()
        end.record()
        torch.cuda.synchronize()
    kv_bytes = sum(t.numel() for pair in cache.values() for t in pair)
    del program, cache
    return start.elapsed_time(end) / steps, kv_bytes


def ring_leg(torch, q, zoo, GM, kernel_fns, dev):
    """Leg (b): gemma-2-2b's widths at 4 blocks (2 local, 2 global),
    max_len 16,384, batch 1: the ring model (local layers of 8,192 rows)
    against the same converted state with full-length caches.  An
    8,160-token prompt and 64 greedy steps (the local layers' base moves at
    8,192): tokens and every step's logit codes equal; both models' ms per
    captured step and KV-cache bytes.  Returns the ring generate's
    launches."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    calib = np.random.default_rng(3).integers(
        0, RING["vocab_size"], (2, 256)).astype(np.int32)
    ring = build_gemma(torch, q, zoo, GM, dict(RING, ring_cache=True), dev,
                       seed=1, calib=calib)
    full = zoo.build("gemma_tiny", config=q.QuantConfig(**GEMMA_CFG),
                     device=dev, **RING)
    load_jax_state(full, export_state(ring))
    rows = [ring._cache_rows(i) for i in range(1, RING["depth"] + 1)]
    ring_rows = -(-2 * RING["sliding_window"] // 32) * 32
    if rows != [ring_rows, RING["max_len"]] * (RING["depth"] // 2):
        fail(f"ring rows {rows}, want {ring_rows} on the local layers")
    ids = np.random.default_rng(4).integers(
        0, RING["vocab_size"], (1, RING_PROMPT)).astype(np.int32)
    reset_counts(kernel_fns)
    toks = ring.generate(ids, RING_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    toks_full = full.generate(ids, RING_STEPS)
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    tt = torch.tensor(toks, dtype=torch.int64, device=dev)
    codes_ring = teacher_forced(torch, ring, prompt, tt)
    codes_full = teacher_forced(torch, full, prompt, tt)
    same_tokens = bool(np.array_equal(toks, toks_full))
    same_codes = bool(torch.equal(codes_ring, codes_full))
    del codes_ring, codes_full
    times = {}
    for label, m in (("ring", ring), ("full", full), ("ring_again", ring),
                     ("full_again", full)):
        times[label] = time_captured_steps(torch, m, prompt, RING_STEPS)
    res = {"phase": "gemma2_ring_vs_full", **{k: v for k, v in RING.items()},
           "ring_rows": rows, "batch": 1, "prompt": RING_PROMPT,
           "steps": RING_STEPS, "base_moves_at": ring_rows,
           "tokens_equal": same_tokens, "codes_equal_every_step": same_codes,
           "launches": counts,
           "ms_per_captured_step": {k: v[0] for k, v in times.items()},
           "kv_cache_bytes": {"ring": times["ring"][1],
                              "full": times["full"][1]},
           "distinct_tokens": int(np.unique(toks).size)}
    log(json.dumps(res))
    if not (same_tokens and same_codes):
        fail(f"the ring cache differs from the full-length cache: tokens "
             f"equal {same_tokens}, codes equal {same_codes}")
    del ring, full
    torch.cuda.empty_cache()
    return counts


def gemma_engine_leg(torch, model, kernel_fns, label="gemma2_2b"):
    """Leg (c): gemma-2-2b's ``GenerationEngine`` (or ``label``'s model's)
    at SERVE under a saturated load (32 requests x 64 prompt tokens x 128
    new tokens, all at once): tokens/s, TTFT p50/p99 and slot fill; each
    request's tokens equal ``generate()``'s (batches of 8 prompts: rows are
    independent).  Returns the engine's launches over the load (a warm-up
    request first)."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    n, t_prompt, new = SERVE_LOAD
    eng = GenerationEngine(model, **SERVE)
    try:
        warm = np.random.default_rng(12).integers(
            0, model.vocab_size, t_prompt).astype(np.int32)
        results([eng.submit(warm, SERVE["chunk_steps"] + 1)])
        reset_counts(kernel_fns)
        res, prompts, outs = saturated_load(torch, eng, model.vocab_size,
                                            label, collect=True)
        counts = read_counts(kernel_fns)
    finally:
        eng.shutdown()
    want = np.concatenate([model.generate(np.stack(prompts[i:i + 8]), new)
                           for i in range(0, n, 8)])
    bad = [i for i in range(n) if not np.array_equal(outs[i], want[i])]
    log(json.dumps({"phase": f"{label}_engine_vs_generate", "requests": n,
                    "equal": n - len(bad), "differing": bad,
                    "launches": counts}))
    if bad:
        fail(f"{label} engine requests {bad} differ from generate()")
    return counts


def small_windowed(torch, q, zoo, GM, family, dev):
    """A small ring decoder (SMALL_RING) of ``family`` on ``dev``,
    calibrated on 4 x 16 ids and converted: 'gemma' (the window on the odd
    block, 'nearest', ``gemma_state`` weights) or 'mistral' (the window on
    both blocks, the default config, ``decoder_state`` weights).  Returns
    (model, zoo name)."""
    from int8inferenceengine_tpu_torch.models import llama as LL
    geo = twin_kwargs(SMALL_RING)
    ids = np.random.default_rng(2).integers(
        0, SMALL_RING["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
            np.int32)
    if family == "gemma":
        state = gemma_state(torch, twin_shapes(torch, GM, geo),
                            SMALL_RING["depth"], 2, dev)
        name, cfg = "gemma_tiny", GEMMA_CFG
    else:
        state = decoder_state(torch, LL.torch_llama(**geo, seed=0),
                              SMALL_RING["depth"], seed=2,
                              residual=("proj", "down"))
        name, cfg = "mistral_tiny", {}
    model = zoo.build(name, config=q.QuantConfig(**cfg), device=dev,
                      **SMALL_RING)
    model.load(state)
    model.prepare()
    model(q.tensor(ids, device=dev))
    model.convert()
    return model, name


def windowed_small(torch, q, zoo, GM, dev):
    """Leg (d): the small ring gemma and mistral (SMALL_RING) on the card
    against a CPU copy of their converted state (``card_vs_cpu``: the
    prefill's codes, 120 steps teacher-forced across three base moves of
    the ring, the greedy tokens), then each served by a ring engine at 4
    slots with requests whose prompts (5-100 tokens, the longer ones past
    the 64 ring rows) put the slots' bases at different phases: each
    request's 120 tokens equal ``generate()``'s."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    ids = np.random.default_rng(7).integers(
        0, SMALL_RING["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
            np.int32)
    legs, bad = [], []
    for family in ("gemma", "mistral"):
        model, name = small_windowed(torch, q, zoo, GM, family, dev)
        legs += card_vs_cpu(torch, zoo, model, name, SMALL_RING, ids,
                            SMALL_RING_STEPS, family)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, SMALL_RING["vocab_size"], n).astype(
            np.int32) for n in (5, 30, 70, 100, 17, 64)]
        eng = GenerationEngine(model, slots=4, chunk_steps=8, sync_chunks=2)
        try:
            rows = [eng._caches[i][0].shape[1] for i in (1, 2)]
            outs = results([eng.submit(p, SMALL_RING_STEPS)
                            for p in prompts])
        finally:
            eng.shutdown()
        equal = [bool(np.array_equal(o, model.generate(
            p[None], SMALL_RING_STEPS)[0])) for p, o in zip(prompts, outs)]
        log(json.dumps({"phase": "ring_engine_vs_generate", "family": family,
                        **SMALL_RING, "slot_cache_rows": rows,
                        "prompts": [len(p) for p in prompts],
                        "new_tokens": SMALL_RING_STEPS, "equal": equal}))
        if not all(equal):
            bad.append(f"{family} engine")
    for r in legs:
        log(json.dumps(r))
    bad += [f"{r['family']} {r['leg']}" for r in legs if not r["ok"]]
    if bad:
        fail(f"windowed decoders: card differs from a CPU copy beyond the "
             f"contract, or an engine from generate(): {bad}")


def time_gemma_kernels(torch, G, A, gen, dev, flush):
    """B1 and B2 at gemma-2-2b's decode step (M = 8) and prefill (M = 512)
    shapes, B3 at its step (T = 8,192, live 128) and, recorded beside it,
    at a full window and at the ring leg's shapes (``time_gemms``,
    ``time_attention``); a row per shape with its launches per unit (a
    decode step, a prefill)."""
    rows = []
    k, widths, per = GEMMA_QKV
    for m, path in ((DEC_BATCH, "gemma2_2b_decode_step"),
                    (DEC_BATCH * DEC_PROMPT, "gemma2_2b_prefill")):
        rows += time_gemms(
            torch, G, gen, dev, flush, path,
            [(layer, m, kk, n, p, None) for layer, kk, n, p in GEMMA_GEMMS],
            (m, k, widths, per), rounding="nearest")
    for cfg, path, label in GEMMA_ATTN_TIMED:
        rows += time_attention(torch, A, gen, dev, flush, cfg, path, label,
                               rounding="nearest")
    log_rows(rows)
    for path in ("gemma2_2b_decode_step", "gemma2_2b_prefill"):
        mine = [r for r in rows if r["path"] == path]
        log(json.dumps({"kernels_per_unit": path} | {
            key: sum(r[key] * r["launches_per_unit"] for r in mine)
            for key in ("ms", "bound_ms", "plain_ms")}))
    return rows


def windowed_paths(torch, q, zoo, GM, kernel_fns, dev, profile,
                   whole=False):
    """Phases 24-28 in order: (d) the small windowed decoders on the card
    against a CPU copy and their ring engines against ``generate()``, (a)
    gemma-2-2b's main path, its timing and step profile (and, in the
    ``whole`` script, phases 49 and 52 on its model), (c) its engine, (b)
    the ring leg.  Returns the launches of the main paths."""
    windowed_small(torch, q, zoo, GM, dev)
    mark("windowed small")
    counts = {}
    model, ids, counts["gemma2_2b_generate"] = gemma_main_path(
        torch, q, zoo, GM, kernel_fns, dev)
    mark("gemma2_2b main path")
    timing = decoder_timing(torch, model, ids, profile,
                            label="gemma2_2b_decode")
    prof = gemma_profile(torch, model, ids, timing["decode_ms_per_step"])
    mark("gemma2_2b timing")
    b_ms, b_by, _, _ = gemma_prefill_bound_ms()
    log(json.dumps({"phase": "gemma2_2b_summary",
                    "decode_ms_per_step": timing["decode_ms_per_step"],
                    "tokens_per_s": timing["tokens_per_s"],
                    "eager_step_loop_ms_per_step":
                        timing["eager_step_loop_ms_per_step"],
                    "step_bound_ms": gemma_step_bound_ms(),
                    "share_of_step_bound":
                        gemma_step_bound_ms() / timing["decode_ms_per_step"],
                    "device_busy_ms_per_step":
                        prof["device_busy_us_per_step"] / 1e3,
                    "glue_share_of_busy": prof["glue_share_of_busy"],
                    "prefill_ms": timing["prefill_ms"],
                    "prefill_bound_ms": b_ms, "prefill_bound_by": b_by,
                    "gated": False}))
    if whole:
        counts["gemma2_2b_artifact_generate"] = artifact_gemma(
            torch, q, zoo, model, ids, kernel_fns)
        mark("gemma2_2b artifact")
        counts["gemma2_2b_hf_generate"] = gemma_hf_leg(
            torch, q, GM, kernel_fns, dev, model, ids)
        mark("gemma2_2b hf")
    counts["gemma2_2b_engine"] = gemma_engine_leg(torch, model, kernel_fns)
    del model
    torch.cuda.empty_cache()
    mark("gemma2_2b engine")
    counts["gemma2_ring_generate"] = ring_leg(torch, q, zoo, GM, kernel_fns,
                                              dev)
    return counts


# -- phases 29-34: the weight modes (W8-float, dynamic_act, W4 weight-only) --

# the three weight-only QuantConfigs, each with gemma's 'nearest' rounding
WEIGHT_MODES = {"w8f": dict(weight_only=True),
                "dynamic": dict(weight_only=True, dynamic_act=True),
                "w4": dict(weight_only=True, weight_bits=4)}
# the float path's tolerance of each mode, relative to the largest |logit|:
# card against a CPU copy, an extend against decode steps, and where an
# engine's or a speculative run's greedy tokens may leave generate()'s (a
# position whose two best logits lie within twice it).  The float32 sums
# run in another order on the card (W8F, the float attention); B5 holds
# 2e-5 a launch.  A dynamic row whose float input differs in its last bits
# quantizes an element on a rounding boundary one code apart, 1/127 of the
# row's scale, and the flip carries to the logits: half of the JAX
# package's own dynamic-vs-FP32 bound (10%, tests/test_weight_only.py).
# (Before the first card run the dynamic bound was 1e-2 with 0.99 argmax
# agreement; llama_tiny measured 1.24e-2 and 0.984, from such flips.)
FLOAT_RTOL = {"w8f": 1e-4, "dynamic": 5e-2, "w4": 5e-4}
# greedy argmax agreement, card against a CPU copy, at every position of
# the forward and of the teacher-forced steps
FLOAT_AGREE = {"w8f": 0.99, "dynamic": 0.95, "w4": 0.99}
# B5 at the decode shapes: M = 8 (a step at batch 8) and 40 (a verify of
# k + 1 = 5 rows at batch 8); gemma-2-2b's Linears (layer, K, N, launches a
# step) and bench.py's llama widths (W4_FORWARD's)
B5_DECODE_M = (DEC_BATCH, DEC_BATCH * (SPEC_K + 1))
GEMMA_WO = [("wq", 2304, 2048, 26), ("wk", 2304, 1024, 26),
            ("wv", 2304, 1024, 26), ("proj", 2048, 2304, 26),
            ("gate", 2304, 9216, 26), ("up", 2304, 9216, 26),
            ("down", 9216, 2304, 26), ("head", 2304, 256_000, 1)]
# DA (the dynamic Linear's s8 x s8 -> s32) at M = 1, 8, 17, 100: gemma's
# K x N and odd ones; DAC (the dynamic conv) at ResNet-50's and the zoo's
# grouped shapes: (batch, C, H, W, O, k, stride, padding, groups)
DA_M = (1, 8, 17, 100)
DA_KN = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
         (9216, 2304), (2304, 256_000), (33, 17), (2305, 1001), (7, 3)]
DAC_SHAPES = [(2, 3, 224, 224, 64, 7, 2, 3, 1),
              (2, 64, 56, 56, 64, 3, 1, 1, 1),
              (2, 256, 56, 56, 128, 1, 1, 0, 1),
              (2, 512, 7, 7, 512, 3, 1, 1, 1),
              (2, 96, 112, 112, 96, 3, 2, 1, 96),
              (2, 144, 56, 56, 144, 3, 1, 1, 144),
              (2, 58, 28, 28, 58, 5, 1, 2, 58),
              (2, 64, 28, 28, 128, 3, 1, 1, 2),
              (2, 3, 31, 29, 17, 5, 2, 2, 1)]
# the small decoders of the float gates: SMALL_DEC's widths (llama and
# gemma over 2 kv heads, gemma's odd block windowed at 32), batch 4, a
# 16-token prompt, 24 teacher-forced steps (past the window)
WO_SMALL = {"gpt_tiny": dict(SMALL_DEC),
            "llama_tiny": dict(SMALL_DEC, kv_heads=2),
            "gemma_tiny": dict(SMALL_DEC, kv_heads=2, sliding_window=32)}
WO_SMALL_STEPS = 24
# the library routes of the weight modes: what JAX leaves to XLA there
LIBRARY_INFO = {
    "w8f_matmul": dict(
        route="torch.matmul on the weight dequantized each call (f32, TF32 "
              "off)",
        replaces="int8inferenceengine_tpu/layers.py:405-407 (XLA)"),
    "s8_matmul": dict(
        route="torch._int_mm on zero-padded s8 operands",
        replaces="int8inferenceengine_tpu/layers.py:398-401 (XLA)"),
    "conv2d_s8": dict(
        route="F.conv2d on float64 copies of the s8 operands (exact)",
        replaces="int8inferenceengine_tpu/layers.py:757-762 (XLA)"),
    "float_attention": dict(
        route="composed QK^T, masked softmax, P@V over all T_max rows",
        replaces="int8inferenceengine_tpu/models/llama.py:258-267 (XLA)"),
    # the other decoder families' (phases 34-38)
    "moe_experts": dict(
        route="the experts' s8 products on torch._int_mm (gate and up over "
              "the [E*H, K] view, down per expert), quantize, silu, combine",
        replaces="int8inferenceengine_tpu/layers.py:1839-1903 (XLA)"),
    "alibi_attention": dict(
        route="composed QK^T, ALiBi bias, masked softmax, P@V over all "
              "T_max rows of the u8 cache",
        replaces="int8inferenceengine_tpu/ops/attention.py:787-801 (XLA)"),
    # the encoders' and the lifecycle levers' (phases 39-43)
    "encoder_attention": dict(
        route="composed QK^T, softmax, P@V on head-split u8 codes: exact "
              "float64 torch.matmul products, a float64-sum softmax",
        replaces="int8inferenceengine_tpu/ops/attention.py:64-113 (XLA)"),
    "fp32_island": dict(
        route="dequantize, F.linear / F.conv2d in float32 (TF32 off), "
              "requantize",
        replaces="int8inferenceengine_tpu/layers.py:474-490, 799-812 "
                 "(XLA)"),
}


def check_b5_decode(torch, W, gen, dev):
    """B5 at the decode shapes: M = 8 and 40 at gemma-2-2b's Linears (the
    256,000-wide head included) and bench.py's llama widths."""
    cases = [("gemma2 " + name, m, k, n, 128, False) for m in B5_DECODE_M
             for name, k, n, _ in GEMMA_WO]
    cases += [("llama " + name, m, k, n, 128, False) for m in B5_DECODE_M
              for name, _, k, n, _ in W4_FORWARD]
    return check_b5(torch, W, gen, dev, cases)


def check_library_routes(torch, WO, C, dev):
    """DA (``s8_matmul``: ``torch._int_mm`` on padded operands) and DAC
    (``conv2d_s8``: float64 ``F.conv2d``) on the card against their plain
    versions, bit for bit: DA at DA_M x DA_KN (the plain version on the CPU,
    or on the card where K x N passes 2^24), DAC at DAC_SHAPES (the integer
    im2col on the CPU).  Also records whether ``torch._int_mm`` takes
    unpadded M = 8 operands."""
    rng = np.random.default_rng(21)
    for m in DA_M:
        for k, n in DA_KN:
            a = torch.tensor(rng.integers(-127, 128, (m, k)).astype(np.int8))
            w = torch.tensor(rng.integers(-127, 128, (n, k)).astype(np.int8))
            got = WO.s8_matmul(a.to(dev), w.to(dev))
            on_card = k * n > 1 << 24
            want = (WO.s8_matmul_plain(a.to(dev), w.to(dev)) if on_card
                    else WO.s8_matmul_plain(a, w))
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want.cpu()):
                fail(f"DA s8_matmul != plain at M={m} K={k} N={n}")
            log(json.dumps({"phase": "da_vs_plain", "M": m, "K": k, "N": n,
                            "padded_to": list(WO.int_mm_shape(m, k, n)),
                            "plain_on": "card" if on_card else "cpu",
                            "equal": True}))
    probe = {}
    a8 = torch.ones((8, 64), dtype=torch.int8, device=dev)
    w16 = torch.ones((16, 64), dtype=torch.int8, device=dev)
    try:
        torch._int_mm(a8, w16.t())
        torch.cuda.synchronize()
        probe["int_mm_takes_8_rows"] = True
    except RuntimeError as e:
        probe["int_mm_takes_8_rows"] = False
        probe["int_mm_8_rows_error"] = str(e).splitlines()[0][:200]
    log(json.dumps({"phase": "int_mm_probe", **probe}))
    for shape in DAC_SHAPES:
        b, c, h, w_, o, k, s, p, g = shape
        x = torch.tensor(rng.integers(-127, 128, (b, c, h, w_)).astype(
            np.int8))
        wt = torch.tensor(rng.integers(-127, 128, (o, c // g, k, k)).astype(
            np.int8))
        got = C.conv2d_s8(x.to(dev), wt.to(dev), s, p, g)
        torch.cuda.synchronize()
        want = C.conv2d_s8_plain(x, wt, s, p, g)
        if not torch.equal(got.cpu(), want):
            fail(f"DAC conv2d_s8 != plain at {shape}: "
                 f"{int((got.cpu() != want).sum())} accumulators differ")
        log(json.dumps({"phase": "dac_vs_plain", "shape": list(shape),
                        "max_abs_acc": int(want.abs().max()),
                        "equal": True}))
    torch.cuda.empty_cache()


def wo_config(q, mode, **kw):
    return q.QuantConfig(**WEIGHT_MODES[mode], **dict(GEMMA_CFG, **kw))


def wo_small(torch, q, zoo, GM, TD, LL, name, mode, dev):
    """A small decoder of WO_SMALL on ``dev`` in weight mode ``mode``,
    converted without calibration (seeded random weights)."""
    geo = WO_SMALL[name]
    if name == "gemma_tiny":
        state = gemma_state(torch, twin_shapes(torch, GM, geo), geo["depth"],
                            2, dev)
    elif name == "llama_tiny":
        state = decoder_state(torch, LL.torch_llama(**geo, seed=0),
                              geo["depth"], seed=2, residual=("proj", "down"))
    else:
        state = decoder_state(torch, TD.torch_text_decoder(**geo, seed=0),
                              geo["depth"], seed=2)
    model = zoo.build(name, config=wo_config(q, mode), device=dev, **geo)
    model.load(state)
    model.convert()
    return model


def float_gap(torch, logits):
    """The gap between each row's two largest logits over the row's
    largest |logit| ([..., V] -> [...])."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) / logits.abs().amax(-1)


def near_tie_divergence(torch, model, prompts, outs, want, rtol):
    """Each request's tokens ``outs[i]`` against ``want[i]``: equal, or
    leaving them at a position where ``want``'s run had its two best
    logits within 2 * rtol of the largest |logit| (recomputed by a prefill
    of the prompt and the common tokens).  Returns (equal count, [(i,
    position, gap)] of the divergences, ok)."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    equal, diverged, ok = 0, [], True
    for i, (p, o, w) in enumerate(zip(prompts, outs, want)):
        if np.array_equal(o, w):
            equal += 1
            continue
        j = int(np.argwhere(o != w)[0, 0])
        seq = np.concatenate([p, w[:j]]).astype(np.int64)[None]
        with torch.no_grad():
            logits, _ = model._prefill(Tensor(torch.tensor(
                seq, device=model.device)))
        gap = float(float_gap(torch, logits)[0])
        diverged.append((i, j, gap))
        ok &= gap <= 2 * rtol
    return equal, diverged, ok


def wo_card_vs_cpu(torch, zoo, model, name, mode, ids, geo=None):
    """The float gate of a small weight-only decoder (of ``geo``, by
    default ``WO_SMALL[name]``) on the card against a CPU copy of its
    state: the forward's logits at every prompt position and WO_SMALL_STEPS
    teacher-forced steps (on the card's greedy tokens) within
    FLOAT_RTOL[mode] of the largest |logit|, the teacher-forced argmax
    agreeing on FLOAT_AGREE of the positions; the greedy tokens' agreement
    recorded."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    geo = WO_SMALL[name] if geo is None else geo
    cpu = zoo.build(name, config=model.config, device="cpu", **geo)
    load_jax_state(cpu, export_state(model))
    prompt = torch.tensor(ids, dtype=torch.int64)
    dev = model.device
    with torch.no_grad():
        fwd = model.forward(Tensor(prompt.to(dev))).data.cpu()
        fwd_cpu = cpu.forward(Tensor(prompt)).data
    tokens = model.generate(ids, WO_SMALL_STEPS)
    tokens_cpu = cpu.generate(ids, WO_SMALL_STEPS)
    toks = torch.tensor(tokens, dtype=torch.int64)
    tf = teacher_forced(torch, model, prompt.to(dev), toks.to(dev)).cpu()
    tf_cpu = teacher_forced(torch, cpu, prompt, toks)
    res = {"phase": "weight_only_card_vs_cpu", "model": name, "mode": mode,
           **geo, "batch": ids.shape[0], "steps": WO_SMALL_STEPS,
           "limit_rel": FLOAT_RTOL[mode], "limit_agree": FLOAT_AGREE[mode]}
    for leg, got, want in (("forward", fwd, fwd_cpu),
                           ("teacher_forced", tf, tf_cpu)):
        res[f"{leg}_err_rel_to_max"] = rel_err(torch, got, want)
        res[f"{leg}_argmax_agree"] = float(
            (got.argmax(-1) == want.argmax(-1)).float().mean())
    res["greedy_tokens_agree"] = float((tokens == tokens_cpu).mean())
    res["ok"] = all(res[f"{leg}_err_rel_to_max"] <= FLOAT_RTOL[mode]
                    and res[f"{leg}_argmax_agree"] >= FLOAT_AGREE[mode]
                    for leg in ("forward", "teacher_forced"))
    return res


def wo_engine_vs_generate(torch, model, mode, label, prefill_chunk=None,
                          prefix=False):
    """A weight-only engine (4 slots, chunks of 8) against ``generate()``
    of each prompt alone: 6 greedy requests (5-60 prompt tokens, 24 new
    tokens), equal or leaving ``generate()`` only at a near-tie
    (``near_tie_divergence``).  ``prefill_chunk`` chunks the longer
    prompts; ``prefix`` registers a 24-token prefix that the requests
    share."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    rng = np.random.default_rng(31)
    pre = rng.integers(0, model.vocab_size, 24).astype(np.int32)
    prompts = [rng.integers(0, model.vocab_size, n).astype(np.int32)
               for n in (5, 17, 30, 60, 9, 40)]
    if prefix:
        prompts = [np.concatenate([pre, p]) for p in prompts]
    eng = GenerationEngine(model, slots=4, chunk_steps=8, sync_chunks=2,
                           prefill_chunk=prefill_chunk)
    try:
        kw = {}
        if prefix:
            kw["prefix_id"] = eng.register_prefix(pre)
        outs = results([eng.submit(p, 24, **kw) for p in prompts])
        dtype = str(eng._caches[1][0].dtype)
    finally:
        eng.shutdown()
    want = [model.generate(p[None], 24)[0] for p in prompts]
    equal, div, ok = near_tie_divergence(torch, model, prompts, outs, want,
                                         FLOAT_RTOL[mode])
    return {"leg": label, "requests": len(prompts), "equal": equal,
            "near_tie_divergences": div, "slot_cache_dtype": dtype,
            "ok": ok}


def wo_extend_vs_decode(torch, model, mode, ids):
    """An m = 5 extend at batch 4 against 5 decode steps from one shared
    prefill cache (the cache cloned): logits within FLOAT_RTOL[mode] of
    the largest |logit|, the caches' rows likewise."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    toks = torch.tensor(np.random.default_rng(32).integers(
        0, model.vocab_size, (ids.shape[0], 5)), dtype=torch.int64,
        device=dev)
    with torch.no_grad():
        _, cache = model._prefill(Tensor(torch.tensor(
            ids, dtype=torch.int64, device=dev)))
        other = {i: (k.clone(), v.clone()) for i, (k, v) in cache.items()}
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)
        ext, _ = model._extend_step(cache, pos, toks)
        steps = torch.stack([model._decode_step(other, pos + j, toks[:, j])[0]
                             for j in range(5)], 1)
    cache_err = max(rel_err(torch, a, b) for i in cache
                    for a, b in zip(cache[i], other[i]))
    err = rel_err(torch, ext, steps)
    agree = float((ext.argmax(-1) == steps.argmax(-1)).float().mean())
    return {"leg": "extend_m5_vs_decode", "logits_err_rel_to_max": err,
            "cache_err_rel_to_max": cache_err, "argmax_agree": agree,
            "ok": err <= FLOAT_RTOL[mode] and cache_err <= FLOAT_RTOL[mode]}


def wo_speculative_vs_generate(torch, model, mode, ids):
    """Speculative decoding (the model as its own draft, k = 4, 32 tokens)
    against ``generate()``: equal, or leaving it only at a near-tie."""
    got = model.generate_speculative(model, ids, 32, k=SPEC_K)
    want = model.generate(ids, 32)
    equal, div, ok = near_tie_divergence(torch, model, list(ids), list(got),
                                         list(want), FLOAT_RTOL[mode])
    return {"leg": "speculative_vs_generate", "rows": int(ids.shape[0]),
            "equal": equal, "near_tie_divergences": div,
            "stats": model.speculative_stats, "ok": ok}


def wo_small_gates(torch, q, zoo, GM, TD, LL, dev):
    """Phase 30: gpt_tiny, llama_tiny (GQA) and gemma_tiny (window and
    softcaps) in each weight mode on the card: against a CPU copy
    (``wo_card_vs_cpu``), captured against eager bit for bit, the engine
    (bucketed, chunked and prefixed) and speculative decoding against
    ``generate()`` and an extend against decode steps, each under the
    float contract."""
    ids = np.random.default_rng(8).integers(
        0, SMALL_DEC["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
            np.int32)
    bad = []
    for name in WO_SMALL:
        for mode in WEIGHT_MODES:
            model = wo_small(torch, q, zoo, GM, TD, LL, name, mode, dev)
            gate = wo_card_vs_cpu(torch, zoo, model, name, mode, ids)
            log(json.dumps(gate))
            tokens = model.generate(ids, WO_SMALL_STEPS)
            captured_vs_eager(torch, model, ids, tokens, f"{name}_{mode}",
                              steps=WO_SMALL_STEPS)
            legs = [wo_engine_vs_generate(torch, model, mode, "engine"),
                    wo_extend_vs_decode(torch, model, mode, ids),
                    wo_speculative_vs_generate(torch, model, mode, ids)]
            if name == "llama_tiny":
                legs += [wo_engine_vs_generate(torch, model, mode,
                                               "engine_chunked",
                                               prefill_chunk=16),
                         wo_engine_vs_generate(torch, model, mode,
                                               "engine_prefixed",
                                               prefill_chunk=16,
                                               prefix=True)]
            for leg in legs:
                log(json.dumps({"phase": "weight_only_vs_generate",
                                "model": name, "mode": mode,
                                "limit_rel": FLOAT_RTOL[mode], **leg}))
            bad += [f"{name} {mode} {leg['leg']}" for leg in legs
                    if not leg["ok"]]
            if not gate["ok"]:
                bad.append(f"{name} {mode} card_vs_cpu")
            del model
    if bad:
        fail(f"weight modes: beyond the float contract: {bad}")


def gemma_wo_step_bound_ms(mode, b=DEC_BATCH, valid=DEC_ATTN["valid"]):
    """One weight-only gemma-2-2b decode step's least time: every weight
    read once (s8, or packed W4 with its f32 group scales) with the
    activations, plus the live float K/V rows of 26 layers, against the
    step's products (f32 ops for W8F, int8 for DA, three bf16 passes for
    B5); returns (ms, bound by)."""
    nbytes = ops = 0.0
    for _, k, n, per in GEMMA_WO:
        w = n * k // 2 + 4 * n * (k // 128) if mode == "w4" else n * k
        nbytes += per * (w + 4 * b * k + 4 * b * n + 4 * n)
        ops += per * 2.0 * b * n * k
    h, hkv, d = GEMMA2["heads"], GEMMA2["kv_heads"], GEMMA2["head_dim"]
    depth = GEMMA2["depth"]
    nbytes += depth * (2 * b * hkv * valid * d * 4 + 2 * 4 * b * h * d)
    peak = {"w8f": PEAK_FP32_OPS, "dynamic": PEAK_INT8_OPS,
            "w4": PEAK_BF16_OPS / 3}[mode]
    t_ops = ops / peak + depth * 4.0 * b * h * valid * d / PEAK_FP32_OPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def wo_ranges(torch, TD, layers_mod):
    """Profiler ranges around every weight-only GEMM (``Linear.
    _forward_weight_only``: W8F, DA or B5) and every float attention
    (``TextDecoder._float_attention``) while the block runs (a harness
    wrap, eager steps only)."""
    from torch.profiler import record_function
    lin, attn = (layers_mod.Linear._forward_weight_only,
                 TD.TextDecoder._float_attention)

    def r_lin(self, x):
        with record_function("wo_gemm"):
            return lin(self, x)

    def r_attn(self, *a):
        with record_function("wo_attention"):
            return attn(self, *a)

    layers_mod.Linear._forward_weight_only = r_lin
    TD.TextDecoder._float_attention = r_attn
    try:
        yield
    finally:
        layers_mod.Linear._forward_weight_only = lin
        TD.TextDecoder._float_attention = attn


def wo_busy_split(torch, TD, layers_mod, model, ids, reps=2):
    """Device µs a decode step by part (the weight GEMMs, the float
    attention, the glue), from ``reps`` eager steps profiled with
    ``wo_ranges`` (the captured step runs the same kernels)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    with torch.no_grad():
        codes, cache = model._prefill(Tensor(torch.tensor(
            ids.astype(np.int64), device=dev)))
        tok = codes.argmax(-1)
        pos = torch.full((), ids.shape[1], dtype=torch.int64, device=dev)
        model._decode_step(cache, pos, tok)
        torch.cuda.synchronize()
        with wo_ranges(torch, TD, layers_mod), torch_profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model._decode_step(cache, pos, tok)
            torch.cuda.synchronize()
    ranges = ("wo_gemm", "wo_attention")
    rows = [e for e in profile_rows(torch, prof) if e.key not in ranges]
    # the kernels alone: the ranges' own device-side rows span them again
    busy = sum(e.self_device_time_total for e in rows)
    # a range's kernels: those that its CPU-side ops launched; B5 launches
    # through ctypes, outside any op, so its rows count by kernel name
    parts = {name: sum(e.device_time_total for e in prof.events()
                       if e.name == name
                       and e.device_type == torch.autograd.DeviceType.CPU)
             for name in ranges}
    del cache
    gemm = parts["wo_gemm"] + sum(e.self_device_time_total for e in rows
                                  if kernel_of(e.key) == "w4_gemm")
    attn = parts["wo_attention"]
    return {"busy_us": busy / reps, "weight_gemm_us": gemm / reps,
            "float_attention_us": attn / reps,
            "glue_us": (busy - gemm - attn) / reps}


def gemma_wo_shared_state(torch, GM, dev):
    """gemma-2-2b's FP32 weights on the card (``gemma_state``, seed 5),
    built once for the three weight modes: every mode's model loads them
    without a copy and converts its own s8 or 4-bit weights."""
    return gemma_state(torch, twin_shapes(torch, GM, twin_kwargs(GEMMA2)),
                       GEMMA2["depth"], 5, dev)


def gemma_wo_leg(torch, q, zoo, GM, TD, layers_mod, kernel_fns, route_fns,
                 state, mode, ids, fp32_last):
    """Phase 31 in one weight mode: gemma-2-2b at its published widths,
    batch 8, converted without calibration from ``state``; greedy
    ``generate(ids, 128)`` captured with exactly 183 weight GEMMs a step
    (B5 launches under W4, W8F or DA calls otherwise), the captured decode
    bit for bit the eager step loop's, the last prompt position's argmax
    against the FP32 model's, and ms/step, tokens/s, the eager loop, the
    prefill, KV bytes, a profiled captured step with its busy split and
    the step's bound.  Returns (model, launches and calls)."""
    dev = next(iter(state.values())).device
    model = zoo.build("gemma_tiny", config=wo_config(q, mode), device=dev,
                      **GEMMA2)
    t0 = time.perf_counter()
    model.load(state)
    model.convert()
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    counters = dict(kernel_fns, **route_fns)
    reset_counts(counters)
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    all_counts = read_counts(counters)
    counts = {k: v for k, v in all_counts.items() if v}
    gemm = {"w8f": "w8f_matmul", "dynamic": "s8_matmul", "w4": "w4_gemm"}[mode]
    per_step = sum(per for _, _, _, per in GEMMA_WO)
    want = {gemm: per_step * DEC_STEPS}
    if counts != want:
        fail(f"gemma2 {mode} generate: launches and calls {counts}, want "
             f"{want} ({per_step} a step and a prefill)")
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.min() < 0 or \
            tokens.max() >= GEMMA2["vocab_size"]:
        fail(f"gemma2 {mode} generate returned {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    captured_vs_eager(torch, model, ids, tokens, f"gemma2_2b_{mode}",
                      steps=GEMMA_CAPTURED_STEPS)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    prompt = Tensor(torch.tensor(ids, dtype=torch.int64, device=dev))
    with torch.no_grad():
        _, cache = model._prefill(prompt)
        # the final softcap's logits, as the FP32 forward gives them
        last = model.forward(prompt).data[:, -1].clone()
    kv_bytes = sum(t.numel() * t.element_size() for pair in cache.values()
                   for t in pair)
    del cache
    agree_fp32 = float((last.argmax(-1) == fp32_last.argmax(-1)).float()
                       .mean())
    err_fp32 = rel_err(torch, last, fp32_last)
    timing = captured_step_timing(torch, model, ids,
                                  f"gemma2_2b_{mode}_decode")
    rows, wall_us, _ = replay_profile(torch, model, ids, 8)
    busy = sum(e.self_device_time_total for e in rows) / 8
    split = wo_busy_split(torch, TD, layers_mod, model, ids)
    b_ms, b_by = gemma_wo_step_bound_ms(mode)
    weights = sum(t.numel() * t.element_size() for _, layer in
                  model.named_layers() for t in (
                      getattr(layer, "q_weight", None),
                      getattr(layer, "w4_packed", None),
                      getattr(layer, "w4_scales", None)) if t is not None)
    log(json.dumps({"phase": "gemma2_2b_weight_only", "mode": mode,
                    **GEMMA2, "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "steps": DEC_STEPS, "ring_cache": False,
                    "launches_and_calls": counts,
                    "weight_gemms_per_step": {gemm: per_step},
                    "weight_bytes": weights, "kv_cache_bytes": kv_bytes,
                    "convert_s": convert_s,
                    **{k: timing[k] for k in (
                        "decode_ms_per_step", "tokens_per_s",
                        "eager_step_loop_ms_per_step", "prefill_ms")},
                    "captured_step_busy_us": busy,
                    "captured_step_wall_us_profiled": wall_us,
                    "device_idle_share": 1 - busy / wall_us,
                    "busy_split_eager_step_us": split,
                    "step_bound_ms": b_ms, "step_bound_by": b_by,
                    "share_of_step_bound": b_ms
                    / timing["decode_ms_per_step"],
                    "prefill_last_argmax_agree_vs_fp32": agree_fp32,
                    "prefill_last_err_rel_to_max_vs_fp32": err_fp32,
                    "distinct_tokens": int(np.unique(tokens).size),
                    "gated": "launches, captured = eager"}))
    return model, all_counts


def gemma_wo_engine_leg(torch, model, mode):
    """Phase 32: the W8-float gemma-2-2b served by ``GenerationEngine`` at
    SERVE under SERVE_LOAD at once: tokens/s, TTFT p50/p99 and slot fill;
    each request against ``generate()`` of its batch of 8 prompts, equal
    or leaving it only at a near-tie."""
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    n, t_prompt, new = SERVE_LOAD
    eng = GenerationEngine(model, **SERVE)
    try:
        warm = np.random.default_rng(12).integers(
            0, model.vocab_size, t_prompt).astype(np.int32)
        results([eng.submit(warm, SERVE["chunk_steps"] + 1)])
        res, prompts, outs = saturated_load(torch, eng, model.vocab_size,
                                            f"gemma2_2b_{mode}",
                                            collect=True)
    finally:
        eng.shutdown()
    want = np.concatenate([model.generate(np.stack(prompts[i:i + 8]), new)
                           for i in range(0, n, 8)])
    equal, div, ok = near_tie_divergence(torch, model, prompts, outs,
                                         list(want), FLOAT_RTOL[mode])
    log(json.dumps({"phase": f"gemma2_2b_{mode}_engine_vs_generate",
                    "requests": n, "equal": equal,
                    "near_tie_divergences": div,
                    "limit_rel": FLOAT_RTOL[mode]}))
    if not ok:
        fail(f"gemma2 {mode} engine leaves generate() away from a near-tie:"
             f" {div}")
    return res


def resnet_wo_leg(torch, q, zoo, dev, counters):
    """Phase 33: ResNet-50-224 at batch 100 in W8-float and dynamic
    (per-channel scales, BN folded at load, no calibration): images/s by
    CUDA events over 10 forwards, top-1 agreement with the FP32 forward,
    the library calls of a forward, and a CPU copy at batch 2 within the
    mode's float tolerance (argmax equal).  Returns each mode's launches
    and calls of one forward."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    state, _ = cnn_state(torch, zoo, "resnet50")
    x = np.random.default_rng(0).standard_normal(
        (CNN_BATCH, 3, 224, 224)).astype(np.float32)
    xt = q.tensor(x, device=dev)
    fp = zoo.build("resnet50", config=q.QuantConfig(weight_per_channel=True),
                   device=dev)
    fp.load(state)
    ref = fp(xt).data
    del fp
    out = {}
    for mode in ("w8f", "dynamic"):
        cfg = q.QuantConfig(**WEIGHT_MODES[mode], weight_per_channel=True)
        model = zoo.build("resnet50", config=cfg, device=dev)
        model.load(state)
        model.convert()
        reset_counts(counters)
        got = model(xt).data
        torch.cuda.synchronize()
        out[f"resnet50_{mode}_b100"] = read_counts(counters)
        calls = {k: v for k, v in out[f"resnet50_{mode}_b100"].items() if v}
        ms = time_cuda(torch, lambda: model(xt), iters=10)
        cpu = zoo.build("resnet50", config=cfg, device="cpu")
        load_jax_state(cpu, export_state(model))
        got_cpu = cpu(q.tensor(x[:2], device="cpu")).data
        card_err = rel_err(torch, got[:2].cpu(), got_cpu)
        card_argmax = bool(torch.equal(got[:2].argmax(1).cpu(),
                                       got_cpu.argmax(1)))
        res = {"phase": "resnet50_weight_only", "mode": mode,
               "batch": CNN_BATCH, "ms_per_batch": ms,
               "images_per_s": CNN_BATCH * 1e3 / ms,
               "top1_agreement_vs_fp32": float(
                   (got.argmax(1) == ref.argmax(1)).float().mean()),
               "err_rel_to_max_vs_fp32": rel_err(torch, got, ref),
               "calls_per_forward": calls,
               "card_vs_cpu_batch2_err_rel_to_max": card_err,
               "card_vs_cpu_argmax_equal": card_argmax,
               "limit_rel": FLOAT_RTOL[mode]}
        log(json.dumps(res))
        if not (card_argmax and card_err <= FLOAT_RTOL[mode]):
            fail(f"resnet50 {mode}: the card differs from a CPU copy: "
                 f"{card_err} of the largest |logit|, argmax equal "
                 f"{card_argmax}")
        if not bool(torch.isfinite(got).all()):
            fail(f"resnet50 {mode}: non-finite outputs")
        del model, cpu
        torch.cuda.empty_cache()
    return out


def time_library_routes(torch, WO, C, gen, dev, flush, resnet_shapes):
    """The weight modes' library routes and the float attention at their
    main paths' shapes, L2 flushed: W8F and DA at gemma-2-2b's decode-step
    Linears (M = 8), B5 beside them (its kernel rows), DAC at every conv
    shape of ResNet-50 at batch 100 (``resnet_shapes``: ``b1_shapes``'s
    conv entries), and the float attention of a gemma-2-2b step (batch 8,
    T 8,192, live 128); each beside its bound.  Returns (kernel rows for
    B5, library rows)."""
    from int8inferenceengine_tpu_torch.ops.quant import quantize_dynamic
    from int8inferenceengine_tpu_torch.ops import w4 as W
    krows, lrows = [], []
    m = DEC_BATCH
    for name, k, n, per in GEMMA_WO:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        s_w = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn((n,), generator=gen, device=dev) * 0.01
        w8f = time_cuda(torch, lambda: WO.w8f_matmul(x, w, s_w, bias),
                        iters=10, flush=flush)
        b_ms, b_by, t_ops, t_bytes = bound(n * k + 4 * (m * k + m * n + 2 * n),
                                           2.0 * m * n * k, PEAK_FP32_OPS)
        lrows.append(dict(kernel="w8f_matmul", path="gemma2_2b_w8f_step",
                          layer=name, M=m, K=k, N=n, launches_per_unit=per,
                          ms=w8f, bound_ms=b_ms, bound_by=b_by))
        a, s_a = quantize_dynamic(x, (1,))

        def da():
            a, s_a = quantize_dynamic(x, (1,))
            return WO.s8_matmul(a, w).to(torch.float32) * (s_a * s_w) + bias

        da_ms = time_cuda(torch, da, iters=10, flush=flush)
        int_mm_ms = time_cuda(torch, lambda: WO.s8_matmul(a, w), iters=10,
                              flush=flush)
        b_ms, b_by, _, _ = bound(n * k + 4 * (m * k + m * n + 2 * n),
                                 2.0 * m * n * k)
        lrows.append(dict(kernel="s8_matmul", path="gemma2_2b_dynamic_step",
                          layer=name, M=m, K=k, N=n, launches_per_unit=per,
                          ms=da_ms, int_mm_alone_ms=int_mm_ms,
                          bound_ms=b_ms, bound_by=b_by))
        del w, a
        c = w4_case(torch, W, gen, m, k, n, 128, dev, weight_only=True)
        args = (c["x"], c["packed"], c["scales"], c["bias"], k, 128)
        ms = time_cuda(torch, lambda: W.w4_gemm(*args), iters=20,
                       flush=flush)
        plain_ms = time_cuda(torch, lambda: W.w4_gemm_plain(*args), iters=3,
                             flush=flush)
        w_deq = W.dequant_w4(c["packed"], c["scales"], k, 128)
        lib_ms = time_cuda(torch, lambda: torch.addmm(c["bias"], c["x"],
                                                      w_deq.t()),
                           iters=10, flush=flush)
        b_ms, b_by, t_ops, t_bytes = w4_bound_ms("w4_gemm", m, k, n, 128)
        krows.append(dict(kernel="w4_gemm", path="gemma2_2b_w4_step",
                          layer=name, M=m, K=k, N=n, group=128,
                          launches_per_unit=per, ms=ms, bound_ms=b_ms,
                          bound_by=b_by, plain_ms=plain_ms,
                          library_ms=lib_ms, t_ops=t_ops, t_bytes=t_bytes))
        del c, w_deq
    convs = [(geom, o, per) for (kind, geom, o), (_, per)
             in resnet_shapes.items() if kind == "conv"]
    for (b, h, w_, c, k, s, p), o, per in convs:
        x = torch.randint(-127, 128, (b, c, h, w_), generator=gen,
                          device=dev, dtype=torch.int8)
        wt = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                           device=dev, dtype=torch.int8)
        ms = time_cuda(torch, lambda: C.conv2d_s8(x, wt, s, p), iters=3,
                       flush=flush)
        oh, ow = (h + 2 * p - k) // s + 1, (w_ + 2 * p - k) // s + 1
        outs = b * o * oh * ow
        b_ms, b_by, _, _ = bound(x.numel() + wt.numel() + 4 * outs,
                                 2.0 * outs * c * k * k)
        lrows.append(dict(kernel="conv2d_s8", path="resnet50_dynamic_b100",
                          layer=f"{c}x{h}x{w_}->{o} k{k}/s{s}",
                          launches_per_unit=per, ms=ms, bound_ms=b_ms,
                          bound_by=b_by))
        del x, wt
    h, hkv, d = GEMMA2["heads"], GEMMA2["kv_heads"], GEMMA2["head_dim"]
    b, t, valid = DEC_BATCH, GEMMA2["max_len"], DEC_ATTN["valid"]
    q_ = torch.randn((b, h, 1, d), generator=gen, device=dev)
    kc = torch.randn((b, hkv, t, d), generator=gen, device=dev)
    vc = torch.randn((b, hkv, t, d), generator=gen, device=dev)
    attn = float_attention_fn(torch, q_, kc, vc, valid)
    ms = time_cuda(torch, attn, iters=10, flush=flush)
    b_ms, b_by, _, _ = bound(2 * b * hkv * valid * d * 4 + 2 * 4 * b * h * d,
                             4.0 * b * h * valid * d, PEAK_FP32_OPS)
    lrows.append(dict(kernel="float_attention", path="gemma2_2b_w8f_step",
                      layer=f"b{b} T{t} live {valid}", launches_per_unit=26,
                      ms=ms, bound_ms=b_ms, bound_by=b_by,
                      full_cache_bytes_ms=1e3 * (2 * b * hkv * t * d * 4)
                      / PEAK_BYTES))
    del q_, kc, vc
    for r in krows + lrows:
        log(json.dumps({k_: v for k_, v in r.items()
                        if k_ not in ("t_ops", "t_bytes")}
                       | {"share_of_bound": r["bound_ms"] / r["ms"]}))
    for path in sorted({r["path"] for r in krows + lrows}):
        mine = [r for r in krows + lrows if r["path"] == path]
        log(json.dumps({"per_unit": path, "ms": sum(
            r["ms"] * r["launches_per_unit"] for r in mine), "bound_ms": sum(
            r["bound_ms"] * r["launches_per_unit"] for r in mine)}))
    return krows, lrows


def float_attention_fn(torch, q_, kc, vc, valid):
    """The decode step's composed float attention on tensors (one layer:
    grouped QK^T, the masked softmax, P@V), as ``_float_attention`` runs
    it."""
    from int8inferenceengine_tpu_torch.ops.attention import softmax_last
    b, h, m, d = q_.shape
    hkv = kc.shape[1]
    g = h // hkv
    col = torch.arange(kc.shape[2], device=kc.device)
    alpha = torch.full((), d ** -0.5, device=kc.device)
    cap = torch.full((), 50.0, device=kc.device)
    ninf = torch.full((), float("-inf"), device=kc.device)

    def run():
        s = alpha * torch.matmul(q_.reshape(b, hkv, g * m, d),
                                 kc.transpose(-1, -2))
        s = cap * torch.tanh(s / cap)
        s = torch.where(col < valid, s, ninf)
        p = softmax_last(s)
        return torch.matmul(p, vc)

    return run


def library_line(lrows, counts_by_path):
    """One entry per library route timed in ``lrows``: its time and bound
    summed over its unit of work (a gemma-2-2b step, a ResNet-50 b100
    forward, a Mixtral-width MoE step, a step's ALiBi attentions), and its
    calls on the main paths."""
    out = []
    for name, info in LIBRARY_INFO.items():
        mine = [r for r in lrows if r["kernel"] == name]
        if not mine:
            continue
        tot = {key: sum(r[key] * r["launches_per_unit"] for r in mine)
               for key in ("ms", "bound_ms")}
        out.append(dict(name=name, **info, ms=tot["ms"],
                        bound_ms=tot["bound_ms"],
                        calls={p: c[name] for p, c in counts_by_path.items()
                               if c.get(name)},
                        work=" + ".join(sorted({r["path"] for r in mine}))))
    return out


def weight_only_paths(torch, q, zoo, GM, TD, LL, layers_mod, kernel_fns,
                      route_fns, dev):
    """Phases 30-33 in order: the small decoders' float gates, gemma-2-2b
    in the three weight modes, its W8-float engine, ResNet-50 in W8-float
    and dynamic.  Returns the launches and calls of the main paths."""
    wo_small_gates(torch, q, zoo, GM, TD, LL, dev)
    mark("weight modes: small gates")
    from int8inferenceengine_tpu_torch.tensor import Tensor
    counts = {}
    ids = np.random.default_rng(0).integers(
        0, GEMMA2["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    state = gemma_wo_shared_state(torch, GM, dev)
    fp = zoo.build("gemma_tiny", config=q.QuantConfig(**GEMMA_CFG),
                   device=dev, **GEMMA2)
    fp.load(state)
    with torch.no_grad():
        fp32_last = fp.forward(Tensor(torch.tensor(
            ids, dtype=torch.int64, device=dev))).data[:, -1].clone()
    del fp
    engine = None
    for mode in WEIGHT_MODES:
        model, counts[f"gemma2_2b_{mode}_generate"] = gemma_wo_leg(
            torch, q, zoo, GM, TD, layers_mod, kernel_fns, route_fns, state,
            mode, ids, fp32_last)
        mark(f"weight modes: gemma2_2b {mode}")
        if mode == "w8f":
            reset_counts(dict(kernel_fns, **route_fns))
            engine = gemma_wo_engine_leg(torch, model, mode)
            counts["gemma2_2b_w8f_engine"] = read_counts(
                dict(kernel_fns, **route_fns))
            mark("weight modes: gemma2_2b w8f engine")
        del model
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    counts.update(resnet_wo_leg(torch, q, zoo, dev,
                                dict(kernel_fns, **route_fns)))
    return counts, engine


# -- phases 34-38: the other decoder families (OPT, NeoX, BLOOM, MoE) --------

# EleutherAI pythia-1.4b at its published widths (Hugging Face
# EleutherAI/pythia-1.4b, config.json, model_type gpt_neox): vocab 50,304,
# 2,048 positions, hidden 2,048, 24 layers, 16 heads of 128, rotary_pct
# 0.25, rotary_emb_base 10,000, intermediate 8,192 (gelu), parallel
# residual, layer_norm_eps 1e-5, an untied head; nothing cut.  'nearest',
# the JAX package's neox configuration
PYTHIA = dict(vocab_size=50_304, max_len=2048, dim=2048, depth=24, heads=16,
              mlp_ratio=4, rotary_pct=0.25, rope_base=10000.0,
              use_parallel_residual=True, eps=1e-5)
FAMILY_CFG = dict(rounding="nearest")
# a Pythia step's B1 launches (layer, K, N, launches a step, act; the qkv
# shape is B2's, checked on B1 too), its merged QKV (B2: K, per-head N,
# launches) and its B3 (the mean live length of generate(ids, 128) after a
# 64-token prompt)
PYTHIA_GEMMS = [("proj", 2048, 2048, 24, None),
                ("fc1+gelu", 2048, 8192, 24, "gelu"),
                ("fc2", 8192, 2048, 24, None),
                ("head", 2048, 50_304, 1, None)]
PYTHIA_QKV = (2048, (2048, 2048, 2048), 24)
PYTHIA_ATTN = dict(b=DEC_BATCH, t=2048, h=16, d=128, valid=128, launches=24)
# mistralai/Mixtral-8x7B-v0.1 (config.json, model_type mixtral): vocab
# 32,000, hidden 4,096, 32 heads over 8 kv heads of 128, 8 experts of
# 14,336, top-2, rope_theta 1e6, rms_norm_eps 1e-5.  Cut to 4 of its 32
# blocks and max_len 4,096 of 32,768: the lifecycle calibrates from FP32
# weights, and 32 blocks would hold 187 GB of them (4 blocks: 24 GB FP32,
# 5.9 GB s8)
MIXTRAL = dict(vocab_size=32_000, max_len=4096, dim=4096, depth=4, heads=32,
               kv_heads=8, mlp_hidden=14_336, n_experts=8, top_k=2,
               rope_base=1e6, eps=1e-5)
MIXTRAL_GEMMS = [("proj", 4096, 4096, 4, None),
                 ("head", 4096, 32_000, 1, None)]
MIXTRAL_QKV = (4096, (4096, 1024, 1024), 4)
MIXTRAL_ATTN = dict(b=DEC_BATCH, t=4096, h=32, hkv=8, d=128, valid=128,
                    launches=4)
# B3's exact checks at the new shapes: (batch, T, H, Hkv, live lengths)
FAMILY_ATTN_CASES = [(DEC_BATCH, 2048, 16, 16, [1, 128, 2047, 2048]),
                     (DEC_BATCH, 4096, 32, 8, [1, 128, 4095])]
# the small families' gates at SMALL_DEC's widths: (label, zoo name, extra
# geometry); the MoE with 8 experts of 704, top-2, over 2 kv heads
_SMALL_MOE = dict(kv_heads=2, n_experts=8)
FAMILY_SMALL = [("opt", "opt_tiny", {}),
                ("neox_parallel", "neox_tiny", {}),
                ("neox_sequential", "neox_tiny",
                 dict(use_parallel_residual=False)),
                ("bloom", "bloom_tiny", {}),
                ("moe_dense", "moe_tiny", dict(_SMALL_MOE, dispatch="dense")),
                ("moe_sparse", "moe_tiny",
                 dict(_SMALL_MOE, dispatch="sparse"))]


def family_twin(name):
    """The torch twin constructor of a family (geometry keywords)."""
    from int8inferenceengine_tpu_torch.models import (bloom, moe, neox,
                                                      text_decoder)
    return {"opt_tiny": lambda **g: text_decoder.torch_text_decoder(
                act="relu", **g),
            "neox_tiny": neox.torch_neox, "bloom_tiny": bloom.torch_bloom,
            "moe_tiny": moe.torch_moe}[name]


def family_shapes(torch, name, geo):
    """The parameter shapes of ``name``'s twin at ``geo``, built on the meta
    device (nothing allocated)."""
    geo = {k: v for k, v in geo.items() if k != "dispatch"}
    with torch.device("meta"):
        twin = family_twin(name)(**geo, seed=0)
    return {k: tuple(v.shape) for k, v in twin.state_dict().items()}


def card_state(torch, shapes, depth: int, seed: int, dev,
               residual=("proj", "fc2", "down_w")):
    """Random weights on the card from a ``torch.Generator``: the norms'
    gains 1 + N(0, 0.02) and biases N(0, 0.02), the Linears' biases N(0,
    0.01), the residual projections (``residual``) N(0, 0.02 / sqrt(2 *
    depth)), everything else (the embedding, the Linears, the router, the
    experts' gate and up) N(0, 0.02)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {}
    for key, shape in shapes.items():
        name, attr = key.rsplit(".", 1)
        z = torch.randn(tuple(shape), generator=gen, device=dev)
        if name.startswith(("ln", "embed_ln")):
            state[key] = z.mul_(0.02).add_(1.0) if attr == "weight" \
                else z.mul_(0.02)
        elif attr == "bias":
            state[key] = z.mul_(0.01)
        elif name.startswith(residual) or attr in residual:
            state[key] = z.mul_(0.02 / math.sqrt(2 * depth))
        else:
            state[key] = z.mul_(0.02)
    return state


def check_b1_act_exact(torch, G, gen, dev, m, k, n, act_name):
    """B1 with its fused activation (``act_grid``) bit for bit against its
    plain version at one shape, both roundings."""
    c = gemm_case(torch, gen, m, k, n, dev)
    oc = G.compute_offset(c["q_bias"], rowsum(torch, c["w"]), c["s_a"],
                          c["zp_a"], recentered=True)
    # scale s_w and s_c alike: the same codes, dequantized to [-5, 5]
    f = 5.0 / (110 * c["s_c"])
    ep = G.epilogue_vector(c["s_a"], c["s_w_pc"] * f, c["s_c"] * f, n, dev,
                           "gemm")
    for rounding in ("trunc", "nearest"):
        kw = dict(scale_a=c["s_a"], scale_c=c["s_c"] * f, zp_c=c["zp_c"],
                  rounding=rounding, act=act_grid(act_name))
        got = G.qgemm(c["a"], c["w"], oc, ep, **kw)
        want = G.qgemm_plain(c["a"], c["w"], oc, ep, **kw)
        torch.cuda.synchronize()
        mx, share = contract(torch, got, want)
        if mx:
            fail(f"B1 act={act_name} != plain at M={m} K={k} N={n} "
                 f"{rounding}: max {mx}, share {share}")
    log(json.dumps({"phase": "b1_act_vs_plain_families", "act": act_name,
                    "M": m, "K": k, "N": n, "max_abs_err": 0,
                    "plan": plan_of(G, m, n, k, dev)}))


def check_family_kernels(torch, G, C, A, gen, dev):
    """Phase 34: B1, B2 and B3 bit for bit against their plain versions at
    Pythia-1.4B's and Mixtral's shapes: B1 at qkv 2,048 -> 6,144, proj,
    fc1 with its gelu epilogue, fc2 and the 50,304-wide head (and
    Mixtral's proj and head) at M = 8 and 512; B2 at both merged QKVs; B3
    at 16 heads of 128 over T = 2,048 (MHA) and 32 over 8 kv heads of 128
    over T = 4,096, every split count, live lengths 1, 128, T - 1 (and T)
    and a per-sequence vector.  Returns {kernel: max |code difference|}."""
    shapes = {}
    for gemms, qkv in ((PYTHIA_GEMMS, PYTHIA_QKV),
                       (MIXTRAL_GEMMS, MIXTRAL_QKV)):
        for m in (DEC_BATCH, DEC_BATCH * DEC_PROMPT):
            for layer, k, n, per, act_name in gemms:
                if act_name is None:
                    shapes[("gemm", (m, k), n)] = (layer, per)
                else:
                    check_b1_act_exact(torch, G, gen, dev, m, k, n, act_name)
            shapes[("gemm", (m, qkv[0]), sum(qkv[1]))] = ("qkv", qkv[2])
    check_b1_shapes(torch, G, C, gen, dev, shapes, "families")
    check_b2(torch, G, gen, dev, [(m, k, widths) for m in (
        DEC_BATCH, DEC_BATCH * DEC_PROMPT) for k, widths, _ in (
        PYTHIA_QKV, MIXTRAL_QKV)])
    for b, t, h, kv, lives in FAMILY_ATTN_CASES:
        check_attention(torch, A, gen, dev, b, 128, (t, h, kv, 1, None, None,
                                                     True), lives,
                        dict(ATTN_PARAMS, alpha=128 ** -0.5),
                        "families_attn_vs_plain", exact=True)
    return {"qgemm_u8s8": 0, "qgemm_u8s8_vzp": 0, "decode_attn_flat": 0}


def build_family(torch, q, zoo, name, geo, dev, seed, calib, cfg=None):
    """A ``name`` model of ``geo`` on ``dev`` with ``card_state`` weights,
    calibrated on ``calib`` ids and converted (the FP32 weights freed);
    a weight-only ``cfg`` converts without calibration."""
    cfg = q.QuantConfig(**(FAMILY_CFG if cfg is None else cfg))
    state = card_state(torch, family_shapes(torch, name, geo), geo["depth"],
                       seed, dev)
    model = zoo.build(name, config=cfg, device=dev, **geo)
    model.load(state)
    del state
    if not cfg.weight_only:
        model.prepare()
        model(q.tensor(calib, device=dev))
    model.convert()
    torch.cuda.synchronize()
    return model


def family_small_gates(torch, q, zoo, dev):
    """Phase 35: opt_tiny, neox_tiny (parallel and sequential residual),
    bloom_tiny and moe_tiny (dense and sparse dispatch) at SMALL_DEC's
    widths, calibrated on the card: against a CPU copy of the converted
    state (``card_vs_cpu``, held bit for bit here: prefill codes, 16
    teacher-forced steps, greedy tokens), the captured decode against the
    eager step loop, the sparse MoE against the dense one's state (equal
    codes and tokens); then moe_tiny in W8-float against a CPU copy
    (``wo_card_vs_cpu``, FLOAT_RTOL)."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    ids = np.random.default_rng(3).integers(
        0, SMALL_DEC["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
            np.int32)
    legs, moe_state = [], None
    for label, name, extra in FAMILY_SMALL:
        geo = dict(SMALL_DEC, **extra)
        model = build_family(torch, q, zoo, name, geo, dev, 2, ids)
        if label == "moe_sparse":
            # the dense MoE's state, carried: the two dispatches must agree
            load_jax_state(model, moe_state)
        for r in card_vs_cpu(torch, zoo, model, name, geo, ids, SMALL_STEPS,
                             label):
            legs.append(dict(r, ok=r["ok"] and r.get("max_abs_err", 0) == 0))
        tokens = model.generate(ids, SMALL_STEPS)
        captured_vs_eager(torch, model, ids, tokens, f"{label}_small",
                          steps=SMALL_STEPS)
        if label == "moe_dense":
            moe_state, moe_tokens = export_state(model), tokens
        if label == "moe_sparse" and not np.array_equal(tokens, moe_tokens):
            fail("moe_tiny: sparse dispatch's tokens differ from dense's")
        del model
    for r in legs:
        log(json.dumps(r))
    bad = [f"{r['family']} {r['leg']}" for r in legs if not r["ok"]]
    if bad:
        fail(f"small families: card differs from a CPU copy: {bad}")
    geo = dict(SMALL_DEC, **_SMALL_MOE)
    model = build_family(torch, q, zoo, "moe_tiny", geo, dev, 2, ids,
                         cfg=dict(FAMILY_CFG, **WEIGHT_MODES["w8f"]))
    res = wo_card_vs_cpu(torch, zoo, model, "moe_tiny", "w8f", ids, geo)
    log(json.dumps(res))
    if not res["ok"]:
        fail(f"moe_tiny W8-float: card differs from a CPU copy beyond "
             f"{FLOAT_RTOL['w8f']}")
    tokens = model.generate(ids, SMALL_STEPS)
    captured_vs_eager(torch, model, ids, tokens, "moe_w8f_small",
                      steps=SMALL_STEPS)


def weight_bytes(model) -> int:
    """The converted model's s8 weight bytes (Linears and experts)."""
    names = ("qw", "q_gate_w", "q_up_w", "q_down_w")
    return sum(t.numel() * t.element_size() for _, layer in
               model.named_layers() for t in (
                   getattr(layer, n, None) for n in names) if t is not None)


def step_bound_ms(gemms, qkv, attn, experts_bytes=0.0, b=DEC_BATCH):
    """A decode step's least time: each B1 and B2 launch's bound, B3 at the
    mean live length, and the experts' s8 weights read once (dense
    dispatch reads every expert)."""
    tot = sum(bound_ms(b, k, n)[0] * per for _, k, n, per, _ in gemms)
    k, widths, per = qkv
    tot += bound_ms(b, k, sum(widths), vectors=3)[0] * per
    tot += attn_bound_ms(b, attn["h"], attn.get("hkv", attn["h"]), attn["d"],
                         attn["valid"])[0] * attn["launches"]
    return tot + 1e3 * experts_bytes / PEAK_BYTES


def family_generate(torch, model, ids, kernel_fns, label, per_step):
    """Greedy ``generate(ids, 128)`` (captured) with the launch gate of
    ``check_captured_launches``, its tokens checked, and the captured decode
    against the eager step loop (GEMMA_CAPTURED_STEPS teacher-forced
    steps).  Returns (tokens, launches)."""
    reset_counts(kernel_fns)
    tokens = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    gated = {k: counts[k] for k in per_step}
    check_captured_launches(torch, label, gated, model, ids,
                            dict(per_step, decode_attn_flat=0), per_step,
                            {k: kernel_fns[k] for k in per_step})
    if tokens.shape != (DEC_BATCH, DEC_STEPS) or tokens.min() < 0 or \
            tokens.max() >= model.vocab_size:
        fail(f"{label} generate returned {tokens.shape} in "
             f"[{tokens.min()}, {tokens.max()}]")
    captured_vs_eager(torch, model, ids, tokens, label,
                      steps=GEMMA_CAPTURED_STEPS)
    return tokens, counts


def cached_equals_recompute(torch, model, ids, tokens, label,
                            steps=SMALL_STEPS):
    """The cached-decode invariant at full width: ``steps`` decode steps
    teacher-forced on ``tokens`` through the KV cache (``teacher_forced``)
    give the logit codes that one causal forward over the prompt and those
    tokens gives at the same positions, bit for bit."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    dev = model.device
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens[:, :steps], dtype=torch.int64, device=dev)
    cached = teacher_forced(torch, model, prompt, toks)
    with torch.no_grad():
        full = model.forward(Tensor(torch.cat([prompt, toks[:, :-1]], 1)))
    full = full.data[:, ids.shape[1] - 1:]
    same = bool(torch.equal(cached, full))
    log(json.dumps({"phase": f"{label}_cached_vs_recompute",
                    "steps": steps, "codes": int(full.numel()),
                    "bitwise_equal": same}))
    if not same:
        fail(f"{label}: cached decode codes differ from a full recompute "
             f"on {int((cached != full).sum())} codes")


def captured_step_timing(torch, model, ids, label):
    """ms per captured decode step (the prefill and the eager first step
    untimed, then 64 replays between two CUDA events), the eager step
    loop's ms/step (``time_eager_steps``) and the prefill's ms (CUDA events,
    3 runs)."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    prompt = torch.tensor(ids, dtype=torch.int64, device=model.device)
    step_ms, kv_bytes = time_captured_steps(torch, model, prompt, 64)
    with torch.no_grad():
        prefill_ms = time_cuda(torch, lambda: model._prefill(Tensor(prompt)),
                               iters=3)
    res = {"model": label, "batch": ids.shape[0], "prompt": ids.shape[1],
           "decode_ms_per_step": step_ms,
           "tokens_per_s": ids.shape[0] / step_ms * 1e3,
           "eager_step_loop_ms_per_step": time_eager_steps(torch, model, ids),
           "prefill_ms": prefill_ms, "kv_cache_bytes": kv_bytes,
           "protocol": "64 replays of a captured step between CUDA events"}
    log(json.dumps(res))
    return res


def library_gemm_names(torch, WO, dev, shapes):
    """The kernel names that ``torch._int_mm`` runs at ``shapes`` ((M, K,
    N), through ``s8_matmul``): the largest device row of each, from
    replays of the call captured as a graph (``layer_busy``)."""
    names = set()
    for m, k, n in shapes:
        a = torch.zeros((m, k), dtype=torch.int8, device=dev)
        w = torch.zeros((n, k), dtype=torch.int8, device=dev)
        names.add(layer_busy(torch, lambda: WO.s8_matmul(a, w), dev)[0].key)
        del a, w
    log(json.dumps({"int_mm_kernels": sorted(names)}))
    return names


def layer_busy(torch, fn, dev, reps=8):
    """Profiler rows of ``reps`` replays of ``fn`` captured (its first call
    eager), after 64 warm-up replays (``profiled``)."""
    from int8inferenceengine_tpu_torch import graphs
    side = graphs.side_stream(dev)
    program = graphs.Captured(fn, side)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.no_grad(), torch.cuda.stream(side):
        program()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    rows, _ = profiled(torch, program.graph.replay, reps,
                       program.graph.replay, warm_calls=64)
    del program
    return rows


def busy_split(torch, WO, model, ids, step_ms, label, gemm_shapes=()):
    """A captured step's device time (16 profiled replays) split into the
    port's kernels (B1, B2, B3), ``torch._int_mm``'s expert GEMMs (kernel
    names from ``gemm_shapes``), and for an MoE the rest of one captured
    MoE layer (router, quantize, silu, combine; times the depth), the
    remainder glue; beside the step's idle share."""
    from int8inferenceengine_tpu_torch.tensor import Tensor
    reps = 16
    rows, wall_us, _ = replay_profile(torch, model, ids, reps)
    busy = sum(e.self_device_time_total for e in rows) / reps
    names = library_gemm_names(torch, WO, model.device, gemm_shapes) \
        if gemm_shapes else set()
    split = {"B1": 0.0, "B2": 0.0, "B3": 0.0, "expert GEMMs": 0.0,
             "glue": 0.0}
    short = {"qgemm_u8s8": "B1", "qgemm_u8s8_vzp": "B2",
             "decode_attn_flat": "B3"}
    for e in rows:
        k = short.get(kernel_of(e.key))
        if k is None:
            k = "expert GEMMs" if e.key in names else "glue"
        split[k] += e.self_device_time_total / reps
    res = {"profile": f"{label}: captured decode_step replay",
           "batch": ids.shape[0], "wall_us_per_step_profiled": wall_us,
           "ms_per_step_unprofiled": step_ms,
           "device_busy_us_per_step": busy,
           "device_idle_share": 1 - busy / (step_ms * 1e3),
           "us_per_step": split,
           "rows": [{"name": e.key[:90],
                     "us_per_step": e.self_device_time_total / reps,
                     "calls_per_step": e.count / reps} for e in rows[:25]]}
    moe = getattr(model, "moe1", None)
    if moe is not None:
        ln = model.ln2_1
        gen = torch.Generator(device=model.device).manual_seed(5)
        x = Tensor(torch.randint(0, 256, (ids.shape[0], model.dim),
                                 generator=gen, dtype=torch.uint8,
                                 device=model.device), ln.scale,
                   ln.zero_point)
        lrows = layer_busy(torch, lambda: moe(x), model.device)
        layer_us = sum(e.self_device_time_total for e in lrows) / 8
        layer_gemm = sum(e.self_device_time_total for e in lrows
                         if e.key in names) / 8
        other = (layer_us - layer_gemm) * model.depth
        res["moe_layer_us"] = layer_us
        res["moe_layer_expert_gemm_us"] = layer_gemm
        split["router, quantize, silu, combine"] = other
        split["glue"] -= other
    log(json.dumps(res))
    return res


def pythia_leg(torch, q, zoo, kernel_fns, dev):
    """Phases 36-37: NeoX at Pythia-1.4B's published widths, batch 8, a
    64-token prompt: the FP32 forward against its twin on the card (1e-4 of
    the largest logit), calibrate, convert, greedy ``generate(ids, 128)``
    captured with exactly 73 B1, 24 B2 and 24 B3 a step, the captured
    decode equal to the eager step loop, 16 cached steps equal to a full
    recompute; ms/step, the eager loop, the prefill and the busy split
    beside the step's bound; then its
    ``GenerationEngine`` under 32 x 64 x 128, every request equal to
    ``generate()``.  Returns the launches of generate() and the engine."""
    from int8inferenceengine_tpu_torch.models import neox as NX
    from int8inferenceengine_tpu_torch.ops import weight_only as WO
    ids = np.random.default_rng(0).integers(
        0, PYTHIA["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = card_state(torch, family_shapes(torch, "neox_tiny", PYTHIA),
                       PYTHIA["depth"], 0, dev)
    with torch.device(dev):
        twin = NX.torch_neox(**PYTHIA, seed=0)
    twin.load_state_dict(state)
    model = zoo.build("neox_tiny", config=q.QuantConfig(**FAMILY_CFG),
                      device=dev, **PYTHIA)
    model.load(state)
    del state
    x = q.tensor(ids, device=dev)
    fp32 = model(x).data
    with torch.no_grad():
        ref = twin(torch.tensor(ids, dtype=torch.int64, device=dev))
    del twin
    fp_err = float((fp32 - ref).abs().max()) / float(ref.abs().max())
    log(json.dumps({"phase": "pythia_1_4b_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    if tuple(fp32.shape) != tuple(ref.shape) or fp_err > 1e-4:
        fail(f"FP32 Pythia-1.4B differs from its torch twin: {fp_err}")
    del fp32, ref
    model.prepare()
    model(x)
    model.convert()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lifecycle_s = time.perf_counter() - t0
    depth = PYTHIA["depth"]
    per_step = {"qgemm_u8s8": 3 * depth + 1, "qgemm_u8s8_vzp": depth,
                "decode_attn_flat": depth}
    tokens, counts = family_generate(torch, model, ids, kernel_fns,
                                     "pythia_1_4b", per_step)
    cached_equals_recompute(torch, model, ids, tokens, "pythia_1_4b")
    log(json.dumps({"phase": "pythia_1_4b_generate", **PYTHIA,
                    "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "steps": DEC_STEPS, "launches": counts,
                    "launches_per_decode_step": per_step,
                    "int8_weight_bytes": weight_bytes(model),
                    "fp32_lifecycle_peak_gib":
                        torch.cuda.max_memory_allocated() / 2**30,
                    "prepare_calibrate_convert_s": lifecycle_s,
                    "distinct_tokens": int(np.unique(tokens).size)}))
    mark("pythia_1_4b main path")
    timing = captured_step_timing(torch, model, ids, "pythia_1_4b_decode")
    prof = busy_split(torch, WO, model, ids, timing["decode_ms_per_step"],
                      "pythia_1_4b")
    bound = step_bound_ms(PYTHIA_GEMMS, PYTHIA_QKV, PYTHIA_ATTN)
    log(json.dumps({"phase": "pythia_1_4b_summary", "card": nvidia_smi(),
                    "decode_ms_per_step": timing["decode_ms_per_step"],
                    "tokens_per_s": timing["tokens_per_s"],
                    "eager_step_loop_ms_per_step":
                        timing["eager_step_loop_ms_per_step"],
                    "prefill_ms": timing["prefill_ms"],
                    "launches_per_step": per_step,
                    "step_bound_ms": bound,
                    "share_of_step_bound":
                        bound / timing["decode_ms_per_step"],
                    "device_busy_ms_per_step":
                        prof["device_busy_us_per_step"] / 1e3,
                    "busy_us_kernels": sum(prof["us_per_step"][k]
                                           for k in ("B1", "B2", "B3")),
                    "busy_us_glue": prof["us_per_step"]["glue"],
                    "device_idle_share": prof["device_idle_share"],
                    "gated": False}))
    mark("pythia_1_4b timing")
    engine = gemma_engine_leg(torch, model, kernel_fns, label="pythia_1_4b")
    del model
    torch.cuda.empty_cache()
    return {"pythia_1_4b_generate": counts, "pythia_1_4b_engine": engine}


def mixtral_leg(torch, q, zoo, kernel_fns, route_fns, dev):
    """Phase 38: the MoE decoder at Mixtral-8x7B's published widths cut to
    4 blocks (MIXTRAL), batch 8, a 64-token prompt: calibrate, convert,
    greedy ``generate(ids, 128)`` captured (the MoE layers in their dense
    form) with exactly 5 B1, 4 B2 and 4 B3 a step, the captured decode
    equal to the eager step loop (whose MoE layers run the sparse form at
    8 tokens), 16 cached steps equal to a full recompute; ms/step, the eager loop, the prefill, the busy split
    (expert GEMMs, router and combine, B1/B2/B3, glue) beside the step's
    bound.  Returns the launches of generate()."""
    from int8inferenceengine_tpu_torch.ops import weight_only as WO
    ids = np.random.default_rng(0).integers(
        0, MIXTRAL["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_family(torch, q, zoo, "moe_tiny", MIXTRAL, dev, 0, ids)
    torch.cuda.empty_cache()
    lifecycle_s = time.perf_counter() - t0
    depth = MIXTRAL["depth"]
    per_step = {"qgemm_u8s8": depth + 1, "qgemm_u8s8_vzp": depth,
                "decode_attn_flat": depth}
    tokens, counts = family_generate(torch, model, ids,
                                     dict(kernel_fns, **route_fns),
                                     "mixtral_4l", per_step)
    cached_equals_recompute(torch, model, ids, tokens, "mixtral_4l")
    e, h, k = MIXTRAL["n_experts"], MIXTRAL["mlp_hidden"], MIXTRAL["dim"]
    experts_bytes = 3 * e * h * k * depth
    log(json.dumps({"phase": "mixtral_4l_generate", **MIXTRAL,
                    "cut": "depth 4 of 32, max_len 4,096 of 32,768",
                    "batch": DEC_BATCH, "prompt": DEC_PROMPT,
                    "steps": DEC_STEPS, "launches": counts,
                    "launches_per_decode_step": per_step,
                    "int8_weight_bytes": weight_bytes(model),
                    "expert_weight_bytes": experts_bytes,
                    "fp32_lifecycle_peak_gib":
                        torch.cuda.max_memory_allocated() / 2**30,
                    "prepare_calibrate_convert_s": lifecycle_s,
                    "distinct_tokens": int(np.unique(tokens).size)}))
    mark("mixtral_4l main path")
    timing = captured_step_timing(torch, model, ids, "mixtral_4l_decode")
    prof = busy_split(torch, WO, model, ids, timing["decode_ms_per_step"],
                      "mixtral_4l",
                      gemm_shapes=[(DEC_BATCH, k, e * h), (DEC_BATCH, h, k)])
    bound = step_bound_ms(MIXTRAL_GEMMS, MIXTRAL_QKV, MIXTRAL_ATTN,
                          experts_bytes)
    log(json.dumps({"phase": "mixtral_4l_summary", "card": nvidia_smi(),
                    "decode_ms_per_step": timing["decode_ms_per_step"],
                    "tokens_per_s": timing["tokens_per_s"],
                    "eager_step_loop_ms_per_step":
                        timing["eager_step_loop_ms_per_step"],
                    "prefill_ms": timing["prefill_ms"],
                    "step_bound_ms": bound,
                    "share_of_step_bound":
                        bound / timing["decode_ms_per_step"],
                    "device_busy_ms_per_step":
                        prof["device_busy_us_per_step"] / 1e3,
                    "busy_us": prof["us_per_step"],
                    "device_idle_share": prof["device_idle_share"],
                    "gated": False}))
    del model
    torch.cuda.empty_cache()
    return {"mixtral_4l_generate": counts}


def time_family_kernels(torch, G, A, WO, gen, dev, flush):
    """B1 and B2 at Pythia-1.4B's and Mixtral's decode-step (M = 8) and
    prefill (M = 512) shapes and B3 at their steps (``time_gemms``,
    ``time_attention``): kernel rows a unit (a step, a prefill).  Then the
    two library routes, each captured as a graph (the form a decode step
    runs; the eager call's time, Python gaps included, beside it): one
    Mixtral MoE layer's experts at M = 8 (dense, every expert read; bound:
    the s8 expert bytes), and the ALiBi decode attention at Pythia's
    attention shape beside B3's time there (bound: the live rows)."""
    from int8inferenceengine_tpu_torch.ops import moe as M
    rows = []
    for name, gemms, (k, widths, per), attn in (
            ("pythia_1_4b", PYTHIA_GEMMS, PYTHIA_QKV, PYTHIA_ATTN),
            ("mixtral_4l", MIXTRAL_GEMMS, MIXTRAL_QKV, MIXTRAL_ATTN)):
        for m, unit in ((DEC_BATCH, "decode_step"),
                        (DEC_BATCH * DEC_PROMPT, "prefill")):
            rows += time_gemms(
                torch, G, gen, dev, flush, f"{name}_{unit}",
                [(layer, m, kk, n, p, act) for layer, kk, n, p, act in gemms],
                (m, k, widths, per), rounding="nearest")
        rows += time_attention(torch, A, gen, dev, flush, attn,
                               f"{name}_decode_step", "attention",
                               rounding="nearest")
    log_rows(rows)
    for path in sorted({r["path"] for r in rows}):
        mine = [r for r in rows if r["path"] == path]
        log(json.dumps({"kernels_per_unit": path} | {
            key: sum(r[key] * r["launches_per_unit"] for r in mine)
            for key in ("ms", "bound_ms", "plain_ms")}))
    lrows = []
    e, h, k = MIXTRAL["n_experts"], MIXTRAL["mlp_hidden"], MIXTRAL["dim"]
    m = DEC_BATCH
    f = torch.randn((m, k), generator=gen, device=dev)
    wexp = M.route(f, torch.randn((e, k), generator=gen, device=dev) * 0.02,
                   MIXTRAL["top_k"])
    gate, up = (torch.randint(-127, 128, (e, h, k), generator=gen,
                              dtype=torch.int8, device=dev) for _ in range(2))
    down = torch.randint(-127, 128, (e, k, h), generator=gen,
                         dtype=torch.int8, device=dev)
    s = torch.full((e,), 1e-3, device=dev)

    def experts():
        return M.experts(f, wexp, gate, up, down, s, s, s, dynamic=True,
                         sparse=False)

    with torch.no_grad():
        prog = captured(torch, experts, dev)
        ms = time_cuda(torch, prog.graph.replay, iters=10, flush=flush)
        eager_ms = time_cuda(torch, experts, iters=5, flush=flush)
    b_ms, b_by, _, _ = bound(3 * e * h * k, 2.0 * 3 * m * e * h * k)
    lrows.append(dict(kernel="moe_experts", path="mixtral_4l_decode_step",
                      layer=f"dense, M {m}, {e} experts of {h}, captured",
                      launches_per_unit=MIXTRAL["depth"], ms=ms,
                      eager_ms=eager_ms, bound_ms=b_ms, bound_by=b_by))
    del gate, up, down, prog
    cfg = PYTHIA_ATTN
    b, t, hh, d = cfg["b"], cfg["t"], cfg["h"], cfg["d"]
    qq = torch.randint(0, 256, (b, hh * d), generator=gen, dtype=torch.uint8,
                       device=dev)
    kc, vc = (torch.randint(0, 256, (b, t, hh * d), generator=gen,
                            dtype=torch.uint8, device=dev) for _ in range(2))
    valid = torch.full((), cfg["valid"], dtype=torch.int32, device=dev)
    from int8inferenceengine_tpu_torch.layers import alibi_slopes
    slopes = torch.tensor(alibi_slopes(hh), dtype=torch.float32, device=dev)
    kw = dict(ATTN_PARAMS, alpha=d ** -0.5, n_heads=hh, rounding="nearest")

    def alibi():
        return A.decode_attention_flat(qq, kc, vc, valid, alibi=slopes, **kw)

    prog = captured(torch, alibi, dev)
    ms = time_cuda(torch, prog.graph.replay, iters=10, flush=flush)
    eager_ms = time_cuda(torch, alibi, iters=5, flush=flush)
    b3_ms = time_cuda(torch, lambda: A.decode_attention_flat(
        qq, kc, vc, valid, **kw), iters=10, flush=flush)
    b_ms, b_by, _, _ = attn_bound_ms(b, hh, hh, d, cfg["valid"])
    lrows.append(dict(kernel="alibi_attention",
                      path="alibi_decode_step_at_pythia_shape",
                      layer=f"b{b} T{t} H{hh} D{d} live {cfg['valid']}, "
                            f"captured",
                      launches_per_unit=PYTHIA["depth"], ms=ms,
                      eager_ms=eager_ms, b3_without_bias_ms=b3_ms,
                      bound_ms=b_ms, bound_by=b_by))
    del prog
    for r in lrows:
        log(json.dumps(r | {"share_of_bound": r["bound_ms"] / r["ms"]}))
    return rows, lrows


def families_paths(torch, q, zoo, kernel_fns, route_fns, dev):
    """Phases 35-38 in order: the small families' gates, Pythia-1.4B with
    its engine, the Mixtral-width MoE.  Returns the launches of the main
    paths."""
    family_small_gates(torch, q, zoo, dev)
    mark("families: small gates")
    counts = pythia_leg(torch, q, zoo, kernel_fns, dev)
    mark("families: pythia_1_4b engine")
    counts.update(mixtral_leg(torch, q, zoo, kernel_fns, route_fns, dev))
    mark("families: mixtral_4l")
    return counts


# -- phases 39-43: the encoders and the lifecycle levers ----------------------

# ViT-B/16 at 224 (Dosovitskiy et al. 2021, Table 1 "ViT-Base", as
# google/vit-base-patch16-224's config.json gives it): hidden 768, 12
# layers, 12 heads of 64, intermediate 3,072, patch 16 (196 patches and the
# class token: 197 tokens), 1,000 classes; nothing cut
VIT_B16 = dict(img_size=224, patch=16, dim=768, depth=12, heads=12,
               mlp_ratio=4, num_classes=1000)
# bert-base-uncased's config.json widths: vocab 30,522, hidden 768, 12
# layers of 12 heads, intermediate 3,072; 128 tokens (and the class token:
# 129) and 2 classes.  Only the widths are BERT's: the block is the JAX
# package's pre-LN TextTransformer block
BERT_BASE = dict(vocab_size=30_522, max_len=128, dim=768, depth=12,
                 heads=12, mlp_ratio=4, num_classes=2)
ENCODERS = [("vit_b16_b64", "vit_tiny", VIT_B16),
            ("text_bert_base_b64", "text_tiny", BERT_BASE)]
ENC_BATCH = 64
ENC_CFG = dict(rounding="nearest")
# the encoders' card-vs-CPU gate at dim 256, depth 2 (batch 4)
SMALL_ENCODERS = [("vit_tiny", dict(img_size=64, patch=16, dim=256, depth=2,
                                    heads=4, mlp_ratio=4, num_classes=10)),
                  ("text_tiny", dict(vocab_size=4096, max_len=32, dim=256,
                                     depth=2, heads=4, mlp_ratio=4,
                                     num_classes=10))]
# the lifecycle gates: AlexNet's last layer (its eighth, fc3) kept an FP32
# island at batch 100; the images of its CPU copy
ISLAND_SKIP = ("fc3",)
ISLAND_BATCH, ISLAND_CPU_BATCH = 100, 4


def encoder_tokens(geo) -> int:
    """The tokens an encoder's blocks see: the patches or the ids, and the
    class token."""
    if "img_size" in geo:
        return (geo["img_size"] // geo["patch"]) ** 2 + 1
    return geo["max_len"] + 1


def encoder_gemms(geo, batch=ENC_BATCH):
    """One forward's B1 GEMMs (layer, M, K, N, launches, act), its B2 (M, K,
    per-head widths, launches) and the patch stem's conv geometry (batch,
    h, w, c, k, stride, pad) or None."""
    m, c, d = batch * encoder_tokens(geo), geo["dim"], geo["depth"]
    h = geo["mlp_ratio"] * c
    gemms = [("proj", m, c, c, d, None), ("fc1+gelu", m, c, h, d, "gelu"),
             ("fc2", m, h, c, d, None),
             ("head", batch, c, geo["num_classes"], 1, None)]
    patch = None
    if "img_size" in geo:
        s, p = geo["img_size"], geo["patch"]
        patch = (batch, s, s, 3, p, p, 0)
    return gemms, (m, c, (c, c, c), d), patch


def encoder_launches(geo) -> dict:
    """B1 and B2 launches of one INT8 forward, from the model's code: the
    patch stem (ViT), proj, fc1 with gelu in its epilogue
    (``fused_linear_act``) and fc2 a block, the head; the merged QKV
    (``fused_qkv``) a block."""
    d = geo["depth"]
    return {"qgemm_u8s8": 3 * d + 1 + ("img_size" in geo),
            "qgemm_u8s8_vzp": d}


def check_encoder_kernels(torch, G, C, gen, dev):
    """Phase 39: B1 and B2 bit for bit against their plain versions at
    every GEMM of the ViT-B/16 and BERT-width forwards at batch 64: the
    patch stem's conv (16 x 16 / 16 over 3 channels, B1's conv route)
    against im2col + ``qgemm_plain``, proj, fc2, the head, fc1 with its
    gelu epilogue, and the merged QKV.  Returns {kernel: max |code
    difference|}."""
    for label, _, geo in ENCODERS:
        gemms, (m, k, widths, per), patch = encoder_gemms(geo)
        shapes = {}
        if patch is not None:
            shapes[("conv", patch, geo["dim"])] = ("patch", 1)
        for layer, mm, kk, n, count, act_name in gemms:
            if act_name is None:
                shapes[("gemm", (mm, kk), n)] = (layer, count)
            else:
                check_b1_act_exact(torch, G, gen, dev, mm, kk, n, act_name)
        check_b1_shapes(torch, G, C, gen, dev, shapes, label)
        check_b2(torch, G, gen, dev, [(m, k, widths)])
    return {"qgemm_u8s8": 0, "qgemm_u8s8_vzp": 0}


def encoder_twin(name):
    from int8inferenceengine_tpu_torch.models import text_transformer, vit
    return {"vit_tiny": vit.torch_vit,
            "text_tiny": text_transformer.torch_text_transformer}[name]


def encoder_state(torch, name, geo, seed: int, dev):
    """Random weights on the card from a ``torch.Generator``, scaled as the
    twins' are: the patch conv He-scaled, the LayerNorms' gains 1 + N(0,
    0.02) and biases N(0, 0.02), the class token, the positions and the
    embedding N(0, 0.02), the Linears N(0, 0.02) (the residual projections
    proj and fc2 0.02 / sqrt(2 depth)) with N(0, 0.01) biases."""
    with torch.device("meta"):
        twin = encoder_twin(name)(**geo, seed=0)
    shapes = {k: tuple(v.shape) for k, v in twin.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {}
    for key, shape in shapes.items():
        lname, attr = key.rsplit(".", 1)
        z = torch.randn(shape, generator=gen, device=dev)
        if lname.startswith("ln"):
            state[key] = z.mul_(0.02).add_(1.0) if attr == "weight" \
                else z.mul_(0.02)
        elif lname == "patch" and attr == "weight":
            state[key] = z.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        elif lname in ("pe", "embed"):
            state[key] = z.mul_(0.02)
        elif attr == "bias":
            state[key] = z.mul_(0.01)
        elif lname.startswith(("proj", "fc2_")):
            state[key] = z.mul_(0.02 / math.sqrt(2 * geo["depth"]))
        else:
            state[key] = z.mul_(0.02)
    return state


def encoder_inputs(geo, batch: int, seed: int) -> np.ndarray:
    """N(0, 1) images, or token ids uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    if "img_size" in geo:
        s = geo["img_size"]
        return rng.standard_normal((batch, 3, s, s)).astype(np.float32)
    return rng.integers(0, geo["vocab_size"], (batch, geo["max_len"])
                        ).astype(np.float32)


def build_encoder(torch, q, zoo, name, geo, dev, calib, seed=0):
    """An encoder of ``geo`` on ``dev`` with ``encoder_state`` weights,
    calibrated on ``calib`` and converted."""
    model = zoo.build(name, config=q.QuantConfig(**ENC_CFG), device=dev,
                      **geo)
    model.load(encoder_state(torch, name, geo, seed, dev))
    model.prepare()
    model(q.tensor(calib, device=dev))
    model.convert()
    return model


def steps_apart(torch, got, want, scale):
    """(max |code difference|, share of codes that differ) of two
    dequantized outputs on one grid."""
    d = torch.round((got.cpu() - want.cpu()).abs() / scale)
    return int(d.max()), float((d > 0).float().mean())


def encoders_small_vs_cpu(torch, q, zoo, dev):
    """Phase 40: the two encoders at dim 256, depth 2 (``SMALL_ENCODERS``),
    calibrated and converted on the card, against a CPU copy of their
    state (``export_state`` -> ``load_jax_state``) on the same batch of 4:
    the logit codes within the reference's contract (at most 1 code off on
    at most 0.2%); bit-equality recorded."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    for name, geo in SMALL_ENCODERS:
        x = encoder_inputs(geo, SMALL_BATCH, 6)
        model = build_encoder(torch, q, zoo, name, geo, dev,
                              encoder_inputs(geo, SMALL_BATCH, 5), seed=2)
        cpu = zoo.build(name, config=model.config, device="cpu", **geo)
        load_jax_state(cpu, export_state(model))
        got = model(q.tensor(x, device=dev)).data
        want = cpu(q.tensor(x, device="cpu")).data
        mx, share = steps_apart(torch, got, want, model.head.scale)
        ok = mx <= CPU_MAX_CODE and share <= CPU_MAX_SHARE
        log(json.dumps({"phase": "encoder_card_vs_cpu", "model": name, **geo,
                        "batch": SMALL_BATCH, "codes": int(want.numel()),
                        "max_abs_err": mx, "share_differing": share,
                        "bitwise_equal": mx == 0, "ok": ok}))
        if not ok:
            fail(f"{name} at dim 256: the card's codes differ from a CPU "
                 f"copy's beyond the contract ({mx} codes, share {share})")
        del model, cpu


def lifecycle_gates(torch, q, zoo, kernel_fns, route_fns, dev):
    """Phase 41, the lifecycle levers on the card: AlexNet-224 b100 with
    ``convert(skip=ISLAND_SKIP)`` (one INT8 forward: 7 B1 and one FP32
    island; 4 images' codes against a CPU copy within the contract);
    ``QuantAct(backend='lut')`` equal to 'elementwise' bit for bit on every
    code of two input grids for each activation; a LeNet with
    ``bias_correction=True`` calibrated on the card equal to a CPU copy of
    its state, its corrected s8 biases beside those of the same lifecycle
    on the CPU (recorded).  Returns the island forward's launches."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.layers import QuantAct
    from int8inferenceengine_tpu_torch.ops.functional import ACTIVATIONS
    rng = np.random.default_rng(7)
    shape = (ISLAND_BATCH, 3, 224, 224)
    x_calib = rng.standard_normal(shape).astype(np.float32)
    x_test = rng.standard_normal(shape).astype(np.float32)
    model = zoo.AlexNet(device=dev)
    model.load(he_state(torch, zoo.torch_twin("alexnet"), seed=0))
    model.prepare()
    model(q.tensor(x_calib, device=dev))
    model.convert(skip=ISLAND_SKIP)
    fns = dict(kernel_fns, **route_fns)
    reset_counts(fns)
    out = model(q.tensor(x_test, device=dev)).data
    torch.cuda.synchronize()
    counts = read_counts(fns)
    want = dict.fromkeys(fns, 0) | {"qgemm_u8s8": 7, "fp32_island": 1}
    if counts != want:
        fail(f"AlexNet with an FP32 {ISLAND_SKIP} launched {counts}, want "
             f"{want}")
    cpu = zoo.AlexNet(device="cpu")
    load_jax_state(cpu, export_state(model))
    out_cpu = cpu(q.tensor(x_test[:ISLAND_CPU_BATCH], device="cpu")).data
    mx, share = steps_apart(torch, out[:ISLAND_CPU_BATCH], out_cpu,
                            model.fc3.scale)
    ok = mx <= CPU_MAX_CODE and share <= CPU_MAX_SHARE
    log(json.dumps({"phase": "alexnet_fp32_island_vs_cpu",
                    "skip": list(ISLAND_SKIP), "launches": counts,
                    "images": ISLAND_CPU_BATCH, "max_abs_err": mx,
                    "share_differing": share, "ok": ok}))
    if not ok:
        fail(f"AlexNet's FP32 island: card differs from a CPU copy ({mx} "
             f"codes, share {share})")
    del model, cpu
    xa = torch.tensor(rng.uniform(-4, 4, (2, 300)).astype(np.float32),
                      device=dev)
    codes = torch.arange(256, dtype=torch.uint8, device=dev).flip(0)
    for name in ACTIVATIONS:
        pair = [QuantAct(name, device=dev),
                QuantAct(name, backend="lut", device=dev)]
        for act in pair:
            act.prepare()
            act(q.Tensor(xa))
            act.convert()
        for scale, zp in ((0.03, 128), (0.011, 7)):
            u8 = q.Tensor(codes.reshape(4, 64), scale, zp)
            e, lut = (act(u8).data for act in pair)
            if not torch.equal(e, lut):
                fail(f"QuantAct({name!r}) LUT differs from elementwise on "
                     f"the card on {int((e != lut).sum())} codes")
    log(json.dumps({"phase": "quant_act_lut_vs_elementwise",
                    "activations": sorted(ACTIVATIONS), "grids": 2,
                    "codes": 256, "bitwise_equal": True}))
    cfg = q.QuantConfig(bias_correction=True)
    sd = zoo.torch_twin("lenet").state_dict()
    x = rng.uniform(-1, 1, (32, 1, 28, 28)).astype(np.float32)
    lenets = {}
    for where in (dev, "cpu"):
        m = zoo.build("lenet", config=cfg, device=where)
        m.load(sd)
        m.prepare()
        m(q.tensor(x, device=where))
        m.convert()
        lenets[str(where)] = m
    card = lenets[str(dev)]
    copy = zoo.build("lenet", config=cfg, device="cpu")
    load_jax_state(copy, export_state(card))
    got = card(q.tensor(x, device=dev)).data.cpu()
    equal = bool(torch.equal(got, copy(q.tensor(x, device="cpu")).data))
    on_cpu = dict(lenets["cpu"].named_layers())
    same_bias = {n: bool(torch.equal(l.q_bias.cpu(), on_cpu[n].q_bias))
                 for n, l in card.named_layers()}
    log(json.dumps({"phase": "lenet_bias_correction_vs_cpu",
                    "card_equals_cpu_copy": equal,
                    "q_bias_equal_to_cpu_lifecycle": same_bias}))
    if not equal:
        fail("bias-corrected LeNet: the card's codes differ from a CPU copy")
    return {"alexnet_fp32_island_b100": counts}


def attention_bound_ms(b, h, t, d):
    """The encoder attention's bound: q, k, v and the output (u8 [B, T, H
    D]) moved once; QK^T and P@V as int8 operations."""
    return bound(4 * b * t * h * d, 4.0 * b * h * t * t * d)


def encoder_bound_ms(geo, batch=ENC_BATCH) -> float:
    """One INT8 forward's bound: every B1 and B2 launch's (the patch stem's
    conv bound) and the attention's at the int8 peak; the glue's bytes are
    not counted."""
    gemms, (m, k, widths, per), patch = encoder_gemms(geo, batch)
    tot = sum(bound_ms(mm, kk, n)[0] * count
              for _, mm, kk, n, count, _ in gemms)
    tot += bound_ms(m, k, sum(widths), vectors=3)[0] * per
    if patch is not None:
        tot += conv_bound_ms(patch, geo["dim"])[0]
    h = geo["heads"]
    tot += attention_bound_ms(batch, h, encoder_tokens(geo),
                              geo["dim"] // h)[0] * geo["depth"]
    return tot


def encoder_attention_case(torch, gen, geo, dev, batch=ENC_BATCH):
    """Random head-split codes [B, H, T, D] and the grids of one encoder
    attention."""
    h, t = geo["heads"], encoder_tokens(geo)
    qkv = [torch.randint(0, 256, (batch, h, t, geo["dim"] // h),
                         generator=gen, dtype=torch.uint8, device=dev)
           for _ in range(3)]
    kw = dict(ATTN_PARAMS, alpha=(geo["dim"] // h) ** -0.5,
              rounding="nearest")
    return qkv, kw


def encoder_leg(torch, q, zoo, label, name, geo, kernel_fns, route_fns,
                dev):
    """Phases 42-43: an encoder at its published widths (``ENCODERS``),
    batch 64, weights from a ``torch.Generator`` on the card: the FP32
    forward against its twin on the card (1e-4 of the largest logit) and
    its ms/batch, calibrate on one batch, convert, one INT8 forward with
    exactly the B1 and B2 launches of ``encoder_launches`` and one composed
    attention a block; INT8 ms/batch (CUDA events around 20 forwards, input
    on the card) and items/s, a profiled forward's busy split (B1, B2, the
    composed attention timed alone at its shape, the glue) beside the
    forward's bound.  Returns (model, the forward's launches)."""
    from int8inferenceengine_tpu_torch.ops import attention as A
    from int8inferenceengine_tpu_torch.ops.qmatmul import qmatmul_act
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch = ENC_BATCH
    x_calib = encoder_inputs(geo, batch, 1)
    x_test = encoder_inputs(geo, batch, 2)
    state = encoder_state(torch, name, geo, 0, dev)
    with torch.device(dev):
        twin = encoder_twin(name)(**geo, seed=0)
    twin.load_state_dict(state)
    twin.eval()
    model = zoo.build(name, config=q.QuantConfig(**ENC_CFG), device=dev,
                      **geo)
    model.load(state)
    del state
    xt = q.tensor(x_test, device=dev)
    fp32 = model(xt).data
    with torch.no_grad():
        ref = twin(torch.tensor(x_test, device=dev))
    del twin
    fp_err = float((fp32 - ref).abs().max()) / float(ref.abs().max())
    log(json.dumps({"phase": f"{label}_fp32_vs_twin",
                    "max_err_rel_to_max": fp_err}))
    if tuple(fp32.shape) != tuple(ref.shape) or fp_err > 1e-4:
        fail(f"FP32 {label} differs from its torch twin: {fp_err}")
    fp32_ms = time_cuda(torch, lambda: model(xt), iters=5)
    model.prepare()
    model(q.tensor(x_calib, device=dev))
    model.convert()
    torch.cuda.synchronize()
    lifecycle_s = time.perf_counter() - t0
    fns = dict(kernel_fns, **route_fns)
    reset_counts(fns)
    out = model(xt).data
    torch.cuda.synchronize()
    counts = read_counts(fns)
    want = dict.fromkeys(fns, 0) | encoder_launches(geo) | {
        "encoder_attention": geo["depth"]}
    if counts != want:
        fail(f"INT8 {label} forward launched {counts}, want {want}")
    if tuple(out.shape) != (batch, geo["num_classes"]) or not bool(
            torch.isfinite(out).all()):
        fail(f"INT8 {label} output {tuple(out.shape)} or non-finite")
    top1 = float((out.argmax(1) == ref.argmax(1)).float().mean())
    del fp32, ref, out
    int8_ms = time_cuda(torch, lambda: model(xt), iters=20)
    rows, wall_us = profiled(torch, lambda: model(xt), 3, lambda: model(xt))
    busy = sum(e.self_device_time_total for e in rows) / 3
    split = by_kernel(rows, 3)
    gen = torch.Generator(device=dev).manual_seed(9)
    (qq, kk, vv), kw = encoder_attention_case(torch, gen, geo, dev)
    attn_ms = time_cuda(torch, lambda: A.attention_xla(qq, kk, vv, **kw),
                        iters=5)
    mm = dict(scale_a=kw["scale_q"], zp_a=kw["zp_q"], scale_b=kw["scale_k"],
              zp_b=kw["zp_k"], scale_c=kw["scale_s"], zp_c=kw["zp_s"])
    qk_ms = time_cuda(torch, lambda: qmatmul_act(qq, kk, transpose_b=True,
                                                 **mm), iters=5)
    pp = torch.randint(0, 256, qq.shape[:3] + qq.shape[2:3], generator=gen,
                       dtype=torch.uint8, device=dev)
    pv_ms = time_cuda(torch, lambda: qmatmul_act(pp, vv, **mm), iters=5)
    del qq, kk, vv, pp
    us = {"B1": split.get("qgemm_u8s8", {}).get("us", 0.0),
          "B2": split.get("qgemm_u8s8_vzp", {}).get("us", 0.0),
          "composed attention": 1e3 * attn_ms * geo["depth"]}
    us["glue"] = busy - sum(us.values())
    bound_fwd = encoder_bound_ms(geo)
    log(json.dumps({"phase": f"{label}_summary", "card": nvidia_smi(),
                    **geo, "batch": batch, "tokens": encoder_tokens(geo),
                    "launches": {k: v for k, v in counts.items() if v},
                    "prepare_calibrate_convert_s": lifecycle_s,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "top1_agreement_vs_fp32": top1,
                    "fp32_ms_per_batch": fp32_ms,
                    "int8_ms_per_batch": int8_ms,
                    "int8_items_per_s": batch * 1e3 / int8_ms,
                    "fp32_items_per_s": batch * 1e3 / fp32_ms,
                    "forward_bound_ms": bound_fwd,
                    "share_of_bound": bound_fwd / int8_ms,
                    "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1 - busy / (int8_ms * 1e3),
                    "wall_us_profiled": wall_us,
                    "busy_split_us": us,
                    "attention_ms_per_layer": attn_ms,
                    "attention_f64_products_ms_per_layer": {
                        "qk": qk_ms, "pv": pv_ms},
                    "profile_by_kernel": split, "gated": False}))
    mark(f"{label} main path")
    return model, counts


def encoders_paths(torch, q, zoo, kernel_fns, route_fns, dev):
    """Phases 40-43 in order: the small encoders against a CPU copy, the
    lifecycle gates, ViT-B/16 with its ``InferenceEngine``, the BERT-width
    text encoder.  Returns the launches of the main paths."""
    encoders_small_vs_cpu(torch, q, zoo, dev)
    counts = lifecycle_gates(torch, q, zoo, kernel_fns, route_fns, dev)
    mark("encoders: small gates, lifecycle gates")
    for label, name, geo in ENCODERS:
        model, counts[label] = encoder_leg(torch, q, zoo, label, name, geo,
                                           kernel_fns, route_fns, dev)
        if name == "vit_tiny":
            counts["vit_b16_engine"] = serve_cnn(torch, q, model, kernel_fns,
                                                 label="vit_b16")
        del model
        torch.cuda.empty_cache()
    mark("encoders")
    return counts


def time_encoder_kernels(torch, q, G, C, A, gen, dev, flush):
    """B1 and B2 at one ViT-B/16 and one BERT-width b64 forward's shapes
    (``time_gemms``, the patch stem's conv through ``time_cnn_gemms``):
    kernel rows a forward.  Then the library routes: the composed encoder
    attention at both shapes (a forward's 12 layers; the bound: q, k, v and
    the output moved once, the products at the int8 peak) and the FP32
    island at AlexNet's fc3 (M = 100, K = 4,096, N = 10; the bound: its
    float32 weight and the u8 codes moved once, 2MNK at the float32
    peak)."""
    from int8inferenceengine_tpu_torch import layers as L
    rows, crows, lrows = [], [], []
    for label, _, geo in ENCODERS:
        gemms, qkv, patch = encoder_gemms(geo)
        rows += time_gemms(torch, G, gen, dev, flush, label, gemms, qkv,
                           rounding="nearest")
        if patch is not None:
            crows += time_cnn_gemms(torch, G, C, gen, dev, flush, {
                ("conv", patch, geo["dim"]): ("patch", 1)}, label)
        (qq, kk, vv), kw = encoder_attention_case(torch, gen, geo, dev)
        ms = time_cuda(torch, lambda: A.attention_xla(qq, kk, vv, **kw),
                       iters=5, flush=flush)
        h = geo["heads"]
        b_ms, b_by, _, _ = attention_bound_ms(ENC_BATCH, h,
                                              encoder_tokens(geo),
                                              geo["dim"] // h)
        lrows.append(dict(kernel="encoder_attention", path=label,
                          layer=f"b{ENC_BATCH} H{h} T{encoder_tokens(geo)} "
                                f"D{geo['dim'] // h}",
                          launches_per_unit=geo["depth"], ms=ms,
                          bound_ms=b_ms, bound_by=b_by))
        del qq, kk, vv
    log_rows(rows)
    rows += crows
    for path in sorted({r["path"] for r in rows}):
        mine = [r for r in rows if r["path"] == path]
        log(json.dumps({"kernels_per_unit": path} | {
            key: sum(r[key] * r["launches_per_unit"] for r in mine)
            for key in ("ms", "bound_ms", "plain_ms", "library_ms")}))
    m, k, n = 100, 4096, 10
    layer = L.Linear(k, n, device=dev)
    layer.load_weight(torch.randn((n, k), generator=gen, device=dev) * 0.02)
    layer.quant_fallback = layer.is_quantized = True
    layer.scale, layer.zero_point = 0.05, 120
    x = q.Tensor(torch.randint(0, 256, (m, k), generator=gen,
                               dtype=torch.uint8, device=dev), 0.02, 128)
    ms = time_cuda(torch, lambda: L.fp32_island(layer, x), iters=10,
                   flush=flush)
    b_ms, b_by, _, _ = bound(m * k + 4 * n * k + 4 * n + m * n,
                             2.0 * m * n * k, PEAK_FP32_OPS)
    lrows.append(dict(kernel="fp32_island", path="alexnet_fp32_island_b100",
                      layer=f"fc3 M {m} K {k} N {n}", launches_per_unit=1,
                      ms=ms, bound_ms=b_ms, bound_by=b_by))
    for r in lrows:
        log(json.dumps(r | {"share_of_bound": r["bound_ms"] / r["ms"]}))
    return rows, lrows


# -- phases 44-47: the accuracy levers -----------------------------------------

# AlexNet's CLE chain: ReLU / max-pool between each pair; the flatten stops
# conv5 -> fc1
ALEX_CLE_PAIRS = [("conv1", "conv2"), ("conv2", "conv3"), ("conv3", "conv4"),
                  ("conv4", "conv5"), ("fc1", "fc2"), ("fc2", "fc3")]
ADAROUND_ARGS = dict(iters=400, max_images=8, max_rows=2048)
GPTQ_ARGS = dict(max_rows=4096, damp=0.01)
# the outlier regime of tests/test_smooth.py: hot channels a norm, their gain
OUTLIER_HOT, OUTLIER_GAIN = 4, 30.0
# smoothing keeps the FP32 function: largest |logit| difference over the
# largest |logit|
SMOOTH_FP32_RTOL = 1e-3
# the kernel path against the plain path under the levers' codes: a
# prefill and this many decode steps
LEVER_PLAIN_STEPS = 4
# the whole run's phase 45 at this many of gemma-2-2b's 26 layers (GPTQ's
# time grows with the Linears it sweeps; --levers runs all 26)
WHOLE_LEVERS_GEMMA_DEPTH = 8
# AdaRound on the card against a CPU copy given the same tapped inputs:
# the share of equal codes the port's tests state against the JAX package
ADAROUND_MIN_EQUAL = 0.99
SMALL_LEVER_GEO = dict(vocab_size=4096, max_len=128, dim=256, depth=2,
                       heads=4)
# torch's CPU threads while the CPU sweep of phase 45 runs beside the card's
# work (the rest of the host's cores feed the card)
CPU_SWEEP_THREADS = 4


def outlier_regime(state, pairs, dim, unit_offset, seed=5):
    """Put a decoder's state into the activation-outlier regime in place: on
    every smoothed norm, OUTLIER_HOT channels get OUTLIER_GAIN times the
    gain (the effective gain ``1 + w`` of a unit-offset norm: ``w' = 30 (1
    + w) - 1``) and bias, the consumers' columns 1/OUTLIER_GAIN.  The FP32
    function stays the same."""
    rng = np.random.default_rng(seed)
    for ln_name, lin_names in pairs:
        hot = rng.choice(dim, OUTLIER_HOT, replace=False).tolist()
        g = state[f"{ln_name}.weight"]
        g[hot] = (OUTLIER_GAIN * (1.0 + g[hot]) - 1.0 if unit_offset
                  else OUTLIER_GAIN * g[hot])
        if f"{ln_name}.bias" in state:
            state[f"{ln_name}.bias"][hot] *= OUTLIER_GAIN
        for n in lin_names:
            state[f"{n}.weight"][:, hot] /= OUTLIER_GAIN


def lever_seconds(report, kind=lambda name: name.rstrip("0123456789_")):
    """A lever's per-layer report summed by layer kind (the name without
    its block number)."""
    out = {}
    for name, r in report.items():
        out[kind(name)] = out.get(kind(name), 0.0) + r["seconds"]
    return out


def plain_gemms(G, layers_mod):
    """Stand-ins for B1 and B2 (the layers module's names) that run their
    plain versions on the card."""
    return swapped(layers_mod, qgemm=G.qgemm_plain,
                   qgemm_multi=G.qgemm_multi_plain)


def alexnet_levers(torch, q, zoo, G, layers_mod, kernel_fns, dev):
    """Phase 44: AlexNet-224 b100, the reference's per-tensor 'trunc'
    config with He-scaled random weights, under CLE over ALEX_CLE_PAIRS
    (card equal to a CPU copy bit for bit), then prepare, calibrate on a
    b100 batch, AdaRound (ADAROUND_ARGS; the summed layer-output MSE no
    higher than nearest's), convert and 20 forwards of 8 B1 each, equal
    bit for bit to the same model with B1 swapped for its plain version.
    Records CLE and AdaRound seconds, ms/batch beside the lever-free
    model's, and each model's INT8-vs-FP32 top-1 agreement and max logit
    error.  Returns the launches of one forward."""
    from int8inferenceengine_tpu_torch import utils as U
    batch = 100
    state = he_state(torch, zoo.torch_twin("alexnet"), seed=0)
    rng = np.random.default_rng(0)
    xc = q.tensor(rng.standard_normal((batch, 3, 224, 224)).astype(
        np.float32), device=dev)
    x_calib = xc.data.cpu().numpy()
    xt = q.tensor(rng.standard_normal((batch, 3, 224, 224)).astype(
        np.float32), device=dev)

    plain = zoo.AlexNet(device=dev)
    plain.load(state)
    ref = plain(xt).data
    plain.prepare()
    plain(xc)
    plain.convert()

    model = zoo.AlexNet(device=dev)
    model.load(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U.cross_layer_equalize(model, ALEX_CLE_PAIRS)
    torch.cuda.synchronize()
    cle_s = time.perf_counter() - t0
    cpu = zoo.AlexNet(device="cpu")
    cpu.load(state)
    U.cross_layer_equalize(cpu, ALEX_CLE_PAIRS)
    on_cpu = dict(cpu.named_layers())
    for name, layer in model.named_layers():
        for key in ("weight", "bias"):
            if not torch.equal(getattr(layer, key).cpu(),
                               getattr(on_cpu[name], key)):
                fail(f"CLE: AlexNet {name}.{key} on the card differs from "
                     f"the CPU copy's")
    del cpu, on_cpu
    fp32_err = rel_err(torch, model(xt).data, ref)
    model.prepare()
    model(xc)
    report = {}
    t0 = time.perf_counter()
    U.adaround(model, x_calib, report=report, **ADAROUND_ARGS)
    ada_s = time.perf_counter() - t0
    e_ada = sum(r["mse_adaround"] for r in report.values())
    e_near = sum(r["mse_nearest"] for r in report.values())
    if len(report) != 8 or not e_ada <= e_near:
        fail(f"AdaRound on AlexNet: {len(report)} layers, summed "
             f"layer-output MSE {e_ada} against nearest's {e_near}")
    model.convert()
    reset_counts(kernel_fns)
    out = model(xt).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    if counts != dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": 8}:
        fail(f"AlexNet under the levers launched {counts}, want 8 B1")
    with plain_gemms(G, layers_mod):
        out_plain = model(xt).data
    if not torch.equal(out, out_plain):
        fail("AlexNet under the levers: B1 differs from its plain version")
    # in turns (levers, none, none, levers): a card's clocks drift
    ms = {"levers": [], "no_levers": []}
    for label, m in (("levers", model), ("no_levers", plain),
                     ("no_levers", plain), ("levers", model)):
        ms[label].append(time_cuda(torch, lambda: m(xt), iters=20))
    accuracy = {}
    for label, m in (("no_levers", plain), ("cle_adaround", model)):
        o = m(xt).data
        accuracy[label] = {
            "top1_agreement_vs_fp32": float(
                (o.argmax(1) == ref.argmax(1)).float().mean()),
            "max_logit_err_rel_to_max": rel_err(torch, o, ref)}
    log(json.dumps({
        "phase": "alexnet_levers_b100", "batch": batch,
        "cle_pairs": ALEX_CLE_PAIRS, "cle_s": cle_s,
        "cle_card_equals_cpu": True, "fp32_after_cle_rel_err": fp32_err,
        "adaround": ADAROUND_ARGS, "adaround_s": ada_s,
        "adaround_layers": {n: dict(r, ratio=r["mse_adaround"]
                                    / r["mse_nearest"])
                            for n, r in report.items()},
        "adaround_mse_sum": e_ada, "nearest_mse_sum": e_near,
        "launches_per_forward": counts, "b1_equals_plain": True,
        "ms_per_batch": ms,
        "images_per_s": {k: [batch * 1e3 / t for t in v]
                         for k, v in ms.items()},
        "accuracy": accuracy}))
    return counts


class CpuSweep(threading.Thread):
    """The GPTQ sweep on the CPU in a thread of its own (on CPU_SWEEP_THREADS
    torch threads), so that the card's work goes on meanwhile."""

    def __init__(self, torch, gptq_mod, w, s, bound, hinv):
        super().__init__(daemon=True)
        self.torch, self.gptq_mod = torch, gptq_mod
        self.args = (w, s, bound, hinv)
        self.codes = self.error = None
        self.seconds = 0.0

    def start(self):
        self.threads = self.torch.get_num_threads()
        self.torch.set_num_threads(CPU_SWEEP_THREADS)
        super().start()

    def join(self, timeout=None):
        super().join(timeout)
        self.torch.set_num_threads(self.threads)

    def run(self):
        t0 = time.perf_counter()
        try:
            self.codes = self.gptq_mod.gptq_sweep(*self.args)
        except BaseException as e:       # re-raised by the caller
            self.error = e
        self.seconds = time.perf_counter() - t0


def wq1_sweep_gate(torch, gptq_mod, model, ids, dev):
    """Block 1's wq of a smoothed gemma-2-2b: its tapped rows, the card's
    inverse Hessian and the card's sweep; a CPU sweep of the same weights
    and inverse started in a thread (joined and compared by the caller);
    and the CPU's own Hessian and inverse swept on the card (the card's
    sweep equals the CPU's given one inverse: the gate).  Returns (card
    codes, record, the CPU job)."""
    from int8inferenceengine_tpu_torch.layers import weight_quant_spec
    from int8inferenceengine_tpu_torch.utils.tap import tapped_forward
    x = torch.cat(tapped_forward(model, ids)[id(model.wq1)], 0)
    w, s, bound, _ = weight_quant_spec(model.wq1)
    hinv = gptq_mod.inverse_hessian(x, GPTQ_ARGS["damp"])
    card = gptq_mod.gptq_sweep(w, s, bound, hinv).cpu()
    job = CpuSweep(torch, gptq_mod, w.cpu(), s.cpu(), bound, hinv.cpu())
    job.start()
    own = gptq_mod.gptq_sweep(w, s, bound, gptq_mod.inverse_hessian(
        x.cpu(), GPTQ_ARGS["damp"]).to(dev)).cpu()
    record = {"layer": "wq1", "n": int(w.shape[0]), "k": int(w.shape[1]),
              "rows": int(x.shape[0]),
              "codes_differing_with_own_hessian": int((own != card).sum()),
              "max_code_diff_with_own_hessian": int(
                  (own.to(torch.int32) - card).abs().max())}
    return card, record, job


def gemma_levers(torch, q, zoo, GM, G, A, layers_mod, kernel_fns, dev,
                 depth=None):
    """Phase 45: gemma-2-2b at its published widths (GEMMA2, batch 8, 64 +
    128 tokens, 'nearest', W8A8; ``depth`` of its layers, all by default)
    in the outlier regime (``outlier_regime``
    on its unit-offset norms), three ways: no lever, ``smooth`` alone, and
    ``smooth`` then ``gptq`` (GPTQ_ARGS) before prepare.  Gates: the
    smoothed FP32 logits within SMOOTH_FP32_RTOL of the unsmoothed ones;
    the card's GPTQ sweep over block 1's wq equal to a CPU sweep given the
    same inverse Hessian; the smooth + GPTQ model's captured ``generate``
    with 4 * depth + 1 B1, depth B2 and depth B3 a step, and a prefill and
    LEVER_PLAIN_STEPS steps equal to the plain path.  Records the levers'
    seconds, the lever-free and the levers' ms/step (64 captured replays
    each), and each way's INT8-vs-FP32 last-position logit error and
    greedy-token agreement (the FP32 model's argmax teacher-forced on the
    INT8 tokens).  Returns the smooth + GPTQ generate's launches."""
    from int8inferenceengine_tpu_torch import utils as U
    gptq_mod = lever_module("gptq")
    geo = dict(GEMMA2, depth=depth or GEMMA2["depth"])
    depth = geo["depth"]
    cfg = q.QuantConfig(**GEMMA_CFG)
    ids = np.random.default_rng(0).integers(
        0, geo["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    xi = q.tensor(ids, device=dev)
    state = gemma_state(torch, twin_shapes(torch, GM, twin_kwargs(geo)),
                        depth, 0, dev)

    def build():
        m = zoo.build("gemma_tiny", config=cfg, device=dev, **geo)
        m.load(state)                     # shares the state's storage
        return m

    fp = build()
    pairs = U.transformer_smooth_pairs(fp)
    outlier_regime(state, pairs, geo["dim"], unit_offset=True)
    with torch.no_grad():
        ref = fp(xi).data
    results, seconds = {}, {}
    for way in ("none", "smooth", "smooth_gptq"):
        model = build()
        if way != "none":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            U.smooth(model, pairs, ids)
            torch.cuda.synchronize()
            seconds["smooth"] = time.perf_counter() - t0
        if way == "smooth":
            with torch.no_grad():
                fp32_err = rel_err(torch, model(xi).data, ref)
            if not fp32_err <= SMOOTH_FP32_RTOL:
                fail(f"gemma-2-2b: smoothing moved the FP32 logits by "
                     f"{fp32_err} of the largest")
            card, sweep, cpu_job = wq1_sweep_gate(torch, gptq_mod, model,
                                                  ids, dev)
        if way == "smooth_gptq":
            report = {}
            t0 = time.perf_counter()
            U.gptq(model, ids, report=report, **GPTQ_ARGS)
            seconds["gptq"] = time.perf_counter() - t0
            seconds["gptq_by_kind"] = lever_seconds(report)
            if not torch.equal(model.wq1._adaround_qw.cpu(), card):
                fail("gemma-2-2b wq1: gptq() chose other codes than the "
                     "sweep alone")
            worse = [n for n, r in report.items()
                     if not r["mse_gptq"] < r["mse_nearest"]]
        model.prepare()
        model(xi)
        model.convert()
        torch.cuda.empty_cache()
        reset_counts(kernel_fns)
        tokens = model.generate(ids, DEC_STEPS)
        torch.cuda.synchronize()
        counts = read_counts(kernel_fns)
        with torch.no_grad():
            last = model(xi).data[:, -1]
            seq = np.concatenate([ids, tokens], 1)[:, :-1]
            fp_next = fp(q.tensor(seq, device=dev)).data[
                :, DEC_PROMPT - 1:].argmax(-1)
        results[way] = {
            "last_position_logit_err_rel_to_max": rel_err(
                torch, last, ref[:, -1]),
            "greedy_agreement_vs_fp32": float(
                (fp_next.cpu() == torch.from_numpy(tokens).long()).float()
                .mean())}
        del last, fp_next
        if way != "smooth":
            # the lever-free and the levers' steps, one protocol, one call
            results[way]["decode_ms_per_step"] = time_captured_steps(
                torch, model, torch.tensor(ids, dtype=torch.int64,
                                           device=dev), 64)[0]
        if way != "smooth_gptq":
            del model
            torch.cuda.empty_cache()
    cpu_job.join()
    if cpu_job.error is not None:
        raise cpu_job.error
    if not torch.equal(card, cpu_job.codes):
        fail(f"GPTQ sweep over gemma-2-2b wq1: the card differs from the "
             f"CPU on {int((card != cpu_job.codes).sum())} codes")
    sweep.update(card_equals_cpu_given_hinv=True, cpu_sweep_s=cpu_job.seconds)
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 4 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    check_captured_launches(torch, "gemma2_2b_levers", counts, model, ids,
                            dict(per_step, decode_attn_flat=0), per_step,
                            kernel_fns)
    prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    got = teacher_forced(torch, model, prompt, toks[:, :LEVER_PLAIN_STEPS + 1])
    with plain_gemms(G, layers_mod), swapped(A, **plain_attn(A)):
        want = teacher_forced(torch, model, prompt,
                              toks[:, :LEVER_PLAIN_STEPS + 1])
    mx, share = contract(torch, got, want)
    if mx:
        fail(f"gemma-2-2b under the levers, kernel path vs plain path: max "
             f"{mx} codes, share {share}")
    del got, want
    log(json.dumps({
        "phase": "gemma2_2b_levers", **geo, "batch": DEC_BATCH,
        "prompt": DEC_PROMPT, "steps": DEC_STEPS,
        "outlier_regime": {"hot_channels": OUTLIER_HOT,
                           "gain": OUTLIER_GAIN},
        "smooth_fp32_err_rel_to_max": fp32_err,
        "limit": SMOOTH_FP32_RTOL, "seconds": seconds, "gptq": GPTQ_ARGS,
        "gptq_layers": len(report),
        "gptq_layers_not_below_nearest": worse, "gptq_sweep_gate": sweep,
        "launches": counts, "launches_per_decode_step": per_step,
        "kernel_vs_plain": {"steps": LEVER_PLAIN_STEPS, "max_abs_err": mx,
                            "share_differing": share},
        "decode_protocol": "64 replays of a captured step between CUDA "
                           "events", "accuracy": results}))
    del model, fp, ref, state
    torch.cuda.empty_cache()
    return counts


def llama_levers(torch, q, zoo, LL, W, kernel_fns, dev):
    """Phase 46: the llama legs of phases 9-10 (bench.py's widths) under
    GPTQ's 4-bit codes, chosen before prepare with their group scales:
    W4A8's captured ``generate`` (the prefill's B7, 49 B6 and 12 B3 a
    step) with every W4 launch of a prefill and 16 steps replayed against
    its plain version (B6 exact, B7 within its 1-code / 0.2% contract), and
    the W4 weight-only forward (85 B5, within 1e-4 of its plain version).
    Gate: every Linear's GPTQ output MSE below ``pack_w4``'s nearest
    codes'.  Returns the launches of both."""
    from int8inferenceengine_tpu_torch import utils as U
    depth = LLAMA["depth"]
    twin = LL.torch_llama(**LLAMA, seed=0)
    state = decoder_state(torch, twin, depth, seed=0,
                          residual=("proj", "down"))
    ids = np.random.default_rng(0).integers(
        0, LLAMA["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    out, counts = {}, {}
    for label, cfg in (("w4a8", LLAMA_W4A8), ("w4", LLAMA_W4)):
        model = zoo.build("llama_tiny", config=q.QuantConfig(**cfg),
                          device=dev, **LLAMA)
        model.load(state)
        report = {}
        t0 = time.perf_counter()
        U.gptq(model, ids, report=report, **GPTQ_ARGS)
        gptq_s = time.perf_counter() - t0
        worse = {n: r for n, r in report.items()
                 if not r["mse_gptq"] < r["mse_nearest"]}
        if len(report) != 7 * depth + 1 or worse:
            fail(f"llama {label} GPTQ: {len(report)} layers; output MSE not "
                 f"below nearest's at {worse}")
        ratios = [r["mse_gptq"] / r["mse_nearest"] for r in report.values()]
        xt = q.tensor(ids, device=dev)
        if label == "w4a8":
            model.prepare()
            model(xt)
            model.convert()
            reset_counts(kernel_fns)
            tokens = model.generate(ids, DEC_STEPS)
            torch.cuda.synchronize()
            counts["llama_w4a8_gptq_generate"] = read_counts(kernel_fns)
            per_step = dict.fromkeys(kernel_fns, 0) | {
                "w4a8_v2_gemm": 4 * depth + 1, "decode_attn_flat": depth}
            prefill = dict.fromkeys(kernel_fns, 0) | {
                "w4a8_v1_gemm": 4 * depth + 1}
            check_captured_launches(torch, "llama_w4a8_gptq",
                                    counts["llama_w4a8_gptq_generate"],
                                    model, ids, prefill, per_step,
                                    kernel_fns)
            prompt = torch.tensor(ids, dtype=torch.int64, device=dev)
            toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
            stats = {}
            with swapped(W, **replaying(torch, W, stats)):
                teacher_forced(torch, model, prompt, toks[:, :DEC_SHORT + 1])
            replayed = {"w4a8_v1_gemm": 4 * depth + 1,
                        "w4a8_v2_gemm": DEC_SHORT * (4 * depth + 1)}
            if {k: s["launches"] for k, s in stats.items()} != replayed:
                fail(f"llama W4A8 GPTQ: replayed {stats}, want {replayed}")
            extra = {"replayed": stats,
                     "distinct_tokens": int(np.unique(tokens).size)}
        else:
            model.convert()
            reset_counts(kernel_fns)
            logits = model(xt).data
            torch.cuda.synchronize()
            counts["llama_w4_gptq_forward"] = read_counts(kernel_fns)
            want = dict.fromkeys(kernel_fns, 0) | {"w4_gemm": 7 * depth + 1}
            if counts["llama_w4_gptq_forward"] != want:
                fail(f"llama W4 GPTQ forward launched "
                     f"{counts['llama_w4_gptq_forward']}, want {want}")
            with swapped(W, **plain_w4(W)):
                rel = rel_err(torch, logits, model(xt).data)
            if not rel <= 1e-4:
                fail(f"llama W4 GPTQ forward: B5 path {rel} of the largest "
                     f"|logit| from the plain path")
            extra = {"b5_vs_plain_rel_to_max": rel, "limit": 1e-4}
        out[label] = dict(gptq_s=gptq_s, gptq_by_kind=lever_seconds(report),
                          mse_ratio_max=max(ratios),
                          mse_ratio_mean=sum(ratios) / len(ratios), **extra)
        del model
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "llama_levers_gptq", "gptq": GPTQ_ARGS,
                    "launches": counts, **out}))
    return counts


def lever_module(name: str):
    """The module ``utils.<name>`` (the package's attribute of that name is
    the lever's function)."""
    import importlib
    return importlib.import_module(f"int8inferenceengine_tpu_torch.utils."
                                   f"{name}")


def lever_state(torch, name, geo, seed=0):
    """A small family's twin weights (CPU tensors) in the outlier regime."""
    from int8inferenceengine_tpu_torch.models import (gemma, llama,
                                                      text_transformer)
    twin = {"gemma_tiny": gemma.torch_gemma, "llama_tiny": llama.torch_llama,
            "text_tiny": text_transformer.torch_text_transformer}[name]
    state = {k: v.clone() for k, v in twin(**geo, seed=seed).state_dict()
             .items()}
    return state


def card_taps(torch, smooth_or_lever_mod, card, cpu):
    """Run a lever on ``card`` recording its tapped forward, and return a
    stand-in ``tapped_forward`` for ``cpu`` that hands the CPU copy the
    card's inputs (by layer name), so that both take the same maxima and
    rows."""
    real = smooth_or_lever_mod.tapped_forward
    seen = {}

    def recording(net, x, observe=True):
        seen.update(real(net, x, observe))
        return seen

    def replay(net, x, observe=True):
        names = {id(l): n for n, l in card.named_layers()}
        by_name = dict(cpu.named_layers())
        return {id(by_name[names[k]]): [t.cpu() for t in v]
                for k, v in seen.items()}

    return recording, replay


def levers_small_gates(torch, q, zoo, dev):
    """Phase 47: the dim-256 gemma_tiny, llama_tiny and text_tiny in the
    outlier regime under smooth + GPTQ, and LeNet under CLE + AdaRound, on
    the card against a CPU copy given the card's tapped inputs (the FP32
    forwards themselves add in another order): the smoothed and equalized
    weights equal bit for bit, GPTQ's codes equal given the card's inverse
    Hessians, and AdaRound's codes equal on at least ADAROUND_MIN_EQUAL of
    the weights."""
    from int8inferenceengine_tpu_torch import utils as U
    ada_mod, gptq_mod, smooth_mod = (lever_module(n) for n in (
        "adaround", "gptq", "smooth"))
    rows = {}
    for name in ("gemma_tiny", "llama_tiny", "text_tiny"):
        geo = dict(SMALL_LEVER_GEO)
        if name == "text_tiny":
            geo["max_len"] = SMALL_PROMPT
        else:
            geo["kv_heads"] = 2
        state = lever_state(torch, name, geo)
        models = {}
        for where in (dev, "cpu"):
            m = zoo.build(name, config=q.QuantConfig(rounding="nearest"),
                          device=where, **geo)
            models[str(where)] = m
        card, cpu = models[str(dev)], models["cpu"]
        pairs = U.transformer_smooth_pairs(card)
        outlier_regime(state, pairs, geo["dim"],
                       unit_offset=name == "gemma_tiny")
        card.load({k: v.to(dev) for k, v in state.items()})
        cpu.load(state)
        ids = np.random.default_rng(3).integers(
            0, geo["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
                np.int32)
        recording, replay = card_taps(torch, smooth_mod, card, cpu)
        with swapped(smooth_mod, tapped_forward=recording):
            U.smooth(card, pairs, ids)
        with swapped(smooth_mod, tapped_forward=replay):
            U.smooth(cpu, pairs, ids)
        on_cpu = dict(cpu.named_layers())
        for n, layer in card.named_layers():
            for key in ("weight", "bias"):
                t = getattr(layer, key, None)
                if t is not None and not torch.equal(
                        t.cpu(), getattr(on_cpu[n], key)):
                    fail(f"smooth: {name} {n}.{key} on the card differs "
                         f"from the CPU copy's")
        hinvs = []
        real_inv = gptq_mod.inverse_hessian

        def recording_inv(x, damp):
            h = real_inv(x, damp)
            hinvs.append(h.cpu())
            return h

        with swapped(gptq_mod, inverse_hessian=recording_inv):
            U.gptq(card, ids)
        handed = iter(hinvs)
        with swapped(gptq_mod, inverse_hessian=lambda x, damp: next(handed)):
            U.gptq(cpu, ids)
        differ = {n: int((l._adaround_qw.cpu()
                          != on_cpu[n]._adaround_qw).sum())
                  for n, l in card.named_layers()
                  if l._adaround_qw is not None}
        linears = sum(isinstance(l, q.Linear) for _, l in card.named_layers())
        if any(differ.values()) or len(differ) != linears or \
                next(handed, None) is not None:
            fail(f"GPTQ: {name}'s codes on the card differ from the CPU "
                 f"copy's given the same inverse Hessians: {differ} "
                 f"({len(hinvs)} sweeps)")
        rows[name] = {"smoothed_equal": True, "gptq_layers": len(differ),
                      "gptq_sweeps": len(hinvs), "gptq_codes_equal": True}
    sd = zoo.torch_twin("lenet").state_dict()
    x = np.random.default_rng(4).uniform(-1, 1, (32, 1, 28, 28)).astype(
        np.float32)
    lenets = {}
    for where in (dev, "cpu"):
        m = zoo.build("lenet", device=where)
        m.load(sd)
        U.cross_layer_equalize(m, [("conv1", "conv2"), ("fc1", "fc2")])
        lenets[str(where)] = m
    card, cpu = lenets[str(dev)], lenets["cpu"]
    on_cpu = dict(cpu.named_layers())
    for n, layer in card.named_layers():
        for key in ("weight", "bias"):
            if not torch.equal(getattr(layer, key).cpu(),
                               getattr(on_cpu[n], key)):
                fail(f"CLE: LeNet {n}.{key} on the card differs from the "
                     f"CPU copy's")
    card.prepare()
    card(q.tensor(x, device=dev))
    recording, replay = card_taps(torch, ada_mod, card, cpu)
    with swapped(ada_mod, tapped_forward=recording):
        U.adaround(card, x, iters=100)
    with swapped(ada_mod, tapped_forward=replay):
        U.adaround(cpu, x, iters=100)
    equal = {}
    for n, layer in card.named_layers():
        a, b = layer._adaround_qw.cpu(), on_cpu[n]._adaround_qw
        equal[n] = {"share_equal": float((a == b).float().mean()),
                    "max_apart": int((a.to(torch.int32) - b).abs().max())}
    low = {n: e for n, e in equal.items()
           if e["share_equal"] < ADAROUND_MIN_EQUAL}
    rows["lenet"] = {"cle_equal": True, "adaround_vs_cpu": equal,
                     "min_share_equal": ADAROUND_MIN_EQUAL}
    log(json.dumps({"phase": "levers_small_vs_cpu", "geometry":
                    SMALL_LEVER_GEO, **rows}))
    if low:
        fail(f"AdaRound on LeNet: the card's codes equal the CPU copy's on "
             f"too few weights: {low}")


def levers_paths(torch, q, zoo, GM, LL, G, A, W, layers_mod, kernel_fns,
                 dev, gemma_depth=None):
    """Phases 44-47 in order, phase 45 at ``gemma_depth`` of gemma-2-2b's
    layers (all by default); returns the launches of their main paths."""
    counts = {"alexnet_levers_b100": alexnet_levers(
        torch, q, zoo, G, layers_mod, kernel_fns, dev)}
    torch.cuda.empty_cache()
    mark("levers: alexnet cle + adaround")
    counts["gemma2_2b_levers_generate"] = gemma_levers(
        torch, q, zoo, GM, G, A, layers_mod, kernel_fns, dev, gemma_depth)
    mark("levers: gemma2_2b smooth + gptq")
    counts.update(llama_levers(torch, q, zoo, LL, W, kernel_fns, dev))
    mark("levers: llama gptq")
    levers_small_gates(torch, q, zoo, dev)
    mark("levers: small gates")
    return counts


# -- phases 48-50: the INT8 artifact ------------------------------------------

TRACE_ATTEMPTS = 3


def saved_and_loaded(torch, model, fresh_fn, name):
    """``utils.save`` of ``model`` into a temporary directory and
    ``utils.load`` into ``fresh_fn()``: (the loaded model, {bytes, save_s,
    fresh_model_s, load_s})."""
    from int8inferenceengine_tpu_torch import utils
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / f"{name}.npz")
        t0 = time.perf_counter()
        utils.save(model, path)
        save_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        t0 = time.perf_counter()
        fresh = fresh_fn()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        utils.load(fresh, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    return fresh, {"artifact_bytes": nbytes, "save_s": save_s,
                   "fresh_model_s": build_s, "load_s": load_s}


def artifact_alexnet(torch, q, zoo, model, x_test, kernel_fns):
    """Phase 48; returns the reloaded forward's launches."""
    from int8inferenceengine_tpu_torch import utils
    from int8inferenceengine_tpu_torch.utils import observe, roofline
    xt = q.tensor(x_test)
    want = model(xt).data
    fresh, io = saved_and_loaded(torch, model,
                                 lambda: zoo.AlexNet(device="cuda"),
                                 "alexnet_int8")
    reset_counts(kernel_fns)
    got = fresh(xt).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    if counts != dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": 8}:
        fail(f"reloaded AlexNet forward launched {counts}, want 8 "
             f"qgemm_u8s8 and nothing else")
    if not torch.equal(got, want):
        fail(f"reloaded AlexNet b100 logits differ from the saved model's "
             f"on {int((got != want).sum())} of {got.numel()}")
    findings = utils.validate.validate(fresh, x_test)
    if findings:
        fail(f"validate(reloaded AlexNet): {findings}")
    report = json.dumps({"saved": utils.quantization_report(model),
                         "loaded": utils.quantization_report(fresh)})
    ms = time_cuda(torch, lambda: fresh(xt), iters=20)
    roof = roofline.report(fresh, (3, 224, 224), x_test.shape[0],
                           measured_s=ms / 1e3)
    if not 0 < roof["percent_of_sol"] <= 100:
        fail(f"roofline percent_of_sol {roof['percent_of_sol']} not in "
             f"(0, 100]")
    # a profiler session's first records can go missing: a trace short of
    # the 8 launches is taken again
    seen = []
    with tempfile.TemporaryDirectory() as d:
        for attempt in range(TRACE_ATTEMPTS):
            log_dir = str(Path(d) / f"trace{attempt}")
            with utils.trace("alexnet_b100_forward", log_dir=log_dir):
                fresh(xt)
            ops = observe.device_op_times(log_dir)
            b1 = sum(v["count"] for k, v in ops.items()
                     if kernel_of(k) == "qgemm_u8s8")
            seen.append(b1)
            if b1 == 8:
                break
    if seen[-1] != 8:
        fail(f"trace of one reloaded AlexNet forward listed B1 {seen} "
             f"times, want 8")
    log(json.dumps({"phase": "alexnet_b100_artifact", **io,
                    "launches": counts, "codes_equal": True,
                    "validate": findings, "report_json_bytes": len(report),
                    "int8_ms_per_batch": ms,
                    "roofline": {k: roof[k] for k in (
                        "total_flops", "total_bytes", "peak_ops",
                        "peak_hbm_Bps", "sol_compute_s", "sol_memory_s",
                        "achieved_ops", "percent_of_peak",
                        "percent_of_sol")},
                    "trace_b1_launches": seen,
                    "trace_kernels": {k[:80]: v for k, v in ops.items()}}))
    del fresh
    return counts


def artifact_gemma(torch, q, zoo, model, ids, kernel_fns):
    """Phase 49 on phase 26's converted gemma-2-2b; returns the reloaded
    ``generate()``'s launches."""
    dev = model.device
    prompt = torch.tensor(ids.astype(np.int64), device=dev)
    tokens = model.generate(ids, DEC_STEPS)
    ms_before, _ = time_captured_steps(torch, model, prompt, 64)
    fresh, io = saved_and_loaded(
        torch, model, lambda: zoo.build(
            "gemma_tiny", config=q.QuantConfig(**GEMMA_CFG), device=dev,
            **GEMMA2), "gemma2_2b_int8")
    reset_counts(kernel_fns)
    got = fresh.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    depth = GEMMA2["depth"]
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 4 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    want = {k: v * DEC_STEPS - (depth if k == "decode_attn_flat" else 0)
            for k, v in per_step.items()}
    if counts != want:
        fail(f"reloaded gemma2_2b generate launched {counts}, want {want}")
    if not np.array_equal(got, tokens):
        fail("reloaded gemma2_2b's greedy tokens differ from the saved "
             "model's")
    ms_after, _ = time_captured_steps(torch, fresh, prompt, 64)
    log(json.dumps({"phase": "gemma2_2b_artifact", **io,
                    "launches": counts, "tokens_equal": DEC_STEPS,
                    "captured_ms_per_step_saved": ms_before,
                    "captured_ms_per_step_loaded": ms_after}))
    del fresh
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def recording(W, A, outs):
    """Swap the 4-bit wrappers (and B3's, given ``A``) for stand-ins that
    launch their kernels and append (kernel, a copy of the output) to
    ``outs``."""
    def keep(kernel, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            outs.append((kernel, out.clone()))
            return out
        return run

    attn = {} if A is None else dict(decode_attention_flat=keep(
        "decode_attn_flat", A.decode_attention_flat))
    with swapped(W, w4a8_v2=keep("w4a8_v2_gemm", W.w4a8_v2),
                 w4a8_v1=keep("w4a8_v1_gemm", W.w4a8_v1),
                 w4_gemm=keep("w4_gemm", W.w4_gemm)), \
            swapped(A, **attn):
        yield


def same_outputs(torch, label, saved, loaded):
    """Every recorded kernel output of the reloaded model equals the saved
    model's bit for bit; returns the launches by kernel."""
    if [k for k, _ in saved] != [k for k, _ in loaded]:
        fail(f"{label}: the reloaded model launched another kernel sequence")
    for i, ((kernel, a), (_, b)) in enumerate(zip(saved, loaded)):
        if not torch.equal(a, b):
            fail(f"{label}: launch {i} of {kernel} differs from the saved "
                 f"model's")
    by = {}
    for kernel, _ in saved:
        by[kernel] = by.get(kernel, 0) + 1
    return by


def artifact_llama_w4a8(torch, q, zoo, W, A, model, ids, kernel_fns):
    """Phase 50 (W4A8) on phase 9's model; returns the reloaded
    ``generate()``'s launches."""
    dev = model.device
    prompt = torch.tensor(ids.astype(np.int64), device=dev)
    tokens = model.generate(ids, DEC_STEPS)
    toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
    saved, loaded = [], []
    with recording(W, A, saved):
        teacher_forced(torch, model, prompt, toks[:, :DEC_SHORT + 1])
    fresh, io = saved_and_loaded(
        torch, model, lambda: zoo.build(
            "llama_tiny", config=q.QuantConfig(**LLAMA_W4A8), **LLAMA),
        "llama_w4a8")
    reset_counts(kernel_fns)
    got = fresh.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    depth = LLAMA["depth"]
    want = dict.fromkeys(kernel_fns, 0) | {
        "w4a8_v1_gemm": 4 * depth + 1,
        "w4a8_v2_gemm": (DEC_STEPS - 1) * (4 * depth + 1),
        "decode_attn_flat": (DEC_STEPS - 1) * depth}
    if counts != want:
        fail(f"reloaded llama W4A8 generate launched {counts}, want {want}")
    if not np.array_equal(got, tokens):
        fail("reloaded llama W4A8's greedy tokens differ from the saved "
             "model's")
    with recording(W, A, loaded):
        teacher_forced(torch, fresh, prompt, toks[:, :DEC_SHORT + 1])
    by = same_outputs(torch, "llama W4A8 artifact", saved, loaded)
    log(json.dumps({"phase": "llama_w4a8_artifact", **io,
                    "launches": counts, "tokens_equal": DEC_STEPS,
                    "kernel_outputs_equal": by}))
    del fresh
    return counts


def artifact_llama_w4(torch, q, zoo, W, model, ids, kernel_fns):
    """Phase 50 (W4 weight-only) on phase 10's model; returns the reloaded
    forward's launches."""
    xt = q.tensor(ids)
    saved, loaded = [], []
    with recording(W, None, saved):
        want = model(xt).data
    fresh, io = saved_and_loaded(
        torch, model, lambda: zoo.build(
            "llama_tiny", config=q.QuantConfig(**LLAMA_W4), **LLAMA),
        "llama_w4")
    reset_counts(kernel_fns)
    got = fresh(xt).data
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    if counts != dict.fromkeys(kernel_fns, 0) | {
            "w4_gemm": 7 * LLAMA["depth"] + 1}:
        fail(f"reloaded llama W4 forward launched {counts}")
    if not torch.equal(got, want):
        fail("reloaded llama W4 logits differ from the saved model's")
    with recording(W, None, loaded):
        fresh(xt)
    by = same_outputs(torch, "llama W4 artifact", saved, loaded)
    log(json.dumps({"phase": "llama_w4_artifact", **io, "launches": counts,
                    "logits_equal": True, "kernel_outputs_equal": by}))
    del fresh
    return counts


def artifact_paths(torch, q, zoo, GM, LL, W, A, kernel_fns, dev):
    """``--artifact``: phases 48-50 on models built here as 5, 26 (no twin
    check), 9 and 10 build them; returns the reloaded paths' launches."""
    counts = {}
    model, x_test, _, _ = alexnet_main_path(torch, q, zoo, kernel_fns, dev)
    counts["alexnet_b100_artifact"] = artifact_alexnet(
        torch, q, zoo, model, x_test, kernel_fns)
    del model
    mark("artifact: alexnet")
    ids = np.random.default_rng(0).integers(
        0, GEMMA2["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    model = build_gemma(torch, q, zoo, GM, GEMMA2, dev, calib=ids,
                        tied_head=True)
    counts["gemma2_2b_artifact_generate"] = artifact_gemma(
        torch, q, zoo, model, ids, kernel_fns)
    del model
    torch.cuda.empty_cache()
    mark("artifact: gemma2_2b")
    twin = LL.torch_llama(**LLAMA, seed=0)
    state = decoder_state(torch, twin, LLAMA["depth"], seed=0,
                          residual=("proj", "down"))
    del twin
    ids = np.random.default_rng(0).integers(
        0, LLAMA["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    model = zoo.build("llama_tiny", config=q.QuantConfig(**LLAMA_W4A8),
                      **LLAMA)
    model.load(state)
    model.prepare()
    model(q.tensor(ids))
    model.convert()
    counts["llama_w4a8_artifact_generate"] = artifact_llama_w4a8(
        torch, q, zoo, W, A, model, ids, kernel_fns)
    del model
    wo, _ = llama_w4_forward_path(torch, q, zoo, W, kernel_fns, state, ids)
    counts["llama_w4_artifact_forward"] = artifact_llama_w4(
        torch, q, zoo, W, wo, ids, kernel_fns)
    mark("artifact: llama")
    return counts


# -- phases 51-53: Hugging Face checkpoint directories ------------------------

# the port's names -> an HF exporter's, per model_type (``utils/hf.py``'s
# maps read backwards): the block prefix, the block tails of the port's
# layer stems (a stem without one is not exported: phi's ln2, which its one
# norm, ln1, carries), the top-level names (no "head": the head is tied to
# the table and not exported), the fused q/k/v tail (gpt2's Conv1D [in, 3 *
# dim]; NeoX's and BLOOM's per-head interleaved [H, 3, D]) and a derived
# buffer that exports carry (dropped on load)
_HF_LLAMA = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "proj": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj", "ln1_": "input_layernorm",
             "ln2_": "post_attention_layernorm"}
_HF_GPTJ = {"fc1_": "mlp.dense_h_to_4h", "fc2_": "mlp.dense_4h_to_h",
            "ln1_": "input_layernorm", "ln2_": "post_attention_layernorm"}
_HF_LLAMA_TOP = {"embed": "model.embed_tokens", "ln_f": "model.norm",
                 "head": "lm_head"}
_HF_ROTARY = "self_attn.rotary_emb.inv_freq"
HF_EXPORT = {
    "gpt2": ("transformer.h.",
             {"ln1_": "ln_1", "ln2_": "ln_2", "proj": "attn.c_proj",
              "fc1_": "mlp.c_fc", "fc2_": "mlp.c_proj"},
             {"embed": "transformer.wte", "pe": "transformer.wpe",
              "ln_f": "transformer.ln_f", "head": "lm_head"},
             "attn.c_attn", "attn.masked_bias"),
    "llama": ("model.layers.", _HF_LLAMA, _HF_LLAMA_TOP, None, _HF_ROTARY),
    "mistral": ("model.layers.", _HF_LLAMA, _HF_LLAMA_TOP, None, _HF_ROTARY),
    "gemma2": ("model.layers.",
               dict(_HF_LLAMA, ln2_="pre_feedforward_layernorm",
                    postn1_="post_attention_layernorm",
                    postn2_="post_feedforward_layernorm"),
               {"embed": "model.embed_tokens", "ln_f": "model.norm"}, None,
               _HF_ROTARY),
    "gpt_neox": ("gpt_neox.layers.", dict(_HF_GPTJ, proj="attention.dense"),
                 {"embed": "gpt_neox.embed_in",
                  "ln_f": "gpt_neox.final_layer_norm", "head": "embed_out"},
                 "attention.query_key_value", "attention.rotary_emb.inv_freq"),
    "phi": ("model.layers.",
            {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "proj": "self_attn.dense",
             "fc1_": "mlp.fc1", "fc2_": "mlp.fc2", "ln1_": "input_layernorm"},
            {"embed": "model.embed_tokens", "ln_f": "model.final_layernorm",
             "head": "lm_head"}, None, _HF_ROTARY),
    "opt": ("model.decoder.layers.",
            {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "proj": "self_attn.out_proj",
             "fc1_": "fc1", "fc2_": "fc2", "ln1_": "self_attn_layer_norm",
             "ln2_": "final_layer_norm"},
            {"embed": "model.decoder.embed_tokens",
             "ln_f": "model.decoder.final_layer_norm", "head": "lm_head"},
            None, None),
    "bloom": ("transformer.h.", dict(_HF_GPTJ, proj="self_attention.dense"),
              {"embed": "transformer.word_embeddings",
               "embed_ln": "transformer.word_embeddings_layernorm",
               "ln_f": "transformer.ln_f", "head": "lm_head"},
              "self_attention.query_key_value", None),
}
# the only exporter here whose head carries a bias (the others' is zero)
HF_HEAD_BIAS = ("phi",)
_PORT_BLOCK = re.compile(r"(wq|wk|wv|proj|gate|up|down|fc1_|fc2_|ln1_|ln2_|"
                         r"postn1_|postn2_)(\d+)")


def hf_export(model_type, state, heads, derived=True) -> dict:
    """``state`` (the port's names; torch tensors) under an HF exporter's
    names and layouts (``HF_EXPORT``), as host numpy arrays: gpt2's Conv1D
    weights transposed, the fused q/k/v, OPT's two leading position rows,
    and (``derived``) the family's derived buffer."""
    prefix, tails, top, fused, buffer = HF_EXPORT[model_type]
    out, qkv = {}, {}
    for key, v in state.items():
        stem, attr = key.rsplit(".", 1)
        a = v.cpu().numpy()
        if stem == "head" and ("head" not in top or (
                attr == "bias" and model_type not in HF_HEAD_BIAS)):
            continue
        if stem in top:
            out[f"{top[stem]}.{attr}"] = a
            continue
        if stem == "pe":                             # OPT's, offset by 2
            out["model.decoder.embed_positions.weight"] = np.concatenate(
                [np.full((2, a.shape[1]), 7.0, np.float32), a])
            continue
        kind, n = _PORT_BLOCK.fullmatch(stem).groups()
        p = f"{prefix}{int(n) - 1}."
        if fused and kind in ("wq", "wk", "wv"):
            qkv.setdefault((p, attr), {})[kind] = a
        elif kind in tails:
            conv1d = (model_type == "gpt2" and attr == "weight"
                      and not kind.startswith("ln"))
            out[f"{p}{tails[kind]}.{attr}"] = (np.ascontiguousarray(a.T)
                                               if conv1d else a)
    for (p, attr), t in qkv.items():
        q_, k_, v_ = t["wq"], t["wk"], t["wv"]
        if model_type == "gpt2":
            out[f"{p}{fused}.{attr}"] = (
                np.concatenate([q_.T, k_.T, v_.T], axis=1)
                if attr == "weight" else np.concatenate([q_, k_, v_]))
        else:
            out[f"{p}{fused}.{attr}"] = np.stack(
                [x.reshape(heads, -1, *x.shape[1:]) for x in (q_, k_, v_)],
                axis=1).reshape(-1, *q_.shape[1:])
    if derived and buffer:
        out[f"{prefix}0.{buffer}"] = np.ones(8, np.float32)
    return out


def write_hf_dir(torch, d, cfg, parts, form, n_parts=1) -> int:
    """An HF checkpoint directory ``d``: ``config.json`` and the weights of
    ``parts`` (an iterable of {HF name: array or tensor}, consumed one at a
    time) as
    ``model.safetensors`` ('single'), ``pytorch_model.bin`` ('bin') or
    ``n_parts`` shards with their ``model.safetensors.index.json``
    ('sharded').  Returns the directory's bytes."""
    from safetensors.numpy import save_file
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(cfg, indent=1))
    weight_map = {}
    for i, part in enumerate(parts):
        if form == "bin":
            torch.save({k: torch.as_tensor(v).contiguous()
                        for k, v in part.items()}, d / "pytorch_model.bin")
            continue
        part = {k: np.ascontiguousarray(v) for k, v in part.items()}
        name = (f"model-{i + 1:05d}-of-{n_parts:05d}.safetensors"
                if form == "sharded" else "model.safetensors")
        save_file(part, str(d / name))
        weight_map.update(dict.fromkeys(part, name))
        del part
    if form == "sharded":
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": weight_map}))
    return sum(p.stat().st_size for p in d.iterdir())


def hf_small_legs(TD, LL, GM):
    """Phase 51's legs at SMALL_DEC's widths: (model_type, config.json, the
    twin (the weights' shapes), file form, load_pretrained overrides)."""
    from int8inferenceengine_tpu_torch.models import bloom, neox
    g = SMALL_DEC
    common = {"vocab_size": g["vocab_size"],
              "max_position_embeddings": g["max_len"],
              "hidden_size": g["dim"], "num_hidden_layers": g["depth"],
              "num_attention_heads": g["heads"]}
    hidden = LL.swiglu_hidden(g["dim"])
    llama = dict(common, model_type="llama", num_key_value_heads=2,
                 intermediate_size=hidden, rms_norm_eps=1e-6,
                 rope_theta=10000.0)
    neox_cfg = dict(common, model_type="gpt_neox", rotary_pct=0.25,
                    rotary_emb_base=10000, use_parallel_residual=True,
                    layer_norm_eps=1e-5)
    return [
        ("gpt2", {"model_type": "gpt2", "vocab_size": g["vocab_size"],
                  "n_positions": g["max_len"], "n_embd": g["dim"],
                  "n_layer": g["depth"], "n_head": g["heads"]},
         lambda: TD.torch_text_decoder(**g), "single", {}),
        ("llama", llama,
         lambda: LL.torch_llama(**g, kv_heads=2, mlp_hidden=hidden),
         "sharded", {}),
        ("mistral", dict(llama, model_type="mistral", sliding_window=32),
         lambda: LL.torch_llama(**g, kv_heads=2, mlp_hidden=hidden),
         "single", {}),
        ("gemma2", dict(common, model_type="gemma2", num_key_value_heads=2,
                        head_dim=g["dim"] // g["heads"],
                        intermediate_size=4 * g["dim"], sliding_window=32,
                        attn_logit_softcapping=50.0,
                        final_logit_softcapping=30.0, rms_norm_eps=1e-6,
                        rope_theta=10000.0),
         lambda: GM.torch_gemma(**g, kv_heads=2, sliding_window=32),
         "single", {}),
        ("gpt_neox", neox_cfg, lambda: neox.torch_neox(**g), "single", {}),
        ("phi", dict(common, model_type="phi", partial_rotary_factor=0.5,
                     rope_theta=10000.0, layer_norm_eps=1e-5),
         lambda: neox.torch_neox(**g, rotary_pct=0.5), "single", {}),
        ("opt", dict(common, model_type="opt", ffn_dim=4 * g["dim"],
                     activation_function="relu", do_layer_norm_before=True),
         lambda: TD.torch_text_decoder(**g, act="relu"), "bin", {}),
        # BLOOM's config has no maximum length (ALiBi): the caller's
        ("bloom", {"model_type": "bloom", "vocab_size": g["vocab_size"],
                   "hidden_size": g["dim"], "n_layer": g["depth"],
                   "n_head": g["heads"], "layer_norm_epsilon": 1e-5},
         lambda: bloom.torch_bloom(**g), "single",
         {"max_len": g["max_len"]}),
    ]


def hf_small_state(torch, model_type, twin, seed=5) -> dict:
    """``card_state``'s weights on the CPU for the twin's shapes, made what
    the family's export can carry: a zero head bias where it has none, the
    head tied to the table (gemma-2), phi's one norm a block (ln2 = ln1);
    the llama leg gains qwen2-style q/k/v biases."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in twin().state_dict().items()}
    depth = SMALL_DEC["depth"]
    if model_type == "llama":
        for i in range(1, depth + 1):
            for w in ("wq", "wk", "wv"):
                shapes[f"{w}{i}.bias"] = shapes[f"{w}{i}.weight"][:1]
    state = card_state(torch, shapes, depth, seed, "cpu")
    if "head.bias" in state and model_type not in HF_HEAD_BIAS:
        state["head.bias"].zero_()
    if model_type == "gemma2":
        state["head.weight"] = state["embed.weight"].clone()
    if model_type == "phi":
        for i in range(1, depth + 1):
            for attr in ("weight", "bias"):
                state[f"ln2_{i}.{attr}"] = state[f"ln1_{i}.{attr}"].clone()
    return state


def fp32_mismatches(torch, model, state) -> list:
    """The keys of ``state`` (the port's names) whose FP32 tensor in
    ``model`` differs from it in any bit."""
    bad = []
    for key, v in state.items():
        stem, attr = key.rsplit(".", 1)
        got = getattr(getattr(model, stem), attr)
        if not torch.equal(got, v.to(got.device)):
            bad.append(key)
    return bad


def hf_small_gates(torch, q, zoo, TD, LL, GM, kernel_fns, dev):
    """Phase 51: each family's HF directory (SMALL_DEC's widths, seeded
    weights; llama's index-sharded, OPT's ``pytorch_model.bin``) read by
    ``load_pretrained`` on the card: FP32 weights equal to a natively named
    twin load's bit for bit, then prepare / calibrate / convert and the
    model against a CPU copy of its state (``card_vs_cpu``: prefill codes,
    16 teacher-forced steps, greedy tokens, within the contract); the llama
    leg also under LLAMA_W4A8, where B6 and B7 must launch.  Returns the
    legs' launches."""
    from int8inferenceengine_tpu_torch.utils import hf
    ids = np.random.default_rng(5).integers(
        0, SMALL_DEC["vocab_size"], (SMALL_BATCH, SMALL_PROMPT)).astype(
            np.int32)
    legs, total = [], dict.fromkeys(kernel_fns, 0)
    with tempfile.TemporaryDirectory() as root:
        for model_type, cfg, twin, form, over in hf_small_legs(TD, LL, GM):
            state = hf_small_state(torch, model_type, twin)
            d = Path(root) / model_type
            nbytes = write_hf_dir(torch, d, cfg, [hf_export(
                model_type, state, SMALL_DEC["heads"])], form)
            qcfgs = {model_type: FAMILY_CFG}
            if model_type == "llama":
                qcfgs["llama_w4a8"] = LLAMA_W4A8
            for label, qcfg in qcfgs.items():
                reset_counts(kernel_fns)
                model = hf.load_pretrained(d, config=q.QuantConfig(**qcfg),
                                           **over)
                bad = fp32_mismatches(torch, model, state)
                if model.device.type != "cuda" or bad:
                    fail(f"{label} from its HF directory: on "
                         f"{model.device}, FP32 weights differ from the "
                         f"natively named load at {bad}")
                model.prepare()
                model(q.tensor(ids, device=dev))
                model.convert()
                cpu = hf.build_from_hf(cfg, config=model.config,
                                       device="cpu", **over)
                geo = hf.from_hf_config(cfg)[1] | over
                for r in card_vs_cpu(torch, zoo, model, None, geo, ids,
                                     SMALL_STEPS, f"hf_{label}", cpu=cpu):
                    legs.append(dict(r, form=form, dir_bytes=nbytes))
                counts = read_counts(kernel_fns)
                need = (("w4a8_v1_gemm", "w4a8_v2_gemm") if
                        label == "llama_w4a8" else ("qgemm_u8s8",))
                if not all(counts[k] for k in need):
                    fail(f"{label} from its HF directory launched {counts}")
                legs[-1]["launches"] = counts
                total = {k: total[k] + counts[k] for k in total}
                del model, cpu
    for r in legs:
        log(json.dumps(r))
    bad = [f"{r['family']} {r['leg']}" for r in legs if not r["ok"]]
    if bad:
        fail(f"HF-loaded decoders: card differs from a CPU copy beyond the "
             f"contract: {bad}")
    return total


def gemma2_hf_config() -> dict:
    """``google/gemma-2-2b``'s config.json: the keys ``from_hf_config``
    reads (GEMMA2's values) and the rest of the published ones."""
    g = GEMMA2
    return {"architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
            "vocab_size": g["vocab_size"],
            "max_position_embeddings": g["max_len"],
            "hidden_size": g["dim"], "num_hidden_layers": g["depth"],
            "num_attention_heads": g["heads"],
            "num_key_value_heads": g["kv_heads"], "head_dim": g["head_dim"],
            "intermediate_size": g["mlp_hidden"],
            "sliding_window": g["sliding_window"],
            "attn_logit_softcapping": g["attn_softcap"],
            "final_logit_softcapping": g["final_softcap"],
            "rms_norm_eps": g["eps"], "rope_theta": g["rope_base"],
            "hidden_act": "gelu_pytorch_tanh",
            "hidden_activation": "gelu_pytorch_tanh",
            "query_pre_attn_scalar": 256, "attention_bias": False,
            "attention_dropout": 0.0, "tie_word_embeddings": True,
            "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
            "initializer_range": 0.02, "cache_implementation": "hybrid",
            "torch_dtype": "float32"}


# phase 52's shards: the table and the final norm, then this many blocks a
# shard (311 MB a block in float32)
HF_BLOCKS_PER_SHARD = 6


def gemma_hf_leg(torch, q, GM, kernel_fns, dev, saved, ids):
    """Phase 52 on phase 26's converted gemma-2-2b (``saved``, calibrated on
    ``ids``): its FP32 weights, drawn again from its seed on the card
    (``gemma_state``, the head tied), exported as an HF directory
    (index-sharded safetensors, one shard on the host at a time, no
    ``lm_head``) and read by ``load_pretrained`` into a fresh model on the
    card: the config's window, softcaps and head_dim taken, every FP32
    weight equal bit for bit, and after the same calibration the 128 greedy
    tokens equal to ``saved``'s with 105 B1, 26 B2 and 26 B3 a step.
    Returns that ``generate()``'s launches."""
    from int8inferenceengine_tpu_torch.utils import hf
    tokens = saved.generate(ids, DEC_STEPS)
    prompt = torch.tensor(ids.astype(np.int64), device=dev)
    ms_saved, _ = time_captured_steps(torch, saved, prompt, 64)
    depth = GEMMA2["depth"]
    state = gemma_state(torch, twin_shapes(torch, GM, twin_kwargs(GEMMA2)),
                        depth, 0, dev, tied_head=True)
    block = {k: int(m.group(2)) for k in state
             if (m := _PORT_BLOCK.fullmatch(k.rsplit(".", 1)[0]))}
    groups = [[k for k in state if k not in block]]
    for lo in range(1, depth + 1, HF_BLOCKS_PER_SHARD):
        groups.append([k for k, i in block.items()
                       if lo <= i < lo + HF_BLOCKS_PER_SHARD])
    cfg = gemma2_hf_config()
    with tempfile.TemporaryDirectory() as root:
        d = Path(root) / "gemma-2-2b"
        t0 = time.perf_counter()
        nbytes = write_hf_dir(
            torch, d, cfg, (hf_export("gemma2", {k: state[k] for k in g},
                                      GEMMA2["heads"], derived=i == 0)
                            for i, g in enumerate(groups)),
            "sharded", n_parts=len(groups))
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = hf.load_pretrained(d, config=q.QuantConfig(**GEMMA_CFG))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    kw = hf.from_hf_config(cfg)[1]
    taken = (model.sliding_window, model.attn_softcap, model.final_softcap,
             model.head_dim)
    if kw != GEMMA2 or model.device.type != "cuda" or taken != tuple(
            GEMMA2[k] for k in ("sliding_window", "attn_softcap",
                                "final_softcap", "head_dim")):
        fail(f"gemma2_2b from its HF directory: config read as {kw}, model "
             f"window/softcaps/head_dim {taken} on {model.device}")
    bad = fp32_mismatches(torch, model, state)
    if bad:
        fail(f"gemma2_2b from its HF directory: FP32 weights differ from "
             f"phase 26's at {bad[:8]} ({len(bad)} of {len(state)})")
    n_weights = len(state)
    del state
    torch.cuda.empty_cache()
    model.prepare()
    model(q.tensor(ids, device=dev))
    model.convert()
    reset_counts(kernel_fns)
    got = model.generate(ids, DEC_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    per_step = dict.fromkeys(kernel_fns, 0) | {
        "qgemm_u8s8": 4 * depth + 1, "qgemm_u8s8_vzp": depth,
        "decode_attn_flat": depth}
    want = {k: v * DEC_STEPS - (depth if k == "decode_attn_flat" else 0)
            for k, v in per_step.items()}
    if counts != want:
        fail(f"gemma2_2b from its HF directory: generate launched {counts}, "
             f"want {want}")
    if not np.array_equal(got, tokens):
        fail("gemma2_2b from its HF directory: greedy tokens differ from "
             "phase 26's model's")
    ms_loaded, _ = time_captured_steps(torch, model, prompt, 64)
    log(json.dumps({"phase": "gemma2_2b_hf", "card": nvidia_smi(),
                    "dir_bytes": nbytes, "shards": len(groups),
                    "fp32_weights_equal": n_weights, "write_s": write_s,
                    "load_pretrained_s": load_s,
                    "load_GBps": nbytes / load_s / 1e9,
                    "launches": counts, "tokens_equal": DEC_STEPS,
                    "captured_ms_per_step_phase26": ms_saved,
                    "captured_ms_per_step_hf": ms_loaded}))
    del model
    torch.cuda.empty_cache()
    return counts


def hf_refusals(torch, q, TD, LL, GM):
    """Phase 53: what ``load_pretrained`` refuses, and bfloat16, on the
    card's machine: a bfloat16 ``pytorch_model.bin`` raises ``TypeError``
    (numpy has no bfloat16) and a bfloat16 safetensors file reads widened
    to float32, both as in the JAX package; a directory without weights,
    and one without ``config.json``, raise ``FileNotFoundError``; an
    unknown HF key raises ``KeyError``."""
    from safetensors.torch import save_file
    from int8inferenceengine_tpu_torch.utils import hf
    model_type, cfg, twin, _, _ = next(
        leg for leg in hf_small_legs(TD, LL, GM) if leg[0] == "llama")
    state = hf_small_state(torch, model_type, twin)
    export = hf_export(model_type, state, SMALL_DEC["heads"])
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in export.items()}
    seen = {}

    def expect(what, error, fn):
        try:
            fn()
        except error as e:
            seen[what] = f"{type(e).__name__}: {str(e)[:120]}"
            return
        fail(f"HF refusals: {what} did not raise {error.__name__}")

    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        write_hf_dir(torch, root / "bf16_bin", cfg, [bf16], "bin")
        expect("bfloat16 pytorch_model.bin", TypeError,
               lambda: hf.load_pretrained(root / "bf16_bin"))
        d = root / "bf16"
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        save_file(bf16, str(d / "model.safetensors"))
        m = hf.load_pretrained(d)
        want = bf16["model.layers.0.self_attn.q_proj.weight"].float()
        if m.device.type != "cuda" or not torch.equal(m.wq1.weight.cpu(),
                                                      want):
            fail("a bfloat16 safetensors file did not read widened to "
                 "float32 on the card")
        del m
        (root / "no_weights").mkdir()
        (root / "no_weights" / "config.json").write_text(json.dumps(cfg))
        expect("directory without weights", FileNotFoundError,
               lambda: hf.load_pretrained(root / "no_weights"))
        (root / "no_config").mkdir()
        expect("directory without config.json", FileNotFoundError,
               lambda: hf.load_pretrained(root / "no_config"))
        bogus = dict(export)
        bogus["model.layers.1.mlp.extra_proj.weight"] = np.zeros(
            (2, 2), np.float32)
        write_hf_dir(torch, root / "unknown_key", cfg, [bogus], "single")
        expect("unknown HF key", KeyError,
               lambda: hf.load_pretrained(root / "unknown_key"))
    log(json.dumps({"phase": "hf_refusals", "raised": seen,
                    "bfloat16_safetensors": "read, widened to float32"}))


def hf_paths(torch, q, zoo, TD, LL, GM, kernel_fns, dev):
    """``--hf``: phases 51-53, phase 52 on a model built as phase 26
    builds it (no twin check); returns the paths' launches."""
    counts = {"hf_small_gates": hf_small_gates(torch, q, zoo, TD, LL, GM,
                                               kernel_fns, dev)}
    mark("hf: small gates")
    ids = np.random.default_rng(0).integers(
        0, GEMMA2["vocab_size"], (DEC_BATCH, DEC_PROMPT)).astype(np.int32)
    model = build_gemma(torch, q, zoo, GM, GEMMA2, dev, calib=ids,
                        tied_head=True)
    counts["gemma2_2b_hf_generate"] = gemma_hf_leg(torch, q, GM, kernel_fns,
                                                   dev, model, ids)
    del model
    torch.cuda.empty_cache()
    mark("hf: gemma2_2b")
    hf_refusals(torch, q, TD, LL, GM)
    return counts


# -- phases 54-58: host ingest, the engine's ingest, xla_conv and the bfloat16
# epilogue, bfloat16 glue and the head-split decode attention ----------------

# the notebook's normalization (torchvision's ImageNet mean and std) of
# seeded u8 32 x 32 x 3 images (CIFAR-10's shape) resized to 224
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# phase 55: batches of 100 through the DataLoader (--ingest; the whole run
# takes the first WHOLE_INGEST_BATCHES), images of each checked on the CPU
INGEST_BATCHES, WHOLE_INGEST_BATCHES, INGEST_CPU_IMAGES = 20, 3, 8
# phase 56: requests of 1-16 images from 8 threads, tiles of 32 and 100
ENGINE_REQUESTS, ENGINE_THREADS, ENGINE_TILES = 200, 8, (32, 100)
# phase 58: the head-split decode attention at gpt2's (12 x 64) and llama
# GQA's (12 over 2) decode shapes, batch 8, T = 512, live 128 and a vector
HEADSPLIT_CASES = [(12, 12), (12, 2)]
# phase 58: the largest distance, in codes, of a bfloat16 glue layer from
# the float32 glue on the same input (the JAX package's own bfloat16 glue
# on EfficientNet-B0's squeeze-excite sigmoids)
GLUE_BF16_CODES = 3


def native_host_ops(torch, timing=True):
    """Phase 54: the port's native library builds on this machine and each
    entry point equals its numpy twin under ``tests/test_hostops.py``'s
    tolerance; with ``timing`` (``--ingest``), host ms of each op at the
    AlexNet-224 b100 ingest shapes."""
    import os
    from int8inferenceengine_tpu_torch import native
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    if not native.available():
        try:
            native.load()
        except RuntimeError as e:
            fail(f"the native host ops do not build: {e}")
    build_s = time.perf_counter() - t0
    if torch.get_num_threads() != threads:
        fail(f"loading the native library changed torch's threads "
             f"{threads} -> {torch.get_num_threads()}")
    rng = np.random.default_rng(54)
    img = rng.integers(0, 256, (100, 32, 32, 3), dtype=np.uint8)
    x = rng.uniform(-5, 5, (100, 3, 224, 224)).astype(np.float32)
    mean, std = np.float32(IMAGENET_MEAN), np.float32(IMAGENET_STD)
    big = native.resize_bilinear(img, 224, 224)
    q = native.quantize_u8(x, 0.025, 127)
    # (entry point, its twin, tolerance: 'exact', an absolute bound, or
    # 'rtol' 1e-6)
    checks = {
        "quantize_u8": (q, native.quantize_u8_plain(x, 0.025, 127), 0),
        "dequantize_u8": (native.dequantize_u8(q, 0.1, 90),
                          native.dequantize_u8_plain(q, 0.1, 90), "rtol"),
        "normalize_nchw": (native.normalize_nchw(big, mean, std),
                           native.normalize_nchw_plain(big, mean, std), 1e-5),
        "resize_bilinear": (big, native.resize_bilinear_plain(img, 224, 224),
                            1),
        "preprocess_quantize": (
            native.preprocess_quantize(big, mean, std, 0.025, 127),
            native.preprocess_quantize_plain(big, mean, std, 0.025, 127), 1),
        "s2d_quantized": (native.s2d_quantized(q, 11, 4, 2, 127),
                          native.s2d_quantized_plain(q, 11, 4, 2, 127), 0),
    }
    gaps = {}
    for name, (got, want, tol) in checks.items():
        if got.shape != want.shape:
            fail(f"native {name}: shape {got.shape} != {want.shape}")
        gap = float(np.abs(got.astype(np.float64)
                           - want.astype(np.float64)).max())
        ok = (np.allclose(got, want, rtol=1e-6, atol=0) if tol == "rtol"
              else gap <= tol)
        if not ok:
            fail(f"native {name} differs from its numpy twin by {gap} "
                 f"(tolerance {tol})")
        gaps[name] = gap

    def host_ms(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    if not timing:
        log(json.dumps({"phase": "native_host_ops", "available": True,
                        "build_or_load_s": build_s,
                        "cpu_count": os.cpu_count(), "torch_threads": threads,
                        "library": str(native.library_path().name),
                        "max_gap_vs_numpy_twin": gaps}))
        return None
    pq = native.preprocess_quantize(big, mean, std, 0.025, 127)
    ms = {"resize_bilinear_32_to_224": host_ms(
              lambda: native.resize_bilinear(img, 224, 224)),
          "preprocess_quantize_224": host_ms(
              lambda: native.preprocess_quantize(big, mean, std, 0.025, 127)),
          "s2d_quantized_alexnet_conv1": host_ms(
              lambda: native.s2d_quantized(pq, 11, 4, 2, 127)),
          "quantize_u8_224": host_ms(
              lambda: native.quantize_u8(x, 0.025, 127))}
    log(json.dumps({"phase": "native_host_ops", "available": True,
                    "build_or_load_s": build_s, "cpu_count": os.cpu_count(),
                    "torch_threads": threads,
                    "library": str(native.library_path().name),
                    "max_gap_vs_numpy_twin": gaps,
                    "host_ms_batch100": ms}))
    return ms


def conv1_recorder(C):
    """A stand-in for ``ops/conv.qgemm_conv`` that records each launch's
    (input shape, window, stride) and runs the kernel."""
    seen = []
    orig = C.qgemm_conv

    def recording(x, *args, **kw):
        seen.append((tuple(x.shape), kw["kh"], kw["stride"]))
        return orig(x, *args, **kw)
    return recording, seen


def alexnet_ingest(torch, q, zoo, C, model, kernel_fns, batches, smi):
    """Phase 55: seeded u8 32 x 32 images through ``DataLoader(resize_to=
    224, quantize_to=the model's input grid, layout_for=model)`` into the
    converted AlexNet-224 at batch 100.  Every batch's logits equal the
    same host-quantized batch fed without the pre-layout and the CPU copy's
    on the pre-laid-out batch (its first INGEST_CPU_IMAGES images); conv1
    runs as B1's gathered conv over 48 channels, once a batch.  Times: host
    ms a batch, card ms a batch, the loader's images/s alone and pipelined
    with the forward, and the card's idle share over the pipelined run.
    Returns the launches of the loader-fed forwards."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    n = 100
    rng = np.random.default_rng(55)
    imgs = rng.integers(0, 256, (batches * n, 32, 32, 3), dtype=np.uint8)
    grid = (model.config.input_scale, model.config.input_zero_point)
    tag = model.ingest_descriptor()
    if tag != ("s2d", 11, 4, 2, 3):
        fail(f"AlexNet's ingest tag is {tag}")
    kw = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, resize_to=(224, 224),
              quantize_to=grid)
    cpu = zoo.AlexNet(device="cpu")
    load_jax_state(cpu, export_state(model))
    recording, seen = conv1_recorder(C)
    outs = []
    reset_counts(kernel_fns)
    with swapped(C, qgemm_conv=recording):
        for batch in q.DataLoader(imgs, n, layout_for=model, **kw):
            if tuple(batch.data.shape) != (n, 57, 57, 48):
                fail(f"pre-laid-out batch {tuple(batch.data.shape)}")
            outs.append((batch, model(batch).data))
        torch.cuda.synchronize()
    counts = read_counts(kernel_fns)
    want = dict.fromkeys(kernel_fns, 0) | {"qgemm_u8s8": 8 * batches}
    if counts != want:
        fail(f"AlexNet ingest forwards launched {counts}, want {want}")
    conv1 = [s for s in seen if s[0][-1] == 48]
    if conv1 != [((n, 57, 57, 48), 3, 1)] * batches:
        fail(f"conv1 did not run as B1's gathered 3 x 3 / 1 conv over 48 "
             f"channels once a batch: {seen[:9]}")
    plain = q.DataLoader(imgs, n, **kw)
    for i, ((batch, got), ref) in enumerate(zip(outs, plain)):
        if not torch.equal(got, model(ref).data):
            fail(f"ingest batch {i}: logits differ from the batch fed "
                 f"without the pre-layout")
        c = INGEST_CPU_IMAGES
        cpu_out = cpu(Tensor(batch.data[:c].cpu(), batch.scale,
                             batch.zero_point, _ingest=tag)).data
        if not torch.equal(got[:c].cpu(), cpu_out):
            fail(f"ingest batch {i}: logits differ from the CPU copy's")
    log(json.dumps({"phase": "alexnet_ingest_codes", "batches": batches,
                    "equal_to_no_prelayout": True,
                    "equal_to_cpu_copy_images": INGEST_CPU_IMAGES,
                    "conv1": {"input": [n, 57, 57, 48], "window": 3,
                              "stride": 1, "launches": len(conv1)},
                    "launches": counts}))

    # -- times (not gated)
    loader = q.DataLoader(imgs, n, layout_for=model, **kw)
    chunk = imgs[:n]
    loader.prepare(chunk)
    t0 = time.perf_counter()
    for i in range(batches):
        loader.prepare(imgs[i * n:(i + 1) * n])
    host_ms = 1e3 * (time.perf_counter() - t0) / batches
    batch, _ = outs[0]
    no_pre = next(iter(plain))
    card_ms = time_cuda(torch, lambda: model(batch), iters=20)
    no_pre_ms = time_cuda(torch, lambda: model(no_pre), iters=20)
    xf = q.tensor(np.zeros((n, 3, 224, 224), np.float32))
    float_ms = time_cuda(torch, lambda: model(xf), iters=20)

    conv1 = conv1_launch_times(torch, C, model, batch, no_pre)

    def drain(fn):
        t0 = time.perf_counter()
        for b in loader:
            fn(b)
        torch.cuda.synchronize()
        return batches * n / (time.perf_counter() - t0)

    drain(lambda b: None)
    alone = drain(lambda b: None)
    drain(model)
    pipelined = drain(model)
    rows, wall_us = profiled(torch, lambda: drain(model), reps=1,
                             warm=lambda: model(batch))
    busy_us = sum(e.self_device_time_total for e in rows
                  if "emcpy" not in e.key and "emset" not in e.key)
    copy_us = sum(e.self_device_time_total for e in rows
                  if "emcpy" in e.key)
    log(json.dumps({
        "phase": "alexnet_ingest_times", "card": smi, "batch": n,
        "batches": batches,
        "host_ms_per_batch_resize_quantize_s2d": host_ms,
        "card_ms_per_batch_prelaid": card_ms,
        "card_ms_per_batch_u8_no_prelayout": no_pre_ms,
        "card_ms_per_batch_float_input": float_ms,
        "loader_images_per_s_alone": alone,
        "loader_images_per_s_pipelined_with_forward": pipelined,
        "pipelined_wall_ms": wall_us / 1e3,
        "pipelined_kernel_busy_ms": busy_us / 1e3,
        "pipelined_copy_ms": copy_us / 1e3,
        "card_idle_share_pipelined": 1 - busy_us / wall_us,
        "conv1_launch": conv1,
        "bytes_to_card_per_batch": {"prelaid_u8": n * 57 * 57 * 48,
                                    "float32_nchw": n * 3 * 224 * 224 * 4}}))
    return counts


def conv1_launch_times(torch, C, model, pre, plain):
    """AlexNet conv1's B1 launch (L2 flushed) on the pre-laid-out batch
    (3 x 3 / 1 over 57 x 57 x 48, K 432) beside the 11 x 11 / 4 launch on
    the same images' u8 NHWC codes (K 363, 3 channels padded to 4), each
    with its bound."""
    layer = model.conv1
    oc, ep = layer._epilogue(pre, layer._order())
    kw = dict(scale_a=pre.scale, zp_a=pre.zero_point, scale_c=layer.scale,
              zp_c=layer.zero_point, relu=layer.fuse_relu,
              rounding=layer.config.rounding, order=layer._order())
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=pre.device)
    x11 = plain.data.permute(0, 2, 3, 1).contiguous()
    out = {}
    for label, x, w, k, s, p in (
            ("prelaid_3x3s1_c48", pre.data, layer._s2d_qw(), 3, 1, 0),
            ("nhwc_11x11s4_c3", x11, layer.qw, 11, 4, 2)):
        ms = time_cuda(torch, lambda: C.qgemm_conv(
            x, w, oc, ep, kh=k, kw=k, stride=s, padding=p, **kw), iters=20,
            flush=flush_buf.zero_)
        b, h, wd, c = x.shape
        bound_ms, bound_by, _, _ = conv_bound_ms((b, h, wd, c, k, s, p),
                                                 layer.out_channels)
        out[label] = {"ms": ms, "input": [b, h, wd, c], "window": k,
                      "stride": s, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    del flush_buf
    return out


def engine_ingest(torch, q, model, label, tag, smi):
    """Phase 56: ``InferenceEngine(quantize_ingest=True)`` (tiles of 32 and
    100) against the float engine on one model: ENGINE_REQUESTS requests of
    1-16 images from ENGINE_THREADS threads each, every result equal to
    ``model(...)`` on the same images bit for bit, the tiles replayed as
    captured graphs; images/s and the staged bytes a tile of both."""
    from int8inferenceengine_tpu_torch.serve import InferenceEngine
    if model.ingest_descriptor() != tag:
        fail(f"{label}: ingest tag {model.ingest_descriptor()} != {tag}")
    rng = np.random.default_rng(56)
    xs = [rng.standard_normal((int(rng.integers(1, 17)), 3, 224, 224))
          .astype(np.float32) for _ in range(ENGINE_REQUESTS)]
    want = [model(q.tensor(x)).numpy() for x in xs]
    report = {}
    for ingest in (False, True):
        eng = InferenceEngine(model, batch_sizes=ENGINE_TILES,
                              quantize_ingest=ingest)
        try:
            got = [None] * len(xs)

            def client(i0):
                futs = [(i, eng.submit(xs[i]))
                        for i in range(i0, len(xs), ENGINE_THREADS)]
                for i, f in futs:
                    got[i] = f.result(timeout=600)

            for rep in range(2):          # the first round captures
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(ENGINE_THREADS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                rate = sum(x.shape[0] for x in xs) / (
                    time.perf_counter() - t0)
                bad = [i for i, (g, w) in enumerate(zip(got, want))
                       if g is None or not np.array_equal(g, w)]
                if bad:
                    fail(f"{label} engine (quantize_ingest={ingest}): "
                         f"{len(bad)} requests differ from model(...)")
            fwds = dict(eng._forwards)
            replays = {str(k[0][0]): f.forward.replays
                       for k, f in fwds.items()}
            if not all(replays.values()):
                fail(f"{label} engine: a tile never replayed {replays}")
            big = [f for k, f in fwds.items() if k[0][0] == max(ENGINE_TILES)]
            report["ingest" if ingest else "float"] = {
                "images_per_s": rate, "replays_by_tile": replays,
                "static_input": list(big[0].x.shape) if big else None,
                "staged_bytes_per_tile_100": (big[0].stage[0].numel()
                                              * big[0].stage[0].element_size()
                                              if big else None),
                "steps": eng.stats.steps,
                "latency_ms": eng.stats.latency_percentiles()}
        finally:
            eng.shutdown()
    log(json.dumps({"phase": f"{label}_engine_ingest", "card": smi,
                    "tag": list(tag), "requests": ENGINE_REQUESTS,
                    "threads": ENGINE_THREADS, "tiles": list(ENGINE_TILES),
                    "equal_to_model": True, **report}))


def check_bf16_epilogue_kernels(torch, q, zoo, G, C, gen, dev):
    """Phase 57's kernel checks: B1's gathered conv under the bfloat16
    epilogue at AlexNet-224 b100's five conv geometries and the
    pre-laid-out conv1 (57 x 57 x 48, 3 x 3 / 1), and G1's at every grouped
    shape of MobileNetV2 (batch 8), against their plain versions bit for
    bit: per-channel s_w, 'trunc' with relu and 'nearest' without."""
    outs = {"conv1": 96, "conv2": 256, "conv3": 384, "conv4": 384,
            "conv5": 256}
    geoms = [(g, outs[name]) for name, g in ALEXNET_CONVS.items()] + [
        ((100, 57, 57, 48, 3, 1, 0), 96)]
    n_cases = 0
    for geom, n in geoms:
        x, cs = conv_case(torch, gen, geom, n, dev)
        oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]),
                              cs["s_a"], cs["zp_a"], recentered=True)
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], n, dev,
                               "conv_bf16")
        for rounding, relu in (("trunc", True), ("nearest", False)):
            kw = dict(kh=geom[4], kw=geom[4], stride=geom[5],
                      padding=geom[6], zp_a=cs["zp_a"], scale_a=cs["s_a"],
                      scale_c=cs["s_c"], zp_c=cs["zp_c"], relu=relu,
                      rounding=rounding, order="conv_bf16")
            before = G.qgemm.launches
            got = C.qgemm_conv(x, cs["w"], oc, ep, **kw)
            launched = G.qgemm.launches - before
            want = C.conv2d_int8_gemm(x, cs["w"], oc, ep, gemm=G.qgemm_plain,
                                      **kw)
            torch.cuda.synchronize()
            n_cases += 1
            if launched != 1 or not torch.equal(got, want):
                fail(f"B1 bf16 epilogue != plain at {tuple(geom)} N={n} "
                     f"{rounding}: {int((got != want).sum())} codes differ")
        del x, cs
    shapes = grouped_shapes(torch, q, zoo, ("mobilenet_v2",), dev)
    for shape, (first, _) in shapes.items():
        x, cs = grouped_operands(torch, G, gen, G1_CHECK_BATCH, shape, dev)
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], shape[3],
                               dev, "conv_bf16")
        for rounding, relu in (("trunc", True), ("nearest", False)):
            kw = grouped_kw(cs, shape, rounding, relu)
            got = C.conv2d_int8_grouped(x, cs["w"], cs["oc"], ep,
                                        order="conv_bf16", **kw)
            want = C.conv2d_int8_grouped_plain(x, cs["w"], cs["oc"], ep,
                                               order="conv_bf16", **kw)
            torch.cuda.synchronize()
            n_cases += 1
            if not torch.equal(got, want):
                fail(f"G1 bf16 epilogue != plain at {shape} ({first}) "
                     f"{rounding}: {int((got != want).sum())} codes differ")
    log(json.dumps({"phase": "bf16_epilogue_kernels_vs_plain",
                    "b1_geometries": len(geoms), "g1_shapes": len(shapes),
                    "cases": n_cases, "max_abs_err": 0}))


def bf16_instance_times(torch, G, C, gen, dev, smi):
    """Phase 57's kernel times (L2 flushed): B1's gathered conv at AlexNet
    conv2 and G1 at MobileNetV2's widest depthwise conv (112 x 112 x 96,
    stride 2, batch 100), each under the float32 and the bfloat16 conv
    epilogue, with its bound."""
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    geom, n = ALEXNET_CONVS["conv2"], 256
    x, cs = conv_case(torch, gen, geom, n, dev)
    oc = G.compute_offset(cs["q_bias"], rowsum(torch, cs["w"]), cs["s_a"],
                          cs["zp_a"], recentered=True)
    for order in ("conv", "conv_bf16"):
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], n, dev,
                               order)
        rows[f"b1_alexnet_conv2_{order}"] = time_cuda(
            torch, lambda: C.qgemm_conv(
                x, cs["w"], oc, ep, kh=5, kw=5, stride=1, padding=2,
                zp_a=cs["zp_a"], scale_a=cs["s_a"], scale_c=cs["s_c"],
                zp_c=cs["zp_c"], relu=True, order=order), iters=20,
            flush=flush_buf.zero_)
    rows["b1_alexnet_conv2_bound_ms"] = conv_bound_ms(geom, n)[0]
    shape = (112, 112, 96, 96, 96, 3, 2)
    x, cs = grouped_operands(torch, G, gen, 100, shape, dev)
    for order in ("conv", "conv_bf16"):
        ep = G.epilogue_vector(cs["s_a"], cs["s_w_pc"], cs["s_c"], 96, dev,
                               order)
        rows[f"g1_mnv2_112x96_s2_{order}"] = time_cuda(
            torch, lambda: C.conv2d_int8_grouped(
                x, cs["w"], cs["oc"], ep, order=order,
                **grouped_kw(cs, shape, relu=True)), iters=20,
            flush=flush_buf.zero_)
    rows["g1_mnv2_112x96_s2_bound_ms"] = g1_bound_ms(100, shape)[0]
    del flush_buf
    log(json.dumps({"phase": "bf16_epilogue_instance_times", "card": smi,
                    "ms": rows}))


def exact_launches(torch, G, C):
    """Stand-ins for ``qgemm_conv`` and ``conv2d_int8_grouped`` that hold
    each launch of a forward against its plain version on the same
    operands (the same accumulators), bit for bit; returns them and the
    count of launches checked."""
    checked = {"b1": 0, "g1": 0}
    b1, g1 = C.qgemm_conv, C.conv2d_int8_grouped

    def b1_checked(x, w, oc, ep, **kw):
        got = b1(x, w, oc, ep, **kw)
        want = C.conv2d_int8_gemm(x, w, oc, ep, gemm=G.qgemm_plain, **kw)
        if not torch.equal(got, want):
            fail(f"B1 ({kw.get('order')}) != plain in a forward at "
                 f"{tuple(x.shape)}")
        checked["b1"] += 1
        return got

    def g1_checked(x, w, oc, ep, **kw):
        got = g1(x, w, oc, ep, **kw)
        want = C.conv2d_int8_grouped_plain(x, w, oc, ep, **kw)
        if not torch.equal(got, want):
            fail(f"G1 ({kw.get('order')}) != plain in a forward at "
                 f"{tuple(x.shape)}")
        checked["g1"] += 1
        return got
    return b1_checked, g1_checked, checked


def with_config(q, zoo, model, name, **cfg):
    """A fresh ``name`` on the card under ``model``'s config with ``cfg``
    changed, holding ``model``'s converted state."""
    import dataclasses
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    m = zoo.build(name, config=dataclasses.replace(model.config, **cfg),
                  device="cuda")
    load_jax_state(m, export_state(model))
    return m


def logit_codes(torch, out, layer):
    return torch.round(out / layer.scale).to(torch.int64)


def xla_conv_and_bf16(torch, q, zoo, G, C, model, mnv2, x_alex, x_mnv2,
                      smi):
    """Phase 57: AlexNet-224 b100 under ``conv_backend='xla_conv'`` (another
    name for 'auto') gives 'auto''s codes through as many B1 launches; under
    ``epilogue_dtype='bfloat16'`` AlexNet-224 b100 (B1's instance) and
    MobileNetV2-224 b100 (B1's and G1's) hold every launch of a forward
    against its plain version on the same operands, bit for bit, and a CPU
    copy's codes; the share of output codes that differ from the float32
    epilogue and the largest difference; ms a batch of each."""
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    xa = q.tensor(x_alex)
    auto = model(xa).data
    xla = with_config(q, zoo, model, "alexnet", conv_backend="xla_conv")
    before = G.qgemm.launches
    got = xla(xa).data
    torch.cuda.synchronize()
    b1 = G.qgemm.launches - before
    want_b1, _ = launches_per_forward(q, xla)
    if not torch.equal(got, auto) or b1 != want_b1:
        fail(f"AlexNet under xla_conv: equal={torch.equal(got, auto)}, "
             f"{b1} B1 launches (want {want_b1})")
    res = {"alexnet_xla_conv": {
        "equal_to_auto": True, "b1_launches": b1,
        "ms_per_batch": time_cuda(torch, lambda: xla(xa), iters=20),
        "auto_ms_per_batch": time_cuda(torch, lambda: model(xa), iters=20)}}
    del xla
    for name, m32, x in (("alexnet", model, x_alex),
                         ("mobilenet_v2", mnv2, x_mnv2)):
        xt = q.tensor(x)
        m16 = with_config(q, zoo, m32, name, epilogue_dtype="bfloat16")
        b1c, g1c, checked = exact_launches(torch, G, C)
        with swapped(C, qgemm_conv=b1c, conv2d_int8_grouped=g1c):
            out16 = m16(xt).data
            torch.cuda.synchronize()
        out32 = m32(xt).data
        cpu = zoo.build(name, config=m16.config, device="cpu")
        load_jax_state(cpu, export_state(m16))
        out_cpu = cpu(q.tensor(x[:CNN_CPU_BATCH], device="cpu")).data
        if not torch.equal(out16[:CNN_CPU_BATCH].cpu(), out_cpu):
            fail(f"{name} bf16 epilogue: card codes differ from the CPU "
                 f"copy's")
        head = list(m16.named_layers())[-1][1]
        c16 = logit_codes(torch, out16, head)
        c32 = logit_codes(torch, out32, head)
        gap = (c16 - c32).abs()
        _, g1 = launches_per_forward(q, m16)
        if checked["b1"] != sum(isinstance(l, q.Conv2d) and l.groups == 1
                                for _, l in m16.named_layers()) \
                or checked["g1"] != g1:
            fail(f"{name} bf16: checked launches {checked}")
        res[f"{name}_bf16_epilogue"] = {
            "conv_launches_checked_exact": checked,
            "cpu_copy_equal_images": CNN_CPU_BATCH,
            "output_codes_differ_share_vs_f32": float(
                (gap > 0).float().mean()),
            "output_codes_max_diff_vs_f32": int(gap.max()),
            "top1_agreement_vs_f32": float(
                (out16.argmax(1) == out32.argmax(1)).float().mean()),
            "ms_per_batch": time_cuda(torch, lambda: m16(xt), iters=20),
            "f32_epilogue_ms_per_batch": time_cuda(torch, lambda: m32(xt),
                                                   iters=20)}
        del m16, cpu
    log(json.dumps({"phase": "xla_conv_and_bf16_epilogue", "card": smi,
                    **res}))


def glue_hooks(model, kinds):
    """{layer name: [args, output]} of ``kinds`` layers, filled by forward
    hooks while a forward runs; and the hooks."""
    seen, hooks = {}, []
    for name, layer in model.named_layers():
        if isinstance(layer, kinds):
            hooks.append(layer.register_forward_hook(
                lambda mod, args, out, name=name: seen.__setitem__(
                    name, (args, out))))
    return seen, hooks


def bf16_glue(torch, q, zoo, model, x, smi):
    """Phase 58 (a): EfficientNet-B0-224 b100 under ``glue_dtype=
    'bfloat16'``: codes equal a CPU copy's; every glue layer (QuantAct,
    QuantAdd, QuantMul, QuantConcat), fed the float32-glue model's input to
    it, equal on its first INGEST_CPU_IMAGES images to the CPU copy's same
    layer on the same input, and within GLUE_BF16_CODES of the float32
    glue's output on the same input: the JAX package's own bfloat16 glue is
    3 codes from its float32 glue at this model's squeeze-excite sigmoids,
    where the port's equals it exactly
    (``tests/test_torch_lifecycle_dtypes.py``), so that is the bound here
    rather than ``tests/test_glue_dtype.py``'s 2 codes; ms a batch of both
    glue dtypes."""
    from int8inferenceengine_tpu_torch import layers as L
    from int8inferenceengine_tpu_torch.carry import (export_state,
                                                     load_jax_state)
    from int8inferenceengine_tpu_torch.tensor import Tensor
    kinds = (L.QuantAct, L.QuantAdd, L.QuantMul, L.QuantConcat)
    xt = q.tensor(x)
    m16 = with_config(q, zoo, model, "efficientnet_b0",
                      glue_dtype="bfloat16")
    out16 = m16(xt).data
    cpu = zoo.build("efficientnet_b0", config=m16.config, device="cpu")
    load_jax_state(cpu, export_state(m16))
    if not torch.equal(out16[:CNN_CPU_BATCH].cpu(), cpu(q.tensor(
            x[:CNN_CPU_BATCH], device="cpu")).data):
        fail("EfficientNet-B0 bf16 glue: card codes differ from the CPU "
             "copy's")
    seen, hooks = glue_hooks(model, kinds)
    try:
        model(xt)
    finally:
        for h in hooks:
            h.remove()
    layers16, cpu16 = dict(m16.named_layers()), dict(cpu.named_layers())
    worst, share, gaps = 0, [], {}
    c = INGEST_CPU_IMAGES
    for name, (args, out) in seen.items():
        got = layers16[name](*args)
        d = (got.data.to(torch.int32) - out.data.to(torch.int32)).abs()
        gaps[int(d.max())] = gaps.get(int(d.max()), 0) + 1
        worst = max(worst, int(d.max()))
        if int(d.max()) > GLUE_BF16_CODES:
            fail(f"EfficientNet-B0 bf16 glue: layer {name} is {int(d.max())} "
                 f"codes from the float32 glue's (bound {GLUE_BF16_CODES})")
        share.append(float((d > 0).float().mean()))
        want = cpu16[name](*[Tensor(a.data[:c].cpu(), a.scale, a.zero_point,
                                    _nhwc=a._nhwc) for a in args])
        if not torch.equal(got.data[:c].cpu(), want.data):
            fail(f"EfficientNet-B0 bf16 glue: layer {name} on the card "
                 f"differs from the CPU copy's on the same input")
    log(json.dumps({
        "phase": "efficientnet_b0_bf16_glue", "card": smi,
        "cpu_copy_equal_images": CNN_CPU_BATCH, "glue_layers": len(seen),
        "layers_equal_to_cpu_copy": len(seen),
        "max_code_diff_per_layer_vs_f32": worst,
        "bound_codes_vs_f32": GLUE_BF16_CODES,
        "layers_by_max_code_diff_vs_f32": gaps,
        "mean_share_differing": float(np.mean(share)),
        "ms_per_batch_bf16_glue": time_cuda(torch, lambda: m16(xt), iters=20),
        "ms_per_batch_f32_glue": time_cuda(torch, lambda: model(xt),
                                           iters=20)}))


def headsplit_attention(torch, A, gen, dev):
    """Phase 58 (b): the head-split ``decode_attention`` at gpt2's and
    llama GQA's decode shapes (batch 8, T = 512, D = 64) equals
    ``decode_attention_flat`` on the same operands and launches B3."""
    b, t, d = 8, 512, 64
    for h, hkv in HEADSPLIT_CASES:
        q4 = torch.randint(0, 256, (b, h, 1, d), generator=gen,
                           dtype=torch.uint8, device=dev)
        k4 = torch.randint(0, 256, (b, hkv, t, d), generator=gen,
                           dtype=torch.uint8, device=dev)
        v4 = torch.randint(0, 256, (b, hkv, t, d), generator=gen,
                           dtype=torch.uint8, device=dev)
        for valid in (128, torch.arange(1, 2 * b, 2, device=dev,
                                        dtype=torch.int32) * 31):
            before = A.decode_attention_flat.launches
            got = A.decode_attention(q4, k4, v4, valid, **ATTN_PARAMS)
            launched = A.decode_attention_flat.launches - before
            want = A.decode_attention_flat(
                q4.reshape(b, h * d), k4.permute(0, 2, 1, 3).reshape(
                    b, t, hkv * d).contiguous(),
                v4.permute(0, 2, 1, 3).reshape(b, t, hkv * d).contiguous(),
                valid, n_heads=h, n_kv_heads=hkv, **ATTN_PARAMS)
            torch.cuda.synchronize()
            if launched != 1 or not torch.equal(got.reshape(b, h * d),
                                                want):
                fail(f"head-split decode_attention {h}/{hkv}: "
                     f"{launched} launches, equal="
                     f"{torch.equal(got.reshape(b, h * d), want)}")
    log(json.dumps({"phase": "headsplit_decode_attention",
                    "cases": [list(c) for c in HEADSPLIT_CASES],
                    "batch": b, "T": t, "equal_to_flat": True,
                    "b3_launches_each": 1}))


def ingest_paths(torch, q, zoo, G, C, A, kernel_fns, dev, smi):
    """Phases 54-58 in full (``--ingest``)."""
    counts = {}
    native_host_ops(torch)
    mark("ingest: native host ops")
    gen = torch.Generator(device=dev).manual_seed(57)
    check_bf16_epilogue_kernels(torch, q, zoo, G, C, gen, dev)
    bf16_instance_times(torch, G, C, gen, dev, smi)
    headsplit_attention(torch, A, gen, dev)
    mark("ingest: kernel checks")
    model, x_alex, _, _ = alexnet_main_path(torch, q, zoo, kernel_fns, dev)
    counts["alexnet_ingest"] = alexnet_ingest(
        torch, q, zoo, C, model, kernel_fns, INGEST_BATCHES, smi)
    mark("ingest: alexnet dataloader")
    engine_ingest(torch, q, model, "alexnet", ("s2d", 11, 4, 2, 3), smi)
    r18 = cnn_main_path(torch, q, zoo, kernel_fns, dev, "resnet18")[0]
    engine_ingest(torch, q, r18, "resnet18", ("s2d", 7, 2, 3, 3), smi)
    del r18
    mark("ingest: engines")
    mnv2, x_mnv2, _, _ = cnn_main_path(torch, q, zoo, kernel_fns, dev,
                                       "mobilenet_v2")
    xla_conv_and_bf16(torch, q, zoo, G, C, model, mnv2, x_alex, x_mnv2, smi)
    del mnv2
    torch.cuda.empty_cache()
    mark("ingest: xla_conv, bf16 epilogue")
    eff, x_eff, _, _ = cnn_main_path(torch, q, zoo, kernel_fns, dev,
                                     "efficientnet_b0")
    bf16_glue(torch, q, zoo, eff, x_eff, smi)
    del eff
    torch.cuda.empty_cache()
    mark("ingest: bf16 glue")
    return counts


def kernels_line(rows, counts_by_path, max_err):
    """One entry per kernel.  ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are sums over the ``work`` named in the entry: every
    launch of one AlexNet b100 forward and of one decode step, at their
    shapes.  ``launches`` adds each path's counts, read just after the
    path ran with the counts set to 0 just before it: the wrappers' eager
    launches and, for every replay of a captured graph, the kernels that
    its capture recorded (``graphs.Captured``)."""
    out = []
    for name, info in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == name]
        tot = {key: sum(r[key] * r["launches_per_unit"] for r in mine)
               for key in ("ms", "plain_ms", "bound_ms", "t_ops", "t_bytes")}
        libs = [r["library_ms"] for r in mine]
        paths = sorted({r["path"] for r in mine})
        out.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"],
            **{k: v for k, v in info.items()
               if k not in ("source", "replaces")},
            launches=sum(c[name] for c in counts_by_path.values()),
            launches_by_path={p: c[name] for p, c in counts_by_path.items()},
            max_abs_err=max_err[name], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["t_bytes"] >= tot["t_ops"]
                      else "operations"),
            library_ms=(None if any(x is None for x in libs) else
                        sum(r["library_ms"] * r["launches_per_unit"]
                            for r in mine)),
            **({key: sum(r[key] * r["launches_per_unit"] for r in mine)
                for key in ("bound_f32_simt_ms", "bound_im2col_ms")
                if all(key in r for r in mine)}),
            work=" + ".join(f"one {p.replace('_', ' ')}" for p in paths)))
    return out


def reset_counts(kernel_fns):
    """Zero the kernel wrappers' launch counts (and the library routes'
    call counts)."""
    for fn in kernel_fns.values():
        for attr in ("launches", "merged_launches", "calls"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counts(kernel_fns):
    return {name: fn.launches if hasattr(fn, "launches") else fn.calls
            for name, fn in kernel_fns.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler breakdowns of the AlexNet "
                         "forwards and of decode steps")
    ap.add_argument("--sweep", action="store_true",
                    help="only build and time B1/B2, B6 and B3 under every "
                         "candidate plan at the main paths' shapes (no "
                         "checks, no result line)")
    ap.add_argument("--windowed", action="store_true",
                    help="only build and run the windowed decoders' phases "
                         "(24-28) with their kernel checks and times (no "
                         "result line)")
    ap.add_argument("--weight-only", action="store_true",
                    help="only build and run the weight modes' phases "
                         "(29-33) with their checks and times (no result "
                         "line)")
    ap.add_argument("--families", action="store_true",
                    help="only build and run the other decoder families' "
                         "phases (34-38) with their checks and times (no "
                         "result line)")
    ap.add_argument("--encoders", action="store_true",
                    help="only build and run the encoders' and the "
                         "lifecycle levers' phases (39-43) with their "
                         "checks and times (no result line)")
    ap.add_argument("--levers", action="store_true",
                    help="only build and run the accuracy levers' phases "
                         "(44-47: CLE, SmoothQuant, AdaRound, GPTQ) with "
                         "their checks (no result line)")
    ap.add_argument("--artifact", action="store_true",
                    help="only build and run the INT8 artifact's phases "
                         "(48-50: save, load, validate, report, roofline, "
                         "trace) with their checks (no result line)")
    ap.add_argument("--ingest", action="store_true",
                    help="only build and run the host ingest phases (54-58: "
                         "native host ops, AlexNet fed by the DataLoader, "
                         "the engines' quantize_ingest, xla_conv and the "
                         "bf16 epilogue, bf16 glue and the head-split "
                         "decode attention) in full (no result line)")
    ap.add_argument("--hf", action="store_true",
                    help="only build and run the HF checkpoint phases "
                         "(51-53: every family's HF directory, gemma-2-2b "
                         "from an HF directory, the refusals) with their "
                         "checks (no result line)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import int8inferenceengine_tpu_torch as q
    from int8inferenceengine_tpu_torch import kernels
    from int8inferenceengine_tpu_torch import layers as layers_mod
    from int8inferenceengine_tpu_torch.models import gemma as GM
    from int8inferenceengine_tpu_torch.models import llama as LL
    from int8inferenceengine_tpu_torch.models import text_decoder as TD
    from int8inferenceengine_tpu_torch.models import zoo
    from int8inferenceengine_tpu_torch.ops import attention as A
    from int8inferenceengine_tpu_torch.ops import conv as C
    from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
    from int8inferenceengine_tpu_torch.ops import moe as MO
    from int8inferenceengine_tpu_torch.ops import w4 as W
    from int8inferenceengine_tpu_torch.ops import weight_only as WO
    from int8inferenceengine_tpu_torch.ops.quant import quantize_u8
    kernel_fns = {"qgemm_u8s8": G.qgemm, "qgemm_u8s8_vzp": G.qgemm_multi,
                  "decode_attn_flat": A.decode_attention_flat,
                  "w4_gemm": W.w4_gemm, "w4a8_v2_gemm": W.w4a8_v2,
                  "w4a8_v1_gemm": W.w4a8_v1,
                  "conv_grouped_u8s8": C.conv2d_int8_grouped}
    # the library routes (what the JAX package leaves to XLA): the weight
    # modes', the MoE experts', the ALiBi attention's
    route_fns = {"w8f_matmul": WO.w8f_matmul, "s8_matmul": WO.s8_matmul,
                 "w8f_conv2d": C.w8f_conv2d, "conv2d_s8": C.conv2d_s8,
                 "moe_experts": MO.experts,
                 "alibi_attention": A.decode_attention_alibi,
                 "encoder_attention": A.attention,
                 "fp32_island": layers_mod.fp32_island}
    t_start = time.perf_counter()

    # -- 1. the card -----------------------------------------------------------
    smi = nvidia_smi()
    log(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {kind}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "seconds": round(build_s, 3)}))
    mark("build")
    for name in kernels.SIGNATURES:
        text = (kernels.BUILD_DIR / f"{name}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

    if args.sweep:
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        sweep_plans(torch, G, C, W, A,
                    torch.Generator(device=dev).manual_seed(0), dev,
                    flush_buf.zero_)
        return 0

    if args.windowed:
        gen = torch.Generator(device=dev).manual_seed(0)
        check_gemma_kernels(torch, G, C, A, gen, dev)
        counts = windowed_paths(torch, q, zoo, GM, kernel_fns, dev,
                                args.profile)
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        time_gemma_kernels(torch, G, A, gen, dev, flush_buf.zero_)
        log(json.dumps({"phase": "windowed_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.families:
        gen = torch.Generator(device=dev).manual_seed(0)
        check_family_kernels(torch, G, C, A, gen, dev)
        mark("families: kernel checks")
        counts = families_paths(torch, q, zoo, kernel_fns, route_fns, dev)
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        _, lrows = time_family_kernels(torch, G, A, WO, gen, dev,
                                       flush_buf.zero_)
        log(json.dumps({"library_routes": library_line(lrows, counts)}))
        log(json.dumps({"phase": "families_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.encoders:
        gen = torch.Generator(device=dev).manual_seed(0)
        check_encoder_kernels(torch, G, C, gen, dev)
        mark("encoders: kernel checks")
        counts = encoders_paths(torch, q, zoo, kernel_fns, route_fns, dev)
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        _, lrows = time_encoder_kernels(torch, q, G, C, A, gen, dev,
                                        flush_buf.zero_)
        log(json.dumps({"library_routes": library_line(lrows, counts)}))
        log(json.dumps({"phase": "encoders_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.levers:
        counts = levers_paths(torch, q, zoo, GM, LL, G, A, W, layers_mod,
                              kernel_fns, dev)
        log(json.dumps({"phase": "levers_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.artifact:
        counts = artifact_paths(torch, q, zoo, GM, LL, W, A, kernel_fns, dev)
        log(json.dumps({"phase": "artifact_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.ingest:
        counts = ingest_paths(torch, q, zoo, G, C, A, kernel_fns, dev, smi)
        log(json.dumps({"phase": "ingest_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.hf:
        counts = hf_paths(torch, q, zoo, TD, LL, GM, kernel_fns, dev)
        log(json.dumps({"phase": "hf_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    if args.weight_only:
        gen = torch.Generator(device=dev).manual_seed(0)
        check_b5_decode(torch, W, gen, dev)
        check_library_routes(torch, WO, C, dev)
        mark("weight-only checks")
        counts, _ = weight_only_paths(torch, q, zoo, GM, TD, LL, layers_mod,
                                      kernel_fns, route_fns, dev)
        mark("weight-only paths")
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        _, lrows = time_library_routes(
            torch, WO, C, gen, dev, flush_buf.zero_,
            b1_shapes(torch, q, zoo, "resnet50", dev))
        log(json.dumps({"library_routes": library_line(lrows, counts)}))
        log(json.dumps({"phase": "weight_only_done", "launches": counts,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    # -- 3. on-card numerics ---------------------------------------------------
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 20) * 10).astype(np.float32)
    for rounding in ("trunc", "nearest"):
        got = quantize_u8(torch.tensor(x, device=dev), 0.0237, 127,
                          rounding).cpu()
        want = quantize_u8(torch.tensor(x), 0.0237, 127, rounding)
        if not torch.equal(got, want):
            fail(f"quantize_u8({rounding}) on the card differs from the CPU "
                 f"on {int((got != want).sum())} of {x.size} values")
    sw = torch.tensor(rng.uniform(0.001, 0.02, 4096).astype(np.float32))
    qb = torch.tensor(rng.integers(-127, 128, 4096).astype(np.int8))
    rs = torch.tensor(rng.integers(-10**5, 10**5, 4096).astype(np.int32))
    for order in G.ORDERS:
        ep_gpu = G.epilogue_vector(0.0173, sw.to(dev), 0.0411, 4096, dev,
                                   order).cpu()
        ep_cpu = G.epilogue_vector(0.0173, sw, 0.0411, 4096, "cpu", order)
        if not torch.equal(ep_gpu, ep_cpu):
            fail(f"epilogue_vector({order}) on the card differs from the CPU")
    oc_gpu = G.compute_offset(qb.to(dev), rs.to(dev), 0.00713, 97,
                              recentered=True).cpu()
    if not torch.equal(oc_gpu, G.compute_offset(qb, rs, 0.00713, 97,
                                                recentered=True)):
        fail("compute_offset on the card differs from the CPU")
    log(json.dumps({"phase": "scalar_numerics", "ok": True}))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = {"qgemm_u8s8": check_alexnet_kernel(torch, G, gen, dev)}
    check_gathered_conv(torch, G, C, gen, dev)

    # -- 4. the decoder's kernels against their plain versions ----------------
    for name, err in check_decoder_kernels(torch, G, A, gen, dev).items():
        max_err[name] = max(max_err.get(name, 0), err)

    # -- 24. B1, B2 and B3 at gemma-2-2b's shapes ------------------------------
    for name, err in check_gemma_kernels(torch, G, C, A, gen, dev).items():
        max_err[name] = max(max_err[name], err)

    # -- 34. B1, B2 and B3 at Pythia-1.4B's and Mixtral's shapes ------------
    for name, err in check_family_kernels(torch, G, C, A, gen, dev).items():
        max_err[name] = max(max_err[name], err)

    # -- 39. B1 and B2 at ViT-B/16's and the BERT-width encoder's shapes ----
    for name, err in check_encoder_kernels(torch, G, C, gen, dev).items():
        max_err[name] = max(max_err[name], err)

    # -- 15. B3 at the extend shapes against its plain version ----------------
    max_err["decode_attn_flat"] = max(max_err["decode_attn_flat"],
                                      check_extend_attention(torch, A, gen,
                                                             dev))

    # -- 8. the 4-bit kernels against their plain versions --------------------
    max_err.update(check_w4_kernels(torch, W, gen, dev))
    for name, err in check_engine_prefill_kernels(torch, G, W, gen,
                                                  dev).items():
        max_err[name] = max(max_err.get(name, 0), err)

    # -- 29. B5 at the decode shapes, DA and DAC against their plain versions
    max_err["w4_gemm"] = max(max_err["w4_gemm"],
                             check_b5_decode(torch, W, gen, dev))
    check_library_routes(torch, WO, C, dev)
    mark("kernel checks")

    # -- 5. the AlexNet main path ---------------------------------------------
    counts_by_path = {}
    model, x_test, state, counts_by_path["alexnet_b100"] = alexnet_main_path(
        torch, q, zoo, kernel_fns, dev)
    alexnet_timing(torch, q, zoo, model, x_test, state, args.profile)

    # -- 48. its INT8 artifact --------------------------------------------------
    counts_by_path["alexnet_b100_artifact"] = artifact_alexnet(
        torch, q, zoo, model, x_test, kernel_fns)

    # -- 14. the AlexNet engine -----------------------------------------------
    counts_by_path["alexnet_engine"] = serve_cnn(torch, q, model,
                                                 kernel_fns)

    # -- 54, 55. the native host ops; AlexNet fed by the DataLoader (3
    # batches; --ingest runs 20) ------------------------------------------------
    native_host_ops(torch, timing=False)
    counts_by_path["alexnet_ingest"] = alexnet_ingest(
        torch, q, zoo, C, model, kernel_fns, WHOLE_INGEST_BATCHES, smi)
    del model, state
    mark("alexnet")

    # -- 19. G1 against its plain version --------------------------------------
    max_err["conv_grouped_u8s8"] = check_g1(torch, q, zoo, G, C, gen, dev)
    # -- 57. B1's and G1's bfloat16 epilogue instances against their plain
    # versions ------------------------------------------------------------------
    check_bf16_epilogue_kernels(torch, q, zoo, G, C, gen, dev)

    # -- 20. B1 at every ResNet-50 and MobileNetV2 conv and Linear shape -------
    cnn_shapes = {name: b1_shapes(torch, q, zoo, name, dev)
                  for name in ("resnet50", "mobilenet_v2")}
    for name, shapes in cnn_shapes.items():
        check_b1_shapes(torch, G, C, gen, dev, shapes, name)

    # -- 21. the ResNet-50 main path and its engine ----------------------------
    for name in ("resnet50", "mobilenet_v2"):
        model, x_test, state, counts_by_path[f"{name}_b100"] = cnn_main_path(
            torch, q, zoo, kernel_fns, dev, name)
        cnn_timing(torch, q, zoo, name, model, x_test, state, dev)
        # -- 22. (MobileNetV2: the same protocol without the engine) ---------
        if name == "resnet50":
            counts_by_path["resnet50_engine"] = serve_cnn(
                torch, q, model, kernel_fns, label="resnet50")
        del model, state
        torch.cuda.empty_cache()

    mark("resnet50, mobilenet_v2")
    # -- 23. the rest of the zoo on the card against a CPU copy ----------------
    counts_by_path["cnn_zoo_b2"] = zoo_vs_cpu(torch, q, zoo, kernel_fns, dev)
    mark("cnn zoo")

    # -- 6. the decoders on the card against a CPU copy ----------------------
    decoders_vs_cpu(torch, q, zoo, TD, LL, dev)

    # -- 13. the small decoders' engines, card against CPU ---------------------
    small_engines_vs_cpu(torch, q, zoo, TD, LL, dev)

    mark("small decoders vs cpu")
    # -- 51, 53. every family's HF directory on the card against a CPU copy;
    # what load_pretrained refuses --------------------------------------------
    counts_by_path["hf_small_gates"] = hf_small_gates(
        torch, q, zoo, TD, LL, GM, kernel_fns, dev)
    hf_refusals(torch, q, TD, LL, GM)
    mark("hf small gates, refusals")
    # -- 7. the decoder main path ---------------------------------------------
    dec, ids, counts_by_path["gpt2_small_ish_decode"] = decoder_main_path(
        torch, q, zoo, TD, kernel_fns, dev)
    decoder_timing(torch, dec, ids, args.profile)
    mark("gpt2 main path and timing")

    # -- 12. the gpt2 engine ---------------------------------------------------
    counts_by_path["gpt2_engine"] = serve_decoder(
        torch, dec, "gpt2", kernel_fns, profile=args.profile)
    bench_engine_load(torch, dec)
    mark("gpt2 engines")

    # -- 16-18. gpt2: extend against decode, speculative decoding, chunked
    # prefill and the prefix cache ---------------------------------------------
    counts_by_path["gpt2_extend"] = extend_vs_decode(torch, dec, ids, "gpt2",
                                                     kernel_fns)
    mark("gpt2 extend")
    counts_by_path["gpt2_speculative_self_draft"] = speculative_path(
        torch, dec, dec, ids, "gpt2_self_draft", kernel_fns)
    draft = build_draft(torch, q, zoo, TD, ids)
    counts_by_path["gpt2_speculative_small_draft"] = speculative_path(
        torch, dec, draft, ids, "gpt2_small_draft", kernel_fns)
    del draft
    mark("gpt2 speculative")
    counts_by_path["gpt2_engine_chunked"] = engine_chunked(torch, dec, "gpt2",
                                                           kernel_fns)
    del dec
    torch.cuda.empty_cache()
    mark("gpt2")

    # -- 9. the llama W4A8 main path ------------------------------------------
    (dec, ids, state,
     counts_by_path["llama_w4a8_generate"]) = llama_w4a8_main_path(
        torch, q, zoo, LL, W, A, kernel_fns, dev)
    mark("llama w4a8 main path")
    decoder_timing(torch, dec, ids, args.profile, label="llama_w4a8_decode")
    counts_by_path["llama_w4a8_engine"] = serve_decoder(
        torch, dec, "llama_w4a8", kernel_fns, sampled_and_eos=False,
        profile=args.profile)
    mark("llama w4a8 timing and engine")
    counts_by_path["llama_w4a8_extend"] = extend_vs_decode(
        torch, dec, ids, "llama_w4a8", kernel_fns)
    counts_by_path["llama_w4a8_speculative_self_draft"] = speculative_path(
        torch, dec, dec, ids, "llama_w4a8_self_draft", kernel_fns)
    counts_by_path["llama_w4a8_engine_chunked"] = engine_chunked(
        torch, dec, "llama_w4a8", kernel_fns, full=False)
    mark("llama w4a8 extend, speculative, chunked")
    full_context_timing(torch, q, dec,
                        "llama_w4a8_causal_forward_full_context", kernel_fns)
    # -- 50. its INT8 artifact --------------------------------------------------
    counts_by_path["llama_w4a8_artifact_generate"] = artifact_llama_w4a8(
        torch, q, zoo, W, A, dec, ids, kernel_fns)
    del dec
    torch.cuda.empty_cache()

    # -- 10. the llama W4 weight-only forward ----------------------------------
    wo, counts_by_path["llama_w4_forward"] = llama_w4_forward_path(
        torch, q, zoo, W, kernel_fns, state, ids)
    llama_w4_timing(torch, q, wo, ids, args.profile)
    full_context_timing(torch, q, wo,
                        "llama_w4_weight_only_forward_full_context",
                        kernel_fns)
    # -- 50. (its INT8 artifact) ------------------------------------------------
    counts_by_path["llama_w4_artifact_forward"] = artifact_llama_w4(
        torch, q, zoo, W, wo, ids, kernel_fns)
    del wo, state
    torch.cuda.empty_cache()
    mark("llama")

    # -- 25-28. the windowed decoders: the small gates, gemma-2-2b, its
    # engine, the ring leg ------------------------------------------------------
    counts_by_path.update(windowed_paths(torch, q, zoo, GM, kernel_fns, dev,
                                         args.profile, whole=True))
    torch.cuda.empty_cache()
    mark("windowed")

    # -- 30-33. the weight modes: the small float gates, gemma-2-2b in W8F,
    # dynamic and W4, its W8F engine, ResNet-50 in W8F and dynamic ------------
    wo_counts, _ = weight_only_paths(torch, q, zoo, GM, TD, LL, layers_mod,
                                     kernel_fns, route_fns, dev)
    counts_by_path.update(wo_counts)
    torch.cuda.empty_cache()
    mark("weight modes")

    # -- 35-38. the other decoder families: the small gates, Pythia-1.4B and
    # its engine, the Mixtral-width MoE ---------------------------------------
    counts_by_path.update(families_paths(torch, q, zoo, kernel_fns,
                                         route_fns, dev))
    torch.cuda.empty_cache()
    mark("families")

    # -- 40-43. the encoders: the small gates, the lifecycle levers, ViT-B/16
    # and its engine, the BERT-width text encoder ------------------------------
    counts_by_path.update(encoders_paths(torch, q, zoo, kernel_fns,
                                         route_fns, dev))
    torch.cuda.empty_cache()

    # -- 44-47. the accuracy levers: AlexNet under CLE + AdaRound, gemma-2-2b
    # under SmoothQuant + GPTQ (WHOLE_LEVERS_GEMMA_DEPTH layers), llama W4A8
    # and W4 under GPTQ, the small gates
    counts_by_path.update(levers_paths(
        torch, q, zoo, GM, LL, G, A, W, layers_mod, kernel_fns, dev,
        gemma_depth=WHOLE_LEVERS_GEMMA_DEPTH))
    torch.cuda.empty_cache()

    # -- 11. per-kernel times --------------------------------------------------
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    time_launch_floor(torch, flush)
    rows = time_alexnet_gemms(torch, G, C, gen, dev, flush)
    for name, shapes in cnn_shapes.items():
        rows += time_cnn_gemms(torch, G, C, gen, dev, flush, shapes,
                               f"{name}_b100")
    rows += time_g1(torch, q, zoo, G, C, gen, dev, flush)
    rows += time_decode_kernels(torch, G, A, gen, dev, flush)
    rows += time_extend_attention(torch, A, gen, dev, flush)
    rows += time_w4_kernels(torch, W, A, gen, dev, flush)
    rows += time_gemma_kernels(torch, G, A, gen, dev, flush)
    krows, lrows = time_library_routes(torch, WO, C, gen, dev, flush,
                                       cnn_shapes["resnet50"])
    rows += krows
    frows, flrows = time_family_kernels(torch, G, A, WO, gen, dev, flush)
    rows += frows
    lrows += flrows
    erows, elrows = time_encoder_kernels(torch, q, G, C, A, gen, dev, flush)
    rows += erows
    lrows += elrows
    mark("per-kernel times")
    log(json.dumps({"phase": "done", "seconds": time.perf_counter() - t_start}))

    log(smi)
    log(json.dumps({"kernels": kernels_line(rows, counts_by_path, max_err),
                    "library_routes": library_line(lrows, counts_by_path)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
