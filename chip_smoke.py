"""Drive the antmmf_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py              # from the repository root, on a machine with CUDA
    python3 chip_smoke.py --calibrate  # the card-vs-CPU readings: seeds and planted faults
    python3 chip_smoke.py --calibrate dmae  # one part: serving, training, pink, pretraining,
                                            # dmae, task_heads, roi, pink_train, pink_7b,
                                            # m2_omni, m2_train, engine, decoding

Phases, each printing JSON lines; a failing phase ends the script with a
non-zero code and no result line:

1. card and build: the GPU's name and power limit (``nvidia-smi``), the
   kernels built from ``antmmf_torch/ops/csrc`` with ``nvcc``, every
   kernel's registers and spills from the compiler's ``-Xptxas -v`` report
   (the D=128 ``flash_dq``/``flash_dkv`` kernels must not spill); TF32 is
   turned off so fp32 checks are exact;
2. kernel vs plain: ``small_attention`` against ``plain_small_attention`` on
   the same inputs at the serving path's shapes and at the edges of the bf16
   kernel's tiles (L 15 to 256, D 32 to 128, strided and biased, fully masked
   rows on both of its branches), DMAE's temporal encoder ([128, 8, 12, 64]
   and [4, 8, 8, 64] with a frame-padding key bias), the ROI cross-encoder
   ([128, 12, 104, 64] under a key bias with holes: ragged text, regions and
   OCR; and with every other row's OCR under 24 tokens, so keys 64..103 are
   all masked while keys 0..63 are live), bf16 and fp32, and its autograd
   Function's gradients against fp32 autograd of the plain version (the ViT
   shape, and the temporal and ROI shapes in both dtypes);
   ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` against their plain versions
   on the same inputs (the cross-encoder's [64, 12, 430, 64] with ragged key
   masks, the pretraining pass's [128, 12, 430, 64] with 30 ragged text keys
   then 400 live visual keys, stage-2 re-ranking's chunk of 32 such pairs and
   a tail chunk of 5, Lq ≠ Lk, causal, a fully masked row, D 32 and 128, key counts
   around the forward's tile ring, query counts around the backward's,
   causal with a key bias, Pink's causal prefill shape and its eval batch's
   ([8, 16, 113, 128], 16..64 live text keys), Pink's training
   step: causal [8, 16, 305, 128] with 49 vision keys and 8..256 live text
   keys, k/v repeated from 4 kv heads; at D=128 [4, 16, L, 128] with L 63,
   64, 65 and 129 around the backward's rings, causal Lq ≠ Lk both ways, a
   fully masked sample, leading keys masked under causal, whole key blocks
   masked with and without a fully masked row that sees them), and the
   ``flash_attention`` Function against fp32 autograd of
   ``plain_flash_attention``, also as the
   decoder calls it at D=128 (causal, the ragged bias, k/v repeated inside
   the graph, the gradients of the 4 kv heads); ``int4_gemv`` against ``plain_int4_gemv`` and
   against ``unpack_int4`` + matmul in fp32 on the decode path's five weight
   shapes (2048→2048, 2048→512, 2048→5504, the row-padded 5632→2048 at group
   88 with x of 5504 columns, 2048→151,936) at 1, 8 and 32 rows of bf16 and
   fp32 x, at the edges of its geometry (3, 5 and 31 rows, outs of 516 and
   2052, groups whose boundaries fall inside a K chunk or a half, a
   row-padded record, x with a wider row stride, the smallest record), one
   CUDA graph of it replayed twice bit for bit, and two refusals (33 rows;
   an x too wide for shared memory);
3. serving: ``projects/base_vtp/configs/serving.yml`` at full width (ViT-B/32
   at 8x224², BERT-base at L=30, bf16, seeded random weights) through the
   port's CLI and predictor code: one ``predict`` and one ``predict_batch`` of
   8, at ``token_merge_r`` 8 (as shipped) and 0; every forward must launch the
   attention kernel 24 times (12 ViT + 12 BERT layers);
4. card vs CPU (serving): the same weights in fp32 on the CPU (plain
   versions) against bf16 on the card, r=0, one request, held to the bound
   that ``--calibrate`` reads from sound seeds and planted faults;
5. training: ``bench.py``'s two training legs at full width through
   ``build_model``, ``build_optimizer``, ``TrainState`` and
   ``make_train_step`` (AdamW lr 5e-5, weight decay 0.01, bf16 first moment,
   clip 1.0), repeating one fixed batch: the flagship (B=32) and the
   cross-mined step (B=16, cross-encoder of 2 layers, ``hard_mining_k`` 4, so
   64 pairs of 430 tokens). Per step: the loss (finite and falling), the
   time, the kernels' launches (24 of ``small_attention``; for the
   cross-mined step 2 of each flash kernel); the step time p50, clip-text
   pairs/s and the device's idle share from ``torch.profiler``;
6. card vs CPU (training): the cross-mined step at B=4 on the same fp32
   master weights, bf16 on the card against fp32 on the CPU: the first
   step's loss and each parameter's gradient cosine, held to the bound that
   ``--calibrate`` reads;
7. times: text-query and full-encode latency, each kernel's time beside its
   bound, its plain version and the library call at the paths' shapes (the
   ViT, BERT, Pink's ViT, DMAE's temporal encoder and the ROI
   cross-encoder for ``small_attention``; the forward alone at a stage-2 chunk of 32 pairs;
   the cross-encoder's
   pair streams of the cross-mined step (64 pairs) and of a pretraining pass
   (128 pairs), Pink's training step (causal, D=128, SDPA given the same
   mask as a boolean [B, 1, L, L]) and Pink's causal prefill for
   ``flash_fwd``; SDPA's backward
   alone, with the kernels that ran it, for ``flash_dq`` and ``flash_dkv``;
   the kernel table carries the pretraining shape's numbers), kernel and
   library as device time per launch from a CUDA graph, with the GPU's name
   and power limit;
8. trace: ``torch.profiler`` over full encodes at B=32: device-busy time per
   forward against the untraced wall time (the device's idle share), device
   operations (kernels and copies) per forward and those that take the most
   device time;
9. Pink int4 decode serving: ``GenerationPredictor`` through the CLI code at
   the full width of ``lm_preset: omni_1b`` (hidden 2048, 22 layers, 16 heads
   of 128, 4 kv heads, vocabulary 151,936, SwiGLU 5504) behind ViT-B/32 at
   224², bf16, ``decode_quant: int4`` (the records made on the card by
   ``quantize_module_for_decode``), prompt of 64 tokens, 24 new tokens,
   seeded random weights. Each request must launch ``small_attention`` 11
   times (ViT), ``flash_fwd`` 22 times (the causal prefill of 113 tokens) and
   ``int4_gemv`` 1 + 23·155 times (``lm_head`` on the last prompt token,
   then 7 projections in each of 22 layers plus ``lm_head`` per decode step);
   greedy tokens with the cache must equal re-encoding for 4 new tokens;
   prefill time, decode time per token, tokens/s, peak memory and the
   device's idle share over profiled decode steps;
10. card vs CPU (Pink): one set of int4 records loaded into the card's bf16
   model and an fp32 CPU model (the records phase 9's predictor made on the
   card from its bf16 weights, exported with ``export_decode_records``, not
   a second quantisation of the CPU's): the logits at
   prefill and at the first decode step (teacher-forced), held to the bound
   that ``--calibrate`` reads from sound seeds and planted faults;
11. ``int4_gemv`` timed on the served model's own records at 1, 3, 5, 8,
   16, 24 and 32 rows of bf16 x (3: a request's beams; 5: a speculative
   verify step of gamma 4; 8: the engine's pooled decode step; 16: its
   chunked extend; 24: beams over an eval batch of 8), cycling through
   copies so that no launch finds its
   weights in the L2 cache, beside its bound, its plain version (1 row) and
   bf16 ``torch.matmul`` on the dequantised weight, and summed over a decode
   step's 155 launches for each row count;
11b. the continuous-batching engine (``predictors/serving_engine.py``):
   (a) on phase 9's Pink int4 module, 8 slots, windows of 8 tokens, 16
   requests with an image (two text-only) of 16..64 prompt tokens and
   8..24 new tokens, two of them sampled (top_p 0.9, temperature 0.8), one
   with a stop token, one cancelled after the first window, one evicted by
   its deadline: greedy tokens against sequential ``generate`` on the same
   module (a first differing position must be a near-tie of the sequential
   logits, ``ENGINE_TIE_MAX``), the sampled ones again in another order;
   then the same requests with ``prefill_chunk`` 16, a prefix (the image and
   16 tokens) registered once with 4 suffixes against their full prompts,
   a two-turn session against a full re-prefill, and a pass with
   ``kv_int8``; every window launches K8 8 x 155 times and nothing else,
   every admission 22 ``flash_fwd``, K8 once and 11 K1 with an image, every
   extend K8 155 times; tokens/s against sequential ``generate`` over the
   same requests, TTFT and TPOT p50/p99, slot use, peak memory, the idle
   share over two profiled windows; (c) the int8 cache card bf16 vs CPU
   fp32 at full width and 2 decoder layers (3 decode steps teacher-forced
   with the CPU's tokens), held to the bounds ``--calibrate engine`` reads,
   and two planted faults outside them (the key scales read one slot off,
   the value scales not applied); (d) ``python -m
   antmmf_torch.predictors.cli --engine`` through ``cli.main`` on four
   text-only requests at 2 decoder layers seeded on the card, its tokens
   against an in-process engine on the same model;
11c. the decoding surface on phase 9's module: (a) ``antmmf_torch.scripts.
   pink_eval.main`` over 16 seeded VQA rows (OpenCV images written under
   ``build/`` and deleted) at batch 8 and 16 new tokens, greedy, beams of 3,
   speculation of gamma 4 and sampling (top_p 0.9, temperature 0.8, seed
   5): each mode's seconds and ms a row beside greedy's, 22 ``flash_fwd``
   and 11 K1 a batch asserted; speculation's tokens equal greedy's but at a
   near-tie of the greedy logits (``ENGINE_TIE_MAX``), one seed's samples
   equal twice, top_p 1e-6 greedy's under the same rule; (b) one request
   through the generation predictor in each mode, K8's launches by rows
   (beams: 3 rows a step; speculation: 5 a verify step) beside phase 11's
   K8 and bf16 matmul times a step at those rows; Pink at full width seeded
   on the card in bf16, then ``decode_quant: int8`` in place on the card
   (decode ms a token, weight bytes, a request's launches: 22 ``flash_fwd``,
   11 K1, no K8) beside phase 9's int4; (c) card bf16 vs CPU fp32 at 2 of 22
   decoder layers: the card's best beam's score against the CPU's
   log-probabilities of its tokens, the card's samples at top_p 0.5 inside
   the CPU's nucleus, int8 records made on the card equal to the CPU's byte
   for byte, the kernels the card dequantises equal to the CPU's bf16
   product of them, and the logits of a prefill and three decode steps,
   held to the bounds ``--calibrate decoding`` reads, with four planted
   faults, each outside the bound named for it (the beams' cache rows
   rolled: the card's replay of its best beam; the beams' length penalty
   dropped: the CPU's score; the nucleus filter skipped; the int8 scale
   multiplied in fp32 and then cast);
12. trainer: ``python -m antmmf_torch.run`` driven in-process
   (``antmmf_torch.run.main``) on ``projects/base_vtp/configs/
   video_retrieval.yml`` at full width over a seeded synthetic dataset in
   its MSR-VTT layout (64 clips of 12 frames at 240×320 in an LMDB, 64
   captions), written under ``build/`` and deleted at the end: 8 steps at
   B=32, the cached val batch every 2 steps, the full validation with
   ``global_retrieval_recall`` every 4, ``max_ckpt_num`` 1, then a resumed
   run to step 10. Checks: 24 ``small_attention`` launches for every train
   step and eval forward and no other kernel, finite losses and a falling
   epoch mean, the first step's loss against phase 5's bare step on the same
   batch and masters, the recalls in [0, 100] and equal to those recomputed
   on the host from the collected embeddings, the files on disk, the resumed
   state (step, masters, AdamW moments, generator) equal to the first run's
   bit for bit, model and batches on the card. Prints the step time and the
   loader wait, clip-text pairs/s per step and over the train loop's whole
   wall time beside phase 5's bare step, the idle share over 2 profiled
   trainer steps (after the counts are read), one batch's host work by
   stage, the loader's steady rate over 8 batches without an epoch restart,
   the full validation's seconds, checkpoint seconds and bytes, resume seconds, peak
   memory and setup seconds;
13. pretraining: ``projects/base_vtp/configs/univl_pretrain.yml`` at full
   width (ViT-B/32 8×224², BERT-base L=30, embed 512, 2 cross layers, bf16
   on fp32 masters, AdamW): (a) the first step at B=4 on the same fp32
   masters and masked batch, bf16 on the card against fp32 on the CPU: each
   loss term's |Δ| (``vtc_loss``, ``itm_loss``, ``masked_lm_loss``), the
   all-gradient cosine, the worst parameter's and the word embedding's
   cosine, held to the bounds ``--calibrate pretraining`` reads from sound
   seeds and three planted faults (an untied MLM decoder, VTM labels that do
   not match the roll, the cross key bias dropped); (b) the bare step at the
   config's B=128 on one repeated masked batch: step p50/p95, clip-text
   pairs/s, device-busy time and idle share over 2 profiled steps, device
   ops, peak memory, and 24 ``small_attention`` and 4 of each flash kernel
   launched every step; (c) ``antmmf_torch.run.main`` on the config at B=32
   over phase 12's dataset (written again under ``build/`` and deleted)
   with MLM masking on: 6 steps and the final full validation, a resumed
   run to step 8 (state bit for bit), then 3 steps of ``snps3_pretrain.yml``
   (dual MLM, FOM, significant masking) with every loss term finite; the
   launches of every train step and eval forward (24 / 4 / 4 / 4 and
   24 / 4 / 0 / 0), the first loss against the bare step on the trainer's
   first batch and masters, MLM targets in training and none in validation,
   pairs/s a step and over the loop, loader wait;
14. retrieval variants: (a) DMAE (``dmae_vtp/configs/msrvtt_retrieval.yml``
   at full width: 12 frames, L=32, 4 temporal layers) card bf16 against
   CPU fp32 on the first step at B=4 with padded frames and captions: each
   loss term's |Δ| and the gradient cosines, held to the bounds
   ``--calibrate dmae`` reads, and three planted faults (WTI masked with
   finfo.min instead of zero, token weights softmaxed over padding,
   NegNCE's hard mask in one direction) each outside them; (b) the bare
   DMAE step at its B=128 on one repeated batch, since PR 17 at 2 of the 12
   ViT and BERT layers (``RV_LAYERS``; 8 ``small_attention`` launches a
   step: 2 ViT, 2 BERT, 4 temporal; p50/p95, pairs/s, device-busy time,
   idle share, device ops, peak memory); (c)
   ``antmmf_torch.run.main`` on it through ``retrieval_trainer`` at B=32
   over phase 12's dataset: 6 steps, the final validation's L1 and L3
   corpus recalls equal to a host recomputation from the encode outputs,
   a resume to 8 bit for bit; (d) MoCo on ``video_retrieval.yml``
   (``with_queue``, ``with_momentum``, momentum 0.99, queue 4096): the bare
   step at B=128 beside the plain step on the same batch, both at
   ``RV_LAYERS`` (8 launches a MoCo step: 4 online, 4 key forward), the
   key forward and the EMA
   timed alone; the trainer at B=32 for 6 steps (``ptr`` 192, ``filled``
   4096, one momentum tensor against a host EMA of the masters after each
   step) and a resume to 8 with the queues, momentum towers and key module
   bit for bit; (e) stage 2: ``video_retrieval.yml`` with the
   cross-encoder through ``retrieval_trainer`` (``stage2_topk`` 8,
   ``stage2_chunk`` 32), one validation over the 64 clips: 32 ``flash_fwd``
   launches (16 chunks × 2 layers) and no backward kernel, 8 candidates a
   text and −1e30 elsewhere, the L2 recalls between the host's
   tie-optimistic and tie-pessimistic rankings of the port's own scores;
15. task heads (``video_retrieval.yml`` with ``model_class`` overridden):
   (a) ``caption_predictor`` through the CLI's code on ``univl_caption`` at
   its defaults (ViT-B/32 on 8 frames at 224², 3 decoder layers of 768 with
   8 heads, vocabulary 30,522, 40 tokens, 4 beams, seeded weights): a
   warm-up and 6 requests, each launching K1 12 times (the ViT) and no flash
   kernel (the decoder's 96-wide heads take the einsum core); request
   p50/p95, prime ms (ViT and the memory k/v), decode ms a step (the rest
   over 39 steps), peak memory, idle share over one profiled request;
   (b) card bf16 against CPU fp32 on the same masters at B=2: the caption
   model's teacher-forced logits (cosine, |Δ| over the spread) and loss,
   MCQA's option logits, held to the bounds ``--calibrate task_heads``
   reads; three planted faults outside them (the causal mask dropped, the
   memory mask ignored, MCQA attending to option padding); the caption
   model in fp32 on the card, beam search with the caches against
   re-encoding (tokens, each step's candidates, the cached decode's logits
   on the re-encoded tokens), and the cache written one slot late outside
   that bound; (c) the bare train step at B=32 of ``univl_caption``,
   ``univl_classification`` and ``univl_mcqa`` (12, 24 and 24 K1 launches
   a step; p50/p95, pairs/s, busy ms, idle share, ops, peak memory); (d)
   ``univl_caption`` through ``antmmf_torch.run.main`` on phase 12's
   synthetic layout, 6 steps at B=32 and a resume to 8 bit for bit, the
   first loss against the bare step's on the same batch and masters.
16. ROI document pretraining (``projects/base_vtp/configs/roi_pretrain.yml``
   at full width: BERT-base at L=30, 10 regions of 2048 features with 13
   classes projected to 768, 64 OCR tokens with LayoutLM boxes, 2 cross
   layers over 104 tokens, MLM + ITM + MRC, no ViT): (a) card bf16 against
   CPU fp32 on the same masters at B=4 with the region dropout off: each
   loss term's |Δ|, the gradient cosines and the region and layout tables'
   cosines, held to the bounds ``--calibrate roi`` reads, and three planted
   faults outside them (the layout embeddings dropped, the streams
   concatenated OCR-first so that MRC reads OCR states, the KL reversed);
   (b) the bare step at B=128 on one repeated batch with the region dropout
   on (14 K1 launches a step: 12 BERT layers, 2 cross layers at L=104;
   p50/p95, pairs/s, busy ms, idle share, ops, peak memory, K1's device
   time); (c) ``antmmf_torch.run.main`` over 128 seeded synthetic
   documents (4..14 regions, 0..12 OCR lines) written under ``build/`` and
   deleted: 6 steps at B=32, the final validation (no MLM or MRC target),
   a resume to 8 bit for bit, the first loss against the bare step's on the
   same batch, masters and generator; (d) ``univl_pretrain.yml`` with
   ``attentive_masking`` at B=128: both branches of the coin over the
   steps, the attentive one masking 4 positions of every row with as many
   live words and never a special token, the importance pass timed alone.
17. Pink instruction tuning (``projects/pink/configs/pink_instruct.local.yml``
   at full width: ``omni_1b`` behind ViT-B/32 at 224², bf16, LoRA rank 16 on
   the decoder's q and v, ``pink_7b.yml``'s ``frozen_params``, B=8,
   ``gradient_accumulation_steps`` 2, the clip on, text of 256 tokens):
   (a) card bf16 against CPU fp32 on the same masters (every ``lora_b``
   drawn nonzero) at 4 of the 22 decoder layers and B=2: |Δ lm_loss| and
   the trainable gradients' cosines, held to the bounds ``--calibrate
   pink_train`` reads, and three planted faults outside them (labels not
   shifted, the frozen q/v projections' outputs detached, the decoder's
   attention not causal); (b) ``antmmf_torch.run.main`` at 4 of the 22
   decoder layers over 256 seeded rows in the config's vqa, grounding and
   caption sources (naming the repository's three fixture images where
   OpenCV reads them, else none: black frames), written under ``build/``
   and deleted: 5 iterations, the final validation and a snapshot one
   micro-step into the third window; a trainer resumed from it holds the
   saved state bit for bit, and the 6th iteration from the resumed state
   and from the first run's gives the same state bit for bit (3 updates);
   11 K1 and 4 of each flash kernel an iteration, 11 and 4 forward an eval;
   the first batch's loss under the final masters below the initial one;
   (c) the trainer at all 22 layers, loaded as ``run.main`` loads it: timed
   updates of its step on its first batch (22 / 44 / 44 / 44 launches an
   update), p50 per update and per micro-batch, tokens/s over all positions
   and over the supervised ones, device-busy ms, flash ms and the idle
   share over 2 profiled updates, optimizer-state bytes (12 a trainable
   parameter, none for a frozen one), peak memory.
18. Pink 7B (``pink_7b.yml`` laid over ``pink_instruct.local.yml`` by
   ``recipe_opts``: omni_7b behind EVA-CLIP-g, LoRA 16 on q/v, remat,
   ``scan_layers``): card bf16 vs CPU fp32 at 2 of 32 decoder and 2 of 39
   EVA layers with three planted faults, ``run.main`` at 1 and 1 with a
   resume inside an accumulation window, its ``save_dir`` and a stacked
   ``params.npz`` served to the same tokens, then the trainer at full
   depth (remat on against off, timed and profiled updates).
19. M2-omni serving (``m2_omni_7b.yml`` with ``serving_opts``: omni_7b
   behind Qwen2-ViT at 32 blocks of 1280 and the conv audio tower at 512,
   bf16, prompts of 640 tokens, images at 448² pixels, seeded weights drawn
   on the card): (a) ``generation_predictor`` through the CLI's code at
   full depth, three requests (a conversation with a 500×375 image; that
   image, 2.6 s of audio and text; a conversation with a video of 4 frames
   at 448²), each launching ``flash_fwd`` 32 times (the causal prefill,
   k/v repeated from 8 kv heads) and K1 4 times with audio (the conv
   tower at [1, 4, 64, 128]); prefill ms with the towers' share, ms a
   token, tokens/s, the idle share, peak memory; (b) one request with
   ``audio_tower: sanm`` (50 blocks, 85 audio tokens); (c) at 2 of 32
   decoder layers and 2 of 32 blocks, the weights written as a stacked
   ``params.npz`` and served by ``antmmf_torch.predictors.cli.main
   --model_dir`` to the in-process predictor's tokens; (d) card bf16 vs
   CPU fp32 at that depth on requests (a) and (b): the logits at the last
   prompt token and the first decode step, the towers' modal tokens in
   fp32 on the card, the 3D positions equal to the CPU's and to the
   reference recurrence, held to the bounds ``--calibrate m2_omni`` reads
   and five planted faults outside them (the mRoPE bands on the wrong
   axes, image slots at sequential positions, the PatchMerger grouping in
   raster order, the L2 normalisation dropped, the audio convolutions
   padded (1, 1)). Phase 2 holds ``flash_fwd`` at its prefill [1, 32, 640,
   128] and K1 at [1, 4, 64, 128]; phase 7 times both beside SDPA; (e)
   the engine on (a)'s model: 4 slots, windows of 8, the three requests
   twice against (a)'s tokens under the near-tie rule (32 ``flash_fwd`` an
   admission, 4 K1 with audio, no launch in a window), the RoPE position and
   the cache slot advancing apart, a two-turn text session against a full
   re-prefill, the idle share over two windows; (d)'s twins with the int8
   cache on request (a), held to the int8 bounds with the same two faults
   outside them; then, last on (a)'s model, int4: the model quantised in
   place on the card (seconds; layer 0's seven records and ``lm_head``'s
   against numpy's ``quantize_for_decode`` on host copies of the same
   weights, byte for byte), K8 at its five shapes (4096→4096, 4096→1024,
   4096→11,008, 11,008→4096 stored as 11,264 rows, 4096→151,936) at 1, 4 and
   8 rows against ``plain_int4_gemv`` and timed beside bf16 matmul and the
   bound, summed over a decode step's 225 launches, and request (a) served
   greedy (32 ``flash_fwd`` and 1 + 23·225 K8 asserted) and speculative
   (gamma 4: its tokens against greedy's under the near-tie rule): TTFT, ms
   a token and peak memory beside the bf16 readings.
20. M2-omni LoRA training (``m2_omni_7b.yml`` under ``recipe_opts`` of
   ``models/m2_omni.py``: LoRA 8 on the decoder's seven projections and on
   every Qwen2-ViT block, only the adapters, ``vision_proj`` and
   ``audio_proj`` train; remat, ``scan_layers``, AdamW lr 2e-5 with a bf16
   first moment, accumulation 2), seeded on the card, through
   ``build_optimizer`` and ``make_train_step``: (a) at full width and depth,
   updates of two micro-batches of 4 conversations of 640 slots from the
   unified processor (images, two of them with audio and text; then 4-frame
   videos at 392²), labels over the assistant's answer: 2 warm-up, 4 timed and 2
   profiled updates (p50/p95 ms, tokens/s, busy and idle share, flash ms,
   peak memory, optimizer-state bytes, 128 ``flash_fwd``, 64 ``flash_dq``,
   64 ``flash_dkv`` and 4 K1 launches an update asserted), finite losses,
   every trainable master moved and every frozen one bit-unchanged; (b) one
   update of B=1 conversations with a 16-frame video (2,048 video slots of
   2,304), so the LM loss takes its chunked path, and its peak memory; (c)
   card bf16 vs CPU fp32 at 2 of 32 decoder layers and 2 of 32 blocks, B=1
   (the loss and the trainable gradients' cosines), held to the bounds
   ``--calibrate m2_train`` reads and three planted faults outside them
   (the decoder's LoRA scaling doubled, the vision tokens detached, the
   audio convolutions padded (1, 1)). Phase 2 holds the flash family at its
   micro-batch [4, 32, 640, 128] (causal, right-padded), phase 7 times it
   beside SDPA's backward.

Each path (serving, each training leg, each Pink request, the trainer, the
pretraining step and trainer, each part of phase 14 but its card-vs-CPU
comparison, each caption request, bare step and trainer run of phase 15,
each bare step and trainer run of phase 16, phase 17's trainer runs,
phase 18's runs and served requests, phase 19's requests, each engine
pass of phases 11b and 19, each pink_eval run and predictor request of
phase 11c, phase 19's int4 requests, phase 20's warm-up updates and its
chunked-loss update)
runs
with the kernels' launch counts set to 0 just before it and read just after;
launches made to compare a kernel with its plain version or to time it are
not counted. The line before the last holds the kernel table, the last line
the result; the line before the kernel table gives each phase's seconds
(``timeline``). Without CUDA the script exits non-zero before printing
anything.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

import torch.nn.functional as F  # noqa: E402

from antmmf_torch import run  # noqa: E402
from antmmf_torch.common.build import build_config  # noqa: E402
from antmmf_torch.common.checkpoint import Checkpoint  # noqa: E402
from antmmf_torch.datasets.loader import DataLoader  # noqa: E402
from antmmf_torch.models.base_model import build_model  # noqa: E402
from antmmf_torch.datasets.processors.m2omni_processing import (  # noqa: E402
    M2OmniUnifiedProcessor,
)
from antmmf_torch.models.m2_omni import recipe_opts as m2_recipe_opts  # noqa: E402
from antmmf_torch.models.pink import LM_PRESETS, recipe_opts  # noqa: E402
from antmmf_torch.modules.vision.eva_vit import EVA_PRESETS  # noqa: E402
from antmmf_torch.modules.vision.qwen2_vit import QWEN2_VIT_PRESETS  # noqa: E402
from antmmf_torch.modules.layers import make_attention_mask  # noqa: E402
from antmmf_torch.ops import _build  # noqa: E402
from antmmf_torch.ops import flash_attention as fa  # noqa: E402
from antmmf_torch.ops import int4_matmul as i4  # noqa: E402
from antmmf_torch.ops import small_attention as sa  # noqa: E402
from antmmf_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_dkv,
    flash_dq,
    flash_fwd,
    plain_flash_attention,
    plain_flash_dkv,
    plain_flash_dq,
    plain_flash_fwd,
)
from antmmf_torch.ops.int4_matmul import (  # noqa: E402
    int4_gemv,
    plain_int4_gemv,
    unpack_int4,
)
from antmmf_torch.ops.kernel_times import (  # noqa: E402
    flash_bwd_bytes,
    sdpa_backward_ms,
    sdpa_kernels,
)
from antmmf_torch.ops.small_attention import (  # noqa: E402
    key_bias,
    plain_small_attention,
    small_attention,
)
from antmmf_torch.optimizer.build import build_optimizer  # noqa: E402
from antmmf_torch.predictors.cli import build_predictor  # noqa: E402
from antmmf_torch.predictors.m2_omni_serving import (  # noqa: E402
    M2_OMNI_7B,
    SERVING_PIXELS,
    SERVING_SEQ_LEN,
    serving_opts,
)
from antmmf_torch.predictors.quantization import (  # noqa: E402
    export_decode_records,
    load_decode_records,
    quantize_for_decode,
    quantize_module_for_decode,
)
from antmmf_torch.predictors.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine,
    M2OmniAdapter,
    PinkAdapter,
)
from antmmf_torch.modules.moco import queue_buffers  # noqa: E402
from antmmf_torch.modules.qdense import QuantDense  # noqa: E402
from antmmf_torch.trainers.base_trainer import BaseTrainer  # noqa: E402
from antmmf_torch.trainers.build import build_trainer  # noqa: E402
from antmmf_torch.trainers.retrieval_trainer import RetrievalTrainer  # noqa: E402
from antmmf_torch.trainers.train_state import TrainState, make_train_step  # noqa: E402
from antmmf_torch.utils.flags import get_parser  # noqa: E402
from antmmf_torch.utils.lmdb_lite import LmdbLiteWriter  # noqa: E402
from antmmf_torch.utils import weights  # noqa: E402
from antmmf_torch.utils.weights import (  # noqa: E402
    export_flax_params,
    export_flax_variables,
    flatten_flax,
    flax_paths,
    flax_to_masters,
)

CONFIG = "projects/base_vtp/configs/serving.yml"
FRAMES, SIZE, SEED = 8, 224, 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
FP32_TOL = 1e-5             # fp32: only summation order differs
BF16_ULPS = 3               # bf16: P and the output round once each
# card bf16 vs CPU fp32 at full width (``--calibrate`` reads the gap): sound
# runs over five seeds stay above cos 0.99989 and below |Δsim| 0.0071; BERT's
# key bias dropped reads text cos 0.744 and |Δsim| 0.076 (H100 readings)
COS_MIN, DSIM_MAX = 0.999, 0.05
# flash kernels vs their plain versions on the same inputs, in bf16 ulps of
# the reference's largest magnitude; against fp32 autograd of the plain
# semantics (the kernels round P and dS to bf16 first), twice that
FLASH_ULPS, FLASH_AUTOGRAD_ULPS = 2, 4
# card bf16 vs CPU fp32, first cross-mined training step at B=4: the cosine
# of all gradients together, the least per-parameter cosine, |Δloss|
GRAD_COS_ALL, GRAD_COS_MIN, DLOSS_MAX = 0.99, 0.9, 0.01

TEXT_LEN = 30
VIT_TOKENS = (SIZE // 32) ** 2 + 1  # ViT-B/32 tokens per frame, the class token included
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
CROSS = dict(with_cross_encoder=True, cross_layers=2, hard_mining_k=4)
TRAIN_LEGS = {"flagship": ({}, 32), "cross_mined": (CROSS, 16)}
# launches per training step: 12 ViT + 12 BERT layers forward (K1's
# backward is plain tensor ops, as in the JAX package); the cross-encoder's
# two layers run the flash forward, dQ and dK/dV once each
STEP_LAUNCHES = {
    "flagship": {"small_attention": 24, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                 "int4_gemv": 0},
    "cross_mined": {"small_attention": 24, "flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
                    "int4_gemv": 0},
}
KERNELS = (small_attention, flash_fwd, flash_dq, flash_dkv, int4_gemv)

# Pink int4 decode serving at full width: the tiny config's file with the
# full-width model and the serving parameters on top
PINK_CONFIG = "projects/pink/configs/pink_tiny.local.yml"
PINK_MODEL = {"lm_preset": "omni_1b", "visual_tower": "vit", "vit_preset": "vit_base_patch32",
              "image_size": SIZE, "lora_rank": 8, "lora_decoder": "true"}
PINK_PROMPT_LEN, PINK_NEW_TOKENS, PINK_VOCAB = 64, 24, 151936
PINK_LAYERS, PINK_VIT_LAYERS, PINK_PATCHES = 22, 11, (SIZE // 32) ** 2
GEMVS_PER_STEP = 7 * PINK_LAYERS + 1  # q, k, v, o, gate, up, down per layer, and lm_head
PINK_LAUNCHES = {"small_attention": PINK_VIT_LAYERS, "flash_fwd": PINK_LAYERS, "flash_dq": 0,
                 "flash_dkv": 0,
                 # lm_head on the last prompt token, then every decode step
                 "int4_gemv": 1 + (PINK_NEW_TOKENS - 1) * GEMVS_PER_STEP}
# Pink instruction tuning at full width (phase 17): B=8 of 49 vision and 256
# text tokens through the causal flash family at D=128
PINK_TRAIN_BATCH, PINK_TRAIN_TEXT = 8, 256
# the decode path's weight shapes: (x columns, record rows, out, group)
INT4_SHAPES = {"attn_q_o": (2048, 2048, 2048, 128), "attn_k_v": (2048, 2048, 512, 128),
               "mlp_gate_up": (2048, 2048, 5504, 128), "mlp_down": (5504, 5632, 2048, 88),
               "lm_head": (2048, 2048, PINK_VOCAB, 128)}
# int4_gemv against its plain version and against unpack + matmul, all fp32
# sums of exact products in another order over up to 5632 terms, held to
# INT4_TOL times the output's largest magnitude (7 to 17 with these random
# records): readings on an H100 stay below 7.7e-6 against the plain version
# and 2.3e-5 against unpack + matmul, a tenth of the bound
INT4_TOL = 2e-5
# where the kernel's geometry can go wrong: (case, rows, x columns, record
# rows, out, group, x row stride). Rows left over after the batches of 4;
# outs that are multiples of 4 but not of the column tile; K chunk and slab
# boundaries inside a group (group 96, and group 256, which does not divide
# in/2); a row-padded record; x with a wider row stride; the smallest record
INT4_EDGES = [("rows_3", 3, 2048, 2048, 512, 128, 2048),
              ("rows_5_down", 5, 5504, 5632, 2048, 88, 5504),
              ("rows_31", 31, 2048, 2048, 2048, 128, 2048),
              ("out_516", 1, 2048, 2048, 516, 128, 2048),
              ("out_2052_rows_8", 8, 2048, 2048, 2052, 128, 2048),
              ("group_96_in_2304", 1, 2304, 2304, 1024, 96, 2304),
              ("group_256_in_2304", 2, 2304, 2304, 1024, 256, 2304),
              ("x_2000_of_2048_rows", 1, 2000, 2048, 1024, 128, 2000),
              ("x_row_stride_3000", 3, 2048, 2048, 2048, 128, 3000),
              ("out_4_in_64", 1, 64, 64, 4, 32, 64)]
# card bf16 vs CPU fp32 on the same int4 records, logits at prefill and at
# the first decode step (``--calibrate`` reads the gap): the cosine, and the
# largest |Δlogit| over the CPU logits' spread. Sound runs over three seeds
# stay above cos 0.99981 and below 0.089; the two halves' scales swapped, the
# mildest planted fault, reads 0.29 at prefill and cos 0.989, 0.71 at the
# decode step; the down_proj padding dropped cos 0.765; the high nibble read
# unsigned cos 0 (H100 readings)
PINK_COS_MIN, PINK_DLOGIT_MAX = 0.999, 0.25


def zero_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 2
def kernel_cases(gen):
    """(name, q, k, v, bias) at the serving path's shapes, one dtype at a time."""
    dev = "cuda"
    fmin = torch.finfo(torch.float32).min

    def qkv(B, H, L, D, dtype, strided=False):
        if strided:  # the [B, L, H, D] projection layout MultiHeadAttention passes
            t = [torch.randn(B, L, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
                 for _ in range(3)]
        else:
            t = [torch.randn(B, H, L, D, generator=gen, device=dev).to(dtype) for _ in range(3)]
        return t

    def pad_bias(B, L, lo):
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device=dev)
        return make_attention_mask((torch.arange(L, device=dev)[None] < lens[:, None]).long())

    def tome_bias(B, L):
        size = torch.randint(1, 9, (B, L), generator=gen, device=dev).float()
        return torch.log(size)[:, None, None, :]

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        yield (f"vit_L50_{tag}", *qkv(256, 12, 50, 64, dtype, strided=True), None)
        yield (f"bert_L30_pad_{tag}", *qkv(32, 12, 30, 64, dtype, strided=True),
               pad_bias(32, 30, 5))
        for L in (42, 34, 26, 18, 10, 6, 4, 3, 2):
            yield (f"tome_L{L}_{tag}", *qkv(64, 12, L, 64, dtype), tome_bias(64, L))
        yield f"d32_L50_pad_{tag}", *qkv(64, 8, 50, 32, dtype), pad_bias(64, 50, 1)
        yield f"d128_L50_{tag}", *qkv(64, 6, 50, 128, dtype), None
        yield f"L256_pad_{tag}", *qkv(8, 12, 256, 64, dtype), pad_bias(8, 256, 1)
        # the edges of the bf16 kernel's tiles: 16 query rows a warp, 8-key
        # blocks, 64-key tiles, 128 query rows a block
        for L in (15, 16, 17, 63, 64, 65, 128, 255):
            yield f"edge_L{L}_pad_{tag}", *qkv(16, 12, L, 64, dtype), pad_bias(16, L, 1)
        yield f"d32_L200_pad_{tag}", *qkv(8, 8, 200, 32, dtype), pad_bias(8, 200, 1)
        if dtype == torch.bfloat16:  # fp32 at D=128 stops at L=215 and its stage is larger
            yield f"d128_L200_pad_{tag}", *qkv(8, 6, 200, 128, dtype), pad_bias(8, 200, 1)
            # M2-omni's conv audio tower: 4 heads of 128 over 64 frames, no bias
            yield f"m2_audio_L64_d128_{tag}", *qkv(1, 4, 64, 128, dtype, strided=True), None
        yield (f"L256_strided_pad_{tag}", *qkv(8, 12, 256, 64, dtype, strided=True),
               pad_bias(8, 256, 1))
        for L in (50, 130):
            q, k, v = qkv(2, 3, L, 64, dtype)
            masked = torch.zeros(2, 1, 1, L, device=dev)
            masked[0] = fmin  # every key of sample 0 masked
            yield f"fully_masked_L{L}_{tag}", q, k, v, masked
        yield from temporal_cases(gen, dtype)
        yield from roi_cases(gen, dtype)


def roi_key_bias(gen, B: int, short_ocr: bool = False, device: str = "cuda"):
    """The ROI cross-encoder's key bias over 30 text + 10 region + 64 OCR
    keys, each segment ragged, so the live keys have holes in the middle:
    text 5..30, regions 1..10, OCR 0..64 (``short_ocr``: every other row
    keeps fewer than 24 OCR tokens, so keys 64..103 are all masked while
    keys 0..63 are live)."""
    def live(L, lo, hi):
        n = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
        return torch.arange(L, device=device)[None] < n[:, None]

    ocr = live(ROI_OCR_LEN, 0, ROI_OCR_LEN)
    if short_ocr:
        ocr[::2] = live(ROI_OCR_LEN, 0, 23)[::2]
    mask = torch.cat([live(TEXT_LEN, 5, TEXT_LEN), live(ROI_REGIONS, 1, ROI_REGIONS), ocr], 1)
    return make_attention_mask(mask.long())


def roi_cases(gen, dtype):
    """The ROI cross-encoder at the config's B=128: 12 heads of 64 over 104
    keys, q/k/v in the projections' layout, under ``roi_key_bias``."""
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    L = TEXT_LEN + ROI_REGIONS + ROI_OCR_LEN
    for name, short in (("holes", False), ("empty_tile", True)):
        q, k, v = (torch.randn(ROI_BATCH, L, 12, 64, generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(3))
        yield (f"roi_cross_L{L}_{name}_{tag}", q, k, v,
               roi_key_bias(gen, ROI_BATCH, short_ocr=short))


def temporal_cases(gen, dtype):
    """DMAE's temporal encoder: 8 heads of 64 over 12 frames at B=128 (and 8
    frames at B=4), trailing frames padded by the key bias, in the
    projections' layout."""
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    for B, L, lo in ((128, 12, 8), (4, 8, 2)):
        q, k, v = (torch.randn(B, L, 8, 64, generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(3))
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device="cuda")
        bias = make_attention_mask((torch.arange(L, device="cuda")[None] < lens[:, None]).long())
        yield f"dmae_temporal_B{B}_L{L}_framepad_{tag}", q, k, v, bias


# kernels phase 1 holds to no spills in the build's -Xptxas -v report
NO_SPILL_KERNELS = ("flash_dq128_kernel", "flash_dkv128_kernel")


def phase_build() -> None:
    """Phase 1: build the kernels, then print every kernel's registers and
    spills from the compiler's report beside the library."""
    t0 = time.perf_counter()
    lib = _build.build()
    emit(phase="build", library=lib, seconds=time.perf_counter() - t0)
    with open(lib + ".log") as f:
        report = {name: [r["registers"], r["spill_stores"], r["spill_loads"]]
                  for name, r in _build.ptxas_report(f.read()).items()
                  if r["registers"] is not None}
    emit(phase="build", part="ptxas", registers_spill_stores_spill_loads=report)
    for want in NO_SPILL_KERNELS:
        found = [r for name, r in report.items() if want in name]
        check(len(found) == 1 and found[0][1] == found[0][2] == 0,
              f"{want}: the compiler's report {found}; no spill allowed")


def phase_kernels() -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_main = 0.0
    failed = []
    for name, q, k, v, bias in kernel_cases(gen):
        out = small_attention(q, k, v, bias=bias)
        ref = plain_small_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (FP32_TOL if q.dtype == torch.float32
               else BF16_ULPS * torch.finfo(torch.bfloat16).eps * max(scale, 1.0))
        ok = bool(torch.isfinite(out).all().item()) and err <= tol
        if name.startswith("fully_masked"):
            uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, q.shape[2], -1)
            uerr = (out[0].float() - uniform).abs().max().item()
            ok = ok and uerr <= tol
        emit(phase="kernel_check", case=name, shape=list(q.shape), dtype=str(q.dtype),
             max_abs_err=err, tol=tol, ok=ok)
        if name == "vit_L50_bf16":
            worst_main = err
        if not ok:
            failed.append(name)
    check(not failed, f"kernel disagrees with its plain version: {failed}")
    # a head whose K and V overflow shared memory is refused by the CUDA
    # entry point and raised by the wrapper, never computed another way
    big = torch.zeros(1, 1, 256, 128, device="cuda")
    try:
        small_attention(big, big, big)
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    emit(phase="kernel_check", case="fp32_d128_L256_refused", refusal=refusal)
    check(refusal is not None and "CUDA error" in refusal,
          "an oversize head was not refused by the kernel")
    # the autograd Function: a grad_fn on the card, gradients as fp32
    # autograd of the plain version on the same bf16 values
    q, k, v = (t.detach().requires_grad_() for t in next(kernel_cases(gen))[1:4])
    out = small_attention(q, k, v)
    check(out.grad_fn is not None, "small_attention's output has no grad_fn on the card")
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(dout)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    plain_small_attention(*leaves).backward(dout.float())
    errs = grad_errs((q, k, v), leaves, "qkv")
    ok = all(e <= tol for e, tol in errs.values())
    emit(phase="kernel_check", case="vit_L50_bf16_autograd", grad_fn=out.grad_fn.name(),
         max_abs_err={n: e for n, (e, _) in errs.items()},
         tol={n: t for n, (_, t) in errs.items()}, ok=ok)
    check(ok, "small_attention's gradients disagree with fp32 autograd")
    # the same at DMAE's temporal shapes and the ROI cross-encoder's, bf16
    # and fp32, with their key biases
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias in (*temporal_cases(gen, dtype), *roi_cases(gen, dtype)):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = small_attention(q, k, v, bias=bias)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            out.backward(dout)
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            plain_small_attention(*leaves, bias=bias).backward(dout.float())
            errs = (grad_errs((q, k, v), leaves, "qkv") if dtype == torch.bfloat16 else
                    {f"d{n}": (max_err(a.grad, b.grad),
                               FP32_TOL * max(b.grad.abs().max().item(), 1.0))
                     for a, b, n in zip((q, k, v), leaves, "qkv")})
            ok = out.grad_fn is not None and all(e <= t for e, t in errs.values())
            emit(phase="kernel_check", case=f"{name}_autograd",
                 max_abs_err={n: e for n, (e, _) in errs.items()},
                 tol={n: t for n, (_, t) in errs.items()}, ok=ok)
            check(ok, f"small_attention's gradients disagree with fp32 autograd at {name}")
    return worst_main


def ulps_tol(ref: torch.Tensor, ulps: float) -> float:
    """``ulps`` bf16 roundings at the reference's largest magnitude (≥ 1)."""
    return ulps * torch.finfo(torch.bfloat16).eps * max(ref.float().abs().max().item(), 1.0)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def grad_errs(got, ref, names, ulps=BF16_ULPS):
    """{d<name>: (max error, tolerance)} of ``got``'s grads against ``ref``'s."""
    return {f"d{n}": (max_err(a.grad, b.grad), ulps_tol(b.grad, ulps))
            for a, b, n in zip(got, ref, names)}


# ------------------------------------------------------ phase 2: flash kernels
def flash_cases(gen):
    """(name, q, k, v, key bias [B, 1, 1, Lk] or None, causal); q/k/v in the
    [B, L, H, D] projection layout seen as [B, H, L, D], as on the path."""
    dev, fmin = "cuda", torch.finfo(torch.float32).min

    def proj(B, L, H, D):
        return torch.randn(B, L, H, D, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)

    def ragged(B, L, lo):
        lens = torch.randint(lo, L + 1, (B,), generator=gen, device=dev)
        return make_attention_mask((torch.arange(L, device=dev)[None] < lens[:, None]).long())

    yield "cross_L430_ragged", proj(64, 430, 12, 64), proj(64, 430, 12, 64), \
        proj(64, 430, 12, 64), ragged(64, 430, 30), False
    # a pretraining pass's pair stream: 30 text keys with ragged padding, then
    # 400 live visual keys, 128 pairs
    text_then_frames = torch.cat([ragged(128, 30, 8), torch.zeros(128, 1, 1, 400, device=dev)], -1)
    yield "pretrain_L430_text_ragged", proj(128, 430, 12, 64), proj(128, 430, 12, 64), \
        proj(128, 430, 12, 64), text_then_frames, False
    # stage-2 re-ranking (retrieval_trainer): a chunk of 32 pairs and a tail
    # chunk of 5, 30 ragged text keys then 400 live visual keys
    for P, name in ((32, "stage2_L430_text_ragged"), (5, "stage2_tail_L430_text_ragged")):
        stream = torch.cat([ragged(P, 30, 8), torch.zeros(P, 1, 1, 400, device=dev)], -1)
        yield name, proj(P, 430, 12, 64), proj(P, 430, 12, 64), proj(P, 430, 12, 64), \
            stream, False
    yield "lq120_lk430_ragged", proj(8, 120, 12, 64), proj(8, 430, 12, 64), \
        proj(8, 430, 12, 64), ragged(8, 430, 100), False
    yield "causal_L430", proj(8, 430, 12, 64), proj(8, 430, 12, 64), proj(8, 430, 12, 64), \
        None, True
    masked = ragged(4, 300, 1)
    masked[0] = fmin  # every key of sample 0 masked
    yield "fully_masked_L300", proj(4, 300, 12, 64), proj(4, 300, 12, 64), \
        proj(4, 300, 12, 64), masked, False
    yield "d32_lq70_lk290", proj(4, 70, 8, 32), proj(4, 290, 8, 32), proj(4, 290, 8, 32), \
        ragged(4, 290, 1), False
    yield "d128_L270_causal", proj(4, 270, 6, 128), proj(4, 270, 6, 128), \
        proj(4, 270, 6, 128), ragged(4, 270, 1), True
    # the forward's two-stage ring: one tile, exactly one, a one-key last
    # tile, an odd count of tiles
    for Lk in (63, 64, 65, 129):
        yield f"lq200_lk{Lk}_ragged", proj(4, 200, 12, 64), proj(4, Lk, 12, 64), \
            proj(4, Lk, 12, 64), ragged(4, Lk, 1), False
    yield "causal_lq200_lk330", proj(4, 200, 12, 64), proj(4, 330, 12, 64), \
        proj(4, 330, 12, 64), ragged(4, 330, 1), True
    yield "causal_lq330_lk200", proj(4, 330, 12, 64), proj(4, 200, 12, 64), \
        proj(4, 200, 12, 64), None, True
    # the backward's 64-row query tiles and its two-stage ring over them: one
    # tile, exactly one, a one-row last tile, an odd count of tiles; and the
    # dK/dV causal start tile crossed with a key bias present
    for Lq in (63, 64, 65, 129):
        yield f"lq{Lq}_lk200_ragged", proj(4, Lq, 12, 64), proj(4, 200, 12, 64), \
            proj(4, 200, 12, 64), ragged(4, 200, 1), False
    yield "causal_lq330_lk200_ragged", proj(4, 330, 12, 64), proj(4, 200, 12, 64), \
        proj(4, 200, 12, 64), ragged(4, 200, 1), True
    yield "pink_prefill_L113_d128_causal", proj(1, 113, 16, 128), proj(1, 113, 16, 128), \
        proj(1, 113, 16, 128), None, True
    # pink_eval's batch prefill (phase 11c): 8 rows of 49 vision keys and
    # 16..64 text keys, right-padded, causal
    text = torch.randint(16, PINK_PROMPT_LEN + 1, (EVAL_BATCH,), generator=gen, device=dev)
    live = torch.cat([torch.ones(EVAL_BATCH, PINK_PATCHES, dtype=torch.bool, device=dev),
                      torch.arange(PINK_PROMPT_LEN, device=dev)[None] < text[:, None]], 1)
    L = PINK_PATCHES + PINK_PROMPT_LEN
    yield f"pink_eval_prefill_B{EVAL_BATCH}_L{L}_d128_causal_ragged", \
        proj(EVAL_BATCH, L, 16, 128), proj(EVAL_BATCH, L, 16, 128), \
        proj(EVAL_BATCH, L, 16, 128), make_attention_mask(live.long()), True
    # the D=128 backward (Pink's width): its two-stage rings over keys (dQ)
    # and queries (dK/dV) at one tile, exactly one, a one-row last tile and
    # an odd count; causal with Lq != Lk both ways
    for L in (63, 64, 65, 129):
        yield f"d128_L{L}_ragged", proj(4, L, 16, 128), proj(4, L, 16, 128), \
            proj(4, L, 16, 128), ragged(4, L, 1), False
    yield "d128_causal_lq200_lk330_ragged", proj(4, 200, 16, 128), proj(4, 330, 16, 128), \
        proj(4, 330, 16, 128), ragged(4, 330, 1), True
    yield "d128_causal_lq330_lk200_ragged", proj(4, 330, 16, 128), proj(4, 200, 16, 128), \
        proj(4, 200, 16, 128), ragged(4, 200, 1), True
    # the tile skipping's cases: every key of sample 0 masked (uniform rows);
    # leading keys masked under causal, so the first rows are fully masked (10
    # rows in sample 0; 100 in sample 1, whose first key block is all masked
    # and seen by them); whole key blocks masked with no fully masked row
    # (49 live keys, then 0, 8, 80 and 256 live text keys), causal and not
    masked = ragged(4, 300, 1)
    masked[0] = fmin
    yield "fully_masked_L300_d128", proj(4, 300, 16, 128), proj(4, 300, 16, 128), \
        proj(4, 300, 16, 128), masked, False
    lead = ragged(4, 300, 150)
    lead[0, ..., :10] = fmin
    lead[1, ..., :100] = fmin
    yield "d128_causal_leading_keys_masked_L300", proj(4, 300, 16, 128), \
        proj(4, 300, 16, 128), proj(4, 300, 16, 128), lead, True
    text = torch.tensor([0, 8, 80, 256], device=dev)
    live = torch.cat([torch.ones(4, PINK_PATCHES, dtype=torch.bool, device=dev),
                      torch.arange(PINK_TRAIN_TEXT, device=dev)[None] < text[:, None]], 1)
    L = PINK_PATCHES + PINK_TRAIN_TEXT
    for causal in (True, False):
        yield f"d128_dead_key_blocks_L{L}{'_causal' if causal else ''}", proj(4, L, 16, 128), \
            proj(4, L, 16, 128), proj(4, L, 16, 128), make_attention_mask(live.long()), causal
    # M2-omni's prefill (phase 19): one right-padded prompt of 640 tokens,
    # causal, 32 heads of 128, k/v the 8 kv heads repeated
    q, k, v, bias = m2_prefill_qkv(gen)
    yield "m2_prefill_L640_h32_d128_causal_padded", q, k, v, bias, True
    # M2-omni's training micro-batch (phase 20): 4 right-padded conversations
    # of 640 slots, causal, 32 heads of 128, k/v the 8 kv heads repeated
    q, k, v, bias = m2_train_qkv(gen)
    yield "m2_train_L640_h32_d128_causal_ragged", q, k, v, bias, True
    # Pink's training step (phase 17): 49 vision keys then 256 text keys with
    # ragged padding, causal, 16 heads of 128, k/v the 4 kv heads repeated
    q, k, v, bias = pink_train_qkv(gen, PINK_TRAIN_BATCH)
    yield "pink_train_L305_d128_causal_ragged", q, k, v, bias, True
    # pink_7b.yml's step (phase 18): 256 EVA keys then 256 text keys with
    # ragged padding, causal, 32 heads of 128, k/v the 8 kv heads repeated
    q, k, v, bias = pink_train_qkv(gen, PINK_TRAIN_BATCH, heads=PINK_7B_HEADS)
    yield f"pink_7b_train_L{q.shape[2]}_h32_d128_causal_ragged", q, k, v, bias, True


# Pink's causal training shapes at D=128: (heads, kv heads, vision tokens)
# of omni_1b behind ViT-B/32 (phase 17) and of pink_7b.yml's omni_7b behind
# EVA-CLIP-g (phase 18), each before 256 text tokens
PINK_1B_HEADS, PINK_7B_HEADS = (16, 4, PINK_PATCHES), (32, 8, (SIZE // 14) ** 2)


def pink_train_qkv(gen, B: int, kv_leaves: bool = False, heads=PINK_1B_HEADS):
    """q [B, H, L, 128] in the projection layout, k and v the [B, kv, L,
    128] kv heads repeated to H as the decoder repeats them (with
    ``kv_leaves``, the kv heads themselves), and the key-padding bias [B, 1,
    1, L]: the vision keys live, then 256 text keys of which 8..256 live;
    (H, kv, vision tokens) = ``heads``, L = vision + 256."""
    (H, n_kv, vision), dev = heads, "cuda"
    L = vision + PINK_TRAIN_TEXT
    q = torch.randn(B, L, H, 128, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    kv = [torch.randn(B, L, n_kv, 128, generator=gen, device=dev).to(torch.bfloat16)
          .transpose(1, 2).contiguous() for _ in range(2)]
    lens = torch.randint(8, PINK_TRAIN_TEXT + 1, (B,), generator=gen, device=dev)
    live = torch.cat([torch.ones(B, vision, dtype=torch.bool, device=dev),
                      torch.arange(PINK_TRAIN_TEXT, device=dev)[None] < lens[:, None]], 1)
    bias = make_attention_mask(live.long())
    if kv_leaves:
        return q, kv[0], kv[1], bias
    return (q, *(t.repeat_interleave(H // n_kv, dim=1) for t in kv), bias)


def m2_prefill_qkv(gen, live: int = 430):
    """M2-omni's causal prefill at its serving length: q [1, 32, 640, 128] in
    the projection layout, k and v the 8 kv heads repeated to 32 as the
    decoder repeats them, and the key-padding bias [1, 1, 1, 640] of a
    right-padded prompt of ``live`` tokens."""
    dev, L = "cuda", SERVING_SEQ_LEN
    q = torch.randn(1, L, 32, 128, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    kv = [torch.randn(1, L, 8, 128, generator=gen, device=dev).to(torch.bfloat16)
          .transpose(1, 2).repeat_interleave(4, dim=1) for _ in range(2)]
    bias = make_attention_mask((torch.arange(L, device=dev)[None] < live).long())
    return (q, *kv, bias)


def m2_train_qkv(gen, B: int = 4, lo: int = 300):
    """M2-omni's training micro-batch at its 640 slots: q [B, 32, 640, 128]
    in the projection layout, k and v the 8 kv heads repeated to 32, and the
    key-padding bias [B, 1, 1, 640] of right-padded conversations of ``lo``
    to 640 live slots."""
    dev, L = "cuda", SERVING_SEQ_LEN
    q = torch.randn(B, L, 32, 128, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    kv = [torch.randn(B, L, 8, 128, generator=gen, device=dev).to(torch.bfloat16)
          .transpose(1, 2).repeat_interleave(4, dim=1) for _ in range(2)]
    lens = torch.randint(lo, L + 1, (B,), generator=gen, device=dev)
    bias = make_attention_mask((torch.arange(L, device=dev)[None] < lens[:, None]).long())
    return (q, *kv, bias)


def pink_gqa_gradients(gen, heads=PINK_1B_HEADS) -> dict:
    """The ``flash_attention`` Function as the decoder calls it (causal, the
    ragged key bias, k/v repeated from the kv heads inside the graph) against
    fp32 autograd of ``plain_flash_attention`` on the same graph: the output
    and the gradients of q and of the kv heads. A kv head's gradient sums
    the query heads of its group (4), each rounded to bf16 first, so it is
    held to FLASH_AUTOGRAD_ULPS plus one rounding per summand."""
    q, k4, v4, bias = pink_train_qkv(gen, 2, kv_leaves=True, heads=heads)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    rep = heads[0] // heads[1]

    def run(leaves, fn):
        q_, k_, v_ = leaves
        out = fn(q_, k_.repeat_interleave(rep, dim=1), v_.repeat_interleave(rep, dim=1),
                 bias=bias, causal=True)
        out.backward(dout.to(out.dtype))
        return out

    leaves = [t.detach().requires_grad_() for t in (q, k4, v4)]
    out = run(leaves, flash_attention)
    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k4, v4)]
    ref = run(ref_leaves, plain_flash_attention)
    errs = {"out": (max_err(out, ref), ulps_tol(ref, FLASH_AUTOGRAD_ULPS)),
            "dq": (max_err(leaves[0].grad, ref_leaves[0].grad),
                   ulps_tol(ref_leaves[0].grad, FLASH_AUTOGRAD_ULPS))}
    for i, n in ((1, "dk_kv_heads"), (2, "dv_kv_heads")):
        errs[n] = (max_err(leaves[i].grad, ref_leaves[i].grad),
                   ulps_tol(ref_leaves[i].grad, FLASH_AUTOGRAD_ULPS + rep))
    return errs


def phase_flash() -> dict:
    """Each flash kernel against its plain version on the same inputs, and
    the autograd Function against fp32 autograd of the plain semantics.
    Returns each kernel's largest error over the training paths' cases
    (cross-mined and pretraining)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    failed, main = [], {}
    for name, q, k, v, bias, causal in flash_cases(gen):
        B, H, Lq, D = q.shape
        scale = D ** -0.5
        kb = key_bias(bias, B, k.shape[2])
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        out, stats = flash_fwd(q, k, v, kb, scale, causal)
        r_out, r_stats = plain_flash_fwd(q, k, v, kb, scale, causal)
        dq, delta = flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
        r_dq, r_delta = plain_flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
        dk, dv = flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        r_dk, r_dv = plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        torch.cuda.synchronize()
        errs = {"out": (max_err(out, r_out), ulps_tol(r_out, FLASH_ULPS)),
                "dq": (max_err(dq, r_dq), ulps_tol(r_dq, FLASH_ULPS)),
                "dk": (max_err(dk, r_dk), ulps_tol(r_dk, FLASH_ULPS)),
                "dv": (max_err(dv, r_dv), ulps_tol(r_dv, FLASH_ULPS)),
                # row statistics and delta: fp32 sums in another order
                "lse": (max_err(stats[0] + stats[1], r_stats[0] + r_stats[1]), 1e-3),
                "delta": (max_err(delta, r_delta), 1e-3 * max(r_delta.abs().max().item(), 1.0))}
        # the Function (what the path calls) against fp32 autograd
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        f_out = flash_attention(*leaves, bias=bias, causal=causal)
        grad_fn = f_out.grad_fn.name() if f_out.grad_fn is not None else None
        f_out.backward(dout)
        ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref = plain_flash_attention(*ref_leaves, bias=bias, causal=causal)
        ref.backward(dout.float())
        auto = {"out": (max_err(f_out, ref), ulps_tol(ref, FLASH_AUTOGRAD_ULPS)),
                **grad_errs(leaves, ref_leaves, "qkv", FLASH_AUTOGRAD_ULPS)}
        finite = all(bool(torch.isfinite(t).all().item()) for t in (out, dq, dk, dv))
        ok = finite and grad_fn is not None and all(e <= t for e, t in errs.values()) \
            and all(e <= t for e, t in auto.values())
        if name.startswith("fully_masked"):
            uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, Lq, -1)
            uerr = max_err(out[0], uniform)
            ok = ok and uerr <= ulps_tol(uniform, FLASH_ULPS)
            errs["uniform_row"] = (uerr, ulps_tol(uniform, FLASH_ULPS))
        emit(phase="flash_check", case=name, q=list(q.shape), k=list(k.shape), causal=causal,
             grad_fn=grad_fn, finite=finite,
             vs_plain={n: e for n, (e, _) in errs.items()},
             vs_plain_tol={n: t for n, (_, t) in errs.items()},
             vs_fp32_autograd={n: e for n, (e, _) in auto.items()},
             vs_fp32_autograd_tol={n: t for n, (_, t) in auto.items()}, ok=ok)
        if name in ("cross_L430_ragged", "pretrain_L430_text_ragged"):  # the training paths
            for kernel, err in (("flash_fwd", errs["out"][0]), ("flash_dq", errs["dq"][0]),
                                ("flash_dkv", max(errs["dk"][0], errs["dv"][0]))):
                main[kernel] = max(main.get(kernel, 0.0), err)
        if not ok:
            failed.append(name)
    for case, heads in (("pink_train", PINK_1B_HEADS), ("pink_7b_train", PINK_7B_HEADS)):
        gqa = pink_gqa_gradients(gen, heads)
        ok = all(e <= t for e, t in gqa.values())
        emit(phase="flash_check", case=f"{case}_gqa_function_d128_causal_ragged",
             q=[2, heads[0], heads[2] + PINK_TRAIN_TEXT, 128], kv_heads=heads[1], causal=True,
             vs_fp32_autograd={n: e for n, (e, _) in gqa.items()},
             vs_fp32_autograd_tol={n: t for n, (_, t) in gqa.items()}, ok=ok)
        if not ok:
            failed.append(f"{case}_gqa_function")
    check(not failed, f"flash kernels disagree with their plain versions: {failed}")
    # a dtype the kernels do not take raises on the card, never runs plain
    x = torch.zeros(2, 2, 300, 64, device="cuda", dtype=torch.float16)
    try:
        flash_attention(x, x, x)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    emit(phase="flash_check", case="fp16_refused", refusal=refusal)
    check(refusal is not None, "flash_attention took a dtype its kernels do not take")
    return main


# -------------------------------------------------------- phase 2: int4 GEMV
def random_record(gen, fin_w: int, fout: int, group: int):
    """Random packed bytes and positive scales, made on the card."""
    packed = torch.randint(0, 256, (fin_w // 2, fout), generator=gen, device="cuda",
                           dtype=torch.uint8)
    scale = torch.rand(fin_w // group, fout, generator=gen, device="cuda") * 0.01 + 0.005
    return packed, scale


def int4_agrees(case: str, x, packed, scale, dense, **info):
    """One ``int4_gemv`` call against ``plain_int4_gemv`` and against
    ``unpack_int4`` + matmul in fp32 (``dense``). Returns (ok, error
    against the plain version)."""
    y = int4_gemv(x, packed, scale)
    ref = plain_int4_gemv(x, packed, scale)
    ref_dense = F.pad(x.float(), (0, dense.shape[0] - x.shape[1])) @ dense
    torch.cuda.synchronize()
    e_plain, e_dense = max_err(y, ref), max_err(y, ref_dense)
    tol = INT4_TOL * max(ref.abs().max().item(), 1.0)
    ok = bool(torch.isfinite(y).all().item()) and y.dtype == torch.float32 \
        and tuple(y.shape) == (x.shape[0], packed.shape[1]) and e_plain <= tol and e_dense <= tol
    emit(phase="int4_check", case=case, x=list(x.shape), x_row_stride=x.stride(0),
         record=[dense.shape[0], packed.shape[1]], dtype=str(x.dtype), vs_plain=e_plain,
         vs_unpack_matmul=e_dense, tol=tol, ok=ok, **info)
    return ok, e_plain


def phase_int4() -> float:
    """``int4_gemv`` against ``plain_int4_gemv`` and against ``unpack_int4`` +
    matmul in fp32, at the decode path's shapes and at the edges of the
    kernel's geometry (``INT4_EDGES``); two replays of one graph bit for bit;
    two refusals. Returns the worst error against the plain version at one
    row of bf16 x, the main path's case."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    failed, worst_main = [], 0.0
    for name, (fin_x, fin_w, fout, group) in INT4_SHAPES.items():
        packed, scale = random_record(gen, fin_w, fout, group)
        dense = unpack_int4(packed, scale, torch.float32)
        for rows in (1, 8, 32):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(rows, fin_x, generator=gen, device="cuda").to(dtype)
                ok, err = int4_agrees(name, x, packed, scale, dense, group=group)
                if rows == 1 and dtype == torch.bfloat16:
                    worst_main = max(worst_main, err)
                if not ok:
                    failed.append(f"{name}_{rows}_{dtype}")
        del dense
    for name, rows, fin_x, fin_w, fout, group, stride in INT4_EDGES:
        packed, scale = random_record(gen, fin_w, fout, group)
        dense = unpack_int4(packed, scale, torch.float32)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, stride, generator=gen, device="cuda").to(dtype)[:, :fin_x]
            if not int4_agrees(name, x, packed, scale, dense, group=group)[0]:
                failed.append(f"{name}_{dtype}")
    check(not failed, f"int4_gemv disagrees with its plain version: {failed}")
    # determinism: one graph of K8 launches replayed twice, bit for bit (the
    # K split summed across a cluster in rank order, no atomics)
    for name, rows in (("attn_q_o", 1), ("mlp_down", 8)):
        fin_x, fin_w, fout, group = INT4_SHAPES[name]
        packed, scale = random_record(gen, fin_w, fout, group)
        x = torch.randn(rows, fin_x, generator=gen, device="cuda").to(torch.bfloat16)
        int4_gemv(x, packed, scale)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = int4_gemv(x, packed, scale)
        graph.replay()
        first = y.clone()
        graph.replay()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, y))
        emit(phase="int4_check", case=f"graph_replays_{name}_{rows}_rows", bitwise_equal=same)
        check(same, f"int4_gemv gave two answers to one input ({name}, {rows} rows)")
    # more rows than the kernel takes raise in the wrapper; an x too wide to
    # stage in shared memory is refused by the CUDA entry point
    packed, scale = random_record(gen, 2048, 512, 128)
    refusals = {}
    for case, x, rec, error in (
            ("33_rows", torch.zeros(33, 2048, device="cuda"), (packed, scale), ValueError),
            ("x_of_131072_columns", torch.zeros(1, 131072, device="cuda"),
             random_record(gen, 131072, 8, 128), RuntimeError)):
        try:
            int4_gemv(x, *rec)
            refusals[case] = None
        except error as e:
            refusals[case] = str(e)
    emit(phase="int4_check", case="refusals", refusals=refusals)
    check(all(refusals.values()) and "CUDA error" in refusals["x_of_131072_columns"],
          "int4_gemv took an input its kernel does not take")
    return worst_main


# ------------------------------------------------------------------ phase 3
def request(rng, caption="a person is cooking in a kitchen"):
    frames = rng.random((FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    return {"caption": caption, "image_data": frames}


def serve(r: int, device: str = "cuda", extra=()):
    argv = ["--config", CONFIG, "--no_ckpt", "--device", device,
            "model_attributes.univl_retrieval.token_merge_r", str(r), *extra]
    predictor, _ = build_predictor(argv)
    return predictor


def phase_serving(rng):
    """Drive predict / predict_batch at r=8 and r=0; returns the predictors and
    the total kernel launches of this phase."""
    predictors, launches = {}, 0
    captions = ["a dog runs on the beach", "two people play tennis", "a man cooks pasta",
                "cars drive through a city at night", "a cat sleeps on a sofa",
                "children swim in a pool", "a woman plays the violin", "snow falls on trees"]
    for r in (8, 0):
        t0 = time.perf_counter()
        pred = serve(r)
        load_s = time.perf_counter() - t0
        small_attention.launches = 0
        t0 = time.perf_counter()
        one = pred.predict(request(rng))
        t_one = time.perf_counter() - t0
        n_one = small_attention.launches
        small_attention.launches = 0
        reqs = [request(rng, c) for c in captions]
        t0 = time.perf_counter()
        many = pred.predict_batch(reqs)
        t_many = time.perf_counter() - t0
        n_many = small_attention.launches
        launches += n_one + n_many
        check(n_one == 24 and n_many == 24,
              f"r={r}: kernel launches per forward {n_one}, {n_many}; expected 24")
        sim = np.asarray(one["sim"])
        te = np.asarray(one["text_embed"])
        rows = [np.asarray(m["sim"]) for m in many]
        norms = [float(np.linalg.norm(m["text_embed"])) for m in many]
        check(sim.shape == (1, 1) and te.shape == (1, 512), f"r={r}: predict shapes")
        check(all(x.shape == (8,) for x in rows), f"r={r}: predict_batch sim rows")
        check(all(np.isfinite(np.asarray(v)).all() for v in one.values()), f"r={r}: finite")
        check(all(np.isfinite(np.asarray(v)).all() for m in many for v in m.values()),
              f"r={r}: finite batch")
        check(abs(float(np.linalg.norm(te)) - 1) < 1e-3 and
              all(abs(n - 1) < 1e-3 for n in norms), f"r={r}: text_embed norms")
        emit(phase="serving", token_merge_r=r, load_s=load_s, predict_s=t_one,
             predict_batch8_s=t_many, launches_per_forward=[n_one, n_many],
             sim_b1=float(sim[0, 0]), sim_row0=rows[0].tolist())
        predictors[r] = pred
    return predictors, launches


# ------------------------------------------------------------------ phase 4
def compare(a, b):
    """Card outputs ``a`` against CPU outputs ``b``: per-row cosine of both
    embeddings and the largest |Δsim|."""
    def cos(x, y):
        x, y = x.reshape(-1).astype(np.float64), y.reshape(-1).astype(np.float64)
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))

    return dict(text_cos=cos(a["text_embed"], b["text_embed"]),
                visual_cos=cos(a["visual_embed"], b["visual_embed"]),
                max_abs_dsim=float(np.abs(a["sim"] - b["sim"]).max()),
                sim_card=float(a["sim"].reshape(-1)[0]), sim_cpu=float(b["sim"].reshape(-1)[0]))


def within_bound(res) -> bool:
    return res["text_cos"] >= COS_MIN and res["visual_cos"] >= COS_MIN \
        and res["max_abs_dsim"] <= DSIM_MAX


def cpu_twin():
    return serve(0, "cpu", ("model_attributes.univl_retrieval.dtype_str", "float32"))


def phase_card_vs_cpu(card, rng):
    cpu = cpu_twin()
    arrays = card.build_sample(request(rng)).arrays()
    res = compare(card.forward(arrays), cpu.forward(arrays))
    ok = within_bound(res)
    emit(phase="card_vs_cpu", token_merge_r=0, **res, cos_min=COS_MIN, dsim_max=DSIM_MAX,
         ok=ok)
    check(ok, "card and CPU disagree beyond the stated bound")


def planted_faults(module):
    """Path-level faults, planted on the card's model only, each undone after
    its forward: (name, plant, undo)."""
    from antmmf_torch.modules import layers
    from antmmf_torch.modules.encoders import text_encoder

    vit_mlps = [m for m in module.base.img_encoder.modules() if isinstance(m, layers.Mlp)]
    bert_norms = [m for m in module.base.text_encoder.modules()
                  if isinstance(m, layers.LayerNorm)]

    def set_mask(fn):
        text_encoder.make_attention_mask = fn

    def set_act(fn):
        for m in vit_mlps:
            m.act = fn

    def set_eps(eps):
        for m in bert_norms:
            m.epsilon = eps

    return [
        ("bert_key_bias_dropped", lambda: set_mask(lambda mask: None),
         lambda: set_mask(layers.make_attention_mask)),
        ("vit_quick_gelu_as_exact_gelu", lambda: set_act(layers.ACTIVATIONS["gelu_exact"]),
         lambda: set_act(layers.ACTIVATIONS["quick_gelu"])),
        ("bert_layernorm_eps_1e-5", lambda: set_eps(1e-5), lambda: set_eps(1e-12)),
    ]


def calibrate(seeds=5) -> None:
    """Phase 4's readings behind its bound: the card-vs-CPU gap of sound runs
    over several weight seeds, and of planted faults at seed 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    card, cpu = serve(0), cpu_twin()
    sound = []
    for seed in range(seeds):
        card.shell.init(seed)
        cpu.shell.init(seed)
        arrays = card.build_sample(request(rng)).arrays()
        ref = cpu.forward(arrays)
        res = compare(card.forward(arrays), ref)
        sound.append(res)
        emit(phase="calibrate", kind="sound", seed=seed, **res, within_bound=within_bound(res))
    for name, plant, undo in planted_faults(card.shell.module):
        plant()
        try:
            res = compare(card.forward(arrays), ref)
        finally:
            undo()
        emit(phase="calibrate", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=within_bound(res))
    emit(phase="calibrate", kind="sound_worst", seeds=seeds,
         min_cos=min(min(r["text_cos"], r["visual_cos"]) for r in sound),
         max_abs_dsim=max(r["max_abs_dsim"] for r in sound),
         cos_min=COS_MIN, dsim_max=DSIM_MAX)


# ------------------------------------------------------------------ phase 5
def train_config(model: dict, dtype: str = "bfloat16") -> dict:
    """bench.py's training configuration, with ``model`` on top."""
    return {"model_attributes": {"univl_retrieval": {
                "vit_preset": "vit_base_patch32", "bert_preset": "bert_base",
                "image_size": SIZE, "embed_dim": 512, "n_clips": 1, "dtype_str": dtype,
                **model}},
            "optimizer_attributes": {"type": "adam_w", "params": {
                "lr": 5e-5, "weight_decay": 0.01, "mu_dtype": "bfloat16"}},
            "training_parameters": {"clip_gradients": True, "max_grad_l2_norm": 1.0}}


def train_batch(B: int, seed: int) -> dict:
    """bench.py's batch (8 frames of 224², ids of 30 tokens) with ragged
    captions, so the key-padding biases are live."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, TEXT_LEN + 1, B)
    mask = (np.arange(TEXT_LEN)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, FRAMES, SIZE, SIZE, 3)).astype(np.float32),
            "video_mask": np.ones((B, FRAMES), np.int64),
            "caption_input_ids": rng.integers(1, 30522, (B, TEXT_LEN)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, TEXT_LEN), np.int64)}


def trainer(model: dict, device: str = "cuda", dtype: str = "bfloat16", seed: int = SEED,
            masters=None):
    """(shell, state, train_step) through the port's training entry points;
    seeded random weights unless fp32 ``masters`` are given."""
    cfg = train_config(model, dtype)
    shell = build_model(cfg, device=device)
    if masters is None:
        shell.init(seed)
    tx, _ = build_optimizer(flax_paths(shell.module), cfg["optimizer_attributes"],
                            cfg["training_parameters"])
    return shell, TrainState.create(shell.module, tx, masters), make_train_step(shell, tx)


def device_ms_by_name(prof, iters: int):
    """({device operation name: ms}, device operations), per iteration."""
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return by_name, len(ops) / iters


def device_busy(prof, iters: int):
    """(device-busy ms, device operations, top operations by ms), per iteration."""
    by_name, n_ops = device_ms_by_name(prof, iters)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), n_ops, [[n[:90], ms] for n, ms in top]


def phase_training(gpu: str):
    """Both training legs; returns the path's launches by kernel, the
    cross-encoder's pair key bias (for phase 7's timing) and the flagship
    step's p50 in ms (for phase 12)."""
    from torch.profiler import ProfilerActivity, profile

    totals = dict.fromkeys(STEP_LAUNCHES["flagship"], 0)
    pair_bias, p50s = None, {}
    for leg, (model, B) in TRAIN_LEGS.items():
        t0 = time.perf_counter()
        shell, state, step = trainer(model)
        batch = shell.to_device(train_batch(B, SEED + 1))
        setup_s = time.perf_counter() - t0
        losses, times, counts = [], [], []
        for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, scalars = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(read_counts())
            losses.append(float(scalars["total_loss"]))
            for name, n in counts[-1].items():
                totals[name] += n
        timed = times[TRAIN_WARMUP:]
        p50 = float(np.percentile(timed, 50))
        p50s[leg] = p50
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
        busy, n_ops, top = device_busy(prof, 2)
        emit(phase="training", leg=leg, batch=B, gpu=gpu, setup_s=setup_s, losses=losses,
             step_ms=times, step_p50_ms=p50, step_p95_ms=float(np.percentile(timed, 95)),
             clip_pairs_per_s=B * len(timed) * 1e3 / float(np.sum(timed)),
             launches_per_step=counts[-1],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             device_busy_ms=busy if n_ops else "not measured",
             device_idle_share=1 - busy / p50 if n_ops else "not measured",
             device_ops_per_step=n_ops, top_device_ops_ms=top)
        check(all(np.isfinite(losses)), f"{leg}: a loss is not finite")
        check(losses[-1] < losses[0], f"{leg}: the loss did not fall ({losses})")
        check(all(c == STEP_LAUNCHES[leg] for c in counts),
              f"{leg}: launches per step {counts[-1]}; expected {STEP_LAUNCHES[leg]}")
        if model.get("with_cross_encoder"):
            k = model["hard_mining_k"]
            text = batch["caption_input_mask"].repeat_interleave(k, dim=0)
            pair_bias = make_attention_mask(torch.cat(
                [text, torch.ones(B * k, FRAMES * VIT_TOKENS, dtype=text.dtype, device="cuda")], 1))
        del shell, state, step, batch
        torch.cuda.empty_cache()
    return totals, pair_bias, p50s["flagship"]


# ------------------------------------------------------------------ phase 6
def first_step(shell, batch):
    """The first training step's loss and fp32 gradients by parameter name."""
    for p in shell.module.parameters():
        p.grad = None
    loss, _ = shell.loss_fn(batch, deterministic=False)
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in shell.module.named_parameters()
                         if p.grad is not None}


def compare_steps(card, cpu):
    """Card (loss, grads) against CPU (loss, grads): |Δloss|, the cosine of
    all gradients together and the least per-parameter cosine. A parameter
    whose CPU gradient is below 1e-3 of the median parameter's (the key
    projections' biases, whose exact gradient is 0) is left out and listed."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    norms = {n: g.norm().item() for n, g in g_cpu.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    cos, skipped = {}, []
    for n, g in g_cpu.items():
        if n not in g_card:
            cos[n] = 0.0  # a gradient the card never produced
        elif norms[n] <= floor:
            skipped.append(n)
        else:
            cos[n] = torch.nn.functional.cosine_similarity(
                g_card[n].double().reshape(-1), g.double().reshape(-1), dim=0).item()
    flat = [torch.cat([d[n].double().reshape(-1) for n in g_cpu]) if all(n in d for n in g_cpu)
            else None for d in (g_card, g_cpu)]
    overall = (torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0).item()
               if flat[0] is not None else 0.0)
    worst = min(cos, key=cos.get)
    return dict(loss_card=l_card, loss_cpu=l_cpu, abs_dloss=abs(l_card - l_cpu),
                grad_cos_all=overall, grad_cos_min=cos[worst], worst_param=worst,
                params_compared=len(cos), params_skipped=skipped)


def train_within_bound(res) -> bool:
    return res["grad_cos_all"] >= GRAD_COS_ALL and res["grad_cos_min"] >= GRAD_COS_MIN \
        and res["abs_dloss"] <= DLOSS_MAX


def train_twins(seed: int):
    """The cross-mined model on the CPU in fp32 (plain versions) and on the
    card in bf16, on the same fp32 master weights, and a B=4 batch."""
    cpu, cpu_state, _ = trainer(CROSS, "cpu", "float32", seed)
    card, _, _ = trainer(CROSS, masters=cpu_state.params)
    batch = train_batch(4, SEED + 2)
    return card, cpu, batch


def phase_train_card_vs_cpu():
    card, cpu, batch = train_twins(SEED)
    res = compare_steps(first_step(card, batch), first_step(cpu, batch))
    ok = train_within_bound(res)
    emit(phase="train_card_vs_cpu", batch=4, **res, grad_cos_all_bound=GRAD_COS_ALL,
         grad_cos_min_bound=GRAD_COS_MIN, dloss_max=DLOSS_MAX, ok=ok)
    check(ok, "card and CPU training steps disagree beyond the stated bound")


def train_faults():
    """Faults planted on the card's path only, each undone after its step:
    (name, plant, undo)."""
    from antmmf_torch.models import univl
    from antmmf_torch.modules import attention

    real_dkv, real_mask, real_small = fa.flash_dkv, univl.make_attention_mask, \
        attention.small_attention

    def dv_unnormalised(q, k, v, kb, stats, dout, delta, scale, causal):
        dk, _ = real_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
        raw = torch.stack([stats[0], torch.zeros_like(stats[1])])  # log l = 0
        return dk, real_dkv(q, k, v, kb, raw, dout, delta, scale, causal)[1]

    # the wrapper counts its launches on whatever its module name holds
    dv_unnormalised.launches = 0

    def detached_small(q, k, v, bias=None, scale=None):
        # the repaired fault: the kernel's output written outside autograd
        B, H, L, D = q.shape
        return sa._forward(q, k, v, key_bias(bias, B, L), scale or D ** -0.5)

    def setter(obj, name, value):
        return lambda: setattr(obj, name, value)

    return [
        ("flash_dv_from_unnormalised_p", setter(fa, "flash_dkv", dv_unnormalised),
         setter(fa, "flash_dkv", real_dkv)),
        ("cross_key_bias_dropped", setter(univl, "make_attention_mask", lambda mask: None),
         setter(univl, "make_attention_mask", real_mask)),
        ("small_attention_output_without_grad_fn",
         setter(attention, "small_attention", detached_small),
         setter(attention, "small_attention", real_small)),
    ]


def calibrate_training(seeds=3) -> None:
    """Phase 6's readings: sound seeds, then planted faults at the last seed."""
    for seed in range(seeds):
        card, cpu, batch = train_twins(seed)
        ref = first_step(cpu, batch)
        res = compare_steps(first_step(card, batch), ref)
        emit(phase="calibrate_training", kind="sound", seed=seed, **res,
             within_bound=train_within_bound(res))
    for name, plant, undo in train_faults():
        plant()
        try:
            res = compare_steps(first_step(card, batch), ref)
        finally:
            undo()
        emit(phase="calibrate_training", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=train_within_bound(res))
    emit(phase="calibrate_training", kind="bound", grad_cos_all=GRAD_COS_ALL,
         grad_cos_min=GRAD_COS_MIN, dloss_max=DLOSS_MAX)


# ------------------------------------------------------------------ phase 7
def cuda_ms(fn, iters=100, warmup=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, copies: int, replays: int = 5) -> float:
    """Device time per launch: ``launch(i)`` for i in range(copies) captured
    in one CUDA graph and replayed, so the host's launch cost is out of the
    reading (and a launch that indexes its operands by ``i`` meets operands
    the L2 cache does not hold)."""
    launch(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(copies):
            launch(i)
    return cuda_ms(graph.replay, iters=replays, warmup=2) / copies


def host_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def pct(lat):
    return dict(n=len(lat), p50_ms=float(np.percentile(lat, 50)),
                p95_ms=float(np.percentile(lat, 95)), mean_ms=float(np.mean(lat)))


def phase_times(predictors, rng, gpu):
    pred = predictors[8]
    module = pred.shell.module
    tok = pred.build_sample({"caption": "a person is cooking in a kitchen"}).arrays()
    ids, mask, seg = (torch.as_tensor(tok[f"caption_{k}"]).cuda()
                      for k in ("input_ids", "input_mask", "segment_ids"))

    def text_query():
        with torch.inference_mode():
            module.base.forward_text_encoder(ids, mask, seg)["text_embed"].cpu()

    emit(phase="times", exp="text_query_encode_b1", token_merge_r=8, gpu=gpu,
         **pct(host_ms(text_query, 200)))
    walls = {}
    for r in (8, 0):
        module = predictors[r].shell.module
        for b in (1, 8, 32):
            batch = {"image_data": torch.as_tensor(
                        rng.random((b, FRAMES, SIZE, SIZE, 3), dtype=np.float32)).cuda(),
                     "caption_input_ids": ids.expand(b, -1), "caption_input_mask":
                        mask.expand(b, -1), "caption_segment_ids": seg.expand(b, -1)}

            def full(module=module, batch=batch):
                with torch.inference_mode():
                    out = module(batch)
                    out["visual_embed"].cpu()

            lat = host_ms(full, 30)
            walls[(r, b)] = (full, float(np.median(lat)))
            emit(phase="times", exp=f"full_encode_b{b}", token_merge_r=r, gpu=gpu,
                 **pct(lat), clips_per_s=b * 1e3 / float(np.mean(lat)))
    return walls, small_attention_times(gpu)


def small_attention_times(gpu) -> dict:
    """The kernel at the main paths' shapes, bf16, q/k/v as the projections
    lay them out: the ViT at B=32 (the row that goes into the kernel table,
    returned), BERT at B=32 with its padding bias, Pink's ViT at one image,
    DMAE's temporal encoder, the ROI cross-encoder with its holed key bias.
    Device time per launch from a CUDA graph: launched eagerly, the
    wrapper's host cost would hide a kernel this short."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    saved = read_counts()
    main = None
    roi_L = TEXT_LEN + ROI_REGIONS + ROI_OCR_LEN
    for name, (B, H, L, D), biased in (("vit_b32", (256, 12, 50, 64), None),
                                       ("bert_b32_pad", (32, 12, TEXT_LEN, 64), "pad"),
                                       ("pink_vit_b1", (1, 12, 50, 64), None),
                                       ("dmae_temporal_b128_framepad", (128, 8, 12, 64), "pad"),
                                       ("roi_cross_b128_holes", (ROI_BATCH, 12, roi_L, 64),
                                        "roi"),
                                       ("m2_audio_conv_b1", (1, 4, 64, 128), None)):
        q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        bias = mask = None
        if biased == "pad":
            lens = torch.randint(8, L + 1, (B,), generator=gen, device="cuda")
            bias = make_attention_mask((torch.arange(L, device="cuda")[None]
                                        < lens[:, None]).long())
        elif biased == "roi":
            bias = roi_key_bias(gen, B)
        if biased:
            mask = bias > torch.finfo(torch.float32).min / 2  # SDPA's boolean form
        row = dict(
            ms=graph_ms(lambda i: small_attention(q, k, v, bias), 20),
            eager_ms=cuda_ms(lambda: small_attention(q, k, v, bias)),
            plain_ms=cuda_ms(lambda: plain_small_attention(q, k, v, bias), iters=20),
            library_ms=graph_ms(lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                20),
            **bound(4 * B * H * L * D * 2 + (B * L * 4 if biased else 0), 4 * B * H * L * L * D))
        emit(phase="times", exp="small_attention_kernel", case=name, shape=[B, H, L, D],
             dtype="bf16", gpu=gpu, **row, bound_share=row["bound_ms"] / row["ms"])
        main = main or row
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    main.pop("eager_ms")
    return main


def bound(nbytes: float, flops: float) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def flash_shape_times(pair_bias, gpu, case: str, qkv=None, causal: bool = False) -> dict:
    """The flash kernels at a pair stream's [P, 12, L, 64] bf16 (or at
    ``qkv``'s shape) with that stream's key bias, q/k/v in the projections'
    layout, beside their plain versions and SDPA (with ``causal``, a boolean
    mask of the key bias and the causal triangle). The bound counts each
    input read once and each output written once (for dQ and dK/dV, K and V
    of the keys these inputs need: ``flash_bwd_bytes``), and the products
    over the (query, key) pairs each row attends (4, 6 and 8 multiply-adds
    ·2 per pair and head dimension for forward, dQ, dK/dV)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    P, L = pair_bias.shape[0], pair_bias.shape[3]
    if qkv is None:
        H, D = 12, 64
        q, k, v = (torch.randn(P, L, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    else:
        (q, k, v), H, D = qkv, qkv[0].shape[1], qkv[0].shape[3]
    dout = torch.randn(P, H, L, D, generator=gen, device="cuda").to(torch.bfloat16)
    kb, scale = key_bias(pair_bias, P, L), D ** -0.5
    saved = read_counts()
    out, stats = flash_fwd(q, k, v, kb, scale, causal)
    _, delta = flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
    key_live = kb > torch.finfo(torch.float32).min / 2
    attended = key_live[:, None, :].expand(P, L, L)
    if causal:
        attended = attended & torch.ones(L, L, dtype=torch.bool, device="cuda").tril()
    live = int(key_live.sum().item())  # live keys, all rows
    pairs = H * int(attended.sum().item())  # (query, key) pairs attended, over heads
    tensor, rows = P * H * L * D * 2, P * H * L * 4  # one bf16 [P, H, L, D]; one fp32 row stat
    bias_b = P * L * 4
    dq_bytes, dkv_bytes = flash_bwd_bytes(kb, P, H, L, L, D, causal)
    # SDPA's boolean form of the same attention
    mask = attended[:, None] if causal else pair_bias > torch.finfo(torch.float32).min / 2
    # SDPA's backward alone, device time per call, the library time of both
    # backward kernels (together they compute what it computes)
    sdpa_bwd_ms, sdpa_method = sdpa_backward_ms(q, k, v, mask, dout)
    timing = {
        "flash_fwd": dict(
            ms=graph_ms(lambda i: flash_fwd(q, k, v, kb, scale, causal), 20),
            plain_ms=cuda_ms(lambda: plain_flash_fwd(q, k, v, kb, scale, causal), iters=10),
            library_ms=graph_ms(
                lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20),
            **bound(4 * tensor + bias_b + 2 * rows, 4 * D * pairs)),
        "flash_dq": dict(
            ms=graph_ms(lambda i: flash_dq(q, k, v, kb, out, stats, dout, scale, causal), 20),
            plain_ms=cuda_ms(lambda: plain_flash_dq(q, k, v, kb, out, stats, dout, scale,
                                                    causal), iters=10),
            library_ms=sdpa_bwd_ms, **bound(dq_bytes, 6 * D * pairs)),
        "flash_dkv": dict(
            ms=graph_ms(lambda i: flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal), 20),
            plain_ms=cuda_ms(lambda: plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale,
                                                     causal), iters=10),
            library_ms=sdpa_bwd_ms, **bound(dkv_bytes, 8 * D * pairs)),
    }
    # SDPA forward and backward together, the yardstick for the three kernels
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(dout)

    def flash_fwd_bwd():
        o, st = flash_fwd(q, k, v, kb, scale, causal)
        _, dl = flash_dq(q, k, v, kb, o, st, dout, scale, causal)
        flash_dkv(q, k, v, kb, st, dout, dl, scale, causal)

    def flash_bwd(i):
        _, dl = flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
        flash_dkv(q, k, v, kb, stats, dout, dl, scale, causal)

    sdpa_ms, family_ms = cuda_ms(sdpa_fwd_bwd, iters=20), cuda_ms(flash_fwd_bwd, iters=20)
    bwd_ms = graph_ms(flash_bwd, 20)
    sdpa_both_ms, both_method = sdpa_backward_ms(q, k, v, mask, dout, with_forward=True)
    backend = sdpa_kernels(q, k, v, mask, dout)
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    for name, t in timing.items():
        emit(phase="times", exp=name, case=case, shape=[P, H, L, D], dtype="bf16",
             gpu=gpu, causal=causal, live_keys=live, attended_pairs=pairs,
             **t, bound_share=t["bound_ms"] / t["ms"])
    emit(phase="times", exp="flash_fwd_dq_dkv_vs_sdpa_fwd_bwd", case=case, shape=[P, H, L, D],
         gpu=gpu, flash_ms=family_ms, sdpa_ms=sdpa_ms,
         timed="eager, CUDA events, .backward into .grad")
    emit(phase="times", exp="flash_dq_dkv_vs_sdpa_bwd", case=case, shape=[P, H, L, D], gpu=gpu,
         flash_bwd_ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms, sdpa_bwd_timed=sdpa_method,
         sdpa_fwd_bwd_ms=sdpa_both_ms, sdpa_fwd_bwd_timed=both_method,
         sdpa_kernels_us=backend)
    return {name: {**t, "shape": [P, H, L, D]} for name, t in timing.items()}


def flash_fwd_times(pair_bias, gpu, case: str) -> dict:
    """The flash forward alone at an evaluation pair stream [P, 12, L, 64]
    bf16 (stage-2 re-ranking runs no backward), beside its plain version and
    SDPA, with ``flash_shape_times``'s bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    P, L, H, D = pair_bias.shape[0], pair_bias.shape[3], 12, 64
    q, k, v = (torch.randn(P, L, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    kb, scale = key_bias(pair_bias, P, L), D ** -0.5
    live = int((kb > torch.finfo(torch.float32).min / 2).sum().item())
    mask = pair_bias > torch.finfo(torch.float32).min / 2
    saved = read_counts()
    row = dict(ms=graph_ms(lambda i: flash_fwd(q, k, v, kb, scale, False), 20),
               plain_ms=cuda_ms(lambda: plain_flash_fwd(q, k, v, kb, scale, False), iters=10),
               library_ms=graph_ms(
                   lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20),
               **bound(4 * P * H * L * D * 2 + P * L * 4 + 2 * P * H * L * 4, 4 * D * H * L * live))
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    emit(phase="times", exp="flash_fwd", case=case, shape=[P, H, L, D], dtype="bf16", gpu=gpu,
         live_keys=live, **row, bound_share=row["bound_ms"] / row["ms"])
    return row


def phase_flash_times(pair_biases: dict, gpu, eval_biases: dict) -> dict:
    """The flash kernels at each training path's pair stream (``case`` →
    key bias), at Pink's training steps (causal, D=128, the ragged text bias:
    16 heads, k/v repeated from 4 kv heads, behind 49 vision keys; 32 heads
    from 8 kv heads behind 256 EVA keys), at M2-omni's training micro-batch
    ([4, 32, 640, 128], causal, right-padded), the forward alone
    at each evaluation pair stream (``eval_biases``) and at Pink's causal
    prefill; returns the timing at the last training pair stream (the
    pretraining path's) for the kernel table."""
    for case, pair_bias in pair_biases.items():
        timing = flash_shape_times(pair_bias, gpu, case)
        torch.cuda.empty_cache()
    for case, heads in (("pink_train_causal_d128", PINK_1B_HEADS),
                        ("pink_7b_train_causal_h32_d128", PINK_7B_HEADS)):
        q, k, v, bias = pink_train_qkv(torch.Generator(device="cuda").manual_seed(SEED + 7),
                                       PINK_TRAIN_BATCH, heads=heads)
        flash_shape_times(bias, gpu, case, (q, k, v), causal=True)
        del q, k, v
        torch.cuda.empty_cache()
    # M2-omni's training micro-batch (phase 20)
    q, k, v, bias = m2_train_qkv(torch.Generator(device="cuda").manual_seed(SEED + 9))
    flash_shape_times(bias, gpu, "m2_omni_train_causal_h32_d128", (q, k, v), causal=True)
    del q, k, v
    torch.cuda.empty_cache()
    for case, pair_bias in eval_biases.items():
        flash_fwd_times(pair_bias, gpu, case)
    # the causal prefill of a Pink request: 113 tokens, 16 heads of 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    saved = read_counts()
    pq, pk, pv = (torch.randn(1, 113, 16, 128, generator=gen, device="cuda")
                  .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    prefill = dict(
        ms=graph_ms(lambda i: flash_fwd(pq, pk, pv, None, 128 ** -0.5, True), 20),
        plain_ms=cuda_ms(lambda: plain_flash_fwd(pq, pk, pv, None, 128 ** -0.5, True), iters=10),
        library_ms=graph_ms(
            lambda i: F.scaled_dot_product_attention(pq, pk, pv, is_causal=True), 20),
        **bound(4 * pq.numel() * 2 + 2 * 16 * 113 * 4, 4 * 128 * 16 * 113 * 114 // 2))
    for fn in KERNELS:
        fn.launches = saved[fn.__name__]
    emit(phase="times", exp="flash_fwd", case="pink_prefill_causal", shape=[1, 16, 113, 128],
         dtype="bf16", gpu=gpu, **prefill, bound_share=prefill["bound_ms"] / prefill["ms"])
    m2_prefill_times(gpu)
    return timing


def m2_prefill_times(gpu) -> dict:
    """The flash forward at M2-omni's prefill ([1, 32, 640, 128], causal, a
    right-padded prompt of 430 tokens, k/v repeated from 8 kv heads) beside
    its plain version and SDPA given the same attention as a boolean mask;
    the bound counts q, k, v and the output once, the bias and the row
    statistics, and 4·D multiply-adds·2 over the (query, key) pairs each row
    attends."""
    q, k, v, bias = m2_prefill_qkv(torch.Generator(device="cuda").manual_seed(SEED + 8))
    B, H, L, D = q.shape
    kb, scale = key_bias(bias, B, L), D ** -0.5
    live = kb > torch.finfo(torch.float32).min / 2
    attended = live[:, None, :].expand(B, L, L) & torch.ones(L, L, dtype=torch.bool,
                                                            device="cuda").tril()
    pairs = H * int(attended.sum().item())
    saved = read_counts()
    row = dict(
        ms=graph_ms(lambda i: flash_fwd(q, k, v, kb, scale, True), 20),
        plain_ms=cuda_ms(lambda: plain_flash_fwd(q, k, v, kb, scale, True), iters=10),
        library_ms=graph_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attended[:, None]), 20),
        **bound(4 * q.numel() * 2 + B * L * 4 + 2 * B * H * L * 4, 4 * D * pairs))
    for fn in KERNELS:
        fn.launches = saved[fn.__name__]
    emit(phase="times", exp="flash_fwd", case="m2_prefill_causal_padded", shape=[B, H, L, D],
         dtype="bf16", gpu=gpu, live_keys=int(live.sum().item()), attended_pairs=pairs, **row,
         bound_share=row["bound_ms"] / row["ms"])
    return row


# ------------------------------------------------------------------ phase 8
def phase_trace(walls, gpu, iters=5):
    from torch.profiler import ProfilerActivity, profile

    for r in (8, 0):
        full, wall_ms = walls[(r, 32)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                full()
        busy_ms, n_ops, top = device_busy(prof, iters)
        emit(phase="trace", exp="full_encode_b32", token_merge_r=r, gpu=gpu,
             untraced_wall_ms=wall_ms,
             device_busy_ms=busy_ms if n_ops else "not measured",
             device_idle_share=1 - busy_ms / wall_ms if n_ops else "not measured",
             device_ops_per_forward=n_ops, top_device_ops_ms=top)


# ------------------------------------------------------------------ phase 9
def pink_predictor(device: str = "cuda", dtype: str = "bfloat16", quant: str = "int4",
                   on_device: bool = False):
    """``GenerationPredictor`` on the full-width Pink model through the CLI's
    ``build_predictor``; seeded random weights (drawn on the card with
    ``on_device``), quantised on the model's device to ``quant`` unless it
    is empty."""
    opts = ["model_attributes.pink.dtype_str", dtype,
            "predictor_parameters.max_prompt_len", str(PINK_PROMPT_LEN),
            "predictor_parameters.max_new_tokens", str(PINK_NEW_TOKENS),
            "predictor_parameters.num_beams", "1",
            "predictor_parameters.init_on_device", str(on_device).lower()]
    for key, value in PINK_MODEL.items():
        opts += [f"model_attributes.pink.{key}", str(value)]
    if quant:
        opts += ["predictor_parameters.decode_quant", quant]
    return build_predictor(["--config", PINK_CONFIG, "--predictor", "generation_predictor",
                            "--no_ckpt", "--device", device, *opts])[0]


def pink_request(rng, text="what is the person in the picture doing?"):
    return {"text": text, "image": rng.random((SIZE, SIZE, 3), dtype=np.float32)}


def decode_walk(pred, arrays, steps: int, sync: bool = True):
    """Prefill, then ``steps`` greedy decode steps through the model's cached
    entry points. Returns (prefill ms, per-step ms, tokens); with ``sync``
    the device is waited for after each, as a streaming server would."""
    module = pred.shell.module
    batch = pred.shell.to_device(arrays)
    wait = torch.cuda.synchronize if sync else (lambda: None)
    with torch.inference_mode():
        lens = batch["input_mask"].sum(dim=-1)
        Lv = module.num_vision_tokens(batch)
        cache = module.decoder.make_cache(1, Lv + PINK_PROMPT_LEN + steps + 1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = module.prefill(batch, cache, lens)
        wait()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_ms, tokens = [], []
        for t in range(steps):
            t0 = time.perf_counter()
            tok = logits.argmax(dim=-1)
            logits, cache = module.decode_step(tok, Lv + lens + t, cache)
            wait()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(tok)
        torch.cuda.synchronize()
    return prefill_ms, step_ms, [int(t) for t in tokens]


def phase_pink(rng, gpu):
    """Serve three requests, counting launches per request; then the timings.
    Returns the predictor and the launches of the three requests."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = pink_predictor(on_device=True)
    load_s = time.perf_counter() - t0
    module = pred.shell.module
    packed = [m for m in module.modules() if getattr(m, "kernel_q4", None) is not None]
    weight_bytes = sum(m.kernel_q4.numel() + m.kernel_scale.numel() * 4 for m in packed)
    check(len(packed) == GEMVS_PER_STEP, f"{len(packed)} packed projections; expected "
          f"{GEMVS_PER_STEP}")
    emit(phase="pink_load", gpu=gpu, load_s=load_s, packed_projections=len(packed),
         packed_weight_bytes=weight_bytes,
         decode_step_bytes_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         mem_after_load_gb=torch.cuda.memory_allocated() / 1e9)
    totals = dict.fromkeys(PINK_LAUNCHES, 0)
    texts = ["what is the person in the picture doing?", "describe the image in detail.",
             "where is the dog [0.10,0.20,0.55,0.90]?"]
    for i, text in enumerate(texts):
        req = pink_request(rng, text)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(req)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        for name, n in counts.items():
            totals[name] += n
        ids = np.asarray(out["generated_ids"])
        n_prompt = int(pred.build_sample(req).arrays()["input_mask"].sum())
        new = ids[0, n_prompt: n_prompt + PINK_NEW_TOKENS]
        emit(phase="pink_serving", request=i, gpu=gpu, request_ms=request_ms,
             new_tokens_per_s=PINK_NEW_TOKENS * 1e3 / request_ms, launches=counts,
             prompt_tokens=n_prompt, new_tokens=new.tolist(), text=out["generated_text"])
        check(counts == PINK_LAUNCHES, f"launches per request {counts}; expected {PINK_LAUNCHES}")
        check(ids.shape == (1, PINK_PROMPT_LEN + PINK_NEW_TOKENS) and
              isinstance(out["generated_text"], str), "generate's output shape")
        check(bool(((new >= 0) & (new < PINK_VOCAB)).all()), "a token outside the vocabulary")

    # greedy with the cache against re-encoding the whole prefix per token
    batch = pred.shell.to_device(pred.build_sample(req).arrays())
    cached, lens = module.generate(batch, eos_id=pred.eos_id, max_length=4)
    anchor, _ = module.generate(batch, eos_id=pred.eos_id, max_length=4, use_cache=False)
    same = bool((cached == anchor).all().item())
    n = int(lens[0])
    emit(phase="pink_cached_vs_reencode", new_tokens=4, cached=cached[0, n:n + 4].tolist(),
         reencoded=anchor[0, n:n + 4].tolist(), ok=same)
    check(same, "cached greedy tokens differ from re-encoding")

    # timings: prefill and per-token decode (the device waited for after each
    # step), whole requests without waiting, and the device's share of a step
    arrays = pred.build_sample(req).arrays()
    decode_walk(pred, arrays, 3)  # warm-up
    prefill, steps = [], []
    for _ in range(3):
        pre, st, _ = decode_walk(pred, arrays, PINK_NEW_TOKENS - 1)
        prefill.append(pre)
        steps += st
    lat = host_ms(lambda: pred.predict(req), 5, warmup=1)
    # the device's share of one prefill and four steps launched without waiting
    walk_ms = float(np.median(host_ms(lambda: decode_walk(pred, arrays, 4, sync=False), 3,
                                      warmup=1)))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_walk(pred, arrays, 4, sync=False)
    busy, n_ops, top = device_busy(prof, 1)
    step_p50 = float(np.percentile(steps, 50))
    pred.decode_step_p50_ms = step_p50
    emit(phase="pink_times", gpu=gpu, prefill_ms=pct(prefill), decode_step_ms=pct(steps),
         decode_tokens_per_s=1e3 / step_p50, request_ms=pct(lat),
         request_new_tokens_per_s=PINK_NEW_TOKENS * 1e3 / float(np.mean(lat)),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         profiled="one prefill and four decode steps", untraced_wall_ms=walk_ms,
         device_busy_ms=busy if n_ops else "not measured",
         device_idle_share=1 - busy / walk_ms if n_ops else "not measured",
         device_ops=n_ops, top_device_ops_ms=top)
    return pred, totals


# ----------------------------------------------------------------- phase 10
def pink_logits(pred, arrays, token=None):
    """fp32 logits at prefill and at the first decode step, which is fed
    ``token`` (default: this model's own greedy token)."""
    module = pred.shell.module
    batch = pred.shell.to_device(arrays)
    with torch.inference_mode():
        lens = batch["input_mask"].sum(dim=-1)
        Lv = module.num_vision_tokens(batch)
        cache = module.decoder.make_cache(1, Lv + PINK_PROMPT_LEN + 1, device=pred.shell.device)
        first, cache = module.prefill(batch, cache, lens)
        token = first.argmax(dim=-1) if token is None else token.to(first.device)
        second, _ = module.decode_step(token, Lv + lens, cache)
    return first[0].float().cpu(), second[0].float().cpu(), token.cpu()


def compare_logits(card, cpu) -> dict:
    """Card logits against CPU logits of one position: cosine, the largest
    |Δ| in units of the CPU logits' spread, and where the CPU's greedy token
    ranks on the card."""
    cos = torch.nn.functional.cosine_similarity(card.double(), cpu.double(), dim=0).item()
    top = int(cpu.argmax())
    return dict(cos=cos, max_abs_d_over_std=((card - cpu).abs().max() / cpu.std()).item(),
                cpu_top_rank_on_card=int((card > card[top]).sum()))


def pink_within_bound(res) -> bool:
    return all(r["cos"] >= PINK_COS_MIN and r["max_abs_d_over_std"] <= PINK_DLOGIT_MAX
               for r in (res["prefill"], res["decode_step"]))


def pink_twins(card, seed: int):
    """An fp32 CPU model with weights of ``seed`` and one set of int4 records
    in it and in the card's bf16 model: at the card's seed the records the
    card's predictor made on the card (from its bf16 weights) and serves,
    exported, else records of the CPU's weights, loaded into both."""
    from antmmf_torch.models.base_model import ModelShell

    seeded = ModelShell.init
    if seed == SEED:  # every value comes from the card's export: no seeded init
        ModelShell.init = lambda self, *a, **kw: None
    try:
        with no_default_init():  # the predictor's seeded init sets every value
            cpu = pink_predictor("cpu", "float32", quant="")
    finally:
        ModelShell.init = seeded
    if seed:  # the predictor drew seed 0
        cpu.shell.init(seed)
    if seed == SEED:  # the records the card's predictor made on the card, as it serves them
        records = export_decode_records(card.shell.module)
    else:
        records = quantize_for_decode({"params": export_flax_params(cpu.shell.module)})
        load_decode_records(card.shell.module, records, torch.bfloat16)
    load_decode_records(cpu.shell.module, records, torch.float32)
    return cpu


def pink_compare(card, cpu, arrays, ref=None):
    ref = ref or pink_logits(cpu, arrays)
    first, second, _ = pink_logits(card, arrays, ref[2])
    return dict(prefill=compare_logits(first, ref[0]),
                decode_step=compare_logits(second, ref[1])), ref


def phase_pink_card_vs_cpu(card, rng):
    t0 = time.perf_counter()
    cpu = pink_twins(card, SEED)
    arrays = card.build_sample(pink_request(rng)).arrays()
    res, _ = pink_compare(card, cpu, arrays)
    ok = pink_within_bound(res)
    emit(phase="pink_card_vs_cpu", **res, cos_min=PINK_COS_MIN, dlogit_max=PINK_DLOGIT_MAX,
         seconds=time.perf_counter() - t0, ok=ok)
    check(ok, "Pink's logits on the card and on the CPU disagree beyond the stated bound")


def pink_faults():
    """Faults planted on the card's decode path only (the CPU holds the
    sound answer), each undone after its reading: (name, plant, undo). Each
    wraps the real kernel, or stands in for it with tensor ops, at the one
    place ``int4_apply`` looks it up."""
    real = i4.int4_gemv

    def high_nibble_unsigned(x, packed, scale):
        fin, fout = packed.shape[0] * 2, packed.shape[1]
        q = torch.cat([(packed & 0x0F).float() - 8, (packed >> 4).float()], dim=0)
        xg = F.pad(x.float(), (0, fin - x.shape[1])).reshape(x.shape[0], scale.shape[0], -1)
        part = torch.einsum("ngr,gro->ngo", xg, q.reshape(scale.shape[0], -1, fout))
        return (part * scale[None]).sum(dim=1)

    def halves_scales_swapped(x, packed, scale):
        return real(x, packed, torch.roll(scale, scale.shape[0] // 2, dims=0).contiguous())

    def padding_dropped(x, packed, scale):
        fin = packed.shape[0] * 2
        if fin == x.shape[1]:
            return real(x, packed, scale)
        # the high half read as if the record had x's rows: it starts 64 rows early
        moved = torch.zeros(x.shape[0], fin, dtype=x.dtype, device=x.device)
        half_x = x.shape[1] // 2
        moved[:, :half_x] = x[:, :half_x]
        moved[:, fin // 2: fin // 2 + half_x] = x[:, half_x:]
        return real(moved, packed, scale)

    def setter(fn):
        return lambda: setattr(i4, "int4_gemv", fn)

    faults = (high_nibble_unsigned, halves_scales_swapped, padding_dropped)
    for fn in faults:  # the wrapper counts its launches on whatever its module name holds
        fn.launches = 0
    return [(fn.__name__, setter(fn), setter(real)) for fn in faults]


def calibrate_pink(seeds=3) -> None:
    """Phase 10's readings: sound seeds, then planted faults at the last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    card = pink_predictor()
    sound = []
    for seed in range(seeds):
        cpu = pink_twins(card, seed)
        arrays = card.build_sample(pink_request(rng)).arrays()
        res, ref = pink_compare(card, cpu, arrays)
        sound.append(res)
        emit(phase="calibrate_pink", kind="sound", seed=seed, **res,
             within_bound=pink_within_bound(res))
        del cpu
    for name, plant, undo in pink_faults():
        plant()
        try:
            res, _ = pink_compare(card, None, arrays, ref)
        finally:
            undo()
        emit(phase="calibrate_pink", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=pink_within_bound(res))
    emit(phase="calibrate_pink", kind="sound_worst", seeds=seeds,
         min_cos=min(r[k]["cos"] for r in sound for k in r),
         max_abs_d_over_std=max(r[k]["max_abs_d_over_std"] for r in sound for k in r),
         cos_min=PINK_COS_MIN, dlogit_max=PINK_DLOGIT_MAX)


# ----------------------------------------------------------------- phase 11
def phase_int4_times(pred, gpu) -> dict:
    """``int4_gemv`` on the served model's records, one of each of the path's
    five shapes, at 1 row of bf16 x (the decode path), at the row counts of
    beams (3), speculation (5), the engine (8, 16), beams at an eval batch of
    8 (24) and at 32 rows.
    Bound: packed bytes, scales, x and y once over the memory rate, against
    2·rows·in·out operations at the bf16 tensor rate. Prints the readings
    summed over a decode step's launches (each shape's time times its
    launches a step) for each row count; returns those of one row."""
    decoder = pred.shell.module.decoder.layer_0
    modules = {"attn_q_o": (decoder.attention.q_proj, 2 * PINK_LAYERS),
               "attn_k_v": (decoder.attention.k_proj, 2 * PINK_LAYERS),
               "mlp_gate_up": (decoder.mlp.gate_proj, 2 * PINK_LAYERS),
               "mlp_down": (decoder.mlp.down_proj, PINK_LAYERS),
               "lm_head": (pred.shell.module.lm_head, 1)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    saved = read_counts()
    steps = {rows: dict(ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0)
             for rows in (1, DECODE_BEAMS, DECODE_GAMMA + 1, ENGINE_SLOTS, ENGINE_CHUNK,
                          EVAL_BATCH * DECODE_BEAMS, 32)}
    steps[1].update(eager_ms=0.0, plain_ms=0.0)
    for name, (mod, per_step) in modules.items():
        packed, scale = mod.kernel_q4, mod.kernel_scale
        fin_x, fin_w, fout, group = INT4_SHAPES[name]
        check(tuple(packed.shape) == (fin_w // 2, fout) and scale.shape[0] == fin_w // group
              and mod.in_features == fin_x, f"{name}: the served record is not {INT4_SHAPES[name]}")
        record_bytes = packed.numel() + scale.numel() * 4
        copies = max(2, min(512, -(-256 * 2 ** 20 // record_bytes)))  # 256 MB in turn
        records = [(packed.clone(), scale.clone()) for _ in range(copies)]
        dense = unpack_int4(packed, scale, torch.bfloat16)[:fin_x]
        dense = [dense.clone() for _ in range(max(2, copies // 4))]
        for rows, step in steps.items():
            x = torch.randn(rows, fin_x, generator=gen, device="cuda").to(torch.bfloat16)
            nbytes = record_bytes + x.numel() * 2 + rows * fout * 4
            timing = dict(ms=graph_ms(lambda i: int4_gemv(x, *records[i]), copies),
                          library_ms=graph_ms(lambda i: torch.matmul(x, dense[i]), len(dense)))
            if rows == 1:
                timing["eager_ms"] = cuda_ms(lambda: int4_gemv(x, packed, scale))
                timing["plain_ms"] = cuda_ms(lambda: plain_int4_gemv(x, packed, scale),
                                             iters=3, warmup=1)
            timing.update(bound(nbytes, 2 * rows * fin_w * fout))
            emit(phase="times", exp="int4_gemv", case=name, x=[rows, fin_x],
                 record=[fin_w, fout], group=group, dtype="bf16", gpu=gpu,
                 launches_per_decode_step=per_step, bytes=nbytes, copies_in_turn=copies,
                 **timing, bound_share=timing["bound_ms"] / timing["ms"])
            for key in step:
                step[key] += per_step * (nbytes if key == "bytes" else timing[key])
        del records, dense
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    for rows, step in steps.items():
        emit(phase="times", exp="int4_gemv_per_decode_step", rows=rows,
             launches=GEMVS_PER_STEP, gpu=gpu, **step,
             bound_share=step["bound_ms"] / step["ms"])
    pred.int4_step_ms = steps  # phase 11c reads them beside the row counts of its modes
    step = steps[1]
    return dict(ms=step["ms"] / GEMVS_PER_STEP, plain_ms=step["plain_ms"] / GEMVS_PER_STEP,
                library_ms=step["library_ms"] / GEMVS_PER_STEP,
                bound_ms=step["bound_ms"] / GEMVS_PER_STEP, bound_by="bytes")


# ------------------------------------------------------------ phase 11b
# The continuous-batching engine (predictors/serving_engine.py) on phase
# 9's Pink int4 module: 8 slots, windows of 8 tokens, 16 requests (16..64
# prompt tokens, 8..24 new tokens; by index: 1 and 2 sampled at top_p 0.9,
# temperature 0.8; 3 with a stop token; 4 cancelled after the first
# window; 5 with a deadline of 0.05 s; 14 and 15 text-only; the rest greedy
# with an image). A window decodes the pool's 8 rows through 155 K8
# launches a step; an admission prefills one request (22 flash_fwd, 11 K1
# with an image, K8 once for lm_head on the last prompt token); an extend
# of W <= 32 tokens (chunks, prefix suffixes, session turns) 155 K8.
ENGINE_SLOTS, ENGINE_WINDOW, ENGINE_REQUESTS = 8, 8, 16
ENGINE_CHUNK, ENGINE_PREFIX, ENGINE_SUFFIXES = 16, 16, 4
ENGINE_ROLES = {1: "sampled", 2: "sampled", 3: "stop", 4: "cancel", 5: "deadline",
                14: "text_only", 15: "text_only"}
ENGINE_TURN = 8  # a session's second turn, in tokens
ENGINE_SHORT = 8  # new tokens of a prefix suffix and of each session turn
ENGINE_EXTRA = ENGINE_TURN + PINK_NEW_TOKENS  # cache slots a session's second turn needs
M2_ENGINE_SLOTS = 4
CLI_LAYERS, CLI_REQUESTS, CLI_NEW = 2, 4, 8
# greedy tokens on the engine (S rows through cuBLAS and K8) against
# sequential generate (one row): where they differ, the first differing
# position must be a near-tie of the sequential logits, |l[seq] - l[engine]|
# over the logits' standard deviation at most ENGINE_TIE_MAX
# (``--calibrate engine``). Three sound seeds (33 requests, 12 of them
# differing) read 0 (the bf16 logits tie exactly), 0.0217 and at most
# 0.0433; an admission copied into slot 0 reads 0.197 to 4.44 on all 11
# requests, the decode slot one ahead up to 0.196 on 10 of 11 (H100 readings)
ENGINE_TIE_MAX = 0.1
# kv_int8, card bf16 vs CPU fp32 on the same weights (Pink at 2 decoder
# layers, M2-omni at M2_CUT): the logits of INT8_STEPS decode steps over the
# int8 cache, teacher-forced with the CPU's tokens; cosine and the largest
# |Δ| over the spread (``--calibrate engine``). Sound runs over three seeds
# stay above cos 0.99994 and below 0.054 (Pink; M2-omni 0.99997, 0.040);
# the key scales read one slot off read cos 0.9928 and 0.55 (M2-omni 0.9932,
# 0.53), the value scales not applied cos 0.69 and 3.5 (H100 readings)
INT8_STEPS = 3
INT8_COS_MIN, INT8_DLOGIT_MAX = 0.999, 0.25


def engine_pink_requests(seed: int = SEED) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(ENGINE_REQUESTS):
        n = int(rng.integers(16, PINK_PROMPT_LEN + 1))
        ids = np.zeros(PINK_PROMPT_LEN, np.int64)
        ids[0], ids[1:n] = 101, rng.integers(1000, 30000, n - 1)
        data = {"input_ids": ids, "input_mask": (np.arange(PINK_PROMPT_LEN) < n).astype(np.int64),
                "max_new": int(rng.integers(8, PINK_NEW_TOKENS + 1))}
        if ENGINE_ROLES.get(i) != "text_only":
            data["image_data"] = rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
        if ENGINE_ROLES.get(i) == "sampled":
            data.update(do_sample=True, top_p=0.9, temperature=0.8, seed=i)
        if ENGINE_ROLES.get(i) == "deadline":  # admitted in the first step, evicted after it
            data["deadline_s"] = 0.05
        reqs.append((f"p{i}", data))
    return reqs


def truncate_at_eos(toks, eos: int) -> list:
    out = []
    for t in toks:
        out.append(int(t))
        if t == eos:
            break
    return out


def sequential_tokens(module, eng, data, max_new: int) -> list:
    """``generate`` on one request (B=1), cut after EOS."""
    batch = {"input_ids": torch.as_tensor(data["input_ids"])[None].cuda(),
             "input_mask": torch.as_tensor(data["input_mask"])[None].cuda(),
             **eng._extras_of(data)}
    tokens, lens = module.generate(batch, eos_id=eng.eos_id, max_length=max_new)
    n = int(lens[0])
    return truncate_at_eos(tokens[0, n:n + max_new].tolist(), eng.eos_id)


def tie_margin(eng, data, got: list, seq: list, j: int) -> float:
    """|l[seq_j] - l[got_j]| / std(l) of the one-row logits at position j,
    teacher-forced on seq[:j] through the adapter's prefill and decode."""
    ad = eng.ad
    with torch.inference_mode():
        logits, cache, slot0, rope0 = ad.prefill1(*eng._prompt(data), eng._extras_of(data))
        for t in range(j):
            logits, cache = ad.decode(torch.tensor([seq[t]], device="cuda"), rope0 + t,
                                      slot0 + t, cache)
    lg = logits[0].float()
    return float((lg[seq[j]] - lg[got[j]]).abs() / lg.std())


def agree(eng, data, got: list, seq: list) -> dict:
    """Engine tokens against sequential ones: equal, or the first differing
    position (or a length difference) and its near-tie margin."""
    j = next((i for i, (a, b) in enumerate(zip(got, seq)) if a != b), None)
    if j is None:
        same = len(got) == len(seq)
        return dict(equal=same, first_diff=None if same else min(len(got), len(seq)),
                    margin=0.0 if same else float("inf"))
    return dict(equal=False, first_diff=j, margin=tie_margin(eng, data, got, seq, j))


def agrees(res: dict) -> bool:
    return res["equal"] or res["margin"] <= ENGINE_TIE_MAX


class LaunchLog:
    """The kernels' launches of each engine window and each admission or
    extend, read around the adapter's and the engine's calls (no sync), and
    each call's host milliseconds (a window's end in its one host read, so
    its time holds the device work queued before it)."""

    def __init__(self, eng):
        self.windows, self.prefills, self.extends = [], [], []
        self.ms = {"window": [], "prefill": [], "extend": []}
        for obj, name, log, key in ((eng, "_window", self.windows, "window"),
                                    (eng.ad, "prefill1", self.prefills, "prefill"),
                                    (eng.ad, "extend", self.extends, "extend")):
            setattr(obj, name, self.wrap(getattr(obj, name), log, self.ms[key]))

    def host_ms(self) -> dict:
        return {k: pct(v) for k, v in self.ms.items() if v}

    @staticmethod
    def undo(eng):
        eng.__dict__.pop("_window", None)
        eng.ad.__dict__.pop("prefill1", None)
        eng.ad.__dict__.pop("extend", None)

    @staticmethod
    def wrap(fn, log, ms):
        def counted(*args, **kw):
            before, t0 = read_counts(), time.perf_counter()
            out = fn(*args, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
            after = read_counts()
            log.append({k: after[k] - before[k] for k in after})
            return out
        return counted


def window_launches(gemvs_per_step: int) -> dict:
    return {**NO_LAUNCHES, "int4_gemv": ENGINE_WINDOW * gemvs_per_step}


def engine_pass(eng, requests, cancel=(), chunk=None) -> tuple:
    """One workload through ``eng`` (reset first): the launch counts set to 0
    just before and read just after; ``cancel`` ids cancelled after the
    first window; with ``chunk``, chunked admission appending up to a chunk
    a slot between windows. Returns (stats, launches, the LaunchLog)."""
    eng.reset()
    eng.chunk, eng.chunks_per_step = chunk, eng.S
    log = LaunchLog(eng)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, data in requests:
        eng.submit(rid, data)
    eng.step()
    for rid in cancel:
        check(eng.cancel(rid), f"engine: {rid} could not be cancelled")
    while eng._queue or any(r is not None for r in eng._slot_req) \
            or any(p is not None for p in eng._slot_pending):
        eng.step()
    torch.cuda.synchronize()
    stats = eng.stats(time.perf_counter() - t0)
    counts = read_counts()
    log.undo(eng)
    eng.chunk, eng.chunks_per_step = None, 1
    return stats, counts, log


def stats_line(stats) -> dict:
    return {k: v for k, v in stats.items() if k not in ("outputs", "cancelled", "evicted")}


def engine_idle(eng, requests, gpu) -> dict:
    """Device-busy time over two windows of a full pool (admitted before,
    the engine's budget of new tokens each), against the same two windows
    untraced."""
    from torch.profiler import ProfilerActivity, profile

    def two_windows(profiled: bool):
        eng.reset()
        for rid, data in requests[:eng.S]:
            eng.submit(rid, {**data, "max_new": eng.max_new, "deadline_s": None})
        eng.step()
        torch.cuda.synchronize()
        ctx = profile(activities=[ProfilerActivity.CUDA]) if profiled \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            eng.step()
            eng.step()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, prof

    wall, _ = two_windows(False)
    _, prof = two_windows(True)
    eng.reset()
    busy, n_ops, top = device_busy(prof, 2)
    return dict(profiled="two decode windows of a full pool", untraced_window_ms=wall / 2,
                device_busy_ms=busy if n_ops else "not measured",
                device_idle_share=1 - 2 * busy / wall if n_ops else "not measured",
                device_ops=n_ops, top_device_ops_ms=top)


def decode_step_ms(module, rows: int, steps: int = 10) -> dict:
    """One ``decode_step`` over ``rows`` cache rows, the device waited for
    after each (host and device together), as the engine's window and
    sequential decoding call it."""
    T = module.num_patches + PINK_PROMPT_LEN + PINK_NEW_TOKENS
    with torch.inference_mode():
        cache = module.make_cache(rows, T, device="cuda")
        tok = torch.full((rows,), 1000, device="cuda")
        pos = torch.full((rows,), T // 2, device="cuda")

        def step():
            module.decode_step(tok, pos, cache)
            torch.cuda.synchronize()

        saved = read_counts()
        out = pct(host_ms(step, steps, warmup=3))
    for fn in KERNELS:  # timing launches are not path launches
        fn.launches = saved[fn.__name__]
    return out


def pink_engine(pred, gpu) -> dict:
    """Phase 11b: the engine on phase 9's module; returns the launches of
    its passes."""
    t_phase = time.perf_counter()
    module = pred.shell.module
    ad = PinkAdapter(module, PINK_PROMPT_LEN, PINK_NEW_TOKENS, has_image=True,
                     extra_slots=ENGINE_EXTRA)
    eng = ContinuousBatchingEngine(ad, slots=ENGINE_SLOTS, max_new_tokens=PINK_NEW_TOKENS,
                                   eos_id=pred.eos_id, step_tokens=ENGINE_WINDOW)
    reqs = engine_pink_requests()
    by_id = dict(reqs)
    # sequential generate over the same requests (greedy: generate does not sample)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = {rid: sequential_tokens(module, eng, d, d["max_new"]) for rid, d in reqs}
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    k = next((i for i, t in enumerate(seq["p3"]) if i >= 2 and t not in seq["p3"][:i]), 0)
    by_id["p3"]["stop"] = [[seq["p3"][k]]]
    totals = dict(NO_LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    stats, counts, log = engine_pass(eng, reqs, cancel=("p4",))
    peak = torch.cuda.max_memory_allocated() / 1e9
    for key, n in counts.items():
        totals[key] += n
    out = stats["outputs"]
    greedy = [rid for i, (rid, _) in enumerate(reqs) if ENGINE_ROLES.get(i) in (None, "text_only")]
    readings = {rid: agree(eng, by_id[rid], out[rid], seq[rid]) for rid in greedy}
    stop = out["p3"]
    readings["p3"] = agree(eng, by_id["p3"], stop, seq["p3"][:k]) if stop != seq["p3"][:k] \
        else dict(equal=True, first_diff=None, margin=0.0)
    seq_tokens = sum(len(t) for t in seq.values())
    emit(phase="engine", part="pink_pass", gpu=gpu, slots=ENGINE_SLOTS, window=ENGINE_WINDOW,
         requests=ENGINE_REQUESTS, **stats_line(stats), peak_mem_gb=peak,
         sequential_s=seq_s, sequential_tokens=seq_tokens,
         sequential_tokens_per_s=seq_tokens / seq_s,
         speedup_tokens_per_s=stats["tokens_per_s"] / (seq_tokens / seq_s),
         launches=counts, windows=len(log.windows), admissions=len(log.prefills),
         host_ms=log.host_ms(), agreement=readings, tie_max=ENGINE_TIE_MAX, cancelled=sorted(stats["cancelled"]),
         evicted=sorted(stats["evicted"]), outputs={r: out[r] for r in ("p1", "p2", "p3", "p4",
                                                                        "p5")})
    check(all(w == window_launches(GEMVS_PER_STEP) for w in log.windows),
          f"engine windows launched {log.windows[:3]}; expected "
          f"{window_launches(GEMVS_PER_STEP)} each")
    admission = {**NO_LAUNCHES, "flash_fwd": PINK_LAYERS, "int4_gemv": 1}
    kinds = [0 if got == admission else 1 if got == {**admission,
                                                      "small_attention": PINK_VIT_LAYERS} else -1
             for got in log.prefills]
    check(sorted(kinds) == [0, 0] + [1] * (ENGINE_REQUESTS - 2) and not log.extends,
          f"engine admissions launched {log.prefills}; expected {admission}, with "
          f"{PINK_VIT_LAYERS} K1 for an image")
    check(all(agrees(r) for r in readings.values()), f"engine tokens differ from sequential "
          f"generate beyond a near-tie: {readings}")
    check(stats["cancelled"] == {"p4"} and len(out["p4"]) <= ENGINE_WINDOW, "engine: cancel")
    check(stats["evicted"] == {"p5"} and len(out["p5"]) < by_id["p5"]["max_new"],
          "engine: deadline")
    check(seq["p3"][k] not in stop, "engine: the stop token was emitted")
    for rid in ("p1", "p2"):
        check(0 < len(out[rid]) <= by_id[rid]["max_new"] and all(0 <= t < PINK_VOCAB
                                                                  for t in out[rid]),
              f"engine: sampled {rid}")

    # the sampled requests again, in another order beside other requests
    again, counts, _ = engine_pass(eng, [reqs[0], reqs[15], reqs[2], reqs[1]])
    for key, n in counts.items():
        totals[key] += n
    same_draws = all(again["outputs"][r] == out[r] for r in ("p1", "p2"))
    emit(phase="engine", part="pink_sampling_reordered", same_tokens=same_draws,
         outputs={r: again["outputs"][r] for r in ("p1", "p2")})
    check(same_draws, "engine: sampled tokens depend on the schedule")

    # chunked admission of the same requests: chunk 0 prefilled, the rest
    # of each prompt appended 16 tokens at a time, up to 8 chunks between
    # windows
    plain = [(rid, {k: v for k, v in d.items() if k not in ("deadline_s",)}) for rid, d in reqs
             if ENGINE_ROLES.get(int(rid[1:])) in (None, "text_only")]
    chunked, counts, log = engine_pass(eng, plain, chunk=ENGINE_CHUNK)
    for key, n in counts.items():
        totals[key] += n
    creadings = {rid: agree(eng, d, chunked["outputs"][rid], seq[rid]) for rid, d in plain}
    emit(phase="engine", part="pink_chunked", chunk=ENGINE_CHUNK, **stats_line(chunked),
         launches=counts, extends=len(log.extends), host_ms=log.host_ms(), agreement=creadings)
    check(all(e == {**NO_LAUNCHES, "int4_gemv": GEMVS_PER_STEP} for e in log.extends)
          and log.extends, f"engine chunked extends launched {log.extends[:3]}")
    check(all(agrees(r) for r in creadings.values()), f"engine chunked tokens: {creadings}")

    # a prefix (the image and 16 tokens) registered once, 4 suffixes forked
    rng = np.random.default_rng(SEED + 31)
    img = rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
    prefix = np.concatenate([[101], rng.integers(1000, 30000, ENGINE_PREFIX - 1)]).astype(np.int64)
    suffixes = [rng.integers(1000, 30000, int(n)).astype(np.int64)
                for n in rng.integers(8, 25, ENGINE_SUFFIXES)]
    eng.reset()
    log = LaunchLog(eng)
    zero_counts()
    eng.register_prefix("sys", {"input_ids": prefix, "image_data": img})
    pstats = eng.run([(f"s{i}", {"prefix": "sys", "input_ids": s, "max_new": ENGINE_SHORT})
                      for i, s in enumerate(suffixes)])
    counts = read_counts()
    log.undo(eng)
    eng.drop_prefix("sys")
    for key, n in counts.items():
        totals[key] += n
    preadings = {}
    for i, s in enumerate(suffixes):
        full = {"input_ids": np.concatenate([prefix, s]), "image_data": img}
        full["input_mask"] = np.ones_like(full["input_ids"])
        preadings[f"s{i}"] = agree(eng, full, pstats["outputs"][f"s{i}"],
                                   sequential_tokens(module, eng, full, ENGINE_SHORT))
    emit(phase="engine", part="pink_prefix", **stats_line(pstats), launches=counts,
         admissions=len(log.prefills), extends=len(log.extends), agreement=preadings)
    check(len(log.prefills) == 1 and len(log.extends) == ENGINE_SUFFIXES,
          "engine prefix: one prefill, an extend a suffix")
    check(all(agrees(r) for r in preadings.values()), f"engine prefix tokens: {preadings}")

    # a two-turn session beside two plain requests, against a full re-prefill
    eng.reset()
    zero_counts()
    first = {**by_id["p0"], "max_new": ENGINE_SHORT, "session": True}
    eng.submit("t1", first)
    eng.submit(*reqs[6])
    eng.submit(*reqs[7])
    while "t1" not in eng._done:
        eng.step()
    turn = np.random.default_rng(SEED + 32).integers(1000, 30000, ENGINE_TURN).astype(np.int64)
    eng.continue_session("t1", "t2", {"input_ids": turn, "max_new": ENGINE_SHORT})
    while "t2" not in eng._done:
        eng.step()
    counts = read_counts()
    for key, n in counts.items():
        totals[key] += n
    gen1, gen2 = eng._done["t1"], eng._done["t2"]
    n1 = int(first["input_mask"].sum())
    conv = np.concatenate([first["input_ids"][:n1], gen1, turn]).astype(np.int64)
    full = {"input_ids": conv, "input_mask": np.ones_like(conv),
            "image_data": first["image_data"]}
    sreading = agree(eng, full, gen2, sequential_tokens(module, eng, full, ENGINE_SHORT))
    eng.close_session("t2")
    emit(phase="engine", part="pink_session", turn_tokens=ENGINE_TURN, first_turn=gen1,
         second_turn=gen2, agreement=sreading, launches=counts)
    check(agrees(sreading), f"engine session against a full re-prefill: {sreading}")

    # kv_int8: the same module serves from an int8 cache
    module.kv_int8 = True
    try:
        qeng = ContinuousBatchingEngine(
            PinkAdapter(module, PINK_PROMPT_LEN, PINK_NEW_TOKENS, has_image=True),
            slots=ENGINE_SLOTS, max_new_tokens=PINK_NEW_TOKENS, eos_id=pred.eos_id,
            step_tokens=ENGINE_WINDOW)
        torch.cuda.reset_peak_memory_stats()
        qstats, counts, qlog = engine_pass(qeng, plain[:ENGINE_SLOTS])
        qpeak = torch.cuda.max_memory_allocated() / 1e9
        qreadings = {rid: agree(qeng, d, qstats["outputs"][rid],
                                sequential_tokens(module, qeng, d, d["max_new"]))
                     for rid, d in plain[:2]}
        cache_bytes = {q: sum(t.numel() * t.element_size() for layer in e._state["cache"]
                              for t in layer.values()) for q, e in (("bf16", eng), ("int8", qeng))}
    finally:
        module.kv_int8 = False
    for key, n in counts.items():
        totals[key] += n
    emit(phase="engine", part="pink_kv_int8", **stats_line(qstats), peak_mem_gb=qpeak,
         pool_cache_bytes=cache_bytes, launches=counts, host_ms=qlog.host_ms(),
         agreement=qreadings)
    check(all(agrees(r) for r in qreadings.values()), f"engine kv_int8 tokens: {qreadings}")
    check(cache_bytes["int8"] < 0.6 * cache_bytes["bf16"], "engine: the int8 pool is not smaller")

    emit(phase="engine", part="pink_idle", gpu=gpu, **engine_idle(eng, plain, gpu),
         decode_step_ms={rows: decode_step_ms(module, rows) for rows in (1, ENGINE_SLOTS)})
    emit(phase="engine", part="pink_summary", seconds=time.perf_counter() - t_phase,
         launches=totals)
    return totals


def pink_int8_twins(seed: int, layers: int = 2, kv_int8: bool = True):
    """Pink at full width and ``layers`` decoder layers with the int8
    cache (or without, ``kv_int8`` off): bf16 on the card seeded there, and
    fp32 on the CPU from the same values."""
    opts = ["model_attributes.pink.kv_int8", str(kv_int8).lower()]
    for key, value in {**PINK_MODEL, "lm_preset": pink_layers(layers)}.items():
        opts += [f"model_attributes.pink.{key}", str(value)]
    shells = []
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        cfg = build_config(PINK_CONFIG, opts=opts + ["model_attributes.pink.dtype_str", dtype])
        with no_default_init():
            shells.append(build_model(cfg, device=device))
    card, cpu = shells
    card.init(seed, on_device=True)
    weights.load_flax_params(cpu.module, export_flax_params(card.module))
    return card, cpu


def int8_logits(step, token=None, steps: int = INT8_STEPS):
    """fp32 logits of ``steps`` decode steps after a prefill; ``step(cache,
    token, t)`` decodes one; fed ``token`` (the CPU's), or greedy."""
    out, toks = [], []
    logits, cache, advance = step(None, None, 0)
    for t in range(steps):
        tok = logits.argmax(-1) if token is None else token[t].to(logits.device)
        toks.append(tok.cpu())
        logits, cache, _ = step(cache, tok, t)
        out.append(logits[0].float().cpu())
    return out, toks


def pink_int8_steps(module, batch):
    def step(cache, tok, t):
        with torch.inference_mode():
            if cache is None:
                lens = batch["input_mask"].sum(-1)
                cache = module.make_cache(1, module.num_vision_tokens(batch) + PINK_PROMPT_LEN
                                          + INT8_STEPS + 1, device=batch["input_ids"].device)
                logits, cache = module.prefill(batch, cache, lens)
                return logits, cache, None
            pos = module.num_vision_tokens(batch) + batch["input_mask"].sum(-1) + t
            logits, cache = module.decode_step(tok, pos, cache)
            return logits, cache, None
    return step


def m2_int8_steps(module, batch):
    state = {}

    def step(cache, tok, t):
        with torch.inference_mode():
            if cache is None:
                logits, cache, state["slot"], state["rope"] = module.prefill(batch, INT8_STEPS + 1)
                return logits, cache, None
            logits, cache = module.decode_step(tok, state["rope"] + t, state["slot"] + t, cache)
            return logits, cache, None
    return step


def int8_faults():
    """The int8 cache's scales misread on the card (the CPU reads first):
    the key scales one slot off; the value scales not applied."""
    from antmmf_torch.modules import llm as llm_mod

    real = llm_mod.int8_scale_rows

    def k_scale_one_slot_off(cache):
        k_row, v_row = real(cache)
        return torch.roll(k_row, 1, dims=-1), v_row

    def v_scale_not_applied(cache):
        k_row, v_row = real(cache)
        return k_row, torch.ones_like(v_row)

    return [(fn.__name__, lambda fn=fn: setattr(llm_mod, "int8_scale_rows", fn),
             lambda: setattr(llm_mod, "int8_scale_rows", real))
            for fn in (k_scale_one_slot_off, v_scale_not_applied)]


def int8_compare(card_steps, cpu_steps, faults: bool) -> dict:
    """Card against CPU over the decode steps: the worst step's cosine and
    |Δ| over the spread; with ``faults``, each planted fault's."""
    ref, toks = int8_logits(cpu_steps)

    def reading():
        got, _ = int8_logits(card_steps, toks)
        rs = [compare_logits(g, r) for g, r in zip(got, ref)]
        return dict(cos=min(r["cos"] for r in rs),
                    max_abs_d_over_std=max(r["max_abs_d_over_std"] for r in rs))

    res = {"sound": reading()}
    for name, plant, undo in (int8_faults() if faults else ()):
        plant()
        try:
            res[name] = reading()
        finally:
            undo()
    return res


def int8_within_bound(res) -> bool:
    return res["cos"] >= INT8_COS_MIN and res["max_abs_d_over_std"] <= INT8_DLOGIT_MAX


def pink_int8_reading(seed: int, faults: bool = True) -> dict:
    card, cpu = pink_int8_twins(seed)
    rng = np.random.default_rng(seed + 40)
    n = 48
    ids = np.zeros(PINK_PROMPT_LEN, np.int64)
    ids[0], ids[1:n] = 101, rng.integers(1000, 30000, n - 1)
    arrays = {"input_ids": ids[None], "input_mask": (np.arange(PINK_PROMPT_LEN) < n)[None]
              .astype(np.int64), "image_data": rng.standard_normal((1, SIZE, SIZE, 3))
              .astype(np.float32)}
    res = int8_compare(pink_int8_steps(card.module, card.to_device(arrays)),
                       pink_int8_steps(cpu.module, cpu.to_device(arrays)), faults)
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return res


def engine_int8_check(name: str, res: dict) -> None:
    caught = {n: not int8_within_bound(r) for n, r in res.items() if n != "sound"}
    emit(phase="engine", part=f"{name}_kv_int8_card_vs_cpu", steps=INT8_STEPS, **res["sound"],
         faults={n: r for n, r in res.items() if n != "sound"}, faults_caught=caught,
         cos_min=INT8_COS_MIN, dlogit_max=INT8_DLOGIT_MAX)
    check(int8_within_bound(res["sound"]), f"{name} kv_int8: card and CPU disagree beyond "
          f"the stated bound")
    check(all(caught.values()), f"{name} kv_int8: a planted fault passed: {caught}")


def engine_cli(gpu) -> dict:
    """Phase 11b (d): ``python -m antmmf_torch.predictors.cli --engine``
    in-process through ``cli.main`` on four text-only requests, Pink at full
    width and 2 decoder layers seeded on the card; the printed tokens
    against an in-process engine on the same seeded model. Returns the
    launches of the CLI's run."""
    from antmmf_torch.predictors import cli

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="engine_cli_", dir=build)
    rng = np.random.default_rng(SEED + 33)
    rows = [{"id": f"c{i}", "input_ids": [101] + rng.integers(1000, 30000, int(n)).tolist()}
            for i, n in enumerate(rng.integers(8, 30, CLI_REQUESTS))]
    argv = ["--config", PINK_CONFIG, "--device", "cuda", "--no_ckpt", "--slots", "4",
            "--step_tokens", str(ENGINE_WINDOW), "--max_new", str(CLI_NEW),
            "model_attributes.pink.dtype_str", "bfloat16",
            "predictor_parameters.init_on_device", "true"]
    for key, value in {**PINK_MODEL, "lm_preset": pink_layers(CLI_LAYERS)}.items():
        argv += [f"model_attributes.pink.{key}", str(value)]
    try:
        path = os.path.join(root, "reqs.jsonl")
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
        argv[2:2] = ["--engine", path]
        zero_counts()
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), no_default_init():
            cli.main(argv)
        cli_s = time.perf_counter() - t0
        counts = read_counts()
        lines = [json.loads(line) for line in stdout.getvalue().strip().splitlines()]
        printed = {r["id"]: r["tokens"] for r in lines[:-1]}
        _, config, _ = cli.parse(argv)
        with no_default_init():
            shell = build_model(config, device="cuda")
        shell.init(on_device=True)
        ad = PinkAdapter(shell.module, max(len(r["input_ids"]) for r in rows), CLI_NEW,
                         has_image=False)
        want = ContinuousBatchingEngine(ad, slots=4, max_new_tokens=CLI_NEW, eos_id=-1,
                                        step_tokens=ENGINE_WINDOW).run(
            [(r["id"], {"input_ids": np.asarray(r["input_ids"])}) for r in rows])["outputs"]
        del shell, ad
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="engine", part="cli", gpu=gpu, layers=CLI_LAYERS, seconds=cli_s, launches=counts,
         printed=printed, stats=lines[-1]["stats"], same_tokens=printed == want)
    check(printed == want, "cli --engine printed other tokens than the in-process engine")
    check(counts == {**NO_LAUNCHES, "flash_fwd": CLI_LAYERS * CLI_REQUESTS},
          f"cli --engine launches {counts}")
    return counts


def phase_engine(pred, gpu) -> dict:
    """Phase 11b: (a) the engine on Pink int4, (c) Pink's int8 cache card vs
    CPU, (d) ``cli --engine``. Returns the launches of (a) and (d)."""
    t0 = time.perf_counter()
    totals = pink_engine(pred, gpu)
    engine_int8_check("pink", pink_int8_reading(SEED))
    for key, n in engine_cli(gpu).items():
        totals[key] += n
    emit(phase="engine", part="summary", seconds=time.perf_counter() - t0, launches=totals)
    return totals


# ------------------------------------------------------------ phase 11c
# The decoding surface on phase 9's Pink int4 module: (a) pink_eval over
# EVAL_ROWS seeded rows at batch EVAL_BATCH, greedy, beams, speculation and
# sampling; (b) the generation predictor's modes with K8's row counts a
# step, and Pink's decode_quant int8 at full width beside bf16 and int4; (c)
# beams, sampling and int8 weights card bf16 against CPU fp32 at 2 decoder
# layers. Beams run K8 at B·num_beams rows (3 for one request, 24 for an
# eval batch), a verify step of speculation at B·(gamma + 1) (5; an eval
# batch's 40 rows pass GEMV_MAX_ROWS and take unpack + matmul).
EVAL_ROWS, EVAL_BATCH, EVAL_NEW = 16, 8, 16
DECODE_BEAMS, DECODE_GAMMA = 3, 4
SAMPLING = dict(top_p=0.9, temperature=0.8, seed=5)
STEP_ROWS = {"greedy": 1, "beams": DECODE_BEAMS, "speculative": DECODE_GAMMA + 1, "sampled": 1}
EVAL_MODES = {"greedy": [], "beams": ["--num_beams", str(DECODE_BEAMS)],
              "speculative": ["--speculate", str(DECODE_GAMMA)],
              "sampled": ["--do_sample", "--top_p", str(SAMPLING["top_p"]), "--temperature",
                          str(SAMPLING["temperature"]), "--seed", str(SAMPLING["seed"])]}
DECODE_LAYERS = 2  # card vs CPU: full width at 2 of the 22 decoder layers
# card bf16 vs CPU fp32 (``--calibrate decoding`` reads them): the card's
# best beam's normalised score against the CPU's log-probabilities of the
# same tokens (|Δ|) and against the card's replay of them at the search's
# shapes; the CPU's probability mass strictly above each token the card
# sampled at top_p 0.5, less 0.5 (> 0: outside the CPU's nucleus); the int8
# kernels the card dequantises against the CPU's bf16 product of the same
# records (largest |Δ|), and the logits of a prefill and three decode steps
# on them (cos, |Δ| over the spread). Sound runs over three seeds read
# |Δscore| 0.0004 to 0.0082 against the CPU and 0 against the replay,
# excess -0.044 to -0.016, the dequantised kernels exact, cos 0.99989 and
# 0.073 of the spread. Planted at each of the three seeds: the beams' cache
# rows rolled read 0.014 to 0.066 against the replay (0.0023 to 0.081
# against the CPU: at two seeds under bf16's noise, so only the replay's
# bound is held to catch it); the beams' length penalty dropped 94.8 to
# 99.1 against the CPU; the nucleus filter skipped 0.36 to 0.46; the scale
# multiplied in fp32 0.00024 on the kernels (H100 readings).
# BEAM_DSCORE_MAX is 3x the largest sound |Δscore|.
BEAM_DSCORE_MAX, BEAM_REPLAY_MAX, SAMPLE_EXCESS_MAX, SAMPLE_TOP_P = 0.025, 1e-5, 0.05, 0.5
DEQUANT_DEV_MAX = 0.0
DECODE_COS_MIN, DECODE_DLOGIT_MAX = 0.999, 0.25


def write_eval_rows(root: str, seed: int) -> str:
    """EVAL_ROWS VQA rows over seeded OpenCV images of 280..420 × 300..500;
    returns the jsonl's path."""
    import cv2

    rng = np.random.default_rng(seed)
    words = ("dog", "cat", "kitchen", "red", "two", "window", "person", "car")
    rows = []
    for i in range(EVAL_ROWS):
        h, w = int(rng.integers(280, 421)), int(rng.integers(300, 501))
        cv2.imwrite(os.path.join(root, f"{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
        q = " ".join(rng.choice(words, int(rng.integers(3, 12))))
        rows.append({"image": f"{i}.png", "question": f"what is the {q} doing?",
                     "answers": [str(a) for a in rng.choice(words, 3)]})
    path = os.path.join(root, "rows.jsonl")
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return path


def eval_run(shell, path: str, extra) -> dict:
    """``pink_eval.main`` on the loaded model: the printed summary, seconds,
    launches (set to 0 just before, read just after) and each generate's
    (batch, tokens, lens)."""
    from antmmf_torch.scripts import pink_eval

    module, calls = shell.module, []
    real = module.generate

    def recorded(batch, **kw):
        tokens, lens = real(batch, **kw)
        calls.append((batch, tokens, lens))
        return tokens, lens

    argv = ["--config", PINK_CONFIG, "--annotations", path, "--image_dir",
            os.path.dirname(path), "--task", "vqa", "--batch_size", str(EVAL_BATCH),
            "--max_prompt_len", str(PINK_PROMPT_LEN), "--max_new_tokens", str(EVAL_NEW),
            "--image_size", str(SIZE), "--device", "cuda", *extra]
    module.generate = recorded
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            summary = pink_eval.main(argv, shell=shell)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        del module.generate
    check(json.loads(printed.getvalue()) == summary, "pink_eval printed another summary")
    return dict(summary=summary, seconds=seconds, launches=counts, calls=calls)


def forced_margin(module, batch, row: int, want: list, got: int, j: int) -> float:
    """|l[want_j] - l[got]| / std(l) of one row's logits at new token j,
    teacher-forced on ``want[:j]`` through the model's prefill and decode
    steps (one row, as ``tie_margin`` reads the engine's)."""
    one = {k: v[row:row + 1] for k, v in batch.items()}
    with torch.inference_mode():
        lens = one["input_mask"].sum(-1)
        Lv = module.num_vision_tokens(one)
        cache = module.make_cache(1, Lv + one["input_ids"].shape[1] + j + 1, device="cuda")
        logits, cache = module.prefill(one, cache, lens)
        for t in range(j):
            logits, cache = module.decode_step(torch.tensor([want[t]], device="cuda"),
                                               Lv + lens + t, cache)
    lg = logits[0].float()
    return float((lg[want[j]] - lg[got]).abs() / lg.std())


def eval_agreement(module, ref: dict, run: dict) -> dict:
    """A run's tokens against ``ref``'s (greedy) row by row: equal, or the
    first difference and its near-tie margin on the greedy logits."""
    out = {"rows": 0, "equal": 0, "margins": []}
    for (batch, want, lens), (_, got, _) in zip(ref["calls"], run["calls"]):
        for row in range(want.shape[0]):
            n = int(lens[row])
            w, g = want[row, n:n + EVAL_NEW].tolist(), got[row, n:n + EVAL_NEW].tolist()
            out["rows"] += 1
            j = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
            if j is None:
                out["equal"] += 1
            else:
                out["margins"].append(forced_margin(module, batch, row, w, g[j], j))
    return out


def decode_eval(pred, gpu) -> dict:
    """Phase 11c (a): pink_eval on phase 9's module in each mode; returns
    the launches."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="pink_eval_", dir=build)
    totals = dict(NO_LAUNCHES)
    try:
        path = write_eval_rows(root, SEED + 60)
        eval_run(pred.shell, path, [])  # warm-up at the eval's shapes
        runs = {mode: eval_run(pred.shell, path, extra) for mode, extra in EVAL_MODES.items()}
        runs["sampled_again"] = eval_run(pred.shell, path, EVAL_MODES["sampled"])
        runs["top_p_1e-6"] = eval_run(pred.shell, path, ["--do_sample", "--top_p", "1e-6"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batches = -(-EVAL_ROWS // EVAL_BATCH)
    for mode, run in runs.items():
        for k, n in run["launches"].items():
            totals[k] += n
        emit(phase="decoding", part="pink_eval", mode=mode, gpu=gpu, rows=EVAL_ROWS,
             batch=EVAL_BATCH, new_tokens=EVAL_NEW, seconds=run["seconds"],
             ms_per_row=run["seconds"] * 1e3 / EVAL_ROWS,
             ms_per_row_over_greedy=run["seconds"] / runs["greedy"]["seconds"],
             launches=run["launches"],
             flash_fwd_per_batch=run["launches"]["flash_fwd"] / batches,
             flash_fwd_per_row=run["launches"]["flash_fwd"] / EVAL_ROWS,
             summary=run["summary"])
        check(run["launches"]["flash_fwd"] == batches * PINK_LAYERS
              and run["launches"]["small_attention"] == batches * PINK_VIT_LAYERS,
              f"pink_eval {mode}: launches {run['launches']}")
        check(run["summary"]["n"] == EVAL_ROWS, f"pink_eval {mode}: {run['summary']}")
    module = pred.shell.module
    spec = eval_agreement(module, runs["greedy"], runs["speculative"])
    narrow = eval_agreement(module, runs["greedy"], runs["top_p_1e-6"])
    same_seed = all(torch.equal(a[1], b[1]) for a, b in zip(runs["sampled"]["calls"],
                                                            runs["sampled_again"]["calls"]))
    emit(phase="decoding", part="pink_eval_agreement", speculative_vs_greedy=spec,
         top_p_1e_6_vs_greedy=narrow, sampled_twice_same_tokens=same_seed,
         tie_max=ENGINE_TIE_MAX)
    for name, res in (("speculative", spec), ("top_p 1e-6", narrow)):
        check(all(m <= ENGINE_TIE_MAX for m in res["margins"]),
              f"pink_eval {name} tokens differ from greedy beyond a near-tie: {res}")
    check(same_seed, "pink_eval: one seed sampled two different generations")
    return totals


def decode_predictor(pred, gpu) -> dict:
    """Phase 11c (b): one request through the generation predictor in each
    mode, K8's rows logged at each launch; returns the launches."""
    from antmmf_torch.modules import qdense

    req = pink_request(np.random.default_rng(SEED + 61))
    saved = dict(pred.decode_options)
    real = qdense.int4_apply
    rows = []

    def logged(x, packed, scale, dtype):  # the rows of each call that takes K8
        n = x.numel() // x.shape[-1]
        if n <= i4.GEMV_MAX_ROWS:
            rows.append(n)
        return real(x, packed, scale, dtype)

    modes = {"greedy": {}, "beams": dict(num_beams=DECODE_BEAMS),
             "speculative": dict(speculative=DECODE_GAMMA), "sampled": dict(do_sample=True,
                                                                           **SAMPLING)}
    totals, out = dict(NO_LAUNCHES), {}
    n_prompt = int(pred.build_sample(req).arrays()["input_mask"].sum())
    for mode, options in modes.items():
        pred.decode_options = {**saved, **options}
        rows.clear()
        qdense.int4_apply = logged
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answer = pred.predict(req)
            torch.cuda.synchronize()
            request_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
        finally:
            qdense.int4_apply = real
            pred.decode_options = saved
        for k, n in counts.items():
            totals[k] += n
        per_rows = {r: rows.count(r) for r in sorted(set(rows))}
        check(sum(per_rows.values()) == counts["int4_gemv"],
              f"predictor {mode}: K8 rows logged {per_rows}, launched {counts['int4_gemv']}")
        new = np.asarray(answer["generated_ids"])[0, n_prompt:n_prompt + PINK_NEW_TOKENS]
        out[mode] = dict(request_ms=request_ms, launches=counts, k8_launches_by_rows=per_rows,
                         new_tokens=new.tolist())
        step_rows = STEP_ROWS[mode]  # lm_head at the prefill's last token: one row, once
        steps = (per_rows.get(step_rows, 0) - (step_rows == 1)) / GEMVS_PER_STEP
        timing = pred.int4_step_ms.get(step_rows, {})
        emit(phase="decoding", part="predictor", mode=mode, gpu=gpu, request_ms=request_ms,
             new_tokens_per_s=PINK_NEW_TOKENS * 1e3 / request_ms, launches=counts,
             k8_launches_by_rows=per_rows, k8_rows_a_step=step_rows, decode_steps=steps,
             k8_step_ms=timing.get("ms"), bf16_matmul_step_ms=timing.get("library_ms"),
             k8_step_bound_ms=timing.get("bound_ms"), new_tokens=new.tolist(),
             text=answer["generated_text"])
        check(counts["flash_fwd"] == PINK_LAYERS and counts["small_attention"] == PINK_VIT_LAYERS,
              f"predictor {mode}: launches {counts}")
        check(per_rows.get(1, 0) >= 1 and steps == int(steps) and 1 <= steps < PINK_NEW_TOKENS,
              f"predictor {mode}: K8 launches by rows {per_rows}")
    check(out["beams"]["k8_launches_by_rows"] == {1: 1, DECODE_BEAMS: (PINK_NEW_TOKENS - 1)
                                                  * GEMVS_PER_STEP},
          f"beams: K8 launches by rows {out['beams']['k8_launches_by_rows']}")
    same = out["speculative"]["new_tokens"] == out["greedy"]["new_tokens"]
    check(same or forced_margin_reading(pred, req, out) <= ENGINE_TIE_MAX,
          "predictor: speculative tokens differ from greedy beyond a near-tie")
    return totals


def forced_margin_reading(pred, req, out) -> float:
    batch = pred.shell.to_device(pred.build_sample(req).arrays())
    want, got = out["greedy"]["new_tokens"], out["speculative"]["new_tokens"]
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    return forced_margin(pred.shell.module, batch, 0, want, got[j], j)


def decode_int8(pred4, gpu) -> None:
    """Phase 11c (b): Pink at full width seeded on the card in bf16, decode
    steps timed; quantised to int8 in place on the card, timed again, one
    request served; beside phase 9's int4 steps."""
    torch.cuda.reset_peak_memory_stats()
    pred = pink_predictor(quant="", on_device=True)
    module = pred.shell.module
    req = pink_request(np.random.default_rng(SEED + 62))
    arrays = pred.build_sample(req).arrays()

    def projections():
        return [m for m in module.modules() if isinstance(m, QuantDense)]

    def weight_bytes():
        return sum(t.numel() * t.element_size() for m in projections()
                   for t in (m.weight, m.kernel_q8, m.kernel_scale) if t is not None)

    readings = {}
    for name in ("bf16", "int8"):
        if name == "int8":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served = quantize_module_for_decode(module, bits=8)
            torch.cuda.synchronize()
            readings.update(quantise_s=time.perf_counter() - t0, served_dequantised=served)
        decode_walk(pred, arrays, 3)  # warm-up
        prefill, steps, _ = decode_walk(pred, arrays, PINK_NEW_TOKENS - 1)
        readings[name] = dict(prefill_ms=prefill, decode_step_ms=pct(steps),
                              projection_weight_bytes=weight_bytes(),
                              mem_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    zero_counts()
    out = pred.predict(req)
    counts = read_counts()
    n8 = sum(m.kernel_q8 is not None for m in projections())
    emit(phase="decoding", part="pink_int8", gpu=gpu, **readings,
         int4_decode_step_p50_ms=pred4.decode_step_p50_ms, int8_projections=n8,
         request_launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         text=out["generated_text"])
    check(n8 == GEMVS_PER_STEP, f"pink int8: {n8} int8 projections")
    check(counts == {**NO_LAUNCHES, "flash_fwd": PINK_LAYERS, "small_attention": PINK_VIT_LAYERS},
          f"pink int8 request launches {counts}")
    check(readings["int8"]["projection_weight_bytes"] < 0.55
          * readings["bf16"]["projection_weight_bytes"], "pink int8: the weights did not shrink")
    del pred, module
    gc.collect()
    torch.cuda.empty_cache()


def decode_twins(seed: int):
    """Pink at full width and DECODE_LAYERS decoder layers: bf16 on the card
    seeded there, fp32 on the CPU from the same values."""
    return pink_int8_twins(seed, DECODE_LAYERS, kv_int8=False)


def decode_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed + 70)
    n = 40
    ids = np.zeros(PINK_PROMPT_LEN, np.int64)
    ids[0], ids[1:n] = 101, rng.integers(1000, 30000, n - 1)
    return {"input_ids": ids[None], "input_mask": (np.arange(PINK_PROMPT_LEN) < n)[None]
            .astype(np.int64), "image_data": rng.standard_normal((1, SIZE, SIZE, 3))
            .astype(np.float32)}


def forced_logprobs(module, batch, tokens: list, temperature: float = 1.0):
    """The CPU's fp32 log-softmax of logits / temperature before each of
    ``tokens``, teacher-forced (prefill, then a decode step a token)."""
    out = []
    with torch.inference_mode():
        lens = batch["input_mask"].sum(-1)
        Lv = module.num_vision_tokens(batch)
        cache = module.make_cache(1, Lv + batch["input_ids"].shape[1] + len(tokens) + 1,
                                  device=batch["input_ids"].device)
        logits, cache = module.prefill(batch, cache, lens)
        for t, tok in enumerate(tokens):
            out.append(torch.log_softmax(logits[0].float() / temperature, -1).cpu())
            if t < len(tokens) - 1:
                logits, cache = module.decode_step(torch.tensor([tok], device=logits.device),
                                                   Lv + lens + t, cache)
    return out


def beam_replay(card, arrays, best: list) -> float:
    """The card's normalised score of ``best`` replayed as the search runs
    it: a one-row prefill repeated to DECODE_BEAMS rows, then a decode step
    a token at DECODE_BEAMS identical rows (each matmul at the search's
    shapes, so the same kernels give the same bits), the log-probabilities
    summed in fp32 up to EOS, over the tokens that are not EOS plus one."""
    K = DECODE_BEAMS
    module, batch = card.module, card.to_device(arrays)
    with torch.inference_mode():
        lens = batch["input_mask"].sum(-1)
        Lv = module.num_vision_tokens(batch)
        cache = module.make_cache(1, Lv + batch["input_ids"].shape[1] + len(best), device="cuda")
        logits, cache = module.prefill(batch, cache, lens)  # the search's first token: one row
        cache = [{n: c.repeat_interleave(K, 0) for n, c in layer.items()} for layer in cache]
        pos = (Lv + lens).repeat_interleave(K)
        score, done = None, False
        for t, tok in enumerate(best):
            logp = torch.log_softmax(logits.float(), dim=-1)[0, tok]
            if not done:
                score = logp if score is None else score + logp
            done = done or tok == 102
            if t < len(best) - 1:
                logits, cache = module.decode_step(torch.full((K,), tok, device="cuda"),
                                                   pos + t, cache)
        length = torch.tensor(float(sum(t != 102 for t in best) + 1), device="cuda")
    return float(score / length ** 1.0)


def beam_reading(card, cpu, arrays) -> dict:
    """The card's best beam (K = DECODE_BEAMS, EVAL_NEW tokens) and its
    normalised score: against the card's replay of the same tokens at the
    search's shapes (|Δ|; the search's cache and scores, bit for bit in a
    sound run), and against the CPU's fp32 log-probabilities of those tokens
    normalised as ``beam_search_cached`` normalises (EOS frozen at 0)."""
    stats = {}
    with torch.inference_mode():
        tokens, lens = card.module.generate(card.to_device(arrays), eos_id=102,
                                            max_length=EVAL_NEW, num_beams=DECODE_BEAMS,
                                            stats=stats)
    n = int(lens[0])
    best = tokens[0, n:n + EVAL_NEW].tolist()
    logps = forced_logprobs(cpu.module, cpu.to_device(arrays), best)
    total, done = 0.0, False
    for tok, lp in zip(best, logps):
        if not done:
            total += float(lp[tok])
        done = done or tok == 102
    cpu_score = total / (sum(t != 102 for t in best) + 1)
    card_score = float(stats["scores"][0])
    return dict(card_score=card_score, replay_dev=abs(card_score - beam_replay(card, arrays, best)),
                cpu_score=cpu_score, d_score=abs(card_score - cpu_score), tokens=best)


def sample_reading(card, cpu, arrays, cpu_draw: bool = True) -> dict:
    """Tokens the card samples at top_p SAMPLE_TOP_P: the CPU's probability
    mass strictly above each, at its step, less top_p (the worst step; > 0:
    outside the CPU's nucleus); with ``cpu_draw``, how many tokens the CPU
    twin draws alike from the same seed."""
    kw = dict(eos_id=-1, max_length=EVAL_NEW, do_sample=True, top_p=SAMPLE_TOP_P,
              temperature=1.0, seed=SAMPLING["seed"])
    with torch.inference_mode():
        tokens, lens = card.module.generate(card.to_device(arrays), **kw)
    n = int(lens[0])
    drawn = tokens[0, n:n + EVAL_NEW].tolist()
    excess = []
    for tok, lp in zip(drawn, forced_logprobs(cpu.module, cpu.to_device(arrays), drawn)):
        p = lp.exp()
        excess.append(float(p[p > p[tok]].sum()) - SAMPLE_TOP_P)
    out = dict(excess=max(excess), tokens=drawn)
    if cpu_draw:
        with torch.inference_mode():
            cpu_tokens, _ = cpu.module.generate(cpu.to_device(arrays), **kw)
        out["same_as_cpu_draw"] = int(sum(a == b for a, b in zip(
            drawn, cpu_tokens[0, n:n + EVAL_NEW].tolist())))
    return out


def int8_reading(card, cpu, arrays) -> dict:
    """Both twins quantised to int8 on their own device: the records byte
    for byte; the kernels the card dequantises against the CPU's bf16
    product of the same records; the logits of a prefill and three decode
    steps (teacher-forced with the CPU's tokens)."""
    served = [quantize_module_for_decode(m.module, bits=8) for m in (card, cpu)]
    pairs = [(a, b) for a, b in zip(card.module.modules(), cpu.module.modules())
             if isinstance(a, QuantDense) and a.kernel_q8 is not None]
    records_equal = all(torch.equal(a.kernel_q8.cpu(), b.kernel_q8)
                        and torch.equal(a.kernel_scale.cpu(), b.kernel_scale) for a, b in pairs)
    ref_logits = int8_logits(pink_int8_steps(cpu.module, cpu.to_device(arrays)))
    # JAX's bf16 product on the CPU: the fp32 product of the bf16 values is
    # exact, so its rounding to bf16 is the bf16 multiply's
    ref_kernels = [(b.kernel_q8.float() * b.kernel_scale.to(torch.bfloat16).float())
                   .to(torch.bfloat16) for _, b in pairs]

    def reading():
        with torch.inference_mode():
            dev = max(float((a.int8_weight().cpu().float() - ref.float()).abs().max())
                      for (a, _), ref in zip(pairs, ref_kernels))
        got, _ = int8_logits(pink_int8_steps(card.module, card.to_device(arrays)), ref_logits[1])
        rs = [compare_logits(g, r) for g, r in zip(got, ref_logits[0])]
        return dict(dequant_max_abs_dev=dev, cos=min(r["cos"] for r in rs),
                    max_abs_d_over_std=max(r["max_abs_d_over_std"] for r in rs))

    return dict(served=served, int8_kernels=len(pairs), records_equal=records_equal,
                reading=reading)


def decode_faults(card):
    """Faults planted on the card only (the CPU reads first): (the bound of
    ``decode_within_bound`` that must catch it, name, plant, undo). The
    beams' cache rows rolled by one before each decode step (a beam reads
    another's keys); the beams' length penalty dropped (the best beam's
    score is its raw sum); the nucleus filter skipped (a draw from the whole
    softmax); the int8 scale multiplied in fp32, then cast."""
    module = card.module
    from antmmf_torch.utils import text_utils

    def rolled(tok, pos, cache):
        return type(module).decode_step(module, tok, pos, [
            {n: t.roll(1, 0) for n, t in layer.items()} for layer in cache])

    real_best = text_utils._best
    real_filter = text_utils.top_p_filter
    real_weight = QuantDense.int8_weight

    def fp32_scale(self):
        return (self.kernel_q8.float() * self.kernel_scale).to(self.dtype)

    return [("beam_replay", "beam_cache_rows_rolled",
             lambda: setattr(module, "decode_step", rolled),
             lambda: module.__dict__.pop("decode_step", None)),
            ("beam_cpu", "beam_length_penalty_dropped",
             lambda: setattr(text_utils, "_best", lambda tokens, scores, eos_id, penalty:
                             real_best(tokens, scores, eos_id, 0.0)),
             lambda: setattr(text_utils, "_best", real_best)),
            ("sample", "nucleus_filter_skipped",
             lambda: setattr(text_utils, "top_p_filter",
                             lambda lg, top_p, temperature: lg.float() / temperature),
             lambda: setattr(text_utils, "top_p_filter", real_filter)),
            ("int8", "int8_scale_multiplied_in_fp32",
             lambda: setattr(QuantDense, "int8_weight", fp32_scale),
             lambda: setattr(QuantDense, "int8_weight", real_weight))]


def decode_within_bound(res) -> dict:
    return {"beam_cpu": res["beam"]["d_score"] <= BEAM_DSCORE_MAX,
            "beam_replay": res["beam"]["replay_dev"] <= BEAM_REPLAY_MAX,
            "sample": res["sample"]["excess"] <= SAMPLE_EXCESS_MAX,
            "int8": res["int8"]["dequant_max_abs_dev"] <= DEQUANT_DEV_MAX
            and res["int8"]["cos"] >= DECODE_COS_MIN
            and res["int8"]["max_abs_d_over_std"] <= DECODE_DLOGIT_MAX}


def decode_readings(seed: int, faults: bool = True) -> dict:
    """Card against CPU at DECODE_LAYERS layers: sound readings, then with
    ``faults`` each planted fault's reading of its own part."""
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    card, cpu = decode_twins(seed)
    arrays = decode_arrays(seed)
    seconds = {"twins": lap()}
    res = {"beam": beam_reading(card, cpu, arrays)}
    seconds["beam"] = lap()
    res["sample"] = sample_reading(card, cpu, arrays)
    seconds["sample"] = lap()
    q = int8_reading(card, cpu, arrays)
    res["int8"] = {**q["reading"](), "records_equal": q["records_equal"],
                   "int8_kernels": q["int8_kernels"]}
    seconds["int8"] = lap()
    res["faults"], res["seconds"] = {}, seconds
    for bound, name, plant, undo in (decode_faults(card) if faults else ()):
        part = bound.split("_")[0]
        plant()
        try:
            reading = {"beam": lambda: beam_reading(card, cpu, arrays),
                       "sample": lambda: sample_reading(card, cpu, arrays, cpu_draw=False),
                       "int8": q["reading"]}[part]()
        finally:
            undo()
        res["faults"][name] = {"bound": bound, **{k: v for k, v in reading.items()
                                                  if k != "tokens"},
                               "within_bound": decode_within_bound({**res, part: reading})[bound]}
    seconds["faults"] = lap()
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return res


def decode_card_vs_cpu() -> None:
    t0 = time.perf_counter()
    res = decode_readings(SEED)
    ok = decode_within_bound(res)
    caught = {n: not f["within_bound"] for n, f in res["faults"].items()}
    emit(phase="decoding", part="card_vs_cpu", layers=DECODE_LAYERS,
         beam={k: v for k, v in res["beam"].items() if k != "tokens"},
         sample={k: v for k, v in res["sample"].items() if k != "tokens"}, int8=res["int8"],
         faults=res["faults"], part_seconds=res["seconds"], within_bound=ok,
         faults_caught=caught,
         bounds=dict(beam_dscore_max=BEAM_DSCORE_MAX, beam_replay_max=BEAM_REPLAY_MAX,
                     sample_excess_max=SAMPLE_EXCESS_MAX,
                     dequant_dev_max=DEQUANT_DEV_MAX, cos_min=DECODE_COS_MIN,
                     dlogit_max=DECODE_DLOGIT_MAX), seconds=time.perf_counter() - t0)
    check(res["int8"]["records_equal"], "int8 records made on the card differ from the CPU's")
    check(all(ok.values()), f"decoding card vs CPU beyond the stated bounds: {ok}")
    check(all(caught.values()), f"decoding: a planted fault passed its bound: {caught}")


def calibrate_decoding(seeds=3) -> None:
    """Phase 11c (c)'s readings: sound and with each planted fault, a seed
    at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in range(seeds):
        res = decode_readings(seed)
        emit(phase="calibrate_decoding", seed=seed,
             beam={k: v for k, v in res["beam"].items() if k != "tokens"},
             sample={k: v for k, v in res["sample"].items() if k != "tokens"},
             int8=res["int8"], faults=res["faults"], part_seconds=res["seconds"],
             within_bound=decode_within_bound(res))


def phase_decoding(pred, gpu) -> dict:
    """Phase 11c on phase 9's Pink int4 predictor: (a) pink_eval, (b) the
    predictor's modes and Pink int8, (c) card vs CPU. Returns the launches
    of (a) and (b)'s int4 requests."""
    t0 = time.perf_counter()
    totals = decode_eval(pred, gpu)
    for k, n in decode_predictor(pred, gpu).items():
        totals[k] += n
    decode_int8(pred, gpu)
    decode_card_vs_cpu()
    emit(phase="decoding", part="summary", seconds=time.perf_counter() - t0, launches=totals)
    return totals


def m2_engine(pred, served: dict, gpu) -> dict:
    """Phase 19 (e): the engine on phase 19's full-depth model: 4 slots,
    windows of 8, the three requests twice (24 new tokens) against phase
    19's sequential tokens, and a two-turn text session against a full
    re-prefill. Returns the launches."""
    t_phase = time.perf_counter()
    module = pred.shell.module
    ad = M2OmniAdapter(module, SERVING_SEQ_LEN, M2_NEW_TOKENS, has_image=True,
                       extra_slots=ENGINE_EXTRA)
    eng = ContinuousBatchingEngine(ad, slots=M2_ENGINE_SLOTS, max_new_tokens=M2_NEW_TOKENS,
                                   eos_id=pred.eos_id, step_tokens=ENGINE_WINDOW)

    def data_of(request) -> dict:
        arrays = pred.build_sample(request).arrays()
        return {"input_ids": arrays["input_ids"][0], "input_mask": arrays["input_mask"][0],
                **{k: v for k, v in arrays.items() if k not in ("input_ids", "input_mask")}}

    requests = m2_requests()
    datas = {name: data_of(r) for name, r in requests.items()}
    reqs = [(f"{name}_{i}", datas[name]) for i in range(2) for name in M2_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    stats, counts, log = engine_pass(eng, reqs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = stats["outputs"]
    readings = {rid: agree(eng, d, out[rid], truncate_at_eos(
        served[rid.rsplit("_", 1)[0]]["new_tokens"], eng.eos_id)) for rid, d in reqs}
    seq_ms = sum(served[name]["request_ms"] for name in M2_REQUESTS) * 2
    seq_tokens = 2 * sum(len(truncate_at_eos(served[n]["new_tokens"], eng.eos_id))
                         for n in M2_REQUESTS)
    emit(phase="engine", part="m2_pass", gpu=gpu, slots=M2_ENGINE_SLOTS, window=ENGINE_WINDOW,
         **stats_line(stats), peak_mem_gb=peak, sequential_tokens_per_s=seq_tokens * 1e3 / seq_ms,
         speedup_tokens_per_s=stats["tokens_per_s"] / (seq_tokens * 1e3 / seq_ms),
         launches=counts, windows=len(log.windows), host_ms=log.host_ms(), agreement=readings,
         tie_max=ENGINE_TIE_MAX)
    for (rid, data), got in zip(reqs, log.prefills):
        want = m2_launches(M2_LAYERS, "audio" in data)
        check(got == want, f"m2 engine admission of {rid}: launches {got}; expected {want}")
    check(all(w == NO_LAUNCHES for w in log.windows), f"m2 engine windows {log.windows[:2]}")
    check(all(agrees(r) for r in readings.values()), f"m2 engine tokens: {readings}")

    # rope and cache slot advance apart, by what the image run compresses
    eng.reset()
    eng.submit("gap", datas["image_conversation"])
    eng.step()
    rope0, slot0 = (int(x.reshape(-1)[0]) for x in eng._slot_start[0])
    st = eng._state
    gap = (int(st["rope"][0]), int(st["spos"][0]))
    check(slot0 - rope0 > 0 and gap == (rope0 + ENGINE_WINDOW, slot0 + ENGINE_WINDOW),
          f"m2 engine: rope {rope0}->{gap[0]}, slot {slot0}->{gap[1]}")
    eng.reset()

    # a two-turn text session against a full re-prefill
    zero_counts()
    first = {**data_of({"conversation": [{"role": "user", "content": [
        {"type": "text", "text": "tell me a short story about a cat and a window."}]}]}),
        "max_new": ENGINE_SHORT, "session": True}
    eng.submit("t1", first)
    while "t1" not in eng._done:
        eng.step()
    turn = np.random.default_rng(SEED + 34).integers(1000, 30000, ENGINE_TURN).astype(np.int64)
    eng.continue_session("t1", "t2", {"input_ids": turn, "max_new": ENGINE_SHORT})
    while "t2" not in eng._done:
        eng.step()
    scounts = read_counts()
    gen1, gen2 = eng._done["t1"], eng._done["t2"]
    n1 = int(first["input_mask"].sum())
    conv = np.zeros(SERVING_SEQ_LEN, np.int64)
    body = np.concatenate([first["input_ids"][:n1], gen1, turn])
    conv[:len(body)] = body
    full = {"input_ids": conv, "input_mask": (conv != 0).astype(np.int64)}
    full["input_mask"][:len(body)] = 1
    sreading = agree(eng, full, gen2, sequential_tokens(module, eng, full, ENGINE_SHORT))
    eng.close_session("t2")
    emit(phase="engine", part="m2_session", first_turn=gen1, second_turn=gen2,
         agreement=sreading, launches=scounts)
    check(agrees(sreading), f"m2 engine session against a full re-prefill: {sreading}")
    emit(phase="engine", part="m2_idle", gpu=gpu, **engine_idle(eng, reqs, gpu),
         seconds=time.perf_counter() - t_phase)
    totals = {k: counts[k] + scounts[k] for k in counts}
    return totals


def m2_int8_reading(card, cpu, request, faults: bool) -> dict:
    """Phase 19 (d)'s twins with the int8 cache on request ``request``."""
    arrays = card.build_sample(request).arrays()
    card.shell.module.kv_int8 = cpu.kv_int8 = True
    try:
        return int8_compare(m2_int8_steps(card.shell.module, card.shell.to_device(arrays)),
                            m2_int8_steps(cpu, {k: torch.as_tensor(v) for k, v in arrays.items()}),
                            faults)
    finally:
        card.shell.module.kv_int8 = cpu.kv_int8 = False


def engine_faults(eng):
    """Faults planted in the engine (each undone after its pass): the decode
    window's cache slot one ahead (a hole in each row's history, RoPE one
    ahead); every admission copied into slot 0."""
    real_decode, real_admit = eng.ad.decode, eng._admit

    def slot_one_ahead(token, rope, slot, cache):
        return real_decode(token, rope + 1, (slot + 1).clamp(max=eng.T - 1), cache)

    def admit_into_slot_0(s, *args):
        return real_admit(0, *args)

    return [("slot_one_ahead", lambda: setattr(eng.ad, "decode", slot_one_ahead),
             lambda: eng.ad.__dict__.pop("decode")),
            ("admit_into_slot_0", lambda: setattr(eng, "_admit", admit_into_slot_0),
             lambda: eng.__dict__.pop("_admit"))]


def calibrate_engine(seeds=3) -> None:
    """The engine's near-tie margin (Pink int4 at full depth: sound seeds'
    first differing positions, then two planted engine faults) and the int8
    cache's card-vs-CPU readings (Pink at 2 layers, M2-omni at M2_CUT; sound
    seeds, then the two misread scales)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = pink_predictor()
    module = pred.shell.module
    eng = ContinuousBatchingEngine(
        PinkAdapter(module, PINK_PROMPT_LEN, PINK_NEW_TOKENS, has_image=True),
        slots=ENGINE_SLOTS, max_new_tokens=PINK_NEW_TOKENS, eos_id=pred.eos_id,
        step_tokens=ENGINE_WINDOW)

    def margins(reqs, seq):
        stats, _, _ = engine_pass(eng, reqs)
        res = {rid: agree(eng, d, stats["outputs"][rid], seq[rid]) for rid, d in reqs}
        diverged = [r["margin"] for r in res.values() if not r["equal"]]
        return dict(requests=len(res), diverged=len(diverged),
                    margins=sorted(diverged), first_diffs=sorted(
                        r["first_diff"] for r in res.values() if not r["equal"]))

    for seed in range(seeds):
        reqs = [r for i, r in enumerate(engine_pink_requests(seed))
                if ENGINE_ROLES.get(i) in (None, "text_only")]
        seq = {rid: sequential_tokens(module, eng, d, d["max_new"]) for rid, d in reqs}
        emit(phase="calibrate_engine", kind="sound", seed=seed, **margins(reqs, seq),
             tie_max=ENGINE_TIE_MAX)
    for name, plant, undo in engine_faults(eng):
        plant()
        try:
            emit(phase="calibrate_engine", kind="fault", fault=name, seed=seeds - 1,
                 **margins(reqs, seq), tie_max=ENGINE_TIE_MAX)
        finally:
            undo()
    del pred, module, eng
    gc.collect()
    torch.cuda.empty_cache()
    for seed in range(seeds):
        res = pink_int8_reading(seed, faults=seed == seeds - 1)
        emit(phase="calibrate_engine", kind="pink_kv_int8", seed=seed, readings=res,
             within_bound={n: int8_within_bound(r) for n, r in res.items()})
    for seed in range(seeds):
        card, cpu, card32, tree = m2_twins(seed)
        del card32, tree
        res = m2_int8_reading(card, cpu, m2_requests(seed)["image_conversation"],
                              seed == seeds - 1)
        emit(phase="calibrate_engine", kind="m2_kv_int8", seed=seed, readings=res,
             within_bound={n: int8_within_bound(r) for n, r in res.items()})
        del card, cpu
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="calibrate_engine", kind="bound", tie_max=ENGINE_TIE_MAX,
         int8_cos_min=INT8_COS_MIN, int8_dlogit_max=INT8_DLOGIT_MAX)


# ------------------------------------------------------------------ phase 12
TRAINER_CONFIG = "projects/base_vtp/configs/video_retrieval.yml"
VOCAB = "tests/data/vocabs/bert-base-uncased_30522_vocab.txt"
TRAINER_CLIPS, TRAINER_CLIP_FRAMES, TRAINER_HW = 64, 12, (240, 320)
TRAINER_BATCH, TRAINER_STEPS, TRAINER_RESUMED_STEPS = 32, 8, 10
TRAINER_SNAPSHOT, TRAINER_LOG = 4, 2
TRAINER_LAUNCHES = {"small_attention": 24, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                    "int4_gemv": 0}  # a train step or an eval forward: 12 ViT + 12 BERT layers
FIRST_LOSS_ATOL = 1e-3  # trainer vs bare step when cuBLAS picks another algorithm
# a trainer whose checks do not hold its first loss to a bare step's draws
# its init on the card (seconds instead of tens at these sizes)
INIT_ON_DEVICE = ["training_parameters.init_on_device", "true"]


def write_msrvtt_layout(root: str, seed: int) -> int:
    """A seeded synthetic dataset in the MSR-VTT layout of ``TRAINER_CONFIG``:
    ``videos/data.mdb``, an LMDB (the port's ``LmdbLiteWriter``) of 64 clips
    of 12 uint8 frames at 240×320 (a seeded image per clip plus seeded
    per-frame noise), keyed by clip name; ``annotations/msrvtt_{train,test}
    .jsonl``, 64 captions of 10 seeded words from the BERT vocabulary, one
    per clip. Returns the LMDB's bytes."""
    rng = np.random.default_rng(seed)
    writer = LmdbLiteWriter(os.path.join(root, "videos") + os.sep)
    for i in range(TRAINER_CLIPS):
        base = rng.integers(0, 256, (1, *TRAINER_HW, 3), dtype=np.int16)
        noise = rng.integers(-24, 25, (TRAINER_CLIP_FRAMES, *TRAINER_HW, 3), dtype=np.int16)
        buf = io.BytesIO()
        np.save(buf, np.clip(base + noise, 0, 255).astype(np.uint8))
        writer.put(f"video{i}", buf.getvalue())
    path = writer.save()
    with open(VOCAB, encoding="utf-8") as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    lines = [json.dumps({"caption": " ".join(rng.choice(words, 10)), "clip_name": f"video{i}",
                         "sen_id": i}) for i in range(TRAINER_CLIPS)]
    os.makedirs(os.path.join(root, "annotations"))
    for split in ("train", "test"):
        with open(os.path.join(root, "annotations", f"msrvtt_{split}.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return os.path.getsize(path)


def trainer_argv(root: str, *extra: str) -> list:
    data = "task_attributes.univl_task.dataset_attributes.video_text_retrieval"
    tp = "training_parameters"
    return ["--config", TRAINER_CONFIG, f"{data}.data_root_dir", root,
            f"{data}.video_source", "lmdb", f"{tp}.batch_size", str(TRAINER_BATCH),
            f"{tp}.test_batch_size", str(TRAINER_BATCH), f"{tp}.log_interval", str(TRAINER_LOG),
            f"{tp}.snapshot_interval", str(TRAINER_SNAPSHOT), f"{tp}.use_warmup", "false",
            f"{tp}.max_ckpt_num", "1", f"{tp}.num_workers", "4",
            f"{tp}.save_dir", os.path.join(root, "save"), f"{tp}.seed", "1", *extra]


class TrainerProbe:
    """Wraps the steps that ``BaseTrainer.compile_steps`` builds and the
    checkpoint's save and restore, to read what the run did: launches per
    train step and eval forward, each step's loss (read after the run), the
    first step's masters and batch, the devices of the batches, each full
    validation's metrics, seconds and collected embeddings, each save's
    seconds and bytes, the restore's seconds; with ``reference`` set, whether
    the loaded state equals the reference trainer's bit for bit."""

    def __init__(self):
        self.train, self.eval, self.losses, self.devices = [], [], [], set()
        self.terms = []  # each train step's losses/* scalars (device tensors)
        self.first, self.reference, self.resumed_equal = None, None, None
        self.validations, self.saves, self.restores = [], [], []
        self.raw_train_step = None  # the last trainer's step, unwrapped (uncounted timing)
        # retrieval_trainer: launches per encode batch and per stage-2 chunk,
        # the encode outputs on the host (with each batch's image_vid)
        self.encode, self.rescore, self.encoded = [], [], []
        self.track, self.tracked = None, []  # one master's value after every step

    def install(self):
        probe = self
        real_compile, real_save, real_restore = (BaseTrainer.compile_steps, Checkpoint.save,
                                                 Checkpoint.restore_state)
        real_rcompile = RetrievalTrainer.compile_steps

        def counted(fn, calls):
            def wrapped(state, batch, *rest):
                before = read_counts()
                out = fn(state, batch, *rest)
                after = read_counts()
                calls.append({k: after[k] - before[k] for k in after})
                if isinstance(batch, dict):
                    probe.devices.add(next(t for t in batch.values()
                                           if torch.is_tensor(t)).device.type)
                return out
            return wrapped

        def rcompile(trainer):
            real_rcompile(trainer)
            encode = counted(trainer._encode_step, probe.encode)

            def encode_step(state, batch):
                out = encode(state, batch)
                probe.encoded.append(({k: v.float().cpu().numpy() for k, v in out.items()
                                       if k not in ("text_seq", "visual_tokens")},
                                      batch["image_vid"].cpu().numpy().reshape(-1)))
                return out

            trainer._encode_step = encode_step
            if trainer._rescore_step is not None:
                trainer._rescore_step = counted(trainer._rescore_step, probe.rescore)

        def compile_steps(trainer):
            real_compile(trainer)
            probe.raw_train_step = trainer._train_step
            train, evaluate = counted(trainer._train_step, probe.train), \
                counted(trainer._eval_step, probe.eval)

            def train_step(state, batch):
                if probe.first is None:
                    probe.first = ({n: t.clone() for n, t in state.params.items()}, dict(batch))
                state, scalars = train(state, batch)
                if probe.track is not None:
                    probe.tracked.append(state.params[probe.track].clone())
                probe.losses.append(scalars["total_loss"])
                probe.terms.append({k: v for k, v in scalars.items() if k.startswith("losses/")})
                return state, scalars

            trainer._train_step, trainer._eval_step = train_step, evaluate
            real_evaluate = trainer.evaluate_set

            def evaluate_set(dataset_type="val"):
                t0 = time.perf_counter()
                metrics = real_evaluate(dataset_type)
                ev = trainer.evaluator
                probe.validations.append(dict(
                    dataset_type=dataset_type, seconds=time.perf_counter() - t0, metrics=metrics,
                    embeds=None if not getattr(ev, "_text", None) else
                    [np.concatenate(x) for x in (ev._text, ev._video, ev._vids)]))
                return metrics

            trainer.evaluate_set = evaluate_set
            if probe.reference is not None:
                probe.resumed_equal = states_equal(trainer.state, probe.reference.state)

        def save(ck, state, iteration=None, tag=None):
            t0 = time.perf_counter()
            path = real_save(ck, state, iteration, tag)
            probe.saves.append((time.perf_counter() - t0, os.path.getsize(path)))
            return path

        def restore_state(ck, state, path=None):
            t0 = time.perf_counter()
            out = real_restore(ck, state, path)
            torch.cuda.synchronize()
            probe.restores.append(time.perf_counter() - t0)
            return out

        def uninstall():
            BaseTrainer.compile_steps, Checkpoint.save, Checkpoint.restore_state = \
                real_compile, real_save, real_restore
            RetrievalTrainer.compile_steps = real_rcompile

        BaseTrainer.compile_steps, Checkpoint.save, Checkpoint.restore_state = \
            compile_steps, save, restore_state
        RetrievalTrainer.compile_steps = rcompile
        return uninstall


def states_equal(a, b) -> dict:
    """Step, masters, AdamW moments and generator of two TrainStates, bit for
    bit; under gradient accumulation also the accumulator and its count; with
    MoCo also the momentum towers, the key module and the queues."""
    same = lambda x, y: all(torch.equal(x[n], y[n]) for n in y)  # noqa: E731
    out = dict(step=a.step == b.step, masters=same(a.params, b.params),
               mu=same(a.opt_state["mu"], b.opt_state["mu"]),
               nu=same(a.opt_state["nu"], b.opt_state["nu"]),
               count=a.opt_state["count"] == b.opt_state["count"],
               generator=torch.equal(a.generator.get_state(), b.generator.get_state()))
    if "acc" in b.opt_state:  # gradient accumulation: the running mean and its count
        out.update(acc=same(a.opt_state["acc"], b.opt_state["acc"]),
                   mini_step=a.opt_state["mini_step"] == b.opt_state["mini_step"])
    if b.momentum is not None:
        out.update(momentum=a.momentum is not None and same(a.momentum, b.momentum),
                   key_module=same(dict(a.key_module.named_parameters()),
                                   dict(b.key_module.named_parameters())),
                   queues=same(queue_buffers(a.model), queue_buffers(b.model)))
    return out


def host_recalls(text: np.ndarray, video: np.ndarray, vids: np.ndarray) -> dict:
    """R@1, R@5 and the mean recall recomputed from the collected embeddings:
    videos deduplicated by id; a caption's rank counts the videos scored
    above its own; a video's rank counts the captions scored above its best
    caption."""
    _, first = np.unique(vids, return_index=True)
    out = sim_recalls(text.astype(np.float64) @ video[first].astype(np.float64).T, vids)
    out["mean_recall"] = float(np.mean(list(out.values())))
    return out


def sim_recalls(sim: np.ndarray, vids: np.ndarray, ties: str = "above") -> dict:
    """R@1/5/10 both ways of a [caption, unique video] score grid, videos in
    ``np.unique(vids)`` order: a caption's rank counts the videos scored
    above its own, a video's the captions scored above its best caption;
    ``ties="at"`` also counts the others scored equal (the worst rank that
    any order of ties gives)."""
    uniq = np.unique(vids)
    col = np.searchsorted(uniq, vids)
    beats = (lambda a, b: a > b) if ties == "above" else (lambda a, b: a >= b)
    own = sim[np.arange(len(vids)), col][:, None]
    t2v = beats(sim, own).sum(1) - (ties == "at")
    best = np.array([sim[vids == u, c].max() for c, u in enumerate(uniq)])
    v2t = beats(sim.T, best[:, None]).sum(1) - (ties == "at")
    return {f"{d}-r@{k}": float((r < k).mean() * 100) for d, r in (("t2v", t2v), ("v2t", v2t))
            for k in (1, 5, 10)}


def loader_breakdown(trainer) -> dict:
    """A train batch's host work on one thread, by stage, in ms: the LMDB
    read and frame sampling, the resize, crop and normalisation of its
    frames, the tokenisation, the collation, and the pinned copy to the card
    (``to_device``, synchronised)."""
    ds = trainer.task_loader.get_loaders("train")[0].dataset
    ms = dict.fromkeys(("read_and_sample", "image_processing", "tokenize", "collate",
                        "to_device"), 0.0)
    samples = []
    for i in range(TRAINER_BATCH):
        ann = ds.annotations[i]
        t0 = time.perf_counter()
        frames = ds._load_frames(ann)
        t1 = time.perf_counter()
        for f in frames:
            ds.image_processor.transform_array(f)
        t2 = time.perf_counter()
        ds.caption_processor({"text": ann["caption"]}, probability=0.0)
        t3 = time.perf_counter()
        ms["read_and_sample"] += (t1 - t0) * 1e3
        ms["image_processing"] += (t2 - t1) * 1e3
        ms["tokenize"] += (t3 - t2) * 1e3
        samples.append(ds[i])
    t0 = time.perf_counter()
    batch = ds.collate_fn(samples)
    t1 = time.perf_counter()
    trainer._to_device(batch)
    torch.cuda.synchronize()
    ms.update(collate=(t1 - t0) * 1e3, to_device=(time.perf_counter() - t1) * 1e3)
    ms["per_frame_image_processing"] = ms["image_processing"] / (TRAINER_BATCH * FRAMES)
    return ms


def loader_steady_state(trainer, batches: int = 8) -> dict:
    """The train loader's rate without an epoch restart: its dataset, batch
    size, threads and prefetch depth over ``batches`` batches of the clips
    in order, repeated; ms a batch from the first batch's arrival to the
    last's (host work only, nothing on the card)."""
    train = trainer.task_loader.get_loaders("train")[0]
    ds = train.dataset
    order = [i % len(ds) for i in range(batches * train.batch_size)]
    loader = DataLoader(ds, train.batch_size, sampler=order, collate_fn=train.collate_fn,
                        num_workers=train.num_workers, drop_last=True,
                        prefetch_batches=train.prefetch_batches)
    arrivals = []
    t0 = time.perf_counter()
    for _ in loader:
        arrivals.append(time.perf_counter())
    per_batch = (arrivals[-1] - arrivals[0]) * 1e3 / (len(arrivals) - 1)
    return dict(batches=len(arrivals), threads=train.num_workers,
                first_batch_ms=(arrivals[0] - t0) * 1e3, ms_per_batch=per_batch,
                clips_per_s=train.batch_size * 1e3 / per_batch)


def phase_trainer(gpu: str, bare_p50_ms: float) -> int:
    """``python -m antmmf_torch.run`` on ``TRAINER_CONFIG`` at full width
    (ViT-B/32 on 8 frames at 224², BERT-base at L=30, embed 512, bf16, AdamW
    with the ``img_encoder`` ×0.1 rule, clip 1.0) over a seeded synthetic
    MSR-VTT-layout dataset that it writes into a temporary directory under
    ``build/`` and deletes at the end. The clips are read from an LMDB: the
    card's machine has neither OpenCV nor PIL, and the ``lmdb`` source and
    the numpy resize need neither. 8 steps at B=32 (4 epochs of 2),
    validation every 4 steps, ``max_ckpt_num`` 1; then a second run with
    ``resume true`` to step 10. Returns the phase's small_attention launches."""
    from torch.profiler import ProfilerActivity, profile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="trainer_smoke_", dir=build)
    probe = TrainerProbe()
    uninstall = probe.install()
    try:
        lmdb_bytes = write_msrvtt_layout(root, SEED)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        first = run.main(trainer_argv(root, "training_parameters.max_iterations",
                                      str(TRAINER_STEPS)))
        setup_s = first.timings["first_step_start"] - t0
        models = sorted(os.listdir(os.path.join(root, "save", "models")))
        on_disk = sorted(os.listdir(os.path.join(root, "save")))
        saves_first = list(probe.saves)
        losses = [float(x) for x in probe.losses]
        val = next(v for v in probe.validations if v["dataset_type"] == "val")
        final_val = [v for v in probe.validations if v["dataset_type"] == "val"][-1]
        first_n = len(probe.train)

        t0 = time.perf_counter()
        probe.reference = first
        second = run.main(trainer_argv(root, "training_parameters.max_iterations",
                                       str(TRAINER_RESUMED_STEPS), "training_parameters.resume",
                                       "true"))
        resume_s = time.perf_counter() - t0
        # the main path ends here: its launches, train steps and eval forwards
        counts = read_counts()
        n_train, n_eval = len(probe.train), len(probe.eval)
        resumed_losses = [float(x) for x in probe.losses[first_n:]]
        resumed_end = second.state.step
        # the device's idle share over 2 trainer steps (not counted): untraced
        # wall, then traced busy time
        batch = second._to_device(second._cached_first_batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            second.state, _ = probe.raw_train_step(second.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / 2
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                second.state, _ = probe.raw_train_step(second.state, batch)
            torch.cuda.synchronize()
        busy, n_ops, top = device_busy(prof, 2)
        breakdown = loader_breakdown(second)
        steady = loader_steady_state(second)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        on_cuda = next(second.shell.module.parameters()).device.type == "cuda"

        # the bare step of phase 5 on the trainer's first batch and masters
        masters, first_batch = probe.first
        shell, state, step = trainer({}, masters=masters)
        _, bare = step(state, first_batch)
        bare_loss, trainer_loss = float(bare["total_loss"]), losses[0]
        probe.first = None
        del shell, state, step, masters, first_batch
    finally:
        uninstall()
        shutil.rmtree(root, ignore_errors=True)

    step_ms = [t * 1e3 for t in first.timings["step_s"]]
    wait_ms = [t * 1e3 for t in first.timings["loader_wait_s"]]
    epochs = [float(np.mean(losses[i:i + 2])) for i in range(0, TRAINER_STEPS, 2)]
    recomputed = host_recalls(*final_val["embeds"])
    reported = {k: final_val["metrics"][k] for k in recomputed}
    first_save = saves_first[0]
    emit(phase="trainer", config=TRAINER_CONFIG, batch=TRAINER_BATCH, gpu=gpu,
         lmdb_bytes=lmdb_bytes, setup_s=setup_s, losses=losses, epoch_mean_losses=epochs,
         resumed_losses=resumed_losses,
         first_step_loss=dict(trainer=trainer_loss, bare=bare_loss,
                              equal="bit for bit" if trainer_loss == bare_loss else
                              f"within {abs(trainer_loss - bare_loss):.3g}"),
         step_ms=step_ms, step_p50_ms=float(np.percentile(step_ms, 50)),
         step_p95_ms=float(np.percentile(step_ms, 95)),
         loader_wait_ms=wait_ms, loader_wait_p50_ms=float(np.percentile(wait_ms, 50)),
         loader_one_thread_ms=breakdown, loader_steady=steady,
         clip_pairs_per_s=TRAINER_BATCH * (len(step_ms) - 1) * 1e3 / float(np.sum(step_ms[1:])),
         train_loop_s=first.timings["loop_s"],
         clip_pairs_per_s_loop_wall=TRAINER_BATCH * len(step_ms) / first.timings["loop_s"],
         bare_step_p50_ms=bare_p50_ms, bare_clip_pairs_per_s=TRAINER_BATCH * 1e3 / bare_p50_ms,
         device_busy_ms=busy if n_ops else "not measured", step_wall_ms=wall_ms,
         device_idle_share=1 - busy / wall_ms if n_ops else "not measured",
         top_device_ops_ms=top,
         full_val_s=val["seconds"], full_val_clips_per_s=TRAINER_CLIPS / val["seconds"],
         val_metrics={k: final_val["metrics"][k] for k in ("t2v-r@1", "t2v-r@5", "v2t-r@1",
                                                          "mean_recall", "total_loss")},
         recalls_recomputed=recomputed, checkpoint_save_s=first_save[0],
         checkpoint_bytes=first_save[1], saves=saves_first, resume_s=resume_s,
         restore_s=probe.restores, resumed_state_equal=probe.resumed_equal,
         resumed_end_step=resumed_end,
         models_dir=models, save_dir=on_disk, peak_mem_gb=peak_gb,
         launches=counts, launches_per_call=probe.train[0],
         train_steps=n_train, eval_forwards=n_eval)

    check(n_train == TRAINER_RESUMED_STEPS and len(probe.train) == n_train,
          f"trainer: {n_train} train steps on the main path, {len(probe.train)} through it")
    check(all(c == TRAINER_LAUNCHES for c in probe.train + probe.eval),
          f"trainer: launches per step or eval forward {probe.train[:1] + probe.eval[:1]}; "
          f"expected {TRAINER_LAUNCHES}")
    check(counts["small_attention"] == 24 * (n_train + n_eval)
          and not any(counts[k] for k in counts if k != "small_attention"),
          f"trainer: the phase launched {counts}")
    check(all(np.isfinite(losses + resumed_losses)), "trainer: a loss is not finite")
    check(epochs[-1] < epochs[0], f"trainer: the epoch mean loss did not fall ({epochs})")
    check(abs(trainer_loss - bare_loss) <= FIRST_LOSS_ATOL,
          f"trainer: first-step loss {trainer_loss} against the bare step's {bare_loss}")
    check(all(0 <= final_val["metrics"][k] <= 100 for k in ("t2v-r@1", "t2v-r@5", "v2t-r@1",
                                                           "mean_recall")),
          "trainer: a recall lies outside [0, 100]")
    check(all(abs(reported[k] - recomputed[k]) <= 1e-9 for k in recomputed),
          f"trainer: recalls {reported} against the host's {recomputed}")
    check(models == ["best", f"model_{TRAINER_STEPS}"],
          f"trainer: models/ holds {models}")
    check({"config.yaml", "univl_retrieval_final", "models"} <= set(on_disk),
          f"trainer: save_dir holds {on_disk}")
    check(probe.resumed_equal is not None and all(probe.resumed_equal.values())
          and len(resumed_losses) == TRAINER_RESUMED_STEPS - TRAINER_STEPS
          and resumed_end == TRAINER_RESUMED_STEPS,
          f"trainer: resume {probe.resumed_equal}, steps {len(resumed_losses)}")
    check(probe.devices == {"cuda"} and on_cuda, f"trainer: ran on {probe.devices}")
    return counts["small_attention"]


# ----------------------------------------------------------------- phase 13
PRETRAIN_CONFIG = "projects/base_vtp/configs/univl_pretrain.yml"
SNPS3_CONFIG = "projects/snps3_vtp/configs/snps3_pretrain.yml"
PRETRAIN_BATCH = 128  # the config's batch: the bare step's
PRETRAIN_TRAINER_BATCH, PRETRAIN_TRAINER_STEPS, PRETRAIN_RESUMED_STEPS = 32, 6, 8
SNPS3_STEPS = 3
PRETRAIN_TERMS = ("vtc_loss", "itm_loss", "masked_lm_loss")
WORD_EMBEDDINGS = "base.text_encoder.embeddings.word_embeddings.weight"
# a pretraining train step: 12 ViT + 12 BERT layers on K1 (its backward is
# plain tensor ops); the cross-encoder's 2 layers run twice (the VTM pairs,
# then the MLM pass over the matched pairs), forward and backward each time.
# An eval forward runs the same forwards and no backward
PRETRAIN_STEP_LAUNCHES = {"small_attention": 24, "flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4,
                          "int4_gemv": 0}
PRETRAIN_EVAL_LAUNCHES = {"small_attention": 24, "flash_fwd": 4, "flash_dq": 0, "flash_dkv": 0,
                          "int4_gemv": 0}
# card bf16 vs CPU fp32, the first pretraining step at B=4 on the same fp32
# masters and the same masked batch (``--calibrate pretraining`` reads the
# gap): each loss term's |Δ|, the cosine of all gradients together, the
# least per-parameter cosine and the word embedding's cosine. Sound runs over
# three seeds stay below |Δ| 0.00071 (vtc), 0.0021 (itm), 0.0047 (mlm) and
# above cos 0.99983 (all), 0.9606 (least), 0.99989 (word embedding); the
# untied decoder reads a word-embedding cos of 0.321, mislabelled VTM pairs
# |Δitm| 0.067 and cos 0.928, the cross key bias dropped |Δmlm| 0.034, cos
# 0.99328 and a word-embedding cos of 0.9963 (H100 readings)
PRETRAIN_DLOSS_MAX = {"vtc_loss": 0.005, "itm_loss": 0.01, "masked_lm_loss": 0.015}
PRETRAIN_COS_ALL, PRETRAIN_COS_MIN, PRETRAIN_WORD_COS = 0.999, 0.9, 0.999


def pretrain_batch(B: int, seed: int) -> dict:
    """``train_batch`` with its captions masked for MLM as the host
    processor masks them: about 15 % of the real tokens after [CLS] become
    [MASK] (id 103), their ids the labels, every other label -1."""
    batch = train_batch(B, seed)
    rng = np.random.default_rng(seed + 100)
    ids, mask = batch["caption_input_ids"], batch["caption_input_mask"]
    pick = (rng.random(ids.shape) < 0.15) & (mask > 0)
    pick[:, 0] = False
    batch.update(caption_raw_input_ids=ids.copy(), caption_input_ids=np.where(pick, 103, ids),
                 caption_lm_label_ids=np.where(pick, ids, -1))
    return batch


def pretrain_model(device: str = "cuda", dtype: str = "bfloat16", seed: int = SEED,
                   masters=None, config: str = PRETRAIN_CONFIG):
    """(shell, state, train_step) of ``config``'s model and optimizer through
    the port's entry points; seeded random weights unless fp32 ``masters``
    are given."""
    cfg = build_config(config, opts=["model_attributes.univl_pretrain.dtype_str", dtype])
    shell = build_model(cfg, device=device)
    if masters is None:
        shell.init(seed)
    tx, _ = build_optimizer(flax_paths(shell.module), cfg["optimizer_attributes"].to_dict(),
                            cfg["training_parameters"].to_dict())
    return shell, TrainState.create(shell.module, tx, masters), make_train_step(shell, tx)


def pretrain_first_step(shell, batch):
    """The first pretraining step's loss terms and fp32 gradients by name."""
    for p in shell.module.parameters():
        p.grad = None
    loss, (_, scalars) = shell.loss_fn(batch, deterministic=False)
    loss.backward()
    terms = {k.split("/", 1)[1]: float(v) for k, v in scalars.items() if k.startswith("losses/")}
    return terms, {n: p.grad.float().cpu() for n, p in shell.module.named_parameters()
                   if p.grad is not None}


def compare_pretrain(card, cpu) -> dict:
    """``compare_steps`` on the total, each loss term's |Δ| and the word
    embedding's gradient cosine."""
    (t_card, g_card), (t_cpu, g_cpu) = card, cpu
    res = compare_steps((sum(t_card.values()), g_card), (sum(t_cpu.values()), g_cpu))
    res["abs_dloss_terms"] = {k: abs(t_card[k] - t_cpu[k]) for k in t_cpu}
    res["loss_terms_cpu"] = t_cpu
    res["word_embeddings_cos"] = torch.nn.functional.cosine_similarity(
        g_card[WORD_EMBEDDINGS].double().reshape(-1), g_cpu[WORD_EMBEDDINGS].double().reshape(-1),
        dim=0).item() if WORD_EMBEDDINGS in g_card else 0.0
    return res


def pretrain_within_bound(res) -> bool:
    return res["grad_cos_all"] >= PRETRAIN_COS_ALL and res["grad_cos_min"] >= PRETRAIN_COS_MIN \
        and res["word_embeddings_cos"] >= PRETRAIN_WORD_COS \
        and all(res["abs_dloss_terms"][k] <= PRETRAIN_DLOSS_MAX[k] for k in PRETRAIN_TERMS)


def pretrain_twins(seed: int):
    """The pretraining model on the CPU in fp32 (plain versions) and on the
    card in bf16 on the same fp32 masters, and a masked B=4 batch."""
    cpu, cpu_state, _ = pretrain_model("cpu", "float32", seed)
    card, _, _ = pretrain_model(masters=cpu_state.params)
    return card, cpu, pretrain_batch(4, SEED + 2)


def pretrain_faults(card):
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo)."""
    from antmmf_torch.models import univl

    module, real_mask = card.module, univl.make_attention_mask

    def untie():  # the MLM decoder on a detached copy of the table
        table = module.base.text_encoder.embeddings.word_embeddings.weight
        module.word_embedding_table = lambda: table.detach().clone()

    def mislabel():  # VTM labels that do not match the roll
        real = type(module).vtm_pairs
        module.vtm_pairs = lambda vis: (lambda labels, seq: (1 - labels, seq))(*real(vis))

    def undo(name):
        return lambda: module.__dict__.pop(name)

    return [("mlm_decoder_untied", untie, undo("word_embedding_table")),
            ("vtm_labels_not_matching_the_roll", mislabel, undo("vtm_pairs")),
            ("cross_key_bias_dropped", lambda: setattr(univl, "make_attention_mask",
                                                       lambda mask: None),
             lambda: setattr(univl, "make_attention_mask", real_mask))]


def calibrate_pretraining(seeds=3) -> None:
    """Phase 13 (a)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        card, cpu, batch = pretrain_twins(seed)
        ref = pretrain_first_step(cpu, batch)
        res = compare_pretrain(pretrain_first_step(card, batch), ref)
        emit(phase="calibrate_pretraining", kind="sound", seed=seed, **res,
             within_bound=pretrain_within_bound(res))
    for name, plant, undo in pretrain_faults(card):
        plant()
        try:
            res = compare_pretrain(pretrain_first_step(card, batch), ref)
        finally:
            undo()
        emit(phase="calibrate_pretraining", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=pretrain_within_bound(res))
    emit(phase="calibrate_pretraining", kind="bound", dloss_max=PRETRAIN_DLOSS_MAX,
         grad_cos_all=PRETRAIN_COS_ALL, grad_cos_min=PRETRAIN_COS_MIN,
         word_embeddings_cos=PRETRAIN_WORD_COS)


def pretrain_bare(gpu: str) -> dict:
    """Phase 13 (b): the bare pretraining step at the config's B=128 and
    width, one repeated masked batch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shell, state, step = pretrain_model()
    batch = shell.to_device(pretrain_batch(PRETRAIN_BATCH, SEED + 1))
    setup_s = time.perf_counter() - t0
    totals = dict.fromkeys(PRETRAIN_STEP_LAUNCHES, 0)
    terms, times, counts = [], [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        terms.append({k: float(v) for k, v in scalars.items()
                      if k.startswith("losses/") or k == "total_loss"})
        for name, n in counts[-1].items():
            totals[name] += n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[TRAIN_WARMUP:]
    p50 = float(np.percentile(timed, 50))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    busy, n_ops, top = device_busy(prof, 2)
    by_name, _ = device_ms_by_name(prof, 2)
    kernel_ms = {k: sum(ms for name, ms in by_name.items() if f"{k}_" in name)
                 for k in ("small_attention", "flash_fwd", "flash_dq", "flash_dkv")}
    losses = [t["total_loss"] for t in terms]
    emit(phase="pretraining", part="bare_step", config=PRETRAIN_CONFIG, batch=PRETRAIN_BATCH,
         gpu=gpu, setup_s=setup_s, loss_terms=terms, step_ms=times, step_p50_ms=p50,
         step_p95_ms=float(np.percentile(timed, 95)),
         clip_pairs_per_s=PRETRAIN_BATCH * 1e3 / p50, launches_per_step=counts[-1],
         peak_mem_gb=peak_gb, device_busy_ms=busy if n_ops else "not measured",
         device_idle_share=1 - busy / p50 if n_ops else "not measured",
         device_ops_per_step=n_ops, top_device_ops_ms=top, kernel_device_ms=kernel_ms,
         flash_share_of_busy=sum(v for k, v in kernel_ms.items() if k.startswith("flash"))
         / busy if n_ops else "not measured")
    check(all(np.isfinite(list(t.values())).all() for t in terms),
          "pretraining bare step: a loss is not finite")
    check(all(f"losses/{k}" in terms[0] for k in PRETRAIN_TERMS),
          f"pretraining bare step: loss terms {sorted(terms[0])}")
    check(losses[-1] < losses[0], f"pretraining bare step: the loss did not fall ({losses})")
    check(all(c == PRETRAIN_STEP_LAUNCHES for c in counts),
          f"pretraining bare step: launches per step {counts[-1]}; "
          f"expected {PRETRAIN_STEP_LAUNCHES}")
    del shell, state, step, batch
    torch.cuda.empty_cache()
    return dict(totals=totals, p50=p50)


def pretrain_argv(root: str, config: str, *extra: str) -> list:
    data = "task_attributes.univl_task.dataset_attributes.video_text_pretrain"
    tp = "training_parameters"
    return ["--config", config, f"{data}.data_root_dir", root, f"{data}.video_source", "lmdb",
            f"{data}.annotations.train", "annotations/msrvtt_train.jsonl",
            f"{data}.annotations.val", "annotations/msrvtt_test.jsonl", f"{data}.text.seed", "0",
            f"{tp}.batch_size", str(PRETRAIN_TRAINER_BATCH),
            f"{tp}.test_batch_size", str(PRETRAIN_TRAINER_BATCH), f"{tp}.log_interval", "2",
            f"{tp}.snapshot_interval", "1000", f"{tp}.max_ckpt_num", "1",
            f"{tp}.num_workers", "4", f"{tp}.run_type", "train",
            f"{tp}.save_dir", os.path.join(root, "save"), f"{tp}.seed", "1", *extra]


def pretrain_trainer(gpu: str, bare_p50_ms: float) -> dict:
    """Phase 13 (c): ``python -m antmmf_torch.run`` on ``univl_pretrain.yml``
    at full width over phase 12's seeded MSR-VTT-layout dataset (written
    again under ``build/`` and deleted at the end), with MLM masking on: 6
    steps at B=32 and the final full validation, a resumed run to step 8,
    then 3 steps of ``snps3_pretrain.yml`` (dual MLM, FOM, significant
    masking). Returns the phase's launches by kernel."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="pretrain_smoke_", dir=build)
    probe = TrainerProbe()
    uninstall = probe.install()
    try:
        write_msrvtt_layout(root, SEED)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        first = run.main(pretrain_argv(root, PRETRAIN_CONFIG, "training_parameters.max_iterations",
                                       str(PRETRAIN_TRAINER_STEPS)))
        timings, setup_s = first.timings, first.timings["first_step_start"] - t0
        models = sorted(os.listdir(os.path.join(root, "save", "models")))
        first_n = len(probe.train)
        val = [v for v in probe.validations if v["dataset_type"] == "val"][-1]
        probe.reference = first
        t0 = time.perf_counter()
        second = run.main(pretrain_argv(root, PRETRAIN_CONFIG, "training_parameters.max_iterations",
                                        str(PRETRAIN_RESUMED_STEPS), "training_parameters.resume",
                                        "true"))
        resume_s, resumed_end = time.perf_counter() - t0, second.state.step
        probe.reference = None
        del first, second
        torch.cuda.empty_cache()
        univl_steps = len(probe.train)
        snps3 = run.main(pretrain_argv(root, SNPS3_CONFIG, "training_parameters.max_iterations",
                                       str(SNPS3_STEPS), "training_parameters.save_dir",
                                       os.path.join(root, "snps3")))
        snps3_step_ms = [t * 1e3 for t in snps3.timings["step_s"]]
        del snps3
        # the main path ends here: its launches, train steps and eval forwards
        counts = read_counts()
        n_train, n_eval = len(probe.train), len(probe.eval)
        losses = [float(x) for x in probe.losses]
        terms = [{k.split("/", 1)[1]: float(v) for k, v in t.items()} for t in probe.terms]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the bare step on the trainer's first batch and masters
        masters, first_batch = probe.first
        shell, state, step = pretrain_model(masters=masters)
        _, bare = step(state, first_batch)
        bare_loss = float(bare["total_loss"])
        probe.first = None
        del shell, state, step, masters, first_batch, bare
        torch.cuda.empty_cache()
    finally:
        uninstall()
        shutil.rmtree(root, ignore_errors=True)

    step_ms = [t * 1e3 for t in timings["step_s"]]
    wait_ms = [t * 1e3 for t in timings["loader_wait_s"]]
    B = PRETRAIN_TRAINER_BATCH
    snps3_terms = terms[univl_steps:]
    emit(phase="pretraining", part="trainer", config=PRETRAIN_CONFIG, batch=B, gpu=gpu,
         setup_s=setup_s, losses=losses[:first_n], resumed_losses=losses[first_n:univl_steps],
         loss_terms_first_step=terms[0],
         first_step_loss=dict(trainer=losses[0], bare=bare_loss,
                              equal="bit for bit" if losses[0] == bare_loss else
                              f"within {abs(losses[0] - bare_loss):.3g}"),
         step_ms=step_ms, step_p50_ms=float(np.percentile(step_ms, 50)),
         step_p95_ms=float(np.percentile(step_ms, 95)),
         loader_wait_ms=wait_ms, loader_wait_p50_ms=float(np.percentile(wait_ms, 50)),
         clip_pairs_per_s=B * (len(step_ms) - 1) * 1e3 / float(np.sum(step_ms[1:])),
         train_loop_s=timings["loop_s"],
         clip_pairs_per_s_loop_wall=B * len(step_ms) / timings["loop_s"],
         bare_step_p50_ms_b128=bare_p50_ms,
         full_val_s=val["seconds"], val_metrics=val["metrics"], resume_s=resume_s,
         resumed_state_equal=probe.resumed_equal, resumed_end_step=resumed_end,
         models_dir=models, peak_mem_gb=peak_gb, launches=counts,
         launches_per_call=probe.train[0], launches_per_eval=probe.eval[0],
         train_steps=n_train, eval_forwards=n_eval)
    emit(phase="pretraining", part="snps3", config=SNPS3_CONFIG, batch=B, gpu=gpu,
         loss_terms=snps3_terms, step_ms=snps3_step_ms)

    check(n_train == PRETRAIN_RESUMED_STEPS + SNPS3_STEPS,
          f"pretraining trainer: {n_train} train steps")
    check(all(c == PRETRAIN_STEP_LAUNCHES for c in probe.train)
          and all(c == PRETRAIN_EVAL_LAUNCHES for c in probe.eval),
          f"pretraining trainer: launches per step {probe.train[:1]}, per eval forward "
          f"{probe.eval[:1]}; expected {PRETRAIN_STEP_LAUNCHES}, {PRETRAIN_EVAL_LAUNCHES}")
    check(all(counts[k] == PRETRAIN_STEP_LAUNCHES[k] * n_train + PRETRAIN_EVAL_LAUNCHES[k] * n_eval
              for k in counts), f"pretraining trainer: the phase launched {counts}")
    check(all(np.isfinite(list(t.values())).all() for t in terms),
          "pretraining trainer: a loss term is not finite")
    check(all(f"{k}" in terms[0] for k in PRETRAIN_TERMS),
          f"pretraining trainer: loss terms {sorted(terms[0])}")
    check(all({*PRETRAIN_TERMS, "text_masked_lm_loss", "fom_loss"} <= set(t) for t in snps3_terms)
          and len(snps3_terms) == SNPS3_STEPS,
          f"snps3: loss terms {[sorted(t) for t in snps3_terms]}")
    check(abs(losses[0] - bare_loss) <= FIRST_LOSS_ATOL,
          f"pretraining trainer: first-step loss {losses[0]} against the bare step's {bare_loss}")
    check(terms[0]["masked_lm_loss"] > 0 and val["metrics"]["losses/masked_lm_loss"] == 0.0,
          "pretraining trainer: MLM targets in training and none in validation expected")
    check(models == ["best", f"model_{PRETRAIN_TRAINER_STEPS}"],
          f"pretraining trainer: models/ holds {models}")
    check(probe.resumed_equal is not None and all(probe.resumed_equal.values())
          and resumed_end == PRETRAIN_RESUMED_STEPS,
          f"pretraining trainer: resume {probe.resumed_equal}, end step {resumed_end}")
    check(probe.devices == {"cuda"}, f"pretraining trainer: ran on {probe.devices}")
    return counts


def phase_pretraining(gpu: str) -> dict:
    """Phase 13: (a) card vs CPU, (b) the bare step at B=128, (c) the
    trainer. Returns the launches of (b) and (c) by kernel."""
    card, cpu, batch = pretrain_twins(SEED)
    res = compare_pretrain(pretrain_first_step(card, batch), pretrain_first_step(cpu, batch))
    ok = pretrain_within_bound(res)
    emit(phase="pretraining", part="card_vs_cpu", batch=4, **res, dloss_max=PRETRAIN_DLOSS_MAX,
         grad_cos_all_bound=PRETRAIN_COS_ALL, grad_cos_min_bound=PRETRAIN_COS_MIN,
         word_embeddings_cos_bound=PRETRAIN_WORD_COS, ok=ok)
    check(ok, "card and CPU pretraining steps disagree beyond the stated bound")
    del card, cpu, batch
    torch.cuda.empty_cache()
    bare = pretrain_bare(gpu)
    counts = pretrain_trainer(gpu, bare["p50"])
    return {k: bare["totals"][k] + counts[k] for k in counts}

# ----------------------------------------------------------------- phase 14
DMAE_CONFIG = "projects/dmae_vtp/configs/msrvtt_retrieval.yml"
DMAE_FRAMES, DMAE_TEXT_LEN, DMAE_BATCH = 12, 32, 128  # the config's frames, length, batch
DMAE_TERMS = ("level1_similarity_loss", "level3_similarity_loss")
# a DMAE step or forward: 12 ViT + 12 BERT layers and the 4 temporal layers
# on K1 (its backward is plain tensor ops)
DMAE_LAUNCHES = {"small_attention": 28, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                 "int4_gemv": 0}
# a MoCo step: the online towers and the key towers (no gradient), 24 each
MOCO_OPTS = ["model_attributes.univl_retrieval.with_queue", "true",
             "model_attributes.univl_retrieval.with_momentum", "true",
             "model_attributes.univl_retrieval.momentum", "0.99"]
MOCO_MU, MOCO_QUEUE = 0.99, 4096
MOCO_LAUNCHES = {**TRAINER_LAUNCHES, "small_attention": 48}
MOCO_TRACKED = "base.img_fc.weight"  # the momentum tensor held against a host EMA
RV_BATCH, RV_STEPS, RV_RESUMED_STEPS = 32, 6, 8
# the DMAE and MoCo bare steps and trainers (phase 14 (b)–(d)): full width
# at 2 of the 12 ViT and BERT layers, initialised on the card (the
# card-vs-CPU check and stage 2 keep all 12)
RV_LAYERS = 2
RV_DMAE_LAUNCHES = {**DMAE_LAUNCHES, "small_attention": 2 * RV_LAYERS + 4}  # + 4 temporal
RV_MOCO_LAUNCHES = {**MOCO_LAUNCHES, "small_attention": 4 * RV_LAYERS}  # query and key towers
RV_EVAL_LAUNCHES = {**TRAINER_LAUNCHES, "small_attention": 2 * RV_LAYERS}


def cut_towers(model: str, layers: int = RV_LAYERS) -> list:
    """Opts that cut ``model``'s ViT-B/32 and BERT-base to ``layers`` layers
    (registered as presets) and draw its init on the card."""
    from antmmf_torch.modules.encoders.text_encoder import PRESETS as BERT_PRESETS
    from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS

    vit, bert = f"vit_base_patch32_{layers}_layers", f"bert_base_{layers}_layers"
    VIT_PRESETS[vit] = {**VIT_PRESETS["vit_base_patch32"], "num_layers": layers}
    BERT_PRESETS[bert] = {**BERT_PRESETS["bert_base"], "num_layers": layers}
    return [f"model_attributes.{model}.vit_preset", vit,
            f"model_attributes.{model}.bert_preset", bert, *INIT_ON_DEVICE]
STAGE2_TOPK, STAGE2_CHUNK = 8, 32
# card bf16 vs CPU fp32, DMAE's first step at B=4 on the same fp32 masters
# and padded batch (``--calibrate dmae`` reads the gap): each loss term's
# |Δ|, the cosine of all gradients together and the least per-parameter
# cosine. Sound runs over three seeds stay below |Δ| 0.0013 (level 1) and
# 0.00041 (level 3); the gradient cosines are noisy, down to 0.955 (all)
# and 0.776 (least): bf16 rounding moves WTI's max between near-equal frame
# tokens and NegNCE's hard set. The planted faults read |Δ level 3| 0.0098
# (WTI masked with finfo.min), 0.026 (token weights over padding, cos 0.68)
# and 0.0091 (the hard mask in one direction) (H100 readings)
DMAE_DLOSS_MAX = {"level1_similarity_loss": 0.005, "level3_similarity_loss": 0.003}
DMAE_COS_ALL, DMAE_COS_MIN = 0.9, 0.5


def dmae_batch(B: int, seed: int, padded: bool = False) -> dict:
    """A DMAE batch: 12 frames of 224² and captions of up to 32 tokens
    (ragged). ``padded``: row 0 keeps 2 live frames and a 3-token caption,
    and every row from 1 on pads its last 3 frames, so that the WTI masking
    and the token weights meet padding on both sides."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, DMAE_TEXT_LEN + 1, B)
    video_mask = np.ones((B, DMAE_FRAMES), np.int64)
    if padded:
        lens[0] = 3
        video_mask[0, 2:] = 0
        video_mask[1:, -3:] = 0
    mask = (np.arange(DMAE_TEXT_LEN)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, DMAE_FRAMES, SIZE, SIZE, 3)).astype(np.float32),
            "video_mask": video_mask,
            "caption_input_ids": rng.integers(1, 30522, (B, DMAE_TEXT_LEN)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, DMAE_TEXT_LEN), np.int64)}


@contextlib.contextmanager
def no_default_init():
    """Linear and Embedding modules built without torch's default init (a
    second of CPU time per 100 M values), for models whose every value is
    then set from masters."""
    nn = torch.nn
    saved = nn.Linear.reset_parameters, nn.Embedding.reset_parameters
    nn.Linear.reset_parameters = nn.Embedding.reset_parameters = lambda self: None
    try:
        yield
    finally:
        nn.Linear.reset_parameters, nn.Embedding.reset_parameters = saved


def config_model(config: str, opts=(), device: str = "cuda", dtype: str = "bfloat16",
                 seed: int = SEED, masters=None, momentum: float = 0.0, on_device: bool = False):
    """(shell, state, train_step) of ``config``'s only model and its
    optimizer through the port's entry points; seeded random weights (drawn
    on the device with ``on_device``) unless fp32 ``masters`` are given;
    with ``momentum`` the state holds MoCo momentum towers over ``base``."""
    name = next(iter(build_config(config)["model_attributes"]))
    cfg = build_config(config, opts=[f"model_attributes.{name}.dtype_str", dtype, *opts])
    with no_default_init():  # the init or the masters set every value
        shell = build_model(cfg, device=device)
    if masters is None:
        shell.init(seed, on_device=on_device)
    tx, _ = build_optimizer(flax_paths(shell.module), cfg["optimizer_attributes"].to_dict(),
                            cfg["training_parameters"].to_dict())
    state = TrainState.create(shell.module, tx, masters)
    if momentum:
        state.init_momentum("base")
    return shell, state, make_train_step(shell, tx, momentum)


def dmae_twins(seed: int):
    """DMAE on the CPU in fp32 (plain versions) and on the card in bf16 on
    the same fp32 masters, and a padded B=4 batch."""
    cpu, cpu_state, _ = config_model(DMAE_CONFIG, device="cpu", dtype="float32", seed=seed)
    card, _, _ = config_model(DMAE_CONFIG, masters=cpu_state.params)
    return card, cpu, dmae_batch(4, SEED + 7, padded=True)


def compare_dmae(card, cpu) -> dict:
    (t_card, g_card), (t_cpu, g_cpu) = card, cpu
    res = compare_steps((sum(t_card.values()), g_card), (sum(t_cpu.values()), g_cpu))
    res["abs_dloss_terms"] = {k: abs(t_card[k] - t_cpu[k]) for k in t_cpu}
    res["loss_terms_cpu"] = t_cpu
    return res


def dmae_within_bound(res) -> bool:
    return res["grad_cos_all"] >= DMAE_COS_ALL and res["grad_cos_min"] >= DMAE_COS_MIN \
        and all(res["abs_dloss_terms"][k] <= DMAE_DLOSS_MAX[k] for k in DMAE_TERMS)


def dmae_faults(card):
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo): WTI masked with −inf (finfo.min) instead of zero
    before the max; token weights softmaxed over the padding too; NegNCE's
    hard mask taken in the row direction only."""
    from antmmf_torch.models import dmae
    from antmmf_torch.modules.losses.contrastive import NEG_INF

    real_wti, real_nce = dmae.wti_similarity, dmae.neg_nce_dmae
    heads = (card.module.text_weight_head, card.module.video_weight_head)

    def wti_neg_inf(tt, tw, vt, vw, tm, vm):
        c = torch.einsum("tld,vmd->tvlm", tt.float(), vt.float())
        valid = (tm[:, None, :, None] > 0) & (vm[None, :, None, :] > 0)
        c = c.masked_fill(~valid, NEG_INF)
        return 0.5 * (torch.einsum("tvl,tl->tv", c.amax(-1), tw.float())
                      + torch.einsum("tvm,vm->tv", c.amax(-2), vw.float()))

    def nce_one_direction(sim, logit_scale=100.0, c_pos=1.0, c_neg=0.5, margin=0.0):
        sim = sim.float()
        p = torch.softmax(sim * logit_scale, dim=-1).clamp(1e-6, 1 - 1e-6)
        eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
        hard = (torch.relu(margin + sim - torch.diagonal(sim)[:, None]) > 0) & ~eye
        neg = torch.where(hard, -torch.log(1.0 - p), 0.0)
        pos = -torch.log(torch.diagonal(p)).mean()
        return c_pos * pos + c_neg * neg.sum() / hard.sum().clamp(min=1)

    def over_padding():
        for head in heads:
            head.forward = (lambda h: lambda tokens, mask: torch.softmax(
                h.weight_proj(tokens.float())[..., 0], dim=-1))(head)

    def undo_heads():
        for head in heads:
            head.__dict__.pop("forward")

    return [("wti_masked_with_neg_inf", lambda: setattr(dmae, "wti_similarity", wti_neg_inf),
             lambda: setattr(dmae, "wti_similarity", real_wti)),
            ("token_weights_over_padding", over_padding, undo_heads),
            ("negnce_hard_mask_one_direction",
             lambda: setattr(dmae, "neg_nce_dmae", nce_one_direction),
             lambda: setattr(dmae, "neg_nce_dmae", real_nce))]


def calibrate_dmae(seeds=3) -> None:
    """Phase 14 (a)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        card, cpu, batch = dmae_twins(seed)
        ref = pretrain_first_step(cpu, batch)
        res = compare_dmae(pretrain_first_step(card, batch), ref)
        emit(phase="calibrate_dmae", kind="sound", seed=seed, **res,
             within_bound=dmae_within_bound(res))
    for name, plant, undo in dmae_faults(card):
        plant()
        try:
            res = compare_dmae(pretrain_first_step(card, batch), ref)
        finally:
            undo()
        emit(phase="calibrate_dmae", kind="fault", fault=name, seed=seeds - 1, **res,
             within_bound=dmae_within_bound(res))
    emit(phase="calibrate_dmae", kind="bound", dloss_max=DMAE_DLOSS_MAX,
         grad_cos_all=DMAE_COS_ALL, grad_cos_min=DMAE_COS_MIN)


def bare_steps(name: str, gpu: str, shell, state, step, batch, launches: dict, extra=None,
               phase: str = "retrieval_variants"):
    """Warm-up and timed steps of a bare train step on one repeated batch:
    step times, launches, losses, peak memory, then 2 profiled steps for
    device-busy time and idle share. Returns (state, summary)."""
    from torch.profiler import ProfilerActivity, profile

    totals = dict.fromkeys(launches, 0)
    times, counts, terms = [], [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        terms.append({k: float(v) for k, v in scalars.items()
                      if k.startswith("losses/") or k == "total_loss"})
        for k, n in counts[-1].items():
            totals[k] += n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[TRAIN_WARMUP:]
    p50 = float(np.percentile(timed, 50))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    busy, n_ops, top = device_busy(prof, 2)
    k1_ms = sum(ms for name, ms in device_ms_by_name(prof, 2)[0].items()
                if "small_attention_" in name)
    B = batch["caption_input_ids" if "caption_input_ids" in batch else "image_data"].shape[0]
    summary = dict(step_ms=times, step_p50_ms=p50, step_p95_ms=float(np.percentile(timed, 95)),
                   clip_pairs_per_s=B * 1e3 / p50, launches_per_step=counts[-1],
                   peak_mem_gb=peak_gb, device_busy_ms=busy if n_ops else "not measured",
                   device_idle_share=1 - busy / p50 if n_ops else "not measured",
                   device_ops_per_step=n_ops, top_device_ops_ms=top, loss_terms=terms,
                   small_attention_device_ms=k1_ms if n_ops else "not measured")
    emit(phase=phase, part=name, batch=B, gpu=gpu, **summary, **(extra or {}))
    check(all(np.isfinite(list(t.values())).all() for t in terms), f"{name}: a loss is not finite")
    check(all(c == launches for c in counts),
          f"{name}: launches per step {counts[-1]}; expected {launches}")
    return state, dict(summary, totals=totals)


def dmae_bare(gpu: str) -> dict:
    """Phase 14 (b): the bare DMAE step at the config's B=128, 12 frames at
    224², L=32, on one repeated batch, at RV_LAYERS of the towers' 12
    layers."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shell, state, step = config_model(DMAE_CONFIG, cut_towers("dmae_retrieval"), on_device=True)
    batch = shell.to_device(dmae_batch(DMAE_BATCH, SEED + 1))
    setup_s = time.perf_counter() - t0
    _, res = bare_steps("dmae_bare_step", gpu, shell, state, step, batch, RV_DMAE_LAUNCHES,
                        dict(config=DMAE_CONFIG, frames=DMAE_FRAMES, text_len=DMAE_TEXT_LEN,
                             vit_images=DMAE_BATCH * DMAE_FRAMES, setup_s=setup_s,
                             tower_layers=RV_LAYERS))
    del shell, state, step, batch
    torch.cuda.empty_cache()
    return res["totals"]


def rv_argv(root: str, config: str, *extra: str) -> list:
    """``trainer_argv``'s overrides on ``config`` at B=32: one full
    validation at the end (no test inference), the BERT vocabulary given."""
    data = "task_attributes.univl_task.dataset_attributes.video_text_retrieval"
    tp = "training_parameters"
    argv = trainer_argv(root, f"{data}.text.vocab_file", VOCAB, f"{tp}.snapshot_interval",
                        "1000", f"{tp}.run_type", "train", f"{tp}.batch_size", str(RV_BATCH),
                        f"{tp}.test_batch_size", str(RV_BATCH), *extra)
    argv[1] = config
    return argv


def rv_trainer(gpu: str, name: str, config: str, launches: dict, eval_launches: dict,
               extra=(), track=None, write=None, argv=None):
    """``antmmf_torch.run.main`` on ``config`` over phase 12's synthetic
    layout (or the one ``write(root, seed)`` writes, with ``argv(root,
    config, *extra)`` in place of ``rv_argv``; written under ``build/`` and
    deleted at the end): RV_STEPS steps
    at B=32 and the final full validation, then a run resumed to
    RV_RESUMED_STEPS, its state checked bit for bit. ``launches`` are a
    train step's, ``eval_launches`` an eval forward's or encode batch's.
    Returns (the phase's launches, the probe, the first run's state and
    records, the summary)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="rv_smoke_", dir=build)
    probe = TrainerProbe()
    probe.track = track
    uninstall = probe.install()
    try:
        (write or write_msrvtt_layout)(root, SEED)
        argv = argv or rv_argv
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        first = run.main(argv(root, config, "training_parameters.max_iterations",
                              str(RV_STEPS), *extra))
        setup_s = first.timings["first_step_start"] - t0
        info = dict(state=first.state, timings=first.timings, setup_s=setup_s,
                    validations=list(probe.validations), encoded=list(probe.encoded),
                    encode_launches=list(probe.encode), first_n=len(probe.train))
        probe.reference = first
        second = run.main(argv(root, config, "training_parameters.max_iterations",
                               str(RV_RESUMED_STEPS), "training_parameters.resume", "true",
                               *extra))
        counts = read_counts()  # the main path ends here
        info.update(resumed_end=second.state.step, resumed_state=second.state,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        probe.reference = None
        del first, second
        torch.cuda.empty_cache()
    finally:
        uninstall()
        shutil.rmtree(root, ignore_errors=True)
    losses = [float(x) for x in probe.losses]
    step_ms = [t * 1e3 for t in info["timings"]["step_s"]]
    wait_ms = [t * 1e3 for t in info["timings"]["loader_wait_s"]]
    val = [v for v in info["validations"] if v["dataset_type"] == "val"][-1]
    summary = dict(losses=losses, step_ms=step_ms, step_p50_ms=float(np.percentile(step_ms, 50)),
                   loader_wait_p50_ms=float(np.percentile(wait_ms, 50)),
                   clip_pairs_per_s=RV_BATCH * (len(step_ms) - 1) * 1e3
                   / float(np.sum(step_ms[1:])),
                   clip_pairs_per_s_loop_wall=RV_BATCH * len(step_ms) / info["timings"]["loop_s"],
                   setup_s=info["setup_s"], full_val_s=val["seconds"],
                   val_metrics=val["metrics"], resumed_state_equal=probe.resumed_equal,
                   resumed_end_step=info["resumed_end"], peak_mem_gb=info["peak_gb"],
                   launches=counts, launches_per_step=probe.train[0],
                   train_steps=len(probe.train), eval_forwards=len(probe.eval),
                   encode_batches=len(probe.encode))
    evals = probe.eval + probe.encode
    check(all(np.isfinite(losses)) and len(losses) == RV_RESUMED_STEPS,
          f"{name}: losses {losses}")
    check(all(c == launches for c in probe.train) and all(c == eval_launches for c in evals),
          f"{name}: launches per step {probe.train[:1]}, per eval forward or encode "
          f"{evals[:1]}; expected {launches}, {eval_launches}")
    check(all(counts[k] == launches[k] * len(probe.train) + eval_launches[k] * len(evals)
              for k in counts), f"{name}: the phase launched {counts}")
    check(probe.resumed_equal is not None and all(probe.resumed_equal.values())
          and info["resumed_end"] == RV_RESUMED_STEPS,
          f"{name}: resume {probe.resumed_equal}, end step {info['resumed_end']}")
    check(probe.devices == {"cuda"}, f"{name}: ran on {probe.devices}")
    return counts, probe, info, summary


def host_wti(w: dict, first: np.ndarray) -> np.ndarray:
    """The corpus WTI grid in float64 from the collected components, videos
    at the rows ``first``: pairs with a padded token zeroed, then the max."""
    tt, tw, tm = (w[k].astype(np.float64) for k in ("wti_text_tokens", "wti_text_weights",
                                                      "wti_text_mask"))
    vt, vw, vm = (w[k][first].astype(np.float64) for k in ("wti_video_tokens",
                                                            "wti_video_weights", "wti_video_mask"))
    c = np.einsum("tld,vmd->tvlm", tt, vt) * tm[:, None, :, None] * vm[None, :, None, :]
    return 0.5 * (np.einsum("tvl,tl->tv", c.max(-1), tw) + np.einsum("tvm,vm->tv", c.max(-2), vw))


def dmae_trainer(gpu: str) -> dict:
    """Phase 14 (c): ``msrvtt_retrieval.yml`` through ``retrieval_trainer``
    at RV_LAYERS of the towers' 12 layers; the L1 and L3 recalls of the final
    validation against a host recomputation from the collected encode
    outputs."""
    counts, probe, info, summary = rv_trainer(gpu, "dmae_trainer", DMAE_CONFIG, RV_DMAE_LAUNCHES,
                                              RV_DMAE_LAUNCHES, cut_towers("dmae_retrieval"))
    outs = [o for o, _ in info["encoded"]]
    vids = np.concatenate([v for _, v in info["encoded"]])
    cat = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    _, first = np.unique(vids, return_index=True)
    l1 = sim_recalls(cat["text_embed"].astype(np.float64)
                     @ cat["visual_embed"][first].astype(np.float64).T, vids)
    l3 = sim_recalls(host_wti(cat, first), vids)
    reported = summary["val_metrics"]
    host = {**{f"l1_simi_{k}": v for k, v in l1.items()},
            **{f"l3_simi_{k}": v for k, v in l3.items()}}
    emit(phase="retrieval_variants", part="dmae_trainer", config=DMAE_CONFIG, batch=RV_BATCH,
         gpu=gpu, **summary, recalls_host=host, corpus_texts=len(vids))
    check(len(info["encoded"]) == TRAINER_CLIPS // RV_BATCH and len(vids) == TRAINER_CLIPS,
          f"dmae trainer: {len(vids)} texts encoded in the final validation")
    check(all(abs(reported[k] - v) <= 1e-9 for k, v in host.items()),
          f"dmae trainer: recalls {dict((k, reported[k]) for k in host)} against the host's {host}")
    check(0 <= reported["l3_simi_t2v-mean_recall"] <= 100, "dmae trainer: L3 mean recall")
    return counts


def moco_bare(gpu: str) -> dict:
    """Phase 14 (d), first part: ``video_retrieval.yml`` with MoCo (momentum
    0.99, the model's queue of 4096) at its B=128 beside the plain step of
    the same config on the same batch, both at RV_LAYERS of the towers' 12
    layers; the key forward and the EMA timed alone."""
    batch_np = train_batch(128, SEED + 1)
    totals = dict.fromkeys(MOCO_LAUNCHES, 0)
    results = {}
    cut = cut_towers("univl_retrieval")
    # a plain step launches K1 as an eval forward does: once a tower layer
    for leg, leg_opts, momentum, launches in (("plain", cut, 0.0, RV_EVAL_LAUNCHES),
                                              ("moco", MOCO_OPTS + cut, MOCO_MU,
                                               RV_MOCO_LAUNCHES)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shell, state, step = config_model(TRAINER_CONFIG, leg_opts, momentum=momentum,
                                          on_device=True)
        batch = shell.to_device(batch_np)
        extra = {"config": TRAINER_CONFIG, "leg": leg}
        state, res = bare_steps(f"moco_bare_step_{leg}", gpu, shell, state, step, batch,
                                launches, extra)
        results[leg] = res
        if leg == "moco":
            saved = read_counts()
            module = shell.module
            with torch.no_grad():
                key_ms = cuda_ms(lambda: module.moco_keys(state.key_module, batch), iters=5,
                                 warmup=2)
            ema_ms = cuda_ms(lambda: state.update_momentum(MOCO_MU), iters=5, warmup=2)
            for fn in KERNELS:  # timing launches are not path launches
                fn.launches = saved[fn.__name__]
            queue = module.text_queue
            results["moco_parts"] = dict(key_forward_ms=key_ms, ema_ms=ema_ms,
                                         queue_filled=int(queue.filled), queue_ptr=int(queue.ptr))
        for k, n in res["totals"].items():
            totals[k] += n
        del shell, state, step, batch
    cost = results["moco"]["step_p50_ms"] - results["plain"]["step_p50_ms"]
    emit(phase="retrieval_variants", part="moco_cost", batch=128, gpu=gpu,
         moco_p50_ms=results["moco"]["step_p50_ms"], plain_p50_ms=results["plain"]["step_p50_ms"],
         moco_over_plain_ms=cost, moco_busy_ms=results["moco"]["device_busy_ms"],
         plain_busy_ms=results["plain"]["device_busy_ms"], **results["moco_parts"])
    parts = results["moco_parts"]
    # 8 + 2 profiled steps (and the timed EMA passes) of 128 keys into 4096 slots
    check(parts["queue_filled"] == MOCO_QUEUE, f"moco bare step: queue {parts}")
    torch.cuda.empty_cache()
    return totals


def moco_trainer(gpu: str) -> dict:
    """Phase 14 (d), second part: the trainer at B=32 with MoCo at RV_LAYERS
    of the towers' 12 layers, 6 steps and a resume to 8: ``ptr`` and
    ``filled`` after 6 steps, one momentum tensor
    against a host EMA of the masters after each step, the queues and
    momentum restored bit for bit."""
    counts, probe, info, summary = rv_trainer(gpu, "moco_trainer", TRAINER_CONFIG,
                                              RV_MOCO_LAUNCHES, RV_EVAL_LAUNCHES,
                                              MOCO_OPTS + cut_towers("univl_retrieval"),
                                              track=MOCO_TRACKED)
    state = info["state"]
    masters0 = probe.first[0][MOCO_TRACKED].cpu().float()
    host = masters0.clone()
    for p in probe.tracked[:info["first_n"]]:
        host = host * MOCO_MU + (1.0 - MOCO_MU) * p.cpu().float()
    ema_err = (state.momentum[MOCO_TRACKED].cpu() - host).abs().max().item()
    queue = state.model.text_queue
    ptr, filled = int(queue.ptr), int(queue.filled)
    emit(phase="retrieval_variants", part="moco_trainer", config=TRAINER_CONFIG, batch=RV_BATCH,
         gpu=gpu, **summary, queue_ptr=ptr, queue_filled=filled, momentum_vs_host_ema=ema_err)
    check(ptr == RV_STEPS * RV_BATCH % MOCO_QUEUE and filled == MOCO_QUEUE,
          f"moco trainer: ptr {ptr}, filled {filled} after {RV_STEPS} steps")
    check(ema_err <= 1e-6, f"moco trainer: momentum against the host EMA {ema_err}")
    probe.first = None
    return counts


def stage2_eval(gpu: str) -> dict:
    """Phase 14 (e): ``video_retrieval.yml`` with the cross-encoder through
    ``retrieval_trainer`` (``stage2_topk`` 8, ``stage2_chunk`` 32), one
    ``evaluate_set("val")`` over the 64 clips (``run_type val``)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="stage2_smoke_", dir=build)
    probe = TrainerProbe()
    uninstall = probe.install()
    scores = []
    real_rescore = RetrievalTrainer._stage2_rescore

    def rescore(trainer, *args):
        t0 = time.perf_counter()
        scores.append(real_rescore(trainer, *args))
        scores.append(time.perf_counter() - t0)
        return scores[-2]

    RetrievalTrainer._stage2_rescore = rescore
    try:
        write_msrvtt_layout(root, SEED)
        tp = "training_parameters"
        argv = rv_argv(root, TRAINER_CONFIG, f"{tp}.trainer", "retrieval_trainer",
                       "model_attributes.univl_retrieval.with_cross_encoder", "true",
                       f"{tp}.stage2_topk", str(STAGE2_TOPK), f"{tp}.stage2_chunk",
                       str(STAGE2_CHUNK), f"{tp}.run_type", "val")
        zero_counts()
        t0 = time.perf_counter()
        trainer_ = run.main(argv)
        wall_s = time.perf_counter() - t0
        counts = read_counts()  # the main path ends here
        metrics = probe.validations[0]["metrics"] if probe.validations else {}
        val_s = probe.validations[0]["seconds"] if probe.validations else None
        del trainer_
    finally:
        RetrievalTrainer._stage2_rescore = real_rescore
        uninstall()
        shutil.rmtree(root, ignore_errors=True)
    l2, rescore_s = scores
    vids = np.concatenate([v for _, v in probe.encoded])
    cand = (l2 > -1e29).sum(1)
    lo, hi = sim_recalls(l2, vids, "above"), sim_recalls(l2, vids, "at")
    pairs = TRAINER_CLIPS * STAGE2_TOPK
    expected_fwd = -(-pairs // STAGE2_CHUNK) * 2  # chunks × 2 cross layers
    reported = {k: metrics[f"l2_simi_{k}"] for k in lo}
    emit(phase="retrieval_variants", part="stage2_eval", config=TRAINER_CONFIG, gpu=gpu,
         clips=TRAINER_CLIPS, topk=STAGE2_TOPK, chunk=STAGE2_CHUNK, pairs=pairs,
         evaluate_set_s=val_s, rescore_s=rescore_s, run_s=wall_s, launches=counts,
         encode_batches=len(probe.encode), rescore_chunks=len(probe.rescore),
         l2_recalls=reported, host_ties_above=lo, host_ties_at=hi,
         l1_recalls={k: metrics[f"l1_simi_{k}"] for k in lo})
    check(counts["flash_fwd"] == expected_fwd and counts["flash_dq"] == 0
          and counts["flash_dkv"] == 0,
          f"stage 2: {counts}; expected {expected_fwd} flash_fwd and no backward kernel")
    check(counts["small_attention"] == 24 * len(probe.encode) and len(probe.encode) == 2,
          f"stage 2: {counts['small_attention']} small_attention over {len(probe.encode)} encodes")
    check(l2.shape == (TRAINER_CLIPS, TRAINER_CLIPS) and (cand == STAGE2_TOPK).all()
          and (l2[l2 <= -1e29] == -1e30).all(), "stage 2: candidates or the −1e30 fill")
    check(all(hi[k] <= reported[k] <= lo[k] for k in lo),
          f"stage 2: L2 recalls {reported} outside the host's re-ranking [{hi}, {lo}]")
    check(probe.devices == {"cuda"}, f"stage 2: ran on {probe.devices}")
    return counts


def phase_retrieval_variants(gpu: str) -> dict:
    """Phase 14: (a) DMAE card vs CPU, (b) the bare DMAE step, (c) DMAE
    through ``retrieval_trainer``, (d) MoCo bare and through the trainer,
    (e) stage-2 re-ranking. Returns the launches of (b) to (e) by kernel."""
    t0 = time.perf_counter()
    card, cpu, batch = dmae_twins(SEED)
    ref = pretrain_first_step(cpu, batch)
    res = compare_dmae(pretrain_first_step(card, batch), ref)
    caught = {}
    for name, plant, undo in dmae_faults(card):
        plant()
        try:
            caught[name] = not dmae_within_bound(compare_dmae(pretrain_first_step(card, batch),
                                                              ref))
        finally:
            undo()
    ok = dmae_within_bound(res)
    emit(phase="retrieval_variants", part="dmae_card_vs_cpu", batch=4, **res,
         dloss_max=DMAE_DLOSS_MAX, grad_cos_all_bound=DMAE_COS_ALL,
         grad_cos_min_bound=DMAE_COS_MIN, faults_caught=caught, ok=ok)
    check(ok, "card and CPU DMAE steps disagree beyond the stated bound")
    check(all(caught.values()), f"DMAE card vs CPU: a planted fault passed the bound: {caught}")
    del card, cpu, batch, ref
    torch.cuda.empty_cache()
    totals = dict.fromkeys(DMAE_LAUNCHES, 0)
    seconds = {"dmae_card_vs_cpu": time.perf_counter() - t0}
    for part in (dmae_bare, dmae_trainer, moco_bare, moco_trainer, stage2_eval):
        t1 = time.perf_counter()
        for k, n in part(gpu).items():
            totals[k] += n
        torch.cuda.empty_cache()
        seconds[part.__name__] = time.perf_counter() - t1
    emit(phase="retrieval_variants", part="summary", seconds=time.perf_counter() - t0,
         part_seconds=seconds, launches=totals)
    return totals


# ----------------------------------------------------------------- phase 15
TASK_MODEL = "model_attributes.univl_retrieval"
CAPTION_OPTS = [f"{TASK_MODEL}.model_class", "univl_caption"]
CLS_OPTS = [f"{TASK_MODEL}.model_class", "univl_classification"]
MCQA_OPTS = [f"{TASK_MODEL}.model_class", "univl_mcqa"]
CAPTION_LEN, CAPTION_BEAMS, CAPTION_REQUESTS = 40, 4, 6  # the model's defaults; timed requests
MCQA_OPTIONS, TASK_BATCH, TWIN_BATCH = 5, 32, 2
NO_LAUNCHES = {"small_attention": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
               "int4_gemv": 0}
# a caption request or step: the ViT's 12 layers on K1; the decoder's heads
# are 768 / 8 = 96 wide, outside the kernels, so its attention takes the
# einsum core. Classification and MCQA: 12 ViT + 12 BERT layers (MCQA's B·5
# options in one text-tower call)
CAPTION_LAUNCHES = {**NO_LAUNCHES, "small_attention": 12}
TOWER_LAUNCHES = {**NO_LAUNCHES, "small_attention": 24}
# card bf16 vs CPU fp32 on the same masters (``--calibrate task_heads``):
# the teacher-forced caption loss's |Δ|, the cosine of the logits at the
# scored positions and their largest |Δ| over the CPU logits' spread, and
# MCQA's largest |Δlogit|. Sound runs over three seeds stay below |Δloss|
# 0.0025, above cos 0.999962, below 0.0052 of the spread, and below MCQA's
# 0.022; the causal mask dropped reads |Δloss| 0.114, cos 0.867; the memory
# mask ignored cos 0.9974 and 0.072 of the spread (its |Δloss| 0.0003 is
# inside); MCQA attending to option padding 0.366 (H100 readings)
CAPTION_DLOSS_MAX, CAPTION_COS_MIN, CAPTION_DLOGIT_MAX = 0.01, 0.9995, 0.02
MCQA_DLOGIT_MAX = 0.1
# the card in fp32: the cached decode's logits against the re-encoded ones
# on the same tokens, over their spread (sound 7.8e-7 at most over three
# seeds, the cache written one slot late 0.21); where the two searches'
# candidate indices part, the smallest gap between adjacent top candidates
# in log-probability (no sound run parted)
CACHE_DLOGIT_MAX, TIE_GAP_MAX = 1e-5, 1e-3


def caption_batch(B: int, seed: int) -> dict:
    """8 frames of 224², row 1 with its last 3 frames padded; captions of
    8 to 30 tokens ([CLS] ... [SEP], then pads) as ``caption_raw_input_ids``."""
    batch = train_batch(B, seed)
    ids, mask = batch.pop("caption_input_ids"), batch["caption_input_mask"]
    lens = mask.sum(1)
    ids[:, 0] = 101
    ids[np.arange(B), lens - 1] = 102
    batch.update(caption_raw_input_ids=ids)
    if B > 1:
        batch["video_mask"][1, -3:] = 0
    return batch


def cls_batch(B: int, seed: int) -> dict:
    return {**train_batch(B, seed),
            "targets": np.random.default_rng(seed + 1).integers(0, 2, B)}


def mcqa_batch(B: int, seed: int) -> dict:
    """5 options of 4 to 30 tokens a clip, and the answer's index."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, TEXT_LEN + 1, (B, MCQA_OPTIONS))
    mask = (np.arange(TEXT_LEN)[None, None] < lens[..., None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, FRAMES, SIZE, SIZE, 3)).astype(np.float32),
            "video_mask": np.ones((B, FRAMES), np.int64),
            "options_input_ids": rng.integers(1, 30522, (B, MCQA_OPTIONS, TEXT_LEN)) * mask,
            "options_input_mask": mask, "targets": rng.integers(0, MCQA_OPTIONS, B)}


def task_model(opts, device: str = "cuda", dtype: str = "bfloat16", seed: int = SEED,
               masters=None):
    """(shell, state, train_step) of ``video_retrieval.yml``'s model class
    overridden by ``opts``, at full width."""
    return config_model(TRAINER_CONFIG, opts, device, dtype, seed, masters)


def caption_serving(gpu: str) -> dict:
    """Phase 15 (a): ``caption_predictor`` through the CLI's code on
    ``video_retrieval.yml`` with ``univl_caption`` at its defaults (seeded
    weights): a warm-up and CAPTION_REQUESTS requests of 8 frames at 224²,
    4 beams, 40 tokens. Returns the launches of the requests."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()  # tensors of earlier phases held only by reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    pred, _ = build_predictor(["--config", TRAINER_CONFIG, "--predictor", "caption_predictor",
                               "--no_ckpt", *CAPTION_OPTS])
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 15)
    reqs = [{"image_data": rng.standard_normal((FRAMES, SIZE, SIZE, 3)).astype(np.float32)}
            for _ in range(CAPTION_REQUESTS + 1)]
    totals, lat, outs = dict.fromkeys(NO_LAUNCHES, 0), [], []
    for req in reqs:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()  # the main path ends here
        check(counts == CAPTION_LAUNCHES,
              f"caption request: launches {counts}; expected {CAPTION_LAUNCHES}")
        for k, n in counts.items():
            totals[k] += n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb  # above what was held
    for out in outs:
        ids = np.asarray(out["generated_ids"])
        check(ids.shape == (1, CAPTION_LEN) and ids[0, 0] == 101
              and ((ids >= 0) & (ids < 30522)).all(), f"caption ids {ids.shape}")
        check(isinstance(out["caption"], str) and np.isfinite(out["scores"]).all(),
              "caption text and score")
    timed = lat[1:]
    module = pred.shell.module
    batch = pred.shell.to_device(pred.build_sample(reqs[0]).arrays())

    def prime():
        with torch.inference_mode():
            memory, _ = module._memory(batch)
            module.decoder.prime(memory)

    prime_ms = pct(host_ms(lambda: (prime(), torch.cuda.synchronize()), 10, 2))["p50_ms"]
    p50 = float(np.percentile(timed, 50))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred.predict(reqs[1])
        torch.cuda.synchronize()
    busy, n_ops, top = device_busy(prof, 1)
    summary = dict(request_ms=lat, request_p50_ms=p50,
                   request_p95_ms=float(np.percentile(timed, 95)), prime_ms=prime_ms,
                   decode_ms_per_step=(p50 - prime_ms) / (CAPTION_LEN - 1),
                   peak_mem_gb=peak_gb, held_before_gb=held_gb, load_s=load_s,
                   launches_per_request=CAPTION_LAUNCHES,
                   device_busy_ms=busy if n_ops else "not measured",
                   device_idle_share=1 - busy / p50 if n_ops else "not measured",
                   device_ops_per_request=n_ops, top_device_ops_ms=top,
                   captions=[o["caption"][:60] for o in outs[:2]])
    emit(phase="task_heads", part="caption_serving", beams=CAPTION_BEAMS, tokens=CAPTION_LEN,
         frames=FRAMES, gpu=gpu, **summary)
    del pred, module, batch
    torch.cuda.empty_cache()
    return totals


def task_twins(opts, seed: int):
    """The model on the CPU in fp32 (plain versions) and on the card in bf16
    on the same fp32 masters."""
    cpu, cpu_state, _ = task_model(opts, "cpu", "float32", seed)
    card, _, _ = task_model(opts, masters=cpu_state.params)
    return card, cpu


def forward_out(shell, batch) -> dict:
    with torch.no_grad():
        _, (out, scalars) = shell.loss_fn(batch, deterministic=True)
    return dict(logits=out["logits"].float().cpu(),
                loss=float(next(v for k, v in scalars.items() if k.startswith("losses/"))))


def compare_caption(card, cpu, batch) -> dict:
    """Teacher-forced logits at the positions the loss scores, and the loss."""
    valid = torch.as_tensor(batch["caption_input_mask"][:, 1:] > 0)
    a, b = card["logits"][:, :-1][valid].double(), cpu["logits"][:, :-1][valid].double()
    cos = torch.nn.functional.cosine_similarity(a.reshape(-1), b.reshape(-1), dim=0).item()
    return dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                abs_dloss=abs(card["loss"] - cpu["loss"]), logits_cos=cos,
                max_abs_dlogit_over_spread=((a - b).abs().max() / (b.max() - b.min())).item())


def compare_mcqa(card, cpu) -> dict:
    return dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                max_abs_dlogit=(card["logits"] - cpu["logits"]).abs().max().item(),
                logits_cpu=cpu["logits"].tolist())


def caption_within_bound(res) -> bool:
    return res["abs_dloss"] <= CAPTION_DLOSS_MAX and res["logits_cos"] >= CAPTION_COS_MIN \
        and res["max_abs_dlogit_over_spread"] <= CAPTION_DLOGIT_MAX


def mcqa_within_bound(res) -> bool:
    return res["max_abs_dlogit"] <= MCQA_DLOGIT_MAX


def cache_late(real_forward):
    """A decode call's k/v written one slot past its position (and its
    validity mask shifted with it)."""
    def forward(self, x, bias=None, kv=None, return_kv=False, cached_kv=None, cache=None,
                decode_pos=None):
        return real_forward(self, x, bias, kv, return_kv, cached_kv, cache,
                            None if decode_pos is None else decode_pos + 1)
    return forward


def task_faults():
    """Faults planted on the card's models only: (name, model, plant, undo).
    The caption decoder with its causal mask dropped, or its cross-attention
    ignoring the memory mask; MCQA attending to the options' padding."""
    from antmmf_torch.modules import decoders

    real_causal, real_mask = decoders.causal_bias, decoders.make_attention_mask
    return [
        ("causal_mask_dropped", "caption",
         lambda: setattr(decoders, "causal_bias", lambda L, device=None: torch.zeros(
             1, 1, L, L, device=device)),
         lambda: setattr(decoders, "causal_bias", real_causal)),
        ("memory_mask_ignored", "caption",
         lambda: setattr(decoders, "make_attention_mask", lambda m: torch.zeros(
             m.shape[0], 1, 1, m.shape[1], device=m.device)),
         lambda: setattr(decoders, "make_attention_mask", real_mask)),
        ("option_padding_attended", "mcqa", None, None)]


def twin_readings(seed: int, faults: bool = False) -> dict:
    """Card bf16 vs CPU fp32 on the same masters: the caption model's
    teacher-forced logits and loss at B=2 (a padded frame, ragged captions),
    MCQA's option logits at B=2; with ``faults`` each planted fault's too."""
    out = {}
    cb, mb = caption_batch(TWIN_BATCH, SEED + 30 + seed), mcqa_batch(TWIN_BATCH, SEED + 40 + seed)
    for model, opts in (("caption", CAPTION_OPTS), ("mcqa", MCQA_OPTS)):
        card, cpu = task_twins(opts, seed)
        batch = cb if model == "caption" else mb
        ref = forward_out(cpu, batch)
        compare_fn = (lambda c: compare_caption(c, ref, cb)) if model == "caption" else \
            (lambda c: compare_mcqa(c, ref))
        out[model] = compare_fn(forward_out(card, batch))
        for name, target, plant, undo in task_faults() if faults else ():
            if target != model:
                continue
            if plant is None:  # the options' masks all ones on the card
                res = compare_fn(forward_out(card, {**batch, "options_input_mask":
                                                    np.ones_like(batch["options_input_mask"])}))
            else:
                plant()
                try:
                    res = compare_fn(forward_out(card, batch))
                finally:
                    undo()
            out[name] = res
        del card, cpu
        torch.cuda.empty_cache()
    return out


def cache_reading(seed: int, fault: bool = False) -> dict:
    """The caption model in fp32 on the card: beam search with the caches and
    by re-encoding (4 beams, 40 tokens, B=2 with a padded frame), every
    step's top candidates recorded; and the cached decode's logits against
    the re-encoded ones on the re-encoded best tokens. With ``fault`` the
    decode cache is written one slot late."""
    from antmmf_torch.modules import attention
    from antmmf_torch.utils import text_utils

    shell, _, _ = task_model(CAPTION_OPTS, dtype="float32", seed=seed)
    module = shell.module
    batch = shell.to_device(caption_batch(TWIN_BATCH, SEED + 50 + seed))
    real_top_k, real_forward = text_utils.top_k, attention.MultiHeadAttention.forward
    logs = {}

    def recording(log):
        def top_k(x, k):
            v, i = real_top_k(x, min(k + 1, x.shape[-1]))
            log.append((v.cpu(), i.cpu()))
            return v[:, :k], i[:, :k]
        return top_k

    if fault:
        attention.MultiHeadAttention.forward = cache_late(real_forward)
    try:
        runs = {}
        for use_cache in (True, False):
            logs[use_cache] = []
            text_utils.top_k = recording(logs[use_cache])
            runs[use_cache] = module.generate(batch, num_beams=CAPTION_BEAMS,
                                              max_length=CAPTION_LEN, use_cache=use_cache)
        text_utils.top_k = real_top_k
        tokens = runs[False][0]
        with torch.inference_mode():
            memory, mm = module._memory(batch)
            full = module.decoder(tokens, memory, mm)
            kvs = module.decoder.prime(memory)
            H = module.decoder_heads
            caches = [{n: torch.zeros(TWIN_BATCH, H, CAPTION_LEN, memory.shape[-1] // H,
                                      device=memory.device) for n in ("k", "v")} for _ in kvs]
            worst = 0.0
            for t in range(CAPTION_LEN - 1):
                pos = torch.full((TWIN_BATCH,), t, dtype=torch.long, device=memory.device)
                logits, caches = module.decoder.decode_step(tokens[:, t], pos, caches, kvs, mm)
                worst = max(worst, (logits - full[:, t]).abs().max().item())
            spread = (full.max() - full.min()).item()
    finally:
        text_utils.top_k, attention.MultiHeadAttention.forward = real_top_k, real_forward
    parted = [j for j, (a, b) in enumerate(zip(logs[True], logs[False]))
              if not torch.equal(a[1][:, :CAPTION_BEAMS], b[1][:, :CAPTION_BEAMS])]
    gap = None
    if parted:  # the smallest gap between adjacent top candidates where they part
        v = logs[False][parted[0]][0]
        gap = (v[:, :-1] - v[:, 1:]).min().item()
    res = dict(tokens_equal=torch.equal(runs[True][0], runs[False][0]),
               scores_cached=runs[True][1].tolist(), scores_reencoded=runs[False][1].tolist(),
               cache_dlogit_over_spread=worst / spread, steps_parted=parted[:5],
               tie_gap_where_parted=gap)
    del shell, module, batch
    torch.cuda.empty_cache()
    return res


def cache_within_bound(res) -> bool:
    return res["cache_dlogit_over_spread"] <= CACHE_DLOGIT_MAX and (
        res["tie_gap_where_parted"] is None or res["tie_gap_where_parted"] <= TIE_GAP_MAX)


def calibrate_task_heads(seeds=3) -> None:
    """Phase 15 (b)'s readings: sound seeds, then the planted faults at the last."""
    for seed in range(seeds):
        res = twin_readings(seed, faults=seed == seeds - 1)
        for name, r in res.items():
            kind = "sound" if name in ("caption", "mcqa") else "fault"
            within = (caption_within_bound(r) if "logits_cos" in r else mcqa_within_bound(r))
            emit(phase="calibrate_task_heads", kind=kind, case=name, seed=seed, **r,
                 within_bound=within)
        res = cache_reading(seed)
        emit(phase="calibrate_task_heads", kind="sound", case="cache", seed=seed, **res,
             within_bound=cache_within_bound(res))
    res = cache_reading(seeds - 1, fault=True)
    emit(phase="calibrate_task_heads", kind="fault", case="cache_one_slot_late", seed=seeds - 1,
         **res, within_bound=cache_within_bound(res))
    emit(phase="calibrate_task_heads", kind="bound", caption_dloss_max=CAPTION_DLOSS_MAX,
         caption_cos_min=CAPTION_COS_MIN, caption_dlogit_max=CAPTION_DLOGIT_MAX,
         mcqa_dlogit_max=MCQA_DLOGIT_MAX, cache_dlogit_max=CACHE_DLOGIT_MAX,
         tie_gap_max=TIE_GAP_MAX)


def task_card_vs_cpu() -> None:
    """Phase 15 (b): the readings at seed 0, each fault outside its bound."""
    res = twin_readings(SEED, faults=True)
    cache, late = cache_reading(SEED), cache_reading(SEED, fault=True)
    caught = {name: not (caption_within_bound(r) if "logits_cos" in r else mcqa_within_bound(r))
              for name, r in res.items() if name not in ("caption", "mcqa")}
    caught["cache_one_slot_late"] = not cache_within_bound(late)
    emit(phase="task_heads", part="card_vs_cpu", batch=TWIN_BATCH, caption=res["caption"],
         mcqa=res["mcqa"], cache=cache, faults={n: r for n, r in res.items()
                                                 if n not in ("caption", "mcqa")},
         cache_fault=late, faults_caught=caught,
         bounds=dict(caption_dloss_max=CAPTION_DLOSS_MAX, caption_cos_min=CAPTION_COS_MIN,
                     caption_dlogit_max=CAPTION_DLOGIT_MAX, mcqa_dlogit_max=MCQA_DLOGIT_MAX,
                     cache_dlogit_max=CACHE_DLOGIT_MAX, tie_gap_max=TIE_GAP_MAX))
    check(caption_within_bound(res["caption"]), f"caption card vs CPU: {res['caption']}")
    check(mcqa_within_bound(res["mcqa"]), f"MCQA card vs CPU: {res['mcqa']}")
    check(cache_within_bound(cache), f"caption cached vs re-encoded: {cache}")
    check(all(caught.values()), f"task heads: a planted fault passed the bound: {caught}")


def task_bare_steps(gpu: str) -> dict:
    """Phase 15 (c): the bare train step at B=32 of each model on one
    repeated batch. Returns (the launches by kernel, each model's summary)."""
    totals, summaries = dict.fromkeys(NO_LAUNCHES, 0), {}
    for name, opts, make_batch, launches in (
            ("caption", CAPTION_OPTS, caption_batch, CAPTION_LAUNCHES),
            ("classification", CLS_OPTS, cls_batch, TOWER_LAUNCHES),
            ("mcqa", MCQA_OPTS, mcqa_batch, TOWER_LAUNCHES)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shell, state, step = task_model(opts)
        batch = shell.to_device(make_batch(TASK_BATCH, SEED + 60))
        _, res = bare_steps(f"{name}_bare_step", gpu, shell, state, step, batch, launches,
                            dict(config=TRAINER_CONFIG, model_class=opts[1]), phase="task_heads")
        for k, n in res["totals"].items():
            totals[k] += n
        summaries[name] = res
        del shell, state, step, batch
    torch.cuda.empty_cache()
    return totals, summaries


def caption_trainer(gpu: str, bare_p50_ms: float) -> dict:
    """Phase 15 (d): ``univl_caption`` through ``antmmf_torch.run.main`` on
    phase 12's synthetic layout (the ``captioning`` evaluator, which scores
    nothing: the trainer does not generate), 6 steps at B=32 and a resume to
    8 bit for bit; the first loss against the bare step on the trainer's
    first batch and masters."""
    counts, probe, info, summary = rv_trainer(
        gpu, "caption_trainer", TRAINER_CONFIG, CAPTION_LAUNCHES, CAPTION_LAUNCHES,
        extra=(*CAPTION_OPTS, "training_parameters.evaluator", "captioning"))
    masters, first_batch = probe.first
    shell, state, step = task_model(CAPTION_OPTS, masters=masters)
    _, bare = step(state, first_batch)
    bare_loss = float(bare["total_loss"])
    probe.first = None
    del shell, state, step, masters, first_batch, bare
    torch.cuda.empty_cache()
    losses = summary["losses"]
    emit(phase="task_heads", part="caption_trainer", config=TRAINER_CONFIG, batch=RV_BATCH,
         gpu=gpu, **summary, bare_step_p50_ms_b32=bare_p50_ms,
         first_step_loss=dict(trainer=losses[0], bare=bare_loss,
                              equal="bit for bit" if losses[0] == bare_loss else
                              f"within {abs(losses[0] - bare_loss):.3g}"))
    check(abs(losses[0] - bare_loss) <= FIRST_LOSS_ATOL,
          f"caption trainer: first-step loss {losses[0]} against the bare step's {bare_loss}")
    check("bleu4" not in summary["val_metrics"], "caption trainer: validation generated")
    return counts


def phase_task_heads(gpu: str) -> dict:
    """Phase 15: (a) caption serving, (b) card vs CPU with planted faults,
    (c) the bare steps, (d) the caption trainer. Returns the launches of (a),
    (c) and (d) by kernel."""
    t0 = time.perf_counter()
    totals = caption_serving(gpu)
    task_card_vs_cpu()
    bare, summaries = task_bare_steps(gpu)
    trainer_counts = caption_trainer(gpu, summaries["caption"]["step_p50_ms"])
    for part in (bare, trainer_counts):
        for k, n in part.items():
            totals[k] += n
    emit(phase="task_heads", part="summary", seconds=time.perf_counter() - t0, launches=totals)
    return totals


# ----------------------------------------------------------------- phase 16
ROI_CONFIG = "projects/base_vtp/configs/roi_pretrain.yml"
ROI_BATCH = 128  # the config's batch: the bare step's
ROI_REGIONS, ROI_FEATURE_DIM, ROI_CLASSES, ROI_OCR_LEN = 10, 2048, 13, 64
ROI_DOCS = 128  # the trainer's synthetic documents: 4 batches of RV_BATCH an epoch
ROI_TERMS = ("itm_loss", "masked_lm_loss", "masked_region_classification")
# a ROI train step or eval forward: 12 BERT layers at L=30 and the 2 cross
# layers at 30 + 10 + 64 = 104 keys on K1; no ViT (``with_grid_stream``
# false), no flash kernel
ROI_LAUNCHES = {**NO_LAUNCHES, "small_attention": 14}
ROI_TABLES = ("region_encoder.proj.weight", "region_encoder.spatial_proj.weight",
              "ocr_layout_embeddings.x_embed.weight", "ocr_layout_embeddings.y_embed.weight",
              "ocr_layout_embeddings.w_embed.weight", "ocr_layout_embeddings.h_embed.weight")
ATTENTIVE_OPTS = ["model_attributes.univl_pretrain.attentive_masking", "true"]
ATTENTIVE_N_MASK = max(1, int(TEXT_LEN * 0.15))  # the config's ratio at L=30
# card bf16 vs CPU fp32, the first ROI step at B=4 on the same fp32 masters
# with the region dropout off (the two devices' generators draw other
# masks): each loss term's |Δ|, the cosine of all gradients together, the
# least per-parameter cosine and the region and layout tables' cosines
# (``--calibrate roi`` reads them). Sound runs over three seeds stay below
# |Δ| 0.0027 (itm), 0.0073 (mlm), 0.0034 (mrc) and above cos 0.99975 (all),
# 0.9657 (least), 0.99978 (tables); the layout embeddings dropped read cos
# 0 (all, layout tables) and |Δmlm| 0.28; the streams OCR-first |Δmrc|
# 0.028 and table cos 0.24; the KL reversed |Δmrc| 0.128, cos 0.982 and
# table cos 0.873 (H100 readings)
ROI_DLOSS_MAX = {"itm_loss": 0.01, "masked_lm_loss": 0.015,
                 "masked_region_classification": 0.01}
ROI_COS_ALL, ROI_COS_MIN, ROI_TABLE_COS = 0.999, 0.9, 0.999


def roi_batch(B: int, seed: int) -> dict:
    """A ``univl_roi`` batch at the config's widths: captions of 5..30
    tokens ([CLS] … [SEP]) with about 15 % of the words masked for MLM,
    1..10 live regions of 2048 features with 5-wide boxes (xyxy, area) and
    13-class distributions, about 15 % of them MRC targets, 0..64 OCR
    tokens with LayoutLM boxes, ITM labels."""
    rng = np.random.default_rng(seed)
    rows = np.arange(B)
    lens = rng.integers(5, TEXT_LEN + 1, B)
    mask = (np.arange(TEXT_LEN)[None] < lens[:, None]).astype(np.int64)
    raw = rng.integers(1000, 30000, (B, TEXT_LEN))
    raw[:, 0], raw[rows, lens - 1] = 101, 102
    raw *= mask
    pick = (rng.random((B, TEXT_LEN)) < 0.15) & (mask > 0) & (raw != 101) & (raw != 102)
    regions = (np.arange(ROI_REGIONS)[None] < rng.integers(1, ROI_REGIONS + 1, B)[:, None])
    xy = rng.uniform(0, 0.6, (B, ROI_REGIONS, 2))
    x1y1 = xy + rng.uniform(0.05, 0.4, (B, ROI_REGIONS, 2))
    boxes = np.concatenate([xy, x1y1, np.prod(x1y1 - xy, -1, keepdims=True)], -1)
    to_predict = (rng.random((B, ROI_REGIONS)) < 0.15) & regions
    to_predict[0, 0] = True
    ocr = (np.arange(ROI_OCR_LEN)[None] < rng.integers(0, ROI_OCR_LEN + 1, B)[:, None])
    corner = rng.integers(0, 900, (B, ROI_OCR_LEN, 2))
    return {"caption_input_ids": np.where(pick, 103, raw), "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, TEXT_LEN), np.int64),
            "caption_lm_label_ids": np.where(pick, raw, -1), "caption_raw_input_ids": raw,
            "region_feature": (rng.standard_normal((B, ROI_REGIONS, ROI_FEATURE_DIM))
                               * regions[..., None]).astype(np.float32),
            "region_boxes": (boxes * regions[..., None]).astype(np.float32),
            "region_mask": regions.astype(np.int64),
            "region_to_predict": to_predict.astype(np.int64),
            "region_cls_dis": rng.dirichlet(np.ones(ROI_CLASSES),
                                            (B, ROI_REGIONS)).astype(np.float32),
            "ocr_input_ids": rng.integers(1000, 30000, (B, ROI_OCR_LEN)) * ocr,
            "ocr_input_mask": ocr.astype(np.int64),
            "ocr_bboxes": np.concatenate([corner, corner + rng.integers(0, 100, corner.shape)],
                                         -1) * ocr[..., None],
            "itm_labels": rng.integers(0, 2, B)}


def roi_first_step(shell, batch):
    """The first ROI step's loss terms and fp32 gradients by name, the
    region dropout off (as in evaluation: the two devices draw other masks)."""
    for p in shell.module.parameters():
        p.grad = None
    loss, (_, scalars) = shell.loss_fn(batch, deterministic=True)
    loss.backward()
    terms = {k.split("/", 1)[1]: float(v) for k, v in scalars.items() if k.startswith("losses/")}
    return terms, {n: p.grad.float().cpu() for n, p in shell.module.named_parameters()
                   if p.grad is not None}


def compare_roi(card, cpu) -> dict:
    """``compare_steps`` on the total, each loss term's |Δ| and the region
    and layout tables' gradient cosines (0 for a table the card's step did
    not reach)."""
    (t_card, g_card), (t_cpu, g_cpu) = card, cpu
    res = compare_steps((sum(t_card.values()), g_card), (sum(t_cpu.values()), g_cpu))
    res["abs_dloss_terms"] = {k: abs(t_card[k] - t_cpu[k]) for k in t_cpu}
    res["loss_terms_cpu"] = t_cpu
    res["tables_cos"] = {n: torch.nn.functional.cosine_similarity(
        g_card[n].double().reshape(-1), g_cpu[n].double().reshape(-1), dim=0).item()
        if n in g_card else 0.0 for n in ROI_TABLES}
    return res


def roi_within_bound(res) -> bool:
    return res["grad_cos_all"] >= ROI_COS_ALL and res["grad_cos_min"] >= ROI_COS_MIN \
        and all(c >= ROI_TABLE_COS for c in res["tables_cos"].values()) \
        and all(res["abs_dloss_terms"][k] <= ROI_DLOSS_MAX[k] for k in ROI_TERMS)


def roi_twins(seed: int):
    """``roi_pretrain.yml``'s model on the CPU in fp32 (plain versions) and
    on the card in bf16 on the same fp32 masters, and a B=4 batch."""
    cpu, cpu_state, _ = config_model(ROI_CONFIG, device="cpu", dtype="float32", seed=seed)
    card, _, _ = config_model(ROI_CONFIG, masters=cpu_state.params)
    return card, cpu, roi_batch(4, SEED + 11)


def reversed_kl(head):
    """``MRCHead.loss_metric`` with KL(softmax ‖ p) in place of KL(p ‖ softmax)."""
    real = type(head).loss_metric

    def loss_metric(logits, region_to_predict, region_cls_dis):
        out = real(head, logits, region_to_predict, region_cls_dis)
        logq = torch.log_softmax(logits.float(), dim=-1)
        kl = logq.exp() * (logq - torch.log(region_cls_dis.float().clamp(min=1e-12)))
        mask = region_to_predict == 1
        out["losses"][head.loss_name] = torch.where(
            mask[..., None], kl, torch.zeros_like(kl)).sum() / mask.sum().clamp(min=1)
        return out

    return loss_metric


def roi_faults(card):
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo)."""
    module = card.module
    real_stream = type(module).visual_stream
    ocr_keys = ("ocr_input_ids", "ocr_input_mask", "ocr_bboxes")

    def ocr_first(batch, deterministic, generator):  # MRC then reads OCR states
        regions = real_stream(module, {k: v for k, v in batch.items() if k not in ocr_keys},
                              deterministic, generator)
        ocr = real_stream(module, {k: v for k, v in batch.items()
                                   if not k.startswith("region_")}, deterministic, generator)
        return torch.cat([ocr[0], regions[0]], 1), torch.cat([ocr[1], regions[1]], 1)

    def undo(obj, name):
        return lambda: obj.__dict__.pop(name)

    return [("layout_embeddings_dropped", lambda: setattr(module, "ocr_layout", False),
             lambda: setattr(module, "ocr_layout", True)),
            ("streams_concatenated_ocr_first", lambda: setattr(module, "visual_stream",
                                                               ocr_first),
             undo(module, "visual_stream")),
            ("mrc_kl_reversed", lambda: setattr(module.mrc_head, "loss_metric",
                                                reversed_kl(module.mrc_head)),
             undo(module.mrc_head, "loss_metric"))]


def roi_readings(card, batch, ref) -> dict:
    """The sound reading and each planted fault's on one pair of twins."""
    out = {"sound": compare_roi(roi_first_step(card, batch), ref)}
    for name, plant, undo in roi_faults(card):
        plant()
        try:
            out[name] = compare_roi(roi_first_step(card, batch), ref)
        finally:
            undo()
    return out


def calibrate_roi(seeds=3) -> None:
    """Phase 16 (a)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        card, cpu, batch = roi_twins(seed)
        ref = roi_first_step(cpu, batch)
        readings = (roi_readings(card, batch, ref) if seed == seeds - 1 else
                    {"sound": compare_roi(roi_first_step(card, batch), ref)})
        for name, res in readings.items():
            emit(phase="calibrate_roi", kind="sound" if name == "sound" else "fault",
                 fault=None if name == "sound" else name, seed=seed, **res,
                 within_bound=roi_within_bound(res))
        del card, cpu
    emit(phase="calibrate_roi", kind="bound", dloss_max=ROI_DLOSS_MAX, grad_cos_all=ROI_COS_ALL,
         grad_cos_min=ROI_COS_MIN, tables_cos=ROI_TABLE_COS)


def roi_card_vs_cpu() -> None:
    """Phase 16 (a): the reading at seed 0 within the bounds, each planted
    fault outside them."""
    card, cpu, batch = roi_twins(SEED)
    readings = roi_readings(card, batch, roi_first_step(cpu, batch))
    caught = {n: not roi_within_bound(r) for n, r in readings.items() if n != "sound"}
    emit(phase="roi", part="card_vs_cpu", batch=4, **readings["sound"],
         faults={n: r for n, r in readings.items() if n != "sound"}, faults_caught=caught,
         bounds=dict(dloss_max=ROI_DLOSS_MAX, grad_cos_all=ROI_COS_ALL, grad_cos_min=ROI_COS_MIN,
                     tables_cos=ROI_TABLE_COS))
    check(roi_within_bound(readings["sound"]), "card and CPU ROI steps disagree beyond the "
          "stated bound")
    check(all(caught.values()), f"ROI: a planted fault passed the bound: {caught}")
    del card, cpu
    torch.cuda.empty_cache()


def roi_bare(gpu: str) -> dict:
    """Phase 16 (b): the bare ``univl_roi`` step at the config's B=128 and
    width, one repeated batch, the region dropout on."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shell, state, step = config_model(ROI_CONFIG)
    batch = shell.to_device(roi_batch(ROI_BATCH, SEED + 12))
    setup_s = time.perf_counter() - t0
    check(not hasattr(shell.module.base, "img_encoder"), "ROI without its grid stream built a ViT")
    _, res = bare_steps("roi_bare_step", gpu, shell, state, step, batch, ROI_LAUNCHES,
                        dict(config=ROI_CONFIG, cross_len=TEXT_LEN + ROI_REGIONS + ROI_OCR_LEN,
                             setup_s=setup_s,
                             params=sum(p.numel() for p in shell.module.parameters())),
                        phase="roi")
    check(all(f"losses/{k}" in res["loss_terms"][0] for k in ROI_TERMS),
          f"ROI bare step: loss terms {sorted(res['loss_terms'][0])}")
    del shell, state, step, batch
    torch.cuda.empty_cache()
    return res


def write_roi_layout(root: str, seed: int) -> int:
    """Seeded synthetic documents in ``roi_pretrain.yml``'s layout:
    ``features/doc{i}.npz`` (4..14 detector regions of 2048 features, so
    that some are padded and some cut to 10, absolute boxes on a 800×1000
    page, 13-class ``cls_prob``) and ``annotations/{train,val}.jsonl``
    (a caption of 10 words and 0..12 OCR lines of 1..8 words with line
    boxes, 8 on every line of a 12-line document, so a document's OCR
    tokens span 0 to past 64). Returns the
    features' bytes."""
    rng = np.random.default_rng(seed)
    with open(VOCAB, encoding="utf-8") as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    os.makedirs(os.path.join(root, "features"))
    os.makedirs(os.path.join(root, "annotations"))
    rows, size = [], 0
    for i in range(ROI_DOCS):
        m = 4 + i % 11
        corner = rng.uniform(0, 600, (m, 2))
        path = os.path.join(root, "features", f"doc{i}.npz")
        np.savez(path, features=rng.standard_normal((m, ROI_FEATURE_DIM)).astype(np.float32),
                 bbox=np.concatenate([corner, corner + rng.uniform(20, 200, (m, 2))], 1
                                     ).astype(np.float32),
                 cls_prob=rng.dirichlet(np.ones(ROI_CLASSES), m).astype(np.float32),
                 image_height=np.float32(1000), image_width=np.float32(800))
        size += os.path.getsize(path)
        per_line = 8 if i % 13 == 12 else None  # 12 lines of 8 words: past 64 tokens
        lines = [" ".join(rng.choice(words, per_line or rng.integers(1, 9)))
                 for _ in range(i % 13)]
        boxes = [[float(x), float(y), float(x + rng.uniform(50, 300)), float(y + 20)]
                 for x, y in rng.uniform(0, 700, (len(lines), 2))]
        rows.append(json.dumps({"caption": " ".join(rng.choice(words, 10)),
                                "feature": f"doc{i}.npz", "ocr_text": lines, "ocr_box": boxes,
                                "image_height": 1000, "image_width": 800, "id": i}))
    for split in ("train", "val"):
        with open(os.path.join(root, "annotations", f"{split}.jsonl"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return size


def roi_argv(root: str, config: str, *extra: str) -> list:
    """``roi_pretrain.yml`` over ``write_roi_layout``'s documents at B=32:
    one full validation at the end, every generator seeded."""
    data = "task_attributes.univl_task.dataset_attributes.roi_dataset"
    tp = "training_parameters"
    return ["--config", config, f"{data}.data_root_dir", root, f"{data}.seed", "0",
            f"{data}.region.seed", "0", f"{data}.text.seed", "0",
            f"{tp}.batch_size", str(RV_BATCH), f"{tp}.test_batch_size", str(RV_BATCH),
            f"{tp}.log_interval", "2", f"{tp}.snapshot_interval", "1000",
            f"{tp}.max_ckpt_num", "1", f"{tp}.num_workers", "4", f"{tp}.run_type", "train",
            f"{tp}.save_dir", os.path.join(root, "save"), f"{tp}.seed", "1", *extra]


def roi_trainer(gpu: str, bare_p50_ms: float) -> dict:
    """Phase 16 (c): ``antmmf_torch.run.main`` on ``roi_pretrain.yml`` over
    ``write_roi_layout``'s documents (under ``build/``, deleted at the end):
    6 steps at B=32 with the region dropout on, the final validation, a
    resume to 8 bit for bit; the first loss against the bare step on the
    trainer's first batch, masters and generator."""
    counts, probe, info, summary = rv_trainer(gpu, "roi_trainer", ROI_CONFIG, ROI_LAUNCHES,
                                              ROI_LAUNCHES, write=write_roi_layout,
                                              argv=roi_argv)
    masters, first_batch = probe.first
    shell, state, step = config_model(ROI_CONFIG, masters=masters)
    state.generator.manual_seed(1)  # the trainer's seed: the same dropout masks
    _, bare = step(state, first_batch)
    bare_loss = float(bare["total_loss"])
    first_terms = {k: float(v) for k, v in probe.terms[0].items()}
    probe.first = None
    del shell, state, step, masters, first_batch, bare
    torch.cuda.empty_cache()
    losses, val = summary["losses"], summary["val_metrics"]
    emit(phase="roi", part="trainer", config=ROI_CONFIG, batch=RV_BATCH, docs=ROI_DOCS,
         gpu=gpu, **summary, bare_step_p50_ms_b128=bare_p50_ms, loss_terms_first_step=first_terms,
         first_step_loss=dict(trainer=losses[0], bare=bare_loss,
                              equal="bit for bit" if losses[0] == bare_loss else
                              f"within {abs(losses[0] - bare_loss):.3g}"))
    check(abs(losses[0] - bare_loss) <= FIRST_LOSS_ATOL,
          f"ROI trainer: first-step loss {losses[0]} against the bare step's {bare_loss}")
    check(all(f"losses/{k}" in first_terms for k in ROI_TERMS)
          and first_terms["losses/masked_lm_loss"] > 0
          and first_terms["losses/masked_region_classification"] > 0,
          f"ROI trainer: first-step terms {first_terms}")
    check(val["losses/masked_lm_loss"] == 0.0 and val["losses/masked_region_classification"] == 0.0,
          f"ROI trainer: MLM and MRC targets in validation: {val}")
    return counts


def attentive_bare(gpu: str) -> dict:
    """Phase 16 (d): ``univl_pretrain.yml`` with ``attentive_masking`` for
    the bare step at B=128 on one repeated masked batch: both branches of
    the coin over the steps (up to 8 more steps until both showed), the
    attentive branch masking ``ATTENTIVE_N_MASK`` positions of every row
    with as many live words and never a special token, the processor's ids
    and labels on the other; the importance pass timed alone."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shell, state, step = config_model(PRETRAIN_CONFIG, ATTENTIVE_OPTS)
    module = shell.module
    batch = shell.to_device(pretrain_batch(PRETRAIN_BATCH, SEED + 13))
    coins, masked = [], []
    real_draws, real_mask = module.attentive_draws, module.attentive_mask

    def draws(*args):
        uniform, coin = real_draws(*args)
        coins.append(coin)
        return uniform, coin

    def attentive_mask(*args):
        ids, labels = real_mask(*args)
        masked.append((ids, labels))
        return ids, labels

    module.attentive_draws, module.attentive_mask = draws, attentive_mask
    state, res = bare_steps("attentive_bare_step", gpu, shell, state, step, batch,
                            PRETRAIN_STEP_LAUNCHES, dict(config=PRETRAIN_CONFIG,
                                                         opts=ATTENTIVE_OPTS), phase="roi")
    totals = res["totals"]
    for _ in range(8):
        if len({bool(c) for c in coins}) == 2:
            break
        zero_counts()
        state, _ = step(state, batch)
        for k, n in read_counts().items():
            totals[k] += n
    raw, mask = batch["caption_raw_input_ids"], batch["caption_input_mask"]
    special = (raw == 101) | (raw == 102) | (raw == 0)
    live = ((mask > 0) & ~special).sum(1).clamp(max=ATTENTIVE_N_MASK)
    branches = {"attentive": 0, "processor": 0}
    for coin, (ids, labels) in zip(coins, masked):
        chosen = labels >= 0
        if bool(coin):
            branches["attentive"] += 1
            check(torch.equal(chosen.sum(1), live) and not (chosen & special).any()
                  and bool((ids[chosen] == 103).all())
                  and torch.equal(ids[~chosen], raw[~chosen]),
                  "attentive masking: a row without its n_mask positions, or a special token")
        else:
            branches["processor"] += 1
            check(torch.equal(ids, batch["caption_input_ids"])
                  and torch.equal(labels, batch["caption_lm_label_ids"]),
                  "attentive masking: the processor's branch changed the ids")
    module.attentive_draws, module.attentive_mask = real_draws, real_mask
    seg = batch["caption_segment_ids"]
    with torch.no_grad():
        importance_ms = cuda_ms(lambda: module.base.text_encoder.word_importance(raw, mask, seg),
                                iters=20)
    emit(phase="roi", part="attentive_masking", batch=PRETRAIN_BATCH, gpu=gpu, branches=branches,
         n_mask=ATTENTIVE_N_MASK, importance_pass_ms=importance_ms,
         step_p50_ms=res["step_p50_ms"])
    check(min(branches.values()) > 0, f"attentive masking: one branch only {branches}")
    del shell, state, step, batch, masked, module
    torch.cuda.empty_cache()
    return totals


def phase_roi(gpu: str) -> dict:
    """Phase 16: (a) card vs CPU with planted faults, (b) the bare ROI step,
    (c) the ROI trainer, (d) attentive masking. Returns the launches of (b),
    (c) and (d) by kernel."""
    t0 = time.perf_counter()
    roi_card_vs_cpu()
    bare = roi_bare(gpu)
    totals = dict(bare["totals"])
    for part in (roi_trainer(gpu, bare["step_p50_ms"]), attentive_bare(gpu)):
        for k, n in part.items():
            totals[k] += n
    emit(phase="roi", part="summary", seconds=time.perf_counter() - t0, launches=totals)
    return totals


# ----------------------------------------------------------------- phase 17
PINK_TRAIN_CONFIG = "projects/pink/configs/pink_instruct.local.yml"
PINK_7B_CONFIG = "projects/pink/configs/pink_7b.yml"  # its frozen_params list
PINK_DATA = "task_attributes.pink_task.dataset_attributes.pink_instruct"
PINK_ROWS = {"vqa": 128, "grounding": 64, "caption": 64}  # the seeded corpus, by format
PINK_ACCUM, PINK_TRAIN_ITERS = 2, 6  # 3 optimizer updates
PINK_CALIB_LAYERS = 4  # card vs CPU: full width at 4 of the 22 decoder layers
PINK_RUN_LAYERS = 4  # run.main and its resume: full width at 4 of the 22 decoder layers


def pink_iter_launches(layers: int) -> dict:
    """A trainer iteration (micro-batch): the frozen ViT's 11 layers forward
    on K1, the causal decoder layers on the flash forward and backward."""
    return {**NO_LAUNCHES, "small_attention": PINK_VIT_LAYERS, "flash_fwd": layers,
            "flash_dq": layers, "flash_dkv": layers}


PINK_UPDATE_LAUNCHES = {k: n * PINK_ACCUM for k, n in pink_iter_launches(PINK_LAYERS).items()}
PINK_RUN_ITER_LAUNCHES = pink_iter_launches(PINK_RUN_LAYERS)
# an eval forward runs no backward kernel
PINK_RUN_EVAL_LAUNCHES = {**PINK_RUN_ITER_LAUNCHES, "flash_dq": 0, "flash_dkv": 0}
# card bf16 vs CPU fp32, the first micro-step at B=2 on the same fp32
# masters (every lora_b drawn nonzero, so that every trainable gradient is
# live): |Δ lm_loss| and the gradient cosines of the 22 trainable tensors
# (``--calibrate pink_train`` reads them). Sound runs over three seeds stay
# below |Δ| 0.0048 and above cos 0.99978 (all), 0.99954 (least); labels not
# shifted read |Δ| 0.048–0.099, cos 0.65–0.68 (all), 0.02–0.06 (least); the
# frozen q/v outputs detached |Δ| 0.0015–0.0025 but cos 0.28–0.32 (all);
# causal dropped |Δ| 0.069–0.215, cos 0.79–0.82 (all) (H100 readings)
PINK_TRAIN_DLOSS_MAX, PINK_TRAIN_COS_ALL, PINK_TRAIN_COS_MIN = 0.02, 0.999, 0.99


def pink_frozen_params() -> list:
    return list(build_config(PINK_7B_CONFIG)["optimizer_attributes"]["frozen_params"])


def pink_train_opts(layers: str = "omni_1b") -> list:
    """The full-width overrides of ``pink_instruct.local.yml`` but its dtype:
    ``omni_1b`` (or a preset of fewer layers) behind ViT-B/32 at 224², the
    tokenizer's ids inside the preset's vocabulary, LoRA rank 16,
    ``pink_7b.yml``'s ``frozen_params``, B=8, accumulation 2, the clip on."""
    model, tp = "model_attributes.pink", "training_parameters"
    return [f"{model}.lm_preset", layers, f"{model}.vit_preset", "vit_base_patch32",
            f"{model}.image_size", str(SIZE), f"{model}.vocab_override", "0",
            f"{model}.lora_rank", "16",
            f"{PINK_DATA}.image.size", str(SIZE), f"{PINK_DATA}.image.resize", "256",
            f"{PINK_DATA}.conversation.max_length", str(PINK_TRAIN_TEXT),
            "optimizer_attributes.frozen_params", json.dumps(pink_frozen_params()),
            f"{tp}.batch_size", str(PINK_TRAIN_BATCH),
            f"{tp}.test_batch_size", str(PINK_TRAIN_BATCH),
            f"{tp}.gradient_accumulation_steps", str(PINK_ACCUM),
            f"{tp}.clip_gradients", "true"]


def write_pink_corpus(root: str, seed: int, images: bool) -> int:
    """Seeded rows in ``pink_instruct.local.yml``'s three sources under
    ``root`` (``vqa.jsonl``, ``grounding.jsonl``, ``caption.jsonl``): questions
    of 6..40 words, one- to three-word answers, referring expressions with
    boxes on their image's size, captions of 8..60 words; with ``images``,
    each row names one of the repository's three fixture images (copied to
    ``root/images``), else no image (the dataset then feeds black frames).
    Returns the rows written."""
    rng = np.random.default_rng(seed)
    with open(VOCAB, encoding="utf-8") as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    fixture = os.path.join("tests", "data", "pink", "images")
    os.makedirs(os.path.join(root, "images"))
    sizes = {}
    for name in sorted(os.listdir(fixture)):
        shutil.copy(os.path.join(fixture, name), os.path.join(root, "images", name))
        sizes[name] = (56, 40)
    names = sorted(sizes)

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi + 1))))

    n = 0
    for fmt, count in PINK_ROWS.items():
        rows = []
        for i in range(count):
            row = {"image": names[i % len(names)]} if images else {}
            if fmt == "vqa":
                row.update(question=text(6, 40) + "?", answer=text(1, 3))
            elif fmt == "grounding":
                w, h = 56, 40
                x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
                row.update(expr=text(2, 8), width=w, height=h,
                           bbox=[float(x), float(y), float(x + rng.uniform(4, w / 2)),
                                 float(y + rng.uniform(4, h / 2))])
            else:
                row.update(caption=text(8, 60))
            rows.append(json.dumps(row))
        with open(os.path.join(root, f"{fmt}.jsonl"), "w") as f:
            f.write("\n".join(rows) + "\n")
        n += count
    return n


def pink_layers(layers: int) -> str:
    """The name of ``omni_1b`` at ``layers`` decoder layers (registered as a
    preset; ``omni_1b`` itself at its 22)."""
    from antmmf_torch.models import pink as pink_model

    if layers == PINK_LAYERS:
        return "omni_1b"
    preset = f"omni_1b_{layers}_layers"
    pink_model.LM_PRESETS[preset] = {**pink_model.LM_PRESETS["omni_1b"], "num_layers": layers}
    return preset


def pink_train_argv(root: str, *extra: str, layers: int = PINK_LAYERS) -> list:
    """The full-width run (at ``layers`` decoder layers) over
    ``write_pink_corpus``'s rows in bf16: the log (with the cached val batch)
    every 2 iterations, no snapshot before the end, no test inference."""
    tp = "training_parameters"
    return ["--config", PINK_TRAIN_CONFIG, *pink_train_opts(pink_layers(layers)),
            "model_attributes.pink.dtype_str",
            "bfloat16", f"{PINK_DATA}.data_root_dir", root,
            f"{tp}.max_iterations", str(PINK_TRAIN_ITERS), f"{tp}.log_interval", "2",
            f"{tp}.snapshot_interval", "1000", f"{tp}.run_type", "train",
            f"{tp}.num_workers", "4", f"{tp}.seed", "1", *INIT_ON_DEVICE,
            f"{tp}.save_dir", os.path.join(root, "save"), *extra]


def pink_train_batch(B: int, seed: int) -> dict:
    """A Pink training batch at the full-width shapes: an image [B, 1, 224,
    224, 3] of normalised noise, prompts of 40..256 wordpiece ids ([CLS]
    first), the last 4..30 live tokens of each the supervised answer."""
    rng = np.random.default_rng(seed)
    L = PINK_TRAIN_TEXT
    lens = rng.integers(40, L + 1, B)
    live = np.arange(L)[None] < lens[:, None]
    ids = rng.integers(1000, 30000, (B, L)) * live
    ids[:, 0] = 101
    answer = np.arange(L)[None] >= (lens - rng.integers(4, 31, B))[:, None]
    return {"input_ids": ids, "input_mask": live.astype(np.int64),
            "labels": np.where(live & answer, ids, -100),
            "image_data": rng.standard_normal((B, 1, SIZE, SIZE, 3)).astype(np.float32)}


def pink_first_step(shell, batch):
    """The first micro-step's LM loss and the trainable parameters' fp32
    gradients by name."""
    for p in shell.module.parameters():
        p.grad = None
    loss, _ = shell.loss_fn(batch, deterministic=False)
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in shell.module.named_parameters()
                         if p.grad is not None}


def pink_train_within_bound(res) -> bool:
    return res["abs_dloss"] <= PINK_TRAIN_DLOSS_MAX and res["grad_cos_all"] >= PINK_TRAIN_COS_ALL \
        and res["grad_cos_min"] >= PINK_TRAIN_COS_MIN


def pink_train_twins(seed: int):
    """Pink at full width with ``PINK_CALIB_LAYERS`` decoder layers, frozen
    as the trainer freezes it: fp32 on the CPU (plain versions) and bf16 on
    the card on the same fp32 masters, every ``lora_b`` drawn from N(0,
    0.02); a B=2 batch."""
    opts = pink_train_opts(pink_layers(PINK_CALIB_LAYERS))
    cpu, cpu_state, _ = config_model(PINK_TRAIN_CONFIG, opts, device="cpu", dtype="float32",
                                     seed=seed)
    gen = torch.Generator().manual_seed(seed)
    for name, t in cpu_state.params.items():
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=gen)
    cpu_state.sync_model(frozen=True)
    card, _, _ = config_model(PINK_TRAIN_CONFIG, opts, masters=cpu_state.params)
    return card, cpu, pink_train_batch(2, SEED + 17)


def pink_train_faults():
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo)."""
    from antmmf_torch.models import pink as pink_model
    from antmmf_torch.modules import llm

    real_loss, real_project, real_attention = (pink_model.lm_loss, llm.GQAttention._project,
                                               llm.flash_attention)

    def unshifted(logits, labels):  # position t scored against its own label
        valid = labels >= 0
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              torch.where(valid, labels, -100).reshape(-1).long(),
                              ignore_index=-100, reduction="sum")
        return nll / valid.sum().clamp(min=1)

    def detached(self, name, x):  # the round-5 PEFT bug: the frozen outputs cut off
        out = real_project(self, name, x)
        if name not in self.lora_targets:
            return out
        base = getattr(self, f"{name}_proj")(x)
        return out - base + base.detach()

    def non_causal(q, k, v, bias=None, scale=None, causal=False):
        return real_attention(q, k, v, bias=bias, scale=scale, causal=False)

    return [("labels_not_shifted", lambda: setattr(pink_model, "lm_loss", unshifted),
             lambda: setattr(pink_model, "lm_loss", real_loss)),
            ("frozen_qv_outputs_detached", lambda: setattr(llm.GQAttention, "_project", detached),
             lambda: setattr(llm.GQAttention, "_project", real_project)),
            ("causal_dropped", lambda: setattr(llm, "flash_attention", non_causal),
             lambda: setattr(llm, "flash_attention", real_attention))]


def pink_train_readings(card, batch, ref) -> dict:
    out = {"sound": compare_steps(pink_first_step(card, batch), ref)}
    for name, plant, undo in pink_train_faults():
        plant()
        try:
            out[name] = compare_steps(pink_first_step(card, batch), ref)
        finally:
            undo()
    return out


def calibrate_pink_train(seeds=3) -> None:
    """Phase 17 (a)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        card, cpu, batch = pink_train_twins(seed)
        ref = pink_first_step(cpu, batch)
        readings = (pink_train_readings(card, batch, ref) if seed == seeds - 1 else
                    {"sound": compare_steps(pink_first_step(card, batch), ref)})
        for name, res in readings.items():
            emit(phase="calibrate_pink_train", kind="sound" if name == "sound" else "fault",
                 fault=None if name == "sound" else name, seed=seed, **res,
                 within_bound=pink_train_within_bound(res))
        del card, cpu
    emit(phase="calibrate_pink_train", kind="bound", dloss_max=PINK_TRAIN_DLOSS_MAX,
         grad_cos_all=PINK_TRAIN_COS_ALL, grad_cos_min=PINK_TRAIN_COS_MIN)


def pink_train_card_vs_cpu() -> None:
    """Phase 17 (a): the reading at seed 0 within the bounds, each planted
    fault outside them."""
    t0 = time.perf_counter()
    card, cpu, batch = pink_train_twins(SEED)
    readings = pink_train_readings(card, batch, pink_first_step(cpu, batch))
    caught = {n: not pink_train_within_bound(r) for n, r in readings.items() if n != "sound"}
    emit(phase="pink_train", part="card_vs_cpu", batch=2, layers=PINK_CALIB_LAYERS,
         **readings["sound"], faults={n: r for n, r in readings.items() if n != "sound"},
         faults_caught=caught, seconds=time.perf_counter() - t0,
         bounds=dict(dloss_max=PINK_TRAIN_DLOSS_MAX, grad_cos_all=PINK_TRAIN_COS_ALL,
                     grad_cos_min=PINK_TRAIN_COS_MIN))
    check(pink_train_within_bound(readings["sound"]),
          "card and CPU Pink training steps disagree beyond the stated bound")
    check(all(caught.values()), f"Pink training: a planted fault passed the bound: {caught}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()


class SnapshotProbe:
    """Copies of the state at each save (step, masters, optimizer state with
    the accumulator, generator), to hold a restored snapshot against."""

    def __init__(self):
        self.saved = {}

    def install(self):
        real_save = Checkpoint.save

        def save(ck, state, iteration=None, tag=None):
            if tag is None:
                opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                       for k, v in state.opt_state.items()}
                generator = torch.Generator(device=state.generator.device)
                generator.set_state(state.generator.get_state())
                self.saved[int(iteration)] = types.SimpleNamespace(
                    step=state.step, params={n: t.clone() for n, t in state.params.items()},
                    opt_state=opt, generator=generator, momentum=None)
            return real_save(ck, state, iteration, tag)

        Checkpoint.save = save
        return lambda: setattr(Checkpoint, "save", real_save)


def pink_updates(step, state, batch, updates: int):
    """``updates`` optimizer updates (PINK_ACCUM micro-steps each) on one
    batch: per update the host ms (ending in ``synchronize``) and the
    launches; the micro-steps' ms."""
    update_ms, micro_ms, counts = [], [], []
    for _ in range(updates):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PINK_ACCUM):
            t1 = time.perf_counter()
            state, scalars = step(state, batch)
            torch.cuda.synchronize()
            micro_ms.append((time.perf_counter() - t1) * 1e3)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
    return state, update_ms, micro_ms, counts, float(scalars["total_loss"])


def loaded_trainer(argv):
    """A trainer on ``argv``'s config (``run.main``'s build and load, without
    its train loop)."""
    args = get_parser().parse_args(argv)
    trainer = build_trainer(build_config(args.config, args.config_override,
                                         [o for o in args.opts if o != "--"], args))
    trainer.load()
    return trainer


def pink_loaded(root: str, *extra: str, layers: int = PINK_LAYERS):
    """A trainer on ``pink_train_argv``'s config."""
    return loaded_trainer(pink_train_argv(root, *extra, layers=layers))


def pink_run_resume(probe, snaps, last: int, run_main, loaded, root: str, after_run=None):
    """Phases 17 and 18 (b): ``run_main(*opts)`` (``run.main`` on the
    composed argv) to ``last`` iterations, one micro-step into a window; a
    trainer ``loaded(*opts)`` from the snapshot at ``last`` (its state held
    against the one saved there by ``probe``); the next iteration on the
    first batch from the resumed state and from the run's own; the first
    batch's loss under the initial masters and the final ones.
    ``after_run(trainer)`` sees the run's trainer before the next iteration.
    Returns the readings."""
    zero_counts()
    t0 = time.perf_counter()
    first = run_main("training_parameters.max_iterations", str(last))
    r = types.SimpleNamespace(run_setup_s=first.timings["first_step_start"] - t0)
    if after_run is not None:
        after_run(first)
    first_step, state = probe.raw_train_step, first.state
    r.loader_wait_ms = [t * 1e3 for t in first.timings["loader_wait_s"]]
    r.iteration_ms = [t * 1e3 for t in first.timings["step_s"]]
    r.mid_window = (state.step, state.opt_state["mini_step"], state.opt_state["count"])
    masters0, batch = probe.first
    # the resume: the state saved at the last snapshot, then the next
    # iteration from it and from the first run's own state
    probe.reference = types.SimpleNamespace(state=snaps.saved[last])
    t1 = time.perf_counter()
    resumed = loaded("training_parameters.resume_file",
                     os.path.join(root, "save", "models", f"model_{last}"))
    r.resume_s = time.perf_counter() - t1
    probe.reference = None
    before = read_counts()
    state_r, sixth_scalars = probe.raw_train_step(resumed.state, batch)
    after = read_counts()
    state, _ = first_step(state, batch)
    r.sixth_loss = float(sixth_scalars["total_loss"])
    r.counts = read_counts()  # the main path ends here
    r.sixth = {k: after[k] - before[k] for k in after}
    r.continued = states_equal(state_r, state)
    # the first batch's loss under the initial masters and the final ones
    shell = first.shell
    with torch.inference_mode():
        r.loss_after = float(shell.loss_fn(batch, deterministic=True)[0])
    with torch.no_grad():
        for n, t in state.params.items():
            t.copy_(masters0[n])
    state.sync_model(frozen=True)
    with torch.inference_mode():
        r.loss_before = float(shell.loss_fn(batch, deterministic=True)[0])
    probe.first = None
    return r


def pink_timed_updates(trainer, warmup: int = 2, timed: int = 6, profiled: int = 2) -> dict:
    """The trainer's own step on its first batch: ``warmup`` updates, then
    ``timed`` (host ms ending in ``synchronize``, launches), then
    ``profiled`` under the profiler (device-busy ms, device ops and the flash
    family's ms an update); the peak memory since the caller's reset, the
    parameter counts and the optimizer state's bytes."""
    from torch.profiler import ProfilerActivity, profile

    step, state = trainer._train_step, trainer.state
    batch = trainer._to_device(trainer._cached_first_batch)
    out = dict(trainable_tensors=len(state.trainable),
               params=sum(t.numel() for t in state.params.values()),
               trainable_params=sum(state.params[n].numel() for n in state.trainable),
               optimizer_state_bytes=state.optimizer_state_bytes())
    state, _, _, _, _ = pink_updates(step, state, batch, warmup)
    state, out["update_ms"], out["micro_ms"], out["counts"], _ = pink_updates(step, state, batch,
                                                                             timed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _, _, _, _ = pink_updates(step, state, batch, profiled)
        torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["busy"], out["n_ops"], out["top"] = device_busy(prof, profiled)
    out["flash_ms"] = sum(ms for name, ms in device_ms_by_name(prof, profiled)[0].items()
                          if "flash_" in name)
    out["supervised"] = int((batch["labels"][:, 1:] >= 0).sum().item())
    trainer.state = state
    return out


def pink_trainer(gpu: str) -> dict:
    """Phase 17 (b)–(c). (b) ``antmmf_torch.run.main`` on
    ``pink_instruct.local.yml`` at full width with PINK_RUN_LAYERS of the 22
    decoder layers over the seeded corpus (under ``build/``, deleted at the
    end): 5 iterations at B=8 with accumulation 2, the final validation and
    the last snapshot at 5, one micro-step into the third window. A trainer
    resumed from that snapshot holds the state saved there bit for bit; the
    6th iteration on one batch, from the resumed state and from the first
    run's own, closes the window (3 updates) to the same state bit for bit;
    the first batch's loss falls. (c) The trainer at full width and depth,
    loaded as ``run.main`` loads it: timed and profiled updates of its step
    on its first batch. Returns the launches of (b)'s runs and 6th
    iterations."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="pink_smoke_", dir=build)
    try:
        import cv2  # noqa: F401
        images = True
    except ImportError:
        images = False
    probe, snaps = TrainerProbe(), SnapshotProbe()
    last = PINK_TRAIN_ITERS - 1
    try:
        rows = write_pink_corpus(root, SEED, images)
        uninstall, unsnap = probe.install(), snaps.install()
        try:
            r = pink_run_resume(
                probe, snaps, last,
                lambda *extra: run.main(pink_train_argv(root, *extra, layers=PINK_RUN_LAYERS)),
                lambda *extra: pink_loaded(root, *extra, layers=PINK_RUN_LAYERS), root)
        finally:
            unsnap()
            uninstall()
        gc.collect()
        torch.cuda.empty_cache()
        # (c) full width and depth: the trainer's own step on its first batch
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        trainer = pink_loaded(root)
        full_setup_s = time.perf_counter() - t1
        t = pink_timed_updates(trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (update_ms, micro_ms, bare_counts, busy, n_ops, top, flash_ms, supervised, peak_gb,
     n_params, n_trainable, trainable, opt_bytes) = (
        t[k] for k in ("update_ms", "micro_ms", "counts", "busy", "n_ops", "top", "flash_ms",
                       "supervised", "peak_gb", "params", "trainable_params",
                       "trainable_tensors", "optimizer_state_bytes"))
    positions = PINK_TRAIN_BATCH * (PINK_PATCHES + PINK_TRAIN_TEXT)
    losses = [float(x) for x in probe.losses] + [r.sixth_loss]
    upd_p50 = float(np.percentile(update_ms, 50))
    run1 = probe.train[:last]
    per_update = [{k: a[k] + b[k] for k in a} for a, b in zip(run1[0::2], run1[1::2])]
    run_update = {k: n * PINK_ACCUM for k, n in PINK_RUN_ITER_LAUNCHES.items()}
    evals = probe.eval
    summary = dict(
        config=PINK_TRAIN_CONFIG, gpu=gpu, rows=rows, images="fixture images (cv2)" if images
        else "none: black frames (no cv2)", batch=PINK_TRAIN_BATCH, accumulation=PINK_ACCUM,
        run_layers=PINK_RUN_LAYERS, timed_layers=PINK_LAYERS,
        losses=losses, first_batch_loss=dict(initial_masters=r.loss_before,
                                             final_masters=r.loss_after),
        update_p50_ms=upd_p50, update_p95_ms=float(np.percentile(update_ms, 95)),
        micro_batch_p50_ms=float(np.percentile(micro_ms, 50)),
        trainer_iteration_ms=r.iteration_ms,
        loader_wait_p50_ms=float(np.percentile(r.loader_wait_ms, 50)),
        tokens_per_s_all_positions=PINK_ACCUM * positions * 1e3 / upd_p50,
        tokens_per_s_supervised=PINK_ACCUM * supervised * 1e3 / upd_p50,
        device_busy_ms_per_update=busy if n_ops else "not measured",
        device_idle_share=1 - busy / upd_p50 if n_ops else "not measured",
        flash_device_ms_per_update=flash_ms if n_ops else "not measured",
        device_ops_per_update=n_ops, top_device_ops_ms=top, peak_mem_gb=peak_gb,
        params=n_params, trainable_params=n_trainable, trainable_tensors=trainable,
        optimizer_state_bytes=opt_bytes, launches=r.counts, launches_per_update=per_update[0],
        launches_per_timed_update=bare_counts[0], launches_sixth_iteration=r.sixth,
        train_iterations=len(probe.train), eval_forwards=len(evals),
        snapshot_at=dict(zip(("step", "mini_step", "count"), r.mid_window)),
        resumed_state_equal=probe.resumed_equal, continued_state_equal=r.continued,
        run_setup_s=r.run_setup_s, full_width_setup_s=full_setup_s, resume_s=r.resume_s,
        restore_s=probe.restores, saves_s_bytes=probe.saves)
    emit(phase="pink_train", part="trainer", **summary)
    check(all(np.isfinite(losses)) and len(losses) == PINK_TRAIN_ITERS,
          f"Pink trainer: losses {losses}")
    check(r.loss_after < r.loss_before,
          f"Pink trainer: the first batch's loss did not fall ({r.loss_before} → {r.loss_after})")
    check(all(c == PINK_RUN_ITER_LAUNCHES for c in probe.train)
          and all(c == PINK_RUN_EVAL_LAUNCHES for c in evals)
          and all(c == run_update for c in per_update)
          and all(c == PINK_UPDATE_LAUNCHES for c in bare_counts),
          f"Pink trainer: launches per iteration {probe.train[:1]}, per update "
          f"{per_update[:1]}, per eval forward {evals[:1]}, per full-depth update "
          f"{bare_counts[:1]}; expected {PINK_RUN_ITER_LAUNCHES}, {run_update}, "
          f"{PINK_RUN_EVAL_LAUNCHES}, {PINK_UPDATE_LAUNCHES}")
    check(r.sixth == PINK_RUN_ITER_LAUNCHES and all(
        r.counts[k] == PINK_RUN_ITER_LAUNCHES[k] * (len(probe.train) + 2)  # the 6th, twice
        + PINK_RUN_EVAL_LAUNCHES[k] * len(evals) for k in r.counts),
          f"Pink trainer: the phase launched {r.counts}")
    check(r.mid_window == (last, 1, last // PINK_ACCUM),
          f"Pink trainer: the snapshot is not inside a window: {r.mid_window}")
    check(probe.resumed_equal is not None and all(probe.resumed_equal.values())
          and "acc" in probe.resumed_equal, f"Pink trainer: resume {probe.resumed_equal}")
    check(all(r.continued.values()), f"Pink trainer: the resumed 6th iteration {r.continued}")
    check(opt_bytes == 12 * n_trainable and n_trainable < 0.01 * n_params,
          f"Pink trainer: optimizer state {opt_bytes} bytes for {n_trainable} trainable of "
          f"{n_params} parameters")
    check(probe.devices == {"cuda"}, f"Pink trainer: ran on {probe.devices}")
    return r.counts


def phase_pink_train(gpu: str) -> dict:
    """Phase 17: (a) card vs CPU with planted faults, (b)–(c) the trainer.
    Returns the launches of (b)."""
    t0 = time.perf_counter()
    pink_train_card_vs_cpu()
    counts = pink_trainer(gpu)
    emit(phase="pink_train", part="summary", seconds=time.perf_counter() - t0, launches=counts)
    return counts


# ------------------------------------------------ phase 18: pink_7b.yml
PINK_7B_LAYERS, PINK_7B_EVA_LAYERS = 32, 39
PINK_7B_TOKENS = PINK_7B_HEADS[2]  # 256 EVA tokens, the class token dropped
# card vs CPU: full width at 2 of the 32 decoder layers and 2 of the 39 EVA
# layers (its planted faults include the bridge's layers reversed); run.main,
# its resume and serving (since PR 17): at 1 and 1 (a snapshot of ≈ 5.9 GB
# of fp32 masters instead of ≈ 32)
PINK_7B_CUT, PINK_7B_RUN_CUT = (2, 2), (1, 1)
PINK_7B_REMAT_LAYERS = (8, 16)  # remat on against off at depths where off still fits
PINK_7B_NEW_TOKENS = 8


def pink_7b_iter_launches(layers: int) -> dict:
    """A trainer iteration (micro-batch) under remat: the frozen EVA tower on
    the einsum core (heads of 88), each causal decoder layer's flash forward
    twice (the forward, then its recompute in the backward), dQ and dK/dV
    once."""
    return {**NO_LAUNCHES, "flash_fwd": 2 * layers, "flash_dq": layers, "flash_dkv": layers}


PINK_7B_UPDATE_LAUNCHES = {k: n * PINK_ACCUM
                           for k, n in pink_7b_iter_launches(PINK_7B_LAYERS).items()}
PINK_7B_RUN_ITER_LAUNCHES = pink_7b_iter_launches(PINK_7B_RUN_CUT[0])
# an eval forward (no gradients, no recompute) and a served request's prefill
PINK_7B_FORWARD_LAUNCHES = {**NO_LAUNCHES, "flash_fwd": PINK_7B_RUN_CUT[0]}
# card bf16 vs CPU fp32 at full width and PINK_7B_CUT depth, the first
# micro-step at B=1 on the same fp32 masters carried through the stacked
# layout (every lora_b drawn nonzero): |Δ lm_loss| and the gradient cosines of
# the 14 trainable tensors; and the EVA tower alone in fp32 on the card
# against the CPU's, the largest |Δ| over the largest |token value|, where a
# change below bf16's rounding shows (``--calibrate pink_7b`` reads them).
# Sound runs over three seeds stay below |Δ| 0.00099 and above cos 0.99994
# (all), 0.99972 (least), with the EVA reading below 2.2e-6; EVA's GELU in
# its tanh form reads |Δ| 0.0004–0.0006 and cos 0.99994 (below bf16's
# rounding) but the EVA reading 1.31e-4–1.40e-4; the class token kept in
# front of vision_proj |Δ| 0.0088–0.0142, cos 0.99927 (all), 0.9960–0.9962
# (least); the bridge's layers reversed |Δ| 0.34–0.45, cos 0.12–0.17
# (H100 readings)
PINK_7B_DLOSS_MAX, PINK_7B_COS_ALL, PINK_7B_COS_MIN = 0.004, 0.9998, 0.999
PINK_7B_EVA_DEV_MAX = 2e-5


def pink_7b_presets(layers: int, eva_layers: int):
    """The names of ``omni_7b`` at ``layers`` decoder layers and of
    ``eva_vit_g`` at ``eva_layers`` (registered as presets; the full ones by
    their own names)."""
    lm, eva = "omni_7b", "eva_vit_g"
    if layers != PINK_7B_LAYERS:
        lm = f"omni_7b_{layers}_layers"
        LM_PRESETS[lm] = {**LM_PRESETS["omni_7b"], "num_layers": layers}
    if eva_layers != PINK_7B_EVA_LAYERS:
        eva = f"eva_vit_g_{eva_layers}_layers"
        EVA_PRESETS[eva] = {**EVA_PRESETS["eva_vit_g"], "num_layers": eva_layers}
    return lm, eva


def pink_7b_opts(layers: int = PINK_7B_LAYERS, eva_layers: int = PINK_7B_EVA_LAYERS,
                 dtype: str = "bfloat16") -> list:
    """``pink_instruct.local.yml`` with ``pink_7b.yml``'s model and optimizer
    laid over (``recipe_opts``: omni_7b behind EVA-CLIP-g at 224², LoRA 16 on
    q/v over a frozen base, remat, scan_layers, its frozen_params), cut to
    ``layers`` and ``eva_layers``; the tokenizer's ids inside the preset's
    vocabulary, the data at 224² and 256 text tokens, B=8, accumulation 2,
    the clip on, the init drawn on the card."""
    tp = "training_parameters"
    lm, eva = pink_7b_presets(layers, eva_layers)
    return recipe_opts(lm_preset=lm, eva_preset=eva, dtype_str=dtype) + [
        "model_attributes.pink.vocab_override", "0",
        f"{PINK_DATA}.image.size", str(SIZE), f"{PINK_DATA}.image.resize", "256",
        f"{PINK_DATA}.conversation.max_length", str(PINK_TRAIN_TEXT),
        f"{tp}.batch_size", str(PINK_TRAIN_BATCH), f"{tp}.test_batch_size", str(PINK_TRAIN_BATCH),
        f"{tp}.gradient_accumulation_steps", str(PINK_ACCUM), f"{tp}.clip_gradients", "true",
        *INIT_ON_DEVICE]


def pink_7b_argv(root: str, *extra: str, layers: int = PINK_7B_LAYERS,
                 eva_layers: int = PINK_7B_EVA_LAYERS) -> list:
    """The composed run over ``write_pink_corpus``'s rows: the log (with the
    cached val batch) every 2 iterations, no snapshot before the end, no
    test inference."""
    tp = "training_parameters"
    return ["--config", PINK_TRAIN_CONFIG, *pink_7b_opts(layers, eva_layers),
            f"{PINK_DATA}.data_root_dir", root, f"{tp}.max_iterations", str(PINK_TRAIN_ITERS),
            f"{tp}.log_interval", "2", f"{tp}.snapshot_interval", "1000",
            f"{tp}.run_type", "train", f"{tp}.num_workers", "4", f"{tp}.seed", "1",
            f"{tp}.save_dir", os.path.join(root, "save"), *extra]


def load_masters(state, masters) -> None:
    """fp32 ``masters`` by name into the state, then the module."""
    with torch.no_grad():
        for n, t in state.params.items():
            t.copy_(masters[n])
    state.sync_model(frozen=True)


def pink_7b_twins(seed: int):
    """Phase 18 (a)'s models at full width and PINK_7B_CUT depth, frozen as
    the trainer freezes them: bf16 on the card, seeded on the card with every
    ``lora_b`` drawn from N(0, 0.02); its masters exported in the stacked
    layout and read back through the bridge into the card's state and an
    fp32 CPU twin (plain versions). Returns (card, card state, CPU, the
    stacked tree, the masters, a B=1 batch)."""
    layers, eva = PINK_7B_CUT
    card, state, _ = config_model(PINK_TRAIN_CONFIG, pink_7b_opts(layers, eva), seed=seed,
                                  on_device=True)
    gen = torch.Generator(device=next(iter(state.params.values())).device).manual_seed(seed)
    for name, t in state.params.items():
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=gen)
    stacked = export_flax_variables(card.module, state)["params"]
    masters = flax_to_masters(card.module, stacked)
    load_masters(state, masters)
    cpu, _, _ = config_model(PINK_TRAIN_CONFIG, pink_7b_opts(layers, eva, "float32"),
                             device="cpu", dtype="float32", masters=masters)
    card.eva32 = copy.deepcopy(cpu.module.vision_tower).to(state.params["lm_head.weight"].device)
    return card, state, cpu, stacked, masters, pink_train_batch(1, SEED + 23)


def eva_dev(card, cpu, batch) -> float:
    """The EVA tower in fp32 on the card (``card.eva32``) against the CPU
    twin's on the batch's image: the largest |Δ| over the largest |value|."""
    img = torch.as_tensor(batch["image_data"][:, 0])
    with torch.no_grad():
        ref = cpu.module.vision_tower(img)
        got = card.eva32(img.to(next(card.eva32.parameters()).device)).cpu()
    if got.shape != ref.shape:
        return float("inf")
    return ((got - ref).abs().max() / ref.abs().max()).item()


def pink_7b_compare(card, cpu, batch, ref) -> dict:
    return {**compare_steps(pink_first_step(card, batch), ref),
            "eva_fp32_dev": eva_dev(card, cpu, batch)}


def pink_7b_faults(card, state, stacked, masters):
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo). EVA's MLP with tanh GELU; the class token kept in
    front of ``vision_proj`` (257 vision tokens); the bridge reading the
    stacked layers in reverse order."""
    tower = card.module.vision_tower
    mlps = [getattr(t, f"layer_{i}").mlp for t in (tower, card.eva32)
            for i in range(tower.num_layers)]
    real_leading = weights._leading

    def tanh_gelu(on: bool):
        for mlp in mlps:
            mlp.act = (lambda x: F.gelu(x, approximate="tanh")) if on else F.gelu

    def keep_cls():
        real = type(tower).forward.__get__(tower)
        tower.forward = lambda images: (lambda seq: torch.cat([seq[:, :1], seq], 1))(
            real(images))

    def reversed_bridge():
        weights._leading = lambda leaf, i: real_leading(leaf, -1 - i)
        try:
            load_masters(state, flax_to_masters(card.module, stacked))
        finally:
            weights._leading = real_leading

    return [("eva_tanh_gelu", lambda: tanh_gelu(True), lambda: tanh_gelu(False)),
            ("eva_cls_not_dropped", keep_cls, lambda: tower.__dict__.pop("forward")),
            ("bridge_layers_reversed", reversed_bridge, lambda: load_masters(state, masters))]


def pink_7b_within_bound(res) -> bool:
    return res["abs_dloss"] <= PINK_7B_DLOSS_MAX and res["grad_cos_all"] >= PINK_7B_COS_ALL \
        and res["grad_cos_min"] >= PINK_7B_COS_MIN and res["eva_fp32_dev"] <= PINK_7B_EVA_DEV_MAX


def pink_7b_readings(seed: int, faults: bool):
    card, state, cpu, stacked, masters, batch = pink_7b_twins(seed)
    ref = pink_first_step(cpu, batch)
    out = {"sound": pink_7b_compare(card, cpu, batch, ref)}
    for name, plant, undo in (pink_7b_faults(card, state, stacked, masters) if faults else ()):
        plant()
        try:
            out[name] = pink_7b_compare(card, cpu, batch, ref)
        finally:
            undo()
    del card, state, cpu, stacked, masters
    gc.collect()
    torch.cuda.empty_cache()
    return out


def calibrate_pink_7b(seeds=3) -> None:
    """Phase 18 (a)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        for name, res in pink_7b_readings(seed, seed == seeds - 1).items():
            emit(phase="calibrate_pink_7b", kind="sound" if name == "sound" else "fault",
                 fault=None if name == "sound" else name, seed=seed, **res,
                 within_bound=pink_7b_within_bound(res))
    emit(phase="calibrate_pink_7b", kind="bound", dloss_max=PINK_7B_DLOSS_MAX,
         grad_cos_all=PINK_7B_COS_ALL, grad_cos_min=PINK_7B_COS_MIN,
         eva_fp32_dev_max=PINK_7B_EVA_DEV_MAX)


def pink_7b_card_vs_cpu() -> None:
    """Phase 18 (a): the reading at seed 0 within the bounds, each planted
    fault outside them."""
    t0 = time.perf_counter()
    readings = pink_7b_readings(SEED, True)
    faults = {n: r for n, r in readings.items() if n != "sound"}
    caught = {n: not pink_7b_within_bound(r) for n, r in faults.items()}
    emit(phase="pink_7b", part="card_vs_cpu", batch=1, layers=PINK_7B_CUT[0],
         eva_layers=PINK_7B_CUT[1], **readings["sound"], faults=faults, faults_caught=caught,
         seconds=time.perf_counter() - t0,
         bounds=dict(dloss_max=PINK_7B_DLOSS_MAX, grad_cos_all=PINK_7B_COS_ALL,
                     grad_cos_min=PINK_7B_COS_MIN, eva_fp32_dev_max=PINK_7B_EVA_DEV_MAX))
    check(pink_7b_within_bound(readings["sound"]),
          "card and CPU pink_7b training steps disagree beyond the stated bound")
    check(all(caught.values()), f"pink_7b: a planted fault passed the bound: {caught}")


def pink_7b_serving(save_dir: str, npz_dir: str) -> dict:
    """Phase 18 (e): ``generation_predictor`` on the card, given the run's
    ``save_dir`` (its ``pink_final``) and given a ``params.npz`` exported
    from the same masters in the stacked layout: one request each, greedy,
    the same tokens. Returns the readings and the launches."""
    request = pink_request(np.random.default_rng(SEED + 29))
    out, counts = {}, []
    for name, model_dir in (("save_dir", save_dir), ("params_npz", npz_dir)):
        t0 = time.perf_counter()
        pred = build_predictor(["--config", PINK_TRAIN_CONFIG, "--predictor",
                                "generation_predictor", "--model_dir", model_dir,
                                "predictor_parameters.max_new_tokens", str(PINK_7B_NEW_TOKENS),
                                "predictor_parameters.max_prompt_len", "64"])[0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        before = read_counts()
        t1 = time.perf_counter()
        answer = pred.predict(request)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t1) * 1e3
        after = read_counts()
        counts.append({k: after[k] - before[k] for k in after})
        out[name] = dict(load_s=load_s, request_ms=request_ms, ids=answer["generated_ids"],
                         text=answer["generated_text"],
                         device=next(pred.shell.module.parameters()).device.type)
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    return dict(readings=out, launches=counts)


def pink_7b_remat_peaks(trainer) -> dict:
    """Phase 18 (c): the peak memory of one update of the full-width trainer
    run through its first decoder layers (the rest skipped), at each depth
    of PINK_7B_REMAT_LAYERS, with remat on and off, beside the memory held
    before the update."""
    module = trainer.shell.module
    decoder, full = module.decoder, module.decoder.num_layers
    step, state = trainer._train_step, trainer.state
    batch = trainer._to_device(trainer._cached_first_batch)
    peaks = {}
    try:
        for layers in PINK_7B_REMAT_LAYERS:
            decoder.num_layers = layers
            for remat in (True, False):
                decoder.remat = module.vision_tower.remat = remat
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 1e9
                state, update_ms, _, _, _ = pink_updates(step, state, batch, 1)
                peaks[f"{layers}_layers_remat_{'on' if remat else 'off'}"] = dict(
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9, held_gb=held,
                    update_ms=update_ms[0])
    finally:
        decoder.num_layers = full
        decoder.remat = module.vision_tower.remat = True
    trainer.state = state
    return peaks


def pink_7b_trainer(gpu: str) -> dict:
    """Phase 18 (b)–(e). (b) ``antmmf_torch.run.main`` on the composed config
    at full width and PINK_7B_RUN_CUT depth over the seeded corpus (under
    ``build/``, deleted at the end), as phase 17 runs it: 5 iterations at B=8
    with accumulation 2, a snapshot one micro-step into the third window,
    the resume and the 6th iteration bit for bit, the first batch's loss
    falls; after the run its masters are exported as a stacked
    ``params.npz``. (e) The run's ``save_dir`` served. (c), (d) The trainer
    at full width and depth, loaded as ``run.main`` loads it: the peak of
    an update at PINK_7B_REMAT_LAYERS layers with remat on and off, then
    timed and profiled updates at all 32. Returns the launches of (b) and
    (e)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="pink_7b_smoke_", dir=build)
    try:
        import cv2  # noqa: F401
        images = True
    except ImportError:
        images = False
    probe, snaps = TrainerProbe(), SnapshotProbe()
    last = PINK_TRAIN_ITERS - 1
    layers, eva = PINK_7B_RUN_CUT
    save_dir, npz_dir = os.path.join(root, "save"), os.path.join(root, "npz")

    def export_npz(trainer):  # the masters pink_final holds, in JAX's stacked layout
        os.makedirs(npz_dir)
        shutil.copy(os.path.join(save_dir, "config.yaml"), npz_dir)
        params = flatten_flax(export_flax_variables(trainer.shell.module, trainer.state)["params"])
        np.savez(os.path.join(npz_dir, "params.npz"), **params)

    try:
        rows = write_pink_corpus(root, SEED, images)
        uninstall, unsnap = probe.install(), snaps.install()
        try:
            r = pink_run_resume(
                probe, snaps, last,
                lambda *e: run.main(pink_7b_argv(root, *e, layers=layers, eva_layers=eva)),
                lambda *e: loaded_trainer(pink_7b_argv(root, *e, layers=layers,
                                                       eva_layers=eva)),
                root, after_run=export_npz)
        finally:
            unsnap()
            uninstall()
        snaps.saved.clear()
        ckpt_gb = os.path.getsize(os.path.join(save_dir, "models", f"model_{last}")) / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        serving = pink_7b_serving(save_dir, npz_dir)
        # (c), (d) full width and depth
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        trainer = loaded_trainer(pink_7b_argv(root))
        torch.cuda.synchronize()
        full_setup_s = time.perf_counter() - t1
        load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        remat = pink_7b_remat_peaks(trainer)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        t = pink_timed_updates(trainer)
        master_bytes = sum(x.numel() * x.element_size() for x in trainer.state.params.values())
        module_bytes = sum(p.numel() * p.element_size()
                           for p in trainer.shell.module.parameters())
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = [float(x) for x in probe.losses] + [r.sixth_loss]
    upd_p50 = float(np.percentile(t["update_ms"], 50))
    run1 = probe.train[:last]
    per_update = [{k: a[k] + b[k] for k in a} for a, b in zip(run1[0::2], run1[1::2])]
    run_update = {k: n * PINK_ACCUM for k, n in PINK_7B_RUN_ITER_LAUNCHES.items()}
    evals = probe.eval
    positions = PINK_TRAIN_BATCH * (PINK_7B_TOKENS + PINK_TRAIN_TEXT)
    capacity_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    served = serving["readings"]
    summary = dict(
        config=f"{PINK_TRAIN_CONFIG} + {PINK_7B_CONFIG}", gpu=gpu, rows=rows,
        images="fixture images (cv2)" if images else "none: black frames (no cv2)",
        batch=PINK_TRAIN_BATCH, accumulation=PINK_ACCUM, run_layers=layers, run_eva_layers=eva,
        timed_layers=PINK_7B_LAYERS, timed_eva_layers=PINK_7B_EVA_LAYERS,
        losses=losses, first_batch_loss=dict(initial_masters=r.loss_before,
                                             final_masters=r.loss_after),
        update_p50_ms=upd_p50, update_p95_ms=float(np.percentile(t["update_ms"], 95)),
        micro_batch_p50_ms=float(np.percentile(t["micro_ms"], 50)),
        trainer_iteration_ms=r.iteration_ms,
        loader_wait_p50_ms=float(np.percentile(r.loader_wait_ms, 50)),
        tokens_per_s_all_positions=PINK_ACCUM * positions * 1e3 / upd_p50,
        tokens_per_s_supervised=PINK_ACCUM * t["supervised"] * 1e3 / upd_p50,
        device_busy_ms_per_update=t["busy"] if t["n_ops"] else "not measured",
        device_idle_share=1 - t["busy"] / upd_p50 if t["n_ops"] else "not measured",
        flash_device_ms_per_update=t["flash_ms"] if t["n_ops"] else "not measured",
        device_ops_per_update=t["n_ops"], top_device_ops_ms=t["top"],
        peak_mem_gb_full_depth_remat_on=t["peak_gb"], held_gb_before_updates=held_gb,
        load_peak_gb=load_peak_gb, device_capacity_gb=capacity_gb,
        headroom_gb=capacity_gb - t["peak_gb"], fp32_master_gb=master_bytes / 1e9,
        module_weight_gb=module_bytes / 1e9,
        remat_peaks=remat,
        params=t["params"], trainable_params=t["trainable_params"],
        trainable_tensors=t["trainable_tensors"],
        optimizer_state_bytes=t["optimizer_state_bytes"], launches=r.counts,
        launches_per_update=per_update[0], launches_per_timed_update=t["counts"][0],
        launches_sixth_iteration=r.sixth, launches_per_request=serving["launches"],
        train_iterations=len(probe.train), eval_forwards=len(evals),
        snapshot_at=dict(zip(("step", "mini_step", "count"), r.mid_window)),
        snapshot_gb=ckpt_gb, resumed_state_equal=probe.resumed_equal,
        continued_state_equal=r.continued, run_setup_s=r.run_setup_s,
        full_width_setup_s=full_setup_s, resume_s=r.resume_s, restore_s=probe.restores,
        saves_s_bytes=probe.saves,
        serving={n: {k: v for k, v in x.items() if k != "ids"} for n, x in served.items()},
        served_tokens=served["save_dir"]["ids"].tolist())
    emit(phase="pink_7b", part="trainer", **summary)
    check(all(np.isfinite(losses)) and len(losses) == PINK_TRAIN_ITERS,
          f"pink_7b trainer: losses {losses}")
    check(r.loss_after < r.loss_before, f"pink_7b trainer: the first batch's loss did not "
          f"fall ({r.loss_before} → {r.loss_after})")
    check(all(c == PINK_7B_RUN_ITER_LAUNCHES for c in probe.train)
          and all(c == PINK_7B_FORWARD_LAUNCHES for c in evals)
          and all(c == run_update for c in per_update)
          and all(c == PINK_7B_UPDATE_LAUNCHES for c in t["counts"]),
          f"pink_7b trainer: launches per iteration {probe.train[:1]}, per update "
          f"{per_update[:1]}, per eval forward {evals[:1]}, per full-depth update "
          f"{t['counts'][:1]}; expected {PINK_7B_RUN_ITER_LAUNCHES}, {run_update}, "
          f"{PINK_7B_FORWARD_LAUNCHES}, {PINK_7B_UPDATE_LAUNCHES}")
    check(r.sixth == PINK_7B_RUN_ITER_LAUNCHES and all(
        r.counts[k] == PINK_7B_RUN_ITER_LAUNCHES[k] * (len(probe.train) + 2)  # the 6th, twice
        + PINK_7B_FORWARD_LAUNCHES[k] * len(evals) for k in r.counts),
          f"pink_7b trainer: the run launched {r.counts}")
    check(r.mid_window == (last, 1, last // PINK_ACCUM),
          f"pink_7b trainer: the snapshot is not inside a window: {r.mid_window}")
    check(probe.resumed_equal is not None and all(probe.resumed_equal.values())
          and "acc" in probe.resumed_equal, f"pink_7b trainer: resume {probe.resumed_equal}")
    check(all(r.continued.values()), f"pink_7b trainer: the resumed 6th iteration {r.continued}")
    check(t["optimizer_state_bytes"] == 12 * t["trainable_params"]
          and t["trainable_params"] < 0.01 * t["params"],
          f"pink_7b trainer: optimizer state {t['optimizer_state_bytes']} bytes for "
          f"{t['trainable_params']} trainable of {t['params']} parameters")
    check(probe.devices == {"cuda"}, f"pink_7b trainer: ran on {probe.devices}")
    check(all(remat[f"{n}_layers_remat_off"]["peak_gb"] > remat[f"{n}_layers_remat_on"]["peak_gb"]
              for n in PINK_7B_REMAT_LAYERS), f"pink_7b: remat saved no memory: {remat}")
    check(np.array_equal(served["save_dir"]["ids"], served["params_npz"]["ids"])
          and served["save_dir"]["text"] == served["params_npz"]["text"]
          and all(x["device"] == "cuda" for x in served.values()),
          f"pink_7b: the save_dir served other tokens than its params.npz: {served}")
    check(all(c == PINK_7B_FORWARD_LAUNCHES for c in serving["launches"]),
          f"pink_7b: launches per request {serving['launches']}")
    counts = dict(r.counts)
    for c in serving["launches"]:
        for k in counts:
            counts[k] += c[k]
    return counts


def phase_pink_7b(gpu: str) -> dict:
    """Phase 18: (a) card vs CPU with planted faults, (b)–(e) the trainer and
    serving its save_dir. Returns the launches of (b) and (e)."""
    t0 = time.perf_counter()
    pink_7b_card_vs_cpu()
    counts = pink_7b_trainer(gpu)
    emit(phase="pink_7b", part="summary", seconds=time.perf_counter() - t0, launches=counts)
    return counts


# ----------------------------------------------------------------- phase 19
# M2-omni served at m2_omni_7b.yml's width through the composed serving
# config (``serving_opts``: prompts of 640 tokens, images and frame pairs at
# 448² pixels, the conv tower's 64 audio tokens): omni_7b (32 layers, 32
# heads of 128 over 8 kv heads, vocabulary 151,936) behind Qwen2-ViT (32
# blocks at 1280, 16 heads of 80, the merger into 8192, vision_proj to 4096)
# and the conv audio tower at 512, bf16, seeded weights drawn on the card
M2_NEW_TOKENS = 24
M2_LAYERS, M2_VIT_BLOCKS, M2_AUDIO_LAYERS = 32, 32, 4
# the model_dir and card-vs-CPU parts: full width at 2 of the 32 decoder
# layers and 2 of the 32 Qwen2-ViT blocks
M2_CUT = (2, 2)
M2_REQUESTS = ("image_conversation", "image_audio_text", "video_conversation")


def m2_launches(layers: int, audio: bool) -> dict:
    """A request: the causal prefill's flash forward once a decoder layer
    (decode attention is plain tensor ops), K1 once a conv audio layer at
    [1, 4, 64, 128] when ``audio`` (the request's audio through the conv
    tower); Qwen2-ViT's heads of 80 and SANM take plain tensor ops."""
    return {**NO_LAUNCHES, "flash_fwd": layers,
            "small_attention": M2_AUDIO_LAYERS if audio else 0}


# card bf16 vs CPU fp32 at full width and M2_CUT depth, on the same weights
# (the card's bf16 values, exact in fp32): the prompt's last-token logits
# and the first decode step's (teacher-forced with the CPU's token; its RoPE
# position is not its cache slot), cosine and the largest |Δ| over the CPU
# logits' spread; and the modal tokens of the towers (Qwen2-ViT +
# vision_proj + L2, the conv tower + audio_proj) in fp32 on the card
# against the CPU's, the largest |Δ| over the largest |value|, where a fault
# below bf16's rounding shows (``--calibrate m2_omni`` reads them). Sound
# runs over three seeds stay above cos 0.999964 and below 0.0404 of the
# spread, the towers below 5.6e-6; the mildest planted faults read cos
# 0.9918 and 0.593 of the spread (the mRoPE bands on the wrong axes, which
# the towers cannot see), the raster-order merger 1.1 and the (1, 1) audio
# padding 0.60 in the fp32 towers (H100 readings)
M2_COS_MIN, M2_DLOGIT_MAX, M2_TOWER_DEV_MAX = 0.9995, 0.1, 2e-5


def m2_presets(layers: int, blocks: int):
    """The names of omni_7b at ``layers`` decoder layers and of qwen2_vit at
    ``blocks`` blocks (registered as presets; the full ones by their own
    names)."""
    lm, vit = "omni_7b", "qwen2_vit"
    if layers != M2_LAYERS:
        lm = f"omni_7b_{layers}_layers"
        LM_PRESETS[lm] = {**LM_PRESETS["omni_7b"], "num_layers": layers}
    if blocks != M2_VIT_BLOCKS:
        vit = f"qwen2_vit_{blocks}_blocks"
        QWEN2_VIT_PRESETS[vit] = {**QWEN2_VIT_PRESETS["qwen2_vit"], "depth": blocks}
    return lm, vit


def m2_opts(layers: int = M2_LAYERS, blocks: int = M2_VIT_BLOCKS, dtype: str = "bfloat16",
            **model) -> list:
    """``serving_opts`` on ``m2_omni_7b.yml``, cut to ``layers`` and
    ``blocks``; greedy, 24 new tokens, the seeded init drawn on the device."""
    lm, vit = m2_presets(layers, blocks)
    return [*serving_opts(lm_preset=lm, qwen2_preset=vit, dtype_str=dtype, **model),
            "predictor_parameters.max_new_tokens", str(M2_NEW_TOKENS),
            "predictor_parameters.init_on_device", "true"]


def m2_argv(*args, model_dir=None, **kw) -> list:
    """The CLI's arguments on the card: ``m2_opts``, seeded weights or those
    of ``model_dir``."""
    return ["--config", M2_OMNI_7B, "--predictor", "generation_predictor", "--device", "cuda",
            *(["--model_dir", model_dir] if model_dir else ["--no_ckpt"]), *m2_opts(*args, **kw)]


def m2_predictor(*args, **kw):
    with no_default_init():  # the seeded init or the model_dir sets every value
        return build_predictor(m2_argv(*args, **kw))[0]


def m2_requests(seed: int = SEED) -> dict:
    """(a) a conversation with one image of 500×375, (b) that image, 2.6 s
    of audio and text, (c) a conversation with a video of 4 frames at 448²;
    seeded noise."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
    wave = (rng.standard_normal(int(16000 * 2.6)) * 0.1).astype(np.float32)
    frames = [rng.integers(0, 256, (448, 448, 3), dtype=np.uint8) for _ in range(4)]

    def chat(media, text):
        return {"conversation": [{"role": "user", "content": [media,
                                                              {"type": "text", "text": text}]}]}

    return {"image_conversation": chat({"type": "image", "image": image},
                                       "describe the image in detail."),
            "image_audio_text": {"text": "<image> what is in the picture, and what do you hear "
                                         "in <audio> ?", "images": [image], "waveform": wave},
            "video_conversation": chat({"type": "video", "video": frames},
                                       "what happens in the video?")}


def rope_positions_numpy(ids, image_id: int, audio_id: int, grid) -> np.ndarray:
    """The reference ``get_rope_index`` loop over one row: a text slot
    takes (base, base, base) and advances the base by 1; an image run takes
    base + (t, h, w) over its grid in raster order and advances the base by
    max(t, h, w); an audio run of n slots takes base + k on all three axes
    and advances it by n."""
    pos, base, i = [], 0, 0
    while i < len(ids):
        if ids[i] == image_id:
            t, h, w = grid
            pos += [(base + a, base + b, base + c)
                    for a in range(t) for b in range(h) for c in range(w)]
            base, i = base + max(t, h, w), i + t * h * w
        elif ids[i] == audio_id:
            n = 0
            while i + n < len(ids) and ids[i + n] == audio_id:
                n += 1
            pos += [(base + k,) * 3 for k in range(n)]
            base, i = base + n, i + n
        else:
            pos.append((base,) * 3)
            base, i = base + 1, i + 1
    return np.array(pos)


def m2_grid(pred, request) -> tuple:
    """The merged (t, h, w) grid of the request's image or video."""
    out = pred.unified(request)
    grids = out.get("image_grid_thw", out.get("video_grid_thw"))
    m = pred.unified.image_processor.merge_size
    t, h, w = (int(g) for g in np.asarray(grids).reshape(-1, 3)[0])
    return t, h // m, w // m


def m2_towers_ms(pred, arrays) -> float:
    """The towers, the splice and the 3D positions alone, timed once (the
    prefill runs them again inside)."""
    module = pred.shell.module
    batch = pred.shell.to_device(arrays)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module._assemble_spliced(batch, batch["input_ids"])
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def m2_walk(pred, arrays, steps: int, sync: bool = True):
    """The prefill (the towers inside) and ``steps`` greedy decode steps
    through the model's cached entry points: RoPE position ``next_p + t``,
    cache slot ``lens_full + t``. Returns (prefill ms, per-step ms, last
    logits); with ``sync`` the device is waited for after each part, as a
    streaming server would."""
    module = pred.shell.module
    batch = pred.shell.to_device(arrays)
    wait = torch.cuda.synchronize if sync else (lambda: None)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, lens_full, next_p = module.prefill(batch, steps + 1)
        wait()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_ms = []
        for t in range(steps):
            t0 = time.perf_counter()
            logits, cache = module.decode_step(logits.argmax(dim=-1), next_p + t, lens_full + t,
                                               cache)
            wait()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return prefill_ms, step_ms, logits


def m2_serve(pred, requests: dict, layers: int) -> tuple:
    """Each request through ``predict`` with the launch counts set to 0
    just before it and read just after. Returns ({name: the readings},
    summed launches)."""
    totals, out = dict(NO_LAUNCHES), {}
    conv = pred.shell.module.audio_tower == "conv"
    for name, request in requests.items():
        audio = "waveform" in request and conv
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answer = pred.predict(request)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        for k, n in counts.items():
            totals[k] += n
        ids = np.asarray(answer["generated_ids"])
        arrays = pred.build_sample(request).arrays()
        n_prompt = int(arrays["input_mask"].sum())
        new = ids[0, n_prompt: n_prompt + M2_NEW_TOKENS]
        out[name] = dict(request_ms=request_ms, launches=counts, prompt_tokens=n_prompt,
                         image_slots=int((arrays["input_ids"] == pred.unified.special_token_ids[
                             "<imagePatch>"]).sum()),
                         audio_slots=int((arrays["input_ids"] == pred.unified.special_token_ids[
                             "<audioPatch>"]).sum()),
                         ids=ids, new_tokens=new.tolist(), text=answer["generated_text"])
        want = m2_launches(layers, audio)
        check(counts == want, f"m2_omni {name}: launches {counts}; expected {want}")
        check(n_prompt < SERVING_SEQ_LEN, f"m2_omni {name}: a prompt of {n_prompt} tokens is cut")
        check(ids.shape == (1, SERVING_SEQ_LEN + M2_NEW_TOKENS)
              and bool(((new >= 0) & (new < LM_PRESETS["omni_7b"]["vocab_size"])).all()),
              f"m2_omni {name}: generated ids {ids.shape}, {new.tolist()}")
    return out, totals


def m2_full_depth(gpu: str) -> dict:
    """Phase 19 (a): the three requests at full width and depth through
    ``predict`` after a warm-up with image and audio, launches counted and the whole
    request timed; then for each the towers alone (once), one walk of the
    prefill and 23 decode steps (the tokens after the prefill's), and the
    device's idle share over a prefill and four decode steps launched
    without waiting (one untraced, one profiled); peak memory. Returns the
    launches."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = m2_predictor()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    module = pred.shell.module
    params = sum(p.numel() for p in module.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in module.parameters())
    emit(phase="m2_omni", part="load", gpu=gpu, load_s=load_s, params=params,
         weight_gb=weight_bytes / 1e9, decode_step_bytes_bound_ms=weight_bytes / HBM_BYTES_PER_S
         * 1e3, mem_after_load_gb=torch.cuda.memory_allocated() / 1e9,
         device=next(module.parameters()).device.type)
    check(next(module.parameters()).is_cuda, "m2_omni: the model is not on the card")
    requests = m2_requests()
    pred.predict(requests["image_audio_text"])  # warm-up: the image and the audio convs
    served, totals = m2_serve(pred, requests, M2_LAYERS)
    for name, request in requests.items():
        arrays = pred.build_sample(request).arrays()
        towers = m2_towers_ms(pred, arrays)
        prefill, steps, logits = m2_walk(pred, arrays, M2_NEW_TOKENS - 1)
        check(bool(torch.isfinite(logits).all().item()), f"m2_omni {name}: non-finite logits")
        wall = host_ms(lambda: m2_walk(pred, arrays, 4, sync=False), 1, warmup=0)[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m2_walk(pred, arrays, 4, sync=False)
        busy, n_ops, top = device_busy(prof, 1)
        reading = served[name]
        emit(phase="m2_omni", part="request", request=name, gpu=gpu,
             prompt_tokens=reading["prompt_tokens"], image_slots=reading["image_slots"],
             audio_slots=reading["audio_slots"], launches=reading["launches"],
             request_ms=reading["request_ms"],
             new_tokens_per_s=M2_NEW_TOKENS * 1e3 / reading["request_ms"],
             prefill_ms=prefill, towers_ms=towers, decoder_prefill_ms=prefill - towers,
             decode_step_ms=pct(steps), decode_tokens_per_s=1e3 / float(np.median(steps)),
             profiled="one prefill (the towers inside) and four decode steps",
             untraced_wall_ms=wall, device_busy_ms=busy if n_ops else "not measured",
             device_idle_share=1 - busy / wall if n_ops else "not measured", device_ops=n_ops,
             top_device_ops_ms=top, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             new_tokens=reading["new_tokens"], text=reading["text"])
    for k, n in m2_engine(pred, served, gpu).items():
        totals[k] += n
    for k, n in m2_int4(pred, served, gpu).items():
        totals[k] += n
    del pred, module
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# phase 19 (d): the full-depth bf16 model quantised to int4 on the card, in
# place; K8 at its five shapes and the rows of one request, of speculation
# (gamma + 1 = 5) and of 8; one request greedy and speculative. A decode
# step launches K8 7 times a layer and once for lm_head.
M2_GEMVS_PER_STEP = 7 * M2_LAYERS + 1
M2_INT4_SHAPES = {"attn_q_o": "attention.q_proj", "attn_k_v": "attention.k_proj",
                  "mlp_gate_up": "mlp.gate_proj", "mlp_down": "mlp.down_proj",
                  "lm_head": None}
M2_INT4_ROWS = (1, 4, 8)
M2_LAUNCHES_PER_STEP = {"attn_q_o": 2 * M2_LAYERS, "attn_k_v": 2 * M2_LAYERS,
                        "mlp_gate_up": 2 * M2_LAYERS, "mlp_down": M2_LAYERS, "lm_head": 1}


def m2_int4_records_check(module, host: dict) -> dict:
    """Each record the card made against numpy's (``quantize_for_decode``
    on the host copies of the same bf16 weights), byte for byte."""
    want = flatten_flax(quantize_for_decode(host))
    out = {}
    for path, rec in want.items():
        mod = module.get_submodule(path[:-len("/kernel")].replace("/", "."))
        out[path] = bool("q4" in rec and mod.kernel_q4 is not None
                         and np.array_equal(mod.kernel_q4.cpu().numpy(), rec["q4"])
                         and np.array_equal(mod.kernel_scale.cpu().numpy(), rec["scale"]))
    return out


def m2_int4_kernels(module, gpu) -> dict:
    """K8 on the served records at the five shapes and M2_INT4_ROWS rows of
    bf16 x: against ``plain_int4_gemv`` (INT4_TOL), timed from a CUDA graph
    over copies that the L2 cannot hold beside bf16 ``torch.matmul`` on the
    dequantised weight, with the bound; summed over a decode step's
    launches. Returns the step sums by rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    saved = read_counts()
    layer = module.decoder.layer_0
    steps = {rows: dict(ms=0.0, library_ms=0.0, bound_ms=0.0) for rows in M2_INT4_ROWS}
    failed = []
    for name, sub in M2_INT4_SHAPES.items():
        mod = module.lm_head if sub is None else layer.get_submodule(sub)
        packed, scale = mod.kernel_q4, mod.kernel_scale
        fin_x, fout = mod.in_features, mod.out_features
        record_bytes = packed.numel() + scale.numel() * 4
        copies = max(2, min(64, -(-256 * 2 ** 20 // record_bytes)))
        records = [(packed.clone(), scale.clone()) for _ in range(copies)]
        dense = [unpack_int4(packed, scale, torch.bfloat16)[:fin_x]]
        dense.append(dense[0].clone())
        for rows in M2_INT4_ROWS:
            x = torch.randn(rows, fin_x, generator=gen, device="cuda").to(torch.bfloat16)
            y, ref = int4_gemv(x, packed, scale), plain_int4_gemv(x, packed, scale)
            err = max_err(y, ref)
            ok = err <= INT4_TOL * max(ref.abs().max().item(), 1.0)
            if not ok:
                failed.append(f"{name}_{rows}")
            nbytes = record_bytes + x.numel() * 2 + rows * fout * 4
            timing = dict(ms=graph_ms(lambda i: int4_gemv(x, *records[i]), copies),
                          library_ms=graph_ms(lambda i: torch.matmul(x, dense[i]), 2),
                          **bound(nbytes, 2 * rows * packed.shape[0] * 2 * fout))
            emit(phase="m2_omni", part="int4_gemv", case=name, x=[rows, fin_x],
                 record=[packed.shape[0] * 2, fout], group=packed.shape[0] * 2 // scale.shape[0],
                 gpu=gpu, vs_plain=err, ok=ok, launches_per_decode_step=M2_LAUNCHES_PER_STEP[name],
                 copies_in_turn=copies, **timing, bound_share=timing["bound_ms"] / timing["ms"])
            for key in steps[rows]:
                steps[rows][key] += M2_LAUNCHES_PER_STEP[name] * timing[key]
        del records, dense
    for fn in KERNELS:  # checks and timings are not path launches
        fn.launches = saved[fn.__name__]
    for rows, step in steps.items():
        emit(phase="m2_omni", part="int4_gemv_per_decode_step", rows=rows, gpu=gpu,
             launches=M2_GEMVS_PER_STEP, **step, bound_share=step["bound_ms"] / step["ms"])
    check(not failed, f"int4_gemv disagrees with its plain version at the 7B shapes: {failed}")
    return steps


def m2_int4(pred, served: dict, gpu) -> dict:
    """Phase 19 (d), last on the full-depth model: host copies of layer 0's
    seven kernels and lm_head's, the model quantised to int4 in place on the
    card (timed), those records against numpy's byte for byte, K8 at the 7B
    shapes, and the image conversation served greedy and speculative (TTFT,
    ms a token, peak) beside the bf16 model's readings. Returns the
    launches of the two requests."""
    module = pred.shell.module
    paths = flax_paths(module)
    host = {}
    for name, param in module.named_parameters():
        if name.startswith("decoder.layer_0.") and name.endswith("_proj.weight") \
                or name == "lm_head.weight":
            host[paths[name]] = param.detach().float().T.contiguous().cpu().numpy()
    host = weights._nest(host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served_n, dequantised = quantize_module_for_decode(module, bits=4)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    records = m2_int4_records_check(module, host)
    del host
    packed = [m for m in module.modules() if getattr(m, "kernel_q4", None) is not None]
    emit(phase="m2_omni", part="int4_quantise", gpu=gpu, seconds=quant_s, served=served_n,
         dequantised=dequantised, records_equal_numpy=records,
         packed_weight_gb=sum(m.kernel_q4.numel() + m.kernel_scale.numel() * 4
                              for m in packed) / 1e9,
         mem_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    check(len(packed) == M2_GEMVS_PER_STEP, f"m2_omni int4: {len(packed)} packed kernels")
    check(all(records.values()), f"m2_omni int4 records differ from numpy's: {records}")
    steps = m2_int4_kernels(module, gpu)
    request = m2_requests()["image_conversation"]
    arrays = pred.build_sample(request).arrays()
    saved = dict(pred.decode_options)
    totals, readings = dict(NO_LAUNCHES), {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pred.predict(request)  # warm-up of the int4 path
    for mode, options in (("greedy", {}), ("speculative", dict(speculative=DECODE_GAMMA))):
        pred.decode_options = {**saved, **options}
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answer = pred.predict(request)
            torch.cuda.synchronize()
            request_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
        finally:
            pred.decode_options = saved
        for k, n in counts.items():
            totals[k] += n
        n_prompt = int(arrays["input_mask"].sum())
        readings[mode] = dict(request_ms=request_ms, launches=counts, new_tokens=np.asarray(
            answer["generated_ids"])[0, n_prompt:n_prompt + M2_NEW_TOKENS].tolist())
    prefill, step_ms, _ = m2_walk(pred, arrays, M2_NEW_TOKENS - 1)
    bf16 = served["image_conversation"]
    spec_steps = (readings["speculative"]["launches"]["int4_gemv"] - 1) / M2_GEMVS_PER_STEP
    emit(phase="m2_omni", part="int4_serving", gpu=gpu, ttft_ms=prefill,
         decode_step_ms=pct(step_ms), greedy=readings["greedy"],
         speculative={**readings["speculative"], "verify_steps": spec_steps},
         bf16_request_ms=bf16["request_ms"], bf16_new_tokens=bf16["new_tokens"],
         k8_step_ms_by_rows={r: s["ms"] for r, s in steps.items()},
         bf16_matmul_step_ms_by_rows={r: s["library_ms"] for r, s in steps.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {**NO_LAUNCHES, "flash_fwd": M2_LAYERS,
            "int4_gemv": 1 + (M2_NEW_TOKENS - 1) * M2_GEMVS_PER_STEP}
    check(readings["greedy"]["launches"] == want,
          f"m2_omni int4 greedy launches {readings['greedy']['launches']}; expected {want}")
    check(spec_steps == int(spec_steps) and 1 <= spec_steps < M2_NEW_TOKENS,
          f"m2_omni int4 speculative K8 launches {readings['speculative']['launches']}")
    same = readings["speculative"]["new_tokens"] == readings["greedy"]["new_tokens"]
    emit(phase="m2_omni", part="int4_speculative_vs_greedy", same_tokens=same)
    check(same or m2_forced_margin(pred, arrays, readings) <= ENGINE_TIE_MAX,
          "m2_omni int4: speculative tokens differ from greedy beyond a near-tie")
    return totals


def m2_forced_margin(pred, arrays, readings) -> float:
    """The greedy logits' near-tie margin at the first position where the
    speculative tokens differ (one row, teacher-forced)."""
    module = pred.shell.module
    want, got = readings["greedy"]["new_tokens"], readings["speculative"]["new_tokens"]
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    batch = pred.shell.to_device(arrays)
    with torch.inference_mode():
        logits, cache, lens_full, next_p = module.prefill(batch, j + 1)
        for t in range(j):
            logits, cache = module.decode_step(torch.tensor([want[t]], device="cuda"),
                                               next_p + t, lens_full + t, cache)
    lg = logits[0].float()
    return float((lg[want[j]] - lg[got[j]]).abs() / lg.std())


def m2_sanm(gpu: str) -> dict:
    """Phase 19 (b): ``audio_tower: sanm`` (bailing2_audio: 50 blocks, LFR
    560 → 512, 85 tokens after compression by 3) laid over the same model,
    one request with image and audio at full width and depth. Returns the
    launches."""
    t0 = time.perf_counter()
    pred = m2_predictor(audio_tower="sanm")
    load_s = time.perf_counter() - t0
    request = {"image_audio_text": m2_requests()["image_audio_text"]}
    served, totals = m2_serve(pred, request, M2_LAYERS)
    check(totals == m2_launches(M2_LAYERS, False), f"m2_omni sanm: launches {totals}")
    reading = served["image_audio_text"]
    emit(phase="m2_omni", part="sanm_request", gpu=gpu, load_s=load_s,
         audio_slots=reading["audio_slots"], prompt_tokens=reading["prompt_tokens"],
         request_ms=reading["request_ms"], launches=reading["launches"],
         new_tokens=reading["new_tokens"], text=reading["text"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(reading["audio_slots"] == 85, f"m2_omni sanm: {reading['audio_slots']} audio slots")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def m2_modal_tokens(module, batch) -> list:
    with torch.inference_mode():
        out = [module._encode_visual_streams(batch["image_data"])[0]]
        if "audio" in batch:
            out.append(module._audio_tokens(batch))
    return [t.float().cpu() for t in out]


def m2_logits(module, batch, token=None):
    """fp32 logits at the prompt's last token and at the first decode step,
    which is fed ``token`` (default: this model's own greedy token), and
    the 3D positions."""
    with torch.inference_mode():
        _, positions, _ = module._assemble_spliced(batch, batch["input_ids"])
        first, cache, lens_full, next_p = module.prefill(batch, 1)
        token = first.argmax(dim=-1) if token is None else token.to(first.device)
        second, _ = module.decode_step(token, next_p, lens_full, cache)
    return first[0].float().cpu(), second[0].float().cpu(), token.cpu(), positions.cpu()


def m2_twins(seed: int):
    """Phase 19 (c)/(d)'s models at full width and M2_CUT depth: the card's
    bf16 predictor seeded on the card, its weights exported as an fp32 flax
    tree (stacked decoder layers), and fp32 models from that tree on the
    CPU and on the card (whose towers give the fp32 reading). Returns (card
    predictor, CPU module, card fp32 module, the tree)."""
    card = m2_predictor(*M2_CUT)
    if seed != SEED:  # the predictor drew seed 0
        card.shell.init(seed, on_device=True)
    tree = export_flax_params(card.shell.module)
    cfg = build_config(M2_OMNI_7B, opts=m2_opts(*M2_CUT, dtype="float32"))
    twins = []
    for device in ("cpu", "cuda"):
        with no_default_init():
            shell = build_model(cfg, device=device)
        weights.load_flax_params(shell.module, tree)
        twins.append(shell.module)
    return card, *twins, tree


def m2_faults(card, card32, audio: bool):
    """Faults planted on the card's models only (the CPU's readings are
    taken before), each undone after its reading: (name, plant, undo).
    The mRoPE bands read from the wrong axes; image slots given sequential
    positions; the PatchMerger grouping tokens in raster order; the L2
    normalisation dropped; with ``audio``, the audio convolutions padded
    (1, 1)."""
    from antmmf_torch.models import m2_omni as m2_mod
    from antmmf_torch.modules import llm as llm_mod

    module = card.shell.module
    real_tables, real_norm, real_pad = llm_mod.rope_tables, m2_mod._l2_normalize, m2_mod._same_pad
    tower_pairs = [module.vision_tower, card32.vision_tower]

    def wrong_axes(positions, head_dim, theta, rope_3d):
        return real_tables(positions[..., [1, 2, 0]] if positions.dim() == 3 else positions,
                           head_dim, theta, rope_3d)

    def sequential(modal_mask, run_start, rel):
        return m2_mod.M2Omni.get_rope_index(torch.zeros_like(modal_mask),
                                            torch.zeros_like(run_start), torch.zeros_like(rel))

    def raster(tower):
        real = type(tower).patches.__get__(tower)

        def patches(frames):
            x, (t, h, w) = real(frames)
            B, L, P = x.shape
            m = tower.merge
            # undo the merge order (t, h/m, w/m, m, m) into raster (t, h, w)
            x = x.view(B, t, h // m, w // m, m, m, P).permute(0, 1, 2, 4, 3, 5, 6)
            return x.reshape(B, L, P), (t, h, w)

        tower.patches = patches

    def setattr_on(obj, name, value):
        return lambda: setattr(obj, name, value)

    faults = [
        ("mrope_bands_wrong_axes", setattr_on(llm_mod, "rope_tables", wrong_axes),
         setattr_on(llm_mod, "rope_tables", real_tables)),
        ("image_slots_sequential", setattr_on(module, "get_rope_index", sequential),
         lambda: module.__dict__.pop("get_rope_index")),
        ("merger_raster_order", lambda: [raster(t) for t in tower_pairs],
         lambda: [t.__dict__.pop("patches") for t in tower_pairs]),
        ("l2_norm_dropped", setattr_on(m2_mod, "_l2_normalize", lambda x: x),
         setattr_on(m2_mod, "_l2_normalize", real_norm))]
    if audio:
        faults.append(("audio_conv_padded_1_1", setattr_on(m2_mod, "_same_pad", lambda n: (1, 1)),
                       setattr_on(m2_mod, "_same_pad", real_pad)))
    return faults


def m2_compare(card, card32, batch, ref) -> dict:
    first, second, _, positions = m2_logits(card.shell.module, batch, ref["token"])
    tokens = m2_modal_tokens(card32, batch)
    dev = max(((a - b).abs().max() / b.abs().max()).item() if a.shape == b.shape
              else float("inf") for a, b in zip(tokens, ref["tokens"]))
    return dict(prefill=compare_logits(first, ref["first"]),
                decode_step=compare_logits(second, ref["second"]), tower_fp32_dev=dev,
                positions_equal_cpu=bool(torch.equal(positions, ref["positions"])),
                positions_equal_recurrence=bool(np.array_equal(positions[0].numpy(),
                                                               ref["recurrence"])))


def m2_within_bound(res) -> bool:
    return all(r["cos"] >= M2_COS_MIN and r["max_abs_d_over_std"] <= M2_DLOGIT_MAX
               for r in (res["prefill"], res["decode_step"])) \
        and res["tower_fp32_dev"] <= M2_TOWER_DEV_MAX


def m2_readings(seed: int, faults: bool, model_dir=None):
    """Card vs CPU on requests (a) and (b): the sound reading and, with
    ``faults``, each planted fault's; with ``model_dir`` (a directory under
    build/), phase 19 (c) in between. Returns ({request: {reading: ...}},
    the model_dir part's readings or None, the launches of its requests)."""
    card, cpu, card32, tree = m2_twins(seed)
    requests = {k: v for k, v in m2_requests(seed).items() if k != "video_conversation"}
    out, totals = {}, dict(NO_LAUNCHES)
    for name, request in requests.items():
        arrays = card.build_sample(request).arrays()
        cpu_batch = {k: torch.as_tensor(v) for k, v in arrays.items()}
        first, second, token, positions = m2_logits(cpu, cpu_batch)
        sp = card.unified.special_token_ids
        ref = dict(first=first, second=second, token=token, positions=positions,
                   tokens=m2_modal_tokens(cpu, cpu_batch),
                   recurrence=rope_positions_numpy(arrays["input_ids"][0], sp["<imagePatch>"],
                                                   sp["<audioPatch>"], m2_grid(card, request)))
        batch = card.shell.to_device(arrays)
        res = {"sound": m2_compare(card, card32, batch, ref)}
        planted = m2_faults(card, card32, "waveform" in request) if faults else ()
        for fault, plant, undo in planted:
            plant()
            try:
                res[fault] = m2_compare(card, card32, batch, ref)
            finally:
                undo()
        out[name] = res
    int8 = m2_int8_reading(card, cpu, requests["image_conversation"], faults)
    served = None
    if model_dir is not None:
        served, totals = m2_model_dir(card, tree, requests["image_audio_text"], model_dir)
    del card, cpu, card32, tree
    gc.collect()
    torch.cuda.empty_cache()
    return out, served, totals, int8


def m2_model_dir(card, tree, request, root: str):
    """Phase 19 (c): the cut model's weights written as a ``params.npz``
    (fp32 flax leaves, decoder layers stacked) and served by
    ``python -m antmmf_torch.predictors.cli --model_dir`` on request (b),
    driven in-process through ``cli.main``; the tokens against the
    in-process predictor's on the same weights."""
    from antmmf_torch.predictors import cli

    npz_dir = os.path.join(root, "npz")
    os.makedirs(npz_dir)
    t0 = time.perf_counter()
    np.savez(os.path.join(npz_dir, "params.npz"), **flatten_flax(tree))
    save_s = time.perf_counter() - t0
    path = os.path.join(root, "request.json")
    with open(path, "w") as f:  # the image as a list of one frame: a list is read as frames
        json.dump({"text": request["text"], "images": [[request["images"][0].tolist()]],
                   "waveform": request["waveform"].tolist()}, f)
    zero_counts()
    in_process = card.predict(request)
    counts = [read_counts()]
    zero_counts()
    t1 = time.perf_counter()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout), no_default_init():
        cli.main(m2_argv(*M2_CUT, model_dir=npz_dir) + ["--input", path])
    served_s = time.perf_counter() - t1
    counts.append(read_counts())
    answer = json.loads(stdout.getvalue().strip().splitlines()[-1])
    totals = {k: counts[0][k] + counts[1][k] for k in counts[0]}
    n_prompt = int(card.build_sample(request).arrays()["input_mask"].sum())
    return dict(save_s=save_s, prompt_tokens=n_prompt, npz_gb=os.path.getsize(os.path.join(npz_dir, "params.npz")) / 1e9,
                load_and_request_s=served_s, launches=counts,
                in_process_ids=np.asarray(in_process["generated_ids"]),
                served_ids=np.asarray(answer["generated_ids"]),
                same_text=answer["generated_text"] == in_process["generated_text"]), totals


def calibrate_m2_omni(seeds=3) -> None:
    """Phase 19 (d)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        readings, _, _, _ = m2_readings(seed, seed == seeds - 1)
        for request, by_name in readings.items():
            for name, res in by_name.items():
                emit(phase="calibrate_m2_omni", kind="sound" if name == "sound" else "fault",
                     fault=None if name == "sound" else name, seed=seed, request=request, **res,
                     within_bound=m2_within_bound(res))
    emit(phase="calibrate_m2_omni", kind="bound", cos_min=M2_COS_MIN,
         dlogit_max=M2_DLOGIT_MAX, tower_fp32_dev_max=M2_TOWER_DEV_MAX)


def m2_cut_depth(gpu: str) -> dict:
    """Phase 19 (c) and (d) at full width and M2_CUT depth; returns the
    launches of (c)'s requests."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="m2_omni_smoke_", dir=build)
    t0 = time.perf_counter()
    try:
        readings, served, totals, int8 = m2_readings(SEED, True, model_dir=root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = bool(np.array_equal(served["in_process_ids"], served["served_ids"]))
    emit(phase="m2_omni", part="model_dir", gpu=gpu, layers=M2_CUT[0], vit_blocks=M2_CUT[1],
         **{k: v for k, v in served.items() if not k.endswith("_ids")}, same_tokens=same,
         tokens=served["served_ids"][0, served["prompt_tokens"]:][:M2_NEW_TOKENS].tolist())
    check(same and served["same_text"], "m2_omni: the model_dir served other tokens")
    want = m2_launches(M2_CUT[0], True)
    check(all(c == want for c in served["launches"]),
          f"m2_omni model_dir: launches {served['launches']}; expected {want}")
    for request, res in readings.items():
        faults = {n: r for n, r in res.items() if n != "sound"}
        caught = {n: not m2_within_bound(r) for n, r in faults.items()}
        emit(phase="m2_omni", part="card_vs_cpu", request=request, layers=M2_CUT[0],
             vit_blocks=M2_CUT[1], **res["sound"], faults=faults, faults_caught=caught,
             bounds=dict(cos_min=M2_COS_MIN, dlogit_max=M2_DLOGIT_MAX,
                         tower_fp32_dev_max=M2_TOWER_DEV_MAX))
        check(m2_within_bound(res["sound"]), f"m2_omni {request}: card and CPU disagree "
              f"beyond the stated bound")
        check(res["sound"]["positions_equal_cpu"] and res["sound"]["positions_equal_recurrence"],
              f"m2_omni {request}: the 3D positions on the card differ")
        check(all(caught.values()), f"m2_omni {request}: a planted fault passed: {caught}")
    engine_int8_check("m2", int8)
    emit(phase="m2_omni", part="cut_depth", seconds=time.perf_counter() - t0)
    return totals


def phase_m2_omni(gpu: str) -> dict:
    """Phase 19: (a) the three requests at full width and depth, (b) the
    SANM tower, (c) the predictor from a model_dir and (d) card vs CPU with
    planted faults at cut depth. Returns the launches of (a), (b), (c)."""
    t0 = time.perf_counter()
    counts = dict(NO_LAUNCHES)
    for part in (m2_full_depth, m2_sanm, m2_cut_depth):
        for k, n in part(gpu).items():
            counts[k] += n
    emit(phase="m2_omni", part="summary", seconds=time.perf_counter() - t0, launches=counts)
    return counts


# ----------------------------------------------------------------- phase 20
# M2-omni LoRA training at m2_omni_7b.yml's width: ``recipe_opts`` of
# models/m2_omni.py (LoRA of rank 8 on the decoder's seven projections and
# on every Qwen2-ViT block; only the adapters, vision_proj and audio_proj
# train; the yml's remat, scan_layers, AdamW at lr 2e-5 with a bf16 first
# moment, accumulation over 2 micro-batches), seeded on the card, driven
# through build_optimizer and make_train_step. An update is two micro-batches
# of M2_TRAIN_BATCH conversations of phase 19's 640 slots built by the
# port's unified processor, labels -100 up to the assistant's answer: image
# conversations (two with audio and text too), then 4-frame videos. A
# 4-frame video at phase 19's 448² takes 635 of the 640 slots before any
# answer, so the training videos are resized to 392² (392 video slots)
M2_TRAIN_BATCH, M2_ACCUM = 4, 2
M2_TRAIN_WARMUP, M2_TRAIN_TIMED, M2_TRAIN_PROFILED = 2, 4, 2
M2_VIDEO_FRAMES, M2_VIDEO_PIXELS = 4, 392 * 392
M2_LONG_FRAMES, M2_LONG_SEQ_LEN = 16, 2304
M2_ANSWER = "a person walks across a kitchen and opens the window while a radio plays."
M2_TRAIN_CUT = (2, 2)  # card vs CPU: 2 of the 32 decoder layers and 2 of the 32 tower blocks


def m2_train_launches(layers: int, audio: bool) -> dict:
    """A micro-batch under remat: each causal decoder layer's flash forward
    twice (the forward, then its recompute in the backward), dQ and dK/dV
    once; the conv audio tower's 4 layers through K1 when the batch carries
    audio (the tower is frozen: no recompute); Qwen2-ViT's heads of 80 take
    plain tensor ops."""
    return {**NO_LAUNCHES, "flash_fwd": 2 * layers, "flash_dq": layers, "flash_dkv": layers,
            "small_attention": M2_AUDIO_LAYERS if audio else 0}


M2_UPDATE_LAUNCHES = {k: m2_train_launches(M2_LAYERS, True)[k]
                      + m2_train_launches(M2_LAYERS, False)[k] for k in NO_LAUNCHES}
# card bf16 vs CPU fp32 at full width and M2_TRAIN_CUT depth, the first
# micro-step at B=1 (an image + audio + text conversation) on the same fp32
# masters carried through the stacked layout (every lora_b drawn nonzero):
# |Δ lm_loss| and the gradient cosines of the 48 trainable tensors (all
# together, the least; ``--calibrate m2_train`` reads them). Sound runs over
# three seeds stay below |Δ| 0.0032 and above cos 0.999938 (all), 0.99976
# (least); the decoder's LoRA scaling doubled reads |Δ| 0.141, cos 0.845 /
# 0.725; the vision tokens detached cos 0 (no gradient reaches the tower);
# the audio convolutions padded (1, 1) |Δ| 0.0133, cos 0.966 / 0.803 (H100
# readings)
M2_TRAIN_DLOSS_MAX, M2_TRAIN_COS_ALL, M2_TRAIN_COS_MIN = 0.006, 0.9998, 0.999


def m2_train_opts(layers: int = M2_LAYERS, blocks: int = M2_VIT_BLOCKS) -> list:
    """``recipe_opts`` on ``m2_omni_7b.yml`` at ``layers`` decoder layers and
    ``blocks`` tower blocks."""
    lm, vit = m2_presets(layers, blocks)
    return m2_recipe_opts(lm_preset=lm, qwen2_preset=vit)


def m2_train_processor(seq_len: int, video_pixels: int = SERVING_PIXELS
                       ) -> M2OmniUnifiedProcessor:
    """Phase 19's serving block (``serving_opts``) as a processor of
    ``seq_len`` slots and video frames of ``video_pixels``, the patch ids
    the model's splice ids (a video's at the image id), as the generation
    predictor builds it."""
    up = "predictor_parameters.unified_processor"
    cfg = build_config(M2_OMNI_7B, opts=serving_opts() + [
        f"{up}.text.max_seq_length", str(seq_len), f"{up}.video.min_pixels", str(video_pixels),
        f"{up}.video.max_pixels", str(video_pixels)])
    block = cfg.get_dotted(up).to_dict()
    model = cfg["model_attributes"]["m2_omni"]
    block["special_token_ids"] = {"<imagePatch>": int(model["image_token_id"]),
                                  "<videoPatch>": int(model["image_token_id"]),
                                  "<audioPatch>": int(model["audio_token_id"])}
    return M2OmniUnifiedProcessor(block)


def m2_train_row(proc, rng, kind: str, frames: int = M2_VIDEO_FRAMES) -> dict:
    """One training conversation of ``kind`` (image, image_audio, video of
    ``frames`` frames of 448², which the processor resizes), seeded noise, and the assistant's answer:
    the processor's ids over the whole conversation, labels -100 up to the
    answer and the answer's ids after it (the prompt's ids are the
    conversation's first ones)."""
    if kind == "video":
        media = [{"type": "video", "video": [rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)
                                             for _ in range(frames)]}]
        question = "what happens in the video?"
    else:
        media = [{"type": "image", "image": rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)}]
        question = "describe the image in detail."
        if kind == "image_audio":
            media.append({"type": "audio",
                          "audio": (rng.standard_normal(int(16000 * 2.6)) * 0.1).astype(
                              np.float32)})
            question = "what is in the picture, and what do you hear?"
    user = [{"role": "user", "content": media + [{"type": "text", "text": question}]}]
    reply = [{"role": "assistant", "content": [{"type": "text", "text": M2_ANSWER}]}]
    prompt = proc({"conversation": user})
    full = proc({"conversation": user + reply, "add_generation_prompt": False})
    n_p, n, L = int(prompt["input_mask"].sum()), int(full["input_mask"].sum()), proc.max_seq_length
    check(n_p < n < L and np.array_equal(full["input_ids"][:n_p], prompt["input_ids"][:n_p]),
          f"m2_train {kind}: the prompt ({n_p}) is not the conversation's ({n} of {L}) start")
    visual = full.get("video_data") or full.get("image_data")
    row = {"input_ids": full["input_ids"], "input_mask": full["input_mask"],
           "labels": np.where((np.arange(L) >= n_p) & (full["input_mask"] > 0),
                              full["input_ids"], -100),
           "image_data": np.asarray(visual[0], np.float32)}
    if "fbank" in full:
        row["audio"] = np.asarray(full["fbank"], np.float32)
        row["audio_mask"] = np.asarray(full["fbank_mask"], np.int32)
    return row


def m2_train_batch(proc, rng, kinds) -> dict:
    """The rows of ``kinds`` stacked; a row without audio in a batch that
    has some carries zero fbank frames, fully masked (no placeholder reads
    them)."""
    rows = [m2_train_row(proc, rng, kind) for kind in kinds]
    with_audio = [r for r in rows if "audio" in r]
    for r in rows:
        if with_audio and "audio" not in r:
            r["audio"] = np.zeros_like(with_audio[0]["audio"])
            r["audio_mask"] = np.zeros_like(with_audio[0]["audio_mask"])
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def m2_train_batches(seed: int = SEED) -> list:
    """An update's two micro-batches: image conversations (the 2nd and 4th
    with audio and text too), then 4-frame video conversations."""
    rng = np.random.default_rng(seed)
    proc = m2_train_processor(SERVING_SEQ_LEN, M2_VIDEO_PIXELS)
    return [m2_train_batch(proc, rng, ("image", "image_audio", "image", "image_audio")),
            m2_train_batch(proc, rng, ("video",) * M2_TRAIN_BATCH)]


def frozen_checksums(state) -> dict:
    """An exact reading of every frozen master: the sum of its fp32 bit
    patterns as int64."""
    frozen = [n for n in state.params if n not in set(state.trainable)]
    return {n: int(state.params[n].view(torch.int32).sum(dtype=torch.int64).item())
            for n in frozen}


def m2_train_updates(step, state, batches, updates: int):
    """``updates`` optimizer updates (one micro-step a batch of ``batches``):
    per update the host ms ending in ``synchronize``, the launches and the
    losses."""
    update_ms, counts, losses = [], [], []
    for _ in range(updates):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            state, scalars = step(state, batch)
            losses.append(scalars["total_loss"])
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
    return state, update_ms, counts, [float(x) for x in losses]


def m2_train_full_depth(gpu: str) -> dict:
    """Phase 20 (a)–(b). (a) ``m2_omni_7b.yml``'s model under the recipe at
    full width and depth, seeded on the card: M2_TRAIN_WARMUP updates (the
    path's launches counted), M2_TRAIN_TIMED timed and M2_TRAIN_PROFILED
    profiled (busy and idle share, device ops, the flash family's ms), peak
    memory, the optimizer state's bytes; finite losses, the trainable
    masters moved and every frozen one bit-unchanged. (b) one more update of
    B=1 micro-batches over a conversation with a 16-frame video (2,048 video
    slots of 2,304), so the LM loss takes its chunked path, its peak
    memory. Returns the launches of (a)'s warm-up and of (b)."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shell, state, step = config_model(M2_OMNI_7B, m2_train_opts(), on_device=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state.params.values())
    n_trainable = sum(state.params[n].numel() for n in state.trainable)
    frozen_before = frozen_checksums(state)
    trainable_before = {n: state.params[n].clone() for n in state.trainable}
    t1 = time.perf_counter()
    batches = [shell.to_device(b) for b in m2_train_batches()]
    batch_s = time.perf_counter() - t1
    state, warm_ms, warm_counts, warm_losses = m2_train_updates(step, state, batches,
                                                                 M2_TRAIN_WARMUP)
    path = {k: sum(c[k] for c in warm_counts) for k in NO_LAUNCHES}
    state, update_ms, counts, losses = m2_train_updates(step, state, batches, M2_TRAIN_TIMED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, prof_ms, _, prof_losses = m2_train_updates(step, state, batches,
                                                          M2_TRAIN_PROFILED)
    busy, n_ops, top = device_busy(prof, M2_TRAIN_PROFILED)
    flash_ms = sum(ms for name, ms in device_ms_by_name(prof, M2_TRAIN_PROFILED)[0].items()
                   if "flash_" in name)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    opt_bytes = state.optimizer_state_bytes()
    frozen_same = frozen_checksums(state) == frozen_before
    moved = sum(not torch.equal(state.params[n], t) for n, t in trainable_before.items())
    del trainable_before
    positions = sum(int(b["input_mask"].sum().item()) for b in batches)
    supervised = sum(int((b["labels"][:, 1:] >= 0).sum().item()) for b in batches)
    upd_p50 = float(np.percentile(update_ms, 50))
    all_losses = warm_losses + losses + prof_losses
    emit(phase="m2_train", part="full_depth", gpu=gpu, batch=M2_TRAIN_BATCH,
         accumulation=M2_ACCUM, seq_len=SERVING_SEQ_LEN, setup_s=setup_s, batch_build_s=batch_s,
         params=n_params, trainable_params=n_trainable, trainable_tensors=len(state.trainable),
         optimizer_state_bytes=opt_bytes, losses=all_losses, warmup_update_ms=warm_ms,
         update_p50_ms=upd_p50, update_p95_ms=float(np.percentile(update_ms, 95)),
         update_ms=update_ms, tokens_per_s_all_positions=positions * 1e3 / upd_p50,
         tokens_per_s_supervised=supervised * 1e3 / upd_p50,
         profiled_update_ms=prof_ms,
         device_busy_ms_per_update=busy if n_ops else "not measured",
         device_idle_share=1 - busy / upd_p50 if n_ops else "not measured",
         flash_device_ms_per_update=flash_ms if n_ops else "not measured",
         device_ops_per_update=n_ops, top_device_ops_ms=top, peak_mem_gb=peak_gb,
         launches_per_update=counts[0], frozen_masters_unchanged=frozen_same,
         trainable_tensors_moved=moved, seconds=time.perf_counter() - t0)
    check(all(np.isfinite(all_losses)), f"m2_train: losses {all_losses}")
    check(all(c == M2_UPDATE_LAUNCHES for c in warm_counts + counts),
          f"m2_train: launches per update {counts[:1]}; expected {M2_UPDATE_LAUNCHES}")
    check(frozen_same, "m2_train: a frozen master changed")
    check(moved == len(state.trainable), f"m2_train: {moved} of {len(state.trainable)} "
                                         f"trainable tensors moved")
    check(opt_bytes == 10 * n_trainable and n_trainable < 0.02 * n_params,
          f"m2_train: optimizer state {opt_bytes} bytes for {n_trainable} trainable of "
          f"{n_params} parameters")
    check(next(shell.module.parameters()).is_cuda, "m2_train: the model is not on the card")
    # (b) the chunked LM loss: B=1, (L - 1)·V past 2^28 logits
    t1 = time.perf_counter()
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    proc = m2_train_processor(M2_LONG_SEQ_LEN)
    rng = np.random.default_rng(SEED + 31)
    rows = proc.max_seq_length
    long_rows = [m2_train_row(proc, rng, "video", M2_LONG_FRAMES) for _ in range(M2_ACCUM)]
    long = [shell.to_device({k: v[None] for k, v in r.items()}) for r in long_rows]
    slots = [int(b["input_mask"].sum().item()) for b in long]
    chunked = (rows - 1) * shell.module.vocab_size > 2 ** 28
    state, long_ms, long_counts, long_losses = m2_train_updates(step, state, long, 1)
    emit(phase="m2_train", part="chunked_loss", gpu=gpu, batch=1, seq_len=rows,
         video_frames=M2_LONG_FRAMES, live_slots=slots, chunked_path=chunked,
         update_ms=long_ms[0], losses=long_losses, launches=long_counts[0],
         mem_before_gb=base_gb, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t1)
    check(chunked and all(np.isfinite(long_losses)) and min(slots) > 2048,
          f"m2_train chunked: {slots} slots, losses {long_losses}")
    check(long_counts[0] == {k: 2 * m2_train_launches(M2_LAYERS, False)[k] for k in NO_LAUNCHES},
          f"m2_train chunked: launches {long_counts[0]}")
    check(frozen_checksums(state) == frozen_before, "m2_train: a frozen master changed")
    del shell, state, step, long
    gc.collect()
    torch.cuda.empty_cache()
    return {k: path[k] + long_counts[0][k] for k in NO_LAUNCHES}


def m2_train_twins(seed: int):
    """Phase 20 (c)'s models at full width and M2_TRAIN_CUT depth, frozen as
    the recipe freezes them: bf16 on the card, seeded on the card with every
    ``lora_b`` drawn from N(0, 0.02); its masters exported in the stacked
    layout and read back through the bridge into the card's state and an
    fp32 CPU twin (plain versions). Returns (card, card state, CPU, masters,
    a B=1 image + audio + text batch)."""
    card, state, _ = config_model(M2_OMNI_7B, m2_train_opts(*M2_TRAIN_CUT), seed=seed,
                                  on_device=True)
    gen = torch.Generator(device=next(iter(state.params.values())).device).manual_seed(seed)
    for name, t in state.params.items():
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=gen)
    stacked = export_flax_variables(card.module, state)["params"]
    masters = flax_to_masters(card.module, stacked)
    load_masters(state, masters)
    cpu, _, _ = config_model(M2_OMNI_7B, m2_train_opts(*M2_TRAIN_CUT), device="cpu",
                             dtype="float32", masters=masters)
    proc = m2_train_processor(SERVING_SEQ_LEN)
    batch = m2_train_batch(proc, np.random.default_rng(seed + 41), ("image_audio",))
    return card, state, cpu, masters, batch


def m2_train_faults(card):
    """Faults planted on the card's model only, each undone after its step:
    (name, plant, undo). The decoder's LoRA scaling doubled; the vision
    tokens detached before the splice (no gradient reaches the tower's
    adapters or vision_proj); the audio convolutions padded (1, 1)."""
    from antmmf_torch.models import m2_omni as m2_mod

    module = card.module
    adapted = [m for m in module.decoder.modules() if getattr(m, "lora_targets", ())]
    real_pad = m2_mod._same_pad

    def scaling(factor):
        for m in adapted:
            m.lora_scaling *= factor

    def detach_vision():
        real = type(module)._vision_tokens.__get__(module)
        module._vision_tokens = lambda images: (lambda t, p: (t.detach(), p))(*real(images))

    return [("lora_scaling_doubled", lambda: scaling(2.0), lambda: scaling(0.5)),
            ("vision_tokens_detached", detach_vision,
             lambda: module.__dict__.pop("_vision_tokens")),
            ("audio_conv_padded_1_1", lambda: setattr(m2_mod, "_same_pad", lambda n: (1, 1)),
             lambda: setattr(m2_mod, "_same_pad", real_pad))]


def m2_train_within_bound(res) -> bool:
    return res["abs_dloss"] <= M2_TRAIN_DLOSS_MAX and res["grad_cos_all"] >= M2_TRAIN_COS_ALL \
        and res["grad_cos_min"] >= M2_TRAIN_COS_MIN


def m2_train_readings(seed: int, faults: bool) -> dict:
    card, state, cpu, masters, batch = m2_train_twins(seed)
    ref = pink_first_step(cpu, batch)
    out = {"sound": compare_steps(pink_first_step(card, batch), ref)}
    for name, plant, undo in (m2_train_faults(card) if faults else ()):
        plant()
        try:
            out[name] = compare_steps(pink_first_step(card, batch), ref)
        finally:
            undo()
    del card, state, cpu, masters
    gc.collect()
    torch.cuda.empty_cache()
    return out


def calibrate_m2_train(seeds=3) -> None:
    """Phase 20 (c)'s readings: sound seeds, then planted faults at the last."""
    for seed in range(seeds):
        for name, res in m2_train_readings(seed, seed == seeds - 1).items():
            emit(phase="calibrate_m2_train", kind="sound" if name == "sound" else "fault",
                 fault=None if name == "sound" else name, seed=seed, **res,
                 within_bound=m2_train_within_bound(res))
    emit(phase="calibrate_m2_train", kind="bound", dloss_max=M2_TRAIN_DLOSS_MAX,
         grad_cos_all=M2_TRAIN_COS_ALL, grad_cos_min=M2_TRAIN_COS_MIN)


def m2_train_card_vs_cpu() -> None:
    """Phase 20 (c): the reading at seed 0 within the bounds, each planted
    fault outside them."""
    t0 = time.perf_counter()
    readings = m2_train_readings(SEED, True)
    faults = {n: r for n, r in readings.items() if n != "sound"}
    caught = {n: not m2_train_within_bound(r) for n, r in faults.items()}
    emit(phase="m2_train", part="card_vs_cpu", batch=1, layers=M2_TRAIN_CUT[0],
         vit_blocks=M2_TRAIN_CUT[1], **readings["sound"], faults=faults, faults_caught=caught,
         seconds=time.perf_counter() - t0,
         bounds=dict(dloss_max=M2_TRAIN_DLOSS_MAX, grad_cos_all=M2_TRAIN_COS_ALL,
                     grad_cos_min=M2_TRAIN_COS_MIN))
    check(m2_train_within_bound(readings["sound"]),
          "card and CPU M2-omni training steps disagree beyond the stated bound")
    check(all(caught.values()), f"m2_train: a planted fault passed the bound: {caught}")


def phase_m2_train(gpu: str) -> dict:
    """Phase 20: (a)–(b) at full width and depth, (c) card vs CPU with planted
    faults at cut depth. Returns the launches of (a)'s warm-up and (b)."""
    t0 = time.perf_counter()
    counts = m2_train_full_depth(gpu)
    m2_train_card_vs_cpu()
    emit(phase="m2_train", part="summary", seconds=time.perf_counter() - t0, launches=counts)
    return counts


SOURCES = {
    "small_attention": ("antmmf_torch/ops/csrc/small_attention.cu",
                        "antmmf_tpu/ops/pallas/small_attention.py:62"),
    "flash_fwd": ("antmmf_torch/ops/csrc/flash_attention.cu",
                  "antmmf_tpu/ops/pallas/flash_attention.py:385"),
    "flash_dq": ("antmmf_torch/ops/csrc/flash_attention.cu",
                 "antmmf_tpu/ops/pallas/flash_attention.py:434"),
    "flash_dkv": ("antmmf_torch/ops/csrc/flash_attention.cu",
                  "antmmf_tpu/ops/pallas/flash_attention.py:460"),
    "int4_gemv": ("antmmf_torch/ops/csrc/int4_gemv.cu",
                  "antmmf_tpu/ops/pallas/int4_matmul.py:240"),
}


def main() -> None:
    clock = [("start", time.perf_counter())]  # (phase, when it ended)

    def done(name: str) -> None:
        clock.append((name, time.perf_counter()))

    gpu = gpu_line()
    emit(phase="card", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    done("1_build")
    errs = {"small_attention": phase_kernels(), **phase_flash(), "int4_gemv": phase_int4()}
    done("2_kernels")
    rng = np.random.default_rng(SEED)
    zero_counts()
    predictors, serving = phase_serving(rng)
    check(not any(fn.launches for fn in KERNELS[1:]),
          "UniVL serving launched a kernel it has no use for")
    check(serving > 0, "the serving path never launched the kernel")
    done("3_serving")
    phase_card_vs_cpu(predictors[0], rng)
    done("4_serving_card_vs_cpu")
    launches, pair_bias, bare_p50 = phase_training(gpu)
    launches["small_attention"] += serving
    done("5_training")
    phase_train_card_vs_cpu()
    done("6_training_card_vs_cpu")
    walls, timing = phase_times(predictors, rng, gpu)
    text = torch.as_tensor(pretrain_batch(PRETRAIN_BATCH, SEED + 1)["caption_input_mask"]).cuda()
    pretrain_bias = make_attention_mask(torch.cat(
        [text, torch.ones(PRETRAIN_BATCH, FRAMES * VIT_TOKENS, dtype=text.dtype, device="cuda")], 1))
    lens = torch.as_tensor(np.random.default_rng(SEED + 6).integers(8, TEXT_LEN + 1, STAGE2_CHUNK))
    stage2_text = (torch.arange(TEXT_LEN)[None] < lens[:, None]).long().cuda()
    stage2_bias = make_attention_mask(torch.cat([stage2_text, torch.ones(
        STAGE2_CHUNK, FRAMES * VIT_TOKENS, dtype=stage2_text.dtype, device="cuda")], 1))
    timing = {"small_attention": timing, **phase_flash_times(
        {"cross_mined": pair_bias, "pretraining": pretrain_bias}, gpu,
        {"stage2_chunk_32": stage2_bias})}
    done("7_times")
    phase_trace(walls, gpu)
    del predictors, walls
    done("8_trace")
    pink, pink_launches = phase_pink(rng, gpu)
    for name, n in pink_launches.items():
        launches[name] += n
    done("9_pink")
    phase_pink_card_vs_cpu(pink, rng)
    done("10_pink_card_vs_cpu")
    timing["int4_gemv"] = phase_int4_times(pink, gpu)
    done("11_int4_times")
    for name, n in phase_engine(pink, gpu).items():
        launches[name] += n
    done("11b_engine")
    for name, n in phase_decoding(pink, gpu).items():
        launches[name] += n
    del pink
    gc.collect()
    torch.cuda.empty_cache()
    done("11c_decoding")
    launches["small_attention"] += phase_trainer(gpu, bare_p50)
    done("12_trainer")
    for part, phase in (("13_pretraining", phase_pretraining),
                        ("14_retrieval_variants", phase_retrieval_variants),
                        ("15_task_heads", phase_task_heads), ("16_roi", phase_roi),
                        ("17_pink_train", phase_pink_train), ("18_pink_7b", phase_pink_7b),
                        ("19_m2_omni", phase_m2_omni), ("20_m2_train", phase_m2_train)):
        for name, n in phase(gpu).items():
            launches[name] += n
        done(part)
    emit(phase="timeline", seconds={name: t - clock[i][1] for i, (name, t) in
                                    enumerate(clock[1:])},
         total_s=clock[-1][1] - clock[0][1])

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": errs[name], **timing[name]} for name in SOURCES]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


CALIBRATIONS = {"serving": calibrate, "training": calibrate_training, "pink": calibrate_pink,
                "pretraining": calibrate_pretraining, "dmae": calibrate_dmae,
                "task_heads": calibrate_task_heads, "roi": calibrate_roi,
                "pink_train": calibrate_pink_train, "pink_7b": calibrate_pink_7b,
                "m2_omni": calibrate_m2_omni, "m2_train": calibrate_m2_train,
                "engine": calibrate_engine, "decoding": calibrate_decoding}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--calibrate"] and set(sys.argv[2:]) <= set(CALIBRATIONS):
        for part in sys.argv[2:] or CALIBRATIONS:
            CALIBRATIONS[part]()
    elif sys.argv[1:]:
        sys.exit(f"usage: python3 chip_smoke.py [--calibrate [{'|'.join(CALIBRATIONS)} ...]]")
    else:
        main()
