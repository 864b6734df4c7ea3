"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_DIR   # K1/K3/K4/K6, phase 4/4b and
                                            # server legs, parent vs this
    python3 chip_smoke.py --phase7          # phases 1, 2 and 7 alone (no
                                            # result line)
    python3 chip_smoke.py --phase8          # phases 1, 2 and 8 alone (no
                                            # result line)
    python3 chip_smoke.py --phase9          # phases 1, 2 and 9 alone (no
                                            # result line)
    python3 chip_smoke.py --phase10         # phases 1, 2 and 10 alone (no
                                            # result line)
    python3 chip_smoke.py --phase11         # phases 1, 2 and 11 alone (no
                                            # result line)
    python3 chip_smoke.py --phase12         # phases 1, 2 and 12 alone (no
                                            # result line)
    python3 chip_smoke.py --phase13         # phases 1, 2 and 13 alone (no
                                            # result line)

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and a measured
   device-to-device copy rate;
2. build: the kernels of ``neural_tpu_torch/csrc`` from source, one nvcc
   per source, all at once;
3. kernels: each kernel (K1 at M=1 and 8, K2, K3 and K4 in their bf16
   and int8 variants, K6 paged decode in both) against its plain PyTorch
   version on the same CUDA tensors at the Llama-2-7B q4_j main-path
   shapes, with its time, the plain version's time, one library call's
   time (a yardstick the port never calls: ``torch.matmul``,
   ``scaled_dot_product_attention``, or a compiled ``flex_attention``
   where the softcap or a window applies) and its bound; K1 (M=1 and 8)
   and K2 (M=1975) also at Gemma-2-9B's widths; K3, K4 and K6 also at
   Gemma-2-9B's heads (16 over 8, head dim 256, softcap 50) with window
   4096 and 0 at fill or prompt 6000, K3 on a 1975-token prompt, K6 at
   batch 8 with mixed fills, and at head dim 128 with the softcap and a
   window (K4 and K3 must be faster with the window than without); then
   the ALiBi branches of K3 (Bloom-7B1's 1975-token prefill, 32 heads),
   K4 (fills 1975 and 128) and K6 (B=8, mixed fills) and K3's GLM prefix
   branch (ChatGLM-6B's 1975-token prefill, all of it the prefix), bf16
   and int8, each also timed with its option off and held against a
   compiled ``flex_attention`` with the same score_mod / mask_mod; K3 also
   at the server's 512-token chunk at position 1024 of 2048; K6 also over
   pages of 16 and 32 keys, over a table whose entries past each fill
   point at other rows' live pages (the rows past each fill holding large
   finite K/V), and over an identity table on K4's own cache against K4
   (the two times side by side); every K1/K3/K4/K6 case printed beside the
   time of the kernel it replaces (``ATTN_BEFORE_MS``, ``K16_BEFORE_MS``)
   and the slower ones listed; then
   K5 on both of its routes, each launch counted under its route
   (``qmm_general+gemv`` at M <= 16, ``qmm_general+tc`` above): nf4 at
   M=1, 8 and 1975, q4_0 at 1975, q4_j at 128, 64, 32 and 24, fp4, fp8
   e4m3/e5m2, int1 and bit-plane int3 asym at 1, and every layout (with
   native-pack nibbles and int2, and int8 codes) again at M=1 and 128,
   each case printed beside the PR 1-7 time it replaces; K1's other
   entry points (asym nibbles, int2 and int8 codes, sym and asym) at M=1
   and 8, and K2-asym at 1975, the same way, and every K2 entry point's
   largest difference from its plain version on one 7B product beside the
   parent tree's (``k2_errors``, ``PARENT_K2_ERR``); K1's fusion options (the
   RMS-norm and glu prologues, the residual epilogue) at M=1 and 8 over
   the three sym layouts, at the 7B's widths and at Gemma-2-9B's with the
   (1 + w) norm and tanh GELU, each also timed against the unfused chain
   it replaces (the port's ``rms_norm`` / ``act(g) * u`` / bf16 add and
   K1); every K1 entry point launched twice on the same inputs, the two
   outputs bit-identical, and the fused rms route against the unfused
   chain (their largest difference logged); the row-norm kernel
   (``rms_norm.cu``, the unfused graph's RMS norm on K1's row-scale
   routine) against the torch chain at a decode step's rows and a
   prefill's, beside ``torch.nn.functional.rms_norm``;
4. generation: a Llama-2-7B-shaped q4_j model (random weights from a seed,
   FFN 11008 padded to 11264) generates greedily through ``Model.generate``
   with bf16 and with int8 KV, every launch count set to 0 just before each
   path and read just after; ``decode_loop``'s CUDA graph against eager
   steps; decode ms/token (slope of ``decode_loop`` n=4 vs n=36) at fills
   128 and 1975 (bf16 KV), at fill 1975 with int8 KV (leg decode_i8kv) and
   at batch 8, fill 128, int8 KV (leg batch8); the 1975-token prefill time
   (TTFT) with bf16 and int8 KV; the fused decode path's A/B on the same
   model: ``Model.generate`` and ``decode_loop`` unfused, fused and fused
   with GLU (``NTPU_FUSED_DECODE``, ``NTPU_FUSE_GLU``), ids against the
   unfused ones where the margin proves them, every K1 launch of a fused
   step through a fused entry point; the decode step's CUDA graph at fills
   128 and 1975, bf16 and int8 KV, and at batch 8, each captured in the
   three modes and replayed in turns, device-timed; the host-clock legs
   and the TTFT by mode; then (4b) the same model at nf4, q4_0 and
   q4_j_i8_g128, one at a time: ``Model.generate``, the TTFT and decode
   ms/token at fill 128, each a path with its own launch counts; then
   (4c) Gemma-2-9B at full depth, q4_j (random weights from a seed):
   ``Model.generate`` with bf16 and int8 KV, decode ms/token at fills 128
   and 6000 (bf16 KV) and 6000 (int8 KV), TTFT at 1975 and 6000 tokens,
   caches of 8192 positions, each a path with its launch counts; (4d)
   Bloom-7B1 at full depth (``bigscience/bloom-7b1``'s config, q4_j,
   random weights): ``Model.generate`` with bf16 and int8 KV, decode at
   fills 128 and 1975, TTFT at 1975 tokens, peak memory; (6b, run while its
   weights are loaded) its batch-8 paged int8 ``ModelServer`` over phase
   6's 12 queries, and a short paged bf16 run; (4e) ChatGLM-6B at full
   depth (``THUDM/chatglm-6b``'s config): ``Model.generate`` with bf16 and
   int8 KV, decode at fill 128, TTFT at 1975 tokens, all of it the prefix;
   and (4i, right after phase 4, on its 7B) the sampling slice:
   ``Model.generate(do_sample=True, top_k=40, top_p=0.95, temperature=0.8)``
   on a 512-token prompt with one seed twice (ids equal) and another (ids
   differ); ``sample_loop``'s graphed step (replays from one pinned state
   draw different ids, a seed fixes the ids) and its device ms a step at
   fill 128, batch 1 and 4, replayed in turns with ``decode_loop``'s
   greedy graph; four ragged prompts (128, 512, 1024, 1975
   tokens, 32 new each) through one padded prefill and a batched decode,
   their ids against the row-wise ones where the margins prove them;
   ``num_beams=4`` on a 128-token prompt, one beam step's device-clock
   time and ``reorder_batch``'s;
   ``streaming=True`` over a 512-position cache (bf16 and int8 KV, 600 new
   tokens, two shifts) and the shift's time; ``sample_batched``'s and
   ``sample``'s draws over one 32000-wide row in 4096 rows against the
   filtered softmax (chi-square) and the sampler's device times. Phase 4 also holds C5:
   the fused decode path's logits equal the unfused ones exactly, and the
   fused rms prologue equals the norm kernel then K1 over the 7B's own
   residual rows;
5. card vs plain: a one-layer copy at the same width runs its prefill logits
   and greedy steps through the kernels and through the plain path on the
   card's own tensors (``plain_on_card``, as every copy of phases 5-5d
   since PR 19; the plain path on the host's CPU took three and a half
   minutes), and the card's fused path (with and without GLU) against the
   same plain rows; then the same through the Scheduler (paged
   int8 KV, batch 4, 6 requests); then, for fp4, fp8, fp8_e5m2, int1,
   int2, int2 asym, int3, int5, int5 asym, q8_0 and int8 (per channel),
   ``Model.generate`` on the card (a
   path each) and its logits against the plain path on the card's own
   tensors (``plain_on_card``); logits within
   tolerance, greedy ids equal where the margin proves it (the formats'
   copies have one layer); (5b) a 2-layer
   Gemma-2-9B copy with its window cut to 32 (so that it acts on every
   prompt there): ``Model.generate`` on the card, its logits against the
   plain path, and the paged int8 Scheduler check; (5c) one-layer full-width
   copies of Bloom-7B1, MPT-7B and ChatGLM-6B (100-token prompts, bf16
   activations, tolerance 2e-2·max|logit|) the same way, and the paged
   int8 Scheduler check on the Bloom copy; on phase 5's copy also beam
   search (4 beams) against the plain path, the first StreamingLLM shift
   (bf16 and int8) of the plain path's cache on the card against the same
   shift on the host's CPU, and a copy with a 32001-wide
   quantized lm_head through the counted ``qmm_plain`` route (K1 and K5
   refuse it) against the plain path; and through the Scheduler a beam
   group (slots bf16, paged int8; the plain run forced to the card's beams,
   every
   expansion's logits rows held to the card's and its choices proven
   where the margins allow), graphed StreamingLLM slots through their
   first shift (ids by the margins, each card shift against the plain
   shift of the same row) and decode blocks (equal to the card's single
   steps);
   Then (4f) Mistral-7B as a GPTQ int4 act-order checkpoint (its state
   dict synthesized on the host, converted on the card by
   ``params_from_gptq_state_dict``): ``Model.generate`` with bf16 and
   int8 KV, decode at fills 128 and 1975, TTFT at 1975 tokens with bf16
   and int8 KV, peak memory, the act-order gather timed alone; (4g)
   Llama-2-7B at q6_sym_g128_a8 and mix_i2_ffn as phase 4b's formats,
   each also generating with the fused path and GLU on;
   (4h) TinyLlama-1.1B (head dim 64: ``attend_xla``, no K3/K4/K6 launch)
   through ``Model.generate``, the paged int8 Scheduler, decode at fill
   128, TTFT; (5d) one-layer copies against the plain path: Mistral
   GPTQ (``Model.generate``, the paged int8 Scheduler, and the copy
   written as a checkpoint directory and loaded with ``Model.init(dir,
   use_gptq=True)``), AWQ, mix_int2_int4, every K2 layout at act_bits 8,
   linear RoPE scaling, TinyLlama, and 32 heads over 2 (G = 16); a copy
   with StarCoder's 48 heads over 1 on the card alone. Phase 3 also holds
   K2 over int8 codes, int2 and int3 (sym and asym), K1-asym and K5 at
   Mistral GPTQ's widths, and K4/K6 at G = 16 and 48 against their plain
   versions.
6. serving: the same 7B model behind ``ModelServer(max_batch=8,
   max_len=2048, kv_mode="paged", page_size=256, memory_dtype="int8")``
   answers 12 queries (prompts of 32-1500 tokens, 32 new tokens each) with
   launch counts; the graphed decode step against the same steps run
   eagerly (ids and pool bytes), also with the fused path on (with and
   without GLU, the graph's K1 launches all fused); short slots-mode bf16
   and paged bf16 runs;
   aggregate tok/s, decode-iteration ms at 8 running slots, TTFT; then
   (6c) serving beyond greedy on the same model: the paged int8 server
   answers 12 mixed queries (greedy, sampled, mirostat v2, a 4-beam query
   on a 128-token prompt): greedy ids equal a greedy-only run's; the
   beam query teacher-forced: its logits rows at every expansion equal to
   the bit to an eager Scheduler's with a plain host-staged KV copy, and
   within 0.1·max|logit| of ``beam_search``'s, a run with its reorders
   skipped failing that hold; the mix through the Scheduler with one seed
   twice and another; StreamingLLM slots (512 positions, bf16 and int8
   KV, 8 queries × 600 new tokens, two shifts a slot): query 0's rows
   within 0.1·max|logit| of a batch-1 stream fed its ids, equal to the
   bit to an eager Scheduler's through the first shift, its ids against
   ``stream_generate`` by the margins; decode
   blocks of 8 against single steps; tok/s, the decode iteration with and
   without a beam group, and the page reorder, slot reorder and per-slot
   shift timed alone.

7. model files (under ``.chip_scratch/phase7``, each file removed after
   its leg; the free disk space printed first, the phase failing when it
   is short): (7a) Llama-2-7B as a llama.cpp Q4_0 GGUF file at full depth
   (random block bytes with finite fp16 scales, a Q6_K lm_head, a
   32000-piece SPM vocabulary) through ``Model().init_from_bin``: load
   seconds, the route counts (every decode projection on K1 at the
   unpadded 11008, the prefill on K5's tiles, the Q6_K lm_head on K5's
   GEMV), TTFT at 1975 tokens, the decode step's graph replay at fills
   128 and 1975 and the host slope at 128, K1, K5's GEMV and K5's tiles
   on the file's own tensors against their plain versions,
   ``generate_text``, ``generate(session_file=...)`` twice (the resumed
   greedy ids equal) and on the prompt plus 64 tokens with and without the
   saved prefix, ``ModelServer(model_path=...)`` (paged int8, batch 8, 8
   queries, tok/s), and ``save()`` to NTPU and ``init_from_bin`` of it
   (every tensor byte-equal, greedy ids over 32 tokens equal); (7b) each
   of the ten ggml types as a 2-layer full-width file with a constant
   group: ``Model.generate`` on the card, then the prefill's last logits
   of a 32-token prompt and 8 teacher-forced steps against the plain path
   on the card's own tensors (``plain_on_card``; 2e-2·max|logit|), each
   type's routes and decode step, and K5's GEMV at group 16 on Q2_K/Q3_K/
   Q6_K weights; (7c) a 4-layer Llama-2-7B-wide bf16 directory (two
   shards and an index) converted at q4_j by ``Model.init`` in a child
   process: seconds, the resident set's rise and the numpy host buffers'
   peak against one layer's f32 bytes, a prefill on K2 and a decode on
   K1, every tensor equal to the CPU's conversion of the same directory.

8. the dense model zoo (random weights from seeds, each config written as
   literals naming the published config it copies): (8d) the kernels at
   the shapes these families give them, each against its plain version
   with its time, the plain version's, one library call's (``sdpa``,
   ``torch.matmul``) and its bound: K4 at fill 1975 and K6 at B=8 with
   mixed fills at G = 7 (Qwen2-7B's 28 heads over 4), K3 on a 1975-token
   prompt and K4 at fill 1975 at head dim 256 with one KV head per query
   head (GPT-J-6B), bf16 and int8 each; K3 and K4 with ALiBi at
   Baichuan-13B's 40 heads; K1 on Qwen2-7B's 3584 × 152064 lm_head at
   M=1; K5's tiles at M=1975 on Falcon-7B's 4544 × 4544 and 4544 × 18432
   q4_0 products; (8a) Qwen2-7B at full depth, q4_j (FFN 18944 padded to
   19456): ``Model.generate`` with bf16 and int8 KV, decode ms/token at
   fills 128 and 1975 (bf16) and 1975 (int8), TTFT at 1975 tokens (bf16,
   int8), the batch-8 paged int8 ``ModelServer`` over phase 6's 12
   queries (tok/s, its K6 launches), peak memory; (8b) GPT-J-6B at full
   depth, q4_j, the same legs but the server, the cache capped at its 2048
   positions; (8c) one-layer full-width copies of SOLAR-10.7B, Qwen-7B
   (v1), Baichuan2-7B, Baichuan-13B (ALiBi, 40 heads), StableLM-3B,
   Pythia-6.9B, GPT-NeoX-20B, ChatGLM3-6B, Phi-2, Phi-3-mini-4k,
   Falcon-7B (q4_0: its 4544 is no multiple of 128), Falcon-40B, OPT-6.7B,
   StarCoder and GPT-J-6B: ``Model.generate`` on the card (a path each,
   100-token prompt), then the prefill's last logits and 3 teacher-forced
   steps against the plain path on the card's own tensors
   (``plain_on_card``, 2e-2·max|logit|), greedy ids held where the margins
   prove them, the copies
   at head dims 64-96 launching no K3/K4/K6; and phase 5's paged int8
   Scheduler check on the GPT-J copy (parallel residual) and the OPT copy
   (learned positions), its plain side on the card too. 8d's cases join
   their kernels' cases in the kernels line.

9. mixture-of-experts (random weights from seeds, each config written as
   literals naming the published config it copies; every expert's
   products through K1/K2/K5, the router a bf16 product): (9d) the kernels
   at the MoE's shapes, each against its plain version with its time, the
   plain version's, one library call's and its bound: K1 at M=1 and 8 on
   Mixtral-8x7B's expert products (4096 × 14336, 14336 × 4096) and on
   Grok-1's (6144 × 32768, 32768 × 6144), K2 at M=1975 on Mixtral's, K4 at
   fill 1975 and K6 int8 at B=8 at G = 4 (Mixtral) and G = 6 with softcap
   30 (Grok-1), K3 on a 1975-token prompt at G = 6 with softcap 30; (9a)
   Mixtral-8x7B at full width and depth, q4_j: ``Model.generate`` with
   bf16 and int8 KV, the launches and routes of a captured decode step
   (897 K1 launches: the dense mixture runs every expert) and of a
   1975-token prefill (896 on K2), decode ms/token at fills 128 and 1975
   on the device's clock (graph replay) beside the host slope, TTFT at
   1975 tokens, the batch-8 paged int8 ``ModelServer`` over phase 6's 12
   queries, peak memory; (9b) two-layer full-width copies of Mixtral-8x7B
   and Grok-1: ``Model.generate`` on the card, then the prefill's last
   logits and 3 teacher-forced steps against the plain path on the card's
   own tensors (2e-2·max|logit|), greedy ids held where the margins prove
   them; a bf16-expert Mixtral copy through the grouped path at a prefill
   (against the plain path) and in the Scheduler's captured batch-8 step
   (equal to the same step run eagerly); (9c) phase 5's paged int8
   Scheduler check on the Mixtral copy, its plain side on the card. 9d's
   cases join their kernels' cases in the kernels line.

10. tensor and expert parallelism: (10d) in this process, the kernels at
   one rank's shapes against their plain versions with their times, the
   plain versions', one library call's and their bounds: K1 at M=1 and 8
   and K2 at M=1975 on a Llama-2-7B tp=2 rank's products, K1 at M=1 and
   K2 at M=1975 on a Llama-2-70B tp=8 rank's (what each rank of
   BASELINE.md target 5 runs), K3 and K4 at 16 heads, bf16 and int8 KV;
   then two ranks spawned on the one card (NCCL refuses two ranks on one
   device, so gloo over 127.0.0.1),
   each agreeing on a checksum of the full weights before keeping its
   shards, each path's launches counted and printed per rank: (10a)
   Llama-2-7B q4_j at full width and depth, tp=2, ``Model.generate(mesh=
   ...)`` with bf16 and int8 KV, the prefill's last row and a step per
   generated id held bit for bit to one device computing the pair's
   products and sums; against the plain single device, the 7B's first 2,
   4 and 8 layers at full width (the gap printed a depth, the 2-layer copy
   within 2e-2·max|logit|, its argmax where the margins prove it) and at
   full depth the ids where the margins prove them, K1 225 and K2 224 launches a step and a prefill, the eager step's
   host time (two ranks sharing a card: no measure of TP across cards);
   (10b) Llama-2-70B's widths, two layers, tp=2: each rank's shard shapes
   pinned, the prefill's last row and one step within 2e-2·max|logit| of
   one device, the argmax equal where the margins prove it; (10c) the
   two-layer Mixtral-8x7B copy at tp=2 (the mixture's deferred sum) and
   ep=2 (capacity factor 8, nothing dropped) within 2e-2·max|logit| of one
   device, and the kernels the capacity buffers reach. 10d's cases join
   their kernels' cases in the kernels line.

11. the cache-less forward, ring attention and the training steps (the
   ranks of phase 10 go on to 11b-11d while 11a runs here; depth cut to 4
   layers of Llama-2-7B and 1 of Mixtral-8x7B for the time limit): (11a)
   in this process, the 4-layer Llama-2-7B q4_j's cache-less forward on a
   1975-token prompt (K2 on every product, ``attend_nocache``, no K3)
   within 2e-2·max|logit| of its cached prefill with the same f32
   attention over the cache, and of the cached prefill through K3 (bf16
   P) within 8e-2 (two routes), its argmax where the margins prove it; (11b) the
   same model's ``sequence_sharded_forward`` at sp = 2 on 2048 tokens
   (K2 at M = 1024 a rank, the ring's hops over gloo), held here against
   one device's cache-less forward: ``ring_attend`` alone on random q/k/v
   at the 7B's heads within 1e-5·max|out|; a one-layer copy, through K2
   and with its weights dequantized to bf16 (no K2, so none of K2's int8
   rounding of the activations), each within 2e-2·max|logit| and within
   2× one device's own gap when its attention's f32 output moves by one
   f32 step at half the elements (the least reordering); the 4 layers
   within 8e-2 and their argmax where the margins prove it; (11c)
   ``make_pp_train_step`` at pp = 2, Llama-2-7B widths, f32 params, B = 4,
   T = 256, 2 microbatches, and (11d) the sp × ep MoE training step on a
   one-layer Mixtral-8x7B, f32 params, at sp = 2 and at ep = 2 (capacity
   factor 8), each held on rank 0 against one device's autograd: the loss
   within 3e-2 relative, the updated ``embed``, a layer's ``wq`` and the
   ``lm_head`` (11d: the router and the local experts' ``w_up`` too)
   within atol 5e-3, rtol 5e-2, and the gradients they moved by within
   5e-2·max|gradient|; no hand-written kernel launched in any training
   leg (counted); whether ``aten::mm.dtype`` has a derivative; each rank's
   peak memory; every time on the host clock beside the card's name and
   power limit. 11a/11b's K2 launches join K2's paths in the kernels line.

12. Whisper (random f32 weights from seeds at openai/whisper-large-v3's
   published widths: d_model 1280, 20 heads, 32 + 32 layers, FFN 5120, 128
   mels, vocab 51866; f32 activations): phase 3 also holds K2 with f32 x
   (q4_j; its activation codes bit-equal to the plain version's) and K5's
   tiles (q4_0) on the encoder's and the cross K/V's products at M = 1500,
   and K1 on a decoder step's at M = 1 (q4_j, q4_0) and M = 5 (a beam-5
   step), f32 out, each against its plain version with its times and bound
   (12d runs them under ``--phase12``); (12a) large-v3 at full depth at q4_j
   (K2 + K1) and q4_0 (K5 + K1): ``transcribe_file`` of a seeded 20 s
   16 kHz WAV written with stdlib ``wave``, a path each with its launch
   counts (256 window products, 256 K1 launches a token), its real-time
   factor, the encoder's device ms a window beside the conv stem's and
   ``_mha``'s, a greedy step's and a beam-5 step's device ms,
   ``detect_language``, the timestamps path and a 5-beam transcription once
   each; (12b) 2 + 2-layer copies at the same widths against the plain path
   on the card's own tensors (encoder states and 8 teacher-forced rows
   within 2e-2·max|·|, argmax where the margins prove it), and the card run
   again with the TF32 switches at PyTorch's defaults and both on, bit-equal
   to the run with them off; (12c) ``eval.perplexity`` over 1024 seeded
   tokens (ctx 512, stride 256, batch 2) on a 2-layer Llama-2-7B-width q4_j
   copy through ``batch_logits`` (K2, K3) within 1e-2 relative of the plain
   route, ``score_choices`` the same on both, and one ``maybe_trace`` of a
   ``Model.generate`` at ``NEURAL_TPU_VERBOSE=2`` with its top device ops.
   12d's cases join their kernels' cases in the kernels line.

13. f32 parameters at rest and f32 KV caches (``dtype="float32"``,
   ``kv_dtype="float32"``), the command-line tools and the accuracy gate:
   (13c, in phase 3) K4's, K3's and K6's f32-cache branches at Llama-2-7B's
   heads (K4 at fill 1975, K3 on a 1975-token prompt, K6 at batch 8 with
   the server's mixed fills), each bit-equal to its bf16 branch over the
   same values rounded (an f32 cache holding bf16 values, and one off the
   bf16 grid), held to its plain version, with its time, the bf16 branch's,
   the plain version's, ``scaled_dot_product_attention``'s over the same
   f32 tensors and its bound at 4 bytes a K or V element (13d runs them
   under ``--phase13``); (13a) Llama-2-7B q4_j at full depth loaded with
   f32 parameters (the embedding and the norms f32, every norm weight
   redrawn off the bf16 grid): ``Model.generate`` of a 1975-token prompt
   (K1, K2, K3, K4 counted), and a 2-layer copy against the plain path on
   the card's own tensors (5e-2·max|logit|, phase 5's); (13b) the batch-8
   ``ModelServer(kv_dtype="float32")`` over a paged pool (K6, K3 through
   the page gather) and with ``kv_mode="slots"`` (K4, K3), 8 queries of
   32-1500 tokens: greedy ids and every token's f32 logits row bit-equal to
   the same server over a bf16 pool; StreamingLLM slots over an f32 cache
   on the 2-layer copy through their shift, against the plain path;
   (13d) every command-line tool (``python -m neural_tpu_torch.cli.*``) on
   2-layer 7B-width files written here (a Q4_0 GGUF with a vocabulary, an
   f32 NTPU file, a bf16 HF directory; a 2 + 2-layer large-v3-wide Whisper
   directory), one process each, all started together: exit 0, and
   ``accuracy`` refusing, naming lm-eval, where the package is absent; the
   accuracy gate's PPL ratios printed.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is present.
"""
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert import checkpoint as PC  # noqa: E402
from neural_tpu_torch.convert import gguf as GG  # noqa: E402
from neural_tpu_torch.convert.gguf_models import \
    random_block_bytes  # noqa: E402
from neural_tpu_torch.convert.gptq import \
    params_from_gptq_state_dict  # noqa: E402
from neural_tpu_torch.convert.hf import (ffn_padded_size,  # noqa: E402
                                         init_random)
from neural_tpu_torch.convert.quant_registry import \
    QuantRegistry  # noqa: E402
from neural_tpu_torch.core.dtypes import (PRESETS, QuantConfig,  # noqa: E402
                                          quant_config_from_args)
from neural_tpu_torch.core.qtensor import (dequantize, quantize,  # noqa: E402
                                           to_native, to_native_packed)
from neural_tpu_torch.models import (baichuan, bloom, chatglm,  # noqa: E402
                                     falcon, gptj, gptneox, grok, llama, mpt,
                                     opt, phi, qwen, stablelm, starcoder)
from neural_tpu_torch.models import transformer as TRANSFORMER  # noqa: E402
from neural_tpu_torch.models import whisper as WH  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import attention as A  # noqa: E402
from neural_tpu_torch.ops import norms as NORMS  # noqa: E402
from neural_tpu_torch.ops import paged_attention as PA  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402
from neural_tpu_torch.ops.norms import rms_norm, rms_norm_plain  # noqa: E402
from neural_tpu_torch.ops.rope import alibi_slopes, rope_freqs  # noqa: E402
from neural_tpu_torch.runtime import streaming as ST  # noqa: E402
from neural_tpu_torch.runtime import beam as BEAM  # noqa: E402
from neural_tpu_torch.runtime.beam import _beam_step, beam_search  # noqa: E402
from neural_tpu_torch.runtime.generate import (_Graph,  # noqa: E402
                                               _SampledStep,
                                               _StepGraph, _prefill_ragged,
                                               sample_loop,
                                               decode_loop,
                                               greedy_generate, model_step,
                                               prefill_step)
from neural_tpu_torch.runtime.kvcache import (copy_kv,  # noqa: E402
                                              init_cache, reorder_batch)
from neural_tpu_torch.runtime.paged import init_paged_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import (  # noqa: E402
    SamplingParams, apply_penalties, batch_params, draw_noise, sample,
    sample_batched, token_counts, top_k_filter, top_p_filter)
from neural_tpu_torch.serving import (ModelServer, Query,  # noqa: E402
                                      Scheduler)
from neural_tpu_torch.serving import scheduler as SCHED  # noqa: E402
from neural_tpu_torch.utils.audio import load_audio_16k  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

L2_BYTES = 50 << 20
D, I_PAD, V, L, H, DH = 4096, 11264, 32000, 32, 32, 128
T_PREFILL, S_CACHE = 1975, 2048
CFG = ModelConfig(arch="llama", vocab_size=V, hidden_size=D, n_layers=L,
                  n_heads=H, n_kv_heads=H, head_dim=DH,
                  intermediate_size=11008, norm_eps=1e-5, rope_theta=10000.0,
                  max_seq_len=4096)
DEV = "cuda"
# The depth of the copies held against the plain path (phases 5, 5c and
# 5d): one layer runs every kernel and branch of a copy, and the plain
# path's time grows with each layer. Gemma-2's copy (5b) keeps two: a
# sliding and a global layer.
COPY_LAYERS = 1


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fns, reps=20):
    """Device time of one call, in ms: the calls of ``fns`` (closures over
    distinct buffers, so a weight stream does not sit in the 50 MB L2) are
    captured in a CUDA graph, repeated until one replay is long enough to
    time, and each of ``reps`` replays is timed with CUDA events; the
    median replay over the number of calls in it. The graph keeps the
    host's launch cost (Python, ctypes) out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    rounds = 1 if time.perf_counter() - t0 > 1e-3 else max(1, 10 // len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for f in fns:
                f()
    calls = rounds * len(fns)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(ts)


def bound_ms(nbytes, ops, peak_ops):
    return bound_ms_s(nbytes, ops / peak_ops)


def bound_ms_s(nbytes, op_seconds):
    """The larger of the bytes over the HBM rate and the operations' least
    time (summed over the operand types' peaks), in ms."""
    b, o = nbytes / HBM_BPS * 1e3, op_seconds * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


LAUNCHES = {}   # path name -> launch counts of that path's run


# a sym K1 entry point a path requires is also met by its fused twin: the
# fused decode path, which this script turns on for every phase (``main``),
# takes the decode steps' products there (the plain entries are required on
# the explicitly unfused paths, and every entry of the kernels line on some
# path)
FUSED_TWIN = {fn: fn + "_fused" for fn in _cuda.K1_ENTRIES}


def run_path(name, required, fn):
    """Drive one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was never launched."""
    _cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    LAUNCHES[name] = counts
    missing = [k for k in required
               if counts[k] == 0 and counts.get(FUSED_TWIN.get(k), 0) == 0]
    log(f"path {name}: launches {counts}")
    if missing:
        raise AssertionError(f"kernels not launched on path {name}: "
                             f"{missing}")
    return out


# The fusion switches of K1's fused decode path (``models/transformer.py
# fuse_mode``), each leg of phase 4's A/B: (name, NTPU_FUSED_DECODE,
# NTPU_FUSE_GLU)
UNFUSED, FUSED, FUSED_GLU = MODES = (("unfused", "0", "0"),
                                     ("fused", "1", "0"),
                                     ("fused_glu", "1", "1"))


@contextlib.contextmanager
def fusion(mode):
    """Run the block under the switches of ``mode``; the model reads them
    at each forward call, so a capture inside records that path."""
    keys = ("NTPU_FUSED_DECODE", "NTPU_FUSE_GLU")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(zip(keys, mode[1:]))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def k1_step_launches(mode, n_layers=L):
    """K1's launches in one decode step of a Llama-shaped q4_j model (7
    products a layer and the lm_head) under ``mode``: every one through a
    fused entry point when the fusion is on (q/k/v and gate/up ``+rms``,
    wo and w_down ``+res``, the lm_head ``+rms``; w_down ``+glu`` too with
    GLU), none when it is off."""
    n = 7 * n_layers + 1
    if mode is UNFUSED:
        return {"qmm4_npack": n, "qmm4_npack_fused": 0}
    return {"qmm4_npack": 0, "qmm4_npack_fused": n,
            "qmm4_npack_fused+rms": 5 * n_layers + 1,
            "qmm4_npack_fused+res": 2 * n_layers,
            "qmm4_npack_fused+glu": n_layers if mode is FUSED_GLU else 0}


def check_step_launches(recorded, mode, what, n_layers=L):
    """A captured decode step's K1 launches are those of ``mode``."""
    want = k1_step_launches(mode, n_layers)
    got = {k: recorded.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what} ({mode[0]}): K1 launches {got}, "
                             f"expected {want}")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | count "
        f"{torch.cuda.device_count()}")
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device=DEV)
    bufs = [torch.empty_like(a) for _ in range(2)]
    ms = time_ms([lambda b=b: b.copy_(a) for b in bufs])
    bw = 2 * n / (ms * 1e-3)
    log(f"device-to-device copy: {bw / 1e12:.3f} TB/s (read+write of 1 GiB "
        f"in {ms:.3f} ms)")
    del a, bufs
    return smi, name, bw


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _qweight(K, N, gen, copies=1):
    w = torch.randn((K, N), generator=gen, device=DEV) * 0.02
    qt = to_native_packed(quantize(w, PRESETS["q4_j"]))
    return [(qt.planes[0].clone(), qt.scales.clone(), qt)
            for _ in range(copies)]


def _copies(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / nbytes))


# the 7B's products per token: q/k/v/o, gate/up, down; and its lm_head
PROJ = [(D, D, 4 * L), (D, I_PAD, 2 * L), (I_PAD, D, L)]
LM_HEAD = [(D, V, 1)]
# Gemma-2-9B's (42 layers): q, k/v, o, gate/up, down; its lm_head is the
# tied embedding, a torch product
G2_PROJ = [(3584, 4096, 42), (3584, 2048, 84), (4096, 3584, 42),
           (3584, 14336, 84), (14336, 3584, 42)]


def _qt_bytes(qt):
    return sum(t.numel() * t.element_size() for t in (
        *qt.planes, qt.scales, *(() if qt.zeros is None else (qt.zeros,))))


def _qt_copy(qt):
    c = lambda t: None if t is None else t.clone()
    return dataclasses.replace(qt, planes=tuple(map(c, qt.planes)),
                               scales=c(qt.scales), zeros=c(qt.zeros))


def _case(gen, label, cfg, M, shapes, fn, plain, entry, peak, at_rest=True,
          vocab=V, x_dtype=torch.bfloat16, out_dtype=None):
    """One format at one M over ``shapes`` (K, N, products per step): the
    wrapper ``fn(x, qt, out_dtype)`` against ``plain`` on the same CUDA
    tensors, checking that ``entry`` is the C function it launched; its
    time, the plain version's, one bf16 ``torch.matmul`` on the
    pre-dequantized weight (a yardstick) and the bound, each summed over the
    step. The lm_head (N = ``vocab``) writes f32 logits, the rest bf16
    unless ``out_dtype`` says (Whisper's f32 x and f32 outputs): a bf16
    output is one rounding away, 1e-2·max|ref|; f32 only the order of the
    sums, 1e-4·max|ref|."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for K, N, count in shapes:
        odt = out_dtype or (torch.float32 if N == vocab else torch.bfloat16)
        qt = quantize(torch.randn((K, N), generator=gen, device=DEV) * 0.02,
                      cfg)
        if at_rest:
            qt = to_native(qt)
        wbytes = _qt_bytes(qt)
        qts = [qt] + [_qt_copy(qt) for _ in range(_copies(wbytes) - 1)]
        x = torch.randn((M, K), generator=gen, device=DEV).to(x_dtype)
        before = _cuda.launch_counts()[entry]
        out = fn(x, qt, odt)
        if _cuda.launch_counts()[entry] != before + 1:
            raise AssertionError(f"{label} {K}x{N}: {entry} was not launched")
        ref = plain(x, qt, odt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = (1e-2 if odt == torch.bfloat16 else 1e-4) \
            * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"{label} {K}x{N}: max err {err} > tol {tol}")
        ms = time_ms([lambda q=q: fn(x, q, odt) for q in qts])
        pms = time_ms([lambda: plain(x, qt, odt)], reps=5)
        wd = Q.dequant_bf16(qt)
        wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
        xb = x.bfloat16()
        lms = time_ms([lambda w=w: torch.matmul(xb, w) for w in wds])
        del wds, wd, qts
        bnd, by = bound_ms(wbytes + M * K * x.element_size()
                           + M * N * odt.itemsize, 2 * M * K * N, peak)
        bound_by[by] += count * bnd
        log(f"{label} {entry} M={M} {K}x{N} x{count}/step: err {err:.3g} "
            f"(tol {tol:.3g}) | kernel {ms:.4f} ms, plain {pms:.3f} ms, "
            f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{wbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights, "
            f"{2 * M * K * N / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
    n = sum(count for _, _, count in shapes)
    agg.update(bound_by=max(bound_by, key=bound_by.get),
               per=f"{label} at M={M} ({n} launches)")
    log(f"{label} at M={M}, per step: kernel {agg['ms']:.4f} ms, bound "
        f"{agg['bound_ms']:.4f} ms ({agg['bound_by']}), plain "
        f"{agg['plain_ms']:.3f} ms, torch.matmul {agg['library_ms']:.4f} ms")
    return agg


# The times the redesigned K2 and K5 replace: each case's kernel time per
# step or prefill in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, PRs 1-7), by (results key, case label), or by
# results key for a K2 layout's one case, or by case label for K5
PR17_MS = {
    ("K2", "1975-token prefill"): 184.5,
    ("K2", "gemma2 1975-token prefill"): 235.6,
    ("K2_act", "1975-token prefill"): 6.053,
    ("K2_asym", "q4_j_i8_g128 1975-token prefill"): 217.8,
    "K2_int8": 183.0, "K2_int8_asym": 219.7, "K2_int2": 155.4,
    "K2_int2_asym": 189.6, "K2_int3": 180.3, "K2_int3_asym": 216.2,
    "nf4 decode step": 29.40, "nf4 1975-token prefill": 619.8,
    "q4_0 1975-token prefill": 335.3, "mistral gptq 1975-token prefill":
    351.5, "fp4 decode step": 29.42, "fp8_e4m3 decode step": 10.49,
    "int1 decode step": 27.28, "q4_j server chunk": 29.96,
}


# The times of the K3 and K4 kernels the redesigned ones replace, per token,
# step or prefill in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, before the redesign), by (results key, case
# label); None: that case was not timed
_FILLS8 = "[1, 2048, 1975, 128, 700, 1300, 33, 1024]"
_G2_FILLS8 = "[1, 8192, 6000, 128, 4500, 3000, 33, 4097]"
ATTN_BEFORE_MS = {
    ("K3", "llama 1975-token prefill, window 0, softcap 0"): 10.30,
    ("K3", "gemma2 6000-token prefill, window 4096, softcap 50"): 53.77,
    ("K3", "gemma2 6000-token prefill, window 0, softcap 50"): 62.84,
    ("K3", "gemma2 1975-token prefill, window 4096, softcap 50"): 22.33,
    ("K3", "head dim 128 1975-token prefill, window 1024, softcap 50"): 0.405,
    ("K3", "llama 512-token chunk at 1024, window 0, softcap 0"): None,
    ("K3_i8", "llama 1975-token prefill, window 0, softcap 0"): 11.40,
    ("K3_i8", "gemma2 6000-token prefill, window 4096, softcap 50"): 64.09,
    ("K3_i8", "gemma2 6000-token prefill, window 0, softcap 50"): 75.65,
    ("K3_i8", "gemma2 1975-token prefill, window 4096, softcap 50"): 25.78,
    ("K3_i8", "head dim 128 1975-token prefill, window 1024, softcap 50"):
    0.455,
    ("K3_i8", "llama 512-token chunk at 1024, window 0, softcap 0"): None,
    ("K3_alibi", "bloom 1975-token prefill, alibi"): 10.25,
    ("K3_prefix", "chatglm 1975-token prefill, prefix"): 13.94,
    ("K3_i8_alibi", "bloom 1975-token prefill, alibi"): 11.13,
    ("K3_i8_prefix", "chatglm 1975-token prefill, prefix"): 15.23,
    ("K4", "llama decode fill 1975, window 0, softcap 0"): 1.395,
    ("K4", "llama decode fill 128, window 0, softcap 0"): None,
    ("K4", "gemma2 decode fill 6000, window 4096, softcap 50"): 1.799,
    ("K4", "gemma2 decode fill 6000, window 0, softcap 50"): 1.942,
    ("K4", "head dim 128 decode fill 1975, window 1024, softcap 50"): 0.0371,
    ("K4_i8", "llama decode fill 1975, window 0, softcap 0"): 1.190,
    ("K4_i8", "llama decode fill 128, window 0, softcap 0"): None,
    ("K4_i8", "gemma2 decode fill 6000, window 4096, softcap 50"): 1.444,
    ("K4_i8", "gemma2 decode fill 6000, window 0, softcap 50"): 1.609,
    ("K4_i8", "head dim 128 decode fill 1975, window 1024, softcap 50"):
    0.0345,
    ("K4_alibi", "bloom decode fill 1975, alibi"): 1.291,
    ("K4_alibi", "bloom decode fill 128, alibi"): 0.910,
    ("K4_i8_alibi", "bloom decode fill 1975, alibi"): 1.175,
    ("K4_i8_alibi", "bloom decode fill 128, alibi"): 0.910,
    ("K4_G>8", "chatglm2 heads (32 over 2) decode fill 1975"): 1.298,
    ("K4_G>8", "starcoder heads (48 over 1) decode fill 1975"): 1.732,
    ("K4_i8_G>8", "chatglm2 heads (32 over 2) decode fill 1975"): 1.511,
    ("K4_i8_G>8", "starcoder heads (48 over 1) decode fill 1975"): 2.085,
    # the f32-cache branches: new; their bf16 branch is timed beside them
    ("K3_f32", "llama 1975-token prefill, f32 cache"): None,
    ("K4_f32", "llama decode fill 1975, f32 cache"): None,
}
ATTN_SLOWER = []    # (key, label, ms, earlier ms) of K3/K4 cases now slower

# The times of the K1 and K6 kernels the redesigned ones replace, per token,
# step or launch sum in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, before the redesign), by (results key, case
# label); None: a case this script did not run before
K16_BEFORE_MS = {
    ("K1", "q4_j decode step"): 3.757,
    ("K1", "q4_j batch-8 step"): 7.827,
    ("K1", "gemma2 q4_j decode step"): 4.822,
    ("K1", "gemma2 q4_j batch-8 step"): 10.08,
    ("K1_asym", "q4_j_i8_g128 decode step"): 4.860,
    ("K1_asym", "q4_j_i8_g128 batch-8 step"): 9.585,
    ("K1_asym", "mistral gptq decode step"): 3.604,
    ("K1_int2", "int2 decode step"): 3.142,
    ("K1_int2", "int2 batch-8 step"): 7.907,
    ("K1_int2_asym", "int2_asym decode step"): 4.335,
    ("K1_int2_asym", "int2_asym batch-8 step"): 9.401,
    ("K1_int8", "int5 decode step"): 5.977,
    ("K1_int8", "int5 batch-8 step"): 10.83,
    ("K1_int8_asym", "int5_asym decode step"): 5.732,
    ("K1_int8_asym", "int5_asym batch-8 step"): 12.41,
    ("K1_rms", "q4_j rms, decode step"): 3.053,
    ("K1_rms", "q4_j rms, decode step (batch 8)"): 6.896,
    ("K1_rms", "gemma2 q4_j rms (1 + w), decode step"): 3.877,
    ("K1_rms", "gemma2 q4_j rms (1 + w), decode step (batch 8)"): 8.716,
    ("K1_res", "q4_j res, decode step"): 1.098,
    ("K1_res", "q4_j res, decode step (batch 8)"): 2.342,
    ("K1_glu", "q4_j glu silu + res, decode step"): 0.712,
    ("K1_glu", "q4_j glu silu + res, decode step (batch 8)"): 1.860,
    ("K1_glu", "gemma2 q4_j glu gelu_tanh + res, decode step"): 0.990,
    ("K1_glu", "gemma2 q4_j glu gelu_tanh + res, decode step (batch 8)"):
    2.748,
    ("K1_int2_fused", "int2 rms, gate/up"): 1.342,
    ("K1_int2_fused", "int2 rms, gate/up (batch 8)"): 3.664,
    ("K1_int2_fused", "int2 glu silu + res, down"): 0.657,
    ("K1_int2_fused", "int2 glu silu + res, down (batch 8)"): 1.641,
    ("K1_int8_fused", "int5 rms, gate/up"): 2.014,
    ("K1_int8_fused", "int5 rms, gate/up (batch 8)"): 5.925,
    ("K1_int8_fused", "int5 glu silu + res, down"): 0.974,
    ("K1_int8_fused", "int5 glu silu + res, down (batch 8)"): 2.581,
    ("K6", f"llama B=8 decode fills {_FILLS8}, window 0, softcap 0"): 3.438,
    ("K6", "gemma2 B=1 decode fills [6000], window 4096, softcap 50"): 1.891,
    ("K6", "gemma2 B=1 decode fills [6000], window 0, softcap 50"): 1.937,
    ("K6", f"gemma2 B=8 decode fills {_G2_FILLS8}, window 4096, softcap 50"):
    3.819,
    ("K6", f"head dim 128 B=8 decode fills {_FILLS8}, window 512, softcap "
     "50"): 0.0606,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, window 0, softcap 0"):
    2.795,
    ("K6_i8", "gemma2 B=1 decode fills [6000], window 4096, softcap 50"):
    1.256,
    ("K6_i8", "gemma2 B=1 decode fills [6000], window 0, softcap 50"): 1.476,
    ("K6_i8", f"gemma2 B=8 decode fills {_G2_FILLS8}, window 4096, softcap "
     "50"): 2.971,
    ("K6_i8", f"head dim 128 B=8 decode fills {_FILLS8}, window 512, "
     "softcap 50"): 0.0471,
    ("K6_alibi", f"bloom B=8 decode fills {_FILLS8}, alibi"): 3.296,
    ("K6_i8_alibi", f"bloom B=8 decode fills {_FILLS8}, alibi"): 2.791,
    ("K6_G>8", f"chatglm2 heads (32 over 2) B=8 decode fills {_FILLS8}"):
    1.374,
    ("K6_G>8", f"starcoder heads (48 over 1) B=8 decode fills {_FILLS8}"):
    2.233,
    ("K6_i8_G>8", f"chatglm2 heads (32 over 2) B=8 decode fills {_FILLS8}"):
    1.425,
    ("K6_i8_G>8", f"starcoder heads (48 over 1) B=8 decode fills "
     f"{_FILLS8}"): 2.378,
    ("K6", f"llama B=8 decode fills {_FILLS8}, page 16"): None,
    ("K6", f"llama B=8 decode fills {_FILLS8}, page 32"): None,
    ("K6", f"llama B=8 decode fills {_FILLS8}, table past the fill at live "
     "pages"): None,
    ("K6", "llama B=1 decode fill 1975, identity table (K4's cache)"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, page 16"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, page 32"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, table past the fill at "
     "live pages"): None,
    ("K6_i8", "llama B=1 decode fill 1975, identity table (K4's cache)"):
    None,
    ("K6_f32", f"llama B=8 decode fills {_FILLS8}, f32 pool"): None,
}
K16_SLOWER = []     # (key, label, ms, earlier ms) of K1/K6 cases now slower


def _record(results, key, cases, window_ms=None):
    """The first case is the kernel's line; every case is kept beside it,
    and an attention kernel's per-launch times at fill 6000 by window.
    Every case is printed beside the time of the kernel it replaces."""
    first = next(iter(cases.values()))
    results[key] = dict(first, cases=cases, window_ms=window_ms)
    for label, c in cases.items():
        _beside_before(key, label, c)
    _record_k2k5(key, cases)


def _beside_before(key, label, c):
    """A K1, K3, K4 or K6 case beside the time of the kernel it replaces;
    a case now slower is listed."""
    if not key.startswith(("K1", "K3", "K4", "K6")):
        return
    table, slower = (K16_BEFORE_MS, K16_SLOWER) if key.startswith(
        ("K1", "K6")) else (ATTN_BEFORE_MS, ATTN_SLOWER)
    if (key, label) not in table:
        raise AssertionError(f"{key} {label}: no earlier time")
    before = table[(key, label)]
    ratio = "" if before is None else f", {c['ms'] / before:.3f}x of it"
    lib = c.get("library_ms")
    log(f"{key} {label}: kernel {c['ms']:.4f} ms, bound "
        f"{c['bound_ms']:.4f} ms ({c['bound_by']}), library "
        f"{'n/a' if lib is None else round(lib, 4)} ms, before "
        f"{'not measured' if before is None else before} ms{ratio}")
    if before is not None and c["ms"] > before:
        slower.append((key, label, c["ms"], before))


def _record_k2k5(key, cases):
    """A K2/K5 case beside the time of the kernel it replaces."""
    if key.startswith(("K2", "K5")):
        for label, c in cases.items():
            before = PR17_MS.get((key, label), PR17_MS.get(
                label if key.startswith("K5") else key))
            log(f"{key} {label}: kernel {c['ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), library "
                f"{c['library_ms'] if c.get('library_ms') is None else round(c['library_ms'], 4)} ms, "
                f"PR 1-7 {before if before is not None else 'not measured'}"
                " ms")


def check_k1(gen, results):
    """K1 over sym int4 (q4_j) at M=1 (batch 1) and M=8 (the server's
    batch-8 step): q/k/v/o, gate/up, down and the lm_head."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    pl = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    _record(results, "K1", {
        label: _case(gen, label, PRESETS["q4_j"], M, shapes, k1, pl,
                     "qmm4_npack", BF16_FLOPS)
        for M, label, shapes in (
            (1, "q4_j decode step", PROJ + LM_HEAD),
            (8, "q4_j batch-8 step", PROJ + LM_HEAD),
            (1, "gemma2 q4_j decode step", G2_PROJ),
            (8, "gemma2 q4_j batch-8 step", G2_PROJ))})


def check_k2(gen, results):
    """Prefill products at M=1975 through the int8-activation path, at
    Llama-2-7B's and Gemma-2-9B's widths; and its first pass, the
    activation quantization, alone (its codes must equal the plain
    version's; its time is inside K2's, and PyTorch has no one call for
    it)."""
    cases, acts = {}, {}
    for label, shapes in (("1975-token prefill", PROJ),
                          ("gemma2 1975-token prefill", G2_PROJ)):
        agg, act = _k2_shapes(gen, shapes)
        n = sum(count for _, _, count in shapes)
        cases[label] = dict(agg, bound_by="operations",
                            per=f"{label} ({n} launches)")
        acts[label] = dict(act, library_ms=None, err=0.0,
                           per=f"{label} ({n} launches), inside K2's time")
        log(f"K2 quantize_act_i8 per {label}: kernel {act['ms']:.3f} ms, "
            f"plain {act['plain_ms']:.3f} ms, bound {act['bound_ms']:.4f} "
            f"ms ({act['bound_by']})")
    _record(results, "K2", cases)
    _record(results, "K2_act", acts)
    check_k2_errors()


def k2_errors(M=1975, K=4096, N=4096, seed=5):
    """The largest |kernel - plain| of one bf16 [M, K] @ [K, N] product
    through each K2 entry point (group 128, act_bits 8), inputs drawn with
    numpy from ``seed``: the same inputs on any tree of the port, so that
    ``--ab`` can hold this tree's K2 against the parent's. Self-contained
    (``--ab`` runs its source in each tree)."""
    import numpy as np
    import torch
    from neural_tpu_torch.core.dtypes import QuantConfig
    from neural_tpu_torch.core.qtensor import quantize, to_native
    from neural_tpu_torch.ops import qmatmul as Q
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    x = x.to("cuda").bfloat16()
    out = {}
    for entry, bits, sym in (("qmm_a8", 4, True), ("qmm_a8_asym", 4, False),
                             ("qmm_a8_int2", 2, True),
                             ("qmm_a8_int2_asym", 2, False),
                             ("qmm_a8_int8", 6, True),
                             ("qmm_a8_int8_asym", 6, False),
                             ("qmm_a8+int3", 3, True),
                             ("qmm_a8_asym+int3", 3, False)):
        w = rng.standard_normal((K, N), dtype=np.float32) * 0.02
        qt = to_native(quantize(torch.from_numpy(w).to("cuda"),
                                QuantConfig(bits=bits, group_size=128,
                                            sym=sym, act_bits=8)))
        args = (qt.planes[0], qt.scales, 128, 128, torch.bfloat16, qt.zeros,
                bits)
        a, b = Q.qmm_a8(x, *args), Q.qmm_a8_plain(x, *args)
        out[entry] = (a.float() - b.float()).abs().max().item()
    return out


# k2_errors on the parent tree (PR 7, 37e0fb3), measured by
# ``chip_smoke.py --ab`` on an H100 80GB HBM3 at 700 W: every entry point
# equal to its plain version
PARENT_K2_ERR = {"qmm_a8": 0.0, "qmm_a8_asym": 0.0, "qmm_a8_int2": 0.0,
                 "qmm_a8_int2_asym": 0.0, "qmm_a8_int8": 0.0,
                 "qmm_a8_int8_asym": 0.0, "qmm_a8+int3": 0.0,
                 "qmm_a8_asym+int3": 0.0}


def check_k2_errors():
    """K2 keeps the parent's fold order, so its largest difference from
    the plain version is no larger than the parent's at each entry point."""
    errs = k2_errors()
    log(f"K2 max |kernel - plain| per entry point: {errs}; the parent's "
        f"(PR 7 tree, --ab): {PARENT_K2_ERR}")
    worse = {k: (v, PARENT_K2_ERR[k]) for k, v in errs.items()
             if v > PARENT_K2_ERR[k]}
    if worse:
        raise AssertionError(f"K2 differs from its plain version more than "
                             f"the parent's: {worse}")


def _k2_shapes(gen, shapes):
    M = T_PREFILL
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    act = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for K, N, count in shapes:
        planes, scales, qt = _qweight(K, N, gen)[0]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        xq, sa = Q.act_quant_i8(x, 128)
        rq, rsa = Q.quantize_act_i8(x, 128)
        if not (torch.equal(xq, rq) and torch.equal(sa, rsa)):
            raise AssertionError(f"K2 act quant codes differ at {M}x{K}")
        # read x, write codes and f32 scales; ~4 f32 operations an element
        abnd, act["bound_by"] = bound_ms(M * K * 3 + M * K // 128 * 4,
                                         4 * M * K, F32_FLOPS)
        for k, v in (("ms", time_ms([lambda: Q.act_quant_i8(x, 128)])),
                     ("plain_ms", time_ms([lambda: Q.quantize_act_i8(x, 128)],
                                          reps=5)), ("bound_ms", abnd)):
            act[k] += count * v
        out = Q.qmm_a8(x, planes, scales, 128, 128, torch.bfloat16)
        ref = Q.qmm_a8_plain(x, planes, scales, 128, 128, torch.bfloat16)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-5 * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K2 {M}x{K}x{N}: max err {err} > {tol}")
        ms = time_ms([lambda: Q.qmm_a8(x, planes, scales, 128, 128,
                                       torch.bfloat16)])
        pms = time_ms([lambda: Q.qmm_a8_plain(x, planes, scales, 128, 128,
                                              torch.bfloat16)], reps=5)
        wd = dequantize(qt, torch.bfloat16)
        lms = time_ms([lambda: torch.matmul(x, wd)])
        nbytes = M * K * 2 + K * N // 2 + K // 128 * N * 2 + M * N * 2
        bnd, by = bound_ms(nbytes, 2 * M * N * K, INT8_OPS)
        log(f"K2 qmm_a8 M={M} {K}x{N} x{count}/prefill: err {err:.3g} "
            f"(tol {tol:.3g}), act codes equal | kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms, torch.matmul bf16 {lms:.3f} ms, bound "
            f"{bnd:.4f} ms ({by}); {2 * M * N * K / (ms * 1e-3) / 1e12:.1f} "
            "TOP/s")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
        del wd
    return agg, act


# K5's cases: (label, config, M, shapes, at rest). M <= 16 takes the gemv
# route, M > 16 the tensor-core tiles; every layout runs on both routes
# (the formats with no full-width path at one product of 4096 x 4096)
ONE = [(D, D, 1)]
K5_CASES = (
    ("nf4 decode step", "nf4", 1, PROJ + LM_HEAD, True),
    ("nf4 batch-8 step", "nf4", 8, PROJ + LM_HEAD, True),
    ("fp4 decode step", "fp4", 1, PROJ + LM_HEAD, True),
    ("fp8_e4m3 decode step", "fp8", 1, PROJ + LM_HEAD, True),
    ("fp8_e5m2 decode step", "fp8_e5m2", 1, PROJ + LM_HEAD, True),
    ("int1 decode step", "int1", 1, PROJ + LM_HEAD, True),
    ("int3 asym bit planes decode step", "int3_asym_planes", 1,
     PROJ + LM_HEAD, False),
    ("q4_j native-pack nibbles, one product at M=1", "q4_j", 1, ONE, True),
    ("int2 g16 asym native-pack, one product at M=1", "int2_g16_asym", 1,
     ONE, True),
    ("int5 int8 codes, one product at M=1", "int5", 1, ONE, True),
    ("nf4 1975-token prefill", "nf4", T_PREFILL, PROJ, True),
    ("q4_0 1975-token prefill", "q4_0", T_PREFILL, PROJ, True),
    ("q4_j server chunk", "q4_j", 128, PROJ, True),
    ("q4_j 64-token prompt", "q4_j", 64, PROJ, True),
    ("q4_j server chunk, 32 bucket", "q4_j", 32, PROJ, True),
    ("q4_j 24-token prompt", "q4_j", 24, PROJ, True),
    *((f"{fmt}, one product at M=128", fmt, 128, ONE, at_rest)
      for fmt, at_rest in (("fp4", True), ("fp8", True), ("fp8_e5m2", True),
                           ("int1", True), ("int3_asym_planes", False),
                           ("int2_g16_asym", True), ("int5", True))),
)
K5_CFGS = {"int3_asym_planes": QuantConfig(bits=3, group_size=32, sym=False),
           "int2_g16_asym": QuantConfig(bits=2, group_size=16, sym=False)}


def check_k5(gen, results):
    """K5 in every format of the main paths and every layout it reads, on
    both routes: nf4 decode (every product and the lm_head, M=1, and the
    batch-8 step) and prefill (M=1975); the q4_0 prefill; the q4_j model's
    products at M=128, 64 and 32 (server chunks in those buckets, and the
    64-token prompt of phase 4) and at M=24 (the 24-token prompt of phase
    5); fp4, fp8 e4m3/e5m2, int1 and bit-plane int3 asym (uint8
    zero-points, not at rest) at M=1; native-pack nibbles and int2 (group
    16, bf16 zero-points) and int8 codes at M=1; and each layout again at
    M=128, one product. Recorded per route (``K5_gemv``, ``K5_tc``) and
    together (``K5``)."""
    k5 = lambda x, qt, odt: Q.qmm_general(x, qt, odt)
    pl = lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt)
    routes = {"gemv": {}, "tc": {}}
    for label, fmt, M, shapes, at_rest in K5_CASES:
        cfg = K5_CFGS.get(fmt) or PRESETS[fmt]
        route = Q.k5_route(M)
        routes[route][label] = _case(gen, label, cfg, M, shapes, k5, pl,
                                     f"qmm_general+{route}", BF16_FLOPS,
                                     at_rest)
        torch.cuda.empty_cache()
    _record(results, "K5_gemv", routes["gemv"])
    _record(results, "K5_tc", routes["tc"])
    results["K5"] = dict(results["K5_gemv"],
                         cases={**routes["gemv"], **routes["tc"]})


def check_k1_branches(gen, results):
    """K1's other entry points at M=1 and 8, every decode product and the
    lm_head: asym nibbles (q4_j_i8_g128), int2 and int8 codes (int5), sym
    and asym."""
    args = lambda qt: (qt.planes[0], qt.scales, qt.zeros, qt.group_size,
                       qt.cfg.bits)
    k1 = lambda x, qt, odt: Q.qmm_native(x, *args(qt), odt)
    pl = lambda x, qt, odt: Q.qmm_native_plain(x, *args(qt), odt)
    for key, entry, fmt in (("K1_asym", "qmm4_npack_asym", "q4_j_i8_g128"),
                            ("K1_int2", "qmm2_npack", "int2"),
                            ("K1_int2_asym", "qmm2_npack_asym", "int2_asym"),
                            ("K1_int8", "qmm8_native", "int5"),
                            ("K1_int8_asym", "qmm8_native_asym", "int5_asym")):
        cfg = QUANTS.get(fmt) or PRESETS[fmt]
        _record(results, key, {
            f"{fmt} {what}": _case(gen, f"{fmt} {what}", cfg, M,
                                   PROJ + LM_HEAD, k1, pl, entry, BF16_FLOPS)
            for M, what in ((1, "decode step"), (8, "batch-8 step"))})
        torch.cuda.empty_cache()


# K1's fusion options on a decode step (``qmatmul_fused``): the products
# whose input the RMS norm prologue makes (q/k/v, gate/up, the lm_head),
# those whose output takes the residual (wo, w_down), and w_down with the
# gated activation in its prologue too (NTPU_FUSE_GLU=1); Gemma-2-9B's
# widths with the (1 + w) norm and tanh GELU
RMS_PROJ = [(D, D, 3 * L), (D, I_PAD, 2 * L)] + LM_HEAD
RES_PROJ = [(D, D, L), (I_PAD, D, L)]
GLU_PROJ = [(I_PAD, D, L)]
G2_RMS_PROJ = [(3584, 4096, 42), (3584, 2048, 84), (3584, 14336, 84)]
G2_GLU_PROJ = [(14336, 3584, 42)]
# a prologue element that rounds to the neighbouring bf16 value (the
# card's rsqrtf, expf and tanhf against torch's, sums in another order)
# moves an f32 output by |w|·2^-8|h|, about 1e-4·max|out| at these widths:
# f32 outputs are held to 1e-3·max|ref|, bf16 ones to one rounding more,
# 1e-2 as K1's
FUSED_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def _unfused_chain(x, u, nw, offset, act, res, qt, odt):
    """What the graph runs without the fusion: the port's ``rms_norm`` or
    ``act(g) * u`` in bf16, K1, the bf16 residual add."""
    h = x
    if u is not None:
        h = Q.ACTS[act](x) * u
    if nw is not None:
        h = rms_norm(h, nw, 1e-5, offset)
    out = Q.qmm_native(h, qt.planes[0], qt.scales, None, qt.group_size,
                       qt.cfg.bits, odt)
    return out if res is None else out + res


def _fused_case(gen, label, cfg, M, shapes, entry, offset=None, act=None,
                res=False):
    """One fusion option of K1 at one M over ``shapes`` (K, N, products per
    step): the wrapper against its plain version on the same CUDA tensors
    (x the raw residual stream for rms, the gate input for glu), checking
    that ``entry`` and its option branches were launched; its time, the
    plain version's, the unfused chain's on the card (the yardstick this
    fusion replaces), one bf16 ``torch.matmul`` on the dequantized weight,
    and the bound: the unfused K1 bound plus the bytes of u, the norm
    weight and the residual. The lm_head (N = V) writes f32 logits with an
    f32 norm weight (the model's final norm), the rest bf16 with a bf16
    one (a layer's)."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, chain_ms=0.0,
               bound_ms=0.0, err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    branches = [b for b, on in (("rms", offset is not None),
                                ("glu", act is not None), ("res", res)) if on]
    for K, N, count in shapes:
        odt = torch.float32 if N == V else torch.bfloat16
        qt = to_native(quantize(
            torch.randn((K, N), generator=gen, device=DEV) * 0.02, cfg))
        wbytes = _qt_bytes(qt)
        qts = [qt] + [_qt_copy(qt) for _ in range(_copies(wbytes) - 1)]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        u = torch.randn((M, K), generator=gen, device=DEV).bfloat16() \
            if act else None
        nw = None
        if offset is not None:
            nw = (1 + 0.3 * torch.randn(K, generator=gen, device=DEV)).to(
                odt)
        r = torch.randn((M, N), generator=gen, device=DEV).bfloat16() \
            if res else None
        fuse = dict(norm=None if nw is None else (nw, 1e-5, offset), u=u,
                    act=act, res=r)
        fn = lambda q: Q.qmm_native_fused(x, q.planes[0], q.scales,
                                          q.group_size, q.cfg.bits, odt,
                                          **fuse)
        names = [entry] + [f"{entry}+{b}" for b in branches]
        before = _cuda.launch_counts()
        out = fn(qt)
        after = _cuda.launch_counts()
        if any(after[n] != before[n] + 1 for n in names):
            raise AssertionError(f"{label} {K}x{N}: {names} not launched")
        ref = Q.qmm_native_fused_plain(x, qt.planes[0], qt.scales,
                                       qt.group_size, qt.cfg.bits, odt,
                                       **fuse)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = FUSED_TOL[odt] * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"{label} {K}x{N}: max err {err} > tol {tol}")
        ms = time_ms([lambda q=q: fn(q) for q in qts])
        pms = time_ms([lambda: Q.qmm_native_fused_plain(
            x, qt.planes[0], qt.scales, qt.group_size, qt.cfg.bits, odt,
            **fuse)], reps=5)
        cms = time_ms([lambda q=q: _unfused_chain(x, u, nw, offset, act, r,
                                                  q, odt) for q in qts])
        wd = Q.dequant_bf16(qt)
        wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
        lms = time_ms([lambda w=w: torch.matmul(x, w) for w in wds])
        del wds, wd, qts
        extra = (0 if u is None else M * K * 2) \
            + (0 if nw is None else K * nw.element_size()) \
            + (0 if r is None else M * N * 2)
        bnd, by = bound_ms(wbytes + M * K * 2 + extra + M * N * odt.itemsize,
                           2 * M * K * N, BF16_FLOPS)
        bound_by[by] += count * bnd
        log(f"{label} {'+'.join([entry] + branches)} M={M} {K}x{N} "
            f"x{count}/step: err {err:.3g} (tol {tol:.3g}) | kernel "
            f"{ms:.4f} ms, unfused chain {cms:.4f} ms, plain {pms:.3f} ms, "
            f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by})")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("chain_ms", cms), ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
    n = sum(count for _, _, count in shapes)
    agg.update(bound_by=max(bound_by, key=bound_by.get),
               per=f"{label} at M={M} ({n} launches)")
    log(f"{label} at M={M}, per step: kernel {agg['ms']:.4f} ms against the "
        f"unfused chain's {agg['chain_ms']:.4f} ms; bound "
        f"{agg['bound_ms']:.4f} ms ({agg['bound_by']}), plain "
        f"{agg['plain_ms']:.3f} ms, torch.matmul {agg['library_ms']:.4f} ms")
    return agg


# (results key, C entry point, format, shapes and options of each case)
K1_FUSED_CHECKS = (
    ("K1_rms", "qmm4_npack_fused", "q4_j", (
        ("q4_j rms, decode step", RMS_PROJ, dict(offset=0.0)),
        ("gemma2 q4_j rms (1 + w), decode step", G2_RMS_PROJ,
         dict(offset=1.0)))),
    ("K1_res", "qmm4_npack_fused", "q4_j", (
        ("q4_j res, decode step", RES_PROJ, dict(res=True)),)),
    ("K1_glu", "qmm4_npack_fused", "q4_j", (
        ("q4_j glu silu + res, decode step", GLU_PROJ,
         dict(act="silu", res=True)),
        ("gemma2 q4_j glu gelu_tanh + res, decode step", G2_GLU_PROJ,
         dict(act="gelu_tanh", res=True)))),
    ("K1_int2_fused", "qmm2_npack_fused", "int2", (
        ("int2 rms, gate/up", [(D, I_PAD, 2 * L)], dict(offset=0.0)),
        ("int2 glu silu + res, down", GLU_PROJ, dict(act="silu", res=True)))),
    ("K1_int8_fused", "qmm8_native_fused", "int5", (
        ("int5 rms, gate/up", [(D, I_PAD, 2 * L)], dict(offset=0.0)),
        ("int5 glu silu + res, down", GLU_PROJ, dict(act="silu", res=True)))),
)


def check_k1_fused(gen, results):
    """K1's fusion options, each at M=1 (batch 1) and M=8 (the server's
    batch-8 step), over the three sym layouts at rest, against their plain
    versions; timed beside the unfused chain they replace."""
    for key, entry, fmt, cases in K1_FUSED_CHECKS:
        out = {}
        for label, shapes, opts in cases:
            for M, what in ((1, ""), (8, " (batch 8)")):
                out[label + what] = _fused_case(gen, label + what,
                                                PRESETS[fmt], M, shapes,
                                                entry, **opts)
        _record(results, key, out)
        torch.cuda.empty_cache()


K1_RERUN = {}       # K1's rerun and fused-vs-unfused checks, for the log


def check_k1_reruns(gen, results):
    """Two launches of each K1 entry point on the same inputs give
    bit-identical outputs (the splits are merged in a fixed order): every
    layout, sym and asym, and the fused entries with rms + res and with
    glu, at M = 1 and 8 over a 4096 x 4096 product (one split a 512-row
    stretch of K) and the lm_head's 4096 x 32000 (no split at M = 1). And
    the fused rms route (no GLU) against the unfused chain on the card
    (``rms_norm``, then K1): their largest difference is recorded."""
    checked = 0
    for fmt in ("q4_j", "q4_j_i8_g128", "int2", "int2_asym", "int5",
                "int5_asym"):
        cfg = QUANTS.get(fmt) or PRESETS[fmt]
        for K, N in ((D, D), (D, V)):
            qt = to_native(quantize(torch.randn(
                (K, N), generator=gen, device=DEV) * 0.02, cfg))
            args = (qt.planes[0], qt.scales, qt.zeros, qt.group_size,
                    qt.cfg.bits)
            for M in (1, 8):
                x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
                odt = torch.float32 if N == V else torch.bfloat16
                runs = [Q.qmm_native(x, *args, odt) for _ in range(2)]
                if qt.zeros is None:
                    nw = (1 + 0.3 * torch.randn(K, generator=gen,
                                                device=DEV)).bfloat16()
                    r = torch.randn((M, N), generator=gen,
                                    device=DEV).bfloat16()
                    u = torch.randn((M, K), generator=gen,
                                    device=DEV).bfloat16()
                    fa = (qt.planes[0], qt.scales, qt.group_size,
                          qt.cfg.bits, odt)
                    for opts in (dict(norm=(nw, 1e-5, 0.0), res=r),
                                 dict(u=u, act="silu")):
                        runs += [Q.qmm_native_fused(x, *fa, **opts)
                                 for _ in range(2)]
                    if fmt == "q4_j":
                        fused = Q.qmm_native_fused(x, *fa,
                                                   norm=(nw, 1e-5, 0.0))
                        chain = Q.qmm_native(rms_norm(x, nw, 1e-5, 0.0),
                                             *args, odt)
                        d = (fused.float() - chain.float()).abs().max()
                        K1_RERUN[f"fused_rms_vs_chain_M{M}_{N}"] = dict(
                            max_abs=d.item(), equal=torch.equal(fused,
                                                                chain))
                torch.cuda.synchronize()
                for a, b in zip(runs[::2], runs[1::2]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K1 {fmt} M={M} {K}x{N}: a "
                                             "rerun gave other bits")
                    checked += 1
            del qt
    K1_RERUN["reruns_bit_identical"] = checked
    log(f"K1 reruns bit-identical: {checked} pairs (every layout sym and "
        f"asym, fused rms + res and glu, M = 1 and 8); fused rms against "
        f"the unfused chain: {json.dumps(K1_RERUN)}")
    torch.cuda.empty_cache()


# the norms of one 7B decode step (two a layer and the final one) and of a
# 1975-token prefill, each [M, 4096] bf16 rows with a bf16 weight
RMS_CASES = ((1, "decode step"), (T_PREFILL, "1975-token prefill"))


def check_rms_norm(gen, results):
    """The row-norm kernel (``csrc/rms_norm.cu``: the unfused graph's RMS
    norm on the card, on K1's row-scale routine ``rms_row.cuh``) against
    the torch chain ``rms_norm_plain`` on the same rows: each output within
    one bf16 step of the chain's (at most 2^-7 relative; the two sum the
    squares in other orders and take other reciprocal square roots), at a
    decode step's rows and a prefill's; its time beside the chain's and
    ``torch.nn.functional.rms_norm``'s (a yardstick the port never calls),
    each times the 2L + 1 norms of a step or prefill."""
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    n = 2 * L + 1
    cases = {}
    for M, label in RMS_CASES:
        x = (torch.randn((M, D), generator=gen, device=DEV) * 3).bfloat16()
        w = (1 + 0.3 * torch.randn(D, generator=gen, device=DEV)).bfloat16()
        before = _cuda.launch_counts()["rms_norm_bf16"]
        out = rms_norm(x, w, 1e-5, 0.0)
        if _cuda.launch_counts()["rms_norm_bf16"] != before + 1:
            raise AssertionError("rms_norm_bf16 was not launched")
        ref = rms_norm_plain(x, w, 1e-5, 0.0)
        err = (out.float() - ref.float()).abs()
        if not bool((err <= 2 ** -7 * ref.float().abs() + 1e-6).all()):
            raise AssertionError(f"rms_norm {label}: more than one bf16 step "
                                 f"from the chain (max {err.max().item()})")
        xs = [x] + [x.clone() for _ in range(_copies(M * D * 2) - 1)]
        ms = time_ms([lambda x=x: rms_norm(x, w, 1e-5, 0.0) for x in xs])
        pms = time_ms([lambda: rms_norm_plain(x, w, 1e-5, 0.0)])
        lms = None if lib_fn is None else time_ms(
            [lambda: lib_fn(x, (D,), w, 1e-5)])
        bnd, by = bound_ms(2 * M * D * 2 + D * 2, 5 * M * D, F32_FLOPS)
        log(f"rms_norm {label} (M={M}): max err {err.max().item():.3g}, "
            f"{int((out != ref).sum())} of {M * D} elements a bf16 step "
            f"apart | kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"F.rms_norm {'n/a' if lms is None else round(lms, 4)} ms, bound "
            f"{bnd:.4f} ms ({by}), per launch")
        cases[label] = dict(ms=n * ms, plain_ms=n * pms,
                            library_ms=None if lms is None else n * lms,
                            bound_ms=n * bnd, bound_by=by,
                            err=err.max().item(),
                            per=f"{label}, {n} norms of [{M}, {D}]")
    _record(results, "RMS", cases)


def check_k2_asym(gen, results):
    """K2 over asymmetric int4 (q4_j_i8_g128) at the 1975-token prefill.
    Equal int8 codes, exact integer dots and the fold in the same order;
    only the start ``-(xsa @ zwp)`` is summed in another order, which can
    move the bf16 output by one rounding: 1e-2·max|ref|."""
    k2 = lambda x, qt, odt: Q.qmm_a8(x, qt.planes[0], qt.scales,
                                     qt.group_size, 128, odt, qt.zeros)
    pl = lambda x, qt, odt: Q.qmm_a8_plain(x, qt.planes[0], qt.scales,
                                           qt.group_size, 128, odt, qt.zeros)
    label = "q4_j_i8_g128 1975-token prefill"
    _record(results, "K2_asym", {label: _case(
        gen, label, PRESETS["q4_j_i8_g128"], T_PREFILL, PROJ, k2, pl,
        "qmm_a8_asym", INT8_OPS)})


# K2 over the layouts that are not int4, group 128, act_bits 8: (results
# key, C entry point (or its branch), bits, sym)
K2_LAYOUTS = (("K2_int8", "qmm_a8_int8", 6, True),
              ("K2_int8_asym", "qmm_a8_int8_asym", 6, False),
              ("K2_int2", "qmm_a8_int2", 2, True),
              ("K2_int2_asym", "qmm_a8_int2_asym", 2, False),
              ("K2_int3", "qmm_a8+int3", 3, True),
              ("K2_int3_asym", "qmm_a8_asym+int3", 3, False))


def check_k2_layouts(gen, results):
    """K2 at the 1975-token prefill over Llama-2-7B's products on int8 code
    planes (int6), native-pack int2 fields and int3 nibbles, group 128,
    sym and asym. Sym K2 is bit-equal to its plain version; asym sums the
    start ``-(xsa @ zwp)`` in another order, one bf16 rounding:
    1e-2·max|ref| (``_case``)."""
    args = lambda qt: (qt.planes[0], qt.scales, qt.group_size, 128)
    for key, entry, bits, sym in K2_LAYOUTS:
        cfg = QuantConfig(bits=bits, group_size=128, sym=sym, act_bits=8)
        k2 = lambda x, qt, odt: Q.qmm_a8(x, *args(qt), odt, qt.zeros,
                                         qt.cfg.bits)
        pl = lambda x, qt, odt: Q.qmm_a8_plain(x, *args(qt), odt, qt.zeros,
                                               qt.cfg.bits)
        label = f"{cfg.short_name()} 1975-token prefill"
        _record(results, key, {label: _case(gen, label, cfg, T_PREFILL, PROJ,
                                            k2, pl, entry, INT8_OPS)})
        torch.cuda.empty_cache()


# Mistral-7B GPTQ's products per token at rest (int4, group 128, asym, the
# act-order projections fused): q|k|v, o, gate|up, down; the lm_head stays
# in bf16
MISTRAL_PROJ = [(4096, 6144, 32), (4096, 4096, 32), (4096, 28672, 32),
                (14336, 4096, 32)]
GPTQ_QCFG = QuantConfig(bits=4, group_size=128, sym=False)


def check_gptq_products(gen, results):
    """Mistral-7B GPTQ's decode step through K1-asym (M=1) and its
    1975-token prefill through K5, x already gathered (the gathers are
    timed apart in phase 4f); each a case beside the kernel's others."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales,
                                         qt.zeros, qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               qt.zeros, qt.group_size, 4,
                                               odt)
    label = "mistral gptq decode step"
    results["K1_asym"]["cases"][label] = _case(
        gen, label, GPTQ_QCFG, 1, MISTRAL_PROJ, k1, p1, "qmm4_npack_asym",
        BF16_FLOPS)
    _beside_before("K1_asym", label, results["K1_asym"]["cases"][label])
    label = "mistral gptq 1975-token prefill"
    case = _case(
        gen, label, GPTQ_QCFG, T_PREFILL, MISTRAL_PROJ,
        lambda x, qt, odt: Q.qmm_general(x, qt, odt),
        lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt),
        "qmm_general+tc", BF16_FLOPS)
    results["K5"]["cases"][label] = case
    results["K5_tc"]["cases"][label] = case
    log(f"K5_tc {label}: kernel {case['ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms, library {case['library_ms']:.4f} ms, "
        f"PR 1-7 {PR17_MS[label]} ms")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3, continued: the attention kernels K3, K4 and K6
# ---------------------------------------------------------------------------

# Gemma-2-9B's attention: 16 query heads over 8 KV heads of 256 dims,
# scale query_pre_attn_scalar^-0.5 = 1/16, softcap 50, a 4096-key window
# on its 21 even layers and none on its 21 odd ones; 8192 positions
G2_HQ, G2_HKV, G2_DH, G2_S, G2_W, G2_SOFTCAP = 16, 8, 256, 8192, 4096, 50.0
G2_FILL = 6000      # a long fill, past the window
# The heads of each case: (what, Hq, Hkv, head dim, S, softcap): Llama-2-7B's
# with no option, Gemma-2-9B's, and head dim 128 with the softcap
LLAMA_HEADS = ("llama", H, H, DH, S_CACHE, 0.0)
G2_HEADS = ("gemma2", G2_HQ, G2_HKV, G2_DH, G2_S, G2_SOFTCAP)
HD128_HEADS = ("head dim 128", H, H, DH, S_CACHE, G2_SOFTCAP)
# q is drawn at 4x a unit normal so the scaled scores reach ~16 and the
# softcap moves them by up to ~1: a kernel that skipped it would fail its
# check. K is normal, V uniform in [-1, 1] (int8: quantized from there).
Q_SPREAD = 4.0
# Tolerances on the f32 output. bf16 KV, and K3 over int8: the kernel rounds
# P (P·vs for int8) to bf16 against its running max, the plain version
# against the final max (<= 2^-9 each, |v| <= 1), and the softmax sums run
# in another order. K4/K6 over int8: q's quantization and the exact int8 QK
# dot are the same arithmetic on both sides, and PV is f32.
BF16_TOL, I8_PREFILL_TOL, I8_DECODE_TOL = 4e-3, 4e-3, 1e-4


def _visible(fill, window):
    return min(fill, window) if window else fill


def _pairs(T, window):
    """(query, key) pairs a causal prefill of T rows from position 0 sees."""
    if not window or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def _attn_cache(gen, shape, int8, copies=1):
    """K and V caches: (k, v, None, None) in bf16, or (k8, v8, k_scale,
    v_scale)."""
    out = []
    for _ in range(copies):
        k = torch.randn(shape, generator=gen, device=DEV)
        v = torch.rand(shape, generator=gen, device=DEV) * 2 - 1
        if int8:
            (kc, ks), (vc, vs) = A.quantize_kv(k), A.quantize_kv(v)
            out.append((kc, vc, ks, vs))
        else:
            out.append((k.bfloat16(), v.bfloat16(), None, None))
    return out


def _bf16_kv(c):
    """A cache as the library call takes it: bf16, dequantized if int8."""
    k, v, ks, vs = c
    if ks is None:
        return k, v
    return tuple((x.float() * s.float()[..., None]).bfloat16()
                 for x, s in ((k, ks), (v, vs)))


def _sdpa(q, k, v, **kw):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


# the yardstick's bf16 output is one rounding (2^-9, |out| <= 1) past the
# plain version's f32 on the same bf16 keys, plus BF16_TOL's sums
LIB_TOL = 1e-2
_FLEX = []      # torch.compile(flex_attention), made on first use


def _flex(q, kvs, offsets, window, scale, softcap, ref, slopes=None,
          prefix=None):
    """Closures of one compiled ``flex_attention`` call per (k, v) of
    ``kvs`` (bf16, dequantized for int8; q [B, Hq, Tq, Dh]): as its
    score_mod the tanh softcap, then ALiBi's ``slopes[h] · (kv - q_pos)``
    with q_pos = i + offsets[b]; as its block mask the keys that query row
    i of batch row b sees: kv <= i + offsets[b] and, with a window, kv > i
    + offsets[b] - window; or, with the GLM prefix bound ``prefix`` (the
    prompt length P), any kv < P - 1. The library's fused kernel for the
    function K3/K4/K6 compute with their options, a yardstick the port
    never calls. It is compiled here, outside any timed window, one graph
    per shape and set of options (the offsets, the window, the slopes and
    the prefix are tensors, so the cases of one shape share it), and its
    output is held within LIB_TOL of ``ref()``, the plain version on the
    same bf16 keys in the same layout."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        # one graph per shape and set of options: a dozen in all, past the
        # default limit of 8, beyond which flex runs uncompiled, and that
        # path copies from the host inside the timing's graph capture
        torch._dynamo.config.recompile_limit = 64
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    off = torch.tensor(offsets, dtype=torch.int32, device=DEV)
    lo = off - (window or 1 << 30)
    pm1 = torch.tensor([(prefix or 0) - 1], dtype=torch.int32, device=DEV)

    def mask(b, h, qi, ki):
        return (ki <= qi + off[b]) & (ki > qi + lo[b])

    def prefix_mask(b, h, qi, ki):
        return mask(b, h, qi, ki) | (ki < pm1[0])

    def score(s, b, h, qi, ki):
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if slopes is not None:
            s = s + slopes[h] * (ki - qi - off[b])
        return s

    B, Hq, Tq, _ = q.shape
    bm = create_block_mask(prefix_mask if prefix else mask, B, None, Tq,
                           kvs[0][0].shape[2], device=DEV)
    mod = score if softcap or slopes is not None else None
    fns = [lambda k=k, v=v: _FLEX[0](
        q, k, v, score_mod=mod, block_mask=bm, scale=scale,
        enable_gqa=Hq != k.shape[1]) for k, v in kvs]
    t = time.perf_counter()
    out = fns[0]()
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    err = (out.float() - ref()).abs().max().item()
    log(f"  flex_attention compiled and run in {t:.1f} s: err {err:.3g} "
        f"against the plain version on the same bf16 keys (tol {LIB_TOL})")
    if not err <= LIB_TOL:
        raise AssertionError(f"flex_attention yardstick: max err {err}")
    return fns


def _attn_case(label, entry, run, plain, nbytes, op_s, tol, count,
               runs=None, library=None, off=None):
    """One attention case: the wrapper ``run()`` against ``plain()`` on the
    same CUDA tensors, checking that ``entry`` launched; its time (over
    ``runs``, closures on copies of the cache that defeat the L2, or
    ``run`` alone), the plain version's, ``library``'s (closures of one
    library call on the same keys, dequantized for int8:
    ``scaled_dot_product_attention`` with no option, a compiled
    ``flex_attention`` with the softcap, a window, ALiBi or the prefix),
    and the bound of ``nbytes`` and ``op_s`` seconds of operations; each
    times ``count``, the launches per token or prefill. ``off``: closures
    of the same launches with the case's option off, timed beside it, so
    the branch's cost shows."""
    before = _cuda.launch_counts()[entry]
    out = run()
    if _cuda.launch_counts()[entry] != before + 1:
        raise AssertionError(f"{label}: {entry} was not launched")
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label} {entry}: max err {err} > tol {tol}")
    del out, ref
    ms = time_ms(runs or [run])
    pms = time_ms([plain], reps=5)
    lms = time_ms(library)
    bnd, by = bound_ms_s(nbytes, op_s)
    log(f"{label} {entry} x{count}: err {err:.3g} (tol {tol}) | kernel "
        f"{ms:.4f} ms, plain {pms:.3f} ms, library {lms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}); {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    out = dict(ms=count * ms, plain_ms=count * pms, library_ms=count * lms,
               bound_ms=count * bnd, bound_by=by, err=err,
               ms_per_launch=ms, per=f"{label} ({count} launches)")
    if off:
        oms = time_ms(off)
        out.update(off_ms_per_launch=oms, on_over_off=ms / oms)
        log(f"  the same launch with the option off: {oms:.4f} ms; on / "
            f"off {ms / oms:.3f}")
    return out


def _f32_twin(label, fn, args, entry, **kw):
    """The f32-cache branch of one bf16 case (``args``: q, K, V, the rest;
    ``kw`` its options): over K and V widened to f32, its output bit-equal
    to the bf16 branch's; over f32 values off the bf16 grid, bit-equal to
    the bf16 branch's over them rounded. ``entry`` is the bf16 case's
    (``flash_decode+alibi``): its f32 twin and the twin's option branch
    must launch twice."""
    q, k, v, *rest = args
    base, _, opt = entry.partition("+")
    names = [f"{base}_f32"] + ([f"{base}_f32+{opt}"] if opt else [])
    gen = torch.Generator(device=DEV).manual_seed(len(label))
    kx, vx = _off_grid(k, gen), _off_grid(v, gen)
    before = _cuda.launch_counts()
    pairs = ((fn(*args, **kw), fn(q, k.float(), v.float(), *rest, **kw)),
             (fn(q, kx.bfloat16(), vx.bfloat16(), *rest, **kw),
              fn(q, kx, vx, *rest, **kw)))
    after = _cuda.launch_counts()
    if any(after[n] != before[n] + 2 for n in names):
        raise AssertionError(f"{label}: {names} not launched twice")
    _biteq(f"{label} ({names[-1]})", *pairs[0])
    _biteq(f"{label} ({names[-1]}, off the grid)", *pairs[1])
    del kx, vx, pairs


def _attn_ops(int8, Dh, Hq, pairs, alibi, decode):
    """Seconds of operations at the peaks: QK^T and PV (int8 QK at the int8
    rate; decode's int8 PV in f32, prefill's in bf16), and ALiBi's product
    and sum per pair in f32."""
    if int8:
        pv = F32_FLOPS if decode else BF16_FLOPS
        op_s = 2 * Dh * Hq * pairs * (1 / INT8_OPS + 1 / pv)
    else:
        op_s = 4 * Dh * Hq * pairs / BF16_FLOPS
    return op_s + (2 * Hq * pairs / F32_FLOPS if alibi else 0.0)


# the server's prefill chunk: 512 tokens at position 1024 (S = 2048)
CHUNK_T, CHUNK_START = 512, 1024


def check_k3(gen, results):
    """K3, bf16 and int8: Llama-2-7B's 1975-token prefill from position 0;
    Gemma-2-9B's 6000-token prompt (S = 8192) with window 4096 and 0, and
    its 1975-token prompt (S = 2048) under the window, which it never
    reaches; head dim 128 at 1975 tokens with the softcap and a window of
    1024; the server's 512-token chunk at position 1024 of 2048 (its
    yardstick a compiled ``flex_attention`` with the offset)."""
    g2_short = (*G2_HEADS[:4], S_CACHE, G2_SOFTCAP)
    shapes = [(LLAMA_HEADS, T_PREFILL, 0, 0, L),
              (G2_HEADS, G2_FILL, 0, G2_W, 21), (G2_HEADS, G2_FILL, 0, 0, 21),
              (g2_short, T_PREFILL, 0, G2_W, 42),
              (HD128_HEADS, T_PREFILL, 0, 1024, 1),
              (LLAMA_HEADS, CHUNK_T, CHUNK_START, 0, L)]
    for int8, key in ((False, "K3"), (True, "K3_i8")):
        entry = "flash_prefill_i8" if int8 else "flash_prefill"
        fn = A.flash_prefill_i8 if int8 else A.flash_prefill
        plain = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), T, start, W, count in shapes:
            starts = torch.full((1,), start, dtype=torch.int32, device=DEV)
            q = (torch.randn((1, T, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (1, Hkv, S, Dh), int8)[0]
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), starts,
                    Dh ** -0.5, cap, W)
            kd, vd = (x[:, :, :start + T] for x in _bf16_kv(c))
            qh = q.transpose(1, 2)
            if cap or W or start:
                library = _flex(qh, [(kd, vd)], [start], W, Dh ** -0.5, cap,
                                lambda: A.flash_prefill_plain(
                                    q, kd, vd, starts, Dh ** -0.5, cap,
                                    W).transpose(1, 2))
            else:
                library = [lambda: _sdpa(qh, kd, vd, is_causal=True)]
            pairs = _pairs(start + T, W) - _pairs(start, W)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            op_s = _attn_ops(int8, Dh, Hq, pairs, False, False)
            label = (f"{what} {T}-token chunk at {start}" if start else
                     f"{what} {T}-token prefill") + \
                f", window {W}, softcap {cap:g}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args), lambda: plain(*args),
                T * Hq * Dh * 2 + 2 * (start + T) * Hkv * row
                + T * Hq * Dh * 4, op_s,
                I8_PREFILL_TOL if int8 else BF16_TOL, count,
                library=library)
            if not int8:
                _f32_twin(label, fn, args, entry)
            if what == "gemma2" and T == G2_FILL:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, qh, c, kd, vd, library, starts
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def check_k4(gen, results):
    """K4, bf16 and int8: Llama-2-7B's decode at fills 1975 and 128;
    Gemma-2-9B's at fill 6000 of 8192 with window 4096 and 0; head dim 128
    at fill 1975 with the softcap and a window of 1024."""
    shapes = [(LLAMA_HEADS, T_PREFILL, 0, L), (LLAMA_HEADS, 128, 0, L),
              (G2_HEADS, G2_FILL, G2_W, 21), (G2_HEADS, G2_FILL, 0, 21),
              (HD128_HEADS, T_PREFILL, 1024, 1)]
    for int8, key in ((False, "K4"), (True, "K4_i8")):
        entry = "flash_decode_i8" if int8 else "flash_decode"
        fn = A.flash_decode_i8 if int8 else A.flash_decode
        plain = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), fill, W, count in shapes:
            q = (torch.randn((1, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            vis = _visible(fill, W)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            caches = _attn_cache(gen, (1, Hkv, S, Dh), int8,
                                 _copies(2 * vis * Hkv * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     Dh ** -0.5, cap, W) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            if cap or W:
                # the whole cache, masked past the fill: K6's B=1 case
                # gathers the same shape, so the two share one graph
                library = _flex(q[:, :, None], kvs, [fill - 1], W,
                                Dh ** -0.5, cap,
                                lambda: A.flash_decode_plain(
                                    q, *kvs[0], lengths, Dh ** -0.5, cap,
                                    W)[:, :, None])
            else:
                library = [lambda kv=kv: _sdpa(
                    q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill])
                    for kv in kvs]
            op_s = _attn_ops(int8, Dh, Hq, vis, False, True)
            label = f"{what} decode fill {fill}, window {W}, softcap {cap:g}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args[0]), lambda: plain(*args[0]),
                2 * vis * Hkv * row + Hq * Dh * (2 + 4), op_s,
                I8_DECODE_TOL if int8 else BF16_TOL, count,
                runs=[lambda a=a: fn(*a) for a in args], library=library)
            if not int8:
                _f32_twin(label, fn, args[0], entry)
            if what == "gemma2" and fill == G2_FILL:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, caches, args, kvs, library
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def check_k6(gen, results):
    """K6 over shuffled page tables (page 256, a pool of B·MAXP + 1 pages),
    bf16 and int8: the Llama server's step (B=8, fills 1..2048);
    Gemma-2-9B's at B=1, fill 6000, window 4096 and 0, and at B=8 with
    mixed fills and the window; head dim 128 at the server's step with the
    softcap and a window of 512."""
    ps = 256
    cpu = torch.Generator().manual_seed(6)
    server = [1, 2048, 1975, 128, 700, 1300, 33, 1024]
    shapes = [(LLAMA_HEADS, server, 0, L),
              (G2_HEADS, [G2_FILL], G2_W, 21), (G2_HEADS, [G2_FILL], 0, 21),
              (G2_HEADS, [1, 8192, 6000, 128, 4500, 3000, 33, 4097], G2_W,
               21),
              (HD128_HEADS, server, 512, 1)]
    for int8, key in ((False, "K6"), (True, "K6_i8")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), fills, W, count in shapes:
            B, maxp = len(fills), S // ps
            P = B * maxp + 1
            table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
                .reshape(B, maxp).to(torch.int32).to(DEV)
            lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
            q = (torch.randn((B, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (P, Hkv, ps, Dh), int8)[0]
            opts = (Dh ** -0.5, cap, W)
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                    *opts)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            if cap or W:
                library = _flex(q[:, :, None], [(kd, vd)],
                                [f - 1 for f in fills], W, Dh ** -0.5, cap,
                                lambda: A.flash_decode_plain(
                                    q, kd, vd, lengths, Dh ** -0.5, cap,
                                    W)[:, :, None])
            else:
                mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                library = [lambda: _sdpa(q[:, :, None], kd, vd,
                                         attn_mask=mask)]
            n = sum(_visible(f, W) for f in fills)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            op_s = _attn_ops(int8, Dh, Hq, n, False, True)
            label = (f"{what} B={B} decode fills {fills}, window {W}, "
                     f"softcap {cap:g}")
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args),
                lambda: PA.paged_decode_plain(q, *c, table, lengths, *opts),
                2 * n * Hkv * row + B * maxp * 4 + B * 4
                + B * Hq * Dh * (2 + 4), op_s,
                I8_DECODE_TOL if int8 else BF16_TOL, count, library=library)
            if not int8:
                _f32_twin(label, fn, args, entry)
            if what == "gemma2" and fills == [G2_FILL]:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, c, args, kd, vd, library
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def _server_table(cpu, B, maxp, P):
    """A shuffled page table: B rows of maxp distinct pages of P."""
    return torch.randperm(P, generator=cpu)[:B * maxp].reshape(B, maxp) \
        .to(torch.int32).to(DEV)


def check_k6_paging(gen, results):
    """K6's paging beside check_k6's cases, bf16 and int8 pools, against
    paged_decode_plain: the Llama server's step (B=8, mixed fills) over
    pages of 16 and 32 keys (a tile takes several boxes); the same over
    pages of 256 with every table entry past a row's fill pointing at
    another row's live page, and the rows past each fill in its last page
    holding large finite K and V (read, since the box is whole, and
    masked); and K6 at batch 1, fill 1975, over an identity table on K4's
    own cache (its pages the cache's rows) against K4 on that cache, the
    two times side by side."""
    cpu = torch.Generator().manual_seed(17)
    fills = SERVER_FILLS
    B = len(fills)
    lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
    opts = (DH ** -0.5, 0.0, 0)
    for int8, key in ((False, "K6"), (True, "K6_i8")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        tol = I8_DECODE_TOL if int8 else BF16_TOL
        row = DH + 2 if int8 else 2 * DH
        n = sum(fills)
        cases = results[key]["cases"]
        for ps, what in ((16, "page 16"), (32, "page 32"),
                         (256, "table past the fill at live pages")):
            maxp = S_CACHE // ps
            P = B * maxp + 1
            table = _server_table(cpu, B, maxp, P - 1)
            k, v = (torch.randn((P, H, ps, DH), generator=gen, device=DEV),
                    torch.rand((P, H, ps, DH), generator=gen,
                               device=DEV) * 2 - 1)
            if ps == 256:
                # entries past the fill: other rows' visible pages; rows
                # past the fill in the last page: large, finite
                live = [int(table[b, i]) for b in range(B)
                        for i in range(-(-fills[b] // ps))]
                for b, f in enumerate(fills):
                    used = -(-f // ps)
                    for i in range(used, maxp):
                        table[b, i] = live[(7 * b + i) % len(live)]
                    page, r0 = int(table[b, used - 1]), f - (used - 1) * ps
                    k[page, :, r0:] = 3e4
                    v[page, :, r0:] = -3e4
            if int8:
                (kc, ks), (vc, vs) = A.quantize_kv(k), A.quantize_kv(v)
                c = (kc, vc, ks, vs)
            else:
                c = (k.bfloat16(), v.bfloat16(), None, None)
            del k, v
            q = (torch.randn((B, H, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), table,
                    lengths, *opts)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            label = f"llama B={B} decode fills {fills}, {what}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args),
                lambda: PA.paged_decode_plain(q, *c, table, lengths, *opts),
                2 * n * H * row + B * maxp * 4 + B * 4 + B * H * DH * 6,
                _attn_ops(int8, DH, H, n, False, True), tol, L,
                library=[lambda: _sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask)])
            _beside_before(key, label, cases[label])
            del q, c, args, kd, vd, mask
            torch.cuda.empty_cache()
        # K6 over an identity table on K4's cache [1, H, S, D]: page i of
        # the pool is keys i*ps .. of the row (pool [maxp, H, ps, D])
        ps, fill = 256, T_PREFILL
        maxp = S_CACHE // ps
        cache = _attn_cache(gen, (1, H, S_CACHE, DH), int8)[0]
        pool = [None if t is None else
                t.reshape(H, maxp, ps, *t.shape[3:]).transpose(0, 1)
                .contiguous() for t in cache]
        table = torch.arange(maxp, dtype=torch.int32, device=DEV)[None]
        ln = torch.tensor([fill], dtype=torch.int32, device=DEV)
        q = (torch.randn((1, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        a4 = (q, cache[0], cache[1], *(cache[2:] if int8 else ()), ln,
              *opts)
        a6 = (q, pool[0], pool[1], *(pool[2:] if int8 else ()), table, ln,
              *opts)
        out4, out6 = k4(*a4), fn(*a6)
        torch.cuda.synchronize()
        err46 = (out6 - out4).abs().max().item()
        if not err46 <= tol:
            raise AssertionError(f"K6 over an identity table against K4: "
                                 f"max err {err46} > {tol}")
        kd, vd = (x[:, :, :fill] for x in _bf16_kv(cache))
        label = f"llama B=1 decode fill {fill}, identity table (K4's cache)"
        cases[label] = _attn_case(
            label, entry, lambda: fn(*a6),
            lambda: PA.paged_decode_plain(q, *pool, table, ln, *opts),
            2 * fill * H * row + maxp * 4 + 4 + H * DH * 6,
            _attn_ops(int8, DH, H, fill, False, True), tol, L,
            library=[lambda: _sdpa(q[:, :, None], kd, vd)])
        k4_ms = time_ms([lambda: k4(*a4)])
        cases[label].update(k4_ms_per_launch=k4_ms, k6_vs_k4_err=err46)
        log(f"{key} {label}: K6 {cases[label]['ms_per_launch']:.4f} ms a "
            f"launch, K4 on the same cache {k4_ms:.4f} ms; |K6 - K4| "
            f"{err46:.3g} (tol {tol})")
        _beside_before(key, label, cases[label])
        del cache, pool, q, a4, a6, out4, out6, kd, vd
        torch.cuda.empty_cache()


def window_speedups(results):
    """The window's gain at fill 6000: K4, K6 (B=1) and K3 time per launch
    with window 4096 over the same with window 0, as each check recorded
    them. A kernel that masked the keys below the floor but still read
    them would show none: K4 and K3 must be faster with the window. K6
    shares K4's body; its B=1 gain was 4-12% on an H100 80GB HBM3 at 700
    W, down to the noise of one launch, so it is printed, not required."""
    out = {}
    for key, at in (("K4", f"decode fill {G2_FILL}"),
                    ("K4_i8", f"decode fill {G2_FILL}"),
                    ("K6", f"B=1 decode fill {G2_FILL}"),
                    ("K6_i8", f"B=1 decode fill {G2_FILL}"),
                    ("K3", f"{G2_FILL}-token prefill"),
                    ("K3_i8", f"{G2_FILL}-token prefill")):
        per = results[key]["window_ms"]
        out[key] = per[G2_W] / per[0]
        log(f"{key} {at}: window {G2_W} {per[G2_W]:.4f} ms, window 0 "
            f"{per[0]:.4f} ms per launch, ratio {out[key]:.3f}")
        if key.startswith(("K4", "K3")) and not per[G2_W] < per[0]:
            raise AssertionError(f"{key}: the window skips no work at {at}")
    return out


# Bloom-7B1's and ChatGLM-6B's attention: 32 heads of 128 over as many KV
# heads, as Llama-2-7B's; Bloom's ALiBi slopes 2^-(h+1)/4; 30 and 28 layers
BLOOM_L, CHATGLM_L = 30, 28


def _slopes(Hq):
    return torch.from_numpy(alibi_slopes(Hq)).to(DEV)


def _prefix_pairs(T, P):
    """(query, key) pairs a T-row prefill from position 0 sees under the GLM
    prefix mask of a P-token prompt: row t sees max(t + 1, P - 1) keys."""
    return sum(max(t + 1, P - 1) for t in range(T))


def check_k3_options(gen, results):
    """K3's ALiBi branch at Bloom-7B1's 1975-token prefill (32 heads, its
    slopes; 30 launches) and its GLM prefix branch at ChatGLM-6B's, where
    the whole 1975-token prompt is the prefix (every row sees 1973 keys or
    more; 28 launches), bf16 and int8 KV, each against the same launch with
    the option off."""
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    sl, T = _slopes(H), T_PREFILL
    plen = torch.tensor([T], dtype=torch.int32, device=DEV)
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        entry = "flash_prefill_i8" if int8 else "flash_prefill"
        fn = A.flash_prefill_i8 if int8 else A.flash_prefill
        plain = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
        q = (torch.randn((1, T, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (1, H, S_CACHE, DH), int8)[0]
        base = (q, c[0], c[1], *(c[2:] if int8 else ()), starts, DH ** -0.5)
        kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
        qh = q.transpose(1, 2)
        row = DH + 2 if int8 else 2 * DH    # bytes of a K or V row
        nbytes = T * H * DH * 2 + 2 * T * H * row + T * H * DH * 4
        for opt, kw, pairs, count, what in (
                ("alibi", dict(slopes=sl), _pairs(T, 0), BLOOM_L, "bloom"),
                ("prefix", dict(prefix_len=plen), _prefix_pairs(T, T),
                 CHATGLM_L, "chatglm")):
            library = _flex(
                qh, [(kd, vd)], [0], 0, DH ** -0.5, 0.0,
                lambda: A.flash_prefill_plain(q, kd, vd, starts, DH ** -0.5,
                                              **kw).transpose(1, 2),
                slopes=kw.get("slopes"), prefix=T if opt == "prefix" else None)
            label = f"{what} {T}-token prefill, {opt}"
            case = _attn_case(
                label, f"{entry}+{opt}", lambda: fn(*base, **kw),
                lambda: plain(*base, **kw), nbytes,
                _attn_ops(int8, DH, H, pairs, opt == "alibi", False),
                I8_PREFILL_TOL if int8 else BF16_TOL, count, library=library,
                off=[lambda: fn(*base)])
            if not int8:
                _f32_twin(label, fn, base, f"{entry}+{opt}", **kw)
            _record(results, f"K3{sfx}_{opt}", {label: case})
            del library
        del q, c, kd, vd, qh
        torch.cuda.empty_cache()


def check_k4_alibi(gen, results):
    """K4's ALiBi branch at Bloom-7B1's decode, fills 1975 and 128 of 2048,
    bf16 and int8 KV, against the same launches without the slopes."""
    sl = _slopes(H)
    for int8, key in ((False, "K4_alibi"), (True, "K4_i8_alibi")):
        entry = "flash_decode_i8" if int8 else "flash_decode"
        fn = A.flash_decode_i8 if int8 else A.flash_decode
        plain = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        cases = {}
        for fill in (T_PREFILL, 128):
            q = (torch.randn((1, H, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            row = DH + 2 if int8 else 2 * DH
            caches = _attn_cache(gen, (1, H, S_CACHE, DH), int8,
                                 _copies(2 * fill * H * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     DH ** -0.5) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            library = _flex(q[:, :, None], kvs, [fill - 1], 0, DH ** -0.5,
                            0.0, lambda: A.flash_decode_plain(
                                q, *kvs[0], lengths, DH ** -0.5,
                                slopes=sl)[:, :, None], slopes=sl)
            label = f"bloom decode fill {fill}, alibi"
            cases[label] = _attn_case(
                label, f"{entry}+alibi", lambda: fn(*args[0], slopes=sl),
                lambda: plain(*args[0], slopes=sl),
                2 * fill * H * row + H * DH * (2 + 4),
                _attn_ops(int8, DH, H, fill, True, True),
                I8_DECODE_TOL if int8 else BF16_TOL, BLOOM_L,
                runs=[lambda a=a: fn(*a, slopes=sl) for a in args],
                library=library, off=[lambda a=a: fn(*a) for a in args])
            if not int8:
                _f32_twin(label, fn, args[0], f"{entry}+alibi", slopes=sl)
            del q, caches, args, kvs, library
            torch.cuda.empty_cache()
        _record(results, key, cases)


def check_k6_alibi(gen, results):
    """K6's ALiBi branch at the Bloom-7B1 server's step: B=8 over a
    shuffled page table (page 256) with the server's mixed fills, bf16 and
    int8 pools, against the same launch without the slopes."""
    ps, sl = 256, _slopes(H)
    cpu = torch.Generator().manual_seed(11)
    fills = [1, 2048, 1975, 128, 700, 1300, 33, 1024]
    B, maxp = len(fills), S_CACHE // ps
    P = B * maxp + 1
    for int8, key in ((False, "K6_alibi"), (True, "K6_i8_alibi")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
            .reshape(B, maxp).to(torch.int32).to(DEV)
        lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
        q = (torch.randn((B, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (P, H, ps, DH), int8)[0]
        args = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                DH ** -0.5)
        kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
        library = _flex(q[:, :, None], [(kd, vd)], [f - 1 for f in fills], 0,
                        DH ** -0.5, 0.0, lambda: A.flash_decode_plain(
                            q, kd, vd, lengths, DH ** -0.5,
                            slopes=sl)[:, :, None], slopes=sl)
        n = sum(fills)
        row = DH + 2 if int8 else 2 * DH
        label = f"bloom B={B} decode fills {fills}, alibi"
        case = _attn_case(
            label, f"{entry}+alibi", lambda: fn(*args, slopes=sl),
            lambda: PA.paged_decode_plain(q, *c, table, lengths, DH ** -0.5,
                                          slopes=sl),
            2 * n * H * row + B * maxp * 4 + B * 4 + B * H * DH * (2 + 4),
            _attn_ops(int8, DH, H, n, True, True),
            I8_DECODE_TOL if int8 else BF16_TOL, BLOOM_L, library=library,
            off=[lambda: fn(*args)])
        if not int8:
            _f32_twin(label, fn, args, f"{entry}+alibi", slopes=sl)
        _record(results, key, {label: case})
        del q, c, args, kd, vd, library
        torch.cuda.empty_cache()


# more than 8 query heads per KV head: ChatGLM-2-6B's attention (32 heads of
# 128 over 2 KV heads, 28 layers) and StarCoder's multi-query attention (48
# heads of 128 over 1, 40 layers)
MANY_G = (("chatglm2", 32, 2, 28), ("starcoder", 48, 1, 40))
SERVER_FILLS = [1, 2048, 1975, 128, 700, 1300, 33, 1024]


def check_many_heads(gen, results):
    """K4 at fill 1975 and K6 at B=8 with the server's mixed fills (page
    256, a shuffled table) at G = 16 and 48, bf16 and int8 KV, against
    their plain versions; the library call is ``sdpa`` with GQA on the
    gathered, dequantized keys."""
    ps, cpu = 256, torch.Generator().manual_seed(13)
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        row = DH + 2 if int8 else 2 * DH
        tol = I8_DECODE_TOL if int8 else BF16_TOL
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        p4 = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        k6 = PA.paged_decode_i8 if int8 else PA.paged_decode
        c4, c6 = {}, {}
        for what, Hq, Hkv, count in MANY_G:
            q = (torch.randn((1, Hq, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            fill = T_PREFILL
            caches = _attn_cache(gen, (1, Hkv, S_CACHE, DH), int8,
                                 _copies(2 * fill * Hkv * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     DH ** -0.5) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            label = f"{what} heads ({Hq} over {Hkv}) decode fill {fill}"
            c4[label] = _attn_case(
                label, f"flash_decode{sfx}+G>8", lambda: k4(*args[0]),
                lambda: p4(*args[0]), 2 * fill * Hkv * row + Hq * DH * 6,
                _attn_ops(int8, DH, Hq, fill, False, True), tol, count,
                runs=[lambda a=a: k4(*a) for a in args],
                library=[lambda kv=kv: _sdpa(
                    q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill],
                    enable_gqa=True) for kv in kvs])
            if not int8:
                _f32_twin(label, k4, args[0], "flash_decode+G>8")
            del q, caches, args, kvs
            B, maxp = len(SERVER_FILLS), S_CACHE // ps
            P = B * maxp + 1
            table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
                .reshape(B, maxp).to(torch.int32).to(DEV)
            lengths = torch.tensor(SERVER_FILLS, dtype=torch.int32,
                                   device=DEV)
            q = (torch.randn((B, Hq, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (P, Hkv, ps, DH), int8)[0]
            a6 = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                  DH ** -0.5)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            n = sum(SERVER_FILLS)
            label = f"{what} heads ({Hq} over {Hkv}) B={B} decode fills " \
                f"{SERVER_FILLS}"
            c6[label] = _attn_case(
                label, f"paged_decode{sfx}+G>8", lambda: k6(*a6),
                lambda: PA.paged_decode_plain(q, *c, table, lengths,
                                              DH ** -0.5),
                2 * n * Hkv * row + B * maxp * 4 + B * 4 + B * Hq * DH * 6,
                _attn_ops(int8, DH, Hq, n, False, True), tol, count,
                library=[lambda: _sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask, enable_gqa=True)])
            if not int8:
                _f32_twin(label, k6, a6, "paged_decode+G>8")
            del q, c, a6, kd, vd, mask
            torch.cuda.empty_cache()
        _record(results, f"K4{sfx}_G>8", c4)
        _record(results, f"K6{sfx}_G>8", c6)


def branch_costs(results):
    """Each ALiBi and prefix case's time per launch over the same launch
    with the option off, as the checks recorded them."""
    out = {}
    for key in ("K3_alibi", "K3_i8_alibi", "K3_prefix", "K3_i8_prefix",
                "K4_alibi", "K4_i8_alibi", "K6_alibi", "K6_i8_alibi"):
        for label, c in results[key]["cases"].items():
            out[f"{key}: {label}"] = c["on_over_off"]
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


# the 64-token prompt prefills through K5, the 512-token one through K2
GEN_BF16 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill",
            "flash_decode")
GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8", "flash_decode_i8")


def _check_ids(new, n, what, vocab=V):
    if len(new) != n or not all(0 <= t < vocab for t in new):
        raise AssertionError(f"{what}: bad generated ids {new}")


def _check_served(out, n, what, cfg):
    """A Scheduler's ids: ``n`` of them, or fewer ending at an EOS."""
    stopped = out and out[-1] in cfg.eos_token_ids
    _check_ids(out, len(out) if stopped else n, what, cfg.vocab_size)


def decode_ms(params, fill, batch=1, kv_dtype=torch.bfloat16, lo=4, hi=36,
              cfg=CFG, S=S_CACHE):
    """ms per decode step: slope of ``decode_loop`` between lo and hi steps
    (best of 3 each) from a cache of ``S`` positions filled to ``fill``, a
    prompt of ``fill`` tokens (which a prefix-LM model's 2-D RoPE reads;
    the others ignore it)."""
    token = torch.full((batch, 1), 17, dtype=torch.long, device=DEV)

    def run(n):
        cache = init_cache(cfg, batch, S, kv_dtype, device=DEV)
        pos = torch.full((batch,), fill, dtype=torch.long, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_loop(params, token, pos, cache, n, prompt_len=pos)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(lo)
    t_lo = min(run(lo) for _ in range(3))
    t_hi = min(run(hi) for _ in range(3))
    return (t_hi - t_lo) / (hi - lo) * 1e3


def ttft_ms(params, kv_dtype=torch.bfloat16, cfg=CFG, T=T_PREFILL,
            S=S_CACHE):
    """T-token prefill with last-row logits on a fresh cache of S
    positions, best of 3 after a warm-up."""
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen).to(DEV)
    start = torch.zeros(1, dtype=torch.long, device=DEV)

    def once():
        cache = init_cache(cfg, 1, S, kv_dtype, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill_step(params, tokens, start, cache)
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        return (time.perf_counter() - t) * 1e3

    once()
    return min(once() for _ in range(3))


def phase_generation(params):
    model = Model().init_params(params, CFG)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in (64, 512)]
    outs = run_path("generate_bf16", GEN_BF16, lambda: [
        model.generate(p, max_new_tokens=16, do_sample=False,
                       stop_at_eos=False)[0] for p in prompts])
    log("Model.generate greedy, bf16 KV, prompts of 64 and 512 tokens, 16 "
        "new each")
    for p, o in zip(prompts, outs):
        _check_ids(o[len(p):], 16, "generate bf16")
        log(f"  prompt {len(p)}: new ids {o[len(p):]}")
    out8 = run_path("generate_int8", GEN_INT8, lambda: model.generate(
        prompts[1], max_new_tokens=16, do_sample=False, stop_at_eos=False,
        kv_dtype="int8")[0])
    _check_ids(out8[512:], 16, "generate int8")
    log(f"Model.generate greedy, int8 KV, 512-token prompt: new ids "
        f"{out8[512:]}")

    _decode_loop_vs_eager(params, prompts[0], outs[0][64])
    res = generate_fused(model, params, prompts[1])
    res["c5_residual_products_equal"] = check_c5_residual_rows(params,
                                                               prompts[1])
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            run_path(f"decode_loop_{mode[0]}", FUSED_DECODE[mode[0]],
                     lambda: _decode_loop_vs_eager(params, prompts[0],
                                                   outs[0][64], mode))
    res.update(run_path("ab_legs", ("qmm4_npack", "flash_decode",
                                    "flash_decode_i8")
                        + FUSED_DECODE["fused_glu"],
                        lambda: ab_device_legs(params)))

    d128, d1975 = decode_ms(params, 128), decode_ms(params, T_PREFILL)
    log(f"decode (slope n=4..36, batch 1, bf16 KV): fill 128 {d128:.3f} "
        f"ms/token ({1e3 / d128:.1f} tok/s), fill 1975 {d1975:.3f} ms/token "
        f"({1e3 / d1975:.1f} tok/s)")
    d1975_i8 = decode_ms(params, T_PREFILL, kv_dtype=torch.int8)
    log(f"leg decode_i8kv (slope, batch 1, int8 KV): fill 1975 "
        f"{d1975_i8:.3f} ms/token ({1e3 / d1975_i8:.1f} tok/s)")
    b8 = decode_ms(params, 128, batch=8, kv_dtype=torch.int8)
    log(f"leg batch8 (slope, batch 8, int8 KV, fill 128): {b8:.3f} ms/step "
        f"({8e3 / b8:.1f} tok/s aggregate)")
    ttft, ttft_i8 = ttft_ms(params), ttft_ms(params, torch.int8)
    log(f"TTFT 1975-token prefill (last-row logits): bf16 KV {ttft:.2f} ms, "
        f"int8 KV {ttft_i8:.2f} ms")
    res.update(ab_host_legs(params))
    res.update(decode_ms_fill128=d128, decode_ms_fill1975=d1975,
               decode_i8kv_ms_fill1975=d1975_i8, batch8_step_ms=b8,
               batch8_tok_s=8e3 / b8, ttft_1975_ms=ttft,
               ttft_1975_int8kv_ms=ttft_i8)
    return res


def _decode_loop_vs_eager(params, prompt, first, mode=None):
    """decode_loop replays one CUDA graph per token: it must give the ids
    of the same steps run eagerly, and write the same KV cache; with
    ``mode``, the graph's K1 launches are those of its fusion switches."""
    caches = [init_cache(CFG, 1, 256, device=DEV) for _ in range(2)]
    with torch.inference_mode():
        for c in caches:
            prefill_step(params, torch.tensor([prompt], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV), c)
        token = torch.tensor([[first]], device=DEV)
        pos = torch.tensor([len(prompt)], device=DEV)
        if mode is not None:
            g = _StepGraph(params, token, pos, init_cache(CFG, 1, 256,
                                                          device=DEV))
            check_step_launches(g.launches, mode, "decode_loop's graph")
            del g
        graphed = decode_loop(params, token, pos, caches[0], 12)[:, 0]
        eager = []
        for _ in range(12):
            logits = params(token, pos, caches[1], logits_dtype=torch.bfloat16)
            token = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos = pos + 1
            eager.append(int(token))
    what = "" if mode is None else f" ({mode[0]})"
    if graphed.tolist() != eager:
        raise AssertionError(f"decode_loop{what} {graphed.tolist()} != eager "
                             f"steps {eager}")
    if not torch.equal(caches[0].k, caches[1].k):
        raise AssertionError(f"decode_loop{what} wrote another KV cache than "
                             "the eager steps")
    log(f"decode_loop{what} (CUDA graph) = eager steps: {eager}")
    del caches


# the kernels a fused path must launch, by mode; the prefill's products
# (M = 64 or 512) take K5 or K2 as before
FUSED_DECODE = {
    "fused": ("qmm4_npack_fused", "qmm4_npack_fused+rms",
              "qmm4_npack_fused+res", "flash_decode"),
    "fused_glu": ("qmm4_npack_fused", "qmm4_npack_fused+rms",
                  "qmm4_npack_fused+res", "qmm4_npack_fused+glu",
                  "flash_decode")}


def _step_rows(model, cfg, ids, feed, kv_dtype=torch.bfloat16, cache=None):
    """The logits [V] (f32, on the CPU) of the prefill's last row and of
    one decode step per id of ``feed``, on the model's device, into a new
    cache or ``cache`` (which then holds the prompt for later steps).
    Decode steps take the prompt length, which a prefix-LM model reads."""
    dev = model.device
    if cache is None:
        cache = init_cache(cfg, 1, len(ids) + len(feed) + 1, kv_dtype,
                           device=dev)
    logits = prefill_step(model, torch.tensor([ids], device=dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    return [logits[0, -1].float().cpu()] + _decode_rows(model, len(ids),
                                                        feed, cache)


def _decode_rows(model, n, feed, cache):
    """The logits rows (f32, on the CPU) of one decode step per id of
    ``feed`` after a prompt of ``n`` tokens that ``cache`` holds."""
    dev = model.device
    rows = []
    for step, tok in enumerate(feed):
        logits = model_step(model, torch.tensor([[tok]], device=dev),
                            torch.tensor([n + step], device=dev),
                            cache, torch.tensor([n], device=dev))
        rows.append(logits[0, -1].float().cpu())
    return rows


def _penalized(row, history):
    """``Model.generate``'s penalized logits (repetition penalty 1.1 over
    the last 64 ids of ``history``) of one step's row [V]."""
    sp = SamplingParams(greedy=True)
    hist = torch.tensor([history[-sp.repeat_last_n:]], dtype=torch.long)
    counts = token_counts(hist, torch.ones_like(hist, dtype=torch.bool),
                          row.shape[-1])
    return apply_penalties(row[None], counts, sp)[0]


def generate_fused(model, params, prompt, n_new=16):
    """``Model.generate`` (512-token prompt, greedy, bf16 KV) unfused, fused
    and fused with GLU, each a path with launch counts; then each mode's
    logits, teacher-forced on the unfused ids, against the unfused ones:
    the fused ids equal the unfused wherever the unfused penalized top-2
    margin exceeds twice the step's logit difference times the penalty,
    up to the first step where the runs part. Returns the largest
    difference per mode, relative to max|logit|."""
    new = {}
    for mode in MODES:
        with fusion(mode):
            out = run_path(f"generate_{mode[0]}", FUSED_DECODE.get(
                mode[0], ("qmm4_npack",)), lambda: model.generate(
                    prompt, max_new_tokens=n_new, do_sample=False,
                    stop_at_eos=False)[0])
        new[mode[0]] = out[len(prompt):]
        _check_ids(new[mode[0]], n_new, f"generate {mode[0]}")
    feed = new["unfused"]
    rows = {}
    with torch.inference_mode():
        for mode in MODES:
            with fusion(mode):
                rows[mode[0]] = _step_rows(params, CFG, prompt, feed[:-1])
    res = {}
    for name in ("fused", "fused_glu"):
        worst, proven = 0.0, 0
        for t, (a, b) in enumerate(zip(rows[name], rows["unfused"])):
            err = (a - b).abs().max().item()
            worst = max(worst, err / b.abs().max().item())
            pen = _penalized(b, prompt + feed[:t]).topk(2).values
            if (pen[0] - pen[1]).item() > 2 * 1.1 * err:
                proven += 1
                if new[name][t] != feed[t]:
                    raise AssertionError(
                        f"generate {name} id {new[name][t]} != unfused "
                        f"{feed[t]} at step {t} despite the margin")
            if new[name][t] != feed[t]:
                break
        log(f"Model.generate {name} (512-token prompt): ids {new[name]}, "
            f"unfused {feed}; logits against unfused, teacher-forced: max "
            f"err {worst:.3g}·max|logit|; ids proven equal at {proven} "
            f"steps before the runs part")
        # without GLU the fused step computes the unfused one's values (the
        # same roundings); with GLU the activation is rounded once where
        # the graph rounds it twice, and over 32 layers of random weights
        # the logits part by a few 1e-2·max|logit| (H100), wider than most
        # decode steps' margins: only the prefill, whose M = 512 products
        # are not fused, is sure to be proven there. Phase 5 holds the GLU
        # steps against the CPU's GLU path, with the same roundings
        if proven < (3 if name == "fused" else 1):
            raise AssertionError(f"generate {name}: too few steps with a "
                                 "margin wide enough to compare the ids")
        # C5: the fused rms prologue and the unfused graph's norm kernel
        # share one row-scale routine, so without GLU every logit is equal
        if name == "fused" and (worst != 0.0 or new[name] != feed):
            raise AssertionError(f"C5: fused logits part from unfused by "
                                 f"{worst}·max|logit| (ids {new[name]}, "
                                 f"unfused {feed})")
        res[f"generate_{name}_rel_err"] = worst
    return res


def check_c5_residual_rows(params, prompt, rows=16):
    """C5 over the 7B's own residual stream: the input of every block's
    attention norm and of the final norm, captured from an unfused prefill
    of ``prompt``, ``rows`` positions at a time (K1's widest M), through
    the fused rms prologue (q/k/v, and the lm_head for the final norm)
    against the unfused chain on the card (the norm kernel, then K1): every
    output bit for bit. Returns the number of products compared."""
    seen = {}

    def keep(l):
        return lambda mod, args: seen.__setitem__(l, args[0][0])

    hooks = [blk.register_forward_pre_hook(keep(l))
             for l, blk in enumerate(params.layers)]
    hooks.append(params.layers[-1].register_forward_hook(
        lambda mod, args, out: seen.__setitem__("final", out[0])))
    try:
        with fusion(UNFUSED), torch.inference_mode():
            prefill_step(params, torch.tensor([prompt], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV),
                         init_cache(CFG, 1, len(prompt), device=DEV))
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator().manual_seed(13)
    sel = torch.randperm(len(prompt), generator=gen)[:rows].to(DEV)
    checked = 0
    for key, x in seen.items():
        with torch.inference_mode():
            checked += _c5_rows(params, key, x[sel].contiguous())
    log(f"C5 over the model's own residual rows ({rows} positions of a "
        f"{len(prompt)}-token prefill, every attention norm and the final "
        f"norm): {checked} fused products bit-identical to the unfused chain")
    return checked


def _c5_rows(params, key, xr):
    """Block ``key``'s q/k/v (or, for "final", the lm_head) on rows ``xr``
    of its norm's input: the fused rms prologue against the unfused chain,
    bit for bit. Returns the number of products compared."""
    if key == "final":
        pairs = [(params.final_norm_w, params.lm_head.qt, torch.float32)]
    else:
        blk = params.layers[key]
        pairs = [(blk.attn_norm_w, getattr(blk, n).qt, torch.bfloat16)
                 for n in ("wq", "wk", "wv")]
    for nw, qt, odt in pairs:
        norm = (nw, CFG.norm_eps, CFG.norm_offset)
        fused = Q.qmatmul_fused(xr, qt, odt, norm=norm)
        chain = Q.qmatmul(rms_norm(xr, *norm), qt, odt)
        if not torch.equal(fused, chain):
            d = (fused.float() - chain.float()).abs().max().item()
            raise AssertionError(f"C5: the fused rms route parts from the "
                                 f"unfused chain at {key}: {d}")
    return len(pairs)


# phase 4's device-timed legs: (name, fill, batch, KV dtype)
AB_LEGS = (("fill128_bf16", 128, 1, torch.bfloat16),
           ("fill1975_bf16", T_PREFILL, 1, torch.bfloat16),
           ("fill128_int8", 128, 1, torch.int8),
           ("fill1975_int8", T_PREFILL, 1, torch.int8),
           ("batch8_int8_fill128", 128, 8, torch.int8))
AB_REPS = 30


def _quartiles(ts):
    q = statistics.quantiles(ts, n=4)
    return dict(median=statistics.median(ts), q25=q[0], q75=q[2],
                min=min(ts), max=max(ts))


def ab_device_legs(params):
    """Each leg's decode step captured three times, once per mode, into
    ``decode_loop``'s CUDA graph (``_StepGraph``) on a cache of its own;
    the three graphs replayed in turns (the order rotated every round),
    each replay timed with CUDA events, AB_REPS replays a mode: the median
    and quartiles per mode. Each graph's K1 launches are checked against
    its mode. Then the verdict of the default rule: fused takes the place
    of unfused only if it is faster at fill 128 bf16 KV and at batch 8
    beyond the spread (its 75th percentile under unfused's 25th) and at
    no leg slower (its 25th percentile over unfused's 75th); the same rule
    for GLU against fused without it."""
    stats = {}
    for leg, fill, batch, kv in AB_LEGS:
        graphs = {}
        with torch.inference_mode():
            for mode in MODES:
                with fusion(mode):
                    cache = init_cache(CFG, batch, S_CACHE, kv, device=DEV)
                    token = torch.full((batch, 1), 17, dtype=torch.long,
                                       device=DEV)
                    pos = torch.full((batch,), fill, dtype=torch.long,
                                     device=DEV)
                    g = _StepGraph(params, token, pos, cache)
                check_step_launches(g.launches, mode, f"leg {leg}")
                graphs[mode[0]] = (g, cache)
        names = [m[0] for m in MODES]
        ts = {n: [] for n in names}
        torch.cuda.synchronize()
        for r in range(AB_REPS):
            for n in names[r % 3:] + names[:r % 3]:
                g = graphs[n][0]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                g.graph.replay()
                e1.record()
                e1.synchronize()
                _cuda.add_launches(g.launches)
                ts[n].append(e0.elapsed_time(e1))
        stats[leg] = {n: _quartiles(t) for n, t in ts.items()}
        log(f"A/B leg {leg} (device time of one graph replay, {AB_REPS} "
            "each, in turns): " + "; ".join(
                f"{n} median {v['median']:.4f} ms (q25 {v['q25']:.4f}, q75 "
                f"{v['q75']:.4f}, min {v['min']:.4f}, max {v['max']:.4f})"
                for n, v in stats[leg].items()))
        del graphs
        torch.cuda.empty_cache()

    def verdict(new, old):
        faster = lambda leg: stats[leg][new]["q75"] < stats[leg][old]["q25"]
        slower = [leg for leg in stats
                  if stats[leg][new]["q25"] > stats[leg][old]["q75"]]
        return faster("fill128_bf16") and faster("batch8_int8_fill128") \
            and not slower, slower
    fused_on, fused_slower = verdict("fused", "unfused")
    glu_on, glu_slower = verdict("fused_glu", "fused")
    log(f"A/B verdict on {smi_line()}: fused over unfused: "
        f"{'faster' if fused_on else 'not faster'} at fill 128 bf16 and "
        f"batch 8, slower at {fused_slower or 'no leg'} -> this run "
        f"{'meets' if fused_on else 'does not meet'} the rule for "
        f"NTPU_FUSED_DECODE on; GLU over fused: "
        f"{'faster' if glu_on else 'not faster'}, slower at "
        f"{glu_slower or 'no leg'} -> {'meets' if glu_on else 'does not meet'}"
        f" the rule for NTPU_FUSE_GLU on (the package's defaults: "
        f"models.transformer.fuse_mode, fuse_glu)")
    out = {f"ab_{leg}_{n}_ms": v["median"] for leg, d in stats.items()
           for n, v in d.items()}
    out.update(ab_fused_default=int(fused_on), ab_glu_default=int(glu_on))
    return out


def ab_host_legs(params):
    """The host-clock slope legs (decode at fill 128 bf16 KV, batch 8 int8
    KV) in each mode, and the 1975-token TTFT (whose only fused product is
    the lm_head) unfused and fused, one after the other."""
    out = {}
    for mode in MODES:
        with fusion(mode):
            out[f"decode_ms_fill128_{mode[0]}"] = decode_ms(params, 128)
            out[f"batch8_step_ms_{mode[0]}"] = decode_ms(
                params, 128, batch=8, kv_dtype=torch.int8)
            if mode is not FUSED_GLU:
                out[f"ttft_1975_ms_{mode[0]}"] = ttft_ms(params)
    log("host-clock legs by mode: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


# the kernels each format's prefill (1975 tokens, last-row lm_head at M=1)
# and decode (M=1) must launch, by the JAX package's route; int6_g128_a8 is
# ``quant_config_from_args("int6", group_size=128)`` (int8 code planes,
# int8 activations), mix_i2_ffn the JAX package's decode-bytes recipe
# (gate/up native int2 g32 sym with bf16 activations, the rest q4_j)
FORMAT_PATHS = {
    "nf4": (("qmm_general+tc", "flash_prefill"),
            ("qmm_general+gemv", "flash_decode")),
    "q4_0": (("qmm_general+tc", "qmm4_npack", "flash_prefill"),
             ("qmm4_npack", "flash_decode")),
    "q4_j_i8_g128": (("quantize_act_i8", "qmm_a8_asym", "qmm4_npack_asym",
                      "flash_prefill"), ("qmm4_npack_asym", "flash_decode")),
    "int6_g128_a8": (("quantize_act_i8", "qmm_a8_int8", "qmm8_native",
                      "flash_prefill"), ("qmm8_native", "flash_decode")),
    "mix_i2_ffn": (("quantize_act_i8", "qmm_a8", "qmm_general+tc", "qmm4_npack",
                    "flash_prefill"),
                   ("qmm4_npack", "qmm2_npack", "flash_decode")),
}


# the formats whose sym codes at rest take K1's other fused entry points
# (int6 g128 a8: int8 code planes everywhere; mix_i2_ffn: int2 gate/up
# beside its q4_j rest): the plain entries their unfused generate must
# launch, and the fused ones of a short paged bf16 server run (the fused
# path is the card's default)
UNFUSED_FORMAT_PATHS = {"int6_g128_a8": ("qmm8_native",),
                        "mix_i2_ffn": ("qmm2_npack", "qmm4_npack")}
FUSED_SERVER_PATHS = {
    "int6_g128_a8": ("qmm8_native_fused", "qmm8_native_fused+rms",
                     "qmm8_native_fused+res", "paged_decode"),
    "mix_i2_ffn": ("qmm2_npack_fused", "qmm2_npack_fused+rms",
                   "qmm4_npack_fused", "qmm4_npack_fused+res",
                   "paged_decode"),
}


# ---------------------------------------------------------------------------
# phase 4i: sampling, beams, batches of prompts and StreamingLLM on the 7B
# ---------------------------------------------------------------------------

# the kernels each path of phase 4i must launch: a prefill of 256 tokens or
# more (K2, K3) and decode steps (K1, K4)
GEN_PREFILL = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
GEN_STEPS = ("qmm4_npack", "flash_decode")
SAMPLED = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
N_SAMPLED = 32


def _host_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def step_graphs_ms(params, fill, batch, reps=AB_REPS):
    """The device time of one decode step at ``fill``, batch ``batch``, for
    the sampled step (one captured ``_SampledStep``, ``sample_loop``'s
    graph: top-k 40, top-p 0.95, temperature 0.8, the penalty over a 64-id
    history; the noise refill and one replay) and the greedy one
    (``_StepGraph``, ``decode_loop``'s graph), each on a cache of its own,
    replayed in turns with CUDA events around each; each state is put back
    to ``fill`` before its replay. Returns the quartiles of each."""
    g = torch.Generator().manual_seed(17)
    token = torch.full((batch, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((batch,), fill, dtype=torch.long, device=DEV)
    hist = torch.randint(3, V, (batch, 64), generator=g).to(DEV)
    with torch.inference_mode():
        st = _SampledStep(params, init_cache(CFG, batch, S_CACHE, device=DEV),
                          SAMPLED, token, pos, hist, generator=torch.Generator(
                              device=DEV).manual_seed(1))
        st.capture()
        greedy = _StepGraph(params, token, pos,
                            init_cache(CFG, batch, S_CACHE, device=DEV))
        steps = {"sampled": (st.step, st.pos),
                 "greedy": (greedy.replay, greedy.pos)}
        ts = {n: [] for n in steps}
        for r in range(reps + 1):
            for n, (fn, p) in steps.items():
                p.fill_(fill)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                if r:                         # the first round warms up
                    ts[n].append(e0.elapsed_time(e1))
    del st, greedy
    return {n: _quartiles(t) for n, t in ts.items()}


def _sampled_step_draws(params):
    """``sample_loop``'s graphed step draws anew at each replay: 16 replays
    from one pinned state (token, position and cache slot put back each
    time) give more than one id, where a draw baked into the graph would
    give one; and a seed fixes the ids: two runs from one seed give the
    same ids, another seed other ids."""
    token = torch.full((1, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((1,), 128, dtype=torch.long, device=DEV)
    with torch.inference_mode():
        st = _SampledStep(params, init_cache(CFG, 1, 256, device=DEV),
                          SAMPLED, token, pos, generator=torch.Generator(
                              device=DEV).manual_seed(3))
        st.capture()
        pinned = []
        for _ in range(16):
            st.token.fill_(17)
            st.pos.fill_(128)
            pinned.append(int(st.step()[0]))
    if len(set(pinned)) < 2:
        raise AssertionError(f"16 replays of the sampled step from one "
                             f"state drew one id: {pinned}")
    del st

    def ids(seed):
        cache = init_cache(CFG, 1, 256, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return sample_loop(params, token, pos, cache, 16, SAMPLED,
                           gen)[:, 0].tolist()

    a, b, c = ids(7), ids(7), ids(8)
    if a != b or a == c:
        raise AssertionError(f"sample_loop seeds: {a} / {b} / {c}")
    log(f"sample_loop's graph: 16 replays from one pinned state drew "
        f"{len(set(pinned))} distinct ids {pinned}; seed 7 gave {a} twice, "
        f"seed 8 {c}")


def _batched_rows(model, prompts, feed):
    """The logits rows of a padded batch, teacher-forced: the ragged
    prefill's last real rows, then one batched step per id of ``feed`` (a
    list per row); a list over steps of [B, V] f32 on the CPU."""
    B, n = len(prompts), len(feed[0])
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    toks = torch.zeros((B, int(lens.max())), dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    cache = init_cache(CFG, B, int(lens.max()) + n + 1, device=DEV)
    rows = [_prefill_ragged(model, toks.to(DEV), lens, cache).float().cpu()]
    for t in range(n - 1):
        tok = torch.tensor([[f[t]] for f in feed], device=DEV)
        rows.append(model_step(model, tok, lens + t, cache)[:, -1]
                    .float().cpu())
    return rows


def _proven_equal(got, want, refs, others, histories, what):
    """Ids ``got`` against ``want`` step by step: each step's logits row of
    the reference (``refs``) against the other computation's (``others``);
    where the reference's penalized top-2 margin exceeds twice the largest
    difference times the penalty 1.1 the argmax is proven the same, and the
    ids may part only at a step not proven. ``histories`` None: no penalty
    (margin over twice the difference). Returns the steps proven."""
    proven = 0
    for t, (a, b) in enumerate(zip(others, refs)):
        err = (a - b).abs().max().item()
        if histories is None:
            pen, rp = b.topk(2).values, 1.0
        else:
            pen, rp = _penalized(b, histories + want[:t]).topk(2).values, 1.1
        sure = (pen[0] - pen[1]).item() > 2 * rp * err
        if got[t] != want[t]:
            if sure:
                raise AssertionError(f"{what}: id {got[t]} != {want[t]} at "
                                     f"step {t} despite the margin")
            break
        proven += sure
    return proven


def _batch_of_prompts(model, params):
    """``Model.generate`` over four ragged prompts (128, 512, 1024 and 1975
    tokens, 32 new each, greedy): the padded prefill's time, the batched
    step's, and the ids against the row-wise ``Model.generate``'s where the
    margins prove them (the batch prefills the 128-token row through K2 at
    M = 7900 where the row alone takes K5, and decodes at M = 4)."""
    g = torch.Generator().manual_seed(19)
    prompts = [torch.randint(3, V, (n,), generator=g).tolist()
               for n in (128, 512, 1024, T_PREFILL)]
    kw = dict(max_new_tokens=N_SAMPLED, stop_at_eos=False, ignore_prompt=True)
    out, total = _host_ms(lambda: run_path(
        "generate_batch4", GEN_PREFILL, lambda: model.generate(prompts,
                                                               **kw)))
    for o in out:
        _check_ids(o, N_SAMPLED, "generate batch of 4")
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    toks = torch.zeros((4, T_PREFILL), dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    toks = toks.to(DEV)

    def prefill():
        cache = init_cache(CFG, 4, T_PREFILL + N_SAMPLED, device=DEV)
        return _host_ms(lambda: _prefill_ragged(params, toks, lens,
                                                cache))[1]

    prefill()
    pre = min(prefill() for _ in range(3))
    step = (total - pre) / (N_SAMPLED - 1)
    rowwise = [model.generate(p, **kw)[0] for p in prompts]
    with torch.inference_mode():
        refs = [_step_rows(params, CFG, p, f[:-1])
                for p, f in zip(prompts, rowwise)]
        batch = _batched_rows(params, prompts, rowwise)
    proven = sum(_proven_equal(out[b], rowwise[b], refs[b],
                               [r[b] for r in batch], prompts[b],
                               f"batch row {b} vs row-wise")
                 for b in range(4))
    log(f"Model.generate, 4 prompts of 128/512/1024/1975 tokens, "
        f"{N_SAMPLED} new each: {total:.1f} ms; the padded prefill "
        f"(M = 4 x 1975) {pre:.2f} ms, then {step:.3f} ms a batched step "
        f"(host clock); ids equal the row-wise ones at {proven} steps the "
        f"margins prove, up to each row's first unproven parting")
    if proven < 4:
        raise AssertionError("batch of prompts: too few proven steps")
    return dict(batch4_prefill_ms=pre, batch4_step_ms=step,
                batch4_proven_steps=proven)


def _beams(model, params):
    """``Model.generate(num_beams=4)`` on a 128-token prompt, 32 new
    tokens: the beam step's host time (the run less the prompt's one-row
    prefill and its copy to the other rows, over its steps); one beam step
    (``_beam_step``: the eager forward of the 4 rows, ``log_softmax`` and
    the joint top-4) on the device's clock, CUDA events around each of 10
    calls after a warm-up, the median; and
    ``reorder_batch``'s device time at this run's cache (S = 160) and at S
    = 2048, bf16, against the bytes it moves."""
    g = torch.Generator().manual_seed(23)
    prompt = torch.randint(3, V, (128,), generator=g).tolist()
    out, total = _host_ms(lambda: run_path(
        "generate_beams4", ("qmm4_npack", "qmm_general", "flash_prefill",
                            "flash_decode"), lambda: model.generate(
            prompt, max_new_tokens=N_SAMPLED, num_beams=4)[0]))
    new = out[len(prompt):]
    _check_ids(new, len(new), "beam search")
    one = torch.tensor([prompt], device=DEV)

    def prefill(cache):
        prefill_step(params, one, torch.zeros(1, dtype=torch.long,
                                              device=DEV), cache.rows(0, 1))
        copy_kv(cache, [0] * 3, range(1, 4), len(prompt))

    def timed_prefill():
        cache = init_cache(CFG, 4, len(prompt) + N_SAMPLED, device=DEV)
        return _host_ms(lambda: prefill(cache))[1]

    timed_prefill()
    pre = min(timed_prefill() for _ in range(3))
    step = (total - pre) / max(1, len(new) - 1)
    ts = []
    with torch.inference_mode():
        cache = init_cache(CFG, 4, len(prompt) + N_SAMPLED, device=DEV)
        prefill(cache)
        args = (torch.full((4, 1), 17, dtype=torch.long, device=DEV),
                torch.full((4,), len(prompt), dtype=torch.long, device=DEV),
                torch.zeros(4, device=DEV), cache,
                torch.ones(4, dtype=torch.bool, device=DEV),
                torch.zeros(V, device=DEV), 4)
        for r in range(11):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _beam_step(params, *args)
            e1.record()
            e1.synchronize()
            if r:
                ts.append(e0.elapsed_time(e1))
        del cache
    dev_step = statistics.median(ts)
    res = dict(beams4_step_ms=step, beams4_step_device_ms=dev_step,
               beams4_prefill_ms=pre)
    perm = torch.tensor([1, 0, 3, 2], device=DEV)
    for S in (len(prompt) + N_SAMPLED, S_CACHE):
        cache, spare = (init_cache(CFG, 4, S, device=DEV) for _ in range(2))
        ms = time_ms([lambda: reorder_batch(cache, perm, spare)], reps=10)
        nbytes = 2 * 2 * cache.k.numel() * cache.k.element_size()
        bnd = nbytes / HBM_BPS * 1e3
        log(f"reorder_batch, 4 beams, S={S}: {ms:.4f} ms for "
            f"{nbytes / 1e9:.3f} GB read and written "
            f"({nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; bound {bnd:.4f} ms)")
        res[f"reorder_ms_S{S}"] = ms
        del cache, spare
    log(f"Model.generate num_beams=4, 128-token prompt: {total:.1f} ms, "
        f"{len(new)} new ids; one-row prefill and copy {pre:.2f} ms, then "
        f"{step:.3f} "
        f"ms a beam step (host clock, the reorder and the host's bookkeeping "
        f"included); one _beam_step {dev_step:.3f} ms on the device's clock "
        f"(median of 10, min {min(ts):.3f}, max {max(ts):.3f}); ids {new}")
    return res


def _streaming(model, params):
    """``Model.generate(streaming=True)`` with a 512-position cache, 4
    sinks, a 256-token prompt and 600 new tokens, bf16 and int8 KV: the
    shifts counted (two: at 256 and 510 new tokens), each timed on the host
    clock in the run, and one shift's device time at the 7B's width."""
    g = torch.Generator().manual_seed(29)
    prompt = torch.randint(3, V, (256,), generator=g).tolist()
    res = {}
    for kv, kvdt, attn in (("bf16", torch.bfloat16, ("flash_prefill",
                                                      "flash_decode")),
                           ("int8", torch.int8, ("flash_prefill_i8",
                                                 "flash_decode_i8"))):
        shifts, orig = [], ST.shift_cache_impl

        def counted(*a, **k):
            _, ms = _host_ms(lambda: orig(*a, **k))
            shifts.append(ms)

        ST.shift_cache_impl = counted
        try:
            out, total = _host_ms(lambda: run_path(
                f"generate_streaming_{kv}", ("qmm4_npack", "qmm_a8") + attn,
                lambda: model.generate(prompt, max_new_tokens=600,
                                       streaming=True, max_len=512, n_keep=4,
                                       kv_dtype=kv, stop_at_eos=False,
                                       ignore_prompt=True)[0]))
        finally:
            ST.shift_cache_impl = orig
        _check_ids(out, 600, f"streaming {kv}")
        if len(shifts) < 2:
            raise AssertionError(f"streaming {kv}: {len(shifts)} shifts")
        cache = init_cache(CFG, 1, 512, kvdt, device=DEV)
        dev_ms = time_ms([lambda: ST.shift_cache_impl(
            cache, params.rope_inv_freqs, CFG, 4, 254)], reps=10)
        nbytes = 2 * sum(t.numel() * t.element_size() for t in (
            cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)
        log(f"streaming {kv} KV, 512 positions, 600 new tokens: {total:.1f} "
            f"ms ({total / 600:.3f} ms a token, host clock); {len(shifts)} "
            f"shifts, host ms {[round(x, 3) for x in shifts]}; one shift's "
            f"device time {dev_ms:.4f} ms for {nbytes / 1e9:.3f} GB read and "
            f"written at most (bound {nbytes / HBM_BPS * 1e3:.4f} ms)")
        res.update({f"stream_{kv}_ms_token": total / 600,
                    f"stream_{kv}_shifts": len(shifts),
                    f"stream_{kv}_shift_ms": dev_ms})
        del cache
    return res


def _chi_square_p(draws, probs):
    """The chi-square p-value of ``draws`` [N] against ``probs`` [V] (bins
    expecting fewer than 5 draws pooled); raises on a draw outside the
    support."""
    from scipy.stats import chisquare
    counts = np.bincount(draws, minlength=len(probs))
    if counts[probs == 0].sum():
        raise AssertionError("a draw outside the kept set")
    exp = probs * len(draws)
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


def _sampler(params):
    """``sample_batched`` and ``sample`` with the filters (temperature 0.8,
    top-k 40, top-p 0.95) on one logits row over the 7B's vocab, replicated
    in 4096 rows: each one's draws against the filtered softmax that the port's plain
    filters give on the CPU (chi-square, p > 1e-4). Then the sampler's
    device times at B = 1 and 4: ``sample`` with the filters and the
    penalty, and ``sample_batched`` with filters and mirostat."""
    g = torch.Generator(device=DEV).manual_seed(31)
    row = torch.randn((1, V), generator=g, device=DEV) * 3
    bp = batch_params([SAMPLED] * 4096).to(DEV)
    tok, _ = sample_batched(row.expand(4096, V).contiguous(), bp,
                            enable=("filters",), generator=g)
    host = row.cpu() / torch.full_like(row.cpu(), SAMPLED.temperature)
    kept = top_p_filter(top_k_filter(host, SAMPLED.top_k), SAMPLED.top_p)
    kept = kept[0].double()
    probs = torch.softmax(kept, -1).numpy() * (kept.numpy() > -1e29)
    probs /= probs.sum()
    p = _chi_square_p(tok.cpu().numpy(), probs)
    tok1, _ = sample(row.expand(4096, V).contiguous(), SAMPLED, generator=g)
    p1 = _chi_square_p(tok1.cpu().numpy(), probs)
    if not (p > 1e-4 and p1 > 1e-4):
        raise AssertionError(f"draws against the filtered softmax: "
                             f"chi-square p {p} (sample_batched), {p1} "
                             "(sample)")
    res = dict(sampler_chi_square_p=p, sample_chi_square_p=p1)
    hist = torch.randint(3, V, (4, 64), device=DEV)
    for B in (1, 4):
        logits = torch.randn((B, V), generator=g, device=DEV) * 3
        noise = draw_noise((B, V), DEV, g)
        bpb = batch_params([SAMPLED] * B).to(DEV)
        mu = torch.full((B,), 10.0, device=DEV)
        ms = time_ms([lambda: sample(logits, SAMPLED, prev_tokens=hist[:B],
                                     noise=noise)], reps=10)
        msb = time_ms([lambda: sample_batched(logits, bpb, mu,
                                              prev_tokens=hist[:B],
                                              noise=noise)], reps=10)
        log(f"sampler at B={B}, vocab {V}: sample (penalty, temperature, "
            f"top-k, top-p, draw) {ms:.4f} ms; sample_batched (filters and "
            f"mirostat) {msb:.4f} ms (device)")
        res.update({f"sample_ms_B{B}": ms, f"sample_batched_ms_B{B}": msb})
    log(f"4096 draws from one 32000-wide row (top-k 40, top-p 0.95, "
        f"temperature 0.8) against the filtered softmax: chi-square p = "
        f"{p:.4g} (sample_batched), {p1:.4g} (sample)")
    return res


def phase_sampling(params):
    """Phase 4i on phase 4's 7B: ``Model.generate`` sampled (one seed twice,
    then another), ``sample_loop``'s graphed step against ``decode_loop``'s
    at fill 128 (batch 1 and 4), a batch of four ragged prompts, beam search
    (4 beams), StreamingLLM with bf16 and int8 KV, and the sampler's draws
    and device times; each ``Model.generate`` a path with its own launch
    counts."""
    model = Model().init_params(params, CFG)
    g = torch.Generator().manual_seed(37)
    prompt = torch.randint(3, V, (512,), generator=g).tolist()
    kw = dict(max_new_tokens=N_SAMPLED, do_sample=True, top_k=40, top_p=0.95,
              temperature=0.8, stop_at_eos=False, ignore_prompt=True)
    runs = [run_path(f"generate_sampled_{i}", GEN_PREFILL,
                     lambda: model.generate(prompt, seed=seed, **kw)[0])
            for i, seed in enumerate((5, 5, 6))]
    for r in runs:
        _check_ids(r, N_SAMPLED, "sampled generate")
    if runs[0] != runs[1] or runs[0] == runs[2]:
        raise AssertionError(f"sampled generate, seeds 5, 5, 6: {runs}")
    log(f"Model.generate sampled (512-token prompt, top-k 40, top-p 0.95, "
        f"temperature 0.8): seed 5 twice {runs[0]}, seed 6 {runs[2]}")
    run_path("sample_loop_seeds", GEN_STEPS,
             lambda: _sampled_step_draws(params))
    res = {}
    for B in (1, 4):
        q = run_path(f"sample_loop_B{B}", GEN_STEPS,
                     lambda: step_graphs_ms(params, 128, B))
        log(f"decode step at fill 128, batch {B} (device time of one graph "
            f"replay, {AB_REPS} each, in turns): " + "; ".join(
                f"{n} median {v['median']:.4f} ms (q25 {v['q25']:.4f}, q75 "
                f"{v['q75']:.4f})" for n, v in q.items()))
        res.update({f"{n}_step_ms_B{B}": v["median"] for n, v in q.items()})
    res.update(_batch_of_prompts(model, params))
    res.update(_beams(model, params))
    res.update(_streaming(model, params))
    res.update(_sampler(params))
    return res


def phase_formats(fmts=("nf4", "q4_0", "q4_j_i8_g128")):
    """The same 7B shape in each format of ``fmts``, one model at a time:
    ``Model.generate`` (300-token prompt, 16 new tokens, greedy, bf16 KV),
    the 1975-token TTFT and decode ms/token at fill 128, each a path of its
    own with the launch counts set to 0 just before it; a format of
    UNFUSED_FORMAT_PATHS also generates with the fused path off, and serves
    two short queries through the batch-8 paged bf16 server with it on,
    each a path of its own."""
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(3, V, (300,), generator=gen).tolist()
    res = {}
    for fmt in fmts:
        pre, dec = FORMAT_PATHS[fmt]
        t = time.time()
        params = init_random(CFG, seed=0, quant=QUANTS.get(fmt, fmt),
                             device=DEV)
        torch.cuda.synchronize()
        log(f"init_random Llama-2-7B {fmt} on the card: "
            f"{time.time() - t:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f}"
            " GiB allocated")
        model = Model().init_params(params, CFG)
        out = run_path(f"generate_{fmt}", sorted(set(pre + dec)),
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False)[0])
        _check_ids(out[300:], 16, f"generate {fmt}")
        if fmt in UNFUSED_FORMAT_PATHS:
            with fusion(UNFUSED):
                plain = run_path(f"generate_{fmt}_unfused",
                                 UNFUSED_FORMAT_PATHS[fmt],
                                 lambda: model.generate(
                                     prompt, max_new_tokens=16,
                                     do_sample=False, stop_at_eos=False)[0])
            log(f"{fmt}: Model.generate unfused new ids {plain[300:]}")
            _check_ids(plain[300:], 16, f"generate {fmt} unfused")
            with fusion(FUSED):
                _server_short(params, CFG, ((
                    f"server_{fmt}_fused", dict(kv_mode="paged",
                                                page_size=256),
                    FUSED_SERVER_PATHS[fmt], [prompt[:90], prompt[:200]],
                    8),))
        ttft = run_path(f"prefill_{fmt}", pre, lambda: ttft_ms(params))
        d128 = run_path(f"decode_{fmt}", dec, lambda: decode_ms(params, 128))
        log(f"{fmt}: Model.generate new ids {out[300:]}; TTFT 1975-token "
            f"prefill {ttft:.2f} ms; decode (slope n=4..36, batch 1, bf16 KV) "
            f"fill 128 {d128:.3f} ms/token ({1e3 / d128:.1f} tok/s)")
        res[f"{fmt}_ttft_1975_ms"] = ttft
        res[f"{fmt}_decode_ms_fill128"] = d128
        del model, params
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4c: Gemma-2-9B at full width and depth
# ---------------------------------------------------------------------------

# Gemma-2-9B as published in google/gemma-2-9b's config.json: 42 layers,
# hidden 3584, 16 heads over 8 KV heads of 256, FFN 14336, vocab 256000
# with tied embeddings, sliding window 4096 (on the even layers),
# attn_logit_softcapping 50, final_logit_softcapping 30,
# query_pre_attn_scalar 256, rope_theta 10000, max_position_embeddings
# 8192, rms_norm_eps 1e-6, hidden_activation gelu_pytorch_tanh, bos 2,
# eos 1. The (1 + w) norms, the post norms and the sqrt(hidden) embedding
# scale are the family's (neural_tpu_torch/models/gemma.py).
G2_CFG = ModelConfig(
    arch="gemma2", vocab_size=256000, hidden_size=3584, n_layers=42,
    n_heads=G2_HQ, n_kv_heads=G2_HKV, head_dim=G2_DH,
    intermediate_size=14336, norm_eps=1e-6, norm_offset=1.0,
    act="gelu_tanh", post_attn_norm=True, post_ffn_norm=True,
    attn_softcap=G2_SOFTCAP, logit_softcap=30.0, attn_scale=256 ** -0.5,
    sliding_window=G2_W, rope_theta=10000.0, tie_word_embeddings=True,
    embed_scale=math.sqrt(3584), max_seq_len=G2_S, bos_token_id=2,
    eos_token_id=1)
G2_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
G2_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8",
               "flash_decode_i8")


def phase_gemma2():
    """Gemma-2-9B at q4_j, random weights from seed 0 drawn and quantized
    on the card: ``Model.generate`` (512-token prompt, 16 new tokens) with
    bf16 and int8 KV, decode ms/token at fills 128 and 6000 (bf16 KV) and
    6000 (int8 KV), TTFT at 1975 and 6000 tokens; every cache holds 8192
    positions. Each is a path with its own launch counts."""
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = init_random(G2_CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"init_random Gemma-2-9B q4_j on the card: {time.time() - t:.1f} s, "
        f"{nbytes / 1e9:.3f} GB of weights and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    model = Model().init_params(params, G2_CFG)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(3, G2_CFG.vocab_size, (512,),
                           generator=gen).tolist()
    res = {}
    for kv, required in (("bf16", G2_GEN), ("int8", G2_GEN_INT8)):
        out = run_path(f"gemma2_generate_{kv}", required,
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False,
                                              kv_dtype=kv)[0])
        _check_ids(out[512:], 16, f"gemma2 generate {kv}", G2_CFG.vocab_size)
        log(f"gemma2 Model.generate greedy, {kv} KV, 512-token prompt: new "
            f"ids {out[512:]}")
    dec = ("qmm4_npack", "flash_decode")
    for fill, kv_dtype, required in ((128, torch.bfloat16, dec),
                                     (G2_FILL, torch.bfloat16, dec),
                                     (G2_FILL, torch.int8,
                                      ("qmm4_npack", "flash_decode_i8"))):
        kv = "int8" if kv_dtype == torch.int8 else "bf16"
        ms = run_path(f"gemma2_decode_{kv}_fill{fill}", required,
                      lambda: decode_ms(params, fill, kv_dtype=kv_dtype,
                                        cfg=G2_CFG, S=G2_S))
        log(f"gemma2 decode (slope n=4..36, batch 1, {kv} KV): fill {fill} "
            f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"gemma2_decode_{'i8kv_' if kv == 'int8' else ''}ms_fill{fill}"] \
            = ms
    for T in (T_PREFILL, G2_FILL):
        ms = run_path(f"gemma2_prefill_{T}", ("qmm_a8", "flash_prefill"),
                      lambda: ttft_ms(params, cfg=G2_CFG, T=T, S=G2_S))
        log(f"gemma2 TTFT {T}-token prefill (last-row logits, bf16 KV): "
            f"{ms:.2f} ms")
        res[f"gemma2_ttft_{T}_ms"] = ms
    res["gemma2_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"gemma2 peak device memory {res['gemma2_peak_gib']:.2f} GiB")
    del model, params
    torch.cuda.empty_cache()
    return res


def phase_gemma2_card_vs_plain():
    """A 2-layer copy of Gemma-2-9B at full width, its window cut to 32 so
    that it is active on every prompt here: ``Model.generate`` on the card
    (300-token prompt, 4 new tokens; a path with launch counts), its
    logits fed the card's ids against the plain path on the card's own
    tensors (``plain_on_card``); then, on this copy, the paged int8
    Scheduler check that phase 5 runs on the Llama copy (prompts of 20-64
    tokens)."""
    cfg2 = dataclasses.replace(G2_CFG, n_layers=2, sliding_window=32)
    card = init_random(cfg2, seed=3, quant="q4_j", device=DEV)
    gen = torch.Generator().manual_seed(10)
    ids = torch.randint(3, cfg2.vocab_size, (300,), generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path("card_gemma2", G2_GEN, lambda: model.generate(
        ids, max_new_tokens=4, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    _check_ids(new, 4, "card gemma2", cfg2.vocab_size)
    rel_tol = 5e-2     # int8 activation codes can move, as for q4_j Llama
    worst, provable, _ = _steps_card_vs_plain(card, cfg2, ids, new[:3],
                                              rel_tol)
    log(f"gemma2 card vs plain (2 layers, full width, window 32, 300-token "
        f"prompt, fed the card's ids {new}): logits max err "
        f"{worst:.3g}·max|logit| (tol {rel_tol}); argmax provably "
        f"comparable at {provable} of 4 steps, equal at all of them")
    if provable < 2:
        raise AssertionError("too few gemma2 steps with a margin wide "
                             "enough to compare the argmax")
    sched_worst = _sched_card_vs_plain(card, cfg2, rel_tol)
    del card, model
    torch.cuda.empty_cache()
    return dict(gemma2_card_vs_plain_rel_err=worst,
                gemma2_sched_card_vs_plain_rel_err=sched_worst)


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the card's own tensors
# ---------------------------------------------------------------------------


def _compare_rows(card_rows, host_rows, rel_tol, what="card vs plain"):
    """Logits rows of the card and of the plain path: within
    ``rel_tol`` of max|logit| at every step, and the argmax equal wherever
    the plain top-2 margin exceeds twice that step's largest logit
    difference. Returns (worst relative difference, steps so proven,
    argmax equal at each step)."""
    worst, provable, sames = 0.0, 0, []
    for step, (a, b) in enumerate(zip(card_rows, host_rows)):
        err = (a - b).abs().max().item()
        tol = rel_tol * b.abs().max().item()
        worst = max(worst, err / b.abs().max().item())
        top2 = b.topk(2).values
        margin = (top2[0] - top2[1]).item()
        same = int(a.argmax()) == int(b.argmax())
        sames.append(same)
        log(f"  step {step}: max |card - plain| {err:.4g}, max|logit| "
            f"{b.abs().max().item():.4g}, plain top-2 margin {margin:.4g}, "
            f"argmax equal {same}")
        if not err <= tol:
            raise AssertionError(f"{what} logits, step {step}: max err "
                                 f"{err} > {tol}")
        if margin > 2 * err:
            provable += 1
            if not same:
                raise AssertionError(f"{what} argmax differs at step {step} "
                                     f"despite margin {margin}")
    return worst, provable, sames


def _plain_rows(model, cfg, ids, feed, **kw):
    """:func:`_step_rows` through the plain path on the card's own
    tensors."""
    with plain_on_card():
        return _step_rows(model, cfg, ids, feed, **kw)


def _steps_card_vs_plain(card, cfg2, ids, feed, rel_tol):
    """Logits of the prefill's last row and of one decode step per id of
    ``feed``, through the kernels and through the plain path on the same
    card tensors, held to each other by :func:`_compare_rows`."""
    return _compare_rows(_step_rows(card, cfg2, ids, feed),
                         _plain_rows(card, cfg2, ids, feed), rel_tol)


def phase_card_vs_plain():
    """Phase 5's one-layer q4_j copy: the kernels against the plain path on
    the card's own tensors (``plain_on_card``; on the host's CPU this plain
    side took two minutes of the script's limit)."""
    cfg2 = dataclasses.replace(CFG, n_layers=COPY_LAYERS)
    card = init_random(cfg2, seed=1, quant="q4_j", device=DEV)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(3, V, (300,), generator=gen).tolist()
    n_new = 8
    with fusion(UNFUSED):
        g_card = greedy_generate(card, cfg2, ids, max_new_tokens=n_new + 1,
                                 stop_at_eos=False)[len(ids):]
        with plain_on_card():
            g_host = greedy_generate(card, cfg2, ids,
                                     max_new_tokens=n_new + 1,
                                     stop_at_eos=False)[len(ids):]
    # bf16 activations: last-bit differences (split-K order in K1 and K5,
    # where K3 rounds P, the card's rsqrt/exp) move int8 activation codes
    # of the next K2 product by a step, and layers amplify that; the
    # tiny model shows 1.8e-2 between the JAX package and the port on the
    # CPU
    rel_tol = 5e-2
    feed = g_card[:n_new]
    host_cache = init_cache(cfg2, 1, len(ids) + N_STEPS, device=DEV)
    with fusion(UNFUSED):
        host_rows = _plain_rows(card, cfg2, ids, feed, cache=host_cache)
        card_rows = _step_rows(card, cfg2, ids, feed)
    worst, provable, sames = _compare_rows(card_rows, host_rows, rel_tol)
    for step in range(n_new):
        if all(sames[:step + 1]) and g_host[step] != g_card[step]:
            raise AssertionError(f"free-running greedy ids differ at step "
                                 f"{step} while every argmax so far agreed")
    log(f"card unfused vs plain ({cfg2.n_layers} layer(s), full width, "
        f"300-token prompt): "
        f"logits max err {worst:.3g}·max|logit| (tol {rel_tol}); greedy card "
        f"{g_card}, plain {g_host}; argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    if provable < 3:
        raise AssertionError("too few steps with a margin wide enough to "
                             "compare the argmax")
    fused_worst = _fused_card_vs_plain(card, cfg2, ids, feed, g_host,
                                       host_rows, rel_tol)
    fused_worst.update(_fused_steps_card_vs_plain(card, len(ids),
                                                  host_cache))
    sched_worst = _sched_card_vs_plain(card, cfg2, rel_tol)
    fused_worst.update(_sched_beyond_greedy_card_vs_plain(card, cfg2, ids,
                                                          rel_tol))
    fused_worst.update(_sampling_card_vs_plain(card, cfg2, ids, rel_tol))
    del card
    # the formats' copies are cut to one layer, which runs every kernel of
    # each format, to keep the script inside its time limit
    return worst, sched_worst, fused_worst, _formats_card_vs_plain(cfg2)


@contextlib.contextmanager
def _ranked(module, calls, forced=None):
    """Record each ``rank_beams`` call made through ``module`` (the
    Scheduler's or ``runtime.beam``'s): its logits rows, scores, alive and
    stop masks and the parents, ids and scores it chose, on the CPU. With
    ``forced`` (another run's records), call k returns that run's k-th
    choice in place of its own, so this run follows the other's beams
    (teacher forcing) while its own choice is recorded beside them."""
    orig = module.rank_beams

    def rec(logits, scores, alive, eos_mask, W):
        out = orig(logits, scores, alive, eos_mask, W)
        calls.append(dict(logits=logits.double().cpu(),
                          scores=scores.double().cpu(), alive=alive.cpu(),
                          eos=eos_mask.double().cpu(), parents=out[0].cpu(),
                          ids=out[1].cpu(), new=out[2].cpu()))
        if forced is None:
            return out
        if len(calls) > len(forced):
            raise AssertionError(f"the forced run ranked {len(calls)} "
                                 f"expansions, the run it follows "
                                 f"{len(forced)}")
        c, dev = forced[len(calls) - 1], logits.device
        return c["parents"].to(dev), c["ids"].to(dev), c["new"].to(dev)

    module.rank_beams = rec
    try:
        yield
    finally:
        module.rank_beams = orig


def _totals(c):
    logp = torch.log_softmax(c["logits"], -1) + c["eos"][None]
    logp = torch.where(c["alive"][:, None], logp, torch.full_like(logp,
                                                                  -1e30))
    return (c["scores"][:, None] + logp).reshape(-1)


def _rows_apart(got, ref):
    """Per expansion of two runs of one beam group (``_ranked`` records),
    the largest difference of their live rows' logits over the
    reference's largest |logit|."""
    out = []
    for a, b in zip(got, ref):
        live = a["alive"] & b["alive"]
        la, lb = a["logits"][live], b["logits"][live]
        out.append((la - lb).abs().max().item() / lb.abs().max().item())
    return out


def _beams_held(got, ref, W, rel_tol, what):
    """A beam group's expansions (``got``) against a reference run forced
    to follow its beams (``ref``, :func:`_ranked` with ``forced=got``): at
    every expansion the live rows' logits within rel_tol·max|logit| of
    the reference's (a row reordered wrong, or logits left from another
    step, sees another history), and the run's choice the joint top W of
    its own rows' totals (score plus log-prob, f64, up to a 1e-4 tie). An
    expansion is proven where the reference's top W+1 totals lie each
    more than twice the largest total difference apart: there the
    reference's own choice must be the run's. Returns (worst relative
    difference, expansions proven)."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} expansions, the forced "
                             f"reference {len(ref)}")
    apart = _rows_apart(got, ref)
    proven = 0
    for k, (a, b) in enumerate(zip(got, ref)):
        if not apart[k] <= rel_tol:
            raise AssertionError(f"{what}: expansion {k}: logits apart by "
                                 f"{apart[k]:.4g}·max|logit| (tol "
                                 f"{rel_tol})")
        ta, tb = _totals(a), _totals(b)
        chosen = a["parents"].long() * a["logits"].shape[-1] + a["ids"].long()
        rest = torch.ones_like(ta, dtype=torch.bool)
        rest[chosen] = False
        tie = 1e-4 * max(1.0, ta.max().abs().item())
        if ta[chosen].min() < ta[rest].max() - tie:
            raise AssertionError(f"{what}: expansion {k} chose beyond the "
                                 f"top {W} of its own rows")
        live = (ta > -1e29) & (tb > -1e29)
        delta = (ta - tb)[live].abs().max().item()
        top = tb.topk(W + 1).values
        top = top[top > -1e29]
        sure = bool(((top[:-1] - top[1:]) > 2 * delta).all())
        if sure and not (torch.equal(a["parents"], b["parents"])
                         and torch.equal(a["ids"], b["ids"])):
            raise AssertionError(f"{what}: expansion {k}: the reference "
                                 f"chose otherwise despite the margins "
                                 f"(delta {delta})")
        proven += sure
    return max(apart), proven


def _beams_card_vs_plain(card, cfg2, ids, rel_tol):
    """Beam search (4 beams, 8 new tokens, a 24-token prompt) through the
    kernels against the plain path on the same card tensors: rank by rank, equal ids and scores within
    2·rel_tol·max|logit| (a score is a mean of log-probs, each within twice
    a logit's difference), except at a near tie of the plain run's scores
    (within the same bound), which a rounding may order either way."""
    prompt = ids[:24]
    hyps = run_path("card_vs_plain_beams", ("qmm4_npack", "qmm_general",
                                            "flash_prefill", "flash_decode"),
                    lambda: beam_search(card, cfg2, prompt, beam_size=4,
                                        max_new_tokens=8))
    with plain_on_card():
        ref = beam_search(card, cfg2, prompt, beam_size=4, max_new_tokens=8)
    scale = _plain_rows(card, cfg2, prompt, [])[0].abs().max().item()
    tol = 2 * rel_tol * scale
    equal, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(hyps, ref)):
        if a.ids != b.ids:
            gaps = [abs(b.score - r.score) for r in ref if r is not b]
            if not gaps or min(gaps) >= tol:
                raise AssertionError(f"beam {i}: card {a.ids} != plain "
                                     f"{b.ids} with no near tie")
            continue
        worst = max(worst, abs(a.score - b.score))
        if abs(a.score - b.score) > tol:
            raise AssertionError(f"beam {i}: score {a.score} against "
                                 f"{b.score} (tol {tol})")
        equal += 1
    log(f"beam search card vs plain ({cfg2.n_layers} layer(s)): {equal} of "
        f"{len(ref)} hypotheses equal, scores within {worst:.3g} (tol "
        f"{tol:.3g}); card {[h.ids[len(prompt):] for h in hyps]}, plain "
        f"{[h.ids[len(prompt):] for h in ref]}")
    if equal < 1:
        raise AssertionError("beam search: no hypothesis held equal")
    return worst


def _shift_card_vs_plain(card, cfg2, ids):
    """The first StreamingLLM shift of a full 64-position cache (4 sinks, 30
    dropped), prefilled on the card by the plain path and copied to the
    host's CPU: shifted on both sides, the values and their scales equal,
    bf16 keys within one bf16 step (at most 2^-7 relative: the rotation's
    f32 cos/sin may round an ulp apart), int8 key codes within one step
    and their scales within one bf16 step."""
    worst = {}
    for kvdt in (torch.bfloat16, torch.int8):
        cc = init_cache(cfg2, 1, 64, kvdt, device=DEV)
        with plain_on_card():
            prefill_step(card, torch.tensor([ids[:64]], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV), cc)
        hc = type(cc)(*(None if t is None else t.cpu()
                        for t in (cc.k, cc.v, cc.k_scale, cc.v_scale)))
        inv = card.rope_inv_freqs
        ST.shift_cache_impl(hc, inv.cpu(), cfg2, 4, 30)
        ST.shift_cache_impl(cc, inv, cfg2, 4, 30)
        for name in ("v", "v_scale"):
            a, b = getattr(cc, name), getattr(hc, name)
            if b is not None and not torch.equal(a.cpu(), b):
                raise AssertionError(f"shift {kvdt}: {name} differs")
        k, rk = cc.k.cpu().float(), hc.k.float()
        if kvdt == torch.int8:
            ks, rks = cc.k_scale.cpu().float(), hc.k_scale.float()
            ok = (k - rk).abs().max() <= 1 and bool(
                ((ks - rks).abs() <= 2 ** -7 * rks.abs()).all())
        else:
            ok = bool(((k - rk).abs() <= 2 ** -7 * rk.abs() + 1e-6).all())
        worst[str(kvdt)] = (k - rk).abs().max().item()
        if not ok:
            raise AssertionError(f"shift {kvdt}: keys part by "
                                 f"{worst[str(kvdt)]}")
    log(f"StreamingLLM shift card vs plain (64 positions, 4 sinks, 30 "
        f"dropped): values equal, keys within {worst}")
    return worst


def _lm_head_32001_card_vs_plain(rel_tol):
    """C7: a one-layer copy with a quantized lm_head over a vocab of 32001
    (an untied fine-tune's), which neither K1 nor K5 takes (both refuse it
    on the card, checked): its products take the counted ``qmm_plain``
    route, the prefill's last row and every decode step, held against the
    plain path as phase 5's copy is."""
    cfg3 = dataclasses.replace(CFG, n_layers=COPY_LAYERS, vocab_size=32001)
    card = init_random(cfg3, seed=4, quant="q4_j", device=DEV)
    qt = card.lm_head.qt
    if Q.route(1, D, 32001, qt) != "plain":
        raise AssertionError("the 32001-wide lm_head does not route plain")
    x = torch.randn((1, D), device=DEV).bfloat16()
    for what, fn in (("K1", lambda: Q.qmm_native(
            x, qt.planes[0], qt.scales, None, qt.group_size, 4,
            torch.float32)), ("K5", lambda: Q.qmm_general(
                x, qt, torch.float32))):
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"{what} took N = 32001")
    g = torch.Generator().manual_seed(41)
    ids = torch.randint(3, 32001, (24,), generator=g).tolist()
    feed = torch.randint(3, 32001, (4,), generator=g).tolist()
    rows = run_path("card_lm_head_32001", ("qmm_plain", "qmm4_npack",
                                           "flash_prefill", "flash_decode"),
                    lambda: _step_rows(card, cfg3, ids, feed))
    plain = LAUNCHES["card_lm_head_32001"]["qmm_plain"]
    worst, provable, _ = _compare_rows(rows, _plain_rows(card, cfg3, ids,
                                                         feed),
                                       rel_tol, "lm_head 32001 card vs plain")
    log(f"C7: lm_head over 32001 through qmm_plain ({plain} products; K1 and "
        f"K5 refuse it): logits max err {worst:.3g}·max|logit| (tol "
        f"{rel_tol}), argmax provably comparable at {provable} of "
        f"{len(feed) + 1} steps, equal at all of them")
    del card
    return worst


def _sampling_card_vs_plain(card, cfg2, ids, rel_tol):
    """Phase 5's checks of the sampling slice on its one-layer copy."""
    return {"beams_card_vs_plain_score_err": _beams_card_vs_plain(
                card, cfg2, ids, rel_tol),
            "shift_card_vs_plain_k_err": _shift_card_vs_plain(card, cfg2,
                                                              ids),
            "lm_head_32001_card_vs_plain_rel_err":
                _lm_head_32001_card_vs_plain(rel_tol)}


def _fused_card_vs_plain(card, cfg2, ids, feed, g_host, host_rows, rel_tol):
    """Phase 5's copy on the card with the fused path on (and with GLU),
    held against the unfused plain path's rows already computed: the
    plain fused path without GLU is the unfused chain bit for bit, so the
    unfused reference stands for it; with GLU the activation is
    rounded once where the unfused graph rounds twice, one bf16 step of
    h (2^-8 relative) at some elements, well inside the same 5e-2.
    Greedy ids on the card equal the plain path's up to the first step
    where an argmax is unproven or the runs part."""
    res = {}
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            rows = run_path(f"card_vs_plain_{mode[0]}",
                            FUSED_DECODE[mode[0]],
                            lambda: _step_rows(card, cfg2, ids, feed))
            g_fused = greedy_generate(card, cfg2, ids,
                                      max_new_tokens=len(feed) + 1,
                                      stop_at_eos=False)[len(ids):]
        worst, provable, sames = _compare_rows(
            rows, host_rows, rel_tol, f"card {mode[0]} vs plain")
        for step in range(len(feed)):
            if all(sames[:step + 1]) and g_host[step] != g_fused[step]:
                raise AssertionError(f"{mode[0]}: greedy ids differ at step "
                                     f"{step} while every argmax so far "
                                     "agreed")
        log(f"card {mode[0]} vs plain ({cfg2.n_layers} layer(s)): logits "
            f"max err "
            f"{worst:.3g}·max|logit| (tol {rel_tol}); greedy card {g_fused}, "
            f"plain {g_host}; argmax provably comparable at {provable} of "
            f"{len(feed) + 1} steps, equal at all of them")
        if provable < 3:
            raise AssertionError(f"{mode[0]}: too few steps with a margin "
                                 "wide enough to compare the argmax")
        res[f"card_vs_plain_{mode[0]}_rel_err"] = worst
    return res


# phase 5's fused decode steps from one cache, card against the CPU's plain
# path under the same switches. The card's steps part from the CPU's by
# 8.5e-3 (fused) and 9.0e-3·max|logit| (fused + GLU) on this copy (H100,
# first run), K4's and K1's last bits against the plain versions', with or
# without GLU: 2e-2, under the 5e-2 of the teacher-forced run with its
# prefill. GLU's single rounding of act(g)·u moves one layer's logits by
# 4.6e-3·max|logit| on the CPU, under that noise, so the card's own GLU
# shift (GLU on against off, on the card) is what is held to the CPU's:
# within a factor of GLU_SHIFT of it. A wrong prologue moves the logits by
# far more; a GLU switch that changed nothing would move them by 0.
STEPS_TOL = 2e-2
GLU_SHIFT = 2.0
N_STEPS = 16
# NTPU_FUSED_DECODE=interpret with GLU: the fused path's plain version on
# the CPU
INTERPRET_GLU = ("interpret_glu", "interpret", "1")


def _rel(rows, refs):
    """The largest difference of two lists of logits rows, relative to
    each reference row's max|logit|."""
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(rows, refs))


def _fused_steps_card_vs_plain(card, n, host_cache):
    """N_STEPS teacher-forced decode steps (seeded ids) from one prompt
    cache: the plain path's prefilled ``host_cache`` copied, so the steps'
    inputs agree and only the steps' own roundings part the two sides.
    Fused without GLU through the kernels against the plain path's
    unfused steps (the plain fused path computes the same values), fused
    with GLU against the plain path under ``NTPU_FUSED_DECODE=interpret``
    and ``NTPU_FUSE_GLU=1`` (the same single rounding), both within
    STEPS_TOL, the argmax proven equal at 3 steps or more. Then the GLU
    shift, GLU on against off, through the kernels against the plain
    path's. The plain side runs on the card's own tensors."""
    gen = torch.Generator().manual_seed(3)
    feed = torch.randint(3, V, (N_STEPS,), generator=gen).tolist()
    host_rows = {}
    for mode in (UNFUSED, INTERPRET_GLU):
        with fusion(mode), plain_on_card():
            host_rows[mode[0]] = _decode_rows(card, n, feed, host_cache)
    card_rows, res = {}, {}
    for mode, ref in ((FUSED, "unfused"), (FUSED_GLU, "interpret_glu")):
        cache = type(host_cache)(*(None if t is None else t.clone() for t in (
            host_cache.k, host_cache.v, host_cache.k_scale,
            host_cache.v_scale)))
        with fusion(mode):
            rows = card_rows[mode[0]] = run_path(
                f"card_vs_plain_steps_{mode[0]}", FUSED_DECODE[mode[0]],
                lambda: _decode_rows(card, n, feed, cache))
        worst, provable, _ = _compare_rows(
            rows, host_rows[ref], STEPS_TOL, f"card {mode[0]} steps vs plain")
        log(f"card {mode[0]} decode steps vs plain {ref}, one prompt cache: "
            f"logits max err {worst:.3g}·max|logit| (tol {STEPS_TOL}); "
            f"argmax provably comparable at {provable} of {N_STEPS} steps, "
            "equal at all of them")
        if provable < 3:
            raise AssertionError(f"{mode[0]} steps: too few steps with a "
                                 "margin wide enough to compare the argmax")
        res[f"card_vs_plain_steps_{mode[0]}_rel_err"] = worst
    shift_card = _rel(card_rows["fused_glu"], card_rows["fused"])
    shift_host = _rel(host_rows["interpret_glu"], host_rows["unfused"])
    log(f"GLU on against off, decode steps: kernels {shift_card:.3g}, plain "
        f"{shift_host:.3g}·max|logit| (held within {GLU_SHIFT}x)")
    if not shift_host / GLU_SHIFT <= shift_card <= shift_host * GLU_SHIFT:
        raise AssertionError(f"the kernels' GLU shift {shift_card} is not "
                             f"within {GLU_SHIFT}x of the plain path's "
                             f"{shift_host}")
    res.update(glu_shift_card_rel=shift_card, glu_shift_plain_rel=shift_host)
    return res


# asymmetric int2 and int5 (uint8 zero-points, group 32), what
# ``quant_config_from_args("int2" | "int5", alg="asym")`` gives; no preset
# holds them, and K1 has an entry point for each
QUANTS = {
    "int2_asym": QuantConfig(bits=2, group_size=32, sym=False, act_bits=8),
    "int5_asym": QuantConfig(bits=5, group_size=32, sym=False, act_bits=8),
    "int6_g128_a8": quant_config_from_args("int6", group_size=128),
}

# the formats with no full-width path, and the kernels a card run of each
# must launch: a 24-token prompt prefills through K5's tiles (M=24 > 16),
# its one-row lm_head and the decode steps through K1's branch for codes
# at rest, through K5's gemv for the stored layouts
_K5_BOTH = ("qmm_general+tc", "qmm_general+gemv")
PLAIN_FORMATS = {
    "fp4": _K5_BOTH, "fp8": _K5_BOTH, "fp8_e5m2": _K5_BOTH, "int1": _K5_BOTH,
    "int2": ("qmm_general+tc", "qmm2_npack"),
    "int2_asym": ("qmm_general+tc", "qmm2_npack_asym"),
    "int3": ("qmm_general+tc", "qmm4_npack"),
    "int5": ("qmm_general+tc", "qmm8_native"),
    "int5_asym": ("qmm_general+tc", "qmm8_native_asym"),
    "q8_0": ("qmm_general+tc", "qmm8_native"),
    "int8": ("qmm_general+tc", "qmm8_native"),
}


def _formats_card_vs_plain(cfg2, rel_tol=2e-2):
    """Each format of PLAIN_FORMATS: a copy at full width (``cfg2``: one
    layer since the script's time limit pressed, two before) runs
    ``Model.generate`` on the card (a path of its own, with launch counts;
    24-token prompt, 3 new tokens), then its logits, fed the card's ids,
    are held against the plain path on the card's own tensors
    (``plain_on_card``: on the host's CPU this plain path took most of
    phase 5's time, as it did 8c's). Every product here has
    bf16 activations (24 rows are too few for the int8 path), so no int8
    code moves; what differs is the order of f32 sums and the bf16
    roundings between layers, one bf16 step (2^-8 relative) at a time.
    The H100 showed 4e-3 to 9e-3·max|logit|; the tolerance is 2e-2, not
    the q4_j check's 5e-2. The worst relative difference is printed per
    format."""
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(3, V, (24,), generator=gen).tolist()
    res, total = {}, 0
    for i, (fmt, required) in enumerate(PLAIN_FORMATS.items()):
        quant = QUANTS.get(fmt, fmt)
        card = init_random(cfg2, seed=10 + i, quant=quant, device=DEV)
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{fmt}", required, lambda: model.generate(
            ids, max_new_tokens=3, do_sample=False,
            stop_at_eos=False)[0])[len(ids):]
        _check_ids(new, 3, f"card {fmt}")
        log(f"{fmt}: card vs plain on the card, fed the card's ids {new}")
        rows = _step_rows(card, cfg2, ids, new)
        with plain_on_card():
            plain = _step_rows(card, cfg2, ids, new)
        worst, provable, _ = _compare_rows(rows, plain, rel_tol)
        log(f"{fmt}: logits max err {worst:.3g}·max|logit| (tol {rel_tol}); "
            f"argmax provably comparable at {provable} of 4 steps, equal at "
            "all of them")
        res[fmt] = worst
        total += provable
        del card, model
        torch.cuda.empty_cache()
    if total < len(PLAIN_FORMATS):
        raise AssertionError(f"only {total} steps over {len(PLAIN_FORMATS)} "
                             "formats had a margin wide enough to compare "
                             "the argmax")
    return res


class _LogitsRecorder:
    """Stands in for the decoder inside a Scheduler: calls it, and keeps
    each logits row that becomes a token, keyed (request id, token index).
    A decode step's row of slot s is token len(output_ids) of the request
    there; a prefill chunk's row is token 0 when the chunk ends the
    prompt."""

    def __init__(self, model):
        self.model, self.sched, self.rows = model, None, {}

    @property
    def device(self):
        return self.model.device

    def __call__(self, tokens, start, cache, **kw):
        logits = self.model(tokens, start, cache, **kw)
        s = self.sched
        if tokens.shape[1] == 1:
            for slot, seq in s.running.items():
                self.rows[(seq.request_id, len(seq.output_ids))] = \
                    logits[slot, -1].float().cpu()
        else:
            seq = s._prefilling
            if seq.prefill_pos + (seq.chunk or len(seq.prompt_ids)) >= \
                    len(seq.prompt_ids):
                self.rows[(seq.request_id, 0)] = logits[0, -1].float().cpu()
        return logits


def _sched_card_vs_plain(card, cfg2, rel_tol, kv_dtype=torch.int8):
    """The copy through the Scheduler (paged KV, int8 unless
    ``kv_dtype`` says otherwise, batch 4, 6 requests) on the card, decode
    step eager so each step's logits can be read, and through the plain
    path on the card's own tensors (``plain_on_card``): per request,
    logits within the tolerance and
    greedy ids equal at every token whose plain top-2 margin exceeds twice
    the logit difference, up to the first token where the two sides' ids
    part (past it their inputs differ)."""
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(20, 64, (6,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    n_new = 3
    done, recs = [], []
    for ctx in (contextlib.nullcontext(), plain_on_card()):
        rec = _LogitsRecorder(card)
        sched = Scheduler(card, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=kv_dtype,
                          sampling=SamplingParams(greedy=True,
                                                  repeat_penalty=1.0))
        sched._graphs = None      # the decode step eagerly: logits readable
        rec.sched, sched.params = sched, rec
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=n_new)
        with ctx:
            done.append({q.request_id: q.output_ids
                         for q in sched.run_to_completion()})
        recs.append(rec.rows)
    worst, provable = 0.0, 0
    for i in range(len(prompts)):
        for t in range(n_new):
            if (i, t) not in recs[1]:
                break
            a, b = recs[0][(i, t)], recs[1][(i, t)]
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            worst = max(worst, err / scale)
            if not err <= rel_tol * scale:
                raise AssertionError(f"scheduler card vs plain logits, "
                                     f"request {i} token {t}: max err {err}")
            top2 = b.topk(2).values
            ca, ho = done[0][i][t], done[1][i][t]
            if (top2[0] - top2[1]).item() > 2 * err:
                provable += 1
                if ca != ho:
                    raise AssertionError(f"scheduler ids differ at request "
                                         f"{i} token {t} despite the margin")
            if ca != ho:
                break
    log(f"{cfg2.arch} scheduler card vs plain ({cfg2.n_layers} layer(s), "
        f"paged "
        f"{'int8' if kv_dtype == torch.int8 else 'bf16'}, batch 4, "
        f"window {cfg2.sliding_window}, prompts "
        f"{lens}): logits max err {worst:.3g}·max|logit| (tol {rel_tol}); "
        f"ids card {[done[0][i] for i in range(6)]}, plain "
        f"{[done[1][i] for i in range(6)]}; provably comparable at "
        f"{provable} tokens, equal at all of them")
    if provable < 3:
        raise AssertionError("too few scheduler steps with a margin wide "
                             "enough to compare the argmax")
    return worst


GREEDY_NP = SamplingParams(greedy=True, repeat_penalty=1.0)


def _sched_beams_card_vs_plain(card, cfg2, ids, rel_tol):
    """A beam group (3 beams, 8 new tokens, a 24-token prompt) beside a
    greedy request through the Scheduler, slots bf16 and then paged int8:
    through the kernels (the decode steps graphed, a path each), then
    through the plain path on the card's own tensors (its steps eager),
    forced to follow the kernels' beams. Every expansion's logits
    rows are held to the plain ones and the choices proven where the
    margins allow (:func:`_beams_held`); the hypotheses equal."""
    prompt = ids[:24]
    res, proven = {}, 0
    for mode, kv, attn in (("slots", torch.bfloat16, ("flash_prefill",
                                                       "flash_decode")),
                           ("paged", torch.int8, ("flash_prefill_i8",
                                                  "paged_decode_i8"))):
        calls, hyps = [], []
        for plain in (False, True):
            def run():
                sched = Scheduler(card, cfg2, max_batch=4, max_len=64,
                                  kv_mode=mode, page_size=16, kv_dtype=kv,
                                  sampling=GREEDY_NP)
                if plain:
                    sched._graphs = None
                sched.add_request("beam", prompt, max_new_tokens=8,
                                  num_beams=3)
                sched.add_request("greedy", ids[30:50], max_new_tokens=8)
                return {q.request_id: q for q in sched.run_to_completion()}
            calls.append([])
            forced = calls[0] if plain else None
            with _ranked(SCHED, calls[-1], forced):
                if plain:
                    with plain_on_card():
                        done = run()
                else:
                    done = run_path(f"card_vs_plain_sched_beams_{mode}",
                                    ("qmm4_npack", "qmm_general") + attn,
                                    run)
            _check_served(done["greedy"].output_ids, 8, "greedy beside "
                          "a beam group", cfg2)
            hyps.append(done["beam"].hypotheses)
        worst, n = _beams_held(*calls, 3, rel_tol,
                               f"scheduler beams {mode} card vs plain")
        if [h for h, _ in hyps[0]] != [h for h, _ in hyps[1]]:
            raise AssertionError(f"scheduler beams {mode}: card hypotheses "
                                 f"{hyps[0]} != forced plain {hyps[1]}")
        log(f"scheduler beam group card vs plain ({mode}, {kv}): the plain "
            f"run forced to the card's beams; logits within {worst:.3g}·"
            f"max|logit| (tol {rel_tol}) at all {len(calls[0])} expansions, "
            f"{n} proven by the margins; hypotheses {hyps[0]}")
        res[f"sched_beams_{mode}_rel_err"] = worst
        res[f"sched_beams_{mode}_proven"] = n
        proven += n
    if proven < 2:
        raise AssertionError(f"scheduler beams card vs plain: {proven} "
                             "expansions proven by the margins")
    return res


def _held_shift(worst):
    """``shift_cache_impl`` wrapped for the Scheduler: the slot row as it
    was copied to the CPU before the card shifts it, then the card's
    shifted row held to the plain shift of that copy (values and scales
    equal, bf16 keys within one bf16 step); ``worst`` collects the keys'
    largest difference."""
    orig = SCHED.shift_cache_impl

    def shift(rows, inv, cfg, n_keep, n_discard):
        before = type(rows)(*(None if t is None else t.cpu()
                              for t in (rows.k, rows.v, rows.k_scale,
                                        rows.v_scale)))
        orig(rows, inv, cfg, n_keep, n_discard)
        orig(before, None if inv is None else inv.cpu(), cfg, n_keep,
             n_discard)
        if not torch.equal(rows.v.cpu(), before.v):
            raise AssertionError("scheduler shift: values differ")
        k, rk = rows.k.cpu().float(), before.k.float()
        worst.append((k - rk).abs().max().item())
        if not bool(((k - rk).abs() <= 2 ** -7 * rk.abs() + 1e-6).all()):
            raise AssertionError(f"scheduler shift: keys part by "
                                 f"{worst[-1]}")
        return rows
    return shift


def _sched_stream_card_vs_plain(card, cfg2, ids, rel_tol,
                                kv_dtype=torch.bfloat16):
    """StreamingLLM slots through the Scheduler (bf16 KV, 64 positions, 4
    sinks, 30 dropped, prompts of 60 and 61 tokens, 6 new each: each slot
    shifts once) through the kernels, the decode steps graphed, and
    through the plain path on the card's own tensors (its steps eager),
    each step's logits rows read from the step's output
    (:class:`_SlotRows`): logits within rel_tol, ids equal where the plain
    margin proves them, up to the first parting; each card shift against
    the plain shift of the same row."""
    prompts = [ids[100:160], ids[160:221]]
    worst_k, recs, done = [], [], []
    f32 = kv_dtype == torch.float32
    attn = ("flash_prefill_f32", "flash_decode_f32") if f32 else \
        ("flash_prefill", "flash_decode")
    for plain in (False, True):
        sched = Scheduler(card, cfg2, max_batch=2, max_len=64,
                          streaming=True, n_keep=4, n_discard=30,
                          sampling=GREEDY_NP, kv_dtype=kv_dtype)
        if plain:
            sched._graphs = None
        rec = _SlotRows(sched, {0, 1})
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=6)
        orig = SCHED.shift_cache_impl
        if not plain:
            SCHED.shift_cache_impl = _held_shift(worst_k)
        try:
            run = lambda: {q.request_id: q.output_ids
                           for q in sched.run_to_completion()}
            if plain:
                with plain_on_card():
                    done.append(run())
            else:
                done.append(run_path(
                    "card_vs_plain_sched_stream" + ("_f32" if f32 else ""),
                    ("qmm4_npack", "qmm_general") + attn, run))
        finally:
            SCHED.shift_cache_impl = orig
        recs.append(rec.rows)
    if len(worst_k) < 2:
        raise AssertionError(f"scheduler streaming: {len(worst_k)} shifts "
                             "on the card")
    proven, worst = 0, 0.0
    for i in range(len(prompts)):
        for t in range(6):
            a, b = recs[0][(i, t)], recs[1][(i, t)]
            err = (a - b).abs().max().item()
            worst = max(worst, err / b.abs().max().item())
            if not err <= rel_tol * b.abs().max().item():
                raise AssertionError(f"scheduler streaming logits, request "
                                     f"{i} token {t}: max err {err}")
            top2 = b.topk(2).values
            sure = (top2[0] - top2[1]).item() > 2 * err
            if done[0][i][t] != done[1][i][t]:
                if sure:
                    raise AssertionError(f"scheduler streaming ids differ "
                                         f"at request {i} token {t} despite "
                                         "the margin")
                break
            proven += sure
    log(f"scheduler streaming card vs plain ({kv_dtype} cache, 64 "
        f"positions, 2 slots, one shift each): logits max err {worst:.3g}·max|logit| (tol "
        f"{rel_tol}); card shifts' keys within {max(worst_k):.3g} of the "
        f"plain shift; ids card {done[0]}, plain {done[1]}; proven at "
        f"{proven} tokens")
    if proven < 3:
        raise AssertionError("scheduler streaming: too few proven tokens")
    return {"sched_stream_card_vs_plain_rel_err": worst,
            "sched_stream_shift_k_err": max(worst_k)}


def _sched_block_card(card, cfg2, ids):
    """Decode blocks of 4 on the card (paged int8, batch 4, 6 requests of
    20-60 tokens, 12 new each, the default repetition penalty): ids equal
    the single steps' exactly; the single steps are held to the CPU by
    :func:`_sched_card_vs_plain`."""
    prompts = [ids[10 * n:10 * n + 20 + 8 * n] for n in range(6)]
    out = []
    for block in (1, 4):
        sched = Scheduler(card, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=torch.int8,
                          decode_block=block)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=12)
        out.append(run_path(f"card_sched_block{block}",
                            ("qmm4_npack", "paged_decode_i8"),
                            lambda: {q.request_id: q.output_ids
                                     for q in sched.run_to_completion()}))
        if block > 1 and not sched._blocks:
            raise AssertionError("no decode block ran")
    if out[0] != out[1]:
        raise AssertionError(f"decode blocks {out[1]} != single steps "
                             f"{out[0]}")
    log(f"scheduler decode blocks of 4 on the card = single steps: ids "
        f"equal over 6 requests, 12 new each")


def _sched_beyond_greedy_card_vs_plain(card, cfg2, ids, rel_tol):
    """Phase 5's checks of serving beyond greedy on its one-layer copy."""
    res = _sched_beams_card_vs_plain(card, cfg2, ids, rel_tol)
    res.update(_sched_stream_card_vs_plain(card, cfg2, ids, rel_tol))
    _sched_block_card(card, cfg2, ids)
    return res


# ---------------------------------------------------------------------------
# phase 6: the server at full width
# ---------------------------------------------------------------------------

# prompt tails in the 32/64/128 buckets prefill through K5
SERVE_PAGED_I8 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill_i8",
                  "paged_decode_i8")


def _serve(srv, prompts, n_new, cfg=CFG, timeout=300.0, queries=None):
    """Issue every prompt at once (or ``queries``, ids 0..n-1, as they
    are), wait for Empty() under a timeout that raises; return (finished
    sequences by id, issue time, wall seconds)."""
    queries = queries or [Query(i, p, n_new) for i, p in enumerate(prompts)]
    t0 = time.time()
    srv.issueQuery(queries)
    while not srv.Empty():
        if time.time() - t0 > timeout:
            raise TimeoutError(f"server did not answer {len(queries)} "
                               f"queries in {timeout} s")
        time.sleep(0.002)
    wall = time.time() - t0
    with srv._lock:
        done, srv.finished = {q.request_id: q for q in srv.finished}, []
    if sorted(done) != list(range(len(queries))):
        raise AssertionError(f"answered {sorted(done)} of "
                             f"{len(queries)} queries")
    for i, q in done.items():
        out = q.output_ids
        stopped = out and out[-1] in cfg.eos_token_ids and len(out) < n_new
        if not (len(out) == n_new or stopped) \
                or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"query {i}: bad ids {out}")
    return done, t0, wall


def _graph_vs_eager(params, mode=None):
    """The same 8 requests through two paged int8 Schedulers, one replaying
    the decode-step CUDA graph, one running the step eagerly: equal ids and
    equal pool bytes (the trash page aside). With ``mode`` (the fusion
    switches both run under), the graph's K1 launches are that mode's: all
    of the batch-8 step's 225 through the fused entry points."""
    gen = torch.Generator().manual_seed(7)
    lens = torch.randint(40, 400, (8,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    runs = []
    for graph in (True, False):
        sched = Scheduler(params, CFG, max_batch=8, max_len=1024,
                          kv_mode="paged", page_size=256,
                          kv_dtype=torch.int8)
        if not graph:
            sched._graphs = None  # the same decode step, run eagerly
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=10)
        runs.append(({q.request_id: q.output_ids
                      for q in sched.run_to_completion()}, sched.cache))
        if graph and mode is not None:
            for g in sched._graphs.values():
                check_step_launches(g.launches, mode, "server decode step")
    (ids_g, pool_g), (ids_e, pool_e) = runs
    if ids_g != ids_e:
        raise AssertionError(f"graphed server steps {ids_g} != eager {ids_e}")
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool_g, name), getattr(pool_e, name)
        if not torch.equal(a[:, :-1], b[:, :-1]):
            raise AssertionError(f"graphed server steps wrote another {name} "
                                 "pool than the eager steps")
    log(f"server decode step{'' if mode is None else ' ' + mode[0]} (CUDA "
        f"graph) = eager steps: ids and pool bytes equal over 8 requests "
        f"(prompts {lens}), 10 new tokens each")
    del runs, pool_g, pool_e
    torch.cuda.empty_cache()


def _server_timed(params, cfg, name, required, prompts):
    """The batch-8 ``ModelServer`` over a paged int8 pool (page 256,
    max_len 2048) answers ``prompts`` (32 new tokens each, issued at once)
    after a warm-up query that captures its decode graph, as the path
    ``name`` with launch counts: aggregate tok/s, the decode iteration's
    median ms at 8 running slots (host clock), TTFT from issue (median,
    max; it includes the wait for a slot)."""
    srv = ModelServer(params, cfg, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, memory_dtype="int8")
    try:
        sched = srv.scheduler
        step_ms = []
        decode_step = sched._decode_step

        def timed_decode_step():
            n = len(sched.running)
            t = time.perf_counter()
            decode_step()
            step_ms.append((n, (time.perf_counter() - t) * 1e3))

        sched._decode_step = timed_decode_step
        # warm-up query: the decode graph is captured once per server
        _serve(srv, [prompts[0][:600]], 4, cfg)
        step_ms.clear()
        done, t0, wall = run_path(name, required,
                                  lambda: _serve(srv, prompts, 32, cfg))
    finally:
        srv.stop()
    n_tok = sum(len(q.output_ids) for q in done.values())
    full = [ms for n, ms in step_ms if n == 8]
    ttft = [(q.first_token_time - t0) * 1e3 for q in done.values()]
    if not full:
        raise AssertionError("no decode iteration ran with 8 slots")
    res = dict(tok_s=n_tok / wall,
               decode_iter_ms_8slots=statistics.median(full),
               ttft_median_ms=statistics.median(ttft), ttft_max_ms=max(ttft),
               wall_s=wall)
    log(f"{name} (batch 8, page 256, {len(prompts)} queries, prompts "
        f"{[len(p) for p in prompts]}, 32 new each): {n_tok} tokens in "
        f"{wall:.2f} s = {res['tok_s']:.1f} tok/s aggregate; decode "
        f"iteration with 8 running slots median "
        f"{res['decode_iter_ms_8slots']:.3f} ms over {len(full)}; TTFT from "
        f"issue median {res['ttft_median_ms']:.1f} ms, max "
        f"{res['ttft_max_ms']:.1f} ms")
    for i in range(3):
        log(f"  query {i} ({len(prompts[i])} tokens): {done[i].output_ids}")
    del srv, sched
    torch.cuda.empty_cache()
    return res


def _server_short(params, cfg, runs):
    """Short server runs, each a path with launch counts: (name, server
    kwargs, kernels it must launch, prompts, new tokens)."""
    for name, kw, required, queries, n_new in runs:
        srv = ModelServer(params, cfg, max_batch=8, max_len=S_CACHE,
                          memory_dtype="auto", **kw)
        try:
            done, _, wall = run_path(name, required,
                                     lambda: _serve(srv, queries, n_new, cfg))
        finally:
            srv.stop()
        log(f"{name}: {len(queries)} queries, {n_new} new each, in "
            f"{wall:.2f} s; query 0: {done[0].output_ids}")
        del srv
        torch.cuda.empty_cache()


def _server_prompts():
    gen = torch.Generator().manual_seed(6)
    lens = torch.randint(32, 1501, (12,), generator=gen).tolist()
    return [torch.randint(3, V, (n,), generator=gen).tolist() for n in lens]


def phase_server(params):
    _graph_vs_eager(params)
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            run_path(f"server_{mode[0]}", FUSED_DECODE[mode[0]][:-1]
                     + ("paged_decode_i8",),
                     lambda: _graph_vs_eager(params, mode))
    prompts = _server_prompts()
    res = {f"server_{k}": v for k, v in _server_timed(
        params, CFG, "server_paged_int8", SERVE_PAGED_I8, prompts).items()}
    _server_short(params, CFG, (
        ("server_slots_bf16", dict(kv_mode="slots"),
         ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode"),
         [p[:n] for p, n in zip(prompts, (64, 300, 700, 1200))], 16),
        ("server_paged_bf16", dict(kv_mode="paged", page_size=256),
         ("qmm4_npack", "flash_prefill", "paged_decode"),
         [p[:n] for p, n in zip(prompts, (90, 200))], 8)))
    return res


# ---------------------------------------------------------------------------
# phase 6c: serving beyond greedy on the 7B
# ---------------------------------------------------------------------------

MIROSTAT = SamplingParams(mirostat=2)
MIX_KINDS = ["greedy"] * 6 + ["sampled"] * 2 + ["mirostat", "beam"] \
    + ["greedy"] * 2
STREAM_LEN, STREAM_NEW = 512, 600
# the server's logits rows against a batch-1 or beam_search computation of
# the same tokens on the card: other kernels (K4 against K6, K1 at another
# M), whose last-bit differences 32 layers of random weights amplify to
# 4-7% of max|logit| in one step, steady over 600 tokens and both shifts
SERVE_TOL = 1e-1
# the same rows through the same kernels at the same shapes, eager against
# graphed: equal to the bit
SAME_ROUTE_TOL = 0.0


def _mix_queries():
    """Phase 6c's 12 queries in issue order, 32 new tokens each: 6 greedy,
    2 sampled (top-k 40, top-p 0.95, temperature 0.8), 1 mirostat v2, a
    4-beam query on a 128-token prompt, 2 more greedy; the other prompts
    are phase 6's (32-1500 tokens)."""
    prompts = _server_prompts()
    g = torch.Generator().manual_seed(43)
    beam_prompt = torch.randint(3, V, (128,), generator=g).tolist()
    sp = {"sampled": SAMPLED, "mirostat": MIROSTAT}
    return [Query(i, beam_prompt if k == "beam" else prompts[i], 32,
                  sampling=sp.get(k), num_beams=4 if k == "beam" else None)
            for i, k in enumerate(MIX_KINDS)]


def _event_ms(fn, reps=10):
    """The median over ``reps`` calls of the device time between CUDA
    events around one call of ``fn`` (its launches from the host and any
    small host-to-card copy included), after a warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def _timed_steps(sched):
    """Wrap a Scheduler's decode step: each call's (running slots, a beam
    group running, host ms) is appended to the returned list."""
    steps, decode_step = [], sched._decode_step

    def timed():
        n = len(sched.running)
        beam = any(q.beam is not None for q in sched.running.values())
        t = time.perf_counter()
        decode_step()
        steps.append((n, beam, (time.perf_counter() - t) * 1e3))

    sched._decode_step = timed
    return steps


@contextlib.contextmanager
def _timed_copies(calls):
    """Time each ``copy_kv`` of the Scheduler (a beam prompt's share,
    then its reorders) on the host's clock around a synchronize; append
    (pages or rows, ms) to ``calls``."""
    orig = SCHED.copy_kv

    def timed(cache, src, dst, n=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig(cache, src, dst, n)
        torch.cuda.synchronize()
        calls.append((len(src), (time.perf_counter() - t) * 1e3))

    SCHED.copy_kv = timed
    try:
        yield
    finally:
        SCHED.copy_kv = orig


def _plain_copy(cache, src, dst, n=None):
    """``copy_kv``'s plain version: every source row or page staged to the
    host first, then each destination written from its copy, one at a
    time."""
    for c in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if c is None:
            continue
        if n is not None:
            c = c[:, :, :, :n]
        held = [c[:, i].to("cpu", copy=True) for i in src]
        for i, h in zip(dst, held):
            c[:, i].copy_(h)


def _beam_run(params, beam_q, copy, graphed, forced=None):
    """The beam query alone through a paged int8 Scheduler of the server's
    shape (batch 8, max_len 2048, page 256), its KV copies made by
    ``copy``, its decode steps graphed or eager, following ``forced``'s
    choices if given: (its ``_ranked`` records, its sequence)."""
    sched = Scheduler(params, CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, kv_dtype=torch.int8)
    if not graphed:
        sched._graphs = None
    orig, calls = SCHED.copy_kv, []
    SCHED.copy_kv = copy
    try:
        with _ranked(SCHED, calls, forced):
            sched.add_request(0, beam_q.token_ids, beam_q.max_new_tokens,
                              num_beams=4)
            done = sched.run_to_completion()
    finally:
        SCHED.copy_kv = orig
    del sched
    torch.cuda.empty_cache()
    return calls, done[0]


def _beam_without_reorders(params, beam_q):
    """The same-route hold against a broken run: the beam query through a
    graphed Scheduler whose reorders are skipped (its prompt's share still
    copied), then the eager plain-copy reference forced to its choices.
    Its rows must part from the reference's. Returns (the largest
    relative difference, reorders skipped)."""
    copies = []

    def share_only(cache, src, dst, n=None):
        if not copies:
            copy_kv(cache, src, dst, n)
        copies.append(len(src))

    calls, _ = _beam_run(params, beam_q, share_only, graphed=True)
    ref, _ = _beam_run(params, beam_q, _plain_copy, graphed=False,
                       forced=calls)
    apart = max(_rows_apart(calls, ref))
    if len(copies) < 2 or not apart > SAME_ROUTE_TOL:
        raise AssertionError(f"a beam run with its {len(copies) - 1} "
                             f"reorders skipped stays within {apart:.4g}·"
                             f"max|logit| of its reference: the hold "
                             "cannot see a wrong reorder")
    return apart, len(copies) - 1


def _mixed_traffic(params):
    """Item 1: phase 6's paged int8 ``ModelServer`` (batch 8, max_len 2048,
    page 256) answers the mix (a path with launch counts); the same 8
    greedy prompts alone through the same server. Greedy ids equal the
    greedy-only run's (a row's numbers do not depend on the other rows).
    The beam query is held, teacher-forced (:func:`_beams_held`), to two
    references that follow its beams: the same Scheduler route with eager
    steps and the plain host-staged copy (:func:`_beam_run`), whose rows
    must equal the server's (SAME_ROUTE_TOL) with 4 expansions or more
    proven by the margins; and ``beam_search`` (a contiguous cache, K4,
    its rows reordered by ``reorder_batch``) within SERVE_TOL, its
    hypotheses equal. :func:`_beam_without_reorders` shows that the first
    hold rejects a run whose reorders are skipped."""
    queries = _mix_queries()
    greedy = [q.id for q, k in zip(queries, MIX_KINDS) if k == "greedy"]
    srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, memory_dtype="int8")
    copies, calls = [], []
    try:
        sched = srv.scheduler
        # warm-up: the mix cut short captures the step graphs it needs
        _serve(srv, None, 8, queries=[
            Query(q.id, q.token_ids[:64], 8, sampling=q.sampling,
                  num_beams=q.num_beams) for q in queries])
        steps = _timed_steps(sched)
        with _timed_copies(copies), _ranked(SCHED, calls):
            done, _, wall = run_path(
                "server_mixed", SERVE_PAGED_I8,
                lambda: _serve(srv, None, 32, queries=queries))
        alone, _, _ = _serve(srv, None, 32, queries=[
            Query(j, queries[i].token_ids, 32) for j, i in enumerate(greedy)])
    finally:
        srv.stop()
    for j, i in enumerate(greedy):
        if done[i].output_ids != alone[j].output_ids:
            raise AssertionError(f"greedy query {i} in the mixed batch "
                                 f"{done[i].output_ids} != alone "
                                 f"{alone[j].output_ids}")
    beam_q = queries[MIX_KINDS.index("beam")]
    T = len(beam_q.token_ids)
    got = done[beam_q.id].hypotheses
    same, seq = _beam_run(params, beam_q, _plain_copy, graphed=False,
                          forced=calls)
    exact, proven = _beams_held(calls, same, 4, SAME_ROUTE_TOL,
                                "server beam query vs its eager plain-copy "
                                "reference")
    if seq.hypotheses != got:
        raise AssertionError(f"server beams {got} != the reference's "
                             f"{seq.hypotheses}")
    if proven < 4:
        raise AssertionError(f"server beam query: {proven} expansions "
                             "proven by the margins")
    ref_calls = []
    with _ranked(BEAM, ref_calls, forced=calls):
        ref = beam_search(params, CFG, beam_q.token_ids, beam_size=4,
                          max_new_tokens=32, kv_dtype=torch.int8)
    worst, _ = _beams_held(calls, ref_calls, 4, SERVE_TOL,
                           "server beam query vs beam_search")
    if [ids for ids, _ in got] != [h.ids[T:] for h in ref]:
        raise AssertionError(f"server beams {got} != beam_search's "
                             f"{[h.ids[T:] for h in ref]} on the same "
                             "choices")
    apart, skipped = _beam_without_reorders(params, beam_q)
    n_tok = sum(len(q.output_ids) for q in done.values())
    with_b = [ms for _, b, ms in steps if b]
    without = [ms for n, b, ms in steps if not b and n == 8]
    if not with_b or not without:
        raise AssertionError("the mix ran no decode iteration with a beam "
                             "group, or none with 8 plain rows")
    share, reorders = copies[0], copies[1:]
    res = dict(mixed_tok_s=n_tok / wall,
               mixed_iter_ms_beam=statistics.median(with_b),
               mixed_iter_ms_8plain=statistics.median(without),
               page_reorder_ms=statistics.median(ms for _, ms in reorders)
               if reorders else None,
               beam_prompt_share_ms=share[1], beam_same_route_rel_err=exact,
               beam_proven=proven, beam_search_rel_err=worst,
               beam_no_reorder_rel_err=apart)
    log(f"server mixed traffic (6+2 greedy, 2 sampled, 1 mirostat v2, 4 "
        f"beams on 128 tokens; 32 new each): {n_tok} tokens in {wall:.2f} s "
        f"= {res['mixed_tok_s']:.1f} tok/s; decode iteration median "
        f"{res['mixed_iter_ms_beam']:.3f} ms with the beam group running "
        f"({len(with_b)}), {res['mixed_iter_ms_8plain']:.3f} ms at 8 plain "
        f"rows ({len(without)}) (host clock); the prompt's pages shared in "
        f"{share[1]:.3f} ms ({share[0]} pages), {len(reorders)} page "
        f"reorders, median {res['page_reorder_ms']} ms, pages "
        f"{sorted({n for n, _ in reorders})} (host clock around a "
        f"synchronize); greedy ids equal the greedy-only run's at all 8 "
        f"queries; the beam query teacher-forced: its logits rows within "
        f"{exact:.3g}·max|logit| of the eager plain-copy Scheduler's (tol "
        f"{SAME_ROUTE_TOL}) at all {len(calls)} expansions, {proven} "
        f"proven by the margins, and within {worst:.3g} of beam_search's "
        f"(tol {SERVE_TOL}), hypotheses equal to both; with its {skipped} "
        f"reorders skipped a run parts from its reference by {apart:.3g}·"
        f"max|logit|; best {got[0][0]}")
    for i in (6, 7, 8):
        log(f"  query {i} ({MIX_KINDS[i]}): {done[i].output_ids}")
    return res, queries


def _mix_seeds(params, queries):
    """Item 2: the mix through the Scheduler itself (no thread), seed 5
    twice and seed 6: one seed gives the same ids, the other seed other
    sampled ids, and the greedy and beam ids do not move."""
    def run(seed):
        sched = Scheduler(params, CFG, max_batch=8, max_len=S_CACHE,
                          kv_mode="paged", page_size=256,
                          kv_dtype=torch.int8, seed=seed)
        for q in queries:
            sched.add_request(q.id, q.token_ids, q.max_new_tokens,
                              sampling=q.sampling,
                              num_beams=q.num_beams or 1)
        out = {q.request_id: q.output_ids for q in sched.run_to_completion()}
        del sched
        torch.cuda.empty_cache()
        return out

    a = run_path("scheduler_mixed_seed5", SERVE_PAGED_I8, lambda: run(5))
    b, c = run(5), run(6)
    drawn = [i for i, k in enumerate(MIX_KINDS) if k in ("sampled",
                                                         "mirostat")]
    fixed = [i for i in range(len(MIX_KINDS)) if i not in drawn]
    if a != b:
        raise AssertionError("the mix with seed 5 twice gave other ids")
    if all(a[i] == c[i] for i in drawn) or any(a[i] != c[i] for i in fixed):
        raise AssertionError(f"seed 6 against 5: drawn ids {[c[i] for i in drawn]}"
                             f" / {[a[i] for i in drawn]}")
    log(f"scheduler mix, seed 5 twice: equal ids; seed 6: other ids at "
        f"{sum(a[i] != c[i] for i in drawn)} of {len(drawn)} sampled "
        "queries, the greedy and beam ids unchanged")


class _RowStep:
    """A batch-1 decode step returning its f32 logits row, captured in a
    CUDA graph (``runtime.generate._Graph``), for teacher-forced runs at
    the 7B's width: ``row(token, pos)`` sets the static token and position
    and replays."""

    def __init__(self, model, cache, token, pos):
        self.token = torch.full((1, 1), token, dtype=torch.long, device=DEV)
        self.pos = torch.full((1,), pos, dtype=torch.long, device=DEV)
        self.g = _Graph(lambda: model(self.token, self.pos, cache)[:, -1])

    def row(self, token, pos):
        self.token.fill_(token)
        self.pos.fill_(pos)
        return self.g.replay()[0].float().cpu()


def _stream_ref_rows(params, prompt, ids, kv, until):
    """Teacher-forced batch-1 logits rows of a stream (``stream_generate``'s
    computation) fed ``ids`` after ``prompt``: the prefill's last row, then
    one step per id, the row shifted before the write that would overflow
    it; ``until`` rows."""
    cache = init_cache(CFG, 1, STREAM_LEN, kv, device=DEV)
    n_discard = (STREAM_LEN - 4) // 2
    with torch.inference_mode():
        rows = [prefill_step(params, torch.tensor([prompt], device=DEV),
                             torch.zeros(1, dtype=torch.long, device=DEV),
                             cache)[0, -1].float().cpu()]
        pos, step = len(prompt), None
        for tok in ids[:until - 1]:
            if pos >= STREAM_LEN:
                ST.shift_cache_impl(cache, params.rope_inv_freqs, CFG, 4,
                                    n_discard)
                pos -= n_discard
            if step is None:
                step = _RowStep(params, cache, tok, pos)
            rows.append(step.row(tok, pos))
            pos += 1
    return rows


class _SlotRows:
    """Records, on a Scheduler, the f32 logits row each token of the
    requests ``rids`` was drawn from, keyed (request id, token index): the
    prefill's last row, then its row of each decode step (the step's
    logits output, graphed or eager)."""

    def __init__(self, sched, rids):
        self.rows = {}
        one, step = sched._sample_one, sched._decode_sample_step

        def sample_one(row, seq):
            if seq.request_id in rids:
                self.rows[(seq.request_id, 0)] = row.float().cpu()
            return one(row, seq)

        def decode_sample_step():
            at = {s: (q.request_id, len(q.output_ids))
                  for s, q in sched.running.items() if q.request_id in rids}
            ids, logits = step()
            for slot, key in at.items():
                self.rows[key] = logits[slot].float().cpu()
            return ids, logits

        sched._sample_one = sample_one
        sched._decode_sample_step = decode_sample_step


def _stream_eager_equal(params, prompt, kv, rows, n_new):
    """The server's streaming slot against the same Scheduler route run
    eagerly: ``prompt`` alone through a streaming slots Scheduler of the
    server's shape, decode steps eager, ``n_new`` tokens (past the first
    shift); its logits rows must equal the server's first ``rows`` to the
    bit, so the graphed steps read the shifted row. Returns n_new."""
    sched = Scheduler(params, CFG, max_batch=8, max_len=STREAM_LEN,
                      kv_dtype=kv, streaming=True, n_keep=4,
                      sampling=GREEDY_NP)
    sched._graphs = None
    rec = _SlotRows(sched, {0})
    sched.add_request(0, prompt, max_new_tokens=n_new)
    sched.run_to_completion()
    for t in range(n_new):
        if not torch.equal(rec.rows[(0, t)], rows[t]):
            raise AssertionError(f"streaming slot, token {t}: the graphed "
                                 f"server's logits differ from the eager "
                                 f"Scheduler's by "
                                 f"{(rec.rows[(0, t)] - rows[t]).abs().max()}")
    del sched
    torch.cuda.empty_cache()
    return n_new


def _streaming_slots(params):
    """Item 3: ``ModelServer(shift_roped_k=True, ctx_size=512, n_keep=4,
    kv_mode="slots")``, bf16 and then int8 KV, greedy without penalty, 8
    queries of 256 tokens with 600 new each (every slot shifts twice); a
    path each. Query 0's logits rows, all of them, through both shifts of
    its slot and the graphed steps after them, within SERVE_TOL of a
    batch-1 stream fed the server's own ids (``stream_generate``'s
    computation, teacher-forced), and to the bit equal to an eager
    Scheduler's through the first shift (:func:`_stream_eager_equal`); its
    ids against ``stream_generate``'s,
    equal where the margins prove them, up to the first parting. The
    shifts counted, and one slot's shift timed on the card at the 7B's
    width."""
    g = torch.Generator().manual_seed(47)
    prompts = [torch.randint(3, V, (256,), generator=g).tolist()
               for _ in range(8)]
    res = {}
    for kv, kvdt, md, attn in (
            ("bf16", torch.bfloat16, "auto", ("flash_prefill",
                                              "flash_decode")),
            ("int8", torch.int8, "int8", ("flash_prefill_i8",
                                          "flash_decode_i8"))):
        srv = ModelServer(params, CFG, max_batch=8, ctx_size=STREAM_LEN,
                          shift_roped_k=True, n_keep=4, kv_mode="slots",
                          memory_dtype=md, sampling=GREEDY_NP)
        shifts, orig = [], SCHED.shift_cache_impl

        def counted(*a):
            _, ms = _host_ms(lambda: orig(*a))
            shifts.append(ms)

        rec = _SlotRows(srv.scheduler, {0})
        SCHED.shift_cache_impl = counted
        try:
            done, _, wall = run_path(
                f"server_streaming_{kv}", ("qmm4_npack", "qmm_a8") + attn,
                lambda: _serve(srv, prompts, STREAM_NEW, timeout=600.0))
        finally:
            SCHED.shift_cache_impl = orig
            srv.stop()
        if len(shifts) < 2 * len(prompts):
            raise AssertionError(f"streaming {kv}: {len(shifts)} shifts")
        want = ST.stream_generate(params, CFG, prompts[0], STREAM_NEW,
                                  STREAM_LEN, n_keep=4,
                                  kv_dtype=kvdt)[len(prompts[0]):]
        got = done[0].output_ids      # shorter if it drew the stop id
        until = next((t + 1 for t in range(len(got)) if got[t] != want[t]),
                     len(got))
        refs = _stream_ref_rows(params, prompts[0], got, kvdt, len(got))
        rows = [rec.rows[(0, t)] for t in range(len(got))]
        apart = [(a - b).abs().max().item() / b.abs().max().item()
                 for a, b in zip(rows, refs)]
        log(f"streaming {kv}: query 0's rows against the batch-1 stream, "
            f"largest relative difference per 50 tokens: "
            f"{[round(max(apart[i:i + 50]), 4) for i in range(0, len(apart), 50)]}")
        if not max(apart) <= SERVE_TOL:
            t = max(range(len(apart)), key=apart.__getitem__)
            raise AssertionError(f"streaming {kv}: token {t}'s logits part "
                                 f"from the batch-1 stream's by "
                                 f"{apart[t]:.4g}·max|logit|")
        # the first row computed after the slot's first shift
        first = STREAM_LEN - len(prompts[0]) + 1
        if len(got) <= first:
            raise AssertionError(f"streaming {kv}: query 0 stopped at "
                                 f"{len(got)} ids, before its first shift")
        proven = _proven_equal(got, want, refs[:until], rows[:until], None,
                               f"streaming {kv} slot vs stream_generate")
        n_eager = _stream_eager_equal(params, prompts[0], kvdt, rows,
                                      first + 16)
        cache = init_cache(CFG, 8, STREAM_LEN, kvdt, device=DEV)
        dev_ms = _event_ms(lambda: ST.shift_cache_impl(
            cache.rows(3, 1), params.rope_inv_freqs, CFG, 4,
            (STREAM_LEN - 4) // 2))
        del cache
        n_tok = sum(len(q.output_ids) for q in done.values())
        log(f"server streaming {kv} (8 queries of 256 tokens, {STREAM_NEW} "
            f"new each, 512 positions): {n_tok / wall:.1f} tok/s; "
            f"{len(shifts)} shifts, host ms median "
            f"{statistics.median(shifts):.3f}; one slot's shift "
            f"{dev_ms:.4f} ms on the card (events around the call); query "
            f"0's logits rows within {max(apart):.3g}·max|logit| of the "
            f"batch-1 stream fed its ids over all {len(got)} tokens (tol "
            f"{SERVE_TOL}; {max(apart[first:]):.3g} after its first shift), "
            f"and equal to the bit to an eager Scheduler's over its first "
            f"{n_eager} (through the first shift); "
            f"it equals stream_generate over its first {until} ids (to the "
            f"end or the first parting), {proven} proven by the margins")
        if proven < 4:
            raise AssertionError(f"streaming {kv}: too few proven steps")
        res.update({f"stream_{kv}_server_tok_s": n_tok / wall,
                    f"stream_{kv}_server_shifts": len(shifts),
                    f"stream_{kv}_slot_shift_ms": dev_ms,
                    f"stream_{kv}_proven": proven,
                    f"stream_{kv}_rel_err": max(apart)})
        del srv
        torch.cuda.empty_cache()
    return res


def _decode_blocks(params):
    """Item 4: 8 greedy queries (phase 6's first 8 prompts, 64 new each)
    through the paged int8 server with ``decode_block`` 1 and 8, two
    warm-up queries first (they capture the single step's graph and the
    block's); equal ids, tok/s of both."""
    prompts = _server_prompts()[:8]
    out, res = [], {}
    for k in (1, 8):
        srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                          kv_mode="paged", page_size=256, memory_dtype="int8",
                          decode_block=k)
        try:
            _serve(srv, [prompts[0][:300], prompts[1][:300]], 16)
            done, _, wall = run_path(
                f"server_decode_block{k}", ("qmm4_npack", "qmm_a8",
                                            "flash_prefill_i8",
                                            "paged_decode_i8"),
                lambda: _serve(srv, prompts, 64))
            if k > 1 and not srv.scheduler._blocks:
                raise AssertionError("no decode block ran")
        finally:
            srv.stop()
        out.append({i: q.output_ids for i, q in done.items()})
        res[f"block{k}_tok_s"] = sum(map(len, out[-1].values())) / wall
        del srv
        torch.cuda.empty_cache()
    if out[0] != out[1]:
        raise AssertionError("decode blocks of 8 gave other ids than "
                             "single steps")
    log(f"server decode blocks (8 greedy queries, 64 new each): "
        f"decode_block 8 {res['block8_tok_s']:.1f} tok/s against "
        f"{res['block1_tok_s']:.1f} at 1; ids equal")
    return res


def _torch_op_times(params):
    """The torch ops of this slice timed alone at the 7B's width (events
    around one call, its host launches included): the page reorder (3
    beam rows' pages, int8 pool of page 256, 1 and 6 pages each), the slot
    reorder (3 of 4 rows, bf16, over 160 and 2048 positions), against
    the bytes each reads and writes."""
    res = {}
    pool = init_paged_cache(CFG, 8, S_CACHE, None, 256, torch.int8, DEV)
    for per in (1, 6):
        src = list(range(per * 3))
        dst = list(range(32, 32 + per * 3))
        ms = _event_ms(lambda: copy_kv(pool, src, dst))
        nbytes = 2 * len(src) * sum(t[:, 0].numel() * t.element_size()
                                    for t in (pool.k, pool.v, pool.k_scale,
                                              pool.v_scale))
        log(f"page reorder, 3 rows x {per} page(s) of 256, int8: {ms:.4f} "
            f"ms for {nbytes / 1e6:.1f} MB read and written (bound "
            f"{nbytes / HBM_BPS * 1e3:.4f} ms)")
        res[f"page_reorder_ms_{per}p"] = ms
    del pool
    cache = init_cache(CFG, 8, S_CACHE, device=DEV)
    for n in (160, S_CACHE):
        ms = _event_ms(lambda: copy_kv(cache, [0, 0, 2], [1, 2, 3], n))
        nbytes = 2 * 2 * 3 * L * H * n * DH * 2
        log(f"slot reorder, 3 of 4 rows, bf16, {n} positions: {ms:.4f} ms "
            f"for {nbytes / 1e6:.1f} MB read and written (bound "
            f"{nbytes / HBM_BPS * 1e3:.4f} ms)")
        res[f"slot_reorder_ms_{n}"] = ms
    del cache
    torch.cuda.empty_cache()
    return res


def phase_serving_beyond_greedy(params):
    """Phase 6c on phase 6's 7B: mixed traffic through the paged int8
    server, the mix's seeds through the Scheduler, StreamingLLM slots (bf16
    and int8), decode blocks, and the slice's torch ops timed alone."""
    res, queries = _mixed_traffic(params)
    _mix_seeds(params, queries)
    res.update(_streaming_slots(params))
    res.update(_decode_blocks(params))
    res.update(_torch_op_times(params))
    return {f"6c_{k}": v for k, v in res.items()}


# ---------------------------------------------------------------------------
# phases 4d, 4e, 5c and 6b: Bloom-7B1, ChatGLM-6B and MPT-7B
# ---------------------------------------------------------------------------

# bigscience/bloom-7b1's config.json: 30 layers, hidden 4096, 32 heads
# (head dim 128), FFN 4 x 4096, vocab 250880 with tied embeddings,
# layer_norm_epsilon 1e-5, bos 1, eos 2; the family's ALiBi, LayerNorms with
# biases, embedding LayerNorm, projection biases and tanh GELU come from
# neural_tpu_torch/models/bloom.py
BLOOM_CFG = bloom.config_from_hf(types.SimpleNamespace(
    vocab_size=250880, hidden_size=4096, n_layer=BLOOM_L, n_head=H,
    layer_norm_epsilon=1e-5, bos_token_id=1, eos_token_id=2))
# THUDM/chatglm-6b's config.json: 28 layers, hidden 4096, 32 heads,
# inner_hidden_size 16384, vocab 130528 with an untied lm_head,
# layernorm_epsilon 1e-5, max_sequence_length 2048, bos 130004, eos 130005,
# position_encoding_2d; the residual alpha sqrt(2 * 28) = sqrt(56), the 2-D
# GLM RoPE and the prefix mask come from neural_tpu_torch/models/chatglm.py
CHATGLM_CFG = chatglm.config_from_hf(types.SimpleNamespace(
    position_encoding_2d=True, vocab_size=130528, hidden_size=4096,
    num_layers=CHATGLM_L, num_attention_heads=H, inner_hidden_size=16384,
    layernorm_epsilon=1e-5, max_sequence_length=2048, bos_token_id=130004,
    eos_token_id=130005))
# mosaicml/mpt-7b's config.json: 32 layers, d_model 4096, 32 heads,
# expansion_ratio 4, vocab 50432 tied, max_seq_len 2048, ALiBi; no biases,
# LayerNorms without bias, exact GELU (neural_tpu_torch/models/mpt.py)
MPT_CFG = mpt.config_from_hf(types.SimpleNamespace(
    d_model=4096, n_heads=H, n_layers=32, expansion_ratio=4,
    vocab_size=50432, max_seq_len=2048, attn_config={"alibi": True}))
BLOOM_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill+alibi",
             "flash_decode+alibi")
BLOOM_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8+alibi",
                  "flash_decode_i8+alibi")
CHATGLM_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill+prefix",
               "flash_decode")
CHATGLM_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8+prefix",
                    "flash_decode_i8")
# prompt tails in the 32/64/128 buckets prefill through K5
BLOOM_SERVE_I8 = ("qmm4_npack", "qmm_a8", "qmm_general",
                  "flash_prefill_i8+alibi", "paged_decode_i8+alibi")


def _init_full(cfg, what):
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = init_random(cfg, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"init_random {what} q4_j on the card: {time.time() - t:.1f} s, "
        f"{nbytes / 1e9:.3f} GB of weights and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    return params


def _generate_paths(params, cfg, what, paths):
    """``Model.generate`` (512-token prompt, 16 new tokens, greedy) once
    per (KV dtype, kernels it must launch), each a path."""
    model = Model().init_params(params, cfg)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(3, cfg.vocab_size, (512,), generator=gen).tolist()
    for kv, required in paths:
        out = run_path(f"{what}_generate_{kv}", required,
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False,
                                              kv_dtype=kv)[0])
        _check_ids(out[512:], 16, f"{what} generate {kv}", cfg.vocab_size)
        log(f"{what} Model.generate greedy, {kv} KV, 512-token prompt: new "
            f"ids {out[512:]}")


def phase_bloom():
    """Bloom-7B1 at full depth, q4_j, random weights from seed 0 drawn and
    quantized on the card: ``Model.generate`` with bf16 and int8 KV, decode
    ms/token at fills 128 and 1975 (bf16 KV), TTFT at 1975 tokens, peak
    memory; each a path with its launch counts. Returns (numbers,
    params) for phase 6b."""
    params = _init_full(BLOOM_CFG, "Bloom-7B1")
    _generate_paths(params, BLOOM_CFG, "bloom",
                    (("bf16", BLOOM_GEN), ("int8", BLOOM_GEN_INT8)))
    res = {}
    for fill in (128, T_PREFILL):
        ms = run_path(f"bloom_decode_fill{fill}",
                      ("qmm4_npack", "flash_decode+alibi"),
                      lambda: decode_ms(params, fill, cfg=BLOOM_CFG))
        log(f"bloom decode (slope n=4..36, batch 1, bf16 KV): fill {fill} "
            f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"bloom_decode_ms_fill{fill}"] = ms
    ms = run_path("bloom_prefill_1975", ("qmm_a8", "flash_prefill+alibi"),
                  lambda: ttft_ms(params, cfg=BLOOM_CFG))
    log(f"bloom TTFT 1975-token prefill (last-row logits, bf16 KV): "
        f"{ms:.2f} ms")
    res["bloom_ttft_1975_ms"] = ms
    res["bloom_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"bloom peak device memory {res['bloom_peak_gib']:.2f} GiB")
    return res, params


def phase_bloom_server(params):
    """Bloom-7B1 behind the batch-8 paged int8 ``ModelServer``, phase 6's
    12 queries; then a short paged bf16 run (K6's bf16 ALiBi branch)."""
    prompts = _server_prompts()
    res = {f"bloom_server_{k}": v for k, v in _server_timed(
        params, BLOOM_CFG, "bloom_server_paged_int8", BLOOM_SERVE_I8,
        prompts).items()}
    _server_short(params, BLOOM_CFG, (
        ("bloom_server_paged_bf16", dict(kv_mode="paged", page_size=256),
         ("qmm4_npack", "flash_prefill+alibi", "paged_decode+alibi"),
         [p[:n] for p, n in zip(prompts, (90, 200))], 8),))
    return res


def phase_chatglm():
    """ChatGLM-6B at full depth, q4_j (the lm_head too), random weights from
    seed 0: ``Model.generate`` with bf16 and int8 KV, decode ms/token at
    fill 128, TTFT at 1975 tokens (the whole prompt is the prefix), peak
    memory; each a path with its launch counts."""
    params = _init_full(CHATGLM_CFG, "ChatGLM-6B")
    _generate_paths(params, CHATGLM_CFG, "chatglm",
                    (("bf16", CHATGLM_GEN), ("int8", CHATGLM_GEN_INT8)))
    ms = run_path("chatglm_decode_fill128", ("qmm4_npack", "flash_decode"),
                  lambda: decode_ms(params, 128, cfg=CHATGLM_CFG))
    log(f"chatglm decode (slope n=4..36, batch 1, bf16 KV): fill 128 "
        f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
    ttft = run_path("chatglm_prefill_1975", ("qmm_a8", "flash_prefill+prefix"),
                    lambda: ttft_ms(params, cfg=CHATGLM_CFG))
    log(f"chatglm TTFT 1975-token prefill, all of it the prefix (last-row "
        f"logits, bf16 KV): {ttft:.2f} ms")
    res = dict(chatglm_decode_ms_fill128=ms, chatglm_ttft_1975_ms=ttft,
               chatglm_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"chatglm peak device memory {res['chatglm_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


ZOO_COPIES = (
    ("bloom", BLOOM_CFG, ("qmm_general", "qmm4_npack", "flash_prefill+alibi",
                          "flash_decode+alibi")),
    ("mpt", MPT_CFG, ("qmm_general", "qmm4_npack", "flash_prefill+alibi",
                      "flash_decode+alibi")),
    ("chatglm", CHATGLM_CFG, ("qmm_general", "qmm4_npack",
                              "flash_prefill+prefix", "flash_decode")))


def phase_zoo_card_vs_plain(rel_tol=2e-2):
    """One-layer full-width copies of Bloom-7B1, MPT-7B and ChatGLM-6B:
    ``Model.generate`` on the card (a path each: 100-token prompt, 4 new
    tokens), then its logits, fed the card's ids, against the plain path
    on the card's own tensors, argmax equal wherever the margin proves
    it. Every product
    here has bf16 activations (100 rows take K5, not the int8 path), as in
    phase 5's formats, so the tolerance is theirs, 2e-2·max|logit|; then,
    on the Bloom copy, phase 5's paged int8 Scheduler check."""
    gen = torch.Generator().manual_seed(12)
    res = {}
    for i, (what, cfg, required) in enumerate(ZOO_COPIES):
        cfg2 = dataclasses.replace(cfg, n_layers=COPY_LAYERS)
        card = init_random(cfg2, seed=20 + i, quant="q4_j", device=DEV)
        ids = torch.randint(3, V, (100,), generator=gen).tolist()
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{what}", required, lambda: model.generate(
            ids, max_new_tokens=4, do_sample=False,
            stop_at_eos=False)[0])[len(ids):]
        _check_ids(new, 4, f"card {what}", cfg2.vocab_size)
        worst, provable, _ = _steps_card_vs_plain(card, cfg2, ids, new[:3],
                                                  rel_tol)
        log(f"{what} card vs plain ({cfg2.n_layers} layer(s), full width, "
            f"100-token prompt, "
            f"fed the card's ids {new}): logits max err {worst:.3g}·"
            f"max|logit| (tol {rel_tol}); argmax provably comparable at "
            f"{provable} of 4 steps, equal at all of them")
        if provable < 2:
            raise AssertionError(f"too few {what} steps with a margin wide "
                                 "enough to compare the argmax")
        res[f"{what}_card_vs_plain_rel_err"] = worst
        if what == "bloom":
            res["bloom_sched_card_vs_plain_rel_err"] = _sched_card_vs_plain(
                card, cfg2, rel_tol)
        del card, model
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 4f, 4g, 4h and 5d: GPTQ/AWQ, the mixed-bit and a8 layouts, head
# dim 64, RoPE scaling and more than 8 query heads per KV head
# ---------------------------------------------------------------------------

# mistralai/Mistral-7B-v0.1's config.json: 32 layers, hidden 4096, 32 heads
# over 8 KV heads of 128, FFN 14336, vocab 32000 untied, rope_theta 10000,
# rms_norm_eps 1e-5, max_position_embeddings 32768, bos 1, eos 2 (its
# sliding_window 4096 is not read, as the JAX package does not read it);
# the checkpoint takes the form of TheBloke/Mistral-7B-v0.1-GPTQ's
# quantize_config.json: bits 4, group_size 128, desc_act true
MISTRAL_HF = dict(
    model_type="mistral", vocab_size=V, hidden_size=D, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=H, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)
MISTRAL_CFG = llama.config_from_hf(types.SimpleNamespace(**MISTRAL_HF))
GPTQ_QUANTIZE_CONFIG = {"bits": 4, "group_size": 128, "desc_act": True,
                        "sym": False}
# GPTQ's same-Hessian rule: q/k/v share one act-order g_idx, gate/up
# another; o_proj and down_proj have their own
GPTQ_PROJ = (("self_attn.q_proj", "qkv"), ("self_attn.k_proj", "qkv"),
             ("self_attn.v_proj", "qkv"), ("self_attn.o_proj", "o"),
             ("mlp.gate_proj", "gu"), ("mlp.up_proj", "gu"),
             ("mlp.down_proj", "down"))


def _gptq_shape(name, cfg):
    Dq, Dkv, I = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, \
        cfg.intermediate_size
    return {"self_attn.q_proj": (cfg.hidden_size, Dq),
            "self_attn.k_proj": (cfg.hidden_size, Dkv),
            "self_attn.v_proj": (cfg.hidden_size, Dkv),
            "self_attn.o_proj": (Dq, cfg.hidden_size),
            "mlp.gate_proj": (cfg.hidden_size, I),
            "mlp.up_proj": (cfg.hidden_size, I),
            "mlp.down_proj": (I, cfg.hidden_size)}[name]


def gptq_state_dict(cfg, seed, fmt="gptq"):
    """A GPTQ (act-order) or AWQ 4-bit group-128 state dict of a Llama-family
    ``cfg``, synthesized on the host from ``seed`` as safetensors holds one:
    qweight int32 words (random words are valid packed codes, mean 7.5),
    zero-points 7 or 8 packed (mean 7.5, so that the weights have no mean;
    GPTQ stores z - 1), f16 scales in [0.003, 0.005] (weights
    of about 0.02 rms, as ``init_random`` draws them, so that the logits
    stay finite and their argmax is no tie), g_idx int32 with equal groups
    in a random order, f16 norm weights of 1, embedding and lm_head
    N(0, 0.02) in f16."""
    rng = np.random.default_rng(seed)
    g = GPTQ_QUANTIZE_CONFIG["group_size"]

    def words(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint32).view(np.int32)

    def zero_words(G, N):
        z = rng.integers(7, 9, (G, N // 8, 8), dtype=np.uint32)
        if fmt == "gptq":
            z -= 1
        return np.bitwise_or.reduce(z << (4 * np.arange(8, dtype=np.uint32)),
                                    axis=2).view(np.int32)

    sd = {}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        gidx = {}
        for name, share in GPTQ_PROJ:
            K, N = _gptq_shape(name, cfg)
            base = p + name
            sd[base + ".qweight"] = words((K // 8, N) if fmt == "gptq"
                                          else (K, N // 8))
            sd[base + ".qzeros"] = zero_words(K // g, N)
            sd[base + ".scales"] = rng.uniform(
                0.003, 0.005, (K // g, N)).astype(np.float16)
            if fmt == "gptq":
                if share not in gidx:
                    gi = np.empty(K, np.int32)
                    gi[rng.permutation(K)] = np.arange(K, dtype=np.int32) // g
                    gidx[share] = gi
                sd[base + ".g_idx"] = gidx[share]
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"] = np.ones(cfg.hidden_size, np.float16)
    normal = lambda shape: (rng.standard_normal(shape, np.float32)
                            * 0.02).astype(np.float16)
    sd["model.embed_tokens.weight"] = normal((cfg.vocab_size,
                                              cfg.hidden_size))
    sd["model.norm.weight"] = np.ones(cfg.hidden_size, np.float16)
    sd["lm_head.weight"] = normal((cfg.vocab_size, cfg.hidden_size))
    return sd


def write_safetensors(path, tensors):
    """numpy arrays → one ``.safetensors`` file: the 8-byte header length,
    the JSON header, the raw little-endian bytes in C order."""
    names = {np.dtype(np.int32): "I32", np.dtype(np.float16): "F16",
             np.dtype(np.float32): "F32"}
    header, off = {}, 0
    for k, a in tensors.items():
        header[k] = {"dtype": names[a.dtype], "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(h)) + h)
        for a in tensors.values():
            fh.write(np.ascontiguousarray(a).tobytes())


MISTRAL_GEN = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
               "flash_prefill", "flash_decode")
MISTRAL_GEN_INT8 = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
                    "flash_prefill_i8", "flash_decode_i8")


def phase_mistral_gptq():
    """Mistral-7B GPTQ at full depth: its state dict synthesized on the host
    (``gptq_state_dict``), converted on the card by
    ``params_from_gptq_state_dict`` (what ``Model.init(dir,
    use_gptq=True)`` calls); ``Model.generate`` with bf16 and int8 KV,
    decode ms/token at fills 128 and 1975, TTFT at 1975 tokens with bf16
    and int8 KV, peak memory from just after the conversion, each a path
    with its launch counts; a decode step must gather x three times a
    layer (wqkv, wo, w_gateup; w_down's perm is folded), one gather per
    four K1 launches; and one ``index_select`` timed alone at [1, 4096] and
    [1975, 4096]."""
    t = time.time()
    sd = gptq_state_dict(MISTRAL_CFG, seed=0)
    t_synth = time.time() - t
    resident = torch.cuda.memory_allocated()
    t = time.time()
    params = params_from_gptq_state_dict(sd, MISTRAL_CFG, bits=4,
                                         group_size=128, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"Mistral-7B GPTQ state dict synthesized on the host in {t_synth:.1f}"
        f" s ({sum(a.nbytes for a in sd.values()) / 1e9:.3f} GB), converted "
        f"on the card in {time.time() - t:.1f} s: {nbytes / 1e9:.3f} GB of "
        f"weights, perms and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    del sd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _generate_paths(params, MISTRAL_CFG, "mistral_gptq",
                    (("bf16", MISTRAL_GEN), ("int8", MISTRAL_GEN_INT8)))
    res = {}
    dec = ("act_order_gather", "qmm4_npack_asym", "flash_decode")
    for fill in (128, T_PREFILL):
        name = f"mistral_gptq_decode_fill{fill}"
        ms = run_path(name, dec, lambda: decode_ms(params, fill,
                                                   cfg=MISTRAL_CFG))
        c = LAUNCHES[name]
        if 4 * c["act_order_gather"] != 3 * c["qmm4_npack_asym"]:
            raise AssertionError(f"{name}: {c['act_order_gather']} gathers "
                                 f"for {c['qmm4_npack_asym']} K1 launches")
        log(f"mistral gptq decode (slope n=4..36, batch 1, bf16 KV): fill "
            f"{fill} {ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"mistral_gptq_decode_ms_fill{fill}"] = ms
    for kv_dtype, kv, k3 in ((torch.bfloat16, "bf16", "flash_prefill"),
                             (torch.int8, "int8", "flash_prefill_i8")):
        ms = run_path(f"mistral_gptq_prefill_{kv}",
                      ("act_order_gather", "qmm_general", k3),
                      lambda: ttft_ms(params, kv_dtype, cfg=MISTRAL_CFG))
        log(f"mistral gptq TTFT 1975-token prefill (last-row logits, {kv} "
            f"KV): {ms:.2f} ms")
        res[f"mistral_gptq_ttft_1975_{kv}_ms"] = ms
    res["mistral_gptq_peak_gib"] = (torch.cuda.max_memory_allocated()
                                    - resident) / 2 ** 30
    perm = params.layers[0].wqkv.perm
    for M in (1, T_PREFILL):
        x = torch.randn((M, D), device=DEV).bfloat16()
        ms = time_ms([lambda: x.index_select(1, perm)])
        res[f"gather_ms_m{M}"] = ms
        log(f"act-order gather, one index_select of [{M}, {D}] bf16: "
            f"{ms:.4f} ms ({4 * M * D / (ms * 1e-3) / 1e9:.0f} GB/s read + "
            "written)")
    log(f"mistral gptq peak device memory since the conversion, less the "
        f"{resident / 2 ** 30:.2f} GiB other phases left resident: "
        f"{res['mistral_gptq_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


# TinyLlama/TinyLlama-1.1B-Chat-v1.0's config.json: 22 layers, hidden 2048,
# 32 heads over 4 KV heads of 64, FFN 5632, vocab 32000 untied,
# rms_norm_eps 1e-5, rope_theta 10000, max_position_embeddings 2048
TINY_CFG = llama.config_from_hf(types.SimpleNamespace(
    model_type="llama", vocab_size=V, hidden_size=2048,
    intermediate_size=5632, num_hidden_layers=22, num_attention_heads=H,
    num_key_value_heads=4, max_position_embeddings=2048, rms_norm_eps=1e-5,
    rope_theta=10000.0, bos_token_id=1, eos_token_id=2))
ATTN_KERNELS = tuple(fn for k in (_cuda.FLASH_PREFILL, _cuda.FLASH_DECODE,
                                  _cuda.PAGED_DECODE) for fn in k.launches)


def _no_attention_kernels(path):
    """Head dim 64 takes ``attend_xla``'s torch ops: no K3/K4/K6 launch."""
    hit = {k: LAUNCHES[path][k] for k in ATTN_KERNELS if LAUNCHES[path][k]}
    if hit:
        raise AssertionError(f"{path}: attention kernels launched at head "
                             f"dim 64: {hit}")


def phase_tinyllama():
    """TinyLlama-1.1B at full depth, q4_j, random weights from seed 0:
    ``Model.generate`` with bf16 and int8 KV, the batch-8 paged int8
    Scheduler (8 requests of 40-1200 tokens, 16 new each), decode ms/token
    at fill 128, TTFT at 1975 tokens, peak memory less what other phases
    left resident; attention at head dim 64 is ``attend_xla``'s torch ops,
    so K3/K4/K6 must read 0 on every path."""
    resident = torch.cuda.memory_allocated()
    params = _init_full(TINY_CFG, "TinyLlama-1.1B")
    paths = (("bf16", ("qmm4_npack", "qmm_a8", "attend_xla")),
             ("int8", ("qmm4_npack", "qmm_a8", "attend_xla")))
    _generate_paths(params, TINY_CFG, "tinyllama", paths)
    for kv, _ in paths:
        _no_attention_kernels(f"tinyllama_generate_{kv}")
    gen = torch.Generator().manual_seed(14)
    lens = torch.randint(40, 1200, (8,), generator=gen).tolist()
    sched = Scheduler(params, TINY_CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, kv_dtype=torch.int8)
    for i, n in enumerate(lens):
        sched.add_request(i, torch.randint(3, V, (n,), generator=gen)
                          .tolist(), max_new_tokens=16)
    done = run_path("tinyllama_sched_paged_int8",
                    ("qmm4_npack", "attend_xla_paged"),
                    lambda: {q.request_id: q.output_ids
                             for q in sched.run_to_completion()})
    _no_attention_kernels("tinyllama_sched_paged_int8")
    for i in range(8):
        _check_served(done[i], 16, f"tinyllama scheduler request {i}",
                      TINY_CFG)
    log(f"tinyllama paged int8 Scheduler (batch 8, prompts {lens}): "
        f"request 0 ids {done[0]}")
    del sched
    ms = run_path("tinyllama_decode_fill128", ("qmm4_npack", "attend_xla"),
                  lambda: decode_ms(params, 128, cfg=TINY_CFG))
    ttft = run_path("tinyllama_prefill_1975", ("qmm_a8", "attend_xla"),
                    lambda: ttft_ms(params, cfg=TINY_CFG))
    for path in ("tinyllama_decode_fill128", "tinyllama_prefill_1975"):
        _no_attention_kernels(path)
    log(f"tinyllama decode (slope n=4..36, batch 1, bf16 KV): fill 128 "
        f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s); TTFT 1975-token prefill "
        f"{ttft:.2f} ms")
    res = dict(tinyllama_decode_ms_fill128=ms, tinyllama_ttft_1975_ms=ttft,
               tinyllama_peak_gib=(torch.cuda.max_memory_allocated()
                                   - resident) / 2 ** 30)
    del params
    torch.cuda.empty_cache()
    return res


# a registry that puts every K2 layout on one prefill: int2, int3 and int6
# (int8 code planes) at group 128 with int8 activations, sym and asym
K2_LAYOUTS_REG = QuantRegistry(rules=[
    ("wq", QuantConfig(bits=2, group_size=128, act_bits=8)),
    ("wk", QuantConfig(bits=2, group_size=128, sym=False, act_bits=8)),
    ("wv", QuantConfig(bits=3, group_size=128, act_bits=8)),
    ("wo", QuantConfig(bits=3, group_size=128, sym=False, act_bits=8)),
    ("w_gate", QuantConfig(bits=6, group_size=128, act_bits=8)),
    ("w_up", QuantConfig(bits=6, group_size=128, sym=False, act_bits=8))],
    default="q4_j")
# Llama-2-7B's width with ChatGLM-2-6B's attention heads (32 over 2, G = 16)
# and with StarCoder's (48 heads of 128 over 1, hidden 6144, FFN 24576)
G16_CFG = dataclasses.replace(CFG, n_kv_heads=2)
G48_CFG = dataclasses.replace(CFG, hidden_size=6144, n_heads=48,
                              n_kv_heads=1, intermediate_size=24576)


def _copy_card_vs_plain(what, card, cfg2, required, n_prompt=24,
                        rel_tol=2e-2, seed=15, n_new=3):
    """``Model.generate`` of a copy on the card (a path with launch
    counts; ``n_prompt`` tokens, ``n_new`` new), then its logits, fed the
    card's ids, against the plain path on the card's own tensors; returns
    (the prompt, the card's new ids, the worst relative difference, the
    steps whose margin proved the argmax)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, min(cfg2.vocab_size, V), (n_prompt,),
                        generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path(f"card_{what}", required, lambda: model.generate(
        ids, max_new_tokens=n_new, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    _check_ids(new, n_new, f"card {what}", cfg2.vocab_size)
    worst, provable, _ = _steps_card_vs_plain(card, cfg2, ids, new,
                                              rel_tol)
    log(f"{what} card vs plain ({cfg2.n_layers} layer(s), full width, "
        f"{n_prompt}-token "
        f"prompt, fed the card's ids {new}): logits max err {worst:.3g}·"
        f"max|logit| (tol {rel_tol}); argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    return ids, new, worst, provable


def _g_many_card_paths(card, cfg2, what):
    """A copy with more than 8 query heads per KV head on the card alone:
    ``Model.generate`` with int8 KV (K4's int8 branch), and the paged
    Scheduler with bf16 and int8 pools (6 requests of 20-64 tokens, 3 new
    each; K6's), each a path with launch counts, ids in range."""
    gen = torch.Generator().manual_seed(16)
    ids = torch.randint(3, V, (24,), generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path(f"card_{what}_int8", ("flash_decode_i8+G>8",),
                   lambda: model.generate(ids, max_new_tokens=3,
                                          stop_at_eos=False,
                                          kv_dtype="int8")[0][24:])
    _check_ids(new, 3, f"{what} int8 KV")
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in torch.randint(20, 64, (6,), generator=gen).tolist()]
    for kv_dtype, entry in ((torch.bfloat16, "paged_decode+G>8"),
                            (torch.int8, "paged_decode_i8+G>8")):
        sched = Scheduler(card, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=kv_dtype)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=3)
        done = run_path(f"sched_{what}_{entry}", (entry,),
                        lambda: {q.request_id: q.output_ids
                                 for q in sched.run_to_completion()})
        for i in range(len(prompts)):
            _check_served(done[i], 3, f"{what} scheduler {entry}", cfg2)
    log(f"{what} on the card: generate int8 KV ids {new}; paged bf16 and "
        "int8 Schedulers ran 6 requests each")


def phase_copies_card_vs_plain():
    """One-layer full-width copies, the kernels against the plain path on
    the card's own tensors (``plain_on_card``; on the host's CPU it took
    a minute and a half of the script's limit) (logits
    within 2e-2·max|logit| where every product has bf16 activations, 5e-2
    where a prefill takes the int8 path, as phase 5's q4_j copy; argmax
    equal where the margin proves it): the Mistral GPTQ copy through
    ``Model.generate`` and the paged int8 Scheduler; the same copy written
    to a temporary directory under build/neural_tpu_torch/ (config.json,
    quantize_config.json, model.safetensors) and loaded by ``Model.init(dir,
    use_gptq=True)`` on the card, whose ids and logits must be the
    in-memory copy's; an AWQ copy; mix_int2_int4 (its g16 int2 asym at M=1
    through K5); every K2 layout on one 256-token prefill (int2, int3 and
    int6 at act_bits 8, sym and asym: the int3-a8 and int6-a8 copies);
    Llama-2-7B with linear RoPE scaling (factor 4); the TinyLlama copy
    (``attend_xla``; and its paged int8 Scheduler); Llama-2-7B's width
    with ChatGLM-2's heads (G = 16: K4 and, through the paged int8
    Scheduler, K6 past 8 heads a KV head), whose card-only paths and a
    copy with StarCoder's heads (G = 48) also run K4's int8 and K6's bf16
    branches past 8 heads (``_g_many_card_paths``)."""
    res = {}
    cfg2 = dataclasses.replace(MISTRAL_CFG, n_layers=COPY_LAYERS)
    sd = gptq_state_dict(cfg2, seed=30)
    card = params_from_gptq_state_dict(sd, cfg2, device=DEV)
    gptq_req = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
                "flash_prefill", "flash_decode")
    # random copies give flat logits (top-2 margins of 0.01-0.8
    # against differences of 0.03-0.08): as phase 5's formats, the argmax
    # must be proven at as many steps as there are copies, over all of them
    ids, new, res["mistral_gptq"], proven = _copy_card_vs_plain(
        "mistral_gptq", card, cfg2, gptq_req)
    res["mistral_gptq_sched"] = run_path(
        "sched_mistral_gptq", ("act_order_gather", "paged_decode_i8"),
        lambda: _sched_card_vs_plain(card, cfg2, 2e-2))
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as d:
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump({**MISTRAL_HF, "num_hidden_layers": cfg2.n_layers}, fh)
        with open(os.path.join(d, "quantize_config.json"), "w") as fh:
            json.dump(GPTQ_QUANTIZE_CONFIG, fh)
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        filed = Model().init(d, use_gptq=True, device=DEV)
    new_f = run_path("card_mistral_gptq_file", gptq_req, lambda: filed.generate(
        ids, max_new_tokens=3, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    with torch.inference_mode():
        a, b = (prefill_step(m, torch.tensor([ids], device=DEV),
                             torch.zeros(1, dtype=torch.long, device=DEV),
                             init_cache(cfg2, 1, 32, device=DEV))
                for m in (card, filed.params))
    if new_f != new or not torch.equal(a, b):
        raise AssertionError(f"Model.init(dir, use_gptq=True) gave ids "
                             f"{new_f}, the in-memory copy {new}, logits max "
                             f"diff {(a - b).abs().max().item()}")
    log(f"Model.init(dir, use_gptq=True) on the card: ids {new_f} and "
        "prefill logits equal to the in-memory copy's")
    del sd, card, filed
    torch.cuda.empty_cache()

    sd = gptq_state_dict(cfg2, seed=31, fmt="awq")
    card = params_from_gptq_state_dict(sd, cfg2, fmt="awq", device=DEV)
    _, _, res["mistral_awq"], n = _copy_card_vs_plain(
        "mistral_awq", card, cfg2,
        ("qmm_general", "qmm4_npack_asym", "flash_prefill", "flash_decode"))
    proven, copies = proven + n, 2
    if LAUNCHES["card_mistral_awq"]["act_order_gather"]:
        raise AssertionError("an AWQ checkpoint has no act-order gather")
    del sd, card
    llama2 = dataclasses.replace(CFG, n_layers=COPY_LAYERS)
    # the K2 copy's prefill takes the int8 path, whose activation codes move
    # a step where the card's bf16 roundings differ from the CPU's (as in
    # phase 5's q4_j copy): 5e-2, over 8 steps
    for i, (what, cfg2, quant, req, n_prompt, tol) in enumerate((
            ("mix_int2_int4", llama2, "mix_int2_int4",
             ("qmm_general", "qmm4_npack", "qmm4_npack_asym", "qmm8_native"),
             24, 2e-2),
            ("k2_layouts", llama2, K2_LAYOUTS_REG,
             ("quantize_act_i8",) + tuple(e for _, e, _, _ in K2_LAYOUTS),
             256, 5e-2),
            ("llama_rope_linear",
             dataclasses.replace(llama2, rope_scaling={"type": "linear",
                                                       "factor": 4.0}),
             "q4_j", ("qmm_general", "qmm4_npack", "flash_prefill",
                      "flash_decode"), 24, 2e-2),
            ("tinyllama", dataclasses.replace(TINY_CFG,
                                              n_layers=COPY_LAYERS), "q4_j",
             ("qmm_general", "qmm4_npack", "attend_xla"), 24, 2e-2),
            ("heads_g16", dataclasses.replace(G16_CFG, n_layers=COPY_LAYERS),
             "q4_j",
             ("qmm_general", "flash_prefill", "flash_decode+G>8"), 24,
             2e-2))):
        card = init_random(cfg2, seed=40 + i, quant=quant, device=DEV)
        _, _, res[what], n = _copy_card_vs_plain(
            what, card, cfg2, req, n_prompt, tol,
            n_new=8 if what == "k2_layouts" else 3)
        proven, copies = proven + n, copies + 1
        if what == "llama_rope_linear":
            base = rope_freqs(DH, None, 10000.0)
            if not torch.equal(card.rope_inv_freqs.cpu(),
                               torch.from_numpy(base / 4.0)):
                raise AssertionError("linear RoPE scaling left the table "
                                     "unscaled")
        if what == "tinyllama":
            _no_attention_kernels("card_tinyllama")
            res["tinyllama_sched"] = run_path(
                "sched_tinyllama", ("attend_xla_paged",),
                lambda: _sched_card_vs_plain(card, cfg2, 2e-2))
            _no_attention_kernels("sched_tinyllama")
        if what == "heads_g16":
            res["heads_g16_sched"] = run_path(
                "sched_heads_g16", ("paged_decode_i8+G>8",),
                lambda: _sched_card_vs_plain(card, cfg2, 2e-2))
            _g_many_card_paths(card, cfg2, "heads_g16")
        del card
        torch.cuda.empty_cache()
    # StarCoder's heads at hidden 6144: the card's paths alone (the copy is
    # 2.3x a Llama copy's CPU time; its kernels are held to their plain
    # versions at these heads in phase 3)
    card = init_random(dataclasses.replace(G48_CFG, n_layers=2), seed=50,
                       quant="q4_j", device=DEV)
    _g_many_card_paths(card, dataclasses.replace(G48_CFG, n_layers=2),
                       "heads_g48")
    del card
    torch.cuda.empty_cache()
    if proven < copies:
        raise AssertionError(f"only {proven} steps over {copies} copies had "
                             "a margin wide enough to compare the argmax")
    return {f"{k}_card_vs_plain_rel_err": v for k, v in res.items()}


# ---------------------------------------------------------------------------
# phase 7: model files (GGUF of every ggml type, NTPU checkpoints and
# session files, the streamed HF conversion, ModelServer(model_path=...))
# ---------------------------------------------------------------------------

# the phase's files: made here, removed after each leg
SCRATCH7 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_scratch", "phase7")
# the disk the phase needs free: the 3.8 GB GGUF and its 1.1 GB session
# file, or the 3.9 GB NTPU copy, at once, with room to spare
FREE_GB_7 = 8.0
GGML = {"Q4_0": GG.GGML_Q4_0, "Q4_1": GG.GGML_Q4_1, "Q5_0": GG.GGML_Q5_0,
        "Q5_1": GG.GGML_Q5_1, "Q8_0": GG.GGML_Q8_0, "Q2_K": GG.GGML_Q2_K,
        "Q3_K": GG.GGML_Q3_K, "Q4_K": GG.GGML_Q4_K, "Q5_K": GG.GGML_Q5_K,
        "Q6_K": GG.GGML_Q6_K}
# the byte offset of each type's fp16 scale d in its block (0 elsewhere)
D_AT = {"Q2_K": 80, "Q3_K": 108, "Q6_K": 208}
# Llama-2-7B's GGUF projections, [out, in] as ggml stores them: FFN 11008,
# unpadded (GGUF files are not padded)
GGUF_SHAPES = {"attn_q": (D, D), "attn_k": (D, D), "attn_v": (D, D),
               "attn_output": (D, D), "ffn_gate": (11008, D),
               "ffn_up": (11008, D), "ffn_down": (D, 11008)}
# a llama.cpp Q4_0 file: Q4_0 everywhere but the lm_head, which is Q6_K
Q4_0_FILE = {**dict.fromkeys(GGUF_SHAPES, "Q4_0"), "token_embd": "Q4_0",
             "output": "Q6_K"}
# the K1 entry point a type's at-rest layout takes at M <= 16 (group 32);
# the group-16 types (Q2_K, Q3_K, Q6_K) take K5's GEMV instead
K1_OF = {"Q4_0": "qmm4_npack", "Q4_1": "qmm4_npack_asym",
         "Q5_0": "qmm8_native", "Q5_1": "qmm8_native_asym",
         "Q8_0": "qmm8_native", "Q4_K": "qmm4_npack_asym",
         "Q5_K": "qmm8_native_asym"}
GGUF_TOL = 2e-2       # phase_zoo_card_vs_plain's, of max|logit|


def _free_gb(path):
    return shutil.disk_usage(path).free / 2 ** 30


def spm_vocab(n=V):
    """A synthetic SPM vocabulary of ``n`` pieces with scores: the specials,
    the 256 byte pieces, then words of 1-3 lowercase letters with and
    without the '▁' prefix, shorter words scoring higher."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = list(letters) + [a + b for a in letters for b in letters] + \
        [a + b + c for a in letters for b in letters for c in letters]
    special = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces = [p for w in words for p in ("▁" + w, w)]
    tokens = (special + pieces)[:n]
    scores = np.concatenate([np.zeros(len(special), np.float32),
                             -np.arange(n - len(special), dtype=np.float32)])
    return tokens, scores


def write_gguf(path, n_layers, types, seed, vocab=False, const=()):
    """A Llama-2-7B-wide GGUF file of ``n_layers`` layers, every quantized
    tensor random block bytes of its ``types`` entry (fp16 scales finite,
    of order 0.02; ``gguf_models.random_block_bytes``, made on the card),
    written with ``GGUFWriter.add_tensor_raw``; norms F32. The tensors in
    ``const`` get one constant group: block 0's d set to 0 (its min, for
    an asymmetric type, stays). Returns the file's bytes."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    w = GG.GGUFWriter(path)
    for k, v in (("general.architecture", "llama"),
                 ("llama.embedding_length", D),
                 ("llama.block_count", n_layers),
                 ("llama.attention.head_count", H),
                 ("llama.attention.head_count_kv", H),
                 ("llama.feed_forward_length", GGUF_SHAPES["ffn_gate"][0]),
                 ("llama.context_length", 4096),
                 ("llama.rope.freq_base", 10000.0),
                 ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2)):
        w.add_kv(k, v)
    if vocab:
        tokens, scores = spm_vocab()
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", tokens)
        w.add_kv("tokenizer.ggml.scores", scores)

    def raw(name, shape, type_name):
        blk = random_block_bytes(GGML[type_name], shape[0] * shape[1], gen,
                                 DEV)
        if name in const:
            at = D_AT.get(type_name, 0)
            blk[0, at:at + 2] = 0
        w.add_tensor_raw(name, shape, GGML[type_name],
                         blk.cpu().numpy().tobytes())

    def norm(name):
        v = 1 + 0.02 * torch.randn(D, generator=gen, device=DEV)
        w.add_tensor(name, v.cpu().numpy(), GG.GGML_F32)

    raw("token_embd.weight", (V, D), types["token_embd"])
    norm("output_norm.weight")
    raw("output.weight", (V, D), types["output"])
    for i in range(n_layers):
        norm(f"blk.{i}.attn_norm.weight")
        norm(f"blk.{i}.ffn_norm.weight")
        for name, shape in GGUF_SHAPES.items():
            raw(f"blk.{i}.{name}.weight", shape, types[name])
    w.write()
    return os.path.getsize(path)


def _paged_decode_plain(q, k_pool, v_pool, table, lengths, scale,
                        softcap=0.0, window=0, slopes=None):
    """K6's bf16 wrapper as it runs on the CPU: its plain version."""
    return PA.paged_decode_plain(q, k_pool, v_pool, None, None, table,
                                 lengths, scale, softcap, window, slopes)


def _paged_decode_i8_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                           lengths, scale, softcap=0.0, window=0,
                           slopes=None):
    """K6's int8 wrapper as it runs on the CPU: its plain version."""
    return PA.paged_decode_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                 lengths, scale, softcap, window, slopes)


# the kernel wrappers and the plain versions they call on the CPU: swapped
# in for a run of the plain path on the card's own tensors (a name of the
# same module, the norm's for None, or the function itself)
PLAIN_TWINS = ((Q, "qmm_native", "qmm_native_plain"),
               (Q, "qmm_native_fused", "qmm_native_fused_plain"),
               (Q, "qmm_a8", "qmm_a8_plain"),
               (Q, "qmm_general", "qmm_general_plain"),
               (Q, "act_quant_i8", "quantize_act_i8"),
               (A, "flash_prefill", "flash_prefill_plain"),
               (A, "flash_prefill_i8", "flash_prefill_i8_plain"),
               (A, "flash_decode", "flash_decode_plain"),
               (A, "flash_decode_i8", "flash_decode_i8_plain"),
               (NORMS, "rms_norm", "rms_norm_plain"),
               (TRANSFORMER, "rms_norm", None),
               # the paged forward's: its prefill's K3 and its steps' K6
               (PA, "flash_prefill", A.flash_prefill_plain),
               (PA, "flash_prefill_i8", A.flash_prefill_i8_plain),
               (PA, "paged_decode", _paged_decode_plain),
               (PA, "paged_decode_i8", _paged_decode_i8_plain))


@contextlib.contextmanager
def plain_on_card():
    """Every kernel wrapper of a forward (contiguous or paged cache)
    replaced by its plain version, so the card's tensors go through the
    plain path on the card: the CPU's plain path without a copy to the
    host (on the host's CPU the plain path of the ten 2-layer full-width
    copies would take minutes). Each pair's parameters are checked equal
    first; the run launches no kernel. The launch counts of a path around
    it are put back as they were."""
    import inspect
    saved = []
    before = _cuda.launch_counts()
    try:
        for mod, name, plain in PLAIN_TWINS:
            if callable(plain):
                twin = plain
            else:
                twin = getattr(mod if plain else NORMS,
                               plain or "rms_norm_plain")
            want = list(inspect.signature(getattr(mod, name)).parameters)
            got = list(inspect.signature(twin).parameters)
            if want != got:
                raise AssertionError(f"{name}{want} and its plain version "
                                     f"{got} differ")
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, twin)
        _cuda.reset_launches()
        yield
        torch.cuda.synchronize()
        launched = {fn: n for k in _cuda.KERNELS
                    for fn, n in k.launches.items() if n}
        if launched:
            raise AssertionError(f"the plain run launched {launched}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        _cuda.reset_launches()
        _cuda.add_launches({fn: n for fn, n in before.items() if n})


def graph_step_ms(params, cfg, fill, reps=20, S=S_CACHE):
    """The device time of one greedy decode step at ``fill``, batch 1:
    ``decode_loop``'s captured step replayed ``reps`` times with CUDA events
    around each (the position put back to ``fill`` before each); the
    median."""
    token = torch.full((1, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((1,), fill, dtype=torch.long, device=DEV)
    ts = []
    with torch.inference_mode():
        g = _StepGraph(params, token, pos, init_cache(cfg, 1, S, device=DEV))
        for r in range(reps + 1):
            g.pos.fill_(fill)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            if r:
                ts.append(e0.elapsed_time(e1))
    del g
    return statistics.median(ts)


def tensor_case(results, key, label, qt, M, fn, plain, entry):
    """One product of a loaded model's own weight ``qt`` at M rows: the
    wrapper ``fn(x, qt, out_dtype)`` (which must launch ``entry``) against
    ``plain`` on the same CUDA tensors (1e-2·max|ref| for a bf16 output,
    1e-4 for the lm_head's f32), its time, the plain version's, one bf16
    ``torch.matmul`` on the dequantized weight and the bound; recorded as
    a case of ``results[key]``."""
    gen = torch.Generator(device=DEV).manual_seed(M)
    K, N = qt.shape
    odt = torch.float32 if N == V else torch.bfloat16
    x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
    before = _cuda.launch_counts()[entry]
    out = fn(x, qt, odt)
    if _cuda.launch_counts()[entry] != before + 1:
        raise AssertionError(f"{label}: {entry} was not launched")
    ref = plain(x, qt, odt)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (1e-2 if odt == torch.bfloat16 else 1e-4) \
        * ref.float().abs().max().item()
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"{label}: max err {err} > tol {tol}")
    wbytes = _qt_bytes(qt)
    qts = [qt] + [_qt_copy(qt) for _ in range(_copies(wbytes) - 1)]
    ms = time_ms([lambda q=q: fn(x, q, odt) for q in qts])
    pms = time_ms([lambda: plain(x, qt, odt)], reps=5)
    wd = Q.dequant_bf16(qt)
    wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
    lms = time_ms([lambda w=w: torch.matmul(x, w) for w in wds])
    del wds, wd, qts
    bnd, by = bound_ms(wbytes + M * K * 2 + M * N * odt.itemsize,
                       2 * M * K * N, BF16_FLOPS)
    case = dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd,
                bound_by=by, err=err, per=f"{label} (one launch)")
    r = results.setdefault(key, dict(case, cases={}))
    r.setdefault("cases", {})[label] = case
    log(f"{key} {label} {entry} M={M} {K}x{N}: err {err:.3g} (tol "
        f"{tol:.3g}) | kernel {ms:.4f} ms, plain {pms:.3f} ms, "
        f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
        f"{wbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights")
    return case


K1_FN = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, qt.zeros,
                                        qt.group_size, qt.cfg.bits, odt)
K1_PLAIN = lambda x, qt, odt: Q.qmm_native_plain(
    x, qt.planes[0], qt.scales, qt.zeros, qt.group_size, qt.cfg.bits, odt)


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _same_model(a, b, what):
    sa, sb = a.state_dict(), b.state_dict()
    if sa.keys() != sb.keys():
        raise AssertionError(f"{what}: tensors {sorted(sa.keys() ^ sb.keys())}")
    for k in sa:
        if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"{what}: {k} differs")


def gguf_7b(results):
    """7a: Llama-2-7B as a llama.cpp Q4_0 GGUF file at full depth (Q6_K
    lm_head, a 32000-piece SPM vocabulary), through the entry points a
    user calls."""
    res = {}
    path = os.path.join(SCRATCH7, "llama-2-7b-q4_0.gguf")
    (size, write_s) = _timed(lambda: write_gguf(path, L, Q4_0_FILE, seed=70,
                                                vocab=True))
    m, load_s = _timed(lambda: Model().init_from_bin(path))
    params, cfg = m.params, m.cfg
    lm = params.lm_head.qt
    if params.layers[0].w_gate.qt.N != GGUF_SHAPES["ffn_gate"][0] \
            or lm.cfg.bits != 6 \
            or lm.cfg.group_size != 16 or lm.planes[0].dtype != torch.int8:
        raise AssertionError("the GGUF 7B's FFN is not 11008 wide or its "
                             "lm_head not 6-bit int8 codes at group 16")
    log(f"7a GGUF Llama-2-7B Q4_0 (Q6_K lm_head): {size / 1e9:.3f} GB "
        f"written in {write_s:.1f} s; init_from_bin {load_s:.2f} s "
        f"({size / load_s / 1e9:.2f} GB/s), "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"tokenizer {type(m.tokenizer).__name__}")
    gen = torch.Generator().manual_seed(70)
    prompt = torch.randint(3, V, (T_PREFILL,), generator=gen).tolist()
    n_new = 16
    new = run_path("gguf_7b_generate", (
        "qmm_general+tc", "qmm_general+gemv", "qmm4_npack", "flash_prefill",
        "flash_decode"), lambda: m.generate(
            prompt, max_new_tokens=n_new, stop_at_eos=False)[0][T_PREFILL:])
    _check_ids(new, n_new, "GGUF 7B generate")
    c = LAUNCHES["gguf_7b_generate"]
    k1 = c["qmm4_npack"] + c["qmm4_npack_fused"]
    want = {"K1": 7 * L * (n_new - 1), "K5 tc": 7 * L, "K5 gemv": n_new}
    got = {"K1": k1, "K5 tc": c["qmm_general+tc"],
           "K5 gemv": c["qmm_general+gemv"]}
    log(f"7a routes over a {T_PREFILL}-token prompt and {n_new} new tokens: "
        f"{got} (expected {want}: every decode projection on K1, the "
        "prefill's on K5's tensor-core tiles, the Q6_K lm_head on K5's "
        "GEMV)")
    if got != want:
        raise AssertionError(f"GGUF 7B routes {got}, expected {want}")
    res["gguf7b_load_s"] = load_s
    res["gguf7b_ttft_ms"] = ttft_ms(params, cfg=cfg)
    res["gguf7b_decode_ms_fill128"] = graph_step_ms(params, cfg, 128)
    res["gguf7b_decode_ms_fill1975"] = graph_step_ms(params, cfg, T_PREFILL)
    res["gguf7b_decode_slope_ms_fill128"] = decode_ms(params, 128, cfg=cfg)
    log(f"7a TTFT {T_PREFILL} tokens (best of 3) {res['gguf7b_ttft_ms']:.2f}"
        f" ms; decode step (graph replay, device time, median of 20) "
        f"{res['gguf7b_decode_ms_fill128']:.3f} ms at fill 128, "
        f"{res['gguf7b_decode_ms_fill1975']:.3f} ms at fill {T_PREFILL}; "
        f"host slope of decode_loop at fill 128 (the q4_0 leg's metric) "
        f"{res['gguf7b_decode_slope_ms_fill128']:.3f} ms")
    res.update(_beside_q4_0_preset(params, cfg))
    lw = params.layers[0]
    tensor_case(results, "K1", "gguf q4_0 gate/up M=1 (N=11008)",
                lw.w_gate.qt, 1, K1_FN, K1_PLAIN, "qmm4_npack")
    tensor_case(results, "K1", "gguf q4_0 down M=1 (K=11008)",
                lw.w_down.qt, 1, K1_FN, K1_PLAIN, "qmm4_npack")
    tensor_case(results, "K5", "gguf q6_k lm_head gemv M=1 (group 16)", lm,
                1, Q.qmm_general, Q.qmm_general_plain, "qmm_general+gemv")
    tensor_case(results, "K5", "gguf q4_0 gate/up tc M=1975 (N=11008)",
                lw.w_gate.qt, T_PREFILL, Q.qmm_general, Q.qmm_general_plain,
                "qmm_general+tc")
    tensor_case(results, "K5", "gguf q4_0 down tc M=1975 (K=11008)",
                lw.w_down.qt, T_PREFILL, Q.qmm_general, Q.qmm_general_plain,
                "qmm_general+tc")
    text = m.generate_text("hello world", max_new_tokens=8,
                           stop_at_eos=False)
    log(f"7a generate_text('hello world'): {text!r}")
    res.update(_session_legs(m, prompt))
    res.update(_server_from_path(path, cfg))
    os.remove(path)
    res.update(_ntpu_round_trip(m, prompt[:128]))
    del m, params
    torch.cuda.empty_cache()
    return res


def _beside_q4_0_preset(params, cfg):
    """The GGUF 7B's decode step beside the q4_0 preset's on the same card
    (``init_random``: the same Q4_0 blocks' layout, but the FFN padded to
    11264 and a Q4_0 lm_head on K1): graph replays at fill 128, GGUF,
    preset, preset, GGUF; the medians of each."""
    ref = init_random(CFG, seed=0, quant="q4_0", device=DEV)
    ts = {"gguf": [], "preset": []}
    for which in ("gguf", "preset", "preset", "gguf"):
        ts[which].append(graph_step_ms(params if which == "gguf" else ref,
                                       cfg if which == "gguf" else CFG, 128))
    del ref
    torch.cuda.empty_cache()
    out = {k: statistics.median(v) for k, v in ts.items()}
    log(f"7a decode step at fill 128, in turns on one card: GGUF Q4_0 "
        f"(FFN 11008, Q6_K lm_head on K5) {ts['gguf']} ms, the q4_0 preset "
        f"(FFN 11264, Q4_0 lm_head on K1) {ts['preset']} ms")
    return {"gguf7b_turns_decode_ms": out["gguf"],
            "q4_0_preset_turns_decode_ms": out["preset"]}


def _session_legs(m, prompt, S=T_PREFILL + 64 + 73):
    """Session files on the 7B: the prompt twice (the resumed run's greedy
    ids equal the first's exactly, no evaluation), then the prompt and 64
    more tokens with the prefix reused against without it."""
    sess = os.path.join(SCRATCH7, "session.ntpus")
    kw = dict(max_new_tokens=32, stop_at_eos=False, max_len=S)
    first, first_s = _timed(lambda: m.generate(prompt, session_file=sess,
                                               **kw)[0])
    size = os.path.getsize(sess)
    again, again_s = _timed(lambda: m.generate(prompt, session_file=sess,
                                               **kw)[0])
    if again != first:
        raise AssertionError("the resumed session's greedy ids differ: "
                             f"{again[-32:]} against {first[-32:]}")
    more = torch.randint(3, V, (64,), generator=torch.Generator()
                         .manual_seed(71)).tolist()
    longer = prompt + more
    one = dict(kw, max_new_tokens=1)
    m.generate(longer, **one)           # warm the fresh path's shapes
    (_, reuse_s) = _timed(lambda: m.generate(longer, session_file=sess,
                                             **one))
    (_, fresh_s) = _timed(lambda: m.generate(longer, **one))
    (_, load_s) = _timed(lambda: PC.load_session(sess, DEV))
    os.remove(sess)
    log(f"7a session ({size / 1e9:.3f} GB, cache of {S} positions): "
        f"{len(prompt)}-token prompt + 32 new {first_s:.2f} s with the save,"
        f" resumed {again_s:.2f} s (ids equal); prompt + 64: first token "
        f"{reuse_s * 1e3:.1f} ms reusing the saved prefix (load, 64-token "
        f"prefill, save back) against {fresh_s * 1e3:.1f} ms without a file"
        f"; the session file alone loads in {load_s * 1e3:.1f} ms")
    return {"session_resumed_s": again_s, "session_reuse_ttft_ms":
            reuse_s * 1e3, "session_fresh_ttft_ms": fresh_s * 1e3,
            "session_load_ms": load_s * 1e3, "session_bytes": size}


def _server_from_path(path, cfg):
    """``ModelServer(model_path=path)``, paged int8 KV, batch 8, answers 8
    queries after a warm-up query."""
    srv, load_s = _timed(lambda: ModelServer(
        model_path=path, max_batch=8, max_len=S_CACHE, kv_mode="paged",
        page_size=256, memory_dtype="int8"))
    try:
        prompts = _server_prompts()[:8]
        _serve(srv, [prompts[0][:600]], 4, cfg)
        done, _, wall = run_path(
            "gguf_7b_server", ("qmm_general+tc", "qmm4_npack",
                               "paged_decode_i8"),
            lambda: _serve(srv, prompts, 32, cfg))
    finally:
        srv.stop()
    n_tok = sum(len(q.output_ids) for q in done.values())
    log(f"7a ModelServer(model_path=GGUF) loaded in {load_s:.2f} s; 8 "
        f"queries (prompts {[len(p) for p in prompts]}, 32 new each): "
        f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s")
    del srv
    torch.cuda.empty_cache()
    return {"gguf7b_server_tok_s": n_tok / wall,
            "gguf7b_server_load_s": load_s}


def _ntpu_round_trip(m, prompt):
    """``save()`` to NTPU, ``init_from_bin`` of it: every tensor byte-equal,
    and the same greedy ids over 32 tokens (the routes are the same)."""
    path = os.path.join(SCRATCH7, "llama-2-7b-q4_0.ntpu")
    (_, save_s) = _timed(lambda: m.save(path))
    size = os.path.getsize(path)
    m2, load_s = _timed(lambda: Model().init_from_bin(path))
    os.remove(path)
    _same_model(m2.params, m.params, "NTPU round trip")
    a = m.generate(prompt, max_new_tokens=32, stop_at_eos=False)[0]
    b = m2.generate(prompt, max_new_tokens=32, stop_at_eos=False)[0]
    if a != b:
        raise AssertionError(f"NTPU copy's greedy ids {b[-32:]} differ from "
                             f"the GGUF model's {a[-32:]}")
    log(f"7a NTPU: saved {size / 1e9:.3f} GB in {save_s:.2f} s, loaded in "
        f"{load_s:.2f} s; every tensor byte-equal, greedy ids over 32 tokens "
        "equal")
    del m2
    torch.cuda.empty_cache()
    return {"ntpu7b_load_s": load_s, "ntpu7b_save_s": save_s}


def gguf_types(results):
    """7b: every ggml type as a 2-layer full-width file (the embedding and
    lm_head of the same type, one constant group in layer 0's q and down
    projections): ``Model.generate`` on the card, then the prefill's last
    logits of a 32-token prompt and 8 teacher-forced decode steps against
    the plain path on the card's own tensors (``plain_on_card``), each
    type's routes and decode ms/token."""
    res, worst = {}, 0.0
    gen = torch.Generator().manual_seed(72)
    for i, name in enumerate(GGML):
        path = os.path.join(SCRATCH7, f"{name}.gguf")
        types = {**dict.fromkeys(GGUF_SHAPES, name), "token_embd": name,
                 "output": name}
        write_gguf(path, 2, types, seed=80 + i,
                   const=("blk.0.attn_q.weight", "blk.0.ffn_down.weight"))
        m = Model().init_from_bin(path)
        os.remove(path)
        cfg2 = m.cfg
        ids = torch.randint(3, V, (32,), generator=gen).tolist()
        decode = K1_OF.get(name, "qmm_general+gemv")
        new = run_path(f"gguf_{name}", ("qmm_general+tc", decode,
                                        "flash_prefill", "flash_decode"),
                       lambda: m.generate(ids, max_new_tokens=9,
                                          stop_at_eos=False)[0][32:])
        _check_ids(new, 9, f"GGUF {name}")
        c = LAUNCHES[f"gguf_{name}"]
        routes = {k: n for k, n in c.items() if n and k.startswith("qmm")}
        card = _step_rows(m.params, cfg2, ids, new[:8])
        with plain_on_card():
            plain = _step_rows(m.params, cfg2, ids, new[:8])
        err, provable, _ = _compare_rows(card, plain, GGUF_TOL,
                                         f"GGUF {name} card vs plain")
        ms = graph_step_ms(m.params, cfg2, 128)
        worst = max(worst, err)
        res[f"gguf_{name}_decode_ms_2layers"] = ms
        log(f"7b {name}: 2 layers at full width, card vs plain on the card "
            f"{err:.3g}·max|logit| (tol {GGUF_TOL}), argmax proven at "
            f"{provable} of 9 rows; routes {routes}; decode step "
            f"{ms:.3f} ms (2 layers, fill 128, graph replay)")
        if name in ("Q2_K", "Q3_K", "Q6_K"):
            tensor_case(results, "K5", f"gguf {name.lower()} gate/up gemv "
                        "M=1 (group 16, N=11008)", m.params.layers[0]
                        .w_gate.qt, 1, Q.qmm_general, Q.qmm_general_plain,
                        "qmm_general+gemv")
        del m
        torch.cuda.empty_cache()
    res["gguf_types_card_vs_plain_rel_err"] = worst
    return res


STREAM_LAYERS = 4


def streamed_dir():
    """7c: Llama-2-7B's width at 4 layers, bf16, as two safetensors shards
    with ``model.safetensors.index.json``; converted at q4_j by
    ``Model.init`` in a child process of its own (so its peak RSS is this
    leg's), which also checks the routes and the CPU conversion."""
    d = os.path.join(SCRATCH7, "llama-2-7b-4l")
    os.makedirs(d, exist_ok=True)
    gen = torch.Generator(device=DEV).manual_seed(73)
    hf = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "hidden_size": D, "intermediate_size": 11008,
          "num_hidden_layers": STREAM_LAYERS, "num_attention_heads": H,
          "num_key_value_heads": H, "vocab_size": V, "rms_norm_eps": 1e-5,
          "max_position_embeddings": 4096, "rope_theta": 10000.0,
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2, "torch_dtype": "bfloat16"}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    cfg4 = llama.config_from_hf(types.SimpleNamespace(**hf))
    names = {"model.embed_tokens.weight": (V, D),
             "model.norm.weight": (D,), "lm_head.weight": (V, D)}
    for i in range(STREAM_LAYERS):
        for ours, (hf_name, _) in llama.hf_layer_map(i, cfg4).items():
            names[hf_name] = (D,) if ours.endswith("norm_w") else \
                {"w_gate": (11008, D), "w_up": (11008, D),
                 "w_down": (D, 11008)}.get(ours, (D, D))
    shard_of = lambda n: 1 if ".layers.0." in n or ".layers.1." in n \
        or "embed" in n else 2
    weight_map, total = {}, 0
    for s in (1, 2):
        fn = f"model-{s:05d}-of-00002.safetensors"
        part = {n: sh for n, sh in names.items() if shard_of(n) == s}
        weight_map.update(dict.fromkeys(part, fn))
        total += write_bf16_safetensors(os.path.join(d, fn), part, gen)
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    layer_f32 = 4 * sum(math.prod(names[hf_name]) for hf_name, _ in
                        llama.hf_layer_map(0, cfg4).values())
    t = time.time()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--convert-child", d], capture_output=True,
                         text=True, timeout=900)
    shutil.rmtree(d, ignore_errors=True)
    if out.returncode != 0:
        raise AssertionError(f"the conversion child failed:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    for line in out.stdout.splitlines()[:-1]:
        log(f"  child: {line}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    LAUNCHES["streamed_7b_4l_generate"] = r["launches"]
    missing = [k for k in ("qmm_a8", "qmm4_npack", "flash_prefill",
                           "flash_decode")
               if r["launches"].get(k, 0) == 0 and
               r["launches"].get(FUSED_TWIN.get(k), 0) == 0]
    if missing:
        raise AssertionError(f"streamed model: {missing} not launched")
    log(f"7c streamed bf16 directory ({total / 1e9:.3f} GB, 2 shards, "
        f"{STREAM_LAYERS} layers at 7B width) → q4_j on the card: "
        f"{r['convert_s']:.2f} s; the child's resident set rose by at most "
        f"{r['rss_delta_gb']:.3f} GB over its {r['rss_base_gb']:.3f} GB "
        f"(sampled every 2 ms; the card memory reserved meanwhile "
        f"{r['card_reserved_gb']:.3f} GB), its numpy host buffers peaked at "
        f"{r['host_peak_gb']:.3f} GB, against one layer's f32 bytes "
        f"{layer_f32 / 1e9:.3f} GB; routes {r['routes']}; every tensor "
        f"equal to the CPU's conversion; child {time.time() - t:.1f} s")
    return {"stream_convert_s": r["convert_s"],
            "stream_rss_delta_gb": r["rss_delta_gb"],
            "stream_host_peak_gb": r["host_peak_gb"],
            "stream_card_reserved_gb": r["card_reserved_gb"],
            "stream_layer_f32_gb": layer_f32 / 1e9}


def write_bf16_safetensors(path, shapes, gen):
    """Random bf16 tensors (N(0, 0.02²), norms near 1), made on the card,
    as one ``.safetensors`` file, a tensor at a time. Returns the data's
    bytes."""
    header, off = {}, 0
    for k, shape in shapes.items():
        n = 2 * math.prod(shape)
        header[k] = {"dtype": "BF16", "shape": list(shape),
                     "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(h)) + h)
        for k, shape in shapes.items():
            t = torch.randn(shape, generator=gen, device=DEV) * 0.02
            if len(shape) == 1:
                t = t + 1
            fh.write(t.bfloat16().view(torch.int16).cpu().numpy().tobytes())
    return off


def _rss_gb():
    """The process's resident set now (``/proc/self/statm``, else
    ``VmRSS``), in GB; NaN where the sandbox's /proc has neither."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") \
                / 1e9
    except (OSError, ValueError, IndexError):
        pass
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


class _PeakRss:
    """The largest resident set seen while the block runs, sampled every
    2 ms by a thread (the sandbox's /proc has no VmHWM, and its
    ``ru_maxrss`` counts the CUDA context's mappings)."""

    def __enter__(self):
        import threading
        self.base = self.peak = _rss_gb()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, _rss_gb())
        self._t = threading.Thread(target=sample, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, _rss_gb())


def convert_child(d):
    """The child of :func:`streamed_dir`: ``Model.init(d, "q4_j")`` on the
    card with the host's peak RSS before and after; a generate whose
    prefill must take K2 and decode K1 (launch counts); the same directory
    converted with ``device="cpu"`` equal, tensor for tensor. The last
    line is a JSON object."""
    import tracemalloc
    _cuda.build_all(_cuda.KERNELS)
    torch.zeros(1, device=DEV)
    tracemalloc.start()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    with _PeakRss() as rss:
        m, convert_s = _timed(lambda: Model().init(d, weight_dtype="q4_j"))
    host_peak = tracemalloc.get_traced_memory()[1] / 1e9
    tracemalloc.stop()
    card_gb = (torch.cuda.max_memory_reserved() - reserved0) / 1e9
    prompt = torch.randint(3, V, (512,), generator=torch.Generator()
                           .manual_seed(74)).tolist()
    _cuda.reset_launches()
    out = m.generate(prompt, max_new_tokens=8, stop_at_eos=False)[0]
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    _check_ids(out[512:], 8, "streamed model")
    cpu = Model().init(d, weight_dtype="q4_j", device="cpu")
    sa = {k: v.cpu() for k, v in m.params.state_dict().items()}
    sb = cpu.params.state_dict()
    if sa.keys() != sb.keys() or not all(
            sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
            for k in sa):
        raise AssertionError("the card's conversion differs from the CPU's")
    routes = {k: n for k, n in launches.items()
              if n and k.startswith(("qmm", "flash"))}
    print(f"converted in {convert_s:.2f} s; RSS {rss.base:.3f} GB before, "
          f"peak {rss.peak:.3f} GB during; numpy host buffers at most "
          f"{host_peak:.3f} GB at once; card memory reserved during the "
          f"conversion {card_gb:.3f} GB; {len(sa)} tensors equal to the "
          "CPU conversion")
    print(json.dumps({"convert_s": convert_s,
                      "rss_delta_gb": rss.peak - rss.base,
                      "rss_base_gb": rss.base, "host_peak_gb": host_peak,
                      "card_reserved_gb": card_gb,
                      "launches": launches, "routes": routes}))


def phase_model_files(results):
    """Phase 7: 7a, 7b and 7c, their files under ``.chip_scratch``."""
    os.makedirs(SCRATCH7, exist_ok=True)
    free = _free_gb(SCRATCH7)
    log(f"phase 7: {free:.1f} GiB free on the disk of {SCRATCH7} (needs "
        f"{FREE_GB_7})")
    if free < FREE_GB_7:
        raise AssertionError(f"phase 7 needs {FREE_GB_7} GiB of disk, "
                             f"{free:.1f} are free")
    try:
        res = gguf_7b(results)
        res.update(gguf_types(results))
        res.update(streamed_dir())
    finally:
        shutil.rmtree(SCRATCH7, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 8: the dense model zoo (8a Qwen2-7B, 8b GPT-J-6B, 8c one-layer
# full-width copies of the other families against the CPU's plain path, 8d
# the kernels at the shapes these families give them)
# ---------------------------------------------------------------------------

NS = types.SimpleNamespace
# Qwen/Qwen2-7B's config.json: 28 layers, hidden 3584, 28 heads over 4 KV
# heads (head dim 128, G = 7), FFN 18944 (padded to 19456), vocab 152064
# untied, rope_theta 1e6, rms_norm_eps 1e-6, bos and eos 151643; q/k/v
# biases (neural_tpu_torch/models/qwen.py)
QWEN2_CFG = qwen.config_from_hf(NS(
    model_type="qwen2", vocab_size=152064, hidden_size=3584,
    intermediate_size=18944, num_hidden_layers=28, num_attention_heads=28,
    num_key_value_heads=4, max_position_embeddings=32768, rope_theta=1e6,
    rms_norm_eps=1e-6, hidden_act="silu", tie_word_embeddings=False,
    bos_token_id=151643, eos_token_id=151643))
# EleutherAI/gpt-j-6b's config.json (transformers' GPTJConfig defaults): 28
# layers, n_embd 4096, 16 heads of 256 each with its own KV, rotary_dim 64
# (GPT-J pairs), FFN 16384, vocab 50400, n_positions 2048 (the cache's
# cap), layer_norm_epsilon 1e-5, bos and eos 50256; parallel residual with
# one shared LayerNorm, biased MLP and lm_head (models/gptj.py)
GPTJ_CFG = gptj.config_from_hf(NS(
    vocab_size=50400, n_embd=4096, n_layer=28, n_head=16, n_inner=None,
    rotary_dim=64, n_positions=2048, layer_norm_epsilon=1e-5,
    bos_token_id=50256, eos_token_id=50256))
# the published configs of 8c's copies (each cut to COPY_LAYERS layers)
ZOO8_CFGS = {
    # upstage/SOLAR-10.7B-v1.0: Llama's graph, 48 layers, hidden 4096, 32
    # heads over 8, FFN 14336, vocab 32000
    "solar": llama.config_from_hf(NS(
        model_type="solar", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
        bos_token_id=1, eos_token_id=2)),
    # Qwen/Qwen-7B (v1): hidden 4096, 32 heads, intermediate_size 22016
    # (both MLP halves: 11008 each), vocab 151936, eps 1e-6, 8192 positions
    "qwen1": qwen.config_from_hf(NS(
        model_type="qwen", vocab_size=151936, hidden_size=4096,
        intermediate_size=22016, num_hidden_layers=32,
        num_attention_heads=32, layer_norm_epsilon=1e-6,
        rotary_emb_base=10000.0, max_position_embeddings=8192)),
    # baichuan-inc/Baichuan2-7B-Base: hidden 4096, 32 heads, FFN 11008,
    # vocab 125696, RoPE
    "baichuan2_7b": baichuan.config_from_hf(NS(
        vocab_size=125696, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, intermediate_size=11008, rms_norm_eps=1e-6,
        model_max_length=4096, bos_token_id=1, eos_token_id=2)),
    # baichuan-inc/Baichuan-13B-Base: hidden 5120, 40 heads, FFN 13696,
    # vocab 64000; its modeling code takes ALiBi (its config.json names no
    # position type, so the literal does)
    "baichuan_13b": baichuan.config_from_hf(NS(
        vocab_size=64000, hidden_size=5120, num_hidden_layers=40,
        num_attention_heads=40, intermediate_size=13696, rms_norm_eps=1e-6,
        position_embedding="alibi", model_max_length=4096, bos_token_id=1,
        eos_token_id=2)),
    # stabilityai/stablelm-3b-4e1t (transformers' StableLmConfig defaults):
    # hidden 2560, 32 heads of 80, rotary 0.25, FFN 6912, vocab 50304
    "stablelm_3b": stablelm.config_from_hf(NS(
        vocab_size=50304, hidden_size=2560, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        intermediate_size=6912, layer_norm_eps=1e-5, use_qkv_bias=False,
        partial_rotary_factor=0.25, rope_theta=10000,
        max_position_embeddings=4096)),
    # EleutherAI/pythia-6.9b: hidden 4096, 32 heads of 128, rotary 0.25,
    # FFN 16384, vocab 50432, parallel residual
    "pythia_6.9b": gptneox.config_from_hf(NS(
        vocab_size=50432, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, intermediate_size=16384, layer_norm_eps=1e-5,
        hidden_act="gelu", rotary_pct=0.25, rotary_emb_base=10000,
        use_parallel_residual=True, max_position_embeddings=2048)),
    # EleutherAI/gpt-neox-20b (transformers' GPTNeoXConfig defaults):
    # hidden 6144, 64 heads of 96, FFN 24576, vocab 50432
    "gpt_neox_20b": gptneox.config_from_hf(NS(
        vocab_size=50432, hidden_size=6144, num_hidden_layers=44,
        num_attention_heads=64, intermediate_size=24576, layer_norm_eps=1e-5,
        hidden_act="gelu", rotary_pct=0.25, rotary_emb_base=10000,
        use_parallel_residual=True, max_position_embeddings=2048)),
    # THUDM/chatglm3-6b: hidden 4096, 32 heads over 2 groups, FFN 13696,
    # padded vocab 65024, GPT-J RoPE on half the head, q/k/v biases
    "chatglm3": chatglm.config_from_hf(NS(
        padded_vocab_size=65024, hidden_size=4096, num_layers=28,
        num_attention_heads=32, multi_query_attention=True,
        multi_query_group_num=2, ffn_hidden_size=13696,
        layernorm_epsilon=1e-5, add_qkv_bias=True, seq_length=8192)),
    # microsoft/phi-2: hidden 2560, 32 heads of 80, rotary 0.4, FFN 10240,
    # vocab 51200, one shared LayerNorm, lm_head bias
    "phi2": phi.config_from_hf(NS(
        model_type="phi", vocab_size=51200, hidden_size=2560,
        num_hidden_layers=32, num_attention_heads=32,
        intermediate_size=10240, layer_norm_eps=1e-5,
        partial_rotary_factor=0.4, rope_theta=10000.0,
        max_position_embeddings=2048, bos_token_id=50256,
        eos_token_id=50256)),
    # microsoft/Phi-3-mini-4k-instruct (transformers' Phi3Config
    # defaults): hidden 3072, 32 heads of 96, FFN 8192, vocab 32064
    "phi3_mini": phi.config_from_hf(NS(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        intermediate_size=8192, rms_norm_eps=1e-5, rope_theta=10000.0,
        rope_scaling=None, max_position_embeddings=4096, bos_token_id=1,
        eos_token_id=32000)),
    # tiiuae/falcon-7b (transformers' FalconConfig defaults): hidden 4544,
    # 71 heads of 64 over one KV head, FFN 18176, vocab 65024, no biases
    "falcon_7b": falcon.config_from_hf(NS(
        vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
        num_attention_heads=71, num_kv_heads=71,
        new_decoder_architecture=False, multi_query=True,
        layer_norm_epsilon=1e-5, bias=False, parallel_attn=True,
        max_position_embeddings=2048)),
    # tiiuae/falcon-40b: hidden 8192, 60 layers, 128 heads of 64 over 8
    # KV heads, the new decoder architecture (ln_attn / ln_mlp), FFN 32768
    "falcon_40b": falcon.config_from_hf(NS(
        vocab_size=65024, hidden_size=8192, num_hidden_layers=60,
        num_attention_heads=128, num_kv_heads=8,
        new_decoder_architecture=True, multi_query=False,
        layer_norm_epsilon=1e-5, bias=False, parallel_attn=True,
        max_position_embeddings=2048)),
    # facebook/opt-6.7b: hidden 4096, 32 heads, FFN 16384, vocab 50272
    # tied, 2048 learned positions at offset 2, ReLU
    "opt_6.7b": opt.config_from_hf(NS(
        vocab_size=50272, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, ffn_dim=16384, activation_function="relu",
        word_embed_proj_dim=4096, tie_word_embeddings=True,
        max_position_embeddings=2048)),
    # bigcode/starcoder: n_embd 6144, 40 layers, 48 heads of 128 over one
    # KV head, FFN 24576, vocab 49152 tied, 8192 learned positions
    "starcoder": starcoder.config_from_hf(NS(
        vocab_size=49152, n_embd=6144, n_layer=40, n_head=48, n_inner=24576,
        multi_query=True, layer_norm_epsilon=1e-5, n_positions=8192)),
    # 8b's GPT-J-6B, the copy the Scheduler check runs
    "gptj_6b": GPTJ_CFG,
}
ZOO8_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
ZOO8_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8",
                 "flash_decode_i8")
# the Qwen2-7B server's prompt tails prefill through K5 (buckets 32-128)
ZOO8_SERVE_I8 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill_i8",
                 "paged_decode_i8")
# 8c: (copy, quant, kernels its path must launch); the copies whose heads
# (64, 80, 96) ``attend_xla`` takes launch no K3/K4/K6
_K = ("qmm_general+tc", "qmm4_npack", "flash_prefill", "flash_decode")
_XLA = ("qmm_general+tc", "qmm4_npack", "attend_xla")
ZOO8_COPIES = (
    ("solar", "q4_j", _K),
    ("qwen1", "q4_j", _K),
    ("baichuan2_7b", "q4_j", _K),
    ("baichuan_13b", "q4_j", ("qmm_general+tc", "qmm4_npack",
                              "flash_prefill+alibi", "flash_decode+alibi")),
    ("stablelm_3b", "q4_j", _XLA),
    ("pythia_6.9b", "q4_j", _K),
    ("gpt_neox_20b", "q4_j", _XLA),
    ("chatglm3", "q4_j", _K),
    ("phi2", "q4_j", _XLA),
    ("phi3_mini", "q4_j", _XLA),
    ("falcon_7b", "q4_0", _XLA),
    ("falcon_40b", "q4_j", _XLA),
    ("opt_6.7b", "q4_j", _K),
    ("starcoder", "q4_j", _K),
    ("gptj_6b", "q4_j", _K),
)
# teacher-forced steps after each copy's prefill, as phase 5c's: the plain
# path dequantizes every weight at each call on the host's CPU, and with 8
# steps a copy phase 8c took 352 s (one run, on an NVIDIA H100 80GB HBM3 at
# 700 W and its host), which the script's time limit does not leave
ZOO8_STEPS = 3


def _zoo_full(cfg, what, paths, fills, sched_required=None):
    """One family at full depth, q4_j, random weights from seed 0:
    ``Model.generate`` per (KV dtype, kernels), decode ms/token at
    ``fills`` (bf16 KV) and at 1975 (int8 KV), TTFT at 1975 tokens (bf16
    and int8 KV), with ``sched_required`` the batch-8 paged int8
    ``ModelServer`` over phase 6's 12 queries, and peak memory; each a path
    with its launch counts. Caches hold 2048 positions."""
    params = _init_full(cfg, what)
    _generate_paths(params, cfg, what, paths)
    res = {}
    for fill, kv in [(f, torch.bfloat16) for f in fills] + [
            (T_PREFILL, torch.int8)]:
        i8 = kv == torch.int8
        ms = run_path(f"{what}_decode_fill{fill}{'_i8kv' if i8 else ''}",
                      ("qmm4_npack", "flash_decode_i8" if i8
                       else "flash_decode"),
                      lambda: decode_ms(params, fill, kv_dtype=kv, cfg=cfg))
        log(f"{what} decode (slope n=4..36, batch 1, "
            f"{'int8' if i8 else 'bf16'} KV): fill {fill} {ms:.3f} ms/token "
            f"({1e3 / ms:.1f} tok/s)")
        res[f"{what}_decode_ms_fill{fill}{'_i8kv' if i8 else ''}"] = ms
    for kv in (torch.bfloat16, torch.int8):
        i8 = kv == torch.int8
        ms = run_path(f"{what}_prefill_1975{'_i8kv' if i8 else ''}",
                      ("qmm_a8", "flash_prefill_i8" if i8
                       else "flash_prefill"),
                      lambda: ttft_ms(params, kv_dtype=kv, cfg=cfg))
        log(f"{what} TTFT 1975-token prefill (last-row logits, "
            f"{'int8' if i8 else 'bf16'} KV): {ms:.2f} ms")
        res[f"{what}_ttft_1975_ms{'_i8kv' if i8 else ''}"] = ms
    if sched_required:
        res.update({f"{what}_server_{k}": v for k, v in _server_timed(
            params, cfg, f"{what}_server_paged_int8", sched_required,
            _server_prompts()).items()})
        log(f"{what} server K6 launches: "
            f"{LAUNCHES[f'{what}_server_paged_int8']['paged_decode_i8']}")
    res[f"{what}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{what} peak device memory {res[f'{what}_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


def zoo_copies_card_vs_plain(rel_tol=2e-2):
    """8c: one-layer full-width copies of each family: ``Model.generate``
    on the card (a path each: 100-token prompt, greedy), then the
    prefill's last logits and ``ZOO8_STEPS`` steps fed the card's ids
    against the plain path on the card's own tensors (``plain_on_card``,
    as 7b: on the host's CPU this phase took 161 s of the script's time
    limit; bf16 activations: 100 rows take K5, so phase 5c's tolerance,
    2e-2·max|logit|), argmax equal wherever the margin proves it; the
    copies at head dims 64-96 launch no K3/K4/K6; then phase 5's paged
    int8 Scheduler check on the GPT-J and OPT copies, its plain side on the
    card too."""
    gen = torch.Generator().manual_seed(18)
    res = {}
    steps = ZOO8_STEPS
    for i, (what, quant, required) in enumerate(ZOO8_COPIES):
        t = time.time()
        cfg2 = dataclasses.replace(ZOO8_CFGS[what], n_layers=COPY_LAYERS)
        card = init_random(cfg2, seed=40 + i, quant=quant, device=DEV)
        ids = torch.randint(3, cfg2.vocab_size, (100,), generator=gen) \
            .tolist()
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{what}", required, lambda: model.generate(
            ids, max_new_tokens=steps + 1, do_sample=False,
            stop_at_eos=False, repetition_penalty=1.0)[0])[len(ids):]
        _check_ids(new, steps + 1, f"card {what}", cfg2.vocab_size)
        if "attend_xla" in required:
            _no_attention_kernels(f"card_{what}")
        rows = _step_rows(card, cfg2, ids, new[:steps])
        with plain_on_card():
            plain = _step_rows(card, cfg2, ids, new[:steps])
        worst, provable, _ = _compare_rows(rows, plain, rel_tol)
        log(f"{what} card vs plain on the card ({cfg2.n_layers} layer(s), "
            f"full width, "
            f"{quant}, head dim {cfg2.head_dim}, {cfg2.n_heads} heads over "
            f"{cfg2.n_kv_heads}, 100-token prompt, fed the card's ids {new}): "
            f"logits max err {worst:.3g}·max|logit| (tol {rel_tol}); argmax "
            f"provably comparable at {provable} of {steps + 1} steps, equal "
            f"at all of them; {time.time() - t:.1f} s")
        if provable < 2:
            raise AssertionError(f"too few {what} steps with a margin wide "
                                 "enough to compare the argmax")
        res[f"zoo8_{what}_card_vs_plain_rel_err"] = worst
        if what in ("gptj_6b", "opt_6.7b"):
            res[f"zoo8_{what}_sched_card_vs_plain_rel_err"] = \
                _sched_card_vs_plain(card, cfg2, rel_tol)
        del card, model
        torch.cuda.empty_cache()
    return res


def _lib_alibi(q, kd, vd, sl, offset, scale):
    """One ``scaled_dot_product_attention`` with the ALiBi bias and the
    causal mask as its float mask (q [B, Hq, Tq, Dh] at rows offset..)."""
    Tq, S = q.shape[2], kd.shape[2]
    qp = torch.arange(Tq, device=DEV)[:, None] + offset
    kp = torch.arange(S, device=DEV)[None, :]
    bias = sl.float()[:, None, None] * (kp - qp).float()
    bias = bias.masked_fill(kp > qp, float("-inf"))[None].bfloat16()
    return lambda: _sdpa(q, kd, vd, attn_mask=bias, scale=scale)


# 8d's heads: (what, Hq, Hkv, head dim, launches a token or prefill)
QWEN2_HEADS = ("qwen2-7b", 28, 4, 128, 28)
GPTJ_HEADS = ("gpt-j-6b", 16, 16, 256, 28)
B13_HEADS = ("baichuan-13b", 40, 40, 128, 40)


def check_zoo_kernels(gen, results):
    """8d: K4 at fill 1975 and K6 at B=8 with the server's mixed fills at
    G = 7 (Qwen2-7B: 28 heads over 4), bf16 and int8; K3 on a 1975-token
    prompt and K4 at fill 1975 at head dim 256 with one KV head per query
    head (GPT-J-6B: 16 over 16), bf16 and int8; K3 and K4 with ALiBi at
    Baichuan-13B's 40 heads (slopes of a head count that is not a power of
    two), bf16; K1 on Qwen2-7B's 3584 × 152064 lm_head at M=1; K5's tiles
    at M=1975 on Falcon-7B's 4544 × 4544 and 4544 × 18432 q4_0 products.
    Each against its plain version, with its time, the plain version's,
    one library call's (``sdpa``; ``torch.matmul`` on the dequantized
    weight) and its bound. Recorded under ``zoo_<kernel>`` and, where
    phase 3 ran, among that kernel's cases."""
    ps, cpu = 256, torch.Generator().manual_seed(19)
    zoo = {}
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        row_b = lambda Dh: Dh + 2 if int8 else 2 * Dh
        tol = I8_DECODE_TOL if int8 else BF16_TOL
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        p4 = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        k6 = PA.paged_decode_i8 if int8 else PA.paged_decode
        k3 = A.flash_prefill_i8 if int8 else A.flash_prefill
        p3 = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
        for what, Hq, Hkv, Dh, count in (QWEN2_HEADS, GPTJ_HEADS):
            row = row_b(Dh)
            fill = T_PREFILL
            q = (torch.randn((1, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            caches = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), int8,
                                 _copies(2 * fill * Hkv * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     Dh ** -0.5) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            label = f"{what} heads ({Hq} over {Hkv}, head dim {Dh}) decode " \
                f"fill {fill}"
            zoo.setdefault(f"K4{sfx}", {})[label] = _attn_case(
                label, f"flash_decode{sfx}", lambda: k4(*args[0]),
                lambda: p4(*args[0]), 2 * fill * Hkv * row + Hq * Dh * 6,
                _attn_ops(int8, Dh, Hq, fill, False, True), tol, count,
                runs=[lambda a=a: k4(*a) for a in args],
                library=[lambda kv=kv: _sdpa(
                    q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill],
                    enable_gqa=Hq != Hkv) for kv in kvs])
            del q, caches, args, kvs
            if what == QWEN2_HEADS[0]:
                B, maxp = len(SERVER_FILLS), S_CACHE // ps
                P = B * maxp + 1
                table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
                    .reshape(B, maxp).to(torch.int32).to(DEV)
                lengths = torch.tensor(SERVER_FILLS, dtype=torch.int32,
                                       device=DEV)
                q = (torch.randn((B, Hq, Dh), generator=gen, device=DEV)
                     * Q_SPREAD).bfloat16()
                c = _attn_cache(gen, (P, Hkv, ps, Dh), int8)[0]
                a6 = (q, c[0], c[1], *(c[2:] if int8 else ()), table,
                      lengths, Dh ** -0.5)
                kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
                mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                n = sum(SERVER_FILLS)
                label = f"{what} heads ({Hq} over {Hkv}) B={B} decode " \
                    f"fills {SERVER_FILLS}"
                zoo.setdefault(f"K6{sfx}", {})[label] = _attn_case(
                    label, f"paged_decode{sfx}", lambda: k6(*a6),
                    lambda: PA.paged_decode_plain(q, *c, table, lengths,
                                                  Dh ** -0.5),
                    2 * n * Hkv * row + B * maxp * 4 + B * 4
                    + B * Hq * Dh * 6,
                    _attn_ops(int8, Dh, Hq, n, False, True), tol, count,
                    library=[lambda: _sdpa(q[:, :, None], kd, vd,
                                           attn_mask=mask, enable_gqa=True)])
                del q, c, a6, kd, vd, mask
            else:
                T = T_PREFILL
                starts = torch.zeros(1, dtype=torch.int32, device=DEV)
                q = (torch.randn((1, T, Hq, Dh), generator=gen, device=DEV)
                     * Q_SPREAD).bfloat16()
                c = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), int8)[0]
                a3 = (q, c[0], c[1], *(c[2:] if int8 else ()), starts,
                      Dh ** -0.5)
                kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
                qh = q.transpose(1, 2)
                label = f"{what} heads ({Hq} over {Hkv}, head dim {Dh}) " \
                    f"{T}-token prefill"
                zoo.setdefault(f"K3{sfx}", {})[label] = _attn_case(
                    label, f"flash_prefill{sfx}", lambda: k3(*a3),
                    lambda: p3(*a3),
                    T * Hq * Dh * 2 + 2 * T * Hkv * row + T * Hq * Dh * 4,
                    _attn_ops(int8, Dh, Hq, _pairs(T, 0), False, False),
                    I8_PREFILL_TOL if int8 else BF16_TOL, count,
                    library=[lambda: _sdpa(qh, kd, vd, is_causal=True)])
                del q, c, a3, kd, vd, qh
            torch.cuda.empty_cache()
    # ALiBi at Baichuan-13B's 40 heads, bf16
    what, Hq, Hkv, Dh, count = B13_HEADS
    sl, T, row = _slopes(Hq), T_PREFILL, 2 * Dh
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    q = (torch.randn((1, T, Hq, Dh), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    c = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), False)[0]
    a3 = (q, c[0], c[1], starts, Dh ** -0.5)
    kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
    label = f"{what} {T}-token prefill, alibi ({Hq} heads)"
    zoo["K3_alibi"] = {label: _attn_case(
        label, "flash_prefill+alibi", lambda: A.flash_prefill(*a3, slopes=sl),
        lambda: A.flash_prefill_plain(*a3, slopes=sl),
        T * Hq * Dh * 2 + 2 * T * Hkv * row + T * Hq * Dh * 4,
        _attn_ops(False, Dh, Hq, _pairs(T, 0), True, False), BF16_TOL, count,
        library=[_lib_alibi(q.transpose(1, 2), kd, vd, sl, 0, Dh ** -0.5)],
        off=[lambda: A.flash_prefill(*a3)])}
    del q, c, a3, kd, vd
    fill = T_PREFILL
    q = (torch.randn((1, Hq, Dh), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    caches = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), False,
                         _copies(2 * fill * Hkv * row))
    lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
    args = [(q, c[0], c[1], lengths, Dh ** -0.5) for c in caches]
    kd, vd = (x[:, :, :fill] for x in _bf16_kv(caches[0]))
    label = f"{what} decode fill {fill}, alibi ({Hq} heads)"
    zoo["K4_alibi"] = {label: _attn_case(
        label, "flash_decode+alibi",
        lambda: A.flash_decode(*args[0], slopes=sl),
        lambda: A.flash_decode_plain(*args[0], slopes=sl),
        2 * fill * Hkv * row + Hq * Dh * 6,
        _attn_ops(False, Dh, Hq, fill, True, True), BF16_TOL, count,
        runs=[lambda a=a: A.flash_decode(*a, slopes=sl) for a in args],
        library=[_lib_alibi(q[:, :, None], kd, vd, sl, fill - 1,
                            Dh ** -0.5)],
        off=[lambda a=a: A.flash_decode(*a) for a in args])}
    del q, caches, args, kd, vd
    torch.cuda.empty_cache()
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    zoo["K1"] = {"qwen2-7b lm_head 3584 x 152064, decode step": _case(
        gen, "qwen2-7b lm_head 3584 x 152064, decode step", PRESETS["q4_j"],
        1, [(3584, 152064, 1)], k1, p1, "qmm4_npack", BF16_FLOPS,
        vocab=152064)}
    torch.cuda.empty_cache()
    k5 = lambda x, qt, odt: Q.qmm_general(x, qt, odt)
    p5 = lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt)
    label = "falcon-7b q4_0 1975-token prefill, 4544 x 4544 and 4544 x 18432"
    zoo["K5_tc"] = {label: _case(
        gen, label, PRESETS["q4_0"], T_PREFILL,
        [(4544, 4544, 64), (4544, 18432, 32)], k5, p5, "qmm_general+tc",
        BF16_FLOPS)}
    torch.cuda.empty_cache()
    for key, cases in zoo.items():
        results[f"zoo_{key}"] = dict(next(iter(cases.values())), cases=cases)
        for main in (key, "K5") if key == "K5_tc" else (key,):
            if main in results:
                results[main]["cases"].update(cases)
    return {f"8d {k} {label}": {m: c[m] for m in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
        for k, cases in zoo.items() for label, c in cases.items()}


def phase_zoo(results):
    """Phase 8: 8a Qwen2-7B and 8b GPT-J-6B at full depth, 8c the one-layer
    copies against the CPU's plain path, 8d the kernels at the zoo's
    shapes."""
    t = time.time()
    gen = torch.Generator(device=DEV).manual_seed(8)
    res = {"8d": check_zoo_kernels(gen, results)}
    log(f"phase 8d: {time.time() - t:.1f} s")
    t = time.time()
    res.update(_zoo_full(QWEN2_CFG, "qwen2", (("bf16", ZOO8_GEN),
                                              ("int8", ZOO8_GEN_INT8)),
                         (128, T_PREFILL), ZOO8_SERVE_I8))
    log(f"phase 8a: {time.time() - t:.1f} s")
    t = time.time()
    res.update(_zoo_full(GPTJ_CFG, "gptj", (("bf16", ZOO8_GEN),
                                            ("int8", ZOO8_GEN_INT8)),
                         (128, T_PREFILL)))
    log(f"phase 8b: {time.time() - t:.1f} s")
    t = time.time()
    res.update(zoo_copies_card_vs_plain())
    log(f"phase 8c: {time.time() - t:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 9: mixture-of-experts (Mixtral-8x7B and Grok-1 through the routed
# expert MLP: every expert's products on K1/K2/K5, the attention on
# K3/K4/K6)
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json: 32 layers, hidden 4096, 32
# heads over 8 KV heads (head dim 128, G = 4), FFN 14336 a expert, 8
# experts top 2, vocab 32000, rope_theta 1e6, rms_norm_eps 1e-5, 32768
# positions, no sliding window (models/llama.py)
MIXTRAL_CFG = llama.config_from_hf(NS(
    model_type="mixtral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, max_position_embeddings=32768, rms_norm_eps=1e-5,
    rope_theta=1e6, num_local_experts=8, num_experts_per_tok=2,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2))
# keyfan/grok-1-hf's config.json: 64 layers, hidden 6144, 48 heads over 8
# (head dim 128, G = 6), FFN 32768 a expert, 8 experts top 2, vocab 131072,
# attn_output_multiplier 0.0884, embedding_multiplier_scale 78.38, 8192
# positions; softcaps of 30, post norms, tanh GELU (models/grok.py)
GROK_CFG = grok.config_from_hf(NS(
    vocab_size=131072, hidden_size=6144, intermediate_size=32768,
    num_hidden_layers=64, num_attention_heads=48, num_key_value_heads=8,
    rms_norm_eps=1e-5, num_experts=8, num_experts_per_tok=2,
    attn_output_multiplier=0.08838834764831845,
    embedding_multiplier_scale=78.38367176906169,
    max_position_embeddings=8192, rope_theta=10000))
# the dense mixture runs every expert on every row: a token (or a prefill)
# takes E·2 gate/up and E down products a layer
MIX_EXPERT_PROJ = [(4096, 14336, 2 * 8 * 32), (14336, 4096, 8 * 32)]
GROK_EXPERT_PROJ = [(6144, 32768, 2 * 8 * 64), (32768, 6144, 8 * 64)]
# (what, Hq, Hkv, head dim, softcap, layers)
MIX_HEADS = ("mixtral-8x7b", 32, 8, 128, 0.0, 32)
GROK_HEADS = ("grok-1", 48, 8, 128, 30.0, 64)
# a q4_j decode step of Mixtral-8x7B: q/k/v/o and 8 experts' 3 products a
# layer, and the lm_head
MIX_STEP_K1 = 32 * (4 + 8 * 3) + 1
MIX_PREFILL_K2 = 32 * (4 + 8 * 3)
MOE_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
MOE_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8", "flash_decode_i8")
MOE_SERVE_I8 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill_i8",
                "paged_decode_i8")
# 9b: (copy, published config, kernels its path must launch); a 100-token
# prefill takes K5's tiles, the decode steps K1
MOE_COPIES = (("mixtral", MIXTRAL_CFG, ("qmm_general+tc", "qmm4_npack",
                                        "flash_prefill", "flash_decode")),
              ("grok", GROK_CFG, ("qmm_general+tc", "qmm4_npack",
                                  "flash_prefill", "flash_decode")))
MOE_LAYERS = 2
MOE_TOL = 2e-2      # phase 8c's, of max|logit| (bf16 activations)
MOE_STEPS = 3


def _moe_attention(gen, zoo):
    """9d's attention cases: K4 at fill 1975 and K6 int8 at B=8 with the
    server's mixed fills, at G = 4 (Mixtral) and G = 6 with softcap 30
    (Grok-1); K3 on a 1975-token prompt at G = 6 with softcap 30. Library:
    ``sdpa`` without the softcap, a compiled ``flex_attention`` with it."""
    ps, cpu = 256, torch.Generator().manual_seed(91)
    for what, Hq, Hkv, Dh, cap, count in (MIX_HEADS, GROK_HEADS):
        fill = T_PREFILL
        q = (torch.randn((1, Hq, Dh), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        caches = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), False,
                             _copies(2 * fill * Hkv * 2 * Dh))
        lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
        args = [(q, c[0], c[1], lengths, Dh ** -0.5, cap) for c in caches]
        kvs = [_bf16_kv(c) for c in caches]
        if cap:
            library = _flex(q[:, :, None], kvs, [fill - 1], 0, Dh ** -0.5,
                            cap, lambda: A.flash_decode_plain(
                                q, *kvs[0], lengths, Dh ** -0.5,
                                cap)[:, :, None])
        else:
            library = [lambda kv=kv: _sdpa(
                q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill],
                enable_gqa=True) for kv in kvs]
        label = f"{what} heads ({Hq} over {Hkv}, softcap {cap:g}) decode " \
            f"fill {fill}"
        zoo.setdefault("K4", {})[label] = _attn_case(
            label, "flash_decode", lambda: A.flash_decode(*args[0]),
            lambda: A.flash_decode_plain(*args[0]),
            2 * fill * Hkv * 2 * Dh + Hq * Dh * 6,
            _attn_ops(False, Dh, Hq, fill, False, True), BF16_TOL, count,
            runs=[lambda a=a: A.flash_decode(*a) for a in args],
            library=library)
        del q, caches, args, kvs, library
        B, maxp = len(SERVER_FILLS), S_CACHE // ps
        P = B * maxp + 1
        table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
            .reshape(B, maxp).to(torch.int32).to(DEV)
        lengths = torch.tensor(SERVER_FILLS, dtype=torch.int32, device=DEV)
        q = (torch.randn((B, Hq, Dh), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (P, Hkv, ps, Dh), True)[0]
        a6 = (q, *c, table, lengths, Dh ** -0.5, cap)
        kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
        if cap:
            library = _flex(q[:, :, None], [(kd, vd)],
                            [f - 1 for f in SERVER_FILLS], 0, Dh ** -0.5, cap,
                            lambda: A.flash_decode_plain(
                                q, kd, vd, lengths, Dh ** -0.5,
                                cap)[:, :, None])
        else:
            mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            library = [lambda: _sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                                     enable_gqa=True)]
        n = sum(SERVER_FILLS)
        label = f"{what} heads ({Hq} over {Hkv}, softcap {cap:g}) B={B} " \
            f"decode fills {SERVER_FILLS}"
        zoo.setdefault("K6_i8", {})[label] = _attn_case(
            label, "paged_decode_i8", lambda: PA.paged_decode_i8(*a6),
            lambda: PA.paged_decode_plain(q, *c, table, lengths, Dh ** -0.5,
                                          cap),
            2 * n * Hkv * (Dh + 2) + B * maxp * 4 + B * 4 + B * Hq * Dh * 6,
            _attn_ops(True, Dh, Hq, n, False, True), I8_DECODE_TOL, count,
            library=library)
        del q, c, a6, kd, vd, library
        torch.cuda.empty_cache()
    what, Hq, Hkv, Dh, cap, count = GROK_HEADS
    T = T_PREFILL
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    q = (torch.randn((1, T, Hq, Dh), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    c = _attn_cache(gen, (1, Hkv, S_CACHE, Dh), False)[0]
    a3 = (q, c[0], c[1], starts, Dh ** -0.5, cap)
    kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
    library = _flex(q.transpose(1, 2), [(kd, vd)], [0], 0, Dh ** -0.5, cap,
                    lambda: A.flash_prefill_plain(
                        q, kd, vd, starts, Dh ** -0.5, cap).transpose(1, 2))
    label = f"{what} heads ({Hq} over {Hkv}, softcap {cap:g}) {T}-token " \
        "prefill"
    zoo.setdefault("K3", {})[label] = _attn_case(
        label, "flash_prefill", lambda: A.flash_prefill(*a3),
        lambda: A.flash_prefill_plain(*a3),
        T * Hq * Dh * 2 + 2 * T * Hkv * 2 * Dh + T * Hq * Dh * 4,
        _attn_ops(False, Dh, Hq, _pairs(T, 0), False, False), BF16_TOL,
        count, library=library)
    del q, c, a3, kd, vd, library
    torch.cuda.empty_cache()


def check_moe_kernels(gen, results):
    """9d: each kernel at the shapes the MoE path gives it, against its
    plain version, with its time, the plain version's, one library call's
    and its bound, summed over a decode step (or a prefill) of the dense
    mixture, which runs every expert on every row: K1 at M = 1 and 8 on
    Mixtral-8x7B's expert products (4096 × 14336 and 14336 × 4096, 512 and
    256 launches a token) and on Grok-1's (6144 × 32768 and 32768 × 6144,
    1024 and 512); K2 at M = 1975 on Mixtral's (a 1975-token prefill); the
    attention cases of :func:`_moe_attention`. Recorded under
    ``moe_<kernel>`` and, where phase 3 ran, among that kernel's cases."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    zoo = {"K1": {}}
    for what, shapes in (("mixtral-8x7b", MIX_EXPERT_PROJ),
                         ("grok-1", GROK_EXPERT_PROJ)):
        for M in (1, 8):
            label = f"{what} experts, dense mixture, q4_j " + \
                ("decode step" if M == 1 else "batch-8 step")
            zoo["K1"][label] = _case(gen, label, PRESETS["q4_j"], M, shapes,
                                     k1, p1, "qmm4_npack", BF16_FLOPS)
            torch.cuda.empty_cache()
    agg, _ = _k2_shapes(gen, MIX_EXPERT_PROJ)
    n = sum(count for _, _, count in MIX_EXPERT_PROJ)
    label = "mixtral-8x7b experts, dense mixture, 1975-token prefill"
    zoo["K2"] = {label: dict(agg, bound_by="operations",
                             per=f"{label} ({n} launches)")}
    torch.cuda.empty_cache()
    _moe_attention(gen, zoo)
    for key, cases in zoo.items():
        results[f"moe_{key}"] = dict(next(iter(cases.values())), cases=cases)
        if key in results:
            results[key]["cases"].update(cases)
    return {f"9d {k} {label}": {m: c[m] for m in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
        for k, cases in zoo.items() for label, c in cases.items()}


def _moe_step_launches(params, cfg):
    """The launches and routes one captured decode step of the full model
    records (batch 1, fill 128): every product of the dense mixture on K1
    (``MIX_STEP_K1`` launches, the attention's fused q/k/v and wo among
    them) and ``moe_mixture`` once a layer; and those of one 1975-token
    prefill: the experts' and the attention's products on K2, the
    lm_head's one row on K1."""
    token = torch.full((1, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((1,), 128, dtype=torch.long, device=DEV)
    with torch.inference_mode():
        g = _StepGraph(params, token, pos, init_cache(cfg, 1, S_CACHE,
                                                      device=DEV))
    step = dict(g.launches)
    del g
    k1 = step.get("qmm4_npack", 0) + step.get("qmm4_npack_fused", 0)
    if k1 != MIX_STEP_K1 or step.get("moe_mixture") != cfg.n_layers:
        raise AssertionError(f"mixtral decode step launches {step}: K1 "
                             f"{k1}, expected {MIX_STEP_K1}")
    tokens = torch.randint(3, V, (1, T_PREFILL), device=DEV)
    run_path("mixtral_prefill_launches", ("qmm_a8", "flash_prefill"),
             lambda: prefill_step(params, tokens,
                                  torch.zeros(1, dtype=torch.long,
                                              device=DEV),
                                  init_cache(cfg, 1, S_CACHE, device=DEV)))
    pre = {k: n for k, n in LAUNCHES["mixtral_prefill_launches"].items()
           if n}
    if pre.get("qmm_a8") != MIX_PREFILL_K2 or \
            pre.get("qmm4_npack", 0) + pre.get("qmm4_npack_fused", 0) != 1:
        raise AssertionError(f"mixtral prefill launches {pre}")
    log(f"mixtral decode step (captured, fill 128) launches "
        f"{ {k: n for k, n in step.items() if n} }; 1975-token prefill "
        f"launches {pre}")
    return step, pre


def moe_full():
    """9a: Mixtral-8x7B at full width and depth, q4_j, random weights from
    seed 0: ``Model.generate`` with bf16 and int8 KV, the launches and
    routes of a decode step and a prefill, decode ms/token at fills 128
    and 1975 on the device's clock (the captured step replayed) beside the
    host slope, TTFT at 1975 tokens, the batch-8 paged int8
    ``ModelServer`` over phase 6's 12 queries, peak memory."""
    cfg = MIXTRAL_CFG
    params = _init_full(cfg, "mixtral")
    _generate_paths(params, cfg, "mixtral", (("bf16", MOE_GEN),
                                             ("int8", MOE_GEN_INT8)))
    res = {}
    step, pre = _moe_step_launches(params, cfg)
    res["mixtral_step_k1_launches"] = step.get("qmm4_npack", 0) + \
        step.get("qmm4_npack_fused", 0)
    res["mixtral_prefill_k2_launches"] = pre["qmm_a8"]
    for fill in (128, T_PREFILL):
        dev_ms = run_path(f"mixtral_step_graph_fill{fill}",
                          ("qmm4_npack", "flash_decode"),
                          lambda: graph_step_ms(params, cfg, fill))
        host_ms = decode_ms(params, fill, cfg=cfg)
        res[f"mixtral_decode_device_ms_fill{fill}"] = dev_ms
        res[f"mixtral_decode_ms_fill{fill}"] = host_ms
        log(f"mixtral decode at fill {fill}, batch 1, bf16 KV: "
            f"{dev_ms:.3f} ms/token on the device's clock (step graph "
            f"replay, median of 20), {host_ms:.3f} ms/token host slope "
            f"(n=4..36)")
    ms = run_path("mixtral_prefill_1975", ("qmm_a8", "flash_prefill"),
                  lambda: ttft_ms(params, cfg=cfg))
    res["mixtral_ttft_1975_ms"] = ms
    log(f"mixtral TTFT 1975-token prefill (last-row logits, bf16 KV): "
        f"{ms:.2f} ms")
    res.update({f"mixtral_server_{k}": v for k, v in _server_timed(
        params, cfg, "mixtral_server_paged_int8", MOE_SERVE_I8,
        _server_prompts()).items()})
    res["mixtral_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"mixtral peak device memory {res['mixtral_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


def _grouped_sched(card, cfg2):
    """The same 8 requests (prompts of 40-120 tokens, 6 new each) through
    a paged bf16 Scheduler on a copy with bf16 experts: its batch-8 decode
    step captured in a CUDA graph (the grouped path's static form,
    counted as ``moe_grouped_static``), and the same step run eagerly with
    the static form forced (the prefill chunks eager in both): equal ids
    and pool bytes."""
    gen = torch.Generator().manual_seed(93)
    lens = torch.randint(40, 120, (8,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    runs = []
    grouped = TRANSFORMER.moe_grouped
    for graph in (True, False):
        sched = Scheduler(card, cfg2, max_batch=8, max_len=256,
                          kv_mode="paged", page_size=64,
                          kv_dtype=torch.bfloat16,
                          sampling=SamplingParams(greedy=True,
                                                  repeat_penalty=1.0))
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=6)
        if graph:
            done = run_path("mixtral_bf16_experts_sched_graph",
                            ("moe_grouped_static", "moe_grouped",
                             "paged_decode"), sched.run_to_completion)
        else:
            # the decode steps in the static form, the prefill chunks in
            # the eager form, as the graphed run computes them
            sched._graphs = None
            TRANSFORMER.moe_grouped = lambda x, *a, **kw: grouped(
                x, *a, **{**kw, "static": x.shape[1] == 1})
            try:
                done = sched.run_to_completion()
            finally:
                TRANSFORMER.moe_grouped = grouped
        runs.append(({q.request_id: q.output_ids for q in done},
                     sched.cache))
    (ids_g, pool_g), (ids_e, pool_e) = runs
    if ids_g != ids_e:
        raise AssertionError(f"graphed grouped steps {ids_g} != eager "
                             f"{ids_e}")
    for name in ("k", "v"):
        if not torch.equal(getattr(pool_g, name)[:, :-1],
                           getattr(pool_e, name)[:, :-1]):
            raise AssertionError(f"graphed grouped steps wrote another "
                                 f"{name} pool")
    log(f"mixtral bf16 experts: the Scheduler's batch-8 decode step (CUDA "
        f"graph, grouped path's static form "
        f"{LAUNCHES['mixtral_bf16_experts_sched_graph']['moe_grouped_static']}"
        f" layer calls) = eager static steps: ids and pool bytes equal over "
        f"8 requests (prompts {lens})")


def moe_copies():
    """9b: two-layer full-width copies of Mixtral-8x7B and Grok-1 at q4_j
    (Grok-1 at full depth is over 150 GB at int4): ``Model.generate`` on
    the card (a path each, 100-token prompt), then the prefill's last
    logits and ``MOE_STEPS`` steps fed the card's ids against the plain
    path on the card's own tensors (``plain_on_card``; on the host's CPU
    one Grok-1 layer dequantized to f32 is ~19 GB), greedy ids held where
    the margins prove them; (9c) on the Mixtral copy, phase 5's paged int8
    Scheduler check, its plain side on the card too; then a bf16-expert
    Mixtral copy through the grouped path: a prefill against the plain
    path the same way, and the Scheduler's captured batch-8 step."""
    gen = torch.Generator().manual_seed(90)
    res = {}
    for i, (what, cfg_full, required) in enumerate(MOE_COPIES):
        t = time.time()
        cfg2 = dataclasses.replace(cfg_full, n_layers=MOE_LAYERS)
        card = init_random(cfg2, seed=91 + i, quant="q4_j", device=DEV)
        ids = torch.randint(3, V, (100,), generator=gen).tolist()
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{what}", required, lambda: model.generate(
            ids, max_new_tokens=MOE_STEPS + 1, do_sample=False,
            stop_at_eos=False, repetition_penalty=1.0)[0])[len(ids):]
        _check_ids(new, MOE_STEPS + 1, f"card {what}", cfg2.vocab_size)
        if LAUNCHES[f"card_{what}"]["moe_mixture"] == 0:
            raise AssertionError(f"{what}: no layer took the dense mixture")
        rows = _step_rows(card, cfg2, ids, new[:MOE_STEPS])
        with plain_on_card():
            plain = _step_rows(card, cfg2, ids, new[:MOE_STEPS])
        worst, provable, _ = _compare_rows(rows, plain, MOE_TOL,
                                           f"{what} card vs plain")
        log(f"9b {what} card vs plain on the card ({MOE_LAYERS} layers, full "
            f"width, q4_j, {cfg2.n_heads} heads over {cfg2.n_kv_heads}, "
            f"softcap {cfg2.attn_softcap:g}, 100-token prompt, fed the "
            f"card's ids {new}): logits max err {worst:.3g}·max|logit| (tol "
            f"{MOE_TOL}); argmax provably comparable at {provable} of "
            f"{MOE_STEPS + 1} steps, equal at all of them; "
            f"{time.time() - t:.1f} s")
        if provable < 2:
            raise AssertionError(f"too few {what} steps with a margin wide "
                                 "enough to compare the argmax")
        res[f"moe_{what}_card_vs_plain_rel_err"] = worst
        if what == "mixtral":
            res["moe_mixtral_sched_card_vs_plain_rel_err"] = \
                _sched_card_vs_plain(card, cfg2, MOE_TOL)
        del card, model
        torch.cuda.empty_cache()
    t = time.time()
    cfg2 = dataclasses.replace(MIXTRAL_CFG, n_layers=MOE_LAYERS)
    card = init_random(cfg2, seed=94, quant=None, device=DEV)
    ids = torch.randint(3, V, (100,), generator=gen).tolist()
    rows = run_path("mixtral_bf16_experts_prefill", ("moe_grouped",),
                    lambda: _step_rows(card, cfg2, ids, [5, 6, 7]))
    with plain_on_card():
        plain = _step_rows(card, cfg2, ids, [5, 6, 7])
    worst, _, _ = _compare_rows(rows, plain, MOE_TOL,
                                "mixtral bf16 experts card vs plain")
    res["moe_mixtral_bf16_experts_card_vs_plain_rel_err"] = worst
    _grouped_sched(card, cfg2)
    log(f"9b mixtral bf16 experts ({MOE_LAYERS} layers): the grouped path's "
        f"prefill and decode steps against the plain path on the card "
        f"{worst:.3g}·max|logit|; {time.time() - t:.1f} s")
    del card
    torch.cuda.empty_cache()
    return res


def phase_moe(results):
    """Phase 9: 9d the kernels at the MoE's shapes, 9a Mixtral-8x7B at full
    depth, 9b/9c the two-layer copies of Mixtral-8x7B and Grok-1."""
    t = time.time()
    gen = torch.Generator(device=DEV).manual_seed(9)
    res = {"9d": check_moe_kernels(gen, results)}
    log(f"phase 9d: {time.time() - t:.1f} s")
    t = time.time()
    res.update(moe_full())
    log(f"phase 9a: {time.time() - t:.1f} s")
    t = time.time()
    res.update(moe_copies())
    log(f"phase 9b/9c: {time.time() - t:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 10: tensor and expert parallelism, two ranks sharing the one card
# ---------------------------------------------------------------------------


# Llama-2-7B's products on one rank at tp = 2 (q/k/v and gate/up split by
# columns, wo and w_down by rows; the FFN padded to 11264): per token
TP2_PROJ = [(D, D // 2, 3 * L), (D // 2, D, L), (D, I_PAD // 2, 2 * L),
            (I_PAD // 2, D, L)]
TP2_LM_HEAD = [(D, V // 2, 1)]
# Llama-2-70B (meta-llama/Llama-2-70b-hf config.json: hidden 8192, FFN
# 28672, 80 layers, 64 q heads over 8 kv heads of 128, vocab 32000): the
# products of one rank of BASELINE.md target 5 at tp = 8, per token
L70 = 80
TP8_70B_PROJ = [(8192, 1024, L70), (8192, 128, 2 * L70), (1024, 8192, L70),
                (8192, 3584, 2 * L70), (3584, 8192, L70)]
TP8_70B_LM_HEAD = [(8192, V // 8, 1)]
LLAMA70_CFG = ModelConfig(arch="llama", vocab_size=V, hidden_size=8192,
                          n_layers=2, n_heads=64, n_kv_heads=8, head_dim=128,
                          intermediate_size=28672, norm_eps=1e-5,
                          rope_theta=10000.0, max_seq_len=4096)
PAR_TOL = 2e-2          # phase 8c's, of max|logit| (bf16 activations)
PAR_TIMEOUT = 300.0     # s a rank's rendezvous or collective may wait
PAR_DEADLINE = 900.0    # s for both ranks' whole run
PAR_PROMPT_70B = 512    # tokens of 10b's prompt (K2's rows: M >= 256)
PAR_NEW = 8             # new tokens of 10a's Model.generate
# 10a's depth sweep: the 7B's first n layers at full width, tp = 2 against
# the plain single device (3 steps a depth, teacher-forced on fixed ids)
PAR_DEPTHS = (2, 4, 8)
PAR_SWEEP_FEED = 3
SHARED_CARD = ("two ranks sharing one H100 under gloo: not a measure of "
               "tensor parallelism across cards")


def _tp_attention(gen, cases):
    """10d's attention cases at one rank's 16 of the 7B's 32 heads: K3 on
    the 1975-token prompt and K4 at fill 1975, bf16 and int8 KV."""
    Hq = Hkv = H // 2
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    for int8 in (False, True):
        s = "_i8" if int8 else ""
        row = DH + 2 if int8 else 2 * DH
        T = T_PREFILL
        q = (torch.randn((1, T, Hq, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (1, Hkv, S_CACHE, DH), int8)[0]
        a3 = (q, c[0], c[1], *(c[2:] if int8 else ()), starts, DH ** -0.5)
        kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
        qh = q.transpose(1, 2)
        label = f"llama-2-7b tp=2 rank heads ({Hq} over {Hkv}) {T}-token " \
            "prefill"
        cases.setdefault("K3" + s, {})[label] = _attn_case(
            label, "flash_prefill" + s,
            lambda: (A.flash_prefill_i8 if int8 else A.flash_prefill)(*a3),
            lambda: (A.flash_prefill_i8_plain if int8
                     else A.flash_prefill_plain)(*a3),
            T * Hq * DH * 2 + 2 * T * Hkv * row + T * Hq * DH * 4,
            _attn_ops(int8, DH, Hq, _pairs(T, 0), False, False),
            I8_PREFILL_TOL if int8 else BF16_TOL, L,
            library=[lambda: _sdpa(qh, kd, vd, is_causal=True)])
        del q, qh, c, a3, kd, vd
        fill = T_PREFILL
        q = (torch.randn((1, Hq, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        caches = _attn_cache(gen, (1, Hkv, S_CACHE, DH), int8,
                             _copies(2 * fill * Hkv * row))
        lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
        args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                 DH ** -0.5) for c in caches]
        kvs = [_bf16_kv(c) for c in caches]
        fn = A.flash_decode_i8 if int8 else A.flash_decode
        label = f"llama-2-7b tp=2 rank heads ({Hq} over {Hkv}) decode fill " \
            f"{fill}"
        cases.setdefault("K4" + s, {})[label] = _attn_case(
            label, "flash_decode" + s, lambda: fn(*args[0]),
            lambda: (A.flash_decode_i8_plain if int8
                     else A.flash_decode_plain)(*args[0]),
            2 * fill * Hkv * row + Hq * DH * (2 + 4),
            _attn_ops(int8, DH, Hq, fill, False, True),
            I8_DECODE_TOL if int8 else BF16_TOL, L,
            runs=[lambda a=a: fn(*a) for a in args],
            library=[lambda kv=kv: _sdpa(q[:, :, None], kv[0][:, :, :fill],
                                         kv[1][:, :, :fill]) for kv in kvs])
        del q, caches, args, kvs
        torch.cuda.empty_cache()


def check_parallel_kernels(gen, results):
    """10d: each kernel at the shapes one rank of a tensor-parallel model
    gives it, against its plain version, with its time, the plain
    version's, one library call's and its bound, summed over a decode step
    or a prefill: K1 at M = 1 and 8 on the 7B's tp = 2 products (q/k/v
    4096 × 2048, wo 2048 × 4096, gate/up 4096 × 5632, down 5632 × 4096,
    the lm_head's 4096 × 16000 vocabulary slice), K2 at M = 1975 on them;
    K1 at M = 1 and K2 at M = 1975 on Llama-2-70B's tp = 8 products (wq
    8192 × 1024, wk/wv 8192 × 128, wo 1024 × 8192, gate/up 8192 × 3584,
    down 3584 × 8192, the lm_head's 8192 × 4000): what each rank of
    BASELINE.md target 5 runs on its own card; K3 and K4 at 16 heads, bf16
    and int8 KV. Recorded under ``tp_<kernel>`` and among that kernel's
    cases."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    cases = {"K1": {}, "K2": {}}
    for what, proj, head, ms in (
            ("llama-2-7b tp=2", TP2_PROJ, TP2_LM_HEAD, (1, 8)),
            ("llama-2-70b tp=8", TP8_70B_PROJ, TP8_70B_LM_HEAD, (1,))):
        for M in ms:
            label = f"{what} rank, q4_j " + \
                ("decode step" if M == 1 else "batch-8 step")
            cases["K1"][label] = _case(
                gen, label, PRESETS["q4_j"], M, proj + head, k1, p1,
                "qmm4_npack", BF16_FLOPS, vocab=head[0][1])
            torch.cuda.empty_cache()
        agg, _ = _k2_shapes(gen, proj)
        n = sum(count for _, _, count in proj)
        label = f"{what} rank, 1975-token prefill"
        cases["K2"][label] = dict(agg, bound_by="operations",
                                  per=f"{label} ({n} launches)")
        torch.cuda.empty_cache()
    _tp_attention(gen, cases)
    for key, cs in cases.items():
        results[f"tp_{key}"] = dict(next(iter(cs.values())), cases=cs)
        if key in results:
            results[key]["cases"].update(cs)
    return {f"10d {k} {label}": {m: c[m] for m in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
        for k, cs in cases.items() for label, c in cs.items()}


def _par_rows(model, cache, prompt, feed, counts=None, what=""):
    """The prefill's last logits row and one decode step's per id of
    ``feed`` (f32, on the CPU), into ``cache``; with ``counts``, the
    launches of the prefill and of the first step, each counted from 0
    (``counts[what + " prefill"]``, ``counts[what + " step"]``)."""
    zero = torch.zeros(1, dtype=torch.long, device=DEV)
    T = prompt.shape[1]
    if counts is not None:
        _cuda.reset_launches()
    rows = [prefill_step(model, prompt, zero, cache)[0, -1].float().cpu()]
    if counts is not None:
        counts[what + " prefill"] = _cuda.launch_counts()
        _cuda.reset_launches()
    for i, t in enumerate(feed):
        logits = model_step(model, torch.tensor([[t]], device=DEV),
                            torch.tensor([T + i], device=DEV), cache)
        rows.append(logits[0, -1].float().cpu())
        if counts is not None and i == 0:
            counts[what + " step"] = _cuda.launch_counts()
    return rows


def _par_feed(rows, n):
    """The argmax of each of the first ``n`` rows: the ids a greedy run of
    the model that gave ``rows`` would feed."""
    return [int(r.argmax()) for r in rows[:n]]


class _TwoRanks(torch.nn.Module):
    """A projection on one device as a tp = 2 pair computes it: the
    weight's two shards (``parallel.sharding.shard_params``, split as
    ``name`` is in the split table), each multiplied by the kernel a rank
    runs at the rank's shape; a row split's two partials in f32, summed
    and rounded once, a column split's halves side by side."""

    def __init__(self, name, qt):
        from neural_tpu_torch.parallel import Mesh, shard_params
        super().__init__()
        self.row = name in ("wo", "w_down")
        one = {"layers": [{name: qt}]}
        self.halves = [shard_params(one, CFG, Mesh(
            {"dp": 1, "tp": 2}, r, {}, None, qt.planes[0].device))[
            "layers"][0][name] for r in range(2)]

    def forward(self, x, out_dtype=None):
        out_dtype = out_dtype or x.dtype
        if not self.row:
            return torch.cat([TRANSFORMER.linear(x, h, out_dtype)
                              for h in self.halves], dim=-1)
        K = x.shape[-1] // 2
        y = [TRANSFORMER.linear(x[..., r * K:(r + 1) * K].contiguous(), h,
                                torch.float32)
             for r, h in enumerate(self.halves)]
        return (y[0] + y[1]).to(out_dtype)


def _attend_two_ranks(attend):
    """``attend`` over each half of the heads apart, as each rank of a
    tp = 2 pair runs it on its own heads, the outputs side by side."""
    def run(q, k, v, positions, cfg, k_scale=None, v_scale=None, **kw):
        hq, hk = q.shape[2] // 2, k.shape[1] // 2
        half = lambda t, r, h: None if t is None else \
            t[:, r * h:(r + 1) * h].contiguous()
        return torch.cat([attend(
            q[:, :, r * hq:(r + 1) * hq].contiguous(), half(k, r, hk),
            half(v, r, hk), positions, cfg, half(k_scale, r, hk),
            half(v_scale, r, hk), **kw) for r in range(2)], dim=-1)
    return run


@contextlib.contextmanager
def _as_two_ranks(model):
    """The unsharded ``model`` computing what a tp = 2 pair computes, on
    one device: every projection and the lm_head a :class:`_TwoRanks`, the
    attention over each half of the heads apart (unfused: the fused
    kernels read the whole weight)."""
    saved = [(blk, n, getattr(blk, n)) for blk in model.layers
             for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    saved.append((model, "lm_head", model.lm_head))
    attend = TRANSFORMER.attend
    for mod, n, lin in saved:
        setattr(mod, n, _TwoRanks(n if mod is not model else "wq", lin.qt))
    TRANSFORMER.attend = _attend_two_ranks(attend)
    try:
        with fusion(UNFUSED):
            yield model
    finally:
        TRANSFORMER.attend = attend
        for mod, n, lin in saved:
            setattr(mod, n, lin)


def _apart(a, b):
    """max|a - b| over max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def _par_7b_refs(whole, m, ids, prompt, got, tp_rows, kv, kvdt):
    """10a's references on rank 0, one device: the two ranks' rows (the
    prefill's last and one a step, fed the TP ids) held bit for bit to the
    unsharded model computing each product and attention as the pair does
    (:func:`_as_two_ranks`), and within ``PAR_TOL`` of it; how far both
    move from the plain single device (a random 7B magnifies any
    reordered f32 sum with depth); the greedy ids against the single
    device's ``Model.generate`` where the margins prove them."""
    want = m.generate(ids, max_new_tokens=PAR_NEW, repetition_penalty=1.0,
                      kv_dtype=kv)[0][T_PREFILL:]
    cache = lambda: init_cache(CFG, 1, S_CACHE, kvdt, device=DEV)
    plain = _par_rows(whole, cache(), prompt.to(DEV), got[:-1])
    with _as_two_ranks(whole):
        pair = _par_rows(whole, cache(), prompt.to(DEV), got[:-1])
    log(f"10a tp=2 against one device computing the pair's products, {kv} "
        "KV, the prefill's last row and a step per TP id:")
    worst, provable, _ = _compare_rows(tp_rows, pair, PAR_TOL, f"10a {kv}")
    apart = [i for i, (a, b) in enumerate(zip(tp_rows, pair))
             if not torch.equal(a, b)]
    if apart:
        raise AssertionError(f"10a {kv} KV: the two ranks' rows {apart} "
                             "differ from one device's computing the same "
                             "products")
    proven = _proven_equal(got, want, plain, tp_rows, None,
                           f"10a Model.generate {kv} KV")
    return {f"single_{kv}": want, f"worst_{kv}": worst,
            f"provable_{kv}": provable, f"proven_{kv}": proven,
            f"tp_from_plain_{kv}": max(_apart(a, b) for a, b in zip(
                tp_rows, plain)),
            f"pair_from_plain_{kv}": max(_apart(a, b) for a, b in zip(
                pair, plain))}


def _par_depths(rank, mesh, whole, prompt):
    """10a's witness against the plain single device that does not lean on
    the pair's own split (``_as_two_ranks``): the 7B's first n layers
    (``PAR_DEPTHS``) at full width, tp = 2 against one device on the same
    card, the prefill's last row and ``PAR_SWEEP_FEED`` steps teacher-forced
    on fixed ids. Rank 0 records the gap max|tp - one|/max|one| a depth and
    holds the shallowest to ``PAR_TOL``, its argmax equal where the margins
    prove it."""
    from neural_tpu_torch.models.transformer import Transformer
    from neural_tpu_torch.parallel import shard_model
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    pd = whole.param_dict()
    feed = torch.randint(3, V, (PAR_SWEEP_FEED,),
                         generator=torch.Generator().manual_seed(13)).tolist()
    out = {}
    for n in PAR_DEPTHS:
        cfg = dataclasses.replace(CFG, n_layers=n)
        cut = dict(pd, layers=pd["layers"][:n])
        sm = shard_model(cut, cfg, mesh)
        tp_rows = _par_rows(sm, pinit(cfg, mesh, 1, S_CACHE), prompt, feed)
        out[f"rows_{n}"] = torch.stack(tp_rows)
        if rank == 0:
            one = _par_rows(Transformer(cfg, cut), init_cache(
                cfg, 1, S_CACHE, device=DEV), prompt, feed)
            out[f"gap_{n}"] = max(_apart(a, b) for a, b in zip(tp_rows, one))
            if n == PAR_DEPTHS[0]:
                log(f"10a depth sweep, the 7B's first {n} layers tp=2 "
                    "against the plain single device, the prefill's last "
                    f"row and {PAR_SWEEP_FEED} steps:")
                out["worst"], out["provable"], _ = _compare_rows(
                    tp_rows, one, PAR_TOL, f"10a {n} layers")
        del sm
        torch.cuda.empty_cache()
    return out


def _par_7b(rank, mesh, counts):
    """10a on one rank: Llama-2-7B q4_j at full width and depth, tp = 2."""
    from neural_tpu_torch.parallel import agree, checksum, shard_model
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    out = {}
    whole = init_random(CFG, seed=0, quant="q4_j", device=DEV)
    out["checksum"] = checksum(whole.param_dict())
    # both ranks hold the same full weights before either keeps its shard
    agree(out["checksum"], "the 7B's weights")
    m = Model().init_params(whole, CFG)
    sm = shard_model(whole, CFG, mesh)
    gen = torch.Generator().manual_seed(10)
    prompt = torch.randint(3, V, (1, T_PREFILL), generator=gen)
    ids = prompt[0].tolist()
    for kv, kvdt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        _cuda.reset_launches()
        t = time.time()
        got = m.generate(ids, max_new_tokens=PAR_NEW, repetition_penalty=1.0,
                         kv_dtype=kv, mesh=mesh)[0][T_PREFILL:]
        torch.cuda.synchronize()
        counts[f"10a tp=2 Model.generate {kv} KV"] = _cuda.launch_counts()
        out[f"generate_{kv}_s"] = time.time() - t
        out[f"ids_{kv}"] = got
        cache = pinit(CFG, mesh, 1, S_CACHE, kvdt)
        # teacher-forced on the TP ids, so the rows of both runs read the
        # same context up to the first parting
        tp_rows = _par_rows(sm, cache, prompt.to(DEV), got[:-1],
                            counts if kv == "bf16" else None, "10a tp=2")
        out[f"tp_rows_{kv}"] = torch.stack(tp_rows)
        if rank == 0:
            out.update(_par_7b_refs(whole, m, ids, prompt, got, tp_rows, kv,
                                    kvdt))
    out["sweep"] = _par_depths(rank, mesh, whole, prompt.to(DEV))
    # the eager TP decode step's time on the host clock (not a measure of
    # tensor parallelism across cards: the two ranks share the card)
    cache = pinit(CFG, mesh, 1, S_CACHE)
    tok, fill = torch.tensor([[17]], device=DEV), S_CACHE // 16
    model_step(sm, tok, torch.tensor([fill], device=DEV), cache)
    torch.cuda.synchronize()
    t = time.time()
    for i in range(8):
        model_step(sm, tok, torch.tensor([fill + 1 + i], device=DEV), cache)
    torch.cuda.synchronize()
    out["step_ms_shared_card"] = (time.time() - t) / 8 * 1e3
    out["shapes"] = {n: tuple(getattr(sm.layers[0], n).qt.planes[0].shape)
                     for n in ("wq", "wk", "wo", "w_up", "w_down")}
    out["lm_head_shape"] = tuple(sm.lm_head.qt.planes[0].shape)
    del m, whole, sm, cache
    return out


def _par_70b(rank, mesh, counts):
    """10b on one rank: Llama-2-70B's widths, two layers, q4_j, tp = 2."""
    from neural_tpu_torch.parallel import agree, checksum, shard_model
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    cfg = LLAMA70_CFG
    out = {}
    whole = init_random(cfg, seed=0, quant="q4_j", device=DEV)
    ck = checksum(whole.param_dict())
    agree(ck, "the 70B-width copy's weights")
    sm = shard_model(whole, cfg, mesh)
    out["shapes"] = {n: tuple(getattr(sm.layers[0], n).qt.planes[0].shape)
                     for n in ("wq", "wk", "wv", "wo", "w_up", "w_down")}
    out["scales"] = {n: tuple(getattr(sm.layers[0], n).qt.scales.shape)
                     for n in ("wk", "w_down")}
    out["lm_head_shape"] = tuple(sm.lm_head.qt.planes[0].shape)
    gen = torch.Generator().manual_seed(11)
    prompt = torch.randint(3, V, (1, PAR_PROMPT_70B), generator=gen).to(DEV)
    feed = _par_feed(_par_rows(sm, pinit(cfg, mesh, 1, 1024), prompt, []),
                     1)
    tp_rows = _par_rows(sm, pinit(cfg, mesh, 1, 1024), prompt, feed, counts,
                        "10b 70b-width tp=2")
    out["tp_rows"] = torch.stack(tp_rows)
    if rank == 0:
        single = _par_rows(whole, init_cache(cfg, 1, 1024, device=DEV),
                           prompt, feed)
        log("10b 70B-width copy tp=2 against one device, the prefill's "
            "last row and one step:")
        out["worst"], out["provable"], out["argmax_equal"] = _compare_rows(
            tp_rows, single, PAR_TOL, "10b")
    del whole, sm
    return out


def _par_mixtral(rank, meshes, counts):
    """10c on one rank: the two-layer full-width Mixtral-8x7B copy, q4_j
    experts, at tp = 2 (the mixture's deferred sum) and at ep = 2 with
    capacity factor E (nothing dropped)."""
    from neural_tpu_torch.parallel import agree, checksum, shard_model
    from neural_tpu_torch.parallel.sharding import init_cache as pinit
    cfg = dataclasses.replace(MIXTRAL_CFG, n_layers=MOE_LAYERS)
    out = {}
    whole = init_random(cfg, seed=0, quant="q4_j", device=DEV)
    agree(checksum(whole.param_dict()), "the Mixtral copy's weights")
    gen = torch.Generator().manual_seed(12)
    prompt = torch.randint(3, V, (1, T_PREFILL), generator=gen).to(DEV)
    for what, mesh in meshes.items():
        sm = shard_model(whole, cfg, mesh,
                         capacity_factor=float(cfg.n_experts))
        feed = _par_feed(_par_rows(sm, pinit(cfg, mesh, 1, S_CACHE), prompt,
                                   []), 1)
        tp_rows = _par_rows(sm, pinit(cfg, mesh, 1, S_CACHE), prompt, feed,
                            counts, f"10c mixtral {what}")
        out[f"rows_{what}"] = torch.stack(tp_rows)
        if rank == 0:
            single = _par_rows(whole, init_cache(cfg, 1, S_CACHE,
                                                 device=DEV), prompt, feed)
            log(f"10c Mixtral copy {what} against one device, the "
                "1975-token prefill's last row and one step:")
            out[f"worst_{what}"], out[f"provable_{what}"], _ = \
                _compare_rows(tp_rows, single, PAR_TOL, f"10c {what}")
        del sm
        torch.cuda.empty_cache()
    del whole
    return out


def _par_rank(rank, port, q, legs):
    """One rank of phases 10 and 11: the process group over 127.0.0.1
    (gloo), both ranks on cuda:0, the kernels the parent built, then each
    phase of ``legs`` in order ("10": 10a-10c; "11": 11b-11d); each
    phase's results (and each path's launch counts) go back to the parent
    through ``q`` as soon as they are ready. A failure is put on ``q`` and
    re-raised."""
    import traceback
    leg = None
    try:
        import torch.distributed as dist
        from neural_tpu_torch.parallel import init_distributed, make_mesh
        torch.cuda.set_device(0)
        os.environ.setdefault("NTPU_FUSED_DECODE", "1")
        torch.backends.cuda.matmul.allow_tf32 = False
        for k in _cuda.KERNELS:
            k.load()
        init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                         timeout=PAR_TIMEOUT)
        for leg in legs:
            torch.cuda.reset_peak_memory_stats()
            if leg == "10":
                tp2 = make_mesh(dp=1, tp=2, device=DEV)
                ep2 = make_mesh(dp=1, ep=2, device=DEV)
                parts = (("10a", _par_7b, tp2), ("10b", _par_70b, tp2),
                         ("10c", _par_mixtral, {"tp=2": tp2, "ep=2": ep2}))
            else:
                parts = (
                    ("11b", _p11_sp, make_mesh(dp=1, sp=2, device=DEV)),
                    ("11c", _p11_pp, make_mesh(dp=1, pp=2, device=DEV)),
                    ("11d", _p11_moe, {
                        "sp=2": make_mesh(dp=1, sp=2, ep=1, device=DEV),
                        "ep=2": make_mesh(dp=1, sp=1, ep=2, device=DEV)}))
            counts, out, secs = {}, {}, {}
            for key, fn, arg in parts:
                t = time.time()
                out[key] = fn(rank, arg, counts)
                secs[key] = time.time() - t
                torch.cuda.empty_cache()
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            # numpy, pickled by value: a tensor on the queue is shared
            # through this process, which may have exited when the parent
            # reads it
            q.put((rank, leg, _to_numpy(dict(out, counts=counts,
                                             seconds=secs)), None))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, leg, None, traceback.format_exc()))
        raise


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree


class _Ranks:
    """The two spawned ranks of phases 10 and 11 (:func:`_par_rank`), run
    once for both phases in the full run: each phase reads its results with
    :meth:`gather` as the ranks deliver them; a rank that fails or outlives
    the deadline fails the phase (the ranks are killed)."""

    def __init__(self, legs):
        import socket
        import torch.multiprocessing as mp
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.legs = tuple(legs)
        self.procs = [ctx.Process(target=_par_rank,
                                  args=(r, port, self.q, self.legs),
                                  daemon=True) for r in range(2)]
        for p in self.procs:
            p.start()
        self.got = {}
        self.end = time.time() + PAR_DEADLINE * len(self.legs)

    def gather(self, leg):
        import queue as _queue
        errs = []
        while len(self.got.get(leg, {})) < 2 and time.time() < self.end:
            try:
                r, lg, res, err = self.q.get(timeout=5)
            except _queue.Empty:
                if not any(p.is_alive() for p in self.procs):
                    break
                continue
            if err:
                errs.append(f"rank {r}, phase {lg}:\n{err}")
                break
            self.got.setdefault(lg, {})[r] = res
        outs = self.got.get(leg, {})
        if errs or len(outs) < 2:
            self.close()
            raise AssertionError(f"phase {leg} ranks: " + ("\n".join(errs) or (
                f"only ranks {sorted(outs)} reported within the deadline; "
                f"exit codes {[p.exitcode for p in self.procs]}")))
        if leg == self.legs[-1]:
            self.close()
        return outs

    def close(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


# the ranks of phases 10 and 11 in the full run, spawned by phase 10
_RANKS = {}


def _ranks(leg):
    """The ranks that run ``leg``: the full run's (spawned in phase 10 for
    phases 10 and 11), or a spawn of their own under ``--phase10`` /
    ``--phase11``."""
    if leg not in _RANKS:
        only = "--phase10" in sys.argv or "--phase11" in sys.argv
        r = _Ranks((leg,) if only else ("10", "11"))
        for lg in r.legs:
            _RANKS[lg] = r
    return _RANKS[leg]


# what each path must launch: (path suffix, required entry points)
PAR_REQUIRED = (
    ("10a tp=2 Model.generate bf16 KV",
     ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")),
    ("10a tp=2 Model.generate int8 KV",
     ("qmm4_npack", "qmm_a8", "flash_prefill_i8", "flash_decode_i8")),
    ("10a tp=2 prefill", ("qmm_a8", "qmm4_npack", "flash_prefill")),
    ("10a tp=2 step", ("qmm4_npack", "flash_decode")),
    ("10b 70b-width tp=2 prefill", ("qmm_a8", "qmm4_npack", "flash_prefill")),
    ("10c mixtral tp=2 prefill", ("qmm_a8", "flash_prefill")),
    ("10c mixtral tp=2 step", ("qmm4_npack", "flash_decode")),
    ("10c mixtral ep=2 prefill", ("qmm_a8", "flash_prefill")),
    ("10c mixtral ep=2 step", ("qmm4_npack", "flash_decode")))


def _par_check_counts(rank, counts):
    """Every path's required kernels launched; a 7B TP step's and
    prefill's launches and collectives as the graph makes them."""
    for path, required in PAR_REQUIRED:
        c = counts[path]
        missing = [k for k in required if not c.get(k)]
        name = f"{path} rank {rank}"
        LAUNCHES[name] = c
        log(f"path {name}: launches "
            f"{ {k: n for k, n in c.items() if n} }")
        if missing:
            raise AssertionError(f"kernels not launched on path {name}: "
                                 f"{missing}")
    LAUNCHES[f"10b 70b-width tp=2 step rank {rank}"] = \
        counts["10b 70b-width tp=2 step"]
    step, pre = counts["10a tp=2 step"], counts["10a tp=2 prefill"]
    want_step = {"qmm4_npack": 7 * L + 1, "flash_decode": L,
                 "tp_all_reduce": 2 * L, "tp_all_gather": 1,
                 "qmm4_npack_fused": 0}
    want_pre = {"qmm_a8": 7 * L, "qmm4_npack": 1, "flash_prefill": L,
                "tp_all_reduce": 2 * L, "tp_all_gather": 1}
    for got, want, what in ((step, want_step, "step"),
                            (pre, want_pre, "prefill")):
        if any(got.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"10a tp=2 {what} rank {rank}: launches "
                                 f"{ {k: got.get(k, 0) for k in want} }, "
                                 f"expected {want}")


def phase_parallel(results):
    """Phase 10: 10d the kernels at one rank's shapes in this process, then
    two ranks spawned on the one card (gloo over 127.0.0.1) run 10a-10c."""
    t = time.time()
    gen = torch.Generator(device=DEV).manual_seed(10)
    res = {"10d": check_parallel_kernels(gen, results)}
    log(f"phase 10d: {time.time() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    outs = _ranks("10").gather("10")
    log(f"phase 10a-10c (both ranks): {time.time() - t:.1f} s; per rank "
        f"{ {r: o['seconds'] for r, o in outs.items()} }")
    for r, o in outs.items():
        _par_check_counts(r, o["counts"])
    r0, r1 = outs[0], outs[1]
    # tp: every rank holds the same summed and gathered logits, bit for
    # bit; ep: each rank's tokens come back from the experts' owners, which
    # ran them among the other rank's rows (the same rows: the tokens are
    # replicated), so the two agree within the tolerance
    for key, fields in (("10a", ("checksum", "ids_bf16", "ids_int8",
                                 "tp_rows_bf16", "tp_rows_int8")),
                        ("10b", ("tp_rows",)), ("10c", ("rows_tp=2",))):
        for f in fields:
            x, y = r0[key][f], r1[key][f]
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"{key}: the ranks differ in {f}")
    for n in PAR_DEPTHS:
        if not np.array_equal(r0["10a"]["sweep"][f"rows_{n}"],
                              r1["10a"]["sweep"][f"rows_{n}"]):
            raise AssertionError(f"10a sweep: the ranks differ at {n} layers")
    x, y = r0["10c"]["rows_ep=2"], r1["10c"]["rows_ep=2"]
    ep_apart = float(np.abs(x - y).max() / np.abs(x).max())
    if not ep_apart <= PAR_TOL:
        raise AssertionError(f"10c ep=2: the ranks' logits part by "
                             f"{ep_apart}·max|logit|")
    a, b, c = r0["10a"], r0["10b"], r0["10c"]
    # native-pack planes [K/2, N] of one rank's slices, and its scales
    # [K/128, N]: q/k/v and gate/up by columns, wo and w_down by rows
    for what, out, cfg in (("10a", a, CFG), ("10b", b, LLAMA70_CFG)):
        hid, ff = cfg.hidden_size, ffn_padded_size(cfg.intermediate_size)
        dq, dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        want = {"wq": (hid // 2, dq // 2), "wk": (hid // 2, dkv // 2),
                "wv": (hid // 2, dkv // 2), "wo": (dq // 4, hid),
                "w_up": (hid // 2, ff // 2), "w_down": (ff // 4, hid)}
        want = {n: want[n] for n in out["shapes"]}
        lm = (hid // 2, cfg.vocab_size // 2)
        log(f"{what} a rank's planes {out['shapes']}, lm_head "
            f"{out['lm_head_shape']}")
        if out["shapes"] != want or tuple(out["lm_head_shape"]) != lm:
            raise AssertionError(f"{what} shard shapes {out['shapes']}, "
                                 f"lm_head {out['lm_head_shape']}: expected "
                                 f"{want}, {lm}")
    hid, ff = LLAMA70_CFG.hidden_size, LLAMA70_CFG.intermediate_size
    dkv = LLAMA70_CFG.n_kv_heads * LLAMA70_CFG.head_dim
    if b["scales"] != {"wk": (hid // 128, dkv // 2),
                       "w_down": (ff // 2 // 128, hid)}:
        raise AssertionError(f"10b shard scales {b['scales']}")
    for kv in ("bf16", "int8"):
        log(f"10a Model.generate(mesh=tp2) {kv} KV: {a[f'ids_{kv}']}; one "
            f"device {a[f'single_{kv}']}; ids proven equal at "
            f"{a[f'proven_{kv}']} of {PAR_NEW} steps by the margins; "
            f"every row bit-equal to one device computing the pair's "
            f"products; from the plain single device the rows move up to "
            f"{a[f'tp_from_plain_{kv}']:.4g}·max|logit|, the one-device "
            f"pair's {a[f'pair_from_plain_{kv}']:.4g}; "
            f"{a[f'generate_{kv}_s']:.2f} s")
    sw = a["sweep"]
    gaps = {n: sw[f"gap_{n}"] for n in PAR_DEPTHS}
    gaps[L] = a["tp_from_plain_bf16"]
    log(f"10a tp=2 against the plain single device by depth (max|tp - one|"
        f" over max|one|; {L} layers: the full model's rows above): "
        f"{ {n: round(g, 5) for n, g in gaps.items()} }; at {PAR_DEPTHS[0]} "
        f"layers within {PAR_TOL}, the argmax proven at {sw['provable']} of "
        f"{PAR_SWEEP_FEED + 1} rows")
    log(f"10a eager tp=2 decode step, host clock: "
        f"{a['step_ms_shared_card']:.2f} ms ({SHARED_CARD})")
    log(f"10b 70B-width copy tp=2: logits within {b['worst']:.3g}·max|logit|"
        f", argmax equal at {b['argmax_equal']}, proven by the margins at "
        f"{b['provable']} of 2 rows")
    routes = {f"{w} {p}": {k: n for k, n in outs[0]["counts"][
        f"10c mixtral {w} {p}"].items() if n and k in (
        "qmm4_npack", "qmm_a8", "qmm_general", "qmm_plain",
        "ep_all_to_all", "tp_all_reduce", "moe_mixture")}
        for w in ("tp=2", "ep=2") for p in ("prefill", "step")}
    log(f"10c Mixtral copy: tp=2 within {c['worst_tp=2']:.3g}, ep=2 within "
        f"{c['worst_ep=2']:.3g}·max|logit|; the capacity buffers' routes "
        f"(ep=2, capacity factor 8: 16 rows a local expert at decode, 7904 "
        f"at the 1975-token prefill): {routes}")
    res.update({
        "10a_proven_bf16": a["proven_bf16"], "10a_proven_int8":
        a["proven_int8"], "10a_worst_bf16": a["worst_bf16"],
        "10a_worst_int8": a["worst_int8"],
        "10a_tp_from_plain_bf16": a["tp_from_plain_bf16"],
        "10a_pair_from_plain_bf16": a["pair_from_plain_bf16"],
        "10a_gap_by_depth": gaps, "10a_sweep_proven": sw["provable"],
        "10a_step_ms_shared_card": a["step_ms_shared_card"],
        "10b_worst": b["worst"], "10c_worst_tp2": c["worst_tp=2"],
        "10c_worst_ep2": c["worst_ep=2"], "10c_ep_ranks_apart": ep_apart,
        "10_rank_seconds": {r: o["seconds"] for r, o in outs.items()}})
    return res


# ---------------------------------------------------------------------------
# Phase 11: the cache-less forward, ring attention and the training steps


# Llama-2-7B's widths, depth cut to 4 layers (the time limit): 11a-11c
NC_CFG = dataclasses.replace(CFG, n_layers=4)
NC_TOL = 2e-2           # of max|logit|, test_parallel_axes.py:34's 2e-2
# of max|logit|, the cache-less forward against the cached prefill through
# K3 (bf16 P against an f32 softmax): two routes, whose logits a random
# 7B parts by 4-7% of max|logit| in one step (PERF §6); held also
# by the margins
NC_ROUTE_TOL = 8e-2
# of max|out|: the ring's attention against one device's on the same
# q/k/v, both f32 softmaxes (only the order of f32 sums differs)
RING_TOL = 1e-5
# the one-layer copies' ring gap, at most this many times one device's own
# gap at the least reordering of its attention's f32 sums
# (``_nudged_attention``): the ring adds nothing beyond reordered sums
NUDGE_RATIO = 2.0
NC_T_SP = 2048          # 11b's tokens: 1024 a rank at sp = 2 (K2: M >= 256)
TRAIN_LR = 1e-2         # test_parallel_axes.py:203's
TRAIN_B, TRAIN_T, TRAIN_MICRO = 4, 256, 2   # 11c
MOE_TRAIN_B, MOE_TRAIN_T = 2, 512           # 11d: 512 tokens a rank at sp=2
# test_parallel_axes.py:203's bounds: the loss within 3e-2 relative, the
# updated leaves within atol 5e-3, rtol 5e-2; and this script's own bound
# on the gradients themselves ((old - new) / lr, which those bounds cannot
# see at lr 1e-2): within 5e-2·max|one device's gradient|
LOSS_RTOL, UPD_ATOL, UPD_RTOL, GRAD_TOL = 3e-2, 5e-3, 5e-2, 5e-2


def _kernel_launches(counts):
    """The hand-written kernels' launches among a path's counts (the routes
    of torch ops and collectives left out)."""
    return {k: n for k, n in counts.items()
            if n and k not in _cuda.ROUTES.launches}


def _mm_dtype_has_derivative():
    """Whether this build's ``aten::mm.dtype`` (``torch.mm(...,
    out_dtype=)``) has a derivative on the card: the training graph takes
    the f32-widened product under autograd either way."""
    a = torch.randn(4, 8, device=DEV, dtype=torch.bfloat16,
                    requires_grad=True)
    b = torch.randn(8, 4, device=DEV, dtype=torch.bfloat16)
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
        return True
    except (RuntimeError, NotImplementedError) as e:
        return f"no: {str(e).splitlines()[0][:120]}"


@contextlib.contextmanager
def _f32_attention():
    """The graph's cached attention through ``attend_xla`` (the JAX
    package's f32 attention over the cache, counted as its route) instead
    of K3/K4: the cache-less forward's numerics over a cache."""
    real = TRANSFORMER.attend

    def xla(q, k, v, positions, cfg, k_scale=None, v_scale=None, window=0,
            slopes=None, prefix_len=None):
        _cuda.ROUTES.count("attend_xla")
        return A.attend_xla(q, k, v, positions, cfg, k_scale, v_scale,
                            window, slopes, prefix_len)
    TRANSFORMER.attend = xla
    try:
        yield
    finally:
        TRANSFORMER.attend = real


def _margins_held(got, ref, what):
    """Rows [N, V]: every row whose ``ref`` top-2 margin exceeds twice the
    row's largest difference has the same argmax. → rows so proven."""
    err = (got - ref).abs().amax(-1)
    top2 = ref.topk(2, dim=-1).values
    proven = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == ref.argmax(-1)
    bad = int((proven & ~same).sum())
    if bad:
        raise AssertionError(f"{what}: argmax differs at {bad} rows the "
                             "margins prove")
    return int(proven.sum())


def _trainable(params):
    """``init_random``'s inference-mode tensors as ordinary ones that can
    require grad, one leaf at a time (the old one freed as it goes)."""
    if isinstance(params, dict):
        for k in list(params):
            params[k] = _trainable(params[k])
        return params
    if isinstance(params, list):
        return [_trainable(v) for v in params]
    if isinstance(params, torch.Tensor) and params.is_inference():
        return params.clone()
    return params


def _one_device_sgd(params, cfg, toks, lr, names):
    """One device's autograd on the cross-entropy of the cache-less forward
    over ``toks`` [B, T+1] (``torch.autograd.grad`` of the plain graph, no
    mesh): → (loss, {name: (old, gradient)}) for the leaves ``names``
    picks, (key path) tuples into ``params``."""
    from neural_tpu_torch.models.transformer import Transformer
    from neural_tpu_torch.parallel.pp import cross_entropy
    leaves = {}

    def swap(tree, path, name):
        """``tree`` copied along ``path``, its leaf there made a leaf that
        requires grad (``params`` itself is left as it was)."""
        if not path:
            leaves[name] = tree.detach().requires_grad_(True)
            return leaves[name]
        t = list(tree) if isinstance(tree, list) else dict(tree)
        t[path[0]] = swap(tree[path[0]], path[1:], name)
        return t
    pd = params
    for name, path in names.items():
        pd = swap(pd, path, name)
    B = toks.shape[0]
    with torch.enable_grad():
        loss = cross_entropy(Transformer(cfg, pd)(
            toks[:, :-1], torch.zeros(B, dtype=torch.long, device=DEV),
            None), toks[:, 1:])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {n: (leaves[n].detach(), g)
                                  for n, g in zip(leaves, grads)}


def _held(new, old, grad, lr, what):
    """An updated leaf against one device's update: the bounds of
    test_parallel_axes.py:203 on the leaf, and ``GRAD_TOL`` on the
    gradient it moved by. → (max |new - ref|, max|gradient error| over
    max|gradient|)."""
    ref = old - lr * grad
    err = (new - ref).abs()
    if not bool((err <= UPD_ATOL + UPD_RTOL * ref.abs()).all()):
        raise AssertionError(f"{what}: update off by {err.max().item()}")
    g = (old - new) / lr
    gerr = ((g - grad).abs().max() / grad.abs().max()).item()
    if not gerr <= GRAD_TOL:
        raise AssertionError(f"{what}: gradient off by {gerr}·max|grad|")
    return err.max().item(), gerr


def _nc_models(model):
    """``model`` (the 4-layer 7B), a one-layer copy sharing its first layer
    and its embedding and head, and that copy with every q4_j weight
    dequantized to bf16 (the same weights, its products without K2, so
    without K2's int8 rounding of the activations): 11b's depth sweep."""
    from torch.utils._pytree import tree_map
    from neural_tpu_torch.core.qtensor import QTensor
    from neural_tpu_torch.models.transformer import Transformer
    pd = model.param_dict()
    cfg1 = dataclasses.replace(NC_CFG, n_layers=1)
    one = dict(pd, layers=pd["layers"][:1])
    bf16 = tree_map(lambda t: dequantize(t, torch.bfloat16)
                    if isinstance(t, QTensor) else t, one,
                    is_leaf=lambda x: isinstance(x, QTensor))
    return {4: (NC_CFG, model), 1: (cfg1, Transformer(cfg1, one)),
            "1 bf16": (cfg1, Transformer(cfg1, bf16))}


@contextlib.contextmanager
def _nudged_attention(seed):
    """The cache-less attention's f32 output moved by one f32 step (towards
    +inf) at a seeded half of its elements: the least change that a
    reordered f32 sum makes, to show how far one device's logits move for
    it (11b's sensitivity reading)."""
    real = TRANSFORMER.attend_nocache
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def nudged(*a, **k):
        out = real(*a, **k)
        half = torch.rand(out.shape, generator=gen, device=out.device) < 0.5
        return torch.where(half, torch.nextafter(
            out, torch.full_like(out, math.inf)), out)
    TRANSFORMER.attend_nocache = nudged
    try:
        yield
    finally:
        TRANSFORMER.attend_nocache = real


def _ring_inputs():
    """11b's attention inputs at the 7B's heads: q [1, T, 32, 128], k/v
    [1, 32, T, 128] bf16 over ``NC_T_SP`` tokens, from a seed."""
    g = torch.Generator().manual_seed(17)
    H_, D_ = NC_CFG.n_heads, NC_CFG.head_dim
    q = torch.randn(1, NC_T_SP, H_, D_, generator=g).to(torch.bfloat16)
    k = torch.randn(1, H_, NC_T_SP, D_, generator=g).to(torch.bfloat16)
    v = torch.randn(1, H_, NC_T_SP, D_, generator=g).to(torch.bfloat16)
    return q.to(DEV), k.to(DEV), v.to(DEV)


def _p11_sp(rank, mesh, counts):
    """11b on one rank: the 4-layer Llama-2-7B q4_j (and its one-layer
    copies, q4_j and bf16), its 2048 tokens sharded over sp = 2,
    ``sequence_sharded_forward`` (K2 at M = 1024, the ring over the two
    ranks) → the rank's logits [1, 1024, V] of each; and ``ring_attend`` alone on random q/k/v at
    the 7B's heads → the rank's [1, 1024, 4096]."""
    from neural_tpu_torch.parallel import (agree, checksum, ring_attend,
                                           sequence_sharded_forward,
                                           shard_model)
    whole = init_random(NC_CFG, seed=0, quant="q4_j", device=DEV)
    agree(checksum(whole.param_dict()), "11b's weights")
    toks = torch.randint(3, V, (1, NC_T_SP),
                         generator=torch.Generator().manual_seed(14))
    out = {}
    with torch.inference_mode():
        for n, (cfg, m) in _nc_models(whole).items():
            sm = shard_model(m, cfg, mesh)
            _cuda.reset_launches()
            t = time.time()
            got = sequence_sharded_forward(sm, toks)
            torch.cuda.synchronize()
            if n == NC_CFG.n_layers:
                counts["11b sp=2 sequence-sharded forward"] = \
                    _cuda.launch_counts()
                out["s"] = time.time() - t
            elif n == "1 bf16":
                counts["11b sp=2 one bf16 layer"] = _cuda.launch_counts()
            out[f"logits_{n}"] = got.float().cpu()
            del sm
        q, k, v = _ring_inputs()
        Tl, r = NC_T_SP // 2, mesh.index("sp")
        pos = torch.arange(r * Tl, (r + 1) * Tl, device=DEV)[None]
        out["ring"] = ring_attend(q[:, r * Tl:(r + 1) * Tl],
                                  k[:, :, r * Tl:(r + 1) * Tl],
                                  v[:, :, r * Tl:(r + 1) * Tl], pos, NC_CFG,
                                  mesh).cpu()
    del whole
    return out


def _p11_pp(rank, mesh, counts):
    """11c on one rank: ``make_pp_train_step`` at pp = 2 on the 4-layer
    7B with f32 params, B = 4, T = 256, two microbatches; rank 0 then holds
    the loss and the updated ``embed``, layer 0's ``wq`` and ``lm_head``
    against one device's autograd on the same weights and tokens."""
    from neural_tpu_torch.parallel import make_pp_train_step, pp_shard_params
    params = _trainable(init_random(NC_CFG, seed=1, dtype=torch.float32,
                                    device=DEV).param_dict())
    step = make_pp_train_step(params, NC_CFG, mesh, TRAIN_MICRO, TRAIN_LR)
    local = pp_shard_params(params, NC_CFG, mesh)
    if rank:
        del params
    toks = torch.randint(3, V, (TRAIN_B, TRAIN_T + 1),
                         generator=torch.Generator().manual_seed(15))
    _cuda.reset_launches()
    t = time.time()
    loss, new = step(local, toks)
    torch.cuda.synchronize()
    out = {"s": time.time() - t, "loss": float(loss)}
    counts["11c pp=2 train step"] = _cuda.launch_counts()
    got = {"embed": new["embed"], "lm_head": new["lm_head"]}
    if rank == 0:
        got["wq0"] = new["layers"][0]["wq"]
    del local, new
    torch.cuda.empty_cache()
    if rank == 0:
        _cuda.reset_launches()
        t = time.time()
        ref_loss, ref = _one_device_sgd(
            params, NC_CFG, toks.to(DEV), TRAIN_LR,
            {"embed": ("embed",), "lm_head": ("lm_head",),
             "wq0": ("layers", 0, "wq")})
        out["ref_s"] = time.time() - t
        counts["11c one-device autograd"] = _cuda.launch_counts()
        out["ref_loss"] = ref_loss
        if not abs(out["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss):
            raise AssertionError(f"11c loss {out['loss']} against one "
                                 f"device's {ref_loss}")
        out["held"] = {n: _held(got[n], *ref[n], TRAIN_LR, f"11c {n}")
                       for n in ref}
        del params, ref
    return out


def _p11_moe(rank, meshes, counts):
    """11d on one rank: the MoE training step on a one-layer Mixtral-8x7B
    at full width, f32 params, B = 2, T = 512, at sp = 2 (ep = 1) and at
    ep = 2 (sp = 1, capacity factor 8: nothing dropped); rank 0 holds each
    against one device's autograd on the same weights and tokens (computed
    once)."""
    from neural_tpu_torch.parallel import make_moe_train_step, shard_params
    from neural_tpu_torch.parallel.ep import ep_param_specs
    cfg = dataclasses.replace(MIXTRAL_CFG, n_layers=1)
    toks = torch.randint(3, V, (MOE_TRAIN_B, MOE_TRAIN_T + 1),
                         generator=torch.Generator().manual_seed(16))
    names = {"embed": ("embed",), "lm_head": ("lm_head",),
             "wq0": ("layers", 0, "wq"), "router0": ("layers", 0, "router"),
             "experts_w_up0": ("layers", 0, "experts", "w_up")}
    out, ref = {}, None
    for what, mesh in meshes.items():
        params = _trainable(init_random(cfg, seed=2, dtype=torch.float32,
                                        device=DEV).param_dict())
        step = make_moe_train_step(params, cfg, mesh, TRAIN_LR,
                                   capacity_factor=float(cfg.n_experts))
        local = params if mesh.ep == 1 else shard_params(
            params, cfg, mesh, ep_param_specs(params, cfg, tp=False))
        if rank and mesh.ep > 1:
            del params
        _cuda.reset_launches()
        t = time.time()
        loss, new = step(local, toks)
        torch.cuda.synchronize()
        o = {"s": time.time() - t, "loss": float(loss)}
        counts[f"11d {what} train step"] = _cuda.launch_counts()
        lp = new["layers"][0]
        got = {"embed": new["embed"], "lm_head": new["lm_head"],
               "wq0": lp["wq"], "router0": lp["router"],
               "experts_w_up0": lp["experts"]["w_up"]}
        del local, new, lp
        torch.cuda.empty_cache()
        if rank == 0:
            if ref is None:
                t = time.time()
                _cuda.reset_launches()
                ref = _one_device_sgd(params, cfg, toks.to(DEV), TRAIN_LR,
                                      names)
                o["ref_s"] = time.time() - t
                counts["11d one-device autograd"] = _cuda.launch_counts()
            ref_loss, grads = ref
            o["ref_loss"] = ref_loss
            if not abs(o["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss):
                raise AssertionError(f"11d {what} loss {o['loss']} against "
                                     f"one device's {ref_loss}")
            # ep = 2: rank 0 holds experts 0-3 of 8
            E = got["experts_w_up0"].shape[0]
            held = {}
            for n, (old, g) in grads.items():
                if n == "experts_w_up0":
                    old, g = old[:E], g[:E]
                held[n] = _held(got[n], old, g, TRAIN_LR, f"11d {what} {n}")
            o["held"] = held
        del got
        if rank == 0 or mesh.ep == 1:
            del params
        torch.cuda.empty_cache()
        out[what] = o
    return out


def phase_nocache(results):
    """Phase 11: (11a) in this process, the 4-layer Llama-2-7B q4_j's
    cache-less forward against its cached prefill on one 1975-token prompt;
    then the ranks of phase 10 (spawned again under ``--phase11``): (11b)
    the sequence-sharded forward at sp = 2, held here against this
    process's one-device cache-less forward, (11c) the pipeline step and
    (11d) the MoE step, each held on rank 0 against one device's
    autograd."""
    t0 = time.time()
    smi = smi_line()
    torch.cuda.reset_peak_memory_stats()
    ranks = _ranks("11")         # running 11b-11d while 11a runs here
    res = {"mm_dtype_derivative": _mm_dtype_has_derivative()}
    log(f"11: aten::mm.dtype has a derivative on this build: "
        f"{res['mm_dtype_derivative']} (the training graph takes the "
        "f32-widened product under autograd)")
    model = init_random(NC_CFG, seed=0, quant="q4_j", device=DEV)
    prompt = torch.randint(3, V, (1, T_PREFILL),
                           generator=torch.Generator().manual_seed(13)) \
        .to(DEV)
    zero = torch.zeros(1, dtype=torch.long, device=DEV)
    with torch.inference_mode():
        _cuda.reset_launches()
        cached = model(prompt, zero, init_cache(NC_CFG, 1, S_CACHE,
                                                device=DEV))
        torch.cuda.synchronize()
        LAUNCHES["11a cached prefill"] = _cuda.launch_counts()
        with _f32_attention():
            _cuda.reset_launches()
            cached32 = model(prompt, zero, init_cache(NC_CFG, 1, S_CACHE,
                                                      device=DEV))
            x32 = _cuda.launch_counts()["attend_xla"]
        _cuda.reset_launches()
        t = time.time()
        nocache = model(prompt, zero, None)
        torch.cuda.synchronize()
        res["11a_nocache_s"] = time.time() - t
        LAUNCHES["11a cache-less forward"] = c = _cuda.launch_counts()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    apart32, apart = rel(nocache, cached32), rel(nocache, cached)
    rows, rows_k3 = nocache[0].float(), cached[0].float()
    proven = _margins_held(rows, rows_k3, "11a against K3's prefill")
    agree_top = (rows.argmax(-1) == rows_k3.argmax(-1)).float().mean()
    res.update({"11a_apart_f32_cache": apart32, "11a_apart_k3": apart,
                "11a_argmax_agree_k3": agree_top.item(),
                "11a_proven_k3": proven})
    n_k2 = 7 * NC_CFG.n_layers + 1
    log(f"11a 4-layer 7B q4_j, {T_PREFILL} tokens: the cache-less forward "
        f"{apart32:.4g}·max|logit| from the cached prefill with the same "
        f"f32 attention over the cache ({x32} attend_xla calls; tolerance "
        f"{NC_TOL}) and {apart:.4g} from the cached prefill through K3 "
        f"(tolerance {NC_ROUTE_TOL}), argmax equal to K3's at "
        f"{agree_top.item():.4f} of the rows, proven by the margins at "
        f"{proven} of {T_PREFILL}; launches {_kernel_launches(c)}, routes "
        f"attend_nocache {c['attend_nocache']}; "
        f"{res['11a_nocache_s']:.3f} s host clock ({smi})")
    if not apart32 <= NC_TOL:
        raise AssertionError(f"11a: {apart32}·max|logit| > {NC_TOL}")
    if not apart <= NC_ROUTE_TOL:
        raise AssertionError(f"11a against K3: {apart}·max|logit| > "
                             f"{NC_ROUTE_TOL}")
    if c["qmm_a8"] != n_k2 or c["flash_prefill"] or \
            c["attend_nocache"] != NC_CFG.n_layers:
        raise AssertionError(f"11a cache-less launches {c}: expected "
                             f"{n_k2} K2, no K3, {NC_CFG.n_layers} "
                             "attend_nocache")
    del cached, cached32, nocache, rows, rows_k3
    # 11b's one-device references on this process's copy of the weights
    from neural_tpu_torch.models.transformer import attend_nocache
    toks = torch.randint(3, V, (1, NC_T_SP),
                         generator=torch.Generator().manual_seed(14)).to(DEV)
    ones, nudged = {}, {}
    with torch.inference_mode():
        for n, (cfg, m) in _nc_models(model).items():
            ones[n] = m(toks, torch.zeros(1, dtype=torch.long, device=DEV),
                        None).float().cpu()
            if n != NC_CFG.n_layers:
                with _nudged_attention(18):
                    one = m(toks, torch.zeros(1, dtype=torch.long,
                                              device=DEV), None).float().cpu()
                nudged[n] = ((one - ones[n]).abs().max()
                             / ones[n].abs().max()).item()
        q, k, v = _ring_inputs()
        pos = torch.arange(NC_T_SP, device=DEV)[None]
        ring_one = attend_nocache(q, k, v, pos, NC_CFG).cpu()
    del model, q, k, v
    torch.cuda.empty_cache()
    outs = ranks.gather("11")
    Tl = NC_T_SP // 2
    shard = lambda t, r: t[:, r * Tl:(r + 1) * Tl]
    ring_apart = max(
        ((torch.from_numpy(np.asarray(o["11b"]["ring"])) - shard(ring_one, r))
         .abs().max() / ring_one.abs().max()).item() for r, o in outs.items())
    gaps, proven = {}, 0
    for n, one in ones.items():
        got = torch.cat([torch.from_numpy(np.asarray(
            outs[r]["11b"][f"logits_{n}"])) for r in range(2)], dim=1)
        gaps[n] = ((got - one).abs().max() / one.abs().max()).item()
        if n == NC_CFG.n_layers:
            proven = _margins_held(got[0], one[0], "11b against one device")
    res.update({"11b_ring_apart": ring_apart, "11b_gap_by_depth": gaps,
                "11b_proven": proven, "11b_one_device_nudged": nudged})
    for r, o in outs.items():
        cnt = o["counts"]["11b sp=2 sequence-sharded forward"]
        LAUNCHES[f"11b sp=2 rank {r}"] = cnt
        for key in ("11c pp=2 train step", "11c one-device autograd",
                    "11d sp=2 train step", "11d ep=2 train step",
                    "11d one-device autograd"):
            if key in o["counts"]:
                LAUNCHES[f"{key} rank {r}"] = o["counts"][key]
        log(f"11b rank {r}: launches {_kernel_launches(cnt)}, ring_attend "
            f"{cnt['ring_attend']}, sp_ppermute {cnt['sp_ppermute']}, "
            f"{o['11b']['s']:.2f} s host clock ({smi})")
        if cnt["qmm_a8"] != n_k2 or cnt["ring_attend"] != NC_CFG.n_layers \
                or cnt["flash_prefill"]:
            raise AssertionError(f"11b rank {r} launches {cnt}")
        c16 = o["counts"]["11b sp=2 one bf16 layer"]
        if c16["qmm_a8"] or c16["ring_attend"] != 1:
            raise AssertionError(f"11b rank {r} bf16 copy launches {c16}")
    log(f"11b sp=2 ({NC_T_SP} tokens, M = {Tl} a rank): ring_attend at the "
        f"7B's heads {ring_apart:.4g}·max|out| from one device's "
        f"(tolerance {RING_TOL}); the ranks' logits from one device's "
        f"cache-less forward by depth {gaps} (1 layer, q4_j through K2 or "
        f"its weights in bf16 without K2: tolerance {NC_TOL}; "
        f"{NC_CFG.n_layers}: {NC_ROUTE_TOL}, argmax proven by the margins "
        f"at {proven} of {NC_T_SP} rows; {smi})")
    log(f"11b one device against itself with its attention's f32 output "
        f"one f32 step apart at half the elements (the least reordering): "
        f"the one-layer logits apart by {nudged} of max|logit| ({smi})")
    if not ring_apart <= RING_TOL:
        raise AssertionError(f"11b ring: {ring_apart}·max|out| > {RING_TOL}")
    if not gaps[1] <= NC_TOL or not gaps["1 bf16"] <= NC_TOL \
            or not gaps[NC_CFG.n_layers] <= NC_ROUTE_TOL:
        raise AssertionError(f"11b: gaps by depth {gaps}")
    for n, floor in nudged.items():
        if not gaps[n] <= NUDGE_RATIO * floor:
            raise AssertionError(
                f"11b {n}: the ring {gaps[n]}·max|logit| from one device, "
                f"past {NUDGE_RATIO}× one device's own {floor} at the least "
                "reordering")
    train = {}
    for r, o in outs.items():
        for key in [k for k in o["counts"] if k.startswith(("11c", "11d"))]:
            train[f"{key} rank {r}"] = _kernel_launches(o["counts"][key])
    log(f"11c/11d hand-written kernel launches in the training legs: "
        f"{train}")
    if any(train.values()):
        raise AssertionError(f"11 training legs launched kernels: {train}")
    c0, c1 = outs[0]["11c"], outs[1]["11c"]
    if c0["loss"] != c1["loss"]:
        raise AssertionError(f"11c: the ranks' losses differ: {c0['loss']}, "
                             f"{c1['loss']}")
    log(f"11c pp=2 train step (7B widths, 4 layers, f32 params, B={TRAIN_B}"
        f", T={TRAIN_T}, {TRAIN_MICRO} microbatches): loss {c0['loss']:.6f} "
        f"against one device's {c0['ref_loss']:.6f}; (max|new - ref|, "
        f"gradient error over max|grad|) {c0['held']}; step "
        f"{c0['s']:.2f} / {c1['s']:.2f} s, one device {c0['ref_s']:.2f} s "
        f"(host clock; {SHARED_CARD}; {smi})")
    d0 = outs[0]["11d"]
    for what, o in d0.items():
        if o["loss"] != outs[1]["11d"][what]["loss"]:
            raise AssertionError(f"11d {what}: the ranks' losses differ")
        log(f"11d {what} MoE train step (Mixtral-8x7B widths, 1 layer, f32 "
            f"params, B={MOE_TRAIN_B}, T={MOE_TRAIN_T}): loss "
            f"{o['loss']:.6f} against one device's {o['ref_loss']:.6f}; "
            f"{o['held']}; step {o['s']:.2f} s (host clock; {smi})")
    peaks = {r: round(o["peak_gib"], 2) for r, o in outs.items()}
    log(f"11 peak memory a rank (GiB allocated): {peaks}; this process "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    res.update({"11c": {k: c0[k] for k in (
        "loss", "ref_loss", "held", "s", "ref_s")},
        "11d": {w: {k: o[k] for k in ("loss", "ref_loss", "held", "s")}
                for w, o in d0.items()},
        "11_rank_peak_gib": peaks,
        "11_rank_seconds": {r: o["seconds"] for r, o in outs.items()},
        "11_seconds": time.time() - t0})
    log(f"phase 11: {time.time() - t0:.1f} s ({smi})")
    return res


# ---------------------------------------------------------------------------
# phase 12: Whisper large-v3, card against plain, eval and the trace
# ---------------------------------------------------------------------------


# openai/whisper-large-v3's config.json: d_model 1280, 20 heads, 32 encoder
# and 32 decoder layers, FFN 5120, 128 mels, vocab 51866, 1500 / 448
# positions, eos 50257, decoder start 50258
WH_V3 = WH.WhisperConfig(vocab_size=51866, d_model=1280, n_heads=20,
                         enc_layers=32, dec_layers=32, n_mels=128,
                         n_audio_ctx=1500, n_text_ctx=448, ffn_dim=5120,
                         eos_token_id=50257, sot_token_id=50258)
WH_M = 1500          # the encoder's rows a 30 s window: K2 / K5 at M = 1500
# the encoder's products a window (q/k/v/o, fc1, fc2 of 32 layers) and the
# decoder's cross K/V of the encoder states (2 a layer), all at M = 1500
WH_ENC = [(1280, 1280, 4 * 32 + 2 * 32), (1280, 5120, 32), (5120, 1280, 32)]
# a decoder step's (self q/k/v/o, cross q/o, fc1, fc2 of 32 layers)
WH_DEC = [(1280, 1280, 6 * 32), (1280, 5120, 32), (5120, 1280, 32)]
WH_K_WINDOW = sum(c for _, _, c in WH_ENC)     # 256 products a window
WH_K_STEP = sum(c for _, _, c in WH_DEC)       # 256 products a token
WH_TOL = 2e-2        # 12b card vs plain, of max|·| (f32 activations)
WH_AUDIO_S = 20.0    # the seeded WAV's seconds (one 30 s window)
WH_NEW = 24          # new tokens of each transcribe_file leg
WH_STEPS = 8         # 12b's teacher-forced decoder steps
EVAL_CFG = dataclasses.replace(CFG, n_layers=2)
EVAL_TOL = 1e-2      # 12c perplexity, card against plain, relative


def _k2_f32(gen, shapes, M=WH_M):
    """K2 with f32 x (Whisper's encoder rows, x quantized from its own f32
    values) and f32 out over ``shapes``: the activation codes and scales
    equal to the plain version's bit for bit, the product within 1e-5 of
    max|plain|; times summed over a window."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for K, N, count in shapes:
        planes, scales, qt = _qweight(K, N, gen)[0]
        x = torch.randn((M, K), generator=gen, device=DEV)
        xq, sa = Q.act_quant_i8(x, 128)
        rq, rsa = Q.quantize_act_i8(x, 128)
        if not (torch.equal(xq, rq) and torch.equal(sa, rsa)):
            raise AssertionError(f"K2 f32 x: act codes differ at {M}x{K}")
        f32 = torch.float32
        out = Q.qmm_a8(x, planes, scales, 128, 128, f32)
        ref = Q.qmm_a8_plain(x, planes, scales, 128, 128, f32)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"K2 f32 x {M}x{K}x{N}: max err {err} > "
                                 f"{tol}")
        ms = time_ms([lambda: Q.qmm_a8(x, planes, scales, 128, 128, f32)])
        pms = time_ms([lambda: Q.qmm_a8_plain(x, planes, scales, 128, 128,
                                              f32)], reps=5)
        wd, xb = dequantize(qt, torch.bfloat16), x.bfloat16()
        lms = time_ms([lambda: torch.matmul(xb, wd)])
        nbytes = M * K * 4 + K * N // 2 + K // 128 * N * 2 + M * N * 4
        bnd, by = bound_ms(nbytes, 2 * M * N * K, INT8_OPS)
        bound_by[by] += count * bnd
        log(f"K2 qmm_a8 f32 x M={M} {K}x{N} x{count}/window: err {err:.3g} "
            f"(tol {tol:.3g}), act codes equal | kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, torch.matmul bf16 {lms:.3f} ms, bound "
            f"{bnd:.4f} ms ({by})")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
        del wd, xb
    agg["bound_by"] = max(bound_by, key=bound_by.get)
    return agg


def check_whisper_kernels(gen, results):
    """Each kernel at Whisper large-v3's shapes with f32 x and f32 out,
    against its plain version, with its time, the plain version's, one
    library call's and its bound: K2 (q4_j) on the encoder's and the cross
    K/V's products at M = 1500 (x quantized from f32: codes bit-equal), K5's
    tiles (q4_0) on the same, K1 on a decoder step's products at M = 1
    (greedy; q4_j and q4_0) and M = 5 (a beam-5 step). Recorded under
    ``whisper_<kernel>`` and, where phase 3 ran, among that kernel's
    cases."""
    f32 = torch.float32
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    k5 = lambda x, qt, odt: Q.qmm_general(x, qt, odt)
    p5 = lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt)
    wh = {"K1": {}, "K5_tc": {}}
    for fmt, M, what in (("q4_j", 1, "greedy decoder step"),
                         ("q4_j", 5, "beam-5 decoder step"),
                         ("q4_0", 1, "greedy decoder step")):
        label = f"whisper large-v3 {fmt} {what}, f32 x"
        wh["K1"][label] = _case(gen, label, PRESETS[fmt], M, WH_DEC, k1, p1,
                                "qmm4_npack", BF16_FLOPS, x_dtype=f32,
                                out_dtype=f32)
        torch.cuda.empty_cache()
    label = "whisper large-v3 q4_0 encoder window, f32 x"
    wh["K5_tc"][label] = _case(gen, label, PRESETS["q4_0"], WH_M, WH_ENC, k5,
                               p5, "qmm_general+tc", BF16_FLOPS, x_dtype=f32,
                               out_dtype=f32)
    torch.cuda.empty_cache()
    label = "whisper large-v3 q4_j encoder window, f32 x"
    wh["K2"] = {label: dict(_k2_f32(gen, WH_ENC),
                            per=f"{label} ({WH_K_WINDOW} launches)")}
    torch.cuda.empty_cache()
    for key, cases in wh.items():
        results[f"whisper_{key}"] = dict(next(iter(cases.values())),
                                          cases=cases)
        if key in results:
            results[key]["cases"].update(cases)
        if key == "K5_tc" and "K5" in results:
            results["K5"]["cases"].update(cases)
    return {f"12d {k} {label}": {m: c[m] for m in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
        for k, cases in wh.items() for label, c in cases.items()}


def _write_wav(path, seconds, seed, sr=16000):
    """A seeded 16 kHz mono WAV through stdlib ``wave``: three tones under
    noise, 16-bit."""
    import wave
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (220.0, 440.0, 990.0))
    sig = sig + 0.05 * rng.standard_normal(len(t))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def _encoder_parts(params, cfg, mel):
    """Where an encoder window's device time goes: the whole ``encode``,
    the conv stem alone, ``_mha`` alone at one layer's shapes (times the
    layers) and the products (from their own launches), each by CUDA
    events around the call."""
    x = torch.as_tensor(mel[None], device=DEV)

    def stem():
        with WH.f32_exact():
            h = F.gelu(F.conv1d(x, params["conv1_w"], params["conv1_b"],
                                padding=1))
            return F.gelu(F.conv1d(h, params["conv2_w"], params["conv2_b"],
                                   stride=2, padding=1))
    q, k, v = (torch.randn((1, WH_M, cfg.d_model), device=DEV)
               for _ in range(3))

    def mha():
        with WH.f32_exact():
            return WH._mha(q, k, v, cfg.n_heads)
    return {"encode_ms": _event_ms(lambda: WH.encode(params, mel[None], cfg),
                                   reps=5),
            "conv_stem_ms": _event_ms(stem, reps=5),
            "mha_ms": cfg.enc_layers * _event_ms(mha, reps=5)}


def _step_ms(params, cfg, enc, W=1):
    """The device time of one decoder step at position 64 by CUDA events:
    greedy (W = 1, ``decode_step``) or one beam expansion (``_beam_step``
    over W rows reading one cross K/V row)."""
    state = WH.init_decoder_state(params, enc, cfg)
    WH.decode_step(params, [[cfg.sot_token_id] * 4], 0, state, cfg)
    if W == 1:
        return _event_ms(lambda: WH.decode_step(params, [[17]], 64, state,
                                                cfg), reps=10)
    for key in ("self_k", "self_v"):
        state[key] = state[key].repeat(1, W, 1, 1)
    toks = [[17 + w] for w in range(W)]
    scores = torch.zeros(W, device=DEV)
    alive = torch.ones(W, dtype=torch.bool, device=DEV)
    return _event_ms(lambda: WH._beam_step(params, toks, 64, scores, state,
                                           alive, cfg, W), reps=10)


def whisper_full(wav, required):
    """12a: Whisper large-v3 at its published widths, random f32 weights
    from a seed built on the card, at q4_j (K2 + K1) and q4_0 (K5 + K1):
    ``transcribe_file`` end to end on the seeded WAV as a path with its
    launch counts (every product of a window and of each token counted),
    its real-time factor, the encoder's device ms a window and where it
    goes, the greedy decoder's ms a token and a beam-5 step's (CUDA
    events), ``detect_language`` and the timestamps path once each."""
    smi = smi_line()
    res = {}
    audio = load_audio_16k(wav)
    mel = WH.log_mel_spectrogram(audio, WH_V3.n_mels)
    for fmt, req in required.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        params = WH.init_random(WH_V3, seed=0, quant=fmt, device=DEV)
        torch.cuda.synchronize()
        build_s = time.time() - t
        m = Model().init_whisper_params(params, WH_V3)
        ids = m.transcribe_file(wav, max_new_tokens=4)     # warm
        t = time.time()
        ids = run_path(f"whisper_{fmt}", req, lambda: m.transcribe_file(
            wav, max_new_tokens=WH_NEW))
        e2e_s = time.time() - t
        c = LAUNCHES[f"whisper_{fmt}"]
        prompt = WH.build_forced_prompt(WH_V3)
        n_new = len(ids) - len(prompt)
        k1 = c["qmm4_npack"]
        enc_k = c["qmm_a8"] if fmt == "q4_j" else c["qmm_general+tc"]
        if k1 != WH_K_STEP * n_new or enc_k != WH_K_WINDOW:
            raise AssertionError(
                f"whisper {fmt}: {k1} K1 launches for {n_new} tokens "
                f"(expected {WH_K_STEP * n_new}), {enc_k} window products "
                f"(expected {WH_K_WINDOW}); counts {_kernel_launches(c)}")
        if any(not 0 <= i < WH_V3.vocab_size for i in ids):
            raise AssertionError(f"whisper {fmt}: ids out of range {ids}")
        enc = WH.encode(params, mel[None], WH_V3)
        if not (enc.shape == (1, WH_M, WH_V3.d_model)
                and torch.isfinite(enc).all()):
            raise AssertionError(f"whisper {fmt}: encoder states {enc.shape}")
        parts = _encoder_parts(params, WH_V3, mel)
        step = _step_ms(params, WH_V3, enc)
        beam = _step_ms(params, WH_V3, enc, W=5)
        t = time.time()
        lang, probs = WH.detect_language(params, WH_V3, mel, enc=enc)
        lang_s = time.time() - t
        st = WH.special_tokens(WH_V3)
        if not (st["lang_begin"] <= lang < st["lang_end"]
                and abs(probs.sum() - 1) < 1e-4):
            raise AssertionError(f"whisper {fmt}: language {lang}")
        t = time.time()
        segs = m.transcribe_file(wav, max_new_tokens=16, timestamps=True)
        ts_s = time.time() - t
        for s0, s1, seg in segs:
            if not (0.0 <= s0 <= s1 <= 60.0
                    and all(i < st["timestamp_begin"] for i in seg)):
                raise AssertionError(f"whisper {fmt}: segment {s0, s1, seg}")
        beams = m.transcribe_file(wav, max_new_tokens=8, num_beams=5)
        r = {"build_s": build_s, "transcribe_s": e2e_s,
             "rtf": e2e_s / WH_AUDIO_S, "new_tokens": n_new, **parts,
             "decode_ms_token": step, "beam5_step_ms": beam,
             "detect_language_s": lang_s, "timestamps_s": ts_s,
             "segments": len(segs), "beam_ids": len(beams),
             "window_products": enc_k, "k1_launches": k1,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        res[f"12a whisper large-v3 {fmt}"] = r
        log(f"12a whisper large-v3 {fmt} (random weights, {build_s:.1f} s to "
            f"build on the card): transcribe_file of {WH_AUDIO_S:.0f} s, "
            f"{n_new} new tokens, {e2e_s:.3f} s host clock, real-time factor "
            f"{r['rtf']:.4f}; encoder {parts['encode_ms']:.3f} ms a window "
            f"(conv stem {parts['conv_stem_ms']:.3f}, _mha "
            f"{parts['mha_ms']:.3f} over 32 layers); greedy step "
            f"{step:.3f} ms, beam-5 step {beam:.3f} ms (CUDA events); "
            f"detect_language {lang_s:.3f} s (token {lang}); timestamps "
            f"path {ts_s:.3f} s, {len(segs)} segments; launches "
            f"{_kernel_launches(c)}; peak {r['peak_gib']:.2f} GiB ({smi})")
        del m, params, enc
    return res


def _whisper_card_vs_plain(fmt, mel):
    """12b: the 2 + 2-layer copy at large-v3's widths, its kernels against
    their plain versions on the card's own tensors: encoder states and the
    logits of WH_STEPS teacher-forced steps within WH_TOL·max|·|, argmax
    equal where the margins prove it; then the card run again with the
    TF32 switches at PyTorch's defaults (cuDNN on) and both on: the same
    bits, the precision being set inside Whisper's ops."""
    cfg2 = dataclasses.replace(WH_V3, enc_layers=2, dec_layers=2)
    params = WH.init_random(cfg2, seed=1, quant=fmt, device=DEV)

    def run():
        enc = WH.encode(params, mel[None], cfg2)
        ids = WH.transcribe_ids(params, cfg2, mel, [cfg2.sot_token_id],
                                max_new_tokens=WH_STEPS)
        state = WH.init_decoder_state(params, enc, cfg2)
        logits, _ = WH.decode_step(params, [ids[:-1]], 0, state, cfg2)
        return enc, logits[0], ids
    enc, rows, ids = run()
    with plain_on_card():
        penc, prows, _ = run()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    e_rel, l_rel = rel(enc, penc), rel(rows, prows)
    proven = _margins_held(rows, prows, f"12b whisper {fmt}")
    if ids[1:] != rows.argmax(-1).tolist():
        raise AssertionError(f"12b whisper {fmt}: greedy ids {ids} are not "
                             "the argmax of their own teacher-forced rows")
    same = {}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for what, conv, mm in (("pytorch defaults", True, False),
                               ("tf32 on", True, True)):
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cuda.matmul.allow_tf32 = mm
            g_enc, g_rows, g_ids = run()
            same[what] = bool(torch.equal(g_enc, enc)
                              and torch.equal(g_rows, rows) and g_ids == ids)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    log(f"12b whisper {fmt}, 2 + 2 layers at large-v3's widths, card "
        f"against plain: encoder {e_rel:.4g}·max|enc|, {WH_STEPS} "
        f"teacher-forced rows {l_rel:.4g}·max|logit| (tolerance {WH_TOL}), "
        f"argmax proven by the margins at {proven} of {len(ids) - 1} rows; "
        f"the card run with the TF32 switches changed bit-equal: {same}")
    if not (e_rel <= WH_TOL and l_rel <= WH_TOL):
        raise AssertionError(f"12b whisper {fmt}: {e_rel}, {l_rel}")
    if not all(same.values()):
        raise AssertionError(f"12b whisper {fmt}: the TF32 switches moved "
                             f"the result: {same}")
    return {"enc_rel": e_rel, "logits_rel": l_rel, "proven": proven,
            "tf32_switches_bit_equal": same}


def _eval_card_vs_plain():
    """12c: ``eval.perplexity`` over 1024 seeded tokens (ctx 512, stride
    256, batch 2) on a 2-layer Llama-2-7B-width q4_j copy through
    ``batch_logits`` (K2 and K3 on the card) against the plain route on
    the card's tensors, within EVAL_TOL relative a window; ``score_choices``
    the same answer on both routes; one ``maybe_trace`` of a
    ``Model.generate`` at ``NEURAL_TPU_VERBOSE=2`` and its top device
    ops."""
    import io
    from neural_tpu_torch.eval import perplexity, score_choices
    smi = smi_line()
    params = init_random(EVAL_CFG, seed=3, quant="q4_j", device=DEV)
    toks = np.random.default_rng(12).integers(3, V, 1024).tolist()
    kw = dict(ctx_size=512, stride=256, batch=2)
    t = time.time()
    got = run_path("eval_perplexity", ("qmm_a8", "flash_prefill"),
                   lambda: perplexity(params, EVAL_CFG, toks, **kw))
    ppl_s = time.time() - t
    with plain_on_card():
        ref = perplexity(params, EVAL_CFG, toks, **kw)
    apart = max(abs(a / b - 1) for a, b in zip(got["per_window"],
                                               ref["per_window"]))
    ctx = toks[:64]
    choices = [toks[64 + 5 * i:64 + 5 * i + 2 + i] for i in range(4)]
    pick = score_choices(params, EVAL_CFG, ctx, choices)
    with plain_on_card():
        pick_ref = score_choices(params, EVAL_CFG, ctx, choices)
    log(f"12c perplexity, 2-layer 7B q4_j, 1024 tokens (ctx 512, stride "
        f"256, batch 2): card {got['ppl']:.6f} in {ppl_s:.3f} s host "
        f"clock, plain {ref['ppl']:.6f}, windows apart by {apart:.3g} "
        f"relative (tolerance {EVAL_TOL}); score_choices card {pick}, plain "
        f"{pick_ref} ({smi})")
    if not (apart <= EVAL_TOL and got["n_tokens"] == ref["n_tokens"]):
        raise AssertionError(f"12c perplexity: {got} against {ref}")
    if pick != pick_ref:
        raise AssertionError(f"12c score_choices: {pick} against {pick_ref}")
    m = Model().init_params(params, EVAL_CFG)
    buf = io.StringIO()
    old = os.environ.get("NEURAL_TPU_VERBOSE")
    os.environ["NEURAL_TPU_VERBOSE"] = "2"
    try:
        with contextlib.redirect_stdout(buf):
            m.generate(toks[:32], max_new_tokens=8)
    finally:
        if old is None:
            os.environ.pop("NEURAL_TPU_VERBOSE")
        else:
            os.environ["NEURAL_TPU_VERBOSE"] = old
    trace = buf.getvalue()
    log(f"12c maybe_trace of Model.generate (32-token prompt, 8 new) at "
        f"NEURAL_TPU_VERBOSE=2 ({smi}):\n{trace}")
    if "neural-tpu timings:" not in trace or " ops (generate" not in trace:
        raise AssertionError(f"12c: the trace printed {trace!r}")
    return {"ppl": got["ppl"], "ppl_plain": ref["ppl"],
            "windows_apart": apart, "ppl_s": ppl_s, "choice": pick,
            "device_ops": "top device ops" in trace}


def phase_whisper(results):
    """Phase 12: (12d) the kernels at Whisper large-v3's shapes with f32 x
    where phase 3 did not run them; (12a) large-v3 at full width and depth,
    q4_j and q4_0; (12b) the 2 + 2-layer copies against the plain path on
    the card; (12c) eval's perplexity and scoring against the plain route
    and one trace."""
    t0 = time.time()
    res = {}
    if "whisper_K2" not in results:
        gen = torch.Generator(device=DEV).manual_seed(12)
        res["12d"] = check_whisper_kernels(gen, results)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".chip_scratch", "phase12")
    os.makedirs(d, exist_ok=True)
    wav = _write_wav(os.path.join(d, "seeded.wav"), WH_AUDIO_S, seed=12)
    t = time.time()
    res.update(whisper_full(wav, {
        "q4_j": ("qmm_a8", "quantize_act_i8", "qmm4_npack"),
        "q4_0": ("qmm_general+tc", "qmm4_npack")}))
    log(f"phase 12a: {time.time() - t:.1f} s")
    t = time.time()
    mel = WH.log_mel_spectrogram(load_audio_16k(wav), WH_V3.n_mels)
    for fmt in ("q4_j", "q4_0"):
        res[f"12b whisper {fmt}"] = _whisper_card_vs_plain(fmt, mel)
        torch.cuda.empty_cache()
    log(f"phase 12b: {time.time() - t:.1f} s")
    t = time.time()
    res["12c eval"] = _eval_card_vs_plain()
    log(f"phase 12c: {time.time() - t:.1f} s")
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 12: {time.time() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 13: f32 parameters at rest and f32 KV caches (K3, K4 and K6's
# f32-cache branches), the command-line tools and the accuracy gate
# ---------------------------------------------------------------------------

F32_NOISE = 1e-3     # f32 K/V moved off the bf16 grid by this much
F32_BITEQ = {}       # 13c: each f32 branch equal to the bf16 branch, by case
F32_BEFORE = {}      # 13c: the bf16 branch's ms per launch, by case


def _off_grid(c, gen):
    """An f32 copy of a cache tensor moved off the bf16 grid (V stays in
    [-1 - 1e-2, 1 + 1e-2])."""
    return c.float() + torch.randn(c.shape, generator=gen, device=DEV) \
        * F32_NOISE


def _biteq(what, bf16_out, f32_out):
    """The f32 branch's output over K/V that the bf16 branch reads rounded
    is the bf16 branch's, bit for bit."""
    same = bool(torch.equal(bf16_out, f32_out))
    F32_BITEQ[what] = same
    if not same:
        raise AssertionError(f"{what}: the f32 branch differs from the bf16 "
                             f"branch by {(bf16_out - f32_out).abs().max()}")


def check_f32_attention(gen, results):
    """13c: K4's, K3's and K6's f32-cache branches at the main path's shapes
    (Llama-2-7B's heads: K4 at fill 1975, K3 on a 1975-token prompt, K6 at
    batch 8 with the server's mixed fills over 256-key pages). For each:
    its output over an f32 cache holding bf16 values, and over f32 values
    off the bf16 grid, bit-equal to the bf16 branch's over the same values
    rounded; held to its plain version; its time over the off-grid cache,
    the bound of its bytes at 4 a K or V element, the plain version's
    time and ``scaled_dot_product_attention``'s over the same f32
    tensors; the bf16 branch's time beside it. The f32 branches' option and
    head-dim cases (head dim 256, the softcap, a window, a chunk at an
    offset, ALiBi, the prefix, G > 8) are each bf16 case's f32 twin
    (:func:`_f32_twin`) in ``check_k3``, ``check_k4``, ``check_k6``,
    ``check_k3_options``, ``check_k4_alibi``, ``check_k6_alibi`` and
    ``check_many_heads``."""
    scale = DH ** -0.5
    row = 4 * DH                     # bytes of an f32 K or V row
    # K4: decode at fill 1975
    fill = T_PREFILL
    q = (torch.randn((1, H, DH), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
    caches = _attn_cache(gen, (1, H, S_CACHE, DH), False,
                         _copies(2 * fill * H * row))
    f32 = [tuple(_off_grid(x, gen) for x in c[:2]) for c in caches]
    _biteq("K4", A.flash_decode(q, *caches[0][:2], lengths, scale),
           A.flash_decode(q, *(x.float() for x in caches[0][:2]), lengths,
                          scale))
    rounded = [tuple(x.bfloat16() for x in c) for c in f32]
    _biteq("K4 off the grid", A.flash_decode(q, *rounded[0], lengths, scale),
           A.flash_decode(q, *f32[0], lengths, scale))
    label = f"llama decode fill {fill}, f32 cache"
    case = _attn_case(
        label, "flash_decode_f32", lambda: A.flash_decode(q, *f32[0], lengths,
                                                          scale),
        lambda: A.flash_decode_plain(q, *f32[0], lengths, scale),
        2 * fill * H * row + H * DH * (2 + 4),
        _attn_ops(False, DH, H, fill, False, True), BF16_TOL, L,
        runs=[lambda kv=kv: A.flash_decode(q, *kv, lengths, scale)
              for kv in f32],
        library=[lambda kv=kv: _sdpa(q.float()[:, :, None],
                                     kv[0][:, :, :fill], kv[1][:, :, :fill])
                 for kv in f32])
    F32_BEFORE[("K4_f32", label)] = time_ms(
        [lambda kv=kv: A.flash_decode(q, *kv, lengths, scale)
         for kv in rounded])
    _record(results, "K4_f32", {label: case})
    del q, caches, f32, rounded
    torch.cuda.empty_cache()
    # K3: the 1975-token prefill from position 0
    T = T_PREFILL
    q = (torch.randn((1, T, H, DH), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    c = _attn_cache(gen, (1, H, S_CACHE, DH), False)[0]
    _biteq("K3", A.flash_prefill(q, *c[:2], starts, scale),
           A.flash_prefill(q, *(x.float() for x in c[:2]), starts, scale))
    kf, vf = (_off_grid(x, gen) for x in c[:2])
    kb, vb = kf.bfloat16(), vf.bfloat16()
    _biteq("K3 off the grid", A.flash_prefill(q, kb, vb, starts, scale),
           A.flash_prefill(q, kf, vf, starts, scale))
    qh = q.float().transpose(1, 2)
    label = f"llama {T}-token prefill, f32 cache"
    case = _attn_case(
        label, "flash_prefill_f32",
        lambda: A.flash_prefill(q, kf, vf, starts, scale),
        lambda: A.flash_prefill_plain(q, kf, vf, starts, scale),
        T * H * DH * 2 + 2 * T * H * row + T * H * DH * 4,
        _attn_ops(False, DH, H, _pairs(T, 0), False, False), BF16_TOL, L,
        library=[lambda: _sdpa(qh, kf[:, :, :T], vf[:, :, :T],
                               is_causal=True)])
    F32_BEFORE[("K3_f32", label)] = time_ms(
        [lambda: A.flash_prefill(q, kb, vb, starts, scale)])
    _record(results, "K3_f32", {label: case})
    del q, qh, c, kf, vf, kb, vb
    torch.cuda.empty_cache()
    # K6: the server's batch-8 step over 256-key pages
    ps, fills = 256, SERVER_FILLS
    B, maxp = len(fills), S_CACHE // ps
    P = B * maxp + 1
    table = _server_table(torch.Generator().manual_seed(13), B, maxp, P - 1)
    lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
    q = (torch.randn((B, H, DH), generator=gen, device=DEV)
         * Q_SPREAD).bfloat16()
    c = _attn_cache(gen, (P, H, ps, DH), False)[0]
    _biteq("K6", PA.paged_decode(q, *c[:2], table, lengths, scale),
           PA.paged_decode(q, *(x.float() for x in c[:2]), table, lengths,
                           scale))
    kf, vf = (_off_grid(x, gen) for x in c[:2])
    kb, vb = kf.bfloat16(), vf.bfloat16()
    _biteq("K6 off the grid", PA.paged_decode(q, kb, vb, table, lengths,
                                              scale),
           PA.paged_decode(q, kf, vf, table, lengths, scale))
    kd, vd = (PA.gather_pages(x, table) for x in (kf, vf))
    mask = (torch.arange(maxp * ps, device=DEV)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    n = sum(fills)
    label = f"llama B=8 decode fills {_FILLS8}, f32 pool"
    case = _attn_case(
        label, "paged_decode_f32",
        lambda: PA.paged_decode(q, kf, vf, table, lengths, scale),
        lambda: PA.paged_decode_plain(q, kf, vf, None, None, table, lengths,
                                      scale),
        2 * n * H * row + B * maxp * 4 + B * 4 + B * H * DH * (2 + 4),
        _attn_ops(False, DH, H, n, False, True), BF16_TOL, L,
        library=[lambda: _sdpa(q.float()[:, :, None], kd, vd,
                               attn_mask=mask)])
    F32_BEFORE[("K6_f32", label)] = time_ms(
        [lambda: PA.paged_decode(q, kb, vb, table, lengths, scale)])
    _record(results, "K6_f32", {label: case})
    for key, lab in F32_BEFORE:
        ms = results[key]["cases"][lab]["ms_per_launch"]
        log(f"13c {key} {lab}: {ms:.4f} ms a launch, the bf16 branch over "
            f"the same values rounded {F32_BEFORE[(key, lab)]:.4f} ms "
            f"({ms / F32_BEFORE[(key, lab)]:.3f}x)")
    log(f"13c f32 branches bit-equal to the bf16 branch: {F32_BITEQ}")
    del q, c, kf, vf, kb, vb, kd, vd
    torch.cuda.empty_cache()


F32_NORM_SPREAD = 0.05     # norm weights 1 + N(0, 0.05²): off the bf16 grid
F32_NORM = {}              # 13c: the f32 norm weight read as f32, by case


def _outside_half_step(out, exact):
    """The elements of ``out`` (bf16) farther from ``exact`` (f64) than half
    a bf16 step at ``exact`` plus 2^-16 of it (f32 sums in another order):
    0 when ``out`` is ``exact`` rounded to bf16."""
    step_exp = torch.frexp(exact)[1] - 8          # a bf16 step is 2^this
    bound = torch.ldexp(torch.full_like(exact, 0.5), step_exp) \
        + exact.abs() * 2 ** -16
    return int(((out.double() - exact).abs() > bound).sum())


def check_f32_norm(gen, results):
    """13c: the row-norm kernel and K1's fused ``+rms`` prologue read an f32
    norm weight as f32. At the 7B's rows (K = 4096; M = 1, the server's 8,
    the 1975-token prefill) with a weight 1 + 0.05·N off the bf16 grid: the
    kernel's output and ``rms_norm_plain``'s are each the exact norm (f64)
    rounded to bf16, within half a bf16 step (2^-9 to 2^-8 relative) plus
    2^-16 of it; the kernel over the weight rounded to bf16 must fail that
    bound (the control: a kernel that rounded the weight would). The fused
    route (q4_j 4096 × 4096 to bf16 and the lm_head's 4096 × 32000 to f32,
    M = 1 and 8) bit-equal to ``rms_norm`` then K1, and apart from it over
    the rounded weight."""
    w = 1 + F32_NORM_SPREAD * torch.randn(D, generator=gen, device=DEV)
    wr = w.bfloat16().float()
    if torch.equal(w, wr):
        raise AssertionError("the f32 norm weight sits on the bf16 grid")
    for M in (1, 8, T_PREFILL):
        x = (torch.randn((M, D), generator=gen, device=DEV) * 3).bfloat16()
        x64 = x.double()
        exact = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-5) \
            * w.double()
        before = _cuda.launch_counts()["rms_norm_bf16"]
        out, ctrl = rms_norm(x, w, 1e-5, 0.0), rms_norm(x, wr, 1e-5, 0.0)
        if _cuda.launch_counts()["rms_norm_bf16"] != before + 2:
            raise AssertionError("rms_norm_bf16 was not launched")
        got = dict(kernel=_outside_half_step(out, exact),
                   plain=_outside_half_step(rms_norm_plain(x, w, 1e-5, 0.0),
                                            exact),
                   rounded_weight=_outside_half_step(ctrl, exact), of=M * D)
        F32_NORM[f"rms_norm M={M}"] = got
        if got["kernel"] or got["plain"] or not got["rounded_weight"]:
            raise AssertionError(f"rms_norm M={M}, f32 weight: elements "
                                 f"outside half a bf16 step {got}")
    for N in (D, V):
        odt = torch.float32 if N == V else torch.bfloat16
        qt = to_native(quantize(torch.randn((D, N), generator=gen,
                                            device=DEV) * 0.02,
                                PRESETS["q4_j"]))
        fa = (qt.planes[0], qt.scales, qt.group_size, qt.cfg.bits, odt)
        for M in (1, 8):
            x = torch.randn((M, D), generator=gen, device=DEV).bfloat16()
            before = _cuda.launch_counts()["qmm4_npack_fused+rms"]
            fused = Q.qmm_native_fused(x, *fa, norm=(w, 1e-5, 0.0))
            ctrl = Q.qmm_native_fused(x, *fa, norm=(wr, 1e-5, 0.0))
            if _cuda.launch_counts()["qmm4_npack_fused+rms"] != before + 2:
                raise AssertionError("qmm4_npack_fused+rms was not launched")
            chain = Q.qmm_native(rms_norm(x, w, 1e-5, 0.0), qt.planes[0],
                                 qt.scales, None, qt.group_size, qt.cfg.bits,
                                 odt)
            got = dict(equal=torch.equal(fused, chain),
                       rounded_weight_apart=not torch.equal(ctrl, chain))
            F32_NORM[f"fused rms M={M} {D}x{N}"] = got
            if not all(got.values()):
                raise AssertionError(f"fused rms M={M} {D}x{N}, f32 weight: "
                                     f"{got}")
        del qt
    log(f"13c f32 norm weights read as f32: {json.dumps(F32_NORM)}")
F32_TOL = 5e-2             # phase 5's q4_j copy's (its prefill takes K2)
F32_NEW = 16


def _f32_model(cfg, seed):
    """Random q4_j weights with f32 parameters at rest (``dtype`` float32:
    the embedding, the norms), every norm weight redrawn off the bf16 grid
    (so that reading it rounded would move the logits)."""
    base = init_random(cfg, seed=seed, quant="q4_j", dtype=torch.float32,
                       device=DEV)
    pd = base.param_dict()
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    spread = lambda t: (1.0 + F32_NORM_SPREAD * torch.randn(
        t.shape, generator=gen, device=DEV)).to(t.dtype)
    for lp in pd["layers"]:
        for name in [n for n in lp if n.endswith("norm_w")]:
            lp[name] = spread(lp[name])
    pd["final_norm_w"] = spread(pd["final_norm_w"])
    model = TRANSFORMER.Transformer(cfg, pd)
    w = model.param_dict()["layers"][0]["attn_norm_w"]
    if w.dtype != torch.float32 or torch.equal(w, w.bfloat16().float()):
        raise AssertionError("the f32 model's norm weights sit on the bf16 "
                             "grid")
    return model


def _served_rows(params, cfg, kv_mode, kv_dtype, prompts, n_new):
    """The batch-8 ``ModelServer`` over a ``kv_dtype`` cache answers
    ``prompts`` (``n_new`` greedy tokens each), every token's f32 logits row
    recorded from the decode graph's output (:class:`_SlotRows`): (ids,
    rows) by query."""
    srv = ModelServer(params, cfg, max_batch=8, max_len=S_CACHE,
                      kv_mode=kv_mode, page_size=256, kv_dtype=kv_dtype,
                      sampling=GREEDY_NP)
    try:
        if srv.scheduler.cache.k.dtype != kv_dtype:
            raise AssertionError(f"the server's cache is "
                                 f"{srv.scheduler.cache.k.dtype}")
        rec = _SlotRows(srv.scheduler, set(range(len(prompts))))
        done, _, _ = _serve(srv, prompts, n_new, cfg)
    finally:
        srv.stop()
    return {i: q.output_ids for i, q in done.items()}, rec.rows


def _f32_servers(params):
    """13b: the f32-pool servers against the same servers over a bf16 pool:
    ids and every f32 logits row bit-equal, paged (K6, K3 through the page
    gather) and slots (K4, K3)."""
    prompts = _server_prompts()[:8]
    res = {}
    for mode, attn in (("paged", ("flash_prefill_f32", "paged_decode_f32")),
                       ("slots", ("flash_prefill_f32", "flash_decode_f32"))):
        ids32, rows32 = run_path(
            f"f32_server_{mode}", ("qmm4_npack", "qmm_a8") + attn,
            lambda: _served_rows(params, CFG, mode, torch.float32, prompts,
                                 F32_NEW))
        ids16, rows16 = _served_rows(params, CFG, mode, torch.bfloat16,
                                     prompts, F32_NEW)
        for i in range(len(prompts)):
            _check_served(ids32[i], F32_NEW, f"f32 server {mode}", CFG)
        if ids32 != ids16 or rows32.keys() != rows16.keys():
            raise AssertionError(f"f32 server {mode}: ids {ids32} against "
                                 f"the bf16 pool's {ids16}")
        apart = [k for k in rows32 if not torch.equal(rows32[k], rows16[k])]
        if apart:
            raise AssertionError(f"f32 server {mode}: logits rows {apart} "
                                 "differ from the bf16 pool's")
        log(f"13b ModelServer(kv_dtype=\"float32\", kv_mode={mode!r}), batch "
            f"8, {len(prompts)} queries of {[len(p) for p in prompts]} "
            f"tokens, {F32_NEW} new: ids and all {len(rows32)} f32 logits "
            f"rows bit-equal to the bf16 pool's; query 0 {ids32[0]}")
        res[f"f32_server_{mode}_rows_equal"] = len(rows32)
    return res


def _f32_copy(e2e):
    """13a's 2-layer copy (f32 parameters, norms off the bf16 grid): its
    logits through the kernels against the plain path on the card's own
    tensors, then 13b's StreamingLLM slots over an f32 cache past their
    shift against the plain path."""
    cfg2 = dataclasses.replace(CFG, n_layers=2)
    card = _f32_model(cfg2, seed=61)
    gen = torch.Generator().manual_seed(61)
    ids = torch.randint(3, V, (300,), generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path("f32_copy_generate", GEN_PREFILL, lambda: model.generate(
        ids, max_new_tokens=4, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    worst, provable, _ = _steps_card_vs_plain(card, cfg2, ids, new[:3],
                                              F32_TOL)
    log(f"13a f32 copy (2 layers, full width, 300-token prompt, fed the "
        f"card's ids {new}): logits max err {worst:.3g}·max|logit| (tol "
        f"{F32_TOL}), argmax provably comparable at {provable} of 4 steps, "
        f"equal at all of them")
    if provable < 2:
        raise AssertionError("f32 copy: too few steps with a margin wide "
                             "enough to compare the argmax")
    e2e["f32_copy_card_vs_plain_rel_err"] = worst
    e2e.update({f"f32_{k}": v for k, v in _sched_stream_card_vs_plain(
        card, cfg2, ids, F32_TOL, kv_dtype=torch.float32).items()})
    del card, model
    torch.cuda.empty_cache()


def _cli_files(d):
    """13d's model files: a 2-layer Llama-2-7B-wide Q4_0 GGUF with an SPM
    vocabulary, the NTPU file of a 2-layer f32 q4_j copy, a 2-layer bf16
    HF directory and a 2 + 2-layer Whisper large-v3-wide directory, and a
    seeded WAV and token file."""
    files = {"gguf": os.path.join(d, "m.gguf"),
             "ntpu": os.path.join(d, "m.ntpu"),
             "hf": os.path.join(d, "hf"), "whisper": os.path.join(d, "wh"),
             "wav": os.path.join(d, "a.wav"),
             "ids": os.path.join(d, "ids.npy")}
    write_gguf(files["gguf"], 2, Q4_0_FILE, seed=71, vocab=True)
    cfg2 = dataclasses.replace(CFG, n_layers=2)
    Model().init_params(_f32_model(cfg2, seed=72), cfg2).save(files["ntpu"])
    gen = torch.Generator(device=DEV).manual_seed(73)
    os.makedirs(files["hf"])
    hf = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "hidden_size": D, "intermediate_size": 11008,
          "num_hidden_layers": 2, "num_attention_heads": H,
          "num_key_value_heads": H, "vocab_size": V, "rms_norm_eps": 1e-5,
          "max_position_embeddings": 4096, "rope_theta": 10000.0,
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2, "torch_dtype": "bfloat16"}
    with open(os.path.join(files["hf"], "config.json"), "w") as f:
        json.dump(hf, f)
    cfg_hf = llama.config_from_hf(types.SimpleNamespace(**hf))
    names = {"model.embed_tokens.weight": (V, D),
             "model.norm.weight": (D,), "lm_head.weight": (V, D)}
    for i in range(2):
        for ours, (hf_name, _) in llama.hf_layer_map(i, cfg_hf).items():
            names[hf_name] = (D,) if ours.endswith("norm_w") else \
                {"w_gate": (11008, D), "w_up": (11008, D),
                 "w_down": (D, 11008)}.get(ours, (D, D))
    write_bf16_safetensors(os.path.join(files["hf"], "model.safetensors"),
                           names, gen)
    wcfg = dataclasses.replace(WH_V3, enc_layers=2, dec_layers=2)
    os.makedirs(files["whisper"])
    with open(os.path.join(files["whisper"], "config.json"), "w") as f:
        json.dump({"model_type": "whisper", "vocab_size": wcfg.vocab_size,
                   "d_model": wcfg.d_model,
                   "encoder_attention_heads": wcfg.n_heads,
                   "decoder_attention_heads": wcfg.n_heads,
                   "encoder_layers": 2, "decoder_layers": 2,
                   "num_mel_bins": wcfg.n_mels,
                   "max_source_positions": wcfg.n_audio_ctx,
                   "max_target_positions": wcfg.n_text_ctx,
                   "encoder_ffn_dim": wcfg.ffn_dim,
                   "decoder_ffn_dim": wcfg.ffn_dim,
                   "eos_token_id": wcfg.eos_token_id,
                   "decoder_start_token_id": wcfg.sot_token_id}, f)
    write_bf16_safetensors(os.path.join(files["whisper"],
                                        "model.safetensors"),
                           WH.hf_shapes(wcfg), gen)
    _write_wav(files["wav"], 5.0, seed=13)
    np.save(files["ids"], np.random.default_rng(13).integers(
        3, V, 600).astype(np.int32))
    return files


# 13d: each command-line tool as a user runs it (one process each, all
# started together); accuracy needs lm-eval, which this machine lacks, and
# must say so
def _cli_runs(f, d):
    return {
        "run": ["--model", f["gguf"], "--prompt", "hello world", "-n", "8"],
        "inference": ["--model", f["ntpu"], "--ids", "1,306,400,29",
                      "-n", "8"],
        "quantize": ["--model_file", f["gguf"], "--out_file",
                     os.path.join(d, "q.ntpu"), "--weight_dtype", "int4"],
        "convert": [f["hf"], "--outfile", os.path.join(d, "c.ntpu"),
                    "--outtype", "q4_j"],
        "perplexity": ["--model", f["gguf"], "--ids", f["ids"],
                       "--ctx_size", "256"],
        "accuracy": ["--model", f["gguf"], "--tasks", "piqa"],
        "whisper": ["--model", f["whisper"], "--audio", f["wav"],
                    "--max_new_tokens", "8", "--weight_dtype", "q4_j"],
        "gate": [],
    }


CLI_TIMEOUT = 300.0


def _f32_clis():
    """13d: every CLI on the files of :func:`_cli_files`, on the card, in
    processes of their own started together; each exits 0 (accuracy:
    non-zero, naming lm-eval, when the package is absent) and the gate's
    ratios are printed."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".chip_scratch", "phase13")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t = time.time()
        files = _cli_files(d)
        log(f"13d files written in {time.time() - t:.1f} s")
        t = time.time()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"neural_tpu_torch.cli.{name}", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for name, argv in _cli_runs(files, d).items()}
        outs, res = {}, {}
        try:
            for name, p in procs.items():
                out, err = p.communicate(timeout=CLI_TIMEOUT)
                outs[name] = (p.returncode, out, err)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        has_lm_eval = importlib.util.find_spec("lm_eval") is not None
        for name, (rc, out, err) in outs.items():
            last = (out.strip().splitlines() or [""])[-1]
            log(f"13d python -m neural_tpu_torch.cli.{name}: exit {rc}; "
                f"{last[:300]}")
            refused = name == "accuracy" and not has_lm_eval
            if refused:
                if rc == 0 or "lm-eval" not in err:
                    raise AssertionError(f"cli accuracy without lm-eval: "
                                         f"exit {rc}\n{err[-2000:]}")
            elif rc != 0:
                raise AssertionError(f"cli {name}: exit {rc}\n{out[-2000:]}"
                                     f"\n{err[-3000:]}")
            res[f"cli_{name}_exit"] = rc
        ratios = json.loads(outs["gate"][1].strip().splitlines()[-1])
        log(f"13d the accuracy gate on the card: PPL ratios {ratios} "
            "(against baselines/accuracy.json, tol 0.10: passed)")
        res["gate_ratios"] = ratios
        log(f"13d the eight tools in {time.time() - t:.1f} s")
        return res
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_f32(results):
    """Phase 13: (13c) the f32-cache branches where phase 3 did not run
    them; (13a) Llama-2-7B at full width and depth with f32 parameters at
    rest, and its 2-layer copy against the plain path; (13b) the batch-8
    server over f32 pools against bf16 pools, and StreamingLLM slots over an
    f32 cache; (13d) the command-line tools and the gate."""
    t0 = time.time()
    e2e = {}
    if "K4_f32" not in results:
        check_f32_attention(torch.Generator(device=DEV).manual_seed(13),
                            results)
        check_f32_norm(torch.Generator(device=DEV).manual_seed(14), results)
    t = time.time()
    params = _f32_model(CFG, seed=60)
    model = Model().init_params(params, CFG)
    gen = torch.Generator().manual_seed(60)
    prompt = torch.randint(3, V, (T_PREFILL,), generator=gen).tolist()
    out = run_path("f32_generate", GEN_PREFILL, lambda: model.generate(
        prompt, max_new_tokens=F32_NEW, do_sample=False,
        stop_at_eos=False)[0])
    _check_ids(out[T_PREFILL:], F32_NEW, "f32 7B generate")
    e2e["f32_generate_ids"] = out[T_PREFILL:]
    log(f"13a Llama-2-7B q4_j with f32 parameters (norms off the bf16 "
        f"grid), {T_PREFILL}-token prompt: greedy ids {out[T_PREFILL:]} "
        f"({time.time() - t:.1f} s with the load)")
    e2e.update(_f32_servers(params))
    del params, model
    torch.cuda.empty_cache()
    _f32_copy(e2e)
    e2e.update(_f32_clis())
    log(f"phase 13: {time.time() - t0:.1f} s")
    return e2e


# ---------------------------------------------------------------------------


KERNEL_META = {
    # results key: (C entry point, source, TPU kernel it replaces)
    "K1": ("qmm4_npack", "neural_tpu_torch/csrc/qmm4_npack.cu",
           "neural_tpu/ops/qmatmul.py:619"),
    "K2": ("qmm_a8", "neural_tpu_torch/csrc/qmm_a8.cu",
           "neural_tpu/ops/qmatmul.py:161"),
    "K3": ("flash_prefill", "neural_tpu_torch/csrc/flash_prefill.cu",
           "neural_tpu/ops/attention.py:433"),
    "K3_i8": ("flash_prefill_i8", "neural_tpu_torch/csrc/flash_prefill.cu",
              "neural_tpu/ops/attention.py:433"),
    "K4": ("flash_decode", "neural_tpu_torch/csrc/flash_decode.cu",
           "neural_tpu/ops/attention.py:110"),
    "K4_i8": ("flash_decode_i8", "neural_tpu_torch/csrc/flash_decode.cu",
              "neural_tpu/ops/attention.py:110"),
    "K6": ("paged_decode", "neural_tpu_torch/csrc/paged_decode.cu",
           "neural_tpu/ops/paged_attention.py:31"),
    "K6_i8": ("paged_decode_i8", "neural_tpu_torch/csrc/paged_decode.cu",
              "neural_tpu/ops/paged_attention.py:31"),
    "K5": ("qmm_general", "neural_tpu_torch/csrc/qmm_general.cu",
           "neural_tpu/ops/qmatmul.py:485"),
    # K5's two routes, counted apart (``qmm_general+gemv`` / ``+tc``)
    "K5_gemv": ("qmm_general+gemv", "neural_tpu_torch/csrc/qmm_general.cu",
                "neural_tpu/ops/qmatmul.py:485"),
    "K5_tc": ("qmm_general+tc", "neural_tpu_torch/csrc/qmm_general.cu",
              "neural_tpu/ops/qmatmul.py:485"),
    "K1_asym": ("qmm4_npack_asym", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int2": ("qmm2_npack", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int2_asym": ("qmm2_npack_asym", "neural_tpu_torch/csrc/qmm4_npack.cu",
                     "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8": ("qmm8_native", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8_asym": ("qmm8_native_asym",
                     "neural_tpu_torch/csrc/qmm4_npack.cu",
                     "neural_tpu/ops/qmatmul.py:619"),
    # K1's fusion options (``fuse``, :633-701): the nibble entry's
    # branches, and the int2 and int8-code fused entries
    **{f"K1_{b}": (f"qmm4_npack_fused+{b}",
                   "neural_tpu_torch/csrc/qmm4_npack.cu",
                   "neural_tpu/ops/qmatmul.py:619")
       for b in ("rms", "res", "glu")},
    "K1_int2_fused": ("qmm2_npack_fused",
                      "neural_tpu_torch/csrc/qmm4_npack.cu",
                      "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8_fused": ("qmm8_native_fused",
                      "neural_tpu_torch/csrc/qmm4_npack.cu",
                      "neural_tpu/ops/qmatmul.py:619"),
    "K2_asym": ("qmm_a8_asym", "neural_tpu_torch/csrc/qmm_a8.cu",
                "neural_tpu/ops/qmatmul.py:161"),
    "K2_act": ("quantize_act_i8", "neural_tpu_torch/csrc/qmm_a8.cu",
               "neural_tpu/ops/qmatmul.py:161"),
    # the unfused graph's RMS norm on K1's row-scale routine: no Pallas
    # kernel; it replaces the XLA-fused norm of the JAX package
    "RMS": ("rms_norm_bf16", "neural_tpu_torch/csrc/rms_norm.cu",
            "neural_tpu/ops/norms.py:15 (XLA-fused, no pl.pallas_call)"),
    # the option branches, counted apart (``entry+branch`` launches)
    "K3_alibi": ("flash_prefill+alibi",
                 "neural_tpu_torch/csrc/flash_prefill.cu",
                 "neural_tpu/ops/attention.py:433"),
    "K3_i8_alibi": ("flash_prefill_i8+alibi",
                    "neural_tpu_torch/csrc/flash_prefill.cu",
                    "neural_tpu/ops/attention.py:433"),
    "K3_prefix": ("flash_prefill+prefix",
                  "neural_tpu_torch/csrc/flash_prefill.cu",
                  "neural_tpu/ops/attention.py:433"),
    "K3_i8_prefix": ("flash_prefill_i8+prefix",
                     "neural_tpu_torch/csrc/flash_prefill.cu",
                     "neural_tpu/ops/attention.py:433"),
    "K4_alibi": ("flash_decode+alibi", "neural_tpu_torch/csrc/flash_decode.cu",
                 "neural_tpu/ops/attention.py:110"),
    "K4_i8_alibi": ("flash_decode_i8+alibi",
                    "neural_tpu_torch/csrc/flash_decode.cu",
                    "neural_tpu/ops/attention.py:110"),
    "K6_alibi": ("paged_decode+alibi",
                 "neural_tpu_torch/csrc/paged_decode.cu",
                 "neural_tpu/ops/paged_attention.py:31"),
    "K6_i8_alibi": ("paged_decode_i8+alibi",
                    "neural_tpu_torch/csrc/paged_decode.cu",
                    "neural_tpu/ops/paged_attention.py:31"),
    # K2's other weight layouts, and decode past 8 query heads a KV head
    **{key: (entry, "neural_tpu_torch/csrc/qmm_a8.cu",
             "neural_tpu/ops/qmatmul.py:161")
       for key, entry, _, _ in K2_LAYOUTS},
    **{f"K4{s}_G>8": (f"flash_decode{s}+G>8",
                      "neural_tpu_torch/csrc/flash_decode.cu",
                      "neural_tpu/ops/attention.py:110") for s in ("", "_i8")},
    **{f"K6{s}_G>8": (f"paged_decode{s}+G>8",
                      "neural_tpu_torch/csrc/paged_decode.cu",
                      "neural_tpu/ops/paged_attention.py:31")
       for s in ("", "_i8")},
    # the f32-cache branches (the TPU kernels' astype(bf16) of an f32 block)
    "K3_f32": ("flash_prefill_f32", "neural_tpu_torch/csrc/flash_prefill.cu",
               "neural_tpu/ops/attention.py:433 (f32 KV: :502, :530-532)"),
    "K4_f32": ("flash_decode_f32", "neural_tpu_torch/csrc/flash_decode.cu",
               "neural_tpu/ops/attention.py:110 (f32 KV: :190-191, "
               ":213-214)"),
    "K6_f32": ("paged_decode_f32", "neural_tpu_torch/csrc/paged_decode.cu",
               "neural_tpu/ops/paged_attention.py:31 (f32 KV: "
               "attention.py:190-191, :213-214)"),
}


def attn_times(reps=30, seed=7):
    """Device ms of one K3 launch at the Llama-2-7B 1975-token prefill and
    one K4 launch at fill 1975 of 2048 (32 heads of 128, batch 1), bf16
    and int8 KV, inputs drawn from ``seed``; each the median of ``reps``
    CUDA-graph replays of 8 launches (K4 over 8 copies of its cache, so
    that the 50 MB L2 holds none). Self-contained: ``--ab`` runs this
    source in each tree, so the per-kernel gain is read on one card."""
    import statistics
    import torch
    from neural_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, Dh, S, T = 32, 128, 2048, 1975

    def cache(int8):
        k = torch.randn((1, H, S, Dh), generator=gen, device="cuda")
        v = torch.rand((1, H, S, Dh), generator=gen, device="cuda") * 2 - 1
        if int8:
            (k, ks), (v, vs) = A.quantize_kv(k), A.quantize_kv(v)
            return k, v, ks, vs
        return k.bfloat16(), v.bfloat16()

    def device_ms(fns):
        for f in fns:
            f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for f in fns:
                f()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / len(fns))
        return statistics.median(ts)

    out = {}
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    lengths = torch.full((1,), T, dtype=torch.int32, device="cuda")
    for int8 in (False, True):
        sfx = "_int8" if int8 else "_bf16"
        c0 = cache(int8)
        q = (torch.randn((1, T, H, Dh), generator=gen, device="cuda")
             * 4).bfloat16()
        k3 = A.flash_prefill_i8 if int8 else A.flash_prefill
        out["k3_1975" + sfx + "_ms"] = device_ms(
            [lambda: k3(q, *c0, starts, Dh ** -0.5)] * 8)
        caches = [c0] + [cache(int8) for _ in range(7)]
        q1 = (torch.randn((1, H, Dh), generator=gen, device="cuda")
              * 4).bfloat16()
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        out["k4_fill1975" + sfx + "_ms"] = device_ms(
            [lambda c=c: k4(q1, *c, lengths, Dh ** -0.5) for c in caches])
        del caches, c0, q, q1
        torch.cuda.empty_cache()
    return out


def k16_times(reps=30, seed=9):
    """Device ms of one K1 and one K6 launch at the Llama-2-7B decode
    shapes, inputs drawn from ``seed``, each the median of ``reps``
    CUDA-graph replays over copies of the weights or pool that the 50 MB
    L2 cannot hold: K1 over q4_j nibbles at M = 1 and 8 (a 4096 x 4096
    product; gate/up's 4096 x 11264 with the RMS-norm prologue; down's
    11264 x 4096 with the residual); K6 at the server's step (B = 8, fills
    1-2048, page 256, 32 heads over 32), bf16 and int8 pools, and at 48
    heads over 1. Self-contained: ``--ab`` runs this source in each tree,
    so the per-kernel gain is read on one card."""
    import math
    import statistics
    import torch
    from neural_tpu_torch.core.dtypes import PRESETS
    from neural_tpu_torch.core.qtensor import quantize, to_native
    from neural_tpu_torch.ops import attention as A
    from neural_tpu_torch.ops import paged_attention as PA
    from neural_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator(device="cuda").manual_seed(seed)
    copies = lambda nbytes: max(1, math.ceil(2 * (50 << 20) / nbytes))

    def device_ms(fns):
        for f in fns:
            f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for f in fns:
                f()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / len(fns))
        return statistics.median(ts)

    out = {}
    for K, N, opt in ((4096, 4096, None), (4096, 11264, "rms"),
                      (11264, 4096, "res")):
        qt = to_native(quantize(torch.randn((K, N), generator=gen,
                                            device="cuda") * 0.02,
                                PRESETS["q4_j"]))
        ws = [(qt.planes[0].clone(), qt.scales.clone())
              for _ in range(copies(qt.planes[0].numel()))]
        for M in (1, 8):
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            if opt is None:
                fns = [lambda w=w: Q.qmm_native(x, w[0], w[1], None, 128, 4,
                                                torch.bfloat16) for w in ws]
            else:
                kw = dict(res=torch.randn((M, N), generator=gen,
                                          device="cuda").bfloat16()) \
                    if opt == "res" else dict(norm=((1 + 0.3 * torch.randn(
                        K, generator=gen, device="cuda")).bfloat16(), 1e-5,
                        0.0))
                fns = [lambda w=w: Q.qmm_native_fused(
                    x, w[0], w[1], 128, 4, torch.bfloat16, **kw) for w in ws]
            name = f"k1_{K}x{N}" + ("" if opt is None else "_" + opt)
            out[f"{name}_m{M}_ms"] = device_ms(fns)
        del ws, qt
    cpu = torch.Generator().manual_seed(seed)
    fills, ps, D = [1, 2048, 1975, 128, 700, 1300, 33, 1024], 256, 128
    B, maxp = len(fills), 2048 // ps
    P = B * maxp + 1
    table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32).to("cuda")
    lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    for Hq, Hkv, int8 in ((32, 32, False), (32, 32, True), (48, 1, False)):
        q = (torch.randn((B, Hq, D), generator=gen, device="cuda")
             * 4).bfloat16()
        k = torch.randn((P, Hkv, ps, D), generator=gen, device="cuda")
        v = torch.rand((P, Hkv, ps, D), generator=gen, device="cuda") * 2 - 1
        if int8:
            (k, ks), (v, vs) = A.quantize_kv(k), A.quantize_kv(v)
            fn = lambda: PA.paged_decode_i8(q, k, v, ks, vs, table, lengths,
                                            D ** -0.5)
        else:
            k, v = k.bfloat16(), v.bfloat16()
            fn = lambda: PA.paged_decode(q, k, v, table, lengths, D ** -0.5)
        out[f"k6_server_{Hq}over{Hkv}{'_int8' if int8 else ''}_ms"] = \
            device_ms([fn] * 4)
        del q, k, v
        torch.cuda.empty_cache()
    return out


AB_CHILD = """\
import json, os, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as c
from neural_tpu_torch.ops import _cuda
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(os.cpu_count() or 1)
_cuda.build_all(_cuda.KERNELS)
{attn_times}
print("ATT " + json.dumps(attn_times()), flush=True)
{k16_times}
print("K16 " + json.dumps(k16_times()), flush=True)
params = c.init_random(c.CFG, seed=0, quant="q4_j", device="cuda")
legs = c.phase_generation(params)
legs.update({"server_" + k: v for k, v in c._server_timed(
    params, c.CFG, "server_paged_int8", c.SERVE_PAGED_I8,
    c._server_prompts()).items()})
del params
torch.cuda.empty_cache()
legs.update(c.phase_formats(("nf4", "q4_0")))
print("AB " + json.dumps(legs), flush=True)
{k2_errors}
print("ERR " + json.dumps(k2_errors()), flush=True)
"""


def compare_legs(parent):
    """``python3 chip_smoke.py --ab PARENT``: K3 at the Llama-2-7B 1975-token
    prefill and K4 at fill 1975, bf16 and int8 KV (``attn_times``, this
    file's source run in each tree), K1 at M = 1 and 8 (plain, +rms, +res)
    and K6 at the server's step (bf16, int8, 48 heads over 1;
    ``k16_times``, the same way), phase 4's Llama-2-7B legs (decode at
    fills 128 and 1975, decode_i8kv, batch8, TTFT; the decode step's
    device time by fusion mode), the batch-8 paged int8 server (tok/s, the
    decode iteration at 8 slots, TTFT) and phase 4b's nf4 and
    q4_0 legs (TTFT, decode at fill 128) of the checkout at PARENT (an
    unpacked tree of an earlier commit) and of this one, each run in a
    process of its own, in the order parent, change, change, parent, on
    the same card; prints each run and, per leg, the change's mean over
    the parent's; then K2's largest difference from its plain version per
    entry point (``k2_errors``, this file's source run in each tree) on
    both."""
    import inspect
    log(f"nvidia-smi: {smi_line()}")
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    errs = {}
    child = AB_CHILD.replace("{k2_errors}", inspect.getsource(k2_errors)) \
        .replace("{attn_times}", inspect.getsource(attn_times)) \
        .replace("{k16_times}", inspect.getsource(k16_times))
    for side in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if side == "parent" else here
        p = subprocess.run([sys.executable, "-c",
                            child.replace("{root!r}", repr(root))],
                           cwd=root, capture_output=True, text=True,
                           timeout=1200)
        if p.returncode:
            raise AssertionError(f"{side} ({root}) legs failed:\n"
                                 f"{p.stderr[-4000:]}")
        lines = p.stdout.splitlines()
        legs = json.loads(next(line for line in lines
                               if line.startswith("AB "))[3:])
        legs.update(json.loads(next(line for line in lines
                                    if line.startswith("ATT "))[4:]))
        legs.update(json.loads(next(line for line in lines
                                    if line.startswith("K16 "))[4:]))
        errs[side] = json.loads(next(line for line in lines
                                     if line.startswith("ERR "))[4:])
        log(f"{side}: {json.dumps(legs)}")
        runs[side].append(legs)
    log(f"K2 max |kernel - plain| per entry point, change: "
        f"{json.dumps(errs['change'])}; parent: {json.dumps(errs['parent'])}")
    mean = lambda side, k: statistics.mean(r[k] for r in runs[side])
    print(json.dumps({"change_over_parent": {
        k: mean("change", k) / mean("parent", k) for k in runs["parent"][0]
        if mean("parent", k)}}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--ab"]:
        return compare_legs(sys.argv[2])
    if sys.argv[1:2] == ["--convert-child"]:
        return convert_child(sys.argv[2])
    only = {"--phase7": ("7 model files", phase_model_files),
            "--phase8": ("8 zoo", phase_zoo),
            "--phase9": ("9 moe", phase_moe),
            "--phase10": ("10 parallel", phase_parallel),
            "--phase11": ("11 nocache", phase_nocache),
            "--phase12": ("12 whisper", phase_whisper),
            "--phase13": ("13 f32", phase_f32)}.get(
                sys.argv[1] if sys.argv[1:] else None)
    # the slice's main path: every phase runs the fused decode path, which
    # the library leaves off by default (``models.transformer.fuse_mode``);
    # the A/B and the unfused references set the switches themselves
    os.environ.setdefault("NTPU_FUSED_DECODE", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    t_start = time.time()
    seconds = {}

    def phase(name, fn, *args):
        t = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    smi, name, bw = phase("1 device", phase_device)
    build_s = phase("2 build", _cuda.build_all, _cuda.KERNELS)
    for k in _cuda.KERNELS:
        k.load()
    log(f"built {[k.source for k in _cuda.KERNELS]} in {build_s:.1f} s")

    results = {}
    if only:
        e2e = phase(*only, results)
        log(json.dumps({"e2e": e2e, "phase_seconds": seconds,
                        "seconds": time.time() - t_start}))
        return
    gen = torch.Generator(device=DEV).manual_seed(0)

    def kernels():
        for check in (check_k1, check_k2, check_k3, check_k4, check_k6,
                      check_k6_paging, check_k3_options, check_k4_alibi, check_k6_alibi,
                      check_k5, check_k1_branches, check_k1_fused,
                      check_k1_reruns, check_rms_norm, check_k2_asym,
                      check_k2_layouts, check_gptq_products,
                      check_many_heads, check_whisper_kernels,
                      check_f32_attention, check_f32_norm):
            check(gen, results)
            torch.cuda.empty_cache()
    phase("3 kernels", kernels)
    log("K3/K4 cases slower than the kernel they replace: "
        + ("; ".join(f"{k} {lab}: {ms:.4f} ms against {old} ms"
                     for k, lab, ms, old in ATTN_SLOWER) or "none"))
    log("K1/K6 cases slower than before the redesign: "
        + ("; ".join(f"{k} {lab}: {ms:.4f} ms against {old} ms"
                     for k, lab, ms, old in K16_SLOWER) or "none"))
    window = window_speedups(results)
    branches = branch_costs(results)
    t = time.time()
    params = init_random(CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    log(f"init_random Llama-2-7B q4_j on the card: {time.time() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    e2e = phase("4 generation", phase_generation, params)
    e2e.update(phase("4i sampling", phase_sampling, params))
    e2e.update(phase("4b formats", phase_formats))
    e2e.update(phase("4c gemma2", phase_gemma2))
    bloom_e2e, bloom_params = phase("4d bloom", phase_bloom)
    e2e.update(bloom_e2e)
    e2e.update(phase("6b bloom server", phase_bloom_server, bloom_params))
    del bloom_params
    torch.cuda.empty_cache()
    e2e.update(phase("4e chatglm", phase_chatglm))
    e2e.update(phase("4f mistral gptq", phase_mistral_gptq))
    e2e.update(phase("4g formats", phase_formats,
                     ("int6_g128_a8", "mix_i2_ffn")))
    e2e.update(phase("4h tinyllama", phase_tinyllama))
    worst, sched_worst, fused_worst, formats_worst = phase(
        "5 card vs plain", phase_card_vs_plain)
    gemma2_worst = phase("5b gemma2 card vs plain",
                         phase_gemma2_card_vs_plain)
    zoo_worst = phase("5c zoo card vs plain", phase_zoo_card_vs_plain)
    copies_worst = phase("5d copies card vs plain",
                         phase_copies_card_vs_plain)
    e2e.update(phase("6 server", phase_server, params))
    e2e.update(phase("6c serving beyond greedy", phase_serving_beyond_greedy,
                     params))
    del params
    torch.cuda.empty_cache()
    e2e.update(phase("7 model files", phase_model_files, results))
    e2e.update(phase("8 zoo", phase_zoo, results))
    e2e.update(phase("9 moe", phase_moe, results))
    e2e.update(phase("10 parallel", phase_parallel, results))
    e2e.update(phase("11 nocache", phase_nocache, results))
    e2e.update(phase("12 whisper", phase_whisper, results))
    e2e.update(phase("13 f32", phase_f32, results))

    kernels = []
    for kid, (kname, src, repl) in KERNEL_META.items():
        r = results[kid]
        err = max(c["err"] for c in r.get("cases", {"": r}).values())
        by_path = {p: c[kname] for p, c in LAUNCHES.items() if c[kname]}
        if not by_path:
            raise AssertionError(f"{kname} was launched on no main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": r["per"], "ok": True,
            **({"chain_ms": r["chain_ms"]} if "chain_ms" in r else {}),
            **({"cases": r["cases"]} if "cases" in r else {})})
    log(json.dumps({"e2e": e2e, "copy_tb_s": bw / 1e12,
                    "card_vs_plain_rel_err": worst,
                    "sched_card_vs_plain_rel_err": sched_worst,
                    "formats_card_vs_plain_rel_err": formats_worst,
                    **fused_worst,
                    **gemma2_worst, **zoo_worst, **copies_worst,
                    "window_over_no_window": window,
                    "k1_reruns": K1_RERUN,
                    "k16_slower": K16_SLOWER,
                    "option_on_over_off": branches,
                    "f32_bit_equal": F32_BITEQ,
                    "f32_norm": F32_NORM,
                    "phase_seconds": seconds,
                    "seconds": time.time() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
