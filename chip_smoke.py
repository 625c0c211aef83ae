#!/usr/bin/env python3
"""Run the PyTorch port (``any4_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N] [--phase evals|tensor_parallel]

Phases, each printing JSON lines:

1. setup: the card's ``nvidia-smi`` name and power limit, the torch and CUDA
   versions, and the time to build the CUDA kernels from
   ``any4_tpu_torch/ops/csrc`` with nvcc (one process per source, in
   parallel); then two ``ptxas`` lines: the registers and spill bytes of each
   instantiation of the tensor-core bodies (kernels A, B, C, E,
   ``int8_post`` and ``int8_fused``; the four W4A8/W8A8 kernels, with the
   fused ones' pre-pass) from nvcc's ``-Xptxas -v`` report.
2. kernels: kernel A (``q4_lut_post``, g=128) and kernel B
   (``q4_lut_fused``, g=64) at m in {1, 8, 16, 128, 512} (512: the
   ``FUSED_M_MAX`` prefill chunk), at Llama-3.2-1B's linear shapes, each
   held against its plain PyTorch version on the card (bf16 output within
   1e-2 * max|plain|; float32 output within 1e-4 * max, kernel A's at
   m=128, kernel B's at every m), with its time (CUDA events,
   median, the L2 emptied by reading a 128 MB buffer before each launch;
   kernel A also with the buffer written, ``ms_dirty_l2``), the plain
   version's time, one ``torch.matmul`` on the dequantized bf16 weight as a
   yardstick (``library_ms``, both ways for kernel A; the port never calls
   it) and the least time the card could take (``bound_ms``). Kernel A
   also at the fused projections' shapes (n 3072 and 16384, k 2048, m in
   {1, 8, 128, 512}) and at the quantized tied head's (n 128256, m in {1,
   8}; checked at 130 too, each row of m = 8 and 130 equal to the row
   alone), with its launch plan (``kernel_fused_shapes``). Then both
   kernels on edge cases (odd n and k, a misaligned x, float32/float16
   outputs, a global LUT) against their plain versions; kernel A at m in
   {3, 9, 17, 130}, n in {24, 1000}, g = 128 and 256, k = 2048 and 1004,
   per-row and global LUTs, three output types, x aligned and misaligned
   by one element; and kernel A's bit equalities at three 1B shapes whose
   k is split: each row of a batch of 8, 16 and 130 gives the bits of that
   row alone (the decode body against the block body), and two calls give
   the same bits. The same bit equalities for kernel C and ``int8_post``,
   which run on kernel A's bodies, for D and ``w8a8`` on int8 x, which
   run on their own pair of tensor-core bodies, and for D-fused and
   ``w8a8_fused`` on bf16 and float32 x (m = 8, 16, 33 and 64) on the same
   bodies, and for B (g=64 with per-row LUTs, g=128 with the int4 ramp), E
   (g=128, per-row LUTs) and ``int8_fused`` (g=64 and g=128), which run on
   kernel A's bodies (``post_bit_equal``); B's and ``int8_fused``'s edge
   cases at g in {16, 32, 64, 128, 256} and E's at g in {128, 256}, as C's
   below with n = 130, k = 1408 as well and, for B and E, per-row and
   global LUTs; the identity weight quantized to any4 at g=64
   through B on the card gives x back bit for bit at m in {1, 4, 130}
   (``fused_identity``); then ``fused_equals_external``: at the 1B
   shapes, m in {1, 8, 16, 64}, bf16 and float32 x, float32 and bf16
   outputs, ``w4a8_fused(x)`` gives the bits of ``(w4a8(xq) * sx).to(out)``
   with ``xq, sx = quantize_activations(x)``, and ``w8a8_fused`` those of
   ``w8a8``'s. C's, ``int8_post``'s, D's and ``w8a8``'s edge cases as
   kernel A's, with g = 256 (two slices a group), int8
   codes of -128, and int8 x for D and ``w8a8`` (float32 within 1e-5 *
   max: exact integer dots) (``post_edge_cases``); and ``int8_post``,
   ``w8a8`` and ``w8a8_fused`` with one group a row, as the row-scale
   formats give it them (g = ``padded_k(k)``, scales ``[1, n]``, k in
   {1024, 1408, 2048, 8192}).
3. attention_kernel: the four decode-attention kernels
   (``flash_paged_decode``/``_q8``, ``flash_contig_decode``/``_q8``) at the
   1B serving shapes (8 kv heads, rep 4, head_dim 64, page size 16, bf16 q)
   for b in {1, 8} at a context of 2048 and b=8 at 8192, each held against
   its plain version (bf16 pools within 1e-2 * max, int8 pools within
   2e-2 * max, one float32 case each within 1e-4 * max), timed as in 2,
   beside one ``scaled_dot_product_attention`` over a prebuilt dense bf16
   view as the yardstick, with the split length S (``kv_cache.split_len``),
   the splits and the blocks of each launch; then edge cases (a seq_len of
   1, seq_len equal to the bucket, one not a multiple of the page size,
   S - 1, S, S + 1 and 0, an inactive slot on the sink page, head_dim 128),
   and each kernel at two buckets over the same pools and lengths, which
   must give the same bits (several live splits; one live split against
   several).
4. main path: Llama-3.2-1B at full width and all 16 layers (``--layers``
   cuts the depth), bf16 weights from ``init_params(seed=0)``, quantized by
   ``quantize_model(fmt="any4", group_size=128, kmeans_iters=10)``; its
   prefill logits with float32 activations are held within 2e-2 * max of
   the dequantized weights' dense float32 forward, and
   ``generate`` runs a seeded 64-token prompt for 64 greedy tokens at batch 1
   and 4. Kernel A must launch exactly 112 times (16 layers x 7 linears) per
   forward; the dense bf16 model's decode figures are printed beside.
   Then one forward over a 1024-token prompt with ``linear``'s prefill
   chunks at 256, 512 (``FUSED_M_MAX``) and 1024 rows (host ms). The same
   entry points at g=64, which run kernel B, come in phase 8.
5. serving: the same any4 model behind ``serving.engine.Engine`` (8 slots,
   max_ctx 2048, page size 16) serves 12 seeded prompts of 16-1000 tokens
   for 32 new tokens each, in each of paged/contig x bf16/int8 pools, once
   with ``run(burst=1)`` and once with ``run(burst=8, pipeline=True)``.
   Checks: every request gives 32 tokens in the vocabulary; the
   combination's attention kernel launches 16 x (decode steps), the other
   three 0, kernel A 112 x (decode steps + prefill chunks of up to
   ``FUSED_M_MAX`` rows); both runs give the same tokens; and a
   teacher-forced decode step with float32 activations over the engine's
   pool is within 2e-2 * max (5e-2 for int8 pools) of ``decode_step`` over
   a dense float32 cache at 3 positions. Prints tokens per second, ms per
   decode step, prefill ms, peak memory and the device's busy share
   (``torch.profiler`` over 8 steps at 8 active slots), with the attention
   and the linear kernels' device ms per step. Each decode step after a
   key's first is a replay of the engine's CUDA graph, which credits the
   launches its capture counted; in the profiled steps (at least one a
   replay) the port's kernels in the device trace, name by name
   (``gemv.DEVICE_KERNELS``, ``kv_cache.DEVICE_KERNELS``), are checked
   equal to the launches the counters gained. Each run prints its decode
   steps and how many were replays.
5b. the fused model with a quantized tied head (``main_path_fused_qemb``,
   ``serving_fused_qemb``): phase 4's linears with the table quantized as
   ``quantize_model(..., quantize_embeddings=True)`` quantizes it (any4,
   g=128, the row layout; quantized alone, the linears keeping their
   seeds), then ``fuse_projections``. Every layer holds ``qkv_proj`` and
   ``gateup_proj``; kernel A launches exactly 65 times a forward (16 x 4
   and the head; per 512-row chunk of a 1024-token prompt) and nothing
   else; prefill logits with float32 activations within 2e-2 * max of the
   dense float32 forward of the dequantized weights (table included, for
   the lookup and the head), and within 1e-2 * max of the same model
   unfused. ``generate`` at batch 1 and 4 with phase 4's figures, then the
   engine (paged bf16 pools, the prompts of 5) at ``run(burst=1)`` and
   ``run(burst=8, pipeline=True)``: equal tokens, kernel A 65 x (decode
   steps + prefill chunks), the teacher-forced step within 2e-2 * max, and
   5's figures, printed beside the unfused model's from 4 and 5.
6. int kernels (slice 3): kernel C (``q4_int4_magic``), D (``w4a8``,
   int8 x), D-fused (``w4a8_fused``) and E (``q4_lut_select``, with the
   int4 ramp LUT and with a per-row LUT), g=128, at the 1B linear shapes,
   C at m in {1, 8, 16, 128, 512}, D at {1, 8, 16, 128, 512, 1024} (the
   W4A8 prefill's chunk), D-fused at {1, 8, 16, 32, 64}, E at {1, 8, 16,
   128},
   timed and held against their plain versions as in 2: bf16 outputs
   within 1e-2 * max, float32 within 1e-4 * max (C, E) and 1e-5 * max (D,
   D-fused: exact integer dots); E equal to kernel B bit for bit. Then edge
   cases: n not a multiple of 8 with k = 1408 and 1407, x misaligned by one
   element, float32 x for D-fused, an all-zero x row (the 1e-8 floor), a
   row whose x / sx lands on k + 0.5 (D-fused bit-equal to
   ``quantize_activations``, which rounds half to even, then D), and
   float32, bf16 and float16 outputs.
7. int8 kernels (slice 4): ``w8a8`` (int8 x) at m in {1, 8, 16, 128, 512,
   1024}, ``int8_post`` (g=128) and ``int8_fused`` (g=64) at {1, 8, 16,
   128, 512}, ``w8a8_fused`` at {1, 8, 16, 32, 64} (g=128), at the 1B
   linear shapes with random int8 codes (-128 included), timed and held
   against their plain versions as in 2: bf16 outputs within 1e-2 * max,
   float32 within 1e-5 * max (``w8a8``, ``w8a8_fused``: exact integer
   dots) and 1e-4 * max (``int8_post``, ``int8_fused``, at every m). Then
   edge cases as in 6 (rows of codes at -128, n not a multiple of 8 with k =
   1408 and 1407, a misaligned x, the 1e-8 floor, half-way ties,
   ``int8_fused`` at g = 16, 64 and 256, three output types), the identity
   weight through ``int8_fused`` at g = 128 (row layout) and 64 (x back bit
   for bit at m = 1, 4 and 130: the decode body and the block body), and
   any4q8's LUT snap on the card against the CPU's (equal).
8. any4 at g=64, int4, w4a8 and int8 at g=64 main paths: the 1B model at
   full width and depth (int4, w4a8 and int8 g=64 at 4 layers,
   ``MAIN_DEPTHS``; ``--layers`` cuts every one) quantized by
   ``quantize_model(fmt="any4", group_size=64, kmeans_iters=10)``,
   ``quantize_model(fmt="int8", group_size=64)`` or
   ``quantize_model(fmt=..., group_size=128)``; every one of the 112
   linears must be ``any4`` (g=64, kernel B), ``int8`` (g=64,
   ``int8_fused``), ``int4p`` or ``w4a8``. The any4, int8 g=64 and int4
   models' prefill logits with float32 activations are held within 2e-2 *
   max of the dequantized weights' dense float32 forward. In the
   w4a8 model's prefill (float32 activations; m=16 runs D-fused, m=128
   runs D) every linear is held within 1e-5 * max of the same linear on the
   CPU through the plain versions, which quantize the activations the same
   way, on the activations the card gave it; the whole-model difference
   from the CPU forward is printed beside (one int8 code flipped by a 1e-7
   difference elsewhere moves an activation by 1/127 of its row's absmax,
   so that difference measures flips). ``generate`` at batch 1 and 4 as in
   4, with
   exact launch counts: B (any4 g=64; kernel A never), ``int8_fused`` (int8
   g=64; ``int8_post`` never) and C once per linear per forward (per
   512-row chunk);
   D-fused once per linear per forward of at most 64 rows, D once per
   linear per larger forward (per ``_int8_m_tile(k)`` chunk above 1024
   rows); then one forward over a 1024-token prompt as in 4 (host ms, best
   of 3). Then each model behind the engine (paged bf16 pools, the prompts
   of 5) at ``run(burst=1)`` and ``run(burst=8, pipeline=True)``: tokens in
   the vocabulary, both runs equal, exact launch counts, and the figures of
   5; for any4 and int8 at g=64 also the teacher-forced decode step of 5
   (within 2e-2 * max).
9. int8, w8a8 and any4q8 main paths (slice 4), as in 8: the 96 k = 2048
   linears are ``int8q``/``w8a8q``/``any4q8`` and the 16 down_projs
   ``int8g``/``w8a8g``/``any4q8g`` (any4q8 with kmeans_iters=10; int8 and
   w8a8 at 4 layers, any4q8 at 2, ``MAIN_DEPTHS``). int8's
   prefill logits are held as int4's, w8a8's and any4q8's linears as
   w4a8's. Launches per forward: at m <= 64, 112 ``int8_post``, or 96
   ``w8a8_fused`` + 16 ``w8a8``; at 64 < m <= 128, 112 ``int8_post`` or 112
   ``w8a8``; above, 96 per chunk (``FUSED_M_MAX`` rows for int8,
   ``_int8_m_tile(k)`` for w8a8) and down_proj dequantized. int8 and w8a8
   then behind the engine as in 8.
9b. mx4 (``quant_methods["mx4"]``, g=32) at full width and depth: every
   linear ``mx4`` on kernel B, logits as int4's, ``generate`` at batch 1
   with 112 B launches a forward; a weight group poisoned to NaN gives NaN
   in its output row only, on the card as on the CPU, at m = 1, 8, 130.
   Then ``int8r``, ``w8a8r`` and ``any4q8r`` (kmeans_iters=10) at full
   width and 2 layers, as in 9: every linear at g = k; 112 ``int8_post``
   a forward for ``int8r``, 112 ``w8a8_fused`` (m <= 64) or ``w8a8`` for
   the others; int8r's logits held as int8's, the others' linears as
   w8a8's.
10. select path: row-layout int4 at g=128, full width and depth
    (``--layers`` cuts it): ``llama.forward(..., use_gather=False)`` runs
    kernel E on every linear, the default runs kernel B with the ramp LUT
    (not kernel A), and the logits of the two (a 16-token prefill and a
    1-token forward) are equal bit for bit.
11. int8 layouts (2 layers, one prefill of 128 rows): ``w8a8`` with
    ``layout="row"``, ``w8a8q``, ``w8a8t`` and ``w8a8g`` run ``w8a8`` on
    the same codes and give bit-equal logits; ``int8q``, ``int8t``,
    ``int8g`` and ``int8p`` run ``int8_post`` and give bit-equal logits;
    ``int8`` with ``layout="row"`` (g=128) runs ``int8_fused`` on every linear, within
    2e-2 * max of the dense float32 forward with float32 activations (int8
    at g=64 runs at full depth in 8); exact launch counts.
12. Mixtral-8x7B and OPT-125m. First kernel A alone at Mixtral's expert
    weights (``kernel_mixtral_shapes``: w1/w3 14336 x 4096, w2 4096 x
    14336, w13 28672 x 4096, stacked ``moe_w13`` 229376 x 4096 and
    ``moe_w2`` 4096 x 114688) at m in {1, 8, 512}, held against its plain
    version (over blocks of 16384 rows) as in ``kernel_fused_shapes`` and
    timed beside a bf16 ``torch.matmul`` and the bytes bound; and
    ``flash_paged_decode`` at Mixtral's attention shape (8 kv heads, rep 4,
    head_dim 128, b=8, ctx 2048), held within 1e-2 * max (float32 1e-4)
    and timed against SDPA. Then ``main_path_mixtral``: the published
    config.json widths of mistralai/Mixtral-8x7B-v0.1 (d 4096, FFN 14336,
    32 q / 8 kv heads of 128, 8 experts, top 2, vocab 32000, rope_theta
    1e6, an untied bf16 ``lm_head``) read by
    ``loader._mixtral_cfg_from_hf`` and cut to 2 layers, bf16 weights from
    ``mixtral.init_params(seed=0)``, any4 at g=128 (kmeans_iters=10; the
    router and ``lm_head`` stay bf16). Prefill logits with float32
    activations within 2e-2 * max of the dense float32 forward; four b=1
    decode steps give the same bits with sparse dispatch (20 kernel A
    launches a forward: 4 attention linears and 2 experts x 3 a layer) as
    with dense (56); ``generate`` at batch 1 and 4 with exactly those
    counts (prefills dense), its figures, and a 1024-token forward (56
    launches a 512-row chunk). ``serving_mixtral``: the engine as in 5
    (paged bf16 pools; dense dispatch a decode step, so 56 launches a step
    and a prefill chunk), burst 1 and burst 8 + pipeline equal, the
    teacher-forced step within 2e-2 * max. ``mixtral_fused_stacked``: the
    model fused (``fuse_projections``) and fused then stacked
    (``stack_experts``), each quantized: logits within 2e-2 * max of their
    dense float32 forwards, 12 and 8 kernel A launches a b=1 decode step.
    ``main_path_opt``: OPT-125m at full width and depth, any4 at g=128
    (72 linears, unfused), logits as above, forwards of 64 and 1024 tokens
    at b=1 and 4 with exactly 72 kernel A launches a 512-row chunk, and
    their host and device ms beside the bf16 model's.
13. AWQ, calibration and nnq. ``awq_main_path``: the 1B model at full
    width and depth (``--layers`` cuts it), bf16 weights from
    ``init_params(seed=0)``, 128 seeded calibration tokens:
    ``run_awq(numeric_type="int")`` -> ``calibrate`` ->
    ``quantize_model(fmt="any4", group_size=128, sample_weight=...,
    kmeans_iters=10)`` -> ``generate`` at b=1 (112 kernel A launches a
    forward). Checks: the searched scales applied to a float32 copy (no
    clip) within 1e-4 * max of the unscaled float32 logits; the quantized
    logits with float32 activations within 2e-2 * max of the dense float32
    forward; layer 0's q/k/v scale search on the card within 1e-5
    relative of the same search on the CPU, with the same ratio (or MSEs
    within 1e-6 of each other) and the ratio ``run_awq`` chose. Prints
    ``awq_s``, ``calibrate_s``, ``quantize_s``, every ratio, b=1 decode
    ms (host and device) and the logit error against the bf16 original
    with and without AWQ. ``awq_any4_search``: ``numeric_type="any4"``
    at 2 layers (seconds a layer, peak memory, neutrality).
    ``nnq_path``: 2 layers, ``quantize_model(..., nnq=True,
    nnq_args={"objective": "y_mse", "steps": 200})``: each layer's summed
    ``y_mse`` (on the activations ``learn_lut`` drew) no worse than the
    k-means LUTs' of the same seeds, logits as above, ``generate`` b=1.
    ``calibrate_fn_path``: 2 layers, ``quantize_model(calibrate_fn=
    make_calibrate_fn(...))`` equal bit for bit to
    ``quantize_model(sample_weight=calibrate(...))`` with PyTorch's
    deterministic kernels (also reported without them). ``awq_mixtral``:
    phase 12's Mixtral weights, ``run_awq`` (the router in the experts'
    group) -> any4 -> phase 12's logit and router checks -> ``generate``
    at b=1 (20 kernel A a sparse step). ``awq_opt``: OPT-125m, neutrality
    as above, any4, a 64-token forward (72 launches).
14. cli_tools: the port's measuring tools and scripts
    (``any4_tpu_torch/utils.py``, ``profiler.py``, ``cli/``). (a)
    ``cli_tools_kxk``: ``microbenchmark.sweep``, the reference's 1xK . KxK
    table at m = 1, K = N in {1024, ..., 8192}: bf16 ``x @ w.T``, int4
    (kernel C), nf4 and any4 (kernel A; kmeans_iters=4) in 12 interleaved
    rounds of 20 calls (CUDA events, the L2 emptied before each call), the
    best round of each; every quantized call first held against its
    kernel's plain version (bf16 within 1e-2 * max), exact launch counts.
    (b) ``cli_microbenchmark``: ``microbenchmark.main`` at K = N = 4096, m =
    1, for each of its ten ``--quantize`` choices, each row's
    ``linear.linear(x, qt)`` first held against the same call on CPU copies
    (the plain versions; bf16 within 1e-2 * max, and float32 x within 1e-5
    * max for w4a8 and w8a8), with the kernels that ran and their exact
    launches (any4/nf4/fp4: A, int4/int4p: C, w4a8: D-fused, mx4: B,
    int8/int8p: ``int8_post``, w8a8: ``w8a8``). (c) phase 4's bf16 and any4 models (parked on the
    host since phases 4 and 5b), full width and depth:
    ``benchmark.decode_tokens_per_s`` at b=1, a 32-token prompt, 64 new
    tokens, equal to ``generate``'s tokens, kernel A 112 x 257 forwards
    for any4 and nothing for bf16 (``cli_benchmark``); then
    ``profile_decode_components`` over the any4 model at ctx 256 with
    exactly 4 A launches an attention call and 3 an MLP call
    (``cli_profile``); model sizes and ``device_memory_stats``
    (``cli_memory``). (d) ``cli_scripts``: the quantize (``--tiny --awq
    --calibrate --group-size 64``), calibrate and example scripts on the
    card; the quantize checkpoint loads back through
    ``load_params(device="cuda")`` with the in-memory model's logits bit
    for bit; ``benchmark --tiny --profile --max-new-tokens 8``: its JSON
    fields and exact A and B launches.
15. evals (``any4_tpu_torch/evals``, ``cli/{eval,analyze,diff}.py``) on
    phase 4's bf16 and any4 models, back on the card. (a) ``evals_ppl``:
    ``harness.run_perplexity_tasks(..., synthetic=True, seqlen=2048,
    max_chunks=4)`` with the chunked evaluator, then the stream one (its 8
    windows over the harness's 2 pseudo-documents), each log-perplexity
    within 1e-4 relative of the same evaluator over the dequantized
    float32 model (``to_float32(..., dequantize=True)``, no kernel), and
    each target token's log-prob in the 4 chunks within 0.2 nats of that
    model's (``evals_ppl_tokens``); kernel A exactly 112 x
    ``ceil(t / FUSED_M_MAX)`` a forward of t tokens (4 chunks x 4 calls of
    512 rows x 112) and nothing else; ``seconds``,
    ``tokens_scored_per_s`` (target tokens over seconds, ending in a
    synchronize), peak memory and, from ``torch.profiler`` over one chunk,
    the device's busy share, after one untimed chunk (the run's first
    2048-token forward, timed apart). (b) ``evals_lm_protocol``:
    ``TorchCausalLM(qparams, cfg, ByteTokenizer(), batch_size=8,
    max_length=2048)``: 16 seeded ``loglikelihood`` requests of 1-2100
    bytes (an empty context, an empty continuation, one truncated): with
    float32 activations on the same quantized weights, batched within
    1e-3 relative of one at a time; in bf16, batched within 5e-3 of one at
    a time (bf16 logits move by an ulp with the batch's shape, and 16
    random layers carry that to about 1e-3) and within 2e-2 of the
    dequantized float32 model; ``loglikelihood_rolling`` of 4500 bytes (3
    windows) within 2e-5 of its windows scored one by one;
    ``generate_until`` with ``max_gen_toks=32`` giving ``generate``'s
    greedy tokens exactly; ``local_mc`` and the builtin code tasks (64
    tokens) run and give their fields (their accuracies on random weights
    are printed, not held); kernel A's exact launches for each, the code
    tasks' from each generation's prompt and token counts.
    (c) ``evals_analyze``: ``analyze_model`` over the bf16 model's first 2
    layers (14 weights; int4, nf4, any4 with kmeans_iters=10), each any4
    ``w_mse`` at or below int4's; ``write_plots`` where matplotlib is
    installed (a non-empty ``plots.pdf``); ``diff_models`` of those layers
    against their pseudo-any4 copy (every row printed) and against
    themselves (MSE 0). (d) ``evals_cli``: ``cli.eval --tiny --quantize
    any4 --tasks synthetic --seqlen 128 --max-chunks 2 --lm-eval-tasks
    local_mc --code-tasks builtin`` (kernel A for down_proj, B six times
    as often for the k = 64 linears), ``cli.analyze --tiny`` and
    ``cli.diff --tiny`` on the card: their files and JSON keys.
16. tensor_parallel (``parallel/tp.py``): first kernel A at every rank's
    weight shape of the paths below that no earlier phase holds
    (``TP_SHAPES``: the 1B's q/k/v/o/gate/up/down at tp=2, its k/v and
    o_proj (k = 512, one 1024 segment) at tp=4, Mixtral's k/v and w1/w3/w2
    at tp=2) at m = 1, 8 and 64, against its plain version (bf16 output
    within 1e-2 * max, float32 within 1e-4), timed as in the Mixtral-shape
    phase (``kernel_a_tp_shapes`` rows); each attention kernel at 4 and 2
    kv heads (a rank's at tp=2 and 4; ``split_len`` changes with h) at b=1
    and 8, ctx 2048, against its plain version as in phase 3
    (``attention_tp_heads`` rows); a dense bf16 product's float32 output
    (``torch.mm``'s ``out_dtype``, as a dense row-parallel weight gives its
    partial) within 1e-5 * max of the float32 product. Then ranks spawned
    on the one card
    (``torch.multiprocessing``, spawn start method, gloo: NCCL refuses two
    ranks on one device, and gloo all-reduces CUDA tensors; dp stays 1,
    since gloo has no CUDA ``all_gather``), after the build. The parent
    quantizes the any4 g=128 1B (full width, ``--layers`` cuts the depth)
    once with ``row_parallel_shards=2`` and once with ``=4``, with
    PyTorch's deterministic kernels (k-means' sums in a fixed order, so
    every run holds the same checkpoint and its gaps repeat; ``--phase
    tp_sums`` reads other draws), saves each through ``models/checkpoint``
    (every rank loads that one checkpoint) and runs the
    unsharded reference: the S-segment weights on the full x
    (``linear._shard_align_x``). Each rank loads the checkpoint, takes its
    shards (``tp.shard_params``) and runs ``tp.make_tp_forward``: a 64-token
    prompt's logits within 2e-2 * max of the reference's in bf16 and with
    float32 activations (kernel A rounds x to bf16, so an f32 sum order
    moves a rounding), and within 1e-4 * max over the rank's dequantized
    float32 shards (the same f32 path on both sides: only the sum order
    differs), kernel A exactly 112 times a forward, at tp=2 and tp=4
    (tp=4: o_proj's k = 512 padded to a 1024 segment). At tp=2 also 32 greedy tokens (the prompt's forward with the
    tp group, then 31 cached steps), equal to ``generate``'s on the
    unsharded model or split at a near-tie by ``tests/test_torch_engine.py``
    's QUANT_TIE rule, their teacher-forced logits within 2e-2 * max; each
    rank's host ms a decode step, device ms a step (``torch.profiler``) and
    all-reduce ms a step (32 all-reduces, timed between synchronizes): two
    ranks share one card, so these are no scaling figures; the TP
    ``Engine`` (8 slots, phase 5's 12 prompts, 32 tokens each, ``run(burst=
    1)``) in each pool (paged and contig, bf16 and int8): equal tokens on
    every rank
    (the engine checks each read), exact launches (A 112 a forward, the
    attention kernel 16 a step), the teacher-forced decode logits of its
    ``_decode_impl`` within 2e-2 (bf16 pools) and 5e-2 (int8) * max of the
    single engine's. Then the 2-layer Mixtral-8x7B (any4, w2 and o_proj in
    2 segments, ``torch.save``'d once) at tp=2: ``make_tp_forward(forward_fn=
    mixtral.forward)`` in sparse dispatch over one token (2 experts a
    layer) and in dense dispatch over the 64-token prompt, bf16 logits and
    float32-activation logits (each routed as the unsharded run) within
    2e-2 and the dequantized float32 weights' logits within 1e-4 * max of
    the unsharded forward's, kernel A's launches equal to its (20 and 56);
    stacked experts at tp=2 raise ``ValueError``. ``tensor_parallel``,
    ``tensor_parallel_mixtral`` and ``tensor_parallel_summary`` rows.
17. native (``any4_tpu_torch/native``): ``available()`` on the card's host;
    ``group_quantize`` and ``pack_int4`` bit for bit against the torch
    functions on the card at 8192x2048 and 14336x4096, each timed beside
    the torch CPU path on the same numpy array; ``cli.quantize --cpu --fmt
    int4 --tiny`` takes the host path and gives the device path's codes
    for the same weights.
18. the script's wall time, the ``nvidia-smi`` name and power line again,
    then the line ``{"kernels": [...]}``, one entry per kernel (fourteen;
    the ten linear kernels, all on the tensor cores, also ``by_m``; kernel
    A also ``fused_shapes``, ``mixtral_shapes``, ``tp_shapes`` and ``kxk``,
    kernel C ``kxk``, each attention kernel ``tp_heads`` and
    ``flash_paged_decode`` ``mixtral_shape``; launches summed over
    the main paths that run the kernel, as ``launches_from`` lists them).
19. ``{"ok": true, "device": {...}}`` as the last line.

``--phase evals`` runs phase 15 alone after the build, on phase 4's models
made as there, and ``--phase tensor_parallel`` phases 16 and 17; each
prints its lines and the ``nvidia-smi`` line, with no kernels line and no
result. ``--phase tp_sums`` (run in no other way) reads the spread of the
1B's TP logits gap from the unsharded run over 3 checkpoints a tp size,
with the ranks' partial sums in float32 (the port's) and in bf16 (the JAX
package's ``psum``): ``tp_sums`` rows.

Any failed check raises, and the script exits non-zero before the last line.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the kernels' timer; tools/torch_*.py reach it as chip_smoke.Timer
from any4_tpu_torch.utils import Timer

# H100 data-sheet peaks (SXM part, dense, at the 700 W limit); the PCIe
# part has its own. bytes/s, bf16 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100": (3.35e12, 989e12)}
KERNEL_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
# one Llama-3.2-1B decoder layer: q, k, v, o, gate, up, down
LAYER_LINEARS = {(2048, 2048): 2, (512, 2048): 2, (8192, 2048): 2,
                 (2048, 8192): 1}
KERNELS = {
    "q4_lut_post": dict(group_size=128, ms=(1, 8, 16, 128, 512), replaces=(
        "any4_tpu/ops/pallas/gemv.py:230 _q4t_kernel; "
        "any4_tpu/ops/pallas/gemv.py:172 _q4post_kernel")),
    "q4_lut_fused": dict(group_size=64, ms=(1, 8, 16, 128, 512), replaces=(
        "any4_tpu/ops/pallas/gemv.py:106 _q4_kernel")),
}
SOURCE = "any4_tpu_torch/ops/csrc/q4_lut_gemv.cu"
W4A8_SOURCE = "any4_tpu_torch/ops/csrc/w4a8_gemv.cu"
# slice 3: name -> (source, the TPU kernel it replaces, m of the kernel phase)
INT_KERNELS = {
    "q4_int4_magic": (SOURCE, "any4_tpu/ops/pallas/gemv.py:457 "
                      "_q4pair_kernel", (1, 8, 16, 128, 512)),
    "w4a8": (W4A8_SOURCE, "any4_tpu/ops/pallas/gemv.py:502 _w4a8_kernel",
             (1, 8, 16, 128, 512, 1024)),
    "w4a8_fused": (W4A8_SOURCE, "any4_tpu/ops/pallas/gemv.py:550 "
                   "_w4a8f_kernel", (1, 8, 16, 32, 64)),
    "q4_lut_select": (SOURCE, "any4_tpu/ops/pallas/gemv.py:63 "
                      "_q4select_kernel", (1, 8, 16, 128)),
}
# slice 4: name -> (source, the TPU kernels it replaces, m of the kernel
# phase, group size)
INT8_KERNELS = {
    "w8a8": (W4A8_SOURCE, "any4_tpu/ops/pallas/gemv.py:650 _w8a8_kernel; "
             "any4_tpu/ops/pallas/gemv.py:685 _w8a8q_kernel; "
             "any4_tpu/ops/pallas/gemv.py:799 _w8a8t_kernel",
             (1, 8, 16, 128, 512, 1024), 128),
    "w8a8_fused": (W4A8_SOURCE, "any4_tpu/ops/pallas/gemv.py:612 "
                   "_w8a8f_kernel; any4_tpu/ops/pallas/gemv.py:725 "
                   "_w8a8qf_kernel; any4_tpu/ops/pallas/gemv.py:838 "
                   "_w8a8tf_kernel", (1, 8, 16, 32, 64), 128),
    "int8_post": (SOURCE, "any4_tpu/ops/pallas/gemv.py:765 _int8q_kernel; "
                  "any4_tpu/ops/pallas/gemv.py:878 _int8t_kernel",
                  (1, 8, 16, 128, 512), 128),
    "int8_fused": (SOURCE, "any4_tpu/ops/pallas/gemv.py:913 _int8_kernel",
                   (1, 8, 16, 128, 512), 64),
}
INT8_OPS = 1979e12               # H100 SXM dense int8 tensor-core rate
# kernel A at the fused projections' and the quantized tied head's shapes
# (n, k) -> m timed; the head is also checked at m = 130 (a block body)
FUSED_SHAPES = {(3072, 2048): (1, 8, 128, 512),      # qkv_proj
                (16384, 2048): (1, 8, 128, 512),     # gateup_proj
                (128256, 2048): (1, 8)}              # the tied head
HEAD_CHECK_MS = (1, 8, 130)
# one forward of the fused model with the quantized tied head: 4 linears a
# layer, then the head
FUSED_PER_LAYER = 4
PROMPT_LEN = 64
NEW_TOKENS = 64
# decode attention: (layout, int8 pool, the TPU kernel it replaces)
ATTN_KERNELS = {
    "flash_paged_decode": ("paged", False, (
        "any4_tpu/serving/kv_cache.py:259 _flash_decode_kernel")),
    "flash_paged_decode_q8": ("paged", True, (
        "any4_tpu/serving/kv_cache.py:233 _flash_decode_kernel_q")),
    "flash_contig_decode": ("contig", False, (
        "any4_tpu/serving/kv_cache.py:461 _flash_contig_kernel")),
    "flash_contig_decode_q8": ("contig", True, (
        "any4_tpu/serving/kv_cache.py:470 _flash_contig_kernel_q")),
}
ATTN_SOURCE = "any4_tpu_torch/ops/csrc/flash_decode.cu"
ATTN_HEADS, ATTN_REP, ATTN_HEAD_DIM, PAGE_SIZE = 8, 4, 64, 16   # 1B serving
ATTN_CASES = ((1, 2048), (8, 2048), (8, 8192))   # (slots, context)
ATTN_TIMED = (8, 2048)           # the shape the kernels line reports
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores
# profiler kernel names of the linear kernels (SOURCE's tensor-core bodies,
# int8_fused's included; W4A8_SOURCE's bodies, their pre-pass included)
LINEAR_KERNEL_NAMES = ("q4_post_mma", "a8_mma")
SERVE_SLOTS, SERVE_MAX_CTX = 8, 2048
SERVE_REQUESTS, SERVE_NEW_TOKENS = 12, 32
# mistralai/Mixtral-8x7B-v0.1's published config.json (the keys that set
# its shape), read through the port's loader; cut to MIXTRAL_LAYERS layers
MIXTRAL_8X7B = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "tie_word_embeddings": False, "hidden_act": "silu",
    "sliding_window": None, "num_local_experts": 8,
    "num_experts_per_tok": 2}
MIXTRAL_LAYERS = 2
# kernel A alone at Mixtral's expert weights, (n, k), at MIXTRAL_MS
MIXTRAL_SHAPES = {"w1_w3": (14336, 4096), "w2": (4096, 14336),
                  "w13": (28672, 4096), "moe_w13": (229376, 4096),
                  "moe_w2": (4096, 114688)}
MIXTRAL_MS = (1, 8, 512)
# AWQ and calibration: cli_quantize.py's 128 seeded calibration tokens (its
# choice without a tokenizer); the 2-layer phases' depth
CALIB_TOKENS = 128
AWQ_CUT_LAYERS = 2
# two grid MSEs this close (relative) are a tie: either ratio may win
SEARCH_TIE = 1e-6
# the cli_tools phase: the K x K sweep's kernels; the kernel each
# single-format row runs at K = N = 4096, m = 1 (int8 and w8a8 as int8g and
# w8a8g there, on int8_post and on w8a8 after quantize_activations)
KXK_KERNELS = {"int4": "q4_int4_magic", "nf4": "q4_lut_post",
               "any4": "q4_lut_post"}
MICRO_ROUTES = {"any4": "q4_lut_post", "nf4": "q4_lut_post",
                "fp4": "q4_lut_post", "int4": "q4_int4_magic",
                "int4p": "q4_int4_magic", "w4a8": "w4a8_fused",
                "mx4": "q4_lut_fused", "int8": "int8_post",
                "int8p": "int8_post", "w8a8": "w8a8"}
BENCH_PROMPT, BENCH_NEW_TOKENS, PROFILE_CTX = 32, 64, 256
# the benchmark script's run on its tiny model, and the fields of its line
TINY_NEW_TOKENS = 8
BENCH_KEYS = {"baseline_tok_s", "any4_tok_s", "speedup",
              "model_bytes_baseline", "model_bytes_quantized",
              "profile_baseline", "profile_quantized", "device"}
# the evals phase: the synthetic perplexity run (window, chunks of the
# chunked evaluator), the LM protocol's requests and tokens, the analysis
# depth. Its bars against the dequantized float32 model: the
# log-perplexity (relative) and each target token's log-prob (absolute,
# nats); the LM protocol's: float32 activations batched against one at a
# time (BATCH_BAR), bf16 batched against one at a time (BF16_BATCH_BAR),
# bf16 against the float32 model (LL_F32_BAR), the rolling score against
# its windows one by one (ROLL_BAR), all relative. Each sits 3-4x above
# the worst of six or more full-width readings on an H100, LL_F32_BAR
# 7.6x, as PERF.md sets out
EVAL_SEQLEN, EVAL_CHUNKS = 2048, 4
PPL_BAR, PPL_TOKEN_BAR = 1e-4, 0.2
BATCH_BAR, BF16_BATCH_BAR, LL_F32_BAR, ROLL_BAR = 1e-3, 5e-3, 2e-2, 2e-5
LL_BATCH, ROLLING_BYTES, GEN_TOKENS, CODE_TOKENS = 8, 4500, 32, 64
# (context bytes, continuation bytes) of the 16 loglikelihood requests:
# an empty context, an empty continuation, one truncated to max_length
LL_LENGTHS = [(0, 3), (1, 1), (5, 8), (17, 2), (40, 20), (64, 5), (100, 1),
              (200, 12), (333, 4), (511, 30), (700, 7), (1000, 2),
              (1500, 9), (1990, 40), (2100, 6), (30, 0)]
ANALYZE_LAYERS = 2
EVAL_RESULTS = {"synthetic:wikitext-2", "lm-eval:local_mc", "code:builtin"}
# the tensor_parallel phase: the tp sizes the 1B runs at (each with its
# weights packed in as many row segments), greedy tokens at tp=2, decode
# steps timed; its bars against the unsharded run (bf16 logits, float32
# activations), the engine's (bf16 pools, int8 pools), the tie rule's share
# of max|logit| (tests/test_torch_engine.py), the TP engine's pools, and
# how long the ranks may take
TP_SIZES, TP_NEW_TOKENS, TP_TIMED_STEPS = (2, 4), 32, 8
TP_BAR, TP_F32_BAR = 2e-2, 1e-4
ENGINE_BARS = {False: 2e-2, True: 5e-2}
QUANT_TIE = 1e-2
TP_POOLS = (("paged", False), ("paged", True), ("contig", False),
            ("contig", True))
TP_TIMEOUT_S = 900
# kernel A at every rank's weight shape on the tensor-parallel paths that
# no earlier phase holds (n, k): the 1B's at tp=2 and 4 (o_proj's k = 512
# padded to one 1024 segment), Mixtral-8x7B's at tp=2; at TP_MS rows
TP_SHAPES = {"q_tp2": (1024, 2048), "kv_tp2": (256, 2048),
             "o_tp2": (2048, 1024), "gate_up_tp2": (4096, 2048),
             "down_tp2": (2048, 4096), "kv_tp4": (128, 2048),
             "o_tp4": (2048, 512), "mixtral_kv_tp2": (512, 4096),
             "mixtral_w1_w3_tp2": (7168, 4096),
             "mixtral_w2_tp2": (4096, 7168)}
TP_MS = (1, 8, 64)
# the attention kernels at a rank's kv heads: 4 at tp=2, 2 at tp=4
TP_HEADS = (4, 2)
# the tp_sums phase: checkpoints quantized a tp size, each read twice in
# each partial-sum dtype
TP_SUM_CHECKPOINTS = 3
# main paths cut in depth to keep the whole run well inside its limit (the
# kernels meet every 1B shape in the kernel phases and the full-depth
# paths of phases 4, 5, 8 and 9b); any4q8 runs w8a8's kernels
MAIN_DEPTHS = {"int8_g64": 4, "int4": 4, "w4a8": 4, "int8": 4, "w8a8": 4,
               "any4q8": 2}
# the native phase: the 1B's gate/up and Mixtral-8x7B's w1/w3 shapes
NATIVE_SHAPES = ((8192, 2048), (14336, 4096))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def kernel_phase(gemv, packing, linear, timer, dirty, bw, peak):
    """Kernels A and B at the 1B linear shapes; kernel A and its
    ``library_ms`` are timed a second time with the L2 emptied by writing
    (``dirty``); float32 outputs are held within 1e-4 * max, kernel A's at
    m=128, kernel B's at every m."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, spec in KERNELS.items():
        g = spec["group_size"]
        wrapper = getattr(gemv, name)
        plain = getattr(gemv, name + "_plain")
        for n, k in KERNEL_SHAPES:
            codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                                  dtype=torch.uint8)
            lut = torch.sort(torch.rand((n, 16), generator=gen,
                                        device="cuda"), dim=1).values
            lut = (lut * 15.0 - 8.0).contiguous()
            G = packing.padded_k(k) // g
            scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 \
                + 1e-3
            zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
            qt = linear.QuantizedTensor(packing.pack_codes(codes), scales,
                                        zeros, lut, "any4", g, (n, k))
            w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
            args = (qt.packed, qt.scales, qt.zeros, qt.lut, g)
            for m in spec["ms"]:
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                y = wrapper(x, *args, torch.bfloat16)
                ref = plain(x, *args, torch.bfloat16)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(y).all()), f"{name} finite")
                check(err <= 1e-2 * scale,
                      f"{name} n={n} k={k} m={m}: |kernel - plain| {err} > "
                      f"1e-2 * {scale}")
                nbytes = (qt.packed.numel() * 4 + 2 * G * n * 4 + n * 16 * 4
                          + m * k * 2 + m * n * 2)
                flops = 2 * m * n * k
                t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
                row = {
                    "phase": "kernel", "name": name, "n": n, "k": k, "m": m,
                    "group_size": g,
                    "ms": timer(lambda: wrapper(x, *args, torch.bfloat16)),
                    "plain_ms": timer(lambda: plain(x, *args, torch.bfloat16),
                                      reps=5),
                    "library_ms": timer(lambda: torch.matmul(x, w_bf16.t())),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops,
                    "max_abs_err": err, "rel_err": err / scale,
                }
                if name == "q4_lut_post":
                    row["ms_dirty_l2"] = dirty(
                        lambda: wrapper(x, *args, torch.bfloat16))
                    row["library_ms_dirty_l2"] = dirty(
                        lambda: torch.matmul(x, w_bf16.t()))
                if name != "q4_lut_post" or m == 128:
                    f32 = rel_err(wrapper(x, *args, torch.float32),
                                  plain(x, *args, torch.float32))
                    check(f32 <= 1e-4, f"{name} n={n} k={k} m={m} "
                          f"float32: {f32} > 1e-4")
                    row["f32_rel_err"] = f32
                row["gb_per_s"] = nbytes / row["ms"] / 1e6
                row["bound_share"] = row["bound_ms"] / row["ms"]
                emit(row)
                rows.append(row)
            del qt, w_bf16
    return rows


def kernel_a_fused_shapes(gemv, packing, linear, timer, bw, peak):
    """Kernel A (g=128, per-row LUT) at :data:`FUSED_SHAPES`: the fused
    qkv_proj and gateup_proj and the quantized tied head (n = 128256, 2004
    row blocks of 64). Each is held against its plain version (bf16 output
    within 1e-2 * max, float32 within 1e-4 * max) at its timed m and, for
    the head, at m = 1, 8 and 130, with the launch plan printed; the head's
    rows at m = 8 and 130 give the bits of each row alone (float32). Timed
    as in the kernel phase, beside a bf16 ``torch.matmul`` on the
    dequantized weight."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(15)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wrapper, plain = gemv.q4_lut_post, gemv.q4_lut_post_plain
    for (n, k), ms in FUSED_SHAPES.items():
        head = n == 128256
        codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                              dtype=torch.uint8)
        lut = torch.sort(torch.rand((n, 16), generator=gen, device="cuda"),
                         dim=1).values * 15.0 - 8.0
        G = packing.padded_k(k) // 128
        scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 \
            + 1e-3
        zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
        qt = linear.QuantizedTensor(packing.pack_codes(codes), scales, zeros,
                                    lut.contiguous(), "any4", 128, (n, k))
        del codes
        w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
        args = (qt.packed, qt.scales, qt.zeros, qt.lut, 128)
        for m in sorted(set(ms) | set(HEAD_CHECK_MS if head else ())):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            errs, abs_err = {}, {}
            for out, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
                y = wrapper(x, *args, out)
                ref = plain(x, *args, out)
                errs[str(out)] = rel_err(y, ref)
                abs_err[str(out)] = float((y.float() - ref.float()).abs()
                                          .max())
                del ref
                check(bool(torch.isfinite(y).all()) and errs[str(out)] <= tol,
                      f"kernel A n={n} k={k} m={m} {out}: {errs[str(out)]} > "
                      f"{tol} of max")
            if head and m > 1:
                for i in range(m):
                    check(same_bits(wrapper(x[i:i + 1], *args, torch.float32),
                                    y[i:i + 1]),
                          f"kernel A head m={m}: row {i} differs alone")
            tn, per, split_blocks, floats, ints = gemv.post_launch_plan(
                "q4_lut_post", m, n, k, G, 128, sms)
            row = {"phase": "kernel_fused_shapes", "name": "q4_lut_post",
                   "n": n, "k": k, "m": m, "group_size": 128,
                   "rel_err": errs, "rows_alone_equal": head and m > 1,
                   "plan": {"token_tiles": tn, "groups_per_split": per,
                            "split_blocks": split_blocks,
                            "scratch_floats": floats, "counters": ints}}
            if m in ms:
                nbytes = (qt.packed.numel() * 4 + 2 * G * n * 4 + n * 16 * 4
                          + m * k * 2 + m * n * 2)
                t_bytes = nbytes / bw * 1e3
                t_ops = 2 * m * n * k / peak * 1e3
                row.update({
                    "ms": timer(lambda: wrapper(x, *args, torch.bfloat16)),
                    "plain_ms": timer(lambda: plain(x, *args, torch.bfloat16),
                                      reps=3, warmup=1),
                    "library_ms": timer(lambda: torch.matmul(x, w_bf16.t())),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations", "bytes": nbytes,
                    "max_abs_err": abs_err[str(torch.bfloat16)]})
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
            emit(row)
        del qt, w_bf16
        torch.cuda.empty_cache()
    return rows


def kernel_a_edge_cases(gemv, packing):
    """Kernel A on shapes the 1B path does not give it: m in {3, 9, 17,
    130} (not multiples of 8, across the token tiles), n in {24, 1000} (not
    multiples of 16; n = 24 splits k into one group a split), k = 2048 and
    1004 (not a multiple of 8), g = 128 and 256, per-row and global LUTs, float32 (1e-4 * max),
    bf16 and float16 (1e-2 * max) outputs, and x misaligned by one element
    (2 bytes) as well as aligned."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = 0
    for n, k in ((24, 2048), (1000, 1004)):
        kp = packing.padded_k(k)
        packed = packing.pack_codes(torch.randint(
            0, 16, (n, k), generator=gen, device="cuda", dtype=torch.uint8))
        for g in (128, 256):
            scales = packing.pad_groups(torch.rand(
                (n, -(-k // g)), generator=gen, device="cuda") + 0.5, k, g)
            zeros = packing.pad_groups(torch.randn(
                (n, -(-k // g)), generator=gen, device="cuda"), k, g)
            check(scales.shape[1] * g == kp, "groups cover kp")
            args = (packed, scales.t().contiguous(), zeros.t().contiguous())
            for lut_rows in (n, 1):
                lut = torch.randn((lut_rows, 16), generator=gen,
                                  device="cuda") * 4
                for m in (3, 9, 17, 130):
                    flat = torch.randn(m * k + 1, generator=gen,
                                       device="cuda").to(torch.bfloat16)
                    for misaligned in (False, True):
                        x = flat[int(misaligned):][:m * k].view(m, k)
                        check((x.data_ptr() % 16 != 0) == misaligned,
                              "x alignment")
                        for out, tol in ((torch.float32, 1e-4),
                                         (torch.bfloat16, 1e-2),
                                         (torch.float16, 1e-2)):
                            y = gemv.q4_lut_post(x, *args, lut, g, out)
                            ref = gemv.q4_lut_post_plain(x, *args, lut, g,
                                                         out)
                            torch.cuda.synchronize()
                            err = rel_err(y, ref)
                            check(y.shape == (m, n) and y.dtype == out
                                  and bool(torch.isfinite(y).all())
                                  and err <= tol,
                                  f"kernel A edge n={n} k={k} m={m} g={g} "
                                  f"lut_rows={lut_rows} misaligned="
                                  f"{misaligned} {out}: {err} > {tol}")
                            cases += 1
    return cases


def post_operands(gemv, packing, name, n, k, g, gen, lut_kind="row"):
    """Random codes of one tensor-core kernel in the port's layout (int8
    codes for ``int8_post`` and ``w8a8``, -128 included), g-wide f32 scales
    and zeros ``[kp/g, n]`` and, for kernels A, B and E, a per-row LUT
    (``lut_kind`` "row") or the int4 ramp ("ramp"); else None."""
    G = packing.padded_k(k) // g
    if name in gemv.BYTE_KERNELS:
        packed = packing.pack_codes8(torch.randint(
            -128, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8))
    else:
        packed = packing.pack_codes(torch.randint(
            0, 16, (n, k), generator=gen, device="cuda", dtype=torch.uint8))
    scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01
    zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
    lut = None
    if name in gemv.LUT_KERNELS:
        lut = (gemv.int4_ramp("cuda") if lut_kind == "ramp" else
               torch.randn((n, 16), generator=gen, device="cuda"))
    return packed, scales, zeros, lut


def post_call(gemv, name, plain=False):
    """``f(x, packed, scales, zeros, lut, g, out)`` for one tensor-core
    kernel's wrapper (or plain version); C ignores the lut, ``int8_post``,
    D and ``w8a8`` take none."""
    fn = getattr(gemv, name + ("_plain" if plain else ""))
    if name in gemv.LUT_KERNELS or (plain and name == "q4_int4_magic"):
        return fn
    return lambda x, packed, scales, zeros, lut, g, out: fn(
        x, packed, scales, zeros, g, out)


def post_x(gemv, name, m, k, gen, dtype=torch.bfloat16):
    """Random activations ``[m, k]`` for one tensor-core kernel: int8 codes
    in [-127, 127] for D and ``w8a8``, else ``dtype`` (bf16 by default)."""
    if name in gemv.INT8_X_KERNELS:
        return torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn((m, k), generator=gen, device="cuda").to(dtype)


def same_bits(a, b) -> bool:
    """Equal shapes, types and bits."""
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view), b.view(view))


def kernel_a_bit_equal(gemv, packing, name="q4_lut_post", g=128,
                       lut_kind="row"):
    """The tensor-core kernels' sums run in an order that depends on (n, k)
    alone: at the 1B shapes whose k is split (2048 x 2048, 512 x 2048 and
    8192 x 2048: one row runs the decode body, m = 16 a block per split,
    m = 130 at 8192 x 2048 one block for all of a tile's splits), every row
    of a batch of m = 8, 16 and 130 gives the same float32 bits as that row
    alone, and two calls on the same inputs give the same bits. Kernel A by
    default; C, ``int8_post``, D and ``w8a8`` (g=128: their 128-k slices
    are the groups; int8 x for D and ``w8a8``) by name, B and E at group
    size ``g`` with a per-row LUT or the int4 ramp (``lut_kind``; B's k is
    split into the same 128-k slices at g=64), and the fused W4A8/W8A8
    kernels on bf16 and float32 x at m = 8, 16, 33 and 64 (they stop at
    ``FUSED_ACT_M_MAX``; m = 33 leaves 31 rows of a 64-token tile
    empty)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    fn = post_call(gemv, name)
    fused = name in gemv.FLOAT_X_KERNELS
    cases = ([(m, dt) for m in (8, 16, 33, 64)
              for dt in (torch.bfloat16, torch.float32)] if fused
             else [(m, torch.bfloat16) for m in (8, 16, 130)])
    rows = 0
    splits = {}
    for n, k in ((2048, 2048), (512, 2048), (8192, 2048)):
        G = packing.padded_k(k) // 128
        splits[f"{n}x{k}"] = gemv.kernel_a_plan(
            1, n, G, torch.cuda.get_device_properties(0)
            .multi_processor_count)[1]
        check(splits[f"{n}x{k}"] > 1, f"{n}x{k} splits k")
        args = (*post_operands(gemv, packing, name, n, k, g, gen, lut_kind), g,
                torch.float32)
        for m, dt in cases:
            x = post_x(gemv, name, m, k, gen, dt)
            y = fn(x, *args)
            check(torch.equal(y.view(torch.int32),
                              fn(x, *args).view(torch.int32)),
                  f"{name} n={n} k={k} m={m}: two calls differ")
            for i in range(m):
                one = fn(x[i:i + 1], *args)
                check(torch.equal(one.view(torch.int32),
                                  y[i:i + 1].view(torch.int32)),
                      f"{name} n={n} k={k}: row {i} of m={m} differs "
                      f"from the row alone")
                rows += 1
    return {"rows": rows, "splits": splits, "group_size": g,
            "lut": lut_kind if name in gemv.LUT_KERNELS else None}


def fused_equals_external(gemv, packing, quant):
    """The fused W4A8/W8A8 kernels take their external twins' plan and
    bodies: at the 1B linear shapes, m in {1, 8, 16, 64} (the decode body,
    the block body at 16 and 64 tokens), bf16 and float32 x, float32 and
    bf16 outputs, ``w4a8_fused(x)`` gives the bits of ``(w4a8(xq) *
    sx).to(out)`` with ``xq, sx = quantize_activations(x)``, and
    ``w8a8_fused`` those of ``w8a8``'s: what ``linear._act_int8_linear``
    computes above 64 rows."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = 0
    for fused, ext in (("w4a8_fused", "w4a8"), ("w8a8_fused", "w8a8")):
        for n, k in KERNEL_SHAPES:
            packed, scales, zeros, _ = post_operands(gemv, packing, fused, n,
                                                     k, 128, gen)
            args = (packed, scales, zeros, 128)
            for m in (1, 8, 16, 64):
                for xdt in (torch.bfloat16, torch.float32):
                    x = post_x(gemv, fused, m, k, gen, xdt) * 3
                    xq, sx = quant.quantize_activations(x)
                    y32 = getattr(gemv, ext)(xq, *args, torch.float32) * sx
                    for out in (torch.float32, torch.bfloat16):
                        y = getattr(gemv, fused)(x, *args, out)
                        check(same_bits(y, y32.to(out)),
                              f"{fused} n={n} k={k} m={m} x {xdt} {out}: "
                              f"not the bits of {ext}(xq) * sx")
                        cases += 1
    return cases


def post_edge_cases(gemv, packing, name, gs=(128, 256)):
    """Kernel C, ``int8_post``, D, ``w8a8``, B, E or ``int8_fused`` on
    shapes the 1B path does not give them, as kernel A's edge cases: m in
    {3, 9, 17, 130}, n in {24, 1000} (B, E and ``int8_fused`` also n = 130
    with k = 1408), k = 2048 and 1004, the group sizes ``gs`` (g = 256: the
    slice fold reads each group's scale twice; B and ``int8_fused`` at g <
    128: several groups a 128-k slice), per-row and global
    LUTs (B and E), int8 codes of -128 (a quarter of the rows all -128),
    float32 (1e-4 * max; 1e-5 for D and ``w8a8``, whose integer dots are
    exact), bf16 and float16 (1e-2 * max) outputs, x (int8 for D and
    ``w8a8``) misaligned by one element as well as aligned."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    fn, plain = post_call(gemv, name), post_call(gemv, name, plain=True)
    cases = 0
    lut_kernel = name in gemv.LUT_KERNELS
    shapes = ((24, 2048), (1000, 1004)) + (
        ((130, 1408),) if lut_kernel or name == "int8_fused" else ())
    for n, k in shapes:
        for g in gs:
            packed, _, _, _ = post_operands(gemv, packing, name, n, k, g,
                                            gen)
            if name in gemv.BYTE_KERNELS:
                packed[:n // 4 + 1] = -128
            # int8 x runs to 127 where bf16 x is about 1: scales and zeros
            # 2^-7 as large keep float16 outputs finite
            int8_x = name in gemv.INT8_X_KERNELS
            mag = 2.0 ** -7 if int8_x else 1.0
            scales = packing.pad_groups(torch.rand(
                (n, -(-k // g)), generator=gen, device="cuda") + 0.5, k, g)
            zeros = packing.pad_groups(torch.randn(
                (n, -(-k // g)), generator=gen, device="cuda"), k, g)
            luts = ([torch.randn((rows, 16), generator=gen, device="cuda") * 4
                     for rows in (n, 1)] if lut_kernel else [None])
            for lut in luts:
                args = (packed, (scales * mag).t().contiguous(),
                        (zeros * mag).t().contiguous(), lut, g)
                for m in (3, 9, 17, 130):
                    flat = post_x(gemv, name, 1, m * k + 1, gen)[0]
                    for misaligned in (False, True):
                        x = flat[int(misaligned):][:m * k].view(m, k)
                        check((x.data_ptr() % 16 != 0) == misaligned,
                              "x alignment")
                        for out, tol in ((torch.float32,
                                          1e-5 if int8_x else 1e-4),
                                         (torch.bfloat16, 1e-2),
                                         (torch.float16, 1e-2)):
                            y = fn(x, *args, out)
                            ref = plain(x, *args, out)
                            torch.cuda.synchronize()
                            err = rel_err(y, ref)
                            check(y.shape == (m, n) and y.dtype == out
                                  and bool(torch.isfinite(y).all())
                                  and err <= tol,
                                  f"{name} edge n={n} k={k} m={m} g={g} "
                                  f"lut_rows="
                                  f"{None if lut is None else lut.shape[0]} "
                                  f"misaligned={misaligned} {out}: {err} > "
                                  f"{tol}")
                            cases += 1
    return cases


def rowscale_edge_cases(gemv, packing, name):
    """``int8_post``, ``w8a8`` or ``w8a8_fused`` with one group a row, as
    the row-scale formats run them: ``g = padded_k(k)`` for k in {1024,
    1408, 2048, 8192}, scales and zeros ``[1, n]``, n in {24, 1000}, m in
    {3, 9, 17} and 130 (64 for ``w8a8_fused``), float32 (1e-4 * max; 1e-5
    for the integer dots of ``w8a8`` and ``w8a8_fused``), bf16 and float16
    (1e-2 * max) outputs, against the plain version. Scales shrink as
    sqrt(128 / kp) (and by 2^-7 for int8 x) to keep float16 finite."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    fn, plain = post_call(gemv, name), post_call(gemv, name, plain=True)
    int8_x = name in gemv.INT8_X_KERNELS
    cases = 0
    for k in (1024, 1408, 2048, 8192):
        g = packing.padded_k(k)
        mag = (gemv.SLICE / g) ** 0.5 * (2.0 ** -7 if int8_x else 1.0)
        for n in (24, 1000):
            packed = packing.pack_codes8(torch.randint(
                -128, 128, (n, k), generator=gen, device="cuda",
                dtype=torch.int8))
            args = (packed, (torch.rand((1, n), generator=gen,
                                        device="cuda") + 0.5) * mag,
                    torch.randn((1, n), generator=gen, device="cuda") * mag,
                    None, g)
            for m in (3, 9, 17, 64 if name == "w8a8_fused" else 130):
                x = post_x(gemv, name, m, k, gen)
                for out, tol in ((torch.float32, 1e-4 if name == "int8_post"
                                  else 1e-5), (torch.bfloat16, 1e-2),
                                 (torch.float16, 1e-2)):
                    y = fn(x, *args, out)
                    err = rel_err(y, plain(x, *args, out))
                    check(y.shape == (m, n) and bool(torch.isfinite(y).all())
                          and err <= tol, f"{name} g=k edge n={n} k={k} "
                          f"m={m} {out}: {err} > {tol}")
                    cases += 1
    return cases


def fused_identity(gemv, linear):
    """The identity weight quantized to any4 at g=64 (as
    ``tests/test_torch_gemv.py::test_fused_identity_bit_exact``: every
    weight ``bf16(lut[c] * s + z)`` is exactly 0 or 1) through kernel B on
    the card gives x back bit for bit, at m = 1, 4 and 130 (the decode body
    and the block body)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = 0
    for k in (1024, 2048):
        qt = linear.quantize_tensor(torch.eye(k, device="cuda"), "any4", 64,
                                    init="int", kmeans_iters=5)
        check(qt.fmt == "any4" and torch.equal(
            linear.dequantize_tensor(qt, torch.float32),
            torch.eye(k, device="cuda")), f"any4 g=64 identity (k={k}) "
              f"dequantizes to the identity")
        for m in (1, 4, 130):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            check(torch.equal(gemv.q4_lut_fused(
                x, qt.packed, qt.scales, qt.zeros, qt.lut, 64,
                torch.bfloat16), x),
                f"kernel B on the identity weight (k={k}, m={m}) != x")
            cases += 1
    return cases


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(report: str, keep="post_mma"):
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    report whose mangled name holds ``keep`` (a namespace of tensor-core
    bodies: ``post_mma`` in SOURCE, ``a8_mma`` in W4A8_SOURCE; each code
    policy x token tiles x output type), demangled by ``c++filt`` where it
    is installed."""
    found, name, spills = [], None, (None, None)
    for line in report.splitlines():
        hit = PTXAS_ENTRY.search(line)
        if hit:
            name = hit.group(1) if keep in hit.group(1) else None
            continue
        if name is None:
            continue
        hit = PTXAS_SPILLS.search(line)
        if hit:
            spills = (int(hit.group(1)), int(hit.group(2)))
        hit = PTXAS_REGS.search(line)
        if hit:
            found.append({"kernel": name, "registers": int(hit.group(1)),
                          "spill_stores": spills[0],
                          "spill_loads": spills[1]})
            name, spills = None, (None, None)
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(f["kernel"] for f in found),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = []
    if len(names) == len(found):
        for f, full in zip(found, names):
            f["kernel"] = full.split(">(")[0].replace("void ", "").replace(
                "(anonymous namespace)::", "").replace(f"{keep}::", "") + ">"
    return found


def edge_cases(gemv, packing):
    """Both kernels on shapes and operands the 1B path does not give them:
    n not a multiple of 8, k not a multiple of 8 or of 1024, m across the
    m-tile sizes, a misaligned x, float32/float16 outputs and a global LUT.
    float32 outputs match the plain version within 1e-4 * max (only the
    order of float32 sums differs), bf16/f16 within 1e-2 * max."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = 0
    for n, k, m in ((1000, 1000, 3), (7, 64, 17), (384, 1536, 40),
                    (130, 2056, 9)):
        kp = packing.padded_k(k)
        codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                              dtype=torch.uint8)
        packed = packing.pack_codes(codes)
        big = torch.randn((m + 1, k), generator=gen, device="cuda")
        for name, g in (("q4_lut_post", 128), ("q4_lut_fused", 16),
                        ("q4_lut_fused", 32)):
            G = kp // g
            scales = packing.pad_groups(torch.rand(
                (n, -(-k // g)), generator=gen, device="cuda") + 0.5, k, g)
            zeros = packing.pad_groups(torch.randn(
                (n, -(-k // g)), generator=gen, device="cuda"), k, g)
            args = (packed, scales.t().contiguous(), zeros.t().contiguous())
            for lut_rows in (n, 1):
                lut = torch.randn((lut_rows, 16), generator=gen,
                                  device="cuda") * 4
                for out, tol in ((torch.float32, 1e-4),
                                 (torch.bfloat16, 1e-2),
                                 (torch.float16, 1e-2)):
                    x = big.to(torch.bfloat16)[1:]   # offset by one row
                    y = getattr(gemv, name)(x, *args, lut, g, out)
                    ref = getattr(gemv, name + "_plain")(x, *args, lut, g,
                                                         out)
                    torch.cuda.synchronize()
                    err = rel_err(y, ref)
                    check(y.shape == (m, n) and y.dtype == out
                          and err <= tol,
                          f"{name} edge n={n} k={k} m={m} g={g} "
                          f"lut_rows={lut_rows} {out}: {err} > {tol}")
                    cases += 1
    return cases


def int_operands(packing, n, k, gen):
    """Random codes in the port's layout, g=128 scales and zeros, and a
    sorted per-row LUT."""
    G = packing.padded_k(k) // 128
    codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                          dtype=torch.uint8)
    scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 + 1e-3
    zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
    lut = torch.sort(torch.rand((n, 16), generator=gen, device="cuda"),
                     dim=1).values * 15.0 - 8.0
    return packing.pack_codes(codes), scales, zeros, lut.contiguous()


def int_calls(gemv, name, x, packed, scales, zeros, lut, out):
    """(kernel call, plain call) of one slice-3 kernel on these operands."""
    if name == "q4_int4_magic":
        args = (x, packed, scales, zeros, 128, out)
        return (lambda: gemv.q4_int4_magic(*args),
                lambda: gemv.q4_int4_magic_plain(x, packed, scales, zeros,
                                                 None, 128, out))
    if name == "q4_lut_select":
        args = (x, packed, scales, zeros, lut, 128, out)
        return (lambda: gemv.q4_lut_select(*args),
                lambda: gemv.q4_lut_select_plain(*args))
    args = (x, packed, scales, zeros, 128, out)
    return (lambda: getattr(gemv, name)(*args),
            lambda: getattr(gemv, name + "_plain")(*args))


def int_kernel_phase(gemv, packing, linear, timer, bw, peak):
    """Kernels C, D, D-fused and E at the 1B linear shapes against their
    plain versions, timed beside a bf16 ``torch.matmul`` on the dequantized
    weight; E also bit for bit against kernel B."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for n, k in KERNEL_SHAPES:
        packed, scales, zeros, lut_row = int_operands(packing, n, k, gen)
        ramp = gemv.int4_ramp("cuda")
        G = scales.shape[0]
        for name, (_, _, ms) in INT_KERNELS.items():
            for lut_kind, lut in ((("ramp", ramp), ("per_row", lut_row))
                                  if name == "q4_lut_select"
                                  else (("none", None),)):
                qt = linear.QuantizedTensor(packed, scales, zeros, lut,
                                            "int4", 128, (n, k))
                w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
                for m in ms:
                    x = torch.randn((m, k), generator=gen, device="cuda")
                    if name == "w4a8":
                        x = torch.randint(-127, 128, (m, k), generator=gen,
                                          device="cuda", dtype=torch.int8)
                        out, tol = torch.float32, 1e-5
                    else:
                        x = x.to(torch.bfloat16)
                        out, tol = torch.bfloat16, 1e-2
                    fn, plain = int_calls(gemv, name, x, packed, scales,
                                          zeros, lut, out)
                    y, ref = fn(), plain()
                    torch.cuda.synchronize()
                    err = float((y.float() - ref.float()).abs().max())
                    scale = float(ref.float().abs().max())
                    check(bool(torch.isfinite(y).all()) and err <= tol * scale,
                          f"{name} {lut_kind} n={n} k={k} m={m}: |kernel - "
                          f"plain| {err} > {tol} * {scale}")
                    e32 = None
                    if out == torch.bfloat16:   # and in float32
                        f32, p32 = int_calls(gemv, name, x, packed, scales,
                                             zeros, lut, torch.float32)
                        bar = 1e-5 if name == "w4a8_fused" else 1e-4
                        e32 = rel_err(f32(), p32())
                        check(e32 <= bar, f"{name} {lut_kind} n={n} k={k} "
                              f"m={m} float32: {e32} > {bar}")
                    if name == "q4_lut_select":
                        for o in (torch.bfloat16, torch.float32):
                            args = (x, packed, scales, zeros, lut, 128, o)
                            check(torch.equal(gemv.q4_lut_select(*args),
                                              gemv.q4_lut_fused(*args)),
                                  f"kernel E != kernel B bit for bit, "
                                  f"{lut_kind} n={n} k={k} m={m} {o}")
                    nbytes = (packed.numel() * 4 + 2 * G * n * 4
                              + x.numel() * x.element_size()
                              + m * n * y.element_size()
                              + (0 if lut is None else lut.numel() * 4))
                    flops = 2 * m * n * k
                    rate = INT8_OPS if name.startswith("w4a8") else peak
                    t_bytes, t_ops = nbytes / bw * 1e3, flops / rate * 1e3
                    xb = x.to(torch.bfloat16)
                    row = {
                        "phase": "int_kernel", "name": name, "lut": lut_kind,
                        "n": n, "k": k, "m": m, "group_size": 128,
                        "x": str(x.dtype), "out": str(out),
                        "ms": timer(fn), "plain_ms": timer(plain, reps=5),
                        "library_ms": timer(lambda: torch.matmul(
                            xb, w_bf16.t())),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bytes": nbytes, "flops": flops,
                        "max_abs_err": err, "rel_err": err / scale,
                        "bar": tol, "rel_err_f32": e32}
                    row["gb_per_s"] = nbytes / row["ms"] / 1e6
                    row["bound_share"] = row["bound_ms"] / row["ms"]
                    emit(row)
                    rows.append(row)
                del qt, w_bf16
    return rows


def edge_activations(m, k, offset, gen):
    """``(flat, base)``: random values, and ``[m, k]`` of them from element
    ``offset`` with row 0 all zero (the 1e-8 floor) and a last row whose
    x / sx lands on k + 0.5 (sx = 1, round half to even)."""
    flat = torch.randn(m * k + 1, generator=gen, device="cuda") * 3
    base = flat[offset:offset + m * k].reshape(m, k)
    base[0] = 0.0
    ties = torch.arange(1, k, device="cuda") % 100 + 0.5
    base[m - 1, 0] = 127.0
    base[m - 1, 1:] = ties * (1 - 2 * (torch.arange(1, k, device="cuda") % 2))
    return flat, base


def int_edge_cases(gemv, packing, quant):
    """Kernels C, D, D-fused and E on what the 1B path does not give them:
    n not a multiple of 8 and k = 1408 (a k that is no multiple of 1024), a
    misaligned x (offset by one element) and k not a multiple of 8, float32
    x for D-fused, an all-zero x row (the 1e-8 floor), a row whose x / sx
    lands on k + 0.5 (round half to even), and float32, bf16 and float16
    outputs. float32 outputs within 1e-5 * max of the plain version for
    D/D-fused and 1e-4 for C/E, bf16/f16 within 1e-2; E equal to kernel B
    and D-fused to ``quantize_activations`` + D bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = 0
    for n, k, m, offset in ((1000, 1408, 3, 0), (130, 1408, 17, 1),
                            (7, 1407, 40, 1), (132, 2056, 64, 0)):
        packed, scales, zeros, lut = int_operands(packing, n, k, gen)
        flat, base = edge_activations(m, k, offset, gen)
        for name in INT_KERNELS:
            for out, tol in ((torch.float32,
                              1e-5 if name.startswith("w4a8") else 1e-4),
                             (torch.bfloat16, 1e-2), (torch.float16, 1e-2)):
                xdts = (torch.float32, torch.bfloat16) \
                    if name == "w4a8_fused" else (torch.bfloat16,)
                for xdt in xdts:
                    if name == "w4a8":
                        flat8 = quant.quantize_activations(
                            flat.reshape(1, -1))[0].reshape(-1)
                        x = flat8[offset:offset + m * k].reshape(m, k)
                    else:
                        x = (flat.to(xdt)[offset:offset + m * k]
                             .reshape(m, k))
                        x.copy_(base.to(xdt))
                    fn, plain = int_calls(gemv, name, x, packed, scales,
                                          zeros, lut, out)
                    y, ref = fn(), plain()
                    torch.cuda.synchronize()
                    err = rel_err(y, ref)
                    check(y.shape == (m, n) and y.dtype == out
                          and bool(torch.isfinite(y).all()) and err <= tol,
                          f"{name} edge n={n} k={k} m={m} offset={offset} "
                          f"x {xdt} {out}: {err} > {tol}")
                    if name == "w4a8_fused":
                        check(bool((y[0] == 0).all()),
                              "w4a8_fused: an all-zero row gives 0")
                        xq, sx = quant.quantize_activations(x)
                        ext = (gemv.w4a8(xq, packed, scales, zeros, 128)
                               * sx).to(out)
                        check(same_bits(y, ext), f"w4a8_fused != "
                              f"quantize_activations + w4a8 (half to even) "
                              f"bit for bit, n={n} k={k} m={m} {xdt} {out}")
                    if name == "q4_lut_select":
                        for lt in (lut, gemv.int4_ramp("cuda")):
                            args = (x, packed, scales, zeros, lt, 128, out)
                            check(torch.equal(gemv.q4_lut_select(*args),
                                              gemv.q4_lut_fused(*args)),
                                  f"kernel E != kernel B edge n={n} k={k}")
                    cases += 1
    return cases


def int8_operands(packing, n, k, g, gen):
    """Random int8 codes (-128 included) in the port's layout and g-wide
    scales and zeros."""
    G = packing.padded_k(k) // g
    q = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 + 1e-3
    zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
    return packing.pack_codes8(q), scales, zeros


def int8_kernel_phase(gemv, packing, linear, timer, bw, peak):
    """The four int8-weight kernels at the 1B linear shapes against their
    plain versions, timed beside a bf16 ``torch.matmul`` on the dequantized
    weight: bf16 outputs within 1e-2 * max, float32 within 1e-5 * max
    (``w8a8``, ``w8a8_fused``: exact integer dots) or 1e-4 * max."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(10)
    for n, k in KERNEL_SHAPES:
        for name, (_, _, ms, g) in INT8_KERNELS.items():
            packed, scales, zeros = int8_operands(packing, n, k, g, gen)
            G = scales.shape[0]
            qt = linear.QuantizedTensor(packed, scales, zeros, None, "int8",
                                        g, (n, k))
            w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
            wrapper = getattr(gemv, name)
            plain = getattr(gemv, name + "_plain")
            bar32 = 1e-5 if name.startswith("w8a8") else 1e-4
            for m in ms:
                x = torch.randn((m, k), generator=gen, device="cuda")
                if name == "w8a8":
                    x = torch.randint(-127, 128, (m, k), generator=gen,
                                      device="cuda", dtype=torch.int8)
                    out, tol = torch.float32, bar32
                else:
                    x = x.to(torch.bfloat16)
                    out, tol = torch.bfloat16, 1e-2
                args = (x, packed, scales, zeros, g, out)
                y, ref = wrapper(*args), plain(*args)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(y).all()) and err <= tol * scale,
                      f"{name} n={n} k={k} m={m}: |kernel - plain| {err} > "
                      f"{tol} * {scale}")
                e32 = None
                if out == torch.bfloat16:                  # and in float32
                    a32 = (x, packed, scales, zeros, g, torch.float32)
                    e32 = rel_err(wrapper(*a32), plain(*a32))
                    check(e32 <= bar32, f"{name} n={n} k={k} m={m} float32: "
                          f"{e32} > {bar32}")
                nbytes = (packed.numel() + 2 * G * n * 4
                          + x.numel() * x.element_size()
                          + m * n * y.element_size())
                flops = 2 * m * n * k
                rate = INT8_OPS if name.startswith("w8a8") else peak
                t_bytes, t_ops = nbytes / bw * 1e3, flops / rate * 1e3
                xb = x.to(torch.bfloat16)
                row = {
                    "phase": "int8_kernel", "name": name, "n": n, "k": k,
                    "m": m, "group_size": g, "x": str(x.dtype),
                    "out": str(out),
                    "ms": timer(lambda: wrapper(*args)),
                    "plain_ms": timer(lambda: plain(*args), reps=5),
                    "library_ms": timer(lambda: torch.matmul(
                        xb, w_bf16.t())),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "bytes": nbytes, "flops": flops,
                    "max_abs_err": err, "rel_err": err / scale,
                    "bar": tol, "rel_err_f32": e32}
                row["gb_per_s"] = nbytes / row["ms"] / 1e6
                row["bound_share"] = row["bound_ms"] / row["ms"]
                emit(row)
                rows.append(row)
            del qt, w_bf16
    return rows


def int8_edge_cases(gemv, packing, quant, linear):
    """The four int8-weight kernels on what the 1B path does not give them:
    rows of codes equal to -128, n not a multiple of 8 with k = 1408 and
    1407 (no multiple of 1024, nor of 8), x misaligned by one element,
    float32 x for ``w8a8_fused``, an all-zero x row (the 1e-8 floor), a row
    whose x / sx lands on k + 0.5 (round half to even), group sizes 16, 64
    and 256 for ``int8_fused``, and float32, bf16 and float16 outputs;
    bars as in the kernel phase, and ``w8a8_fused`` bit-equal to
    ``quantize_activations`` + ``w8a8``. Then the identity weight through
    ``int8_fused`` (x back bit for bit) and any4q8's LUT snap on the card
    against the CPU's on the same LUTs (equal codes and row scales)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = 0
    for n, k, m, offset in ((1000, 1408, 3, 0), (130, 1408, 17, 1),
                            (7, 1407, 40, 1), (132, 2056, 64, 0)):
        flat, base = edge_activations(m, k, offset, gen)
        for name, g in (("w8a8", 128), ("w8a8_fused", 128),
                        ("int8_post", 128), ("int8_fused", 16),
                        ("int8_fused", 64), ("int8_fused", 256)):
            packed, scales, zeros = int8_operands(packing, n, k, g, gen)
            packed[: n // 2 + 1, :k] = -128               # codes at -128
            bar32 = 1e-5 if name.startswith("w8a8") else 1e-4
            for out, tol in ((torch.float32, bar32), (torch.bfloat16, 1e-2),
                             (torch.float16, 1e-2)):
                xdts = (torch.float32, torch.bfloat16) \
                    if name == "w8a8_fused" else (torch.bfloat16,)
                for xdt in xdts:
                    if name == "w8a8":
                        flat8 = quant.quantize_activations(
                            flat.reshape(1, -1))[0].reshape(-1)
                        x = flat8[offset:offset + m * k].reshape(m, k)
                    else:
                        x = (flat.to(xdt)[offset:offset + m * k]
                             .reshape(m, k))
                        x.copy_(base.to(xdt))
                    args = (x, packed, scales, zeros, g, out)
                    y = getattr(gemv, name)(*args)
                    ref = getattr(gemv, name + "_plain")(*args)
                    torch.cuda.synchronize()
                    err = rel_err(y, ref)
                    check(y.shape == (m, n) and y.dtype == out
                          and bool(torch.isfinite(y).all()) and err <= tol,
                          f"{name} edge n={n} k={k} m={m} g={g} offset="
                          f"{offset} x {xdt} {out}: {err} > {tol}")
                    if name == "w8a8_fused":
                        check(bool((y[0] == 0).all()),
                              "w8a8_fused: an all-zero row gives 0")
                        xq, sx = quant.quantize_activations(x)
                        ext = (gemv.w8a8(xq, packed, scales, zeros, 128)
                               * sx).to(out)
                        check(same_bits(y, ext), f"w8a8_fused != "
                              f"quantize_activations + w8a8 (half to even) "
                              f"bit for bit, n={n} k={k} m={m} {xdt} {out}")
                    cases += 1
    for k, g in ((1024, 128), (2048, 64)):
        qt = linear.quantize_tensor(torch.eye(k, device="cuda"), "int8", g,
                                    layout="row")
        check(qt.fmt == "int8", f"int8 identity (k={k}, g={g}) format")
        for m in (1, 4, 130):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            check(torch.equal(gemv.int8_fused(
                x, qt.packed, qt.scales, qt.zeros, g, torch.bfloat16), x),
                f"int8_fused on the identity weight (k={k}, g={g}, m={m}) "
                f"!= x")
            cases += 1
    lut = torch.rand((2048, 16), generator=gen, device="cuda") * 15.0 - 8.0
    for l in (lut, lut[:1]):
        lut8, sr = linear.snap_lut8(l)
        lut8_h, sr_h = linear.snap_lut8(l.cpu())
        check(torch.equal(lut8.cpu(), lut8_h) and torch.equal(sr.cpu(), sr_h),
              f"any4q8 LUT snap on the card != on the CPU ({l.shape[0]} "
              f"rows)")
        cases += 1
    return cases


def attn_inputs(kvc, name, b, ctx, gen, pool_dtype, q_dtype, lens=None,
                sink_slots=(), h=ATTN_HEADS, rep=ATTN_REP, d=ATTN_HEAD_DIM):
    """(wrapper, plain version, arguments) of one attention kernel: random
    pools in the engine's layout (int8 ones written by ``to_int8`` from
    float), bucket ``ctx``, every slot at full length unless ``lens``; in
    the paged layout a shuffled page table, with ``sink_slots`` on page 0."""
    layout, q8, _ = ATTN_KERNELS[name]
    pps = ctx // PAGE_SIZE
    P = b * pps + 1
    shape = (h, P, PAGE_SIZE, d) if layout == "paged" else (h, b * ctx, d)

    def pool():
        x = torch.randn(shape, generator=gen, device="cuda")
        if q8:
            amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-6)
            return (kvc.to_int8(x, amax), amax[..., 0].contiguous())
        return x.to(pool_dtype)
    k, v = pool(), pool()
    q = torch.randn((b, h * rep, d), generator=gen, device="cuda").to(q_dtype)
    lens = torch.tensor([ctx] * b if lens is None else lens,
                        dtype=torch.int32, device="cuda")
    if layout == "contig":
        return (kvc.flash_contig_decode, kvc.flash_contig_decode_plain,
                (q, k, v, lens, ctx, ctx))
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[:b * pps]
             + 1).reshape(b, pps).to(torch.int32)
    table[list(sink_slots)] = 0
    return (kvc.flash_paged_decode, kvc.flash_paged_decode_plain,
            (q, k, v, lens, table))


def sdpa_yardstick(kvc, args):
    """One ``scaled_dot_product_attention`` (GQA, boolean length mask) over
    a dense bf16 ``[b, h, ctx, d]`` view of the same pools, dequantized for
    int8, built here once: the call the port never makes, for
    ``library_ms``."""
    q, k, v, lens = args[:4]
    if len(args) == 5:                            # paged: gather the table
        kd, vd = (kvc.gather_ctx_hmajor(p, args[4]) for p in (k, v))
    else:
        ctx = args[4]

        def view(p):
            if isinstance(p, tuple):
                h = p[0].shape[0]
                return kvc.from_int8(p[0].reshape(h, -1, ctx, p[0].shape[-1]),
                                     p[1].reshape(h, -1, ctx)[..., None])
            return p.reshape(p.shape[0], -1, ctx, p.shape[-1])
        kd, vd = view(k), view(v)
    kd, vd = (t.permute(1, 0, 2, 3).to(torch.bfloat16).contiguous()
              for t in (kd, vd))
    qd = q.to(torch.bfloat16)[:, :, None, :].contiguous()
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True)


def attn_bound(name, args, bw):
    """(least ms, bound_by, bytes, flops) for these inputs: the K and V rows
    (and int8 scales) of the live positions, the table entries they use,
    q, the output and seq_lens, each read or written once, over the memory
    rate; 4 * rep * d flops per live position and head over the float32
    rate."""
    layout, q8, _ = ATTN_KERNELS[name]
    q, k = args[0], args[1]
    kc = k[0] if q8 else k
    b, nq, d = q.shape
    h = kc.shape[0]
    ctx = args[4].shape[1] * PAGE_SIZE if layout == "paged" else args[4]
    live = [min(int(n), ctx) for n in args[3].tolist()]
    toks = sum(live)
    nbytes = 2 * toks * h * d * kc.element_size() + 2 * q.numel() * \
        q.element_size() + 4 * b
    nbytes += 2 * toks * h * 4 if q8 else 0
    nbytes += 4 * sum(-(-n // PAGE_SIZE) for n in live) \
        if layout == "paged" else 0
    flops = 4 * toks * nq * d
    t_bytes, t_ops = nbytes / bw * 1e3, flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def attention_phase(kvc, timer, bw):
    """Each attention kernel against its plain version at the 1B serving
    shapes, with its times; and one float32 case each."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, (layout, q8, _) in ATTN_KERNELS.items():
        pool_dtype = torch.int8 if q8 else torch.bfloat16
        tol = 2e-2 if q8 else 1e-2
        for b, ctx in ATTN_CASES:
            fn, plain, args = attn_inputs(kvc, name, b, ctx, gen, pool_dtype,
                                          torch.bfloat16)
            y, ref = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            check(bool(torch.isfinite(y).all()) and err <= tol * scale,
                  f"{name} b={b} ctx={ctx}: |kernel - plain| {err} > "
                  f"{tol} * {scale}")
            bound, by, nbytes, flops = attn_bound(name, args, bw)
            split = kvc.split_len(b, ATTN_HEADS)
            splits = -(-ctx // split)
            row = {"phase": "attention_kernel", "name": name, "b": b,
                   "ctx": ctx, "h": ATTN_HEADS, "rep": ATTN_REP,
                   "d": ATTN_HEAD_DIM, "page_size": PAGE_SIZE, "S": split,
                   "splits": splits, "blocks": ATTN_HEADS * b * splits,
                   "pool": str(pool_dtype), "q": "torch.bfloat16",
                   "ms": timer(lambda: fn(*args)),
                   "plain_ms": timer(lambda: plain(*args), reps=3),
                   "library_ms": timer(sdpa_yardstick(kvc, args)),
                   "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                   "flops": flops, "max_abs_err": err, "rel_err": err / scale,
                   "bar": tol}
            row["gb_per_s"] = nbytes / row["ms"] / 1e6
            row["bound_share"] = row["bound_ms"] / row["ms"]
            emit(row)
            rows.append(row)
            del args
        # float32: f32 pools (int8 ones stay int8) and f32 q
        fn, plain, args = attn_inputs(kvc, name, *ATTN_TIMED, gen,
                                      torch.int8 if q8 else torch.float32,
                                      torch.float32)
        err = rel_err(fn(*args), plain(*args))
        check(err <= 1e-4, f"{name} float32: {err} > 1e-4 of max")
        emit({"phase": "attention_kernel_f32", "name": name,
              "b": ATTN_TIMED[0], "ctx": ATTN_TIMED[1], "rel_err": err,
              "bar": 1e-4})
    return rows


def attention_buckets(kvc):
    """Each kernel over the same pools and lengths at two buckets (paged: a
    table cut to its first columns; contig: a smaller ``ctx_bucket``) gives
    the same bits: with several live splits (b=8, buckets 1024 and 2048)
    and with one live split against several (lengths up to S, buckets S
    and 2048)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, ctx = ATTN_TIMED
    S = kvc.split_len(b, ATTN_HEADS)
    cases = 0
    for name, (layout, q8, _) in ATTN_KERNELS.items():
        pool_dtype = torch.int8 if q8 else torch.bfloat16
        for lens, small in (([1, S - 1, S, S + 1, 1000, 1024, 517, 0], 1024),
                            ([1, S - 1, S, 40, 0, S, 7, 100], S)):
            fn, _, args = attn_inputs(kvc, name, b, ctx, gen, pool_dtype,
                                      torch.bfloat16, lens=lens)
            if layout == "paged":
                cut = args[:4] + (args[4][:, :small // PAGE_SIZE]
                                  .contiguous(),)
            else:
                cut = args[:4] + (small, ctx)
            full, part = fn(*args), fn(*cut)
            check(torch.equal(full, part) and bool(torch.isfinite(full).all()),
                  f"{name}: buckets {small} and {ctx} differ at lens {lens}")
            check(bool((full[lens.index(0)] == 0).all()),
                  f"{name}: a slot of length 0 is not zero")
            cases += 1
    return cases


def attention_edge_cases(kvc):
    """The four kernels on lengths of 1, of the whole bucket, of no whole
    number of pages, of S - 1, S and S + 1 for the split length S, and of
    0, an inactive slot on the sink page (paged), and head_dim 128, against
    their plain versions: float32 q within 1e-4 * max, bf16 q within
    1e-2 * max (2e-2 for int8 pools)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    S = kvc.split_len(4, 8)
    cases = 0
    for name, (layout, q8, _) in ATTN_KERNELS.items():
        for h, rep, d, ctx, lens in ((8, 4, 64, 256, [1, 256, 37, 1]),
                                     (8, 4, 64, 512, [S - 1, S, S + 1, 0]),
                                     (2, 2, 128, 128, [5, 128, 100])):
            for q_dtype, pool_dtype, tol in (
                    (torch.float32, torch.float32, 1e-4),
                    (torch.bfloat16, torch.bfloat16, 2e-2 if q8 else 1e-2)):
                fn, plain, args = attn_inputs(
                    kvc, name, len(lens), ctx, gen, pool_dtype, q_dtype,
                    lens=lens, sink_slots=(3,) if len(lens) == 4 else (),
                    h=h, rep=rep, d=d)
                y = fn(*args)
                err = rel_err(y, plain(*args))
                check(y.shape == args[0].shape and y.dtype == q_dtype
                      and bool(torch.isfinite(y).all()) and err <= tol,
                      f"{name} edge h={h} rep={rep} d={d} lens={lens} "
                      f"{q_dtype}: {err} > {tol}")
                cases += 1
    return cases


def layer_summary(rows, name, lut=None, m=1,
                  keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """One Llama-3.2-1B decoder layer's 7 linears at ``m`` (rows of one LUT
    variant when ``lut`` is given)."""
    out = {key: 0.0 for key in keys}
    for r in rows:
        if r["name"] == name and r["m"] == m and r.get("lut", lut) == lut:
            for key in out:
                out[key] += LAYER_LINEARS[(r["n"], r["k"])] * r[key]
    mine = [r for r in rows if r["name"] == name]
    out["max_abs_err"] = max(r["max_abs_err"] for r in mine)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in mine
                                     if r["m"] == m) else "operations"
    return out


def by_m(rows, name, ms, lut=None):
    """A kernel's per-layer sums at each m of its kernel phase."""
    return {m: layer_summary(rows, name, lut, m=m) for m in ms}


def rel_err(a, ref) -> float:
    """max |a - ref| over max |ref|."""
    ref = ref.float()
    return float((a.float() - ref).abs().max() / ref.abs().max())


def to_float32(tree, linear, dequantize=False):
    """Dense leaves as float32; quantized weights kept, or dequantized in
    float32 (``lut[c] * s + z``, not rounded to bf16)."""
    if isinstance(tree, dict):
        return {k: to_float32(v, linear, dequantize) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v, linear, dequantize) for v in tree]
    if isinstance(tree, linear.QuantizedTensor):
        return linear.dequantize_tensor(tree, torch.float32) if dequantize \
            else tree
    return tree.float()


def timed_generate(gen_mod, params, cfg, prompt):
    """``generate`` with host time, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = gen_mod.generate(params, cfg, prompt, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    return tokens, (time.perf_counter() - t0) * 1e3


def decode_figures(gen_mod, llama, params, cfg, prompt, batches=(1, 4)):
    """Host time of ``prefill`` and of ``decode_loop`` over the remaining
    NEW_TOKENS-1 steps, each ending in a synchronize; the better of two
    runs at each batch size."""
    out = {}
    for b in batches:
        best = None
        for _ in range(2):
            caches = llama.init_kv_caches(cfg, b, PROMPT_LEN + NEW_TOKENS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = gen_mod.prefill(params, cfg, prompt[:b].long(),
                                             caches)
            tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gen_mod.decode_loop(params, cfg, tok, PROMPT_LEN, caches,
                                NEW_TOKENS - 1)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            run = ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / (NEW_TOKENS - 1))
            best = run if best is None or run[1] < best[1] else best
        out[b] = {"prefill_ms": best[0], "decode_ms_per_token": best[1],
                  "tok_s": b * 1e3 / best[1]}
    return out


def device_profile(gen_mod, llama, params, cfg, prompt, steps=8):
    """Device time per decode step at batch 1 from ``torch.profiler``, and
    the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caches = llama.init_kv_caches(cfg, 1, PROMPT_LEN + steps + 1)
    logits, caches = gen_mod.prefill(params, cfg, prompt[:1].long(), caches)
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen_mod.decode_loop(params, cfg, tok, PROMPT_LEN, caches, steps)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:       # kernels, not host ops
            t = ev.self_device_time_total
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t
    total_ms = sum(per_kernel.values()) / 1e3 / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_step": total_ms,
            "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps
                                        for k, v in top}}


def prefill_chunks(llama, qparams, cfg, gen, tokens=1024, fwd=None):
    """Host ms (best of 3, ending in a synchronize) of one forward
    (``llama.forward`` unless ``fwd``) over a ``tokens``-token prompt with
    ``linear``'s chunks of at most ``fused_m_max`` rows at 256, 512
    (``FUSED_M_MAX``) and 1024."""
    fwd = fwd or llama.forward
    ids = torch.randint(0, cfg.vocab_size, (1, tokens), generator=gen,
                        device="cuda", dtype=torch.int32)
    out = {}
    for fused_m_max in (256, 512, 1024):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = fwd(qparams, cfg, ids, fused_m_max=fused_m_max)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()), "prefill logits finite")
        out[fused_m_max] = min(times)
    return out


def llama_1b_any4(args, llama, api):
    """Phase 4's models: Llama-3.2-1B (``--layers`` cuts the depth), bf16
    weights from ``init_params(seed=0)`` and their any4 g=128 copy; with
    the host seconds of each."""
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = api.quantize_model(params, fmt="any4", group_size=128,
                                 kmeans_iters=10)
    torch.cuda.synchronize()
    return params, qparams, cfg, init_s, time.perf_counter() - t0


def main_path(args, gemv, llama, gen_mod, api, linear):
    params, qparams, cfg, init_s, quantize_s = llama_1b_any4(args, llama, api)
    per_forward = cfg.num_hidden_layers * 7
    # quantize_model(..., quantize_embeddings=True) quantizes the table after
    # the linears, which keep their seeds, and the table with the learner's
    # default seed: so the table alone completes that model
    # (main_path_fused_qemb) from this one's linears
    t0 = time.perf_counter()
    qtable = api.quantize_model(
        {"embed_tokens": params["embed_tokens"]}, fmt="any4", group_size=128,
        kmeans_iters=10, quantize_embeddings=True)["embed_tokens"]
    torch.cuda.synchronize()
    qtable_s = time.perf_counter() - t0
    quantized = [l for l in qparams["layers"] for l in l.values()
                 if isinstance(l, linear.QuantizedTensor)]
    check(len(quantized) == per_forward
          and all(q.fmt == "any4t" for q in quantized),
          "every linear is any4 at g=128")
    check("lm_head" not in qparams and isinstance(
        qparams["embed_tokens"], torch.Tensor), "tied lm_head stays bf16")

    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)

    # The check runs the any4 model with float32 activations (the kernels
    # still round x and the LUT to bf16, as the TPU kernels do) against the
    # dense float32 forward of the exactly dequantized weights. The bf16
    # model's figures are printed beside: over 16 random layers two bf16
    # forwards of the same weights already differ by 1.5-2e-2 of max.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    one = prompt[:1]
    logits = {
        "any4_f32": llama.forward(to_float32(qparams, linear), cfg32, one)[0],
        "any4_bf16": llama.forward(qparams, cfg, one)[0],
        "dense_bf16": llama.forward(api.dequantize_model(qparams), cfg,
                                    one)[0],
    }
    ref, _ = llama.forward(to_float32(qparams, linear, dequantize=True),
                           cfg32, one)
    torch.cuda.synchronize()
    errs = {f"rel_err_{k}_vs_dense_f32": rel_err(v, ref)
            for k, v in logits.items()}
    errs["rel_err_any4_bf16_vs_dense_bf16"] = rel_err(logits["any4_bf16"],
                                                      logits["dense_bf16"])
    emit({"phase": "main_path_check", "bar": 2e-2,
          "logits_max_abs": float(ref.abs().max()), **errs})
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "any4 logits finite")
    check(errs["rel_err_any4_f32_vs_dense_f32"] <= 2e-2,
          "any4 prefill logits (float32 activations) vs the dequantized "
          f"model's float32 dense forward: {errs} > 2e-2 of max")
    del logits, ref

    # the main path: generate at batch 1 and 4, with the counts read around it
    torch.cuda.reset_peak_memory_stats()
    gemv.reset_launches()
    gen_ms, tokens = {}, {}
    for b in (1, 4):
        tokens[b], gen_ms[b] = timed_generate(gen_mod, qparams, cfg,
                                              prompt[:b])
    launches = dict(gemv.LAUNCHES)
    forwards = 2 * NEW_TOKENS  # per batch: one prefill + NEW_TOKENS-1 steps
    check(launches["q4_lut_post"] == per_forward * forwards,
          f"kernel A launches {launches['q4_lut_post']} != "
          f"{per_forward} x {forwards} forwards")
    check(launches["q4_lut_fused"] == 0, "kernel B is not on the g=128 path")
    for b, tok in tokens.items():
        check(tok.shape == (b, PROMPT_LEN + NEW_TOKENS), f"tokens shape b={b}")
        check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              "tokens in vocab")
        check(torch.equal(tok[:, :PROMPT_LEN], prompt[:b]), "prompt kept")
    peak_mem = torch.cuda.max_memory_allocated()
    any4 = decode_figures(gen_mod, llama, qparams, cfg, prompt)
    prof = device_profile(gen_mod, llama, qparams, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / any4[1]["decode_ms_per_token"])
    dense_tok, dense_ms = timed_generate(gen_mod, params, cfg, prompt[:1])
    dense = decode_figures(gen_mod, llama, params, cfg, prompt)
    dense_prof = device_profile(gen_mod, llama, params, cfg, prompt)
    dense_prof["busy_share_b1"] = (dense_prof["device_ms_per_step"]
                                   / dense[1]["decode_ms_per_token"])
    agree = float((tokens[1][:, PROMPT_LEN:] == dense_tok[:, PROMPT_LEN:])
                  .float().mean())
    emit({"phase": "main_path", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "fmt": "any4", "group_size": 128,
          "kmeans_iters": 10, "init_s": init_s, "quantize_s": quantize_s,
          "launches": launches, "launches_per_forward": per_forward,
          "generate_ms": gen_ms, "dense_generate_ms_b1": dense_ms,
          "max_memory_allocated": peak_mem,
          "model_bytes_any4": api.model_size_bytes(qparams),
          "model_bytes_bf16": api.model_size_bytes(params),
          "any4": any4, "dense_bf16": dense,
          "any4_profile_b1": prof, "dense_bf16_profile_b1": dense_prof,
          "greedy_agreement_with_dense_b1": agree,
          "b4_row0_equals_b1": bool(torch.equal(tokens[4][0], tokens[1][0]))})
    # the serving phase reuses qparams; the bf16 weights wait on the host
    # for the cli_tools phase
    params = to_device(params, "cpu", linear)
    torch.cuda.empty_cache()
    prefill = prefill_chunks(llama, qparams, cfg, gen)
    emit({"phase": "prefill_fused_m_max", "tokens": 1024,
          "layers": cfg.num_hidden_layers, "forward_ms": prefill})
    figures = {"quantize_s": quantize_s, "any4": any4, "profile_b1": prof,
               "prefill_1024_tokens_forward_ms": prefill}
    return launches, params, qparams, cfg, (qtable, qtable_s, figures)


def fused_qemb_path(qparams, qtable, cfg, unfused, gemv, kvc, teng, llama,
                    gen_mod, api, linear, fuse):
    """The phase-4 model with its tied table quantized (any4, g=128, the
    row layout) and its projections fused (``fuse_projections``): 16 x 4
    linears and the head, all on kernel A. ``unfused``: phase 4's and
    phase 5's figures of the same linears, unfused with the bf16 head, from
    this run. See the module docstring (phase 5b)."""
    per_forward = FUSED_PER_LAYER * cfg.num_hidden_layers + 1
    unfused_model = {**qparams, "embed_tokens": qtable}
    fused = fuse.fuse_projections(unfused_model)
    emb = fused["embed_tokens"]
    check(isinstance(emb, linear.QuantizedTensor) and emb.fmt == "any4"
          and emb.group_size == 128 and emb.lut.shape == (cfg.vocab_size, 16),
          "embed_tokens is any4 at g=128 in the row layout, a LUT a row")
    check(all("qkv_proj" in l and "gateup_proj" in l and "q_proj" not in l
              and l["qkv_proj"].fmt == l["gateup_proj"].fmt == "any4t"
              for l in fused["layers"]), "every layer holds qkv_proj and "
          "gateup_proj (any4t)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    one = prompt[:1]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    got = llama.forward(to_float32(fused, linear), cfg32, one)[0]
    ref = llama.forward(to_float32(fused, linear, dequantize=True), cfg32,
                        one)[0]
    plain_unfused = llama.forward(to_float32(unfused_model, linear), cfg32,
                                  one)[0]
    bf16 = {k: llama.forward(m, cfg, one)[0]
            for k, m in (("fused", fused), ("unfused", unfused_model))}
    torch.cuda.synchronize()
    errs = {"rel_err_fused_f32_vs_dense_f32": rel_err(got, ref),
            "rel_err_fused_vs_unfused_f32": rel_err(got, plain_unfused),
            "rel_err_fused_vs_unfused_bf16": rel_err(bf16["fused"],
                                                     bf16["unfused"])}
    emit({"phase": "main_path_check_fused_qemb", "bar_dense": 2e-2,
          "bar_unfused": 1e-2, **errs})
    check(bool(torch.isfinite(got).all()) and all(
        bool(torch.isfinite(v).all()) for v in bf16.values()),
        "fused logits finite")
    check(errs["rel_err_fused_f32_vs_dense_f32"] <= 2e-2,
          f"fused any4 with the quantized head vs the dense float32 forward "
          f"of its dequantized weights: {errs}")
    check(errs["rel_err_fused_vs_unfused_f32"] <= 1e-2,
          f"fused vs unfused (float32 activations): {errs}")
    del got, ref, plain_unfused, bf16

    torch.cuda.reset_peak_memory_stats()
    gemv.reset_launches()
    gen_ms, tokens = {}, {}
    for b in (1, 4):
        tokens[b], gen_ms[b] = timed_generate(gen_mod, fused, cfg, prompt[:b])
    launches = dict(gemv.LAUNCHES)
    check_launches(gemv, {"q4_lut_post": per_forward}, 2 * NEW_TOKENS,
                   "fused generate: kernel A a forward")
    for b, tok in tokens.items():
        check(tok.shape == (b, PROMPT_LEN + NEW_TOKENS)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
              and torch.equal(tok[:, :PROMPT_LEN], prompt[:b]),
              f"fused tokens b={b}")
    peak_mem = torch.cuda.max_memory_allocated()
    figs = decode_figures(gen_mod, llama, fused, cfg, prompt)
    prof = device_profile(gen_mod, llama, fused, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / figs[1]["decode_ms_per_token"])
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    gemv.reset_launches()
    check(bool(torch.isfinite(llama.forward(fused, cfg, ids)[0]).all()),
          "fused 1024-token logits finite")
    torch.cuda.synchronize()
    chunks = -(-1024 // linear.FUSED_M_MAX)
    check_launches(gemv, {"q4_lut_post": per_forward}, chunks,
                   f"fused 1024-token forward: kernel A a {linear.FUSED_M_MAX}"
                   f"-row chunk")
    prefill = prefill_chunks(llama, fused, cfg, gen)
    emit({"phase": "main_path_fused_qemb", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "fmt": "any4", "group_size": 128,
          "kmeans_iters": 10, "quantize_embeddings": True, "fused": True,
          "launches": launches, "launches_per_forward": per_forward,
          "generate_ms": gen_ms, "max_memory_allocated": peak_mem,
          "model_bytes": api.model_size_bytes(fused),
          "model_bytes_unfused_bf16_head": api.model_size_bytes(qparams),
          "any4_fused_qemb": figs, "profile_b1": prof,
          "prefill_1024_tokens_forward_ms": prefill,
          "unfused_bf16_head": unfused["main"],
          "b4_row0_equals_b1": bool(torch.equal(tokens[4][0], tokens[1][0]))})

    prompts = serve_prompts(cfg)
    out, runs = {}, {}
    for mode, run_kw in (("burst1", dict(burst=1)),
                         ("burst8_pipeline", dict(burst=8, pipeline=True))):
        gemv.reset_launches()
        kvc.reset_launches()
        out[mode], e, wall = serve(teng, fused, cfg, prompts, "paged", False,
                                   run_kw)
        steps = e.decode_steps
        chunks = sum(-(-e._bucket(len(p)) // linear.FUSED_M_MAX)
                     for p in prompts)
        check(all(len(t) == SERVE_NEW_TOKENS
                  and all(0 <= x < cfg.vocab_size for x in t)
                  for t in out[mode]), f"fused {mode}: every request gives "
              f"{SERVE_NEW_TOKENS} tokens in the vocabulary")
        check(kvc.LAUNCHES["flash_paged_decode"] == cfg.num_hidden_layers
              * steps and sum(kvc.LAUNCHES.values())
              == kvc.LAUNCHES["flash_paged_decode"],
              f"fused {mode}: attention launches {kvc.LAUNCHES}")
        check_launches(gemv, {"q4_lut_post": per_forward}, steps + chunks,
                       f"fused {mode} engine ({steps} steps + {chunks} "
                       f"prefill chunks)")
        runs[mode] = {"launches": {**gemv.LAUNCHES, **kvc.LAUNCHES},
                      "decode_steps": steps,
                      "graph_replays": e.graph_replays,
                      "prefill_chunks": chunks, "wall_s": wall,
                      "tok_s": SERVE_REQUESTS * SERVE_NEW_TOKENS / wall}
        del e
    check(out["burst1"] == out["burst8_pipeline"],
          "fused: run(burst=8, pipeline=True) tokens differ from run(burst=1)")
    forced = teacher_forced(teng, kvc, gen_mod, llama,
                            to_float32(fused, linear), cfg32, "paged", False,
                            torch.Generator(device="cuda").manual_seed(6))
    check(forced <= 2e-2, f"fused: teacher-forced decode logits {forced} > "
          f"2e-2 of max from decode_step over a dense f32 cache")
    emit({"phase": "serving_fused_qemb", "kv_layout": "paged",
          "kv_int8": False, "slots": SERVE_SLOTS, "max_ctx": SERVE_MAX_CTX,
          "page_size": PAGE_SIZE, "layers": cfg.num_hidden_layers,
          "new_tokens": SERVE_NEW_TOKENS, "runs": runs,
          "burst8_pipeline_equals_burst1": True,
          "teacher_forced_rel_err": forced, "teacher_forced_bar": 2e-2,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **serving_figures(teng, fused, cfg, prompts, "paged", False),
          "unfused_bf16_head": {k: unfused["serving"][k] for k in (
              "runs", "ms_per_decode_step_8_slots", "decode_tok_s_8_slots",
              "device_ms_per_step", "busy_share", "prefill_ms",
              "attention_ms_per_step", "linear_ms_per_step")}})
    return {"q4_lut_post": launches["q4_lut_post"]
            + runs["burst1"]["launches"]["q4_lut_post"]}


def to_device(tree, device, linear):
    """A parameter tree (quantized weights included) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, linear) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, linear) for v in tree]
    if isinstance(tree, linear.QuantizedTensor):
        return dataclasses.replace(tree, **{
            f: None if getattr(tree, f) is None
            else getattr(tree, f).to(device)
            for f in ("packed", "scales", "zeros", "lut")})
    return tree.to(device)


@contextlib.contextmanager
def held_linears(linear):
    """While active, every quantized ``linear`` call also runs on the CPU
    through the plain versions with the same inputs; yields the list of
    their max|y - ref| / max|ref|."""
    errs = []
    orig = linear.linear

    def held(x, w, bias=None, **kw):
        y = orig(x, w, bias, **kw)
        if isinstance(w, linear.QuantizedTensor):
            ref = orig(x.cpu(), to_device(w, "cpu", linear),
                       None if bias is None else bias.cpu(), **kw)
            errs.append(rel_err(y.cpu(), ref))
        return y

    linear.linear = held
    try:
        yield errs
    finally:
        linear.linear = orig


# path -> (format of the six k = 2048 linears, of down_proj (k = 8192), the
# check of the prefill logits, quantize_model's arguments besides
# fmt=path and group_size=128)
MAIN_FORMATS = {
    "int4": ("int4p", "int4p", "dense", {}),
    "w4a8": ("w4a8", "w4a8", "held", {}),
    "int8": ("int8q", "int8g", "dense", {}),
    "w8a8": ("w8a8q", "w8a8g", "held", {}),
    "any4q8": ("any4q8", "any4q8g", "held", {"kmeans_iters": 10}),
    "any4_g64": ("any4", "any4", "dense",
                 {"fmt": "any4", "group_size": 64, "kmeans_iters": 10}),
    "int8_g64": ("int8", "int8", "dense", {"fmt": "int8", "group_size": 64}),
    "int8r": ("int8r", "int8r", "dense", {}),
    "w8a8r": ("w8a8r", "w8a8r", "held", {}),
    "any4q8r": ("any4q8r", "any4q8r", "held", {"kmeans_iters": 10}),
}


def int_layer_launches(gemv, linear, fmt, ms):
    """Expected launches per decoder layer (its 7 linears) over forwards of
    ``ms`` rows each: int4p one kernel C call per ``FUSED_M_MAX`` rows, int8
    one ``int8_post`` call per ``FUSED_M_MAX`` rows, any4 at g=64 one kernel
    B call and int8 at g=64 one ``int8_fused`` call per ``FUSED_M_MAX``
    rows; w4a8, w8a8 and any4q8
    one fused call at m <= ``FUSED_ACT_M_MAX``, else one call on quantized
    activations, or one per ``_int8_m_tile(k)`` rows once m exceeds
    ``max(FUSED_M_MAX, tile)`` (the tile is 512 for down_proj's k = 8192,
    1024 below). The grouped down_proj of int8/w8a8/any4q8 takes one call on
    (for w8a8 and any4q8: quantized) activations up to
    ``_XLA_GROUPED_M_MAX`` rows and dequantizes above. The row-scale
    formats route as int8 (``int8r``) and w8a8 (``w8a8r``, ``any4q8r``)
    with no grouped layer."""
    out = {}
    _, down_fmt, _, _ = MAIN_FORMATS[fmt]
    for (_, k), count in LAYER_LINEARS.items():
        tile = linear._int8_m_tile(k)
        grouped = k == 8192 and down_fmt in linear.GROUPED_FMTS
        for m in ms:
            if grouped and m > linear._XLA_GROUPED_M_MAX:
                continue                                  # dequantized
            if fmt in ("int4", "int8", "any4_g64", "int8_g64", "int8r"):
                name = {"int4": "q4_int4_magic", "int8": "int8_post",
                        "any4_g64": "q4_lut_fused", "int8_g64": "int8_fused",
                        "int8r": "int8_post"}[fmt]
                calls = 1 if grouped else -(-m // linear.FUSED_M_MAX)
            else:
                ext = "w4a8" if fmt == "w4a8" else "w8a8"
                if m <= gemv.FUSED_ACT_M_MAX and not grouped:
                    name, calls = ext + "_fused", 1
                else:
                    name = ext
                    calls = 1 if m <= max(linear.FUSED_M_MAX, tile) \
                        else -(-m // tile)
            out[name] = out.get(name, 0) + count * calls
    return out


def check_launches(gemv, want, times, what):
    """Each kernel of ``gemv.LAUNCHES`` launched exactly ``times`` x its
    count in ``want`` (a layer's or a forward's; 0 when absent), and each
    one in ``want`` at least once."""
    for name, count in gemv.LAUNCHES.items():
        expect = times * want.get(name, 0)
        check(count == expect and (name not in want or count > 0),
              f"{what}: {name} launches {count} != {expect}")


def int_main_path(args, fmt, gemv, llama, gen_mod, api, linear, layers=None):
    """Llama-3.2-1B at full width (``--layers``, or ``layers``, cuts the
    depth), bf16 weights from ``init_params(seed=0)``, quantized as path
    ``fmt`` says (int4, w4a8, int8, w8a8 or any4q8 at g=128, any4 or int8 at
    g=64, the row-scale formats with one group a row); see the module
    docstring (phases 8, 9 and 9b)."""
    kind, down_kind, how, qkw = MAIN_FORMATS[fmt]
    qkw = {"fmt": fmt, "group_size": 128, **qkw}
    g = qkw["group_size"]
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if layers or args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=min(
            n for n in (layers, args.layers) if n))
    per_forward = cfg.num_hidden_layers * 7
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = api.quantize_model(params, **qkw)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    fmts = [(key, l.fmt, l.group_size, l.shape[1])
            for layer in qparams["layers"] for key, l in layer.items()
            if isinstance(l, linear.QuantizedTensor)]
    rowscale = kind in linear.ROWSCALE_FMTS
    check(len(fmts) == per_forward and all(
        f == (down_kind if key == "down_proj" else kind)
        and gs == (k if rowscale else g) for key, f, gs, k in fmts),
        f"every linear is {kind} (down_proj {down_kind}) at "
        f"g={'k' if rowscale else g}")

    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    q32 = to_float32(qparams, linear)
    info = {}
    if how == "dense":
        # as for any4: float32 activations (the kernel rounds x to bf16)
        # against the float32 forward of the exactly dequantized weights
        ids = prompt[:1]
        got = llama.forward(q32, cfg32, ids)[0]
        ref = llama.forward(to_float32(qparams, linear, dequantize=True),
                            cfg32, ids)[0]
        errs = {f"rel_err_{fmt}_f32_vs_dense_f32": rel_err(got, ref)}
        bar = 2e-2
    else:
        # W4A8 and W8A8 round every activation to an int8 code, so the first 1e-7
        # difference between the card's and the CPU's non-kernel ops (sum
        # order, rsqrt, sin/cos) flips a code somewhere and moves that
        # activation by 1/127 of its row's absmax; a whole-model
        # comparison therefore measures those flips (1.1-2.7e-2 of max at
        # 2 layers), not the port. Each linear of the forward is instead
        # held against the same linear on the CPU through the plain
        # versions, on the very activations the card gave it: m=16 runs
        # the fused kernel (W8A8's grouped down_proj: quantized activations
        # and the external one), m=128 (two rows of 64) the external one.
        # The whole-model difference is printed beside.
        errs = {}
        for name, ids in (("m16_fused", prompt[:1, :16]),
                          ("m128_external", prompt[:2])):
            with held_linears(linear) as per_linear:
                got = llama.forward(q32, cfg32, ids)[0]
            check(bool(torch.isfinite(got).all()) and len(per_linear)
                  == per_forward, f"{fmt} {name}: finite, every linear held")
            errs[f"max_rel_err_{fmt}_{name}_per_linear_vs_cpu_plain"] = max(
                per_linear)
            cpu = to_device(q32, "cpu", linear)
            info[f"rel_err_{fmt}_{name}_model_vs_cpu_plain"] = rel_err(
                got.cpu(), llama.forward(cpu, cfg32, ids.cpu())[0])
            del cpu
        bar = 1e-5
    torch.cuda.synchronize()
    emit({"phase": f"main_path_check_{fmt}", "bar": bar, **errs, **info})
    check(all(e <= bar for e in errs.values()),
          f"{fmt} prefill: {errs} > {bar} of max")
    del q32

    torch.cuda.reset_peak_memory_stats()
    gemv.reset_launches()
    gen_ms, tokens = {}, {}
    for b in (1, 4):
        tokens[b], gen_ms[b] = timed_generate(gen_mod, qparams, cfg,
                                              prompt[:b])
    launches = dict(gemv.LAUNCHES)
    ms = [b * PROMPT_LEN for b in (1, 4)] + [b for b in (1, 4)
                                             for _ in range(NEW_TOKENS - 1)]
    check_launches(gemv, int_layer_launches(gemv, linear, fmt, ms),
                   cfg.num_hidden_layers, f"{fmt} generate")
    for b, tok in tokens.items():
        check(tok.shape == (b, PROMPT_LEN + NEW_TOKENS)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
              and torch.equal(tok[:, :PROMPT_LEN], prompt[:b]),
              f"{fmt} tokens b={b}")
    peak_mem = torch.cuda.max_memory_allocated()
    figs = decode_figures(gen_mod, llama, qparams, cfg, prompt)
    prof = device_profile(gen_mod, llama, qparams, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / figs[1]["decode_ms_per_token"])
    prefill = prefill_chunks(llama, qparams, cfg, gen)
    emit({"phase": f"main_path_{fmt}", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, **qkw, "fmt": kind,
          "fmt_down_proj": down_kind,
          "quantize_s": quantize_s, "launches": launches,
          "launches_per_forward": per_forward, "generate_ms": gen_ms,
          "max_memory_allocated": peak_mem,
          "model_bytes": api.model_size_bytes(qparams), fmt: figs,
          "profile_b1": prof, "prefill_1024_tokens_forward_ms": prefill,
          "b4_row0_equals_b1": bool(torch.equal(tokens[4][0], tokens[1][0]))})
    return launches, qparams, cfg


def mx4_path(args, gemv, llama, gen_mod, api, linear):
    """``quant_methods["mx4"]`` (g=32) on the 1B model at full width and
    depth (``--layers`` cuts it): every linear ``mx4`` at g=32 on kernel B
    (the e2m1 table as a global LUT), logits with float32 activations
    within 2e-2 * max of the dequantized weights' dense float32 forward,
    ``generate`` at batch 1 with 112 B launches a forward and no A; then one
    weight group poisoned to NaN: its e8m0 byte is NaN, and on the card as
    on the CPU that weight row's output is NaN and every other finite, at m
    = 1, 8 and 130."""
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    per_forward = cfg.num_hidden_layers * 7
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = api.quant_methods["mx4"](params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    lins = [l for layer in q["layers"] for l in layer.values()
            if isinstance(l, linear.QuantizedTensor)]
    check(len(lins) == per_forward and all(
        l.fmt == "mx4" and l.group_size == 32 and l.lut.shape == (1, 16)
        for l in lins), "every linear is mx4 at g=32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    got = llama.forward(to_float32(q, linear), cfg32, prompt)[0]
    ref = llama.forward(to_float32(q, linear, dequantize=True), cfg32,
                        prompt)[0]
    err = rel_err(got, ref)
    check(bool(torch.isfinite(got).all()) and err <= 2e-2,
          f"mx4 logits (float32 activations) vs the dense float32 forward: "
          f"{err}")
    del got, ref
    gemv.reset_launches()
    tokens, gen_ms = timed_generate(gen_mod, q, cfg, prompt)
    launches = dict(gemv.LAUNCHES)
    check_launches(gemv, {"q4_lut_fused": per_forward}, NEW_TOKENS,
                   "mx4 generate: kernel B a forward")
    check(tokens.shape == (1, PROMPT_LEN + NEW_TOKENS) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "mx4 tokens")
    # one poisoned group: row 5, the third group of 32
    w = params["layers"][0]["q_proj"].clone()
    w[5, 64:96] = float("nan")
    qt = linear.quantize_tensor(w, "mx4", 32)
    nan_scales = torch.isnan(qt.scales)
    check(bool(nan_scales[2, 5]) and int(nan_scales.sum()) == 1,
          "the poisoned group's e8m0 byte is NaN, and no other")
    cpu_qt = to_device(qt, "cpu", linear)
    for m in (1, 8, 130):
        x = torch.randn((m, w.shape[1]), generator=gen, device="cuda").to(
            torch.bfloat16)
        for y in (linear.linear(x, qt), linear.linear(x.cpu(), cpu_qt)):
            bad = ~torch.isfinite(y)
            check(bool(torch.isnan(y[:, 5]).all()) and int(bad.sum()) == m,
                  f"mx4 NaN group, m={m} on {y.device}: NaN in row 5 only")
    emit({"phase": "main_path_mx4", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "fmt": "mx4", "group_size": 32,
          "quantize_s": quantize_s, "rel_err_mx4_f32_vs_dense_f32": err,
          "bar": 2e-2, "launches": launches,
          "launches_per_forward": per_forward, "generate_ms_b1": gen_ms,
          "model_bytes": api.model_size_bytes(q),
          "nan_group_rows_only": True})
    return launches


def select_path(args, gemv, llama, api, linear):
    """Row-layout int4 at g=128, the 1B model at full width and depth
    (``--layers`` cuts it): ``forward`` with ``use_gather=False`` runs
    kernel E on every linear, the default runs kernel B with the ramp LUT
    (not kernel A), and the two give the same logits bit for bit."""
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    q = api.quantize_model(llama.init_params(cfg, seed=0, device="cuda"),
                           fmt="int4", group_size=128, layout="row")
    check(all(l.fmt == "int4" for layer in q["layers"]
              for l in layer.values()
              if isinstance(l, linear.QuantizedTensor)), "row-layout int4")
    gen = torch.Generator(device="cuda").manual_seed(9)
    ids = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                        device="cuda", dtype=torch.int32)
    logits = {}
    launches = {}
    for use_gather in (False, True):
        gemv.reset_launches()
        logits[use_gather] = torch.cat([
            llama.forward(q, cfg, ids[:, :t], use_gather=use_gather)[0][:, -1]
            for t in (16, 1)])
        torch.cuda.synchronize()
        launches[use_gather] = dict(gemv.LAUNCHES)
        check_launches(gemv, {"q4_lut_fused" if use_gather
                              else "q4_lut_select": 2 * 7},
                       cfg.num_hidden_layers,
                       f"row int4 use_gather={use_gather}")
    check(bool(torch.isfinite(logits[False]).all()), "select logits finite")
    check(torch.equal(logits[False], logits[True]),
          "use_gather=False logits != use_gather=True logits")
    emit({"phase": "main_path_select", "layers": cfg.num_hidden_layers,
          "fmt": "int4",
          "layout": "row", "group_size": 128, "forwards": [16, 1],
          "launches_use_gather_false": launches[False],
          "launches_use_gather_true": launches[True],
          "logits_bit_equal": True})
    return launches[False]


def int8_layouts(gemv, llama, api, linear):
    """The int8 format names on 2 layers of the 1B model, one prefill of
    m = 128: ``w8a8`` with ``layout="row"``, ``w8a8q``, ``w8a8t`` and
    ``w8a8g`` all quantize the activations and run ``w8a8`` on the same
    codes, so their logits are bit-equal; ``int8q``, ``int8t``, ``int8g``
    and ``int8p`` all run ``int8_post`` and are bit-equal; ``int8`` with
    ``layout="row"`` at g=128 runs ``int8_fused`` on every linear, and its
    logits with float32 activations are within 2e-2 * max of the
    dequantized weights' dense float32 forward (``int8`` at g=64 runs at
    full depth in ``int_main_path``)."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama_3_2_1b(),
                              num_hidden_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                        device="cuda", dtype=torch.int32)
    out = {}
    for kernel, names in (
            ("w8a8", (("w8a8", 128, "row"), ("w8a8q", 128, None),
                      ("w8a8t", 128, None), ("w8a8g", 128, None))),
            ("int8_post", (("int8q", 128, None), ("int8t", 128, None),
                           ("int8g", 128, None), ("int8p", 128, None))),
            ("int8_fused", (("int8", 128, "row"),))):
        logits = []
        for name, g, layout in names:
            kw = {"layout": layout} if layout else {}
            q = api.quantize_model(params, fmt=name, group_size=g, **kw)
            check(all(l.fmt == name for layer in q["layers"]
                      for l in layer.values()
                      if isinstance(l, linear.QuantizedTensor)),
                  f"every linear is {name}")
            gemv.reset_launches()
            if kernel == "int8_fused":
                got = llama.forward(to_float32(q, linear), cfg32, ids)[0]
                torch.cuda.synchronize()
                ref = llama.forward(to_float32(q, linear, dequantize=True),
                                    cfg32, ids)[0]
                err = rel_err(got, ref)
                check(err <= 2e-2, f"{name} g={g} logits (float32 "
                      f"activations) vs the dense float32 forward: {err}")
                out[f"rel_err_{name}_{layout or 'default'}_g{g}_vs_dense_"
                    f"f32"] = err
            else:
                got = llama.forward(q, cfg, ids)[0]
                torch.cuda.synchronize()
            check_launches(gemv, {kernel: 7}, 2, f"{name} g={g} layout="
                           f"{layout} prefill of 128 rows")
            check(bool(torch.isfinite(got).all()), f"{name} logits finite")
            logits.append(got)
            del q
        if kernel != "int8_fused":
            check(all(torch.equal(l, logits[0]) for l in logits),
                  f"the logits of {[n for n, _, _ in names]} are not "
                  f"bit-equal")
            out[f"{kernel}_names_bit_equal"] = [n for n, _, _ in names]
    emit({"phase": "int8_layouts", "layers": 2, "m": 128, **out})


def int_serving(teng, gemv, kvc, linear, qparams, cfg, fmt, prompts,
                forced=None):
    """The engine over a main path's model (int4, w4a8, int8, w8a8, or any4
    or int8 at g=64), paged bf16 pools, once with ``run(burst=1)`` and once with
    ``run(burst=8, pipeline=True)``: tokens in the vocabulary, both runs
    equal, exact launch counts. ``forced``: ``(gen_mod, llama)`` to hold a
    teacher-forced decode step with float32 activations within 2e-2 * max
    of ``decode_step`` over a dense float32 cache, as in phase 5."""
    out, runs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for mode, run_kw in (("burst1", dict(burst=1)),
                         ("burst8_pipeline", dict(burst=8, pipeline=True))):
        gemv.reset_launches()
        kvc.reset_launches()
        out[mode], e, wall = serve(teng, qparams, cfg, prompts, "paged",
                                   False, run_kw)
        steps = e.decode_steps
        buckets = [e._bucket(len(p)) for p in prompts]
        check(all(len(t) == SERVE_NEW_TOKENS and
                  all(0 <= x < cfg.vocab_size for x in t)
                  for t in out[mode]),
              f"{fmt} {mode}: every request gives {SERVE_NEW_TOKENS} tokens "
              f"in the vocabulary")
        check(kvc.LAUNCHES["flash_paged_decode"] == cfg.num_hidden_layers
              * steps and sum(kvc.LAUNCHES.values()) ==
              kvc.LAUNCHES["flash_paged_decode"],
              f"{fmt} {mode}: attention launches {kvc.LAUNCHES}")
        check_launches(gemv, int_layer_launches(
            gemv, linear, fmt, buckets + [SERVE_SLOTS] * steps),
            cfg.num_hidden_layers, f"{fmt} {mode} engine")
        runs[mode] = {"launches": {**gemv.LAUNCHES, **kvc.LAUNCHES},
                      "decode_steps": steps,
                      "graph_replays": e.graph_replays,
                      "prefill_buckets": buckets,
                      "wall_s": wall,
                      "tok_s": SERVE_REQUESTS * SERVE_NEW_TOKENS / wall}
        del e
    check(out["burst1"] == out["burst8_pipeline"],
          f"{fmt}: run(burst=8, pipeline=True) tokens differ from "
          f"run(burst=1)")
    info = {}
    if forced is not None:
        gen_mod, llama = forced
        err = teacher_forced(
            teng, kvc, gen_mod, llama, to_float32(qparams, linear),
            dataclasses.replace(cfg, dtype=torch.float32), "paged", False,
            torch.Generator(device="cuda").manual_seed(6))
        check(err <= 2e-2, f"{fmt}: teacher-forced decode logits {err} > "
              f"2e-2 of max from decode_step over a dense f32 cache")
        info = {"teacher_forced_rel_err": err, "teacher_forced_bar": 2e-2}
    emit({"phase": f"serving_{fmt}", "kv_layout": "paged", "kv_int8": False,
          "slots": SERVE_SLOTS, "max_ctx": SERVE_MAX_CTX,
          "page_size": PAGE_SIZE, "layers": cfg.num_hidden_layers,
          "new_tokens": SERVE_NEW_TOKENS, "runs": runs,
          "burst8_pipeline_equals_burst1": True, **info,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **serving_figures(teng, qparams, cfg, prompts, "paged", False)})
    return runs["burst1"]["launches"]


def serve_prompts(cfg):
    """12 seeded prompts of 16-1000 tokens, one above 512."""
    rng = np.random.RandomState(5)
    lens = rng.randint(16, 1001, size=SERVE_REQUESTS)
    if lens.max() <= 512:
        lens[0] = 900
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def serve(teng, qparams, cfg, prompts, layout, q8, run_kw):
    """One engine run of ``prompts``: (tokens per request in submission
    order, the engine, host seconds ending in a synchronize)."""
    e = teng.Engine(qparams, cfg, max_slots=SERVE_SLOTS,
                    max_ctx=SERVE_MAX_CTX, page_size=PAGE_SIZE,
                    kv_quantize=q8, kv_layout=layout, device="cuda")
    uids = [e.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {r.uid: r.out_tokens for r in e.run(**run_kw)}
    torch.cuda.synchronize()
    return [done[u] for u in uids], e, time.perf_counter() - t0


def forced_inputs(vocab, gen, t=120, forced=3):
    """A ``t``-token prompt ``[1, t]`` and ``forced`` tokens to decode after
    it, drawn from ``gen``."""
    prompt = torch.randint(0, vocab, (1, t), generator=gen, device="cuda",
                           dtype=torch.int32)
    toks = torch.randint(0, vocab, (forced,), generator=gen, device="cuda",
                         dtype=torch.int32)
    return prompt, toks


def engine_forced(teng, kvc, params32, cfg32, layout, q8, prompt, toks,
                  tp_group=None):
    """The engine's ``_decode_impl`` logits ``[forced, vocab]`` over its
    pool (bf16 or int8) after its ``_prefill_impl`` of ``prompt``, on the
    forced ``toks``; ``cfg32``/``params32`` a rank's under ``tp_group``."""
    t, forced = prompt.shape[1], toks.shape[0]
    pps = 8                                       # 128 positions >= bucket
    pages = pps + (0 if layout == "contig" else 1)
    cache = kvc.PagedKVCache.create(cfg32, pages, PAGE_SIZE,
                                    dtype=torch.bfloat16, quantize=q8,
                                    device="cuda")
    alloc = kvc.PageAllocator(pages, 1, pps, contiguous=layout == "contig")
    check(alloc.ensure(0, t + forced + 1, PAGE_SIZE), "teacher-forced pages")
    table = torch.from_numpy(alloc.table.copy()).cuda()
    padded = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    padded[:, :t] = prompt
    teng._prefill_impl(params32, cfg32, padded, t, cache.k_pages,
                       cache.v_pages, table[0], PAGE_SIZE, kv_layout=layout,
                       tp_group=tp_group)
    out = []
    for i in range(forced):
        out.append(teng._decode_impl(
            params32, cfg32, toks[i:i + 1],
            torch.tensor([t + i], dtype=torch.int32, device="cuda"), table,
            cache.k_pages, cache.v_pages, PAGE_SIZE, kv_layout=layout,
            tp_group=tp_group)[0])
    return torch.stack(out)


def teacher_forced(teng, kvc, gen_mod, llama, params32, cfg32, layout, q8,
                   gen, t=120, forced=3):
    """Max over 3 positions of |logits - ref| / max|ref|: the engine's
    ``_decode_impl`` over its pool (bf16 or int8) after its
    ``_prefill_impl`` (:func:`engine_forced`), against ``decode_step`` over
    a dense float32 cache after ``prefill``, on the same forced tokens,
    float32 activations."""
    prompt, toks = forced_inputs(cfg32.vocab_size, gen, t, forced)
    got = engine_forced(teng, kvc, params32, cfg32, layout, q8, prompt, toks)
    caches = llama.init_kv_caches(cfg32, 1, t + forced, device="cuda")
    gen_mod.prefill(params32, cfg32, prompt.long(), caches)
    errs = []
    for i in range(forced):
        ref, _ = gen_mod.decode_step(params32, cfg32, toks[i:i + 1], t + i,
                                     caches)
        errs.append(rel_err(got[i:i + 1], ref))
    return max(errs)


def serving_figures(teng, qparams, cfg, prompts, layout, q8, steps=8):
    """ms per decode step (host clock, synchronized) over ``steps`` single
    steps at 8 active slots, the device time of as many steps from
    ``torch.profiler`` and their ratio, the attention kernel's share of it,
    and the host time of a prefill of the shortest and the longest
    prompt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    e = teng.Engine(qparams, cfg, max_slots=SERVE_SLOTS,
                    max_ctx=SERVE_MAX_CTX, page_size=PAGE_SIZE,
                    kv_quantize=q8, kv_layout=layout, device="cuda")
    for p in prompts[:SERVE_SLOTS]:
        e.submit(p, max_new_tokens=4 * steps)
    e.step()                                      # admits all 8, one step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        e.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    before = [dict(c) for c in teng.LAUNCH_COUNTERS]
    replays = e.graph_replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            e.step()
        torch.cuda.synchronize()
    # the launches counted (a replay credits its capture's) against the
    # port's kernels in the device trace, by name
    tables = (teng.gemv.DEVICE_KERNELS, teng.kvc.DEVICE_KERNELS)
    launched = collections.Counter()
    for table, d in zip(tables, teng.launch_delta(teng.LAUNCH_COUNTERS,
                                                  before)):
        for name, n in d.items():
            for part in table[name]:
                launched[part] += n
    parts = {p for t in tables for ps in t.values() for p in ps}
    traced = collections.Counter(
        p for ev in prof.events() if ev.device_type == DeviceType.CUDA
        for p in parts if p in ev.name)
    replayed = e.graph_replays - replays
    check(replayed > 0 and traced == launched,
          f"profiled steps ({replayed} replays): device kernels "
          f"{dict(traced)} != launches counted {dict(launched)}")
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:       # kernels, not host ops
            per_kernel[ev.key] = (per_kernel.get(ev.key, 0.0)
                                  + ev.self_device_time_total)
    device_ms = sum(per_kernel.values()) / 1e3 / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    prefill = {}
    for p in (min(prompts, key=len), max(prompts, key=len)):
        L = e._bucket(len(p))
        padded = torch.zeros((1, L), dtype=torch.int32, device="cuda")
        padded[0, :len(p)] = torch.from_numpy(p).cuda()
        row = torch.from_numpy(e.alloc.table[0].copy()).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        teng._prefill_impl(qparams, cfg, padded, len(p), e.cache.k_pages,
                           e.cache.v_pages, row, PAGE_SIZE, kv_layout=layout)
        torch.cuda.synchronize()
        prefill[f"prompt_{len(p)}_bucket_{L}"] = \
            (time.perf_counter() - t0) * 1e3
    return {"ms_per_decode_step_8_slots": step_ms,
            "profiled_replays": replayed,
            "profiled_kernels": dict(traced),
            "decode_tok_s_8_slots": SERVE_SLOTS * 1e3 / step_ms,
            "device_ms_per_step": device_ms,
            "busy_share": device_ms / step_ms, "prefill_ms": prefill,
            # flash_decode.cu's kernel, all 16 launches of a step
            "attention_ms_per_step": sum(
                v for k, v in per_kernel.items() if "decode_kernel" in k)
            / 1e3 / steps,
            # the 112 linear kernel launches of a step
            "linear_ms_per_step": sum(
                v for k, v in per_kernel.items()
                if any(name in k for name in LINEAR_KERNEL_NAMES))
            / 1e3 / steps,
            "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps
                                        for k, v in top}}


def serving_phase(qparams, cfg, gemv, kvc, teng, llama, gen_mod, linear):
    """The engine at full width and depth in the four pool combinations;
    see the module docstring (phase 5) for what is checked."""
    prompts = serve_prompts(cfg)
    lens = np.array([len(p) for p in prompts])
    per_forward = cfg.num_hidden_layers * 7
    params32 = to_float32(qparams, linear)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(6)
    launches = {}
    for name, (layout, q8, _) in ATTN_KERNELS.items():
        torch.cuda.reset_peak_memory_stats()
        out, runs = {}, {}
        for mode, run_kw in (("burst1", dict(burst=1)),
                             ("burst8_pipeline", dict(burst=8,
                                                      pipeline=True))):
            gemv.reset_launches()
            kvc.reset_launches()
            out[mode], e, wall = serve(teng, qparams, cfg, prompts, layout,
                                       q8, run_kw)
            count = {**gemv.LAUNCHES, **kvc.LAUNCHES}
            chunks = sum(-(-e._bucket(len(p)) // linear.FUSED_M_MAX)
                         for p in prompts)
            steps = e.decode_steps
            check(all(len(t) == SERVE_NEW_TOKENS and
                      all(0 <= x < cfg.vocab_size for x in t)
                      for t in out[mode]),
                  f"{name} {mode}: every request gives {SERVE_NEW_TOKENS} "
                  f"tokens in the vocabulary")
            check(count[name] == cfg.num_hidden_layers * steps and all(
                count[other] == 0 for other in ATTN_KERNELS if other != name),
                  f"{name} {mode}: attention launches {count} for {steps} "
                  f"decode steps")
            check(count["q4_lut_post"] == per_forward * (steps + chunks)
                  and count["q4_lut_fused"] == 0,
                  f"{name} {mode}: kernel A launches {count['q4_lut_post']} "
                  f"!= {per_forward} x ({steps} steps + {chunks} prefill "
                  f"chunks)")
            runs[mode] = {"launches": count, "decode_steps": steps,
                          "graph_replays": e.graph_replays,
                          "prefill_chunks": chunks, "wall_s": wall,
                          "tok_s": SERVE_REQUESTS * SERVE_NEW_TOKENS / wall}
            if mode == "burst1":
                launches[name] = count[name]
            del e
        check(out["burst1"] == out["burst8_pipeline"],
              f"{name}: run(burst=8, pipeline=True) tokens differ from "
              f"run(burst=1)")
        bar = 5e-2 if q8 else 2e-2
        forced = teacher_forced(teng, kvc, gen_mod, llama, params32, cfg32,
                                layout, q8, gen)
        check(forced <= bar, f"{name}: teacher-forced decode logits {forced} "
              f"> {bar} of max from decode_step over a dense f32 cache")
        row = {"phase": "serving", "kernel": name, "kv_layout": layout,
               "kv_int8": q8, "slots": SERVE_SLOTS, "max_ctx": SERVE_MAX_CTX,
               "page_size": PAGE_SIZE, "layers": cfg.num_hidden_layers,
               "prompt_lens": lens.tolist(), "new_tokens": SERVE_NEW_TOKENS,
               "runs": runs, "burst8_pipeline_equals_burst1": True,
               "teacher_forced_rel_err": forced, "teacher_forced_bar": bar,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               **serving_figures(teng, qparams, cfg, prompts, layout, q8)}
        emit(row)
        if name == "flash_paged_decode":
            paged_bf16 = row
        torch.cuda.empty_cache()
    return launches, paged_bf16


def mixtral_config(loader):
    """Mixtral-8x7B's published widths through the port's loader, cut to
    :data:`MIXTRAL_LAYERS` layers."""
    cfg = loader._mixtral_cfg_from_hf(MIXTRAL_8X7B)
    return dataclasses.replace(cfg, num_hidden_layers=MIXTRAL_LAYERS)


def moe_launches(cfg, kinds, dispatch):
    """Kernel A launches of one Mixtral forward of at most ``FUSED_M_MAX``
    rows: per layer q, k, v, o (or qkv, o) and, per expert run (top-k
    sparse, all dense), w1, w3, w2 (or w13, w2); stacked: moe_w13 and
    moe_w2."""
    attn = 2 if kinds != "unfused" else 4
    if kinds == "stacked":
        return cfg.num_hidden_layers * (attn + 2)
    experts = (cfg.num_experts_per_tok if dispatch == "sparse"
               else cfg.num_local_experts)
    per_expert = 3 if kinds == "unfused" else 2
    return cfg.num_hidden_layers * (attn + experts * per_expert)


@contextlib.contextmanager
def moe_dispatch(mixtral, dispatch):
    """While active, every ``moe_ffn`` call runs with ``dispatch``."""
    orig = mixtral.moe_ffn

    def forced(layer, cfg, x, **kw):
        return orig(layer, cfg, x, **{**kw, "dispatch": dispatch})

    mixtral.moe_ffn = forced
    try:
        yield
    finally:
        mixtral.moe_ffn = orig


def check_quantized(params, linear, cfg, kinds):
    """Every linear of a Mixtral layer any4t at g=128 (the router and
    ``lm_head`` bf16), with the keys of ``kinds``."""
    want = {"unfused": {"q_proj", "k_proj", "v_proj", "o_proj", "w1", "w3",
                        "w2"},
            "fused": {"qkv_proj", "o_proj", "w13", "w2"},
            "stacked": {"qkv_proj", "o_proj", "moe_w13", "moe_w2"}}[kinds]
    seen = set()
    for layer in params["layers"]:
        leaves = [(k, v) for k, v in layer.items() if k != "experts"] + [
            (k, v) for e in layer.get("experts", []) for k, v in e.items()]
        for key, leaf in leaves:
            if isinstance(leaf, linear.QuantizedTensor):
                check(leaf.fmt == "any4t" and leaf.group_size == 128,
                      f"{kinds} {key} is {leaf.fmt} g={leaf.group_size}")
                seen.add(key)
        check(isinstance(layer["router"], torch.Tensor)
              and layer["router"].dtype == torch.bfloat16, "router bf16")
    check(seen == want, f"{kinds}: quantized linears {sorted(seen)}")
    check(isinstance(params["lm_head"], torch.Tensor)
          and params["embed_tokens"].dtype == torch.bfloat16,
          "lm_head and embed_tokens stay bf16")


@contextlib.contextmanager
def routing(mixtral, record=None, replay=None):
    """While active, every ``mixtral.route`` call appends its router logits
    (f32) and top-k experts to ``record``; or, with ``replay``, routes
    each call to the experts recorded for it, with gates from its own
    router logits (a softmax over those experts' logits, as ``route``
    takes), and yields a list that gains, per call, ``(positions where a
    replayed expert is not among the call's own top k, the largest
    distance of such an expert's logit below the call's own k-th best,
    max|own - recorded logits|)``, each distance over max|own logits|."""
    orig = mixtral.route
    calls = None if replay is None else iter(replay)
    out = []

    def route(layer, cfg, x):
        logits = mixtral.lin.linear(x, layer["router"]).float()
        if calls is None:
            topi, gate = orig(layer, cfg, x)
            record.append((logits, topi))
            return topi, gate
        theirs, topi = next(calls)
        scale = logits.abs().max()
        kth = torch.sort(logits, dim=-1, descending=True).values[
            ..., cfg.num_experts_per_tok - 1:cfg.num_experts_per_tok]
        chosen = logits.gather(-1, topi)
        below = (kth - chosen).clamp_min(0) / scale
        out.append((int((below > 0).any(-1).sum()), float(below.max()),
                    float((logits - theirs).abs().max() / scale)))
        return topi, torch.softmax(chosen, dim=-1)

    mixtral.route = route
    try:
        yield out
    finally:
        mixtral.route = orig


def dense_f32_check(mixtral, linear, params, cfg, ids):
    """The quantized model with float32 activations against the dense
    float32 forward of its exactly dequantized weights, the reference
    routed as the quantized forward routed (:func:`routing`): a routing of
    random weights changes on a near-tie between router logits, and any
    difference in what comes before the router can move such a tie, so
    the reference takes the same experts and the router logits are held
    to the same bar as the output. Returns ``{rel_err, router_rel_err,
    routing_flips, routing_flip_gap}``: max|logits - ref| / max|ref|, the
    same of the router logits over every layer, the positions where the
    two routings differ and how far below the reference's own k-th best
    router logit a replayed expert lay there (over max|logit|)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rec = []
    with routing(mixtral, record=rec):
        got = mixtral.forward(to_float32(params, linear), cfg32, ids)[0]
    with routing(mixtral, replay=rec) as calls:
        ref = mixtral.forward(to_float32(params, linear, dequantize=True),
                              cfg32, ids)[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "Mixtral logits finite")
    return {"rel_err": rel_err(got, ref),
            "router_rel_err": max(e for _, _, e in calls),
            "routing_flips": sum(f for f, _, _ in calls),
            "routing_flip_gap": max(g for _, g, _ in calls)}


def generate_launches(gemv, gen_mod, params, cfg, prompt, per_prefill,
                      per_step):
    """``generate`` at batch 1 with host ms, kernel A launching exactly
    ``per_prefill`` + (NEW_TOKENS - 1) x ``per_step`` times."""
    gemv.reset_launches()
    tokens, ms = timed_generate(gen_mod, params, cfg, prompt[:1])
    want = per_prefill + (NEW_TOKENS - 1) * per_step
    check(gemv.LAUNCHES["q4_lut_post"] == want and sum(
        gemv.LAUNCHES.values()) == want, f"generate b=1: kernel A launches "
        f"{dict(gemv.LAUNCHES)} != {per_prefill} + {NEW_TOKENS - 1} x "
        f"{per_step}")
    check(tokens.shape == (1, PROMPT_LEN + NEW_TOKENS) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens b=1")
    return tokens, ms


def mixtral_path(gemv, loader, mixtral, gen_mod, llama, api, linear):
    """Mixtral-8x7B at full width, 2 layers, any4 g=128; see the module
    docstring (phase 12). Returns the dense bf16 and the quantized trees,
    the config and kernel A's launches in ``generate``."""
    cfg = mixtral_config(loader)
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = api.quantize_model(params, fmt="any4", group_size=128,
                                 kmeans_iters=10)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check_quantized(qparams, linear, cfg, "unfused")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    errs = dense_f32_check(mixtral, linear, qparams, cfg, prompt[:1])
    emit({"phase": "main_path_check_mixtral", "bar": 2e-2, **errs})
    check(errs["rel_err"] <= 2e-2 and errs["router_rel_err"] <= 2e-2,
          f"Mixtral any4 logits or router logits (float32 activations) vs "
          f"the dequantized model's dense float32 forward: {errs} > 2e-2 of "
          f"max")

    # sparse (auto at b=1) against dense, bit for bit, over 4 decode steps
    sparse_pf = moe_launches(cfg, "unfused", "sparse")
    dense_pf = moe_launches(cfg, "unfused", "dense")
    steps = 4
    caches = llama.init_kv_caches(cfg, 1, PROMPT_LEN + steps)
    gen_mod.prefill(qparams, cfg, prompt[:1].long(), caches)
    for i in range(steps):
        tok = prompt[:1, i]
        logits = {}
        for dispatch in ("sparse", "dense"):
            gemv.reset_launches()
            with moe_dispatch(mixtral, dispatch):
                logits[dispatch], _ = gen_mod.decode_step(
                    qparams, cfg, tok, PROMPT_LEN + i, caches)
            torch.cuda.synchronize()
            want = sparse_pf if dispatch == "sparse" else dense_pf
            check_launches(gemv, {"q4_lut_post": want}, 1,
                           f"Mixtral decode step, {dispatch} dispatch")
        check(torch.equal(logits["sparse"], logits["dense"]),
              f"Mixtral b=1 decode step {i}: sparse logits != dense")
    del caches

    torch.cuda.reset_peak_memory_stats()
    gemv.reset_launches()
    gen_ms, tokens = {}, {}
    for b in (1, 4):
        tokens[b], gen_ms[b] = timed_generate(gen_mod, qparams, cfg,
                                              prompt[:b])
    # a prefill of b * 64 rows and b = 4 decode runs dense, b = 1 sparse
    want = 2 * dense_pf + (NEW_TOKENS - 1) * (sparse_pf + dense_pf)
    launches = dict(gemv.LAUNCHES)
    check(launches["q4_lut_post"] == want and sum(launches.values()) == want,
          f"Mixtral generate: kernel A launches {launches} != {want}")
    for b, tok in tokens.items():
        check(tok.shape == (b, PROMPT_LEN + NEW_TOKENS)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
              and torch.equal(tok[:, :PROMPT_LEN], prompt[:b]),
              f"Mixtral tokens b={b}")
    peak_mem = torch.cuda.max_memory_allocated()
    figs = decode_figures(gen_mod, llama, qparams, cfg, prompt)
    prof = device_profile(gen_mod, llama, qparams, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / figs[1]["decode_ms_per_token"])
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    gemv.reset_launches()
    check(bool(torch.isfinite(mixtral.forward(qparams, cfg, ids)[0]).all()),
          "Mixtral 1024-token logits finite")
    torch.cuda.synchronize()
    chunks = -(-1024 // linear.FUSED_M_MAX)
    check_launches(gemv, {"q4_lut_post": dense_pf}, chunks,
                   f"Mixtral 1024-token forward: kernel A a "
                   f"{linear.FUSED_M_MAX}-row chunk")
    prefill = prefill_chunks(llama, qparams, cfg, gen, fwd=mixtral.forward)
    emit({"phase": "main_path_mixtral", "model": "mixtral_8x7b",
          "source": "mistralai/Mixtral-8x7B-v0.1 config.json",
          "layers": cfg.num_hidden_layers, "reduced": {
              "num_hidden_layers": [MIXTRAL_8X7B["num_hidden_layers"],
                                    cfg.num_hidden_layers]},
          "fmt": "any4", "group_size": 128, "kmeans_iters": 10,
          "init_s": init_s, "quantize_s": quantize_s,
          "launches": launches, "launches_per_forward": {
              "b1_sparse": sparse_pf, "dense": dense_pf},
          "sparse_equals_dense_decode_steps": steps,
          "generate_ms": gen_ms, "max_memory_allocated": peak_mem,
          "model_bytes_any4": api.model_size_bytes(qparams),
          "model_bytes_bf16": api.model_size_bytes(params),
          "mixtral": figs, "profile_b1": prof,
          "prefill_1024_tokens_forward_ms": prefill,
          "b4_row0_equals_b1": bool(torch.equal(tokens[4][0], tokens[1][0]))})
    return params, qparams, cfg, launches["q4_lut_post"]


def mixtral_fused_stacked(params, cfg, gemv, mixtral, gen_mod, llama, api,
                          linear, fuse):
    """The Mixtral model fused (qkv and each expert's w13), and fused then
    stacked (``moe_w13``/``moe_w2``), each quantized to any4 at g=128:
    logits within 2e-2 * max of the dense float32 forward; kernel A 12 and
    8 launches a b=1 decode step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    out = {}
    for kinds in ("fused", "stacked"):
        tree = fuse.fuse_projections(params)
        if kinds == "stacked":
            tree = fuse.stack_experts(tree)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = api.quantize_model(tree, fmt="any4", group_size=128,
                               kmeans_iters=10)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        del tree
        torch.cuda.empty_cache()
        check_quantized(q, linear, cfg, kinds)
        errs = dense_f32_check(mixtral, linear, q, cfg, prompt[:1])
        check(errs["rel_err"] <= 2e-2 and errs["router_rel_err"] <= 2e-2,
              f"Mixtral {kinds} logits or router logits (float32 "
              f"activations) vs the dense float32 forward: {errs} > 2e-2 of "
              f"max")
        step = moe_launches(cfg, kinds, "sparse")
        _, ms = generate_launches(gemv, gen_mod, q, cfg, prompt,
                                  moe_launches(cfg, kinds, "dense"), step)
        figs = decode_figures(gen_mod, llama, q, cfg, prompt)
        prof = device_profile(gen_mod, llama, q, cfg, prompt)
        prof["busy_share_b1"] = (prof["device_ms_per_step"]
                                 / figs[1]["decode_ms_per_token"])
        out[kinds] = {"check_vs_dense_f32": errs,
                      "launches_per_decode_step_b1": step,
                      "quantize_s": quantize_s, "generate_ms_b1": ms,
                      "model_bytes": api.model_size_bytes(q),
                      "mixtral": figs, "profile_b1": prof}
        del q
        torch.cuda.empty_cache()
    emit({"phase": "mixtral_fused_stacked", "layers": cfg.num_hidden_layers,
          "bar": 2e-2, **out})


def mixtral_serving(qparams, cfg, gemv, kvc, teng, gen_mod, llama, linear):
    """The any4 Mixtral model behind the engine (paged bf16 pools, the
    prompts of phase 5) at ``run(burst=1)`` and ``run(burst=8,
    pipeline=True)``: equal tokens, exact launches (every expert a decode
    step: dense dispatch), the teacher-forced step within 2e-2 * max."""
    prompts = serve_prompts(cfg)
    per_forward = moe_launches(cfg, "unfused", "dense")
    out, runs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for mode, run_kw in (("burst1", dict(burst=1)),
                         ("burst8_pipeline", dict(burst=8, pipeline=True))):
        gemv.reset_launches()
        kvc.reset_launches()
        out[mode], e, wall = serve(teng, qparams, cfg, prompts, "paged",
                                   False, run_kw)
        steps = e.decode_steps
        chunks = sum(-(-e._bucket(len(p)) // linear.FUSED_M_MAX)
                     for p in prompts)
        check(all(len(t) == SERVE_NEW_TOKENS
                  and all(0 <= x < cfg.vocab_size for x in t)
                  for t in out[mode]), f"Mixtral {mode}: every request "
              f"gives {SERVE_NEW_TOKENS} tokens in the vocabulary")
        check(kvc.LAUNCHES["flash_paged_decode"] == cfg.num_hidden_layers
              * steps and sum(kvc.LAUNCHES.values())
              == kvc.LAUNCHES["flash_paged_decode"],
              f"Mixtral {mode}: attention launches {kvc.LAUNCHES}")
        check_launches(gemv, {"q4_lut_post": per_forward}, steps + chunks,
                       f"Mixtral {mode} engine ({steps} steps + {chunks} "
                       f"prefill chunks)")
        runs[mode] = {"launches": {**gemv.LAUNCHES, **kvc.LAUNCHES},
                      "decode_steps": steps,
                      "graph_replays": e.graph_replays,
                      "prefill_chunks": chunks, "wall_s": wall,
                      "tok_s": SERVE_REQUESTS * SERVE_NEW_TOKENS / wall}
        del e
    check(out["burst1"] == out["burst8_pipeline"],
          "Mixtral: run(burst=8, pipeline=True) tokens differ from "
          "run(burst=1)")
    forced = teacher_forced(
        teng, kvc, gen_mod, llama, to_float32(qparams, linear),
        dataclasses.replace(cfg, dtype=torch.float32), "paged", False,
        torch.Generator(device="cuda").manual_seed(6))
    check(forced <= 2e-2, f"Mixtral: teacher-forced decode logits {forced} "
          f"> 2e-2 of max from decode_step over a dense f32 cache")
    emit({"phase": "serving_mixtral", "kv_layout": "paged", "kv_int8": False,
          "slots": SERVE_SLOTS, "max_ctx": SERVE_MAX_CTX,
          "page_size": PAGE_SIZE, "layers": cfg.num_hidden_layers,
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW_TOKENS, "runs": runs,
          "burst8_pipeline_equals_burst1": True,
          "teacher_forced_rel_err": forced, "teacher_forced_bar": 2e-2,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **serving_figures(teng, qparams, cfg, prompts, "paged", False)})
    return runs["burst1"]["launches"]["flash_paged_decode"]


def timed_forward(fn, reps=3):
    """(host ms, device ms) of one call of ``fn``: the host clock over
    ``reps`` calls ending in a synchronize, and the kernels' time from
    ``torch.profiler`` over as many, both per call, after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA) / 1e3 / reps
    return host, device


def opt_path(gemv, opt, api, linear):
    """OPT-125m at full width and depth, any4 g=128 (72 linears, all
    ``any4t``, unfused: the forward reads q/k/v apart): logits of a
    64-token prompt with float32 activations within 2e-2 * max of the
    dense float32 forward; 64- and 1024-token forwards at b=1 and 4 with
    exactly 72 kernel A launches per ``FUSED_M_MAX``-row chunk, and their
    host and device ms."""
    cfg = opt.OPTConfig.opt_125m()
    params = opt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = api.quantize_model(params, fmt="any4", group_size=128,
                           kmeans_iters=10)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    per_chunk = 6 * cfg.num_hidden_layers
    fmts = [l.fmt for layer in q["layers"] for l in layer.values()
            if isinstance(l, linear.QuantizedTensor)]
    check(len(fmts) == per_chunk and set(fmts) == {"any4t"}
          and isinstance(q["embed_tokens"], torch.Tensor),
          f"OPT: every linear any4t, the tied table bf16 ({set(fmts)})")
    gen = torch.Generator(device="cuda").manual_seed(13)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    got = opt.forward(to_float32(q, linear), cfg32, ids[:1, :PROMPT_LEN])[0]
    ref = opt.forward(to_float32(q, linear, dequantize=True), cfg32,
                      ids[:1, :PROMPT_LEN])[0]
    err = rel_err(got, ref)
    check(bool(torch.isfinite(got).all()) and err <= 2e-2,
          f"OPT any4 logits (float32 activations) vs the dense float32 "
          f"forward: {err} > 2e-2 of max")
    del got, ref
    launches, times = {}, {}
    for b in (1, 4):
        for t in (PROMPT_LEN, 1024):
            x = ids[:b, :t]
            gemv.reset_launches()
            logits, _ = opt.forward(q, cfg, x)
            torch.cuda.synchronize()
            check(logits.shape == (b, t, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), f"OPT b={b} t={t}")
            chunks = -(-b * t // linear.FUSED_M_MAX)
            check_launches(gemv, {"q4_lut_post": per_chunk}, chunks,
                           f"OPT forward b={b} t={t}")
            launches[f"b{b}_t{t}"] = gemv.LAUNCHES["q4_lut_post"]
            host, device = timed_forward(lambda: opt.forward(q, cfg, x))
            dense_host, dense_device = timed_forward(
                lambda: opt.forward(params, cfg, x))
            times[f"b{b}_t{t}"] = {"host_ms": host, "device_ms": device,
                                   "dense_bf16_host_ms": dense_host,
                                   "dense_bf16_device_ms": dense_device}
    emit({"phase": "main_path_opt", "model": "opt_125m",
          "layers": cfg.num_hidden_layers, "fmt": "any4", "group_size": 128,
          "kmeans_iters": 10, "quantize_s": quantize_s,
          "rel_err_any4_f32_vs_dense_f32": err, "bar": 2e-2,
          "launches_per_chunk": per_chunk, "launches": launches,
          "forward": times, "model_bytes": api.model_size_bytes(q),
          "model_bytes_bf16": api.model_size_bytes(params)})
    return sum(launches.values())


def calib_ids(cfg, seed=2):
    """CALIB_TOKENS seeded calibration token ids ``[1, CALIB_TOKENS]``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (1, CALIB_TOKENS), generator=gen,
                         device="cuda", dtype=torch.int32)


def seconds(fn):
    """``(fn(), host seconds)``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def deterministic():
    """While active, PyTorch runs its deterministic kernels (k-means'
    ``scatter_add_`` sums in a fixed order) and warns where it has none."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def llama_cut(llama, layers):
    cfg = llama.LlamaConfig.llama_3_2_1b()
    return cfg if not layers else dataclasses.replace(
        cfg, num_hidden_layers=layers)


def neutral_err(fwd, awq, linear, params, results, cfg, ids):
    """max|logits| difference of the float32 model with ``results``'
    scales applied (no clip) from the unscaled float32 model, over
    max|logits|: AWQ's scaling is exact in exact arithmetic."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_float32(params, linear)
    base = fwd(p32, cfg32, ids)[0]
    scaled = fwd(awq.apply_awq(p32, results, do_clip=False), cfg32, ids)[0]
    torch.cuda.synchronize()
    return rel_err(scaled, base)


def kernel_err(fwd, linear, q, cfg, ids):
    """The quantized model with float32 activations against the dense
    float32 forward of its exactly dequantized weights."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    got = fwd(to_float32(q, linear), cfg32, ids)[0]
    ref = fwd(to_float32(q, linear, dequantize=True), cfg32, ids)[0]
    check(bool(torch.isfinite(got).all()), "quantized logits finite")
    return rel_err(got, ref)


def quantized_leaves(q, linear):
    """The quantized weights of a Llama or OPT tree's layers."""
    return [w for layer in q["layers"] for w in layer.values()
            if isinstance(w, linear.QuantizedTensor)]


def check_any4(q, linear, count):
    fmts = [w.fmt for w in quantized_leaves(q, linear)]
    check(len(fmts) == count and set(fmts) == {"any4t"},
          f"every linear any4t at g=128 ({len(fmts)} of {count}: "
          f"{sorted(set(fmts))})")


def same_search(card, cpu):
    """The card's grid MSEs within 1e-5 relative of the CPU's, and the same
    argmin (or two within SEARCH_TIE of each other)."""
    card, cpu = card.double().cpu(), cpu.double()
    rel = float(((card - cpu).abs() / cpu.abs()).max())
    i, j = int(card.argmin()), int(cpu.argmin())
    tie = abs(float(cpu[i] - cpu[j])) <= SEARCH_TIE * float(cpu[j])
    return rel, i, j, i == j or tie


def awq_main_path(args, gemv, llama, gen_mod, api, linear, awq, cal):
    """Llama-3.2-1B at full width and depth (``--layers`` cuts it): AWQ
    (int) -> calibration -> any4 g=128 -> ``generate`` at b=1 on kernel A;
    see the module docstring (phase 13). Returns kernel A's launches in
    ``generate``."""
    cfg = llama_cut(llama, args.layers)
    per_forward = cfg.num_hidden_layers * 7
    params = llama.init_params(cfg, seed=0, device="cuda")
    ids = calib_ids(cfg)
    (results, aparams), awq_s = seconds(
        lambda: awq.run_awq(params, cfg, ids, numeric_type="int"))
    sw, calibrate_s = seconds(lambda: cal.calibrate(aparams, cfg, ids))
    q, quantize_s = seconds(lambda: api.quantize_model(
        aparams, fmt="any4", group_size=128, sample_weight=sw,
        kmeans_iters=10))
    check_any4(q, linear, per_forward)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)

    neutral = neutral_err(llama.forward, awq, linear, params, results, cfg,
                          prompt)
    check(neutral <= 1e-4, f"AWQ scales not output-neutral in float32: "
          f"{neutral} > 1e-4 of max")
    gemv.reset_launches()
    err = kernel_err(llama.forward, linear, q, cfg, prompt)
    check_launches(gemv, {"q4_lut_post": per_forward}, 1,
                   "AWQ any4 forward (float32 activations)")
    check(err <= 2e-2, f"AWQ any4 logits (float32 activations) vs the "
          f"dequantized model's float32 dense forward: {err} > 2e-2")

    # the search on the card against the same search on the CPU: layer 0's
    # q/k/v group on the unscaled weights and its captured input
    store = llama.Capture(raw=True)
    llama.forward(params, cfg, ids, capture=store)
    x = torch.cat(store.rows["layers.0.q_proj"])
    del store
    ws = [params["layers"][0][f"{p}_proj"] for p in "qkv"]
    x_max = x.abs().mean(dim=0) + 1e-8
    card = awq._scale_search_mses(x, ws, x_max, 20, 4, 128, "int")
    cpu = awq._scale_search_mses(x.cpu(), [w.cpu() for w in ws],
                                 x_max.cpu(), 20, 4, 128, "int")
    rel, i_card, i_cpu, same = same_search(card, cpu)
    chosen = results["scales"]["layers.0.input_layernorm"]["ratio"]
    chosen_mse = float(card[round(chosen * 20)])
    check(rel <= 1e-5 and same
          and chosen_mse <= float(card.min()) * (1 + SEARCH_TIE),
          f"AWQ search on the card vs the CPU: MSEs {rel} > 1e-5 relative, "
          f"or ratios {i_card}/20 (card), {i_cpu}/20 (CPU), {chosen} "
          f"(run_awq)")

    # the bf16 model's logits: quantized with and without AWQ
    orig = llama.forward(params, cfg, prompt)[0]
    plain = api.quantize_model(params, fmt="any4", group_size=128,
                               kmeans_iters=10, sample_weight=cal.calibrate(
                                   params, cfg, ids))
    vs_bf16 = {"awq": rel_err(llama.forward(q, cfg, prompt)[0], orig),
               "no_awq": rel_err(llama.forward(plain, cfg, prompt)[0], orig)}
    del plain, aparams
    torch.cuda.empty_cache()

    gemv.reset_launches()
    tokens, gen_ms = timed_generate(gen_mod, q, cfg, prompt)
    check_launches(gemv, {"q4_lut_post": per_forward}, NEW_TOKENS,
                   "AWQ any4 generate b=1")
    launches = gemv.LAUNCHES["q4_lut_post"]
    check(tokens.shape == (1, PROMPT_LEN + NEW_TOKENS) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "AWQ tokens")
    figs = decode_figures(gen_mod, llama, q, cfg, prompt, batches=(1,))
    prof = device_profile(gen_mod, llama, q, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / figs[1]["decode_ms_per_token"])
    emit({"phase": "awq_main_path", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "numeric_type": "int",
          "calib_tokens": CALIB_TOKENS, "fmt": "any4", "group_size": 128,
          "kmeans_iters": 10, "awq_s": awq_s, "calibrate_s": calibrate_s,
          "quantize_s": quantize_s,
          "ratios": {k: v["ratio"] for k, v in results["scales"].items()},
          "clip": results["clip"],
          "neutral_rel_err_f32": neutral, "neutral_bar": 1e-4,
          "rel_err_any4_f32_vs_dense_f32": err, "bar": 2e-2,
          "search_card_vs_cpu": {"max_rel_mse": rel, "ratio_card": i_card / 20,
                                 "ratio_cpu": i_cpu / 20,
                                 "mses_card": card.tolist()},
          "rel_err_vs_bf16": vs_bf16, "launches_per_forward": per_forward,
          "launches": launches, "generate_ms_b1": gen_ms,
          "decode_b1": figs[1], "profile_b1": prof})
    return launches


def awq_any4_search(llama, awq, linear):
    """The any4 search (``numeric_type="any4"``, the paper's pairing) on the
    1B model cut to AWQ_CUT_LAYERS layers: seconds a layer, peak memory,
    and the scales output-neutral in float32."""
    cfg = llama_cut(llama, AWQ_CUT_LAYERS)
    params = llama.init_params(cfg, seed=0, device="cuda")
    ids = calib_ids(cfg)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (results, _), awq_s = seconds(
        lambda: awq.run_awq(params, cfg, ids, numeric_type="any4"))
    peak = torch.cuda.max_memory_allocated()
    neutral = neutral_err(llama.forward, awq, linear, params, results, cfg,
                          ids)
    check(neutral <= 1e-4, f"any4 AWQ scales not output-neutral: {neutral}")
    emit({"phase": "awq_any4_search", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "numeric_type": "any4",
          "awq_s": awq_s, "awq_s_per_layer": awq_s / cfg.num_hidden_layers,
          "max_memory_allocated": peak, "allocated_before": before,
          "ratios": {k: v["ratio"] for k, v in results["scales"].items()},
          "clip": results["clip"], "neutral_rel_err_f32": neutral})


def y_mse(linear, w, qt, x):
    """mean((x W^T - x Wq^T)^2) of a weight and its quantized form."""
    wq = linear.dequantize_tensor(qt, torch.float32)
    return float(torch.mean((x @ w.float().t() - x @ wq.t()) ** 2))


def nnq_path(gemv, llama, gen_mod, api, linear):
    """any4 with nnq (``y_mse``, 200 Adam steps a weight) on the 1B model
    cut to AWQ_CUT_LAYERS layers: each layer's summed ``y_mse`` on the
    activations ``learn_lut`` drew is no worse than that of the k-means
    LUTs (the same seeds) it started from; then ``generate`` at b=1."""
    cfg = llama_cut(llama, AWQ_CUT_LAYERS)
    per_forward = cfg.num_hidden_layers * 7
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = dict(fmt="any4", group_size=128, kmeans_iters=10)
    q0, kmeans_s = seconds(lambda: api.quantize_model(params, **kw))
    q1, nnq_s = seconds(lambda: api.quantize_model(
        params, nnq=True, nnq_args={"objective": "y_mse", "steps": 200},
        **kw))
    check_any4(q1, linear, per_forward)
    xs = {}
    ratio, per_layer = {}, []
    for i, (layer, l0, l1) in enumerate(zip(params["layers"], q0["layers"],
                                            q1["layers"])):
        before = after = 0.0
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            k = layer[name].shape[1]
            if k not in xs:     # learn_lut's draw: seed 0 on the device
                gen = torch.Generator(device="cuda").manual_seed(0)
                xs[k] = torch.randn((256, k), generator=gen, device="cuda")
            e0 = y_mse(linear, layer[name], l0[name], xs[k])
            e1 = y_mse(linear, layer[name], l1[name], xs[k])
            ratio[f"layers.{i}.{name}"] = e1 / e0
            before, after = before + e0, after + e1
        per_layer.append({"kmeans": before, "nnq": after})
        check(after <= before, f"nnq layer {i}: y_mse {after} > k-means "
              f"{before}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    err = kernel_err(llama.forward, linear, q1, cfg, prompt)
    check(err <= 2e-2, f"nnq logits vs the dense float32 forward: {err}")
    gemv.reset_launches()
    tokens, gen_ms = timed_generate(gen_mod, q1, cfg, prompt)
    check_launches(gemv, {"q4_lut_post": per_forward}, NEW_TOKENS,
                   "nnq any4 generate b=1")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "nnq tokens")
    emit({"phase": "nnq_path", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "objective": "y_mse",
          "steps": 200, "nnq_s": nnq_s, "kmeans_only_s": kmeans_s,
          "nnq_s_per_weight": (nnq_s - kmeans_s) / per_forward,
          "y_mse_per_layer": per_layer, "y_mse_ratio_per_weight": ratio,
          "rel_err_any4_f32_vs_dense_f32": err, "bar": 2e-2,
          "launches": gemv.LAUNCHES["q4_lut_post"], "generate_ms_b1": gen_ms})
    return gemv.LAUNCHES["q4_lut_post"]


def same_quantized(a, b, linear):
    """Do two quantized trees hold the same codes, LUTs, scales and zeros,
    bit for bit? Also the largest LUT difference."""
    equal, lut_diff = True, 0.0
    for x, y in zip(quantized_leaves(a, linear), quantized_leaves(b, linear)):
        equal &= all(torch.equal(getattr(x, f), getattr(y, f))
                     for f in ("packed", "scales", "zeros", "lut"))
        lut_diff = max(lut_diff, float((x.lut - y.lut).abs().max()))
    return equal, lut_diff


def calibrate_fn_path(llama, api, linear, cal):
    """``quantize_model(calibrate_fn=make_calibrate_fn(...))`` (a forward
    per layer) against ``quantize_model(sample_weight=calibrate(...))`` on
    the 1B model cut to AWQ_CUT_LAYERS layers: the same codes, LUTs,
    scales and zeros bit for bit with PyTorch's deterministic kernels; the
    same comparison without them is reported (k-means sums with atomics)."""
    cfg = llama_cut(llama, AWQ_CUT_LAYERS)
    params = llama.init_params(cfg, seed=0, device="cuda")
    ids = calib_ids(cfg)
    kw = dict(fmt="any4", group_size=128, kmeans_iters=10)
    out = {}
    for mode in ("default", "deterministic"):
        ctx = deterministic() if mode == "deterministic" \
            else contextlib.nullcontext()
        with ctx:
            online, online_s = seconds(lambda: api.quantize_model(
                params, calibrate_fn=cal.make_calibrate_fn(params, cfg, ids),
                **kw))
            offline, offline_s = seconds(lambda: api.quantize_model(
                params, sample_weight=cal.calibrate(params, cfg, ids), **kw))
        equal, lut_diff = same_quantized(online, offline, linear)
        out[mode] = {"bit_equal": equal, "max_lut_diff": lut_diff,
                     "calibrate_fn_s": online_s, "sample_weight_s": offline_s}
    emit({"phase": "calibrate_fn_path", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, **out})
    check(out["deterministic"]["bit_equal"], "calibrate_fn and sample_weight "
          "quantize to other bits with deterministic kernels")


def awq_mixtral(params, cfg, gemv, mixtral, gen_mod, llama, api, linear,
                awq):
    """Mixtral-8x7B (2 layers, published widths): AWQ (int; the router in
    the experts' w1/w3 group) -> any4 -> logits and router logits within
    2e-2 * max of the dense float32 forward -> ``generate`` at b=1, sparse
    dispatch (20 kernel A launches a step)."""
    ids = calib_ids(cfg)
    torch.cuda.reset_peak_memory_stats()
    (results, aparams), awq_s = seconds(
        lambda: awq.run_awq(params, cfg, ids, numeric_type="int"))
    peak = torch.cuda.max_memory_allocated()
    q, quantize_s = seconds(lambda: api.quantize_model(
        aparams, fmt="any4", group_size=128, kmeans_iters=10))
    del aparams
    check_quantized(q, linear, cfg, "unfused")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    errs = dense_f32_check(mixtral, linear, q, cfg, prompt)
    check(errs["rel_err"] <= 2e-2 and errs["router_rel_err"] <= 2e-2,
          f"AWQ Mixtral logits or router logits vs the dense float32 "
          f"forward: {errs} > 2e-2 of max")
    _, gen_ms = generate_launches(
        gemv, gen_mod, q, cfg, prompt, moe_launches(cfg, "unfused", "dense"),
        moe_launches(cfg, "unfused", "sparse"))
    emit({"phase": "awq_mixtral", "model": "mixtral_8x7b",
          "layers": cfg.num_hidden_layers, "numeric_type": "int",
          "awq_s": awq_s, "quantize_s": quantize_s,
          "max_memory_allocated_awq": peak,
          "ratios": {k: v["ratio"] for k, v in results["scales"].items()},
          "clip": results["clip"], **errs, "bar": 2e-2,
          "launches": gemv.LAUNCHES["q4_lut_post"], "generate_ms_b1": gen_ms})
    return gemv.LAUNCHES["q4_lut_post"]


def awq_opt(gemv, opt, api, linear, awq):
    """OPT-125m at full depth: AWQ (int; LayerNorm folds, ``v_bias`` and
    ``fc1_bias`` scaled with their rows), output-neutral in float32, then
    any4 and a 64-token forward (72 kernel A launches)."""
    cfg = opt.OPTConfig.opt_125m()
    params = opt.init_params(cfg, seed=0, device="cuda")
    ids = calib_ids(cfg)
    (results, aparams), awq_s = seconds(
        lambda: awq.run_awq(params, cfg, ids, numeric_type="int"))
    neutral = neutral_err(opt.forward, awq, linear, params, results, cfg,
                          ids[:, :PROMPT_LEN])
    check(neutral <= 1e-4, f"OPT AWQ scales not output-neutral: {neutral}")
    q, quantize_s = seconds(lambda: api.quantize_model(
        aparams, fmt="any4", group_size=128, kmeans_iters=10))
    per_chunk = 6 * cfg.num_hidden_layers
    check_any4(q, linear, per_chunk)
    gemv.reset_launches()
    err = kernel_err(opt.forward, linear, q, cfg, ids[:, :PROMPT_LEN])
    check_launches(gemv, {"q4_lut_post": per_chunk}, 1, "AWQ OPT forward")
    check(err <= 2e-2, f"AWQ OPT logits vs the dense float32 forward: {err}")
    emit({"phase": "awq_opt", "model": "opt_125m",
          "layers": cfg.num_hidden_layers, "numeric_type": "int",
          "awq_s": awq_s, "quantize_s": quantize_s,
          "ratios": {k: v["ratio"] for k, v in results["scales"].items()},
          "clip": results["clip"], "neutral_rel_err_f32": neutral,
          "rel_err_any4_f32_vs_dense_f32": err, "bar": 2e-2,
          "launches": per_chunk})
    return per_chunk


def plain_by_rows(plain, x, args, out, rows=16384):
    """Kernel A's plain version over blocks of ``rows`` weight rows (each
    output column depends on its own row only), concatenated."""
    packed, scales, zeros, lut, g = args
    n = packed.shape[0]
    per_row = lut.shape[0] == n
    return torch.cat([
        plain(x, packed[i:i + rows], scales[:, i:i + rows],
              zeros[:, i:i + rows], lut[i:i + rows] if per_row else lut, g,
              out) for i in range(0, n, rows)], dim=1)


def kernel_a_mixtral_shapes(gemv, packing, linear, timer, bw, peak,
                            shapes=MIXTRAL_SHAPES, ms=MIXTRAL_MS,
                            phase="kernel_mixtral_shapes", seed=17):
    """Kernel A (g=128, per-row LUT) at ``shapes`` (Mixtral's by default),
    m in ``ms``: held against its plain version (run over blocks of
    rows; bf16 output within 1e-2 * max, float32 within 1e-4 * max), with
    its launch plan, and timed as in the kernel phase beside a bf16
    ``torch.matmul`` on the dequantized weight and the bytes bound. Each
    shape is launched once before it is timed."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wrapper, plain = gemv.q4_lut_post, gemv.q4_lut_post_plain
    for name, (n, k) in shapes.items():
        codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                              dtype=torch.uint8)
        lut = torch.sort(torch.rand((n, 16), generator=gen, device="cuda"),
                         dim=1).values * 15.0 - 8.0
        G = packing.padded_k(k) // 128
        scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 \
            + 1e-3
        zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
        qt = linear.QuantizedTensor(packing.pack_codes(codes), scales, zeros,
                                    lut.contiguous(), "any4", 128, (n, k))
        del codes
        w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
        args = (qt.packed, qt.scales, qt.zeros, qt.lut, 128)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            errs, abs_err = {}, {}
            for out, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
                y = wrapper(x, *args, out)
                ref = plain_by_rows(plain, x, args, out)
                errs[str(out)] = rel_err(y, ref)
                abs_err[str(out)] = float((y.float() - ref.float()).abs()
                                          .max())
                del y, ref
                check(errs[str(out)] <= tol, f"kernel A {name} n={n} k={k} "
                      f"m={m} {out}: {errs[str(out)]} > {tol} of max")
            tn, per, split_blocks, floats, ints = gemv.post_launch_plan(
                "q4_lut_post", m, n, k, G, 128, sms)
            nbytes = (qt.packed.numel() * 4 + 2 * G * n * 4 + n * 16 * 4
                      + m * k * 2 + m * n * 2)
            t_bytes = nbytes / bw * 1e3
            t_ops = 2 * m * n * k / peak * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_by_rows(plain, x, args, torch.bfloat16)
            torch.cuda.synchronize()
            row = {"phase": phase, "name": "q4_lut_post",
                   "weight": name, "n": n, "k": k, "m": m,
                   "group_size": 128, "rel_err": errs,
                   "plan": {"token_tiles": tn, "groups_per_split": per,
                            "split_blocks": split_blocks,
                            "scratch_floats": floats, "counters": ints},
                   "ms": timer(lambda: wrapper(x, *args, torch.bfloat16)),
                   "plain_ms": (time.perf_counter() - t0) * 1e3,
                   "plain_timed_as": "one call, host clock, synchronized",
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16.t())),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": 2 * m * n * k,
                   "max_abs_err": abs_err[str(torch.bfloat16)]}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            emit(row)
            rows.append(row)
        del qt, w_bf16
        torch.cuda.empty_cache()
    return rows


def attention_mixtral_shape(kvc, timer, bw):
    """``flash_paged_decode`` at Mixtral's attention shape (8 kv heads, rep
    4, head_dim 128: the kernel's general body, not the ``SMALL`` one) at
    b=8, ctx 2048, bf16 pools and q: held within 1e-2 * max of its plain
    version (float32 within 1e-4), timed against SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    name = "flash_paged_decode"
    b, ctx = ATTN_TIMED
    dims = dict(h=8, rep=4, d=128)
    fn, plain, args = attn_inputs(kvc, name, b, ctx, gen, torch.bfloat16,
                                  torch.bfloat16, **dims)
    y, ref = fn(*args), plain(*args)
    err = float((y.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    check(bool(torch.isfinite(y).all()) and err <= 1e-2 * scale,
          f"{name} at Mixtral's shape: |kernel - plain| {err} > 1e-2 * "
          f"{scale}")
    f32_fn, f32_plain, f32_args = attn_inputs(
        kvc, name, b, ctx, gen, torch.float32, torch.float32, **dims)
    f32 = rel_err(f32_fn(*f32_args), f32_plain(*f32_args))
    check(f32 <= 1e-4, f"{name} at Mixtral's shape, float32: {f32} > 1e-4")
    bound, by, nbytes, flops = attn_bound(name, args, bw)
    split = kvc.split_len(b, dims["h"])
    row = {"phase": "attention_kernel", "shape": "mixtral_8x7b",
           "name": name, "b": b, "ctx": ctx, **dims, "page_size": PAGE_SIZE,
           "S": split, "splits": -(-ctx // split),
           "pool": "torch.bfloat16", "q": "torch.bfloat16",
           "ms": timer(lambda: fn(*args)),
           "plain_ms": timer(lambda: plain(*args), reps=3),
           "library_ms": timer(sdpa_yardstick(kvc, args)),
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "flops": flops, "max_abs_err": err, "rel_err": err / scale,
           "f32_rel_err": f32, "bar": 1e-2}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit(row)
    return row


def attention_tp_heads(kvc, timer, bw):
    """Each attention kernel at a tensor-parallel rank's kv heads
    (:data:`TP_HEADS`: 4 at tp=2, 2 at tp=4; the 1B's rep 4 and head_dim
    64), where ``split_len(b, h)`` changes with h: at b=1 and 8, ctx 2048,
    held against its plain version (bf16 pools within 1e-2 * max, int8
    within 2e-2; float32 q and pools within 1e-4 at b=8) and timed
    against SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for name, (layout, q8, _) in ATTN_KERNELS.items():
        pool_dtype = torch.int8 if q8 else torch.bfloat16
        tol = 2e-2 if q8 else 1e-2
        for h in TP_HEADS:
            fn, plain, args = attn_inputs(
                kvc, name, *ATTN_TIMED, gen,
                torch.int8 if q8 else torch.float32, torch.float32, h=h)
            f32 = rel_err(fn(*args), plain(*args))
            check(f32 <= 1e-4, f"{name} at {h} kv heads, float32: {f32} > "
                  f"1e-4 of max")
            for b, ctx in ATTN_CASES[:2]:
                fn, plain, args = attn_inputs(kvc, name, b, ctx, gen,
                                              pool_dtype, torch.bfloat16,
                                              h=h)
                y, ref = fn(*args), plain(*args)
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(y).all()) and err <= tol * scale,
                      f"{name} at {h} kv heads, b={b} ctx={ctx}: |kernel - "
                      f"plain| {err} > {tol} * {scale}")
                bound, by, nbytes, flops = attn_bound(name, args, bw)
                split = kvc.split_len(b, h)
                row = {"phase": "attention_tp_heads", "name": name, "b": b,
                       "ctx": ctx, "h": h, "rep": ATTN_REP,
                       "d": ATTN_HEAD_DIM, "page_size": PAGE_SIZE,
                       "S": split, "splits": -(-ctx // split),
                       "pool": str(pool_dtype), "q": "torch.bfloat16",
                       "ms": timer(lambda: fn(*args)),
                       "plain_ms": timer(lambda: plain(*args), reps=3),
                       "library_ms": timer(sdpa_yardstick(kvc, args)),
                       "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                       "flops": flops, "max_abs_err": err,
                       "rel_err": err / scale, "bar": tol}
                if (b, ctx) == ATTN_TIMED:
                    row["f32_rel_err"] = f32
                row["bound_share"] = row["bound_ms"] / row["ms"]
                emit(row)
                rows.append(row)
                del args
    return rows


def tp_kernel_checks(gemv, packing, linear, kvc, bw, peak):
    """Kernel A at :data:`TP_SHAPES` and the attention kernels at
    :data:`TP_HEADS` (the tensor-parallel paths' shapes), each against its
    plain version; returns both phases' rows."""
    timer = Timer()
    rows = kernel_a_mixtral_shapes(gemv, packing, linear, timer, bw, peak,
                                   shapes=TP_SHAPES, ms=TP_MS,
                                   phase="kernel_a_tp_shapes", seed=23)
    attn = attention_tp_heads(kvc, timer, bw)
    del timer
    torch.cuda.empty_cache()
    return rows, attn


def run_cli(main, argv):
    """A script's ``main(argv)`` with its standard output kept: its return
    value and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue().splitlines()


def kxk_table(gemv, bw, peak):
    """(a) of the cli_tools phase: the microbenchmark's 1xK . KxK sweep;
    each quantized call held against its kernel's plain version first,
    exact launch counts. Returns A's and C's ``kxk`` lists."""
    from any4_tpu_torch.cli import microbenchmark as mb
    rounds, iters = 12, 20
    checks = {}

    def check_row(k, x, wb, qts):
        for fmt, qt in qts.items():
            name = KXK_KERNELS[fmt]
            y = mb.sweep_call(x, qt)
            plain = getattr(gemv, f"{name}_plain")(
                x, qt.packed, qt.scales, qt.zeros,
                qt.lut if name in gemv.LUT_KERNELS else None,
                qt.group_size, torch.bfloat16)
            err = rel_err(y, plain)
            check(err <= 1e-2, f"K={k} {fmt}: {name} vs its plain version "
                               f"{err} > 1e-2 of max")
            moved = qt.nbytes + x.numel() * 2 + k * 2
            t_bytes, t_ops = moved / bw, 2.0 * x.shape[0] * k * k / peak
            checks[(k, fmt)] = {
                "rel_err": err,
                "max_abs_err": float((y.float() - plain.float()).abs().max()),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    gemv.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):     # the table line
        table = mb.sweep(rounds=rounds, iters=iters, check=check_row)
    per_k = 2 + rounds * iters      # the check, the warm-up, the windows
    want = {"q4_int4_magic": len(table) * per_k,
            "q4_lut_post": 2 * len(table) * per_k}
    got = {k: v for k, v in gemv.LAUNCHES.items() if v}
    check(got == want, f"K x K launches {got} != {want}")
    out = {"q4_lut_post": [], "q4_int4_magic": []}
    for k, row in table.items():
        emit({"phase": "cli_tools_kxk", "k": k, "m": 1, **row,
              "rel_err": {f: checks[(k, f)]["rel_err"] for f in KXK_KERNELS},
              "library": "torch.matmul(x, w_bf16.T)"})
        for fmt, name in KXK_KERNELS.items():
            out[name].append({
                "k": k, "n": k, "m": 1, "fmt": fmt,
                "ms": row[f"{fmt}_us"] / 1e3,
                "library_ms": row["bf16_us"] / 1e3,
                "speedup_over_library": row[fmt],
                "launches": per_k - 1, **checks[(k, fmt)]})
    return out


def micro_check(linear, fmt, x, qt):
    """(b)'s check of one row: ``linear.linear(x, qt)`` on the card against
    the same call on CPU copies, which runs the plain versions: bf16 x
    (bf16 out) within 1e-2 * max; for the formats that quantize x, float32
    x as well (float32 out; exact integer dots) within 1e-5 * max. Returns
    the errors by x dtype."""
    cpu_qt = to_device(qt, "cpu", linear)
    xs = {"bf16": (x, 1e-2)}
    if qt.fmt in linear.ACT_INT8_FMTS:
        xs["f32"] = (x.float(), 1e-5)
    errs = {}
    for name, (xi, bar) in xs.items():
        y = linear.linear(xi, qt)
        check(y.dtype == xi.dtype and y.shape == (x.shape[0], qt.shape[0]),
              f"{fmt}: output {y.dtype} {tuple(y.shape)}")
        errs[name] = rel_err(y.cpu(), linear.linear(xi.cpu(), cpu_qt))
        check(errs[name] <= bar, f"{fmt} ({qt.fmt}) at {name} x: "
                                 f"{errs[name]} > {bar} of max")
    return errs


def cli_tools(params, qparams, cfg, gemv, linear, llama, gen_mod, bw, peak):
    """Phase 14: the port's measuring tools and scripts on the card; see the
    module docstring. ``params``/``qparams``: phase 4's bf16 and any4
    models. Returns kernel A's and C's ``kxk`` lists and kernel A's
    launches in (c) and (d)."""
    import tempfile
    from any4_tpu_torch import profiler, utils
    from any4_tpu_torch.cli import benchmark, calibrate as cal_cli
    from any4_tpu_torch.cli import example, microbenchmark as mb
    from any4_tpu_torch.cli import quantize as quant_cli
    from any4_tpu_torch.models import checkpoint

    t0 = time.perf_counter()
    kxk = kxk_table(gemv, bw, peak)
    # (b) one row per --quantize choice at K = N = 4096, m = 1, each held
    # against the plain versions before it is timed
    check(sorted(MICRO_ROUTES) == sorted(mb.FORMATS), "a format's route")
    for fmt in mb.FORMATS:
        errs = {}
        row, _ = run_cli(lambda argv: mb.main(
            argv, check=lambda x, qt: errs.update(
                micro_check(linear, fmt, x, qt))),
            ["--input-dim", "4096", "--output-dim", "4096", "--batch", "1",
             "--quantize", fmt])
        check(bool(errs), f"{fmt}: the row was not checked")
        emit({"phase": "cli_microbenchmark", **row, "rel_err": errs})
        want = {MICRO_ROUTES[fmt]: 1 + 12 * 20}
        check(row["kernels"] == want,
              f"{fmt}: launches {row['kernels']} != {want}")
    # (c) the 1B at full width and depth: decode tokens/s, then the profile
    per_forward = cfg.num_hidden_layers * 7
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, BENCH_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    figures, a_launches = {}, 0
    for name, p in (("bf16", params), ("any4", qparams)):
        gemv.reset_launches()
        tps, tokens = benchmark.decode_tokens_per_s(p, cfg, prompt,
                                                    BENCH_NEW_TOKENS)
        got = gemv.LAUNCHES["q4_lut_post"]
        want = per_forward * (1 + 4 * BENCH_NEW_TOKENS) if name == "any4" \
            else 0
        check(got == want and sum(gemv.LAUNCHES.values()) == got,
              f"{name} decode_tokens_per_s launches {dict(gemv.LAUNCHES)}; "
              f"kernel A {want} expected")
        a_launches += got
        ref = gen_mod.generate(p, cfg, prompt, max_new_tokens=BENCH_NEW_TOKENS)
        check(torch.equal(tokens[:, :BENCH_NEW_TOKENS],
                          ref[:, BENCH_PROMPT:]),
              f"{name}: decode_tokens_per_s's tokens != generate's")
        figures[name] = {"tok_s": tps, "tokens_equal_generate": True,
                         "launches_q4_lut_post": got}
    gemv.reset_launches()
    rounds, iters = 6, 20
    prof = profiler.profile_decode_components(qparams, cfg, ctx=PROFILE_CTX,
                                              iters=iters, rounds=rounds)
    calls = cfg.num_hidden_layers * (1 + rounds * iters)
    got = dict(gemv.LAUNCHES)
    check(got["q4_lut_post"] == calls * 7
          and sum(got.values()) == calls * 7,
          f"profile launches {got} != kernel A {calls} x (4 + 3)")
    a_launches += got["q4_lut_post"]
    emit({"phase": "cli_benchmark", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "batch": 1,
          "prompt_tokens": BENCH_PROMPT, "new_tokens": BENCH_NEW_TOKENS,
          **{f"{k}_tok_s": v["tok_s"] for k, v in figures.items()},
          "speedup": figures["any4"]["tok_s"] / figures["bf16"]["tok_s"],
          "figures": figures})
    emit({"phase": "cli_profile", "model": "llama_3_2_1b", "fmt": "any4",
          "ctx": PROFILE_CTX, "iters": iters, "rounds": rounds,
          "launches_q4_lut_post": got["q4_lut_post"],
          "totals": prof["totals"],
          "layers": {k: v for k, v in prof.items() if k != "totals"}})
    stats = utils.device_memory_stats()
    emit({"phase": "cli_memory", "model": "llama_3_2_1b",
          "model_bytes_bf16": utils.get_model_size(params),
          "model_bytes_any4": utils.get_model_size(qparams),
          "device_memory_stats": {k: stats[k] for k in (
              "allocated_bytes.all.current", "allocated_bytes.all.peak",
              "reserved_bytes.all.current", "reserved_bytes.all.peak",
              "num_alloc_retries", "num_ooms")},
          "resident": "the bf16 and any4 models"})
    # (d) the scripts on the card, on their tiny model
    with tempfile.TemporaryDirectory() as d:
        (qp, qcfg), _ = run_cli(quant_cli.main, [
            "--tiny", "--awq", "--calibrate", "--group-size", "64",
            "--output", os.path.join(d, "q")])
        loaded, lcfg = checkpoint.load_params(os.path.join(d, "q"),
                                              device="cuda")
        check(lcfg == qcfg, "the checkpoint's config")
        ids = torch.randint(0, qcfg.vocab_size, (2, 16), generator=gen,
                            device="cuda", dtype=torch.int32)
        check(torch.equal(llama.forward(qp, qcfg, ids)[0],
                          llama.forward(loaded, lcfg, ids)[0]),
              "the quantize CLI's checkpoint gives the in-memory logits")
        acts, _ = run_cli(cal_cli.main, ["--tiny", "--output",
                                         os.path.join(d, "acts.npz")])
        check(len(acts) == 14 and os.path.exists(os.path.join(d, "acts.npz")),
              "the calibrate CLI's activations")
        (before, after), lines = run_cli(example.main, ["--tiny"])
        check(before.shape == after.shape == (1, 16), "example's tokens")
        # the benchmark script: its tiny any4 model (g=128) has k = 64
        # linears at g = 64 (kernel B) and down_proj at g = 128 (kernel A)
        gemv.reset_launches()
        bench, _ = run_cli(benchmark.main, [
            "--tiny", "--profile", "--max-new-tokens", str(TINY_NEW_TOKENS)])
        check(set(bench) == BENCH_KEYS, f"benchmark's fields {sorted(bench)}")
        check(all(math.isfinite(bench[k]) and bench[k] > 0 for k in (
            "baseline_tok_s", "any4_tok_s", "speedup")), "benchmark's rates")
        for prof in (bench["profile_baseline"], bench["profile_quantized"]):
            check(prof["totals"]["layers_profiled"] == 2
                  and math.isfinite(prof["totals"]["sum_ms"]),
                  "benchmark's profiles")
        # per layer: 1 + 4 new_tokens forwards, 1 + 6 x 20 profile calls
        calls = 2 * (1 + 4 * TINY_NEW_TOKENS + 1 + 6 * 20)
        want = {"q4_lut_post": calls, "q4_lut_fused": 6 * calls}
        got = {k: v for k, v in gemv.LAUNCHES.items() if v}
        check(got == want, f"benchmark --tiny launches {got} != {want}")
        a_launches += got["q4_lut_post"]
        emit({"phase": "cli_scripts", "quantize": "--tiny --awq --calibrate "
              "--group-size 64: checkpoint logits bit-equal on the card",
              "calibrate_layers": len(acts), "example": lines,
              "benchmark": {k: bench[k] for k in (
                  "baseline_tok_s", "any4_tok_s", "speedup",
                  "model_bytes_baseline", "model_bytes_quantized")},
              "benchmark_launches": got})
    emit({"phase": "cli_tools", "seconds": time.perf_counter() - t0})
    return kxk, a_launches


def forward_launches(linear, per_forward, rows):
    """Kernel A's launches in one forward over ``rows`` token rows: each of
    ``per_forward`` linears once per ``FUSED_M_MAX`` rows."""
    return per_forward * -(-rows // linear.FUSED_M_MAX)


def score_launches(linear, per_forward, token_lists, batch_size):
    """Kernel A's launches in ``TorchCausalLM._score_batch``: the lists
    sorted by length, in batches of ``batch_size`` padded to their
    longest."""
    lens = sorted(len(t) for t in token_lists)
    return sum(forward_launches(linear, per_forward,
                                len(lens[i:i + batch_size])
                                * lens[i:i + batch_size][-1])
               for i in range(0, len(lens), batch_size))


def only_kernel_a(gemv, want, what):
    """Kernel A launched exactly ``want`` times since the last reset, and
    no other kernel; returns its count."""
    check_launches(gemv, {"q4_lut_post": want}, 1, what)
    return gemv.LAUNCHES["q4_lut_post"]


def device_seconds(fn):
    """The CUDA kernels' summed time in one ``fn()`` under
    ``torch.profiler``, and the three that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            per_kernel[ev.key] = (per_kernel.get(ev.key, 0.0)
                                  + ev.self_device_time_total)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    return (sum(per_kernel.values()) / 1e6,
            {k[:80]: v / 1e6 for k, v in top})


def rel_gap(a, ref) -> float:
    return abs(a - ref) / max(abs(ref), 1e-30)


def evals_ppl(qparams, ref, cfg, cfg32, gemv, linear, log_dir):
    """(a) of the evals phase: ``run_perplexity_tasks`` (synthetic, 2048
    tokens a window) with each evaluator over the any4 model, against the
    same over the dequantized float32 model; exact kernel A launches.
    Returns kernel A's launches."""
    from any4_tpu_torch.evals import datasets, harness, perplexity
    per_forward = cfg.num_hidden_layers * 7
    tokens = datasets.synthetic_tokens(cfg.vocab_size)
    # the stream evaluator's windows over the harness's pseudo-documents
    docs = np.array_split(tokens, max(len(tokens) // (4 * EVAL_SEQLEN), 1))
    windows = [min(EVAL_SEQLEN, len(d) - 1 - s) for d in docs
               for s in range(0, len(d) - 1, EVAL_SEQLEN)]
    runs = {"chunked": ([EVAL_SEQLEN] * EVAL_CHUNKS,
                        EVAL_CHUNKS * (EVAL_SEQLEN - 1)),
            "stream": (windows, sum(windows))}
    # the run's first 2048-token forward picks cuBLAS's algorithms and grows
    # the allocator: it is timed apart, before the evaluators
    _, first_s = seconds(lambda: perplexity.eval_perplexity_chunked(
        qparams, cfg, tokens, seqlen=EVAL_SEQLEN, max_chunks=1))
    a_launches = 0
    for ev, (forwards, targets) in runs.items():
        kw = dict(seqlen=EVAL_SEQLEN, max_chunks=EVAL_CHUNKS, synthetic=True,
                  evaluator=ev)
        d = os.path.join(log_dir, ev)
        want = sum(forward_launches(linear, per_forward, t)
                   for t in forwards)
        torch.cuda.reset_peak_memory_stats()
        gemv.reset_launches()
        res, secs = seconds(lambda: harness.run_perplexity_tasks(
            qparams, cfg, ["wikitext-2"], log_dir=d, **kw))
        peak_mem = torch.cuda.max_memory_allocated()
        a_launches += only_kernel_a(gemv, want, f"{ev} perplexity")
        gemv.reset_launches()
        ref_res, ref_secs = seconds(lambda: harness.run_perplexity_tasks(
            ref, cfg32, ["wikitext-2"], **kw))
        check_launches(gemv, {}, 1, "the dequantized float32 model")
        (name, ppl), = res.items()
        log_ppl, ref_log = math.log(ppl), math.log(ref_res[name])
        gap = rel_gap(log_ppl, ref_log)
        check(name == "synthetic:wikitext-2" and math.isfinite(log_ppl)
              and gap <= PPL_BAR, f"{ev}: log-perplexity {log_ppl} vs the "
              f"float32 model's {ref_log}: {gap} > {PPL_BAR} relative")
        with open(os.path.join(d, "results.json")) as f:
            logged = json.load(f)
        check(set(logged) == {name} and logged[name]["result"] == ppl
              and logged[name]["seqlen"] == EVAL_SEQLEN, "results.json")
        row = {"phase": "evals_ppl", "evaluator": ev, "seqlen": EVAL_SEQLEN,
               "forwards": len(forwards), "target_tokens": targets,
               "seconds": secs, "tokens_scored_per_s": targets / secs,
               "log_ppl": log_ppl, "ref_log_ppl_f32": ref_log,
               "rel_gap": gap, "bar": PPL_BAR,
               "launches_q4_lut_post": want,
               "max_memory_allocated": peak_mem, "ref_seconds": ref_secs}
        if ev == "chunked":
            dev_s, top = device_seconds(
                lambda: perplexity.eval_perplexity_chunked(
                    qparams, cfg, tokens, seqlen=EVAL_SEQLEN, max_chunks=1))
            row.update(first_chunk_s=first_s, device_s_per_chunk=dev_s,
                       host_s_per_chunk=secs / EVAL_CHUNKS,
                       busy_share=dev_s / (secs / EVAL_CHUNKS),
                       top_kernels_s=top)
        emit(row)
    gaps, launches = token_logprob_gaps(qparams, ref, cfg, cfg32, tokens,
                                        gemv, linear)
    emit({"phase": "evals_ppl_tokens", **gaps, "bar": PPL_TOKEN_BAR})
    check(gaps["max_abs_gap"] <= PPL_TOKEN_BAR,
          f"per-token log-probs: largest gap {gaps['max_abs_gap']} > "
          f"{PPL_TOKEN_BAR} nats")
    return a_launches + launches


def token_logprob_gaps(qparams, ref, cfg, cfg32, tokens, gemv, linear):
    """Each target token's log-prob in the chunked evaluator's
    EVAL_CHUNKS chunks under the any4 model and under the dequantized
    float32 one (``perplexity.token_logprobs``): the gaps in nats, beside
    the spread of the float32 model's log-probs. Returns them and kernel
    A's launches, which must be exact."""
    from any4_tpu_torch.evals import perplexity
    from any4_tpu_torch.models import llama
    per_forward = cfg.num_hidden_layers * 7
    chunks = torch.from_numpy(tokens[:EVAL_CHUNKS * EVAL_SEQLEN].astype(
        np.int64).reshape(EVAL_CHUNKS, 1, EVAL_SEQLEN)).cuda()
    got, want = [], []
    gemv.reset_launches()
    for c in chunks:
        got.append(perplexity.token_logprobs(
            llama.forward(qparams, cfg, c)[0], c[:, 1:])[0])
    launches = only_kernel_a(
        gemv, EVAL_CHUNKS * forward_launches(linear, per_forward, EVAL_SEQLEN),
        "per-token log-probs")
    gemv.reset_launches()
    for c in chunks:
        want.append(perplexity.token_logprobs(
            llama.forward(ref, cfg32, c)[0], c[:, 1:])[0])
    check_launches(gemv, {}, 1, "the float32 model's per-token log-probs")
    got, want = torch.cat(got), torch.cat(want)
    gap = (got - want).abs()
    return {"tokens": gap.numel(), "max_abs_gap": float(gap.max()),
            "mean_abs_gap": float(gap.mean()),
            "max_abs_gap_by_chunk": gap.amax(1).tolist(),
            "ref_logprob_mean": float(want.mean()),
            "ref_logprob_std": float(want.std())}, launches


def evals_lm_protocol(qparams, ref, cfg, cfg32, gemv, linear, gen_mod,
                      log_dir):
    """(b) of the evals phase: ``TorchCausalLM`` over the any4 model with
    the byte tokenizer; see the module docstring. Returns kernel A's
    launches."""
    from any4_tpu_torch.evals import code_eval, tasks_local
    from any4_tpu_torch.evals.lm_eval_adapter import TorchCausalLM
    per_forward = cfg.num_hidden_layers * 7
    tok = tasks_local.ByteTokenizer()
    lm = TorchCausalLM(qparams, cfg, tok, batch_size=LL_BATCH,
                       max_length=EVAL_SEQLEN)
    rng = np.random.default_rng(7)

    def text(n):
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    def scored(reqs):
        """The token lists ``loglikelihood`` scores for ``reqs``."""
        return [((tok.encode(c) or [tok.bos_token_id])
                 + tok.encode(x))[-EVAL_SEQLEN:] for c, x in reqs]

    requests = [(text(c), " " + text(n - 1) if n else "")
                for c, n in LL_LENGTHS]
    lists = scored(requests)
    want = score_launches(linear, per_forward, lists, LL_BATCH) + sum(
        score_launches(linear, per_forward, [t], 1) for t in lists)
    gemv.reset_launches()
    batched, ll_s = seconds(lambda: lm.loglikelihood(requests))
    singles = [lm.loglikelihood([r])[0] for r in requests]
    a = only_kernel_a(gemv, want, "loglikelihood")
    # the same quantized weights with float32 activations (kernel A still
    # rounds x to bf16): bf16 logits move by an ulp with the batch's shape
    # (cuBLAS's head and attention), which 16 random bf16 layers carry to
    # about 1e-3 of a request's score; float32 ones hold the padding and
    # the batching to the bar
    lm32 = TorchCausalLM(to_float32(qparams, linear), cfg32, tok,
                         batch_size=LL_BATCH, max_length=EVAL_SEQLEN)
    gemv.reset_launches()
    batched32 = lm32.loglikelihood(requests)
    singles32 = [lm32.loglikelihood([r])[0] for r in requests]
    a += only_kernel_a(gemv, want, "loglikelihood, float32 activations")
    del lm32
    ref_lm = TorchCausalLM(ref, cfg32, tok, batch_size=LL_BATCH,
                           max_length=EVAL_SEQLEN)
    gemv.reset_launches()
    f32 = ref_lm.loglikelihood(requests)
    check_launches(gemv, {}, 1, "the float32 model's loglikelihood")
    check(batched[-1] == singles[-1] == batched32[-1] == (0.0, True),
          "the empty continuation scores (0.0, True)")

    def gap(xs, ys):
        return [rel_gap(x[0], y[0]) for x, y in zip(xs, ys)]

    gaps = {"bf16_batched_vs_single": gap(batched, singles),
            "f32_act_batched_vs_single": gap(batched32, singles32),
            "bf16_vs_dense_f32": gap(batched, f32)}
    worst = {k: max(v) for k, v in gaps.items()}
    check(all(math.isfinite(b[0]) and b[0] <= 0 for b in batched)
          and worst["f32_act_batched_vs_single"] <= BATCH_BAR
          and worst["bf16_batched_vs_single"] <= BF16_BATCH_BAR
          and worst["bf16_vs_dense_f32"] <= LL_F32_BAR,
          f"loglikelihood gaps {worst}: float32 activations batched vs one "
          f"at a time within {BATCH_BAR}, bf16 within {BF16_BATCH_BAR}, "
          f"bf16 vs the float32 model within {LL_F32_BAR}")

    long_text = text(ROLLING_BYTES)
    ids = tok.encode(long_text)
    windows = [w for w in (ids[s:s + EVAL_SEQLEN] for s in range(
        0, len(ids) - 1, EVAL_SEQLEN - 1)) if len(w) >= 2]
    gemv.reset_launches()
    [rolled], roll_s = seconds(
        lambda: lm.loglikelihood_rolling([(long_text,)]))
    one_by_one = sum(float(lm._score_batch([w])[0][0].sum())
                     for w in windows)
    a += only_kernel_a(gemv, score_launches(
        linear, per_forward, windows, LL_BATCH) + sum(
        score_launches(linear, per_forward, [w], 1) for w in windows),
        "loglikelihood_rolling")
    roll_gap = rel_gap(rolled, one_by_one)
    check(len(windows) == 3 and math.isfinite(rolled)
          and roll_gap <= ROLL_BAR,
          f"rolling {rolled} vs its windows one by one {one_by_one}")

    prompt = text(64)
    pids = tok.encode(prompt)
    gemv.reset_launches()
    [gen_text], gen_s = seconds(lambda: lm.generate_until(
        [(prompt, {"until": [], "max_gen_toks": GEN_TOKENS})]))
    toks = lm.greedy_tokens(pids, GEN_TOKENS)
    ref_tokens = gen_mod.generate(
        qparams, cfg, torch.tensor([pids], device="cuda"),
        max_new_tokens=GEN_TOKENS)[0, len(pids):].tolist()
    # greedy_tokens stops before the byte tokenizer's eos
    cut = ref_tokens.index(tok.eos_token_id) \
        if tok.eos_token_id in ref_tokens else GEN_TOKENS
    steps = min(len(toks), GEN_TOKENS - 1)
    a += only_kernel_a(gemv, 2 * (forward_launches(
        linear, per_forward, len(pids)) + per_forward * steps)
        + forward_launches(linear, per_forward, len(pids))
        + per_forward * (GEN_TOKENS - 1), "generate_until and generate")
    check(toks == ref_tokens[:cut] and gen_text == tok.decode(toks),
          f"generate_until's tokens {toks} != generate's {ref_tokens}")

    gemv.reset_launches()
    mc, mc_s = seconds(lambda: tasks_local.run_local_task(lm, "local_mc"))
    mc_lists = scored([(ex["context"], c)
                       for ex in tasks_local.BUILTIN_MC_EXAMPLES
                       for c in ex["choices"]])
    a += only_kernel_a(gemv, score_launches(linear, per_forward, mc_lists,
                                            LL_BATCH), "local_mc")
    # each code problem's generation: its prompt's and its greedy tokens'
    # counts give its prefill and decode steps
    gens, greedy = [], lm.greedy_tokens

    def recorded(ids, max_new, until=()):
        toks = greedy(ids, max_new, until)
        gens.append((len(ids), max_new, len(toks)))
        return toks

    lm.greedy_tokens = recorded
    gemv.reset_launches()
    code, code_s = seconds(lambda: code_eval.run_code_tasks(
        lm, ["builtin"], max_gen_toks=CODE_TOKENS, log_dir=log_dir))
    del lm.greedy_tokens
    code_launches = sum(forward_launches(linear, per_forward, p)
                        + per_forward * min(n, max_new - 1)
                        for p, max_new, n in gens)
    check(len(gens) == 4, f"code tasks: {len(gens)} generations, not 4")
    a += only_kernel_a(gemv, code_launches, "code tasks")
    check(set(mc) == {"acc", "acc_norm", "n"} and mc["n"] == 6
          and set(code) == {"builtin"}
          and set(code["builtin"]) == {"pass@1", "n_problems"}
          and code["builtin"]["n_problems"] == 4
          and os.path.exists(os.path.join(log_dir, "code_builtin.json")),
          f"local_mc {mc}, code {code}")
    emit({"phase": "evals_lm_protocol", "batch_size": LL_BATCH,
          "max_length": EVAL_SEQLEN, "requests": len(requests),
          "request_tokens": [len(t) for t in lists],
          "loglikelihood_s": ll_s, "max_rel_gaps": worst,
          "rel_gaps": gaps, "bar_f32_act_batched": BATCH_BAR,
          "bar_bf16_batched": BF16_BATCH_BAR, "bar_vs_f32": LL_F32_BAR,
          "loglikelihood": [b[0] for b in batched],
          "rolling": {"bytes": ROLLING_BYTES, "windows": len(windows),
                      "total": rolled, "windows_one_by_one": one_by_one,
                      "rel_gap": roll_gap, "bar": ROLL_BAR,
                      "seconds": roll_s},
          "generate_until": {"max_gen_toks": GEN_TOKENS,
                             "tokens": len(toks), "seconds": gen_s,
                             "equals_generate": True},
          "local_mc": mc, "local_mc_s": mc_s, "code": code["builtin"],
          "code_max_gen_toks": CODE_TOKENS, "code_s": code_s,
          "code_generations": [{"prompt": p, "max_new": m, "tokens": n}
                               for p, m, n in gens],
          "code_launches_q4_lut_post": code_launches,
          "launches_q4_lut_post": a,
          "note": "accuracies of random weights mean nothing"})
    return a


def evals_analyze(params, cfg, gemv, api, log_dir, plots):
    """(c) of the evals phase: ``analyze_model`` and ``diff_models`` over
    the bf16 model's first ANALYZE_LAYERS layers; ``write_plots`` where
    matplotlib is installed (``plots``)."""
    from any4_tpu_torch.evals import analyze
    cut = {**params, "layers": params["layers"][:ANALYZE_LAYERS]}
    cfg_cut = dataclasses.replace(cfg, num_hidden_layers=ANALYZE_LAYERS)
    rows, an_s = seconds(lambda: analyze.analyze_model(
        cut, fmts=["int4", "nf4", "any4"], group_size=128,
        out_dir=log_dir))
    check(len(rows) == 7 * ANALYZE_LAYERS
          and os.path.exists(os.path.join(log_dir, "stats.csv")),
          f"analyze_model rows {len(rows)}")
    for r in rows:
        check(r["any4_w_mse"] <= r["int4_w_mse"],
              f"{r['layer']}: any4 w_mse {r['any4_w_mse']} > int4's "
              f"{r['int4_w_mse']}")
    pdf = None
    if plots:
        path = analyze.write_plots(cut, rows, log_dir)
        pdf = os.path.getsize(path)
        check(pdf > 0, "plots.pdf is empty")
    pseudo = api.quantize_model(cut, fmt="any4", group_size=128, pseudo=True,
                                kmeans_iters=10)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                        device="cuda", dtype=torch.int32)
    gemv.reset_launches()
    diff, diff_s = seconds(lambda: analyze.diff_models(
        cut, pseudo, cfg_cut, ids, out_dir=log_dir))
    same = analyze.diff_models(cut, cut, cfg_cut, ids)
    check_launches(gemv, {}, 1, "diff_models over dense weights")
    check(len(diff) == 7 * ANALYZE_LAYERS + 1 and diff[-1]["layer"] ==
          "logits" and all(math.isfinite(r["mse"]) for r in diff),
          "diff_models rows")
    check(all(r["mse"] == 0.0 for r in same),
          "a model against itself gives MSE 0")
    emit({"phase": "evals_analyze", "layers": ANALYZE_LAYERS,
          "weights": len(rows), "analyze_s": an_s, "diff_s": diff_s,
          "plots_pdf_bytes": pdf if plots else
          "not run: matplotlib is not installed",
          "w_mse": {r["layer"]: {f: r[f"{f}_w_mse"] for f in
                                 ("int4", "nf4", "any4")} for r in rows},
          "y_cossim": {r["layer"]: {f: r[f"{f}_y_cossim"] for f in
                                    ("int4", "nf4", "any4")} for r in rows},
          "diff": diff})


def evals_cli(gemv, log_dir, plots):
    """(d) of the evals phase: the eval, analyze and diff scripts on their
    tiny models on the card. Returns the eval script's launches."""
    from any4_tpu_torch.cli import analyze as analyze_cli
    from any4_tpu_torch.cli import diff as diff_cli
    from any4_tpu_torch.cli import eval as eval_cli
    d = os.path.join(log_dir, "eval")
    gemv.reset_launches()
    (results, _), eval_s = seconds(lambda: run_cli(eval_cli.main, [
        "--tiny", "--quantize", "any4", "--tasks", "synthetic", "--seqlen",
        "128", "--max-chunks", "2", "--lm-eval-tasks", "local_mc",
        "--code-tasks", "builtin", "--log-dir", d]))
    launches = {k: v for k, v in gemv.LAUNCHES.items() if v}
    # the tiny any4 model at g=128: the k = 64 linears take g = 64
    # (kernel B), down_proj (k = 128) kernel A
    check(set(launches) == {"q4_lut_post", "q4_lut_fused"}
          and launches["q4_lut_fused"] == 6 * launches["q4_lut_post"],
          f"eval --tiny launches {launches}")
    with open(os.path.join(d, "results.json")) as f:
        logged = json.load(f)
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    check(set(results) == set(logged) == EVAL_RESULTS
          and args["cpu"] is False and args["quantize"] == "any4"
          and math.isfinite(results["synthetic:wikitext-2"])
          and os.path.exists(os.path.join(d, "command_line.txt"))
          and os.path.exists(os.path.join(d, "code_builtin.json")),
          f"eval --tiny results {sorted(results)}, logged {sorted(logged)}")
    an_dir = os.path.join(log_dir, "analyze")
    rows, _ = run_cli(analyze_cli.main, ["--tiny", "--log-dir", an_dir]
                      + ([] if plots else ["--no-plots"]))
    check(len(rows) == 15 and os.path.exists(os.path.join(an_dir,
                                                          "stats.csv"))
          and os.path.exists(os.path.join(an_dir, "plots.pdf")) == plots,
          "analyze --tiny")
    diff_dir = os.path.join(log_dir, "diff")
    diff, _ = run_cli(diff_cli.main, ["--tiny", "--log-dir", diff_dir])
    check(len(diff) == 15 and os.path.exists(os.path.join(diff_dir,
                                                          "diffs.csv")),
          "diff --tiny")
    emit({"phase": "evals_cli", "eval": results, "eval_s": eval_s,
          "eval_launches": launches, "analyze_rows": len(rows),
          "analyze_plots": plots, "diff_rows": len(diff),
          "diff_logits": diff[-1]})
    return launches


def evals_phase(params, qparams, cfg, gemv, linear, gen_mod, api):
    """Phase 15: the evals on phase 4's bf16 and any4 models, on the card;
    see the module docstring. Returns kernel A's and B's launches."""
    import importlib.util
    import tempfile
    t0 = time.perf_counter()
    plots = importlib.util.find_spec("matplotlib") is not None
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = to_float32(qparams, linear, dequantize=True)
    with tempfile.TemporaryDirectory() as d:
        a = evals_ppl(qparams, ref, cfg, cfg32, gemv, linear,
                      os.path.join(d, "ppl"))
        a += evals_lm_protocol(qparams, ref, cfg, cfg32, gemv, linear,
                               gen_mod, d)
        del ref
        torch.cuda.empty_cache()
        evals_analyze(params, cfg, gemv, api, os.path.join(d, "analyze"),
                      plots)
        cli = evals_cli(gemv, os.path.join(d, "cli"), plots)
    emit({"phase": "evals", "seconds": time.perf_counter() - t0,
          "launches_q4_lut_post": a + cli["q4_lut_post"],
          "launches_q4_lut_fused": cli["q4_lut_fused"]})
    return {"q4_lut_post": a + cli["q4_lut_post"],
            "q4_lut_fused": cli["q4_lut_fused"]}


# ---------------------------------------------------------------------------
# Phase 16: tensor parallelism (parallel/tp.py), ranks sharing the one card
# ---------------------------------------------------------------------------

def tp_greedy(llama, gen_mod, tp, mesh, local, specs, cfg, prompt, new):
    """Greedy decode of ``new`` tokens on one rank: the prompt's forward
    with the tp group writing the rank's caches, then ``new - 1`` steps of
    ``make_tp_forward(with_cache=True)``. Returns ``(tokens [1, t + new],
    host ms a decode step, the step function, the caches)``, the clock
    ending in a synchronize."""
    cfg_local = tp.local_config(cfg, mesh.tp)
    t = prompt.shape[1]
    # room for the step costs' 2 x TP_TIMED_STEPS steps after the tokens
    caches = llama.init_kv_caches(cfg_local, 1,
                                  t + new + 2 * TP_TIMED_STEPS,
                                  device="cuda")
    step = tp.make_tp_forward(cfg, mesh, specs, with_cache=True)
    logits, caches = llama.forward(
        local, cfg_local, prompt.long(), kv_caches=caches, cache_pos=None,
        mask=gen_mod._prefill_mask(t, caches[0][0].shape[1], prompt.device),
        tp_group=mesh.tp_group)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
    toks = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits, caches = step(local, tok, t + i, caches)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
    return (torch.cat([prompt, torch.stack(toks, dim=1)], dim=1), ms, step,
            caches)


def tp_step_costs(step, local, caches, pos, tok, dist):
    """Device ms a decode step (``torch.profiler``'s kernel time over
    ``TP_TIMED_STEPS`` steps) and all-reduce ms a step (the host clock
    around each ``all_reduce``, between synchronizes, in as many more
    steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(TP_TIMED_STEPS):
            step(local, tok, pos + i, caches)
        torch.cuda.synchronize()
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA) / 1e3
    spent = []
    orig = dist.all_reduce

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    dist.all_reduce = timed
    try:
        for i in range(TP_TIMED_STEPS):
            step(local, tok, pos + i, caches)
    finally:
        dist.all_reduce = orig
    return (device_ms / TP_TIMED_STEPS,
            sum(spent) * 1e3 / TP_TIMED_STEPS, len(spent) // TP_TIMED_STEPS)


def tp_rank_llama(job, mesh, mods):
    """One rank's share of the 1B model: the prompt's logits (bf16, float32
    activations, and float32 over the rank's dequantized shards) with kernel
    A's launches; at tp=2 also the greedy
    tokens, the teacher-forced logits along the unsharded run's tokens, the
    step costs, and the TP engine in each pool of TP_POOLS (its tokens,
    launches and teacher-forced decode logits)."""
    llama, gen_mod, tp, gemv, kvc, teng, linear, ckpt, dist = mods
    t0 = time.perf_counter()
    params, cfg = ckpt.load_params(job["checkpoint"], device="cuda")
    local, specs = tp.shard_params(params, mesh)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"load_shard_s": time.perf_counter() - t0}
    per_forward = cfg.num_hidden_layers * 7
    prompt = job["prompt"].cuda()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    local32 = to_float32(local, linear)
    gemv.reset_launches()
    out["logits_bf16"] = tp.make_tp_forward(cfg, mesh, specs)(
        local, prompt).float().cpu()
    out["launches_forward"] = dict(gemv.LAUNCHES)
    out["logits_f32"] = tp.make_tp_forward(cfg32, mesh, specs)(
        local32, prompt).cpu()
    deq = to_float32(local, linear, dequantize=True)
    out["logits_deq32"] = tp.make_tp_forward(cfg32, mesh, tp.param_specs(
        deq))(deq, prompt).cpu()
    del deq
    torch.cuda.empty_cache()
    if "ref_tokens" not in job:
        return out
    gemv.reset_launches()
    tokens, ms, step, caches = tp_greedy(llama, gen_mod, tp, mesh, local,
                                         specs, cfg, prompt, TP_NEW_TOKENS)
    out["launches_generate"] = dict(gemv.LAUNCHES)
    out["tokens"] = tokens.cpu()
    out["host_ms_per_token"] = ms
    out["device_ms_per_step"], out["all_reduce_ms_per_step"], \
        out["all_reduces_per_step"] = tp_step_costs(
            step, local, caches, tokens.shape[1] - 1, tokens[:, -1], dist)
    ref = job["ref_tokens"].cuda()
    t = prompt.shape[1]
    out["forced_logits"] = tp.make_tp_forward(cfg, mesh, specs)(
        local, ref[:, :-1])[0, t - 1:].float().cpu()
    prompts = serve_prompts(cfg)
    cfg32_local = tp.local_config(cfg32, mesh.tp)
    for layout, q8 in TP_POOLS:
        key = f"{layout}_{'int8' if q8 else 'bf16'}"
        e = teng.Engine(local, cfg, max_slots=SERVE_SLOTS,
                        max_ctx=SERVE_MAX_CTX, page_size=PAGE_SIZE,
                        kv_quantize=q8, kv_layout=layout, mesh=mesh,
                        param_spec=specs, device="cuda")
        uids = [e.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        gemv.reset_launches()
        kvc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {r.uid: r.out_tokens for r in e.run(burst=1)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = sum(-(-e._bucket(len(p)) // linear.FUSED_M_MAX)
                     for p in prompts)
        out[f"engine_{key}"] = {
            "tokens": [done[u] for u in uids], "wall_s": wall,
            "decode_steps": e.decode_steps, "prefill_chunks": chunks,
            "launches": {**gemv.LAUNCHES, **kvc.LAUNCHES},
            "want_linear": per_forward * (e.decode_steps + chunks),
            "want_attention": cfg.num_hidden_layers * e.decode_steps,
            "forced_logits": engine_forced(
                teng, kvc, local32, cfg32_local, layout, q8,
                job["forced_prompt"].cuda(), job["forced_toks"].cuda(),
                mesh.tp_group).float().cpu()}
        del e
        torch.cuda.empty_cache()
    return out


def tp_rank_mixtral(job, mesh, mods):
    """One rank's share of the 2-layer Mixtral-8x7B: for each dispatch, the
    prompt's logits in bf16 (with kernel A's launches) and with float32
    activations, each routed as the unsharded run routed (:func:`routing`
    replaying its record), and in float32 over the rank's dequantized
    shards, routed by the rank's own router."""
    llama, gen_mod, tp, gemv, kvc, teng, linear, ckpt, dist = mods
    from any4_tpu_torch.models import mixtral
    params = to_device(torch.load(job["weights"], weights_only=False),
                       "cuda", linear)
    cfg = job["cfg"]
    local, specs = tp.shard_params(params, mesh)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fwd = tp.make_tp_forward(cfg, mesh, specs, forward_fn=mixtral.forward)
    fwd32 = tp.make_tp_forward(cfg32, mesh, specs,
                               forward_fn=mixtral.forward)
    local32 = to_float32(local, linear)
    deq32 = to_float32(local, linear, dequantize=True)
    fwd_deq = tp.make_tp_forward(cfg32, mesh, tp.param_specs(deq32),
                                 forward_fn=mixtral.forward)
    out = {}
    for dispatch, records in job["routing"].items():
        prompt = job["ids"][dispatch].cuda()
        replay = {k: [(lg.cuda(), ti.cuda()) for lg, ti in rec]
                  for k, rec in records.items()}
        with moe_dispatch(mixtral, dispatch):
            with routing(mixtral, replay=replay["bf16"]) as calls:
                gemv.reset_launches()
                lg = fwd(local, prompt)
                launches = dict(gemv.LAUNCHES)
            with routing(mixtral, replay=replay["f32"]) as calls32:
                lg32 = fwd32(local32, prompt)
            deq = fwd_deq(deq32, prompt)
        out[dispatch] = {"logits_bf16": lg.float().cpu(),
                         "logits_f32": lg32.cpu(), "logits_deq32": deq.cpu(),
                         "launches": launches,
                         "routing_flips": sum(f for f, _, _ in calls)
                         + sum(f for f, _, _ in calls32)}
    del deq32
    torch.cuda.empty_cache()
    # stacked experts (a tiny dense model) are refused at tp > 1
    from any4_tpu_torch.models import fuse
    tiny = mixtral.MixtralConfig.tiny()
    stacked, _ = tp.shard_params(fuse.stack_experts(mixtral.init_params(
        tiny, seed=0, device="cuda")), mesh)
    try:
        mixtral.forward(stacked, tp.local_config(tiny, mesh.tp),
                        prompt % tiny.vocab_size, tp_group=mesh.tp_group)
        out["stacked_raised"] = None
    except ValueError as e:
        out["stacked_raised"] = str(e)
    return out


def tp_rank_sums(job, mesh, mods):
    """One rank's 1B logits over each checkpoint of ``job``, read twice
    with float32 partial sums (``llama.row_parallel``) and twice with bf16
    partials (each rank's product rounded to bf16 and all-reduced in bf16,
    as the JAX package's ``psum`` sums them): a list, one
    ``{"float32": [a, b], "bf16": [a, b]}`` a checkpoint."""
    llama, gen_mod, tp, gemv, kvc, teng, linear, ckpt, dist = mods
    prompt = job["prompt"].cuda()
    f32_sum = llama.row_parallel

    def bf16_sum(x, w, bias=None, tp_group=None, **kw):
        return llama.tp_all_reduce(linear.linear(x, w, bias, **kw), tp_group)

    out = []
    for path in job["checkpoints"]:
        params, cfg = ckpt.load_params(path, device="cuda")
        local, specs = tp.shard_params(params, mesh)
        del params
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        got = {}
        for mode, fn in (("float32", f32_sum), ("bf16", bf16_sum)):
            llama.row_parallel = fn
            try:
                got[mode] = [fwd(local, prompt).float().cpu()
                             for _ in range(2)]
            finally:
                llama.row_parallel = f32_sum
        out.append(got)
        del local
        torch.cuda.empty_cache()
    return out


def tp_rank(rank, world, address, job_path, results):
    """The body of one spawned rank: join the gloo world at ``address``,
    run the jobs of ``job_path`` on the tp mesh over every rank, save
    ``{"rank"}`` and each job's result beside the jobs (``torch.save``) and
    put ``{"rank", "path"}`` (or ``{"rank", "error"}``) on ``results``."""
    import traceback
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        import torch.distributed as dist
        from any4_tpu_torch.models import checkpoint as ckpt
        from any4_tpu_torch.models import generate as gen_mod, llama
        from any4_tpu_torch.ops import gemv, linear
        from any4_tpu_torch.parallel import distributed, tp
        from any4_tpu_torch.serving import engine as teng, kv_cache as kvc
        mods = (llama, gen_mod, tp, gemv, kvc, teng, linear, ckpt, dist)
        check(distributed.initialize(address, world, rank, backend="gloo"),
              "joined the gloo world")
        mesh = tp.make_mesh(dp=1, tp=world, device="cuda")
        jobs = torch.load(job_path, weights_only=False)
        out = {"rank": rank}
        for key, fn in (("llama", tp_rank_llama),
                        ("mixtral", tp_rank_mixtral), ("sums", tp_rank_sums)):
            if key in jobs:
                out[key] = fn(jobs[key], mesh, mods)
        dist.barrier()
        dist.destroy_process_group()
        path = f"{job_path}.rank{rank}"
        torch.save(out, path)
        results.put({"rank": rank, "path": path})
    except BaseException:        # the parent raises it: a rank's failure
        results.put({"rank": rank, "error": traceback.format_exc()})


def run_ranks(world, jobs, work):
    """Spawn ``world`` ranks on the card (gloo, a free localhost port), each
    running :func:`tp_rank` on ``jobs``; returns their results by rank.
    Raises if a rank fails or the ranks do not finish within TP_TIMEOUT_S;
    every rank is stopped either way."""
    import multiprocessing as mp
    import queue
    import socket
    path = os.path.join(work, f"jobs_tp{world}.pt")
    torch.save(jobs, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=tp_rank, args=(r, world, address, path,
                                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = {}
        deadline = time.perf_counter() + TP_TIMEOUT_S
        while len(got) < world:
            try:
                out = results.get(
                    timeout=max(deadline - time.perf_counter(), 1))
            except queue.Empty:
                late = sorted(set(range(world)) - set(got))
                raise RuntimeError(f"tp={world}: ranks {late} did not "
                                   f"finish in {TP_TIMEOUT_S} s") from None
            check("error" not in out,
                  f"tp={world} rank {out['rank']} failed:\n"
                  f"{out.get('error')}")
            got[out["rank"]] = torch.load(out["path"], weights_only=False)
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def tie_split(tokens, ref_tokens, ref_logits, t):
    """The QUANT_TIE rule of ``tests/test_torch_engine.py``: the position of
    the first token where ``tokens`` leave ``ref_tokens`` (None if they
    never do), which must be where the reference's two best logits lie
    within QUANT_TIE of max|logit| and the token taken one of those near
    the top. Raises otherwise."""
    new, ref_new = tokens[0, t:].tolist(), ref_tokens[0, t:].tolist()
    for j, (a, b) in enumerate(zip(new, ref_new)):
        if a == b:
            continue
        lg = ref_logits[j]
        tie = QUANT_TIE * float(lg.abs().max())
        top2 = torch.topk(lg, 2).values
        check(float(top2[0] - top2[1]) < tie and float(lg[a]) >= float(
            top2[0]) - tie, f"TP greedy token {j} ({a}) differs from the "
            f"unsharded run's ({b}) outside a near-tie")
        return j
    return None


def tensor_parallel_phase(args, loader, checkpoint, llama, mixtral, gen_mod,
                          api, linear, gemv, kvc, teng):
    """Phase 16; see the module docstring. Returns kernel A's launches and
    each attention kernel's in the ranks' main paths (rank 0's)."""
    import tempfile
    phase0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    per_forward = cfg.num_hidden_layers * 7
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    forced_prompt, forced_toks = forced_inputs(
        cfg.vocab_size, torch.Generator(device="cuda").manual_seed(6))
    params = llama.init_params(cfg, seed=0, device="cuda")
    launches = {"q4_lut_post": 0, **{k: 0 for k in ATTN_KERNELS}}
    rows, fails = {}, []
    # a dense bf16 row-parallel partial (o_proj's rank shape at tp=2):
    # float32 sums from torch.mm's out_dtype, the weight not cast
    dgen = torch.Generator(device="cuda").manual_seed(24)
    x, w = (torch.randn(shape, generator=dgen, device="cuda")
            .to(torch.bfloat16) for shape in ((PROMPT_LEN, 1024),
                                              (2048, 1024)))
    y = linear.linear(x, w, out_dtype=torch.float32)
    dense_err = rel_err(y, x.float() @ w.float().t())
    check(y.dtype == torch.float32 and dense_err <= 1e-5,
          f"dense bf16 linear with float32 output: {y.dtype}, {dense_err} "
          f"of max from the float32 product")
    del x, w, y
    with tempfile.TemporaryDirectory() as work:
        for world in TP_SIZES:
            t0 = time.perf_counter()
            # deterministic sums: every run holds the same checkpoint, so
            # its gaps to the unsharded run repeat (tp_sums draws others)
            with deterministic():
                q = api.quantize_model(params, fmt="any4", group_size=128,
                                       kmeans_iters=10,
                                       row_parallel_shards=world)
            torch.cuda.synchronize()
            quantize_s = time.perf_counter() - t0
            layer = q["layers"][0]
            check(layer["o_proj"].row_shards == world
                  and layer["down_proj"].row_shards == world
                  and layer["q_proj"].row_shards == 1
                  and all(v.fmt == "any4t" for v in layer.values()
                          if isinstance(v, linear.QuantizedTensor)),
                  f"row_parallel_shards={world}: o/down in {world} segments")
            t0 = time.perf_counter()
            path = os.path.join(work, f"llama_any4_S{world}")
            checkpoint.save_params(path, q, cfg)
            save_s = time.perf_counter() - t0
            # the unsharded reference: the S-segment weights on the full x
            gemv.reset_launches()
            ref = llama.forward(q, cfg, prompt)[0].float()
            check(gemv.LAUNCHES["q4_lut_post"] == per_forward,
                  f"unsharded S={world} forward: kernel A "
                  f"{dict(gemv.LAUNCHES)}")
            ref32 = llama.forward(to_float32(q, linear), cfg32, prompt)[0]
            deq32 = llama.forward(to_float32(q, linear, dequantize=True),
                                  cfg32, prompt)[0]
            job = {"checkpoint": path, "prompt": prompt.cpu()}
            if world == 2:
                ref_tokens = gen_mod.generate(q, cfg, prompt,
                                              max_new_tokens=TP_NEW_TOKENS)
                ref_forced = llama.forward(
                    q, cfg, ref_tokens[:, :-1])[0][0, PROMPT_LEN - 1:].float()
                engine_refs = {
                    f"{layout}_{'int8' if q8 else 'bf16'}": engine_forced(
                        teng, kvc, to_float32(q, linear), cfg32, layout, q8,
                        forced_prompt, forced_toks).float()
                    for layout, q8 in TP_POOLS}
                job.update(ref_tokens=ref_tokens.cpu(),
                           forced_prompt=forced_prompt.cpu(),
                           forced_toks=forced_toks.cpu())
            del q
            torch.cuda.empty_cache()
            jobs = {"llama": job}
            if world == 2:
                jobs["mixtral"], mref = mixtral_tp_reference(
                    loader, mixtral, api, linear, gemv, work)
            t0 = time.perf_counter()
            ranks = run_ranks(world, jobs, work)
            ranks_s = time.perf_counter() - t0
            row = {"phase": "tensor_parallel", "model": "llama_3_2_1b",
                   "tp": world, "ranks_on_one_card": world,
                   "layers": cfg.num_hidden_layers, "fmt": "any4",
                   "group_size": 128, "row_parallel_shards": world,
                   "quantize_s": quantize_s, "checkpoint_save_s": save_s,
                   "ranks_s": ranks_s,
                   "bars": {"bf16": TP_BAR, "f32_activations": TP_BAR,
                            "dequantized_f32": TP_F32_BAR}}
            for r in ranks:
                out = r["llama"]
                errs = {"rel_err_bf16": rel_err(out["logits_bf16"],
                                                ref.cpu()),
                        "rel_err_f32": rel_err(out["logits_f32"],
                                               ref32.cpu()),
                        "rel_err_dequantized_f32": rel_err(
                            out["logits_deq32"], deq32.cpu())}
                hold(fails, errs["rel_err_bf16"] <= TP_BAR
                     and errs["rel_err_f32"] <= TP_BAR
                     and errs["rel_err_dequantized_f32"] <= TP_F32_BAR,
                     f"tp={world} rank {r['rank']}: logits {errs} of max "
                     f"from the unsharded forward")
                hold(fails, out["launches_forward"]["q4_lut_post"]
                     == per_forward and sum(out["launches_forward"].values())
                     == per_forward, f"tp={world} rank {r['rank']}: "
                     f"launches {out['launches_forward']} a forward")
                hold(fails, torch.equal(out["logits_bf16"],
                                        ranks[0]["llama"]["logits_bf16"]),
                     "every rank has the same logits")
                row.setdefault("ranks", []).append({
                    "rank": r["rank"], **errs,
                    "load_shard_s": out["load_shard_s"],
                    "launches_forward": out["launches_forward"]})
            launches["q4_lut_post"] += per_forward
            if world == 2:
                tp2_checks(row, ranks, ref_tokens, ref_forced, engine_refs,
                           cfg, per_forward, launches, fails)
                rows["mixtral"] = mixtral_tp_checks(ranks, mref, fails)
                launches["q4_lut_post"] += \
                    rows["mixtral"]["launches_per_rank"]
            emit(row)
            if world == 2:
                emit({"phase": "tensor_parallel_mixtral", "tp": 2,
                      "layers": MIXTRAL_LAYERS, **rows["mixtral"]})
            del deq32
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "tensor_parallel_summary",
          "note": "the ranks share one card, so their times are no scaling "
                  "figures: they show the all-reduce's cost over gloo",
          "dense_bf16_float32_partial_rel_err": dense_err,
          "phase_s": time.perf_counter() - phase0, "failed": fails})
    check(not fails, "; ".join(fails))
    return launches


def tp_sums_phase(args, checkpoint, llama, api):
    """``--phase tp_sums``: the spread of the 1B's tensor-parallel logits
    gap from the unsharded run, with float32 against bf16 partial sums. At
    each tp size, TP_SUM_CHECKPOINTS checkpoints quantized as phase 16
    quantizes (k-means on the card is not deterministic, so each is a
    draw), each with its unsharded reference, and the ranks' logits over
    phase 16's prompt read twice in each sum (:func:`tp_rank_sums`).
    Holds nothing but that every rank reads alike; ``tp_sums`` rows."""
    import tempfile
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    params = llama.init_params(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as work:
        for world in TP_SIZES:
            paths, refs = [], []
            for i in range(TP_SUM_CHECKPOINTS):
                q = api.quantize_model(params, fmt="any4", group_size=128,
                                       kmeans_iters=10,
                                       row_parallel_shards=world)
                paths.append(os.path.join(work, f"llama_any4_S{world}_{i}"))
                checkpoint.save_params(paths[-1], q, cfg)
                refs.append(llama.forward(q, cfg, prompt)[0].float().cpu())
                del q
                torch.cuda.empty_cache()
            ranks = run_ranks(world, {"sums": {"checkpoints": paths,
                                               "prompt": prompt.cpu()}},
                              work)
            errs = {"float32": [], "bf16": []}
            repeat_equal = ranks_equal = True
            for i, ref in enumerate(refs):
                for mode in errs:
                    a, b = ranks[0]["sums"][i][mode]
                    repeat_equal &= torch.equal(a, b)
                    ranks_equal &= all(torch.equal(r["sums"][i][mode][1], a)
                                       for r in ranks)
                    errs[mode].append(rel_err(a, ref))
            emit({"phase": "tp_sums", "tp": world,
                  "layers": cfg.num_hidden_layers,
                  "checkpoints": TP_SUM_CHECKPOINTS, "rel_err": errs,
                  "spread": {m: [min(v), max(v)] for m, v in errs.items()},
                  "repeat_reads_equal": repeat_equal,
                  "ranks_equal": ranks_equal, "bar": TP_BAR})
            check(ranks_equal, f"tp={world}: every rank reads alike")
    del params
    torch.cuda.empty_cache()


def hold(fails, cond, msg):
    """A check whose failure is recorded in ``fails`` (raised after the
    phase's rows are printed, so one run shows every figure)."""
    if not cond:
        fails.append(msg)


def tp2_checks(row, ranks, ref_tokens, ref_forced, engine_refs, cfg,
               per_forward, launches, fails):
    """The tp=2 rows' checks: greedy tokens (the unsharded run's, or split
    at a near-tie), their teacher-forced logits, exact launches, the step
    costs, and the TP engine (equal tokens on every rank, exact launches,
    teacher-forced decode logits within the engine's bars of the single
    engine's)."""
    t = PROMPT_LEN
    for r in ranks:
        out = r["llama"]
        hold(fails, torch.equal(out["tokens"], ranks[0]["llama"]["tokens"]),
             "every rank takes the same greedy tokens")
        want = per_forward * TP_NEW_TOKENS
        hold(fails, out["launches_generate"]["q4_lut_post"] == want
             and sum(out["launches_generate"].values()) == want,
             f"rank {r['rank']}: greedy decode launches "
             f"{out['launches_generate']} != {want}")
        forced = rel_err(out["forced_logits"], ref_forced.cpu())
        hold(fails, forced <= TP_BAR, f"rank {r['rank']}: teacher-forced "
             f"logits {forced} of max from the unsharded run's")
        try:
            split = tie_split(out["tokens"], ref_tokens.cpu(),
                              ref_forced.cpu(), t)
        except RuntimeError as e:
            fails.append(str(e))
            split = "outside a near-tie"
        info = row["ranks"][r["rank"]]
        info.update(
            greedy_tokens=TP_NEW_TOKENS, greedy_split_at=split,
            teacher_forced_rel_err=forced,
            host_ms_per_token=out["host_ms_per_token"],
            device_ms_per_step=out["device_ms_per_step"],
            all_reduce_ms_per_step=out["all_reduce_ms_per_step"],
            all_reduces_per_step=out["all_reduces_per_step"])
        hold(fails, out["all_reduces_per_step"] == 2 * cfg.num_hidden_layers,
             "two all-reduces a layer a step")
        for layout, q8 in TP_POOLS:
            key = f"{layout}_{'int8' if q8 else 'bf16'}"
            eng = out[f"engine_{key}"]
            name = next(n for n, (lay, q, _) in ATTN_KERNELS.items()
                        if lay == layout and q == q8)
            hold(fails, eng["tokens"] == ranks[0]["llama"][f"engine_{key}"]
                 ["tokens"], f"TP engine {key}: ranks' tokens differ")
            hold(fails, all(len(x) == SERVE_NEW_TOKENS for x in eng["tokens"]),
                 f"TP engine {key}: {SERVE_NEW_TOKENS} tokens a request")
            got = eng["launches"]
            hold(fails, got["q4_lut_post"] == eng["want_linear"]
                 and got[name] == eng["want_attention"]
                 and sum(got.values()) == eng["want_linear"]
                 + eng["want_attention"], f"TP engine {key}: launches "
                 f"{got}, want A {eng['want_linear']}, {name} "
                 f"{eng['want_attention']}")
            bar = ENGINE_BARS[q8]
            err = rel_err(eng["forced_logits"], engine_refs[key].cpu())
            hold(fails, err <= bar, f"TP engine {key}: teacher-forced "
                 f"logits {err} > {bar} of max from the single engine's")
            info[f"engine_{key}"] = {
                "kernel": name, "wall_s": eng["wall_s"],
                "tok_s": SERVE_REQUESTS * SERVE_NEW_TOKENS / eng["wall_s"],
                "decode_steps": eng["decode_steps"],
                "prefill_chunks": eng["prefill_chunks"],
                "launches": got, "teacher_forced_rel_err": err,
                "teacher_forced_bar": bar}
            if r["rank"] == 0:
                launches["q4_lut_post"] += eng["want_linear"]
                launches[name] += eng["want_attention"]
    launches["q4_lut_post"] += per_forward * TP_NEW_TOKENS


def mixtral_tp_reference(loader, mixtral, api, linear, gemv, work):
    """The 2-layer Mixtral-8x7B quantized to any4 g=128 with w2 and o_proj
    in 2 row segments, saved for the ranks (``torch.save``: the same bytes
    in every rank); its unsharded forward in sparse dispatch over one
    token (2 experts a layer run) and in dense dispatch over a 64-token
    prompt, in bf16 and with float32 activations (the routing recorded)
    and over the dequantized float32 weights. Returns the ranks' job and
    the references."""
    cfg = mixtral_config(loader)
    params = mixtral.init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    q = api.quantize_model(params, fmt="any4", group_size=128,
                           kmeans_iters=10, row_parallel_shards=2)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    check(q["layers"][0]["experts"][0]["w2"].row_shards == 2,
          "Mixtral w2 in 2 row segments")
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda", dtype=torch.int32)
    ids = {"sparse": prompt[:, :1], "dense": prompt}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    q32, deq32 = to_float32(q, linear), to_float32(q, linear, dequantize=True)
    ref, records = {}, {}
    for dispatch, prompt in ids.items():
        rec, rec32 = [], []
        with moe_dispatch(mixtral, dispatch):
            with routing(mixtral, record=rec):
                gemv.reset_launches()
                lg = mixtral.forward(q, cfg, prompt)[0].float()
                launches = gemv.LAUNCHES["q4_lut_post"]
            with routing(mixtral, record=rec32):
                lg32 = mixtral.forward(q32, cfg32, prompt)[0]
            deq = mixtral.forward(deq32, cfg32, prompt)[0]
        records[dispatch] = {k: [(a.cpu(), b.cpu()) for a, b in r]
                             for k, r in (("bf16", rec), ("f32", rec32))}
        ref[dispatch] = (lg.cpu(), lg32.cpu(), deq.cpu(), launches)
    del q32, deq32
    path = os.path.join(work, "mixtral_any4_S2.pt")
    torch.save(to_device(q, "cpu", linear), path)
    del q
    torch.cuda.empty_cache()
    return ({"weights": path, "cfg": cfg, "routing": records,
             "ids": {k: v.cpu() for k, v in ids.items()}},
            {"ref": ref, "quantize_s": quantize_s})


def mixtral_tp_checks(ranks, mref, fails):
    """Each rank's Mixtral logits against the unsharded forward's, in each
    dispatch: bf16 and float32 activations (routed as the unsharded run)
    within TP_BAR, the dequantized float32 weights within TP_F32_BAR;
    kernel A's launches a rank equal the unsharded forward's; stacked
    experts refused."""
    out = {"quantize_s": mref["quantize_s"], "ranks": [],
           "bars": {"bf16": TP_BAR, "f32_activations": TP_BAR,
                    "dequantized_f32": TP_F32_BAR}}
    for r in ranks:
        mine = {"rank": r["rank"]}
        for dispatch, (lg, lg32, deq, want) in mref["ref"].items():
            got = r["mixtral"][dispatch]
            bf = rel_err(got["logits_bf16"], lg)
            f32 = rel_err(got["logits_f32"], lg32)
            d32 = rel_err(got["logits_deq32"], deq)
            hold(fails, bf <= TP_BAR and f32 <= TP_BAR and d32 <= TP_F32_BAR,
                 f"Mixtral tp=2 rank {r['rank']} {dispatch}: logits {bf} "
                 f"(bf16), {f32} (float32 activations), {d32} (dequantized "
                 f"float32) of max from the unsharded run")
            hold(fails, got["launches"]["q4_lut_post"] == want and sum(
                got["launches"].values()) == want, f"Mixtral tp=2 "
                f"{dispatch}: launches {got['launches']} != {want}")
            mine[dispatch] = {"rel_err_bf16": bf, "rel_err_f32": f32,
                              "rel_err_dequantized_f32": d32,
                              "launches": want,
                              "routing_flips": got["routing_flips"]}
        hold(fails, r["mixtral"]["stacked_raised"] is not None
             and "stacked experts" in r["mixtral"]["stacked_raised"],
             "stacked experts at tp=2 raise ValueError")
        out["ranks"].append(mine)
    out["launches_per_rank"] = sum(v[3] for v in mref["ref"].values())
    return out


# ---------------------------------------------------------------------------
# Phase 17: the native host data plane
# ---------------------------------------------------------------------------

def native_phase(native, quant, packing, api, linear):
    """``native.available()`` on the card's host; the native pack and
    ``group_quantize`` bit for bit against the torch functions on the card
    at NATIVE_SHAPES, each timed beside the torch CPU path on the same
    numpy array (``torch.from_numpy``, ``group_quantize``, ``pack_codes``:
    what the host path ran without the C++); ``cli.quantize --cpu --fmt
    int4 --tiny`` on the host path with the device path's codes for the
    same weights."""
    from any4_tpu_torch.cli import quantize as quantize_cli
    from any4_tpu_torch.models import llama
    import tempfile
    check(native.available(), "the native data plane builds on the card's "
          "host")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, k in NATIVE_SHAPES:
        w = torch.randn((n, k), generator=gen, device="cuda")
        host = w.cpu().numpy()
        t0 = time.perf_counter()
        c0, s0, z0 = native.group_quantize(host, 4, 128)
        gq_s = time.perf_counter() - t0
        c1, s1, z1 = quant.group_quantize(w, 4, 128)
        t0 = time.perf_counter()
        p0 = native.pack_int4(c0)
        pack_s = time.perf_counter() - t0
        p1 = packing.pack_codes(c1)
        t0 = time.perf_counter()
        c2, _, _ = quant.group_quantize(torch.from_numpy(host), 4, 128)
        packing.pack_codes(c2)
        torch_cpu_s = time.perf_counter() - t0
        same = {"codes": np.array_equal(c0, c1.cpu().numpy()),
                "scales": np.array_equal(s0, s1.cpu().numpy()),
                "zeros": np.array_equal(z0, z1.cpu().numpy()),
                "packed": np.array_equal(p0, p1.cpu().numpy())}
        check(all(same.values()), f"native vs torch on the card at {n}x{k}: "
              f"{same}")
        rows.append({"n": n, "k": k, "bit_equal": same,
                     "group_quantize_s": gq_s, "pack_s": pack_s,
                     "native_s": gq_s + pack_s,
                     "torch_cpu_s": torch_cpu_s,
                     "torch_cpu_threads": torch.get_num_threads()})
        del w, c1, s1, z1, p1
    with tempfile.TemporaryDirectory() as d:
        (host, cfg), lines = run_cli(quantize_cli.main, [
            "--cpu", "--tiny", "--fmt", "int4", "--output", d])
    check(f"native data plane: on ({native.num_threads()} threads)" in lines
          and "quantizing host-side through the native data plane" in lines,
          f"cli.quantize --fmt int4 takes the host path: {lines[:3]}")
    dev = api.quantize_model(to_device(llama.init_params(
        cfg, seed=0, device="cpu"), "cuda", linear), fmt="int4")
    n_same = 0
    for i, layer in enumerate(dev["layers"]):
        for name, qt in layer.items():
            if isinstance(qt, linear.QuantizedTensor):
                got = host["layers"][i][name]
                check(got.fmt == qt.fmt and all(
                    torch.equal(getattr(got, f), getattr(qt, f).cpu())
                    for f in ("packed", "scales", "zeros")),
                      f"cli.quantize host path {name}: the device path's "
                      f"codes")
                n_same += 1
    emit({"phase": "native", "threads": native.num_threads(),
          "shapes": rows, "cli_quantize_host_path_weights_equal": n_same})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the 1B model's depth (default: all 16)")
    ap.add_argument("--phase", choices=["evals", "tensor_parallel",
                                        "tp_sums"],
                    default=None,
                    help="run only this phase after the build (evals on "
                         "phase 4's models; tensor_parallel with its kernel "
                         "checks and the native phase; tp_sums, the spread "
                         "of the TP logits gap, runs in no other way); "
                         "prints no kernels line and no result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from any4_tpu_torch import native
    from any4_tpu_torch.models import checkpoint
    from any4_tpu_torch.models import fuse, generate as gen_mod, llama
    from any4_tpu_torch.models import loader, mixtral, opt
    from any4_tpu_torch.ops import build, gemv, linear, packing, quant
    from any4_tpu_torch import calibrate as cal
    from any4_tpu_torch.quant import api, awq
    from any4_tpu_torch.serving import engine as teng, kv_cache as kvc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_name, (bw, peak) = peaks(kind)
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "nvidia_smi": smi, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": sorted(libs.values()),
          "bandwidth_bytes_per_s": bw, "bf16_flops_per_s": peak,
          "peaks_from": f"NVIDIA data sheet, {peak_name} (SXM unless PCIe)"})
    if args.phase == "evals":
        params, qparams, cfg, _, _ = llama_1b_any4(args, llama, api)
        launches = evals_phase(params, qparams, cfg, gemv, linear, gen_mod,
                               api)
        emit({"phase": "wall", "wall_s": time.perf_counter() - wall0,
              "layers": cfg.num_hidden_layers, "launches": launches})
        print(smi, flush=True)
        return
    if args.phase == "tp_sums":
        tp_sums_phase(args, checkpoint, llama, api)
        emit({"phase": "wall", "wall_s": time.perf_counter() - wall0})
        print(smi, flush=True)
        return
    if args.phase == "tensor_parallel":
        tp_kernel_checks(gemv, packing, linear, kvc, bw, peak)
        launches = tensor_parallel_phase(args, loader, checkpoint, llama,
                                         mixtral, gen_mod, api, linear, gemv,
                                         kvc, teng)
        native_phase(native, quant, packing, api, linear)
        emit({"phase": "wall", "wall_s": time.perf_counter() - wall0,
              "launches": launches})
        print(smi, flush=True)
        return
    for source, keep in ((SOURCE, "post_mma"), (W4A8_SOURCE, "a8_mma")):
        emit({"phase": "ptxas", "source": source, "kernels": ptxas_summary(
            build.PTXAS_REPORTS.get(os.path.basename(source), ""), keep)})

    timer = Timer()
    rows = kernel_phase(gemv, packing, linear, timer, Timer(dirty=True), bw,
                        peak)
    fused_rows = kernel_a_fused_shapes(gemv, packing, linear, timer, bw, peak)
    emit({"phase": "kernel_edge_cases", "passed": edge_cases(gemv, packing)})
    emit({"phase": "kernel_a_edge_cases",
          "passed": kernel_a_edge_cases(gemv, packing)})
    emit({"phase": "kernel_a_bit_equal",
          **kernel_a_bit_equal(gemv, packing)})
    for name in ("q4_int4_magic", "int8_post", "w4a8", "w8a8"):
        emit({"phase": "post_bit_equal", "name": name,
              **kernel_a_bit_equal(gemv, packing, name)})
        emit({"phase": "post_edge_cases", "name": name,
              "passed": post_edge_cases(gemv, packing, name)})
    for name in ("int8_post", "w8a8", "w8a8_fused"):
        emit({"phase": "post_edge_cases", "name": name,
              "group_size": "padded_k(k)",
              "passed": rowscale_edge_cases(gemv, packing, name)})
    for name in gemv.FLOAT_X_KERNELS:
        emit({"phase": "post_bit_equal", "name": name,
              **kernel_a_bit_equal(gemv, packing, name)})
    for name, g, lut_kind in (("q4_lut_fused", 64, "row"),
                              ("q4_lut_fused", 128, "ramp"),
                              ("q4_lut_select", 128, "row")):
        emit({"phase": "post_bit_equal", "name": name,
              **kernel_a_bit_equal(gemv, packing, name, g, lut_kind)})
    for name, g in (("int8_fused", 64), ("int8_fused", 128)):
        emit({"phase": "post_bit_equal", "name": name,
              **kernel_a_bit_equal(gemv, packing, name, g)})
    for name, gs in (("q4_lut_fused", (16, 32, 64, 128, 256)),
                     ("q4_lut_select", (128, 256)),
                     ("int8_fused", (16, 32, 64, 128, 256))):
        emit({"phase": "post_edge_cases", "name": name, "group_sizes": gs,
              "passed": post_edge_cases(gemv, packing, name, gs)})
    emit({"phase": "fused_identity", "passed": fused_identity(gemv, linear)})
    emit({"phase": "fused_equals_external",
          "passed": fused_equals_external(gemv, packing, quant)})
    int_rows = int_kernel_phase(gemv, packing, linear, timer, bw, peak)
    emit({"phase": "int_kernel_edge_cases",
          "passed": int_edge_cases(gemv, packing, quant)})
    int8_rows = int8_kernel_phase(gemv, packing, linear, timer, bw, peak)
    emit({"phase": "int8_kernel_edge_cases",
          "passed": int8_edge_cases(gemv, packing, quant, linear)})
    attn_rows = attention_phase(kvc, timer, bw)
    emit({"phase": "attention_edge_cases",
          "passed": attention_edge_cases(kvc)})
    emit({"phase": "attention_buckets_bit_equal",
          "passed": attention_buckets(kvc)})
    del timer
    launches, params, qparams, cfg, (qtable, qtable_s, figures) = main_path(
        args, gemv, llama, gen_mod, api, linear)
    cfg1b = cfg
    attn_launches, paged_bf16 = serving_phase(qparams, cfg, gemv, kvc, teng,
                                              llama, gen_mod, linear)
    figures["quantize_embeddings_s"] = qtable_s
    fused_launches = fused_qemb_path(
        qparams, qtable, cfg, {"main": figures, "serving": paged_bf16}, gemv,
        kvc, teng, llama, gen_mod, api, linear, fuse)
    launches["q4_lut_post"] += fused_launches["q4_lut_post"]
    # phase 4's any4 model waits on the host for the cli_tools phase
    qparams = to_device(qparams, "cpu", linear)
    del qtable
    torch.cuda.empty_cache()
    # each kernel's launches in the main path that carries it, at the
    # depths of MAIN_DEPTHS
    for fmt, names in (("any4_g64", ("q4_lut_fused",)),
                       ("int8_g64", ("int8_fused",)),
                       ("int4", ("q4_int4_magic",)),
                       ("w4a8", ("w4a8", "w4a8_fused")),
                       ("int8", ("int8_post",)),
                       ("w8a8", ("w8a8", "w8a8_fused")), ("any4q8", ())):
        got, qf, cfg = int_main_path(args, fmt, gemv, llama, gen_mod, api,
                                     linear, layers=MAIN_DEPTHS.get(fmt))
        launches.update({k: got[k] for k in names})
        if fmt != "any4q8":
            int_serving(teng, gemv, kvc, linear, qf, cfg, fmt,
                        serve_prompts(cfg),
                        (gen_mod, llama) if fmt in ("any4_g64", "int8_g64")
                        else None)
        del qf
        torch.cuda.empty_cache()
    launches["q4_lut_fused"] += mx4_path(args, gemv, llama, gen_mod, api,
                                         linear)["q4_lut_fused"]
    torch.cuda.empty_cache()
    # the row-scale formats at 2 layers: their kernels run more layers in
    # the paths above
    for fmt, names in (("int8r", ("int8_post",)),
                       ("w8a8r", ("w8a8", "w8a8_fused")),
                       ("any4q8r", ("w8a8", "w8a8_fused"))):
        got, _, _ = int_main_path(args, fmt, gemv, llama, gen_mod, api,
                                  linear, layers=2)
        for k in names:
            launches[k] += got[k]
        torch.cuda.empty_cache()
    launches.update({k: v for k, v in select_path(
        args, gemv, llama, api, linear).items() if v})
    int8_layouts(gemv, llama, api, linear)
    # Mixtral-8x7B's shapes alone, then the model (2 layers) through
    # generate, the engine, fused and stacked; then OPT-125m
    timer = Timer()
    mixtral_rows = kernel_a_mixtral_shapes(gemv, packing, linear, timer, bw,
                                           peak)
    attn_mixtral = attention_mixtral_shape(kvc, timer, bw)
    del timer
    mparams, mq, mcfg, mixtral_launches = mixtral_path(
        gemv, loader, mixtral, gen_mod, llama, api, linear)
    attn_launches["flash_paged_decode"] += mixtral_serving(
        mq, mcfg, gemv, kvc, teng, gen_mod, llama, linear)
    del mq
    mixtral_fused_stacked(mparams, mcfg, gemv, mixtral, gen_mod, llama, api,
                          linear, fuse)
    torch.cuda.empty_cache()
    launches["q4_lut_post"] += mixtral_launches + opt_path(gemv, opt, api,
                                                           linear)
    # AWQ, calibration and nnq (phase 13)
    torch.cuda.empty_cache()
    launches["q4_lut_post"] += awq_main_path(args, gemv, llama, gen_mod, api,
                                             linear, awq, cal)
    torch.cuda.empty_cache()
    awq_any4_search(llama, awq, linear)
    torch.cuda.empty_cache()
    launches["q4_lut_post"] += nnq_path(gemv, llama, gen_mod, api, linear)
    torch.cuda.empty_cache()
    calibrate_fn_path(llama, api, linear, cal)
    torch.cuda.empty_cache()
    launches["q4_lut_post"] += awq_mixtral(mparams, mcfg, gemv, mixtral,
                                           gen_mod, llama, api, linear, awq)
    del mparams
    torch.cuda.empty_cache()
    launches["q4_lut_post"] += awq_opt(gemv, opt, api, linear, awq)
    # the port's tools and scripts (phase 14), then the evals (phase 15), on
    # phase 4's models, back on the card
    torch.cuda.empty_cache()
    params = to_device(params, "cuda", linear)
    qparams = to_device(qparams, "cuda", linear)
    kxk, cli_launches = cli_tools(params, qparams, cfg1b, gemv, linear, llama,
                                  gen_mod, bw, peak)
    launches["q4_lut_post"] += cli_launches
    torch.cuda.empty_cache()
    for name, count in evals_phase(params, qparams, cfg1b, gemv, linear,
                                   gen_mod, api).items():
        launches[name] += count
    del params, qparams
    # tensor parallelism (phase 16: the kernels at its shapes, then the
    # ranks) and the native data plane (phase 17)
    torch.cuda.empty_cache()
    tp_rows, tp_attn = tp_kernel_checks(gemv, packing, linear, kvc, bw, peak)
    tp_launches = tensor_parallel_phase(args, loader, checkpoint, llama,
                                        mixtral, gen_mod, api, linear, gemv,
                                        kvc, teng)
    launches["q4_lut_post"] += tp_launches.pop("q4_lut_post")
    for name, count in tp_launches.items():
        attn_launches[name] += count
    native_phase(native, quant, packing, api, linear)

    kernels = []
    for name, spec in KERNELS.items():
        summary = layer_summary(rows, name)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"], "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"],
            "library_ms": summary["library_ms"],
            "timed_as": "sum over one 1B decoder layer's 7 linears at m=1",
            "launches_from": (
                "generate at b=1 and 4 over the any4 g=128 model, then over "
                "it fused with the quantized tied head, and that model's "
                "engine run(burst=1); generate at b=1 and 4 over the any4 "
                "Mixtral-8x7B model (2 layers); OPT-125m's forwards of 64 "
                "and 1024 tokens at b=1 and 4; generate at b=1 over the "
                "AWQ-scaled, calibrated any4 1B model and the 2-layer nnq "
                "model, and over the AWQ any4 Mixtral (2 layers); the AWQ "
                "any4 OPT-125m's 64-token forward; the cli_tools phase's "
                "decode_tokens_per_s and profile_decode_components over "
                "the any4 g=128 model and the benchmark script's tiny "
                "any4 model; evals: the any4 g=128 model's chunked and "
                "stream perplexity (2048-token windows), the LM protocol's "
                "loglikelihood, rolling, generate_until, local_mc and code "
                "tasks, and the eval script's tiny any4 model; rank 0's "
                "tensor-parallel paths: the 1B's forward at tp=2 and 4, its "
                "32 greedy tokens and TP engine runs (paged and contig, "
                "bf16 and int8 pools) at tp=2, and the 2-layer Mixtral's "
                "sparse and dense forwards at tp=2"
                if name == "q4_lut_post" else
                "generate at b=1 and 4 over the any4 g=64 model and at b=1 "
                "over the mx4 (g=32) model; evals: the eval script's tiny "
                "any4 model (its k = 64 linears)"),
            "group_size": spec["group_size"]})
        if name == "q4_lut_post":
            kernels[-1]["by_m"] = {m: layer_summary(
                rows, name, m=m, keys=("ms", "ms_dirty_l2", "plain_ms",
                                       "bound_ms", "library_ms",
                                       "library_ms_dirty_l2"))
                for m in spec["ms"]}
            kernels[-1]["fused_shapes"] = {
                f"{r['n']}x{r['k']}_m{r['m']}": {
                    key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "max_abs_err")}
                for r in fused_rows}
            kernels[-1]["kxk"] = kxk["q4_lut_post"]
            for key, shape_rows in (("mixtral_shapes", mixtral_rows),
                                    ("tp_shapes", tp_rows)):
                kernels[-1][key] = {
                    f"{r['weight']}_{r['n']}x{r['k']}_m{r['m']}": {
                        k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err")}
                    for r in shape_rows}
        else:
            kernels[-1]["by_m"] = by_m(rows, name, spec["ms"])
    for name, (layout, q8, replaces) in ATTN_KERNELS.items():
        r = next(r for r in attn_rows if r["name"] == name
                 and (r["b"], r["ctx"]) == ATTN_TIMED)
        kernels.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": replaces, "launches": attn_launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in attn_rows
                               if x["name"] == name),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "timed_as": (f"one call at b={ATTN_TIMED[0]}, ctx="
                         f"{ATTN_TIMED[1]}, {ATTN_HEADS} kv heads, rep "
                         f"{ATTN_REP}, d={ATTN_HEAD_DIM}; launches from "
                         f"the engine's run(burst=1) in the {layout} "
                         f"{'int8' if q8 else 'bf16'} combination"
                         + (" and the Mixtral engine's" if name ==
                            "flash_paged_decode" else "")
                         + (" and rank 0's TP engine at tp=2" if
                            (layout, q8) in TP_POOLS else ""))})
        kernels[-1]["tp_heads"] = {
            f"h{r['h']}_b{r['b']}_ctx{r['ctx']}": {
                k: r[k] for k in ("S", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "max_abs_err")}
            for r in tp_attn if r["name"] == name}
        if name == "flash_paged_decode":
            kernels[-1]["mixtral_shape"] = {
                k: attn_mixtral[k] for k in (
                    "b", "ctx", "h", "rep", "d", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err")}
    for name, (source, replaces, _) in INT_KERNELS.items():
        lut = "ramp" if name == "q4_lut_select" else "none"
        summary = layer_summary(int_rows, name, lut)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: summary[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
            "timed_as": ("sum over one 1B decoder layer's 7 linears at m=1"
                         + (", int4 ramp LUT" if lut == "ramp" else "")),
            "launches_from": ("row-layout int4 forward, use_gather=False"
                              if lut == "ramp" else
                              f"generate at b=1 and 4 over the "
                              f"{'int4' if name == 'q4_int4_magic' else 'w4a8'}"
                              f" model (4 layers)")})
        if name in gemv.POST_KERNELS:
            kernels[-1]["by_m"] = by_m(int_rows, name, INT_KERNELS[name][2],
                                       lut)
        if name == "q4_int4_magic":
            kernels[-1]["kxk"] = kxk[name]
    for name, (source, replaces, _, g) in INT8_KERNELS.items():
        summary = layer_summary(int8_rows, name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: summary[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
            "timed_as": (f"sum over one 1B decoder layer's 7 linears at m=1,"
                         f" g={g}"),
            "launches_from": (
                "generate at b=1 and 4 over the "
                + {"int8_fused": "int8 g=64 model (4 layers)",
                   "int8_post": "4-layer int8 model and the 2-layer int8r "
                                "model",
                   "w8a8": "4-layer w8a8 model and the 2-layer w8a8r and "
                           "any4q8r models",
                   "w8a8_fused": "4-layer w8a8 model and the 2-layer w8a8r "
                                 "and any4q8r models"}[name])})
        if name in gemv.POST_KERNELS:
            kernels[-1]["by_m"] = by_m(int8_rows, name, INT8_KERNELS[name][2])
    emit({"phase": "wall", "wall_s": time.perf_counter() - wall0,
          "layers": cfg.num_hidden_layers})
    print(smi, flush=True)      # the card's name and power limit
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
