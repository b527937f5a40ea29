#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --verify   # build + phase 3 (verify) only
    python3 chip_smoke.py --tune     # build + phase 3 (tune) only
    python3 chip_smoke.py --sharded  # build + phase 3 (sharded) only
    python3 chip_smoke.py --audit    # build + phase 3 (audit) only
    python3 chip_smoke.py --train    # build + phase 3 (train) only
    python3 chip_smoke.py --dp-train # build + phase 3 (dp train) only
    python3 chip_smoke.py --dense    # build + phase 3 (dense) only
    python3 chip_smoke.py --tp       # build + phase 3 (tp) only
    python3 chip_smoke.py --moe      # build + phase 3 (moe) only
    python3 chip_smoke.py --hybrid   # build + phase 3 (hybrid) only
    python3 chip_smoke.py --encdec   # build + phase 3 (encdec) only
    python3 chip_smoke.py --dryrun   # build + phase 3 (dryrun) only
    python3 chip_smoke.py --examples # build + phase 3 (examples) only
    python3 chip_smoke.py --bf16     # build + phase 3 (bf16) + its rows
    python3 chip_smoke.py --1d       # build + B6/B7's phase 2, 3 (1-D), 4 rows

Phases (each raises on failure; none is caught):

1. Card: name and power limit, torch/CUDA/nvcc versions; build every
   kernel from ``src/repro_torch/kernels/csrc`` (into ``build/``, one
   ``nvcc`` per source, all at once) and print nvcc's
   register/shared-memory/spill report.
2. (In the full run inside phase 3 (clis), at the end; with ``--quick``
   right after phase 1.) Kernel vs. plain version on the card, on the
   same inputs, f32
   (tolerance 1e-5 relative to the largest |value|) and f64 (1e-12),
   with each plan's shared-memory bytes held to the kernel's own
   layout: the depth-1 kernel against ``ref.fused_stencil`` —
   diffusion at ranks 1-3, the MHD RHS and fused RK substep on a cube
   and a non-cubic box, and a ragged case (padded rows of 41 elements,
   one round short of threads) in f32, f64 and bf16, each printing
   its persistent launch (grid, ring, threads x outputs per thread,
   registers, spills); bf16 must equal its plain version bit for bit;
   the temporal kernel against
   ``ref.fused_stencil_steps`` — diffusion at depth 2 and 3, ranks 1-3,
   two selected fields, the MHD pair (two RK3 substep φs, aux w) and the
   MHD RHS twice, and on its walk body (``csrc/temporal_walk_body.cuh``)
   a ragged row pitch, steps of several planes and segments forced to 1
   and 4, each walk case printing its launch (persistent grid, columns,
   step and cross tile, rings, threads x outputs per thread, registers,
   spills);
   the stream kernel (``swc_stream``) against ``ref.fused_stencil`` /
   ``ref.fused_stencil_steps`` — diffusion at ranks 2 and 3, depth 1-3,
   on stream extents of many chunks and x extents off the default tile,
   two selected fields at depth 2, the MHD RHS on a cube and a
   non-cubic box, and stream axes cut into segments; at depth 1 (the
   ring body, ``csrc/stream_body.cuh``) also a ragged row pitch (41
   elements, chunks of 21 points) and stream extents of many ring
   passes, each depth-1 case printing its launch (grid, chunk and cross
   tile, the ring, threads x outputs per thread, registers, spills).
   Then the ensemble
   batch (B5, the member as an outer grid index of each kernel): B1 at
   B = 1, 3, 8 on ranks 1-3, B2 at depth 2 and 3, B3 at ranks 2-3 and
   depth 1-2 (a cut stream among them), the MHD RHS and fused substep
   with aux at B = 2, in f32 and f64, each against the batched plain
   version and each member against the unbatched launch on it, exactly.
   Then bf16 in the depth-1 kernel (B1b: ranks 1-3, two selected fields,
   B = 3; tolerance 2e-2) and the tc kernel (B4, ``fused_stencil_tc``)
   against ``ref.fused_stencil_tc[_steps]``: diffusion at ranks 1-3 in
   f32 and bf16 at depth 1 and 2, on tiles whose last 8-wide segment is
   ragged, two selected fields, B = 3 (each member equal to its
   unbatched launch), and the MHD RHS, fused substep (aux) and pair on
   a cube and a non-cubic box, the RHS and substep also at B = 3. Each
   tc case prints its launch: persistent grid, ring stages, staging
   route, registers. The walks at depth > 1: ``tc`` on
   ``csrc/tc_walk_body.cuh`` at depth 2 and 3 (f32 and bf16, ragged
   patches at ranks 2 and 3, segments forced to 1 and 4, two fields at
   B = 3, the MHD RHS twice, the pair at 256³) and ``swc_stream`` on the
   temporal walk body (f32 and f64, a ragged row pitch, segments forced
   to 1 and 4), each printing its walk line (persistent grid, columns,
   step and cross tile, rings, threads x outputs or patches a warp,
   registers, spills, evaluations per output-step; tc: banded MACs issued
   against the taps').
   Then bf16 in B2, B3 and the MHD φ (``parity_bf16``; B2c, B3c,
   B4b): diffusion at depth 2 and 3 on ranks 1-3 (the walk and the
   one-tile body), two fields, rows of 41 values (ragged modulo 8),
   segments forced to 1 and 4, B = 3; the stream kernel at ranks 2-3 and
   depth 1-3, cut stream axes and many ring passes; each equal to its
   plain version bit for bit. The MHD RHS and substep on ``swc``,
   ``swc_stream`` (RHS) and ``tc`` on a cube and a non-cubic box, the
   pair on both walks, the RHS twice and B = 2, each within 2e-2 of max
   |plain| with every field row's error printed, and equal to it bit for
   bit but on ``tc``.
   Then tc beyond radius 4 (orders 10 and 12, f32 and bf16, ranks 1-3),
   depths 9 and 12 on B2, B3 and B4 at 2-D (order 2, f32), and the B6
   cross-correlation (``csrc/xcorr1d.cu``) against ``ref.xcorr1d``: each
   strategy at unroll 4, elementwise at 8 and 16 and (``XCORR_WIDE``,
   register passes) at 32 and 64, pointwise at 24 and 64, in f32, f64,
   bf16 and f16 (B6b; the 2-byte types equal to the plain version bit for
   bit, "="), radii 0-1024, n = 2^20 + 123 (a ragged last tile), and odd
   register tilings (``XCORR_ODD``) at r = 3 (the one-tile launch) and
   1024 (elementwise on the ring) on an f aligned to 16 bytes and on one
   an element past (the ring's element staging), each launch's threads,
   shared bytes, grid (tiles, or the ring's persistent grid), register
   width and passes held to the kernel's own layout. Then B7
   (``csrc/conv1d_depthwise.cu``)
   against ``ref.conv1d_depthwise``: the reference's sweep shapes
   (1,64,8,4), (3,100,16,4), (2,257,32,7) and the same at k = 9, 16 and
   33 (B7b: k at run time), mamba2-780m's prefill launch (4, 8192, 3328)
   k = 4, a ragged s = 8193, and the strided xBC view of the (4, 8192,
   6448) in-projection (16-byte lanes at offset 3072, 2-byte pairs at
   3074, single channels at 3073), f32, bf16, f16 and f64 (B7b; f16
   equal bit for bit, f64 within 1e-12), activation none and silu, each
   launch's threads and grid held to the kernel's own.
3. Main path at full size, through the entry points a user calls, with
   the launch counters (total, per depth and per kernel) zeroed just
   before and read just after each run: MHD 256³ f32 RK3 with the fused
   axpy (3 launches per step), plain (3 per step), ``fuse_rk_pairs``
   (one depth-2 and one depth-1 launch per step) and plain on
   ``swc_stream`` (3 stream launches per step; the fused-axpy forms
   must raise there); 3-D diffusion at 512³ at depth 1, 2 and 3 (and 7
   steps at depth 3: a depth-1 remainder) on ``swc`` and on
   ``swc_stream``, 2-D diffusion at 8192² on ``swc_stream``, each held
   to ``swc`` at depth 1 (the ``swc`` runs at 8192² and 2^26 of the tc
   phase are counted too: one ``fused_stencil`` launch per step); an
   f64 Fourier mode checked against its exact
   discrete and analytic decay. Then ensemble serving
   (``repro_torch.launch.serve_sim.SimServer`` at its defaults: order 2,
   alpha 1, f32) on ``swc`` and on ``swc_stream``: after a warm-up batch
   of 8 per bucket, 16 requests of 8 steps alternating between 256³ and
   4096² members, batches of 8; every request ``ok`` on the strategy asked
   for, 8 launches of that strategy's kernel per batch, each request
   held to its per-member plain version on the card.
   The tc phase (``strategy="tc"``): MHD 256³ f32 plain, fused-axpy RK3
   (3 ``fused_stencil_tc`` launches per step) and ``fuse_rk_pairs`` (one
   depth-2 and one depth-1 launch per step, the pair on the tc walk),
   each held to ``swc`` within 1e-5; diffusion 512³ f32 at depth 1, 2
   and 3, bf16 at depth 1 and 2 (and bf16 on ``swc``, B1b, held to the
   plain bf16 version), 8192² and 2^26 f32, each held to f32 ``swc``.
   Phase 3 (bf16), after it (also alone with ``--bf16``; B2c, B3c,
   B4b): ``MHDSolver`` at 256³ bf16, 3 RK3 steps in each form it takes
   (plain on ``swc``, ``swc_stream`` and ``tc``, the fused axpy and
   ``fuse_rk_pairs`` on ``swc`` and ``tc``), launches by depth and
   kernel, ms a step beside the f32 row's, one step held to the plain
   bf16 version's (the entry points with the kernel wrapper replaced by
   its plain version, ``plain_kernels``): equal bit for bit on ``swc``
   and ``swc_stream``, within 2e-2 on ``tc``; diffusion 512³ bf16 at
   depth 2 and 3 on ``swc`` and 1-3 on ``swc_stream``, 8192² on
   ``swc_stream`` and 2^26 at depth 2 on ``swc``'s one-tile body, each
   equal to the plain bf16 steps bit for bit. The serve phase also runs
   ``SimServer(strategy="tc")``: 8 ``fused_stencil_tc`` launches per
   batch. The 1-D path: ``step_1d_xcorr`` on diffusion at 2^26, order 6,
   f32, bf16 and f16, 5 steps on each B6 strategy, exactly one
   ``xcorr1d`` launch per step (and no fused-stencil launch), held to
   ``simulate(..., strategy="swc")`` (B1 at rank 1; bf16 on B1b) within
   the dtype's limit, the 2-byte steps also to the plain ``hwc`` steps
   bit for bit (f16 has no B1 until ROADMAP B9); then B7b's path:
   ``ops.conv1d_depthwise`` under autograd (``Conv1dDepthwise``: the
   kernel forward, the plain gradient) in f16 and f64 at mamba2-780m's
   prefill view (4, 8192, 3328) of the (4, 8192, 6448) projection, k =
   4, and bf16 at k = 16 and 33, one launch each, held to the plain
   version (f16 and bf16 bit for bit, f64 within 1e-12) and its
   gradient.
   The mamba2 phase: mamba2-780m at full width (48 layers, d_model
   1536, random init from a seeded generator on the card) through
   ``repro_torch.launch.steps``: the prefill (4, 8192) in bf16 with
   exactly 48 B7 launches and no fused-stencil or xcorr1d launch, its
   last logits held to the same prefill with ``use_pallas_conv=False``
   within 2e-2 of the largest |logit|; ``forward`` (with B7) against
   step-by-step ``decode_step`` from an empty cache in f32 on (2, 512)
   (two SSD chunks) within 2.2e-3 absolute (``DECODE_TOL`` says why not
   the reduced test's 5e-4); the
   serve loop of ``launch/serve.py`` at batch 4, 32 steps; prefill ms
   and tokens/s on the host clock after a warm-up.
   Phase 3 (train), after the mamba2 phase (also alone with
   ``--train``): mamba2-780m's train step at full width (bf16 compute
   on f32 master parameters, selective remat, chunk 256) on
   ``MarkovLMDataset`` batches at (2, 4096), ``train_4k``'s sequence at
   a batch cut from 256 to 2. B7 under autograd (``Conv1dDepthwise``)
   against the plain version's autograd at the training xBC view
   (2, 4096, 3328) of the (2, 4096, 6448) in-projection, bf16 and f32:
   the output and the gradients of x and w within TOL ("=" when bit
   for bit); one gradient step (``make_grad_step``) on B7 (96 launches:
   the forward and remat's recompute, a layer each) against one with
   ``use_pallas_conv=False`` (none): loss and each gradient leaf
   (relative L2) within 2e-2; then 4 AdamW steps through
   ``make_train_step`` with the counters zeroed just before and read
   just after, each printing loss, grad_norm, lr, ms (synchronised),
   tokens/s, its B7 launches and peak memory; the reduced train CLI
   (``python -m repro_torch.launch.train``) on the card with a failure
   injected at step 5, restarting once from its step-3 checkpoint; and
   B7's time at the training view (the kernels line's training row:
   launches of the 4 steps, bound, plain, ``F.conv1d``).
   Phase 3 (dp train), after phase 3 (train) (also alone with
   ``--dp-train``): data-parallel training of mamba2-780m at full width
   and ``DP_LAYERS`` of its 48 layers, its ranks processes that share
   this card over gloo (``launch.mesh.run_on_mesh``; no time of this
   phase is a scaling figure). (a) The yardstick: the one-card B7 step 0
   at that depth on phase 3 (train)'s batch (2, 4096), its loss and 12
   f32 gradient leaves kept on the host and written under
   ``build/dp-yardstick`` for the ranks (removed after).
   (b) Mesh (2, 1) of (data, model), the ``dp`` profile, local batch
   (1, 4096): step 0 through ``make_synced_grad_step``, its loss within
   2e-2 of (a)'s and each synced gradient leaf within 2e-2 relative L2,
   two B7 launches a layer; then 3 steps through ``make_train_step``
   with the counters zeroed just before and read just after (two B7
   launches a layer per rank a step), the median ms a step (host clock after a barrier), the
   bytes a rank sends per step (the ring count), the sync alone on a
   full f32 tree, peak ``max_memory_allocated`` per rank and the card's
   memory in use. (c) The same mesh with ``fsdp=True`` (ZeRO): step 0's
   synced gradients and the parameters after it against (b)'s bit for
   bit, or the reason printed; one timed step; peak per rank. (d)
   ``grad_sync`` at (a)'s size, 4 ranks on mesh (2, 2) of (pod, data),
   rank r's tree (a)'s times (1 + r/8): one flat all-reduce,
   ``hierarchical_psum_tree`` (within 1e-6 of flat) and
   ``compressed_psum_tree`` (within 2e-2, residuals nonzero), each with
   its ms and bytes a rank. (e) The reduced train CLI with ``--mesh 2x1
   --backend gloo`` on the card (the failure at step 5): its logged
   losses equal phase 3 (train)'s ``--mesh 1x1`` run's to the printed
   digits, both ranks restored at step 3; its step-8 checkpoint
   restored on one process for 2 more steps. B7's time at a rank's
   training view (1, 4096, 3328) joins the kernels line with rank 0's
   launches of (b)'s timed steps.
   Phase 3 (dense), after phase 3 (dp train) (also alone with
   ``--dense``): the dense transformer family at full width, random
   init from seeded generators on the card, plain PyTorch (the
   reference computes these models outside any Pallas kernel, so the
   B1-B7 counters, zeroed just before each part and read just after,
   must read 0). llama3-8b (32 layers, d_model 4096, 32/8 heads, d_ff
   14336, vocab 128256; 29.9 GiB of f32 weights): the prefill (1, 8192)
   in bf16 through ``make_prefill_step``, ``prefill_32k``'s (32, 32768)
   cut to fit one card, the chunked attention (1024/1024) in every
   layer, ms (median of 3 after a warm-up), tokens/s and peak memory;
   ``forward`` against step-by-step ``decode_step`` from an empty cache
   in f32 on (2, 256), max |err| relative to max |logit| within 1e-3;
   the serve loop at batch 4, 32 steps. Then llama3-8b is freed and
   qwen2.5-3b (36 layers, d_model 2048, vocab 151936, tied, QKV bias)
   trains through ``make_train_step(donate=True)`` at ``train_4k``'s
   seq 4096, its global batch cut from 256 to 1, bf16 on f32 master
   weights with selective remat: step 0's loss finite and within 1.0 of
   ln(151936), steps 1-3 timed (ms a step, tokens/s, peak
   ``max_memory_allocated`` beside the card's). Last, the card against
   the CPU on reduced qwen2.5-3b and qwen2-vl-7b (the VLM with patch
   embeddings and three M-RoPE streams): ``forward``'s logits, the loss
   and every ``lm_loss`` gradient leaf on the same parameters, relative
   L2 within 1e-4 in f32 and 2e-2 in bf16 (the k bias, whose gradient
   the softmax's shift invariance nearly cancels, within its own bf16
   rounding on the CPU, against its f32 gradient, where that is larger),
   TF32 off.
   Phase 3 (tp), after phase 3 (dense) (also alone with ``--tp``): the
   ``tp`` profile's ``model`` axis (explicit Megatron tensor
   parallelism) for the dense family at full width (llama3-8b cut to 4
   of its 32 layers, gemma-2b to 6 of 18, qwen2.5-3b to 4 of 36, to
   keep the whole script inside half its time limit), ranks sharing the
   card over gloo (``run_on_mesh``; no time of theirs is a scaling
   figure), each rank drawing the seeded parameters leaf by leaf and
   keeping its blocks, each part held to a one-rank yardstick run just
   before in this process (its results kept on the host, its model
   freed). The B1-B7 counters, zeroed before each part and read after,
   read 0. (a) llama3-8b's prefill (1, 8192) bf16 on (1, 2): the last
   position's logits within 2e-2 of the yardstick's max |logit|; ms
   (median of 3 after a warm-up, host clock after a barrier), tokens/s,
   bytes a rank sends, peak per rank and the card's memory in use.
   (b) llama3-8b's bf16 serve step on (1, 2), batch 4, 32 teacher-forced
   steps from an empty cache cut by KV heads: each step's logits within
   2e-2; ms and bytes a step. (c) gemma-2b in f32 on (2, 2), where the
   single KV head and the batch cut over data cut the cache by sequence
   (the reference's rule cuts by sequence only over a data axis above
   one rank) and its KV leaves are cut mid-head: 32 decode steps at
   batch 2 within 1e-3, the forward (1, 2048) within 1e-4. (d)
   qwen2.5-3b's train step on (1, 2) at ``train_4k``'s seq, global
   batch 1, bf16, selective remat, donated AdamW: step 0's loss and
   global gradient norm within 2e-2 of the yardstick's, then 3 timed
   steps (ms, tokens/s, bytes a rank sends, peak per rank beside the
   card's). (e) the reduced train CLI ``--arch qwen2.5-3b --mesh 2x2
   --backend gloo`` on the card, failing at step 5: its logged losses
   equal ``--mesh 1x1``'s to the printed digits. Then the other
   families on (1, 2), each against its own one-rank yardstick
   (``TP_LAYERS`` cuts the depth); (a), (b), (d) and (f)-(h) run one
   after another in one process a rank, after every yardstick: (f) mamba2-780m at 2 of 48
   layers: the bf16 prefill (4, 8192), B7 counted on every rank (one
   launch a layer) and each rank's first launch, on its own strided
   ``[x of its heads, B, C]`` view of its projection, held to the plain
   version on that view (bf16 bit for bit, an f32 copy within 1e-5), the
   last logits held to 1.5x the one-rank bf16 prefill's own distance
   from the one-rank f32 prefill (as (b)); 32 f32 teacher-forced decode
   steps at batch 4 from a cache in ``cache_shardings``' blocks (conv
   window by channels, state by heads) within 1e-3; a bf16 train step
   (1, 4096), step 0's loss and gradient norm within 2e-2, step 1 timed
   with two B7 launches a layer (remat's recompute); B7 then timed alone
   at that view's geometry (the kernels line's tensor-parallel row). (g) recurrentgemma-9b at 4
   of 38 layers: the bf16 prefill (1, 8192) within 2e-2 and 32 bf16
   decode steps at batch 4 from the width-cut cache within 2e-2. (h)
   whisper-small at 4 + 4 of its 12 + 12 layers in f32: encode
   (4, 1500, 768) and the prefill at
   tokens (4, 448) within 1e-4, 32 decode steps from the encoder's
   cross K/V cut by heads within 1e-3; a bf16 train step at (8, 448)
   with its frames, step 0 within 2e-2, step 1 timed. Each prints ms,
   bytes a rank sends and peak per rank; the B1-B6 counters read 0
   throughout, B7 only in (f)'s prefill and train step.
   Phase 3 (moe), after phase 3 (tp) (also alone with ``--moe``): the
   MoE family at full width, random init from seeded generators on the
   card, plain PyTorch (the reference computes the router, the dispatch
   and the experts in ``jnp``, outside any Pallas kernel, so the B1-B7
   counters, zeroed before each part and read after, read 0). (a)
   qwen3-moe-30b-a3b (d_model 2048, 32/4 heads of 128, QK-norm, 128
   experts top-8 of width 768, vocab 151936) at 16 of its 48 layers
   (39.5 GiB of f32 parameters): the prefill (1, 8192) in bf16 through
   ``make_prefill_step`` (``prefill_32k``'s sequence, cut as llama3-8b's
   is), the chunked attention (1024/1024) in every layer, ms (median of
   2 after a warm-up), tokens/s, peak memory and the (token, choice)
   pairs dropped by capacity, in all and by layer; the serve loop of
   ``launch/serve.py`` at batch 4, 32 steps, its ms a step and drops
   (each decode step groups its 4 new tokens alone: a capacity of 1 a
   expert, as the reference's; decode is not held to the forward). (b)
   mixtral-8x7b (d_model 4096, 32/8 heads, 8 experts top-2 of width
   14336, vocab 32000, window 4096) at 4 of 32 layers (22.6 GiB): the
   same, its prefill through the banded attention (1024/4096) and its
   decode on the ring cache. (c) The card against the CPU on both
   reduced configs: the prefill's and the forward's logits, 8 decode
   steps (mixtral's window a ring past its 4 slots), the loss and every
   ``lm_loss`` gradient leaf, relative L2 within 1e-4 in f32; in bf16,
   where a near-tie in the router can flip an expert between the
   devices, each within 1.5x the CPU's own bf16-to-f32 distance; the
   flipped routes counted. (d) qwen3-moe's train step at 4 of 48 layers
   (46.4 GiB of parameters, gradients and AdamW moments), (1, 4096)
   bf16, selective remat, donated AdamW: step 0's cross-entropy within
   1.0 of ln(151936) and its aux above 0, the others timed (ms,
   tokens/s, peak). (e) EP: qwen3-moe at 4 layers in f32 on mesh (1, 2)
   of gloo ranks sharing the card (64 whole experts a rank), against a
   one-rank yardstick run first in this process: 8 decode steps at batch
   4 within 1e-3 of max |logit|; the prefill (1, 8192), whose routing at
   random init is chaotic, within 2x the distance of the yardstick's own
   prefill with the embedding one ulp away, and its differing routes by
   layer within 2x that run's plus 8; bytes a rank sends, ms, peak; no
   scaling figure. (f) MoE groups that span data-parallel ranks:
   mixtral at (b)'s 4 layers in f32 on meshes (2, 1) and (2, 2) (EP over
   ``model``) of gloo ranks, the prefill (2, 256) one group of 512
   tokens and each batch-4 decode step one group of 4, both spanning the
   two data ranks and gathered over them; against a one-rank yardstick
   of the same global batch run first: the routes identical, the drop
   counts equal (printed as shares), the prefill within (e)'s 2x the
   nudged run's distance, the decode within 1e-3; bytes, ms, peak.
   Phase 3 (hybrid), after phase 3 (moe) (also alone with ``--hybrid``):
   recurrentgemma-9b, plain PyTorch (the reference computes the RG-LRU
   with ``lax.associative_scan``, its temporal conv with the plain
   ``kref`` conv and the rest in ``jnp``, outside any Pallas kernel, so
   the B1-B7 counters, zeroed before each part and read after, read 0).
   (a) At full width and depth (38 layers: 12 (rec, rec, att)
   super-blocks and 2 tail recurrent blocks; d_model 4096, 16 heads of
   256 over one KV head, LRU width 4096, d_ff 12288, vocab 256000; 35.7
   GiB of f32 parameters): the prefill (1, 8192) in bf16 through
   ``make_prefill_step``, the banded attention (1024/2048) in 12 of 12
   attention layers and the log-depth scan in 26 of 26 recurrent
   layers, ms (median of 2 after a warm-up), tokens/s, peak; the serve
   loop of ``launch/serve.py`` at batch 4, 32 steps; the decode cache's
   bytes at max_len 64, 2048 (the window) and 524288, the last two
   equal. (b) The card against the CPU on the reduced config: the
   forward's logits, the loss and every ``lm_loss`` gradient leaf within
   1e-4 in f32 (logits of max |logit|, the rest relative L2); in bf16
   the logits, each token's cross-entropy and the gradient within 1.5x
   the CPU's own bf16-to-f32 distance; 40 decode steps in f32 through the ring (window 16, so it
   wraps twice) against the teacher-forced forward on the card, within
   1e-3 of max |logit|. (c) The train step at full width and the
   reference's reduced depth of 5 layers (one super-block, two tail
   blocks; 46.0 GiB of parameters, gradients and AdamW moments; all 38
   layers would need 142.6), (1, 4096) bf16, selective remat, donated
   AdamW: step 0's cross-entropy within 1.0 of ln(256000), the others
   timed (ms, tokens/s, peak); then the reduced train CLI (failing at
   step 5, restarting from its step-3 checkpoint) and serve CLI on the
   card, at once.
   Phase 3 (encdec), after phase 3 (hybrid) (also alone with
   ``--encdec``): whisper-small (12 encoder and 12 decoder layers,
   d_model 768, 12 heads, d_ff 3072, vocab 51865, tied), plain PyTorch,
   the B1-B7 counters 0. (a) At full size in bf16: ``encode`` on frames
   (4, 1500, 768); the teacher-forced prefill through
   ``make_prefill_step`` at tokens (4, 448) with the frames;
   ``init_decode_cache`` from the encoder's output, then 447 greedy
   decode steps through ``make_serve_step`` to the contract's 448
   tokens; ms and peak for each. (b) The card against the CPU on the
   reduced config at (b)'s limits above, its decode over every one of
   the ``max_target_len`` steps. (c) The train step at full size,
   tokens (8, 448) and frames (8, 1500, 768), bf16, donated AdamW:
   step 0's cross-entropy within 1.0 of ln(51865), the others timed (ms,
   peak).
   Phase 3 (dryrun), after phase 3 (encdec) (also alone with
   ``--dryrun``): (a) the eager dry run (``python -m
   repro_torch.launch.dryrun --all``, no card: meta tensors, rank 0 of
   the 16 x 16 and 2 x 16 x 16 meshes over a ``fake`` process group),
   started in a subprocess (``nice`` 19, 2 workers) right after phase 1
   and read here: every cell's status and dominant roofline term, and
   all 64 cells with status run ``ok``; (b) mamba2-780m's prefill (4,
   8192) bf16 (48 B7 launches), llama3-8b's bf16 decode step at batch 4
   against a 128-slot cache and qwen2.5-3b's train step (1, 4096) at
   12 of its 36 layers, each built on the card from a seed and on meta by
   ``dryrun.build_cell``: FlopCounterMode's count equal on both (B7, a
   ``ctypes`` launch, is not seen by the counter; meta runs the plain
   conv, whose elementwise work it does not count either), the step's
   host-clock time (median of 3) against ``Roofline.bound_s``.
   Phase 3 (examples), in phase 3 (clis) (also alone with
   ``--examples``): the five ``examples/torch_*.py`` at small arguments
   on the card, in subprocesses all at once, each exit code 0 and its
   OK line printed; seconds each, the stencil examples' fused-stencil
   launches (above 0).
   Phase 3 (verify), after the serve phase: the verification layer
   (``repro_torch.verify.mms``, ``physics.spectral``,
   ``boundary_weights``) through B1 (``swc``), B3 (``swc_stream``) and
   B4 (``tc``) at depth 1. The MMS matrix of
   ``tests/test_convergence.py:330-389`` (``MMS_SWEEPS``): f64 orders
   2, 4, 8 at ranks 1-3 (B3: 2-3), periodic and dirichlet (the blend on),
   on ``swc`` and ``swc_stream``; f32 orders 2 and 4 at ranks 1-2 on the
   reference's grids and the order-8 error floor, on ``swc`` and ``tc``;
   each slope within [nominal - 0.25, nominal + 1.2], each sweep printing
   its slope, its plain version's, the plan's tile per grid and its
   launches by kernel (one per grid, zeroed just before), each grid's
   output held to its plain version with the same blend (1e-12 f64, 1e-5
   f32 of the sums' scale, Σ|tap| x max|f|); the neumann / neumann2
   ghost-fill gap on ``swc``. The spectral oracle: the MHD RHS at 16³ and
   32³ f64 on ``swc`` and ``swc_stream`` (32³ within 5e-4, order > 5),
   and at 256³ f32 on the plain version, ``swc``, ``swc_stream`` and
   ``tc`` against the f64 spectral RHS within ``SPECTRAL_TOL_256``. The
   order-6 Laplacian at 512³ f32, dirichlet, ``boundary_weights=True`` on
   each strategy: held to the plain version with the blend, the interior
   equal to the unblended launch bit for bit, kernel, blend and step
   times (CUDA events, median) and the blend's share of the step.
   Phase 3 (tune), after it: the tuner (``repro_torch.tuning``) on a
   fresh cache under ``build/tune-cache`` (``tune_calls``):
   ``block="auto"`` (512³ ``swc``), ``fuse_steps="auto"`` (512³
   ``swc``), ``strategy="auto"`` with ``fuse_steps="auto"`` (diffusion
   512³, 8192², 2^26), the MHD RHS's ``strategy="auto"`` (256³ f32), B6's
   ``block_size="auto"`` (2^24, r = 1024, elementwise U = 4),
   ``SimServer(strategy="auto")`` on phase 3b's queue and ``serve_sim
   --smoke --auto-tune``. Every record must be measured (CUDA events)
   with no failed row; each record's timing table is printed, and each
   case's winner beside the planner's own tiles; each tuned launch is
   held to its plain version (1e-5 f32); at these sizes no
   ``strategy="auto"`` may resolve to ``hwc``. A subprocess replays
   every call: 0 measurements, the same decisions, the cache file
   unchanged. Then ``serve_sim --smoke --chaos`` on a cache of its own
   (its contract: poison quarantined, transient retried, the candidate
   fault a ``failed`` row, the garbled cache quarantined and rebuilt).
   Phase 3 (sharded), after it: ``FusedStencilOp.apply_sharded`` on
   meshes of processes that share this card over gloo (halos staged
   through pinned host memory; ``launch.mesh.run_on_mesh``, one spawn
   per mesh, the kernels built before), periodic random fields from one
   generator seed on every rank (``SHARDED_CASES``): diffusion 512³ f32
   order 6 on (2,) over z (B1), on (2,) over y (B3, depth 1), on (2, 2)
   over (z, y) at depth 1 (B1), 2 (B2's walk, halo 6) and on ``tc``
   (B4); MHD 256³ f32 on (2,) over z: the RHS on B1 and B4, the
   fused-axpy substep with its aux (B1), the ``fuse_rk_pairs`` pair
   (B2's walk, its carry exchanged at r·1); each with overlap off and
   on. Every rank holds its padded block from ``exchange_halos_nd`` to
   its window of the globally padded field (bit for bit) and its output
   to its block of the unsharded kernel's (bit-for-bit equality
   reported) and of the unsharded plain version (1e-5 of its largest
   |value|, the worst over ranks by ``all_reduce(MAX)``); launches
   counted per sharded step (1, or 1 + 2 x sharded axes with overlap).
   Rank 0 prints each case's bytes per exchange, the exchange's ms
   alone, the sharded step's ms with overlap off and on and the
   unsharded step's (host clock after a barrier, ending in a
   synchronize; median of 5), and a kernels-line row per case (the
   shard's launch on CUDA events, its plain version, bound and, for
   diffusion, the dense ``conv3d``) carrying the case's launches.
   Phase 3 (clis), run last: every command-line run of the phases above
   (the train CLIs of phase 3 (train), (dp train), (tp) and (hybrid),
   the hybrid's serve CLI and the five examples), none of which is a
   measurement, started at once in subprocesses, with phase 2 (which
   times nothing) and then phase 3 (audit) run in this process
   meanwhile; each CLI then checked as its own phase checks it when run
   alone, and the launches those checks make here audited after.
   Phase 3 (audit), in phase 3 (clis) (also alone with ``--audit``),
   after phase 4: the static auditor
   (``repro_torch.analysis``) at full extents over ``AUDIT_SHAPES``, the
   tuner's candidate spaces and every plan and B6/B7 launch the earlier
   phases made (``emit.launched_plans()``, the wrappers' ``launched``
   sets): unaudited 0, findings 0, counts by body and by the ROADMAP item
   of what is not ported, and the mutation harness (11 mutants, each
   caught with its class); each audited plan's layout fields from the
   library (``repro_<name>_layout``), the kernel's shared bytes and the
   auditor's equal field by field, persistent grids in [1, walk_items];
   guard-band launches of every body, dtype and φ kind (B = 3 with
   segments, PR 24's odd tiles, tuner winners off the planner, a 244-plane
   slab), each input a view at offset 0 and 1 element past 16 bytes
   inside 4 KiB of NaN each side, the output's interior NaN too: guards
   intact, no NaN out, equal to the ordinary launch bit for bit and to the
   plain version within TOL. memcheck is left out (``compute-sanitizer``
   does not support this machine's card). Each step prints its seconds.
4. Times (CUDA events, median after warm-up) of each kernel, its plain
   version and, for diffusion, ``F.conv{1,2,3}d`` with the merged
   stencil as a dense weight (S calls at depth S); the bound is
   max(bytes / memory rate, FLOPs / non-tensor rate) from the card's
   data sheet. Temporal rows (B2) also print their launch (the walk's
   persistent grid, columns, step and cross tile, rings, threads x
   outputs, registers and spills, or the one-tile body's grid of tiles)
   and the evaluations per output-step; stream rows their launch (at
   depth > 1 the walk's line), the tile, its shared memory, the
   modelled bytes per step (``repro_torch.core.trafficmodel``) and the
   redundant work (the walk: its evaluations per output-step). Batched
   rows
   (B members in one launch) also time B unbatched launches of the same
   members in the same call (on ``swc_stream`` each cut into the
   segments the planner gives one member); their library is ``conv{2,3}d``
   with N = B.
   The serve phase's batches (order 2, B = 8, 256³ and 4096², on
   ``swc``, ``swc_stream`` and ``tc``) get rows of their own, each
   carrying its bucket's launch count from the serve phase. tc rows
   (diffusion 512³ f32 S=1, 2, 3 and bf16 S=1, 2, 8192², 2^26; MHD RHS
   and substep 256³, the pair at 128³ and 256³, the walk's rows also
   printing their walk line) take their bound at the route's tensor-core
   rate
   (989 TFLOP/s bf16 MMA; 67 TFLOP/s f64 MMA for f32 fields) and print
   the banded multiply-adds the MMAs issue beside the taps' own
   (``plan.tc_issued_macs``) and, at depth 1, the persistent grid (the
   kernel's occupancy times the SMs), the ring's stages, the staging
   route (16-byte ``cp.async``) and the registers from ptxas; the bf16
   rows time ``conv*d`` in bf16. Depth-1 ``swc`` rows (B1) print their
   persistent grid (blocks per SM x SMs), ring stages, threads, outputs
   per thread, registers and spills; its 2^26 and 8192² rows join the
   kernels line with their main-path launch counts. Depth-1
   ``swc_stream`` rows (B3) print their grid, chunk and cross tile, the
   ring (chunks, plane slots, bytes) or the one-buffer body, threads x
   outputs per thread, registers and spills. The bf16 rows of B2, B3
   and the MHD φ (``bf16_rows``, also with ``--bf16``): diffusion 512³
   on B2 S=2/3 and B3 S=1-3, 8192² on B3, 2^26 S=2 on B2's one-tile
   body (beside the same launch in f32), the MHD RHS and substep 256³
   on B1, B3 (RHS) and B4, the pair 256³ on B2's and B4's walks; bound
   at 2 B a value, the taps' bf16 operations outside the tensor cores at
   the packed pair rate (``BF16_PAIR`` x f32) and φ's at the f32 rate,
   library ``conv*d`` in bf16 (none for MHD).
   B6 rows: each strategy at n = 2^24 (fig07's size), f32 at radii
   1-1024 (``XCORR_TIME_RADII``: r = 8 and 10 on each side of the
   elementwise ring's first radius) and f64 at r = 1, 10 and 1024,
   elementwise also at unroll 8 and 16 (Fig. 9's sweep) for f32 r >= 64
   and f64 r = 1024, each row naming its launch (one-tile or ring); bf16
   and f16 at r = 1, 10 and 1024; at r = 1024 in every dtype elementwise
   at unroll 32 and 64 and pointwise at 24 and 64 (register passes); and
   the 2^26 ``step_1d_xcorr`` launch in f32, bf16 and f16 (the kernels
   line's B6 rows); bound max((2n + 2r + taps) × itemsize / memory rate,
   2 × taps × n / non-tensor rate: f32, f64, or bf16/f16 at the packed
   pair rate, ``BF16_PAIR`` x f32, of which a multiply and an add each
   rounded reach half); library ``F.conv1d`` (cuDNN) in the same dtype
   with ``cudnn.allow_tf32`` off.
   B7 rows (the kernels line's): the strided xBC view at the prefill
   launch (4, 8192, 3328), k = 4, bf16 and f32, with launches per
   prefill, f16 and f64 (B7b's path), and bf16 at k = 16 and 33 (the
   body with k at run time); bound max(((b(s+k-1) + k)c + bsc) ×
   itemsize / memory rate, 2kbsc / non-tensor rate as B6's); library
   ``F.conv1d(groups=c, padding=k-1)`` (cuDNN, TF32 off) on a
   contiguous (b, c, s) copy, whose copy time is printed apart.
   Each phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil.cu"
REPLACES = "src/repro/kernels/emit.py:207"  # _kernel_pipelined (+ _block_derivs :73)
TEMPORAL_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_temporal.cu"
TEMPORAL_REPLACES = "src/repro/kernels/emit.py:271"  # _kernel_temporal (+ _temporal_sweeps :242)
TEMPORAL = "fused_stencil_temporal"
STREAM_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_stream.cu"
STREAM_REPLACES = "src/repro/kernels/emit.py:585"  # _kernel_stream (via _fused_stream :687)
STREAM = "fused_stencil_stream"
BATCH_REPLACES = "src/repro/kernels/emit.py:345"  # _fused_batched (+ _member_phi :318)
TC_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_tc.cu"
TC_REPLACES = "src/repro/kernels/emit.py:233"  # _kernel_tc (+ _block_derivs_tc :153)
TC = "fused_stencil_tc"
# At depth > 1 the reference runs _kernel_temporal with
# derivs_fn=_block_derivs_tc (emit.py:549-554).
TC_TEMPORAL_REPLACES = "src/repro/kernels/emit.py:271"
XCORR_SOURCE = "src/repro_torch/kernels/csrc/xcorr1d.cu"
# xcorr1d_pallas (+ _kernel_baseline :52, _kernel_elementwise :56, _mac_loop :35)
XCORR_REPLACES = "src/repro/kernels/stencil1d.py:73"
# B6's strategies as the paper's Figs. 8-9 run them: unroll 4 (baseline
# ignores it, as the reference's does).
XCORR_STRATEGIES = (("baseline", 4), ("pointwise", 4), ("elementwise", 4))
XCORR_RADII = (0, 1, 5, 32, 200, 1024)
# Phase 4's f32 radii at n = 2^24: r = 8 (17 taps) is elementwise's last
# one-tile launch, r = 10 (21 taps, RING_MIN_TAPS of xcorr1d.cu) its
# first on the ring.
XCORR_TIME_RADII = (1, 4, 8, 10, 16, 64, 256, 1024)
# Fig. 9's unroll sweep on elementwise (register tiling: U / 4 float4 in
# f32, U / 2 double2 in f64): phase 2's parity and phase 4's rows.
XCORR_UNROLLS = (("elementwise", 8), ("elementwise", 16))
# Odd tiles of the register tiling (V = 1, 2 or 4 elements a vector, the
# empty-slot layout or none), block_size 1536, on an f aligned to 16
# bytes and on one a single element past that (staged element by
# element): phase 2.
XCORR_ODD = (("elementwise", 2), ("elementwise", 3), ("elementwise", 6),
             ("elementwise", 12), ("elementwise", 24), ("pointwise", 7),
             ("baseline", 1))
# B6b: unroll factors past the register widths the kernel instantiates
# (1..16), run as U / U_r passes of U_r (its largest divisor of at most
# 16): phase 2's parity and phase 4's r = 1024 rows.
XCORR_WIDE = (("elementwise", 32), ("elementwise", 64), ("pointwise", 24),
              ("pointwise", 64))
XCORR_DTYPES = ("float32", "float64", "bfloat16", "float16")
# B7b: tap counts past the kernel's templated 8 (its body with k at run
# time), on the reference's sweep shapes.
CONV_WIDE_TAPS = (9, 16, 33)
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv1d_depthwise.cu"
# conv1d_depthwise_pallas (+ _kernel :26)
CONV_REPLACES = "src/repro/kernels/conv1d_depthwise.py:36"
# mamba2-780m's prefill at the cut size (registry prefill_32k is (32, 32768))
# and the decode-consistency prompt (two SSD chunks of 256).
PREFILL_SHAPE = (4, 8192)
DECODE_SHAPE = (2, 512)
LM_BATCH, LM_STEPS = 4, 32  # launch/serve.py's defaults
# Decode against forward at full width in f32, max |err| (absolute).
# tests/test_system.py:85 holds 5e-4 at the reduced config (4 layers,
# chunk 16); at 48 layers and chunk 256 the chunked form's f32
# exp(A_cs_i - A_cs_j) rounds unlike the recurrence and depth amplifies
# it (the reference's JAX code too: tools/mamba2_drift.py decode). On the
# H100, tools/mamba2_decode_limit.py reads 8.395e-4 to 1.110e-3 over four
# seeds, and 2.902e-1 to 7.523 with a fault planted in the decode path
# (conv window frozen, state decaying twice, state in bf16): the limit
# is twice the largest sound reading.
DECODE_TOL = 2.2e-3
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2,
       "float16": 2e-2}
# Host ms a step of the f32 main-path runs (phase 3 and its tc phase), by
# their launch-count keys: the bf16 phase prints each beside its own.
STEP_MS: dict[str, float] = {}
# Tensor-core rates of the tc routes (data sheet, SXM): bf16 MMA; the
# f32 fields contract on the f64 MMA.
TC_RATES = {"bfloat16": 989e12, "float32": 67e12}

# Data-sheet rates: (memory B/s, non-tensor f32 FLOP/s, non-tensor f64 FLOP/s).
CARD_RATES = {
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H100": (3.35e12, 67e12, 34e12),  # SXM5
    "H200": (4.8e12, 67e12, 34e12),
}
# Outside the tensor cores bf16 runs as packed pairs (mul.rn.bf16x2,
# add.rn.bf16x2) at twice the f32 rate (data sheet, SXM5: 133.8 TFLOP/s).
BF16_PAIR = 2


def card_rates(name: str) -> tuple[float, float, float]:
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def run(cmd: list[str]) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


CLI_TIMEOUT = 600  # seconds for every command of one run_at_once


def run_at_once(cmds: dict, logs: Path, during=None) -> dict:
    """Every command of ``cmds`` ({name: argv, or (argv, extra env)}) in
    a subprocess of its own from the repo's root with ``src`` on its
    path, all started together, their output in files under ``logs``;
    ``during()`` runs here meanwhile. Waits for all (each process
    started is ended). {name: (returncode, stdout, stderr, seconds)}."""
    import threading
    import types

    logs.mkdir(parents=True, exist_ok=True)
    procs, ends, files = {}, {}, {}
    t0 = time.perf_counter()

    def wait(name, proc):
        proc.wait()
        ends[name] = time.perf_counter() - t0

    try:
        for name, cmd in cmds.items():
            argv, extra = cmd if isinstance(cmd, tuple) else (cmd, {})
            files[name] = (logs / f"{name}.out", logs / f"{name}.err")
            with open(files[name][0], "w") as out, \
                    open(files[name][1], "w") as err:
                procs[name] = subprocess.Popen(
                    argv, stdout=out, stderr=err, text=True, cwd=ROOT,
                    env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                         **extra})
            threading.Thread(target=wait, args=(name, procs[name]),
                             daemon=True).start()
        if during is not None:
            during()
        while len(ends) < len(procs):
            if time.perf_counter() - t0 > CLI_TIMEOUT:
                raise TimeoutError(f"still running after {CLI_TIMEOUT} s: "
                                   f"{sorted(set(procs) - set(ends))}")
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: types.SimpleNamespace(
        returncode=proc.returncode, stdout=files[name][0].read_text(),
        stderr=files[name][1].read_text(), seconds=ends[name])
        for name, proc in procs.items()}


def _cli(module: str, *args) -> list[str]:
    return [sys.executable, "-m", f"repro_torch.launch.{module}", *args]


def _cli_ok(label: str, out) -> None:
    if out.returncode:
        raise AssertionError(f"{label}: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|), 2-byte types compared in f32."""
    if a.element_size() < 4 or b.element_size() < 4:
        a, b = a.float(), b.float()
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-300)


def check(label: str, got, want, dtype: str) -> float:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    err, rel = rel_err(got, want)
    ok = rel <= TOL[dtype]
    print(f"  {label:<44} max|err| {err:.3e}  rel {rel:.3e}  "
          f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: rel err {rel:.3e} > {TOL[dtype]}")
    return err


def check_equal(label: str, got, want) -> float:
    """Hold a kernel's output to its plain version bit for bit ("=");
    returns max |err| (0)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
    if not torch.equal(got, want):
        err, rel = rel_err(got, want)
        raise AssertionError(f"{label}: differs from the plain version "
                             f"(max|err| {err:.3e}, rel {rel:.3e}); want "
                             "bit for bit")
    print(f"  {label:<44} = (bit for bit)")
    return 0.0


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The seeded draws of the cases built inside reuse_draws(), by key; None
# outside it, where every case draws its own.
_DRAWS: dict | None = None


@contextlib.contextmanager
def reuse_draws():
    """Cases built inside draw each field (and aux) of one shape, dtype
    and seed once: the host's draws of 10^8 values a case would
    otherwise take most of a row's time. Inside another, the outer's
    draws are kept."""
    global _DRAWS
    if _DRAWS is not None:
        yield
        return
    _DRAWS = {}
    try:
        yield
    finally:
        _DRAWS = None


def drawn(key, make):
    """``make()``, or inside :func:`reuse_draws` its first result for
    ``key``."""
    if _DRAWS is None:
        return make()
    if key not in _DRAWS:
        _DRAWS[key] = make()
    return _DRAWS[key]


def mhd_aux(shape, dtype, device, seed):
    """The w of an MHD substep: 1e-3 x uniform [0, 1) of (8, *shape),
    seeded ``seed``."""
    import torch

    from repro_torch import as_dtype

    def make():
        g = torch.Generator(device="cpu").manual_seed(seed)
        return (1e-3 * torch.rand((8,) + tuple(shape), generator=g,
                                  dtype=torch.float64)
                ).to(device=device, dtype=as_dtype(dtype))

    return drawn(("mhd aux", tuple(shape), str(dtype), seed), make)


def diffusion_case(shape, dtype, device, block=None, unroll=1, seed=0,
                   fuse_steps=1, strategy="swc", segments=None, batch=None,
                   accuracy=6):
    """(f_padded, ops, phi, plan, aux) of ``fuse_steps`` diffusion
    steps of order ``accuracy`` in one launch; ``segments`` overrides
    the stream planner's;
    ``batch`` members (seeds ``seed``, ``seed + 1``, ...) make a
    (batch, 1, *padded) ensemble."""
    import dataclasses

    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics.diffusion import DiffusionProblem

    prob = DiffusionProblem(shape, accuracy=accuracy)
    op = prob.step_op(strategy, block=block, fuse_steps=fuse_steps,
                      device=device)
    if batch is None:
        f = drawn(("diffusion", tuple(shape), str(dtype), seed),
                  lambda: prob.init_field(seed, device=device, dtype=dtype))
    else:
        f = torch.stack([prob.init_field(seed + m, device=device, dtype=dtype)
                         for m in range(batch)])
    fp = pad(f, [r * fuse_steps for r in op.radius_per_axis], "periodic",
             spatial_axes=range(f.ndim - len(shape), f.ndim))
    plan = plan_for_nd(op.ops, tuple(fp.shape), 1, strategy=strategy,
                       block=block, dtype=dtype, unroll=unroll,
                       fuse_steps=fuse_steps)
    if segments is not None:
        plan = dataclasses.replace(plan, segments=segments)
    return fp, op.ops, op.phi, plan, None


def select_case(shape, dtype, device, fuse_steps, seed=0, strategy="swc",
                batch=None):
    """Two random fields through the whole order-6 derivative set, φ
    selecting ``dxx``: the select kind with more than one field
    (``batch`` members of them, when given)."""
    import torch

    from repro_torch.core.stencil import derivative_operator_set
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.kernels.phi import select_phi

    ops = derivative_operator_set(len(shape), 6, 0.3)
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = () if batch is None else (batch,)
    padded = lead + (2,) + tuple(n + 6 * fuse_steps for n in shape)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        device=device, dtype=getattr(torch, dtype))
    plan = plan_for_nd(ops, padded, 2, strategy=strategy, dtype=dtype,
                       fuse_steps=fuse_steps)
    return fp, ops, select_phi("dxx"), plan, None


def mhd_case(shape, dtype, device, substep, block=None, unroll=1,
             smooth=True, seed=0, strategy="swc", batch=None):
    """(f_padded, ops, phi, plan, aux) of one MHD RHS or RK substep;
    ``batch`` members (seeds ``seed``, ``seed + 1``, ...) make an
    ensemble, aux then (batch, 8, *shape). ``block`` defaults to the
    solver's: the planner's on ``swc`` and ``tc`` (depth 1), else
    ``MHDSolver.block``."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    if block is None and strategy == "swc_stream":
        block = solver.block
    init = solver.init_smooth if smooth else solver.init_fields
    kw = dict(amplitude=1e-2) if smooth else {}
    if batch is None:
        f = drawn(("mhd", tuple(shape), str(dtype), seed, smooth),
                  lambda: init(seed, dtype=dtype, **kw))
    else:
        f = torch.stack([init(seed + m, dtype=dtype, **kw)
                         for m in range(batch)])
    ops = solver.operator_set
    fp = pad(f, ops.radius_per_axis(), "periodic",
             spatial_axes=range(f.ndim - 3, f.ndim))
    if substep:
        dt = float(solver.cfl_dt(f if batch is None else f[0]))
        phi = mhd.mhd_substep_device_phi(
            solver.params, mhd.RK3_ALPHA[1], mhd.RK3_BETA[1], dt
        )
        if batch is None:
            aux = mhd_aux(shape, dtype, device, seed + 1)
        else:
            g = torch.Generator(device="cpu").manual_seed(seed + 1)
            aux = (1e-3 * torch.rand(f.shape, generator=g,
                                     dtype=torch.float64)
                   ).to(device=device, dtype=f.dtype)
    else:
        phi, aux = mhd.mhd_rhs_device_phi(solver.params), None
    plan = plan_for_nd(
        ops, tuple(fp.shape), phi.n_out(8),
        aux_shape=None if aux is None else tuple(aux.shape),
        strategy=strategy, block=block, dtype=dtype, unroll=unroll,
        max_threads=phi.max_threads, n_slots=len(phi.operators),
    )
    return fp, ops, phi, plan, aux


def mhd_pair_case(shape, dtype, device, substeps=(1, 2), block=None,
                  smooth=True, seed=0, strategy="swc"):
    """(f_padded, ops, phis, plan, aux) of two fused-axpy RK3 substeps
    in one depth-2 launch, aux = w. Substeps (1, 2), both with α ≠ 0,
    read the carried w in both sweeps; the solver's pair is (0, 1).
    ``block`` defaults to the solver's: the planner's (on ``swc`` and
    ``tc`` the walk's)."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    f = drawn(("mhd", tuple(shape), str(dtype), seed, smooth),
              lambda: solver.init_smooth(seed, amplitude=1e-2, dtype=dtype)
              if smooth else solver.init_fields(seed, dtype=dtype))
    ops = solver.operator_set
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    dt = float(solver.cfl_dt(f))
    phis = tuple(
        mhd.mhd_substep_device_phi(
            solver.params, mhd.RK3_ALPHA[i], mhd.RK3_BETA[i], dt)
        for i in substeps
    )
    aux = pad(mhd_aux(shape, dtype, device, seed + 1), 3, "periodic",
              spatial_axes=(1, 2, 3))
    plan = plan_for_nd(ops, tuple(fp.shape), 16, aux_shape=tuple(aux.shape),
                       strategy=strategy, block=block, dtype=dtype,
                       fuse_steps=2, max_threads=256, n_slots=10)
    return fp, ops, phis, plan, aux


def mhd_rhs_twice_case(shape, dtype, device, seed=0, strategy="swc"):
    """(f_padded, ops, phi, plan, aux) of the MHD RHS applied twice in
    one depth-2 launch (a self-map without aux)."""
    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    f = solver.init_smooth(seed, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    plan = plan_for_nd(solver.operator_set, tuple(fp.shape), 8,
                       strategy=strategy, dtype=dtype, fuse_steps=2,
                       max_threads=256, n_slots=10)
    return (fp, solver.operator_set, mhd.mhd_rhs_device_phi(solver.params),
            plan, None)


def ptxas_usage(name: str) -> dict[str, tuple[int, int]]:
    """(registers, bytes of spill stores) per kernel entry (mangled name)
    of ``csrc/<name>.cu``'s last build, from nvcc's ``-Xptxas -v``
    report."""
    from repro_torch.kernels import build

    usage, entry, spill = {}, None, 0
    for line in build.ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "spill stores" in line and entry is not None:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and entry is not None:
            usage[entry] = (int(line.split("Used")[1].split()[0]), spill)
            entry = None
    return usage


def _usage_of(name: str, key: str) -> str:
    found = [v for k, v in ptxas_usage(name).items() if key in k]
    if not found:
        return "? registers"
    regs, spill = found[0]
    return f"{regs} registers, {spill} B spilled"


def tc_launch_info(plan, phi, ops=None) -> str:
    """The tc launch of ``plan``: at depth 1 its persistent grid (the
    kernel's occupancy), ring stages, staging route and registers; at
    depth > 1 the walk's (``walk_launch_info``) or the one-tile body's
    grid of tiles."""
    import torch

    from repro_torch.kernels import emit

    if getattr(plan, "tc_walk", False):
        return walk_launch_info(plan, phi, ops)
    if not plan.tc_depth1:
        tiles = plan.batch
        for n, b in zip(plan.interior, plan.block):
            tiles *= n // b
        return (f"one-tile body with TcEval (depth {plan.fuse_steps}), "
                f"grid of {tiles} tiles")
    grid = emit.launch_grid(plan, phi.kind_id,
                            torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = "f" if plan.dtype == "float32" else "13__nv_bfloat16"
    key = f"tc_d1_kernelI{t}Li{phi.kind_id}E"
    return (f"persistent grid {grid} ({grid / sms:.2f} per SM, "
            f"{plan.walk_items} steps of {plan.tc_step.extent}), "
            f"{plan.stage_buffers}-stage ring of {plan.tc_step.buffer_bytes} "
            f"B windows, 16-byte cp.async staging, {plan.threads} threads, "
            f"{_usage_of(TC, key)}")


SWC_TYPE_KEYS = {"float32": "f", "float64": "d", "bfloat16": "13__nv_bfloat16"}


def swc_launch_info(plan, phi) -> str:
    """The depth-1 swc launch of ``plan`` (B1): its persistent grid (the
    kernel's resident blocks per SM times the SMs), ring stages, threads,
    outputs per thread, registers and spills."""
    import torch

    from repro_torch.kernels import emit

    grid = emit.launch_grid(plan, phi.kind_id, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    key = f"fused_stencil_kernelI{SWC_TYPE_KEYS[plan.dtype]}Li{phi.kind_id}E"
    return (f"persistent grid {grid} ({grid / sms:.2f} per SM x {sms} SMs, "
            f"{plan.walk_items} steps of {plan.swc_step.extent}), "
            f"{plan.stage_buffers}-stage ring of "
            f"{plan.swc_step.buffer_bytes} B windows, {plan.threads} "
            f"threads x {plan.outputs_per_thread} outputs, "
            f"{_usage_of('fused_stencil', key)}")


def temporal_launch_info(plan, phi) -> str:
    """The ``swc`` launch of ``plan`` at depth > 1 (B2). On the walk
    (``csrc/temporal_walk_body.cuh``): ``walk_launch_info``. On the
    one-tile body: its grid of tiles, threads, window buffers, registers
    and spills."""
    t = SWC_TYPE_KEYS[plan.dtype]
    if not plan.temporal_walk:
        tiles = plan.batch
        for n, b in zip(plan.interior, plan.block):
            tiles *= n // b
        key = f"temporal_kernelI{t}Li{phi.kind_id}E"
        return (f"one-tile body: grid of {tiles} tiles {plan.block}, "
                f"{plan.threads} threads, {plan.stage_buffers} window "
                f"buffer(s), {plan.smem_bytes} B shared, "
                f"{_usage_of(TEMPORAL, key)}")
    return walk_launch_info(plan, phi)


def walk_launch_info(plan, phi, ops=None) -> str:
    """A walk launch of ``plan`` at depth > 1 (B2 ``swc``, B3 ``swc_stream``
    on ``csrc/temporal_walk_body.cuh``; B4 ``tc`` on
    ``csrc/tc_walk_body.cuh``): its persistent grid (the kernel's resident
    blocks per SM times the SMs), its columns (members x segments of the
    slowest axis x cross tiles), the step and cross tile, the input ring
    and the intermediate (and carry) rings, threads x outputs per thread
    (tc: patches a warp contracts at once), registers and spills,
    evaluations per output-step and, on tc given ``ops``, the banded
    multiply-adds issued against the taps'."""
    import torch

    from repro_torch.kernels import emit

    t = SWC_TYPE_KEYS[plan.dtype]
    grid = emit.launch_grid(plan, phi.kind_id, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ring = plan.walk_ring
    tail = ""
    if plan.strategy == "tc":
        from repro_torch.kernels.plan import (
            TC_MMA_ROWS, TC_PATCH_BATCH, tc_issued_macs)

        kind = "select" if plan.n_slots == 1 else "mhd"
        per = (f"{TC_PATCH_BATCH[kind, plan.dtype]} patches of "
               f"{TC_MMA_ROWS[plan.dtype]} x 8 a warp")
        usage = _usage_of(TC, f"tc_walk_kernelI{t}Li{phi.kind_id}E")
        if ops is not None:
            issued, needed = tc_issued_macs(plan, ops, list(phi.operators))
            tail = (f"; banded MACs issued {issued:.6e} against "
                    f"{needed:.6e} ({issued / needed:.3f}x)")
    elif plan.strategy == "swc_stream":
        per = f"{plan.outputs_per_thread} outputs"
        usage = _usage_of(STREAM, f"stream_walk_kernelI{t}E")
    else:
        per = f"{plan.outputs_per_thread} outputs"
        usage = _usage_of(TEMPORAL, f"walk_kernelI{t}Li{phi.kind_id}E")
    return (f"walk: persistent grid {grid} ({grid / sms:.2f} per SM x {sms} "
            f"SMs), {plan.walk_items} columns ({plan.batch} member(s) x "
            f"{plan.segments} segment(s) of {plan.interior[0] // plan.segments}"
            f" planes x cross tiles {plan.block[1:]}), step {plan.block[0]} "
            f"plane(s), input ring of {ring.inp.period} plane slots "
            f"({plan.stage_buffers} steps, {ring.inp.ring_bytes} B), "
            f"{len(ring.mid_bytes)} intermediate ring(s) of "
            f"{ring.mid_slots} slots ({sum(ring.mid_bytes)} B), "
            + (f"carry rings of {ring.carry_slots} slots "
               f"({sum(ring.carry_bytes)} B), " if plan.n_aux else "")
            + f"{plan.smem_bytes} B shared, {plan.threads} threads x {per}, "
            f"{usage}; evaluations per output-step "
            f"{plan.evaluations_per_output_step:.4f}{tail}")


def stream_launch_info(plan, phi) -> str:
    """The ``swc_stream`` launch of ``plan`` (B3): at depth > 1 the walk's
    (``walk_launch_info``); else its grid (cross tiles x members x
    segments), chunk and cross tile, the ring on the depth-1 body (chunks
    it holds, plane slots, bytes) or the one-buffer body, threads x
    outputs per thread, registers and spills."""
    import torch

    if getattr(plan, "stream_walk", False):
        return walk_launch_info(plan, phi)
    kind, t = phi.kind_id, SWC_TYPE_KEYS[plan.dtype]
    tiles = 1
    for n, b in zip(plan.interior[1:], plan.block[1:]):
        tiles *= n // b
    grid = tiles * plan.batch * plan.segments
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    head = (f"grid {grid} ({grid / sms:.2f} per SM: {tiles} cross tiles x "
            f"{plan.batch} member(s) x {plan.segments} segment(s)), chunk "
            f"{plan.block[0]}, cross tile {plan.block[1:]}")
    if getattr(plan, "stream_depth1", False):
        ring = plan.stream_ring
        u = plan.outputs_per_thread
        key = f"stream_d1_kernelI{t}Li{kind}ELi{u}E"
        return (f"{head}, ring body: {plan.stage_buffers} chunk(s) in a ring "
                f"of {ring.period} plane slots ({ring.ring_bytes} B, "
                f"{plan.smem_bytes} B shared), 16-byte cp.async, "
                f"{plan.threads} threads x {u} outputs, "
                f"{_usage_of(STREAM, key)}")
    key = f"stream_kernelI{t}E"  # depth 1, the f64 MHD RHS only
    return (f"{head}, one-buffer body ({plan.smem_bytes} B shared), "
            f"{plan.threads} threads x 1 output, {_usage_of(STREAM, key)}")


def plain(case):
    """The plain PyTorch version of a case's launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.phi import phi_sequence

    fp, ops, phi, plan, aux = case
    phis = phi_sequence(phi, plan.fuse_steps)
    batched = fp.ndim == plan.rank + 2
    tc = plan.strategy == "tc"
    if plan.fuse_steps == 1:
        fn = ref.fused_stencil_batched if batched else ref.fused_stencil
        return fn(fp, ops, phis[0].torch_fn, aux=aux, tc=tc)
    fn = ref.fused_stencil_steps_batched if batched else ref.fused_stencil_steps
    return fn(fp, ops, [p.torch_fn for p in phis], plan.fuse_steps, aux=aux,
              tc=tc)


def compare(label, case, dtype):
    from repro_torch.kernels import emit

    import torch

    fp, ops, phi, plan, aux = case
    layout = emit.kernel_smem_bytes(plan)
    if layout != plan.smem_bytes:
        raise AssertionError(
            f"{label}: plan.smem_bytes {plan.smem_bytes} != the kernel's "
            f"layout {layout}")
    got = emit.fused_stencil_swc(fp, ops, phi, plan, aux=aux)
    first = phi[0] if isinstance(phi, tuple) else phi
    if plan.strategy == "tc":
        print(f"    tc: {tc_launch_info(plan, first, ops)}")
    elif plan.swc_depth1:
        print(f"    swc: {swc_launch_info(plan, phi)}")
    elif plan.stream_axis is not None:
        print(f"    stream: {stream_launch_info(plan, phi)}")
    elif plan.temporal_walk:
        print(f"    temporal: {temporal_launch_info(plan, first)}")
    seg = f" seg{plan.segments}" if plan.segments > 1 else ""
    want = plain(case)
    check(f"{label} {dtype} S{plan.fuse_steps} tile{plan.block}"
          f"u{plan.unroll}{seg} {plan.smem_bytes}B", got, want, dtype)
    if (dtype == "bfloat16" and plan.strategy != "tc"
            and not torch.equal(got, want)):
        raise AssertionError(f"{label}: bf16 {plan.strategy} differs from its "
                             "plain version (it rounds each product, sum "
                             "and φ's operations as the plain version does)")
    if dtype == "bfloat16" and plan.n_slots > 1:
        scale = float(want.float().abs().max())
        rows = (got.float() - want.float()).abs().flatten(-3).amax(-1)
        rows = rows.reshape(-1, plan.n_out).amax(0) / scale
        print(f"    per field row, max|err| / max|plain| (limit "
              f"{TOL[dtype]:.0e}): "
              + " ".join(f"{float(v):.2e}" for v in rows))
    return got


def compare_batched(label, case, dtype):
    """A batched case against the batched plain version, and each member
    against the unbatched launch on that member: equal bit for bit, since
    its block runs the unbatched body on the same values."""
    import dataclasses

    import torch

    from repro_torch.kernels import emit

    fp, ops, phi, plan, aux = case
    got = compare(f"{label} B={plan.batch} gz{plan.grid_z}", case, dtype)
    solo = dataclasses.replace(plan, batch=1)
    for m in range(plan.batch):
        one = emit.fused_stencil_swc(fp[m], ops, phi, solo,
                                     aux=None if aux is None else aux[m])
        if not torch.equal(got[m], one):
            diff = float((got[m] - one).abs().max())
            raise AssertionError(f"{label}: member {m} of the batched launch "
                                 f"differs from its unbatched launch by {diff}")
    print(f"    each of {plan.batch} member(s) equals its unbatched launch "
          "exactly")


def xcorr_inputs(n, radius, dtype, device, seed=0):
    """(f_padded, g) of n outputs at ``radius``: standard normal draws
    from a seeded CPU generator, moved to ``device``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    f = torch.randn(n + 2 * radius, generator=gen, dtype=torch.float64)
    g = torch.randn(2 * radius + 1, generator=gen, dtype=torch.float64)
    dt = getattr(torch, dtype)
    return f.to(device=device, dtype=dt), g.to(device=device, dtype=dt)


def phase_card():
    import torch

    from repro_torch.kernels import build

    print("== phase 1: card and build")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("  " + run([build.nvcc_path(), "--version"]).splitlines()[-1])
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas: " + line.strip())
    return smi


def phase_parity(dev):
    print("== phase 2: kernel vs plain version on the card")
    for dtype in ("float32", "float64"):
        compare("diffusion (65536,)", diffusion_case((65536,), dtype, dev),
                dtype)
        compare("diffusion (512, 384)",
                diffusion_case((512, 384), dtype, dev), dtype)
        compare("diffusion (64, 96, 128)",
                diffusion_case((64, 96, 128), dtype, dev), dtype)
        compare("diffusion (64, 96, 128)",
                diffusion_case((64, 96, 128), dtype, dev, block=(2, 8, 32),
                               unroll=2), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            for substep in (False, True):
                name = "mhd_substep" if substep else "mhd_rhs"
                compare(f"{name} {shape}",
                        mhd_case(shape, dtype, dev, substep), dtype)
        compare("mhd_substep (48, 64, 80)",
                mhd_case((48, 64, 80), dtype, dev, True, block=(1, 8, 16),
                         unroll=2), dtype)
    print("  -- temporal kernel vs ref.fused_stencil_steps")
    for dtype in ("float32", "float64"):
        for depth in (2, 3):
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare(f"diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth),
                        dtype)
            compare("select dxx, 2 fields (48, 64, 80)",
                    select_case((48, 64, 80), dtype, dev, depth), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            compare(f"mhd_substep pair {shape}",
                    mhd_pair_case(shape, dtype, dev), dtype)
        compare("mhd_rhs twice (48, 64, 80)",
                mhd_rhs_twice_case((48, 64, 80), dtype, dev), dtype)
    print("  -- temporal walk (select at ranks 2 and 3): a ragged row pitch "
          "(37 + 2rS elements), steps of several planes, segments forced to "
          "1 and 4")
    for dtype in ("float32", "float64"):
        for depth in (2, 3):
            compare("diffusion (48, 18, 37)",
                    diffusion_case((48, 18, 37), dtype, dev, block=(2, 6, 37),
                                   fuse_steps=depth), dtype)
            compare("diffusion (1024, 37)",
                    diffusion_case((1024, 37), dtype, dev, block=(4, 37),
                                   fuse_steps=depth, accuracy=4), dtype)
            for seg in (1, 4):
                compare("diffusion (192, 64, 120)",
                        diffusion_case((192, 64, 120), dtype, dev,
                                       fuse_steps=depth, segments=seg), dtype)
    print("  -- stream kernel (swc_stream) vs ref.fused_stencil[_steps]")
    for dtype in ("float32", "float64"):
        for depth in (1, 2, 3):
            # Many chunks along the stream axis; x off the default tile
            # (120 = 4 x 30, 400 = 8 x 50).
            for shape in ((512, 400), (64, 96, 120)):
                compare(f"stream diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                       strategy="swc_stream"), dtype)
        compare("stream select dxx, 2 fields (48, 64, 80)",
                select_case((48, 64, 80), dtype, dev, 2,
                            strategy="swc_stream"), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            compare(f"stream mhd_rhs {shape}",
                    mhd_case(shape, dtype, dev, False,
                             strategy="swc_stream"), dtype)
        for shape, depth, seg in (((1024, 96), 1, 4), ((192, 64, 120), 2, 4),
                                  ((256, 64, 64), 1, 8)):
            compare(f"stream diffusion {shape} in segments",
                    diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                   strategy="swc_stream", segments=seg),
                    dtype)
    print("  -- depth-1 stream ring body at a ragged row pitch (x 35 of a "
          "41-element row, chunks of 21 points for 1024 thread outputs), "
          "stream extents of many ring passes")
    for dtype in ("float32", "float64"):
        compare("stream diffusion (48, 18, 35)",
                diffusion_case((48, 18, 35), dtype, dev, block=(2, 3, 7),
                               strategy="swc_stream"), dtype)
        compare("stream diffusion (2048, 35)",
                diffusion_case((2048, 35), dtype, dev, block=(3, 35),
                               strategy="swc_stream", accuracy=2), dtype)
        compare("stream diffusion (4096, 256)",
                diffusion_case((4096, 256), dtype, dev, strategy="swc_stream",
                               segments=2), dtype)
    print("  -- ensemble batch (B5): batched kernel vs batched plain version, "
          "each member vs its unbatched launch")
    for dtype in ("float32", "float64"):
        for batch in (1, 3, 8) if dtype == "float32" else (3,):
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare_batched(f"diffusion {shape}",
                                diffusion_case(shape, dtype, dev, batch=batch),
                                dtype)
        for depth in (2, 3):
            compare_batched("diffusion (64, 96, 128)",
                            diffusion_case((64, 96, 128), dtype, dev,
                                           fuse_steps=depth, batch=3), dtype)
        compare_batched("select dxx, 2 fields (48, 64, 80)",
                        select_case((48, 64, 80), dtype, dev, 2, batch=3),
                        dtype)
        for depth in (1, 2):
            for shape in ((512, 400), (64, 96, 120)):
                compare_batched(f"stream diffusion {shape}",
                                diffusion_case(shape, dtype, dev,
                                               fuse_steps=depth, batch=3,
                                               strategy="swc_stream"), dtype)
        compare_batched("stream diffusion (1024, 96) in segments",
                        diffusion_case((1024, 96), dtype, dev, batch=3,
                                       strategy="swc_stream", segments=4),
                        dtype)
        for substep in (False, True):
            name = "mhd_substep" if substep else "mhd_rhs"
            compare_batched(f"{name} (64, 64, 64)",
                            mhd_case((64,) * 3, dtype, dev, substep, batch=2),
                            dtype)
    print("  -- bf16 in the depth-1 kernel (B1b) vs ref.fused_stencil in bf16")
    for shape in ((65536,), (512, 384), (64, 96, 128)):
        compare(f"diffusion {shape}", diffusion_case(shape, "bfloat16", dev),
                "bfloat16")
    compare("select dxx, 2 fields (48, 64, 80)",
            select_case((48, 64, 80), "bfloat16", dev, 1), "bfloat16")
    compare_batched("diffusion (64, 96, 128)",
                    diffusion_case((64, 96, 128), "bfloat16", dev, batch=3),
                    "bfloat16")
    print("  -- depth-1 swc at a ragged row pitch (41 elements, unroll 5, a "
          "step of 210 points for 1024 thread outputs)")
    for dtype in ("float32", "float64", "bfloat16"):
        compare("diffusion (12, 18, 35)",
                diffusion_case((12, 18, 35), dtype, dev, block=(2, 3, 7),
                               unroll=5), dtype)
    print("  -- tc kernel vs ref.fused_stencil_tc[_steps] (f32 on the f64 "
          "MMA, bf16 on the bf16 MMA)")
    for dtype in ("float32", "bfloat16"):
        for depth in (1, 2, 3):
            # Tiles off the 8-wide segment: x tiles 2002 (of 30030), 50
            # (of 400) and 30 (of 120), so the last segment is ragged.
            for shape in ((65536,), (30030,), (512, 400), (64, 96, 120)):
                compare(f"tc diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                       strategy="tc"), dtype)
            compare("tc select dxx, 2 fields (48, 64, 80)",
                    select_case((48, 64, 80), dtype, dev, depth,
                                strategy="tc"), dtype)
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare_batched(f"tc diffusion {shape}",
                                diffusion_case(shape, dtype, dev, batch=3,
                                               fuse_steps=depth,
                                               strategy="tc"), dtype)
    for shape in ((64, 64, 64), (48, 64, 80)):
        for substep in (False, True):
            name = "mhd_substep" if substep else "mhd_rhs"
            compare(f"tc {name} {shape}",
                    mhd_case(shape, "float32", dev, substep, strategy="tc"),
                    "float32")
        compare(f"tc mhd_substep pair {shape}",
                mhd_pair_case(shape, "float32", dev, strategy="tc"),
                "float32")
    for substep in (False, True):
        name = "mhd_substep" if substep else "mhd_rhs"
        compare_batched(f"tc {name} (64, 64, 64)",
                        mhd_case((64,) * 3, "float32", dev, substep, batch=3,
                                 strategy="tc"), "float32")
    print("  -- tc walk at depth > 1 (csrc/tc_walk_body.cuh): ragged patches "
          "(regions of 37 + 2r columns, rows of one line at rank 2), "
          "segments forced to 1 and 4, B = 3, the MHD RHS twice and the "
          "pair at 256^3's launch")
    for dtype in ("float32", "bfloat16"):
        for depth in (2, 3):
            compare("tc diffusion (48, 18, 37)",
                    diffusion_case((48, 18, 37), dtype, dev, block=(2, 6, 37),
                                   fuse_steps=depth, strategy="tc"), dtype)
            compare("tc diffusion (1024, 37)",
                    diffusion_case((1024, 37), dtype, dev, block=(4, 37),
                                   fuse_steps=depth, accuracy=4,
                                   strategy="tc"), dtype)
            for seg in (1, 4):
                compare("tc diffusion (192, 64, 120)",
                        diffusion_case((192, 64, 120), dtype, dev,
                                       fuse_steps=depth, segments=seg,
                                       strategy="tc"), dtype)
        compare_batched("tc select dxx, 2 fields (48, 64, 80)",
                        select_case((48, 64, 80), dtype, dev, 3, batch=3,
                                    strategy="tc"), dtype)
    compare("tc mhd_rhs twice (48, 64, 80)",
            mhd_rhs_twice_case((48, 64, 80), "float32", dev, strategy="tc"),
            "float32")
    compare("tc mhd_substep pair (256, 256, 256)",
            mhd_pair_case((256,) * 3, "float32", dev, strategy="tc"),
            "float32")
    print("  -- stream walk at depth > 1 (swc_stream on "
          "csrc/temporal_walk_body.cuh): a ragged row pitch, segments forced "
          "to 1 and 4")
    for dtype in ("float32", "float64"):
        for depth in (2, 3):
            compare("stream diffusion (48, 18, 37)",
                    diffusion_case((48, 18, 37), dtype, dev, block=(2, 6, 37),
                                   fuse_steps=depth, strategy="swc_stream"),
                    dtype)
            for seg in (1, 4):
                compare("stream diffusion (192, 64, 120)",
                        diffusion_case((192, 64, 120), dtype, dev,
                                       fuse_steps=depth, segments=seg,
                                       strategy="swc_stream"), dtype)
    print("  -- tc beyond radius 4 (C1): orders 10 and 12, the band of "
          "8 + 2r rows in more than one k-step")
    for dtype in ("float32", "bfloat16"):
        for shape, order in (((30030,), 12), ((512, 400), 10),
                             ((64, 96, 120), 10), ((64, 96, 120), 12)):
            compare(f"tc diffusion o{order} {shape}",
                    diffusion_case(shape, dtype, dev, strategy="tc",
                                   accuracy=order), dtype)
    print("  -- depths 9 and 12 (C2): B2, B3 and B4 at 2-D, order 2, the "
          "phi parameter rows in a device buffer")
    for depth in (9, 12):
        for shape in ((64, 64), (512, 400)):
            for strategy in ("swc", "swc_stream", "tc"):
                compare(f"{strategy} diffusion o2 {shape}",
                        diffusion_case(shape, "float32", dev,
                                       fuse_steps=depth, strategy=strategy,
                                       accuracy=2), "float32")
    parity_bf16(dev)
    phase_parity_1d(dev)


def phase_parity_1d(dev):
    """Phase 2's B6 and B7 cases (also alone: ``--1d``)."""
    parity_xcorr(dev)
    parity_conv1d(dev)


def parity_bf16(dev):
    """bf16 on B2 (the temporal kernel: its walk at ranks 2 and 3, the
    one-tile body at rank 1), B3 (the stream kernel: the depth-1 ring and
    the walk) and the MHD φ on B1, B3's ring, B4 and both walks' pair
    (B2c, B3c, B4b). Each equals its plain version bit for bit (compare)
    but the MHD kinds on tc, which are held to 2e-2 of max |plain|; each
    MHD field row's error is printed."""
    bf = "bfloat16"
    print("  -- bf16 in the temporal kernel (B2c): ranks 1-3 at depth 2 and "
          "3, two fields, rows of 41 bf16 elements (ragged modulo 8), "
          "segments forced to 1 and 4, B = 3; equal bit for bit")
    for depth in (2, 3):
        for shape in ((65536,), (512, 384), (64, 96, 128)):
            compare(f"diffusion {shape}",
                    diffusion_case(shape, bf, dev, fuse_steps=depth), bf)
        compare("select dxx, 2 fields (48, 64, 80)",
                select_case((48, 64, 80), bf, dev, depth), bf)
        x = 41 - 6 * depth  # padded rows of 41 elements at order 6
        compare(f"diffusion (48, 18, {x}) pitch 41",
                diffusion_case((48, 18, x), bf, dev, block=(2, 6, x),
                               fuse_steps=depth), bf)
        compare(f"diffusion (1024, {x}) pitch 41",
                diffusion_case((1024, x), bf, dev, block=(4, x),
                               fuse_steps=depth), bf)
        for seg in (1, 4):
            compare("diffusion (192, 64, 120)",
                    diffusion_case((192, 64, 120), bf, dev, fuse_steps=depth,
                                   segments=seg), bf)
        compare_batched("diffusion (64, 96, 128)",
                        diffusion_case((64, 96, 128), bf, dev,
                                       fuse_steps=depth, batch=3), bf)
    print("  -- bf16 in the stream kernel (B3c): ranks 2-3 at depth 1-3, cut "
          "stream axes, many ring passes, rows of 41 elements; equal bit for "
          "bit")
    for depth in (1, 2, 3):
        for shape in ((512, 400), (64, 96, 120)):
            compare(f"stream diffusion {shape}",
                    diffusion_case(shape, bf, dev, fuse_steps=depth,
                                   strategy="swc_stream"), bf)
    compare("stream select dxx, 2 fields (48, 64, 80)",
            select_case((48, 64, 80), bf, dev, 2, strategy="swc_stream"), bf)
    for shape, depth, seg in (((1024, 96), 1, 4), ((192, 64, 120), 2, 4),
                              ((256, 64, 64), 1, 8), ((192, 64, 120), 3, 1)):
        compare(f"stream diffusion {shape} in segments",
                diffusion_case(shape, bf, dev, fuse_steps=depth,
                               strategy="swc_stream", segments=seg), bf)
    compare("stream diffusion (48, 18, 35) pitch 41",
            diffusion_case((48, 18, 35), bf, dev, block=(2, 3, 7),
                           strategy="swc_stream"), bf)
    compare("stream diffusion (2048, 35)",
            diffusion_case((2048, 35), bf, dev, block=(3, 35),
                           strategy="swc_stream", accuracy=2), bf)
    compare("stream diffusion (4096, 256)",
            diffusion_case((4096, 256), bf, dev, strategy="swc_stream",
                           segments=2), bf)
    compare_batched("stream diffusion (512, 400)",
                    diffusion_case((512, 400), bf, dev, fuse_steps=2, batch=3,
                                   strategy="swc_stream"), bf)
    print("  -- the MHD φ in bf16 (B4b) on B1, B3's ring (the RHS), B4, and "
          "the pair on B2's and B4's walks; equal bit for bit but on tc, "
          "within 2e-2 of max |plain|")
    for shape in ((64, 64, 64), (48, 64, 80)):
        for substep in (False, True):
            name = "mhd_substep" if substep else "mhd_rhs"
            for strategy in ("swc", "tc") + (() if substep
                                             else ("swc_stream",)):
                compare(f"{strategy} {name} {shape}",
                        mhd_case(shape, bf, dev, substep, strategy=strategy),
                        bf)
        for strategy in ("swc", "tc"):
            compare(f"{strategy} mhd_substep pair {shape}",
                    mhd_pair_case(shape, bf, dev, strategy=strategy), bf)
    compare("swc mhd_rhs twice (48, 64, 80)",
            mhd_rhs_twice_case((48, 64, 80), bf, dev), bf)
    compare_batched("swc mhd_substep (64, 64, 64)",
                    mhd_case((64,) * 3, bf, dev, True, batch=2), bf)


def conv_inputs(shape, k, dtype, device, seed=0, row=None, offset=0):
    """(x, w): x (b, s, c) standard normal, w (k, c); with ``row``, x is
    the column view ``[..., offset:offset + c]`` of a (b, s, row) tensor
    (mamba2's xBC inside its in-projection)."""
    import torch

    b, s, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    full = torch.randn((b, s, row or c), generator=gen, device=device)
    x = full.to(dt)[..., offset:offset + c]
    w = torch.randn((k, c), generator=gen, device=device).to(dt)
    return x, w


def parity_conv1d(dev):
    """B7 (``csrc/conv1d_depthwise.cu``) against ``ref.conv1d_depthwise``:
    the reference's sweep shapes, mamba2-780m's prefill launch (4, 8192,
    3328) with k = 4, a ragged s, and the strided xBC view of the
    (4, 8192, 6448) in-projection (16-byte lanes at offset 3072, bf16
    pairs at 3074, single channels at 3073), and the sweep shapes at k =
    9, 16 and 33 (B7b: the body with k at run time), f32, bf16, f16 and
    f64, activation none and silu; each launch's threads, grid and tap
    body held to the kernel's own layout. "=" marks an output equal to
    the plain version's bit for bit, "~" one within the tolerance only;
    f16 must be "=" (B7b)."""
    import torch

    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    print("  -- B7 conv1d_depthwise vs ref.conv1d_depthwise")
    b, s = PREFILL_SHAPE
    cases = [((1, 64, 8), 4, 128, {}), ((3, 100, 16), 4, 128, {}),
             ((2, 257, 32), 7, 128, {}),
             ((b, s, 3328), 4, 512, {}), ((b, s + 1, 3328), 4, 512, {}),
             ((b, s, 3328), 4, 512, dict(row=6448, offset=3072)),
             ((b, s, 3328), 4, 512, dict(row=6448, offset=3074)),
             ((b, s, 3328), 4, 512, dict(row=6448, offset=3073))]
    cases += [(shape, k, 128, {}) for k in CONV_WIDE_TAPS
              for shape in ((1, 64, 8), (3, 100, 16), (2, 257, 32))]
    if kc.kernel_threads() != kc.THREADS:
        raise AssertionError("conv1d: the kernel's threads differ from "
                             "conv1d_depthwise.py's")
    for dtype in XCORR_DTYPES:
        for i, (shape, k, block_seq, view) in enumerate(cases):
            x, w = conv_inputs(shape, k, dtype, dev, seed=i, **view)
            vec = kc.vector_width(x, w)
            for act in ("none", "silu"):
                resident = kc.kernel_grid(0, 0, 0, k, act, dtype, vec)
                grid, _ = kc.launch_layout(*shape, vec, resident)
                if kc.kernel_grid(*shape, k, act, dtype, vec) != grid or \
                        kc.layout_fields(*shape, k, vec)[1]["taps"] != \
                        kc.tap_body(k):
                    raise AssertionError(
                        f"conv1d {shape} {act}: the kernel's grid or tap "
                        "body differs from conv1d_depthwise.py's")
                got = kops.conv1d_depthwise(x, w, activation=act,
                                            block_seq=block_seq)
                want = ref.conv1d_depthwise(x, w, act)
                tag = f" view row {view['row']} +{view['offset']}" \
                    if view else ""
                same = "=" if torch.equal(got, want) else "~"
                label = (f"conv1d {shape} k={k} {act}{tag} vec{vec} grid "
                         f"{grid} ({resident} resident) {dtype}")
                if dtype == "float16":
                    check_equal(label, got, want)
                else:
                    check(f"{label} {same}", got, want, dtype)
                del got, want
            del x, w


def _xcorr_layout_check(label, n, n_taps, block, strategy, unroll, dtype):
    """Hold the launch's threads, shared bytes and grid to the kernel's
    own; returns them and the launch's name ("ring" with its windows, or
    "one-tile")."""
    from repro_torch.kernels import xcorr1d as kx

    layout = kx.kernel_layout(n_taps, block, strategy, unroll, dtype)
    want = (kx.launch_threads(block, strategy, unroll, n_taps),
            kx.smem_bytes(n_taps, block, dtype, strategy, unroll))
    resident = kx.kernel_grid(0, n_taps, block, strategy, unroll, dtype)
    grid = kx.kernel_grid(n, n_taps, block, strategy, unroll, dtype)
    want_grid = kx.launch_grid(n, n_taps, block, strategy, unroll, resident)
    _, fields = kx.layout_fields(n_taps, block, strategy, unroll, dtype)
    u = kx.kernel_unroll(strategy, unroll)
    ur = kx.register_unroll(u)
    if layout != want or grid != want_grid or \
            (fields["unroll"], fields["passes"]) != (ur, u // ur):
        raise AssertionError(
            f"{label}: the kernel's layout {layout}, grid {grid}, U_r "
            f"{fields['unroll']} x {fields['passes']} differ from "
            f"xcorr1d.py's {want}, {want_grid}, {ur} x {u // ur}")
    route = "one-tile"
    if kx.ring_route(strategy, u, n_taps):
        stages = kx.ring_stages(n_taps, block, dtype, strategy, unroll)
        route = f"ring of {stages}"
    if u > ur:
        route += f", {u // ur} passes of U_r {ur}"
    return layout, route, grid


def check_xcorr(label, got, want, dtype):
    """B6 against its plain version: the 2-byte types bit for bit (B6b),
    f32 and f64 within TOL (FMAs)."""
    if dtype in ("bfloat16", "float16"):
        return check_equal(label, got, want)
    return check(label, got, want, dtype)


def parity_xcorr(dev):
    """B6 (``csrc/xcorr1d.cu``) against ``ref.xcorr1d`` for each strategy,
    elementwise also at unroll 8 and 16 and (``XCORR_WIDE``) 32 and 64,
    pointwise at 24 and 64, in f32, f64, bf16 and f16 (B6b: bit for bit),
    radii 0 to 1024, n = 2^20 + 123 (a ragged last tile of the default
    2048 outputs); then odd register tilings (``XCORR_ODD``, block_size
    1536) at r = 3 and 1024 on an aligned f and on one an element past
    16 bytes (element staging). Each launch's threads, shared bytes, grid,
    register width and passes are held to the kernel's own layout."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import xcorr1d as kx

    n, block = (1 << 20) + 123, 2048
    print(f"  -- B6 xcorr1d vs ref.xcorr1d, n = {n}, block_size {block}")
    for dtype in XCORR_DTYPES:
        for r in XCORR_RADII:
            f, g = xcorr_inputs(n, r, dtype, dev, seed=r)
            want = ref.xcorr1d(f, g)
            for strategy, unroll in (XCORR_STRATEGIES + XCORR_UNROLLS
                                     + XCORR_WIDE):
                label = f"xcorr1d {strategy} u{unroll} r={r} {dtype}"
                layout, route, grid = _xcorr_layout_check(
                    label, n, 2 * r + 1, block, strategy, unroll, dtype)
                got = kops.xcorr1d(f, g, strategy=strategy,
                                   block_size=block, unroll=unroll)
                check_xcorr(f"{label} {route} {layout[0]}thr {layout[1]}B "
                            f"grid {grid}", got, want, dtype)
            del f, g, want
    for key in ("ring_kernelIdLi16E", "tile_kernelIdLi2ELi16E"):
        print(f"  f64 at U = 64 (U_r = 16): {key} "
              f"{_usage_of('xcorr1d', key)}")
    block = 1536
    for dtype in XCORR_DTYPES:
        for r in (3, 1024):
            f, g = xcorr_inputs(n + 1, r, dtype, dev, seed=r + 1)
            for offset in (0, 1):
                fo = f[offset:offset + n + 2 * r]
                want = ref.xcorr1d(fo, g)
                for strategy, unroll in XCORR_ODD:
                    label = (f"xcorr1d {strategy} u{unroll} r={r} block "
                             f"{block} f+{offset}")
                    layout, route, grid = _xcorr_layout_check(
                        label, n, 2 * r + 1, block, strategy, unroll, dtype)
                    got = kops.xcorr1d(fo, g, strategy=strategy,
                                       block_size=block, unroll=unroll)
                    # the ring stages by 16 bytes where f allows it, and
                    # so does the one-tile launch in 2-byte types
                    wide = kx.wide_staging(fo, block) and (
                        not route.startswith("one-tile")
                        or fo.element_size() == 2)
                    staging = "16-byte" if wide else "element"
                    check_xcorr(f"{label} {dtype} {route}, {staging} "
                                "staging", got, want, dtype)
                del want
            del f, g


def counted(fn, kernel=None):
    """(fn(), host seconds, launches by depth), the launch counters set
    to 0 just before and read just after, the card synchronised at both
    ends. With ``kernel``, every launch must have gone to that kernel
    (the per-kernel count)."""
    import torch

    from repro_torch.kernels import emit

    torch.cuda.synchronize()
    emit.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_depth = dict(emit.fused_stencil_swc.launches_by_depth)
    by_kernel = dict(emit.fused_stencil_swc.launches_by_kernel)
    total = emit.fused_stencil_swc.launches
    if total != sum(by_depth.values()) or total != sum(by_kernel.values()):
        raise AssertionError("launch total and per-depth/kernel counts "
                             "disagree")
    if kernel is not None and by_kernel != {kernel: total}:
        raise AssertionError(f"launches by kernel {by_kernel}, want all "
                             f"{total} on {kernel}")
    return out, wall, by_depth


def phase_main_path(dev):
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem, simulate
    from repro_torch.physics.mhd import MHDSolver

    print("== phase 3: main path at full size")
    launches = {}
    n_steps = 3
    results = {}
    for kind, form, want in (
        ("mhd_substep", dict(fuse_rk_axpy=True), {1: 3 * n_steps}),
        ("mhd_rhs", {}, {1: 3 * n_steps}),
        ("mhd pair", dict(fuse_rk_pairs=True), {2: n_steps, 1: n_steps}),
    ):
        solver = MHDSolver((256,) * 3, strategy="swc", device=dev, **form)
        f0 = solver.init_fields(seed=0, dtype="float32")
        dt = float(solver.cfl_dt(f0))
        solver.step(f0, dt)  # warm-up: first launches load the modules

        def run():
            f = f0
            for _ in range(n_steps):
                f = solver.step(f, dt)
            return f

        f, wall, by_depth = counted(run)
        if by_depth != want:
            raise AssertionError(f"{kind}: launches {by_depth}, want {want}")
        if f.shape != (8, 256, 256, 256) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{kind}: bad MHD state")
        launches[kind] = by_depth.get(2, by_depth[1])
        STEP_MS[kind] = 1e3 * wall / n_steps
        results[kind] = f
        print(f"  MHD 256^3 f32 RK3 {form or 'plain'}: {n_steps} steps "
              f"dt={dt:.4e}, launches by depth {by_depth}, "
              f"{1e3 * wall / n_steps:.2f} ms/step (host clock)")
    solver = MHDSolver((256,) * 3, strategy="swc_stream", device=dev)
    f0 = solver.init_fields(seed=0, dtype="float32")
    dt = float(solver.cfl_dt(f0))
    solver.step(f0, dt)

    def run_stream():
        f = f0
        for _ in range(n_steps):
            f = solver.step(f, dt)
        return f

    f, wall, by_depth = counted(run_stream, kernel=STREAM)
    if by_depth != {1: 3 * n_steps}:
        raise AssertionError(f"mhd stream: launches {by_depth}")
    if f.shape != (8, 256, 256, 256) or not bool(torch.isfinite(f).all()):
        raise AssertionError("mhd stream: bad MHD state")
    launches["stream mhd_rhs"] = by_depth[1]
    STEP_MS["stream mhd_rhs"] = 1e3 * wall / n_steps
    results["mhd_rhs stream"] = f
    print(f"  MHD 256^3 f32 RK3 plain on swc_stream: {n_steps} steps, "
          f"{by_depth[1]} stream launches, {1e3 * wall / n_steps:.2f} "
          "ms/step (host clock)")
    for kind in ("mhd_rhs", "mhd pair", "mhd_rhs stream"):
        _, rel = rel_err(results[kind], results["mhd_substep"])
        print(f"  {kind} vs fused-axpy RK3 after {n_steps} steps: "
              f"rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"{kind}: the RK3 forms disagree")
    del results, f
    for form in ("fuse_rk_axpy", "fuse_rk_pairs"):
        solver = MHDSolver((64,) * 3, strategy="swc_stream", device=dev,
                           **{form: True})
        try:
            solver.step(solver.init_fields(dtype="float32"), 1e-3)
        except ValueError as err:
            print(f"  MHD swc_stream with {form}: ValueError ({err})")
        else:
            raise AssertionError(f"swc_stream with {form} did not raise")

    prob = DiffusionProblem((512,) * 3)
    f0 = prob.init_field(seed=0, device=dev)
    out, wall, by_depth = counted(
        lambda: simulate(prob, f0, 5, strategy="swc", device=dev))
    if by_depth != {1: 5}:
        raise AssertionError(f"diffusion: launches {by_depth}")
    launches["select"] = by_depth[1]
    if out.shape != f0.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("diffusion: bad state")
    print(f"  diffusion 512^3 f32: 5 steps, launches by depth {by_depth}, "
          f"{1e3 * wall / 5:.2f} ms/step (host clock)")
    base = {5: out}
    base.update({n: simulate(prob, f0, n, strategy="swc", device=dev)
                 for n in (6, 7)})
    del out
    for strategy, depth, n, want in (
        ("swc", 2, 6, {2: 3}), ("swc", 3, 6, {3: 2}),
        ("swc", 3, 7, {3: 2, 1: 1}),
        ("swc_stream", 1, 5, {1: 5}), ("swc_stream", 2, 6, {2: 3}),
        ("swc_stream", 3, 6, {3: 2}), ("swc_stream", 3, 7, {3: 2, 1: 1}),
    ):
        stream = strategy == "swc_stream"
        out, wall, by_depth = counted(
            lambda: simulate(prob, f0, n, strategy=strategy,
                             fuse_steps=depth, device=dev),
            kernel=STREAM if stream else None)
        if by_depth != want:
            raise AssertionError(
                f"diffusion {strategy} fuse_steps={depth}, {n} steps: "
                f"launches {by_depth}, want {want}")
        if n != 7:
            key = "stream select" if stream else "select"
            launches[f"{key} S={depth}"] = by_depth[depth]
            STEP_MS[f"{key} S={depth}"] = 1e3 * wall / n
        _, rel = rel_err(out, base[n])
        print(f"  diffusion 512^3 f32 {strategy} fuse_steps={depth}: {n} "
              f"steps, launches by depth {by_depth}, "
              f"{1e3 * wall / n:.2f} ms/step (host clock); vs swc depth 1 "
              f"rel {rel:.3e}")
        if rel > 1e-5 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{strategy} diffusion at depth {depth} "
                                 "disagrees with swc depth 1")
    del base, out, f0

    prob = DiffusionProblem((8192, 8192))
    f0 = prob.init_field(seed=0, device=dev)
    want = simulate(prob, f0, 5, strategy="swc", device=dev)
    out, wall, by_depth = counted(
        lambda: simulate(prob, f0, 5, strategy="swc_stream", device=dev),
        kernel=STREAM)
    if by_depth != {1: 5}:
        raise AssertionError(f"diffusion 8192^2 stream: launches {by_depth}")
    launches["stream select 8192^2"] = by_depth[1]
    STEP_MS["stream select 8192^2"] = 1e3 * wall / 5
    _, rel = rel_err(out, want)
    print(f"  diffusion 8192^2 f32 swc_stream (y-stream): 5 steps, "
          f"launches by depth {by_depth}, {1e3 * wall / 5:.2f} ms/step "
          f"(host clock); vs swc rel {rel:.3e}")
    if rel > 1e-5 or not bool(torch.isfinite(out).all()):
        raise AssertionError("y-stream diffusion disagrees with swc")
    del want, out, f0

    prob = DiffusionProblem((64, 64, 64), safety=0.05)
    k, n = (1, 1, 2), 60
    f0 = prob.fourier_mode(k, device=dev)
    out = simulate(prob, f0, n, strategy="swc", device=dev)
    decay = float(out.norm() / f0.norm())
    spec = prob.merged_stencil()
    lam = sum(
        c * math.cos(
            sum(ki * oi * hi for ki, oi, hi in zip(k, o, prob.spacing)))
        for o, c in zip(spec.offsets, spec.coeffs)
    )
    ana = prob.analytic_decay(k, n * prob.dt)
    print(f"  Fourier mode f64 64^3: decay {decay:.12f}, exact discrete "
          f"{lam ** n:.12f}, analytic {ana:.12f}")
    if abs(decay - lam ** n) > 1e-10 or abs(decay - ana) / ana > 2e-3:
        raise AssertionError("Fourier-mode decay off")
    return launches


def phase_main_path_tc(dev, launches):
    """The tensor-core regime (``strategy="tc"``) and bf16 through the
    entry points: MHD in three RK3 forms, diffusion at depth 1 and 2, in
    bf16 (and bf16 on ``swc``: B1b), and at ranks 2 and 1, each held to
    its ``swc`` counterpart."""
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem, simulate
    from repro_torch.physics.mhd import MHDSolver

    print("== phase 3 (tc): the tensor-core regime and bf16 on the main path")
    n_steps = 3
    for kind, n, form, want in (
        ("tc mhd_substep", 256, dict(fuse_rk_axpy=True), {1: 3 * n_steps}),
        ("tc mhd_rhs", 256, {}, {1: 3 * n_steps}),
        ("tc mhd pair", 256, dict(fuse_rk_pairs=True),
         {2: n_steps, 1: n_steps}),
    ):
        solver = MHDSolver((n,) * 3, strategy="tc", device=dev, **form)
        swc = MHDSolver((n,) * 3, strategy="swc", device=dev, **form)
        f0 = solver.init_fields(seed=0, dtype="float32")
        dt = float(solver.cfl_dt(f0))
        solver.step(f0, dt)  # warm-up

        def run(solver=solver):
            f = f0
            for _ in range(n_steps):
                f = solver.step(f, dt)
            return f

        f, wall, by_depth = counted(run, kernel=TC)
        if by_depth != want:
            raise AssertionError(f"{kind}: launches {by_depth}, want {want}")
        if f.shape != (8, n, n, n) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{kind}: bad MHD state")
        _, rel = rel_err(f, run(swc))
        launches[kind] = by_depth.get(2, by_depth[1])
        STEP_MS[kind] = 1e3 * wall / n_steps
        print(f"  MHD {n}^3 f32 RK3 on tc {form or 'plain'}: {n_steps} steps, "
              f"launches by depth {by_depth} (all {TC}), "
              f"{1e3 * wall / n_steps:.2f} ms/step (host clock); vs swc "
              f"rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"{kind}: tc and swc disagree")
        del f, solver, swc
        torch.cuda.empty_cache()

    for shape, cases in (
        ((512,) * 3, (("tc", 1, 5, "float32", "tc select S=1"),
                      ("tc", 2, 6, "float32", "tc select S=2"),
                      ("tc", 3, 6, "float32", "tc select S=3"),
                      ("tc", 1, 5, "bfloat16", "tc select bf16"),
                      ("tc", 2, 6, "bfloat16", "tc select bf16 S=2"),
                      ("swc", 1, 5, "bfloat16", "select bf16"))),
        ((8192, 8192), (("tc", 1, 5, "float32", "tc select 8192^2"),)),
        ((1 << 26,), (("tc", 1, 5, "float32", "tc select 2^26"),)),
    ):
        prob = DiffusionProblem(shape)
        f0 = prob.init_field(seed=0, device=dev)
        base = {}
        for n in sorted({c[2] for c in cases}):
            # The swc run each case is held to: B1 on the main path too,
            # one fused_stencil launch per step.
            base[n], wall, by_depth = counted(
                lambda: simulate(prob, f0, n, strategy="swc", device=dev),
                kernel="fused_stencil")
            if by_depth != {1: n} or not bool(torch.isfinite(base[n]).all()):
                raise AssertionError(f"diffusion {shape} swc: launches "
                                     f"{by_depth}, want {n}, or bad state")
            if len(shape) < 3:
                key = f"select {'8192^2' if len(shape) == 2 else '2^26'}"
                launches[key] = by_depth[1]
                print(f"  diffusion {'x'.join(map(str, shape))} float32 swc: "
                      f"{n} steps, launches by depth {by_depth} (all "
                      f"fused_stencil), {1e3 * wall / n:.2f} ms/step (host "
                      "clock)")
        for strategy, depth, n, dtype, key in cases:
            kernel = TC if strategy == "tc" else "fused_stencil"
            fd = f0.to(getattr(torch, dtype))
            out, wall, by_depth = counted(
                lambda: simulate(prob, fd, n, strategy=strategy,
                                 fuse_steps=depth, device=dev),
                kernel=kernel)
            if by_depth != {depth: n // depth}:
                raise AssertionError(f"diffusion {shape} {strategy} {dtype} "
                                     f"S={depth}: launches {by_depth}")
            if out.dtype != fd.dtype or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"diffusion {shape} {key}: bad state")
            launches[key] = by_depth[depth]
            _, rel = rel_err(out, base[n])
            # bf16 on swc rounds every tap in bf16 (the reference's VPU
            # path), so its n steps are held to the plain bf16 version;
            # tc accumulates in f32 and is held to f32, as the
            # reference's tests/test_tc.py holds it.
            versus = ("swc f32 depth 1", rel)
            if strategy == "swc":
                plain_out = simulate(prob, fd, n, strategy="hwc", device=dev)
                versus = ("the plain bf16 version", rel_err(out, plain_out)[1])
                del plain_out
            print(f"  diffusion {'x'.join(map(str, shape))} {dtype} "
                  f"{strategy} fuse_steps={depth}: {n} steps, launches by "
                  f"depth {by_depth} (all {kernel}), {1e3 * wall / n:.2f} "
                  f"ms/step (host clock); vs swc f32 depth 1 rel {rel:.3e}"
                  + (f", vs {versus[0]} rel {versus[1]:.3e}"
                     if strategy == "swc" else ""))
            if versus[1] > TOL[dtype]:
                raise AssertionError(f"diffusion {key} disagrees with "
                                     f"{versus[0]}")
            del out, fd
        del base, f0
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_kernels():
    """The fused-stencil wrapper that the entry points call replaced by
    its plain version (:func:`plain`, ``ref.fused_stencil[_steps]``,
    launched nowhere): what a solver's step computes without the kernels,
    on the card, as the oracle of the bf16 phase."""
    from repro_torch.kernels import ops as kops

    real = kops.fused_stencil_swc

    def plain_swc(f_padded, ops, phi, plan, *, aux=None, taps=None,
                  out=None):
        res = plain((f_padded, ops, phi, plan, aux))
        return res if out is None else out.copy_(res)

    kops.fused_stencil_swc = plain_swc
    try:
        yield
    finally:
        kops.fused_stencil_swc = real


def phase_main_path_bf16(dev, launches):
    """bf16 through the entry points (B2c, B3c, B4b): ``MHDSolver`` at
    256^3 in every RK3 form it takes (plain on swc, swc_stream and tc; the
    fused axpy and fuse_rk_pairs on swc and tc), diffusion 512^3 at depth
    2 and 3 on swc and 1-3 on swc_stream, 8192^2 on swc_stream and 2^26
    at depth 2 on swc's one-tile body. Each prints ms a step (host clock)
    and launches by kernel beside the f32 row of the same case, and is
    held to the plain bf16 version: an MHD step after one step (equal
    bit for bit on swc and swc_stream, within 2e-2 on tc, whose plain
    version sums the contractions in another f32 order), diffusion after
    its run (equal bit for bit)."""
    import torch

    from repro_torch.kernels import emit
    from repro_torch.physics.diffusion import DiffusionProblem, simulate
    from repro_torch.physics.mhd import MHDSolver

    print("== phase 3 (bf16): bf16 MHD RK3 and diffusion on the main path "
          "(B2c, B3c, B4b)")
    bf = torch.bfloat16
    n_steps = 3
    f0 = MHDSolver((256,) * 3, device=dev).init_fields(seed=0, dtype=bf)
    for strategy, form, key, kernel, want in (
        ("swc", {}, "mhd_rhs", "fused_stencil", {1: 3 * n_steps}),
        ("swc", dict(fuse_rk_axpy=True), "mhd_substep", "fused_stencil",
         {1: 3 * n_steps}),
        ("swc", dict(fuse_rk_pairs=True), "mhd pair", None,
         {2: n_steps, 1: n_steps}),
        ("swc_stream", {}, "stream mhd_rhs", STREAM, {1: 3 * n_steps}),
        ("tc", {}, "tc mhd_rhs", TC, {1: 3 * n_steps}),
        ("tc", dict(fuse_rk_axpy=True), "tc mhd_substep", TC,
         {1: 3 * n_steps}),
        ("tc", dict(fuse_rk_pairs=True), "tc mhd pair", TC,
         {2: n_steps, 1: n_steps}),
    ):
        solver = MHDSolver((256,) * 3, strategy=strategy, device=dev, **form)
        dt = float(solver.cfl_dt(f0))
        one = solver.step(f0, dt)  # warm-up, and the step held to plain
        with plain_kernels():
            want_one = solver.step(f0, dt)
        _, rel1 = rel_err(one, want_one)
        exact = strategy != "tc"
        if exact and not torch.equal(one, want_one):
            raise AssertionError(f"bf16 {key} on {strategy}: the step "
                                 "differs from its plain version")
        del one, want_one

        def run(solver=solver):
            f = f0
            for _ in range(n_steps):
                f = solver.step(f, dt)
            return f

        f, wall, by_depth = counted(run, kernel=kernel)
        by_kernel = dict(emit.fused_stencil_swc.launches_by_kernel)
        if by_depth != want:
            raise AssertionError(f"bf16 {key}: launches {by_depth}, want "
                                 f"{want}")
        if f.dtype != bf or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"bf16 {key}: bad MHD state")
        launches[f"{key} bf16"] = by_depth.get(2, by_depth[1])
        ms = 1e3 * wall / n_steps
        print(f"  MHD 256^3 bf16 RK3 on {strategy} {form or 'plain'}: "
              f"{n_steps} steps, launches by depth {by_depth}, by kernel "
              f"{by_kernel}, {ms:.2f} ms/step (host clock; f32 "
              f"{STEP_MS.get(key, float('nan')):.2f}); one step vs the "
              "plain bf16 version " + ("equal bit for bit" if exact else
                                        f"rel {rel1:.3e} (limit "
                                        f"{TOL['bfloat16']})"))
        if rel1 > TOL["bfloat16"]:
            raise AssertionError(f"bf16 {key}: the step disagrees with its "
                                 "plain version")
        del f, solver
        torch.cuda.empty_cache()
    del f0

    for shape, cases in (
        ((512,) * 3, (("swc", 2, 6, "select S=2"), ("swc", 3, 6, "select S=3"),
                      ("swc_stream", 1, 5, "stream select S=1"),
                      ("swc_stream", 2, 6, "stream select S=2"),
                      ("swc_stream", 3, 6, "stream select S=3"))),
        ((8192, 8192), (("swc_stream", 1, 5, "stream select 8192^2"),)),
        ((1 << 26,), (("swc", 2, 6, "select 2^26 S=2"),)),
    ):
        prob = DiffusionProblem(shape)
        f0 = prob.init_field(seed=0, device=dev).to(bf)
        for strategy, depth, n, key in cases:
            stream = strategy == "swc_stream"
            kernel = STREAM if stream else TEMPORAL if depth > 1 else None
            out, wall, by_depth = counted(
                lambda: simulate(prob, f0, n, strategy=strategy,
                                 fuse_steps=depth, device=dev),
                kernel=kernel)
            if by_depth != {depth: n // depth}:
                raise AssertionError(f"bf16 diffusion {shape} {key}: "
                                     f"launches {by_depth}")
            if out.dtype != bf or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"bf16 diffusion {shape} {key}: bad "
                                     "state")
            launches[f"{key} bf16"] = by_depth[depth]
            want = simulate(prob, f0, n, strategy="hwc", device=dev)
            same = bool(torch.equal(out, want))
            _, rel = rel_err(out, want)
            ms = 1e3 * wall / n
            f32 = STEP_MS.get(key)
            print(f"  diffusion {'x'.join(map(str, shape))} bf16 {strategy} "
                  f"fuse_steps={depth}: {n} steps, launches by depth "
                  f"{by_depth} (all {kernel}), {ms:.2f} ms/step (host clock; "
                  + ("no f32 row" if f32 is None else f"f32 {f32:.2f}")
                  + "); vs the plain bf16 version "
                  + ("equal bit for bit" if same else f"rel {rel:.3e}"))
            if not same:
                raise AssertionError(f"bf16 diffusion {key} differs from "
                                     "the plain bf16 version")
            del out, want
        del f0
        torch.cuda.empty_cache()


def phase_main_path_1d(dev, launches):
    """The 1-D path: ``step_1d_xcorr`` at 2^26 in f32, bf16 and f16, 5
    steps on each B6 strategy, every step one ``xcorr1d`` launch (the
    counters zeroed just before and read just after), held to B1's
    ``simulate(..., "swc")`` (bf16: B1b) within the dtype's limit and, in
    the 2-byte types, to the plain ``hwc`` steps bit for bit (f16 has no
    B1 until ROADMAP B9); then B7b's path (:func:`b7b_path`)."""
    print("== phase 3 (1-D): step_1d_xcorr at 2^26 on B6 (csrc/xcorr1d.cu)")
    for dtype in ("float32", "bfloat16", "float16"):
        _xcorr_steps(dev, launches, dtype)
    b7b_path(dev, launches)


def _xcorr_steps(dev, launches, dtype):
    import torch

    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx
    from repro_torch.physics.diffusion import (
        DiffusionProblem,
        simulate,
        step_1d_xcorr,
    )

    n_steps = 5
    prob = DiffusionProblem((1 << 26,), accuracy=6)
    f0 = prob.init_field(seed=0, device=dev, dtype=dtype)[0]
    want = plain = None
    if dtype != "float16":  # B1 (f32) and B1b (bf16) at rank 1
        want = simulate(prob, f0[None], n_steps, strategy="swc",
                        device=dev)[0]
    if dtype != "float32":
        plain = f0
        for _ in range(n_steps):
            plain = step_1d_xcorr(plain, prob, strategy="hwc")
    for strategy, _ in XCORR_STRATEGIES:
        step_1d_xcorr(f0, prob, strategy=strategy)  # warm-up

        def run(strategy=strategy):
            f = f0
            for _ in range(n_steps):
                f = step_1d_xcorr(f, prob, strategy=strategy)
            return f

        torch.cuda.synchronize()
        kx.reset_launch_counts()
        emit.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by = dict(kx.xcorr1d_cuda.launches_by_strategy)
        if by != {strategy: n_steps} or kx.xcorr1d_cuda.launches != n_steps \
                or emit.fused_stencil_swc.launches:
            raise AssertionError(
                f"step_1d_xcorr {strategy} {dtype}: launches {by}, "
                f"{emit.fused_stencil_swc.launches} fused-stencil launches; "
                f"want {n_steps} xcorr1d")
        if out.shape != f0.shape or out.dtype != f0.dtype or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"step_1d_xcorr {strategy}: bad state")
        key = "xcorr" if dtype == "float32" else f"xcorr {dtype}"
        launches[f"{key} {strategy}"] = by[strategy]
        held = []
        if want is not None:
            _, rel = rel_err(out, want)
            held.append(f"vs swc ({'B1' if dtype == 'float32' else 'B1b'}) "
                        f"rel {rel:.3e}")
            if rel > TOL[dtype]:
                raise AssertionError(f"step_1d_xcorr {strategy} {dtype} "
                                     "disagrees with swc")
        if plain is not None:
            if not torch.equal(out, plain):
                raise AssertionError(f"step_1d_xcorr {strategy} {dtype}: "
                                     "not the plain hwc steps bit for bit")
            held.append("= the hwc steps (bit for bit)")
        print(f"  diffusion 2^26 {dtype} order 6 step_1d_xcorr {strategy}: "
              f"{n_steps} steps, launches {by}, "
              f"{1e3 * wall / n_steps:.4f} ms/step (host clock); "
              + "; ".join(held))
        del out
    del want, plain, f0
    torch.cuda.empty_cache()


def b7b_path(dev, launches):
    """B7b's path: ``ops.conv1d_depthwise`` under autograd (its
    ``Conv1dDepthwise``: the kernel forward, the plain version's gradient)
    on mamba2-780m's prefill view (4, 8192, 3328) of the (4, 8192, 6448)
    projection at offset 3072, in f16 and f64 at k = 4 and in bf16 at k =
    16 and 33 (the body with k at run time); the counters zeroed just
    before and read just after each call (one launch, no other kernel);
    the output held to the plain version (f16 and bf16 bit for bit, f64
    within 1e-12) and the gradients to the plain version's."""
    import torch

    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    print("== phase 3 (1-D): B7b, ops.conv1d_depthwise under autograd at "
          "the prefill view")
    b, s = PREFILL_SHAPE
    for dtype, k in (("float16", 4), ("float64", 4), ("bfloat16", 16),
                     ("bfloat16", 33)):
        gen = torch.Generator(device=dev).manual_seed(k)
        dt = getattr(torch, dtype)
        base = torch.randn((b, s, 6448), generator=gen, device=dev).to(dt)
        base.requires_grad_(True)
        x = base[..., 3072:3072 + 3328]
        w = torch.randn((k, 3328), generator=gen, device=dev).to(dt)
        w.requires_grad_(True)
        torch.cuda.synchronize()
        _reset_all_counts()
        t0 = time.perf_counter()
        y = kops.conv1d_depthwise(x, w, activation="silu")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts()
        if counts != (1, 0, 0) or \
                type(y.grad_fn).__name__ != "Conv1dDepthwiseBackward":
            raise AssertionError(f"B7b {dtype} k={k}: launches (B7, fused, "
                                 f"xcorr) {counts}, want (1, 0, 0) under "
                                 "Conv1dDepthwise")
        launches[f"conv1d {dtype} k={k}"] = counts[0]
        want = ref.conv1d_depthwise(x, w, "silu")
        label = (f"B7b {dtype} k={k} silu view (4, 8192, 3328) vec"
                 f"{kc.vector_width(x, w)}")
        if dtype == "float64":
            check(label, y.detach(), want.detach(), dtype)
        else:
            check_equal(label, y.detach(), want.detach())
        gy = torch.randn_like(y)
        got_g = torch.autograd.grad(y, (base, w), gy)
        want_g = torch.autograd.grad(want, (base, w), gy)
        if not all(torch.equal(a, c) for a, c in zip(got_g, want_g)):
            raise AssertionError(f"{label}: gradients differ from the "
                                 "plain version's")
        print(f"    one launch, {1e3 * wall:.4f} ms forward (host clock); "
              "gradients equal to the plain version's")
        del base, x, w, y, want, got_g, want_g
    torch.cuda.empty_cache()


def _reset_all_counts():
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    emit.reset_launch_counts()
    kx.reset_launch_counts()
    kc.reset_launch_counts()


def _all_counts() -> tuple[int, int, int]:
    """(B7, fused-stencil, xcorr1d) launches since the last reset."""
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    return (kc.conv1d_depthwise_cuda.launches,
            emit.fused_stencil_swc.launches, kx.xcorr1d_cuda.launches)


def phase_main_path_ssm(dev, smi, launches):
    """mamba2-780m at full width (48 layers, d_model 1536, state 128,
    vocab 50280), random init from a seeded generator on the card,
    through ``repro_torch.launch.steps`` and ``launch.serve``: the
    prefill (4, 8192) in bf16 with 48 B7 launches (counters zeroed just
    before, read just after) held to the same prefill with the plain conv;
    forward (with B7) against step-by-step decode in f32 on (2, 512); the
    serve loop at batch 4, 32 steps."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm

    print("== phase 3 (mamba2): mamba2-780m prefill and decode on B7 "
          "(csrc/conv1d_depthwise.cu)")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    cfg = get_config("mamba2-780m")
    params = ssm.init_params(cfg, seed=0, device=dev)
    n_par = sum(v.numel() for t in (params, params["blocks"])
                for v in t.values() if torch.is_tensor(v))
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"conv channels {cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state}"
          f", {n_par} parameters (config: {cfg.n_params():.0f}), {cfg.dtype}")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = PREFILL_SHAPE
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    plain_prefill = make_prefill_step(cfg, device=dev, use_pallas_conv=False)
    batch = {"tokens": tokens}
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_all_counts()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        conv_n, stencil_n, xcorr_n = _all_counts()
        if (conv_n, stencil_n, xcorr_n) != (cfg.n_layers, 0, 0):
            raise AssertionError(
                f"prefill: {conv_n} B7, {stencil_n} fused-stencil and "
                f"{xcorr_n} xcorr1d launches; want {cfg.n_layers}, 0, 0")
        launches["conv1d prefill"] = conv_n
        if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"prefill: bad logits {tuple(out.shape)}")
        _reset_all_counts()
        want = plain_prefill(params, batch)
        if _all_counts() != (0, 0, 0):
            raise AssertionError("the plain-conv prefill launched a kernel")
        err, rel = rel_err(out, want)
        print(f"  prefill {PREFILL_SHAPE} {cfg.dtype}: launches B7 {conv_n}, "
              f"fused-stencil {stencil_n}, xcorr1d {xcorr_n}; last logits vs "
              f"use_pallas_conv=False max|err| {err:.3e} rel {rel:.3e} "
              f"(tol {TOL['bfloat16']:.0e}) "
              f"{'ok' if rel <= TOL['bfloat16'] else 'FAIL'}")
        if rel > TOL["bfloat16"]:
            raise AssertionError(f"prefill: rel err {rel:.3e} vs plain conv")
        del out, want
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        prefill_ms = statistics.median(times)
        print(f"  prefill {PREFILL_SHAPE} {cfg.dtype}: {prefill_ms:.1f} ms "
              f"(host clock, median of {len(times)} after the "
              f"warm-up; {b * s / prefill_ms * 1e3:.0f} tokens/s) on {smi}")
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tokens, batch

        # Decode consistency (tests/test_system.py:67) at full width, f32.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b2, s2 = DECODE_SHAPE
        toks = torch.randint(0, cfg.vocab, (b2, s2), generator=gen,
                             device=dev)
        _reset_all_counts()
        full, _ = ssm.forward(params, cfg32, toks)
        torch.cuda.synchronize()
        counts = _all_counts()
        if counts != (cfg.n_layers, 0, 0):
            raise AssertionError(f"f32 forward: launches {counts}")
        launches["conv1d f32 forward"] = counts[0]
        step = make_serve_step(cfg32, device=dev)
        cache = ssm.init_decode_cache(cfg32, b2, s2, device=dev)
        errs = torch.empty(s2, device=dev)
        for t in range(s2):
            lg, cache = step(params, cache, {"tokens": toks[:, t:t + 1]})
            errs[t] = (lg - full[:, t]).abs().max()
        worst = float(errs.max())
        rel = worst / float(full.abs().max())
        print(f"  decode vs forward (B7) {DECODE_SHAPE} f32, {s2} steps from "
              f"an empty cache: max|err| {worst:.3e} (tol {DECODE_TOL:.1e}; "
              f"rel {rel:.3e}; worst step {int(errs.argmax())}) "
              f"{'ok' if worst <= DECODE_TOL else 'FAIL'}")
        if not worst <= DECODE_TOL:
            raise AssertionError(f"decode vs forward: max|err| {worst:.3e}")
        del full, cache, toks, errs

    # The serve loop of launch/serve.py, after a two-step warm-up.
    serve(cfg, batch=LM_BATCH, steps=2, device=dev, params=params)
    gen_tokens, secs = serve(cfg, batch=LM_BATCH, steps=LM_STEPS,
                             device=dev, params=params)
    if gen_tokens.shape != (LM_BATCH, LM_STEPS + 1) or \
            int(gen_tokens.min()) < 0 or int(gen_tokens.max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {tuple(gen_tokens.shape)}")
    print(f"  serve batch {LM_BATCH}, {LM_STEPS} steps {cfg.dtype}: "
          f"{LM_BATCH * LM_STEPS / secs:.1f} tokens/s, "
          f"{1e3 * secs / LM_STEPS:.2f} ms per decode step (host clock) "
          f"on {smi}")
    print("  first row: " + " ".join(map(str, gen_tokens[0, :12].tolist())))
    del params
    torch.cuda.empty_cache()


# mamba2-780m's training at full width: train_4k's sequence (registry
# SHAPES["train_4k"] is (256, 4096)) at a global batch cut from 256 to 2
# to fit one card; AdamW steps on the B7 path after the parity step.
TRAIN_SHAPE = (2, 4096)
TRAIN_STEPS = 4
# The reduced train CLI on the card: checkpoints at steps 3 and 6, an
# injected failure at step 5, so it restarts once from step 3.
TRAIN_CLI = ["--reduced", "--steps", "8", "--global-batch", "2",
             "--seq-len", "64", "--ckpt-every", "3",
             "--simulate-failure-at", "5", "--log-every", "1"]


def _rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def train_conv_parity(dev, b, s, c, row, offset):
    """B7 under autograd (``Conv1dDepthwise``) against the plain
    version's autograd at the training xBC view: the (b, s, c) columns
    at ``offset`` of a (b, s, row) leaf that requires a gradient, bf16
    and f32: the output and the gradients of the leaf and of the taps,
    each within TOL and printed with "=" when equal bit for bit."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device=dev).manual_seed(21)
        dt = getattr(torch, dtype)
        base = torch.randn((b, s, row), generator=gen, device=dev).to(dt)
        w = torch.randn((4, c), generator=gen, device=dev).to(dt)
        gy = torch.randn((b, s, c), generator=gen, device=dev).to(dt)
        base.requires_grad_()
        w.requires_grad_()
        _reset_all_counts()
        y = kops.conv1d_depthwise(base[..., offset:offset + c], w)
        if type(y.grad_fn).__name__ != "Conv1dDepthwiseBackward":
            raise AssertionError(f"B7 under autograd: grad_fn {y.grad_fn}")
        got = (y.detach(), *torch.autograd.grad(y, (base, w), gy))
        torch.cuda.synchronize()
        if _all_counts() != (1, 0, 0):
            raise AssertionError(f"B7 under autograd: launches "
                                 f"{_all_counts()}, want (1, 0, 0)")
        plain = ref.conv1d_depthwise(base[..., offset:offset + c], w)
        want = (plain.detach(), *torch.autograd.grad(plain, (base, w), gy))
        parts = []
        for name, g, wv in zip(("y", "d/dx", "d/dw"), got, want):
            err, rel = rel_err(g, wv)
            if not rel <= TOL[dtype]:
                raise AssertionError(f"B7 autograd {dtype} {name}: rel "
                                     f"{rel:.3e}")
            parts.append(f"{name} {'=' if torch.equal(g, wv) else ''}"
                         f"{err:.3e}")
        print(f"  B7 autograd vs plain autograd, xBC view {b}x{s}x{c} of "
              f"{row} {dtype}: " + ", ".join(parts)
              + f" (max|err|, tol {TOL[dtype]:.0e} relative; 1 launch, "
              "the backward the plain version's gradient)")
        del base, w, gy, got, want, y, plain


def train_step_parity(cfg, params, batch, dev):
    """One gradient step (``make_grad_step``) on the B7 path against one
    on the plain conv from the same parameters and batch: B7 launched
    twice a layer (the forward and remat's recompute), nothing on the
    plain path; the loss and each gradient leaf (relative L2) within
    the bf16 limit."""
    import torch

    from repro_torch.launch.steps import make_grad_step
    from repro_torch.tree import tree_leaves_with_path

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    loss_k, _, grads_k = make_grad_step(cfg, device=dev)(params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _all_counts()
    want = (2 * cfg.n_layers, 0, 0)
    if counts != want:
        raise AssertionError(f"train step: launches {counts}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    _reset_all_counts()
    loss_p, _, grads_p = make_grad_step(cfg, device=dev,
                                        use_pallas_conv=False)(params, batch)
    torch.cuda.synchronize()
    if _all_counts() != (0, 0, 0):
        raise AssertionError("the plain-conv train step launched a kernel")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst, equal, rows = 0.0, 0, []
    for (path, gk), (_, gp) in zip(tree_leaves_with_path(grads_k),
                                   tree_leaves_with_path(grads_p)):
        if not bool(torch.isfinite(gk).all()):
            raise AssertionError(f"train step: non-finite grad {path}")
        rel = _rel_l2(gk, gp)
        equal += bool(torch.equal(gk, gp))
        rows.append((rel, "/".join(path)))
        worst = max(worst, rel)
    rows.sort(reverse=True)
    ok = loss_rel <= TOL["bfloat16"] and worst <= TOL["bfloat16"]
    print(f"  step 0 grad (B7, {secs * 1e3:.1f} ms, peak "
          f"{peak / 2**30:.2f} GiB) vs use_pallas_conv=False: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel "
          f"{loss_rel:.3e}); gradients rel L2 worst {worst:.3e} "
          f"({rows[0][1]}), {equal} of {len(rows)} leaves bit-equal (tol "
          f"{TOL['bfloat16']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train step vs plain conv: loss rel "
                             f"{loss_rel:.3e}, grads {rows[:3]}")
    return counts[0]


def train_cli_cmd(tmp) -> list[str]:
    """``python -m repro_torch.launch.train`` with ``TRAIN_CLI``, its
    checkpoints under ``tmp``."""
    return _cli("train", *TRAIN_CLI, "--ckpt-dir", f"{tmp}/train-one")


def train_cli_check(out, tmp) -> list[list[str]]:
    """Phase 3 (train)'s CLI run (``train_cli_cmd``): rc 0, one restart
    from step 3, a finite final loss, B7 launched. Returns its logged
    step lines."""
    _cli_ok("train CLI", out)
    steps = sorted(os.listdir(f"{tmp}/train-one"))
    done = next(x for x in out.stdout.splitlines() if x.startswith("done:"))
    final = float(done.split("final loss")[1].split()[0])
    launches = int(done.split("launches=")[1].split()[0])
    if ("restarts=1" not in done or "device=cuda" not in done
            or not math.isfinite(final) or launches <= 0
            or "restored at step 3" not in out.stderr):
        raise AssertionError(f"train CLI: {done!r} / {out.stderr[-500:]}")
    print(f"  python -m repro_torch.launch.train {' '.join(TRAIN_CLI)}: "
          f"rc 0 in {out.seconds:.1f} s, restored at step 3, checkpoints "
          f"{steps}")
    print(f"    {done}")
    return _logged(out.stdout)


def train_cli_on_card():
    """The reduced train CLI on the card alone (``train_cli_cmd``), its
    checkpoints in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = run_at_once({"train": train_cli_cmd(tmp)}, Path(tmp) / "logs")
        train_cli_check(out["train"], tmp)


def phase_train(dev, smi, launches, cli=True):
    """mamba2-780m's train step at full width (48 layers, d_model 1536,
    state 128, vocab 50280, chunk 256; bf16 compute on f32 master
    parameters, selective remat), random init from a seeded generator
    on the card, on ``MarkovLMDataset`` batches at ``TRAIN_SHAPE``: B7
    under autograd against the plain version at the training view; one
    gradient step on B7 against one on the plain conv; then
    ``TRAIN_STEPS`` AdamW steps through ``make_train_step`` with the
    launch counters zeroed just before and read just after (96 B7
    launches a step); the reduced train CLI on the card with a restart
    (with ``cli``; else phase 3 (clis) runs it). Returns the B7 row at
    the training view (the kernels line's)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init

    print("== phase 3 (train): mamba2-780m's train step at full width, B7 "
          "(csrc/conv1d_depthwise.cu) under autograd")
    print(f"  card: {smi}")
    cfg = get_config("mamba2-780m")
    if cfg.remat != "selective" or cfg.dtype != "bfloat16":
        raise AssertionError(f"config remat {cfg.remat}, dtype {cfg.dtype}")
    b, s = TRAIN_SHAPE
    dv, h, _, g, n, c = ssm._dims(cfg)
    row = 2 * dv + 2 * g * n + h  # the in-projection: z, xBC, dt
    train_conv_parity(dev, b, s, c, row, dv)

    params = ssm.init_params(cfg, seed=0, device=dev)
    n_par = sum(v.numel() for t in (params, params["blocks"])
                for v in t.values() if torch.is_tensor(v))
    dataset = MarkovLMDataset(cfg.vocab, s, branching=4)
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_par} parameters (f32 master), {cfg.dtype} compute, remat "
          f"{cfg.remat}; MarkovLMDataset batch {b} x seq {s} (train_4k's "
          f"seq; its batch 256 cut to {b})")
    it = BatchIterator(dataset, b, start_step=0)
    batches = [it.next_global(dev) for _ in range(TRAIN_STEPS)]
    train_step_parity(cfg, params, batches[0], dev)

    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg, device=dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    step_ms = []
    for i, batch in enumerate(batches):
        before = _all_counts()[0]
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        per = _all_counts()[0] - before
        step_ms.append(ms)
        print(f"  step {i}: loss {loss:.4f}  grad_norm {gnorm:.4f}  lr "
              f"{lr:.3e}  {ms:.1f} ms  {b * s / ms * 1e3:.0f} tokens/s  B7 "
              f"launches {per}  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: loss {loss}, "
                                 f"grad_norm {gnorm}")
        if per != 2 * cfg.n_layers:
            raise AssertionError(f"train step {i}: {per} B7 launches")
    counts = _all_counts()
    if counts != (2 * cfg.n_layers * TRAIN_STEPS, 0, 0):
        raise AssertionError(f"train steps: launches {counts}")
    launches["conv1d train"] = counts[0]
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(step_ms[1:])
    print(f"  {TRAIN_STEPS} train steps {b}x{s} {cfg.dtype}: "
          f"{steady:.1f} ms a step (host clock, median of steps 1-"
          f"{TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f}), "
          f"{b * s / steady * 1e3:.0f} tokens/s, peak device memory "
          f"{peak / 2**30:.2f} GiB, B7 launches {counts[0]} "
          f"({counts[0] // TRAIN_STEPS} a step), fused-stencil "
          f"{counts[1]}, xcorr1d {counts[2]} on {smi}")
    del params, opt, batches, m
    torch.cuda.empty_cache()

    if cli:
        train_cli_on_card()
    return [conv1d_train_row(dev, cfg, b, s, launches["conv1d train"],
                             steady, "forward + remat recompute")]


def conv1d_train_row(dev, cfg, b, s, launches, step_ms, what):
    """B7 alone at a training xBC view (b, s, c) of the (b, s, row)
    in-projection, bf16 (no gradient: the bare launch the Function's
    forward makes): held to its plain version, timed beside it and
    ``F.conv1d(groups=c)``; the kernels line's row, carrying
    ``launches`` of the path it stands for."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    dv, h, _, g, n, c = ssm._dims(cfg)
    row = 2 * dv + 2 * g * n + h
    bw, f32_rate, _ = card_rates(torch.cuda.get_device_name(0))
    k = cfg.ssm_conv_kernel
    x, w = conv_inputs((b, s, c), k, "bfloat16", dev, seed=23, row=row,
                       offset=dv)
    want = ref.conv1d_depthwise(x, w)
    err, rel = rel_err(kops.conv1d_depthwise(x, w), want)
    if rel > TOL["bfloat16"]:
        raise AssertionError(f"conv1d train view: rel err {rel:.3e}")
    ms = time_ms(lambda: kops.conv1d_depthwise(x, w), 20)
    plain_ms = time_ms(lambda: ref.conv1d_depthwise(x, w), 5)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xt = x.transpose(1, 2).contiguous()  # (b, c, s)
        wt = w.t().contiguous()[:, None, :]  # (c, 1, k)
        lib_ms = time_ms(
            lambda: F.conv1d(xt, wt, padding=k - 1, groups=c), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    values = (b * (s + k - 1) + k) * c + b * s * c
    t_bytes = values * x.element_size() / bw * 1e3
    t_ops = 2 * k * b * s * c / f32_rate * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    per_step = 2 * cfg.n_layers
    print(f"  B7 at the training view {b}x{s}x{c} k={k} bf16: kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms "
          f"({by})  conv1d (groups=c, no TF32) {lib_ms:.4f} ms  max|err| "
          f"{err:.3e}; {per_step} launches a step = {per_step * ms:.2f} ms "
          f"of a {step_ms:.1f} ms step ({per_step * ms / step_ms:.2%})")
    del x, w, want, xt, wt
    torch.cuda.empty_cache()
    return {
        "name": f"conv1d_depthwise[mamba2 train xBC {b}x{s}x{c} k={k}, "
                f"bfloat16, {what}]",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
    }


# Phase 3 (dp train): mamba2-780m data-parallel over ranks that share the
# card over gloo, at phase 3 (train)'s global batch (2, 4096): mesh (2, 1)
# of (data, model) under the dp profile, plain (3 timed steps after step
# 0, then the sync alone) and ZeRO (1 after step 0); grad_sync on the
# yardstick's tree on (2, 2) of (pod, data); the step-0 yardstick's
# leaves under build/ meanwhile. Full width, the depth cut to DP_LAYERS
# of 48 to keep the whole script inside half its time limit: the gloo
# sums of the full depth's 857M gradient values took 166 s of a 927 s
# run (NVIDIA H100 80GB HBM3, 700.00 W), and a host whose CPU is shared
# runs them up to 1.8x slower.
DP_LAYERS = 8
DP_MESH = ((2, 1), ("data", "model"))
DP_STEPS = {False: 3, True: 1}  # timed steps after step 0, by fsdp
DP_SYNC_MESH = ((2, 2), ("pod", "data"))
DP_YARD_DIR = ROOT / "build" / "dp-yardstick"
HIER_TOL = 1e-6


def _rel_l2_big(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64, a chunk of 2^26 values at a time (a
    leaf holds up to 475M)."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for lo in range(0, b.numel(), 1 << 26):
        x, y = a[lo:lo + (1 << 26)].double(), b[lo:lo + (1 << 26)].double()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / max(den, 1e-300))


def _max_rel(a, b) -> float:
    """max |a − b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _yard_file(directory, name: str) -> Path:
    return Path(directory) / (name.replace("/", "__") + ".npy")


def _save_yardstick(yard, directory: Path) -> None:
    """The yardstick's loss and gradient leaves as files the ranks read."""
    import numpy as np

    loss, grads = yard
    directory.mkdir(parents=True, exist_ok=True)
    for name, g in grads.items():
        np.save(_yard_file(directory, name), g.numpy())
    (directory / "yardstick.json").write_text(
        json.dumps({"loss": loss, "leaves": sorted(grads)}))


def _load_leaf(directory, name: str, dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.load(_yard_file(directory, name))).to(dev)


def dp_yardstick(dev, cfg):
    """Phase 3 (train)'s step 0 at ``cfg``'s depth: the B7 grad step of
    ``cfg`` (seed 0) on step 0's ``TRAIN_SHAPE`` batch; the loss and the
    gradient leaves on the host."""
    import torch

    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import ssm
    from repro_torch.tree import tree_leaves_with_path

    b, s = TRAIN_SHAPE
    params = ssm.init_params(cfg, seed=0, device=dev)
    batch = BatchIterator(MarkovLMDataset(cfg.vocab, s, branching=4), b,
                          start_step=0).next_global(dev)
    loss, _, grads = make_grad_step(cfg, device=dev)(params, batch)
    yard = (float(loss), {"/".join(path): g.cpu() for path, g in
                          tree_leaves_with_path(grads)})
    del params, grads, batch
    torch.cuda.empty_cache()
    return yard


def dp_train_rank(mesh, cfg, yard_dir: str, b: int, s: int):
    """One rank of phase 3 (dp train) (b) and (c): ``cfg`` (mamba2-780m
    at full width) on its rows of ``TRAIN_SHAPE``'s global batch, plain data
    parallelism, then ZeRO (``fsdp=True``). Step 0 through
    ``make_synced_grad_step`` (its synced gradient held to the
    yardstick leaf by leaf), AdamW on it, then ``DP_STEPS`` timed steps
    through ``make_train_step``; ZeRO's step-0 gradient and updated
    parameters against plain DP's bit for bit (its gradient held to
    the yardstick itself where it is not); plain DP's sync alone on a
    full f32 tree. Returns this rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.distrib.grad_sync import sync_grads
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves_with_path, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    meta = json.loads((Path(yard_dir) / "yardstick.json").read_text())
    dataset = MarkovLMDataset(cfg.vocab, s, branching=4)
    axes = shlib.dp_axes("dp")
    host, hosts = shlib.axis_index(mesh, axes), shlib.axes_size(mesh, axes)

    def clock(fn):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    def named(tree):
        return {"/".join(p): v for p, v in tree_leaves_with_path(tree)}

    out, kept = {}, {}
    for fsdp in (False, True):
        steps = DP_STEPS[fsdp]
        opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                              total_steps=1 + steps)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        p_sh, _ = tsteps.train_shardings(cfg, mesh, profile="dp", fsdp=fsdp)
        params = shlib.shard_tree(ssm.init_params(cfg, seed=0, device=dev),
                                  p_sh)
        opt = adamw_init(params)
        it = BatchIterator(dataset, b, host_index=host, host_count=hosts)
        batches = [it.next_global(dev) for _ in range(1 + steps)]
        synced = tsteps.make_synced_grad_step(cfg, mesh=mesh, profile="dp",
                                              fsdp=fsdp, device=dev)
        step_fn = tsteps.make_train_step(cfg, opt_cfg, device=dev,
                                         mesh=mesh, profile="dp", fsdp=fsdp)
        rec = {"rows": tuple(batches[0]["tokens"].shape)}
        kc.reset_launch_counts()
        (loss, _, grads, norm), rec["step0_ms"] = clock(
            lambda: synced(params, batches[0]))
        rec["launches0"] = kc.conv1d_depthwise_cuda.launches
        rec["loss"] = float(loss)
        rec["loss_rel"] = abs(rec["loss"] - meta["loss"]) / abs(meta["loss"])
        full = named(shlib.gather_tree(grads, p_sh) if fsdp else grads)
        rec["finite"] = all(bool(torch.isfinite(g).all())
                            for g in full.values())
        if fsdp:
            rec["grads_equal"] = sum(torch.equal(g.cpu(), kept["grads"][k])
                                     for k, g in full.items())
        if not fsdp or rec["grads_equal"] < len(full):
            # (c) equal to (b) bit for bit inherits (b)'s comparison
            rec["grad_rel"] = {
                k: _rel_l2_big(g, _load_leaf(yard_dir, k, dev))
                for k, g in full.items()}
        else:
            rec["grad_rel"] = dict(kept["grad_rel"])
        if not fsdp:
            kept["grads"] = {k: g.cpu() for k, g in full.items()}
            kept["grad_rel"] = rec["grad_rel"]
        del full
        params, opt, m = adamw_update(opt_cfg, grads, opt, params,
                                      grad_norm=norm)
        del grads
        rec["grad_norm0"] = float(m["grad_norm"])
        full = named(shlib.gather_tree(params, p_sh) if fsdp else params)
        if not fsdp:
            kept["params"] = {k: p.cpu() for k, p in full.items()}
        else:
            rec["params_equal"] = sum(torch.equal(p.cpu(),
                                                  kept["params"][k])
                                      for k, p in full.items())
        del full
        rec["leaves"] = len(kept["grads"])
        torch.cuda.empty_cache()  # the comparisons' blocks
        # the timed steps: counters zeroed just before, read just after
        comm.reset_counts()
        kc.reset_launch_counts()
        rec["ms"], rec["losses"], rec["launches"] = [], [], []
        for batch in batches[1:]:
            before = kc.conv1d_depthwise_cuda.launches
            (params, opt, m), ms = clock(
                lambda: step_fn(params, opt, batch))
            rec["ms"].append(ms)
            rec["losses"].append(float(m["loss"]))
            rec["launches"].append(kc.conv1d_depthwise_cuda.launches - before)
        rec["bytes"] = comm.counts["bytes"] // steps
        rec["peak"] = torch.cuda.max_memory_allocated(dev)
        free, total = torch.cuda.mem_get_info(dev)
        rec["card_used"], rec["card_total"] = total - free, total
        if not fsdp:  # the sync alone, on a tree of the gradient's size
            clone = tree_map(lambda t: t.clone(), params)
            comm.reset_counts()
            _, rec["sync_ms"] = clock(
                lambda: sync_grads(clone, p_sh, mesh, axes))
            rec["sync_bytes"] = comm.counts["bytes"]
            del clone
        del params, opt, batches, synced, step_fn, m
        out["zero" if fsdp else "dp"] = rec
    return out


def dp_sync_rank(mesh, yard_dir: str):
    """One rank of phase 3 (dp train) (d): the yardstick's gradient tree
    scaled by (1 + rank/8), summed over (pod, data) by one flat
    all-reduce, by ``hierarchical_psum_tree`` (fast ``data``, slow
    ``pod``) and by ``compressed_psum_tree``, a leaf at a time; each
    timed (host clock after a barrier, ending in a synchronize) with the
    bytes this rank sent, and held to the flat sum."""
    import torch
    import torch.distributed as dist

    from repro_torch.distrib import comm, grad_sync
    from repro_torch.distrib import sharding as shlib

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    meta = json.loads((Path(yard_dir) / "yardstick.json").read_text())
    scale = 1 + rank / 8
    total = sum(1 + r / 8 for r in range(dist.get_world_size()))
    tree = {k: _load_leaf(yard_dir, k, dev).mul_(scale)
            for k in meta["leaves"]}
    both = ("pod", "data")

    def clock(fn):
        dist.barrier()
        torch.cuda.synchronize(dev)
        comm.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0), comm.counts["bytes"]

    rec = {"values": sum(t.numel() for t in tree.values())}
    flat = {k: v.clone() for k, v in tree.items()}
    _, rec["flat_ms"], rec["flat_bytes"] = clock(
        lambda: comm.all_reduce_(list(flat.values()),
                                 shlib.axis_group(mesh, both)))
    rec["flat_err"] = max(_max_rel(flat[k], tree[k] * (total / scale))
                          for k in tree)
    rec.update(hier_err=0.0, hier_ms=0.0, hier_bytes=0, comp_err=0.0,
               comp_ms=0.0, comp_bytes=0)
    rec["resid_nonzero"] = 0  # leaves whose bf16 residual is not all zero
    for k, g in tree.items():
        h, ms, by = clock(lambda: grad_sync.hierarchical_psum_tree(
            {k: g}, mesh, "data", "pod"))
        rec["hier_ms"] += ms
        rec["hier_bytes"] += by
        rec["hier_err"] = max(rec["hier_err"], _max_rel(h[k], flat[k]))
        del h
        (c, resid), ms, by = clock(lambda: grad_sync.compressed_psum_tree(
            {k: g}, mesh, both))
        rec["comp_ms"] += ms
        rec["comp_bytes"] += by
        rec["comp_err"] = max(rec["comp_err"], _max_rel(c[k], flat[k]))
        rec["resid_nonzero"] += bool(resid[k].abs().max() > 0)
        del c, resid
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    return rec


def dp_cli_cmd(tmp) -> list[str]:
    """The train CLI with ``TRAIN_CLI`` over ``--mesh 2x1 --backend
    gloo`` (two ranks sharing the card, restarting once), its
    checkpoints under ``tmp``."""
    return _cli("train", *TRAIN_CLI, "--mesh", "2x1", "--backend", "gloo",
                "--ckpt-dir", f"{tmp}/dp-two")


def dp_cli_check(dev, out, one, tmp):
    """Phase 3 (dp train)'s CLI run (``dp_cli_cmd``): its logged losses
    equal to ``--mesh 1x1``'s (``one``, the logged step lines of
    ``train_cli_cmd``'s run) to the printed digits, both ranks restored
    at step 3; then its last checkpoint restored onto one process (no
    mesh) for 2 more steps."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init

    _cli_ok("train CLI 2x1", out)
    two = _logged(out.stdout)
    done = next(x for x in out.stdout.splitlines() if x.startswith("done:"))
    if (two != one or "restarts=1" not in done or "device=cuda" not in done
            or out.stderr.count("restored at step 3") != 2):
        raise AssertionError(f"train CLI 2x1: {two} vs 1x1 {one}; {done}")
    print(f"  python -m repro_torch.launch.train {' '.join(TRAIN_CLI)} "
          f"--mesh 2x1 --backend gloo: rc 0 in {out.seconds:.1f} s, its "
          f"{len(two)} logged step lines equal --mesh 1x1's to the "
          "printed digits, both ranks restored at step 3")
    print(f"    {done}")
    # its last checkpoint on one process: the reduced config, the CLI's
    # data and schedule (2 steps past its 8)
    cfg = reduced_config(get_config("mamba2-780m"))
    mgr = CheckpointManager(f"{tmp}/dp-two")
    params = ssm.init_params(cfg, seed=0, device=dev)
    (state, at) = mgr.restore({"params": params, "opt": adamw_init(params)})
    step_fn = make_train_step(cfg, AdamWConfig(
        lr_peak=1e-3, warmup_steps=1, total_steps=at + 2), device=dev)
    data = MarkovLMDataset(cfg.vocab, 64, branching=4)
    params, opt, losses = state["params"], state["opt"], []
    for i in range(at, at + 2):
        batch = BatchIterator(data, 2, start_step=i).next_global(dev)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    if at != 8 or int(opt.step) != at + 2 or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"restore onto 1x1: step {at}, {losses}")
    del params, opt, state
    torch.cuda.empty_cache()
    print(f"  its step-{at} checkpoint (whole leaves) restored on one "
          f"process without a mesh: steps {at}, {at + 1} loss "
          + ", ".join(f"{x:.4f}" for x in losses))


def dp_cli_on_card(dev):
    """``dp_cli_cmd`` and its ``--mesh 1x1`` twin (``train_cli_cmd``) on
    the card at once, then ``dp_cli_check``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        outs = run_at_once({"one": train_cli_cmd(tmp), "two": dp_cli_cmd(tmp)},
                           Path(tmp) / "logs")
        _cli_ok("train CLI 1x1", outs["one"])
        dp_cli_check(dev, outs["two"], _logged(outs["one"].stdout), tmp)


def _logged(stdout: str) -> list[list[str]]:
    """The train CLI's step lines, split: ["step", n, "loss", value]."""
    return [x.split()[:4] for x in stdout.splitlines()
            if x.startswith("step ")]


def phase_dp_train(dev, smi, launches, cli=True):
    """Phase 3 (dp train): the data-parallel train step of mamba2-780m
    at full width and ``DP_LAYERS`` layers on ranks sharing this card
    over gloo (``launch.mesh.run_on_mesh``; none of its times is a
    scaling figure), held to the one-card step 0 at that depth (the
    yardstick); grad_sync on the yardstick's tree; with ``cli``, the
    train CLI over a mesh against its ``--mesh 1x1`` run (else phase 3
    (clis) runs them). Returns the B7 row at a rank's training view."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh

    print("== phase 3 (dp train): mamba2-780m data-parallel and ZeRO over "
          f"gloo ranks sharing one card at {DP_LAYERS} of 48 layers, "
          "grad_sync")
    print(f"  card: {smi}")
    build.build_all()  # no rank waits on nvcc
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=DP_LAYERS)
    b, s = TRAIN_SHAPE
    t0 = time.perf_counter()
    yard = dp_yardstick(dev, cfg)
    shutil.rmtree(DP_YARD_DIR, ignore_errors=True)
    _save_yardstick(yard, DP_YARD_DIR)
    loss_a, leaves = yard[0], len(yard[1])
    n_values = sum(g.numel() for g in yard[1].values())
    del yard
    print(f"  (a) yardstick: the one-card B7 step 0 at {cfg.n_layers} layers, "
          f"{b}x{s}: loss {loss_a:.6f}, {leaves} f32 gradient leaves, "
          f"{n_values} values, made and written for the ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    try:
        ranks = run_on_mesh(dp_train_rank, *DP_MESH, backend="gloo",
                            device=dev, args=(cfg, str(DP_YARD_DIR), b, s),
                            timeout=900)
        sync = run_on_mesh(dp_sync_rank, *DP_SYNC_MESH, backend="gloo",
                           device=dev, args=(str(DP_YARD_DIR),), timeout=900)
    finally:
        shutil.rmtree(DP_YARD_DIR, ignore_errors=True)
    tol = TOL["bfloat16"]
    per_step = 2 * cfg.n_layers
    for label, key in (("(b) mesh (2, 1) dp profile", "dp"),
                       ("(c) the same mesh, fsdp=True (ZeRO)", "zero")):
        recs = [r[key] for r in ranks]
        print(f"  {label}: local batch {recs[0]['rows']} per rank")
        for rank, r in enumerate(recs):
            worst = max(r["grad_rel"].items(), key=lambda kv: kv[1])
            print(f"    rank {rank}: step 0 loss {r['loss']:.6f} vs "
                  f"(a) {loss_a:.6f} (rel {r['loss_rel']:.3e}), synced "
                  f"gradient rel L2 worst {worst[1]:.3e} ({worst[0]}) of "
                  f"{len(r['grad_rel'])} leaves (tol {tol:.0e}); grad_norm "
                  f"{r['grad_norm0']:.6f}; B7 launches step 0 "
                  f"{r['launches0']}, then {r['launches']}; steps "
                  f"{', '.join(f'{ms:.1f}' for ms in r['ms'])} ms, losses "
                  f"{', '.join(f'{x:.4f}' for x in r['losses'])}; peak "
                  f"{r['peak'] / 2**30:.2f} GiB")
            if not (r["finite"] and r["loss_rel"] <= tol
                    and worst[1] <= tol):
                raise AssertionError(f"{label} rank {rank}: loss rel "
                                     f"{r['loss_rel']:.3e}, {worst}")
            if r["launches0"] != per_step or any(
                    n != per_step for n in r["launches"]):
                raise AssertionError(f"{label} rank {rank}: B7 launches "
                                     f"{r['launches0']}, {r['launches']}")
            if r["losses"] != recs[0]["losses"]:
                raise AssertionError(f"{label}: ranks' losses differ")
        r = recs[0]
        med = statistics.median(r["ms"])
        peaks = ", ".join(f"{x['peak'] / 2**30:.2f}" for x in recs)
        alone = (f"; the sync alone {r['sync_ms']:.1f} ms, "
                 f"{r['sync_bytes']} bytes" if "sync_ms" in r else "")
        print(f"    {len(r['ms'])} timed step(s): {med:.1f} ms a step "
              f"(median, host clock after a barrier), {b * s / med * 1e3:.0f}"
              f" tokens/s over both ranks{alone}; bytes a rank sends per "
              f"step {r['bytes']} (ring count); peak per rank {peaks} GiB;"
              f" the card {r['card_used'] / 2**30:.2f} of "
              f"{r['card_total'] / 2**30:.2f} GiB in use after the steps")
    dp, zero = ranks[0]["dp"], ranks[0]["zero"]
    n_leaves = dp["leaves"]
    if zero["grads_equal"] == n_leaves and zero["params_equal"] == n_leaves:
        print(f"    ZeRO vs DP: step 0's synced gradients ({n_leaves} of "
              f"{n_leaves} leaves) and the parameters after it equal bit for"
              " bit")
    else:
        why = ("the synced gradients differ: the sums ran in another order"
               if zero["grads_equal"] != n_leaves else
               f"the gradients are equal, but the clip's global norm sums "
               f"the blocks' squares in another order ({zero['grad_norm0']!r}"
               f" vs {dp['grad_norm0']!r}), so AdamW's scale differs")
        print(f"    ZeRO vs DP: gradients {zero['grads_equal']} of {n_leaves}"
              f" leaves equal bit for bit, parameters after step 0 "
              f"{zero['params_equal']} of {n_leaves}: {why}")
    print(f"  (d) grad_sync on (a)'s tree, mesh (2, 2) of (pod, data), 4 ranks"
          f" on the card, rank r's tree = (a) x (1 + r/8), "
          f"{sync[0]['values']} values:")
    for rank, r in enumerate(sync):
        if not (r["hier_err"] <= HIER_TOL and r["comp_err"] <= tol
                and r["flat_err"] <= HIER_TOL and r["resid_nonzero"]):
            raise AssertionError(f"grad_sync rank {rank}: {r}")
    r = sync[0]
    peaks = ", ".join(f"{x['peak'] / 2**30:.2f}" for x in sync)
    print(f"    flat all_reduce {r['flat_ms']:.1f} ms, {r['flat_bytes']} bytes"
          f" a rank (max rel {r['flat_err']:.3e} from 4.75 x (a)); "
          f"hierarchical_psum_tree {r['hier_ms']:.1f} ms, "
          f"{r['hier_bytes']} bytes (max rel {r['hier_err']:.3e} from flat, "
          f"tol {HIER_TOL:.0e}); compressed_psum_tree {r['comp_ms']:.1f} ms,"
          f" {r['comp_bytes']} bytes (max rel {r['comp_err']:.3e}, tol "
          f"{tol:.0e}, residuals nonzero in {r['resid_nonzero']} of "
          f"{leaves} leaves); peak per rank {peaks} GiB; all"
          " ranks within tolerance")
    if cli:
        dp_cli_on_card(dev)
    launches["conv1d dp train"] = sum(dp["launches"])
    return [conv1d_train_row(dev, cfg, b // 2, s,
                             launches["conv1d dp train"],
                             statistics.median(dp["ms"]),
                             "data-parallel rank 0 of 2, forward + remat "
                             "recompute")]


SERVE_SHAPES = [(256, 256, 256), (4096, 4096)]
SERVE_REQUESTS, SERVE_STEPS, SERVE_BATCH = 16, 8, 8


# The dense transformer family at full width (phase 3 (dense)).
# llama3-8b serving: prefill_32k's (32, 32768) cut to (1, 8192) to fit
# one card beside the 29.9 GiB of f32 weights (at (32, 32768) the bf16
# logits alone are 269 GB); 8192 > 2048 takes the chunked attention.
DENSE_PREFILL = (1, 8192)
# Decode against forward in f32 from an empty cache: max |err| over max
# |logit| within DENSE_DECODE_TOL.
DENSE_DECODE = (2, 256)
DENSE_DECODE_TOL = 1e-3
# qwen2.5-3b training: train_4k's seq 4096 at a global batch cut from 256
# to 1 to fit one card (46.0 GiB of f32 parameters, gradients and
# moments); step 0, then steps 1-3 timed.
DENSE_TRAIN_SHAPE = (1, 4096)
DENSE_TRAIN_STEPS = 4
# The card against the CPU on reduced configs, relative L2, TF32 off.
DENSE_CPU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Gradient leaves that the softmax's shift invariance nearly cancels
# (adding one vector to every key moves a row's logits by one constant,
# but for the RoPE rotation): bf16 rounds their sum coarsely wherever it
# runs, so in bf16 each is held to its own rounding on the CPU (its
# bf16 gradient against its f32 one) where that is above the limit.
NEAR_CANCELLED = ("bk",)


def _counting_chunked():
    """Wrap ``layers.chunked_attention`` to count its calls; returns
    (the list of calls, a function that restores it)."""
    from repro_torch.models import layers

    calls, plain = [], layers.chunked_attention

    def counting(*a, **kw):
        calls.append((kw["q_chunk"], kw["kv_chunk"]))
        return plain(*a, **kw)

    layers.chunked_attention = counting

    def restore():
        layers.chunked_attention = plain

    return calls, restore


def _no_kernel(what: str) -> tuple[int, int, int]:
    """The launch counts since the last reset, which must read 0: the
    dense path runs no kernel of B1-B7 (the reference reaches no
    ``pl.pallas_call`` there)."""
    counts = _all_counts()
    if counts != (0, 0, 0):
        raise AssertionError(f"{what}: launches (B7, fused-stencil, "
                             f"xcorr1d) {counts}, want none")
    return counts


def dense_serving(dev, smi):
    """llama3-8b at full width (32 layers, d_model 4096, 32/8 heads, d_ff
    14336, vocab 128256), random init from a seeded generator on the
    card: the prefill ``DENSE_PREFILL`` in bf16 through
    ``make_prefill_step`` (chunked attention in every layer), timed;
    ``forward`` against step-by-step ``decode_step`` in f32 on
    ``DENSE_DECODE``; the serve loop of ``launch/serve.py``; the launch
    counters zeroed just before each part and read just after, all 0."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tr

    cfg = get_config("llama3-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for t in (params, params["blocks"])
                for v in t.values() if torch.is_tensor(v))
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_par} parameters (config: "
          f"{cfg.n_params():.0f}), {n_par * 4 / 2**30:.2f} GiB f32, init "
          f"{time.perf_counter() - t0:.1f} s; {cfg.dtype} compute")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = DENSE_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    prefill = make_prefill_step(cfg, device=dev)
    calls, restore = _counting_chunked()
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            _reset_all_counts()
            out = prefill(params, batch)
            torch.cuda.synchronize()
            counts = _no_kernel("llama3-8b prefill")
    finally:
        restore()
    if calls != [(1024, 1024)] * cfg.n_layers:
        raise AssertionError(f"prefill: chunked attention calls {calls}")
    if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prefill: bad logits {tuple(out.shape)}")
    times = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    print(f"  prefill {DENSE_PREFILL} {cfg.dtype} (prefill_32k's (32, 32768) "
          f"cut to fit one card): {ms:.1f} ms (host clock, median of 3 "
          f"after the warm-up: {', '.join(f'{t:.1f}' for t in times)}), "
          f"{b * s / ms * 1e3:.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; chunked "
          f"attention (1024/1024) in {len(calls)} of {cfg.n_layers} layers; "
          f"launches (B7, fused-stencil, xcorr1d) {counts} on {smi}")
    del out, batch

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b2, s2 = DENSE_DECODE
    toks = torch.randint(0, cfg.vocab, (b2, s2), generator=gen, device=dev)
    step = make_serve_step(cfg32, device=dev)
    with torch.no_grad():
        _reset_all_counts()
        full, _ = tr.forward(params, cfg32, toks)
        cache = tr.init_decode_cache(cfg32, b2, s2, device=dev)
        errs = torch.empty(s2, device=dev)
        t0 = time.perf_counter()
        for t in range(s2):
            lg, cache = step(params, cache, {"tokens": toks[:, t:t + 1]})
            errs[t] = (lg - full[:, t]).abs().max()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _no_kernel("llama3-8b decode vs forward")
    worst = float(errs.max())
    rel = worst / float(full.abs().max())
    print(f"  decode vs forward {DENSE_DECODE} f32, {s2} steps from an empty "
          f"cache ({1e3 * secs / s2:.2f} ms a step): max|err| {worst:.3e}, "
          f"relative to max|logit| {rel:.3e} (limit {DENSE_DECODE_TOL:.0e}; "
          f"worst step {int(errs.argmax())}); launches {counts} "
          f"{'ok' if rel <= DENSE_DECODE_TOL else 'FAIL'}")
    if not rel <= DENSE_DECODE_TOL:
        raise AssertionError(f"llama3-8b decode vs forward: rel {rel:.3e}")
    del full, cache, toks, errs

    serve(cfg, batch=LM_BATCH, steps=2, device=dev, params=params)
    _reset_all_counts()
    gen_tokens, secs = serve(cfg, batch=LM_BATCH, steps=LM_STEPS,
                             device=dev, params=params)
    counts = _no_kernel("llama3-8b serve")
    if gen_tokens.shape != (LM_BATCH, LM_STEPS + 1) or \
            int(gen_tokens.min()) < 0 or int(gen_tokens.max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {tuple(gen_tokens.shape)}")
    print(f"  serve batch {LM_BATCH}, {LM_STEPS} steps {cfg.dtype}: "
          f"{LM_BATCH * LM_STEPS / secs:.1f} tokens/s, "
          f"{1e3 * secs / LM_STEPS:.2f} ms per decode step (host clock); "
          f"launches {counts} on {smi}")
    print("  first row: " + " ".join(map(str, gen_tokens[0, :12].tolist())))
    del params, prefill, step
    torch.cuda.empty_cache()


def dense_training(dev, smi):
    """qwen2.5-3b's train step at full width (36 layers, d_model 2048,
    vocab 151936, tied, QKV bias; bf16 compute on f32 master
    parameters, selective remat) on ``MarkovLMDataset`` batches at
    ``DENSE_TRAIN_SHAPE`` through ``make_train_step(donate=True)``:
    step 0's loss finite and within 1.0 of ln(vocab), steps 1-3 timed;
    the launch counters zeroed just before and read just after, 0."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("qwen2.5-3b")
    if cfg.remat != "selective" or cfg.dtype != "bfloat16":
        raise AssertionError(f"config remat {cfg.remat}, dtype {cfg.dtype}")
    b, s = DENSE_TRAIN_SHAPE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    n_par = sum(v.numel() for t in (params, params["blocks"])
                for v in t.values() if torch.is_tensor(v))
    state = torch.cuda.memory_allocated()
    card = torch.cuda.get_device_properties(dev).total_memory
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, tied {cfg.tie_embeddings}, QKV bias "
          f"{cfg.qkv_bias}; {n_par} parameters (config: "
          f"{cfg.n_params():.0f}); parameters and moments "
          f"{state / 2**30:.2f} GiB (with gradients "
          f"{state * 4 / 3 / 2**30:.2f}); batch {b} x seq {s} (train_4k's "
          f"seq, its batch 256 cut to {b}), {cfg.dtype} on f32 master "
          f"weights, remat {cfg.remat}")
    dataset = MarkovLMDataset(cfg.vocab, s, branching=4)
    it = BatchIterator(dataset, b, start_step=0)
    batches = [it.next_global(dev) for _ in range(DENSE_TRAIN_STEPS)]
    step_fn = make_train_step(
        cfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                         total_steps=DENSE_TRAIN_STEPS),
        device=dev, donate=True)
    _reset_all_counts()
    step_ms, losses = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        step_ms.append(ms)
        losses.append(loss)
        print(f"  step {i}: loss {loss:.4f}  grad_norm {gnorm:.4f}  lr "
              f"{lr:.3e}  {ms:.1f} ms  {b * s / ms * 1e3:.0f} tokens/s  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: loss {loss}, "
                                 f"grad_norm {gnorm}")
    counts = _no_kernel("qwen2.5-3b train steps")
    ln_v = math.log(cfg.vocab)
    if not abs(losses[0] - ln_v) <= 1.0:
        raise AssertionError(f"step-0 loss {losses[0]:.4f}, ln(vocab) "
                             f"{ln_v:.4f}")
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(step_ms[1:])
    print(f"  {DENSE_TRAIN_STEPS} train steps {b}x{s} {cfg.dtype}: step-0 "
          f"loss {losses[0]:.4f} (ln {cfg.vocab} = {ln_v:.4f}); "
          f"{steady:.1f} ms a step (host clock, median of steps 1-"
          f"{DENSE_TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f}), "
          f"{b * s / steady * 1e3:.0f} tokens/s, peak device memory "
          f"{peak / 2**30:.2f} GiB of the card's {card / 2**30:.2f}; "
          f"launches {counts} on {smi}")
    del params, opt, batches, m
    torch.cuda.empty_cache()


def dense_card_vs_cpu(dev):
    """Reduced qwen2.5-3b and qwen2-vl-7b (the VLM with patch embeddings
    and three M-RoPE streams): the card's ``forward`` logits, loss and
    ``lm_loss`` gradient leaves against the CPU's on the same
    parameters, f32 and bf16, relative L2 within ``DENSE_CPU_TOL``; in
    bf16 a ``NEAR_CANCELLED`` leaf whose own bf16 rounding on the CPU is
    larger is held to that instead."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves_with_path, tree_map

    for arch in ("qwen2.5-3b", "qwen2-vl-7b"):
        base = reduced_config(get_config(arch))
        params = tr.init_params(base, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(2)
        b, s = 2, 64
        tokens = torch.randint(0, base.vocab, (b, s), generator=gen)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        if base.family == "vlm":
            t = torch.arange(s).expand(b, s)
            batch["positions"] = torch.stack([t, t // 8, t % 8])
            batch["patch_embeds"] = torch.randn(
                (b, base.n_patches, base.d_model), generator=gen)
        on_card = tree_map(lambda v: v.to(dev), params)
        batch_card = {k: v.to(dev) for k, v in batch.items()}
        extra = {k: batch[k] for k in ("positions", "patch_embeds")
                 if k in batch}
        extra_card = {k: batch_card[k] for k in extra}
        cpu_f32 = None
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            tol = DENSE_CPU_TOL[dtype]
            _reset_all_counts()
            with torch.no_grad():
                want, _ = tr.forward(params, cfg, tokens, **extra)
                got, _ = tr.forward(on_card, cfg, batch_card["tokens"],
                                    **extra_card)
            logit_rel = _rel_l2(got.cpu(), want)
            loss_c, _, grads_c = make_grad_step(cfg, device="cpu")(params,
                                                                  batch)
            loss_g, _, grads_g = make_grad_step(cfg, device=dev)(on_card,
                                                                batch_card)
            _no_kernel(f"{arch} {dtype} card vs CPU")
            grads_c = dict(tree_leaves_with_path(grads_c))
            cpu_f32 = cpu_f32 or grads_c
            rows, floors = [], []
            for path, g in tree_leaves_with_path(grads_g):
                limit = tol
                if dtype == "bfloat16" and path[-1] in NEAR_CANCELLED:
                    own = _rel_l2(grads_c[path], cpu_f32[path])
                    if own > tol:
                        limit = own
                        floors.append(f"{'/'.join(path)} {own:.3e}")
                rows.append((_rel_l2(g.cpu(), grads_c[path]), limit,
                             "/".join(path)))
            rows.sort(reverse=True)
            loss_rel = abs(float(loss_g) - float(loss_c)) / float(loss_c)
            bad = [r for r in rows if not r[0] <= r[1]]
            ok = logit_rel <= tol and loss_rel <= tol and not bad
            print(f"  {arch} reduced {dtype}, card vs CPU (TF32 off): logits "
                  f"rel L2 {logit_rel:.3e}, loss {float(loss_g):.6f} vs "
                  f"{float(loss_c):.6f}, gradient leaves rel L2 worst "
                  f"{rows[0][0]:.3e} ({rows[0][2]}) of {len(rows)} (tol "
                  f"{tol:.0e}" + (f"; near-cancelled, held to its own "
                                  f"bf16 rounding on the CPU: "
                                  f"{', '.join(floors)}"
                                  if floors else "")
                  + f") {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{arch} {dtype} card vs CPU: logits "
                                     f"{logit_rel:.3e}, loss {loss_rel:.3e}"
                                     f", {bad or rows[:3]}")


def phase_dense(dev, smi):
    """Phase 3 (dense): the dense transformer family at full width on
    the card (``dense_serving``: llama3-8b; ``dense_training``:
    qwen2.5-3b) and the card against the CPU on reduced configs
    (``dense_card_vs_cpu``). Every op is plain PyTorch, as the reference
    computes these models outside any Pallas kernel; the B1-B7 counters
    read 0 throughout."""
    import torch

    print("== phase 3 (dense): llama3-8b serving, qwen2.5-3b training at "
          "full width (plain PyTorch; no kernel of B1-B7)")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    torch.cuda.empty_cache()
    dense_serving(dev, smi)
    dense_training(dev, smi)
    dense_card_vs_cpu(dev)


# Tensor parallelism at full width (phase 3 (tp)): ranks sharing the card
# over gloo against a one-rank yardstick run just before in this process.
TP_MESH = ((1, 2), ("data", "model"))
# gemma-2b's single KV head: the reference's rule cuts the cache by
# sequence only where the batch is cut over a data axis above one rank.
TP_SEQ_MESH = ((2, 2), ("data", "model"))
TP_PREFILL = (1, 8192)
# Depth cut to keep the whole script inside half its time limit (full
# width; llama3-8b has 32 layers, qwen2.5-3b 36, gemma-2b 18,
# mamba2-780m 48, recurrentgemma-9b 38, whisper-small 12 + 12): llama3-8b
# in (a) and (b), gemma-2b in (c), qwen2.5-3b in (d), mamba2-780m in (f),
# recurrentgemma-9b in (g) (one super-block of (rec, rec, attn) and one
# tail block), whisper-small in (h) (its encoder and decoder alike), the
# yardsticks and the ranks alike. A host whose CPU is
# shared runs the whole script up to 1.8x slower: on such a host
# (NVIDIA H100 80GB HBM3, 700.00 W) it took 1152.4 s with this phase at
# 12, 12, 18, 8 and 8 layers, and another ran past 1200 s at 8, 9, 18,
# 4 and 4.
TP_LAYERS = {"llama3-8b": 4, "qwen2.5-3b": 4, "gemma-2b": 6,
             "mamba2-780m": 2, "recurrentgemma-9b": 4, "whisper-small": 4}
TP_DECODE = (4, 32)  # batch, teacher-forced steps from an empty cache
TP_GEMMA_DECODE = (2, 32)
TP_GEMMA_FORWARD = (1, 2048)
TP_TRAIN_SHAPE = (1, 4096)  # train_4k's seq at a global batch of 1
TP_TRAIN_STEPS = 3  # timed, after step 0
# limits, relative to the yardstick's max |logit| (losses and the norm
# relative); the row-parallel partial products are summed in f32
TP_BF16_TOL = 2e-2
# (b)'s bf16 decode: a correct one-rank bf16 program that sums one product
# in another order lies 2.26e-2 of max |logit| from the yardstick here, so
# 2e-2 cannot tell programs apart; the decode is held instead, as the bf16
# gradients are on the CPU, to TP_BF16_MULTIPLE times the one-rank bf16
# decode's own distance from the one-rank f32 decode.
TP_BF16_MULTIPLE = 1.5
TP_F32_DECODE_TOL = 1e-3
TP_F32_FORWARD_TOL = 1e-4
TP_YARD_DIR = ROOT / "build" / "tp-yardstick"
TP_CLI = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "8",
          "--global-batch", "2", "--seq-len", "64", "--ckpt-every", "3",
          "--simulate-failure-at", "5", "--log-every", "1"]


def _tp_cfg(arch: str):
    """``arch``'s config at phase 3 (tp)'s depth (``TP_LAYERS``)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch), n_layers=TP_LAYERS[arch])


def _tp_tokens(cfg, shape, seed, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)


def _tp_decode(step, params, cache, tokens):
    """Teacher-forced decode steps of ``tokens`` (b, steps): every step's
    float32 logits (steps, b, vocab) and the host ms a step."""
    import torch

    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, cache = step(params, cache, {"tokens": tokens[:, t:t + 1]})
            out.append(lg)
    torch.cuda.synchronize()
    return torch.stack(out), 1e3 * (time.perf_counter() - t0) / len(out)


def tp_yardstick(dev, directory: Path) -> dict:
    """The one-rank runs phase 3 (tp) holds its ranks to, written to
    ``directory`` as numpy arrays: llama3-8b's bf16 prefill logits at
    ``TP_PREFILL`` and its bf16 serve steps at ``TP_DECODE``; gemma-2b's
    f32 forward at ``TP_GEMMA_FORWARD`` and decode steps at
    ``TP_GEMMA_DECODE``; qwen2.5-3b's step-0 loss and gradient norm.
    Each model is freed before the next; returns the host times."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init

    directory.mkdir(parents=True, exist_ok=True)
    out = {}
    cfg = _tp_cfg("llama3-8b")
    params = tr.init_params(cfg, seed=0, device=dev)
    tokens = _tp_tokens(cfg, TP_PREFILL, 1, dev)
    prefill = make_prefill_step(cfg, device=dev)
    with torch.no_grad():
        prefill(params, {"tokens": tokens})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    np.save(directory / "prefill.npy", logits.cpu().numpy())
    b, steps = TP_DECODE
    cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    logits, out["decode_ms"] = _tp_decode(
        make_serve_step(cfg, device=dev), params, cache,
        _tp_tokens(cfg, TP_DECODE, 2, dev))
    np.save(directory / "decode.npy", logits.cpu().numpy())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cache = tr.init_decode_cache(cfg32, b, steps, device=dev)
    f32, _ = _tp_decode(make_serve_step(cfg32, device=dev), params, cache,
                        _tp_tokens(cfg, TP_DECODE, 2, dev))
    np.save(directory / "decode_f32.npy", f32.cpu().numpy())
    out["decode_bf16_vs_f32"] = _tp_worst(logits, f32.cpu().numpy())
    del params, cache, logits, f32, prefill
    torch.cuda.empty_cache()

    cfg = _tp_model_cfg("gemma-2b", "float32")
    params = tr.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        logits, _ = tr.forward(params, cfg,
                               _tp_tokens(cfg, TP_GEMMA_FORWARD, 3, dev))
    np.save(directory / "gemma_forward.npy", logits.float().cpu().numpy())
    del logits
    b, steps = TP_GEMMA_DECODE
    cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    logits, out["gemma_decode_ms"] = _tp_decode(
        make_serve_step(cfg, device=dev), params, cache,
        _tp_tokens(cfg, TP_GEMMA_DECODE, 4, dev))
    np.save(directory / "gemma_decode.npy", logits.cpu().numpy())
    del params, cache, logits
    torch.cuda.empty_cache()

    cfg = _tp_cfg("qwen2.5-3b")
    b, s = TP_TRAIN_SHAPE
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(cfg, seed=0, device=dev)
    batch = BatchIterator(MarkovLMDataset(cfg.vocab, s, branching=4),
                          b).next_global(dev)
    step = make_train_step(cfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                                            total_steps=1 + TP_TRAIN_STEPS),
                           device=dev, donate=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, adamw_init(params), batch)
    torch.cuda.synchronize()
    out["train_ms"] = 1e3 * (time.perf_counter() - t0)
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    out["train_peak"] = torch.cuda.max_memory_allocated()
    del params, opt, m, batch, step
    torch.cuda.empty_cache()
    (directory / "yardstick.json").write_text(json.dumps(out))
    return out


def _tp_clock(dev, fn):
    import torch
    import torch.distributed as dist

    dist.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _tp_held(dev) -> dict:
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    return {"peak": torch.cuda.max_memory_allocated(dev),
            "card_used": total - free, "card_total": total}


def _tp_err(got, want) -> float:
    """max |got − want| over max |want| (float64 on the host)."""
    import numpy as np

    got = got.detach().double().cpu().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tp_worst(got, want) -> float:
    """The worst step of (steps, b, vocab) logits by :func:`_tp_err`."""
    return max(_tp_err(got[t], want[t]) for t in range(len(want)))


def tp_llama_rank(mesh, yard_dir: str):
    """One rank of phase 3 (tp) (a) and (b): llama3-8b's blocks drawn leaf
    by leaf from the seeded generator; the prefill through
    ``make_prefill_step(mesh=)`` (a warm-up, then 3 timed) and the bf16
    serve steps through ``make_serve_step(mesh=)`` from an empty cache
    block, each held to the yardstick on the host."""
    import numpy as np
    import torch

    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _tp_cfg("llama3-8b")
    yard = Path(yard_dir)
    torch.cuda.reset_peak_memory_stats(dev)
    p_sh = shlib.param_shardings(tr.abstract_params(cfg), mesh)
    params = tr.init_params(cfg, seed=0, device=dev, shardings=p_sh)
    rec = {"held_gib": sum(v.numel() * v.element_size() for t in
                           (params, params["blocks"]) for v in t.values()
                           if torch.is_tensor(v)) / 2**30}
    tokens = _tp_tokens(cfg, TP_PREFILL, 1, dev)
    prefill = make_prefill_step(cfg, mesh=mesh, device=dev)
    _reset_all_counts()
    with torch.no_grad():
        logits = prefill(params, {"tokens": tokens})
        times = []
        comm.reset_counts()
        for _ in range(3):
            logits, ms = _tp_clock(dev, lambda: prefill(
                params, {"tokens": tokens}))
            times.append(ms)
    rec["prefill_bytes"] = comm.counts["bytes"] // 3
    rec["prefill_calls"] = {k: v // 3 for k, v in comm.counts.items()
                            if k != "bytes"}
    rec["prefill_ms"] = times
    rec["prefill_err"] = _tp_err(logits, np.load(yard / "prefill.npy"))
    rec["prefill_shape"] = tuple(logits.shape)
    rec.update({f"prefill_{k}": v for k, v in _tp_held(dev).items()})
    del logits
    b, steps = TP_DECODE
    with shlib.rules_context(mesh):
        cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    rec["cache_block"] = tuple(cache.k.shape)
    comm.reset_counts()
    torch.distributed.barrier()
    logits, rec["decode_ms"] = _tp_decode(
        make_serve_step(cfg, mesh=mesh, device=dev), params, cache,
        _tp_tokens(cfg, TP_DECODE, 2, dev))
    rec["decode_bytes"] = comm.counts["bytes"] // steps
    rec["decode_err"] = _tp_worst(logits, np.load(yard / "decode.npy"))
    rec["decode_f32_err"] = _tp_worst(logits,
                                      np.load(yard / "decode_f32.npy"))
    rec["counts"] = _all_counts()
    return rec


def tp_gemma_rank(mesh, yard_dir: str):
    """One rank of phase 3 (tp) (c): gemma-2b in f32 (TF32 off) on its
    rows: ``TP_GEMMA_DECODE``'s decode steps from an empty cache block
    cut by sequence, then the forward at ``TP_GEMMA_FORWARD`` (its
    vocab columns), each held to the yardstick."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _tp_model_cfg("gemma-2b", "float32")
    yard = Path(yard_dir)
    p_sh = shlib.param_shardings(tr.abstract_params(cfg), mesh)
    params = tr.init_params(cfg, seed=0, device=dev, shardings=p_sh)
    data = shlib.axis_index(mesh, shlib.dp_axes())
    b, steps = TP_GEMMA_DECODE
    rows = slice(data * b // 2, (data + 1) * b // 2)
    rec = {}
    _reset_all_counts()
    with shlib.rules_context(mesh):
        cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    rec["cache_block"] = tuple(cache.k.shape)
    rec["slots"] = (int(cache.slots[0]), int(cache.slots[-1]))
    comm.reset_counts()
    torch.distributed.barrier()
    logits, rec["decode_ms"] = _tp_decode(
        make_serve_step(cfg, mesh=mesh, device=dev), params, cache,
        _tp_tokens(cfg, TP_GEMMA_DECODE, 4, dev)[rows])
    rec["decode_bytes"] = comm.counts["bytes"] // steps
    rec["decode_err"] = _tp_worst(
        logits, np.load(yard / "gemma_decode.npy")[:, rows])
    del logits, cache
    tokens = _tp_tokens(cfg, TP_GEMMA_FORWARD, 3, dev)
    with torch.no_grad(), shlib.rules_context(mesh):
        logits, _ = tr.forward(params, cfg, tokens)
    width = logits.shape[-1]
    lo = mesh.get_local_rank("model") * width
    want = np.load(yard / "gemma_forward.npy", mmap_mode="r")
    mine = torch.from_numpy(np.ascontiguousarray(want[..., lo:lo + width]))
    rec["forward_num"] = float((logits - mine.to(dev)).abs().max())
    rec["forward_den"] = float(np.abs(want).max())
    del mine
    rec["forward_shape"] = tuple(logits.shape)
    rec["counts"] = _all_counts()
    rec.update(_tp_held(dev))
    return rec


def tp_train_rank(mesh, yard_dir: str):
    """One rank of phase 3 (tp) (d): qwen2.5-3b's blocks drawn leaf by
    leaf, its AdamW state, ``make_train_step(mesh=, donate=True)`` on
    ``TP_TRAIN_SHAPE``'s batch (the same rows on both ranks): step 0,
    then ``TP_TRAIN_STEPS`` timed steps."""
    import torch

    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.distrib import comm
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _tp_cfg("qwen2.5-3b")
    b, s = TP_TRAIN_SHAPE
    torch.cuda.reset_peak_memory_stats(dev)
    p_sh, _ = tsteps.train_shardings(cfg, mesh)
    params = tr.init_params(cfg, seed=0, device=dev, shardings=p_sh)
    opt = adamw_init(params)
    rec = {"state_gib": torch.cuda.memory_allocated(dev) / 2**30}
    # every rank the whole batch: the ranks differ only in model
    it = BatchIterator(MarkovLMDataset(cfg.vocab, s, branching=4), b,
                       host_index=0, host_count=1)
    batches = [it.next_global(dev) for _ in range(1 + TP_TRAIN_STEPS)]
    step = tsteps.make_train_step(
        cfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                         total_steps=1 + TP_TRAIN_STEPS),
        device=dev, mesh=mesh, donate=True)
    _reset_all_counts()
    (params, opt, m), rec["step0_ms"] = _tp_clock(
        dev, lambda: step(params, opt, batches[0]))
    rec["loss0"], rec["grad_norm0"] = float(m["loss"]), float(m["grad_norm"])
    rec["ms"], rec["losses"] = [], []
    comm.reset_counts()
    for batch in batches[1:]:
        (params, opt, m), ms = _tp_clock(dev, lambda: step(params, opt,
                                                           batch))
        rec["ms"].append(ms)
        rec["losses"].append(float(m["loss"]))
    rec["bytes"] = comm.counts["bytes"] // TP_TRAIN_STEPS
    rec["counts"] = _all_counts()
    rec.update(_tp_held(dev))
    return rec


def tp_cli_cmds(tmp) -> dict:
    """(e)'s commands: the train CLI ``TP_CLI`` on the card over
    ``--mesh 2x2 --backend gloo`` (four ranks sharing it, restarting
    once) and over ``--mesh 1x1``."""
    return {"tp-one": _cli("train", *TP_CLI, "--ckpt-dir", f"{tmp}/tp-one"),
            "tp-four": _cli("train", *TP_CLI, "--mesh", "2x2", "--backend",
                            "gloo", "--ckpt-dir", f"{tmp}/tp-four")}


def tp_cli_check(outs):
    """(e): ``tp_cli_cmds``' runs, the same logged step lines."""
    _cli_ok("train CLI 1x1", outs["tp-one"])
    _cli_ok("train CLI 2x2", outs["tp-four"])
    one, out = _logged(outs["tp-one"].stdout), outs["tp-four"]
    four = _logged(out.stdout)
    done = next(x for x in out.stdout.splitlines() if x.startswith("done:"))
    if (four != one or "restarts=1" not in done or "device=cuda" not in done
            or out.stderr.count("restored at step 3") != 4):
        raise AssertionError(f"train CLI 2x2: {four} vs 1x1 {one}; {done}")
    print(f"  (e) python -m repro_torch.launch.train {' '.join(TP_CLI)} "
          f"--mesh 2x2 --backend gloo: rc 0 in {out.seconds:.1f} s, its "
          f"{len(four)} logged step lines equal --mesh 1x1's to the printed "
          "digits, all four ranks restored at step 3")
    print(f"    {done}")


def tp_cli_on_card():
    """(e) alone: ``tp_cli_cmds`` at once, then ``tp_cli_check``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tp_cli_check(run_at_once(tp_cli_cmds(tmp), Path(tmp) / "logs"))


# Phase 3 (tp) parts (f)-(h): mamba2, the hybrid and whisper on TP_MESH,
# each against its own one-rank yardstick run first in this process
# (kept in TP_YARD_DIR while the ranks run).
TP_SSM_PREFILL = (4, 8192)  # bf16, the mamba2 phase's prefill
TP_SSM_DECODE = (4, 32)  # f32, batch, teacher-forced steps
TP_SSM_TRAIN = (1, 4096)  # bf16, train_4k's seq at a global batch of 1
TP_HYBRID_PREFILL = (1, 8192)  # bf16
TP_HYBRID_DECODE = (4, 32)  # bf16
# whisper-small at TP_LAYERS' depth: encode and prefill at ENCDEC_BATCH,
# the decode steps, in f32 (TF32 off); the train step at
# (ENCDEC_TRAIN_BATCH, 448) in bf16
TP_WHISPER_DECODE = 32
# (f)'s bf16 prefill: at 2e-2 of max |logit| the first run (NVIDIA H100
# 80GB HBM3, 700.00 W) measured 2.025e-2 from the one-rank bf16 prefill
# (its other parts within 6.1e-6 in f32, B7 bit for bit on both ranks),
# bf16's noise through the SSD's long memory (at 8 layers then). So it is held, as (b)'s bf16 decode is, to
# TP_BF16_MULTIPLE times the one-rank bf16 prefill's own distance from
# the one-rank f32 prefill, both against that f32 prefill; its distance
# from the one-rank bf16 prefill is printed beside.


def _tp_model_cfg(arch: str, dtype: str | None = None):
    """``arch`` at phase 3 (tp)'s depth where ``TP_LAYERS`` cuts it, in
    ``dtype`` (its own by default)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if arch in TP_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=TP_LAYERS[arch])
    if cfg.n_encoder_layers:
        cfg = dataclasses.replace(cfg, n_encoder_layers=cfg.n_layers)
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype)


def _tp_family_batches(arch: str, dev):
    """The inputs of (f)-(h), the same in the yardstick and every rank:
    {part: batch}."""
    import torch

    cfg = _tp_model_cfg(arch)
    if arch == "mamba2-780m":
        prefill = _tp_tokens(cfg, TP_SSM_PREFILL, 11, dev)
        decode = _tp_tokens(cfg, TP_SSM_DECODE, 12, dev)
        train = _tp_tokens(cfg, (TP_SSM_TRAIN[0], TP_SSM_TRAIN[1] + 1), 13,
                           dev)
        return {"prefill": {"tokens": prefill}, "decode": decode,
                "train": {"tokens": train[:, :-1], "labels": train[:, 1:]}}
    if arch == "recurrentgemma-9b":
        return {"prefill": {"tokens": _tp_tokens(cfg, TP_HYBRID_PREFILL, 14,
                                                 dev)},
                "decode": _tp_tokens(cfg, TP_HYBRID_DECODE, 15, dev)}
    b, t = ENCDEC_BATCH, cfg.max_target_len
    frames = _frames(cfg, b, dev, 16)
    tokens = _tp_tokens(cfg, (b, t), 17, dev)
    bt = ENCDEC_TRAIN_BATCH
    train = _tp_tokens(cfg, (bt, t + 1), 18, dev)
    return {"prefill": {"tokens": tokens, "frames": frames},
            "decode": tokens[:, :TP_WHISPER_DECODE],
            "train": {"tokens": train[:, :-1], "labels": train[:, 1:],
                      "frames": _frames(cfg, bt, dev, 19).to(torch.bfloat16)}}


def _tp_family_cache(arch: str, cfg, params, batch, dev):
    """An empty decode cache for ``batch`` (this rank's block under an
    installed rule set): whisper's from the encoder's output."""
    from repro_torch.configs.registry import get_model
    from repro_torch.models import encdec

    if arch == "whisper-small":
        return encdec.init_decode_cache(
            params, cfg, encdec.encode(params, cfg, batch["frames"]))
    b, steps = (TP_SSM_DECODE if arch == "mamba2-780m" else TP_HYBRID_DECODE)
    return get_model(cfg).init_decode_cache(cfg, b, steps, device=dev)


def tp_family_yardstick(arch: str, dev, directory: Path) -> dict:
    """The one-rank runs (f)-(h) hold ``arch``'s ranks to, written to
    ``directory``: the prefill's last logits (whisper: also the encoder's
    output), the teacher-forced decode steps' logits and (mamba2,
    whisper) step 0's loss and gradient norm; the model is freed after.
    Returns the host times."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_model
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init

    directory.mkdir(parents=True, exist_ok=True)
    serve_dtype = "float32" if arch == "whisper-small" else None
    cfg = _tp_model_cfg(arch, serve_dtype)
    api = get_model(cfg)
    batches = _tp_family_batches(arch, dev)
    params = api.init_params(cfg, seed=0, device=dev)
    out = {}
    with torch.no_grad():
        prefill = make_prefill_step(cfg, device=dev)
        prefill(params, batches["prefill"])  # warm-up
        logits, out["prefill_ms"] = _tp_clock_one(
            dev, lambda: prefill(params, batches["prefill"]))
        np.save(directory / f"{arch}-prefill.npy", logits.cpu().numpy())
        if arch == "mamba2-780m":
            cfg32 = _tp_model_cfg(arch, "float32")
            f32 = make_prefill_step(cfg32, device=dev)(params,
                                                      batches["prefill"])
            np.save(directory / f"{arch}-prefill_f32.npy", f32.cpu().numpy())
            out["prefill_bf16_vs_f32"] = _tp_err(logits, f32.cpu().numpy())
            del f32
        if arch == "whisper-small":
            enc, out["encode_ms"] = _tp_clock_one(
                dev, lambda: encdec.encode(params, cfg,
                                           batches["prefill"]["frames"]))
            np.save(directory / f"{arch}-encode.npy", enc.cpu().numpy())
            del enc
        del logits
    dcfg = _tp_model_cfg(arch, "float32") if arch == "mamba2-780m" else cfg
    cache = _tp_family_cache(arch, dcfg, params, batches["prefill"], dev)
    logits, out["decode_ms"] = _tp_decode(make_serve_step(dcfg, device=dev),
                                          params, cache, batches["decode"])
    np.save(directory / f"{arch}-decode.npy", logits.cpu().numpy())
    del cache, logits
    if "train" in batches:
        tcfg = _tp_model_cfg(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(tcfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                                                 total_steps=2),
                               device=dev, donate=True)
        opt = adamw_init(params)
        (params, opt, m), out["step0_ms"] = _tp_clock_one(
            dev, lambda: step(params, opt, batches["train"]))
        out["loss"], out["grad_norm"] = (float(m["loss"]),
                                         float(m["grad_norm"]))
        (params, opt, m), out["train_ms"] = _tp_clock_one(
            dev, lambda: step(params, opt, batches["train"]))
        out["train_peak"] = torch.cuda.max_memory_allocated(dev)
        del opt
    del params, batches
    torch.cuda.empty_cache()
    (directory / f"{arch}-yardstick.json").write_text(json.dumps(out))
    return out


def _tp_clock_one(dev, fn):
    """(fn(), ms) on the host clock, one process."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _b7_view_check(x, w) -> dict:
    """B7 (``ops.conv1d_depthwise``, as the path calls it) on the view
    ``x`` a rank's prefill gave it, against the plain version on the same
    view in bf16 (equal bit for bit) and on an f32 copy of the same
    geometry (1e-5): the view's shape, row stride and offset, each
    max |err|."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    base = x._base if x._base is not None else x
    if not base.is_contiguous():
        raise AssertionError("B7's view: its base is not contiguous")
    offset = x.storage_offset() - base.storage_offset()
    rec = {"shape": tuple(x.shape), "row": x.stride(1), "offset": offset}
    got, want = kops.conv1d_depthwise(x, w), ref.conv1d_depthwise(x, w)
    rec["bf16_equal"] = bool(torch.equal(got, want))
    rec["bf16_err"] = rel_err(got, want)[0]
    xf = torch.as_strided(base.float(), x.shape, x.stride(), offset)
    wf = w.float()
    rec["f32_err"], rec["f32_rel"] = rel_err(kops.conv1d_depthwise(xf, wf),
                                             ref.conv1d_depthwise(xf, wf))
    return rec


def tp_family_rank(mesh, arch: str, yard_dir: str):
    """One rank of phase 3 (tp) (f)-(h) for ``arch`` on its blocks (the
    seeded tree, cut by ``param_shardings``): the prefill through
    ``make_prefill_step(mesh=)`` (a warm-up, then one timed; mamba2's B7
    launches counted, its first launch's view kept and checked after),
    the teacher-forced serve steps through ``make_serve_step(mesh=)``
    from an empty cache block (whisper: the encoder's output and its
    cross K/V first), and (mamba2, whisper) step 0 of
    ``make_train_step(mesh=, donate=True)``, each held to the yardstick
    on the host."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_model
    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    yard = Path(yard_dir)
    serve_dtype = "float32" if arch == "whisper-small" else None
    cfg = _tp_model_cfg(arch, serve_dtype)
    api = get_model(cfg)
    batches = _tp_family_batches(arch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    p_sh = shlib.param_shardings(api.abstract_params(cfg), mesh)
    params = shlib.shard_tree(api.init_params(cfg, seed=0, device=dev), p_sh)
    torch.cuda.empty_cache()
    rec = {"held_gib": _bytes(params) / 2**30}
    views = []
    kernel = kops.conv1d_depthwise

    def keep_first(x, w, **kw):
        if not views:
            views.append((x, w))
        return kernel(x, w, **kw)

    prefill = tsteps.make_prefill_step(cfg, mesh=mesh, device=dev)
    with torch.no_grad():
        kops.conv1d_depthwise = keep_first
        try:
            _reset_all_counts()
            prefill(params, batches["prefill"])
            rec["prefill_counts"] = _all_counts()
        finally:
            kops.conv1d_depthwise = kernel
        comm.reset_counts()
        logits, ms = _tp_clock(dev, lambda: prefill(params,
                                                    batches["prefill"]))
        rec["prefill_ms"] = ms
        rec["prefill_bytes"] = comm.counts["bytes"]
        rec["prefill_err"] = _tp_err(logits,
                                     np.load(yard / f"{arch}-prefill.npy"))
        if arch == "mamba2-780m":
            rec["prefill_f32_err"] = _tp_err(
                logits, np.load(yard / f"{arch}-prefill_f32.npy"))
        rec["prefill_shape"] = tuple(logits.shape)
        del logits
        if views:
            rec["view"] = _b7_view_check(*views[0])
            views.clear()
        if arch == "whisper-small":
            with shlib.rules_context(mesh):
                enc, rec["encode_ms"] = _tp_clock(dev, lambda: encdec.encode(
                    params, cfg, batches["prefill"]["frames"]))
            rec["encode_err"] = _tp_err(enc,
                                        np.load(yard / f"{arch}-encode.npy"))
            del enc
    rec["prefill_peak"] = torch.cuda.max_memory_allocated(dev)
    dcfg = (_tp_model_cfg(arch, "float32") if arch == "mamba2-780m"
            else cfg)
    with torch.no_grad(), shlib.rules_context(mesh):
        cache = _tp_family_cache(arch, dcfg, params, batches["prefill"], dev)
    rec["cache_block"] = {k: tuple(v.shape) for k, v in
                          cache._asdict().items() if v.dim() > 0}
    _reset_all_counts()
    comm.reset_counts()
    torch.distributed.barrier()
    logits, rec["decode_ms"] = _tp_decode(
        tsteps.make_serve_step(dcfg, mesh=mesh, device=dev), params, cache,
        batches["decode"])
    rec["decode_counts"] = _all_counts()
    steps = batches["decode"].shape[1]
    rec["decode_bytes"] = comm.counts["bytes"] // steps
    rec["decode_err"] = _tp_worst(logits,
                                  np.load(yard / f"{arch}-decode.npy"))
    del cache, logits
    if "train" in batches:
        tcfg = _tp_model_cfg(arch)
        step = tsteps.make_train_step(
            tcfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=2),
            device=dev, mesh=mesh, donate=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        opt = adamw_init(params)
        (params, opt, m), rec["step0_ms"] = _tp_clock(
            dev, lambda: step(params, opt, batches["train"]))
        rec["loss"], rec["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        _reset_all_counts()
        comm.reset_counts()
        (params, opt, m), rec["train_ms"] = _tp_clock(
            dev, lambda: step(params, opt, batches["train"]))
        rec["train_counts"] = _all_counts()
        rec["train_bytes"] = comm.counts["bytes"]
        rec["train_peak"] = torch.cuda.max_memory_allocated(dev)
        del opt
    rec.update(_tp_held(dev))
    return rec


def tp_b7_row(dev, cfg, view: dict, launches: int, smi: str) -> dict:
    """B7 alone at a tensor-parallel rank's view (its geometry from the
    rank: ``view``), bf16, in this process with the card to itself:
    held to its plain version, timed beside it and
    ``F.conv1d(groups=c)``; the kernels line's row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    b, s, c = view["shape"]
    k = cfg.ssm_conv_kernel
    bw, f32_rate, _ = card_rates(torch.cuda.get_device_name(0))
    x, w = conv_inputs((b, s, c), k, "bfloat16", dev, seed=29,
                       row=view["row"], offset=view["offset"])
    want = ref.conv1d_depthwise(x, w)
    err, _ = rel_err(kops.conv1d_depthwise(x, w), want)
    if not torch.equal(kops.conv1d_depthwise(x, w), want):
        raise AssertionError("B7 at the tp view: not equal to plain")
    ms = time_ms(lambda: kops.conv1d_depthwise(x, w), 20)
    plain_ms = time_ms(lambda: ref.conv1d_depthwise(x, w), 5)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xt = x.transpose(1, 2).contiguous()
        wt = w.t().contiguous()[:, None, :]
        lib_ms = time_ms(
            lambda: F.conv1d(xt, wt, padding=k - 1, groups=c), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    values = (b * (s + k - 1) + k) * c + b * s * c
    t_bytes = values * x.element_size() / bw * 1e3
    t_ops = 2 * k * b * s * c / f32_rate * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  B7 at a tp rank's view {b}x{s}x{c} (row {view['row']}, "
          f"offset {view['offset']}) k={k} bf16, the card to itself: kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})"
          f"  conv1d (groups=c, no TF32) {lib_ms:.4f} ms  max|err| {err:.3e}"
          f" on {smi}")
    del x, w, want, xt, wt
    torch.cuda.empty_cache()
    return {
        "name": f"conv1d_depthwise[mamba2 tp rank xBC {b}x{s}x{c} of row "
                f"{view['row']} k={k}, bfloat16, prefill on (1, 2)]",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
    }


TP_FAMILIES = ("mamba2-780m", "recurrentgemma-9b", "whisper-small")


def tp_mesh_rank(mesh, yard_dir: str):
    """One rank of every part of phase 3 (tp) on ``TP_MESH``, in one
    process (each part's model freed before the next): (a) and (b)
    (``tp_llama_rank``), (d) (``tp_train_rank``), then (f)-(h)
    (``tp_family_rank``). Returns {part: this rank's record}."""
    import torch

    out = {"llama": tp_llama_rank(mesh, yard_dir)}
    torch.cuda.empty_cache()
    out["train"] = tp_train_rank(mesh, yard_dir)
    for arch in TP_FAMILIES:
        torch.cuda.empty_cache()
        out[arch] = tp_family_rank(mesh, arch, yard_dir)
    return out


def tp_families(dev, smi, out: dict) -> list[dict]:
    """(f)-(h) of phase 3 (tp): checks and prints each family's ranks
    against its yardstick (``out``: {arch: (yardstick, ranks' records,
    the yardstick's seconds)}). Returns the kernels line's B7 row."""
    row = []
    for arch, (yard, recs, secs) in out.items():
        cfg = _tp_model_cfg(arch)
        part = {"mamba2-780m": "f", "recurrentgemma-9b": "g"}.get(arch, "h")
        print(f"  ({part}) {arch} at {cfg.n_layers} layers on (1, 2) "
              f"(its yardstick {secs:.1f} s):")
        ssm = arch == "mamba2-780m"
        for rank, r in enumerate(recs):
            b7 = r["prefill_counts"][0]
            want_b7 = cfg.n_layers if ssm else 0
            if r["prefill_counts"] != (want_b7, 0, 0):
                raise AssertionError(f"{arch} rank {rank} prefill launches "
                                     f"(B7, fused-stencil, xcorr1d) "
                                     f"{r['prefill_counts']}")
            if r["decode_counts"] != (0, 0, 0):
                raise AssertionError(f"{arch} rank {rank} decode launches "
                                     f"{r['decode_counts']}")
            dec_tol = (TP_BF16_TOL if arch == "recurrentgemma-9b"
                       else TP_F32_DECODE_TOL)
            pre_tol = (TP_F32_FORWARD_TOL if arch == "whisper-small"
                       else TP_BF16_TOL)
            pre_dtype = "f32" if arch == "whisper-small" else "bf16"
            if ssm:
                own = yard["prefill_bf16_vs_f32"]
                held = (f"from the one-rank f32 prefill "
                        f"{r['prefill_f32_err']:.3e} of max |logit|, "
                        f"{r['prefill_f32_err'] / own:.3f}x the one-rank bf16 "
                        f"prefill's own {own:.3e} (limit "
                        f"{TP_BF16_MULTIPLE}x); from the one-rank bf16 "
                        f"prefill {r['prefill_err']:.3e}")
                good = r["prefill_f32_err"] <= TP_BF16_MULTIPLE * own
            else:
                held = (f"within {r['prefill_err']:.3e} of max |logit| "
                        f"(limit {pre_tol:.0e})")
                good = r["prefill_err"] <= pre_tol
            print(f"    rank {rank}: {r['held_gib']:.2f} GiB of f32 blocks; "
                  f"prefill {tuple(_tp_family_shape(arch, cfg))} {pre_dtype} "
                  f"logits {r['prefill_shape']} {held}; {r['prefill_ms']:.1f}"
                  f" ms (one rank {yard['prefill_ms']:.1f}), "
                  f"{r['prefill_bytes']} bytes sent, peak "
                  f"{r['prefill_peak'] / 2**30:.2f} GiB; B7 launches "
                  f"{b7} ({b7 // cfg.n_layers if ssm else 0} a layer)")
            if not good:
                raise AssertionError(f"{arch} rank {rank} prefill: {r}")
            if arch == "whisper-small":
                print(f"      encode ({ENCDEC_BATCH}, {cfg.encoder_seq}, "
                      f"{cfg.d_model}) f32 within {r['encode_err']:.3e} "
                      f"(limit {TP_F32_FORWARD_TOL:.0e}), {r['encode_ms']:.1f}"
                      f" ms (one rank {yard['encode_ms']:.1f})")
                if not r["encode_err"] <= TP_F32_FORWARD_TOL:
                    raise AssertionError(f"whisper rank {rank} encode: {r}")
            if "view" in r:
                v = r["view"]
                print(f"      B7 on this rank's view {v['shape']} (row "
                      f"{v['row']}, offset {v['offset']}): bf16 "
                      f"{'equal bit for bit' if v['bf16_equal'] else 'DIFFERS'}"
                      f" to the plain version, f32 copy within "
                      f"{v['f32_rel']:.3e} (limit {TOL['float32']:.0e})")
                if not (v["bf16_equal"] and v["f32_rel"] <= TOL["float32"]):
                    raise AssertionError(f"B7 at rank {rank}'s view: {v}")
            steps = _tp_family_steps(arch)
            dec = "f32" if arch != "recurrentgemma-9b" else "bf16"
            print(f"      {steps} teacher-forced {dec} decode steps, cache "
                  f"block {r['cache_block']}: worst step within "
                  f"{r['decode_err']:.3e} (limit {dec_tol:.0e}), "
                  f"{r['decode_ms']:.2f} ms a step (one rank "
                  f"{yard['decode_ms']:.2f}), {r['decode_bytes']} bytes sent "
                  "a step")
            if not r["decode_err"] <= dec_tol:
                raise AssertionError(f"{arch} rank {rank} decode: {r}")
            if "loss" in r:
                loss_rel = abs(r["loss"] - yard["loss"]) / abs(yard["loss"])
                norm_rel = (abs(r["grad_norm"] - yard["grad_norm"])
                            / abs(yard["grad_norm"]))
                want_b7 = 2 * cfg.n_layers if ssm else 0
                print(f"      train step {tuple(_tp_family_train(arch))} bf16 "
                      f"step 0: loss {r['loss']:.4f} vs {yard['loss']:.4f} "
                      f"(rel {loss_rel:.3e}), grad_norm {r['grad_norm']:.4f} "
                      f"vs {yard['grad_norm']:.4f} (rel {norm_rel:.3e}; limit "
                      f"{TP_BF16_TOL:.0e}); step 0 {r['step0_ms']:.1f} ms, "
                      f"step 1 {r['train_ms']:.1f} ms (one rank "
                      f"{yard['step0_ms']:.1f}, {yard['train_ms']:.1f}), "
                      f"{r['train_bytes']} bytes sent in step 1, peak "
                      f"{r['train_peak'] / 2**30:.2f} GiB (one rank "
                      f"{yard['train_peak'] / 2**30:.2f}); B7 launches in "
                      f"step 1 {r['train_counts'][0]}")
                if not (loss_rel <= TP_BF16_TOL and norm_rel <= TP_BF16_TOL
                        and r["train_counts"] == (want_b7, 0, 0)):
                    raise AssertionError(f"{arch} rank {rank} train: {r}")
            print(f"      the card {r['card_used'] / 2**30:.2f} of "
                  f"{r['card_total'] / 2**30:.2f} GiB in use at the end")
        if ssm:
            row.append(tp_b7_row(dev, cfg, recs[0]["view"],
                                 recs[0]["prefill_counts"][0], smi))
    return row


def _tp_family_shape(arch: str, cfg):
    return {"mamba2-780m": TP_SSM_PREFILL,
            "recurrentgemma-9b": TP_HYBRID_PREFILL}.get(
                arch, (ENCDEC_BATCH, cfg.max_target_len))


def _tp_family_steps(arch: str) -> int:
    return {"mamba2-780m": TP_SSM_DECODE[1],
            "recurrentgemma-9b": TP_HYBRID_DECODE[1]}.get(arch,
                                                          TP_WHISPER_DECODE)


def _tp_family_train(arch: str):
    return TP_SSM_TRAIN if arch == "mamba2-780m" else (
        ENCDEC_TRAIN_BATCH, 448)


def phase_tp(dev, smi, cli=True):
    """Phase 3 (tp): the tp profile's model axis at full width over gloo
    ranks sharing this card, each part against a one-rank yardstick
    (``tp_yardstick``, ``tp_family_yardstick``) run first in this
    process; plain PyTorch and collectives (the reference's TP is GSPMD
    over plain ``jnp``): the B1-B7 counters read 0 on every rank of
    (a)-(e), and B7 alone runs in (f), mamba2's conv; (e), the CLIs,
    with ``cli`` (else phase 3 (clis) runs them). Returns the kernels
    line's row of B7 under tensor parallelism."""
    import os
    import shutil

    import torch

    from repro_torch.launch.mesh import run_on_mesh

    print("== phase 3 (tp): tensor parallelism (the tp profile's model "
          "axis) at full width, gloo ranks sharing one card")
    print(f"  card: {smi}")
    print("  depth cut (full width): " + ", ".join(
        f"{a} {n} layers" for a, n in TP_LAYERS.items()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    shutil.rmtree(TP_YARD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        yard = tp_yardstick(dev, TP_YARD_DIR)
        print(f"  yardstick (one rank, this process, {time.perf_counter() - t0:.1f}"
              f" s): llama3-8b prefill {yard['prefill_ms']:.1f} ms, bf16 "
              f"decode {yard['decode_ms']:.2f} ms a step; gemma-2b f32 decode "
              f"{yard['gemma_decode_ms']:.2f} ms a step; qwen2.5-3b step 0 loss "
              f"{yard['loss']:.4f}, grad_norm {yard['grad_norm']:.4f}, "
              f"{yard['train_ms']:.1f} ms, peak "
              f"{yard['train_peak'] / 2**30:.2f} GiB")
        families = {}
        for arch in TP_FAMILIES:
            t1 = time.perf_counter()
            yard_f = tp_family_yardstick(arch, dev, TP_YARD_DIR)
            families[arch] = (yard_f, time.perf_counter() - t1)
            torch.cuda.empty_cache()
        # one process a rank for every part on TP_MESH; the training
        # parts fill the card (a 32 GiB peak each): the ranks' allocators
        # map memory as it grows rather than caching segments
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t1 = time.perf_counter()
        try:
            ranks = run_on_mesh(tp_mesh_rank, *TP_MESH, backend="gloo",
                                device=dev, args=(str(TP_YARD_DIR),),
                                timeout=900)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        print(f"  (a), (b), (d), (f)-(h): one process a rank on (1, 2), "
              f"{time.perf_counter() - t1:.1f} s")
        gemma = run_on_mesh(tp_gemma_rank, *TP_SEQ_MESH, backend="gloo",
                            device=dev, args=(str(TP_YARD_DIR),),
                            timeout=900)
    finally:
        shutil.rmtree(TP_YARD_DIR, ignore_errors=True)
    llama = [r["llama"] for r in ranks]
    train = [r["train"] for r in ranks]
    families = {arch: (yard_f, [r[arch] for r in ranks], secs)
                for arch, (yard_f, secs) in families.items()}
    for label, recs in (("llama3-8b", llama), ("gemma-2b", gemma),
                        ("qwen2.5-3b", train)):
        for rank, r in enumerate(recs):
            if tuple(r["counts"]) != (0, 0, 0):
                raise AssertionError(f"{label} rank {rank}: launches (B7, "
                                     f"fused-stencil, xcorr1d) {r['counts']}")
    b, s = TP_PREFILL
    for rank, r in enumerate(llama):
        med = statistics.median(r["prefill_ms"])
        print(f"  (a) llama3-8b prefill {TP_PREFILL} bf16 on mesh (1, 2), "
              f"rank {rank}: {r['held_gib']:.2f} GiB of f32 blocks; last "
              f"logits {r['prefill_shape']} within {r['prefill_err']:.3e} of "
              f"max |logit| (limit {TP_BF16_TOL:.0e}); {med:.1f} ms (host "
              f"clock after a barrier, median of "
              f"{', '.join(f'{t:.1f}' for t in r['prefill_ms'])}; one rank "
              f"{yard['prefill_ms']:.1f}), {b * s / med * 1e3:.0f} tokens/s; "
              f"{r['prefill_bytes']} bytes sent a prefill ({r['prefill_calls']}"
              f"); peak {r['prefill_peak'] / 2**30:.2f} GiB, the card "
              f"{r['prefill_card_used'] / 2**30:.2f} of "
              f"{r['prefill_card_total'] / 2**30:.2f} GiB in use")
        if not r["prefill_err"] <= TP_BF16_TOL:
            raise AssertionError(f"tp prefill rank {rank}: {r['prefill_err']}")
    b, steps = TP_DECODE
    own = yard["decode_bf16_vs_f32"]
    for rank, r in enumerate(llama):
        print(f"  (b) llama3-8b bf16 serve step on (1, 2), rank {rank}: cache "
              f"block {r['cache_block']} (KV heads cut), {steps} "
              f"teacher-forced steps at batch {b}: worst step from the "
              f"one-rank f32 decode {r['decode_f32_err']:.3e} of max |logit|,"
              f" {r['decode_f32_err'] / own:.3f}x the one-rank bf16 decode's "
              f"own {own:.3e} (limit {TP_BF16_MULTIPLE}x); from the one-rank "
              f"bf16 decode {r['decode_err']:.3e}; {r['decode_ms']:.2f} ms a "
              f"step (one rank {yard['decode_ms']:.2f}), {r['decode_bytes']} "
              "bytes sent a step")
        if not r["decode_f32_err"] <= TP_BF16_MULTIPLE * own:
            raise AssertionError(f"tp decode rank {rank}: "
                                 f"{r['decode_f32_err']} vs {own}")
    b, steps = TP_GEMMA_DECODE
    for rank, r in enumerate(gemma):
        fwd = r["forward_num"] / r["forward_den"]
        print(f"  (c) gemma-2b f32 on (2, 2), rank {rank}: cache block "
              f"{r['cache_block']}, slots {r['slots'][0]}-{r['slots'][1]} "
              f"(cut by sequence); {steps} decode steps, worst within "
              f"{r['decode_err']:.3e} (limit {TP_F32_DECODE_TOL:.0e}), "
              f"{r['decode_ms']:.2f} ms a step (one rank "
              f"{yard['gemma_decode_ms']:.2f}), {r['decode_bytes']} bytes a "
              f"step; forward {TP_GEMMA_FORWARD} logits {r['forward_shape']} "
              f"within {fwd:.3e} (limit {TP_F32_FORWARD_TOL:.0e}); peak "
              f"{r['peak'] / 2**30:.2f} GiB")
        if not (r["decode_err"] <= TP_F32_DECODE_TOL
                and fwd <= TP_F32_FORWARD_TOL):
            raise AssertionError(f"tp gemma rank {rank}: {r}")
    b, s = TP_TRAIN_SHAPE
    for rank, r in enumerate(train):
        loss_rel = abs(r["loss0"] - yard["loss"]) / abs(yard["loss"])
        norm_rel = (abs(r["grad_norm0"] - yard["grad_norm"])
                    / abs(yard["grad_norm"]))
        med = statistics.median(r["ms"])
        print(f"  (d) qwen2.5-3b train step on (1, 2) {b}x{s} bf16, selective "
              f"remat, donated AdamW, rank {rank}: parameters and moments "
              f"{r['state_gib']:.2f} GiB; step 0 loss {r['loss0']:.4f} vs "
              f"{yard['loss']:.4f} (rel {loss_rel:.3e}), grad_norm "
              f"{r['grad_norm0']:.4f} vs {yard['grad_norm']:.4f} (rel "
              f"{norm_rel:.3e}; limit {TP_BF16_TOL:.0e}); steps "
              f"{', '.join(f'{t:.1f}' for t in r['ms'])} ms (step 0 "
              f"{r['step0_ms']:.1f}; one rank {yard['train_ms']:.1f}), "
              f"{b * s / med * 1e3:.0f} tokens/s, losses "
              f"{', '.join(f'{x:.4f}' for x in r['losses'])}; "
              f"{r['bytes']} bytes sent a step; peak {r['peak'] / 2**30:.2f} "
              f"GiB, the card {r['card_used'] / 2**30:.2f} of "
              f"{r['card_total'] / 2**30:.2f} GiB in use")
        if not (loss_rel <= TP_BF16_TOL and norm_rel <= TP_BF16_TOL
                and all(map(math.isfinite, r["losses"]))):
            raise AssertionError(f"tp train rank {rank}: {r}")
        if r["losses"] != train[0]["losses"]:
            raise AssertionError("tp train: the ranks' losses differ")
    if cli:
        tp_cli_on_card()
    print("  B1-B7 launches on every rank of (a)-(d): (0, 0, 0)")
    rows = tp_families(dev, smi, families)
    print("  B1-B6 launches on every rank of (f)-(h): 0; B7 only in (f)'s "
          "prefill and train step")
    return rows


# The MoE family at full width (phase 3 (moe)): qwen3-moe-30b-a3b and
# mixtral-8x7b served, qwen3-moe trained, the card against the CPU on the
# reduced configs, and EP over gloo ranks sharing the card. Depths are cut
# to fit one card beside the f32 weights (qwen3-moe's 48 layers would need
# 113.7 GiB, mixtral's 32 layers 173.9 GiB).
MOE_QWEN_LAYERS = 16  # 39.5 GiB of f32 parameters
MOE_MIXTRAL_LAYERS = 4  # 22.6 GiB
MOE_PREFILL = (1, 8192)  # prefill_32k's sequence cut as llama3-8b's is
# qwen3-moe's train step at train_4k's seq, its batch 256 cut to 1, 4 of
# 48 layers (46.4 GiB of parameters, gradients and AdamW moments): step
# 0, then the others timed.
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_SHAPE = (1, 4096)
MOE_TRAIN_STEPS = 3
# The card against the CPU on the reduced configs: f32 logits, loss,
# decode and gradient leaves within MOE_CPU_TOL relative L2 (TF32 off).
# In bf16 a near-tie in the router can flip an expert between the
# devices, so each bf16 quantity (the logits, the decode steps, the
# gradient as one vector) is held to MOE_BF16_MULTIPLE times the CPU's
# own bf16-to-f32 distance of it (fixed before the first run, as phase 3
# (tp) holds its bf16 decode).
MOE_CPU_TOL = 1e-4
MOE_BF16_MULTIPLE = 1.5
MOE_CPU_SHAPE = (2, 64)
MOE_CPU_DECODE = 8
# EP over two gloo ranks sharing the card: qwen3-moe at 4 layers on mesh
# (1, 2) (64 of the 128 experts a rank), f32 with TF32 off, against the
# one-rank yardstick. The teacher-forced decode steps (batch, steps)
# MOE_EP_DECODE within MOE_EP_DECODE_TOL of max |logit|. The prefill's
# routing at random init is chaotic: 24-88% of (token, choice) pairs are
# dropped by capacity, so a route that flips at a near-tie moves other
# tokens across the capacity line, and attention carries that to every
# later token. The yardstick measures it: the same prefill with every
# embedding value one ulp away. A rank's last logits are held within
# MOE_EP_NUDGE_MULTIPLE times that run's distance, and its routes that
# differ from the yardstick's, layer by layer, within MOE_EP_NUDGE_MULTIPLE
# times that run's plus MOE_EP_TIES (near-ties of the first layer).
MOE_EP_MESH = ((1, 2), ("data", "model"))
MOE_EP_LAYERS = 4
MOE_EP_DECODE = (4, 8)
MOE_EP_DECODE_TOL = 1e-3
MOE_EP_NUDGE_MULTIPLE = 2.0
MOE_EP_TIES = 8
MOE_YARD_DIR = ROOT / "build" / "moe-yardstick"
# MoE groups that span data-parallel ranks (f): mixtral-8x7b at phase 3
# (moe) (b)'s depth, f32 with TF32 off, as gloo ranks sharing the card.
# The prefill MOE_SPAN_PREFILL puts its 512 tokens in one group that
# spans the data ranks (256 a rank), gathered over them; so does each of
# MOE_EP_DECODE's batch-4 decode steps (4 tokens, 2 a rank). Each mesh
# is held to the one-rank run of the same global batch: the routes
# identical, the prefill's last logits within MOE_EP_NUDGE_MULTIPLE times
# the one-ulp-nudged run's distance and the decode within
# MOE_EP_DECODE_TOL (part (e)'s limits).
MOE_SPAN_PREFILL = (2, 256)
MOE_SPAN_MESHES = (((2, 1), ("data", "model")), ((2, 2), ("data", "model")))
MOE_SPAN_YARD_DIR = ROOT / "build" / "moe-span-yardstick"


def _moe_cfg(arch: str, layers: int, **kw):
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers, **kw)


def _n_params(params) -> int:
    from repro_torch.tree import tree_leaves

    return sum(v.numel() for v in tree_leaves(params))


def _dropped(rec) -> str:
    """The dropped share of a ``moe.recording`` dict's (token, choice)
    pairs, as printed."""
    routed, kept = int(rec["routed"]), int(rec["kept"])
    return (f"{routed - kept} of {routed} (token, choice) pairs dropped by "
            f"capacity ({(routed - kept) / max(routed, 1):.2%})")


def moe_serving(dev, smi, arch: str, layers: int, want_calls):
    """``arch`` at full width, ``layers`` deep, random init from a seeded
    generator on the card: the prefill ``MOE_PREFILL`` in bf16 through
    ``make_prefill_step`` (``want_calls``: the chunked attention's
    (q_chunk, kv_chunk), one call a layer), a warm-up then 2 timed; the
    serve loop of ``launch/serve.py`` at batch ``LM_BATCH``, ``LM_STEPS``
    steps; the (token, choice) pairs dropped by capacity in each; the
    B1-B7 counters zeroed before each part and read after, 0."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    cfg = _moe_cfg(arch, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = _n_params(params)
    print(f"  {arch}: {layers} of {get_config(arch).n_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.hd}, qk_norm {cfg.qk_norm}, window {cfg.sliding_window}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} of width "
          f"{cfg.d_ff_expert}, vocab {cfg.vocab}; {n_par} parameters "
          f"(config: {cfg.n_params():.0f}), {n_par * 4 / 2**30:.2f} GiB f32, "
          f"init {time.perf_counter() - t0:.1f} s; {cfg.dtype} compute")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = MOE_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    prefill = make_prefill_step(cfg, device=dev)
    calls, restore = _counting_chunked()
    try:
        with torch.no_grad(), moe.recording() as rec:
            torch.cuda.synchronize()
            _reset_all_counts()
            out = prefill(params, batch)
            torch.cuda.synchronize()
            counts = _no_kernel(f"{arch} prefill")
    finally:
        restore()
    if calls != [want_calls] * layers:
        raise AssertionError(f"{arch} prefill: chunked attention {calls}")
    if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{arch} prefill: bad logits {tuple(out.shape)}")
    times = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    by_layer = [1 - int(k) / int(r) for r, k in rec["calls"]]
    print(f"  prefill {MOE_PREFILL} {cfg.dtype}: {ms:.1f} ms (host clock, "
          f"after a warm-up: {', '.join(f'{t:.1f}' for t in times)}), "
          f"{b * s / ms * 1e3:.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; chunked "
          f"attention {want_calls} in {len(calls)} of {layers} layers; "
          f"{_dropped(rec)}, by layer "
          f"{', '.join(f'{x:.1%}' for x in by_layer)}; launches (B7, "
          f"fused-stencil, xcorr1d) {counts} on {smi}")
    del out, batch
    serve(cfg, batch=LM_BATCH, steps=2, device=dev, params=params)
    _reset_all_counts()
    with moe.recording() as rec:
        gen_tokens, secs = serve(cfg, batch=LM_BATCH, steps=LM_STEPS,
                                 device=dev, params=params)
    counts = _no_kernel(f"{arch} serve")
    if gen_tokens.shape != (LM_BATCH, LM_STEPS + 1) or \
            int(gen_tokens.min()) < 0 or int(gen_tokens.max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {tuple(gen_tokens.shape)}")
    print(f"  serve (launch/serve.py) batch {LM_BATCH}, {LM_STEPS} decode "
          f"steps {cfg.dtype}: {LM_BATCH * LM_STEPS / secs:.1f} tokens/s, "
          f"{1e3 * secs / LM_STEPS:.2f} ms a step (host clock); each step "
          f"groups its {LM_BATCH} new tokens alone (capacity "
          f"{max(int(LM_BATCH * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)}"
          f" a expert): {_dropped(rec)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}")
    print("  first row: " + " ".join(map(str, gen_tokens[0, :12].tolist())))
    del params, prefill
    torch.cuda.empty_cache()


def moe_training(dev, smi):
    """qwen3-moe-30b-a3b's train step at full width, ``MOE_TRAIN_LAYERS``
    deep (bf16 compute on f32 master parameters, selective remat; the
    router's aux in the loss) on ``MarkovLMDataset`` batches at
    ``MOE_TRAIN_SHAPE`` through ``make_train_step(donate=True)``: step
    0's cross-entropy within 1.0 of ln(vocab) and its aux above 0, the
    others timed; the B1-B7 counters 0."""
    import torch

    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _moe_cfg("qwen3-moe-30b-a3b", MOE_TRAIN_LAYERS)
    if cfg.remat != "selective" or cfg.dtype != "bfloat16":
        raise AssertionError(f"config remat {cfg.remat}, dtype {cfg.dtype}")
    b, s = MOE_TRAIN_SHAPE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    state = torch.cuda.memory_allocated()
    card = torch.cuda.get_device_properties(dev).total_memory
    print(f"  {cfg.arch_id} train, {MOE_TRAIN_LAYERS} of 48 layers: "
          f"{_n_params(params)} parameters; parameters and moments "
          f"{state / 2**30:.2f} GiB (with gradients "
          f"{state * 4 / 3 / 2**30:.2f}); batch {b} x seq {s} (train_4k's "
          f"seq, its batch 256 cut to {b}), {cfg.dtype} on f32 master "
          f"weights, remat {cfg.remat}, aux weight {cfg.router_aux_weight}")
    it = BatchIterator(MarkovLMDataset(cfg.vocab, s, branching=4), b)
    batches = [it.next_global(dev) for _ in range(MOE_TRAIN_STEPS)]
    step_fn = make_train_step(
        cfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                         total_steps=MOE_TRAIN_STEPS),
        device=dev, donate=True)
    _reset_all_counts()
    step_ms, first = [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        vals = {k: float(m[k]) for k in ("loss", "xent", "aux", "grad_norm",
                                          "lr")}
        first = first or vals
        step_ms.append(ms)
        print(f"  step {i}: loss {vals['loss']:.4f}  xent {vals['xent']:.4f} "
              f" aux {vals['aux']:.4f}  grad_norm {vals['grad_norm']:.4f}  "
              f"lr {vals['lr']:.3e}  {ms:.1f} ms  {b * s / ms * 1e3:.0f} "
              f"tokens/s  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(map(math.isfinite, vals.values())):
            raise AssertionError(f"moe train step {i}: {vals}")
    counts = _no_kernel("qwen3-moe train steps")
    ln_v = math.log(cfg.vocab)
    if not (abs(first["xent"] - ln_v) <= 1.0 and first["aux"] > 0):
        raise AssertionError(f"step 0: {first}, ln(vocab) {ln_v:.4f}")
    steady = statistics.median(step_ms[1:])
    print(f"  {MOE_TRAIN_STEPS} train steps {b}x{s} {cfg.dtype}: step-0 xent "
          f"{first['xent']:.4f} (ln {cfg.vocab} = {ln_v:.4f}), aux "
          f"{first['aux']:.4f} over {MOE_TRAIN_LAYERS} layers; "
          f"{steady:.1f} ms a step (host clock, median of steps 1-"
          f"{MOE_TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f}), "
          f"{b * s / steady * 1e3:.0f} tokens/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of the "
          f"card's {card / 2**30:.2f}; launches {counts} on {smi}")
    del params, opt, batches, m
    torch.cuda.empty_cache()


def _flips(a: list, b: list) -> int:
    """(token, choice) routes that differ between two recordings."""
    return sum(int((x.cpu() != y.cpu()).sum()) for x, y in zip(a, b,
                                                               strict=True))


def moe_card_vs_cpu(dev):
    """Reduced qwen3-moe-30b-a3b and mixtral-8x7b (8 experts top-2 of 96,
    mixtral's window 16 made a ring by ``MOE_CPU_DECODE`` steps past a
    cache of 4): the card's ``make_prefill_step`` logits, ``forward``
    logits, ``MOE_CPU_DECODE`` decode steps, the loss and every
    ``lm_loss`` gradient leaf against the CPU's on the same parameters;
    f32 within ``MOE_CPU_TOL`` relative L2; bf16 within
    ``MOE_BF16_MULTIPLE`` times the CPU's own bf16-to-f32 distance; the
    flipped (token, choice) routes between the devices counted."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.launch.steps import make_grad_step, make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves_with_path, tree_map

    def run(cfg, params, batch, device, max_len):
        """(prefill logits, forward logits, decode logits, loss, grads as
        one flat vector and by leaf, forward routes) on ``device``."""
        with torch.no_grad():
            pre = make_prefill_step(cfg, device=device)(
                params, {"tokens": batch["tokens"]})
            with moe.recording(keep_routes=True) as rec:
                fwd, _ = tr.forward(params, cfg, batch["tokens"])
            cache = tr.init_decode_cache(cfg, batch["tokens"].shape[0],
                                         max_len, device=device)
            dec = []
            for t in range(MOE_CPU_DECODE):
                lg, cache = tr.decode_step(params, cfg,
                                           batch["tokens"][:, t:t + 1], cache)
                dec.append(lg)
        loss, _, grads = make_grad_step(cfg, device=device)(params, batch)
        leaves = {"/".join(p): g.float().cpu()
                  for p, g in tree_leaves_with_path(grads)}
        flat = torch.cat([g.flatten() for g in leaves.values()])
        return (pre.float().cpu(), fwd.float().cpu(),
                torch.stack(dec).float().cpu(), float(loss), flat, leaves,
                [r.cpu() for r in rec["routes"]])

    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        base = reduced_config(get_config(arch))
        params = tr.init_params(base, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(3)
        b, s = MOE_CPU_SHAPE
        tokens = torch.randint(0, base.vocab, (b, s), generator=gen)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        on_card = tree_map(lambda v: v.to(dev), params)
        batch_card = {k: v.to(dev) for k, v in batch.items()}
        max_len = 4 if base.sliding_window else MOE_CPU_DECODE
        cpu = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            _reset_all_counts()
            want = run(cfg, params, batch, "cpu", max_len)
            got = run(cfg, on_card, batch_card, dev, max_len)
            _no_kernel(f"{arch} {dtype} card vs CPU")
            cpu[dtype] = want
            names = ("prefill", "forward", "decode")
            errs = {n: _rel_l2(g, w) for n, g, w in zip(names, got, want)}
            errs["loss"] = abs(got[3] - want[3]) / abs(want[3])
            errs["gradient"] = _rel_l2(got[4], want[4])
            leaf = max((_rel_l2(got[5][k], want[5][k]), k) for k in want[5])
            flips = _flips(got[6], want[6])
            routes = sum(r.numel() for r in want[6])
            if dtype == "float32":
                limits = {k: MOE_CPU_TOL for k in errs}
                leaf_ok = leaf[0] <= MOE_CPU_TOL
                held = f"limit {MOE_CPU_TOL:.0e}"
            else:
                f32 = cpu["float32"]
                own = {n: _rel_l2(w, f) for n, w, f in
                       zip(names, want, f32)}
                own["loss"] = abs(want[3] - f32[3]) / abs(f32[3])
                own["gradient"] = _rel_l2(want[4], f32[4])
                errs = {n: _rel_l2(g, f) for n, g, f in zip(names, got, f32)}
                errs["loss"] = abs(got[3] - f32[3]) / abs(f32[3])
                errs["gradient"] = _rel_l2(got[4], f32[4])
                limits = {k: MOE_BF16_MULTIPLE * max(own[k], 1e-30)
                          for k in errs}
                leaf_ok = True
                held = (f"from the CPU's f32, limit {MOE_BF16_MULTIPLE}x the "
                        f"CPU bf16's own: " + ", ".join(
                            f"{k} {own[k]:.3e}" for k in own)
                        + f"; flips against the CPU's f32 routes "
                          f"{_flips(want[6], f32[6])} (CPU bf16), "
                          f"{_flips(got[6], f32[6])} (card bf16)")
            ok = leaf_ok and all(errs[k] <= limits[k] for k in errs)
            print(f"  {arch} reduced {dtype}, card vs CPU (TF32 off): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" rel L2; worst gradient leaf {leaf[0]:.3e} ({leaf[1]}) "
                  f"against the CPU {dtype}; {flips} of {routes} forward "
                  f"routes flipped between the devices; {held} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{arch} {dtype} card vs CPU: {errs} vs "
                                     f"{limits}, leaf {leaf}")


def _layer_flips(a, b) -> list[int]:
    """The (token, choice) routes that differ, by layer, between two
    stacked recordings (layers, G, Tg, K)."""
    return [int(n) for n in (a != b).reshape(len(a), -1).sum(1)]


def moe_ep_yardstick(dev, directory: Path) -> dict:
    """The one-rank run (e) holds its ranks to: qwen3-moe at
    ``MOE_EP_LAYERS`` layers in f32, the prefill's last logits at
    ``MOE_PREFILL`` and its routes, and ``MOE_EP_DECODE``'s teacher-forced
    decode steps, written to ``directory``; returns the host times."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    directory.mkdir(parents=True, exist_ok=True)
    cfg = _moe_cfg("qwen3-moe-30b-a3b", MOE_EP_LAYERS, dtype="float32")
    params = tr.init_params(cfg, seed=0, device=dev)
    tokens = _tp_tokens(cfg, MOE_PREFILL, 5, dev)
    prefill = make_prefill_step(cfg, device=dev)
    out = {}
    with torch.no_grad():
        prefill(params, {"tokens": tokens})  # warm-up
        with moe.recording(keep_routes=True) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    np.save(directory / "prefill.npy", logits.cpu().numpy())
    routes = torch.stack(rec["routes"]).cpu().numpy()
    np.save(directory / "routes.npy", routes)
    # the same prefill with every embedding value one ulp away (seeded
    # signs): how far a change at f32's rounding carries at this depth
    gen = torch.Generator(device=dev).manual_seed(7)
    up = torch.rand(params["embed"].shape, generator=gen, device=dev) < 0.5
    nudged = dict(params, embed=torch.nextafter(
        params["embed"], torch.where(up, math.inf, -math.inf)))
    del up
    with torch.no_grad(), moe.recording(keep_routes=True) as rec:
        other = prefill(nudged, {"tokens": tokens})
    del nudged
    out["nudged_err"] = _tp_err(other, logits.cpu().numpy())
    out["nudged_flips"] = _layer_flips(
        torch.stack(rec["routes"]).cpu().numpy(), routes)
    del other
    b, steps = MOE_EP_DECODE
    cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    logits, out["decode_ms"] = _tp_decode(
        make_serve_step(cfg, device=dev), params, cache,
        _tp_tokens(cfg, MOE_EP_DECODE, 6, dev))
    np.save(directory / "decode.npy", logits.cpu().numpy())
    del params, cache, logits, prefill
    torch.cuda.empty_cache()
    return out


def moe_ep_rank(mesh, yard_dir: str):
    """One rank of (e): qwen3-moe's blocks drawn leaf by leaf (64 whole
    experts of 128 a rank, EP), the prefill through
    ``make_prefill_step(mesh=)`` (a warm-up, then one timed) and
    ``MOE_EP_DECODE``'s f32 decode steps through ``make_serve_step(mesh=)``,
    each held to the yardstick on the host."""
    import numpy as np
    import torch

    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _moe_cfg("qwen3-moe-30b-a3b", MOE_EP_LAYERS, dtype="float32")
    yard = Path(yard_dir)
    torch.cuda.reset_peak_memory_stats(dev)
    p_sh = shlib.param_shardings(tr.abstract_params(cfg), mesh)
    params = tr.init_params(cfg, seed=0, device=dev, shardings=p_sh)
    rec = {"held_gib": sum(v.numel() * v.element_size()
                           for v in tree_leaves(params)) / 2**30,
           "experts": tuple(params["blocks"]["moe"]["w_gate"].shape)}
    tokens = _tp_tokens(cfg, MOE_PREFILL, 5, dev)
    prefill = make_prefill_step(cfg, mesh=mesh, device=dev)
    _reset_all_counts()
    with torch.no_grad():
        prefill(params, {"tokens": tokens})
        comm.reset_counts()
        with moe.recording(keep_routes=True) as routes:
            logits, rec["prefill_ms"] = _tp_clock(
                dev, lambda: prefill(params, {"tokens": tokens}))
    rec["prefill_bytes"] = comm.counts["bytes"]
    rec["prefill_calls"] = {k: v for k, v in comm.counts.items()
                            if k != "bytes"}
    rec["prefill_err"] = _tp_err(logits, np.load(yard / "prefill.npy"))
    mine = torch.stack(routes["routes"]).cpu().numpy()
    rec["flips"] = _layer_flips(mine, np.load(yard / "routes.npy"))
    rec["routes"] = int(mine.size)
    rec.update({f"prefill_{k}": v for k, v in _tp_held(dev).items()})
    del logits
    b, steps = MOE_EP_DECODE
    with shlib.rules_context(mesh):
        cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    comm.reset_counts()
    torch.distributed.barrier()
    logits, rec["decode_ms"] = _tp_decode(
        make_serve_step(cfg, mesh=mesh, device=dev), params, cache,
        _tp_tokens(cfg, MOE_EP_DECODE, 6, dev))
    rec["decode_bytes"] = comm.counts["bytes"] // steps
    rec["decode_err"] = _tp_worst(logits, np.load(yard / "decode.npy"))
    rec["counts"] = _all_counts()
    return rec


def moe_ep(dev, smi):
    """(e): EP over ``MOE_EP_MESH``'s two gloo ranks sharing the card,
    against the one-rank yardstick run first in this process."""
    import shutil

    import torch

    from repro_torch.launch.mesh import run_on_mesh

    shutil.rmtree(MOE_YARD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        yard = moe_ep_yardstick(dev, MOE_YARD_DIR)
        print(f"  (e) yardstick (one rank, this process, "
              f"{time.perf_counter() - t0:.1f} s): qwen3-moe {MOE_EP_LAYERS} "
              f"layers f32 prefill {MOE_PREFILL} {yard['prefill_ms']:.1f} ms, "
              f"decode {yard['decode_ms']:.2f} ms a step; with the "
              f"embedding one ulp away the prefill's last logits lie "
              f"{yard['nudged_err']:.3e} of max |logit| from it, routes "
              f"differing by layer {yard['nudged_flips']}")
        torch.cuda.empty_cache()
        ranks = run_on_mesh(moe_ep_rank, *MOE_EP_MESH, backend="gloo",
                            device=dev, args=(str(MOE_YARD_DIR),),
                            timeout=900)
    finally:
        shutil.rmtree(MOE_YARD_DIR, ignore_errors=True)
    b, steps = MOE_EP_DECODE
    for rank, r in enumerate(ranks):
        if tuple(r["counts"]) != (0, 0, 0):
            raise AssertionError(f"moe EP rank {rank}: launches {r['counts']}")
        print(f"  (e) qwen3-moe EP on mesh (1, 2), rank {rank}: expert blocks "
              f"{r['experts']} (layers, experts, d, f), {r['held_gib']:.2f} "
              f"GiB of f32 blocks; prefill {MOE_PREFILL} f32 last logits "
              f"within {r['prefill_err']:.3e} of max |logit| (limit "
              f"{MOE_EP_NUDGE_MULTIPLE}x the nudged run's "
              f"{yard['nudged_err']:.3e}), routes differing from one rank's "
              f"by layer {r['flips']} of {r['routes']}; "
              f"{r['prefill_ms']:.1f} ms (host "
              f"clock after a barrier; one rank {yard['prefill_ms']:.1f}); "
              f"{r['prefill_bytes']} bytes sent a prefill "
              f"({r['prefill_calls']}); {steps} decode steps at batch {b} "
              f"within {r['decode_err']:.3e} (limit "
              f"{MOE_EP_DECODE_TOL:.0e}), {r['decode_ms']:.2f} ms a step (one "
              f"rank {yard['decode_ms']:.2f}), {r['decode_bytes']} bytes sent "
              f"a step; peak {r['prefill_peak'] / 2**30:.2f} GiB, the card "
              f"{r['prefill_card_used'] / 2**30:.2f} of "
              f"{r['prefill_card_total'] / 2**30:.2f} GiB in use")
        flips_ok = all(
            n <= MOE_EP_NUDGE_MULTIPLE * m + MOE_EP_TIES
            for n, m in zip(r["flips"], yard["nudged_flips"], strict=True))
        if not (r["prefill_err"] <= MOE_EP_NUDGE_MULTIPLE * yard["nudged_err"]
                and flips_ok and r["decode_err"] <= MOE_EP_DECODE_TOL):
            raise AssertionError(f"moe EP rank {rank}: {r}")


def moe_span_yardstick(dev, directory: Path) -> dict:
    """The one-rank run (f) holds its meshes to: mixtral at
    ``MOE_MIXTRAL_LAYERS`` layers in f32, the prefill ``MOE_SPAN_PREFILL``'s
    last logits and routes (and the run with the embedding one ulp away),
    ``MOE_EP_DECODE``'s teacher-forced decode logits and routes, written to
    ``directory``; returns the host times and drop counts."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    directory.mkdir(parents=True, exist_ok=True)
    cfg = _moe_cfg("mixtral-8x7b", MOE_MIXTRAL_LAYERS, dtype="float32")
    params = tr.init_params(cfg, seed=0, device=dev)
    tokens = _tp_tokens(cfg, MOE_SPAN_PREFILL, 8, dev)
    prefill = make_prefill_step(cfg, device=dev)
    out = {}
    with torch.no_grad():
        prefill(params, {"tokens": tokens})  # warm-up
        with moe.recording(keep_routes=True) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    out["prefill_drop"] = _dropped(rec)
    np.save(directory / "prefill.npy", logits.cpu().numpy())
    np.save(directory / "routes.npy",
            torch.stack(rec["routes"]).cpu().numpy())
    gen = torch.Generator(device=dev).manual_seed(7)
    up = torch.rand(params["embed"].shape, generator=gen, device=dev) < 0.5
    nudged = dict(params, embed=torch.nextafter(
        params["embed"], torch.where(up, math.inf, -math.inf)))
    del up
    with torch.no_grad():
        other = prefill(nudged, {"tokens": tokens})
    del nudged
    out["nudged_err"] = _tp_err(other, logits.cpu().numpy())
    b, steps = MOE_EP_DECODE
    cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    with moe.recording(keep_routes=True) as rec:
        logits, out["decode_ms"] = _tp_decode(
            make_serve_step(cfg, device=dev), params, cache,
            _tp_tokens(cfg, MOE_EP_DECODE, 9, dev))
    out["decode_drop"] = _dropped(rec)
    np.save(directory / "decode.npy", logits.cpu().numpy())
    np.save(directory / "decode_routes.npy",
            torch.stack(rec["routes"]).cpu().numpy())
    del params, cache, logits, other, prefill
    torch.cuda.empty_cache()
    return out


def moe_span_rank(mesh, yard_dir: str):
    """One rank of (f): mixtral's blocks (whole on (2, 1), EP over
    ``model`` on (2, 2)), this rank's rows of the prefill through
    ``make_prefill_step(mesh=)`` (the group gathered over ``data``) and of
    ``MOE_EP_DECODE``'s decode steps through ``make_serve_step(mesh=)``,
    each with its recorded routes, held to the yardstick on the host."""
    import numpy as np
    import torch

    from repro_torch.distrib import comm
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch.steps import (
        cache_shardings,
        make_prefill_step,
        make_serve_step,
    )
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _moe_cfg("mixtral-8x7b", MOE_MIXTRAL_LAYERS, dtype="float32")
    yard = Path(yard_dir)
    p_sh = shlib.param_shardings(tr.abstract_params(cfg), mesh)
    params = tr.init_params(cfg, seed=0, device=dev, shardings=p_sh)

    def rows(t):
        return shlib.local_shard(
            t, shlib.batch_spec("tokens", tuple(t.shape), mesh),
            mesh).contiguous()

    lo = shlib.axis_index(mesh, "data")
    rec = {"experts": tuple(params["blocks"]["moe"]["w_gate"].shape)}
    tokens = rows(_tp_tokens(cfg, MOE_SPAN_PREFILL, 8, dev))
    prefill = make_prefill_step(cfg, mesh=mesh, device=dev)
    _reset_all_counts()
    with torch.no_grad():
        prefill(params, {"tokens": tokens})
        comm.reset_counts()
        with moe.recording(keep_routes=True) as got:
            logits, rec["prefill_ms"] = _tp_clock(
                dev, lambda: prefill(params, {"tokens": tokens}))
    with shlib.rules_context(mesh):
        rec["batch_ranks"] = shlib.batch_ranks()
    rec["prefill_bytes"] = comm.counts["bytes"]
    rec["prefill_drop"] = _dropped(got)
    n = tokens.shape[0]
    rec["prefill_err"] = _tp_err(
        logits, np.load(yard / "prefill.npy")[lo * n:(lo + 1) * n])
    rec["prefill_flips"] = _layer_flips(
        torch.stack(got["routes"]).cpu().numpy(),
        np.load(yard / "routes.npy"))
    b, steps = MOE_EP_DECODE
    cache = tr.init_decode_cache(cfg, b, steps, device=dev)
    cache = shlib.shard_tree(cache, cache_shardings(cache, mesh))
    toks = rows(_tp_tokens(cfg, MOE_EP_DECODE, 9, dev))
    comm.reset_counts()
    torch.distributed.barrier()
    with moe.recording(keep_routes=True) as got:
        logits, rec["decode_ms"] = _tp_decode(
            make_serve_step(cfg, mesh=mesh, device=dev), params, cache, toks)
    rec["decode_bytes"] = comm.counts["bytes"] // steps
    rec["decode_drop"] = _dropped(got)
    n = toks.shape[0]
    rec["decode_err"] = _tp_worst(
        logits, np.load(yard / "decode.npy")[:, lo * n:(lo + 1) * n])
    rec["decode_flips"] = _layer_flips(
        torch.stack(got["routes"]).cpu().numpy(),
        np.load(yard / "decode_routes.npy"))
    rec["counts"] = _all_counts()
    rec.update(_tp_held(dev))
    return rec


def moe_span(dev, smi):
    """(f): mixtral's MoE groups spanning the data ranks of
    ``MOE_SPAN_MESHES`` (gloo ranks sharing the card), against the
    one-rank yardstick run first in this process."""
    import shutil

    import torch

    from repro_torch.launch.mesh import run_on_mesh

    shutil.rmtree(MOE_SPAN_YARD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        yard = moe_span_yardstick(dev, MOE_SPAN_YARD_DIR)
        print(f"  (f) yardstick (one rank, this process, "
              f"{time.perf_counter() - t0:.1f} s): mixtral "
              f"{MOE_MIXTRAL_LAYERS} layers f32 prefill {MOE_SPAN_PREFILL} "
              f"{yard['prefill_ms']:.1f} ms, {yard['prefill_drop']}; with "
              f"the embedding one ulp away its last logits lie "
              f"{yard['nudged_err']:.3e} of max |logit| from it; decode "
              f"{MOE_EP_DECODE} {yard['decode_ms']:.2f} ms a step, "
              f"{yard['decode_drop']}")
        torch.cuda.empty_cache()
        for shape, axes in MOE_SPAN_MESHES:
            t1 = time.perf_counter()
            ranks = run_on_mesh(moe_span_rank, shape, axes, backend="gloo",
                                device=dev, args=(str(MOE_SPAN_YARD_DIR),),
                                timeout=900)
            secs = time.perf_counter() - t1
            for rank, r in enumerate(ranks):
                flips = sum(r["prefill_flips"]) + sum(r["decode_flips"])
                print(f"  (f) mixtral on mesh {shape}, rank {rank} ({secs:.1f}"
                      f" s for the mesh): batch cut over {r['batch_ranks']} "
                      f"data ranks, expert blocks {r['experts']}; prefill "
                      f"{MOE_SPAN_PREFILL} (one group of "
                      f"{MOE_SPAN_PREFILL[0] * MOE_SPAN_PREFILL[1]} tokens "
                      f"gathered) last logits within {r['prefill_err']:.3e} "
                      f"of max |logit| (limit {MOE_EP_NUDGE_MULTIPLE}x "
                      f"{yard['nudged_err']:.3e}), {r['prefill_drop']}, "
                      f"{r['prefill_ms']:.1f} ms (one rank "
                      f"{yard['prefill_ms']:.1f}), {r['prefill_bytes']} bytes "
                      f"sent; decode {MOE_EP_DECODE} within "
                      f"{r['decode_err']:.3e} (limit {MOE_EP_DECODE_TOL:.0e}),"
                      f" {r['decode_drop']}, {r['decode_ms']:.2f} ms a step "
                      f"(one rank {yard['decode_ms']:.2f}), "
                      f"{r['decode_bytes']} bytes a step; routes differing "
                      f"from one rank's: {flips} (prefill by layer "
                      f"{r['prefill_flips']}, decode {r['decode_flips']}); "
                      f"peak {r['peak'] / 2**30:.2f} GiB on {smi}")
                if (tuple(r["counts"]) != (0, 0, 0) or flips
                        or r["batch_ranks"] != shape[0]
                        or not r["prefill_err"] <= (MOE_EP_NUDGE_MULTIPLE
                                                    * yard["nudged_err"])
                        or not r["decode_err"] <= MOE_EP_DECODE_TOL
                        or r["prefill_drop"] != yard["prefill_drop"]
                        or r["decode_drop"] != yard["decode_drop"]):
                    raise AssertionError(f"moe span {shape} rank {rank}: {r}")
    finally:
        shutil.rmtree(MOE_SPAN_YARD_DIR, ignore_errors=True)


def phase_moe(dev, smi):
    """Phase 3 (moe): the MoE family at full width on the card, plain
    PyTorch (the reference computes the router, the dispatch and the
    experts in ``jnp``, outside any Pallas kernel): (a) qwen3-moe-30b-a3b
    serving, (b) mixtral-8x7b serving (the banded window-4096 attention
    and the ring cache), (c) the card against the CPU on both reduced
    configs, (d) qwen3-moe's train step, (e) EP over two gloo ranks, (f)
    mixtral's groups spanning the data ranks of (2, 1) and (2, 2),
    gathered; the B1-B7 counters read 0 throughout."""
    import torch

    print("== phase 3 (moe): qwen3-moe-30b-a3b and mixtral-8x7b served, "
          "qwen3-moe trained, at full width (plain PyTorch; no kernel of "
          "B1-B7)")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    torch.cuda.empty_cache()
    print("  (a)")
    moe_serving(dev, smi, "qwen3-moe-30b-a3b", MOE_QWEN_LAYERS, (1024, 1024))
    print("  (b)")
    moe_serving(dev, smi, "mixtral-8x7b", MOE_MIXTRAL_LAYERS, (1024, 4096))
    print("  (c)")
    moe_card_vs_cpu(dev)
    print("  (d)")
    moe_training(dev, smi)
    moe_ep(dev, smi)
    moe_span(dev, smi)
    print("  B1-B7 launches in every part: (0, 0, 0)")


# The hybrid family (phase 3 (hybrid)): recurrentgemma-9b served at full
# width and depth (35.7 GiB of f32 parameters), trained at the
# reference's reduced depth (all 38 layers' parameters, gradients and
# AdamW moments would need 142.6 GiB), and the card against the CPU on
# the reduced config.
HYBRID_PREFILL = (1, 8192)  # prefill_32k's sequence, cut as llama3-8b's
HYBRID_CACHE_LENS = (64, 2048, 524288)  # below, at and past the window
HYBRID_TRAIN_LAYERS = 5  # one super-block and two tail blocks
HYBRID_TRAIN_SHAPE = (1, 4096)  # train_4k's seq at a global batch of 1
HYBRID_TRAIN_STEPS = 3
# The card against the CPU (TF32 off): f32 within CARD_CPU_TOL (logits of
# max |logit|, loss and gradients relative); bf16 within BF16_MULTIPLE
# times the CPU's own bf16-to-f32 distance (phase 3 (moe)'s rule); the
# f32 decode against the teacher-forced forward on the card within
# CARD_DECODE_TOL of max |logit| (phase 3 (dense)'s limit).
CARD_CPU_TOL = 1e-4
BF16_MULTIPLE = 1.5
CARD_DECODE_TOL = 1e-3
HYBRID_CPU_SHAPE = (2, 64)
HYBRID_CPU_DECODE = 40  # the reduced window of 16 wraps twice
HYBRID_TRAIN_CLI = ["--arch", "recurrentgemma-9b", "--reduced", "--steps",
                    "8", "--global-batch", "2", "--seq-len", "64",
                    "--ckpt-every", "3", "--simulate-failure-at", "5",
                    "--log-every", "1"]
HYBRID_SERVE_CLI = ["--arch", "recurrentgemma-9b", "--reduced", "--batch",
                    "4", "--steps", "40", "--max-len", "16"]
# The encoder-decoder (phase 3 (encdec)): whisper-small at full size.
ENCDEC_BATCH = 4
ENCDEC_TRAIN_BATCH = 8
ENCDEC_TRAIN_STEPS = 3


def _counting(module, name: str):
    """Wrap ``module.name`` to record each call's args; returns (the list
    of calls, a function that restores it)."""
    calls, plain = [], getattr(module, name)

    def counting(*a, **kw):
        calls.append((a, kw))
        return plain(*a, **kw)

    setattr(module, name, counting)

    def restore():
        setattr(module, name, plain)

    return calls, restore


def _bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(v.numel() * v.element_size() for v in tree_leaves(tree))


def _timed_runs(fn, n: int) -> tuple[float, list[float]]:
    """(median ms, each ms) of ``n`` calls of ``fn`` on the host clock,
    each ending in a synchronize."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


def hybrid_serving(dev, smi):
    """(a): recurrentgemma-9b at full width and depth, random init from a
    seeded generator on the card: the prefill ``HYBRID_PREFILL`` in bf16
    through ``make_prefill_step`` (the banded attention in every
    attention layer, the log-depth scan in every recurrent one), a
    warm-up then 2 timed; the serve loop at batch ``LM_BATCH``; the
    cache's bytes at ``HYBRID_CACHE_LENS``."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import hybrid

    cfg = get_config("recurrentgemma-9b")
    n_super, n_tail, n_att = hybrid.split_layers(cfg.n_layers,
                                                 cfg.hybrid_pattern)
    n_rec = 2 * n_super + n_tail
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = _n_params(params)
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers ({n_super} (rec, rec, "
          f"att) super-blocks, {n_tail} tail rec), d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, LRU width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, window {cfg.local_window}, "
          f"vocab {cfg.vocab}; {n_par} parameters (config: "
          f"{cfg.n_params():.0f}), {n_par * 4 / 2**30:.2f} GiB f32, init "
          f"{time.perf_counter() - t0:.1f} s; {cfg.dtype} compute")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = HYBRID_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    prefill = make_prefill_step(cfg, device=dev)
    calls, restore = _counting_chunked()
    scans, restore_scan = _counting(hybrid, "rg_lru_scan")
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            _reset_all_counts()
            out = prefill(params, batch)
            torch.cuda.synchronize()
            counts = _no_kernel("recurrentgemma-9b prefill")
    finally:
        restore()
        restore_scan()
    lengths = {a[0].shape[1] for a, _ in scans}
    if calls != [(1024, 2048)] * n_att or len(scans) != n_rec or \
            lengths != {s}:
        raise AssertionError(f"prefill: banded attention {calls}, scans "
                             f"{len(scans)} of length {lengths}")
    if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prefill: bad logits {tuple(out.shape)}")
    with torch.no_grad():
        ms, times = _timed_runs(lambda: prefill(params, batch), 2)
    print(f"  prefill {HYBRID_PREFILL} {cfg.dtype}: {ms:.1f} ms (host "
          f"clock, after a warm-up: {', '.join(f'{t:.1f}' for t in times)}"
          f"), {b * s / ms * 1e3:.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; banded "
          f"attention (1024/2048) in {len(calls)} of {n_att} attention "
          f"layers; rg_lru_scan in {len(scans)} of {n_rec} recurrent layers, "
          f"each {math.ceil(math.log2(s))} doubling rounds over (b, l, w) = "
          f"({b}, {s}, {cfg.lru_width}); launches (B7, fused-stencil, "
          f"xcorr1d) {counts} on {smi}")
    del out, batch
    serve(cfg, batch=LM_BATCH, steps=2, device=dev, params=params)
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    gen_tokens, secs = serve(cfg, batch=LM_BATCH, steps=LM_STEPS,
                             device=dev, params=params)
    counts = _no_kernel("recurrentgemma-9b serve")
    if gen_tokens.shape != (LM_BATCH, LM_STEPS + 1) or \
            int(gen_tokens.min()) < 0 or int(gen_tokens.max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {tuple(gen_tokens.shape)}")
    print(f"  serve (launch/serve.py) batch {LM_BATCH}, {LM_STEPS} decode "
          f"steps {cfg.dtype}: {LM_BATCH * LM_STEPS / secs:.1f} tokens/s, "
          f"{1e3 * secs / LM_STEPS:.2f} ms a step (host clock); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}")
    print("  first row: " + " ".join(map(str, gen_tokens[0, :12].tolist())))
    sizes = {}
    for n in HYBRID_CACHE_LENS:
        cache = hybrid.init_decode_cache(cfg, LM_BATCH, n, device=dev)
        sizes[n] = _bytes(cache)
        del cache
    print(f"  decode cache at batch {LM_BATCH} by max_len: " + ", ".join(
        f"{n}: {v} bytes" for n, v in sizes.items())
          + f" (the ring stops at the window of {cfg.local_window})")
    if not sizes[64] < sizes[2048] == sizes[524288]:
        raise AssertionError(f"hybrid cache grows with max_len: {sizes}")
    del params, prefill
    torch.cuda.empty_cache()


def _card_vs_cpu(label, cfg, params, batch, on_card, batch_card, dev,
                 forward, decode):
    """The card against the CPU on one reduced config: in f32 the
    forward's logits (of max |logit|), the loss and every gradient leaf
    (relative) within ``CARD_CPU_TOL``; in bf16 the logits, each token's
    cross-entropy and the gradient, each as one vector, within
    ``BF16_MULTIPLE`` times the CPU's own bf16-to-f32 distance (the
    scalar loss, their mean, is printed: its own bf16 error is one sum
    of signed terms, which can land near 0 by chance);
    ``decode(cfg, params, batch)`` in f32 on the card (its worst step's
    max |err| against the forward, of max |logit|) within
    ``CARD_DECODE_TOL``."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import make_grad_step
    from repro_torch.tree import tree_leaves_with_path

    def run(cfg, params, batch, device):
        with torch.no_grad():
            logits = forward(params, cfg, batch).float()
            xent = (torch.logsumexp(logits, -1) - logits.gather(
                -1, batch["labels"].long()[..., None])[..., 0]).cpu()
        loss, _, grads = make_grad_step(cfg, device=device)(params, batch)
        leaves = {"/".join(p): g.float().cpu()
                  for p, g in tree_leaves_with_path(grads)}
        return logits.cpu(), float(loss), leaves, torch.cat(
            [g.flatten() for g in leaves.values()]), xent

    cpu = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        _reset_all_counts()
        want = run(c, params, batch, "cpu")
        got = run(c, on_card, batch_card, dev)
        _no_kernel(f"{label} {dtype} card vs CPU")
        cpu[dtype] = want
        if dtype == "float32":
            errs = {"logits": float((got[0] - want[0]).abs().max()
                                    / want[0].abs().max()),
                    "loss": abs(got[1] - want[1]) / abs(want[1]),
                    "gradient": max(_rel_l2(got[2][k], want[2][k])
                                    for k in want[2])}
            limits = {k: CARD_CPU_TOL for k in errs}
            held = f"limit {CARD_CPU_TOL:.0e} (gradient: the worst leaf)"
        else:
            f32 = cpu["float32"]
            own = {"logits": _rel_l2(want[0], f32[0]),
                   "token xent": _rel_l2(want[4], f32[4]),
                   "gradient": _rel_l2(want[3], f32[3])}
            errs = {"logits": _rel_l2(got[0], f32[0]),
                    "token xent": _rel_l2(got[4], f32[4]),
                    "gradient": _rel_l2(got[3], f32[3])}
            limits = {k: BF16_MULTIPLE * max(own[k], 1e-30) for k in errs}
            held = (f"from the CPU's f32, limit {BF16_MULTIPLE}x the CPU "
                    "bf16's own: " + ", ".join(f"{k} {v:.3e}"
                                               for k, v in own.items())
                    + f"; the loss {abs(got[1] - f32[1]) / abs(f32[1]):.3e} "
                    f"(the CPU bf16's {abs(want[1] - f32[1]) / abs(f32[1]):.3e})")
        ok = all(errs[k] <= limits[k] for k in errs)
        print(f"  {label} reduced {dtype}, card vs CPU (TF32 off): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; {held} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {dtype} card vs CPU: {errs} vs "
                                 f"{limits}")
    _reset_all_counts()
    steps, worst = decode(dataclasses.replace(cfg, dtype="float32"),
                          on_card, batch_card)
    counts = _no_kernel(f"{label} decode vs forward")
    print(f"  {label} reduced f32 on the card: {steps} decode steps against "
          f"the teacher-forced forward, worst max |err| {worst:.3e} of max "
          f"|logit| (limit {CARD_DECODE_TOL:.0e}); launches {counts} "
          f"{'ok' if worst <= CARD_DECODE_TOL else 'FAIL'}")
    if not worst <= CARD_DECODE_TOL:
        raise AssertionError(f"{label} decode vs forward: {worst:.3e}")


def _decode_worst(full, step_logits) -> float:
    """The worst step's max |err| against the forward, of max |logit|."""
    errs = [(lg - full[:, t]).abs().max() for t, lg in enumerate(step_logits)]
    return float(max(errs) / full.abs().max())


def hybrid_card_vs_cpu(dev):
    """(b): the reduced recurrentgemma-9b, card against CPU."""
    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import hybrid
    from repro_torch.tree import tree_map

    cfg = reduced_config(get_config("recurrentgemma-9b"))
    params = hybrid.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, HYBRID_CPU_SHAPE, generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}

    def forward(p, c, bt):
        return hybrid.forward(p, c, bt["tokens"])[0]

    def decode(c, p, bt):
        toks = bt["tokens"][:, :HYBRID_CPU_DECODE]
        cache = hybrid.init_decode_cache(c, toks.shape[0], 64,
                                         device=toks.device)
        if cache.k.shape[2] * 2 >= HYBRID_CPU_DECODE:
            raise AssertionError(f"the ring of {cache.k.shape[2]} slots does "
                                 f"not wrap twice in {HYBRID_CPU_DECODE}")
        with torch.no_grad():
            full, _ = hybrid.forward(p, c, toks)
            out = []
            for t in range(HYBRID_CPU_DECODE):
                lg, cache = hybrid.decode_step(p, c, toks[:, t:t + 1], cache)
                out.append(lg)
        return HYBRID_CPU_DECODE, _decode_worst(full, out)

    _card_vs_cpu("recurrentgemma-9b", cfg, params, batch,
                 tree_map(lambda v: v.to(dev), params),
                 {k: v.to(dev) for k, v in batch.items()}, dev, forward,
                 decode)


def _train_steps(label, cfg, params, batches, dev, smi, note):
    """``make_train_step(donate=True)`` over ``batches``: each step's
    loss, grad_norm, lr, ms and peak; step 0's cross-entropy within 1.0
    of ln(vocab); the B1-B7 counters 0. Returns the steady ms a step."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    opt = adamw_init(params)
    state = torch.cuda.memory_allocated()
    card = torch.cuda.get_device_properties(dev).total_memory
    b, s = batches[0]["tokens"].shape
    print(f"  {label} train: {_n_params(params)} parameters; parameters and "
          f"moments {state / 2**30:.2f} GiB (with gradients "
          f"{state * 4 / 3 / 2**30:.2f}); batch {b} x seq {s}{note}, "
          f"{cfg.dtype} on f32 master weights, remat {cfg.remat}")
    step_fn = make_train_step(
        cfg, AdamWConfig(lr_peak=3e-4, warmup_steps=1,
                         total_steps=len(batches)),
        device=dev, donate=True)
    _reset_all_counts()
    step_ms, first = [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        vals = {k: float(m[k]) for k in ("loss", "xent", "grad_norm", "lr")}
        first = first or vals
        step_ms.append(ms)
        print(f"  step {i}: loss {vals['loss']:.4f}  grad_norm "
              f"{vals['grad_norm']:.4f}  lr {vals['lr']:.3e}  {ms:.1f} ms  "
              f"{b * s / ms * 1e3:.0f} tokens/s  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(map(math.isfinite, vals.values())):
            raise AssertionError(f"{label} train step {i}: {vals}")
    counts = _no_kernel(f"{label} train steps")
    ln_v = math.log(cfg.vocab)
    if not abs(first["xent"] - ln_v) <= 1.0:
        raise AssertionError(f"{label} step-0 xent {first['xent']:.4f}, "
                             f"ln(vocab) {ln_v:.4f}")
    steady = statistics.median(step_ms[1:])
    print(f"  {len(batches)} train steps {b}x{s} {cfg.dtype}: step-0 xent "
          f"{first['xent']:.4f} (ln {cfg.vocab} = {ln_v:.4f}); "
          f"{steady:.1f} ms a step (host clock, median of steps 1-"
          f"{len(batches) - 1}; step 0 {step_ms[0]:.1f}), "
          f"{b * s / steady * 1e3:.0f} tokens/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of the "
          f"card's {card / 2**30:.2f}; launches {counts} on {smi}")
    del params, opt, m
    torch.cuda.empty_cache()
    return steady


def hybrid_training(dev, smi):
    """(c): the train step at full width, ``HYBRID_TRAIN_LAYERS`` deep."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.models import hybrid

    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, n_layers=HYBRID_TRAIN_LAYERS)
    if cfg.remat != "selective" or cfg.dtype != "bfloat16":
        raise AssertionError(f"config remat {cfg.remat}, dtype {cfg.dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = hybrid.init_params(cfg, seed=0, device=dev)
    b, s = HYBRID_TRAIN_SHAPE
    it = BatchIterator(MarkovLMDataset(cfg.vocab, s, branching=4), b)
    batches = [it.next_global(dev) for _ in range(HYBRID_TRAIN_STEPS)]
    _train_steps("recurrentgemma-9b", cfg, params, batches, dev, smi,
                 f" (train_4k's seq, its batch 256 cut to {b}); "
                 f"{HYBRID_TRAIN_LAYERS} of {full.n_layers} layers (all "
                 f"{full.n_layers}: {full.n_params() * 16 / 2**30:.1f} GiB "
                 "of parameters, gradients and moments)")


def hybrid_cli_cmds(tmp) -> dict:
    """The reduced train CLI (``HYBRID_TRAIN_CLI``: a failure at step 5,
    a restart from its step-3 checkpoint) and serve CLI
    (``HYBRID_SERVE_CLI``)."""
    return {"hybrid-train": _cli("train", *HYBRID_TRAIN_CLI, "--ckpt-dir",
                                 f"{tmp}/hybrid-train"),
            "hybrid-serve": _cli("serve", *HYBRID_SERVE_CLI)}


def hybrid_cli_check(outs):
    """``hybrid_cli_cmds``' runs: rc 0 each, one restart, a finite final
    loss, the serve CLI's generated line."""
    train, serve = outs["hybrid-train"], outs["hybrid-serve"]
    _cli_ok("train CLI", train)
    _cli_ok("serve CLI", serve)
    done = next(x for x in train.stdout.splitlines()
                if x.startswith("done:"))
    final = float(done.split("final loss")[1].split()[0])
    if ("restarts=1" not in done or "device=cuda" not in done
            or not math.isfinite(final)
            or "restored at step 3" not in train.stderr):
        raise AssertionError(f"train CLI: {done!r} / "
                             f"{train.stderr[-500:]}")
    generated = next(x for x in serve.stdout.splitlines()
                     if x.startswith("generated"))
    print(f"  python -m repro_torch.launch.train {' '.join(HYBRID_TRAIN_CLI)}"
          f" and launch.serve {' '.join(HYBRID_SERVE_CLI)}, at once: rc 0 in "
          f"{max(train.seconds, serve.seconds):.1f} s, restored at step 3")
    print(f"    {done}")
    print(f"    serve: {generated} (the ring of 16 slots wrapped)")


def hybrid_clis_on_card():
    """``hybrid_cli_cmds`` on the card at once, then
    ``hybrid_cli_check``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        hybrid_cli_check(run_at_once(hybrid_cli_cmds(tmp),
                                     Path(tmp) / "logs"))


def phase_hybrid(dev, smi, cli=True):
    """Phase 3 (hybrid): recurrentgemma-9b served at full width and depth
    (a), the card against the CPU on the reduced config (b), the train
    step at the reference's reduced depth and, with ``cli`` (else phase 3
    (clis) runs them), the CLIs (c); plain PyTorch, the B1-B7 counters 0
    throughout."""
    import torch

    print("== phase 3 (hybrid): recurrentgemma-9b served at full width and "
          "depth, trained at 5 layers (plain PyTorch; no kernel of B1-B7)")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    torch.cuda.empty_cache()
    print("  (a)")
    hybrid_serving(dev, smi)
    print("  (b)")
    hybrid_card_vs_cpu(dev)
    print("  (c)")
    hybrid_training(dev, smi)
    if cli:
        hybrid_clis_on_card()
    print("  B1-B7 launches in every part: (0, 0, 0)")


def _frames(cfg, b: int, dev, seed: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=dev)


def encdec_serving(dev, smi):
    """(a): whisper-small at full size in bf16: ``encode``, the
    teacher-forced prefill through ``make_prefill_step`` with the frames,
    then ``init_decode_cache`` from the encoder's output and greedy
    decode steps through ``make_serve_step`` to ``max_target_len``
    tokens; ms and peak for each."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import encdec

    cfg = get_config("whisper-small")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_params(cfg, seed=0, device=dev)
    n_par = _n_params(params)
    print(f"  {cfg.arch_id}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab} (tied), {cfg.encoder_seq} frames, "
          f"{cfg.max_target_len} target tokens; {n_par} parameters (config: "
          f"{cfg.n_params():.0f}), {n_par * 4 / 2**30:.2f} GiB f32; "
          f"{cfg.dtype} compute")
    b, t = ENCDEC_BATCH, cfg.max_target_len
    frames = _frames(cfg, b, dev, 1).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=gen, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    step = make_serve_step(cfg, device=dev)
    with torch.no_grad():
        encdec.encode(params, cfg, frames)  # warm-up
        _reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        enc_ms, enc_times = _timed_runs(
            lambda: encdec.encode(params, cfg, frames), 2)
        enc_peak = torch.cuda.max_memory_allocated()
        batch = {"tokens": tokens, "frames": frames}
        out = prefill(params, batch)
        torch.cuda.reset_peak_memory_stats()
        pre_ms, pre_times = _timed_runs(lambda: prefill(params, batch), 2)
        pre_peak = torch.cuda.max_memory_allocated()
        enc = encdec.encode(params, cfg, frames)
        counts = _no_kernel("whisper-small encode and prefill")
        if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"prefill: bad logits {tuple(out.shape)}")
        print(f"  encode ({b}, {cfg.encoder_seq}, {cfg.d_model}) {cfg.dtype}: "
              f"{enc_ms:.1f} ms (host clock, after a warm-up: "
              f"{', '.join(f'{x:.1f}' for x in enc_times)}), peak "
              f"{enc_peak / 2**30:.2f} GiB; prefill (encode and the "
              f"teacher-forced decoder) at tokens ({b}, {t}): {pre_ms:.1f} ms "
              f"({', '.join(f'{x:.1f}' for x in pre_times)}), peak "
              f"{pre_peak / 2**30:.2f} GiB; launches {counts} on {smi}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = encdec.init_decode_cache(params, cfg, enc)
        torch.cuda.synchronize()
        cache_ms = 1e3 * (time.perf_counter() - t0)
        cur = tokens[:, :1]
        seq = [cur]
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(t - 1):
            logits, cache = step(params, cache, {"tokens": cur})
            cur = logits.argmax(-1, keepdim=True)
            seq.append(cur)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _no_kernel("whisper-small decode")
    seq = torch.cat(seq, 1)
    if seq.shape != (b, t) or int(cache.length) != t - 1 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode: {tuple(seq.shape)}, length "
                             f"{int(cache.length)}")
    print(f"  init_decode_cache (cross K/V of {cfg.n_layers} layers, "
          f"{_bytes(cache) / 2**20:.1f} MiB with the self-attention cache): "
          f"{cache_ms:.1f} ms; {t - 1} greedy decode steps at batch {b} to "
          f"{t} tokens: {1e3 * secs / (t - 1):.2f} ms a step (host clock), "
          f"{b * (t - 1) / secs:.1f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}")
    print("  first row: " + " ".join(map(str, seq[0, :12].tolist())))
    del params, cache, enc, prefill, step
    torch.cuda.empty_cache()


def encdec_card_vs_cpu(dev):
    """(b): the reduced whisper-small, card against CPU; the decode over
    every one of its ``max_target_len`` steps."""
    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import encdec
    from repro_torch.tree import tree_map

    cfg = reduced_config(get_config("whisper-small"))
    params = encdec.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, cfg.max_target_len),
                           generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
             "frames": torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                   generator=gen)}

    def forward(p, c, bt):
        return encdec.forward(p, c, bt["tokens"], frames=bt["frames"])[0]

    def decode(c, p, bt):
        with torch.no_grad():
            full = forward(p, c, bt)
            cache = encdec.init_decode_cache(
                p, c, encdec.encode(p, c, bt["frames"]))
            out = []
            for t in range(c.max_target_len):
                lg, cache = encdec.decode_step(p, c,
                                               bt["tokens"][:, t:t + 1], cache)
                out.append(lg)
        return c.max_target_len, _decode_worst(full, out)

    _card_vs_cpu("whisper-small", cfg, params, batch,
                 tree_map(lambda v: v.to(dev), params),
                 {k: v.to(dev) for k, v in batch.items()}, dev, forward,
                 decode)


def encdec_training(dev, smi):
    """(c): the train step at full size, tokens (``ENCDEC_TRAIN_BATCH``,
    448) and frames (``ENCDEC_TRAIN_BATCH``, 1500, 768)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec

    cfg = get_config("whisper-small")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_params(cfg, seed=0, device=dev)
    b, t = ENCDEC_TRAIN_BATCH, cfg.max_target_len
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = []
    for i in range(ENCDEC_TRAIN_STEPS):
        tokens = torch.randint(0, cfg.vocab, (b, t), generator=gen,
                               device=dev)
        batches.append({"tokens": tokens, "labels": tokens.roll(-1, 1),
                        "frames": _frames(cfg, b, dev, 10 + i)})
    _train_steps("whisper-small", cfg, params, batches, dev, smi,
                 f" and frames ({b}, {cfg.encoder_seq}, {cfg.d_model}), "
                 "every layer (the reference has no remat here)")


def phase_encdec(dev, smi):
    """Phase 3 (encdec): whisper-small at full size served (a) and
    trained (c), the card against the CPU on the reduced config (b);
    plain PyTorch, the B1-B7 counters 0 throughout."""
    import torch

    print("== phase 3 (encdec): whisper-small served and trained at full "
          "size (plain PyTorch; no kernel of B1-B7)")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    torch.cuda.empty_cache()
    print("  (a)")
    encdec_serving(dev, smi)
    print("  (b)")
    encdec_card_vs_cpu(dev)
    print("  (c)")
    encdec_training(dev, smi)
    print("  B1-B7 launches in every part: (0, 0, 0)")


def phase_serve(dev, launches):
    """Ensemble serving through ``SimServer`` on each CUDA strategy: a
    warm-up queue of the same size (so the allocator holds full-batch
    blocks), then the 16-request queue with the launch counters zeroed
    just before and read just after, per batch."""
    import collections

    import torch

    from repro_torch.kernels import emit
    from repro_torch.launch.serve_sim import SimServer, check_parity, demo_queue

    print("== phase 3b: ensemble serving (SimServer at its defaults, f32)")
    for strategy, kernel in (("swc", "fused_stencil"), ("swc_stream", STREAM),
                             ("tc", TC)):
        server = SimServer(strategy=strategy, max_batch=SERVE_BATCH,
                           device=dev)
        server.serve(demo_queue(SERVE_SHAPES, SERVE_STEPS, SERVE_REQUESTS,
                                seed=1, device=dev))  # warm-up
        queue = demo_queue(SERVE_SHAPES, SERVE_STEPS, SERVE_REQUESTS,
                           device=dev)
        by_id = {r.req_id: r for r in queue.snapshot()}
        warm = len(server.reports)
        marks = []  # per-kernel launch counts at each batch's start
        server.batch_hook = lambda index, reqs: marks.append(
            collections.Counter(emit.fused_stencil_swc.launches_by_kernel))
        server.request_status.clear()
        torch.cuda.synchronize()
        emit.reset_launch_counts()
        t0 = time.perf_counter()
        results = server.serve(queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        marks.append(collections.Counter(
            emit.fused_stencil_swc.launches_by_kernel))
        reports = server.reports[warm:]
        statuses = {rid: server.request_status.get(rid) for rid in by_id}
        if set(statuses.values()) != {"ok"} or server.error_reports:
            raise AssertionError(f"serve {strategy}: statuses {statuses}, "
                                 f"errors {server.error_reports}")
        if [r.strategy for r in reports] != [strategy] * len(reports):
            raise AssertionError(f"serve {strategy}: batches ran "
                                 f"{[r.strategy for r in reports]}")
        per_batch = [dict(b - a) for a, b in zip(marks, marks[1:])]
        if len(reports) != SERVE_REQUESTS // SERVE_BATCH or per_batch != [
            {kernel: SERVE_STEPS}
        ] * len(reports):
            raise AssertionError(f"serve {strategy}: launches per batch "
                                 f"{per_batch} in {len(reports)} batches")
        err = check_parity(server, by_id, results)
        for r, n in zip(reports, per_batch):  # per bucket: its timed row
            key = f"serve {strategy} {'x'.join(map(str, r.key[0]))}"
            launches[key] = launches.get(key, 0) + sum(n.values())
        member_steps = sum(r.batch for r in reports) * SERVE_STEPS
        print(f"  {strategy}: {len(results)}/{SERVE_REQUESTS} requests ok in "
              f"{len(reports)} batches of {SERVE_BATCH} "
              f"({', '.join('x'.join(map(str, r.key[0])) for r in reports)}), "
              f"{wall:.4f} s, {member_steps / wall:.1f} member-steps/s "
              "(host clock)")
        for r, n in zip(reports, per_batch):
            print(f"    batch {'x'.join(map(str, r.key[0]))}: "
                  f"{r.seconds:.6f} s, "
                  f"{r.seconds / (r.batch * SERVE_STEPS) * 1e3:.4f} ms per "
                  f"member-step, launches {n}")
        print(f"    vs per-member plain version on the card: max|err| "
              f"{err:.3e} (tol 1e-5 of each bucket's largest |value|)")
        del server, results, queue, by_id
        torch.cuda.empty_cache()


# The MMS slope bounds of tests/test_convergence.py:330-389: the fitted
# order within 0.25 below nominal, at most 1.2 above (Dirichlet's offset
# rows superconverge pre-asymptotically); order 8 in f32 is gated on its
# error floor instead (its truncation falls under f32 roundoff).
SLOPE_DEFICIT, SLOPE_EXCESS = 0.25, 1.2
F32_ORDER8_FLOOR = 2e-3
# Kernels of the depth-1 launches, by strategy.
DEPTH1_KERNEL = {"swc": "fused_stencil", "swc_stream": STREAM, "tc": TC}
# The MMS matrix on the card: (strategy, dtype, accuracy, rank, boundary,
# ns) with ns None for the reference's default grids.
MMS_SWEEPS = (
    [(s, "float64", a, rank, b, None)
     for s, ranks in (("swc", (1, 2, 3)), ("swc_stream", (2, 3)))
     for a in (2, 4, 8) for rank in ranks
     for b in ("periodic", "dirichlet")]
    + [(s, "float32", 2, rank, b, (8, 12, 16, 24) if b == "dirichlet"
        else None)
       for s in ("swc", "tc") for rank in (1, 2)
       for b in ("periodic", "dirichlet")]
    + [(s, "float32", 4, rank, b, (8, 12, 16))
       for s in ("swc", "tc") for rank in (1, 2)
       for b in ("periodic", "dirichlet")]
    + [(s, "float32", 8, 1, b, None)
       for s in ("swc", "tc") for b in ("periodic", "dirichlet")]
)
# The MHD RHS at 256³ f32 against the spectral RHS (f64), max |err| over
# max |spectral|: 6th-order truncation is far below f32 roundoff there,
# so this is a floor, independent of the plain version's arithmetic. On
# the H100, tools/spectral_limit.py reads the plain version (hwc:
# ref.fused_stencil on the card) at 1.5875e-5 and 2.8470e-5 over seeds 0
# and 1, the kernels at 1.1778e-5 to 1.9596e-5: the limit is twice the
# plain version's largest reading.
SPECTRAL_TOL_256 = 5.7e-5
SPECTRAL_N = 256
BLEND_SHAPE = (512, 512, 512)


def smooth_fields(n, seed, device, amplitude=1e-2):
    """``MHDSolver.init_smooth(seed, amplitude)`` (``tests/test_physics.py``'s
    ``_smooth_fields`` at amplitude 1e-2) at n³, float64, its cosines
    evaluated on ``device``: the same numpy draws in the same order."""
    import numpy as np
    import torch

    from repro_torch.physics.mhd import N_FIELDS

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.linspace(0, 2 * np.pi, n, endpoint=False),
                        device=device)
    zz, yy, xx = x[:, None, None], x[None, :, None], x[None, None, :]
    f = torch.zeros((N_FIELDS, n, n, n), dtype=torch.float64, device=device)
    for fi in range(N_FIELDS):
        for _ in range(3):
            k = rng.integers(-2, 3, size=3)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0) * amplitude
            f[fi] += amp * torch.cos(
                int(k[0]) * zz + int(k[1]) * yy + int(k[2]) * xx + ph)
    return f


def mms_sweep(dev, strategy, dtype, accuracy, rank, boundary, ns):
    """One MMS sweep through ``strategy``'s kernel, the launch counters
    zeroed just before and read just after, then each grid's kernel
    output held to its plain version on the card (``ref.fused_stencil``,
    as the kernel rounds: ``tc=True`` on ``tc``; the same blend after
    it). The f32 Laplacian at these grids cancels terms up to ~1e3 times
    its value, so the difference is taken relative to the sums' own
    scale, Σ|tap| · max|f|. Returns (result, the plain version's slope,
    tiles, launches by kernel, largest relative difference)."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels import emit, ref
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.verify import mms

    torch.cuda.synchronize()
    emit.reset_launch_counts()
    res = mms.run_convergence(rank, accuracy, boundary, dtype=dtype,
                              strategy=strategy, ns=ns, device=dev)
    torch.cuda.synchronize()
    by_kernel = dict(emit.fused_stencil_swc.launches_by_kernel)
    tiles, plain_errors, worst = [], [], 0.0
    for n in res.ns:
        f, lap, h = mms.manufactured_solution(rank, boundary, n, dtype, dev)
        op = mms.laplacian_op(rank, accuracy, h, boundary, strategy=strategy,
                              boundary_weights=res.boundary_weights,
                              device=dev)
        got = op(f)
        r = op.radius_per_axis
        fp = pad(f, r, boundary, spatial_axes=range(1, rank + 1))
        want = ref.fused_stencil(fp, op.ops, op.phi.torch_fn,
                                 tc=strategy == "tc")
        if res.boundary_weights:
            op.blend_boundary_weights(f, want)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"MMS {strategy} n={n}: bad output")
        scale = sum(abs(c) for c in op.ops.ops[0].coeffs) * float(
            f.abs().max())
        rel = float((got - want).abs().max()) / scale
        if rel > TOL[dtype]:
            raise AssertionError(
                f"MMS {strategy} {dtype} order {accuracy} rank {rank} "
                f"{boundary} n={n}: kernel vs plain {rel:.3e} of the sums' "
                f"scale > {TOL[dtype]}")
        worst = max(worst, rel)
        plain_errors.append(mms.normalized_rms_error(want, lap))
        tiles.append(plan_for_nd(op.ops, tuple(fp.shape), 1,
                                 strategy=strategy, dtype=dtype).block)
    return (res, mms.fit_slope(res.hs, plain_errors), tiles, by_kernel,
            worst)


def phase_verify(dev, smi):
    """The verification layer on the card (``repro_torch.verify``,
    ``physics.spectral``, ``boundary_weights``): the MMS slope gates
    through B1, B3 and B4, the spectral oracle, and the dirichlet blend
    at full size."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.core.fusion import FusedStencilOp
    from repro_torch.core.stencil import OperatorSet, laplacian_stencil
    from repro_torch.kernels.phi import select_phi
    from repro_torch.physics.mhd import MHDSolver, mhd_rhs_phi
    from repro_torch.physics.spectral import spectral_rhs
    from repro_torch.verify import run_convergence

    print("== phase 3 (verify): MMS slopes, the spectral oracle and the "
          "boundary-weight blend on the card")
    t0 = time.perf_counter()
    for strategy, dtype, acc, rank, boundary, ns in MMS_SWEEPS:
        res, plain_slope, tiles, by_kernel, worst = mms_sweep(
            dev, strategy, dtype, acc, rank, boundary, ns)
        want = {DEPTH1_KERNEL[strategy]: len(res.ns)}
        if by_kernel != want:
            raise AssertionError(f"MMS {strategy}: launches {by_kernel}, "
                                 f"want {want}")
        floor = dtype == "float32" and acc == 8
        if floor:
            ok = max(res.errors) <= F32_ORDER8_FLOOR
            gate = (f"max err {max(res.errors):.3e} (floor "
                    f"{F32_ORDER8_FLOOR:.0e})")
        else:
            ok = acc - SLOPE_DEFICIT <= res.slope <= acc + SLOPE_EXCESS
            gate = (f"slope {res.slope:.4f} (nominal {acc}, bounds "
                    f"[{acc - SLOPE_DEFICIT}, {acc + SLOPE_EXCESS}])")
        print(f"  MMS {strategy:<10} {dtype} order {acc} rank {rank} "
              f"{boundary:<9} n {res.ns}: {gate}; plain slope "
              f"{plain_slope:.4f}; tiles {tiles}; launches {by_kernel}; "
              f"vs plain {worst:.3e} of the sums' scale "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"MMS gate failed: {res}")
    lo = run_convergence(1, 6, "neumann", strategy="swc", device=dev)
    hi = run_convergence(1, 6, "neumann2", strategy="swc", device=dev)
    print(f"  MMS swc float64 order 6 rank 1 ghost fill: neumann slope "
          f"{lo.slope:.4f} (< 1.2), neumann2 {hi.slope:.4f} (> 4.0), gap "
          f"{hi.slope - lo.slope:.4f} (> 2)")
    if not (lo.slope < 1.2 and hi.slope > 4.0 and hi.slope - lo.slope > 2):
        raise AssertionError(f"neumann ghost-fill gap: {lo}, {hi}")
    print(f"  [MMS sweeps: {time.perf_counter() - t0:.1f} s]")

    # The spectral oracle: tests/test_physics.py's 6th-order gate.
    for strategy in ("swc", "swc_stream"):
        errs = {}
        for n in (16, 32):
            solver = MHDSolver((n,) * 3, strategy=strategy, device=dev)
            f = smooth_fields(n, 0, dev)
            rhs, _, by_depth = counted(lambda: solver.rhs(f),
                                       kernel=DEPTH1_KERNEL[strategy])
            if by_depth != {1: 1}:
                raise AssertionError(f"spectral {strategy}: {by_depth}")
            sp = spectral_rhs(f, solver.spacing, mhd_rhs_phi(solver.params))
            errs[n] = float((rhs - sp).abs().max() / sp.abs().max())
        order = math.log2(errs[16] / errs[32])
        print(f"  MHD RHS f64 {strategy} vs spectral: 16^3 {errs[16]:.4e}, "
              f"32^3 {errs[32]:.4e} (< 5e-4), order {order:.4f} (> 5)")
        if not (errs[32] < 5e-4 and order > 5.0):
            raise AssertionError(f"spectral oracle on {strategy}: {errs}")

    # The main path's size: MHD RHS at 256³ f32 against the f64 spectral
    # RHS, on each kernel and on the plain version.
    n = SPECTRAL_N
    f64 = smooth_fields(n, 0, dev)
    solver = MHDSolver((n,) * 3, strategy="hwc", device=dev)
    sp = spectral_rhs(f64, solver.spacing, mhd_rhs_phi(solver.params))
    scale = float(sp.abs().max())
    f = f64.float()
    del f64
    for strategy in ("hwc", "swc", "swc_stream", "tc"):
        solver = MHDSolver((n,) * 3, strategy=strategy, device=dev)
        kernel = DEPTH1_KERNEL.get(strategy)
        rhs, _, by_depth = counted(lambda: solver.rhs(f), kernel=kernel)
        if by_depth != ({1: 1} if kernel else {}):
            raise AssertionError(f"{n}^3 {strategy}: launches {by_depth}")
        if not bool(torch.isfinite(rhs).all()):
            raise AssertionError(f"{n}^3 {strategy}: non-finite RHS")
        err = float((rhs.double() - sp).abs().max()) / scale
        ok = err <= SPECTRAL_TOL_256
        print(f"  MHD RHS {n}^3 f32 {strategy:<10} vs spectral f64: rel "
              f"{err:.4e} (tol {SPECTRAL_TOL_256:.3e}) launches {by_depth} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{n}^3 spectral check on {strategy}")
        del rhs
    del sp, f
    torch.cuda.empty_cache()

    # Full width for the blend: the order-6 Laplacian at 512³ f32,
    # dirichlet, boundary_weights=True.
    n = BLEND_SHAPE[0]
    ops = OperatorSet((laplacian_stencil(3, 6, spacing=1.0 / (n - 1)),))
    r = ops.radius_per_axis()
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn((1,) + BLEND_SHAPE, generator=gen, device=dev)
    fp = pad(f, r, "dirichlet", spatial_axes=range(1, 4))
    kw = dict(boundary_mode="dirichlet", device=dev)
    want = FusedStencilOp(ops, select_phi("lap"), 1, boundary_weights=True,
                          **kw)(f)
    inner = (slice(None),) + tuple(slice(ri, m - ri)
                                   for ri, m in zip(r, BLEND_SHAPE))
    print(f"  blend at {'x'.join(map(str, BLEND_SHAPE))} f32, order-6 "
          f"Laplacian, dirichlet, boundary_weights=True ({smi}):")
    for strategy in ("swc", "swc_stream", "tc"):
        op = FusedStencilOp(ops, select_phi("lap"), 1, strategy=strategy,
                            boundary_weights=True, **kw)
        bare = FusedStencilOp(ops, select_phi("lap"), 1, strategy=strategy,
                              **kw)
        got, _, by_depth = counted(lambda: op(f),
                                   kernel=DEPTH1_KERNEL[strategy])
        if by_depth != {1: 1}:
            raise AssertionError(f"blend {strategy}: launches {by_depth}")
        check(f"blend {strategy} vs plain with the blend", got, want,
              "float32")
        unblended = bare(f)
        if not torch.equal(got[inner], unblended[inner]):
            raise AssertionError(f"blend {strategy}: the interior differs "
                                 "from the launch without the blend")
        if torch.equal(got, unblended):
            raise AssertionError(f"blend {strategy}: nothing was blended")
        out = op.apply_padded(fp)
        kernel_ms = time_ms(lambda: op.apply_padded(fp), reps=10)
        blend_ms = time_ms(lambda: op.blend_boundary_weights(f, out),
                           reps=10)
        step_ms = time_ms(lambda: op(f), reps=10)
        print(f"    {strategy:<10} launches {by_depth}; interior equal to "
              f"the unblended launch bit for bit; kernel {kernel_ms:.4f} ms, "
              f"blend {blend_ms:.4f} ms, step (pad + kernel + blend) "
              f"{step_ms:.4f} ms, blend share {blend_ms / step_ms:.1%}")
        del got, unblended, out
    del f, fp, want
    torch.cuda.empty_cache()


# Phase 3 (tune): the tuner's "auto" forms at the main path's sizes, on a
# fresh cache under build/ (chaos on a cache of its own beside it).
TUNE_CACHE = ROOT / "build" / "tune-cache"
TUNE_DIFFUSION = ((512, 512, 512), (8192, 8192), (1 << 26,))
TUNE_MHD = (256, 256, 256)
TUNE_XCORR = (1 << 24, 1024, "elementwise", 4)  # n, r, strategy, unroll


def tune_calls(dev) -> tuple[dict, list, object, dict]:
    """Every tuning call of phase 3 (tune), in order: ``block="auto"``
    (512³ ``swc``), ``fuse_steps="auto"`` (512³ ``swc``),
    ``strategy="auto"`` with ``fuse_steps="auto"`` (diffusion 512³,
    8192², 2^26), the MHD RHS's ``strategy="auto"`` (256³ f32), B6's
    ``block_size="auto"`` (2^24, r = 1024), then ``SimServer(strategy=
    "auto")`` on phase 3b's queue and ``serve_sim --smoke --auto-tune``.
    Returns ({case: decision}, cases, the server, its results); a case is
    (name, tuned launch, plain version, dtype, its record, the labels of
    the planner's own tiles) — the launches are not run here, so a
    replay in another process re-derives the decisions alone."""
    import torch

    from repro_torch.core import boundary
    from repro_torch.core.fusion import integrate
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import serve_sim
    from repro_torch.launch.serve_sim import SimServer, demo_queue
    from repro_torch.physics.diffusion import DiffusionProblem
    from repro_torch.physics.mhd import MHDSolver
    from repro_torch.tuning import TuningKey, current_backend, session
    from repro_torch.tuning.cache import candidate_label
    from repro_torch.tuning.session import lookup_fused_nd, phi_traits

    decisions, cases = {}, []

    def defaults(op, shape, strategies, depths):
        """Labels of the planner's own tiles, one per (strategy, depth)."""
        traits = phi_traits(op.phi)
        out = []
        for strategy in strategies:
            for depth in depths:
                padded = (shape[0],) + tuple(
                    n + 2 * r * depth
                    for n, r in zip(shape[1:], op.ops.radius_per_axis()))
                try:
                    plan = kops.plan_for_nd(
                        op.ops, padded, op.n_out, strategy=strategy,
                        fuse_steps=depth, max_threads=traits["max_threads"],
                        n_slots=traits["n_slots"])
                except (ValueError, NotImplementedError):
                    continue
                out.append(candidate_label(
                    plan.block, depth, strategy == "swc_stream", strategy))
        return out

    p = DiffusionProblem(TUNE_DIFFUSION[0])
    f = p.init_field(device=dev)
    base = p.step_op("hwc", device=dev)
    swc = p.step_op("swc", device=dev)
    fp = boundary.pad(f, [p.radius] * 3, "periodic", spatial_axes=(1, 2, 3))
    block = session.auto_block_nd(fp, swc.ops, swc.phi, 1, strategy="swc")
    name = "block=auto 512^3 swc"
    decisions[name] = block
    cases.append((name, lambda: p.step_op("swc", block, device=dev)(f),
                  lambda: base(f), "float32",
                  lambda: lookup_fused_nd(f, base.ops, 1, "swc"),
                  defaults(swc, f.shape, ("swc",), (1,))))
    rop = p.step_op("swc", block="auto", fuse_steps="auto",
                    device=dev).resolved(f)
    name = "fuse_steps=auto 512^3 swc"
    decisions[name] = (rop.block, rop.fuse_steps)
    cases.append((name, lambda: rop(f),
                  lambda: integrate(base, f, rop.fuse_steps), "float32",
                  lambda: lookup_fused_nd(f, base.ops, 1, "swc",
                                          fuse_steps="auto"),
                  defaults(swc, f.shape, ("swc",), (1, 2, 3, 4))))
    for shape in TUNE_DIFFUSION:
        q = DiffusionProblem(shape)
        fq = f if shape == TUNE_DIFFUSION[0] else q.init_field(device=dev)
        r_ = q.step_op("auto", fuse_steps="auto", device=dev).resolved(fq)
        name = f"strategy=auto {'x'.join(map(str, shape))}"
        decisions[name] = (r_.strategy, r_.block, r_.fuse_steps)
        plain = q.step_op("hwc", device=dev)
        strategies = ("swc", "tc") + (("swc_stream",) if len(shape) > 1
                                      else ())
        cases.append((
            name, lambda r_=r_, fq=fq: r_(fq),
            lambda plain=plain, r_=r_, fq=fq: integrate(
                plain, fq, r_.fuse_steps), "float32",
            lambda fq=fq, plain=plain: lookup_fused_nd(
                fq, plain.ops, 1, "auto", fuse_steps="auto"),
            defaults(q.step_op("swc", device=dev), fq.shape, strategies,
                     (1, 2, 3, 4))))
    solver = MHDSolver(TUNE_MHD, strategy="auto", device=dev)
    fm = solver.init_fields()
    rhs = solver.rhs_op()
    r_m = rhs.resolved(fm)
    name = "strategy=auto MHD rhs 256^3"
    decisions[name] = (r_m.strategy, r_m.block, r_m.fuse_steps)
    plain_m = MHDSolver(TUNE_MHD, strategy="hwc", device=dev)
    cases.append((name, lambda: r_m(fm), lambda: plain_m.rhs(fm), "float32",
                  lambda: lookup_fused_nd(fm, rhs.ops, 8, "auto"),
                  defaults(rhs, fm.shape, ("swc", "swc_stream", "tc"),
                           (1,))))
    n, r, xs, xu = TUNE_XCORR
    fx, gx = xcorr_inputs(n, r, "float32", dev)
    bs = session.auto_block_xcorr1d(fx, gx, strategy=xs, unroll=xu)
    name = f"block_size=auto xcorr 2^24 r={r}"
    decisions[name] = bs
    xkey = TuningKey("xcorr1d", f"{xs}:u{xu}", (n,), (2 * r,), 1, 1,
                     "float32", current_backend(dev))
    cases.append((name,
                  lambda: kops.xcorr1d(fx, gx, strategy=xs, block_size=bs,
                                       unroll=xu),
                  lambda: ref.xcorr1d(fx, gx), "float32",
                  lambda: session.default_session().cache.get(xkey),
                  [str(session.XCORR_DEFAULT_BLOCK)]))
    server = SimServer(strategy="auto", max_batch=SERVE_BATCH, device=dev)
    results = server.serve(demo_queue(SERVE_SHAPES, SERVE_STEPS,
                                      SERVE_REQUESTS, device=dev))
    decisions["SimServer(strategy=auto)"] = sorted(
        (c.strategy, c.block, c.fuse_steps) for op in server._ops.values()
        for c in op._resolved.values())
    decisions["SimServer(strategy=auto) statuses"] = sorted(
        set(server.request_status.values()))
    serve_sim.main(["--smoke", "--auto-tune", "--device", str(dev)])
    torch.cuda.synchronize()
    return decisions, cases, server, results


def phase_tune(dev, smi):
    """The tuner on the card: each ``"auto"`` form of ``tune_calls`` on a
    fresh cache; every record measured with no failed row; each tuned
    launch held to its plain version; each case's winner printed beside
    the planner's own tiles (the hand-set choice) and every record's
    timing table; ``serve_sim --chaos`` on a cache of its own; a
    subprocess replays every call with no measurement."""
    import os
    import shutil

    import torch

    from repro_torch.launch import serve_sim
    from repro_torch.launch.serve_sim import check_parity, demo_queue
    from repro_torch.tuning import TuningCache, session
    from repro_torch.tuning.cache import ENV_VAR

    print("== phase 3 (tune): block, fuse_steps and strategy='auto' "
          "measured on the card")
    shutil.rmtree(TUNE_CACHE, ignore_errors=True)
    os.environ[ENV_VAR] = str(TUNE_CACHE)
    t0 = time.perf_counter()
    decisions, cases, server, results = tune_calls(dev)
    print(f"  tuning calls: {time.perf_counter() - t0:.1f} s, "
          f"{session.MEASURE_COUNT} measurements")
    records = TuningCache().items()
    for key, rec in sorted(records.items()):
        if rec.source != "measured" or rec.failed:
            raise AssertionError(f"{key}: source {rec.source}, failed "
                                 f"{rec.failed}")
        win = rec.winner_label
        print(f"  {key}: winner {win} {rec.timings_us[win]:.1f} us")
        for label, us in sorted(rec.timings_us.items(), key=lambda kv: kv[1]):
            print(f"    {label:>22s} {us:12.1f} us"
                  + ("  <-- winner" if label == win else ""))
    for name, tuned, plain, dtype, record, labels in cases:
        rec = record()
        win = rec.winner_label
        hand = ", ".join(f"{x} {rec.timings_us[x]:.1f} us" for x in labels
                         if x in rec.timings_us)
        print(f"  {name}: winner {win} {rec.timings_us[win]:.1f} us; "
              f"planner's tile {hand}")
        got, want = tuned(), plain()
        check(f"tuned {name}", got, want, dtype)
        del got, want
        if name.startswith("strategy=auto") and decisions[name][0] == "hwc":
            raise AssertionError(f"{name}: the plain version won")
    served = decisions["SimServer(strategy=auto)"]
    if any(d[0] == "hwc" for d in served) or decisions[
            "SimServer(strategy=auto) statuses"] != ["ok"]:
        raise AssertionError(f"SimServer(strategy='auto'): {served}, "
                             f"{decisions['SimServer(strategy=auto) statuses']}")
    by_id = {r.req_id: r for r in demo_queue(
        SERVE_SHAPES, SERVE_STEPS, SERVE_REQUESTS, device=dev).snapshot()}
    err = check_parity(server, by_id, results)
    print(f"  SimServer(strategy='auto'): {served}, every request ok, vs "
          f"per-member plain version max|err| {err:.3e}")
    # What "auto" adds to a served batch once its bucket is warm: the
    # op's resolution by lookup (host clock, no launch).
    for op in server._ops.values():
        for sig in list(op._resolved):
            x = torch.empty(sig[0], dtype=sig[1], device=sig[2])
            t1 = time.perf_counter()
            for _ in range(1000):
                op.resolved(x)
            us = (time.perf_counter() - t1) * 1e3
            print(f"  warm resolution of strategy='auto' at "
                  f"{'x'.join(map(str, sig[0]))}: {us:.2f} us per batch")
    del server, results, cases
    torch.cuda.empty_cache()
    # The replay: the same calls in a fresh process, nothing measured,
    # the same decisions, the cache file untouched.
    before = (TUNE_CACHE / "cache.json").read_bytes()
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[1] + '/src'); "
            "import chip_smoke, repro_torch; "
            "from repro_torch.tuning import session; "
            "d = chip_smoke.tune_calls(repro_torch.default_device())[0]; "
            "print('REPLAY', session.MEASURE_COUNT, "
            "json.dumps({k: repr(v) for k, v in d.items()}))")
    t1 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True,
                         env={**os.environ, ENV_VAR: str(TUNE_CACHE)})
    if out.returncode:
        raise AssertionError(f"replay failed: {out.stderr[-2000:]}")
    line = next(x for x in out.stdout.splitlines() if x.startswith("REPLAY"))
    _, count, blob = line.split(" ", 2)
    replayed = json.loads(blob)
    if int(count) != 0 or replayed != {k: repr(v)
                                        for k, v in decisions.items()}:
        raise AssertionError(f"replay measured {count} or differs: "
                             f"{replayed}")
    if (TUNE_CACHE / "cache.json").read_bytes() != before:
        raise AssertionError("the replay wrote to the cache")
    print(f"  replay in a subprocess: {len(replayed)} decisions equal, "
          f"0 measurements, cache unchanged "
          f"({time.perf_counter() - t1:.1f} s)")
    # The chaos plan, on a cache of its own beside the phase's.
    chaos = TUNE_CACHE.with_name("tune-cache-chaos")
    shutil.rmtree(chaos, ignore_errors=True)
    os.environ[ENV_VAR] = str(chaos)
    try:
        serve_sim.main(["--smoke", "--chaos", "--device", str(dev)])
    finally:
        os.environ[ENV_VAR] = str(TUNE_CACHE)
    failed = {k: r.failed for k, r in TuningCache(chaos).items().items()
              if r.failed}
    print(f"  serve_sim --chaos: failed rows {failed}")


SHARDED_DIFFUSION = (512, 512, 512)
SHARDED_MHD = (256, 256, 256)
# Per mesh (its shape; dimensions named p, q): (problem, strategy, depth,
# mesh_axes) of each case, each run with overlap off and on.
SHARDED_CASES = {
    (2,): (
        ("diffusion", "swc", 1, ("p", None, None)),
        ("diffusion", "swc_stream", 1, (None, "p", None)),
        ("mhd_rhs", "swc", 1, ("p", None, None)),
        ("mhd_rhs", "tc", 1, ("p", None, None)),
        ("mhd_substep", "swc", 1, ("p", None, None)),
        ("mhd pair", "swc", 2, ("p", None, None)),
    ),
    (2, 2): (
        ("diffusion", "swc", 1, ("p", "q", None)),
        ("diffusion", "swc", 2, ("p", "q", None)),
        ("diffusion", "tc", 1, ("p", "q", None)),
    ),
}
SHARDED_KERNEL = {  # strategy, depth > 1 -> launch counter key, source
    ("swc", False): ("fused_stencil", KERNEL_SOURCE, REPLACES),
    ("swc", True): (TEMPORAL, TEMPORAL_SOURCE, TEMPORAL_REPLACES),
    ("swc_stream", False): (STREAM, STREAM_SOURCE, STREAM_REPLACES),
    ("tc", False): (TC, TC_SOURCE, TC_REPLACES),
}
SHARDED_REPS = 5


def sharded_case_op(problem, strategy, depth, shape, dev, seed):
    """(op, global field, global aux or None, φ FLOPs per point) of one
    sharded case: periodic, random in (-1e-5, 1e-5] (paper Table B2; the
    carry w in (0, 1e-3)) from one generator seed, the same on every
    rank."""
    import torch

    from repro_torch.physics import mhd
    from repro_torch.physics.diffusion import DiffusionProblem

    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(n_f, scale=2e-5, shift=1e-5):
        return torch.rand((n_f,) + tuple(shape), generator=gen,
                          device=dev) * scale - shift

    if problem == "diffusion":
        op = DiffusionProblem(tuple(shape)).step_op(
            strategy, fuse_steps=depth, device=dev)
        return op, draw(1), None, 0
    solver = mhd.MHDSolver(tuple(shape), strategy=strategy, device=dev)
    f = draw(mhd.N_FIELDS)
    if problem == "mhd_rhs":
        return solver.rhs_op(), f, None, mhd.RHS_PHI_FLOPS
    aux = draw(mhd.N_FIELDS, 1e-3, 0.0)
    if problem == "mhd_substep":
        op = solver._fused_substep_op(mhd.RK3_ALPHA[1], mhd.RK3_BETA[1], 1e-4)
    else:
        op = solver._fused_pair_op(1e-4)
    return op, f, aux, mhd.SUBSTEP_PHI_FLOPS


def _plain_padded(op, fp, aux_p):
    """The plain PyTorch version of ``op``'s launch on a padded stack."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.phi import phi_sequence

    depth = op.fuse_steps
    phis = phi_sequence(op.phi, depth)
    tc = op.strategy == "tc"
    if depth == 1:
        return ref.fused_stencil(fp, op.ops, phis[0].torch_fn, aux=aux_p,
                                 tc=tc)
    return ref.fused_stencil_steps(fp, op.ops, [p.torch_fn for p in phis],
                                   depth, aux=aux_p, tc=tc)


def sharded_rank(mesh, cases, shapes, seed0):
    """One rank of phase 3 (sharded): every case of this mesh on its
    block, held to the unsharded kernel and plain version on the whole
    field; rank 0 prints each case and returns the kernels line's rows
    and the launches by kernel, the others None."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import boundary, halo
    from repro_torch.kernels import emit
    from repro_torch.launch.mesh import local_block

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    names = mesh.mesh_dim_names
    bw, f32_rate, _ = card_rates(torch.cuda.get_device_name(0))
    sync = torch.cuda.synchronize

    def stepped(fn):
        """Median host ms of ``fn()`` after a barrier, ending in a
        synchronize and a barrier (the slowest rank's step)."""
        times = []
        for _ in range(SHARDED_REPS):
            dist.barrier()
            t = time.perf_counter()
            fn()
            sync()
            dist.barrier()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)

    def worst(x):
        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def total(x):
        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t)
        return float(t)

    out_rows, by_kernel = [], {}
    for i, (problem, strategy, depth, axes) in enumerate(cases):
        shape = shapes[problem.split()[0].split("_")[0]]
        op, g, aux_g, phi_flops = sharded_case_op(
            problem, strategy, depth, shape, dev, seed0 + i)
        spatial = tuple(range(1, g.ndim))
        wrads = [r * depth for r in op.radius_per_axis]
        arads = [r * (depth - 1) for r in op.radius_per_axis]
        gp = boundary.pad(g, wrads, "periodic", spatial_axes=spatial)
        aux_gp = aux_g
        if aux_g is not None and depth > 1:
            aux_gp = boundary.pad(aux_g, arads, "periodic",
                                  spatial_axes=spatial)
        want_kernel = op.apply_padded(gp, aux=aux_gp)
        want_plain = _plain_padded(op, gp, aux_gp)
        # this rank's window of the globally padded field
        window = [slice(None)]
        for a, name in enumerate(axes):
            if name is None:
                window.append(slice(None))
                continue
            k, c = mesh.size(names.index(name)), mesh.get_local_rank(name)
            n = shape[a] // k
            window.append(slice(c * n, (c + 1) * n + 2 * wrads[a]))
        want_pad = gp[tuple(window)]
        del gp, aux_gp
        fl = local_block(g, mesh, axes).contiguous()
        al = None if aux_g is None else local_block(
            aux_g, mesh, axes).contiguous()
        del g, aux_g
        block_k = local_block(want_kernel, mesh, axes)
        block_p = local_block(want_plain, mesh, axes)

        halo.reset_counts()
        fp = halo.exchange_halos_nd(fl, wrads, axes, spatial_axes=spatial,
                                    mesh=mesh, staging=op._staging)
        sync()
        sent = halo.counts["bytes"]
        if not torch.equal(fp, want_pad):
            raise AssertionError(
                f"rank {rank}: {problem} {strategy}: the exchanged block "
                "differs from its window of the padded field")
        del want_pad
        al_p = al
        if al is not None and depth > 1:
            al_p = halo.exchange_halos_nd(
                al, arads, axes, spatial_axes=spatial, mesh=mesh,
                staging=op._staging)
        sharded = sum(name is not None for name in axes)
        result = {}
        for overlap in (False, True):
            dist.barrier()
            sync()
            emit.reset_launch_counts()
            out = op.apply_sharded(fl, axes, al, overlap=overlap, mesh=mesh)
            sync()
            counts = dict(emit.fused_stencil_swc.launches_by_kernel)
            want_n = 1 + 2 * sharded if overlap else 1
            if sum(counts.values()) != want_n or len(counts) != 1:
                raise AssertionError(
                    f"rank {rank}: {problem} {strategy} overlap={overlap}: "
                    f"launches {counts}, want {want_n} of one kernel")
            for key, n in counts.items():
                by_kernel[key] = by_kernel.get(key, 0) + n
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{problem}: non-finite output")
            err_k = float((out - block_k).abs().max())
            err_p, rel_p = rel_err(out, block_p)
            result[overlap] = dict(
                launches=want_n, err_k=worst(err_k), err_p=worst(err_p),
                rel=worst(rel_p),
                equal_all=worst(0.0 if torch.equal(out, block_k) else 1.0)
                == 0.0,
                ms=stepped(lambda: op.apply_sharded(
                    fl, axes, al, overlap=overlap, mesh=mesh)),
            )
            del out
        exchange_ms = stepped(lambda: halo.exchange_halos_nd(
            fl, wrads, axes, spatial_axes=spatial, mesh=mesh,
            staging=op._staging))
        whole_ms = None
        if rank == 0:  # the unsharded step on the whole field, alone
            g, aux_g = sharded_case_op(problem, strategy, depth, shape, dev,
                                       seed0 + i)[1:3]
            whole = []
            for _ in range(SHARDED_REPS + 1):
                sync()
                t = time.perf_counter()
                op(g, aux_g)
                sync()
                whole.append(1e3 * (time.perf_counter() - t))
            whole_ms = statistics.median(whole[1:])
            del g, aux_g
        dist.barrier()
        sent_all = total(sent)
        kernel, source, replaces = SHARDED_KERNEL[strategy, depth > 1]
        mesh_txt = f"{tuple(mesh.mesh.shape)} over {axes}"
        if rank == 0:
            for overlap, r in result.items():
                if r["rel"] > TOL["float32"]:
                    raise AssertionError(
                        f"{problem} {strategy} S={depth} {mesh_txt} "
                        f"overlap={overlap}: rel err {r['rel']:.3e} against "
                        "the unsharded plain version")
            off, on = result[False], result[True]
            print(f"  {problem} {tuple(shape)} {strategy} S={depth} on "
                  f"{mesh_txt}: shard {tuple(fl.shape[1:])}, padded "
                  f"{tuple(fp.shape[1:])} equal to its window of the padded "
                  f"field; exchange {sent} B sent by rank 0 ({sent_all:.0f} "
                  f"B by all ranks), {exchange_ms:.3f} ms alone; sharded "
                  f"step {off['ms']:.3f} ms (overlap off, {off['launches']} "
                  f"launch) / {on['ms']:.3f} ms (on, {on['launches']} "
                  f"launches); unsharded step {whole_ms:.3f} ms; vs "
                  f"unsharded kernel max|err| {off['err_k']:.3e} / "
                  f"{on['err_k']:.3e} (bit for bit on every rank: "
                  f"{off['equal_all']} / {on['equal_all']}); vs plain "
                  f"rel {off['rel']:.3e} / {on['rel']:.3e} (tol 1e-05)")
        out_rows += _sharded_row(
            rank, op, fp, al_p, phi_flops, kernel, source, replaces,
            f"{problem}, S={depth}, sharded {mesh_txt}, shard "
            f"{'x'.join(map(str, fl.shape[1:]))}",
            sum(r["launches"] for r in result.values()),
            max(result[False]["err_p"], result[True]["err_p"]),
            problem == "diffusion", bw, f32_rate)
        del fl, al, fp, al_p, want_kernel, want_plain, block_k, block_p, op
        torch.cuda.empty_cache()
    dist.barrier()
    return (out_rows, by_kernel) if rank == 0 else None


def _sharded_row(rank, op, fp, aux_p, phi_flops, kernel, source, replaces,
                 label, launches, err, library, bw, f32_rate):
    """The kernels line's row of one sharded case, timed on rank 0
    while the other ranks wait: the shard's own launch (CUDA events),
    its plain version and, for diffusion, the dense convolution."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    row = []
    if rank == 0:
        ms = time_ms(lambda: op.apply_padded(fp, aux=aux_p), 10)
        plain_ms = time_ms(lambda: _plain_padded(op, fp, aux_p), 3,
                           warmup=1)
        lib_ms = None
        if library:
            rad = op.radius_per_axis
            spec = op.ops.ops[0]
            w = torch.zeros(tuple(2 * r + 1 for r in rad),
                            dtype=torch.float64)
            for off, c in zip(spec.offsets, spec.coeffs):
                w[tuple(o + r for o, r in zip(off, rad))] = c
            w = w.to(device=fp.device, dtype=fp.dtype)[None, None]

            def conv():
                y = fp[None]
                for _ in range(op.fuse_steps):
                    y = F.conv3d(y, w)
                return y

            lib_ms = time_ms(conv, 3, warmup=1)
        depth = op.fuse_steps
        out_numel = op.n_out
        for n, r in zip(fp.shape[1:], op.radius_per_axis):
            out_numel *= n - 2 * r * depth
        item = fp.element_size()
        nbytes = (fp.numel() + out_numel
                  + (0 if aux_p is None else aux_p.numel())) * item
        points = out_numel // op.n_out
        flops = depth * (op.ops.flops_per_point(fp.shape[0]) + phi_flops) * (
            points)
        rate = TC_RATES["float32"] if op.strategy == "tc" else f32_rate
        t_bytes, t_ops = nbytes / bw * 1e3, flops / rate * 1e3
        bound = max(t_bytes, t_ops)
        row.append({
            "name": f"{kernel}[{label}]",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"    row {kernel}[{label}]: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bound:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              f"{bound / ms:.1%} of bound")
    dist.barrier()
    return row


def phase_sharded(dev, smi):
    """Phase 3 (sharded): the distribution layer on the card. Every
    mesh's ranks are processes sharing this card over gloo (halos staged
    through pinned host memory), spawned by ``launch.mesh.run_on_mesh``
    once per mesh; the kernels are built before they start."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh

    print("== phase 3 (sharded): apply_sharded over gloo, the ranks "
          "sharing one card")
    print(f"  card: {smi}")
    build.build_all()  # no rank waits on nvcc
    torch.cuda.empty_cache()
    shapes = {"diffusion": SHARDED_DIFFUSION, "mhd": SHARDED_MHD}
    out_rows, launches = [], {}
    for seed0, (mesh_shape, cases) in enumerate(SHARDED_CASES.items()):
        axes = ("p", "q")[:len(mesh_shape)]
        results = run_on_mesh(
            sharded_rank, mesh_shape, axes, backend="gloo", device=dev,
            args=(cases, shapes, 100 * seed0), timeout=600)
        mesh_rows, by_kernel = results[0]
        out_rows += mesh_rows
        for key, n in by_kernel.items():
            launches[key] = launches.get(key, 0) + n
    print(f"  launches on rank 0 by kernel, all sharded steps: {launches}")
    for key in ("fused_stencil", TEMPORAL, STREAM, TC):
        if not launches.get(key):
            raise AssertionError(f"no {key} launch in the sharded phase")
    return out_rows


# Phase 3 (audit): each guard band of NaN around a view is this many bytes.
AUDIT_GUARD_BYTES = 4096


def _nan_like(shape, dtype, device, offset):
    """(flat, view): ``shape`` of ``dtype`` as a view ``offset`` elements
    past the start of AUDIT_GUARD_BYTES of NaN, with as much NaN after it,
    in one flat allocation of NaN."""
    import math as _m

    import torch

    g = AUDIT_GUARD_BYTES // torch.empty((), dtype=dtype).element_size()
    n = _m.prod(shape)
    flat = torch.full((2 * g + offset + n,), float("nan"), dtype=dtype,
                      device=device)
    return flat, flat[g + offset:g + offset + n].view(shape)


def _guards_intact(flat, view) -> bool:
    """Every element of ``flat`` outside ``view`` still holds the NaN bits
    it was filled with."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        flat.element_size()]
    bits = flat.view(ints)
    lo = (view.data_ptr() - flat.data_ptr()) // flat.element_size()
    hi = lo + view.numel()
    nan = bits[0]
    return bool((bits[:lo] == nan).all() and (bits[hi:] == nan).all())


def guard_launch(label, launch, inputs, want, dtype):
    """One guard-band case: ``launch(inputs, out)`` on ordinary tensors,
    then on views of each input placed at offset 0 and 1 element past a
    16-byte boundary inside NaN guards, into an output view 16-byte
    aligned (B7's 16-byte and paired lanes store whole vectors, and
    ``conv1d_depthwise.cu:380-386`` refuses an output off their alignment)
    whose interior is NaN too. Each time: the guards hold their NaN bits
    (nothing stored outside the output, no input written), the output holds
    no NaN (every point written; a read outside the staged window would
    pull NaN in) and equals the ordinary launch bit for bit; the ordinary
    launch within TOL of the plain version."""
    import torch

    ordinary = launch(inputs, None)
    for off in (0, 1):
        views = {}
        flats = []
        for k, t in inputs.items():
            if t is None:
                views[k] = None
                continue
            flat, view = _nan_like(tuple(t.shape), t.dtype, t.device, off)
            view.copy_(t)
            views[k] = view
            flats.append((k, flat, view, t))
        oflat, oview = _nan_like(tuple(ordinary.shape), ordinary.dtype,
                                 ordinary.device, 0)
        got = launch(views, oview)
        torch.cuda.synchronize()
        if got.data_ptr() != oview.data_ptr():
            raise AssertionError(f"{label}: the launch did not store into out")
        if not _guards_intact(oflat, oview):
            raise AssertionError(f"{label} offset {off}: a store outside "
                                 "the output changed its guard band")
        for k, flat, view, t in flats:
            if not _guards_intact(flat, view) or not torch.equal(view, t):
                raise AssertionError(f"{label} offset {off}: input {k} or "
                                     "its guard band was written")
        if bool(torch.isnan(oview).any()):
            raise AssertionError(f"{label} offset {off}: NaN in the output "
                                 "(a point unwritten or a read outside the "
                                 "staged window)")
        if not torch.equal(oview, ordinary):
            raise AssertionError(f"{label} offset {off}: differs from the "
                                 "launch on ordinary tensors")
    check(f"{label} (guards, offsets 0/1)", ordinary, want, dtype)


def guard_cases(dev):
    """(label, launch, inputs, plain, dtype) of phase 3 (audit)'s guard-band
    launches: every body of B1-B7 (the depth-1 swc, the column walks of
    swc, swc_stream and tc, the one-tile temporal body, the stream ring
    and one-buffer bodies, tc at depth 1, B6's one-tile and ring launches,
    B7), each dtype and φ kind it takes, B = 3 with segments, the odd
    tiles (4, 5, 20), (5, 5, 20), (4, 6, 12), (6, 6, 12) and (12,), the
    tuner's off-planner winners (32, 256) at S = 4 and (2, 32, 64) at
    S = 2, and a (4, 4, 32) tile on a 244-plane slab."""
    from repro_torch.kernels import emit, ref
    from repro_torch.kernels.conv1d_depthwise import conv1d_depthwise_cuda
    from repro_torch.kernels.xcorr1d import xcorr1d_cuda

    F, D, H, E = "float32", "float64", "bfloat16", "float16"
    fused = (
        ("B1 swc (4,5,20) f32", diffusion_case((16, 20, 40), F, dev,
                                               block=(4, 5, 20))),
        ("B1 swc (5,5,20) f64", diffusion_case((10, 10, 40), D, dev,
                                               block=(5, 5, 20))),
        ("B1 swc (4,6,12) f32", diffusion_case((8, 12, 24), F, dev,
                                               block=(4, 6, 12))),
        ("B1 swc (6,6,12) bf16", diffusion_case((12, 12, 24), H, dev,
                                                block=(6, 6, 12))),
        ("B1 swc (12,) f32", diffusion_case((1200,), F, dev, block=(12,))),
        ("B1 swc rank 2 bf16", diffusion_case((40, 96), H, dev)),
        ("B1 swc MHD RHS f32", mhd_case((8, 8, 32), F, dev, False)),
        ("B1 swc MHD substep f32", mhd_case((8, 8, 32), F, dev, True)),
        ("B1 swc MHD RHS f64", mhd_case((8, 8, 16), D, dev, False)),
        ("B1 swc MHD substep f64", mhd_case((8, 8, 16), D, dev, True)),
        ("B5 swc B=3 f32", diffusion_case((8, 16, 32), F, dev, batch=3)),
        ("B2 walk S=2 f32", diffusion_case((16, 16, 32), F, dev,
                                           fuse_steps=2)),
        ("B2 walk S=3 f64 rank 2", diffusion_case((48, 64), D, dev,
                                                  fuse_steps=3)),
        ("B2 walk B=3 seg 4", diffusion_case((32, 16, 32), F, dev,
                                             fuse_steps=2, batch=3,
                                             segments=4)),
        ("B2 walk (32,256) S=4", diffusion_case((128, 512), F, dev,
                                                block=(32, 256),
                                                fuse_steps=4)),
        ("B2 walk (2,32,64) S=2", diffusion_case((16, 64, 128), F, dev,
                                                 block=(2, 32, 64),
                                                 fuse_steps=2)),
        ("B2 walk (4,4,32) 244-plane slab", diffusion_case(
            (244, 8, 64), F, dev, block=(4, 4, 32), fuse_steps=2)),
        ("B2 walk MHD pair f32", mhd_pair_case((8, 8, 32), F, dev)),
        ("B2 walk MHD RHS twice f32", mhd_rhs_twice_case((8, 8, 32), F,
                                                         dev)),
        ("B2 one-tile rank 1 S=2", diffusion_case((4096,), F, dev,
                                                  fuse_steps=2)),
        ("B2 one-tile rank 1 S=3 f64", diffusion_case((2048,), D, dev,
                                                     fuse_steps=3)),
        ("B2 one-tile MHD pair f64", mhd_pair_case((8, 8, 16), D, dev)),
        ("B2 one-tile MHD RHS twice f64", mhd_rhs_twice_case((8, 8, 16), D,
                                                             dev)),
        ("B3 ring rank 2 f32", diffusion_case((64, 128), F, dev,
                                              strategy="swc_stream")),
        ("B3 ring rank 3 f64", diffusion_case((16, 16, 32), D, dev,
                                              strategy="swc_stream")),
        ("B3 ring B=3 seg 4", diffusion_case((64, 16, 32), F, dev,
                                             strategy="swc_stream", batch=3,
                                             segments=4)),
        ("B3 ring MHD RHS f32", mhd_case((8, 8, 32), F, dev, False,
                                         strategy="swc_stream")),
        ("B3 one-buffer MHD RHS f64", mhd_case((8, 8, 32), D, dev, False,
                                               strategy="swc_stream")),
        ("B3 walk S=2 f32", diffusion_case((24, 16, 32), F, dev,
                                           strategy="swc_stream",
                                           fuse_steps=2)),
        ("B3 walk S=2 f64 rank 2", diffusion_case((48, 64), D, dev,
                                                  strategy="swc_stream",
                                                  fuse_steps=2)),
        ("B4 tc f32 rank 3", diffusion_case((8, 16, 32), F, dev,
                                            strategy="tc")),
        ("B4 tc bf16 rank 2", diffusion_case((32, 64), H, dev,
                                             strategy="tc")),
        ("B4 tc f32 rank 1", diffusion_case((4096,), F, dev, strategy="tc")),
        ("B4 tc B=3", diffusion_case((8, 16, 32), F, dev, strategy="tc",
                                     batch=3)),
        ("B4 tc MHD RHS f32", mhd_case((8, 8, 16), F, dev, False,
                                       strategy="tc")),
        ("B4 tc MHD substep f32", mhd_case((8, 8, 16), F, dev, True,
                                           strategy="tc")),
        ("B4 tc walk S=2 f32", diffusion_case((16, 16, 32), F, dev,
                                              strategy="tc", fuse_steps=2)),
        ("B4 tc walk S=2 bf16 rank 2", diffusion_case(
            (48, 64), H, dev, strategy="tc", fuse_steps=2)),
        ("B4 tc walk MHD pair f32", mhd_pair_case((8, 8, 16), F, dev,
                                                  strategy="tc")),
        ("B4 tc walk MHD RHS twice f32", mhd_rhs_twice_case(
            (8, 8, 16), F, dev, strategy="tc")),
        ("B4 tc walk B=3 seg 2", diffusion_case((32, 16, 32), F, dev,
                                                strategy="tc", fuse_steps=2,
                                                batch=3, segments=2)),
        ("B4 tc rank 1 S=2", diffusion_case((4096,), F, dev, strategy="tc",
                                            fuse_steps=2)),
        ("B4 tc rank 1 S=2 bf16", diffusion_case((4096,), H, dev,
                                                 strategy="tc",
                                                 fuse_steps=2)),
        # bf16 in B2, B3 and the MHD φ (B2c, B3c, B4b)
        ("B2 walk S=2 bf16", diffusion_case((16, 16, 32), H, dev,
                                            fuse_steps=2)),
        ("B2 walk S=3 bf16 rank 2", diffusion_case((48, 64), H, dev,
                                                   fuse_steps=3)),
        ("B2 one-tile rank 1 S=2 bf16", diffusion_case((4096,), H, dev,
                                                       fuse_steps=2)),
        ("B2 walk MHD pair bf16", mhd_pair_case((8, 8, 32), H, dev)),
        ("B3 ring rank 3 bf16", diffusion_case((16, 16, 32), H, dev,
                                               strategy="swc_stream")),
        ("B3 ring MHD RHS bf16", mhd_case((8, 8, 32), H, dev, False,
                                          strategy="swc_stream")),
        ("B3 walk S=2 bf16 rank 2", diffusion_case((48, 64), H, dev,
                                                   strategy="swc_stream",
                                                   fuse_steps=2)),
        ("B1 swc MHD RHS bf16", mhd_case((8, 8, 32), H, dev, False)),
        ("B1 swc MHD substep bf16", mhd_case((8, 8, 32), H, dev, True)),
        ("B4 tc MHD substep bf16", mhd_case((8, 8, 16), H, dev, True,
                                            strategy="tc")),
        ("B4 tc walk MHD pair bf16", mhd_pair_case((8, 8, 16), H, dev,
                                                   strategy="tc")),
    )
    cases = []
    for label, case in fused:
        fp, ops, phi, plan, aux = case

        def launch(t, out, ops=ops, phi=phi, plan=plan):
            return emit.fused_stencil_swc(t["f"], ops, phi, plan,
                                          aux=t["aux"], out=out)

        cases.append((f"{label} {emit.kernel_name(plan)}", launch,
                      {"f": fp, "aux": aux}, lambda c=case: plain(c),
                      plan.dtype))
    for strategy, u, r, dt in (("baseline", 4, 1, F), ("pointwise", 4, 10, D),
                               ("elementwise", 4, 1, F),
                               ("elementwise", 4, 10, F),
                               ("elementwise", 8, 64, D),
                               ("elementwise", 16, 64, F),
                               ("baseline", 4, 1, H),
                               ("elementwise", 8, 10, E),
                               ("elementwise", 32, 64, H),
                               ("pointwise", 24, 64, E)):
        f, g = xcorr_inputs(5000 + 123, r, dt, dev)

        def launch(t, out, s=strategy, u=u):
            return xcorr1d_cuda(t["f"], t["g"], strategy=s, block_size=1024,
                                unroll=u, out=out)

        cases.append((f"B6 {strategy} u{u} r{r} {dt}", launch,
                      {"f": f, "g": g}, lambda f=f, g=g: ref.xcorr1d(f, g),
                      dt))
    for shape, k, dt, act in (((2, 257, 32), 4, F, "silu"),
                              ((2, 257, 40), 7, H, "none"),
                              ((3, 100, 16), 4, H, "silu"),
                              ((2, 257, 40), 4, E, "silu"),
                              ((2, 257, 32), 4, D, "none"),
                              ((2, 257, 32), 16, E, "none"),
                              ((3, 100, 16), 33, D, "silu")):
        x, w = conv_inputs(shape, k, dt, dev)

        def launch(t, out, act=act):
            return conv1d_depthwise_cuda(t["x"], t["w"], activation=act,
                                         out=out)

        cases.append((f"B7 {shape} k{k} {dt} {act}", launch,
                      {"x": x.contiguous(), "w": w},
                      lambda x=x, w=w, act=act: ref.conv1d_depthwise(
                          x, w, act), dt))
    return cases


def _layout_checks(results) -> tuple[int, int]:
    """Phase 3 (audit) step (b): for every audited plan and launch, the
    library's ``repro_<name>_layout`` fields and body, the kernel's shared
    bytes and the auditor's equal field by field, and a persistent plan's
    grid within [1, walk_items]. Host calls only: no launch. Returns
    (layouts compared, grids checked)."""
    from repro_torch.analysis.bodies import Conv1dLaunch, XcorrLaunch
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx
    from repro_torch.kernels.phi import KIND_IDS
    from repro_torch.kernels.plan import StencilPlan

    n_layouts = n_grids = 0
    bad = []
    for key, res in results:
        if isinstance(key, StencilPlan):
            body, fields = emit.layout_fields(key)
            smem = emit.kernel_smem_bytes(key)
        elif isinstance(key, XcorrLaunch):
            body, fields = kx.layout_fields(key.n_taps, key.block_size,
                                            key.strategy, key.unroll,
                                            key.dtype)
            smem = fields["total"]
        else:
            body, fields = kc.layout_fields(key.b, key.s, key.c, key.k,
                                            key.vec)
            smem = fields["total"]
        if body != res.body or fields != res.layout or \
                smem != res.measured_smem:
            bad.append(f"{res.sid}: library {body} {fields} {smem} B, "
                       f"auditor {res.body} {res.layout} "
                       f"{res.measured_smem} B")
        n_layouts += 1
        if isinstance(key, StencilPlan) and key.persistent:
            kind = ("select" if key.n_slots == 1 and not key.n_aux else
                    "mhd_substep" if key.n_aux == 8 else
                    "mhd_rhs" if key.n_slots == 10 and key.n_f == 8 else None)
            if kind is None:
                continue  # a planner-only plan no φ kind launches
            grid = emit.launch_grid(key, KIND_IDS[kind])
            if not 1 <= grid <= key.walk_items:
                bad.append(f"{res.sid}: grid {grid} outside [1, "
                           f"{key.walk_items}]")
            n_grids += 1
    for line in bad[:20]:
        print(f"    MISMATCH {line}")
    if bad:
        raise AssertionError(f"{len(bad)} layouts differ from the auditor's")
    return n_layouts, n_grids


def phase_audit(dev, smi):
    """Phase 3 (audit): the static auditor (``repro_torch.analysis``) and
    the guard-band launches, run last.

    (a) The full audit: ``AUDIT_SHAPES`` at their full extents, the
    tuner's candidate spaces (whole at the smoke extents, the timed
    candidates at the main path's full extents) and every plan and B6/B7
    launch this run's earlier phases made; unaudited and findings must be
    0; then the mutation harness (every mutant caught with its class).
    (b) Layouts: every audited plan's library layout fields, the kernel's
    shared bytes and the auditor's equal; persistent grids in [1,
    walk_items]. (c) Guard-band launches (:func:`guard_cases`,
    :func:`guard_launch`). (d) memcheck is left out: on this machine
    ``compute-sanitizer`` is installed but reports "Device not supported"
    and the program's first cudaMalloc under it fails (PERF.md section 6).
    Prints each step's seconds."""
    from repro_torch.analysis.bodies import Conv1dLaunch, XcorrLaunch
    from repro_torch.analysis.driver import run_audit, run_mutants
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    print(f"== phase 3 (audit): {smi}")
    t = time.perf_counter()
    launched = emit.launched_plans()
    launched_1d = [XcorrLaunch(*k) for k in kx.xcorr1d_cuda.launched] + [
        Conv1dLaunch(b, s, c, k, dt, vec, sb, ss)
        for b, s, c, k, dt, vec, sb, ss in
        kc.conv1d_depthwise_cuda.launched]
    report = run_audit(full=True, launched=launched, launched_1d=launched_1d)
    c = report["counts"]
    print(f"  (a) registry {c['registry']}, candidates {c['candidates']}, "
          f"launched {c['launched']} ({len(launched)} fused plans, "
          f"{len(launched_1d)} B6/B7 launches), audited {c['audited']} "
          f"({c['classes']} tile and column classes), unaudited "
          f"{c['unaudited']}, findings {c['findings']}, sid combos "
          f"{c['sid_combos']}, record round trips {c['record_roundtrips']}")
    print("      bodies: " + ", ".join(f"{k} {v}" for k, v in
                                      report["bodies"].items()))
    print("      not ported: " + (", ".join(
        f"{k} {v}" for k, v in report["not_ported"].items()) or "none")
          + "; refused by the planner: " + (", ".join(
              f"{k} {v}" for k, v in report["refused"].items()) or "none"))
    print("      bf16 kernels audited: " + (", ".join(
        f"{k} {v}" for k, v in report["bf16_items"].items()) or "none"))
    if set(report["not_ported"]) & {"B2c", "B3c", "B4b"} or set(
            report["bf16_items"]) != {"B2c", "B3c", "B4b"}:
        raise AssertionError("audit: B2c, B3c and B4b must be audited, "
                             "none counted as not ported")
    for f in report["findings"][:20]:
        print(f"      [{f['cls']}] {f['plan']}: {f['detail']}")
    if c["unaudited"] or c["findings"]:
        raise AssertionError(f"audit: {c['unaudited']} unaudited, "
                             f"{c['findings']} findings")
    mut = run_mutants()
    print(f"      mutants: {len(mut['mutants']) - 1} seeded, undetected "
          f"{mut['undetected'] or 'none'}")
    if mut["undetected"]:
        raise AssertionError(f"mutants missed: {mut['undetected']}")
    t_a = time.perf_counter() - t
    print(f"  [(a) audit: {t_a:.1f} s (the audit itself "
          f"{report['seconds']:.1f} s)]")
    t = time.perf_counter()
    aud = report["_auditor"]
    n_layouts, n_grids = _layout_checks(aud.results.items())
    print(f"  (b) {n_layouts} layouts equal field by field (library, "
          f"kernel shared bytes, auditor); {n_grids} persistent grids in "
          "[1, walk_items]")
    print(f"  [(b) layouts: {time.perf_counter() - t:.1f} s]")
    t = time.perf_counter()
    cases = guard_cases(dev)
    for label, launch, inputs, want, dtype in cases:
        guard_launch(label, launch, inputs, want(), dtype)
    print(f"  (c) {len(cases)} guard-band cases x 2 input offsets: guards "
          "intact, no NaN, equal to the ordinary launch bit for bit")
    # The guard cases' own plans and launches, audited and their layouts
    # held to the library's like (a) and (b)'s.
    new = [(p, o) for p, o in emit.launched_plans() if p not in aud.results]
    new_1d = [lc for lc in (
        [XcorrLaunch(*k) for k in kx.xcorr1d_cuda.launched] + [
            Conv1dLaunch(b, s, c, k, dt, vec, sb, ss)
            for b, s, c, k, dt, vec, sb, ss in
            kc.conv1d_depthwise_cuda.launched]) if lc not in aud.results]
    for p, o in new:
        aud.plan(p, o)
    for lc in new_1d:
        aud.launch(lc)
    found = [f for k in [p for p, _ in new] + new_1d
             for f in aud.results[k].findings]
    for f in found[:20]:
        print(f"      [{f.cls}] {f.plan}: {f.detail}")
    n_more, _ = _layout_checks((k, aud.results[k]) for k in
                               [p for p, _ in new] + new_1d)
    print(f"      their {len(new)} plans and {len(new_1d)} B6/B7 launches "
          f"audited after: findings {len(found)}, {n_more} layouts equal")
    if found:
        raise AssertionError(f"guard cases: {len(found)} findings")
    print(f"  [(c) guard bands: {time.perf_counter() - t:.1f} s]")
    print("  (d) memcheck: left out (compute-sanitizer: Device not "
          "supported on this machine)")
    return report


def phase_times(dev, smi, launches, bf16_only=False):
    """Phase 4: kernel times (CUDA events, median) at the main path's
    shapes beside their bounds, plain and library times; ``bf16_only``
    the bf16 rows alone (``--bf16``). Each field of one shape, dtype and
    seed is drawn once for the phase."""
    with reuse_draws():
        return _phase_times(dev, smi, launches, bf16_only)


def _phase_times(dev, smi, launches, bf16_only):
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core.trafficmodel import (
        stencil_hbm_bytes_per_step,
        stencil_redundant_compute_fraction,
        stencil_stream_hbm_bytes_per_step,
    )
    from repro_torch.kernels.emit import fused_stencil_swc
    from repro_torch.kernels.phi import phi_sequence
    from repro_torch.kernels.plan import (
        MIN_WALK_ITEMS,
        _stream_segments,
        tc_issued_macs,
    )
    from repro_torch.physics import mhd

    print("== phase 4: times (CUDA events, median)")
    name = torch.cuda.get_device_name(0)
    bw, f32_rate, f64_rate = card_rates(name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def row(label, kind, case, dtype, phi_flops, library=None, reps=10,
            plain_reps=3, main=None):
        """Time one launch; ``main`` names its main-path launch count
        and puts the row in the kernels line."""
        fp, ops, phi, plan, aux = case
        depth = plan.fuse_steps
        item = fp.element_size()
        batch = plan.batch if fp.ndim == plan.rank + 2 else 0
        got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
        want = plain(case)
        err, rel = rel_err(got, want)
        if rel > TOL[dtype]:
            raise AssertionError(f"{label}: rel err {rel:.3e}")
        del want
        ms = time_ms(lambda: fused_stencil_swc(fp, ops, phi, plan, aux=aux),
                     reps)
        if batch:  # the same members, one unbatched launch each, cut
            # into the stream segments the planner gives one member
            solo = dataclasses.replace(plan, batch=1)
            if plan.stream_axis is not None:
                solo = dataclasses.replace(solo, segments=_stream_segments(
                    plan.block, plan.interior, plan.radii, depth))
            elif plan.temporal_walk:
                solo = dataclasses.replace(solo, segments=_stream_segments(
                    plan.block, plan.interior, plan.radii, depth, 1,
                    MIN_WALK_ITEMS))
            members = [(fp[m], None if aux is None else aux[m])
                       for m in range(batch)]
            solo_ms = time_ms(lambda: [
                fused_stencil_swc(f, ops, phi, solo, aux=a) for f, a in members
            ], reps)
        # the check's call above was the plain version's warm-up
        plain_ms = time_ms(lambda: plain(case), plain_reps, warmup=0)
        lib_ms = None
        if library is not None:
            t = time.perf_counter()
            lib_out = library()
            torch.cuda.synchronize()
            slow = time.perf_counter() - t > 0.05  # e.g. conv3d at 512^3
            lerr, _ = rel_err(lib_out.reshape(got.shape), got)
            del lib_out
            # A library call of tens of ms or more is timed over 3 calls
            # after the check's call, which keeps the run within its
            # budget.
            lib_ms = time_ms(library, 3 if slow else reps,
                             warmup=0 if slow else 2)
            print(f"    library conv vs kernel max|err| {lerr:.3e}")
        points = max(batch, 1)
        for n_ in plan.interior:
            points *= n_
        nbytes = (fp.numel() + got.numel()
                  + (0 if aux is None else aux.numel())) * item
        tap_flops = depth * ops.flops_per_point(plan.n_f) * points
        phi_ops = depth * phi_flops * points
        t_bytes = nbytes / bw * 1e3
        tc = plan.strategy == "tc"
        if tc:  # the tensor-core route's rate (bf16 MMA, or f64 MMA)
            t_ops = (tap_flops + phi_ops) / TC_RATES[dtype] * 1e3
        elif item == 2:  # the taps' bf16 pairs; φ (exp, /) at the f32 rate
            t_ops = (tap_flops / (BF16_PAIR * f32_rate)
                     + phi_ops / f32_rate) * 1e3
        else:
            rate = f64_rate if item == 8 else f32_rate
            t_ops = (tap_flops + phi_ops) / rate * 1e3
        bound = max(t_bytes, t_ops)
        stream = plan.stream_axis is not None
        if tc:
            issued, needed = tc_issued_macs(plan, ops, phi_sequence(
                phi, depth)[0].operators)
            name_, source, replaces = (
                f"{TC}[{kind}, S={depth}, {dtype}", TC_SOURCE,
                TC_REPLACES if depth == 1 else TC_TEMPORAL_REPLACES)
            print(f"    tc: tile {plan.block}, {plan.smem_bytes} B shared; "
                  f"{tc_launch_info(plan, phi_sequence(phi, depth)[0])}; "
                  f"banded MACs issued {issued:.6e} against "
                  f"{needed:.6e} for the multi-tap groups' taps "
                  f"({issued / needed:.3f}x)")
            if depth > 1:
                print(f"    S={depth}: {ms / depth:.4f} ms per step")
        elif stream:
            name_, source, replaces = (f"{STREAM}[{kind}, S={depth}",
                                       STREAM_SOURCE, STREAM_REPLACES)
            print(f"    stream: {stream_launch_info(plan, phi)}")
        elif depth == 1:
            name_, source, replaces = (f"fused_stencil_swc[{kind}",
                                       KERNEL_SOURCE, REPLACES)
            print(f"    swc: tile {plan.block}, {plan.smem_bytes} B shared; "
                  f"{swc_launch_info(plan, phi)}")
        else:
            name_, source, replaces = (
                f"fused_stencil_temporal[{kind}, S={depth}",
                TEMPORAL_SOURCE, TEMPORAL_REPLACES)
        if item == 2 and not tc:
            name_ += ", bf16"
        if batch:
            name_, replaces = f"{name_}, B={batch}]", BATCH_REPLACES
        else:
            name_ += "]"
        r = {
            "name": name_,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[main] if main else 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
        print(f"  {label:<34} {dtype:<7} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:10.4f} ms  bound {bound:8.4f} ms "
              f"({r['bound_by']})  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              f"max|err| {err:.3e}  {bound / ms:.1%} of bound")
        if batch:
            print(f"    {batch} members in one launch (grid z {plan.grid_z}, "
                  f"{plan.segments} segment(s)): {ms:.4f} ms; {batch} "
                  f"unbatched launches ({solo.segments} segment(s) each): "
                  f"{solo_ms:.4f} ms ({ms / batch:.4f} against "
                  f"{solo_ms / batch:.4f} ms per member)")
        elif stream and not tc:
            model = dict(domain=plan.interior, block=plan.block,
                         radii=plan.radii, n_f=plan.n_f, n_out=plan.n_out,
                         itemsize=item, fuse_steps=depth)
            walk = stencil_stream_hbm_bytes_per_step(
                **model, segments=plan.segments)
            one = stencil_stream_hbm_bytes_per_step(**model)
            swc = stencil_hbm_bytes_per_step(**model)
            work = (f"evaluations per output-step "
                    f"{plan.evaluations_per_output_step:.4f}"
                    if getattr(plan, "walk", False) else
                    "redundant work {:.4f}".format(
                        stencil_redundant_compute_fraction(
                            plan.block, plan.radii, depth)))
            print(f"    stream S={depth}: {ms / depth:.4f} ms per step; "
                  f"chunk and cross tile {plan.block}, {plan.segments} "
                  f"segment(s), {plan.threads} threads, {plan.smem_bytes} B "
                  f"shared; modelled {walk:.6e} B/step (one walk "
                  f"{one:.6e}; swc at this tile {swc:.6e}), {work}")
        elif depth > 1 and plan.temporal_walk:
            print(f"    S={depth}: {ms / depth:.4f} ms per step; "
                  f"{temporal_launch_info(plan, phi_sequence(phi, depth)[0])}")
        elif depth > 1 and not tc:
            traffic = [
                stencil_hbm_bytes_per_step(
                    plan.interior, plan.block, plan.radii, plan.n_f,
                    plan.n_out, item, s)
                for s in (depth, 1)
            ]
            print(f"    S={depth}: {ms / depth:.4f} ms per step; "
                  f"{temporal_launch_info(plan, phi_sequence(phi, depth)[0])}"
                  f"; modelled {traffic[0]:.6e} B/step (depth 1: "
                  f"{traffic[1]:.6e}), evaluations per output-step "
                  f"{plan.evaluations_per_output_step:.4f}")
        if main:
            rows.append(r)
        return r

    def conv_of(case):
        fp, ops, _, plan, _ = case
        spec = ops.ops[0]
        rad = ops.radius_per_axis()
        w = torch.zeros(tuple(2 * r + 1 for r in rad), dtype=torch.float64)
        for off, c in zip(spec.offsets, spec.coeffs):
            w[tuple(o + r for o, r in zip(off, rad))] = c
        w = w.to(device=fp.device, dtype=fp.dtype)[None, None]
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[plan.rank]
        x = fp if fp.ndim == plan.rank + 2 else fp[None]  # N = B

        def run():  # one valid convolution per fused step
            y = x
            for _ in range(plan.fuse_steps):
                y = conv(y, w)
            return y

        return run

    def bf16_rows():
        """The bf16 rows of B2, B3 and the MHD φ (B2c, B3c, B4b)."""
        print("  -- bf16 in B2 and B3 (B2c, B3c) and the MHD φ in bf16 "
              "(B4b); bound at 2 B a value, the taps' bf16 operations at "
              "the bf16 pair rate (2x f32), φ's at the f32 rate")
        bf = "bfloat16"
        t_bf = time.perf_counter()
        with reuse_draws():
            bf16_cases(bf)
        print(f"    (the bf16 rows: {time.perf_counter() - t_bf:.1f} s)")

    def bf16_cases(bf):
        lib = {}  # the S convs at depth S, timed once for B2 and B3
        for strategy, depth in (("swc", 2), ("swc", 3), ("swc_stream", 1),
                                ("swc_stream", 2), ("swc_stream", 3)):
            case = diffusion_case((512,) * 3, bf, dev, fuse_steps=depth,
                                  strategy=strategy)
            key = "stream select" if strategy == "swc_stream" else "select"
            r = row(f"{strategy} diffusion 512^3 S={depth} (library: {depth} "
                    "convs)", "select", case, bf, 0,
                    None if depth in lib else conv_of(case),
                    main=f"{key} S={depth} bf16")
            if depth in lib:
                r["library_ms"] = lib[depth]
                print(f"    library: the B2 row's {depth} convs on the same "
                      f"field, {lib[depth]:.4f} ms")
            lib.setdefault(depth, r["library_ms"])
            del case
        case = diffusion_case((8192, 8192), bf, dev, strategy="swc_stream")
        row("stream diffusion (8192, 8192)", "select y-stream", case, bf, 0,
            conv_of(case), main="stream select 8192^2 bf16")
        del case
        case = diffusion_case((1 << 26,), bf, dev, fuse_steps=2)
        row("diffusion (2^26,) S=2 (library: 2 convs)", "select 2^26", case,
            bf, 0, conv_of(case), main="select 2^26 S=2 bf16")
        del case
        case = diffusion_case((1 << 26,), "float32", dev, fuse_steps=2)
        row("the same in f32 (one-tile body)", "select 2^26", case,
            "float32", 0, conv_of(case))
        del case
        torch.cuda.empty_cache()
        for strategy, substep, kind, flops, main in (
            ("swc", False, "mhd_rhs", mhd.RHS_PHI_FLOPS, "mhd_rhs bf16"),
            ("swc", True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS,
             "mhd_substep bf16"),
            ("swc_stream", False, "mhd_rhs", mhd.RHS_PHI_FLOPS,
             "stream mhd_rhs bf16"),
            ("tc", False, "mhd_rhs", mhd.RHS_PHI_FLOPS, "tc mhd_rhs bf16"),
            ("tc", True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS,
             "tc mhd_substep bf16"),
        ):
            case = mhd_case((256,) * 3, bf, dev, substep, smooth=False,
                            strategy=strategy)
            row(f"{strategy} MHD {kind} 256^3", kind, case, bf, flops,
                main=main, reps=5, plain_reps=2)
            del case
            torch.cuda.empty_cache()
        for strategy, main in (("swc", "mhd pair bf16"),
                               ("tc", "tc mhd pair bf16")):
            case = mhd_pair_case((256,) * 3, bf, dev, substeps=(0, 1),
                                 smooth=False, strategy=strategy)
            row(f"{strategy} MHD pair 256^3", "mhd_substep", case, bf,
                mhd.SUBSTEP_PHI_FLOPS, main=main, reps=3, plain_reps=1)
            del case
            torch.cuda.empty_cache()

    print(f"  card: {smi}")
    if bf16_only:
        bf16_rows()
        return rows
    case = diffusion_case((512,) * 3, "float32", dev)
    row("diffusion 512^3", "select", case, "float32", 0, conv_of(case),
        main="select")
    del case
    for depth in (2, 3):
        case = diffusion_case((512,) * 3, "float32", dev, fuse_steps=depth)
        row(f"diffusion 512^3 S={depth} (library: {depth} convs)", "select",
            case, "float32", 0, conv_of(case), main=f"select S={depth}")
        del case
        case = diffusion_case((256,) * 3, "float64", dev, fuse_steps=depth)
        row(f"diffusion 256^3 S={depth} (library: {depth} convs)", "select",
            case, "float64", 0, conv_of(case))
        del case
    for shape, key in (((1 << 26,), "select 2^26"),
                       ((8192, 8192), "select 8192^2")):
        case = diffusion_case(shape, "float32", dev)
        row(f"diffusion {shape}", key, case, "float32", 0, conv_of(case),
            main=key)
        del case
    case = diffusion_case((256,) * 3, "float64", dev)
    row("diffusion 256^3", "select", case, "float64", 0, conv_of(case))
    del case
    substep_ms = {}
    for substep, kind, flops in (
        (True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS),
        (False, "mhd_rhs", mhd.RHS_PHI_FLOPS),
    ):
        case = mhd_case((256,) * 3, "float32", dev, substep, smooth=False)
        substep_ms[kind] = row(f"MHD {kind} 256^3", kind, case, "float32",
                               flops, main=kind, reps=5, plain_reps=2)["ms"]
        del case
        case = mhd_case((128,) * 3, "float64", dev, substep, smooth=False)
        row(f"MHD {kind} 128^3", kind, case, "float64", flops, reps=5,
            plain_reps=2)
        del case
        torch.cuda.empty_cache()
    for shape, dtype, main in (((256,) * 3, "float32", "mhd pair"),
                               ((128,) * 3, "float64", None)):
        case = mhd_pair_case(shape, dtype, dev, substeps=(0, 1),
                             smooth=False)
        r = row(f"MHD pair {shape[0]}^3", "mhd_substep", case, dtype,
                mhd.SUBSTEP_PHI_FLOPS, main=main, reps=3, plain_reps=1)
        if main:
            print(f"    RK3 step with fuse_rk_pairs: pair {r['ms']:.4f} + "
                  f"substep {substep_ms['mhd_substep']:.4f} = "
                  f"{r['ms'] + substep_ms['mhd_substep']:.4f} ms of kernel; "
                  f"fused axpy: 3 x {substep_ms['mhd_substep']:.4f} = "
                  f"{3 * substep_ms['mhd_substep']:.4f} ms")
        del case
        torch.cuda.empty_cache()

    print("  -- stream kernel (swc_stream)")
    for depth in (1, 2, 3):
        case = diffusion_case((512,) * 3, "float32", dev, fuse_steps=depth,
                              strategy="swc_stream")
        row(f"stream diffusion 512^3 S={depth}", "select", case, "float32",
            0, conv_of(case), main=f"stream select S={depth}")
        del case
    case = diffusion_case((8192, 8192), "float32", dev, strategy="swc_stream")
    row("stream diffusion (8192, 8192)", "select y-stream", case, "float32",
        0, conv_of(case), main="stream select 8192^2")
    del case
    case = diffusion_case((256,) * 3, "float64", dev, strategy="swc_stream")
    row("stream diffusion 256^3", "select", case, "float64", 0,
        conv_of(case))
    del case
    case = mhd_case((256,) * 3, "float32", dev, False, smooth=False,
                    strategy="swc_stream")
    row("stream MHD mhd_rhs 256^3", "mhd_rhs", case, "float32",
        mhd.RHS_PHI_FLOPS, main="stream mhd_rhs", reps=5, plain_reps=2)
    del case
    case = mhd_case((128,) * 3, "float64", dev, False, smooth=False,
                    strategy="swc_stream")
    row("stream MHD mhd_rhs 128^3", "mhd_rhs", case, "float64",
        mhd.RHS_PHI_FLOPS, reps=5, plain_reps=2)
    del case
    torch.cuda.empty_cache()

    print("  -- ensemble batch (B5): B members in one launch")
    for label, kw in (("B1", dict()), ("B3 S=1", dict(strategy="swc_stream")),
                      ("B2 S=2", dict(fuse_steps=2))):
        case = diffusion_case((256,) * 3, "float32", dev, batch=8, **kw)
        row(f"diffusion 256^3 B=8, {label}", "select", case, "float32", 0,
            conv_of(case))
        del case
    # The serve phase's own launches: order 2 (its default), one bucket
    # each, with that bucket's launch count from phase 3b.
    for strategy in ("swc", "swc_stream"):
        for shape in SERVE_SHAPES:
            bucket = "x".join(map(str, shape))
            case = diffusion_case(shape, "float32", dev, batch=SERVE_BATCH,
                                  accuracy=2, strategy=strategy)
            row(f"serve {bucket} B={SERVE_BATCH}, {strategy}",
                f"serve {bucket}", case, "float32", 0, conv_of(case),
                main=f"serve {strategy} {bucket}")
            del case
        torch.cuda.empty_cache()
    case = mhd_case((128,) * 3, "float32", dev, False, smooth=False, batch=4)
    row("MHD mhd_rhs 128^3 B=4, B1", "mhd_rhs", case, "float32",
        mhd.RHS_PHI_FLOPS, reps=5, plain_reps=2)
    del case
    torch.cuda.empty_cache()

    print("  -- tc kernel (tensor cores) and bf16 in B1 (B1b)")
    for shape, depth, dtype, strategy, main in (
        ((512,) * 3, 1, "float32", "tc", "tc select S=1"),
        ((512,) * 3, 2, "float32", "tc", "tc select S=2"),
        ((512,) * 3, 3, "float32", "tc", "tc select S=3"),
        ((512,) * 3, 1, "bfloat16", "tc", "tc select bf16"),
        ((512,) * 3, 2, "bfloat16", "tc", "tc select bf16 S=2"),
        ((512,) * 3, 1, "bfloat16", "swc", "select bf16"),
        ((8192, 8192), 1, "float32", "tc", "tc select 8192^2"),
        ((1 << 26,), 1, "float32", "tc", "tc select 2^26"),
    ):
        case = diffusion_case(shape, dtype, dev, fuse_steps=depth,
                              strategy=strategy)
        kind = "select" if len(shape) == 3 else (
            f"select {'x'.join(map(str, shape))}")
        row(f"{strategy} diffusion {shape} S={depth}", kind, case, dtype,
            0, conv_of(case), main=main)
        del case
    torch.cuda.empty_cache()
    for substep, kind, flops in (
        (True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS),
        (False, "mhd_rhs", mhd.RHS_PHI_FLOPS),
    ):
        case = mhd_case((256,) * 3, "float32", dev, substep, smooth=False,
                        strategy="tc")
        row(f"tc MHD {kind} 256^3", kind, case, "float32", flops,
            main=f"tc {kind}", reps=5, plain_reps=2)
        del case
        torch.cuda.empty_cache()
    for n, main in ((128, None), (256, "tc mhd pair")):
        case = mhd_pair_case((n,) * 3, "float32", dev, substeps=(0, 1),
                             smooth=False, strategy="tc")
        row(f"tc MHD pair {n}^3", "mhd_substep", case, "float32",
            mhd.SUBSTEP_PHI_FLOPS, main=main, reps=3, plain_reps=1)
        del case
        torch.cuda.empty_cache()
    for shape in SERVE_SHAPES:
        bucket = "x".join(map(str, shape))
        case = diffusion_case(shape, "float32", dev, batch=SERVE_BATCH,
                              accuracy=2, strategy="tc")
        row(f"serve {bucket} B={SERVE_BATCH}, tc", f"serve {bucket}", case,
            "float32", 0, conv_of(case), main=f"serve tc {bucket}")
        del case
    torch.cuda.empty_cache()

    bf16_rows()
    return rows


def phase_times_xcorr(dev, smi, launches):
    """B6 rows (CUDA events, median): n = 2^24, fig07's full size
    (``benchmarks/fig07_xcorr_library.py``), f32 at radii 1-1024
    (``XCORR_TIME_RADII``), f64, bf16 and f16 at r = 1, 10 and 1024 (r =
    1 and 1024 the paper's Table 3 cases), each strategy at unroll 4, and
    elementwise at unroll 8 and 16 (Fig. 9's sweep) for f32 r >= 64 and
    the other dtypes at r = 1024, and there ``XCORR_WIDE`` (unroll 24-64,
    register passes) in every dtype; then the 2^26 ``step_1d_xcorr``
    launch of each strategy in f32, bf16 and f16, whose rows go to the
    kernels line. The library call is ``F.conv1d(f[None, None], g[None,
    None])`` in the same dtype (cuDNN, the paper's Fig. 7) timed with
    ``torch.backends.cudnn.allow_tf32 = False``; the flag is restored
    after. The port never calls it. Bound: bytes, or the taps'
    operations at the f32, f64 or (bf16, f16) packed pair rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch import cast
    from repro_torch.core.stencil import diffusion_kernel_1d
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import xcorr1d as kx
    from repro_torch.physics.diffusion import DiffusionProblem

    print("== phase 4 (1-D): B6 xcorr1d times (CUDA events, median)")
    print(f"  card: {smi}")
    name = torch.cuda.get_device_name(0)
    bw, f32_rate, f64_rate = card_rates(name)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    def rows_for(label, f, g, dtype, main=None, reps=10, extra=()):
        """One row per strategy on the inputs (f, g), then one per
        (strategy, unroll) of ``extra``; the plain and the library call
        are timed once for all."""
        n_taps = g.shape[0]
        n = f.shape[0] - n_taps + 1
        item = f.element_size()
        want = ref.xcorr1d(f, g)
        plain_ms = time_ms(lambda: ref.xcorr1d(f, g), 2, warmup=1)
        x, w = f[None, None], g[None, None]
        t = time.perf_counter()
        lib_out = F.conv1d(x, w)[0, 0]
        torch.cuda.synchronize()
        slow = time.perf_counter() - t > 0.05
        _, lib_rel = rel_err(lib_out, want)
        del lib_out
        lib_ms = time_ms(lambda: F.conv1d(x, w), 3 if slow else reps,
                         warmup=1 if slow else 2)
        t_bytes = (f.numel() + n_taps + n) * item / bw * 1e3
        rate = {8: f64_rate, 4: f32_rate, 2: BF16_PAIR * f32_rate}[item]
        t_ops = 2 * n_taps * n / rate * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        for strategy, unroll in XCORR_STRATEGIES + tuple(extra):
            launch = ("ring" if kx.ring_route(strategy, unroll, n_taps)
                      else "one-tile")
            got = kops.xcorr1d(f, g, strategy=strategy, unroll=unroll)
            err, rel = rel_err(got, want)
            if rel > TOL[dtype] or (item == 2 and not torch.equal(got, want)):
                raise AssertionError(f"{label} {strategy}: rel err {rel:.3e}")
            del got
            ms = time_ms(lambda: kops.xcorr1d(f, g, strategy=strategy,
                                              unroll=unroll), reps)
            r = {
                "name": f"xcorr1d[{strategy}, u{unroll}, {label}, {dtype}]",
                "route": "cuda",
                "source": XCORR_SOURCE,
                "replaces": XCORR_REPLACES,
                "launches": launches[f"{main} {strategy}"] if main else 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": lib_ms,
            }
            print(f"  {label:<22} {dtype:<8} {strategy:<11} u{unroll:<2} "
                  f"{launch:<8} kernel "
                  f"{ms:9.4f} ms  plain {plain_ms:10.4f} ms  bound "
                  f"{bound:7.4f} ms ({by})  conv1d (no TF32) {lib_ms:.4f} "
                  f"ms  max|err| {err:.3e}  {bound / ms:.1%} of bound")
            if main and (strategy, unroll) in XCORR_STRATEGIES:
                rows.append(r)
        print(f"    conv1d vs plain rel {lib_rel:.3e}")
        del want

    try:
        n = 1 << 24
        for dtype, radii in (("float32", XCORR_TIME_RADII),
                             ("float64", (1, 10, 1024)),
                             ("bfloat16", (1, 10, 1024)),
                             ("float16", (1, 10, 1024))):
            for r in radii:
                f, g = xcorr_inputs(n, r, dtype, dev, seed=r)
                sweep = r >= (64 if dtype == "float32" else 1024)
                extra = XCORR_UNROLLS if sweep else ()
                rows_for(f"n=2^24 r={r}", f, g, dtype,
                         extra=extra + (XCORR_WIDE if r == 1024 else ()))
                del f, g
        prob = DiffusionProblem((1 << 26,), accuracy=6)
        taps = torch.as_tensor(
            diffusion_kernel_1d(prob.accuracy, prob.dt, prob.alpha,
                                prob.spacing[0]),
            dtype=torch.float64, device=dev)
        for dtype in ("float32", "bfloat16", "float16"):
            f0 = prob.init_field(seed=0, device=dev, dtype=dtype)[0]
            r = prob.radius
            fp = torch.cat([f0[-r:], f0, f0[:r]])
            main = "xcorr" if dtype == "float32" else f"xcorr {dtype}"
            rows_for("step_1d_xcorr 2^26 r=3", fp, cast(taps, fp.dtype),
                     dtype, main=main)
            del fp, f0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


def phase_times_conv1d(dev, smi, launches, mamba2=True):
    """B7 rows (CUDA events, median) at mamba2-780m's prefill launch: the
    strided xBC view (4, 8192, 3328) of a (4, 8192, 6448) in-projection,
    k = 4, bf16 (the main path's dtype, 48 launches per prefill) and f32
    (the f32 forward's, also 48), f16 and f64 (B7b's path, one launch
    each), and bf16 at k = 16 and 33 (the body with k at run time, one
    launch each on B7b's path). Bound: bytes = ((b·(s+k-1) + k)·c +
    b·s·c) values (the padded input and the taps read once, the output
    written once) over the memory rate, against 2·k·b·s·c FLOPs at the
    non-tensor f32 or f64 rate (bf16, f16: the packed pair rate). The
    library call is ``F.conv1d(groups=c, padding=k-1)`` in the same dtype
    (cuDNN, TF32 off) on a contiguous (b, c, s) copy; the copy's time is
    printed apart. The port never calls it. Without ``mamba2`` (phase 3
    (mamba2) did not run, so its counts were not taken) the bf16 and f32
    k = 4 rows are left out."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    print("== phase 4 (mamba2): B7 conv1d_depthwise times (CUDA events, "
          "median)")
    print(f"  card: {smi}")
    bw, f32_rate, f64_rate = card_rates(torch.cuda.get_device_name(0))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    b, s = PREFILL_SHAPE
    c, row = 3328, 6448
    rows = []
    try:
        cases = (("bfloat16", "conv1d prefill", 4),
                 ("float32", "conv1d f32 forward", 4),
                 ("float16", "conv1d float16 k=4", 4),
                 ("float64", "conv1d float64 k=4", 4),
                 ("bfloat16", "conv1d bfloat16 k=16", 16),
                 ("bfloat16", "conv1d bfloat16 k=33", 33))
        if not mamba2:
            print("  (phase 3 (mamba2) not run: its bf16 and f32 k=4 rows "
                  "are left out)")
            cases = cases[2:]
        for dtype, key, k in cases:
            x, w = conv_inputs((b, s, c), k, dtype, dev, seed=11, row=row,
                               offset=3072)
            item = x.element_size()
            want = ref.conv1d_depthwise(x, w)
            got = kops.conv1d_depthwise(x, w)
            err, rel = rel_err(got, want)
            if rel > TOL[dtype] or (item != 8 and not torch.equal(got, want)):
                raise AssertionError(f"conv1d {dtype} k={k}: rel err "
                                     f"{rel:.3e}")
            del got
            ms = time_ms(lambda: kops.conv1d_depthwise(x, w), 20)
            xc = x.contiguous()
            ms_contig = time_ms(lambda: kops.conv1d_depthwise(xc, w), 20)
            del xc
            plain_ms = time_ms(lambda: ref.conv1d_depthwise(x, w), 5)
            copy_ms = time_ms(lambda: x.transpose(1, 2).contiguous(), 10)
            xt = x.transpose(1, 2).contiguous()  # (b, c, s)
            wt = w.t().contiguous()[:, None, :]  # (c, 1, k)
            lib = F.conv1d(xt, wt, padding=k - 1, groups=c)[..., :s]
            _, lib_rel = rel_err(lib.transpose(1, 2), want)
            del lib, want
            lib_ms = time_ms(
                lambda: F.conv1d(xt, wt, padding=k - 1, groups=c), 20)
            del xt
            values = (b * (s + k - 1) + k) * c + b * s * c
            t_bytes = values * item / bw * 1e3
            rate = {8: f64_rate, 4: f32_rate, 2: BF16_PAIR * f32_rate}[item]
            t_ops = 2 * k * b * s * c / rate * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            rows.append({
                "name": f"conv1d_depthwise[mamba2 prefill xBC {b}x{s}x{c} "
                        f"k={k}, {dtype}]",
                "route": "cuda",
                "source": CONV_SOURCE,
                "replaces": CONV_REPLACES,
                "launches": launches[key],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": lib_ms,
            })
            print(f"  xBC view {b}x{s}x{c} k={k:<2} {dtype:<8} vec"
                  f"{kc.vector_width(x, w)}: kernel {ms:.4f} ms (contiguous "
                  f"input {ms_contig:.4f})  plain {plain_ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}, {values * item / 1e6:.1f} MB)  "
                  f"conv1d (groups=c, no TF32) {lib_ms:.4f} ms + transpose "
                  f"copy {copy_ms:.4f} ms  max|err| {err:.3e}  "
                  f"{bound / ms:.1%} of bound  launches ({key}) "
                  f"{launches[key]}; conv1d vs plain rel "
                  f"{lib_rel:.3e}")
            del x, w
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


# Phase 3 (dryrun): (a) the eager dry run of every cell on both
# production meshes (``repro_torch.launch.dryrun --all``, meta tensors on
# a fake process group, no card), started in a subprocess right after
# phase 1 at the lowest CPU priority and read here; (b) the three model
# cells the script times elsewhere, each step counted by FlopCounterMode
# on the card and on meta (equal), timed on the card against its
# roofline bound (the FLOPs over the bf16 rate, the traffic model's bytes
# over the memory rate, the larger).
DRYRUN_JOBS = 2
DRYRUN_OUT = ROOT / "build" / "dryrun.json"
DRYRUN_LOG = ROOT / "build" / "dryrun.log"
DRYRUN_TIMEOUT = 900  # seconds to wait in the phase for the subprocess
DRYRUN_CELLS = 64  # 32 cells with status run, on two meshes
DRYRUN_TIMED = 3  # timed steps after a warm-up; the median is kept
# (b)'s train cell at 12 of qwen2.5-3b's 36 layers (full width): counting
# a step's FLOPs op by op costs seconds a layer on the host, twice (the
# card and meta), and phase 3 (dense) times the full depth.
DRYRUN_TRAIN_LAYERS = 12


def dryrun_start():
    """The dry run's subprocess (``nice`` 19, ``DRYRUN_JOBS`` workers),
    writing ``DRYRUN_OUT`` and its log ``DRYRUN_LOG``."""
    import subprocess

    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(DRYRUN_LOG, "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--jobs", str(DRYRUN_JOBS), "--out", str(DRYRUN_OUT)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            start_new_session=True, preexec_fn=lambda: os.nice(19))
    finally:
        log.close()


def _dryrun_cells(proc) -> dict:
    """(a): wait for the subprocess, print each cell's status and
    dominant term, and fail unless every cell with status run is ok."""
    import collections

    t0 = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    waited = time.perf_counter() - t0
    recs = json.loads(DRYRUN_OUT.read_text()) if DRYRUN_OUT.exists() else []
    by = collections.defaultdict(dict)
    for r in recs:
        by[(r["arch"], r["shape"])][r["mesh"]] = r
    for (arch, shape), meshes in sorted(by.items()):
        cols = []
        for mesh in ("single", "multi"):
            r = meshes.get(mesh, {"status": "missing"})
            if r["status"] == "ok":
                cols.append(
                    f"{mesh} ok {r['dominant']} (compute {r['compute_s']:.3e}"
                    f" s, memory {r['memory_s']:.3e}, collective "
                    f"{r['collective_s']:.3e}; roofline share "
                    f"{r['roofline_fraction']:.3f}, useful FLOPs "
                    f"{r['useful_flops_ratio']:.3f}, resident "
                    f"{r['resident_bytes_per_chip'] / 1e9:.2f} GB)")
            else:
                cols.append(f"{mesh} {r['status']} {r.get('error', '')}")
        print(f"  (a) {arch} x {shape}: " + "; ".join(cols))
    ok = sum(r["status"] == "ok" for r in recs)
    failed = [r for r in recs if r["status"] not in ("ok",)
              and not r["status"].startswith("skip")]
    print(f"  (a) dry run: rc {rc}, {ok} cells ok, "
          f"{sum(r['status'].startswith('skip') for r in recs)} skipped "
          f"(documented), {len(failed)} failed, waited {waited:.1f} s here "
          f"(log: {DRYRUN_LOG.relative_to(ROOT)})")
    if rc != 0 or failed or ok != DRYRUN_CELLS:
        print(DRYRUN_LOG.read_text()[-4000:])
        raise AssertionError(f"dry run: rc {rc}, {ok} ok, failed {failed}")
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def _dryrun_step(dev, smi, label, cfg, shape, seed=1):
    """(b) for one cell: the step built on the card (seeded parameters
    and inputs) and on meta by ``dryrun.build_cell``, counted by
    FlopCounterMode on both (equal), then timed on the card (a warm-up,
    ``DRYRUN_TIMED`` steps, the median) against ``Roofline.bound_s``."""
    import statistics

    import torch

    from repro_torch.core import rooflinelib as rl
    from repro_torch.core.trafficmodel import modeled_hbm_bytes
    from repro_torch.launch import dryrun

    run, resident = dryrun.build_cell(cfg, shape, device=dev, seed=seed)
    _reset_all_counts()
    card, _ = dryrun.count_flops(run)
    torch.cuda.synchronize()
    launches = _all_counts()
    meta_run, meta_resident = dryrun.build_cell(cfg, shape)
    meta, _ = dryrun.count_flops(meta_run)
    times = []
    for _ in range(DRYRUN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    secs = statistics.median(times)
    roof = rl.Roofline(
        flops=meta, chips=1, collective_wire_bytes=0.0,
        hbm_bytes=modeled_hbm_bytes(cfg, shape.kind, shape.seq_len,
                                    shape.global_batch, model_ways=1,
                                    dp_ways=1))
    print(f"  (b) {label}: FlopCounterMode {card:.6e} FLOPs on the card, "
          f"{meta:.6e} on meta ({'equal' if card == meta else 'DIFFER'}); "
          f"resident {resident / 2**30:.2f} GiB (meta {meta_resident / 2**30:.2f}"
          f"); launches (B7, fused-stencil, xcorr1d) {launches}, B7's not "
          f"seen by the counter; step {1e3 * secs:.2f} ms (host clock, median "
          f"of {DRYRUN_TIMED}: {', '.join(f'{1e3 * t:.2f}' for t in times)})"
          f" against a bound of {1e3 * roof.bound_s:.3f} ms ({roof.dominant}:"
          f" compute {1e3 * roof.compute_s:.3f}, memory "
          f"{1e3 * roof.memory_s:.3f}): {roof.bound_s / secs:.2%} of the "
          f"bound, on {smi}")
    if card != meta or card <= 0:
        raise AssertionError(f"dry run (b) {label}: card {card}, meta {meta}")
    del run
    torch.cuda.empty_cache()
    return {"label": label, "flops": meta, "ms": 1e3 * secs,
            "bound_ms": 1e3 * roof.bound_s, "launches": launches}


def phase_dryrun(dev, smi, proc):
    """Phase 3 (dryrun): (b) then (a), while the subprocess finishes: (a)
    every cell of the dry run on both meshes, (b) mamba2-780m's prefill ``PREFILL_SHAPE`` (bf16, 48 B7 launches),
    llama3-8b's decode step at ``LM_BATCH`` against the serve loop's cache
    of 128 slots (bf16) and qwen2.5-3b's train step
    ``DENSE_TRAIN_SHAPE`` at ``DRYRUN_TRAIN_LAYERS``: the FLOP count on
    the card equal to meta's, the step's time against its roofline
    bound."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import ShapeSpec, get_config

    print("== phase 3 (dryrun): the eager dry run of the 40-cell matrix "
          "(launch/dryrun.py) and three model steps against their roofline")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    b, s = PREFILL_SHAPE
    rows.append(_dryrun_step(dev, smi, f"mamba2-780m prefill ({b}, {s})",
                             get_config("mamba2-780m"),
                             ShapeSpec("prefill", s, b, "prefill")))
    rows.append(_dryrun_step(
        dev, smi, f"llama3-8b decode at batch {LM_BATCH}, cache 128",
        get_config("llama3-8b"), ShapeSpec("decode", 128, LM_BATCH,
                                           "decode")))
    b, s = DENSE_TRAIN_SHAPE
    rows.append(_dryrun_step(
        dev, smi, f"qwen2.5-3b train step ({b}, {s}) at "
        f"{DRYRUN_TRAIN_LAYERS} of 36 layers",
        dataclasses.replace(get_config("qwen2.5-3b"),
                            n_layers=DRYRUN_TRAIN_LAYERS),
        ShapeSpec("train", s, b, "train")))
    if rows[0]["launches"][0] != get_config("mamba2-780m").n_layers:
        raise AssertionError(f"dry run (b) mamba2: launches {rows[0]}")
    _dryrun_cells(proc)
    return rows


# Phase 3 (examples): the five examples/torch_*.py on the card, each in a
# subprocess of its own (all at once), at small arguments; each must exit
# 0 and print its OK line; the stencil examples must launch B1-B5.
EXAMPLES = {
    "torch_quickstart": [],
    "torch_mhd_simulation": ["--n", "32", "--steps", "8"],
    "torch_serve_ensemble": ["--requests", "8", "--steps", "4",
                             "--max-batch", "4"],
    "torch_serve_batched": ["--requests", "8", "--max-new", "12"],
    "torch_train_lm": ["--steps", "60", "--global-batch", "8",
                       "--seq-len", "64", "--fail-at", "30"],
}
STENCIL_EXAMPLES = ("torch_quickstart", "torch_mhd_simulation",
                    "torch_serve_ensemble")
EXAMPLES_TIMEOUT = 600


def example_cmds(cache: Path) -> dict:
    """Every example at ``EXAMPLES``' arguments on the card (its default
    device), each with a tuning cache of its own under ``cache``."""
    return {name: ([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                    *args], {"REPRO_TORCH_TUNE_CACHE": str(cache / name)})
            for name, args in EXAMPLES.items()}


def examples_check(outs, smi):
    """The examples' runs (``example_cmds``): each exit code 0 and its
    OK line, its seconds (they share the card and the host) and, for the
    stencil examples, their fused-stencil launches printed."""
    import re

    failed = []
    for name in EXAMPLES:
        proc = outs[name]
        out = proc.stdout + proc.stderr
        ok_line = name.removeprefix("torch_") + " OK"
        found = re.findall(r"fused-stencil launches: (\d+) (\{.*\})", out)
        launches = int(found[-1][0]) if found else 0
        line = (f"  {name} {' '.join(EXAMPLES[name])}: rc "
                f"{proc.returncode} in {proc.seconds:.1f} s")
        if found:
            line += f", fused-stencil launches {launches} {found[-1][1]}"
        print(line + f" on {smi}")
        for tail in proc.stdout.strip().splitlines()[-3:]:
            print(f"    | {tail}")
        if (proc.returncode != 0 or not proc.stdout.rstrip().endswith(ok_line)
                or (name in STENCIL_EXAMPLES and launches <= 0)):
            failed.append(name)
            print(out[-3000:])
    if failed:
        raise AssertionError(f"examples failed: {failed}")


def phase_examples(dev, smi):
    """Phase 3 (examples): ``example_cmds`` at once, then
    ``examples_check``."""
    import shutil

    print("== phase 3 (examples): examples/torch_*.py on the card")
    cache = ROOT / "build" / "examples-tune"
    shutil.rmtree(cache, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        outs = run_at_once(example_cmds(cache), cache / "logs")
        examples_check(outs, smi)
        print(f"  five examples in {time.perf_counter() - t0:.1f} s (at once)")
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def phase_clis(dev, smi):
    """Phase 3 (clis), last in the full run: every command-line check of
    the earlier phases started at once, as they need no measurement —
    phase 3 (train)'s reduced train CLI, phase 3 (dp train)'s over
    ``--mesh 2x1`` with its restore, phase 3 (tp)'s (e) (``--mesh 2x2``
    and 1x1), phase 3 (hybrid)'s train and serve CLIs and the five
    examples (phase 3 (examples)) — with phase 2 and then phase 3
    (audit) run in this process while they run; then each checked as its
    phase checks it, and the launches the checks made here (the DP
    restore's B7) audited after."""
    import shutil
    import tempfile

    from repro_torch.analysis.bodies import Conv1dLaunch, XcorrLaunch
    from repro_torch.analysis.driver import run_audit
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    def launched():
        return ({p: ops for p, ops in emit.launched_plans()},
                set(kx.xcorr1d_cuda.launched),
                set(kc.conv1d_depthwise_cuda.launched))

    print("== phase 3 (clis): the CLIs and the examples at once, phase 2 "
          "and phase 3 (audit) meanwhile")

    audited = []  # the launches made when the audit is done

    def meanwhile():
        for name, fn, args in (("phase 2", phase_parity, (dev,)),
                               ("phase 3 (audit)", phase_audit, (dev, smi))):
            t = time.perf_counter()
            fn(*args)
            print(f"  [{name}: {time.perf_counter() - t:.1f} s, the CLIs "
                  "running beside it]")
        audited.append(launched())  # the audit's guard cases audited there

    cache = ROOT / "build" / "examples-tune"
    shutil.rmtree(cache, ignore_errors=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cmds = {"train": train_cli_cmd(tmp), "dp": dp_cli_cmd(tmp),
                    **tp_cli_cmds(tmp), **hybrid_cli_cmds(tmp),
                    **example_cmds(cache)}
            t0 = time.perf_counter()
            outs = run_at_once(cmds, Path(tmp) / "logs", during=meanwhile)
            print(f"  {len(cmds)} commands at once, the last done in "
                  f"{max(o.seconds for o in outs.values()):.1f} s; phase 2 "
                  f"and the audit beside them: {time.perf_counter() - t0:.1f}"
                  " s in all")
            print("  phase 3 (train)'s CLI:")
            one = train_cli_check(outs["train"], tmp)
            print("  phase 3 (dp train)'s CLI:")
            dp_cli_check(dev, outs["dp"], one, tmp)
        print("  phase 3 (tp)'s CLIs:")
        tp_cli_check(outs)
        print("  phase 3 (hybrid)'s CLIs:")
        hybrid_cli_check(outs)
        print("  phase 3 (examples):")
        examples_check(outs, smi)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    now, seen = launched(), audited[0]
    plans = [(p, ops) for p, ops in now[0].items() if p not in seen[0]]
    launches_1d = [XcorrLaunch(*k) for k in now[1] - seen[1]] + [
        Conv1dLaunch(*k) for k in now[2] - seen[2]]
    report = run_audit(shapes=(), enumerate_candidates=False,
                       launched=plans, launched_1d=launches_1d)
    c = report["counts"]
    print(f"  launches the checks made after the audit: {len(plans)} fused "
          f"plans, {len(launches_1d)} B6/B7 launches; audited "
          f"{c['audited']}, unaudited {c['unaudited']}, findings "
          f"{c['findings']}")
    if c["unaudited"] or c["findings"]:
        raise AssertionError(f"audit after the CLIs: {report['findings']}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    dev = repro_torch.default_device()
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"  [{name}: {seconds[name]:.1f} s]")
        return out

    smi = timed("phase 1", phase_card)
    print(smi)
    dry = None
    if "--dryrun" in argv or not any(a.startswith("--") for a in argv):
        dry = dryrun_start()  # no card: runs beside the phases below
    try:
        return _phases(argv, dev, smi, timed, seconds, t0, dry)
    finally:
        if dry is not None and dry.poll() is None:
            import signal

            os.killpg(dry.pid, signal.SIGKILL)  # its workers too
            dry.wait()


def _phases(argv, dev, smi, timed, seconds, t0, dry) -> int:
    """The phases that ``argv`` selects (every one without a flag)."""
    import torch

    if "--dryrun" in argv:
        rows = timed("phase 3 (dryrun)", phase_dryrun, dev, smi, dry)
        print(json.dumps({"dryrun_steps": rows}))
        return 0
    if "--examples" in argv:
        timed("phase 3 (examples)", phase_examples, dev, smi)
        return 0
    if "--verify" in argv:
        timed("phase 3 (verify)", phase_verify, dev, smi)
        return 0
    if "--tune" in argv:
        timed("phase 3 (tune)", phase_tune, dev, smi)
        return 0
    if "--sharded" in argv:
        timed("phase 3 (sharded)", phase_sharded, dev, smi)
        return 0
    if "--audit" in argv:
        timed("phase 3 (audit)", phase_audit, dev, smi)
        return 0
    if "--train" in argv:
        timed("phase 3 (train)", phase_train, dev, smi, {})
        return 0
    if "--dp-train" in argv:
        timed("phase 3 (dp train)", phase_dp_train, dev, smi, {})
        return 0
    if "--dense" in argv:
        timed("phase 3 (dense)", phase_dense, dev, smi)
        return 0
    if "--tp" in argv:
        rows = timed("phase 3 (tp)", phase_tp, dev, smi)
        print(json.dumps({"kernels": rows}))
        return 0
    if "--moe" in argv:
        timed("phase 3 (moe)", phase_moe, dev, smi)
        return 0
    if "--bf16" in argv:
        launches = {}
        timed("phase 3 (bf16)", phase_main_path_bf16, dev, launches)
        rows = timed("phase 4 (bf16)", phase_times, dev, smi, launches, True)
        print(json.dumps({"kernels": rows}))
        return 0
    if "--hybrid" in argv or "--encdec" in argv:
        if "--hybrid" in argv:
            timed("phase 3 (hybrid)", phase_hybrid, dev, smi)
        if "--encdec" in argv:
            timed("phase 3 (encdec)", phase_encdec, dev, smi)
        return 0
    if "--quick" in argv:
        timed("phase 2", phase_parity, dev)
        return 0
    if "--1d" in argv:
        launches = {}
        timed("phase 2 (1-D)", phase_parity_1d, dev)
        timed("phase 3 (1-D)", phase_main_path_1d, dev, launches)
        rows = timed("phase 4 (1-D)", phase_times_xcorr, dev, smi, launches)
        rows += timed("phase 4 (mamba2)", phase_times_conv1d, dev, smi,
                      launches, False)
        print(json.dumps({"kernels": rows}))
        return 0
    # phase 2 runs in phase 3 (clis), beside the CLIs
    launches = timed("phase 3", phase_main_path, dev)
    timed("phase 3 (tc)", phase_main_path_tc, dev, launches)
    timed("phase 3 (bf16)", phase_main_path_bf16, dev, launches)
    timed("phase 3 (1-D)", phase_main_path_1d, dev, launches)
    timed("phase 3 (mamba2)", phase_main_path_ssm, dev, smi, launches)
    # the CLIs and the examples run at the end, all at once (phase 3
    # (clis))
    train_rows = timed("phase 3 (train)", phase_train, dev, smi, launches,
                       False)
    train_rows += timed("phase 3 (dp train)", phase_dp_train, dev, smi,
                        launches, False)
    timed("phase 3 (dense)", phase_dense, dev, smi)
    train_rows += timed("phase 3 (tp)", phase_tp, dev, smi, False)
    timed("phase 3 (moe)", phase_moe, dev, smi)
    timed("phase 3 (hybrid)", phase_hybrid, dev, smi, False)
    timed("phase 3 (encdec)", phase_encdec, dev, smi)
    timed("phase 3 (dryrun)", phase_dryrun, dev, smi, dry)
    timed("phase 3b", phase_serve, dev, launches)
    timed("phase 3 (verify)", phase_verify, dev, smi)
    timed("phase 3 (tune)", phase_tune, dev, smi)
    sharded_rows = timed("phase 3 (sharded)", phase_sharded, dev, smi)
    rows = timed("phase 4", phase_times, dev, smi, launches)
    rows += timed("phase 4 (1-D)", phase_times_xcorr, dev, smi, launches)
    rows += timed("phase 4 (mamba2)", phase_times_conv1d, dev, smi, launches)
    rows += train_rows + sharded_rows
    timed("phase 3 (clis)", phase_clis, dev, smi)
    print("chip_smoke: seconds by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
