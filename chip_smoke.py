#!/usr/bin/env python3
"""Drive the PyTorch port (`scenedino_torch`) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  0 device   the card's name and power limit; TF32 off for fp32 compares
  1 build    nvcc builds every kernel of the paths from csrc/ (sm_90a);
             the registers and spills (none allowed) of the K1 forward and
             backward kernels (at D = 80 with setmaxnreg's split: the
             forward's two instantiations, dq, dkv; at every other head dim
             the forward, dq and dkv at seven padded widths), of the point
             kernels' sixteen instantiations, their wide walk's five and its
             weight packing, and of K6's thirty-two, its wide walk's four and
             their packing's two, and of K1's forward, dq and dkv past head
             dim 256 (with ptxas' notes on serialized wgmma: none allowed);
             the build's wall time beside the 45.1 s it took before the wide
             walk (an H100 at 700 W)
  2 K1       the attention forward kernel vs its plain versions (output
             and log-sum-exp) at the three shapes its paths give it:
             ViT-B/8 @192x640 serving (1, 1921, 12, 64), the training
             step's student (4, ...) with the log-sum-exp and teacher
             (8, ...), bf16; two launches bitwise equal; kernel, plain and
             F.scaled_dot_product_attention times (the last only as a
             yardstick: the port never calls it)
  2b K1-bwd  the backward kernels (dq; dk and dv) vs the plain fp32
             backward at the training shape (4, 1921, 12, 64) bf16, and
             two launches bitwise equal; kernel, plain and
             scaled_dot_product_attention-backward times, the pair's TFLOP/s
  3 K2       point-render kernel vs its plain version at full width:
             192x640 rays x 32 samples, 384x1280x128 bf16 grid, d_out 65;
             then with the weight-median depth
  3b probe   the probe path's kernels at the shapes it gives them: K3 at
             48x160 rays x 16 samples over the same grid with the density
             column of W2; the row gather of their weights and depths, a
             (7680, 32) fp32 table, at the 122,880 pixels' probe rows
             (exact; kernel, plain and torch.index_select times); K2 on
             the 10 + 2 resampled, sorted depths of each pixel
  3c K4      point-query kernel vs its plain version over the 2,097,152
             SSCBench voxel centres (bench.py's (z, x, y) order)
  3d gather  the row-gather kernel at P1's shape (256 rows of a 512x128
             fp32 table) and P2's (2^20 rows of a 32768x128 bf16
             table), exact at both; kernel, plain and torch.index_select
             times, and at P1's its C function called alone (the host's
             floor of a launch)
  3e K6      the encode-view kernel vs its plain version at 192x640 rays
             x 32 samples from a 384x1280x128 folded grid (W_z 13x128, W2
             128x65) through the render's own preamble: the bf16 serving
             state of one frame, then stage 2's fp32 state of 4 frames in
             one launch; then phase 7b's: 4 fp32 frames of 96x192 rays x 32
             samples from a 192x384x64 grid (W2 64x17); then the bf16
             serving state of one 192x640 frame at 48 samples (16 dead rows
             a ray in the kernel's 64-row tiles), and of one 96x192 frame at
             48 samples (W2 64x17: the encode view of a field of
             configs/train_synthetic_convergence.yaml); expectation depth,
             then the weight-median depth; two launches bitwise equal;
             kernel, plain and bound times (no library call computes this
             function); then the serving render stage split into its torch
             preamble and K6
  Bounds: the larger of the bytes moved (each input read once, each
  output written once; of a folded grid only the distinct rows that the
  points' corner lookups read) over 3.35 TB/s and the FLOP over the bf16
  tensor-core peak (K6's fp32 state: three TF32 passes at 495 TFLOP/s, the
  least time for products of fp32 accuracy; beside it the 67 TFLOP/s of
  fp32 outside the tensor cores). Phases 3-3c also print the corner rows the kernels
  read (points x 4 x D x 2 B) and their time at 3.35 TB/s.
  4 slice    the flagship field (ViT-B/8 + DPT 256, bf16, seeded random
             weights) answers 3 novel-view requests (encode ->
             build_fast_state -> render_novel_view_fused, 32 samples),
             3 probe requests (encode_prefolded -> render_novel_view_probe
             at its defaults), 3 SSC voxel queries (encode_prefolded ->
             fast_query_fused over the 2,097,152 voxel centres) and 3
             encode-view renders (encode_prefolded -> render_encode_view,
             K6);
             the launch counters, zeroed before each path and read after
             it, show each path's kernels ran; stage times and profiles;
             then small requests of the exact, probe and query paths are
             checked against the same model run on the CPU
  5 train    the flagship stage-1 training step (configs/
             train_scenedino_kitti_360.yaml: student ViT-B/8 + DPT 256 and
             frozen ViT-B/8 teacher in bf16, FeatUp downsampler, 64->768
             MLP, artifact field, 192x640, batch 4, V = 4, 2048 rays in
             8x8 patches, 32 samples, two-group Adam) takes 3 steps on
             seeded random weights and seeded images; each step must be
             finite, applied and move the parameters, with 12 launches of
             each backward kernel; stage times, peak memory and a
             profile; then one step at 32x96 is checked against the same
             model run on the CPU
  5b fp32    one step of the synthetic smoke recipe (configs/
             train_synthetic_smoke.yaml: fp32, ViT-S/8 cut to width 64,
             depth 3, 2 heads, 48x96, batch 2): its attention takes the
             ViT's plain branch, so the step launches no kernel; it must be
             finite, applied and move every parameter tensor
  6 train run the port's stage-1 run (scenedino_torch.cli.train.run_stage1)
             on configs/train_synthetic_flagship.yaml, read by the port's
             own YAML reader, at full width with the cuts printed on its
             first line: 6 steps (each step's loss and host ms), validation
             renders at 3 and 6 (depth, dino and nvs metrics), checkpoints
             (write ms), peak memory, the K1 launch counts against what the
             steps (remat recomputes the student's blocks) and validations
             need; the checkpoint loaded into a fresh model equals the run's
             state; the run resumed from it to step 9; the validation render
             at 32x64 on the GPU against the CPU; 3 steps and a validation of
             configs/train_synthetic_convergence.yaml (fp32, the fine pass)
  7 stage 2  the port's stage-2 run (cli.train.run_stage2) at full width:
             train_synthetic_flagship.yaml's model (ViT-B/8, DPT 256,
             d_hidden 128, bf16, 192x640) with train_semantic_kitti_360.yaml's
             downstream, loss, optimizer and validation blocks, the synthetic
             dataset at batch 4, resume_from phase 6's run directory; cuts
             printed on its first line. Each step's losses and host ms, the
             seeding's ms, each validation's metrics and ms, peak memory;
             every step finite and applied, the head moved, the field
             bitwise unchanged, the K1 and K6 launch counts the steps, the
             seeding and the validations imply, each validation's pseudo
             assignment written into both cluster heads, the checkpoint
             loaded back equal, a resume to step 9; then downstream_forward
             at 32x64 on the GPU against the CPU with the same draws, on the
             front view (linear probes) and the side view (STEGO terms); a
             loss 0 on both sides in both fails
  7b         3 steps and a validation of
             configs/train_semantic_synthetic_convergence.yaml (fp32, tiny
             ViT, d_hidden 64) from tests/goldens/s1b_field_params.npz
  8 eval     evaluation from phase 7's run directory. 8a: a seeded
             SSCBench-KITTI-360 tree of 3 frames of sequence 09 (376x1408
             PNGs written by the port, the release's P_rect_00 and camera
             -> velodyne, poses, voxel GT of SSCBench ids and 255) through
             cli.evaluate_sscbench.main (encode_prefolded, K4 over 4 blocks
             of 524,288 voxel centres a frame, the head, the
             alpha-weighted argmax, the host accumulation); the table
             finite in [0, 1], each range's occupancy numbers covering its
             valid in-view voxels, 12 K1 and 4 K4 launches a frame; one
             frame with --test-alpha-cutoffs; ties of the alpha-weighted
             argmax take the first class; K4 on each block of one frame
             against point_query_plain (phase 3c's error over each point's
             largest output; the trained field's outputs exceed 1) and the
             labels of both (99.9 % of in-view voxels); K4's times at the
             block; the
             fast path against --slow (printed, not gated). 8b: a seeded
             Cityscapes tree of 3 frames at 1024x2048 through
             cli.evaluate.main with configs/evaluate_semantic_cityscapes.yaml
             and phase 7's model and downstream blocks (encode, the fp32
             fold, K6, the 768-d expansion, four modes); every value finite
             in [0, 1], 12 K1 and 1 K6 launches a frame; once with apply_crf
             on one frame; K6 on one frame against its plain version (fp32
             bounds) and the four modes' labels of both (99.9 %)
  9 reference the reference's checkpoints: for the published
             ssc-kitti-360-dino (configs/train_semantic_kitti_360.yaml's
             model: ViT-B/8) and -dinov2 (configs/
             train_scenedino_kitti_360_dinov2.yaml: ViT-B/14, LayerScale,
             a 37x37 position embedding) architectures, a seeded full-width
             field and head of 19 clusters written as the reference's
             trainer writes checkpoint.pt ({"model": BTSWrapper names}, with
             the artifact field); load_eval_state loads each strictly, bit
             for bit; cli.evaluate_sscbench.main on phase 8a's tree with
             --ckpt <x>.pt --config <yaml> (bf16 through with_amp; 12 K1
             and 4 K4 a frame for v1, 0 K1 for v2's 481 tokens) prints the
             same table and accumulates the same numbers as on the same
             weights saved as a port run; K1 (v1) and K4 (both) against
             their plain versions on the inputs those runs give them; the v2
             encoder on the GPU against the CPU (the 14/16 pre-resize at
             192x640, the fp32 ViT at 64x128); one novel-view request on
             the v2 field (K2) and K2 on its inputs; cli.evaluate.main with
             evaluate_semantic_cityscapes.yaml's variant: dinov2 on phase
             8b's tree (one K6 a frame) and K6 on its first frame; the
             encode times (per frame, and the encoder alone by CUDA events)
             and sec_per_frame of both, beside the card's name and limit
  10 kitti   the KITTI-360 data path. 10a: a seeded tree in the release's
             layout (56 posed frames of one sequence, 376x1408 perspective
             and 1400x1400 fisheye pairs as Paeth-filtered PNGs, the
             release's calibration with the fisheye YAMLs in its
             FileStorage layout, velodyne scans, KITTI-360 labels, the
             repository's SSCBench training lines that the tree holds and 3
             test items), cli.preprocess_kitti_360 resize, an item through
             the cache against the same item resampled on the fly (one 8-bit
             step), the loader's host ms per item (raw, cached) and per batch
             of 4; 10b: cli.train.main on train_scenedino_kitti_360.yaml at
             full width (3 steps, one validation of 2 test items on the
             velodyne depths, a checkpoint; each step's host ms and loader
             wait); 10c: cli.train.main --stage semantic on
             train_semantic_kitti_360.yaml from 10b's run (3 steps, one
             validation on the labels as train ids; the head moved, the field
             bitwise unchanged); 10d: cli.evaluate.main on
             evaluate_semantic_kitti_360.yaml with 10c's model over the 3
             test items (12 K1 and 1 K6 a frame), K6 on the first frame
             against its plain version; 10e, on the host: KITTI_360_v2 items
             (overlap sampling) and SSCBench items with the fisheye views;
             then K1's forward at the shapes 10b-10d gave it that phase 2
             does not time (the stage-1 teacher's 16 frames, stage 2's 4
             frames without the log-sum-exp), as phase 2 times its own
  11 d80 and upsample-gt. 11a: K1 at head dim 80 (csrc/attention_d80.cu,
             the forward; csrc/attention_d80_bwd.cu, dq and dkv):
             the forward without and with the log-sum-exp, dq and dkv
             against their plain versions (phase 2's bounds) at (1, 585,
             16, 80) and (4, 585, 16, 80), I-JEPA-H/14's forward at 192x640
             and four of it, and (4, 1921, 12, 80) and (2, 1921, 12, 80),
             the teacher and the student of 11's D = 80 training step; two launches bitwise equal; kernel,
             plain, SDPA (forward and backward, both also as their
             kernels' device time beside the kernels') and bound times,
             dq + dkv's TFLOP/s over their 7 products and share of the
             SDPA backward; the kernels line's D = 80 entries are timed at
             the student's shape; then keys scaled by 1 + 4 n / N
             (ROADMAP queue 3): the card test's input (2, 1921, 12, 80)
             through the D = 80 forward (held at K1's bound), SDPA, the
             D = 64 forward on the same construction at D = 64 and the fp32
             plain version, and the same construction at 4 seeds and 4
             shapes at both head dims, printed. 11b: the
             I-JEPA-H/14 backbone (32 blocks, width 1280, 16 heads of 80, no
             class token) from seeded weights in the reference's layout
             through utils.convert.convert_ssl_vit into make_vit
             ("i_jepa_huge") in bf16: the 192x640 forward (CUDA events,
             and one forward profiled: device busy, idle share), 32 launches of
             the D = 80 forward; its first 2 blocks at 196x518 on the GPU
             against the CPU; then 2 steps of the flagship stage-1 step
             (trainer.make_train_step, bf16, 192x640, batch 2) with
             vit_overrides width 960, 12 heads: heads of 80 through the
             training entry point, each step 24 forward, 12 dq and 12 dkv
             launches at D = 80. 11c: cli.train.main on
             configs/train_scenedino_kitti_360_upsampler.yaml (upsample-gt,
             the multiscale-crop teacher: 4 views of each of the 16 loss
             images a step, a per-pixel target) at full width on phase 10's
             tree and cache: 3 steps and a validation of 2 items; each
             step's host ms and loader wait, peak memory, the launches, the
             losses finite, no step skipped, every student parameter moved,
             the validation finite; the teacher's K1 shape (64, 1921, 12,
             64) timed as phase 2 times its own
  12 re10k  the RealEstate10K path. 12a: a seeded tree in the release's
             layout (2 sequences of 100 camera rows as train/<seq>.txt,
             through cli.process_re10k process into train.pickle; the 10
             frames a sequence that the loader's ::10 subsample reads, as
             640x360 baseline 4:2:0 JPEGs by image_io.write_jpeg), the
             decode of each frame against what was written (PSNR), a
             frame's decode and INTER_AREA resize, an item and a batch of 4
             (host ms); 12b: cli.train.main on train_scenedino_re10k.yaml at
             full width (ViT-B/8 student and teacher, DPT 256, FeatUp, bf16,
             288x512, batch 4, 4 frames, the "alternate" split; cuts: 3
             steps, a validation of 2 items, one checkpoint): each step's
             host ms and loader wait, peak memory, the losses finite, no
             step skipped, every student tensor moved, the launches; 12c:
             K1's forward at the batches 12b gave it at 2305 tokens
             (the student's (4, 2305, 12, 64) with the log-sum-exp, the
             teacher's 8, the validation's 1 and 4) and dq + dkv at (4, 2305,
             12, 64) against their plain versions (phase 2's bounds), two
             launches bitwise equal, kernel, plain, SDPA and bound times
  13 stage1 the rest of stage 1: the uncertainty and consistency branches,
             gradient accumulation, the sample-count schedule, the render
             modes, the data-parallel wrapper, the dinov2 recipe, the
             depth-convergence tool
  14 serve  serving, the rest, on the flagship model (ViT-B/8, DPT 256,
             bf16, 192x640, seeded weights). 14a: one frame's folded state
             exact (bf16) and int8 (`build_fast_state(quantize_grid=True)`):
             the unfused render_novel_view of both on the same strata within
             the reference's closeness bounds (tests/test_fast_field.py:178-183:
             mean depth difference < 0.8 m, mean feature cosine > 0.995, mean
             colour difference < 0.05), fast_query of both over the 2,097,152
             SSCBench voxel centres (the mean sigma difference within 0.1 of
             its spread + 0.05, the mean feature cosine > 0.995), the int8
             encode view through K6 against its plain version (phase 3e's
             bf16 bounds), the fused paths' refusal of the int8 state; 14b:
             the unfused exact render against render_novel_view_fused (K2)
             on the same state and strata (phase 3's bounds; colour 1e-2,
             the unfused lookup blends the bf16 image in bf16); 14c:
             make_pipelined_stream_step over 4 frames against the two calls,
             bit for bit, host ms of each; 14d: cli.generate_ply_sequence on
             phase 8a's tree with phase 7's run, 2 frames at the evaluation's
             0.2 m grid, fast and --pipelined: the same bytes, each frame's
             host ms and the launches; 14e: cli.demo on a seeded 192x640 PNG
             with phase 7's run: host ms of the encode, the 2D render, the
             PCA and the 3D grid, peak memory, every file written and finite;
             14f: the probe-serving bound on the trained s1b field through
             K3, the row gather and K2 (tools/probe_quality_trained; the
             exact render and the 128-sample gold through K2)
  15 multi  the device-parallel paths, on the one card named several times
             (its shares run in turn) and on make_mesh() (every visible
             card). 15a, the flagship serving model (bf16, 192x640, 32
             samples): render_novel_view_fused_sharded over [cuda:0] x 4 and
             over make_mesh() against render_novel_view_fused on the same
             state and strata, bit for bit, one K2 launch a share, host ms of
             each; make_sharded_renderer over [cuda:0] x 4 against
             render_rays on the same draws (12,288 rays through the unfolded
             field). 15b: cli.evaluate_sscbench on phase 8a's tree with phase
             7's run, in turn, --data-parallel with the CLI's mesh set to
             [cuda:0] x 2 (make_sharded_frame_predictor over the card twice:
             a group of 2 frames, then a short group of 1) and --data-parallel
             over make_mesh(): the same tables and accumulated numbers, the
             launches (12 K1, 4 K4 a frame), sec_per_frame of each. 15c:
             cli.evaluate on phase 8b's tree, the same three runs
             (Seg2DEvaluator.run_sharded over [cuda:0] x 2): the same metrics
             exactly, 12 K1 and one K6 a frame. 15d: 2 stage-2 steps of phase 7's config
             through the data-parallel wrapper (NCCL, world size 1) against
             the plain step (losses and head equal), the generic (unfolded)
             stage-2 render against the folded one (K6) on one batch within
             phase 7's render bounds with both host times, and a
             downstream.mode 2d step (the head's five crops)
  16 eval    evaluation, the rest: 16a the stage-1 validator (phase 6's
             run, bf16, one 192x640 item of the synthetic dataset with
             occupancy probe points and labels) with metrics depth, dino,
             nvs (LPIPS alex from a seeded state dict written in the lpips
             naming) and occ, and its "images"; the same bf16 validator at
             128x256 (513 tokens: K1 on the card, plain attention on the
             CPU) on the card and on the CPU with the same draws, at bounds
             read from that pair (VAL_BF16); the same validator in fp32 at
             64x128 on the card and on the CPU with the same draws (the
             CPU tests' bounds: the render's depths and colours and every
             metric within 1e-4, the occupancy metrics equal; the panels
             within one level), cuDNN on and TF32 off for both. 16b
             cli.evaluate_sscbench --mode s4c on phase 8a's tree with a
             seeded S4C field snapshot (Monodepth2, d_hidden 64, 20 outputs:
             K4 at D = 64, E = 20), K4 against its plain version on one
             block, timed. 16c cli.evaluate with apply_crf and crf_method
             exact on one frame of phase 8b's tree (the CRF's host ms). 16d
             two 192x640 depth frames rendered by K2 fused into a TSDF volume
             on the card and on the CPU (weights equal, TSDF within 1e-5), a
             surface PLY
  17 rest    the port's last slice: 17a cli.sweep.run_sweep (random
             backend) over configs/train_synthetic_flagship.yaml at full
             width, 2 trials of 3 steps and one validation each (cuts
             printed): each trial's drawn lr, status and best score, the K1
             forward / dq / dkv launches against what the steps and
             validations need; 17b one stage-1 step of that config's field
             with a MultiViewHead over 2 encode views at 192x640 (a finite
             loss, every head parameter a gradient, K1's launches), then the
             four multi-view head types at a small width on the card and on
             the CPU with the same weights (fp32, MVH_TOL); 17c
             cli.demo_gradio.demo_run with phase 7's run at 192x640 in each
             of the five modes (panel, occupied voxels, 12 K1 launches each)
             and its voxel guard; 17d RAFT (12 iterations) and both pixelNeRF
             encoders with seeded weights on the card and on the CPU (fp32,
             RAFT_TOL, PIXELNERF_TOL); the phase's wall time against its
             120 s target
  18 shapes every shape the JAX package takes, on the flagship's widths:
             18a render_novel_view_fused at 128 and 256 samples a ray (two and
             four of K2's 64-point tiles a ray), expectation and weight-median
             depth, and render_novel_view_probe at n_probe 96 (K3 over two
             tiles a probe ray), each through its entry point with the counts
             zeroed just before it and read just after, equal to its kernel's
             launch on the same inputs, which is held against its plain
             version (phase 3's bounds and median rule), timed beside the
             plain version and the bound; 18b render_encode_view at 128
             samples, and at 32 on a field of num_freqs 8 (17 z-code
             columns: K6's second k16 step), the same way (phase 3e's bf16
             bounds); 18c the smoke recipe's ViT (vit_overrides: width 64,
             depth 3, 2 heads of 32) in bf16 at 192x640 (1921 tokens), one
             stage-1 step on the card (K1's forward, dq and dkv at head dim
             32 from csrc/attention_any.cu, counted) against the same step on
             the CPU (phase 5's bounds), then K1 at (2, 1921, 2, 32), (2,
             1921, 4, 96), (2, 1921, 6, 128) and (2, 1921, 2, 256) against
             the plain versions, two launches bitwise equal, kernel, plain,
             SDPA and bound times, CUDA events and device time, and at head
             dim 20 (padded to 24 by the wrappers) against the plain
             versions; 18d phase 11a's 16
             scaled-keys cases at head dims 64 and 80 with the shipped build
             (the exact rescale), every forward within K1_TOL, counts above
             SDPA and above 1.5625e-2; the phase's wall time against its 30 s
             target
  19 widths every width the JAX package takes (the wide walk of
             csrc/wide_walk.cuh). 19a the flagship with its head widened to
             d_hidden 512, dino_dims 768, num_freqs 16 (E 769, 99 point-code
             and 33 z-code columns): 3 requests through each serving path
             (novel view: K1, K2; probe: K1, K3, the gather, K2; SSC query
             over the 256x256x32 grid: K1, K4; encode view: K1, K6 bf16),
             the counts zeroed before each path and read after it, exact,
             and one render_encode_view of the fp32 fold (K6 fp32); outputs
             finite, of the right shape, depth in [3, 80]; then K2, K3, K4
             and both K6 states against their plain versions on a request's
             inputs (phases 3-3e's bounds, at num_freqs 16 too: the kernels
             and the plain versions normalize depth with the same float32
             constants and roundings, core/encoding.zn_constants). 19b seeded fields at d_hidden 256 with 129
             outputs, d_hidden 132, num_freqs 11 (69 code columns), each
             kernel against its plain version at the paths' shapes; on the
             shipped widths K2 and K6 at 512 samples (both depth
             statistics) and K3 at n_probe 320. 19c each new shape's kernel,
             plain and bound times; the phase's wall time against its 60 s
             target
  20 heads   K1 past head dim 256 (csrc/attention_wide.cu). 20a the
             forward (with the log-sum-exp), dq and dkv at (2, 1921, H, D)
             for D 384 / 768 / 512 / 320 / 1280 / 264 (the ViTs of wide
             heads) against the plain versions, two launches bitwise equal,
             timed beside SDPA (its backend named) and the bound, CUDA events
             and device time, and at D 300 (padded to 304) untimed; 20b the
             flagship serving model (bf16) with vit_overrides num_heads 2 (D
             384): 3 exact novel-view requests (K1 12 a request, K2), then
             num_heads 1 (D 768), one request, each model against itself on
             the CPU (a 64x640 frame encoded: 641 tokens, so the card takes
             K1; a 32x96 view rendered; phase 4's bounds); 20c one stage-1
             step of the flagship recipe with num_heads 2 at batch 4 (the
             wide forward once a student and a teacher block, dq and dkv once
             a student block, counted exactly; finite, every parameter
             moves), then num_heads 2 at depth 3 (DPT taps 0, 1, 2), batch 1,
             64x640 on the card and the CPU (phase 5's bounds); the phase's
             wall time against its 60 s target
  kernels    one JSON line: launches (all serving paths, training, the
             train run, stage 2, evaluation, phases 9-18 together), error, times and
             bound per kernel (K1 at every other head dim as attention_any,
             attention_any_bwd_dq and attention_any_bwd_dkv, at phase 18c's
             (2, 1921, 2, 32), with the device times of the forward, of dq +
             dkv and of SDPA's forward and backward beside the events');
             the K1 forward's, K4's and K6's also at
             their shapes ("shapes": K4 at the evaluation's block, K6 at
             the 2D evaluator's fp32 frame; phase 9's holds of K1, K2, K4
             and K6 under "reference checkpoints"; K1's forward, dq and dkv at
             the RE10K recipe's 2305 tokens under "RE10K recipe"; phase 18's
             K2 at 128 and 256 samples, K3 at n_probe 96, K6 at 128 samples
             and at num_freqs 8, K1 at head dims 32 and 128; phase 19's K2,
             K3, K4 and K6 at each new width, with their launches counted;
             K1 past head dim 256 as attention_wide, attention_wide_bwd_dq
             and attention_wide_bwd_dkv at phase 20a's (2, 1921, 2, 384),
             its six other shapes under "shapes", SDPA's backend beside)
The line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is {"ok": true, "device": {...}}.
Any failed phase exits non-zero before that line. Needs one CUDA card;
exits non-zero without one, and outside a checkout of the repository.
"""
import argparse
import contextlib
import copy
import dataclasses
import json
import logging
import os
import re
import socket
import sys
import tempfile
import time

import numpy as np
import torch

H, W, K = 192, 640, 32
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the special-function unit's exp2: 16 a cycle an SM, 132 SMs at about 1.83 GHz
PEAK_EXP2 = 3.9e12
# phase 2's K1 forward shapes: (batch, with the log-sum-exp) at 1921 tokens, 12 heads of 64
K1_PHASE2_SHAPES = ((1, False), (4, True), (8, False))
# bounds of the kernel-vs-plain comparisons
K1_TOL = 2e-2  # bf16 output (ulp 2^-8 at |x| ~ 1) plus P rounded to bf16 for P @ V
K1_LSE_TOL = 1e-3  # fp32 statistics of the same bf16 logits, another order, approximate exp2
K2_DEPTH_TOL = 5e-2  # metres: sample weights move by bf16 rounding flips of h
K2_FEAT_TOL = 5e-3  # one bf16 ulp of h through W2 (|W2| ~ 0.1)
K2_RGB_TOL = 5e-3  # fp32 colour blend on both sides; only the weights differ
# the median depth is a sample depth: the kernel's is the plain version's
# sample, or its neighbour where a bf16 flip of h moves the CDF across 0.5
# (a near tie), on at most this share of rays
K2_MEDIAN_FLIPS = 1e-2
K3_TOL = 5e-3  # weights in [0, 1], moved by bf16 rounding flips of h as K2's are
# per point, where K2's feature is averaged over a ray's samples: about two
# bf16 flips of h (ulp 2^-6 at |h| < 4) through W2 entries (|w| < 0.35);
# on points nearer than z_near, relative to the point's largest output
K4_TOL = 1e-2
# the backward kernels against the plain fp32 backward, per output: this
# fraction of the largest |plain| value plus 1e-3 (P and dS are rounded to
# bf16 for the tensor-core products and the results to bf16)
K1_BWD_REL = 2e-2
# the small-input check: the same bf16 model on the GPU (kernels) and on the
# CPU (plain versions), summed in other orders through 12 blocks and the DPT
SLICE_DEPTH_REL = 1e-2
SLICE_COS = 0.99
# the probe path resamples depths by comparing draws with the probe's
# weight CDF, a step function of the weights: a draw within the two
# runs' weight differences of a step picks the next bin, so a few rays
# may differ by more; the bound holds at the 99th percentile
PROBE_DEPTH_REL_P99 = 1e-2
# the query's sigma against its largest value (sigma near 0 has no
# meaningful relative error)
QUERY_SIGMA_REL = 1e-2
# the small training check, same bf16 model and draws on the GPU and the
# CPU: the loss is a mean over ~1e5 terms whose bf16 rounding differs
# element by element; a gradient tensor's relative L2 error collects those
# differences through 12 blocks forward and back
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL = 0.1
TRAIN_STEPS = 3
# phase 6: the flagship run's cuts (dataset items, steps, the resume's last step)
TRAIN_RUN_ITEMS = 8
TRAIN_RUN_STEPS = 6
TRAIN_RUN_RESUME_TO = 9
# phase 7: the stage-2 run's cuts (dataset items, steps, the resume's last step,
# validation items)
STAGE2_ITEMS = 8
STAGE2_STEPS = 6
STAGE2_RESUME_TO = 9
STAGE2_VAL_ITEMS = 4
# downstream_forward at 32x64, GPU against CPU, the flagship's bf16 field with
# the same draws, once on the front view (the only one with segmentation: the
# linear probes' losses) and once on the side view (the draws' own coin and
# view: the crops there are valid, so the STEGO terms are not 0). The render as
# phase 6's (depth p99, feature cosine); the cluster and probe losses are means
# over the 2 x 2048 pixels' bf16-rounded features, held relative; the STEGO
# terms are means over 10 crops of terms near 0 (a few 1e-2), held absolute.
# The errors measured on the card (NVIDIA H100 80GB HBM3, 700.00 W): head
# losses 1.2e-4 relative, STEGO terms 2.0e-5 to 1.7e-4. A loss that is exactly
# 0 on both sides compares nothing, and fails the check
STAGE2_HEAD_LOSS_REL = 2e-3
STAGE2_STEGO_ABS = 1e-3
# the validation render at 32x64, GPU against CPU, bf16: its depths and colours
# are the same kind of sums as phase 4's, over 4 views; the 99th percentile
# allows a few rays whose weights move with bf16 rounding near a surface
EVAL_DEPTH_REL_P99 = 1e-2
EVAL_RGB_ABS = 2e-2
# kernels of csrc/point_render.cu: the shipped instantiations, K2 and K4 at 2
# hidden x 2 output widths each, K3 at 2 hidden widths, K2 and K3 again for
# the multi-tile walk (16); the wide walk's (csrc/wide_walk.cuh), K2 and K3
# by walk and K4 (5); its weight packing (1)
POINT_KERNELS = 16 + 5 + 1
# instantiations of csrc/attention_any.cu: the forward, dq and dkv at the 4
# padded widths (64, 128, 192 and 256 columns), at 64 columns one for each
# count of k-steps (1 to 4) of the products over the head dim
ANY_KERNELS = 21
# phase 11a: K1 at head dim 80 (csrc/attention_d80.cu, attention_d80_bwd.cu) at
# I-JEPA-H/14's 192x640 forward (13 x 45 = 585 tokens, 16 heads), four of them, and phase
# 11's D = 80 training step (1921 tokens, 12 heads of 80): its teacher on the
# 4 loss images and, last, its student, each with its backward
D80_SHAPES = ((1, 585, 16), (4, 585, 16), (4, 1921, 12), (2, 1921, 12))
# phase 11: the D = 80 training step's cuts (its ViTs: ViT-B/8 with 12 heads
# of 80; batch, steps) and the upsampler recipe's (steps, validation items)
D80_TRAIN_WIDTH, D80_TRAIN_B, D80_TRAIN_STEPS = 960, 2, 2
UPSAMPLER_STEPS, UPSAMPLER_VAL_ITEMS = 3, 2
# phase 11a, keys scaled by 1 + 4 n / N along the walk (ROADMAP queue 3):
# tests/test_torch_kernels.py::test_attention_d80_kernels_match_plain's input
# (its seed 200 + N), held at K1_TOL like every shape; the same construction
# at other seeds and shapes, both head dims and SDPA, printed beside it
SCALED_KEYS = (2, 1921, 12)
SCALED_SWEEP = ((4, 585, 16), (2, 1921, 12), (4, 1921, 12), (4, 2305, 12))
SCALED_SEEDS = (1, 2, 3)
# phase 13: the stage-1 branches on train_synthetic_flagship.yaml's model (the
# plain steps, then the branches' micro-steps with gradient_accum_factor 2), the
# sample-count ramp (renderer.sched: 16 coarse samples, 24 from step 1, 32 from
# step 2), the dinov2 recipe's cuts on phase 10's tree, the items the depth
# diagnosis renders of phase 6's run
BRANCH_PLAIN_STEPS = 2
BRANCH_MICRO_STEPS = 4
SCHED_RAMP = [[1, 2], [24, 32], [0, 0]]
DINOV2_STEPS = 3
DINOV2_VAL_ITEMS = 2
DIAG_ITEMS = 2
# phase 12: the RealEstate10K tree (sequences, camera rows each; frames are
# the rows the loader's ::10 subsample reads, 640x360 as the repository's
# download fetches them), the JPEGs' quality and the least PSNR of the
# decoded frames against what was written, the recipe's cuts (steps,
# validation items)
RE10K_SEQS, RE10K_ROWS, RE10K_FRAME = 2, 100, (360, 640)
RE10K_QUALITY, RE10K_PSNR_MIN = 90, 30.0
RE10K_STEPS, RE10K_VAL_ITEMS = 3, 2
RE10K_H, RE10K_W = 288, 512  # the recipe's image_size: 36 x 64 patches of 8 and the class token, 2305 tokens
# phase 11b: the I-JEPA-H/14 ViT's first blocks at 196x518 (14 x 37 = 518
# tokens, so the card takes K1) on the GPU against the CPU, both bf16
IJEPA_CHECK_DEPTH, IJEPA_CHECK_SIZE = 2, (196, 518)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def novel_pose(device):
    """0.3 m right, 0.1 m up, 3 degrees of yaw (bench.py's novel camera)."""
    c, s = np.cos(0.05), np.sin(0.05)
    m = np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.0], [0, 0, 0, 1]], np.float32)
    return torch.from_numpy(m).to(device)


def intrinsics(device):
    return torch.tensor([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], device=device)


def k1_forward_shape(gen, B, with_lse, path, phase="phase 2", N=1921):
    """K1's forward at (B, N, 12, 64) bf16 (N = 1921 at 192x640, 2305 at
    288x512): output and (where the path asks for it) log-sum-exp against
    the plain versions, two launches bitwise equal, kernel, plain, SDPA and
    bound times; the shape's entry."""
    from scenedino_torch.kernels.attention import attention_fwd, attention_lse_plain, attention_plain
    from scenedino_torch.utils.timing import time_ms

    Hh, D = 12, 64
    q, k, v = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    out, lse = attention_fwd(q, k, v, with_lse=with_lse)
    again = attention_fwd(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and (lse is None or torch.equal(lse, again[1]))):
        fail(f"K1 forward ({B}, {N}, {Hh}, {D}): two launches on the same inputs differ")
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item() if with_lse else None
    if not (torch.isfinite(out).all() and err <= K1_TOL and (lse_err is None or lse_err <= K1_LSE_TOL)):
        fail(f"K1 forward ({B}, {N}, {Hh}, {D}) disagrees with its plain version: max abs err {err} (bound "
             f"{K1_TOL}), lse {lse_err} (bound {K1_LSE_TOL})")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: attention_fwd(q, k, v, with_lse=with_lse), inner=10)
    plain_ms = time_ms(lambda: attention_plain(q, k, v), reps=5)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    flops = 4.0 * B * Hh * N * N * D
    b, by = bound_ms(flops, (4 * B * N * Hh * D * 2) + (B * Hh * N * 4 if with_lse else 0))
    lse_text = f", lse {lse_err:.3e} (bound {K1_LSE_TOL})" if with_lse else ""
    print(f"{phase} K1 forward ({B}, {N}, {Hh}, {D}) bf16, {path}{' with the lse' if with_lse else ''}: "
          f"max_abs_err {err:.3e} (bound {K1_TOL}){lse_text}; two launches bitwise equal; kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s; the kernel takes {ms / lib_ms:.2f} of it), bound {b:.4f} ms "
          f"({by})", flush=True)
    return {"shape": [B, N, Hh, D], "lse": with_lse, "max_abs_err": err, "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def phase_k1(gen):
    """The forward at the three shapes its paths give it (`k1_forward_shape`)."""
    shapes = [k1_forward_shape(gen, B, with_lse, path)
              for (B, with_lse), path in zip(K1_PHASE2_SHAPES, ("serving", "student", "teacher"))]
    serving = shapes[0]
    return {"name": "attention", "route": "cuda", "source": "scenedino_torch/csrc/attention.cu",
            "replaces": "scenedino_tpu/models/vit.py:126",
            "max_abs_err": max(e["max_abs_err"] for e in shapes),
            **{key: serving[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shapes": shapes}


def k1_backward_shape(gen, B, N, phase="phase 2b"):
    """The backward kernels (dq; dk and dv) at (B, N, 12, 64) bf16 against
    the plain fp32 backward, two launches bitwise equal, kernel, plain, SDPA
    and bound times; the shape's entry."""
    from scenedino_torch.kernels.attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_fwd,
    )
    from scenedino_torch.utils.timing import time_ms

    Hh, D = 12, 64
    q, k, v, do = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    # no atomics: a second launch gives the same bits
    dq2, di2 = attention_bwd_dq(q, k, v, o, do, lse)
    dk2, dv2 = attention_bwd_dkv(q, k, v, do, lse, di2)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in ((dq, dq2), (di, di2), (dk, dk2), (dv, dv2))):
        fail(f"K1 backward ({B}, {N}, {Hh}, {D}): two launches on the same inputs differ")
    ref = attention_bwd_plain(q, k, v, o, do, lse)
    errs, bounds = [], []
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs.append((got.float() - r.float()).abs().max().item())
        bounds.append(K1_BWD_REL * r.float().abs().max().item() + 1e-3)
        if not (torch.isfinite(got).all() and errs[-1] <= bounds[-1]):
            fail(f"K1 backward {name} ({B}, {N}, {Hh}, {D}) disagrees with the plain backward: max abs err "
                 f"{errs[-1]} > {bounds[-1]}")

    ms_dq = time_ms(lambda: attention_bwd_dq(q, k, v, o, do, lse), inner=5)
    ms_dkv = time_ms(lambda: attention_bwd_dkv(q, k, v, do, lse, di), inner=5)
    plain_ms = time_ms(lambda: attention_bwd_plain(q, k, v, o, do, lse), reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), inner=5)
    # FlashAttention-2's count with S recomputed: QK^T, dO V^T, dS K, dS^T Q
    # and P^T dO, each 2 N^2 D per (batch, head); dq alone needs the first
    # three, dk and dv alone the other two after the first two again
    unit = 2.0 * B * Hh * N * N * D
    t_bytes, s_bytes = B * N * Hh * D * 2, B * Hh * N * 4
    b_dq, by_dq = bound_ms(3 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v o dO dq; lse, di
    b_dkv, by_dkv = bound_ms(4 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v dO dk dv; lse, di
    b_all, by_all = bound_ms(5 * unit, 8 * t_bytes + s_bytes)
    bytes_ms = [n / PEAK_BYTES * 1e3 for n in (6 * t_bytes + 2 * s_bytes, 8 * t_bytes + s_bytes)]
    print(f"{phase} K1 backward ({B}, {N}, {Hh}, {D}) bf16: max_abs_err dq {errs[0]:.3e} (bound {bounds[0]:.3e}), "
          f"dk {errs[1]:.3e} (bound {bounds[1]:.3e}), dv {errs[2]:.3e} (bound {bounds[2]:.3e}); kernel dq "
          f"{ms_dq:.4f} ms, dkv {ms_dkv:.4f} ms, together {ms_dq + ms_dkv:.4f} ms "
          f"({7 * unit / (ms_dq + ms_dkv) / 1e9:.1f} TFLOP/s over their 7 products; two launches bitwise equal); "
          f"plain backward {plain_ms:.4f} ms; sdpa backward {lib_ms:.4f} ms (the pair takes "
          f"{(ms_dq + ms_dkv) / lib_ms:.2f} of it); bound dq {b_dq:.4f} ms ({by_dq}), dkv "
          f"{b_dkv:.4f} ms ({by_dkv}), the whole backward at 10 N^2 D B H FLOP {b_all:.4f} ms ({by_all}); "
          f"bytes terms: each kernel {bytes_ms[0]:.4f} ms, the whole backward {bytes_ms[1]:.4f} ms",
          flush=True)
    return {"shape": [B, N, Hh, D], "bwd_errs": errs, "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_dq_ms": b_dq, "bound_dq_by": by_dq, "bound_dkv_ms": b_dkv,
            "bound_dkv_by": by_dkv}


def bwd_entries(e):
    """A `k1_backward_shape` entry as the kernels line's dq and dkv fields."""
    return ({"max_abs_err": e["bwd_errs"][0], "ms": e["ms_dq"], "bound_ms": e["bound_dq_ms"],
             "bound_by": e["bound_dq_by"], "plain_ms": e["plain_ms"], "library_ms": e["library_ms"]},
            {"max_abs_err": max(e["bwd_errs"][1:]), "ms": e["ms_dkv"], "bound_ms": e["bound_dkv_ms"],
             "bound_by": e["bound_dkv_by"], "plain_ms": e["plain_ms"], "library_ms": e["library_ms"]})


def phase_k1_bwd(gen):
    """Phase 2b: the backward kernels at the training step's student (4, 1921, 12, 64)."""
    dq, dkv = bwd_entries(k1_backward_shape(gen, 4, 1921))
    common = {"route": "cuda", "source": "scenedino_torch/csrc/attention_bwd.cu"}
    return [
        {"name": "attention_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         **dq, **common},
        {"name": "attention_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         **dkv, **common},
    ]


def flagship_field(gen, dev="cuda"):
    """The serving head's folded grid and weights at the flagship widths:
    384x1280x128 bf16 grid, W_code 39x128, W2 128x65 (seeded random)."""
    Hg, Wg, D, E, C = 2 * H, 2 * W, 128, 65, 39

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    grid = randn(Hg, Wg, D).to(torch.bfloat16)
    w_code = randn(C, D, scale=C ** -0.5).to(torch.bfloat16)
    b1 = randn(D, scale=0.1)
    w2 = randn(D, E, scale=D ** -0.5).to(torch.bfloat16)
    b2 = randn(E, scale=0.1)
    b2[0] += 0.5
    return grid, w_code, b1, w2, b2


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _ray_points(rays, z):
    return (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)


def corner_traffic(points, D):
    """The corner rows the kernel reads, (points x 4 x D x 2 B), and their
    time at 3.35 TB/s: a yardstick beside the bound, which counts each
    distinct grid row once."""
    n = points * 4 * D * 2
    return f"corner rows {n / 1e9:.3f} GB, {n / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s"


def grid_rows_read(pts, grid, w2c, k):
    """Distinct rows of the (Hg, Wg, D) grid that the 4-corner lookups of
    world points `pts` (P, 3) read, from the plain version's corner
    indices: the grid bytes a kernel over these points must move are these
    rows, not the whole grid."""
    from scenedino_torch.core import cameras
    from scenedino_torch.kernels.point_render import _corners, _to_pixel

    Hg, Wg, _ = grid.shape
    seen = torch.zeros(Hg * Wg, dtype=torch.bool, device=pts.device)
    for p0 in range(0, pts.shape[0], 1 << 20):
        xy = cameras.project(pts[p0:p0 + (1 << 20)], w2c, k)[0]
        (y0, x0, y1, x1), _, _ = _corners(_to_pixel(xy[:, 0], Wg), _to_pixel(xy[:, 1], Hg), Hg, Wg)
        for row in (y0 * Wg + x0, y0 * Wg + x1, y1 * Wg + x0, y1 * Wg + x1):
            seen[row] = True
    return int(seen.sum())


def phase_k2(gen):
    from scenedino_torch.core import rays as rays_mod
    from scenedino_torch.core.sampling import sample_coarse
    from scenedino_torch.kernels.point_render import PointRenderConfig, point_render, point_render_plain
    from scenedino_torch.utils.timing import time_ms

    dev = "cuda"
    cfg = PointRenderConfig()
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    z = sample_coarse(flat, K, generator=gen).contiguous()
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    D, E, C = grid.shape[-1], w2.shape[-1], w_code.shape[0]
    args = (flat, z, grid, w_code, b1, w2, b2, torch.eye(4, device=dev), intrinsics(dev),
            torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16), torch.eye(4, device=dev),
            intrinsics(dev))
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    errs = [(o - p).abs().max().item() for o, p in zip(out, ref)]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    print(f"phase 3 K2 errors: depth {errs[0]:.3e} m, feature {errs[1]:.3e}, rgb {errs[2]:.3e}", flush=True)
    if not (finite and errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail(f"K2 point_render disagrees with its plain version (finite={finite}, errors {errs}; "
             f"bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})")

    # the weight-median depth: a sample depth, the plain version's or its neighbour
    med = dataclasses.replace(cfg, depth_statistic="median")
    out_m = point_render(*args, med)
    torch.cuda.synchronize()
    ref_m = point_render_plain(*args, med)
    k_idx = (z - out_m[0][:, None]).abs().argmin(-1)
    p_idx = (z - ref_m[0][:, None]).abs().argmin(-1)
    on_sample = torch.equal(z.gather(1, k_idx[:, None])[:, 0], out_m[0])
    off = (k_idx - p_idx).abs().max().item()
    flips = (k_idx != p_idx).float().mean().item()
    med_err = (out_m[0] - ref_m[0]).abs().max().item()
    print(f"phase 3 K2 median depth: on a sample depth {on_sample}; rays whose sample differs from the plain "
          f"version's {flips:.3e} (bound {K2_MEDIAN_FLIPS}), by at most {off} sample(s) (bound 1); max abs err "
          f"{med_err:.3e} m", flush=True)
    if not (on_sample and off <= 1 and flips <= K2_MEDIAN_FLIPS):
        fail("K2's weight-median depth disagrees with its plain version")

    ms = time_ms(lambda: point_render(*args, cfg))
    ms_median = time_ms(lambda: point_render(*args, med))
    plain_ms = time_ms(lambda: point_render_plain(*args, cfg))
    R = flat.shape[0]
    rows = grid_rows_read(_ray_points(flat, z), grid, *args[7:9])
    b, by = bound_ms(2.0 * R * K * (C * D + D * E),
                     rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * (1 + (E - 1) + 3) * 4)
    print(f"phase 3 K2 point_render ({R} rays x {K}, grid {H * 2}x{W * 2}x{D} bf16): kernel {ms:.4f} ms "
          f"(median depth {ms_median:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct "
          f"grid rows read); {corner_traffic(R * K, D)}", flush=True)
    return {"name": "point_render", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:825", "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_probe(gen):
    """K3, the row gather and K2 at the shapes the probe path gives them:
    48x160 probe rays x 16 samples; their weights and depths side by side,
    a (7680, 32) fp32 table, read at (y // 4) * 160 + x // 4 for the
    122,880 pixels; K2 on each pixel's 10 + 2 resampled, sorted depths."""
    from scenedino_torch.core import rays as rays_mod
    from scenedino_torch.core import sampling
    from scenedino_torch.kernels.point_render import (
        PointRenderConfig,
        point_render,
        point_render_plain,
        probe_weights,
        probe_weights_plain,
    )
    from scenedino_torch.kernels.row_gather import row_gather, row_gather_plain
    from scenedino_torch.ops.fast_field import draw_probe
    from scenedino_torch.utils.timing import time_ms

    dev, s, Kp = "cuda", 4, 16
    cfg = PointRenderConfig()
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    rays = r[0, ::s, ::s].reshape(-1, 8).contiguous()
    draws = draw_probe(H, W, gen, dev)
    z = sampling.sample_coarse(rays, Kp, u=draws.u_probe).contiguous()
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    cams = (torch.eye(4, device=dev), intrinsics(dev))
    args = (rays, z, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), *cams)
    w_probe = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    err = (w_probe - probe_weights_plain(*args, cfg)).abs().max().item()
    finite = bool(torch.isfinite(w_probe).all())
    print(f"phase 3b K3 probe_weights error: weights {err:.3e} (bound {K3_TOL})", flush=True)
    if not (finite and err <= K3_TOL):
        fail(f"K3 probe_weights disagrees with its plain version (finite={finite}, error {err})")
    ms = time_ms(lambda: probe_weights(*args, cfg), inner=10)
    plain_ms = time_ms(lambda: probe_weights_plain(*args, cfg))
    R, D, C = rays.shape[0], grid.shape[-1], w_code.shape[0]
    rows = grid_rows_read(_ray_points(rays, z), grid, *cams)
    b, by = bound_ms(2.0 * R * Kp * (C * D + D), rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * Kp * 4)
    print(f"phase 3b K3 probe_weights ({R} rays x {Kp}, grid {H * 2}x{W * 2}x{D} bf16, density column): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct grid rows read); "
          f"{corner_traffic(R * Kp, D)}", flush=True)
    k3 = {"name": "probe_weights", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
          "replaces": "scenedino_tpu/ops/fast_field.py:792", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}

    # the nearest upsample, as render_novel_view_probe builds its table and index
    table = torch.cat([w_probe, z], -1).contiguous()
    idx = ((torch.arange(H, device=dev) // s)[:, None] * (W // s)
           + (torch.arange(W, device=dev) // s)[None]).reshape(-1).to(torch.int32)
    full = row_gather(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(full, row_gather_plain(table, idx)):
        fail("the row gather at the probe path's shape is not exact")
    g_ms = time_ms(lambda: row_gather(table, idx), reps=20, inner=20)
    g_plain = time_ms(lambda: row_gather_plain(table, idx), reps=20, inner=20)
    g_lib = time_ms(lambda: torch.index_select(table, 0, idx), reps=20, inner=20)
    n = idx.shape[0]
    gb, gby = bound_ms(0.0, n * table.shape[1] * 4 + nbytes(table, idx))
    print(f"phase 3b row_gather at the probe path's shape ({n} rows of a {table.shape[0]}x{table.shape[1]} fp32 "
          f"table, exact): kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, index_select {g_lib:.4f} ms, bound "
          f"{gb:.5f} ms ({gby})", flush=True)
    gather = {"name": "row_gather", "route": "cuda", "source": "scenedino_torch/csrc/row_gather.cu",
              "replaces": "tools/bench_pallas_gather.py:38", "max_abs_err": 0.0, "ms": g_ms,
              "plain_ms": g_plain, "bound_ms": gb, "bound_by": gby, "library_ms": g_lib}

    # K2 on the resampled depths: 10 from each pixel's histogram, 2 stratified
    zf = sampling.sample_coarse_from_dist(flat, full[:, :Kp], full[:, Kp:], 10, u=draws.u_fine, t=draws.t_fine)
    zf = torch.cat([zf, sampling.sample_coarse(flat, 2, u=draws.u_uniform)], -1)
    zf = torch.sort(zf, -1).values.contiguous()
    colour = torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16)
    args = (flat, zf, grid, w_code, b1, w2, b2, *cams, colour, *cams)
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    errs = [(o - p).abs().max().item() for o, p in zip(out, point_render_plain(*args, cfg))]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    Kf = zf.shape[1]
    print(f"phase 3b K2 on the probe's {Kf} resampled depths, errors: depth {errs[0]:.3e} m, feature "
          f"{errs[1]:.3e}, rgb {errs[2]:.3e}", flush=True)
    if not (finite and errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail(f"K2 point_render at {Kf} samples disagrees with its plain version (finite={finite}, errors {errs})")
    k2_ms = time_ms(lambda: point_render(*args, cfg))
    k2_plain = time_ms(lambda: point_render_plain(*args, cfg))
    E, Rf = w2.shape[-1], flat.shape[0]
    rows = grid_rows_read(_ray_points(flat, zf), grid, *cams)
    kb, kby = bound_ms(2.0 * Rf * Kf * (C * D + D * E),
                       rows * D * 2 + nbytes(*args[:2], *args[3:]) + Rf * (1 + (E - 1) + 3) * 4)
    print(f"phase 3b K2 point_render ({Rf} rays x {Kf}): kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, bound "
          f"{kb:.4f} ms ({kby}; {rows} distinct grid rows read); {corner_traffic(Rf * Kf, D)}", flush=True)
    return [k3, gather]


def ssc_points(device):
    """The 2,097,152 SSCBench voxel centres in bench.py's (z, x, y) order."""
    from scenedino_torch.eval.sscbench import generate_point_grid

    pts, _ = generate_point_grid()
    pts = pts.reshape(256, 256, 32, 3).transpose(2, 0, 1, 3).reshape(-1, 3)
    return torch.from_numpy(np.ascontiguousarray(pts)).to(device)


def phase_k4(gen):
    from scenedino_torch.kernels.point_render import PointRenderConfig, point_query, point_query_plain
    from scenedino_torch.utils.timing import time_ms

    dev = "cuda"
    cfg = PointRenderConfig()
    pts = ssc_points(dev)
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    args = (pts, grid, w_code, b1, w2, b2, torch.eye(4, device=dev), intrinsics(dev))
    sigma, feat = point_query(*args, cfg)
    torch.cuda.synchronize()
    # the plain version chunk by chunk, so memory stays bounded; errors on
    # the points in the depth range [z_near, z_far], and on every point
    # scaled by the size of its outputs: nearer than z_near the normalized
    # inverse depth reaches ~6e3 (a bf16 ulp of 32 in the code) and h
    # reaches ~1e3 (a bf16 ulp of 4), so an fp32 difference before either
    # rounding (the tensor cores' summation order against the plain fp32
    # product's) can round it the other way and move an output by ~1
    in_range = (pts[:, 2] >= cfg.z_near) & (pts[:, 2] <= cfg.z_far)
    err_abs, err_range, err_scaled, chunk = 0.0, 0.0, 0.0, 1 << 18
    for p0 in range(0, pts.shape[0], chunk):
        ref_s, ref_f = point_query_plain(pts[p0:p0 + chunk], *args[1:], cfg)
        d = torch.maximum((sigma[p0:p0 + chunk] - ref_s).abs(), (feat[p0:p0 + chunk] - ref_f).abs().amax(-1))
        scale = torch.clamp_min(torch.maximum(ref_s, ref_f.abs().amax(-1)), 1.0)
        err_abs = max(err_abs, d.max().item())
        err_range = max(err_range, d[in_range[p0:p0 + chunk]].max().item())
        err_scaled = max(err_scaled, (d / scale).max().item())
    finite = bool(torch.isfinite(sigma).all() and torch.isfinite(feat).all())
    print(f"phase 3c K4 point_query errors (sigma and feature): {int(in_range.sum())} points in [{cfg.z_near}, "
          f"{cfg.z_far}] m max abs {err_range:.3e} (bound {K4_TOL}); all points max abs {err_abs:.3e}, over each "
          f"point's largest output (at least 1) {err_scaled:.3e} (bound {K4_TOL})", flush=True)
    if not (finite and err_range <= K4_TOL and err_scaled <= K4_TOL):
        fail(f"K4 point_query disagrees with its plain version (finite={finite})")
    ms = time_ms(lambda: point_query(*args, cfg))
    plain_ms = time_ms(lambda: point_query_plain(*args, cfg), reps=5)
    P, D, E, C = pts.shape[0], grid.shape[-1], w2.shape[-1], w_code.shape[0]
    out_bytes = P * 4 + P * (E - 1) * 4
    rows = grid_rows_read(pts, grid, *args[6:8])
    in_bytes = rows * D * 2 + nbytes(args[0], *args[2:])
    b, by = bound_ms(2.0 * P * (C * D + D * E), in_bytes + out_bytes)
    print(f"phase 3c K4 point_query ({P} points, grid {H * 2}x{W * 2}x{D} bf16, d_out {E}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}: inputs {in_bytes / 1e6:.1f} MB read once, of them "
          f"{rows} distinct grid rows; sigma and feature {out_bytes / 1e6:.1f} MB written once); "
          f"{corner_traffic(P, D)}", flush=True)
    return {"name": "point_query", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:990", "max_abs_err": err_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_gather(seed):
    """The row gather at P1's and P2's shapes, through their tools."""
    from scenedino_torch.kernels import build
    from scenedino_torch.kernels.row_gather import ARGTYPES, row_gather, row_gather_plain
    from scenedino_torch.tools import bench_gather, probe_gather
    from scenedino_torch.utils.timing import time_ms

    if not probe_gather.run("cuda"):
        fail("the row gather at P1's shape is not exact")
    rows, C, n = probe_gather.ROWS, probe_gather.C, probe_gather.BLK
    t1 = torch.arange(rows * C, dtype=torch.float32, device="cuda").reshape(rows, C)
    i1 = torch.from_numpy(np.random.RandomState(0).randint(0, rows, n).astype(np.int32)).cuda()
    # the C function alone through ctypes, pointers and stream taken before: the launch's own floor
    fn = build.function("row_gather", "row_gather", ARGTYPES)
    o1, stream = torch.empty(n, C, device="cuda"), torch.cuda.current_stream().cuda_stream
    ptrs = (t1.data_ptr(), i1.data_ptr(), o1.data_ptr(), n, rows, C * 4, stream)
    p1 = {name: time_ms(f, reps=20, inner=20) for name, f in (
        ("kernel", lambda: row_gather(t1, i1)), ("c_call", lambda: fn(*ptrs)),
        ("empty", lambda: torch.empty((n, C), dtype=t1.dtype, device=t1.device)),
        ("plain", lambda: row_gather_plain(t1, i1)), ("index_select", lambda: torch.index_select(t1, 0, i1)))}
    if not torch.equal(o1, row_gather_plain(t1, i1)):
        fail("the row gather's C function at P1's shape is not exact")
    b1, by1 = bound_ms(0.0, n * C * 4 + nbytes(t1, i1))
    print(f"phase 3d row_gather at P1's shape ({n} rows of a {rows}x{C} fp32 table, exact): kernel "
          f"{p1['kernel']:.4f} ms per call (the wrapper: checks, torch.empty, ctypes, launch; 20 back to back), "
          f"its C function alone through ctypes {p1['c_call']:.4f} ms, the output's torch.empty alone "
          f"{p1['empty']:.4f} ms, plain {p1['plain']:.4f} ms, index_select "
          f"{p1['index_select']:.4f} ms, bound {b1:.5f} ms ({by1})", flush=True)
    m = bench_gather.measure(seed)
    if not m["equal"]:
        fail("the row gather at P2's shape differs from torch.index_select")
    table, idx = bench_gather.inputs(seed)
    plain_ms = time_ms(lambda: row_gather_plain(table, idx), reps=20, inner=5)
    P, C = idx.shape[0], table.shape[1]
    b, by = bound_ms(0.0, P * C * 2 + nbytes(table, idx))
    print(f"phase 3d row_gather at P2's shape ({P} rows of a {table.shape[0]}x{C} bf16 table, exact): kernel "
          f"{m['kernel_ms']:.4f} ms ({P / m['kernel_ms'] / 1e3:.1f} Mrows/s), plain {plain_ms:.4f} ms, "
          f"index_select {m['index_select_ms']:.4f} ms, bound {b:.4f} ms ({by})", flush=True)


def phase_k6(gen):
    """K6 against its plain version at the shapes its paths give it (the
    render's own preamble from a seeded state): the bf16 serving state of
    one flagship frame, the fp32 stage-2 state of 4 flagship frames in one
    launch (phase 7), the fp32 state of 4 frames of the stage-2 convergence
    recipe (phase 7b: d_hidden 64, d_out 17), and the bf16 serving state of
    one frame at 48 samples (the dead rows of a 64-row tile) at flagship
    width and at the stage-1 convergence recipe's (96x192, d_hidden 64,
    d_out 17)."""
    from scenedino_torch.tools.bench_encode_view import SHAPES, check, render_stage

    shapes = {}
    for shape in SHAPES:
        r = check(gen, shape)
        path = r["path"]
        print(f"phase 3e K6 encode_view ({path}: {r['frames']} x {r['height']}x{r['width']} rays x {r['samples']} "
              f"samples from a {2 * r['height']}x{2 * r['width']}x{r['d_hidden']} grid, {r['dtype']} state, d_out "
              f"{r['d_out']}): errors {json.dumps(r['errors'])} (bounds {json.dumps(r['tolerance'])}); finite "
              f"{r['finite']}; two launches bitwise equal {r['bitwise']}; median depth on a sample depth "
              f"{r['median_on_sample']}, rays whose sample differs from the plain version's {r['median_flips']:.3e} "
              f"(bound 1e-3), by at most {r['median_off']} (bound 1); kernel {r['ms']:.4f} ms (median depth "
              f"{r['median_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}{'; three TF32 passes' if r['fp32_cores_bound_ms'] else ''})"
              + (f", fp32 outside the tensor cores {r['fp32_cores_bound_ms']:.4f} ms" if r["fp32_cores_bound_ms"]
                 else ""), flush=True)
        if not r["ok"]:
            fail(f"K6 encode_view disagrees with its plain version ({path}): {r}")
        shapes[path] = {k: r[k] for k in ("frames", "dtype", "height", "width", "d_hidden", "d_out", "samples",
                                          "ms", "plain_ms", "bound_ms", "bound_by")}
        shapes[path]["max_abs_err"] = max(r["errors"].values())
    split = render_stage(gen, SHAPES[0])
    print(f"phase 3e K6 the serving render stage split (render_encode_view_batched, one 192x640 frame): torch "
          f"preamble {split['preamble_ms']:.4f} ms, K6 {split['kernel_ms']:.4f} ms, the whole render "
          f"{split['render_ms']:.4f} ms; the preamble's {split['preamble_profile']}", flush=True)
    main = shapes["stage 2"]
    return {"name": "encode_view", "route": "cuda", "source": "scenedino_torch/csrc/encode_view.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:254",
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": shapes}


def cameras_of(device):
    return intrinsics(device)[None, None], torch.eye(4, device=device)[None, None]


@torch.inference_mode()
def serve(model, img, u, device, size=None):
    """One novel-view request: encode -> fold -> render the novel camera (no
    graph), at the image's size or at `size` (h, w)."""
    from scenedino_torch.ops.fast_field import build_fast_state, render_novel_view_fused

    h, w = size or img.shape[-2:]
    Ks, poses = cameras_of(device)
    state = model.encode(img, Ks, poses, ids_encoder=(0,))
    fs = build_fast_state(model, state, compute_dtype=torch.bfloat16)
    return render_novel_view_fused(fs, model.cfg, novel_pose(device), intrinsics(device), h, w,
                                   u=u, n_coarse=K)


@torch.inference_mode()
def serve_probe(model, img, draws, device):
    """One probe request: encode_prefolded -> render_novel_view_probe at its defaults."""
    from scenedino_torch.ops.fast_field import encode_prefolded, render_novel_view_probe

    h, w = img.shape[-2:]
    fs = encode_prefolded(model, img, *cameras_of(device))
    return render_novel_view_probe(fs, model.cfg, novel_pose(device), intrinsics(device), h, w, draws=draws)


@torch.inference_mode()
def serve_query(model, img, pts, device):
    """One SSC voxel query: encode_prefolded -> fast_query_fused."""
    from scenedino_torch.ops.fast_field import encode_prefolded, fast_query_fused

    return fast_query_fused(encode_prefolded(model, img, *cameras_of(device)), model.cfg, pts)


@torch.inference_mode()
def serve_encode_view(model, img, u, device):
    """One encode-view render: encode_prefolded -> render_encode_view."""
    from scenedino_torch.ops.fast_field import encode_prefolded, render_encode_view

    h, w = img.shape[-2:]
    return render_encode_view(encode_prefolded(model, img, *cameras_of(device)), model.cfg, h, w, u=u,
                              n_coarse=K)


def check_depth(name, depth, dino, rgb):
    """Shapes, finiteness and the [3, 80] m depth range of one full-frame answer."""
    if depth.shape != (H, W) or dino.shape != (H, W, 64) or rgb.shape != (H, W, 3):
        fail(f"{name} output shapes {depth.shape}, {dino.shape}, {rgb.shape}")
    if not all(bool(torch.isfinite(t).all()) for t in (depth, dino, rgb)):
        fail(f"{name} output is not finite")
    # depth is a convex combination of sample depths in [3, 80]; 1e-3 m of fp32 slack
    if not (depth.min().item() >= 3.0 - 1e-3 and depth.max().item() <= 80.0 + 1e-3):
        fail(f"{name} depth outside [3, 80]: [{depth.min().item()}, {depth.max().item()}]")


def run_path(name, requests, answer, check, expect):
    """Drive one serving path: the launch counters zeroed just before, read
    just after; each request's launches must meet `expect` (name -> the
    least count, or the exact count where `exact`). Returns the counts and
    the host ms of each request (synchronized)."""
    from scenedino_torch import kernels

    kernels.reset_launches()
    times = []
    for req in requests:
        before = kernels.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = answer(*req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(*out)
        per = {k: n - before[k] for k, n in kernels.launches().items()}
        bad = {k: per[k] for k, (least, exact) in expect.items() if (per[k] != least if exact else per[k] < least)}
        if bad or any(per[k] for k in per if k not in expect):
            fail(f"the {name} path did not run through its kernels: launches {per}, expected {expect}")
    return kernels.launches(), times


def stages_of(steps):
    """Synchronized host ms of each named step of one request, run in order."""
    ms, carry = {}, None
    with torch.inference_mode():
        for name, step in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return ms


def phase_slice(seed):
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.utils.timing import profile_device, time_ms
    from scenedino_torch.ops.fast_field import (
        build_fast_state,
        draw_probe,
        encode_prefolded,
        fast_query_fused,
        render_encode_view,
        render_novel_view_fused,
        render_novel_view_probe,
    )

    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    blocks = model.encoder.vit_encoder.vit.cfg.depth
    imgs, gens = [], []
    for i in range(3):
        g = torch.Generator(device="cuda").manual_seed(seed + 100 + i)
        imgs.append(torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1)
        gens.append(g)
    Ks, poses = cameras_of("cuda")
    pts = ssc_points("cuda")
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        return json.dumps(counts)

    # the exact novel-view path
    reqs = [(img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("novel-view", reqs, lambda *r: serve(model, *r), lambda *o: check_depth("novel-view", *o),
                             {"attention": (blocks, True), "point_render": (1, True)})
    img, u, _ = reqs[0]
    stages = stages_of([
        ("encode_ms", lambda _: model.encode(img, Ks, poses)),
        ("fold_ms", lambda st: build_fast_state(model, st)),
        ("render_ms", lambda fs: render_novel_view_fused(fs, model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W,
                                                         u=u, n_coarse=K)),
    ])
    print(f"phase 4 slice: 3 novel-view requests at {H}x{W}, ms per request {[round(t, 3) for t in times]}; "
          f"stages of one request {json.dumps(stages)}; launches {add(counts)}", flush=True)
    print(f"phase 4 profile (novel view): {profile_device(lambda: serve(model, *reqs[1]))}", flush=True)

    # the probe-guided path at its defaults (16-sample probe at stride 4, 10 + 2 samples)
    reqs = [(img, draw_probe(H, W, g, "cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("probe", reqs, lambda *r: serve_probe(model, *r), lambda *o: check_depth("probe", *o),
                             {"attention": (blocks, True), "probe_weights": (1, True), "row_gather": (1, False),
                              "point_render": (1, True)})
    img, draws, _ = reqs[0]
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, img, Ks, poses)),
        ("render_ms", lambda fs: render_novel_view_probe(fs, model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W,
                                                         draws=draws)),
    ])
    with torch.inference_mode():  # the fold inside the DPT's last conv against the fold after it
        prefolded_ms = time_ms(lambda: encode_prefolded(model, img, Ks, poses), reps=5)
        two_step_ms = time_ms(lambda: build_fast_state(model, model.encode(img, Ks, poses)), reps=5)
    print(f"phase 4 probe: 3 requests at {H}x{W}, ms per request {[round(t, 3) for t in times]}; stages of one "
          f"request {json.dumps(stages)}; launches {add(counts)}; encode_prefolded {prefolded_ms:.3f} ms against "
          f"encode + build_fast_state {two_step_ms:.3f} ms (CUDA events, median of 5)", flush=True)
    print(f"phase 4 profile (probe): {profile_device(lambda: serve_probe(model, *reqs[1]))}", flush=True)

    # the SSC voxel query over the full grid
    def check_query(sigma, feat):
        if sigma.shape != (pts.shape[0],) or feat.shape != (pts.shape[0], 64):
            fail(f"SSC query output shapes {sigma.shape}, {feat.shape}")
        if not (torch.isfinite(sigma).all() and torch.isfinite(feat).all() and sigma.min() >= 0):
            fail("SSC query output is not finite, or sigma < 0")

    reqs = [(img, pts, "cuda") for img in imgs]
    counts, times = run_path("SSC query", reqs, lambda *r: serve_query(model, *r), check_query,
                             {"attention": (blocks, True), "point_query": (1, True)})
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, imgs[0], Ks, poses)),
        ("query_ms", lambda fs: fast_query_fused(fs, model.cfg, pts)),
    ])
    print(f"phase 4 SSC query: 3 queries of {pts.shape[0]} voxel centres, ms per query "
          f"{[round(t, 3) for t in times]}; stages of one query {json.dumps(stages)}; launches {add(counts)}",
          flush=True)
    print(f"phase 4 profile (SSC query): {profile_device(lambda: serve_query(model, *reqs[1]))}", flush=True)

    # the encode-view render (no feature lookup; K6 per sample)
    reqs = [(img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("encode-view", reqs, lambda *r: serve_encode_view(model, *r),
                             lambda *o: check_depth("encode-view", *o),
                             {"attention": (blocks, True), "encode_view": (1, True)})
    img, u, _ = reqs[0]
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, img, Ks, poses)),
        ("render_ms", lambda fs: render_encode_view(fs, model.cfg, H, W, u=u, n_coarse=K)),
    ])
    print(f"phase 4 encode view: 3 renders at {H}x{W}, ms per render {[round(t, 3) for t in times]}; stages of one "
          f"render {json.dumps(stages)}; launches {add(counts)}", flush=True)
    print(f"phase 4 profile (encode view): {profile_device(lambda: serve_encode_view(model, *reqs[1]))}", flush=True)

    # small inputs: the same model on the GPU (kernels) and on the CPU (plain versions)
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(seed + 7)
    h, w = 32, 96
    img = torch.rand(1, 1, 3, h, w, generator=g) * 2 - 1
    u = torch.rand(h * w, K, generator=g)
    gpu = [t.float().cpu() for t in serve(model, img.cuda(), u.cuda(), "cuda")]
    cpu = [t.float() for t in serve(cpu_model, img, u, "cpu")]
    rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).max().item()
    cos = torch.nn.functional.cosine_similarity(gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64), dim=-1).median().item()
    print(f"phase 4 small-input check ({h}x{w}, GPU kernels vs CPU plain, bf16): depth max rel err "
          f"{rel:.3e} (bound {SLICE_DEPTH_REL}), feature median cosine {cos:.6f} (bound {SLICE_COS})",
          flush=True)
    if not (rel <= SLICE_DEPTH_REL and cos >= SLICE_COS):
        fail("the GPU slice disagrees with the CPU reference on the small input")

    draws = draw_probe(h, w, g)
    gpu = [t.float().cpu() for t in serve_probe(model, img.cuda(), type(draws)(*(t.cuda() for t in draws)), "cuda")]
    cpu = [t.float() for t in serve_probe(cpu_model, img, draws, "cpu")]
    rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).flatten()
    p99 = torch.quantile(rel, 0.99).item()
    cos = torch.nn.functional.cosine_similarity(gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64), dim=-1).median().item()
    print(f"phase 4 small-input probe check ({h}x{w}): depth rel err median {rel.median().item():.3e}, p99 "
          f"{p99:.3e} (bound {PROBE_DEPTH_REL_P99}), max {rel.max().item():.3e}; feature median cosine {cos:.6f} "
          f"(bound {SLICE_COS})", flush=True)
    if not (p99 <= PROBE_DEPTH_REL_P99 and cos >= SLICE_COS):
        fail("the GPU probe path disagrees with the CPU reference on the small input")

    small_pts = pts[::64].contiguous()
    gpu = [t.float().cpu() for t in serve_query(model, img.cuda(), small_pts, "cuda")]
    cpu = [t.float() for t in serve_query(cpu_model, img, small_pts.cpu(), "cpu")]
    sig_rel = ((gpu[0] - cpu[0]).abs().max() / cpu[0].abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(gpu[1], cpu[1], dim=-1).median().item()
    print(f"phase 4 small-input query check ({h}x{w} encode, {small_pts.shape[0]} voxel centres): sigma max abs err "
          f"over max sigma {sig_rel:.3e} (bound {QUERY_SIGMA_REL}), feature median cosine {cos:.6f} "
          f"(bound {SLICE_COS})", flush=True)
    if not (sig_rel <= QUERY_SIGMA_REL and cos >= SLICE_COS):
        fail("the GPU query disagrees with the CPU reference on the small input")
    return total


def train_batch(gen, B, h, w, device):
    """Seeded images in [-1, 1] for V = 4 views: a stereo pair (0.6 m
    baseline) and the same pair 1 m further along the road; every view
    looks down +z with the intrinsics of `intrinsics`."""
    imgs = torch.rand(B, 4, 3, h, w, generator=gen, device=device) * 2 - 1
    poses = torch.eye(4, device=device).repeat(B, 4, 1, 1)
    poses[:, :, 0, 3] = torch.tensor([0.0, 0.6, 0.0, 0.6], device=device)
    poses[:, :, 2, 3] = torch.tensor([0.0, 0.0, 1.0, 1.0], device=device)
    return {"imgs": imgs, "poses": poses, "projs": intrinsics(device).expand(B, 4, 3, 3).contiguous()}


class StageTimer:
    """The `mark` callback of a train step: synchronized ms since the last mark."""

    def __init__(self):
        self.ms = {}
        self.last = 0.0

    def start(self):
        torch.cuda.synchronize()
        self.last = time.perf_counter()

    def __call__(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = (now - self.last) * 1e3
        self.last = now


def phase_train(seed):
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.timing import profile_device

    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(SCENEDINO_KITTI_360_TRAIN)
    Bt, V = SCENEDINO_KITTI_360_TRAIN["batch_size"], 4
    torch.cuda.reset_peak_memory_stats()
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    gp, blocks, t_blocks = enc.gt_patch_size, enc.vit_encoder.vit.cfg.depth, enc.gt_encoder.vit.cfg.depth
    g = torch.Generator(device="cuda").manual_seed(seed + 200)
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.gt_encoder.latent_size, H // gp, W // gp),
                                     generator=g)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(g, Bt, H, W, "cuda")
    trainable = [p for group in state.optimizer.param_groups for p in group["params"]]
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": blocks + t_blocks, "attention_bwd_dq": blocks, "attention_bwd_dkv": blocks}

    kernels.reset_launches()
    times, timer = [], StageTimer()
    for i in range(TRAIN_STEPS):
        draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, H, W, gp)
        before = [p.detach().clone() for p in trainable] + [state.artifact_field.detach().clone()]
        counts = kernels.launches()
        last = i == TRAIN_STEPS - 1
        timer.start()
        t0 = timer.last
        losses = step(state, batch, draws, mark=timer if last else None)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: n - counts[k] for k, n in kernels.launches().items()}
        loss = losses["rec_loss"].item()
        unchanged = sum(torch.equal(a, p) for a, p in zip(before, trainable + [state.artifact_field]))
        if not np.isfinite(loss):
            fail(f"training step {i + 1}: loss {loss}")
        if losses["nonfinite_consecutive"] != 0 or state.applied != i + 1:
            fail(f"training step {i + 1} was skipped as non-finite: {losses}")
        if unchanged > 0:
            fail(f"training step {i + 1} left {unchanged} of {len(before)} parameter tensors unchanged")
        if per_step != expect:
            fail(f"training step {i + 1} launched {per_step}, expected {expect}")
        print(f"phase 5 train step {i + 1}: loss {loss:.6f} "
              f"({json.dumps({k: round(float(v), 6) for k, v in losses.items() if k.startswith(('loss', 'edge', 'dino'))})}); "
              f"{times[-1]:.3f} ms; launches {json.dumps(per_step)}", flush=True)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 5 train: {TRAIN_STEPS} steps at batch {Bt}, {V} views, {H}x{W}, {tcfg.ray_batch_size} rays x "
          f"{rcfg.n_coarse} samples; first step {times[0]:.3f} ms (cuDNN's algorithm search and the kernels' "
          f"load), then {[round(t, 3) for t in times[1:]]} ms (the last synchronized at each stage); stages of the "
          f"last step {json.dumps({k: round(v, 3) for k, v in timer.ms.items()})}; peak memory allocated "
          f"{peak:.3f} GiB; launches {json.dumps(launches)}", flush=True)
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, H, W, gp)
    print(f"phase 5 profile: {profile_device(lambda: step(state, batch, draws))}", flush=True)

    # small input: one step of the same model on the GPU (kernels) and on the
    # CPU (plain versions), same images, draws and artifact field
    h, w, Bs = 32, 96, 2
    gc = torch.Generator().manual_seed(seed + 300)
    small = train_batch(gc, Bs, h, w, "cpu")
    draws = trainer.draw_stage1(gc, tcfg, rcfg, Bs, V, h, w, gp)
    art = 1e-3 * torch.randn(enc.gt_encoder.latent_size, h // gp, w // gp, generator=gc)
    model.zero_grad(set_to_none=True)
    del state, step, before

    def one_step(m, device):
        m.zero_grad(set_to_none=True)
        a = art.to(device).requires_grad_(True)
        d = dataclasses.replace(draws, **{f: getattr(draws, f).to(device) for f in ("pv", "py", "px", "u")})
        loss, _ = trainer.stage1_forward(m, {k: v.to(device) for k, v in small.items()}, d, tcfg, rcfg, lcfg, a)
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters() if p.grad is not None}
        grads["artifact_field"] = a.grad.float().cpu()
        return loss.item(), grads

    gpu_loss, gpu_grads = one_step(model, "cuda")
    cpu_loss, cpu_grads = one_step(copy.deepcopy(model).to("cpu"), "cpu")
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if sorted(gpu_grads) != sorted(cpu_grads):
        fail("the GPU and CPU steps gave gradients to different parameters")
    errs = {n: (torch.linalg.vector_norm(gpu_grads[n] - r) / torch.linalg.vector_norm(r)).item()
            for n, r in cpu_grads.items() if torch.linalg.vector_norm(r) > 0}
    worst = max(errs, key=errs.get)
    print(f"phase 5 small-step check ({h}x{w}, batch {Bs}, GPU kernels vs CPU plain, bf16): loss {gpu_loss:.6f} vs "
          f"{cpu_loss:.6f}, rel err {loss_rel:.3e} (bound {TRAIN_LOSS_REL}); gradients of {len(errs)} tensors, "
          f"relative L2 error median {float(np.median(list(errs.values()))):.3e}, worst {errs[worst]:.3e} "
          f"({worst}; bound {TRAIN_GRAD_REL})", flush=True)
    if not (loss_rel <= TRAIN_LOSS_REL and errs[worst] <= TRAIN_GRAD_REL):
        fail("the GPU training step disagrees with the CPU reference on the small input")
    return launches


def phase_train_fp32(seed):
    """One stage-1 step of the synthetic smoke recipe (configs/
    train_synthetic_smoke.yaml, `SYNTHETIC_SMOKE_TRAIN`): fp32, a ViT-S/8 cut
    to width 64, depth 3, 2 heads (head dim 32, 73 tokens at 48x96), so the
    ViT takes its plain attention branch and no kernel runs; the step must
    be finite, applied and move every parameter tensor."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SYNTHETIC_SMOKE_TRAIN as conf, make_model
    from scenedino_torch.training import trainer

    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    (h, w), V, Bt = conf["dataset"]["image_size"], conf["dataset"]["n_views"], conf["batch_size"]
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    vit = enc.vit_encoder.vit
    gp = enc.gt_patch_size
    g = torch.Generator(device="cuda").manual_seed(seed + 400)
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.gt_encoder.latent_size, h // gp, w // gp),
                                     generator=g)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(g, Bt, h, w, "cuda")
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, h, w, gp)
    trainable = [p for group in state.optimizer.param_groups for p in group["params"]]
    before = [p.detach().clone() for p in trainable]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step(state, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    loss = losses["rec_loss"].item()
    unchanged = sum(torch.equal(a, p) for a, p in zip(before, trainable))
    tokens = 1 + (h // vit.cfg.patch_size) * (w // vit.cfg.patch_size)
    print(f"phase 5b fp32 train step (configs/train_synthetic_smoke.yaml: batch {Bt}, {V} views, {h}x{w}, ViT width "
          f"{vit.cfg.width}, depth {vit.cfg.depth}, {vit.cfg.num_heads} heads, head dim "
          f"{vit.cfg.width // vit.cfg.num_heads}, {tokens} tokens, compute dtype {vit.cfg.dtype or 'fp32'}; its "
          f"training blocks as the config gives them): loss {loss:.6f}, {ms:.3f} ms (first step), applied "
          f"{state.applied}, {len(trainable) - unchanged} of {len(trainable)} parameter tensors moved; launches "
          f"{json.dumps(counts)}", flush=True)
    if not np.isfinite(loss) or losses["nonfinite_consecutive"] != 0 or state.applied != 1:
        fail(f"the fp32 smoke training step was not finite and applied: {losses}")
    if unchanged:
        fail(f"the fp32 smoke training step left {unchanged} of {len(trainable)} parameter tensors unchanged")
    if any(counts.values()):
        fail(f"the fp32 smoke training step launched kernels {counts}: its attention must take the plain branch")
    return counts


class LogRecords(logging.Handler):
    """Keeps the training loop's log records that carry numbers
    (`training.loop` attaches them as record attributes)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def with_attr(self, name):
        return [r for r in self.records if hasattr(r, name)]


def _state_equal(a, b) -> bool:
    """Two train-state dicts (tensors, numbers, strings, nested) equal, tensors bitwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_state_equal, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.cpu(), b.cpu())
    return a == b


def _finite(values) -> bool:
    return all(np.isfinite(float(v)) for v in values)


def phase_train_run(seed, scratch):
    """Phase 6: the port's stage-1 training run (`cli.train.run_stage1`) on
    configs/train_synthetic_flagship.yaml at full width, with the cuts
    printed on its first line; the resume from its checkpoint; three steps
    of configs/train_synthetic_convergence.yaml (the fine pass); the
    validation render at 32x64 on the GPU against the CPU. Returns the
    flagship run's launch counts and its run directory (phase 7's field)."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.training import trainer
    from scenedino_torch.utils import config as yaml_config
    from scenedino_torch.utils.checkpoint import load_checkpoint, train_state_dict

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    tmp = tempfile.mkdtemp(prefix="train_", dir=scratch)
    conf["dataset"]["length"] = TRAIN_RUN_ITEMS
    conf["training"].update(stop_iteration=TRAIN_RUN_STEPS, checkpoint_every=3, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = 3
    vconf["subset"]["args"] = {"start": 0, "end": 3}
    conf["output"]["path"] = os.path.join(tmp, "flagship")
    conf["num_workers"] = 4
    enc_conf = conf["model"]["encoder"]
    print(f"phase 6 train run: configs/train_synthetic_flagship.yaml read by scenedino_torch.utils.config, every width "
          f"as the file gives it ({enc_conf['encoder_arch']} {enc_conf['version']} student and teacher, "
          f"{enc_conf['image_size']}, batch {conf['batch_size']}, "
          f"{conf['dataset']['n_views']} views, {conf['training']['ray_sampler']['args']['ray_batch_size']} rays x "
          f"{conf['renderer']['n_coarse']} samples, with_amp {conf['with_amp']}, grad_checkpointing "
          f"{enc_conf['grad_checkpointing']}); cuts: dataset.length 64 -> {TRAIN_RUN_ITEMS}, stop_iteration "
          f"{TRAIN_RUN_STEPS}, checkpoint_every 1000 -> 3, log_every 50 -> 1, validation every 500 -> 3 over "
          f"subset 0-2 (file: 0-7), output into {tmp}", flush=True)

    log = logging.getLogger("training")
    log.setLevel(logging.INFO)
    records = LogRecords()
    log.addHandler(records)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        field, state = cli.run_stage1(conf, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        writes = records.with_attr("checkpoint")
        for r in steps:
            print(f"phase 6 train step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host {r.step_ms:.1f} ms "
                  f"(data wait {r.data_ms:.1f} ms)", flush=True)
        for r in vals:
            print(f"phase 6 validation at {r.iteration} ({r.ms:.1f} ms): "
                  f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
        depth = field.encoder.vit_encoder.vit.cfg.depth
        n_val_batches = len(vals) * 3
        expect = {**{name: 0 for name in kernels.WRAPPERS},
                  # a step: the student's 12 blocks, again under the recompute of
                  # the backward, and the teacher's 12; a validation batch: the
                  # student (view 0) and the teacher (4 views in one call)
                  "attention": TRAIN_RUN_STEPS * 3 * depth + n_val_batches * 2 * depth,
                  "attention_bwd_dq": TRAIN_RUN_STEPS * depth, "attention_bwd_dkv": TRAIN_RUN_STEPS * depth}
        print(f"phase 6 flagship run: {len(steps)} steps in {run_s:.1f} s wall (model build, data, steps, "
              f"validations, checkpoints); checkpoint writes "
              f"{json.dumps({os.path.basename(r.checkpoint): round(r.ms, 1) for r in writes})} ms, "
              f"{os.path.getsize(os.path.join(conf['output']['path'], f'training_checkpoint_{TRAIN_RUN_STEPS}.pt'))} "
              f"bytes each; peak memory "
              f"allocated {peak:.3f} GiB (remat on; phase 5 gives the step without it); launches "
              f"{json.dumps(counts)} (expected {json.dumps(expect)})", flush=True)
        if len(steps) != TRAIN_RUN_STEPS or state.step != TRAIN_RUN_STEPS or state.applied != TRAIN_RUN_STEPS:
            fail(f"the flagship run took {len(steps)} logged steps, state step {state.step}, applied {state.applied}")
        if not _finite(v for r in steps for v in r.losses.values()) or len(vals) != 2 or not all(
                _finite(r.metrics.values()) and "dino_cos_sim" in r.metrics and "nvs_psnr" in r.metrics
                and "depth_abs_rel" in r.metrics for r in vals):
            fail("the flagship run gave a non-finite loss or metric, or a validation is missing")
        if counts != expect:
            fail(f"the flagship run launched {counts}, expected {expect}")

        out = conf["output"]["path"]
        ckpt6 = os.path.join(out, f"training_checkpoint_{TRAIN_RUN_STEPS}.pt")
        snap = train_state_dict(field, state)
        if not os.path.exists(ckpt6) or not _state_equal(snap, torch.load(ckpt6, map_location="cuda",
                                                                              weights_only=True)):
            fail(f"{ckpt6} is missing or differs from the run's final state")

        # the validation render of one item, timed (the second call)
        vbatch = next(cli.make_val_batches_fn(make_datasets(conf["dataset"])[0], [0], 1, cli.VAL_KEYS, "cuda")())
        _, tcfg, rcfg, _ = trainer.configs_from_dict(conf)
        g = torch.Generator(device="cuda").manual_seed(seed + 600)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.stage1_eval_forward(field, vbatch, tcfg, rcfg, generator=g)
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) * 1e3

        # the checkpoint loads into a fresh model and train state, equal to what was saved
        field3, state3, *_ = cli.init_stage1(conf, "cuda")
        load_checkpoint(ckpt6, field3, state3)
        loaded_equal = _state_equal(train_state_dict(field3, state3), snap)
        print(f"phase 6 validation render of one item (1 x {conf['dataset']['n_views']} views at "
              f"{enc_conf['image_size']}, {rcfg.n_coarse} samples, chunks of 16384 rays): {eval_ms:.1f} ms; "
              f"{os.path.basename(ckpt6)} equals the final state and loads into a fresh model equal to it: "
              f"{loaded_equal}, step {state3.step}", flush=True)
        if not loaded_equal or state3.step != TRAIN_RUN_STEPS:
            fail("the checkpoint did not load back to the saved state")
        del field3, state3, field, state, snap

        # resume: continue from the newest checkpoint to RESUME_TO
        records.records.clear()
        conf2 = copy.deepcopy(conf)
        conf2["training"].update(stop_iteration=TRAIN_RUN_RESUME_TO)
        conf2["training"]["continue"] = True
        field, state = cli.run_stage1(conf2, device="cuda")
        resumed = records.with_attr("resumed_from")
        its = [r.iteration for r in records.with_attr("losses")]
        files = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
        periodic = [f for f in files if f.startswith("training_checkpoint_")]
        best = [f for f in files if f.startswith("dino_cos_sim_best_")]
        print(f"phase 6 resume: from {[os.path.basename(r.resumed_from) for r in resumed]} at iteration "
              f"{[r.iteration for r in resumed]}, then iterations {its}, final step {state.step}; checkpoints "
              f"left {files}", flush=True)
        if (len(resumed) != 1 or not resumed[0].resumed_from.endswith(os.path.basename(ckpt6))
                or resumed[0].iteration != TRAIN_RUN_STEPS
                or its != list(range(TRAIN_RUN_STEPS + 1, TRAIN_RUN_RESUME_TO + 1))
                or state.step != TRAIN_RUN_RESUME_TO or periodic != [f"training_checkpoint_{TRAIN_RUN_RESUME_TO}.pt"]
                or len(best) != 1 or not _finite(v for r in records.with_attr("losses") for v in r.losses.values())):
            fail("the resumed run did not continue from the checkpoint as expected")

        # the small-input check of the validation render: the flagship field's weights
        # on the GPU and on the CPU, the same draws
        h, w, V = 32, 64, conf["dataset"]["n_views"]
        gc = torch.Generator().manual_seed(seed + 700)
        small = train_batch(gc, 1, h, w, "cpu")
        u = torch.rand(V * h * w, rcfg.n_coarse, generator=gc)
        gpu = trainer.stage1_eval_forward(field, {k: v.cuda() for k, v in small.items()}, tcfg, rcfg, u=u.cuda())
        cpu_field = copy.deepcopy(field).to("cpu")
        del field, state
        cpu = trainer.stage1_eval_forward(cpu_field, small, tcfg, rcfg, u=u)
        d_rel = ((gpu["depth"].float().cpu() - cpu["depth"]).abs() / cpu["depth"]).flatten()
        rgb_err = (gpu["rgb"].float().cpu() - cpu["rgb"].float()).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(gpu["dino_pred_grid"].float().cpu().flatten(0, -2),
                                                    cpu["dino_pred_grid"].float().flatten(0, -2), dim=-1)
        p99 = torch.quantile(d_rel, 0.99).item()
        print(f"phase 6 small-input check of the validation render ({h}x{w}, {V} views, bf16; the ViT takes its "
              f"plain branch at {1 + (h // 8) * (w // 8)} tokens on both devices): depth rel err p99 {p99:.3e} "
              f"(bound {EVAL_DEPTH_REL_P99}), max {d_rel.max().item():.3e}; rgb max abs err {rgb_err:.3e} (bound "
              f"{EVAL_RGB_ABS}); pooled feature median cosine {cos.median().item():.6f} (bound {SLICE_COS})",
              flush=True)
        if not (p99 <= EVAL_DEPTH_REL_P99 and rgb_err <= EVAL_RGB_ABS and cos.median().item() >= SLICE_COS):
            fail("the GPU validation render disagrees with the CPU reference on the small input")
        del cpu_field

        # the fine pass on the card: 3 steps of the convergence recipe with one validation
        records.records.clear()
        conv = yaml_config.load(os.path.join(root, "configs", "train_synthetic_convergence.yaml"))
        conv["dataset"]["length"] = TRAIN_RUN_ITEMS
        conv["training"].update(stop_iteration=3, checkpoint_every=3, log_every=1)
        conv["validation"]["validation"]["events"][0]["args"]["every"] = 3
        conv["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
        conv["output"]["path"] = os.path.join(tmp, "convergence")
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, state = cli.run_stage1(conv, device="cuda")
        conv_s = time.perf_counter() - t0
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        print(f"phase 6 fine pass (configs/train_synthetic_convergence.yaml, fp32, {conv['renderer']['n_coarse']} + "
              f"{conv['renderer']['n_fine']} samples, {conv['dataset']['image_size']}; cuts: dataset.length 64 -> "
              f"{TRAIN_RUN_ITEMS}, stop_iteration 3, checkpoint_every 3, log_every 1, validation at 3 over subset "
              f"0-1): losses {[round(r.losses['rec_loss'], 6) for r in steps]}, host ms "
              f"{[round(r.step_ms, 1) for r in steps]}; validation "
              f"{json.dumps({k: round(float(v), 6) for r in vals for k, v in r.metrics.items()})}; {conv_s:.1f} s "
              f"wall; launches {json.dumps(kernels.launches())}", flush=True)
        if (len(steps) != 3 or state.applied != 3 or len(vals) != 1
                or not _finite(v for r in steps for v in r.losses.values()) or not _finite(vals[0].metrics.values())):
            fail("the convergence recipe's run was not 3 finite steps with one finite validation")
    finally:
        log.removeHandler(records)
    print(f"phase 6 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, out


def _semantic_config(root, stage1_dir, out):
    """Phase 7's stage-2 config, composed here: train_synthetic_flagship.yaml's
    model, precision, batch and data; train_semantic_kitti_360.yaml's
    downstream, training.loss, optimizer and validation blocks; cuts of scale
    only (no width)."""
    from scenedino_torch.utils import config as yaml_config

    flag = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    sem = yaml_config.load(os.path.join(root, "configs", "train_semantic_kitti_360.yaml"))
    conf = {k: copy.deepcopy(flag[k]) for k in ("seed", "with_amp", "batch_size", "dataset", "model", "renderer")}
    conf["dataset"]["length"] = STAGE2_ITEMS
    conf["downstream"] = copy.deepcopy(sem["downstream"])
    conf["training"] = {**copy.deepcopy(sem["training"]), "num_epochs": 10, "stop_iteration": STAGE2_STEPS,
                        "checkpoint_every": 3, "log_every": 1}
    conf["validation"] = copy.deepcopy(sem["validation"])
    vconf = conf["validation"]["validation"]
    vconf["subset"] = {"type": "range", "args": {"start": 0, "end": STAGE2_VAL_ITEMS}}
    vconf["events"][0]["args"]["every"] = 3
    conf["resume_from"] = stage1_dir
    conf["output"] = {"path": out}
    conf["num_workers"] = 4
    return conf


def phase_stage2(seed, stage1_dir, scratch):
    """Phase 7: the port's stage-2 run (`cli.train.run_stage2`) at full width
    from phase 6's stage-1 run directory, its checks, the resume, and
    downstream_forward at 32x64 on the GPU against the CPU. Returns the
    run's launch counts."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.losses.stego import stego_loss
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.renderer.nerf import RenderConfig
    from scenedino_torch.training import downstream as down
    from scenedino_torch.utils.checkpoint import load_checkpoint, train_state_dict
    from scenedino_torch.utils.timing import profile_device

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="stage2_", dir=scratch)
    conf = _semantic_config(root, stage1_dir, os.path.join(tmp, "semantic"))
    d, m, enc = conf["downstream"], conf["model"], conf["model"]["encoder"]
    print(f"phase 7 stage 2: cli.train.run_stage2 at full width, composed from train_synthetic_flagship.yaml "
          f"({enc['encoder_arch']} {enc['version']}, DPT {enc['decoder_out_dim']}, d_hidden "
          f"{m['decoder_heads'][0]['args']['d_hidden']}, with_amp {conf['with_amp']}, {enc['image_size']}, batch "
          f"{conf['batch_size']}) and train_semantic_kitti_360.yaml (downstream input_dim {d['input_dim']}, code_dim "
          f"{d['code_dim']}, {d['n_classes']} clusters over {d['gt_classes']} classes, buffer {d['buffer_size']}, "
          f"{d['patch_sample_size']} samples a crop, kNN {d['knn_neighbors']}, mode {d['mode']}, lr "
          f"{conf['training']['optimizer']['args']['lr']}; its loss and validation blocks), resume_from phase 6's "
          f"run; cuts: dataset.length 64 -> {STAGE2_ITEMS}, num_epochs 1 -> 10 (8 items are 2 steps an epoch), "
          f"stop_iteration {STAGE2_STEPS}, validation every 100 -> 3 over items 0-{STAGE2_VAL_ITEMS - 1} (file: a "
          f"random 32), checkpoint_every 5000 -> 3, log_every 250 -> 1; output into {tmp}", flush=True)

    def fresh_head():
        """The head as run_stage2 builds it before seeding: from `seed` on a CPU generator."""
        return SemanticHead(SemanticHeadConfig.from_dict(d), generator=torch.Generator().manual_seed(conf["seed"])).to(
            "cuda")

    records = LogRecords()
    loggers = [logging.getLogger(n) for n in ("training", "validation")]
    for lg in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(records)
    try:
        init = fresh_head().state_dict()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        field, head, state = cli.run_stage2(conf, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        written = records.with_attr("pseudo_assignment")
        seeded = records.with_attr("seed_ms")
        print(f"phase 7 cluster seeding (k-means++ over {d['n_classes']} clusters from the first batch's render): "
              f"{seeded[0].seed_ms:.1f} ms", flush=True)
        for r in steps:
            print(f"phase 7 step {r.iteration}: {json.dumps({k: round(float(v), 6) for k, v in r.losses.items()})}; "
                  f"host {r.step_ms:.1f} ms (data wait {r.data_ms:.1f} ms)", flush=True)
        for r in vals:
            print(f"phase 7 validation at {r.iteration} ({r.ms:.1f} ms): "
                  f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
        blocks = field.encoder.vit_encoder.vit.cfg.depth
        renders = STAGE2_STEPS + 1 + len(vals) * STAGE2_VAL_ITEMS  # steps, the seeding, validation items (batch 1)
        expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": renders * blocks, "encode_view": renders}
        print(f"phase 7 run: {len(steps)} steps in {run_s:.1f} s wall (model build, resume_from, seeding, data, "
              f"steps, validations, checkpoints); peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} "
              f"(expected {json.dumps(expect)}: each step, the seeding and each validation item encode one view "
              f"and render it through K6)", flush=True)
        if (len(steps) != STAGE2_STEPS or state.step != STAGE2_STEPS or state.applied != STAGE2_STEPS
                or state.total_notfinite != 0 or not _finite(v for r in steps for v in r.losses.values())):
            fail(f"stage 2 took {len(steps)} steps, state step {state.step}, applied {state.applied}, non-finite "
                 f"{state.total_notfinite}, or a loss was not finite")
        if len(vals) != 2 or not all("stego_cluster_weighted_miou" in r.metrics and _finite(r.metrics.values())
                                     for r in vals):
            fail("a stage-2 validation is missing or not finite")
        if counts != expect:
            fail(f"stage 2 launched {counts}, expected {expect}")
        moved = {k: not torch.equal(v, init[k]) for k, v in head.state_dict().items() if v.is_floating_point()}
        if not all(moved.values()):
            fail(f"stage 2 left head parameters unchanged: {[k for k, v in moved.items() if not v]}")
        frozen = torch.load(cli.find_latest_checkpoint(stage1_dir), map_location="cuda", weights_only=True)["field"]
        if not _state_equal(field.state_dict(), frozen):
            fail("stage 2 changed the frozen field")
        if len(written) != len(vals) or any(
                w.pseudo_assignment[key] != v.arrays[key].tolist() for w, v in zip(written, vals)
                for key in ("direct_cluster_assignment", "stego_cluster_assignment")):
            fail("a validation's pseudo assignment is not what the cluster heads hold after it")
        print(f"phase 7 checks: every step finite and applied; all {len(moved)} head tensors moved; the field "
              f"bitwise equal to {os.path.basename(cli.find_latest_checkpoint(stage1_dir))}; after each validation "
              f"both cluster heads hold its assignment "
              f"{[w.pseudo_assignment['stego_cluster_assignment'] for w in written]} (stego)", flush=True)

        # the loop writes the checkpoint, then validates: the step-6 checkpoint holds
        # the final state but the assignment of the validation at 3 (the reference's order)
        out = conf["output"]["path"]
        ckpt = os.path.join(out, f"training_checkpoint_{STAGE2_STEPS}.pt")
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)
        head2 = fresh_head()
        state2 = down.init_downstream_state(head2, down.DownstreamTrainConfig())
        load_checkpoint(ckpt, head2, state2)
        reloaded = _state_equal(train_state_dict(head2, state2), saved)
        assignments = {f"{name}_head.pseudo_assignment": f"{name}_assignment"
                       for name in ("direct_cluster", "stego_cluster")}

        def without_assignments(tree):
            return {**tree, "head": {k: v for k, v in tree["head"].items() if k not in assignments}}

        final = _state_equal(without_assignments(train_state_dict(head, state)), without_assignments(saved))
        before_last = all(saved["head"][k].tolist() == written[0].pseudo_assignment[v] for k, v in assignments.items())
        print(f"phase 7 checkpoint {os.path.basename(ckpt)} ({os.path.getsize(ckpt)} bytes) loads back equal: "
              f"{reloaded}; equals the final state but for the assignments: {final}; holds the assignment of the "
              f"validation at 3: {before_last}; field snapshot field_params.pt "
              f"{os.path.getsize(os.path.join(out, cli.FIELD_SNAPSHOT))} bytes", flush=True)
        if not (reloaded and final and before_last):
            fail("the stage-2 checkpoint does not hold the run's state, or did not load back to it")
        del head2, state2, saved

        records.records.clear()
        conf2 = copy.deepcopy(conf)
        conf2["training"].update(stop_iteration=STAGE2_RESUME_TO)
        conf2["training"]["continue"] = True
        _, _, state2 = cli.run_stage2(conf2, device="cuda")
        resumed = records.with_attr("resumed_from")
        its = [r.iteration for r in records.with_attr("losses")]
        print(f"phase 7 resume: from {[os.path.basename(r.resumed_from) for r in resumed]} at "
              f"{[r.iteration for r in resumed]}, then iterations {its}, final step {state2.step}", flush=True)
        if (len(resumed) != 1 or resumed[0].iteration != STAGE2_STEPS or state2.step != STAGE2_RESUME_TO
                or its != list(range(STAGE2_STEPS + 1, STAGE2_RESUME_TO + 1))):
            fail("the stage-2 run did not resume from its checkpoint as expected")
        del state2

        # one more step of the first run's head and state, profiled: where a stage-2 step's device time goes
        B = conf["batch_size"]
        batch = next(cli.make_val_batches_fn(make_datasets(conf["dataset"])[0], range(B), B, cli.SEMANTIC_KEYS,
                                             "cuda")())
        scfg = dataclasses.replace(down.DownstreamTrainConfig(), lr=conf["training"]["optimizer"]["args"]["lr"],
                                   render_height=enc["image_size"][0], render_width=enc["image_size"][1],
                                   n_samples=head.cfg.patch_sample_size)
        srcfg = RenderConfig(n_coarse=conf["renderer"]["n_coarse"])
        step = down.make_downstream_train_step(field, head, scfg, srcfg)
        gp = torch.Generator(device="cuda").manual_seed(seed + 900)
        step(state, batch, down.draw_stage2(gp, scfg, head.cfg, srcfg, B, batch["imgs"].shape[1]))  # warm
        draws = down.draw_stage2(gp, scfg, head.cfg, srcfg, B, batch["imgs"].shape[1])
        print(f"phase 7 profile (one stage-2 step, batch {B}): {profile_device(lambda: step(state, batch, draws))}",
              flush=True)

        # downstream_forward at 32x64 on the GPU against the CPU: the same field, head, buffers and draws, on the
        # front view (the linear probes) and on the side view (the STEGO terms)
        h, w = 32, 64
        cfg = dataclasses.replace(down.DownstreamTrainConfig(), render_height=h, render_width=w,
                                  n_samples=head.cfg.patch_sample_size)
        rcfg = RenderConfig(n_coarse=K)
        gc = torch.Generator().manual_seed(seed + 800)
        small = {**train_batch(gc, 2, h, w, "cpu"),
                 "segs": torch.randint(0, head.cfg.gt_classes, (2, 1, h, w), generator=gc)}
        drawn = down.draw_stage2(gc, cfg, head.cfg, rcfg, 2, small["imgs"].shape[1])
        cpu_field, cpu_head = copy.deepcopy(field).to("cpu"), copy.deepcopy(head).to("cpu")
        p99s, coss, head_rel, stego_abs, losses, nonzero = [], [], 0.0, 0.0, {}, set()
        for view, coin in (("front", False), ("side", True)):
            draws = dataclasses.replace(drawn, side_coin=coin)
            res = {}
            for dev in ("cuda", "cpu"):
                f, hd = (field, head) if dev == "cuda" else (cpu_field, cpu_head)
                bufs = down.RingBufferState.create(hd.cfg.buffer_size, hd.cfg.patch_sample_size, hd.cfg.input_dim,
                                                   dev)
                seg, rend, _ = down.downstream_forward(f, hd, {k: v.to(dev) for k, v in small.items()}, bufs,
                                                       _to(draws, dev), cfg, rcfg)
                res[dev] = ({k: float(v.detach()) for k, v in stego_loss(seg).items()},
                            {k: v.float().cpu() for k, v in rend.items()})
            (lg, rg), (lc, rc) = res["cuda"], res["cpu"]
            d_rel = ((rg["depth"] - rc["depth"]).abs() / rc["depth"]).flatten()
            p99s.append(torch.quantile(d_rel, 0.99).item())
            coss.append(torch.nn.functional.cosine_similarity(rg["dino_features"].flatten(0, -2),
                                                              rc["dino_features"].flatten(0, -2), dim=-1)
                        .median().item())
            for k in lc:
                if k == "total_loss":
                    continue
                if k.endswith(("cluster_loss", "linear_loss")):
                    head_rel = max(head_rel, abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6))
                else:
                    stego_abs = max(stego_abs, abs(lg[k] - lc[k]))
                if lg[k] != 0.0 or lc[k] != 0.0:
                    nonzero.add(k)
            losses[view] = {"GPU": {k: round(v, 6) for k, v in lg.items()},
                            "CPU": {k: round(v, 6) for k, v in lc.items()}}
        zero = sorted({k for v in losses.values() for k in v["CPU"] if k != "total_loss"} - nonzero)
        print(f"phase 7 small-input check of downstream_forward ({h}x{w}, batch 2, the run's field and head, the same "
              f"draws, front and side view): depth rel err p99 {max(p99s):.3e} (bound {EVAL_DEPTH_REL_P99}); 768-d "
              f"feature median cosine {min(coss):.6f} (bound {SLICE_COS}); cluster and probe losses max rel err "
              f"{head_rel:.3e} (bound {STAGE2_HEAD_LOSS_REL}); STEGO terms max abs err {stego_abs:.3e} (bound "
              f"{STAGE2_STEGO_ABS}); losses 0 on both sides in both views {zero}; losses {json.dumps(losses)}",
              flush=True)
        if not (max(p99s) <= EVAL_DEPTH_REL_P99 and min(coss) >= SLICE_COS and head_rel <= STAGE2_HEAD_LOSS_REL
                and stego_abs <= STAGE2_STEGO_ABS and not zero):
            fail("the GPU stage-2 forward disagrees with the CPU on the small input, or a loss compared nothing")
    finally:
        for lg in loggers:
            lg.removeHandler(records)
    print(f"phase 7 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, conf["output"]["path"]


def _to(draws, device):
    """A Stage2Draws with every tensor on `device`."""
    from scenedino_torch.models.downstream import HeadDraws

    def mv(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    fields = {f.name: mv(getattr(draws, f.name)) for f in dataclasses.fields(draws)}
    fields["head"] = HeadDraws(*(mv(getattr(draws.head, f.name)) for f in dataclasses.fields(draws.head)))
    return type(draws)(**fields)


def phase_stage2_convergence(seed, scratch):
    """Phase 7b: 3 steps and a validation of
    configs/train_semantic_synthetic_convergence.yaml (fp32, tiny ViT,
    d_hidden 64) from tests/goldens/s1b_field_params.npz. Returns its
    launch counts."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.utils import config as yaml_config

    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_semantic_synthetic_convergence.yaml"))
    conf["resume_from"] = os.path.join(root, "tests", "goldens", "s1b_field_params.npz")
    conf["dataset"]["length"] = STAGE2_ITEMS
    conf["training"].update(stop_iteration=3, checkpoint_every=3, log_every=1)
    conf["validation"]["validation"]["events"][0]["args"]["every"] = 3
    conf["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
    conf["output"]["path"] = tempfile.mkdtemp(prefix="stage2_convergence_", dir=scratch)
    records = LogRecords()
    log = logging.getLogger("training")
    log.addHandler(records)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        field, head, state = cli.run_stage2(conf, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
    finally:
        log.removeHandler(records)
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "encode_view": 3 + 1 + 2}
    print(f"phase 7b stage-2 convergence recipe (configs/train_semantic_synthetic_convergence.yaml, fp32, "
          f"{conf['dataset']['image_size']}, d_hidden {conf['model']['decoder_heads'][0]['args']['d_hidden']}, from "
          f"s1b_field_params.npz; cuts: dataset.length 64 -> {STAGE2_ITEMS}, stop_iteration 3, checkpoint_every 3, "
          f"log_every 1, validation at 3 over items 0-1): total losses "
          f"{[round(float(r.losses['total_loss']), 6) for r in steps]}, host ms {[round(r.step_ms, 1) for r in steps]}; "
          f"validation {json.dumps({k: round(float(v), 6) for r in vals for k, v in r.metrics.items()})}; "
          f"{wall:.1f} s wall; launches {json.dumps(counts)} (expected {json.dumps(expect)}: the ViT's plain branch, "
          f"K6 for the 3 steps, the seeding and 2 validation items)", flush=True)
    if (len(steps) != 3 or state.applied != 3 or len(vals) != 1 or counts != expect
            or not _finite(v for r in steps for v in r.losses.values()) or not _finite(vals[0].metrics.values())):
        fail("the stage-2 convergence recipe's run was not 3 finite applied steps and one finite validation "
             "through K6")
    return counts


# phase 8: the evaluations' cuts (frames of each synthetic tree), the label
# agreement of a kernel's path with its plain version's on the same frame
EVAL_FRAMES = 3
EVAL_LABELS_AGREE = 0.999
SSC_BLOCK = 128 * 128 * 32
SSC_SEQ = "2013_05_28_drive_0009_sync"


def _write_kv(path, rows):
    with open(path, "w") as f:
        for key, value in rows:
            f.write(key + ": " + " ".join(repr(float(x)) for x in np.ravel(value)) + "\n")


def write_sscbench_tree(root, rng):
    """A seeded SSCBench-KITTI-360 tree of EVAL_FRAMES frames of sequence 09
    in the release's layout: 376x1408 front images (the port's PNG writer),
    calib_cam_to_pose.txt, calib_cam_to_velo.txt (the release's camera ->
    velodyne), perspective.txt (the release's P_rect_00 and size), poses.txt,
    and (256, 256, 32) uint8 voxel GT drawn from the SSCBench label ids and
    255 (a ground layer, blocks above it, invalid patches)."""
    from scenedino_torch.datasets.image_io import write_png
    from scenedino_torch.eval.sscbench import CAM2VELO, CAM_K

    calib = os.path.join(root, "calibration")
    img_dir = os.path.join(root, "data_2d_raw", SSC_SEQ, "image_00", "data_rect")
    for d in (calib, img_dir, os.path.join(root, "data_poses", SSC_SEQ), os.path.join(root, "voxel_gt", SSC_SEQ)):
        os.makedirs(d, exist_ok=True)
    _write_kv(os.path.join(calib, "calib_cam_to_pose.txt"),
              [(f"image_0{i}", np.hstack([np.eye(3), [[0.8 * i], [0.3], [-0.1]]])) for i in range(4)])
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(repr(float(x)) for x in CAM2VELO[:3].ravel()) + "\n")
    _write_kv(os.path.join(calib, "perspective.txt"),
              [("P_rect_00", np.hstack([CAM_K, np.zeros((3, 1))])), ("R_rect_00", np.eye(3)),
               ("R_rect_01", np.eye(3)), ("S_rect_00", [1408, 376])])
    poses = []
    for i in range(EVAL_FRAMES):
        write_png(os.path.join(img_dir, f"{i:010d}.png"), rng.integers(0, 256, (376, 1408, 3), dtype=np.uint8))
        poses.append([i] + list(np.hstack([np.eye(3), [[0.0], [0.0], [1.5 * i]]]).ravel()))
        gt = np.zeros((256, 256, 32), np.uint8)
        gt[:, :, :3] = rng.choice(np.array([7, 8, 9, 10], np.uint8), size=(256, 256, 3))
        for _ in range(40):
            x, y, z = rng.integers(0, 240), rng.integers(0, 240), rng.integers(3, 20)
            gt[x:x + 16, y:y + 16, z:z + 8] = rng.choice(np.array([1, 2, 11, 13, 14, 15, 16, 18], np.uint8))
        gt[rng.random((256, 256, 32)) < 0.05] = 255
        np.save(os.path.join(root, "voxel_gt", SSC_SEQ, f"{i:06d}_1_1.npy"), gt)
    np.savetxt(os.path.join(root, "data_poses", SSC_SEQ, "poses.txt"), np.asarray(poses))


def write_cityscapes_tree(root, rng):
    """A seeded Cityscapes tree of EVAL_FRAMES frames at the release's 1024x2048:
    leftImg8bit/val/<city>/*_leftImg8bit.png and gtFine/val/<city>/*_gtFine_labelIds.png."""
    from scenedino_torch.datasets.image_io import write_png

    for i in range(EVAL_FRAMES):
        city = ("frankfurt", "lindau", "munster")[i]
        for d in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, d, "val", city), exist_ok=True)
        base = f"{city}_000000_{i:06d}"
        write_png(os.path.join(root, "leftImg8bit", "val", city, f"{base}_leftImg8bit.png"),
                  rng.integers(0, 256, (1024, 2048, 3), dtype=np.uint8))
        write_png(os.path.join(root, "gtFine", "val", city, f"{base}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (1024, 2048), dtype=np.uint8))


def _logged(fn, loggers=("evaluation",)):
    """fn() with the launch counters zeroed before and read after, the
    loggers' records and the peak memory: (records, launches, peak GiB,
    wall s)."""
    from scenedino_torch import kernels

    records = LogRecords()
    logs = [logging.getLogger(n) for n in loggers]
    for lg in logs:
        lg.setLevel(logging.INFO)
        lg.addHandler(records)
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
    finally:
        for lg in logs:
            lg.removeHandler(records)
    return records, counts, torch.cuda.max_memory_allocated() / 2 ** 30, wall


def _run_logged(fn, argv):
    """fn(argv) through `_logged` with the "evaluation" logger: (result,
    launches, per-frame records, peak GiB, wall s)."""
    out = []
    records, counts, peak, wall = _logged(lambda: out.append(fn(argv)))
    return out[0], counts, records.with_attr("frame"), peak, wall


def _in_unit(values) -> bool:
    return all(np.isfinite(float(v)) and 0.0 <= float(v) <= 1.0 for v in values)


def phase_eval_sscbench(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8a: `cli.evaluate_sscbench.main` on a seeded SSCBench tree with
    phase 7's stage-2 run; then with --test-alpha-cutoffs on one frame; K4
    against its plain version on every block of one frame and the labels
    of both; the fast path against --slow (printed). Returns (the main
    run's launches, K4's block measurement, the tree's root)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate_sscbench as cli
    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.kernels.point_render import point_query, point_query_plain
    from scenedino_torch.ops import fast_field
    from scenedino_torch.utils.config import load_run_config
    from scenedino_torch.utils.timing import profile_device, time_ms

    root = tempfile.mkdtemp(prefix="sscbench_", dir=scratch)
    t0 = time.perf_counter()
    write_sscbench_tree(root, np.random.default_rng(seed + 80))
    write_s = time.perf_counter() - t0
    config = load_run_config(stage2_dir)
    field, head = eval_model(config, stage2_dir, device)
    depth = field.encoder.vit_encoder.vit.cfg.depth
    argv = ["--data", root, "--voxel-gt", os.path.join(root, "voxel_gt"), "--ckpt", stage2_dir,
            "--config", stage2_dir, "--device", device]
    (table, acc), counts, frames, peak, wall = _run_logged(cli.main, argv)
    blocks = 256 * 256 * 32 // SSC_BLOCK
    enc = config["model"]["encoder"]
    stages = ("read_ms", "encode_ms", "query_ms", "accumulate_ms")
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
              "point_query": EVAL_FRAMES * blocks}
    print(f"phase 8a SSCBench: cli.evaluate_sscbench.main on a seeded tree of {EVAL_FRAMES} frames "
          f"(376x1408 PNGs, written in {write_s:.1f} s) with phase 7's run ({enc['encoder_arch']} {enc['version']}, "
          f"DPT {enc['decoder_out_dim']}, with_amp {config.get('with_amp')}, {enc['image_size']}, "
          f"{config['downstream']['n_classes']} clusters), fast path: {json.dumps(table)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in stages} for r in frames])}; "
          f"{wall:.1f} s wall (model build and load included); peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: {depth} K1 and {blocks} K4 blocks of {SSC_BLOCK} "
          f"points a frame)", flush=True)
    if not all(_in_unit(table[s].values()) for s in ("12.8", "25.6", "51.2")) or not table["sec_per_frame"] > 0:
        fail(f"the SSCBench table is not finite in [0, 1]: {table}")
    if counts != expect or len(frames) != EVAL_FRAMES:
        fail(f"the SSCBench evaluation launched {counts} over {len(frames)} frames, expected {expect}")
    # every range's occupancy numbers cover the valid in-view voxels of all frames
    dataset = SSCBenchDataset(data_path=root, voxel_gt_path=os.path.join(root, "voxel_gt"))
    fov = S.get_fov_mask()
    valid = {size: 0 for size in S.SIZES}
    for i in range(EVAL_FRAMES):
        target = S.convert_voxels(dataset[i]["voxel_gt"], S.SSCBENCH_TO_LABEL)
        target = np.where(S.identify_additional_invalids(target), 255, target)
        for size in S.SIZES:
            nv = int(size // 0.2)
            sl = np.s_[:nv, 128 - nv // 2:128 + nv // 2, :]
            valid[size] += int(((target[sl] != 255) & fov[sl]).sum())
    covered = {size: sum(acc.results[size][k] for k in ("tp", "fp", "tn", "fn")) for size in S.SIZES}
    print(f"phase 8a occupancy numbers per range (tp + fp + tn + fn) {covered}, valid in-view voxels {valid}",
          flush=True)
    if covered != valid:
        fail("the SSCBench occupancy numbers do not cover the valid in-view voxels")

    (diag, _), _, dframes, _, dwall = _run_logged(cli.main, argv + ["--max-frames", "1", "--test-alpha-cutoffs"])
    print(f"phase 8a --test-alpha-cutoffs on one frame ({dwall:.1f} s, accumulation "
          f"{dframes[0].accumulate_ms:.1f} ms): best cutoffs {json.dumps(diag['best_alpha_cutoffs'])}; tradeoff "
          f"{json.dumps(diag['sigma_tradeoff'][:3])} ...", flush=True)
    if len(diag["best_alpha_cutoffs"]) != 15 or not all(np.isfinite(r["iou"]) for r in diag["sigma_tradeoff"]):
        fail("the sigma-cutoff search is incomplete or not finite")

    # the alpha-weighted argmax on the card: equal weighted scores (a tie, or sigma 0) give the first class
    tie_sigma = torch.tensor([0.0, 1.0, 1.0], device=device)
    tie_scores = torch.tensor([[0.0, 1.0, 1.0], [0.5, 0.5, 0.2], [0.1, 0.3, 0.3]], device=device)
    ties = S.make_grid_predictor(lambda b, _: (tie_sigma[None], tie_scores[None]), chunk_points=3, grow=False,
                                 grid_dim=(3, 1, 1), coherent=False)(torch.zeros(3, 3, device=device), None)[1]
    print(f"phase 8a alpha-weighted argmax of tied scores on the card: {ties.reshape(-1).tolist()} (the first "
          f"class of each tie: [0, 0, 1])", flush=True)
    if ties.reshape(-1).tolist() != [0, 0, 1]:
        fail("the alpha-weighted argmax does not take the first class of a tie on the card")

    # K4 on every block of frame 0 against its plain version on the card, and the labels of the two
    sample = dataset[0]
    frame = [torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    pts, fov_flat = S.generate_point_grid()
    pts = torch.from_numpy(pts).to(device)
    fs = cli.make_encode_fn(field, fast=True)(*frame)
    coherent = pts.reshape(256, 256, 32, 3).permute(2, 0, 1, 3).reshape(-1, SSC_BLOCK, 3)
    view = fast_field._single_view(fs, "phase 8a")
    pcfg = fast_field._point_config(field.cfg)
    # errors as phase 3c's; a trained field's outputs exceed 1, where one bf16 flip of h moves an output in
    # proportion to its size: the gate is the error over each point's largest output (at least 1)
    err_abs, err_range, err_scaled, size_at_range = 0.0, 0.0, 0.0, 0.0
    for block in coherent:
        sigma, feat = point_query(block, *view, pcfg)
        ref_s, ref_f = point_query_plain(block, *view, pcfg)
        d = torch.maximum((sigma - ref_s).abs(), (feat - ref_f).abs().amax(-1))
        size = torch.maximum(ref_s, ref_f.abs().amax(-1))
        near = (block[:, 2] >= pcfg.z_near) & (block[:, 2] <= pcfg.z_far)
        err_abs = max(err_abs, d.max().item())
        i = torch.argmax(torch.where(near, d, torch.zeros_like(d)))
        if d[i].item() > err_range:
            err_range, size_at_range = d[i].item(), size[i].item()
        err_scaled = max(err_scaled, (d / torch.clamp_min(size, 1.0)).max().item())
    one_hot = torch.eye(cli.N_CLASSES, device=device)
    mode = "stego_kmeans"

    def plain_query(block, state):
        sigma, feat = point_query_plain(block[0], *view, pcfg)
        return sigma[None], one_hot[field.segment_features(feat, head, mode)[1]][None]

    with torch.no_grad():
        sig_k, seg_k = S.make_grid_predictor(cli.make_query_fn(field, head, mode, True))(pts, fs)
        sig_p, seg_p = S.make_grid_predictor(plain_query)(pts, fs)
    fov3 = torch.from_numpy(fov_flat.reshape(256, 256, 32)).to(device)
    agree = (seg_k == seg_p)[fov3].float().mean().item()
    print(f"phase 8a K4 on frame 0's {blocks} blocks against point_query_plain: error over each point's largest "
          f"output (at least 1) {err_scaled:.3e} (bound {K4_TOL}); max abs error on points in [{pcfg.z_near}, "
          f"{pcfg.z_far}] m {err_range:.3e} at a point whose largest output is {size_at_range:.3f}, on all points "
          f"{err_abs:.3e}; grown sigma max abs difference {(sig_k - sig_p).abs().max().item():.3e}; labels equal on "
          f"{agree:.6f} of the {int(fov3.sum())} in-view voxels (bound {EVAL_LABELS_AGREE})", flush=True)
    if not (err_scaled <= K4_TOL and agree >= EVAL_LABELS_AGREE):
        fail("K4 on the SSCBench blocks disagrees with its plain version, or the labels do")

    # K4 at the block shape: times and the bound (distinct grid rows read, points, sigma and features moved)
    block = coherent[0].contiguous()
    grid, w_code, b1, w2, b2, feat_w2c, feat_k = view
    ms = time_ms(lambda: point_query(block, *view, pcfg))
    plain_ms = time_ms(lambda: point_query_plain(block, *view, pcfg), reps=5)
    P, D, E, C = block.shape[0], grid.shape[-1], w2.shape[-1], w_code.shape[0]
    rows = grid_rows_read(block, grid, feat_w2c, feat_k)
    in_bytes = rows * D * 2 + nbytes(block, w_code, b1, w2, b2, feat_w2c, feat_k)
    out_bytes = P * 4 * E
    b, by = bound_ms(2.0 * P * (C * D + D * E), in_bytes + out_bytes)
    block_entry = {"points": P, "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                   "max_abs_err": err_abs}
    print(f"phase 8a K4 point_query at the evaluation's block ({P} points, the phase-7 field's "
          f"{grid.shape[0]}x{grid.shape[1]}x{D} bf16 folded grid, d_out {E}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} distinct grid rows, inputs {in_bytes / 1e6:.1f} MB, "
          f"sigma and features {out_bytes / 1e6:.1f} MB); {corner_traffic(P, D)}", flush=True)
    predict = S.make_grid_predictor(cli.make_query_fn(field, head, mode, True))
    print(f"phase 8a profile (one frame's grid query: 4 x K4, the 768-d expansion and the head, the argmax, the "
          f"pool): {profile_device(lambda: predict(pts, fs))}", flush=True)

    # the fast path against --slow on the card (printed): both fold in bf16, at different points
    with torch.no_grad():
        state = cli.make_encode_fn(field, fast=False)(*frame)
        sig_s, seg_s = S.make_grid_predictor(cli.make_query_fn(field, head, mode, False), coherent=False)(pts, state)
    print(f"phase 8a fast path against --slow (the unfolded bf16 field in plain torch), frame 0: grown sigma max abs "
          f"difference {(sig_k - sig_s).abs().max().item():.3e} (largest sigma {sig_s.abs().max().item():.3e}); "
          f"labels equal on {(seg_k == seg_s)[fov3].float().mean().item():.6f} of the in-view voxels", flush=True)
    del field, head, fs, state
    return counts, block_entry, root


def _eval_config(root, stage2_dir, data):
    """configs/evaluate_semantic_cityscapes.yaml with phase 7's model,
    precision and downstream blocks (it has none: `variant: dino`), the data
    path set to the seeded tree."""
    from scenedino_torch.utils.config import load, load_run_config

    conf = load(os.path.join(root, "configs", "evaluate_semantic_cityscapes.yaml"))
    run = load_run_config(stage2_dir)
    conf.pop("variant", None)
    conf["model"], conf["with_amp"] = copy.deepcopy(run["model"]), run.get("with_amp", False)
    conf["downstream"] = {**conf.get("downstream", {}), **copy.deepcopy(run["downstream"])}
    conf["dataset"]["data_path"] = data
    return conf


def phase_eval_seg2d(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8b: `cli.evaluate.main` on a seeded Cityscapes tree with phase
    7's run, then once with apply_crf on one frame; the evaluator's K6 render
    against K6's plain version on one frame, and the labels of the four
    modes. Returns the main run's launches, K6's measurement at the frame and the tree's root."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli
    from scenedino_torch.datasets import make_test_dataset
    from scenedino_torch.kernels.encode_view import encode_view, encode_view_plain
    from scenedino_torch.ops.fast_field import build_fast_state, encode_view_inputs
    from scenedino_torch.tools.bench_encode_view import TOL, bound
    from scenedino_torch.utils.config import save_run_config
    from scenedino_torch.utils.timing import time_ms

    root = os.path.dirname(os.path.abspath(__file__))
    data = tempfile.mkdtemp(prefix="cityscapes_", dir=scratch)
    t0 = time.perf_counter()
    write_cityscapes_tree(data, np.random.default_rng(seed + 81))
    write_s = time.perf_counter() - t0
    conf = _eval_config(root, stage2_dir, data)
    conf_dir = tempfile.mkdtemp(prefix="eval_config_", dir=scratch)
    save_run_config(conf_dir, conf)
    out, counts, frames, peak, wall = _run_logged(cli.main, ["--config", conf_dir, "--ckpt", stage2_dir,
                                                              "--device", device])
    depth = conf["model"]["encoder"].get("vit_overrides", {}).get("depth", 12)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
              "encode_view": EVAL_FRAMES}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    print(f"phase 8b 2D segmentation: cli.evaluate.main on a seeded Cityscapes tree of {EVAL_FRAMES} frames "
          f"(1024x2048 PNGs, written in {write_s:.1f} s), configs/evaluate_semantic_cityscapes.yaml with phase 7's "
          f"model and downstream blocks: {json.dumps(summary)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in ('read_ms', 'frame_ms')} for r in frames])}; "
          f"{wall:.1f} s wall (model build and load included); peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: {depth} K1 and one K6 a frame)", flush=True)
    if out["n_frames"] != EVAL_FRAMES or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the 2D evaluation is not {EVAL_FRAMES} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the 2D evaluation launched {counts}, expected {expect}")

    conf_crf = copy.deepcopy(conf)
    conf_crf["downstream"]["apply_crf"] = True
    crf_dir = tempfile.mkdtemp(prefix="eval_config_crf_", dir=scratch)
    save_run_config(crf_dir, conf_crf)
    out_crf, _, crf_frames, _, crf_wall = _run_logged(cli.main, ["--config", crf_dir, "--ckpt", stage2_dir,
                                                                 "--max-frames", "1", "--device", device])
    crf_summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out_crf.items() if isinstance(r, dict)}
    print(f"phase 8b apply_crf (the window CRF, one frame, {crf_wall:.1f} s wall; the frame "
          f"{crf_frames[0].frame_ms:.1f} ms against {frames[0].frame_ms:.1f} ms without): "
          f"{json.dumps({m: v for m, v in crf_summary.items() if m.endswith('_crf')})}", flush=True)
    if len(crf_summary) != 8 or not all(_in_unit(r.values()) for r in crf_summary.values()):
        fail(f"the CRF rows are missing or not finite in [0, 1]: {out_crf}")

    # K6 as the evaluator launches it (one frame, the fp32 fold) against its plain version on the same inputs
    from scenedino_torch.eval.seg2d import MODES, Seg2DEvaluator

    field, head = cli.eval_model(conf, stage2_dir, device)
    H, W = conf["dataset"]["image_size"]
    ev = Seg2DEvaluator(field=field, head=head, image_size=(H, W))
    sample = make_test_dataset(conf["dataset"])[0]
    frame = [torch.as_tensor(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    with torch.no_grad():
        state = field.encode(*frame, ids_encoder=(0,))
        fs = build_fast_state(field, state, compute_dtype=torch.float32)
        args, ecfg = encode_view_inputs(fs, field.cfg, H, W, u=ev.draws(0, device)[None], n_coarse=ev.n_coarse)
        out_k = encode_view(*args, ecfg)
        out_p = encode_view_plain(*args, ecfg)
        errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), out_k, out_p)}
        feats = [field.expand_dim(o[1].reshape(H, W, -1)) for o in (out_k, out_p)]
        agree = {m: (head(feats[0], mode=m) == head(feats[1], mode=m)).float().mean().item() for m in MODES}
        rendered = ev.render(*frame, ev.draws(0, device))
        evaluator_err = max((rendered[i].reshape(out_k[i].shape) - out_k[i]).abs().max().item() for i in range(3))
    tol = TOL[torch.float32]
    ms = time_ms(lambda: encode_view(*args, ecfg))
    plain_ms = time_ms(lambda: encode_view_plain(*args, ecfg), reps=3, warmup=1)
    b, by = bound(args, torch.float32)
    print(f"phase 8b K6 on frame 0 as the evaluator launches it (fp32 fold, {H}x{W} rays x {ev.n_coarse}): errors "
          f"{json.dumps(errs)} (bounds {json.dumps(tol)}); the evaluator's own render of the frame differs from this "
          f"launch's by {evaluator_err:.3e} (bound {tol['feature']}); labels equal "
          f"{json.dumps({m: round(v, 6) for m, v in agree.items()})} (bound "
          f"{EVAL_LABELS_AGREE}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; three TF32 "
          f"passes)", flush=True)
    if not (all(errs[k] <= tol[k] for k in tol) and evaluator_err <= tol["feature"]
            and min(agree.values()) >= EVAL_LABELS_AGREE):
        fail("K6 on the 2D evaluation frame disagrees with its plain version, or the labels do")
    del field, head, fs, state
    shape = {"frames": 1, "dtype": "float32", "height": H, "width": W, "d_hidden": args[0].shape[1],
             "d_out": args[4].shape[1], "samples": ev.n_coarse, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "max_abs_err": max(errs.values())}
    return counts, shape, data


def phase_eval(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8: evaluation on the card (8a SSCBench, 8b 2D segmentation) from
    phase 7's stage-2 run directory. Returns (the two main runs' launches, K4
    at the evaluation's block, K6 at the evaluator's frame, the SSCBench and
    Cityscapes trees' roots)."""
    t_phase = time.perf_counter()
    ssc_counts, k4_block, ssc_root = phase_eval_sscbench(seed, stage2_dir, scratch, device)
    seg_counts, k6_frame, city_root = phase_eval_seg2d(seed, stage2_dir, scratch, device)
    print(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: ssc_counts[k] + seg_counts[k] for k in ssc_counts}, k4_block, k6_frame, (ssc_root, city_root)


# phase 9: the reference's checkpoints. The configs each variant's SSCBench
# run rebuilds its model from; the v2 encoder's GPU-CPU check: the pre-resize
# (the same float32 matrices, summed in another order) and the fp32 ViT-B/14
# with TF32 off (fp32 sums in other orders through 12 blocks), relative to
# the largest output
REFERENCE_CONFIGS = {"v1": "train_semantic_kitti_360.yaml", "v2": "train_scenedino_kitti_360_dinov2.yaml"}
RESIZE_GPU_TOL = 1e-6
V2_ENCODER_REL = 1e-4


@contextlib.contextmanager
def first_call(module, name):
    """Keep the arguments of the first call of `module.name` (a kernel
    wrapper as its caller sees it) in the yielded list; calls pass through."""
    calls, original = [], getattr(module, name)

    def spy(*args):
        if not calls:
            calls.append(args)
        return original(*args)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def k1_batches():
    """Keep (batch, with the log-sum-exp) of every K1 forward call of the ViT
    in the yielded set (the lse where a gradient is wanted, as
    `kernels.attention.attention` decides); calls pass through."""
    from scenedino_torch.models import vit as vit_mod

    seen, original = set(), vit_mod.attention

    def spy(q, k, v):
        seen.add((q.shape[0], torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)))
        return original(q, k, v)

    vit_mod.attention = spy
    try:
        yield seen
    finally:
        vit_mod.attention = original


def reference_checkpoint(conf, seed, path, device="cuda"):
    """A field and head of `conf` (a config's model and downstream blocks)
    at full width, drawn from `seed` (LayerScale drawn around 0.1, not the
    initial 1e-5), written to `path` as the reference's trainer writes
    checkpoint.pt: {"model": BTSWrapper state dict}, on the host. Returns
    the field's and the head's state_dicts as drawn, and the head."""
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.utils.convert import to_reference_layout

    field = make_model(conf["model"], device=device, seed=seed, training=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.endswith((".ls1", ".ls2")):
                p.copy_(0.1 + 0.05 * torch.randn(p.shape, generator=gen, device=device))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        head = SemanticHead(SemanticHeadConfig.from_dict(conf.get("downstream", {}))).to(device)
    enc = field.encoder
    H_, W_ = conf["model"].get("encoder", {}).get("image_size", (H, W))
    artifact = 1e-3 * torch.randn(enc.gt_encoder.latent_size, H_ // enc.gt_patch_size, W_ // enc.gt_patch_size,
                                  generator=gen, device=device)
    sd = to_reference_layout(field.state_dict(), head.state_dict(), artifact)
    torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, path)
    return field.state_dict(), head.state_dict(), head


def _bitwise(got, want) -> bool:
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def phase_reference(seed, scratch, ssc_root, city_root, device="cuda"):
    """Phase 9: checkpoints in the reference's torch layout (the published
    ssc-kitti-360-dino and -dinov2 architectures) at full width from `seed`,
    loaded bit for bit; cli.evaluate_sscbench.main on phase 8a's tree with
    each `.pt` against the same weights as a port run (the tables and the
    accumulated numbers identical); cli.evaluate.main with `variant: dinov2`
    on phase 8b's tree; one novel-view request on the v2 field; the v2
    encoder on the GPU against the CPU; K1, K4, K6 and K2 against their plain
    versions on this phase's inputs. Returns (the main runs' launches, the
    holds by kernel)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli_eval
    from scenedino_torch.cli import evaluate_sscbench as cli_ssc
    from scenedino_torch.core.resize import jax_resize
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.kernels.attention import attention_plain
    from scenedino_torch.kernels.encode_view import encode_view_plain
    from scenedino_torch.kernels.point_render import point_query_plain, point_render_plain
    from scenedino_torch.models import vit as vit_mod
    from scenedino_torch.models.encoder import DinoViTEncoder, normalize_input
    from scenedino_torch.ops import fast_field
    from scenedino_torch.tools.bench_encode_view import TOL
    from scenedino_torch.training.downstream import DownstreamTrainConfig, init_downstream_state
    from scenedino_torch.utils.checkpoint import load_eval_state, save_checkpoint
    from scenedino_torch.utils.config import load, save_run_config
    from scenedino_torch.utils.timing import card_line, profile_device, time_ms

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    total = {name: 0 for name in kernels.WRAPPERS}
    holds, encode_ms, spf = {}, {}, {}
    sample = SSCBenchDataset(data_path=ssc_root, voxel_gt_path=os.path.join(ssc_root, "voxel_gt"))[0]
    frame = [torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    pts = torch.from_numpy(S.generate_point_grid()[0]).to(device)
    block = pts.reshape(256, 256, 32, 3).permute(2, 0, 1, 3).reshape(-1, SSC_BLOCK, 3)[0].contiguous()
    paths = {}
    for i, (version, config_name) in enumerate(REFERENCE_CONFIGS.items()):
        config_path = os.path.join(root, "configs", config_name)
        conf = load(config_path)
        ckpt = os.path.join(scratch, f"ssc-kitti-360-{version}.pt")
        t0 = time.perf_counter()
        field_sd, head_sd, head = reference_checkpoint(conf, seed + 90 + i, ckpt, device)
        size_gb = os.path.getsize(ckpt) / 1e9
        write_s = time.perf_counter() - t0
        # the same weights as a stage-2 run directory of the port
        run = tempfile.mkdtemp(prefix=f"port_{version}_", dir=scratch)
        torch.save(field_sd, os.path.join(run, "field_params.pt"))
        save_checkpoint(os.path.join(run, "training_checkpoint_0.pt"), head,
                        init_downstream_state(head, DownstreamTrainConfig()))
        del head
        t0 = time.perf_counter()
        got_field, got_head = load_eval_state(ckpt, device=device)
        load_s = time.perf_counter() - t0
        n_ref = len(torch.load(ckpt, map_location="cpu", weights_only=True)["model"])
        exact = _bitwise(got_field, field_sd) and _bitwise(got_head, head_sd)
        print(f"phase 9 {version}: {config_name}'s model, a reference-layout checkpoint of {n_ref} tensors "
              f"({size_gb:.3f} GB, drawn and written in {write_s:.1f} s) loaded strictly by load_eval_state in "
              f"{load_s:.1f} s: {len(got_field)} field and {len(got_head)} head tensors, equal bit for bit to the "
              f"drawn ones: {exact}", flush=True)
        if not exact:
            fail(f"the {version} reference checkpoint did not load bit for bit")
        del got_field, got_head, field_sd, head_sd

        argv = ["--data", ssc_root, "--voxel-gt", os.path.join(ssc_root, "voxel_gt"), "--config", config_path,
                "--device", device]
        (table, acc), counts, frames, peak, wall = _run_logged(cli_ssc.main, argv + ["--ckpt", ckpt])
        (port_table, port_acc), port_counts, _, _, _ = _run_logged(cli_ssc.main, argv + ["--ckpt", run])
        blocks = 256 * 256 * 32 // SSC_BLOCK
        depth = 12 if version == "v1" else 0  # v2: 481 tokens, under K1's 512
        expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
                  "point_query": EVAL_FRAMES * blocks}
        spf[version] = table["sec_per_frame"]
        encode_ms[version] = [round(r.encode_ms, 1) for r in frames]
        same = ({k: v for k, v in table.items() if k != "sec_per_frame"}
                == {k: v for k, v in port_table.items() if k != "sec_per_frame"}
                and all(np.array_equal(acc.results[s][k], port_acc.results[s][k]) for s in S.SIZES
                        for k in acc.results[s]))
        stages = ("read_ms", "encode_ms", "query_ms", "accumulate_ms")
        print(f"phase 9 {version} SSCBench: cli.evaluate_sscbench.main --ckpt {os.path.basename(ckpt)} --config "
              f"{config_name} on phase 8a's {EVAL_FRAMES} frames: {json.dumps(table)}; per frame host ms "
              f"{json.dumps([{k: round(getattr(r, k), 1) for k in stages} for r in frames])}; "
              f"{wall:.1f} s wall; peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: "
              f"{depth} K1 and {blocks} K4 a frame); the same weights as a port run: table and accumulated numbers "
              f"identical {same}", flush=True)
        if counts != expect or port_counts != expect or len(frames) != EVAL_FRAMES:
            fail(f"the {version} SSCBench evaluation launched {counts} / {port_counts}, expected {expect}")
        if not same or not all(_in_unit(table[s].values()) for s in ("12.8", "25.6", "51.2")):
            fail(f"the {version} reference checkpoint's SSCBench table differs from the port run's or leaves [0, 1]")
        for name, n in counts.items():
            total[name] += n + port_counts[name]

        # the kernels against their plain versions on this checkpoint's inputs
        field, head = cli_eval.eval_model(conf, ckpt, device)
        fs = cli_ssc.make_encode_fn(field, fast=True)(*frame)
        img = frame[0][:, 0]

        def encode_once():
            with torch.inference_mode():
                return field.encoder(img)

        encoder_ms = time_ms(encode_once, reps=5)
        encode_ms[f"{version} encoder (CUDA events)"] = round(encoder_ms, 3)
        print(f"phase 9 {version} profile (the encoder alone, 192x640, bf16): {profile_device(encode_once)}",
              flush=True)
        with torch.no_grad(), first_call(vit_mod, "attention") as k1_calls, \
                first_call(fast_field, "point_query") as k4_calls:
            field.encoder(img)
            fast_field.fast_query_fused(fs, field.cfg, block)
        if version == "v1":
            q, k, v = k1_calls[0]
            err = (vit_mod.attention(q, k, v).float() - attention_plain(q, k, v).float()).abs().max().item()
            holds["attention"] = {"shape": list(q.shape), "max_abs_err": err}
            print(f"phase 9 v1 K1 on the checkpoint's first block {tuple(q.shape)} {q.dtype}: max abs err "
                  f"{err:.3e} (bound {K1_TOL})", flush=True)
            if not err <= K1_TOL:
                fail("K1 disagrees with its plain version on the v1 checkpoint's attention")
        elif k1_calls:
            fail("the v2 encoder (481 tokens) called K1")
        args = k4_calls[0]
        sigma, feat = kernels.point_query(*args)
        ref_s, ref_f = point_query_plain(*args)
        d = torch.maximum((sigma - ref_s).abs(), (feat - ref_f).abs().amax(-1))
        scaled = (d / torch.clamp_min(torch.maximum(ref_s, ref_f.abs().amax(-1)), 1.0)).max().item()
        holds.setdefault("point_query", {})[version] = {"points": block.shape[0], "max_abs_err": d.max().item(),
                                                         "err_over_largest_output": scaled}
        print(f"phase 9 {version} K4 on the first 524,288-point block: error over each point's largest output "
              f"{scaled:.3e} (bound {K4_TOL}), max abs {d.max().item():.3e}", flush=True)
        if not scaled <= K4_TOL:
            fail(f"K4 disagrees with its plain version on the {version} checkpoint's block")
        paths[version] = (ckpt, field, head)
        del fs

    # the v2 encoder on the GPU against the CPU: the pre-resize at 192x640, the fp32 ViT at 64x128
    ckpt, field, head = paths["v2"]
    x = normalize_input(frame[0][:, 0].float())
    resize_err = (jax_resize(x, (168, 560)).cpu() - jax_resize(x.cpu(), (168, 560))).abs().max().item()
    ecfg = field.encoder.cfg  # the same encoder in fp32
    enc32 = DinoViTEncoder(ecfg.encoder_arch, ecfg.version, tuple(ecfg.intermediate_features),
                           vit_overrides=ecfg.vit_overrides).to(device).eval()
    enc32.load_state_dict(field.encoder.vit_encoder.state_dict())
    small = torch.nn.functional.interpolate(frame[0][:, 0].float(), (64, 128), mode="area")
    with torch.no_grad():
        gpu = enc32(small)
        cpu = enc32.cpu()(small.cpu())
    rel = max(((g.cpu() - c).abs().max() / c.abs().max()).item() for g, c in zip(gpu, cpu))
    print(f"phase 9 v2 encoder GPU against CPU: the 14/16 pre-resize 192x640 -> 168x560 max abs err "
          f"{resize_err:.3e} (bound {RESIZE_GPU_TOL}); the fp32 ViT-B/14 at 64x128 (56x112, a 4x8 grid), each grid's "
          f"max abs err over its largest value {rel:.3e} (bound {V2_ENCODER_REL})", flush=True)
    if not (resize_err <= RESIZE_GPU_TOL and rel <= V2_ENCODER_REL):
        fail("the v2 encoder on the GPU disagrees with the CPU")
    del enc32, gpu, cpu

    # one novel-view request on the v2 field (K2), then K2 on its inputs
    g = torch.Generator(device=device).manual_seed(seed + 95)
    u = torch.rand(H * W, K, generator=g, device=device)
    kernels.reset_launches()
    with first_call(fast_field, "point_render") as k2_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(field, frame[0][:, :1], u, device)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    check_depth("v2 novel-view", *out)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "point_render": 1}
    args = k2_calls[0]
    k2 = kernels.point_render(*args)
    ref = point_render_plain(*args)
    errs = [(a - b).abs().max().item() for a, b in zip(k2, ref)]
    holds["point_render"] = {"rays": args[0].shape[0], "samples": args[1].shape[1], "max_abs_err": max(errs)}
    print(f"phase 9 v2 novel-view request: {serve_ms:.1f} ms, launches {json.dumps(counts)} (expected "
          f"{json.dumps(expect)}); K2 on its inputs: errors depth {errs[0]:.3e} m, feature {errs[1]:.3e}, rgb "
          f"{errs[2]:.3e} (bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})", flush=True)
    if counts != expect:
        fail(f"the v2 novel-view request launched {counts}, expected {expect}")
    if not (errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail("K2 disagrees with its plain version on the v2 request")
    for name, n in counts.items():
        total[name] += n
    del field, head, paths

    # the 2D evaluator on the v2 checkpoint: the variant: dinov2 preset (fp32), phase 8b's tree
    conf = load(os.path.join(root, "configs", "evaluate_semantic_cityscapes.yaml"))
    conf["variant"] = "dinov2"
    conf["dataset"]["data_path"] = city_root
    conf_dir = tempfile.mkdtemp(prefix="eval_config_v2_", dir=scratch)
    save_run_config(conf_dir, conf)
    with first_call(fast_field, "encode_view") as k6_calls:
        out, counts, frames, peak, wall = _run_logged(cli_eval.main, ["--config", conf_dir, "--ckpt", ckpt,
                                                                      "--device", device])
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "encode_view": EVAL_FRAMES}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    args = k6_calls[0]
    k6 = kernels.encode_view(*args)
    ref = encode_view_plain(*args)
    tol = TOL[torch.float32]  # the preset encodes in fp32 and folds in fp32
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), k6, ref)}
    holds["encode_view"] = {"frames": 1, "max_abs_err": max(errs.values())}
    print(f"phase 9 v2 2D segmentation: cli.evaluate.main, evaluate_semantic_cityscapes.yaml with variant: dinov2, "
          f"--ckpt {os.path.basename(ckpt)}, phase 8b's {EVAL_FRAMES} frames: {json.dumps(summary)}; per frame host "
          f"ms {json.dumps([round(r.frame_ms, 1) for r in frames])}; {wall:.1f} s wall; peak {peak:.3f} GiB; "
          f"launches {json.dumps(counts)} (expected {json.dumps(expect)}: the fp32 preset takes the ViT's plain "
          f"attention, one K6 a frame); K6 on its first frame: errors {json.dumps(errs)} (bounds {json.dumps(tol)})",
          flush=True)
    if out["n_frames"] != EVAL_FRAMES or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the v2 2D evaluation is not {EVAL_FRAMES} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the v2 2D evaluation launched {counts}, expected {expect}")
    if not all(errs[k] <= tol[k] for k in tol):
        fail("K6 disagrees with its plain version on the v2 2D evaluation frame")
    for name, n in counts.items():
        total[name] += n
    print(f"phase 9 encode: host ms per SSCBench frame v1 {encode_ms['v1']}, v2 {encode_ms['v2']}; the encoder "
          f"alone (CUDA events, 192x640, bf16) v1 {encode_ms['v1 encoder (CUDA events)']} ms, v2 "
          f"{encode_ms['v2 encoder (CUDA events)']} ms; sec_per_frame v1 {spf['v1']:.4f}, v2 {spf['v2']:.4f}; "
          f"{card_line()}; phase 9 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total, holds


# phase 10: the KITTI-360 data path. The seeded tree: one sequence of
# KITTI_FRAMES posed frames at the release's sizes (the training split's items
# reach 41 frames ahead with the recipe's fisheye offsets of up to 40, and the
# resize cache holds every frame but the last); its test items; the cuts of the
# three recipes' runs
KITTI_SEQ = "2013_05_28_drive_0000_sync"
KITTI_FRAMES = 56
KITTI_TEST_IDS = (20, 30, 40)
KITTI_STEPS = 3
KITTI_VAL_ITEMS = 2
# an item through the cache against the same item resampled on the fly: one
# 8-bit step after the [-1, 1] scaling (the cache truncates), and float32
# round-off
KITTI_CACHE_TOL = 2 / 255 + 1e-6
# processes that write the tree and the resize cache (the card's host has 8 cores)
KITTI_WORKERS = 8
# the release's fisheye calibrations (image_02.yaml, image_03.yaml), 1400x1400
KITTI_FISHEYE = {
    "02": (2.2134047507854890, 1.6798235660113681e-02, 1.6548773243373522, 1336.3220825849971, 1335.7883350012958,
           716.94323510126321, 705.76498308221585),
    "03": (2.5535139132482758, 4.9370396274089505e-02, 4.5068455478645308, 1485.4455462304386, 1484.7933577069786,
           698.47345726911731, 698.97203136519401),
}


def _texture(seed, shape, shift):
    """A seeded low-frequency RGB field (H, W, 3) uint8, moved `shift` pixels
    along x: a few sinusoids per channel, so the photometric loss has
    structure to fit."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y = np.arange(h, dtype=np.float32)[:, None] / h
    x = (np.arange(w, dtype=np.float32)[None, :] + shift) / w
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy, ph = rng.uniform(1, 6, 3), rng.uniform(1, 6, 3), rng.uniform(0, 2 * np.pi, 3)
        img[..., c] = 128 + sum(40 / (k + 1) * np.sin(2 * np.pi * (fx[k] * x + fy[k] * y) + ph[k]) for k in range(3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_kitti_frame(root, i, seed):
    """Frame i of the tree: the two rectified perspective images (376x1408)
    and the two fisheye images (1400x1400), Paeth-filtered PNGs."""
    from scenedino_torch.datasets.image_io import write_png

    raw = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    for cam, folder, shape in (("00", "data_rect", (376, 1408)), ("01", "data_rect", (376, 1408)),
                               ("02", "data_rgb", (1400, 1400)), ("03", "data_rgb", (1400, 1400))):
        write_png(os.path.join(raw, f"image_{cam}", folder, f"{i:010d}.png"),
                  _texture(seed + int(cam), shape, 12.0 * i), filter_type=4)
    return i


def kitti_train_lines(repo_root, max_id):
    """The lines of datasets/kitti_360/splits/sscbench/train_files.txt of the
    tree's sequence whose index is at most `max_id` (l and r entries)."""
    lines = []
    with open(os.path.join(repo_root, "datasets", "kitti_360", "splits", "sscbench", "train_files.txt")) as f:
        for line in f:
            seq, idx, _ = line.split()
            if seq == KITTI_SEQ and int(idx) <= max_id:
                lines.append(line.strip())
            elif seq == KITTI_SEQ and int(idx) > max_id:
                break
    return lines


def write_kitti_tree(root, repo_root, seed, workers=8):
    """A seeded KITTI-360 tree in the release's layout: KITTI_FRAMES frames of
    one sequence (perspective pairs 376x1408, fisheye pairs 1400x1400, the
    port's PNG writer with the Paeth filter, written by `workers` processes),
    calibration (the release's P_rect_00 and camera -> velodyne, phase 8a's
    camera -> pose, the fisheye YAMLs in the release's FileStorage layout),
    poses, velodyne scans and KITTI-360 semantic PNGs of the items' frames,
    and a split directory: the training lines of the repository's SSCBench
    split that the tree holds, and KITTI_TEST_IDS. Returns (the split's
    training lines, seconds)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from scenedino_torch.datasets.image_io import write_png
    from scenedino_torch.eval.sscbench import CAM2VELO, CAM_K

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    calib = os.path.join(root, "calibration")
    raw = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    velo = os.path.join(root, "data_3d_raw", KITTI_SEQ, "velodyne_points", "data")
    sem = os.path.join(root, "data_2d_semantics", "train", KITTI_SEQ, "image_00", "semantic")
    for d in [calib, velo, sem, os.path.join(root, "data_poses", KITTI_SEQ), os.path.join(root, "splits")] + [
            os.path.join(raw, f"image_{cam}", folder) for cam, folder in (("00", "data_rect"), ("01", "data_rect"),
                                                                          ("02", "data_rgb"), ("03", "data_rgb"))]:
        os.makedirs(d, exist_ok=True)
    _write_kv(os.path.join(calib, "calib_cam_to_pose.txt"),
              [(f"image_0{i}", np.hstack([np.eye(3), [[0.8 * i], [0.3], [-0.1]]])) for i in range(4)])
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(repr(float(x)) for x in CAM2VELO[:3].ravel()) + "\n")
    _write_kv(os.path.join(calib, "perspective.txt"),
              [("P_rect_00", np.hstack([CAM_K, np.zeros((3, 1))])), ("R_rect_00", np.eye(3)),
               ("R_rect_01", np.eye(3)), ("S_rect_00", [1408, 376])])
    for cam, (xi, k1, k2, g1, g2, u0, v0) in KITTI_FISHEYE.items():
        with open(os.path.join(calib, f"image_{cam}.yaml"), "w") as f:
            f.write(f"%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_{cam}\nimage_width: 1400\n"
                    f"image_height: 1400\nmirror_parameters:\n   xi: {xi:.16e}\ndistortion_parameters:\n"
                    f"   k1: {k1:.16e}\n   k2: {k2:.16e}\n   p1: 4.2223943394772046e-04\n"
                    f"   p2: 4.2462134260997584e-04\nprojection_parameters:\n   gamma1: {g1:.16e}\n"
                    f"   gamma2: {g2:.16e}\n   u0: {u0:.16e}\n   v0: {v0:.16e}\n")
    poses = []
    for i in range(KITTI_FRAMES):
        a = 0.004 * i
        poses.append([i] + list(np.array([[np.cos(a), 0, np.sin(a), 0.05 * i], [0, 1, 0, 0.0],
                                          [-np.sin(a), 0, np.cos(a), 0.8 * i]]).ravel()))
    np.savetxt(os.path.join(root, "data_poses", KITTI_SEQ, "poses.txt"), np.asarray(poses))
    train = kitti_train_lines(repo_root, KITTI_FRAMES - 2 - 41)
    with open(os.path.join(root, "splits", "train_files.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(root, "splits", "test_files.txt"), "w") as f:
        f.write("".join(f"{KITTI_SEQ} {i:010d} l\n" for i in KITTI_TEST_IDS))
    # the items' first frames: a velodyne scan (a road plane and walls ahead, x forward) and the labels
    ids = sorted({int(line.split()[1]) for line in train} | set(KITTI_TEST_IDS))
    for i in ids:
        n = 60000
        x = rng.uniform(2, 60, n)
        y = rng.uniform(-12, 12, n)
        z = np.where(rng.random(n) < 0.6, -1.7, rng.uniform(-1.7, 3.0, n))
        y = np.where(z > -1.7, np.sign(y) * rng.uniform(6, 12, n), y)
        np.stack([x, y, z, rng.random(n)], -1).astype(np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
        labels = np.zeros((376, 1408), np.uint8)
        labels[:150] = 23  # sky
        labels[150:250] = rng.choice(np.array([11, 21, 26, 17, 13], np.uint8), size=(1, 1408)).repeat(100, 0)
        labels[250:] = rng.choice(np.array([7, 8, 9, 22], np.uint8), size=(1, 1408)).repeat(126, 0)
        write_png(os.path.join(sem, f"{i:010d}.png"), labels, filter_type=2)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_write_kitti_frame, [root] * KITTI_FRAMES, range(KITTI_FRAMES), [seed] * KITTI_FRAMES))
    return train, time.perf_counter() - t0


def _kitti_dataset_block(conf, root):
    conf["dataset"].update(data_path=root, pose_path=os.path.join(root, "data_poses"),
                           split_path=os.path.join(root, "splits"))


def phase_kitti_tree(seed, scratch):
    """Phase 10a: the tree, the preprocess CLI's cache, one item through the
    cache against the same item resampled on the fly, and the loader's host
    ms. Returns (the tree's root, the loader's ms)."""
    from scenedino_torch.cli import preprocess_kitti_360
    from scenedino_torch.datasets.kitti_360 import KITTI360Dataset
    from scenedino_torch.utils.prefetch import ThreadedLoader

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="kitti360_", dir=scratch)
    train, write_s = write_kitti_tree(root, repo, seed + 100, KITTI_WORKERS)
    t0 = time.perf_counter()
    preprocess_kitti_360.main(["resize", "-d", root, "-r", str(H), str(W), "-f", "0", "-15",
                               "--workers", str(KITTI_WORKERS)])
    cache_s = time.perf_counter() - t0
    size_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 1e6
    print(f"phase 10a tree: {KITTI_FRAMES} frames of {KITTI_SEQ} (376x1408 perspective and 1400x1400 fisheye pairs, "
          f"Paeth-filtered PNGs by the port's writer, {KITTI_WORKERS} processes), the release's calibration with the "
          f"fisheye YAMLs in its FileStorage layout, {len(train)} training lines of the repository's SSCBench split "
          f"({', '.join(train)}), test items {list(KITTI_TEST_IDS)}: written in {write_s:.1f} s, {size_mb:.0f} MB; "
          f"cli.preprocess_kitti_360 resize (192x640, rotation 0x-15, {KITTI_WORKERS} processes) in {cache_s:.1f} s",
          flush=True)

    kw = dict(data_path=root, pose_path=os.path.join(root, "data_poses"),
              split_path=os.path.join(root, "splits", "train_files.txt"), fisheye_offset=(10, 25, 40),
              return_segmentation=True)
    raw, cached = KITTI360Dataset(**kw), KITTI360Dataset(is_preprocessed=True, **kw)
    worst, raw_ms, cached_ms = 0.0, [], []
    for i in range(len(cached)):
        items = []
        for ds, times in ((raw, raw_ms), (cached, cached_ms)) if i == 0 else ((cached, cached_ms),):
            ds._rng_local.rng = np.random.RandomState(seed + i)
            t0 = time.perf_counter()
            items.append(ds[i])
            times.append((time.perf_counter() - t0) * 1e3)
        if len(items) == 2:  # the first item also resampled from the raw frames
            if not np.array_equal(items[0]["poses"], items[1]["poses"]):
                fail("an item's poses through the cache differ from the raw item's")
            worst = max(worst, float(np.abs(items[0]["imgs"] - items[1]["imgs"]).max()))
    # the PNG decode of one file of each kind (the port's reader, host ms)
    from scenedino_torch.datasets.image_io import read_png, write_png

    raw_dir = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    decode = {}
    for name, path in (("fisheye 1400x1400", os.path.join(raw_dir, "image_02", "data_rgb", "0000000001.png")),
                       ("perspective 376x1408", os.path.join(raw_dir, "image_00", "data_rect", "0000000001.png")),
                       ("labels 376x1408", os.path.join(root, "data_2d_semantics", "train", KITTI_SEQ, "image_00",
                                                        "semantic", "0000000001.png")),
                       ("cached 192x640", os.path.join(raw_dir, "image_00", f"data_{H}x{W}", "0000000001.png"))):
        t0 = time.perf_counter()
        pixels = read_png(path)
        decode[name] = round((time.perf_counter() - t0) * 1e3, 1)
    # the port's cache is written without row filters; a cache written with them (as PIL does) decodes so
    paeth = os.path.join(root, "paeth_192x640.png")
    write_png(paeth, pixels, filter_type=4)
    t0 = time.perf_counter()
    read_png(paeth)
    decode["cached 192x640 if Paeth-filtered"] = round((time.perf_counter() - t0) * 1e3, 1)
    plan = [list(range(i, i + 4)) for i in range(0, len(cached) - 3, 4)] * 3
    t0 = time.perf_counter()
    n = sum(1 for _ in ThreadedLoader(cached, plan, num_workers=4))
    batch_ms = (time.perf_counter() - t0) * 1e3 / n
    ms = {"raw_item": float(np.median(raw_ms)), "cached_item": float(np.median(cached_ms)), "batch_of_4": batch_ms}
    print(f"phase 10a loader (host): an item of 8 views at 192x640 with its labels, raw (2 perspective reads and "
          f"resizes, 2 fisheye reads and MEI resamples a timestep) {json.dumps([round(t, 1) for t in raw_ms])} ms, "
          f"through the cache {json.dumps([round(t, 1) for t in cached_ms])} ms; a batch of 4 through the cache by "
          f"ThreadedLoader (4 threads, {n} batches) {batch_ms:.1f} ms; the cached items against the raw ones: max abs "
          f"difference {worst:.3e} (bound {KITTI_CACHE_TOL:.3e}, one 8-bit step in [-1, 1]); one PNG's decode, host "
          f"ms: {json.dumps(decode)}", flush=True)
    if not worst <= KITTI_CACHE_TOL:
        fail("an item read through the cache differs from the same item resampled on the fly")
    return root, ms


def phase_kitti_stage1(root, scratch):
    """Phase 10b: cli.train.main on configs/train_scenedino_kitti_360.yaml at
    full width on the tree. Returns (its launches, its run directory, each
    step's host and loader-wait ms)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_s1_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=KITTI_STEPS, checkpoint_every=KITTI_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = KITTI_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": KITTI_VAL_ITEMS}
    cfg_dir = tempfile.mkdtemp(prefix="kitti_s1_config_", dir=scratch)
    path = save_run_config(cfg_dir, conf)
    model_conf = trainer.configs_from_dict(conf)[0]
    enc = model_conf["encoder"]
    print(f"phase 10b stage 1: cli.train.main --config configs/train_scenedino_kitti_360.yaml at full width "
          f"({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, d_hidden "
          f"{model_conf['decoder_heads'][0]['args']['d_hidden']}, with_amp {conf['with_amp']}, {enc['image_size']}, "
          f"batch {conf['batch_size']}, 8 views, fisheye offsets 10-40, is_preprocessed); cuts: data_path, pose_path "
          f"and split_path -> the seeded tree, stop_iteration {KITTI_STEPS}, validation every 5000 -> {KITTI_STEPS} "
          f"over test items 0-{KITTI_VAL_ITEMS - 1} (file: 0-127), checkpoint_every 10000 -> {KITTI_STEPS}, "
          f"log_every 1, output into {out}", flush=True)
    records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 10b step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host ms: waiting on the loader "
              f"{r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 10b validation at {r.iteration} ({r.ms:.1f} ms, the velodyne depths): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    remat = depth if enc.get("grad_checkpointing") else 0
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": KITTI_STEPS * (2 * depth + remat) + len(vals) * KITTI_VAL_ITEMS * 2 * depth,
              "attention_bwd_dq": KITTI_STEPS * depth, "attention_bwd_dkv": KITTI_STEPS * depth}
    ckpt = os.path.join(out, f"training_checkpoint_{KITTI_STEPS}.pt")
    print(f"phase 10b run: {len(steps)} steps in {wall:.1f} s wall (model build, data, steps, validation, checkpoints);"
          f" peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: a "
          f"step the student's and the teacher's 12 blocks and the backward's 12, a validation item 12 + 12); "
          f"{os.path.basename(ckpt)} written: {os.path.exists(ckpt)}", flush=True)
    if (len(steps) != KITTI_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0):
        fail("the KITTI-360 stage-1 run did not take its steps finite and applied")
    if len(vals) != 1 or not _finite(vals[0].metrics.values()) or "dino_cos_sim" not in vals[0].metrics or not any(
            k.startswith("depth_") for k in vals[0].metrics):
        fail("the KITTI-360 stage-1 validation is missing a depth or dino metric, or one is not finite")
    if counts != expect:
        fail(f"the KITTI-360 stage-1 run launched {counts}, expected {expect}")
    if not os.path.exists(ckpt):
        fail(f"{ckpt} was not written")
    return counts, out, [(r.step_ms, r.data_ms) for r in steps]


def phase_kitti_stage2(root, stage1_dir, scratch):
    """Phase 10c: cli.train.main --stage semantic on
    configs/train_semantic_kitti_360.yaml from phase 10b's run. Returns
    (its launches, its run directory)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_semantic_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_s2_", dir=scratch)
    conf["output"]["path"] = out
    conf["resume_from"] = stage1_dir
    conf["training"].update(stop_iteration=KITTI_STEPS, checkpoint_every=KITTI_STEPS, log_every=1, num_epochs=10)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = KITTI_STEPS
    vconf["subset"] = {"type": "range", "args": {"start": 0, "end": KITTI_VAL_ITEMS}}
    path = save_run_config(tempfile.mkdtemp(prefix="kitti_s2_config_", dir=scratch), conf)
    d = conf["downstream"]
    print(f"phase 10c stage 2: cli.train.main --stage semantic --config configs/train_semantic_kitti_360.yaml "
          f"(its model: ViT-B/8, DPT 256, with_amp {conf['with_amp']}; downstream {d['n_classes']} clusters, "
          f"buffer {d['buffer_size']}, {d['patch_sample_size']} samples a crop; batch {conf['batch_size']}, "
          f"num_workers {conf['num_workers']}); cuts: the data paths -> the seeded tree, resume_from phase 10b's run, "
          f"num_epochs 1 -> 10 (4 training items are one step an epoch), stop_iteration {KITTI_STEPS}, validation "
          f"every 100 -> {KITTI_STEPS} over test items 0-{KITTI_VAL_ITEMS - 1} (file: a random 32), "
          f"checkpoint_every 5000 -> {KITTI_STEPS}, log_every 250 -> 1; the labels read as train ids", flush=True)
    captured, run_stage2 = [], cli.run_stage2

    def keep(config, device=None):  # the run's field and head, as main's call of run_stage2 returns them
        captured.append(run_stage2(config, device=device))
        return captured[-1]

    cli.run_stage2 = keep
    try:
        records, counts, peak, wall = _logged(lambda: cli.main(["--config", path, "--stage", "semantic"]),
                                              ("training", "validation"))
    finally:
        cli.run_stage2 = run_stage2
    field, head, _ = captured[0]
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 10c step {r.iteration}: {json.dumps({k: round(float(v), 6) for k, v in r.losses.items()})}; "
              f"host ms: waiting on the loader {r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    seg = {}
    for r in vals:
        seg = {k: float(v) for k, v in r.metrics.items() if k.endswith(("_miou", "_acc"))}
        print(f"phase 10c validation at {r.iteration} ({r.ms:.1f} ms, the tree's labels): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    renders = KITTI_STEPS + 1 + len(vals) * KITTI_VAL_ITEMS
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": renders * depth, "encode_view": renders}
    # the head moved from its draw, and the field is phase 10b's, bit for bit
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig

    init = SemanticHead(SemanticHeadConfig.from_dict(d), generator=torch.Generator().manual_seed(conf["seed"]))
    moved = {k: not torch.equal(v.cpu(), init.state_dict()[k]) for k, v in head.state_dict().items()
             if v.is_floating_point()}
    frozen = torch.load(cli.find_latest_checkpoint(stage1_dir), map_location="cuda", weights_only=True)["field"]
    unchanged = _state_equal(field.state_dict(), frozen)
    del field, head, captured
    print(f"phase 10c run: {len(steps)} steps in {wall:.1f} s wall; peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: each step, the seeding and each validation item "
          f"encode one view and render it through K6); head tensors moved {sum(moved.values())} of {len(moved)}; "
          f"the field after the run bitwise equal to phase 10b's checkpoint: {unchanged}", flush=True)
    if (len(steps) != KITTI_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses.get("nonfinite_total", 0) != 0):
        fail("the KITTI-360 stage-2 run did not take its steps finite and applied")
    if len(vals) != 1 or not seg or not _in_unit(seg.values()):
        fail(f"the KITTI-360 stage-2 validation's seg metrics are missing or leave [0, 1]: {seg}")
    if counts != expect:
        fail(f"the KITTI-360 stage-2 run launched {counts}, expected {expect}")
    if not all(moved.values()) or not unchanged:
        fail("the KITTI-360 stage 2 left a head tensor unchanged or changed the field")
    return counts, out


def phase_kitti_eval(root, stage2_dir, scratch, device="cuda"):
    """Phase 10d: cli.evaluate.main on configs/evaluate_semantic_kitti_360.yaml
    with phase 10c's model, precision and downstream blocks, over the
    tree's test items; K6 on the first frame against its plain version.
    Returns (its launches, K6's error)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli
    from scenedino_torch.kernels.encode_view import encode_view_plain
    from scenedino_torch.ops import fast_field
    from scenedino_torch.tools.bench_encode_view import TOL
    from scenedino_torch.utils.config import load, load_run_config, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "evaluate_semantic_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    run = load_run_config(stage2_dir)
    conf.pop("variant", None)
    conf["model"], conf["with_amp"] = copy.deepcopy(run["model"]), run.get("with_amp", False)
    conf["downstream"] = {**conf.get("downstream", {}), **copy.deepcopy(run["downstream"])}
    conf_dir = tempfile.mkdtemp(prefix="kitti_eval_config_", dir=scratch)
    save_run_config(conf_dir, conf)
    with first_call(fast_field, "encode_view") as k6_calls:
        out, counts, frames, peak, wall = _run_logged(cli.main, ["--config", conf_dir, "--ckpt", stage2_dir,
                                                                  "--device", device])
    n = len(KITTI_TEST_IDS)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": n * 12, "encode_view": n}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    args = k6_calls[0]
    k6, ref = kernels.encode_view(*args), encode_view_plain(*args)
    tol = TOL[torch.float32]
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), k6, ref)}
    print(f"phase 10d evaluation: cli.evaluate.main, configs/evaluate_semantic_kitti_360.yaml (raw frames, fisheye "
          f"offset 10) with phase 10c's model, with_amp and downstream blocks, the tree's {n} test items (8 views, "
          f"view 0 encoded), labels as train ids: {json.dumps(summary)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in ('read_ms', 'frame_ms')} for r in frames])}; "
          f"{wall:.1f} s wall; peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: 12 "
          f"K1 and one K6 a frame); K6 on the first frame against its plain version: {json.dumps(errs)} (bounds "
          f"{json.dumps(tol)})", flush=True)
    if out["n_frames"] != n or len(summary) != 4 or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the KITTI-360 evaluation is not {n} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the KITTI-360 evaluation launched {counts}, expected {expect}")
    if not all(errs[k] <= tol[k] for k in tol):
        fail("K6 disagrees with its plain version on the KITTI-360 evaluation frame")
    return counts, max(errs.values())


def phase_kitti_layouts(root):
    """Phase 10e (host): KITTI_360_v2 items (the overlap sampling) and
    SSCBench items with the fisheye views on the same tree."""
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.datasets.kitti_360 import estimate_frustum_overlap
    from scenedino_torch.datasets.sscbench import SSCBenchDataset

    from scenedino_torch.utils.config import load

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360.yaml"))["dataset"]
    conf.update(type="KITTI_360_v2", data_path=root, pose_path=os.path.join(root, "data_poses"), data_fc=4,
                split_path=None, data_segmentation=False)
    train, _ = make_datasets(conf)
    overlaps, shapes, ok = [], [], True
    for i in (0, 41):
        train._rng_local.rng = np.random.RandomState(i)
        t0 = time.perf_counter()
        item = train[2 * i]
        ms = (time.perf_counter() - t0) * 1e3
        ok &= item["imgs"].shape == (4, 3, H, W) and all(np.isfinite(item[k]).all() for k in ("imgs", "poses"))
        overlaps.append([round(estimate_frustum_overlap(item["projs"][v], item["poses"][v], item["projs"][0],
                                                        item["poses"][0]), 4) for v in range(1, 4)])
        shapes.append((list(item["imgs"].shape), [int(t) for t in item["ts"]], round(ms, 1)))
    ssc = SSCBenchDataset(data_path=root, sequences=(KITTI_SEQ,), load_fisheye=True)
    for i in (50,):
        item = ssc[i]
        ok &= item["imgs"].shape == (3, 3, H, W) and all(np.isfinite(item[k]).all() for k in ("imgs", "poses"))
        shapes.append(list(item["imgs"].shape))
    print(f"phase 10e layouts (host): type KITTI_360_v2 ({len(train)} datapoints of the full split), 2 items of 4 "
          f"frames through the cache (shape, timesteps, ms): {shapes[:2]}, each frame's overlap with the encoder "
          f"camera {overlaps}; SSCBenchDataset(load_fisheye=True) item 50 (raw fisheyes): {shapes[2:]}; shapes and "
          f"finite values: {ok}",
          flush=True)
    if not ok:
        fail("a KITTI_360_v2 or SSCBench fisheye item has the wrong shape or a non-finite value")


def phase_kitti(seed, scratch):
    """Phase 10: the KITTI-360 data path (10a-10e). Returns the launches of
    10b, 10c and 10d together, K1 at the forward shapes they gave it that
    phase 2 does not time, and the tree's root (phase 11c reads it)."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    root, loader_ms = phase_kitti_tree(seed, scratch)
    with k1_batches() as seen:
        s1_counts, s1_dir, step_ms = phase_kitti_stage1(root, scratch)
        s2_counts, s2_dir = phase_kitti_stage2(root, s1_dir, scratch)
        ev_counts, _ = phase_kitti_eval(root, s2_dir, scratch)
    phase_kitti_layouts(root)
    # K1 at the forward shapes phase 2 does not time: 8 views give the teacher 16 frames a step
    gen = torch.Generator(device="cuda").manual_seed(seed + 110)
    new_shapes = [k1_forward_shape(gen, B, lse, "KITTI-360 path", "phase 10") for B, lse in sorted(seen)
                  if (B, lse) not in K1_PHASE2_SHAPES]
    wait = [round(d / (s + d), 3) for s, d in step_ms]
    print(f"phase 10 loader against the step: an item {loader_ms['cached_item']:.1f} ms through the cache "
          f"({loader_ms['raw_item']:.1f} ms raw), a batch of 4 {loader_ms['batch_of_4']:.1f} ms; stage-1 steps' host "
          f"ms {[round(s, 1) for s, _ in step_ms]} after loader waits of {[round(d, 1) for _, d in step_ms]}: the "
          f"wait's share of each step's wall {wait}; {card_line()}; "
          f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: s1_counts[k] + s2_counts[k] + ev_counts[k] for k in s1_counts}, new_shapes, root


def ratio_text(part, whole):
    """The text " take x of it" for two device times; nothing where one is missing."""
    return "" if part is None or whole is None else f" take {part / whole:.2f} of it"


def k1_d80_shape(gen, B, N, Hh):
    """Phase 11a at one shape (B, N, Hh, 80) bf16: the forward without and
    with the log-sum-exp, dq and dkv against the plain versions, two
    launches bitwise equal; kernel, plain, SDPA and bound times, and the
    kernels' and SDPA's device times (the profiler)."""
    from scenedino_torch.kernels.attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_fwd,
        attention_lse_plain,
        attention_plain,
    )
    from scenedino_torch.utils.timing import device_ms, ms_text, time_ms

    D = 80
    shape = (B, N, Hh, D)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    out = attention_fwd(q, k, v)[0]
    out_l, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, out_l, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = (attention_fwd(q, k, v)[0], attention_bwd_dq(q, k, v, out_l, do, lse)[0],
             *attention_bwd_dkv(q, k, v, do, lse, di))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, dq, dk, dv), again)) or not torch.equal(out, out_l):
        fail(f"K1 at D = 80 {shape}: two launches on the same inputs differ")
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
    if not (torch.isfinite(out).all() and err <= K1_TOL and lse_err <= K1_LSE_TOL):
        fail(f"K1 forward at D = 80 {shape} disagrees with its plain version: max abs err {err} (bound {K1_TOL}), "
             f"lse {lse_err} (bound {K1_LSE_TOL})")
    errs, bounds = [], []
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), attention_bwd_plain(q, k, v, out_l, do, lse)):
        errs.append((got.float() - r.float()).abs().max().item())
        bounds.append(K1_BWD_REL * r.float().abs().max().item() + 1e-3)
        if not (torch.isfinite(got).all() and errs[-1] <= bounds[-1]):
            fail(f"K1 backward {name} at D = 80 {shape} disagrees with the plain backward: max abs err "
                 f"{errs[-1]} > {bounds[-1]}")
    ms = time_ms(lambda: attention_fwd(q, k, v), inner=10)
    ms_lse = time_ms(lambda: attention_fwd(q, k, v, with_lse=True), inner=10)
    ms_dq = time_ms(lambda: attention_bwd_dq(q, k, v, out_l, do, lse), inner=10)
    ms_dkv = time_ms(lambda: attention_bwd_dkv(q, k, v, do, lse, di), inner=10)
    plain_ms = time_ms(lambda: attention_plain(q, k, v), reps=5)
    plain_bwd_ms = time_ms(lambda: attention_bwd_plain(q, k, v, out_l, do, lse), reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    # the forwards' kernels alone (torch.profiler): at one image SDPA's CUDA-event time is its host's
    dev_ms = device_ms(lambda: attention_fwd(q, k, v))
    lib_dev_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), inner=10)
    # the same call's kernels alone (torch.profiler): a small backward's CUDA-event time is the host's autograd
    lib_bwd_dev_ms = device_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True))
    bwd_dev_ms = device_ms(lambda: (attention_bwd_dq(q, k, v, out_l, do, lse),
                                    attention_bwd_dkv(q, k, v, do, lse, di)))
    unit = 2.0 * B * Hh * N * N * D  # one N x N x D product
    t_bytes, s_bytes = B * N * Hh * D * 2, B * Hh * N * 4
    b_fwd, by_fwd = bound_ms(2 * unit, 4 * t_bytes)  # q k v out
    b_lse, by_lse = bound_ms(2 * unit, 4 * t_bytes + s_bytes)
    b_dq, by_dq = bound_ms(3 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v o dO dq; lse, di
    b_dkv, by_dkv = bound_ms(4 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v dO dk dv; lse, di
    b_bwd, by_bwd = bound_ms(5 * unit, 8 * t_bytes + s_bytes)
    print(f"phase 11a K1 at D = 80 {shape} bf16: max_abs_err forward {err:.3e} (bound {K1_TOL}), lse {lse_err:.3e} "
          f"(bound {K1_LSE_TOL}), dq {errs[0]:.3e} (bound {bounds[0]:.3e}), dk {errs[1]:.3e} (bound "
          f"{bounds[1]:.3e}), dv {errs[2]:.3e} (bound {bounds[2]:.3e}); two launches bitwise equal; kernel forward "
          f"{ms:.4f} ms, with the lse {ms_lse:.4f} ms ({2 * unit / ms_lse / 1e9:.1f} TFLOP/s), dq {ms_dq:.4f} ms, "
          f"dkv {ms_dkv:.4f} ms ({7 * unit / (ms_dq + ms_dkv) / 1e9:.1f} TFLOP/s over their 7 products); plain "
          f"forward {plain_ms:.4f} ms, backward {plain_bwd_ms:.4f} ms; sdpa forward {lib_ms:.4f} ms (the kernel "
          f"takes {ms / lib_ms:.2f} of it), its kernels' device time {ms_text(lib_dev_ms)} (the forward's "
          f"{ms_text(dev_ms)}{ratio_text(dev_ms, lib_dev_ms)}), backward {lib_bwd_ms:.4f} ms (dq + dkv take "
          f"{(ms_dq + ms_dkv) / lib_bwd_ms:.2f} of it), its kernels' device time {ms_text(lib_bwd_dev_ms)} (dq + dkv's "
          f"{ms_text(bwd_dev_ms)}{ratio_text(bwd_dev_ms, lib_bwd_dev_ms)}); bound forward {b_fwd:.4f} ms ({by_fwd}), "
          f"with the lse {b_lse:.4f} ms ({by_lse}), dq {b_dq:.4f} ms ({by_dq}), dkv {b_dkv:.4f} ms ({by_dkv}), the "
          f"whole backward at 10 N^2 D B H FLOP {b_bwd:.4f} ms ({by_bwd})", flush=True)
    return {"shape": list(shape), "max_abs_err": err, "lse_err": lse_err, "bwd_errs": errs, "ms": ms,
            "ms_lse": ms_lse, "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms,
            "library_ms": lib_ms, "device_ms": dev_ms, "library_device_ms": lib_dev_ms, "library_bwd_ms": lib_bwd_ms,
            "library_bwd_device_ms": lib_bwd_dev_ms, "bwd_device_ms": bwd_dev_ms, "bound_ms": b_fwd, "bound_by": by_fwd,
            "bound_dq_ms": b_dq, "bound_dq_by": by_dq, "bound_dkv_ms": b_dkv, "bound_dkv_by": by_dkv}


def _scaled_keys(B, N, Hh, D, seed):
    """q, k, v of (B, N, Hh, D) bf16 from `seed`, key row n scaled by 1 + 4 n / N."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, N, Hh, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    ramp = torch.arange(N, device="cuda", dtype=torch.float32)[None, :, None, None] / N
    return q, (k.float() * (1 + 4 * ramp)).to(torch.bfloat16), v


def _scaled_errors(q, k, v):
    """The K1 forward (at q's head dim) and SDPA against the fp32 plain
    version rounded to bf16 (`attention_plain`, the card test's yardstick)
    and unrounded; the rounding's own error; the largest |out|."""
    from scenedino_torch.kernels.attention import attention_fwd, attention_plain

    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * q.shape[-1] ** -0.5
    fp32 = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.float())
    plain = attention_plain(q, k, v).float()
    kernel = attention_fwd(q, k, v)[0].float()
    sdpa = torch.nn.functional.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    sdpa = sdpa.transpose(1, 2).float()
    return {"kernel": (kernel - plain).abs().max().item(), "sdpa": (sdpa - plain).abs().max().item(),
            "kernel_fp32": (kernel - fp32).abs().max().item(), "sdpa_fp32": (sdpa - fp32).abs().max().item(),
            "plain_fp32": (plain - fp32).abs().max().item(), "max_out": fp32.abs().max().item()}


def phase_scaled_keys():
    """Phase 11a, ROADMAP queue 3 item A: the card test's scaled-keys input
    through the D = 80 forward, SDPA, the D = 64 forward on the same
    construction at D = 64, and the fp32 plain version; the D = 80 forward
    held at K1_TOL against `attention_plain` there. Then the same
    construction at other seeds and shapes, printed (the record of where
    each implementation lands: one bf16 step at |out| >= 4 is 3.125e-2)."""
    B, N, Hh = SCALED_KEYS
    at = {D: _scaled_errors(*_scaled_keys(B, N, Hh, D, 200 + N)) for D in (80, 64)}
    print(f"phase 11a scaled keys ({B}, {N}, {Hh}, D) bf16, key row n x (1 + 4 n / N), seed {200 + N}: D = 80 "
          f"forward {at[80]['kernel']:.4e} against the plain version rounded to bf16 (bound {K1_TOL}), SDPA "
          f"{at[80]['sdpa']:.4e}, the D = 64 forward on the same construction {at[64]['kernel']:.4e} (SDPA "
          f"{at[64]['sdpa']:.4e}); against the fp32 plain version unrounded: D = 80 forward "
          f"{at[80]['kernel_fp32']:.4e}, SDPA {at[80]['sdpa_fp32']:.4e}, D = 64 forward {at[64]['kernel_fp32']:.4e}, "
          f"the bf16 rounding itself {at[80]['plain_fp32']:.4e}; largest |out| {at[80]['max_out']:.3f}", flush=True)
    if not at[80]["kernel"] <= K1_TOL:
        fail(f"the D = 80 forward on scaled keys reads {at[80]['kernel']} against its plain version (bound {K1_TOL})")
    sweep = {}
    for D in (80, 64):
        for b, n, h in SCALED_SWEEP:
            errs = [_scaled_errors(*_scaled_keys(b, n, h, D, seed)) for seed in (200 + n,) + SCALED_SEEDS]
            sweep[f"D{D} ({b}, {n}, {h})"] = [[round(e["kernel"], 6), round(e["sdpa"], 6)] for e in errs]
    print(f"phase 11a scaled keys at seeds {[200] + list(SCALED_SEEDS)} (the first 200 + N), [forward, SDPA] "
          f"against the plain version rounded to bf16, not gated: {json.dumps(sweep)}", flush=True)


def phase_d80_kernels(gen):
    """Phase 11a: the three D = 80 kernels at `D80_SHAPES`, and the scaled
    keys; their entries timed at the D = 80 training step's student (2, 1921,
    12, 80), where the card's time is the kernels' and not the host's."""
    shapes = [k1_d80_shape(gen, *shape) for shape in D80_SHAPES]
    phase_scaled_keys()
    fwd = bwd = shapes[-1]
    route = {"route": "cuda", "shapes": shapes}
    bwd_source = {"source": "scenedino_torch/csrc/attention_d80_bwd.cu", **route}
    return [
        {"name": "attention_d80", "replaces": "scenedino_tpu/models/vit.py:126",
         "max_abs_err": max(e["max_abs_err"] for e in shapes),
         **{key: fwd[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "source": "scenedino_torch/csrc/attention_d80.cu", **route},
        {"name": "attention_d80_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "max_abs_err": max(e["bwd_errs"][0] for e in shapes), "ms": bwd["ms_dq"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["bound_dq_ms"], "bound_by": bwd["bound_dq_by"], "library_ms": bwd["library_bwd_ms"],
         **bwd_source},
        {"name": "attention_d80_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "max_abs_err": max(max(e["bwd_errs"][1:]) for e in shapes), "ms": bwd["ms_dkv"],
         "plain_ms": bwd["plain_bwd_ms"], "bound_ms": bwd["bound_dkv_ms"], "bound_by": bwd["bound_dkv_by"],
         "library_ms": bwd["library_bwd_ms"], **bwd_source},
    ]


def ijepa_reference_weights(gen, depth):
    """Seeded I-JEPA-H/14 weights in the published checkpoint's layout
    ("module." + timm names, a 16 x 16 position embedding, no class token,
    the predictor's head keys that the import drops), on the card: matrices
    and kernels ~ N(0, 1/fan_in), norm weights 1, biases and the position
    embedding ~ N(0, 0.02^2)."""
    from scenedino_torch.models.vit import VIT_PRESETS

    cfg = VIT_PRESETS["i_jepa_huge"]
    dim, p = cfg.width, cfg.patch_size

    def randn(*shape, scale):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    raw = {"patch_embed.proj.weight": randn(dim, 3, p, p, scale=(3 * p * p) ** -0.5),
           "patch_embed.proj.bias": randn(dim, scale=0.02), "pos_embed": randn(1, 256, dim, scale=0.02),
           "norm.weight": torch.ones(dim, device="cuda"), "norm.bias": randn(dim, scale=0.02),
           "fc.weight": randn(2, dim, scale=0.02)}
    for i in range(depth):
        for name, shape in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            raw[f"blocks.{i}.{name}.weight"] = randn(*shape, scale=shape[1] ** -0.5)
            raw[f"blocks.{i}.{name}.bias"] = randn(shape[0], scale=0.02)
        for name in ("norm1", "norm2"):
            raw[f"blocks.{i}.{name}.weight"] = torch.ones(dim, device="cuda")
            raw[f"blocks.{i}.{name}.bias"] = randn(dim, scale=0.02)
    return {f"module.{k}": v for k, v in raw.items()}


def phase_ijepa(seed):
    """Phase 11b, first part: the I-JEPA-H/14 backbone at 192x640 in bf16.
    Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.encoder import normalize_input
    from scenedino_torch.models.vit import VIT_PRESETS, make_vit
    from scenedino_torch.utils.convert import convert_ssl_vit
    from scenedino_torch.utils.timing import profile_device, time_ms

    cfg = VIT_PRESETS["i_jepa_huge"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 111)
    t0 = time.perf_counter()
    state = convert_ssl_vit("i_jepa_huge", ijepa_reference_weights(gen, cfg.depth))
    model = make_vit("i_jepa_huge", dtype=torch.bfloat16).to("cuda").eval()
    model.load_state_dict(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = normalize_input(torch.rand(1, 3, H, W, generator=gen, device="cuda") * 2 - 1)
    with torch.inference_mode():
        kernels.reset_launches()
        out = model(x)
        torch.cuda.synchronize()
        counts = kernels.launches()
        ms = time_ms(lambda: model(x), reps=5)
        profiled = profile_device(lambda: model(x))  # the host's share of that time
    feats = out["features_normalized"]
    n_tokens = (H // cfg.patch_size) * (W // cfg.patch_size)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention_d80": cfg.depth}
    print(f"phase 11b I-JEPA-H/14 ({cfg.depth} blocks, width {cfg.width}, {cfg.num_heads} heads of "
          f"{cfg.width // cfg.num_heads}, patch {cfg.patch_size}, no class token; {sum(v.numel() for v in state.values())} "
          f"parameters) from seeded weights in the reference's layout through convert_ssl_vit in {load_s:.1f} s; the "
          f"192x640 forward in bf16: {n_tokens} tokens, features {tuple(feats.shape)}, {ms:.2f} ms a forward "
          f"(CUDA events); one forward profiled: {profiled}; launches {json.dumps(counts)}", flush=True)
    if tuple(feats.shape) != (1, n_tokens, cfg.width) or not torch.isfinite(feats).all():
        fail(f"the I-JEPA-H/14 forward gave {tuple(feats.shape)} or non-finite features")
    if counts != expect:
        fail(f"the I-JEPA-H/14 forward launched {counts}, expected {expect}")

    # its first blocks at 196x518 (518 tokens: the card takes K1) against the same bf16 ViT on the CPU
    depth = IJEPA_CHECK_DEPTH
    small = {k: v for k, v in state.items() if not (k.startswith("blocks.") and int(k.split(".")[1]) >= depth)}
    cut = make_vit("i_jepa_huge", intermediate_layers=(0,), dtype=torch.bfloat16, overrides={"depth": depth})
    cut.load_state_dict(small)
    xs = normalize_input(torch.rand(1, 3, *IJEPA_CHECK_SIZE, generator=gen, device="cuda") * 2 - 1)
    with torch.inference_mode():
        kernels.reset_launches()
        gpu = cut.to("cuda")(xs)["features_normalized"].float().cpu()
        torch.cuda.synchronize()
        small_counts = kernels.launches()
        cpu = cut.cpu()(xs.cpu())["features_normalized"].float()
    cos = torch.nn.functional.cosine_similarity(gpu, cpu, dim=-1).min().item()
    err = (gpu - cpu).abs().max().item()
    print(f"phase 11b I-JEPA-H/14's first {depth} blocks at {IJEPA_CHECK_SIZE[0]}x{IJEPA_CHECK_SIZE[1]} "
          f"({gpu.shape[1]} tokens), GPU (kernels: {small_counts['attention_d80']} D = 80 launches) against the "
          f"CPU (plain), both bf16: least token cosine {cos:.6f} (bound {SLICE_COS}), max abs err {err:.3e}",
          flush=True)
    if small_counts["attention_d80"] != depth or not cos >= SLICE_COS:
        fail("the I-JEPA-H/14 check at 196x518 did not run through the D = 80 kernel or disagrees with the CPU")
    return counts


def phase_train_d80(seed):
    """Phase 11b, second part: the flagship stage-1 step with heads of 80
    (vit_overrides width 960, 12 heads) through trainer.make_train_step.
    Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer

    conf = copy.deepcopy(SCENEDINO_KITTI_360_TRAIN)
    conf["model"]["encoder"]["vit_overrides"] = {"width": D80_TRAIN_WIDTH, "num_heads": 12}
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    gen = torch.Generator(device="cuda").manual_seed(seed + 112)
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    B, depth = D80_TRAIN_B, model.encoder.vit_encoder.vit.cfg.depth
    state = trainer.init_train_state(model, tcfg, artifact_shape=(D80_TRAIN_WIDTH, H // 8, W // 8), generator=gen)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(gen, B, H, W, "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    kernels.reset_launches()
    losses, ms = [], []
    for _ in range(D80_TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(state, batch, trainer.draw_stage1(gen, tcfg, rcfg, B, 4, H, W, 8))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["rec_loss"]))
    counts = kernels.launches()
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters() if n in before)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention_d80": D80_TRAIN_STEPS * 2 * depth,
              "attention_d80_bwd_dq": D80_TRAIN_STEPS * depth, "attention_d80_bwd_dkv": D80_TRAIN_STEPS * depth}
    print(f"phase 11b stage-1 step with heads of 80 (configs/train_scenedino_kitti_360.yaml's model, vit_overrides "
          f"width {D80_TRAIN_WIDTH}, 12 heads; bf16, 192x640, batch {B}, V = 4): losses {losses}, host ms "
          f"{[round(m, 1) for m in ms]}, {moved} of {len(before)} trainable tensors moved, applied "
          f"{state.applied}; launches {json.dumps(counts)}", flush=True)
    if not (all(np.isfinite(losses)) and state.applied == D80_TRAIN_STEPS and moved == len(before)):
        fail("the D = 80 training steps were not finite and applied, or a parameter did not move")
    if counts != expect:
        fail(f"the D = 80 training steps launched {counts}, expected {expect}")
    return counts


def phase_upsampler(seed, root, scratch):
    """Phase 11c: cli.train.main on configs/train_scenedino_kitti_360_upsampler.yaml
    on phase 10's tree. Returns (its launches, K1 at the forward shapes it
    gave that phases 2 and 10 do not time)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360_upsampler.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_up_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=UPSAMPLER_STEPS, checkpoint_every=UPSAMPLER_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = UPSAMPLER_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": UPSAMPLER_VAL_ITEMS}
    path = save_run_config(tempfile.mkdtemp(prefix="kitti_up_config_", dir=scratch), conf)
    model_conf = trainer.configs_from_dict(conf)[0]
    enc = model_conf["encoder"]
    print(f"phase 11c upsample-gt: cli.train.main --config configs/train_scenedino_kitti_360_upsampler.yaml at full "
          f"width ({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, "
          f"{enc['mode']} with the {enc['upsampler_arch']} teacher, dino_upscaled, compensate_artifacts "
          f"{model_conf['compensate_artifacts']}, with_amp {conf['with_amp']}, batch {conf['batch_size']}, 8 views); "
          f"cuts: the paths -> phase 10's tree and cache, stop_iteration {UPSAMPLER_STEPS}, validation every 5000 -> "
          f"{UPSAMPLER_STEPS} over test items 0-{UPSAMPLER_VAL_ITEMS - 1} (file: 0-127), checkpoint_every 10000 -> "
          f"{UPSAMPLER_STEPS}, log_every 1", flush=True)
    with k1_batches() as seen:
        records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 11c step {r.iteration}: loss {r.losses['rec_loss']:.6f} (dino {r.losses['loss_dino_coarse']:.6f}); "
              f"host ms: waiting on the loader {r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 11c validation at {r.iteration} ({r.ms:.1f} ms): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    # a step: the teacher's 12 blocks on all 64 views at once, the student's 12, the backward's 12;
    # a validation item: the student's 12 and the teacher's 12 on its 8 views x 4
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": UPSAMPLER_STEPS * 2 * depth + len(vals) * UPSAMPLER_VAL_ITEMS * 2 * depth,
              "attention_bwd_dq": UPSAMPLER_STEPS * depth, "attention_bwd_dkv": UPSAMPLER_STEPS * depth}
    ckpt_path = os.path.join(out, f"training_checkpoint_{UPSAMPLER_STEPS}.pt")
    fresh = make_model(model_conf, device="cuda", seed=conf.get("seed", 0), training=True)
    field = torch.load(ckpt_path, map_location="cuda", weights_only=True)["field"]
    student = [n for n, p in fresh.named_parameters() if p.requires_grad]
    still = [n for n in student if torch.equal(field[n], fresh.get_parameter(n))]
    print(f"phase 11c run: {len(steps)} steps in {wall:.1f} s wall (model build, data, steps, validation, "
          f"checkpoint); peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} (expected "
          f"{json.dumps(expect)}); K1 forward batches seen {sorted(seen)}; {len(student) - len(still)} of "
          f"{len(student)} student tensors moved", flush=True)
    if (len(steps) != UPSAMPLER_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0):
        fail("the upsample-gt run did not take its steps finite and applied")
    if len(vals) != 1 or not _finite(vals[0].metrics.values()) or "dino_cos_sim" not in vals[0].metrics:
        fail("the upsample-gt validation is missing its dino metric, or a metric is not finite")
    if still:
        fail(f"student parameters did not move in the upsample-gt run: {still[:8]}")
    if counts != expect:
        fail(f"the upsample-gt run launched {counts}, expected {expect}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 113)
    timed = {(16, False)} | set(K1_PHASE2_SHAPES)  # phases 2 and 10 time these
    shapes = [k1_forward_shape(gen, B, lse, "upsample-gt recipe", "phase 11c") for B, lse in sorted(seen)
              if (B, lse) not in timed]
    return counts, shapes


def phase_d80_and_upsample_gt(seed, root, scratch):
    """Phase 11b and 11c (11a ran with the other kernel phases). Returns
    their launches together and K1 at the upsample-gt recipe's new shapes."""
    from scenedino_torch.utils.timing import card_line

    t0 = time.perf_counter()
    ijepa = phase_ijepa(seed)
    train = phase_train_d80(seed)
    up, shapes = phase_upsampler(seed, root, scratch)
    print(f"phase 11 wall time (11b and 11c) {time.perf_counter() - t0:.1f} s; {card_line()}", flush=True)
    return {k: ijepa[k] + train[k] + up[k] for k in ijepa}, shapes


def _re10k_frame(seq, row):
    """Frame `row` of sequence `seq`: phase 10's low-frequency field moved
    along x, a finer pattern and noise (sigma 4), so that its coefficients
    are not all zero (uint8, 360x640x3)."""
    base = _texture(1200 + seq, RE10K_FRAME, 3.0 * row).astype(np.float32)
    y, x = np.mgrid[0:RE10K_FRAME[0], 0:RE10K_FRAME[1]].astype(np.float32)
    detail = 25 * np.sin((x + 3.0 * row) / 3.1 + 4 * np.sin(y / 17.0))[..., None] * np.array([1.0, 0.8, 0.6])
    noise = np.random.default_rng(1300 + 97 * seq + row).normal(0, 4, base.shape)
    return np.clip(base + detail + noise, 0, 255).astype(np.uint8)


def write_re10k_tree(root, seed):
    """A RealEstate10K tree in the release's layout: `train/<seq>.txt` camera
    files (a URL line, then per row the microsecond timestamp, fx fy cx cy in
    units of the frame, two zeros and the 3x4 world-to-camera pose of a
    camera walking forward and turning slowly), through `cli.process_re10k
    process` into `train.pickle`; `frames_720/train/<seq>/<ms>.jpg` for the
    rows the loader's ::10 subsample reads, written by `image_io.write_jpeg`.
    Returns (the pickle's path, the frames written, the least PSNR of their
    decode against the pixels written, write ms and decode ms per frame)."""
    from scenedino_torch.cli import process_re10k
    from scenedino_torch.datasets.image_io import read_jpeg, write_jpeg

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train"))
    psnr, write_ms, decode_ms, n = [], [], [], 0
    for s in range(RE10K_SEQS):
        name = f"{seed:08x}{s:08x}"
        ts = 1_000_000 * (s + 1) + np.arange(RE10K_ROWS, dtype=np.int64) * 33_367
        lines = [f"https://www.youtube.com/watch?v=seq{s}"]
        for i, t in enumerate(ts):
            a = 0.003 * i + 0.2 * s
            c2w = np.eye(4)
            c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
            c2w[:3, 3] = [0.01 * i, 0.002 * rng.standard_normal(), 0.04 * i]
            w2c = np.linalg.inv(c2w)[:3]
            intr = [0.5, 0.5 * RE10K_FRAME[1] / RE10K_FRAME[0], 0.5, 0.5, 0.0, 0.0]
            lines.append(" ".join([str(int(t))] + [f"{v:.9f}" for v in intr + w2c.reshape(-1).tolist()]))
        with open(os.path.join(root, "train", f"{name}.txt"), "w") as f:
            f.write("\n".join(lines))
        frames = os.path.join(root, "frames_720", "train", name)
        os.makedirs(frames)
        for i in range(0, RE10K_ROWS, 10):
            img = _re10k_frame(s, i)
            path = os.path.join(frames, f"{int(ts[i]) // 1000}.jpg")
            t0 = time.perf_counter()
            write_jpeg(path, img, quality=RE10K_QUALITY)
            t1 = time.perf_counter()
            back = read_jpeg(path)
            decode_ms.append((time.perf_counter() - t1) * 1e3)
            write_ms.append((t1 - t0) * 1e3)
            psnr.append(10 * np.log10(255.0 ** 2 / np.mean((back.astype(np.float64) - img) ** 2)))
            n += 1
    process_re10k.main(["process", "-m", "train", "-d", root])
    return os.path.join(root, "train.pickle"), n, min(psnr), write_ms, decode_ms


def phase_re10k_tree(seed, scratch):
    """Phase 12a: the tree, the decode's fidelity, and the loader's host ms
    (a frame's decode and resize, an item, a batch of 4). Returns (the
    pickle's path, the loader's ms)."""
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.datasets.image_io import read_jpeg, resize_area
    from scenedino_torch.datasets.re10k import center_crop_to_aspect
    from scenedino_torch.utils.config import load
    from scenedino_torch.utils.prefetch import ThreadedLoader

    root = tempfile.mkdtemp(prefix="re10k_", dir=scratch)
    t0 = time.perf_counter()
    data_path, n, psnr, write_ms, decode_ms = write_re10k_tree(root, seed + 120)
    tree_s = time.perf_counter() - t0
    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_re10k.yaml"))["dataset"]
    conf["data_path"] = data_path
    train, test = make_datasets(conf)
    h, w = conf["image_size"]
    frames = os.path.join(root, "frames_720", "train")
    seq_dir = os.path.join(frames, sorted(os.listdir(frames))[0])
    img = read_jpeg(os.path.join(seq_dir, sorted(os.listdir(seq_dir))[0])).astype(np.float32) / 255.0
    crop = center_crop_to_aspect(img, w / h)[0]
    resize_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        resize_area(crop, (h, w))
        resize_ms.append((time.perf_counter() - t0) * 1e3)
    item_ms = []
    for i in range(4):
        t0 = time.perf_counter()
        item = train[i]
        item_ms.append((time.perf_counter() - t0) * 1e3)
    ok = item["imgs"].shape == (conf["data_fc"], 3, h, w) and all(np.isfinite(item[k]).all() for k in item)
    plan = [list(range(i, i + 4)) for i in range(0, len(train) - 3, 4)]
    t0 = time.perf_counter()
    nb = sum(1 for _ in ThreadedLoader(train, plan, num_workers=4))
    batch_ms = (time.perf_counter() - t0) * 1e3 / nb
    ms = {"decode": float(np.median(decode_ms)), "resize": float(np.median(resize_ms)),
          "item": float(np.median(item_ms)), "batch_of_4": batch_ms}
    print(f"phase 12a tree: {RE10K_SEQS} sequences of {RE10K_ROWS} camera rows (train/<seq>.txt) through "
          f"cli.process_re10k process into train.pickle, {n} frames at {RE10K_FRAME[1]}x{RE10K_FRAME[0]} (the rows "
          f"the ::10 subsample reads) as baseline 4:2:0 JPEGs by image_io.write_jpeg at quality {RE10K_QUALITY}, in "
          f"{tree_s:.1f} s; decode(write(x)) against x: least PSNR {psnr:.2f} dB (bound {RE10K_PSNR_MIN}); "
          f"configs/train_scenedino_re10k.yaml's dataset block: {len(train)} windows of {conf['data_fc']} frames "
          f"{conf['dilation']} rows apart, the test instance {'the training set' if test is train else len(test)}; "
          f"an item {tuple(item['imgs'].shape)} finite: {ok}", flush=True)
    print(f"phase 12a loader (host ms): a frame's write {np.median(write_ms):.1f}, its decode {ms['decode']:.1f} "
          f"(each: {json.dumps([round(t, 1) for t in decode_ms])}), the crop's INTER_AREA resize {w}x{h} "
          f"{ms['resize']:.2f}, an item of {conf['data_fc']} frames {json.dumps([round(t, 1) for t in item_ms])}, "
          f"a batch of 4 by ThreadedLoader (4 threads, {nb} batches) {batch_ms:.1f}", flush=True)
    if not (psnr >= RE10K_PSNR_MIN and ok and len(train) > 0):
        fail("the RE10K tree's frames do not decode to what was written, or an item is wrong")
    return data_path, ms


def phase_re10k_train(data_path, scratch):
    """Phase 12b: cli.train.main on configs/train_scenedino_re10k.yaml at full
    width on the tree. Returns (its launches, each step's host and
    loader-wait ms)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_re10k.yaml"))
    conf["dataset"]["data_path"] = data_path
    out = tempfile.mkdtemp(prefix="re10k_s1_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=RE10K_STEPS, checkpoint_every=RE10K_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = RE10K_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": RE10K_VAL_ITEMS}
    path = save_run_config(tempfile.mkdtemp(prefix="re10k_s1_config_", dir=scratch), conf)
    model_conf, tcfg = trainer.configs_from_dict(conf)[:2]
    enc = model_conf["encoder"]
    print(f"phase 12b stage 1: cli.train.main --config configs/train_scenedino_re10k.yaml at full width "
          f"({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, "
          f"{enc['downsampler_arch']}, with_amp {conf['with_amp']}, {enc['image_size']}, batch {conf['batch_size']}, "
          f"{conf['dataset']['data_fc']} frames, loss_renderer_strategy {tcfg.loss_renderer_strategy}); cuts: "
          f"data_path -> the seeded tree, stop_iteration {RE10K_STEPS}, validation every 5000 -> {RE10K_STEPS} over "
          f"items 0-{RE10K_VAL_ITEMS - 1} (file: 0-127), checkpoint_every 10000 -> {RE10K_STEPS}, log_every 1",
          flush=True)
    with k1_batches() as seen:
        records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 12b step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host ms: waiting on the loader "
              f"{r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 12b validation at {r.iteration} ({r.ms:.1f} ms, no depth ground truth): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    # a step: the student's 12 blocks on frame 0 of the 4 items, the teacher's 12 on their 8 loss frames, the
    # backward's 12; a validation item: 12 + 12
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": RE10K_STEPS * 2 * depth + len(vals) * RE10K_VAL_ITEMS * 2 * depth,
              "attention_bwd_dq": RE10K_STEPS * depth, "attention_bwd_dkv": RE10K_STEPS * depth}
    ckpt_path = os.path.join(out, f"training_checkpoint_{RE10K_STEPS}.pt")
    fresh = make_model(model_conf, device="cuda", seed=conf.get("seed", 0), training=True)
    field = torch.load(ckpt_path, map_location="cuda", weights_only=True)["field"]
    student = [n for n, p in fresh.named_parameters() if p.requires_grad]
    still = [n for n in student if torch.equal(field[n], fresh.get_parameter(n))]
    del fresh, field
    print(f"phase 12b run: {len(steps)} steps in {wall:.1f} s wall (model build, data, steps, validation, "
          f"checkpoint); peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} (expected "
          f"{json.dumps(expect)}); K1 forward (batch, with the lse) seen at 2305 tokens {sorted(seen)}; "
          f"{len(student) - len(still)} of {len(student)} student tensors moved", flush=True)
    if (len(steps) != RE10K_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0):
        fail("the RE10K run did not take its steps finite and applied")
    if len(vals) != 1 or not _finite(vals[0].metrics.values()) or "dino_cos_sim" not in vals[0].metrics:
        fail("the RE10K validation is missing its dino metric, or a metric is not finite")
    if still:
        fail(f"student parameters did not move in the RE10K run: {still[:8]}")
    if counts != expect or not all(counts[k] > 0 for k in ("attention", "attention_bwd_dq", "attention_bwd_dkv")):
        fail(f"the RE10K run launched {counts}, expected {expect}")
    if not {(4, True), (8, False)} <= seen:
        fail(f"the RE10K run gave K1 the batches {sorted(seen)}, expected the student's (4, lse) and teacher's 8")
    return counts, [(r.step_ms, r.data_ms) for r in steps], seen


def phase_re10k(seed, scratch):
    """Phase 12: the RealEstate10K path (12a-12c). Returns its launches, K1's
    forward at the shapes the run gave it (2305 tokens) and the backward at
    the student's (4, 2305, 12, 64)."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    data_path, loader_ms = phase_re10k_tree(seed, scratch)
    counts, step_ms, seen = phase_re10k_train(data_path, scratch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 121)
    n = (RE10K_H // 8) * (RE10K_W // 8) + 1
    forwards = [k1_forward_shape(gen, B, lse, "RE10K recipe", "phase 12c", N=n) for B, lse in sorted(seen)]
    backward = k1_backward_shape(gen, 4, n, "phase 12c")
    wait = [round(d / (s + d), 3) for s, d in step_ms]
    print(f"phase 12 loader against the step: a frame's decode {loader_ms['decode']:.1f} ms, its resize "
          f"{loader_ms['resize']:.2f} ms, an item {loader_ms['item']:.1f} ms, a batch of 4 "
          f"{loader_ms['batch_of_4']:.1f} ms; stage-1 steps' host ms {[round(s, 1) for s, _ in step_ms]} after loader "
          f"waits of {[round(d, 1) for _, d in step_ms]}: the wait's share of each step's wall {wait}; {card_line()}; "
          f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, forwards, backward


def _trainable_snapshot(state):
    return [p.detach().clone() for group in state.optimizer.param_groups for p in group["params"]] + \
        [state.artifact_field.detach().clone()]


def _timed_step(step, state, batch, draws):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step(state, batch, draws)
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) * 1e3


def phase_branches(seed):
    """Phase 13a-d on configs/train_synthetic_flagship.yaml's model at full
    width (bf16, batch 4, remat): plain steps, then the uncertainty
    (a Monodepth2 predictor), consistency and debug_stats branches with
    gradient_accum_factor 2 for BRANCH_MICRO_STEPS micro-steps; the
    uncertainty gradient through the rendered channel; the sample-count
    ramp through ScheduledTrainStep; the four render options on the card
    against the CPU; one step through the data-parallel wrapper under NCCL
    at world size 1 against the plain step. Returns the launches of the
    steps (13a, 13b, 13d)."""
    from scenedino_torch import kernels
    from scenedino_torch.core.ray_sampler import ImageRaySampler
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.models.monodepth2 import Monodepth2
    from scenedino_torch.parallel.data_parallel import DataParallel
    from scenedino_torch.renderer.nerf import RenderConfig, render_rays
    from scenedino_torch.training import trainer
    from scenedino_torch.utils import config as yaml_config

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    Bt, V = conf["batch_size"], conf["dataset"]["n_views"]
    torch.manual_seed(seed + 1300)  # the predictor's initialization
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    model.uncertainty_predictor = Monodepth2(1, (0,)).cuda()
    enc = model.encoder
    gp, depth = enc.gt_patch_size, enc.vit_encoder.vit.cfg.depth
    g = torch.Generator(device="cuda").manual_seed(seed + 1300)
    batch = train_batch(g, Bt, H, W, "cuda")
    art0 = 1e-3 * torch.randn(enc.gt_encoder.latent_size, H // gp, W // gp, generator=g, device="cuda")
    branched = dataclasses.replace(tcfg, predict_uncertainty=True, predict_consistency=True, debug_stats=True,
                                   gradient_accum_factor=2)
    print(f"phase 13a stage-1 branches: configs/train_synthetic_flagship.yaml's model at full width (ViT-B/8 student "
          f"and teacher, bf16, remat, batch {Bt}, {V} views, {H}x{W}, {tcfg.ray_batch_size} rays x {rcfg.n_coarse} "
          f"samples) with a Monodepth2(d_out 1) uncertainty predictor; {BRANCH_PLAIN_STEPS} plain steps, then "
          f"predict_uncertainty, predict_consistency ({branched.consistency_rays} rays), debug_stats and "
          f"gradient_accum_factor 2 for {BRANCH_MICRO_STEPS} micro-steps; seeded images (phase 5's)", flush=True)

    kernels.reset_launches()
    expect_plain = {**{n: 0 for n in kernels.WRAPPERS}, "attention": 3 * depth, "attention_bwd_dq": depth,
                    "attention_bwd_dkv": depth}
    runs = {}
    for name, cfg, n_steps in (("plain", tcfg, BRANCH_PLAIN_STEPS), ("branches", branched, BRANCH_MICRO_STEPS)):
        state = trainer.init_train_state(model, cfg, artifact_field=art0)
        step = trainer.make_train_step(model, cfg, rcfg, lcfg)
        up = [p for n, p in model.named_parameters() if n.startswith("uncertainty_predictor.")]
        torch.cuda.reset_peak_memory_stats()
        ms, per_step, moved = [], [], []
        for i in range(n_steps):
            draws = trainer.draw_stage1(g, cfg, rcfg, Bt, V, H, W, gp)
            before = _trainable_snapshot(state)
            counts = kernels.launches()
            losses, t = _timed_step(step, state, batch, draws)
            ms.append(t)
            per_step.append({k: c - counts[k] for k, c in kernels.launches().items()})
            after = _trainable_snapshot(state)
            # the predictor gets no gradient from rec_loss (the loss reads the colours only), so it stays put
            changed = [not torch.equal(a, b) for a, b, p in zip(before, after, [*(p for grp in
                       state.optimizer.param_groups for p in grp["params"]), state.artifact_field])
                       if not any(p is q for q in up)]
            moved.append(sum(changed) / len(changed))
            if not _finite(float(v) for v in losses.values()):
                fail(f"phase 13a {name} step {i + 1}: a non-finite loss {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = dict(ms=ms, launches=per_step, moved=moved, peak=peak, losses=losses)
        print(f"phase 13a {name}: host ms per step {[round(t, 1) for t in ms]} (the first with cuDNN's search); "
              f"share of trainable tensors moved by each step {[round(m, 4) for m in moved]}; peak memory allocated "
              f"{peak:.3f} GiB; launches per step {json.dumps(per_step[-1])}; last losses "
              f"{json.dumps({k: round(float(v), 6) for k, v in losses.items()})}", flush=True)
    # each branch alone: 2 steps (the first with cuDNN's search), the second's host ms and the peak
    alone = {}
    for name, kw in (("uncertainty", dict(predict_uncertainty=True)), ("consistency", dict(predict_consistency=True)),
                     ("debug_stats", dict(debug_stats=True)), ("accumulation", dict(gradient_accum_factor=2))):
        cfg = dataclasses.replace(tcfg, **kw)
        state = trainer.init_train_state(model, cfg, artifact_field=art0)
        step = trainer.make_train_step(model, cfg, rcfg, lcfg)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            losses, t = _timed_step(step, state, batch, trainer.draw_stage1(g, cfg, rcfg, Bt, V, H, W, gp))
        if not np.isfinite(float(losses["rec_loss"])):
            fail(f"phase 13a {name} alone: loss {losses['rec_loss']}")
        alone[name] = {"host_ms": round(t, 1), "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    print(f"phase 13a each branch alone (its second step; accumulation: the second micro-step, which applies): "
          f"{json.dumps(alone)}", flush=True)
    plain, br = runs["plain"], runs["branches"]
    # 24 more forwards a step: consistency encodes views 0 and 1 again (12 blocks each, no graph); the
    # backward is rec_loss's, which the consistency diagnostic does not enter
    expect_branch = {**expect_plain, "attention": 3 * depth + 2 * depth}
    if any(c != expect_plain for c in plain["launches"]) or any(c != expect_branch for c in br["launches"]):
        fail(f"phase 13a launches {plain['launches']} / {br['launches']}, expected {expect_plain} / {expect_branch}")
    if plain["moved"] != [1.0] * BRANCH_PLAIN_STEPS or br["moved"] != [0.0, 1.0, 0.0, 1.0]:
        fail(f"phase 13a: the parameters moved {plain['moved']} / {br['moved']}; accumulation over 2 micro-steps "
             f"must leave them after 1 and 3 and move them after 2 and 4")
    for key in ("uncert_mean", "consistency_depth_abs", "dbg_depth_min", "dbg_artifact_absmax"):
        if key not in br["losses"]:
            fail(f"phase 13a: the branches' loss dict lacks {key}")
    # the uncertainty predictor's gradient through the rendered channel (rec_loss + uncert_mean)
    state = trainer.init_train_state(model, branched, artifact_field=art0)
    model.zero_grad(set_to_none=True)
    draws = trainer.draw_stage1(g, branched, rcfg, Bt, V, H, W, gp)
    loss, losses = trainer.stage1_forward(model, batch, draws, branched, rcfg, lcfg, state.artifact_field)
    (loss + losses["uncert_mean"]).backward()
    up_grads = [p.grad for n, p in model.named_parameters() if n.startswith("uncertainty_predictor.")]
    up_norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(gr.float()) for gr in up_grads
                                                          if gr is not None])))
    print(f"phase 13a uncertainty gradient (rec_loss + uncert_mean, {len(up_grads)} predictor tensors): L2 norm "
          f"{up_norm:.4e}; host ms plain {np.median(plain['ms'][1:]):.1f} vs branches (a micro-step) "
          f"{np.median(br['ms'][1:]):.1f}; peak memory {plain['peak']:.3f} vs {br['peak']:.3f} GiB; attention "
          f"launches a step {plain['launches'][-1]['attention']} vs {br['launches'][-1]['attention']}", flush=True)
    if not (np.isfinite(up_norm) and up_norm > 0):
        fail(f"phase 13a: the uncertainty predictor's gradient is {up_norm}")
    model.zero_grad(set_to_none=True)
    model.uncertainty_predictor = None

    # 13b: the sample-count ramp
    base = dataclasses.replace(rcfg, n_coarse=16)
    state = trainer.init_train_state(model, tcfg, artifact_field=art0)
    seen = []

    def make_step(rc):
        step = trainer.make_train_step(model, tcfg, rc, lcfg)

        def train_step(state, batch, gen):
            draws = trainer.draw_stage1(gen, tcfg, rc, Bt, V, H, W, gp)
            seen.append(draws.u.shape[1])
            return _timed_step(step, state, batch, draws)

        return train_step

    sts = trainer.ScheduledTrainStep(make_step, base, SCHED_RAMP)
    for it in range(3):
        losses, t = sts.for_iteration(it)(state, batch, g)
        print(f"phase 13b step {it + 1}: n_coarse {seen[-1]} (config_at {sts.config_at(it)}), loss "
              f"{float(losses['rec_loss']):.6f}, host {t:.1f} ms", flush=True)
        if not np.isfinite(float(losses["rec_loss"])):
            fail(f"phase 13b step {it + 1}: loss {losses['rec_loss']}")
    if seen != [16, 24, 32]:
        fail(f"phase 13b: the ramp rendered {seen} coarse samples, expected [16, 24, 32]")
    counts = kernels.launches()

    # 13c: the render options, the card against the CPU (no kernel at 32x96)
    h, w = 32, 96
    gc = torch.Generator().manual_seed(seed + 1301)
    small = train_batch(gc, 1, h, w, "cpu")
    cpu_model = copy.deepcopy(model).to("cpu")
    poses = torch.linalg.inv(small["poses"][:, :1]) @ small["poses"]
    rays = ImageRaySampler(tcfg.z_near, tcfg.z_far, h, w).sample(poses[:, 1:2], small["projs"][:, 1:2])[..., :8]
    R, Kc = rays.shape[1], 16
    u, noise = torch.rand(R, Kc, generator=gc), torch.randn(R, Kc, generator=gc)
    results = {}
    for mode, kw, training in (("surface", dict(render_mode="surface"), False),
                               ("neus", dict(render_mode="neus", surface_sigmoid_scale=0.5), False),
                               ("noise", dict(noise_std=1.0), True), ("white_bkgd", dict(white_bkgd=True), False)):
        cfg = RenderConfig(n_coarse=Kc, **kw)
        outs = []
        for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
            with torch.no_grad():
                b = {k: v.to(dev) for k, v in small.items()}
                st = m.encode(b["imgs"], b["projs"], poses.to(dev), ids_encoder=(0,), ids_render=(0, 1))
                outs.append(render_rays(lambda xyz, only_density=False: m(st, xyz, only_density=only_density),
                                        rays.to(dev), u.to(dev), cfg, noise=noise.to(dev), training=training)["coarse"])
        gpu, cpu = outs
        d_rel = ((gpu["depth"].float().cpu() - cpu["depth"]).abs() / cpu["depth"].abs()).flatten()
        p99 = torch.quantile(d_rel, 0.99).item()
        rgb_err = 0.0 if cpu["rgb"] is None else (gpu["rgb"].float().cpu() - cpu["rgb"]).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(gpu["dino_features"].float().cpu(), cpu["dino_features"], dim=-1)
        results[mode] = {"depth_rel_p99": p99, "rgb_abs": rgb_err, "feature_cos_median": cos.median().item(),
                         "rgb": "none" if gpu["rgb"] is None else list(gpu["rgb"].shape)}
        if not (p99 <= EVAL_DEPTH_REL_P99 and rgb_err <= EVAL_RGB_ABS and cos.median().item() >= SLICE_COS
                and (gpu["rgb"] is None) == (mode == "surface")):
            fail(f"phase 13c {mode}: the card's render disagrees with the CPU's: {results[mode]}")
    print(f"phase 13c renders at {h}x{w} ({R} rays x {Kc} samples, the flagship bf16 field, GPU vs CPU, phase 6's "
          f"render bounds: depth rel p99 {EVAL_DEPTH_REL_P99}, rgb abs {EVAL_RGB_ABS}, feature cosine median >= "
          f"{SLICE_COS}): {json.dumps(results)}", flush=True)
    del cpu_model

    # 13d: one step through the data-parallel wrapper (NCCL, world size 1) against the plain step
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, H, W, gp)
    results = []
    for wrapped in (False, True):
        model.load_state_dict(saved)
        state = trainer.init_train_state(model, tcfg, artifact_field=art0)
        if wrapped:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dp = DataParallel.init(0, 1, torch.device("cuda"), init_method=f"tcp://localhost:{port}")
            try:
                step = trainer.make_train_step(model, tcfg, rcfg, lcfg, average_gradients=dp.average_)
                losses, t = _timed_step(lambda s, b, d: dp.reduce_losses(step(s, b, d)), state, batch,
                                        dp.shard_draws(draws, Bt))
            finally:
                torch.distributed.destroy_process_group()
        else:
            losses, t = _timed_step(trainer.make_train_step(model, tcfg, rcfg, lcfg), state, batch, draws)
        results.append((float(losses["rec_loss"]), t, [p.detach().float() - saved[n].float()
                                                        for n, p in model.named_parameters() if n in saved]))
    (l0, t0_, u0), (l1, t1_, u1) = results
    loss_rel = abs(l1 - l0) / abs(l0)
    upd_rel = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(a - b) for a, b in zip(u1, u0)]))
                    / torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(a) for a in u0])))
    print(f"phase 13d data-parallel wrapper (NCCL, world size 1) against the plain step: loss {l1:.6f} vs {l0:.6f} "
          f"(rel {loss_rel:.3e}, bound {TRAIN_LOSS_REL}); the parameters' updates, relative L2 difference "
          f"{upd_rel:.3e} (bound {TRAIN_GRAD_REL}); host {t1_:.1f} vs {t0_:.1f} ms", flush=True)
    if not (loss_rel <= TRAIN_LOSS_REL and upd_rel <= TRAIN_GRAD_REL):
        fail("phase 13d: the data-parallel step disagrees with the plain step")
    counts = kernels.launches()
    print(f"phase 13a-d launches {json.dumps(counts)}; {time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return counts


def phase_dinov2_and_diag(root, stage1_dir, scratch):
    """Phase 13e: cli.train.main on configs/train_scenedino_kitti_360_dinov2.yaml
    at full width on phase 10's tree: the file as shipped is refused (its
    8-pixel ray patches miss the 16-pixel teacher's grid), then 3 steps at
    the teacher's patch size (481 tokens a view: below K1's 512, so the
    step and the validation launch no K1); 13f: the depth-convergence tool
    on phase 6's run directory. Returns 13e's launches."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.tools import diag_depth_convergence
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360_dinov2.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_dinov2_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=DINOV2_STEPS, checkpoint_every=DINOV2_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = DINOV2_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": DINOV2_VAL_ITEMS}
    cfg_dir = tempfile.mkdtemp(prefix="kitti_dinov2_config_", dir=scratch)
    enc = trainer.configs_from_dict(conf)[0]["encoder"]
    patch = conf["training"]["ray_sampler"]["args"]["patch_size"]
    # the file's 8-pixel ray patches miss the 16-pixel DINOv2 teacher's grid: JAX fails to broadcast in its
    # downsampler, the port refuses at the sampler (ROADMAP queue 3); the run takes the teacher's patch size
    t0 = time.perf_counter()
    try:
        cli.main(["--config", save_run_config(cfg_dir, conf)])
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"phase 13e the file as shipped (ray patch_size {patch}): refused in {time.perf_counter() - t0:.1f} s: "
          f"{refused}", flush=True)
    if refused is None or "teacher's patch size" not in refused:
        fail("the dinov2 recipe's 8-pixel patches against its 16-pixel teacher were not refused")
    conf["training"]["ray_sampler"]["args"]["patch_size"] = 16
    path = save_run_config(cfg_dir, conf)
    print(f"phase 13e stage 1: cli.train.main --config configs/train_scenedino_kitti_360_dinov2.yaml at full width "
          f"({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, with_amp "
          f"{conf['with_amp']}, {enc['image_size']}, batch {conf['batch_size']}); cuts: the data paths -> phase 10's "
          f"tree, stop_iteration {DINOV2_STEPS}, validation every {DINOV2_STEPS} over test items "
          f"0-{DINOV2_VAL_ITEMS - 1}, checkpoint_every {DINOV2_STEPS}, log_every 1, output into {out}; the ray "
          f"sampler's patch_size {patch} -> 16, the teacher's", flush=True)
    records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 13e step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host ms: waiting on the loader "
              f"{r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 13e validation at {r.iteration} ({r.ms:.1f} ms): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    print(f"phase 13e run: {len(steps)} steps in {wall:.1f} s wall; peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (481 tokens a view: the ViT's plain attention, as JAX's dispatch floor of 512 "
          f"gives it)", flush=True)
    if (len(steps) != DINOV2_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0 or len(vals) != 1 or not _finite(vals[0].metrics.values())):
        fail("the dinov2 recipe did not take its steps finite and applied, or its validation failed")
    if any(counts.values()):
        fail(f"the dinov2 recipe launched {counts}: at 481 tokens no K1 is expected")
    if not os.path.exists(os.path.join(out, f"training_checkpoint_{DINOV2_STEPS}.pt")):
        fail("the dinov2 recipe wrote no checkpoint")

    t0 = time.perf_counter()
    print(f"phase 13f tools/diag_depth_convergence (port) on phase 6's run directory, {DIAG_ITEMS} items:", flush=True)
    rc = diag_depth_convergence.main([stage1_dir, "--items", str(DIAG_ITEMS)])
    print(f"phase 13f rc {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        fail("the depth-convergence tool failed on phase 6's run directory")
    return counts


# phase 14: serving, the rest. The int8 state's closeness to the exact one
# (the reference's own bounds, tests/test_fast_field.py:178-183); the unfused
# render's colour against K2's (the unfused lookup blends the bf16 image in
# bf16, as the reference's packed-quad gather does, K2 in fp32: a few bf16
# ulps of a value in [0, 1]); the stream's frames; the PLY sequence's frames
# and voxel size (the evaluation's grid, not the CLI's 0.1 m default, to keep
# the files small)
INT8_DEPTH_MEAN = 0.8
INT8_COS_MEAN = 0.995
INT8_RGB_MEAN = 0.05
UNFUSED_RGB_TOL = 1e-2
STREAM_FRAMES = 4
PLY_FRAMES = 2
PLY_VOXEL = 0.2


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mean_cosine(a, b):
    return (torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1, eps=1e-9)).mean().item()


def phase_int8_and_unfused(model, seed):
    """Phases 14a and 14b on one frame of `model`. Returns the launches."""
    from scenedino_torch import kernels
    from scenedino_torch.kernels.encode_view import encode_view_plain
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.tools.bench_encode_view import TOL

    g = torch.Generator(device="cuda").manual_seed(seed + 140)
    img = torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1
    u = torch.rand(H * W, K, generator=g, device="cuda")
    pose, k, cfg = novel_pose("cuda"), intrinsics("cuda"), model.cfg
    kernels.reset_launches()
    with torch.inference_mode():
        state = model.encode(img, *cameras_of("cuda"), ids_encoder=(0,))
        exact = ff.build_fast_state(model, state)
        q = ff.build_fast_state(model, state, quantize_grid=True)
        (da, fa, ra), exact_ms = _synced_ms(lambda: ff.render_novel_view(exact, cfg, pose, k, H, W, u=u, n_coarse=K))
        (db, fb, rb), int8_ms = _synced_ms(lambda: ff.render_novel_view(q, cfg, pose, k, H, W, u=u, n_coarse=K))
        close = {"depth_mean_abs": (da - db).abs().mean().item(), "feature_cos_mean": _mean_cosine(fa, fb),
                 "rgb_mean_abs": (ra - rb).abs().mean().item()}
        print(f"phase 14a int8 grid ({tuple(q.folded_grid.shape)} int8, per-channel scale in "
              f"[{q.grid_scale.min().item():.3e}, {q.grid_scale.max().item():.3e}]) against the exact bf16 state, "
              f"render_novel_view (unfused, plain torch, {H}x{W} x {K} samples, the same strata): "
              f"{json.dumps(close)} (bounds: < {INT8_DEPTH_MEAN} m, > {INT8_COS_MEAN}, < {INT8_RGB_MEAN}); "
              f"host ms exact {exact_ms:.1f}, int8 {int8_ms:.1f}; peak memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
        if not all(bool(torch.isfinite(t).all()) for t in (da, fa, ra, db, fb, rb)) or not (
                close["depth_mean_abs"] < INT8_DEPTH_MEAN and close["feature_cos_mean"] > INT8_COS_MEAN
                and close["rgb_mean_abs"] < INT8_RGB_MEAN):
            fail(f"the int8 render is not within the reference's closeness bounds: {close}")

        pts = ssc_points("cuda")[None]
        _, _, sa, fqa = ff.fast_query(exact, cfg, pts, only_density=True)
        _, _, sb, fqb = ff.fast_query(q, cfg, pts, only_density=True)
        spread = sa.std().item()
        qc = {"sigma_mean_abs": (sa - sb).abs().mean().item(), "sigma_max_abs": (sa - sb).abs().max().item(),
              "sigma_std": spread, "feature_cos_mean": _mean_cosine(fqa, fqb),
              "feature_cos_min": torch.nn.functional.cosine_similarity(fqa.float(), fqb.float(), -1,
                                                                        1e-9).min().item()}
        print(f"phase 14a fast_query over {pts.shape[1]} voxel centres, int8 against exact: {json.dumps(qc)} "
              f"(gated: the mean sigma difference < 0.1 x its spread + 0.05, the mean cosine > {INT8_COS_MEAN})",
              flush=True)
        if not (torch.isfinite(sb).all() and qc["sigma_mean_abs"] < 0.1 * spread + 0.05
                and qc["feature_cos_mean"] > INT8_COS_MEAN):
            fail(f"fast_query on the int8 grid is not close to the exact grid's: {qc}")

        before = kernels.launches()["encode_view"]
        args, ecfg = ff.encode_view_inputs(q, cfg, H, W, u[None], n_coarse=K)
        out = ff.render_encode_view(q, cfg, H, W, u=u, n_coarse=K)
        if kernels.launches()["encode_view"] != before + 1:
            fail("the int8 encode view did not launch K6 once")
        ref = encode_view_plain(*args, ecfg)
        tol = TOL[torch.bfloat16]
        errs = {name: (o.reshape(r.shape) - r).abs().max().item() for name, o, r in zip(tol, out, ref)}
        print(f"phase 14a int8 encode view through K6 (base fp32 after the dequantization, W_z and W2 "
              f"{args[3].dtype}): errors against its plain version {json.dumps(errs)} (phase 3e's bounds "
              f"{json.dumps(tol)})", flush=True)
        if args[0].dtype != torch.float32 or any(errs[n] > tol[n] for n in tol):
            fail(f"K6 on the int8 grid disagrees with its plain version: {errs}")

        refused = []
        for name, call in (("render_novel_view_fused", lambda: ff.render_novel_view_fused(q, cfg, pose, k, H, W, u=u)),
                           ("render_novel_view_probe", lambda: ff.render_novel_view_probe(q, cfg, pose, k, H, W)),
                           ("fast_query_fused", lambda: ff.fast_query_fused(q, cfg, pts[0]))):
            try:
                call()
            except NotImplementedError as e:
                if str(e) == ff.INT8_REFUSAL:
                    refused.append(name)
        print(f"phase 14a the fused paths refuse the int8 state: {refused}", flush=True)
        if len(refused) != 3:
            fail(f"a fused path took the int8 state: refused only {refused}")

        (dk, fk, rk), fused_ms = _synced_ms(lambda: ff.render_novel_view_fused(exact, cfg, pose, k, H, W, u=u,
                                                                                n_coarse=K))
        errs = {"depth": (dk - da).abs().max().item(), "feature": (fk - fa).abs().max().item(),
                "rgb": (rk - ra).abs().max().item()}
        print(f"phase 14b the unfused exact render against render_novel_view_fused (K2) on the same state and "
              f"strata: max abs errors {json.dumps(errs)} (phase 3's bounds: depth {K2_DEPTH_TOL} m, feature "
              f"{K2_FEAT_TOL}; colour {UNFUSED_RGB_TOL}); host ms unfused {exact_ms:.1f}, fused {fused_ms:.1f}",
              flush=True)
        if errs["depth"] > K2_DEPTH_TOL or errs["feature"] > K2_FEAT_TOL or errs["rgb"] > UNFUSED_RGB_TOL:
            fail(f"the unfused exact render and K2 disagree: {errs}")
    return kernels.launches()


def phase_stream(model, seed):
    """Phase 14c: make_pipelined_stream_step over STREAM_FRAMES frames
    against the two-call sequence, bit for bit. Returns the launches of
    the pipelined run."""
    from scenedino_torch import kernels
    from scenedino_torch.ops import fast_field as ff

    g = torch.Generator(device="cuda").manual_seed(seed + 141)
    frames = [torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1 for _ in range(STREAM_FRAMES)]
    strata = [torch.rand(H * W, K, generator=g, device="cuda") for _ in range(STREAM_FRAMES)]
    Ks, poses = cameras_of("cuda")
    pose, k = novel_pose("cuda"), intrinsics("cuda")

    def fold(img):
        return ff.build_fast_state(model, model.encode(img, Ks, poses, ids_encoder=(0,)))

    step = ff.make_pipelined_stream_step(model, H, W, n_coarse=K)
    with torch.inference_mode():
        fs = fold(frames[0])
        kernels.reset_launches()
        piped, piped_ms = [], []
        for i in range(STREAM_FRAMES):
            nxt = frames[min(i + 1, STREAM_FRAMES - 1)]  # the last step re-feeds its frame, its encode unused
            (fs, out), ms = _synced_ms(lambda: step(fs, nxt, Ks, poses, pose, k, u=strata[i]))
            piped.append(out)
            piped_ms.append(ms)
        counts = kernels.launches()
        fs_p = fs
        fs = fold(frames[0])
        seq, seq_ms = [], []
        for i in range(STREAM_FRAMES):
            nxt = frames[min(i + 1, STREAM_FRAMES - 1)]

            def two_calls():
                out = ff.render_novel_view_fused(fs, model.cfg, pose, k, H, W, u=strata[i], n_coarse=K)
                return out, fold(nxt)

            (out, fs), ms = _synced_ms(two_calls)
            seq.append(out)
            seq_ms.append(ms)
    same = all(torch.equal(a, b) for o, r in zip(piped, seq) for a, b in zip(o, r)) and all(
        (getattr(fs_p, n) is None and getattr(fs, n) is None) or torch.equal(getattr(fs_p, n), getattr(fs, n))
        for n in ff.FastFieldState._fields)
    depth = model.encoder.vit_encoder.vit.cfg.depth
    print(f"phase 14c make_pipelined_stream_step over {STREAM_FRAMES} frames ({H}x{W}, {K} samples): equal to the "
          f"two calls bit for bit {same}; host ms a step {[round(t, 2) for t in piped_ms]}, the two calls "
          f"{[round(t, 2) for t in seq_ms]}; launches {json.dumps(counts)}", flush=True)
    if not same:
        fail("the pipelined stream step differs from the two-call sequence")
    if counts["attention"] != STREAM_FRAMES * depth or counts["point_render"] != STREAM_FRAMES:
        fail(f"the stream step did not run K1 and K2 as expected: {counts}")
    for d, f, r in piped:
        check_depth("stream step", d, f, r)
    return counts


def phase_ply_sequence(ssc_root, stage2_dir, scratch):
    """Phase 14d: cli.generate_ply_sequence fast and --pipelined on phase
    8a's tree with phase 7's run. Returns the two runs' launches."""
    from scenedino_torch.cli import generate_ply_sequence as cli

    files, total = {}, {}
    from scenedino_torch.eval.sscbench import SCENE_SIZE

    centres = int(np.prod([np.ceil(s_ / PLY_VOXEL) for s_ in SCENE_SIZE]))
    expect_k4 = PLY_FRAMES * -(-centres // cli.CHUNK)  # the grid padded to whole blocks
    for mode in ("fast", "pipelined"):
        out = tempfile.mkdtemp(prefix=f"ply_{mode}_", dir=scratch)
        argv = ["--data", ssc_root, "--ckpt", stage2_dir, "--config", stage2_dir, "--out", out, "--max-frames",
                str(PLY_FRAMES), "--voxel-size", str(PLY_VOXEL)] + (["--pipelined"] if mode == "pipelined" else [])
        res = []
        _, counts, peak, wall = _logged(lambda: res.append(cli.main(argv)), ("ply_sequence",))
        res = res[0]
        files[mode] = {os.path.relpath(p, out): open(p, "rb").read() for p in res["paths"]}
        sizes = {name: len(b) for name, b in files[mode].items()}
        print(f"phase 14d cli.generate_ply_sequence {mode} ({PLY_FRAMES} frames of phase 8a's tree, "
              f"--voxel-size {PLY_VOXEL}): frame host ms {[round(t, 1) for t in res['frame_ms']]}, sec_per_frame "
              f"{res['sec_per_frame']:.3f}, {wall:.1f} s wall (model build and load included), peak "
              f"{peak:.2f} GiB; file bytes {json.dumps(sizes)}; launches {json.dumps(counts)}", flush=True)
        if counts["point_query"] != expect_k4 or counts["attention"] == 0:
            fail(f"the PLY sequence ({mode}) launched {counts}, expected {expect_k4} K4 blocks and K1")
        for k_, n in counts.items():
            total[k_] = total.get(k_, 0) + n
    same = files["fast"] == files["pipelined"]
    print(f"phase 14d the fast and pipelined files byte-identical: {same} ({len(files['fast'])} files)", flush=True)
    if not same or len(files["fast"]) != 3 * PLY_FRAMES:
        fail("the pipelined PLY sequence differs from the fast one")
    return total


def phase_demo(seed, stage2_dir, scratch):
    """Phase 14e: cli.demo on a seeded 192x640 PNG with phase 7's run.
    Returns its launches."""
    from scenedino_torch.cli import demo
    from scenedino_torch.datasets.image_io import read_png, write_png

    out = tempfile.mkdtemp(prefix="demo_", dir=scratch)
    png = os.path.join(out, "input.png")
    write_png(png, np.random.default_rng(seed + 142).integers(0, 256, (H, W, 3), dtype=np.uint8))
    res = []
    _, counts, peak, wall = _logged(lambda: res.append(demo.main(["--image", png, "--config", stage2_dir, "--ckpt",
                                                                  stage2_dir, "--out", out])), ())
    ms = {k_: round(v, 1) for k_, v in res[0].items() if k_.endswith("_ms")}
    arrays = {name: np.load(os.path.join(out, name)) for name in ("depth.npy", "dino_features.npy", "grid_sigma.npy")}
    pngs = {name: read_png(os.path.join(out, name)).shape for name in
            ("input_image.png", "feat_pca_00_02.png", "feat_pca_03_05.png", "feat_pca_06_08.png")}
    occupied = int((arrays["grid_sigma.npy"] > 0.2).sum())
    print(f"phase 14e cli.demo (phase 7's run, {H}x{W}): host ms {json.dumps(ms)}, {wall:.1f} s wall (model build "
          f"and load included); peak memory allocated {peak:.2f} GiB; depth [{arrays['depth.npy'].min():.2f}, "
          f"{arrays['depth.npy'].max():.2f}] m, features {arrays['dino_features.npy'].shape}, grid "
          f"{arrays['grid_sigma.npy'].shape[0]} points, {occupied} occupied; panels {json.dumps(pngs)}; launches "
          f"{json.dumps(counts)}", flush=True)
    if not all(np.isfinite(a.astype(np.float32)).all() for a in arrays.values()) or arrays["depth.npy"].shape != (H, W) \
            or arrays["dino_features.npy"].shape != (H, W, 768) or arrays["grid_sigma.npy"].shape != (101 * 51 * 101,):
        fail("the demo's arrays are not finite or not of the expected shapes")
    if any(shape != (H, W, 3) for shape in pngs.values()) or (occupied and not os.path.exists(
            os.path.join(out, "grid_points.ply"))):
        fail("the demo did not write every file")
    if counts["attention"] != 12:
        fail(f"the demo's encode did not run K1: {counts}")
    return counts


def phase_probe_trained():
    """Phase 14f: the probe-serving bound on the trained s1b field through
    the kernels. Returns the launches."""
    from scenedino_torch.tools import probe_quality_trained as pq

    (err_p, err_e, cos, counts), ms = _synced_ms(lambda: pq.probe_errors("cuda"))
    stats, failed = pq.bound(err_p, err_e, cos)
    print(f"phase 14f the probe bound on the trained s1b field ({pq.H}x{pq.W}, bf16 state): "
          f"{json.dumps({k_: round(v, 6) for k_, v in stats.items()})}; failed {failed}; launches "
          f"{json.dumps(counts)}; {ms:.0f} ms", flush=True)
    if failed or counts["point_render"] != 3 or counts["probe_weights"] != 1 or counts["row_gather"] != 1:
        fail(f"the probe bound on the trained field failed on the card: {failed}, launches {counts}")
    return counts


def phase_serving_rest(seed, ssc_root, stage2_dir, scratch):
    """Phase 14: serving, the rest. Returns the launches of its paths."""
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    torch.cuda.reset_peak_memory_stats()
    parts = [phase_int8_and_unfused(model, seed), phase_stream(model, seed)]
    del model
    torch.cuda.empty_cache()
    parts += [phase_ply_sequence(ssc_root, stage2_dir, scratch), phase_demo(seed, stage2_dir, scratch),
              phase_probe_trained()]
    print(f"phase 14 wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}", flush=True)
    return {name: sum(p[name] for p in parts) for name in parts[0]}


# phase 15: the sharded render's devices (the card named this many times; 48
# strips of 4 rows deal 12 to each), the generic ray renderer's rays, the
# evaluators' devices (phase 8's trees of 3 frames: a group of 2, then a short
# group of 1), the stage-2 steps through the data-parallel wrapper
MESH_REPEAT = 4
MESH_RAYS = 12288
EVAL_MESH = 2
STAGE2_DP_STEPS = 2


def _max_diffs(names, got, want):
    return {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, got, want)}


def phase_sharded_serving(seed):
    """Phase 15a: the sharded fused render and the ray-sharded renderer on
    the flagship serving model. Returns the launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.parallel.mesh import make_mesh
    from scenedino_torch.parallel.render_sharding import make_sharded_renderer
    from scenedino_torch.renderer.nerf import RenderConfig, render_rays

    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 150)
    img = torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1
    u = torch.rand(H * W, K, generator=g, device="cuda")
    pose, k, cfg = novel_pose("cuda"), intrinsics("cuda"), model.cfg
    meshes = {f"[cuda:0] x {MESH_REPEAT}": [torch.device("cuda", 0)] * MESH_REPEAT, "make_mesh()": make_mesh()}
    names = ("depth", "feature", "rgb")
    kernels.reset_launches()
    with torch.inference_mode():
        Ks, poses = cameras_of("cuda")
        state = model.encode(img, Ks, poses, ids_encoder=(0,))
        fs = ff.build_fast_state(model, state)
        one, one_ms = _synced_ms(lambda: ff.render_novel_view_fused(fs, cfg, pose, k, H, W, u=u, n_coarse=K))
        results = {}
        for name, devs in meshes.items():
            before = kernels.launches()["point_render"]
            out, ms = _synced_ms(lambda: ff.render_novel_view_fused_sharded(fs, cfg, pose, k, H, W, devs, u=u,
                                                                             n_coarse=K))
            results[name] = {"devices": len(devs), "max_abs_diff": _max_diffs(names, out, one),
                             "k2_launches": kernels.launches()["point_render"] - before, "host_ms": round(ms, 2)}
            check_depth(f"sharded render over {name}", *out)
        print(f"phase 15a render_novel_view_fused_sharded ({H}x{W}, {K} samples, strips of 4 rows) against "
              f"render_novel_view_fused ({one_ms:.2f} host ms, 1 K2 launch): {json.dumps(results)}", flush=True)
        for name, r in results.items():
            if any(r["max_abs_diff"].values()) or r["k2_launches"] != r["devices"]:
                fail(f"the sharded fused render over {name} is not the one-card render through one K2 a share: {r}")

        rays = ff._target_rays(cfg, pose, k, H, W).reshape(1, -1, 8)[:, :MESH_RAYS].contiguous()
        u_r = u[:MESH_RAYS]
        rcfg = RenderConfig(n_coarse=K)

        def field_fn(xyz, only_density=False):
            return model(state, xyz, only_density=only_density)

        ref, ref_ms = _synced_ms(lambda: render_rays(field_fn, rays, u_r, rcfg, want_z_samps=True)["coarse"])
        run = make_sharded_renderer(lambda d: field_fn, rcfg, meshes[f"[cuda:0] x {MESH_REPEAT}"], want_z_samps=True)
        got, got_ms = _synced_ms(lambda: run(rays, u_r)["coarse"])
        keys = ("depth", "dino_features", "rgb", "z_samps")
        diffs = _max_diffs(keys, [got[n] for n in keys], [ref[n] for n in keys])
        print(f"phase 15a make_sharded_renderer over [cuda:0] x {MESH_REPEAT} against render_rays on the same "
              f"draws ({MESH_RAYS} rays x {K} samples through the unfolded field): max abs differences "
              f"{json.dumps(diffs)} (gated: 0 in every output); host ms {got_ms:.1f} against {ref_ms:.1f}",
              flush=True)
        if any(diffs.values()):
            fail(f"the ray-sharded renderer is not render_rays bit for bit: {diffs}")
    counts = kernels.launches()
    del model, state, fs
    torch.cuda.empty_cache()
    return counts


CARD = torch.device("cuda", 0)
TWICE = f"--data-parallel over [cuda:0] x {EVAL_MESH}"


@contextlib.contextmanager
def _mesh_of(cli, devices):
    """The CLI module's `make_mesh` giving `devices` inside the block (None:
    the CLI's own): a CLI's --data-parallel runs over every visible card, so
    the frame-parallel path runs here over the one card named again."""
    if devices is None:
        yield
        return
    own = cli.make_mesh
    cli.make_mesh = lambda device: list(devices)
    try:
        yield
    finally:
        cli.make_mesh = own


def phase_sharded_eval(ssc_root, city_root, stage2_dir, scratch):
    """Phases 15b and 15c: both evaluation CLIs in turn and --data-parallel
    on phase 8's trees. Returns the launches."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate, evaluate_sscbench
    from scenedino_torch.utils.config import load_run_config, save_run_config

    argv = ["--data", ssc_root, "--voxel-gt", os.path.join(ssc_root, "voxel_gt"), "--ckpt", stage2_dir,
            "--config", stage2_dir, "--device", "cuda"]
    depth = load_run_config(stage2_dir)["model"]["encoder"].get("vit_overrides", {}).get("depth", 12)
    blocks = 256 * 256 * 32 // SSC_BLOCK
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
              "point_query": EVAL_FRAMES * blocks}
    total = {name: 0 for name in kernels.WRAPPERS}
    runs = {}
    for name, extra, devs in (("in turn", [], None), (TWICE, ["--data-parallel"], [CARD] * EVAL_MESH),
                              ("--data-parallel over make_mesh()", ["--data-parallel"], None)):
        with _mesh_of(evaluate_sscbench, devs):
            (table, acc), counts, frames, peak, wall = _run_logged(evaluate_sscbench.main, argv + extra)
        runs[name] = (table, acc)
        for k_, n in counts.items():
            total[k_] += n
        print(f"phase 15b cli.evaluate_sscbench {name} (phase 8a's tree, {EVAL_FRAMES} frames): sec_per_frame "
              f"{table['sec_per_frame']:.4f}; per frame host ms "
              f"{json.dumps([{k_: round(v, 1) for k_, v in vars(r).items() if k_.endswith('_ms')} for r in frames])}; "
              f"{wall:.1f} s wall (model build and load included), peak {peak:.3f} GiB; launches {json.dumps(counts)}",
              flush=True)
        if counts != expect:
            fail(f"the SSCBench evaluation ({name}) launched {counts}, expected {expect}")
    base, base_acc = runs["in turn"]
    for name, (table, acc) in runs.items():
        same = {k_: v for k_, v in table.items() if k_ != "sec_per_frame"} == {
            k_: v for k_, v in base.items() if k_ != "sec_per_frame"} and _results_equal(acc.results, base_acc.results)
        print(f"phase 15b {name}: the table and accumulated numbers equal to the run in turn: {same}", flush=True)
        if not same:
            fail(f"the SSCBench evaluation {name} differs from the run in turn")

    conf = _eval_config(os.path.dirname(os.path.abspath(__file__)), stage2_dir, city_root)
    conf_dir = tempfile.mkdtemp(prefix="eval_config_dp_", dir=scratch)
    save_run_config(conf_dir, conf)
    argv = ["--config", conf_dir, "--ckpt", stage2_dir, "--device", "cuda"]
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth, "encode_view": EVAL_FRAMES}
    outs = {}
    for name, extra, devs in (("in turn", [], None), (TWICE, ["--data-parallel"], [CARD] * EVAL_MESH),
                              ("--data-parallel over make_mesh()", ["--data-parallel"], None)):
        with _mesh_of(evaluate, devs):
            out, counts, frames, peak, wall = _run_logged(evaluate.main, argv + extra)
        outs[name] = out
        for k_, n in counts.items():
            total[k_] += n
        ms = [{k_: round(v, 1) for k_, v in vars(r).items() if k_.endswith("_ms")} for r in frames]
        print(f"phase 15c cli.evaluate {name} (phase 8b's tree, {EVAL_FRAMES} frames): "
              f"{json.dumps({m: r['miou'] for m, r in out.items() if isinstance(r, dict)})} (mIoU); host ms "
              f"{json.dumps(ms)}; {wall:.1f} s wall, peak {peak:.3f} GiB; launches {json.dumps(counts)}", flush=True)
        if counts != expect:
            fail(f"the 2D evaluation ({name}) launched {counts}, expected {expect}")
    same = len(set(json.dumps(o, sort_keys=True) for o in outs.values())) == 1
    print(f"phase 15c both data-parallel runs' metrics equal to the run in turn (atol 0): {same}", flush=True)
    if not same:
        fail("the data-parallel 2D evaluation differs from the run in turn")
    return total


def _results_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_results_equal(a[k_], b[k_]) for k_ in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def phase_stage2_parallel(stage2_dir):
    """Phase 15d: stage-2 steps through the data-parallel wrapper (NCCL,
    world size 1) against the plain step, the generic stage-2 render against
    the folded one, and a mode 2d step, on phase 7's config. Returns the
    launches."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.datasets import make_datasets, with_train_ids
    from scenedino_torch.models.downstream import SemanticHead
    from scenedino_torch.parallel.data_parallel import DataParallel
    from scenedino_torch.training import downstream as down
    from scenedino_torch.utils.config import load_run_config
    from scenedino_torch.utils.prefetch import to_device

    config = load_run_config(stage2_dir)
    field, head, _, gen, cfg, rcfg, loss_cfg = cli.init_stage2(config, "cuda")
    train_ds = with_train_ids(make_datasets(config["dataset"])[0], config["dataset"])
    batch = to_device(next(iter(cli.batch_iterator(train_ds, config["batch_size"])())), "cuda", cli.SEMANTIC_KEYS)
    B, V = batch["imgs"].shape[:2]
    init = {n: t.clone() for n, t in head.state_dict().items()}
    draws = [down.draw_stage2(gen, cfg, head.cfg, rcfg, B, V) for _ in range(STAGE2_DP_STEPS)]
    kernels.reset_launches()
    runs = {}
    for wrapped in (False, True):
        head.load_state_dict(init)
        state = down.init_downstream_state(head, cfg)
        dp = None
        if wrapped:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dp = DataParallel.init(0, 1, torch.device("cuda"), init_method=f"tcp://localhost:{port}")
        try:
            step = down.make_downstream_train_step(field, head, cfg, rcfg, loss_cfg, dp=dp)
            losses, ms = [], []
            for d in draws:
                if dp is not None:
                    d = down.shard_stage2_draws(d, dp, B, head, cfg)
                out, t = _synced_ms(lambda: step(state, batch, d) if dp is None else dp.reduce_losses(
                    step(state, batch, d)))
                losses.append({k_: float(v) for k_, v in out.items()})
                ms.append(round(t, 1))
        finally:
            if dp is not None:
                torch.distributed.destroy_process_group()
        runs[wrapped] = (losses, {n: p.detach().clone() for n, p in head.named_parameters()}, ms, state.buffers)
    (l0, p0, ms0, b0), (l1, p1, ms1, b1) = runs[False], runs[True]
    same = l0 == l1 and all(torch.equal(p0[n], p1[n]) for n in p0) and torch.equal(b0.patch_buffer, b1.patch_buffer)
    print(f"phase 15d {STAGE2_DP_STEPS} stage-2 steps of phase 7's config through the data-parallel wrapper (NCCL, "
          f"world size 1) against the plain step: losses, head and buffers equal bit for bit {same}; total_loss "
          f"{[l_['total_loss'] for l_ in l1]}; host ms {ms1} against {ms0}", flush=True)
    if not same or not all(np.isfinite(list(l_.values())).all() for l_ in l1):
        fail("phase 15d: the data-parallel stage-2 step differs from the plain step")

    generic_cfg = dataclasses.replace(cfg, use_fast_render=False)
    u = draws[0].u
    with torch.no_grad():
        (fold, *_), fold_ms = _synced_ms(lambda: down.render_frames(field, batch, u, 0, cfg, rcfg))
        (gen_r, *_), gen_ms = _synced_ms(lambda: down.render_frames(field, batch, u, 0, generic_cfg, rcfg))
    d_rel = ((gen_r["depth"] - fold["depth"]).abs() / fold["depth"].abs()).flatten().float()
    close = {"depth_rel_p99": torch.quantile(d_rel[::7], 0.99).item(),
             "rgb_abs": (gen_r["rgb"] - fold["rgb"]).abs().max().item(),
             "feature_cos_median": torch.nn.functional.cosine_similarity(
                 gen_r["dino_features"].float(), fold["dino_features"].float(), dim=-1).median().item()}
    print(f"phase 15d the generic stage-2 render (ImageRaySampler + render_rays_chunked of the unfolded field, "
          f"chunks of {cfg.render_chunk} rays) against the folded one (K6, fp32 fold) on one batch of {B} frames: "
          f"{json.dumps(close)} (phase 7's render bounds: depth rel p99 {EVAL_DEPTH_REL_P99}, rgb abs {EVAL_RGB_ABS}, "
          f"feature cosine median >= {SLICE_COS}); host ms generic {gen_ms:.1f}, folded {fold_ms:.1f}", flush=True)
    if not (close["depth_rel_p99"] <= EVAL_DEPTH_REL_P99 and close["rgb_abs"] <= EVAL_RGB_ABS
            and close["feature_cos_median"] >= SLICE_COS):
        fail(f"phase 15d: the generic stage-2 render disagrees with the folded one: {close}")

    two_d = dataclasses.replace(cfg, mode="2d")
    head2 = SemanticHead(dataclasses.replace(head.cfg, mode="2d")).to("cuda")
    head2.load_state_dict(init)
    state2 = down.init_downstream_state(head2, two_d)
    before = kernels.launches()["encode_view"]
    out, ms = _synced_ms(lambda: down.make_downstream_train_step(field, head2, two_d, rcfg, loss_cfg)(
        state2, batch, down.draw_stage2(gen, two_d, head2.cfg, rcfg, B, V)))
    print(f"phase 15d a downstream.mode 2d step (the head's five crops, {head2.cfg.patch_sample_size} samples each, "
          f"no 3D crops): {json.dumps({k_: round(float(v), 6) for k_, v in out.items()})}; {ms:.1f} host ms; the "
          f"buffers' cursor {state2.buffers.idx}, mark {state2.buffers.filled}", flush=True)
    if not np.isfinite([float(v) for v in out.values()]).all() or kernels.launches()["encode_view"] != before + 1 \
            or state2.applied != 1:
        fail("phase 15d: the 2d stage-2 step is not finite, skipped, or did not render through K6")
    counts = kernels.launches()
    del field, head, head2, state, state2
    torch.cuda.empty_cache()
    return counts


def phase_multi_device(seed, ssc_root, city_root, stage2_dir, scratch):
    """Phase 15: the device-parallel paths. Returns their launches."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    parts = [phase_sharded_serving(seed), phase_sharded_eval(ssc_root, city_root, stage2_dir, scratch),
             phase_stage2_parallel(stage2_dir)]
    counts = {name: sum(p[name] for p in parts) for name in parts[0]}
    print(f"phase 15 launches {json.dumps(counts)}; wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}",
          flush=True)
    if not all(counts[n] for n in ("attention", "point_render", "point_query", "encode_view")):
        fail(f"phase 15 did not launch K1, K2, K4 and K6: {counts}")
    return counts


# phase 16: the validator's occupancy probe grid (points ahead of the first
# camera), the fp32 small-input check's size and its bounds (the CPU tests':
# the render's depths relative and its colours absolute 1e-4, each metric
# relative 1e-4, the occupancy metrics exactly), the bf16 pair's size (the
# smallest at which the ViT takes K1) and its bounds, read from that pair
# on an H100 with some room (PERF.md), and the TSDF volume (x, y, z bounds
# in m and the voxel size) with its GPU-CPU bound
OCC_GRID = (16, 8, 32)
OCC_THRESHOLD = 1.0
VAL_SMALL = (64, 128)
VAL_REL = 1e-4
VAL_BF16_SIZE = (128, 256)
VAL_BF16 = {"depth_rel_p99": 3e-2, "depth_rel_median": 1e-2, "metrics_rel": 3e-2, "panel_within_one": 0.85}
TSDF_BOUNDS, TSDF_VOXEL, TSDF_TOL = ((-12.0, 12.0), (-4.0, 2.0), (3.0, 40.0)), 0.2, 1e-5


def _occupancy_batch(item, gen, device):
    """One dataset item as a batch with the occupancy probe's inputs: a grid
    of OCC_GRID points 4 to 40 m ahead and seeded is_occupied / is_visible."""
    batch = {k: torch.as_tensor(item[k])[None].to(device) for k in ("imgs", "poses", "projs", "depths")}
    axes = [torch.linspace(a, b, n) for (a, b), n in zip(((-8, 8), (-2, 1), (4, 40)), OCC_GRID)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
    n = pts.shape[1]
    batch["occ_pts"] = pts.to(device)
    batch["is_occupied"] = (torch.rand(1, n, generator=gen) < 0.4).to(device)
    batch["is_visible"] = (torch.rand(1, n, generator=gen) < 0.5).to(device)
    return batch


def _resized(batch, h, w):
    """A batch's images resized to h x w (bilinear), its depths (nearest)."""
    return {**batch, "imgs": torch.nn.functional.interpolate(batch["imgs"][0], size=(h, w), mode="bilinear")[None],
            "depths": torch.nn.functional.interpolate(batch["depths"], size=(h, w), mode="nearest")}


def _lpips_file(path, seed):
    """A seeded AlexNet LPIPS state dict in the published `lpips` naming
    (torchvision's trunk under net.<i>, the heads as lin<k>.model.1.weight)."""
    from scenedino_torch.eval.lpips import ALEX_CHANNELS

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i, cin, cout, k in ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3), (10, 256, 256, 3)):
        sd[f"net.{i}.weight"] = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
        sd[f"net.{i}.bias"] = 0.1 * torch.randn(cout, generator=g)
    for j, c in enumerate(ALEX_CHANNELS):
        sd[f"lin{j}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=g)
    torch.save(sd, path)
    return path


@contextlib.contextmanager
def _fixed_render_draws(u):
    """The validator's render takes the strata `u` (moved to the batch's
    device) instead of drawing them: the same draws on every device.
    Yields the list its outputs are appended to."""
    from scenedino_torch.training import trainer

    real = trainer.stage1_eval_forward
    outputs = []

    def with_draws(field, batch, cfg, rcfg, generator=None, **kw):
        outputs.append(real(field, batch, cfg, rcfg, u=u.to(batch["imgs"].device), **kw))
        return outputs[-1]

    trainer.stage1_eval_forward = with_draws
    try:
        yield outputs
    finally:
        trainer.stage1_eval_forward = real


def _validate(config, stage1_dir, device, batch, u, val_cfg, tcfg, rcfg, lpips_path, seed):
    """The stage-1 validator of the run in `stage1_dir` (built from `config`)
    on `device` over one batch, the render taking the strata `u`: (its
    metrics, its panels, the render's outputs on the CPU, the field)."""
    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.eval.lpips import load_lpips
    from scenedino_torch.training.validation import make_stage1_validator

    field = eval_model(config, stage1_dir, device)[0]
    b = {k: v.to(device) for k, v in batch.items()}
    with _fixed_render_draws(u) as rendered:  # the validator binds the render when it is made
        v = make_stage1_validator("validation", val_cfg, field, tcfg, rcfg, lambda: iter([b]),
                                  load_lpips(lpips_path, "alex", device=device))
        metrics = v(None, torch.Generator(device=device).manual_seed(seed))
    panels = metrics.pop("images")
    return metrics, panels, {k: x.float().cpu() for k, x in rendered[0].items()}, field


def _validator_diffs(gpu, cpu):
    """How far the card's _validate result lies from the CPU's: the render's
    depth relative (max, 99th percentile, median), its colours and pooled
    features absolute, each metric relative, each panel's largest difference
    in levels of 255 and its share of pixels within one level."""
    (gm, gp, gr, _), (cm, cp, cr, _) = gpu, cpu
    d = ((gr["depth"] - cr["depth"]).abs() / cr["depth"]).flatten()
    levels = {k: np.abs(np.round(gp[k] * 255) - np.round(cp[k] * 255)) for k in cp}
    return {"keys_equal": sorted(gm) == sorted(cm) and sorted(gp) == sorted(cp),
            "depth_rel": d.max().item(), "depth_rel_p99": torch.quantile(d[::max(1, d.numel() // 2 ** 20)], 0.99).item(),
            "depth_rel_median": d.median().item(), "rgb_abs": (gr["rgb"] - cr["rgb"]).abs().max().item(),
            "features_abs": (gr["dino_pred_grid"] - cr["dino_pred_grid"]).abs().max().item(),
            "metrics_rel": {k: float(f"{abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12):.3e}") for k in cm},
            "panel_levels": {k: int(x.max()) for k, x in levels.items()},
            "panel_within_one": {k: round(float((x <= 1).all(-1).mean()), 4) for k, x in levels.items()}}


def phase_validator(seed, stage1_dir, scratch):
    """Phase 16a: the stage-1 validator of phase 6's run (bf16, as it
    trained) on one 192x640 item of the synthetic dataset with occupancy
    inputs, metrics depth, dino, nvs (with LPIPS) and occ, and its panels;
    the same validator at VAL_BF16_SIZE on the card and on the CPU with
    the same render draws (K1 against plain attention, at the bounds
    VAL_BF16); then the fp32 field at VAL_SMALL on the card and on the CPU
    (the CPU tests' bounds). Returns
    (the card's full-size run's launches, its bf16 field, the item)."""
    from scenedino_torch import kernels
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load_run_config

    config = load_run_config(stage1_dir)
    _, tcfg, rcfg, _ = trainer.configs_from_dict(config)
    val_cfg = {"metrics": [{"type": "depth", "args": None}, {"type": "dino", "args": None},
                           {"type": "nvs", "args": None}, {"type": "occ", "args": {"occ_threshold": OCC_THRESHOLD}}]}
    lpips_path = _lpips_file(os.path.join(scratch, "lpips_alex.pt"), seed + 160)
    item = make_datasets(config["dataset"])[1][0]
    gen = torch.Generator().manual_seed(seed + 161)
    batch = _occupancy_batch(item, gen, "cpu")
    u = torch.rand(batch["imgs"].shape[1] * batch["imgs"][0, 0, 0].numel(), rcfg.n_coarse, generator=gen)
    args = (val_cfg, tcfg, rcfg, lpips_path, seed + 162)
    out = []
    _, counts, peak, wall = _logged(lambda: out.append(_validate(config, stage1_dir, "cuda", batch, u, *args)))
    metrics, panels, _, field = gpu = out[0]
    depth = config["model"]["encoder"].get("vit_overrides", {}).get("depth", 12)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": 2 * depth}
    H0, W0 = item["imgs"].shape[-2:]
    print(f"phase 16a the stage-1 validator of phase 6's run ({config['model']['encoder']['encoder_arch']}, with_amp "
          f"{config.get('with_amp')}) on one {H0}x{W0} item of {item['imgs'].shape[0]} views with "
          f"{batch['occ_pts'].shape[1]} occupancy probe points (threshold {OCC_THRESHOLD}) and LPIPS alex from a "
          f"seeded lpips-named state dict: {json.dumps({k: round(float(v), 6) for k, v in metrics.items()})}; panels "
          f"{json.dumps({k: list(v.shape) for k, v in panels.items()})}; {wall:.1f} s wall (the field's load "
          f"included), peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: the "
          f"student's {depth} K1 and the teacher's {depth})", flush=True)
    want = {f"{t}_{k}" for t, ks in (("depth", ("abs_rel", "a1")), ("dino", ("cos_sim",)),
                                    ("nvs", ("psnr", "ssim", "lpips")), ("occ", ("o_acc", "ie_acc", "t_ie")))
            for k in ks}
    if (not want <= set(metrics) or not _finite(metrics.values()) or len(panels) != 8
            or not all(np.isfinite(p).all() and p.min() >= 0 and p.max() <= 1 for p in panels.values())):
        fail(f"the validator's metrics or panels are missing or not finite: {sorted(metrics)}, {sorted(panels)}")
    if counts != expect:
        fail(f"the validator launched {counts}, expected {expect}")

    # the same bf16 validator at VAL_BF16_SIZE on the card and on the CPU, the same draws: K1 against the plain
    # attention in bf16 (at 192x640 the CPU side took 103 s on an H100 machine's 8 host threads, beyond the
    # phase's budget)
    h, w = VAL_BF16_SIZE
    gc = torch.Generator().manual_seed(seed + 163)
    small = _resized(_occupancy_batch(item, gc, "cpu"), h, w)
    u = torch.rand(small["imgs"].shape[1] * h * w, rcfg.n_coarse, generator=gc)
    out = []
    _, pair_counts, _, _ = _logged(lambda: out.append(_validate(config, stage1_dir, "cuda", small, u, *args)))
    t0 = time.perf_counter()
    diffs = _validator_diffs(out[0], _validate(config, stage1_dir, "cpu", small, u, *args))
    print(f"phase 16a the bf16 validator at {h}x{w} ({1 + (h // 8) * (w // 8)} tokens), the card (launches "
          f"{json.dumps(pair_counts)}) against the CPU ({time.perf_counter() - t0:.1f} s wall, "
          f"{torch.get_num_threads()} threads; the same draws): {json.dumps(diffs)} (bounds {json.dumps(VAL_BF16)})",
          flush=True)
    if (pair_counts != expect or not diffs["keys_equal"]
            or any(diffs[k] > VAL_BF16[k] for k in ("depth_rel_p99", "depth_rel_median"))
            or any(r > VAL_BF16["metrics_rel"] for r in diffs["metrics_rel"].values())
            or any(s < VAL_BF16["panel_within_one"] for s in diffs["panel_within_one"].values())):
        fail("the bf16 validator on the card did not take K1 or disagrees with the CPU beyond VAL_BF16")

    # the fp32 validator at 64x128, the card against the CPU, the same draws
    conf32 = copy.deepcopy(config)
    conf32["with_amp"] = False
    conf32["model"]["encoder"].pop("dtype", None)  # the run's config may name its bf16 encoder
    h, w = VAL_SMALL
    small = _resized(_occupancy_batch(item, gc, "cpu"), h, w)
    u = torch.rand(small["imgs"].shape[1] * h * w, rcfg.n_coarse, generator=gc)
    runs = [_validate(conf32, stage1_dir, device, small, u, val_cfg, tcfg, rcfg, lpips_path, seed + 164)
            for device in ("cuda", "cpu")]
    diffs = _validator_diffs(*runs)
    occ_equal = all(runs[0][0][k] == runs[1][0][k] for k in runs[1][0] if k.startswith("occ_"))
    levels = {k: v for k, v in diffs["panel_levels"].items() if k != "dino_kmeans"}
    # depth_a1-a3 are shares of view 0's pixels whose depth ratio to the ground truth lies under 1.25^k: a
    # pixel whose ratio lies within the devices' depth difference of a threshold counts on either side, so
    # those shares may differ by the share of such pixels (eval.metrics.depth_metrics, no scaling)
    pred = runs[1][2]["depth"][:, 0].clamp_min(1e-3)
    gt = small["depths"].reshape(pred.shape[0], -1, *pred.shape[1:])[:, 0].float()
    ratio = torch.maximum(gt / pred, pred / gt.clamp_min(1e-8))[gt > 0]
    n_px = max(ratio.numel(), 1)
    ties = {f"depth_a{k}": int(((ratio - 1.25 ** k).abs() <= 2 * diffs["depth_rel"] * ratio).sum()) for k in (1, 2, 3)}
    shares = {m: abs(runs[0][0][m] - runs[1][0][m]) * n_px for m in ties}
    print(f"phase 16a fp32 at {h}x{w}, the card against the CPU (the same draws; the ViT's plain attention at "
          f"{1 + (h // 8) * (w // 8)} tokens; cuDNN's convolutions, TF32 off): {json.dumps(diffs)} (bounds: the "
          f"render's depth relative and rgb absolute {VAL_REL}, each metric relative {VAL_REL}, the threshold shares "
          f"depth_a1-a3 by at most the pixels whose ratio lies within twice the depth difference of the threshold "
          f"({json.dumps({m: round(shares[m], 3) for m in ties})} pixels of {n_px} moved, "
          f"{json.dumps(ties)} within it), the occupancy metrics equal: {occ_equal}; each panel within one level, the "
          f"k-means map, whose labels can flip where two clusters tie within round-off, by its share of pixels "
          f"within one level >= 0.95)", flush=True)
    if (not diffs["keys_equal"] or not occ_equal or max(levels.values()) > 1
            or diffs["panel_within_one"]["dino_kmeans"] < 0.95 or diffs["depth_rel"] > VAL_REL
            or diffs["rgb_abs"] > VAL_REL
            or any(r > VAL_REL and not (m in ties and shares[m] <= ties[m] + 0.01)
                   for m, r in diffs["metrics_rel"].items())):
        fail("the fp32 validator on the card disagrees with the CPU")
    return counts, field, item


def phase_s4c(seed, ssc_root, scratch):
    """Phase 16b: cli.evaluate_sscbench --mode s4c on phase 8a's tree with a
    seeded S4C field snapshot; K4 at the S4C field's (D = 64, E = 20)
    against its plain version on one block of frame 0, timed, with its
    bound. Returns (the run's launches, K4's entry at that shape)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate_sscbench as cli
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.kernels.point_render import point_query, point_query_plain
    from scenedino_torch.models.factory import make_model, s4c_baseline_config
    from scenedino_torch.ops import fast_field
    from scenedino_torch.utils.checkpoint import save_field_snapshot
    from scenedino_torch.utils.timing import time_ms

    field = make_model(s4c_baseline_config(), device="cuda", seed=seed + 164).eval()
    ckpt = os.path.join(scratch, "s4c_field.pt")
    save_field_snapshot(ckpt, field)
    argv = ["--data", ssc_root, "--voxel-gt", os.path.join(ssc_root, "voxel_gt"), "--ckpt", ckpt, "--mode", "s4c"]
    (table, _), counts, frames, peak, wall = _run_logged(cli.main, argv)
    blocks = 256 * 256 * 32 // SSC_BLOCK
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "point_query": EVAL_FRAMES * blocks}
    stages = ("read_ms", "encode_ms", "query_ms", "accumulate_ms")
    print(f"phase 16b cli.evaluate_sscbench --mode s4c on phase 8a's tree ({EVAL_FRAMES} frames) with a seeded "
          f"S4C field (Monodepth2 d_out 64, head d_hidden 64, 19 logits): {json.dumps(table)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in stages} for r in frames])}; {wall:.1f} s wall, peak "
          f"{peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)})", flush=True)
    if not all(_in_unit(table[s].values()) for s in ("12.8", "25.6", "51.2")) or counts != expect:
        fail(f"the S4C evaluation is not finite in [0, 1] or launched {counts}, expected {expect}")

    sample = SSCBenchDataset(data_path=ssc_root, voxel_gt_path=os.path.join(ssc_root, "voxel_gt"))[0]
    frame = [torch.from_numpy(sample[k])[None].cuda() for k in ("imgs", "projs", "poses")]
    fs = cli.make_encode_fn(field, fast=True)(*frame)
    view = fast_field._single_view(fs, "phase 16b")
    pcfg = fast_field._point_config(field.cfg)
    pts = torch.from_numpy(S.generate_point_grid()[0]).cuda()
    block = pts.reshape(256, 256, 32, 3).permute(2, 0, 1, 3).reshape(-1, SSC_BLOCK, 3)[0].contiguous()
    kernels.reset_launches()
    sigma, feat = point_query(block, *view, pcfg)
    ref_s, ref_f = point_query_plain(block, *view, pcfg)
    d = torch.maximum((sigma - ref_s).abs(), (feat - ref_f).abs().amax(-1))
    size = torch.maximum(ref_s, ref_f.abs().amax(-1))
    err_abs, err_scaled = d.max().item(), (d / torch.clamp_min(size, 1.0)).max().item()
    probs_err = (torch.softmax(feat, -1) - torch.softmax(ref_f, -1)).abs().max().item()
    grid, w_code, b1, w2, b2, feat_w2c, feat_k = view
    ms = time_ms(lambda: point_query(block, *view, pcfg))
    plain_ms = time_ms(lambda: point_query_plain(block, *view, pcfg), reps=5)
    P, D, E, C = block.shape[0], grid.shape[-1], w2.shape[-1], w_code.shape[0]
    rows = grid_rows_read(block, grid, feat_w2c, feat_k)
    in_bytes = rows * D * 2 + nbytes(block, w_code, b1, w2, b2, feat_w2c, feat_k)
    b, by = bound_ms(2.0 * P * (C * D + D * E), in_bytes + P * 4 * E)
    print(f"phase 16b K4 point_query at the S4C field's block ({P} points, {grid.shape[0]}x{grid.shape[1]}x{D} bf16 "
          f"folded grid, d_out {E}: the (1, 1, 8) layout, 20 of its 72 output columns live): error over each point's "
          f"largest output (at least 1) {err_scaled:.3e} (bound {K4_TOL}), max abs {err_abs:.3e}, softmax "
          f"probabilities {probs_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} "
          f"distinct grid rows)", flush=True)
    if not err_scaled <= K4_TOL:
        fail("K4 at the S4C field's width disagrees with its plain version")
    del field, fs
    entry = {"points": P, "d_hidden": D, "d_out": E, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "max_abs_err": err_abs}
    return counts, entry


def phase_exact_crf(city_root, stage2_dir, scratch):
    """Phase 16c: cli.evaluate with apply_crf and crf_method exact on one
    frame of phase 8b's tree: the CRF rows and the exact CRF's host ms.
    Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli
    from scenedino_torch.utils.config import save_run_config

    conf = _eval_config(os.path.dirname(os.path.abspath(__file__)), stage2_dir, city_root)
    conf["downstream"].update(apply_crf=True, crf_method="exact")
    conf_dir = tempfile.mkdtemp(prefix="eval_config_exact_", dir=scratch)
    save_run_config(conf_dir, conf)
    out = []
    records, counts, peak, wall = _logged(lambda: out.append(cli.main(
        ["--config", conf_dir, "--ckpt", stage2_dir, "--max-frames", "1", "--device", "cuda"])))
    frames, crf = records.with_attr("frame_ms"), records.with_attr("crf_ms")
    depth = conf["model"]["encoder"].get("vit_overrides", {}).get("depth", 12)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": depth, "encode_view": 1}
    rows = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out[0].items() if isinstance(r, dict)}
    print(f"phase 16c cli.evaluate with apply_crf and crf_method exact (the permutohedral lattice on the host, "
          f"{os.cpu_count()} CPUs) on one frame of phase 8b's tree: CRF rows "
          f"{json.dumps({m: v for m, v in rows.items() if m.endswith('_crf')})}; the exact CRF of the frame's four "
          f"modes {[round(r.crf_ms, 1) for r in crf]} host ms, the frame {[round(r.frame_ms, 1) for r in frames]} ms; "
          f"{wall:.1f} s wall, peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)})",
          flush=True)
    if len(rows) != 8 or not all(_in_unit(r.values()) for r in rows.values()) or len(crf) != 1:
        fail(f"the exact CRF rows are missing or not finite in [0, 1]: {out[0]}")
    if counts != expect:
        fail(f"the exact-CRF evaluation launched {counts}, expected {expect}")
    return counts


def _render_depths(field, item, device):
    """Two 192x640 depth frames of one encoded image rendered by K2 (the
    identity camera and phase 4's novel camera), as camera z; with their
    pixel intrinsics, camera-to-world poses and colours."""
    from scenedino_torch.core.geometry import distance_to_z
    from scenedino_torch.ops.fast_field import build_fast_state, render_novel_view_fused

    img = torch.as_tensor(item["imgs"][:1])[None].to(device)
    k = torch.as_tensor(item["projs"][0]).to(device)
    h, w = img.shape[-2:]
    with torch.inference_mode():
        state = field.encode(img, k[None, None], torch.eye(4, device=device)[None, None], ids_encoder=(0,))
        fs = build_fast_state(field, state, compute_dtype=torch.bfloat16)
        frames = []
        for pose in (torch.eye(4, device=device), novel_pose(device)):
            u = torch.rand(h * w, K, generator=torch.Generator(device=device).manual_seed(len(frames)), device=device)
            depth, _, rgb = render_novel_view_fused(fs, field.cfg, pose, k, h, w, u=u, n_coarse=K)
            z = distance_to_z(depth.reshape(1, 1, h, w).float(), k[None, None])[0, 0]
            frames.append((z, pose, rgb.reshape(h, w, 3).float() * 255))
    # the normalized intrinsics (x_ndc = fx X / Z + cx on [-1, 1]) in pixels
    pix = torch.tensor([[k[0, 0] * w / 2, 0, (k[0, 2] + 1) * w / 2 - 0.5],
                        [0, k[1, 1] * h / 2, (k[1, 2] + 1) * h / 2 - 0.5], [0, 0, 1]])
    return [torch.stack(t) for t in zip(*frames)], pix


def phase_fusion(field, item, scratch):
    """Phase 16d: two depth frames rendered by K2 fused into a TSDF volume on
    the card and on the CPU: equal weights, TSDF within TSDF_TOL; a surface
    PLY. Returns the launches."""
    from scenedino_torch import kernels
    from scenedino_torch.eval import fusion

    kernels.reset_launches()
    (depths, poses, colors), pix = _render_depths(field, item, "cuda")
    counts = kernels.launches()
    cfg = fusion.TSDFVolumeConfig(TSDF_BOUNDS, TSDF_VOXEL)
    intrs = pix.expand(2, 3, 3)
    t0 = time.perf_counter()
    gpu = fusion.integrate_frames(cfg, depths, intrs.cuda(), poses, colors)
    torch.cuda.synchronize()
    gpu_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = fusion.integrate_frames(cfg, depths.cpu(), intrs, poses.cpu(), colors.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    w_equal = torch.equal(gpu.weight.cpu(), cpu.weight)
    seen = cpu.weight > 0
    tsdf_err = (gpu.tsdf.cpu() - cpu.tsdf).abs().max().item()
    ply = os.path.join(scratch, "surface.ply")
    n_vert, n_face = fusion.save_surface_ply(ply, gpu, cfg)
    print(f"phase 16d TSDF fusion of 2 depth frames rendered by K2 ({tuple(depths.shape[1:])}, z "
          f"{depths.min().item():.2f}-{depths.max().item():.2f} m) into a {cfg.vol_dim} volume of "
          f"{TSDF_VOXEL} m voxels: {int(seen.sum())} voxels observed ({int((cpu.weight == 2).sum())} by both frames); "
          f"the card against the CPU: weights equal {w_equal}, TSDF max abs difference {tsdf_err:.3e} (bound "
          f"{TSDF_TOL}); {gpu_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the CPU (host clocks); surface PLY "
          f"{n_vert} vertices, {n_face} faces, {os.path.getsize(ply)} bytes; launches {json.dumps(counts)}",
          flush=True)
    if not (w_equal and tsdf_err <= TSDF_TOL and seen.any() and n_face > 0):
        fail("the TSDF fusion on the card disagrees with the CPU, or observed nothing")
    return counts


def phase_eval_rest(seed, stage1_dir, stage2_dir, ssc_root, city_root, scratch):
    """Phase 16: evaluation, the rest. Returns (its launches, K4's entry at the S4C shape)."""
    t_phase = time.perf_counter()
    val_counts, field, item = phase_validator(seed, stage1_dir, scratch)
    s4c_counts, k4_s4c = phase_s4c(seed, ssc_root, scratch)
    crf_counts = phase_exact_crf(city_root, stage2_dir, scratch)
    fusion_counts = phase_fusion(field, item, scratch)
    parts = (val_counts, s4c_counts, crf_counts, fusion_counts)
    counts = {name: sum(p[name] for p in parts) for name in val_counts}
    print(f"phase 16 launches {json.dumps(counts)}; wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, k4_s4c


# phase 17: the sweep's cuts (trials, steps and validation items a trial, its
# learning-rate range), the multi-view step's head (MultiViewHead, an "ff"
# embedding to 64, 2 attention layers of 4 heads) over 2 encode views, the four
# head types at a small width on the card and on the CPU (fp32, TF32 off: the
# same sums in other orders through at most 3 attention layers and 2 residual
# blocks), the demo's grid (its sliders' default ranges, x and y +-10 m, z 0-20
# m, at 0.4 m: at their default 0.2 m the grid is 101^3 > MAX_VOXEL_COUNT and
# raises in both packages; at 0.2 m over y +-5 the PCA modes' host PCA of
# 452,344 occupied voxels took most of the phase), RAFT's iterations and the CPU's shape for RAFT and the pixelNeRF
# encoders, and their fp32 bounds over the largest output (RAFT: 12 recurrent
# updates of cuDNN against the CPU's convolutions)
SWEEP_TRIALS, SWEEP_STEPS, SWEEP_VAL_ITEMS, SWEEP_LR = 2, 3, 1, {"min": 1e-5, "max": 3e-4, "log": True}
MVH_ARGS = {"embedding_encoder": {"type": "ff", "d_out": 64}, "attn_layers": {"n_layers": 2, "n_heads": 4}}
MVH_HEADS = {
    "MultiViewHead": {"embedding_encoder": {"type": "pwf", "d_out": 32},
                      "attn_layers": {"n_layers": 2, "n_heads": 4, "IBRAttn": True},
                      "independent_token": {"type": "DataViewIndependentToken"}},
    "SimpleMultiViewHead": {"mlp": {"args": {"n_blocks": 2, "d_hidden": 32}}},
    "MultiViewHead2": {"mlp": {"args": {"n_blocks": 1, "d_hidden": 32}}, "mlp2": {"d_in": 16, "args": {
        "n_blocks": 1, "d_hidden": 32}}, "attn_layers": {"n_layers": 1, "n_heads": 4},
        "independent_token": {"type": "FixedViewIndependentToken"}},
    "MultiViewHead3": {"mlp": {"args": {"n_blocks": 2, "d_hidden": 32}}, "mlp2": {"d_in": 16, "args": {
        "n_blocks": 2, "d_hidden": 32}}},
}
MVH_POINTS, MVH_VIEWS, MVH_D_IN, MVH_TOL = 8192, 3, 55, 1e-4
DEMO_GRID = dict(x_range=10.0, y_range=10.0, z_range=20.0, resolution=0.4)
RAFT_ITERS, RAFT_SIZE, RAFT_TOL = 12, (128, 192), 1e-3
PIXELNERF_SIZE, PIXELNERF_TOL = (96, 320), 1e-4


def phase_sweep(seed, scratch, card):
    """Phase 17a: cli.sweep.run_sweep (random backend) over
    configs/train_synthetic_flagship.yaml at full width, SWEEP_TRIALS
    trials of SWEEP_STEPS steps and one validation each. Returns its launches."""
    from scenedino_torch.cli import sweep
    from scenedino_torch.utils import config as yaml_config

    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    out = tempfile.mkdtemp(prefix="sweep_", dir=scratch)
    conf["dataset"]["length"] = TRAIN_RUN_ITEMS
    conf["training"].update(stop_iteration=SWEEP_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = SWEEP_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": SWEEP_VAL_ITEMS}
    vconf["save_best"]["dry_run"] = True
    conf["output"]["path"] = out
    base = os.path.join(out, "base.yaml")
    with open(base, "w") as f:
        f.write(yaml_config.dumps(conf))
    spec = {"base": base, "trials": SWEEP_TRIALS, "stage": "nvs", "metric": "validation",
            "params": {"training.optimizer.args.lr": SWEEP_LR}}
    enc = conf["model"]["encoder"]
    print(f"phase 17a sweep: cli.sweep.run_sweep, random backend, seed {seed}, over "
          f"configs/train_synthetic_flagship.yaml read by scenedino_torch.utils.config, every width as the file gives "
          f"it ({enc['encoder_arch']} {enc['version']} student and teacher, {enc['image_size']}, batch "
          f"{conf['batch_size']}, {conf['dataset']['n_views']} views, with_amp {conf['with_amp']}); the lr drawn "
          f"{json.dumps(SWEEP_LR)}; cuts: trials 8 -> {SWEEP_TRIALS}, dataset.length 64 -> {TRAIN_RUN_ITEMS}, "
          f"stop_iteration {SWEEP_STEPS}, validation every 500 -> {SWEEP_STEPS} over subset 0-{SWEEP_VAL_ITEMS - 1} "
          f"(file: 0-7), save_best dry_run (no best checkpoint written), log_every 50 -> 1; {card}", flush=True)
    res = []
    _, counts, peak, wall = _logged(lambda: res.append(sweep.run_sweep(spec, seed=seed, device="cuda")), ())
    result = res[0]
    for t in result["trials"]:
        print(f"phase 17a trial {t['trial']}: lr {t['training.optimizer.args.lr']:.6e}, status {t['status']}, best "
              f"validation score (dino_cos_sim) {t['best']:.6f}; {card}", flush=True)
    depth = 12
    expect = {"attention": SWEEP_TRIALS * (SWEEP_STEPS * 3 * depth + SWEEP_VAL_ITEMS * 2 * depth),
              "attention_bwd_dq": SWEEP_TRIALS * SWEEP_STEPS * depth,
              "attention_bwd_dkv": SWEEP_TRIALS * SWEEP_STEPS * depth}
    k1 = {k: counts[k] for k in expect}
    print(f"phase 17a sweep: {wall:.1f} s wall ({SWEEP_TRIALS} model builds, {SWEEP_TRIALS * SWEEP_STEPS} steps, "
          f"{SWEEP_TRIALS} validations), peak memory allocated {peak:.2f} GiB; best trial {result['best']['trial']}; "
          f"K1 launches {json.dumps(k1)} (expected {json.dumps(expect)}); {card}", flush=True)
    if len(result["trials"]) != SWEEP_TRIALS or any(t["status"] not in ("complete", "pruned") or
                                                    not np.isfinite(t["best"]) for t in result["trials"]):
        fail(f"the sweep's trials did not all finish with a finite score: {result['trials']}")
    if k1 != expect or min(k1.values()) == 0:
        fail(f"the sweep launched {k1}, expected {expect}")
    return counts


def _mvh_inputs(gen, device):
    x = torch.randn(MVH_POINTS, MVH_VIEWS, MVH_D_IN, generator=gen).to(device)
    inv = (torch.rand(MVH_POINTS, MVH_VIEWS, generator=gen) < 0.3).to(device)
    return x, inv


def phase_multi_view(seed, card):
    """Phase 17b: one stage-1 step of the flagship field with a
    MultiViewHead over 2 encode views at 192x640 on the card (K1 forward,
    dq, dkv; finite loss, every head parameter a gradient); then the four
    head types at a small width on the card and on the CPU with the same
    weights (MVH_TOL). Returns the step's launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.models.heads import make_head
    from scenedino_torch.training import trainer
    from scenedino_torch.utils import config as yaml_config

    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    conf["model"]["decoder_heads"] = [{"type": "MultiViewHead", "name": "normal_head", "args": MVH_ARGS}]
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    tcfg = dataclasses.replace(tcfg, ids_encoder=(0, 1))
    torch.cuda.reset_peak_memory_stats()
    model = make_model(model_conf, device="cuda", seed=seed + 170, training=True)
    enc = model.encoder
    gp, depth = enc.gt_patch_size, enc.vit_encoder.vit.cfg.depth
    g = torch.Generator(device="cuda").manual_seed(seed + 171)
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.teacher.latent_size, H // gp, W // gp),
                                     generator=g)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    Bt = conf["batch_size"]
    batch = train_batch(g, Bt, H, W, "cuda")
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, 4, H, W, gp)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step(state, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    loss = float(losses["rec_loss"])
    head = {n: p for n, p in model.heads.named_parameters()}
    no_grad = [n for n, p in head.items() if p.grad is None or not bool((p.grad != 0).any())]
    expect = {"attention": 3 * depth, "attention_bwd_dq": depth, "attention_bwd_dkv": depth}
    k1 = {k: counts[k] for k in expect}
    print(f"phase 17b multi-view step: configs/train_synthetic_flagship.yaml's field (ViT-B/8, DPT 256, bf16, "
          f"remat) with decoder_heads MultiViewHead {json.dumps(MVH_ARGS)} ({sum(p.numel() for p in head.values())} "
          f"parameters), the student over encode views (0, 1), batch {Bt}, 4 views, {H}x{W}, "
          f"{tcfg.ray_batch_size} rays x {rcfg.n_coarse} samples: loss {loss:.6f}, {ms:.1f} ms (the first step), "
          f"peak memory allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, {len(head) - len(no_grad)} "
          f"of {len(head)} head tensors with a gradient; K1 launches {json.dumps(k1)} (expected {json.dumps(expect)})"
          f"; {card}", flush=True)
    if not np.isfinite(loss) or state.applied != 1:
        fail(f"the multi-view step gave loss {loss}, applied {state.applied}")
    if no_grad:
        fail(f"head parameters without a gradient: {no_grad}")
    if k1 != expect:
        fail(f"the multi-view step launched {k1}, expected {expect}")
    del model, state, step, batch

    gen = torch.Generator().manual_seed(seed + 172)
    x, inv = _mvh_inputs(gen, "cpu")
    errs = {}
    for kind, args in MVH_HEADS.items():
        torch.manual_seed(seed + 173)
        head_cpu = make_head({"type": kind, "args": args}, MVH_D_IN, 65)
        head_gpu = copy.deepcopy(head_cpu).cuda()
        with torch.no_grad():
            ref = head_cpu(x, invalid_features=inv)
            out = head_gpu(x.cuda(), invalid_features=inv.cuda()).cpu()
        errs[kind] = float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-12))
        if not torch.isfinite(out).all() or out.shape != (MVH_POINTS, 1, 65):
            fail(f"{kind} on the card: shape {tuple(out.shape)} or non-finite values")
    print(f"phase 17b the four head types ({MVH_POINTS} points x {MVH_VIEWS} views x {MVH_D_IN} channels -> 65, "
          f"~30 % of views invalid, fp32) on the card against the CPU, the same weights: max error over the largest "
          f"output {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (bound {MVH_TOL}); {card}",
          flush=True)
    if max(errs.values()) > MVH_TOL:
        fail(f"a multi-view head on the card disagrees with the CPU: {errs}")
    return counts


def phase_demo_gradio(seed, stage2_dir, scratch, card):
    """Phase 17c: cli.demo_gradio.demo_run with phase 7's run at 192x640 in
    each of the five modes; the voxel guard. Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import demo_gradio
    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.datasets.image_io import write_png
    from scenedino_torch.utils.config import load_run_config

    out = tempfile.mkdtemp(prefix="demo_gradio_", dir=scratch)
    png = os.path.join(out, "input.png")
    write_png(png, np.random.default_rng(seed + 174).integers(0, 256, (H, W, 3), dtype=np.uint8))
    field, head = eval_model(load_run_config(stage2_dir), stage2_dir, "cuda", (H, W))
    total = {name: 0 for name in kernels.WRAPPERS}
    t_phase = time.perf_counter()
    for mode in demo_gradio.MODES:
        res = []
        _, counts, peak, wall = _logged(lambda: res.append(demo_gradio.demo_run(
            field, head, png, mode=mode, image_size=(H, W), generator=torch.Generator(device="cuda").manual_seed(
                seed + 175), **DEMO_GRID)), ())
        vis, ply = res[0]
        with open(ply, "rb") as f:
            header = f.read(512).split(b"end_header\n")[0].decode()
        n_vert = int(next(line for line in header.splitlines() if line.startswith("element vertex")).split()[-1])
        print(f"phase 17c demo_run {mode!r} (phase 7's run, {H}x{W}, grid x +-{DEMO_GRID['x_range']:g}, y "
              f"+-{DEMO_GRID['y_range']:g}, z 0-{DEMO_GRID['z_range']:g} m at {DEMO_GRID['resolution']} m): panel "
              f"{vis.shape} {vis.dtype}, {n_vert // 8} occupied voxels ({os.path.getsize(ply)} PLY bytes), "
              f"{wall:.2f} s wall, peak memory allocated {peak:.2f} GiB, K1 launches {counts['attention']}; {card}",
              flush=True)
        if vis.shape != (H, W, 3) or vis.dtype != np.uint8 or counts["attention"] != 12:
            fail(f"demo_run in {mode!r}: panel {vis.shape} {vis.dtype}, launches {counts}")
        total = {k: total[k] + counts[k] for k in total}
    try:
        demo_gradio.demo_run(field, head, png, resolution=0.05, x_range=50.0, y_range=50.0, z_range=100.0,
                             image_size=(H, W))
    except ValueError as e:
        print(f"phase 17c the voxel guard: {e}; {card}", flush=True)
    else:
        fail("demo_run's voxel guard did not raise")
    print(f"phase 17c: the five modes in {time.perf_counter() - t_phase:.1f} s wall; {card}", flush=True)
    return total


def phase_raft_pixelnerf(seed, card):
    """Phase 17d: RAFT (RAFT_ITERS iterations) and both pixelNeRF encoders
    with seeded weights on the card and on the CPU, fp32."""
    from scenedino_torch.models.pixelnerf import ImageEncoder, SpatialEncoder
    from scenedino_torch.models.raft import RAFT

    gen = torch.Generator().manual_seed(seed + 176)
    img0 = torch.rand(1, 3, *RAFT_SIZE, generator=gen) * 2 - 1
    img1 = torch.roll(img0, 3, -1) * 0.95
    imgs = torch.rand(2, 3, *PIXELNERF_SIZE, generator=gen) * 2 - 1
    torch.manual_seed(seed + 177)
    models = {"RAFT": (RAFT(iters=RAFT_ITERS).eval(), (img0, img1), RAFT_TOL),
              "SpatialEncoder": (SpatialEncoder().eval(), (imgs,), PIXELNERF_TOL),
              "ImageEncoder": (ImageEncoder().eval(), (imgs,), PIXELNERF_TOL)}
    for name, (m, inputs, tol) in models.items():
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = m(*inputs)
            cpu_s = time.perf_counter() - t0
            gm = copy.deepcopy(m).cuda()
            out = gm(*(t.cuda() for t in inputs))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gm(*(t.cuda() for t in inputs))
            torch.cuda.synchronize()
            gpu_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(ref, list):
            ref, out = ref[0], out[0]
        err = float((out.cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-12))
        print(f"phase 17d {name} ({'%d iterations, ' % RAFT_ITERS if name == 'RAFT' else ''}input "
              f"{tuple(inputs[0].shape)}, output {tuple(out.shape)}, largest |output| {float(ref.abs().max()):.4g}): "
              f"the card against the CPU, fp32, max error over the largest output {err:.3e} (bound {tol}); card "
              f"{gpu_ms:.2f} ms warm, CPU {cpu_s:.2f} s; {card}", flush=True)
        if not torch.isfinite(out).all() or err > tol:
            fail(f"{name} on the card disagrees with the CPU: {err:.3e} > {tol}")


def phase_port_rest(seed, stage2_dir, scratch):
    """Phase 17: the port's last slice. Returns its launches."""
    from scenedino_torch.utils.timing import card_line

    card = card_line()
    t_phase = time.perf_counter()
    parts = (phase_sweep(seed, scratch, card), phase_multi_view(seed, card),
             phase_demo_gradio(seed, stage2_dir, scratch, card))
    phase_raft_pixelnerf(seed, card)
    counts = {name: sum(p[name] for p in parts) for name in parts[0]}
    wall = time.perf_counter() - t_phase
    print(f"phase 17 launches {json.dumps(counts)}; wall time {wall:.1f} s (target 120 s); {card}", flush=True)
    return counts


# phase 18: every shape the JAX package takes. 18a: the flagship serving model's
# render_novel_view_fused at these samples a ray (tests/
# test_probe_quality_trained.py renders at 128, tests/test_probe_quality.py and
# tools/probe_quality_trained.py at 256) and render_novel_view_probe at this
# n_probe; 18b: render_encode_view at LONG_K6 samples and, on a field of
# num_freqs LONG_FREQS (17 z-code columns), at 32; 18c: the ViT of the smoke
# recipe's vit_overrides (width 64, depth 3, 2 heads: head dim 32) in bf16 at
# 192x640 (1921 tokens, so the card takes K1), one stage-1 step of a batch of
# ANY_STEP_B on the card and on the CPU (phase 5's bounds), and K1 at ANY_SHAPES
# (head dim 32 at the step's shape; 96, where a third of the last tile is zero
# columns; 128; 256, the widest) against its plain version and SDPA, and at
# ANY_UNALIGNED (a head dim the wrappers pad to a multiple of 8) against its
# plain version; 18d: phase 11a's 16 scaled-keys cases at both shipped head
# dims, each within K1_TOL
LONG_RAYS = (128, 256)
LONG_PROBE = 96
LONG_K6, LONG_FREQS = 128, 8
ANY_STEP_B = 1
ANY_SHAPES = ((2, 1921, 2, 32), (2, 1921, 4, 96), (2, 1921, 6, 128), (2, 1921, 2, 256))
ANY_UNALIGNED = (2, 130, 3, 20)


def _driven(fn):
    """`fn()` with the launch counts zeroed just before and read just after:
    (its result, the counts)."""
    from scenedino_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launches()


def _expect_launches(name, counts, expect):
    from scenedino_torch import kernels

    want = {**{k: 0 for k in kernels.WRAPPERS}, **expect}
    if counts != want:
        fail(f"{name} did not run through its kernels: launches {counts}, expected {want}")


def _median_rule(z, got, ref):
    """The weight-median depth rule of phase 3: on a sample depth, the plain
    version's sample or its neighbour on at most K2_MEDIAN_FLIPS of rays.
    Returns (holds, share of rays off the plain version's sample)."""
    k_idx = (z - got[:, None]).abs().argmin(-1)
    p_idx = (z - ref[:, None]).abs().argmin(-1)
    flips = (k_idx != p_idx).float().mean().item()
    holds = (torch.equal(z.gather(1, k_idx[:, None])[:, 0], got) and (k_idx - p_idx).abs().max().item() <= 1
             and flips <= K2_MEDIAN_FLIPS)
    return holds, flips


def phase_long_rays(seed):
    """Phase 18a: render_novel_view_fused at LONG_RAYS samples a ray, both
    depth statistics, and render_novel_view_probe at n_probe LONG_PROBE, on
    the flagship serving model (bf16); each driven through its entry point
    alone, then its K2 / K3 launch against the plain version on the same
    inputs. Returns (the launches, K2's and K3's shape entries)."""
    from scenedino_torch.core import sampling
    from scenedino_torch.kernels.point_render import (
        point_render,
        point_render_plain,
        probe_weights,
        probe_weights_plain,
    )
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.utils.timing import time_ms

    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1800)
    img = torch.rand(1, 1, 3, H, W, generator=gen, device="cuda") * 2 - 1
    with torch.inference_mode():
        fs = ff.encode_prefolded(model, img, *cameras_of("cuda"))
    pose, kmat = novel_pose("cuda"), intrinsics("cuda")
    field, colour = ff._single_view(fs, "phase 18a"), ff._colour_view(fs)
    flat = ff._target_rays(model.cfg, pose, kmat, H, W).reshape(-1, 8).contiguous()
    grid, w_code, b1, w2, b2 = field[:5]
    D, E, C = grid.shape[-1], w2.shape[-1], w_code.shape[0]
    total, k2_shapes = {}, {}

    def add(counts):
        for k_, n in counts.items():
            total[k_] = total.get(k_, 0) + n

    for Kr in LONG_RAYS:
        u = torch.rand(H * W, Kr, generator=gen, device="cuda")
        z = sampling.sample_coarse(flat, Kr, True, u=u).contiguous()
        args = (flat, z, *field, *colour)
        entry = {}
        for stat in ("expectation", "median"):
            (depth, dino, rgb), counts = _driven(lambda: ff.render_novel_view_fused(
                fs, model.cfg, pose, kmat, H, W, u=u, n_coarse=Kr, depth_statistic=stat))
            _expect_launches(f"render_novel_view_fused at {Kr} samples ({stat})", counts, {"point_render": 1})
            add(counts)
            if stat == "expectation":
                check_depth(f"render_novel_view_fused at {Kr} samples", depth, dino, rgb)
            pcfg = ff._point_config(model.cfg, True, stat)
            out = point_render(*args, pcfg)
            torch.cuda.synchronize()
            if not all(torch.equal(a.reshape(b.shape), b) for a, b in zip((depth, dino, rgb), out)):
                fail(f"render_novel_view_fused at {Kr} samples ({stat}) is not its K2 launch")
            ref = point_render_plain(*args, pcfg)
            errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
            if stat == "median":
                holds, flips = _median_rule(z, out[0], ref[0])
                entry["median_flips"] = flips
                ok = holds and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL
            else:
                ok = errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL
                entry["max_abs_err"] = max(errs)
            print(f"phase 18a render_novel_view_fused at {Kr} samples a ray ({H}x{W}, {stat}; {-(-Kr // 64)} of K2's "
                  f"64-point tiles a ray): launches {json.dumps({k_: n for k_, n in counts.items() if n})}; K2 "
                  f"against its plain version: depth {errs[0]:.3e}, feature {errs[1]:.3e}, rgb {errs[2]:.3e}"
                  + (f", rays off the plain version's median sample {flips:.3e} (bound {K2_MEDIAN_FLIPS})"
                     if stat == "median" else ""), flush=True)
            if not ok or not all(bool(torch.isfinite(o).all()) for o in out):
                fail(f"K2 at {Kr} samples ({stat}) disagrees with its plain version: {errs}")
        pcfg = ff._point_config(model.cfg)
        ms = time_ms(lambda: point_render(*args, pcfg), reps=5)
        plain_ms = time_ms(lambda: point_render_plain(*args, pcfg), reps=3, warmup=1)
        R = flat.shape[0]
        rows = grid_rows_read(_ray_points(flat, z), grid, *field[5:7])
        b, by = bound_ms(2.0 * R * Kr * (C * D + D * E),
                         rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * (1 + (E - 1) + 3) * 4)
        print(f"phase 18a K2 point_render ({R} rays x {Kr}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b:.4f} ms ({by}; {rows} distinct grid rows read); {corner_traffic(R * Kr, D)}", flush=True)
        k2_shapes[f"{Kr} samples"] = {"rays": R, "samples": Kr, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                                      "bound_by": by, **entry}

    # the probe at n_probe LONG_PROBE: K3 over two tiles a probe ray
    draws = ff.draw_probe(H, W, gen, "cuda", n_probe=LONG_PROBE)
    (depth, dino, rgb), counts = _driven(lambda: ff.render_novel_view_probe(
        fs, model.cfg, pose, kmat, H, W, draws=draws, n_probe=LONG_PROBE))
    _expect_launches(f"render_novel_view_probe at n_probe {LONG_PROBE}", counts,
                     {"probe_weights": 1, "row_gather": 1, "point_render": 1})
    add(counts)
    check_depth(f"render_novel_view_probe at n_probe {LONG_PROBE}", depth, dino, rgb)
    rays = flat.reshape(H, W, 8)[::4, ::4].reshape(-1, 8).contiguous()
    zp = sampling.sample_coarse(rays, LONG_PROBE, True, u=draws.u_probe).contiguous()
    args = (rays, zp, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), *field[5:7])
    pcfg = ff._point_config(model.cfg)
    w_probe = probe_weights(*args, pcfg)
    torch.cuda.synchronize()
    err = (w_probe - probe_weights_plain(*args, pcfg)).abs().max().item()
    ms = time_ms(lambda: probe_weights(*args, pcfg), inner=10)
    plain_ms = time_ms(lambda: probe_weights_plain(*args, pcfg), reps=3, warmup=1)
    R = rays.shape[0]
    rows = grid_rows_read(_ray_points(rays, zp), grid, *field[5:7])
    b, by = bound_ms(2.0 * R * LONG_PROBE * (C * D + D), rows * D * 2 + nbytes(*args[:2], *args[3:])
                     + R * LONG_PROBE * 4)
    print(f"phase 18a render_novel_view_probe at n_probe {LONG_PROBE} ({H}x{W}): launches "
          f"{json.dumps({k_: n for k_, n in counts.items() if n})}; K3 ({R} probe rays x {LONG_PROBE}, two 64-point "
          f"tiles a ray) against its plain version: weights {err:.3e} (bound {K3_TOL}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct grid rows read)", flush=True)
    if not (err <= K3_TOL and bool(torch.isfinite(w_probe).all())):
        fail(f"K3 at {LONG_PROBE} samples disagrees with its plain version: {err}")
    k3_shape = {f"n_probe {LONG_PROBE}": {"rays": R, "samples": LONG_PROBE, "max_abs_err": err, "ms": ms,
                                          "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}}
    return total, k2_shapes, k3_shape


def phase_long_encode_view(seed):
    """Phase 18b: render_encode_view of the flagship serving model at LONG_K6
    samples a ray, and of the same model at num_freqs LONG_FREQS (17 z-code
    columns) at 32, each through its entry point alone, then its K6 launch
    against the plain version on the same inputs, both depth statistics.
    Returns (the launches, K6's shape entries)."""
    from scenedino_torch.kernels.encode_view import encode_view, encode_view_plain
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.tools import bench_encode_view as bev
    from scenedino_torch.utils.timing import time_ms

    total, shapes = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1810)
    img = torch.rand(1, 1, 3, H, W, generator=gen, device="cuda") * 2 - 1
    for name, Kr, freqs in ((f"{LONG_K6} samples", LONG_K6, 6), (f"num_freqs {LONG_FREQS}", K, LONG_FREQS)):
        conf = {**SCENEDINO_KITTI_360, "code": {**SCENEDINO_KITTI_360["code"], "num_freqs": freqs}}
        conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
        model = make_model(conf, device="cuda", seed=seed)
        with torch.inference_mode():
            fs = ff.encode_prefolded(model, img, *cameras_of("cuda"))
        u = torch.rand(H * W, Kr, generator=gen, device="cuda")
        args, ecfg = ff.encode_view_inputs(fs, model.cfg, H, W, u=u[None], n_coarse=Kr)
        entry = {"samples": Kr, "code_columns": ecfg.code_dims}
        for stat in ("expectation", "median"):
            (depth, dino, rgb), counts = _driven(lambda: ff.render_encode_view(
                fs, model.cfg, H, W, u=u, n_coarse=Kr, depth_statistic=stat))
            _expect_launches(f"render_encode_view ({name}, {stat})", counts, {"encode_view": 1})
            for k_, n in counts.items():
                total[k_] = total.get(k_, 0) + n
            if stat == "expectation":
                check_depth(f"render_encode_view ({name})", depth, dino, rgb)
            scfg = dataclasses.replace(ecfg, depth_statistic=stat)
            out = encode_view(*args, scfg)
            torch.cuda.synchronize()
            if not all(torch.equal(a.reshape(b.shape), b) for a, b in zip((depth, dino, rgb), out)):
                fail(f"render_encode_view ({name}, {stat}) is not its K6 launch")
            ref = encode_view_plain(*args, scfg)
            errs = {n_: (o - r).abs().max().item() for n_, o, r in zip(("depth", "feature", "rgb"), out, ref)}
            tol = bev.TOL[torch.bfloat16]
            if stat == "median":
                holds, flips = _median_rule(args[1], out[0], ref[0])
                ok = holds and errs["feature"] <= tol["feature"] and errs["rgb"] <= tol["rgb"]
                entry["median_flips"] = flips
            else:
                ok = all(errs[n_] <= tol[n_] for n_ in tol)
                entry["max_abs_err"] = max(errs.values())
            print(f"phase 18b render_encode_view ({name}: {H}x{W} rays x {Kr} samples, {ecfg.code_dims} z-code "
                  f"columns, {stat}): launches {json.dumps({k_: n for k_, n in counts.items() if n})}; K6 against "
                  f"its plain version {json.dumps(errs)} (bounds {json.dumps(tol)})"
                  + (f", rays off the plain version's median sample {flips:.3e}" if stat == "median" else ""),
                  flush=True)
            if not ok or not all(bool(torch.isfinite(o).all()) for o in out):
                fail(f"K6 ({name}, {stat}) disagrees with its plain version: {errs}")
        ms = time_ms(lambda: encode_view(*args, ecfg), reps=5)
        plain_ms = time_ms(lambda: encode_view_plain(*args, ecfg), reps=3, warmup=1)
        b, by = bev.bound(args, torch.bfloat16)
        print(f"phase 18b K6 encode_view ({name}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms "
              f"({by})", flush=True)
        shapes[name] = {**entry, "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}
    return total, shapes


def k1_any_shape(gen, B, N, Hh, D, timed=True, phase="phase 18c"):
    """K1 at head dim D through csrc/attention_any.cu (past 256:
    csrc/attention_wide.cu): the forward (with the log-sum-exp), dq and dkv
    against the plain versions, two launches bitwise equal; where `timed`,
    kernel, plain, SDPA and bound times (CUDA events, and the kernels' device
    time by the profiler: at these grids SDPA's events read its host) and the
    SDPA backend that ran; the shape's entry."""
    from scenedino_torch.kernels.attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_fwd,
        attention_lse_plain,
        attention_plain,
        route,
    )
    from scenedino_torch.tools.bench_attention_wide import backend_of
    from scenedino_torch.utils.timing import _kernel_times, device_ms, ms_text, time_ms

    q, k, v, do = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, out, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = (attention_fwd(q, k, v)[0], attention_bwd_dq(q, k, v, out, do, lse)[0],
             *attention_bwd_dkv(q, k, v, do, lse, di))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, dq, dk, dv), again)):
        fail(f"K1 at head dim {D} ({B}, {N}, {Hh}): two launches on the same inputs differ")
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
    errs, bounds = [], []
    for got, r in zip((dq, dk, dv), attention_bwd_plain(q, k, v, out, do, lse)):
        errs.append((got.float() - r.float()).abs().max().item())
        bounds.append(K1_BWD_REL * r.float().abs().max().item() + 1e-3)
    if not (err <= K1_TOL and lse_err <= K1_LSE_TOL and all(e <= b_ for e, b_ in zip(errs, bounds))
            and all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))):
        fail(f"K1 at head dim {D} ({B}, {N}, {Hh}) disagrees with its plain versions: out {err}, lse {lse_err}, "
             f"dq dk dv {errs} (bounds {bounds})")
    key, width, pd = route(D)
    entry = {"shape": [B, N, Hh, D], "max_abs_err": err, "lse_err": lse_err, "bwd_errs": errs}
    text = (f"{phase} K1 at head dim {D} ({B}, {N}, {Hh}, {D}) bf16 (csrc/attention_{key}.cu, handed {width} "
            f"columns, computing at {pd}): max_abs_err out {err:.3e} (bound {K1_TOL}), lse {lse_err:.3e}, dq "
            f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (bounds {[round(x, 5) for x in bounds]}); two "
            f"launches bitwise equal")
    if not timed:
        print(text, flush=True)
        return entry
    ms = time_ms(lambda: attention_fwd(q, k, v), inner=10)
    ms_dq = time_ms(lambda: attention_bwd_dq(q, k, v, out, do, lse), inner=5)
    ms_dkv = time_ms(lambda: attention_bwd_dkv(q, k, v, do, lse, di), inner=5)
    plain_ms = time_ms(lambda: attention_plain(q, k, v), reps=5)
    plain_bwd_ms = time_ms(lambda: attention_bwd_plain(q, k, v, out, do, lse), reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    sd = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(sd, (qt, kt, vt), dot, retain_graph=True), inner=5)
    # the kernels alone (torch.profiler), as phase 11a times the D = 80 ones; more
    # windows than its default (once the profiler saw no kernel of these in three)
    dev_ms = device_ms(lambda: attention_fwd(q, k, v), calls=20, tries=6)
    dev_bwd_ms = device_ms(lambda: (attention_bwd_dq(q, k, v, out, do, lse), attention_bwd_dkv(q, k, v, do, lse, di)),
                           calls=20, tries=6)
    lib_dev_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), calls=20, tries=6)
    lib_bwd_dev_ms = device_ms(lambda: torch.autograd.grad(sd, (qt, kt, vt), dot, retain_graph=True))
    backend = backend_of(_kernel_times(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))[0])
    if lib_bwd_dev_ms is not None and lib_dev_ms is not None and lib_bwd_dev_ms < lib_dev_ms:
        # the window saw part of the backward's kernels (twenty-call windows did so here at three of
        # four shapes, twice): SDPA's backward recomputes its forward's products, so it is not faster
        lib_bwd_dev_ms = None
    unit = 2.0 * B * Hh * N * N * D
    t_bytes, s_bytes = B * N * Hh * D * 2, B * Hh * N * 4
    b, by = bound_ms(2 * unit, 4 * t_bytes)
    b_dq, by_dq = bound_ms(3 * unit, 6 * t_bytes + 2 * s_bytes)
    b_dkv, by_dkv = bound_ms(4 * unit, 6 * t_bytes + 2 * s_bytes)
    exp_ms = B * Hh * N * N / PEAK_EXP2 * 1e3  # one exp2 a logit, each kernel
    print(f"{text}; forward {ms:.4f} ms (device {ms_text(dev_ms)}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
          f"(device {ms_text(lib_dev_ms)}; {backend}), bound {b:.4f} ms ({by}; the exp2 {exp_ms:.4f} ms); dq {ms_dq:.4f} ms "
          f"(bound {b_dq:.4f}, {by_dq}), dkv {ms_dkv:.4f} ms (bound {b_dkv:.4f}, {by_dkv}), dq + dkv device "
          f"{ms_text(dev_bwd_ms)}, plain backward {plain_bwd_ms:.4f} ms, sdpa backward {lib_bwd_ms:.4f} ms (device "
          f"{ms_text(lib_bwd_dev_ms)})", flush=True)
    return {**entry, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "exp2_ms": exp_ms, "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "ms_dq": ms_dq,
            "ms_dkv": ms_dkv, "bwd_device_ms": dev_bwd_ms, "plain_bwd_ms": plain_bwd_ms, "library_bwd_ms": lib_bwd_ms,
            "library_bwd_device_ms": lib_bwd_dev_ms, "library_backend": backend, "bound_dq_ms": b_dq, "bound_dq_by": by_dq,
            "bound_dkv_ms": b_dkv, "bound_dkv_by": by_dkv}


def phase_any_head_dim(seed):
    """Phase 18c: the smoke recipe's ViT (head dim 32) in bf16 at 192x640, one
    stage-1 step on the card (K1's forward, dq and dkv at head dim 32,
    counted) and the same step on the CPU; then K1 at ANY_SHAPES against the
    plain versions and SDPA, and at ANY_UNALIGNED against the plain versions.
    Returns (the step's launches, the three kernels' entries)."""
    from scenedino_torch.models.factory import SYNTHETIC_SMOKE_TRAIN, make_model
    from scenedino_torch.training import trainer

    conf = copy.deepcopy(SYNTHETIC_SMOKE_TRAIN)
    conf["dataset"]["image_size"] = (H, W)
    conf["model"]["encoder"].update(image_size=(H, W), dtype="bfloat16")
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    vit, gp = enc.vit_encoder.vit, enc.gt_patch_size
    blocks, t_blocks = vit.cfg.depth, enc.gt_encoder.vit.cfg.depth
    V = conf["dataset"]["n_views"]
    gc = torch.Generator().manual_seed(seed + 1820)
    batch = train_batch(gc, ANY_STEP_B, H, W, "cpu")
    draws = trainer.draw_stage1(gc, tcfg, rcfg, ANY_STEP_B, V, H, W, gp)
    art = 1e-3 * torch.randn(enc.gt_encoder.latent_size, H // gp, W // gp, generator=gc)

    def one_step(m, device):
        m.zero_grad(set_to_none=True)
        a = art.to(device).requires_grad_(True)
        d = dataclasses.replace(draws, **{f: getattr(draws, f).to(device) for f in ("pv", "py", "px", "u")})
        loss, _ = trainer.stage1_forward(m, {k_: v.to(device) for k_, v in batch.items()}, d, tcfg, rcfg, lcfg, a)
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters() if p.grad is not None}
        grads["artifact_field"] = a.grad.float().cpu()
        return loss.item(), grads

    t0 = time.perf_counter()
    (gpu_loss, gpu_grads), counts = _driven(lambda: one_step(model, "cuda"))
    gpu_ms = (time.perf_counter() - t0) * 1e3
    _expect_launches("the head-dim-32 stage-1 step", counts, {"attention_any": blocks + t_blocks,
                                                              "attention_any_bwd_dq": blocks,
                                                              "attention_any_bwd_dkv": blocks})
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = one_step(copy.deepcopy(model).to("cpu"), "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if sorted(gpu_grads) != sorted(cpu_grads):
        fail("the GPU and CPU head-dim-32 steps gave gradients to different parameters")
    errs = {n: (torch.linalg.vector_norm(gpu_grads[n] - r) / torch.linalg.vector_norm(r)).item()
            for n, r in cpu_grads.items() if torch.linalg.vector_norm(r) > 0}
    worst = max(errs, key=errs.get)
    tokens = 1 + (H // vit.cfg.patch_size) * (W // vit.cfg.patch_size)
    print(f"phase 18c the smoke recipe's ViT in bf16 at {H}x{W} (width {vit.cfg.width}, depth {blocks}, "
          f"{vit.cfg.num_heads} heads of {vit.cfg.width // vit.cfg.num_heads}, {tokens} tokens), one stage-1 step "
          f"of batch {ANY_STEP_B}, {V} views: launches {json.dumps({k_: n for k_, n in counts.items() if n})}; "
          f"loss {gpu_loss:.6f} on the card ({gpu_ms:.0f} ms, the kernels' first launches included) vs "
          f"{cpu_loss:.6f} on the CPU ({cpu_ms:.0f} ms), rel err {loss_rel:.3e} (bound {TRAIN_LOSS_REL}); gradients "
          f"of {len(errs)} tensors, relative L2 error median {float(np.median(list(errs.values()))):.3e}, worst "
          f"{errs[worst]:.3e} ({worst}; bound {TRAIN_GRAD_REL})", flush=True)
    if not (np.isfinite(gpu_loss) and loss_rel <= TRAIN_LOSS_REL and errs[worst] <= TRAIN_GRAD_REL):
        fail("the head-dim-32 training step on the card disagrees with the CPU")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1830)
    shapes = [k1_any_shape(gen, *shape) for shape in ANY_SHAPES]
    shapes.append(k1_any_shape(gen, *ANY_UNALIGNED, timed=False))
    main = shapes[0]
    # the device times beside the event times: at these grids the events read the host
    common = {"route": "cuda", "source": "scenedino_torch/csrc/attention_any.cu",
              **{k_: main[k_] for k_ in ("device_ms", "library_device_ms", "bwd_device_ms", "library_bwd_device_ms")},
              "shapes": shapes}
    entries = [
        {"name": "attention_any", "replaces": "scenedino_tpu/models/vit.py:126",
         "max_abs_err": max(e["max_abs_err"] for e in shapes),
         **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, **common},
        {"name": "attention_any_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "max_abs_err": max(e["bwd_errs"][0] for e in shapes), "ms": main["ms_dq"], "plain_ms": main["plain_bwd_ms"],
         "bound_ms": main["bound_dq_ms"], "bound_by": main["bound_dq_by"], "library_ms": main["library_bwd_ms"],
         **common},
        {"name": "attention_any_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "max_abs_err": max(max(e["bwd_errs"][1:]) for e in shapes), "ms": main["ms_dkv"],
         "plain_ms": main["plain_bwd_ms"], "bound_ms": main["bound_dkv_ms"], "bound_by": main["bound_dkv_by"],
         "library_ms": main["library_bwd_ms"], **common},
    ]
    return counts, entries


def phase_scaled_sweep():
    """Phase 18d: item C of ROADMAP queue 3 with the shipped build (the exact
    rescale): phase 11a's 16 scaled-keys cases at head dims 64 and 80, each
    forward and SDPA against the fp32 plain version rounded to bf16, every
    forward within K1_TOL."""
    from scenedino_torch.kernels.attention import attention_fwd, attention_plain

    summary, worst = {}, 0.0
    for D in (64, 80):
        rows = []
        for b, n, h in SCALED_SWEEP:
            for seed in (200 + n,) + SCALED_SEEDS:
                q, k, v = _scaled_keys(b, n, h, D, seed)
                plain = attention_plain(q, k, v).float()
                sdpa = torch.nn.functional.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
                rows.append(((attention_fwd(q, k, v)[0].float() - plain).abs().max().item(),
                             (sdpa.transpose(1, 2).float() - plain).abs().max().item()))
        summary[f"D{D}"] = {"cases": len(rows), "max": max(r[0] for r in rows),
                            "above SDPA": sum(r[0] > r[1] for r in rows),
                            "above 1.5625e-2": sum(r[0] > 1.5625e-2 for r in rows),
                            "SDPA max": max(r[1] for r in rows)}
        worst = max(worst, summary[f"D{D}"]["max"])
    print(f"phase 18d scaled keys, the shipped build (exact rescale), 16 cases a head dim ({list(SCALED_SWEEP)} x "
          f"seeds 200 + N, {list(SCALED_SEEDS)}), against the fp32 plain version rounded to bf16: "
          f"{json.dumps(summary)} (bound {K1_TOL} every case)", flush=True)
    if not worst <= K1_TOL:
        fail(f"a K1 forward on scaled keys reads {worst} against its plain version (bound {K1_TOL})")
    return summary


def phase_every_shape(seed):
    """Phase 18: every shape the JAX package takes. Returns (the launches of
    its paths, the shape entries of K2, K3 and K6, the entries of K1 at every
    other head dim)."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    serving, k2_shapes, k3_shape = phase_long_rays(seed)
    encode, k6_shapes = phase_long_encode_view(seed)
    step, any_entries = phase_any_head_dim(seed)
    phase_scaled_sweep()
    counts = {k_: serving.get(k_, 0) + encode.get(k_, 0) + step.get(k_, 0) for k_ in serving}
    print(f"phase 18 launches {json.dumps(counts)}; wall time {time.perf_counter() - t_phase:.1f} s (target 30 s); "
          f"{card_line()}", flush=True)
    return counts, {"point_render": k2_shapes, "probe_weights": k3_shape, "encode_view": k6_shapes}, any_entries


# phase 19: the field kernels at every width the JAX package takes. 19a: the
# flagship (SCENEDINO_KITTI_360, ViT-B/8, DPT 256, bf16 encoder) with its head
# widened to WIDE_HEAD (E = 769, 99 point-code and 33 z-code columns),
# WIDE_REQUESTS seeded requests through each serving path and one fp32-fold
# encode view; 19b: seeded fields of WIDE_OTHERS' widths (d_hidden, d_out,
# num_freqs), each kernel against its plain version, and on the shipped
# flagship widths K2 and K6 at WIDE_SAMPLES samples a ray and K3 at
# WIDE_PROBE probe samples; 19c: the times of each new shape beside its plain
# version's and its bound
WIDE_HEAD = {"d_hidden": 512, "dino_dims": 768, "num_freqs": 16}
WIDE_REQUESTS = 3
WIDE_OTHERS = (("E 129", 256, 129, 6), ("D 132", 132, 65, 6), ("69 code columns", 128, 65, 11))
WIDE_SAMPLES = 512
WIDE_PROBE = 320


def wide_model(seed, d_hidden, dino_dims, num_freqs):
    """The flagship serving model (bf16 encoder) with its head's widths."""
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model

    conf = {**SCENEDINO_KITTI_360, "dino_dims": dino_dims,
            "code": {**SCENEDINO_KITTI_360["code"], "num_freqs": num_freqs},
            "decoder_heads": [{"type": "resnet", "name": "normal_head",
                               "args": {"n_blocks": 0, "d_hidden": d_hidden}}]}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    return make_model(conf, device="cuda", seed=seed)


def wide_field(gen, D, E, C, dev="cuda"):
    """flagship_field's seeded draws at other widths: a 384x1280xD bf16 grid,
    W_code CxD, W2 DxE."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    grid = randn(2 * H, 2 * W, D).to(torch.bfloat16)
    w_code = randn(C, D, scale=C ** -0.5).to(torch.bfloat16)
    b1 = randn(D, scale=0.1)
    w2 = randn(D, E, scale=D ** -0.5).to(torch.bfloat16)
    b2 = randn(E, scale=0.1)
    b2[0] += 0.5
    return grid, w_code, b1, w2, b2


def _entry(tag, errors, fn, plain, flops, nbytes_, **info):
    """19c: the shape's kernel, plain and bound times (CUDA events; the plain
    version fewer times) and its entry."""
    from scenedino_torch.utils.timing import time_ms

    ms = time_ms(fn, reps=5)
    plain_ms = time_ms(plain, reps=2, warmup=1)
    b, by = bound_ms(flops, nbytes_)
    print(f"phase 19c {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by})", flush=True)
    return {**info, "max_abs_err": max(errors.values()), "errors": errors, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by}


def wide_k2(tag, args, cfg):
    """K2 against its plain version (phase 3's bounds and median rule); the entry with its times."""
    from scenedino_torch.kernels.point_render import point_render, point_render_plain

    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    errs = {n: (o - r).abs().max().item() for n, o, r in zip(("depth", "feature", "rgb"), out, ref)}
    ok = all(bool(torch.isfinite(o).all()) for o in out) and errs["feature"] <= K2_FEAT_TOL and errs["rgb"] <= K2_RGB_TOL
    extra = {}
    if cfg.depth_statistic == "median":
        holds, extra["median_flips"] = _median_rule(args[1], out[0], ref[0])
        ok = ok and holds
    else:
        ok = ok and errs["depth"] <= K2_DEPTH_TOL
    (R, Kr), (D, E), C = args[1].shape, args[5].shape, args[3].shape[0]
    print(f"phase 19 K2 {tag} ({R} rays x {Kr}, D {D}, E {E}, {C} code columns, {cfg.depth_statistic}) against its "
          f"plain version: {json.dumps(errs)} (bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})"
          + (f", rays off the plain version's median sample {extra['median_flips']:.3e}" if extra else ""), flush=True)
    if not ok:
        fail(f"K2 {tag} disagrees with its plain version: {errs} {extra}")
    rows = grid_rows_read(_ray_points(*args[:2]), args[2], *args[7:9])
    return _entry(f"K2 {tag}", errs, lambda: point_render(*args, cfg), lambda: point_render_plain(*args, cfg),
                  2.0 * R * Kr * (C * D + D * E), rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * (E + 3) * 4,
                  rays=R, samples=Kr, d_hidden=D, d_out=E, code_columns=C, depth_statistic=cfg.depth_statistic,
                  grid_rows_read=rows, **extra)


def wide_k3(tag, args, cfg):
    from scenedino_torch.kernels.point_render import probe_weights, probe_weights_plain

    out = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    err = (out - probe_weights_plain(*args, cfg)).abs().max().item()
    (R, Kr), D, C = args[1].shape, args[2].shape[-1], args[3].shape[0]
    print(f"phase 19 K3 {tag} ({R} rays x {Kr}, D {D}, {C} code columns) against its plain version: weights "
          f"{err:.3e} (bound {K3_TOL})", flush=True)
    if not (err <= K3_TOL and bool(torch.isfinite(out).all())):
        fail(f"K3 {tag} disagrees with its plain version: {err}")
    rows = grid_rows_read(_ray_points(*args[:2]), args[2], *args[7:9])
    return _entry(f"K3 {tag}", {"weights": err}, lambda: probe_weights(*args, cfg),
                  lambda: probe_weights_plain(*args, cfg), 2.0 * R * Kr * (C * D + D),
                  rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * Kr * 4, rays=R, samples=Kr, d_hidden=D,
                  code_columns=C, grid_rows_read=rows)


def wide_k4(tag, args, cfg):
    """K4 against its plain version under phase 3c's rule: in [z_near, z_far]
    and over each point's largest output (at least 1), each within K4_TOL."""
    from scenedino_torch.kernels.point_render import point_query, point_query_plain

    pts = args[0]
    sigma, feat = point_query(*args, cfg)
    torch.cuda.synchronize()
    in_range = (pts[:, 2] >= cfg.z_near) & (pts[:, 2] <= cfg.z_far)
    err_abs, err_range, err_scaled, chunk = 0.0, 0.0, 0.0, 1 << 17
    for p0 in range(0, pts.shape[0], chunk):
        ref_s, ref_f = point_query_plain(pts[p0:p0 + chunk], *args[1:], cfg)
        d = torch.maximum((sigma[p0:p0 + chunk] - ref_s).abs(), (feat[p0:p0 + chunk] - ref_f).abs().amax(-1))
        scaled = d / torch.clamp_min(torch.maximum(ref_s, ref_f.abs().amax(-1)), 1.0)
        err_abs = max(err_abs, d.max().item())
        if bool(in_range[p0:p0 + chunk].any()):
            err_range = max(err_range, d[in_range[p0:p0 + chunk]].max().item())
        err_scaled = max(err_scaled, scaled.max().item())
    P, (D, E), C = pts.shape[0], args[4].shape, args[2].shape[0]
    errs = {"in_range": err_range, "scaled": err_scaled, "abs": err_abs}
    print(f"phase 19 K4 {tag} ({P} points, D {D}, E {E}, {C} code columns) against its plain version: "
          f"{json.dumps(errs)} (bound {K4_TOL} in range and scaled)", flush=True)
    if not (err_range <= K4_TOL and err_scaled <= K4_TOL and bool(torch.isfinite(sigma).all())
            and bool(torch.isfinite(feat).all())):
        fail(f"K4 {tag} disagrees with its plain version: {errs}")
    rows = grid_rows_read(pts, args[1], *args[6:8])
    entry = _entry(f"K4 {tag}", errs, lambda: point_query(*args, cfg), lambda: point_query_plain(*args, cfg),
                   2.0 * P * (C * D + D * E), rows * D * 2 + nbytes(args[0], *args[2:]) + P * E * 4, points=P,
                   d_hidden=D, d_out=E, code_columns=C, grid_rows_read=rows)
    entry["max_abs_err"] = max(err_range, err_scaled)
    return entry


def wide_k6(tag, args, ecfg):
    """K6 against its plain version (phase 3e's bounds by the state's dtype,
    the median rule)."""
    from scenedino_torch.kernels.encode_view import encode_view, encode_view_plain
    from scenedino_torch.tools import bench_encode_view as bev

    dtype = args[4].dtype
    out = encode_view(*args, ecfg)
    torch.cuda.synchronize()
    ref = encode_view_plain(*args, ecfg)
    errs = {n: (o - r).abs().max().item() for n, o, r in zip(("depth", "feature", "rgb"), out, ref)}
    tol = bev.TOL[dtype]
    extra = {}
    if ecfg.depth_statistic == "median":
        holds, extra["median_flips"] = _median_rule(args[1], out[0], ref[0])
        ok = holds and errs["feature"] <= tol["feature"] and errs["rgb"] <= tol["rgb"]
    else:
        ok = all(errs[n] <= tol[n] for n in tol)
    (N, D), Kr, E, Cz = args[0].shape, args[1].shape[1], args[4].shape[1], args[3].shape[0]
    print(f"phase 19 K6 {tag} ({N} rays x {Kr}, {str(dtype).split('.')[-1]} state, D {D}, E {E}, {Cz} z-code "
          f"columns, {ecfg.depth_statistic}) against its plain version: {json.dumps(errs)} (bounds {json.dumps(tol)})"
          + (f", rays off the plain version's median sample {extra['median_flips']:.3e}" if extra else ""), flush=True)
    if not ok or not all(bool(torch.isfinite(o).all()) for o in out):
        fail(f"K6 {tag} disagrees with its plain version: {errs} {extra}")
    return _entry(f"K6 {tag}", errs, lambda: encode_view(*args, ecfg), lambda: encode_view_plain(*args, ecfg),
                  bev.flops(args) * (3 * PEAK_BF16_FLOPS / 495e12 if dtype == torch.float32 else 1.0),
                  nbytes(*args) + N * (E + 3) * 4, rays=N, samples=Kr, dtype=str(dtype).split(".")[-1],
                  d_hidden=D, d_out=E, z_code_columns=Cz, depth_statistic=ecfg.depth_statistic, **extra)


def phase_wide_field(seed):
    """Phase 19a: WIDE_HEAD's field through the four serving paths,
    WIDE_REQUESTS requests each, the counts zeroed before each path and read
    after it; one fp32-fold render_encode_view; then each kernel against its
    plain version on a request's inputs. Returns (the launches, the shape
    entries by kernel)."""
    from scenedino_torch.core import sampling
    from scenedino_torch.ops import fast_field as ff

    model = wide_model(seed, **WIDE_HEAD)
    blocks = model.encoder.vit_encoder.vit.cfg.depth
    F = WIDE_HEAD["dino_dims"]
    imgs, gens = [], []
    for i in range(WIDE_REQUESTS):
        g = torch.Generator(device="cuda").manual_seed(seed + 1900 + i)
        imgs.append(torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1)
        gens.append(g)
    Ks, poses = cameras_of("cuda")
    pts = ssc_points("cuda")
    total = {}

    def add(counts):
        for k_, n in counts.items():
            total[k_] = total.get(k_, 0) + n
        return json.dumps({k_: n for k_, n in counts.items() if n})

    def check(name):
        def fn(depth, dino, rgb):
            if depth.shape != (H, W) or dino.shape != (H, W, F) or rgb.shape != (H, W, 3):
                fail(f"19a {name} output shapes {depth.shape}, {dino.shape}, {rgb.shape}")
            if not all(bool(torch.isfinite(t).all()) for t in (depth, dino, rgb)):
                fail(f"19a {name} output is not finite")
            if not (depth.min().item() >= 3.0 - 1e-3 and depth.max().item() <= 80.0 + 1e-3):
                fail(f"19a {name} depth outside [3, 80]")
        return fn

    def check_query(sigma, feat):
        if sigma.shape != (pts.shape[0],) or feat.shape != (pts.shape[0], F):
            fail(f"19a SSC query output shapes {sigma.shape}, {feat.shape}")
        if not (torch.isfinite(sigma).all() and torch.isfinite(feat).all() and sigma.min() >= 0):
            fail("19a SSC query output is not finite, or sigma < 0")

    us = [torch.rand(H * W, K, generator=g, device="cuda") for g in gens]
    draws = [ff.draw_probe(H, W, g, "cuda") for g in gens]
    paths = [
        ("novel-view", [(img, u, "cuda") for img, u in zip(imgs, us)], lambda *r: serve(model, *r),
         check("novel-view"), {"point_render": (1, True)}),
        ("probe", [(img, d, "cuda") for img, d in zip(imgs, draws)], lambda *r: serve_probe(model, *r),
         check("probe"), {"probe_weights": (1, True), "row_gather": (1, False), "point_render": (1, True)}),
        ("SSC query", [(img, pts, "cuda") for img in imgs], lambda *r: serve_query(model, *r), check_query,
         {"point_query": (1, True)}),
        ("encode-view", [(img, u, "cuda") for img, u in zip(imgs, us)], lambda *r: serve_encode_view(model, *r),
         check("encode-view"), {"encode_view": (1, True)}),
    ]
    for name, reqs, answer, chk, expect in paths:
        counts, times = run_path(f"19a {name}", reqs, answer, chk, {"attention": (blocks, True), **expect})
        print(f"phase 19a {name} on the wide field ({json.dumps(WIDE_HEAD)}): {len(reqs)} requests at {H}x{W}, ms "
              f"per request {[round(t, 3) for t in times]}; launches {add(counts)}", flush=True)
    with torch.inference_mode():
        fs32 = ff.build_fast_state(model, model.encode(imgs[0], Ks, poses), compute_dtype=torch.float32)
    out, counts = _driven(lambda: ff.render_encode_view(fs32, model.cfg, H, W, u=us[0], n_coarse=K))
    _expect_launches("19a render_encode_view on the fp32 fold", counts, {"encode_view": 1})
    check("fp32-fold encode-view")(*out)
    print(f"phase 19a render_encode_view on the wide field's fp32 fold: launches {add(counts)}", flush=True)

    # each kernel against its plain version on the first request's inputs
    with torch.inference_mode():
        fs = ff.encode_prefolded(model, imgs[0], Ks, poses)
    field, colour = ff._single_view(fs, "phase 19a"), ff._colour_view(fs)
    pcfg = ff._point_config(model.cfg)
    flat = ff._target_rays(model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W).reshape(-1, 8).contiguous()
    z = sampling.sample_coarse(flat, K, True, u=us[0]).contiguous()
    tag = "wide field"
    shapes = {"point_render": {tag: wide_k2(tag, (flat, z, *field, *colour), pcfg)}}
    rays = flat.reshape(H, W, 8)[::4, ::4].reshape(-1, 8).contiguous()
    zp = sampling.sample_coarse(rays, draws[0].u_probe.shape[1], True, u=draws[0].u_probe).contiguous()
    grid, w_code, b1, w2, b2, fw, fk = field
    shapes["probe_weights"] = {tag: wide_k3(tag, (rays, zp, grid, w_code, b1, w2[:, :1].contiguous(),
                                                  b2[:1].contiguous(), fw, fk), pcfg)}
    shapes["point_query"] = {tag: wide_k4(tag, (pts, *field), pcfg)}
    shapes["encode_view"] = {}
    for name, state in ((tag, fs), (f"{tag}, fp32 fold", fs32)):
        args, ecfg = ff.encode_view_inputs(state, model.cfg, H, W, u=us[0][None], n_coarse=K)
        shapes["encode_view"][name] = wide_k6(name, args, ecfg)
    return total, shapes


def phase_other_widths(seed):
    """Phase 19b: WIDE_OTHERS' seeded fields, each kernel against its plain
    version at the paths' shapes (K2 over the 192x640 novel view's rays at 32
    samples, K3 over its 48x160 probe rays at 16, K4 over the SSCBench voxel
    centres, K6 over the bf16 serving frame at 32); then on the shipped
    flagship widths K2 and K6 at WIDE_SAMPLES samples (both depth
    statistics) and K3 at WIDE_PROBE. Returns the shape entries by kernel."""
    from scenedino_torch.core import sampling
    from scenedino_torch.kernels.point_render import PointRenderConfig
    from scenedino_torch.models.field import FieldConfig
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.ops.fast_field import FastFieldState, encode_view_inputs

    gen = torch.Generator(device="cuda").manual_seed(seed + 1950)
    cams = (torch.eye(4, device="cuda"), intrinsics("cuda"))
    flat = ff._target_rays(FieldConfig(), novel_pose("cuda"), intrinsics("cuda"), H, W).reshape(-1, 8).contiguous()
    rays = flat.reshape(H, W, 8)[::4, ::4].reshape(-1, 8).contiguous()
    pts = ssc_points("cuda")[: 1 << 19].contiguous()  # the SSC evaluator's block
    shapes = {"point_render": {}, "probe_weights": {}, "point_query": {}, "encode_view": {}}

    def state_of(field, colour):
        grid, w_code, b1, w2, b2 = field
        return FastFieldState(folded_grid=grid[None, None], w_code=w_code, b1=b1, w2=w2, b2=b2,
                              feat_ks=intrinsics("cuda")[None, None], feat_w2c=cams[0][None, None],
                              color_imgs=colour[None, None], color_ks=intrinsics("cuda")[None, None],
                              color_w2c=cams[0][None, None])

    def k6(tag, field, colour, fcfg, Kr, stats=("expectation",)):
        u = torch.rand(1, H * W, Kr, generator=gen, device="cuda")
        args, ecfg = encode_view_inputs(state_of(field, colour), fcfg, H, W, u=u, n_coarse=Kr)
        for stat in stats:
            name = tag if stat == "expectation" else f"{tag}, {stat}"
            shapes["encode_view"][name] = wide_k6(name, args, dataclasses.replace(ecfg, depth_statistic=stat))

    for tag, D, E, nf in WIDE_OTHERS:
        cfg = PointRenderConfig(num_freqs=nf)
        field = wide_field(gen, D, E, cfg.code_dims)
        colour = torch.rand(H, W, 3, generator=gen, device="cuda").to(torch.bfloat16)
        z = sampling.sample_coarse(flat, K, generator=gen).contiguous()
        shapes["point_render"][tag] = wide_k2(tag, (flat, z, *field, *cams, colour, *cams), cfg)
        zp = sampling.sample_coarse(rays, 16, generator=gen).contiguous()
        grid, w_code, b1, w2, b2 = field
        shapes["probe_weights"][tag] = wide_k3(tag, (rays, zp, grid, w_code, b1, w2[:, :1].contiguous(),
                                                     b2[:1].contiguous(), *cams), cfg)
        shapes["point_query"][tag] = wide_k4(tag, (pts, *field, *cams), cfg)
        k6(tag, field, colour, FieldConfig(dino_dims=E - 1, num_freqs=nf), K)

    cfg = PointRenderConfig()
    field = flagship_field(gen)
    colour = torch.rand(H, W, 3, generator=gen, device="cuda").to(torch.bfloat16)
    z = sampling.sample_coarse(flat, WIDE_SAMPLES, True, generator=gen).contiguous()
    for stat in ("expectation", "median"):
        tag = f"{WIDE_SAMPLES} samples" + ("" if stat == "expectation" else f", {stat}")
        shapes["point_render"][tag] = wide_k2(tag, (flat, z, *field, *cams, colour, *cams),
                                              dataclasses.replace(cfg, depth_statistic=stat))
    zp = sampling.sample_coarse(rays, WIDE_PROBE, True, generator=gen).contiguous()
    grid, w_code, b1, w2, b2 = field
    shapes["probe_weights"][f"n_probe {WIDE_PROBE}"] = wide_k3(
        f"n_probe {WIDE_PROBE}", (rays, zp, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), *cams),
        cfg)
    k6(f"{WIDE_SAMPLES} samples", field, colour, FieldConfig(), WIDE_SAMPLES, ("expectation", "median"))
    return shapes


def phase_every_width(seed):
    """Phase 19: the field kernels at every width the JAX package takes.
    Returns (the launches of 19a's paths, the shape entries of K2, K3, K4 and
    K6)."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    counts, shapes = phase_wide_field(seed)
    for name, entries in phase_other_widths(seed).items():
        shapes[name].update(entries)
    print(f"phase 19 launches {json.dumps(counts)}; wall time {time.perf_counter() - t_phase:.1f} s (target 60 s); "
          f"{card_line()}", flush=True)
    return counts, shapes


# phase 20: K1 past head dim 256 (csrc/attention_wide.cu). 20a: the forward,
# dq and dkv at WIDE_K1_SHAPES (the ViTs of wide heads: ViT-B/8 with 2 heads
# and 1, width 1024 with 2, width 1280 with 4 and 1; and D 264, whose fifth
# 64-column chunk is 8 columns wide) against their plain versions, two
# launches bitwise equal, timed beside SDPA and the bound, and at
# WIDE_K1_PADDED (a head dim the wrappers pad to a multiple of 8) untimed;
# 20b: the flagship serving model (bf16) with vit_overrides num_heads 2 (D
# 384), WIDE_K1_REQUESTS exact novel-view requests, then num_heads 1 (D 768),
# one request; each model against itself on the CPU, encoding a frame of
# WIDE_K1_CHECK (the flagship's width cut to 64 rows: 8 x 80 patches + 1 =
# 641 tokens, so the card takes K1, which it does from 512 tokens) and
# rendering phase 4's small 32x96 view of it (a 64x640 render takes the CPU's
# plain K2 about 4 s); 20c: one stage-1 step of SCENEDINO_KITTI_360_TRAIN with
# num_heads 2 at its batch 4 on the card, then WIDE_K1_CPU_OVERRIDES at batch
# 1 and WIDE_K1_CHECK on the card and on the CPU (phase 5's bounds): three
# blocks, the fewest that give the DPT its three taps (WIDE_K1_CPU_TAPS, as
# the smoke recipe's)
WIDE_K1_SHAPES = ((2, 1921, 2, 384), (2, 1921, 1, 768), (2, 1921, 2, 512), (2, 1921, 4, 320), (2, 1921, 1, 1280),
                  (2, 1921, 2, 264))
WIDE_K1_PADDED = (2, 1921, 2, 300)
WIDE_K1_REQUESTS = 3
WIDE_K1_CHECK = (64, 640)
WIDE_K1_CPU_OVERRIDES = {"num_heads": 2, "depth": 3}
WIDE_K1_CPU_TAPS = (0, 1, 2)


def phase_wide_k1_kernels(seed):
    """Phase 20a: K1's three kernels past head dim 256 at WIDE_K1_SHAPES and
    WIDE_K1_PADDED. Returns the three kernels' entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2000)
    shapes = [k1_any_shape(gen, *shape, phase="phase 20a") for shape in WIDE_K1_SHAPES]
    shapes.append(k1_any_shape(gen, *WIDE_K1_PADDED, timed=False, phase="phase 20a"))
    main = shapes[0]
    common = {"route": "cuda", "source": "scenedino_torch/csrc/attention_wide.cu",
              **{k_: main[k_] for k_ in ("device_ms", "library_device_ms", "bwd_device_ms", "library_bwd_device_ms",
                                         "library_backend")},
              "shapes": shapes}
    return [
        {"name": "attention_wide", "replaces": "scenedino_tpu/models/vit.py:126",
         "max_abs_err": max(e["max_abs_err"] for e in shapes),
         **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, **common},
        {"name": "attention_wide_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "max_abs_err": max(e["bwd_errs"][0] for e in shapes), "ms": main["ms_dq"], "plain_ms": main["plain_bwd_ms"],
         "bound_ms": main["bound_dq_ms"], "bound_by": main["bound_dq_by"], "library_ms": main["library_bwd_ms"],
         **common},
        {"name": "attention_wide_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "max_abs_err": max(max(e["bwd_errs"][1:]) for e in shapes), "ms": main["ms_dkv"],
         "plain_ms": main["plain_bwd_ms"], "bound_ms": main["bound_dkv_ms"], "bound_by": main["bound_dkv_by"],
         "library_ms": main["library_bwd_ms"], **common},
    ]


def phase_wide_k1_serving(seed):
    """Phase 20b: the flagship serving model with heads of 384 (then 768)
    through the exact novel view, the counts zeroed before each model's
    requests and read after them; then each model against itself on the CPU
    at WIDE_K1_CHECK (phase 4's bounds). Returns the launches."""
    from scenedino_torch.kernels.attention import route
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model

    total = {}
    for heads, n_req in ((2, WIDE_K1_REQUESTS), (1, 1)):
        conf = {**SCENEDINO_KITTI_360}
        conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16", "vit_overrides": {"num_heads": heads}}
        model = make_model(conf, device="cuda", seed=seed)
        vit = model.encoder.vit_encoder.vit.cfg
        D = vit.width // vit.num_heads
        if route(D)[0] != "wide":
            fail(f"phase 20b: head dim {D} does not take csrc/attention_wide.cu")
        reqs = []
        for i in range(n_req):
            g = torch.Generator(device="cuda").manual_seed(seed + 2010 + 10 * heads + i)
            img = torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1
            reqs.append((img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda"))
        name = f"novel-view at D {D}"
        counts, times = run_path(f"20b {name}", reqs, lambda *r: serve(model, *r),
                                 lambda *o: check_depth(f"20b {name}", *o),
                                 {"attention_wide": (vit.depth, True), "point_render": (1, True)})
        for k_, n in counts.items():
            total[k_] = total.get(k_, 0) + n
        print(f"phase 20b {name} (ViT-B/8, {vit.num_heads} heads of {D}, bf16): {n_req} requests at {H}x{W}, ms per "
              f"request {[round(t, 3) for t in times]}; launches "
              f"{json.dumps({k_: n for k_, n in counts.items() if n})}", flush=True)

        g = torch.Generator().manual_seed(seed + 2030 + heads)
        h, w = WIDE_K1_CHECK
        img = torch.rand(1, 1, 3, h, w, generator=g) * 2 - 1
        u = torch.rand(32 * 96, K, generator=g)
        out, small = _driven(lambda: serve(model, img.cuda(), u.cuda(), "cuda", size=(32, 96)))
        gpu = [t.float().cpu() for t in out]
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        cpu = [t.float() for t in serve(cpu_model, img, u, "cpu", size=(32, 96))]
        cpu_s = time.perf_counter() - t0
        rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).max().item()
        cos = torch.nn.functional.cosine_similarity(gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64),
                                                    dim=-1).median().item()
        tokens = 1 + (h // vit.patch_size) * (w // vit.patch_size)
        print(f"phase 20b small-input check at D {D} ({h}x{w} encoded, {tokens} tokens, 32x96 rendered; GPU kernels, "
              f"{small['attention_wide']} wide K1 launches, vs CPU plain, bf16; the CPU {cpu_s:.1f} s): depth max rel "
              f"err {rel:.3e} (bound {SLICE_DEPTH_REL}), feature median cosine {cos:.6f} (bound {SLICE_COS})",
              flush=True)
        if not (small["attention_wide"] == vit.depth and rel <= SLICE_DEPTH_REL and cos >= SLICE_COS):
            fail(f"the GPU novel view at D {D} did not take the wide K1 or disagrees with the CPU on the small input")
        del model, cpu_model
    return total


def phase_wide_k1_train(seed):
    """Phase 20c: one stage-1 step of the flagship recipe with heads of 384
    through trainer.make_train_step at its batch (the wide forward once a
    student and a teacher block, dq and dkv once a student block), then
    WIDE_K1_CPU_OVERRIDES at batch 1 and WIDE_K1_CHECK on the card and the
    CPU. Returns the launches of the step."""
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer

    conf = copy.deepcopy(SCENEDINO_KITTI_360_TRAIN)
    conf["model"]["encoder"]["vit_overrides"] = {"num_heads": 2}
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2040)
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    B, V, gp = conf["batch_size"], 4, enc.gt_patch_size
    vit = enc.vit_encoder.vit.cfg
    blocks, t_blocks = vit.depth, enc.gt_encoder.vit.cfg.depth
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.gt_encoder.latent_size, H // gp, W // gp),
                                     generator=gen)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(gen, B, H, W, "cuda")
    draws = trainer.draw_stage1(gen, tcfg, rcfg, B, V, H, W, gp)
    trainable = [p for group in state.optimizer.param_groups for p in group["params"]]
    before = [p.detach().clone() for p in trainable] + [state.artifact_field.detach().clone()]
    t0 = time.perf_counter()
    losses, counts = _driven(lambda: step(state, batch, draws))
    ms = (time.perf_counter() - t0) * 1e3
    loss = float(losses["rec_loss"])
    unchanged = sum(torch.equal(a, p) for a, p in zip(before, trainable + [state.artifact_field]))
    print(f"phase 20c stage-1 step with heads of {vit.width // vit.num_heads} (configs/train_scenedino_kitti_360.yaml's "
          f"model, vit_overrides num_heads 2; bf16, {H}x{W}, batch {B}, V = {V}): loss {loss:.6f}, {ms:.1f} host ms "
          f"(the first step: cuDNN's search and the kernels' load), {len(before) - unchanged} of {len(before)} "
          f"tensors moved, applied {state.applied}; launches {json.dumps({k_: n for k_, n in counts.items() if n})}",
          flush=True)
    if not (np.isfinite(loss) and state.applied == 1 and losses["nonfinite_consecutive"] == 0 and unchanged == 0):
        fail("the stage-1 step with heads of 384 was not finite and applied, or a parameter did not move")
    _expect_launches("the stage-1 step with heads of 384", counts, {
        "attention_wide": blocks + t_blocks, "attention_wide_bwd_dq": blocks, "attention_wide_bwd_dkv": blocks})
    del state, step, model, before, trainable

    # the same widths three blocks deep at batch 1: the card's kernels against the CPU's plain versions
    conf["model"]["encoder"].update(vit_overrides=dict(WIDE_K1_CPU_OVERRIDES), intermediate_features=WIDE_K1_CPU_TAPS)
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    h, w = WIDE_K1_CHECK
    gc = torch.Generator().manual_seed(seed + 2050)
    small = train_batch(gc, 1, h, w, "cpu")
    sdraws = trainer.draw_stage1(gc, tcfg, rcfg, 1, V, h, w, gp)
    art = 1e-3 * torch.randn(enc.gt_encoder.latent_size, h // gp, w // gp, generator=gc)

    def one_step(m, device):
        m.zero_grad(set_to_none=True)
        a = art.to(device).requires_grad_(True)
        d = dataclasses.replace(sdraws, **{f: getattr(sdraws, f).to(device) for f in ("pv", "py", "px", "u")})
        loss_, _ = trainer.stage1_forward(m, {k_: v.to(device) for k_, v in small.items()}, d, tcfg, rcfg, lcfg, a)
        loss_.backward()
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters() if p.grad is not None}
        grads["artifact_field"] = a.grad.float().cpu()
        return loss_.item(), grads

    (gpu_loss, gpu_grads), small_counts = _driven(lambda: one_step(model, "cuda"))
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = one_step(copy.deepcopy(model).to("cpu"), "cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if sorted(gpu_grads) != sorted(cpu_grads):
        fail("the GPU and CPU steps with heads of 384 gave gradients to different parameters")
    errs = {n: (torch.linalg.vector_norm(gpu_grads[n] - r) / torch.linalg.vector_norm(r)).item()
            for n, r in cpu_grads.items() if torch.linalg.vector_norm(r) > 0}
    worst = max(errs, key=errs.get)
    depth = WIDE_K1_CPU_OVERRIDES["depth"]
    print(f"phase 20c small-step check ({json.dumps(WIDE_K1_CPU_OVERRIDES)}, {h}x{w}, batch 1, GPU kernels vs CPU "
          f"plain, bf16; the CPU {cpu_s:.1f} s): launches {json.dumps({k_: n for k_, n in small_counts.items() if n})}; "
          f"loss {gpu_loss:.6f} vs {cpu_loss:.6f}, rel err {loss_rel:.3e} (bound {TRAIN_LOSS_REL}); gradients of "
          f"{len(errs)} tensors, relative L2 error median {float(np.median(list(errs.values()))):.3e}, worst "
          f"{errs[worst]:.3e} ({worst}; bound {TRAIN_GRAD_REL})", flush=True)
    _expect_launches("the small step with heads of 384", small_counts, {
        "attention_wide": 2 * depth, "attention_wide_bwd_dq": depth, "attention_wide_bwd_dkv": depth})
    if not (np.isfinite(gpu_loss) and loss_rel <= TRAIN_LOSS_REL and errs[worst] <= TRAIN_GRAD_REL):
        fail("the GPU training step with heads of 384 disagrees with the CPU on the small input")
    return counts


def phase_wide_head_dims(seed):
    """Phase 20: K1 past head dim 256. Returns (the launches of 20b's paths
    and 20c's step, the three kernels' entries)."""
    from scenedino_torch.utils.timing import card_line

    t = [time.perf_counter()]
    entries = phase_wide_k1_kernels(seed)
    t.append(time.perf_counter())
    serving = phase_wide_k1_serving(seed)
    t.append(time.perf_counter())
    step = phase_wide_k1_train(seed)
    t.append(time.perf_counter())
    counts = {k_: serving.get(k_, 0) + step.get(k_, 0) for k_ in serving}
    parts = {f"20{c}": round(b - a, 1) for c, a, b in zip("abc", t, t[1:])}
    print(f"phase 20 launches {json.dumps(counts)}; wall time {t[-1] - t[0]:.1f} s (target 60 s; "
          f"{json.dumps(parts)}); {card_line()}", flush=True)
    return counts, entries


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    try:
        from scenedino_torch import kernels
        from scenedino_torch.kernels import build
        from scenedino_torch.tools import bench_attention_bwd, bench_attention_wide, bench_encode_view
        from scenedino_torch.utils.timing import card_line
    except ImportError as e:
        fail(f"scenedino_torch is not importable ({e}): run from a checkout of the repository")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {kind}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    secs = build.build(build.all_names())
    ptxas = {}
    for name in secs:
        ptxas[name] = [line.split("ptxas info    : ")[-1] for line in build.build_log(name).splitlines()
                       if "Used" in line]
    print(f"phase 1 build: {time.monotonic() - t0:.1f} s wall (45.1 s before the wide walk, an H100 at 700 W), per kernel "
          f"{json.dumps(secs)}; "
          f"ptxas {json.dumps(ptxas)}", flush=True)
    # the K1 kernels hold their accumulators in registers: a spill would put them in local memory
    k1 = {("fwd" if "fwd" in entry else "dq" if "bwd_dq" in entry else "dkv"): r
          for name in ("attention", "attention_bwd") for entry, r in build.ptxas_report(build.build_log(name)).items()}
    print(f"phase 1 K1 kernels (forward, backward dq and dkv), registers at launch (a consumer warpgroup then takes "
          f"the producer's, see csrc/attention.cu and attention_bwd.cu) and spills in bytes: {json.dumps(k1)}",
          flush=True)
    if sorted(k1) != ["dkv", "dq", "fwd"] or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                                 for r in k1.values()):
        fail(f"ptxas spilled in a K1 kernel, or its report is missing: {k1}")
    d80 = bench_attention_bwd.forward_report(build.build_log("attention_d80"))
    d80.update(bench_attention_bwd.backward_report(build.build_log("attention_d80_bwd")))
    print(f"phase 1 K1 kernels at head dim 80 (csrc/attention_d80.cu: the forward's two instantiations, by "
          f"warpgroups, ring slots and blocks per SM; csrc/attention_d80_bwd.cu: dq and dkv), registers at launch, "
          f"then setmaxnreg's split of the producer warpgroup and each consumer warpgroup, and spills in bytes: "
          f"{json.dumps(d80)}", flush=True)
    forwards = [name for name in d80 if name.startswith("fwd")]
    if (len(forwards) != 2 or sorted(set(d80) - set(forwards)) != ["dkv", "dq"]
            or any("consumer" not in d80[name] for name in forwards)
            or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in d80.values())):
        fail(f"ptxas spilled in a D = 80 K1 kernel, or its report is missing: {d80}")
    # K1 at every other head dim: forward, dq and dkv at each padded width and k-steps (csrc/attention_any.cu)
    anyk = bench_attention_bwd.any_report(build.build_log("attention_any"))
    print(f"phase 1 K1 kernels at every other head dim (csrc/attention_any.cu: the forward, dq and dkv by the "
          f"head-dim columns their k-steps cover, wgmma on TMA tiles), registers at launch (a consumer warpgroup "
          f"then takes the producer's) and spills in bytes: {json.dumps(anyk)}", flush=True)
    if len(anyk) != ANY_KERNELS or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in anyk.values()):
        fail(f"ptxas spilled in csrc/attention_any.cu, or a report is missing ({len(anyk)} of {ANY_KERNELS}): {anyk}")
    # K1 past head dim 256: one forward, dq and dkv (csrc/attention_wide.cu)
    wide_log = build.build_log("attention_wide")
    widek, wide_notes = bench_attention_wide.wide_report(wide_log), bench_attention_wide.wgmma_notes(wide_log)
    print(f"phase 1 K1 kernels past head dim 256 (csrc/attention_wide.cu: the forward, dq and dkv, output columns in "
          f"groups of {json.dumps(bench_attention_wide.GROUPS)} 64-column chunks; built in "
          f"{secs['attention_wide']:.1f} s), registers at launch and spills in bytes: {json.dumps(widek)}; ptxas notes "
          f"on wgmma {wide_notes}", flush=True)
    if bench_attention_wide.spilled(widek) or wide_notes:
        fail(f"ptxas spilled or serialized wgmma in csrc/attention_wide.cu, or a report is missing: {widek} {wide_notes}")
    # the point kernels (K2, K3, K4) in each of their hidden and output widths: mode, DC, EC, ET; the wide walk's
    pk = {}
    for name, r in build.ptxas_report(build.build_log("point_render")).items():
        for kernel, tag in (("point_kernel", ""), ("point_wide_kernel", "wide "), ("pack_units", "pack ")):
            if kernel in name:
                pk[tag + ",".join(re.findall(r"Li(\d+)E", name.split(kernel)[-1]))] = r
    print(f"phase 1 point kernels by template arguments (mode 0 K2, 1 K3, 2 K4; hidden chunks of 64; output chunks "
          f"of 64; output tail; the walk, 1 for several tiles a ray; \"wide\" the wide walk by mode and walk, "
          f"\"pack\" its weight packing), registers and spills in bytes: {json.dumps(pk)}", flush=True)
    if len(pk) != POINT_KERNELS or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in pk.values()):
        fail(f"ptxas spilled in a point kernel, or a report is missing ({len(pk)} of {POINT_KERNELS}): {pk}")
    ev = bench_encode_view.ptxas()
    print(f"phase 1 K6 encode_view kernels by template arguments (TF32: 1 for the fp32 state's three passes; "
          f"the code's k16 steps; the walk, 1 for several tiles a ray; hidden chunks of 64; output chunks of 64; output "
          f"tail), registers and spills in bytes: {json.dumps(ev)}", flush=True)
    if bench_encode_view.spilled(ev):
        fail(f"ptxas spilled in K6, or a report is missing ({len(ev)} of {bench_encode_view.INSTANTIATIONS}): {ev}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(gen), *phase_k1_bwd(gen), phase_k2(gen), *phase_probe(gen), phase_k4(gen), phase_k6(gen),
               *phase_d80_kernels(gen)]
    phase_gather(args.seed)
    serving = phase_slice(args.seed)
    training = phase_train(args.seed)
    phase_train_fp32(args.seed)
    # the training phases' run directories (checkpoints of GBs) live and go with one temporary directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        train_run, stage1_dir = phase_train_run(args.seed, scratch)
        stage2, stage2_dir = phase_stage2(args.seed, stage1_dir, scratch)
        stage2_conv = phase_stage2_convergence(args.seed, scratch)
        evaluation, k4_block, k6_frame, trees = phase_eval(args.seed, stage2_dir, scratch)
        reference, holds = phase_reference(args.seed, scratch, *trees)
        kitti, k1_kitti, kitti_root = phase_kitti(args.seed, scratch)
        d80_paths, k1_upsampler = phase_d80_and_upsample_gt(args.seed, kitti_root, scratch)
        re10k, k1_re10k, bwd_re10k = phase_re10k(args.seed, scratch)
        t13 = time.perf_counter()
        branches = phase_branches(args.seed)
        dinov2 = phase_dinov2_and_diag(kitti_root, stage1_dir, scratch)
        print(f"phase 13 wall time {time.perf_counter() - t13:.1f} s; {card_line()}", flush=True)
        serving_rest = phase_serving_rest(args.seed, trees[0], stage2_dir, scratch)
        multi = phase_multi_device(args.seed, *trees, stage2_dir, scratch)
        eval_rest, k4_s4c = phase_eval_rest(args.seed, stage1_dir, stage2_dir, *trees, scratch)
        port_rest = phase_port_rest(args.seed, stage2_dir, scratch)
    every_shape, long_shapes, any_entries = phase_every_shape(args.seed)
    every_width, wide_shapes = phase_every_width(args.seed)
    wide_heads, wide_entries = phase_wide_head_dims(args.seed)
    entries += any_entries + wide_entries
    paths = (serving, training, train_run, stage2, stage2_conv, evaluation, reference, kitti, d80_paths, re10k,
             branches, dinov2, serving_rest, multi, eval_rest, port_rest, every_shape, every_width, wide_heads)
    for e in entries:
        for extra in (long_shapes, wide_shapes):
            if e["name"] in extra:
                e.setdefault("shapes", {}).update(extra[e["name"]])
                e["max_abs_err"] = max([e["max_abs_err"]] + [shape["max_abs_err"] for shape in
                                                             extra[e["name"]].values()])
        e["launches"] = sum(p[e["name"]] for p in paths)
        if e["name"] == "point_query":
            e.setdefault("shapes", {}).update({"SSCBench evaluation block": k4_block, "S4C baseline block": k4_s4c})
            e["max_abs_err"] = max(e["max_abs_err"], k4_block["max_abs_err"], k4_s4c["max_abs_err"])
        elif e["name"] == "encode_view":
            e["shapes"]["2D evaluation"] = k6_frame
            e["max_abs_err"] = max(e["max_abs_err"], k6_frame["max_abs_err"])
        if e["name"] == "attention":
            e["shapes"] += [{"path": "KITTI-360", **shape} for shape in k1_kitti]
            e["shapes"] += [{"path": "upsample-gt recipe", **shape} for shape in k1_upsampler]
            e["shapes"] += [{"path": "RE10K recipe", **shape} for shape in k1_re10k]
            e["max_abs_err"] = max([e["max_abs_err"]] + [shape["max_abs_err"] for shape in
                                                         k1_kitti + k1_upsampler + k1_re10k])
        if e["name"] in ("attention_bwd_dq", "attention_bwd_dkv"):
            shape = dict(zip(("attention_bwd_dq", "attention_bwd_dkv"), bwd_entries(bwd_re10k)))[e["name"]]
            e["shapes"] = [{"path": "RE10K recipe", "shape": bwd_re10k["shape"], **shape}]
            e["max_abs_err"] = max(e["max_abs_err"], shape["max_abs_err"])
        if e["name"] in holds:
            if isinstance(e.get("shapes"), list):
                e["shapes"].append({"path": "reference checkpoints", **holds[e["name"]]})
            else:
                e.setdefault("shapes", {})["reference checkpoints"] = holds[e["name"]]
    if sorted(e["name"] for e in entries) != sorted(kernels.WRAPPERS):
        fail("the kernels line does not list every kernel")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms", "bwd_device_ms",
            "library_bwd_device_ms", "library_backend", "shapes"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e} for e in entries]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
