"""Chip smoke test of the PyTorch/CUDA port (scenesplat_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card, and the kernels' build from this checkout's sources
     (one nvcc per source, started together);
  2. kernel: the flash-window attention kernel against its plain version at
     every (window, channels, heads) signature of the flagship backbone and
     of configs/test_lang_inference.py and at windows on both sides of the
     bf16 variants' thresholds (windows of 16 to 64 on the one-pass
     bf16_small, 65 and 4160 on bf16_tiled, 128 to 1024 on bf16_large),
     fp32 and bf16, with partial and fully padded windows, a ragged last
     window and valid prefixes that end inside a key tile, on a tile edge and
     one past it; in bf16 also the log-sum-exp against the plain one and the
     output with and without it (equal bits);
  3. serve: the zero-shot serving path (FeatureExtractor -> flagship
     LangPretrainer in bf16 -> zero_shot_predict against the ScanNet200
     SigLIP2 table) at 196,608 points of a seeded synthetic room, a few
     requests, with the kernel's launches counted;
  4. timing: at the shapes and valid counts phase 3 gave each launch, the
     kernel against its plain version in bf16, then the times of the
     kernel, the plain version and scaled_dot_product_attention (the
     library yardstick, used nowhere in the port), with the least time the
     card could take for the same work, the TFLOP/s reached and which
     variant ran;
  5. shipped: one forward of the shipped inference backbone (decoder
     windows of 48, ragged at every stage, on bf16_small) at 65,536 points;
  6. agree: fp32 forward with the kernel against the same forward with the
     plain attention at 49,152 points;
  7. kernel_bwd: the attention backward kernels (through the autograd
     Function) against autograd through the plain version at every
     signature of phase 2, fp32 and bf16 (both bf16 variants: windows on
     both sides of the backward's threshold of 64), with zero gradients in
     padded windows; then kernel_widths: K1 and K2 at head widths 8, 24, 40
     (padded to 16, 32, 48 by the wrapper), 64, 96 and 128 in fp32, bf16
     and fp16 (fp16 also at 16, 32 and 48), at windows of 48, 64, 65, 128,
     1024 and 4160 (every variant on both sides of its threshold), partly
     and fully padded windows and a ragged last one, against the plain
     version (fp32 1e-4; bf16 and fp16 within 2.5 times the plain
     version's own error in that type; lse 1e-4), each call counted on
     its variant and padded width; every variant timed at width 64 beside
     the plain version, scaled_dot_product_attention and the bound, and the
     wrapper pad's time at the padded widths;
  8. train: scenesplat_tpu_torch.train's trainer on the flagship config
     (configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py, read
     through the port's Config) over a synthetic 3DGS dataset written to a
     temporary directory: flagship widths, losses, optimizer, schedule,
     transforms, Mix3D and 196,608 points, batch 2, epoch 1 so the
     contrastive term is live, and the file's own hooks (the evaluator
     over one small validation scene per dataset logs val*/fg_mIoU, the
     saver writes model_best.pth, PreciseEvaluator finds no tester); 1 + 2
     steps (2 rooms of write_flagship_data's) with K1 and K2 launches
     counted (and each variant's: the decoder's windows of 48 on
     bf16_small, the encoder's on bf16_large),
     step times, loader waits, peak memory and one profiled step;
  9. timing_bwd: at the train step's stage shapes, the forward with
     log-sum-exp and the backward kernel against the plain version (bf16
     noise-floor rule, zeros in padded windows), then their times against
     the plain version, scaled_dot_product_attention's forward and backward
     (the library yardstick, used nowhere in the port) and the least time
     the card could take;
 10. train_agree: one fp32 train step of the flagship config file's model at
     24,576 points with the kernels and one with the plain attention, same
     weights and generator seeds;
 11. ddp_train: data parallel, the train phase's run once more through
     DistributedDataParallel under a one-process NCCL group, as torchrun
     starts one (the same data, batch 2, 1 + 2 steps, the file's hooks with
     the evaluator on the scene-sharded path, K1 and K2 launches, step
     times, loader waits, peak memory, beside the train phase's), its
     checkpoint loaded strictly into a one-process model; then one fp32
     step at 24,576 points under DDP against the same step without it
     (losses to 1e-5, gradients to 1e-4 relative); then the wide heads:
     wide_serve, the flagship's channels with heads of width 64 (32 at
     encoder stage 0, WIDE_HEADS) served at 196,608 Gaussians in bf16,
     every K1 launch on bf16_large at widths 32 and 64, and wide_timing
     (phase 4 at its shapes); wide_train, the flagship file's trainer
     with those heads for 1 + 2 steps over the train phase's rooms with
     its hooks, K1 and K2 launches by variant and width, and
     wide_timing_bwd (phase 9 at its shapes); fp16_serve, the flagship in
     float16 served once, every K1 launch on bf16_large in fp16, its
     features within a mean cosine of 0.99 of the fp32 forward's; then
     tools: entry.py --save-features --results-dir, the PCA tool (through
     the model and from the saved features) and the scene viewer as a
     user runs them over a synthetic scene of 40,000 Gaussians, the files
     read back and checked, K1 launched 18 times a model run;
 12. ddp_agree: two ranks on the one card over gloo (NCCL refuses two ranks
     on one card), run in phase 39's shared spawn: one fp32 step of a
     global batch of 2 rows of 24,576 points (drop-path 0.3, the
     contrastive term on) against one process's step over both rows (the
     loss to 1e-5, the gradient norm, every gradient and every BatchNorm
     running statistic to 1e-4 relative, equal gradients on both ranks),
     then the zero-shot test entry over 3 scenes on the ddp_train
     checkpoint, the ranks' metrics and predictions equal to one
     process's (both under deterministic algorithms); the ranks' K1 and K2
     launches go into the kernels line;
 13. kernel_sort: the bitonic row sort K3 against its plain version, exact,
     at 2 and 3 operands, 1 to 3 keys, rows of 1000 to 2^20, 1 to 12 rows,
     random and heavily tied keys, and against torch.sort (equal keys;
     with the index as last key, the stable order); int64 codes with a
     sentinel tail through sort_int64 with the switch on (K3's int64 entry)
     against its plain version and against torch.sort(stable=True), rows
     of 1, 3 and 4, lengths that are no power of two;
 14. test: scenesplat_tpu_torch.test's main on the flagship config file
     plus test= and data.test= (the fragment test pipeline of
     configs/_base_/gs_pipelines.py), bf16, the train phase's checkpoint,
     over one synthetic ScanNet200-layout scene of 320,001 Gaussians at
     1 cm spacing (2 fragments of 160,001 points each); once with
     torch.sort and once with SCENESPLAT_BITONIC_SORT=1, both under
     torch.use_deterministic_algorithms: equal predictions and metrics, K3
     launches 0 then as reckoned, K1 18 per fragment (the decoder's 6 on
     bf16_small); then once more with torch.sort and without the
     deterministic mode, as a user runs it, for the times per scene;
 15. timing_sort: sort_int64 with the switch on (K3 as the sort sites call
     it), torch.sort and the plain version by CUDA events at the eight sort
     shapes of one fragment forward;
 16. timing_test: at the shapes and valid counts the test phase gave the
     decoder's K1 calls (windows of 48, without lse) in one fragment
     forward, the kernel against its plain version in bf16, then the times
     of the kernel, the plain version and scaled_dot_product_attention, with
     the bound, per call and per fragment forward;
 17. ssl_train: the trainer on the SimDINO file
     configs/scannet/ssl-pretrain-scannet-all-base.py as it is
     (SimDINOSSL over a 5-stage PT-v3m1 with its mask token, windows of
     1024 in the encoder and 48 in the decoder, the DINO, iBOT and MAE
     heads, the EMA teacher, 2 global crops of 102,400 points with patch
     token masks and 3 local crops of 25,600, the multi-crop transforms
     with the voxel blur, AdamW + OneCycle, its own hooks) at batch 2 (the
     file's 24 is 6 a card on 4 cards) for 4 steps over 4 synthetic
     unlabeled rooms: step times, loader waits, peak memory, every loss
     term (finite), pooling overflow per stage and crop kind (none allowed
     past the first pooling, where the file's capacities overflow on dense
     rooms, as they do unseen in the JAX package), K1 launches
     of each variant with and without lse for the student and the teacher
     apart, K2 launches of each variant, the teacher held to m t + (1 - m) s
     at every step within fp32 rounding and its mask token unmoved; then
     ssl_timing_bwd, timing_bwd at the student's stage shapes (the first
     global crop's twice, the first local crop's three times, the locals'
     decoder forward only), and ssl_timing_teacher, timing at the teacher's
     shapes (its two passes over the global crops, K1 without lse);
 18. ssl_agree: one fp32 SSL loss and its gradients of that model at one
     block a stage with mean pooling (the file's max pooling makes the
     gradient a discontinuous function of the features), batch 2, global
     crops of 24,576 points with injected token masks and local crops of
     6,144, with the kernels and with the plain attention: the loss to
     1e-5, the gradient of each term apart, each tensor and the whole to
     1e-4 relative (the MCR expansion's from one cotangent at the student's
     DINO heads, given to both paths: its own is ill-conditioned);
 19. warm_start: python -m scenesplat_tpu_torch.rename_ckpt on ssl_train's
     checkpoint for the teacher and the student (each backbone bit for bit
     as backbone.*, no mask token); the train phase's flagship checkpoint
     into the semseg file's model and the extracted teacher into the
     flagship file's, as the files' non-strict CheckpointLoader loads them
     (every encoder tensor of stages 0-3 loaded bit for bit, every other
     tensor skipped or kept at its initialization, each one named in the
     log);
 20. semseg_train: the trainer on the semantic-segmentation file
     configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py as it is
     (DefaultSegmentorV2 over a 5-stage PT-v3m1, 32 heads at stage 4,
     in_channels 14, 205,824 points, CE + Lovasz, Mix3D 0.8, its own hooks:
     SemSegEvaluator, CheckpointSaver, PreciseEvaluator with the file's
     SemSegTester and 9 test-time views), started with weight= the
     extracted teacher (every backbone tensor but the stem, 11 vs 14
     channels, equal to the teacher's bit for bit after the file's
     CheckpointLoader; the stem and seg_head at their initialization; the
     log names them), at batch 2 for 4 steps over 4 synthetic ScanNet-layout
     scenes with normals and 20 classes and one validation scene: step
     times, loader waits, peak memory, val/mIoU, K1 and K2 launches of each
     variant a step, pooling overflow per stage (none allowed); then
     semseg_timing_bwd, timing_bwd at its stage shapes;
 21. semseg_agree: one fp32 train step of that model at one block a stage
     and 49,152 points with the kernels and with the plain attention
     (losses to 1e-5, gradients to 1e-4 relative);
 22. semseg_test: scenesplat_tpu_torch.test's main on the semseg file with
     the semseg_train checkpoint over one synthetic scene of 100,001
     Gaussians, 2 of the file's 9 views (TEST_VIEWS): torch.sort and K3 under deterministic
     algorithms (equal predictions and mIoU), then as a user runs it, for
     the seconds per scene (fetch, extract, vote); then semseg_timing_test
     (every K1 call of the first fragment forward, bf16_large and
     bf16_small without lse) and semseg_timing_sort (K3 at that forward's
     sort shapes);
 23. semseg_ddp_agree and ssl_ddp_agree: two ranks sharing the card over
     gloo, one row each, against one process over both rows, fp32, the
     files' models at one block a stage: semseg at 2 rows of 49,152 points,
     drop-path 0.3, CE + Lovasz over the gathered global batch (the loss
     to 1e-5, every gradient to 1e-4 of its norm, the BatchNorm statistics
     to 1e-6); SSL at crops of 24,576 and 6,144 with mean pooling and token
     masks drawn at the global shape (every loss term to 1e-5, every
     student gradient to 1e-4, the statistics to 1e-6, after the SGD step
     and the EMA the teacher bit-equal on both ranks and within 1e-6 of one
     process's, its mask token unmoved); K1 with lse and K2 on each rank;
 24. remat_agree: one fp32 train step of the flagship file's model at its
     widths, 2 rows of 24,576 points (1.7 m rooms), with remat_blocks off
     and on, under deterministic algorithms: the loss bit-equal, every
     gradient to 1e-5 of its norm, each run's peak memory and K1 / K2
     launches a step (the recompute launches K1 with lse once more a
     block);
 25. ppt_train: Point Prompt Training, MultiDatasetTrainer over the semseg
     file with a PPT-v1m1 model over its backbone (bf16, 205,824 points,
     PDNorm BatchNorms and LayerNorms, two conditions, ScanNetGS with 20
     classes and ScanNetPPGS with 100, the backbone's pdnorm_conditions in
     the other order, the ScanNet200 SigLIP2 table as class embeddings) at
     batch 2 for 3 steps over 4 synthetic rooms read by both datasets
     (loops 2 and 1: conditions A A B; it ran 6 steps, A A B A A B, before
     the Point Transformer phases came), then SemSegEvaluator over one
     validation room a condition: each step's condition, only its PDNorm
     statistics moved, K1 / K2 launches by variant, losses, step times,
     loader waits, peak memory, one profiled step, each condition's
     val/mIoU; then ppt_timing_bwd, timing_bwd at its stage shapes;
 26. ppt_test: the test entry point on that config with ppt_train's
     checkpoint, one SemSegTester a condition over a 100,001-Gaussian room
     (TEST_VIEWS: 2 of 9 views), as a user runs it: seconds per scene (fetch, extract,
     vote), K1 per fragment forward; then ppt_timing_test (every K1 call of
     the first fragment forward);
 27. ppt_agree: one fp32 loss of PPT-v1m1 and of PPT-v1m2 at one block a
     stage and 49,152 points on each condition, kernels against plain
     (losses to 1e-5, gradients to 1e-4 relative), only the active
     condition's norms (and v1m2's head) with gradients;
 28. ppt_ddp_agree: two ranks sharing the card over gloo against one
     process, PPT-v1m2 at one block a stage, 2 rows of 49,152, two steps
     through a change of condition under DDP with find_unused_parameters:
     each step's loss to 1e-5, every gradient to 1e-4 of its norm, the
     inactive head without gradient, statistics to 1e-6;
 29. rpe_agree: the semseg file's backbone with enable_rpe at 205,824
     points in bf16: zero tables against the K1 path of the same weights
     under the noise-floor rule (both against the fp32 K1 forward), each
     forward's time and peak memory; one bf16 train step of the semseg
     model with random tables: finite loss and gradients, every table's
     gradient nonzero, no K1 or K2 launch;
 30. spunet_agree: instance segmentation's model, PG-v1m1 over
     SpUNet-v1m1 at its published widths (channels 32 to 256, layers
     2 3 4 6 2 2 2 2), fp32, 2 rows of 8,192 points of a room with
     objects: one step's loss, gradients and BatchNorm statistics on the
     card against the CPU (1e-5; each gradient to 1e-4 of its norm or to
     2.5 times the noise floor of the card's step on the rows' points in 3
     other orders, about 5e-3 at this deep BatchNorm stack; 1e-5); then
     SpUNet-v1m3 (adaptive PDNorm, the batch named "S3DIS", a context): its
     forward on both (1e-4), only that condition's statistics moved;
 31. insseg_train: the trainer on the insseg configuration, the semseg
     file made PointGroup as Pointcept's PG config sets it (InstanceParser,
     PG-v1m1 over SpUNet-v1m1, SGD + PolyLR, InsSegEvaluator) at batch 2
     for 4 steps over 4 rooms of 200,000 points with 12 objects of classes
     2-19 each, then the evaluator over 2 rooms of 40,000: finite losses
     and seg terms above 0, no attention kernel, val mAP / AP50 / AP25, AP50
     the checkpoint metric, model_best.pth strict into a fresh PG; step
     times, loader waits, peak memory, one profiled step, pooling overflow
     per stage, proposals and clustering seconds a validation room;
 32. insseg_oracle: one validation room with its ground truth as logits
     and biases: the card's proposals and clusters equal the CPU's exactly,
     mAP = AP50 = AP25 = 1, the clustering's time on both;
 33. insseg_agree: PG over the semseg file's PT-v3m1 at one block a stage,
     49,152 points, fp32, one insseg step with the kernels (K1 with lse and
     K2) against the plain attention (losses 1e-5, gradients 1e-4);
 34. insseg_ddp_agree: phase 23's check for PG over SpUNet-v1m1: two ranks
     over gloo against one process at 2 rows of 8,192 (loss 1e-5,
     gradients and statistics 1e-4 and 1e-6 or under phase 30's noise-floor
     rule), no kernel launch;
 35. msc_agree: Masked Scene Contrast, MSC-v1m1 and MSC-v1m2 (CSC) over
     SpUNet-v1m1 at its published widths, fp32, 2 rows x 2 views of 8,192
     points, view 1 mixed, the card's own cross masks and pairs injected
     through the replay keys: one step's loss terms, gradients and
     statistics on the card against the CPU (terms to 1e-5 of the loss,
     gradients and statistics under phase 30's noise-floor rule);
 36. msc_train: the trainer on the semseg file made MSC-v1m1 pretraining
     as Pointcept's published MSC file sets it (two views of 205,824
     slots, view mixing 0.8, 8,192 pairs), batch 2, 4 steps, a seed whose
     draws mix view 1 in some steps and not in others: every loss term,
     pairs, masked shares, kNN ms, pooling overflow, step times, peak;
 37. cac_train and cac_test: the semseg file made CAC-v1m1 over the same
     SpUNet (14 channels, 20 classes, CE), batch 2, 4 steps, val mIoU
     through SemSegEvaluator, then the test entry point's SemSegTester over
     one 100,001-Gaussian room (TEST_VIEWS: 2 of 9 views) as a user runs it;
 38. cac_agree: CAC over the semseg file's PT-v3m1, one block a stage,
     fp32, 49,152 points, kernels against plain (losses 1e-5, gradients
     1e-4 or under the noise floor of 3 point-permuted kernel steps);
 39. msc_ddp_agree and cac_ddp_agree: phase 34's check for MSC (the card's
     draws injected, the pairs global) and CAC (global class sums): the
     loss to 1e-6. Phases 12, 23, 28, 34 and 39 take their one-process
     reference step (12: and test) where they stand, and their ranks run
     here, after cac_agree, in one spawn (shared_ddp_agree: each job in
     turn in one process group; a spawn each cost 21-33 s of process
     start, imports and a group); each check is made then;
 39a. tp_agree, cp_agree and cp_serve, jobs of the same spawn (their
     one-process references taken beside phase 39's): tensor parallel at
     (data 1, model 2), both ranks holding ddp_agree's two rows of 24,576
     points, the flagship file's fp32 model with each block's qkv, proj,
     fc1 and fc2 cut in two (K1 and K2 at H / 2 heads) under DDP over the
     points group, drop-path 0.3, the contrastive term on, clipped at 1.0:
     held to ddp_agree's one-process step with its gradients clipped by its
     own norm (loss 1e-5, every gathered gradient and the norm 1e-4, the
     BatchNorm statistics 1e-4, equal gradients on both ranks); context
     parallel at (data 1, seq 2), each rank half of each row's slots, the
     same step and bounds (K1 and K2 on the rank's whole windows); and
     cp_serve, one bf16 forward of the serve phase's model over a room of
     98,304 Gaussians at seq 2 against one process's (2.5 times the
     one-process bf16 forward's distance from its fp32 one, relative to
     the fp32 features' largest magnitude). Each rank's K1 and K2 launches
     (18 each a step, 18 K1 on bf16_large in cp_serve), local heads,
     gathered bytes, peak memory and seconds;
 40. ppt_spunet_train: ppt_train's run with PPT-v1m1 over SpUNet-v1m3
     (published widths, adaptive PDNorm, context 256): each step's
     condition and only its norms' statistics moved, each condition's val
     mIoU, no K1 or K2 launch;
 41. ptv2_agree: Point Transformer V2, fp32, one 1.7 m room of 4,096
     points (jittered off the lattice by 3 mm): the kNN and FPS indices on the
     card equal the CPU's; one train step (CE + Lovasz) of DefaultSegmentor
     over PT-v2m2 at Pointcept's published widths and depths, then PT-v2m1
     and PT-v2m3 (adaptive PDNorm named "S3DIS", a N(0, 1) context) at one
     block a stage, the card against a float64 step on the CPU (loss 1e-5;
     gradients and statistics 1e-4 or 2.5 times the noise floor: 3
     point-permuted card steps and the CPU's fp32 step's distance from the
     witness), K1 and K2 counted from 0 (none);
 42. ptv2_train: the trainer on the semseg file made Pointcept's
     semseg-pt-v2m2-0-base.py model (DefaultSegmentor over PT-v2m2, grid
     sizes 0.06 to 0.9375, drop path 0.3, task="semseg", the file's data,
     optimizer and hooks) at batch 2 for 5 steps over 4 synthetic rooms and
     one validation room: losses, val mIoU, no K1 or K2 launch, no pooling
     overflow, kNN ms a step, step times, loader waits, peak memory, one
     profiled step;
 43. ptv2_test: the test entry on that config and checkpoint over one
     100,001-Gaussian room (TEST_VIEWS: 2 of 9 views): torch.sort and K3 under
     deterministic algorithms (equal predictions and metrics, K3 once for
     each of the 4 grid poolings of every fragment forward), then as a
     user runs it, for the seconds per scene;
 44. ptv1_agree: PointTransformer-Seg50 under DefaultSegmentor, fp32, 2
     rows of 4,096 points, one step on the card against a float64 step on
     the CPU (the noise floor of the CPU's fp32 step, of the rows swapped
     and of 2 orders that keep each row's first point, where FPS starts),
     FPS ms a call on the card (the FPS kernel's launches counted);
     Cls38 and PartSeg26 (shape categories) eval
     forwards on both (1e-4); K1 and K2 counted from 0 (none);
 45. ppt_ptv2_train: ppt_train's run with PPT-v1m1 over PT-v2m3 at the
     published widths (adaptive PDNorm, context 256), 3 steps A A B: each
     step's condition and only its norms moved, val mIoU a condition, no
     K1 or K2 launch, no pooling overflow.
 46-49. mink_agree, spvcnn_agree, oacnns_agree, octformer_agree: the
     sparse-conv backbones (SPARSE_BACKBONES: MinkUNet34C, SPVCNN, OACNNs
     and OctFormer-v1m1 at their published widths, each under the v1
     DefaultSegmentor with the semseg file's CE + Lovasz), one fp32 train
     step of one row of 8,192 points (a 1 m room filled to two thirds,
     jittered 3 mm; OctFormer 16,384 in 1.4 m) on the card against a float64 step on the CPU
     (card_cpu_agree), SPVCNN's dropout and OctFormer's drop path off
     (OctFormer's per-scene drop path checked apart on the card; its steps
     at two blocks a stage and with capacities that keep every cluster);
     K1 and K2 counted from 0 (none);
 50-53. mink_train, spvcnn_train, oacnns_train, octformer_train: the
     semseg trainer on sparse_config(name) (the file's data, optimizer and
     hooks but PreciseEvaluator, and for all but mink the evaluator and the
     saver; task="semseg") at batch 2, 205,824 slots, 1 + 2 steps over 4
     synthetic rooms written once for the four, and one validation room:
     losses, mink's val mIoU, no K1 or K2 launch, each pool's
     clusters against its capacity (overflow reported), step times, loader
     waits, peak memory, one profiled step's idle share; OctFormer's
     batches inside its +-10.24 m octree;
 54. mink_test: the test entry on mink_train's config and checkpoint over
     one 100,001-Gaussian room (TEST_VIEWS: 2 of 9 views): torch.sort and K3 under
     deterministic algorithms (equal predictions and metrics, K3 6 times a
     fragment forward), then as a user runs it, for the seconds per room;
 55. fps_kernel: the farthest point sampling kernel
     (csrc/farthest_point_sampling.cu; it replaces no TPU kernel, the JAX
     FPS is an XLA fori_loop) against its plain loop on the card, ids
     bit-equal, at the 5 FPS calls of an ST forward over the train rows
     (2 rows of 205,824 slots: a room's lattice, where distances tie
     everywhere, and a jittered one with a padding tail and its first
     slots masked; each level the previous one's samples), at PTv1's 4
     (ptv1_agree's rows) and at PartSeg50's 4 (an object of 2,048 points):
     kernel and plain CUDA-event times, M, each level's blocks a row,
     whether it spilled and us a step, and the bound (the valid points'
     operations of the M steps at the fp32 rate);
 56. st_agree: one fp32 semseg train step of DefaultSegmentor over ST-v1m2
     at its default widths (channels 48-384, depths 3/9/3/3, the KPConv
     stem, the three RPE tables), 2 rows of 4,096 points, on the card
     against a float64 witness on the CPU (card_cpu_agree; the floor from
     the CPU's fp32 step and the card's step on the rows swapped, not from
     permuted points, which change ST's function); K1 and K2 counted from
     0 (none), the FPS kernel 5 times a step;
 57. st_train: the semseg trainer on st_config (the file's data, optimizer
     and hooks but PreciseEvaluator, task="semseg") at batch 2, 205,824
     slots, 1 + 2 steps over the sparse phases' rooms and one validation
     room: losses, val mIoU, no K1 or K2 launch, the FPS kernel's launches
     and ms a step, the window members truncated per stage (fine and
     coarse tables), step times, loader waits, peak memory, one profiled
     step's idle share;
 58. st_test: the test entry on st_train's config and checkpoint over one
     200,001-Gaussian room (TEST_VIEWS: 2 of 9 views): torch.sort and K3 under
     deterministic algorithms (equal predictions and metrics, K3 16 times a
     fragment forward: each stage's four window tables, some past one
     cluster's tile), then as a user runs it, for the seconds per room;
 59. cls_agree: DefaultClassifier (40 classes) over PT-v3m1 in cls_mode at
     Pointcept's ModelNet40 widths (the semseg file's encoder, windows of
     1024, coordinates and normals in), fp32, 2 synthetic objects of
     10,000 points through the test pipeline (NormalizeCoord, GridSample
     at 1 cm) padded into one batch: the card's logits with the K1 kernel
     (fp32, 14 launches, no pooling overflow) against the plain
     attention's and the CPU's (1e-4 of their scale);
 60. cls_test: the classifier in bf16 through the port's tester builder,
     as the test entry builds it: ClsTester over 16 objects, ClsVotingTester
     over 3 repeats of the scaled test pipeline, ClsEvaluator's
     before_train and after_epoch on a stub trainer: their records in the
     JAX testers' form, seconds an object, K1 14 a forward on bf16_large,
     no K2, K3 or FPS launch, no pooling overflow; 4 objects' bf16 logits
     against the fp32 kernel path's under the noise-floor rule; then
     cls_timing, phase 4's timing at the K1 calls of one classifier forward;
 61. partseg_test: PartSegTester through the builder, PTv1 PartSeg50 under
     DefaultSegmentor (16 shape categories, 50 parts, each object's
     cls_token), fp32, 8 objects of 2,048 points with 2 scaled variants
     each, on the card and on the CPU: logits to 1e-4 of their scale,
     ins_mIoU and cat_mIoU equal where the predictions are, the FPS kernel
     4 times a forward, no K1, K2 or K3;
 62. loss_agree: SmoothCELoss, FocalLoss, BinaryFocalLoss, DiceLoss,
     L1Loss, DINOLoss (3 centre updates), iBOTPatchLoss (3) and
     sinkhorn_knopp_teacher in fp32 on the card against float64 on the
     CPU, values, centres and gradients to 1e-5 of their scale.
 After phase 3, profiler_hook: RuntimeProfiler over 2 of 4 steps of a card
 matmul loop, the process's second profiler session (the first, serve's,
 pays the profiler's start), its Chrome trace holding CUDA kernel events;
 after phase 62, profiler_hook_last, the same after every other profiled
 phase: its trace holds the kernel events, or none and the hook warned
 (late in a process torch.profiler loses kernel events whatever profiles;
 tools/profiler_sessions.py).
To make room for phases 41-45, msc_train and cac_train run 4 steps where
they ran 6, and ppt_train and ppt_spunet_train 3 where they ran 6 (A A
B); for phases 46-54, semseg_train, insseg_train and cac_train run 3
steps where they ran 4 (ssl_train and msc_train keep 4: 2 samples a step
over 4 rooms needs an even count), ptv2_train 3 where it ran 5, the test
phases semseg_test, ppt_test, cac_test and ptv2_test (and mink_test)
take rooms of 200,001 Gaussians where they took 320,001, the flagship
rooms are written once for train and ddp_train, MSC-v1m2's agree step
runs one block a stage, the agree phases copy one built model where they
built one a run, each timing phase times the plain backward once where
it timed it twice, and the two-rank checks of phases 12 and 23-39 share one
spawn; for phases 55-58 the CPU witness steps of the agree phases take
fewer points (ptv2_agree 8,192 where it took 49,152; ptv1_agree 2 rows
of 4,096 where they were 16,384; spunet_agree, msc_agree and the insseg,
msc and cac two-rank checks 16,384 a row where they took 24,576), their
checks and bounds as they were; for phases 59-62, again fewer points in
the agree phases' CPU witness steps (mink_agree, spvcnn_agree and
oacnns_agree 8,192 where they took 16,384, in a 1 m room where it was
1.4 m, so that the row fills its shell as before; ptv2_agree 4,096 where it took 8,192,
in a 1.7 m room where it was 2.4 m, its FPS check 2,048 samples where
it took 4,096; spunet_agree, msc_agree and the insseg, msc and cac
two-rank checks 8,192 a row where they took 16,384), and remat_agree's
two rows 24,576 points in 1.7 m rooms where they took 49,152 in 2.4 m
ones, each room filled as before; their checks and bounds as they were),
five test phases' rooms (semseg_test, ppt_test, cac_test, ptv2_test,
mink_test) 100,001 Gaussians where they were 200,001 (st_test keeps
200,001: its window tables must pass one sort tile), and six test phases
(semseg_test, ppt_test, cac_test, ptv2_test, mink_test, st_test) 2 of
the file's test-time views where they took all 9 (TEST_VIEWS: the first
rotation and the flip), their checks as they were. Each phase's
JSON line carries the script's seconds so far (``t_s``); PERF.md gives the
whole script's seconds on one H100 80GB HBM3 at 700 W, run by run.
The kernel and kernel_bwd phases also hold K1 and K2 at a local crop's
encoder stage shapes (25,600 to 2,048 slots, whole windows of 1024).
Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises; without a CUDA card the script exits non-zero.

    python3 chip_smoke.py --cards N [flagship] [semseg] [ssl] [fit] [tp] [cp]

runs data parallel across N cards of one host instead (not the one-card
smoke test): the kernels' build, then the phases named (all but fit by
default): flagship, ddp_cards_train, the flagship file at its own global
batch of 8 as 2 rows a card on N = 4 cards (each rank a spawned process on
its card over NCCL, the train phase's rooms, one epoch's steps and one
sharded validation; the same losses on every rank), and ddp_cards_agree,
ddp_agree with one rank a card over NCCL on that run's checkpoint; semseg
and ssl, cards_semseg and cards_ssl, those files at their own global
batches of 48 and 24 (12 and 6 rows a card on 4), remat_blocks as
CARDS_REMAT says, for a few steps over 4 rooms (every card's warm step,
peak memory, loader wait and NCCL time; the same losses on every rank);
fit, cards_fit, on one card, those rows a card with remat_blocks off and
on, down to the largest batch that fits; tp and cp, cards_grid_tp and
cards_grid_cp, the flagship file's bf16 model under (data 2, model 2) and
(data 2, seq 2) over NCCL at 2 rows of 196,608 points a data rank, beside
cards_grid_dp, plain data parallel at 2 rows a card (cold and warm step
ms, a profiled step's NCCL and busy ms, peak memory per card).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import inspect
import json
import logging
import math
import multiprocessing as mp
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from scenesplat_tpu_torch.engines.eval import load_text_embeddings, zero_shot_predict
from scenesplat_tpu_torch import test as test_entry
from scenesplat_tpu_torch.data import metadata
from scenesplat_tpu_torch.engines.hooks import HookBase
from scenesplat_tpu_torch.engines.hooks.misc import PreciseEvaluator
from scenesplat_tpu_torch.engines.infer import FeatureExtractor, bucket_size
from scenesplat_tpu_torch.engines.pretrain import (
    SSLObjective,
    build_ssl_model,
    ssl_loss,
    ssl_train_step,
)
from scenesplat_tpu_torch.engines.train import build_trainer
import scenesplat_tpu_torch.engines.train_step as train_step_module
from scenesplat_tpu_torch.engines.train_step import (
    batch_to_device,
    insseg_loss,
    lang_loss,
    point_from_batch,
    ppt_loss,
    semseg_loss,
    train_step,
)
from scenesplat_tpu_torch.entry import (
    FLAGSHIP_BACKBONE,
    SHIPPED_INFERENCE_BACKBONE,
    build_lang_model,
)
from scenesplat_tpu_torch.models import PointBatch, build_criteria, build_model
from scenesplat_tpu_torch.models import stratified
from scenesplat_tpu_torch.models.ppt import valid_index_by_name
from scenesplat_tpu_torch.models.ptv3 import PointTransformerV3, _round_capacity
from scenesplat_tpu_torch.models.ssl import generate_token_masks
from scenesplat_tpu_torch.ops import bitonic_sort as bs
from scenesplat_tpu_torch.ops import flash_window_attn as fwa
from scenesplat_tpu_torch.ops import fps as fps_ops
from scenesplat_tpu_torch.ops import pointops
from scenesplat_tpu_torch.ops import window_attention as window_attention_module
from scenesplat_tpu_torch.ops.knn import knn
from scenesplat_tpu_torch.ops.serialization import SENTINEL, take_along_points
from scenesplat_tpu_torch.parallel import context
from scenesplat_tpu_torch.parallel.context import context_groups, shard_point_batch
from scenesplat_tpu_torch.parallel.dist import (
    all_reduce_sum,
    data_parallel,
    init_distributed,
    layout,
    local_batch_slice,
    process_group,
    set_layout,
    world,
)
from scenesplat_tpu_torch.parallel.tp import gather_whole, shard_model_tp, tp_groups
from scenesplat_tpu_torch.utils.config import Config

FLAGSHIP_CONFIG = "configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py"
PIPELINES = "configs/_base_/gs_pipelines.py"

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
GRID = 0.02  # metres per voxel
FP32_ATOL = 1e-4
BF16_NOISE_FACTOR = 2.5
# the timing phases time the plain version (the attention's yardstick) once
# each way after one untimed warm-up (so no call that is timed pays first-use
# set-up): at the train shapes its calls took most of each phase's seconds
# (they took a warm-up and three timed forwards, a warm-up and one backward)
PLAIN_REPS = dict(reps=1, warmup=1)
# fp32 features with the kernel vs the plain attention, unit-norm 768-d rows:
# each attention call agrees to ~1e-6 (fp32 summation order), and 18 blocks
# of LayerNorm'd residual updates carry that far below this bound
AGREE_ATOL = 1e-3
AGREE_ARGMAX = 0.99
# backward, fp32: each gradient within 1e-4 of the plain gradient's largest
# magnitude (the kernel and autograd sum in other orders)
BWD_FP32_RTOL = 1e-4
# one fp32 train step, kernels vs plain attention: losses to 1e-5 relative,
# each parameter gradient to 1e-4 relative L2 of its own norm. A gradient
# that is zero in exact arithmetic (the bias of a linear layer whose every
# consumer is a BatchNorm, which the batch mean cancels) is rounding noise on
# both sides, below ZERO_GRAD of the global gradient norm; the other tensors
# lie above 1e-6 of it
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
ZERO_GRAD = 1e-7
# SpUNet's step (PointGroup over SpUNet-v1m1 at its published widths, a
# deep stack of BatchNorms, at its random initialization) moves its fp32
# gradients by up to 5.5e-3 of their norms (2.3e-3 the whole) when only the
# order of its sums changes (each row's points permuted, one process on the
# CPU, 2 x 24,576 points): its comparisons take that noise floor, times
# this factor (the bf16 rule's), where it lies above TRAIN_GRAD_RTOL
NOISE_FLOOR_FACTOR = 2.5
FLOOR_PERMUTATIONS = 3
TRAIN_POINTS = 196608
TRAIN_CLASSES = 20
LANG_DIM = 768
SEMSEG_CONFIG = "configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py"
SSL_CONFIG = "configs/scannet/ssl-pretrain-scannet-all-base.py"


START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets the script's seconds so far
    (``t_s``), the breakdown of its running time."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - START, 1))
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_k1_counts():
    """K1's launch counts to 0, as just before a path is driven."""
    fwa.flash_window_attention.reset()


def k1_variants():
    """K1's launches of each variant since the last reset."""
    return dict(fwa.flash_window_attention.variant_launches)


def k1_lse_variants():
    """K1's launches with the log-sum-exp, of each variant, since the last
    reset."""
    return dict(fwa.flash_window_attention.lse_variant_launches)


def depth_split(backbone):
    """(encoder blocks, decoder blocks) of a backbone config: the K1
    launches a forward makes at the encoder's and at the decoder's
    windows."""
    return sum(backbone["enc_depths"]), sum(backbone["dec_depths"])


def room_scene(rng, n, size_m, thickness=1):
    """n unique 2 cm voxels on the floor and the four walls of a room of
    ``size_m`` metres, surfaces ``thickness`` voxels thick, with 11 Gaussian
    features (colour, opacity, unit quaternion, scale) -> (coord, feat,
    grid_coord)."""
    ex, ey, ez = (int(round(s / GRID)) for s in size_m)
    x, y, z = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij")
    t = thickness
    surface = (z < t) | (x < t) | (x >= ex - t) | (y < t) | (y >= ey - t)
    vox = np.stack([x[surface], y[surface], z[surface]], -1)
    check(len(vox) >= n, f"room {size_m} holds {len(vox)} voxels < {n}")
    grid = vox[rng.choice(len(vox), n, replace=False)].astype(np.int64)
    coord = ((grid + 0.5) * GRID).astype(np.float32)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    feat = np.concatenate([
        rng.uniform(-1, 1, (n, 3)),  # colour
        rng.uniform(0, 1, (n, 1)),  # opacity
        quat,
        rng.uniform(0, 0.05, (n, 3)),  # scale
    ], axis=1).astype(np.float32)
    return coord, feat, grid


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libraries = (fwa.LIBRARY, fwa.LIBRARY_SMALL, fwa.LIBRARY_LARGE, fwa.LIBRARY_BWD,
                 fwa.LIBRARY_BWD_LARGE, bs.LIBRARY, fps_ops.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, together
        build_s = dict(zip((lib.source.name for lib in libraries),
                           pool.map(lambda lib: lib.build(), libraries)))
    wall_s = time.perf_counter() - t0
    ptxas = {}
    for lib in libraries:
        lib.load()
        ptxas[lib.source.name] = [
            ln.split("ptxas info    : ")[-1] for ln in lib.log_path().read_text().splitlines()
            if "registers" in ln or "spill" in ln][:40]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
              cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
              build_s=build_s, build_wall_s=wall_s, ptxas=ptxas))
    return smi


def check_noise_floor(err, floor, what, shape, least=1e-4):
    """The noise-floor rule of tests/test_attention.py: the kernel's relative
    error on bf16 (or fp16) input against the plain version run in fp32 may
    be at most BF16_NOISE_FACTOR times the plain version's own in that
    type, which must lie above ``least`` (the path ran in that type)."""
    check(floor > least, f"low-precision path not exercised ({what}) at {shape}")
    check(err <= BF16_NOISE_FACTOR * floor,
          f"low-precision {what} error {err} > {BF16_NOISE_FACTOR} x {floor} at {shape}")


def check_bf16(x16, valid, k, h, out=None):
    """The kernel's bf16 (or fp16) output (``out``, else the inference
    launch's) under the noise-floor rule. Returns both errors."""
    chunk = max(8, 16384 // k)  # windows per plain chunk: the result is the same
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h,
                                             patch_chunk=chunk)[valid]

    def rel(o):
        return ((o[valid].float() - truth).norm() / truth.norm()).item()

    if out is None:
        out = fwa.flash_window_attention(x16, valid, k, h)
    err = rel(out)
    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h, patch_chunk=chunk))
    check_noise_floor(err, floor, "output", ("N, K, C, H", x16.shape[1], k, x16.shape[3], h),
                      least=LOW_PRECISION_FLOOR.get(x16.dtype, 1e-4))
    return err, floor


SIGNATURES = sorted({
    (k, c, h)
    for k in (1024, 48)
    for c, h in ((768, 16), (512, 16), (256, 16))
} | {(1024, c, h) for c, h in ((32, 2), (64, 4), (128, 8), (256, 16))}
  # windows on both sides of the bf16 variants' thresholds (forward 64 and
  # 128, backward 64)
  | {(k, c, h) for k in (16, 32, 64, 65, 128, 192, 256)
     for c, h in ((768, 16), (512, 16), (32, 2))}
  # above the large-window forward's 4096: the tiled forward again
  | {(4160, 32, 2)}
  # the semseg files' backbone: 32 heads at encoder stage 4, and the
  # decoder's 4 heads at C = 64 and 8 at C = 128 at windows of 48
  | {(1024, 512, 32), (48, 64, 4), (48, 128, 8)}
  # the flagship's blocks on a tensor-parallel rank at model 2 (tp_agree):
  # H / 2 heads at the unchanged head width
  | {(1024, 16, 1), (48, 384, 8), (48, 256, 8)})
# the encoder stages of a local crop of the SSL file (25,600 points, windows
# of 1024: whole windows, two at stage 4): (N, K, C, H), checked beside
# SIGNATURES at their own N
SSL_LOCAL_STAGES = ((25600, 1024, 32, 2), (13312, 1024, 64, 4), (7168, 1024, 128, 8),
                    (4096, 1024, 256, 16), (2048, 1024, 512, 32))
KERNEL_CASES = [(k, c, h, None) for k, c, h in SIGNATURES] + [
    (k, c, h, n) for n, k, c, h in SSL_LOCAL_STAGES]
# the bf16 forward variant each of these windows of SIGNATURES must take
VARIANT_WINDOWS = {"bf16_small": {16, 32, 48, 64}, "bf16_tiled": {65, 4160},
                   "bf16_large": {128, 192, 256, 1024}}
LSE_ATOL = 1e-4  # bf16 forward: fp32 log-sum-exp against the plain one


def signature_inputs(gen, k, c, batch=2, n=None):
    """qkv [batch, N, 3, c] fp32 and valid prefixes for windows of k, by
    default N with a ragged last window: a partial window, then fully padded
    windows; with batch 4 also prefixes that end on a 64-key tile edge and
    one past it."""
    n = n or 3 * k + k // 2 + 5
    valid = torch.zeros(batch, n, dtype=torch.bool, device="cuda")
    valid[0, : int(0.8 * n)] = True  # ends inside a key tile
    valid[1, : k + 7] = True  # then fully padded windows
    if batch > 2:
        valid[2, : k + 64] = True
        valid[3, : k + 65] = True
    qkv = torch.randn(batch, n, 3, c, generator=gen, device="cuda")
    p = -(-n // k)
    slot0 = torch.nn.functional.pad(valid, (0, p * k - n)).view(batch, p, k)[:, :, :1]
    dead = ~slot0.expand(batch, p, k).reshape(batch, p * k)[:, :n]  # windows of padding
    return n, qkv, valid, dead


def plain_lse(qkv, valid, k, h):
    """The natural-log log-sum-exp of each row's scaled scores over the valid
    keys of its window, [B, N, H] fp32, in plain torch ops."""
    b, n, _, c = qkv.shape
    d, p = c // h, -(-n // k)
    pad = p * k - n
    qkv = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    blk = qkv.view(b, p, k, 3, h, d).permute(3, 0, 1, 4, 2, 5)
    scores = (blk[0] * d ** -0.5).float() @ blk[1].float().transpose(-1, -2)
    scores = torch.where(valid.view(b, p, 1, 1, k), scores, float("-inf"))
    return torch.logsumexp(scores, -1).permute(0, 1, 3, 2).reshape(b, p * k, h)[:, :n]


def phase_kernel():
    """Kernel vs plain at every signature; returns the fp32 max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst32, rows = 0.0, []
    for k, c, h, n_case in KERNEL_CASES:
        n, qkv, valid, dead = signature_inputs(gen, k, c, batch=4, n=n_case)
        out32 = fwa.flash_window_attention(qkv, valid, k, h)
        ref32 = fwa.flash_window_attention_plain(qkv, valid, k, h)
        torch.cuda.synchronize()
        check(torch.isfinite(out32).all().item(), f"non-finite output at {k, c, h}")
        err32 = (out32 - ref32)[valid].abs().max().item()
        check((out32[dead] == 0).all().item(), f"padded windows not zero at {k, c, h}")

        x16 = qkv.bfloat16()
        variant = fwa.forward_variant(x16.dtype, k, c // h)
        out16, lse16 = fwa._forward(x16, valid, k, h, (c // h) ** -0.5, True)[:2]
        err16, floor16 = check_bf16(x16, valid, k, h, out=out16)
        check((out16[dead] == 0).all().item(), f"bf16 padded windows not zero at {k, c, h}")
        check(torch.equal(out16, fwa.flash_window_attention(x16, valid, k, h)),
              f"bf16 output differs with and without the log-sum-exp at {k, c, h}")
        lse_err = (lse16 - plain_lse(x16, valid, k, h))[~dead].abs().max().item()
        check(lse_err <= LSE_ATOL, f"bf16 log-sum-exp error {lse_err} at {k, c, h}")
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err=err32, bf16_variant=variant,
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16,
                         bf16_lse_max_abs_err=lse_err))
        check(err32 <= FP32_ATOL, f"fp32 error {err32} > {FP32_ATOL} at {k, c, h}")
        worst32 = max(worst32, err32)
    for variant, windows in VARIANT_WINDOWS.items():
        took = {r["K"] for r in rows if r["bf16_variant"] == variant}
        check(took == windows, f"bf16 {variant} took windows {sorted(took)}, expected "
              f"{sorted(windows)}")
    emit(dict(phase="kernel", fp32_atol=FP32_ATOL, bf16_noise_factor=BF16_NOISE_FACTOR,
              bf16_lse_atol=LSE_ATOL, cases=rows))
    return worst32


def stage_shapes(backbone, sizes):
    """(N, valid, K, C, H, launches) of every attention call of one forward,
    grouped by stage, from each stage's (slots, valid count) in ``sizes``;
    what the config leaves out (the flagship file's ``dec_patch_size``)
    takes the backbone's default."""
    params = inspect.signature(PointTransformerV3.__init__).parameters.values()
    backbone = {**{p.name: p.default for p in params if p.default is not p.empty},
                **backbone}
    enc_c, enc_h = backbone["enc_channels"], backbone["enc_num_head"]
    shapes = [(n, v, backbone["enc_patch_size"][s], enc_c[s], enc_h[s],
               backbone["enc_depths"][s]) for s, (n, v) in enumerate(sizes)]
    for s in reversed(range(len(sizes) - 1)):
        n, v = sizes[s]
        shapes.append((n, v, backbone["dec_patch_size"][s], backbone["dec_channels"][s],
                       backbone["dec_num_head"][s], backbone["dec_depths"][s]))
    return shapes


def serve(model, sample, text, reps):
    """One cold and ``reps`` warm requests (feature extraction, then
    zero-shot prediction on the host). Returns features, predictions, the
    plans of the last forward and per request the milliseconds of
    extraction and of prediction, on the host clock."""
    plans = []

    def keep_plans(out):
        plans[:] = out.plans
        return out.feat

    extractor = FeatureExtractor(model, patch_size=1024, device="cuda",
                                 output_fn=keep_plans)
    times = []
    for _ in range(1 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat = extractor(sample)  # ends with the copy to the host
        t1 = time.perf_counter()
        pred, _ = zero_shot_predict(feat, text)
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    return feat, pred, plans, times


def device_kernels(prof):
    """A profile's device work by name: kernels and copies, not the ranges
    that code annotates (an annotated range's device time, such as
    DistributedDataParallel.forward's or the optimizer step's, repeats its
    kernels' time)."""
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0 and not e.is_user_annotation]


def device_profile(model, point):
    """Device time of one forward by kernel, from torch.profiler: the busy
    time, the wall time of the forward and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(point)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms if wall_ms else None,
                top_kernels=[dict(name=e.key[:90], calls=e.count,
                                  ms=e.self_device_time_total / 1e3) for e in top])


def check_features(feat, n, name):
    check(feat.shape == (n, 768), f"{name}: feature shape {feat.shape}")
    check(np.isfinite(feat).all(), f"{name}: non-finite features")
    norms = np.linalg.norm(feat, axis=1)
    check(np.abs(norms - 1).max() < 1e-2, f"{name}: features not L2-normalized")


def phase_serve(text):
    n, reps = 196608, 3
    rng = np.random.default_rng(0)
    coord, feat_in, grid = room_scene(rng, n, (6.0, 6.0, 3.0))
    backbone = dict(FLAGSHIP_BACKBONE)
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    sample = dict(coord=coord, feat=feat_in, grid_coord=grid)
    torch.cuda.reset_peak_memory_stats()
    reset_k1_counts()
    feat, pred, plans, times = serve(model, sample, text, reps)
    launches, variants = fwa.flash_window_attention.launches, k1_variants()
    check(variants["bf16_large"] == launches,
          f"the serve path's launches (bf16, windows of 1024) did not all take the "
          f"large-window kernel: {variants}")
    check_features(feat, n, "serve")
    overflow = [int(p.n_overflow.max()) for p in plans]
    clusters = [int(p.n_clusters.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
    check(launches == 18 * (1 + reps), f"{launches} kernel launches for {1 + reps} "
          "forwards, expected 18 each")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the forward alone, on a batch already on the card (196,608 is a bucket)
    point = PointBatch(
        coord=torch.from_numpy(coord)[None].cuda(),
        feat=torch.from_numpy(feat_in)[None].cuda(),
        grid_coord=torch.from_numpy(grid)[None].cuda(),
        mask=torch.ones(1, n, dtype=torch.bool, device="cuda"))
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(point), reps=3, warmup=1)
    profile = device_profile(model, point)

    uniq, counts = np.unique(pred, return_counts=True)
    emit(dict(phase="serve", points=n, dtype="bfloat16", requests=1 + reps,
              cold_extract_ms=times[0][0], warm_extract_ms=[t[0] for t in times[1:]],
              zero_shot_ms=[t[1] for t in times], forward_ms=forward_ms,
              kernel_launches=launches, launches_per_forward=launches / (1 + reps),
              variant_launches=variants,
              n_clusters=clusters, n_overflow=overflow, peak_mem_gib=peak_gib,
              classes_predicted=len(uniq),
              class_histogram=dict(zip(uniq.tolist(), counts.tolist())),
              profile=profile))
    sizes = [(n, n)] + [(p.out_mask.shape[1], int(p.out_mask.sum())) for p in plans]
    return stage_shapes(backbone, sizes), launches, variants


def bound_ms(n, n_valid, k, c):
    """Least time for one bf16 call, as (ops_ms, bytes_ms): the needed work
    (valid query rows against the valid keys of their window) at the bf16
    peak, and the bytes (qkv of live windows read once, the output written
    once, the mask read once) at the memory rate."""
    ops, rows_live = 0, 0
    for w0 in range(0, n, k):
        v = max(0, min(n_valid, w0 + k) - w0)
        ops += 4 * v * v * c
        rows_live += min(k, n - w0) if v else 0
    nbytes = 2 * (3 * c * rows_live + c * n) + n
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_timing(shapes, phase="timing", dtype=torch.bfloat16):
    """Kernel against plain (bf16 noise-floor rule; fp16 with ``dtype``),
    then kernel, plain and library times per call at the main path's
    shapes, and the times' sums over one forward. A shape's valid count is
    one row's, or a list of the rows' (a batch)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    by_variant = {}  # the sums over each variant's calls
    for n, n_valid, k, c, h, count in shapes:
        valids = n_valid if isinstance(n_valid, (list, tuple)) else [n_valid]
        b = len(valids)
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").to(dtype)
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
        err16, floor16 = check_bf16(qkv, valid, k, h)
        ms = cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps=10)
        plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                           **PLAIN_REPS)
        p, d = -(-n // k), c // h
        pad = p * k - n
        qkv_w = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], 1) if pad else qkv
        valid_w = torch.cat([valid, valid.new_zeros(b, pad)], 1) if pad else valid
        q, kk, v = qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid_w.view(b * p, 1, 1, k)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps=10)
        ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms)
        tflops = ops_ms * PEAK_BF16_FLOPS / ms / 1e12  # needed operations over the time
        rows.append(dict(N=n, valid=n_valid, K=k, C=c, H=h, launches=count, **row,
                         bound_ms=max(ops_ms, bytes_ms), bf16_rel_err=err16,
                         bf16_plain_rel_err=floor16,
                         variant=fwa.forward_variant(qkv.dtype, k, d), tflops=tflops,
                         library_tflops=ops_ms * PEAK_BF16_FLOPS / lib_ms / 1e12,
                         share_of_bf16_peak=ops_ms / ms))
        part = by_variant.setdefault(rows[-1]["variant"], dict.fromkeys(tot, 0.0))
        for key, val in row.items():
            tot[key] += count * val
            part[key] += count * val
        part["launches"] = part.get("launches", 0) + count
        del qkv, qkv_w, q, kk, v
    for t in (tot, *by_variant.values()):
        t["bound_ms"] = max(t["ops_ms"], t["bytes_ms"])
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
    tot["by_variant"] = by_variant
    emit(dict(phase=phase, dtype=str(dtype).removeprefix("torch."), per_call=rows,
              per_forward=tot))
    return tot


def phase_shipped(text):
    n = 65536
    rng = np.random.default_rng(1)
    coord, feat_in, grid = room_scene(rng, n, (3.0, 3.0, 3.0))
    backbone = dict(SHIPPED_INFERENCE_BACKBONE)
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    reset_k1_counts()
    feat, pred, plans, times = serve(
        model, dict(coord=coord, feat=feat_in, grid_coord=grid), text, reps=0)
    launches, variants = fwa.flash_window_attention.launches, k1_variants()
    enc, dec = depth_split(backbone)
    check(variants["bf16_large"] == enc and variants["bf16_small"] == dec,
          f"shipped: variant launches {variants}, expected {enc} bf16_large (windows of "
          f"1024) and {dec} bf16_small (windows of 48)")
    check_features(feat, n, "shipped")
    overflow = [int(p.n_overflow.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
    check(launches == 18, f"{launches} kernel launches, expected 18")
    sizes = [n] + [p.out_mask.shape[1] for p in plans]
    ragged = [s for s in sizes[:-1] if s % 48]
    check(len(ragged) == len(sizes) - 1, f"decoder stages {sizes[:-1]} not all ragged")
    emit(dict(phase="shipped", points=n, dec_window=48, stage_sizes=sizes,
              ragged_decoder_stages=ragged, extract_ms=times[0][0], kernel_launches=launches,
              variant_launches=variants,
              n_overflow=overflow, classes_predicted=int(len(np.unique(pred)))))
    return launches


def phase_agree(text):
    n = 49152
    rng = np.random.default_rng(2)
    coord, feat_in, grid = room_scene(rng, n, (3.0, 3.0, 3.0))
    sample = dict(coord=coord, feat=feat_in, grid_coord=grid)
    model_k = build_lang_model(FLAGSHIP_BACKBONE, dtype="float32", device="cuda", seed=1)
    model_p = build_model(dict(type="LangPretrainer", backbone=dict(
        FLAGSHIP_BACKBONE, dtype="float32", use_kernel=False))).to("cuda").eval()
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    before = fwa.flash_window_attention.launches
    feat_k = FeatureExtractor(model_k, patch_size=1024, device="cuda")(sample)
    check(fwa.flash_window_attention.launches == before + 18, "kernel path not taken")
    feat_p = FeatureExtractor(model_p, patch_size=1024, device="cuda")(sample)
    check(fwa.flash_window_attention.launches == before + 18, "plain path launched")
    check_features(feat_k, n, "agree/kernel")
    pred_k, _ = zero_shot_predict(feat_k, text)
    pred_p, _ = zero_shot_predict(feat_p, text)
    diff = float(np.abs(feat_k - feat_p).max())
    same = float((pred_k == pred_p).mean())
    emit(dict(phase="agree", points=n, dtype="float32", max_abs_diff=diff,
              atol=AGREE_ATOL, argmax_agreement=same, min_agreement=AGREE_ARGMAX))
    check(diff <= AGREE_ATOL, f"kernel vs plain features differ by {diff}")
    check(same >= AGREE_ARGMAX, f"argmax agreement {same}")


def grads_of(fn, qkv, valid, k, h, dout):
    """(output, d output / d qkv) of ``fn`` for output gradient ``dout``."""
    x = qkv.detach().clone().requires_grad_(True)
    out = fn(x, valid, k, h)
    out.backward(dout)
    return out.detach(), x.grad


def phase_kernel_bwd():
    """Backward kernel vs autograd through the plain version at every
    signature; returns the fp32 max abs gradient error and that of the
    forward with log-sum-exp (the Function's forward)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, worst_fwd, rows = 0.0, 0.0, []
    for k, c, h, n_case in KERNEL_CASES:
        n, qkv, valid, dead = signature_inputs(gen, k, c, n=n_case)
        dout = torch.randn(2, n, c, generator=gen, device="cuda")
        out32, g32 = grads_of(fwa.flash_window_attention, qkv, valid, k, h, dout)
        ref_out, ref32 = grads_of(fwa.flash_window_attention_plain, qkv, valid, k, h, dout)
        torch.cuda.synchronize()
        check(torch.isfinite(g32).all().item(), f"non-finite gradient at {k, c, h}")
        err_fwd = (out32 - ref_out)[valid].abs().max().item()
        check(err_fwd <= FP32_ATOL, f"fp32 forward-with-lse error {err_fwd} at {k, c, h}")
        worst_fwd = max(worst_fwd, err_fwd)
        errs = [(g32[:, :, i] - ref32[:, :, i]).abs().max().item() for i in range(3)]
        scale = [ref32[:, :, i].abs().max().item() for i in range(3)]
        check((g32[dead] == 0).all().item(), f"padded windows' gradients not zero at {k, c, h}")

        x16, d16 = qkv.bfloat16(), dout.bfloat16()
        _, truth = grads_of(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                            d16.float())

        def rel(g):
            return ((g.float() - truth).norm() / truth.norm()).item()

        variant = fwa.backward_variant(x16.dtype, k, c // h)
        before = fwa.flash_window_attention_bwd.variant_launches[variant]
        g16 = grads_of(fwa.flash_window_attention, x16, valid, k, h, d16)[1]
        check(fwa.flash_window_attention_bwd.variant_launches[variant] == before + 1,
              f"the {variant} backward did not run at {k, c, h}")
        check((g16[dead] == 0).all().item(), f"bf16 padded windows' gradients not zero at "
              f"{k, c, h}")
        err16 = rel(g16)
        floor16 = rel(grads_of(fwa.flash_window_attention_plain, x16, valid, k, h, d16)[1])
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err_dq_dk_dv=errs,
                         fp32_max_abs_grad=scale, fp32_fwd_lse_max_abs_err=err_fwd,
                         bf16_variant=variant, bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        for name, e, m in zip(("dq", "dk", "dv"), errs, scale):
            check(e <= BWD_FP32_RTOL * m, f"fp32 {name} error {e} > {BWD_FP32_RTOL} x {m} "
                  f"at {k, c, h}")
        check_noise_floor(err16, floor16, "gradient", ("K, C, H", k, c, h))
        worst = max(worst, *errs)
    check({r["bf16_variant"] for r in rows} == {"bf16_small", "bf16_large"},
          "the signatures do not reach both bf16 backward variants")
    emit(dict(phase="kernel_bwd", fp32_rtol=BWD_FP32_RTOL,
              bf16_noise_factor=BF16_NOISE_FACTOR, cases=rows))
    return worst, worst_fwd


# kernel_widths: head widths off the instantiated ones (8, 24, 40: padded to
# 16, 32, 48) and the new instantiated ones (64, 96, 128) in every storage
# type, fp16 also at the shipped widths, at windows on both sides of every
# variant's threshold (forward 64 and 128 and 4096, backward 64)
WIDTH_CASES = [(d, dt) for d in (8, 24, 40, 64, 96, 128)
               for dt in (torch.float32, torch.bfloat16, torch.float16)] + [
    (d, torch.float16) for d in (16, 32, 48)]
WIDTH_WINDOWS = (48, 64, 65, 128, 1024, 4160)
WIDTH_HEADS = 2
# the noise-floor rule's check that the low-precision path ran: the plain
# version's own relative error lies above this (fp16 rounds 8 times finer
# than bf16)
LOW_PRECISION_FLOOR = {torch.bfloat16: 1e-4, torch.float16: 1e-5}
# kernel_widths times every variant at head width 64 (the wide path's) at
# these windows: bf16_small and the one-pass backward, bf16_large and the
# two-kernel backward, bf16_tiled past 4096; fp32 at each
WIDTH_TIMED = (64, (48, 1024, 4160))
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def typed_bound_ms(n, valids, k, c, dtype, backward=False):
    """Least time of one call in ``dtype``, as (ops_ms, bytes_ms): 4 v^2 C
    operations a window of v valid slots forward, 10 v^2 C backward, at the
    type's peak (fp32 outside the tensor cores); the bytes of the function,
    each read or written once: qkv of live windows (and dO backward) read,
    the output (dqkv) written, the mask read."""
    esz = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    ops, rows_live = 0, 0
    for nv in valids:
        for w0 in range(0, n, k):
            v = max(0, min(nv, w0 + k) - w0)
            ops += (10 if backward else 4) * v * v * c
            rows_live += min(k, n - w0) if v else 0
    if backward:
        nbytes = rows_live * esz * 4 * c + len(valids) * n * (esz * 3 * c + 1)
    else:
        nbytes = rows_live * esz * 3 * c + len(valids) * n * (esz * c + 1)
    return ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def time_width_case(x, valid, dout, k, h):
    """K1 and K2 at one case: kernel, plain and scaled_dot_product_attention
    times (the library yardstick, used nowhere in the port), forward and
    backward, with the bound of each."""
    b, n, _, c = x.shape
    d = c // h
    valids = valid.sum(1).tolist()
    row = dict(fwd_ms=cuda_ms(lambda: fwa.flash_window_attention(x, valid, k, h), reps=10),
               fwd_plain_ms=cuda_ms(lambda: fwa.flash_window_attention_plain(x, valid, k, h),
                                    **PLAIN_REPS))
    out, lse = fwa._forward(x, valid, k, h, d ** -0.5, True)[:2]
    row["bwd_ms"] = cuda_ms(lambda: fwa.flash_window_attention_bwd(
        x, valid, out, lse, dout, k, h, d ** -0.5), reps=10)
    xg = x.detach().clone().requires_grad_(True)
    row["bwd_plain_ms"] = backward_ms(lambda: fwa.flash_window_attention_plain(xg, valid, k, h),
                                      [xg], dout, **PLAIN_REPS)[0]
    p = -(-n // k)
    pad = p * k - n
    x_w = torch.cat([x, x.new_zeros(b, pad, 3, c)], 1) if pad else x
    valid_w = torch.cat([valid, valid.new_zeros(b, pad)], 1) if pad else valid
    q, kk, v = [t.detach().requires_grad_(True) for t in
                x_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()]
    mask = valid_w.view(b * p, 1, 1, k)
    dout_w = torch.cat([dout, dout.new_zeros(b, pad, c)], 1) if pad else dout
    dout_w = dout_w.view(b * p, k, h, d).transpose(1, 2).contiguous()

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=mask)

    with torch.no_grad():
        row["fwd_library_ms"] = cuda_ms(library, reps=5)
    row["bwd_library_ms"] = backward_ms(library, [q, kk, v], dout_w, reps=3)[0]
    for pre, backward in (("fwd_", False), ("bwd_", True)):
        ops_ms, bytes_ms = typed_bound_ms(n, valids, k, c, x.dtype, backward)
        row[pre + "bound_ms"] = max(ops_ms, bytes_ms)
        row[pre + "bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    return row


def width_counts():
    """K1's and K2's launches by (variant, storage type, instantiated
    width) since the last reset, and the launches the wrapper padded."""
    f, b = fwa.flash_window_attention, fwa.flash_window_attention_bwd
    return dict(k1={"/".join(map(str, key)): n for key, n in sorted(f.width_launches.items())},
                k2={"/".join(map(str, key)): n for key, n in sorted(b.width_launches.items())},
                k1_padded=f.padded_launches, k2_padded=b.padded_launches)


def phase_kernel_widths():
    """K1 and K2 at every WIDTH_CASES width and type and every WIDTH_WINDOWS
    window against the plain version (forward and autograd through it):
    fp32 to FP32_ATOL (the forward) and BWD_FP32_RTOL (each gradient), bf16
    and fp16 under the noise-floor rule against the plain version in the
    same type, the log-sum-exp to LSE_ATOL, zeros in windows of padding,
    each call on the variant and padded width forward_variant and
    backward_variant name, and counted there; with the wrapper pad's time
    at a window of 1024 where the width is padded. Returns the largest fp32
    error."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst32, rows = 0.0, []
    fwa.reset_counts()
    for d, dtype in WIDTH_CASES:
        h, dp = WIDTH_HEADS, fwa.padded_head_dim(d)
        c = h * d
        name = str(dtype).removeprefix("torch.")
        for k in WIDTH_WINDOWS:
            shape = (name, d, k)
            n, qkv, valid, dead = signature_inputs(gen, k, c, batch=4 if k < 1024 else 2)
            x = qkv.to(dtype)
            dout = torch.randn(x.shape[0], n, c, generator=gen, device="cuda").to(dtype)
            fwd_v = fwa.forward_variant(dtype, k, d)
            bwd_v = fwa.backward_variant(dtype, k, d)
            before = dict(fwa.flash_window_attention.width_launches)
            before_b = dict(fwa.flash_window_attention_bwd.width_launches)
            out, lse = fwa._forward(x, valid, k, h, d ** -0.5, True)[:2]
            out_g, g = grads_of(fwa.flash_window_attention, x, valid, k, h, dout)
            torch.cuda.synchronize()
            key = (fwd_v, name, dp)
            check(fwa.flash_window_attention.width_launches.get(key, 0)
                  == before.get(key, 0) + 2, f"K1 not on {key} at {shape}")
            key_b = (bwd_v, name, dp)
            check(fwa.flash_window_attention_bwd.width_launches.get(key_b, 0)
                  == before_b.get(key_b, 0) + 1, f"K2 not on {key_b} at {shape}")
            check(torch.isfinite(out).all().item() and torch.isfinite(g).all().item(),
                  f"non-finite output or gradient at {shape}")
            check(torch.equal(out, out_g), f"output differs with and without the graph at "
                  f"{shape}")
            check((out[dead] == 0).all().item() and (g[dead] == 0).all().item(),
                  f"windows of padding not zero at {shape}")
            lse_err = (lse - plain_lse(x, valid, k, h))[~dead].abs().max().item()
            check(lse_err <= LSE_ATOL, f"log-sum-exp error {lse_err} at {shape}")
            row = dict(dtype=name, D=d, padded_D=dp, K=k, C=c, H=h, N=n, fwd_variant=fwd_v,
                       bwd_variant=bwd_v, lse_max_abs_err=lse_err)
            if dtype == torch.float32:
                ref_out, ref = grads_of(fwa.flash_window_attention_plain, x, valid, k, h, dout)
                err = (out - ref_out)[valid].abs().max().item()
                errs = [(g[:, :, i] - ref[:, :, i]).abs().max().item() for i in range(3)]
                mags = [ref[:, :, i].abs().max().item() for i in range(3)]
                check(err <= FP32_ATOL, f"fp32 error {err} at {shape}")
                for part, e, m in zip(("dq", "dk", "dv"), errs, mags):
                    check(e <= BWD_FP32_RTOL * m, f"fp32 {part} error {e} > {BWD_FP32_RTOL} x "
                          f"{m} at {shape}")
                worst32 = max(worst32, err, *errs)
                row.update(fp32_max_abs_err=err, fp32_max_abs_err_dq_dk_dv=errs,
                           fp32_max_abs_grad=mags)
            else:
                t_out, truth = grads_of(fwa.flash_window_attention_plain, x.float(), valid, k,
                                        h, dout.float())
                p_out, p_g = grads_of(fwa.flash_window_attention_plain, x, valid, k, h, dout)

                def rel(a, b, m=valid):
                    return ((a[m].float() - b[m]).norm() / b[m].norm()).item()

                errs = dict(output=(rel(out, t_out), rel(p_out, t_out)),
                            gradient=(rel(g, truth), rel(p_g, truth)))
                for what, (err, floor) in errs.items():
                    check(floor > LOW_PRECISION_FLOOR[dtype],
                          f"{name} path not exercised ({what}) at {shape}")
                    check(err <= BF16_NOISE_FACTOR * floor,
                          f"{name} {what} error {err} > {BF16_NOISE_FACTOR} x {floor} at {shape}")
                row.update(rel_err=errs["output"][0], plain_rel_err=errs["output"][1],
                           grad_rel_err=errs["gradient"][0],
                           grad_plain_rel_err=errs["gradient"][1])
            if dp != d and k == 1024:  # the wrapper's copy into [B, N, 3, H, Dp] and back
                row["pad_ms"] = cuda_ms(lambda: fwa.unpad_heads(fwa.pad_heads(x, h, dp), h, d),
                                        reps=10)
                row["fwd_ms"] = cuda_ms(lambda: fwa.flash_window_attention(x, valid, k, h),
                                        reps=10)
            if (d, k) in [(WIDTH_TIMED[0], kt) for kt in WIDTH_TIMED[1]]:
                row["times"] = time_width_case(x, valid, dout, k, h)
            rows.append(row)
            del qkv, x, dout, g
    check({r["fwd_variant"] for r in rows} == set(fwa.VARIANTS)
          and {r["bwd_variant"] for r in rows} == set(fwa.BWD_VARIANTS),
          "the width cases do not reach every variant")
    counts = width_counts()
    emit(dict(phase="kernel_widths", fp32_atol=FP32_ATOL, fp32_rtol=BWD_FP32_RTOL,
              noise_factor=BF16_NOISE_FACTOR, lse_atol=LSE_ATOL, counts=counts,
              cases=rows))
    timed = {f"{r['dtype']}/K{r['K']}": dict(
        D=r["D"], N=r["N"], C=r["C"], H=r["H"], fwd_variant=r["fwd_variant"],
        bwd_variant=r["bwd_variant"], **r["times"]) for r in rows if "times" in r}
    pads = {f"{r['dtype']}/D{r['D']}": dict(pad_ms=r["pad_ms"], fwd_ms=r["fwd_ms"])
            for r in rows if "pad_ms" in r}
    return worst32, dict(counts=counts, timed=timed, pads=pads)


def shell_normals(grid, extent, thickness):
    """Unit normals of the voxels of a room's shell (room_scene's floor and
    walls, ``extent`` voxels a side): up on the floor, into the room on the
    walls."""
    normal = np.zeros((len(grid), 3), np.float32)
    for axis, sign, on in ((0, 1, grid[:, 0] < thickness),
                           (0, -1, grid[:, 0] >= extent[0] - thickness),
                           (1, 1, grid[:, 1] < thickness),
                           (1, -1, grid[:, 1] >= extent[1] - thickness),
                           (2, 1, grid[:, 2] < thickness)):
        normal[on] = 0
        normal[on, axis] = sign
    return normal


def write_gs_scenes(root, n_scenes, n, seed, size_m=(3.6, 3.6, 2.6), pc_points=0,
                    semseg=False, ppt=False):
    """``n_scenes`` synthetic 3DGS scenes of ``n`` unique 2 cm voxels on the
    4 cm thick floor and walls of a room of ``size_m`` metres (81% of its
    247,072 surface voxels at the default size), in the GS datasets'
    layout (root/scene/<asset>.npy): colour, opacity, quaternion, scale, 20
    classes by angle around the room's centre and height, 768-d fp16
    lang_feat (the class's unit embedding plus noise) and valid_feat_mask;
    with ``semseg`` the semseg files' assets instead of the last two:
    normals and the labels as ``segment20``. Dense shells keep the pooled
    stages inside their capacities after Mix3D merges two rooms and halves
    each one's density. With ``pc_points`` a scene also gets an evaluation
    point cloud (that many of its points, moved by a few millimetres, with
    their labels). With ``ppt`` (and ``semseg``) a scene also holds 100
    ScanNet++ classes as ``segment`` (ppt_labels), so that the ScanNet and
    the ScanNet++ dataset read one scene as two conditions."""
    rng = np.random.default_rng(seed)
    if not semseg:
        emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        noise = (0.05 * rng.standard_normal((n, LANG_DIM), dtype=np.float32))
    dirs = []
    for i in range(n_scenes):
        coord, _, grid = room_scene(rng, n, size_m, thickness=2)
        angle = np.arctan2(coord[:, 1] - size_m[1] / 2, coord[:, 0] - size_m[0] / 2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = (seg + 10 * (coord[:, 2] > 1.0)).astype(np.int16)
        scene = os.path.join(root, f"scene{i:04d}")
        os.makedirs(scene)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32))
        if semseg:
            extent = [int(round(m / GRID)) for m in size_m]
            assets.update(segment20=seg, normal=shell_normals(grid, extent, 2))
            if ppt:
                assets["segment"] = ppt_labels(seg, coord)
        else:
            assets.update(
                segment=seg, segment200=seg,
                lang_feat=(emb[seg] + np.roll(noise, i, axis=0)).astype(np.float16),
                valid_feat_mask=rng.random(n) > 0.1)
        if pc_points:
            pick = rng.choice(n, pc_points, replace=False)
            assets["pc_coord"] = (coord[pick] + rng.normal(0, 0.003, (pc_points, 3))
                                  ).astype(np.float32)
            assets["pc_segment"] = assets["pc_segment200"] = seg[pick].astype(np.int32)
        for key, value in assets.items():
            np.save(os.path.join(scene, f"{key}.npy"), value)
        dirs.append(scene)
    return dirs


def write_meta(meta_root):
    """The label files and torch ``.pt`` text tables the flagship config's
    evaluator hook and the test config name under SCENESPLAT_META_ROOT, cut
    from the port's built-in ScanNet200 table (its first 100 and 160 rows
    stand in for the ScanNet++ and Matterport tables)."""
    os.makedirs(meta_root)
    names = metadata.class_labels("scannet200")
    table = torch.from_numpy(metadata.text_embeddings("scannet200"))
    for labels, emb, rows in (
            ("scannetpp_top100_labels.txt", "scannetpp_top100_text_embeddings_siglip2.pt", 100),
            ("scannet200_labels.txt", "scannet200_text_embeddings_siglip2.pt", 200),
            ("matterport_nyu160_labels.txt", "matterport-nyu160_text_embeddings_siglip2.pt",
             160)):
        with open(os.path.join(meta_root, labels), "w") as f:
            f.write("\n".join(names[:rows]) + "\n")
        torch.save(table[:rows].clone(), os.path.join(meta_root, emb))


class StepProbe(HookBase):
    """CUDA-event time of every step, and a torch.profiler trace of step
    ``profile_step``."""

    def __init__(self, profile_step):
        self.profile_step = profile_step
        self.events, self.prof, self.profile = [], None, None

    def before_step(self):
        if self.trainer.storage.iter == self.profile_step:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.events.append([start, None])

    def after_step(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events[-1][1] = end
        if self.prof is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            kernels = device_kernels(self.prof)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            # DDP's gradient all-reduce (NCCL's kernels, on a stream of their own)
            nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower())
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
            self.profile = dict(step=self.profile_step, wall_ms=wall_ms, device_busy_ms=busy,
                                idle_share=1 - busy / wall_ms, nccl_ms=nccl / 1e3,
                                top_kernels=[dict(name=e.key[:90], calls=e.count,
                                                  ms=e.self_device_time_total / 1e3)
                                             for e in top])
            self.prof = None

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def flagship_train_config(root, exp, batch_size):
    """The flagship config file as it is, its hooks included (the label and
    text-table files come from SCENESPLAT_META_ROOT), with the data roots,
    epoch 1 (so the contrastive term's last_75 gate is open) and the batch
    size set."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    for ds in list(cfg.data.train.datasets) + list(cfg.data.val):
        ds["data_root"] = root[ds["type"]]
    return cfg


def run_training(cfg, before=None):
    """Trains the config's epoch (``before(trainer)`` called first); returns
    the trainer, its probe, the per-step records of the training forward
    (pooling overflow, stage sizes and valid counts) and, read from K1's
    counter around every forward, the forwards and K1 launches of the train
    steps and of the hooks' validation and testing, with the largest
    pooling overflow of each of those forwards."""
    trainer = build_trainer(cfg, device="cuda")
    if before is not None:
        before(trainer)
    steps = len(trainer.train_loader)
    probe = StepProbe(profile_step=steps - 1)
    probe.trainer = trainer
    trainer.hooks.append(probe)
    records = []
    k1 = dict(train_forwards=0, train_launches=0, val_forwards=0, val_launches=0,
              train_variants=dict.fromkeys(fwa.VARIANTS, 0),
              val_variants=dict.fromkeys(fwa.VARIANTS, 0), val_overflow=[])
    forward = trainer.model.forward

    def recording_forward(point, generator=None, **kwargs):  # PPT: condition=
        before, variants = fwa.flash_window_attention.launches, k1_variants()
        result = forward(point, generator=generator, **kwargs)
        out = points_of(result)
        mode = "train" if trainer.model.training else "val"
        k1[mode + "_forwards"] += 1
        k1[mode + "_launches"] += fwa.flash_window_attention.launches - before
        for v, n in k1_variants().items():
            k1[mode + "_variants"][v] += n - variants[v]
        if out is None:  # MSC's and CAC's loss terms, no points
            return result
        if mode == "val":
            k1["val_overflow"].append(max((int(p.n_overflow.max()) for p in out.plans),
                                          default=0))
            return result
        records.append(dict(
            condition=kwargs.get("condition"), overflow=[p.n_overflow for p in out.plans],
            sizes=[(point.mask.shape[1], point.mask.sum(1))]
            + [(p.out_mask.shape[1], p.out_mask.sum(1)) for p in out.plans]))
        return result

    trainer.model.forward = recording_forward
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    return trainer, probe, records, k1


# the flagship trainer phases' rooms: Mix3D puts about 98,000 points of
# each of two rooms in a row of 196,608, whose first pooling holds 98,304
# clusters (4 cm cells), so a room's shell must span fewer than about
# 49,000 cells after the file's rotation, scaling and distortion. Over 2
# rooms of 2.4 x 2.4 x 2.6 m (130,000 of their 149,632 surface voxels)
# tools/flagship_pooling_replay.py, the seeded loader replayed on the CPU,
# finds at most 73,706 first-pooling clusters at seeds 0 to 7 (16,851 of
# 49,152 and 3,826 of 24,576 at the next two poolings); 3.6 m rooms of
# 200,000 reached 103,709 (98,494 at the file's seed 0)
FLAGSHIP_SCENE_POINTS, FLAGSHIP_ROOM_M = 130000, (2.4, 2.4, 2.6)


def write_flagship_data(tmp, scene_points=FLAGSHIP_SCENE_POINTS, room=FLAGSHIP_ROOM_M,
                        val_points=40000, copies=1, rooms=2):
    """The flagship file's three training sets over ``rooms`` synthetic
    rooms (each listed ``copies`` times) and one small validation scene
    each, under ``tmp``; returns the data roots by dataset type and the
    seconds the writing took."""
    t0 = time.perf_counter()
    scenes = write_gs_scenes(os.path.join(tmp, "scenes"), rooms, scene_points, seed=4,
                             size_m=room)
    (val_scene,) = write_gs_scenes(os.path.join(tmp, "val_scenes"), 1, val_points, seed=9,
                                   size_m=(2.4, 2.4, 2.0), pc_points=val_points // 4)
    # Matterport (loop 3): every room; ScanNet++ (loop 2): every room;
    # ScanNet200 (loop 2): 2 rooms. Each dataset fills its own batches of 4
    # Mix3D samples: at 2 rooms 1 + 1 + 1 batches, at 4 rooms 3 + 2 + 1.
    # One validation scene per dataset.
    root, splits = {}, {"Matterport3D_160_GSDataset": (
        "train_grid1.0cm_chunk6x6_stride3x3_filtered", rooms,
        "test_grid1.0cm_chunk6x6_stride3x3_filtered"),
        "ScanNetPPGSDataset": ("train_grid1.0cm_chunk6x6_stride3x3", rooms, "val"),
        "ScanNet200GSDataset": ("train_grid1.0cm_chunk6x6_stride3x3", 2, "val")}
    for name, (split, count, val_split) in splits.items():
        root[name] = os.path.join(tmp, name)
        os.makedirs(os.path.join(root[name], split))
        for copy in range(copies):
            for scene in scenes[:count]:
                os.symlink(scene, os.path.join(root[name], split,
                                               f"{os.path.basename(scene)}_{copy}"))
        os.makedirs(os.path.join(root[name], val_split))
        os.symlink(val_scene, os.path.join(root[name], val_split, "scene_val"))
    return root, time.perf_counter() - t0


def reset_k2_counts():
    fwa.flash_window_attention_bwd.reset()


def check_flagship_run(phase, trainer, probe, records, k1_counts):
    """What the flagship trainer phases hold of run_training's run (the
    counts reset just before it): at least 1 + 2 finite steps, K1 with lse
    and K2 once a block in every step's forward and backward, K1 without
    lse once a block in one validation forward per set (the encoder's on
    bf16_large, the decoder's windows of 48 on bf16_small), no pooling
    overflow, the file's own hooks' work done (each set's fg_mIoU logged
    once, model_last.pth and model_best.pth written, PreciseEvaluator with
    no tester). Returns the run's record."""
    backbone = trainer.cfg.model.backbone
    enc, dec = depth_split(backbone)
    blocks = enc + dec  # 18
    # K1 with lse: the launches counted inside the train steps' forwards;
    # the evaluator hook's validation forwards launch K1 without lse
    k1, k1_val = k1_counts["train_launches"], k1_counts["val_launches"]
    val_forwards = k1_counts["val_forwards"]
    k2 = fwa.flash_window_attention_bwd.launches
    k2_variants = dict(fwa.flash_window_attention_bwd.variant_launches)
    step_ms = probe.step_ms()
    hist = trainer.storage.history
    losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
    steps = len(losses)
    check(steps >= 3, f"{phase}: {steps} train steps, expected at least 1 + 2")
    check(all(math.isfinite(v) for v in losses + grad_norms),
          f"{phase}: non-finite loss or grad_norm: {losses} {grad_norms}")
    check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
          and k2 == blocks * steps,
          f"{phase}: {k1} forward and {k2} backward kernel launches in {steps} steps "
          f"({k1_counts['train_forwards']} forwards), expected {blocks} each per step")
    check(val_forwards == len(trainer.cfg.data.val) and k1_val == blocks * val_forwards,
          f"{phase}: {k1_val} kernel launches in {val_forwards} validation forwards, "
          f"expected {blocks} each, one forward per validation set")
    # bf16: the encoder's windows of 1024 take the large-window backward,
    # the decoder's windows of 48 the one-pass one
    check(k2_variants["bf16_small"] > 0 and k2_variants["bf16_large"] > 0
          and k2_variants["bf16_small"] + k2_variants["bf16_large"] == k2,
          f"{phase}: backward variant launches {k2_variants} of {k2}")
    check(fwa.flash_window_attention.launches == k1 + k1_val,
          f"{phase}: K1 launched {fwa.flash_window_attention.launches} times, {k1} + "
          f"{k1_val} of them inside a forward")
    # K1 in bf16: the encoder's windows of 1024 on the large-window
    # forward, the decoder's windows of 48 on the one-pass one
    for mode, forwards in (("train", steps), ("val", val_forwards)):
        got = {v: n for v, n in k1_counts[mode + "_variants"].items() if n}
        check(got == dict(bf16_large=enc * forwards, bf16_small=dec * forwards),
              f"{phase}: {mode} K1 variant launches {got} in {forwards} forwards, expected "
              f"{enc} bf16_large and {dec} bf16_small each")
    overflow = [int(max(int(o.max()) for o in r["overflow"])) for r in records]
    check(all(o == 0 for o in overflow), f"{phase}: pooling overflow {overflow}")
    model_dir = os.path.join(trainer.cfg.save_path, "model")
    check(os.path.exists(os.path.join(model_dir, "model_last.pth")),
          f"{phase}: no checkpoint written")
    # the file's own hooks: the evaluator logged each validation set's
    # fg_mIoU, the saver kept the best epoch, PreciseEvaluator had no tester
    val = {f"val{i}/{m}": hist(f"val{i}/{m}").values()
           for i in range(len(trainer.cfg.data.val)) for m in ("mIoU", "fg_mIoU")}
    check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in val.values()),
          f"{phase}: validation metrics not logged once per set: {val}")
    check(trainer.comm_info.get("current_metric_name") == "fg_mIoU",
          f"{phase}: the evaluator hook set no checkpoint metric")
    check(os.path.exists(os.path.join(model_dir, "model_best.pth")),
          f"{phase}: no model_best.pth")
    precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
    check(len(precise) == 1 and precise[0].results == [],
          f"{phase}: PreciseEvaluator ran a tester the config does not name")
    sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
    return dict(points=TRAIN_POINTS, steps=steps, loss=losses, grad_norm=grad_norms,
                lr=hist("lr").values(), cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                k1_launches=k1, k2_launches=k2, k2_variant_launches=k2_variants,
                k1_variant_launches=k1_counts["train_variants"],
                validation_forwards=val_forwards, validation_k1_launches=k1_val,
                validation_k1_variant_launches=k1_counts["val_variants"],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                n_overflow=overflow, stage_slots_valid=sizes[-1],
                validation={k: v[0] for k, v in val.items()},
                best_metric=trainer.comm_info.get("best_metric_value"),
                profile=probe.profile)


def phase_train(work, data):
    """The flagship trainer, its own hooks included, for 1 + 2 steps and one
    validation over ``data`` (write_flagship_data's roots and seconds);
    returns the train-step stage shapes, the K1 / K2 launch counts, the
    best checkpoint, copied into ``work``, and the run's record."""
    root, data_s = data
    with tempfile.TemporaryDirectory() as tmp:
        reset_k1_counts()
        reset_k2_counts()
        batch, oom, result = 2, None, None
        try:
            result = run_training(flagship_train_config(root, os.path.join(tmp, "exp"), batch))
        except torch.cuda.OutOfMemoryError as e:
            oom = dict(batch_size=batch, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       error=str(e)[:600])
        if result is None:  # the reference's 2 per card did not fit: 1 per card
            gc.collect()
            torch.cuda.empty_cache()
            batch = 1
            reset_k1_counts()
            reset_k2_counts()
            result = run_training(flagship_train_config(root, os.path.join(tmp, "exp1"), batch))
        trainer, probe, records, k1_counts = result
        backbone = trainer.cfg.model.backbone
        record = check_flagship_run("train", trainer, probe, records, k1_counts)
        checkpoint = shutil.copy(os.path.join(trainer.cfg.save_path, "model", "model_best.pth"),
                                 os.path.join(work, "model_best.pth"))
        emit(dict(phase="train", batch_size=batch, oom=oom, dataset_write_s=data_s, **record))
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    k1_vars = dict(train=k1_counts["train_variants"], validation=k1_counts["val_variants"])
    return (shapes, record["k1_launches"], record["validation_k1_launches"], k1_vars,
            record["k2_variant_launches"], checkpoint, record)


def bwd_bound_ms(n, valids, k, c, h):
    """Least time of one bf16 backward call, as (ops_ms, bytes_ms,
    design_bytes_ms): 10 v^2 C operations per window of v valid slots (the
    five products, the recompute of S included) at the bf16 peak; the bytes
    of the function K2 replaces (qkv and dO of live windows and the mask
    read once, dqkv written once) at the memory rate; and those bytes plus
    what this design's backward also reads of live windows: lse, and O at
    windows above the one-pass variant's (delta from dO and O)."""
    ops, rows_live = 0, 0
    for nv in valids:
        for w0 in range(0, n, k):
            v = max(0, min(nv, w0 + k) - w0)
            ops += 10 * v * v * c
            rows_live += min(k, n - w0) if v else 0
    nbytes = rows_live * (2 * 3 * c + 2 * c) + len(valids) * n * (2 * 3 * c + 1)
    design = nbytes + rows_live * ((2 * c if k > fwa.BWD_SMALL_MAX else 0) + 4 * h)
    return (ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3,
            design / PEAK_BYTES * 1e3)


def fwd_lse_bound_ms(n, valids, k, c, h):
    """Least time of one bf16 forward with log-sum-exp, as (ops_ms,
    bytes_ms): ``bound_ms`` of each batch row, plus the fp32 lse written."""
    ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
    return ops_ms, bytes_ms + len(valids) * n * 4 * h / PEAK_BYTES * 1e3


def backward_ms(make_out, x_list, dout, reps, warmup=1):
    """Device time of the backward alone: a fresh forward per rep outside the
    timed span, CUDA events around torch.autograd.grad, after ``warmup``
    untimed reps. Returns the time and the last rep's gradients."""
    total = 0.0
    for i in range(reps + warmup):
        out = make_out()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grads = torch.autograd.grad(out, x_list, dout)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
        del out
    return total / reps, grads


def phase_timing_bwd(shapes, phase="timing_bwd"):
    """At the train step's shapes, (N, valid counts, K, C, H, forward
    launches a step[, backward launches a step]): the forward with
    log-sum-exp and the backward kernel against the plain version under the
    bf16 noise-floor rule (gradients against autograd through the plain
    version run in fp32), with zero output and gradients in windows whose
    slot 0 is padding; then each kernel's time per call and per step against
    the plain version, the library call and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               design_bytes_ms=0.0, fwd_lse_ms=0.0, fwd_plain_ms=0.0,
               fwd_library_ms=0.0, fwd_ops_ms=0.0, fwd_bytes_ms=0.0)
    fwd_keys = ("fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_ops_ms", "fwd_bytes_ms")
    by_variant = {}  # the forward's per-step sums for each of its variants
    # what the autograd Function keeps beyond the JAX package's residuals
    # (qkv, valid): the bf16 output and the fp32 log-sum-exp of every call
    shapes = [tuple(sh) + (sh[5],) * (7 - len(sh)) for sh in shapes]
    saved_gib = sum(count * len(valids) * n * (2 * c + 4 * h)
                    for n, valids, k, c, h, count, _ in shapes) / 2 ** 30
    for n, valids, k, c, h, count, bwd_count in shapes:
        b, d, scale = len(valids), c // h, (c // h) ** -0.5
        shape = ("N, valid, K, C, H", n, valids, k, c, h)
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        dead = torch.zeros_like(valid)
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
            dead[i, -(-nv // k) * k:] = True
        out, lse = fwa._forward(qkv, valid, k, h, scale, True)[:2]
        dqkv = fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h, scale)
        torch.cuda.synchronize()
        check(torch.isfinite(dqkv).all().item(), f"non-finite gradient at {shape}")
        check((out[dead] == 0).all().item() and (dqkv[dead] == 0).all().item(),
              f"padded windows' output or gradients not zero at {shape}")
        fwd_err, fwd_floor = check_bf16(qkv, valid, k, h, out=out)

        fwd_ms = cuda_ms(lambda: fwa._forward(qkv, valid, k, h, scale, True), reps=10)
        # the plain version once each way after a warm-up (PLAIN_REPS)
        fwd_plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                               **PLAIN_REPS)
        ms = cuda_ms(lambda: fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h,
                                                            scale), reps=10)
        x = qkv.detach().clone().requires_grad_(True)
        plain_ms, (g_plain,) = backward_ms(
            lambda: fwa.flash_window_attention_plain(x, valid, k, h), [x], dout, **PLAIN_REPS)
        chunk = max(8, 16384 // k)  # windows per plain chunk: the result is the same
        _, truth = grads_of(
            lambda t, m, kk, hh: fwa.flash_window_attention_plain(t, m, kk, hh,
                                                                  patch_chunk=chunk),
            qkv.float(), valid, k, h, dout.float())

        def rel(g):
            return ((g.float() - truth).norm() / truth.norm()).item()

        err16, floor16 = rel(dqkv), rel(g_plain)
        check_noise_floor(err16, floor16, "gradient", shape)
        del truth, g_plain, x

        p = -(-n // k)
        pad = p * k - n
        qkv_w = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], 1) if pad else qkv
        valid_w = torch.cat([valid, valid.new_zeros(b, pad)], 1) if pad else valid
        q, kk, v = [t.detach().requires_grad_(True) for t in
                    qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()]
        mask = valid_w.view(b * p, 1, 1, k)
        dout_w = (torch.cat([dout, dout.new_zeros(b, pad, c)], 1) if pad else dout)
        dout_w = dout_w.view(b * p, k, h, d).transpose(1, 2).contiguous()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=mask)

        with torch.no_grad():
            fwd_lib_ms = cuda_ms(library, reps=10)
        lib_ms, _ = backward_ms(library, [q, kk, v], dout_w, reps=5)
        ops_ms, bytes_ms, design_bytes_ms = bwd_bound_ms(n, valids, k, c, h)
        fwd_ops_ms, fwd_bytes_ms = fwd_lse_bound_ms(n, valids, k, c, h)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms, design_bytes_ms=design_bytes_ms, fwd_lse_ms=fwd_ms,
                   fwd_plain_ms=fwd_plain_ms, fwd_library_ms=fwd_lib_ms,
                   fwd_ops_ms=fwd_ops_ms, fwd_bytes_ms=fwd_bytes_ms)
        fwd_variant = fwa.forward_variant(qkv.dtype, k, d)
        rows.append(dict(N=n, B=b, valid=valids, K=k, C=c, H=h, launches=count,
                         bwd_launches=bwd_count,
                         variant=fwa.backward_variant(qkv.dtype, k, d),
                         fwd_variant=fwd_variant, **row,
                         bound_ms=max(ops_ms, bytes_ms),
                         fwd_bound_ms=max(fwd_ops_ms, fwd_bytes_ms),
                         bf16_grad_rel_err=err16, bf16_grad_plain_rel_err=floor16,
                         bf16_fwd_lse_rel_err=fwd_err, bf16_fwd_plain_rel_err=fwd_floor))
        for key, val in row.items():
            tot[key] += (count if key.startswith("fwd_") else bwd_count) * val
        part = by_variant.setdefault(fwd_variant, dict.fromkeys(fwd_keys, 0.0))
        for key in fwd_keys:
            part[key] += count * row[key]
        del qkv, dout, out, lse, dqkv, q, kk, v, qkv_w, dout_w
        torch.cuda.empty_cache()
    for pre in ("", "fwd_"):
        ops_ms, bytes_ms = tot[pre + "ops_ms"], tot[pre + "bytes_ms"]
        tot[pre + "bound_ms"] = max(ops_ms, bytes_ms)
        tot[pre + "bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    tot["design_bound_ms"] = max(tot["ops_ms"], tot["design_bytes_ms"])
    for part in by_variant.values():
        part["fwd_bound_ms"] = max(part["fwd_ops_ms"], part["fwd_bytes_ms"])
        part["fwd_bound_by"] = ("operations" if part["fwd_ops_ms"] >= part["fwd_bytes_ms"]
                                else "bytes")
    tot["fwd_by_variant"] = by_variant
    emit(dict(phase=phase, dtype="bfloat16", bf16_noise_factor=BF16_NOISE_FACTOR,
              per_call=rows, per_step=tot, saved_out_lse_gib=saved_gib,
              worst_bf16_grad_ratio=max(r["bf16_grad_rel_err"] / r["bf16_grad_plain_rel_err"]
                                        for r in rows),
              worst_bf16_fwd_lse_ratio=max(r["bf16_fwd_lse_rel_err"]
                                           / r["bf16_fwd_plain_rel_err"] for r in rows)))
    return tot


def compare_train_steps(phase, step, blocks, **record):
    """``step(use_kernel)`` -> (loss, or the loss terms with the composed
    one under "loss", gradients by name, pooling overflow of each stage)
    runs one train step from fixed weights and generator seeds; it runs
    with the kernels (``blocks`` K1 and K2 launches, or a pair of counts
    (K1, K2)) and with the plain attention (none); compare_steps holds the
    two. Emits ``phase`` with ``record``."""
    before = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    kernel = step(None)
    after = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    k1, k2 = blocks if isinstance(blocks, tuple) else (blocks, blocks)
    check(after == (before[0] + k1, before[1] + k2),
          f"{phase}: kernel path not taken: {before} {after}, expected {k1} and {k2} more")
    plain = step(False)
    check((fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
          == after, f"{phase}: plain path launched a kernel")
    compare_steps(phase, kernel, plain, **record)


def grad_floor(ref, others):
    """The fp32 noise floor of a step: the largest relative L2 of each
    gradient over the step results ``others`` (the same step on the batch's
    points in other orders within each row: the same function, summed in
    other orders) against ``ref``, and the whole gradient's."""
    ga = {k: g.cpu() for k, g in ref[1].items()}
    per, whole = dict.fromkeys(ga, 0.0), 0.0
    for other in others:
        gb = {k: g.cpu() for k, g in other[1].items()}
        for k, g in ga.items():
            per[k] = max(per[k], rel_l2(gb[k], g))
        num = sum(float(((gb[k] - g) ** 2).sum()) for k, g in ga.items())
        whole = max(whole, math.sqrt(num / sum(float((g ** 2).sum()) for g in ga.values())))
    return per, whole


def permuted_rows(rows, seed):
    """``rows`` (numpy [rows, n, ...]) with each row's points in a random
    order."""
    rng = np.random.default_rng(seed)
    b, n = rows["mask"].shape
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    return {k: np.take_along_axis(v, perm.reshape(perm.shape + (1,) * (v.ndim - 2)), 1)
            for k, v in rows.items()}


def compare_steps(phase, got, ref, names=("kernel", "plain"), floor=None, zero=ZERO_GRAD,
                  **record):
    """Holds one train step's (loss or loss terms, gradients by name, pooling
    overflow) ``got`` to ``ref``: the losses to TRAIN_LOSS_RTOL (each
    term's difference is recorded) and each gradient to TRAIN_GRAD_RTOL of
    its own norm (or both zero, see ZERO_GRAD), the whole gradient too; no
    stage may overflow. With ``floor`` (grad_floor's), a gradient may also
    differ by NOISE_FLOOR_FACTOR times the larger of its own floor and the
    whole gradient's, the whole gradient by that factor times its floor.
    Gradients named ``<term>/<parameter>`` are one loss term's: each term
    is its own whole gradient. ``zero`` is the share of the whole gradient
    under which a tensor counts as zero in exact arithmetic. Emits
    ``phase`` with ``record``, the two losses under loss_<names>."""
    loss_k, grads_k, overflow_k = got
    loss_p, grads_p, overflow_p = ref
    term = {name: name.split("/")[0] if "/" in name else "" for name in grads_p}
    total = {t: torch.linalg.vector_norm(torch.stack(
        [g.norm() for name, g in grads_p.items() if term[name] == t])).item()
        for t in set(term.values())}
    worst, zeros, by_share, diff_sq = 0.0, [], {}, dict.fromkeys(total, 0.0)
    check(sorted(grads_k) == sorted(grads_p), f"{phase}: gradients of other parameters")
    for name, gp in grads_p.items():
        gk, whole = grads_k[name], total[term[name]]
        check(torch.isfinite(gk).all().item(), f"{phase}: non-finite gradient {name}")
        norm, diff = gp.norm().item(), (gk - gp).norm().item()
        diff_sq[term[name]] += diff ** 2
        # per decade of the tensor's share of its whole gradient's norm: how
        # many tensors, and their worst error relative to their own norm
        decade = f"1e{math.floor(math.log10(norm / whole))}" if norm else "0"
        count, own = by_share.get(decade, (0, 0.0))
        by_share[decade] = (count + 1, max(own, diff / norm if norm else diff))
        if norm < zero * whole:
            zeros.append(name)
            check(gk.norm().item() < zero * whole,
                  f"{phase}: gradient of {name} is zero on the {names[1]} path only")
            continue
        worst = max(worst, diff / norm)
        bound = TRAIN_GRAD_RTOL if floor is None else max(
            TRAIN_GRAD_RTOL, NOISE_FLOOR_FACTOR * max(floor[0][name], floor[1]))
        check(diff / norm <= bound,
              f"{phase}: gradient of {name} differs by {diff / norm} (relative L2; bound "
              f"{bound})")
    losses_k, losses_p = (loss_k, loss_p) if isinstance(loss_p, dict) else (
        dict(loss=loss_k), dict(loss=loss_p))
    loss_rel = {k: abs(losses_k[k] - v) / abs(v) for k, v in losses_p.items()}
    whole_rel = {t: math.sqrt(diff_sq[t]) / total[t] for t in total}
    emit(dict(phase=phase, dtype="float32", **record, n_overflow=[overflow_k, overflow_p],
              **{f"loss_{names[0]}": loss_k, f"loss_{names[1]}": loss_p},
              loss_rel_diff=loss_rel["loss"], term_rel_diff=loss_rel,
              loss_rtol=TRAIN_LOSS_RTOL, grad_tensors=len(grads_p), worst_grad_rel_l2=worst,
              grad_rtol=TRAIN_GRAD_RTOL, zero_grad_tensors=zeros, zero_grad_share=zero,
              **({} if floor is None else dict(
                  noise_floor_whole=floor[1], noise_floor_factor=NOISE_FLOOR_FACTOR,
                  noise_floor_worst=max(floor[0][k] for k in grads_p if k not in zeros))),
              global_grad_norm=total[""] if "" in total else total,
              global_grad_rel_l2=whole_rel[""] if "" in whole_rel else whole_rel,
              worst_own_rel_l2_by_share=dict(sorted(by_share.items()))))
    check(loss_rel["loss"] <= TRAIN_LOSS_RTOL,
          f"{phase}: losses differ by {loss_rel['loss']} relative")
    whole_bound = TRAIN_GRAD_RTOL if floor is None else max(TRAIN_GRAD_RTOL,
                                                            NOISE_FLOOR_FACTOR * floor[1])
    check(max(whole_rel.values()) <= whole_bound,
          f"{phase}: the whole gradient differs by {whole_rel} (bound {whole_bound})")
    check(not any(overflow_k + overflow_p), f"{phase}: pooling overflow {overflow_k}")


# the flagship file's fp32 agree steps (train_agree, ddp_train_agree,
# ddp_agree and the tp and cp grids against its reference, remat_agree):
# 24,576 points a row in a 1.7 m room, whose 4 cm cells fill the first
# pooling as a 2.4 m room's 49,152 points did (all but remat_agree took
# 49,152 before)
AGREE_ROOM_M = 1.7


def agree_rows(n, seeds, size_m=2.4):
    """One batch row of ``n`` points per seed: a cube room of ``size_m``
    small enough that its 4 cm cells fit the first pooling's capacity (a 3
    m room's 24,891 would overflow 0.5 x 49,152; at 24,576 points a 1.7 m
    room), 20 classes by angle and height, 768-d fp16 lang_feat (a unit
    embedding per class plus noise) and valid_feat_mask; numpy arrays
    [rows, n, ...]."""
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coord, feat_in, grid = room_scene(rng, n, (size_m,) * 3)
        angle = np.arctan2(coord[:, 1] - size_m / 2, coord[:, 0] - size_m / 2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = seg + 10 * (coord[:, 2] > 1.0)
        emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)  # SigLIP2 features are unit rows
        lang = emb[seg] + 0.05 * rng.normal(size=(n, LANG_DIM)).astype(np.float32)
        rows.append(dict(coord=coord, feat=feat_in, grid_coord=grid, mask=np.ones(n, bool),
                         segment=seg, lang_feat=lang.astype(np.float16),
                         valid_feat_mask=rng.random(n) > 0.1))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def cuda_batch(rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in rows.items()}


def flagship_fp32_model(**backbone):
    """The flagship config file's LangPretrainer in fp32 from seed 1, on the
    card in train mode, and the file's criteria."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    model = build_model(dict(type="LangPretrainer", backbone=dict(
        cfg.model.backbone, dtype="float32", seed=1, **backbone)))
    return model.cuda().train(), build_criteria(cfg.model.criteria)


def phase_train_agree(n=24576):
    """One fp32 train step of the flagship config file's model (decoder
    windows of 48, ragged) at ``n`` points with the kernels and one with the
    plain attention, from the same weights and generator seeds."""
    backbone = dict(Config.fromfile(FLAGSHIP_CONFIG).model.backbone)
    batch = cuda_batch(agree_rows(n, (7,), size_m=AGREE_ROOM_M))

    def step(use_kernel):
        model, criteria = flagship_fp32_model(use_kernel=use_kernel)
        gen = torch.Generator(device="cuda").manual_seed(11)
        loss, out = lang_loss(model, criteria, batch, gen, epoch_progress=1.0)
        loss.backward()
        return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                [int(p.n_overflow.max()) for p in out.plans])

    compare_train_steps("train_agree", step, sum(depth_split(backbone)), points=n,
                        dec_patch_size=backbone.get("dec_patch_size", "default (48)"))


# ---- data parallel ---------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank, world, port, local_rank=0):
    """The environment torchrun gives a process, for the block (the ranks
    that share the one card all have LOCAL_RANK 0)."""
    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.update(env)
    try:
        yield
    finally:
        for key in env:
            os.environ.pop(key, None)


def train_step_fp32(batch, wrap=lambda m: m, build=flagship_fp32_model, task="lang", seed=11,
                    clip_grad=None, **backbone):
    """One train_step of task ``task`` of ``build(**backbone)``'s fp32 model
    (the flagship file's by default; drop-path 0.3, the curve shuffle and
    the contrastive split drawn from a generator seeded ``seed``; SGD at lr
    0, so the step leaves the weights) on ``batch``, the model wrapped by
    ``wrap``, the gradient clipped at ``clip_grad``. Returns (loss,
    grad_norm, gradients and BatchNorm running statistics by name, each
    stage's pooling overflow)."""
    model, criteria = build(**backbone)
    overflow, forward = [], model.forward

    def recording(point, generator=None, **kwargs):
        out = forward(point, generator=generator, **kwargs)
        if points_of(out) is not None:
            overflow.extend(int(p.n_overflow.max()) for p in points_of(out).plans)
        elif "n_overflow" in out:  # MSC: the passes' largest
            overflow.append(int(out["n_overflow"].item()))
        return out

    model.forward = recording
    metrics = train_step(wrap(model), criteria, torch.optim.SGD(model.parameters(), lr=0.0),
                         None, batch, generator=torch.Generator(device="cuda").manual_seed(seed),
                         epoch_progress=1.0, clip_grad=clip_grad, task=task)
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (metrics["loss"].item(), metrics["grad_norm"].item(),
            {k: p.grad for k, p in model.named_parameters()}, stats, overflow)


def phase_ddp_train(work, plain, data, n_agree=24576):
    """The flagship trainer as phase_train runs it (its data, batch 2, 1 + 2
    steps, its own hooks with the evaluator on the scene-sharded path),
    under a one-process NCCL group, so through DistributedDataParallel,
    beside phase_train's plain trainer; then one fp32 step at ``n_agree``
    points under DDP against the same step without it. Returns the run's
    record and its best checkpoint, copied into ``work``."""
    root, data_s = data
    with torchrun_env(0, 1, free_port()), process_group("cuda"):
        check(torch.distributed.get_backend() == "nccl" and world() == 1,
              "ddp_train: no one-process NCCL group")
        with tempfile.TemporaryDirectory() as tmp:
            reset_k1_counts()
            reset_k2_counts()
            trainer, probe, records, k1_counts = run_training(
                flagship_train_config(root, os.path.join(tmp, "exp"), 2))
            check(isinstance(trainer.train_model, torch.nn.parallel.DistributedDataParallel),
                  "ddp_train: the trainer's step does not run under DDP")
            record = check_flagship_run("ddp_train", trainer, probe, records, k1_counts)
            best = os.path.join(trainer.cfg.save_path, "model", "model_best.pth")
            state = torch.load(best, map_location="cpu", weights_only=False)["state_dict"]
            check(not any(k.startswith("module.") for k in state),
                  "ddp_train: the checkpoint holds DDP's names")
            model_cfg = dict(trainer.cfg.model)
            model_cfg.pop("criteria")
            build_model(model_cfg).load_state_dict(state, strict=True)
            checkpoint = shutil.copy(best, os.path.join(work, "ddp_model_best.pth"))
            del trainer
        torch.cuda.empty_cache()
        warm, plain_warm = (float(np.mean(r["warm_step_ms"])) for r in (record, plain))
        emit(dict(phase="ddp_train", world=1, backend="nccl", batch_size=2,
                  dataset_write_s=data_s, **record, warm_step_ms_mean=warm,
                  plain=dict({k: plain[k] for k in (
                      "steps", "loss", "cold_step_ms", "warm_step_ms", "data_wait_s",
                      "peak_mem_gib")}, warm_step_ms_mean=plain_warm),
                  ddp_over_plain_warm_step=warm / plain_warm))

        batch = cuda_batch(agree_rows(n_agree, (7,), size_m=AGREE_ROOM_M))
        loss, norm, grads, _, overflow = train_step_fp32(
            batch, data_parallel)
        got = (loss, grads, overflow)
        loss, plain_norm, grads, _, overflow = train_step_fp32(batch)
        compare_steps("ddp_train_agree", got, (loss, grads, overflow), names=("ddp", "plain"),
                      points=n_agree, world=1, backend="nccl", grad_norm=[norm, plain_norm])
        check(abs(norm - plain_norm) <= TRAIN_GRAD_RTOL * plain_norm,
              f"ddp_train_agree: gradient norms {norm} and {plain_norm}")
    return record, checkpoint



# ---- wide heads and float16 (K1 and K2 at widths past the shipped ones) -----

# the flagship's channels with heads of width 64 (32 at encoder stage 0):
# C / H = 32, 64, 64, 64 in the encoder and 64, 64, 64 in the decoder
WIDE_HEADS = dict(enc_num_head=(1, 1, 2, 4), dec_num_head=(12, 8, 4))
# float16 serve forward against the fp32 one from the same weights: the
# mean cosine of each Gaussian's features
FP16_MIN_COSINE = 0.99


def head_widths(backbone):
    """The K1 launches of one forward by head width: {C / H: launches}."""
    widths = {}
    for side in ("enc", "dec"):
        for c, h, depth in zip(backbone[f"{side}_channels"], backbone[f"{side}_num_head"],
                               backbone[f"{side}_depths"]):
            widths[c // h] = widths.get(c // h, 0) + depth
    return widths


def check_widths(phase, counts, dtype, variants, widths, forwards):
    """A path's K1 or K2 launches (width_launches since the last reset)
    all on ``variants`` in ``dtype`` at the head widths ``widths`` ({width:
    launches a forward}, instantiated widths: nothing padded), ``forwards``
    times over."""
    got = {}
    for (variant, name, dp), n in counts.items():
        check(name == dtype and variant in variants,
              f"{phase}: {n} launches on {variant} in {name}, expected {variants} in {dtype}")
        got[dp] = got.get(dp, 0) + n
    want = {d: n * forwards for d, n in widths.items()}
    check(got == want, f"{phase}: launches by head width {got}, expected {want}")


def phase_wide_heads(data, text):
    """The flagship LangPretrainer at its channels with heads of width 64
    (WIDE_HEADS): one serve forward at 196,608 Gaussians in bf16 (and one
    warm), K1 against its plain version at its shapes with their times; the
    flagship config file's trainer with those heads, 1 + 2 steps at batch 2
    over the train phase's rooms with its hooks, K1 and K2 launches counted
    by variant and head width, and timing_bwd at its shapes; then one
    float16 serve forward of the unchanged flagship against the fp32 one.
    Every launch must fall on a kernel at an instantiated width. Returns
    the kernels line's record."""
    n = 196608
    rng = np.random.default_rng(0)
    coord, feat_in, grid = room_scene(rng, n, (6.0, 6.0, 3.0))
    sample = dict(coord=coord, feat=feat_in, grid_coord=grid)
    backbone = dict(FLAGSHIP_BACKBONE, **WIDE_HEADS)
    widths = head_widths(backbone)
    check(set(widths) == {32, 64}, f"wide heads: widths {widths}")
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    reset_k1_counts()
    fwa.reset_counts()
    feat, pred, plans, times = serve(model, sample, text, reps=1)
    check_features(feat, n, "wide_serve")
    check_widths("wide_serve", fwa.flash_window_attention.width_launches, "bfloat16",
                 {"bf16_large"}, widths, 2)
    serve_counts = width_counts()
    overflow = [int(p.n_overflow.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"wide_serve: pooling overflow {overflow}")
    emit(dict(phase="wide_serve", points=n, dtype="bfloat16", heads=WIDE_HEADS,
              head_widths=widths, extract_ms=[t[0] for t in times], counts=serve_counts,
              n_overflow=overflow, classes_predicted=int(len(np.unique(pred)))))
    sizes = [(n, n)] + [(p.out_mask.shape[1], int(p.out_mask.sum())) for p in plans]
    serve_tot = phase_timing(stage_shapes(backbone, sizes), phase="wide_timing")
    del model

    root, _ = data
    with tempfile.TemporaryDirectory() as tmp:
        cfg = flagship_train_config(root, os.path.join(tmp, "exp"), 2)
        cfg.merge_from_options({f"model.backbone.{k}": v for k, v in WIDE_HEADS.items()})
        train_bb = dict(cfg.model.backbone)
        reset_k1_counts()
        reset_k2_counts()
        fwa.reset_counts()
        trainer, probe, records, k1_counts = run_training(cfg)
        record = check_flagship_run("wide_train", trainer, probe, records, k1_counts)
        steps, val_forwards = record["steps"], record["validation_forwards"]
        train_widths = head_widths(train_bb)
        check_widths("wide_train (K1)", fwa.flash_window_attention.width_launches, "bfloat16",
                     {"bf16_large", "bf16_small"}, train_widths, steps + val_forwards)
        check_widths("wide_train (K2)", fwa.flash_window_attention_bwd.width_launches,
                     "bfloat16", {"bf16_large", "bf16_small"}, train_widths, steps)
        train_counts = width_counts()
        emit(dict(phase="wide_train", heads=WIDE_HEADS, head_widths=train_widths,
                  counts=train_counts, **{k: v for k, v in record.items() if k != "profile"},
                  profile=record["profile"]))
        del trainer
    torch.cuda.empty_cache()
    train_shapes = stage_shapes(train_bb, [(nn, v.tolist()) for nn, v in records[-1]["sizes"]])
    train_tot = phase_timing_bwd(train_shapes, phase="wide_timing_bwd")

    # float16: the unchanged flagship, against fp32 from the same weights
    model = build_lang_model(FLAGSHIP_BACKBONE, dtype="float16", device="cuda", seed=0)
    fwa.reset_counts()
    feat16, _, plans16, times16 = serve(model, sample, text, reps=0)
    check_features(feat16, n, "fp16_serve")
    check_widths("fp16_serve", fwa.flash_window_attention.width_launches, "float16",
                 {"bf16_large"}, head_widths(FLAGSHIP_BACKBONE), 1)
    fp16_counts = width_counts()
    del model
    model = build_lang_model(FLAGSHIP_BACKBONE, dtype="float32", device="cuda", seed=0)
    feat32 = serve(model, sample, text, reps=0)[0]
    del model
    torch.cuda.empty_cache()
    cosine = float(np.mean(np.sum(feat16 * feat32, axis=1)))
    emit(dict(phase="fp16_serve", points=n, dtype="float16", extract_ms=times16[0][0],
              counts=fp16_counts, mean_cosine_to_fp32=cosine, min_cosine=FP16_MIN_COSINE))
    check(cosine >= FP16_MIN_COSINE, f"fp16_serve: mean cosine {cosine} to the fp32 forward")
    sizes16 = [(n, n)] + [(p.out_mask.shape[1], int(p.out_mask.sum())) for p in plans16]
    fp16_tot = phase_timing(stage_shapes(FLAGSHIP_BACKBONE, sizes16), phase="fp16_timing",
                            dtype=torch.float16)
    return dict(serve=serve_tot, serve_counts=serve_counts, train=train_tot,
                train_counts=train_counts, train_steps=steps, fp16_counts=fp16_counts,
                fp16_mean_cosine=cosine, fp16=fp16_tot)


def write_tool_scene(root, n, seed):
    """A scene directory of the .npy assets the single-scene tools read
    (coord, uint8 colour, opacity, quaternion, scale) from room_scene."""
    rng = np.random.default_rng(seed)
    coord, feat, _ = room_scene(rng, n, (3.0, 3.0, 2.4))
    os.makedirs(root)
    assets = dict(coord=coord, color=((feat[:, :3] + 1) * 127.5).round().astype(np.uint8),
                  opacity=feat[:, 3], quat=feat[:, 4:8], scale=feat[:, 8:11])
    for name, x in assets.items():
        np.save(os.path.join(root, f"{name}.npy"), x)
    return root


def phase_tools(work):
    """The single-scene tools on the card, as a user runs them, over a
    synthetic scene of 40,000 Gaussians written to a temporary directory:
    entry.py --save-features --results-dir (the flagship in bf16; the files
    read back: L2-normalized features, the shifted coordinates, the input
    features, the pickled output), the PCA tool through the model and from
    the saved features (--feat-file), and the scene viewer's PLY of both
    modes; the K1 launches of each model run counted."""
    from scenesplat_tpu_torch import entry
    from scenesplat_tpu_torch.tools import visualize_features_pca, visualize_scene
    from scenesplat_tpu_torch.utils.save_features import load_simple_results

    n = 40000
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        scene = write_tool_scene(os.path.join(tmp, "scene0000_00"), n, seed=31)
        out = os.path.join(tmp, "results")
        reset_k1_counts()
        t0 = time.perf_counter()
        check(entry.main(["--scene", scene, "--save-features", "--results-dir", out]) == 0,
              "tools: entry.py failed")
        entry_s = time.perf_counter() - t0
        entry_k1 = k1_variants()
        run = load_simple_results(out, scene_name="scene0000_00")
        coord, feat = entry.load_scene(scene)
        check(sorted(os.listdir(out)) == sorted(
            f"{os.path.basename(run['prefix'])}_{tag}" for tag in (
                "features.npy", "coords.npy", "input_geom.npy", "full_output.pkl")),
            f"tools: entry.py wrote {sorted(os.listdir(out))}")
        check_features(run["features"], n, "tools/entry")
        check(np.array_equal(run["coords"], coord - coord.min(axis=0))
              and np.array_equal(run["input_geom"], feat),
              "tools: saved coordinates or input features differ from the scene's")
        check(np.array_equal(run["full_output"]["point_feat"], run["features"]),
              "tools: the pickled output differs from the saved features")
        check(sum(entry_k1.values()) == 18 and entry_k1["bf16_large"] == 18,
              f"tools: entry.py's K1 launches {entry_k1}, expected 18 bf16_large")
        plys = {}
        reset_k1_counts()
        for name, extra in (("model", []),
                            ("feat_file", ["--feat-file", f"{run['prefix']}_features.npy"])):
            plys[name] = os.path.join(tmp, f"pca_{name}.ply")
            check(visualize_features_pca.main(["--scene", scene, "--output", plys[name],
                                               *extra]) == 0, f"tools: PCA tool ({name})")
        pca_k1 = k1_variants()
        check(pca_k1["bf16_large"] == 18 and sum(pca_k1.values()) == 18,
              f"tools: the PCA tool's K1 launches {pca_k1}, expected one forward's 18")
        for path in plys.values():
            with open(path, "rb") as f:
                head = f.read(400)
            check(head.startswith(b"ply\n") and f"element vertex {n}\n".encode() in head,
                  f"tools: {path} is not a PLY of {n} points")
        check(visualize_scene.main([scene, "--mode", "both", "--out",
                                    os.path.join(tmp, "viz", "scene")]) == 0,
              "tools: the scene viewer failed")
        viz = sorted(os.listdir(os.path.join(tmp, "viz")))
        check(viz == ["scene_gaussians.ply", "scene_points.ply"], f"tools: viewer wrote {viz}")
        emit(dict(phase="tools", points=n, entry_s=entry_s, entry_k1=entry_k1, pca_k1=pca_k1,
                  saved=sorted(os.listdir(out)), pca_plys=sorted(os.path.basename(p)
                                                                for p in plys.values()),
                  viewer=viz))
    return dict(entry_k1=entry_k1, pca_k1=pca_k1)

def rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm().clamp(min=1e-30)).item()


def points_of(out):
    """A model's output points: PointGroup returns (points, bias); MSC, and
    CAC in training, return a dict of loss terms (None)."""
    if isinstance(out, dict):
        return None
    return out[0] if isinstance(out, tuple) else out


def spawn_ranks(target, world, job_file, timeout_s=600):
    """Runs ``target(rank, world, port, job_file)`` in ``world`` spawned
    processes and waits for them (killed past ``timeout_s``); fails unless
    every one exits 0. Returns the seconds they took."""
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, world, port, job_file)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"{target.__name__}: rank exit codes {[p.exitcode for p in procs]}")
    return time.perf_counter() - t0


def ddp_agree_job(rank, job):
    """A rank's part of ddp_agree: its row of the global batch through the
    fp32 step under DDP, then the zero-shot test entry on its share of the
    scenes; writes what it saw, with its K1 and K2 launches, to the job's
    ``out`` file. On one card the ranks share it over gloo, on CUDA tensors
    (NCCL refuses two ranks on one card), as a job of the shared spawn
    (phase_shared_ddp_agree); on several, each has its own over NCCL
    (ddp_agree_rank)."""
    reset_k1_counts()
    reset_k2_counts()
    rows = {k: v[local_batch_slice(len(v))] for k, v in job["rows"].items()}
    loss, norm, grads, stats, overflow = train_step_fp32(cuda_batch(rows), data_parallel)
    out = dict(loss=loss, grad_norm=norm, overflow=overflow,
               grads={k: g.cpu() for k, g in grads.items()},
               stats={k: v.cpu() for k, v in stats.items()},
               k1_step=fwa.flash_window_attention.launches,
               k1_step_variants=k1_lse_variants(),
               k2_step=fwa.flash_window_attention_bwd.launches,
               k2_step_variants=dict(fwa.flash_window_attention_bwd.variant_launches))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    reset_k1_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (out["test"],) = test_entry.main(job["test_argv"])
    finally:
        torch.use_deterministic_algorithms(False)
    out.update(k1_test=fwa.flash_window_attention.launches, k1_test_variants=k1_variants())
    torch.save(out, job["out"].format(rank=rank))


def ddp_agree_rank(rank, world, port, job_file):
    """One rank of ddp_cards_agree (a spawned process on its own card over
    NCCL): ddp_agree_job."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda", backend="nccl")
        try:
            ddp_agree_job(rank, job)
        finally:
            torch.distributed.destroy_process_group()


def prepare_ddp_agree(work, checkpoint, meta_root, n=24576, n_voxels=20000, world=2, cards=1):
    """``world`` ranks (one row each) against one process on the first
    card: the fp32 step of a global batch of ``world`` rows of ``n`` points
    (drop-path 0.3, the contrastive term on) and the zero-shot test entry
    over 3 scenes with ``checkpoint`` (at 4 ranks one draws no scene). This
    process's step and test run now; returns the ranks' job (on one card a
    job of phase_shared_ddp_agree's spawn, the ranks sharing the card over
    gloo; with ``cards`` > 1 phase_ddp_agree spawns them, a card each over
    NCCL), with finish_ddp_agree's check, and the one-process step (rows,
    loss, norm, gradients, statistics: tp_agree's and cp_agree's
    reference)."""
    phase = "ddp_agree" if cards == 1 else "ddp_cards_agree"
    rows = agree_rows(n, tuple(range(7, 7 + world)), size_m=AGREE_ROOM_M)
    loss, norm, grads, stats, overflow = train_step_fp32(cuda_batch(rows))
    ref = dict(rows=rows, loss=loss, grad_norm=norm, grads={k: g.cpu() for k, g in grads.items()},
               overflow=overflow, stats={k: v.cpu() for k, v in stats.items()})
    del grads, stats
    gc.collect()
    torch.cuda.empty_cache()

    data_root = os.path.join(work, f"{phase}_scenes")
    n_points = write_test_scenes(data_root, 3, n_voxels, seed=21, pc_points=n_voxels // 2)
    cfg_file = os.path.join(work, f"{phase}_test.py")
    with open(cfg_file, "w") as f:
        f.write(TEST_CONFIG.format(flagship=os.path.abspath(FLAGSHIP_CONFIG),
                                   pipelines=os.path.abspath(PIPELINES),
                                   data_root=data_root, meta_root=meta_root))
    argv = ["--config-file", cfg_file, "--options", f"weight={checkpoint}", "bitonic_sort=False"]
    one_dir, two_dir = (os.path.join(work, f"{phase}_{name}") for name in ("one", "ranks"))
    # the pooling's scatter-adds in one order in every run (see run_test_entry)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_k1_counts()
        (one,) = test_entry.main(argv + [f"test.save_path={one_dir}"])
        k1_one = fwa.flash_window_attention.launches
    finally:
        torch.use_deterministic_algorithms(False)

    job = dict(kind="ddp", rows=rows, test_argv=argv + [f"test.save_path={two_dir}"],
               out=os.path.join(work, f"{phase}_rank{{rank}}.pt"))
    test = dict(one=one, k1_one=k1_one, one_dir=one_dir, two_dir=two_dir, n_points=n_points)
    return dict(phase=phase, job=job, finish=lambda ranks, ranks_s, world: finish_ddp_agree(
        phase, ranks, ranks_s, world, cards, ref, test)), ref


def phase_ddp_agree(work, checkpoint, meta_root, world, cards):
    """ddp_cards_agree: prepare_ddp_agree's check with a card a rank over
    NCCL, its ranks in a spawn of their own. Returns their launches."""
    pending, _ = prepare_ddp_agree(work, checkpoint, meta_root, world=world, cards=cards)
    job_file = os.path.join(work, f"{pending['phase']}_job.pt")
    torch.save(pending["job"], job_file)
    ranks_s = spawn_ranks(ddp_agree_rank, world, job_file)
    ranks = [torch.load(pending["job"]["out"].format(rank=r), weights_only=False)
             for r in range(world)]
    return pending["finish"](ranks, ranks_s, world)


def finish_ddp_agree(phase, ranks, ranks_s, world, cards, ref, test):
    """prepare_ddp_agree's check of the ranks' outputs ``ranks``; returns
    their K1 and K2 launches."""
    n, loss, norm, stats = ref["rows"]["mask"].shape[1], ref["loss"], ref["grad_norm"], \
        ref["stats"]
    one, k1_one, one_dir, two_dir = test["one"], test["k1_one"], test["one_dir"], test["two_dir"]
    backend = "gloo" if cards == 1 else "nccl"
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    for r, got in enumerate(ranks):
        compare_steps(f"{phase}_rank{r}", (got["loss"], got["grads"], got["overflow"]),
                      (loss, ref["grads"], ref["overflow"]),
                      names=("ranks", "one"), points=n, rows=world, world=world,
                      backend=backend, grad_norm=[got["grad_norm"], norm])
        check(abs(got["grad_norm"] - norm) <= TRAIN_GRAD_RTOL * norm,
              f"{phase}: rank {r}'s gradient norm {got['grad_norm']} against {norm}")
        stat_err = {k: rel_l2(v, stats[k]) for k, v in got["stats"].items()}
        check(sorted(stat_err) == sorted(stats) and max(stat_err.values()) <= TRAIN_GRAD_RTOL,
              f"{phase}: rank {r}'s BatchNorm statistics differ by {max(stat_err.values())}")
        check(got["k1_step"] == got["k2_step"] == blocks,
              f"{phase}: rank {r} launched K1 {got['k1_step']} and K2 {got['k2_step']} "
              f"times in its step, expected {blocks}")
        got["stat_worst_rel_l2"] = max(stat_err.values())
        for key, g in ranks[0]["grads"].items():
            check(torch.equal(g, got["grads"][key]), f"{phase}: rank {r}'s {key} gradient "
                  "differs from rank 0's")

    one_preds = {f: np.load(os.path.join(one_dir, f)) for f in os.listdir(one_dir)
                 if f.endswith("_pred.npy")}
    two_preds = {f: np.load(os.path.join(two_dir, f)) for f in os.listdir(two_dir)
                 if f.endswith("_pred.npy")}
    check(len(one_preds) == 3 and sorted(one_preds) == sorted(two_preds),
          f"{phase}: scenes {sorted(one_preds)} and {sorted(two_preds)}")
    for name, pred in one_preds.items():
        check(np.array_equal(pred, two_preds[name]), f"{phase}: {name} predictions differ")
    for r, got in enumerate(ranks):
        check(sorted(got["test"]) == sorted(one) and all(
            np.array_equal(got["test"][k], one[k]) for k in one),
              f"{phase}: rank {r}'s test metrics differ from one process's")
        check((got["k1_test"] > 0) == (r < 3), f"{phase}: rank {r} launched K1 "
              f"{got['k1_test']} times in testing (3 scenes round-robin)")
    k1_test = sum(got["k1_test"] for got in ranks)
    check(k1_test == k1_one, f"{phase}: the ranks launched K1 "
          f"{[got['k1_test'] for got in ranks]} times in testing, one process {k1_one}")
    with open(os.path.join(two_dir, "scene_log.json")) as f:
        check(len(json.load(f)) == 3, f"{phase}: rank 0's scene log lacks scenes")
    emit(dict(phase=phase, world=world, backend=backend, cards=cards, points=n, rows=world,
              dtype="float32", drop_path=0.3, loss=[got["loss"] for got in ranks],
              loss_one=loss, grad_norm=[got["grad_norm"] for got in ranks], grad_norm_one=norm,
              stat_worst_rel_l2=[got["stat_worst_rel_l2"] for got in ranks],
              stat_tensors=len(stats), ranks_s=ranks_s,
              k1_step=[got["k1_step"] for got in ranks],
              k2_step=[got["k2_step"] for got in ranks],
              test_scenes=3, test_points_per_scene=test["n_points"],
              test_metrics={k: one[k] for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")},
              test_metrics_equal=True, predictions_equal=True,
              k1_test=[got["k1_test"] for got in ranks], k1_test_one_process=k1_one))
    return dict(k1_lse=sum(got["k1_step"] for got in ranks),
                k2=sum(got["k2_step"] for got in ranks), k1_test=k1_test,
                k1_lse_variants=sum_counts(got["k1_step_variants"] for got in ranks),
                k2_variants=sum_counts(got["k2_step_variants"] for got in ranks),
                k1_test_variants=sum_counts(got["k1_test_variants"] for got in ranks))


def ddp_train_rank(rank, world, port, job_file):
    """One rank of phase_ddp_cards_train (a spawned process, its own card,
    NCCL): the flagship trainer at the job's global batch; writes its
    per-step losses, gradient norms, step times, loader waits, peak memory,
    K1 / K2 launches, pooling overflow, validation and profile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda")
        try:
            reset_k1_counts()
            reset_k2_counts()
            trainer, probe, records, k1_counts = run_training(flagship_train_config(
                job["root"], job["exp"], job["batch_size"]))
            hist = trainer.storage.history
            step_ms = probe.step_ms()
            torch.save(dict(
                loss=hist("loss").values(), grad_norm=hist("grad_norm").values(),
                data_wait_s=hist("data_time").values(), cold_step_ms=step_ms[0],
                warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                k1=k1_counts["train_launches"], k1_val=k1_counts["val_launches"],
                val_forwards=k1_counts["val_forwards"],
                k2=fwa.flash_window_attention_bwd.launches,
                overflow=[int(max(int(o.max()) for o in r["overflow"])) for r in records],
                validation={k: hist(k).values() for k in ("val0/fg_mIoU", "val/fg_mIoU")},
                profile=probe.profile, train_steps=len(trainer.train_loader)),
                job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


def phase_ddp_cards_train(work, cards):
    """The flagship file as it ships it: its global batch of 8, 2 rows a
    card on ``cards`` cards, each rank a spawned process on its own card
    over NCCL, at 196,608 points over the train phase's rooms (each listed
    4 times, so that every dataset fills batches of 16 Mix3D samples), for
    its steps of one epoch and one sharded validation. Every rank holds the
    same loss and gradient norm at every step, K1 and K2 launch once a block
    a step, rank 0 alone writes the checkpoint. Each rank's pooling
    overflow is recorded, not refused: with 16 Mix3D samples a batch some
    rank draws a pair of augmented rooms whose 4 cm clusters overflow the
    file's first capacity (497 over 98,304 in one run), as one card would
    with these draws."""
    with tempfile.TemporaryDirectory() as tmp:
        root, data_s = write_flagship_data(tmp, copies=4, rooms=4)
        exp = os.path.join(tmp, "exp")
        job_file = os.path.join(work, "ddp_cards_train_job.pt")
        torch.save(dict(root=root, exp=exp, batch_size=2 * cards,
                        out=os.path.join(work, "ddp_cards_train_rank{rank}.pt")), job_file)
        ranks_s = spawn_ranks(ddp_train_rank, cards, job_file, timeout_s=900)
        ranks = [torch.load(os.path.join(work, f"ddp_cards_train_rank{r}.pt"),
                            weights_only=False) for r in range(cards)]
        best = os.path.join(exp, "model", "model_best.pth")
        check(os.path.exists(best), "ddp_cards_train: no checkpoint")
        checkpoint = shutil.copy(best, os.path.join(work, "ddp_cards_model_best.pth"))
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    steps = len(ranks[0]["loss"])
    emit(dict(phase="ddp_cards_train", world=cards, backend="nccl", batch_size=2 * cards,
              rows_per_card=2, points=TRAIN_POINTS, steps=steps, dataset_write_s=data_s,
              ranks_s=ranks_s, loss=ranks[0]["loss"], grad_norm=ranks[0]["grad_norm"],
              validation=ranks[0]["validation"],
              per_rank=[dict({k: got[k] for k in (
                  "cold_step_ms", "warm_step_ms", "profiled_step_ms", "data_wait_s",
                  "peak_mem_gib", "k1", "k1_val", "val_forwards", "k2", "overflow")},
                  profile={k: v for k, v in (got["profile"] or {}).items()
                           if k != "top_kernels"}) for got in ranks]))
    check(steps >= 6, f"ddp_cards_train: {steps} steps")
    for r, got in enumerate(ranks):
        check(got["loss"] == ranks[0]["loss"] and got["grad_norm"] == ranks[0]["grad_norm"],
              f"ddp_cards_train: rank {r}'s losses {got['loss']} against rank 0's")
        check(all(math.isfinite(v) for v in got["loss"] + got["grad_norm"]),
              f"ddp_cards_train: rank {r}: non-finite losses")
        check(got["k1"] == got["k2"] == blocks * steps,
              f"ddp_cards_train: rank {r} launched K1 {got['k1']} and K2 {got['k2']} times "
              f"in {steps} steps")
        check(got["validation"] == ranks[0]["validation"],
              f"ddp_cards_train: rank {r}'s validation differs from rank 0's")
    return dict(k1_lse=sum(got["k1"] for got in ranks), k2=sum(got["k2"] for got in ranks),
                k1_val=sum(got["k1_val"] for got in ranks)), checkpoint


# the semseg and SSL files' global batches, and whether their runs on
# ``--cards`` cards recompute the blocks (remat_blocks): cards_fit on an
# H100 80GB (700 W) held 8 semseg and 4 SSL rows a card without it, 12
# and 6 with it, so the files' 12 and 6 rows a card on 4 cards need it
CARDS_TASKS = dict(semseg=(SEMSEG_CONFIG, 48), ssl=(SSL_CONFIG, 24))
CARDS_REMAT = dict(semseg=True, ssl=True)
CARDS_STEPS = 4


def task_train_config(task, root, exp, batch_size, steps, remat):
    """The task's file as semseg_train / ssl_train read it, at
    ``batch_size`` for ``steps`` steps over 4 rooms, ``remat_blocks`` as
    given, with the timer and the writer for hooks only (no evaluation, no
    checkpoint: a run of steps)."""
    make = semseg_train_config if task == "semseg" else ssl_train_config
    cfg = make(root, exp, batch_size, steps, 4)
    cfg.model.backbone["remat_blocks"] = remat
    cfg.hooks = [h for h in cfg.hooks if h["type"] in ("IterationTimer", "InformationWriter")]
    return cfg


def run_task_steps(task, cfg):
    """Trains ``cfg``'s steps on the card (under DDP in a group) with a
    StepProbe that profiles the last step; returns the run's record."""
    reset_k1_counts()
    reset_k2_counts()
    trainer = build_trainer(cfg, device="cuda")
    probe = StepProbe(profile_step=len(trainer.train_loader) - 1)
    probe.trainer = trainer
    trainer.hooks.append(probe)
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    hist = trainer.storage.history
    step_ms = probe.step_ms()
    record = dict(task=task, world=trainer.world, batch_size=cfg.batch_size,
                  rows_per_card=cfg.batch_size // trainer.world,
                  remat_blocks=cfg.model.backbone["remat_blocks"],
                  loss=hist("loss").values(), grad_norm=hist("grad_norm").values(),
                  data_wait_s=hist("data_time").values(), cold_step_ms=step_ms[0],
                  warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  k1_lse=sum(k1_lse_variants().values()),
                  k1=fwa.flash_window_attention.launches,
                  k2=fwa.flash_window_attention_bwd.launches,
                  profile={k: v for k, v in (probe.profile or {}).items() if k != "top_kernels"},
                  top_kernels=(probe.profile or {}).get("top_kernels", [])[:8])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return record


def cards_task_rank(rank, world, port, job_file):
    """One rank of phase_cards_task (a spawned process on its own card over
    NCCL): the job's task at its global batch; writes the run's record."""
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda")
        try:
            cfg = task_train_config(job["task"], job["root"], job["exp"], job["batch_size"],
                                    CARDS_STEPS, job["remat"])
            torch.save(run_task_steps(job["task"], cfg), job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


def write_task_rooms(tmp):
    """4 synthetic rooms of 200,000 2 cm voxels with normals and 20
    classes (semseg_train's), under tmp/rooms/train."""
    root = os.path.join(tmp, "rooms")
    write_gs_scenes(os.path.join(root, "train"), 4, 200000, seed=21, semseg=True)
    return root


def phase_cards_task(work, cards, task):
    """cards_semseg / cards_ssl: the task's file at its own global batch
    (semseg 48, 12 rows a card; SSL 24, 6 a card) on ``cards`` cards, each
    rank a spawned process on its card over NCCL, ``remat_blocks`` as
    CARDS_REMAT says, for CARDS_STEPS steps over 4 rooms at the file's
    points: every card's warm step, peak memory, loader wait and NCCL time
    (the profiled last step), and the same losses on every rank."""
    config, batch = CARDS_TASKS[task]
    phase = f"cards_{task}"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = write_task_rooms(tmp)
        data_s = time.perf_counter() - t0
        job_file = os.path.join(work, f"{phase}_job.pt")
        torch.save(dict(task=task, root=root, exp=os.path.join(tmp, "exp"), batch_size=batch,
                        remat=CARDS_REMAT[task],
                        out=os.path.join(work, f"{phase}_rank{{rank}}.pt")), job_file)
        ranks_s = spawn_ranks(cards_task_rank, cards, job_file, timeout_s=1500)
        ranks = [torch.load(os.path.join(work, f"{phase}_rank{r}.pt"), weights_only=False)
                 for r in range(cards)]
    emit(dict(phase=phase, config=config, world=cards, backend="nccl", batch_size=batch,
              rows_per_card=batch // cards, remat_blocks=CARDS_REMAT[task],
              dataset_write_s=data_s, ranks_s=ranks_s, loss=ranks[0]["loss"],
              grad_norm=ranks[0]["grad_norm"],
              per_rank=[{k: v for k, v in got.items() if k not in ("loss", "grad_norm")}
                        for got in ranks]))
    for r, got in enumerate(ranks):
        check(len(got["loss"]) == CARDS_STEPS, f"{phase}: rank {r} took {len(got['loss'])} steps")
        check(got["loss"] == ranks[0]["loss"] and got["grad_norm"] == ranks[0]["grad_norm"],
              f"{phase}: rank {r}'s losses {got['loss']} against rank 0's {ranks[0]['loss']}")
        check(all(math.isfinite(v) for v in got["loss"] + got["grad_norm"]),
              f"{phase}: rank {r}: non-finite losses")
        check(got["k1_lse"] > 0 and got["k2"] > 0, f"{phase}: rank {r} launched no K1 / K2")
    return dict(k1_lse=sum(got["k1_lse"] for got in ranks), k2=sum(got["k2"] for got in ranks),
                k1=sum(got["k1"] - got["k1_lse"] for got in ranks))


def phase_cards_fit(work, cards):
    """cards_fit, on one card: the rows a card the semseg and SSL files'
    global batches give on ``cards`` cards (12 and 6 on 4), trained for 2
    steps in one process with remat_blocks off and on; when a batch runs out
    of the card's memory, the next smaller even batch, down to the largest
    that fits. Records each try's peak memory and step times. (One process:
    under DDP a card also holds the gradient buckets, and the semseg Lovasz
    sort spans every card's rows.)"""
    tries = []
    with tempfile.TemporaryDirectory() as tmp:
        root = write_task_rooms(tmp)
        for task, (config, batch) in CARDS_TASKS.items():
            target = batch // cards
            for remat in (False, True):
                for b in range(target, 0, -2):
                    cfg = task_train_config(task, root, os.path.join(tmp, f"{task}_{b}_{remat}"),
                                            b, 2, remat)
                    try:
                        rec = dict(run_task_steps(task, cfg), fits=True)
                    except torch.cuda.OutOfMemoryError as e:
                        rec = dict(task=task, batch_size=b, rows_per_card=b, remat_blocks=remat,
                                   fits=False, error=str(e).splitlines()[0][:200])
                    gc.collect()
                    torch.cuda.empty_cache()
                    emit(dict(phase="cards_fit_try", **{k: v for k, v in rec.items()
                                                        if k != "top_kernels"}))
                    tries.append(rec)
                    if rec["fits"]:
                        break
    largest = {f"{task}_remat_{remat}": max(
        [t["rows_per_card"] for t in tries if t["task"] == task and t["remat_blocks"] == remat
         and t["fits"]], default=0) for task in CARDS_TASKS for remat in (False, True)}
    emit(dict(phase="cards_fit", cards=cards, targets={t: b // cards for t, (_, b)
                                                       in CARDS_TASKS.items()},
              largest_rows_per_card=largest))


# the grids of ``--cards 4 tp|cp`` (cards_grid): the flagship file's model
# (bf16) and AdamW at its lr, rows of TRAIN_POINTS points; one cold step,
# two warm ones and a profiled one
CARDS_GRID_STEPS = 4
CARDS_GRID_ROOM_M = 4.4  # a cube whose floor and walls hold TRAIN_POINTS 2 cm voxels


def cards_grid_rank(rank, world, port, job_file):
    """One rank of phase_cards_grid (its own card, NCCL): the layout of
    the job's ``kind`` ("dp": plain data parallel, 2 rows a card; "tp":
    (data 2, model 2), each model group's 2 rows on both its cards; "cp":
    (data 2, seq 2), each seq group's 2 rows split by slots), its rows (made
    here from their seeds), CARDS_GRID_STEPS train steps under DDP over the
    points group; writes the step times, the profiled step's NCCL and busy
    device time, the peak memory, the losses and K1 / K2 launches."""
    from torch.profiler import ProfilerActivity, profile

    job = torch.load(job_file, weights_only=False)
    kind = job["kind"]
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda")
        try:
            if kind != "dp":
                set_layout(tp_groups(2, world // 2) if kind == "tp" else context_groups(2))
            grid = layout()
            per = 2 * world // grid.data // grid.seq // grid.model  # rows a data rank holds
            seeds = [100 + grid.data_rank * per + i for i in range(per)]
            rows = agree_rows(TRAIN_POINTS, seeds, size_m=CARDS_GRID_ROOM_M)
            if kind == "cp":
                n = TRAIN_POINTS // grid.seq
                rows = {k: v[:, grid.seq_rank * n:(grid.seq_rank + 1) * n] for k, v in rows.items()}
            batch = cuda_batch(rows)
            cfg = Config.fromfile(FLAGSHIP_CONFIG)
            model = build_model(dict(type="LangPretrainer",
                                     backbone=dict(cfg.model.backbone, seed=1))).cuda()
            if kind == "tp":
                shard_model_tp(model)
            criteria = build_criteria(cfg.model.criteria)
            optimizer = torch.optim.AdamW(model.parameters(), lr=cfg.optimizer.lr,
                                          weight_decay=cfg.optimizer.weight_decay)
            ddp = data_parallel(model)
            gen = torch.Generator(device="cuda").manual_seed(11)
            reset_k1_counts()
            reset_k2_counts()
            context.GATHERED.update(forward=0, backward=0)
            torch.cuda.reset_peak_memory_stats()
            step_ms, losses, prof = [], [], None
            for i in range(CARDS_GRID_STEPS):
                if i == CARDS_GRID_STEPS - 1:
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.__enter__()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = train_step(ddp, criteria, optimizer, None, batch, generator=gen,
                                     epoch_progress=1.0, clip_grad=cfg.clip_grad)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(metrics["loss"].item())
            prof.__exit__(None, None, None)
            kernels = device_kernels(prof)
            torch.save(dict(
                step_ms=step_ms, loss=losses, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                nccl_ms=sum(e.self_device_time_total for e in kernels
                            if "nccl" in e.key.lower()) / 1e3,
                device_busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                k1=fwa.flash_window_attention.launches,
                k2=fwa.flash_window_attention_bwd.launches,
                gathered_gib=sum(context.GATHERED.values()) / CARDS_GRID_STEPS / 2 ** 30,
                coords=(grid.data_rank, grid.seq_rank, grid.model_rank)),
                job["out"].format(rank=rank))
        finally:
            set_layout(None)
            torch.distributed.destroy_process_group()


def phase_cards_grid(work, cards, kind):
    """cards_grid_<kind> on ``cards`` cards over NCCL (see cards_grid_rank):
    per card the cold and warm step ms, the profiled step's NCCL ms and
    device busy ms, the peak memory and K1 / K2 launches; the losses equal
    on the ranks of one model or seq group (the same global loss)."""
    job_file = os.path.join(work, f"cards_grid_{kind}_job.pt")
    torch.save(dict(kind=kind, out=os.path.join(work, f"cards_grid_{kind}_rank{{rank}}.pt")),
               job_file)
    ranks_s = spawn_ranks(cards_grid_rank, cards, job_file, timeout_s=900)
    ranks = [torch.load(os.path.join(work, f"cards_grid_{kind}_rank{r}.pt"), weights_only=False)
             for r in range(cards)]
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    for r, got in enumerate(ranks):
        check(all(math.isfinite(v) for v in got["loss"]), f"cards_grid_{kind}: rank {r}'s "
              f"losses {got['loss']}")
        check(got["k1"] == got["k2"] == blocks * CARDS_GRID_STEPS,
              f"cards_grid_{kind}: rank {r} launched K1 {got['k1']} and K2 {got['k2']} times")
    emit(dict(phase=f"cards_grid_{kind}", cards=cards, backend="nccl", points=TRAIN_POINTS,
              grid=dict(dp="(data 4)", tp="(data 2, model 2)", cp="(data 2, seq 2)")[kind],
              rows_per_card=2, slots_per_row_per_card=TRAIN_POINTS // (2 if kind == "cp" else 1),
              global_batch=dict(dp=8, tp=4, cp=4)[kind],
              ranks_s=ranks_s, steps=CARDS_GRID_STEPS,
              per_rank=[dict(got, cold_step_ms=got["step_ms"][0],
                             warm_step_ms=got["step_ms"][1:-1]) for got in ranks]))
    return dict(k1=sum(got["k1"] for got in ranks), k2=sum(got["k2"] for got in ranks))


def main_cards(cards, phases=()) -> int:
    """``python3 chip_smoke.py --cards N [phase ...]``: data parallel across
    ``N`` cards of one host (not the one-card smoke test): the kernels'
    build, then the phases asked for (all but ``fit`` by default):
    ``flagship``, the flagship file at its global batch of 8
    (ddp_cards_train) and N ranks over NCCL against one process
    (ddp_cards_agree, whose one-process test runs on ddp_cards_train's
    checkpoint); ``semseg`` and ``ssl``, those files at their global
    batches of 48 and 24 (cards_semseg, cards_ssl); ``fit``, on one card,
    the rows a card those batches give on N cards, with remat_blocks off
    and on (cards_fit); ``tp`` and ``cp``, the flagship file's model under
    (data 2, model 2) and (data 2, seq 2) beside plain data parallel at 2
    rows a card (cards_grid_dp, cards_grid_tp, cards_grid_cp)."""
    phases = tuple(phases) or ("flagship", "semseg", "ssl")
    unknown = set(phases) - {"flagship", "semseg", "ssl", "fit", "tp", "cp"}
    check(not unknown, f"--cards: unknown phases {sorted(unknown)}")
    if set(phases) - {"fit"}:
        check(torch.cuda.device_count() >= cards,
              f"--cards {cards}: {torch.cuda.device_count()} cards")
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as work:
        meta_root = os.path.join(work, "metadata")
        write_meta(meta_root)
        os.environ["SCENESPLAT_META_ROOT"] = meta_root
        smi = phase_device()
        if "fit" in phases:
            phase_cards_fit(work, cards)
        if "flagship" in phases:
            train, checkpoint = phase_ddp_cards_train(work, cards)
            agree = phase_ddp_agree(work, checkpoint, meta_root, world=cards, cards=cards)
            launches["flagship"] = dict(k1_lse=train["k1_lse"] + agree["k1_lse"],
                                        k2=train["k2"] + agree["k2"], k1_test=agree["k1_test"])
        for task in ("semseg", "ssl"):
            if task in phases:
                launches[task] = phase_cards_task(work, cards, task)
        for kind in ("dp", "tp", "cp"):
            if {"tp", "cp"} & set(phases) and (kind == "dp" or kind in phases):
                launches[f"grid_{kind}"] = phase_cards_grid(work, cards, kind)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)
    emit(dict(cards=cards, phases=list(phases), launches=launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


SORT_ROWS = (1000, 1024, 5000, 4095, 4097, 24576, 196608, 1 << 20)
# (operands, keys, heavy ties): the last operand is the element index
SORT_SIGNATURES = ((2, 1, False), (2, 2, True), (3, 1, True), (3, 2, False), (3, 3, True))


def combined_key(keys):
    """int64 whose signed order is the unsigned lexicographic order of one
    or two int32 bit patterns."""
    out = torch.zeros_like(keys[0], dtype=torch.int64)
    for k in keys:
        out = (out << 32) | (k.to(torch.int64) & 0xFFFFFFFF)
    return out ^ -(1 << 63) if len(keys) == 2 else out


def sort_max_abs_diff(got, ref):
    """The largest |got - ref| over every operand, keys and payloads."""
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def sort_switch(on):
    """Sets the sort switch as the entry points' bitonic_sort option does."""
    bs.apply_sort_switch(dict(bitonic_sort=on))


def phase_kernel_sort():
    """K3 against its plain version, exact, payloads included (both run one
    network on identically padded rows), and against torch.sort."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases, checked, worst = [], 0, 0
    for n in SORT_ROWS:
        for b in (1, 4, 12):
            if b * n > (1 << 20) and b > (4 if n < (1 << 20) else 1):
                continue  # long rows: fewer of them
            for num_ops, num_keys, ties in SORT_SIGNATURES:
                lo, hi = (0, 8) if ties else (-2 ** 31, 2 ** 31 - 1)
                ops = [torch.randint(lo, hi, (b, n), generator=gen, device="cuda",
                                     dtype=torch.int32) for _ in range(num_ops - 1)]
                ops.append(torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n))
                kept = [o.clone() for o in ops]
                got = bs.bitonic_sort(ops, num_keys)
                ref = bs.bitonic_sort_reference(ops, num_keys)
                torch.cuda.synchronize()
                what = f"B={b} n={n} operands={num_ops} keys={num_keys} ties={ties}"
                worst = max(worst, sort_max_abs_diff(got, ref))
                check(all(torch.equal(g, r) for g, r in zip(got, ref)),
                      f"K3 differs from its plain version at {what}")
                check(all(torch.equal(o, k) for o, k in zip(ops, kept)),
                      f"K3 changed its inputs at {what}")
                data_keys = num_keys - (num_keys == num_ops)  # without the index
                if data_keys <= 2:
                    want = torch.sort(combined_key(ops[:data_keys]), dim=-1, stable=True)
                    check(torch.equal(combined_key(got[:data_keys]), want.values),
                          f"K3 keys differ from torch.sort at {what}")
                    if num_keys == num_ops:  # the index as last key: the stable order
                        check(torch.equal(got[-1].long(), want.indices),
                              f"K3 order differs from the stable torch.sort at {what}")
                checked += 1
            cases.append(dict(B=b, n=n, padded=bs.padded_length(n),
                              kernel_launches=bs.kernel_launches(n)))
    # int64 codes with duplicates and a sentinel tail, as the sort sites see
    # them: K3's int64 entry (sort_int64 with the switch on) against its plain
    # version on the codes' halves and the index, and against torch.sort
    int64_shapes = ((4, 1, 196608), (3, 2, 24576), (393216,), (1, 5000), (3, 70000), (4, 1000),
                    (1, 1 << 20))
    for shape in int64_shapes:
        code = torch.randint(0, 1 << 28, shape, generator=gen, device="cuda")
        code[..., -(shape[-1] // 7):] = SENTINEL
        sort_switch(False)
        values, order = bs.sort_int64(code)
        calls, kernels = bs.bitonic_sort.launches, bs.bitonic_sort.kernel_launches
        sort_switch(True)
        values_on, order_on = bs.sort_int64(code)
        sort_switch(False)
        check(bs.bitonic_sort.launches == calls + 1 and bs.bitonic_sort.kernel_launches
              == kernels + bs.kernel_launches(shape[-1]),
              f"sort_int64 with the switch on did not make one K3 call of "
              f"{bs.kernel_launches(shape[-1])} launches at {shape}")
        check(torch.equal(values, values_on) and torch.equal(order, order_on),
              f"sort_int64 with the switch on differs from torch.sort at {shape}")
        halves = code.view(torch.int32).view(*shape, 2)
        iota = torch.arange(shape[-1], dtype=torch.int32, device="cuda").expand(shape)
        hi, lo, idx = bs.bitonic_sort_reference((halves[..., 1], halves[..., 0], iota), 3)
        plain = ((hi.long() << 32) | (lo.long() & 0xFFFFFFFF), idx.long())
        worst = max(worst, sort_max_abs_diff((values_on, order_on), plain))
        check(torch.equal(values_on, plain[0]) and torch.equal(order_on, plain[1]),
              f"K3's int64 entry differs from its plain version at {shape}")
        checked += 1
    check(bs.kernel_launches(1 << 18) <= 10, "a row of 2^18 takes more than 10 launches")
    emit(dict(phase="kernel_sort", exact=True, signatures=checked, max_abs_err=worst,
              int64_shapes=int64_shapes, launches_at_2_18=bs.kernel_launches(1 << 18),
              rows=cases))
    return worst


def ppt_labels(seg20, coord):
    """100 ScanNet++ classes from the 20 (angle and height) and the
    quadrant of the x-y plane (5 per ScanNet class, the fifth never used)."""
    quadrant = 2 * (coord[:, 0] > coord[:, 0].mean()) + (coord[:, 1] > coord[:, 1].mean())
    return (5 * seg20.astype(np.int64) + quadrant).astype(np.int16)


def write_test_scenes(root, n_scenes, n_voxels, seed, pc_points=100000, semseg=False,
                      ppt=False):
    """``n_scenes`` ScanNet-layout scenes under root/val: ``n_voxels``
    unique 2 cm voxels on the floor and walls of a 6 x 6 x 3 m room, each
    holding two Gaussians 1 cm apart on its diagonal, plus one Gaussian at
    height 0 in a voxel of its own, so that the 1 cm deduplication keeps all
    2 n + 1 and the 2 cm test voxelisation, whose cells line up with the
    voxels after CenterShift, gives 2 fragments of n + 1 points. With 200
    classes by position as ``segment200``, valid_feat_mask and an
    evaluation point cloud of ``pc_points`` of the Gaussians moved by a few
    millimetres; with ``semseg`` the semseg files' assets instead: normals
    and 20 classes by angle and height as ``segment20``, with ``ppt`` also
    the 100 of ppt_labels as ``segment``. Returns the Gaussians a scene
    holds."""
    rng = np.random.default_rng(seed)
    extent = [int(round(m / GRID)) for m in (6.0, 6.0, 3.0)]
    ex, ey, _ = extent
    x, y, z = np.meshgrid(*(np.arange(e) for e in extent), indexing="ij")
    surface = (z < 1) | (x < 1) | (x >= ex - 1) | (y < 1) | (y >= ey - 1)
    vox = np.stack([x[surface], y[surface], z[surface]], -1)
    for i in range(n_scenes):
        perm = rng.permutation(len(vox))
        grid = vox[perm[:n_voxels]]
        rest = vox[perm[n_voxels:]]
        anchor = rest[np.flatnonzero((rest[:, 2] == 0) & (rest[:, 0] > 0) & (rest[:, 0] < ex - 1)
                                     & (rest[:, 1] > 0) & (rest[:, 1] < ey - 1))[0]]
        coord = np.concatenate([(grid + 0.25) * GRID, (grid + 0.75) * GRID,
                                [[(anchor[0] + 0.5) * GRID, (anchor[1] + 0.5) * GRID, 0.0]]]
                               ).astype(np.float32)
        n = len(coord)
        angle = np.arctan2(coord[:, 1] - 3.0, coord[:, 0] - 3.0)
        if semseg:
            seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
            seg = (seg + 10 * (coord[:, 2] > 1.5)).astype(np.int16)
        else:
            seg = ((angle + np.pi) / (2 * np.pi) * 20).astype(np.int64).clip(0, 19)
            seg = (seg * 10 + (coord[:, 2] / 3.0 * 10).astype(np.int64).clip(0, 9)
                   ).astype(np.int16)
            pick = rng.choice(n, pc_points, replace=False)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32))
        if semseg:
            cells = np.concatenate([grid, grid, anchor[None]])
            assets.update(segment20=seg, normal=shell_normals(cells, extent, 1))
            if ppt:
                assets["segment"] = ppt_labels(seg, coord)
        else:
            assets.update(
                segment200=seg, valid_feat_mask=rng.random(n) > 0.1,
                pc_coord=(coord[pick] + rng.normal(0, 0.002, (pc_points, 3))).astype(np.float32),
                pc_segment200=seg[pick].astype(np.int32))
        scene = os.path.join(root, "val", f"scene{i:04d}_00")
        os.makedirs(scene)
        for key, value in assets.items():
            np.save(os.path.join(scene, f"{key}.npy"), value)
    return 2 * n_voxels + 1

TEST_CONFIG = """# The flagship config file plus the tester and its data: test= and
# data.test= of configs/scannet/lang-pretrain-scannet-mcmc-wo-normal-contrastive.py
# with the fragment test pipeline of configs/_base_/gs_pipelines.py (loaded
# by path). is_train=False, as the flagship file's validation sets have it,
# loads the evaluation point cloud, so the tester votes onto it.
import importlib.util

_base_ = [{flagship!r}]
_spec = importlib.util.spec_from_file_location("gs_pipelines", {pipelines!r})
_gp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gp)
del _spec

_gs_keys = ("coord", "color", "opacity", "quat", "scale", "segment",
            "lang_feat", "valid_feat_mask")
_test_transform, _test_cfg = _gp.lang_test_transform_and_cfg(_gs_keys)

data = dict(
    test=dict(
        type="ScanNet200GSDataset",
        split="val",
        data_root={data_root!r},
        is_train=False,
        transform=_test_transform,
        test_mode=True,
        test_cfg=_test_cfg,
    ),
)

test = dict(
    type="ZeroShotSemSegTester",
    class_names={meta_root!r} + "/scannet200_labels.txt",
    text_embeddings={meta_root!r} + "/scannet200_text_embeddings_siglip2.pt",
    excluded_classes=["wall", "floor", "ceiling"],
    enable_voting=True,
    vote_k=25,
    confidence_threshold=0.1,
)
"""


def forward_sort_sizes(backbone, n_points):
    """Row lengths of the 8 sorts of one forward of ``n_points`` through the
    FeatureExtractor: the bucket (4 curves, then the stem's conv plan) and
    each pooled stage's capacity (its 3 re-sorted curves, then its conv
    plan). Returns [(rows, length), ...]."""
    n0 = bucket_size(n_points, max(backbone["enc_patch_size"]))
    curves = len(backbone["order"])
    sizes = [(curves, n0), (1, n0)]
    for s, frac in enumerate(backbone["stage_capacity"]):
        cap = _round_capacity(n0, frac, backbone["enc_patch_size"][s + 1])
        sizes += [(curves - 1, cap), (1, cap)]
    return sizes


class WindowCalls:
    """Records (N, valid count of each batch row, K, C, H) of the first
    ``limit`` K1 calls on the card at windows of at most ``max_window``
    slots (by default FWD_SMALL_MAX: the decoder's) while it is entered,
    then passes each call on unchanged. A CPU forward in another thread
    (cls_agree's witness) is not recorded."""

    def __init__(self, limit, max_window=fwa.FWD_SMALL_MAX):
        self.limit, self.max_window, self.calls = limit, max_window, []

    def __enter__(self):
        real = self.real = window_attention_module.flash_window_attention

        def recording(qkv, valid, patch_size, num_heads, scale=None):
            if len(self.calls) < self.limit and patch_size <= self.max_window and qkv.is_cuda:
                self.calls.append((qkv.shape[1], tuple(valid.sum(1).tolist()), patch_size,
                                   qkv.shape[3], num_heads))
            return real(qkv, valid, patch_size, num_heads, scale)

        window_attention_module.flash_window_attention = recording
        return self

    def __exit__(self, *exc):
        window_attention_module.flash_window_attention = self.real

    def shapes(self):
        """(N, valids, K, C, H, calls) of each distinct call, in call order."""
        order = list(dict.fromkeys(self.calls))
        return [(*call, self.calls.count(call)) for call in order]


# the test phases' test-time views: of the semseg file's 9 (semseg_tta: 4
# rotations at each of 2 scales, then a flip), the first rotation and the
# flip
TEST_VIEWS = (0, -1)


def test_views(augs):
    """TEST_VIEWS of a test_cfg's ``aug_transform``, as plain lists and
    dicts."""
    return json.loads(json.dumps([augs[i] for i in TEST_VIEWS]))


def views_option(config_path):
    """The test entry's option that keeps TEST_VIEWS of the config file's
    test-time views."""
    augs = Config.fromfile(config_path).data.test.test_cfg.aug_transform
    return f"data.test.test_cfg.aug_transform={test_views(augs)!r}"


def run_test_entry(work, prefix, args, calls):
    """The test entry point's main with ``args`` three times: sort switch
    off and on under deterministic algorithms, whose predictions and
    metrics the caller holds equal, then off as a user runs it (no
    deterministic mode), whose times are the ones to quote per scene.
    ``calls`` (a WindowCalls) records K1's calls in the first run. Returns
    each run ("off", "on", "timed"): its results, scene log, predictions by
    scene, seconds, K3 sort calls and kernel launches, K1 launches and K1
    launches by variant."""
    runs = {}
    try:
        for name, switch, deterministic in (("off", False, True), ("on", True, True),
                                            ("timed", False, False)):
            # scatter-adds of the pooling sum in an order that changes from
            # run to run, and a last-bit difference can flip an argmax: the
            # two runs that are compared use the deterministic forms
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            save = os.path.join(work, f"{prefix}_{name}")
            bs.bitonic_sort.launches = bs.bitonic_sort.kernel_launches = 0
            reset_k1_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_args = args + [f"test.save_path={save}", f"bitonic_sort={switch}"]
            with calls if name == "off" else contextlib.nullcontext():
                (res,) = test_entry.main(run_args)
            seconds = time.perf_counter() - t1
            with open(os.path.join(save, "scene_log.json")) as f:
                scenes = json.load(f)
            runs[name] = dict(
                res=res, scenes=scenes, seconds=seconds,
                preds={sc["name"]: np.load(os.path.join(save, f"{sc['name']}_pred.npy"))
                       for sc in scenes},
                sort_calls=bs.bitonic_sort.launches, sort_kernels=bs.bitonic_sort.kernel_launches,
                k1=fwa.flash_window_attention.launches, k1_variants=k1_variants())
    finally:
        torch.use_deterministic_algorithms(False)
        sort_switch(False)
    return runs


def check_test_runs(phase, runs, n_scenes, n_points, backbone):
    """What both test phases hold of run_test_entry's runs: every scene of
    ``n_points`` predicted in each run, equal predictions and metrics with
    the sort switch off and on, K3 launched only with the switch on and
    then for every sort of every fragment forward (reckoned from the
    fragments' sizes), and K1 once a block in every fragment forward, the
    encoder's on bf16_large and the decoder's windows of 48 on bf16_small.
    Returns the fragments' point counts and each fragment forward's sort
    sizes."""
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    check(len(off["preds"]) == n_scenes
          and sorted(off["preds"]) == sorted(on["preds"]) == sorted(timed["preds"]),
          f"{phase}: predicted scenes {sorted(off['preds'])}, {sorted(on['preds'])} and "
          f"{sorted(timed['preds'])}")
    for sc in on["scenes"]:
        check(sc["points"] == n_points, f"{phase}: scene {sc['name']} has {sc['points']} points")
    for key, pred in off["preds"].items():
        check(pred.ndim == 1, f"{phase}: {key} predictions of shape {pred.shape}")
        check(np.array_equal(pred, on["preds"][key]),
              f"{phase}: {key}: predictions differ with the sort switch on")
    for key, value in off["res"].items():
        check(np.array_equal(value, on["res"][key]),
              f"{phase}: metric {key} differs with the sort switch on")
    fragment_points = [p for sc in on["scenes"] for p in sc["fragment_points"]]
    fragments = len(fragment_points)
    # the sorts of each fragment forward: the bucket's curves and conv plan,
    # and each pooled stage's
    sizes = [forward_sort_sizes(backbone, p) for p in fragment_points]
    want_calls = sum(len(sz) for sz in sizes)
    want_kernels = sum(bs.kernel_launches(length) for sz in sizes for _, length in sz)
    check(off["sort_calls"] == off["sort_kernels"] == timed["sort_calls"] == 0,
          f"{phase}: K3 launched with the sort switch off")
    check(on["sort_calls"] == want_calls and on["sort_kernels"] == want_kernels,
          f"{phase}: K3 {on['sort_calls']} sorts and {on['sort_kernels']} kernels, reckoned "
          f"{want_calls} and {want_kernels}")
    enc, dec = depth_split(backbone)
    for name, run in runs.items():
        got = {v: n for v, n in run["k1_variants"].items() if n}
        check(run["k1"] == (enc + dec) * fragments
              and got == dict(bf16_large=enc * fragments, bf16_small=dec * fragments),
              f"{phase}: run {name}: K1 launches {run['k1']} {got} in {fragments} fragment "
              f"forwards, expected {enc} bf16_large and {dec} bf16_small each")
    return fragment_points, sizes


def scene_split(run):
    """Each scene's points, fragments and seconds (fetch, extract, score
    where the tester scores, vote, total) from a run's scene log."""
    keys = ("fetch_s", "extract_s", "score_s", "vote_s", "total_s")
    return [dict(name=sc["name"], points=sc["points"], fragments=sc["fragments"],
                 fragment_points=sc["fragment_points"], **{k: sc[k] for k in keys if k in sc})
            for sc in run["scenes"]]


def phase_test(work, checkpoint, meta_root, n_voxels=160000, n_scenes=2):
    """The zero-shot test entry point on the flagship file's tester, three
    times through run_test_entry. Returns the K3 counts of the run with the
    switch on, its fragment forwards, the sort sizes of one, K1's variant
    launches in that run and the shapes of the decoder's K1 calls in the
    first fragment forward."""
    t0 = time.perf_counter()
    data_root = os.path.join(work, "scannet_test")
    n_points = write_test_scenes(data_root, n_scenes, n_voxels, seed=12)
    cfg_file = os.path.join(work, "flagship_test.py")
    with open(cfg_file, "w") as f:
        f.write(TEST_CONFIG.format(flagship=os.path.abspath(FLAGSHIP_CONFIG),
                                   pipelines=os.path.abspath(PIPELINES),
                                   data_root=data_root, meta_root=meta_root))
    write_s = time.perf_counter() - t0
    backbone = Config.fromfile(cfg_file).model.backbone
    enc, dec = depth_split(backbone)
    # the compared run's decoder call shapes, for timing_test
    small_calls = WindowCalls(limit=dec)
    runs = run_test_entry(work, "test", ["--config-file", cfg_file, "--options",
                                         f"weight={checkpoint}"], small_calls)
    fragment_points, sizes = check_test_runs("test", runs, n_scenes, n_points, backbone)
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    fragments = len(fragment_points)
    for s in on["scenes"]:
        check(s["fragments"] >= 2 and min(s["fragment_points"]) >= 150000,
              f"scene {s['name']}: {s['fragments']} fragments of {s['fragment_points']}")
    for name, pred in off["preds"].items():  # voted onto the evaluation cloud
        check(len(pred) > 50000, f"{name}: shape {pred.shape}")
    check(all(np.isfinite(off["res"][k]) for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")),
          "non-finite metrics")
    check(len(small_calls.calls) == dec and all(k == 48 for _, _, k, _, _ in small_calls.calls),
          f"the first fragment's decoder calls: {small_calls.calls}")
    agreement = float(np.mean([np.mean(pred == timed["preds"][name])
                               for name, pred in off["preds"].items()]))

    # the voting's neighbour search alone, at the last scene's sizes
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 6, (int(0.9 * n_points), 3)).astype(np.float32)
    query = rng.uniform(0, 6, (100000, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    knn(data, query, 25, device="cuda")
    knn_s = time.perf_counter() - t1

    record = dict(
        phase="test", dtype="bfloat16", scenes=n_scenes, points_per_scene=n_points,
        fragments=fragments, dataset_write_s=write_s, sort_sizes=sizes[0],
        switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                        per_scene=scene_split(off), k1_launches=off["k1"],
                        sort_calls=off["sort_calls"]),
        switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                       per_scene=scene_split(on), k1_launches=on["k1"],
                       k1_variant_launches=on["k1_variants"],
                       sort_calls=on["sort_calls"], sort_kernel_launches=on["sort_kernels"]),
        as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                               seconds=timed["seconds"], per_scene=scene_split(timed),
                               k1_launches=timed["k1"],
                               predictions_equal_to_deterministic_run=agreement,
                               metrics={k: timed["res"][k]
                                        for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")}),
        predictions_equal=True, metrics_equal=True,
        metrics={k: off["res"][k] for k in ("mIoU", "fg_mIoU", "mAcc", "fg_mAcc", "allAcc")},
        classes_predicted=int(len(np.unique(np.concatenate(list(off["preds"].values()))))),
        knn_s=knn_s, knn_data=len(data), knn_queries=len(query))
    record["decoder_k1_calls_first_fragment"] = small_calls.shapes()
    emit(record)
    return (on["sort_calls"], on["sort_kernels"], fragments, sizes[0], on["k1_variants"],
            small_calls.shapes())

def phase_timing_sort(sizes, phase="timing_sort"):
    """At the 8 sort shapes of one fragment forward: sort_int64 with the
    switch on (K3's int64 entry, as the sort sites call it), the plain
    version and torch.sort(stable=True) on the int64 codes, by CUDA events;
    the bound is every operand read once and written once at the memory
    rate."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, worst = [], 0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, kernel_launches=0)
    for b, n in sizes:
        code = torch.randint(0, 1 << 30, (b, n), generator=gen, device="cuda")
        code[:, -(n // 5):] = SENTINEL  # padding slots
        halves = code.view(torch.int32).view(b, n, 2)
        ops = (halves[..., 1].contiguous(), halves[..., 0].contiguous(),
               torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n).contiguous())
        sort_switch(True)
        try:
            got = bs.sort_int64(code)
            ms = cuda_ms(lambda: bs.sort_int64(code), reps=20)
        finally:
            sort_switch(False)
        hi, lo, idx = bs.bitonic_sort_reference(ops, 3)
        ref = ((hi.long() << 32) | (lo.long() & 0xFFFFFFFF), idx.long())
        want = torch.sort(code, dim=-1, stable=True)
        torch.cuda.synchronize()
        worst = max(worst, sort_max_abs_diff(got, ref))
        check(all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"K3 differs from its plain version at {(b, n)}")
        check(torch.equal(got[0], want.values) and torch.equal(got[1], want.indices),
              f"K3 differs from the stable torch.sort at {(b, n)}")
        row = dict(
            ms=ms,
            plain_ms=cuda_ms(lambda: bs.bitonic_sort_reference(ops, 3), reps=2, warmup=1),
            library_ms=cuda_ms(lambda: torch.sort(code, dim=-1, stable=True), reps=20),
            bound_ms=2 * 3 * 4 * b * n / PEAK_BYTES * 1e3)
        rows.append(dict(B=b, n=n, padded=bs.padded_length(n),
                         kernel_launches=bs.kernel_launches(n), **row))
        for key, val in row.items():
            tot[key] += val
        tot["kernel_launches"] += bs.kernel_launches(n)
    tot["max_abs_err"] = worst
    emit(dict(phase=phase, operands=3, num_keys=3, entry="sort_int64, switch on",
              per_call=rows, per_forward=tot))
    return tot


def phase_timing_test(shapes, phase="timing_test"):
    """At the shapes and valid counts of K1's calls in one test fragment
    forward (the flagship's: the decoder's, windows of 48 on bf16_small; the
    semseg file's: every call), without lse: the kernel against its plain
    version (bf16 noise-floor rule, zeros where slot 0 is padding), then the
    kernel's, the plain version's and the library's times per call and per
    fragment forward, with the bound, in all and for each variant."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, worst = [], 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    by_variant = {}
    for n, valids, k, c, h, count in shapes:
        b, d = len(valids), c // h
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        dead = torch.zeros_like(valid)
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
            dead[i, -(-nv // k) * k:] = True
        variant = fwa.forward_variant(qkv.dtype, k, d)
        out = fwa.flash_window_attention(qkv, valid, k, h)
        torch.cuda.synchronize()
        check((out[dead] == 0).all().item(), f"padded windows not zero at {n, valids, k, c, h}")
        err16, floor16 = check_bf16(qkv, valid, k, h, out=out)
        plain16 = fwa.flash_window_attention_plain(qkv, valid, k, h, patch_chunk=16384 // k)
        worst = max(worst, (out.float() - plain16.float())[valid].abs().max().item())
        ms = cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps=10)
        plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                           **PLAIN_REPS)
        p = -(-n // k)
        pad = p * k - n
        qkv_w = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
        valid_w = torch.nn.functional.pad(valid, (0, pad))
        q, kk, v = qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid_w.view(b * p, 1, 1, k)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps=10)
        ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms)
        rows.append(dict(N=n, valid=list(valids), K=k, C=c, H=h, launches=count,
                         variant=variant, **row, bound_ms=max(ops_ms, bytes_ms),
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        part = by_variant.setdefault(variant, dict.fromkeys(row, 0.0))
        for key, val in row.items():
            tot[key] += count * val
            part[key] += count * val
        del qkv, qkv_w, q, kk, v, out, plain16
    tot["max_abs_err"] = worst  # against the plain bf16 version
    for part in [tot] + list(by_variant.values()):
        part["bound_ms"] = max(part["ops_ms"], part["bytes_ms"])
        part["bound_by"] = "operations" if part["ops_ms"] >= part["bytes_ms"] else "bytes"
    tot["by_variant"] = by_variant
    emit(dict(phase=phase, dtype="bfloat16", lse=False, per_call=rows,
              per_fragment_forward=tot))
    return tot


def semseg_train_config(root, exp, batch_size, steps, scenes):
    """The ScanNet-20 semseg file as it is, its hooks included, with the
    data roots (train, val and the post-training test all under ``root``),
    epoch 1, the batch size, and a train loop that gives ``steps`` steps
    over ``scenes`` scenes (Mix3D: two samples a batch slot). The
    post-training tester writes its scene log under ``exp``."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    samples = steps * batch_size * (2 if cfg.mix_prob > 0 else 1)
    check(samples % scenes == 0, f"{samples} samples over {scenes} scenes")
    cfg.data.train.update(data_root=root, loop=samples // scenes)
    cfg.data.val.data_root = cfg.data.test.data_root = root
    cfg.test["save_path"] = os.path.join(exp, "precise_test")
    return cfg


def phase_semseg_train(work, weight, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6),
                       val_points=40000):
    """The semseg trainer on configs/scannet/semseg-gs-scannet-all-w-normal-
    fixed-xyz.py as it is (widths, 205,824 points, losses, optimizer,
    schedule, transforms, Mix3D 0.8 and its own hooks) at batch 2 for
    ``steps`` steps over 4 synthetic ScanNet-layout scenes with normals and
    20 classes, and one validation scene, which PreciseEvaluator's
    SemSegTester also runs after training with the file's 9 views; started
    from ``weight`` (the SSL teacher's backbone that warm_start extracted)
    through the file's CheckpointLoader, whose load WarmStartProbe checks.
    Returns the train-step stage shapes, the K1 / K2 launch counts and the
    best checkpoint, copied into ``work``."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "scannet_gs")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=21, size_m=room,
                        semseg=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=22,
                        size_m=(2.4, 2.4, 2.0), semseg=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        reset_k2_counts()
        cfg = semseg_train_config(root, os.path.join(tmp, "exp"), 2, steps, 4)
        cfg.weight = weight
        source = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
        warm = WarmStartProbe(source)
        trainer, probe, records, k1_counts = run_training(cfg, before=warm.insert)
        check(warm.record is not None, "semseg: the warm start was not checked")
        check(warm.record["kept"] == [STEM, "seg_head.bias", "seg_head.weight"]
              and warm.record["skipped"] == [STEM],
              f"semseg: from the teacher, kept {warm.record['kept']}, skipped "
              f"{warm.record['skipped']}: expected the stem (11 vs 14 channels) and seg_head")
        emit(dict(phase="warm_start_semseg_train", weight="ssl_train's teacher, extracted",
                  **warm.record))
        backbone = trainer.cfg.model.backbone
        enc, dec = depth_split(backbone)
        blocks = enc + dec  # 22
        k1, k1_val = k1_counts["train_launches"], k1_counts["val_launches"]
        k2 = fwa.flash_window_attention_bwd.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        n_steps = len(losses)
        check(n_steps == steps, f"semseg: {n_steps} train steps, expected {steps}")
        check(all(math.isfinite(v) for v in losses + grad_norms),
              f"semseg: non-finite loss or grad_norm: {losses} {grad_norms}")
        check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
              and k2 == blocks * steps,
              f"semseg: {k1} forward and {k2} backward kernel launches in {steps} steps, "
              f"expected {blocks} each per step")
        k2_variants = fwa.flash_window_attention_bwd.variant_launches
        check(k2_variants == dict(k2_variants, bf16_small=dec * steps, bf16_large=enc * steps),
              f"semseg: backward variant launches {k2_variants}, expected {dec} bf16_small "
              f"(windows of 48) and {enc} bf16_large (windows of 1024) a step")
        got = {v: n for v, n in k1_counts["train_variants"].items() if n}
        check(got == dict(bf16_large=enc * steps, bf16_small=dec * steps),
              f"semseg: train K1 variant launches {got}, expected {enc} bf16_large and "
              f"{dec} bf16_small a step")
        # after training: one validation forward (the evaluator), then the
        # PreciseEvaluator's tester, one forward a fragment
        precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
        check(len(precise) == 1 and len(precise[0].results) == 1,
              "semseg: PreciseEvaluator did not run the file's tester")
        with open(os.path.join(cfg.test.save_path, "scene_log.json")) as f:
            test_fragments = sum(sc["fragments"] for sc in json.load(f))
        val_forwards = k1_counts["val_forwards"]
        check(val_forwards == 1 + test_fragments and k1_val == blocks * val_forwards,
              f"semseg: {k1_val} K1 launches in {val_forwards} evaluation forwards, expected "
              f"{blocks} in each of 1 validation and {test_fragments} test fragments")
        got = {v: n for v, n in k1_counts["val_variants"].items() if n}
        check(got == dict(bf16_large=enc * val_forwards, bf16_small=dec * val_forwards),
              f"semseg: evaluation K1 variant launches {got}")
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        check(not any(map(any, overflow)) and not any(k1_counts["val_overflow"]),
              f"semseg: pooling overflow {overflow} {k1_counts['val_overflow']}")
        miou = hist("val/mIoU").values()
        check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"semseg: val/mIoU {miou}")
        check(trainer.comm_info.get("current_metric_name") == "mIoU",
              "semseg: the evaluator set no checkpoint metric")
        test_miou = precise[0].results[0]["mIoU"]
        check(math.isfinite(test_miou), f"semseg: test mIoU {test_miou}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        check(os.path.exists(os.path.join(model_dir, "model_best.pth")),
              "semseg: no model_best.pth")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                 os.path.join(work, "semseg_model_best.pth"))
        sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
        emit(dict(phase="semseg_train", config=SEMSEG_CONFIG, batch_size=2,
                  points=cfg.data.num_points, steps=n_steps, loss=losses, grad_norm=grad_norms,
                  lr=hist("lr").values(), cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=peak_gib, val_miou=miou[0], precise_test_miou=test_miou,
                  precise_test_fragments=test_fragments,
                  k1_launches_per_step=k1 / steps, k2_launches_per_step=k2 / steps,
                  k1_variant_launches=k1_counts["train_variants"],
                  k2_variant_launches=dict(k2_variants),
                  evaluation_forwards=val_forwards, evaluation_k1_launches=k1_val,
                  evaluation_k1_variant_launches=k1_counts["val_variants"],
                  n_overflow_per_stage=overflow, evaluation_n_overflow=k1_counts["val_overflow"],
                  stage_slots_valid=sizes[-1], dataset_write_s=data_s, profile=probe.profile))
        print(f"semseg_train: val/mIoU {miou[0]:.4f} (after {n_steps} steps)", flush=True)
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    variants = dict(train=k1_counts["train_variants"], evaluation=k1_counts["val_variants"])
    return shapes, k1, variants, dict(k2_variants), checkpoint


def semseg_rows(n, seeds, size_m=(2.4, 2.4, 2.4)):
    """One semseg batch row of ``n`` points per seed: a room (of ``size_m``)
    whose 4 cm cells fit the first pooling (see train_agree), 14 input
    channels (the Gaussian features and the shell's normals), 20 classes by
    angle and height, 5% ignored; numpy arrays [rows, n, ...]."""
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coord, feat_in, grid = room_scene(rng, n, size_m)
        normal = shell_normals(grid, [int(round(m / GRID)) for m in size_m], 1)
        angle = np.arctan2(coord[:, 1] - size_m[1] / 2, coord[:, 0] - size_m[0] / 2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = seg + 10 * (coord[:, 2] > 1.0)
        seg[rng.random(n) < 0.05] = -1  # ignored points
        rows.append(dict(coord=coord, feat=np.concatenate([feat_in, normal], 1).astype(
            np.float32), grid_coord=grid, mask=np.ones(n, bool), segment=seg))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def phase_semseg_agree(n=49152):
    """One fp32 train step of the semseg file's model at one block a stage
    (its widths, heads and windows kept) and ``n`` points, CE + Lovasz, with
    the kernels and with the plain attention."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4)
    batch = cuda_batch(semseg_rows(n, (13,)))
    model_cfg = dict(cfg.model)
    criteria = build_criteria(model_cfg.pop("criteria"))

    def step(use_kernel):
        model = build_model(dict(model_cfg, backbone=dict(
            backbone, dtype="float32", seed=1, use_kernel=use_kernel)))
        model = model.cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(12)
        loss, out = semseg_loss(model, criteria, batch, gen)
        loss.backward()
        return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                [int(p.n_overflow.max()) for p in out.plans])

    compare_train_steps("semseg_agree", step, sum(depth_split(backbone)), points=n,
                        config=SEMSEG_CONFIG, enc_depths=backbone["enc_depths"],
                        dec_depths=backbone["dec_depths"], criteria=[
                            c["type"] for c in cfg.model.criteria])


def phase_semseg_test(work, checkpoint, n_voxels=160000, n_scenes=2):
    """``python -m scenesplat_tpu_torch.test`` on the semseg file as it is
    (SemSegTester with TEST_VIEWS of the file's test-time views and
    fragment voting, bf16) with the semseg_train checkpoint, three times through
    run_test_entry; the per-scene seconds (fetch, extract, vote) of the run
    as a user makes it are the ones to quote. Returns K3's and K1's counts
    of the K3 run, the fragments, the sort sizes of the first fragment
    forward and the shapes of K1's calls in it."""
    t0 = time.perf_counter()
    data_root = os.path.join(work, "semseg_test")
    n_points = write_test_scenes(data_root, n_scenes, n_voxels, seed=23, semseg=True)
    write_s = time.perf_counter() - t0
    backbone = Config.fromfile(SEMSEG_CONFIG).model.backbone
    blocks = sum(depth_split(backbone))
    calls = WindowCalls(limit=blocks, max_window=max(backbone["enc_patch_size"]))
    runs = run_test_entry(work, "semseg_test", [
        "--config-file", SEMSEG_CONFIG, "--options", f"weight={checkpoint}",
        f"data.test.data_root={data_root}", views_option(SEMSEG_CONFIG)], calls)
    fragment_points, sizes = check_test_runs("semseg_test", runs, n_scenes, n_points, backbone)
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    for sc in on["scenes"]:
        check(sc["fragments"] >= len(TEST_VIEWS), f"semseg_test: scene {sc['name']}: "
              f"{sc['fragments']} fragments for {len(TEST_VIEWS)} views")
    for key, pred in off["preds"].items():
        check(len(pred) == n_points, f"semseg_test: {key} {pred.shape}")
    check(np.isfinite(off["res"]["mIoU"]), f"semseg_test: mIoU {off['res']['mIoU']}")
    check(len(calls.calls) == blocks, f"semseg_test: first fragment's K1 calls {calls.calls}")
    emit(dict(phase="semseg_test", config=SEMSEG_CONFIG, dtype="bfloat16", scenes=n_scenes,
              points_per_scene=n_points, views=len(TEST_VIEWS), fragments=len(fragment_points),
              dataset_write_s=write_s,
              switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                              per_scene=scene_split(off), k1_launches=off["k1"]),
              switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                             per_scene=scene_split(on), k1_launches=on["k1"],
                             k1_variant_launches=on["k1_variants"], sort_calls=on["sort_calls"],
                             sort_kernel_launches=on["sort_kernels"]),
              as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                                     seconds=timed["seconds"], per_scene=scene_split(timed),
                                     mIoU=timed["res"]["mIoU"]),
              predictions_equal=True, mIoU=off["res"]["mIoU"],
              iou_per_class=off["res"]["iou_per_class"].tolist(),
              k1_calls_first_fragment=calls.shapes()))
    for sc in scene_split(timed):
        print(f"semseg_test: {sc['name']} {sc['points']} points, {sc['fragments']} fragments: "
              f"fetch {sc['fetch_s']:.2f} s, extract {sc['extract_s']:.2f} s, vote "
              f"{sc['vote_s']:.2f} s, total {sc['total_s']:.2f} s", flush=True)
    return on, len(fragment_points), sizes[0], calls.shapes()

def ssl_train_config(root, exp, batch_size, steps, scenes):
    """The ScanNet SSL file as it is, its hooks included, with the data
    root, epoch 1, the batch size and a train loop that gives ``steps``
    steps over ``scenes`` scenes."""
    cfg = Config.fromfile(SSL_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    samples = steps * batch_size
    check(samples % scenes == 0, f"{samples} samples over {scenes} scenes")
    cfg.data.train.update(data_root=root, loop=samples // scenes)
    return cfg


def record_passes(model):
    """Wraps the SSL model's student and teacher backbones: for each, the
    forwards, K1's launches of each variant inside them with and without the
    log-sum-exp, and per forward the pooling overflow and (slots, valid
    count) of each stage, kept as tensors (no host sync in the step)."""
    rec = {}
    for name, module in (("student", model.backbone), ("teacher", model.teacher)):
        r = rec[name] = dict(forwards=0, variants=dict.fromkeys(fwa.VARIANTS, 0),
                             lse_variants=dict.fromkeys(fwa.VARIANTS, 0), passes=[])

        def recording(point, generator=None, token_mask=None, return_enc=False,
                      _forward=module.forward, _r=r):
            before, before_lse = k1_variants(), k1_lse_variants()
            out = _forward(point, generator=generator, token_mask=token_mask,
                           return_enc=return_enc)
            _r["forwards"] += 1
            for v, n in k1_variants().items():
                _r["variants"][v] += n - before[v]
            for v, n in k1_lse_variants().items():
                _r["lse_variants"][v] += n - before_lse[v]
            dec = out[0] if return_enc else out
            _r["passes"].append(dict(
                masked=token_mask is not None, overflow=[p.n_overflow for p in dec.plans],
                clusters=[p.n_clusters for p in dec.plans],
                sizes=[(point.mask.shape[1], point.mask.sum(1))]
                + [(p.out_mask.shape[1], p.out_mask.sum(1)) for p in dec.plans]))
            return out

        module.forward = recording
    return rec


class EmaProbe(HookBase):
    """Holds the teacher to its EMA at every step: one teacher parameter
    after the step must equal m t + (1 - m) s, t its value before the step,
    s the student's after the optimizer step, m the step's momentum, within
    four fp32 roundings of |m t| + |(1 - m) s|; the teacher's mask token
    must never move."""

    PARAM = "enc.enc4.block1.attn.qkv.weight"

    def before_train(self):
        self.token = self.trainer.model.teacher.mask_token.detach().clone()
        self.errors = []

    def before_step(self):
        self.m = np.float32(self.trainer.momentum_schedule(self.trainer.storage.iter))
        self.t = self.trainer.model.teacher.get_parameter(self.PARAM).detach().clone()

    def after_step(self):
        model = self.trainer.model
        s = model.backbone.get_parameter(self.PARAM).detach()
        got = model.teacher.get_parameter(self.PARAM).detach()
        a, b = self.t * float(self.m), s * float(np.float32(1) - self.m)
        err = (got - (a + b)).abs()
        tol = 4 * torch.finfo(torch.float32).eps * (a.abs() + b.abs()) + 1e-30
        self.errors.append(dict(momentum=float(self.m), max_abs_err=err.max().item(),
                                worst_err_over_tol=(err / tol).max().item(),
                                moved=(got != self.t).any().item()))
        check((err <= tol).all().item(), f"ssl: teacher {self.PARAM} is not m t + (1 - m) s "
              f"at step {self.trainer.storage.iter}: {self.errors[-1]}")
        check(torch.equal(model.teacher.mask_token, self.token),
              "ssl: the teacher's mask token moved")


def ssl_stage_shapes(backbone, student, local_crop_num):
    """The timing phase's shapes from one step's student passes: the first
    global crop's stages for both globals (forward with lse and backward
    twice), the first local crop's for every local (the encoder forward and
    backward, the decoder forward only: its output takes no gradient)."""
    g0, _, local = student["passes"][-(2 + local_crop_num):][:3]  # the last step's
    check(g0["masked"] and not local["masked"], "ssl: the student's passes out of order")
    shapes = []
    for record, count, dec_bwd in ((g0, 2, 2), (local, local_crop_num, 0)):
        sizes = [(n, v.tolist()) for n, v in record["sizes"]]
        stages = stage_shapes(backbone, sizes)
        enc = len(sizes)
        shapes += [sh[:5] + (sh[5] * count, sh[5] * (count if i < enc else dec_bwd))
                   for i, sh in enumerate(stages)]
    return shapes


def phase_ssl_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6), rooms=4):
    """The SSL trainer on configs/scannet/ssl-pretrain-scannet-all-base.py as
    it is (SimDINOSSL at the shipped widths: 5 stages, windows of 1024 in
    the encoder, 48 in the decoder, 3 local crops, patch masks, MAE; AdamW,
    OneCycle, the EMA teacher, the multi-crop transforms with the voxel
    blur, 102,400 / 25,600 points a global / local crop, its own hooks) at
    batch 2 for ``steps`` steps over ``rooms`` synthetic unlabeled rooms of
    ``scene_points`` 2 cm voxels (2 samples a step: steps * 2 must split
    over the rooms). Returns the timing phase's shapes and the
    launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "ssl_gs")
        write_gs_scenes(os.path.join(root, "train"), rooms, scene_points, seed=31, size_m=room,
                        semseg=True)
        data_s = time.perf_counter() - t0
        batch = 2  # the reference's 8 a card cut to 2
        reset_k1_counts()
        reset_k2_counts()
        cfg = ssl_train_config(root, os.path.join(tmp, "exp"), batch, steps, rooms)
        trainer = build_trainer(cfg, device="cuda")
        probe, ema = StepProbe(profile_step=steps - 1), EmaProbe()
        for hook in (probe, ema):
            hook.trainer = trainer
            trainer.hooks.append(hook)
        passes = record_passes(trainer.model)
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        backbone = trainer.cfg.model.backbone
        locals_ = trainer.loss_kwargs["local_crop_num"]
        enc, dec = depth_split(backbone)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        terms = ("loss", "grad_norm", "mcr_comp_loss", "mcr_expa_loss", "sim_dino_crops_loss",
                 "sim_ibot_patch_loss", "global_mae_loss")
        logged = {k: hist(k).values() for k in terms}
        check(all(len(v) == steps for v in logged.values()),
              f"ssl: {[len(v) for v in logged.values()]} logged steps, expected {steps}")
        check(all(math.isfinite(x) for v in logged.values() for x in v),
              f"ssl: non-finite loss terms {logged}")
        student, teacher = passes["student"], passes["teacher"]
        check(student["forwards"] == (2 + locals_) * steps and teacher["forwards"] == 2 * steps,
              f"ssl: {student['forwards']} student and {teacher['forwards']} teacher forwards "
              f"in {steps} steps")
        # K1: every student pass records a graph (lse), the teacher's none;
        # the encoder's windows of 1024 on bf16_large, the decoder's 48 on
        # bf16_small
        for name, r, forwards, lse in (("student", student, (2 + locals_) * steps, True),
                                       ("teacher", teacher, 2 * steps, False)):
            got = {v: n for v, n in r["variants"].items() if n}
            want = dict(bf16_large=enc * forwards, bf16_small=dec * forwards)
            check(got == want, f"ssl: {name} K1 variant launches {got}, expected {want}")
            got_lse = {v: n for v, n in r["lse_variants"].items() if n}
            check(got_lse == (want if lse else {}),
                  f"ssl: {name} K1 launches with lse {got_lse}")
        k1 = fwa.flash_window_attention.launches
        check(k1 == (enc + dec) * (4 + locals_) * steps,
              f"ssl: K1 launched {k1} times, not all inside the backbones' forwards")
        # K2: the globals' encoder and decoder, the locals' encoder (their
        # decoder output takes no gradient)
        k2_variants = fwa.flash_window_attention_bwd.variant_launches
        k2_want = dict(bf16_large=enc * (2 + locals_) * steps, bf16_small=dec * 2 * steps)
        got = {v: n for v, n in k2_variants.items() if n}
        check(got == k2_want, f"ssl: K2 variant launches {got}, expected {k2_want}")
        # pooling overflow: the file's capacities (1/2 to 1/16 of the crop's
        # slots) against the clusters of each crop; the JAX package drops the
        # clusters past them unseen, the port counts them. Per crop kind and
        # stage: the most clusters lost in a row and their share
        overflow = {}
        for r in (student, teacher):
            for p in r["passes"]:
                kind = "global" if p["sizes"][0][0] == cfg.data.num_points else "local"
                rows = overflow.setdefault(kind, [[0, 0.0] for _ in p["overflow"]])
                for stage, (o, c) in enumerate(zip(p["overflow"], p["clusters"])):
                    rows[stage][0] = max(rows[stage][0], int(o.max()))
                    rows[stage][1] = max(rows[stage][1], (o / c.clamp(min=1)).max().item())
        lost = {k: [o for o, _ in v] for k, v in overflow.items()}
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        check(os.path.exists(os.path.join(model_dir, "model_last.pth")),
              "ssl: no checkpoint written")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_last.pth"),
                                 os.path.join(work, "ssl_model_last.pth"))
        last = student["passes"][-(2 + locals_):]
        stage_slots_valid = [[(n, v.tolist()) for n, v in p["sizes"]] for p in last]
        emit(dict(phase="ssl_train", config=SSL_CONFIG, batch_size=batch,
                  batch_cut="the file's batch_size 24 (8 a card x 3 cards) cut to "
                            f"{batch} on one card",
                  global_points=cfg.data.num_points, local_points=cfg.data.num_points_local,
                  local_crop_num=locals_, steps=steps, **logged, lr=hist("lr").values(),
                  momentum=[e["momentum"] for e in ema.errors], ema_check=ema.errors,
                  cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=peak_gib,
                  k1_student_variant_launches=student["variants"],
                  k1_student_lse_variant_launches=student["lse_variants"],
                  k1_teacher_variant_launches=teacher["variants"],
                  k1_teacher_lse_variant_launches=teacher["lse_variants"],
                  k1_launches_per_step=k1 / steps, k2_variant_launches=dict(k2_variants),
                  k2_launches_per_step=sum(k2_variants.values()) / steps,
                  n_overflow_per_stage=lost,
                  overflow_share_per_stage={k: [f for _, f in v] for k, v in overflow.items()},
                  stage_slots_valid_last_step=stage_slots_valid,
                  dataset_write_s=data_s, profile=probe.profile))
        # the one loss the file's capacities are known to take: a crop's 4 cm
        # cells past its first pooling's 1/2 (up to 32% of a local crop's, 1%
        # of a global's; ROADMAP Queue 3); no later stage may lose any
        check(not any(o for v in lost.values() for o in v[1:]),
              f"ssl: pooling overflow beyond the first stage: {lost}")
        warm = step_ms[1:-1] or step_ms
        print(f"ssl_train: loss {logged['loss'][-1]:.4f} after {steps} steps, warm step "
              f"{min(warm):.0f}-{max(warm):.0f} ms, peak {peak_gib:.2f} GiB", flush=True)
        shapes = ssl_stage_shapes(backbone, student, locals_)
        # the teacher's K1 calls, without lse: the last step's first global
        # crop's stages, for both of its passes
        first = teacher["passes"][-2]
        teacher_shapes = [sh[:5] + (2 * sh[5],) for sh in stage_shapes(
            backbone, [(n, v.tolist()) for n, v in first["sizes"]])]
        counts = dict(student_lse=student["lse_variants"], teacher=teacher["variants"],
                      k1=k1, k2=dict(k2_variants), steps=steps)
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, counts, checkpoint, teacher_shapes


def ssl_rows(n, n_local, seed=19):
    """Two rows of the SSL batch: 2 global crops of ``n`` points and 3
    local crops of ``n_local``, each a room small enough that its 4 cm
    cells fit the first pooling; numpy arrays [2, points, ...] under
    ``<crop>_<key>``."""
    rng = np.random.default_rng(seed)
    batch = {}
    for prefix, points, size in (("global_crop0", n, 1.8), ("global_crop1", n, 1.8),
                                 ("local_crop0", n_local, 0.9), ("local_crop1", n_local, 0.9),
                                 ("local_crop2", n_local, 0.9)):
        rows = [room_scene(rng, points, (size,) * 3) for _ in range(2)]
        for i, key in enumerate(("coord", "feat", "grid_coord")):
            batch[f"{prefix}_{key}"] = np.stack([r[i] for r in rows])
        batch[f"{prefix}_mask"] = np.ones((2, points), bool)
    return batch


def phase_ssl_agree(n=24576, n_local=6144):
    """One fp32 SSL loss and its gradients of the SSL file's model at one
    block a stage with mean pooling (its widths, heads and windows kept),
    batch 2, two global crops of ``n`` points with injected token masks and
    three local crops of ``n_local``, with the kernels and with the plain
    attention; each loss term's gradient apart."""
    cfg = Config.fromfile(SSL_CONFIG)
    # mean pooling in place of the file's max: which point is a cluster's
    # max is a discontinuous function of the features, and an attention
    # output a few ulps off flips near-ties, moving some gradients by 1e-3
    # on either path (the kernels' or the plain path's own under one ulp);
    # max pooling runs as the file has it in ssl_train and against JAX in
    # tests/test_torch_ssl.py
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4,
                    pool_reduce="mean")
    batch = cuda_batch(ssl_rows(n, n_local))
    gen = torch.Generator(device="cuda").manual_seed(5)
    for prefix in ("global_crop0", "global_crop1"):
        tm, w = generate_token_masks(gen, batch[f"{prefix}_coord"], batch[f"{prefix}_mask"],
                                     mask_sample_probability=1.0)
        batch[f"{prefix}_token_mask"], batch[f"{prefix}_mask_weight"] = tm, w

    # the expansion term's gradient at the student's DINO heads: each
    # path's own is as ill-conditioned as I + 2560 cov (eigenvalues 1 to
    # about 5,100 at two rows); the first step's is given to both, so what
    # is compared is the heads' and the backbones' backward, where the
    # kernels are
    cotangent = []

    def step(use_kernel):
        model, loss_kwargs = build_ssl_model(dict(cfg.model, backbone=dict(
            backbone, dtype="float32", seed=1, use_kernel=use_kernel)))
        model = model.cuda().train()
        passes = record_passes(model)
        heads, head = [], model.dino_head.forward

        def recording(x):
            y = head(x)
            if torch.is_grad_enabled():  # the student's
                heads.append(y)
            return y

        model.dino_head.forward = recording
        loss, metrics = ssl_loss(model, batch, torch.Generator(device="cuda").manual_seed(13),
                                 **loss_kwargs)
        if not cotangent:
            cotangent.extend(torch.autograd.grad(metrics["mcr_expa_loss"], heads,
                                                 retain_graph=True))
        named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
        grads = {}
        for term, out, cot in (("mcr_comp_loss", metrics["mcr_comp_loss"], None),
                               ("sim_ibot_patch_loss", metrics["sim_ibot_patch_loss"], None),
                               ("global_mae_loss", metrics["global_mae_loss"], None),
                               ("mcr_expa_loss", heads, cotangent)):
            got = torch.autograd.grad(out, [p for _, p in named], grad_outputs=cot,
                                      retain_graph=True, allow_unused=True)
            grads.update({f"{term}/{k}": g for (k, _), g in zip(named, got) if g is not None})
        overflow = [max(int(o.max()) for p in r["passes"] for o in p["overflow"])
                    for r in passes.values()]
        return {k: v.item() for k, v in metrics.items()}, grads, overflow

    enc, dec = depth_split(backbone)
    # K2: the compression's and the expansion's backward each reach the
    # encoders of all five student passes, the iBOT term's the globals'
    # encoders and decoders, the MAE term's the first global's
    compare_train_steps("ssl_agree", step, ((enc + dec) * 7, enc * 5 * 2 + (enc + dec) * 3),
                        points=dict(global_crop=n, local_crop=n_local, batch=2),
                        config=SSL_CONFIG, enc_depths=backbone["enc_depths"],
                        dec_depths=backbone["dec_depths"], token_masks="injected",
                        passes="2 teacher, 2 masked global, 3 local",
                        grads="per term; the expansion's from one cotangent at the heads")
    gc.collect()  # the recorders' closures hold the models in cycles
    torch.cuda.empty_cache()


# ---- pretraining to fine-tuning, data parallel semseg and SSL, remat ----------

STEM = "backbone.embedding.stem.conv.weight"
SSL_DDP_LR = 0.01  # SGD, so a step's student (and the EMA'd teacher) moves smoothly


class LogLines(logging.Handler):
    """The messages a logger emits while the handler is attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def check_warm_start(phase, after, init, source, lines):
    """A non-strict load of ``source`` into a model whose state was ``init``
    and is ``after``: every source tensor whose name and shape the model
    has is loaded bit for bit, every other model tensor kept its
    initialization, and ``lines`` (the loader's log) name each tensor
    skipped and each one kept. Returns the record."""
    loaded = sorted(k for k, v in source.items()
                    if k in after and tuple(v.shape) == tuple(after[k].shape))
    skipped = sorted(k for k in source if k not in set(loaded))
    kept = sorted(k for k in after if k not in set(loaded))
    for k in loaded:
        check(torch.equal(after[k].cpu(), source[k].cpu()), f"{phase}: {k} not loaded bit for bit")
    for k in kept:
        check(torch.equal(after[k].cpu(), init[k].cpu()), f"{phase}: {k} left its initialization")
    text = "\n".join(lines)
    unlogged = [k for k in skipped if f"skipped {k}:" not in text] + [
        k for k in kept if f"kept the initialization of {k}" not in text]
    check(not unlogged, f"{phase}: the log does not name {unlogged[:5]}")
    return dict(loaded=len(loaded), model_tensors=len(after), skipped=skipped, kept=kept)


class WarmStartProbe(HookBase):
    """Inserted right after the trainer's CheckpointLoader: reads the
    model's state after the load (check_warm_start against ``source`` and
    the state the trainer built) and the loader's log lines."""

    def __init__(self, source):
        self.source, self.record = source, None

    def insert(self, trainer):
        self.trainer = trainer
        self.init = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        (i,) = [i for i, h in enumerate(trainer.hooks) if type(h).__name__ == "CheckpointLoader"]
        trainer.hooks.insert(i + 1, self)
        self.log = LogLines()
        trainer.logger.addHandler(self.log)

    def before_train(self):
        self.trainer.logger.removeHandler(self.log)
        after = {k: v.detach().cpu() for k, v in self.trainer.model.state_dict().items()}
        self.record = check_warm_start("warm_start", after, self.init, self.source,
                                       self.log.lines)


def phase_warm_start(work, ssl_checkpoint, flagship_checkpoint):
    """``python -m scenesplat_tpu_torch.rename_ckpt`` on ssl_train's last
    checkpoint (the SSL file at its widths) for the teacher and for the
    student: each output holds that backbone's tensors as ``backbone.*``,
    bit for bit, without the mask token. Then non-strict loads as the
    files' CheckpointLoader makes them: the train phase's flagship
    checkpoint into the semseg file's model and the extracted teacher into
    the flagship file's (every encoder tensor of stages 0-3 loads; the rest
    are skipped or kept, and logged). semseg_train starts from the teacher.
    Returns the teacher's file."""
    from scenesplat_tpu_torch import rename_ckpt
    from scenesplat_tpu_torch.engines.hooks.misc import load_matching

    ssl_state = torch.load(ssl_checkpoint, map_location="cpu", weights_only=False)["state_dict"]
    out, record = {}, dict(phase="warm_start", ssl_checkpoint="ssl_train's model_last.pth")
    for source, prefix in (("teacher", "teacher."), ("student", "backbone.")):
        path = os.path.join(work, f"ssl_{source}_backbone.pth")
        t0 = time.perf_counter()
        check(rename_ckpt.main(["--input", ssl_checkpoint, "--output", path,
                                "--source", source]) == 0, f"warm_start: {source} extraction")
        record[f"{source}_extract_s"] = time.perf_counter() - t0
        got = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
        want = {"backbone." + k[len(prefix):]: v for k, v in ssl_state.items()
                if k.startswith(prefix) and k != prefix + "mask_token"}
        check(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"warm_start: the {source} extraction differs from the checkpoint's {prefix}*")
        record[f"{source}_tensors"] = len(got)
        out[source] = got
    check(any(not torch.equal(v, out["student"][k]) for k, v in out["teacher"].items()),
          "warm_start: the teacher equals the student after ssl_train's steps")
    logger = logging.getLogger("chip_smoke.warm_start")
    logger.setLevel(logging.INFO)
    encoders = tuple(f"backbone.enc.enc{s}." for s in range(4))
    for name, weight, config in (("flagship_to_semseg", flagship_checkpoint, SEMSEG_CONFIG),
                                 ("teacher_to_flagship", os.path.join(
                                     work, "ssl_teacher_backbone.pth"), FLAGSHIP_CONFIG)):
        model_cfg = dict(Config.fromfile(config).model)
        model_cfg.pop("criteria", None)
        model = build_model(model_cfg)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        source = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
        log = LogLines()
        logger.addHandler(log)
        try:
            load_matching(model, source, logger)
        finally:
            logger.removeHandler(log)
        after = model.state_dict()
        rec = check_warm_start(name, after, init, source, log.lines)
        missing = [k for k in after if k.startswith(encoders) and k in rec["kept"]]
        check(not missing, f"{name}: encoder tensors not loaded: {missing[:5]}")
        record[name] = dict(rec, skipped=len(rec["skipped"]), kept=len(rec["kept"]),
                            stem_loaded=STEM not in rec["kept"],
                            first_skipped=rec["skipped"][:8], first_kept=rec["kept"][:8])
        del model
    emit(record)
    return os.path.join(work, "ssl_teacher_backbone.pth")


def semseg_fp32_model(**backbone):
    """The semseg file's DefaultSegmentorV2 at one block a stage (its
    widths, heads, windows and drop-path kept) in fp32 from seed 1, on the
    card in train mode, and the file's criteria (CE + Lovasz)."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    model_cfg = dict(cfg.model)
    criteria = build_criteria(model_cfg.pop("criteria"))
    model = build_model(dict(model_cfg, backbone=dict(
        cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4, dtype="float32", seed=1,
        **backbone)))
    return model.cuda().train(), criteria


def ssl_fp32_model():
    """The SSL file's SimDINOSSL at one block a stage with mean pooling (as
    ssl_agree), drop-path 0.3 as the file sets it, fp32 from seed 1, on the
    card; and the loss's keyword arguments."""
    cfg = Config.fromfile(SSL_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4,
                    pool_reduce="mean", dtype="float32", seed=1)
    model, loss_kwargs = build_ssl_model(dict(cfg.model, backbone=backbone))
    return model.cuda().train(), loss_kwargs, cfg.model.get("momentum_base", 0.994)


def expansion_cotangent(batch):
    """The MCR expansion term's gradient at the student's DINO head outputs
    (one [rows, D] a crop, zeros for the local crops, which it does not
    read) in one process's forward of ssl_fp32_model over ``batch`` with
    the generator ssl_step_fp32 seeds."""
    model, loss_kwargs, _ = ssl_fp32_model()
    heads, head = [], model.dino_head.forward

    def recording(x):
        y = head(x)
        if torch.is_grad_enabled():  # the student's
            heads.append(y)
        return y

    model.dino_head.forward = recording
    _, metrics = ssl_loss(model, batch, torch.Generator(device="cuda").manual_seed(13),
                          **loss_kwargs)
    got = torch.autograd.grad(metrics["mcr_expa_loss"], heads, allow_unused=True)
    return [torch.zeros_like(h) if g is None else g.detach() for h, g in zip(heads, got)]


@contextlib.contextmanager
def given_expansion_cotangent(cotangent):
    """The SSL loss's MCR with the expansion term's backward replaced by
    ``cotangent`` (expansion_cotangent's, rows of the global batch; each
    process takes its rows): the same values, and the same well-posed
    gradient on every path. The expansion's own gradient goes through the
    inverse of I + p / (m eps) cov, whose condition number (about 5,100 at
    two rows, see ssl_agree) turns the summation-order differences of two
    ranks against one process into gradient differences above 1e-4; what
    ssl_ddp_agree compares is the data-parallel backward of the heads and
    the backbones. The loss's own reduction over the ranks is held to JAX
    in tests/test_torch_dist_tasks.py."""
    import scenesplat_tpu_torch.engines.pretrain as pretrain

    real = pretrain.mcr_loss

    def mcr(student_feats, teacher_feats):
        _, metrics = real(student_feats, teacher_feats)
        rows = local_batch_slice(cotangent[0].shape[0])
        lin = all_reduce_sum(sum((s * c[rows]).sum() for s, c in zip(student_feats, cotangent)))
        expa = metrics["mcr_expa_loss"].detach() + lin - lin.detach()
        return -0.1 * metrics["mcr_comp_loss"] - expa, metrics  # mcr_loss's coeff 0.1

    pretrain.mcr_loss = mcr
    try:
        yield
    finally:
        pretrain.mcr_loss = real


def ssl_step_fp32(batch, cotangent, wrap=lambda m: m):
    """One ssl_train_step of ssl_fp32_model (token masks, the curve shuffle
    and drop-path drawn from a generator seeded 13; SGD at SSL_DDP_LR; the
    EMA at the file's first momentum) through its SSLObjective wrapped by
    ``wrap``, the MCR expansion's cotangent given
    (given_expansion_cotangent). Returns (loss terms, student gradients,
    BatchNorm running statistics, teacher parameters after the EMA, whether
    the teacher's mask token stayed, pooling overflow)."""
    model, loss_kwargs, momentum = ssl_fp32_model()
    token = model.teacher.mask_token.detach().clone()
    passes = record_passes(model)
    optimizer = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                                lr=SSL_DDP_LR)
    with given_expansion_cotangent(cotangent):
        metrics = ssl_train_step(wrap(SSLObjective(model)), optimizer, None, batch, momentum,
                                 generator=torch.Generator(device="cuda").manual_seed(13),
                                 **loss_kwargs)
    overflow = [max(int(o.max()) for p in r["passes"] for o in p["overflow"])
                for r in passes.values()]
    return ({k: v.item() for k, v in metrics.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            {k: p.detach().clone() for k, p in model.teacher.named_parameters()},
            torch.equal(model.teacher.mask_token, token), overflow)


def shared_agree_rank(rank, world, port, job_file):
    """One rank of phase_shared_ddp_agree (a spawned process sharing the one
    card over gloo): each of the job file's jobs in turn in one process
    group, through RANK_JOBS[job["kind"]]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jobs = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port):
        init_distributed("cuda", backend="gloo")
        try:
            for job in jobs:
                RANK_JOBS[job["kind"]](rank, job)
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()


def task_agree_job(rank, job):
    """A rank's part of a task's two-rank check (prepare_task_ddp_agree):
    its rows of the job's global batch through one fp32 step under DDP;
    writes the step's results and its K1 / K2 launches."""
    reset_k1_counts()
    reset_k2_counts()
    # MSC's injected pairs list the global batch's rows: every rank holds them all
    rows = {k: v if k.startswith("match_") else v[local_batch_slice(len(v))]
            for k, v in job["rows"].items()}
    if job["task"] in FP32_TASK_MODELS:
        loss, norm, grads, stats, overflow = train_step_fp32(
            cuda_batch(rows), data_parallel, build=FP32_TASK_MODELS[job["task"]](),
            task=job["task"], seed=12)
        out = dict(loss=loss, grad_norm=norm, overflow=overflow)
    else:
        terms, grads, stats, teacher, token_kept, overflow = ssl_step_fp32(
            cuda_batch(rows), [c.cuda() for c in job["cotangent"]], data_parallel)
        out = dict(terms=terms, teacher={k: v.cpu() for k, v in teacher.items()},
                   token_kept=token_kept, overflow=overflow)
    out.update(grads={k: g.cpu() for k, g in grads.items()},
               stats={k: v.cpu() for k, v in stats.items()},
               k1_lse=k1_lse_variants(), k1=k1_variants(),
               k2=dict(fwa.flash_window_attention_bwd.variant_launches))
    torch.save(out, job["out"].format(rank=rank))


STAT_RTOL_DDP = 1e-6
# the SpUNet tasks' two-rank losses (insseg's come out bit-equal)
SPUNET_DDP_LOSS_RTOL = 1e-6


def msc_fp32_model():
    """msc_model_cfg's MSC-v1m1 (published widths, fp32, view mixing off:
    a process merges only its own rows' pairs) on the card in train
    mode, and no criteria (MSC computes its loss)."""
    return build_model(msc_model_cfg(view1_mix_prob=0.0)).cuda().train(), build_criteria(None)


def cac_fp32_model():
    """cac_model_cfg's CAC-v1m1 over SpUNet-v1m1 (published widths) in fp32
    from seed 1 on the card in train mode, and no criteria (CAC holds its
    own)."""
    cfg = cac_model_cfg()
    cfg["backbone"]["seed"] = 1
    return build_model(cfg).cuda().train(), build_criteria(None)


# the fp32 model of each task whose two-rank step runs through train_step_fp32
FP32_TASK_MODELS = dict(semseg=lambda: semseg_fp32_model, insseg=lambda: insseg_fp32_model,
                        msc=lambda: msc_fp32_model, cac=lambda: cac_fp32_model)
SPUNET_TASKS = ("insseg", "msc", "cac")


def check_ranks_stats(phase, r, got, ref, floor=0.0):
    """Each BatchNorm running statistic of rank ``r`` within STAT_RTOL_DDP
    (relative L2) of one process's, or within NOISE_FLOOR_FACTOR times
    ``floor`` (the statistics' own noise floor); returns the worst."""
    err = {k: rel_l2(v, ref[k].cpu()) for k, v in got.items()}
    bound = max(STAT_RTOL_DDP, NOISE_FLOOR_FACTOR * floor)
    check(sorted(err) == sorted(ref) and max(err.values()) <= bound,
          f"{phase}: rank {r}'s BatchNorm statistics differ by {max(err.values())} "
          f"(bound {bound})")
    return max(err.values())


def prepare_task_ddp_agree(work, task):
    """semseg_ddp_agree / ssl_ddp_agree / insseg_ddp_agree / msc_ddp_agree /
    cac_ddp_agree, run by phase_shared_ddp_agree: this process's step (the
    reference) now, the ranks' job for the shared spawn, and
    finish_task_ddp_agree's check once the ranks ran. Two ranks sharing
    the one card over gloo, one row each,
    against one process over both rows, fp32 at the file's widths with one
    block a stage. semseg: CE + Lovasz (the gather of
    every rank's probabilities), 2 rows of 49,152 points, drop-path 0.3, no
    Mix3D; the loss to 1e-5, every gradient to 1e-4 of its norm, the
    BatchNorm statistics to 1e-6. ssl: crops of 24,576 and 6,144 (as
    ssl_agree), token masks drawn at the global batch's shape; every loss
    term to 1e-5, every student gradient to 1e-4 of its norm, the
    statistics to 1e-6, and after the SGD step and the EMA the teacher
    bit-equal on both ranks and within 1e-6 of one process's, its mask token
    unmoved (the MCR expansion's cotangent at the heads given to both sides,
    as in ssl_agree: given_expansion_cotangent). K1 with lse and K2 launch
    on each rank. insseg: PointGroup over SpUNet-v1m1 at its published
    widths (the insseg configuration's model), 2 rows of 8,192 points, the
    reference's CE and the two bias terms over the global batch; the loss to
    1e-5, every gradient to 1e-4 of its norm or under the noise floor rule
    (compare_steps; the floor of one process's step on the points in 3
    other orders), the statistics to 1e-6 or that rule with their floor; no
    K1 or K2 launch. msc: MSC-v1m1 at its published widths (view mixing
    off), 2 rows x 2 views of 8,192 points with msc_agree's draws injected
    (the pairs name global rows, so every rank holds them all): InfoNCE
    over the summed pair features, the reconstructions over the global
    batch; cac: CAC-v1m1 over SpUNet-v1m1 at its published widths on
    insseg's rows, the class sums over the global batch. Both: the loss to
    1e-6, gradients and statistics as insseg's, no K1 or K2 launch."""
    phase = f"{task}_ddp_agree"
    rows = dict(semseg=lambda: semseg_rows(49152, (13, 14)), ssl=lambda: ssl_rows(24576, 6144),
                insseg=lambda: insseg_rows(INSSEG_AGREE_POINTS, (41, 42)),
                msc=lambda: with_msc_draws(msc_rows(MSC_AGREE_POINTS, (61, 62))),
                cac=lambda: insseg_rows(INSSEG_AGREE_POINTS, (41, 42)))[task]()
    batch = cuda_batch(rows)
    floor, stat_floor, teacher, cotangent = None, 0.0, None, None
    if task in FP32_TASK_MODELS:
        build = FP32_TASK_MODELS[task]()
        loss, norm, grads, stats, overflow = train_step_fp32(batch, build=build, task=task,
                                                             seed=12)
        ref = (loss, {k: g.cpu() for k, g in grads.items()}, overflow)
        if task in SPUNET_TASKS:  # the noise floor: the points in other orders
            permuted = permuted_two_view if task == "msc" else permuted_rows
            others = [train_step_fp32(cuda_batch(permuted(rows, 70 + i)), build=build,
                                      task=task, seed=12) for i in range(FLOOR_PERMUTATIONS)]
            floor = grad_floor(ref, [(o[0], o[2]) for o in others])
            stat_floor = max(rel_l2(o[3][k].cpu(), v.cpu()) for o in others
                             for k, v in stats.items())
    else:
        cotangent = expansion_cotangent(batch)
        terms, grads, stats, teacher, token_kept, overflow = ssl_step_fp32(batch, cotangent)
        check(token_kept, f"{phase}: one process's teacher mask token moved")
        ref = (terms, {k: g.cpu() for k, g in grads.items()}, overflow)
        teacher = {k: v.cpu() for k, v in teacher.items()}
    stats = {k: v.cpu() for k, v in stats.items()}
    del grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    job = dict(kind="task", task=task, rows=rows,
               out=os.path.join(work, f"{phase}_rank{{rank}}.pt"),
               cotangent=None if cotangent is None else [c.cpu() for c in cotangent])
    return dict(phase=phase, job=job, finish=lambda ranks, ranks_s, world: finish_task_ddp_agree(
        task, ranks, ranks_s, world, ref, stats, floor, stat_floor, teacher))


def finish_task_ddp_agree(task, ranks, ranks_s, world, ref, stats, floor, stat_floor, teacher):
    """prepare_task_ddp_agree's check of the ranks' outputs ``ranks``
    against this process's step ``ref``; returns the launches."""
    phase = f"{task}_ddp_agree"
    record = dict(phase=phase, world=world, backend="gloo", rows=world, dtype="float32",
                  drop_path=None if task in SPUNET_TASKS else 0.3, ranks_s=ranks_s,
                  stat_rtol=STAT_RTOL_DDP,
                  stat_noise_floor=stat_floor)
    for r, got in enumerate(ranks):
        loss_r = got["terms"] if task == "ssl" else got["loss"]
        compare_steps(f"{phase}_rank{r}", (loss_r, got["grads"], got["overflow"]), ref,
                      names=("ranks", "one"), floor=floor, world=world, backend="gloo")
        if task == "ssl":
            for key, value in ref[0].items():
                check(abs(loss_r[key] - value) <= TRAIN_LOSS_RTOL * abs(value),
                      f"{phase}: rank {r}'s {key} {loss_r[key]} against {value}")
            err = max((got["teacher"][k] - v).abs().max().item() for k, v in teacher.items())
            check(err <= 1e-6, f"{phase}: rank {r}'s teacher differs by {err} from one process's")
            check(got["token_kept"], f"{phase}: rank {r}'s teacher mask token moved")
            record.setdefault("teacher_max_abs_diff", []).append(err)
            for k, v in ranks[0]["teacher"].items():
                check(torch.equal(v, got["teacher"][k]),
                      f"{phase}: rank {r}'s teacher {k} differs from rank 0's")
        record.setdefault("stat_worst_rel_l2", []).append(
            check_ranks_stats(phase, r, got["stats"], stats, stat_floor))
        if task in ("msc", "cac"):
            rel = abs(loss_r - ref[0]) / abs(ref[0])
            check(rel <= SPUNET_DDP_LOSS_RTOL,
                  f"{phase}: rank {r}'s loss {loss_r} against {ref[0]} ({rel} relative)")
        k1_lse, k2 = sum(got["k1_lse"].values()), sum(got["k2"].values())
        # SpUNet (insseg, msc, cac) has no attention: neither kernel may launch
        check((k1_lse > 0 and k2 > 0) if task not in SPUNET_TASKS else
              k1_lse == k2 == sum(got["k1"].values()) == 0,
              f"{phase}: rank {r} launched K1 with lse {k1_lse} and K2 {k2} times")
        record.setdefault("k1_lse", []).append(k1_lse)
        record.setdefault("k1_without_lse", []).append(sum(got["k1"].values()) - k1_lse)
        record.setdefault("k2", []).append(k2)
        for key, g in ranks[0]["grads"].items():
            check(torch.equal(g, got["grads"][key]),
                  f"{phase}: rank {r}'s {key} gradient differs from rank 0's")
    record.update(loss=[got.get("loss", got.get("terms")) for got in ranks], loss_one=ref[0])
    emit(record)
    return dict(k1_lse=sum(record["k1_lse"]), k1=sum(record["k1_without_lse"]),
                k2=sum(record["k2"]),
                k1_lse_variants=sum_counts(got["k1_lse"] for got in ranks),
                k2_variants=sum_counts(got["k2"] for got in ranks))


REMAT_GRAD_RTOL = 1e-5


def phase_remat_agree(n=24576):
    """The flagship file at its widths, one fp32 train step of 2 rows of
    ``n`` points (drop-path 0.3, the curve shuffle and the contrastive split
    drawn) with remat_blocks off and on, from the same weights and
    generator seed, both under deterministic algorithms (the pooling's
    scatter-adds in one order): the loss bit-equal, every gradient within
    REMAT_GRAD_RTOL of its norm, K1 / K2 launches (with remat, each block's
    recompute in the backward launches K1 with lse once more); then each
    model's step again without the deterministic mode for its time (CUDA
    events) and peak memory (the model's parameters included)."""
    batch = cuda_batch(agree_rows(n, (7, 8), size_m=AGREE_ROOM_M))
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            built = flagship_fp32_model(remat_blocks=remat)
            gc.collect()
            torch.cuda.empty_cache()
            reset_k1_counts()
            reset_k2_counts()
            loss, norm, grads, _, overflow = train_step_fp32(batch, build=lambda: built)
            runs[remat] = dict(loss=loss, grad_norm=norm, overflow=overflow,
                               grads={k: g.detach().clone() for k, g in grads.items()},
                               k1_lse=sum(k1_lse_variants().values()),
                               k1=fwa.flash_window_attention.launches,
                               k2=fwa.flash_window_attention_bwd.launches)
            del grads
            # the same step again as a user runs it (not deterministic): its
            # time (CUDA events) and peak memory (the model's parameters
            # included)
            torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            train_step_fp32(batch, build=lambda: built)
            end.record()
            torch.cuda.synchronize()
            runs[remat].update(step_ms=start.elapsed_time(end),
                               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.use_deterministic_algorithms(True, warn_only=True)
            del built
    finally:
        torch.use_deterministic_algorithms(False)
    off, on = runs[False], runs[True]
    worst = max(rel_l2(on["grads"][k], g) for k, g in off["grads"].items()
                if g.norm() > ZERO_GRAD * off["grad_norm"])
    record = dict(phase="remat_agree", config=FLAGSHIP_CONFIG, dtype="float32", points=n,
                  rows=2, deterministic_algorithms=True, grad_rtol=REMAT_GRAD_RTOL,
                  worst_grad_rel_l2=worst, loss_bit_equal=on["loss"] == off["loss"],
                  **{f"remat_{name}": {k: v for k, v in run.items() if k != "grads"}
                     for name, run in (("off", off), ("on", on))})
    emit(record)
    check(on["loss"] == off["loss"], f"remat_agree: loss {on['loss']} against {off['loss']}")
    check(worst <= REMAT_GRAD_RTOL, f"remat_agree: a gradient differs by {worst}")
    check(not any(on["overflow"] + off["overflow"]), "remat_agree: pooling overflow")
    check(off["k1_lse"] == off["k2"] == blocks and on["k2"] == blocks
          and on["k1_lse"] == 2 * blocks,
          f"remat_agree: K1 with lse {off['k1_lse']} / {on['k1_lse']} and K2 {off['k2']} / "
          f"{on['k2']} a step without / with remat, expected {blocks} / {2 * blocks} and "
          f"{blocks}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(off=dict(k1_lse=off["k1_lse"], k2=off["k2"]),
                on=dict(k1_lse=on["k1_lse"], k2=on["k2"]))


# ---- Point Prompt Training and the RPE switch --------------------------------

# the PPT model's conditions and, in another order as in the published PPT
# file, the backbone's PDNorm conditions: a name looked up by index would
# pick the other dataset's norms
PPT_CONDITIONS = ("ScanNetGS", "ScanNetPPGS")
PPT_PDNORM_CONDITIONS = ("ScanNetPPGS", "ScanNetGS")
PPT_CLASSES = dict(ScanNetGS=20, ScanNetPPGS=100)
PPT_DATASETS = dict(ScanNetGS="ScanNetGSDataset", ScanNetPPGS="ScanNetPPGSDataset")


def ppt_model_config(backbone, kind="v1m1"):
    """PPT over the semseg file's PT-v3m1 with the published PPT switches
    (pdnorm bn, ln and decouple on, adaptive off, context 256): PPT-v1m1
    over the port's ScanNet200 SigLIP2 table, each condition's classes
    matched to its rows by name (valid_index_by_name), or PPT-v1m2 with
    one head per condition (20 and 100 classes)."""
    bb = dict(backbone, pdnorm_conditions=PPT_PDNORM_CONDITIONS, pdnorm_bn=True,
              pdnorm_ln=True, pdnorm_decouple=True, pdnorm_adaptive=False,
              context_channels=256)
    common = dict(backbone=bb, backbone_out_channels=64, context_channels=256,
                  conditions=PPT_CONDITIONS)
    if kind == "v1m2":
        return dict(type="PPT-v1m2", num_classes=tuple(PPT_CLASSES[c] for c in PPT_CONDITIONS),
                    **common)
    return dict(type="PPT-v1m1", class_name="builtin:scannet200",
                class_embedding_path="builtin:scannet200",
                valid_index=valid_index_by_name("builtin:scannet200", (
                    "builtin:scannet20", "builtin:scannetpp_top100")), **common)


def with_condition(transform, name):
    """A pipeline ending in Collect, with Add(condition=name) before its
    ToTensor and ``condition`` collected."""
    transform = [dict(t) for t in transform]
    collect = transform[-1]
    check(collect["type"] == "Collect", f"pipeline ends in {collect['type']}")
    transform[-1] = dict(collect, keys=tuple(collect["keys"]) + ("condition",))
    transform.insert(len(transform) - 2, dict(type="Add", keys_dict={"condition": name}))
    return transform


def ppt_train_config(root, exp, batch_size, test_root=None, loop=2):
    """The semseg file (criteria, optimizer, schedule, param groups, Mix3D,
    points, its hooks but PreciseEvaluator) with the PPT-v1m1 model over
    its backbone and MultiDatasetTrainer over two children of the same
    scenes under ``root``: ScanNetGS (ScanNetGSDataset, ScanNet-20 labels,
    loop 2) and ScanNetPPGS (ScanNetPPGSDataset, 100 classes, loop 1), each
    pipeline ending in Add(condition); the concatenation's ``loop``. With 4
    scenes and batch 2 (Mix3D: 4 samples a batch) that is 3 steps a loop,
    the conditions A, A, B (A, A, B, A, A, B at loop 2). Validation: one child per condition over
    root/val; with ``test_root``, one SemSegTester per condition over it."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    cfg.model = dict(ppt_model_config(cfg.model.backbone), criteria=cfg.model.criteria)
    cfg.train = dict(type="MultiDatasetTrainer")
    train, val, test, testers = [], [], [], []
    for name, loop in zip(PPT_CONDITIONS, (2, 1)):
        dataset = PPT_DATASETS[name]
        train.append(dict(cfg.data.train, type=dataset, data_root=root, loop=loop,
                          transform=with_condition(cfg.data.train.transform, name)))
        val.append(dict(cfg.data.val, type=dataset, data_root=root,
                        transform=with_condition(cfg.data.val.transform, name)))
        test_cfg = dict(cfg.data.test.test_cfg)
        test_cfg["post_transform"] = with_condition(test_cfg["post_transform"], name)
        test.append(dict(cfg.data.test, type=dataset, data_root=test_root, test_cfg=test_cfg))
        testers.append(dict(type="SemSegTester", num_classes=PPT_CLASSES[name],
                            save_path=os.path.join(exp, f"test_{name}")))
    cfg.data.update(num_classes=max(PPT_CLASSES.values()),
                    train=dict(type="ConcatDataset", datasets=train, loop=loop),
                    val=dict(type="ConcatDataset", datasets=val))
    if test_root:
        cfg.data.test, cfg.test = test, testers
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    return cfg


def pdnorm_index(key):
    """The condition index (in the backbone's order) of a PDNorm's entry
    ``...norm.{c}.<leaf>`` (SpUNet-v1m3's ``...bns.{c}.<leaf>``), else
    None."""
    m = re.search(r"\.(?:norm|bns)\.(\d+)\.(weight|bias|running_mean|running_var)$", key)
    return None if m is None else int(m.group(1))


class PDNormProbe(HookBase):
    """Around every train step, which conditions' PDNorm BatchNorms moved
    their running statistics (indices into the backbone's
    ``pdnorm_conditions``)."""

    def __init__(self, model):
        self.stats = {k: v for k, v in model.named_buffers()
                      if k.endswith("running_mean") and pdnorm_index(k) is not None}
        self.moved, self.before = [], None

    def before_step(self):
        self.before = {k: v.clone() for k, v in self.stats.items()}

    def after_step(self):
        self.moved.append(sorted({pdnorm_index(k) for k, v in self.stats.items()
                                  if not torch.equal(v, self.before[k])}))


def phase_ppt_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6), val_points=40000):
    """MultiDatasetTrainer on ppt_train_config: PPT-v1m1 at the semseg
    file's widths (bf16, 205,824 points, 32 heads at stage 4, encoder
    windows of 1024, decoder 48), batch 2, ``steps`` steps (a multiple of
    3) over 4 synthetic rooms read as two conditions, then SemSegEvaluator
    over one validation room a condition. Checks each step's condition (A,
    A, B, ... by the loop ratio), that only that condition's PDNorm statistics moved in it (the
    name looked up in the backbone's other order), K1 / K2 launches by
    variant, finite losses, no pooling overflow and each condition's
    val mIoU. Returns the stage shapes, the K1 / K2 counts and the best
    checkpoint, copied into ``work``."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "rooms")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=31, size_m=room,
                        semseg=True, ppt=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=32,
                        size_m=(2.4, 2.4, 2.0), semseg=True, ppt=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        reset_k2_counts()
        cfg = ppt_train_config(root, os.path.join(tmp, "exp"), 2, loop=steps // 3)
        probes = []

        def before(trainer):
            probes.append(PDNormProbe(trainer.model))
            probes[0].trainer = trainer
            trainer.hooks.append(probes[0])

        trainer, probe, records, k1_counts = run_training(cfg, before=before)
        moved = probes[0].moved
        backbone = trainer.cfg.model.backbone
        enc, dec = depth_split(backbone)
        blocks = enc + dec
        k1, k2 = k1_counts["train_launches"], fwa.flash_window_attention_bwd.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        conditions = [r["condition"] for r in records]
        a, b = PPT_CONDITIONS
        check(conditions == [a, a, b] * (steps // 3),
              f"ppt_train: step conditions {conditions}, expected {a} {a} {b} twice")
        want_moved = [[PPT_PDNORM_CONDITIONS.index(c)] for c in conditions]
        check(moved == want_moved, f"ppt_train: PDNorm statistics of conditions {moved} moved "
              f"in the steps, expected {want_moved} (the backbone's order)")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses + grad_norms),
              f"ppt_train: losses {losses}, grad norms {grad_norms}")
        check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
              and k2 == blocks * steps,
              f"ppt_train: {k1} forward and {k2} backward kernel launches in {steps} steps")
        got = {v: n for v, n in k1_counts["train_variants"].items() if n}
        check(got == dict(bf16_large=enc * steps, bf16_small=dec * steps),
              f"ppt_train: train K1 variant launches {got}")
        k2_variants = fwa.flash_window_attention_bwd.variant_launches
        check(k2_variants == dict(k2_variants, bf16_small=dec * steps, bf16_large=enc * steps),
              f"ppt_train: K2 variant launches {k2_variants}")
        val_forwards, k1_val = k1_counts["val_forwards"], k1_counts["val_launches"]
        check(val_forwards == 2 and k1_val == 2 * blocks,
              f"ppt_train: {k1_val} K1 launches in {val_forwards} validation forwards")
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        check(not any(map(any, overflow)) and not any(k1_counts["val_overflow"]),
              f"ppt_train: pooling overflow {overflow} {k1_counts['val_overflow']}")
        mious = {c: hist(f"val/{c}/mIoU").values() for c in PPT_CONDITIONS}
        check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in mious.values()),
              f"ppt_train: per-condition val mIoU {mious}")
        checkpoint = shutil.copy(os.path.join(trainer.cfg.save_path, "model", "model_best.pth"),
                                 os.path.join(work, "ppt_model_best.pth"))
        sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
        emit(dict(phase="ppt_train", model="PPT-v1m1", conditions=PPT_CONDITIONS,
                  pdnorm_conditions=PPT_PDNORM_CONDITIONS, config=SEMSEG_CONFIG + " + PPT",
                  batch_size=2, points=cfg.data.num_points, steps=len(losses),
                  step_conditions=conditions, pdnorm_stats_moved=moved, loss=losses,
                  grad_norm=grad_norms, lr=hist("lr").values(), cold_step_ms=step_ms[0],
                  warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                  data_wait_s=hist("data_time").values(), peak_mem_gib=peak_gib,
                  val_miou={c: v[0] for c, v in mious.items()},
                  val_miou_mean=hist("val/mIoU").values()[0],
                  k1_launches_per_step=k1 / steps, k2_launches_per_step=k2 / steps,
                  k1_variant_launches=k1_counts["train_variants"],
                  k2_variant_launches=dict(k2_variants), evaluation_forwards=val_forwards,
                  evaluation_k1_launches=k1_val, n_overflow_per_stage=overflow,
                  stage_slots_valid=sizes[-1], dataset_write_s=data_s, profile=probe.profile))
        print(f"ppt_train: step conditions {conditions}; val mIoU "
              f"{ {c: round(v[0], 4) for c, v in mious.items()} }; K1 {k1_counts['train_variants']}"
              f", K2 {dict(k2_variants)} in {steps} steps", flush=True)
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    return shapes, k1, dict(k1_counts["train_variants"]), dict(k2_variants), checkpoint


def phase_ppt_test(work, checkpoint, n_voxels=160000):
    """``python -m scenesplat_tpu_torch.test`` on the PPT config with the
    ppt_train checkpoint: a SemSegTester a condition (ScanNetGS over 20
    classes, ScanNetPPGS over 100 with the ScanNet++ top-3 protocol), each
    over one synthetic room of 2 n_voxels + 1 Gaussians with both label sets,
    TEST_VIEWS of the file's views, as a user runs it. Checks every scene predicted, finite mIoU
    and K1 once a block in every fragment forward; prints the seconds per
    scene (fetch, extract, vote). Returns the K1 counts, the fragment
    forwards and the shapes of K1's calls in the first one."""
    t0 = time.perf_counter()
    root = os.path.join(work, "ppt_test")
    n_points = write_test_scenes(root, 1, n_voxels, seed=33, semseg=True, ppt=True)
    write_s = time.perf_counter() - t0
    cfg = ppt_train_config(root, os.path.join(work, "ppt_test_exp"), 2, test_root=root)
    for test in cfg.data.test:
        test["test_cfg"]["aug_transform"] = test_views(test["test_cfg"]["aug_transform"])
    path = os.path.join(work, "ppt_test_config.py")
    cfg.dump(path)
    backbone = cfg.model["backbone"]
    enc, dec = depth_split(backbone)
    calls = WindowCalls(limit=enc + dec, max_window=max(backbone["enc_patch_size"]))
    reset_k1_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with calls:
        results = test_entry.main(["--config-file", path, "--options", f"weight={checkpoint}"])
    seconds = time.perf_counter() - t1
    per_condition = {}
    for name, tester, res in zip(PPT_CONDITIONS, cfg.test, results):
        with open(os.path.join(tester["save_path"], "scene_log.json")) as f:
            scenes = json.load(f)
        check(len(scenes) == 1 and scenes[0]["points"] == n_points,
              f"ppt_test: {name}: scenes {[(s['name'], s['points']) for s in scenes]}")
        check(math.isfinite(res["mIoU"]) and res["iou_per_class"].shape == (PPT_CLASSES[name],),
              f"ppt_test: {name}: mIoU {res['mIoU']}, {res['iou_per_class'].shape} classes")
        per_condition[name] = dict(mIoU=res["mIoU"], classes=PPT_CLASSES[name],
                                   per_scene=scene_split(dict(scenes=scenes)))
    fragments = sum(sc["fragments"] for r in per_condition.values() for sc in r["per_scene"])
    variants = {v: n for v, n in k1_variants().items() if n}
    check(fwa.flash_window_attention.launches == (enc + dec) * fragments
          and variants == dict(bf16_large=enc * fragments, bf16_small=dec * fragments),
          f"ppt_test: K1 {variants} in {fragments} fragment forwards")
    check(len(calls.calls) == enc + dec, f"ppt_test: first fragment's K1 calls {calls.calls}")
    emit(dict(phase="ppt_test", dtype="bfloat16", points_per_scene=n_points,
              views=len(TEST_VIEWS),
              fragments=fragments, seconds=seconds, dataset_write_s=write_s,
              k1_variant_launches=variants, conditions=per_condition,
              k1_calls_first_fragment=calls.shapes()))
    for name, r in per_condition.items():
        for sc in r["per_scene"]:
            print(f"ppt_test: {name} {sc['name']} {sc['points']} points, {sc['fragments']} "
                  f"fragments: fetch {sc['fetch_s']:.2f} s, extract {sc['extract_s']:.2f} s, "
                  f"vote {sc['vote_s']:.2f} s, total {sc['total_s']:.2f} s", flush=True)
    return variants, fragments, calls.shapes()


def ppt_fp32_model(kind, **backbone):
    """ppt_model_config of ``kind`` over the semseg file's backbone at one
    block a stage (widths, heads, windows, drop-path 0.3 kept), fp32 from
    seed 1, on the card in train mode, and the file's criteria."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    model = build_model(ppt_model_config(dict(
        cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4, dtype="float32", seed=1,
        **backbone), kind))
    return model.cuda().train(), build_criteria(cfg.model.criteria)


def ppt_grads(model):
    """The gradients a step left (the other condition's norms and head
    have none)."""
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()
            if p.grad is not None}


def phase_ppt_agree(n=49152):
    """One fp32 training loss (CE + Lovasz) of PPT-v1m1 and of PPT-v1m2 at
    one block a stage on each condition, with the kernels and with the
    plain attention, from the same weights and generator seeds: losses to
    1e-5, each gradient to 1e-4 of its norm; the parameters with gradients
    are the backbone's shared ones, the active condition's norms (its
    index in the backbone's order) and head."""
    backbone = dict(Config.fromfile(SEMSEG_CONFIG).model.backbone, enc_depths=(1,) * 5,
                    dec_depths=(1,) * 4)
    rows = semseg_rows(n, (41,))
    for kind in ("v1m1", "v1m2"):
        for ci, name in enumerate(PPT_CONDITIONS):
            batch = dict(cuda_batch(rows), condition=name)
            active = PPT_PDNORM_CONDITIONS.index(name)

            def step(use_kernel):
                model, criteria = ppt_fp32_model(kind, use_kernel=use_kernel)
                gen = torch.Generator(device="cuda").manual_seed(12)
                loss, out = ppt_loss(model, criteria, batch, gen)
                loss.backward()
                grads = ppt_grads(model)
                norms = {pdnorm_index(k) for k in grads} - {None}
                check(norms == {active}, f"ppt_agree: {kind} {name}: norms of conditions "
                      f"{norms} took gradients, expected {active}")
                heads = {k for k in grads if k.startswith("seg_heads.")}
                check(kind == "v1m1" or heads == {f"seg_heads.{ci}.weight",
                                                  f"seg_heads.{ci}.bias"},
                      f"ppt_agree: {name}: head gradients {heads}")
                return loss.item(), grads, [int(p.n_overflow.max()) for p in out.plans]

            compare_train_steps(f"ppt_agree_{kind}_{name}", step, sum(depth_split(backbone)),
                                points=n, model=f"PPT-{kind}", condition=name,
                                pdnorm_index=active)


def ppt_steps_fp32(batch, conditions, ddp=False, kind="v1m2"):
    """train_step of task "ppt" on ppt_fp32_model(kind) (drop-path 0.3,
    the curve shuffle drawn from a generator seeded 12; SGD at lr 0) once
    on each of ``conditions`` in turn; with ``ddp`` the model runs under
    one DDP wrapper with find_unused_parameters, as the trainer builds it
    for PPT, which sees the change of condition. Returns each step's (loss, grad
    norm, gradients, pooling overflow) and the BatchNorm statistics
    after the last."""
    model, criteria = ppt_fp32_model(kind)
    overflow, forward = [], model.forward

    def recording(point, generator=None, condition=None):
        out = forward(point, generator=generator, condition=condition)
        overflow.append([int(p.n_overflow.max()) for p in out.plans])
        return out

    model.forward = recording
    wrapped = data_parallel(model, find_unused_parameters=True) if ddp else model
    steps = []
    for name in conditions:
        metrics = train_step(wrapped, criteria, torch.optim.SGD(model.parameters(), lr=0.0),
                             None, dict(batch, condition=name),
                             generator=torch.Generator(device="cuda").manual_seed(12),
                             task="ppt")
        steps.append((metrics["loss"].item(), metrics["grad_norm"].item(), ppt_grads(model),
                      overflow[-1]))
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return steps, stats


def ppt_agree_job(rank, job):
    """A rank's part of prepare_ppt_ddp_agree's check: its row of the global
    batch through ppt_steps_fp32 under DDP with find_unused_parameters;
    writes the steps and its K1 / K2 launches."""
    reset_k1_counts()
    reset_k2_counts()
    rows = {k: v[local_batch_slice(len(v))] for k, v in job["rows"].items()}
    steps, stats = ppt_steps_fp32(cuda_batch(rows), job["conditions"], ddp=True)
    torch.save(dict(steps=[(loss, norm, {k: g.cpu() for k, g in grads.items()}, o)
                           for loss, norm, grads, o in steps],
                    stats={k: v.cpu() for k, v in stats.items()},
                    k1_lse=k1_lse_variants(),
                    k2=dict(fwa.flash_window_attention_bwd.variant_launches)),
               job["out"].format(rank=rank))


def prepare_ppt_ddp_agree(work):
    """ppt_ddp_agree, run by phase_shared_ddp_agree (this process's steps
    now, the ranks' job, finish_ppt_ddp_agree's check once the ranks ran):
    two ranks sharing the card over gloo, one row each, against one
    process over both rows: PPT-v1m2 at one block a stage, fp32, 2 rows of
    49,152 points (semseg_rows: their 4 cm cells fit the first pooling), two steps, on ScanNetGS then ScanNetPPGS, through one
    DDP wrapper with find_unused_parameters (the inactive condition's
    norms and head take no gradient, and change with the condition; each
    step checks that the ranks hold one condition). Each step's loss to
    1e-5, every gradient to 1e-4 of its norm, the same parameters with
    gradients on every rank and in one process (the inactive head's
    none), the BatchNorm statistics after both steps to 1e-6."""
    phase = "ppt_ddp_agree"
    conditions = list(PPT_CONDITIONS)
    rows = semseg_rows(49152, (43, 44))
    ref_steps, ref_stats = ppt_steps_fp32(cuda_batch(rows), conditions)
    ref_steps = [(loss, norm, {k: g.cpu() for k, g in grads.items()}, o)
                 for loss, norm, grads, o in ref_steps]
    ref_stats = {k: v.cpu() for k, v in ref_stats.items()}
    gc.collect()
    torch.cuda.empty_cache()
    job = dict(kind="ppt", rows=rows, conditions=conditions,
               out=os.path.join(work, f"{phase}_rank{{rank}}.pt"))
    return dict(phase=phase, job=job, finish=lambda ranks, ranks_s, world: finish_ppt_ddp_agree(
        ranks, ranks_s, world, conditions, ref_steps, ref_stats))


def finish_ppt_ddp_agree(ranks, ranks_s, world, conditions, ref_steps, ref_stats):
    """prepare_ppt_ddp_agree's check of the ranks' outputs ``ranks``;
    returns the launches."""
    phase = "ppt_ddp_agree"
    record = dict(phase=phase, model="PPT-v1m2", world=world, backend="gloo", rows=world,
                  dtype="float32", drop_path=0.3, conditions=conditions, ranks_s=ranks_s,
                  find_unused_parameters=True, stat_rtol=STAT_RTOL_DDP)
    for r, got in enumerate(ranks):
        for i, (name, (loss, _, grads, overflow)) in enumerate(zip(conditions, got["steps"])):
            ref_loss, _, ref_grads, ref_overflow = ref_steps[i]
            inactive = f"seg_heads.{1 - PPT_CONDITIONS.index(name)}.weight"
            check(inactive not in grads and inactive not in ref_grads,
                  f"{phase}: rank {r}: step {i} ({name}): the inactive head took a gradient")
            compare_steps(f"{phase}_rank{r}_step{i}", (loss, grads, overflow),
                          (ref_loss, ref_grads, ref_overflow), names=("ranks", "one"),
                          world=world, condition=name)
            for key, g in ranks[0]["steps"][i][2].items():
                check(torch.equal(g, grads[key]),
                      f"{phase}: rank {r}'s step {i} {key} gradient differs from rank 0's")
        record.setdefault("stat_worst_rel_l2", []).append(
            check_ranks_stats(phase, r, got["stats"], ref_stats))
        k1_lse, k2 = sum(got["k1_lse"].values()), sum(got["k2"].values())
        check(k1_lse > 0 and k2 > 0, f"{phase}: rank {r}: K1 with lse {k1_lse}, K2 {k2}")
        record.setdefault("k1_lse", []).append(k1_lse)
        record.setdefault("k2", []).append(k2)
    record.update(loss=[[s[0] for s in got["steps"]] for got in ranks],
                  loss_one=[s[0] for s in ref_steps])
    emit(record)
    return dict(k1_lse=sum(record["k1_lse"]), k2=sum(record["k2"]))


# ---- tensor and context parallel ---------------------------------------------

GRID_CLIP = 1.0  # the flagship file's clip_grad
CP_SERVE_POINTS = 98304


def whole_grads(model, grads):
    """``grads`` (by name) of a model whose tensor-parallel shares
    (``shard_model_tp``) are gathered whole over its model group, on the
    host; the others as they are."""
    return {k: g.cpu() for k, g in gather_whole(grads.items(), model).items()}


def tp_fp32_model(**backbone):
    """flagship_fp32_model cut over the layout's model group."""
    model, criteria = flagship_fp32_model(**backbone)
    return shard_model_tp(model), criteria


def grid_step_job(rank, job):
    """A rank's part of tp_agree or cp_agree (phase_shared_ddp_agree's
    spawn): the fp32 step of ddp_agree's two rows clipped at GRID_CLIP, on
    (data 1, model 2) with both rows (``kind`` "tp") or on (data 1, seq 2)
    with half of each row's slots ("cp"), under DDP over the points group;
    writes the step, the whole gradients and the rank's K1 / K2 launches,
    heads, gathered bytes, peak memory and seconds."""
    kind = job["kind"]
    grid = tp_groups(1, 2) if kind == "tp" else context_groups(1)
    set_layout(grid)
    try:
        rows = job["rows"] if kind == "tp" else shard_point_batch(job["rows"])
        reset_path_counts()
        context.GATHERED.update(forward=0, backward=0)
        torch.cuda.reset_peak_memory_stats()
        built = []

        def build(**backbone):
            model, criteria = (tp_fp32_model if kind == "tp" else flagship_fp32_model)(**backbone)
            built.append(model)
            return model, criteria

        t0 = time.perf_counter()
        loss, norm, grads, stats, overflow = train_step_fp32(
            cuda_batch(rows), data_parallel, build=build, clip_grad=GRID_CLIP)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        model = built[0]
        heads = [m.num_heads // m.tp_degree for m in model.modules()
                 if type(m).__name__ == "SerializedAttention"]
        out = dict(loss=loss, grad_norm=norm, overflow=overflow, seconds=seconds,
                   grads=whole_grads(model, grads), stats={k: v.cpu() for k, v in stats.items()},
                   k1_lse=k1_lse_variants(), k1=k1_variants(),
                   k2=dict(fwa.flash_window_attention_bwd.variant_launches),
                   k3=bs.bitonic_sort.launches, heads=heads, gathered=dict(context.GATHERED),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   sharded=sum(getattr(p, "tp_sharded", False) for p in model.parameters()))
        torch.save(out, job["out"].format(rank=rank))
    finally:
        set_layout(None)


def serve_point(rows):
    return PointBatch(coord=rows["coord"], feat=rows["feat"],
                      grid_coord=rows["grid_coord"], mask=rows["mask"])


def cp_serve_job(rank, job):
    """A rank's part of cp_serve: the flagship LangPretrainer in bf16 (seed
    0, as the serve phase builds it) on its half of the room's slots at
    (data 1, seq 2), one forward; writes its block of the features, its K1
    launches by variant, the bytes gathered and the forward's seconds."""
    set_layout(context_groups(1))
    try:
        model = build_lang_model(dict(FLAGSHIP_BACKBONE), dtype="bfloat16", device="cuda",
                                 seed=0)
        point = serve_point(cuda_batch(shard_point_batch(job["rows"])))
        reset_path_counts()
        context.GATHERED.update(forward=0, backward=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            feat = model(point).feat.float().cpu()
        seconds = time.perf_counter() - t0
        torch.save(dict(feat=feat, k1=k1_variants(), k1_lse=k1_lse_variants(),
                        k3=bs.bitonic_sort.launches,
                        gathered=dict(context.GATHERED), seconds=seconds,
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30),
                   job["out"].format(rank=rank))
    finally:
        set_layout(None)


def prepare_grid_agree(work, ref):
    """tp_agree, cp_agree and cp_serve, run by phase_shared_ddp_agree.

    tp_agree: the flagship file's fp32 model (its widths: heads 2, 4, 8, 16
    in the encoder, 16 in the decoder, every block cut in two) on (data 1,
    model 2), both ranks holding ddp_agree's two rows of 24,576 points:
    drop-path 0.3, the contrastive term on, clipped at the file's 1.0,
    against ddp_agree's one-process step over the same rows (``ref``),
    whose gradients clipped by its own norm are the reference: the loss to
    1e-5, every whole gradient to 1e-4 of its norm, the norm to 1e-4,
    equal gradients on both ranks. Each rank launches K1 with lse and K2 on
    every block, at its H / 2 heads. cp_agree: the same step on (data 1,
    seq 2), each rank holding half of each row's slots, the same reference
    and bounds; each rank runs K1 and K2 on its whole windows of every
    stage. cp_serve: one bf16 forward of the flagship LangPretrainer (the
    serve phase's model, seed 0) over one room of 98,304 Gaussians at seq
    2, against one process's bf16 forward of the room: within 2.5 times the
    one-process bf16 forward's own distance from its fp32 forward, each
    relative to the fp32 features' largest magnitude; K1 on bf16_large."""
    coef = min(1.0, GRID_CLIP / (ref["grad_norm"] + 1e-6))  # torch's clip_grad_norm_
    clipped = (ref["loss"], {k: g * coef for k, g in ref["grads"].items()}, ref["overflow"])
    pending = []
    for kind in ("tp", "cp"):
        phase = f"{kind}_agree"
        job = dict(kind=kind, rows=ref["rows"], out=os.path.join(work, f"{phase}_rank{{rank}}.pt"))
        pending.append(dict(phase=phase, job=job, finish=lambda ranks, ranks_s, world, kind=kind:
                            finish_grid_agree(kind, ranks, ranks_s, world, clipped, ref, coef)))

    rng = np.random.default_rng(5)
    coord, feat_in, grid = room_scene(rng, CP_SERVE_POINTS, (4.0, 4.0, 3.0))
    rows = dict(coord=coord[None], feat=feat_in[None], grid_coord=grid[None],
                mask=np.ones((1, CP_SERVE_POINTS), bool))
    one = {}
    for dtype in ("bfloat16", "float32"):
        model = build_lang_model(dict(FLAGSHIP_BACKBONE), dtype=dtype, device="cuda", seed=0)
        with torch.inference_mode():
            one[dtype] = model(serve_point(cuda_batch(rows))).feat.float().cpu()
        del model
        torch.cuda.empty_cache()
    job = dict(kind="cp_serve", rows=rows, out=os.path.join(work, "cp_serve_rank{rank}.pt"))
    pending.append(dict(phase="cp_serve", job=job, finish=lambda ranks, ranks_s, world:
                        finish_cp_serve(ranks, ranks_s, world, one)))
    return pending


def finish_grid_agree(kind, ranks, ranks_s, world, clipped, ref, coef):
    """prepare_grid_agree's check of tp_agree's or cp_agree's ranks;
    returns their K1 and K2 launches."""
    phase = f"{kind}_agree"
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    record = dict(phase=phase, grid="(data 1, model 2)" if kind == "tp" else "(data 1, seq 2)",
                  world=world, backend="gloo", rows=2, points=ref["rows"]["mask"].shape[1],
                  dtype="float32", drop_path=0.3, clip_grad=GRID_CLIP, clip_coef=coef,
                  ranks_s=ranks_s, loss_one=ref["loss"], grad_norm_one=ref["grad_norm"])
    for r, got in enumerate(ranks):
        compare_steps(f"{phase}_rank{r}", (got["loss"], got["grads"], got["overflow"]), clipped,
                      names=("grid", "one"), world=world, grid=record["grid"],
                      grad_norm=[got["grad_norm"], ref["grad_norm"]])
        check(abs(got["grad_norm"] - ref["grad_norm"]) <= TRAIN_GRAD_RTOL * ref["grad_norm"],
              f"{phase}: rank {r}'s gradient norm {got['grad_norm']} against {ref['grad_norm']}")
        stat_err = {k: rel_l2(v, ref["stats"][k]) for k, v in got["stats"].items()}
        stat = max(stat_err.values())
        check(sorted(stat_err) == sorted(ref["stats"]) and stat <= TRAIN_GRAD_RTOL,
              f"{phase}: rank {r}'s BatchNorm statistics differ by {stat}")
        k1_lse, k2 = sum(got["k1_lse"].values()), sum(got["k2"].values())
        check(k1_lse == k2 == blocks and sum(got["k1"].values()) == k1_lse,
              f"{phase}: rank {r} launched K1 {got['k1']} ({k1_lse} with lse) and K2 "
              f"{got['k2']} times, expected {blocks} each")
        check(got["k3"] == 0, f"{phase}: rank {r} launched K3 {got['k3']} times (switch off)")
        if kind == "tp":
            check(got["sharded"] == 6 * blocks, f"{phase}: rank {r} holds {got['sharded']} "
                  "shares")
        for key, g in ranks[0]["grads"].items():
            check(torch.equal(g, got["grads"][key]),
                  f"{phase}: rank {r}'s {key} gradient differs from rank 0's")
        for key in ("loss", "grad_norm", "seconds", "peak_mem_gib", "gathered", "heads", "k3"):
            record.setdefault(key, []).append(got[key])
        record.setdefault("stat_worst_rel_l2", []).append(stat)
        record.setdefault("k1_lse", []).append(got["k1_lse"])
        record.setdefault("k2", []).append(got["k2"])
    emit(record)
    return dict(k1_lse=[sum(c.values()) for c in record["k1_lse"]],
                k2=[sum(c.values()) for c in record["k2"]], k3=record["k3"],
                k1_lse_variants=sum_counts(record["k1_lse"]), k2_variants=sum_counts(record["k2"]))


def finish_cp_serve(ranks, ranks_s, world, one):
    """prepare_grid_agree's check of cp_serve's ranks; returns their K1
    launches."""
    got = torch.cat([r["feat"] for r in ranks], dim=1)
    ref16, ref32 = one["bfloat16"], one["float32"]
    scale = ref32.abs().max().item()
    own = (ref16 - ref32).abs().max().item() / scale
    err = (got - ref16).abs().max().item() / scale
    check(got.shape == ref16.shape and torch.isfinite(got).all().item(),
          f"cp_serve: features {tuple(got.shape)}, one process {tuple(ref16.shape)}")
    for r, rank_out in enumerate(ranks):
        check(rank_out["k1"].get("bf16_large", 0) == sum(rank_out["k1"].values()) == 18,
              f"cp_serve: rank {r} launched K1 {rank_out['k1']}, expected 18 on bf16_large")
        check(rank_out["k3"] == 0, f"cp_serve: rank {r} launched K3 {rank_out['k3']} times")
    emit(dict(phase="cp_serve", grid="(data 1, seq 2)", world=world, backend="gloo",
              points=got.shape[1], dtype="bfloat16", ranks_s=ranks_s, max_rel_err=err,
              one_bf16_vs_fp32_max_rel_err=own, bound=BF16_NOISE_FACTOR * own,
              k1=[r["k1"] for r in ranks], k3=[r["k3"] for r in ranks],
              gathered=[r["gathered"] for r in ranks],
              seconds=[r["seconds"] for r in ranks],
              peak_mem_gib=[r["peak_mem_gib"] for r in ranks]))
    check(err <= BF16_NOISE_FACTOR * own,
          f"cp_serve: {err} from one process's bf16 features (bound {BF16_NOISE_FACTOR * own})")
    return dict(k1=[r["k1"]["bf16_large"] for r in ranks], k3=[r["k3"] for r in ranks])


RANK_JOBS = dict(ddp=ddp_agree_job, task=task_agree_job, ppt=ppt_agree_job, tp=grid_step_job,
                 cp=grid_step_job, cp_serve=cp_serve_job)


def phase_shared_ddp_agree(work, pending, world=2):
    """The two-rank checks prepared by prepare_ddp_agree,
    prepare_task_ddp_agree, prepare_ppt_ddp_agree and prepare_grid_agree,
    their ranks in one spawn (shared_agree_rank:
    each job in turn in one process group, where a spawn each cost a
    process start, the imports and a group each); then each check in
    turn. Returns each phase's launches by phase name."""
    job_file = os.path.join(work, "shared_ddp_agree_jobs.pt")
    torch.save([p["job"] for p in pending], job_file)
    ranks_s = spawn_ranks(shared_agree_rank, world, job_file, timeout_s=900)
    emit(dict(phase="shared_ddp_agree", phases=[p["phase"] for p in pending], world=world,
              ranks_s=ranks_s))
    results = {}
    for p in pending:
        ranks = [torch.load(p["job"]["out"].format(rank=r), weights_only=False)
                 for r in range(world)]
        results[p["phase"]] = p["finish"](ranks, ranks_s, world)
    return results


def phase_rpe_agree(n=205824, n_train=49152, reps=1):
    """enable_rpe on the semseg file's backbone at its widths (bf16, 5
    stages, encoder windows of 1024, decoder 48), one row of ``n`` points:
    with every rpe_table zero the RPE path (plain dense attention with the
    bias, no kernel) against the K1 path of the same weights, both against
    the fp32 K1 forward, under the noise-floor rule (the RPE path's error
    at most 2.5x the K1 path's); each forward's time (CUDA events) and
    peak memory; then one bf16 train step of the semseg file's
    DefaultSegmentorV2 over that backbone with enable_rpe and its random
    tables at ``n_train`` points: finite loss and gradients, every table's
    gradient nonzero, no K1 or K2 launch."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    backbone = dict(cfg.model.backbone)
    rng = np.random.default_rng(45)
    coord, feat_in, grid = room_scene(rng, n, (3.6, 3.6, 2.6), thickness=2)
    normal = shell_normals(grid, [int(round(m / GRID)) for m in (3.6, 3.6, 2.6)], 2)
    point = PointBatch(coord=torch.from_numpy(coord)[None].cuda(),
                       feat=torch.from_numpy(np.concatenate([feat_in, normal], 1).astype(
                           np.float32))[None].cuda(),
                       grid_coord=torch.from_numpy(grid)[None].long().cuda(),
                       mask=torch.ones(1, n, dtype=torch.bool, device="cuda"))
    k1_model = build_model(dict(backbone, seed=3)).cuda().eval()
    state = k1_model.state_dict()
    rpe_model = build_model(dict(backbone, seed=3, enable_rpe=True)).cuda().eval()
    missing, unexpected = rpe_model.load_state_dict(state, strict=False)
    check(not unexpected and missing and all(k.endswith("attn.rpe.rpe_table") for k in missing),
          f"rpe_agree: missing {missing}, unexpected {unexpected}")
    for k in missing:
        rpe_model.get_parameter(k).data.zero_()
    truth_model = build_model(dict(backbone, seed=3, dtype="float32")).cuda().eval()
    truth_model.load_state_dict(state)
    runs = {}
    with torch.no_grad():
        truth = truth_model(point).feat.float()[0]
        del truth_model
        for name, model in (("k1", k1_model), ("rpe", rpe_model)):
            reset_k1_counts()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = model(point).feat.float()[0]
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            launches = fwa.flash_window_attention.launches
            ms = cuda_ms(lambda: model(point), reps=reps, warmup=1)
            runs[name] = dict(out=out, ms=ms, peak_gib=peak, k1_launches=launches,
                              rel_err=((out - truth).norm() / truth.norm()).item())
    k1, rpe = runs["k1"], runs["rpe"]
    blocks = sum(depth_split(backbone))
    check(k1["k1_launches"] == blocks and rpe["k1_launches"] == 0,
          f"rpe_agree: K1 launches {k1['k1_launches']} (K1 path) and {rpe['k1_launches']} (RPE)")
    check(torch.isfinite(rpe["out"]).all().item(), "rpe_agree: non-finite RPE output")
    check_noise_floor(rpe["rel_err"], k1["rel_err"], "zero-table RPE model output",
                      ("N", n, "blocks", blocks))
    diff = ((rpe["out"] - k1["out"]).norm() / k1["out"].norm()).item()
    del runs, k1_model, rpe_model, point
    gc.collect()
    torch.cuda.empty_cache()

    # one bf16 train step with random tables
    model = build_model(dict(
        type="DefaultSegmentorV2", num_classes=cfg.model.num_classes,
        backbone_out_channels=cfg.model.backbone_out_channels,
        backbone=dict(backbone, seed=3, enable_rpe=True))).cuda().train()
    criteria = build_criteria(cfg.model.criteria)
    batch = cuda_batch(semseg_rows(n_train, (46, 47)))
    reset_k1_counts()
    reset_k2_counts()
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train_step(model, criteria, optimizer, None, batch,
                         generator=torch.Generator(device="cuda").manual_seed(48), task="semseg")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    tables = {k: g.norm().item() for k, g in grads.items() if k.endswith("rpe_table")}
    check(math.isfinite(metrics["loss"].item()) and all(torch.isfinite(g).all().item()
                                                        for g in grads.values()),
          "rpe_agree: non-finite loss or gradient in the bf16 train step")
    check(len(tables) == blocks and all(v > 0 for v in tables.values()),
          f"rpe_agree: rpe_table gradients {tables}")
    check(fwa.flash_window_attention.launches == 0
          and fwa.flash_window_attention_bwd.launches == 0,
          "rpe_agree: the RPE path launched K1 or K2")
    emit(dict(phase="rpe_agree", config=SEMSEG_CONFIG, dtype="bfloat16", points=n,
              blocks=blocks, k1_path=dict(ms=k1["ms"], peak_gib=k1["peak_gib"],
                                          rel_err_vs_fp32=k1["rel_err"],
                                          k1_launches=k1["k1_launches"]),
              rpe_path=dict(ms=rpe["ms"], peak_gib=rpe["peak_gib"],
                            rel_err_vs_fp32=rpe["rel_err"], k1_launches=rpe["k1_launches"]),
              rpe_vs_k1_rel_l2=diff, noise_factor=BF16_NOISE_FACTOR,
              train_step=dict(points=n_train, rows=2, loss=metrics["loss"].item(),
                              grad_norm=metrics["grad_norm"].item(), seconds=step_s,
                              rpe_table_grad_norms=tables)))
    print(f"rpe_agree: forward at {n} points, bf16: K1 path {k1['ms']:.1f} ms, "
          f"{k1['peak_gib']:.2f} GiB; RPE path {rpe['ms']:.1f} ms, {rpe['peak_gib']:.2f} GiB",
          flush=True)
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()


# ---- instance segmentation: SpUNet and PointGroup ------------------------------

INSSEG_IGNORE = (-1, 0, 1)
INSSEG_AGREE_POINTS = 8192
SPUNET_WIDTHS = dict(channels=(32, 64, 128, 256, 256, 128, 96, 96), layers=(2, 3, 4, 6, 2, 2, 2, 2))
# the card against the CPU, fp32: BatchNorm running statistics (relative L2)
# and a forward's features (relative to their largest magnitude)
STAT_RTOL = 1e-5
SPUNET_FWD_RTOL = 1e-4


def insseg_model_cfg(backbone=None):
    """PG-v1m1 as Pointcept's configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py
    sets it, over SpUNet-v1m1 at its published widths with the GS files'
    14 input channels (or over ``backbone``), fp32."""
    return dict(type="PG-v1m1",
                backbone=backbone or dict(type="SpUNet-v1m1", in_channels=14, num_classes=0,
                                          **SPUNET_WIDTHS),
                backbone_out_channels=96, semantic_num_classes=20, semantic_ignore_index=-1,
                segment_ignore_index=INSSEG_IGNORE, instance_ignore_index=-1,
                cluster_thresh=1.5, cluster_closed_points=300, cluster_propose_points=100,
                cluster_min_points=50)


def insseg_config(cfg):
    """The semseg file ``cfg`` (read as it is) made the PointGroup
    configuration: ``instance`` added to GridSample's and Collect's keys,
    InstanceParser((-1, 0, 1), -1) after NormalizeColor, ``instance_centroid``
    and ``bbox`` collected, insseg_model_cfg's model, Pointcept's SGD (lr 0.1,
    momentum 0.9, weight decay 1e-4, nesterov) and PolyLR without param
    groups, and the hooks ending in InsSegEvaluator and the saver. Data,
    grid, point budget, augmentations, Mix3D and clip_grad stay the file's."""
    def edit(transforms):
        out = []
        for t in transforms:
            t = dict(t)
            if t["type"] == "GridSample":
                t["keys"] = tuple(t["keys"]) + ("instance",)
            if t["type"] == "Collect":
                t["keys"] = tuple(t["keys"]) + ("instance", "instance_centroid", "bbox")
            out.append(t)
            if t["type"] == "NormalizeColor":
                out.append(dict(type="InstanceParser", segment_ignore_index=INSSEG_IGNORE,
                                instance_ignore_index=-1))
        return out

    cfg.data.train.transform = edit(cfg.data.train.transform)
    cfg.data.val.transform = edit(cfg.data.val.transform)
    cfg.model = insseg_model_cfg()
    cfg.optimizer = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="PolyLR")
    cfg.param_dicts = None
    cfg.hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                 dict(type="InformationWriter"),
                 dict(type="InsSegEvaluator", segment_ignore_index=INSSEG_IGNORE,
                      instance_ignore_index=-1),
                 dict(type="CheckpointSaver", save_freq=None)]
    return cfg


def insseg_room(rng, n, size_m, n_objects, box_m=(0.3, 0.6)):
    """A room of ``n`` unique 2 cm voxels: ``n_objects`` box surfaces (no
    bottom face), one in each of as many cells of a floor grid, sides of
    ``box_m`` metres, classes 2-19, one instance each, all their voxels;
    the rest drawn from the 4 cm thick floor (class 1) and walls (class 0).
    Returns (coord, 14 features: colour, opacity, quaternion, scale and
    normals, grid_coord, segment, instance)."""
    ex, ey, ez = (int(round(m / GRID)) for m in size_m)
    per = int(math.ceil(math.sqrt(n_objects)))
    slot = (min(ex, ey) - 8) // per
    parts, normals, segs, insts = [], [], [], []
    for k, cell in enumerate(rng.choice(per * per, n_objects, replace=False)):
        side = rng.integers(int(box_m[0] / GRID), int(box_m[1] / GRID) + 1, 3)
        side[:2] = np.minimum(side[:2], slot - 2)
        lo = np.array([4 + (cell // per) * slot + 1, 4 + (cell % per) * slot + 1, 2])
        box = np.stack(np.meshgrid(*[np.arange(s) for s in side], indexing="ij"), -1)
        box = box.reshape(-1, 3)
        normal = np.zeros((len(box), 3), np.float32)
        for axis, sign, on in ((0, -1, box[:, 0] == 0), (0, 1, box[:, 0] == side[0] - 1),
                               (1, -1, box[:, 1] == 0), (1, 1, box[:, 1] == side[1] - 1),
                               (2, 1, box[:, 2] == side[2] - 1)):
            normal[on] = 0
            normal[on, axis] = sign
        surface = normal.any(1)
        parts.append(box[surface] + lo)
        normals.append(normal[surface])
        segs.append(np.full(surface.sum(), 2 + rng.integers(0, 18)))
        insts.append(np.full(surface.sum(), 2 + k))
    objects = np.concatenate(parts)
    x, y, z = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij")
    shell = (z < 2) | (x < 2) | (x >= ex - 2) | (y < 2) | (y >= ey - 2)
    vox = np.stack([x[shell], y[shell], z[shell]], -1)
    rest = n - len(objects)
    check(0 < rest <= len(vox), f"room {size_m}: {len(objects)} object voxels of {n}")
    shell_vox = vox[rng.choice(len(vox), rest, replace=False)]
    grid = np.concatenate([shell_vox, objects]).astype(np.int64)
    floor = shell_vox[:, 2] < 2
    segment = np.concatenate([np.where(floor, 1, 0)] + segs).astype(np.int64)
    instance = np.concatenate([np.where(floor, 1, 0)] + insts).astype(np.int64)
    normal = np.concatenate([shell_normals(shell_vox, (ex, ey, ez), 2)] + normals)
    order = rng.permutation(n)
    grid, segment, instance, normal = grid[order], segment[order], instance[order], normal[order]
    coord = ((grid + 0.5) * GRID).astype(np.float32)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    feat = np.concatenate([rng.uniform(-1, 1, (n, 3)), rng.uniform(0, 1, (n, 1)), quat,
                           rng.uniform(0, 0.05, (n, 3)), normal], axis=1).astype(np.float32)
    return coord, feat, grid, segment, instance


def write_insseg_scenes(root, n_scenes, n, seed, size_m, n_objects):
    """``n_scenes`` insseg_room rooms in the ScanNet GS layout
    (root/scene/<asset>.npy): colour 0-255, opacity, quaternion, scale,
    normals, ``segment20`` and ``instance``."""
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        coord, feat, _, segment, instance = insseg_room(rng, n, size_m, n_objects)
        scene = os.path.join(root, f"scene{i:04d}")
        os.makedirs(scene)
        for key, value in dict(coord=coord, color=((feat[:, :3] + 1) * 127.5).astype(np.float32),
                               opacity=feat[:, 3], quat=feat[:, 4:8], scale=feat[:, 8:11],
                               normal=feat[:, 11:], segment20=segment.astype(np.int16),
                               instance=instance.astype(np.int32)).items():
            np.save(os.path.join(scene, f"{key}.npy"), np.ascontiguousarray(value))


def insseg_rows(n, seeds, size_m=(1.6, 1.6, 1.4), n_objects=4, box_m=(0.3, 0.4)):
    """One PointGroup batch row of ``n`` points per seed (insseg_room; a
    room small enough that every downsample's clusters fit its capacity),
    its instance targets as InstanceParser gives them; numpy arrays [rows,
    n, ...]."""
    from scenesplat_tpu_torch.data.transforms import InstanceParser

    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coord, feat, grid, segment, instance = insseg_room(rng, n, size_m, n_objects, box_m)
        parsed = InstanceParser(INSSEG_IGNORE, -1)(dict(coord=coord, segment=segment,
                                                        instance=instance))
        rows.append(dict(coord=coord, feat=feat, grid_coord=grid, mask=np.ones(n, bool),
                         segment=segment, instance=parsed["instance"],
                         instance_centroid=parsed["instance_centroid"].astype(np.float32)))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def insseg_fp32_model():
    """insseg_model_cfg's PointGroup over SpUNet-v1m1 (published widths) in
    fp32 from seed 1, on the card in train mode, and the criteria its
    config sets (none: the reference's CE)."""
    cfg = insseg_model_cfg()
    cfg["backbone"]["seed"] = 1
    return build_model(cfg).cuda().train(), build_criteria(None)


def pg_step(model, batch):
    """One insseg loss and backward of ``model`` on ``batch`` (tensors on
    the model's device): (loss, gradients by name on the CPU, each
    downsample's pooling overflow), and the BatchNorm statistics after."""
    loss, out = insseg_loss(model, build_criteria(None), batch)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (loss.item(), grads, [int(p.n_overflow.max()) for p in out.plans]), stats


def phase_spunet_agree(n=INSSEG_AGREE_POINTS):
    """The insseg configuration's PointGroup over SpUNet-v1m1 at its
    published widths, fp32, 2 rows of ``n`` points: one train step's loss,
    gradients and BatchNorm statistics on the card against the same step
    on the CPU from the same weights and batch (loss 1e-5, every gradient
    1e-4 of its norm, or the noise floor rule of compare_steps with the floor
    of the card's step on the rows' points in 3 other orders; statistics
    1e-5); then
    SpUNet-v1m3 (PDNorm, adaptive,
    the published conditions, the batch named "S3DIS", a [2, 256] context):
    its train-mode forward on both (1e-4 of the output's scale), only the
    active condition's statistics moved, and its statistics to 1e-5."""
    rows = insseg_rows(n, (41, 42))
    cfg = insseg_model_cfg()
    cfg["backbone"]["seed"] = 1
    base = build_model(copy.deepcopy(cfg))  # every run a copy: one initialization
    runs = [("cuda", rows), ("cpu", rows)] + [
        (f"permuted{i}", permuted_rows(rows, 60 + i)) for i in range(FLOOR_PERMUTATIONS)]
    steps, stats, seconds = {}, {}, {}
    for device, batch_rows in runs:
        model = copy.deepcopy(base)
        where = "cpu" if device == "cpu" else "cuda"
        model.to(where).train()
        t0 = time.perf_counter()
        steps[device], stats[device] = pg_step(model, batch_to_device(batch_rows, where))
        if where == "cuda":
            torch.cuda.synchronize()
        seconds[device] = time.perf_counter() - t0
        del model
    stat_err = {k: rel_l2(v, stats["cpu"][k]) for k, v in stats["cuda"].items()}
    floor = grad_floor(steps["cuda"], [steps[name] for name, _ in runs[2:]])
    compare_steps("spunet_agree", steps["cuda"], steps["cpu"], names=("card", "cpu"),
                  floor=floor, points=n, rows=2,
                  model="PG-v1m1 over SpUNet-v1m1", widths=SPUNET_WIDTHS, step_s=seconds,
                  stat_worst_rel_l2=max(stat_err.values()), stat_rtol=STAT_RTOL)
    check(max(stat_err.values()) <= STAT_RTOL,
          f"spunet_agree: BatchNorm statistics differ by {max(stat_err.values())}")

    conditions = ("ScanNet", "S3DIS", "Structured3D")
    v1m3 = dict(type="SpUNet-v1m3", in_channels=14, num_classes=0, conditions=conditions,
                pd_adaptive=True, seed=2, **SPUNET_WIDTHS)
    init = build_model(dict(v1m3)).state_dict()
    context = torch.randn(2, 256, generator=torch.Generator().manual_seed(3))
    feats, moved = {}, {}
    for device in ("cuda", "cpu"):
        model = build_model(dict(v1m3))
        model.load_state_dict(init)
        model.to(device).train()
        point = point_from_batch(batch_to_device(rows, device))
        with torch.no_grad():
            out = model(point, condition="S3DIS", context=context.to(device))
        feats[device] = out.feat.cpu()
        moved[device] = {k: v.cpu() for k, v in model.state_dict().items()
                         if k.endswith("running_mean") and not torch.equal(v.cpu(), init[k])}
        del model
    err = ((feats["cuda"] - feats["cpu"]).abs().max() / feats["cpu"].abs().max()).item()
    check(err <= SPUNET_FWD_RTOL, f"spunet_agree: v1m3 forward differs by {err}")
    card, cpu = sorted(moved["cuda"]), sorted(moved["cpu"])
    check(card == cpu and cpu and all(".bns.1." in k for k in cpu),
          f"spunet_agree: v1m3 moved {card[:4]} on the card and {cpu[:4]} on the CPU, "
          f"expected the S3DIS norms")
    v1m3_err = max(rel_l2(v, moved["cpu"][k]) for k, v in moved["cuda"].items())
    check(v1m3_err <= STAT_RTOL, f"spunet_agree: v1m3 statistics differ by {v1m3_err}")
    emit(dict(phase="spunet_agree_v1m3", points=n, rows=2, condition="S3DIS",
              conditions=conditions, adaptive=True, forward_max_rel_err=err,
              fwd_rtol=SPUNET_FWD_RTOL, norms_moved=len(moved["cpu"]),
              stat_worst_rel_l2=v1m3_err))


class InsSegTermProbe:
    """Records each insseg step's three loss terms (the train step's
    pointgroup_loss, wrapped for the block)."""

    def __init__(self):
        self.terms = []

    @contextlib.contextmanager
    def on(self):
        real = train_step_module.pointgroup_loss

        def recording(*args, **kwargs):
            total, terms = real(*args, **kwargs)
            if torch.is_grad_enabled():
                self.terms.append({k: v.item() for k, v in terms.items()})
            return total, terms

        train_step_module.pointgroup_loss = recording
        try:
            yield self
        finally:
            train_step_module.pointgroup_loss = real


def insseg_train_config(root, exp, batch_size, steps, scenes):
    """insseg_config over the semseg file: the data roots, epoch 1, the
    batch size and a train loop that gives ``steps`` steps over ``scenes``
    rooms (Mix3D: two samples a batch slot); written to a file and read
    back, as the train entry reads it."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    samples = steps * batch_size * (2 if cfg.mix_prob > 0 else 1)
    check(samples % scenes == 0, f"{samples} samples over {scenes} scenes")
    cfg.data.train.update(data_root=root, loop=samples // scenes)
    cfg.data.val.data_root = root
    cfg = insseg_config(cfg)
    path = os.path.join(os.path.dirname(exp), "insseg.py")
    cfg.dump(path)
    return Config.fromfile(path)


def phase_insseg_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6),
                       val_points=40000, val_room=(2.4, 2.4, 2.0), objects=(12, 6)):
    """The train entry's trainer on the insseg configuration (insseg_config:
    PG-v1m1 over SpUNet-v1m1 at its published widths, SGD + PolyLR, the
    semseg file's data path with InstanceParser, 205,824 points, Mix3D 0.8)
    at batch 2 for ``steps`` steps over 4 rooms of ``scene_points`` with
    ``objects[0]`` objects each, then InsSegEvaluator over 2 validation
    rooms of ``val_points`` (``objects[1]`` each). Gates: finite losses, the seg term
    above 0, no K1 or K2 launch (SpUNet has no attention), AP50 the
    checkpoint metric, model_best.pth loading strictly into a fresh PG.
    Returns the validation root's first room's path for insseg_oracle and
    the run's config."""
    tmp = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    root = os.path.join(tmp, "scannet_gs")
    write_insseg_scenes(os.path.join(root, "train"), 4, scene_points, 51, room, objects[0])
    write_insseg_scenes(os.path.join(root, "val"), 2, val_points, 52, val_room, objects[1])
    data_s = time.perf_counter() - t0
    reset_k1_counts()
    reset_k2_counts()
    cfg = insseg_train_config(root, os.path.join(tmp, "exp"), 2, steps, 4)
    with InsSegTermProbe().on() as terms:
        trainer, probe, records, k1_counts = run_training(cfg)
    hist = trainer.storage.history
    losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
    check(len(losses) == steps, f"insseg: {len(losses)} train steps, expected {steps}")
    check(all(math.isfinite(v) for v in losses + grad_norms),
          f"insseg: non-finite loss or grad_norm: {losses} {grad_norms}")
    check(len(terms.terms) == steps and all(t["seg_loss"] > 0 for t in terms.terms),
          f"insseg: seg terms {terms.terms}")
    k1 = k1_counts["train_launches"] + k1_counts["val_launches"]
    k2 = fwa.flash_window_attention_bwd.launches
    check(k1 == k2 == 0, f"insseg: K1 {k1} and K2 {k2} launches on a SpUNet")
    check(trainer.comm_info.get("current_metric_name") == "AP50",
          f"insseg: checkpoint metric {trainer.comm_info.get('current_metric_name')}")
    aps = {k: hist(f"val/{k}").values() for k in ("mAP", "AP50", "AP25")}
    check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in aps.values()), f"insseg: {aps}")
    best = os.path.join(trainer.cfg.save_path, "model", "model_best.pth")
    check(os.path.exists(best), "insseg: no model_best.pth")
    fresh = build_model(copy.deepcopy(dict(cfg.model)))
    fresh.load_state_dict(torch.load(best, map_location="cpu", weights_only=False)["state_dict"],
                          strict=True)
    evaluator = next(h for h in trainer.hooks if type(h).__name__ == "InsSegEvaluator")
    step_ms = probe.step_ms()
    overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
    sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
    emit(dict(phase="insseg_train", config=f"{SEMSEG_CONFIG} made PG-v1m1 (insseg_config)",
              model="PG-v1m1 over SpUNet-v1m1", widths=SPUNET_WIDTHS, batch_size=2,
              points=cfg.data.num_points, steps=len(losses), loss=losses, loss_terms=terms.terms,
              grad_norm=grad_norms, lr=hist("lr").values(), cold_step_ms=step_ms[0],
              warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
              data_wait_s=hist("data_time").values(),
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
              val_map=aps["mAP"][0], val_ap50=aps["AP50"][0], val_ap25=aps["AP25"][0],
              val_scenes=evaluator.scene_log, n_overflow_per_stage=overflow,
              evaluation_n_overflow=k1_counts["val_overflow"], stage_slots_valid=sizes[-1],
              k1_launches=k1, k2_launches=k2, dataset_write_s=data_s, profile=probe.profile))
    print(f"insseg_train: val AP50 {aps['AP50'][0]:.4f} (after {len(losses)} steps)", flush=True)
    val_cfg = dict(cfg.data.val)
    del trainer, fresh
    torch.cuda.empty_cache()
    return val_cfg, dict(cfg.model)


def phase_insseg_oracle(val_cfg, model_cfg, reps=5):
    """One validation room at full size through the val pipeline: its
    ground truth as one-hot logits and biases (centroid - coord) through
    proposals_from_predictions on the card and on the CPU and the ScanNet
    AP code: the clusters equal exactly, AP50 = mAP = 1. Times the
    clustering at the room's size on both."""
    from scenesplat_tpu_torch.data import build_dataset
    from scenesplat_tpu_torch.models.point_group import proposals_from_predictions
    from scenesplat_tpu_torch.ops.cluster import pointgroup_cluster
    from scenesplat_tpu_torch.utils.insseg_eval import associate_instances, evaluate_matches

    sample = build_dataset(val_cfg)[0]
    coord = np.asarray(sample["coord"], np.float32)
    segment, instance = np.asarray(sample["segment"]), np.asarray(sample["instance"])
    logits = 10.0 * np.eye(20, dtype=np.float32)[segment]
    bias = np.where((instance >= 0)[:, None], sample["instance_centroid"] - coord, 0.0).astype(
        np.float32)
    kw = {k: model_cfg[k] for k in ("segment_ignore_index", "cluster_thresh",
                                    "cluster_propose_points", "cluster_min_points")}
    preds = {d: proposals_from_predictions(coord, logits, bias, device=d, **kw)
             for d in ("cuda", "cpu")}
    for key in ("pred_masks", "pred_classes"):
        check(np.array_equal(preds["cuda"][key], preds["cpu"][key]),
              f"insseg_oracle: {key} differ between the card and the CPU")
    scores = evaluate_matches([associate_instances(
        preds["cuda"]["pred_masks"], preds["cuda"]["pred_classes"], preds["cuda"]["pred_scores"],
        segment, instance, 20, segment_ignore_index=INSSEG_IGNORE)], 20,
        [str(i) for i in range(20)], segment_ignore_index=INSSEG_IGNORE)
    ap = dict(mAP=scores["all_ap"], AP50=scores["all_ap_50%"], AP25=scores["all_ap_25%"])
    check(all(abs(v - 1.0) <= 1e-9 for v in ap.values()), f"insseg_oracle: {ap}")

    keep = ~np.isin(segment, INSSEG_IGNORE)
    centers = torch.from_numpy((coord[keep] + bias[keep]) / np.float32(0.02))
    labels = torch.from_numpy(segment[keep])
    times, ids = {}, {}
    for device in ("cuda", "cpu"):
        c, lab = centers.to(device), labels.to(device)
        ms = []
        for _ in range(reps if device == "cuda" else 1):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids[device], n_clusters = pointgroup_cluster(c, lab, kw["cluster_thresh"],
                                                         kw["cluster_min_points"])
            if device == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[device] = ms
    check(torch.equal(ids["cuda"].cpu(), ids["cpu"]),
          "insseg_oracle: cluster ids differ between the card and the CPU")
    sizes = torch.bincount(ids["cpu"][ids["cpu"] >= 0])
    emit(dict(phase="insseg_oracle", points=len(coord), clustered_points=int(keep.sum()),
              instances=int(len(np.unique(instance[instance >= 0]))),
              proposals=len(preds["cuda"]["pred_classes"]), clusters=n_clusters,
              pile_pairs=int((sizes * (sizes - 1) // 2).sum()), **ap,
              cluster_ms_card=times["cuda"], cluster_ms_cpu=times["cpu"][0]))


def phase_insseg_agree(n=49152):
    """PointGroup over the semseg file's PT-v3m1 (its widths, heads and
    windows, one block a stage, fp32) at ``n`` points of a room with
    objects: one insseg step (the reference's CE and the two bias terms)
    with the kernels and with the plain attention (losses to 1e-5,
    gradients to 1e-4 relative). Returns its K1 with lse and K2 launches."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4)
    batch = cuda_batch(insseg_rows(n, (43,), size_m=(2.0, 2.0, 2.0), n_objects=6,
                                   box_m=(0.3, 0.5)))

    def step(use_kernel):
        model = build_model(insseg_model_cfg(dict(backbone, dtype="float32", seed=1,
                                                  use_kernel=use_kernel)) | dict(
            backbone_out_channels=cfg.model.backbone_out_channels))
        model = model.cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(12)
        loss, out = insseg_loss(model, build_criteria(None), batch, gen)
        loss.backward()
        return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                [int(p.n_overflow.max()) for p in out.plans])

    reset_k1_counts()
    reset_k2_counts()
    compare_train_steps("insseg_agree", step, sum(depth_split(backbone)), points=n,
                        model="PG-v1m1 over the semseg file's PT-v3m1",
                        enc_depths=backbone["enc_depths"], dec_depths=backbone["dec_depths"],
                        criteria="the reference's CE (no criteria) + bias L1 + bias cosine")
    k1_lse = sum(k1_lse_variants().values())
    k2 = fwa.flash_window_attention_bwd.launches
    check(k1_lse == sum(depth_split(backbone)) and k2 == k1_lse,
          f"insseg_agree: K1 with lse {k1_lse}, K2 {k2} launches")
    return dict(k1_lse=k1_lse, k1_lse_variants=k1_lse_variants(), k2=k2,
                k2_variants=dict(fwa.flash_window_attention_bwd.variant_launches))


# ---- Masked Scene Contrast, the Context-Aware Classifier, PPT over SpUNet ----------

MSC_TERMS = ("loss", "nce_loss", "pos_sim", "neg_sim", "color_loss", "normal_loss")
CAC_TERMS = ("loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss")
MSC_AGREE_POINTS = 8192
MSC_CSC = dict(partitions=4, r1=0.125, r2=2.0)
MSC_VIEW_KEYS = ("origin_coord", "grid_coord", "coord", "color", "normal")


def msc_model_cfg(kind="MSC-v1m1", **extra):
    """MSC as Pointcept's pretrain-msc-v1m1-0-spunet-base.py sets it, as far
    as the model's fields and the reference's keys name it: SpUNet-v1m1 at
    its published widths over 6 input channels (colour and normal), out
    96, mask grid 0.1 m at rate 0.4, view 1 mixed with probability 0.8,
    8 neighbours within 3 cm, 8,192 pairs, temperature 0.4, both
    reconstructions; MSC-v1m2 with CSC's partitions (r1 0.125, r2 2 m)."""
    return dict(dict(type=kind, backbone=dict(type="SpUNet-v1m1", in_channels=6, num_classes=0,
                                              **SPUNET_WIDTHS),
                     backbone_in_channels=6, backbone_out_channels=96, mask_grid_size=0.1,
                     mask_rate=0.4, view1_mix_prob=0.8, view2_mix_prob=0, matching_max_k=8,
                     matching_max_radius=0.03, matching_max_pair=8192, nce_t=0.4,
                     contrast_weight=1, reconstruct_weight=1, reconstruct_color=True,
                     reconstruct_normal=True, **(MSC_CSC if kind == "MSC-v1m2" else {})),
                **extra)


def msc_config(cfg):
    """The semseg file ``cfg`` (read as it is) made the MSC pretraining
    configuration: ``origin_coord`` copied, then ContrastiveViewsGenerator
    with the file's train augmentations as each view's pipeline (its
    GridSample carrying ``origin_coord``; Mix3D's place taken by the
    model's view mixing) ending in ShufflePoint, the views' colour and
    normal collected as their 6 input channels; msc_model_cfg's MSC-v1m1;
    Pointcept's SGD (lr 0.1, momentum 0.8, nesterov, weight decay 1e-4)
    and OneCycleLR (pct 0.01); no param groups, no evaluator. The data
    root, 2 cm grid, 204,800-point crop and 205,824 slots stay the
    file's."""
    views = []
    for t in cfg.data.train.transform[:-2]:  # ToTensor and Collect go
        t = dict(t)
        if t["type"] == "GridSample":
            t["keys"] = ("origin_coord", "coord", "color", "normal")
        views.append(t)
    views.append(dict(type="ShufflePoint"))
    cfg.data.train.transform = [
        dict(type="Copy", keys_dict={"coord": "origin_coord"}),
        dict(type="ContrastiveViewsGenerator",
             view_keys=("coord", "color", "normal", "origin_coord"), view_trans_cfg=views),
        dict(type="ToTensor"),
        dict(type="Collect", keys=tuple(f"view{v}_{k}" for v in (1, 2) for k in MSC_VIEW_KEYS),
             view1_feat_keys=("view1_color", "view1_normal"),
             view2_feat_keys=("view2_color", "view2_normal"))]
    cfg.model = msc_model_cfg()
    cfg.mix_prob = 0.0
    cfg.optimizer = dict(type="SGD", lr=0.1, momentum=0.8, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="OneCycleLR", max_lr=0.1, pct_start=0.01, anneal_strategy="cos",
                         div_factor=10.0, final_div_factor=10000.0)
    cfg.param_dicts = None
    cfg.hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                 dict(type="InformationWriter"), dict(type="CheckpointSaver", save_freq=None)]
    return cfg


def msc_rows(n, seeds):
    """Two views of one insseg_room a seed (a room whose 4 cm cells fit the
    first pooling): view 1 its ``n`` points, view 2 the same points in
    another order, their voxels moved by (1, 2, 0) and each coordinate
    anywhere inside its voxel, with 5% colour noise; origin coordinates the
    room's, colour and normal the 6 input channels; row r's room r x 4 m
    along x, so that merged rows (view mixing) do not share voxels. Every
    voxel holds one point, so a step is a function of the point sets alone
    (the noise floor's permutations change only its sums' order). numpy
    arrays [rows, n, ...] under the views' keys."""
    rows = []
    for r, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        coord, feat, grid, _, _ = insseg_room(rng, n, (1.6, 1.6, 1.4), 4, (0.3, 0.4))
        shift = np.array([200 * r, 0, 0])
        grid = grid + shift
        coord = (coord + shift * GRID).astype(np.float32)
        color, normal = feat[:, :3], feat[:, 11:14]
        order = rng.permutation(n)
        grid2 = grid[order] + np.array([1, 2, 0])
        coord2 = ((grid2 + rng.uniform(0, 1, (n, 3))) * GRID).astype(np.float32)
        color2 = (color[order] + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
        row = {}
        for v, c, g, col, nrm, oc in (("view1", coord, grid, color, normal, coord),
                                      ("view2", coord2, grid2, color2, normal[order],
                                       coord[order])):
            row.update({f"{v}_coord": c, f"{v}_grid_coord": g, f"{v}_origin_coord": oc,
                        f"{v}_color": col, f"{v}_normal": nrm,
                        f"{v}_feat": np.concatenate([col, nrm], 1).astype(np.float32),
                        f"{v}_mask": np.ones(n, bool)})
        rows.append(row)
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def with_msc_draws(rows, seed=63):
    """``rows`` with the replay keys of one step's draws, made on the card
    by the model's own cross masks and matching (generator seeded
    ``seed``), so that every run of a comparison takes the same masks and
    pairs: ``view{1,2}_point_mask`` and ``match_{scene,i1,i2,valid}``."""
    model = build_model(msc_model_cfg())
    batch = cuda_batch(rows)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = [batch[f"view{v}_{k}"] for v in (1, 2) for k in ("origin_coord", "mask")]
    pm1, pm2 = model.generate_cross_masks(*args, gen)
    scene, i1, i2, valid = model.match_contrastive_pair(*args, gen)
    draws = dict(view1_point_mask=pm1, view2_point_mask=pm2, match_scene=scene, match_i1=i1,
                 match_i2=i2, match_valid=valid)
    return dict(rows, **{k: v.cpu().numpy() for k, v in draws.items()})


def permuted_two_view(rows, seed):
    """``rows`` (msc_rows with the replay keys) with each view row's points
    in a random order, the masks moved with them and the pairs' indices
    remapped: the same step, summed in other orders."""
    rng = np.random.default_rng(seed)
    out, where = dict(rows), {}
    for v in ("view1", "view2"):
        b, n = rows[f"{v}_mask"].shape
        perm = np.stack([rng.permutation(n) for _ in range(b)])
        where[v] = np.argsort(perm, axis=1)  # an old index's new position
        for k, val in rows.items():
            if k.startswith(v + "_"):
                out[k] = np.take_along_axis(val, perm.reshape(perm.shape + (1,) * (val.ndim - 2)),
                                            1)
    out["match_i1"] = where["view1"][rows["match_scene"], rows["match_i1"]]
    out["match_i2"] = where["view2"][rows["match_scene"], rows["match_i2"]]
    return out


def msc_step(model, batch, generator=None):
    """One MSC loss and backward of ``model`` on ``batch`` (tensors on the
    model's device): (the loss terms, gradients by name on the CPU, the
    passes' largest pooling overflow), and the BatchNorm statistics after."""
    out = model(batch, generator=generator)
    out["loss"].backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return ({k: out[k].item() for k in MSC_TERMS}, grads, [int(out["n_overflow"].item())]), stats


def check_terms(phase, got, ref):
    """Each loss term within TRAIN_LOSS_RTOL of the whole loss; returns the
    worst difference relative to it."""
    worst = max(abs(got[k] - v) for k, v in ref.items()) / abs(ref["loss"])
    check(worst <= TRAIN_LOSS_RTOL, f"{phase}: loss terms {got} against {ref}")
    return worst


def agree_runs(phase, cfg, rows, step, permuted, seeds, extra=None):
    """``step(model, batch)`` of ``cfg``'s model from one initialization on
    the card and on the CPU over ``rows``, and on the card over
    ``permuted(rows, seed)`` for each of ``seeds``; compare_steps holds the
    card to the CPU with the noise floor of the permuted steps, the loss
    terms each within TRAIN_LOSS_RTOL of the loss, the statistics within
    STAT_RTOL_DDP relative L2 or NOISE_FLOOR_FACTOR times their own floor.
    Returns the floor and the card step's seconds."""
    base = build_model(copy.deepcopy(cfg))  # every run a copy: one initialization
    runs = [("cuda", rows), ("cpu", rows)] + [(f"permuted{s}", permuted(rows, s)) for s in seeds]
    steps, stats, seconds = {}, {}, {}
    for name, batch_rows in runs:
        model = copy.deepcopy(base)
        where = "cpu" if name == "cpu" else "cuda"
        model.to(where).train()
        t0 = time.perf_counter()
        steps[name], stats[name] = step(model, batch_to_device(batch_rows, where))
        if where == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        del model
    floor = grad_floor(steps["cuda"], [steps[name] for name, _ in runs[2:]])
    stat_floor = max(rel_l2(stats[name][k], v) for name, _ in runs[2:]
                     for k, v in stats["cuda"].items())
    stat_err = {k: rel_l2(v, stats["cpu"][k]) for k, v in stats["cuda"].items()}
    stat_bound = max(STAT_RTOL_DDP, NOISE_FLOOR_FACTOR * stat_floor)
    worst_term = check_terms(phase, steps["cuda"][0], steps["cpu"][0])
    compare_steps(phase, steps["cuda"], steps["cpu"], names=("card", "cpu"), floor=floor,
                  zero=POINT_ZERO_GRAD, step_s=seconds, stat_worst_rel_l2=max(stat_err.values()),
                  stat_noise_floor=stat_floor, stat_bound=stat_bound,
                  worst_term_rel_to_loss=worst_term, **(extra or {}))
    check(max(stat_err.values()) <= stat_bound,
          f"{phase}: BatchNorm statistics differ by {max(stat_err.values())} (bound {stat_bound})")
    return floor, seconds["cuda"]


def phase_msc_agree(n=MSC_AGREE_POINTS):
    """MSC-v1m1 and MSC-v1m2 (msc_model_cfg, published widths, fp32) over 2
    rows x 2 views of ``n`` points (msc_rows), the card's own draws of the
    masks and pairs injected through the replay keys and view 1 mixed:
    one step's loss terms, gradients and statistics on the card against
    the CPU (agree_runs: terms to 1e-5 of the loss, each gradient to 1e-4
    of its norm or 2.5 times the floor of 3 point-permuted steps on the
    card, statistics to 1e-6 or that rule)."""
    rows = with_msc_draws(msc_rows(n, (61, 62)))
    pairs = int(rows["match_valid"].sum())
    check(pairs == 8192, f"msc_agree: {pairs} valid pairs of 8,192")
    for kind in ("MSC-v1m1", "MSC-v1m2"):
        cfg = msc_model_cfg(kind, view1_mix_prob=1.0)
        if kind == "MSC-v1m2":  # CSC's loss over one block a stage (the time limit)
            cfg["backbone"]["layers"] = (1,) * 8
        agree_runs(kind.lower().replace("-", "_") + "_agree", cfg, rows, msc_step,
                   permuted_two_view, (64, 65, 66),
                   extra=dict(points=n, rows=2, views=2, model=f"{kind} over SpUNet-v1m1",
                              widths=SPUNET_WIDTHS, pairs=pairs, view1_mixed=True,
                              masked_share=[float(rows[f"view{v}_point_mask"].mean())
                                            for v in (1, 2)]))


class MSCProbe:
    """Around MSC's matching, the kNN's CUDA-event time a step (the model
    module's ``knn``, wrapped for the block)."""

    def __init__(self):
        self.ms = []

    @contextlib.contextmanager
    def on(self):
        from scenesplat_tpu_torch.models import msc as msc_module

        real = msc_module.knn

        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            end.record()
            self.ms.append((start, end))
            return out

        msc_module.knn = timed
        try:
            yield self
        finally:
            msc_module.knn = real

    def knn_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.ms]


def mixing_seed(steps, batch_size, n, k=8, prob=0.8, seeds=range(1, 200)):
    """The first config seed whose trainer generator (seed + 1, on the card)
    draws both a mixed and an unmixed view 1 in ``steps`` MSC steps: the
    model's draws a step replayed (the masks' [B, 2n], the mix's scalar,
    the pair priorities' [B, n, k], the rows' scores [B n])."""
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        mixed = []
        for _ in range(steps):
            torch.rand((batch_size, 2 * n), generator=gen, device="cuda")
            mixed.append(bool(torch.rand((), generator=gen, device="cuda") < prob))
            torch.rand((batch_size, n, k), generator=gen, device="cuda")
            torch.rand((batch_size * n,), generator=gen, device="cuda")
        if any(mixed) and not all(mixed):
            return seed, mixed
    raise RuntimeError("no seed mixes some steps and not others")


def task_config(cfg, path):
    cfg.dump(path)
    return Config.fromfile(path)


def phase_msc_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6)):
    """The trainer on msc_config (the semseg file made MSC-v1m1 pretraining
    over SpUNet-v1m1 at its published widths, fp32, two views of 205,824
    slots) at batch 2 for ``steps`` steps over 4 synthetic rooms, with a
    seed whose draws mix view 1 in some steps and not in others: finite
    loss terms, every step's pairs (at most 8,192), masked shares, kNN ms,
    pooling overflow and view mixing; step times, loader waits, peak
    memory, one profiled step; no K1 or K2 launch (SpUNet has no
    attention); model_last.pth loads strictly into a fresh MSC."""
    tmp = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    root = os.path.join(tmp, "scannet_gs")
    write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=71, size_m=room,
                    semseg=True)
    data_s = time.perf_counter() - t0
    cfg = Config.fromfile(SEMSEG_CONFIG)
    seed, want_mixed = mixing_seed(steps, 2, cfg.data.num_points)
    cfg.merge_from_options(dict(save_path=os.path.join(tmp, "exp"), epoch=1, eval_epoch=1,
                                batch_size=2, seed=seed))
    check(steps * 2 % 4 == 0, f"{steps} steps of 2 over 4 rooms")
    cfg.data.train.update(data_root=root, loop=steps * 2 // 4)
    cfg = task_config(msc_config(cfg), os.path.join(tmp, "msc.py"))
    reset_k1_counts()
    reset_k2_counts()
    with MSCProbe().on() as knn_probe:
        trainer, probe, _, _ = run_training(cfg)
    hist = trainer.storage.history
    terms = {k: hist(k).values() for k in MSC_TERMS + (
        "pairs", "view1_mask_share", "view2_mask_share", "view1_mixed", "n_overflow")}
    check(len(terms["loss"]) == steps and all(math.isfinite(v) for k in MSC_TERMS
                                              for v in terms[k]),
          f"msc_train: loss terms {terms}")
    check(all(0 < p <= 8192 for p in terms["pairs"]), f"msc_train: pairs {terms['pairs']}")
    mixed = [bool(v) for v in terms["view1_mixed"]]
    check(mixed == want_mixed, f"msc_train: view 1 mixed {mixed}, the replayed draws "
          f"{want_mixed}")
    k1, k2 = fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches
    check(k1 == k2 == 0, f"msc_train: K1 {k1} and K2 {k2} launches on a SpUNet")
    last = os.path.join(trainer.cfg.save_path, "model", "model_last.pth")
    build_model(copy.deepcopy(dict(cfg.model))).load_state_dict(
        torch.load(last, map_location="cpu", weights_only=False)["state_dict"], strict=True)
    step_ms, knn_ms = probe.step_ms(), knn_probe.knn_ms()
    emit(dict(phase="msc_train", config=f"{SEMSEG_CONFIG} made MSC-v1m1 (msc_config)",
              model="MSC-v1m1 over SpUNet-v1m1", widths=SPUNET_WIDTHS, batch_size=2,
              points=cfg.data.num_points, steps=steps, seed=seed, **terms,
              grad_norm=hist("grad_norm").values(), lr=hist("lr").values(),
              cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
              profiled_step_ms=step_ms[-1], knn_ms=knn_ms,
              data_wait_s=hist("data_time").values(),
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, k1_launches=k1,
              k2_launches=k2, dataset_write_s=data_s, profile=probe.profile))
    print(f"msc_train: nce {[round(v, 3) for v in terms['nce_loss']]}, pairs {terms['pairs']}, "
          f"mixed {mixed}, warm steps {[round(v) for v in step_ms[1:-1]]} ms", flush=True)
    del trainer
    torch.cuda.empty_cache()


def cac_model_cfg(backbone=None, backbone_out_channels=96):
    """CAC-v1m1 over SpUNet-v1m1 at its published widths with the GS files'
    14 input channels (or over ``backbone``), 20 classes, the cross-entropy
    as criteria, the JAX package's defaults (cos_temp 15, every weight 1,
    conf_thresh 0), fp32."""
    return dict(type="CAC-v1m1", num_classes=TRAIN_CLASSES,
                backbone_out_channels=backbone_out_channels,
                backbone=backbone or dict(type="SpUNet-v1m1", in_channels=14, num_classes=0,
                                          **SPUNET_WIDTHS),
                criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
                cos_temp=15, main_weight=1, pre_weight=1, pre_self_weight=1, kl_weight=1,
                conf_thresh=0)


def cac_config(cfg):
    """The semseg file ``cfg`` (read as it is) made a CAC configuration
    (Pointcept's semseg-cac-v1m1-0-spunet-base.py over the GS data path):
    cac_model_cfg's model, SGD (lr 0.05, momentum 0.9, nesterov, weight
    decay 1e-4) with OneCycleLR (pct 0.05), no param groups; the file's
    data path, Mix3D, clip_grad, hooks and tester."""
    cfg.model = cac_model_cfg()
    cfg.optimizer = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05, anneal_strategy="cos",
                         div_factor=10.0, final_div_factor=10000.0)
    cfg.param_dicts = None
    return cfg


def phase_cac_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6), val_points=40000):
    """The trainer on cac_config (CAC-v1m1 over SpUNet-v1m1 at its published
    widths, fp32, 205,824 points, Mix3D 0.8) at batch 2 for ``steps`` steps
    over 4 synthetic rooms, then the file's SemSegEvaluator over one
    validation room (PreciseEvaluator's tester left to cac_test): finite
    loss terms, the refined logits scored, no K1 or K2 launch; step times,
    loader waits, peak memory, one profiled step. Returns the config file
    and the best checkpoint."""
    tmp = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    root = os.path.join(tmp, "scannet_gs")
    write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=73, size_m=room,
                    semseg=True)
    write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=74, size_m=(2.4, 2.4, 2.0),
                    semseg=True)
    data_s = time.perf_counter() - t0
    cfg = cac_config(semseg_train_config(root, os.path.join(tmp, "exp"), 2, steps, 4))
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    path = os.path.join(tmp, "cac.py")
    cfg = task_config(cfg, path)
    reset_k1_counts()
    reset_k2_counts()
    overflow = []

    def before(trainer):  # each training forward's pooling overflow, from the backbone
        backbone = trainer.model.backbone
        forward = backbone.forward

        def recording(point, *args, **kwargs):
            out = forward(point, *args, **kwargs)
            if backbone.training:
                overflow.append([int(p.n_overflow.max()) for p in out.plans])
            return out

        backbone.forward = recording

    trainer, probe, _, k1_counts = run_training(cfg, before=before)
    hist = trainer.storage.history
    terms = {k: hist(k).values() for k in CAC_TERMS}
    check(len(terms["loss"]) == steps and all(math.isfinite(v) for vs in terms.values()
                                              for v in vs), f"cac_train: loss terms {terms}")
    k1 = k1_counts["train_launches"] + k1_counts["val_launches"]
    k2 = fwa.flash_window_attention_bwd.launches
    check(k1 == k2 == 0, f"cac_train: K1 {k1} and K2 {k2} launches on a SpUNet")
    miou = hist("val/mIoU").values()
    check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"cac_train: val mIoU {miou}")
    best = os.path.join(trainer.cfg.save_path, "model", "model_best.pth")
    step_ms = probe.step_ms()
    emit(dict(phase="cac_train", config=f"{SEMSEG_CONFIG} made CAC-v1m1 (cac_config)",
              model="CAC-v1m1 over SpUNet-v1m1", widths=SPUNET_WIDTHS, batch_size=2,
              points=cfg.data.num_points, steps=steps, **terms,
              grad_norm=hist("grad_norm").values(), lr=hist("lr").values(),
              cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
              profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, val_miou=miou[0],
              n_overflow_per_stage=overflow, evaluation_n_overflow=k1_counts["val_overflow"],
              k1_launches=k1, k2_launches=k2,
              dataset_write_s=data_s, profile=probe.profile))
    print(f"cac_train: val mIoU {miou[0]:.4f}, warm steps "
          f"{[round(v) for v in step_ms[1:-1]]} ms", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return path, best


def phase_cac_test(work, config_path, checkpoint, n_voxels=160000):
    """``python -m scenesplat_tpu_torch.test`` on the CAC config with
    cac_train's best checkpoint: the file's SemSegTester (TEST_VIEWS, fragment
    voting of the refined logits) over one synthetic room of 2 n_voxels + 1
    Gaussians, as a user runs it: the room predicted, finite mIoU, the
    seconds (fetch, extract, vote)."""
    t0 = time.perf_counter()
    root = os.path.join(work, "cac_test")
    n_points = write_test_scenes(root, 1, n_voxels, seed=75, semseg=True)
    write_s = time.perf_counter() - t0
    save = os.path.join(work, "cac_test_out")
    reset_k1_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (res,) = test_entry.main(["--config-file", config_path, "--options", f"weight={checkpoint}",
                              f"data.test.data_root={root}", f"test.save_path={save}",
                              views_option(config_path)])
    seconds = time.perf_counter() - t1
    check(fwa.flash_window_attention.launches == 0,
          f"cac_test: {fwa.flash_window_attention.launches} K1 launches on a SpUNet")
    with open(os.path.join(save, "scene_log.json")) as f:
        scenes = json.load(f)
    check(len(scenes) == 1 and scenes[0]["points"] == n_points
          and scenes[0]["fragments"] >= len(TEST_VIEWS),
          f"cac_test: scenes {[(s['name'], s['points'], s['fragments']) for s in scenes]}")
    check(math.isfinite(res["mIoU"]), f"cac_test: mIoU {res['mIoU']}")
    emit(dict(phase="cac_test", model="CAC-v1m1 over SpUNet-v1m1", points_per_scene=n_points,
              views=len(TEST_VIEWS), seconds=seconds, dataset_write_s=write_s, mIoU=res["mIoU"],
              per_scene=scene_split(dict(scenes=scenes))))
    sc = scenes[0]
    print(f"cac_test: {sc['name']} {sc['points']} points, {sc['fragments']} fragments: fetch "
          f"{sc['fetch_s']:.2f} s, extract {sc['extract_s']:.2f} s, vote {sc['vote_s']:.2f} s, "
          f"total {sc['total_s']:.2f} s", flush=True)


def cac_step(model, batch, generator=None):
    """One CAC loss and backward (the model's own four-term loss): (its
    terms, gradients by name on the CPU, each downsample's overflow), and
    the BatchNorm statistics after."""
    out = model(point_from_batch(batch), generator=generator, segment=batch["segment"])
    out["loss"].backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return ({k: out[k].item() for k in CAC_TERMS}, grads, []), stats


def phase_cac_agree(n=49152):
    """CAC-v1m1 over the semseg file's PT-v3m1 (its widths, heads and
    windows, one block a stage, fp32) at ``n`` points of a semseg room: one
    step of the four-term loss with the kernels and with the plain
    attention (losses to 1e-5, each gradient to 1e-4 of its norm or 2.5
    times the noise floor of the kernel step on the points in 3 other
    orders: the refined logits' cos_temp 15 and the normalized prototypes
    carry the kernel's rounding further than semseg's CE does). A tensor's
    bound is the worst tensor's floor, not its own: the serialization
    orders a window's points whatever the input order, so the permutations
    leave the attention's own sums in place and a tensor next to it may
    show no floor of its own. Every step runs under deterministic
    algorithms (warn_only): in their default forms the card's scatter-adds
    sum in an order that changes from run to run, and the kernel's step
    run twice on the same rows moved the encoder's MLP biases by up to
    1.2e-4, as far as the plain step lay and at times over the floor that
    3 runs sample (tools/cac_agree_ties.py); the step then repeats bit for
    bit and the floor and the compared steps are sums in one order. Returns
    its K1 with lse and K2 launches."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4)
    rows = semseg_rows(n, (76,))

    def step(use_kernel, batch_rows=rows):
        batch = cuda_batch(batch_rows)
        model = build_model(cac_model_cfg(dict(backbone, dtype="float32", seed=1,
                                               use_kernel=use_kernel),
                                          cfg.model.backbone_out_channels)).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(12)
        out = model(point_from_batch(batch), generator=gen, segment=batch["segment"])
        out["loss"].backward()
        return ({k: out[k].item() for k in CAC_TERMS},
                {k: p.grad.detach().cpu() for k, p in model.named_parameters()}, [])

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = step(None)
        per, whole = grad_floor(ref, [step(None, permuted_rows(rows, 77 + i))
                                      for i in range(FLOOR_PERMUTATIONS)])
        # the worst floor of the tensors that are not zero in exact arithmetic
        total = torch.linalg.vector_norm(torch.stack([g.norm() for g in ref[1].values()]))
        worst = max(per[k] for k, g in ref[1].items() if g.norm() >= ZERO_GRAD * total)
        floor = (dict.fromkeys(per, worst), whole)
        reset_k1_counts()
        reset_k2_counts()
        compare_train_steps("cac_agree", step, sum(depth_split(backbone)), points=n,
                            floor=floor, deterministic_algorithms=True,
                            model="CAC-v1m1 over the semseg file's PT-v3m1",
                            enc_depths=backbone["enc_depths"], dec_depths=backbone["dec_depths"])
    finally:
        torch.use_deterministic_algorithms(False)
    k1_lse = sum(k1_lse_variants().values())
    k2 = fwa.flash_window_attention_bwd.launches
    check(k1_lse == sum(depth_split(backbone)) and k2 == k1_lse,
          f"cac_agree: K1 with lse {k1_lse}, K2 {k2} launches")
    return dict(k1_lse=k1_lse, k1_lse_variants=k1_lse_variants(), k2=k2,
                k2_variants=dict(fwa.flash_window_attention_bwd.variant_launches))


def ppt_spunet_model_config():
    """PPT-v1m1 over SpUNet-v1m3 as Pointcept's PPT SpUNet files set it
    (the published widths, adaptive and decoupled PDNorm, context 256) with
    the GS files' 14 input channels, the backbone's conditions in the other
    order than the model's (as ppt_train), the ScanNet200 SigLIP2 table's
    rows matched by name, fp32."""
    return dict(type="PPT-v1m1", backbone=dict(
        type="SpUNet-v1m3", in_channels=14, num_classes=0, conditions=PPT_PDNORM_CONDITIONS,
        pd_adaptive=True, context_channels=256, **SPUNET_WIDTHS),
        backbone_out_channels=96, context_channels=256, conditions=PPT_CONDITIONS,
        class_name="builtin:scannet200", class_embedding_path="builtin:scannet200",
        valid_index=valid_index_by_name("builtin:scannet200", (
            "builtin:scannet20", "builtin:scannetpp_top100")))


def phase_ppt_spunet_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6),
                           val_points=40000):
    """ppt_train's run (MultiDatasetTrainer over the same 4 rooms read as
    ScanNetGS and ScanNetPPGS, conditions A A B A A B, one validation room
    a condition) with ppt_spunet_model_config's PPT-v1m1 over SpUNet-v1m3:
    each step's condition, only that condition's norms' statistics moved
    (``bns.{c}`` in the backbone's order), finite losses, no K1 or K2
    launch, each condition's val mIoU; step times, loader waits, peak
    memory, one profiled step."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "rooms")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=77, size_m=room,
                        semseg=True, ppt=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=78,
                        size_m=(2.4, 2.4, 2.0), semseg=True, ppt=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        reset_k2_counts()
        cfg = ppt_train_config(root, os.path.join(tmp, "exp"), 2, loop=steps // 3)
        cfg.model = dict(ppt_spunet_model_config(), criteria=cfg.model["criteria"])
        probes = []

        def before(trainer):
            probes.append(PDNormProbe(trainer.model))
            probes[0].trainer = trainer
            trainer.hooks.append(probes[0])

        trainer, probe, records, k1_counts = run_training(cfg, before=before)
        hist = trainer.storage.history
        losses = hist("loss").values()
        conditions = [r["condition"] for r in records]
        a, b = PPT_CONDITIONS
        check(conditions == [a, a, b] * (steps // 3),
              f"ppt_spunet_train: step conditions {conditions}")
        want_moved = [[PPT_PDNORM_CONDITIONS.index(c)] for c in conditions]
        check(probes[0].moved == want_moved,
              f"ppt_spunet_train: norms of conditions {probes[0].moved} moved, expected "
              f"{want_moved} (the backbone's order)")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"ppt_spunet_train: losses {losses}")
        k1 = k1_counts["train_launches"] + k1_counts["val_launches"]
        k2 = fwa.flash_window_attention_bwd.launches
        check(k1 == k2 == 0, f"ppt_spunet_train: K1 {k1} and K2 {k2} launches on a SpUNet")
        mious = {c: hist(f"val/{c}/mIoU").values() for c in PPT_CONDITIONS}
        check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in mious.values()),
              f"ppt_spunet_train: per-condition val mIoU {mious}")
        step_ms = probe.step_ms()
        emit(dict(phase="ppt_spunet_train", model="PPT-v1m1 over SpUNet-v1m3",
                  widths=SPUNET_WIDTHS, conditions=PPT_CONDITIONS,
                  pdnorm_conditions=PPT_PDNORM_CONDITIONS, batch_size=2,
                  points=cfg.data.num_points, steps=len(losses), step_conditions=conditions,
                  norms_moved=probes[0].moved, loss=losses, grad_norm=hist("grad_norm").values(),
                  cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  val_miou={c: v[0] for c, v in mious.items()},
                  n_overflow_per_stage=[[int(o.max()) for o in r["overflow"]] for r in records],
                  k1_launches=k1, k2_launches=k2, dataset_write_s=data_s,
                  profile=probe.profile))
        print(f"ppt_spunet_train: step conditions {conditions}; val mIoU "
              f"{ {c: round(v[0], 4) for c, v in mious.items()} }", flush=True)
        del trainer
    torch.cuda.empty_cache()


# ---- Point Transformer V2 and V1 -------------------------------------------------

# Pointcept's semseg-pt-v2m2-0-base.py backbone at its published widths, its
# own grid sizes (x3, x2.5, x2.5, x2.5), over the GS files' 14 channels and
# ScanNet-20
PTV2_BACKBONE = dict(
    type="PT-v2m2", in_channels=14, num_classes=20, patch_embed_depth=1,
    patch_embed_channels=48, patch_embed_groups=6, patch_embed_neighbours=8,
    enc_depths=(2, 2, 6, 2), enc_channels=(96, 192, 384, 512), enc_groups=(12, 24, 48, 64),
    enc_neighbours=(16, 16, 16, 16), dec_depths=(1, 1, 1, 1), dec_channels=(48, 96, 192, 384),
    dec_groups=(6, 12, 24, 48), dec_neighbours=(16, 16, 16, 16),
    grid_sizes=(0.06, 0.15, 0.375, 0.9375), attn_qkv_bias=True, pe_multiplier=False,
    pe_bias=True, attn_drop_rate=0.0, drop_path_rate=0.3, unpool_backend="map")
PTV2_STEPS = 3  # 1 + 2
PTV2_BATCH = 2
PTV2_AGREE_POINTS = 4096
# a room whose clusters at the first grid size fit the first pooling, as
# semseg_rows' 2.4 m room does at twice the points
PTV2_AGREE_ROOM = (1.7, 1.7, 1.7)
PTV1_AGREE_POINTS = 4096
FPS_SAMPLES = 2048
# PTv2's and PTv1's gradients that are zero in exact arithmetic (a linear's
# bias ahead of a BatchNorm or of the softmax over the neighbours) keep
# fp32 noise of their sums over every neighbour slot: up to 1.9e-6 of the
# whole gradient in the CPU tests' small steps (tests/test_torch_ptv1.py)
POINT_ZERO_GRAD = 1e-5
# the card's step in this many other orders of the points (a few tenths of
# a second each), one part of card_cpu_agree's noise floor
POINT_FLOOR_RUNS = 3


def ptv2_config(cfg):
    """The semseg file with its model made Pointcept's PT-v2m2 semseg
    model (DefaultSegmentor over PTV2_BACKBONE, the file's CE + Lovasz) and
    task="semseg"; data, optimizer, schedule and hooks as the file sets
    them."""
    cfg.model = dict(type="DefaultSegmentor", backbone=dict(PTV2_BACKBONE),
                     criteria=cfg.model.criteria)
    cfg.task = "semseg"
    return cfg


class KnnProbe:
    """CUDA-event time of every ``ops/pointops.py`` kNN and FPS call on
    the card (the module's functions, wrapped for the block: the models
    and ``interpolation`` look them up there)."""

    def __init__(self):
        self.calls = dict(knn=[], farthest_point_sampling=[])

    @contextlib.contextmanager
    def on(self):
        real = {name: getattr(pointops, name) for name in self.calls}

        def timed(name):
            def call(*args, **kwargs):
                if not args[0].is_cuda:  # a CPU run's call: not timed
                    return real[name](*args, **kwargs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = real[name](*args, **kwargs)
                end.record()
                self.calls[name].append((start, end))
                return out
            return call

        for name in self.calls:
            setattr(pointops, name, timed(name))
        try:
            yield self
        finally:
            for name, fn in real.items():
                setattr(pointops, name, fn)

    def ms(self, name):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.calls[name]]

    def reset(self):
        for v in self.calls.values():
            v.clear()


def path_attention_counts(phase, k1=None):
    """K1's launches since reset_k1_counts (or ``k1``, the phase's own sum
    over runs that reset it) and K2's since reset_k2_counts, checked at 0:
    PTv2 and PTv1 have no window attention."""
    counts = dict(k1=fwa.flash_window_attention.launches if k1 is None else k1,
                  k2=fwa.flash_window_attention_bwd.launches)
    check(counts["k1"] == counts["k2"] == 0,
          f"{phase}: K1 {counts['k1']} and K2 {counts['k2']} launches on a point transformer")
    return counts


def jittered(rows, seed, mm=3.0):
    """``rows`` with each point moved by up to ``mm`` millimetres a
    coordinate: a Gaussian's centre lies anywhere in its 2 cm voxel, and
    on room_scene's exact lattice equal distances tie everywhere (the kNN
    then takes the lower index, so a reordered row is another function)."""
    rng = np.random.default_rng(seed)
    coord = rows["coord"] + rng.uniform(-mm, mm, rows["coord"].shape) * 1e-3
    return dict(rows, coord=coord.astype(np.float32))


def point_queries_agree(phase, coord, mask, k=16, samples=FPS_SAMPLES):
    """kNN (the row itself at ``k``, and FPS's samples as a separate query
    set at 8) and FPS at ``samples`` of each row: the card's indices equal
    the CPU's exactly; returns the card's ms of each."""
    out, ms = {}, {}
    for device in ("cuda", "cpu"):
        c, m = coord.to(device), mask.to(device)
        t0 = time.perf_counter()
        fps, fmask = pointops.farthest_point_sampling(c, m, samples)
        if device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx, _ = pointops.knn(c, m, k)
        q = take_along_points(c, fps)
        qidx, _ = pointops.knn(c, m, 8, query=q, query_mask=fmask)
        if device == "cuda":
            torch.cuda.synchronize()
        ms[device] = dict(fps_ms=(t1 - t0) * 1e3, knn_ms=(time.perf_counter() - t1) * 1e3)
        out[device] = [t.cpu() for t in (fps, fmask, idx, qidx)]
    for name, a, b in zip(("fps", "fps mask", "knn", "knn of a query set"), *out.values()):
        check(torch.equal(a, b), f"{phase}: {name} indices differ between the card and the CPU")
    return ms


def ptv2_step(model, batch, criteria, kw):
    """One fp32 semseg loss and backward: (loss, gradients by name on the
    CPU, each stage's pooling overflow), and the BatchNorm statistics."""
    out = model(point_from_batch(batch), generator=None, **kw)
    loss = criteria(out.feat, batch["segment"], mask=out.mask)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (loss.item(), grads, [int(p.n_overflow.max()) for p in out.plans]), stats


def float64_model(model):
    """``model`` computing in float64, the witness of an fp32 step: its
    parameters and buffers, and each module's compute dtype (its ``dtype``;
    sums, norms and softmaxes follow the input's float64)."""
    model.double()
    for mod in model.modules():
        if getattr(mod, "dtype", None) == torch.float32:
            mod.dtype = torch.float64
    return model


def larger_floor(a, b):
    """The larger of two grad_floor results, tensor by tensor."""
    return {k: max(v, b[0][k]) for k, v in a[0].items()}, max(a[1], b[1])


def card_cpu_agree(phase, cfg, rows, step, other_orders, rounding_whole=None, branches=None,
                   **record):
    """``step(model, batch)`` from the same weights in fp32 on the card and
    on the CPU, in float64 on the CPU (the witness: every module's compute
    dtype and the batch's features; the coordinates stay fp32, so its kNN,
    FPS and pooling plans are the fp32 runs'), and on the card for each
    rows of ``other_orders`` (the same function summed in other orders).
    The card's step is held to the witness by compare_steps: the loss to
    TRAIN_LOSS_RTOL, each gradient to TRAIN_GRAD_RTOL or NOISE_FLOOR_FACTOR
    times its floor, the larger of the other orders' change of the card's
    step and the CPU's fp32 distance from the witness (which every rounding
    moves, the matrix products' own sums too); the BatchNorm statistics to
    STAT_RTOL or that factor times their floor, built the same way. The
    CPU's fp32 step is that second sample of fp32 rounding, not a
    reference: its loss is held to the witness at TRAIN_LOSS_RTOL, its
    distances from the witness and from the card are recorded. With
    ``rounding_whole``, a floor whose whole gradient lies further than that
    (the CPU's step from the witness, or the other orders' from the card's
    step) took another branch of a near tie (a max, an argmax): that is not
    rounding, so it is left out of the gradient and statistics floors, and
    the record says so; with neither left, the bounds are TRAIN_GRAD_RTOL
    and STAT_RTOL. ``branches(name)``, where given, is the context each run
    steps in (StBranches: the card's step records its branches, the others
    replay them). Returns the seconds of each run."""
    base = build_model(copy.deepcopy(cfg))  # every run a copy: one initialization
    runs = [("cuda", rows), ("cpu", rows), ("float64", rows)] + [
        (f"other{i}", r) for i, r in enumerate(other_orders)]
    steps, stats, seconds = {}, {}, {}
    for name, batch_rows in runs:
        model = copy.deepcopy(base)
        where = "cpu" if name in ("cpu", "float64") else "cuda"
        batch = batch_to_device(batch_rows, where)
        if name == "float64":
            float64_model(model)
            batch["feat"] = batch["feat"].double()
        model.to(where).train()
        t0 = time.perf_counter()
        with branches(name) if branches else contextlib.nullcontext():
            steps[name], stats[name] = step(model, batch)
        if where == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        del model
    witness = steps["float64"]
    order_floor = grad_floor(steps["cuda"], [steps[name] for name, _ in runs[3:]])
    cpu_floor = grad_floor(witness, [steps["cpu"]])
    in_floor = {name: rounding_whole is None or f[1] <= rounding_whole
                for name, f in (("other_orders", order_floor), ("cpu", cpu_floor))}
    stat_order = max((rel_l2(stats[name][k], v) for name, _ in runs[3:]
                      for k, v in stats["cuda"].items()), default=0.0)
    stat_witness = {n: max(rel_l2(v, stats["float64"][k]) for k, v in stats[n].items())
                    for n in ("cuda", "cpu")}
    stat_floor = max(stat_order if in_floor["other_orders"] else 0.0,
                     stat_witness["cpu"] if in_floor["cpu"] else 0.0)
    stat_bound = max(STAT_RTOL, NOISE_FLOOR_FACTOR * stat_floor)
    floors = [f for name, f in (("other_orders", order_floor), ("cpu", cpu_floor))
              if in_floor[name]]
    compare_steps(phase, steps["cuda"], witness, names=("card", "float64"),
                  floor=larger_floor(*floors) if len(floors) == 2 else (floors or [None])[0],
                  zero=POINT_ZERO_GRAD,
                  step_s=seconds, stat_worst_rel_l2=stat_witness["cuda"], stat_floor=stat_floor,
                  stat_bound=stat_bound, other_orders_floor_whole=order_floor[1],
                  cpu_to_witness_whole=cpu_floor[1], in_floor=in_floor, **record)
    check(stat_witness["cuda"] <= stat_bound,
          f"{phase}: BatchNorm statistics differ from the float64 witness by "
          f"{stat_witness['cuda']} (bound {stat_bound})")
    whole = math.sqrt(sum(float((g.double() ** 2).sum()) for g in witness[1].values()))
    nonzero = [k for k, g in witness[1].items() if g.norm().item() >= POINT_ZERO_GRAD * whole]
    card_floor = grad_floor(witness, [steps["cuda"]])
    card_cpu = grad_floor(steps["cpu"], [steps["cuda"]])
    cpu_loss_rel = abs(steps["cpu"][0] - witness[0]) / abs(witness[0])
    emit(dict(phase=f"{phase}_witness", loss_float64=witness[0], cpu_loss_rel_diff=cpu_loss_rel,
              card_to_witness_whole=card_floor[1],
              card_to_witness_worst=max(card_floor[0][k] for k in nonzero),
              cpu_to_witness_whole=cpu_floor[1],
              cpu_to_witness_worst=max(cpu_floor[0][k] for k in nonzero),
              in_floor=in_floor, rounding_whole=rounding_whole,
              card_to_cpu_whole=card_cpu[1], card_to_cpu_worst=max(card_cpu[0][k] for k in nonzero),
              other_orders_floor_whole=order_floor[1],
              stat_card_to_witness=stat_witness["cuda"], stat_cpu_to_witness=stat_witness["cpu"],
              stat_other_orders=stat_order, step_s=seconds))
    check(cpu_loss_rel <= TRAIN_LOSS_RTOL,
          f"{phase}: the CPU's fp32 loss differs from the float64 witness by {cpu_loss_rel}")
    return seconds


def phase_ptv2_agree(n=PTV2_AGREE_POINTS):
    """One fp32 train step (CE + Lovasz) of DefaultSegmentor over PT-v2m2
    at its published widths and depths, one row of ``n`` points (a room,
    ``jittered``), on the card against a float64 witness on the CPU from
    the same weights (card_cpu_agree; drop path 0: the card's and the
    CPU's generators draw different streams; the train phase keeps 0.3):
    loss 1e-5, gradients and statistics 1e-4 of their norms or 2.5 times
    their noise floor (the card's step on the row's points in
    POINT_FLOOR_RUNS other orders, the CPU's fp32 step's distance from the
    witness; gradients below POINT_ZERO_GRAD of the whole: zero on both).
    Then PT-v2m1 and PT-v2m3 (adaptive PDNorm, the batch named "S3DIS", a
    [1, 256] context of N(0, 1)) at one block a stage. First the row's kNN
    and FPS indices, card against CPU, exactly. Returns K1's and K2's
    launches (none)."""
    reset_k1_counts()
    reset_k2_counts()
    rows = jittered(semseg_rows(n, (13,), size_m=PTV2_AGREE_ROOM), 14)
    coord, mask = torch.from_numpy(rows["coord"]), torch.from_numpy(rows["mask"])
    query_ms = point_queries_agree("ptv2_agree", coord, mask)
    criteria = build_criteria(Config.fromfile(SEMSEG_CONFIG).model.criteria)
    others = [permuted_rows(rows, 70 + i) for i in range(POINT_FLOOR_RUNS)]
    one_block = dict(enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
    conditions = ("ScanNet", "S3DIS", "Structured3D")
    # a context row of N(0, 1), as PPT's initial table rows
    context = torch.randn(1, 256, generator=torch.Generator().manual_seed(3))
    cases = [
        ("PT-v2m2", dict(type="DefaultSegmentor", backbone=dict(
            PTV2_BACKBONE, drop_path_rate=0.0, seed=1)), {}),
        ("PT-v2m1", dict(PTV2_BACKBONE, type="PT-v2m1", drop_path_rate=0.0, seed=2,
                         **one_block), {}),
        ("PT-v2m3", dict(PTV2_BACKBONE, type="PT-v2m3", drop_path_rate=0.0, seed=3,
                         conditions=conditions, pd_adaptive=True, **one_block),
         dict(condition="S3DIS", context=context)),
    ]
    seconds = {}
    for name, cfg, kw in cases:
        def step(model, batch, kw=kw):
            # the context in the batch's feature dtype (the witness's float64)
            extra = {k: v.to(batch["feat"]) if torch.is_tensor(v) else v for k, v in kw.items()}
            return ptv2_step(model, batch, criteria, extra)

        seconds[name] = card_cpu_agree(
            f"ptv2_agree_{name}", cfg, rows, step, others, points=n, batch_rows=1, model=name,
            depths=(cfg.get("backbone", cfg)["enc_depths"], cfg.get("backbone", cfg)["dec_depths"]))
    counts = path_attention_counts("ptv2_agree")
    emit(dict(phase="ptv2_agree", points=n, point_queries_ms=query_ms, fps_samples=FPS_SAMPLES,
              step_s=seconds, k1_launches=counts["k1"], k2_launches=counts["k2"]))
    return counts


def phase_ptv2_train(work, steps=PTV2_STEPS, batch_size=PTV2_BATCH, scene_points=200000,
                     room=(3.6, 3.6, 2.6), val_points=40000):
    """The semseg trainer on ptv2_config (DefaultSegmentor over PT-v2m2 at
    the published widths, 205,824 points, CE + Lovasz, Mix3D 0.8, the
    file's optimizer and hooks) at ``batch_size`` for ``steps`` steps over
    4 synthetic rooms and one validation room, which PreciseEvaluator's
    SemSegTester also runs: losses, val mIoU, no K1 / K2 launch, pooling
    overflow per stage (none allowed), kNN ms a step, step times, loader
    waits, peak memory, one profiled step. Returns the config file (dumped
    into ``work``) and the best checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "scannet_gs")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=91, size_m=room,
                        semseg=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=92,
                        size_m=(2.4, 2.4, 2.0), semseg=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        reset_k2_counts()
        cfg = ptv2_config(semseg_train_config(root, os.path.join(tmp, "exp"), batch_size, steps,
                                              4))
        knn_probe = KnnProbe()
        with knn_probe.on():
            trainer, probe, records, k1_counts = run_training(cfg)
        knn_ms = knn_probe.ms("knn")
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        check(len(losses) == steps and all(math.isfinite(v) for v in losses + grad_norms),
              f"ptv2_train: losses {losses}, grad norms {grad_norms}")
        counts = path_attention_counts("ptv2_train")
        k1, k2 = counts["k1"], counts["k2"]
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        check(not any(map(any, overflow)) and not any(k1_counts["val_overflow"]),
              f"ptv2_train: pooling overflow {overflow} {k1_counts['val_overflow']}")
        miou = hist("val/mIoU").values()
        check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"ptv2_train: val/mIoU {miou}")
        precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
        check(len(precise) == 1 and len(precise[0].results) == 1,
              "ptv2_train: PreciseEvaluator did not run the file's tester")
        test_miou = precise[0].results[0]["mIoU"]
        check(math.isfinite(test_miou), f"ptv2_train: test mIoU {test_miou}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                 os.path.join(work, "ptv2_model_best.pth"))
        state = torch.load(checkpoint, map_location="cpu", weights_only=False)["state_dict"]
        fresh = build_model({k: v for k, v in dict(cfg.model).items() if k != "criteria"})
        fresh.load_state_dict(state, strict=True)
        # kNN calls a train step: 5 block sequences and 4 decoder ones
        per_step = 1 + len(PTV2_BACKBONE["enc_depths"]) + len(PTV2_BACKBONE["dec_depths"])
        train_knn = knn_ms[:per_step * steps]
        knn_step = [sum(train_knn[i:i + per_step]) for i in range(0, len(train_knn), per_step)]
        step_ms = probe.step_ms()
        sizes = [[(m, v.tolist()) for m, v in r["sizes"]] for r in records]
        emit(dict(phase="ptv2_train", config=SEMSEG_CONFIG,
                  model="DefaultSegmentor over PT-v2m2 (semseg-pt-v2m2-0-base.py)",
                  backbone=PTV2_BACKBONE, task="semseg", batch_size=batch_size,
                  points=cfg.data.num_points, steps=len(losses), loss=losses,
                  grad_norm=grad_norms, lr=hist("lr").values(), cold_step_ms=step_ms[0],
                  warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                  data_wait_s=hist("data_time").values(),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  knn_ms_per_step=knn_step, knn_calls_per_step=per_step,
                  val_miou=miou[0], precise_test_miou=test_miou,
                  n_overflow_per_stage=overflow, stage_slots_valid=sizes,
                  k1_launches=k1, k2_launches=k2, dataset_write_s=data_s,
                  profile=probe.profile))
        print(f"ptv2_train: warm steps {[round(v) for v in step_ms[1:-1]]} ms, kNN "
              f"{[round(v, 1) for v in knn_step]} ms a step, val mIoU {miou[0]:.4f}", flush=True)
        config_path = os.path.join(work, "ptv2_semseg.py")
        cfg.dump(config_path)
        del trainer, fresh
    torch.cuda.empty_cache()
    return config_path, checkpoint, counts


def sorted_room_test(work, phase, config_label, config_path, checkpoint, n_voxels, seed, sorts,
                     extra=lambda fragments: {}):
    """The test entry point on a semseg train phase's config and checkpoint
    (SemSegTester, TEST_VIEWS of the file's views, fragment voting) over one synthetic
    room of 2 ``n_voxels`` + 1 Gaussians, through run_test_entry: torch.sort
    and K3 under deterministic algorithms (equal predictions and metrics; K3
    ``sorts`` times a fragment forward with the switch on, none off; no K1
    or K2), then as a user runs it, for the seconds per room. ``extra``
    (the fragment forwards of one run) makes the caller's own checks of the
    runs and returns what they add to the phase's record. Returns the K3
    run's sort calls, kernel launches and fragment forwards, and K1's and
    K2's launches."""
    t0 = time.perf_counter()
    reset_k2_counts()
    data_root = os.path.join(work, phase)
    n_points = write_test_scenes(data_root, 1, n_voxels, seed=seed, semseg=True)
    write_s = time.perf_counter() - t0
    runs = run_test_entry(work, phase, [
        "--config-file", config_path, "--options", f"weight={checkpoint}",
        f"data.test.data_root={data_root}", views_option(config_path)],
        WindowCalls(limit=0, max_window=1024))
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    for key, pred in off["preds"].items():
        check(pred.shape == (n_points,), f"{phase}: {key} {pred.shape}")
        check(np.array_equal(pred, on["preds"][key]),
              f"{phase}: {key}: predictions differ with the sort switch on")
    for key, value in off["res"].items():
        check(np.array_equal(value, on["res"][key]),
              f"{phase}: metric {key} differs with the sort switch on")
    fragments = sum(sc["fragments"] for sc in on["scenes"])
    check(fragments >= len(TEST_VIEWS),
          f"{phase}: {fragments} fragments for {len(TEST_VIEWS)} views")
    check(off["sort_calls"] == timed["sort_calls"] == 0 and on["sort_calls"] == sorts * fragments
          and on["sort_kernels"] > 0,
          f"{phase}: K3 {off['sort_calls']}, {on['sort_calls']} ({on['sort_kernels']} kernels) "
          f"and {timed['sort_calls']} sorts, expected {sorts} a fragment forward with the "
          "switch on only")
    counts = path_attention_counts(phase, k1=sum(r["k1"] for r in runs.values()))
    check(np.isfinite(off["res"]["mIoU"]), f"{phase}: mIoU {off['res']['mIoU']}")
    emit(dict(phase=phase, config=config_label, dtype="float32",
              scenes=1, points_per_scene=n_points, views=len(TEST_VIEWS), fragments=fragments,
              dataset_write_s=write_s,
              switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                              per_scene=scene_split(off)),
              switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                             per_scene=scene_split(on), sort_calls=on["sort_calls"],
                             sort_kernel_launches=on["sort_kernels"]),
              as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                                     seconds=timed["seconds"], per_scene=scene_split(timed),
                                     mIoU=timed["res"]["mIoU"]),
              predictions_equal=True, mIoU=off["res"]["mIoU"], **extra(fragments)))
    for sc in scene_split(timed):
        print(f"{phase}: {sc['name']} {sc['points']} points, {sc['fragments']} fragments: "
              f"fetch {sc['fetch_s']:.2f} s, extract {sc['extract_s']:.2f} s, vote "
              f"{sc['vote_s']:.2f} s, total {sc['total_s']:.2f} s", flush=True)
    return dict(sort_calls=on["sort_calls"], sort_kernels=on["sort_kernels"],
                fragments=fragments), counts


def phase_ptv2_test(work, config_path, checkpoint, n_voxels=160000):
    """sorted_room_test on ptv2_train's config and checkpoint: K3 once for
    each of the 4 grid poolings' serializations of every fragment
    forward."""
    return sorted_room_test(work, "ptv2_test", "semseg file with ptv2_config", config_path,
                            checkpoint, n_voxels, 93, len(PTV2_BACKBONE["enc_depths"]))


def swapped_rows(rows):
    """``rows`` in the other row order: every batch sum adds in another
    order, the FPS of each row (which starts at its first point) is
    unchanged."""
    return {k: np.ascontiguousarray(v[::-1]) for k, v in rows.items()}


def permuted_after_first(rows, seed):
    """permuted_rows with each row's first point kept first: FPS starts
    there and, with no ties, takes the same points in the same order, so
    the step is the same function summed in other orders."""
    rng = np.random.default_rng(seed)
    b, n = rows["mask"].shape
    perm = np.stack([np.concatenate([[0], 1 + rng.permutation(n - 1)]) for _ in range(b)])
    return {k: np.take_along_axis(v, perm.reshape(perm.shape + (1,) * (v.ndim - 2)), 1)
            for k, v in rows.items()}


def phase_ptv1_agree(n=PTV1_AGREE_POINTS):
    """One fp32 train step (CE + Lovasz) of DefaultSegmentor over
    PointTransformer-Seg50 at its published widths, 2 rows of ``n``
    points (rooms, ``jittered``), the card against a float64 witness on the
    CPU (card_cpu_agree: loss 1e-5, gradients and statistics 1e-4 or 2.5
    times the noise floor, the CPU's fp32 distance from the witness or the
    card's step on the rows swapped and on the points but the first in
    POINT_FLOOR_RUNS - 1 other orders); the FPS calls' ms on the card; then
    one eval forward each of Cls38 (logits [2, 13]) and PartSeg26 (each
    row's shape category) on both, 1e-4 of the output's scale. Returns
    K1's and K2's launches (none)."""
    reset_k1_counts()
    reset_k2_counts()
    fps_launches = fps_ops.farthest_point_sampling_cuda.launches
    rows = jittered(semseg_rows(n, (31, 32)), 33)
    criteria = build_criteria(Config.fromfile(SEMSEG_CONFIG).model.criteria)
    cfg = dict(type="DefaultSegmentor", backbone=dict(
        type="PointTransformer-Seg50", in_channels=14, num_classes=20, seed=5))
    probe = KnnProbe()
    with probe.on():
        seconds = card_cpu_agree(
            "ptv1_agree", cfg, rows, lambda m, b: ptv2_step(m, b, criteria, {}),
            [swapped_rows(rows)] + [permuted_after_first(rows, 80 + i)
                                    for i in range(POINT_FLOOR_RUNS - 1)],
            points=n, batch_rows=2, model="PointTransformer-Seg50")
    fps_ms = probe.ms("farthest_point_sampling")
    knn_ms = probe.ms("knn")
    forwards = {}
    for name, cfg_m, kw in (
            ("PointTransformer-Cls38", dict(type="PointTransformer-Cls38", in_channels=17,
                                            num_classes=13, seed=6), {}),
            ("PointTransformer-PartSeg26", dict(type="PointTransformer-PartSeg26",
                                                in_channels=14, num_classes=8,
                                                num_shape_classes=4, seed=7),
             dict(cls_token=torch.tensor([3, 1])))):
        base = build_model(dict(cfg_m))  # both runs a copy: one initialization
        outs = {}
        for device in ("cuda", "cpu"):
            model = copy.deepcopy(base)
            model.to(device).eval()
            point = point_from_batch(batch_to_device(rows, device))
            with torch.no_grad():
                out = model(point, **{k: v.to(device) for k, v in kw.items()})
            out = getattr(out, "feat", out)
            outs[device] = out.cpu()
        check(torch.isfinite(outs["cuda"]).all().item(), f"ptv1_agree: {name} not finite")
        err = ((outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
        check(err <= SPUNET_FWD_RTOL, f"ptv1_agree: {name} forward differs by {err}")
        forwards[name] = dict(shape=list(outs["cuda"].shape), max_rel_err=err)
    counts = path_attention_counts("ptv1_agree")
    fps_launches = fps_ops.farthest_point_sampling_cuda.launches - fps_launches
    # the FPS kernel serves PTv1's transitions: 4 a forward on the card
    check(fps_launches >= 4 * (1 + POINT_FLOOR_RUNS),
          f"ptv1_agree: {fps_launches} FPS kernel launches")
    emit(dict(phase="ptv1_agree_forwards", points=n, rows=2, forwards=forwards,
              fps_kernel_launches=fps_launches,
              fwd_rtol=SPUNET_FWD_RTOL, step_s=seconds,
              fps_ms_per_call=fps_ms, fps_calls=len(fps_ms),
              fps_samples=[n // 4 ** s for s in range(1, 5)], knn_ms_per_call=knn_ms,
              timed_runs=f"the card's step and its {POINT_FLOOR_RUNS} floor steps, 4 FPS "
                         "calls each", k1_launches=counts["k1"], k2_launches=counts["k2"]))
    print(f"ptv1_agree: FPS {[round(v, 1) for v in fps_ms]} ms a call", flush=True)
    return counts


def ppt_ptv2_model_config():
    """PPT-v1m1 over PT-v2m3 at the published PT-v2m2 widths (adaptive,
    decoupled PDNorm, context 256; the backbone's conditions in the other
    order than the model's, as ppt_train), its features 48 wide, the
    ScanNet200 SigLIP2 table's rows matched by name, fp32."""
    backbone = dict(PTV2_BACKBONE, type="PT-v2m3", num_classes=0,
                    conditions=PPT_PDNORM_CONDITIONS, pd_adaptive=True, context_channels=256)
    return dict(type="PPT-v1m1", backbone=backbone,
                backbone_out_channels=PTV2_BACKBONE["dec_channels"][0], context_channels=256,
                conditions=PPT_CONDITIONS, class_name="builtin:scannet200",
                class_embedding_path="builtin:scannet200",
                valid_index=valid_index_by_name("builtin:scannet200", (
                    "builtin:scannet20", "builtin:scannetpp_top100")))


def phase_ppt_ptv2_train(work, steps=6, batch_size=PTV2_BATCH, scene_points=200000,
                         room=(3.6, 3.6, 2.6), val_points=40000):
    """ppt_train's run (MultiDatasetTrainer, 4 rooms read as ScanNetGS and
    ScanNetPPGS, conditions A A B A A B, one validation room a condition)
    with ppt_ptv2_model_config's PPT-v1m1 over PT-v2m3: each step's
    condition, only that condition's PDNorm statistics moved (in the
    backbone's order), finite losses, no K1 or K2 launch, no pooling
    overflow, each condition's val mIoU; step times, loader waits, peak
    memory, one profiled step."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "rooms")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=94, size_m=room,
                        semseg=True, ppt=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=95,
                        size_m=(2.4, 2.4, 2.0), semseg=True, ppt=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        reset_k2_counts()
        cfg = ppt_train_config(root, os.path.join(tmp, "exp"), batch_size, loop=steps // 3)
        cfg.model = dict(ppt_ptv2_model_config(), criteria=cfg.model["criteria"])
        probes = []

        def before(trainer):
            probes.append(PDNormProbe(trainer.model))
            probes[0].trainer = trainer
            trainer.hooks.append(probes[0])

        trainer, probe, records, k1_counts = run_training(cfg, before=before)
        hist = trainer.storage.history
        losses = hist("loss").values()
        conditions = [r["condition"] for r in records]
        a, b = PPT_CONDITIONS
        check(conditions == [a, a, b] * (steps // 3),
              f"ppt_ptv2_train: step conditions {conditions}")
        want_moved = [[PPT_PDNORM_CONDITIONS.index(c)] for c in conditions]
        check(probes[0].moved == want_moved,
              f"ppt_ptv2_train: norms of conditions {probes[0].moved} moved, expected "
              f"{want_moved} (the backbone's order)")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"ppt_ptv2_train: losses {losses}")
        counts = path_attention_counts("ppt_ptv2_train")
        k1, k2 = counts["k1"], counts["k2"]
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        check(not any(map(any, overflow)), f"ppt_ptv2_train: pooling overflow {overflow}")
        mious = {c: hist(f"val/{c}/mIoU").values() for c in PPT_CONDITIONS}
        check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in mious.values()),
              f"ppt_ptv2_train: per-condition val mIoU {mious}")
        step_ms = probe.step_ms()
        emit(dict(phase="ppt_ptv2_train", model="PPT-v1m1 over PT-v2m3",
                  backbone=cfg.model["backbone"], conditions=PPT_CONDITIONS,
                  pdnorm_conditions=PPT_PDNORM_CONDITIONS, batch_size=batch_size,
                  points=cfg.data.num_points, steps=len(losses), step_conditions=conditions,
                  norms_moved=probes[0].moved, loss=losses, grad_norm=hist("grad_norm").values(),
                  cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  val_miou={c: v[0] for c, v in mious.items()}, n_overflow_per_stage=overflow,
                  k1_launches=k1, k2_launches=k2, dataset_write_s=data_s,
                  profile=probe.profile))
        print(f"ppt_ptv2_train: step conditions {conditions}; val mIoU "
              f"{ {c: round(v[0], 4) for c, v in mious.items()} }", flush=True)
        del trainer
    torch.cuda.empty_cache()
    return counts


# The sparse-conv backbones at their published widths, each the semseg
# file's model as a v1 DefaultSegmentor (sparse_config): MinkUNet34C, the
# variant of Pointcept's ScanNet MinkUNet recipe; SPVCNN, OACNNs and
# OctFormer-v1m1 at their class defaults (OctFormer: channels 96/192/384/
# 384, blocks 2/2/18/2, heads 6/12/24/24, windows of 26, dilation 4, FPN
# 168, drop path 0.5)
SPARSE_BACKBONES = dict(
    mink=dict(type="MinkUNet34C", in_channels=14, out_channels=TRAIN_CLASSES),
    spvcnn=dict(type="SPVCNN", in_channels=14, out_channels=TRAIN_CLASSES),
    oacnns=dict(type="OACNNs", in_channels=14, num_classes=TRAIN_CLASSES),
    octformer=dict(type="OctFormer-v1m1", in_channels=14, num_classes=TRAIN_CLASSES))
# the agree phases' training randomness off (the card's and the CPU's
# generators draw different streams): OctFormer's drop path at 0 and
# SPVCNN's fixed dropout replaced by the identity (spvcnn_dropout_off);
# octformer_agree checks drop path's per-scene draw apart
SPARSE_AGREE_OFF = dict(octformer=dict(drop_path=0.0))
# each agree phase's row: its points and a cube room whose 2 cm shell (the
# floor and four walls: 12,500 voxels at 1 m, 24,500 at 1.4 m) the row
# fills to two thirds, so that each stride-2 pooling at least halves it (as
# the capacities assume). OctFormer keeps 16,384: at 8,192 in 1 m its
# card step lay 2.27e-3 from the float64 witness at one attention bias,
# over 2.5 times that row's floor (2.25e-3)
SPARSE_AGREE_ROWS = dict(mink=(8192, 1.0), spvcnn=(8192, 1.0), oacnns=(8192, 1.0),
                         octformer=(16384, 1.4))
SPARSE_STEPS = 3  # 1 + 2: one warm step and the profiled one
# sort_int64 calls of one MinkUNet forward: the z-serialization, the k=5
# stem plan and each of the 4 pooled levels' k=3 plan
MINK_SORTS = 6
# ocnn's leaves clip cells to [0, 2**11): a point beyond +-10.24 m of the
# room's centre (CenterShift's origin) would merge with the boundary's
OCTREE_HALF_M = 10.24


def sparse_config(cfg, name):
    """The semseg file with its model a DefaultSegmentor over
    SPARSE_BACKBONES[name] (the file's CE + Lovasz) and task="semseg";
    data, optimizer, schedule and hooks as the file sets them."""
    cfg.model = dict(type="DefaultSegmentor", backbone=dict(SPARSE_BACKBONES[name]),
                     criteria=cfg.model.criteria)
    cfg.task = "semseg"
    return cfg


@contextlib.contextmanager
def spvcnn_dropout_off():
    """SPVCNN's dropout (the reference's fixed 0.3) as the identity for the
    block."""
    import scenesplat_tpu_torch.models.spvcnn as spvcnn

    kept = spvcnn.dropout
    spvcnn.dropout = lambda x, p, generator: x
    try:
        yield
    finally:
        spvcnn.dropout = kept


def check_drop_path_by_scene(phase, rows=8, n=4096, p=0.5):
    """OctFormer's drop path on the card (a CUDA generator): each scene's
    branch kept whole (scaled by 1 / (1 - p)) or dropped whole."""
    from scenesplat_tpu_torch.models.octformer import drop_path

    x = torch.rand(rows, n, 96, device="cuda") + 1.0
    y = drop_path(x, p, torch.Generator(device="cuda").manual_seed(5))
    kept = (y == x / (1 - p)).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    check(bool((kept ^ dropped).all()), f"{phase}: drop path split a scene")
    return dict(rows=rows, kept=int(kept.sum()), dropped=int(dropped.sum()), rate=p)


def phase_sparse_agree(name, seed=21):
    """One fp32 semseg train step (CE + Lovasz) of DefaultSegmentor over
    SPARSE_BACKBONES[name] at its published widths, one row of
    SPARSE_AGREE_ROWS[name]'s points (a room, ``jittered``: OctFormer's
    ocnn leaves read the coordinates), on the card against a float64
    witness on the CPU from the same weights (card_cpu_agree, the floor of
    POINT_FLOOR_RUNS other orders and of the CPU's fp32 step), dropout and
    drop path off; for OctFormer also drop path's per-scene draw on the
    card. Returns K1's and K2's launches (none)."""
    reset_k1_counts()
    reset_k2_counts()
    n, room = SPARSE_AGREE_ROWS[name]
    rows = jittered(semseg_rows(n, (seed,), size_m=(room,) * 3), seed + 1)
    criteria = build_criteria(Config.fromfile(SEMSEG_CONFIG).model.criteria)
    backbone = dict(SPARSE_BACKBONES[name], seed=3, **SPARSE_AGREE_OFF.get(name, {}))
    if name == "octformer":
        # the first stem pool takes the 1 cm leaves to 2 cm cells, about one
        # point each in 2 cm rows: the default capacity of 0.7 of the slots
        # drops clusters there (the train phase reports it), which the
        # compared steps may not; two blocks a stage (its dilated second
        # block kept), where the published third stage has 18, for the
        # CPU steps' time
        backbone.update(stage_capacity=(1.0, 0.5, 0.25, 0.125, 0.0625), num_blocks=(2, 2, 2, 2))
    cfg = dict(type="DefaultSegmentor", backbone=backbone)
    others = [permuted_rows(rows, 80 + i) for i in range(POINT_FLOOR_RUNS)]
    with spvcnn_dropout_off() if name == "spvcnn" else contextlib.nullcontext():
        seconds = card_cpu_agree(f"{name}_agree", cfg, rows,
                                 lambda m, b: ptv2_step(m, b, criteria, {}), others, points=n,
                                 batch_rows=1, model=backbone["type"])
    extra = dict(drop_path=check_drop_path_by_scene(f"{name}_agree")) if name == "octformer" else {}
    counts = path_attention_counts(f"{name}_agree")
    emit(dict(phase=f"{name}_agree", model=backbone["type"], points=n, step_s=seconds,
              k1_launches=counts["k1"], k2_launches=counts["k2"], **extra))
    return counts


def write_sparse_rooms(tmp, scene_points=200000, room=(3.6, 3.6, 2.6), val_points=40000):
    """The sparse train phases' 4 training rooms and one validation room
    (written once for the four)."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "sparse_rooms")
    write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=96, size_m=room,
                    semseg=True)
    write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=97, size_m=(2.4, 2.4, 2.0),
                    semseg=True)
    return root, time.perf_counter() - t0


def phase_sparse_train(work, name, root, data_s, steps=SPARSE_STEPS, batch_size=2):
    """The semseg trainer on sparse_config(name) (the published widths,
    batch 2, the file's 205,824 points, CE + Lovasz, Mix3D 0.8, optimizer
    and hooks but PreciseEvaluator; the evaluator and the saver only for
    mink, whose checkpoint mink_test reads) for ``steps`` steps over
    write_sparse_rooms' rooms: finite losses, mink's val mIoU and best
    checkpoint, no K1 or K2 launch, each downsample's clusters against its capacity (n_overflow,
    reported), step times, loader waits, peak memory, one profiled step
    (the idle share); OctFormer's batches inside its octree. Returns the
    config file (dumped into ``work``), the best checkpoint and the
    attention counts."""
    with tempfile.TemporaryDirectory() as tmp:
        reset_k1_counts()
        reset_k2_counts()
        cfg = sparse_config(semseg_train_config(root, os.path.join(tmp, "exp"), batch_size,
                                                steps, 4), name)
        # mink_test reads mink_train's best checkpoint; the other three
        # train without the evaluator and the saver (the time limit)
        dropped = ("PreciseEvaluator",) if name == "mink" else (
            "PreciseEvaluator", "SemSegEvaluator", "CheckpointSaver")
        cfg.hooks = [h for h in cfg.hooks if h["type"] not in dropped]
        coords = []

        def before(trainer):
            forward = trainer.model.forward

            def watched(point, generator=None, **kwargs):
                if trainer.model.training:
                    coords.append(float(point.coord[point.mask].abs().max()))
                return forward(point, generator=generator, **kwargs)

            trainer.model.forward = watched

        trainer, probe, records, _ = run_training(cfg, before=before)
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        check(len(losses) == steps and all(math.isfinite(v) for v in losses + grad_norms),
              f"{name}_train: losses {losses}, grad norms {grad_norms}")
        counts = path_attention_counts(f"{name}_train")
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        capacity = [[m for m, _ in r["sizes"][1:]] for r in records]
        clusters = [[int(v.max()) for _, v in r["sizes"][1:]] for r in records]
        if name == "octformer":
            check(len(coords) == steps and max(coords) < OCTREE_HALF_M,
                  f"octformer_train: |coordinates| up to {max(coords)} m, the octree holds "
                  f"+-{OCTREE_HALF_M}")
        miou, checkpoint = hist("val/mIoU").values() if name == "mink" else [None], None
        if name == "mink":
            check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"{name}_train: val/mIoU {miou}")
            model_dir = os.path.join(trainer.cfg.save_path, "model")
            checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                     os.path.join(work, f"{name}_model_best.pth"))
            state = torch.load(checkpoint, map_location="cpu", weights_only=False)["state_dict"]
            trainer.model.load_state_dict(state, strict=True)  # name for name
        step_ms = probe.step_ms()
        emit(dict(phase=f"{name}_train", config=SEMSEG_CONFIG,
                  model=f"DefaultSegmentor over {SPARSE_BACKBONES[name]['type']}",
                  backbone=SPARSE_BACKBONES[name], task="semseg", batch_size=batch_size,
                  points=cfg.data.num_points, steps=len(losses), loss=losses,
                  grad_norm=grad_norms, cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  idle_share=probe.profile["idle_share"], val_miou=miou[0],
                  n_overflow_per_pool=overflow, pool_capacity=capacity,
                  pool_clusters_max_row=clusters, coord_abs_max_m=coords,
                  k1_launches=counts["k1"], k2_launches=counts["k2"], dataset_write_s=data_s,
                  profile=probe.profile))
        print(f"{name}_train: warm steps {[round(v) for v in step_ms[1:-1]]} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, idle share "
              f"{probe.profile['idle_share']:.3f}, overflow {overflow}", flush=True)
        config_path = os.path.join(work, f"{name}_semseg.py")
        cfg.dump(config_path)
        del trainer
    torch.cuda.empty_cache()
    return config_path, checkpoint, counts


def phase_mink_test(work, config_path, checkpoint, n_voxels=160000):
    """sorted_room_test on mink_train's config and checkpoint: K3
    MINK_SORTS times a fragment forward."""
    return sorted_room_test(work, "mink_test", "semseg file with sparse_config('mink')",
                            config_path, checkpoint, n_voxels, 98, MINK_SORTS)


def sparse_phases(work, root, data_s):
    """The sparse-conv backbones' phases, in order: each one's agree, the
    four train phases over write_sparse_rooms' rooms (``root``), then
    mink_test. Returns K1's and K2's counts by phase and mink_test's
    sorts."""
    counts = {f"{name}_agree": phase_sparse_agree(name) for name in SPARSE_BACKBONES}
    trained = {}
    for name in SPARSE_BACKBONES:
        *trained[name], counts[f"{name}_train"] = phase_sparse_train(work, name, root, data_s)
    sorts, counts["mink_test"] = phase_mink_test(work, *trained["mink"], n_voxels=50000)
    return counts, sorts


# ---- Stratified Transformer ------------------------------------------------------

# ST-v1m2 at the JAX module's (the reference v1m2's) default widths: channels
# 48 to 384, heads 6/12/24/24, depths 3/9/3/3, windows of 0.2 to 1.6 m with
# their RPE tables, the KPConv stem, drop path 0.2
ST_BACKBONE = dict(type="ST-v1m2", in_channels=14, num_classes=TRAIN_CLASSES)
ST_AGREE_POINTS = 4096
# st_agree's rows: semseg_rows' two room seeds and jittered's seed
ST_AGREE_SEEDS = (41, 42, 43)
# fp32 rounding moves ST's whole gradient by 6.2e-7 to 7.5e-7 from the
# float64 witness when both take the same branches (StBranches); a floor
# further than this is not rounding
ST_ROUNDING_WHOLE = 1e-5
# a branch of the card's that the float64 witness would not take (StBranches)
# must lie this near its tie, as a share of its tensor's RMS: the fp32
# steps' such branches lay 3e-7 to 2.3e-6 of it from their ties
ST_NEAR_TIE = 1e-4
# sort_int64 calls of one ST forward: each of the 4 stages' fine and coarse
# window tables, unshifted and shifted (window_members)
ST_SORTS = 16
# FPS calls of one ST forward: the stem's transition down, then each stage's
# samples (its stratified key set and its transition down share them)
ST_FPS_CALLS = 5
ST_DOWN_RATIO = 0.25
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 rate outside the tensor cores
# a valid point's work in one FPS step: 3 differences, 3 products, 2 sums,
# the minimum and the argmax's comparison
FPS_OPS_PER_POINT = 10


def st_config(cfg):
    """The semseg file with its model a DefaultSegmentor over ST_BACKBONE
    (the file's CE + Lovasz) and task="semseg"; data, optimizer, schedule
    and hooks as the file sets them."""
    cfg.model = dict(type="DefaultSegmentor", backbone=dict(ST_BACKBONE),
                     criteria=cfg.model.criteria)
    cfg.task = "semseg"
    return cfg


def fps_bound_ms(m, n_valid, n):
    """The least time of one row set's FPS: M steps over the valid points'
    operations at the fp32 rate, or the bytes (coordinates and mask read
    once, the ids written once) at the memory rate; and which bounds it."""
    ops = sum(mm * nv for mm, nv in zip(m, n_valid)) * FPS_OPS_PER_POINT
    nbytes = sum(nn * 13 for nn in n) + sum(mm * 8 for mm in m)
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def fps_levels(coord, mask, depth, samples, reps=3):
    """The FPS calls of a chain of levels, each the previous one's samples
    (``samples(n)`` of a level of n slots, the valid ones
    ``samples(n_valid)`` as a transition down keeps them): for each, the
    level's coordinates, mask and the kernel's ids, checked bit-equal to the
    plain loop's on the card, the two's CUDA-event ms, the kernel's blocks a
    row, whether a row spills past them and the kernel's us a step."""
    out = []
    for _ in range(depth):
        b, n = mask.shape
        m = samples(n)
        kernel_ms = cuda_ms(lambda: pointops.farthest_point_sampling(coord, mask, m), reps=reps,
                            warmup=1)
        ids, _ = pointops.farthest_point_sampling(coord, mask, m)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = pointops.farthest_point_sampling_reference(coord, mask, m)
        end.record()
        torch.cuda.synchronize()
        check(torch.equal(ids, plain), f"fps_kernel: ids differ from the plain loop at {n} "
              f"slots, {m} samples")
        n_valid = [int(v) for v in mask.sum(1)]
        out.append(dict(rows=b, slots=n, samples=m, valid=n_valid, ms=kernel_ms,
                        plain_ms=start.elapsed_time(end), blocks=fps_ops.blocks_per_row(n),
                        spills=fps_ops.spills(n), us_per_step=kernel_ms * 1e3 / m))
        keep = torch.tensor([samples(v) for v in n_valid], device=coord.device)
        coord = take_along_points(coord, ids)
        mask = torch.arange(m, device=coord.device) < keep.clamp(max=m)[:, None]
    return out


def fps_level_sets():
    """name -> (coord, mask, levels, samples) of the FPS kernel's row sets:
    ST's train rows (2 rows of the semseg file's 205,824 slots, one of a
    room's lattice voxels, where distances tie everywhere, the other
    jittered by 3 mm with a padding tail of 40,000 slots and its first 5
    slots masked; each level the previous one's int(n / 4) + 1 samples, as
    ST's transition downs take them), PTv1's (ptv1_agree's 2 rows of
    PTV1_AGREE_POINTS, n // 4 a level) and PartSeg50's (one object of
    PARTSEG_POINTS, as partseg_test's forwards take them)."""
    n = 205824
    rows = semseg_rows(n, (61, 62), size_m=(5.0, 5.0, 3.0))
    rows = dict(rows, coord=np.stack([rows["coord"][0], jittered(rows, 63)["coord"][1]]))
    coord = torch.from_numpy(rows["coord"]).cuda()
    mask = torch.ones(2, n, dtype=torch.bool, device="cuda")
    mask[1, :5] = False
    mask[1, n - 40000:] = False
    p1 = torch.from_numpy(jittered(semseg_rows(PTV1_AGREE_POINTS, (31, 32)), 33)["coord"]).cuda()
    obj = shape_object(0, SHAPE_PARTS[0][1], PARTSEG_POINTS, 700)[0]
    obj = torch.from_numpy(obj.astype(np.float32))[None].cuda()

    def ptv1_samples(v):
        return max(1, v // 4)

    return dict(st=(coord, mask, ST_FPS_CALLS, lambda v: int(v * ST_DOWN_RATIO) + 1),
                ptv1=(p1, torch.ones(p1.shape[:2], dtype=torch.bool, device="cuda"), 4,
                      ptv1_samples),
                partseg=(obj, torch.ones(obj.shape[:2], dtype=torch.bool, device="cuda"), 4,
                         ptv1_samples))


def fps_sums(levels):
    """A row set's sums over its levels: kernel and plain ms, the bound and
    what bounds it, M a level, and the levels."""
    bound, by = fps_bound_ms([lv["samples"] for lv in levels],
                             [sum(lv["valid"]) for lv in levels],
                             [lv["slots"] * lv["rows"] for lv in levels])
    return dict(ms=sum(lv["ms"] for lv in levels), plain_ms=sum(lv["plain_ms"] for lv in levels),
                bound_ms=bound, bound_by=by, samples=[lv["samples"] for lv in levels],
                levels=levels)


def fps_record(r):
    """A row set's sums as the kernels line gives them: M, the times and
    the bound, and each level's blocks a row and us a step."""
    return dict(samples=r["samples"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], blocks=[lv["blocks"] for lv in r["levels"]],
                us_per_step=[lv["us_per_step"] for lv in r["levels"]])


def phase_fps_kernel():
    """The FPS kernel against its plain loop on the card, ids bit-equal, at
    fps_level_sets' levels (ST's 5, PTv1's 4, PartSeg50's 4); each call's
    kernel and plain times by CUDA events, its blocks a row and us a step,
    and the bound: the valid points' operations of the M steps at the fp32
    rate. Returns each set's sums."""
    fps_launches = fps_ops.farthest_point_sampling_cuda.launches
    result = {name: fps_sums(fps_levels(*args)) for name, args in fps_level_sets().items()}
    emit(dict(phase="fps_kernel", ids_equal=True, max_abs_err=0,
              phase_launches=fps_ops.farthest_point_sampling_cuda.launches - fps_launches,
              **result))
    for name, r in result.items():
        by_level = [(lv["blocks"], lv["spills"], round(lv["us_per_step"], 3))
                    for lv in r["levels"]]
        print(f"fps_kernel: {name} {r['ms']:.2f} ms a forward (M = {r['samples']}) against a "
              f"bound of {r['bound_ms']:.4f} ms ({r['bound_by']}); plain loop "
              f"{r['plain_ms']:.1f} ms; by level, blocks a row, spilled, us a step: {by_level}",
              flush=True)
    return result


class StBranches:
    """The branches of ST's step that fp32 rounding can tip: at every value
    of each leaky_relu and relu, x > 0 or not, and of each transition's
    max over its neighbours (neighbour_max), the argmax. A single value on
    the other side of a kink moves the stem's gradients by 1e-4 to 2e-3 of
    their norm, up to three orders more than fp32 rounding moves them, and on
    most rows of thousands of points some value lies within rounding of
    its kink, so a step that takes its own branches is compared with one
    that may take others. Called with a run's name (card_cpu_agree), it
    gives the context the run steps in: the card's step ("cuda") records
    its branches; every other run replays them ("other" runs, the rows
    swapped, with them swapped too), so the float64 witness, the CPU's
    fp32 step and the swapped rows' step compute the card's branch of the
    function and differ from the card's step by rounding alone. The
    witness audits the card's branches against its own: each one it would
    not take must be a near tie, its float64 margin (|x| at a kink, the
    gap below the neighbours' own max) at most ST_NEAR_TIE of that
    tensor's RMS, so a card that takes a clear branch otherwise fails."""

    def __init__(self):
        self.taken, self.pos, self.replay, self.flip, self.audit = [], 0, False, False, False
        self.decisions, self.differ, self.worst = 0, 0, 0.0

    def __call__(self, name):
        return self._run(replay=name != "cuda", flip=name.startswith("other"),
                         audit=name == "float64")

    @contextlib.contextmanager
    def _run(self, replay, flip, audit):
        self.replay, self.flip, self.audit, self.pos = replay, flip, audit, 0
        if not replay:
            self.taken = []
        saved = stratified.F, stratified.neighbour_max
        functional = types.SimpleNamespace(**vars(torch.nn.functional))
        functional.leaky_relu, functional.relu = self.leaky_relu, self.relu
        stratified.F = functional
        stratified.neighbour_max = lambda g, kidx: self.neighbour_max(g, kidx, saved[1])
        try:
            yield
        finally:
            stratified.F, stratified.neighbour_max = saved
        check(self.pos == (len(self.taken) if replay else 0),
              f"st_agree: a replayed step took {self.pos} of the card's "
              f"{len(self.taken)} branch points")
        if audit:
            check(self.worst <= ST_NEAR_TIE,
                  f"st_agree: the card took a branch {self.worst} of its tensor's RMS from "
                  f"the float64 witness's own (near tie: {ST_NEAR_TIE})")

    def _branch(self, own, margin, scale):
        """Records ``own`` (the run's branches), or returns the card's, and
        audits those that are not ``own`` by ``margin(taken)`` / ``scale``."""
        if not self.replay:
            self.taken.append(own.clone())
            return own
        taken = self.taken[self.pos].to(own.device)
        self.pos += 1
        taken = taken.flip(0) if self.flip else taken
        differ = taken != own
        if self.audit:
            self.decisions += own.numel()
            self.differ += int(differ.sum())
            if differ.any():
                self.worst = max(self.worst, float(margin(taken)[differ].max() / scale))
        return taken

    def _kink(self, x):
        v = x.detach()
        return self._branch(v > 0, lambda _: v.abs(), v.double().square().mean().sqrt())

    def leaky_relu(self, x, negative_slope=0.01):
        taken = self._kink(x)
        if not self.replay:
            return torch.nn.functional.leaky_relu(x, negative_slope)
        return torch.where(taken, x, x * negative_slope)

    def relu(self, x):
        taken = self._kink(x)
        if not self.replay:
            return torch.nn.functional.relu(x)
        return torch.where(taken, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def neighbour_max(self, g, kidx, port_max):
        gm = torch.where((kidx >= 0)[..., None], g, float("-inf"))
        v = gm.detach()
        top = v.amax(2)

        def gap(taken):
            return torch.where(torch.isfinite(top), top - v.gather(2, taken[:, :, None]).squeeze(2),
                               torch.zeros((), dtype=v.dtype, device=v.device))

        own = v.argmax(2)
        taken = self._branch(own, gap, v[torch.isfinite(v)].double().square().mean().sqrt())
        if not self.replay:
            return port_max(g, kidx)
        return gm.gather(2, taken[:, :, None]).squeeze(2)


def phase_st_agree(n=ST_AGREE_POINTS):
    """One fp32 semseg train step (CE + Lovasz) of DefaultSegmentor over
    ST-v1m2 at its default widths, 2 rows of ``n`` points (rooms,
    ``jittered`` from ST_AGREE_SEEDS), drop path 0 (the card's and
    the CPU's generators draw different streams), on the card against a
    float64 witness on the CPU (card_cpu_agree) that takes the card's
    branches at every kink and neighbour max (StBranches: each one the
    witness would not take is audited as a near tie). The noise floor
    comes from the CPU fp32 step's distance from the witness and from the
    card's step on the two rows swapped (every batch sum adds in another
    order; each row's own order is kept), both on the card's branches, not
    from points permuted within a row: FPS starts at each row's first
    valid point and a window keeps its first members by position, so such
    a permutation changes ST's function. A floor further than
    ST_ROUNDING_WHOLE is not rounding and is left out. Each floor is about
    7e-7 of the whole gradient, so every gradient's bound is
    TRAIN_GRAD_RTOL (1e-4 a tensor). Returns K1's and K2's launches (none)
    and the FPS kernel's."""
    reset_k1_counts()
    reset_k2_counts()
    fps_launches = fps_ops.farthest_point_sampling_cuda.launches
    rows = jittered(semseg_rows(n, ST_AGREE_SEEDS[:2]), ST_AGREE_SEEDS[2])
    criteria = build_criteria(Config.fromfile(SEMSEG_CONFIG).model.criteria)
    cfg = dict(type="DefaultSegmentor", backbone=dict(ST_BACKBONE, drop_path_rate=0.0, seed=7))
    branches = StBranches()
    seconds = card_cpu_agree("st_agree", cfg, rows, lambda m, b: ptv2_step(m, b, criteria, {}),
                             [swapped_rows(rows)], rounding_whole=ST_ROUNDING_WHOLE,
                             branches=branches, points=n, batch_rows=2, seeds=ST_AGREE_SEEDS,
                             model="ST-v1m2")
    counts = path_attention_counts("st_agree")
    counts["fps"] = fps_ops.farthest_point_sampling_cuda.launches - fps_launches
    check(counts["fps"] == 2 * ST_FPS_CALLS, f"st_agree: {counts['fps']} FPS launches in two "
          f"card steps, expected {2 * ST_FPS_CALLS}")
    emit(dict(phase="st_agree", model="ST-v1m2", points=n, rows=2, seeds=ST_AGREE_SEEDS,
              step_s=seconds, k1_launches=counts["k1"], k2_launches=counts["k2"],
              fps_launches=counts["fps"], branch_points=len(branches.taken),
              branch_decisions=branches.decisions, card_branches_not_witness=branches.differ,
              worst_near_tie=branches.worst, near_tie_bound=ST_NEAR_TIE))
    return counts


def table_overflow_by_stage(overflow):
    """A forward's 16 table truncations (each stage's fine and coarse
    tables, unshifted then shifted; [B] each) as members dropped per stage
    (fine, coarse), summed over the rows."""
    return [dict(fine=int(overflow[4 * s].sum() + overflow[4 * s + 2].sum()),
                 coarse=int(overflow[4 * s + 1].sum() + overflow[4 * s + 3].sum()))
            for s in range(len(overflow) // 4)]


def phase_st_train(work, root, data_s, steps=SPARSE_STEPS, batch_size=2):
    """The semseg trainer on st_config (ST-v1m2 at its default widths, fp32,
    batch 2, the file's 205,824 points, CE + Lovasz, Mix3D 0.8, optimizer
    and hooks but PreciseEvaluator) for ``steps`` steps over the sparse
    phases' rooms and one validation: finite losses, val mIoU and the best
    checkpoint, no K1 or K2 launch, the FPS kernel's launches (ST_FPS_CALLS
    a forward) and its CUDA-event ms a step, the window members truncated
    per stage, step times, loader waits, peak memory, one profiled step (the
    idle share). Returns the config file, the checkpoint and the counts."""
    with tempfile.TemporaryDirectory() as tmp:
        reset_k1_counts()
        reset_k2_counts()
        fps_launches = fps_ops.farthest_point_sampling_cuda.launches
        cfg = st_config(semseg_train_config(root, os.path.join(tmp, "exp"), batch_size, steps, 4))
        cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
        knn_probe = KnnProbe()
        with knn_probe.on():
            trainer, probe, records, k1_counts = run_training(cfg)
        fps_ms = knn_probe.ms("farthest_point_sampling")
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        check(len(losses) == steps and all(math.isfinite(v) for v in losses + grad_norms),
              f"st_train: losses {losses}, grad norms {grad_norms}")
        counts = path_attention_counts("st_train")
        counts["fps"] = fps_ops.farthest_point_sampling_cuda.launches - fps_launches
        forwards = k1_counts["train_forwards"] + k1_counts["val_forwards"]
        check(counts["fps"] == ST_FPS_CALLS * forwards,
              f"st_train: {counts['fps']} FPS launches in {forwards} forwards")
        fps_step = [sum(fps_ms[i:i + ST_FPS_CALLS])
                    for i in range(0, ST_FPS_CALLS * steps, ST_FPS_CALLS)]
        truncated = [table_overflow_by_stage(r["overflow"]) for r in records]
        miou = hist("val/mIoU").values()
        check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"st_train: val/mIoU {miou}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                 os.path.join(work, "st_model_best.pth"))
        state = torch.load(checkpoint, map_location="cpu", weights_only=False)["state_dict"]
        trainer.model.load_state_dict(state, strict=True)  # name for name
        step_ms = probe.step_ms()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sizes = [[(m, v.tolist()) for m, v in r["sizes"][:1]] for r in records]
        emit(dict(phase="st_train", config=SEMSEG_CONFIG, model="DefaultSegmentor over ST-v1m2",
                  backbone=ST_BACKBONE, task="semseg", batch_size=batch_size,
                  points=cfg.data.num_points, steps=len(losses), loss=losses,
                  grad_norm=grad_norms, cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=peak, idle_share=probe.profile["idle_share"], val_miou=miou[0],
                  fps_ms_per_step=fps_step, fps_launches=counts["fps"],
                  fps_launches_per_forward=ST_FPS_CALLS, forwards=forwards,
                  members_truncated_per_stage=truncated, input_slots_valid=sizes,
                  k1_launches=counts["k1"], k2_launches=counts["k2"], dataset_write_s=data_s,
                  profile=probe.profile))
        print(f"st_train: warm steps {[round(v) for v in step_ms[1:-1]]} ms, peak {peak:.2f} GiB, "
              f"idle share {probe.profile['idle_share']:.3f}, FPS "
              f"{[round(v, 1) for v in fps_step]} ms a step ({counts['fps']} launches), "
              f"members truncated per stage {truncated[-1]}, K1 {counts['k1']} K2 {counts['k2']}",
              flush=True)
        config_path = os.path.join(work, "st_semseg.py")
        cfg.dump(config_path)
        del trainer
    torch.cuda.empty_cache()
    return config_path, checkpoint, counts


def phase_st_test(work, config_path, checkpoint, n_voxels=100000):
    """sorted_room_test on st_train's config and checkpoint: K3 ST_SORTS
    times a fragment forward (each stage's four window tables), some of
    them past one cluster's tile of 32,768 keys (sort_global, more than one
    launch a sort: the room's fragments hold about 180,000 points), and the
    FPS kernel ST_FPS_CALLS times in every fragment forward of the three
    runs."""
    fps_launches = fps_ops.farthest_point_sampling_cuda.launches
    launched = {}

    def fps_count(fragments):
        launched["fps"] = fps_ops.farthest_point_sampling_cuda.launches - fps_launches
        check(launched["fps"] == ST_FPS_CALLS * 3 * fragments,
              f"st_test: {launched['fps']} FPS launches in 3 runs of {fragments} fragment "
              "forwards")
        return dict(fps_launches=launched["fps"])

    sorts, counts = sorted_room_test(work, "st_test", "semseg file with st_config", config_path,
                                     checkpoint, n_voxels, 99, ST_SORTS, fps_count)
    check(sorts["sort_kernels"] > sorts["sort_calls"],
          f"st_test: {sorts['sort_kernels']} K3 launches for {sorts['sort_calls']} sorts: no "
          "window table went past one tile")
    return sorts, dict(counts, **launched)


def st_phases(work, root, data_s):
    """The Stratified Transformer's phases, in order: fps_kernel, st_agree,
    st_train over the sparse phases' rooms, st_test. Returns the FPS
    kernel's times, the counts by phase and st_test's sorts."""
    fps_times = phase_fps_kernel()
    counts = dict(st_agree=phase_st_agree())
    config_path, checkpoint, counts["st_train"] = phase_st_train(work, root, data_s)
    sorts, counts["st_test"] = phase_st_test(work, config_path, checkpoint)
    return fps_times, counts, sorts


# ---- classification and part segmentation; the last losses ------------------

# Pointcept's ModelNet40 recipe (configs/modelnet40/cls-ptv3-v1m1-0-base.py):
# PT-v3m1 in cls_mode at the semseg file's encoder widths, windows of 1024 at
# every stage, coordinates and normals in. The pooling capacities are one
# stage later than the default 0.5^s: a 1 cm sample of an object's surface
# keeps most of its points as 2 cm clusters (7,864 of 9,412 on cls_agree's
# first object, where the default capacity holds 6,144), so the first
# pooling may keep every slot
CLS_BACKBONE = dict(type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert",
                                                           "hilbert-trans"),
                    stride=(2, 2, 2, 2), enc_depths=(2, 2, 2, 6, 2),
                    enc_channels=(32, 64, 128, 256, 512), enc_num_head=(2, 4, 8, 16, 32),
                    enc_patch_size=(1024,) * 5, mlp_ratio=4, drop_path=0.3,
                    shuffle_orders=True, cls_mode=True, stage_capacity=(1.0, 0.5, 0.25, 0.125))
CLS_CLASSES = 40
CLS_POINTS = 10000  # a ModelNet40 object's resampled cloud
CLS_GRID = 0.01
CLS_OBJECTS = 16
CLS_REPEATS = 3
CLS_FWD_RTOL = 1e-4
# ShapeNetPart's 16 categories and their 50 parts
SHAPE_PARTS = (("airplane", 4), ("bag", 2), ("cap", 2), ("car", 4), ("chair", 4),
               ("earphone", 3), ("guitar", 3), ("knife", 2), ("lamp", 4), ("laptop", 2),
               ("motorbike", 6), ("mug", 2), ("pistol", 3), ("rocket", 3), ("skateboard", 3),
               ("table", 3))
PARTSEG_POINTS = 2048  # ShapeNetPart's usual sampling
PARTSEG_OBJECTS = 8
PARTSEG_VOTES = 2
PARTSEG_MODEL = dict(type="DefaultSegmentor", backbone=dict(
    type="PointTransformer-PartSeg50", in_channels=6, num_classes=50, num_shape_classes=16,
    seed=43))
LOSS_RTOL = 1e-5


def primitive_points(rng, kind, center, size, n):
    """n points on the surface of a sphere, a box or an upright cylinder of
    ``size`` about ``center``, with their outward normals."""
    if kind == 0:
        normal = rng.normal(size=(n, 3))
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        return center + normal * size, normal
    if kind == 1:
        axis = rng.integers(0, 3, n)
        sign = rng.choice((-1.0, 1.0), n)
        p = rng.uniform(-1, 1, (n, 3))
        p[np.arange(n), axis] = sign
        normal = np.zeros((n, 3))
        normal[np.arange(n), axis] = sign
        return center + p * size, normal
    theta = rng.uniform(0, 2 * np.pi, n)
    normal = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], 1)
    p = normal * size[:2].mean()
    p[:, 2] = rng.uniform(-1, 1, n) * size[2]
    return center + p, normal


def shape_object(category, parts, n, seed):
    """An object of ``parts`` primitives whose kinds and layout the
    category fixes and whose sizes and placement the seed jitters: its
    coordinates, normals and each point's part."""
    layout = np.random.default_rng(1000 + category)
    rng = np.random.default_rng(seed)
    counts = np.diff(np.linspace(0, n, parts + 1).astype(int))
    coord, normal, part = [], [], []
    for j, m in enumerate(counts):
        kind = int(layout.integers(0, 3))
        center = layout.uniform(-0.4, 0.4, 3) + rng.normal(0, 0.03, 3)
        size = layout.uniform(0.1, 0.4, 3) * rng.uniform(0.85, 1.15)
        c, nm = primitive_points(rng, kind, center, size, m)
        coord.append(c)
        normal.append(nm)
        part.append(np.full(m, j))
    return (np.concatenate(coord).astype(np.float32), np.concatenate(normal).astype(np.float32),
            np.concatenate(part))


def register_object_set():
    """Registers ``ChipSmokeObjects`` in the port's datasets (once):
    ``objects`` (dicts of arrays) through ``transform``, each fetch
    drawing from the transform generator the tester seeds. With ``votes``
    a fetch is a part segmentation sample: its labels, its ``cls_token``
    and ``votes`` variants, each through the transform (which keeps the
    token for the model), with 1 cm grid coordinates. ``categories`` and
    ``category2part`` are the testers'."""
    from scenesplat_tpu_torch.data import DATASETS
    from scenesplat_tpu_torch.data.transforms import Compose

    if "ChipSmokeObjects" in DATASETS:
        return

    @DATASETS.register_module("ChipSmokeObjects")
    class ObjectSet:
        def __init__(self, objects, transform=(), votes=0, categories=(),
                     category2part=None, **kwargs):
            self.objects = list(objects)
            self.transform = Compose(list(transform))
            self.votes = votes
            self.categories = list(categories)
            self.category2part = dict(category2part or {})

        def __len__(self):
            return len(self.objects)

        def view(self, obj):
            d = self.transform({k: np.array(v) for k, v in obj.items()})
            if self.votes:
                c = d["coord"]
                d["grid_coord"] = np.floor((c - c.min(0)) / CLS_GRID).astype(np.int64)
            return d

        def __getitem__(self, i):
            obj = self.objects[i]
            if not self.votes:
                return self.view(obj)
            return dict(segment=obj["segment"], cls_token=obj["cls_token"],
                        voting_list=[self.view(obj) for _ in range(self.votes)])


def cls_transform(voting=False):
    """The ModelNet40 recipe's test pipeline (NormalizeCoord, GridSample at
    1 cm, coordinates and normals as features); with ``voting`` an
    anisotropic scale first, the test augmentation a vote repeats."""
    scale = [dict(type="RandomScale", scale=[0.9, 1.1], anisotropic=True)] if voting else []
    return [dict(type="NormalizeCoord"), *scale,
            dict(type="GridSample", grid_size=CLS_GRID, hash_type="fnv", mode="train",
                 keys=("coord", "normal"), return_grid_coord=True),
            dict(type="Collect", keys=("coord", "grid_coord", "category"),
                 feat_keys=("coord", "normal"))]


def write_cls_objects(n_objects=CLS_OBJECTS, seed=0):
    """The dataset config of objects of CLS_POINTS points, categories
    cycling over the 40 classes, through the test pipeline."""
    objects = []
    for i in range(n_objects):
        category = (7 * i + seed) % CLS_CLASSES
        coord, normal, _ = shape_object(category, 1 + category % 3, CLS_POINTS, 500 + i)
        objects.append(dict(coord=coord, normal=normal, category=np.array([category])))
    return dict(type="ChipSmokeObjects", objects=objects, transform=cls_transform())


def cls_model(dtype, device="cuda", **backbone):
    return build_model(dict(type="DefaultClassifier", num_classes=CLS_CLASSES,
                            backbone_embed_dim=CLS_BACKBONE["enc_channels"][-1],
                            backbone=dict(CLS_BACKBONE, dtype=dtype, seed=41, **backbone))
                       ).to(device).eval()


def reset_path_counts():
    """K1's, K2's, K3's and the FPS kernel's counts to 0, as just before a
    path is driven."""
    reset_k1_counts()
    reset_k2_counts()
    bs.bitonic_sort.launches = bs.bitonic_sort.kernel_launches = 0
    fps_ops.farthest_point_sampling_cuda.launches = 0


def path_counts():
    """The four kernels' launches since reset_path_counts (K1's also with
    the log-sum-exp alone)."""
    return dict(k1=fwa.flash_window_attention.launches, k1_variants=k1_variants(),
                k1_lse=sum(k1_lse_variants().values()),
                k2=fwa.flash_window_attention_bwd.launches, k3=bs.bitonic_sort.launches,
                k3_kernels=bs.bitonic_sort.kernel_launches,
                fps=fps_ops.farthest_point_sampling_cuda.launches)


def rel_err(got, ref):
    """Largest difference over the reference's largest magnitude."""
    got, ref = (torch.as_tensor(np.asarray(x), dtype=torch.float64) for x in (got, ref))
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def phase_cls_agree(dataset_cfg):
    """The classifier in fp32, 2 objects through the test pipeline, padded
    into one batch of a bucket's slots: the card's forward with the K1
    kernel (fp32, 14 launches, no pooling overflow) against the card's
    forward with the plain attention and against the CPU's forward, logits
    to CLS_FWD_RTOL of their scale. Returns the counts."""
    from scenesplat_tpu_torch.data import build_dataset
    from scenesplat_tpu_torch.data.transforms import seed_transforms

    ds = build_dataset(dict(dataset_cfg))
    rows = []
    for i in range(2):
        seed_transforms((0, i))
        rows.append(ds[i])
    n = bucket_size(max(len(r["coord"]) for r in rows), 1024)

    def padded(key, dtype):
        return torch.from_numpy(np.stack([np.pad(np.asarray(r[key], dtype),
                                                 [(0, n - len(r[key])), (0, 0)])
                                          for r in rows]))

    point = PointBatch(coord=padded("coord", np.float32), feat=padded("feat", np.float32),
                       grid_coord=padded("grid_coord", np.int64),
                       mask=torch.from_numpy(np.stack([np.arange(n) < len(r["coord"])
                                                       for r in rows])))
    kernel = cls_model("float32")
    plain = cls_model("float32", use_kernel=False)
    plain.load_state_dict(kernel.state_dict(), strict=True)
    cpu = copy.deepcopy(kernel).cpu()
    plans = []
    hook = kernel.backbone.register_forward_hook(lambda m, i, out: plans.extend(out.plans))
    on_card = PointBatch(**{k: getattr(point, k).to("cuda")
                            for k in ("coord", "feat", "grid_coord", "mask")})
    reset_path_counts()
    with torch.inference_mode():
        got = kernel(on_card).cpu()
        counts = path_counts()
        hook.remove()
        ref_plain = plain(on_card).cpu()
        t0 = time.perf_counter()
        ref_cpu = cpu(point)
        cpu_s = time.perf_counter() - t0
    overflow = [int(p.n_overflow.max()) for p in plans]
    err, err_cpu = rel_err(got, ref_plain), rel_err(got, ref_cpu)
    emit(dict(phase="cls_agree", dtype="float32", objects=2, points=[len(r["coord"]) for r in rows],
              slots=n, logits_shape=list(got.shape), max_rel_err_plain=err,
              max_rel_err_cpu=err_cpu, cpu_forward_s=cpu_s, rtol=CLS_FWD_RTOL,
              pooled_slots=[p.out_mask.shape[1] for p in plans],
              clusters=[int(p.n_clusters.max()) for p in plans], n_overflow=overflow,
              launches=counts))
    check(got.shape == (2, CLS_CLASSES) and torch.isfinite(got).all().item(),
          f"cls_agree: logits {tuple(got.shape)}")
    check(counts["k1_variants"]["fp32"] == counts["k1"] == sum(CLS_BACKBONE["enc_depths"]),
          f"cls_agree: K1 launches {counts['k1_variants']}, expected 14 fp32")
    check(counts["k2"] == counts["k3"] == counts["fps"] == 0, f"cls_agree: {counts}")
    check(all(o == 0 for o in overflow), f"cls_agree: pooling overflow {overflow}")
    check(err <= CLS_FWD_RTOL, f"cls_agree: card logits vs the plain attention's: {err}")
    check(err_cpu <= CLS_FWD_RTOL, f"cls_agree: card logits vs the CPU's: {err_cpu}")
    return counts


def stub_trainer(cfg, model):
    """What an evaluator hook reads of a trainer."""
    from scenesplat_tpu_torch.utils.events import EventStorage

    return types.SimpleNamespace(cfg=cfg, model=model, device=torch.device("cuda"),
                                 logger=logging.getLogger("chip_smoke"), comm_info={},
                                 storage=EventStorage(), epoch=0)


def timed_run(phase, what, forwards, fn):
    """``fn()`` from reset counts: its result, seconds, counts; K1 14 times a
    classifier forward, all on bf16_large, and no K2, K3 or FPS launch."""
    reset_path_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_counts()
    want = sum(CLS_BACKBONE["enc_depths"]) * forwards
    check(counts["k1"] == counts["k1_variants"]["bf16_large"] == want,
          f"{phase}: {what} K1 launches {counts['k1_variants']}, expected {want} bf16_large")
    check(counts["k2"] == counts["k3"] == counts["fps"] == 0, f"{phase}: {what} {counts}")
    return out, seconds, counts


def phase_cls_test(dataset_cfg):
    """The classifier in bf16 on the card through the port's tester builder:
    ClsTester over CLS_OBJECTS objects, ClsVotingTester over CLS_REPEATS
    repeats of the scaled test pipeline, ClsEvaluator's before_train and
    after_epoch on a stub trainer over the same objects: their records in
    the JAX testers' form and finite, seconds an object, K1 14 times a
    forward on bf16_large, no pooling overflow. Then the bf16 logits of 4
    objects against the fp32 kernel path's, within BF16_NOISE_FACTOR times
    the plain bf16 attention's error, and the K1 calls' shapes of one
    forward (for cls_timing)."""
    from scenesplat_tpu_torch.data import build_dataset
    from scenesplat_tpu_torch.data.transforms import seed_transforms
    from scenesplat_tpu_torch.engines.hooks.evaluator import ClsEvaluator
    from scenesplat_tpu_torch.engines.test import build_tester

    model = cls_model("bfloat16")
    overflow = []
    model.backbone.register_forward_hook(
        lambda m, i, out: overflow.append(max(int(p.n_overflow.max()) for p in out.plans)))
    voting_cfg = dict(dataset_cfg, transform=cls_transform(voting=True))
    runs, counts = {}, {}
    tester = build_tester(dict(type="ClsTester", num_classes=CLS_CLASSES), model, dataset_cfg,
                          patch_size=1024, seed=0, device="cuda")
    runs["cls_tester"], s_cls, counts["cls_tester"] = timed_run(
        "cls_test", "ClsTester", CLS_OBJECTS, tester.test)
    voting = build_tester(dict(type="ClsVotingTester", num_classes=CLS_CLASSES,
                               num_repeat=CLS_REPEATS), model, voting_cfg, patch_size=1024,
                          seed=0, device="cuda")
    runs["cls_voting_tester"], s_vote, counts["cls_voting_tester"] = timed_run(
        "cls_test", "ClsVotingTester", CLS_OBJECTS * CLS_REPEATS, voting.test)
    cfg = Config(dict(seed=0, data=dict(val=dataset_cfg, num_classes=CLS_CLASSES),
                      model=dict(backbone=CLS_BACKBONE)))
    hook = ClsEvaluator()
    hook.trainer = stub_trainer(cfg, model)
    hook.before_train()
    _, s_eval, counts["cls_evaluator"] = timed_run("cls_test", "ClsEvaluator", CLS_OBJECTS,
                                                   hook.after_epoch)
    runs["cls_evaluator"] = dict(hook.trainer.storage.latest,
                                 metric=hook.trainer.comm_info["current_metric_name"])
    check(set(runs["cls_tester"]) == {"allAcc"}, f"cls_test: {runs['cls_tester']}")
    check(set(runs["cls_voting_tester"]) == {"allAcc", "mAcc"},
          f"cls_test: {runs['cls_voting_tester']}")
    check(set(runs["cls_evaluator"]) == {"val/allAcc", "val/mAcc", "metric"}
          and runs["cls_evaluator"]["metric"] == "allAcc", f"cls_test: {runs['cls_evaluator']}")
    check(all(math.isfinite(v) and 0 <= v <= 1 for r in runs.values() for v in r.values()
              if not isinstance(v, str)), f"cls_test: records {runs}")

    # the bf16 logits against fp32's, under the noise-floor rule
    fp32 = cls_model("float32")
    plain16 = cls_model("bfloat16", use_kernel=False)
    for m in (fp32, plain16):
        m.load_state_dict(model.state_dict(), strict=True)
    ds = build_dataset(dict(dataset_cfg))
    extract = {name: FeatureExtractor(m, patch_size=1024, device="cuda")
               for name, m in (("kernel", model), ("plain", plain16), ("fp32", fp32))}
    logits = {name: [] for name in extract}
    calls = WindowCalls(sum(CLS_BACKBONE["enc_depths"]), max_window=1024)
    for i in range(4):
        seed_transforms((0, i))
        sample = ds[i]
        for name, ex in extract.items():
            with calls if (i == 0 and name == "kernel") else contextlib.nullcontext():
                logits[name].append(ex(sample))
    err = rel_err(np.stack(logits["kernel"]), np.stack(logits["fp32"]))
    floor = rel_err(np.stack(logits["plain"]), np.stack(logits["fp32"]))
    emit(dict(phase="cls_test", dtype="bfloat16", objects=CLS_OBJECTS, repeats=CLS_REPEATS,
              records=runs, seconds=dict(cls_tester=s_cls, cls_voting_tester=s_vote,
                                         cls_evaluator=s_eval),
              seconds_per_object=dict(cls_tester=s_cls / CLS_OBJECTS,
                                      cls_voting_tester=s_vote / (CLS_OBJECTS * CLS_REPEATS),
                                      cls_evaluator=s_eval / CLS_OBJECTS),
              launches=counts, bf16_rel_err=err, bf16_plain_rel_err=floor,
              forwards=len(overflow), max_overflow=max(overflow),
              window_calls=calls.shapes()))
    check(max(overflow) == 0, f"cls_test: pooling overflow up to {max(overflow)} clusters")
    check_noise_floor(err, floor, "classifier logits", "cls_test's 4 objects")
    check(len(calls.calls) == sum(CLS_BACKBONE["enc_depths"]),
          f"cls_test: {len(calls.calls)} K1 calls recorded in one forward")
    print(f"cls_test: {s_cls / CLS_OBJECTS:.3f} s an object (ClsTester), bf16 logits "
          f"{err:.2e} from fp32 against plain bf16's {floor:.2e}", flush=True)
    return calls.shapes(), {k: c for k, c in counts.items()}


def write_partseg_objects(n_objects=PARTSEG_OBJECTS):
    """The dataset config of objects of PARTSEG_POINTS points of categories
    cycling over SHAPE_PARTS, each point labeled with its part's id among
    the 50 (the category's parts numbered in SHAPE_PARTS' order), with
    PARTSEG_VOTES scaled variants a fetch."""
    first = np.cumsum([0] + [p for _, p in SHAPE_PARTS])
    objects = []
    for i in range(n_objects):
        category = (5 * i) % len(SHAPE_PARTS)
        coord, normal, part = shape_object(category, SHAPE_PARTS[category][1], PARTSEG_POINTS,
                                           700 + i)
        objects.append(dict(coord=coord, normal=normal, segment=first[category] + part,
                            cls_token=np.array([category])))
    return dict(type="ChipSmokeObjects", objects=objects, votes=PARTSEG_VOTES,
                transform=[dict(type="NormalizeCoord"),
                           dict(type="RandomScale", scale=[0.9, 1.1], anisotropic=True),
                           dict(type="Collect", keys=("coord", "cls_token"),
                                feat_keys=("coord", "normal"))],
                categories=[name for name, _ in SHAPE_PARTS],
                category2part={name: list(range(first[c], first[c + 1]))
                               for c, (name, _) in enumerate(SHAPE_PARTS)})


class Recording:
    """An extractor that keeps every output of the one it wraps."""

    def __init__(self, extractor):
        self.extractor, self.outputs = extractor, []

    def __call__(self, sample):
        self.outputs.append(self.extractor(sample))
        return self.outputs[-1]


def phase_partseg_test(dataset_cfg):
    """PartSegTester (through the tester builder) over PARTSEG_OBJECTS
    objects of PARTSEG_POINTS points with PARTSEG_VOTES variants each, PTv1
    PartSeg50 under DefaultSegmentor in fp32, on the card and on the CPU
    from one initialization and one stream of variant draws: the card's
    logits within CLS_FWD_RTOL of the
    CPU's, ins_mIoU and cat_mIoU equal where the predictions are, the FPS
    kernel 4 times a forward and no K1, K2 or K3 launch."""
    from scenesplat_tpu_torch.data.transforms import seed_transforms
    from scenesplat_tpu_torch.engines.test import build_tester

    base = build_model(copy.deepcopy(PARTSEG_MODEL)).eval()
    results, outputs, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(device)
        tester = build_tester(dict(type="PartSegTester", num_classes=50), model, dataset_cfg,
                              patch_size=1024, seed=0, device=device)
        tester.extractor = Recording(tester.extractor)
        if device == "cuda":
            reset_path_counts()
        # the tester, as the JAX one, seeds no fetch: both runs draw their
        # variants' scales from one seeded stream
        seed_transforms((0, 18))
        t0 = time.perf_counter()
        results[device] = tester.test()
        seconds[device] = time.perf_counter() - t0
        if device == "cuda":
            counts = path_counts()
        outputs[device] = tester.extractor.outputs
    forwards = PARTSEG_OBJECTS * PARTSEG_VOTES
    err = max(rel_err(a, b) for a, b in zip(outputs["cuda"], outputs["cpu"]))
    same_pred = all(np.array_equal(a.argmax(-1), b.argmax(-1))
                    for a, b in zip(outputs["cuda"], outputs["cpu"]))
    emit(dict(phase="partseg_test", dtype="float32", objects=PARTSEG_OBJECTS,
              points=PARTSEG_POINTS, votes=PARTSEG_VOTES, results=results, seconds=seconds,
              seconds_per_object={d: s / PARTSEG_OBJECTS for d, s in seconds.items()},
              max_rel_err=err, rtol=CLS_FWD_RTOL, predictions_equal=same_pred,
              launches=counts))
    check(len(outputs["cuda"]) == forwards and all(
        o.shape == (PARTSEG_POINTS, 50) and np.isfinite(o).all() for o in outputs["cuda"]),
        "partseg_test: card logits")
    check(err <= CLS_FWD_RTOL, f"partseg_test: card logits vs the CPU's: {err}")
    if same_pred:
        check(results["cuda"] == results["cpu"], f"partseg_test: {results}")
    check(set(results["cuda"]) == {"ins_mIoU", "cat_mIoU"}, f"partseg_test: {results}")
    check(counts["fps"] == 4 * forwards, f"partseg_test: {counts['fps']} FPS launches in "
          f"{forwards} forwards")
    check(counts["k1"] == counts["k2"] == counts["k3"] == 0, f"partseg_test: {counts}")
    return counts


def loss_cases(rng):
    """name -> (loss config, prediction, target, mask): logits [2, 4096, 20]
    with ignored labels and a padding tail; BinaryFocalLoss and L1Loss on
    targets in [0, 1]."""
    pred = rng.normal(0, 2.0, (2, 4096, 20))
    target = rng.integers(-1, 20, (2, 4096))
    soft = rng.uniform(0, 1, pred.shape)
    mask = np.ones((2, 4096), bool)
    mask[1, 3500:] = False
    return {
        "SmoothCELoss": (dict(smoothing_ratio=0.1), pred, target, mask),
        "FocalLoss": (dict(gamma=2.0, alpha=0.5), pred, target, mask),
        "BinaryFocalLoss": (dict(), pred, soft, np.broadcast_to(mask[..., None], pred.shape)),
        "DiceLoss": (dict(), pred, target, mask),
        "L1Loss": (dict(), pred, soft, mask),
    }


def phase_loss_agree():
    """The five losses, DINOLoss over 3 centre updates, iBOTPatchLoss over 3
    and sinkhorn_knopp_teacher, in fp32 on the card against float64 on the
    CPU: values and gradients to LOSS_RTOL of their scale, the centres too."""
    from scenesplat_tpu_torch.models.losses import LOSSES
    from scenesplat_tpu_torch.models.losses.dino_legacy import (
        DINOLoss,
        iBOTPatchLoss,
        sinkhorn_knopp_teacher,
    )

    rng = np.random.default_rng(17)
    reset_path_counts()
    errs = {}

    def both(name, fn, arrays):
        """``fn`` of the arrays (made tensors that take gradients) on the card
        in fp32 and on the CPU in float64: each output's and gradient's
        error."""
        outs = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            xs = [torch.tensor(a, dtype=dtype, device=device, requires_grad=True)
                  for a in arrays]
            values = fn(xs, device, dtype)
            sum(v.sum() for v in values if v.requires_grad).backward()
            outs[device] = [v.detach().cpu() for v in values] + [x.grad.cpu() for x in xs]
        errs[name] = max(rel_err(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))

    for name, (cfg, pred, target, mask) in loss_cases(rng).items():
        loss = LOSSES.build(dict(type=name, **cfg))
        t = torch.from_numpy(target)
        m = torch.from_numpy(np.ascontiguousarray(mask))
        both(name, lambda xs, d, dt: [loss(xs[0], (t.to(dt) if t.is_floating_point() else t)
                                           .to(d), mask=m.to(d))], [pred])

    views = [rng.normal(0, 1.0, (3, 2, 64, 256)) for _ in range(2)]

    def dino(xs, device, dtype):
        module = DINOLoss(256, student_temp=0.1, center_momentum=0.8).to(device, dtype)
        out = [module(list(xs[0][k]), list(torch.tensor(views[1][k], dtype=dtype,
                                                        device=device)), 0.05) for k in range(3)]
        return out + [module.center.clone()]

    both("DINOLoss", dino, [views[0]])
    tokens = [rng.normal(0, 1.0, (3, 8, 512, 64)) for _ in range(2)]
    masks = torch.from_numpy(rng.uniform(size=(8, 512)) < 0.3)

    def ibot(xs, device, dtype):
        module = iBOTPatchLoss(64).to(device, dtype)
        out = [module(xs[0][k], torch.tensor(tokens[1][k], dtype=dtype, device=device),
                      masks.to(device), 0.06) for k in range(3)]
        return out + [module.center.clone()]

    both("iBOTPatchLoss", ibot, [tokens[0]])
    weights = rng.normal(size=(64, 256))
    # teacher logits of a scale whose exp at the temperature stays well
    # inside fp32 (at N(0, 1) over 0.05 the assignment's small entries
    # underflow in fp32 and the fp32 assignment is another one)
    both("sinkhorn_knopp_teacher", lambda xs, d, dt: [
        (sinkhorn_knopp_teacher(xs[0], 0.1, 3) * torch.tensor(weights, dtype=dt, device=d))],
        [rng.normal(0, 0.3, (64, 256))])
    counts = path_counts()
    emit(dict(phase="loss_agree", max_rel_err=errs, rtol=LOSS_RTOL, launches=counts))
    for name, err in errs.items():
        check(err <= LOSS_RTOL, f"loss_agree: {name} fp32 on the card vs float64: {err}")
    check(counts["k1"] == counts["k2"] == counts["k3"] == counts["fps"] == 0,
          f"loss_agree: {counts}")
    return counts


def phase_profiler_hook(work, phase="profiler_hook", strict=True):
    """RuntimeProfiler on a stub trainer over 2 of 4 steps of a card matmul
    loop: its Chrome trace holds the steps' CPU matmuls, and the hook
    counts its events on the card. ``strict`` (after serve, the process's
    second profiler session): the trace holds the steps' CUDA kernel
    events. Else (after every other phase) it holds them, or it holds none
    and the hook warned: later in a process torch.profiler loses CUDA
    kernel events, whole sessions of them at times, whatever profiles
    (tools/profiler_sessions.py), and the hook must not hand over a trace
    without them unsaid."""
    from scenesplat_tpu_torch.engines.hooks import HOOKS

    profiler = HOOKS.build(dict(type="RuntimeProfiler", start_step=1, num_steps=2))
    profiler.trainer = stub_trainer(Config(dict(save_path=os.path.join(work, phase))), None)
    lines = LogLines()
    profiler.trainer.logger.addHandler(lines)
    x = torch.randn(512, 512, device="cuda")
    try:
        for step in range(4):
            profiler.trainer.storage.iter = step
            profiler.before_step()
            x = torch.tanh(x @ x)
            profiler.after_step()
    finally:
        profiler.trainer.logger.removeHandler(lines)
    with open(profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    matmuls = sum(e.get("name") in ("aten::mm", "aten::matmul") for e in events)
    warned = any("no event on the card" in line for line in lines.lines)
    emit(dict(phase=phase, trace=profiler.trace_path, kernel_events=len(kernels),
              device_events=profiler.device_events, cpu_matmuls=matmuls, warned=warned,
              kernels=sorted({e.get("name", "")[:60] for e in kernels})[:5]))
    recorded = len(kernels) >= 2 and profiler.device_events >= len(kernels) and not warned
    check(matmuls >= 2 and (recorded or not strict and profiler.device_events == 0 and warned),
          f"{phase}: {len(kernels)} CUDA kernel events in the trace, "
          f"{profiler.device_events} counted by the hook, {matmuls} CPU matmuls, "
          f"warned {warned}")


def cls_phases():
    """Classification and part segmentation, then the last losses:
    cls_agree, cls_test, cls_timing (K1 at cls_test's shapes, per
    classifier forward), partseg_test, loss_agree. Returns the counts by
    phase and cls_timing's sums."""
    register_object_set()
    cls_cfg = write_cls_objects()
    counts = {}
    counts["cls_agree"] = phase_cls_agree(cls_cfg)
    shapes, counts["cls_test"] = phase_cls_test(cls_cfg)
    timing = phase_timing(shapes, phase="cls_timing")
    counts["partseg_test"] = phase_partseg_test(write_partseg_objects())
    counts["loss_agree"] = phase_loss_agree()
    return counts, timing


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS's deterministic workspace, for the test phase's two compared
    # runs; cuBLAS reads it when its handle is made, so it holds for every
    # phase (the device phase's record says so)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        meta_root = os.path.join(work, "metadata")
        write_meta(meta_root)
        os.environ["SCENESPLAT_META_ROOT"] = meta_root  # the flagship config reads it
        smi = phase_device()
        worst32 = phase_kernel()
        text = load_text_embeddings("builtin:scannet200")
        shapes, launches, serve_variants = phase_serve(text)
        phase_profiler_hook(work)
        tot = phase_timing(shapes)
        phase_shipped(text)
        phase_agree(text)
        worst_bwd, worst_fwd_lse = phase_kernel_bwd()
        worst_widths, widths = phase_kernel_widths()
        # the flagship rooms, written once for train and ddp_train
        flagship_data = write_flagship_data(os.path.join(work, "flagship_data"))
        train_shapes, k1_train, k1_val, k1_variants_train, k2_variants, checkpoint, plain = \
            phase_train(work, flagship_data)
        tot_bwd = phase_timing_bwd(train_shapes)
        phase_train_agree()
        ddp_record, ddp_checkpoint = phase_ddp_train(work, plain, flagship_data)
        wide = phase_wide_heads(flagship_data, text)
        tools = phase_tools(work)
        # the two ranks run in the shared spawn below; grid_ref is tp_agree's
        # and cp_agree's reference
        ddp_agree_pending, grid_ref = prepare_ddp_agree(work, ddp_checkpoint, meta_root)
        worst_sort = phase_kernel_sort()
        # the older phases at a cut depth, to leave time for the later
        # paths' phases: one test scene where there were two, 3 train steps
        # where there were 4 to 6 (semseg, insseg, cac; ssl and msc keep 4,
        # an even count: their loaders pass whole over 4 rooms, and ssl's
        # steps 1 and 2 its unprofiled warm ones), 3 PPT
        # steps (A A B) where there were 6 (ppt, ppt over SpUNet), 3 PT-v2m2
        # steps where there were 5, test rooms of 100,001 Gaussians where
        # there were 200,001 (semseg, ppt, cac, ptv2 and mink test; 320,001
        # before that), one timed rep of each plain backward where
        # there were two, MSC-v1m2's agree step at one block a stage
        sort_calls, sort_kernels, fragments, sort_sizes, test_variants, test_shapes = \
            phase_test(work, checkpoint, meta_root, n_scenes=1)
        tot_sort = phase_timing_sort(sort_sizes)
        tot_test = phase_timing_test(test_shapes)
        # 1 + 2 steps over 2 rooms (it took 4 over 4): a CPU replay of
        # its loader puts every pooling past the first 2,089 clusters or more
        # under its capacity, where 4 over 4 came within 73
        ssl_shapes, ssl_counts, ssl_checkpoint, teacher_shapes = phase_ssl_train(
            work, steps=3, rooms=2)
        ssl_bwd = phase_timing_bwd(ssl_shapes, phase="ssl_timing_bwd")
        ssl_teacher = phase_timing(teacher_shapes, phase="ssl_timing_teacher")
        phase_ssl_agree()
        teacher_weight = phase_warm_start(work, ssl_checkpoint, checkpoint)
        semseg_shapes, semseg_k1, semseg_k1_variants, semseg_k2_variants, semseg_checkpoint = \
            phase_semseg_train(work, teacher_weight, steps=3)
        semseg_bwd = phase_timing_bwd(semseg_shapes, phase="semseg_timing_bwd")
        phase_semseg_agree()
        semseg_on, semseg_fragments, semseg_sort_sizes, semseg_calls = \
            phase_semseg_test(work, semseg_checkpoint, n_voxels=50000, n_scenes=1)
        semseg_fwd = phase_timing_test(semseg_calls, phase="semseg_timing_test")
        semseg_sort = phase_timing_sort(semseg_sort_sizes, phase="semseg_timing_sort")
        # the two-rank checks: each reference step here, their ranks in one
        # spawn after cac_agree (phase_shared_ddp_agree)
        ddp_pending = [ddp_agree_pending] + [prepare_task_ddp_agree(work, task)
                                             for task in ("semseg", "ssl")]
        remat = phase_remat_agree()
        ppt_shapes, ppt_k1, ppt_k1_variants, ppt_k2_variants, ppt_checkpoint = \
            phase_ppt_train(work, steps=3)
        ppt_bwd = phase_timing_bwd(ppt_shapes, phase="ppt_timing_bwd")
        ppt_test_variants, ppt_fragments, ppt_calls = phase_ppt_test(work, ppt_checkpoint,
                                                                     n_voxels=50000)
        ppt_fwd = phase_timing_test(ppt_calls, phase="ppt_timing_test")
        phase_ppt_agree()
        ddp_pending.append(prepare_ppt_ddp_agree(work))
        phase_rpe_agree()
        phase_spunet_agree()
        insseg_val, insseg_model = phase_insseg_train(work, steps=3)
        phase_insseg_oracle(insseg_val, insseg_model)
        insseg_kernels = phase_insseg_agree()
        ddp_pending.append(prepare_task_ddp_agree(work, "insseg"))
        phase_msc_agree()
        phase_msc_train(work, steps=4)
        cac_config_path, cac_best = phase_cac_train(work, steps=3)
        phase_cac_test(work, cac_config_path, cac_best, n_voxels=50000)
        cac_kernels = phase_cac_agree()
        ddp_pending += [prepare_task_ddp_agree(work, task) for task in ("msc", "cac")]
        ddp_pending += prepare_grid_agree(work, grid_ref)
        del grid_ref
        ddp = phase_shared_ddp_agree(work, ddp_pending)
        del ddp_pending
        ddp_ranks = ddp["ddp_agree"]
        tp_ranks, cp_ranks, cp_serve = ddp["tp_agree"], ddp["cp_agree"], ddp["cp_serve"]
        tasks_ddp = {task: ddp[f"{task}_ddp_agree"] for task in ("semseg", "ssl")}
        ppt_ddp, insseg_ddp = ddp["ppt_ddp_agree"], ddp["insseg_ddp_agree"]
        spunet_ddp = {task: ddp[f"{task}_ddp_agree"] for task in ("msc", "cac")}
        phase_ppt_spunet_train(work, steps=3)
        ptv2_counts = dict(ptv2_agree=phase_ptv2_agree())
        ptv2_config_path, ptv2_best, ptv2_counts["ptv2_train"] = phase_ptv2_train(work)
        ptv2_sorts, ptv2_counts["ptv2_test"] = phase_ptv2_test(work, ptv2_config_path, ptv2_best,
                                                                n_voxels=50000)
        ptv2_counts["ptv1_agree"] = phase_ptv1_agree()
        ptv2_counts["ppt_ptv2_train"] = phase_ppt_ptv2_train(work, steps=3)
        with tempfile.TemporaryDirectory() as rooms:
            root, data_s = write_sparse_rooms(rooms)
            sparse_counts, mink_sorts = sparse_phases(work, root, data_s)
            fps_times, st_counts, st_sorts = st_phases(work, root, data_s)
        cls_counts, cls_timing = cls_phases()
        phase_profiler_hook(work, phase="profiler_hook_last", strict=False)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)
    source = "scenesplat_tpu_torch/csrc/flash_window_attn.cu"
    # bf16 at windows of at most 64: the decoder's launches of the train and
    # test paths
    source_small = "scenesplat_tpu_torch/csrc/flash_window_attn_fwd_small.cu"
    # the bf16 and fp16 backward (the one-pass variant; the two-kernel one in
    # _bwd_large.cu); flash_window_attn.cu holds its fp32 twin
    source_bwd = "scenesplat_tpu_torch/csrc/flash_window_attn_bwd.cu"
    source_bwd_large = "scenesplat_tpu_torch/csrc/flash_window_attn_bwd_large.cu"
    # bf16 at windows of 128 and more: every launch of the serve path, and
    # the encoder's launches of the train path
    source_large = "scenesplat_tpu_torch/csrc/flash_window_attn_fwd.cu"
    # launches: the count of the path's run (4 serve forwards, 3 train
    # steps, the test run's fragment forwards with the sort switch on); ms
    # and the other times: per forward or per step (18 attention launches, 8
    # sorts; the small forward: the decoder's 6 launches of a test fragment
    # forward). "semseg": the same for the semseg file's path (4 train
    # steps of 22 attention launches; the test run's fragment forwards, the
    # first one's 14 encoder and 8 decoder launches timed, 10 sorts)

    def times(t, pre=""):
        """A timing phase's sums, of the forward with lse with pre "fwd_"."""
        return dict(ms=t["fwd_lse_ms" if pre else "ms"], plain_ms=t[pre + "plain_ms"],
                    bound_ms=t[pre + "bound_ms"], bound_by=t[pre + "bound_by"],
                    library_ms=t[pre + "library_ms"])

    semseg_test = dict(path="semseg test", fragment_forwards=semseg_fragments,
                       ms_per="test fragment forward (the first fragment's calls, no lse)")
    semseg_train = dict(path="semseg train", ms_per="train step")
    # "ppt": PPT-v1m1 over the semseg file's backbone (PDNorm, two
    # conditions) through MultiDatasetTrainer, 3 train steps of 22 attention
    # launches, and its test entry's fragment forwards (the first one's 22
    # launches timed); ppt_ddp_agree's two ranks' PPT-v1m2 steps beside
    ppt_test = dict(path="ppt test", fragment_forwards=ppt_fragments,
                    ms_per="test fragment forward (the first fragment's calls, no lse)")
    ppt_train = dict(path="ppt train", ms_per="train step")
    # "ssl": the SSL file's path, 4 train steps of 7 backbone passes; ms
    # and the other times per step (timing at the student's shapes: the
    # globals' 22 launches twice, the locals' 22 forward and 14 backward
    # launches three times); the teacher's launches, without lse, are
    # counted apart
    ssl_train = dict(path="ssl train", ms_per="train step", steps=ssl_counts["steps"])
    ssl_small = ssl_bwd["fwd_by_variant"]["bf16_small"]
    # "ddp": data parallel, the flagship trainer under DDP at one process
    # (NCCL, 3 steps and one validation, as "train") and the two ranks of
    # ddp_agree on the one card (gloo: one fp32 step each, then their share
    # of the 3 test scenes' fragment forwards), launches summed over ranks
    ddp = dict(path="ddp train", ms_per="train step", world1_steps=ddp_record["steps"])
    # the semseg and SSL files' fp32 steps under two ranks on the one card
    # (semseg_ddp_agree, ssl_ddp_agree), launches summed over the ranks; and
    # remat_agree's flagship fp32 step without and with remat_blocks (the
    # recompute launches K1 with lse once more a block)
    ddp_tasks = {f"{task}_two_rank_launches": tasks_ddp[task]["k1_lse"] for task in tasks_ddp}
    ddp_tasks_k2 = {f"{task}_two_rank_launches": tasks_ddp[task]["k2"] for task in tasks_ddp}
    # "insseg": PointGroup. Over SpUNet (spunet_agree, insseg_train and its
    # evaluation, insseg_ddp_agree's two ranks) no attention kernel runs;
    # insseg_agree runs PG over the semseg file's PT-v3m1, one fp32 step
    # with the kernels (its launches; no times: fp32 at one block a stage)
    insseg = dict(path="insseg", spunet_launches=0,
                  spunet_two_rank_launches=insseg_ddp["k1_lse"] + insseg_ddp["k1"],
                  agree_ms_per="fp32 train step of PG over PT-v3m1, one block a stage")
    # "spunet_tasks": MSC and CAC over SpUNet and PPT over SpUNet-v1m3
    # (msc_agree, msc_train, cac_train, cac_test, msc_ddp_agree,
    # cac_ddp_agree, ppt_spunet_train) launch no attention kernel;
    # cac_agree runs CAC over the semseg file's PT-v3m1, one fp32 step with
    # the kernels (its launches; no times: fp32 at one block a stage)
    spunet_tasks = dict(path="msc, cac, ppt over SpUNet-v1m3", spunet_launches=0,
                        spunet_two_rank_launches=sum(
                            d["k1_lse"] + d["k1"] for d in spunet_ddp.values()),
                        agree_ms_per="fp32 train step of CAC over PT-v3m1, one block a stage")
    # "ptv2": PT-v2m2 and PTv1 (ptv2_agree, ptv2_train, ptv2_test,
    # ptv1_agree) and PPT over PT-v2m3 (ppt_ptv2_train) have no window
    # attention: each phase counts K1 and K2 from 0 and checks 0; K3 runs on
    # the ptv2 test path with the switch on

    def ptv2_path(kernel):
        by_phase = {phase: c[kernel] for phase, c in ptv2_counts.items()}
        return dict(path="ptv2, ptv1, ppt over PT-v2m3", launches=sum(by_phase.values()),
                    phase_launches=by_phase)

    # "sparse": MinkUNet34C, SPVCNN, OACNNs and OctFormer-v1m1 (the
    # <name>_agree and <name>_train phases, mink_test) have no window
    # attention (OctFormer's is plain torch with its RPE bias): each phase
    # counts K1 and K2 from 0 and checks 0; K3 runs on the mink test path
    # with the switch on

    def sparse_path(kernel):
        by_phase = {phase: c[kernel] for phase, c in sparse_counts.items()}
        return dict(path="minkunet, spvcnn, oacnns, octformer", launches=sum(by_phase.values()),
                    phase_launches=by_phase)

    # "st": ST-v1m2 (st_agree, st_train, st_test) has no window attention of
    # K1's kind (its slot attention with the RPE tables is plain torch): each
    # phase counts K1 and K2 from 0 and checks 0; K3 runs on the st test
    # path with the switch on; the FPS kernel on every ST forward

    def st_path(kernel):
        by_phase = {phase: c[kernel] for phase, c in st_counts.items()}
        return dict(path="st-v1m2", launches=sum(by_phase.values()), phase_launches=by_phase)

    # "cls": DefaultClassifier over PT-v3m1 in cls_mode (cls_agree in fp32,
    # cls_test in bf16: 14 K1 launches a classifier forward), PTv1 PartSeg50
    # (partseg_test: the FPS kernel 4 times a forward) and the losses
    # (loss_agree): each phase counts every kernel from 0

    def cls_path(kernel):
        by_phase = {phase: c[kernel] if kernel in c else sum(r[kernel] for r in c.values())
                    for phase, c in cls_counts.items()}
        return dict(path="cls, partseg, losses", launches=sum(by_phase.values()),
                    phase_launches=by_phase)

    teacher_large = ssl_teacher["by_variant"]["bf16_large"]
    teacher_small = ssl_teacher["by_variant"]["bf16_small"]
    # "wide": the flagship's channels with heads of width 64 (32 at encoder
    # stage 0), bf16: its serve forward (2 forwards counted) and its trainer
    # (1 + 2 steps and the validation's forwards counted), K1 and K2
    # launches by (variant, type, instantiated width); ms per serve forward
    # or train step at its shapes. "fp16": one float16 serve forward of the
    # flagship. "widths": kernel_widths' launches by (variant, type,
    # instantiated width) at head widths 8 to 128, the variants' times at
    # width 64 (per call, "<type>/K<window>") and the wrapper pad's time at
    # the padded widths (per call at a window of 1024, beside the call)
    wide_serve = dict(path="wide_serve (heads of width 64, bf16, 196,608 Gaussians)",
                      ms_per="serve forward", launches=sum(wide["serve_counts"]["k1"].values()),
                      width_launches=wide["serve_counts"]["k1"], **times(wide["serve"]))
    fp16_serve = dict(path="fp16_serve (the flagship in float16, 196,608 Gaussians)",
                      ms_per="serve forward", launches=sum(wide["fp16_counts"]["k1"].values()),
                      width_launches=wide["fp16_counts"]["k1"],
                      mean_cosine_to_fp32=wide["fp16_mean_cosine"], **times(wide["fp16"]))
    wide_train = dict(path="wide_train (heads of width 64, the flagship file's trainer)",
                      ms_per="train step", steps=wide["train_steps"])
    emit({"kernels": [
        dict(name="flash_window_attention_fwd", route="cuda", source=source_large,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="serve",
             launches=launches, variant_launches=serve_variants,
             ms_per="serve forward", max_abs_err=max(worst32, worst_widths), ms=tot["ms"],
             plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=tot["bound_by"],
             library_ms=tot["library_ms"],
             semseg=dict(semseg_test, launches=semseg_on["k1_variants"]["bf16_large"],
                         **times(semseg_fwd["by_variant"]["bf16_large"])),
             ssl_teacher=dict(ssl_train, ms_per="train step (the teacher's 2 passes over the "
                              "global crops, no lse; its encoder's windows of 1024)",
                              launches=ssl_counts["teacher"]["bf16_large"],
                              **times(teacher_large)),
             ppt=dict(ppt_test, launches=ppt_test_variants["bf16_large"],
                      **times(ppt_fwd["by_variant"]["bf16_large"])),
             cp_serve=dict(path="cp_serve (seq 2, two ranks on the card)",
                           ms_per="not timed (the serve phase's forward is)",
                           rank_launches=cp_serve["k1"]),
             cls=dict(cls_path("k1"), ms_per="classifier forward (bf16, 14 launches at "
                      "windows of 1024, the shapes of one cls_test object)",
                      test_launches=sum(r["k1_variants"]["bf16_large"]
                                        for r in cls_counts["cls_test"].values()),
                      agree_fp32_launches=cls_counts["cls_agree"]["k1_variants"]["fp32"],
                      **times(cls_timing)),
             wide=wide_serve, fp16=fp16_serve,
             tools=dict(path="tools (entry.py --save-features, the PCA tool; 40,000 "
                             "Gaussians)", entry_launches=tools["entry_k1"],
                        pca_launches=tools["pca_k1"]),
             widths=dict(path="kernel_widths (head widths 8 to 128, fp32, bf16, fp16)",
                         width_launches=widths["counts"]["k1"],
                         padded_launches=widths["counts"]["k1_padded"],
                         ms_per="call", max_abs_err_fp32=worst_widths,
                         timed=widths["timed"], pad=widths["pads"])),
        dict(name="flash_window_attention_fwd_lse", route="cuda", source=source_small,
             sources=[source_small, source_large, source],
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="train",
             launches=k1_train, validation_launches=k1_val,
             variant_launches=k1_variants_train, ms_per="train step",
             max_abs_err=worst_fwd_lse,
             ms=tot_bwd["fwd_lse_ms"], plain_ms=tot_bwd["fwd_plain_ms"],
             bound_ms=tot_bwd["fwd_bound_ms"], bound_by=tot_bwd["fwd_bound_by"],
             library_ms=tot_bwd["fwd_library_ms"],
             semseg=dict(semseg_train, launches=semseg_k1, variant_launches=semseg_k1_variants,
                         by_variant=semseg_bwd["fwd_by_variant"], **times(semseg_bwd, "fwd_")),
             ssl=dict(ssl_train, launches=sum(ssl_counts["student_lse"].values()),
                      variant_launches=ssl_counts["student_lse"],
                      teacher_launches_without_lse=sum(ssl_counts["teacher"].values()),
                      teacher_variant_launches=ssl_counts["teacher"],
                      by_variant=ssl_bwd["fwd_by_variant"], **times(ssl_bwd, "fwd_")),
             ddp=dict(ddp, launches=ddp_record["k1_launches"] + ddp_ranks["k1_lse"],
                      world1_launches=ddp_record["k1_launches"],
                      world1_variant_launches=ddp_record["k1_variant_launches"],
                      world1_validation_launches=ddp_record["validation_k1_launches"],
                      two_rank_launches=ddp_ranks["k1_lse"],
                      two_rank_variant_launches=ddp_ranks["k1_lse_variants"],
                      two_rank_test_launches_without_lse=ddp_ranks["k1_test"],
                      two_rank_test_variant_launches=ddp_ranks["k1_test_variants"],
                      **ddp_tasks),
             remat=dict(path="remat_agree", ms_per="fp32 train step",
                        launches_per_step_off=remat["off"]["k1_lse"],
                        launches_per_step_on=remat["on"]["k1_lse"]),
             ppt=dict(ppt_train, launches=ppt_k1, variant_launches=ppt_k1_variants,
                      by_variant=ppt_bwd["fwd_by_variant"],
                      two_rank_launches=ppt_ddp["k1_lse"], **times(ppt_bwd, "fwd_")),
             insseg=dict(insseg, agree_launches=insseg_kernels["k1_lse"],
                         agree_variant_launches=insseg_kernels["k1_lse_variants"]),
             spunet_tasks=dict(spunet_tasks, agree_launches=cac_kernels["k1_lse"],
                               agree_variant_launches=cac_kernels["k1_lse_variants"]),
             ptv2=ptv2_path("k1"), sparse=sparse_path("k1"), st=st_path("k1"),
             cls=cls_path("k1_lse"),
             wide=dict(wide_train, launches=sum(wide["train_counts"]["k1"].values()),
                       width_launches=wide["train_counts"]["k1"],
                       **times(wide["train"], "fwd_")),
             tp_cp=dict(path="tp_agree (model 2: each rank's H / 2 heads), cp_agree (seq 2: "
                             "each rank's whole windows); fp32, two ranks on the card",
                        ms_per="not timed (fp32 agree steps)",
                        tp_rank_launches=tp_ranks["k1_lse"], cp_rank_launches=cp_ranks["k1_lse"],
                        tp_variant_launches=tp_ranks["k1_lse_variants"],
                        cp_variant_launches=cp_ranks["k1_lse_variants"])),
        dict(name="flash_window_attention_fwd_small", route="cuda", source=source_small,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="test",
             launches=test_variants["bf16_small"], variant_launches=test_variants,
             fragment_forwards=fragments, train_launches=k1_variants_train["train"]["bf16_small"],
             train_step=tot_bwd["fwd_by_variant"]["bf16_small"],
             ms_per="test fragment forward (the decoder's windows of 48, no lse)",
             max_abs_err=tot_test["max_abs_err"], ms=tot_test["ms"],
             plain_ms=tot_test["plain_ms"],
             bound_ms=tot_test["bound_ms"], bound_by=tot_test["bound_by"],
             library_ms=tot_test["library_ms"],
             semseg=dict(semseg_test, launches=semseg_on["k1_variants"]["bf16_small"],
                         train_launches=semseg_k1_variants["train"]["bf16_small"],
                         train_step=semseg_bwd["fwd_by_variant"]["bf16_small"],
                         **times(semseg_fwd["by_variant"]["bf16_small"])),
             ssl=dict(ssl_train, launches=ssl_counts["student_lse"]["bf16_small"],
                      teacher_launches_without_lse=ssl_counts["teacher"]["bf16_small"],
                      ms_per="train step (the student's decoder launches, with lse)",
                      ms=ssl_small["fwd_lse_ms"], plain_ms=ssl_small["fwd_plain_ms"],
                      bound_ms=ssl_small["fwd_bound_ms"], bound_by=ssl_small["fwd_bound_by"],
                      library_ms=ssl_small["fwd_library_ms"]),
             ssl_teacher=dict(ssl_train, ms_per="train step (the teacher's 2 passes' decoder "
                              "launches, no lse)", launches=ssl_counts["teacher"]["bf16_small"],
                              **times(teacher_small)),
             ppt=dict(ppt_test, launches=ppt_test_variants["bf16_small"],
                      train_launches=ppt_k1_variants["bf16_small"],
                      train_step=ppt_bwd["fwd_by_variant"]["bf16_small"],
                      **times(ppt_fwd["by_variant"]["bf16_small"]))),
        dict(name="flash_window_attention_bwd", route="cuda", source=source_bwd,
             sources=[source_bwd, source_bwd_large, source],
             replaces="scenesplat_tpu/ops/pallas_attn.py:98", path="train",
             launches=sum(k2_variants.values()), variant_launches=k2_variants,
             ms_per="train step", max_abs_err=worst_bwd,
             ms=tot_bwd["ms"], plain_ms=tot_bwd["plain_ms"], bound_ms=tot_bwd["bound_ms"],
             bound_by=tot_bwd["bound_by"], library_ms=tot_bwd["library_ms"],
             design_bound_ms=tot_bwd["design_bound_ms"],
             semseg=dict(semseg_train, launches=sum(semseg_k2_variants.values()),
                         variant_launches=semseg_k2_variants, **times(semseg_bwd)),
             ssl=dict(ssl_train, launches=sum(ssl_counts["k2"].values()),
                      variant_launches=ssl_counts["k2"], **times(ssl_bwd)),
             ddp=dict(ddp, launches=ddp_record["k2_launches"] + ddp_ranks["k2"],
                      world1_launches=ddp_record["k2_launches"],
                      world1_variant_launches=ddp_record["k2_variant_launches"],
                      two_rank_launches=ddp_ranks["k2"],
                      two_rank_variant_launches=ddp_ranks["k2_variants"], **ddp_tasks_k2),
             remat=dict(path="remat_agree", ms_per="fp32 train step",
                        launches_per_step_off=remat["off"]["k2"],
                        launches_per_step_on=remat["on"]["k2"]),
             ppt=dict(ppt_train, launches=sum(ppt_k2_variants.values()),
                      variant_launches=ppt_k2_variants, two_rank_launches=ppt_ddp["k2"],
                      **times(ppt_bwd)),
             insseg=dict(insseg, spunet_two_rank_launches=insseg_ddp["k2"],
                         agree_launches=insseg_kernels["k2"],
                         agree_variant_launches=insseg_kernels["k2_variants"]),
             spunet_tasks=dict(spunet_tasks, spunet_two_rank_launches=sum(
                 d["k2"] for d in spunet_ddp.values()), agree_launches=cac_kernels["k2"],
                 agree_variant_launches=cac_kernels["k2_variants"]),
             ptv2=ptv2_path("k2"), sparse=sparse_path("k2"), st=st_path("k2"),
             cls=cls_path("k2"),
             wide=dict(wide_train, launches=sum(wide["train_counts"]["k2"].values()),
                       width_launches=wide["train_counts"]["k2"], **times(wide["train"])),
             widths=dict(path="kernel_widths (head widths 8 to 128, fp32, bf16, fp16)",
                         width_launches=widths["counts"]["k2"],
                         padded_launches=widths["counts"]["k2_padded"],
                         ms_per="call (the times: the forward entry's widths.timed)"),
             tp_cp=dict(path="tp_agree, cp_agree (fp32, two ranks on the card)",
                        ms_per="not timed (fp32 agree steps)",
                        tp_rank_launches=tp_ranks["k2"], cp_rank_launches=cp_ranks["k2"],
                        tp_variant_launches=tp_ranks["k2_variants"],
                        cp_variant_launches=cp_ranks["k2_variants"])),
        dict(name="bitonic_sort", route="cuda",
             source="scenesplat_tpu_torch/csrc/bitonic_sort.cu",
             replaces="scenesplat_tpu/ops/pallas_sort.py:146", path="test",
             launches=sort_calls, kernel_launches=sort_kernels, fragment_forwards=fragments,
             ms_per="fragment forward",
             max_abs_err=max(worst_sort, tot_sort["max_abs_err"]), ms=tot_sort["ms"],
             plain_ms=tot_sort["plain_ms"], bound_ms=tot_sort["bound_ms"], bound_by="bytes",
             library_ms=tot_sort["library_ms"],
             semseg=dict(semseg_test, ms_per="fragment forward (the first fragment's sorts)",
                         launches=semseg_on["sort_calls"],
                         kernel_launches=semseg_on["sort_kernels"], ms=semseg_sort["ms"],
                         plain_ms=semseg_sort["plain_ms"], bound_ms=semseg_sort["bound_ms"],
                         bound_by="bytes", library_ms=semseg_sort["library_ms"],
                         max_abs_err=semseg_sort["max_abs_err"]),
             ptv2=dict(path="ptv2 test (PT-v2m2's 4 grid poolings, switch on)",
                       ms_per="fragment forward", launches=ptv2_sorts["sort_calls"],
                       kernel_launches=ptv2_sorts["sort_kernels"],
                       fragment_forwards=ptv2_sorts["fragments"]),
             sparse=dict(path=f"mink test (MinkUNet34C's {MINK_SORTS} sorts a fragment forward, "
                              "switch on)", ms_per="fragment forward",
                         launches=mink_sorts["sort_calls"],
                         kernel_launches=mink_sorts["sort_kernels"],
                         fragment_forwards=mink_sorts["fragments"]),
             st=dict(path=f"st test (ST-v1m2's {ST_SORTS} window-table sorts a fragment forward, "
                          "switch on)", ms_per="fragment forward",
                     launches=st_sorts["sort_calls"], kernel_launches=st_sorts["sort_kernels"],
                     fragment_forwards=st_sorts["fragments"]),
             cls=cls_path("k3"),
             tp_cp=dict(path="tp_agree, cp_agree, cp_serve (the switch off), counted a rank",
                        tp_rank_launches=tp_ranks["k3"], cp_rank_launches=cp_ranks["k3"],
                        cp_serve_rank_launches=cp_serve["k3"])),
        # not a TPU kernel: the JAX package's FPS is an XLA lax.fori_loop;
        # ms and the other times: the 5 calls of one ST forward at the train
        # rows' levels (fps_kernel), launches: st_train's run; ptv1 and
        # partseg: their forwards' 4 calls at fps_kernel's levels
        dict(name="farthest_point_sampling", route="cuda",
             source="scenesplat_tpu_torch/csrc/farthest_point_sampling.cu",
             replaces="none: scenesplat_tpu/ops/pointops.py:205 (farthest_point_sampling, an "
                      "XLA lax.fori_loop, not a Pallas kernel)",
             path="st train", launches=st_counts["st_train"]["fps"],
             phase_launches=st_path("fps")["phase_launches"],
             ms_per=f"ST train forward ({ST_FPS_CALLS} calls)", max_abs_err=0,
             library_ms=None, **fps_record(fps_times["st"]),
             ptv1=dict(path="ptv1 (ptv1_agree's transitions)", ms_per="PTv1 forward (4 calls)",
                       **fps_record(fps_times["ptv1"])),
             partseg=dict(cls_path("fps"), ms_per="PTv1 PartSeg50 forward (4 calls)",
                          **fps_record(fps_times["partseg"])))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--cards" and torch.cuda.is_available():
        sys.exit(main_cards(int(sys.argv[2]), sys.argv[3:]))
    sys.exit(main())
