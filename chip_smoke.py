#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cistar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script catches nothing):

1. the device: ``torch.cuda.get_device_name`` and the card's name and power
   limit from ``nvidia-smi``;
2. build the CUDA kernels from ``cistar_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once, sm_90a); print what ptxas reported of the
   ``wgmma`` conv's entries in that build (registers, spills; none may
   spill), in each of the five libraries that use it (K1/K2, K3, K5-K6,
   K7, K8), of K6's ``wg_branch_kernel``, and of every entry of K9's and
   K4's libraries (``head_cout1``,
   ``in_act``); count the HMMA instructions of K9's bf16 kernel in the
   library's SASS (``cuobjdump``; none would fail).

The ResNet path (slice 1): the CycleGAN ResNet-9 generator, 64 features,
256², random weights from seed 0.

3. K1 / K2 on the trunk activation of the main path's own batch,
   (8, 32, 32, 512): the int32 accumulators of the int8 reflect conv equal
   the plain version bit for bit, there and at the timed batch (64, 32,
   32, 512), and ``cistar_resblock_conv_variant`` names the ``wgmma`` conv
   at both (as its Python mirror does: BN 128 and 256); K1 (bf16 carrier)
   and K2 (int8 carrier) agree with their plain PyTorch versions within
   ``K1_*`` / ``K2_*`` at both batches (K2's scales at 64 within
   ``K2_SCALE_RTOL_BATCH``);
4. the path at batch 8: the bf16 forward and the int8 engine with both
   carriers, with the launch counters set to 0 just before and read just
   after. Fidelity, here and at the configuration where the JAX package set
   its 0.1 int8-engine budget (``tools/kernel_matrix.py``'s
   resnet_engine_e2e: 3 blocks, 32 features, 128², batch 32): each int8
   engine about as far from the fp32 forward as the same engine with the
   plain versions of its kernels on the same card (the JAX package's int8
   math, which the CPU tests hold to the JAX emulation) — mean-abs within
   ``KERNEL_MEAN_RATIO`` times, max-abs within ``KERNEL_MAX_EXCESS`` more;
   the distance to the 0.1 budget is printed. The same rule for both
   engines at the timed batch, 64;
5. serve three requests of (A, B) through ``CycleGANInference("p2p")``;
6. times with CUDA events: img/s of each engine at batch 64, and K1 / K2
   per launch at batch 8 and 64 beside their bound, their TOPS, their
   plain versions and the yardstick of their GEMM part (one
   ``torch._int_mm`` of both convs' im2col matrices, never called by the
   port).

The bilinear path (slice 2): ``bilinear_content``, the JAX engine's
default generator (``MultiscaleBilinearGenerator``), 16 features, 6 atrous
residual blocks, 512², random weights from seed 0.

7. K5 / K6 on the main path's own activations at batch 4: the int32
   accumulators of the int8 dilated conv equal the plain version bit for
   bit at every rate, at K5's trunk shape (4, 64, 64, 128), at K6's stage
   shape (4, 64, 64, 64→128) and at the 256² stage-1 shape
   (4, 64, 64, 32→64), and ``cistar_atrous_conv_variant`` equals its
   Python mirror at each, as (BN, bytes of K a stage): the ``wgmma`` conv
   at (128, 128) at K5's, at (128, 64) at K6's, ``conv_s8_kernel`` (0, 0)
   at stage 1's; K6 at stage 2 runs its two passes with the branch outputs
   on chip (``int8_atrous.stage_fused``); K5 and K6 agree with their plain
   versions within ``K5_*`` / ``K6_*``; their distance to the JAX
   package's family budgets vs the fp32 modules is printed;
8. the path at batch 4: the bf16 forward and the int8 engine, counted: one
   generator call launches K5 6 times, K6 once (the JAX engine's routing
   rule sends only stage 2 to int8 at 512²), K1 / K2 never. Fidelity as in
   phase 4, against the same engine with plain K5 / K6;
9. serve three requests through ``CycleGANInference("bilinear_content")``;
10. times with CUDA events at batch 32, the JAX suite's
    ``bilinear512_int8`` shape: img/s of each engine, one profile each,
    each engine's time by segment (stem, the three encoder stages, the
    trunk, decoder + head), and K5 / K6 per launch at batch 4 and 32
    beside their bound, their TOPS, their plain versions and the yardstick
    of their GEMM part (one ``torch._int_mm`` of their convs' im2col
    matrices stacked: K5's four dilated zero-pad and one reflect, K6's
    four dilated). Before the times, phase 7's checks at batch 32: the
    variant queries, every rate's int32 accumulators, K5 within ``K5_*``,
    K6 within ``K6_*``.

The pix2pixHD paths (slice 3), random weights from seed 0, 512²:
``global`` (``GlobalGenerator``) at the reference CLI's defaults, ngf 64,
4 downsamplings, 9 resnet blocks (a 1024-channel trunk at 32², which the
JAX engine's rule sends to the cout-tiled chain, K7); and ``UNet``
(``UNetGeneratorHD``, the r2l_MSRB experiment's generator), 64 features,
3 MSRB blocks at (B, 64, 64, 512), K8. Each path, as the two above:

11. the kernels on the path's own trunk activation (``global`` at batch
    4, ct 256; ``UNet`` at batch 2): the int32 accumulators of K7's conv 1
    (through the grouped RAW entry at one group, and through K1's RAW
    entry, which runs K7a's conv at K7a's BN) and of every group of its
    conv 2, and of both K8 branches in both stages, equal the plain
    versions bit for bit, and each library's variant query
    (``cistar_tiled_a_conv_variant``, ``cistar_tiled_conv_variant``,
    ``cistar_msrb_conv_variant``) names the ``wgmma`` conv for K7a's (BN
    of ``wg_bn``, equal to K1's), K7b's and each K8 conv's shape (BN 128),
    as its Python mirror does; K7a's int8
    output differs by at most ``K7_MAX_LSB`` on at most ``K7_MAX_FRAC`` of
    the elements, K7b on the plain K7a's output and the K7 block are
    within ``K7_*`` of plain; K8's stage-1 int8 outputs and tile scales
    are bit-exact, stage 2 within ``K8_*``; one block's distance to the
    JAX package's family budget vs its fp32 module is printed;
12. the path at its checked batch (``global`` 4, ``UNet`` 2), counted:
    one ``global`` call launches K7a 9 times and K7b 9 times, one ``UNet``
    call K8 12 times, and no other kernel. Fidelity as in phase 4, against
    the same engine with the plain K7 / K8;
13. serve three requests through ``Pix2PixHDInference``: ``infer_step``
    and ``infer_step_int8``;
14. times with CUDA events at the JAX suite's shapes (``global`` batch 16,
    ``UNet`` batch 8): img/s of both engines, one profile each, a
    breakdown by segment (stem, downs, trunk, ups, head), and K7a / K7b /
    K8 per launch beside their bounds, their plain versions, their TOPS
    and the yardstick of their GEMM part (one ``torch._int_mm`` of the
    same conv's im2col matrix: reflect 3×3 for K7a and K7b, zero-pad 3×3
    / 5×5 for K8). Before the times, K7a, K7b and K8 at the timed batch
    pass phase 11's checks (variant queries, K7a's conv 1 at BN 256 and
    every group's int32 accumulators, K7a within ``K7_MAX_*``, K8 stage 1
    bit-exact, stage 2 and K7b within tolerance): the timed batch runs
    other builds than the checked one by the variant rule, so both are
    checked.

The fused-kernel paths of ResNet-9 (slice 4), the phase-4 generator
(64 features, 9 blocks, 256², seed 0), batch 8 checked and 64 timed:

15. K3, K4 and K9 on the main path's own activations against their plain
    versions: K3 (``fused_conv3x3_in_act``) on the trunk input (8, 32, 32,
    512) and at the timed batch (64, 32, 32, 512) with bf16 weights, conv 1
    with ReLU and conv 2 with the residual, within ``K3_*``, its conv alone
    (``conv3x3_bf16_f32``, the ``wgmma`` conv) against an fp32 conv of the
    same bf16 values within ``K3_CONV_REL``, and in fp32 at (8, 32, 32, 64), a shape whose fp32
    weights the JAX rule sends to K3, within ``K3_FP32_ABS``; K4
    (``fused_instance_norm_act``) on the raw down_1, down_2 and up_0
    outputs with ReLU, and on down_2 in the leaky, tanh and residual forms,
    within ``K4_*``; K9 on the raw up_2 output (8, 256, 256, 64), with and
    without ``pre_in``, within ``K9_*``; ``cistar_in_act_variant`` at the
    three K4 shapes (a cluster of 8 CTAs at 64² × 256, 2 at 32² × 512)
    against its Python mirror, and K9's shared memory; then K4 (relu) on the
    three stage outputs and K9 (tanh, and ``pre_in``) on the up_2 output
    of the timed batch, 64, within the same tolerances;
16. the bf16 fast forward (``resnet_generator_fast_apply``) of the module
    with bf16 weights, counted: 18 K3 launches and no other kernel; the
    same forward of the fp32-weight module: no K3 launch, equal to the bf16
    module forward. Its distance to the fp32 forward within the rule of
    phase 4 of the bf16 module forward's, at batch 8 and 64; img/s of both
    at batch 64, K3 per launch at batch 8 and 64 beside its bound, its conv
    alone and the yardstick of its GEMM part (cuDNN's bf16 ``F.conv2d``,
    channels_last);
17. the int8 engine (``resnet_generator_int8_trunk_apply``) under
    ``_FUSED_STAGE_IN = "1"``: 9 K1 + 3 K4 launches per generator call;
    then under each K9 variant of ``_HEAD_KERNEL``: 9 K1 + 1 K9. Each
    against the same engine with the plain K4 / K9: max-abs to the
    default engine and to the fp32 forward within the plain's + 0.1,
    mean-abs to fp32 within 1.1×; three requests served through
    ``CycleGANInference("p2p")`` (counted: three generator calls each),
    img/s at batch 64; K4 (relu) at its three shapes and K9 (tanh, and
    ``pre_in``) at batch 8 and 64 beside their bounds, with GB/s or
    TFLOP/s and their yardsticks (``F.instance_norm``; cuDNN's bf16
    ``F.conv2d`` of the pre-padded input to one channel, channels_last,
    the pad excluded);
18. ``global_generator_fast_apply`` at the pix2pixHD CLI defaults, batch
    4: no K3 launch (the 1024-channel weights exceed the JAX rule), equal
    to the bf16 ``GlobalGenerator`` forward.

The pix2pixHD ``multiscale`` and ``local`` paths (slice 5), random weights
from seed 0: ``multiscale`` (``MultiscaleGlobalGenerator``, always
BatchNorm; the r2l experiment's netG: ngf 64, 9 blocks) at 512², whose
(B, 64, 64, 512) trunk the JAX rule sends to the ``bn=True`` form of K7 at
ct 128, and at 256², whose (B, 32, 32, 512) trunk fits K1's ``bn=True``
form; ``local`` (``LocalEnhancer``, the JAX suite's ``p2phd1024_int8``:
ngf 32, one enhancer, 3 global downs, 9 global and 3 local blocks) at
1024², whose global trunk is (B, 64, 64, 512) with instance norm: K7 at
ct 128. Random running statistics (0, 1) normalize nothing, so each
BatchNorm's statistics are set from a seeded calibration batch, layer by
layer (``calibrate``).

19. the kernels on the paths' own trunk activations: K7a-bn and K7b-bn at
    (2, 64, 64, 512), ct 128, and K1-bn at (8, 32, 32, 512), each equal to
    its plain version bit for bit (rq, rs and the block output); K7 (IN)
    at ct 128 on ``local``'s trunk (2, 64, 64, 512) under K7's rules; K7a's
    and K7b's variant queries, K7a's conv 1 and every group's int32
    accumulators at both trunks;
    each block's distance to the tiled family budget (0.35) vs its fp32
    module is printed;
20. each path, counted: ``multiscale`` 512² batch 2 launches 9 K7a-bn + 9
    K7b-bn, ``multiscale`` 256² batch 8 9 K1-bn, ``local`` 1024² batch 2 9
    K7a + 9 K7b, and no other kernel; fidelity as in phase 4, against the
    same engine with the plain kernels;
21. three requests served per family through ``Pix2PixHDInference``
    (``infer_step`` and ``infer_step_int8``), counted;
22. times with CUDA events: img/s of both engines, ``multiscale`` at batch
    8 (512²) and ``local`` at batch 4 (1024², the suite's
    ``p2phd1024_int8``), one profile each, a breakdown by segment, and the
    kernels per launch beside their bounds and their plain versions (K1-bn
    also at batch 64, bit-exact there too, with phase 6's GEMM yardstick;
    K7a-bn / K7b-bn at batch 8 and K7a / K7b at ``local``'s batch 4 after
    phase 19's checks at that batch, K7a-bn and K7b-bn bit-exact, K7a
    within ``K7_MAX_*``, each with its TOPS and the GEMM yardstick of its
    conv).

The CycleGAN training path (slice 11), ``CycleGAN`` at the JAX CLI's
defaults: ``bilinear_content``, 16 features, 6 atrous blocks, 512², batch
4, pool 50, bf16 compute with fp32 params, gradients, Adam state and
losses, weights from seed 0. It runs the plain ops under autograd (the
kernels are forward-only), in ``torch.enable_grad()``:

23. the card's train step against the CPU's, the same seed and 16
    features / 6 blocks at 64², batch 2, pool 8, fp32 with TF32 off: 3
    steps on the same dense frames (all in the pools' fill phase), the
    card's each from the CPU's state before it; every metric within
    ``TRAIN_RTOL``, and G_A2B's output after each step within
    ``TRAIN_ABS`` max-abs;
24. the full-width step on frames of ``tools/make_synthetic_r2l.py``,
    counted: 2 warm-up and 10 timed steps (CUDA events) with every launch
    counter set to 0 before and still 0 after; ms a step, img/s and
    ``torch.cuda.max_memory_allocated``; ``skipped`` 0 on every step,
    finite losses, G's and D's params moved;
25. one step under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    sync in a step), a ``[breakdown]`` of one step by phase (G forward +
    loss, G backward, G Adam, the pools, the D_A step, the D_B step) and a
    ``[profile]`` top 8;
26. the training CLI, ``apps/cyclegan_train.py``, on 16 synthetic pairs at
    512²: one epoch (8 train pairs, 2 steps at batch 4), the per-epoch and
    latest ``.npz`` of the four nets written, and a ``--resume`` run that
    loads them.

The other CycleGAN generators (slice 12) at the JAX CLIs' defaults
(``cistar_tpu/apps/cyclegan_train.py:19-48``, ``cyclegan_test.py:18-30``):
16 features, 6 residual blocks, 512², bf16; random weights from seed 0.
``atrous_content`` with the dense decoder (``MultiscaleDenseDecoder``, the
JAX suite's ``atrousdense512_int8``), ``atrous_content`` without it
(``MultiscaleGenerator``, four dilated transpose-conv branches a stage)
and ``unet_content`` (``UnetGenerator``). Their int8 engines run the trunk
(B, 64, 64, 128) through K1 and, in 'atrous', encoder stage 2 through K6:

27. K1 on the dense 'atrous' path's own trunk activation at (4, 64, 64,
    128) and at the timed (32, 64, 64, 128): the int32 accumulators of
    ``conv3x3_reflect_s8`` equal the plain version bit for bit,
    ``cistar_resblock_conv_variant`` is 128 as its Python mirror says, K1
    is within ``K1_*`` of plain; one block's distance to the JAX package's
    res-trunk budget (0.35) vs its fp32 module is printed;
28. each family at batch 4, counted: a generator call of the int8 engine
    launches 6 K1 and, in 'atrous', 1 K6, and no other kernel; fidelity as
    in phase 4, against the same engine with the plain K1 / K6. Then the
    non-dense 'atrous' engine under ``_HEAD_KERNEL = "tap_matmul"``: 6 K1
    + 1 K6 + 1 K9, and K9 on its head input (4, 512, 512, 16) within
    ``K9_*`` of plain;
29. three requests per family served through ``CycleGANInference``
    (``infer_step`` and ``infer_step_int8``), counted: 3 generator calls
    each;
30. times with CUDA events at batch 32: img/s of each family's bf16 and
    int8 engine, one profile each, each engine's time by segment (stem,
    the three encoder stages, the trunk, the decoder, the head), and K1
    per launch at batch 4 and 32 beside its bound, its TOPS, its plain
    version and phase 6's GEMM yardstick at this shape;
31. one ``CycleGAN.train_step`` at 512², batch 4, bf16 (after a warm-up
    step) of ``unet_content``, of ``unet_content`` with the VGG16 content
    loss (the training CLI's ``--content_loss``) and of the non-dense
    ``atrous_content``: every launch counter still 0, finite losses,
    ``skipped`` 0, ms a step; then ``apps/cyclegan_test.py`` on the first
    two runs' checkpoints and 4 synthetic pairs at 512², both engines: the
    recovered PNG and its 5-panel strip written.

The Gatys IST path (slice 13): VGG-19 to relu5_1, the Gram style loss and
torch-semantics L-BFGS at the JAX CLI's defaults (512², 300 iterations,
history 100 in fp32, bf16 VGG with fp32 loss and L-BFGS), the
coarse-to-fine pass at 1024² (500 iterations) and batched sweeps; VGG
weights ``init_vgg_params(seed=0)``, frames from
``tools/make_synthetic_r2l.py``. It launches no port kernel:

32. checks at 64²: max-pool ties (windows drawn from {0, 1, 2}) route the
    gradient on the card as on the CPU (bf16 and fp32, channels_last); the
    VGG-19 features on the card against the CPU's, fp32 with TF32 off and
    bf16 (``GATYS_FEAT_*``); ``optimize`` in fp32 on the card against the
    CPU, from the same weights and frames, at 1 iteration within the
    reference's gate (``GATYS_RTOL`` / ``GATYS_ATOL``), and 3 iterations
    each from the CPU's state within the same gate (free-running, the two
    can take other branches at the second: printed); ``optimize_batch`` at
    F = 3 against three F = 1 calls on the card, at 1 iteration within the
    reference's gate;
33. at 512², batch 1: ms an iteration (CUDA events over the 300) of the
    bf16, fp32 and bf16-history engines, and of 100 HR iterations at
    1024²; 300 bf16 iterations again under
    ``torch.cuda.set_sync_debug_mode("error")`` (the loop reads nothing on
    the host); every launch counter 0; the final loss finite and below the
    first; a ``[breakdown]`` of one iteration (direction, forward + loss,
    backward, history update; device and host ms), a ``[profile]`` (device
    busy against wall, top kernels, none of them the port's); s a frame of
    ``transfer_style`` and its peak memory;
34. ``transfer_style_batch`` at F = 4, 512²: frames/s against phase 33's
    per-frame rate;
35. ``python -m cistar_tpu_torch.apps.ist_main`` on 4 synthetic 512²
    radar frames with a lidar style frame, ``--polar --hr HRDATA.IMG_SIZE
    1024`` at the default 300 + 500 iterations: 4 PNGs of 1024², each the
    inverse-polar warp of its HR result, and s/frame in its log.

The pix2pixHD training path (slice 14), ``Pix2PixHD`` at the shipped
recipe ``checkpoints/r2l_MSRB_7/opt.txt``: ``UNet``, ngf 64, 3 MSRB blocks,
num_D 2, n_layers_D 3, ndf 64, instance norm, LSGAN with GAN feature
matching, no VGG loss, lr 1e-4, beta1 0.5, pool 0, 512², batch 1, bf16
compute with fp32 params (the JAX CLI's default); weights from seed 0,
frames from ``tools/make_synthetic_r2l.py``. The train step runs the plain
ops under autograd (no port kernel); the test CLI's int8 engine runs K8:

36. the card's ``Pix2PixHD.train_step`` against the CPU's at 64², batch 2,
    fp32 with TF32 off, each card step from the CPU's state before it:
    ``UNet`` with 8 features, 1 MSRB block, ndf 8, 3 steps; then one step
    of ``multiscale`` (training-mode BatchNorm) and one of ``global`` with
    netE (``instance_feat``, instance maps), with the VGG19 loss and
    without; the CPU replays the card's activation patterns (ReLU and
    LeakyReLU sides, max pool picks: ``same_kinks``), and those it would
    have taken otherwise lie within ``TRAIN_ABS`` of their kink; every
    metric, each net's backward from the same state and inputs, and the
    Adam first moment of G, D and netE (the gradient, which Adam does not
    amplify: each net's max-abs error over its largest value), within
    ``TRAIN_RTOL``; G's output in the step, ``multiscale``'s running
    statistics and G's output after the step, as stepped and with the
    CPU's values at the weights whose Adam update took the other sign,
    within ``TRAIN_ABS``;
37. the full-width step, counted: 2 warm-up and 30 timed steps (CUDA
    events around each) with every launch counter 0 before and after; ms a
    step (the mean; each step's min, median and max), img/s and
    ``torch.cuda.max_memory_allocated``; finite losses,
    ``G_GAN_Feat`` > 0, G's and D's params moved. Then the same for the
    CLI's ``global`` default (ngf 64, 4 downsamplings, 9 blocks) with the
    VGG19 loss;
38. for each of the two, one step under ``torch.cuda.set_sync_debug_mode
    ("error")``, a ``[breakdown]`` of one step by phase (G forward + loss,
    G backward, G Adam, D forward + backward, D Adam; device and host ms)
    and a ``[profile]`` top 8;
39. ``apps/p2phd_train.py`` with ``--load_opt checkpoints/r2l_MSRB_7/
    opt.txt`` on 16 synthetic pairs at 512², ``--niter 1 --niter_decay 0``
    in a temporary ``--checkpoints_dir``: the latest G and D ``.npz`` and
    ``iter.txt`` written; a ``--continue_train`` run resumes at epoch 2 from
    them;
40. ``apps/p2phd_test.py`` on that checkpoint and 4 test pairs at
    ``--data_type 32`` (no kernel launched) and ``8`` (12 K8 a generator
    call and no other kernel, counted): the PNGs and the gallery written;
    the int8 engine on those 4 frames as far from the fp32 forward as the
    same engine with the plain K8 (phase 12's rule); K8 per launch at batch
    1, the CLI's batch, beside its bound, its plain version and the GEMM
    yardstick of its conv (one ``torch._int_mm`` of the im2col, as phase
    12 times it at batch 2 and 8).

The extended pix2pixHD trainers (slice 15): plain ops under autograd, no
port kernel; the UDA CLI, the feature tools and the UI session:

41. each trainer's step on the card against the CPU's at 64², batch 2,
    fp32 with TF32 off, from the same state, the CPU replaying the card's
    activation patterns (``same_kinks``): ``R2LAE`` with both feature
    critics, ``R2LImageCritic`` with explicit interpolation weights (the
    penalty's double backward), ``R2LTransfer`` with the feature critic's
    gate open and then, from the CPU's state, closed (DF and its Adam state
    then unchanged), and phase 36's checks of the transfer pair and of
    ``netG=autoencoder``; every metric, each net's Adam first moment after
    the step (from zero moments, (1 − b1)·∇: its backward), the outputs of
    the step and the BatchNorm running statistics, within ``TRAIN_RTOL`` /
    ``TRAIN_ABS``; ``R2LTransfer``'s frozen nets bit for bit unchanged;
42. the full-width steps (the constants ``EXT_*``): ``R2LAE`` at
    ``r2l_MSRB_7`` through ``create_uda_model`` (fp32, ``--fp16``,
    ``--wgan``), the CLI's default image critic, ``R2LTransfer`` and the
    transfer pair through ``create_model`` at the JAX constructors' widths,
    ``Pix2PixHD`` with ``netG=autoencoder`` at ``r2l_MSRB_7``'s G widths:
    2 warm-up and 30 timed steps each (CUDA events around each), every
    launch counter 0 before and after; ms a step (mean; min, median, max),
    img/s, ``max_memory_allocated``; finite losses, the trained nets moved,
    ``R2LTransfer``'s frozen nets bit for bit unchanged;
43. one step each of ``R2LAE`` and ``R2LTransfer`` under
    ``set_sync_debug_mode("error")``, a ``[breakdown]`` by phase and a
    ``[profile]``;
44. ``apps/p2phd_train.py --uda`` with ``--load_opt checkpoints/r2l_MSRB_7/
    opt.txt`` for both training modules on 16 synthetic 512² pairs (one
    epoch of the 30% split): the ``.npz`` files written, no kernel
    launched; ``R2LAE.infer`` on the saved nets and 4 test frames, a frame
    alone as in the batch; the same two calls again with cuDNN's
    deterministic algorithms (no autotuning), every module's frame-0 output
    recorded in both and the first that differs printed (``[uda cli]``);
45. ``apps/encode_features.py`` ``--mode maps`` and ``--mode cluster`` at
    512² (nef 16, 4 downsamplings, 3 features, 10 clusters) on those frames,
    the encoder on the card; an ``EditSession`` over ``global`` with three
    feature channels: a stroke edit composited inside its box (nothing
    outside it changes) and a style switch to a cluster centre.

LPIPS, checkpoint import and the dashboard (slice 16; the dashboard uses no
device and is not driven here):

46. the rows of ``tools/fidelity_table.py`` at its shapes, weights from
    seed 0, inputs from the port's ``make_radar``: ``cyclegan256``
    (ResNet-9, 64 features, 8 × 256², int8 through K1), ``p2phd_global512``
    (``global``, ngf 64, 4 downsamplings, 9 blocks, 4 × 512²; K7a + K7b at
    ct 256), ``unet_msrb512`` (``UNet`` at ``r2l_MSRB_7``'s widths, 4 ×
    512²; K8), ``local1024`` (``local``, ngf 32, 2 × 1024²; K7 at ct 128):
    for each, the fp32 forward (TF32 off), the bf16 forward and the int8
    engine (counted: the row's kernels, no other); each engine's calibrated
    LPIPS metric and pixel L1 against fp32 (``utils/fidelity.py::
    fidelity_metric``, computed in fp32 with TF32 off), each within
    ``BUDGET`` (1e-2); the first row's ``lpips_distance`` of frames 0-1
    (bf16, fp32) on the card within ``LPIPS_CPU_RTOL`` of the CPU's;
47. the reference's checkpoints: seeded ``state_dict`` s of the torch twins
    (``tools/reference_twins.py``) saved as ``.pth`` in a temporary
    directory, the ``UNet`` of ``checkpoints/r2l_MSRB_7/opt.txt`` as
    ``latest_net_G.pth`` and the CycleGAN test CLI's ``bilinear_content``
    pair with its two D as ``netG_A2B.pth`` … ``netD_B.pth``; each converted
    by ``python -m cistar_tpu_torch.apps.convert_checkpoint`` (five
    processes side by side), each ``.npz`` equal key for key and bit for bit
    to what ``core/convert_models.py``'s ``*_from_pth`` gives; then, each in
    a process of its own, the four side by side (``CLI_RUNNER``: the CLI's
    ``main`` with its engine's calls recorded and the launch counts
    printed), ``p2phd_test --data_type 32`` and ``8`` (K8, 12 a frame) and
    ``cyclegan_test --dtype fp32`` and ``--engine int8`` (K5 18 and K6 3 a
    frame) on 2 test frames of 512²: the fp32 outputs within
    ``CKPT_FP32_ABS`` of the twins' fp32 forwards of the same frames on the
    card with one-pass instance norms and within ``CKPT_REF_ABS`` with their
    own (TF32 off), the int8 outputs within ``BUDGET`` of the same CLI's
    fp32 in ``fidelity_metric``; the seconds each step took.

Exported programs and data parallelism (``runtime/``,
``parallel/``; the kernels are ``cistar`` custom ops,
``kernels/custom_ops.py``, so ``torch.export`` traces through them):

48. exported programs on the card (``export_path``): the ResNet-9 int8
    engine (64 features, 256², batch 64: K1) and the ``bilinear_content``
    int8 engine (16 features, 6 blocks, 512², batch 32: K5, K6), each the
    per-rank program of ``make_sharded_infer`` (``InferProgram``, weights
    as arguments) exported, saved and loaded (``runtime/aot.py``); then
    ``p2phd_test --data_type 8 --export_onnx`` and ``--engine`` at
    ``r2l_MSRB_7`` (``UNet``, 512², K8) on a seeded checkpoint, through the
    CLI. For each: export and load seconds, eager and loaded ms a call
    (``profile_fn``), the loaded program's op table, top 8
    (``runtime/profiler.py``), which must name the case's kernels (K1; K5
    and K6; K8: kernels the trace links to their ``cistar`` op), its
    launches counted (only the case's kernels); the loaded program against
    the eager call under cuDNN's deterministic mode: bit for bit where two
    eager calls are, else (the kernels' IN sums in atomics) the eager
    calls' gap printed and the loaded program's error against the fp32
    forward within ``KERNEL_MEAN_RATIO`` / ``KERNEL_MAX_EXCESS`` of the
    eager call's, the run-to-run budget of phases 4 and 8;
49. data parallelism at world size 1 with NCCL (``dp_path``; a
    ``file://`` rendezvous in a temporary directory): the CycleGAN step
    (``bilinear_content``, 512², batch 4) and the ``r2l_MSRB_7`` pix2pixHD
    step, each with the mesh against the same engine without, from the
    same state, in fp32 with TF32 off (as phases 36 and 41 hold their
    steps: in bf16 the backward's atomics, in bilinear upsampling and
    reflect padding, move G's gradients by a bf16 rounding from run to
    run), with the activation patterns replayed (``same_kinks``) and
    cuDNN deterministic: the metrics and Adam's first moments within
    ``TRAIN_RTOL`` (phase 41's rule); ms a step of both in bf16, the
    CLIs' default; ``make_sharded_infer`` at ResNet-9, 256², batch 64,
    both engines, against the unsharded engines as phase 48 holds a
    loaded program, and ms a call of both.
    One card cannot run NCCL with two ranks: world size 2 is the CPU
    tests' (gloo, ``tests/test_torch_parallel.py``).
50. spatial sharding at world size 1 with NCCL (``spatial_path``, one
    group for phases 50-52): the ``local`` generator of the JAX suite's
    p2phd1024 row (ngf 32, 1024²) and r2l_MSRB_7's ``UNet`` (512²), the
    slab forward (``parallel/spatial_models.py``) against the whole-image
    forward on the same seeded weights, fp32 with TF32 off: max-abs within
    ``SPATIAL_ABS`` and pixel L1 beside JAX's ``spatial256`` row; bf16 ms
    a call and peak memory at batch 2 and 4, sharded against unsharded;
51. the ``p2phd1024`` train step (``local``, num_D 3, batch 1) and the
    ``r2l_MSRB_7`` step with ``spatial_mesh`` against without, held in fp32
    and timed in bf16 as phase 49 holds and times its steps, with a
    ``[profile]`` of each; then ``p2phd_train --spatial_shard`` (one
    epoch) and ``p2phd_test --spatial_shard`` (its gallery) on synthetic
    512² pairs, each a process of its own;
52. ``R2LAE`` at r2l_MSRB_7's widths and the image critic, 512², with a
    ``mesh`` against without (held in fp32, timed with ``--fp16``), then
    ``p2phd_train --uda`` for both modules inside the NCCL group;
53. the native PNG loader (``data/native_loader.py``, built with g++ and
    libpng at first use) against the PIL decode: images/s at 512² with 8
    threads on the card's host; where the host cannot build it, the PIL
    fallback of ``make_cyclegan_dataset``, printed;
54. ``ops/quant.py``'s int8 ResNet-9 (64 features, 256², batch 1) on the
    card: every int32 product (``torch._int_mm``) equal to the CPU's exact
    product of the same int8 operands; ms a call.
    These paths launch no port kernel: each runs with every launch counter
    at 0 and checks that they stay there.

The fp32 reference forwards run with TF32 off, the rest under PyTorch's
defaults. The line before the last is the card's name and power limit; the
kernels' JSON line comes before it; the last line is
``{"ok": true, "device": ...}``. Exits non-zero, printing no result,
without CUDA or without the package beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, SIZE, FEATURES, BLOCKS = 8, 256, 64, 9
BENCH_BATCH = 64
# The int8 engine's max-abs budget vs fp32 in the JAX package
# (benchmarks/kernel_matrix_r5.json, resnet_engine_e2e), set on the
# configuration BUDGET_CFG (tools/kernel_matrix.py).
# The int8 math itself misses it at 9 blocks / 64 features, and lands near
# it at BUDGET_CFG with other random weights (PERF.md, Findings), so it is
# printed, not enforced. What is enforced: the kernels add little to the
# error of the plain versions of the same math. They differ from them only
# by LSB flips of the requantized tensors (the kernels sum the IN
# statistics with atomics, in another order), on ~1e-4 of the elements:
# the mean-abs error over the 524,288 outputs barely moves (10% allowed);
# the max-abs error can move by the flips' local effect (0.04 seen, 0.1
# allowed).
E2E_BUDGET, BUDGET_CFG = 0.1, dict(blocks=3, features=32, size=128, batch=32)
KERNEL_MEAN_RATIO, KERNEL_MAX_EXCESS = 1.1, 0.1
# K1 vs its plain version, bf16 carrier, per element: one bf16 ulp of the
# value (at most 2^-7 of it) plus 0.01, the most by which one flipped LSB
# of the requantized intermediate moves an output (4.3e-3 seen with an
# fp32 carrier; the kernel sums the IN statistics with atomics, in another
# order than the plain version).
K1_REL, K1_ABS = 2.0 ** -7, 0.01
# K2 vs its plain version: the same LSB flips, at most one LSB per element
# on at most 0.1% of the elements; the per-image scales to 1e-4 relative.
K2_MAX_LSB, K2_MAX_FRAC, K2_SCALE_RTOL = 1, 1e-3, 1e-4
# At the timed batch of 64 images, one flipped LSB of the requantized
# intermediate among the 4,608 inputs of an image's largest output is
# likely: it moves that output, and so the image's scale (max / 127), by
# |w2| * s_mid / sigma2, up to ~5e-4 of it at these weights (1.8e-4 seen,
# with int8 outputs within one LSB on 1.7e-4 of the elements). 1e-3 there.
K2_SCALE_RTOL_BATCH = 1e-3

# bilinear_content as the JAX engine and CLI default it; the checked batch
# and the JAX suite's bilinear512_int8 batch (benchmarks/run_suite.py)
BIL = dict(features=16, blocks=6, size=512, batch=4)
BIL_BENCH_BATCH = 32
RATES, RATES2 = (2, 4, 6, 8), (1, 2, 3, 4)
# The JAX package's family budgets, max-abs of one int8 block vs its fp32
# module (benchmarks/kernel_matrix_r5.json): printed, as the 0.1 above.
ATROUS_BUDGET, STAGE_BUDGET = 0.25, 0.35
# K5 vs its plain version, bf16 carrier: as K1 — one bf16 ulp of the value
# plus 0.01 for an LSB flip of the requantized branch sum (atomics order).
K5_REL, K5_ABS = 2.0 ** -7, 0.01
# K6 vs its plain version: no requantization, so only the order of the
# fp32 IN sums differs (~1e-7 relative), which can move a bf16 output by
# one ulp; 1e-4 absolute covers the values near 0, where 2^-7 of the value
# is less than that order effect.
K6_REL, K6_ABS = 2.0 ** -7, 1e-4

# pix2pixHD at the reference CLI's defaults (apps/p2phd_options.py:87-89:
# ngf 64, 4 downsamplings, 9 blocks) and the r2l_MSRB experiment
# (checkpoints/r2l_MSRB_7/opt.txt: UNet, ngf 64, 3 blocks), 512²; the
# checked batch, and the batch of the JAX suite's p2phd512_int8 /
# unet512_int8 rows (benchmarks/run_suite.py)
P2PHD = {"global": dict(ngf=64, n_downsample_global=4, n_blocks_global=9,
                        batch=4, bench_batch=16),
         "UNet": dict(ngf=64, n_downsample_global=3, n_blocks_global=3,
                      batch=2, bench_batch=8)}
P2P_SIZE, K7_TILE, K8_TILE = 512, 256, 128
# The JAX package's family budgets (benchmarks/kernel_matrix_r5.json,
# trunk_tiled and msrb): max-abs of one int8 block vs its fp32 module,
# printed.
TILED_BUDGET, MSRB_BUDGET = 0.35, 0.35
# K7a vs its plain version: the IN statistics are summed with atomics in
# another order, so a requantized LSB can flip (as K2's): at most one LSB
# on at most 0.1% of the elements. The K7 block: one bf16 ulp + 0.01, K1's
# rule.
K7_MAX_LSB, K7_MAX_FRAC = 1, 1e-3
K7_REL, K7_ABS = 2.0 ** -7, 0.01
# K8 stage 2 vs its plain version: no statistics; the fp32 group sum and
# dequantize are the same ops in the same order, so one bf16 ulp + 1e-4.
K8_REL, K8_ABS = 2.0 ** -7, 1e-4

# K3 (bf16) and K4 vs their plain versions: the same fp32 math, summed in
# another order (the statistics by atomics), then one cast: one bf16 ulp
# of the value plus 1e-4 (8.6e-6 over one ulp seen). K3 in fp32, TF32 off
# on the plain side: the order of sums (6.7e-6 seen).
K3_REL, K3_ABS, K3_FP32_ABS = 2.0 ** -7, 1e-4, 1e-4
# K3's conv alone (conv3x3_bf16_f32) vs an fp32 conv of the same bf16
# values, TF32 off: both sum 4,608 exact products in fp32 in other orders.
# Each element within 2^-13 of its sum of |x*w| (one fp32 rounding is 2^-24
# of it; a blocked sum of 4,608 terms stays far below 2^11 of those; 2.4e-5
# seen against values up to 3.8).
K3_CONV_REL = 2.0 ** -13
K4_REL, K4_ABS = 2.0 ** -7, 1e-4
# K9 as K3 without pre_in (3.2e-6 over one ulp seen). With pre_in the IN
# statistics, summed in another order, can round a normalized input to the
# neighbouring bf16 value; each such input moves the output by its tap
# weight times one input ulp (1.1e-3 over one ulp seen at (8, 256, 256,
# 64), 4e-3 allowed).
K9_REL, K9_ABS, K9_PRE_ABS = 2.0 ** -7, 1e-4, 4e-3
# The K9 variants of fast_infer._HEAD_KERNEL (the JAX switch
# CISTAR_HEAD_KERNEL); "shift" and "xla" run no kernel.
HEAD_VARIANTS = ("tap_matmul", "loop", "maskedloop", "masked")

# pix2pixHD multiscale (the r2l experiment's netG, SURVEY.md:158: 9
# blocks, 1 channel, the default ngf 64) and local (benchmarks/run_suite.py
# p2phd1024_int8: ngf 32, 1024², batch 4; the defaults of one enhancer, 3
# global downs and 3 local blocks): the checked batches and the timed ones.
MULTISCALE = dict(ngf=64, n_blocks_global=9, size=512, batch=2,
                  small_size=256, small_batch=8, bench_batch=8)
LOCAL = dict(ngf=32, n_downsample_global=3, n_blocks_global=9,
             n_local_enhancers=1, n_blocks_local=3, size=1024, batch=2,
             bench_batch=4)
# K7's tile at 64²×512, the JAX kernel path's pick_cout_tile; the images of
# the BatchNorm calibration batch
BN_TILE, CALIB_BATCH = 128, 4

# Peaks of an H100 SXM (NVIDIA data sheet; dense int8 and bf16 tensor-core
# operations, HBM bandwidth), for the bound of each kernel.
PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 1979e12, 989e12, 3.35e12


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the fp32 reference forwards (cuDNN convs default to
    TF32). The engines run under PyTorch's defaults: their convs take bf16
    inputs, which TF32 holds exactly."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after two warm-up calls."""
    import torch

    fn()
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def profile_top(fn, k: int = 8) -> tuple:
    """One profiled call (after one warm-up call,
    ``runtime/profiler.py::profile_op_table``): wall ms, summed
    device-kernel ms, and the ``k`` kernels with the most device time as
    (ms, name), a port kernel's name led by its id (``K1 ...``)."""
    from cistar_tpu_torch.runtime.profiler import profile_op_table

    rows, totals = profile_op_table(fn, iters=1, device="cuda")
    return (totals["wall_ms"], totals["total_ms"],
            [(r["total_ms"], r["op"]) for r in rows[:k]])


def print_times(label: str, batch: int, fn) -> None:
    """img/s over 5 calls, then one profiled call."""
    ms = cuda_ms(fn, 5)
    print(f"[times] {label} batch {batch}: {ms!r} ms, "
          f"{batch / ms * 1e3!r} img/s", flush=True)
    wall, busy, top = profile_top(fn)
    print(f"[profile] {label} batch {batch}: wall {wall!r} ms, device busy "
          f"{busy!r} ms; top device time (ms): "
          + "; ".join(f"{k[:48]} {t!r}" for t, k in top), flush=True)


def bound(ops: float, nbytes: float, peak: float = PEAK_INT8_OPS) -> tuple:
    """(least ms, what bounds it) for ``ops`` operations at ``peak`` (int8
    by default) moving ``nbytes`` bytes."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_bound_ms(x, w, res) -> tuple:
    """K3: the 3×3 conv's operations at the bf16 rate against x, w, the
    bias, the output and the residual."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    out = n * h * wd * cout * x.element_size()
    return bound(2 * n * h * wd * 9 * cin * cout,
                 x.numel() * x.element_size() + w.numel() * w.element_size()
                 + cout * 4 + out * (2 if res is not None else 1),
                 PEAK_BF16_FLOPS)


def k9_bound_ms(x) -> tuple:
    """K9: 49·Cin multiply-adds a pixel at the bf16 rate against x, the
    (49, Cin) fp32 taps and the one-channel output."""
    n, h, w, c = x.shape
    return bound(2 * n * h * w * 49 * c,
                 x.numel() * x.element_size() + 49 * c * 4
                 + n * h * w * x.element_size(), PEAK_BF16_FLOPS)


def k9_pre_bound_ms(x) -> tuple:
    """K9 with ``pre_in``: as :func:`k9_bound_ms`, and the statistics read
    x once more."""
    n, h, w, c = x.shape
    return bound(2 * n * h * w * 49 * c,
                 2 * x.numel() * x.element_size() + 49 * c * 4
                 + n * h * w * x.element_size(), PEAK_BF16_FLOPS)


def k_bound_ms(n: int, h: int, w: int, c: int, carrier_bytes: int) -> tuple:
    """Least time of one int8 residual block (K1 / K2) on the card: two 3×3
    convs of int8 operations against carrier in + out and both int8
    weights."""
    return bound(2 * 2 * n * h * w * 9 * c * c,
                 2 * n * h * w * c * carrier_bytes + 2 * 9 * c * c + 4 * c * 4)


def k5_bound_ms(n: int, h: int, w: int, c: int, carrier_bytes: int) -> tuple:
    """K5: five 3×3 convs against carrier in + out and five int8 weights."""
    return bound(5 * 2 * n * h * w * 9 * c * c,
                 2 * n * h * w * c * carrier_bytes + 5 * 9 * c * c
                 + 10 * c * 4)


def k6_bound_ms(n: int, h: int, w: int, cin: int, cout: int,
                carrier_bytes: int) -> tuple:
    """K6 at (n, h, w) output pixels: four 3×3 convs against the even
    pixels of the input (all it reads), the output and four int8
    weights."""
    return bound(4 * 2 * n * h * w * 9 * cin * cout,
                 n * h * w * (cin + cout) * carrier_bytes
                 + 4 * 9 * cin * cout + 8 * cout * 4)


def k7_bound_ms(n: int, h: int, w: int, c: int, half: str) -> tuple:
    """K7a (``half`` "a") or K7b ("b"): one 3×3 conv over all of C against
    K7a's bf16 input and int8 output, or K7b's int8 input, bf16 skip and
    bf16 output, plus one int8 weight and the scale / bias rows."""
    act = 2 + 1 if half == "a" else 1 + 2 + 2
    return bound(2 * n * h * w * 9 * c * c,
                 n * h * w * c * act + 9 * c * c + 4 * c * 4)


def k8_bound_ms(n: int, h: int, w: int, cin: int, cout: int, kk: int,
                quant_out: bool) -> tuple:
    """One K8 branch: a kk×kk conv against its int8 input, its int8
    (stage 1) or bf16 (stage 2) output and its int8 weight."""
    return bound(2 * n * h * w * kk * kk * cin * cout,
                 n * h * w * (cin + cout * (1 if quant_out else 2))
                 + kk * kk * cin * cout + 2 * cout * 4)


def im2col_reflect(xq):
    """The (N·H·W, 9·C) matrix of a reflect-pad-1 3×3 conv of NHWC ``xq``,
    k = tap·C + c (the layout of the kernels' ``wk``)."""
    import torch
    import torch.nn.functional as F

    n, h, w, c = xq.shape
    xp = F.pad(xq.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="reflect") \
        .to(xq.dtype).permute(0, 2, 3, 1)
    return torch.cat([xp[:, dy:dy + h, dx:dx + w].reshape(n * h * w, c)
                      for dy in range(3) for dx in range(3)], dim=1)


def im2col_zero(xq, kk: int, rate: int = 1):
    """The (N·H·W, kk²·C) matrix of a zero-pad kk×kk conv at dilation
    ``rate`` (padding rate·(kk // 2)) of NHWC ``xq``, k = tap·C + c (the
    layout of K8's and K5's ``wk``)."""
    import torch
    import torch.nn.functional as F

    n, h, w, c = xq.shape
    p = rate * (kk // 2)
    xp = F.pad(xq, (0, 0, p, p, p, p))
    return torch.cat([xp[:, dy * rate:dy * rate + h, dx * rate:dx * rate + w]
                      .reshape(n * h * w, c)
                      for dy in range(kk) for dx in range(kk)], dim=1)


def gemm_ms(a, wk) -> float:
    """One ``torch._int_mm`` of the int8 (M, K) im2col matrix ``a`` by the
    (K, Cout) weights ``wk.t()``: the yardstick of a conv's GEMM part.
    Timed here; the port never calls it."""
    import torch

    b = wk.t()
    return cuda_ms(lambda: torch._int_mm(a, b), 10)


def int_mm_ms(xq, wk) -> float:
    """The yardstick of the GEMM part of one int8 res block (two convs):
    one ``torch._int_mm`` of the im2col matrix stacked twice (2·N·H·W, 9·C)
    by the (9·C, C) weights."""
    import torch

    a = im2col_reflect(xq)
    return gemm_ms(torch.cat([a, a]), wk)


def atrous_gemm_ms(xq, wk, rates, reflect: bool) -> float:
    """The yardstick of the GEMM part of K5 (``reflect``: its four dilated
    branch convs and its reflect conv) or K6 (the four branches): one
    ``torch._int_mm`` of the convs' im2col matrices stacked, by one (9·Cin,
    Cout) weight."""
    import torch

    cols = [im2col_zero(xq, 3, r) for r in rates]
    if reflect:
        cols.append(im2col_reflect(xq))
    return gemm_ms(torch.cat(cols), wk)


def dilated_conv_vs_plain(label: str, xq, q, rates, want: tuple) -> None:
    """The dilated zero-pad conv of K5's / K6's branches at ``xq``'s shape:
    the library's variant query against the Python mirror and ``want``
    ((BN, bytes of K a stage) of the ``wgmma`` conv; (0, 0):
    ``conv_s8_kernel``), and the int32 accumulators of each branch's
    weights at its rate bit for bit against the plain version."""
    import torch

    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.ops import quant_int8 as qi

    shape = (*xq.shape, q["wbq"].shape[-1])
    card, mirror = ka.conv_variant_card(*shape), ka.conv_variant(*shape)
    print(f"[kernels] {label} conv at {tuple(xq.shape)} -> {shape[-1]}: "
          f"variant {card} (Python mirror {mirror}; (BN, K stage bytes) of "
          f"the wgmma conv, (0, 0) mma.sync)", flush=True)
    check(card == mirror == want, f"{label} {shape}: variant {want}")
    for bi, r in enumerate(rates):
        acc_k = ka.conv3x3_dilated_s8(xq, q["wbk"][bi], r)
        acc_p = qi.conv3x3_dilated_s8_plain(xq, q["wbq"][bi], r)
        check(torch.equal(acc_k, acc_p),
              f"conv3x3_dilated_s8 {label} {tuple(xq.shape)} rate {r} bit-exact")
    print(f"[kernels] conv3x3_dilated_s8 {label} {tuple(xq.shape)} -> "
          f"{shape[-1]}, rates {rates}: int32 accumulators bit-exact vs "
          f"plain", flush=True)


def k5_vs_plain(h, q) -> tuple:
    """K5 on ``h`` against its plain version within one bf16 ulp +
    ``K5_ABS``: (the kernel's output, its max-abs error)."""
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.ops import quant_int8 as qi

    yk = ka.atrous_resblock_int8(h, q, RATES, qi.EPS)
    yp = qi.atrous_resblock_int8_plain(h, q)
    d = (yk.float() - yp.float()).abs()
    err, over = d.max().item(), (d - K5_REL * yp.float().abs()).max().item()
    print(f"[kernels] K5 atrous_resblock_int8 {tuple(h.shape)} bf16: "
          f"max|kernel-plain| {err!r}, max over one ulp {over!r} (tol "
          f"{K5_ABS})", flush=True)
    check(over <= K5_ABS, f"K5 {tuple(h.shape)} within one bf16 ulp + 0.01 "
          "of plain")
    return yk, err


def k6_vs_plain(x, q) -> tuple:
    """K6 on the full-resolution stage input ``x`` against its plain
    version on ``x[:, ::2, ::2]`` within one bf16 ulp + ``K6_ABS``: (the
    kernel's output, its max-abs error)."""
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.ops import quant_int8 as qi

    yk = ka.multi_atrous_stage_int8(x, q, RATES2, qi.EPS)
    yp = qi.multi_atrous_stage_int8_plain(x[:, ::2, ::2], q, RATES2)
    d = (yk.float() - yp.float()).abs()
    err, over = d.max().item(), (d - K6_REL * yp.float().abs()).max().item()
    fused = ka.stage_fused(*yk.shape[:3], x.shape[-1], yk.shape[-1], RATES2)
    print(f"[kernels] K6 multi_atrous_stage_int8 {tuple(x.shape)} -> "
          f"{tuple(yk.shape)} bf16: max|kernel-plain| {err!r}, max over one "
          f"ulp {over!r} (tol {K6_ABS}); branch outputs on chip: {fused}",
          flush=True)
    check(fused, f"K6 {tuple(x.shape)} on its fused passes")
    check(over <= K6_ABS, f"K6 {tuple(x.shape)} within one bf16 ulp + 1e-4 "
          "of plain")
    return yk, err


def k7a_conv_vs_plain(label: str, h, qblk) -> None:
    """K7a's conv 1 at ``h``'s shape, K1's conv at K1's BN: K7a's variant
    query against the Python mirror and K1's (whose RAW entry runs the same
    conv at the same BN), not 0; and the int32 accumulators of the
    quantized ``h`` through K1's RAW entry bit for bit against the plain
    version."""
    import torch

    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.ops import quant_int8 as qi

    shape = tuple(h.shape)
    card, mirror = kt.a_conv_variant_card(*shape), kt.a_conv_variant(*shape)
    raw = kr.conv_variant_card(*shape)
    print(f"[kernels] {label} conv 1 at {shape}: wgmma BN {card} (Python "
          f"mirror {mirror}, K1's RAW entry {raw}; 0 would be mma.sync)",
          flush=True)
    check(card == mirror == raw != 0, f"{label} {shape} on the wgmma conv")
    hq, _ = qi.quantize_act(h)
    check(torch.equal(kr.conv3x3_reflect_s8(hq, qblk["w1k"]),
                      qi.conv3x3_reflect_s8_plain(hq, qblk["w1q"])),
          f"{label} conv 1 {shape}: int32 accumulators bit-exact")
    print(f"[kernels] {label} conv 1 {shape} at BN {card}: int32 "
          f"accumulators bit-exact vs plain", flush=True)


def k7a_vs_plain(label: str, h, qblk, ct: int, bn: bool = False) -> tuple:
    """K7a on ``h`` against its plain version: ``bn``, rq and rs bit for
    bit; else rq within ``K7_MAX_LSB`` on at most ``K7_MAX_FRAC`` of the
    elements. Returns the plain rq / rs and the max-abs of the
    dequantized difference."""
    import torch

    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.ops import quant_int8 as qi

    rqk, rsk = kt.resblock_int8_tiled_a(h, qblk, ct, qi.EPS, bn=bn)
    rqp, rsp = qi.resblock_tiled_a_plain(h, qblk, ct, bn=bn)
    dq = (rqk.int() - rqp.int()).abs()
    frac = (dq > 0).float().mean().item()
    s_rel = ((rsk - rsp).abs() / rsp).max().item()
    scale = lambda rs: rs.repeat_interleave(ct, 1)[:, None, None]  # noqa: E731
    err = (rqk.float() * scale(rsk) - rqp.float() * scale(rsp)).abs().max().item()
    print(f"[kernels] {label} {tuple(h.shape)} ct {ct}: max|dq| "
          f"{dq.max().item()} LSB on {frac!r} of elements, tile scale rel err "
          f"{s_rel!r}, max|dequant diff| {err!r}, bit-exact "
          f"{torch.equal(rqk, rqp) and torch.equal(rsk, rsp)}", flush=True)
    if bn:
        check(torch.equal(rqk, rqp) and torch.equal(rsk, rsp),
              f"{label} {tuple(h.shape)} rq and rs bit-exact vs plain")
    else:
        check(dq.max().item() <= K7_MAX_LSB and frac <= K7_MAX_FRAC,
              f"{label} {tuple(h.shape)} within one LSB on 0.1% of plain")
    return rqp, rsp, err


def check_grouped_variant(label: str, card: int, mirror: int) -> None:
    """A grouped conv's variant query (K7b, K8), the library's answer
    against the Python mirror: BN 128 of the ``wgmma`` conv, not 0 (the
    ``mma.sync`` conv)."""
    print(f"[kernels] {label}: wgmma BN {card} (Python mirror {mirror}; 0 "
          f"would be mma.sync)", flush=True)
    check(card == mirror == 128, f"{label} on the wgmma conv")


def print_conv_times(name: str, shape, ms: float, ops: float, bnd: float,
                     lib_ms: float, extra: str = "") -> None:
    """One conv kernel's time beside its bound, its TOPS and the
    ``torch._int_mm`` yardstick of its GEMM part."""
    print(f"[times] {name} {shape}: {ms!r} ms, bound {bnd!r} ms, "
          f"{ops / ms * 1e-9!r} TOPS{extra}; GEMM yardstick (torch._int_mm "
          f"of its im2col) {lib_ms!r} ms", flush=True)


def print_block_times(name, shape, ms, carrier_bytes, lib_ms,
                      plain_ms=None) -> None:
    """One int8 res block's time beside its bound, its TOPS and the GEMM
    yardstick of its two convs."""
    n, h, w, c = shape
    bnd, by = k_bound_ms(n, h, w, c, carrier_bytes)
    ops = 2 * 2 * n * h * w * 9 * c * c
    plain = "" if plain_ms is None else f", plain {plain_ms!r} ms"
    print(f"[times] {name} {shape}: {ms!r} ms, bound {bnd!r} ms ({by}), "
          f"{ops / ms * 1e-9!r} TOPS{plain}; GEMM yardstick (torch._int_mm "
          f"of both convs' im2col) {lib_ms!r} ms", flush=True)


def resnet_path(dev, images, counters) -> list:
    """Phases 3-6; the kernels' JSON rows of K1 and K2."""
    import torch

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import quant_int8 as qi

    int8_engine = fi.resnet_generator_int8_trunk_apply
    gen = seeded_generator("p2p", BLOCKS, FEATURES, seed=0, device=dev)
    qblocks = qi.quantize_resnet_trunk(gen)

    def plain_engine(g, qb, x, carrier):
        """The int8 engine with the plain versions of K1 / K2."""
        h = fi.resnet_encode(g, x)
        if carrier == "bf16":
            for q in qb:
                h = qi.resblock_int8_bf16io_plain(h, q)
        else:
            hq, hs = qi.quantize_act(h)
            for q in qb:
                hq, hs = qi.resblock_int8_plain(hq, hs, q)
            h = (hq.float() * hs[:, :, None, None]).to(h.dtype)
        return fi.resnet_decode(g, h)

    x = images(BATCH, SIZE)

    # 3. kernels at the main path's width, on its trunk activation
    h = fi.resnet_encode(gen, x.bfloat16()).contiguous()
    n, hh, ww, c = h.shape
    check((n, hh, ww, c) == (BATCH, 32, 32, 512), f"trunk shape {h.shape}")
    q0 = qblocks[0]
    hq, hs = qi.quantize_act(h)
    acc_k = kr.conv3x3_reflect_s8(hq, q0["w1k"])
    acc_p = qi.conv3x3_reflect_s8_plain(hq, q0["w1q"])
    check(torch.equal(acc_k, acc_p), "conv3x3_reflect_s8 int32 accumulators "
          "equal the plain version bit for bit")
    print(f"[kernels] conv3x3_reflect_s8 {tuple(hq.shape)}: int32 "
          f"accumulators bit-exact vs plain", flush=True)
    # the same at the timed batch, on a seeded batch of its own (the
    # images() stream of the later phases stays as it was)
    x64 = torch.rand(BENCH_BATCH, SIZE, SIZE, 1,
                     generator=torch.Generator().manual_seed(64)) * 2 - 1
    h64 = fi.resnet_encode(gen, x64.to(dev).bfloat16()).contiguous()
    h64q, h64s = qi.quantize_act(h64)
    check(torch.equal(kr.conv3x3_reflect_s8(h64q, q0["w1k"]),
                      qi.conv3x3_reflect_s8_plain(h64q, q0["w1q"])),
          "conv3x3_reflect_s8 bit-exact at the timed batch")
    print(f"[kernels] conv3x3_reflect_s8 {tuple(h64q.shape)}: int32 "
          f"accumulators bit-exact vs plain", flush=True)
    for shape in (tuple(hq.shape), tuple(h64q.shape)):
        v_card, v_py = kr.conv_variant_card(*shape), kr.conv_variant(*shape)
        print(f"[kernels] K1 / K2 conv at {shape}: wgmma BN {v_card} (Python "
              f"mirror {v_py}; 0 would be mma.sync)", flush=True)
        check(v_card == v_py and v_card in (128, 256),
              f"the wgmma conv at {shape}")

    def k1_k2(h, hq, hs, s_rtol) -> tuple:
        """K1 and K2 against their plain versions, K2's scales within
        ``s_rtol``; their max-abs errors."""
        y1k = kr.resblock_int8_bf16io(h, q0, qi.EPS)
        y1p = qi.resblock_int8_bf16io_plain(h, q0)
        d1 = (y1k.float() - y1p.float()).abs()
        k1_err = d1.max().item()
        k1_over = (d1 - K1_REL * y1p.float().abs()).max().item()
        print(f"[kernels] K1 resblock_int8_bf16io {tuple(h.shape)} bf16: "
              f"max|kernel-plain| {k1_err!r}, max over one ulp {k1_over!r} "
              f"(tol {K1_ABS})", flush=True)
        check(k1_over <= K1_ABS, f"K1 {tuple(h.shape)} within one bf16 ulp "
              f"+ 0.01 of plain")

        (q2k, s2k), (q2p, s2p) = kr.resblock_int8(hq, hs, q0, qi.EPS), \
            qi.resblock_int8_plain(hq, hs, q0)
        dq = (q2k.int() - q2p.int()).abs()
        frac = (dq > 0).float().mean().item()
        s_rel = ((s2k - s2p).abs() / s2p).max().item()
        k2_err = (q2k.float() * s2k[:, :, None, None]
                  - q2p.float() * s2p[:, :, None, None]).abs().max().item()
        print(f"[kernels] K2 resblock_int8 {tuple(hq.shape)}: max|dq| "
              f"{dq.max().item()} LSB on {frac!r} of elements, scale rel err "
              f"{s_rel!r} (tol {s_rtol}), max|dequant diff| {k2_err!r}",
              flush=True)
        check(dq.max().item() <= K2_MAX_LSB and frac <= K2_MAX_FRAC
              and s_rel <= s_rtol,
              f"K2 {tuple(hq.shape)} within tolerance of plain")
        return k1_err, k2_err

    # at the checked batch (BN 128) and at the timed one (BN 256)
    k1_err, k2_err = k1_k2(h, hq, hs, K2_SCALE_RTOL)
    k1_k2(h64, h64q, h64s, K2_SCALE_RTOL_BATCH)

    # 4. the main path, counted
    for m in counters:
        m.reset_launches()
    y_bf16 = gen(x.bfloat16()).float()
    y_k1 = int8_engine(gen, qblocks, x.bfloat16(), "bf16").float()
    y_k2 = int8_engine(gen, qblocks, x.bfloat16(), "int8").float()
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[resnet path] launches {launches}", flush=True)
    check(launches["resblock_int8_bf16io"] == BLOCKS,
          f"{BLOCKS} K1 launches per generator call")
    check(launches["resblock_int8"] == BLOCKS,
          f"{BLOCKS} K2 launches per generator call")
    check(launches["atrous_resblock_int8"] == 0
          and launches["multi_atrous_stage_int8"] == 0,
          "no K5 / K6 launch on the ResNet path")

    def fidelity(label, g, qb, xf, ys):
        """Error vs the fp32 forward of the kernel engines ``ys`` (by
        carrier) and of the same engines with plain blocks."""
        with fp32_exact():
            y32 = g(xf)
        for carrier, y in ys.items():
            dk = (y - y32).abs()
            dp = (plain_engine(g, qb, xf.bfloat16(), carrier).float()
                  - y32).abs()
            (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item())
                                  for d in (dk, dp))
            print(f"[{label}] int8 engine, {carrier} carrier, vs fp32: "
                  f"max {mk!r} mean {ak!r}; with plain blocks max {mp!r} "
                  f"mean {ap!r}; 0.1 budget "
                  f"{'met' if mk <= E2E_BUDGET else 'missed'}", flush=True)
            check(ak <= KERNEL_MEAN_RATIO * ap
                  and mk <= mp + KERNEL_MAX_EXCESS,
                  f"{label} {carrier}: kernels add little to the plain error")
        return y32

    y_fp32 = fidelity("resnet path", gen, qblocks, x,
                      {"bf16": y_k1, "int8": y_k2})
    x64 = x64.to(dev)
    fidelity(f"resnet path, batch {BENCH_BATCH}", gen, qblocks, x64,
             {c: int8_engine(gen, qblocks, x64.bfloat16(), c).float()
              for c in ("bf16", "int8")})
    for name, y in (("bf16", y_bf16), ("int8/K1", y_k1), ("int8/K2", y_k2)):
        check(tuple(y.shape) == (BATCH, SIZE, SIZE, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y_fp32).abs()
        print(f"[resnet path] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)
    cfg = BUDGET_CFG
    g_b = seeded_generator("p2p", cfg["blocks"], cfg["features"], seed=0,
                           device=dev)
    q_b = qi.quantize_resnet_trunk(g_b)
    x_b = images(cfg["batch"], cfg["size"])
    fidelity(f"budget config {cfg}", g_b, q_b, x_b,
             {c: int8_engine(g_b, q_b, x_b.bfloat16(), c).float()
              for c in ("bf16", "int8")})

    # 5. serve three requests
    serve(CycleGANInference("p2p", in_features=FEATURES,
                            n_residual_blocks=BLOCKS, seed=1),
          images, BATCH, SIZE, "resnet")

    # 6. times
    xb = images(BENCH_BATCH, SIZE).bfloat16()
    for name, fn in (
            ("bf16", lambda: gen(xb)),
            ("int8/K1", lambda: int8_engine(gen, qblocks, xb, "bf16")),
            ("int8/K2", lambda: int8_engine(gen, qblocks, xb, "int8"))):
        print_times(f"resnet generator {name}", BENCH_BATCH, fn)

    lib_ms = {n: int_mm_ms(v, q0["w1k"]) for n, v in ((BATCH, hq),
                                                       (BENCH_BATCH, h64q))}
    rows = []
    for name, replaces, kfn, pfn, cb, err in (
            ("resblock_int8_bf16io",
             "cistar_tpu/ops/quant_pallas.py:240",
             lambda: kr.resblock_int8_bf16io(h, q0, qi.EPS),
             lambda: qi.resblock_int8_bf16io_plain(h, q0), 2, k1_err),
            ("resblock_int8", "cistar_tpu/ops/quant_pallas.py:181",
             lambda: kr.resblock_int8(hq, hs, q0, qi.EPS),
             lambda: qi.resblock_int8_plain(hq, hs, q0), 1, k2_err)):
        bnd, by = k_bound_ms(n, hh, ww, c, cb)
        ms, plain_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/int8_resblock.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib_ms[BATCH]})
        print_block_times(name, tuple(h.shape), ms, cb, lib_ms[BATCH],
                          plain_ms)
    for name, fn, cb in (
            ("resblock_int8_bf16io",
             lambda: kr.resblock_int8_bf16io(h64, q0, qi.EPS), 2),
            ("resblock_int8",
             lambda: kr.resblock_int8(h64q, h64s, q0, qi.EPS), 1)):
        print_block_times(name, tuple(h64.shape), cuda_ms(fn, 10), cb,
                          lib_ms[BENCH_BATCH])
    for nb, xq in ((BATCH, hq), (BENCH_BATCH, h64q)):
        ms = cuda_ms(lambda: kr.conv3x3_reflect_s8(xq, q0["w1k"]), 10)
        ops = 2 * xq.numel() * 9 * c
        print(f"[times] conv3x3_reflect_s8 {tuple(xq.shape)}: {ms!r} ms, "
              f"{ops / ms * 1e-9!r} TOPS, bound {ops / PEAK_INT8_OPS * 1e3!r}"
              f" ms; torch._int_mm of its im2col matrix {lib_ms[nb] / 2!r} "
              f"ms", flush=True)
    return rows


def serve(eng, images, batch: int, size: int, label: str) -> None:
    """Three requests of (A, B) through ``infer_step`` and
    ``infer_step_int8``, each output checked."""
    import torch

    q_a2b, q_b2a = eng.quantize_generators()
    for r in range(3):
        a, b = images(batch, size), images(batch, size)
        t0 = time.perf_counter()
        outs = eng.infer_step(a, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs8 = eng.infer_step_int8(q_a2b, q_b2a, (a, b))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for o in (*outs, *outs8):
            check(tuple(o.shape) == (batch, size, size, 1)
                  and o.dtype == torch.float32
                  and bool(torch.isfinite(o).all()), f"{label} served output")
        gap = [round((p - q).abs().max().item(), 4)
               for p, q in zip(outs, outs8)]
        print(f"[serve {label}] request {r}: infer_step {1e3 * (t1 - t0):.3f} "
              f"ms, infer_step_int8 {1e3 * (t2 - t1):.3f} ms, max|int8-bf16| "
              f"of fake_B, fake_A, recover_B {gap}", flush=True)


def bilinear_path(dev, images, counters) -> list:
    """Phases 7-10; the kernels' JSON rows of K5 and K6."""
    import torch

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import quant_int8 as qi

    int8_engine = fi.bilinear_generator_int8_trunk_apply
    gen = seeded_generator("bilinear_content", BIL["blocks"], BIL["features"],
                           seed=0, device=dev)
    qt = fi.quantize_bilinear_trunk(gen)
    size, n = BIL["size"], BIL["batch"]

    def encode(x, stage_int8):
        return family_encode(gen, qt, x, stage_int8)

    def plain_engine(x):
        """The int8 engine with the plain versions of K5 / K6."""
        _, skips = encode(x, lambda h, q: qi.multi_atrous_stage_int8_plain(
            h[:, ::2, ::2], q, RATES2))
        h = skips[-1]
        for q in qt["res"]:
            h = qi.atrous_resblock_int8_plain(h, q)
        return fi.bilinear_decode(gen, h, skips)

    x = images(n, size)
    xb = x.bfloat16()

    # 7. kernels on the main path's own activations
    ins, outs = encode(xb, qi.multi_atrous_stage_int8)
    x6, h5 = ins[2].contiguous(), outs[2].contiguous()
    check(tuple(x6.shape) == (n, 128, 128, 64)
          and tuple(h5.shape) == (n, 64, 64, 128),
          f"stage-2 input {tuple(x6.shape)}, trunk {tuple(h5.shape)}")
    q5, q6 = qt["res"][0], qt["enc"][2]
    ins256, _ = encode(images(n, 256).bfloat16(), qi.multi_atrous_stage_int8)
    for label, xin, q, rates, want in (
            ("K5 trunk", h5, q5, RATES, (128, 128)),
            ("K6 stage 2", x6[:, ::2, ::2], q6, RATES2, (128, 64)),
            ("256² stage 1", ins256[1][:, ::2, ::2], qt["enc"][1], RATES2,
             (0, 0))):
        xq, _ = qi.quantize_act(xin.contiguous())
        dilated_conv_vs_plain(label, xq, q, rates, want)

    y5k, k5_err = k5_vs_plain(h5, q5)
    y6k, k6_err = k6_vs_plain(x6, q6)
    with fp32_exact():
        f5 = (y5k.float() - gen.res[0](h5.float())).abs().max().item()
        f6 = (y6k.float() - gen.down[2](x6.float())).abs().max().item()
    print(f"[kernels] K5 atrous_resblock_int8 {tuple(h5.shape)} vs the fp32 "
          f"block {f5!r}, {ATROUS_BUDGET} budget "
          f"{'met' if f5 <= ATROUS_BUDGET else 'missed'}", flush=True)
    print(f"[kernels] K6 multi_atrous_stage_int8 {tuple(x6.shape)} vs the "
          f"fp32 stage {f6!r}, {STAGE_BUDGET} budget "
          f"{'met' if f6 <= STAGE_BUDGET else 'missed'}", flush=True)

    # 8. the main path, counted
    for m in counters:
        m.reset_launches()
    y_bf16 = gen(xb).float()
    y_int8 = int8_engine(gen, qt, xb).float()
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[bilinear path] launches {launches}", flush=True)
    check(launches["atrous_resblock_int8"] == BIL["blocks"],
          f"{BIL['blocks']} K5 launches per generator call")
    check(launches["multi_atrous_stage_int8"] == 1,
          "1 K6 launch per generator call at 512²")
    check(launches["resblock_int8_bf16io"] == 0
          and launches["resblock_int8"] == 0,
          "no K1 / K2 launch on the bilinear path")

    with fp32_exact():
        y32 = gen(x)
    dk, dp = (y_int8 - y32).abs(), (plain_engine(xb).float() - y32).abs()
    (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item()) for d in (dk, dp))
    print(f"[bilinear path] int8 engine vs fp32: max {mk!r} mean {ak!r}; "
          f"with plain K5 / K6 max {mp!r} mean {ap!r}", flush=True)
    check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
          "bilinear path: kernels add little to the plain error")
    for name, y in (("bf16", y_bf16), ("int8", y_int8)):
        check(tuple(y.shape) == (n, size, size, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y32).abs()
        print(f"[bilinear path] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)

    # 9. serve three requests
    serve(CycleGANInference("bilinear_content", in_features=BIL["features"],
                            n_residual_blocks=BIL["blocks"], seed=1),
          images, n, size, "bilinear")

    # 10. times
    xbb = images(BIL_BENCH_BATCH, size).bfloat16()
    for name, fn in (("bf16", lambda: gen(xbb)),
                     ("int8", lambda: int8_engine(gen, qt, xbb))):
        print_times(f"bilinear generator {name}", BIL_BENCH_BATCH, fn)

    ins_b, outs_b = encode(xbb, qi.multi_atrous_stage_int8)
    x6b, h5b = ins_b[2].contiguous(), outs_b[2].contiguous()
    # K5 / K6 at the timed batch, checked as at the checked one: the
    # variant queries, every rate's int32 accumulators, K5 and K6 vs plain
    h5bq, _ = qi.quantize_act(h5b)
    x6bq, _ = qi.quantize_act(x6b[:, ::2, ::2].contiguous())
    dilated_conv_vs_plain("K5 trunk", h5bq, q5, RATES, (128, 128))
    dilated_conv_vs_plain("K6 stage 2", x6bq, q6, RATES2, (128, 64))
    k5_vs_plain(h5b, q5)
    k6_vs_plain(x6b, q6)
    h5q, _ = qi.quantize_act(h5)
    x6q, _ = qi.quantize_act(x6[:, ::2, ::2].contiguous())
    rows = []
    for name, replaces, kfn, kfn_b, pfn, err, xq, xqb, wk, rates, k5 in (
            ("atrous_resblock_int8", "cistar_tpu/ops/quant_pallas.py:973",
             lambda: ka.atrous_resblock_int8(h5, q5, RATES, qi.EPS),
             lambda: ka.atrous_resblock_int8(h5b, q5, RATES, qi.EPS),
             lambda: qi.atrous_resblock_int8_plain(h5, q5), k5_err,
             h5q, h5bq, q5["wck"], RATES, True),
            ("multi_atrous_stage_int8", "cistar_tpu/ops/quant_pallas.py:1160",
             lambda: ka.multi_atrous_stage_int8(x6, q6, RATES2, qi.EPS),
             lambda: ka.multi_atrous_stage_int8(x6b, q6, RATES2, qi.EPS),
             lambda: qi.multi_atrous_stage_int8_plain(x6[:, ::2, ::2], q6,
                                                      RATES2), k6_err,
             x6q, x6bq, q6["wbk"][0], RATES2, False)):
        ms, ms_b, plain_ms = cuda_ms(kfn, 20), cuda_ms(kfn_b, 10), cuda_ms(pfn, 5)
        # the GEMM yardstick: K5's five convs (four dilated, one reflect) or
        # K6's four, one torch._int_mm of their stacked im2col matrices
        lib_ms, lib_ms_b = (atrous_gemm_ms(v, wk, rates, k5) for v in (xq, xqb))
        cout = wk.shape[0]
        if k5:
            (bnd, by), (bnd_b, _) = (k5_bound_ms(*v.shape, 2) for v in (xq, xqb))
        else:
            (bnd, by), (bnd_b, _) = (k6_bound_ms(*v.shape, cout, 2) for v in (xq, xqb))
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/int8_atrous.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms})
        ops = (5 if k5 else 4) * 2 * xq.numel() * 9 * cout
        print_conv_times(name, tuple(xq.shape), ms, ops, bnd, lib_ms,
                         f", plain {plain_ms!r} ms")
        print_conv_times(name, tuple(xqb.shape), ms_b, ops * BIL_BENCH_BATCH / n,
                         bnd_b, lib_ms_b)
    breakdown(gen, qt, xbb, ins_b, outs_b)
    bnd, by = bound(2 * x6bq.numel() * 9 * 128,
                    x6bq.numel() * (1 + 4 * 128 // 64) + 9 * 64 * 128)
    ms = cuda_ms(lambda: ka.conv3x3_dilated_s8(x6bq, q6["wbk"][0], 1), 10)
    print(f"[times] conv3x3_dilated_s8 {tuple(x6bq.shape)} -> 128: {ms!r} ms, "
          f"bound {bnd!r} ms ({by})", flush=True)
    return rows


def breakdown(gen, qt, x, ins, outs) -> None:
    """Where the time of each bilinear engine goes: CUDA-event ms of each
    segment of one generator call on the main path's own activations
    (``ins`` / ``outs``: the encoder stages' inputs and outputs)."""
    import torch

    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.ops import quant_int8 as qi

    trunk_in = outs[2].contiguous()
    trunk_out = qi.atrous_resblock_chain_int8(trunk_in, qt["res"])

    def bf16_trunk():
        h = trunk_in
        for m in gen.res:
            h = m(h)
        return h

    def bf16_decode():
        h = trunk_out
        for m, skip in zip(gen.up, reversed(outs)):
            h = m(torch.cat([h, skip], dim=-1))
        return tnn.tanh(gen.out_conv(h))

    stem = (lambda: tnn.relu(tnn.instance_norm(gen.init_conv(x))),) * 2
    stages = [(lambda i=i: gen.down[i](ins[i]),) * 2 for i in range(2)]
    stage2 = (lambda: gen.down[2](ins[2]),
              lambda: qi.multi_atrous_stage_int8(ins[2], qt["enc"][2]))
    trunk = (bf16_trunk,
             lambda: qi.atrous_resblock_chain_int8(trunk_in, qt["res"]))
    decode = (bf16_decode, lambda: fi.bilinear_decode(gen, trunk_out, outs))
    names = ("stem", "stage 0", "stage 1", "stage 2", "trunk",
             "decoder + head")
    segs = (stem, *stages, stage2, trunk, decode)
    for e, engine in enumerate(("bf16", "int8")):
        ms = [cuda_ms(seg[e], 5) for seg in segs]
        print(f"[breakdown] bilinear {engine} batch {x.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in zip(names, ms))
              + f"; sum {sum(ms)!r}", flush=True)


def k7b_vs_plain(rq, rs, hx, qblk, ct: int, bn: bool = False) -> tuple:
    """K7b on ``rq`` / ``rs`` against its plain version on the same inputs:
    (max-abs, the most by which an element exceeds one bf16 ulp of the
    plain value)."""
    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.ops import quant_int8 as qi

    yk = kt.resblock_int8_tiled_b(rq, rs, hx, qblk, ct, qi.EPS, bn=bn).float()
    yp = qi.resblock_tiled_b_plain(rq, rs, hx, qblk, ct, bn=bn).float()
    d = (yk - yp).abs()
    return d.max().item(), (d - K7_REL * yp.abs()).max().item()


def k7b_conv_vs_plain(label: str, rq, qblk, ct: int) -> None:
    """K7b's conv at ``rq``'s shape: its variant query, and the int32
    accumulators of every group bit for bit against the plain version."""
    import torch

    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.ops import quant_int8 as qi

    t = rq.shape[-1] // ct
    check_grouped_variant(f"{label} conv at {tuple(rq.shape)} in {t} groups",
                          kt.conv_variant_card(*rq.shape, t),
                          kt.conv_variant(*rq.shape, t))
    check(torch.equal(kt.conv3x3_reflect_grouped_s8(rq, qblk["w2k"], t),
                      qi.conv3x3_reflect_grouped_s8_plain(rq, qblk["w2q"], t)),
          f"{label} conv {tuple(rq.shape)}: int32 accumulators of all {t} "
          "groups bit-exact")
    print(f"[kernels] {label} conv {tuple(rq.shape)}: int32 accumulators of "
          f"the {t} groups bit-exact vs plain", flush=True)


def k8_vs_plain(xq, xs, qblk) -> tuple:
    """K8 on the ``UNet`` trunk's int8 ``xq`` / per-image ``xs``, both
    stages, against the plain versions: each of the four convs' variant
    query and int32 accumulators of every group bit for bit; stage 1's int8
    outputs and tile scales bit for bit; stage 2 (bf16) within one bf16 ulp
    + ``K8_ABS``. Returns stage 2's input and group scales (the plain stage
    1's) and its max-abs error."""
    import torch

    from cistar_tpu_torch.kernels import int8_msrb as km
    from cistar_tpu_torch.ops import quant_int8 as qi

    s1k = qi.msrb_stage(xq, xs, qblk, "a", K8_TILE, True, None)
    s1p = qi.msrb_stage_plain(xq, xs, qblk["w3a"], qblk["w5a"], qblk["sb1"],
                              K8_TILE, True, None)
    check(all(torch.equal(a, b) for a, b in zip(s1k, s1p)),
          f"K8 stage 1 {tuple(xq.shape)} int8 outputs and tile scales "
          "bit-exact")
    cat = torch.cat(s1p[:2], -1).contiguous()
    sc = torch.cat(s1p[2:], 1).contiguous()
    for st, xin, g in (("a", xq, 1), ("b", cat, sc.shape[1])):
        for kk in (3, 5):
            wk = qblk[f"w{kk}{st}k"]
            shape = (*xin.shape, wk.shape[0], kk, g)
            check_grouped_variant(
                f"K8 stage {st} {kk}x{kk} conv at {tuple(xin.shape)} in {g} "
                "groups", km.conv_variant_card(*shape),
                km.conv_variant(*shape))
            check(torch.equal(
                km.conv_zero_grouped_s8(xin, wk, kk, g),
                qi.conv_zero_grouped_s8_plain(xin, qblk[f"w{kk}{st}"], kk, g)),
                f"K8 stage {st} {kk}x{kk} {tuple(xin.shape)} int32 "
                "accumulators bit-exact")
    print(f"[kernels] conv_zero_grouped_s8 {tuple(xq.shape)} and "
          f"{tuple(cat.shape)} in {sc.shape[1]} groups, 3x3 and 5x5: int32 "
          f"accumulators bit-exact vs plain; K8 stage 1 int8 outputs and "
          f"tile scales bit-exact", flush=True)
    s2k = qi.msrb_stage(cat, sc, qblk, "b", K8_TILE, False, torch.bfloat16)
    s2p = qi.msrb_stage_plain(cat, sc, qblk["w3b"], qblk["w5b"], qblk["sb2"],
                              K8_TILE, False, torch.bfloat16)
    d = torch.stack([(a.float() - b.float()).abs()
                     for a, b in zip(s2k[:2], s2p[:2])])
    ref = torch.stack([b.float().abs() for b in s2p[:2]])
    err = d.max().item()
    over = (d - K8_REL * ref).max().item()
    print(f"[kernels] K8 stage 2 {tuple(cat.shape)} -> bf16: "
          f"max|kernel-plain| {err!r}, max over one ulp {over!r} (tol "
          f"{K8_ABS})", flush=True)
    check(over <= K8_ABS, f"K8 stage 2 {tuple(cat.shape)} within one bf16 ulp "
          "+ 1e-4 of plain")
    return cat, sc, err


def p2phd_path(family: str, images, counters) -> list:
    """Phases 11-14 for ``family`` "global" or "UNet"; the kernels' JSON
    rows of K7a and K7b, or of K8."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    from cistar_tpu_torch.kernels import int8_msrb as km
    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import quant_int8 as qi

    cfg = P2PHD[family]
    n, size = cfg["batch"], P2P_SIZE
    eng = Pix2PixHDInference(family, ngf=cfg["ngf"],
                             n_downsample_global=cfg["n_downsample_global"],
                             n_blocks_global=cfg["n_blocks_global"], seed=0)
    gen, qb = eng.G, eng.quantize_generator()
    label = f"{family} path"
    if family == "global":
        encode = fi.global_encode
        def int8_engine(x):
            return fi.global_generator_int8_trunk_apply(gen, qb, x)

        def plain_engine(x):
            h = fi.global_encode(gen, x)
            for q in qb:
                h = qi.resblock_int8_tiled_plain(h, q, K7_TILE)
            return fi.global_decode(gen, h)
    else:
        def encode(g, x):
            return fi.unet_encode(g, x)[-1]

        def int8_engine(x):
            return fi.unet_msrb_int8_apply(gen, qb, x)

        def plain_engine(x):
            skips = fi.unet_encode(gen, x)
            h = skips[-1]
            for q in qb:
                h = qi.msrb_block_int8_plain(h, q, K8_TILE)
            return fi.unet_decode(gen, h, skips)

    x = images(n, size)
    xb = x.bfloat16()

    # 11. kernels on the path's own trunk activation
    h = encode(gen, xb).contiguous()
    q0 = qb[0]
    if family == "global":
        check(tuple(h.shape) == (n, 32, 32, 1024), f"trunk {tuple(h.shape)}")
        check(not qi.whole_image_resblock_fits(32, 32, 1024)
              and qi.pick_cout_tile(32 * 32, 1024) == K7_TILE,
              "the JAX rule sends the 1024-channel trunk to K7 at ct 256")
        hq, _ = qi.quantize_act(h)
        check(torch.equal(kt.conv3x3_reflect_grouped_s8(hq, q0["w1k"], 1),
                          qi.conv3x3_reflect_grouped_s8_plain(hq, q0["w1q"], 1)),
              "K7 conv 1 int32 accumulators bit-exact")
        print(f"[kernels] conv3x3_reflect_grouped_s8 {tuple(hq.shape)}: int32 "
              f"accumulators of conv 1 bit-exact vs plain", flush=True)
        k7a_conv_vs_plain("K7a", h, q0)
        rqp, rsp, err_a = k7a_vs_plain("K7a", h, q0, K7_TILE)
        k7b_conv_vs_plain("K7b", rqp, q0, K7_TILE)
        # K7b alone, on the plain K7a's output
        err_b, over_b = k7b_vs_plain(rqp, rsp, h, q0, K7_TILE)
        yk = qi.resblock_int8_tiled(h, q0, K7_TILE)
        yp = qi.resblock_int8_tiled_plain(h, q0, K7_TILE)
        d = (yk.float() - yp.float()).abs()
        err = d.max().item()
        over = (d - K7_REL * yp.float().abs()).max().item()
        with fp32_exact():
            fb = (yk.float() - gen.trunk.res[0](h.float())).abs().max().item()
        print(f"[kernels] K7b {tuple(h.shape)} ct {K7_TILE} on the plain rq: "
              f"max|kernel-plain| {err_b!r}, over one ulp {over_b!r}; K7 "
              f"block bf16 max|kernel-plain| {err!r}, max over one ulp "
              f"{over!r} (tol {K7_ABS}); vs the fp32 block "
              f"{fb!r}, {TILED_BUDGET} budget "
              f"{'met' if fb <= TILED_BUDGET else 'missed'}", flush=True)
        check(over <= K7_ABS, "K7 within one bf16 ulp + 0.01 of plain")
        check(over_b <= K7_ABS, "K7b within one bf16 ulp + 0.01 of plain")
        rows_in = (h, rqp, rsp, {"a": err_a, "b": err_b})
    else:
        check(tuple(h.shape) == (n, 64, 64, 512), f"trunk {tuple(h.shape)}")
        xq, xs = qi.quantize_act(h)
        cat, sc, err = k8_vs_plain(xq, xs, q0)
        with fp32_exact():
            fb = (qi.msrb_block_int8(h, q0).float()
                  - gen.msrb[0](h.float())).abs().max().item()
        print(f"[kernels] MSRB block vs the fp32 block {fb!r}, {MSRB_BUDGET} "
              f"budget {'met' if fb <= MSRB_BUDGET else 'missed'}", flush=True)
        rows_in = (xq, xs, cat, sc, err)

    # 12. the path, counted
    for m in counters:
        m.reset_launches()
    y_bf16 = gen(xb).float()
    y_int8 = int8_engine(xb).float()
    torch.cuda.synchronize()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[{label}] launches {launches}", flush=True)
    want = ({"resblock_int8_tiled_a": cfg["n_blocks_global"],
             "resblock_int8_tiled_b": cfg["n_blocks_global"]}
            if family == "global" else
            {"msrb_branch_int8": 4 * cfg["n_blocks_global"]})
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"one {family} call launches {want} and no other kernel")
    with fp32_exact():
        y32 = gen(x)
    dk, dp = (y_int8 - y32).abs(), (plain_engine(xb).float() - y32).abs()
    (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item()) for d in (dk, dp))
    print(f"[{label}] int8 engine vs fp32: max {mk!r} mean {ak!r}; with plain "
          f"kernels max {mp!r} mean {ap!r}", flush=True)
    check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
          f"{label}: kernels add little to the plain error")
    for name, y in (("bf16", y_bf16), ("int8", y_int8)):
        check(tuple(y.shape) == (n, size, size, 1)
              and bool(torch.isfinite(y).all()), f"{name} output shape/finite")
        d = (y - y32).abs()
        print(f"[{label}] {name} vs fp32: max {d.max().item()!r} mean "
              f"{d.mean().item()!r}", flush=True)

    # 13. serve three requests
    for r in range(3):
        lab = images(n, size)
        t0 = time.perf_counter()
        out = eng.infer_step(lab)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out8 = eng.infer_step_int8(qb, lab)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for o in (out, out8):
            check(tuple(o.shape) == (n, size, size, 1)
                  and o.dtype == torch.float32
                  and bool(torch.isfinite(o).all()), f"{family} served output")
        print(f"[serve {family}] request {r}: infer_step "
              f"{1e3 * (t1 - t0):.3f} ms, infer_step_int8 {1e3 * (t2 - t1):.3f}"
              f" ms, max|int8-bf16| {(out - out8).abs().max().item():.4f}",
              flush=True)

    # 14. times
    nb = cfg["bench_batch"]
    xbb = images(nb, size).bfloat16()
    for name, fn in (("bf16", lambda: gen(xbb)),
                     ("int8", lambda: int8_engine(xbb))):
        print_times(f"{family} generator {name}", nb, fn)
    p2phd_breakdown(family, gen, qb, xbb)

    if family == "global":
        hh, rqp, rsp, errs = rows_in
        hb = fi.global_encode(gen, xbb).contiguous()
        # K7a and K7b at the timed batch, checked as at the checked one
        k7a_conv_vs_plain("K7a", hb, q0)
        k7a_vs_plain("K7a", hb, q0, K7_TILE)
        rqb, rsb = kt.resblock_int8_tiled_a(hb, q0, K7_TILE, qi.EPS)
        k7b_conv_vs_plain("K7b", rqb, q0, K7_TILE)
        err_b, over_b = k7b_vs_plain(rqb, rsb, hb, q0, K7_TILE)
        print(f"[kernels] K7b {tuple(hb.shape)} ct {K7_TILE}: "
              f"max|kernel-plain| {err_b!r}, over one ulp {over_b!r} (tol "
              f"{K7_ABS})", flush=True)
        check(over_b <= K7_ABS, f"K7b {tuple(hb.shape)} within one bf16 ulp + "
              "0.01 of plain")
        lib = {"a": tuple(gemm_ms(im2col_reflect(qi.quantize_act(v)[0]),
                                  q0["w1k"]) for v in (hh, hb)),
               "b": (gemm_ms(im2col_reflect(rqp), q0["w2k"]),
                     gemm_ms(im2col_reflect(rqb), q0["w2k"]))}
        rows = []
        for name, line, half, kfn, kfn_b, pfn in (
                ("resblock_int8_tiled_a", ":519", "a",
                 lambda: kt.resblock_int8_tiled_a(hh, q0, K7_TILE, qi.EPS),
                 lambda: kt.resblock_int8_tiled_a(hb, q0, K7_TILE, qi.EPS),
                 lambda: qi.resblock_tiled_a_plain(hh, q0, K7_TILE)),
                ("resblock_int8_tiled_b", ":532", "b",
                 lambda: kt.resblock_int8_tiled_b(rqp, rsp, hh, q0, K7_TILE,
                                                  qi.EPS),
                 lambda: kt.resblock_int8_tiled_b(rqb, rsb, hb, q0, K7_TILE,
                                                  qi.EPS),
                 lambda: qi.resblock_tiled_b_plain(rqp, rsp, hh, q0,
                                                   K7_TILE))):
            bnd, by = k7_bound_ms(*hh.shape, half)
            bnd_b, _ = k7_bound_ms(*hb.shape, half)
            ms, ms_b = cuda_ms(kfn, 20), cuda_ms(kfn_b, 10)
            plain_ms = cuda_ms(pfn, 5)
            lib_ms, lib_ms_b = lib[half]
            rows.append({"name": name, "route": "cuda",
                         "source": "cistar_tpu_torch/csrc/int8_tiled.cu",
                         "replaces": "cistar_tpu/ops/quant_pallas.py" + line,
                         "launches": launches[name], "max_abs_err": errs[half],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                         "bound_by": by, "library_ms": lib_ms})
            ops = 2 * hh.numel() * 9 * hh.shape[-1]
            print_conv_times(name, tuple(hh.shape), ms, ops, bnd, lib_ms,
                             f", plain {plain_ms!r} ms")
            print_conv_times(name, tuple(hb.shape), ms_b, ops * nb / n,
                             bnd_b, lib_ms_b)
        return rows

    xq, xs, cat, sc, err = rows_in
    hb = fi.unet_encode(gen, xbb)[-1].contiguous()
    xqb, xsb = qi.quantize_act(hb)
    # K8 at the timed batch, checked as at the checked one
    catb, scb, _ = k8_vs_plain(xqb, xsb, q0)
    tot = dict.fromkeys(("ms", "plain", "bound", "lib", "ms_b", "bound_b",
                         "lib_b"), 0.0)
    by = None
    for st, (xin, xsc, xinb, xscb) in (("a", (xq, xs, xqb, xsb)),
                                       ("b", (cat, sc, catb, scb))):
        qo = st == "a"
        sb = q0["sb1" if qo else "sb2"]
        for row, kk in ((0, 3), (1, 5)):
            wk, wq = q0[f"w{kk}{st}k"], q0[f"w{kk}{st}"]
            odt = None if qo else torch.bfloat16
            ms = cuda_ms(lambda: km.msrb_branch_int8(
                xin, xsc, wk, sb, row, kk, K8_TILE, qo, odt), 20)
            ms_b = cuda_ms(lambda: km.msrb_branch_int8(
                xinb, xscb, wk, sb, row, kk, K8_TILE, qo, odt), 10)
            plain_ms = cuda_ms(lambda: qi.msrb_branch_plain(
                xin, xsc, wq, sb, row, kk, K8_TILE, qo, odt), 5)
            bnd, by = k8_bound_ms(*xin.shape, wk.shape[0], kk, qo)
            bnd_b, _ = k8_bound_ms(*xinb.shape, wk.shape[0], kk, qo)
            lib_ms = gemm_ms(im2col_zero(xin, kk), wk)
            lib_ms_b = gemm_ms(im2col_zero(xinb, kk), wk)
            for k, v in (("ms", ms), ("plain", plain_ms), ("bound", bnd),
                         ("lib", lib_ms), ("ms_b", ms_b), ("bound_b", bnd_b),
                         ("lib_b", lib_ms_b)):
                tot[k] += v
            ops = 2 * xin.numel() * kk * kk * wk.shape[0]
            label = f"msrb_branch_int8 stage {st} {kk}x{kk}"
            print_conv_times(label, tuple(xin.shape), ms, ops, bnd, lib_ms,
                             f", plain {plain_ms!r} ms")
            print_conv_times(label, tuple(xinb.shape), ms_b, ops * nb / n,
                             bnd_b, lib_ms_b)
    print(f"[times] msrb_branch_int8, the four launches of one block: "
          f"{tot['ms']!r} ms at batch {n} (bound {tot['bound']!r}, GEMM "
          f"yardstick {tot['lib']!r}), {tot['ms_b']!r} ms at batch {nb} "
          f"(bound {tot['bound_b']!r}, GEMM yardstick {tot['lib_b']!r})",
          flush=True)
    # one row, per launch: the mean over one block's four launches
    return [{"name": "msrb_branch_int8", "route": "cuda",
             "source": "cistar_tpu_torch/csrc/int8_msrb.cu",
             "replaces": "cistar_tpu/ops/quant_pallas.py:780",
             "launches": launches["msrb_branch_int8"], "max_abs_err": err,
             "ms": tot["ms"] / 4, "plain_ms": tot["plain"] / 4,
             "bound_ms": tot["bound"] / 4, "bound_by": by,
             "library_ms": tot["lib"] / 4}]


def p2phd_breakdown(family: str, gen, qb, x) -> None:
    """Where the time of each pix2pixHD engine goes: CUDA-event ms of each
    segment of one generator call, on the engine's own activations."""
    import torch

    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.ops import quant_int8 as qi

    def in_relu(v):
        return tnn.relu(tnn.instance_norm(v))

    def thin(conv, v):
        return tnn.conv2d_reflect_thin(v, conv.weight, conv.bias)

    if family == "global":
        tr = gen.trunk
        stem_out = tr.stem(x)
        downs = [stem_out]
        for m in tr.down:
            downs.append(m(downs[-1]))
        t_in = downs[-1]
        t_out = fi.global_trunk_int8(t_in, qb)
        ups = [t_out]
        for m in tr.up:
            ups.append(m(ups[-1]))

        def run_downs():
            for m, v in zip(tr.down, downs):
                m(v)

        def run_ups():
            for m, v in zip(tr.up, ups):
                m(v)

        def bf16_trunk():
            v = t_in
            for m in tr.res:
                v = m(v)
            return v
        segs = {"stem": (lambda: tr.stem(x),
                         lambda: in_relu(thin(tr.stem.conv, x))),
                "downs": (run_downs,) * 2,
                "trunk": (bf16_trunk, lambda: fi.global_trunk_int8(t_in, qb)),
                "ups": (run_ups,) * 2,
                "head": (lambda: gen.head(ups[-1]),
                         lambda: tnn.tanh(thin(gen.head.conv, ups[-1])))}
    else:
        stem_out = gen.init_block(x)
        skips = fi.unet_encode(gen, x)
        ins = [stem_out, *skips[:-1]]
        t_in = skips[-1]
        t_out = t_in
        for q in qb:
            t_out = qi.msrb_block_int8(t_out, q)
        up_ins = [t_out]
        for convt, skip in zip(gen.up_convt, reversed(skips)):
            up_ins.append(in_relu(convt(torch.cat([up_ins[-1], skip], -1))))

        def run_downs():
            for conv, v in zip(gen.down_conv, ins):
                in_relu(conv(v))

        def run_ups():
            for convt, v, skip in zip(gen.up_convt, up_ins, reversed(skips)):
                in_relu(convt(torch.cat([v, skip], -1)))

        def bf16_trunk():
            v = t_in
            for m in gen.msrb:
                v = m(v)
            return v

        def int8_trunk():
            v = t_in
            for q in qb:
                v = qi.msrb_block_int8(v, q)
            return v
        head_in = up_ins[-1]
        segs = {"stem": (lambda: gen.init_block(x),
                         lambda: in_relu(thin(gen.init_block.conv, x))),
                "downs": (run_downs,) * 2,
                "trunk": (bf16_trunk, int8_trunk),
                "ups": (run_ups,) * 2,
                "head": (lambda: gen.output_layer(head_in),
                         lambda: tnn.tanh(thin(gen.output_layer.conv,
                                               head_in)))}
    for e, engine in enumerate(("bf16", "int8")):
        ms = {k: cuda_ms(v[e], 5) for k, v in segs.items()}
        print(f"[breakdown] {family} {engine} batch {x.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in ms.items())
              + f"; sum {sum(ms.values())!r}", flush=True)


def fused_path(dev, images, counters) -> list:
    """Phases 15-18; the kernels' JSON rows of K3, K4 and K9."""
    import copy
    import functools

    import torch
    import torch.nn.functional as F

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    from cistar_tpu_torch.kernels import fused_conv as kf
    from cistar_tpu_torch.kernels import head_cout1 as kh
    from cistar_tpu_torch.kernels import in_act as kn
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import fused
    from cistar_tpu_torch.ops import quant_int8 as qi
    from cistar_tpu_torch.ops.head_conv import head_conv_tanh_pallas

    gen = seeded_generator("p2p", BLOCKS, FEATURES, seed=0, device=dev)
    gen16 = copy.deepcopy(gen).bfloat16()
    qblocks = qi.quantize_resnet_trunk(gen)
    x = images(BATCH, SIZE)
    xb = x.bfloat16()
    xf64 = images(BENCH_BATCH, SIZE)
    xbb = xf64.bfloat16()

    def counted(fn):
        """``fn()`` with every launch counter set to 0 just before; its
        result and the counts just after."""
        for m in counters:
            m.reset_launches()
        y = fn()
        torch.cuda.synchronize()
        return y, {k: v for m in counters for k, v in m.launches.items()}

    def cudnn_ms(x, w):
        """cuDNN's bf16 conv of NHWC ``x`` (a channels_last NCHW view),
        zero pad 1: the yardstick of K3's GEMM, never called by the port."""
        wc = w.contiguous(memory_format=torch.channels_last)
        xc = x.permute(0, 3, 1, 2)
        return cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10)

    def within(label, yk, yp, rel, tol):
        d = (yk.float() - yp.float()).abs()
        err = d.max().item()
        over = (d - rel * yp.float().abs()).max().item()
        print(f"[kernels] {label} {tuple(yk.shape)} {yk.dtype}: "
              f"max|kernel-plain| {err!r}, max over one ulp {over!r} (tol "
              f"{tol})", flush=True)
        check(over <= tol, f"{label} within tolerance of plain")
        return err

    # 15. kernels on the main path's own activations
    def trunk_in(v):
        for m in (gen16.init_conv, *gen16.down):
            v = fi._in_relu(m(v))
        return v.contiguous()

    h, hb = trunk_in(xb), trunk_in(xbb)
    check(tuple(h.shape) == (BATCH, 32, 32, 512), f"trunk {tuple(h.shape)}")
    c1, c2 = gen16.res[0].conv1, gen16.res[0].conv2
    check(fused.conv3x3_in_act_fits(h, c1.weight)
          and not fused.conv3x3_in_act_fits(h, gen.res[0].conv1.weight),
          "the JAX rule sends the trunk to K3 with bf16 weights only")
    wk1 = c1.weight.detach().permute(0, 2, 3, 1).reshape(512, -1).contiguous()
    b1 = c1.bias.detach().float().contiguous()

    def k3_checks(h) -> float:
        """K3 (both convs of block 0) and its conv alone against their
        plain versions on ``h``; K3's max-abs error."""
        r_p = fused.fused_conv3x3_in_act_plain(h, c1.weight, c1.bias, "relu")
        err = max(
            within("K3 conv 1, relu", fused.fused_conv3x3_in_act(
                h, c1.weight, c1.bias, "relu"), r_p, K3_REL, K3_ABS),
            within("K3 conv 2, none + residual", fused.fused_conv3x3_in_act(
                r_p, c2.weight, c2.bias, "none", h),
                fused.fused_conv3x3_in_act_plain(
                    r_p, c2.weight, c2.bias, "none", h), K3_REL, K3_ABS))
        # the conv alone against an fp32 conv of the same bf16 values
        v_card = kf.conv_variant_card(*h.shape, 512, True, True)
        check(v_card == kf.conv_variant(*h.shape, 512, True, True) != 0,
              f"K3 at {tuple(h.shape)} takes the wgmma conv")
        f_k = kf.conv3x3_bf16_f32(h, wk1, b1, True)
        with fp32_exact():
            f_p = fused.conv3x3_bias_plain(h, c1.weight, c1.bias)
            f_abs = fused.conv3x3_bias_plain(h.abs(), c1.weight.abs())
        d = (f_k - f_p).abs()
        over = (d - K3_CONV_REL * f_abs).max().item()
        print(f"[kernels] K3 conv alone (conv3x3_bf16_f32, wgmma BN "
              f"{v_card}) {tuple(f_k.shape)}: max|kernel-fp32| "
              f"{d.max().item()!r}, max over 2^-13 of sum|x*w| {over!r} "
              f"(tol 0)", flush=True)
        check(over <= 0, f"K3's conv at {tuple(h.shape)} within its "
              f"sum-order tolerance of fp32")
        return err

    # at the checked batch (BN 128) and at the timed one (BN 256)
    k3_err = k3_checks(h)
    k3_checks(hb)
    g32 = torch.Generator(device=dev).manual_seed(0)
    x64 = torch.randn(BATCH, 32, 32, 64, device=dev, generator=g32)
    w64 = 0.05 * torch.randn(64, 64, 3, 3, device=dev, generator=g32)
    b64 = 0.1 * torch.randn(64, device=dev, generator=g32)
    check(fused.conv3x3_in_act_fits(x64, w64), "fp32 K3 shape fits the rule")
    with fp32_exact():
        p64 = fused.fused_conv3x3_in_act_plain(x64, w64, b64, "relu",
                                               x64, "zero")
    within("K3 fp32, zero pad, relu + residual", fused.fused_conv3x3_in_act(
        x64, w64, b64, "relu", x64, "zero"), p64, 0.0, K3_FP32_ABS)

    hs = fi._in_relu(gen.init_conv(xb))
    d1 = gen.down[1](fi._in_relu(gen.down[0](hs)))
    d2 = gen.down[2](fi._in_relu(d1))
    t = qi.resblock_chain_int8_bf16io(fi._in_relu(d2), qblocks)
    u0 = gen.up[0](t)
    u2 = gen.up[2](fi._in_relu(gen.up[1](fi._in_relu(u0)))).contiguous()
    k4_err = 0.0
    for label, v, act, res in (("down_1", d1, "relu", None),
                               ("down_2", d2, "relu", None),
                               ("up_0", u0, "relu", None),
                               ("down_2", d2, "leaky", None),
                               ("down_2", d2, "tanh", None),
                               ("down_2 + residual", d2, "relu", t),
                               ("down_2 + residual", d2, "tanh", t)):
        check(fused.in_act_fits(v, res), f"K4 rule: {label} fits")
        k4_err = max(k4_err, within(
            f"K4 {label}, {act}",
            fused.fused_instance_norm_act(v, act, residual=res),
            fused.fused_instance_norm_act_plain(v, act, residual=res),
            K4_REL, K4_ABS))
    wh, bh = gen.out_conv.weight, gen.out_conv.bias
    u2n = fi._in_relu(u2)
    k9_err = max(
        within("K9 (loop / masked), tanh", fused.conv2d_reflect_cout1_loop(
            u2n, wh, bh, "tanh"), fused.conv2d_reflect_cout1_plain(
            u2n, wh, bh, "tanh"), K9_REL, K9_ABS),
        within("K9 (tap_matmul) pre_in, tanh", head_conv_tanh_pallas(
            u2, wh, bh, pre_in=True), fused.conv2d_reflect_cout1_plain(
            u2, wh, bh, "tanh", pre_in=True), K9_REL, K9_PRE_ABS))
    # which kernel the library takes at these shapes, against the mirror:
    # K4's cluster (8 CTAs at 64² x 256, 2 at 32² x 512)
    for label, v in (("down_1", d1), ("down_2", d2), ("up_0", u0)):
        _, hv, wv, cv = v.shape
        vc = kn.variant_card(hv, wv, cv, v.element_size())
        print(f"[kernels] K4 {label} {tuple(v.shape)}: cistar_in_act_variant "
              f"{vc}, mirror {kn.variant(hv, wv, cv, v.element_size())}",
              flush=True)
        check(vc == kn.variant(hv, wv, cv, v.element_size()) > 0,
              f"K4 {label}: the cluster kernel, as the mirror says")
    check(kh.smem_bytes_card() == kh.SMEM_BYTES,
          "K9's shared memory as the mirror says")
    # the same checks at the timed batch, on its own activations
    d1b = gen.down[1](fi._in_relu(gen.down[0](fi._in_relu(
        gen.init_conv(xbb)))))
    d2b_ = gen.down[2](fi._in_relu(d1b))
    u0b = gen.up[0](qi.resblock_chain_int8_bf16io(fi._in_relu(d2b_),
                                                  qblocks))
    u2b_ = gen.up[2](fi._in_relu(gen.up[1](fi._in_relu(u0b)))).contiguous()
    for label, v in (("down_1", d1b), ("down_2", d2b_), ("up_0", u0b)):
        check(fused.in_act_fits(v), f"K4 rule: {label} batch "
              f"{BENCH_BATCH} fits")
        k4_err = max(k4_err, within(
            f"K4 {label} batch {BENCH_BATCH}, relu",
            fused.fused_instance_norm_act(v, "relu"),
            fused.fused_instance_norm_act_plain(v, "relu"), K4_REL, K4_ABS))
    u2nb = fi._in_relu(u2b_)
    k9_err = max(
        k9_err,
        within(f"K9 batch {BENCH_BATCH}, tanh",
               fused.conv2d_reflect_cout1_loop(u2nb, wh, bh, "tanh"),
               fused.conv2d_reflect_cout1_plain(u2nb, wh, bh, "tanh"),
               K9_REL, K9_ABS),
        within(f"K9 batch {BENCH_BATCH} pre_in, tanh",
               head_conv_tanh_pallas(u2b_, wh, bh, pre_in=True),
               fused.conv2d_reflect_cout1_plain(u2b_, wh, bh, "tanh",
                                                pre_in=True),
               K9_REL, K9_PRE_ABS))
    del d1b, d2b_, u0b, u2b_, u2nb

    # 16. the bf16 fast forward, counted
    y_fast, n16 = counted(lambda: fi.resnet_generator_fast_apply(gen16, xb))
    print(f"[fast forward] launches {n16}", flush=True)
    check(all(v == (2 * BLOCKS if k == "conv3x3_in_act" else 0)
              for k, v in n16.items()),
          f"{2 * BLOCKS} K3 launches per call and no other kernel")
    y_fw32, n32 = counted(lambda: fi.resnet_generator_fast_apply(gen, xb))
    y_bf16 = gen(xb)
    check(all(v == 0 for v in n32.values())
          and torch.equal(y_fw32, y_bf16),
          "fp32 weights: no K3, equal to the bf16 module forward")
    with fp32_exact():
        y32 = gen(x)
    check(tuple(y_fast.shape) == (BATCH, SIZE, SIZE, 1)
          and bool(torch.isfinite(y_fast).all()), "fast forward output")
    (mf, af), (mb, ab) = ((d.max().item(), d.mean().item()) for d in (
        (y_fast.float() - y32).abs(), (y_bf16.float() - y32).abs()))
    print(f"[fast forward] vs fp32: max {mf!r} mean {af!r}; the bf16 module "
          f"forward max {mb!r} mean {ab!r}", flush=True)
    check(af <= KERNEL_MEAN_RATIO * ab and mf <= mb + KERNEL_MAX_EXCESS,
          "the fast forward about as far from fp32 as the bf16 forward")
    # the same rule at the timed batch
    y_fast64 = fi.resnet_generator_fast_apply(gen16, xbb)
    with fp32_exact():
        y32_64 = gen(xf64)
    check(tuple(y_fast64.shape) == (BENCH_BATCH, SIZE, SIZE, 1)
          and bool(torch.isfinite(y_fast64).all()), "fast forward output, "
          f"batch {BENCH_BATCH}")
    (mf, af), (mb, ab) = ((d.max().item(), d.mean().item()) for d in (
        (y_fast64.float() - y32_64).abs(), (gen(xbb).float() - y32_64).abs()))
    print(f"[fast forward] batch {BENCH_BATCH} vs fp32: max {mf!r} mean "
          f"{af!r}; the bf16 module forward max {mb!r} mean {ab!r}",
          flush=True)
    check(af <= KERNEL_MEAN_RATIO * ab and mf <= mb + KERNEL_MAX_EXCESS,
          f"batch {BENCH_BATCH}: the fast forward about as far from fp32 as "
          f"the bf16 forward")
    del y_fast64, y32_64
    for name, fn in (("bf16 module", lambda: gen(xbb)),
                     ("bf16 fast (K3)",
                      lambda: fi.resnet_generator_fast_apply(gen16, xbb))):
        print_times(f"resnet generator {name}", BENCH_BATCH, fn)
    k3_lib = {}
    for v in (h, hb):
        ops = 2 * v.numel() * 9 * 512
        ms_k = cuda_ms(lambda: fused.fused_conv3x3_in_act(
            v, c1.weight, c1.bias, "relu"), 10)
        ms_c = cuda_ms(lambda: kf.conv3x3_bf16_f32(v, wk1, b1, True), 10)
        k3_lib[v.shape[0]] = cudnn_ms(v, c1.weight)
        bnd_k, by = k3_bound_ms(v, c1.weight, None)
        print(f"[times] conv3x3_in_act {tuple(v.shape)}: {ms_k!r} ms, bound "
              f"{bnd_k!r} ms ({by}), {ops / ms_k * 1e-9!r} TFLOP/s; its conv "
              f"alone (conv3x3_bf16_f32) {ms_c!r} ms, {ops / ms_c * 1e-9!r} "
              f"TFLOP/s; GEMM yardstick (cuDNN F.conv2d, bf16, "
              f"channels_last) {k3_lib[v.shape[0]]!r} ms", flush=True)

    # 17. the int8 engine under the switches
    engine = fi.resnet_generator_int8_trunk_apply
    y0 = engine(gen, qblocks, xb).float()

    def plain_engine(stage, head):
        """The int8 engine with ``stage`` for its stage IN+ReLU and
        ``head`` on the last stage's raw output."""
        v = stage(gen.init_conv(xb))
        for m in gen.down:
            v = stage(m(v))
        v = qi.resblock_chain_int8_bf16io(v, qblocks)
        for i, m in enumerate(gen.up):
            v = m(v)
            if i < len(gen.up) - 1:
                v = stage(v)
        return head(v).float()

    def plain_k4(v):
        return fused.fused_instance_norm_act_plain(v, "relu") \
            if fused.in_act_fits(v) else fi._in_relu(v)

    def plain_k9(v):
        return fused.conv2d_reflect_cout1_plain(fi._in_relu(v), wh, bh,
                                                "tanh")

    def default_head(v):
        return fi._head_conv_tanh(v, gen.out_conv, raw_in=True)

    serve_eng = CycleGANInference("p2p", in_features=FEATURES,
                                  n_residual_blocks=BLOCKS, seed=1)
    saved = fi._FUSED_STAGE_IN, fi._HEAD_KERNEL
    k4_launches, k9_launches = 0, 0
    try:
        for stage_in, variant in (("1", ""),
                                  *(("", v) for v in HEAD_VARIANTS)):
            fi._FUSED_STAGE_IN, fi._HEAD_KERNEL = stage_in, variant
            label = "fused stage IN" if stage_in else f"head {variant}"
            kname = "in_act" if stage_in else "head_cout1"
            per_call = 3 if stage_in else 1
            yk, n = counted(lambda: engine(gen, qblocks, xb).float())
            print(f"[int8 engine, {label}] launches {n}", flush=True)
            want = {"resblock_int8_bf16io": BLOCKS, kname: per_call}
            check(all(v == want.get(k, 0) for k, v in n.items()),
                  f"{label}: one call launches {want} and no other kernel")
            if stage_in:
                k4_launches = n[kname]
            else:
                k9_launches += n[kname]
            yp = plain_engine(plain_k4, default_head) if stage_in \
                else plain_engine(fi._in_relu, plain_k9)
            for ref, what in ((y0, "the default engine"), (y32, "fp32")):
                (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item())
                                      for d in ((yk - ref).abs(),
                                                (yp - ref).abs()))
                print(f"[int8 engine, {label}] vs {what}: max {mk!r} mean "
                      f"{ak!r}; with the plain {kname} max {mp!r} mean "
                      f"{ap!r}", flush=True)
                check(mk <= mp + KERNEL_MAX_EXCESS,
                      f"{label}: max-abs vs {what} within the plain's + 0.1")
            # the mean, as in phase 4, against fp32, whose error dominates;
            # against the default engine both differences are the noise of
            # flipped requantized LSBs, and their ratio is not stable
            check(ak <= KERNEL_MEAN_RATIO * ap,
                  f"{label}: mean-abs vs fp32 within 1.1x the plain's")
            _, ns = counted(lambda: serve(serve_eng, images, BATCH, SIZE,
                                          f"resnet, {label}"))
            check(ns["resblock_int8_bf16io"] == 3 * 3 * BLOCKS
                  and ns[kname] == 3 * 3 * per_call,
                  f"{label}: three generator calls a request")
            print_times(f"resnet int8 engine, {label}", BENCH_BATCH,
                        lambda: engine(gen, qblocks, xbb))
    finally:
        fi._FUSED_STAGE_IN, fi._HEAD_KERNEL = saved

    # 18. global_generator_fast_apply at the CLI defaults
    cfg = P2PHD["global"]
    geng = Pix2PixHDInference("global", ngf=cfg["ngf"],
                              n_downsample_global=cfg["n_downsample_global"],
                              n_blocks_global=cfg["n_blocks_global"],
                              seed=0).G
    xg = images(cfg["batch"], P2P_SIZE).bfloat16()
    yg, ng = counted(lambda: fi.global_generator_fast_apply(geng, xg))
    yg_fw = geng(xg)
    print(f"[global fast forward] launches {ng}; max|fast-forward| "
          f"{(yg.float() - yg_fw.float()).abs().max().item()!r}", flush=True)
    check(all(v == 0 for v in ng.values()) and torch.equal(yg, yg_fw),
          "global at the CLI defaults: no K3, equal to the bf16 forward")

    def cudnn_head_ms(v):
        """cuDNN's bf16 conv of the reflect-padded NHWC ``v`` (padded
        beforehand, pad excluded) to one channel, channels_last: the
        yardstick of K9, never called by the port."""
        xp = F.pad(v.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect") \
            .contiguous(memory_format=torch.channels_last)
        wc = wh.detach().to(v.dtype).contiguous(
            memory_format=torch.channels_last)
        return cuda_ms(lambda: F.conv2d(xp, wc), 10)

    def in_norm_ms(v):
        """``F.instance_norm`` of NHWC ``v``: the yardstick of K4."""
        return cuda_ms(lambda: F.instance_norm(v.permute(0, 3, 1, 2)), 10)

    # the kernels' rows, at the checked batch
    rows = []
    v4 = d1.contiguous()
    u2c = u2n.contiguous()
    for (name, src, replaces, launches, err, kfn, pfn, (bnd, by),
         lib_ms) in (
            ("conv3x3_in_act", "conv3x3_in_act.cu", "pallas_kernels.py:224",
             n16["conv3x3_in_act"], k3_err,
             lambda: fused.fused_conv3x3_in_act(h, c1.weight, c1.bias),
             lambda: fused.fused_conv3x3_in_act_plain(h, c1.weight, c1.bias),
             k3_bound_ms(h, c1.weight, None), k3_lib[BATCH]),
            ("in_act", "in_act.cu", "pallas_kernels.py:111", k4_launches,
             k4_err, lambda: fused.fused_instance_norm_act(v4, "relu"),
             lambda: fused.fused_instance_norm_act_plain(v4, "relu"),
             bound(0, 2 * v4.numel() * v4.element_size()), in_norm_ms(v4)),
            ("head_cout1", "head_cout1.cu", "head_conv.py:341", k9_launches,
             k9_err,
             lambda: fused.conv2d_reflect_cout1_loop(u2c, wh, bh, "tanh"),
             lambda: fused.conv2d_reflect_cout1_plain(u2c, wh, bh, "tanh"),
             k9_bound_ms(u2c), cudnn_head_ms(u2c))):
        ms, plain_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/" + src,
                     "replaces": "cistar_tpu/ops/" + replaces,
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib_ms})
        print(f"[times] {name} at the checked shape: {ms!r} ms, bound {bnd!r} "
              f"ms ({by}), plain {plain_ms!r} ms, library {lib_ms!r} ms",
              flush=True)
    xb64 = images(BENCH_BATCH, SIZE).bfloat16()
    v4b = gen.down[1](fi._in_relu(gen.down[0](fi._in_relu(
        gen.init_conv(xb64))))).contiguous()
    d2b = gen.down[2](fi._in_relu(v4b)).contiguous()
    u2b = torch.relu(torch.randn(BENCH_BATCH, SIZE, SIZE, FEATURES, device=dev,
                                 dtype=torch.bfloat16, generator=g32))
    # K4 (relu) at the path's three stage shapes, both batches: ms, bound,
    # GB/s, and F.instance_norm on the same input. At batch 8 the calls
    # back to back are host-bound: the device time of one call (profiler,
    # all its kernels) is printed beside them
    for v in (v4, d2.contiguous(), v4b, d2b):
        fn = functools.partial(fused.fused_instance_norm_act, v, "relu")
        ms, busy = cuda_ms(fn, 20), profile_top(fn)[1]
        nbytes = 2 * v.numel() * v.element_size()
        bnd, by = bound(0, nbytes)
        print(f"[times] in_act {tuple(v.shape)}, relu, cluster "
              f"{kn.variant(*v.shape[1:], v.element_size())}: {ms!r} ms "
              f"(device {busy!r} ms a call), bound {bnd!r} ms ({by}), "
              f"{nbytes / ms * 1e-6!r} GB/s; F.instance_norm "
              f"{in_norm_ms(v)!r} ms", flush=True)
    # K9 (tanh, and pre_in) at both batches: ms, bound, TFLOP/s, GB/s of x,
    # and cuDNN's conv of the pre-padded input; the device time as above
    for vn, vr in ((u2c, u2), (u2b, u2b)):
        flops = 2 * vn.shape[0] * vn.shape[1] * vn.shape[2] * 49 * vn.shape[3]
        nbytes = vn.numel() * vn.element_size()
        for label, fn, (bnd, by) in (
                ("tanh", functools.partial(fused.conv2d_reflect_cout1_loop,
                                           vn, wh, bh, "tanh"),
                 k9_bound_ms(vn)),
                ("pre_in", functools.partial(head_conv_tanh_pallas, vr, wh,
                                             bh, pre_in=True),
                 k9_pre_bound_ms(vr))):
            ms, busy = cuda_ms(fn, 20), profile_top(fn)[1]
            print(f"[times] head_cout1 {tuple(vn.shape)} {label}: {ms!r} ms "
                  f"(device {busy!r} ms a call), bound {bnd!r} ms ({by}), "
                  f"{flops / ms * 1e-9!r} TFLOP/s, {nbytes / ms * 1e-6!r} "
                  f"GB/s of x", flush=True)
        print(f"[times] cuDNN F.conv2d bf16 channels_last, pre-padded "
              f"{tuple(vn.shape)} -> 1 channel: {cudnn_head_ms(vn)!r} ms",
              flush=True)
    return rows


def calibrate(gen, x) -> None:
    """Set each BatchNorm's running statistics, layer by layer, to the batch
    mean and biased variance of its input under the fp32 forward of ``x``
    (TF32 off; a shared layer keeps the first input it sees)."""
    import torch

    from cistar_tpu_torch.models.pix2pixhd import BatchNorm

    seen, hooks = set(), []

    def pre(m, args):
        if m not in seen:
            seen.add(m)
            v = args[0].float()
            m.running_mean.copy_(v.mean(dim=(0, 1, 2)))
            m.running_var.copy_(v.var(dim=(0, 1, 2), unbiased=False))
    for m in gen.modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(pre))
    try:
        with fp32_exact(), torch.no_grad():
            gen(x.float())
    finally:
        for h in hooks:
            h.remove()


def bn_local_path(images, counters) -> list:
    """Phases 19-22; the kernels' JSON rows of K1-bn, K7a-bn and K7b-bn."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.kernels import int8_tiled as kt
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import quant_int8 as qi

    def counted(fn):
        """``fn()`` with every launch counter set to 0 just before; its
        result and the counts just after."""
        for m in counters:
            m.reset_launches()
        y = fn()
        torch.cuda.synchronize()
        return y, {k: v for m in counters for k, v in m.launches.items()}

    ms_cfg, lo_cfg = MULTISCALE, LOCAL
    ms_eng = Pix2PixHDInference("multiscale", ngf=ms_cfg["ngf"],
                                n_blocks_global=ms_cfg["n_blocks_global"],
                                seed=0)
    msg = ms_eng.G
    calibrate(msg, images(CALIB_BATCH, ms_cfg["size"]))
    ms_q = ms_eng.quantize_generator()
    lo_eng = Pix2PixHDInference(
        "local", **{k: lo_cfg[k] for k in (
            "ngf", "n_downsample_global", "n_blocks_global",
            "n_local_enhancers", "n_blocks_local")}, seed=0)
    log, lo_q = lo_eng.G, lo_eng.quantize_generator()
    nb = ms_cfg["n_blocks_global"]

    def fp32_block(blk, h):
        with fp32_exact():
            return blk(h.float())

    def bit_exact(label, yk, yp):
        err = (yk.float() - yp.float()).abs().max().item()
        print(f"[kernels] {label} {tuple(yk.shape)} {yk.dtype}: "
              f"max|kernel-plain| {err!r}, bit-exact {torch.equal(yk, yp)}",
              flush=True)
        check(torch.equal(yk, yp), f"{label} bit-exact vs plain")
        return err

    def budget(label, y, y32):
        fb = (y.float() - y32).abs().max().item()
        print(f"[kernels] {label} vs the fp32 block {fb!r}, {TILED_BUDGET} "
              f"budget {'met' if fb <= TILED_BUDGET else 'missed'}",
              flush=True)

    # 19. kernels on the paths' own trunk activations
    size, n = ms_cfg["size"], ms_cfg["batch"]
    x_ms = images(n, size)
    h7 = fi.multiscale_encode(msg, x_ms.bfloat16()).contiguous()
    check(tuple(h7.shape) == (n, 64, 64, 512), f"trunk {tuple(h7.shape)}")
    check(not qi.whole_image_resblock_fits(64, 64, 512)
          and qi.pick_cout_tile(64 * 64, 512) == BN_TILE,
          "the JAX rule sends the 64²×512 trunk to K7 at ct 128")
    q0 = ms_q[0]
    k7a_conv_vs_plain("K7a-bn", h7, q0)
    rqp, rsp, err_a = k7a_vs_plain("K7a-bn", h7, q0, BN_TILE, bn=True)
    errs = {"a": err_a}
    k7b_conv_vs_plain("K7b-bn", rqp, q0, BN_TILE)
    errs["b"] = bit_exact("K7b-bn (on the plain rq)", kt.resblock_int8_tiled_b(
        rqp, rsp, h7, q0, BN_TILE, qi.EPS, bn=True), qi.resblock_tiled_b_plain(
        rqp, rsp, h7, q0, BN_TILE, bn=True))
    y7 = qi.resblock_int8_tiled(h7, q0, BN_TILE, bn=True)
    bit_exact("K7-bn block", y7,
              qi.resblock_int8_tiled_plain(h7, q0, BN_TILE, bn=True))
    budget("K7-bn block", y7, fp32_block(msg.res[0], h7))

    n1, size1 = ms_cfg["small_batch"], ms_cfg["small_size"]
    x_ms1 = images(n1, size1)
    h1 = fi.multiscale_encode(msg, x_ms1.bfloat16()).contiguous()
    check(tuple(h1.shape) == (n1, 32, 32, 512)
          and qi.whole_image_resblock_fits(32, 32, 512),
          f"the 256² trunk {tuple(h1.shape)} fits K1")
    v1 = kr.conv_variant_card(*h1.shape)
    print(f"[kernels] K1-bn conv at {tuple(h1.shape)}: wgmma BN {v1}",
          flush=True)
    check(v1 == kr.conv_variant(*h1.shape) != 0, "K1-bn on the wgmma conv")
    y1 = kr.resblock_int8_bf16io(h1, q0, qi.EPS, bn=True)
    errs["k1"] = bit_exact("K1-bn", y1,
                           qi.resblock_int8_bf16io_plain(h1, q0, bn=True))
    budget("K1-bn block", y1, fp32_block(msg.res[0], h1))

    x_lo = images(lo_cfg["batch"], lo_cfg["size"])
    hl = fi.trunk_encode(log.global_trunk, log.pyramid(x_lo.bfloat16())[-1]) \
        .contiguous()
    check(tuple(hl.shape) == (lo_cfg["batch"], 64, 64, 512),
          f"local trunk {tuple(hl.shape)}")
    ql = lo_q[0]
    k7a_conv_vs_plain("K7a (local)", hl, ql)
    rqp, rsp, _ = k7a_vs_plain("K7a (local)", hl, ql, BN_TILE)
    k7b_conv_vs_plain("K7b (local)", rqp, ql, BN_TILE)
    err_b, over_b = k7b_vs_plain(rqp, rsp, hl, ql, BN_TILE)
    print(f"[kernels] K7b (local) {tuple(hl.shape)} ct {BN_TILE} on the plain "
          f"rq: max|kernel-plain| {err_b!r}, over one ulp {over_b!r} (tol "
          f"{K7_ABS})", flush=True)
    check(over_b <= K7_ABS,
          "K7b at ct 128 within one bf16 ulp + 0.01 of plain")
    yl = qi.resblock_int8_tiled(hl, ql, BN_TILE)
    d = (yl.float() - qi.resblock_int8_tiled_plain(hl, ql, BN_TILE).float()) \
        .abs()
    over = (d - K7_REL * yl.float().abs()).max().item()
    print(f"[kernels] K7 block (local) {tuple(hl.shape)} ct {BN_TILE} bf16: "
          f"max|kernel-plain| {d.max().item()!r}, max over one ulp {over!r} "
          f"(tol {K7_ABS})", flush=True)
    check(over <= K7_ABS, "K7 at ct 128 within one bf16 ulp + 0.01 of plain")
    budget("K7 block (local)", yl, fp32_block(log.global_trunk.res[0], hl))

    # 20. each path, counted
    def plain_ms(x):
        h = fi.multiscale_encode(msg, x)
        for q in ms_q:
            h = (qi.resblock_int8_bf16io_plain(h, q, bn=True)
                 if qi.whole_image_resblock_fits(*h.shape[1:])
                 else qi.resblock_int8_tiled_plain(h, q, BN_TILE, bn=True))
        return fi.multiscale_decode(msg, h)

    def plain_lo(x):
        pyr = log.pyramid(x)
        h = fi.trunk_encode(log.global_trunk, pyr[-1])
        for q in lo_q:
            h = qi.resblock_int8_tiled_plain(h, q, BN_TILE)
        return fi.local_decode(log, h, pyr)

    launches = {}
    for label, gen, engine, plain, x, want in (
            ("multiscale 512²", msg,
             lambda v: fi.multiscale_global_int8_apply(msg, ms_q, v),
             plain_ms, x_ms, {"resblock_int8_tiled_a_bn": nb,
                              "resblock_int8_tiled_b_bn": nb}),
            ("multiscale 256²", msg,
             lambda v: fi.multiscale_global_int8_apply(msg, ms_q, v),
             plain_ms, x_ms1, {"resblock_int8_bf16io_bn": nb}),
            ("local 1024²", log,
             lambda v: fi.local_enhancer_int8_apply(log, lo_q, v),
             plain_lo, x_lo, {"resblock_int8_tiled_a": nb,
                              "resblock_int8_tiled_b": nb})):
        xb = x.bfloat16()
        (y_bf16, y_int8), cnt = counted(lambda: (gen(xb).float(),
                                                 engine(xb).float()))
        print(f"[{label} path] launches {cnt}", flush=True)
        check(all(v == want.get(k, 0) for k, v in cnt.items()),
              f"one {label} call launches {want} and no other kernel")
        for k in want:
            launches[k] = launches.get(k, 0) + cnt[k]
        with fp32_exact():
            y32 = gen(x)
        dk, dp = (y_int8 - y32).abs(), (plain(xb).float() - y32).abs()
        (mk, ak), (mp, ap) = ((v.max().item(), v.mean().item())
                              for v in (dk, dp))
        print(f"[{label} path] int8 engine vs fp32: max {mk!r} mean {ak!r}; "
              f"with plain kernels max {mp!r} mean {ap!r}", flush=True)
        check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
              f"{label}: kernels add little to the plain error")
        for name, y in (("bf16", y_bf16), ("int8", y_int8)):
            check(tuple(y.shape) == tuple(x.shape)
                  and bool(torch.isfinite(y).all()),
                  f"{label} {name} output shape/finite")
            dd = (y - y32).abs()
            print(f"[{label} path] {name} vs fp32: max {dd.max().item()!r} "
                  f"mean {dd.mean().item()!r}", flush=True)

    # 21. three requests per family
    for family, eng, qb, n_req, sz, want in (
            ("multiscale", ms_eng, ms_q, n, size,
             {"resblock_int8_tiled_a_bn": nb, "resblock_int8_tiled_b_bn": nb}),
            ("local", lo_eng, lo_q, lo_cfg["batch"], lo_cfg["size"],
             {"resblock_int8_tiled_a": nb, "resblock_int8_tiled_b": nb})):
        for r in range(3):
            lab = images(n_req, sz)
            t0 = time.perf_counter()
            out = eng.infer_step(lab)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out8, cnt = counted(lambda: eng.infer_step_int8(qb, lab))
            t2 = time.perf_counter()
            check(all(v == want.get(k, 0) for k, v in cnt.items()),
                  f"{family} request: one generator call's launches")
            for o in (out, out8):
                check(tuple(o.shape) == (n_req, sz, sz, 1)
                      and o.dtype == torch.float32
                      and bool(torch.isfinite(o).all()),
                      f"{family} served output")
            print(f"[serve {family}] request {r}: infer_step "
                  f"{1e3 * (t1 - t0):.3f} ms, infer_step_int8 "
                  f"{1e3 * (t2 - t1):.3f} ms, max|int8-bf16| "
                  f"{(out - out8).abs().max().item():.4f}", flush=True)

    # 22. times
    xmb = images(ms_cfg["bench_batch"], size).bfloat16()
    xlb = images(lo_cfg["bench_batch"], lo_cfg["size"]).bfloat16()
    for label, nbat, gen, fn in (
            ("multiscale", ms_cfg["bench_batch"], msg,
             lambda: fi.multiscale_global_int8_apply(msg, ms_q, xmb)),
            ("local", lo_cfg["bench_batch"], log,
             lambda: fi.local_enhancer_int8_apply(log, lo_q, xlb))):
        xx = xmb if label == "multiscale" else xlb
        print_times(f"{label} generator bf16", nbat, lambda: gen(xx))
        print_times(f"{label} generator int8", nbat, fn)
    bn_local_breakdown(msg, ms_q, xmb, log, lo_q, xlb)

    hmb = fi.multiscale_encode(msg, xmb).contiguous()
    # K7a-bn and K7b-bn at the timed batch, checked as at the checked one
    k7a_conv_vs_plain("K7a-bn", hmb, q0)
    rqb, rsb, _ = k7a_vs_plain("K7a-bn", hmb, q0, BN_TILE, bn=True)
    rq7, rs7 = qi.resblock_tiled_a_plain(h7, q0, BN_TILE, bn=True)
    k7b_conv_vs_plain("K7b-bn", rqb, q0, BN_TILE)
    bit_exact("K7b-bn (on the plain rq)",
              kt.resblock_int8_tiled_b(rqb, rsb, hmb, q0, BN_TILE, qi.EPS,
                                       bn=True),
              qi.resblock_tiled_b_plain(rqb, rsb, hmb, q0, BN_TILE, bn=True))
    k7b_lib = {v.shape[0]: gemm_ms(im2col_reflect(v), q0["w2k"])
               for v in (rq7, rqb)}
    k7a_lib = {v.shape[0]: gemm_ms(im2col_reflect(qi.quantize_act(v)[0]),
                                   q0["w1k"]) for v in (h7, hmb)}
    h1b = fi.multiscale_encode(msg, images(BENCH_BATCH, size1).bfloat16()) \
        .contiguous()
    bit_exact("K1-bn (BN 256)", kr.resblock_int8_bf16io(h1b, q0, qi.EPS,
                                                        bn=True),
              qi.resblock_int8_bf16io_plain(h1b, q0, bn=True))
    k1_lib = {v.shape[0]: int_mm_ms(qi.quantize_act(v)[0], q0["w1k"])
              for v in (h1, h1b)}
    rows = []
    for name, line, src, err, kfn, kfn_b, pfn, (bnd, by), (bnd_b, _) in (
            ("resblock_int8_bf16io_bn", ":240", "int8_resblock.cu", errs["k1"],
             lambda: kr.resblock_int8_bf16io(h1, q0, qi.EPS, bn=True),
             lambda: kr.resblock_int8_bf16io(h1b, q0, qi.EPS, bn=True),
             lambda: qi.resblock_int8_bf16io_plain(h1, q0, bn=True),
             k_bound_ms(*h1.shape, 2), k_bound_ms(*h1b.shape, 2)),
            ("resblock_int8_tiled_a_bn", ":519", "int8_tiled.cu", errs["a"],
             lambda: kt.resblock_int8_tiled_a(h7, q0, BN_TILE, qi.EPS, bn=True),
             lambda: kt.resblock_int8_tiled_a(hmb, q0, BN_TILE, qi.EPS,
                                              bn=True),
             lambda: qi.resblock_tiled_a_plain(h7, q0, BN_TILE, bn=True),
             k7_bound_ms(*h7.shape, "a"), k7_bound_ms(*hmb.shape, "a")),
            ("resblock_int8_tiled_b_bn", ":532", "int8_tiled.cu", errs["b"],
             lambda: kt.resblock_int8_tiled_b(rq7, rs7, h7, q0, BN_TILE,
                                              qi.EPS, bn=True),
             lambda: kt.resblock_int8_tiled_b(rqb, rsb, hmb, q0, BN_TILE,
                                              qi.EPS, bn=True),
             lambda: qi.resblock_tiled_b_plain(rq7, rs7, h7, q0, BN_TILE,
                                               bn=True),
             k7_bound_ms(*h7.shape, "b"), k7_bound_ms(*hmb.shape, "b"))):
        ms, plain_ms_ = cuda_ms(kfn, 20), cuda_ms(pfn, 5)
        lib_of = {"resblock_int8_bf16io_bn": k1_lib,
                  "resblock_int8_tiled_a_bn": k7a_lib,
                  "resblock_int8_tiled_b_bn": k7b_lib}[name]
        lib_ms = lib_of[h1.shape[0] if name == "resblock_int8_bf16io_bn" else n]
        rows.append({"name": name, "route": "cuda",
                     "source": "cistar_tpu_torch/csrc/" + src,
                     "replaces": "cistar_tpu/ops/quant_pallas.py" + line,
                     "launches": launches[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms_, "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib_ms})
        if name == "resblock_int8_bf16io_bn":
            print_block_times(name, tuple(h1.shape), ms, 2, k1_lib[h1.shape[0]],
                              plain_ms_)
            print_block_times(name, tuple(h1b.shape), cuda_ms(kfn_b, 10), 2,
                              k1_lib[h1b.shape[0]])
        else:
            ops = 2 * h7.numel() * 9 * h7.shape[-1]
            print_conv_times(name, tuple(h7.shape), ms, ops, bnd, lib_ms,
                             f", plain {plain_ms_!r} ms")
            print_conv_times(name, tuple(hmb.shape), cuda_ms(kfn_b, 10),
                             ops * hmb.shape[0] / n, bnd_b,
                             lib_of[hmb.shape[0]])
    hlb = fi.trunk_encode(log.global_trunk, log.pyramid(xlb)[-1]).contiguous()
    # K7a and K7b (local) at the timed batch, checked as at the checked one
    k7a_conv_vs_plain("K7a (local)", hlb, ql)
    k7a_vs_plain("K7a (local)", hlb, ql, BN_TILE)
    rqlb, rslb = kt.resblock_int8_tiled_a(hlb, ql, BN_TILE, qi.EPS)
    k7b_conv_vs_plain("K7b (local)", rqlb, ql, BN_TILE)
    err_b, over_b = k7b_vs_plain(rqlb, rslb, hlb, ql, BN_TILE)
    print(f"[kernels] K7b (local) {tuple(hlb.shape)} ct {BN_TILE}: "
          f"max|kernel-plain| {err_b!r}, over one ulp {over_b!r} (tol "
          f"{K7_ABS})", flush=True)
    check(over_b <= K7_ABS, f"K7b {tuple(hlb.shape)} within one bf16 ulp + "
          "0.01 of plain")
    ops = 2 * hlb.numel() * 9 * hlb.shape[-1]
    print_conv_times(
        f"resblock_int8_tiled_a ct {BN_TILE}", tuple(hlb.shape),
        cuda_ms(lambda: kt.resblock_int8_tiled_a(hlb, ql, BN_TILE, qi.EPS), 10),
        ops, k7_bound_ms(*hlb.shape, "a")[0],
        gemm_ms(im2col_reflect(qi.quantize_act(hlb)[0]), ql["w1k"]))
    print_conv_times(
        f"resblock_int8_tiled_b ct {BN_TILE}", tuple(hlb.shape),
        cuda_ms(lambda: kt.resblock_int8_tiled_b(rqlb, rslb, hlb, ql, BN_TILE,
                                                 qi.EPS), 10),
        ops, k7_bound_ms(*hlb.shape, "b")[0],
        gemm_ms(im2col_reflect(rqlb), ql["w2k"]))
    return rows


def bn_local_breakdown(msg, ms_q, xm, log, lo_q, xl) -> None:
    """Where the time of the ``multiscale`` and ``local`` engines goes:
    CUDA-event ms of each segment of one generator call, on the engine's
    own activations."""
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn

    t_in = fi.multiscale_encode(msg, xm)
    t_out = fi.global_trunk_int8(t_in, ms_q, bn=True)
    ups = [t_out]
    for m in msg.up:
        ups.append(m(ups[-1]))

    def run(mods, v):
        for m in mods:
            v = m(v)
        return v

    def run_ups(stage):
        for m, v in zip(msg.up, ups):
            stage(m, v)
    segs = {"branches + fuse": (lambda: msg.encode(xm),
                                lambda: fi.multiscale_encode(msg, xm)),
            "trunk": (lambda: run(msg.res, t_in),
                      lambda: fi.global_trunk_int8(t_in, ms_q, bn=True)),
            "ups": (lambda: run_ups(lambda m, v: m(v)),
                    lambda: run_ups(fi._bn_stage)),
            "head": (lambda: msg.head(ups[-1]),
                     lambda: tnn.tanh(msg.head.conv(ups[-1])))}
    for e, engine in enumerate(("bf16", "int8")):
        ms = {k: cuda_ms(v[e], 5) for k, v in segs.items()}
        print(f"[breakdown] multiscale {engine} batch {xm.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in ms.items())
              + f"; sum {sum(ms.values())!r}", flush=True)

    tr = log.global_trunk
    pyr = log.pyramid(xl)
    g_in = fi.trunk_encode(log.global_trunk, pyr[-1])
    g_out = fi.global_trunk_int8(g_in, lo_q)
    e_in = run(tr.up, g_out)
    segs = {"pyramid": (lambda: log.pyramid(xl),) * 2,
            "global stem + downs": (
                lambda: run(tr.down, tr.stem(pyr[-1])),
                lambda: fi.trunk_encode(log.global_trunk, pyr[-1])),
            "global trunk": (lambda: run(tr.res, g_in),
                             lambda: fi.global_trunk_int8(g_in, lo_q)),
            "global ups": (lambda: run(tr.up, g_out),) * 2,
            "enhancer + head": (
                lambda: log.head(run([log.enhancer(1, f"res_{i}") for i in
                                      range(log.n_blocks_local)]
                                     + [log.enhancer(1, "up")],
                                     log.enhancer(1, "down")(
                                         log.enhancer(1, "stem")(pyr[0]))
                                     + e_in)),
                lambda: fi.local_decode(log, g_out, pyr))}
    for e, engine in enumerate(("bf16", "int8")):
        ms = {k: cuda_ms(v[e], 5) for k, v in segs.items()}
        if e == 1:   # the int8 decode includes the global ups
            ms["enhancer + head"] -= ms["global ups"]
        print(f"[breakdown] local {engine} batch {xl.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in ms.items())
              + f"; sum {sum(ms.values())!r}", flush=True)


# The training path (slice 11): the CycleGAN train step at the JAX CLI's
# defaults (apps/cyclegan_train.py:19-48): bilinear_content, 16 features, 6
# atrous blocks, 512², batch 4, pool 50, bf16 compute with fp32 params,
# gradients, Adam state and losses. The card is held to the CPU on a small
# copy (TRAIN_CHECK): 3 steps of batch 2 stay in pool 8's fill phase, so the
# two devices' coin draws are never read. Both run fp32 with TF32 off and
# sum in other orders (cuDNN's algorithms, atomics). The metrics come from
# the forward before the update: ~1e-6 apart. The update is Adam's, about
# lr = 2e-4 a weight whatever the gradient's size, so a gradient within
# rounding of 0 can take either sign (on an H100 80GB HBM3 at 700 W against
# the CPU, 4,811-4,894 of G's 10,021,442 did at step 0, most of them biases
# ahead of an instance norm), and G_A2B's output after one step differed by
# 3.5e-4. Free-running, the steps amplify that
# (0.023-0.031 after three), so each card step starts from the CPU's state;
# phase 23 prints both numbers.
TRAIN = dict(features=16, blocks=6, size=512, batch=4, pool=50)
TRAIN_CHECK = dict(size=64, batch=2, pool=8, steps=3)
TRAIN_RTOL, TRAIN_ABS = 1e-3, 1e-3
TRAIN_WARMUP, TRAIN_STEPS, CLI_PAIRS = 2, 10, 16


# The other CycleGAN generators at the JAX CLIs' defaults; the checked
# batch and the JAX suite's atrousdense512_int8 batch
# (benchmarks/run_suite.py:540-541, bench_cyclegan_family_infer)
FAM = dict(features=16, blocks=6, size=512, batch=4, bench_batch=32)
# label, gen_type, dense_decoder
FAMILIES = (("atrous dense", "atrous_content", True),
            ("atrous", "atrous_content", False),
            ("unet", "unet_content", True))
# The JAX package's res-trunk budget, max-abs of one int8 block (K1's
# bf16 carrier) vs its fp32 module (benchmarks/kernel_matrix_r5.json,
# trunk_bf16io): printed, as the 0.1 above.
TRUNK_BUDGET = 0.35
FAM_TRAIN_STEPS = 3


# The Gatys IST path (slice 13) at the JAX CLI's defaults
# (cistar_tpu/core/config.py::get_ist_cfg_defaults, apps/ist_main.py): 512²,
# 300 iterations, history 100; the HR pass at 1024² (500 iterations in
# the CLI, 100 timed alone); the batched sweep at F = 4. Checks at 64²,
# batch 3.
GATYS = dict(size=512, iters=300, hr_size=1024, hr_iters=100, batch=4,
             check_size=64, check_batch=3, cli_frames=4)
# VGG-19 features on the card vs the CPU, max-abs over each feature's
# largest |value|: the CPU tests' gates against JAX (fp32 1e-4, the order
# of sums; bf16 3e-2, a bf16 rounding landing an ulp away)
GATYS_FEAT_FP32, GATYS_FEAT_BF16 = 1e-4, 3e-2
# optimize in fp32, card vs CPU and F = 3 vs F = 1, at 1 iteration, and
# each of 3 card iterations from the CPU's state (gatys_teacher_forced):
# the reference's gate (tests/test_vgg_gatys.py:170-171). Measured on an
# H100 80GB HBM3 at 700 W: the loss 1e-7 to 7.6e-7 apart, the image 3.1e-5
GATYS_RTOL, GATYS_ATOL = 1e-5, 1e-4


# The pix2pixHD train step (slice 14) at the shipped recipe
# (checkpoints/r2l_MSRB_7/opt.txt; batch 1, 512²) and at the JAX CLI's
# 'global' default with the VGG19 loss (apps/p2phd_options.py: ngf 64, 4
# downsamplings, 9 blocks); both bf16, the JAX CLI's default. The card is
# held to the CPU at 64², batch 2, fp32 with TF32 off, with TRAIN_RTOL /
# TRAIN_ABS, each card step from the CPU's state (phase 23's reasons).
P2P_TRAIN = {"UNet": dict(ngf=64, n_blocks_global=3),
             "global": dict(ngf=64, n_downsample_global=4,
                            n_blocks_global=9)}
P2P_TRAIN_COMMON = dict(ndf=64, num_d=2, n_layers_d=3, lr=1e-4, beta1=0.5,
                        niter=50, niter_decay=50, pool_size=0,
                        image_size=512)
P2P_TRAIN_BATCH = 1
# timed steps of each configuration, each between CUDA events of its own
P2P_TRAIN_STEPS = 30
P2P_CHECK = dict(size=64, batch=2)
P2P_CHECK_CFG = {
    "UNet": dict(ngf=8, n_blocks_global=1),
    "multiscale": dict(ngf=8, n_blocks_global=1),
    "global": dict(ngf=8, n_downsample_global=3, n_blocks_global=2,
                   no_instance=False, instance_feat=True)}
# (label, family, steps, VGG19 loss): global runs with and without it
P2P_CHECK_RUNS = (("UNet", "UNet", 3, False),
                  ("multiscale", "multiscale", 1, False),
                  ("global", "global", 1, True),
                  ("global, no VGG19", "global", 1, False))
# Phase 36 holds each net's backward from the CPU's state and inputs, and
# the step as stepped, with the card's activation patterns replayed on the
# CPU. Each device alone puts the few inputs that lie within their
# rounding of a kink on its own side, and cuDNN's default forward is not
# bitwise repeatable, so the side changes from run to run: at these widths
# one ReLU on the other side moves G's gradient by 1e-2 of its largest,
# and max pool picks in VGG19 move G's first moment by 4e-3
# (tools/p2p_check_repeat.py --no-replay counts the runs that fail so).
# Adam's first step moves a weight by ±lr on its gradient's sign whatever
# the gradient's size, so where a gradient lies within the two devices'
# rounding of 0 (global's stem weights on the edge map, 1 at 99.9% of the
# pixels of per-pixel random ids) the card and the CPU move it 2·lr apart;
# G's output after the step is held as stepped and, tighter in practice,
# with the CPU's values at those weights.
P2P_CLI_PAIRS, P2P_TEST_PAIRS = 16, 4


# The extended trainers (slice 15). Full width: the UDA pair at
# checkpoints/r2l_MSRB_7/opt.txt through `p2phd_train --uda` (ngf 64, 2
# downsamplings, max_ch 256, no encoder blocks, ndf 64, 2 × 3-layer D,
# 512², batch 1; fp32, the CLI's default, also --fp16 and --wgan; the image
# critic, the CLI's default module: ngf 16, 5 layers, fp32), R2LTransfer
# and the transfer pair through create_model at the JAX constructors'
# widths (ngf 32, 4 downsamplings, 3 scales, 3 blocks, df_layers 5, ndf
# 64, 2 × 3-layer D; 512², batch 1, fp32), and Pix2PixHD with
# netG=autoencoder at r2l_MSRB_7's G widths (ngf 64, 2 downsamplings, 3
# blocks; bf16, p2phd_train's default). The card is held to the CPU at 64²,
# batch 2, fp32 with TF32 off (EXT_CHECK), with TRAIN_RTOL / TRAIN_ABS and
# the card's activation patterns replayed on the CPU (phase 36's reasons).
EXT_CHECK = dict(size=64, batch=2)
# R2LAE.infer, frame 0 alone vs in a batch of 4, fp32 with TF32 off: eval
# mode reads the running statistics, so only the order of sums differs
# (cuDNN picks its algorithms by batch: 2.9e-5 read at 512² on the H100)
INFER_BATCH_ABS = 1e-4
EXT_CHECK_R2LAE = dict(size=64, n_downsample=1, ngf=8, max_ch=16, ndf=8)
EXT_CHECK_CRITIC = dict(ngf=8, n_layer=5)
EXT_CHECK_TRANSFER = dict(ngf=8, n_downsampling=3, n_scale=2, n_blocks=1,
                          ndf=8, df_layers=3, image_size=64)
P2P_CHECK_CFG.update({
    "transfer": dict(ngf=8, n_downsample_global=3, n_scale=2,
                     n_blocks_global=1),
    "autoencoder": dict(ngf=8, n_downsample_global=2, n_blocks_global=1)})
EXT_P2P_RUNS = (("transfer pair", "transfer", 1, False),
                ("autoencoder", "autoencoder", 1, False))
# the JAX constructors' widths (cistar_tpu/engines/extended.py:102-105)
EXT_TRANSFER_FLAGS = ["--ngf", "32", "--n_downsample_global", "4",
                      "--n_scale", "3", "--n_blocks_global", "3",
                      "--ndf", "64", "--n_layers_D", "3", "--num_D", "2"]
EXT_STEPS, EXT_SIZE = 30, 512
# the UI session's engine: the JAX CLI's 'global' default with three
# feature channels (instance_feat + load_features)
EXT_UI = dict(ngf=64, n_downsample_global=4, n_blocks_global=9)
# encode_features at the JAX CLI's defaults, on the CLI's 16 pairs
EXT_FEATURES = ["--nef", "16", "--n_downsample_E", "4", "--feat_num", "3",
                "--n_clusters", "10", "--label_nc", "0"]

# LPIPS, checkpoint import and the dashboard (slice 16). Phase 46: the
# rows of tools/fidelity_table.py at its shapes (row, batch of
# make_radar, size), weights from seed 0; every engine within
# utils/fidelity.py's BUDGET of its fp32 forward in the calibrated LPIPS
# metric. The card's LPIPS of the first row's first two (bf16, fp32) pairs
# within LPIPS_CPU_RTOL of the CPU's on the same tensors: fp32 with TF32
# off, so only the convs' order of sums differs.
FIDELITY_ROWS = (("cyclegan256", 8, 256), ("p2phd_global512", 4, 512),
                 ("unet_msrb512", 4, 512), ("local1024", 2, 1024))
LPIPS_CPU_RTOL = 1e-4
# Phase 47: the reference's .pth files from the torch twins
# (tools/reference_twins.py), seeded: the UNet of
# checkpoints/r2l_MSRB_7/opt.txt (64 features, 3 MSRB blocks), and the
# CycleGAN test CLI's bilinear_content pair (16 features, 6 blocks) with
# its two D; the test CLIs on CKPT_FRAMES test frames of CKPT_PAIRS
# synthetic 512² pairs (CycleGAN's test split is the last 10%: 2 of 12).
# Each CLI's fp32 output against the twin's fp32 forward of the same frame
# on the card, TF32 off on both sides: within CKPT_FP32_ABS of the twin
# with the port's one-pass instance-norm moments (the twin's NCHW convs
# and the port's NHWC ones sum in other orders: 1.9e-6 read at the UNet),
# and within CKPT_REF_ABS of the twin's own nn.InstanceNorm2d, from which
# the one-pass moments, E[x²] − E[x]² in fp32 as the JAX package takes
# them, move the output by 1.2e-5-1.8e-5 (read on the H100).
CKPT_UNET, CKPT_BIL = dict(nf=64, n_res=3), dict(nf=16, n_res=6)
CKPT_SIZE, CKPT_PAIRS, CKPT_FRAMES = 512, 12, 2
CKPT_FP32_ABS, CKPT_REF_ABS = 1e-5, 5e-5
# Runs a CLI's ``main`` in a process of its own, as ``python -m`` would:
# argv[1] the module, argv[2] an .npz for what its engine computed (every
# infer_step / infer_step_int8 call's inputs and outputs, in call order),
# argv[3] "0" to turn TF32 off; prints the kernel launch counts as JSON on
# its last line.
CLI_RUNNER = r"""
import importlib, json, sys
import numpy as np, torch
mod, out, tf32 = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
argv = sys.argv[4:]
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
from cistar_tpu_torch.engines.cyclegan import CycleGANInference
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.kernels import (fused_conv, head_cout1, in_act,
    int8_atrous, int8_msrb, int8_resblock, int8_tiled)
calls = []
def record(cls, name):
    fn = getattr(cls, name)
    def wrapped(self, *a):
        y = fn(self, *a)
        ins = [t for v in a for t in (v if isinstance(v, tuple) else (v,))
               if isinstance(t, torch.Tensor)]
        calls.append([t.float().cpu().numpy() for t in
                      (*ins, *(y if isinstance(y, tuple) else (y,)))])
        return y
    setattr(cls, name, wrapped)
for cls in (CycleGANInference, Pix2PixHDInference):
    for name in ("infer_step", "infer_step_int8"):
        record(cls, name)
mods = (fused_conv, head_cout1, in_act, int8_atrous, int8_msrb,
        int8_resblock, int8_tiled)
importlib.import_module(mod).main(argv)
if torch.cuda.is_available():
    torch.cuda.synchronize()
np.savez(out, **{f"{c:03d}_{i}": v for c, vs in enumerate(calls)
                   for i, v in enumerate(vs)})
print(json.dumps({k: v for m in mods for k, v in m.launches.items()}))
"""


def family(dev, gen_type: str, dense: bool, seed: int = 0):
    """One of the other CycleGAN generators at ``FAM``'s width, its
    quantized trunk and its int8 engine ``fn(gen, q, x)``."""
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator

    gen = seeded_generator(gen_type, FAM["blocks"], FAM["features"],
                           seed=seed, device=dev, dense_decoder=dense)
    if gen_type.startswith("unet"):
        return gen, fi.quantize_unet_trunk(gen), \
            fi.unet_generator_int8_trunk_apply
    return gen, fi.quantize_multiscale_trunk(gen), \
        fi.multiscale_generator_int8_trunk_apply


def family_encode(gen, qt, x, stage_int8):
    """Stem and encoder of a CycleGAN skip-decoder generator as its int8
    engine runs them, with ``stage_int8`` for the stages its rule sends to
    K6 (none in 'unet'): (stage inputs, stage outputs)."""
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn

    qenc = qt.get("enc") if isinstance(qt, dict) else None
    h = tnn.relu(tnn.instance_norm(gen.init_conv(x)))
    ins, outs = [], []
    for i, stage in enumerate(gen.down):
        ins.append(h)
        h = stage_int8(h, qenc[i]) if qenc is not None \
            and fi.stage_kernel_fits(h, qenc[i]) else stage(h)
        outs.append(h)
    return ins, outs


def family_plain_engine(gen, qt, x):
    """A family's int8 engine with the plain versions of K1 / K6."""
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import quant_int8 as qi

    _, skips = family_encode(gen, qt, x, lambda h, q: (
        qi.multi_atrous_stage_int8_plain(h[:, ::2, ::2], q, RATES2)))
    h = skips[-1]
    for q in (qt["res"] if isinstance(qt, dict) else qt):
        h = qi.resblock_int8_bf16io_plain(h, q)
    return fi.convt_decode(gen, h, skips)


def k1_trunk_check(gen, h, q) -> float:
    """Phase 27 at one batch: K1's conv bit for bit and at BN 128, K1
    within ``K1_*`` of plain, one block vs its fp32 module; K1's max-abs
    error against plain."""
    import torch

    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.ops import quant_int8 as qi

    hq, _ = qi.quantize_act(h)
    shape = tuple(hq.shape)
    check(torch.equal(kr.conv3x3_reflect_s8(hq, q["w1k"]),
                      qi.conv3x3_reflect_s8_plain(hq, q["w1q"])),
          f"conv3x3_reflect_s8 {shape} bit-exact")
    v_card, v_py = kr.conv_variant_card(*shape), kr.conv_variant(*shape)
    print(f"[kernels] conv3x3_reflect_s8 {shape}: int32 accumulators "
          f"bit-exact vs plain; wgmma BN {v_card} (Python mirror {v_py})",
          flush=True)
    check(v_card == v_py == 128, f"the wgmma conv at BN 128 at {shape}")
    yk = kr.resblock_int8_bf16io(h, q, qi.EPS)
    yp = qi.resblock_int8_bf16io_plain(h, q)
    d = (yk.float() - yp.float()).abs()
    err = d.max().item()
    over = (d - K1_REL * yp.float().abs()).max().item()
    with fp32_exact():
        f = (yk.float() - gen.res[0](h.float())).abs().max().item()
    print(f"[kernels] K1 resblock_int8_bf16io {shape} bf16: max|kernel-plain|"
          f" {err!r}, max over one ulp {over!r} (tol {K1_ABS}); vs the fp32 "
          f"block {f!r}, {TRUNK_BUDGET} budget "
          f"{'met' if f <= TRUNK_BUDGET else 'missed'}", flush=True)
    check(over <= K1_ABS, f"K1 {shape} within one bf16 ulp + 0.01 of plain")
    return err


def family_launches(counters, want: dict, label: str) -> None:
    """Every launch counter against ``want`` (the counters not named: 0)."""
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[{label}] launches {launches}", flush=True)
    for k, v in launches.items():
        check(v == want.get(k, 0), f"{label}: {want.get(k, 0)} {k} launches")


def family_breakdown(label, gen, qt, int8_fn, x) -> None:
    """Where the time of each engine of a family goes: CUDA-event ms of
    each segment of one generator call on the main path's own
    activations."""
    import torch

    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.ops import quant_int8 as qi

    ins, outs = family_encode(gen, qt, x, qi.multi_atrous_stage_int8)
    qres = qt["res"] if isinstance(qt, dict) else qt
    trunk_in = outs[2].contiguous()
    trunk_out = qi.resblock_chain_int8_bf16io(trunk_in, qres)

    def bf16_trunk():
        h = trunk_in
        for m in gen.res:
            h = m(h)
        return h

    def bf16_up():
        h = trunk_out
        for m, skip in zip(gen.up, reversed(outs)):
            h = m(torch.cat([h, skip], dim=-1))
        return h

    up_bf16, up_int8 = bf16_up(), fi.convt_up(gen, trunk_out, outs)
    stem = (lambda: tnn.relu(tnn.instance_norm(gen.init_conv(x))),) * 2
    def stage_int8(i):
        if isinstance(qt, dict) and fi.stage_kernel_fits(ins[i],
                                                         qt["enc"][i]):
            return qi.multi_atrous_stage_int8(ins[i], qt["enc"][i])
        return gen.down[i](ins[i])

    stages = [(lambda i=i: gen.down[i](ins[i]), lambda i=i: stage_int8(i))
              for i in range(3)]
    trunk = (bf16_trunk, lambda: qi.resblock_chain_int8_bf16io(trunk_in, qres))
    up = (bf16_up, lambda: fi.convt_up(gen, trunk_out, outs))
    head = (lambda: tnn.tanh(gen.out_conv(up_bf16)),
            lambda: fi.convt_head(gen, up_int8))
    names = ("stem", "stage 0", "stage 1", "stage 2", "trunk", "decoder",
             "head")
    segs = (stem, *stages, trunk, up, head)
    for e, engine in enumerate(("bf16", "int8")):
        ms = [cuda_ms(seg[e], 5) for seg in segs]
        print(f"[breakdown] {label} {engine} batch {x.shape[0]} (ms): "
              + "; ".join(f"{k} {t!r}" for k, t in zip(names, ms))
              + f"; sum {sum(ms)!r}", flush=True)


def family_path(dev, images, counters) -> None:
    """Phases 27-30: the other CycleGAN generators' inference."""
    import torch

    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import fused
    from cistar_tpu_torch.ops import quant_int8 as qi

    n, size, nb = FAM["batch"], FAM["size"], FAM["bench_batch"]
    blocks = FAM["blocks"]

    # 27. K1 on the dense 'atrous' trunk, at the checked and timed batch
    gen, qt, _ = family(dev, "atrous_content", True)
    q0 = qt["res"][0]
    x = images(n, size).bfloat16()
    xb = images(nb, size).bfloat16()
    h, hb = (fi.atrous_encode(gen, qt["enc"], v)[-1].contiguous()
             for v in (x, xb))
    check(tuple(h.shape) == (n, 64, 64, 128)
          and tuple(hb.shape) == (nb, 64, 64, 128),
          f"trunk {tuple(h.shape)}, {tuple(hb.shape)}")
    k1_trunk_check(gen, h, q0)
    k1_trunk_check(gen, hb, q0)

    # 28. each family at batch 4, counted
    xf = images(n, size)
    for label, gen_type, dense in FAMILIES:
        gen, qt, int8_fn = family(dev, gen_type, dense)
        for m in counters:
            m.reset_launches()
        y_bf16 = gen(xf.bfloat16()).float()
        y_int8 = int8_fn(gen, qt, xf.bfloat16()).float()
        torch.cuda.synchronize()
        family_launches(counters, {"resblock_int8_bf16io": blocks,
                                   "multi_atrous_stage_int8":
                                   int(gen_type.startswith("atrous"))},
                        f"{label} path")
        with fp32_exact():
            y32 = gen(xf)
        dk = (y_int8 - y32).abs()
        dp = (family_plain_engine(gen, qt, xf.bfloat16()).float()
              - y32).abs()
        (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item())
                              for d in (dk, dp))
        print(f"[{label} path] int8 engine vs fp32: max {mk!r} mean {ak!r}; "
              f"with plain K1 / K6 max {mp!r} mean {ap!r}", flush=True)
        check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
              f"{label} path: kernels add little to the plain error")
        for name, y in (("bf16", y_bf16), ("int8", y_int8)):
            check(tuple(y.shape) == (n, size, size, 1)
                  and bool(torch.isfinite(y).all()),
                  f"{label} {name} output shape/finite")
            d = (y - y32).abs()
            print(f"[{label} path] {name} vs fp32: max {d.max().item()!r} "
                  f"mean {d.mean().item()!r}", flush=True)
        if dense:
            continue
        # the non-dense decoder's head under the K9 switch
        saved = fi._HEAD_KERNEL
        fi._HEAD_KERNEL = "tap_matmul"
        try:
            for m in counters:
                m.reset_launches()
            y_k9 = int8_fn(gen, qt, xf.bfloat16()).float()
            torch.cuda.synchronize()
            family_launches(counters, {"resblock_int8_bf16io": blocks,
                                       "multi_atrous_stage_int8": 1,
                                       "head_cout1": 1},
                            f"{label} path, K9 head")
        finally:
            fi._HEAD_KERNEL = saved
        _, skips = family_encode(gen, qt, xf.bfloat16(),
                                 qi.multi_atrous_stage_int8)
        u = fi.convt_up(gen, qi.resblock_chain_int8_bf16io(skips[-1],
                                                           qt["res"]), skips)
        check(tuple(u.shape) == (n, size, size, FAM["features"]),
              f"K9's input {tuple(u.shape)}")
        wh, bh = gen.out_conv.weight, gen.out_conv.bias
        yk = fused.conv2d_reflect_cout1_loop(u, wh, bh, "tanh")
        yp = fused.conv2d_reflect_cout1_plain(u, wh, bh, "tanh")
        d = (yk.float() - yp.float()).abs()
        over = (d - K9_REL * yp.float().abs()).max().item()
        dh = (y_k9 - y_int8).abs().max().item()
        print(f"[kernels] K9 {tuple(u.shape)} {u.dtype}, tanh: max|kernel-"
              f"plain| {d.max().item()!r}, max over one ulp {over!r} (tol "
              f"{K9_ABS}); the engine with K9 vs the default head, max "
              f"{dh!r}", flush=True)
        check(over <= K9_ABS, "K9 within tolerance of plain")
        check(bool(torch.isfinite(y_k9).all()), "K9 engine output finite")

    # 29. three requests per family, counted: 3 generator calls each
    for label, gen_type, dense in FAMILIES:
        for m in counters:
            m.reset_launches()
        serve(CycleGANInference(gen_type, in_features=FAM["features"],
                                n_residual_blocks=blocks, seed=1,
                                dense_decoder=dense),
              images, n, size, label)
        torch.cuda.synchronize()
        family_launches(counters, {
            "resblock_int8_bf16io": 9 * blocks,
            "multi_atrous_stage_int8": 9 * int(gen_type.startswith("atrous"))},
            f"serve {label}")

    # 30. times at batch 32
    for label, gen_type, dense in FAMILIES:
        gen, qt, int8_fn = family(dev, gen_type, dense)
        for name, fn in (("bf16", lambda: gen(xb)),
                         ("int8", lambda: int8_fn(gen, qt, xb))):
            print_times(f"{label} generator {name}", nb, fn)
        family_breakdown(label, gen, qt, int8_fn, xb)
    for v in (h, hb):
        vq, _ = qi.quantize_act(v)
        ms = cuda_ms(lambda: kr.resblock_int8_bf16io(v, q0, qi.EPS), 20)
        plain_ms = cuda_ms(lambda: qi.resblock_int8_bf16io_plain(v, q0), 5)
        print_block_times("resblock_int8_bf16io", tuple(v.shape), ms, 2,
                          int_mm_ms(vq, q0["w1k"]), plain_ms)


def family_train_path(dev, counters) -> None:
    """Phase 31: train steps of the other generators at 512², then the
    test CLI on their checkpoints."""
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.apps import cyclegan_test
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.engines.cyclegan import CycleGAN
    from cistar_tpu_torch.losses.perceptual import make_content_criterion

    n, size = TRAIN["batch"], TRAIN["size"]
    radar, lidar = synthetic_pairs(n, size)
    a, b = torch.from_numpy(radar).to(dev), torch.from_numpy(lidar).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        synthetic_tool().main(["--out", data, "--n", "4", "--size",
                               str(size)])
        runs = []
        for label, gen_type, dense, content in (
                ("unet", "unet_content", True, False),
                ("unet, content loss", "unet_content", True, True),
                ("atrous", "atrous_content", False, False)):
            eng = CycleGAN(gen_type, in_features=FAM["features"],
                           n_residual_blocks=FAM["blocks"], image_size=size,
                           batch_size=n, pool_size=TRAIN["pool"],
                           dense_decoder=dense, device=dev,
                           cycle_criterion=make_content_criterion()
                           if content else None)
            st = eng.init_state(0)
            for c in counters:
                c.reset_launches()
            st, _ = eng.train_step(st, a, b)          # warm-up
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(FAM_TRAIN_STEPS):
                st, m = eng.train_step(st, a, b)
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1) / FAM_TRAIN_STEPS
            launches = {k: v for c in counters for k, v in c.launches.items()}
            check(not any(launches.values()),
                  f"train step {label}: no kernel launched")
            host = {k: float(v) for k, v in m.items()}
            print(f"[times] train step {label} batch {n} {size}² bf16: {ms!r}"
                  f" ms a step, {n / ms * 1e3!r} img/s; last step {host}",
                  flush=True)
            check(host["skipped"] == 0.0, f"train step {label}: not skipped")
            check(all(np.isfinite(v) for v in host.values()),
                  f"train step {label}: finite losses")
            if not content:
                model_dir = os.path.join(tmp, label)
                os.makedirs(model_dir)
                ckpt.save_cyclegan_state(model_dir, eng)
                runs.append((label, gen_type, dense, model_dir))
            del eng, st
        # the test CLI on the checkpoints: the test split is pair 3 of 4
        for label, gen_type, dense, model_dir in runs:
            for engine in ("default", "int8"):
                t0 = time.perf_counter()
                out = cyclegan_test.main(
                    ["--dataroot", data, "--model_dir", model_dir, "--size",
                     str(size), "--gen_type", gen_type, "--dense_decoder",
                     str(dense), "--engine", engine])
                torch.cuda.synchronize()
                names = sorted(os.listdir(out))
                check(names == ["00003.png", "panel_00003.png"],
                      f"the test CLI wrote {names}")
                print(f"[test cli] {label} {engine}: {names} in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                for f in names:
                    os.remove(os.path.join(out, f))


def tool(name: str):
    """``tools/<name>.py``, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_tool():
    """``tools/make_synthetic_r2l.py``."""
    return tool("make_synthetic_r2l")


def synthetic_pairs(n: int, size: int):
    """``n`` (radar, lidar) frames of the synthetic tool, scenes 0 … n-1,
    NHWC in [-1, 1], as two fp32 numpy arrays."""
    import numpy as np

    pairs = [synthetic_tool().make_pair(i, size) for i in range(n)]
    return tuple((np.stack([p[j] for p in pairs])[..., None] * 2
                  - 1).astype(np.float32) for j in (0, 1))


def copy_train_state(src, src_st, dst, dst_st) -> None:
    """Copy one ``CycleGAN``'s nets, Adam states, pools and epoch into
    another's (on another device), in place."""
    import torch

    with torch.no_grad():
        for a, b in zip(src._nets(), dst._nets()):
            b.load_state_dict(a.state_dict())
        for f in ("opt_g", "opt_d_a", "opt_d_b"):
            a, b = getattr(src_st, f), getattr(dst_st, f)
            for t in ("count", "mu_flat", "nu_flat"):
                getattr(b, t).copy_(getattr(a, t))
        for f in ("pool_a", "pool_b"):
            for a, b in zip(getattr(src_st, f), getattr(dst_st, f)):
                b.copy_(a)
        dst_st.epoch.copy_(src_st.epoch)


def g_grad_sign_flips(engs, sts, a, b) -> tuple:
    """The G loss's gradients of two ``CycleGAN`` engines (on two devices,
    in the same state) on one batch: how many elements differ in sign,
    of how many."""
    import torch

    grads = []
    for e, st in zip(engs, sts):
        params = [*st.g_a2b.values(), *st.g_b2a.values()]
        loss = e._g_losses(a.to(e.device), b.to(e.device))["loss_G"]
        grads.append([g.cpu() for g in torch.autograd.grad(loss, params)])
    flips = sum(int(((x > 0) != (y > 0)).sum()) for x, y in zip(*grads))
    return flips, sum(g.numel() for g in grads[0])


def train_path(dev, counters) -> None:
    """Phases 23-26: the CycleGAN train step, card against CPU, at full
    width counted and timed, and through the training CLI."""
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.apps import cyclegan_train
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.core.convert import generator_from_jax
    from cistar_tpu_torch.engines.cyclegan import CycleGAN

    cfg = dict(gen_type="bilinear_content", in_features=TRAIN["features"],
               n_residual_blocks=TRAIN["blocks"], seed=0)

    # 23. the card's steps against the CPU's, each from the CPU's state
    n, size = TRAIN_CHECK["batch"], TRAIN_CHECK["size"]
    gen = torch.Generator().manual_seed(11)
    frames = [(torch.rand(n, size, size, 1, generator=gen) * 2 - 1,
               torch.rand(n, size, size, 1, generator=gen) * 2 - 1)
              for _ in range(TRAIN_CHECK["steps"])]
    probe = frames[0][0]
    with fp32_exact():
        engs = [CycleGAN(**cfg, image_size=size, batch_size=n,
                         pool_size=TRAIN_CHECK["pool"],
                         compute_dtype=torch.float32, device=d)
                for d in ("cpu", dev)]
        sts = [e.init_state(0) for e in engs]
        flips, n_el = g_grad_sign_flips(engs, sts, *frames[0])
        print(f"[train check] step 0's G gradients: {flips} of {n_el} "
              "elements differ in sign, card vs CPU", flush=True)
        o_cpus = []
        for i, (a, b) in enumerate(frames):
            copy_train_state(engs[0], sts[0], engs[1], sts[1])
            with torch.no_grad():
                before = engs[0].G_a2b(probe)
            outs = []
            for k, e in enumerate(engs):
                sts[k], m = e.train_step(sts[k], a.to(e.device),
                                         b.to(e.device))
                with torch.no_grad():
                    outs.append((e.G_a2b(probe.to(e.device)).cpu(),
                                 {k2: float(v) for k2, v in m.items()}))
            (o_cpu, m_cpu), (o_card, m_card) = outs
            o_cpus.append(o_cpu)
            rel = max(abs(m_card[k] - v) / abs(v) for k, v in m_cpu.items()
                      if v)
            err = (o_card - o_cpu).abs().max().item()
            moved = (o_cpu - before).abs().max().item()
            print(f"[train check] step {i}, bilinear_content "
                  f"{TRAIN['features']} features {TRAIN['blocks']} blocks, "
                  f"{size}², batch {n}, fp32: metrics card vs CPU max rel "
                  f"{rel!r} (tol {TRAIN_RTOL}); G_A2B after the step, "
                  f"max-abs {err!r} (tol {TRAIN_ABS}), moved by the step "
                  f"{moved!r}; CPU {m_cpu}", flush=True)
            check(m_card.keys() == m_cpu.keys(), "the same train metrics")
            check(rel <= TRAIN_RTOL, f"step {i}: train metrics, card within "
                  "rtol of the CPU")
            check(err <= TRAIN_ABS, f"step {i}: G_A2B after the step, card "
                  "vs CPU")
            check(m_card["skipped"] == 0.0, "no check step skipped")
        check(int(sts[1].pool_a.size) == n * TRAIN_CHECK["steps"]
              <= TRAIN_CHECK["pool"],
              "the check stays in the pools' fill phase")
        # for the record: the card's steps free-running, from its own state
        eng = CycleGAN(**cfg, image_size=size, batch_size=n,
                       pool_size=TRAIN_CHECK["pool"],
                       compute_dtype=torch.float32, device=dev)
        st, free = eng.init_state(0), []
        for (a, b), o_cpu in zip(frames, o_cpus):
            st, _ = eng.train_step(st, a.to(dev), b.to(dev))
            with torch.no_grad():
                free.append((eng.G_a2b(probe.to(dev)).cpu() - o_cpu)
                            .abs().max().item())
    print(f"[train check] free-running, G_A2B after each step vs the CPU's,"
          f" max-abs: {free} (not checked)", flush=True)

    # 24. full width, counted: no kernel on the train step
    n, size = TRAIN["batch"], TRAIN["size"]
    radar, lidar = synthetic_pairs(2 * n, size)
    batches = [(torch.from_numpy(radar[i:i + n]).to(dev),
                torch.from_numpy(lidar[i:i + n]).to(dev))
               for i in (0, n)]
    eng = CycleGAN(**cfg, image_size=size, batch_size=n,
                   pool_size=TRAIN["pool"], device=dev)
    st = eng.init_state(0)

    def flat(params):
        return torch.cat([p.detach().reshape(-1) for p in params.values()])

    g0, d0 = flat(st.g_a2b), flat(st.d_a)
    metrics = []

    def step(i):
        nonlocal st
        st, m = eng.train_step(st, *batches[i % 2])
        metrics.append(m)

    for m in counters:
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(TRAIN_STEPS):
        step(i)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    print(f"[train path] launches {launches}", flush=True)
    check(not any(launches.values()), "the train step launches no kernel")
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    print(f"[times] train step bilinear_content batch {n} {size}² bf16: "
          f"{ms!r} ms a step, {n / ms * 1e3!r} img/s; the {TRAIN_WARMUP} "
          f"warm-up steps {first_s!r} s; peak memory {peak} B "
          f"({peak / 2**30!r} GiB); last step {host[-1]}", flush=True)
    check(all(m["skipped"] == 0.0 for m in host), "no full-width step skipped")
    check(all(np.isfinite(v) for m in host for v in m.values()),
          "finite train losses")
    check(not torch.equal(flat(st.g_a2b), g0), "G's params moved")
    check(not torch.equal(flat(st.d_a), d0), "D_A's params moved")
    check(int(st.opt_g.count) == TRAIN_WARMUP + TRAIN_STEPS, "G took every step")

    # 25. no host sync in a step; where its time goes
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[train path] one step under set_sync_debug_mode('error'): no "
          "host sync", flush=True)
    marks = [("start", torch.cuda.Event(enable_timing=True), 0.0)]

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev, time.perf_counter()))

    torch.cuda.synchronize()
    marks[0] = ("start", marks[0][1], time.perf_counter())
    marks[0][1].record()
    st, _ = eng.train_step(st, *batches[0], mark=mark)
    torch.cuda.synchronize()
    for unit, span in (
            ("device", lambda a, b: a[1].elapsed_time(b[1])),
            ("host", lambda a, b: (b[2] - a[2]) * 1e3)):
        parts = {b[0]: span(a, b) for a, b in zip(marks, marks[1:])}
        print(f"[breakdown] train step batch {n}, {unit} ms (CUDA events "
              "between the phases' ends; host: their enqueue): "
              + "; ".join(f"{k} {t!r}" for k, t in parts.items())
              + f"; sum {sum(parts.values())!r}", flush=True)
    wall, busy, top = profile_top(lambda: step(1))
    print(f"[profile] train step batch {n}: wall {wall!r} ms, device busy "
          f"{busy!r} ms; top device time (ms): "
          + "; ".join(f"{k[:48]} {t!r}" for t, k in top), flush=True)

    # 26. the training CLI: one epoch, then --resume
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        t0 = time.perf_counter()
        synthetic_tool().main(["--out", data, "--n", str(CLI_PAIRS),
                               "--size", str(size)])
        args = ["--dataroot", data, "--size", str(size), "--batchSize",
                str(n), "--n_epochs", "1", "--output_dir", out,
                "--log_every", "1", "--device", dev.type]
        t1 = time.perf_counter()
        cyclegan_train.main(args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        run = out + "_bilinear_content"
        for net in ("netG_A2B", "netG_B2A", "netD_A", "netD_B"):
            for name in (f"0_{net}.npz", f"{net}.npz"):
                check(os.path.exists(os.path.join(run, name)),
                      f"the CLI wrote {name}")
        # --resume at the end epoch: the nets load, no step runs
        st = cyclegan_train.main(args + ["--resume", "--epoch", "1"])
        saved = generator_from_jax(ckpt.load_pytree(
            os.path.join(run, "netG_A2B.npz")))
        check(all(torch.equal(st.g_a2b[k].cpu(), v) for k, v in saved.items()),
              "--resume loads the saved G_A2B")
        print(f"[train cli] {CLI_PAIRS} pairs {size}² ({t1 - t0:.1f} s to "
              f"write), one epoch of {CLI_PAIRS // 2 // n} steps at batch {n} "
              f"in {t2 - t1:.1f} s, checkpoints written, --resume loaded",
              flush=True)


def gatys_frames(n: int, size: int):
    """The synthetic tool's radar (content) and lidar (style) frames 0 …
    n-1 as RGB PIL images, as its PNGs hold them."""
    import numpy as np
    from PIL import Image

    tool = synthetic_tool()
    pairs = [tool.make_pair(i, size) for i in range(n)]

    def pil(a):
        return Image.fromarray((a * 255).astype(np.uint8)).convert("RGB")

    return [pil(r) for r, _ in pairs], [pil(li) for _, li in pairs]


def port_kernel_names() -> set:
    """The names of the port's CUDA kernels, read from ``csrc``."""
    import glob

    names = set()
    for path in glob.glob(os.path.join(ROOT, "cistar_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as fh:
            text = fh.read()
        for m in re.finditer(r"__global__", text):
            seg = re.sub(r"__launch_bounds__\([^)]*\)", "",
                         text[m.end():m.end() + 300])
            names.add(re.search(r"(\w+)\s*\(", seg).group(1))
    return names


def gatys_checks(dev, params) -> None:
    """Phase 32: the card against the CPU at 64²."""
    import numpy as np
    import torch

    from cistar_tpu_torch.core.config import get_ist_cfg_defaults
    from cistar_tpu_torch.engines.ist import GatysEngine
    from cistar_tpu_torch.models import vgg
    from cistar_tpu_torch.ops import nn as tnn

    gen = torch.Generator().manual_seed(32)
    x = torch.randint(0, 3, (2, 64, 64, 64), generator=gen).float()
    g = torch.randn(2, 32, 32, 64, generator=gen)
    win = x.reshape(2, 32, 2, 32, 2, 64)
    tied = ((win == win.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4)) > 1)
    for dt in (torch.float32, torch.bfloat16):
        grads = []
        for d in ("cpu", dev):
            xt = x.to(d, dt).requires_grad_(True)
            with torch.enable_grad():
                (gx,) = torch.autograd.grad(tnn.max_pool2d(xt, 2, 2), xt,
                                            g.to(d, dt))
            grads.append(gx.float().cpu())
        check(torch.equal(grads[0], grads[1]),
              f"max-pool ties route as on the CPU, {dt}")
        print(f"[gatys check] max pool (2, 64, 64, 64) {dt}, channels_last, "
              f"{tied.float().mean().item():.3f} of windows tied: the "
              "card's gradient equals the CPU's", flush=True)

    n, size = GATYS["check_batch"], GATYS["check_size"]
    cfg = get_ist_cfg_defaults()
    cfg.DATA.IMG_SIZE = size
    contents, styles = gatys_frames(n, size)
    engs = {d: GatysEngine(cfg, params, device=d,
                           compute_dtype=torch.float32) for d in ("cpu", dev)}
    prep = engs["cpu"].transform.preparation
    c = np.stack([prep(im) for im in contents])          # (3, 1, 64, 64, 3)
    s = np.stack([prep(im) for im in styles])
    keys = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu4_2",
            "relu5_1"]
    with fp32_exact():
        for dt, tol in ((torch.float32, GATYS_FEAT_FP32),
                        (torch.bfloat16, GATYS_FEAT_BF16)):
            cpu, card = (vgg.extract_features(
                params, torch.from_numpy(c[:, 0]).to(d), keys,
                compute_dtype=dt) for d in ("cpu", dev))
            errs = [((b.float().cpu() - a.float()).abs().max()
                     / a.float().abs().max()).item()
                    for a, b in zip(cpu, card)]
            print(f"[gatys check] VGG-19 features ({n}, {size}, {size}, 3) "
                  f"{dt}, card vs CPU, max-abs / max|CPU| by layer "
                  f"{dict(zip(keys, errs))} (tol {tol})", flush=True)
            check(max(errs) <= tol, f"VGG-19 features {dt}, card vs CPU")

    (ci, li, _), (cd, ld, _) = (engs[d].optimize(c[0], s[0], max_iters=1)
                                for d in ("cpu", dev))
    err, rel = (cd.cpu() - ci).abs().max().item(), abs(ld.item() / li.item()
                                                       - 1)
    print(f"[gatys check] optimize fp32 {size}², 1 iteration, card vs CPU: "
          f"image max-abs {err!r}, loss rel {rel!r}", flush=True)
    check(torch.allclose(cd.cpu(), ci, rtol=GATYS_RTOL, atol=GATYS_ATOL)
          and rel <= GATYS_RTOL, "optimize at 1 iteration, card vs CPU")
    gatys_teacher_forced(engs, dev, c[:1], s[:1])

    eng = engs[dev]
    imgs, losses, _ = eng.optimize_batch(c, s, max_iters=1)
    errs = []
    for f in range(n):
        out, loss, _ = eng.optimize(c[f], s[f], max_iters=1)
        check(torch.allclose(imgs[f], out, rtol=GATYS_RTOL, atol=GATYS_ATOL)
              and abs(losses[f].item() - loss.item())
              <= GATYS_RTOL * loss.item(),
              f"optimize_batch frame {f} vs optimize, 1 iteration")
        errs.append((imgs[f] - out).abs().max().item())
    print(f"[gatys check] optimize_batch F = {n} vs {n} optimize calls on "
          f"the card, 1 iteration: image max-abs {errs}", flush=True)


def gatys_teacher_forced(engs, dev, c, s) -> None:
    """Phase 32's 3 iterations: each card iteration from the CPU's state.

    Free-running, the two part at the second iteration: the first step is
    scaled to 1/‖g‖₁ (torch's rule), so the first pair's yᵀs is a
    difference of nearly equal gradients and can fall on either side of
    the 1e-10 store threshold; unstored, the second step is −g at lr 1. So
    each card iteration starts from a copy of the CPU's state (history,
    caches, ring), as phase 23 starts each card train step from the CPU's;
    the free-running losses are printed, not checked."""
    import torch

    from cistar_tpu_torch.ops import lbfgs

    fns = {d: lbfgs.value_and_grad_fn(e.objective(c, s), c.shape)
           for d, e in engs.items()}
    with fp32_exact():
        st = lbfgs.init_state(fns["cpu"], torch.from_numpy(c))
        rows = []
        for _ in range(3):
            card = lbfgs.step(st._replace(**{
                k: v.to(dev) for k, v in st._asdict().items()
                if isinstance(v, torch.Tensor)}), fns[dev])
            st = lbfgs.step(st, fns["cpu"])
            moved = (st.x - card.x.cpu()).abs().max().item()
            rel = abs(card.loss.item() / st.loss.item() - 1)
            close = torch.allclose(card.x.cpu(), st.x, rtol=GATYS_RTOL,
                                   atol=GATYS_ATOL)
            rows.append((moved, rel, int(st.count), bool(card.count.cpu()
                                                         == st.count)))
            print(f"[gatys check] iteration {st.k} from the CPU's state: "
                  f"image max-abs {moved!r} of max|x| "
                  f"{st.x.abs().max().item()!r}, loss rel {rel!r}; pairs "
                  f"stored CPU {int(st.count)}, "
                  f"the same on the card: {rows[-1][3]}", flush=True)
            check(close and rel <= GATYS_RTOL, f"iteration {st.k}: image "
                  "and loss, card vs CPU from the same state")
    free = {str(d): e.optimize(c[0], s[0], max_iters=3)[2].tolist()
            for d, e in engs.items()}
    print(f"[gatys check] free-running, 3 iterations, losses: {free} "
          "(not checked)", flush=True)


def gatys_timed(dev, params, counters) -> float:
    """Phase 33: 512², batch 1, timed; returns s a frame of
    ``transfer_style``."""
    import numpy as np
    import torch

    from cistar_tpu_torch.core.config import get_ist_cfg_defaults
    from cistar_tpu_torch.data.transforms import GatysImageTransform
    from cistar_tpu_torch.engines.ist import GatysEngine

    cfg = get_ist_cfg_defaults()
    size, iters = GATYS["size"], GATYS["iters"]
    check(cfg.DATA.IMG_SIZE == size and cfg.LOSS.MAX_ITER == iters,
          "the default config")
    contents, styles = gatys_frames(1, size)
    eng = GatysEngine(cfg, params, device=dev)
    c = torch.from_numpy(eng.transform.preparation(contents[0])).to(dev)
    s = torch.from_numpy(eng.transform.preparation(styles[0])).to(dev)
    hr = GATYS["hr_size"]
    hr_t = GatysImageTransform(hr, cfg.DATA.IMAGENET_MEAN)
    hr_c, hr_s = (torch.from_numpy(hr_t.preparation(im)).to(dev)
                  for im in (contents[0], styles[0]))
    for m in counters:
        m.reset_launches()
    ms_iter = {}
    for label, e, x, n in (
            (f"{size}² bf16", eng, (c, s), iters),
            (f"{size}² fp32", GatysEngine(cfg, params, device=dev,
                                          compute_dtype=torch.float32),
             (c, s), iters),
            (f"{size}² bf16, bf16 history", GatysEngine(
                cfg, params, device=dev, history_dtype=torch.bfloat16),
             (c, s), iters),
            (f"{hr}² bf16 (the HR pass)", eng, (hr_c, hr_s),
             GATYS["hr_iters"]),
            (f"{size}² bf16 under set_sync_debug_mode('error')", eng, (c, s),
             iters)):
        e.optimize(*x, max_iters=2)                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        if "sync" in label:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, loss, losses = e.optimize(*x, max_iters=n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - t0
        ms_iter[label] = e0.elapsed_time(e1) / n
        first, last = losses[0].item(), losses[-1].item()
        print(f"[times] gatys {label}: {ms_iter[label]!r} ms an "
              f"iteration (CUDA events over {n}, targets and the first "
              f"evaluation included), {wall!r} s wall; loss {first!r} -> "
              f"{last!r}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB", flush=True)
        check(np.isfinite(last) and last < first,
              f"gatys {label}: the final loss finite and below the first")
        check(out.shape == x[0].shape, "the image's shape")
    print(f"[gatys] {iters} iterations under set_sync_debug_mode('error'): "
          "no host sync", flush=True)
    launches = {k: v for m in counters for k, v in m.launches.items()}
    check(not any(launches.values()), "the Gatys path launches no kernel")

    gatys_report(f"{size}² bf16", ms_iter[f"{size}² bf16"],
                 lambda n, mark=None: eng.optimize(c, s, max_iters=n,
                                                   mark=mark))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = eng.transfer_style(contents[0], styles[0])
    frame_s = time.perf_counter() - t0
    print(f"[times] gatys transfer_style {size}², {iters} iterations, bf16: "
          f"{frame_s!r} s a frame ({img.size}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB", flush=True)
    return frame_s


def gatys_report(label: str, ms_iter: float, run) -> None:
    """Where an iteration of ``run(max_iters, mark=None)`` goes: a
    ``[breakdown]`` of the last of three by phase (device and host ms), and
    a ``[profile]`` of 20 (device busy against ``ms_iter``, the unprofiled
    ms an iteration; launches an iteration; top kernels). Fails if the
    device ran nothing or ran one of the port's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    run(3, mark)
    torch.cuda.synchronize()
    last = marks[-5:]
    for unit, span in (
            ("device", lambda a, b: a[1].elapsed_time(b[1])),
            ("host", lambda a, b: (b[2] - a[2]) * 1e3)):
        parts = {b[0]: span(a, b) for a, b in zip(last, last[1:])}
        print(f"[breakdown] gatys {label}, one iteration, {unit} ms: "
              + "; ".join(f"{k} {t!r}" for k, t in parts.items())
              + f"; sum {sum(parts.values())!r}", flush=True)

    n = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] gatys {label}, {n} iterations: device busy {busy!r} ms"
          f" ({busy / n!r} an iteration, {busy / n / ms_iter!r} of the "
          f"unprofiled {ms_iter!r} ms an iteration; wall under the profiler "
          f"{wall!r} ms), {sum(r[1] for r in rows) / n!r} kernel launches an"
          " iteration; top device time (ms, launches): "
          + "; ".join(f"{k[:64]} {t!r} {c}" for t, c, k in rows[:12]),
          flush=True)
    check(busy > 0, "the Gatys iterations ran on the device")
    names = port_kernel_names()
    ours = [k for _, _, k in rows for name in names
            if re.search(rf"\b{name}\b", k)]
    check(not ours, f"no port kernel in the Gatys profile: {ours}")


def gatys_sweep(dev, params, frame_s: float) -> None:
    """Phase 34: ``transfer_style_batch`` at F = 4, 512²."""
    import numpy as np
    import torch

    from cistar_tpu_torch.core.config import get_ist_cfg_defaults
    from cistar_tpu_torch.engines.ist import GatysEngine

    f = GATYS["batch"]
    eng = GatysEngine(get_ist_cfg_defaults(), params, device=dev)
    contents, styles = gatys_frames(f, GATYS["size"])
    eng.transfer_style_batch(contents, styles[0], max_iters=2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.transfer_style_batch(contents, styles[0])
    dt = time.perf_counter() - t0
    check(len(outs) == f and all(o.size == (GATYS["size"],) * 2
                                 for o in outs), "F outputs of 512²")
    check(all(np.asarray(o).std() > 0 for o in outs), "non-constant outputs")
    print(f"[times] gatys transfer_style_batch F = {f}, {GATYS['size']}², "
          f"{GATYS['iters']} iterations, bf16: {dt!r} s, {f / dt!r} frames/s "
          f"against {1 / frame_s!r} frames/s one at a time; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB", flush=True)
    prep = eng.transform.preparation
    c = torch.from_numpy(np.stack([prep(im) for im in contents])).to(dev)
    s = torch.from_numpy(np.stack([prep(styles[0])] * f)).to(dev)
    gatys_report(f"F = {f} {GATYS['size']}² bf16", dt / GATYS["iters"] * 1e3,
                 lambda n, mark=None: eng.optimize_batch(c, s, max_iters=n,
                                                         mark=mark))


def gatys_cli() -> None:
    """Phase 35: the IST CLI on 4 synthetic frames, polar, HR at 1024²."""
    import tempfile

    from PIL import Image

    n = GATYS["cli_frames"]
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        synthetic_tool().main(["--out", data, "--n", str(n), "--size",
                               str(GATYS["size"])])
        cmd = [sys.executable, "-m", "cistar_tpu_torch.apps.ist_main",
               "--content-dir", os.path.join(data, "radar"),
               "--style-image", os.path.join(data, "lidar", "00000.png"),
               "--save-dir", out, "--polar", "--hr",
               "HRDATA.IMG_SIZE", str(GATYS["hr_size"])]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900)
        dt = time.perf_counter() - t0
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        check(proc.returncode == 0, "the IST CLI ran")
        names = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        check(names == [f"{i:05d}.png" for i in range(n)],
              f"the IST CLI wrote {names}")
        hr = GATYS["hr_size"]
        for f in names:
            with Image.open(os.path.join(out, f)) as im:
                check(im.size == (hr, hr) and im.mode == "RGB",
                      f"{f}: {im.size} {im.mode}")
        with open(os.path.join(out, "log.txt")) as fh:
            lines = [li.strip() for li in fh if "s/frame" in li
                     or "avg seconds" in li]
        check(len(lines) == n + 1, "s/frame in the CLI's log")
        print(f"[gatys cli] {n} frames {GATYS['size']}² --polar --hr "
              f"HRDATA.IMG_SIZE {hr} (300 + 500 iterations, bf16): {names} "
              f"of {hr}² in {dt:.1f} s; log: " + " | ".join(
                  li.split(": ", 1)[-1] for li in lines), flush=True)


def gatys_path(dev, counters) -> None:
    """Phases 32-35: the Gatys IST path."""
    from cistar_tpu_torch.models import vgg

    params = vgg.init_vgg_params(seed=0)
    gatys_checks(dev, params)
    frame_s = gatys_timed(dev, params, counters)
    gatys_sweep(dev, params, frame_s)
    gatys_cli()


def copy_p2p_state(src, src_st, dst, dst_st) -> None:
    """Copy one ``Pix2PixHD``'s nets (BatchNorm statistics included), Adam
    states and epoch into another's (on another device), in place."""
    import torch

    with torch.no_grad():
        for a, b in ((src.G, dst.G), (src.D, dst.D), (src.E, dst.E)):
            if a is not None:
                b.load_state_dict(a.state_dict())
        for f in ("opt_g", "opt_d", "opt_e"):
            a, b = getattr(src_st, f), getattr(dst_st, f)
            if a is not None:
                for t in ("count", "mu_flat", "nu_flat"):
                    getattr(b, t).copy_(getattr(a, t))
        dst_st.epoch.copy_(src_st.epoch)


def p2p_served(eng, label, inst, image):
    """G's output on a batch after a step: through netE's features when it
    trains one, else ``infer_step`` (eval mode: BatchNorm's running
    statistics)."""
    if eng.gen_features:
        return eng.infer_encoded(label, inst, image).cpu()
    return eng.infer_step(label, inst).cpu()


@contextlib.contextmanager
def same_kinks(masks: list, flips: list = None):
    """Phase 36's activation patterns. With ``flips`` None (the card),
    record in call order into ``masks`` the side of its kink that each
    ReLU and LeakyReLU of the port's models (``ops/nn.py``) takes, and the
    element that each max pool window picks; else (the CPU) replay them,
    and append to ``flips`` the count of those that differ from the CPU's
    own and the largest distance from the kink among them (an activation's
    |input|, a window's gap to its own max). Where an input lies within
    the two devices' rounding of a kink they may take opposite sides, and
    one such activation moves a gradient at 64² by up to 1e-2 of its
    largest; replayed, the two backwards differ by rounding alone."""
    import torch
    import torch.nn.functional as F

    from cistar_tpu_torch.ops import nn as tnn

    relu, leaky, pool = tnn.relu, tnn.leaky_relu, tnn.max_pool2d
    replay = iter(masks)

    def side(own, x):
        if flips is None:
            masks.append(own.cpu())
            return None
        m = next(replay).to(x.device)
        off = m != own
        flips.append((int(off.sum()),
                      float(x.detach()[off].abs().max()) if off.any()
                      else 0.0))
        return m

    def relu_(x):
        m = side(x.detach() > 0, x)
        return relu(x) if m is None else x * m

    def leaky_(x, negative_slope=0.2):
        m = side(x.detach() >= 0, x)
        return (leaky(x, negative_slope) if m is None
                else torch.where(m, x, x * negative_slope))

    def pool_(x, kernel, stride=None, padding=0):
        xc = x.permute(0, 3, 1, 2)
        top, own = F.max_pool2d(xc.detach(), kernel, stride or kernel,
                                padding, return_indices=True)
        if flips is None:
            masks.append(own.cpu())
            return pool(x, kernel, stride, padding)
        m = next(replay).to(x.device)
        out = xc.flatten(2).gather(2, m.flatten(2)).view_as(top)
        off = m != own
        flips.append((int(off.sum()),
                      float((top - out.detach())[off].max()) if off.any()
                      else 0.0))
        return out.permute(0, 2, 3, 1)

    tnn.relu, tnn.leaky_relu, tnn.max_pool2d = relu_, leaky_, pool_
    try:
        yield
    finally:
        tnn.relu, tnn.leaky_relu, tnn.max_pool2d = relu, leaky, pool


def p2p_backward_check(engs, label, inst, image, gen) -> tuple:
    """G's, netE's and D's backward on the card against the CPU's, from the
    same state and inputs and with the card's activation patterns
    (:func:`same_kinks`), each net's max-abs error over its largest
    gradient: G and netE through G's output in train mode, against a fixed
    cotangent; D through the D step's loss on the CPU's fake. G's
    BatchNorm statistics are put back after its forward. Also returns the
    activations replayed on the other side (count, largest distance from
    the kink)."""
    import torch

    from cistar_tpu_torch.losses.gan import gan_loss

    cot = torch.randn(*label.shape[:3], engs[0].output_nc, generator=gen)
    cpu, card = engs

    def d_grad(e, fake):
        il = e.encode_input(label.to(e.device),
                            None if inst is None else inst.to(e.device))
        x = torch.cat([torch.cat([il, fake.to(e.device)], -1),
                       torch.cat([il, image.to(e.device)], -1)])
        both = e._d(x)
        nb = label.shape[0]
        loss_d = (gan_loss([[t[:nb] for t in sc] for sc in both], False,
                           e.use_lsgan)
                  + gan_loss([[t[nb:] for t in sc] for sc in both], True,
                             e.use_lsgan)) * 0.5
        return flat(torch.autograd.grad(loss_d, list(e.D.parameters())))

    def flat(gs):
        return torch.cat([g.reshape(-1).cpu() for g in gs])

    def g_grads(e):
        dev_ = e.device
        lab, img = label.to(dev_), image.to(dev_)
        ins = None if inst is None else inst.to(dev_)
        il = e.encode_input(lab, ins)
        saved = {k: v.clone() for k, v in e.G.named_buffers()}
        e.G.train()
        try:
            fake = e.G(e._g_input(il, lab, ins, img, None).to(e.cdt))
        finally:
            e.G.eval()
        with torch.no_grad():
            for k, v in e.G.named_buffers():
                v.copy_(saved[k])
        nets = [("G", e.G)] + ([("E", e.E)] if e.gen_features else [])
        gs = torch.autograd.grad(
            fake.float(), [p for _, net in nets for p in net.parameters()],
            cot.to(dev_))
        out, o = {}, 0
        for name, net in nets:
            k = sum(1 for _ in net.parameters())
            out[name] = flat(gs[o:o + k])
            o += k
        return out, fake.detach().float().cpu()

    masks_g, masks_d, flips = [], [], []
    with torch.enable_grad():
        with same_kinks(masks_g):
            g_card, _ = g_grads(card)
        with same_kinks(masks_g, flips):
            g_cpu, fake = g_grads(cpu)
        with same_kinks(masks_d):
            g_card["D"] = d_grad(card, fake)
        with same_kinks(masks_d, flips):
            g_cpu["D"] = d_grad(cpu, fake)
    return ({k: ((g_card[k] - v).abs().max() / v.abs().max()).item()
             for k, v in g_cpu.items()},
            (sum(n for n, _ in flips), max(x for _, x in flips)))


def p2p_train_check(dev, runs=P2P_CHECK_RUNS) -> None:
    """Phase 36 (and phase 41's ``runs``): the card's train step against
    the CPU's, each card step from the CPU's state."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.losses.perceptual import make_vgg_loss

    n, size = P2P_CHECK["batch"], P2P_CHECK["size"]
    for label_, family_, steps, vgg in runs:
        gen = torch.Generator().manual_seed(14)   # the same frames in each
        cfg = dict(P2P_CHECK_CFG[family_], ndf=8, num_d=2, n_layers_d=3,
                   image_size=size, compute_dtype=torch.float32, seed=0)
        with fp32_exact():
            engs = [Pix2PixHD(family_, device=d, vgg_criterion=(
                        make_vgg_loss(compute_dtype=torch.float32)
                        if vgg else None), **cfg)
                    for d in ("cpu", dev)]
            sts = [e.init_state(0) for e in engs]
            for i in range(steps):
                label = torch.rand(n, size, size, 1, generator=gen) * 2 - 1
                image = torch.rand(n, size, size, 1, generator=gen) * 2 - 1
                inst = (torch.randint(0, 6, (n, size, size, 1),
                                      generator=gen).float()
                        if engs[0].gen_features else None)
                copy_p2p_state(engs[0], sts[0], engs[1], sts[1])
                bwd, bwd_kinks = p2p_backward_check(
                    engs, label, inst, image, gen)
                before = p2p_served(engs[0], label, inst, image)
                # the card's step first: the CPU's replays its activation
                # patterns
                outs, masks, kinks = [None, None], [], []
                for k in (1, 0):
                    e = engs[k]
                    args = [t if t is None else t.to(e.device)
                            for t in (label, inst, image)]
                    with same_kinks(masks, kinks if k == 0 else None):
                        sts[k], m, fake = e.train_step(sts[k], *args)
                    outs[k] = (p2p_served(e, *args),
                               {k2: float(v) for k2, v in m.items()},
                               {k2: v.cpu() for k2, v in
                                (sts[k].g_stats or {}).items()},
                               fake.cpu())
                step_kinks = (sum(n for n, _ in kinks),
                              max(x for _, x in kinks))
                (o_cpu, m_cpu, s_cpu, f_cpu), (o_card, m_card, s_card,
                                               f_card) = outs
                rel = max(abs(m_card[k] - v) / abs(v)
                          for k, v in m_cpu.items() if v)
                f_err = (f_card - f_cpu).abs().max().item()
                mu_rel = {}
                for net in ("opt_g", "opt_d", "opt_e"):
                    a, b = getattr(sts[0], net), getattr(sts[1], net)
                    if a is not None:
                        mu_rel[net[-1].upper()] = (
                            (b.mu_flat.cpu() - a.mu_flat).abs().max()
                            / a.mu_flat.abs().max()).item()
                err = (o_card - o_cpu).abs().max().item()
                s_err = max(((s_card[k] - v).abs().max().item()
                             for k, v in s_cpu.items()), default=0.0)
                moved = (o_cpu - before).abs().max().item()
                # the weights whose Adam update took the other sign on the
                # card get the CPU's values
                flips = 0
                with torch.no_grad():
                    for a, b in ((engs[0].G, engs[1].G),
                                 (engs[0].E, engs[1].E)):
                        if a is None:
                            continue
                        for p, q in zip(a.parameters(), b.parameters()):
                            off = (q.cpu() - p).abs() > engs[0].lr / 2
                            flips += int(off.sum())
                            q.copy_(torch.where(off.to(q.device),
                                                p.to(q.device), q))
                err_fixed = (p2p_served(engs[1], *[
                    t if t is None else t.to(dev)
                    for t in (label, inst, image)]) - o_cpu).abs().max() \
                    .item()
                print(f"[p2phd train check] {label_} step {i}, {size}², "
                      f"batch {n}, fp32: metrics card vs CPU max rel "
                      f"{rel!r} (tol {TRAIN_RTOL}); backward from the "
                      f"same state and inputs (max-abs over the net's "
                      f"largest gradient) {bwd} (tol {TRAIN_RTOL}), with "
                      f"the card's activation patterns, {bwd_kinks[0]} "
                      f"of them on the other side at CPU inputs up to "
                      f"{bwd_kinks[1]!r} (tol {TRAIN_ABS}); the step with "
                      f"the card's "
                      f"activation patterns, {step_kinks[0]} on the other "
                      f"side at CPU inputs up to {step_kinks[1]!r}: Adam "
                      f"first moments {mu_rel} (tol {TRAIN_RTOL}); "
                      f"G's output in the step max-abs "
                      f"{f_err!r}; after the step {err!r}, with the CPU's "
                      f"values at the {flips} weights whose update took "
                      f"the other sign {err_fixed!r} (tol {TRAIN_ABS}), "
                      f"moved by the step {moved!r}; BatchNorm running "
                      f"statistics max-abs {s_err!r}; CPU {m_cpu}",
                      flush=True)
                check(m_card.keys() == m_cpu.keys(), "the same train metrics")
                check(rel <= TRAIN_RTOL, f"{label_} step {i}: train "
                      "metrics, card within rtol of the CPU")
                for net, r in bwd.items():
                    check(r <= TRAIN_RTOL, f"{label_} step {i}: {net}'s "
                          "backward, card vs CPU")
                for what, (_, x) in (("backward", bwd_kinks),
                                     ("step", step_kinks)):
                    check(x <= TRAIN_ABS, f"{label_} step {i}: the {what}'s "
                          "activations on the other side lie within "
                          "rounding of their kink")
                for net, r in mu_rel.items():
                    check(r <= TRAIN_RTOL, f"{label_} step {i}: {net}'s "
                          "Adam first moment, card vs CPU")
                check(f_err <= TRAIN_ABS, f"{label_} step {i}: G's output "
                      "in the step, card vs CPU")
                check(err_fixed <= TRAIN_ABS, f"{label_} step {i}: G's "
                      "output after the step, card vs CPU")
                check(err <= TRAIN_ABS, f"{label_} step {i}: G's output "
                      "after the step, as stepped")
                check(s_err <= TRAIN_ABS, f"{label_} step {i}: running "
                      "statistics, card vs CPU")
                check(m_cpu["G_GAN_Feat"] > 0, "feature matching on")
                check((m_cpu["G_VGG"] > 0) == vgg, "the VGG19 loss on")
                if family_ == "global":
                    check(set(mu_rel) == set(bwd) == {"G", "D", "E"},
                          "netE trains")
            if family_ == "multiscale":
                check(len(s_cpu) > 0, "multiscale has running statistics")


def p2p_timed(dev, counters, family_: str):
    """Phase 37 for one configuration: the engine, its state and a
    step function, after the timed steps."""
    import numpy as np
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.losses.perceptual import make_vgg_loss

    n, size = P2P_TRAIN_BATCH, P2P_TRAIN_COMMON["image_size"]
    radar, lidar = synthetic_pairs(2 * n, size)
    batches = [(torch.from_numpy(radar[i:i + n]).to(dev),
                torch.from_numpy(lidar[i:i + n]).to(dev)) for i in (0, n)]
    eng = Pix2PixHD(family_, device=dev, seed=0, vgg_criterion=(
        make_vgg_loss() if family_ == "global" else None),
        **P2P_TRAIN[family_], **P2P_TRAIN_COMMON)
    st = eng.init_state(0)

    def flat(params):
        return torch.cat([p.detach().reshape(-1) for p in params.values()])

    g0, d0 = flat(st.g), flat(st.d)
    metrics = []

    def step(i, mark=None):
        nonlocal st
        lab, img = batches[i % 2]
        st, m, _ = eng.train_step(st, lab, None, img, mark=mark)
        metrics.append(m)

    for m in counters:
        m.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(P2P_TRAIN_STEPS + 1)]
    evs[0].record()
    for i in range(P2P_TRAIN_STEPS):
        step(i)
        evs[i + 1].record()
    evs[-1].synchronize()
    ms = evs[0].elapsed_time(evs[-1]) / P2P_TRAIN_STEPS
    each = sorted(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    label = (f"p2phd train step {family_} ngf 64"
             + (" + VGG19 loss" if family_ == "global" else " (r2l_MSRB_7)"))
    print(f"[p2phd train path] {family_}: launches {launches}", flush=True)
    check(not any(launches.values()), f"the {family_} train step launches "
          "no kernel")
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    print(f"[times] {label} batch {n} {size}² bf16: {ms!r} ms a step "
          f"(the mean of {P2P_TRAIN_STEPS}; each step min {each[0]!r}, "
          f"median {each[len(each) // 2]!r}, max {each[-1]!r}), "
          f"{n / ms * 1e3!r} img/s; the {TRAIN_WARMUP} warm-up steps "
          f"{first_s!r} s; peak memory {peak} B ({peak / 2**30!r} GiB); "
          f"last step {host[-1]}", flush=True)
    check(all(np.isfinite(v) for m in host for v in m.values()),
          "finite train losses")
    check(all(m["G_GAN_Feat"] > 0 for m in host), "G_GAN_Feat > 0")
    if family_ == "global":
        check(all(m["G_VGG"] > 0 for m in host), "G_VGG > 0")
    check(not torch.equal(flat(st.g), g0), "G's params moved")
    check(not torch.equal(flat(st.d), d0), "D's params moved")
    check(int(st.opt_g.count) == TRAIN_WARMUP + P2P_TRAIN_STEPS,
          "G took every step")
    return step


def p2p_breakdown(step, label: str, name: str = "p2phd train step"
                  ) -> None:
    """Phase 38 (and 43) for one configuration: no host sync in a step;
    where its time goes."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[{name}] one {label} step under "
          "set_sync_debug_mode('error'): no host sync", flush=True)
    marks = [("start", torch.cuda.Event(enable_timing=True), 0.0)]

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev, time.perf_counter()))

    torch.cuda.synchronize()
    marks[0] = ("start", marks[0][1], time.perf_counter())
    marks[0][1].record()
    step(1, mark)
    torch.cuda.synchronize()
    for unit, span in (
            ("device", lambda a, b: a[1].elapsed_time(b[1])),
            ("host", lambda a, b: (b[2] - a[2]) * 1e3)):
        parts = {b[0]: span(a, b) for a, b in zip(marks, marks[1:])}
        print(f"[breakdown] {name} {label} batch "
              f"{P2P_TRAIN_BATCH}, {unit} ms (CUDA events between the "
              "phases' ends; host: their enqueue): "
              + "; ".join(f"{k} {t!r}" for k, t in parts.items())
              + f"; sum {sum(parts.values())!r}", flush=True)
    wall, busy, top = profile_top(lambda: step(0))
    print(f"[profile] {name} {label} batch {P2P_TRAIN_BATCH}: "
          f"wall {wall!r} ms, device busy {busy!r} ms; top device time (ms): "
          + "; ".join(f"{k[:60]} {t!r}" for t, k in top), flush=True)


def p2p_cli(dev, counters) -> None:
    """Phases 39-40: the training CLI at the shipped recipe, a resume, and
    the test CLI on its checkpoint at --data_type 32 and 8."""
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.apps import p2phd_test, p2phd_train
    from cistar_tpu_torch.apps.p2phd_options import TestOptions
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.core.convert import unet_generator_hd_from_jax
    from cistar_tpu_torch.data.datasets import Radar2LidarDataset
    from cistar_tpu_torch.kernels import int8_msrb as km
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.ops import quant_int8 as qi

    opt_txt = os.path.join(ROOT, "checkpoints", "r2l_MSRB_7", "opt.txt")
    size = P2P_TRAIN_COMMON["image_size"]
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        synthetic_tool().main(["--out", data, "--n", str(P2P_CLI_PAIRS),
                               "--size", str(size)])
        base = ["--load_opt", opt_txt, "--dataroot", data,
                "--checkpoints_dir", ck, "--device", dev.type]
        args = base + ["--niter", "1", "--niter_decay", "0",
                       "--print_freq", "4"]
        # 39. one epoch of the shipped recipe, then --continue_train
        t0 = time.perf_counter()
        p2phd_train.main(args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run = os.path.join(ck, "r2l_MSRB_7")
        for name in ("latest_net_G.npz", "latest_net_D.npz", "iter.txt"):
            check(os.path.exists(os.path.join(run, name)),
                  f"the CLI wrote {name}")
        check(ckpt.load_iter(run) == (2, 0), "iter.txt says epoch 2")
        saved = ckpt.load_pytree(os.path.join(run, "latest_net_G.npz"))
        # at the last epoch: the nets load, no step runs
        st = p2phd_train.main(args + ["--continue_train"])
        want = unet_generator_hd_from_jax(saved)
        check(all(torch.equal(st.g[k].cpu(), v) for k, v in want.items()),
              "--continue_train loads the saved G")
        n_train = int(P2P_CLI_PAIRS * 0.7)
        print(f"[p2phd train cli] {P2P_CLI_PAIRS} pairs {size}², one epoch "
              f"of {n_train} steps at batch 1 in {t1 - t0:.1f} s (set-up "
              "included); latest G, D, iter.txt written; --continue_train "
              "resumed at epoch 2 from them", flush=True)

        # 40. the test CLI on that checkpoint, fp32 and int8
        test_args = base + ["--results_dir", os.path.join(tmp, "res"),
                            "--phase", "test", "--how_many",
                            str(P2P_TEST_PAIRS)]
        for data_type in (32, 8):
            for m in counters:
                m.reset_launches()
            t0 = time.perf_counter()
            web = p2phd_test.main(test_args + ["--data_type", str(data_type)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for m in counters
                        for k, v in m.launches.items()}
            # 4 K8 an MSRB block, 3 blocks: 12 a generator call
            want = ({"msrb_branch_int8": 4 * P2P_TRAIN["UNet"][
                "n_blocks_global"] * P2P_TEST_PAIRS} if data_type == 8 else {})
            print(f"[p2phd test cli] --data_type {data_type}: launches "
                  f"{launches}; {P2P_TEST_PAIRS} frames in {dt:.1f} s",
                  flush=True)
            check(all(launches[k] == want.get(k, 0) for k in launches),
                  f"--data_type {data_type} launches {want} and no other "
                  "kernel")
            pngs = os.listdir(os.path.join(web, "images"))
            check(len(pngs) == 3 * P2P_TEST_PAIRS,
                  f"the test CLI wrote {3 * P2P_TEST_PAIRS} PNGs")
            check(open(os.path.join(web, "index.html")).read().count("<img")
                  == 3 * P2P_TEST_PAIRS, "the gallery lists them")
        # the int8 engine on those frames, held as phase 12 holds it
        opt = TestOptions().parse(test_args + ["--data_type", "8"],
                                  save=False)
        eng = p2phd_test.load_engine(opt)
        gen, qb = eng.G, eng.quantize_generator()
        ds = Radar2LidarDataset(data, size=size, mode="test")
        x = torch.from_numpy(np.stack([ds[i]["label"] for i in
                                       range(P2P_TEST_PAIRS)])).to(dev)
        xb = x.bfloat16()
        y8 = eng.infer_step_int8(qb, x)
        skips = fi.unet_encode(gen, xb)
        h = skips[-1]
        for q in qb:
            h = qi.msrb_block_int8_plain(h, q, K8_TILE)
        yp = fi.unet_decode(gen, h, skips).float()
        with fp32_exact():
            y32 = gen(x)
        dk, dp = (y8 - y32).abs(), (yp - y32).abs()
        (mk, ak), (mp, ap) = ((d.max().item(), d.mean().item())
                              for d in (dk, dp))
        print(f"[p2phd test cli] int8 engine on the checkpoint vs fp32, "
              f"{P2P_TEST_PAIRS} test frames: max {mk!r} mean {ak!r}; with "
              f"the plain K8 max {mp!r} mean {ap!r}", flush=True)
        check(ak <= KERNEL_MEAN_RATIO * ap and mk <= mp + KERNEL_MAX_EXCESS,
              "the CLI's int8 engine: K8 adds little to the plain error")

        # K8 at batch 1, the CLI's batch, on the checkpoint's activations
        h1 = fi.unet_encode(gen, xb[:1])[-1].contiguous()
        xq, xs = qi.quantize_act(h1)
        q0 = qb[0]
        cat, sc, _ = k8_vs_plain(xq, xs, q0)
        tot = dict.fromkeys(("ms", "plain", "bound", "lib"), 0.0)
        for st_, xin, xsc in (("a", xq, xs), ("b", cat, sc)):
            qo = st_ == "a"
            sb = q0["sb1" if qo else "sb2"]
            odt = None if qo else torch.bfloat16
            for row, kk in ((0, 3), (1, 5)):
                wk, wq = q0[f"w{kk}{st_}k"], q0[f"w{kk}{st_}"]
                ms = cuda_ms(lambda: km.msrb_branch_int8(
                    xin, xsc, wk, sb, row, kk, K8_TILE, qo, odt), 20)
                plain_ms = cuda_ms(lambda: qi.msrb_branch_plain(
                    xin, xsc, wq, sb, row, kk, K8_TILE, qo, odt), 5)
                bnd, by = k8_bound_ms(*xin.shape, wk.shape[0], kk, qo)
                lib_ms = gemm_ms(im2col_zero(xin, kk), wk)
                for k, v in (("ms", ms), ("plain", plain_ms),
                             ("bound", bnd), ("lib", lib_ms)):
                    tot[k] += v
                print(f"[times] msrb_branch_int8 stage {st_} {kk}x{kk} "
                      f"{tuple(xin.shape)}: {ms!r} ms, bound {bnd!r} ms "
                      f"({by}), plain {plain_ms!r} ms, GEMM yardstick "
                      f"{lib_ms!r} ms", flush=True)
        print(f"[times] msrb_branch_int8 at batch 1 (the test CLI's), per "
              f"launch (the mean of one block's four): {tot['ms'] / 4!r} ms, "
              f"bound {tot['bound'] / 4!r} ms, plain {tot['plain'] / 4!r} "
              f"ms, GEMM yardstick (torch._int_mm of the conv's im2col) "
              f"{tot['lib'] / 4!r} ms", flush=True)


def p2phd_train_path(dev, counters) -> None:
    """Phases 36-40: the pix2pixHD train step, card against CPU, at full
    width counted and timed, and the two CLIs."""
    p2p_train_check(dev)
    p2p_breakdown(p2p_timed(dev, counters, "UNet"), "r2l_MSRB_7")
    p2p_breakdown(p2p_timed(dev, counters, "global"), "global + VGG19")
    p2p_cli(dev, counters)


def ext_steps(engs, step) -> tuple:
    """One step of the card's engine, then the CPU's with the card's
    activation patterns replayed (:func:`same_kinks`): ``step(k)`` runs
    engine k's and returns (metrics, {name: output}); per device the host
    metrics and the outputs on the CPU, and the activations the CPU took
    on the other side (count, largest distance from the kink)."""
    masks, kinks, res = [], [], [None, None]
    for k in (1, 0):
        with same_kinks(masks, kinks if k == 0 else None):
            m, outs = step(k)
        res[k] = ({n: float(v) for n, v in m.items()},
                  {n: v.detach().float().cpu() for n, v in outs.items()})
    return res, (sum(n for n, _ in kinks), max((x for _, x in kinks),
                                                default=0.0))


def ext_hold(label: str, res, kinks, moments: dict, extra: dict) -> None:
    """Phase 41's checks of one step: the metrics (TRAIN_RTOL relative),
    each net's Adam first moment (its max-abs error over its largest
    |value|, TRAIN_RTOL: after one step from zero moments, (1 − b1)·∇, the
    net's backward), the step's outputs and ``extra`` max-abs errors
    (TRAIN_ABS), and the kinks taken otherwise (within TRAIN_ABS)."""
    (m_cpu, o_cpu), (m_card, o_card) = res
    rel = max(abs(m_card[k] - v) / abs(v) for k, v in m_cpu.items() if v)
    mu = {k: ((b.mu_flat.cpu() - a.mu_flat).abs().max()
              / a.mu_flat.abs().max()).item()
          for k, (a, b) in moments.items() if a.mu_flat.abs().max() > 0}
    out = {k: (o_card[k] - v).abs().max().item() for k, v in o_cpu.items()}
    print(f"[extended train check] {label}, {EXT_CHECK['size']}², batch "
          f"{EXT_CHECK['batch']}, fp32, the CPU with the card's activation "
          f"patterns ({kinks[0]} on the other side at CPU inputs up to "
          f"{kinks[1]!r}, tol {TRAIN_ABS}): metrics max rel {rel!r} (tol "
          f"{TRAIN_RTOL}); Adam first moments {mu} (tol {TRAIN_RTOL}); "
          f"outputs max-abs {out}, {extra} (tol {TRAIN_ABS}); CPU {m_cpu}",
          flush=True)
    check(m_card.keys() == m_cpu.keys(), f"{label}: the same metrics")
    check(rel <= TRAIN_RTOL, f"{label}: metrics, card vs CPU")
    check(kinks[1] <= TRAIN_ABS, f"{label}: the activations on the other "
          "side lie within rounding of their kink")
    check(set(mu) == set(moments), f"{label}: every net has a gradient")
    for k, r in mu.items():
        check(r <= TRAIN_RTOL, f"{label}: {k}'s Adam first moment, card "
              "vs CPU")
    for k, e in (*out.items(), *extra.items()):
        check(e <= TRAIN_ABS, f"{label}: {k}, card vs CPU")


def ext_copy(nets, opts) -> None:
    """The CPU's nets (buffers included) and Adam states into the card's:
    ``nets`` / ``opts`` are (CPU, card) pairs."""
    import torch

    with torch.no_grad():
        for a, b in nets:
            b.load_state_dict(a.state_dict())
        for a, b in opts:
            for t in ("count", "mu_flat", "nu_flat"):
                getattr(b, t).copy_(getattr(a, t))


def ext_check(dev) -> None:
    """Phase 41: the extended trainers' steps, card against CPU, each card
    step from the CPU's state."""
    import torch

    from cistar_tpu_torch.engines import extended as px

    n, size = EXT_CHECK["batch"], EXT_CHECK["size"]
    gen = torch.Generator().manual_seed(15)
    devs = ("cpu", dev)

    def frames():
        return torch.rand(n, size, size, 1, generator=gen) * 2 - 1

    def on(t, e):
        return t.to(e.device)

    with fp32_exact():
        # R2LAE, both feature critics: one joint step of six nets
        for wgan in (False, True):
            engs = [px.R2LAE(wgan=wgan, compute_dtype=torch.float32,
                             device=d, **EXT_CHECK_R2LAE) for d in devs]
            sts = [e.init_state(0) for e in engs]
            radar, lidar = frames(), frames()

            def step(k):
                sts[k], m, fakes = engs[k].train_step(
                    sts[k], on(radar, engs[k]), on(lidar, engs[k]))
                return m, fakes

            res, kinks = ext_steps(engs, step)
            stats = {k: max(((sts[1].stats[k][b].cpu() - v).abs().max()
                             .item() for b, v in sts[0].stats[k].items()),
                            default=0.0) for k in px.BN_NETS}
            ext_hold(f"R2LAE, DF {'WDiscriminator' if wgan else 'domain'}",
                     res, kinks, {k: (sts[0].opts[k], sts[1].opts[k])
                                  for k in px.NETS},
                     {f"{k} running statistics": v for k, v in stats.items()})
            # eval mode on the running statistics, after the step
            outs = [e.infer(s, on(radar, e), on(lidar, e))
                    for e, s in zip(engs, sts)]
            err = max((outs[1][k].cpu() - v).abs().max().item()
                      for k, v in outs[0].items())
            print(f"[extended train check] R2LAE infer after the step, card "
                  f"vs CPU max-abs {err!r}", flush=True)
            check(err <= TRAIN_ABS, "R2LAE infer after the step, card vs "
                  "CPU")

        # the image critic with the JAX-style explicit interpolation weights
        engs = [px.R2LImageCritic(compute_dtype=torch.float32, device=d,
                                  **EXT_CHECK_CRITIC) for d in devs]
        sts = [e.init_state(0) for e in engs]
        lidar, radar = frames(), frames()
        eps = torch.rand(n, 1, 1, 1, generator=gen)

        def step(k):
            sts[k], m = engs[k].train_step(sts[k], on(lidar, engs[k]),
                                           on(radar, engs[k]),
                                           eps=on(eps, engs[k]))
            return m, {}

        res, kinks = ext_steps(engs, step)
        ext_hold("R2LImageCritic, explicit eps, the penalty's double "
                 "backward", res, kinks, {"D": (sts[0].opt, sts[1].opt)}, {})
        check(res[0][0]["gp"] > 0, "the gradient penalty is on")

        # R2LTransfer: a step with the feature critic's gate open, then one
        # from the CPU's state with it closed
        engs = [px.R2LTransfer(compute_dtype=torch.float32, device=d,
                               **EXT_CHECK_TRANSFER) for d in devs]
        sts = [e.init_state(0) for e in engs]
        frozen = [e.init_frozen(1) for e in engs]
        for floor in (0.2, 1e9):
            ext_copy([(engs[0].E, engs[1].E), (engs[0].DF, engs[1].DF)],
                     [(sts[0].opt_lidar_e, sts[1].opt_lidar_e),
                      (sts[0].opt_df, sts[1].opt_df)])
            df0 = [torch.cat([p.detach().reshape(-1).cpu()
                              for p in s.net_df.values()]) for s in sts]
            count0 = int(sts[0].opt_df.count)
            for e in engs:
                e.d_floor = floor
            radar, lidar = frames(), frames()

            def step(k):
                sts[k], m, (rt, lt) = engs[k].train_step(
                    sts[k], frozen[k], on(radar, engs[k]), on(lidar, engs[k]))
                return m, {"radar_trans": rt, "lidar_trans": lt}

            res, kinks = ext_steps(engs, step)
            gate = res[0][0]["D_Loss"] > floor
            moments = {"E": (sts[0].opt_lidar_e, sts[1].opt_lidar_e)}
            if gate:
                moments["DF"] = (sts[0].opt_df, sts[1].opt_df)
            ext_hold(f"R2LTransfer, DF gate {'open' if gate else 'closed'}",
                     res, kinks, moments, {})
            check(gate == (floor < 1), "the DF gate opened as asked")
            for k, s in enumerate(sts):
                df1 = torch.cat([p.detach().reshape(-1).cpu()
                                 for p in s.net_df.values()])
                check(torch.equal(df1, df0[k]) != gate
                      and (int(s.opt_df.count) == count0 + gate),
                      "DF and its Adam state move only through the gate")
        ref = engs[0].init_frozen(1)
        for f in frozen:
            check(all(torch.equal(a.cpu(), b) for k in ref for a, b in zip(
                f[k].state_dict().values(), ref[k].state_dict().values())),
                  "R2LTransfer's frozen nets bit for bit unchanged")
    # the transfer pair and the autoencoder generator: phase 36's checks
    p2p_train_check(dev, EXT_P2P_RUNS)


def ext_timed(label: str, counters, step, nets: dict, frozen=None,
              batch: int = 1, dtype: str = "fp32"):
    """Phase 42 for one configuration: ``step(i, mark=None)`` runs the
    i-th step and returns its metrics; 2 warm-up and EXT_STEPS timed steps,
    CUDA events around each, every launch counter 0 before and after; the
    trained ``nets`` moved, the ``frozen`` ones bit for bit unchanged.
    Returns ``step`` for phase 43."""
    import numpy as np
    import torch

    def flat(ms):
        return torch.cat([p.detach().reshape(-1) for m in ms.values()
                          for p in m.parameters()])

    before = {k: flat({k: m}) for k, m in nets.items()}
    fz0 = flat(frozen).clone() if frozen else None
    metrics = []
    for m in counters:
        m.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        metrics.append(step(i))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(EXT_STEPS + 1)]
    evs[0].record()
    for i in range(EXT_STEPS):
        metrics.append(step(i))
        evs[i + 1].record()
    evs[-1].synchronize()
    ms = evs[0].elapsed_time(evs[-1]) / EXT_STEPS
    each = sorted(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for m in counters for k, v in m.launches.items()}
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    print(f"[extended train path] {label}: {sum(launches.values())} "
          f"launches over the {len(launches)} kernel counters", flush=True)
    check(not any(launches.values()), f"{label}: no kernel launched")
    print(f"[times] {label} batch {batch} {EXT_SIZE}² {dtype}: {ms!r} ms a "
          f"step "
          f"(the mean of {EXT_STEPS}; each step min {each[0]!r}, median "
          f"{each[len(each) // 2]!r}, max {each[-1]!r}), "
          f"{batch / ms * 1e3!r} img/s; the {TRAIN_WARMUP} warm-up steps "
          f"{first_s!r} s; peak memory {peak} B ({peak / 2**30!r} GiB); "
          f"last step {host[-1]}", flush=True)
    check(all(np.isfinite(v) for m in host for v in m.values()),
          f"{label}: finite losses")
    for k, m in nets.items():
        check(not torch.equal(flat({k: m}), before[k]), f"{label}: {k} moved")
    if frozen:
        check(torch.equal(flat(frozen), fz0),
              f"{label}: the frozen nets bit for bit unchanged")
    return step


def ext_opt(*flags):
    """``p2phd_train``'s options at the shipped recipe, on the card."""
    from cistar_tpu_torch.apps.p2phd_options import TrainOptions

    return TrainOptions().parse(
        ["--load_opt", os.path.join(ROOT, "checkpoints", "r2l_MSRB_7",
                                    "opt.txt"),
         "--dataroot", ROOT, "--checkpoints_dir",
         os.path.join(ROOT, "checkpoints"), "--device", "cuda", *flags],
        save=False)


def ext_full(dev, counters) -> None:
    """Phases 42-43: the full-width steps, counted and timed; the no-sync
    check, the breakdown and the profile of R2LAE and R2LTransfer."""
    import torch

    from cistar_tpu_torch.apps.p2phd_train import make_engine
    from cistar_tpu_torch.engines.factory import (create_model,
                                                  create_uda_model)

    size = EXT_SIZE
    radar, lidar = synthetic_pairs(2, size)
    frames = [(torch.from_numpy(radar[i:i + 1]).to(dev),
               torch.from_numpy(lidar[i:i + 1]).to(dev)) for i in (0, 1)]
    steps = {}
    for label, flags, dtype in (
            ("R2LAE (r2l_MSRB_7)", [], "fp32"),
            ("R2LAE (r2l_MSRB_7) --fp16", ["--fp16"], "bf16"),
            ("R2LAE (r2l_MSRB_7) --wgan", ["--wgan"], "fp32")):
        eng = create_uda_model(ext_opt("--uda", "--training_module",
                                       "autoencoder", *flags))
        check(eng.cdt == (torch.bfloat16 if dtype == "bf16"
                          else torch.float32), f"{label}: {dtype}")
        box = [eng.init_state(0)]

        def step(i, mark=None, eng=eng, box=box):
            r, li = frames[i % 2]
            box[0], m, _ = eng.train_step(box[0], r, li, mark=mark)
            return m

        steps[label] = ext_timed(label, counters, step, eng.nets(),
                                 dtype=dtype)

    eng = create_uda_model(ext_opt("--uda"))
    check(type(eng).__name__ == "R2LImageCritic"
          and eng.cdt == torch.float32,
          "the CLI's default UDA module is the fp32 image critic")
    box = [eng.init_state(0)]

    def step(i, mark=None, eng=eng, box=box):
        r, li = frames[i % 2]
        box[0], m = eng.train_step(box[0], li, r, mark=mark)
        return m

    ext_timed("R2LImageCritic (ngf 16, 5 layers)", counters, step,
              {"D": eng.D})

    flags = [*EXT_TRANSFER_FLAGS, "--r2l", "--r2l_res", str(size)]
    eng = create_model(ext_opt("--wgan", *flags))
    box = [eng.init_state(0)]
    frozen = eng.init_frozen(1)

    def step(i, mark=None, eng=eng, box=box):
        r, li = frames[i % 2]
        box[0], m, _ = eng.train_step(box[0], frozen, r, li, mark=mark)
        return m

    steps["R2LTransfer"] = ext_timed(
        "R2LTransfer (ngf 32, 4 downs, 3 scales, 3 blocks)", counters, step,
        {"E": eng.E, "DF": eng.DF}, frozen=frozen)

    for label, eng in (
            ("transfer pair (ngf 32, 4 downs, 3 scales, 3 blocks)",
             create_model(ext_opt("--transfer", *flags))),
            ("Pix2PixHD netG=autoencoder (ngf 64, 2 downs, 3 blocks)",
             make_engine(ext_opt("--netG", "autoencoder"), size))):
        box = [eng.init_state(0)]

        def step(i, mark=None, eng=eng, box=box):
            r, li = frames[i % 2]
            box[0], m, _ = eng.train_step(box[0], r, None, li, mark=mark)
            return m

        ext_timed(label, counters, step, {"G": eng.G, "D": eng.D},
                  dtype="bf16" if eng.cdt == torch.bfloat16 else "fp32")

    # 43. no host sync in a step; where the time goes
    for label in ("R2LAE (r2l_MSRB_7)", "R2LTransfer"):
        p2p_breakdown(steps[label], label, "extended train step")


def ext_cli(dev, counters) -> None:
    """Phases 44-45: ``p2phd_train --uda`` for both modules, R2LAE.infer on
    its nets, ``encode_features`` in both modes and an ``EditSession`` edit
    and style switch, on synthetic 512² pairs, on the card."""
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.apps import encode_features, p2phd_train
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.core.convert import batch_stats_to_jax
    from cistar_tpu_torch.data.datasets import UDADataset
    from cistar_tpu_torch.engines import ui
    from cistar_tpu_torch.engines.factory import create_uda_model
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD

    size = EXT_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        synthetic_tool().main(["--out", data, "--n", str(P2P_CLI_PAIRS),
                               "--size", str(size)])
        base = ["--load_opt", os.path.join(ROOT, "checkpoints", "r2l_MSRB_7",
                                           "opt.txt"),
                "--uda", "--dataroot", data, "--checkpoints_dir", ck,
                "--device", dev.type, "--niter", "1", "--niter_decay", "0",
                "--print_freq", "2"]
        run = os.path.join(ck, "r2l_MSRB_7")
        # 44. both modules, one epoch of UDADataset's 30% split
        for module, labels in (("discriminator", ("img_D",)),
                               ("autoencoder", tuple(
                                   lab for lab, _ in p2phd_train.UDA_LABELS))):
            for m in counters:
                m.reset_launches()
            t0 = time.perf_counter()
            st = p2phd_train.main(base + ["--training_module", module])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for m in counters for k, v in m.launches.items()}
            for lab in labels:
                check(os.path.exists(os.path.join(
                    run, f"latest_net_{lab}.npz")), f"--uda wrote {lab}")
            check(not any(launches.values()), "--uda launches no kernel")
            n_train = int(P2P_CLI_PAIRS * 0.3)
            print(f"[uda cli] --training_module {module}: {P2P_CLI_PAIRS} "
                  f"pairs {size}², one epoch of {n_train} steps at batch 1 "
                  f"in {dt:.1f} s (set-up included); wrote "
                  f"{', '.join(labels)}", flush=True)
        # R2LAE.infer on the saved nets and the run's running statistics
        # (the CLI saves none, as the JAX CLI)
        opt = ext_opt("--uda", "--training_module", "autoencoder")
        eng = create_uda_model(opt)
        params = {f: ckpt.load_pytree(os.path.join(
            run, f"latest_net_{lab}.npz"))
            for lab, f in p2phd_train.UDA_LABELS}
        stats = {k: batch_stats_to_jax(st.stats[k]) or {}
                 for k in st.stats}
        eng.load_jax_params(params, stats)
        ds = UDADataset(data, size=size, mode="test")
        r = torch.from_numpy(np.stack([ds[i]["radar"] for i in range(4)]))
        li = torch.from_numpy(np.stack([ds[i]["lidar"] for i in range(4)]))
        with fp32_exact():   # TF32 rounds at ~5e-4, over INFER_BATCH_ABS
            out = eng.infer(st, r.to(dev), li.to(dev))
            one = eng.infer(st, r[:1].to(dev), li[:1].to(dev))
        for k, v in out.items():
            check(tuple(v.shape) == (4, size, size, 1)
                  and bool(torch.isfinite(v).all()),
                  f"R2LAE.infer {k}: finite, 4 frames")
        err = max((one[k][0] - out[k][0]).abs().max().item() for k in out)
        top = max(v.abs().max().item() for v in out.values())
        print(f"[uda cli] R2LAE.infer on the saved nets, 4 test frames: "
              f"lidar_gen mean {out['lidar_gen'].float().mean().item()!r}; "
              f"frame 0 alone vs in the batch max-abs {err!r} (TF32 off; "
              f"largest |value| {top!r})", flush=True)
        check(err <= INFER_BATCH_ABS, "R2LAE.infer is batch independent")
        infer_batch_bisect(eng, st, r.to(dev), li.to(dev))

        # 45. encode_features, then the UI, with the encoder on the card
        feat_args = ["--dataroot", data, "--checkpoints_dir", ck,
                     "--name", "features", "--size", str(size),
                     "--device", dev.type, *EXT_FEATURES]
        for m in counters:
            m.reset_launches()
        t0 = time.perf_counter()
        out_dir = encode_features.main(["--mode", "maps", *feat_args])
        t1 = time.perf_counter()
        clusters = encode_features.main(["--mode", "cluster", *feat_args])
        t2 = time.perf_counter()
        check(not any(v for m in counters for v in m.launches.values()),
              "encode_features launches no kernel")
        maps = sorted(os.listdir(out_dir))
        n_train = int(P2P_CLI_PAIRS * 0.7)
        check(len(maps) == n_train, f"{n_train} feature maps")
        fm = np.load(os.path.join(out_dir, maps[0]))
        check(fm.shape == (size, size, 3) and np.isfinite(fm).all(),
              "a 512² feature map of 3 channels")
        check(set(clusters) == {0} and clusters[0].shape == (10, 3),
              "10 centres of label 0")
        print(f"[encode features] --mode maps {n_train} frames {size}² in "
              f"{t1 - t0:.1f} s, --mode cluster in {t2 - t1:.1f} s: "
              f"centres {clusters[0].round(4).tolist()}", flush=True)

        eng = Pix2PixHD("global", instance_feat=True, load_features=True,
                        feat_num=3, device=dev, **EXT_UI)
        label = UDADataset(data, size=size, mode="train")[0]["radar"]
        for m in counters:
            m.reset_launches()
        t0 = time.perf_counter()
        s = ui.EditSession(eng, label, None, fm)
        before = s.current.copy()
        # a stroke of brush 9 (±4) at two points; the edit composites its
        # box dilated by 64 pixels
        ys, xs = np.array([size * 5 // 8, size * 5 // 8 + 10]), \
            np.array([size * 3 // 8, size * 3 // 8 + 20])
        region = (ys.min() - 4, xs.min() - 4, ys.max() + 5, xs.max() + 5)
        got = s.apply(ui.add_strokes, ys, xs, 9, 1.0, region=region)
        box = np.zeros(got.shape[:2], bool)
        box[max(0, region[0] - 64):region[2] + 64,
            max(0, region[1] - 64):region[3] + 64] = True
        outside = np.abs(got[~box] - before[~box]).max(initial=0.0)
        inside = np.abs(got[box] - before[box]).max()
        styled = s.set_style(0, clusters[0], 3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for m in counters for k, v in m.launches.items()}
        print(f"[ui] EditSession on the card ({size}², global {EXT_UI} "
              f"with 3 feature channels, bf16): synthesis, a stroke edit "
              f"composited in its box + 64 px (changed up to "
              f"{float(inside)!r} inside, {float(outside)!r} outside), a "
              f"style switch to cluster 3 (moved the frame by up to "
              f"{float(np.abs(styled - got).max())!r}) in {dt:.2f} s; "
              f"{sum(launches.values())} kernel launches", flush=True)
        check(not any(launches.values()), "the UI session launches no "
              "kernel")
        check(outside == 0.0 and inside > 0, "the edit stays in its box")
        check(np.isfinite(styled).all() and np.abs(styled - got).max() > 0,
              "the style switch changes the frame")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, no autotuning."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved


def infer_batch_bisect(eng, st, r, li) -> None:
    """Phase 44's two ``R2LAE.infer`` calls (frame 0 alone and in the batch)
    with TF32 off and cuDNN's deterministic algorithms, and the first module
    of ``E``, ``G_lidar``, ``G_radar`` (in call order) whose frame-0 output
    differs between them; printed, not held (the outputs stay held to
    ``INFER_BATCH_ABS`` by phase 44)."""
    import torch

    mods = [(f"{net}.{name}" if name else net, m)
            for net in ("E", "G_lidar", "G_radar")
            for name, m in getattr(eng, net).named_modules()]

    def run(n):
        rec = []
        hooks = [m.register_forward_hook(
            lambda m_, i, o, name=name: rec.append(
                (name, type(m_).__name__, o[0].detach().float().clone(),
                 o.shape[0])))
            for name, m in mods]
        try:
            out = eng.infer(st, r[:n], li[:n])
        finally:
            for h in hooks:
                h.remove()
        return out, rec

    with fp32_exact(), cudnn_deterministic():
        out, rec_n = run(r.shape[0])
        one, rec_1 = run(1)
    err = max((one[k][0] - out[k][0]).abs().max().item() for k in out)
    check([e[0] for e in rec_n] == [e[0] for e in rec_1],
          "the same modules run in both calls")
    diffs = [(name, kind, (a - b).abs().max().item())
             for (name, kind, a, _), (_, _, b, _) in zip(rec_n, rec_1)]
    first = next((d for d in diffs if d[2] > 0), None)
    n_diff = sum(d[2] > 0 for d in diffs)
    print(f"[uda cli] R2LAE.infer frame 0 alone vs in the batch, TF32 off, "
          f"cuDNN deterministic (benchmark off): max-abs {err!r}; "
          f"{n_diff} of {len(diffs)} module outputs differ, the first "
          f"{first!r}", flush=True)
    if first is None:
        return
    i = diffs.index(first)
    print(f"[uda cli] the modules around it: {diffs[max(0, i - 2):i + 4]!r}",
          flush=True)
    if i == 0 or diffs[i - 1][2] != 0:
        return
    # its input is the same in both calls: the instance-norm moments of
    # that frame at either call's batch shape (a reduction's order of sums
    # follows the shape, not the values), one-pass as the port takes them
    # and two-pass
    frame, nb = rec_n[i - 1][2], (rec_n[i - 1][3], rec_1[i - 1][3])
    with fp32_exact():
        moments = []
        for n in nb:
            xf = frame.expand(n, *frame.shape).contiguous()
            mean = xf.mean((1, 2))[0]
            one = (xf * xf).mean((1, 2))[0] - mean * mean
            two = ((xf - mean) ** 2).mean((1, 2))[0]
            moments.append((mean, one, two))
    (m_a, o_a, t_a), (m_b, o_b, t_b) = moments

    def rel(a, b):
        return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()

    print(f"[uda cli] the instance-norm moments of that module's input "
          f"(the same frame at batch {nb[0]} and {nb[1]}): mean "
          f"{rel(m_a, m_b)!r} relative, one-pass variance E[x²]-E[x]² "
          f"{rel(o_a, o_b)!r}, "
          f"two-pass variance {rel(t_a, t_b)!r}; |mean| / std up to "
          f"{(m_a.abs() / t_a.sqrt()).max().item()!r}", flush=True)


def extended_path(dev, counters) -> None:
    """Phases 41-45: the extended pix2pixHD trainers (slice 15)."""
    ext_check(dev)
    ext_full(dev, counters)
    ext_cli(dev, counters)


def fidelity_path(dev, counters) -> None:
    """Phase 46: the bf16 forward and the int8 engine of each row of
    ``tools/fidelity_table.py`` against the fp32 forward, in the calibrated
    LPIPS metric and the pixel L1."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    from cistar_tpu_torch.models import fast_infer as fi
    from cistar_tpu_torch.models.cyclegan import seeded_generator
    from cistar_tpu_torch.ops import quant_int8 as qi
    from cistar_tpu_torch.utils.fidelity import (BUDGET, fidelity_metric,
                                                 make_radar)
    from cistar_tpu_torch.utils.lpips import lpips_distance

    def p2p(family_, **cfg):
        eng = Pix2PixHDInference(family_, seed=0, **cfg)
        return eng.G, eng.quantize_generator()

    def k7(nb):
        return {"resblock_int8_tiled_a": nb, "resblock_int8_tiled_b": nb}

    glob, unet = P2PHD["global"], P2PHD["UNet"]
    builders = {
        "cyclegan256": lambda: (
            *(lambda g: (g, qi.quantize_resnet_trunk(g)))(seeded_generator(
                "p2p", BLOCKS, FEATURES, seed=0, device=dev)),
            fi.resnet_generator_int8_trunk_apply,
            {"resblock_int8_bf16io": BLOCKS}),
        "p2phd_global512": lambda: (
            *p2p("global", ngf=glob["ngf"],
                 n_downsample_global=glob["n_downsample_global"],
                 n_blocks_global=glob["n_blocks_global"]),
            fi.global_generator_int8_trunk_apply,
            k7(glob["n_blocks_global"])),
        "unet_msrb512": lambda: (
            *p2p("UNet", ngf=unet["ngf"],
                 n_blocks_global=unet["n_blocks_global"]),
            fi.unet_msrb_int8_apply,
            {"msrb_branch_int8": 4 * unet["n_blocks_global"]}),
        "local1024": lambda: (
            *p2p("local", **{k: LOCAL[k] for k in (
                "ngf", "n_downsample_global", "n_blocks_global",
                "n_local_enhancers", "n_blocks_local")}),
            fi.local_enhancer_int8_apply, k7(LOCAL["n_blocks_global"])),
    }
    t_phase = time.perf_counter()
    for name, batch, size in FIDELITY_ROWS:
        gen, qb, int8_fn, want = builders[name]()
        x = torch.from_numpy(make_radar(batch, size)).to(dev)
        with fp32_exact():
            ref = gen(x)
        outs = {"bf16": gen(x.bfloat16())}
        for m in counters:
            m.reset_launches()
        outs["int8"] = int8_fn(gen, qb, x.bfloat16())
        torch.cuda.synchronize()
        launches = {k: v for m in counters for k, v in m.launches.items()}
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"{name}: the int8 engine launches {want} and no other kernel")
        with fp32_exact():
            metrics = {e: fidelity_metric(ref, y) for e, y in outs.items()}
        for e, mt in metrics.items():
            print(f"[fidelity] {name} ({batch}, {size}, {size}, 1) {e} vs "
                  f"fp32: lpips_metric {mt['lpips_metric']!r}, pixel_l1 "
                  f"{mt['pixel_l1']!r} (budget {BUDGET}; launches "
                  f"{want if e == 'int8' else {}})", flush=True)
            check(mt["lpips_metric"] < BUDGET,
                  f"{name} {e} within the LPIPS budget of fp32")
        if name == FIDELITY_ROWS[0][0]:
            a, b = ((y[:2].float() + 1) / 2 for y in (outs["bf16"], ref))
            with fp32_exact():
                d_card = lpips_distance(a, b).cpu()
            d_cpu = lpips_distance(a.cpu(), b.cpu())
            rel = ((d_card - d_cpu).abs() / d_cpu).max().item()
            print(f"[fidelity] {name} lpips_distance of frames 0-1 (bf16, "
                  f"fp32) on the card {d_card.tolist()!r}, on the CPU "
                  f"{d_cpu.tolist()!r}: {rel!r} relative (tol "
                  f"{LPIPS_CPU_RTOL})", flush=True)
            check(rel <= LPIPS_CPU_RTOL, "the card's LPIPS is the CPU's")
        del gen, qb, ref, outs
        torch.cuda.empty_cache()
    print(f"[fidelity] phase 46 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_clis(runs: dict, tmp: str) -> dict:
    """Each CLI of ``runs`` (label → (module, args, TF32 on)) in a process
    of its own (:data:`CLI_RUNNER`), all started together: label → (the
    seconds to its exit, its engine's calls (each a list of arrays: the
    inputs, then the outputs), its kernel launches)."""
    import numpy as np

    procs = {}
    t0 = time.perf_counter()
    for k, (label, (module, args, tf32)) in enumerate(runs.items()):
        out = os.path.join(tmp, f"cli{k}")
        with open(out + ".out", "w") as so, open(out + ".err", "w") as se:
            procs[label] = (out, subprocess.Popen(
                [sys.executable, "-c", CLI_RUNNER, module, out + ".npz",
                 "1" if tf32 else "0", *args], cwd=ROOT, stdout=so,
                stderr=se))
    secs = {}
    while len(secs) < len(procs):
        for label, (_, p) in procs.items():
            if label not in secs and p.poll() is not None:
                secs[label] = time.perf_counter() - t0
        time.sleep(0.05)
    results = {}
    for label, (out, p) in procs.items():
        stdout = open(out + ".out").read()
        if p.returncode != 0:
            print(stdout[-4000:], open(out + ".err").read()[-4000:],
                  flush=True)
            check(False, f"{label}: exit {p.returncode}")
        with np.load(out + ".npz") as f:
            calls = {}
            for k in sorted(f.files):
                calls.setdefault(k.split("_")[0], []).append(f[k])
        results[label] = (secs[label], [calls[c] for c in sorted(calls)],
                          json.loads(stdout.strip().splitlines()[-1]))
    return results


# Phase 48's cases: label, gen_type, features, blocks, size, batch, the
# kernel ids its op table must name
EXPORT_CASES = (("ResNet-9 int8", "p2p-content", FEATURES, BLOCKS, SIZE,
                 BENCH_BATCH, ("K1",)),
                ("bilinear_content int8", "bilinear_content",
                 BIL["features"], BIL["blocks"], BIL["size"],
                 BIL_BENCH_BATCH, ("K5", "K6")))
EXPORT_ITERS, EXPORT_TOP = 20, 8
DP_STEPS = 5


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for both sides of a comparison."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


def hold_to_eager(label: str, names, got, eager0, eager1, ref32) -> None:
    """Phase 48's rule for an output computed two ways (a loaded program or
    a sharded one, ``got``) against the eager call (``eager0``; a second
    eager call ``eager1``): bit for bit where the two eager calls are;
    else the eager gap printed, and ``got``'s error against the fp32
    forward ``ref32`` within KERNEL_MEAN_RATIO (mean-abs) and
    KERNEL_MAX_EXCESS (max-abs) of the eager call's."""
    import torch

    for name, g, e0, e1, r in zip(names, got, eager0, eager1, ref32):
        gap_e, gap_g = (e1 - e0).abs(), (g - e0).abs()
        same = torch.equal(e0, e1)
        print(f"[{label}] {name}: eager vs eager max {gap_e.max().item()!r} "
              f"mean {gap_e.mean().item()!r}; vs eager max "
              f"{gap_g.max().item()!r} mean {gap_g.mean().item()!r}"
              + ("; the eager calls equal bit for bit" if same else ""),
              flush=True)
        if same:
            check(torch.equal(g, e0), f"{label} {name}: bit for bit with the "
                  "eager call, as two eager calls are")
            continue
        el, ee = (g - r).abs(), (e0 - r).abs()
        print(f"[{label}] {name} vs fp32: max {el.max().item()!r} mean "
              f"{el.mean().item()!r}; the eager call's max "
              f"{ee.max().item()!r} mean {ee.mean().item()!r}", flush=True)
        check(el.mean() <= KERNEL_MEAN_RATIO * ee.mean()
              and el.max() <= ee.max() + KERNEL_MAX_EXCESS,
              f"{label} {name}: within the eager call's run-to-run budget")


def check_table(label: str, rows, totals, ids) -> None:
    """Print the op table's top EXPORT_TOP and check that it names ``ids``
    (rows led by a kernel id, ``runtime/profiler.py``)."""
    from cistar_tpu_torch.runtime.profiler import format_op_table

    print(f"[export] {label}: the loaded program's op table\n"
          + format_op_table(rows, totals, top=EXPORT_TOP), flush=True)
    named = {i for r in rows for i in r["op"].split(" ", 1)[0].split("+")}
    check(set(ids) <= named, f"{label}: the op table names {ids} (it names "
          f"{sorted(named & {'K1', 'K2', 'K5', 'K6', 'K7a', 'K7b', 'K8'})})")


def counted(counters, fn) -> dict:
    """The launches of one call of ``fn``, every counter at 0 before."""
    import torch

    for m in counters:
        m.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for m in counters for k, v in m.launches.items() if v}


def export_path(dev, images, counters) -> None:
    """Phase 48: exported programs, saved and loaded, on the card."""
    import contextlib as cl
    import io
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.apps import p2phd_test
    from cistar_tpu_torch.apps.p2phd_options import TestOptions
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import Radar2LidarDataset
    from cistar_tpu_torch.engines.cyclegan import (CycleGANInference,
                                                   InferProgram)
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    from cistar_tpu_torch.runtime.aot import (load_compiled, profile_fn,
                                              save_compiled)
    from cistar_tpu_torch.runtime.profiler import profile_op_table

    names = ("fake_b", "fake_a", "recover_b")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, gen, feat, blocks, size, n, ids in EXPORT_CASES:
            eng = CycleGANInference(gen, in_features=feat,
                                    n_residual_blocks=blocks, device=dev)
            extra = eng.program_args("int8")
            a, b = images(n, size), images(n, size)
            path = os.path.join(tmp, f"{gen}.pt2")
            t0 = time.perf_counter()
            nbytes = save_compiled(InferProgram(eng, True), extra + (a, b),
                                   path)
            t1 = time.perf_counter()
            run = load_compiled(path)
            t2 = time.perf_counter()
            loaded = lambda: run(*extra, a, b)  # noqa: E731
            eager = lambda: eng.infer_step_int8(  # noqa: E731
                extra[2], extra[3], (a, b))
            launches = counted(counters, loaded)
            want = {"p2p-content": {"resblock_int8_bf16io": 3 * blocks},
                    "bilinear_content": {"atrous_resblock_int8": 3 * blocks,
                                         "multi_atrous_stage_int8": 3}}[gen]
            print(f"[export] {label} {size}² batch {n}: exported in "
                  f"{t1 - t0!r} s ({nbytes} bytes), loaded in {t2 - t1!r} s; "
                  f"one loaded call launches {launches}", flush=True)
            check(launches == want, f"{label}: the loaded program launches "
                  f"{want}")
            with cudnn_deterministic():
                e0, e1, got = eager(), eager(), loaded()
            ref = CycleGANInference(gen, in_features=feat,
                                    n_residual_blocks=blocks, device=dev,
                                    compute_dtype=torch.float32)
            with fp32_exact():
                r32 = ref.infer_step(a, b)
            del ref
            hold_to_eager(f"export {label}", names, got, e0, e1, r32)
            del e0, e1, got, r32
            pe, pl = (profile_fn(f, iters=EXPORT_ITERS, warmup=2)
                      for f in (eager, loaded))
            print(f"[times] {label} batch {n}: eager {pe['mean_ms']!r} ms a "
                  f"call (p50 {pe['p50_ms']!r}), loaded {pl['mean_ms']!r} "
                  f"ms (p50 {pl['p50_ms']!r}), {n / pl['mean_ms'] * 1e3!r} "
                  "img/s loaded", flush=True)
            check_table(label, *profile_op_table(loaded, iters=2), ids)
            del eng, run, extra
            torch.cuda.empty_cache()

        # p2phd_test --export_onnx / --engine at r2l_MSRB_7 (UNet, 512²)
        label = "p2phd_test UNet int8 (r2l_MSRB_7)"
        opt_txt = os.path.join(ROOT, "checkpoints", "r2l_MSRB_7", "opt.txt")
        size = P2P_TRAIN_COMMON["image_size"]
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        synthetic_tool().main(["--out", data, "--n", str(P2P_TEST_PAIRS * 2),
                               "--size", str(size)])
        args = ["--load_opt", opt_txt, "--dataroot", data,
                "--checkpoints_dir", ck, "--device", dev.type, "--phase",
                "test", "--data_type", "8", "--results_dir",
                os.path.join(tmp, "res"), "--how_many", "2"]
        opt = TestOptions().parse(args, save=False)
        g = Pix2PixHDInference(opt.netG, ngf=opt.ngf,
                               n_blocks_global=opt.n_blocks_global,
                               input_nc=opt.input_nc, output_nc=opt.output_nc,
                               label_nc=opt.label_nc, r2l=opt.r2l,
                               no_instance=opt.no_instance, device=dev)
        ckpt.save_network(os.path.join(ck, opt.name), "G", "latest",
                          g.jax_params()["G"])
        del g
        pt2 = os.path.join(tmp, "unet.pt2")
        for flag in ("--export_onnx", "--engine"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with cl.redirect_stdout(buf):
                p2phd_test.main(args + [flag, pt2])
            torch.cuda.synchronize()
            out = buf.getvalue()
            print(f"[export] {label} {flag}: the CLI in "
                  f"{time.perf_counter() - t0!r} s; it printed:\n"
                  + out.strip(), flush=True)
            if flag == "--engine":
                check("ms/iter" in out and "\nK8 " in out,
                      "the CLI's --engine printed its time and an op table "
                      "naming K8")
        eng = p2phd_test.load_engine(opt)
        qb = eng.quantize_generator()
        ds = Radar2LidarDataset(data, size=size, mode="test")
        x = torch.from_numpy(np.stack([ds[0]["label"]])).to(dev)
        t0 = time.perf_counter()
        run = load_compiled(pt2)
        load_s = time.perf_counter() - t0
        loaded = lambda: run(x)  # noqa: E731
        eager = lambda: eng.infer_step_int8(qb, x)  # noqa: E731
        launches = counted(counters, loaded)
        want = {"msrb_branch_int8": 4 * opt.n_blocks_global}
        print(f"[export] {label}: loaded in {load_s!r} s; one loaded call "
              f"launches {launches}", flush=True)
        check(launches == want, f"{label}: the loaded program launches {want}")
        with cudnn_deterministic():
            e0, e1, got = eager(), eager(), loaded()
        with fp32_exact():
            r32 = eng.G(x)
        hold_to_eager(f"export {label}", ("fake",), (got,), (e0,), (e1,),
                      (r32,))
        pe, pl = (profile_fn(f, iters=EXPORT_ITERS, warmup=2)
                  for f in (eager, loaded))
        print(f"[times] {label} batch 1: eager {pe['mean_ms']!r} ms a call "
              f"(p50 {pe['p50_ms']!r}), loaded {pl['mean_ms']!r} ms (p50 "
              f"{pl['p50_ms']!r})", flush=True)
        check_table(label, *profile_op_table(loaded, iters=2), ("K8",))
    print(f"[export] phase 48 took {time.perf_counter() - t_phase!r} s",
          flush=True)


def dp_hold(label: str, run) -> None:
    """Phase 49's check of one train step: ``run(k)`` steps engine k (1:
    the mesh's, recording its activation patterns; 0: without the mesh,
    replaying them) and returns (metrics, {net: Adam state}); the metrics
    and each net's first moment (its max-abs error over its largest) within
    TRAIN_RTOL."""
    masks, kinks, res = [], [], [None, None]
    for k in (1, 0):
        with same_kinks(masks, kinks if k == 0 else None):
            m, opts = run(k)
        res[k] = ({n: float(v) for n, v in m.items()},
                  {n: o.mu_flat.float().cpu() for n, o in opts.items()})
    (m0, mu0), (m1, mu1) = res
    rel = max(abs(m1[k] - v) / abs(v) for k, v in m0.items() if v)
    mu = {k: ((mu1[k] - v).abs().max() / v.abs().max()).item()
          for k, v in mu0.items()}
    print(f"[dp] {label}: mesh vs none, metrics max rel {rel!r}; first "
          f"moments (max-abs over largest) {mu}; activations replayed on "
          f"the other side {sum(n for n, _ in kinks)} (max distance "
          f"{max((x for _, x in kinks), default=0.0)!r}); tol {TRAIN_RTOL}",
          flush=True)
    check(m0.keys() == m1.keys() and rel <= TRAIN_RTOL,
          f"{label}: the sharded step's metrics")
    check(all(v <= TRAIN_RTOL for v in mu.values()),
          f"{label}: the sharded step's gradients")


def dp_time(label: str, steps, unit: str = "step") -> None:
    """ms a ``unit`` of each of ``steps`` (label → step function), in
    turns, DP_STEPS each after one warm-up call."""
    import torch

    out = {}
    for name, step in steps.items():
        step()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(DP_STEPS):
            step()
        e1.record()
        e1.synchronize()
        out[name] = e0.elapsed_time(e1) / DP_STEPS
    print(f"[times] {label}: " + "; ".join(f"{k} {v!r} ms a {unit}"
                                           for k, v in out.items()),
          flush=True)


def dp_path(dev, images, counters) -> None:
    """Phase 49: data parallelism at world size 1 with NCCL."""
    import tempfile

    import torch

    from cistar_tpu_torch.engines.cyclegan import (CycleGAN,
                                                   CycleGANInference)
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = sharding.make_mesh(dev, 0, 1,
                                  "file://" + os.path.join(tmp, "rendezvous"))
        try:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            check(mesh.grouped and torch.distributed.get_backend() == backend,
                  f"a {backend} group of one")
            print(f"[dp] {mesh}, backend {torch.distributed.get_backend()}",
                  flush=True)
            # the CycleGAN step at the train CLI's defaults: held in fp32
            # (TF32 off), timed in the CLI's bf16
            n, size = TRAIN["batch"], TRAIN["size"]
            radar, lidar = synthetic_pairs(n, size)
            a, b = (torch.from_numpy(t).to(dev) for t in (radar, lidar))
            cfg = dict(gen_type="bilinear_content",
                       in_features=TRAIN["features"],
                       n_residual_blocks=TRAIN["blocks"], image_size=size,
                       batch_size=n, pool_size=TRAIN["pool"], device=dev)
            for cdt in (torch.float32, torch.bfloat16):
                engs = [CycleGAN(**cfg, compute_dtype=cdt),
                        CycleGAN(**cfg, compute_dtype=cdt, mesh=mesh)]
                sts = [e.init_state(0) for e in engs]

                def cg_step(k):
                    sts[k], m = engs[k].train_step(sts[k], a, b)
                    return m, {"G": sts[k].opt_g, "D_A": sts[k].opt_d_a,
                               "D_B": sts[k].opt_d_b}

                if cdt == torch.float32:
                    with fp32_exact(), cudnn_deterministic():
                        dp_hold(f"CycleGAN bilinear_content {size}² batch "
                                f"{n}, fp32", cg_step)
                else:
                    dp_time(f"CycleGAN step bilinear_content {size}² batch "
                            f"{n} bf16", {"sharded (world 1)":
                                          lambda: cg_step(1),
                                          "unsharded": lambda: cg_step(0)})
                del engs, sts

            # the r2l_MSRB_7 pix2pixHD step, the same way
            n, size = P2P_TRAIN_BATCH, P2P_TRAIN_COMMON["image_size"]
            radar, lidar = synthetic_pairs(n, size)
            lab, img = (torch.from_numpy(t).to(dev) for t in (radar, lidar))
            cfg = dict(P2P_TRAIN["UNet"], **P2P_TRAIN_COMMON, device=dev,
                       seed=0)
            for cdt in (torch.float32, torch.bfloat16):
                engs = [Pix2PixHD("UNet", **cfg, compute_dtype=cdt),
                        Pix2PixHD("UNet", **cfg, compute_dtype=cdt,
                                  mesh=mesh)]
                sts = [e.init_state(0) for e in engs]

                def p2p_step(k):
                    sts[k], m, _ = engs[k].train_step(sts[k], lab, None, img)
                    return m, {"G": sts[k].opt_g, "D": sts[k].opt_d}

                if cdt == torch.float32:
                    with fp32_exact(), cudnn_deterministic():
                        dp_hold(f"pix2pixHD r2l_MSRB_7 {size}² batch {n}, "
                                "fp32", p2p_step)
                else:
                    dp_time(f"pix2pixHD step r2l_MSRB_7 {size}² batch {n} "
                            "bf16", {"sharded (world 1)": lambda: p2p_step(1),
                                     "unsharded": lambda: p2p_step(0)})
                del engs, sts

            # make_sharded_infer at ResNet-9, both engines
            n = BENCH_BATCH
            eng = CycleGANInference("p2p-content", in_features=FEATURES,
                                    n_residual_blocks=BLOCKS, device=dev)
            ref = CycleGANInference("p2p-content", in_features=FEATURES,
                                    n_residual_blocks=BLOCKS, device=dev,
                                    compute_dtype=torch.float32)
            a, b = images(n, SIZE), images(n, SIZE)
            with fp32_exact():
                r32 = ref.infer_step(a, b)
            del ref
            for kind in ("bf16", "int8"):
                extra = eng.program_args(kind)
                f = eng.make_sharded_infer(mesh, kind)
                sharded = lambda: f(*extra, a, b)  # noqa: E731
                plain = (lambda: eng.infer_step_int8(  # noqa: E731
                    extra[2], extra[3], (a, b))) if kind == "int8" \
                    else (lambda: eng.infer_step(a, b))
                launches = counted(counters, sharded)
                want = {"resblock_int8_bf16io": 3 * BLOCKS} \
                    if kind == "int8" else {}
                check(launches == want, f"make_sharded_infer {kind} "
                      f"launches {want}")
                with cudnn_deterministic():
                    e0, e1, got = plain(), plain(), sharded()
                hold_to_eager(f"dp make_sharded_infer {kind}",
                              ("fake_b", "fake_a", "recover_b"), got, e0,
                              e1, r32)
                del e0, e1, got
                dp_time(f"ResNet-9 {kind} inference {SIZE}² batch {n}",
                        {"sharded (world 1)": sharded,
                         "unsharded": plain}, "call")
        finally:
            sharding.close_mesh(mesh)
    print(f"[dp] phase 49 took {time.perf_counter() - t_phase!r} s",
          flush=True)


# Spatial sharding, UDA data parallelism, the native loader and the plain
# int8 convs (slice 18, phases 50-54). One card cannot run two NCCL ranks,
# so every path runs at world size 1 (NCCL, a file:// rendezvous), as phase
# 49 does; world sizes 2 and 4 are the CPU tests' (gloo,
# tests/test_torch_spatial*.py, tests/test_torch_uda_dp.py). Phase 50: the
# `local` generator of benchmarks/run_suite.py's p2phd1024 row (ngf 32,
# 1024², 3 global downs, 9 global blocks, 1 enhancer, 3 local blocks) and
# r2l_MSRB_7's UNet (64 features, 3 MSRB blocks, 512²), slab vs whole:
# fp32 (TF32 off) within SPATIAL_ABS, beside the JAX suite's spatial256 row
# (benchmarks/fidelity_r5.json, pixel L1 7.1e-7 over 8 virtual devices);
# bf16 ms a call and peak memory at SPATIAL_BATCHES.
SPATIAL_NETS = (("local 1024² (p2phd1024)", "local",
                 dict(ngf=32, n_downsample_global=3, n_blocks_global=9,
                      n_local_enhancers=1, n_blocks_local=3), 1024),
                ("UNet 512² (r2l_MSRB_7)", "UNet",
                 dict(ngf=64, n_blocks_global=3), 512))
SPATIAL_ABS, SPATIAL_BATCHES, SPATIAL_ITERS = 1e-4, (2, 4), 5
JAX_SPATIAL256_PIXEL_L1 = 7.1e-7
# Phase 51: the p2phd1024 step (num_D 3, batch 1) and the r2l_MSRB_7 step
# (P2P_TRAIN), with spatial_mesh against without, held and timed as phase
# 49 holds and times its steps; then both CLIs with --spatial_shard on
# SPATIAL_CLI_PAIRS synthetic 512² pairs (5 train steps), each a process.
SPATIAL_TRAIN = (("pix2pixHD local 1024² (p2phd1024), batch 1", "local",
                  dict(ngf=32, n_downsample_global=3, n_blocks_global=9,
                       n_local_enhancers=1, n_blocks_local=3, ndf=64,
                       n_layers_d=3, num_d=3, pool_size=0,
                       image_size=1024)),
                 ("pix2pixHD r2l_MSRB_7 512², batch 1", "UNet",
                  dict(P2P_TRAIN["UNet"], **P2P_TRAIN_COMMON)))
SPATIAL_CLI_PAIRS = 8
# Phase 52: R2LAE at r2l_MSRB_7's widths (ext_opt) and the image critic,
# 512², a batch of UDA_DP_BATCH, with the mesh against without.
UDA_DP_BATCH = 2
# Phase 53: the native loader against the PIL decode on LOADER_FRAMES
# synthetic 512² frames, the loader's N_THREADS threads, batches of
# LOADER_BATCH.
LOADER_FRAMES, LOADER_BATCH = 64, 8
# Phase 54: ops/quant.py's int8 ResNet-9 (64 features) at 256², batch 1.
QUANT = dict(features=64, blocks=9, size=256, batch=1, iters=10)


def no_launches(counters, label: str, fn):
    """``fn()`` with every launch counter at 0 before (``counted``); these
    paths launch no port kernel. Returns what ``fn`` returns."""
    out = []
    launches = counted(counters, lambda: out.append(fn()))
    check(not launches, f"{label} launches no kernel (got {launches})")
    return out[0]


def spatial_forward(dev, images, mesh, counters) -> None:
    """Phase 50: the slab forwards against the whole-image forwards."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference

    for label, net, kw, size in SPATIAL_NETS:
        x = images(SPATIAL_BATCHES[0], size)
        engs = [Pix2PixHDInference(net, **kw, compute_dtype=torch.float32,
                                   device=dev, spatial_mesh=m)
                for m in (None, mesh)]
        check(all(torch.equal(a, b) for a, b in zip(
            engs[0].G.parameters(), engs[1].G.parameters())),
            f"{label}: one set of seeded weights")
        with fp32_exact(), cudnn_deterministic():
            y0 = engs[0].infer_step(x)
            y1 = no_launches(counters, f"spatial {label}",
                             lambda: engs[1].infer_step(x))
        d = (y1 - y0).abs()
        print(f"[spatial] {label} batch {x.shape[0]} fp32 (TF32 off), slab "
              f"vs whole: max-abs {d.max().item()!r}, pixel L1 "
              f"{d.mean().item()!r} (JAX spatial256 over 8 virtual "
              f"devices: pixel L1 {JAX_SPATIAL256_PIXEL_L1!r}); tol "
              f"{SPATIAL_ABS}", flush=True)
        check(tuple(y1.shape) == tuple(y0.shape) and bool(
            torch.isfinite(y1).all()) and d.max().item() <= SPATIAL_ABS,
            f"spatial {label}: the slab forward is the whole one")
        del engs, y0, y1, d
        torch.cuda.empty_cache()
        engs = [Pix2PixHDInference(net, **kw, device=dev, spatial_mesh=m)
                for m in (None, mesh)]
        for n in SPATIAL_BATCHES:
            x = images(n, size)
            res = {}
            for name, k in (("unsharded", 0), ("sharded (world 1)", 1),
                            ("sharded (world 1) again", 1),
                            ("unsharded again", 0)):
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = cuda_ms(lambda: engs[k].infer_step(x), SPATIAL_ITERS)
                res[name] = (ms, (torch.cuda.max_memory_allocated() - base)
                             / 2 ** 20)
            print(f"[times] spatial {label} bf16 batch {n}: " + "; ".join(
                f"{k} {ms!r} ms a call, peak {mib:.0f} MiB above its inputs"
                for k, (ms, mib) in res.items()), flush=True)
        del engs
        torch.cuda.empty_cache()


def spatial_train(dev, mesh, counters) -> None:
    """Phase 51: the sharded train steps against the unsharded ones, and
    both CLIs with ``--spatial_shard``."""
    import tempfile

    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHD

    for label, net, cfg in SPATIAL_TRAIN:
        size = cfg["image_size"]
        radar, lidar = synthetic_pairs(1, size)
        lab, img = (torch.from_numpy(t).to(dev) for t in (radar, lidar))
        for cdt in (torch.float32, torch.bfloat16):
            engs = [Pix2PixHD(net, **cfg, compute_dtype=cdt, device=dev,
                              spatial_mesh=m) for m in (None, mesh)]
            sts = [e.init_state(0) for e in engs]

            def step(k):
                sts[k], m, _ = engs[k].train_step(sts[k], lab, None, img)
                return m, {"G": sts[k].opt_g, "D": sts[k].opt_d}

            if cdt == torch.float32:
                with fp32_exact(), cudnn_deterministic():
                    no_launches(counters, f"spatial step {label}",
                                lambda: dp_hold(f"spatial {label}, fp32",
                                                step))
            else:
                dp_time(f"spatial {label} bf16",
                        {"sharded (world 1)": lambda: step(1),
                         "unsharded": lambda: step(0)})
                for name, k in (("sharded (world 1)", 1), ("unsharded", 0)):
                    wall, busy, top = profile_top(lambda: step(k))
                    print(f"[profile] spatial {label} bf16 {name}: wall "
                          f"{wall!r} ms, device busy {busy!r} ms; top "
                          "device time (ms): " + "; ".join(
                              f"{n[:48]} {t!r}" for t, n in top), flush=True)
            del engs, sts
            torch.cuda.empty_cache()

    opt_txt = os.path.join(ROOT, "checkpoints", "r2l_MSRB_7", "opt.txt")
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        synthetic_tool().main(["--out", data, "--n", str(SPATIAL_CLI_PAIRS),
                               "--size", "512"])
        common = ["--load_opt", opt_txt, "--dataroot", data,
                  "--checkpoints_dir", ck, "--spatial_shard"]
        for app, extra in (
                ("p2phd_train", ["--niter", "1", "--niter_decay", "0",
                                 "--print_freq", "2"]),
                ("p2phd_test", ["--phase", "test", "--how_many", "2",
                                "--results_dir", os.path.join(tmp, "res")])):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", f"cistar_tpu_torch.apps.{app}",
                 *common, *extra], cwd=ROOT, capture_output=True, text=True)
            dt = time.perf_counter() - t0
            print(f"[spatial cli] {app} --spatial_shard: exit "
                  f"{out.returncode} in {dt:.1f} s (a process of its own); "
                  f"it printed:\n{out.stdout.strip()[-1500:]}", flush=True)
            check(out.returncode == 0, f"{app} --spatial_shard ran: "
                  f"{out.stderr.strip()[-2000:]}")
        run = os.path.join(ck, "r2l_MSRB_7")
        web = os.path.join(tmp, "res", "r2l_MSRB_7", "test_latest")
        check(os.path.exists(os.path.join(run, "latest_net_G.npz")),
              "p2phd_train --spatial_shard saved G")
        pngs = [f for f in os.listdir(os.path.join(web, "images"))
                if f.endswith("_synthesized_image.png")]
        check(os.path.exists(os.path.join(web, "index.html"))
              and len(pngs) == 2, "p2phd_test --spatial_shard wrote its "
              "gallery")


def uda_dp(dev, mesh, counters) -> None:
    """Phase 52: R2LAE and the image critic with the mesh against without;
    ``p2phd_train --uda`` in the NCCL group."""
    import tempfile

    import torch

    from cistar_tpu_torch.apps import p2phd_train
    from cistar_tpu_torch.engines.factory import create_uda_model

    size = EXT_SIZE
    radar, lidar = synthetic_pairs(UDA_DP_BATCH, size)
    r, li = (torch.from_numpy(t).to(dev) for t in (radar, lidar))
    for label, flags in (("R2LAE (r2l_MSRB_7)", ["--training_module",
                                                  "autoencoder"]),
                         ("R2LImageCritic (ngf 16, 5 layers)", [])):
        for fp16 in (False, True):
            opt = ext_opt("--uda", *flags, *(["--fp16"] if fp16 else []))
            engs = [create_uda_model(opt), create_uda_model(opt, mesh)]
            sts = [e.init_state(0) for e in engs]

            def step(k):
                if type(engs[k]).__name__ == "R2LImageCritic":
                    sts[k], m = engs[k].train_step(sts[k], li, r)
                    return m, {"D": sts[k].opt}
                sts[k], m, _ = engs[k].train_step(sts[k], r, li)
                return m, sts[k].opts

            if not fp16:
                with fp32_exact(), cudnn_deterministic():
                    no_launches(counters, f"UDA DP {label}",
                                lambda: dp_hold(f"UDA {label} {size}² batch "
                                                f"{UDA_DP_BATCH}, fp32",
                                                step))
            else:
                dp_time(f"UDA {label} {size}² batch {UDA_DP_BATCH} --fp16",
                        {"sharded (world 1)": lambda: step(1),
                         "unsharded": lambda: step(0)})
            del engs, sts
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        synthetic_tool().main(["--out", data, "--n", str(P2P_CLI_PAIRS),
                               "--size", str(size)])
        for module, labels in (("discriminator", ("img_D",)),
                               ("autoencoder", tuple(
                                   lab for lab, _ in p2phd_train.UDA_LABELS))):
            args = ["--load_opt", os.path.join(ROOT, "checkpoints",
                                               "r2l_MSRB_7", "opt.txt"),
                    "--uda", "--dataroot", data, "--checkpoints_dir", ck,
                    "--device", dev.type, "--niter", "1", "--niter_decay",
                    "0", "--print_freq", "2", "--training_module", module]
            t0 = time.perf_counter()
            no_launches(counters, f"--uda {module}",
                        lambda: p2phd_train.main(args))
            dt = time.perf_counter() - t0
            for lab in labels:
                check(os.path.exists(os.path.join(
                    ck, "r2l_MSRB_7", f"latest_net_{lab}.npz")),
                    f"--uda {module} in the NCCL group wrote {lab}")
            print(f"[uda dp] p2phd_train --uda --training_module {module} in "
                  f"a {torch.distributed.get_backend()} group of "
                  f"{torch.distributed.get_world_size()}: one epoch in "
                  f"{dt:.1f} s", flush=True)


def spatial_path(dev, images, counters) -> None:
    """Phases 50-52 in one NCCL group of one."""
    import tempfile

    import torch

    from cistar_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = sharding.make_mesh(dev, 0, 1,
                                  "file://" + os.path.join(tmp, "rendezvous"))
        try:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            check(mesh.grouped and torch.distributed.get_backend() == backend,
                  f"a {backend} group of one")
            spatial_forward(dev, images, mesh, counters)
            print(f"[spatial] phase 50 done at "
                  f"{time.perf_counter() - t_phase!r} s", flush=True)
            spatial_train(dev, mesh, counters)
            print(f"[spatial] phase 51 done at "
                  f"{time.perf_counter() - t_phase!r} s", flush=True)
            uda_dp(dev, mesh, counters)
        finally:
            sharding.close_mesh(mesh)
    print(f"[spatial] phases 50-52 took {time.perf_counter() - t_phase!r} s",
          flush=True)


def loader_path() -> None:
    """Phase 53: the native PNG loader against the PIL decode, on the
    card machine's host."""
    import tempfile

    import numpy as np

    from cistar_tpu_torch.data import datasets, native_loader
    from cistar_tpu_torch.data import transforms as T

    size = 512
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_tool().main(["--out", tmp, "--n", str(LOADER_FRAMES),
                               "--size", str(size)])
        paths = sorted(
            os.path.join(tmp, "radar", f)
            for f in os.listdir(os.path.join(tmp, "radar")))
        batches = [list(range(i, min(i + LOADER_BATCH, len(paths))))
                   for i in range(0, len(paths), LOADER_BATCH)]

        def pil(idx):
            return np.stack([T.normalize(T.pil_to_array(
                T.load_image(paths[i], "L"))).astype(np.float32)
                for i in idx])

        t0 = time.perf_counter()
        for b in batches:
            ref = pil(b)
        pil_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            ldr = native_loader.NativePngLoader(paths, size)
            build_s = time.perf_counter() - t0
        except (OSError, subprocess.CalledProcessError) as e:
            import ctypes.util

            ds = datasets.make_cyclegan_dataset(tmp, size, False, "test")
            print(f"[loader] the native library does not build on this host "
                  f"({e!r}; png.h {os.path.exists('/usr/include/png.h')}, "
                  f"libpng {ctypes.util.find_library('png')!r}); "
                  "make_cyclegan_dataset serves "
                  f"{type(ds).__name__}; PIL decode "
                  f"{len(paths) / pil_s!r} images/s", flush=True)
            check(type(ds).__name__ == "CycleGANImageDataset",
                  "the PIL fallback serves without the native library")
            return
        ldr.get_batch(batches[0])          # warm: threads, page cache
        t0 = time.perf_counter()
        for b in batches:
            got = ldr.get_batch(b)
        nat_s = time.perf_counter() - t0
        err = float(np.abs(got - ref).max())
        ds = datasets.make_cyclegan_dataset(tmp, size, False, "test")
        print(f"[loader] {LOADER_FRAMES} frames {size}², batches of "
              f"{LOADER_BATCH}: native ({native_loader.N_THREADS} threads, built in "
              f"{build_s:.1f} s) {len(paths) / nat_s!r} images/s, PIL decode "
              f"(one thread, the PIL dataset's) {len(paths) / pil_s!r} "
              f"images/s; last batch native vs PIL max-abs {err!r}; "
              f"make_cyclegan_dataset serves {type(ds).__name__} "
              f"({os.cpu_count()} host cores)", flush=True)
        check(err <= 1e-5, "the native loader decodes as PIL does")
        check(type(ds).__name__ == "NativeCycleGANDataset",
              "make_cyclegan_dataset takes the native loader where it builds")


def quant_path(dev, images, counters) -> None:
    """Phase 54: ops/quant.py's int8 ResNet-9 on the card; every int32
    accumulator against the exact product of the same int8 operands on the
    CPU."""
    import torch

    from cistar_tpu_torch.models.cyclegan import ResnetGenerator
    from cistar_tpu_torch.ops import quant

    torch.manual_seed(0)
    gen = ResnetGenerator(1, 1, QUANT["blocks"], QUANT["features"]).to(dev)
    q = {k: {n: t.to(dev) for n, t in v.items()}
         for k, v in quant.quantize_conv_tree(gen).items()}
    x = images(QUANT["batch"], QUANT["size"])
    calls, int_matmul = [], quant.int_matmul

    def recording(a, b):
        out = int_matmul(a, b)
        calls.append((a.cpu(), b.cpu(), out.cpu()))
        return out

    quant.int_matmul = recording
    try:
        y = no_launches(counters, "ops/quant.py", lambda: (
            quant.resnet_generator_int8_apply(q, x, QUANT["blocks"])))
    finally:
        quant.int_matmul = int_matmul
    # |acc| ≤ 127² · K < 2^53: the fp64 product of the operands is exact
    bad = [i for i, (a, b, acc) in enumerate(calls)
           if not torch.equal(torch.mm(a.double(), b.double()).long(),
                              acc.long()) or acc.dtype != torch.int32]
    with fp32_exact():
        ref = gen(x)
    ms = cuda_ms(lambda: quant.resnet_generator_int8_apply(
        q, x, QUANT["blocks"]), QUANT["iters"])
    print(f"[quant] ops/quant.py ResNet-9 {QUANT['features']} features "
          f"{QUANT['size']}² batch {QUANT['batch']}: {len(calls)} int32 "
          f"products (torch._int_mm), {len(calls) - len(bad)} equal to the "
          f"CPU's exact product of the same operands; vs the fp32 forward "
          f"max-abs {(y - ref).abs().max().item()!r}; {ms!r} ms a call",
          flush=True)
    check(len(calls) == 2 * QUANT["blocks"] + 8 and not bad,
          f"the int32 accumulators bit for bit (differ at {bad})")
    check(bool(torch.isfinite(y).all()), "the int8 forward is finite")


def checkpoint_path(dev, counters) -> None:
    """Phase 47: the reference's ``.pth`` files converted by
    ``apps/convert_checkpoint.py`` and served by both test CLIs, each step a
    process of its own."""
    import tempfile

    import numpy as np
    import torch

    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.core import convert as cv
    from cistar_tpu_torch.core import convert_models as cm
    from cistar_tpu_torch.core.torch_import import load_state_dict
    from cistar_tpu_torch.data.datasets import (CycleGANImageDataset,
                                                Radar2LidarDataset)
    from cistar_tpu_torch.utils.fidelity import BUDGET, fidelity_metric

    tw = tool("reference_twins")
    size = CKPT_SIZE
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        run, mdir = os.path.join(ck, "r2l_MSRB_7"), os.path.join(tmp, "cg")
        for d in (run, mdir):
            os.makedirs(d)
        synthetic_tool().main(["--out", data, "--n", str(CKPT_PAIRS),
                               "--size", str(size)])
        # the reference's files: (path, family flags, twin, port state_dict)
        unet = tw.seeded(tw.UNetHD, n_res=CKPT_UNET["n_res"],
                         nf=CKPT_UNET["nf"])
        files = {os.path.join(run, "latest_net_G"): (
            ["--family", "p2phd-g", "--netG", "UNet", "--n_blocks_global",
             str(CKPT_UNET["n_res"])], unet,
            lambda sd: cm.p2phd_generator_from_pth(
                sd, "UNet", n_blocks_global=CKPT_UNET["n_res"]))}
        for seed, net in enumerate(("netG_A2B", "netG_B2A", "netD_A",
                                    "netD_B"), 1):
            gen = net.startswith("netG")
            files[os.path.join(mdir, net)] = (
                ["--family", "cyclegan-g" if gen else "cyclegan-d",
                 "--gen_type", "bilinear_content", "--n_residual_blocks",
                 str(CKPT_BIL["n_res"])],
                tw.seeded(tw.SkipDecoderG, seed, kind="bilinear",
                          n_res=CKPT_BIL["n_res"], nf=CKPT_BIL["nf"])
                if gen else tw.seeded(tw.CycleD, seed),
                (lambda sd: cm.cyclegan_generator_from_pth(
                    sd, "bilinear_content", CKPT_BIL["n_res"])) if gen
                else cm.cyclegan_discriminator_from_pth)
        for base, (_, twin, _) in files.items():
            torch.save(twin.state_dict(), base + ".pth")
        # convert each file, the processes side by side
        t0 = time.perf_counter()
        procs = {base: subprocess.Popen(
            [sys.executable, "-m", "cistar_tpu_torch.apps.convert_checkpoint",
             *flags, "--in_pth", base + ".pth", "--out", base + ".npz"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for base, (flags, _, _) in files.items()}
        for base, p in procs.items():
            out = p.communicate()[0]
            check(p.returncode == 0, f"convert_checkpoint {base}: {out}")
            print(f"[checkpoint import] {out.strip()}", flush=True)
        print(f"[checkpoint import] {len(procs)} convert_checkpoint "
              f"processes side by side in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for base, (_, _, from_pth) in files.items():
            want = from_pth(load_state_dict(base + ".pth"))
            tree = ckpt.load_pytree(base + ".npz")
            got = (cv.unet_generator_hd_from_jax(tree) if "net_G" in base
                   else cv.generator_from_jax(tree) if "netG" in base
                   else cv.patch_discriminator_from_jax(tree))
            check(sorted(got) == sorted(want) and all(
                torch.equal(got[k], want[k]) for k in want),
                f"{os.path.basename(base)}.npz is what *_from_pth loads")
        print(f"[checkpoint import] each .npz equals its *_from_pth "
              f"state_dict key for key, bit for bit", flush=True)

        # the test CLIs on the converted files
        p2p_args = ["--load_opt", os.path.join(ROOT, "checkpoints",
                                               "r2l_MSRB_7", "opt.txt"),
                    "--r2l_res", str(size), "--ngf", str(CKPT_UNET["nf"]),
                    "--n_blocks_global", str(CKPT_UNET["n_res"]),
                    "--dataroot", data, "--checkpoints_dir", ck,
                    "--results_dir", os.path.join(tmp, "res"), "--phase",
                    "test", "--how_many", str(CKPT_FRAMES), "--device",
                    dev.type]
        cg_args = ["--dataroot", data, "--model_dir", mdir, "--size",
                   str(size), "--gen_type", "bilinear_content", "--device",
                   dev.type]
        k8 = {"msrb_branch_int8": 4 * CKPT_UNET["n_res"] * CKPT_FRAMES}
        # 3 generator calls a frame (fake_B, fake_A, recover_B), each 6 K5
        # and 1 K6
        k56 = {"atrous_resblock_int8": 6 * 3 * CKPT_FRAMES,
               "multi_atrous_stage_int8": 3 * CKPT_FRAMES}
        p2p, cg = "cistar_tpu_torch.apps.p2phd_test", \
            "cistar_tpu_torch.apps.cyclegan_test"
        plan = {"p2phd_test --data_type 32": (
                    p2p, p2p_args + ["--data_type", "32"], False, {}),
                "p2phd_test --data_type 8": (
                    p2p, p2p_args + ["--data_type", "8"], True, k8),
                "cyclegan_test --dtype fp32": (
                    cg, cg_args + ["--dtype", "fp32"], False, {}),
                "cyclegan_test --engine int8": (
                    cg, cg_args + ["--engine", "int8"], True, k56)}
        t0 = time.perf_counter()
        results = run_clis({k: v[:3] for k, v in plan.items()}, tmp)
        runs = {}
        for label, (dt, calls, launches) in results.items():
            want = plan[label][3]
            nz = {k: v for k, v in launches.items() if v}
            print(f"[checkpoint cli] {label}: {len(calls)} frames of "
                  f"{size}² in {dt:.1f} s (its own process, start-up "
                  f"included, the four side by side); launches {nz}",
                  flush=True)
            check(len(calls) == CKPT_FRAMES, f"{label}: {CKPT_FRAMES} calls")
            check(all(launches[k] == want.get(k, 0) for k in launches),
                  f"{label} launches {want} and no other kernel")
            runs[label] = calls
        print(f"[checkpoint cli] the four CLI processes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # fp32: the twins' forwards of the same frames on the card, with
        # nn.InstanceNorm2d and with the port's one-pass moments
        r2l = Radar2LidarDataset(data, size=size, mode="test")
        cgd = CycleGANImageDataset(data, size=size, mode="test")
        nets = {"p2phd_test": unet, "A2B": files[os.path.join(
            mdir, "netG_A2B")][1], "B2A": files[os.path.join(mdir,
                                                             "netG_B2A")][1]}
        worst = {}
        with fp32_exact():
            for kind, tol in (("its nn.InstanceNorm2d", CKPT_REF_ABS),
                              ("one-pass instance norms", CKPT_FP32_ABS)):
                tn = {k: (tw.with_one_pass_norms(m) if kind.startswith(
                    "one-pass") else m).to(dev) for k, m in nets.items()}

                def hold(lab, t, y):
                    err = float(np.abs(tw.nhwc(t).cpu().numpy() - y).max())
                    key = (lab, kind, tol)
                    worst[key] = max(worst.get(key, 0.0), err)

                for i, call in enumerate(runs["p2phd_test --data_type 32"]):
                    x, y = call[0], call[-1]
                    check(np.array_equal(x[0], r2l[i]["label"]),
                          "p2phd_test read the test frame")
                    hold("p2phd_test", tn["p2phd_test"](
                        tw.nchw(x).to(dev)), y)
                for i, call in enumerate(runs["cyclegan_test --dtype fp32"]):
                    a, b, fake_b, fake_a, rec_b = call
                    check(np.array_equal(b[0], cgd[i]["B"]),
                          "cyclegan_test read the test frame")
                    tfa = tn["B2A"](tw.nchw(b).to(dev))
                    hold("cyclegan_test fake_B", tn["A2B"](
                        tw.nchw(a).to(dev)), fake_b)
                    hold("cyclegan_test fake_A", tfa, fake_a)
                    hold("cyclegan_test recover_B",
                         tn["A2B"]((tfa - 0.5) / 0.5), rec_b)
        for (lab, kind, tol), err in worst.items():
            print(f"[checkpoint cli] {lab} fp32 vs the twin's fp32 forward "
                  f"({kind}) on the card, TF32 off: max-abs {err!r} (tol "
                  f"{tol})", flush=True)
            check(err <= tol, f"{lab}: the converted checkpoint serves the "
                  f"twin's function ({kind})")
        # int8 against the same CLI's fp32, in the LPIPS metric
        for lab, fp32_run, int8_run, outs in (
                ("p2phd_test", "p2phd_test --data_type 32",
                 "p2phd_test --data_type 8", {"fake": -1}),
                ("cyclegan_test", "cyclegan_test --dtype fp32",
                 "cyclegan_test --engine int8",
                 {"fake_B": 2, "fake_A": 3, "recover_B": 4})):
            for o, j in outs.items():
                ref, y = (torch.from_numpy(np.concatenate(
                    [c[j] for c in runs[r]])).to(dev)
                    for r in (fp32_run, int8_run))
                with fp32_exact():
                    mt = fidelity_metric(ref, y)
                print(f"[checkpoint cli] {lab} int8 {o} vs its fp32, "
                      f"{CKPT_FRAMES} frames: lpips_metric "
                      f"{mt['lpips_metric']!r}, pixel_l1 {mt['pixel_l1']!r} "
                      f"(budget {BUDGET})", flush=True)
                check(mt["lpips_metric"] < BUDGET,
                      f"{lab} int8 {o} within the LPIPS budget")
    print(f"[checkpoint import] phase 47 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device, nothing run")
    sys.path.insert(0, ROOT)
    from cistar_tpu_torch.kernels import build
    from cistar_tpu_torch.kernels import fused_conv as kf
    from cistar_tpu_torch.kernels import head_cout1 as kh
    from cistar_tpu_torch.kernels import in_act as kn
    from cistar_tpu_torch.kernels import int8_atrous as ka
    from cistar_tpu_torch.kernels import int8_msrb as km
    from cistar_tpu_torch.kernels import int8_resblock as kr
    from cistar_tpu_torch.kernels import int8_tiled as kt

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    print(f"[build] csrc/*.cu -> sm_90a in {build.build_all():.1f} s",
          flush=True)
    for src, kernels in (
            *((s, ("wg_conv_kernel",)) for s in (
                "int8_resblock", "conv3x3_in_act", "int8_tiled", "int8_msrb")),
            ("int8_atrous", ("wg_conv_kernel", "wg_branch_kernel")),
            ("head_cout1", ("head_tc_kernel", "head_kernel", "sums_kernel",
                            "stats_kernel")),
            ("in_act", ("in_act_cluster_kernel", "in_act_kernel"))):
        for kernel in kernels:
            for line in build.ptxas_report(src, kernel):
                print(f"[ptxas] {src}: {line}", flush=True)
                check(" 0 bytes spill stores, 0 bytes spill loads" in line
                      or "spill" not in line, f"{src} {line}: no spills")
    # K9's bf16 kernel runs on the tensor cores: HMMA in its SASS
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
         "-sass", str(build.lib_path("head_cout1"))], capture_output=True,
        text=True, check=True).stdout
    fun, hmma = "", 0
    for line in sass.splitlines():
        if "Function :" in line:
            fun = line
        elif "head_tc_kernel" in fun and "HMMA" in line:
            hmma += 1
    print(f"[sass] head_cout1: {hmma} HMMA instructions in head_tc_kernel",
          flush=True)
    check(hmma > 0, "K9's bf16 kernel runs HMMA")

    cpu_gen = torch.Generator().manual_seed(0)

    def images(n: int, size: int) -> torch.Tensor:
        return (torch.rand(n, size, size, 1, generator=cpu_gen) * 2
                - 1).to(dev)

    counters = (kr, ka, kt, km, kf, kn, kh)
    rows = resnet_path(dev, images, counters)
    rows += bilinear_path(dev, images, counters)
    rows += p2phd_path("global", images, counters)
    rows += p2phd_path("UNet", images, counters)
    rows += fused_path(dev, images, counters)
    rows += bn_local_path(images, counters)
    with torch.enable_grad():
        train_path(dev, counters)
    family_path(dev, images, counters)
    with torch.enable_grad():
        family_train_path(dev, counters)
    gatys_path(dev, counters)
    p2phd_train_path(dev, counters)   # train_step enables grad itself
    extended_path(dev, counters)
    fidelity_path(dev, counters)
    checkpoint_path(dev, counters)
    export_path(dev, images, counters)
    dp_path(dev, images, counters)
    spatial_path(dev, images, counters)
    loader_path()
    quant_path(dev, images, counters)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
