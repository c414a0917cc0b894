#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``comfyui_frame_interpolation_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each; any failed phase raises and the exit code is not 0:

1. device  -- a CUDA device, its name and power limit (``nvidia-smi``);
2. build   -- the warp and splat kernels built from ``csrc/warp.cu`` and
   ``csrc/softsplat.cu``, one ``nvcc`` each, started together; each kernel's
   registers and spills from ``-Xptxas -v``;
3. kernel  -- the warp kernels against their plain PyTorch twin on the card,
   bit for bit (max abs err 0), on the flow cases of ``tests/warp_cases.py``
   (border and zeros, f32 and bf16, at 256x512; tiles whose tap box
   overflows, a 68x92 frame, M2M's widths C = 32 to 384 in zeros mode): the
   kernel ``ops.warp.warp`` routes each case to, and K1 (the tiled kernel)
   forced on every case; and K1, as routed, at the main
   paths' shapes: RIFE's ``[16, 1088, 1920, 7]`` bf16 with f32 and bf16 flow
   and ``[16, 1088, 1920, 3]``, M2M's ``[8, 1088, 1920, 3]`` in zeros mode,
   EISAI's Lab warp ``[1, 540, 960, 3]`` f32 with f32 flow in border mode;
4. node    -- the RIFE VFI node (``rife47.pth``, fast mode, no ensemble,
   random weights from seed 0) on 4 frames of 540x960, multiplier 2, batch 2,
   on the card in fp32 (TF32 off) and bf16, each >= 40 dB PSNR against the
   same node on the CPU (plain twin) in fp32; K1 must have been launched
   exactly 4 times per forward call; then the same for
   ``sudo_rife4_269.662_testV1_scale1.pth`` (arch 4.0), ``fast_mode`` True
   and False, with the K1 and wide launches of ``rife.warps_per_forward``
   for each forward (the Contextnet's 4 feature warps take the wide
   kernel), and one fp32 and one bf16 forward whose stage-1 flow (block 1's
   head scaled up) triggers 4.0's restart with doubled scales, checked the
   same way; every warp those 4.0 runs launched is launched again on a copy
   of its inputs and held bit for bit against the plain twin, and the wide
   ones must be the Contextnet's ``[4, 288, 480, 16]`` to ``[4, 36, 60,
   128]`` (540 rows padded to 576), border, in f32 and bf16;
5. golden  -- the port on the card (fp32, TF32 off) against the JAX RIFE 4.7
   output stored in ``tests/fixtures/torch_port_rife47_golden.npz``, >= 40 dB;
6. timing  -- RIFE 4.7 1080p 2x bf16 batch 8 (the configuration of
   ``bench.py:bench_rife``) in frames/s, a ``torch.profiler`` top 10 of one
   forward with K1's device ms and share, and at ``[16, 1088, 1920, 7]`` bf16
   with f32 flow the ms per call of K1, the plain twin and ``F.grid_sample``
   on a precomputed grid (the library yardstick, which the port never
   calls), in turns;
7. splat   -- the splat kernel against its plain twin on the card, on the
   splat cases of ``tests/warp_cases.py`` (256x512 and the narrow frames, f32
   and bf16; flows that pile 16 sources on a target, rough flow) and at the
   M2M path's shape ``[16, 1088, 1920, 4]`` bf16.
   Tolerances: f32 atol 1e-5 on values in [0, 1] (fp32 atomics sum in an
   order that changes from run to run), bf16 one ulp of the output (2**-8 to
   2**-7 of the value);
8. m2m     -- the M2M VFI node (``M2M.pth``, random weights from seed 0) on 4
   frames of 270x480, multipliers 2 and 3, batch 2, on the card in fp32 (TF32
   off) and bf16, each >= 40 dB against the same node on the CPU in fp32;
   original frames pass through bit for bit; exactly 1 splat launch per infer
   call, and per reuse call 4 warp launches on K1 and 16 on the
   wide kernel, as ``models.m2m.warps_per_reuse`` derives them from
   ``warp_kernel.route``;
9. golden  -- the port's M2M on the card (fp32, TF32 off) against the JAX M2M
   output stored in ``tests/fixtures/torch_port_m2m_golden.npz``, >= 40 dB;
10. timing -- M2M 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_m2m``) in frames/s through ``make_model_fn``, reuse and
   infer ms through ``make_pair_fns``, the splat kernel's ms per call at
   ``[16, 1088, 1920, 4]`` bf16 beside the plain twin's, and a
   ``torch.profiler`` top 10 of one M2M forward with each kernel's device ms
   and share (the splat's ms there is its time on M2M's rough flows).

11. wide     -- the wide-channel warp kernel against the plain twin on the
   card, bit for bit (max abs err 0), on the wide cases of
   ``tests/warp_cases.py`` (C = 16, 18, 20, 21, 24, 32, 36, 44, 54, 64, 192,
   448, 960, 46: every vector width the kernel picks; a channel slice whose
   taps start off 16 bytes; extreme and non-finite flow; border and zeros,
   f32 and bf16, at 128x256) and at FILM's level-0 feature warp
   ``[4, 1080, 1920, 64]`` bf16, where K1 must agree too,
   and, as routed, at M2M's feature warps ``[2, 544, 960, 48]`` and ``[2,
   68, 120, 384]`` bf16 in zeros mode, and at RIFE 4.0's Contextnet warps
   ``[4, 288, 480, 16]``, ``[4, 144, 240, 32]``, ``[4, 72, 120, 64]`` and
   ``[4, 36, 60, 128]`` in border mode, f32 and bf16 (flow in the same
   dtype);
12. film     -- the FILM VFI node (``film_net_fp32.pt``, random weights from
   seed 0) on 4 frames of 135x240 (the CPU leg's 7 batch-2 fp32 calls take
   ~25-39 s at 270x480 on 8 cores), multipliers 2 and 4, batch 2, on the card
   in fp32 (TF32 off) and bf16, each >= 40 dB against the same node on the
   CPU in fp32; original frames pass through bit for bit; exactly 11 wide and
   5 K1 warp launches per forward call (``film.WARPS_PER_CALL``);
13. golden   -- the port's FILM on the card (fp32, TF32 off) against the JAX
   FILM output stored in ``tests/fixtures/torch_port_film_golden.npz``,
   >= 40 dB;
14. timing   -- FILM 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_film``) in frames/s, each stage's ms, the wide kernel's,
   K1's, the plain twin's and ``F.grid_sample``'s ms per
   call on the same tensors at ``[4, 1080, 1920, 64]`` and ``[4, 135, 240,
   960]`` bf16, and a ``torch.profiler`` top 10 of one FILM forward with the
   warp kernels' device ms and shares and the idle share.
15. gsplat    -- the splat kernel against its plain twin at GMFSS Fortuna's
   widths, C = 4, 65, 129 and 193 (``[1, 544, 960, 4]``, ``[1, 544, 960,
   65]``, ``[1, 272, 480, 129]``, ``[1, 136, 240, 193]``: one direction of
   a 1080p batch-1 infer), f32 and bf16, on smooth flow (tolerances as in
   phase 7) and on the eight ``"soft"``-mode inputs that one GMFSS 1080p
   bf16 forward (random weights, rough flows) hands the kernel (bf16 as
   captured: one ulp; cast to f32: 1e-5 of the output's largest magnitude,
   since ``exp(metric)`` scales the values up to ~150); and the ``softsplat``
   wrapper on the card against the CPU for every mode and eps variant and
   every ``function_softsplat`` name, f32 atol 1e-5;
16. gmfss     -- the GMFSS Fortuna VFI node, ``GMFSS_fortuna`` and
   ``GMFSS_fortuna_union`` (random weights from seed 0), on 4 frames of
   135x240, multipliers 2 and 3, batch 2, on the card in fp32 (TF32 off) and
   bf16, each >= 40 dB against the same node on the CPU in fp32; original
   frames pass through bit for bit; per reuse call exactly the K1 and wide
   launches of ``gmfss.warps_per_reuse``, per infer call the K1 launches of
   ``gmfss.warps_per_infer`` (the union's RIFE 4.6) and
   ``gmfss.splats_per_infer()`` splat launches;
17. golden    -- the port's GMFSS, base and union, on the card (fp32, TF32
   off) against the JAX outputs stored in
   ``tests/fixtures/torch_port_gmfss_golden.npz``, >= 40 dB;
18. timing    -- GMFSS 1080p 2x bf16 batch 1 (the configuration of
   ``bench.py:bench_gmfss``), base and union, in frames/s through
   ``make_model_fn``, reuse and infer ms through ``make_pair_fns``, a
   ``torch.profiler`` top 10 of one forward of each; the splat kernel's,
   the plain twin's ms per call on the captured inputs of each width, and
   the warp kernels', the twin's and ``F.grid_sample``'s at GMFSS's warp
   shapes (``[1, 136, 240, 128]`` wide, ``[1, 544, 960, 2]`` and ``[1,
   544, 960, 3]`` zeros, ``[2, 576, 960, 3]`` border), each with its bound.
19. esplat    -- the splat kernel against its plain twin at EISAI's widths,
   C = 6, 66, 258 and 514 (``[1, 540, 960, 6]``, ``[1, 128, 228, 66]``,
   ``[1, 64, 114, 258]``, ``[1, 32, 57, 514]``: one direction of a 540p
   batch-1 infer), f32 and bf16, on smooth flow (tolerances as in phase 15)
   and on the eight f32 ``"soft"``-mode inputs that one EISAI 540p bf16
   forward hands the kernel (as captured: 1e-5 of the output's largest
   magnitude; cast to bf16: one ulp); that forward's two K1 warps of the
   f32 Lab frames (``[1, 540, 960, 3]``, border, RAFT's flow plus the grid
   offsets) launched again on their inputs, bit for bit against the twin;
20. eisai     -- the EISAI VFI node (random weights from seed 0, the
   reference's 12 RAFT iterations) on 4 frames of 135x240 (the CPU leg at
   270x480 took ~20 s), multipliers 2 and 3, batch 2, on the card in
   fp32 (TF32 off) and bf16, each >= 40 dB against the same node on the CPU
   in fp32; original frames pass through bit for bit; no launch per reuse
   call, per infer call the K1 launches of ``eisai.warps_per_infer()`` and
   ``eisai.splats_per_infer()`` splat launches;
21. golden    -- the port's EISAI on the card (fp32, TF32 off) against the
   JAX output stored in ``tests/fixtures/torch_port_eisai_golden.npz``,
   >= 40 dB;
22. timing    -- EISAI 540x960 2x bf16 batch 1, 12 iterations (the
   configuration of ``bench.py:bench_eisai``), in frames/s through
   ``make_model_fn``, reuse and infer ms through ``make_pair_fns``, a
   ``torch.profiler`` top 10 of one forward; the splat kernel's and the
   plain twin's ms per call on the captured inputs of each width, with
   their bounds.
23. stmfnet   -- K1 and the kernel ``ops.warp.warp`` routes to against the
   plain twin, bit for bit, zeros mode, f32 and bf16, at STMFNet's 1080p
   backwarps (batch 1, both flow directions as one batch): the PWC features
   ``[2, 288, 480, 32]``, ``[2, 144, 240, 64]``, ``[2, 72, 120, 96]``, ``[2,
   36, 60, 128]`` (the wide kernel), the same with the ones channel appended
   (C = 33, 65, 97, 129: the JAX form), the frames ``[2, 1152, 1920, 3]``
   and ``[..., 4]``, and the f32 ones planes the port warps apart (K1); the
   splat kernel at ``[2, 1152, 1920, 4]`` f32 and bf16 on smooth flow
   (phase-7 tolerances); then every warp and splat that one 1080p bf16
   forward launched, again on a copy of its inputs; and the backwarp as JAX
   writes it (one launch on C + 1 channels) against the port's (C channels,
   then the f32 ones plane: two launches), in turns and by the kernels'
   device time in a profile, with their bounds;
24. stmfnet   -- the STMFNet VFI node (``stmfnet.pth``, random weights from
   seed 0) on 4 frames of 135x240 (reflect-padded to 256x256 inside),
   ``duplicate_first_last_frames`` False and True, batch 1, on the card in
   fp32 (TF32 off) and bf16, each >= 40 dB against the same node on the CPU
   in fp32; original frames pass through bit for bit; per forward call
   exactly the K1 and wide launches of ``stmfnet.warps_per_forward`` and
   ``stmfnet.splats_per_forward()`` splat launches;
25. golden    -- the port's STMFNet on the card (fp32, TF32 off) against the
   JAX output stored in ``tests/fixtures/torch_port_stmfnet_golden.npz``,
   >= 40 dB;
26. timing    -- STMFNet 1080p 2x bf16 batch 1 (the node's default batch) in
   frames/s, the peak device memory of one forward, each stage's ms
   (features, the three scale streams, the flow splat, the GridNet, the
   UNet3d), a ``torch.profiler`` top 10 of one forward with the idle share;
   AdaCoF's and the correlation's ms at the forward's shapes and their
   shares of it; the splat kernel's and the twin's ms on the forward's own splat input,
   and the warp kernels', the twin's and ``F.grid_sample``'s at STMFNet's
   warp shapes, each with its bound;
27. flavr     -- the FLAVR VFI node (``FLAVR_2x.pth``, random weights from
   seed 0) on 4 frames of 135x240 (edge-padded to 144x240 inside), as in
   phase 24 at batch 2, with no hand-kernel launch; the JAX golden
   (``tests/fixtures/torch_port_flavr_golden.npz``) through the node on the
   card, >= 40 dB; FLAVR 1080p 2x bf16 batch 2 (``bench.py:bench_flavr``'s
   configuration) in frames/s and peak memory, and a ``torch.profiler`` top
   10 of one forward.
28. slice8    -- K1 and the kernel ``ops.warp.warp`` routes to against the
   plain twin, bit for bit, border mode, f32 and bf16 (flow in the same
   dtype), at every warp shape of one 1080p forward of IFRNet S batch 4
   (the features ``[4, 136, 240, 54]``, ``[4, 272, 480, 36]``, ``[4, 544,
   960, 24]``, the frames ``[4, 1088, 1920, 3]``), IFUnet batch 2 (the
   frames ``[2, 1088, 1920, 3]``, the context ``[2, 272, 480, 32]``) and
   AMT-S batch 2 (``[2, 136, 240, 44]``, ``[2, 272, 480, 32]``, ``[2, 544,
   960, 20]``, the frames over 3 flows ``[6, 1088, 1920, 3]``); then at
   each, bf16, the routed kernel's, the twin's, ``F.grid_sample``'s and,
   where the wide kernel is routed, K1's ms in turns, their device ms, and
   the bound; the wide kernel forced at ``[2, 544, 960, C]``, C = 16, 18,
   21 (16-byte, 4-byte and element vectors in bf16), f32 and bf16, border
   and zeros, bit for bit; and every wide launch that the profiles of
   phases 10, 14, 18 and 26 recorded (M2M, FILM, GMFSS base and union,
   STMFNet), plus RIFE 4.0's Contextnet warps, in the layout the path gave
   it: bit for bit in f32 and bf16, border and zeros, then as recorded the
   wide kernel's and ``F.grid_sample``'s ms in turns, their device ms and
   the bound;
29. ifrnet    -- the IFRNet VFI node (random weights from seed 0) on 4
   frames of 135x240 (padded to 192x256 inside), S at x2 and x3 and L at
   x2, batch 4, on the card in fp32 (TF32 off) and bf16, each >= 40 dB
   against the same node on the CPU in fp32; original frames pass through
   bit for bit; each model call launches exactly the K1 and wide warps of
   ``ifrnet.warps_per_forward`` (counted per call); the JAX golden
   (``tests/fixtures/torch_port_ifrnet_golden.npz``) through the node on
   the card, >= 40 dB;
30. timing    -- IFRNet S 1080p 2x bf16 batch 4 (``bench.py:bench_ifrnet``'s
   configuration): its warps launched again on copies of their inputs
   against the twin (the shapes of phase 28), frames/s, peak memory of one
   forward, a ``torch.profiler`` top 10 with the idle share;
31. ifunet    -- the IFUnet VFI node as in phase 29, batch 2, without the
   ensemble at x2 and x3 and with it at x2; the golden;
32. timing    -- IFUnet 1080p 2x bf16 batch 2, no ensemble
   (``bench_ifunet``), as phase 30;
33. amt       -- the AMT VFI node as in phase 29 (the clip edge-padded to
   144x240, centred), batch 2, AMT-S at x2 and x3, AMT-L and AMT-G at x2;
   the golden;
34. timing    -- AMT-S 1080p (node-padded to 1088x1920) 2x bf16 batch 2
   (``bench_amt``), as phase 30, and the ms of the correlation lookup at the
   forward's shapes and the share of the forward its three calls take.

35. slice10  -- K1 and the kernel ``ops.warp.warp`` routes to against the
   plain twin, bit for bit, zeros mode, f32 and bf16, at ATM's and XVFI's
   1080p warp shapes: ATM base batch 1 (padded to 1088x1920) the fused
   features ``[1, 136, 240, 384]`` (lite ``224``) and the frames at 1/4, 1/2
   and 1; XVFI Vimeo batch 2 (padded to 1088x1920) the features ``[2, 544,
   960, 64]``, the frames and the f32 ones planes; ATM's enhanced halves as
   the model makes them, channel slices of ``[1, 136, 240, 768]``; then
   every warp of one ATM base 1080p bf16 forward and of one XVFI Vimeo
   reuse + infer launched again on copies of their inputs; K2 at XVFI's CFR
   splat ``[4, 544, 960, 3]`` f32 on smooth flow and on the input one bf16
   infer captured (f32, and cast to bf16); then each warp's device ms
   against its bound and ``F.grid_sample``, in turns (the two halves as
   views), and K2's against its bound and the twin;
36. atm       -- the ATM VFI node (random weights from seed 0) on 4 frames
   of 135x240 (edge-padded to 192x256 per call, centred), x2, batch 2, on
   the card in fp32 (TF32 off) and bf16 against the same node on the CPU in
   fp32, >= 40 dB: base with global motion "On" and "Off (fastest)", lite
   "On", base "On with Ensemble (slowest)" in fp32 only; original frames
   pass through bit for bit; each model call launches exactly
   ``atm.warps_per_forward``'s warps (counted per call); the JAX golden
   (``tests/fixtures/torch_port_atm_golden.npz``) through the node on the
   card, >= 40 dB;
37. timing    -- ATM base 1080p 2x bf16 batch 1 with global motion
   (``bench.py:bench_atm``'s configuration): frames/s, the peak memory of
   one forward, CUDA-event spans of the attention (scores, softmax, value
   product), the window partitions and the transformer blocks with their
   shares of the forward, and a ``torch.profiler`` top 10 with the idle
   share and the hand kernels' device ms against their bound;
38. xvfi      -- the XVFI VFI node as in phase 36, Vimeo at x2 and x3
   (zero-padded to 144x240) and X4K at x2 (zero-padded to 512x512), batch
   2, fp32 and bf16; each reuse call launches exactly
   ``xvfi.warps_per_reuse``'s warps, each infer call
   ``xvfi.warps_per_infer``'s and ``xvfi.splats_per_infer()`` splats; the
   JAX golden (``tests/fixtures/torch_port_xvfi_golden.npz``) through the
   node, >= 40 dB;
39. timing    -- XVFI Vimeo 1080p 2x bf16 batch 2 through ``make_pair_fns``
   (``bench.py:bench_xvfi``'s configuration): frames/s, reuse and infer ms,
   the peak memory of one reuse + infer and its profile as in phase 37; then
   X4K (the node's default checkpoint, padded to 1536x2048) 1080p 2x bf16
   batch 2: one forward's launches counted from 0 (exactly
   ``warps_per_reuse`` + ``warps_per_infer`` and one splat), each of its
   warps (the features ``[2, 384, 512, 64]`` down to ``[2, 24, 32, 64]``,
   the frames, every f32 ones plane) launched again on copies of their
   inputs against the twin, bit for bit, and its CFR splat ``[4, 384, 512,
   3]`` f32 against the twin (f32, and cast to bf16); then frames/s and the
   peak memory of one forward.

40. cain      -- the CAIN VFI node (random weights from seed 0) on 4 frames
   of 135x240 (reflect-padded to 256x256 inside, centred), x2 and x4, batch
   2, on the card in fp32 (TF32 off) and bf16, each >= 40 dB against the same
   node on the CPU in fp32; original frames pass through bit for bit; no
   hand-kernel launch; the JAX golden
   (``tests/fixtures/torch_port_cain_golden.npz``) through the node on the
   card, >= 40 dB;
41. timing    -- CAIN 1080p (padded to 1152x1920) 2x bf16 batch 4
   (``bench.py:bench_cain``'s configuration): frames/s, the peak memory of
   one forward, a ``torch.profiler`` top 10 with the idle share;
42. sepconv   -- the Sepconv VFI node as in phase 40 (edge-padded to 136x240
   inside), with the kernel heads conditioned as ``bench.py`` conditions
   them (last convolution times 0.05, bias 1/51); the golden
   (``tests/fixtures/torch_port_sepconv_golden.npz``); and ``sepconv_func``
   on the card against the CPU on one band of a 720p batch-2 call, f32,
   within 1e-6 of the sums' magnitude;
43. timing    -- Sepconv 720p 2x bf16 batch 2 (``bench.py:bench_sepconv``'s
   configuration) as phase 41, and ``sepconv_func``'s ms per call at that
   forward's shapes, on the device, against its bound, and the share of the
   forward its two calls take;
44. streaming -- the three executors over a ``memory_budget_bytes`` that
   forces them to stream, against the same clip resident: RIFE 4.7 bf16
   through ``run_plan`` (x4, 24 frames of 1080p, batch 8; also from a clip
   on the host), M2M fp32 through ``run_plan_pair_cached`` (x3, 8 frames of
   540x960, batch 2) and FLAVR bf16 through ``run_plan_window4`` (10 frames
   of 540x960, edge-padded to 544x960, batch 2). RIFE and FLAVR must be bit
   for bit; M2M's splat sums with float atomics, so it is held within the
   largest difference between five resident runs (both figures printed);
   each run's launches, counted from 0, must equal the resident run's, and
   its peak device memory must be lower.
45. momo      -- MoMo base (random weights from seed 0, 8 steps): ``apply``
   on 192x256 frames with noise drawn by numpy and injected, on the card in
   fp32 (TF32 off) >= 40 dB against the CPU in fp32; on the same weights with
   the latent head times 0.02 and the mask head times 0.1 (the predictions
   stay within ~0.2 and none clips, as ``tests/test_torch_momo.py``'s
   conditioned weights), the card in bf16 >= 30 dB against the CPU in fp32
   (as drawn, the predictions reach ~10 and mostly clip, and the rounding of
   the unclipped ones times 128 leaves bf16 at ~19 dB on either device,
   which tells a fault from rounding by nothing); the MOMO VFI node on 3 frames of 135x240
   (edge-padded to 192x256 inside) x2, bf16: the original frames bit for
   bit, the same seed twice the same frames, another seed other frames; the
   JAX golden (``tests/fixtures/torch_port_momo_golden.npz``: lite, 3 steps,
   numpy noise from its seed) through ``apply`` on the card in fp32, >= 40
   dB; no hand-kernel launch in any of it;
46. timing    -- MoMo base 1080p (edge-padded to 1088x1920) 2x bf16 b1, 8
   steps (``bench.py:bench_momo``'s configuration): frames/s, the peak memory
   of one forward, a ``torch.profiler`` top 10 with the idle share, and
   CUDA-event spans of the 8 denoiser passes against the synthesis;
47. utilities -- one ``run_plan`` (RIFE 4.7, bf16) on the card under
   ``CFI_PROFILE`` writes a Chrome trace that names a CUDA kernel; the RIFE
   node, given no params, loads ``rife47.pth.npz`` from a temporary
   ``ckpts_path`` (``utils.download``'s cache, found before any mirror): the
   weights as saved, bit for bit, one model over two calls, and fp32 frames
   (TF32 off) >= 60 dB against the same weights passed as params (another
   model object, whose convolutions cuDNN may run by other algorithms).
48. backward  -- the warp's backward kernel (``warp_bilinear_backward``)
   against its plain version (``ops.warp.warp_backward_torch``) on the card:
   the flow cases of ``tests/warp_cases.py`` at 256x512 and samples exactly
   on each bound (border and zeros, f32 and bf16); the cases its merges of
   neighbouring taps and its padded channels could break
   (``warp_cases.backward_cases``: C = 1 to 40, ragged 68x92 and 137x261
   frames, integer and half-pixel constant offsets, rough and
   discontinuous flow, a pile of 256 samples on each tap), each also
   without the image's gradient (the flow's bit for bit the same); NCHW
   planes, a channel slice with an odd start and an expanded ``grad_out``
   at C = 7 and 8; the wide widths C = 16 to 384 as ``channels_last`` views
   (a channel slice among them), and the four backward launches of one RIFE
   4.7 training step at phase 50's size, as the step hands them over.
   Tolerances: the image's gradient within 1e-5
   of the sum of each pixel's absolute contributions plus 1e-6 (f32
   atomics in changing order, in both versions), the flow's within 1e-5 of
   its largest magnitude plus 1e-6 (channel sums in another order); bf16 one
   ulp of the output more;
49. train     -- one ``parallel.make_train_step`` step of RIFE 4.7 (random
   weights from seed 0, L1 loss, Adam 1e-4) at b2 x 256x256 f32, TF32 off:
   on the card through the kernels against the same step on the card with
   RIFE's warps calling the plain twin (cuDNN's deterministic algorithms in
   both): the loss equal, every gradient within 1e-4 of its tensor's
   largest; and against the CPU (the plain twins): the loss within 1e-5,
   every gradient within 5e-2 of its tensor's largest and 5e-3 of the
   largest of all (gradients whose sums cancel, and the warps' gradient in
   the flow, which jumps where a sample crosses a pixel, meet forward
   values ~1e-7 apart: measured 1.78e-2 and 1.72e-3; two runs of one step on
   the card alone with cuDNN's default algorithms, also run and printed
   here, differ by up to 5.4e-2 and 7.5e-3), the updates within 1e-7 (1e-3 of the learning rate, plus
   one f32 ulp of a parameter in [1, 2)) where the gradient is over half
   its tensor's largest (Adam's first step is about -lr * sign(g)); the
   card's step launches K1 4 times and the backward kernel 4 times (no
   other count passes), and no CUDA warp that needs a gradient reaches the
   plain twin;
50. timing    -- RIFE 4.7 training at b16 x 224x224 (the ECCV2022-RIFE
   recipe's crops and batch; padded to 256x256), Adam 1e-4, f32 (TF32 at
   torch's defaults) and bf16 (parameters in bf16): steps/s and samples/s
   as the median of 2 windows of 10 steps after 3, the two dtypes in turns,
   with the windows' spread and whether it resolves the two dtypes apart;
   the peak memory of one step, a ``torch.profiler`` top 10 of one f32 step
   with the idle share and the backward kernel's device ms and share; at
   the step's warp shapes, ``[32, 256, 256, 7]`` f32 and bf16 and ``[32,
   256, 256, 3]`` f32 without the image's gradient, and at ``[16, 1088,
   1920, 7]`` f32 (the flow in the image's dtype) the backward op's ms, the
   kernel's device ms, its bound (grad_out, img and flow read once, grad_img
   and grad_flow written once in their dtypes),
   ``aten.grid_sampler_2d_backward``'s ms (the library yardstick, which the
   port never calls) and the plain version's ms, in turns;
51. parallel  -- ``parallel.make_mesh()`` on the card (1 x 1 on one card);
   RIFE 4.7 bf16 through ``make_sharded_model_fn`` and ``run_plan``, bit for
   bit with the unsharded run on a 1x1 mesh, and on a 2-way mesh of logical
   replicas of the card (the batch split, run shard by shard and gathered)
   bit for bit with the unsharded run at batch 1 (cuDNN deterministic); M2M
   fp32 through ``make_sharded_pair_fns`` and ``run_plan_pair_cached``, on
   the 1x1 mesh within the spread of three unsharded runs (the splat's float
   atomics), on the 2-way mesh within 1e-5 of the unsharded run at batch 1
   (TF32 off, cuDNN deterministic); the same launches as unsharded, twice
   them on the 2-way mesh; one RIFE 4.7 training step (b2 x 256x256 f32,
   TF32 off, cuDNN deterministic) on the 2-way mesh against one-device
   steps on each sample alone (the shards' forwards bit for bit): the loss
   within 1e-6 of their mean, the gradients within 1e-4 of each tensor's
   largest; against the one-device step at batch 2 (other convolution
   algorithms) within phase 49's card-against-CPU tolerance, the updates
   where |g| is over half its tensor's largest within 1e-7; K1 4 and the
   backward kernel 4 per shard; ``parallel.train.dryrun(torch.cuda.device_count())``.
52. splat backward -- the splat's backward kernel
   (``softsplat_bilinear_backward``) against its plain version
   (``ops.softsplat.softsplat_backward_torch``): the splat cases and
   ``warp_cases.splat_backward_cases`` at 256x512 (integer and half-pixel
   constant offsets, targets exactly on -1, 0, w - 1 and w, non-finite and
   huge flow, EISAI's 8-byte-aligned C = 6, 66, 258), f32 and bf16, f16
   once; C = 1-8, 65 and 66, GMFSS's 193 and EISAI's 258 and 514 at their
   sizes; NCHW planes, channel slices that start 4 and 8 bytes past a
   16-byte boundary and an expanded ``grad_out``; the flow's gradient alone
   too (the same bits);
   the launches of one M2M training step at phase 53's size, and of one
   GMFSS base and one EISAI step at 64x64, as the steps hand them over;
   ``softsplat_func`` with a gradient through ``SplatFunction`` (no twin),
   a direct ``softsplat_bilinear`` with one raising. Tolerances: the
   input's gradient within 4 f32 ulps of the sum of its absolute
   contributions, the flow's within 1e-5 of its largest magnitude plus
   1e-6; bf16/f16 one ulp more; two launches bit for bit (no atomics);
53. m2m train -- one ``make_train_step`` step of M2M (seed 0, L1, Adam 1e-4)
   at b2 x 256x256 f32, TF32 off, cuDNN deterministic: through the kernels
   against the same step with M2M's warps and splat on the plain twins
   (the loss within 1e-6 relative, every gradient within 1e-4 of its
   tensor's largest) and against the CPU with phase 49's rule (the updates
   within 1e-7 plus one f32 ulp of a parameter in [8, 16)); the launches
   exactly K1 4, wide 16, splat 1, the warp's backward 20 and the splat's
   1, and no CUDA warp or splat that needs a gradient reaching a twin;
54. m2m train timing -- M2M training at b8 x 256x256 (crops of Vimeo-90K's
   448x256 triplets), f32 (TF32 at torch's defaults) and bf16, as phase 50
   but in 2 windows of 5 steps each:
   steps/s and samples/s, the windows' spread, the peak memory of one step,
   a profile of one f32 step with the splat backward's device ms and
   share; at ``[64, 256, 256, 4]`` f32 and bf16 (the step's splat) and
   ``[16, 1088, 1920, 4]`` f32, in turns, the backward op's ms, the
   plain version's and two library calls' (``F.grid_sample`` for the
   input's gradient, ``aten.grid_sampler_2d_backward`` for the flow's),
   the kernel's device ms and its bound (values, flow and the f32
   grad_out read once, both gradients written once).
55-61. gmfss, eisai, gmfss_union, xvfi, stmfnet, ifrnet, amt train -- one
   training step of each family (``FAMILIES``, in this order; seed 0, L1,
   Adam 1e-4; GMFSS base and union, EISAI at 12 RAFT iterations, XVFI
   Vimeo, IFRNet S and AMT S through ``make_train_step``, STMFNet on four
   frames through ``loss.backward()`` and the optimizer) at full width (every
   tensor of ``init_params(0)``, ``strict=True``) on b8 x 256x256 crops f32,
   TF32 off, cuDNN deterministic: through the kernels, twice, against the
   same step with the warps and splats on the plain twins (the loss within
   1e-6 relative, each gradient within 1e-4 of its tensor's largest or 4x
   the two kernel runs' own difference on it); the launches exactly
   ``FAMILY_STEP_LAUNCHES`` (K1, wide, K2, the warp's backward, the
   splat's backward), and no CUDA warp or splat that needs a gradient
   reaching a twin; every backward launch of the step, as the step handed
   it over, against its plain version (phases 48 and 52's tolerances: the
   splat's backward at C = 3-514, the warp's at the wide and zeros-mode
   shapes); the same step at b1 x 64x64 (STMFNet 128x128) on the card
   against the CPU with phase 49's rule; then the step at TF32 defaults:
   steps/s as the median of 2 windows of 2 steps with their spread, the
   peak memory, and one profiled step's idle share and each backward
   kernel's device ms and share of the step's device time;
64-70. film, ifunet, atm, cain, flavr, sepconv, momo train -- as 55-61 (run
   after them, before 62): FILM, IFUnet (batch norms in ``eval()``, as
   ``_load`` leaves them), ATM base (global motion, no ensemble), CAIN,
   Sepconv (kernel heads conditioned as in phase 42) and MoMo base (8 DDPM
   steps, conditioned as in phase 45, the noise drawn once per batch shape
   from a fixed seed, so the kernels', the twins' and the CPU's steps see
   the same) through ``make_train_step``, FLAVR 2x on four frames as
   STMFNet; CAIN's CPU leg at 128x128. CAIN, FLAVR, Sepconv and MoMo launch
   no hand kernel: their launches must be 0 for all five;
62. family backward timing -- the warp's backward kernel at the largest
   input each family's step of 55-61 and 64-70 gave it, and the splat's at
   the largest of all, in the step's layout: the op's ms, the plain
   version's and the library call's in turns, the kernel's device ms and
   its bound.
63. splat backward timing -- the splat's backward kernel at every distinct
   input (shape, strides, start offset, dtypes, with or without the
   input's gradient) that one training step of each path of phases 54-61
   hands it (M2M b8 f32 and bf16; GMFSS base and union, EISAI, XVFI and
   STMFNet at b8 x 256x256 f32; ``splat_backward_step_inputs``), on the
   step's own tensors, and at ``[16, 1088, 1920, 4]`` f32: the kernel's
   device ms from a profile and its bound, the two library calls' device
   ms, and the op's, the plain version's and the library calls' ms in
   turns; per step, the sum over its launches against the sum of their
   bounds.
71. K1 band -- the ``space`` axis's K1 (``row0``): RIFE 1080p b8's
   ``[16, 1088, 1920, 7]`` warp in the two bands of a ``(1, 2)`` mesh
   (rows 0-576 and 576-1088, ``parallel.space.band_rows``), f32 and bf16
   border, bf16 zeros: each band bit for bit its twin's band
   (``warp_torch(..., row0=)``), the routed ``ops.warp.warp`` band and the
   whole frame's rows; ``row0=0`` at full height bit for bit the
   whole-frame call; the second bf16 band's ms in turns with the whole
   frame's, the twin's band and ``F.grid_sample`` on the band's grid, and
   its bound; then the wide kernel's band (``row0``) at M2M 1080p b2's
   feature warps (``M2M_SPACE_WIDE_SHAPES``: C = 32-384, zeros, f32 and
   bf16) and FILM's widest level ``[4, 135, 240, 960]`` (bf16, border),
   each in the rows its frame's two bands give it (``frame_band_spans``):
   each band bit for bit its twin's band, the routed ``ops.warp.warp``
   band and the whole frame's rows, ``row0=0`` bit for bit the whole-frame
   call, and the second bf16 band timed as K1's;
72. backward band -- the warp's backward kernel on the training step's
   ``[32, 256, 256, 7]`` f32 in two bands of 128 rows, and C = 3 without the
   image's gradient, against ``warp_backward_torch``'s band (phase 48's
   tolerances); the two bands' image gradients summed against the
   whole-frame call's; the second band's ms in turns with the whole
   frame's, the plain band's and ``aten.grid_sampler_2d_backward`` on the
   band's grid, and its bound;
73. space    -- RIFE 4.7 1080p x2 b8 (9 frames) through
   ``make_sharded_model_fn`` and ``run_plan`` on a ``(1, 2)`` mesh of
   logical replicas of the card against the one-device run: f32 (TF32 off,
   cuDNN deterministic) within 1e-4 (recorded too: the (1, 2) run against
   itself, and both at cuDNN's default), bf16 >= 40 dB against the
   f32 one-device frames, K1 8 a forward (twice 4) and the backward 0;
   frames/s of both in turns (one round each), ``run_plan``'s peak memory
   and a profile of one forward (idle share) of each;
74. space train -- a RIFE 4.7 step at b16 x 224x224 f32 (two bands of 128
   rows after the pad) on the ``(1, 2)`` mesh against ``(1, 1)``, TF32 off,
   cuDNN deterministic: the loss within 1e-6 relative, each gradient within
   5e-5 of its tensor's largest or 4x what the ``(1, 1)`` step moves with
   every weight times 1 + 2^-22; the same at b2 x 128x128 within 5e-5 alone;
   the updates where |g| is over half its largest within 1e-7; K1 and the
   backward 8 each (twice 4); steps/s of both in turns (TF32 defaults);
75. pair fns -- M2M 1080p x2 b2 (3 frames) through
   ``make_sharded_pair_fns`` and ``run_plan_pair_cached`` on the ``(1, 2)``
   mesh of replicas against one device: f32 (TF32 off, cuDNN
   deterministic) within 1e-4, and each run against itself (K2's f32
   atomics), bf16 >= 40 dB against the f32 one-device frames, the
   launches read (K1 8, wide 32, K2 2 a pair batch: twice one device's 4,
   16, 1); frames/s of both in turns (one round), peak memory and a
   profile of one pair batch (idle share) of each; a training step on the
   mesh whose model runs an op without a row-band rule (a stand-in: a
   convolution, then a running sum down the rows, ``row_op_stand_in``)
   raises ``NotImplementedError`` at that op, naming ``ROADMAP.md``'s item,
   and moves no parameter (every family's inference and every carried
   family's training step split: 73-93);
76. K2 band -- K2 with a band of sources (``row0``, ``out_rows``): M2M's
   ``[16, 1088, 1920, 4]`` f32 and bf16 splat in the two bands of the
   ``(1, 2)`` mesh, each a whole-frame f32 partial, against the twin's band;
   their sum against the whole-frame kernel and the twin (phase 7's
   tolerances), ``row0=0`` against the whole-frame call; the second bf16
   band's ms in turns with the whole frame's, the twin's band and one
   ``aten.grid_sampler_2d_backward`` on the band's grid
   (``library_splat(..., row0=, out_rows=)``), and its bound (the band's
   values and flow in, the whole-frame f32 partial out).
77. XVFI split -- XVFI Vimeo 1080p x2 b2 (3 frames) through
   ``make_sharded_pair_fns`` + ``run_plan_pair_cached`` on the ``(1, 2)``
   mesh of replicas (bands 576 + 504, the zero pad to 1088 in the second)
   against one device: f32 within 1e-4 under TF32 off and cuDNN's
   deterministic algorithms (each run also against itself: K2's atomics),
   bf16 at or above 40 dB against the f32 one-device frames; K1's, the
   wide kernel's and K2's launches read from the counters, twice one
   device's (``xvfi.warps_per_reuse`` + ``warps_per_infer``,
   ``splats_per_infer``); every launch of one bf16 split call made again on
   its band (``captured_band_launches``) against the plain version, the
   warps bit for bit, K2's partial within phase 7's f32 tolerance
   (``band_launches_vs_plain``); frames/s of one pair batch in turns (one
   round), peak memory and a profile (idle share, kernels) of each.
78. FILM split -- FILM 1080p x2 b2 the same way (each f32 run against
   itself only on the paths that launch K2, here and in 79-90) through
   ``make_sharded_model_fn`` + ``run_plan`` (``film.warps_per_forward``:
   K1 5 and wide 11 a forward, twice on the mesh; the pyramid's 135 -> 67
   rows put the bilinear and nearest resizes on rows by a ratio that is not
   an integer).
79. IFRNet split -- IFRNet S 1080p x2 b2 the same way (``ifrnet.warps_per_forward``:
   K1 2 and wide 6 a forward, twice on the mesh; the pad to 1088 rows in
   the second band; ``ResBlock``'s in-place writes, the joint mean's rows
   joined along the rows);
80. AMT split -- AMT S the same way, its clip edge-padded to 1088 rows first as
   its node pads (``nodes/vfi_nodes.py:_pad16``; bands 576 + 512), K1 2 and
   wide 6 a forward (``amt.warps_per_forward``), the correlation lookup's
   target pyramids built on each band's device from the gathered targets;
81. IFUnet split -- IFUnet the same way, K1 12 and wide 2 a forward
   (``ifunet.warps_per_forward``; ``convex_upsample`` with a row of halo
   from each neighbour, batch norms on their stored statistics).
82. X4K split -- XVFI X4K 1080p x2 b2 (3 frames) the same way as 77
   (pair-cached; the zero pad to 1536 rows in the second band), K1 18, wide
   14 and K2 1 a bf16 pair batch on one device and exactly twice on the
   mesh, each band's launch against its plain version; the re-bands of one
   bf16 split batch counted (``parallel.space.rebands``, ``rows_moved``:
   the pyramid to 1/128 starts the second band off its stride); bf16 held
   within 0.5 dB of one device's bf16;
83. CAIN split -- CAIN 1080p x2 b2 the same way as 78 (no hand kernel; the
   centred reflect pad to 1152 rows starts the second band at 612, which
   ``pixel_unshuffle(8)`` re-bands to 608; its f32 runs with cuDNN timing
   its algorithms: with TF32 off its heuristics' choice takes ~48 s a b2
   forward);
84. Sepconv split -- Sepconv 720p x2 b2 the same way, conditioned weights
   (``sepconv_func`` on each band with the 50 rows its taps read);
85. FLAVR split -- FLAVR 2x 1080p edge-padded to 1088 rows (its node's pad;
   bands 576 + 512) x2 b2 (5 frames, one batch of two windows) the same way
   through ``make_sharded_model_fn`` + ``run_plan_window4`` (no hand kernel;
   the 3-D convolutions with the rows on dimension 3 of the clip);
86. STMFNet split -- STMFNet 1080p x2 b1 (4 frames, one window) the same way
   (the reflect pad to 1152 rows puts 72 rows in the second band: 576 +
   576), K1 6, wide 4 and K2 1 a forward on one device and exactly twice on
   the mesh (``stmfnet.warps_per_forward``, ``splats_per_forward``), each
   band's launch against its plain version; AdaCoF, the correlation and the
   8-tap upsampler handed over to their rules; bf16 held within 0.5 dB of
   one device's bf16;
87. GMFSS split -- GMFSS Fortuna base and union 1080p x2 b1 (3 frames, two
   pair batches) through ``make_sharded_pair_fns`` +
   ``run_plan_pair_cached`` on the ``(1, 2)`` mesh of replicas (bands 576 +
   504, the zero pad to 1088 in the second) against one device, as phase
   77: GMFlow's transformer, correlation softmaxes, flow attention and
   convex upsampling handed over to their rules (each band's queries
   against keys gathered whole, halo rows for the local ops); K1, the wide
   kernel and K2 exactly twice one device's (``gmfss.warps_per_reuse``,
   ``warps_per_infer``, ``splats_per_infer``), each band's launch of one
   bf16 split batch against its plain version (the warps bit for bit, K2's
   partials at C = 4, 65, 129 and 193 within phase 15's tolerances); f32
   within twice one device's own gap when every input value moves one f32
   ulp (its global correlation softmax amplifies f32 rounding to ~1e-2,
   the split's gap and the nudge's alike), or 1e-4 where that is smaller,
   its f32 runs with cuDNN timing its algorithms (with TF32 off its
   heuristics' choice takes ~6 s a one-device run of two pairs, a timed one
   ~0.6 s); bf16 at 40 dB or more against the f32 one-device frames, or,
   where one device's bf16 is below 40 dB, within 0.5 dB of it;
88. EISAI split -- EISAI 540p x2 b1 (3 frames) the same way (bands 320 +
   220: the resize to 536 rows and the strided encoder leave band edges off
   the stride, the re-bands of one split batch counted; RAFT's all-pairs
   correlation, its convex upsampling and the distance transform handed
   over), K1 2 and K2 8 an infer on one device and exactly twice on the
   mesh, K2's f32 partials at C = 6, 66, 258 and 514 against the plain
   version;
89. ATM split -- ATM base 1080p x2 b1 (3 frames, two forward calls),
   global motion on (the node's default), through ``make_sharded_model_fn``
   + ``run_plan`` as phase 78: the centred edge pad to 1088 rows makes the
   bands 580 + 508, and the Swin windows cross the band edge at 1/8 and
   1/16 (each band computes the windows that hold its rows, under the shift
   with the rows the roll wraps from the frame's other end); K1 12 and wide
   4 a forward on one device (``atm.warps_per_forward``) and exactly twice
   on the mesh, each band's launch of one bf16 split call bit for bit its
   plain version; f32 within twice one device's own gap for its inputs one
   f32 ulp up (or 1e-4), bf16 at 40 dB against the f32 one-device frames or
   within 0.5 dB of one device's bf16; then one f32 call with the ensemble
   at 540p (K1 18, wide 4 on one device, twice on the mesh) held the same
   way;
90. MoMo split -- MoMo base 1080p x2 b1 the same way, conditioned heads
   (``momo_conditioned``), 2 denoising steps, the noise drawn from seed 0
   for the whole batch on the first band's device and cut into the bands
   (the GroupNorm, the replicate pad, the convex upsampling, the frames'
   statistics, the bicubic pyramids and backwarps handed over); no hand
   kernel; f32 as phase 89, bf16 within 0.5 dB of one device's bf16;
91. splat backward band -- the splat's backward kernel on a row band
   (``row0``, ``out_rows``): M2M's step input ``[64, 256, 256, 4]`` f32
   (phase 54's) and GMFSS's C = 65 and EISAI's C = 66 step inputs (phase
   63's, the spread route), each in the two halves of its rows (the
   ``(1, 2)`` mesh's bands at every level of a 256-row frame): each band's
   launch on the whole frame's output gradient bit for bit the whole-frame
   launch's rows of its sources, ``row0 = 0`` at the whole height bit for
   bit the default call, each band against its plain version with phase
   52's tolerances; each band's device ms in turns with the whole frame's,
   its bound, the two library calls on the band
   (``splat_backward_library_call`` with ``row0``) and the ops in turns;
92. M2M space train -- M2M's training step at b8 x 256x256 f32 through
   ``make_train_step`` on the ``(1, 2)`` mesh of replicas against one
   device (``space_train_phase``), TF32 off and cuDNN deterministic: the
   loss and every gradient within 4x one device's own move for its frames
   one f32 ulp up or its weights two (or 1e-6 relative for the loss; 5e-5
   of a tensor's largest, or 1e-6 of the largest gradient of all, for a
   gradient); launches exactly twice one device's (K1 8, wide
   32, K2 2, the warp's backward 40, the splat's backward 2); steps/s of
   both in turns (one round), peak memory and a profiled step of each;
93. family space train -- GMFSS base, EISAI (12 iterations), XVFI Vimeo and
   AMT S, one f32 step each at b2 x 256x256 on the mesh against one device
   the same way (``family_trainer`` on the mesh), launches exactly twice
   ``FAMILY_STEP_LAUNCHES``; no timed rounds.

Each phase starts with a ``clock:`` line, the seconds since the run began.

Each main path (phases 4, 8, 12, 16, 20, 24, 27, 29, 31, 33, 36, 38, 40, 42, 44, 45, 47, 49, 51, 53, 55-61, 64-70, 73-75, 77-90, 92-93 and X4K's forward in 39) is driven with the
launch counts set to 0 just before it and read just after. Each profile (phases 6, 10, 14, 18, 22, 26, 27, 30, 32, 34, 37, 39, 41, 43) also
records the launches of one forward, as the model makes them, and gives
each kernel its device ms there against the bound of those launches; a
ranking line orders kernel and path by the ms above the bound. Then the
kernel table as one JSON line: per kernel its launches (by path), max abs
error, ms, the plain twin's ms,
the library call's ms (``library_ms``: ``grid_sample`` for the warps, for
the splat one ``aten.grid_sampler_2d_backward`` whose input gradient is
the sum splat, ``utils/kernel_compare.py:library_splat``), its bound: the larger of the bytes it must move
(inputs once, output once) over 3.35 TB/s and its f32 operations over 67
TFLOP/s, with which of the two bounds it; and ``per_forward``, per path the
launches, device ms, bound and ms above it of one bf16 forward at each
path's timed size (1080p; EISAI 540p); K1's entries also hold
``F.grid_sample``'s device ms for the same launches (``library_ms``, and
by layout with each layout's bound: the forward's recorded launches
replayed on random values and smooth flow). The new paths' warp shapes are
under ``ifrnet_ifunet_amt_shapes`` and ``atm_xvfi_shapes`` (K1) and
``by_shape`` (wide, every main-path shape), XVFI's splat under
``xvfi_shapes``, and each profile's ``per_forward`` entry lists the
layouts its launches took (``launch_layouts``); the streamed RIFE and M2M
runs of phase 44 under ``launches_by_path`` as ``rife_streaming`` and
``m2m_streaming``, phase 49's training step as ``rife_train`` and phase
51's sharded runs as ``rife_sharded`` and ``m2m_sharded`` (1x1 mesh),
``rife_sharded_2way``, ``m2m_sharded_2way`` and ``rife_train_2way``, and phases
73's and 74's runs on the ``space`` axis as ``rife_space_2way`` and
``rife_train_space_2way`` (K1 and the backward; K1's ``row_band`` and
``rife_space_2way`` and the backward's ``row_band`` and
``rife_train_space_2way`` hold phases 71-74's numbers), and phase 75's
M2M run as ``m2m_space_2way`` (K1, the wide kernel and K2; the wide
kernel's ``row_band`` and ``m2m_space_2way`` and K2's ``row_band`` hold
phases 71, 75 and 76's numbers), and phases 77's and 78's runs as
``xvfi_space_2way`` and ``film_space_2way`` (K1, the wide kernel and K2;
K2's and the wide kernel's entries of those names hold the phases' rows,
each kernel's band shapes among them), and phases 79-81's as
``ifrnet_space_2way``, ``amt_space_2way`` and ``ifunet_space_2way`` (the
wide kernel's entries of those names hold the rows), phases 82-84's as
``xvfi_x4k_space_2way``, ``cain_space_2way`` and ``sepconv_space_2way``,
phases 85-86's as ``flavr_space_2way`` and ``stmfnet_space_2way`` (the
wide kernel's entries hold the rows, K2's STMFNet's too), and phases
87-88's as ``gmfss_space_2way``, ``gmfss_union_space_2way`` and
``eisai_space_2way`` (K2's entries of those names hold the rows, with K2's
band shapes at the wide widths; the wide kernel's GMFSS's), and phases
89-90's as ``atm_sharded_2way`` and ``momo_sharded_2way`` (the wide
kernel's ``atm_sharded_2way`` holds phase 89's row, its ensemble call's
too), and phases 92-93's steps as ``m2m_train_space_2way``,
``gmfss_train_space_2way``, ``eisai_train_space_2way``,
``xvfi_train_space_2way`` and ``amt_train_space_2way`` (every kernel; the
splat's backward holds their rows under those names, and phase 91's as
``row_band``). CAIN, Sepconv, FLAVR and MoMo launch no hand kernel
(``launches_by_path`` holds ``momo: 0`` and ``momo_sharded_2way: 0``). The fourth kernel, ``warp_bilinear_backward``, gives its ms at
``[16, 1088, 1920, 7]`` f32 beside ``grid_sampler_2d_backward``'s
(``library_ms``), ``by_shape`` (phase 50's four rows),
``per_step`` (one f32 training step's launches, device ms and bound) and
``training`` (phase 50's rows). The fifth, ``softsplat_bilinear_backward``,
gives its ms at ``[64, 256, 256, 4]`` f32 beside two library calls'
(``library_ms``), ``by_shape`` (phase 54's three rows), ``per_step`` (one
f32 M2M step's launch), ``training`` (phase 54's rows) and
``other_steps`` (phase 52's GMFSS and EISAI steps); every kernel's
``launches_by_path`` holds phase 53's step as ``m2m_train`` and phases
55-61's and 64-70's as ``<family>_train``; both backward kernels hold
``family_steps`` (per family, the launches by shape, the max errors against
the plain version, and the kernel's device ms and share of one profiled
step) and ``family_largest`` (phase 62, by family), and the splat's backward
``family_training`` (phases 55-61's and 64-70's rows: launches, steps/s, windows,
spread, peak memory, idle share) and ``phase_63`` (``by_layout``: each
input's device ms, bound, share of it, library and plain ms; ``per_step``:
each step's launches against their bounds).
The last line is ``{"ok": true, "device": {...}}``. Nothing of JAX is
imported.
"""

import concurrent.futures
import contextlib
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SHAPE = (16, 1088, 1920, 7)  # a batch-8 1080p RIFE warp: 2B images, 3+4 channels
SPLAT_F32_ATOL = 1e-5
SPLAT_SHAPE = (16, 1088, 1920, 4)  # a batch-2 1080p M2M splat: 2 directions x 2 pairs x 4 branches, 3+1 channels
M2M_HW = (540, 960)
M2M_NODE_HW = (270, 480)  # phase 8's clip: its CPU leg took ~28 s at M2M_HW
FILM_HW = (135, 240)  # phase 12's clip: its CPU leg took ~25-39 s at 270x480
FILM_WARP_SHAPES = ((4, 1080, 1920, 64), (4, 135, 240, 960))  # FILM 1080p batch 2: level-0 and level-3 feature warps
# the wide cases' widths: FILM's and M2M's, and the narrow ones of RIFE 4.0,
# IFRNet and AMT with one per vector width the kernel picks (bf16 C = 18: 4
# bytes, C = 21: an element)
WIDE_CHANNELS = (16, 18, 20, 21, 24, 32, 36, 44, 54, 64, 192, 448, 960)
# forced wide at a 1080p feature size: one width per vector in bf16 (16,
# 4 bytes, an element)
WIDE_PROBE_SHAPES = ((2, 544, 960, 16), (2, 544, 960, 18), (2, 544, 960, 21))
M2M_WIDE_SHAPES = ((2, 544, 960, 48), (2, 68, 120, 384))  # M2M 1080p batch 2: encoder-decoder feature warps
GMFSS_HW = (135, 240)  # phase 16's clip: its two CPU legs took ~20-30 s at 270x480
# GMFSS 1080p batch 1, one direction of an infer: the half-resolution image
# (3 + exp(metric)) and the three feature levels (64, 128, 192 + 1), "soft"
GMFSS_SPLAT_SHAPES = ((1, 544, 960, 4), (1, 544, 960, 65), (1, 272, 480, 129), (1, 136, 240, 193))
# GMFSS 1080p batch 1 warps (shape, mode, kernel): GMFlow's scale-1 feature
# warp, the metric net's flow and image warps, the union's RIFE 4.6 image
# warp of both frames (padded to 576 rows inside RIFE)
GMFSS_WARP_SHAPES = (
    ((1, 136, 240, 128), "zeros", "wide"),
    ((1, 544, 960, 2), "zeros", "tiled"),
    ((1, 544, 960, 3), "zeros", "tiled"),
    ((2, 576, 960, 3), "border", "tiled"),
)
EISAI_HW = (135, 240)  # phase 20's clip: its CPU leg took ~20-24 s at 270x480
# EISAI 540p batch 1, one direction of an infer: the frame (RGB + NEDT, the
# ones channel, exp(metric)) and the ResNet levels (64, 256, 512 + 2), "soft"
EISAI_SPLAT_SHAPES = ((1, 540, 960, 6), (1, 128, 228, 66), (1, 64, 114, 258), (1, 32, 57, 514))
# EISAI 540p batch 1: the FlowZMetric's border warp of each f32 Lab frame
# (f32 flow: RAFT's flow plus the grid offsets), on K1
EISAI_WARP_SHAPES = ((1, 540, 960, 3),)
RIFE40 = "sudo_rife4_269.662_testV1_scale1.pth"
# RIFE 4.0 refined mode at 540x960 batch 2 (padded to 576 rows inside RIFE):
# the Contextnet levels of both frames, border, on the wide kernel
RIFE40_WIDE_SHAPES = ((4, 288, 480, 16), (4, 144, 240, 32), (4, 72, 120, 64), (4, 36, 60, 128))
STMFNET_HW = (135, 240)
# STMFNet 1080p batch 1 (reflect-padded to 1152x1920), both flow directions
# as one batch: the PWC feature backwarps of levels 2 to 5, the frames'
# backwarp (each also warps its f32 ones plane, on K1) and the splat (3
# channels times exp(metric), and exp(metric))
STMFNET_PWC_SHAPES = ((2, 288, 480, 32), (2, 144, 240, 64), (2, 72, 120, 96), (2, 36, 60, 128))
STMFNET_IMAGE_SHAPE = (2, 1152, 1920, 3)
STMFNET_SPLAT_SHAPE = (2, 1152, 1920, 4)
FLAVR_HW = (135, 240)
NODE_HW = (135, 240)  # the frames of the node runs, card against CPU (phases 29-38)
# 1080p warps, border mode (NHWC shape, the kernel routed to): IFRNet S
# batch 4 (padded to 1088x1920) and AMT-S batch 2 (node-padded to
# 1088x1920): both frames' features at 1/8, 1/4 and 1/2, then the frames
# (AMT's over its 3 flows); IFUnet batch 2 (padded to 1088x1920): the frames
# and the refinement's context warp at 1/4
SLICE8_WARPS = {
    "ifrnet": (((4, 136, 240, 54), "wide"), ((4, 272, 480, 36), "wide"), ((4, 544, 960, 24), "wide"), ((4, 1088, 1920, 3), "tiled")),
    "ifunet": (((2, 1088, 1920, 3), "tiled"), ((2, 272, 480, 32), "wide")),
    "amt": (((2, 136, 240, 44), "wide"), ((2, 272, 480, 32), "wide"), ((2, 544, 960, 20), "wide"), ((6, 1088, 1920, 3), "tiled")),
}
# 1080p warps, zeros mode (NHWC shape, value dtype or None for the model's,
# the kernel routed to): ATM base batch 1 (padded to 1088x1920): the fused
# features of each frame at 1/8 (lite: C = 224) and the frames at 1/4, 1/2
# and 1; XVFI Vimeo batch 2 (padded to 1088x1920): the level-0 features, the
# frames and the f32 ones planes each warps apart
SLICE10_WARPS = (
    ((1, 136, 240, 384), None, "wide"), ((1, 136, 240, 224), None, "wide"), ((1, 272, 480, 3), None, "tiled"),
    ((1, 544, 960, 3), None, "tiled"), ((1, 1088, 1920, 3), None, "tiled"),
    ((2, 544, 960, 64), None, "wide"), ((2, 1088, 1920, 3), None, "tiled"),
    ((2, 544, 960, 1), "float32", "tiled"), ((2, 1088, 1920, 1), "float32", "tiled"),
)
ATM_ENH_SHAPE = (1, 136, 240, 768)  # ATM base 1080p b1: both frames' enhanced features side by side; its halves warp as views
XVFI_SPLAT_SHAPE = (4, 544, 960, 3)  # XVFI Vimeo 1080p b2: CFR, both directions as one batch, flow times z and the norm, f32
X4K = "XVFInet_X4K1000FPS_exp1_latest.pt"  # XVFI's X4K checkpoint, the node's default
X4K_HW = (1536, 2048)  # 1080p zero-padded to X4K's divide, 512
X4K_SPLAT_SHAPE = (4, 384, 512, 3)  # X4K at 1080p b2: CFR at 1/4, as XVFI_SPLAT_SHAPE
SOFTSPLAT_MODES = ["sum"] + [f"{b}{e}" for b in ("avg", "linear", "soft") for e in ("", "-addeps", "-zeroeps", "-clipeps")]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source
# each kernel of the kernels line and its device kernels' names
KERNEL_BODIES = {
    "warp_bilinear": ("warp_bilinear_tiled_kernel",),
    "warp_bilinear_wide": ("warp_bilinear_wide_kernel",),
    "softsplat": ("softsplat_kernel",),
    "warp_bilinear_backward": ("warp_bilinear_backward_kernel",),
    "softsplat_bilinear_backward": ("softsplat_backward_kernel",),
}
# RIFE 4.7 training (ECCV2022-RIFE: random 224x224 crops of Vimeo-90K
# triplets, batch 16), padded to 256x256 inside apply: the warp of both
# frames' image and encoder feature stacks, [2N, H, W, 3 + 4]
TRAIN_BATCH, TRAIN_HW = 16, (224, 224)
TRAIN_WARP_SHAPE = (32, 256, 256, 7)
# the space axis (phases 71-76): RIFE 1080p b8's warp, split by a (1, 2) mesh
# into bands of 576 and 512 rows, and the b16 x 224^2 training step's warp
# (padded to 256 rows), into two of 128
SPACE_WARP_SHAPE = (16, 1088, 1920, 7)
SPACE_TRAIN_WARP_SHAPE = (32, 256, 256, 7)
# M2M 1080p b2 (padded to 1088 rows) on the (1, 2) mesh: its wide feature
# warps, zeros (the flow net's level-0 C = 32, the encoder-decoder's C = 48
# to 384), and its splat (SPLAT_SHAPE) in the frame's bands of 576 + 512 rows
M2M_SPACE_WIDE_SHAPES = ((2, 272, 480, 32), (2, 544, 960, 48), (2, 272, 480, 96), (2, 136, 240, 192), (2, 68, 120, 384))
TRAIN_CHECK_HW = (256, 256)  # phase 49: card against CPU at b2
# M2M training (256x256 crops of Vimeo-90K's 448x256 triplets, a multiple of
# M2M's pad of 64): phase 53 card against CPU at b2, phase 54 timing at b8;
# the step's splat, [2 directions x b8 x 4 branches, H, W, 3 + 1]
M2M_TRAIN_BATCH, M2M_TRAIN_HW = 8, (256, 256)
M2M_TRAIN_SPLAT_SHAPE = (64, 256, 256, 4)
# one M2M training step's launches: K1, wide and the splat forward; the
# warp's backward once per warp (each warp's flow needs a gradient) and the
# splat's once
M2M_TRAIN_LAUNCHES = {"narrow": 4, "wide": 16, "splat": 1, "backward": 20, "splat_backward": 1}
# phases 55-61 and 64-70: the other families' training steps, in this
# order, at b8 x 256x256 crops (Vimeo-90K's 448x256 triplets cropped; a
# multiple of every family's pad: GMFSS 64, XVFI Vimeo 2**S_tst * scale * 4
# = 16, STMFNet 128, IFRNet 64, AMT 16, IFUnet 64, ATM 64, CAIN 128, FLAVR
# 16, MoMo 64), f32; card against the CPU at b1 x 64x64 (STMFNet and CAIN
# 128x128)
FAMILIES = ("gmfss", "eisai", "gmfss_union", "xvfi", "stmfnet", "ifrnet", "amt",
            "film", "ifunet", "atm", "cain", "flavr", "sepconv", "momo")
FAMILY_PHASES = dict(zip(FAMILIES, (*range(55, 62), *range(64, 71))))
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_HW = 8, (256, 256)
# the training timings' windows (phases 50, 54, 55-61 and 64-70): 7 until
# the run passed 850 s of its 1200 with phases 79-81, then 5 until phases
# 82-84 were added, then 3 until phases 87-88 were
TIMING_WINDOWS = 2
FAMILY_CHECK_HW = {"stmfnet": (128, 128), "cain": (128, 128)}  # the others at 64x64
FAMILY_EISAI_ITERS = 12  # the node's default
FAMILY_MOMO_STEPS = 8  # the node's default
FAMILY_FOUR_FRAMES = ("stmfnet", "flavr")  # clips of four frames: a plain step, no make_train_step
# one step's launches at f32: the forward's warps and splats as each model
# counts them (gmfss.warps_per_reuse/warps_per_infer/splats_per_infer,
# eisai.warps_per_infer/splats_per_infer, xvfi.warps_per_reuse/
# warps_per_infer, stmfnet.warps_per_forward, ifrnet, amt, film, ifunet and
# atm .warps_per_forward, routed at f32), one splat backward for each splat,
# and one warp backward for each warp whose output the loss reads
# differentiably: none for the masks' warps, which only a comparison reads
# (GMFSS's forward-backward consistency warps of the flows, two; the f32
# ones planes that XVFI, eight, and STMFNet, five, warp for their masks),
# and none for ATM's eight warps whose outputs nothing reads (the frames at
# 1/4 and 1/2 under global motion, and the blends at 1/4 and 1/2 that the
# pyramid's last level overwrites). CAIN, FLAVR, Sepconv and MoMo launch no
# hand kernel.
NO_LAUNCHES = {"narrow": 0, "wide": 0, "splat": 0, "backward": 0, "splat_backward": 0}
FAMILY_STEP_LAUNCHES = {
    "gmfss": {"narrow": 4, "wide": 2, "splat": 8, "backward": 4, "splat_backward": 8},
    "eisai": {"narrow": 2, "wide": 0, "splat": 8, "backward": 2, "splat_backward": 8},
    "gmfss_union": {"narrow": 8, "wide": 2, "splat": 8, "backward": 8, "splat_backward": 8},
    "xvfi": {"narrow": 10, "wide": 6, "splat": 1, "backward": 8, "splat_backward": 1},
    "stmfnet": {"narrow": 6, "wide": 4, "splat": 1, "backward": 5, "splat_backward": 1},
    "ifrnet": {"narrow": 2, "wide": 6, "splat": 0, "backward": 8, "splat_backward": 0},
    "amt": {"narrow": 2, "wide": 6, "splat": 0, "backward": 8, "splat_backward": 0},
    "film": {"narrow": 5, "wide": 11, "splat": 0, "backward": 16, "splat_backward": 0},
    "ifunet": {"narrow": 12, "wide": 2, "splat": 0, "backward": 14, "splat_backward": 0},
    "atm": {"narrow": 12, "wide": 4, "splat": 0, "backward": 8, "splat_backward": 0},
    "cain": NO_LAUNCHES, "flavr": NO_LAUNCHES, "sepconv": NO_LAUNCHES, "momo": NO_LAUNCHES,
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def psnr(a, b):
    mse = ((a.double().cpu() - b.double().cpu()) ** 2).mean().item()
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def cuda_ms(fn, iters):
    """Mean ms per call of ``fn()`` between CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate, and which one."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_work(planes, flow_planes):
    """Bytes and f32 operations of one warp of ``[N, C, H, W]`` planes by
    ``[N, 2, H', W]`` flow planes (``H' = H``, or a row band's rows): the
    image's rows that the output samples (the band's own, for flow of a few
    pixels) and the flow read once, the output written once; 7 operations
    per channel (4 products, 3 sums) and 14 per pixel for its coordinates
    and weights."""
    n, c, _, w = planes.shape
    h = flow_planes.shape[2]
    nbytes = 2 * n * c * h * w * planes.element_size() + flow_planes.numel() * flow_planes.element_size()
    return nbytes, n * h * w * (7 * c + 14)


def splat_work(planes, flow_planes):
    """Bytes and f32 operations of one splat of ``[N, C, H, W]`` planes: the
    values and flow read once, the output written once in the values' dtype;
    8 operations per channel (4 products, 4 sums) and 12 per source."""
    n, c, h, w = planes.shape
    nbytes = 2 * planes.numel() * planes.element_size() + flow_planes.numel() * flow_planes.element_size()
    return nbytes, n * h * w * (8 * c + 12)


def splat_band_work(planes, flow_planes, out_rows):
    """Bytes and f32 operations of K2 on a band of sources (``[N, C, Hb,
    W]`` planes) into the whole frame's ``out_rows``: the band's values and
    flow read once, the f32 partial ``[N, C, out_rows, W]`` written once;
    the operations of :func:`splat_work` for the band's sources."""
    n, c, _, w = planes.shape
    nbytes, flops = splat_work(planes, flow_planes)
    return nbytes - planes.numel() * planes.element_size() + n * c * out_rows * w * 4, flops


def frame_band_spans(rows, frame_rows, n=2):
    """The ``(first row, rows)`` of each band of a tensor of ``rows`` rows
    inside a model whose frame of ``frame_rows`` rows splits into ``n``
    bands (``parallel.space.band_rows``): each band's start scaled by the
    tensor's ratio to the frame (M2M's 1088 rows split 576 + 512, its
    level of 272 rows 144 + 128)."""
    from comfyui_frame_interpolation_tpu_torch.parallel.space import band_rows

    starts = [a * rows // frame_rows for a, _ in band_rows(frame_rows, n)]
    return [(a, b - a) for a, b in zip(starts, starts[1:] + [rows])]


def band_grid(flow_band, row0, rows):
    """``F.grid_sample``'s grid (``align_corners=True``) that samples a
    frame of ``rows`` rows where a band of flow from row ``row0`` samples it
    (the library yardstick of a warp's band)."""
    import torch

    n, h, w, _ = flow_band.shape
    gx = torch.arange(w, device=flow_band.device, dtype=torch.float32).view(1, 1, -1) + flow_band[..., 0].float()
    gy = torch.arange(row0, row0 + h, device=flow_band.device, dtype=torch.float32).view(1, -1, 1) + flow_band[..., 1].float()
    return torch.stack([gx * (2.0 / (w - 1)) - 1.0, gy * (2.0 / (rows - 1)) - 1.0], -1)


def warp_bound(img, flow):
    """Bound of one warp of NHWC ``img`` by ``flow``."""
    return bound(*warp_work(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)))


def backward_work(planes, flow_planes, img_grad=True):
    """Bytes and f32 operations of one warp backward of ``[N, C, H, W]``
    planes: the output's gradient, the image and the flow read once, the
    flow's gradient and (with ``img_grad``) the image's written once, each
    in its own dtype (the kernel's zeroed f32 buffer and its cast are its
    own cost, in its measured time, not in the bound); 22 operations per
    channel (the flow's two sums, 18; the four weighted gradients, 4) and 40
    per pixel (coordinates, weights and slopes). For a row band (flow planes
    of fewer rows) the image's rows are the band's, as in :func:`warp_work`."""
    n, c, _, w = planes.shape
    h = flow_planes.shape[2]
    isz, fbytes = planes.element_size(), flow_planes.numel() * flow_planes.element_size()
    nbytes = (3 if img_grad else 2) * n * c * h * w * isz + 2 * fbytes
    return nbytes, n * h * w * (22 * c + 40)


def grad_within(got, ref, tol, dtype):
    """``got`` within ``tol`` (a number or a tensor like ``ref``) of ``ref``,
    plus one ulp of ``ref`` for bf16/f16: ``(ok, max abs err)``."""
    import torch

    g, r = got.float(), ref.float()
    if dtype in (torch.bfloat16, torch.float16):
        _, exp = torch.frexp(r.abs())
        tol = tol + torch.ldexp(torch.ones_like(r), exp - (8 if dtype == torch.bfloat16 else 11))
    err = (g - r).abs()
    return bool((err <= tol).all()), err.max().item()


def splat_backward_work(planes, flow_planes, in_grad=True):
    """Bytes and f32 operations of one splat backward of ``[N, C, H, W]``
    planes: the f32 output gradient, the values and the flow read once, the
    flow's gradient and (with ``in_grad``) the values' written once, each in
    its own dtype; 16 operations per channel (the input's gradient, 4
    products and 4 sums; the corners' sums for the flow's, 8) and 30 per
    source (coordinates, weights, the flow's gradient)."""
    n, c, h, w = planes.shape
    vbytes, fbytes = planes.numel() * planes.element_size(), flow_planes.numel() * flow_planes.element_size()
    nbytes = 4 * planes.numel() + vbytes + 2 * fbytes + (vbytes if in_grad else 0)
    return nbytes, n * h * w * (16 * c + 30)


def splat_backward_vs_plain(vals, flow, what, grad_out=None, seed=0, in_grad=True):
    """The splat's backward kernel against its plain version
    (``ops.softsplat.softsplat_backward_torch``) on NHWC ``vals`` and
    ``flow`` and an f32 output gradient (uniform in [-1, 1] from ``seed``
    unless given; any strides). Tolerances: the input's gradient within 4
    f32 ulps of the sum of its absolute contributions (at most four
    products, summed in another order); the flow's within 1e-5 of its
    largest magnitude plus 1e-6 (channel sums in another order); bf16/f16
    one ulp of the output more. The kernel has no atomics: a second launch
    must give the same bits, and so must a launch that computes the
    flow's gradient without the input's. Returns the f32 max abs errors
    ``(grad_in, grad_flow)``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_backward_torch

    if grad_out is None:
        g = torch.Generator().manual_seed(seed)
        grad_out = (torch.rand(vals.shape, generator=g) * 2 - 1).to(vals.device)
    args = (vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2))
    gi, gf = softsplat_kernel.softsplat_bilinear_backward(*args, in_grad)
    again = softsplat_kernel.softsplat_bilinear_backward(*args, in_grad)
    ri, rf = softsplat_backward_torch(vals, flow, grad_out)
    contributions, _ = softsplat_backward_torch(vals.float(), flow.float(), grad_out.abs())
    torch.cuda.synchronize()
    shape = f"{list(vals.shape)} {str(vals.dtype).split('.')[-1]}, {str(flow.dtype).split('.')[-1]} flow"
    err_i = 0.0
    if in_grad:
        ok_i, err_i = grad_within(gi.permute(0, 2, 3, 1), ri, 4 * 2.0**-23 * contributions, vals.dtype)
        check(ok_i, f"splat backward kernel vs plain, {what} {shape}: grad_in max err {err_i}")
        check(torch.equal(gi, again[0]), f"splat backward {what} {shape}: grad_in differs between two launches")
        no_i, gf_alone = softsplat_kernel.softsplat_bilinear_backward(*args, False)
        check(no_i is None and torch.equal(gf_alone, gf), f"splat backward {what} {shape}: the flow's gradient alone differs")
    ok_f, err_f = grad_within(gf.permute(0, 2, 3, 1), rf, 1e-5 * rf.float().abs().max().item() + 1e-6, flow.dtype)
    check(ok_f, f"splat backward kernel vs plain, {what} {shape}: grad_flow max err {err_f}")
    check(torch.equal(gf, again[1]), f"splat backward {what} {shape}: grad_flow differs between two launches")
    return err_i, err_f


def splat_backward_library_call(vals, flow, grad_out, row0=0):
    """The splat's gradients of NHWC ``vals`` by ``flow`` for the f32
    ``grad_out`` in two library calls on a precomputed grid (no single
    PyTorch call computes them): ``F.grid_sample`` of ``grad_out`` at the
    targets, zeros padding (the input's gradient), and
    ``aten.grid_sampler_2d_backward`` of the values against ``grad_out``
    with ``output_mask=[False, True]`` (the flow's). A band of sources
    (``vals`` and ``flow`` global rows ``row0`` on of ``grad_out``'s): the
    targets at their global rows in the whole frame's ``grad_out``. The
    library yardstick, which the port never calls."""
    import torch
    import torch.nn.functional as F

    gplanes = grad_out.permute(0, 3, 1, 2)
    planes = vals.permute(0, 3, 1, 2).float()  # the library call takes one dtype: f32, cast before timing
    n, _, ho, w = gplanes.shape
    h = vals.shape[1]
    gx = torch.arange(w, device=vals.device, dtype=torch.float32).view(1, 1, w) + flow[..., 0].float()
    gy = torch.arange(row0, row0 + h, device=vals.device, dtype=torch.float32).view(1, h, 1) + flow[..., 1].float()
    grid = torch.stack([gx * (2.0 / max(w - 1, 1)) - 1.0, gy * (2.0 / max(ho - 1, 1)) - 1.0], -1)

    def call():
        F.grid_sample(gplanes, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        torch.ops.aten.grid_sampler_2d_backward(planes, gplanes, grid, 0, 0, True, [False, True])

    return call


def row_op_stand_in():
    """A module whose forward runs an op that no row-band rule covers: a
    3x3 convolution of the frames' sum, then a running sum down the rows
    (``Tensor.cumsum``), NHWC in and out (phase 75)."""
    import torch

    class RowCumsum(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)

        def forward(self, f0, f1):
            return self.conv((f0 + f1).permute(0, 3, 1, 2)).cumsum(2).permute(0, 2, 3, 1)

    return RowCumsum()


def m2m_trainer(device, dtype, mesh=None):
    """An M2M module from ``init_params(0)`` on ``device`` in ``dtype``
    (``channels_last``), an Adam 1e-4 over it and
    ``parallel.make_train_step(m2m.apply, ...)`` on ``mesh`` (one device by
    default): ``(net, step)``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch import parallel
    from comfyui_frame_interpolation_tpu_torch.models import m2m
    from comfyui_frame_interpolation_tpu_torch.models.common import cast_params

    net = m2m.M2M_PWC()
    net.load_state_dict(cast_params(m2m.init_params(0), dtype), strict=True)
    net = net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    mesh = mesh or parallel.make_mesh(1, devices=[torch.device(device)])
    step = parallel.make_train_step(m2m.apply, torch.optim.Adam(net.parameters(), lr=1e-4), mesh, net)
    return net, step


def backward_vs_plain(img, flow, mode, what, grad_out=None, seed=0):
    """The backward kernel against its plain version
    (``ops.warp.warp_backward_torch``) on NHWC ``img`` and ``flow`` and an
    output gradient (uniform in [-1, 1] from ``seed`` unless given).
    Tolerances: the image's gradient within 1e-5 of the sum of each pixel's
    absolute contributions plus 1e-6 (both versions sum with f32 atomics, in
    orders that change from run to run; a pixel that many samples pile onto
    sums many terms), the flow's within 1e-5 of its largest magnitude plus
    1e-6 (the channels summed in another order); bf16/f16 one ulp more.
    Returns the f32 max abs errors ``(grad_img, grad_flow)``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp_backward_torch

    if grad_out is None:
        g = torch.Generator().manual_seed(seed)
        grad_out = (torch.rand(img.shape, generator=g) * 2 - 1).to(img.device, img.dtype)
    gi, gf = warp_kernel.warp_bilinear_backward(
        img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), mode == "zeros"
    )
    ri, rf = warp_backward_torch(img, flow, grad_out, mode)
    contributions, _ = warp_backward_torch(img.float(), flow.float(), grad_out.float().abs(), mode)
    torch.cuda.synchronize()
    ok_i, err_i = grad_within(gi.permute(0, 2, 3, 1), ri, 1e-5 * contributions + 1e-6, img.dtype)
    ok_f, err_f = grad_within(gf.permute(0, 2, 3, 1), rf, 1e-5 * rf.float().abs().max().item() + 1e-6, flow.dtype)
    shape = f"{list(img.shape)} {str(img.dtype).split('.')[-1]} {mode}, {str(flow.dtype).split('.')[-1]} flow"
    check(ok_i, f"backward kernel vs plain, {what} {shape}: grad_img max err {err_i}")
    check(ok_f, f"backward kernel vs plain, {what} {shape}: grad_flow max err {err_f}")
    return err_i, err_f


def grid_sample_backward_call(img, flow, grad_out, padding_mode="border", img_grad=True, row0=0):
    """``aten.grid_sampler_2d_backward`` computing the warp's gradients of
    NHWC ``img`` by ``flow`` for ``grad_out`` on a precomputed grid
    (``align_corners=True``; the grid's alone without ``img_grad``; a row
    band's from ``row0``), in the layout the path holds: the library
    yardstick, which the port never calls."""
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import library_backward

    return library_backward(img, flow, grad_out, padding_mode == "zeros", img_grad, row0=row0)


def rife_trainer(device, dtype, mesh=None):
    """A RIFE 4.7 module from ``init_params(0)`` on ``device`` in ``dtype``
    (``channels_last``), an Adam 1e-4 over it and ``parallel.make_train_step``
    on ``mesh`` (one device by default): ``(net, step)``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch import parallel
    from comfyui_frame_interpolation_tpu_torch.models import rife
    from comfyui_frame_interpolation_tpu_torch.models.common import cast_params

    net = rife.IFNet("4.7")
    net.load_state_dict(cast_params(rife.init_params(0, "4.7"), dtype), strict=True)
    net = net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    scale_list = rife.default_scale_list("4.7")
    mesh = mesh or parallel.make_mesh(1, devices=[torch.device(device)])
    step = parallel.make_train_step(
        lambda n, f0, f1, t: rife.apply(n, f0, f1, t, scale_list), torch.optim.Adam(net.parameters(), lr=1e-4), mesh, net
    )
    return net, step


def train_batch(b, hw, seed, device, dtype):
    """``(f0, f1, t, target)``: random NHWC frames and target from numpy's
    ``seed``, t uniform in (0, 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f0, f1, target = (torch.from_numpy(rng.random((b, *hw, 3), dtype=np.float32)).to(device, dtype) for _ in range(3))
    t = torch.from_numpy(rng.uniform(0.1, 0.9, b).astype(np.float32)).to(device, dtype)
    return f0, f1, t, target


@contextlib.contextmanager
def spying(targets):
    """Inside, each ``(module, attr, record)`` of ``targets`` makes
    ``module.attr`` call ``record(*args)`` before the real function."""
    real = [getattr(module, attr) for module, attr, _ in targets]

    def spy(fn, record):
        def call(*args, **kwargs):
            record(*args)
            return fn(*args, **kwargs)

        return call

    try:
        for (module, attr, record), fn in zip(targets, real):
            setattr(module, attr, spy(fn, record))
        yield
    finally:
        for (module, attr, _), fn in zip(targets, real):
            setattr(module, attr, fn)


def launch_layout(x, flow, zeros):
    """What a warp or splat launch was given, as a hashable tuple: the NHWC
    shape, the planes' element strides, the start's offset in elements
    modulo 16 bytes, the dtype, the flow planes' strides and dtype, and the
    zeros flag."""
    shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    dt = lambda t: str(t.dtype).split(".")[-1]  # noqa: E731
    return (shape, tuple(x.stride()), x.data_ptr() % 16 // x.element_size(), dt(x), tuple(flow.stride()), dt(flow), zeros)


def recorded_work(log):
    """Inside, each call of a kernel wrapper appends ``(kernel, bytes, f32
    operations, launch_layout)`` of its launch to ``log``, ``kernel`` named
    as in the kernels line: the launches a model's forward really makes, at
    the shapes and layouts it gives them."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    def record(kernel, work):
        return lambda x, flow, *rest: log.append((kernel, *work(x, flow), launch_layout(x, flow, bool(rest[0]) if rest else False)))

    def record_backward(x, flow, grad_out, zeros=False, img_grad=True):
        log.append(("warp_bilinear_backward", *backward_work(x, flow, img_grad), launch_layout(x, flow, bool(zeros))))

    def record_splat_backward(x, flow, grad_out, in_grad=True):
        log.append(("softsplat_bilinear_backward", *splat_backward_work(x, flow, in_grad), launch_layout(x, flow, False)))

    return spying([
        (warp_kernel, "warp_bilinear", record("warp_bilinear", warp_work)),
        (warp_kernel, "warp_bilinear_wide", record("warp_bilinear_wide", warp_work)),
        (softsplat_kernel, "softsplat_bilinear", record("softsplat", splat_work)),
        (warp_kernel, "warp_bilinear_backward", record_backward),
        (softsplat_kernel, "softsplat_bilinear_backward", record_splat_backward),
    ])


def captured_splats(store):
    """Inside, each call of the splat kernel's wrapper appends a copy of its
    values and flow, NHWC, to ``store``: the inputs a model hands the
    kernel."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel

    def record(x, flow):
        store.append((x.permute(0, 2, 3, 1).clone(), flow.permute(0, 2, 3, 1).clone()))

    return spying([(softsplat_kernel, "softsplat_bilinear", record)])


def captured_warps(store):
    """Inside, each call of a warp kernel's wrapper appends ``(kernel,
    planes, flow planes, zeros)`` to ``store``, copies with the strides the
    model gave them: the inputs a model hands the kernels."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel

    def record(kernel):
        return lambda img, flow, zeros=False: store.append((kernel, img.clone(), flow.clone(), zeros))

    return spying([(warp_kernel, k, record(k)) for k in ("warp_bilinear", "warp_bilinear_wide")])


def warps_vs_plain(store, what):
    """Each captured warp launched again through its wrapper and held against
    the plain twin on the same inputs, bit for bit. Returns ``{kernel: the
    NHWC shapes, value and flow dtypes it took}``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp_torch

    seen = {}
    for kernel, img, flow, zeros in store:
        mode = "zeros" if zeros else "border"
        got = getattr(warp_kernel, kernel)(img, flow, zeros).permute(0, 2, 3, 1)
        ref = warp_torch(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), mode)
        torch.cuda.synchronize()
        shape = (img.shape[0], *img.shape[2:], img.shape[1])
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.equal(got, ref), f"{what}: {kernel} at {list(shape)} {img.dtype} {mode}, {flow.dtype} flow: max err {err}, not bit-exact")
        seen.setdefault(kernel, set()).add((shape, mode, str(img.dtype).split(".")[-1], str(flow.dtype).split(".")[-1]))
    return seen


@contextlib.contextmanager
def captured_band_launches(store):
    """Inside, each call of K1's, the wide kernel's and K2's wrapper appends
    ``(kernel, input copy, flow copy, positional arguments, keyword
    arguments)`` to ``store``: the launches a split run makes, with each
    band's ``row0`` (and K2's ``out_rows``), which the wrappers take by
    keyword and :func:`spying` does not record."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    targets = [(warp_kernel, "warp_bilinear"), (warp_kernel, "warp_bilinear_wide"), (softsplat_kernel, "softsplat_bilinear")]
    real = [getattr(module, attr) for module, attr in targets]

    def spy(name, fn):
        def call(x, flow, *args, **kwargs):
            store.append((name, x.clone(), flow.clone(), args, dict(kwargs)))
            return fn(x, flow, *args, **kwargs)

        return call

    try:
        for (module, attr), fn in zip(targets, real):
            setattr(module, attr, spy(attr, fn))
        yield
    finally:
        for (module, attr), fn in zip(targets, real):
            setattr(module, attr, fn)


def band_launches_vs_plain(store, what):
    """Each captured launch of :func:`captured_band_launches` made again
    through its wrapper on the copies and held against its plain version on
    the same band: the warps bit for bit (``warp_torch(..., row0=)``), K2's
    whole-frame f32 partial within 1e-5 of the largest magnitude (at least
    1) (``softsplat_torch(..., row0=, out_rows=)``). Returns ``{kernel:
    sorted (band's NHWC shape, source rows, row0, dtype)}`` and the largest
    error."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_torch
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp_torch

    seen, worst = {}, 0.0
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    for kernel, x, flow, args, kwargs in store:
        row0 = kwargs.get("row0", 0)
        if kernel == "softsplat_bilinear":
            got = nhwc(softsplat_kernel.softsplat_bilinear(x, flow, *args, **kwargs))
            ref = softsplat_torch(nhwc(x).float(), nhwc(flow), row0=row0, out_rows=kwargs.get("out_rows"))
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ok = err <= SPLAT_F32_ATOL * max(1.0, ref.abs().max().item())
            rows = kwargs.get("out_rows") or x.shape[2]
        else:
            zeros = bool(args[0]) if args else bool(kwargs.get("zeros", False))
            got = nhwc(getattr(warp_kernel, kernel)(x, flow, *args, **kwargs))
            ref = warp_torch(nhwc(x), nhwc(flow), "zeros" if zeros else "border", row0=row0)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.equal(got, ref)
            rows = x.shape[2]
        worst = max(worst, err)
        band = (flow.shape[0], flow.shape[2], flow.shape[3], x.shape[1])
        check(ok, f"{what}: {kernel} on the band {list(band)} from row {row0} of {rows} {x.dtype}: max err {err} against the plain version")
        seen.setdefault(kernel, set()).add((band, rows, row0, str(x.dtype).split(".")[-1]))
    return {k: sorted(v) for k, v in seen.items()}, worst


@contextlib.contextmanager
def rescue_flags(store):
    """Inside, each call of RIFE 4.0's rescue test appends its flag and the
    largest stage-1 flow update of each direction to ``store``."""
    from comfyui_frame_interpolation_tpu_torch.models import rife

    real = rife._needs_rescue

    def record(fd):
        flag = real(fd)
        store.append((flag, fd[:, :2].abs().amax().item(), fd[:, 2:4].abs().amax().item()))
        return flag

    rife._needs_rescue = record
    try:
        yield
    finally:
        rife._needs_rescue = real


def in_turns(calls):
    """``{name: (fn, iters)}`` -> ``{name: [ms, ms]}``: each version timed by
    :func:`cuda_ms` in order, then in reverse order."""
    order = list(calls)
    times = {k: [] for k in order}
    for name in order + order[::-1]:
        fn, iters = calls[name]
        times[name].append(cuda_ms(fn, iters))
    return times


def routed_at_path_shape(shape, mode, flow_dtype, body, generator, value_dtype=None):
    """``ops.warp.warp`` as routed against the plain twin at a main path's
    NHWC ``shape`` (values in ``value_dtype``, bf16 by default, smooth flow in
    ``flow_dtype``): the route must be ``body`` and the result bit-exact.
    Returns the max abs error."""
    import torch
    import warp_cases
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_torch

    value_dtype = value_dtype or torch.bfloat16
    img = torch.rand(shape, generator=generator).to("cuda", value_dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to("cuda", flow_dtype)
    planes = img.permute(0, 3, 1, 2)
    routed = warp_kernel.route(planes.shape, planes.stride(), img.dtype)
    check(routed == body, f"{list(shape)} {value_dtype} routed to {routed}, expected {body}")
    got, ref = warp(img, flow, mode), warp_torch(img, flow, mode)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(
        torch.equal(got, ref),
        f"{routed} kernel vs plain at {list(shape)} {value_dtype} {mode}, {flow_dtype} flow: max err {err}, not bit-exact",
    )
    return err


def grid_sample_call(img, flow, padding_mode="border"):
    """``F.grid_sample`` computing the warp of NHWC ``img`` by ``flow`` on a
    precomputed grid, in the layout the path holds (channels_last planes)."""
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import grid_sample_planes

    return grid_sample_planes(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), padding_mode == "zeros")


def library_per_forward(layouts, generator, dev):
    """``F.grid_sample``'s device ms for one forward's launches of a warp
    kernel, replayed from a ``per_forward`` entry's ``launch_layouts`` (each
    layout's shape, strides, start offset and dtypes) on random values and
    smooth flow (amplitude 6 px): ``(total ms, [per layout: shape, dtype,
    launches, bound_ms, library_ms of one launch])``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import grid_sample_planes, smooth_flow, strided_like

    total, rows = 0.0, []
    for lay in layouts:
        n, h, w, c = lay["shape"]
        dtype, fdtype = getattr(torch, lay["dtype"]), getattr(torch, lay["flow_dtype"])
        values = torch.rand((n, c, h, w), generator=generator).to(dev, dtype)
        planes = strided_like((n, c, h, w), lay["strides"], lay["offset"], dtype, dev, values)
        flow = torch.from_numpy(smooth_flow(n, h, w, 6.0)).to(dev, fdtype).permute(0, 3, 1, 2)
        fplanes = strided_like((n, 2, h, w), lay["flow_strides"], 0, fdtype, dev, flow)
        # all the call's kernels: F.grid_sample takes cuDNN's sampler for some
        # f32 inputs, PyTorch's own for the rest
        ms = device_ms(grid_sample_planes(planes, fplanes, lay["zeros"]), 20)
        total += lay["launches"] * ms
        rows.append({"shape": lay["shape"], "dtype": lay["dtype"], "launches": lay["launches"],
                     "bound_ms": bound(*warp_work(planes, fplanes))[0], "library_ms": ms})
        del values, planes, flow, fplanes
    return total, rows


def bf16_ulp_ok(got, ref):
    """Every element of ``got`` within one bf16 ulp of ``ref``'s value."""
    import torch

    _, exp = torch.frexp(ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


def shifted_pattern(n, h, w, seed, step=(6.0, 3.0)):
    """``n`` frames of a smooth random pattern, each shifted by ``step`` pixels
    from the last, so the flows between them are non-trivial."""
    import numpy as np

    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.01, 0.05, (3, 2, 2))
    phase = rng.uniform(0, 2 * np.pi, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.float32)
    for k in range(n):
        x, y = xx - k * step[0], yy - k * step[1]
        for c in range(3):
            frames[k, ..., c] = 0.5 + 0.25 * np.sin(freq[c, 0, 0] * x + freq[c, 0, 1] * y + phase[c, 0]) + 0.2 * np.cos(
                freq[c, 1, 0] * x - freq[c, 1, 1] * y + phase[c, 1]
            )
    return frames


def device_us(evt):
    """An event's own device time in us (the attribute's name differs across torch versions)."""
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def device_ms(fn, iters, name=None):
    """Mean device ms per call of ``fn()``: the kernels' own time in a
    ``torch.profiler`` trace of ``iters`` calls, after one warm-up (the
    host's launch cost, which :func:`cuda_ms` takes in for small calls, left
    out). With ``name``, for a call that launches one kernel: the mean time
    of the traced launches of the kernels whose names hold ``name``, which
    stays right when a trace of many short kernels drops some of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for attempt in range(6):  # a trace of a few short kernels now and then comes back empty: trace again, longer
        n = iters * 2**attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        seen.update(e.key for e in kernels)
        if name is not None:
            kernels = [e for e in kernels if name in e.key]
        total_us = sum(device_us(e) for e in kernels)
        if total_us > 0:
            return total_us / 1e3 / (n if name is None else sum(e.count for e in kernels))
    raise SmokeFailure(
        f"device_ms: six profiler traces saw no device time{'' if name is None else ' in ' + name}; kernels seen: {sorted(seen)[:8]}"
    )


def profile_forward(what, model_fn, *inputs, card, unit="forward", totals=None):
    """``torch.profiler`` over one forward of ``model_fn`` after a warm-up
    forward whose kernel launches are recorded: the top 10 ops by device
    time, each hand kernel's device ms and share of the device time, the
    device's idle share of the wall time; and per kernel of the kernels line
    that the forward launched, its launches, device ms and bound (the bytes
    and operations of its recorded launches) and the ms above it. A
    ``totals`` dict gets the forward's device ms, wall ms, idle share,
    kernel count and ``aten::cat``'s device ms (on the ``space`` axis, the
    halos' and gathers' joins)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log = []
    with recorded_work(log):
        model_fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model_fn(*inputs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_total = sum(device_us(e) for e in on_device)
    check(device_total > 0, "profiler saw no device time")
    body_us = {
        body: sum(device_us(e) for e in on_device if body in e.key) for bodies in KERNEL_BODIES.values() for body in bodies
    }
    shares = ", ".join(
        f"{body} {us / 1e3:.3f} ms ({100 * us / device_total:.2f} %)" for body, us in body_us.items() if us > 0
    )
    n_kernels = sum(e.count for e in on_device)
    if totals is not None:
        totals.update(device_ms=device_total / 1e3, wall_ms=wall_us / 1e3, idle_share=max(0.0, 1 - device_total / wall_us),
                      kernels=n_kernels, cat_ms=sum(device_us(e) for e in events if e.key == "aten::cat") / 1e3)
    ops = sorted((e for e in events if e not in on_device and device_us(e) > 0), key=device_us, reverse=True)
    print(
        f"profile {card}: one {what} {unit}, {device_total / 1e3:.3f} ms of kernels in "
        f"{wall_us / 1e3:.3f} ms wall, idle share {max(0.0, 1 - device_total / wall_us):.4f}, {n_kernels} kernels; "
        f"{shares} of device time",
        flush=True,
    )
    for e in ops[:10]:
        print(f"  profile op {e.key}: {device_us(e) / 1e3:.3f} ms ({100 * device_us(e) / device_total:.2f} %), {e.count} calls")
    per_kernel = {}
    for kernel, bodies in KERNEL_BODIES.items():
        work = [(nbytes, ops_) for k, nbytes, ops_, _ in log if k == kernel]
        if not work:
            continue
        b = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        dev_ms = sum(body_us[body] for body in bodies) / 1e3
        layouts = {}
        for k, _, _, layout in log:
            if k == kernel:
                layouts[layout] = layouts.get(layout, 0) + 1
        per_kernel[kernel] = {
            "launches": len(work), "device_ms": dev_ms, "bound_ms": b[0], "bound_by": b[1], "above_bound_ms": dev_ms - b[0],
            "launch_layouts": [
                {"shape": list(l[0]), "strides": list(l[1]), "offset": l[2], "dtype": l[3], "flow_strides": list(l[4]),
                 "flow_dtype": l[5], "zeros": l[6], "launches": n}
                for l, n in layouts.items()
            ],
        }
        print(
            f"  profile kernel {kernel}: {len(work)} launches, {dev_ms:.3f} ms on the device, bound {b[0]:.3f} ms "
            f"({b[1]}), {dev_ms - b[0]:.3f} ms above it",
            flush=True,
        )
    return per_kernel


@contextlib.contextmanager
def counted_calls(module, attr, log):
    """Inside, every callable that ``module.attr(...)`` builds (a model
    function, or a tuple of pair functions) appends ``(name, dtype, launches)``
    to ``log`` at each call: ``name`` "forward", "reuse" or "infer",
    ``dtype`` the ``dtype`` keyword it was built with, ``launches`` ``{"narrow",
    "wide", "splat"}`` that the call made."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    def counts():
        return {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}

    def counted(name, fn, dtype):
        def call(*args, **kwargs):
            before = counts()
            out = fn(*args, **kwargs)
            log.append((name, dtype, {k: v - before[k] for k, v in counts().items()}))
            return out

        return call

    real = getattr(module, attr)

    def build(*args, **kwargs):
        made = real(*args, **kwargs)
        dtype = kwargs.get("dtype")
        if isinstance(made, tuple):
            return tuple(counted(name, fn, dtype) for name, fn in zip(("reuse", "infer"), made))
        return counted("forward", made, dtype)

    setattr(module, attr, build)
    try:
        yield
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def cuda_spans(targets, spans):
    """Inside, each call of ``(owner, attr, label)`` of ``targets`` is
    bracketed by CUDA events on the current stream; ``spans[label]`` collects
    the event pairs (read them after a synchronize with :func:`span_ms`)."""
    import torch

    def wrap(fn, label):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.setdefault(label, []).append((start, end))
            return out

        return call

    real = [getattr(owner, attr) for owner, attr, _ in targets]
    try:
        for (owner, attr, label), fn in zip(targets, real):
            setattr(owner, attr, wrap(fn, label))
        yield
    finally:
        for (owner, attr, _), fn in zip(targets, real):
            setattr(owner, attr, fn)


def span_ms(spans):
    """``{label: (calls, ms)}`` of :func:`cuda_spans`' event pairs."""
    return {label: (len(pairs), sum(s.elapsed_time(e) for s, e in pairs)) for label, pairs in spans.items()}


def sepconv_conditioned(seed):
    """``sepconv.init_params(seed)`` with each kernel head's last
    convolution scaled by 0.05 and its bias at 1/51 (``bench.py``'s
    conditioning: a filter's taps sum to about 1, as a trained
    checkpoint's do, so the normaliser the output is divided by is not
    near 0)."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.models import sepconv

    sd = sepconv.init_params(seed)
    for head in ("netVerone", "netVertwo", "netHorone", "netHortwo"):
        sd[f"{head}.netMain.3.weight"] = sd[f"{head}.netMain.3.weight"] * 0.05
        sd[f"{head}.netMain.3.bias"] = torch.full_like(sd[f"{head}.netMain.3.bias"], 1.0 / 51.0)
    return sd


def momo_conditioned(sd):
    """MoMo's ``sd`` with the latent head times 0.02 and the mask head times
    0.1: the denoiser's predictions stay within ~0.2 and none clips
    (``tests/test_torch_momo.py:_conditioned``)."""
    return {k: v * {"model.mid_model.conv_out": 0.02, "model.out_up.proj_out.2": 0.1}.get(k.rsplit(".", 1)[0], 1.0)
            for k, v in sd.items()}


def family_trainer(name, device, mesh=None):
    """The module of training family ``name`` (``FAMILIES``) from its
    ``init_params(0)`` (every tensor of its checkpoint, ``strict=True``;
    Sepconv's and MoMo's conditioned as their inference phases condition
    them), ``channels_last`` on ``device`` in f32 (IFUnet's batch norms in
    ``eval()``, as ``_load`` leaves them: JAX's are constants), an Adam 1e-4
    over it and its step: ``(net, step)``, ``step(frames, t, target) ->
    loss`` (detached). The two-frame families step through
    ``parallel.make_train_step`` on ``mesh`` (one device by default); STMFNet and FLAVR
    take four frames, which no ``make_train_step`` carries, so their step is
    the same L1 through ``loss.backward()`` and the optimizer. ATM is base
    with global motion, no ensemble; MoMo base denoises ``FAMILY_MOMO_STEPS``
    steps on noise drawn once per batch shape from a fixed seed, the same on
    every device and in every run."""
    import torch
    from comfyui_frame_interpolation_tpu_torch import parallel
    from comfyui_frame_interpolation_tpu_torch.models import (
        amt, atm, cain, eisai, film, flavr, gmfss, ifrnet, ifunet, momo, sepconv, stmfnet, xvfi,
    )
    from comfyui_frame_interpolation_tpu_torch.parallel import train

    f32 = torch.float32
    nchw = lambda x: x.permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    if name in ("gmfss", "gmfss_union"):
        union = name == "gmfss_union"
        net, apply_fn = gmfss._load(gmfss.init_params(0, union=union), union, f32, device), gmfss.apply
    elif name == "eisai":
        net = eisai._load(eisai.init_params(0), f32, device)
        apply_fn = lambda n, f0, f1, t: eisai.apply(n, f0, f1, t, iters=FAMILY_EISAI_ITERS)  # noqa: E731
    elif name == "xvfi":
        ckpt = "XVFInet_Vimeo_exp1_latest.pt"
        cfg = xvfi.CKPT_CONFIGS[ckpt]
        net = xvfi._load(xvfi.init_params(ckpt, 0), cfg["module_scale_factor"], f32, device)
        apply_fn = lambda n, f0, f1, t: xvfi.apply(n, f0, f1, t, cfg["S_tst"])  # noqa: E731
    elif name == "stmfnet":
        net = stmfnet._load(stmfnet.init_params(0), f32, device)
        predict = lambda frames: nhwc(stmfnet.apply(net, *(stmfnet._nchw(f) for f in frames)))  # noqa: E731
    elif name == "ifrnet":
        net = ifrnet.IFRNet("S")
        net.load_state_dict(ifrnet.init_params("S", 0), strict=True)
        net, apply_fn = net.to(device=device, memory_format=torch.channels_last), ifrnet.apply
    elif name == "amt":
        net, apply_fn = amt._load(amt.init_params("S", 0), "S", 3, f32, device), amt.apply
    elif name == "film":
        net, apply_fn = film._load(film.init_params(0), f32, device), film.apply
    elif name == "ifunet":
        net, apply_fn = ifunet._load(ifunet.init_params(0), f32, device), ifunet.apply
    elif name == "atm":
        net = atm._load(atm.init_params("base", 0), "base", f32, device)
        apply_fn = lambda n, f0, f1, t: atm.apply(n, f0, f1, global_motion=True, ensemble_global_motion=False)  # noqa: E731
    elif name in ("cain", "sepconv"):
        mod, params = (cain, cain.init_params(0)) if name == "cain" else (sepconv, sepconv_conditioned(0))
        net = mod._load(params, f32, device)
        apply_fn = lambda n, f0, f1, t: nhwc(mod.apply(n, nchw(f0), nchw(f1)))  # noqa: E731
    elif name == "flavr":
        net = flavr._load(flavr.init_params(0), f32, device)
        predict = lambda frames: nhwc(flavr.apply(net, torch.stack(frames, 1).permute(0, 4, 1, 2, 3))[0])  # noqa: E731
    elif name == "momo":
        net = momo._load(momo_conditioned(momo.init_params(0, "momo-base.pth")), "momo-base.pth", f32, device)
        noises = {}

        def apply_fn(n, f0, f1, t):
            b, h, w, _ = f0.shape
            key = (b, h, w, str(f0.device))
            if key not in noises:
                gen = torch.Generator().manual_seed(0)
                noises[key] = [torch.randn((b, 4, h, w), generator=gen).to(f0.device).contiguous(memory_format=torch.channels_last)
                               for _ in range(FAMILY_MOMO_STEPS + 1)]
            z = noises[key]
            frames = (nchw(f).contiguous(memory_format=torch.channels_last) for f in (f0, f1))
            return nhwc(momo.apply(n, *frames, FAMILY_MOMO_STEPS, init_latents=z[0], step_noises=z[1:]))
    else:
        raise ValueError(name)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    if name in FAMILY_FOUR_FRAMES:
        def step(frames, t, target):
            opt.zero_grad(set_to_none=True)
            loss = train.l1_loss(predict(frames), target)
            loss.backward()
            opt.step()
            return loss.detach()
    else:
        two = parallel.make_train_step(apply_fn, opt, mesh or parallel.make_mesh(1, devices=[torch.device(device)]), net)

        def step(frames, t, target):
            return two(frames[0], frames[1], t, target)
    return net, step


def family_batch(name, b, hw, seed, device):
    """``(frames, t, target)`` for family ``name``: random NHWC frames (four
    for STMFNet and FLAVR) and target from numpy's ``seed``, t uniform in
    (0.1, 0.9)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.random((b, *hw, 3), dtype=np.float32)).to(device)
              for _ in range(4 if name in FAMILY_FOUR_FRAMES else 2)]
    target = torch.from_numpy(rng.random((b, *hw, 3), dtype=np.float32)).to(device)
    t = torch.from_numpy(rng.uniform(0.1, 0.9, b).astype(np.float32)).to(device)
    return frames, t, target


@contextlib.contextmanager
def family_twins():
    """Inside, the families' warps and splats call the plain twins directly
    (autograd through them): the reference for the kernels on the same
    card."""
    from comfyui_frame_interpolation_tpu_torch.models import atm, eisai, film, gmfss, ifrnet, rife, stmfnet, xvfi

    splat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
    warp_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")

    def twin_warp(img, flow, padding_mode="border", prefer_wide=False):
        return warp_mod.warp_torch(img, flow, padding_mode)

    def twin_splat(x, flow):
        return splat_mod.softsplat_torch(x, flow)

    # IFUnet and AMT warp through ifrnet.warp_nchw
    targets = [(m, "warp", twin_warp) for m in (gmfss, eisai, rife, xvfi, stmfnet, ifrnet, film, atm)]
    targets += [(splat_mod, "softsplat_func", twin_splat), (xvfi, "softsplat_func", twin_splat)]
    real = [getattr(m, a) for m, a, _ in targets]
    try:
        for m, a, fn in targets:
            setattr(m, a, fn)
        yield
    finally:
        for (m, a, _), fn in zip(targets, real):
            setattr(m, a, fn)


@contextlib.contextmanager
def no_twin_with_grad():
    """Inside, a CUDA warp or splat that needs a gradient reaching a plain
    twin fails the run: the kernels must carry every one."""
    import torch

    splat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
    warp_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")
    real_warp, real_splat = warp_mod.warp_torch, splat_mod.softsplat_torch

    def needs(x, flow):
        return x.is_cuda and torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad)

    def warp_guard(img, flow, padding_mode="border", row0=0):
        check(not needs(img, flow), "a CUDA warp that needs a gradient reached the plain twin")
        return real_warp(img, flow, padding_mode, row0)

    def splat_guard(x, flow):
        check(not needs(x, flow), "a CUDA splat that needs a gradient reached the plain twin")
        return real_splat(x, flow)

    warp_mod.warp_torch, splat_mod.softsplat_torch = warp_guard, splat_guard
    try:
        yield
    finally:
        warp_mod.warp_torch, splat_mod.softsplat_torch = real_warp, real_splat


def kernel_counts():
    """Every hand kernel's launch counter, by the kernels line's short names."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    return {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches,
            "backward": warp_kernel.backward_launches, "splat_backward": softsplat_kernel.backward_launches}


def zero_kernel_counts():
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    warp_kernel.launches = warp_kernel.wide_launches = warp_kernel.backward_launches = 0
    softsplat_kernel.launches = softsplat_kernel.backward_launches = 0


def grad_rel(got, ref, atol=1e-7):
    """Per tensor, the largest error less ``atol`` over the tensor's largest
    magnitude (0 where the error is within ``atol``: the tests' slack for
    gradients that are 0 but for rounding, such as a bias before a
    normalisation)."""
    out = {}
    for k, r in ref.items():
        err, scale = (got[k] - r).abs().max().item(), r.abs().max().item()
        out[k] = 0.0 if err <= atol else (err - atol) / scale if scale > 0 else math.inf
    return out


def space_train_phase(what, make_step, batch, want, mesh_one, mesh_split, card, timed=False):
    """One training step on the ``(1, 2)`` mesh of replicas of the card
    against one device (phases 92-93): ``make_step(mesh) -> (net, step)``
    builds the module from its seed and its ``make_train_step`` step,
    ``step(f0, f1, t, target) -> loss``; ``batch`` is ``(f0, f1, t,
    target)``. f32 with TF32 off and cuDNN's deterministic algorithms: one
    device, the split, one device with both frames one f32 ulp up (the
    step's own gap for inputs that move by rounding, as phases 87-90 hold
    their frames) and one device with every weight times 1 + 2^-22 (two f32
    ulps, phase 74's yardstick: it moves every sum of the backward, as the
    bands' other cuDNN algorithms and reduction orders do, where the
    frames' ulp leaves the weight gradients' sums in their order). The
    split's loss within 4x the larger of the two moves or 1e-6 relative;
    each gradient within 4x the larger move on it, or 5e-5 of its tensor's
    largest (phase 74's floor), or 1e-6 of the largest gradient of all (a
    gradient that is 0 but for rounding, such as a bias before a
    normalisation); one device launching ``want`` and the split exactly
    twice that. With ``timed``: steps/s of both in turns (one round of 2
    steps each after one, TF32 at its defaults), each one's peak memory
    above what it holds and a profiled step (idle share, kernels). Returns
    the phase's record."""
    import torch

    f0, f1, t, target = batch
    up = lambda x: torch.nextafter(x, torch.full_like(x, 2.0))  # noqa: E731
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    det = torch.backends.cudnn.deterministic
    runs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        for key, mesh, inputs, scale in (("one device", mesh_one, (f0, f1), 0.0), ("(1, 2) mesh", mesh_split, (f0, f1), 0.0),
                                         ("one device, inputs one ulp up", mesh_one, (up(f0), up(f1)), 0.0),
                                         ("one device, weights two ulps up", mesh_one, (f0, f1), 2.0**-22)):
            net, step = make_step(mesh)
            if scale:
                with torch.no_grad():
                    for p in net.parameters():
                        p.mul_(1 + scale)
            torch.cuda.synchronize()
            zero_kernel_counts()
            loss = step(*inputs, t, target).item()
            torch.cuda.synchronize()
            runs[key] = (loss, {k: v.grad.clone() for k, v in net.named_parameters() if v.grad is not None}, kernel_counts())
            del net, step
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (loss1, grads1, n1), (loss2, grads2, n2), (loss_up, grads_up, _), (loss_w, grads_w, _) = runs.values()
    check(n1 == want and n2 == {k: 2 * v for k, v in want.items()},
          f"{what} launches: one device {n1}, the (1, 2) mesh {n2}; expected {want} and exactly twice that")
    check(grads1.keys() == grads2.keys() == grads_up.keys() == grads_w.keys(),
          f"{what}: the split step's gradients are not one device's tensors")
    loss_nudge = max(abs(loss_up - loss1), abs(loss_w - loss1))
    check(math.isfinite(loss2) and abs(loss2 - loss1) <= max(1e-6 * abs(loss1), 4 * loss_nudge),
          f"{what}: the (1, 2) step's loss {loss2} against one device's {loss1}, above 1e-6 relative and 4x {loss_nudge} (one "
          f"device's move for its inputs one ulp up or its weights two)")
    top = max(r.abs().max().item() for r in grads1.values())
    over, worst, worst_nudge, glob = {}, (0.0, ""), (0.0, ""), 0.0
    for k, r in grads1.items():
        scale = max(r.abs().max().item(), 1e-30)
        err = (grads2[k] - r).abs().max().item()
        nudge = max((grads_up[k] - r).abs().max().item(), (grads_w[k] - r).abs().max().item())
        worst, worst_nudge, glob = max(worst, (err / scale, k)), max(worst_nudge, (nudge / scale, k)), max(glob, err / top)
        if not err <= max(4 * nudge, 5e-5 * scale, 1e-6 * top):
            over[k] = (err, nudge, scale)
    check(not over, f"{what}: the (1, 2) step's gradients against one device, (max err, one device's larger move for its "
          f"inputs one ulp up or its weights two, largest) above 4x the move, 5e-5 of the largest and 1e-6 of the largest "
          f"gradient of all ({top}): {dict(list(over.items())[:4])}")
    row = {"loss": loss2, "loss_one_device": loss1, "loss_one_device_one_ulp_input": loss_up,
           "loss_one_device_two_ulp_weights": loss_w, "grad_rel_err": worst[0], "grad_rel_worst": worst[1],
           "grad_err_over_largest_of_all": glob, "one_device_move_grad_rel": worst_nudge[0],
           "one_device_move_grad_rel_worst": worst_nudge[1], "launches": {"one device": n1, "(1, 2) mesh": n2}}
    del runs, grads1, grads2, grads_up, grads_w
    if timed:
        steps = {key: make_step(mesh)[1] for key, mesh in (("one device", mesh_one), ("(1, 2) mesh", mesh_split))}
        for step in steps.values():
            step(*batch)
        rates = {key: [] for key in steps}
        for key in ("one device", "(1, 2) mesh", "(1, 2) mesh", "one device"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(2):
                steps[key](*batch)
            torch.cuda.synchronize()
            rates[key].append(2 / (time.perf_counter() - t1))
        row["training"] = {}
        for key, step in steps.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step(*batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            totals = {}
            profile_forward(f"{what}, {key}", step, *batch, card=card, unit="step", totals=totals)
            row["training"][key] = {"steps_per_s": statistics.mean(rates[key]), "steps_per_s_turns": rates[key], "peak_bytes": peak,
                                    "idle_share": totals["idle_share"], "device_ms": totals["device_ms"],
                                    "wall_ms": totals["wall_ms"], "kernels": totals["kernels"]}
        del steps
    torch.cuda.empty_cache()
    return row


def family_phase(name, number, dev, card):
    """Phase ``number``: one training step of family ``name`` at
    ``FAMILY_TRAIN_BATCH`` x ``FAMILY_TRAIN_HW`` f32 on the card, TF32 off,
    cuDNN deterministic, through the kernels (twice: their f32 atomics sum in
    orders that change from run to run) and through the plain twins, with
    every backward launch captured; the kernels' step held to the twins'
    (the loss within 1e-6 relative, each gradient within 1e-4 of its
    tensor's largest or 4x the two kernel runs' own difference on it, after
    1e-7 absolute: :func:`grad_rel`) and
    launching exactly ``FAMILY_STEP_LAUNCHES[name]``, with no CUDA warp or
    splat that needs a gradient reaching a twin; each captured backward
    launch held to its plain version (``backward_vs_plain``,
    ``splat_backward_vs_plain``); the same step at b1 on the card against
    the CPU with phase 49's rule (each tensor after 1e-7 absolute; the
    updates where ``|g|`` is also over 1e-5); then the
    step timed at TF32 defaults (``TIMING_WINDOWS``
    windows of 2 steps after 2), its peak memory and one profiled step.
    Returns the phase's record."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    t0 = time.perf_counter()
    b, hw = FAMILY_TRAIN_BATCH, FAMILY_TRAIN_HW
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    batch = family_batch(name, b, hw, number, dev)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    det = torch.backends.cudnn.deterministic

    def once(device, data, twin=False, capture=None):
        """One step: ``(loss, grads, updates)`` on the host."""
        net, step = family_trainer(name, device)
        before = {k: v.detach().clone() for k, v in net.named_parameters()}
        with contextlib.ExitStack() as stack:
            if twin:
                stack.enter_context(family_twins())
            if capture is not None:
                def keep_warp(img, flow, grad_out, zeros=False, img_grad=True):
                    capture.append(("warp", img.detach(), flow.detach(), grad_out, zeros, img_grad))

                def keep_splat(x, flow, grad_out, in_grad=True):
                    capture.append(("splat", x.detach(), flow.detach(), grad_out, False, in_grad))

                stack.enter_context(spying([(warp_kernel, "warp_bilinear_backward", keep_warp),
                                            (softsplat_kernel, "softsplat_bilinear_backward", keep_splat)]))
            loss = step(*data).item()
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach().cpu() for k, v in net.named_parameters()}
        return loss, grads, {k: (v.detach() - before[k]).cpu() for k, v in net.named_parameters()}

    captured = []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        twin_loss, twin_grads, _ = once(dev, batch, twin=True)
        with no_twin_with_grad():
            torch.cuda.synchronize()
            zero_kernel_counts()
            k_loss, k_grads, _ = once(dev, batch, capture=captured)
            torch.cuda.synchronize()
            launches = kernel_counts()
            k2_loss, k2_grads, _ = once(dev, batch)
        small = family_batch(name, 1, FAMILY_CHECK_HW.get(name, (64, 64)), number + 100, "cpu")
        c_loss, c_grads, c_deltas = once(dev, [[f.to(dev) for f in small[0]], small[1].to(dev), small[2].to(dev)])
        with torch.backends.mkldnn.flags(enabled=name != "stmfnet"):
            # this CPU leg alone: oneDNN's channels_last 1x1 stride-2 weight
            # gradient at 6 input channels (STMFNet's first MS-ResNeXt skip)
            # corrupts the heap in some torch CPU builds
            cpu_loss, cpu_grads, cpu_deltas = once("cpu", small)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    expected = FAMILY_STEP_LAUNCHES[name]
    check(launches == expected, f"one {name} training step launched {launches}, expected {expected}")
    check(math.isfinite(k_loss) and abs(k_loss - twin_loss) <= 1e-6 * abs(twin_loss),
          f"{name} training step loss with the kernels {k_loss} vs through the twins {twin_loss} on the card")
    kt, kk = grad_rel(k_grads, twin_grads), grad_rel(k_grads, k2_grads)
    over = {k: (kt[k], kk[k]) for k in kt if kt[k] > max(1e-4, 4 * kk[k])}
    check(not over, f"{name} training step gradients, kernels vs twins on the card, beyond 1e-4 and 4x the kernels' own "
                    f"run-to-run difference: {dict(list(over.items())[:4])}")
    kt_worst = max(kt, key=kt.get)
    # card against CPU, phase 49's rule
    cc = grad_rel(c_grads, cpu_grads)
    cc_worst = max(cc, key=cc.get)
    top = max(v.abs().max().item() for v in cpu_grads.values())
    cc_glob = max((c_grads[k] - cpu_grads[k]).abs().max().item() for k in cpu_grads) / top
    check(abs(c_loss - cpu_loss) <= 1e-5 * abs(cpu_loss), f"{name} training step loss card {c_loss} vs CPU {cpu_loss}")
    check(cc[cc_worst] <= 5e-2 and cc_glob <= 5e-3,
          f"{name} training step gradients card vs CPU: {cc[cc_worst]:.3g} of {cc_worst}'s largest (at most 5e-2), "
          f"{cc_glob:.3g} of the largest of all (at most 5e-3)")
    upd_err = 0.0
    for k, gk in cpu_grads.items():
        # where Adam's first step is -lr * sign(g): |g| well above its 1e-8
        # epsilon (a gradient that is 0 but for rounding, as before an
        # instance norm, moves by an eps-dependent fraction of lr)
        big = (gk.abs() > 0.5 * gk.abs().max()) & (gk.abs() > 1e-5)
        if big.any():
            upd_err = max(upd_err, (c_deltas[k][big] - cpu_deltas[k][big]).abs().max().item())
    check(upd_err <= 1e-3 * 1e-4 + 2.0**-20, f"{name} training step updates card vs CPU: max err {upd_err:.3g}")
    # every backward launch of the step against its plain version
    errs, shapes = {"warp": [0.0, 0.0], "splat": [0.0, 0.0]}, {"warp": {}, "splat": {}}
    for kind, x, flow, grad_out, zeros, with_x in captured:
        key = f"{list(nhwc(x).shape)} {'zeros' if zeros else 'border'}" if kind == "warp" else f"{list(nhwc(x).shape)}"
        if kind == "warp":
            e = backward_vs_plain(nhwc(x), nhwc(flow), "zeros" if zeros else "border", f"{name} step", grad_out=nhwc(grad_out))
        else:
            e = splat_backward_vs_plain(nhwc(x), nhwc(flow), f"{name} step", grad_out=nhwc(grad_out), in_grad=with_x)
        errs[kind] = [max(a, c) for a, c in zip(errs[kind], e)]
        shapes[kind][key] = shapes[kind].get(key, 0) + 1
    largest = {kind: max(((x, flow, grad_out, zeros, with_x) for k_, x, flow, grad_out, zeros, with_x in captured if k_ == kind),
                         key=lambda c: c[0].numel(), default=None) for kind in ("warp", "splat")}
    del captured
    check_s = time.perf_counter() - t0
    # timing, TF32 at torch's defaults
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    net, step = family_trainer(name, dev)
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    windows = []
    for _ in range(TIMING_WINDOWS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(2):
            loss = step(*batch)
        torch.cuda.synchronize()
        windows.append(1e3 * (time.perf_counter() - ts) / 2)
        check(bool(torch.isfinite(loss)), f"{name} training step: loss {loss}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    totals = {}
    prof = profile_forward(f"{name} training step b{b} {hw[0]}x{hw[1]} f32 (TF32 at its defaults)", step, *batch, card=card,
                           unit="step", totals=totals)
    del net, step
    ms = statistics.median(windows)
    shares = {k: {"launches": v["launches"], "device_ms": v["device_ms"], "share": v["device_ms"] / totals["device_ms"],
                  "bound_ms": v["bound_ms"]}
              for k, v in prof.items() if k in ("warp_bilinear_backward", "softsplat_bilinear_backward")}
    row = {
        "launches": launches, "steps_per_s": 1e3 / ms, "samples_per_s": 1e3 * b / ms, "ms_per_step": ms,
        "ms_per_step_windows": windows, "spread_ms": max(windows) - min(windows), "peak_bytes": peak,
        "idle_share": totals["idle_share"], "device_ms": totals["device_ms"], "kernels_per_step": totals["kernels"],
        "backward_shares": shares, "max_abs_err": errs, "backward_shapes": shapes,
        "kernels_vs_twins": kt[kt_worst], "card_vs_cpu": cc[cc_worst], "card_vs_cpu_global": cc_glob,
    }
    print(
        f"{name} train (phase {number}) {card}: b{b}x{hw[0]}x{hw[1]} f32, TF32 off, cuDNN deterministic: launches {launches}; "
        f"kernels vs the plain twins on the card: loss {k_loss:.7f} vs {twin_loss:.7f}, gradients within {kt[kt_worst]:.3g} of "
        f"each tensor's largest ({kt_worst}; the kernels' own run-to-run difference there {kk[kt_worst]:.3g}); card vs CPU at b1 "
        f"{FAMILY_CHECK_HW.get(name, (64, 64))}: loss {c_loss:.7f} vs {cpu_loss:.7f}, gradients within {cc[cc_worst]:.3g} "
        f"({cc_worst}) and {cc_glob:.3g} of the largest of all, updates within {upd_err:.3g}; backward launches vs plain: warp "
        f"{shapes['warp']} max err {errs['warp'][0]:.3g}, {errs['warp'][1]:.3g}; splat {shapes['splat']} max err "
        f"{errs['splat'][0]:.3g}, {errs['splat'][1]:.3g}; checks {check_s:.1f} s",
        flush=True,
    )
    print(
        f"timing {card}: {name} training b{b} {hw[0]}x{hw[1]} f32, Adam 1e-4: {1e3 / ms:.3f} steps/s, {1e3 * b / ms:.2f} samples/s "
        f"(median {ms:.3f} ms a step over {len(windows)} windows of 2 steps; windows {min(windows):.3f} to {max(windows):.3f} ms), peak "
        f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held, idle share {totals['idle_share']:.4f}; backward kernels' "
        f"share of the step's device time: "
        + (", ".join(f"{k} {v['launches']} launches {v['device_ms']:.3f} ms ({100 * v['share']:.2f} %)" for k, v in shares.items()) or "none")
        + f"; phase {time.perf_counter() - t0:.1f} s (timing {time.perf_counter() - t1:.1f} s)",
        flush=True,
    )
    return row, largest


def largest_backward_times(largest, card):
    """Each backward kernel at the largest input (by elements) that some
    steps gave it, as the step gave it: ``largest`` is a list of ``(kind,
    path, capture)``. The op's ms, the plain version's and the library
    call's in turns (``utils/kernel_compare.library_backward`` for the warp,
    :func:`splat_backward_library_call` for the splat), the kernel's device
    ms and its bound; ``{kernel: {path: row}}``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_backward_torch
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp_backward_torch
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import library_backward

    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    out = {}
    for kind, path, (x, flow, grad_out, zeros, with_x) in largest:
        if kind == "warp":
            mode = "zeros" if zeros else "border"
            kernel = lambda: warp_kernel.warp_bilinear_backward(x, flow, grad_out, zeros, with_x)  # noqa: E731
            plain = lambda: warp_backward_torch(nhwc(x), nhwc(flow), nhwc(grad_out), mode)  # noqa: E731
            library = library_backward(nhwc(x), nhwc(flow), nhwc(grad_out), zeros, with_x)
            work, body, name = backward_work(x, flow, with_x), "warp_bilinear_backward_kernel", "warp_bilinear_backward"
        else:
            kernel = lambda: softsplat_kernel.softsplat_bilinear_backward(x, flow, grad_out, with_x)  # noqa: E731
            plain = lambda: softsplat_backward_torch(nhwc(x), nhwc(flow), nhwc(grad_out))  # noqa: E731
            library = splat_backward_library_call(nhwc(x), nhwc(flow), nhwc(grad_out))
            work, body, name = splat_backward_work(x, flow, with_x), "softsplat_backward_kernel", "softsplat_bilinear_backward"
        times = in_turns({"plain": (plain, 3), "kernel": (kernel, 10), "library": (library, 10)})
        ms = {k: statistics.mean(v) for k, v in times.items()}
        dev_ms = device_ms(kernel, 10, name=body)
        b = bound(*work)
        key = f"{path}: {list(nhwc(x).shape)} {str(x.dtype).split('.')[-1]}" + (f" {'zeros' if zeros else 'border'}" if kind == "warp" else "")
        out.setdefault(name, {})[path] = {"shape": key, "ms": ms["kernel"], "kernel_device_ms": dev_ms, "plain_ms": ms["plain"],
                                          "library_ms": ms["library"], "bound_ms": b[0], "bound_by": b[1]}
        print(
            f"timing {card}: {name} at the largest input of {key}: " + ", ".join(f"{k} {ms[k]:.4f} ms {v}" for k, v in times.items())
            + f"; the kernel alone {dev_ms:.4f} ms on the device; bound {b[0]:.4f} ms ({b[1]}), the kernel at "
            f"{100 * b[0] / dev_ms:.1f} % of it",
            flush=True,
        )
    return out


SPLAT_BACKWARD_STEPS = ("m2m_f32", "m2m_bf16") + tuple(n for n in FAMILIES if FAMILY_STEP_LAUNCHES[n]["splat_backward"])


def splat_backward_step_inputs(dev):
    """The splat backward launches of one training step of each path of
    ``SPLAT_BACKWARD_STEPS`` (M2M at ``M2M_TRAIN_BATCH`` x ``M2M_TRAIN_HW``
    in f32 and bf16, as phase 54 times it; the families at
    ``FAMILY_TRAIN_BATCH`` x ``FAMILY_TRAIN_HW`` f32, as phases 55-61 do),
    with the tensors as the steps hand them over: ``(layouts, per_step)``,
    ``layouts`` ``{key: (planes, flow planes, grad_out planes, in_grad)}``,
    one per distinct shape, strides, start offset and dtypes, and
    ``per_step`` ``{step: {key: launches}}``."""
    import torch
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel

    layouts, per_step = {}, {}
    dt = lambda t: str(t.dtype).split(".")[-1]  # noqa: E731
    for path in SPLAT_BACKWARD_STEPS:
        if path.startswith("m2m"):
            dtype = torch.float32 if path == "m2m_f32" else torch.bfloat16
            _, step = m2m_trainer(dev, dtype)
            batch = train_batch(M2M_TRAIN_BATCH, M2M_TRAIN_HW, 54, dev, dtype)
        else:
            _, step = family_trainer(path, dev)
            batch = family_batch(path, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_HW, 63, dev)
        counts = per_step.setdefault(path, {})

        def keep(x, flow, grad_out, in_grad=True):
            key = (f"{list(x.permute(0, 2, 3, 1).shape)} {dt(x)} strides {list(x.stride())} "
                   f"+{x.data_ptr() % 16 // x.element_size()}, {dt(flow)} flow strides {list(flow.stride())}, grad_out "
                   f"strides {list(grad_out.stride())} +{grad_out.data_ptr() % 16 // 4}" + ("" if in_grad else ", no input gradient"))
            counts[key] = counts.get(key, 0) + 1
            layouts.setdefault(key, (x.detach(), flow.detach(), grad_out, bool(in_grad)))

        with spying([(softsplat_kernel, "softsplat_bilinear_backward", keep)]):
            step(*batch)
        torch.cuda.synchronize()
        del step, batch
    return layouts, per_step


def splat_backward_times(layouts, card):
    """Each of ``layouts`` (``{key: (planes, flow planes, grad_out planes,
    in_grad)}``): the splat backward kernel's device ms from a profile and
    its bound, the two library calls' device ms
    (:func:`splat_backward_library_call`), and in turns the op's, the
    plain version's and the library calls' ms. Returns ``{key: row}``."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_backward_torch

    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    rows = {}
    for key, (x, flow, grad_out, in_grad) in layouts.items():
        kernel = lambda: softsplat_kernel.softsplat_bilinear_backward(x, flow, grad_out, in_grad)  # noqa: E731
        library = splat_backward_library_call(nhwc(x), nhwc(flow), nhwc(grad_out))
        small = x.numel() < 5e7
        times = in_turns({
            "plain": (lambda: softsplat_backward_torch(nhwc(x), nhwc(flow), nhwc(grad_out)), 2),
            "kernel": (kernel, 10),
            "two library calls": (library, 10 if small else 3),
        })
        ms = {k: statistics.mean(v) for k, v in times.items()}
        dev_ms = device_ms(kernel, 10 if small else 3, name="softsplat_backward_kernel")
        lib_dev_ms = device_ms(library, 5 if small else 2)
        b = bound(*splat_backward_work(x, flow, in_grad))
        rows[key] = {"kernel_device_ms": dev_ms, "bound_ms": b[0], "bound_by": b[1], "share_of_bound": b[0] / dev_ms,
                     "library_device_ms": lib_dev_ms, "ms": ms["kernel"], "plain_ms": ms["plain"],
                     "library_ms": ms["two library calls"], "turns": times}
        print(
            f"splat backward {card}: {key}: the kernel {dev_ms:.4f} ms on the device, bound {b[0]:.4f} ms ({b[1]}), "
            f"{100 * b[0] / dev_ms:.1f} % of it; two library calls {lib_dev_ms:.4f} ms on the device; in turns "
            + ", ".join(f"{k} {ms[k]:.4f} ms {v}" for k, v in times.items()),
            flush=True,
        )
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def clock(phase):
        """One line at the start of each phase: the seconds since the run
        began, so the run's time can be split by phase."""
        print(f"clock: phase {phase} starts at {time.perf_counter() - t_start:.1f} s", flush=True)

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import warp_cases
    from comfyui_frame_interpolation_tpu_torch.core.loop import _pair_groups, run_plan, run_plan_pair_cached, run_plan_window4
    from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_bisection, plan_timestep, plan_window4
    from comfyui_frame_interpolation_tpu_torch.models import (
        amt, atm, cain, eisai, film, flavr, gmfss, ifrnet, ifunet, m2m, momo, rife, sepconv, stmfnet, xvfi,
    )
    from comfyui_frame_interpolation_tpu_torch.models.common import device_const, reflect_pad
    from comfyui_frame_interpolation_tpu_torch.nodes.rife_node import RIFE_VFI
    from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import (
        AMT_VFI, ATM_VFI, CAIN_VFI, EISAI_VFI, FILM_VFI, FLAVR_VFI, GMFSS_Fortuna_VFI, IFRNet_VFI, IFUnet_VFI, M2M_VFI, MOMO_VFI,
        STMFNet_VFI, SepconvVFI, XVFI_VFI, _pad16,
    )
    from comfyui_frame_interpolation_tpu_torch.ops.adacof import adacof_func
    from comfyui_frame_interpolation_tpu_torch.ops.bidir_corr import BidirCorr
    from comfyui_frame_interpolation_tpu_torch.ops import sepconv as sepconv_op
    from comfyui_frame_interpolation_tpu_torch.ops.correlation import correlation_func
    from comfyui_frame_interpolation_tpu_torch.ops.sepconv import sepconv_func
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import build, softsplat_kernel, warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import (
        function_softsplat, softsplat, softsplat_backward_torch, softsplat_func, softsplat_torch,
    )
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_backward_torch, warp_torch
    from comfyui_frame_interpolation_tpu_torch.core.config import load_config
    from comfyui_frame_interpolation_tpu_torch.utils.benchmark import measure
    from comfyui_frame_interpolation_tpu_torch.utils.ckpt import save_npz
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import library_splat

    dev = torch.device("cuda")

    # ---- 1. device -----------------------------------------------------------
    clock("1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build ------------------------------------------------------------
    clock("2")
    def timed_build(name):
        t0 = time.perf_counter()
        build.load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # nvcc runs outside the GIL
        build_s = dict(zip(("warp", "softsplat"), pool.map(timed_build, ("warp", "softsplat"))))
    print(
        f"build {card}: csrc/warp.cu {build_s['warp']:.2f} s, csrc/softsplat.cu {build_s['softsplat']:.2f} s "
        f"(nvcc, in parallel: {time.perf_counter() - t0:.2f} s in all), both loaded",
        flush=True,
    )
    for name in ("warp", "softsplat"):
        log = next((v for k, v in build.build_logs.items() if k[0] == name), "")
        for line in build.ptxas_summary(log) or ["built before this process: no ptxas log"]:
            print(f"build {card}: {name}.cu {line}", flush=True)

    # ---- 3. kernel vs plain on the card --------------------------------------
    clock("3")
    n_cases, bodies = 0, {}
    for case in warp_cases.warp_cases(0, 256, 512):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)
                flow = torch.from_numpy(case["flow"]).to(dev)
                planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
                routed = warp_kernel.route(planes.shape, planes.stride(), dtype)
                bodies[routed] = bodies.get(routed, 0) + 1
                ref = warp_torch(img, flow, mode)
                outs = {
                    f"routed ({routed})": warp(img, flow, mode),
                    "K1": warp_kernel.warp_bilinear(planes, fplanes, mode == "zeros").permute(0, 2, 3, 1),
                }
                torch.cuda.synchronize()
                for body, got in outs.items():
                    err = (got.float() - ref.float()).abs().max().item()
                    check(torch.equal(got, ref), f"kernel vs plain: {case['name']} {mode} {dtype} {body}: max err {err}, not bit-exact")
                n_cases += 1
    g = torch.Generator().manual_seed(0)
    main_img = torch.rand(MAIN_SHAPE, generator=g).to(dev, torch.bfloat16)
    main_flow = torch.from_numpy(warp_cases.smooth_flow(*MAIN_SHAPE[:3], amp=6.0)).to(dev)
    got, ref = warp(main_img, main_flow), warp_torch(main_img, main_flow)
    torch.cuda.synchronize()
    main_err = (got.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"K1 vs plain at {MAIN_SHAPE}: max err {main_err}, not bit-exact")
    del got, ref
    # K1's C = 7 and C = 3 builds at the other shapes and flows
    # of the main paths: RIFE's bf16 model (bf16 flow), RIFE's image warp,
    # M2M's image warps (zeros), EISAI's f32 Lab warps (f32 values and flow)
    bf16, f32 = torch.bfloat16, torch.float32
    path_errs = {
        f"{list(shape)} {str(vd).split('.')[-1]} {mode} {str(fd).split('.')[-1]} flow": routed_at_path_shape(
            shape, mode, fd, "tiled", g, value_dtype=vd
        )
        for shape, mode, vd, fd in (
            (MAIN_SHAPE, "border", bf16, bf16),
            ((16, 1088, 1920, 3), "border", bf16, f32),
            ((16, 1088, 1920, 3), "border", bf16, bf16),
            ((8, 1088, 1920, 3), "zeros", bf16, bf16),
            *((shape, "border", f32, f32) for shape in EISAI_WARP_SHAPES),
        )
    }
    print(
        f"kernel vs plain: {n_cases} case x mode x dtype runs at 256x512 (routed to {bodies}), the routed kernel "
        f"and K1 each bit-exact (max err 0); {list(MAIN_SHAPE)} bf16 K1 max err {main_err}; "
        f"K1 at the paths' shapes: " + ", ".join(f"{k} max err {v}" for k, v in path_errs.items()),
        flush=True,
    )

    # ---- 4. RIFE node end to end ---------------------------------------------
    clock("4")
    params = rife.init_params(0, "4.7")
    frames = shifted_pattern(4, 540, 960, seed=0)
    multiplier, batch = 2, 2
    kw = dict(multiplier=multiplier, fast_mode=True, ensemble=False, batch_size=batch, params=params)
    node = RIFE_VFI()
    calls_per_run = math.ceil(len(plan_timestep(4, multiplier).tasks) / batch)
    rife_dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = 0
    (out_f32,) = node.vfi("rife47.pth", frames, dtype="float32", device="cuda", **kw)
    (out_bf16,) = node.vfi("rife47.pth", frames, dtype="bfloat16", device="cuda", **kw)
    torch.cuda.synchronize()
    rife_warp_launches = warp_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (out_cpu,) = node.vfi("rife47.pth", frames, dtype="float32", device="cpu", **kw)
    n_out = 2 * 4 - 1
    for out in (out_f32, out_bf16):
        check(tuple(out.shape) == (n_out, 540, 960, 3) and out.is_cuda, f"node output {tuple(out.shape)} on {out.device}")
        check(bool(torch.isfinite(out).all()), "node output has non-finite values")
    check(torch.equal(out_f32[::2].cpu(), torch.from_numpy(frames)), "original frames not passed through")
    p32, p16 = psnr(out_f32, out_cpu), psnr(out_bf16, out_cpu)
    check(p32 >= 40.0, f"node fp32 cuda vs cpu {p32:.2f} dB < 40")
    check(p16 >= 40.0, f"node bf16 cuda vs fp32 cpu {p16:.2f} dB < 40")
    check(
        rife_warp_launches == 4 * 2 * calls_per_run,
        f"warp launches {rife_warp_launches} != 4 x {2 * calls_per_run} forward calls",
    )
    print(
        f"node: RIFE 4.7 4x540x960 x2 batch {batch} -> {n_out} frames; cuda fp32 vs cpu {p32:.2f} dB, "
        f"cuda bf16 vs cpu fp32 {p16:.2f} dB; K1 launches {rife_warp_launches} = 4 x {2 * calls_per_run} forward "
        f"calls",
        flush=True,
    )

    # RIFE 4.0: both fast modes through the node, then one forward whose
    # stage-1 flow update triggers the restart with doubled scales
    params40 = rife.init_params(0, "4.0")
    outs40, flags40, warps40 = {}, [], []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = 0
    with rescue_flags(flags40), captured_warps(warps40):
        for fast in (True, False):
            for dtype in ("float32", "bfloat16"):
                (outs40[fast, dtype],) = node.vfi(
                    RIFE40, frames, multiplier=multiplier, fast_mode=fast, ensemble=False, batch_size=batch,
                    params=params40, dtype=dtype, device="cuda",
                )
    torch.cuda.synchronize()
    rife40_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(len(flags40) == 4 * calls_per_run, f"RIFE 4.0: {len(flags40)} rescue tests for {4 * calls_per_run} forward calls")
    expect40 = {"narrow": 0, "wide": 0}
    for (fast, dtype), flags in zip(outs40, (flags40[i : i + calls_per_run] for i in range(0, len(flags40), calls_per_run))):
        for flag, _, _ in flags:
            per = rife.warps_per_forward("4.0", fast, False, rescued=flag, dtype=rife_dtypes[dtype])
            expect40 = {k: expect40[k] + per[k] for k in expect40}
    check(rife40_launches == expect40, f"RIFE 4.0 launches {rife40_launches} != {expect40} (rescues {flags40})")
    # every warp those runs launched, again on the same inputs against the twin
    seen40, n_warps40 = warps_vs_plain(warps40, "RIFE 4.0 node"), len(warps40)
    del warps40
    wide40 = {(shape, dt) for shape, mode, dt, fdt in seen40.get("warp_bilinear_wide", ()) if mode == "border" and fdt == dt}
    check(
        wide40 == {(shape, dt) for shape in RIFE40_WIDE_SHAPES for dt in ("float32", "bfloat16")},
        f"RIFE 4.0 wide warps {sorted(seen40.get('warp_bilinear_wide', ()))}, expected {RIFE40_WIDE_SHAPES} in f32 and bf16",
    )
    rife40_psnr = []
    for fast in (True, False):
        (out_cpu,) = node.vfi(
            RIFE40, frames, multiplier=multiplier, fast_mode=fast, ensemble=False, batch_size=batch,
            params=params40, dtype="float32", device="cpu",
        )
        for dtype in ("float32", "bfloat16"):
            out = outs40[fast, dtype]
            check(tuple(out.shape) == (n_out, 540, 960, 3) and out.is_cuda, f"RIFE 4.0 output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"RIFE 4.0 fast={fast} {dtype} has non-finite values")
            check(torch.equal(out[::2].cpu(), torch.from_numpy(frames)), f"RIFE 4.0 fast={fast} {dtype}: original frames not passed through")
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"RIFE 4.0 node fast={fast} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            rife40_psnr.append(f"fast={fast} {dtype} {p:.2f} dB")
    # the rescue: block 1's head scaled so its flow update is twice the limit
    largest = min(min(a, b) for _, a, b in flags40)
    k = 64.0 / largest
    rescue_params = dict(params40)
    for key in ("block1.lastconv.weight", "block1.lastconv.bias"):
        rescue_params[key] = params40[key] * k
    r0, r1 = (torch.from_numpy(frames[i : i + 2]) for i in (0, 1))
    rt = torch.full((2,), 0.5)
    rescue_out, rescue_flags_seen, rescue_warps = {}, [], []
    with rescue_flags(rescue_flags_seen), captured_warps(rescue_warps):
        for dev_, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cuda", torch.bfloat16)):
            fn = rife.make_model_fn(rescue_params, "4.0", fastmode=False, dtype=dtype, device=dev_)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            warp_kernel.launches = warp_kernel.wide_launches = 0
            rescue_out[dev_, dtype] = fn(r0, r1, rt)
            torch.cuda.synchronize()
            got = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches}
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            want = rife.warps_per_forward("4.0", False, False, rescued=True, dtype=dtype) if dev_ == "cuda" else {"narrow": 0, "wide": 0}
            check(got == want, f"RIFE 4.0 rescue forward on {dev_} {dtype}: launches {got} != {want}")
    check(all(f for f, _, _ in rescue_flags_seen), f"RIFE 4.0 rescue not taken: {rescue_flags_seen}")
    seen_rescue, n_rescue_warps = warps_vs_plain(rescue_warps, "RIFE 4.0 rescue forward"), len(rescue_warps)
    del rescue_warps
    wide_rescue = {(shape, dt) for shape, mode, dt, fdt in seen_rescue.get("warp_bilinear_wide", ()) if mode == "border" and fdt == dt}
    check(wide_rescue == wide40, f"RIFE 4.0 rescue forward's wide warps {sorted(seen_rescue.get('warp_bilinear_wide', ()))}")
    rescue_psnr = {str(d).split(".")[-1]: psnr(rescue_out["cuda", d], rescue_out["cpu", torch.float32]) for d in (torch.float32, torch.bfloat16)}
    check(min(rescue_psnr.values()) >= 40.0, f"RIFE 4.0 rescue forward cuda vs cpu {rescue_psnr} < 40 dB")
    print(
        f"node: RIFE 4.0 4x540x960 x2 batch {batch}, cuda vs cpu fp32: {', '.join(rife40_psnr)}; launches "
        f"{rife40_launches} = per forward {rife.warps_per_forward('4.0', True)} (fast) and "
        f"{rife.warps_per_forward('4.0', False)} (refined) x {calls_per_run} calls each, rescues "
        f"{[f for f, _, _ in flags40]}; rescue forward (block 1's head x {k:.1f}, stage-1 update "
        f"{[round(min(a, b), 1) for _, a, b in rescue_flags_seen]} px) cuda vs cpu "
        + ", ".join(f"{d} {p:.2f} dB" for d, p in rescue_psnr.items())
        + f", launches {rife.warps_per_forward('4.0', False, rescued=True)} per forward; the {n_warps40} warps of the "
        f"node runs and the {n_rescue_warps} of the rescue forwards launched again on their inputs, each bit-exact "
        f"against the plain twin (wide at {sorted(s for s, _ in wide40)}, border, f32 and bf16)",
        flush=True,
    )
    del outs40, out_cpu, rescue_out

    # ---- 5. JAX golden -------------------------------------------------------
    clock("5")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_rife47_golden.npz")) as z:
        seed, golden = int(z["seed"]), torch.from_numpy(z["output"])
    gframes = torch.from_numpy(np.random.default_rng(seed).random((2, 1, 64, 128, 3), dtype=np.float32)).to(dev)
    net = rife.IFNet("4.7")
    net.load_state_dict(rife.init_params(seed, "4.7"), strict=True)
    net = net.to(dev, memory_format=torch.channels_last).eval()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        gout = rife.apply(net, gframes[0], gframes[1], torch.full((1,), 0.5, device=dev), rife.default_scale_list("4.7"))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"golden: {pg:.2f} dB < 40")
    print(f"golden: port on cuda fp32 vs JAX RIFE 4.7 fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 6. timing -----------------------------------------------------------
    clock("6")
    model_fn = rife.make_model_fn(params, "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((8,), 0.5, device=dev)
    fps = 8 / measure(model_fn, f0, f1, t, iters=10, rounds=3)
    rife_profile = profile_forward("RIFE 4.7 1080p bf16 b8", model_fn, f0, f1, t, card=card)
    del f0, f1
    # plain, K1, grid_sample, grid_sample, K1, plain
    k1_times = in_turns({
        "plain": (lambda: warp_torch(main_img, main_flow), 5),
        "K1": (lambda: warp(main_img, main_flow), 50),
        "grid_sample": (grid_sample_call(main_img, main_flow), 20),
    })
    k1_ms = {k: statistics.mean(v) for k, v in k1_times.items()}
    k1_bound = warp_bound(main_img, main_flow)
    print(
        f"timing {card}: RIFE 4.7 1080p 2x bf16 batch 8 {fps:.2f} frames/s; warp {list(MAIN_SHAPE)} bf16, f32 flow: "
        + ", ".join(f"{k} {k1_ms[k]:.4f} ms {v}" for k, v in k1_times.items())
        + f"; bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), K1 at {100 * k1_bound[0] / k1_ms['K1']:.1f} % of it",
        flush=True,
    )

    del main_img, main_flow

    # ---- 7. splat kernel vs plain on the card --------------------------------
    clock("7")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for case in warp_cases.splat_cases(0, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.from_numpy(case["vals"]).to(dev, dtype)
            flow = torch.from_numpy(case["flow"]).to(dev)
            got, ref = softsplat_func(vals, flow), softsplat_torch(vals, flow)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= SPLAT_F32_ATOL if dtype == torch.float32 else bf16_ulp_ok(got, ref)
            check(ok and got.dtype == dtype, f"splat kernel vs plain: {case['name']} {dtype}: max err {err}")
            worst[dtype] = max(worst[dtype], err)
            n_cases += 1
    splat_vals = torch.rand(SPLAT_SHAPE, generator=g).to(dev, torch.bfloat16)
    splat_flow = torch.from_numpy(warp_cases.smooth_flow(*SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    got, ref = softsplat_func(splat_vals, splat_flow), softsplat_torch(splat_vals, splat_flow)
    torch.cuda.synchronize()
    splat_err = (got.float() - ref.float()).abs().max().item()
    check(bf16_ulp_ok(got, ref), f"splat kernel vs plain at {SPLAT_SHAPE}: max err {splat_err} beyond one bf16 ulp")
    del got, ref
    print(
        f"splat kernel vs plain: {n_cases} cases at 256x512 and narrow frames, max err f32 {worst[torch.float32]} "
        f"(tol {SPLAT_F32_ATOL}), bf16 {worst[torch.bfloat16]} (tol one ulp); {list(SPLAT_SHAPE)} bf16 max err "
        f"{splat_err} (within one ulp)",
        flush=True,
    )

    # ---- 8. M2M node end to end ----------------------------------------------
    clock("8")
    m2m_params = m2m.init_params(0)
    frames = shifted_pattern(4, *M2M_NODE_HW, seed=1)
    node = M2M_VFI()
    batch = 2
    expect_reuse = expect_infer = 0
    for multiplier in (2, 3):
        _, by_count = _pair_groups(plan_timestep(4, multiplier))
        expect_reuse += sum(math.ceil(len(keys) / batch) for keys in by_count.values())
        expect_infer += sum(m_ * math.ceil(len(keys) / batch) for m_, keys in by_count.items())
    expect_reuse, expect_infer = 2 * expect_reuse, 2 * expect_infer  # fp32 and bf16
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    for multiplier in (2, 3):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "M2M.pth", frames, multiplier=multiplier, batch_size=batch, dtype=dtype, params=m2m_params, device="cuda"
            )
    torch.cuda.synchronize()
    m2m_warp_launches, m2m_wide = warp_kernel.launches, warp_kernel.wide_launches
    m2m_splat_launches = softsplat_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    split = m2m.warps_per_reuse(torch.float32)
    check(split == m2m.warps_per_reuse(torch.bfloat16), "M2M's warp split differs between fp32 and bf16")
    check(
        m2m_splat_launches == expect_infer,
        f"splat launches {m2m_splat_launches} != 1 x {expect_infer} infer calls",
    )
    check(
        m2m_warp_launches == split["narrow"] * expect_reuse,
        f"K1 launches {m2m_warp_launches} != {split['narrow']} x {expect_reuse} reuse calls",
    )
    check(
        m2m_wide == split["wide"] * expect_reuse,
        f"wide warp launches {m2m_wide} != {split['wide']} x {expect_reuse} reuse calls",
    )
    m2m_psnr = []
    t0 = time.perf_counter()
    for multiplier in (2, 3):
        (out_cpu,) = node.vfi(
            "M2M.pth", frames, multiplier=multiplier, batch_size=batch, dtype="float32", params=m2m_params, device="cpu"
        )
        n_out = 3 * multiplier + 1
        for dtype in ("float32", "bfloat16"):
            out = outs[multiplier, dtype]
            check(tuple(out.shape) == (n_out, *M2M_NODE_HW, 3) and out.is_cuda, f"M2M node output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"M2M node x{multiplier} {dtype} has non-finite values")
            check(
                torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)),
                f"M2M x{multiplier} {dtype}: original frames not passed through",
            )
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"M2M node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            m2m_psnr.append(f"x{multiplier} {dtype} {p:.2f} dB")
    cpu_s = time.perf_counter() - t0
    print(
        f"m2m: M2M node 4x{M2M_NODE_HW[0]}x{M2M_NODE_HW[1]} x2 and x3 batch {batch}, cuda vs cpu fp32: {', '.join(m2m_psnr)} "
        f"(cpu leg {cpu_s:.1f} s); splat launches {m2m_splat_launches} = 1 x {expect_infer} infer calls; "
        f"warp launches per reuse call {split}: K1 {m2m_warp_launches}, wide {m2m_wide}, "
        f"over {expect_reuse} reuse calls",
        flush=True,
    )
    del outs, out_cpu

    # ---- 9. M2M JAX golden ---------------------------------------------------
    clock("9")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_m2m_golden.npz")) as z:
        seed, gt, golden = int(z["seed"]), torch.from_numpy(z["t"]), torch.from_numpy(z["output"])
    rng = np.random.default_rng(seed)
    g0 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32))
    g1 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gout = m2m.make_model_fn(m2m.init_params(seed), device=dev)(g0, g1, gt)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"M2M golden: {pg:.2f} dB < 40")
    print(f"golden: port M2M on cuda fp32 vs JAX M2M fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 10. M2M timing ------------------------------------------------------
    clock("10")
    model_fn = m2m.make_model_fn(m2m_params, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((2,), 0.5, device=dev)
    m2m_fps = 2 / measure(model_fn, f0, f1, t, iters=5, rounds=3)
    reuse_fn, infer_fn = m2m.make_pair_fns(m2m_params, dtype=torch.bfloat16, device=dev)
    cache = reuse_fn(f0, f1)
    reuse_ms = cuda_ms(lambda: reuse_fn(f0, f1), 5)
    infer_ms = cuda_ms(lambda: infer_fn(f0, f1, cache, t), 10)
    del cache
    # plain, kernel, kernel, plain: the two versions are compared in turns
    splat_times = in_turns({
        "plain": (lambda: softsplat_torch(splat_vals, splat_flow), 3),
        "kernel": (lambda: softsplat_func(splat_vals, splat_flow), 20),
        "library": (library_splat(splat_vals, splat_flow), 20),
    })
    splat_ms = statistics.mean(splat_times["kernel"])
    splat_plain_ms = statistics.mean(splat_times["plain"])
    splat_library_ms = statistics.mean(splat_times["library"])
    splat_bound = bound(*splat_work(splat_vals.permute(0, 3, 1, 2), splat_flow.permute(0, 3, 1, 2)))
    del splat_vals, splat_flow
    print(
        f"timing {card}: M2M 1080p 2x bf16 batch 2 {m2m_fps:.3f} frames/s; reuse {reuse_ms:.3f} ms, infer "
        f"{infer_ms:.3f} ms per pair batch; splat {list(SPLAT_SHAPE)} bf16 kernel {splat_ms:.4f} ms "
        f"{splat_times['kernel']}, plain {splat_plain_ms:.4f} ms {splat_times['plain']}, one library call "
        f"(aten.grid_sampler_2d_backward, f32) {splat_library_ms:.4f} ms {splat_times['library']}",
        flush=True,
    )
    print(
        f"timing {card}: splat {list(SPLAT_SHAPE)} bf16 bound {splat_bound[0]:.4f} ms ({splat_bound[1]}: values and "
        f"flow in, bf16 out), the op at {100 * splat_bound[0] / splat_ms:.1f} % of it",
        flush=True,
    )
    m2m_profile = profile_forward("M2M 1080p bf16 b2", model_fn, f0, f1, t, card=card)
    del f0, f1

    # ---- 11. wide warp kernel vs plain on the card ---------------------------
    clock("11")
    n_cases = 0
    for case in warp_cases.wide_cases(0, 128, 256, channels=WIDE_CHANNELS):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)[..., case["offset"] :]
                flow = torch.from_numpy(case["flow"]).to(dev)
                got, ref = warp(img, flow, mode, prefer_wide=True), warp_torch(img, flow, mode)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                check(torch.equal(got, ref), f"wide kernel vs plain: {case['name']} {mode} {dtype}: max err {err}, not bit-exact")
                n_cases += 1
    wide_img = torch.rand(FILM_WARP_SHAPES[0], generator=g).to(dev, torch.bfloat16)
    wide_flow = torch.from_numpy(warp_cases.smooth_flow(*FILM_WARP_SHAPES[0][:3], amp=6.0)).to(dev)
    got, ref = warp(wide_img, wide_flow, prefer_wide=True), warp_torch(wide_img, wide_flow)
    k1 = warp_kernel.warp_bilinear(wide_img.permute(0, 3, 1, 2), wide_flow.permute(0, 3, 1, 2))
    k1 = k1.permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    wide_err = (got.float() - ref.float()).abs().max().item()
    k1_err = (k1.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"wide kernel vs plain at {FILM_WARP_SHAPES[0]}: max err {wide_err}, not bit-exact")
    check(torch.equal(k1, ref), f"K1 vs plain at {FILM_WARP_SHAPES[0]}: max err {k1_err}, not bit-exact")
    del got, ref, k1
    # M2M's feature warps, which the route sends to the wide kernel (zeros,
    # bf16 flow): the encoder-decoder's first and last levels
    m2m_errs = {
        f"{list(shape)}": routed_at_path_shape(shape, "zeros", torch.bfloat16, "wide", g)
        for shape in M2M_WIDE_SHAPES
    }
    # RIFE 4.0's Contextnet warps (border; f32 values and flow in the fp32
    # model, bf16 in the bf16 one)
    rife40_errs = {
        f"{list(shape)} {str(dt).split('.')[-1]}": routed_at_path_shape(shape, "border", dt, "wide", g, value_dtype=dt)
        for shape in RIFE40_WIDE_SHAPES
        for dt in (torch.float32, torch.bfloat16)
    }
    print(
        f"wide kernel vs plain: {n_cases} cases at 128x256 (C {', '.join(map(str, WIDE_CHANNELS))}, 46, unaligned, "
        f"extreme, non-finite) bit-exact (max err 0); {list(FILM_WARP_SHAPES[0])} bf16 max err wide {wide_err}, "
        f"K1 {k1_err}; routed to it at M2M's shapes, bf16 zeros, bf16 flow: "
        + ", ".join(f"{k} max err {v}" for k, v in m2m_errs.items())
        + "; at RIFE 4.0's Contextnet shapes, border, flow in the values' dtype: "
        + ", ".join(f"{k} max err {v}" for k, v in rife40_errs.items()),
        flush=True,
    )

    # ---- 12. FILM node end to end --------------------------------------------
    clock("12")
    film_params = film.init_params(0)
    frames = shifted_pattern(4, *FILM_HW, seed=2)
    node = FILM_VFI()
    batch = 2
    film_calls = 2 * sum(
        math.ceil(len(level) / batch) for m_ in (2, 4) for level in plan_bisection(4, m_).levels
    )  # fp32 and bf16
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = 0
    for multiplier in (2, 4):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "film_net_fp32.pt", frames, multiplier=multiplier, batch_size=batch, dtype=dtype,
                params=film_params, device="cuda",
            )
    torch.cuda.synchronize()
    film_wide_launches, film_warp_launches = warp_kernel.wide_launches, warp_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(
        film_wide_launches == film.WARPS_PER_CALL["wide"] * film_calls,
        f"wide warp launches {film_wide_launches} != {film.WARPS_PER_CALL['wide']} x {film_calls} forward calls",
    )
    check(
        film_warp_launches == film.WARPS_PER_CALL["narrow"] * film_calls,
        f"K1 launches {film_warp_launches} != {film.WARPS_PER_CALL['narrow']} x {film_calls} forward calls",
    )
    film_psnr = []
    t0 = time.perf_counter()
    for multiplier in (2, 4):
        (out_cpu,) = node.vfi(
            "film_net_fp32.pt", frames, multiplier=multiplier, batch_size=batch, dtype="float32",
            params=film_params, device="cpu",
        )
        n_out = 3 * multiplier + 1
        for dtype in ("float32", "bfloat16"):
            out = outs[multiplier, dtype]
            check(tuple(out.shape) == (n_out, *FILM_HW, 3) and out.is_cuda, f"FILM node output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"FILM node x{multiplier} {dtype} has non-finite values")
            check(
                torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)),
                f"FILM x{multiplier} {dtype}: original frames not passed through",
            )
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"FILM node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            film_psnr.append(f"x{multiplier} {dtype} {p:.2f} dB")
    cpu_s = time.perf_counter() - t0
    print(
        f"film: FILM node 4x{FILM_HW[0]}x{FILM_HW[1]} x2 and x4 batch {batch}, cuda vs cpu fp32: {', '.join(film_psnr)} "
        f"(cpu leg {cpu_s:.1f} s); wide warp launches {film_wide_launches} = {film.WARPS_PER_CALL['wide']} x "
        f"{film_calls} forward calls, K1 launches {film_warp_launches} = "
        f"{film.WARPS_PER_CALL['narrow']} x {film_calls}",
        flush=True,
    )
    del outs, out_cpu

    # ---- 13. FILM JAX golden -------------------------------------------------
    clock("13")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_film_golden.npz")) as z:
        seed, golden = int(z["seed"]), torch.from_numpy(z["output"])
    rng = np.random.default_rng(seed)
    g0 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32)).to(dev)
    g1 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32)).to(dev)
    net = film._load(film.init_params(seed), torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        gout = film.apply(net, g0, g1)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"FILM golden: {pg:.2f} dB < 40")
    print(f"golden: port FILM on cuda fp32 vs JAX FILM fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)
    del net

    # ---- 14. FILM timing -----------------------------------------------------
    clock("14")
    model_fn = film.make_model_fn(film_params, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((2,), 0.5, device=dev)
    film_fps = 2 / measure(model_fn, f0, f1, t, iters=5, rounds=3)
    net = film._load(film_params, torch.bfloat16, dev)
    with torch.inference_mode():
        x0, x1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
        pyr = film.stage_pyramid(x0, x1)
        feat = film.stage_features(net, pyr)
        fwd, bwd = film.stage_flow(net, feat, 2)
        aligned = film.stage_warp(pyr, feat, fwd, bwd, 2)
        stage_ms = {
            "pyramid": cuda_ms(lambda: film.stage_pyramid(x0, x1), 5),
            "features": cuda_ms(lambda: film.stage_features(net, pyr), 3),
            "flow": cuda_ms(lambda: film.stage_flow(net, feat, 2), 3),
            "warp": cuda_ms(lambda: film.stage_warp(pyr, feat, fwd, bwd, 2), 3),
            "fuse": cuda_ms(lambda: film.stage_fuse(net, aligned), 3),
        }
    del pyr, feat, fwd, bwd, aligned, net
    print(
        f"timing {card}: FILM 1080p 2x bf16 batch 2 {film_fps:.3f} frames/s; stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()),
        flush=True,
    )
    wide_times = {}
    for shape in FILM_WARP_SHAPES:
        if shape != FILM_WARP_SHAPES[0]:
            wide_img = torch.rand(shape, generator=g).to(dev, torch.bfloat16)
            wide_flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        # plain, wide, K1, grid_sample, then back: the versions in turns
        planes, fplanes = wide_img.permute(0, 3, 1, 2), wide_flow.permute(0, 3, 1, 2)
        times = in_turns({
            "plain": (lambda: warp_torch(wide_img, wide_flow), 3),
            "wide": (lambda: warp(wide_img, wide_flow, prefer_wide=True), 30),
            "K1": (lambda: warp_kernel.warp_bilinear(planes, fplanes), 10),
            "grid_sample": (grid_sample_call(wide_img, wide_flow), 10),
        })
        del planes, fplanes
        key = "x".join(map(str, shape))
        wb = warp_bound(wide_img, wide_flow)
        wide_times[key] = {
            "ms": statistics.mean(times["wide"]),
            "k1_ms": statistics.mean(times["K1"]),
            "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]),
            "bound_ms": wb[0],
            "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {list(shape)} bf16, f32 flow: "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {wb[0]:.4f} ms ({wb[1]}), wide at {100 * wb[0] / wide_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    del wide_img, wide_flow
    film_profile = profile_forward("FILM 1080p bf16 b2", model_fn, f0, f1, t, card=card)
    del f0, f1
    wide_main = wide_times["x".join(map(str, FILM_WARP_SHAPES[0]))]
    del model_fn

    # ---- 15. splat at GMFSS's widths -----------------------------------------
    clock("15")
    def splat_vs_plain(vals, flow, f32_scaled=False):
        """Max abs error of the kernel against the twin, checked: f32 within
        1e-5 (times the output's largest magnitude, if ``f32_scaled``),
        bf16 within one ulp."""
        got, ref = softsplat_func(vals, flow), softsplat_torch(vals, flow)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if vals.dtype == torch.float32:
            tol = SPLAT_F32_ATOL * (max(1.0, ref.abs().max().item()) if f32_scaled else 1.0)
            ok = err <= tol
        else:
            ok, tol = bf16_ulp_ok(got, ref), "one ulp"
        check(ok and got.dtype == vals.dtype, f"splat kernel vs plain at {list(vals.shape)} {vals.dtype}: max err {err}, tol {tol}")
        return err

    smooth_errs = {}
    for shape in GMFSS_SPLAT_SHAPES:
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=8.0)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.rand(shape, generator=g).to(dev, dtype)
            smooth_errs[f"C={shape[3]} {str(dtype).split('.')[-1]}"] = splat_vs_plain(vals, flow)
    gmfss_params = {union: gmfss.init_params(0, union=union) for union in (False, True)}
    gmfss_fn = gmfss.make_model_fn(gmfss_params[False], dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((1, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((1, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((1,), 0.5, device=dev)
    gmfss_splats = []
    with captured_splats(gmfss_splats):
        gmfss_fn(f0, f1, t)
    torch.cuda.synchronize()
    captured_c = tuple(v.shape[-1] for v, _ in gmfss_splats)
    check(captured_c == gmfss.SPLAT_CHANNELS_PER_INFER, f"GMFSS splat widths {captured_c} != {gmfss.SPLAT_CHANNELS_PER_INFER}")
    soft_errs = {"bf16": 0.0, "f32": 0.0}
    for vals, flow in gmfss_splats:
        check(vals.dtype == torch.bfloat16, f"GMFSS bf16 forward splats {vals.dtype} values")
        soft_errs["bf16"] = max(soft_errs["bf16"], splat_vs_plain(vals, flow))
        soft_errs["f32"] = max(soft_errs["f32"], splat_vs_plain(vals.float(), flow.float(), f32_scaled=True))
    rng = np.random.default_rng(5)
    w_vals = rng.random((2, 64, 96, 3), dtype=np.float32)
    w_flow = warp_cases.smooth_flow(2, 64, 96, amp=3.0)
    w_flow[..., 0] += 4.0  # leaves an empty strip: exact-zero normalisers
    w_metric = rng.uniform(0.25, 1.25, (2, 64, 96, 1)).astype(np.float32)
    w_metric[:, ::5] = 0.0
    wrapper_err = 0.0
    # (name, call, whether it is given the metric): the legacy names always
    # are, and read it only where their mode does
    cases = [(m, softsplat, m.split("-")[0] in ("linear", "soft")) for m in SOFTSPLAT_MODES] + [
        (n, function_softsplat, True) for n in ("summation", "average", "linear", "softmax", "sum", "avg", "soft")
    ]
    for name, fn, with_metric in cases:
        outs = [
            fn(*(torch.from_numpy(a).to(d) for a in (w_vals, w_flow)), torch.from_numpy(w_metric).to(d) if with_metric else None, name)
            for d in (dev, torch.device("cpu"))
        ]
        err = (outs[0].cpu() - outs[1]).abs().max().item()
        check(outs[0].is_cuda and err <= SPLAT_F32_ATOL, f"{fn.__name__} {name} cuda vs cpu: max err {err}")
        wrapper_err = max(wrapper_err, err)
    print(
        f"gsplat: splat kernel vs plain at GMFSS's widths, smooth flow: "
        + ", ".join(f"{k} {v}" for k, v in smooth_errs.items())
        + f"; on the {len(gmfss_splats)} soft-mode inputs of one GMFSS 1080p bf16 forward (C {list(captured_c)}): "
        f"bf16 max err {soft_errs['bf16']} (one ulp), f32 max err {soft_errs['f32']} (1e-5 of the magnitude); "
        f"softsplat wrapper cuda vs cpu, {len(cases)} modes and names, max err {wrapper_err} (tol {SPLAT_F32_ATOL})",
        flush=True,
    )

    # ---- 16. GMFSS node end to end -------------------------------------------
    clock("16")
    frames = shifted_pattern(4, *GMFSS_HW, seed=3)
    batch = 2
    reuse_calls = infer_calls = 0
    for multiplier in (2, 3):
        _, by_count = _pair_groups(plan_timestep(4, multiplier))
        reuse_calls += sum(math.ceil(len(keys) / batch) for keys in by_count.values())
        infer_calls += sum(m_ * math.ceil(len(keys) / batch) for m_, keys in by_count.items())
    gmfss_launches = {}
    for union in (False, True):
        name = "GMFSS_fortuna_union" if union else "GMFSS_fortuna"
        path = "gmfss_union" if union else "gmfss"
        node = GMFSS_Fortuna_VFI()
        expect = {"narrow": 0, "wide": 0, "splat": 0}
        for dtype in (torch.float32, torch.bfloat16):
            per_reuse, per_infer = gmfss.warps_per_reuse(dtype), gmfss.warps_per_infer(union, dtype)
            for k in ("narrow", "wide"):
                expect[k] += per_reuse[k] * reuse_calls + per_infer[k] * infer_calls
            expect["splat"] += gmfss.splats_per_infer() * infer_calls
        outs = {}
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
        for multiplier in (2, 3):
            for dtype in ("float32", "bfloat16"):
                (outs[multiplier, dtype],) = node.vfi(
                    name, frames, multiplier=multiplier, batch_size=batch, dtype=dtype, params=gmfss_params[union],
                    device="cuda",
                )
        torch.cuda.synchronize()
        got = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        check(got == expect, f"{name} launches {got} != {expect} ({reuse_calls} reuse, {infer_calls} infer calls per dtype)")
        gmfss_launches[path] = got
        psnrs = []
        t0 = time.perf_counter()
        for multiplier in (2, 3):
            (out_cpu,) = node.vfi(
                name, frames, multiplier=multiplier, batch_size=batch, dtype="float32", params=gmfss_params[union],
                device="cpu",
            )
            n_out = 3 * multiplier + 1
            for dtype in ("float32", "bfloat16"):
                out = outs[multiplier, dtype]
                check(tuple(out.shape) == (n_out, *GMFSS_HW, 3) and out.is_cuda, f"{name} output {tuple(out.shape)} on {out.device}")
                check(bool(torch.isfinite(out).all()), f"{name} x{multiplier} {dtype} has non-finite values")
                check(
                    torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)),
                    f"{name} x{multiplier} {dtype}: original frames not passed through",
                )
                p = psnr(out, out_cpu)
                check(p >= 40.0, f"{name} node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
                psnrs.append(f"x{multiplier} {dtype} {p:.2f} dB")
        print(
            f"gmfss: {name} node 4x{GMFSS_HW[0]}x{GMFSS_HW[1]} x2 and x3 batch {batch}, cuda vs cpu fp32: "
            f"{', '.join(psnrs)} (cpu leg {time.perf_counter() - t0:.1f} s); launches {got} over {reuse_calls} reuse "
            f"and {infer_calls} infer calls per dtype, as derived from the model (per reuse "
            f"{gmfss.warps_per_reuse()}, per infer {gmfss.warps_per_infer(union)} and {gmfss.splats_per_infer()} splats)",
            flush=True,
        )
        del outs, out_cpu

    # ---- 17. GMFSS JAX golden ------------------------------------------------
    clock("17")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_gmfss_golden.npz")) as z:
        seed, gt, gframes = int(z["seed"]), float(z["t"]), z["frames"]
        goldens = {union: torch.from_numpy(z["output_union" if union else "output_base"]) for union in (False, True)}
    g0, g1 = (torch.from_numpy(gframes[i].astype(np.float32) / 255.0).to(dev) for i in (0, 1))
    golden_psnr = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for union, golden in goldens.items():
        net = gmfss._load(gmfss.init_params(seed, union=union), union, torch.float32, dev)
        with torch.inference_mode():
            gout = gmfss.apply(net, g0, g1, torch.full((1,), gt, device=dev))
        golden_psnr[union] = (psnr(gout, golden), (gout.cpu() - golden).abs().max().item())
        check(golden_psnr[union][0] >= 40.0, f"GMFSS golden union={union}: {golden_psnr[union][0]:.2f} dB < 40")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del net
    print(
        "golden: port GMFSS on cuda fp32 vs JAX GMFSS fp32, "
        + ", ".join(f"{'union' if u else 'base'} {p:.2f} dB (max abs err {e:.3g})" for u, (p, e) in golden_psnr.items()),
        flush=True,
    )

    # ---- 18. GMFSS timing ----------------------------------------------------
    clock("18")
    gmfss_fps, gmfss_stage_ms, gmfss_profiles = {}, {}, {}
    for union in (False, True):
        path = "gmfss_union" if union else "gmfss"
        fn = gmfss_fn if not union else gmfss.make_model_fn(gmfss_params[True], union=True, dtype=torch.bfloat16, device=dev)
        gmfss_fps[path] = 1 / measure(fn, f0, f1, t, iters=5, rounds=3)
        reuse_fn, infer_fn = gmfss.make_pair_fns(gmfss_params[union], union=union, dtype=torch.bfloat16, device=dev)
        cache = reuse_fn(f0, f1)
        gmfss_stage_ms[path] = {"reuse": cuda_ms(lambda: reuse_fn(f0, f1), 5), "infer": cuda_ms(lambda: infer_fn(f0, f1, cache, t), 5)}
        del cache, reuse_fn, infer_fn
        print(
            f"timing {card}: {'GMFSS union' if union else 'GMFSS'} 1080p 2x bf16 batch 1 {gmfss_fps[path]:.3f} frames/s; "
            f"reuse {gmfss_stage_ms[path]['reuse']:.3f} ms, infer {gmfss_stage_ms[path]['infer']:.3f} ms per pair",
            flush=True,
        )
        gmfss_profiles[path] = profile_forward(f"{'GMFSS union' if union else 'GMFSS'} 1080p bf16 b1", fn, f0, f1, t, card=card)
        del fn
    del gmfss_fn, f0, f1
    # the splat at each width, on the first direction's captured inputs
    gmfss_splat_times = {}
    for vals, flow in gmfss_splats[::2]:
        times = in_turns({
            "plain": (lambda: softsplat_torch(vals, flow), 3),
            "kernel": (lambda: softsplat_func(vals, flow), 20),
            "library": (library_splat(vals, flow), 20),
        })
        sb = bound(*splat_work(vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)))
        key = "x".join(map(str, vals.shape))
        gmfss_splat_times[key] = {
            "ms": statistics.mean(times["kernel"]), "plain_ms": statistics.mean(times["plain"]),
            "bound_ms": sb[0], "bound_by": sb[1], "library_ms": statistics.mean(times["library"]),
        }
        print(
            f"timing {card}: splat {list(vals.shape)} bf16, bf16 flow (GMFSS's soft-mode input): "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {sb[0]:.4f} ms ({sb[1]}), the op at {100 * sb[0] / gmfss_splat_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    print(
        f"library {card}: K2 per GMFSS infer (each width splatted twice, both directions): the op "
        f"{2 * sum(v['ms'] for v in gmfss_splat_times.values()):.4f} ms, one library call each "
        f"{2 * sum(v['library_ms'] for v in gmfss_splat_times.values()):.4f} ms",
        flush=True,
    )
    del gmfss_splats
    gmfss_warp_times = {}
    for shape, mode, body in GMFSS_WARP_SHAPES:
        routed_at_path_shape(shape, mode, torch.bfloat16, body, g)
        img = torch.rand(shape, generator=g).to(dev, torch.bfloat16)
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev, torch.bfloat16)
        times = in_turns({
            "plain": (lambda: warp_torch(img, flow, mode), 3),
            body: (lambda: warp(img, flow, mode), 30),
            "grid_sample": (grid_sample_call(img, flow, mode), 10),
        })
        wb = warp_bound(img, flow)
        key = f"{'x'.join(map(str, shape))} {mode}"
        gmfss_warp_times[key] = {
            "kernel": body, "ms": statistics.mean(times[body]), "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]), "bound_ms": wb[0], "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {list(shape)} bf16 {mode}, bf16 flow (GMFSS): "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {wb[0]:.4f} ms ({wb[1]}), {body} at {100 * wb[0] / gmfss_warp_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    del img, flow

    # ---- 19. splat at EISAI's widths -----------------------------------------
    clock("19")
    esmooth_errs = {}
    for shape in EISAI_SPLAT_SHAPES:
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=8.0)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.rand(shape, generator=g).to(dev, dtype)
            esmooth_errs[f"C={shape[3]} {str(dtype).split('.')[-1]}"] = splat_vs_plain(vals, flow)
    del vals, flow
    eisai_params = eisai.init_params(0)
    eisai_fn = eisai.make_model_fn(eisai_params, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((1, 540, 960, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((1, 540, 960, 3), dtype=np.float32)).to(dev)
    t = torch.full((1,), 0.5, device=dev)
    eisai_splats, eisai_warps = [], []
    with captured_splats(eisai_splats), captured_warps(eisai_warps):
        eisai_fn(f0, f1, t)
    torch.cuda.synchronize()
    # its two Lab warps (RAFT's flow plus the grid offsets), again on the
    # same inputs against the twin
    eseen = warps_vs_plain(eisai_warps, "EISAI 540p forward")
    want_warps = {"warp_bilinear": {(shape, "border", "float32", "float32") for shape in EISAI_WARP_SHAPES}}
    check(
        eseen == want_warps and len(eisai_warps) == eisai.warps_per_infer()["narrow"],
        f"EISAI warps {len(eisai_warps)} x {eseen}, expected {eisai.warps_per_infer()} at {want_warps}",
    )
    elargest_warp = max(fl.abs().max().item() for _, _, fl, _ in eisai_warps)
    del eisai_warps
    ecaptured_c = tuple(v.shape[-1] for v, _ in eisai_splats)
    check(ecaptured_c == eisai.SPLAT_CHANNELS_PER_INFER, f"EISAI splat widths {ecaptured_c} != {eisai.SPLAT_CHANNELS_PER_INFER}")
    check(
        [tuple(v.shape) for v, _ in eisai_splats[::2]] == [tuple(sh) for sh in EISAI_SPLAT_SHAPES],
        f"EISAI splat shapes {[tuple(v.shape) for v, _ in eisai_splats]}",
    )
    esoft_errs = {"f32": 0.0, "bf16": 0.0}
    for vals, flow in eisai_splats:
        check(vals.dtype == torch.float32 and flow.dtype == torch.float32, f"EISAI splats {vals.dtype} values, {flow.dtype} flow")
        esoft_errs["f32"] = max(esoft_errs["f32"], splat_vs_plain(vals, flow, f32_scaled=True))
        esoft_errs["bf16"] = max(esoft_errs["bf16"], splat_vs_plain(vals.bfloat16(), flow.bfloat16()))
    print(
        "esplat: splat kernel vs plain at EISAI's widths, smooth flow: "
        + ", ".join(f"{k} {v}" for k, v in esmooth_errs.items())
        + f"; on the {len(eisai_splats)} soft-mode inputs of one EISAI 540p bf16 forward (C {list(ecaptured_c)}, "
        f"f32, largest flow {max(fl.abs().max().item() for _, fl in eisai_splats):.3f} px): f32 max err "
        f"{esoft_errs['f32']} (1e-5 of the magnitude), cast to bf16 max err {esoft_errs['bf16']} (one ulp); "
        f"that forward's {eisai.warps_per_infer()['narrow']} K1 warps {list(EISAI_WARP_SHAPES[0])} f32 border "
        f"(f32 flow, largest {elargest_warp:.3f} px with the offsets) bit-exact against the plain twin",
        flush=True,
    )

    # ---- 20. EISAI node end to end ------------------------------------------
    clock("20")
    frames = shifted_pattern(4, *EISAI_HW, seed=4)
    batch = 2
    reuse_calls = infer_calls = 0
    for multiplier in (2, 3):
        _, by_count = _pair_groups(plan_timestep(4, multiplier))
        reuse_calls += sum(math.ceil(len(keys) / batch) for keys in by_count.values())
        infer_calls += sum(m_ * math.ceil(len(keys) / batch) for m_, keys in by_count.items())
    per_infer = eisai.warps_per_infer()
    expect = {"narrow": 2 * per_infer["narrow"] * infer_calls, "wide": 2 * per_infer["wide"] * infer_calls,
              "splat": 2 * eisai.splats_per_infer() * infer_calls}  # fp32 and bf16
    node = EISAI_VFI()
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    for multiplier in (2, 3):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "eisai", frames, multiplier=multiplier, batch_size=batch, dtype=dtype, params=eisai_params, device="cuda"
            )
    torch.cuda.synchronize()
    eisai_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(eisai_launches == expect, f"EISAI launches {eisai_launches} != {expect} ({reuse_calls} reuse, {infer_calls} infer calls per dtype)")
    psnrs = []
    t0 = time.perf_counter()
    for multiplier in (2, 3):
        (out_cpu,) = node.vfi("eisai", frames, multiplier=multiplier, batch_size=batch, dtype="float32", params=eisai_params, device="cpu")
        n_out = 3 * multiplier + 1
        for dtype in ("float32", "bfloat16"):
            out = outs[multiplier, dtype]
            check(tuple(out.shape) == (n_out, *EISAI_HW, 3) and out.is_cuda, f"EISAI output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"EISAI x{multiplier} {dtype} has non-finite values")
            check(torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)), f"EISAI x{multiplier} {dtype}: original frames not passed through")
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"EISAI node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            psnrs.append(f"x{multiplier} {dtype} {p:.2f} dB")
    print(
        f"eisai: EISAI node 4x{EISAI_HW[0]}x{EISAI_HW[1]} x2 and x3 batch {batch}, 12 iterations, cuda vs cpu fp32: "
        f"{', '.join(psnrs)} (cpu leg {time.perf_counter() - t0:.1f} s); launches {eisai_launches} over {reuse_calls} reuse "
        f"and {infer_calls} infer calls per dtype, as derived from the model (none per reuse, per infer {per_infer} "
        f"and {eisai.splats_per_infer()} splats)",
        flush=True,
    )
    del outs, out_cpu

    # ---- 21. EISAI JAX golden ------------------------------------------------
    clock("21")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_eisai_golden.npz")) as z:
        seed, gt, gframes, golden = int(z["seed"]), float(z["t"]), z["frames"], torch.from_numpy(z["output"])
    g0, g1 = (torch.from_numpy(gframes[i].astype(np.float32) / 255.0).to(dev) for i in (0, 1))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gout = eisai.make_model_fn(eisai.init_params(seed), device=dev)(g0, g1, torch.full((1,), gt, device=dev))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"EISAI golden: {pg:.2f} dB < 40")
    print(f"golden: port EISAI on cuda fp32 vs JAX EISAI fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 22. EISAI timing ----------------------------------------------------
    clock("22")
    eisai_fps = 1 / measure(eisai_fn, f0, f1, t, iters=5, rounds=3)
    reuse_fn, infer_fn = eisai.make_pair_fns(eisai_params, dtype=torch.bfloat16, device=dev)
    cache = reuse_fn(f0, f1)
    eisai_stage_ms = {"reuse": cuda_ms(lambda: reuse_fn(f0, f1), 5), "infer": cuda_ms(lambda: infer_fn(f0, f1, cache, t), 5)}
    del cache, reuse_fn, infer_fn
    print(
        f"timing {card}: EISAI 540x960 2x bf16 batch 1, 12 iterations {eisai_fps:.3f} frames/s; reuse "
        f"{eisai_stage_ms['reuse']:.3f} ms, infer {eisai_stage_ms['infer']:.3f} ms per pair",
        flush=True,
    )
    eisai_profile = profile_forward("EISAI 540p bf16 b1", eisai_fn, f0, f1, t, card=card)
    del eisai_fn, f0, f1
    eisai_splat_times = {}
    for vals, flow in eisai_splats[::2]:
        times = in_turns({
            "plain": (lambda: softsplat_torch(vals, flow), 3),
            "kernel": (lambda: softsplat_func(vals, flow), 20),
            "library": (library_splat(vals, flow), 20),
        })
        sb = bound(*splat_work(vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)))
        key = "x".join(map(str, vals.shape))
        eisai_splat_times[key] = {
            "ms": statistics.mean(times["kernel"]), "plain_ms": statistics.mean(times["plain"]),
            "bound_ms": sb[0], "bound_by": sb[1], "library_ms": statistics.mean(times["library"]),
        }
        print(
            f"timing {card}: splat {list(vals.shape)} f32, f32 flow (EISAI's soft-mode input): "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {sb[0]:.4f} ms ({sb[1]}), the op at {100 * sb[0] / eisai_splat_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    print(
        f"library {card}: K2 per EISAI infer (each width splatted twice, both directions): the op "
        f"{2 * sum(v['ms'] for v in eisai_splat_times.values()):.4f} ms, one library call each "
        f"{2 * sum(v['library_ms'] for v in eisai_splat_times.values()):.4f} ms",
        flush=True,
    )
    del eisai_splats

    # ---- 23. kernels at STMFNet's shapes -------------------------------------
    clock("23")
    def routed_and_k1(img, flow, body, mode="zeros"):
        """The routed kernel and K1 against the twin in ``mode``, bit for
        bit; the route must be ``body``. Returns the max abs error."""
        planes = img.permute(0, 3, 1, 2)
        routed = warp_kernel.route(planes.shape, planes.stride(), img.dtype)
        check(routed == body, f"{list(img.shape)} {img.dtype} routed to {routed}, expected {body}")
        ref = warp_torch(img, flow, mode)
        outs = {
            routed: warp(img, flow, mode),
            "K1": warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), mode == "zeros").permute(0, 2, 3, 1),
        }
        torch.cuda.synchronize()
        err = 0.0
        for name, got in outs.items():
            e = (got.float() - ref.float()).abs().max().item()
            check(torch.equal(got, ref), f"{name} vs plain at {list(img.shape)} {img.dtype} {mode}, {flow.dtype} flow: max err {e}")
            err = max(err, e)
        return err

    stmf_kernel_errs = {}
    for shape in STMFNET_PWC_SHAPES + (STMFNET_IMAGE_SHAPE,):
        flow32 = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            flow = flow32.to(dt)
            for extra in (0, 1):  # the warped tensor, and the same with the ones channel appended (the JAX form)
                c = shape[3] + extra
                img = torch.rand(*shape[:3], c, generator=g).to(dev, dt)
                body = "wide" if c * dt.itemsize >= 32 or (c * dt.itemsize) % 16 == 0 else "tiled"
                stmf_kernel_errs[f"{list(shape[:3]) + [c]} {str(dt).split('.')[-1]} ({body})"] = routed_and_k1(img, flow, body)
            ones = torch.ones(*shape[:3], 1, device=dev)
            stmf_kernel_errs[f"{list(shape[:3]) + [1]} float32 ones, {str(dt).split('.')[-1]} flow (tiled)"] = routed_and_k1(ones, flow, "tiled")
    del img, ones, flow, flow32
    stmf_splat_errs = {}
    sflow = torch.from_numpy(warp_cases.smooth_flow(*STMFNET_SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        vals = torch.rand(STMFNET_SPLAT_SHAPE, generator=g).to(dev, dtype)
        stmf_splat_errs[str(dtype).split(".")[-1]] = splat_vs_plain(vals, sflow.to(dtype))
    del vals, sflow
    # every warp and splat of one 1080p bf16 forward, on copies of its inputs
    stmf_params = stmfnet.init_params(0)
    stmf_fn = stmfnet.make_model_fn(stmf_params, dtype=torch.bfloat16, device=dev)
    sf = [torch.from_numpy(np.random.default_rng(i).random((1, 1080, 1920, 3), dtype=np.float32)).to(dev) for i in range(4)]
    stmf_warps, stmf_splats = [], []
    with captured_warps(stmf_warps), captured_splats(stmf_splats):
        stmf_fn(*sf)
    torch.cuda.synchronize()
    sseen = warps_vs_plain(stmf_warps, "STMFNet 1080p forward")
    per_fwd = stmfnet.warps_per_forward(torch.bfloat16)
    want_warps = {
        "warp_bilinear_wide": {(shape, "zeros", "bfloat16", "bfloat16") for shape in STMFNET_PWC_SHAPES},
        "warp_bilinear": {(shape[:3] + (1,), "zeros", "float32", "bfloat16") for shape in STMFNET_PWC_SHAPES + (STMFNET_IMAGE_SHAPE,)}
        | {(STMFNET_IMAGE_SHAPE, "zeros", "bfloat16", "bfloat16")},
    }
    n_by_kernel = {k: sum(1 for kk, *_ in stmf_warps if kk == k) for k in ("warp_bilinear", "warp_bilinear_wide")}
    check(
        sseen == want_warps and n_by_kernel == {"warp_bilinear": per_fwd["narrow"], "warp_bilinear_wide": per_fwd["wide"]},
        f"STMFNet warps {n_by_kernel} at {sseen}, expected {per_fwd} at {want_warps}",
    )
    slargest = max(fl.abs().max().item() for _, _, fl, _ in stmf_warps)
    del stmf_warps
    check(len(stmf_splats) == stmfnet.splats_per_forward(), f"STMFNet splats {len(stmf_splats)}")
    check([tuple(v.shape) for v, _ in stmf_splats] == [STMFNET_SPLAT_SHAPE], f"STMFNet splat shapes {[tuple(v.shape) for v, _ in stmf_splats]}")
    ssoft_errs = {"bf16": 0.0, "f32": 0.0}
    for vals, flow in stmf_splats:
        ssoft_errs["bf16"] = max(ssoft_errs["bf16"], splat_vs_plain(vals, flow))
        ssoft_errs["f32"] = max(ssoft_errs["f32"], splat_vs_plain(vals.float(), flow.float(), f32_scaled=True))
    # the masked backwarp as JAX writes it (the ones channel appended to the
    # tensor: one warp of C + 1 channels) against the port's
    # (stmfnet._backwarp_masked: C channels, then the f32 ones plane, two
    # warps), whole (the concatenation or the ones plane, the warps, the
    # mask) and by its warps alone, bf16, in turns and by the kernels' device
    # time; f32 results must be equal, bf16 ones may differ where the bf16
    # rounding of the warped ones channel crosses 0.999
    def joined_backwarp(x, flow):
        h, w = x.shape[2], x.shape[3]
        fl = flow.permute(0, 2, 3, 1) * device_const((w / (w - 1.0), h / (h - 1.0)), (2,), flow.device, flow.dtype)
        out = warp(torch.cat([x, torch.ones_like(x[:, :1])], 1).permute(0, 2, 3, 1), fl, "zeros")
        return (out[..., :-1] * (out[..., -1:] > 0.999).to(x.dtype)).permute(0, 3, 1, 2)

    design_times = {}
    for shape in STMFNET_PWC_SHAPES + (STMFNET_IMAGE_SHAPE,):
        flow32 = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev).permute(0, 3, 1, 2)
        x32 = torch.rand(shape, generator=g).to(dev).permute(0, 3, 1, 2)
        check(torch.equal(joined_backwarp(x32, flow32), stmfnet._backwarp_masked(x32, flow32)), f"backwarp designs differ in f32 at {shape}")
        x, fl = x32.bfloat16(), flow32.bfloat16()
        flipped = (joined_backwarp(x, fl) != stmfnet._backwarp_masked(x, fl)).any(1).float().mean().item()
        fl_nhwc = fl.permute(0, 2, 3, 1)
        xj = torch.cat([x, torch.ones_like(x[:, :1])], 1).permute(0, 2, 3, 1)
        ones = torch.ones(*shape[:3], 1, device=dev)
        calls = {
            "joined": (lambda: joined_backwarp(x, fl), 20),
            "split": (lambda: stmfnet._backwarp_masked(x, fl), 20),
            "joined warp": (lambda: warp(xj, fl_nhwc, "zeros"), 20),
            "split warps": (lambda: (warp(x.permute(0, 2, 3, 1), fl_nhwc, "zeros"), warp(ones, fl_nhwc, "zeros")), 20),
        }
        times = in_turns(calls)
        dev_ms = {k: device_ms(fn, it) for k, (fn, it) in calls.items()}
        jb = warp_bound(xj, fl_nhwc)
        sb = warp_bound(x.permute(0, 2, 3, 1), fl_nhwc)[0] + warp_bound(ones, fl_nhwc)[0]
        pj, px = xj.permute(0, 3, 1, 2), x
        key = "x".join(map(str, shape))
        design_times[key] = {
            **{f"{k.replace(' ', '_')}_ms": statistics.mean(v) for k, v in times.items()},
            **{f"{k.replace(' ', '_')}_device_ms": v for k, v in dev_ms.items()},
            "joined_kernel": warp_kernel.route(pj.shape, pj.stride(), xj.dtype),
            "split_kernels": [warp_kernel.route(px.shape, px.stride(), x.dtype), "tiled"],
            "joined_bound_ms": jb[0], "split_bound_ms": sb, "bf16_pixels_differing": flipped,
        }
        d = design_times[key]
        print(
            f"timing {card}: STMFNet backwarp {list(shape)} bf16 zeros, wall ms in turns (device ms): joined (C {shape[3] + 1}, "
            f"1 warp on {d['joined_kernel']}) {d['joined_ms']:.4f} ({d['joined_device_ms']:.4f}), its warp {d['joined_warp_ms']:.4f} "
            f"({d['joined_warp_device_ms']:.4f}), bound {jb[0]:.4f}; split (C {shape[3]} on {d['split_kernels'][0]}, f32 ones "
            f"plane on K1) {d['split_ms']:.4f} ({d['split_device_ms']:.4f}), its warps {d['split_warps_ms']:.4f} "
            f"({d['split_warps_device_ms']:.4f}), bound {sb:.4f}; f32 equal, bf16 pixels differing {flipped:.2e}",
            flush=True,
        )
    del x, x32, xj, ones, fl, flow32, fl_nhwc
    print(
        "stmfnet kernels: K1 and the routed kernel vs plain at STMFNet's 1080p shapes, zeros, bit-exact: "
        + ", ".join(f"{k} max err {v}" for k, v in stmf_kernel_errs.items())
        + f"; splat {list(STMFNET_SPLAT_SHAPE)} smooth flow max err "
        + ", ".join(f"{k} {v}" for k, v in stmf_splat_errs.items())
        + f"; one 1080p bf16 forward's {sum(n_by_kernel.values())} warps ({n_by_kernel}, largest flow {slargest:.3f} px) "
        f"launched again on their inputs, each bit-exact against the plain twin; its {len(stmf_splats)} splat(s): bf16 max err "
        f"{ssoft_errs['bf16']} (one ulp), f32 max err {ssoft_errs['f32']} (1e-5 of the magnitude)",
        flush=True,
    )

    # ---- 24. STMFNet node end to end -----------------------------------------
    clock("24")
    frames = shifted_pattern(4, *STMFNET_HW, seed=5)
    node = STMFNet_VFI()
    calls = {dup: len(plan_window4(4, dup).tasks) for dup in (False, True)}  # batch 1: a call per window
    expect = {"narrow": 0, "wide": 0, "splat": 0}
    for dtype in (torch.float32, torch.bfloat16):
        per = stmfnet.warps_per_forward(dtype)
        for dup in (False, True):
            expect = {"narrow": expect["narrow"] + per["narrow"] * calls[dup], "wide": expect["wide"] + per["wide"] * calls[dup],
                      "splat": expect["splat"] + stmfnet.splats_per_forward() * calls[dup]}
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    for dtype in ("float32", "bfloat16"):
        for dup in (False, True):
            (outs[dup, dtype],) = node.vfi(
                "stmfnet.pth", frames, duplicate_first_last_frames=dup, batch_size=1, dtype=dtype, params=stmf_params, device="cuda"
            )
    torch.cuda.synchronize()
    stmf_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(stmf_launches == expect, f"STMFNet launches {stmf_launches} != {expect} ({calls} calls per dtype)")
    psnrs = []
    t0 = time.perf_counter()
    for dup in (False, True):
        (out_cpu,) = node.vfi("stmfnet.pth", frames, duplicate_first_last_frames=dup, batch_size=1, params=stmf_params, device="cpu")
        orig = [0, 1, 2, 4, 5, 6] if dup else [0, 1, 3, 4]  # [0, (0), 1, mid, 2, 3, (3)]
        src = [0, 0, 1, 2, 3, 3] if dup else [0, 1, 2, 3]
        for dtype in ("float32", "bfloat16"):
            out = outs[dup, dtype]
            check(tuple(out.shape) == (len(orig) + 1, *STMFNET_HW, 3) and out.is_cuda, f"STMFNet output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"STMFNet dup={dup} {dtype} has non-finite values")
            check(torch.equal(out[orig].cpu(), torch.from_numpy(frames[src])), f"STMFNet dup={dup} {dtype}: original frames not passed through")
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"STMFNet node dup={dup} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            psnrs.append(f"dup={dup} {dtype} {p:.2f} dB")
    print(
        f"stmfnet: STMFNet node 4x{STMFNET_HW[0]}x{STMFNET_HW[1]} (reflect-padded to 256x256) x2 batch 1, cuda vs cpu fp32: "
        f"{', '.join(psnrs)} (cpu leg {time.perf_counter() - t0:.1f} s); launches {stmf_launches} over {calls} calls per dtype "
        f"(duplicate_first_last_frames False/True), as derived from the model (per forward {stmfnet.warps_per_forward()} "
        f"and {stmfnet.splats_per_forward()} splat)",
        flush=True,
    )
    del outs, out_cpu

    # ---- 25. STMFNet JAX golden ----------------------------------------------
    clock("25")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_stmfnet_golden.npz")) as z:
        seed, gframes, golden = int(z["seed"]), z["frames"], torch.from_numpy(z["output"])
    gf = [torch.from_numpy(gframes[i : i + 1].astype(np.float32) / 255.0).to(dev) for i in range(4)]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gout = stmfnet.make_model_fn(stmfnet.init_params(seed), device=dev)(*gf)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"STMFNet golden: {pg:.2f} dB < 40")
    print(f"golden: port STMFNet on cuda fp32 vs JAX STMFNet fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 26. STMFNet timing --------------------------------------------------
    clock("26")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    stmf_fn(*sf)
    torch.cuda.synchronize()
    stmf_peak = torch.cuda.max_memory_allocated() - base_mem
    stmf_fps = 1 / measure(stmf_fn, *sf, iters=3, rounds=3)
    net = stmfnet._load(stmf_params, torch.bfloat16, dev)
    with torch.inference_mode():
        x0, x1, x2, x3 = (reflect_pad(stmfnet._nchw(f.to(torch.bfloat16)), (0, 0, 0, 72)) for f in sf)
        feats = stmfnet.stage_feats(net, x1, x2)
        adas = [a for sfx in ("", "_ds", "_us") for a in stmfnet.stage_stream(net, feats, x1, x2, sfx)]
        splats = stmfnet.stage_flowsplat(net, x1, x2)
        tilde = stmfnet.stage_synth(net, adas, splats)
        stmf_stage_ms = {"feats": cuda_ms(lambda: stmfnet.stage_feats(net, x1, x2), 3)}
        for sfx in ("", "_ds", "_us"):
            stmf_stage_ms[f"stream{sfx or '_1x'}"] = cuda_ms(lambda: stmfnet.stage_stream(net, feats, x1, x2, sfx), 3)
        stmf_stage_ms["flowsplat"] = cuda_ms(lambda: stmfnet.stage_flowsplat(net, x1, x2), 3)
        stmf_stage_ms["synth"] = cuda_ms(lambda: stmfnet.stage_synth(net, adas, splats), 3)
        stmf_stage_ms["dyntex"] = cuda_ms(lambda: stmfnet.stage_dyntex(net, x0, x1, x2, x3, tilde), 3)
    del net, x0, x1, x2, x3, feats, adas, splats, tilde
    # the two plain ops at the forward's shapes (bf16): AdaCoF twice per
    # stream (the frame edge-padded by 2; 25 weights and offsets per pixel),
    # the correlation once per PWC level (both directions as one batch)
    plain_op_ms = {}
    for name, (h, w) in (("adacof", (1152, 1920)), ("adacof_ds", (576, 960)), ("adacof_us", (2304, 3840))):
        img = torch.rand(1, h + 4, w + 4, 3, device=dev, dtype=torch.bfloat16)
        maps = [torch.rand(1, h, w, 25, device=dev, dtype=torch.bfloat16) * 4 - 2 for _ in range(3)]
        plain_op_ms[f"{name} x2"] = 2 * cuda_ms(lambda: adacof_func(img, *maps), 3)
    del img, maps
    corr_ms = 0.0
    for level, c in zip(range(2, 7), (32, 64, 96, 128, 196)):
        fa, fb = (torch.rand(2, 1152 >> level, 1920 >> level, c, device=dev, dtype=torch.bfloat16) for _ in range(2))
        corr_ms += cuda_ms(lambda: correlation_func(fa, fb), 3)
    plain_op_ms["correlation x5 levels"] = corr_ms
    del fa, fb
    print(
        f"timing {card}: STMFNet's plain ops per 1080p bf16 forward: "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v * stmf_fps / 1e3:.1f} % of the forward)" for k, v in plain_op_ms.items()),
        flush=True,
    )
    print(
        f"timing {card}: STMFNet 1080p 2x bf16 batch 1 {stmf_fps:.3f} frames/s; peak memory of one forward "
        f"{stmf_peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} GiB held before it; stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stmf_stage_ms.items()),
        flush=True,
    )
    stmf_profile = profile_forward("STMFNet 1080p bf16 b1", stmf_fn, *sf, card=card)
    stmf_splat_times = {}
    for vals, flow in stmf_splats:
        times = in_turns({
            "plain": (lambda: softsplat_torch(vals, flow), 3),
            "kernel": (lambda: softsplat_func(vals, flow), 20),
            "library": (library_splat(vals, flow), 20),
        })
        sb = bound(*splat_work(vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)))
        key = "x".join(map(str, vals.shape))
        stmf_splat_times[key] = {
            "ms": statistics.mean(times["kernel"]), "plain_ms": statistics.mean(times["plain"]),
            "bound_ms": sb[0], "bound_by": sb[1], "library_ms": statistics.mean(times["library"]),
        }
        print(
            f"timing {card}: splat {list(vals.shape)} bf16, bf16 flow (STMFNet's softmax-mode input): "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {sb[0]:.4f} ms ({sb[1]}), the op at {100 * sb[0] / stmf_splat_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    stmf_warp_times = {}
    for shape, body in [(s_, "wide") for s_ in STMFNET_PWC_SHAPES] + [(STMFNET_IMAGE_SHAPE, "tiled"), (STMFNET_IMAGE_SHAPE[:3] + (1,), "tiled")]:
        dt = torch.float32 if shape[3] == 1 else torch.bfloat16
        img = torch.rand(shape, generator=g).to(dev, dt)
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev, torch.bfloat16)
        times = in_turns({
            "plain": (lambda: warp_torch(img, flow, "zeros"), 3),
            body: (lambda: warp(img, flow, "zeros"), 30),
            "grid_sample": (grid_sample_call(img, flow, "zeros"), 10),
        })
        wb = warp_bound(img, flow)
        key = f"{'x'.join(map(str, shape))} {str(dt).split('.')[-1]} zeros"
        stmf_warp_times[key] = {
            "kernel": body, "ms": statistics.mean(times[body]), "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]), "bound_ms": wb[0], "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {list(shape)} {str(dt).split('.')[-1]} zeros, bf16 flow (STMFNet): "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; bound {wb[0]:.4f} ms ({wb[1]}), {body} at {100 * wb[0] / stmf_warp_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    del img, flow, stmf_splats, stmf_fn, sf

    # ---- 27. FLAVR -----------------------------------------------------------
    clock("27")
    flavr_params = flavr.init_params(0)
    frames = shifted_pattern(4, *FLAVR_HW, seed=6)
    node = FLAVR_VFI()
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    for dtype in ("float32", "bfloat16"):
        for dup in (False, True):
            (outs[dup, dtype],) = node.vfi(
                "FLAVR_2x.pth", frames, duplicate_first_last_frames=dup, batch_size=2, dtype=dtype, params=flavr_params, device="cuda"
            )
    torch.cuda.synchronize()
    flavr_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(flavr_launches == {"narrow": 0, "wide": 0, "splat": 0}, f"FLAVR launched hand kernels: {flavr_launches}")
    psnrs = []
    t0 = time.perf_counter()
    for dup in (False, True):
        (out_cpu,) = node.vfi("FLAVR_2x.pth", frames, duplicate_first_last_frames=dup, batch_size=2, params=flavr_params, device="cpu")
        orig = [0, 1, 2, 4, 5, 6] if dup else [0, 1, 3, 4]  # [0, (0), 1, mid, 2, 3, (3)]
        src = [0, 0, 1, 2, 3, 3] if dup else [0, 1, 2, 3]
        for dtype in ("float32", "bfloat16"):
            out = outs[dup, dtype]
            check(tuple(out.shape) == (len(orig) + 1, *FLAVR_HW, 3) and out.is_cuda, f"FLAVR output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"FLAVR dup={dup} {dtype} has non-finite values")
            check(torch.equal(out[orig].cpu(), torch.from_numpy(frames[src])), f"FLAVR dup={dup} {dtype}: original frames not passed through")
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"FLAVR node dup={dup} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            psnrs.append(f"dup={dup} {dtype} {p:.2f} dB")
    flavr_cpu_s = time.perf_counter() - t0
    del outs, out_cpu
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_flavr_golden.npz")) as z:
        seed, gframes, golden = int(z["seed"]), z["frames"], torch.from_numpy(z["output"])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    (gout,) = FLAVR_VFI().vfi("FLAVR_2x.pth", gframes.astype(np.float32) / 255.0, params=flavr.init_params(seed), device="cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg_flavr = psnr(gout[2:3], golden)
    check(pg_flavr >= 40.0, f"FLAVR golden: {pg_flavr:.2f} dB < 40")
    flavr_fn = flavr.make_model_fn(flavr_params, dtype=torch.bfloat16, device=dev)
    ff = [torch.from_numpy(np.random.default_rng(i).random((2, 1088, 1920, 3), dtype=np.float32)).to(dev) for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    flavr_fps = 2 / measure(flavr_fn, *ff, iters=3, rounds=3)
    flavr_peak = torch.cuda.max_memory_allocated() - base_mem
    print(
        f"flavr: FLAVR node 4x{FLAVR_HW[0]}x{FLAVR_HW[1]} (edge-padded to 144x240) x2 batch 2, cuda vs cpu fp32: "
        f"{', '.join(psnrs)} (cpu leg {flavr_cpu_s:.1f} s); no hand-kernel launch; golden: port on cuda fp32 vs JAX FLAVR fp32 "
        f"{pg_flavr:.2f} dB, max abs err {(gout[2:3].cpu() - golden).abs().max().item():.3g}",
        flush=True,
    )
    print(
        f"timing {card}: FLAVR 1080p (padded to 1088x1920) 2x bf16 batch 2 {flavr_fps:.3f} frames/s; peak memory "
        f"{flavr_peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} GiB held before it",
        flush=True,
    )
    profile_forward("FLAVR 1080p bf16 b2", flavr_fn, *ff, card=card)
    del flavr_fn, ff

    # ---- 28. kernels at IFRNet's, IFUnet's and AMT's shapes -------------------
    clock("28")
    s8_errs = {}
    s8_shapes = dict.fromkeys(sb for fam in SLICE8_WARPS.values() for sb in fam)
    for shape, body in s8_shapes:
        flow32 = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            img = torch.rand(shape, generator=g).to(dev, dt)
            s8_errs[f"{list(shape)} {str(dt).split('.')[-1]} ({body})"] = routed_and_k1(img, flow32.to(dt), body, "border")
    del img, flow32
    print(
        f"slice8 kernels: the routed kernel and K1 vs plain, border, flow in the values' dtype, bit-exact at "
        + ", ".join(f"{k} max err {v}" for k, v in s8_errs.items()),
        flush=True,
    )
    s8_warp_times = {}
    for shape, body in s8_shapes:
        img = torch.rand(shape, generator=g).to(dev, torch.bfloat16)
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev, torch.bfloat16)
        gs = grid_sample_call(img, flow, "border")
        planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        k1 = lambda: warp_kernel.warp_bilinear(planes, fplanes, False)  # noqa: E731
        calls = {"plain": (lambda: warp_torch(img, flow), 3), body: (lambda: warp(img, flow), 30), "grid_sample": (gs, 10)}
        if body == "wide":  # K1 at the same shape: where the routing threshold falls
            calls["K1"] = (k1, 30)
        times = in_turns(calls)
        dev_k, dev_gs = device_ms(lambda: warp(img, flow), 10), device_ms(gs, 10)
        dev_k1 = device_ms(k1, 10) if body == "wide" else dev_k
        wb = warp_bound(img, flow)
        key = f"{'x'.join(map(str, shape))} bf16 border"
        s8_warp_times[key] = {
            "kernel": body, "ms": statistics.mean(times[body]), "device_ms": dev_k, "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]), "library_device_ms": dev_gs, "k1_device_ms": dev_k1,
            "bound_ms": wb[0], "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {list(shape)} bf16 border, bf16 flow: "
            + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; device {body} {dev_k:.4f} ms, K1 {dev_k1:.4f} ms, grid_sample {dev_gs:.4f} ms; bound {wb[0]:.4f} ms "
            f"({wb[1]}), {body} on the device at {100 * wb[0] / dev_k:.1f} % of it",
            flush=True,
        )
    del img, flow, gs, planes, fplanes
    # the wide kernel forced at one width per vector it picks, 1080p sizes
    probe_errs = {}
    for shape in WIDE_PROBE_SHAPES:
        flow32 = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            img = torch.rand(shape, generator=g).to(dev, dt)
            for mode in ("border", "zeros"):
                got, ref = warp(img, flow32.to(dt), mode, prefer_wide=True), warp_torch(img, flow32.to(dt), mode)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                check(torch.equal(got, ref), f"wide kernel vs plain at {list(shape)} {dt} {mode}: max err {err}, not bit-exact")
                probe_errs[f"{list(shape)} {str(dt).split('.')[-1]} {mode}"] = err
    del img, flow32, got, ref
    print("slice8 kernels: the wide kernel forced, vs plain, bit-exact at " + ", ".join(f"{k} max err {v}" for k, v in probe_errs.items()), flush=True)

    # every other main path's wide launches as its profile recorded them
    # (FILM, M2M, GMFSS base and union, STMFNet), and RIFE 4.0's Contextnet
    # warps (bf16, border, contiguous): in the recorded layout, f32 and bf16
    # values (flow in the same dtype), border and zeros, bit for bit against
    # the twin; then as recorded, the wide kernel's and grid_sample's ms, by
    # CUDA events and on the device, and the bound
    from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import grid_sample_planes, strided_like

    path_layouts = {}
    profiled = {"m2m": m2m_profile, "film": film_profile, **gmfss_profiles, "stmfnet": stmf_profile}
    for path, prof in profiled.items():
        for lay in prof.get("warp_bilinear_wide", {}).get("launch_layouts", ()):
            key = (tuple(lay["shape"]), tuple(lay["strides"]), lay["offset"], lay["dtype"], tuple(lay["flow_strides"]), lay["flow_dtype"], lay["zeros"])
            path_layouts.setdefault(key, {})[path] = lay["launches"]
    for shape in RIFE40_WIDE_SHAPES:
        n_, h_, w_, c_ = shape
        key = (shape, (h_ * w_ * c_, 1, w_ * c_, c_), 0, "bfloat16", (h_ * w_ * 2, 1, w_ * 2, 2), "bfloat16", False)
        path_layouts.setdefault(key, {})["rife40 540p b2 refined"] = 1
    path_wide_times = {}
    gd = torch.Generator(device=dev).manual_seed(9)
    for (shape, strides, offset, dts, fstrides, fdts, zeros), paths in sorted(path_layouts.items(), key=lambda kv: -math.prod(kv[0][0])):
        n_, h_, w_, c_ = shape
        flow32 = torch.from_numpy(warp_cases.smooth_flow(n_, h_, w_, amp=6.0)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            planes = strided_like((n_, c_, h_, w_), strides, offset, dt, dev, torch.rand((n_, c_, h_, w_), generator=gd, device=dev).to(dt))
            fplanes = flow32.to(dt).permute(0, 3, 1, 2)
            for z in (False, True):
                got = warp_kernel.warp_bilinear_wide(planes, fplanes, z).permute(0, 2, 3, 1)
                ref = warp_torch(planes.permute(0, 2, 3, 1), flow32.to(dt), "zeros" if z else "border")
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                check(torch.equal(got, ref), f"wide kernel vs plain at {list(shape)} {dt} zeros={z} (layout of {paths}): max err {err}, not bit-exact")
                del got, ref
        dt, fdt = getattr(torch, dts), getattr(torch, fdts)
        planes = strided_like((n_, c_, h_, w_), strides, offset, dt, dev, torch.rand((n_, c_, h_, w_), generator=gd, device=dev).to(dt))
        fplanes = strided_like((n_, 2, h_, w_), fstrides, 0, fdt, dev, flow32.to(fdt).permute(0, 3, 1, 2))
        gs = grid_sample_planes(planes, fplanes, zeros)
        wide_fn = lambda: warp_kernel.warp_bilinear_wide(planes, fplanes, zeros)  # noqa: E731
        times = in_turns({"wide": (wide_fn, 30), "grid_sample": (gs, 10)})
        dev_k, dev_gs = device_ms(wide_fn, 10, "warp_bilinear_wide_kernel"), device_ms(gs, 10, "grid_sampler")
        wb = bound(*warp_work(planes, fplanes))
        key = f"{'x'.join(map(str, shape))} {dts} {'zeros' if zeros else 'border'}, {fdts} flow, {'channels_last' if planes.is_contiguous(memory_format=torch.channels_last) else 'strided'}"
        path_wide_times[key] = {
            "kernel": "wide", "paths": paths, "ms": statistics.mean(times["wide"]), "device_ms": dev_k,
            "library_ms": statistics.mean(times["grid_sample"]), "library_device_ms": dev_gs, "bound_ms": wb[0], "bound_by": wb[1],
        }
        print(
            f"timing {card}: wide {key} ({', '.join(f'{p} x{k}' for p, k in paths.items())}), bit-exact in f32 and bf16, border "
            f"and zeros: wide {statistics.mean(times['wide']):.4f} ms {times['wide']}, grid_sample "
            f"{statistics.mean(times['grid_sample']):.4f} ms; device wide {dev_k:.4f} ms, grid_sample {dev_gs:.4f} ms; bound "
            f"{wb[0]:.4f} ms ({wb[1]}), wide on the device at {100 * wb[0] / dev_k:.1f} % of it",
            flush=True,
        )
        del planes, fplanes, gs, flow32

    def card_vs_cpu(label, node, ckpt, params, runs, build, want, batch=2, seed=9, **kw):
        """``node`` on 4 frames of 135x240 (``shifted_pattern`` of ``seed``),
        each ``(multiplier, dtypes, extra kwargs)`` of ``runs`` on the card
        (fp32 with TF32 off) against fp32 on the CPU: >= 40 dB, the original
        frames passed through, and each model call's launches equal to
        ``want(name, dtype)``, counted by wrapping ``build`` (the model module
        and the name of the function the node builds its callables with)
        from just before the card runs to just after. Returns the launches,
        the PSNRs and the number of model calls."""
        frames = shifted_pattern(4, *NODE_HW, seed=seed)
        log, outs = [], {}
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
        with counted_calls(*build, log):
            for m, dtypes, extra in runs:
                for dtype in dtypes:
                    (outs[m, dtype, str(extra)],) = node().vfi(
                        ckpt, frames, multiplier=m, batch_size=batch, dtype=dtype, params=params, device="cuda", **kw, **extra
                    )
        torch.cuda.synchronize()
        launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        for name, dt, got in log:
            check(got == want(name, dt), f"{label} {name} call in {dt} launched {got}, expected {want(name, dt)}")
        check(launches == {k: sum(got[k] for _, _, got in log) for k in launches}, f"{label}: launches outside the model calls")
        psnrs = []
        for m, dtypes, extra in runs:
            (out_cpu,) = node().vfi(ckpt, frames, multiplier=m, batch_size=batch, params=params, device="cpu", **kw, **extra)
            for dtype in dtypes:
                out = outs[m, dtype, str(extra)]
                check(tuple(out.shape) == (3 * m + 1, *NODE_HW, 3) and out.is_cuda, f"{label} output {tuple(out.shape)} on {out.device}")
                check(bool(torch.isfinite(out).all()), f"{label} x{m} {dtype} {extra} has non-finite values")
                check(torch.equal(out[::m].cpu(), torch.from_numpy(frames)), f"{label} x{m} {dtype} {extra}: original frames not passed through")
                p_ = psnr(out, out_cpu)
                check(p_ >= 40.0, f"{label} node x{m} {extra} cuda {dtype} vs cpu fp32 {p_:.2f} dB < 40")
                psnrs.append(f"x{m} {dtype}{' ' + str(extra) if extra else ''} {p_:.2f} dB")
        return launches, psnrs, len(log)

    def node_golden(name, node, ckpt, make_params, **kw):
        """The JAX golden ``tests/fixtures/torch_port_<name>_golden.npz``
        (two frames, their midpoint) through ``node`` on the card in fp32
        (TF32 off), x2, with ``make_params(the golden's seed)``."""
        with np.load(os.path.join(ROOT, "tests", "fixtures", f"torch_port_{name}_golden.npz")) as z:
            seed, gframes, golden = int(z["seed"]), z["frames"][:, 0].astype(np.float32) / 255.0, torch.from_numpy(z["output"])
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        (gout,) = node().vfi(ckpt, gframes, multiplier=2, params=make_params(seed), device="cuda", **kw)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        pg = psnr(gout[1:2], golden)
        check(pg >= 40.0, f"{name} golden through the node: {pg:.2f} dB < 40")
        return f"golden through the node on cuda fp32 vs JAX fp32 {pg:.2f} dB, max abs err {(gout[1:2].cpu() - golden).abs().max().item():.3g}"

    def timed_row(label, fn, x, n, profile=True):
        """``fn(*x)`` on ``n`` frames a call: frames/s by ``measure``, the
        peak memory of one call, and (with ``profile``) its profile."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        fn(*x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        fps = n / measure(fn, *x, iters=3, rounds=3)
        print(
            f"timing {card}: {label} {fps:.3f} frames/s ({1e3 * n / fps:.3f} ms per call); peak memory of one call "
            f"{peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} GiB held before it",
            flush=True,
        )
        return fps, profile_forward(label, fn, *x, card=card) if profile else None

    def slice8_row(label, fn, n, hw, family):
        """One 1080p bf16 forward's warps launched again on copies of their
        inputs against the twin (the shapes must be ``SLICE8_WARPS[family]``),
        then :func:`timed_row`."""
        x = [torch.from_numpy(np.random.default_rng(i).random((n, *hw, 3), dtype=np.float32)).to(dev) for i in range(2)]
        x.append(torch.full((n,), 0.5, device=dev))
        store = []
        with captured_warps(store):
            fn(*x)
        torch.cuda.synchronize()
        seen = warps_vs_plain(store, f"{label} forward")
        want = {}
        for shape, body in SLICE8_WARPS[family]:
            want.setdefault("warp_bilinear_wide" if body == "wide" else "warp_bilinear", set()).add((shape, "border", "bfloat16", "bfloat16"))
        check(seen == want, f"{label} warps at {seen}, expected {want}")
        print(f"{label}: its {sum(len(v) for v in seen.values())} warp shapes bit-exact", flush=True)
        del store
        return timed_row(label, fn, x, n)

    # ---- 29. IFRNet node end to end, and the golden ---------------------------
    clock("29")
    ifrnet_launches = {"narrow": 0, "wide": 0, "splat": 0}
    t0 = time.perf_counter()
    for variant, ckpt, mults in (("S", "IFRNet_S_Vimeo90K.pth", (2, 3)), ("L", "IFRNet_L_Vimeo90K.pth", (2,))):
        got, psnrs, n_calls = card_vs_cpu(
            f"IFRNet {variant}", IFRNet_VFI, ckpt, ifrnet.init_params(variant, 0), [(m, ("float32", "bfloat16"), {}) for m in mults],
            (ifrnet, "make_model_fn"), lambda name, dt, variant=variant: {**ifrnet.warps_per_forward(variant, dt), "splat": 0},
            batch=4, seed=7,
        )
        ifrnet_launches = {k: ifrnet_launches[k] + got[k] for k in got}
        print(
            f"ifrnet: IFRNet {variant} node 4x{NODE_HW[0]}x{NODE_HW[1]} (padded to 192x256 inside) batch 4, cuda vs cpu "
            f"fp32: {', '.join(psnrs)}; {n_calls} model calls, launches {got}, per forward {ifrnet.warps_per_forward(variant)}",
            flush=True,
        )
    print(f"ifrnet: {node_golden('ifrnet', IFRNet_VFI, 'IFRNet_S_Vimeo90K.pth', lambda seed: ifrnet.init_params('S', seed))}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 30. IFRNet timing ----------------------------------------------------
    clock("30")
    ifrnet_fn = ifrnet.make_model_fn(ifrnet.init_params("S", 0), "S", dtype=torch.bfloat16, device=dev)
    ifrnet_fps, ifrnet_profile = slice8_row("IFRNet S 1080p (padded to 1088x1920) 2x bf16 b4", ifrnet_fn, 4, (1080, 1920), "ifrnet")
    del ifrnet_fn

    # ---- 31. IFUnet node end to end, and the golden ---------------------------
    clock("31")
    ifunet_launches = {"narrow": 0, "wide": 0, "splat": 0}
    t0 = time.perf_counter()
    ifunet_params = ifunet.init_params(0)
    for ensemble, mults in ((False, (2, 3)), (True, (2,))):
        got, psnrs, n_calls = card_vs_cpu(
            f"IFUnet ensemble={ensemble}", IFUnet_VFI, "IFUNet.pth", ifunet_params, [(m, ("float32", "bfloat16"), {}) for m in mults],
            (ifunet, "make_model_fn"), lambda name, dt: {**ifunet.warps_per_forward(dt), "splat": 0}, seed=7, ensemble=ensemble,
        )
        ifunet_launches = {k: ifunet_launches[k] + got[k] for k in got}
        print(
            f"ifunet: IFUnet node ensemble={ensemble} 4x{NODE_HW[0]}x{NODE_HW[1]} (padded to 192x256 inside) batch 2, "
            f"cuda vs cpu fp32: {', '.join(psnrs)}; {n_calls} model calls, launches {got}, per forward {ifunet.warps_per_forward()}",
            flush=True,
        )
    print(f"ifunet: {node_golden('ifunet', IFUnet_VFI, 'IFUNet.pth', ifunet.init_params)}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 32. IFUnet timing ----------------------------------------------------
    clock("32")
    ifunet_fn = ifunet.make_model_fn(ifunet_params, dtype=torch.bfloat16, device=dev)
    ifunet_fps, ifunet_profile = slice8_row("IFUnet 1080p (padded to 1088x1920) 2x bf16 b2, no ensemble", ifunet_fn, 2, (1080, 1920), "ifunet")
    del ifunet_fn

    # ---- 33. AMT node end to end, and the golden ------------------------------
    clock("33")
    amt_launches = {"narrow": 0, "wide": 0, "splat": 0}
    t0 = time.perf_counter()
    for variant, ckpt, mults in (("S", "amt-s.pth", (2, 3)), ("L", "amt-l.pth", (2,)), ("G", "amt-g.pth", (2,))):
        got, psnrs, n_calls = card_vs_cpu(
            f"AMT {variant}", AMT_VFI, ckpt, amt.init_params(variant, 0), [(m, ("float32", "bfloat16"), {}) for m in mults],
            (amt, "make_model_fn"), lambda name, dt, variant=variant: {**amt.warps_per_forward(variant, dt), "splat": 0}, seed=7,
        )
        amt_launches = {k: amt_launches[k] + got[k] for k in got}
        print(
            f"amt: AMT {variant} node 4x{NODE_HW[0]}x{NODE_HW[1]} (edge-padded to 144x240, centred) batch 2, cuda vs cpu "
            f"fp32: {', '.join(psnrs)}; {n_calls} model calls, launches {got}, per forward {amt.warps_per_forward(variant)}",
            flush=True,
        )
    print(f"amt: {node_golden('amt', AMT_VFI, 'amt-s.pth', lambda seed: amt.init_params('S', seed))}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 34. AMT timing, and the correlation lookups' share --------------------
    clock("34")
    amt_fn = amt.make_model_fn(amt.init_params("S", 0), "amt-s.pth", dtype=torch.bfloat16, device=dev)
    amt_fps, amt_profile = slice8_row("AMT-S 1080p (node-padded to 1088x1920) 2x bf16 b2", amt_fn, 2, (1088, 1920), "amt")
    del amt_fn
    # the forward's three lookups (both directions each), at its shapes: the
    # feature maps [2, 84, 136, 240] bf16 and end points within a few pixels
    fm = [torch.randn(2, 84, 136, 240, generator=g).to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last) for _ in range(2)]
    gy, gx = torch.meshgrid(torch.arange(136.0, device=dev), torch.arange(240.0, device=dev), indexing="ij")
    base = torch.stack([gx, gy], -1).expand(2, 136, 240, 2)
    c0, c1 = (base + torch.from_numpy(warp_cases.smooth_flow(2, 136, 240, amp=3.0)).to(dev) * s for s in (1.0, -1.0))
    corr = BidirCorr(*fm)
    look_ms = cuda_ms(lambda: corr.lookup(c0, c1), 3)
    look_dev = device_ms(lambda: corr.lookup(c0, c1), 3)
    fwd_ms = 2e3 / amt_fps
    print(
        f"timing {card}: AMT-S's correlation lookup (both directions, [2, 84, 136, 240] bf16, 4 levels, f32 gathers in "
        f"bands of {2**26} values) {look_ms:.3f} ms per call ({look_dev:.3f} ms on the device); 3 per forward: "
        f"{3 * look_ms:.3f} ms, {100 * 3 * look_ms / fwd_ms:.1f} % of the {fwd_ms:.3f} ms forward",
        flush=True,
    )
    del fm, base, c0, c1, corr

    # ---- 35. kernels at ATM's and XVFI's 1080p shapes -------------------------
    clock("35")
    t0 = time.perf_counter()
    s10_errs = {}
    for shape, vdt, body in SLICE10_WARPS:
        flow32 = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            img = torch.rand(shape, generator=g).to(dev, getattr(torch, vdt) if vdt else dt)
            s10_errs[f"{list(shape)} {str(img.dtype).split('.')[-1]}, {str(dt).split('.')[-1]} flow ({body})"] = routed_and_k1(img, flow32.to(dt), body)
    # ATM's enhanced features: each half a channel slice of [1, 136, 240, 768]
    # (pixel stride 768), as the model hands them to the kernel
    enh_flow32 = torch.from_numpy(warp_cases.smooth_flow(*ATM_ENH_SHAPE[:3], amp=6.0)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        feat = torch.rand(ATM_ENH_SHAPE, generator=g).to(dev, dt)
        for half in (0, 1):
            view = feat[..., 384 * half : 384 * (half + 1)]
            check(not view.is_contiguous() and view.stride()[2] == 768, f"ATM half {half}: strides {view.stride()}")
            s10_errs[f"[1, 136, 240, 768][..., {384 * half}:{384 * (half + 1)}] {str(dt).split('.')[-1]} (wide)"] = routed_and_k1(
                view, enh_flow32.to(dt), "wide"
            )
    del img, flow32, feat, view
    # one ATM base b1 forward and one XVFI Vimeo b2 reuse and infer, bf16, at
    # 1080p: each warp launched again on a copy of its inputs, each splat too
    atm_bf16 = atm.make_model_fn(atm.init_params("base", 0), "base", True, False, torch.bfloat16, dev)
    xvfi_params = xvfi.init_params("XVFInet_Vimeo_exp1_latest.pt", 0)
    xvfi_reuse, xvfi_infer = xvfi.make_pair_fns(xvfi_params, "XVFInet_Vimeo_exp1_latest.pt", torch.bfloat16, dev)
    af = [torch.from_numpy(np.random.default_rng(i).random((1, 1080, 1920, 3), dtype=np.float32)).to(dev) for i in range(2)]
    xf = [torch.from_numpy(np.random.default_rng(i).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev) for i in range(2)]
    xf.append(torch.full((2,), 0.5, device=dev))
    a_store, x_store, x_splats = [], [], []
    with captured_warps(a_store):
        atm_bf16(*af)
    with captured_warps(x_store), captured_splats(x_splats):
        xvfi_infer(xf[0], xf[1], xvfi_reuse(xf[0], xf[1]), xf[2])
    torch.cuda.synchronize()
    aseen, xseen = warps_vs_plain(a_store, "ATM base 1080p forward"), warps_vs_plain(x_store, "XVFI Vimeo 1080p reuse + infer")
    n_atm = {k: sum(1 for kk, *_ in a_store if kk == k) for k in ("warp_bilinear", "warp_bilinear_wide")}
    n_xvfi = {k: sum(1 for kk, *_ in x_store if kk == k) for k in ("warp_bilinear", "warp_bilinear_wide")}
    want_a = atm.warps_per_forward("base", True, False, torch.bfloat16)
    want_x = {k: xvfi.warps_per_reuse("XVFInet_Vimeo_exp1_latest.pt")[k] + xvfi.warps_per_infer()[k] for k in ("narrow", "wide")}
    check(
        aseen == {"warp_bilinear_wide": {((1, 136, 240, 384), "zeros", "bfloat16", "bfloat16")},
                  "warp_bilinear": {((1, h, w, 3), "zeros", "bfloat16", "bfloat16") for h, w in ((272, 480), (544, 960), (1088, 1920))}}
        and n_atm == {"warp_bilinear": want_a["narrow"], "warp_bilinear_wide": want_a["wide"]},
        f"ATM warps {n_atm} at {aseen}, expected {want_a}",
    )
    check(
        xseen == {"warp_bilinear_wide": {((2, 544, 960, 64), "zeros", "bfloat16", "float32")},
                  "warp_bilinear": {((2, 544, 960, 1), "zeros", "float32", "float32"), ((2, 1088, 1920, 3), "zeros", "bfloat16", "float32"),
                                    ((2, 1088, 1920, 1), "zeros", "float32", "float32")}}
        and n_xvfi == {"warp_bilinear": want_x["narrow"], "warp_bilinear_wide": want_x["wide"]},
        f"XVFI warps {n_xvfi} at {xseen}, expected {want_x}",
    )
    del a_store, x_store
    check([tuple(v.shape) for v, _ in x_splats] == [XVFI_SPLAT_SHAPE] and x_splats[0][0].dtype == torch.float32,
          f"XVFI splats {[(tuple(v.shape), v.dtype) for v, _ in x_splats]}")
    xsplat_errs = {}
    sflow = torch.from_numpy(warp_cases.smooth_flow(*XVFI_SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    xsplat_errs["smooth f32"] = splat_vs_plain(torch.rand(XVFI_SPLAT_SHAPE, generator=g).to(dev), sflow)
    xsplat_errs["captured f32"] = splat_vs_plain(*x_splats[0], f32_scaled=True)
    xsplat_errs["captured as bf16"] = splat_vs_plain(x_splats[0][0].bfloat16(), x_splats[0][1])
    print(
        "slice10 kernels: K1 and the routed kernel vs plain, zeros, bit-exact at "
        + ", ".join(f"{k} max err {v}" for k, v in s10_errs.items())
        + f"; one ATM base 1080p bf16 forward's {sum(n_atm.values())} warps ({n_atm}) and one XVFI Vimeo 1080p bf16 reuse + "
        f"infer's {sum(n_xvfi.values())} ({n_xvfi}) launched again on their inputs, each bit-exact against the plain twin; "
        f"K2 at XVFI's CFR splat {list(XVFI_SPLAT_SHAPE)}: " + ", ".join(f"{k} max err {v}" for k, v in xsplat_errs.items()),
        flush=True,
    )
    s10_warp_times = {}
    timed = [(shape, vdt, body, None) for shape, vdt, body in SLICE10_WARPS] + [(ATM_ENH_SHAPE, None, "wide", h) for h in (0, 1)]
    for shape, vdt, body, half in timed:
        base = torch.rand(shape, generator=g).to(dev, getattr(torch, vdt) if vdt else torch.bfloat16)
        img = base if half is None else base[..., 384 * half : 384 * (half + 1)]
        fdt = torch.float32 if shape[0] == 2 else torch.bfloat16  # XVFI warps by f32 flows, ATM by the model's
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev, fdt)
        gs = grid_sample_call(img, flow, "zeros")
        times = in_turns({body: (lambda: warp(img, flow, "zeros"), 30), "plain": (lambda: warp_torch(img, flow, "zeros"), 3),
                          "grid_sample": (gs, 10)})
        body_name = KERNEL_BODIES["warp_bilinear_wide" if body == "wide" else "warp_bilinear"][0]
        dev_k, dev_gs = device_ms(lambda: warp(img, flow, "zeros"), 10, body_name), device_ms(gs, 10)
        wb = warp_bound(img, flow)
        key = (f"{'x'.join(map(str, shape))}" + ("" if half is None else f"[..., {384 * half}:{384 * (half + 1)}]")
               + f" {str(img.dtype).split('.')[-1]} zeros, {str(fdt).split('.')[-1]} flow")
        s10_warp_times[key] = {
            "kernel": body, "ms": statistics.mean(times[body]), "device_ms": dev_k, "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]), "library_device_ms": dev_gs, "bound_ms": wb[0], "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {key}: " + ", ".join(f"{k} {statistics.mean(v):.4f} ms {v}" for k, v in times.items())
            + f"; device {body} {dev_k:.4f} ms, grid_sample {dev_gs:.4f} ms; bound {wb[0]:.4f} ms ({wb[1]}), {body} on the "
            f"device at {100 * wb[0] / dev_k:.1f} % of it",
            flush=True,
        )
    del base, img, flow, gs
    xsplat_times = {}
    for label, (vals, sfl) in {"smooth": (torch.rand(XVFI_SPLAT_SHAPE, generator=g).to(dev), sflow), "captured": x_splats[0]}.items():
        times = in_turns({"kernel": (lambda: softsplat_func(vals, sfl), 20), "plain": (lambda: softsplat_torch(vals, sfl), 3)})
        dev_k = device_ms(lambda: softsplat_func(vals, sfl), 10, KERNEL_BODIES["softsplat"][0])
        sb = bound(*splat_work(vals.permute(0, 3, 1, 2), sfl.permute(0, 3, 1, 2)))
        xsplat_times[f"{'x'.join(map(str, XVFI_SPLAT_SHAPE))} f32 {label}"] = {
            "ms": statistics.mean(times["kernel"]), "device_ms": dev_k, "plain_ms": statistics.mean(times["plain"]),
            "bound_ms": sb[0], "bound_by": sb[1],
        }
        print(
            f"timing {card}: splat {list(XVFI_SPLAT_SHAPE)} f32 ({label} flow): kernel {statistics.mean(times['kernel']):.4f} ms "
            f"{times['kernel']}, plain {statistics.mean(times['plain']):.4f} ms; device {dev_k:.4f} ms; bound {sb[0]:.4f} ms "
            f"({sb[1]}), kernel on the device at {100 * sb[0] / dev_k:.1f} % of it",
            flush=True,
        )
    del vals, sfl, sflow, x_splats
    print(f"slice10 kernels: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 36. ATM node end to end, and the golden ------------------------------
    clock("36")
    t0 = time.perf_counter()
    atm_launches = {"narrow": 0, "wide": 0, "splat": 0}
    for variant, ckpt, setting, dtypes in (
        ("base", "atm-vfi-base.pt", "On", ("float32", "bfloat16")), ("base", "atm-vfi-base.pt", "Off (fastest)", ("float32", "bfloat16")),
        ("lite", "atm-vfi-lite.pt", "On", ("float32", "bfloat16")), ("base", "atm-vfi-base.pt", "On with Ensemble (slowest)", ("float32",)),
    ):
        gm, ens = ATM_VFI.GLOBAL_MOTION_SETTINGS[setting]
        per = {dt: {**atm.warps_per_forward(variant, gm, ens, getattr(torch, dt)), "splat": 0} for dt in dtypes}
        got, psnrs, n_calls = card_vs_cpu(
            f"ATM {variant} {setting}", ATM_VFI, ckpt, atm.init_params(variant, 0), [(2, dtypes, {})], (atm, "make_model_fn"),
            lambda name, dt, per=per: per[str(dt).split(".")[-1]], global_motion=setting,
        )
        atm_launches = {k: atm_launches[k] + got[k] for k in got}
        print(
            f"atm: ATM {variant} global motion {setting!r} node 4x{NODE_HW[0]}x{NODE_HW[1]} (edge-padded to 192x256 per "
            f"call, centred) x2 batch 2, cuda vs cpu fp32: {', '.join(psnrs)}; {n_calls} model calls, launches {got}, per forward "
            f"{per}",
            flush=True,
        )
    print(f"atm: {node_golden('atm', ATM_VFI, 'atm-vfi-base.pt', lambda seed: atm.init_params('base', seed), global_motion='On')}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 37. ATM timing, and the attention's share ---------------------------
    clock("37")
    atm_fps, atm_profile = timed_row("ATM base 1080p (padded to 1088x1920) 2x bf16 b1, global motion", atm_bf16, af, 1)
    spans = {}
    targets = [
        (atm, "_mha", "attention (scores, mask, softmax, value product)"),
        (atm, "_window_partition", "window partition"),
        (atm, "_window_reverse", "windows back (reverse)"),
        (atm.AttentionToMotion, "forward", "attention to motion (q, kv, proj, motion readout, with its attention)"),
        (atm.ATMFormer, "forward", "ATMFormer blocks"),
        (atm.RefineBottleneck, "forward", "RefineBottleneck blocks"),
    ]
    with cuda_spans(targets, spans):
        atm_bf16(*af)
    torch.cuda.synchronize()
    fwd_ms = 1e3 / atm_fps
    print(
        f"timing {card}: ATM base 1080p bf16 attention, CUDA-event spans of one forward: "
        + "; ".join(f"{label} {ms:.3f} ms in {n} calls ({100 * ms / fwd_ms:.1f} % of the forward)" for label, (n, ms) in span_ms(spans).items()),
        flush=True,
    )
    del atm_bf16, af, spans

    # ---- 38. XVFI node end to end, and the golden -----------------------------
    clock("38")
    t0 = time.perf_counter()
    xvfi_launches = {"narrow": 0, "wide": 0, "splat": 0}
    for ckpt, mults, pad in (("XVFInet_Vimeo_exp1_latest.pt", (2, 3), "144x240"), (X4K, (2,), "512x512")):
        def want(name, dt, ckpt=ckpt):
            if name == "reuse":
                return {**xvfi.warps_per_reuse(ckpt, dt), "splat": 0}
            return {**xvfi.warps_per_infer(dt), "splat": xvfi.splats_per_infer()}

        got, psnrs, n_calls = card_vs_cpu(
            f"XVFI {ckpt}", XVFI_VFI, ckpt, xvfi.init_params(ckpt, 0), [(m, ("float32", "bfloat16"), {}) for m in mults],
            (xvfi, "make_pair_fns"), want,
        )
        xvfi_launches = {k: xvfi_launches[k] + got[k] for k in got}
        print(
            f"xvfi: XVFI {ckpt} node 4x{NODE_HW[0]}x{NODE_HW[1]} (zero-padded to {pad}) batch 2, cuda vs cpu fp32: "
            f"{', '.join(psnrs)}; {n_calls} reuse and infer calls, launches {got}, per reuse "
            f"{xvfi.warps_per_reuse(ckpt)}, per infer {xvfi.warps_per_infer()} and {xvfi.splats_per_infer()} splat",
            flush=True,
        )
    print(f"xvfi: {node_golden('xvfi', XVFI_VFI, 'XVFInet_Vimeo_exp1_latest.pt', lambda seed: xvfi.init_params('XVFInet_Vimeo_exp1_latest.pt', seed))}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 39. XVFI timing, and X4K's kernels at 1080p --------------------------
    clock("39")
    def xvfi_fwd(f0, f1, t):
        return xvfi_infer(f0, f1, xvfi_reuse(f0, f1), t)

    _, xvfi_profile = timed_row(
        "XVFI Vimeo 1080p (padded to 1088x1920) 2x bf16 b2 through make_pair_fns, reuse + infer", xvfi_fwd, xf, 2
    )
    xcache = xvfi_reuse(xf[0], xf[1])
    reuse_ms = 1e3 * measure(xvfi_reuse, xf[0], xf[1], iters=3, rounds=3)
    infer_ms = 1e3 * measure(xvfi_infer, xf[0], xf[1], xcache, xf[2], iters=3, rounds=3)
    print(f"timing {card}: XVFI Vimeo 1080p bf16 b2: reuse {reuse_ms:.3f} ms, infer {infer_ms:.3f} ms per call", flush=True)
    del xvfi_reuse, xvfi_infer, xcache
    # X4K, the node's default checkpoint: one forward's launches counted from
    # 0 just before it and read just after, then each of its warps and its
    # splat launched again on copies of their inputs against the twins
    x4k_fn = xvfi.make_model_fn(xvfi.init_params(X4K, 0), X4K, torch.bfloat16, dev)
    x_store, x_splats = [], []
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    with captured_warps(x_store), captured_splats(x_splats):
        x4k_fn(*xf)
    torch.cuda.synchronize()
    x4k_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
    want_x4k = {k: v + xvfi.warps_per_infer()[k] for k, v in xvfi.warps_per_reuse(X4K).items()}
    want_x4k["splat"] = xvfi.splats_per_infer()
    check(x4k_launches == want_x4k, f"XVFI X4K 1080p forward launched {x4k_launches}, expected {want_x4k}")
    x4k_seen = warps_vs_plain(x_store, "XVFI X4K 1080p forward")
    levels = [(X4K_HW[0] // 4 >> i, X4K_HW[1] // 4 >> i) for i in range(5)]  # level 0 at 1/4, then the flow levels to 24x32
    want_seen = {
        "warp_bilinear_wide": {((2, h, w, 64), "zeros", "bfloat16", "float32") for h, w in levels},
        "warp_bilinear": {((2, h, w, 1), "zeros", "float32", "float32") for h, w in levels + [X4K_HW]}
        | {((2, *X4K_HW, 3), "zeros", "bfloat16", "float32")},
    }
    check(x4k_seen == want_seen, f"XVFI X4K warps at {x4k_seen}, expected {want_seen}")
    check([tuple(v.shape) for v, _ in x_splats] == [X4K_SPLAT_SHAPE] and x_splats[0][0].dtype == torch.float32,
          f"XVFI X4K splats {[(tuple(v.shape), v.dtype) for v, _ in x_splats]}")
    x4k_splat_errs = {
        "captured f32": splat_vs_plain(*x_splats[0], f32_scaled=True),
        "captured as bf16": splat_vs_plain(x_splats[0][0].bfloat16(), x_splats[0][1]),
    }
    print(
        f"xvfi: one XVFI X4K 1080p (padded to {X4K_HW[0]}x{X4K_HW[1]}) bf16 b2 forward: launches {x4k_launches}; its "
        f"{len(x_store)} warps at {sum(len(v) for v in x4k_seen.values())} shapes launched again, each bit-exact against the "
        f"plain twin; K2 at its CFR splat {list(X4K_SPLAT_SHAPE)}: " + ", ".join(f"{k} max err {v}" for k, v in x4k_splat_errs.items()),
        flush=True,
    )
    del x_store, x_splats
    timed_row(f"XVFI X4K 1080p (padded to {X4K_HW[0]}x{X4K_HW[1]}) 2x bf16 b2", x4k_fn, xf, 2, profile=False)
    del x4k_fn, xf

    # ---- 40. CAIN node end to end, and the golden ------------------------------
    clock("40")
    t0 = time.perf_counter()
    cain_launches, psnrs, n_calls = card_vs_cpu(
        "CAIN", CAIN_VFI, "pretrained_cain.pth", cain.init_params(0), [(m, ("float32", "bfloat16"), {}) for m in (2, 4)],
        (cain, "make_model_fn"), lambda name, dt: {"narrow": 0, "wide": 0, "splat": 0},
    )
    print(
        f"cain: CAIN node 4x{NODE_HW[0]}x{NODE_HW[1]} (reflect-padded to 256x256, centred) batch 2, cuda vs cpu fp32: "
        f"{', '.join(psnrs)}; {n_calls} model calls, no hand-kernel launch; "
        f"{node_golden('cain', CAIN_VFI, 'pretrained_cain.pth', cain.init_params)}; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 41. CAIN timing --------------------------------------------------------
    clock("41")
    cain_fn = cain.make_model_fn(cain.init_params(0), dtype=torch.bfloat16, device=dev)
    cx = [torch.from_numpy(np.random.default_rng(i).random((4, 1080, 1920, 3), dtype=np.float32)).to(dev) for i in range(2)]
    cx.append(torch.full((4,), 0.5, device=dev))
    timed_row("CAIN 1080p (reflect-padded to 1152x1920) 2x bf16 b4", cain_fn, cx, 4)
    del cain_fn, cx

    # ---- 42. Sepconv node end to end, the golden, and sepconv_func on a 720p band --
    clock("42")
    t0 = time.perf_counter()
    sep_launches, psnrs, n_calls = card_vs_cpu(
        "Sepconv", SepconvVFI, "sepconv.pth", sepconv_conditioned(0), [(m, ("float32", "bfloat16"), {}) for m in (2, 4)],
        (sepconv, "make_model_fn"), lambda name, dt: {"narrow": 0, "wide": 0, "splat": 0},
    )
    print(
        f"sepconv: Sepconv node 4x{NODE_HW[0]}x{NODE_HW[1]} (edge-padded to 136x240) batch 2, conditioned weights, cuda vs "
        f"cpu fp32: {', '.join(psnrs)}; {n_calls} model calls, no hand-kernel launch; "
        f"{node_golden('sepconv', SepconvVFI, 'sepconv.pth', sepconv_conditioned)}; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    # one band of a 720p batch-2 call (the rows ops.sepconv.BAND_ELEMENTS gives
    # it), f32, on the card against the CPU: f32 rounding of sums of 2601
    # products, 1e-6 of the largest sum of the products' magnitudes
    band = max(1, sepconv_op.BAND_ELEMENTS // (2 * 1280 * 4 * 51))
    sx = torch.rand(2, band + 50, 1330, 4, generator=g)
    sv, sh = (torch.randn(2, band, 1280, 51, generator=g) / 51 for _ in range(2))
    sep_cpu = sepconv_func(sx, sv, sh)
    sep_abs = sepconv_func(sx.to(dev), sv.abs().to(dev), sh.abs().to(dev)).max().item()
    sep_card = sepconv_func(sx.to(dev), sv.to(dev), sh.to(dev)).cpu()
    sep_err = (sep_card - sep_cpu).abs().max().item()
    check(sep_err <= 1e-6 * sep_abs, f"sepconv_func on the card vs the cpu at [2, {band}, 1280, 51]: max err {sep_err} > 1e-6 x {sep_abs}")
    print(f"sepconv: sepconv_func on one 720p band ([2, {band + 50}, 1330, 4] f32, K = 51) cuda vs cpu: max abs err {sep_err:.3g} "
          f"(the sums' magnitude {sep_abs:.3g})", flush=True)
    del sx, sv, sh, sep_cpu, sep_card

    # ---- 43. Sepconv timing, and sepconv_func's share ---------------------------
    clock("43")
    sep_fn = sepconv.make_model_fn(sepconv_conditioned(0), dtype=torch.bfloat16, device=dev)
    sx = [torch.from_numpy(np.random.default_rng(i).random((2, 720, 1280, 3), dtype=np.float32)).to(dev) for i in range(2)]
    sx.append(torch.full((2,), 0.5, device=dev))
    sep_fps, _ = timed_row("Sepconv 720p 2x bf16 b2", sep_fn, sx, 2)
    del sep_fn, sx
    # one sepconv_func call of that forward: a frame padded by 25 with its ones
    # channel, bf16 [2, 770, 1330, 4], and two 51-tap fields as NHWC views of
    # channels_last [2, 51, 720, 1280] bf16
    spad = torch.rand(2, 770, 1330, 4, generator=g).to(dev, torch.bfloat16)
    sver, shor = (
        (torch.randn(2, 51, 720, 1280, generator=g) / 51).to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for _ in range(2)
    )
    sep_ms = cuda_ms(lambda: sepconv_func(spad, sver, shor), 3)
    sep_dev = device_ms(lambda: sepconv_func(spad, sver, shor), 2)
    # bytes: the input, both fields and the output once; operations: per
    # output value 51 rows of 51 products and sums, and each row's weight
    # product and sum (2 * 51 * 52)
    sep_bound = bound(
        sum(t.numel() * t.element_size() for t in (spad, sver, shor)) + 2 * 720 * 1280 * 4 * 2, 2 * 720 * 1280 * 4 * 2 * 51 * 52,
    )
    fwd_ms = 2e3 / sep_fps
    print(
        f"timing {card}: sepconv_func at Sepconv 720p bf16 b2's shapes ([2, 770, 1330, 4], fields [2, 720, 1280, 51]; f32 "
        f"products in bands of {band} rows) {sep_ms:.3f} ms per call ({sep_dev:.3f} ms on the device); bound {sep_bound[0]:.4f} ms "
        f"({sep_bound[1]}), {sep_dev / sep_bound[0]:.1f}x it; 2 per forward: {2 * sep_ms:.3f} ms, {100 * 2 * sep_ms / fwd_ms:.1f} % of "
        f"the {fwd_ms:.3f} ms forward",
        flush=True,
    )
    del spad, sver, shor

    # ---- 44. the streaming executors against the resident ones -----------------------
    clock("44")
    def executor_run(run, frames_, *args, **kw):
        """``run(frames_, *args, **kw)`` with the launch counts from 0 just
        before it and read just after, and its peak device memory above what
        was held before it: ``(result on the host, launches, peak bytes)``."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
        out = run(frames_, *args, **kw)
        torch.cuda.synchronize()
        got = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}
        peak = torch.cuda.max_memory_allocated() - base
        return out.cpu(), got, peak

    t0 = time.perf_counter()
    stream_rows = {}
    # RIFE 4.7 (bf16, fast mode) through run_plan: x4, 24 frames of 1080p, b8
    rife_fn = rife.make_model_fn(rife.init_params(0, "4.7"), "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev)
    rclip = torch.from_numpy(shifted_pattern(24, 1080, 1920, seed=12)).to(dev)
    rplan = plan_timestep(24, 4)
    budget = 16 * 1080 * 1920 * 3 * 4  # 16 frames: far under the 24 + 93 + 32 frames the resident estimate counts
    r_res, r_res_n, r_res_peak = executor_run(run_plan, rclip, rplan, rife_fn, batch_size=8)
    r_str, r_str_n, r_str_peak = executor_run(run_plan, rclip, rplan, rife_fn, batch_size=8, memory_budget_bytes=budget)
    r_host, r_host_n, r_host_peak = executor_run(run_plan, rclip.cpu(), rplan, rife_fn, batch_size=8, memory_budget_bytes=budget)
    check(r_str.device.type == "cpu" and tuple(r_str.shape) == (93, 1080, 1920, 3), f"RIFE streamed {tuple(r_str.shape)}")
    check(torch.equal(r_str, r_res) and torch.equal(r_host, r_res), "RIFE run_plan streamed != resident, not bit for bit")
    check(r_str_n == r_res_n == r_host_n, f"RIFE launches streamed {r_str_n}, from a host clip {r_host_n}, resident {r_res_n}")
    check(r_str_peak < r_res_peak and r_host_peak < r_res_peak, f"RIFE peak memory streamed {r_str_peak} / {r_host_peak}, resident {r_res_peak}")
    stream_rows["rife"] = (r_res_peak, r_str_peak, r_str_n, "bit for bit")
    rife_stream_launches = r_str_n
    print(f"streaming: RIFE 4.7 run_plan x4 24x1080x1920 b8 bf16, the clip on the host: bit for bit, peak "
          f"{r_host_peak / 2**30:.3f} GiB, launches {r_host_n}", flush=True)
    del rife_fn, rclip, r_res, r_str, r_host
    # M2M (fp32) through run_plan_pair_cached: x3, 8 frames of 540x960, b2;
    # the splat sums with float atomics, so five resident runs give the spread
    # (the streamed run, a sixth draw of the sums' order, fails only if it lies
    # farther from all five than any two of them lie apart)
    reuse_fn, infer_fn = m2m.make_pair_fns(m2m.init_params(0), dtype=torch.float32, device=dev)
    mclip = torch.from_numpy(shifted_pattern(8, *M2M_HW, seed=13)).to(dev)
    mplan = plan_timestep(8, 3)
    budget = 8 * M2M_HW[0] * M2M_HW[1] * 3 * 4
    m_res = [executor_run(run_plan_pair_cached, mclip, mplan, reuse_fn, infer_fn, batch_size=2) for _ in range(5)]
    m_str, m_str_n, m_str_peak = executor_run(
        run_plan_pair_cached, mclip, mplan, reuse_fn, infer_fn, batch_size=2, memory_budget_bytes=budget
    )
    spread = max((a[0] - b[0]).abs().max().item() for i, a in enumerate(m_res) for b in m_res[i + 1 :])
    m_err = min((m_str - r[0]).abs().max().item() for r in m_res)
    check(m_str.device.type == "cpu" and tuple(m_str.shape) == (22, *M2M_HW, 3), f"M2M streamed {tuple(m_str.shape)}")
    check(torch.equal(m_str[::3], mclip.cpu()), "M2M streamed: original frames not passed through")
    check(m_err <= spread, f"M2M streamed vs resident max err {m_err} above the resident runs' spread {spread}")
    check(all(r[1] == m_str_n for r in m_res), f"M2M launches streamed {m_str_n}, resident {[r[1] for r in m_res]}")
    check(m_str_peak < min(r[2] for r in m_res), f"M2M peak memory streamed {m_str_peak}, resident {[r[2] for r in m_res]}")
    stream_rows["m2m"] = (m_res[0][2], m_str_peak, m_str_n, f"max err {m_err:.3g} against the nearest resident run; "
                          f"five resident runs differ by up to {spread:.3g}")
    m2m_stream_launches = m_str_n
    del reuse_fn, infer_fn, mclip, m_res, m_str
    # FLAVR (bf16) through run_plan_window4: 10 frames of 540x960 (edge-padded
    # to 544x960, as the node pads), b2
    flavr_fn2 = flavr.make_model_fn(flavr.init_params(0), dtype=torch.bfloat16, device=dev)
    fclip, _ = _pad16(torch.from_numpy(shifted_pattern(10, *M2M_HW, seed=14)).to(dev))
    fplan = plan_window4(10)
    budget = 8 * 544 * 960 * 3 * 4
    f_res, f_res_n, f_res_peak = executor_run(run_plan_window4, fclip, fplan, flavr_fn2, batch_size=2)
    f_str, f_str_n, f_str_peak = executor_run(run_plan_window4, fclip, fplan, flavr_fn2, batch_size=2, memory_budget_bytes=budget)
    check(f_str.device.type == "cpu" and tuple(f_str.shape) == (len(fplan.output), 544, 960, 3), f"FLAVR streamed {tuple(f_str.shape)}")
    check(torch.equal(f_str, f_res), "FLAVR run_plan_window4 streamed != resident, not bit for bit")
    check(f_str_n == f_res_n == {"narrow": 0, "wide": 0, "splat": 0}, f"FLAVR launches streamed {f_str_n}, resident {f_res_n}")
    check(f_str_peak < f_res_peak, f"FLAVR peak memory streamed {f_str_peak}, resident {f_res_peak}")
    stream_rows["flavr"] = (f_res_peak, f_str_peak, f_str_n, "bit for bit")
    del flavr_fn2, fclip, f_res, f_str
    for path, (res_peak, str_peak, n, same) in stream_rows.items():
        print(
            f"streaming {card}: {path} streamed vs resident: {same}; peak device memory {str_peak / 2**30:.3f} GiB streamed, "
            f"{res_peak / 2**30:.3f} GiB resident; launches {n} in both",
            flush=True,
        )
    print(f"streaming: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 45. MoMo: apply card against CPU, the node, the golden ----------------------
    clock("45")
    t0 = time.perf_counter()

    def hand_launches():
        return {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches, "splat": softsplat_kernel.launches}

    def momo_apply(sd, ckpt, f0, f1, noises, dtype, device):
        """``momo.apply`` on NHWC numpy frames and NHWC numpy noise (the
        initial latent, then one per step), f32 NHWC on the host."""
        net = momo._load(sd, ckpt, dtype, device)
        nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(device).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            out = momo.apply(net, nchw(f0).to(dtype), nchw(f1).to(dtype), len(noises) - 1,
                             init_latents=nchw(noises[0]), step_noises=[nchw(n) for n in noises[1:]])
        return out.permute(0, 2, 3, 1).cpu()

    momo_sd = momo.init_params(0, "momo-base.pth")
    # the same weights with the latent head and the mask head scaled down: no prediction clips
    momo_csd = momo_conditioned(momo_sd)
    mrng = np.random.default_rng(45)
    mf0, mf1 = (mrng.random((1, 192, 256, 3), dtype=np.float32) for _ in range(2))
    mnoise = [mrng.standard_normal((1, 192, 256, 4)).astype(np.float32) for _ in range(9)]
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    m_card32 = momo_apply(momo_sd, "momo-base.pth", mf0, mf1, mnoise, torch.float32, dev)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    m_card16 = momo_apply(momo_csd, "momo-base.pth", mf0, mf1, mnoise, torch.bfloat16, dev)
    m_cpu32 = momo_apply(momo_sd, "momo-base.pth", mf0, mf1, mnoise, torch.float32, "cpu")
    m_ccpu32 = momo_apply(momo_csd, "momo-base.pth", mf0, mf1, mnoise, torch.float32, "cpu")
    p32, p16 = psnr(m_card32, m_cpu32), psnr(m_card16, m_ccpu32)
    check(all(bool(torch.isfinite(o).all()) for o in (m_card32, m_card16)), "MoMo apply on the card: non-finite values")
    check(p32 >= 40.0, f"MoMo base apply cuda fp32 vs cpu fp32 {p32:.2f} dB < 40")
    check(p16 >= 30.0, f"MoMo base apply (conditioned weights) cuda bf16 vs cpu fp32 {p16:.2f} dB < 30")
    # the node: 3 frames, x2, bf16, the same seed twice and another seed
    mframes = shifted_pattern(3, *NODE_HW, seed=45)
    mnode = MOMO_VFI()
    kw = dict(multiplier=2, dtype="bfloat16", params=momo_sd, device="cuda")
    (mo_a,) = mnode.vfi("momo-base.pth", mframes, **kw)
    (mo_b,) = mnode.vfi("momo-base.pth", mframes, **kw)
    (mo_c,) = mnode.vfi("momo-base.pth", mframes, seed=1, **kw)
    torch.cuda.synchronize()
    check(tuple(mo_a.shape) == (5, *NODE_HW, 3) and mo_a.is_cuda and bool(torch.isfinite(mo_a).all()), f"MoMo node output {tuple(mo_a.shape)}")
    check(torch.equal(mo_a[::2].cpu(), torch.from_numpy(mframes)), "MoMo node: original frames not passed through")
    check(torch.equal(mo_a, mo_b), "MoMo node: the same seed gave other frames")
    check(not torch.equal(mo_a[1::2], mo_c[1::2]), "MoMo node: another seed gave the same frames")
    check(len(mnode._model_fns) == 2, f"MoMo node built {len(mnode._model_fns)} models for two seeds")
    # the JAX golden: lite, 3 steps, the noise from its seed
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_momo_golden.npz")) as z:
        gseed, gnseed, gframes, golden = int(z["seed"]), int(z["noise_seed"]), z["frames"][:, 0].astype(np.float32) / 255.0, z["output"]
    grng = np.random.default_rng(gnseed)
    _ = [grng.random((1, 128, 128, 3), dtype=np.float32) for _ in range(2)]  # the test's draw order: two frames, then the noise
    gnoise = [grng.standard_normal((1, 128, 128, 4)).astype(np.float32) for _ in range(4)]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gout = momo_apply(momo.init_params(gseed, "momo-lite.pth"), "momo-lite.pth", gframes[0:1], gframes[1:2], gnoise, torch.float32, dev)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, torch.from_numpy(golden))
    check(pg >= 40.0, f"MoMo golden through apply on the card: {pg:.2f} dB < 40")
    momo_launches = hand_launches()
    check(momo_launches == {"narrow": 0, "wide": 0, "splat": 0}, f"MoMo launched hand kernels: {momo_launches}")
    print(
        f"momo {card}: MoMo base apply 192x256, 8 steps, injected noise: cuda fp32 vs cpu fp32 {p32:.2f} dB; conditioned "
        f"weights: cuda bf16 vs cpu fp32 {p16:.2f} dB; node "
        f"3x{NODE_HW[0]}x{NODE_HW[1]} (edge-padded to 192x256) x2 bf16: originals bit for bit, seed 0 twice equal, seed 1 other "
        f"frames; golden (lite, 3 steps) through apply on cuda fp32 vs JAX fp32 {pg:.2f} dB, max abs err "
        f"{(gout - torch.from_numpy(golden)).abs().max().item():.3g}; hand-kernel launches {momo_launches}; phase "
        f"{time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    del m_card32, m_card16, m_cpu32, m_ccpu32, momo_csd, mnode, mo_a, mo_b, mo_c

    # ---- 46. MoMo timing, the denoiser against the synthesis ----------------------
    clock("46")
    momo_bf16 = momo.make_model_fn(momo_sd, "momo-base.pth", 8, 0, torch.bfloat16, dev)
    mx = [torch.from_numpy(np.random.default_rng(i).random((1, 1080, 1920, 3), dtype=np.float32)).to(dev) for i in range(2)]
    mx.append(torch.full((1,), 0.5, device=dev))
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    momo_fps, _ = timed_row("MoMo base 1080p (padded to 1088x1920) 2x bf16 b1, 8 steps", momo_bf16, mx, 1)
    torch.cuda.synchronize()
    check(hand_launches() == {"narrow": 0, "wide": 0, "splat": 0}, f"MoMo 1080p launched hand kernels: {hand_launches()}")
    spans = {}
    with cuda_spans([(momo.ConvexUpUNet, "denoise", "denoiser passes"), (momo, "_synthesize", "synthesis")], spans):
        momo_bf16(*mx)
    torch.cuda.synchronize()
    fwd_ms = 1e3 / momo_fps
    print(
        f"timing {card}: MoMo base 1080p bf16 b1, CUDA-event spans of one forward: "
        + "; ".join(f"{label} {ms:.3f} ms in {n} calls ({100 * ms / fwd_ms:.1f} % of the forward)" for label, (n, ms) in span_ms(spans).items()),
        flush=True,
    )
    del momo_bf16, mx, spans, momo_sd

    # ---- 47. the utilities: the profiler hook, a node from an .npz ----------------
    clock("47")
    t0 = time.perf_counter()
    rife_sd = rife.init_params(0, "4.7")
    rife16 = rife.make_model_fn(rife_sd, "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev)
    pclip = torch.from_numpy(shifted_pattern(3, 540, 960, seed=47)).to(dev)
    env = {k: os.environ.get(k) for k in ("CFI_PROFILE",)}
    cfg = load_config()
    old_ckpts = cfg["ckpts_path"]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CFI_PROFILE"] = os.path.join(tmp, "prof")
        try:
            warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
            run_plan(pclip, plan_timestep(3, 2), rife16, batch_size=2)
            prof_launches = hand_launches()
            del os.environ["CFI_PROFILE"]
            traces = os.listdir(os.path.join(tmp, "prof", "run_plan"))
            check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"), f"CFI_PROFILE wrote {traces}")
            with open(os.path.join(tmp, "prof", "run_plan", traces[0])) as f:
                events = json.load(f)["traceEvents"]
            kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
            check(any("warp_bilinear_tiled_kernel" in k for k in kernels), f"the run_plan trace names no K1 kernel: {kernels[:8]}")
            # the RIFE node from rife47.pth.npz in a temporary ckpts_path
            cfg["ckpts_path"] = os.path.join(tmp, "ckpts")
            save_npz(rife_sd, os.path.join(tmp, "ckpts", "rife", "rife47.pth.npz"))
            rnode = RIFE_VFI()
            rframes = shifted_pattern(3, 270, 480, seed=48)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
            outs = [rnode.vfi("rife47.pth", rframes, multiplier=2, fast_mode=True, device="cuda")[0] for _ in range(2)]
            npz_launches = hand_launches()
            (ref,) = RIFE_VFI().vfi("rife47.pth", rframes, multiplier=2, fast_mode=True, params=rife_sd, device="cuda")
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        finally:
            cfg["ckpts_path"] = old_ckpts
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(len(rnode._model_fns) == 1, f"the RIFE node built {len(rnode._model_fns)} models over two calls from the .npz")
    loaded = next(iter(rnode._model_fns.values()))[0]
    check(loaded.keys() == rife_sd.keys() and all(torch.equal(loaded[k], v) for k, v in rife_sd.items()),
          "the weights loaded from rife47.pth.npz differ from the ones saved")
    # another model object, so cuDNN may pick other algorithms: held by PSNR, not bit for bit
    npz_psnr = [psnr(o, ref) for o in outs]
    check(min(npz_psnr) >= 60.0, f"the RIFE node from the .npz vs the same weights as params: {npz_psnr} dB < 60")
    check(npz_launches == {"narrow": 16, "wide": 0, "splat": 0}, f"the RIFE node's two calls launched {npz_launches}")  # 2 x 2 forwards x 4
    print(
        f"utilities: run_plan (RIFE 4.7 bf16, 3x540x960 x2) under CFI_PROFILE wrote {traces[0]} with {len(events)} events, "
        f"{len(kernels)} kernel names (K1 among them), launches {prof_launches}; the RIFE node from rife47.pth.npz: one model over "
        f"two calls, the saved weights bit for bit, fp32 output vs the params run {min(npz_psnr):.2f} dB, launches {npz_launches}; "
        f"phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    del rife16, pclip, rnode, outs, ref

    # ---- 48. the warp's backward kernel against its plain version -----------------
    clock("48")
    t0 = time.perf_counter()
    bwd_errs, n_bwd = {}, 0

    def worst(key, errs):
        bwd_errs[key] = tuple(max(a, b) for a, b in zip(bwd_errs.get(key, (0.0, 0.0)), errs))

    for case in warp_cases.warp_cases(0, 256, 512):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)
                errs = backward_vs_plain(img, torch.from_numpy(case["flow"]).to(dev), mode, case["name"])
                worst(f"flow cases {str(dtype).split('.')[-1]}", errs)
                n_bwd += 1
    bflow = torch.from_numpy(warp_cases.bound_flow(2, 256, 512)).to(dev)
    for mode in ("border", "zeros"):
        for dtype in (torch.float32, torch.bfloat16):
            img = torch.rand(2, 256, 512, 7, generator=g).to(dev, dtype)
            worst(f"exact bounds {str(dtype).split('.')[-1]}", backward_vs_plain(img, bflow, mode, "exact bounds"))
            n_bwd += 1
    # what the merges of neighbouring taps and the padded channels could
    # break: C = 1-40, ragged tiles, constant offsets (every neighbour
    # merges), rough flow (few do), a pile of 256 samples on each tap; each
    # also without the image's gradient (the flow's bit for bit the same)
    for case in warp_cases.backward_cases(0, 256, 512):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)
                bflow = torch.from_numpy(case["flow"]).to(dev)
                gout = (torch.rand(img.shape, generator=g) * 2 - 1).to(dev, dtype)
                worst(f"backward cases {str(dtype).split('.')[-1]}", backward_vs_plain(img, bflow, mode, case["name"], grad_out=gout))
                args = img.permute(0, 3, 1, 2), bflow.permute(0, 3, 1, 2), gout.permute(0, 3, 1, 2), mode == "zeros"
                gi_none, gf_alone = warp_kernel.warp_bilinear_backward(*args, img_grad=False)
                check(gi_none is None and torch.equal(gf_alone, warp_kernel.warp_bilinear_backward(*args)[1]),
                      f"backward {case['name']} {mode} {dtype}: the flow's gradient without the image's differs")
                n_bwd += 2
    # layouts: NCHW planes, a channel slice with an odd start, an expanded
    # output gradient (the vector widths each allows)
    for c in (7, 8):
        for dtype in (torch.float32, torch.bfloat16):
            img = torch.rand(2, 256, 512, c, generator=g).to(dev, dtype)
            lflow = torch.from_numpy(warp_cases.smooth_flow(2, 256, 512, 6.0)).to(dev)
            gout = (torch.rand(img.shape, generator=g) * 2 - 1).to(dev, dtype)
            sliced = torch.zeros(2, 256, 512, c + 1, dtype=dtype, device=dev)
            sliced[..., 1:] = img
            layouts = {
                "nchw planes": (img.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), gout.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)),
                "odd channel slice": (sliced[..., 1:], gout),
                "expanded grad_out": (img, gout[:1, :1, :1].expand(img.shape)),
            }
            for what, (limg, lgout) in layouts.items():
                for mode in ("border", "zeros"):
                    worst(f"layouts {str(dtype).split('.')[-1]}", backward_vs_plain(limg, lflow, mode, f"{what} C = {c}", grad_out=lgout))
                    n_bwd += 1
    for case in warp_cases.wide_cases(0, 128, 256, channels=(16, 32, 64, 192, 384)):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)[..., case["offset"] :]  # channels_last views
                errs = backward_vs_plain(img, torch.from_numpy(case["flow"]).to(dev), mode, case["name"])
                worst(f"wide views {str(dtype).split('.')[-1]}", errs)
                n_bwd += 1
    # the backward inputs of one training step at phase 50's size, as the
    # step hands them to the kernel (strided views, autograd's gradients)
    captured_bwd = []

    def capture_backward(img, flow, grad_out, zeros=False, *rest):
        captured_bwd.append((img.clone(), flow.clone(), grad_out.clone(), zeros))

    _, cstep = rife_trainer(dev, torch.float32)
    with spying([(warp_kernel, "warp_bilinear_backward", capture_backward)]):
        cstep(*train_batch(TRAIN_BATCH, TRAIN_HW, 48, dev, torch.float32))
    torch.cuda.synchronize()
    check(len(captured_bwd) == 4, f"one training step made {len(captured_bwd)} backward launches, expected 4")
    step_shapes = set()
    for img, flow, grad_out, zeros in captured_bwd:
        nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
        mode = "zeros" if zeros else "border"
        worst("training step", backward_vs_plain(nhwc(img), nhwc(flow), mode, "training step", grad_out=nhwc(grad_out)))
        step_shapes.add((tuple(nhwc(img).shape), mode))
        n_bwd += 1
    check(step_shapes == {(TRAIN_WARP_SHAPE, "border"), (TRAIN_WARP_SHAPE[:3] + (3,), "border")},
          f"the training step's backward shapes {sorted(step_shapes)}")
    del captured_bwd, cstep
    bwd_err = max(e for k, v in bwd_errs.items() if "float32" in k or k == "training step" for e in v)
    print(
        f"backward: {n_bwd} runs of the backward kernel against warp_backward_torch (flow cases at 256x512, exact bounds, "
        f"the backward cases (C = 1-40, ragged tiles, constant offsets, rough flow, a pile; each also without the image's "
        f"gradient), NCHW planes, an odd channel slice, an expanded grad_out, wide C = 16-384 as channels_last views, the "
        f"training step's {sorted(step_shapes)}), all within tolerance; max abs "
        f"err (grad_img, grad_flow): " + ", ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in bwd_errs.items())
        + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 49. a RIFE 4.7 training step, card against CPU ---------------------------
    clock("49")
    t0 = time.perf_counter()
    warp_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")  # ops.warp is also a function's name
    real_twin = warp_mod.warp_torch

    def guarded_twin(img, flow, padding_mode="border", row0=0):
        check(not (img.is_cuda and torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad)),
              "a CUDA warp that needs a gradient reached the plain twin")
        return real_twin(img, flow, padding_mode, row0)

    batch49 = train_batch(2, TRAIN_CHECK_HW, 49, "cpu", torch.float32)
    trained = {}

    def train_once(d, twin=False):
        """One step on ``d``: ``(loss, grads, updates)`` on the host. With
        ``twin``, RIFE's warps call the plain twin directly (autograd through
        it), the reference for the kernels on the same card."""
        real_warp = rife.warp
        if twin:
            rife.warp = lambda img, flow, padding_mode="border", prefer_wide=False: real_twin(img, flow, padding_mode)
        try:
            net, step = rife_trainer(d, torch.float32)
            before = {k: v.detach().clone() for k, v in net.named_parameters()}
            loss = step(*(x.to(d) for x in batch49)).item()
        finally:
            rife.warp = real_warp
        return (loss, {k: v.grad.cpu() for k, v in net.named_parameters()},
                {k: (v.detach() - before[k]).cpu() for k, v in net.named_parameters()})

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's default backward-weight algorithms sum in an order that changes
    # from run to run (two runs of one step differ by up to 2.1 % of a
    # tensor's largest gradient where its sums cancel): the two card runs
    # that isolate the kernels take deterministic ones
    torch.backends.cudnn.deterministic = True
    try:
        trained["twin"] = train_once("cuda", twin=True)
        torch.cuda.synchronize()
        warp_mod.warp_torch = guarded_twin
        warp_kernel.launches = warp_kernel.wide_launches = warp_kernel.backward_launches = softsplat_kernel.launches = 0
        softsplat_kernel.backward_launches = 0
        trained["cuda"] = train_once("cuda")
        torch.cuda.synchronize()
        train_launches = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches,
                          "backward": warp_kernel.backward_launches, "splat": softsplat_kernel.launches,
                          "splat_backward": softsplat_kernel.backward_launches}
        trained["cpu"] = train_once("cpu")
        # the card's own spread: two more runs with cuDNN's default algorithms
        torch.backends.cudnn.deterministic = det
        spread_runs = [train_once("cuda")[1] for _ in range(2)]
    finally:
        warp_mod.warp_torch = real_twin
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(train_launches == {"narrow": 4, "wide": 0, "backward": 4, "splat": 0, "splat_backward": 0},
          f"one RIFE 4.7 training step launched {train_launches}, expected K1 4 and the backward kernel 4")
    (loss_gpu, grads_gpu, deltas_gpu), (loss_cpu, grads_cpu, deltas_cpu) = trained["cuda"], trained["cpu"]
    loss_twin, grads_twin, _ = trained["twin"]

    def grad_errs(got, ref):
        """The largest error of each tensor over its largest magnitude, and the
        largest error over the largest gradient of all."""
        top = max(v.abs().max().item() for v in ref.values())
        rel = {k: (got[k] - ref[k]).abs().max().item() / max(ref[k].abs().max().item(), 1e-30) for k in ref}
        return max(rel.values()), max(rel, key=rel.get), max((got[k] - ref[k]).abs().max().item() for k in ref) / top

    # the kernels against the plain twin inside one step on the card: the
    # forward kernels are bit for bit, the backward sums in another order
    kt_rel, kt_worst, kt_glob = grad_errs(grads_gpu, grads_twin)
    check(loss_gpu == loss_twin, f"training step loss with the kernels {loss_gpu} vs through the twin {loss_twin} on the card")
    check(kt_rel <= 1e-4, f"training step gradients, kernels vs twin on the card: {kt_rel:.3g} of {kt_worst}'s largest, above 1e-4")
    # card against CPU: cuDNN's and oneDNN's sums (forward values ~1e-7
    # apart), and the warps' gradient in the flow, which jumps where a sample
    # crosses a pixel, leave gradients whose sums cancel apart by a share of
    # their tensor's largest: 1.78e-2 (block1.convblock.4.beta), and 1.72e-3
    # of the largest of all, in each of three runs (the card's deterministic
    # algorithms against oneDNN's). So: each tensor within 5e-2 of its
    # largest, every error within 5e-3 of the largest gradient of all. Two
    # card runs with cuDNN's default algorithms differ from each other by
    # 1.66e-2 to 5.42e-2 and 1.7e-3 to 7.5e-3 (printed below)
    cc_rel, cc_worst, cc_glob = grad_errs(grads_gpu, grads_cpu)
    sp_rel, sp_worst, sp_glob = grad_errs(spread_runs[0], spread_runs[1])
    check(math.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu),
          f"training step loss card {loss_gpu} vs CPU {loss_cpu}")
    check(cc_rel <= 5e-2 and cc_glob <= 5e-3,
          f"training step gradients card vs CPU: {cc_rel:.3g} of {cc_worst}'s largest (at most 5e-2), {cc_glob:.3g} of the "
          f"largest of all (at most 5e-3)")
    # Adam's first step is about -lr * sign(g): held where |g| is over 10x that tolerance
    upd_err, n_upd = 0.0, 0
    for k, gk in grads_cpu.items():
        big = gk.abs() > 0.5 * gk.abs().max()
        n_upd += int(big.sum())
        upd_err = max(upd_err, (deltas_gpu[k][big] - deltas_cpu[k][big]).abs().max().item())
    check(upd_err <= 1e-3 * 1e-4 + 2.0**-23, f"training step updates card vs CPU: max err {upd_err:.3g}")
    print(
        f"train: RIFE 4.7 make_train_step (L1, Adam 1e-4) b2x{TRAIN_CHECK_HW[0]}x{TRAIN_CHECK_HW[1]} f32, TF32 off: kernels vs "
        f"the plain twin on the card: loss equal, gradients within {kt_rel:.3g} of each tensor's largest ({kt_worst}); card vs "
        f"CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f}, gradients within {cc_rel:.3g} of each tensor's largest ({cc_worst}) and "
        f"{cc_glob:.3g} of the largest of all (two card runs with cuDNN's default algorithms: {sp_rel:.3g} ({sp_worst}) and "
        f"{sp_glob:.3g}), the {n_upd} updates where |g| > 0.5 of its tensor's largest within {upd_err:.3g}; "
        f"launches {train_launches} (K1 4, backward 4, through WarpFunction; no CUDA warp reached the twin); "
        f"phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    del trained, grads_gpu, grads_cpu, grads_twin, deltas_gpu, deltas_cpu, spread_runs

    # ---- 50. training timing ------------------------------------------------------
    clock("50")
    t0 = time.perf_counter()
    # one window of 20 steps lasted under a second and two windows on this
    # shared host have read 23 and 42 steps/s: so several windows, f32 and
    # bf16 in turns, reported by their median and spread
    trainers = {}
    for dtype in (torch.float32, torch.bfloat16):
        net, step = rife_trainer(dev, dtype)
        trainers[str(dtype).split(".")[-1]] = (dtype, step, train_batch(TRAIN_BATCH, TRAIN_HW, 50, dev, dtype))
        del net
    for _, step, batch50 in trainers.values():
        for _ in range(3):
            step(*batch50)
    torch.cuda.synchronize()
    n_steps, n_windows = 10, TIMING_WINDOWS
    windows = {name: [] for name in trainers}
    for i in range(n_windows):
        for name in (list(trainers) if i % 2 == 0 else list(trainers)[::-1]):
            _, step, batch50 = trainers[name]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n_steps):
                loss = step(*batch50)
            torch.cuda.synchronize()
            windows[name].append(1e3 * (time.perf_counter() - t1) / n_steps)
            check(bool(torch.isfinite(loss)), f"training step {name}: loss {loss}")
    train_rows = {}
    for name, (dtype, step, batch50) in trainers.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(*batch50)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms_step = statistics.median(windows[name])
        train_rows[name] = {
            "steps_per_s": 1e3 / ms_step, "samples_per_s": 1e3 * TRAIN_BATCH / ms_step, "ms_per_step": ms_step,
            "ms_per_step_windows": windows[name], "peak_bytes": peak,
        }
        print(
            f"timing {card}: RIFE 4.7 training b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]} (padded to 256x256) {name}, Adam 1e-4: "
            f"{1e3 / ms_step:.3f} steps/s, {1e3 * TRAIN_BATCH / ms_step:.2f} samples/s (median {ms_step:.3f} ms a step over "
            f"{n_windows} windows of {n_steps} steps, in turns with the other dtype; windows "
            f"{min(windows[name]):.3f} to {max(windows[name]):.3f} ms), peak {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB held",
            flush=True,
        )
    (f_lo, f_hi), (b_lo, b_hi) = ((min(windows[k]), max(windows[k])) for k in ("float32", "bfloat16"))
    gap = abs(train_rows["float32"]["ms_per_step"] - train_rows["bfloat16"]["ms_per_step"])
    spread = max(f_hi - f_lo, b_hi - b_lo)
    print(
        f"timing {card}: RIFE 4.7 training, bf16 against f32: medians {gap:.3f} ms a step apart, the windows of one dtype "
        f"spread by up to {spread:.3f} ms: " + ("resolved" if spread < gap else "unresolved (the spread exceeds the difference)"),
        flush=True,
    )
    _, step, batch50 = trainers["float32"]
    train_profile = profile_forward(
        f"RIFE 4.7 training step b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]} f32 (TF32 at its defaults)", step, *batch50,
        card=card, unit="step",
    )
    del trainers, step, batch50
    bwd_times = {}
    # the step's warps (f32 and bf16; the fourth, of the frames, without the
    # image's gradient) and a batch-8 1080p RIFE warp; the flow in the
    # image's dtype, as the training steps give it
    for shape, dtype, img_grad in (
        (TRAIN_WARP_SHAPE, torch.float32, True), (TRAIN_WARP_SHAPE, torch.bfloat16, True),
        (TRAIN_WARP_SHAPE[:3] + (3,), torch.float32, False), (MAIN_SHAPE, torch.float32, True),
    ):
        dname = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        bimg = torch.rand(shape, generator=g).to(dev, dtype)
        bflow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev, dtype)
        bgrad = (torch.rand(shape, generator=g) * 2 - 1).to(dev, dtype)
        err = backward_vs_plain(bimg, bflow, "border", "timing shape", grad_out=bgrad)
        args = (bimg.permute(0, 3, 1, 2), bflow.permute(0, 3, 1, 2), bgrad.permute(0, 3, 1, 2), False, img_grad)
        times = in_turns({
            "plain": (lambda: warp_backward_torch(bimg, bflow, bgrad), 3),
            "kernel": (lambda: warp_kernel.warp_bilinear_backward(*args), 20),
            "grid_sampler_2d_backward": (grid_sample_backward_call(bimg, bflow, bgrad, img_grad=img_grad), 10),
        })
        ms = {k: statistics.mean(v) for k, v in times.items()}
        dev_kernel = device_ms(lambda: warp_kernel.warp_bilinear_backward(*args), 20, name="warp_bilinear_backward_kernel")
        b = bound(*backward_work(*args[:2], img_grad=img_grad))
        key = f"{list(shape)} {dname} border" + ("" if img_grad else ", no image gradient")
        bwd_times[key] = {
            "ms": ms["kernel"], "kernel_device_ms": dev_kernel, "plain_ms": ms["plain"],
            "library_ms": ms["grid_sampler_2d_backward"], "bound_ms": b[0], "bound_by": b[1], "max_abs_err": max(err),
        }
        print(
            f"timing {card}: backward {key}, {dname} flow: "
            + ", ".join(f"{k} {ms[k]:.4f} ms {v}" for k, v in times.items())
            + f"; the kernel alone {dev_kernel:.4f} ms on the device; bound {b[0]:.4f} ms ({b[1]}), the op at "
            f"{100 * b[0] / ms['kernel']:.1f} % of it; max abs err (grad_img, grad_flow) {err[0]:.3g}, {err[1]:.3g}",
            flush=True,
        )
        del bimg, bflow, bgrad, args
    bwd_main = bwd_times[f"{list(MAIN_SHAPE)} f32 border"]
    print(f"train timing: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 51. parallel: the mesh, the sharded executors, a sharded step, the dry run --
    clock("51")
    t0 = time.perf_counter()
    from comfyui_frame_interpolation_tpu_torch import parallel
    from comfyui_frame_interpolation_tpu_torch.parallel import train as ptrain

    n_cards = torch.cuda.device_count()
    space = 2 if n_cards % 2 == 0 and n_cards > 1 else 1
    mesh = parallel.make_mesh()
    check(mesh.shape == {"data": n_cards // space, "space": space}, f"make_mesh() on {n_cards} card(s): {mesh.shape}")
    mesh1 = parallel.make_mesh(1)
    # two logical replicas of the card: the batch split, run shard by shard
    # (parameters copied per shard in the step) and gathered, as on two cards
    mesh2 = parallel.make_mesh(2, shape=(2, 1), devices=[dev] * 2)
    check(mesh2.shape == {"data": 2, "space": 1}, f"make_mesh(2, shape=(2, 1)) on one card: {mesh2.shape}")
    rife16 = rife.make_model_fn(rife.init_params(0, "4.7"), "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev)
    pclip = torch.from_numpy(shifted_pattern(4, 540, 960, seed=51)).to(dev)
    pplan = plan_timestep(4, 2)
    ref_out, ref_n, _ = executor_run(run_plan, pclip, pplan, rife16, batch_size=2)
    sh_out, rife_sharded_launches, _ = executor_run(
        run_plan, pclip, pplan, parallel.make_sharded_model_fn(lambda d: rife16, mesh1), batch_size=2
    )
    check(torch.equal(sh_out, ref_out), "make_sharded_model_fn through run_plan on a 1x1 mesh: not bit for bit with the unsharded run")
    check(rife_sharded_launches == ref_n == {"narrow": 4 * 2, "wide": 0, "splat": 0},
          f"sharded RIFE launches {rife_sharded_launches}, unsharded {ref_n}")
    # on the 2-way mesh each shard runs a batch of 1: held bit for bit against
    # the unsharded executor at batch 1, cuDNN's deterministic algorithms in
    # both (the same shapes take the same algorithms)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref1_out, _, _ = executor_run(run_plan, pclip, pplan, rife16, batch_size=1)
        sh2_out, rife_sharded2_launches, _ = executor_run(
            run_plan, pclip, pplan, parallel.make_sharded_model_fn(lambda d: rife16, mesh2), batch_size=2
        )
    finally:
        torch.backends.cudnn.deterministic = det
    rife2_err = (sh2_out - ref_out).abs().max().item()
    check(torch.equal(sh2_out, ref1_out), f"make_sharded_model_fn through run_plan on a 2-way mesh: not bit for bit with the "
          f"unsharded run at batch 1 (max err {(sh2_out - ref1_out).abs().max().item()})")
    check(rife_sharded2_launches == {"narrow": 2 * 4 * 2, "wide": 0, "splat": 0},
          f"RIFE on the 2-way mesh launched {rife_sharded2_launches}, expected K1 4 per shard and call")
    reuse_fn, infer_fn = m2m.make_pair_fns(m2m.init_params(0), dtype=torch.float32, device=dev)
    mclip = torch.from_numpy(shifted_pattern(4, *M2M_HW, seed=52)).to(dev)
    mplan = plan_timestep(4, 3)
    m_refs = [executor_run(run_plan_pair_cached, mclip, mplan, reuse_fn, infer_fn, batch_size=2) for _ in range(3)]
    m_sh, m2m_sharded_launches, _ = executor_run(
        run_plan_pair_cached, mclip, mplan, *parallel.make_sharded_pair_fns(lambda d: (reuse_fn, infer_fn), mesh1), batch_size=2
    )
    # the splat sums with float atomics: held within the unsharded runs' spread
    m_spread = max((a[0] - b[0]).abs().max().item() for i, a in enumerate(m_refs) for b in m_refs[i + 1 :])
    m_err = min((m_sh - r[0]).abs().max().item() for r in m_refs)
    check(m_err <= m_spread, f"make_sharded_pair_fns through run_plan_pair_cached: max err {m_err} above the spread {m_spread}")
    check(all(r[1] == m2m_sharded_launches for r in m_refs), f"sharded M2M launches {m2m_sharded_launches}, unsharded {m_refs[0][1]}")
    # 2-way: each shard runs a batch of 1, held against the unsharded executor
    # at batch 1, TF32 off and cuDNN's deterministic algorithms in both (the
    # same shapes take the same algorithms), within 1e-5 of fp32 frames in
    # [0, 1] (the splat's float atomics sum in changing order); twice the 1x1
    # mesh's launches
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        m_ref1, _, _ = executor_run(run_plan_pair_cached, mclip, mplan, reuse_fn, infer_fn, batch_size=1)
        m_sh2, m2m_sharded2_launches, _ = executor_run(
            run_plan_pair_cached, mclip, mplan, *parallel.make_sharded_pair_fns(lambda d: (reuse_fn, infer_fn), mesh2),
            batch_size=2,
        )
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    m2_err = (m_sh2 - m_ref1).abs().max().item()
    check(m2_err <= 1e-5, f"make_sharded_pair_fns through run_plan_pair_cached on a 2-way mesh: max err {m2_err} above 1e-5")
    check(m2m_sharded2_launches == {k: 2 * v for k, v in m2m_sharded_launches.items()},
          f"M2M on the 2-way mesh launched {m2m_sharded2_launches}, the 1x1 mesh {m2m_sharded_launches}")
    # one RIFE 4.7 training step (f32, TF32 off, cuDNN's deterministic
    # algorithms) on the 2-way mesh, where each shard runs a batch of 1,
    # against one-device steps on each sample alone, whose forwards are the
    # shards' own bit for bit: the loss and the gradients are their means,
    # within 1e-6 and phase 49's kernel tolerance (1e-4 of each tensor's
    # largest; the shards' sums meet in another order); K1 4 and the backward
    # kernel 4 per shard. Against the one-device step at batch 2, whose
    # convolutions take other algorithms (forward values ~1e-7 apart, where
    # the warps' flow gradient jumps as a sample crosses a pixel), within
    # phase 49's card-against-CPU tolerance, and the updates where |g| is over
    # half its tensor's largest within phase 49's 1e-7
    batch51 = train_batch(2, TRAIN_CHECK_HW, 51, dev, torch.float32)
    stepped = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        runs = (("one", mesh1, batch51), ("two", mesh2, batch51),
                *((f"sample {i}", mesh1, tuple(x[i : i + 1] for x in batch51)) for i in range(2)))
        for key, m, batch in runs:
            net, step = rife_trainer(dev, torch.float32, mesh=m)
            before = {k: v.detach().clone() for k, v in net.named_parameters()}
            warp_kernel.launches = warp_kernel.wide_launches = warp_kernel.backward_launches = softsplat_kernel.launches = 0
            softsplat_kernel.backward_launches = 0
            loss = step(*batch).item()
            torch.cuda.synchronize()
            counts = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches,
                      "backward": warp_kernel.backward_launches, "splat": softsplat_kernel.launches,
                      "splat_backward": softsplat_kernel.backward_launches}
            stepped[key] = (loss, {k: v.grad.cpu() for k, v in net.named_parameters()},
                            {k: (v.detach() - before[k]).cpu() for k, v in net.named_parameters()}, counts)
            del net, step
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (loss1, grads1, deltas1, _), (loss2, grads2, deltas2, train2_launches) = stepped["one"], stepped["two"]
    (loss_a, grads_a, _, _), (loss_b, grads_b, _, _) = stepped["sample 0"], stepped["sample 1"]
    check(math.isfinite(loss2) and abs(loss2 - (loss_a + loss_b) / 2) <= 1e-6 * abs(loss2),
          f"2-way step loss {loss2} vs the mean of the samples' one-device steps {(loss_a + loss_b) / 2}")
    t2_rel, t2_worst, _ = grad_errs(grads2, {k: (grads_a[k] + grads_b[k]) / 2 for k in grads_a})
    check(t2_rel <= 1e-4, f"2-way step gradients vs the samples' one-device steps: {t2_rel:.3g} of {t2_worst}'s largest, above 1e-4")
    check(abs(loss2 - loss1) <= 1e-6 * abs(loss1), f"2-way step loss {loss2} vs the one-device step at batch 2 {loss1}")
    b2_rel, b2_worst, b2_glob = grad_errs(grads2, grads1)
    check(b2_rel <= 5e-2 and b2_glob <= 5e-3,
          f"2-way step gradients vs the one-device step at batch 2: {b2_rel:.3g} of {b2_worst}'s largest (at most 5e-2), "
          f"{b2_glob:.3g} of the largest of all (at most 5e-3)")
    t2_upd = max(
        (deltas2[k][gk.abs() > 0.5 * gk.abs().max()] - deltas1[k][gk.abs() > 0.5 * gk.abs().max()]).abs().max().item()
        for k, gk in grads1.items()
    )
    check(t2_upd <= 1e-3 * 1e-4 + 2.0**-23, f"2-way step updates vs the one-device step at batch 2: max err {t2_upd:.3g}")
    check(train2_launches == {"narrow": 8, "wide": 0, "backward": 8, "splat": 0, "splat_backward": 0},
          f"the 2-way training step launched {train2_launches}, expected K1 4 and the backward kernel 4 per shard")
    del stepped, grads1, grads2, grads_a, grads_b, deltas1, deltas2
    with contextlib.redirect_stdout(io.StringIO()) as dry_out:
        ptrain.dryrun(n_cards)
    dry_line = dry_out.getvalue().strip()
    check(dry_line.startswith(f"dryrun_multichip({n_cards}) OK: loss="), f"parallel.train.dryrun printed {dry_line!r}")
    print(
        f"parallel: make_mesh() on {n_cards} card(s) {mesh.shape}; RIFE 4.7 bf16 run_plan (4x540x960 x2, b2) through "
        f"make_sharded_model_fn: on a 1x1 mesh bit for bit with the unsharded run, launches {rife_sharded_launches}; on a 2-way "
        f"mesh of logical replicas bit for bit with the unsharded run at batch 1 ({rife2_err:.3g} from the batch-2 run), "
        f"launches {rife_sharded2_launches}; M2M fp32 run_plan_pair_cached (x3) through make_sharded_pair_fns: on a 1x1 mesh "
        f"max err {m_err:.3g} against the nearest unsharded run, three unsharded runs differ by up to {m_spread:.3g}, launches "
        f"{m2m_sharded_launches}; on the 2-way mesh max err {m2_err:.3g} against the unsharded run at batch 1, launches {m2m_sharded2_launches}; a RIFE 4.7 training "
        f"step b2x{TRAIN_CHECK_HW[0]}x{TRAIN_CHECK_HW[1]} f32 on the 2-way mesh: against one-device steps on each sample "
        f"alone, loss {loss2:.7f} vs their mean {(loss_a + loss_b) / 2:.7f}, gradients within {t2_rel:.3g} of each tensor's "
        f"largest ({t2_worst}); against the one-device step at batch 2, loss {loss1:.7f}, gradients within {b2_rel:.3g} of "
        f"each tensor's largest ({b2_worst}) and {b2_glob:.3g} of the largest of all, updates within {t2_upd:.3g}; "
        f"launches {train2_launches}; {dry_line}; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    del rife16, pclip, ref_out, ref1_out, sh_out, sh2_out, reuse_fn, infer_fn, mclip, m_refs, m_sh, m_sh2, m_ref1

    # ---- 52. the splat's backward kernel against its plain version ------------------
    clock("52")
    t0 = time.perf_counter()
    sb_errs, n_sb = {}, 0

    def sb_worst(key, errs):
        sb_errs[key] = tuple(max(a, b) for a, b in zip(sb_errs.get(key, (0.0, 0.0)), errs))

    dname = lambda t: str(t).split(".")[-1]  # noqa: E731
    for case in warp_cases.splat_cases(0, 256, 512) + warp_cases.splat_backward_cases(1, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.from_numpy(case["vals"]).to(dev, dtype)
            sb_worst(f"splat cases {dname(dtype)}", splat_backward_vs_plain(vals, torch.from_numpy(case["flow"]).to(dev), case["name"]))
            n_sb += 1
    f16_case = next(c for c in warp_cases.splat_backward_cases(1, 256, 512) if c["name"] == "splat_bwd_c5")
    sb_worst("f16 values and flow", splat_backward_vs_plain(
        torch.from_numpy(f16_case["vals"]).to(dev, torch.float16), torch.from_numpy(f16_case["flow"]).to(dev, torch.float16), "f16"))
    n_sb += 1
    # the vector widths, runs and channel tails: C = 1-8, 65 and 66 at
    # 256x512, GMFSS's and EISAI's widest at their 1080p / 540p sizes
    for shape in [(2, 256, 512, c) for c in (1, 2, 3, 4, 5, 6, 7, 8, 65, 66)] + [GMFSS_SPLAT_SHAPES[3], *EISAI_SPLAT_SHAPES[2:]]:
        wflow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], 6.0, scale=40.0)).to(dev) + torch.randn(*shape[:3], 2, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.rand(shape, generator=g).to(dev, dtype)
            sb_worst(f"widths {dname(dtype)}", splat_backward_vs_plain(vals, wflow, f"C = {shape[3]}"))
            n_sb += 1
    # layouts: NCHW planes, channel slices that start 4 and 8 bytes past a
    # 16-byte boundary, an expanded grad_out (stride 0, as a branch sum's
    # gradient can be)
    for c in (4, 7, 65, 66):
        lvals = torch.rand(2, 256, 512, c, generator=g).to(dev)
        lflow = torch.from_numpy(warp_cases.smooth_flow(2, 256, 512, 6.0)).to(dev)
        lgout = (torch.rand(lvals.shape, generator=g) * 2 - 1).to(dev)
        sliced = torch.zeros(2, 256, 512, c + 1, device=dev)
        sliced[..., 1:] = lvals
        sliced2 = torch.zeros(2, 256, 512, c + 2, device=dev)
        sliced2[..., 2:] = lvals
        layouts = {
            "nchw planes": (lvals.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), lgout.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)),
            "odd channel slice": (sliced[..., 1:], lgout),
            "8-byte channel slice": (sliced2[..., 2:], lgout),
            "expanded grad_out": (lvals, lgout[:1, :1, :1].expand(lvals.shape)),
        }
        for what, (v_, go_) in layouts.items():
            sb_worst("layouts float32", splat_backward_vs_plain(v_, lflow, f"{what} C = {c}", grad_out=go_))
            n_sb += 1
    del lvals, lflow, lgout, sliced, sliced2, layouts
    # a CUDA splat that needs a gradient goes through SplatFunction (the
    # twin is never called); a direct call of the forward wrapper with such
    # an input raises, naming softsplat_func
    splat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")  # also a function's name
    real_splat_twin = splat_mod.softsplat_torch

    def guarded_splat_twin(x, flow):
        check(not (x.is_cuda and torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad)),
              "a CUDA splat that needs a gradient reached the plain twin")
        return real_splat_twin(x, flow)

    rvals = torch.rand(1, 64, 64, 4, generator=g).to(dev).requires_grad_()
    rflow = (torch.randn(1, 64, 64, 2, generator=g) * 3).to(dev).requires_grad_()
    splat_mod.softsplat_torch = guarded_splat_twin
    try:
        before = (softsplat_kernel.launches, softsplat_kernel.backward_launches)
        torch.autograd.grad(softsplat_func(rvals, rflow).square().sum(), (rvals, rflow))
        torch.cuda.synchronize()
        check((softsplat_kernel.launches - before[0], softsplat_kernel.backward_launches - before[1]) == (1, 1),
              "softsplat_func with a gradient did not launch K2 and the backward kernel once each")
    finally:
        splat_mod.softsplat_torch = real_splat_twin
    try:
        softsplat_kernel.softsplat_bilinear(rvals.permute(0, 3, 1, 2), rflow.permute(0, 3, 1, 2))
        check(False, "softsplat_bilinear took an input that needs a gradient")
    except NotImplementedError as e:
        check("softsplat_func" in str(e), f"softsplat_bilinear's refusal does not name softsplat_func: {e}")
    del rvals, rflow

    def captured_splat_backwards(step_fn, *batch):
        """The splat backward launches one training step makes, with the
        tensors as the step hands them over (no copy: strides kept), and
        the step's splat forward launches."""
        store = []

        def keep(ten_in, flow, grad_out, in_grad=True):
            store.append((ten_in.detach(), flow.detach(), grad_out, in_grad))

        before = softsplat_kernel.launches
        with spying([(softsplat_kernel, "softsplat_bilinear_backward", keep)]):
            step_fn(*batch)
        torch.cuda.synchronize()
        return store, softsplat_kernel.launches - before

    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    # one M2M training step at phase 53's size
    _, m2m_cstep = m2m_trainer(dev, torch.float32)
    m2m_caps, m2m_cap_fwd = captured_splat_backwards(m2m_cstep, *train_batch(2, M2M_TRAIN_HW, 52, dev, torch.float32))
    check(len(m2m_caps) == 1 and m2m_cap_fwd == 1, f"one M2M training step made {m2m_cap_fwd} splats and {len(m2m_caps)} splat backwards, expected 1 and 1")
    m2m_bwd_layouts = []
    for ten_in, flow, grad_out, in_grad in m2m_caps:
        sb_worst("m2m training step", splat_backward_vs_plain(nhwc(ten_in), nhwc(flow), "M2M training step", grad_out=nhwc(grad_out),
                                                               in_grad=in_grad))
        m2m_bwd_layouts.append(f"values {list(nhwc(ten_in).shape)} strides {list(ten_in.stride())}, grad_out strides {list(grad_out.stride())}")
        n_sb += 1
    del m2m_cstep, m2m_caps
    # one GMFSS base step and one EISAI step at their smallest legal size
    # (64x64: GMFSS pads to multiples of 64), through make_train_step
    other_steps = {}
    for path, net_, apply_ in (
        ("gmfss", gmfss._load(gmfss.init_params(0), False, torch.float32, dev), gmfss.apply),
        ("eisai", eisai._load(eisai.init_params(0), torch.float32, dev), eisai.apply),
    ):
        step_ = parallel.make_train_step(apply_, torch.optim.Adam(net_.parameters(), lr=1e-4), parallel.make_mesh(1), net_)
        caps, fwd_n = captured_splat_backwards(step_, *train_batch(1, (64, 64), 52, dev, torch.float32))
        check(len(caps) == fwd_n > 0, f"one {path} training step made {fwd_n} splats and {len(caps)} splat backwards")
        for ten_in, flow, grad_out, in_grad in caps:
            sb_worst(f"{path} training step", splat_backward_vs_plain(nhwc(ten_in), nhwc(flow), f"{path} step", grad_out=nhwc(grad_out),
                                                                    in_grad=in_grad))
            n_sb += 1
        other_steps[path] = {"splats": fwd_n, "splat_backwards": len(caps),
                             "channels": sorted({int(t[0].shape[1]) for t in caps}),
                             "in_grads": sum(bool(t[3]) for t in caps)}
        del net_, step_, caps
    sb_err = max(e for k, v in sb_errs.items() if "bfloat16" not in k and "f16" not in k for e in v)
    print(
        f"splat backward: {n_sb} runs of the splat's backward kernel against softsplat_backward_torch (splat cases and "
        f"splat_backward_cases at 256x512 f32 and bf16, f16 once; C = 1-8, 65, 66, 193, 258, 514; NCHW planes, an odd and an 8-byte channel "
        f"slice, an expanded grad_out; the flow's gradient alone too), all within tolerance and each bit for bit on a second launch; "
        f"softsplat_func with a gradient went through SplatFunction (K2 and the backward kernel once, no twin), a direct "
        f"softsplat_bilinear with a gradient raised; one M2M training step's splat backward ({'; '.join(m2m_bwd_layouts)}); "
        f"GMFSS base and EISAI steps at 64x64 (their forwards differentiate on the card): "
        + ", ".join(f"{k} {v}" for k, v in other_steps.items())
        + "; max abs err (grad_in, grad_flow): " + ", ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in sb_errs.items())
        + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 53. an M2M training step, card against the twins and the CPU ---------------
    clock("53")
    t0 = time.perf_counter()
    batch53 = train_batch(2, M2M_TRAIN_HW, 53, "cpu", torch.float32)
    real_m2m_warp, real_m2m_splat = m2m.warp, m2m.softsplat_func

    def m2m_train_once(d, twin=False):
        """One M2M step on ``d``: ``(loss, grads, updates)`` on the host. With
        ``twin``, M2M's warps and splat call the plain twins directly
        (autograd through them), the reference for the kernels on the same
        card."""
        if twin:
            m2m.warp = lambda img, flow, padding_mode="border", prefer_wide=False: real_twin(img, flow, padding_mode)
            m2m.softsplat_func = real_splat_twin
        try:
            net, step = m2m_trainer(d, torch.float32)
            before = {k: v.detach().clone() for k, v in net.named_parameters()}
            loss = step(*(x.to(d) for x in batch53)).item()
        finally:
            m2m.warp, m2m.softsplat_func = real_m2m_warp, real_m2m_splat
        return (loss, {k: v.grad.cpu() for k, v in net.named_parameters()},
                {k: (v.detach() - before[k]).cpu() for k, v in net.named_parameters()})

    m2m_trained = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        m2m_trained["twin"] = m2m_train_once("cuda", twin=True)
        torch.cuda.synchronize()
        warp_mod.warp_torch, splat_mod.softsplat_torch = guarded_twin, guarded_splat_twin
        zero_kernel_counts()
        m2m_trained["cuda"] = m2m_train_once("cuda")
        torch.cuda.synchronize()
        m2m_train_launches = kernel_counts()
        warp_mod.warp_torch, splat_mod.softsplat_torch = real_twin, real_splat_twin
        m2m_trained["cpu"] = m2m_train_once("cpu")
    finally:
        warp_mod.warp_torch, splat_mod.softsplat_torch = real_twin, real_splat_twin
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(m2m_train_launches == M2M_TRAIN_LAUNCHES,
          f"one M2M training step launched {m2m_train_launches}, expected {M2M_TRAIN_LAUNCHES}")
    (mloss_gpu, mgrads_gpu, mdeltas_gpu), (mloss_cpu, mgrads_cpu, mdeltas_cpu) = m2m_trained["cuda"], m2m_trained["cpu"]
    mloss_twin, mgrads_twin, _ = m2m_trained["twin"]
    # the kernels against the twins inside one step on the card: K2's forward
    # sums with f32 atomics (so do the twin's index_add_ and the warp's
    # backward), in orders that change from run to run
    mk_rel, mk_worst, mk_glob = grad_errs(mgrads_gpu, mgrads_twin)
    check(math.isfinite(mloss_gpu) and abs(mloss_gpu - mloss_twin) <= 1e-6 * abs(mloss_twin),
          f"M2M training step loss with the kernels {mloss_gpu} vs through the twins {mloss_twin} on the card")
    check(mk_rel <= 1e-4, f"M2M training step gradients, kernels vs twins on the card: {mk_rel:.3g} of {mk_worst}'s largest, above 1e-4")
    # card against CPU, phase 49's rule
    mc_rel, mc_worst, mc_glob = grad_errs(mgrads_gpu, mgrads_cpu)
    check(abs(mloss_gpu - mloss_cpu) <= 1e-5 * abs(mloss_cpu), f"M2M training step loss card {mloss_gpu} vs CPU {mloss_cpu}")
    check(mc_rel <= 5e-2 and mc_glob <= 5e-3,
          f"M2M training step gradients card vs CPU: {mc_rel:.3g} of {mc_worst}'s largest (at most 5e-2), {mc_glob:.3g} of the "
          f"largest of all (at most 5e-3)")
    mupd_err, mn_upd = 0.0, 0
    for k, gk in mgrads_cpu.items():
        # (the cost volumes' PReLU slopes get a zero gradient: an L1 cost
        # volume is never negative)
        big = gk.abs() > 0.5 * gk.abs().max()
        if big.any():
            mn_upd += int(big.sum())
            mupd_err = max(mupd_err, (mdeltas_gpu[k][big] - mdeltas_cpu[k][big]).abs().max().item())
    # 1e-3 of the learning rate, plus one f32 ulp of a parameter in [8, 16) (paramAlpha starts at 10)
    check(mupd_err <= 1e-3 * 1e-4 + 2.0**-20, f"M2M training step updates card vs CPU: max err {mupd_err:.3g}")
    print(
        f"m2m train: M2M make_train_step (L1, Adam 1e-4) b2x{M2M_TRAIN_HW[0]}x{M2M_TRAIN_HW[1]} f32, TF32 off, cuDNN "
        f"deterministic: kernels vs the plain twins on the card: loss {mloss_gpu:.7f} vs {mloss_twin:.7f}, gradients within "
        f"{mk_rel:.3g} of each tensor's largest ({mk_worst}) and {mk_glob:.3g} of the largest of all; card vs CPU: loss "
        f"{mloss_cpu:.7f}, gradients within {mc_rel:.3g} of each tensor's largest ({mc_worst}) and {mc_glob:.3g} of the largest "
        f"of all, the {mn_upd} updates where |g| > 0.5 of its tensor's largest within {mupd_err:.3g}; launches "
        f"{m2m_train_launches} (no CUDA warp or splat that needs a gradient reached a twin); phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    del m2m_trained, mgrads_gpu, mgrads_cpu, mgrads_twin, mdeltas_gpu, mdeltas_cpu

    # ---- 54. M2M training timing, and the splat backward kernel's ---------------------
    clock("54")
    t0 = time.perf_counter()
    m2m_trainers = {}
    for dtype in (torch.float32, torch.bfloat16):
        net, step = m2m_trainer(dev, dtype)
        m2m_trainers[dname(dtype)] = (dtype, step, train_batch(M2M_TRAIN_BATCH, M2M_TRAIN_HW, 54, dev, dtype))
        del net
    for _, step, batch54 in m2m_trainers.values():
        for _ in range(3):
            step(*batch54)
    torch.cuda.synchronize()
    # windows of 5 steps (~1.6 s, as the families' 2 steps of 200-600 ms):
    # RIFE's 20 a window took M2M's 300 ms steps ~90 s of the run's limit
    m2m_steps = 5
    m2m_windows = {name: [] for name in m2m_trainers}
    for i in range(n_windows):
        for name in (list(m2m_trainers) if i % 2 == 0 else list(m2m_trainers)[::-1]):
            _, step, batch54 = m2m_trainers[name]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(m2m_steps):
                loss = step(*batch54)
            torch.cuda.synchronize()
            m2m_windows[name].append(1e3 * (time.perf_counter() - t1) / m2m_steps)
            check(bool(torch.isfinite(loss)), f"M2M training step {name}: loss {loss}")
    m2m_train_rows = {}
    for name, (dtype, step, batch54) in m2m_trainers.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(*batch54)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms_step = statistics.median(m2m_windows[name])
        m2m_train_rows[name] = {
            "steps_per_s": 1e3 / ms_step, "samples_per_s": 1e3 * M2M_TRAIN_BATCH / ms_step, "ms_per_step": ms_step,
            "ms_per_step_windows": m2m_windows[name], "peak_bytes": peak,
        }
        print(
            f"timing {card}: M2M training b{M2M_TRAIN_BATCH} {M2M_TRAIN_HW[0]}x{M2M_TRAIN_HW[1]} {name}, Adam 1e-4: "
            f"{1e3 / ms_step:.3f} steps/s, {1e3 * M2M_TRAIN_BATCH / ms_step:.2f} samples/s (median {ms_step:.3f} ms a step over "
            f"{n_windows} windows of {m2m_steps} steps, in turns with the other dtype; windows {min(m2m_windows[name]):.3f} to "
            f"{max(m2m_windows[name]):.3f} ms), peak {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held",
            flush=True,
        )
    (f_lo, f_hi), (b_lo, b_hi) = ((min(m2m_windows[k]), max(m2m_windows[k])) for k in ("float32", "bfloat16"))
    gap = abs(m2m_train_rows["float32"]["ms_per_step"] - m2m_train_rows["bfloat16"]["ms_per_step"])
    spread = max(f_hi - f_lo, b_hi - b_lo)
    print(
        f"timing {card}: M2M training, bf16 against f32: medians {gap:.3f} ms a step apart, the windows of one dtype spread by "
        f"up to {spread:.3f} ms: " + ("resolved" if spread < gap else "unresolved (the spread exceeds the difference)"),
        flush=True,
    )
    _, step, batch54 = m2m_trainers["float32"]
    m2m_train_profile = profile_forward(
        f"M2M training step b{M2M_TRAIN_BATCH} {M2M_TRAIN_HW[0]}x{M2M_TRAIN_HW[1]} f32 (TF32 at its defaults)", step, *batch54,
        card=card, unit="step",
    )
    del m2m_trainers, step, batch54
    sbwd_times = {}
    # the step's splat in f32 and bf16 (flow in the values' dtype, as the
    # steps give it) and M2M's batch-2 1080p splat in f32
    for shape, dtype in ((M2M_TRAIN_SPLAT_SHAPE, torch.float32), (M2M_TRAIN_SPLAT_SHAPE, torch.bfloat16), (SPLAT_SHAPE, torch.float32)):
        svals = torch.rand(shape, generator=g).to(dev, dtype)
        sflow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=8.0)).to(dev, dtype)
        sgrad = (torch.rand(shape, generator=g) * 2 - 1).to(dev)
        err = splat_backward_vs_plain(svals, sflow, "timing shape", grad_out=sgrad)
        args = (svals.permute(0, 3, 1, 2), sflow.permute(0, 3, 1, 2), sgrad.permute(0, 3, 1, 2))
        times = in_turns({
            "plain": (lambda: softsplat_backward_torch(svals, sflow, sgrad), 3),
            "kernel": (lambda: softsplat_kernel.softsplat_bilinear_backward(*args), 20),
            "two library calls": (splat_backward_library_call(svals, sflow, sgrad), 10),
        })
        ms = {k: statistics.mean(v) for k, v in times.items()}
        dev_kernel = device_ms(lambda: softsplat_kernel.softsplat_bilinear_backward(*args), 20, name="softsplat_backward_kernel")
        b = bound(*splat_backward_work(*args[:2]))
        key = f"{list(shape)} {dname(dtype)}"
        sbwd_times[key] = {
            "ms": ms["kernel"], "kernel_device_ms": dev_kernel, "plain_ms": ms["plain"], "library_ms": ms["two library calls"],
            "bound_ms": b[0], "bound_by": b[1], "max_abs_err": max(err),
        }
        print(
            f"timing {card}: splat backward {key}, {dname(dtype)} flow: "
            + ", ".join(f"{k} {ms[k]:.4f} ms {v}" for k, v in times.items())
            + f"; the kernel alone {dev_kernel:.4f} ms on the device; bound {b[0]:.4f} ms ({b[1]}), the op at "
            f"{100 * b[0] / ms['kernel']:.1f} % of it, the kernel at {100 * b[0] / dev_kernel:.1f} %; max abs err (grad_in, "
            f"grad_flow) {err[0]:.3g}, {err[1]:.3g}",
            flush=True,
        )
        del svals, sflow, sgrad, args
    sbwd_main = sbwd_times[f"{list(M2M_TRAIN_SPLAT_SHAPE)} float32"]
    print(f"m2m train timing: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 55-61 and 64-70. the other families' training steps, and 62. the ----
    clock("55-61 and 64-70")
    # backward kernels at their largest inputs: the warp's at each family's,
    # the splat's at the largest of all (phase 63 times each of its inputs)
    t0 = time.perf_counter()
    family_rows, warp_largest, splat_largest = {}, [], None
    for name in FAMILIES:
        family_rows[name], largest = family_phase(name, FAMILY_PHASES[name], dev, card)
        if largest["warp"] is not None:
            warp_largest.append(("warp", name, largest["warp"]))
        c = largest["splat"]
        if c is not None and (splat_largest is None or c[0].numel() > splat_largest[2][0].numel()):
            splat_largest = ("splat", name, c)
        del largest, c
        torch.cuda.empty_cache()
    family_times = largest_backward_times(warp_largest + [splat_largest], card)
    del warp_largest, splat_largest
    print(f"family training: phases 55-62 and 64-70 {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 63. the splat's backward kernel at every input the steps give it ----------
    clock("63")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sb_layouts, sb_per_step = splat_backward_step_inputs(dev)
    svals = torch.rand(SPLAT_SHAPE, generator=g).to(dev)
    sflow = torch.from_numpy(warp_cases.smooth_flow(*SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    sgrad = (torch.rand(SPLAT_SHAPE, generator=g) * 2 - 1).to(dev)
    sb_layouts[f"{list(SPLAT_SHAPE)} float32, smooth flow (M2M's batch-2 1080p splat)"] = (
        svals.permute(0, 3, 1, 2), sflow.permute(0, 3, 1, 2), sgrad.permute(0, 3, 1, 2), True)
    del svals, sflow, sgrad
    sb_rows = splat_backward_times(sb_layouts, card)
    # GMFSS's C = 65 and EISAI's C = 66 step inputs, kept for phase 91's bands
    band91_inputs = {}
    for path91, c91 in (("gmfss", 65), ("eisai", 66)):
        key91 = next(k for k in sb_per_step[path91] if k.split(" float32")[0].endswith(f", {c91}]"))
        band91_inputs[f"{path91} step input {key91}"] = sb_layouts[key91]
    del sb_layouts
    sb_steps = {}
    for path, counts in sb_per_step.items():
        launches = sum(counts.values())
        dev_sum = sum(n * sb_rows[k]["kernel_device_ms"] for k, n in counts.items())
        bound_sum = sum(n * sb_rows[k]["bound_ms"] for k, n in counts.items())
        lib_sum = sum(n * sb_rows[k]["library_device_ms"] for k, n in counts.items())
        sb_steps[path] = {"launches": launches, "kernel_device_ms": dev_sum, "bound_ms": bound_sum,
                          "share_of_bound": bound_sum / dev_sum, "library_device_ms": lib_sum, "by_layout": counts}
        print(
            f"splat backward {card}: one {path} training step's {launches} launches: the kernel {dev_sum:.4f} ms on the "
            f"device against their bounds' {bound_sum:.4f} ms ({100 * bound_sum / dev_sum:.1f} %), the two library calls "
            f"{lib_sum:.4f} ms",
            flush=True,
        )
    print(f"splat backward timing: phase 63 {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 71. K1 on a row band against its twin's band -------------------------------
    clock("71")
    # the two bands of RIFE 1080p b8's [16, 1088, 1920, 7] warp on a (1, 2) mesh
    t0 = time.perf_counter()
    from comfyui_frame_interpolation_tpu_torch.parallel.space import band_rows

    spans = band_rows(SPACE_WARP_SHAPE[1], 2)
    check(spans == [(0, 576), (576, 512)], f"band_rows({SPACE_WARP_SHAPE[1]}, 2) = {spans}")
    band_err, band_rows_ms = 0.0, {}
    for dtype, mode in ((torch.float32, "border"), (torch.bfloat16, "border"), (torch.bfloat16, "zeros")):
        img = torch.rand(SPACE_WARP_SHAPE, generator=g).to(dev, dtype)
        flow = torch.from_numpy(warp_cases.smooth_flow(*SPACE_WARP_SHAPE[:3], amp=6.0)).to(dev)
        planes, fplanes, zeros = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), mode == "zeros"
        ref = warp_torch(img, flow, mode)
        whole = warp_kernel.warp_bilinear(planes, fplanes, zeros)
        whole0 = warp_kernel.warp_bilinear(planes, fplanes, zeros, row0=0)
        torch.cuda.synchronize()
        check(torch.equal(whole0, whole) and torch.equal(whole.permute(0, 2, 3, 1), ref),
              f"K1 with row0=0 at full height {list(SPACE_WARP_SHAPE)} {dtype} {mode}: not bit for bit the whole-frame call and the twin")
        for row0, rows in spans:
            fband = flow[:, row0 : row0 + rows]
            got = warp_kernel.warp_bilinear(planes, fband.permute(0, 3, 1, 2), zeros, row0=row0).permute(0, 2, 3, 1)
            routed = warp(img, fband, mode, row0=row0)
            twin = warp_torch(img, fband, mode, row0=row0)
            torch.cuda.synchronize()
            err = (got.float() - twin.float()).abs().max().item()
            band_err = max(band_err, err)
            check(torch.equal(got, twin) and torch.equal(routed, twin) and torch.equal(got, ref[:, row0 : row0 + rows]),
                  f"K1 band rows {row0}-{row0 + rows} of {list(SPACE_WARP_SHAPE)} {dtype} {mode}: max err {err} against the "
                  f"twin's band, not bit for bit (or not the whole frame's rows)")
        if dtype == torch.bfloat16 and mode == "border":
            # the second band, as the (1, 2) mesh's second device warps it, in
            # turns with the whole frame and the twin's band; grid_sample on a
            # grid of the band's rows is the library yardstick
            row0, rows = spans[1]
            fband = flow[:, row0 : row0 + rows]
            fbp = fband.permute(0, 3, 1, 2)
            grid = band_grid(fband, row0, SPACE_WARP_SHAPE[1]).to(dtype)
            times = in_turns({
                "K1 band": (lambda: warp_kernel.warp_bilinear(planes, fbp, False, row0=row0), 50),
                "K1 whole frame": (lambda: warp_kernel.warp_bilinear(planes, fplanes, False), 50),
                "plain band": (lambda: warp_torch(img, fband, "border", row0=row0), 5),
                "grid_sample band": (lambda: torch.nn.functional.grid_sample(planes, grid, padding_mode="border", align_corners=True), 20),
            })
            band_rows_ms = {k: statistics.mean(v) for k, v in times.items()}
            band_bound = bound(*warp_work(planes, fbp))
            del fbp, grid
        del img, flow, planes, fplanes, ref, whole, whole0, got, routed, twin
    print(
        f"K1 band {card}: {list(SPACE_WARP_SHAPE)} in bands {spans}, f32 and bf16 border, bf16 zeros: each band bit for bit its "
        f"twin's band and the whole frame's rows (max err {band_err}), row0=0 at full height bit for bit the whole-frame call; "
        f"the second band bf16: " + ", ".join(f"{k} {v:.4f} ms" for k, v in band_rows_ms.items())
        + f"; its bound {band_bound[0]:.4f} ms ({band_bound[1]}), K1 at {100 * band_bound[0] / band_rows_ms['K1 band']:.1f} % "
        f"of it",
        flush=True,
    )
    # the wide kernel's band: M2M 1080p b2's feature warps (zeros) and FILM's
    # widest level (border), each in the rows that the frame's two bands give
    # it on a (1, 2) mesh; the second bf16 band timed in turns with the whole
    # frame, the twin's band and F.grid_sample on the band's grid
    wide_band_err, wide_band_ms = 0.0, {}
    wide_band_cases = [(shape, 1088, "zeros", (torch.float32, torch.bfloat16)) for shape in M2M_SPACE_WIDE_SHAPES]
    wide_band_cases.append((FILM_WARP_SHAPES[1], 1080, "border", (torch.bfloat16,)))
    for shape, frame_rows, mode, dtypes in wide_band_cases:
        wspans = frame_band_spans(shape[1], frame_rows)
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        for dtype in dtypes:
            img = torch.rand(shape, generator=g).to(dev, dtype)
            planes, fplanes, zeros = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), mode == "zeros"
            check(warp_kernel.route(planes.shape, planes.stride(), dtype) == "wide", f"{list(shape)} {dtype} does not route to the wide kernel")
            whole = warp_kernel.warp_bilinear_wide(planes, fplanes, zeros)
            whole0 = warp_kernel.warp_bilinear_wide(planes, fplanes, zeros, row0=0)
            torch.cuda.synchronize()
            check(torch.equal(whole0, whole), f"the wide kernel with row0=0 at full height {list(shape)} {dtype}: not bit for bit the whole-frame call")
            for row0, rows in wspans:
                fband = flow[:, row0 : row0 + rows]
                got = warp_kernel.warp_bilinear_wide(planes, fband.permute(0, 3, 1, 2), zeros, row0=row0).permute(0, 2, 3, 1)
                routed = warp(img, fband, mode, row0=row0)
                twin = warp_torch(img, fband, mode, row0=row0)
                torch.cuda.synchronize()
                err = (got.float() - twin.float()).abs().max().item()
                wide_band_err = max(wide_band_err, err)
                check(torch.equal(got, twin) and torch.equal(routed, twin) and torch.equal(got, whole.permute(0, 2, 3, 1)[:, row0 : row0 + rows]),
                      f"wide band rows {row0}-{row0 + rows} of {list(shape)} {dtype} {mode}: max err {err} against the twin's band, "
                      f"not bit for bit (or not the whole frame's rows)")
            if dtype == torch.bfloat16:
                row0, rows = wspans[1]
                fband = flow[:, row0 : row0 + rows]
                fbp = fband.permute(0, 3, 1, 2)
                grid_band = band_grid(fband, row0, shape[1]).to(dtype)
                times = in_turns({
                    "wide band": (lambda: warp_kernel.warp_bilinear_wide(planes, fbp, zeros, row0=row0), 50),
                    "wide whole frame": (lambda: warp_kernel.warp_bilinear_wide(planes, fplanes, zeros), 50),
                    "plain band": (lambda: warp_torch(img, fband, mode, row0=row0), 3),
                    "grid_sample band": (lambda: torch.nn.functional.grid_sample(planes, grid_band, padding_mode=mode, align_corners=True), 20),
                })
                key = f"{list(shape)} bf16 {mode}, rows {row0}-{row0 + rows}"
                wide_band_ms[key] = {k: statistics.mean(v) for k, v in times.items()}
                wide_band_ms[key]["bound_ms"], wide_band_ms[key]["bound_by"] = bound(*warp_work(planes, fbp))
                del fbp, grid_band
            del img, planes, fplanes, whole, whole0, got, routed, twin
        del flow
    wide_band_main = next(k for k in wide_band_ms if k.startswith(str(list(M2M_SPACE_WIDE_SHAPES[1]))))
    print(
        f"wide band {card}: M2M's {[list(s) for s in M2M_SPACE_WIDE_SHAPES]} zeros f32 and bf16 and FILM's {list(FILM_WARP_SHAPES[1])} "
        f"bf16 border, each in the bands of its frame's (1, 2) split: each band bit for bit its twin's band and the whole frame's "
        f"rows (max err {wide_band_err}), row0=0 at full height bit for bit the whole-frame call; the second bf16 band: "
        + "; ".join(
            f"{k}: " + ", ".join(f"{n} {m:.4f} ms" for n, m in v.items() if n != "bound_by")
            + f" ({v['bound_by']}), the kernel at {100 * v['bound_ms'] / v['wide band']:.1f} % of its bound"
            for k, v in wide_band_ms.items()
        ) + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 72. the warp's backward kernel on a row band ---------------------------------
    clock("72")
    # the b16 x 224^2 training step's warps ([32, 256, 256, 7], and C = 3 of
    # the last stage without the image's gradient) in its two bands of 128 rows
    t0 = time.perf_counter()
    bband_err, bband_ms = {}, {}
    for c, img_grad in ((7, True), (3, False)):
        shape = (SPACE_TRAIN_WARP_SHAPE[0], *SPACE_TRAIN_WARP_SHAPE[1:3], c)
        img = torch.rand(shape, generator=g).to(dev).contiguous()
        flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        grad_out = (torch.rand(shape, generator=g) * 2 - 1).to(dev)
        planes, fplanes, gplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2)
        gi_whole, gf_whole = warp_kernel.warp_bilinear_backward(planes, fplanes, gplanes, False, img_grad)
        contributions, _ = warp_backward_torch(img, flow, grad_out.abs())
        gi_sum = torch.zeros_like(img)
        errs = [0.0, 0.0]
        for row0, rows in band_rows(shape[1], 2):
            fb, gb = flow[:, row0 : row0 + rows], grad_out[:, row0 : row0 + rows]
            gi, gf = warp_kernel.warp_bilinear_backward(
                planes, fb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2), False, img_grad, row0=row0
            )
            ri, rf = warp_backward_torch(img, fb, gb, "border", row0=row0)
            band_contrib, _ = warp_backward_torch(img, fb, gb.abs(), "border", row0=row0)
            torch.cuda.synchronize()
            ok_f, err_f = grad_within(gf.permute(0, 2, 3, 1), rf, 1e-5 * rf.abs().max().item() + 1e-6, torch.float32)
            check(ok_f, f"backward band rows {row0}-{row0 + rows} of {list(shape)}: grad_flow max err {err_f} against its plain version")
            errs[1] = max(errs[1], err_f)
            if img_grad:
                ok_i, err_i = grad_within(gi.permute(0, 2, 3, 1), ri, 1e-5 * band_contrib + 1e-6, torch.float32)
                check(ok_i, f"backward band rows {row0}-{row0 + rows} of {list(shape)}: grad_img max err {err_i} against its plain version")
                errs[0] = max(errs[0], err_i)
                gi_sum += gi.permute(0, 2, 3, 1)
            else:
                check(gi is None, "the backward band without the image's gradient returned one")
            if row0 > 0:
                fbp, gbp = fb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2)
                library = grid_sample_backward_call(img, fb, gb, "border", img_grad, row0=row0)
                times = in_turns({
                    "band": (lambda: warp_kernel.warp_bilinear_backward(planes, fbp, gbp, False, img_grad, row0=row0), 20),
                    "whole frame": (lambda: warp_kernel.warp_bilinear_backward(planes, fplanes, gplanes, False, img_grad), 20),
                    "plain band": (lambda: warp_backward_torch(img, fb, gb, "border", row0=row0), 5),
                    "library band": (library, 20),
                })
                del library
                key = f"{list(shape)} f32 rows {row0}-{row0 + rows}" + ("" if img_grad else ", no image gradient")
                bband_ms[key] = {k: statistics.mean(v) for k, v in times.items()}
                bband_ms[key]["bound_ms"], bband_ms[key]["bound_by"] = bound(*backward_work(planes, fbp, img_grad))
        if img_grad:
            torch.cuda.synchronize()
            ok_s, err_s = grad_within(gi_sum, gi_whole.permute(0, 2, 3, 1), 1e-5 * contributions + 1e-6, torch.float32)
            check(ok_s, f"backward bands' grad_img summed against the whole-frame call at {list(shape)}: max err {err_s}")
            errs.append(err_s)
        bband_err[f"{list(shape)} f32" + ("" if img_grad else ", no image gradient")] = errs
        del img, flow, grad_out, planes, fplanes, gplanes, gi_whole, gf_whole, contributions, gi_sum
    bband_main = next(iter(bband_ms))  # C = 7 with the image's gradient
    print(
        f"backward band {card}: " + "; ".join(
            f"{k}: max err grad_img {v[0]:.3g}, grad_flow {v[1]:.3g}" + (f", bands summed vs whole {v[2]:.3g}" if len(v) > 2 else "")
            for k, v in bband_err.items()
        ) + "; " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {m:.4f} ms" for n, m in v.items() if n != "bound_by") for k, v in bband_ms.items()
        ) + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 73. RIFE 4.7 1080p b8 on a (1, 2) mesh of replicas of the card -----------------
    clock("73")
    t0 = time.perf_counter()
    mesh_s = parallel.make_mesh(2, devices=[dev] * 2)
    check(mesh_s.shape == {"data": 1, "space": 2}, f"make_mesh(2) of replicas: {mesh_s.shape}")
    sclip = torch.from_numpy(shifted_pattern(9, 1080, 1920, seed=73)).to(dev)
    splan = plan_timestep(9, 2)  # 8 pairs, one batch of 8
    space_rows, space_out, f32_settings = {}, {}, {}
    space_launches = {"narrow": 0, "wide": 0, "splat": 0}
    space_backward_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        fn1 = rife.make_model_fn(rife.init_params(0, "4.7"), "4.7", fastmode=True, ensemble=False, dtype=dtype, device=dev)
        fn2 = parallel.make_sharded_model_fn(lambda d: fn1, mesh_s)
        # TF32 off and cuDNN's deterministic algorithms, as phase 74 and the
        # other sharded phases compare
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            warp_kernel.backward_launches = 0
            one_out, one_n, one_peak = executor_run(run_plan, sclip, splan, fn1, batch_size=8)
            two_out, two_n, two_peak = executor_run(run_plan, sclip, splan, fn2, batch_size=8)
            space_backward_launches += warp_kernel.backward_launches
            if dtype == torch.float32:
                # the (1, 2) run again, then the same runs at cuDNN's default
                # (which may take a non-deterministic algorithm for the
                # transposed convolutions, cuDNN's backward-data)
                two_again, _, _ = executor_run(run_plan, sclip, splan, fn2, batch_size=8)
                torch.backends.cudnn.deterministic = det
                one_d, one_d_n, _ = executor_run(run_plan, sclip, splan, fn1, batch_size=8)
                two_d, two_d_n, _ = executor_run(run_plan, sclip, splan, fn2, batch_size=8)
                two_d2, _, _ = executor_run(run_plan, sclip, splan, fn2, batch_size=8)
                check(one_d_n == one_n and two_d_n == two_n, f"RIFE f32 launches at cuDNN's default: {one_d_n}, {two_d_n}")
                f32_settings = {"deterministic_repeat_max_abs_diff": (two_again - two_out).abs().max().item(),
                                "default_max_abs_err": (two_d - one_d).abs().max().item(),
                                "default_repeat_max_abs_diff": (two_d2 - two_d).abs().max().item()}
                del two_again, one_d, two_d, two_d2
        finally:
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        check(one_n == {"narrow": 4, "wide": 0, "splat": 0} and two_n == {"narrow": 8, "wide": 0, "splat": 0},
              f"RIFE {name} launches: one device {one_n}, the (1, 2) mesh {two_n}; expected K1 4 and twice 4")
        space_launches = {k: space_launches[k] + two_n[k] for k in space_launches}
        space_out[name] = (one_out, two_out)
        # frames/s of one b8 forward each, in turns, and each run's profile
        f0 = torch.from_numpy(np.random.default_rng(0).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
        f1 = torch.from_numpy(np.random.default_rng(1).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
        tt = torch.full((8,), 0.5, device=dev)
        fps = {"one device": [], "(1, 2) mesh": []}
        for key in ("one device", "(1, 2) mesh", "(1, 2) mesh", "one device"):
            fps[key].append(8 / measure(fn1 if key == "one device" else fn2, f0, f1, tt, iters=5, rounds=1))
        totals = {"one device": {}, "(1, 2) mesh": {}}
        profile_forward(f"RIFE 4.7 1080p {name} b8, one device", fn1, f0, f1, tt, card=card, totals=totals["one device"])
        profile_forward(f"RIFE 4.7 1080p {name} b8, (1, 2) mesh", fn2, f0, f1, tt, card=card, totals=totals["(1, 2) mesh"])
        space_rows[name] = {
            key: {"frames_per_s": statistics.mean(fps[key]), "frames_per_s_turns": fps[key],
                  "peak_run_plan_bytes": one_peak if key == "one device" else two_peak,
                  "idle_share": totals[key]["idle_share"], "device_ms": totals[key]["device_ms"],
                  "wall_ms": totals[key]["wall_ms"], "kernels": totals[key]["kernels"]}
            for key in fps
        }
        del fn1, fn2, f0, f1, tt
        torch.cuda.empty_cache()
    f32_err = (space_out["float32"][1] - space_out["float32"][0]).abs().max().item()
    check(f32_err <= 1e-4, f"RIFE f32 on the (1, 2) mesh: max abs {f32_err} from one device, above 1e-4")
    check(space_backward_launches == 0, f"RIFE inference on the (1, 2) mesh launched the warp's backward {space_backward_launches} times")
    bf16_db = psnr(space_out["bfloat16"][1], space_out["float32"][0])
    bf16_one_db = psnr(space_out["bfloat16"][0], space_out["float32"][0])
    check(bf16_db >= 40.0, f"RIFE bf16 on the (1, 2) mesh: {bf16_db:.2f} dB against the f32 one-device frames, below 40")
    del space_out, sclip
    print(
        f"space {card}: RIFE 4.7 1080p x2 b8 (9 frames, 8 mids) through make_sharded_model_fn + run_plan on a (1, 2) mesh of "
        f"replicas of the card, bands {band_rows(1080, 2)} (padded {band_rows(1088, 2)}): f32 (TF32 off, cuDNN deterministic) "
        f"max abs {f32_err:.3g} from one device, the (1, 2) run against itself {f32_settings['deterministic_repeat_max_abs_diff']:.3g} "
        f"(at cuDNN's default {f32_settings['default_max_abs_err']:.3g} and "
        f"{f32_settings['default_repeat_max_abs_diff']:.3g}); bf16 {bf16_db:.2f} dB against the f32 one-device frames (one device bf16 {bf16_one_db:.2f} dB); "
        f"launches {space_launches} for two run_plan calls (K1 8 a forward), the backward {space_backward_launches}; "
        + "; ".join(
            f"{name} {key}: {r['frames_per_s']:.2f} frames/s (turns {', '.join(f'{v:.2f}' for v in r['frames_per_s_turns'])}), "
            f"run_plan peak {r['peak_run_plan_bytes'] / 2**30:.3f} GiB, idle share {r['idle_share']:.4f}"
            for name, rows_ in space_rows.items() for key, r in rows_.items()
        ) + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 74. a RIFE 4.7 training step on a (1, 2) mesh of replicas --------------------
    clock("74")
    # b16 x 224^2 f32 (two bands of 128 rows after the pad to 256) against
    # (1, 1), TF32 off and cuDNN's deterministic algorithms in both: the loss
    # within 1e-6 relative, each gradient within 5e-5 of its tensor's largest
    # (tests/test_torch_parallel.py's tolerances) or within 4x what the
    # (1, 1) step's gradient moves when every weight is scaled by 1 + 2^-22
    # (two f32 ulps): the bands' convolutions take other cuDNN algorithms, so
    # the forward values move by rounding, and where a sample sits on a pixel
    # edge the warp's flow gradient jumps (at this size one device moves by
    # 3.1e-3 of block3.convblock.4.beta's largest so on an H100). The
    # same at b2 x 128^2 (bands of 64 rows), the CPU test's size, within
    # 5e-5 alone; the updates where |g| is over half its tensor's largest
    # within 1e-7
    t0 = time.perf_counter()
    batch74 = train_batch(TRAIN_BATCH, TRAIN_HW, 74, dev, torch.float32)
    batch74s = train_batch(2, (128, 128), 74, dev, torch.float32)
    stepped = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        for key, m, batch, scale in (("one", mesh1, batch74, 0.0), ("space", mesh_s, batch74, 0.0),
                                     ("one scaled", mesh1, batch74, 2.0**-22), ("one small", mesh1, batch74s, 0.0),
                                     ("space small", mesh_s, batch74s, 0.0)):
            net, step = rife_trainer(dev, torch.float32, mesh=m)
            if scale:
                with torch.no_grad():
                    for p in net.parameters():
                        p.mul_(1 + scale)
            before = {k: v.detach().clone() for k, v in net.named_parameters()}
            warp_kernel.launches = warp_kernel.wide_launches = warp_kernel.backward_launches = softsplat_kernel.launches = 0
            softsplat_kernel.backward_launches = 0
            loss = step(*batch).item()
            torch.cuda.synchronize()
            counts = {"narrow": warp_kernel.launches, "wide": warp_kernel.wide_launches,
                      "backward": warp_kernel.backward_launches, "splat": softsplat_kernel.launches,
                      "splat_backward": softsplat_kernel.backward_launches}
            stepped[key] = (loss, {k: v.grad.clone() for k, v in net.named_parameters()},
                            {k: v.detach() - before[k] for k, v in net.named_parameters()}, counts)
            del net, step
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (loss1, grads1, deltas1, one_counts), (loss_s, grads_s, deltas_s, space_train_launches) = stepped["one"], stepped["space"]
    grads_p = stepped["one scaled"][1]
    (loss1s, grads1s, deltas1s, _), (loss_ss, grads_ss, deltas_ss, small_launches) = stepped["one small"], stepped["space small"]
    s_rel, s_worst, s_glob = grad_errs(grads_s, grads1)
    p_rel, p_worst, _ = grad_errs(grads_p, grads1)
    over = {
        k: (err, sens)
        for k in grads1
        for err, sens in [((grads_s[k] - grads1[k]).abs().max().item(), (grads_p[k] - grads1[k]).abs().max().item())]
        if err > max(5e-5 * grads1[k].abs().max().item(), 4 * sens)
    }
    ss_rel, ss_worst, _ = grad_errs(grads_ss, grads1s)

    def big_update_err(d2, d1, g1):
        return max((d2[k][gk.abs() > 0.5 * gk.abs().max()] - d1[k][gk.abs() > 0.5 * gk.abs().max()]).abs().max().item()
                   for k, gk in g1.items())

    s_upd, ss_upd = big_update_err(deltas_s, deltas1, grads1), big_update_err(deltas_ss, deltas1s, grads1s)
    for what, a, b in (("b16 x 224^2", loss_s, loss1), ("b2 x 128^2", loss_ss, loss1s)):
        check(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(b),
              f"the (1, 2) step's loss {a} against the (1, 1) step's {b} at {what}: above 1e-6 relative")
    check(not over, f"the (1, 2) step's gradients against (1, 1) at b16 x 224^2, (max err, the scaled weights' move) above both "
          f"5e-5 of the tensor's largest and 4x the move: {dict(list(over.items())[:4])}")
    check(ss_rel <= 5e-5, f"the (1, 2) step's gradients against (1, 1) at b2 x 128^2: {ss_rel:.3g} of {ss_worst}'s largest, above 5e-5")
    check(max(s_upd, ss_upd) <= 1e-3 * 1e-4 + 2.0**-23, f"the (1, 2) step's updates against (1, 1): max err {s_upd:.3g}, {ss_upd:.3g}")
    check(one_counts == {"narrow": 4, "wide": 0, "backward": 4, "splat": 0, "splat_backward": 0}
          and space_train_launches == {"narrow": 8, "wide": 0, "backward": 8, "splat": 0, "splat_backward": 0}
          and small_launches == space_train_launches,
          f"training step launches: (1, 1) {one_counts}, (1, 2) {space_train_launches}; expected K1 and the backward 4, "
          f"and twice that on two bands")
    del stepped, grads1, grads_s, grads_p, deltas1, deltas_s, grads1s, grads_ss, deltas1s, deltas_ss
    # steps/s, one device against the (1, 2) mesh in turns (TF32 at torch's
    # defaults, as phase 50)
    trainers74 = {key: rife_trainer(dev, torch.float32, mesh=m)[1] for key, m in (("one device", mesh1), ("(1, 2) mesh", mesh_s))}
    for step in trainers74.values():
        for _ in range(2):
            step(*batch74)
    windows74 = {key: [] for key in trainers74}
    for i in range(4):
        for key in (list(trainers74) if i % 2 == 0 else list(trainers74)[::-1]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                trainers74[key](*batch74)
            torch.cuda.synchronize()
            windows74[key].append(5 / (time.perf_counter() - t1))
    space_train_rows = {key: {"steps_per_s": statistics.median(v), "windows": v} for key, v in windows74.items()}
    del trainers74, batch74, batch74s
    torch.cuda.empty_cache()
    print(
        f"space train {card}: RIFE 4.7 step b{TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]} f32 (TF32 off, cuDNN deterministic) on a "
        f"(1, 2) mesh of replicas against (1, 1): loss {loss_s:.7f} vs {loss1:.7f}, gradients within {s_rel:.3g} of each tensor's "
        f"largest ({s_worst}), {s_glob:.3g} of the largest of all (the (1, 1) step with every weight times 1 + 2^-22 moves "
        f"{p_rel:.3g} of {p_worst}'s largest), updates where |g| is over half its largest within {s_upd:.3g}; at b2 x 128^2 "
        f"loss {loss_ss:.7f} vs {loss1s:.7f}, gradients within {ss_rel:.3g} ({ss_worst}), updates within {ss_upd:.3g}; "
        f"launches (1, 1) {one_counts}, (1, 2) {space_train_launches}; steps/s (TF32 defaults, median of 4 windows of 5): "
        + ", ".join(f"{k} {v['steps_per_s']:.2f} ({', '.join(f'{w:.2f}' for w in v['windows'])})" for k, v in space_train_rows.items())
        + f"; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 75. M2M 1080p through the pair-cached split on a (1, 2) mesh of replicas ---------
    clock("75")
    # 3 frames x2 at b2 (two pairs, one reuse and one infer call), the rows in
    # bands of 576 + 504 (the replicate pad to 1088 in the second) against
    # one device: f32 with TF32 off and cuDNN's deterministic algorithms
    # (each run also against itself: K2's f32 atomics sum in an order that
    # changes from run to run), bf16 against the f32 one-device frames;
    # launches read, frames/s in turns, peak memory and a profile of each
    t0 = time.perf_counter()
    mclip75 = torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=75)).to(dev)
    mplan75 = plan_timestep(3, 2)
    m2m_space_rows, m2m_space_out, m2m_f32_settings = {}, {}, {}
    m2m_space_launches = {"narrow": 0, "wide": 0, "splat": 0}
    m2m_params75 = m2m.init_params(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        pair1 = m2m.make_pair_fns(m2m_params75, dtype=dtype, device=dev)
        pair2 = parallel.make_sharded_pair_fns(lambda d: pair1, mesh_s)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            one_out, one_n, one_peak = executor_run(run_plan_pair_cached, mclip75, mplan75, *pair1, batch_size=2)
            two_out, two_n, two_peak = executor_run(run_plan_pair_cached, mclip75, mplan75, *pair2, batch_size=2)
            if dtype == torch.float32:
                two_again, _, _ = executor_run(run_plan_pair_cached, mclip75, mplan75, *pair2, batch_size=2)
                one_again, _, _ = executor_run(run_plan_pair_cached, mclip75, mplan75, *pair1, batch_size=2)
                m2m_f32_settings = {"split_repeat_max_abs_diff": (two_again - two_out).abs().max().item(),
                                    "one_device_repeat_max_abs_diff": (one_again - one_out).abs().max().item()}
                del two_again, one_again
        finally:
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        check(one_n == {"narrow": 4, "wide": 16, "splat": 1} and two_n == {"narrow": 8, "wide": 32, "splat": 2},
              f"M2M {name} launches: one device {one_n}, the (1, 2) mesh {two_n}; expected K1 4, wide 16, K2 1 and twice that")
        check(tuple(two_out.shape) == (5, 1080, 1920, 3) and bool(torch.isfinite(two_out).all()),
              f"M2M {name} on the (1, 2) mesh: {tuple(two_out.shape)}, finite {bool(torch.isfinite(two_out).all())}")
        m2m_space_launches = {k: m2m_space_launches[k] + two_n[k] for k in m2m_space_launches}
        m2m_space_out[name] = (one_out, two_out)
        # frames/s of one pair batch each (a reuse and an infer at b2), in
        # turns, and each one's profile
        f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
        f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
        tt = torch.full((2,), 0.5, device=dev)
        calls = {"one device": pair1, "(1, 2) mesh": pair2}

        def pair_call(fns):
            return lambda a, b, t: fns[1](a, b, fns[0](a, b), t)

        fps = {key: [] for key in calls}
        for key in ("one device", "(1, 2) mesh", "(1, 2) mesh", "one device"):
            fps[key].append(2 / measure(pair_call(calls[key]), f0, f1, tt, iters=3, rounds=1))
        totals = {key: {} for key in calls}
        for key, fns in calls.items():
            profile_forward(f"M2M 1080p {name} b2 (reuse + infer), {key}", pair_call(fns), f0, f1, tt, card=card,
                            unit="pair batch", totals=totals[key])
        m2m_space_rows[name] = {
            key: {"frames_per_s": statistics.mean(fps[key]), "frames_per_s_turns": fps[key],
                  "peak_run_plan_pair_cached_bytes": one_peak if key == "one device" else two_peak,
                  "idle_share": totals[key]["idle_share"], "device_ms": totals[key]["device_ms"],
                  "wall_ms": totals[key]["wall_ms"], "kernels": totals[key]["kernels"]}
            for key in fps
        }
        del pair1, pair2, calls, f0, f1, tt
        torch.cuda.empty_cache()
    m2m_f32_err = (m2m_space_out["float32"][1] - m2m_space_out["float32"][0]).abs().max().item()
    check(m2m_f32_err <= 1e-4, f"M2M f32 on the (1, 2) mesh: max abs {m2m_f32_err} from one device, above 1e-4")
    m2m_bf16_db = psnr(m2m_space_out["bfloat16"][1], m2m_space_out["float32"][0])
    m2m_bf16_one_db = psnr(m2m_space_out["bfloat16"][0], m2m_space_out["float32"][0])
    check(m2m_bf16_db >= 40.0, f"M2M bf16 on the (1, 2) mesh: {m2m_bf16_db:.2f} dB against the f32 one-device frames, below 40")
    del m2m_space_out, mclip75
    # every family's training step splits too (phases 92-93); a step whose
    # model runs an op without a rule (a stand-in: a convolution, then a
    # running sum down the rows) still raises at that op on the mesh, naming
    # ROADMAP.md's item, and moves no parameter
    raised75 = {}
    tall = torch.rand((2, 128, 128, 3), device=dev)
    stand_in = row_op_stand_in().to(dev)
    before75 = [p.detach().clone() for p in stand_in.parameters()]
    step75 = parallel.make_train_step(lambda n, a, b, tt: n(a, b), torch.optim.Adam(stand_in.parameters(), lr=1e-4), mesh_s,
                                      stand_in)
    try:
        step75(tall, tall.flip(1), torch.full((2,), 0.5, device=dev), tall)
        check(False, "a training step on a (1, 2) mesh through an op without a row-band rule did not raise")
    except NotImplementedError as e:
        check(str(e).startswith("Tensor.cumsum has no row-band rule") and "ROADMAP.md Queue 1 item 3" in str(e),
              f"a training step through Tensor.cumsum on a (1, 2) mesh raised {e}")
        raised75["a step through a running sum down the rows"] = str(e).split(" has no row-band rule")[0]
    check(all(torch.equal(p, q) for p, q in zip(stand_in.parameters(), before75)), "the refused step moved a parameter")
    del stand_in, step75, before75
    del tall
    torch.cuda.empty_cache()
    print(
        f"space {card}: M2M 1080p x2 b2 (3 frames, 2 mids) through make_sharded_pair_fns + run_plan_pair_cached on a (1, 2) mesh "
        f"of replicas of the card, bands {band_rows(1080, 2)} (padded {band_rows(1088, 2)}): f32 (TF32 off, cuDNN deterministic) "
        f"max abs {m2m_f32_err:.3g} from one device, the (1, 2) run against itself "
        f"{m2m_f32_settings['split_repeat_max_abs_diff']:.3g}, one device against itself "
        f"{m2m_f32_settings['one_device_repeat_max_abs_diff']:.3g}; bf16 {m2m_bf16_db:.2f} dB against the f32 one-device frames "
        f"(one device bf16 {m2m_bf16_one_db:.2f} dB); launches {m2m_space_launches} for the two runs (K1 8, wide 32, K2 2 a "
        f"pair batch); " + "; ".join(
            f"{name} {key}: {r['frames_per_s']:.2f} frames/s (turns {', '.join(f'{v:.2f}' for v in r['frames_per_s_turns'])}), "
            f"run_plan_pair_cached peak {r['peak_run_plan_pair_cached_bytes'] / 2**30:.3f} GiB, idle share {r['idle_share']:.4f}, "
            f"{r['kernels']} kernels"
            for name, rows_ in m2m_space_rows.items() for key, r in rows_.items()
        ) + f"; the stand-in training step that raises on the axis, at: {raised75}; phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 76. K2 with a band of sources: M2M 1080p b2's splat in two partials -------------
    clock("76")
    # [16, 1088, 1920, 4] in the bands 576 + 512 of the (1, 2) mesh, each
    # band's sources splat from their first row into a whole-frame f32
    # partial; the partials' sum against the whole-frame kernel and the
    # twin (phase 7's tolerances); the second band timed in turns with the
    # whole frame, the twin's band and the library call on its grid
    t0 = time.perf_counter()
    splat_spans = band_rows(SPLAT_SHAPE[1], 2)
    ho = SPLAT_SHAPE[1]
    sband_err, sband_ms = {}, {}
    sflow = torch.from_numpy(warp_cases.smooth_flow(*SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        vals = torch.rand(SPLAT_SHAPE, generator=g).to(dev, dtype)
        planes, fplanes = vals.permute(0, 3, 1, 2), sflow.permute(0, 3, 1, 2)
        whole = softsplat_kernel.softsplat_bilinear(planes, fplanes)
        same = softsplat_kernel.softsplat_bilinear(planes, fplanes, row0=0, out_rows=ho)
        total = torch.zeros_like(whole)
        errs = []
        for row0, rows in splat_spans:
            vb, fb = planes[:, :, row0 : row0 + rows], fplanes[:, :, row0 : row0 + rows]
            part = softsplat_kernel.softsplat_bilinear(vb, fb, row0=row0, out_rows=ho)
            twin = softsplat_torch(vals[:, row0 : row0 + rows].float(), sflow[:, row0 : row0 + rows], row0=row0, out_rows=ho)
            torch.cuda.synchronize()
            e = (part.permute(0, 2, 3, 1) - twin).abs().max().item()
            check(e <= SPLAT_F32_ATOL, f"K2 band rows {row0}-{row0 + rows} of {list(SPLAT_SHAPE)} {dtype}: max err {e} against the twin's band")
            errs.append(e)
            total += part
            del part, twin
        ref = softsplat_torch(vals, sflow)
        torch.cuda.synchronize()
        e_same = (same - whole).abs().max().item()
        e_whole = (total - whole).abs().max().item()
        check(max(e_same, e_whole) <= SPLAT_F32_ATOL,
              f"K2's bands at {list(SPLAT_SHAPE)} {dtype}: row0=0 {e_same}, the partials' sum {e_whole} from the whole-frame kernel")
        summed = total.permute(0, 2, 3, 1).to(dtype)
        if dtype == torch.float32:
            e_twin = (summed - ref).abs().max().item()
            check(e_twin <= SPLAT_F32_ATOL, f"K2's partials summed at {list(SPLAT_SHAPE)} f32: max err {e_twin} against the twin")
        else:
            e_twin = (summed.float() - ref.float()).abs().max().item()
            check(bf16_ulp_ok(summed, ref), f"K2's partials summed at {list(SPLAT_SHAPE)} bf16: max err {e_twin}, above one ulp of the twin")
        sband_err[f"{list(SPLAT_SHAPE)} {str(dtype).split('.')[-1]}"] = {
            "band_vs_twin_band": max(errs), "row0_0_vs_whole": e_same, "sum_vs_whole_kernel": e_whole, "sum_vs_twin": e_twin}
        if dtype == torch.bfloat16:
            row0, rows = splat_spans[1]
            vb, fb = planes[:, :, row0 : row0 + rows], fplanes[:, :, row0 : row0 + rows]
            library = library_splat(vals[:, row0 : row0 + rows], sflow[:, row0 : row0 + rows], row0=row0, out_rows=ho)
            times = in_turns({
                "K2 band": (lambda: softsplat_kernel.softsplat_bilinear(vb, fb, row0=row0, out_rows=ho), 20),
                "K2 whole frame": (lambda: softsplat_kernel.softsplat_bilinear(planes, fplanes), 20),
                "plain band": (lambda: softsplat_torch(vals[:, row0 : row0 + rows], sflow[:, row0 : row0 + rows], row0=row0, out_rows=ho), 3),
                "library band": (library, 10),
            })
            sband_ms = {k: statistics.mean(v) for k, v in times.items()}
            sband_ms["bound_ms"], sband_ms["bound_by"] = bound(*splat_band_work(vb, fb, ho))
            sband_ms["whole_frame_bound_ms"] = bound(*splat_work(planes, fplanes))[0]
            del library, vb, fb
        del vals, planes, fplanes, whole, same, total, ref, summed
    del sflow
    torch.cuda.empty_cache()
    print(
        f"K2 band {card}: {list(SPLAT_SHAPE)} (smooth flow, amp 8) in bands {splat_spans}, each band's partial a whole-frame f32 "
        f"[16, 4, {ho}, 1920]: " + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.3g}" for n, v in e.items()) for k, e in sband_err.items())
        + f"; the second band bf16: " + ", ".join(f"{k} {v:.4f} ms" for k, v in sband_ms.items() if k != "bound_by")
        + f" ({sband_ms['bound_by']}), K2's band at {100 * sband_ms['bound_ms'] / sband_ms['K2 band']:.1f} % of its bound; "
        f"phase {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    # ---- 77-78. XVFI Vimeo (pair-cached) and FILM 1080p through the split -------------------
    clock("77-78")
    # on the (1, 2) mesh of replicas, each as phase 75: 3 frames x2 at b2 (one
    # batch), rows in bands of 576 + 504 (XVFI's zero pad to 1088 in the
    # second), against one device: f32 with TF32 off and cuDNN's
    # deterministic algorithms (each run also against itself where K2 runs), bf16 against
    # the f32 one-device frames; the launches of K1, the wide kernel and K2
    # twice one device's; every launch of one bf16 split call made again on
    # its band against the plain version; frames/s in turns (one round in
    # bf16), peak memory and a profile of each
    def space_split_phase(label, executor, shard, make, clip, plan, want_one, call, bf16_within_db=None, cudnn_benchmark=False,
                          batch=2, window4=False, calls=1, bf16_floor_db=None, f32_nudge=False):
        """``make(dtype)`` -> one device's callable(s) for ``executor`` (a
        tuple for the pair-cached one), ``shard`` the matching
        ``parallel.make_sharded_*``, ``call(fns)`` one batch's forward of
        ``(f0, f1, t)``, or with ``window4`` of ``(f0, f1, f2, f3)`` (the
        window-4 models through ``run_plan_window4``), ``batch`` windows or
        pairs a call; ``clip`` 3 frames of 1080 rows (AMT's padded to 1088;
        Sepconv's 720p; 4-5 for the window-4 models). bf16 on the mesh is held at 40 dB or more
        against the f32 one-device frames, or with ``bf16_within_db`` within
        that many dB of one device's bf16; with ``bf16_floor_db`` too, at
        that floor where one device's bf16 reaches it and within
        ``bf16_within_db`` of it where it does not. ``calls`` is the number
        of batch calls the executor makes (a timed or captured call is one).
        With ``f32_nudge`` one device also runs in f32 on the clip with every
        value one f32 ulp up (``torch.nextafter``), and the split's f32 gap
        is held within twice that run's gap from one device where that is
        above 1e-4: GMFSS's global softmaxes at 1080p move one device's own
        frames by ~1e-2 for such a nudge. The re-bands of one bf16 split
        call are counted (``parallel.space.rebands`` and ``rows_moved``).
        ``cudnn_benchmark`` lets cuDNN time its algorithms for the f32 runs
        held to each other (CAIN's f32 convolutions at 1080p with TF32 off take
        ~48 s a b2 forward on the algorithm its heuristics pick, ~0.2 s on
        the one it times). Returns the row of the kernels line."""
        height, width = clip.shape[1], clip.shape[2]
        as_args = lambda fns: fns if isinstance(fns, tuple) else (fns,)  # noqa: E731
        outs, rows, settings, launches = {}, {}, {}, {"narrow": 0, "wide": 0, "splat": 0}
        bands, band_err, rebands, secs = {}, 0.0, {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            one = make(dtype)
            two = shard(lambda d: one, mesh_s)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            bench = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = bench or (cudnn_benchmark and dtype == torch.float32)
            try:
                ts = time.perf_counter()
                one_out, one_n, one_peak = executor_run(executor, clip, plan, *as_args(one), batch_size=batch)
                secs[f"{name} one device"] = time.perf_counter() - ts
                ts = time.perf_counter()
                two_out, two_n, two_peak = executor_run(executor, clip, plan, *as_args(two), batch_size=batch)
                secs[f"{name} (1, 2) mesh"] = time.perf_counter() - ts
                if dtype == torch.float32 and want_one(dtype)["splat"]:
                    # K2's f32 atomics sum in an order that changes from run
                    # to run; without them, deterministic cuDNN repeats bits
                    ts = time.perf_counter()
                    two_again, _, _ = executor_run(executor, clip, plan, *as_args(two), batch_size=batch)
                    one_again, _, _ = executor_run(executor, clip, plan, *as_args(one), batch_size=batch)
                    secs["f32 both again"] = time.perf_counter() - ts
                    settings = {"split_repeat_max_abs_diff": (two_again - two_out).abs().max().item(),
                                "one_device_repeat_max_abs_diff": (one_again - one_out).abs().max().item()}
                    del two_again, one_again
                if dtype == torch.float32:
                    if f32_nudge:
                        ts = time.perf_counter()
                        nudged, _, _ = executor_run(executor, torch.nextafter(clip, torch.full_like(clip, 2.0)), plan,
                                                    *as_args(one), batch_size=batch)
                        secs["f32 one device, inputs one ulp up"] = time.perf_counter() - ts
                        settings["one_device_one_ulp_input_max_abs_diff"] = (nudged - one_out).abs().max().item()
                        del nudged
            finally:
                torch.backends.cudnn.benchmark = bench
                torch.backends.cudnn.deterministic = det
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            want = want_one(dtype)
            check(one_n == want and two_n == {k: 2 * v for k, v in want.items()},
                  f"{label} {name} launches: one device {one_n}, the (1, 2) mesh {two_n}; expected {want} and twice that")
            check(tuple(two_out.shape) == (len(plan.output), height, width, 3) and bool(torch.isfinite(two_out).all()),
                  f"{label} {name} on the (1, 2) mesh: {tuple(two_out.shape)}, finite {bool(torch.isfinite(two_out).all())}")
            launches = {k: launches[k] + two_n[k] for k in launches}
            outs[name] = (one_out, two_out)
            if dtype != torch.bfloat16:
                del one, two
                torch.cuda.empty_cache()
                continue
            frames_in = [
                torch.from_numpy(np.random.default_rng(k).random((batch, height, width, 3), dtype=np.float32)).to(dev)
                for k in range(4 if window4 else 2)
            ]
            inputs = (*frames_in, *(() if window4 else (torch.full((batch,), 0.5, device=dev),)))
            # each band's launches of one split call, against the plain
            # versions, and the call's re-bands
            store = []
            parallel.space.rebands = parallel.space.rows_moved = 0
            ts = time.perf_counter()
            with captured_band_launches(store):
                call(two)(*inputs)
            torch.cuda.synchronize()
            secs["bf16 split call captured"] = time.perf_counter() - ts
            rebands = {"rebands": parallel.space.rebands, "rows_moved": parallel.space.rows_moved}
            bands, band_err = band_launches_vs_plain(store, f"{label} bf16 on the (1, 2) mesh")
            check(len(store) * calls == sum(two_n.values()),
                  f"{label}: {len(store)} launches captured in one of the run's {calls} calls, the run made {two_n}")
            del store
            torch.cuda.empty_cache()
            calls = {"one device": one, "(1, 2) mesh": two}
            fps = {key: [] for key in calls}
            ts = time.perf_counter()
            for key in ("one device", "(1, 2) mesh", "(1, 2) mesh", "one device"):
                fps[key].append(batch / measure(call(calls[key]), *inputs, iters=3, rounds=1))
            secs["bf16 timing"] = time.perf_counter() - ts
            ts = time.perf_counter()
            totals = {key: {} for key in calls}
            for key, fns in calls.items():
                profile_forward(f"{label} {height}x{width} {name} b{batch}, {key}", call(fns), *inputs, card=card, unit="batch",
                                totals=totals[key])
            secs["bf16 profiles"] = time.perf_counter() - ts
            rows[name] = {
                key: {"frames_per_s": statistics.mean(fps[key]), "frames_per_s_turns": fps[key],
                      "peak_executor_bytes": one_peak if key == "one device" else two_peak,
                      "idle_share": totals[key]["idle_share"], "device_ms": totals[key]["device_ms"],
                      "wall_ms": totals[key]["wall_ms"], "kernels": totals[key]["kernels"], "cat_ms": totals[key]["cat_ms"]}
                for key in fps
            }
            del one, two, calls, frames_in, inputs
            torch.cuda.empty_cache()
        f32_err = (outs["float32"][1] - outs["float32"][0]).abs().max().item()
        f32_tol = max(1e-4, 2 * settings.get("one_device_one_ulp_input_max_abs_diff", 0.0))
        check(f32_err <= f32_tol, f"{label} f32 on the (1, 2) mesh: max abs {f32_err} from one device, above {f32_tol:.3g}"
              + (f" (twice one device's own gap for inputs one ulp up)" if f32_tol > 1e-4 else ""))
        bf16_db = psnr(outs["bfloat16"][1], outs["float32"][0])
        bf16_one_db = psnr(outs["bfloat16"][0], outs["float32"][0])
        if bf16_within_db is None or (bf16_floor_db is not None and bf16_one_db >= bf16_floor_db):
            floor = 40.0 if bf16_floor_db is None else bf16_floor_db
            check(bf16_db >= floor, f"{label} bf16 on the (1, 2) mesh: {bf16_db:.2f} dB against the f32 one-device frames, below {floor}")
        else:
            check(bf16_db >= bf16_one_db - bf16_within_db,
                  f"{label} bf16 on the (1, 2) mesh: {bf16_db:.2f} dB against the f32 one-device frames, more than "
                  f"{bf16_within_db} dB below one device's bf16 ({bf16_one_db:.2f} dB)")
        return {"rows": height, "cols": width, "batch": batch, "frames": clip.shape[0], "mids": len(plan.tasks),
                "f32_max_abs_err": f32_err, "f32_settings": settings, "bf16_psnr_db": bf16_db,
                "bf16_one_device_psnr_db": bf16_one_db, "rebands_per_bf16_batch": rebands, "seconds": secs,
                "launches": launches, "bands": {k: [[list(b), r, a, d] for b, r, a, d in v] for k, v in bands.items()},
                "band_max_abs_err": band_err, "runs": rows}

    def space_split_line(number, label, row, t0):
        print(
            f"space {card}: phase {number}: {label} {row['rows']}x{row['cols']} x2 b{row['batch']} ({row['frames']} frames, "
            f"{row['mids']} mids) on a (1, 2) mesh of "
            f"replicas of the card, "
            f"bands {band_rows(row['rows'], 2)}: f32 (TF32 off, cuDNN deterministic) max abs {row['f32_max_abs_err']:.3g} from one "
            f"device"
            + (f", the (1, 2) run against itself {row['f32_settings']['split_repeat_max_abs_diff']:.3g}, one device against "
               f"itself {row['f32_settings']['one_device_repeat_max_abs_diff']:.3g}"
               if "split_repeat_max_abs_diff" in row["f32_settings"] else "")
            + (f", one device for inputs one ulp up {row['f32_settings']['one_device_one_ulp_input_max_abs_diff']:.3g}"
               if "one_device_one_ulp_input_max_abs_diff" in row["f32_settings"] else "")
            + f"; bf16 {row['bf16_psnr_db']:.2f} dB against the "
            f"f32 one-device frames (one device bf16 {row['bf16_one_device_psnr_db']:.2f} dB); launches {row['launches']} for the "
            f"two split runs; each band's launch of one bf16 split call against its plain version (max err "
            f"{row['band_max_abs_err']:.3g}): " + "; ".join(f"{k} {v}" for k, v in row["bands"].items())
            + f"; re-bands of one bf16 split batch {row['rebands_per_bf16_batch']}; "
            + "; ".join(
                f"{name} {key}: {r['frames_per_s']:.3f} frames/s (turns {', '.join(f'{v:.3f}' for v in r['frames_per_s_turns'])}), "
                f"executor peak {r['peak_executor_bytes'] / 2**30:.3f} GiB, idle share {r['idle_share']:.4f}, {r['kernels']} kernels, "
                f"aten::cat {r['cat_ms']:.3f} of {r['device_ms']:.3f} device ms"
                for name, rows_ in row["runs"].items() for key, r in rows_.items()
            ) + f"; seconds {', '.join(f'{k} {v:.1f}' for k, v in row['seconds'].items())}; phase {time.perf_counter() - t0:.1f} s",
            flush=True,
        )

    t0 = time.perf_counter()
    xvfi_ckpt = "XVFInet_Vimeo_exp1_latest.pt"
    xvfi_params77 = xvfi.init_params(xvfi_ckpt, 0)

    def xvfi_want(dtype):
        per = {k: xvfi.warps_per_reuse(xvfi_ckpt, dtype)[k] + xvfi.warps_per_infer(dtype)[k] for k in ("narrow", "wide")}
        return {**per, "splat": xvfi.splats_per_infer()}

    xvfi_space = space_split_phase(
        "XVFI Vimeo", run_plan_pair_cached, parallel.make_sharded_pair_fns,
        lambda dtype: xvfi.make_pair_fns(xvfi_params77, xvfi_ckpt, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=77)).to(dev), plan_timestep(3, 2), xvfi_want,
        lambda fns: (lambda a, b, t: fns[1](a, b, fns[0](a, b), t)),
    )
    del xvfi_params77
    space_split_line(77, "XVFI Vimeo (pair-cached: reuse + infer)", xvfi_space, t0)

    t0 = time.perf_counter()
    film_params78 = film.init_params(0)
    film_space = space_split_phase(
        "FILM", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: film.make_model_fn(film_params78, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=78)).to(dev), plan_timestep(3, 2),
        lambda dtype: {**film.warps_per_forward(dtype), "splat": 0}, lambda fn: fn,
    )
    del film_params78
    space_split_line(78, "FILM", film_space, t0)

    # ---- 79-81. IFRNet S, AMT S and IFUnet 1080p through the split ----------------------------
    clock("79-81")
    # each as phase 78 through make_sharded_model_fn + run_plan; AMT's clip
    # edge-padded to 1088 rows first, as its node pads (bands 576 + 512)
    t0 = time.perf_counter()
    ifrnet_params79 = ifrnet.init_params("S", 0)
    ifrnet_space = space_split_phase(
        "IFRNet S", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: ifrnet.make_model_fn(ifrnet_params79, "S", dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=79)).to(dev), plan_timestep(3, 2),
        lambda dtype: {**ifrnet.warps_per_forward("S", dtype), "splat": 0}, lambda fn: fn,
    )
    del ifrnet_params79
    space_split_line(79, "IFRNet S", ifrnet_space, t0)

    t0 = time.perf_counter()
    amt_params80 = amt.init_params("S", 0)
    amt_space = space_split_phase(
        "AMT S", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: amt.make_model_fn(amt_params80, "amt-s.pth", dtype=dtype, device=dev),
        _pad16(torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=80)).to(dev))[0], plan_timestep(3, 2),
        lambda dtype: {**amt.warps_per_forward("S", dtype), "splat": 0}, lambda fn: fn,
    )
    del amt_params80
    space_split_line(80, "AMT S (edge-padded to 1088 rows)", amt_space, t0)

    t0 = time.perf_counter()
    ifunet_params81 = ifunet.init_params(0)
    ifunet_space = space_split_phase(
        "IFUnet", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: ifunet.make_model_fn(ifunet_params81, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=81)).to(dev), plan_timestep(3, 2),
        lambda dtype: {**ifunet.warps_per_forward(dtype), "splat": 0}, lambda fn: fn,
    )
    del ifunet_params81
    space_split_line(81, "IFUnet", ifunet_space, t0)
    slice22 = {"ifrnet_space_2way": ifrnet_space, "amt_space_2way": amt_space, "ifunet_space_2way": ifunet_space}

    # ---- 82-84. XVFI X4K (pair-cached), CAIN and Sepconv through the split -------------------
    clock("82-84")
    # each as phases 77-81: X4K at 1080p (the zero pad to 1536 rows in the
    # second band; its pyramid to 1/128 starts that band at 4.5 rows, and the
    # flows from the coarser levels meet the features in other bands: the
    # re-banding rule), CAIN at 1080p (the centred reflect pad to 1152 starts
    # the second band at 612, which pixel_unshuffle(8) re-bands to 608; cuDNN
    # times its algorithms for CAIN's f32 runs, see space_split_phase) and
    # Sepconv at 720p; bf16 held within 0.5 dB of one device's bf16
    t0 = time.perf_counter()
    x4k_ckpt = "XVFInet_X4K1000FPS_exp1_latest.pt"
    x4k_params82 = xvfi.init_params(x4k_ckpt, 0)

    def x4k_want(dtype):
        per = {k: xvfi.warps_per_reuse(x4k_ckpt, dtype)[k] + xvfi.warps_per_infer(dtype)[k] for k in ("narrow", "wide")}
        return {**per, "splat": xvfi.splats_per_infer()}

    x4k_space = space_split_phase(
        "XVFI X4K", run_plan_pair_cached, parallel.make_sharded_pair_fns,
        lambda dtype: xvfi.make_pair_fns(x4k_params82, x4k_ckpt, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=82)).to(dev), plan_timestep(3, 2), x4k_want,
        lambda fns: (lambda a, b, t: fns[1](a, b, fns[0](a, b), t)), bf16_within_db=0.5,
    )
    del x4k_params82
    space_split_line(82, "XVFI X4K (pair-cached: reuse + infer)", x4k_space, t0)

    t0 = time.perf_counter()
    cain_params83 = cain.init_params(0)
    cain_space = space_split_phase(
        "CAIN", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: cain.make_model_fn(cain_params83, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=83)).to(dev), plan_timestep(3, 2),
        lambda dtype: {"narrow": 0, "wide": 0, "splat": 0}, lambda fn: fn, bf16_within_db=0.5, cudnn_benchmark=True,
    )
    del cain_params83
    space_split_line(83, "CAIN", cain_space, t0)

    t0 = time.perf_counter()
    sepconv_params84 = sepconv_conditioned(0)
    sepconv_space = space_split_phase(
        "Sepconv", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: sepconv.make_model_fn(sepconv_params84, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 720, 1280, seed=84)).to(dev), plan_timestep(3, 2),
        lambda dtype: {"narrow": 0, "wide": 0, "splat": 0}, lambda fn: fn, bf16_within_db=0.5,
    )
    del sepconv_params84
    space_split_line(84, "Sepconv (conditioned weights)", sepconv_space, t0)
    slice23 = {"xvfi_x4k_space_2way": x4k_space, "cain_space_2way": cain_space, "sepconv_space_2way": sepconv_space}

    # ---- 85-86. FLAVR 2x and STMFNet through the split (run_plan_window4) ---------------------
    clock("85-86")
    # the window-4 models through make_sharded_model_fn + run_plan_window4
    # (four frames a window), each as phases 77-84: FLAVR at 1080p
    # edge-padded to 1088 rows as its node pads (bands 576 + 512), 5 frames,
    # b2 (one batch of two windows; no hand kernel); STMFNet at 1080p, 4
    # frames, b1 (one window: its reflect pad to 1152 rows puts 72 rows in
    # the second band, 576 + 576), K1 6, wide 4 and K2 1 a forward on one
    # device and exactly twice on the mesh, each band's launch against its
    # plain version. Their f32 runs take cuDNN's heuristic algorithms: with
    # cudnn.benchmark, timing FLAVR's f32 3-D algorithms at 1088 rows took
    # ~220 s a first call, the heuristic's first call ~4 s
    t0 = time.perf_counter()
    flavr_params85 = flavr.init_params(0)
    flavr_space = space_split_phase(
        "FLAVR 2x", run_plan_window4, parallel.make_sharded_model_fn,
        lambda dtype: flavr.make_model_fn(flavr_params85, dtype=dtype, device=dev),
        _pad16(torch.from_numpy(shifted_pattern(5, 1080, 1920, seed=85)).to(dev))[0], plan_window4(5),
        lambda dtype: {"narrow": 0, "wide": 0, "splat": 0}, lambda fn: fn, window4=True,
    )
    del flavr_params85
    space_split_line(85, "FLAVR 2x (edge-padded to 1088 rows)", flavr_space, t0)

    t0 = time.perf_counter()
    stmf_params86 = stmfnet.init_params(0)
    stmf_space = space_split_phase(
        "STMFNet", run_plan_window4, parallel.make_sharded_model_fn,
        lambda dtype: stmfnet.make_model_fn(stmf_params86, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(4, 1080, 1920, seed=86)).to(dev), plan_window4(4),
        lambda dtype: {**stmfnet.warps_per_forward(dtype), "splat": stmfnet.splats_per_forward()}, lambda fn: fn,
        bf16_within_db=0.5, batch=1, window4=True,
    )
    del stmf_params86
    space_split_line(86, "STMFNet", stmf_space, t0)
    slice24 = {"flavr_space_2way": flavr_space, "stmfnet_space_2way": stmf_space}

    # ---- 87-88. GMFSS Fortuna (base and union) and EISAI (pair-cached) through the split ---------
    clock("87-88")
    # each as phase 77 through make_sharded_pair_fns + run_plan_pair_cached
    # at b1 (the bench's batch: two pair batches, each a reuse and an infer
    # call): GMFSS at 1080p (bands 576 + 504, the zero pad to 1088 in the
    # second; GMFlow's global ops against keys gathered whole, K2's band
    # partials at C = 4-193), EISAI at 540p (bands 320 + 220; K2's at C =
    # 6-514 in f32); bf16 at 40 dB or more against the f32 one-device frames,
    # or within 0.5 dB of one device's bf16 where that is below 40. GMFSS's
    # f32 split is held within twice one device's own gap for its inputs one
    # ulp up (f32_nudge): its global correlation softmax at 1080p amplifies
    # f32 rounding to ~1e-2, the split's and the nudge's alike; the split
    # computes one device's
    # function (tests/test_torch_space_gmfss.py: f64 within 1e-6). cuDNN
    # times its algorithms for GMFSS's f32 runs: with TF32 off its
    # heuristics' choice takes ~6 s a one-device run of two pairs, a timed
    # one ~0.6 s after ~25 s of timing that base and union share
    slice25 = {}
    for union in (False, True):
        t0 = time.perf_counter()
        params87 = gmfss.init_params(0, union=union)

        def gmfss_want(dtype, union=union):
            per = {k: gmfss.warps_per_reuse(dtype)[k] + gmfss.warps_per_infer(union, dtype)[k] for k in ("narrow", "wide")}
            return {k: 2 * v for k, v in {**per, "splat": gmfss.splats_per_infer()}.items()}

        name87 = "GMFSS union" if union else "GMFSS base"
        slice25["gmfss_union_space_2way" if union else "gmfss_space_2way"] = row87 = space_split_phase(
            name87, run_plan_pair_cached, parallel.make_sharded_pair_fns,
            lambda dtype: gmfss.make_pair_fns(params87, union=union, dtype=dtype, device=dev),
            torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=87)).to(dev), plan_timestep(3, 2), gmfss_want,
            lambda fns: (lambda a, b, t: fns[1](a, b, fns[0](a, b), t)), batch=1, calls=2, bf16_within_db=0.5,
            bf16_floor_db=40.0, f32_nudge=True, cudnn_benchmark=True,
        )
        del params87
        space_split_line(87, f"{name87} (pair-cached: reuse + infer)", row87, t0)

    t0 = time.perf_counter()
    eisai_params88 = eisai.init_params(0)
    slice25["eisai_space_2way"] = eisai_space = space_split_phase(
        "EISAI", run_plan_pair_cached, parallel.make_sharded_pair_fns,
        lambda dtype: eisai.make_pair_fns(eisai_params88, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 540, 960, seed=88)).to(dev), plan_timestep(3, 2),
        lambda dtype: {**{k: 2 * v for k, v in eisai.warps_per_infer().items()}, "splat": 2 * eisai.splats_per_infer()},
        lambda fns: (lambda a, b, t: fns[1](a, b, fns[0](a, b), t)), batch=1, calls=2, bf16_within_db=0.5,
        bf16_floor_db=40.0,
    )
    del eisai_params88
    space_split_line(88, "EISAI (pair-cached: reuse + infer)", eisai_space, t0)

    # ---- 89-90. ATM and MoMo through the split (run_plan) -------------------------------------
    clock("89-90")
    # each as phase 78 through make_sharded_model_fn + run_plan at b1 (the
    # bench's batch: two forward calls of 3 frames x2 at 1080p). ATM base with
    # global motion (the node's default): its centred edge pad to 1088 rows
    # makes the bands 580 + 508, and Swin windows cross the band edge at 1/8
    # and 1/16; K1 12 and wide 4 a forward on one device
    # (atm.warps_per_forward), exactly twice on the mesh, each band's launch
    # of one bf16 split call against its plain version; then one f32 call with
    # the ensemble at 540p, K1 18 and wide 4 on one device, against one device.
    # MoMo base with the conditioned heads (momo_conditioned), 2 denoising
    # steps, its noise drawn from seed 0 for the whole batch on the first
    # band's device and cut into the bands; no hand kernel. f32 (TF32 off,
    # cuDNN deterministic) within twice one device's own gap for its inputs one
    # f32 ulp up, or 1e-4 where that is smaller (f32_nudge: MoMo's flows are
    # its latents x128); bf16 at 40 dB or more against the f32 one-device
    # frames (ATM), or within 0.5 dB of one device's bf16
    slice26 = {}
    t0 = time.perf_counter()
    atm_params89 = atm.init_params("base", 0)

    def atm_want(dtype, ensemble=False, forwards=2):
        return {k: forwards * v for k, v in {**atm.warps_per_forward("base", True, ensemble, dtype), "splat": 0}.items()}

    slice26["atm_sharded_2way"] = atm_space = space_split_phase(
        "ATM base", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: atm.make_model_fn(atm_params89, "base", dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=89)).to(dev), plan_timestep(3, 2), atm_want,
        lambda fn: fn, batch=1, calls=2, bf16_within_db=0.5, bf16_floor_db=40.0, f32_nudge=True,
    )
    # the ensemble: one f32 call at 540p, split against one device and one
    # device against itself for its inputs one f32 ulp up
    ens_one = atm.make_model_fn(atm_params89, "base", True, True, device=dev)
    ens_two = parallel.make_sharded_model_fn(lambda d: ens_one, mesh_s)
    pair89 = torch.from_numpy(shifted_pattern(2, 540, 960, seed=891)).to(dev)
    half = torch.full((1,), 0.5, device=dev)
    ens_out, ens_n = {}, {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        for key, fn, frames_ in (("one device", ens_one, pair89), ("(1, 2) mesh", ens_two, pair89),
                                 ("one device, inputs one ulp up", ens_one, torch.nextafter(pair89, torch.full_like(pair89, 2.0)))):
            torch.cuda.synchronize()
            zero_kernel_counts()
            ens_out[key] = fn(frames_[:1], frames_[1:], half).cpu()
            ens_n[key] = {k: v for k, v in kernel_counts().items() if k in ("narrow", "wide", "splat")}
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ens_want = atm_want(torch.float32, ensemble=True, forwards=1)
    check(ens_n["one device"] == ens_want and ens_n["(1, 2) mesh"] == {k: 2 * v for k, v in ens_want.items()},
          f"ATM base ensemble f32 launches: one device {ens_n['one device']}, the (1, 2) mesh {ens_n['(1, 2) mesh']}; "
          f"expected {ens_want} and twice that")
    ens_err = (ens_out["(1, 2) mesh"] - ens_out["one device"]).abs().max().item()
    ens_nudge = (ens_out["one device, inputs one ulp up"] - ens_out["one device"]).abs().max().item()
    check(tuple(ens_out["(1, 2) mesh"].shape) == (1, 540, 960, 3) and ens_err <= max(1e-4, 2 * ens_nudge),
          f"ATM base ensemble f32 540p on the (1, 2) mesh: max abs {ens_err} from one device, above max(1e-4, twice "
          f"{ens_nudge}, one device's own gap for its inputs one ulp up)")
    atm_space["ensemble_540p_f32"] = {"max_abs_err": ens_err, "one_device_one_ulp_input_max_abs_diff": ens_nudge,
                                      "launches": ens_n}
    del atm_params89, ens_one, ens_two, pair89, ens_out
    torch.cuda.empty_cache()
    space_split_line(89, "ATM base (global motion; edge-padded to 1088 rows inside)", atm_space, t0)
    print(f"space {card}: phase 89: ATM base ensemble 540p f32 on the (1, 2) mesh: max abs {ens_err:.3g} from one device "
          f"(one device for its inputs one ulp up {ens_nudge:.3g}); launches {ens_n}", flush=True)

    t0 = time.perf_counter()
    momo_params90 = momo_conditioned(momo.init_params(0, "momo-base.pth"))
    slice26["momo_sharded_2way"] = momo_space = space_split_phase(
        "MoMo base", run_plan, parallel.make_sharded_model_fn,
        lambda dtype: momo.make_model_fn(momo_params90, "momo-base.pth", num_inference_steps=2, dtype=dtype, device=dev),
        torch.from_numpy(shifted_pattern(3, 1080, 1920, seed=90)).to(dev), plan_timestep(3, 2),
        lambda dtype: {"narrow": 0, "wide": 0, "splat": 0}, lambda fn: fn, batch=1, calls=2, bf16_within_db=0.5,
        f32_nudge=True,
    )
    del momo_params90
    space_split_line(90, "MoMo base (conditioned heads, 2 steps; edge-padded to 1088 rows inside)", momo_space, t0)

    # ---- 91. the splat's backward kernel on a row band ----------------------------------------
    clock("91")
    # M2M's step input [64, 256, 256, 4] f32 (phase 54's: random values, smooth
    # flow of amplitude 8), and GMFSS's C = 65 and EISAI's C = 66 step inputs
    # (phase 63's, as the steps hand them over: the spread route), each in the
    # two bands of the (1, 2) mesh (the rows' halves at every level of the
    # 256-row frame). Each band's launch on the whole frame's output gradient
    # is the whole-frame launch's rows of its sources bit for bit; row0 = 0 at
    # the whole frame's height is the default call bit for bit; each band
    # against its plain version (softsplat_backward_torch with the band) within
    # phase 52's tolerances; device ms of each band in turns with the whole
    # frame's, its bound, the two library calls on the band
    # (splat_backward_library_call with row0) and the ops in turns
    t0 = time.perf_counter()
    band91_inputs = {
        f"M2M step input {list(M2M_TRAIN_SPLAT_SHAPE)} float32, smooth flow": (
            torch.rand(M2M_TRAIN_SPLAT_SHAPE, generator=g).to(dev).permute(0, 3, 1, 2),
            torch.from_numpy(warp_cases.smooth_flow(*M2M_TRAIN_SPLAT_SHAPE[:3], amp=8.0)).to(dev).permute(0, 3, 1, 2),
            (torch.rand(M2M_TRAIN_SPLAT_SHAPE, generator=g) * 2 - 1).to(dev).permute(0, 3, 1, 2), True),
        **band91_inputs,
    }
    sband91, sband91_err = {}, (0.0, 0.0)
    for key, (x, flow, gout, in_grad) in band91_inputs.items():
        nhwc = lambda t_: t_.permute(0, 2, 3, 1)  # noqa: E731
        hh = x.shape[2]
        spans91 = ((0, hh // 2), (hh // 2, hh - hh // 2))
        whole = softsplat_kernel.softsplat_bilinear_backward(x, flow, gout, in_grad)
        same = softsplat_kernel.softsplat_bilinear_backward(x, flow, gout, in_grad, 0, hh)
        torch.cuda.synchronize()
        check(torch.equal(same[0], whole[0]) and torch.equal(same[1], whole[1]),
              f"splat backward {key}: row0 = 0 at the whole frame's {hh} rows differs from the default call")
        contributions, _ = softsplat_backward_torch(nhwc(x).float(), nhwc(flow).float(), nhwc(gout).abs())
        rows91 = {}
        for a, n in spans91:
            xb, fb = x[:, :, a : a + n], flow[:, :, a : a + n]
            band = lambda xb=xb, fb=fb, a=a: softsplat_kernel.softsplat_bilinear_backward(xb, fb, gout, in_grad, a, hh)  # noqa: E731
            bi, bf = band()
            ri, rf = softsplat_backward_torch(nhwc(xb), nhwc(fb), nhwc(gout), a, hh)
            torch.cuda.synchronize()
            check(torch.equal(bi, whole[0][:, :, a : a + n]) and torch.equal(bf, whole[1][:, :, a : a + n]),
                  f"splat backward {key}: the band of rows {a}-{a + n} differs from the whole-frame launch's rows")
            ok_i, err_i = grad_within(nhwc(bi), ri, 4 * 2.0**-23 * contributions[:, a : a + n], x.dtype)
            ok_f, err_f = grad_within(nhwc(bf), rf, 1e-5 * rf.float().abs().max().item() + 1e-6, flow.dtype)
            check(ok_i and ok_f, f"splat backward {key}, band {a}-{a + n} vs plain: max err grad_in {err_i}, grad_flow {err_f}")
            sband91_err = (max(sband91_err[0], err_i), max(sband91_err[1], err_f))
            library = splat_backward_library_call(nhwc(xb), nhwc(fb), nhwc(gout), row0=a)
            whole_call = lambda: softsplat_kernel.softsplat_bilinear_backward(x, flow, gout, in_grad)  # noqa: E731
            dev_turns = {"band": [], "whole frame": []}
            for which in ("band", "whole frame", "whole frame", "band"):
                dev_turns[which].append(device_ms(band if which == "band" else whole_call, 10, name="softsplat_backward_kernel"))
            lib_ms = device_ms(library, 5)
            times = in_turns({"band": (band, 10), "plain band": (lambda xb=xb, fb=fb, a=a: softsplat_backward_torch(
                nhwc(xb), nhwc(fb), nhwc(gout), a, hh), 2), "two library calls on the band": (library, 5)})
            b = bound(*splat_backward_work(xb, fb, in_grad))
            rows91[f"rows {a}-{a + n}"] = {
                "kernel_device_ms": statistics.mean(dev_turns["band"]), "whole_frame_device_ms": statistics.mean(dev_turns["whole frame"]),
                "device_ms_turns": dev_turns, "bound_ms": b[0], "bound_by": b[1], "library_device_ms": lib_ms,
                "ms": statistics.mean(times["band"]), "plain_ms": statistics.mean(times["plain band"]),
                "library_ms": statistics.mean(times["two library calls on the band"]), "turns": times,
                "max_abs_err": (err_i, err_f),
            }
            del bi, bf, ri, rf
        sband91[key] = rows91
        print(f"splat backward band {card}: {key}, bands {spans91} of {hh} rows: each band's launch the whole frame's rows "
              "bit for bit; " + "; ".join(
                  f"{k}: the kernel {r['kernel_device_ms']:.4f} ms on the device (whole frame {r['whole_frame_device_ms']:.4f}), "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}), two library calls {r['library_device_ms']:.4f}; ops in turns band "
                  f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} ms; max err {r['max_abs_err']}"
                  for k, r in rows91.items()), flush=True)
        del whole, same, contributions
    sband91_main = sband91[next(iter(band91_inputs))][f"rows {M2M_TRAIN_SPLAT_SHAPE[1] // 2}-{M2M_TRAIN_SPLAT_SHAPE[1]}"]
    del band91_inputs
    torch.cuda.empty_cache()
    print(f"splat backward band: phase 91 {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 92. M2M's training step on the (1, 2) mesh of replicas ------------------------------
    clock("92")
    # b8 x 256^2 f32 (phase 54's size; two bands of 128 rows) through
    # make_train_step against one device (space_train_phase): launches
    # exactly twice one device's (K1 8, wide 32, K2 2, the warp's backward
    # 40, the splat's 2); steps/s in turns, peak memory, a profile of each
    t0 = time.perf_counter()
    m2m_train_space = space_train_phase(
        f"M2M training step b{M2M_TRAIN_BATCH} x {M2M_TRAIN_HW[0]}x{M2M_TRAIN_HW[1]} f32",
        lambda mesh: m2m_trainer(dev, torch.float32, mesh), train_batch(M2M_TRAIN_BATCH, M2M_TRAIN_HW, 92, dev, torch.float32),
        M2M_TRAIN_LAUNCHES, mesh1, mesh_s, card, timed=True,
    )
    print(
        f"space train {card}: M2M step b{M2M_TRAIN_BATCH} x {M2M_TRAIN_HW[0]}x{M2M_TRAIN_HW[1]} f32 (TF32 off, cuDNN "
        f"deterministic) on the (1, 2) mesh against one device: loss {m2m_train_space['loss']:.7f} vs "
        f"{m2m_train_space['loss_one_device']:.7f}, gradients within {m2m_train_space['grad_rel_err']:.3g} of each tensor's "
        f"largest ({m2m_train_space['grad_rel_worst']}; {m2m_train_space['grad_err_over_largest_of_all']:.3g} of the largest of "
        f"all; one device's larger move for its inputs one ulp up or its weights two {m2m_train_space['one_device_move_grad_rel']:.3g}, "
        f"{m2m_train_space['one_device_move_grad_rel_worst']}); launches "
        f"{m2m_train_space['launches']}; " + "; ".join(
            f"{k}: {r['steps_per_s']:.3f} steps/s (turns {', '.join(f'{v:.3f}' for v in r['steps_per_s_turns'])}), peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, idle share {r['idle_share']:.4f}, {r['kernels']} kernels"
            for k, r in m2m_train_space["training"].items()) + f"; phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 93. the other unblocked steps on the (1, 2) mesh ----------------------------------------
    clock("93")
    # GMFSS base, EISAI (12 iterations), XVFI Vimeo and AMT S, one f32 step
    # each at b2 x 256^2 on the mesh against one device, as phase 92 holds
    # M2M's (family_trainer on the mesh), launches exactly twice
    # FAMILY_STEP_LAUNCHES; no timed rounds
    t0 = time.perf_counter()
    slice27 = {}
    for name93 in ("gmfss", "eisai", "xvfi", "amt"):
        t1 = time.perf_counter()
        frames93, t93, target93 = family_batch(name93, 2, FAMILY_TRAIN_HW, 93, dev)

        def make93(mesh, name93=name93):
            net93, step93 = family_trainer(name93, dev, mesh)
            return net93, (lambda a, b, tt, tgt: step93([a, b], tt, tgt))

        slice27[f"{name93}_train_space_2way"] = row93 = space_train_phase(
            f"{name93} training step b2 x {FAMILY_TRAIN_HW[0]}x{FAMILY_TRAIN_HW[1]} f32", make93,
            (*frames93, t93, target93), FAMILY_STEP_LAUNCHES[name93], mesh1, mesh_s, card,
        )
        del frames93, t93, target93
        print(f"space train {card}: {name93} step b2 x {FAMILY_TRAIN_HW[0]}x{FAMILY_TRAIN_HW[1]} f32 on the (1, 2) mesh "
              f"against one device: loss {row93['loss']:.7f} vs {row93['loss_one_device']:.7f}, gradients within "
              f"{row93['grad_rel_err']:.3g} of each tensor's largest ({row93['grad_rel_worst']}; "
              f"{row93['grad_err_over_largest_of_all']:.3g} of the largest of all; one device's larger move for its inputs one "
              f"ulp up or its weights two {row93['one_device_move_grad_rel']:.3g}, {row93['one_device_move_grad_rel_worst']}); "
              f"launches "
              f"{row93['launches']}; {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"space train: phase 93 {time.perf_counter() - t0:.1f} s", flush=True)
    train_space27 = {"m2m_train_space_2way": m2m_train_space, **slice27}
    train_space27_n = {path: row["launches"]["(1, 2) mesh"] for path, row in train_space27.items()}

    # per kernel and bf16 path, one forward's launches, device ms and bound,
    # ranked by the ms above the bound
    profiles = {
        "rife": rife_profile, "m2m": m2m_profile, "film": film_profile, **gmfss_profiles, "eisai": eisai_profile,
        "stmfnet": stmf_profile, "ifrnet": ifrnet_profile, "ifunet": ifunet_profile, "amt": amt_profile,
        "atm": atm_profile, "xvfi": xvfi_profile,
    }
    per_forward = {k: {path: prof[k] for path, prof in profiles.items() if k in prof} for k in KERNEL_BODIES}
    # K1's library yardstick per forward: each path's recorded launches
    # replayed through F.grid_sample
    for path, entry in per_forward["warp_bilinear"].items():
        entry["library_ms"], entry["library_by_layout"] = library_per_forward(entry["launch_layouts"], g, dev)
        print(
            f"library {card}: K1 on {path}: {entry['launches']} launches, {entry['device_ms']:.4f} ms on the device, bound "
            f"{entry['bound_ms']:.4f}, F.grid_sample {entry['library_ms']:.4f} ms on the device ("
            + "; ".join(f"{r['shape']} {r['dtype']} x{r['launches']}: bound {r['bound_ms']:.4f}, grid_sample "
                        f"{r['library_ms']:.4f}" for r in entry["library_by_layout"])
            + ")",
            flush=True,
        )
    ranked = sorted(
        ((k, path, v) for k, paths in per_forward.items() for path, v in paths.items()),
        key=lambda e: e[2]["above_bound_ms"], reverse=True,
    )
    print(
        f"ranking {card}: ms above the bound per bf16 forward (1080p; EISAI 540p; STMFNet a 1080p window; IFRNet b4, IFUnet, AMT "
        f"and XVFI b2, ATM b1): "
        + "; ".join(f"{k} on {path} {v['above_bound_ms']:.3f} ({v['launches']} launches)" for k, path, v in ranked),
        flush=True,
    )

    print(f"smoke {card}: phases 1-93 passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    family_launches = {k: {f"{name}_train": row["launches"][k] for name, row in family_rows.items()} for k in family_rows["gmfss"]["launches"]}
    print(json.dumps({"kernels": [
        {
            "name": "warp_bilinear",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:78",
            "launches": rife_warp_launches + rife40_launches["narrow"] + m2m_warp_launches + film_warp_launches
            + sum(v["narrow"] for v in gmfss_launches.values()) + eisai_launches["narrow"] + stmf_launches["narrow"]
            + ifrnet_launches["narrow"] + ifunet_launches["narrow"] + amt_launches["narrow"] + atm_launches["narrow"]
            + xvfi_launches["narrow"] + x4k_launches["narrow"] + rife_stream_launches["narrow"] + m2m_stream_launches["narrow"]
            + train_launches["narrow"] + rife_sharded_launches["narrow"] + m2m_sharded_launches["narrow"]
            + rife_sharded2_launches["narrow"] + m2m_sharded2_launches["narrow"] + train2_launches["narrow"]
            + m2m_train_launches["narrow"] + sum(family_launches["narrow"].values()) + space_launches["narrow"]
            + space_train_launches["narrow"] + m2m_space_launches["narrow"] + xvfi_space["launches"]["narrow"]
            + film_space["launches"]["narrow"] + sum(row["launches"]["narrow"] for row in (*slice22.values(), *slice23.values(), *slice24.values(), *slice25.values(), *slice26.values()))
            + sum(n["narrow"] for n in train_space27_n.values()),
            "launches_by_path": {
                "rife": rife_warp_launches, "rife40": rife40_launches["narrow"], "m2m": m2m_warp_launches,
                "film": film_warp_launches, **{path: v["narrow"] for path, v in gmfss_launches.items()},
                "eisai": eisai_launches["narrow"], "stmfnet": stmf_launches["narrow"],
                "ifrnet": ifrnet_launches["narrow"], "ifunet": ifunet_launches["narrow"], "amt": amt_launches["narrow"],
                "atm": atm_launches["narrow"], "xvfi": xvfi_launches["narrow"], "xvfi_x4k_1080p": x4k_launches["narrow"],
                "rife_streaming": rife_stream_launches["narrow"], "m2m_streaming": m2m_stream_launches["narrow"],
                "momo": momo_launches["narrow"], "rife_train": train_launches["narrow"],
                "rife_sharded": rife_sharded_launches["narrow"], "m2m_sharded": m2m_sharded_launches["narrow"],
                "rife_sharded_2way": rife_sharded2_launches["narrow"], "m2m_sharded_2way": m2m_sharded2_launches["narrow"],
                "rife_train_2way": train2_launches["narrow"], "m2m_train": m2m_train_launches["narrow"],
                **family_launches["narrow"], "rife_space_2way": space_launches["narrow"],
                "rife_train_space_2way": space_train_launches["narrow"], "m2m_space_2way": m2m_space_launches["narrow"],
                "xvfi_space_2way": xvfi_space["launches"]["narrow"], "film_space_2way": film_space["launches"]["narrow"],
                **{path: row["launches"]["narrow"] for path, row in (*slice22.items(), *slice23.items(), *slice24.items(), *slice25.items(), *slice26.items())},
                **{path: n["narrow"] for path, n in train_space27_n.items()},
            },
            "max_abs_err": main_err,
            "shape": f"{list(MAIN_SHAPE)} bf16, f32 flow",
            "ms": k1_ms["K1"],
            "plain_ms": k1_ms["plain"],
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": k1_ms["grid_sample"],
            "gmfss_shapes": {k: v for k, v in gmfss_warp_times.items() if v["kernel"] == "tiled"},
            "stmfnet_shapes": {k: v for k, v in stmf_warp_times.items() if v["kernel"] == "tiled"},
            "ifrnet_ifunet_amt_shapes": {k: v for k, v in s8_warp_times.items() if v["kernel"] == "tiled"},
            "atm_xvfi_shapes": {k: v for k, v in s10_warp_times.items() if v["kernel"] == "tiled"},
            "per_forward": per_forward["warp_bilinear"],
            "row_band": {"shape": f"{list(SPACE_WARP_SHAPE)} bf16, f32 flow, rows {spans[1][0]}-{sum(spans[1])}",
                         "max_abs_err": band_err, "ms": band_rows_ms["K1 band"], "whole_frame_ms": band_rows_ms["K1 whole frame"],
                         "plain_ms": band_rows_ms["plain band"], "bound_ms": band_bound[0], "bound_by": band_bound[1],
                         "library_ms": band_rows_ms["grid_sample band"]},
            "rife_space_2way": {"f32_max_abs_err": f32_err, "f32_settings": f32_settings, "bf16_psnr_db": bf16_db,
                                "runs": space_rows},
        },
        {
            "name": "warp_bilinear_wide",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:297",
            "launches": rife40_launches["wide"] + m2m_wide + film_wide_launches
            + sum(v["wide"] for v in gmfss_launches.values()) + stmf_launches["wide"]
            + ifrnet_launches["wide"] + ifunet_launches["wide"] + amt_launches["wide"] + atm_launches["wide"]
            + xvfi_launches["wide"] + x4k_launches["wide"] + rife_stream_launches["wide"] + m2m_stream_launches["wide"]
            + m2m_sharded_launches["wide"] + m2m_sharded2_launches["wide"] + m2m_train_launches["wide"]
            + sum(family_launches["wide"].values()) + m2m_space_launches["wide"] + xvfi_space["launches"]["wide"]
            + film_space["launches"]["wide"] + sum(row["launches"]["wide"] for row in (*slice22.values(), *slice23.values(), *slice24.values(), *slice25.values(), *slice26.values()))
            + sum(n["wide"] for n in train_space27_n.values()),
            "launches_by_path": {
                "rife40": rife40_launches["wide"], "m2m": m2m_wide, "film": film_wide_launches,
                **{path: v["wide"] for path, v in gmfss_launches.items()}, "stmfnet": stmf_launches["wide"],
                "ifrnet": ifrnet_launches["wide"], "ifunet": ifunet_launches["wide"], "amt": amt_launches["wide"],
                "atm": atm_launches["wide"], "xvfi": xvfi_launches["wide"], "xvfi_x4k_1080p": x4k_launches["wide"],
                "rife_streaming": rife_stream_launches["wide"], "m2m_streaming": m2m_stream_launches["wide"],
                "momo": momo_launches["wide"], "rife_train": train_launches["wide"], "m2m_sharded": m2m_sharded_launches["wide"],
                "m2m_sharded_2way": m2m_sharded2_launches["wide"], "m2m_train": m2m_train_launches["wide"],
                **family_launches["wide"], "m2m_space_2way": m2m_space_launches["wide"],
                "xvfi_space_2way": xvfi_space["launches"]["wide"], "film_space_2way": film_space["launches"]["wide"],
                **{path: row["launches"]["wide"] for path, row in (*slice22.items(), *slice23.items(), *slice24.items(), *slice25.items(), *slice26.items())},
                **{path: n["wide"] for path, n in train_space27_n.items()},
            },
            "max_abs_err": wide_err,
            "shape": f"{list(FILM_WARP_SHAPES[0])} bf16, f32 flow",
            "ms": wide_main["ms"],
            "plain_ms": wide_main["plain_ms"],
            "k1_ms": wide_main["k1_ms"],
            "bound_ms": wide_main["bound_ms"],
            "bound_by": wide_main["bound_by"],
            "library_ms": wide_main["library_ms"],
            "by_shape": {
                **wide_times, **{k: v for k, v in gmfss_warp_times.items() if v["kernel"] == "wide"},
                **{k: v for k, v in stmf_warp_times.items() if v["kernel"] == "wide"},
                **{k: v for k, v in s8_warp_times.items() if v["kernel"] == "wide"},
                **{k: v for k, v in s10_warp_times.items() if v["kernel"] == "wide"},
                **path_wide_times,
            },
            "stmfnet_backwarp_designs": design_times,
            "per_forward": per_forward["warp_bilinear_wide"],
            "row_band": {"shape": wide_band_main, "max_abs_err": wide_band_err, "ms": wide_band_ms[wide_band_main]["wide band"],
                         "whole_frame_ms": wide_band_ms[wide_band_main]["wide whole frame"],
                         "plain_ms": wide_band_ms[wide_band_main]["plain band"], "bound_ms": wide_band_ms[wide_band_main]["bound_ms"],
                         "bound_by": wide_band_ms[wide_band_main]["bound_by"],
                         "library_ms": wide_band_ms[wide_band_main]["grid_sample band"], "by_shape": wide_band_ms},
            "m2m_space_2way": {"f32_max_abs_err": m2m_f32_err, "f32_settings": m2m_f32_settings, "bf16_psnr_db": m2m_bf16_db,
                               "runs": m2m_space_rows},
            "film_space_2way": film_space,
            **slice22,
            **slice23,
            **slice24,
            "gmfss_space_2way": slice25["gmfss_space_2way"],
            "gmfss_union_space_2way": slice25["gmfss_union_space_2way"],
            "atm_sharded_2way": slice26["atm_sharded_2way"],
        },
        {
            "name": "softsplat",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/softsplat.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py:365",
            "launches": m2m_splat_launches + sum(v["splat"] for v in gmfss_launches.values()) + eisai_launches["splat"]
            + stmf_launches["splat"] + xvfi_launches["splat"] + x4k_launches["splat"] + rife_stream_launches["splat"]
            + m2m_stream_launches["splat"] + m2m_sharded_launches["splat"] + m2m_sharded2_launches["splat"]
            + m2m_train_launches["splat"] + sum(family_launches["splat"].values()) + m2m_space_launches["splat"]
            + xvfi_space["launches"]["splat"] + sum(row["launches"]["splat"] for row in (*slice23.values(), *slice24.values(), *slice25.values(), *slice26.values()))
            + sum(n["splat"] for n in train_space27_n.values()),
            "launches_by_path": {
                "m2m": m2m_splat_launches, **{path: v["splat"] for path, v in gmfss_launches.items()},
                "eisai": eisai_launches["splat"], "stmfnet": stmf_launches["splat"], "xvfi": xvfi_launches["splat"],
                "xvfi_x4k_1080p": x4k_launches["splat"], "rife_streaming": rife_stream_launches["splat"],
                "m2m_streaming": m2m_stream_launches["splat"], "momo": momo_launches["splat"],
                "rife_train": train_launches["splat"], "m2m_sharded": m2m_sharded_launches["splat"],
                "m2m_sharded_2way": m2m_sharded2_launches["splat"], "m2m_train": m2m_train_launches["splat"],
                **family_launches["splat"], "m2m_space_2way": m2m_space_launches["splat"],
                "xvfi_space_2way": xvfi_space["launches"]["splat"], "film_space_2way": film_space["launches"]["splat"],
                **{path: row["launches"]["splat"] for path, row in (*slice22.items(), *slice23.items(), *slice24.items(), *slice25.items(), *slice26.items())},
                **{path: n["splat"] for path, n in train_space27_n.items()},
            },
            "max_abs_err": splat_err,
            "shape": f"{list(SPLAT_SHAPE)} bf16, f32 flow, smooth amp 8, through softsplat_func",
            "ms": splat_ms,
            "plain_ms": splat_plain_ms,
            "kernel_ms_in_m2m_forward": m2m_profile["softsplat"]["device_ms"],
            "bound_ms": splat_bound[0],
            "bound_by": splat_bound[1],
            "library_ms": splat_library_ms,
            "library": "one call: aten.grid_sampler_2d_backward of the f32 values on a precomputed grid (utils/kernel_compare.py:library_splat)",
            "gmfss_shapes": gmfss_splat_times,
            "eisai_shapes": eisai_splat_times,
            "stmfnet_shapes": stmf_splat_times,
            "xvfi_shapes": xsplat_times,
            "xvfi_space_2way": xvfi_space,
            "stmfnet_space_2way": stmf_space,
            **slice25,
            "per_forward": per_forward["softsplat"],
            "row_band": {"shape": f"{list(SPLAT_SHAPE)} bf16, f32 flow, rows {splat_spans[1][0]}-{sum(splat_spans[1])} into the whole "
                                  f"frame's f32 partial", "max_abs_err": sband_err, "ms": sband_ms["K2 band"],
                         "whole_frame_ms": sband_ms["K2 whole frame"], "plain_ms": sband_ms["plain band"],
                         "bound_ms": sband_ms["bound_ms"], "bound_by": sband_ms["bound_by"],
                         "whole_frame_bound_ms": sband_ms["whole_frame_bound_ms"], "library_ms": sband_ms["library band"]},
        },
        {
            "name": "warp_bilinear_backward",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "the XLA VJP of comfyui_frame_interpolation_tpu/ops/warp.py:57 (bilinear_sample)",
            "launches": train_launches["backward"] + train2_launches["backward"] + m2m_train_launches["backward"]
            + sum(family_launches["backward"].values()) + space_train_launches["backward"]
            + sum(n["backward"] for n in train_space27_n.values()),
            "launches_by_path": {"rife_train": train_launches["backward"], "rife_train_2way": train2_launches["backward"],
                                 "m2m_train": m2m_train_launches["backward"], **family_launches["backward"],
                                 "rife_space_2way": space_backward_launches,
                                 "rife_train_space_2way": space_train_launches["backward"],
                                 **{path: n["backward"] for path, n in train_space27_n.items()}},
            "max_abs_err": bwd_err,
            "shape": f"{list(MAIN_SHAPE)} f32, f32 flow, border",
            "ms": bwd_main["ms"],
            "kernel_device_ms": bwd_main["kernel_device_ms"],
            "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main["bound_ms"],
            "bound_by": bwd_main["bound_by"],
            "library_ms": bwd_main["library_ms"],
            "by_shape": bwd_times,
            "per_step": train_profile.get("warp_bilinear_backward"),
            "per_m2m_step": m2m_train_profile.get("warp_bilinear_backward"),
            "training": train_rows,
            "family_steps": {name: {"launches": row["backward_shapes"]["warp"], "max_abs_err": row["max_abs_err"]["warp"],
                                    **row["backward_shares"].get("warp_bilinear_backward", {})}
                             for name, row in family_rows.items()},
            "family_largest": family_times.get("warp_bilinear_backward"),
            "row_band": {"shape": bband_main, "max_abs_err": bband_err, "ms": bband_ms[bband_main]["band"],
                         "whole_frame_ms": bband_ms[bband_main]["whole frame"], "plain_ms": bband_ms[bband_main]["plain band"],
                         "bound_ms": bband_ms[bband_main]["bound_ms"], "bound_by": bband_ms[bband_main]["bound_by"],
                         "library_ms": bband_ms[bband_main]["library band"], "by_shape": bband_ms},
            "rife_train_space_2way": {"loss": loss_s, "loss_one_device": loss1, "grad_rel_err": s_rel, "grad_rel_worst": s_worst,
                                      "scaled_weights_grad_rel": p_rel, "small_grad_rel_err": ss_rel, "training": space_train_rows},
        },
        {
            "name": "softsplat_bilinear_backward",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/softsplat.cu",
            "replaces": "the XLA VJP of comfyui_frame_interpolation_tpu/ops/softsplat.py:83 (_softsplat_xla)",
            "launches": m2m_train_launches["splat_backward"] + sum(family_launches["splat_backward"].values())
            + sum(n["splat_backward"] for n in train_space27_n.values()),
            "launches_by_path": {"m2m_train": m2m_train_launches["splat_backward"], "rife_train": train_launches["splat_backward"],
                                 "rife_train_2way": train2_launches["splat_backward"], **family_launches["splat_backward"],
                                 **{path: n["splat_backward"] for path, n in train_space27_n.items()}},
            "max_abs_err": sb_err,
            "shape": f"{list(M2M_TRAIN_SPLAT_SHAPE)} f32, f32 flow",
            "ms": sbwd_main["ms"],
            "kernel_device_ms": sbwd_main["kernel_device_ms"],
            "plain_ms": sbwd_main["plain_ms"],
            "bound_ms": sbwd_main["bound_ms"],
            "bound_by": sbwd_main["bound_by"],
            "library_ms": sbwd_main["library_ms"],
            "library": "two calls: F.grid_sample (grad_in) + aten.grid_sampler_2d_backward, output_mask [False, True] (grad_flow)",
            "by_shape": sbwd_times,
            "per_step": m2m_train_profile.get("softsplat_bilinear_backward"),
            "training": m2m_train_rows,
            "other_steps": other_steps,
            "family_steps": {name: {"launches": row["backward_shapes"]["splat"], "max_abs_err": row["max_abs_err"]["splat"],
                                    **row["backward_shares"].get("softsplat_bilinear_backward", {})}
                             for name, row in family_rows.items()},
            "family_largest": family_times.get("softsplat_bilinear_backward"),
            "family_training": {name: {k: v for k, v in row.items() if k not in ("backward_shapes", "max_abs_err")}
                                for name, row in family_rows.items()},
            "phase_63": {"by_layout": sb_rows, "per_step": sb_steps},
            "row_band": {"shape": f"{list(M2M_TRAIN_SPLAT_SHAPE)} f32, f32 flow, rows {M2M_TRAIN_SPLAT_SHAPE[1] // 2}-"
                                  f"{M2M_TRAIN_SPLAT_SHAPE[1]} of the whole frame's output gradient",
                         "max_abs_err": sband91_err, "ms": sband91_main["ms"], "kernel_device_ms": sband91_main["kernel_device_ms"],
                         "whole_frame_device_ms": sband91_main["whole_frame_device_ms"], "plain_ms": sband91_main["plain_ms"],
                         "bound_ms": sband91_main["bound_ms"], "bound_by": sband91_main["bound_by"],
                         "library_ms": sband91_main["library_ms"], "library_device_ms": sband91_main["library_device_ms"],
                         "by_input": sband91},
            **train_space27,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
