#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and depth with random weights
made from a seed: 4-step text-to-image sampling of SD1.5 at 512² and of
SDXL at 1024² (also in the JAX package's two opt-in kernel modes), the
Flash distillation step of SD1.5 at 512² and of SDXL at 1024², SDXL 1024²
served over HTTP in int8 W8A8 with a merged LoRA, 4-step sampling of
Pixart-α at 1024² (T5-XXL, the DiT) in bf16 and in int8, Pixart's
distillation step at 512², 4-step sampling of SD3-medium at 1024² (the
MMDiT, dual-CLIP and with T5-XXL) in bf16 and in int8, SD3's
distillation step at 1024², the SD1.5 training run on JPEG shards, the
Canny T2I-Adapter distillation run of SD1.5 at 512², the DPT depth
model (ViT-L/16) at 384², the eval path (SD1.5 samples scored by CLIP-FID
with ViT-L/14, Inception FID and CLIPScore through ``eval_coco``), and the
weights-free toy distillation proofs. It fails unless every phase passes, and prints
each phase's seconds:

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernels from ``flash_diffusion_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed), with ptxas' register report; the
   attention kernels' shared-memory plans against the kernels' own
   arithmetic (K1's and K4's at their shapes, K6/K7's and K2's tiles at
   every head dim they take, K8's at every head dim and KV up to 160 and
   256, K10's plan at every FFN shape and tile width, K12's at every FFN
   shape and built variant, K11's at every int8 shape on this card's SMs
   and on 132, and at each split), and no K1, K2, K4, K5, K6, K7, K8, K10,
   K11 or K12 instantiation may spill (the packed K4 and K5, K11's and K12's
   must have a report of their own), nor may K2, K5, K10, K11 or K12 have
   ptxas serialize their wgmma;
2. kernels vs plain: each hand-written kernel against its plain PyTorch
   version at every shape the paths give it (bf16 kernel vs the plain
   version in fp32 on the same inputs; the SDXL training step's shapes at
   batch 2 and 4 among them: K1, K8 and the pair at D = 64, the VAE's
   encoder at 1024² and decoder over 64² latent crops, the discriminator's
   fp32 GroupNorms; the Pixart training step's at batch 4 and 2B: K2, K3
   and the pair at D = 72 over 1024 tokens, a ragged D = 72 backward, the
   VAE encoder at 512² and the discriminator's fp32 GroupNorms at 16² and
   8²; K11 at Pixart 1024²'s four int8 shapes; K1 at D = 72 at the small
   Pixart references' shapes; SD3's: K2 over the joint sequence at
   [96, 4352, 4352, 64] masked at kv_valid 4250 and, with T5, [96, 4480,
   4480, 64] at 4429, each timed against SDPA under the same key mask, and
   a ragged joint length off the tile; K1 at the 128² references' 218 of
   256 keys; K3 at width 1536 over the image and padded context streams;
   K11 at SD3's six int8 products; SD3 training's: K2 at [48, 4352, 4352,
   64] masked at 4250, the K6 + K7 pair at [48 and 96, 4352, 4352, 64]
   masked at 4250 (dk, dv exactly 0 past it) timed against SDPA's backward
   under the same boolean key mask, K3 at [8192, 1536] and [512, 1536],
   the discriminator's fp32 GroupNorms at [2, 128, 32²] and [2, 256, 16²],
   and every shape of its 256² reference (K1 and the pair at 410 of 512
   keys, the VAE encoder at 256², the 3-stage discriminator); the small
   references' shapes with the library call and the bound too, outside the
   sums), with ragged cases; max abs error
   against the stated tolerance; at the paths' shapes also the kernel's,
   the plain version's and the PyTorch library call's device time (CUDA
   events around 10 queued calls, 2 for calls of 1 ms or more, median of 5
   runs) and the bound: the
   larger of the bytes the function moves over 3.35 TB/s and its operations
   (as the JAX ``pl.CostEstimate`` counts them) over 989 TFLOP/s in bf16
   (67 TFLOP/s fp32 for the norms). The library calls are yardsticks only:
   ``F.scaled_dot_product_attention`` (forward for K1, K2, K4; its backward,
   ``torch.autograd.grad`` with ``retain_graph``, for K6–K8; for K5 on the
   [B, H, S, D] views of the packed tensors) and
   ``F.layer_norm`` for K3, ``torch._int_mm`` and the same dequant for the
   int8 GEMM (K11, whose bound counts int8 operations at 1979 TOP/s and whose
   int32 sums are checked equal to the plain version's, its bf16 output to
   one ulp, at every case, each printed with its plan). K3 (LayerNorm) is
   held to ``ops/norms.py layer_norm_gate`` (bf16: every element within
   2^-8·|y| + 2^-16·max|y|, relative L2 within 4e-3; fp32: the summation
   order), also on rows of small variance where eps shows. The whole
   GroupNorm (``group_norm``: the resident kernel in one launch, or K9's
   statistics with the fold, then the apply) is held to ``group_norm_gate``
   at every GroupNorm shape of the paths, in both layouts, with and without
   SiLU (relative to the plain version in fp32; mean and inv to fp64), and
   bit-equal for a sample alone and in its batch and from run to run; K9's
   own entry (``group_norm_stats``) in fp64 (Σx to 1e-5 of Σ|x|, Σx² to
   1e-5), exact alone vs batched; the apply kernel alone (x·ŵ + b̂, SiLU)
   to one bf16 ulp; their library yardsticks are ``torch.var_mean`` and
   ``F.silu(F.group_norm(...))``. K2
   also runs at Pixart's D = 72. K1 (the one-shot forward) is held to
   ``attention_fwd_gate`` (max|out err| within 4e-3 + 2^-8 of max|out|, a
   relative L2 within 4e-3, a mean signed error within 5e-4, lse within
   5e-3) on cases whose keys past ``kv_valid`` are k × 3 and v + 1, and on
   a 77-key case with v + 1 at every key (a zero padding row that leaked
   would show); K2 to the same gate, with ragged and v + 1 cases at D = 64
   and 72 whose Sq and KV are off its tiles. The backward kernels (K6+K7
   or K8, routed by ``attention_bwd_plan``) are held in fp32 against
   ``attention_bwd_reference`` for dq, dk and dv by ``attention_bwd_gate``
   (max|err| within 4e-3 + 2^-6 of max|grad|, relative L2 within 1e-2, and
   dk, dv exactly 0 at rows past ``kv_valid``, whose keys are filled with
   k × 3 and v + 1); K6 and K7 are also timed alone. K4 and K5 (the
   packed one-shot and streaming attention) at SDXL's cross- and
   self-attention shapes and ragged ones, to the same gate without the lse
   term (their ragged cases add 1 to every v, so that a zero-filled key
   past KV leaking into the softmax would show); K10 and K12 (the feed-forward's
   down-projection GEMMs) at SDXL's two feed-forward shapes, ragged M and
   K10's dW shapes, to ``ops/gemm.py gemm_gate`` (|err| within 2^-8 of |y|
   plus 2^-8 of max|y| at every element, relative L2 within 4e-3, mean
   signed error within 1e-4 of rms|y|; library yardsticks ``F.linear``;
   ``torch.mm`` for dW = xᵀ·dy; for K12, which no one PyTorch call
   computes, the unfused gate then ``F.linear``);
3. SD1.5 path: ``build_pipeline("sd15", device="cuda")`` then ``generate``
   of 4 prompts × 4 steps, guidance 0, 512²: the output must be
   [4, 512, 512, 3] and finite, and the launch counts of K1–K3 and of the
   GroupNorm kernels, reset just before, must have grown; then warm wall
   time per batch and images/s;
4. SD1.5 reference: the same modules at 128² on one prompt, on the card in
   bf16 against a copy on the CPU in fp32 (the plain paths), with the same
   latents and step noise: CLIP must agree to 1e-4 and the images to a
   relative L2 error of 0.1;
3b. SDXL path, after the SD1.5 pipeline is freed: ``build_pipeline("sdxl",
   device="cuda")`` then ``generate`` of 4 prompts × 4 steps, guidance 0,
   1024²: [4, 1024, 1024, 3] and finite, and the launch counts of K2, K3,
   K4 and the GroupNorm kernels, reset just before, must have grown; warm
   s/batch, images/s and peak memory;
4b. SDXL reference at 128² on one prompt, as phase 4: both CLIP outputs
   (crossattn and vector) to a relative L2 of 1e-4, the images to 0.1. The
   fp32 CPU copy is built from the modules' state dicts, parameter by
   parameter;
3c. the same SDXL pipeline in the JAX package's opt-in kernel modes, each
   through ``generate`` as in 3b (same seeds): (A)
   ``FLASH_TPU_ATTN_PACKED=1 FLASH_TPU_FFN_FUSED=1``, (B)
   ``FLASH_TPU_FFN_DOWN_GEMM=1``. The launch counts, reset just before,
   must be exact (A: K12 280, K5 280, K10 0, K2 1; B: K10 280, K12 0, K5
   0) and the images within a relative L2 of 5e-2 of the default mode's;
   warm s/batch, images/s and peak memory beside 3b's;
4c. each mode at 512² (the least size where all three kernels run), one
   prompt, one step, on the card against the fp32 CPU copy under the same
   switches (the plain versions): images to 0.1, the mode's kernels
   launched;
5. training, after the serving pipelines are freed: ``build_trainer("sd15",
   device="cuda")`` with ``flash_sd.yaml`` (K = 32, LPIPS distill, DMD,
   hinge GAN, rank-128 LoRA, ``remat`` on) and ``NUM_ITERATIONS_PER_K`` set
   so that every step falls in stage 1 (distill 1.0, DMD 0.3, adversarial
   0.1), then ``fit`` on synthetic batches of 4 at 512²: 1 warm and 3 timed
   steps. Every loss finite; every LoRA B factor and the discriminator
   changed; teacher, VAE and CLIP bit-identical; the launch counts of K1,
   K2, K3, K6, K7, K8 and the GroupNorm kernels, reset just before, grown
   (the forward kernels'
   counts include the recompute of ``remat`` and of the checkpointed LPIPS
   decode in the backward). Warm s/step (median), images/s and peak memory
   (the stage breakdown is ``flash_diffusion_tpu_torch.profiling --train``);
5b. training reference at 256² (K = [4], ``LPIPS_CROP`` 16, no
   discriminator stage, batch 2, non-zero LoRA B; 256² is the least size
   whose 4×4 mid features the discriminator's 4×4 head takes; at 128²
   they are 2×2): one ``losses`` and
   backward on the card in bf16 against an fp32 CPU copy built from the
   state dicts, on the same staged batch and the same draws: the distill,
   DMD and D losses each to a relative error of 0.05, the discriminator's
   outputs to a relative L2 of 0.05, the LoRA and discriminator gradients to
   a relative L2 of 0.1, the VAE encode to 0.1 (the ungated diagnostics of
   each scaled G term's LoRA gradients and of the student's own backward,
   which take longer than the check itself on the CPU copy, are
   ``train_ref_precision.py --model sd15``'s);
5c. SDXL training, after the SD1.5 trainers are freed: ``build_trainer(
   "sdxl", device="cuda")`` with ``flash_sdxl.yaml`` (the full-width UNet
   with ``remat``, CLIP-L + bigG, the SDXL VAE, K = 32 with the DPM-Solver++
   2M teacher, LPIPS distill, DMD, lsgan, rank-64 LoRA, a 3-stage
   discriminator), every step in stage 1, then ``fit`` on synthetic batches
   of 2 at 1024² with the size tuples: 1 warm and 3 timed steps, each
   printed with its start index and teacher forwards (K − start); checked
   as phase 5 (K4 launched too), and every (kernel, shape) the steps
   launched (the keys of the kernels' ``LAUNCHES``, cleared just before;
   the GroupNorm's with its group count) must be among the shapes phase 2
   gates. Warm s/step (median), images/s, peak memory;
5d. SDXL training reference at 256², as 5b (K = [4], ``LPIPS_CROP`` 16,
   batch 2, non-zero LoRA B, the discriminator's 1 stage on the 8² mid
   features), the DPM rollout from ``TRAIN_REF_START`` 1 (first-order,
   second-order and final steps), 5b's tolerances; its seconds printed;
6. int8 serving, after the training pipelines are freed: ``build_pipeline(
   "sdxl", device="cuda")``, a random rank-64 LoRA over the default targets
   written as a PEFT file and loaded through ``pipe.lora_loader``, then
   ``quantize("int8")`` (722 layers) and ``InferenceServer`` on an
   ephemeral localhost port (``max_batch`` 4, ``batch_sizes`` (1, 4),
   prewarm) in a thread. 8 concurrent clients each send 8 ``POST
   /generate`` at 1024² (``format: json``), one after the other (a closed
   loop: 64 requests, 16 dispatches of 4): each response must decode to a
   1024×1024 RGB PNG; ``/healthz``, ``/loras`` and ``/metrics``
   (``batch_occupancy`` 1.0) are checked, and the int8 GEMM kernel's
   launches, reset just before, must be 2888 per batch-4 dispatch (722
   products × 4 steps), with K2, K3, K4 and the GroupNorm kernels launched
   too. Then warm s/batch
   (median of 3 ``generate`` calls), images/s, the 64 requests' latency
   p50/p95 (the server's, and the clients' with PNG and HTTP) and peak
   memory;
6b. the same int8 pipeline at 128² on one prompt against its fp32 CPU copy
   with the same int8 weights (the plain paths), as phases 4/4b; and one
   request's image alone against the same request in a batch of 4
   (per-request seeds), to a relative L2 of 1.5e-2, the contract of
   ``FlashPipeline.generate``: the port's own ops are exact, cuDNN's and
   cuBLAS's algorithms depend on the batch size (measured: 9.8e-3; a wrong
   noise chain gives ~1.3);
7. Pixart-α, after the int8 pipeline is freed: ``build_pipeline("pixart",
   device="cuda")`` (T5-XXL in fp32, the DiT and VAE in bf16, LCM on linear
   betas) then ``generate`` of 4 prompts × 4 steps, guidance 0, 1024²:
   [4, 1024, 1024, 3] and finite, the launch counts of K2, K3 and the
   GroupNorm kernels grown; warm s/batch, images/s and peak memory;
7b. Pixart references: T5-XXL at full width and 2 layers, card (fp32) vs
   its CPU copy, rel. L2 1e-4; the DiT and VAE at full size at 128² on one
   prompt, bf16 on the card vs an fp32 CPU copy on the same T5 output
   (the card's), latents and step noise: images to a relative L2 of 0.1;
7e. the same Pixart pipeline in int8 W8A8: ``quantize("int8")`` (280
   layers), then ``generate`` of 4 prompts × 4 steps at 1024² as phase 7:
   K11 launched exactly 280 × 4 times, every launched (kernel, shape) among
   phase 2's; warm s/batch beside phase 7's; then its DiT and VAE at 128²
   against an fp32 CPU copy with the same int8 weights, as 7b (images to
   0.1);
7c. Pixart training, after that pipeline is freed: ``build_trainer(
   "pixart", device="cuda")`` with ``flash_pixart.yaml`` (the full-width DiT
   with ``remat``, T5-XXL in fp32 over bf16-rounded weights, the SD VAE,
   K = 16 with the DDPM teacher on linear betas, l2 distill, DMD, hinge,
   rank-64 LoRA, a 3-stage 64-feature discriminator over the 4-channel
   output latents), every step in stage 1, then ``fit`` on synthetic
   batches of 4 at 512² (T5 ids and mask, ``resolution_ar``): 1 warm and 3
   timed steps, each printed with its start index and teacher forwards;
   checked as 5c (K2, K3, K6, K7 and the GroupNorm kernels launched, every
   launched (kernel, shape) among phase 2's); warm s/step (median),
   images/s, peak memory;
7d. Pixart training reference at 256², as 5b (K = [4], batch 2, non-zero
   LoRA B, the discriminator's 3 stages down to its 4×4 head), the DDPM
   rollout from ``TRAIN_REF_START`` 2 (two noised steps): the CPU copy is
   fed the card's staged ``__conds`` and holds a 1-layer stand-in T5, never
   run, in place of T5-XXL; 5b's tolerances, the discriminator's outputs
   held on the card's features (``DISC_ON_CARD_FEATURES``), end to end
   printed beside; its seconds printed;
8. SD3-medium, after the Pixart trainers are freed: ``build_pipeline("sd3",
   device="cuda")`` (CLIP-L and CLIP-G in fp32, packed to 77 CLIP and 77
   zero T5 tokens 4096 wide; the MMDiT, 24 joint blocks of 1536, and the
   16-channel VAE in bf16; the Flash flow-match sampler, shift 3) then
   ``generate`` of 4 prompts × 4 steps, guidance 0, 1024²: [4, 1024, 1024,
   3] and finite, the launch counts of K2, K3 and the GroupNorm kernels
   grown, every launched (kernel, shape) among phase 2's (the joint
   attention at kv_valid 4250, the VAE's GroupNorms at SDXL's shapes);
   warm s/batch, images/s and peak memory;
8b. SD3 references at 128² on one prompt, as 4b: the conditioner (CLIP-L
   and CLIP-G, fp32 on the card) against its CPU copy, crossattn and
   vector to a relative L2 of 1e-4; the MMDiT and VAE at full size, bf16 on
   the card against an fp32 CPU copy built from the state dicts, the same
   latents and flow-match step noise: images to 0.1;
8e. the same SD3 pipeline in int8 W8A8: ``quantize("int8")`` (213 layers:
   the add_q/k/v projections stay bf16, as in JAX), then ``generate`` as
   phase 8: K11 launched exactly 213 × 4 times, every launched (kernel,
   shape) among phase 2's; warm s/batch beside phase 8's; then its 128²
   reference against an fp32 CPU copy with the same int8 weights, as 8b
   (images to 0.1);
8t. SD3 with T5-XXL, after that pipeline is freed: ``build_pipeline("sd3",
   device="cuda", t5=True)`` (T5-XXL in fp32 over 256 tokens: a 4429-token
   joint sequence padded to 4480), ``generate`` checked as phase 8; warm
   s/batch, images/s and peak memory;
9. SD3 training, after that pipeline is freed: ``build_trainer("sd3",
   device="cuda")`` with ``flash_sd3.yaml`` (the full MMDiT with ``remat``,
   CLIP-L, CLIP-G and T5-XXL over 77 tokens in fp32 over bf16-rounded
   weights, the 16-channel VAE, K = 32 with the flow-match Euler teacher on
   float timesteps, l2 distill, DMD over the full flow schedule, lsgan over
   the post-mid features, rank-64 LoRA, the 4-stage 64-feature
   discriminator), every step in stage 1, the yaml's
   ``TEXT_ENCODER_OFFLOAD`` 4 honoured (the towers on the host, moved to
   the card for one encode burst of the 4 batches), then ``fit`` on
   synthetic batches of 2 at 1024² (CLIP and T5 ids): 1 warm and 3 timed
   steps, each printed with its start index and teacher forwards; then one
   ``SampleLogger`` call (the student, 4 steps, the yaml's prompt) under
   ``sampling_frozen``, its PNG decoded; checked as 7c (K2, K3, K6, K7 and
   the GroupNorm kernels launched, every launched (kernel, shape) among
   phase 2's: the joint attention and its backward at kv_valid 4250, the
   sampling at batch 1; every LoRA B but the final block's inert
   ``add_q_proj`` pair, whose B stays 0, changed); warm s/step (median),
   images/s, the seconds of each move of the towers, peak memory over the
   phase and over the training steps alone (reset after the burst);
9b. SD3 training reference at 256², as 5b (K = [4], batch 2, non-zero LoRA
   B, a 3-stage discriminator: 4 stages would reduce the 32² features below
   the 4×4 head), the flow-match rollout from ``TRAIN_REF_START`` 1: the
   CPU copy is fed the card's staged ``__conds`` and holds a stand-in T5,
   never run, in place of T5-XXL; 5b's tolerances, but the distill and DMD
   losses held to 0.1 (``TRAIN_REF_LOSS_TOL``: bf16 alone, with no kernel,
   puts them ~5% from fp32); every (kernel, shape) the card's side launched
   among phase 2's; its seconds printed;
10. the SD1.5 training run, after the SD3 trainers are freed
   (``run_training_run``): 3 training shards of 12 JPEGs (512–768 a side)
   and an eval shard of 8, written from seeds 0 and 1, a quarter of the
   scores below ``MIN_AESTHETIC_SCORE`` (the kept and dropped counts
   printed); ``build_trainer("sd15")`` with ``flash_sd.yaml`` stage 1,
   ``EMA_DECAY`` 0.999, ``GRADIENT_ACCUMULATION_STEPS`` 2,
   ``VAL_EVERY_N_STEPS`` and ``CKPT_EVERY_N_STEPS`` 4; ``build_data`` (two
   thread workers) and ``tokenize_batches`` behind ``prefetch_to_device``;
   ``fit`` of 4 micro-steps with ``MetricLogger``, ``CheckpointCallback``,
   a ``SampleLogger`` (the yaml's 2 prompts, 1, 2 and 4 steps, the
   teacher's Euler-ancestral samples at CFG 5) and ``eval_data``. After
   micro-step 1 the LoRA, the discriminator and the EMA are unchanged;
   after micro-step 2 all moved, the EMA = 0.999·EMA₀ + 0.001·LoRA to fp32
   rounding; the validation finite; every sample PNG decodes; the
   checkpoint of step 4 restored by a fresh trainer bit for bit (the
   generator included), two more micro-steps on both with the same batches
   drawing the same starts, their LoRAs within a relative L2 of 1e-3;
   two steps in the alternating mode (``"g"`` moves only the LoRA, ``"d"``
   only the discriminator); the EMA exported as a PEFT file, read back
   equal, and ``build_pipeline("sd15", lora=...)`` generating 4 finite
   images. K1, K2, K3, K6, K7, K8 and the GroupNorm kernels launched, every
   launched (kernel, shape) among phase 2's (the validation batch at B = 2
   and 2B = 4, the eval batch, the training shapes); warm s/micro-step,
   the seconds ``fit`` waited on its data iterator, peak memory;
11. the Canny T2I-Adapter run (``run_canny_training``), on phase 10's JPEG
   shards: ``build_trainer("sd15-canny")`` with
   ``flash_canny_adapter.yaml`` stage 1 (K = 16 DDPM teacher, l2, DMD,
   hinge, rank-128 LoRA, the frozen bf16 adapter over [320, 640, 1280,
   1280] made from the seed), ``build_data`` with the Canny mapper (two
   thread workers) behind ``prefetch_to_device``, zero text ids; ``fit`` of
   4 steps (1 warm, 3 timed), then a 5th under ``torch.profiler`` for the
   device-busy time (its share of that step and of the warm median).
   Every loss finite; the LoRA moved; the adapter
   bit-identical and in no optimizer; then ``FlashDiffusion.sample`` of 4
   images at 512² from one batch's edge maps at
   ``adapter_conditioning_scale`` 1 and 0 (same latents and noise), finite
   and apart by ``CANNY_SCALE_MIN_DIFF`` at least; the LoRA exported as a
   PEFT file and read back equal. K1, K2, K3, K6, K7, K8 and the GroupNorm
   kernels launched, every launched (kernel, shape) among phase 2's; warm
   s/step (median), peak memory, the busy time, the seconds ``fit`` waited
   on data and the Canny mapper's ms a 512² image on the host;
11b. its training reference at 256², as 5b (K = [4], batch 2, non-zero
   LoRA B, 0 discriminator stages), the rollout from ``TRAIN_REF_START``
   3, the adapter's residuals (bf16 on the card, fp32 on the CPU copy) in
   every UNet call; 5b's tolerances; every launched (kernel, shape) among
   phase 2's;
11c. the DPT (``DPTDepth()``: ViT-L/16 at 384², dim 1024, 24 blocks of 16
   heads, 256 features; random weights from seed 0, q and k scaled so that
   the attention is sharp, the head's last conv so that the map varies by
   about 1: ``calibrate_dpt``), bf16 on the card against its fp32 CPU copy
   on one image: the four hook taps and the depth map, each less its mean,
   within ``DPT_REL_L2_TOL`` (relative L2), and the same readings with the
   attention zeroed or its values one key on outside it; then
   ``DepthMapper(make_depth_fn(...))`` over 4 images of 512²: [512, 512, 3]
   maps in [0, 1], the first within the same tolerance of the fp32 copy's,
   K1 launched at [16, 577, 577, 64] (24 a map), gated; ms a map.
12. the eval path (``run_eval``): a seeded full CLIP ViT-L/14 file (both
   towers and projections, transformers' names; q and k of the vision
   layers × 3) under ``image_encoder/`` and a seeded InceptionV3 file
   (torchvision's names, named ``pt_inception-2015-12-05…``: the FID
   blocks; BatchNorm statistics from one batch of real images), then
   ``eval_coco.main`` (``--model sd15 --random-init``, batch 4, 2 batches)
   over phase 10's JPEG + caption shards: finite fid, clip_fid and
   clip_score in [0, 100] over 8 samples, K1 launched at the ViT's [64, 257,
   257, 64] and K3 at [1028, 1024] (24 and 50 a ViT pass), every launched
   (kernel, shape) among phase 2's; then on one batch of 4 real images the
   ViT's image_embeds (bf16) and InceptionV3's pool3 (fp32) against their
   fp32 CPU copies, each within its tolerance, the ViT with its attention
   zeroed outside it, the card-vs-CPU Fréchet distance printed beside the
   real-vs-fake one; ms an image of each extractor;
12b. the toy distillation proofs (``run_toy``): ``toy_quality.main`` and
   ``toy_quality_rf.main`` at 20 teacher and 5 distill steps, batch and
   n_eval 48: every FD finite, K1 and K8 at D = 32 over 64 tokens, K3 at
   width 64 and the GroupNorm (8 groups) launched, every launched (kernel,
   shape) among phase 2's.

The second-to-last line of output is the card's name and power limit; the
line before it lists the kernels as JSON (``launches``: the count over the
paths' runs, ``launches_by_path`` each, the modes of 3c as the paths
``sdxl_packed_fused`` and ``sdxl_down_gemm``, 5c as ``train_sdxl``, 7e as
``pixart_int8``, 7c as ``train_pixart``, 8 as ``sd3``, 8e as ``sd3_int8``,
8t as ``sd3_t5``, 9 as ``train_sd3``, 10 as ``train_run``, 11 as
``train_canny``, 11c as ``depth``, 12 as ``eval``, 12b as ``toy``; ``ms``, ``plain_ms``,
``library_ms``, ``bound_ms``: sums over the paths' shapes, ``bound_by`` the
bound of the largest share; for K6 and K7 ``plain_ms`` and ``library_ms``
are those of the whole backward, dq, dk and dv); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port beside
this file, it exits non-zero and prints no result.
"""

import base64
import collections
import contextlib
import copy
import ctypes
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# (bh, sq, skv, d, kv_valid) of every kernel attention call at batch 4,
# guidance 0, 512² (8 heads: BH = 32), plus ragged cases
ATTENTION_SHAPES = [
    (32, 4096, 4096, 40, None),  # UNet level-0 self-attention
    (32, 1024, 1024, 80, None),  # level-1 self-attention
    (32, 256, 256, 160, None),  # level-2 self-attention
    (32, 64, 64, 160, None),  # mid-block self-attention
    (32, 4096, 77, 40, None),  # cross-attention over the 77 text tokens
    (32, 1024, 77, 80, None),
    (32, 256, 77, 160, None),
    (32, 64, 77, 160, None),
    (4, 4096, 4096, 512, None),  # VAE mid-block, single head, D = C
]
ATTENTION_RAGGED = [
    (32, 1000, 1024, 80, 900), (32, 4000, 77, 40, 70), (4, 700, 4096, 512, 3000),
    (32, 4000, 4096, 40, 4001), (32, 300, 2000, 160, 1999),
    (40, 1000, 1100, 64, 1037), (16, 700, 1500, 72, 1433),  # K2 at SDXL's and Pixart's D, off every tile
    (20, 4000, 77, 64, 70),  # K1 at SDXL's D
]
# v + 1 at every key (kv_valid None): a zero-filled padding row past KV (77
# keys padded to 80; the zero rows of K2's last 128-key tile past 1030 or
# 999 keys) that leaked into the softmax would pull every row's output
# towards 0: by ~2% at 77 keys, by 2–11% at ~1000 keys
ATTENTION_V_SHIFTED = [(32, 4000, 77, 40, None), (40, 1000, 1030, 64, None), (16, 999, 999, 72, None)]
# the small references' DiT self-attention on K1 at D = 72: 7d at 256² (B =
# 2 and 2B over 256 tokens), 7b and 7e at 128² (64 tokens)
ATTENTION_REFERENCES = [(32, 256, 256, 72, None), (64, 256, 256, 72, None), (16, 64, 64, 72, None)]
# SDXL at batch 4, 1024²: the self-attention (10 heads at level 1, 20 at
# level 2 and mid; D = 64) and the VAE mid-block over 128² latents' 16384
# tokens
ATTENTION_SHAPES_XL = [
    (40, 4096, 4096, 64, None),
    (80, 1024, 1024, 64, None),
    (4, 16384, 16384, 512, None),
]
# Pixart-α 1024² at batch 4: the DiT's self-attention (16 heads of D = 72,
# padded to 80, over 4096 tokens); its VAE mid-block is SDXL's shape above.
# Pixart training at 512² (phase 7c): the DiT's self-attention over 1024
# tokens at B = 4 (the student, DMD's student) and 2B (the rollout, DMD's
# and the GAN's teacher); its VAE encoder's mid-block is SD1.5's shape
ATTENTION_SHAPES_PIXART = [(64, 4096, 4096, 72, None), (64, 1024, 1024, 72, None), (128, 1024, 1024, 72, None)]
# SD3-medium 1024² at batch 4 (phases 8, 8e, 8t): the MMDiT's joint
# attention (24 heads of D = 64) over 4096 image + 154 text tokens, the
# context stream zero-padded to a 4352-row joint sequence and masked at
# kv_valid 4250; with T5 (8t), 4096 + 77 + 256 = 4429 of 4480. Its VAE
# mid-block is SDXL's shape above. A wrong key mask would let the padded
# context rows into every image token's softmax
ATTENTION_SHAPES_SD3 = [(96, 4352, 4352, 64, 4250), (96, 4480, 4480, 64, 4429)]
# the 128² references of 8b and 8e (one prompt): 64 image + 154 text tokens
# padded to 256 on K1's one-shot plan, masked at 218; and a ragged joint
# length off K2's 128-row tile (k × 3, v + 1 past kv_valid)
ATTENTION_REFERENCES_SD3 = [(24, 256, 256, 64, 218)]
ATTENTION_RAGGED_SD3 = [(24, 4300, 4300, 64, 4201)]
# the SD3 training step at batch 2, 1024² (phase 9): the student's joint
# attention under a gradient (B = 2: BH 48) beside the 2B calls above (the
# rollout, DMD's teacher, the GAN's teacher pass); its VAE encoder's
# mid-attention is SDXL training's [2, 16384, 16384, 512]. Its 256²
# reference (phase 9b): 256 image + 154 text tokens padded to 512, masked at
# 410, on K1 at B and 2B, and the VAE encoder's mid-attention over 32²
# latents
ATTENTION_SHAPES_SD3_TRAIN = [(48, 4352, 4352, 64, 4250)]
ATTENTION_REFERENCES_SD3_TRAIN = [(48, 512, 512, 64, 410), (96, 512, 512, 64, 410), (2, 1024, 1024, 512, None)]
# the SDXL training step at batch 2, 1024² (phase 5c), where the sampling
# paths' shapes above do not have them: the student's forward under a
# gradient (B = 2: BH 20 at 4096 tokens, 40 at 1024) and the GAN's teacher
# pass (2B: 40, 80) take K1 for the cross-attention over the 77 text tokens
# (never the packed K4 under a gradient), the student's K2 self-attention at
# BH 20 and 40, the VAE encoder's mid-attention over 128² latents and the
# decoder's over the LPIPS loss's 64² latent crops (one head of D = 512)
ATTENTION_SHAPES_XL_TRAIN = [
    (20, 4096, 77, 64, None), (40, 1024, 77, 64, None), (40, 4096, 77, 64, None), (80, 1024, 77, 64, None),
    (20, 4096, 4096, 64, None), (40, 1024, 1024, 64, None), (2, 16384, 16384, 512, None),
    (2, 4096, 4096, 512, None),
]
# (b, sq, kv, h, d) of the packed one-shot kernel (K4): SDXL's
# cross-attention at level 1 and at level 2 / mid (batch 4, 77 text tokens),
# plus ragged cases (Sq off the tile, KV 200 and 256, D = 128, batch 1,
# batch 8 as under CFG). The ragged cases add 1 to every v (the packed
# kernels take no ``kv_valid``), so that a zero-filled padding key past KV
# (77 keys pad to 80, 200 to 208) that leaked into the softmax (its score
# 0, not -1e30) would pull every row's output towards 0
PACKED_SHAPES = [(4, 4096, 77, 10, 64), (4, 1024, 77, 20, 64),
                 (2, 4096, 77, 10, 64), (2, 1024, 77, 20, 64)]  # the training step's DMD student (B = 2)
PACKED_RAGGED = [
    (4, 4000, 77, 10, 64), (4, 1024, 200, 20, 64), (2, 1000, 256, 10, 64),
    (2, 1024, 77, 8, 128), (1, 4000, 256, 8, 128), (2, 1000, 200, 8, 128), (1, 4096, 77, 10, 64),
    (8, 1024, 77, 20, 64),
]
# (b, sq, kv, h, d) of the packed streaming kernel (K5) under
# FLASH_TPU_ATTN_PACKED=1: SDXL's self-attention at level 1 and at level 2 /
# mid (batch 4), plus ragged cases (Sq off the tile, KV = 4000 and off the
# tile, batch 1, D = 128), with v + 1 as K4's: a leaked key would pull every
# row's output towards 0 by 0.5% (KV 4000) to 3.3% (KV 1030) of |out| ~ 1
PACKED_STREAM_SHAPES = [(4, 4096, 4096, 10, 64), (4, 1024, 1024, 20, 64)]
PACKED_STREAM_RAGGED = [(4, 4000, 4000, 10, 64), (1, 4096, 4096, 10, 64), (1, 1000, 1030, 20, 64),
                        (2, 700, 1500, 8, 128)]
# [M, K, N] of SDXL's feed-forward down projection at batch 4, 1024² (level
# 1: 640 channels over 4096 tokens; level 2 and mid: 1280 over 1024): K12
# under FLASH_TPU_FFN_FUSED=1 (on [a | g] of [M, 2K]), K10 under
# FLASH_TPU_FFN_DOWN_GEMM=1; ragged: batch 1, M off the 128-row tile (odd
# too), the unit tests' shape; and K10's dW = xᵀ·dy of a backward at those
# shapes ([K, M] · [N, M]ᵀ)
FFN_SHAPES = [(16384, 2560, 640), (4096, 5120, 1280)]
FFN_RAGGED = [(4096, 2560, 640), (1024, 5120, 1280), (4001, 2560, 640), (1032, 2048, 128)]
FFN_DW_SHAPES = [(2560, 16384, 640), (5120, 4096, 1280)]
# (rows, C, dtype): UNet norm1/2/3 at each level, CLIP-L (fp32), plus ragged
LAYER_NORM_SHAPES = [
    (4 * 4096, 320, torch.bfloat16),
    (4 * 1024, 640, torch.bfloat16),
    (4 * 256, 1280, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16),
    (4 * 77, 768, torch.float32),
]
LAYER_NORM_RAGGED = [(4 * 1024 + 3, 640, torch.bfloat16), (1001, 320, torch.bfloat16)]
# rows of small variance (x ~ 3e-3·N(0, 1), var ≈ eps = 1e-5): a kernel that
# drops eps is off by ~√2 there, and by ~1e-6 at unit scale
LAYER_NORM_SMALL_VAR = [(1001, 320, torch.bfloat16), (4 * 256, 1280, torch.bfloat16), (4 * 77, 768, torch.float32)]
# Pixart: the DiT's affine-free LayerNorms over its 4 × 4096 tokens; in
# training at 512², over 4 × 1024 (B) and 8 × 1024 (2B)
LAYER_NORM_SHAPES_PIXART = [(4 * 4096, 1152, torch.bfloat16), (4 * 1024, 1152, torch.bfloat16),
                            (8 * 1024, 1152, torch.bfloat16)]
# SD3 at batch 4, 1024²: the MMDiT's affine-free LayerNorms over the image
# stream (4 × 4096 rows) and the padded context stream (4 × 256 rows; with
# T5, 4 × 384), width 1536; the 128² references' (64 image rows, 192
# context rows) and CLIP-L's and CLIP-G's fp32 rows of one prompt there
LAYER_NORM_SHAPES_SD3 = [(4 * 4096, 1536, torch.bfloat16), (4 * 256, 1536, torch.bfloat16),
                         (4 * 384, 1536, torch.bfloat16)]
LAYER_NORM_REFERENCES_SD3 = [(64, 1536, torch.bfloat16), (192, 1536, torch.bfloat16), (77, 768, torch.float32),
                             (77, 1280, torch.float32)]
# the SD3 training step at batch 2, 1024² (phase 9): the image stream at B
# (2 × 4096 rows) and the padded context stream at B (2 × 256); the 2B rows
# are the sampling shapes above, CLIP's fp32 rows SDXL training's (2 × 77).
# Its 256² reference (9b) launches [512, 1536] and [1024, 1536]: both
# streams at 256 rows a sample
LAYER_NORM_SHAPES_SD3_TRAIN = [(2 * 4096, 1536, torch.bfloat16), (2 * 256, 1536, torch.bfloat16)]
# SDXL: UNet norm1/2/3 at levels 1 and 2 (bf16); CLIP-G and CLIP-L (fp32);
# then the training step's at batch 2 (the student, DMD's student; the
# text towers' three passes)
LAYER_NORM_SHAPES_XL = [
    (4 * 4096, 640, torch.bfloat16),
    (4 * 1024, 1280, torch.bfloat16),
    (4 * 77, 1280, torch.float32),
    (4 * 77, 768, torch.float32),
    (2 * 4096, 640, torch.bfloat16),
    (2 * 1024, 1280, torch.bfloat16),
    (2 * 77, 1280, torch.float32),
    (2 * 77, 768, torch.float32),
]
# (bh, sq, kv, d, kv_valid) of the attention backward of one training step
# at batch 4, 512² (8 heads): the student's (BH 32) and the GAN branch's
# teacher down path and mid block at 2B (BH 64), self-attention per level
# and cross-attention over the 77 text tokens; and the VAE decoder's
# single-head mid-attention under the LPIPS loss. Ragged: Sq off the tile,
# KV 200, kv_valid < KV, batch 1 (BH 8; VAE BH 1)
BWD_LEVELS = [
    (4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
    (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160),
]
BWD_SHAPES = [(bh, sq, kv, d, None) for bh in (32, 64) for sq, kv, d in BWD_LEVELS]
BWD_SHAPES.append((4, 4096, 4096, 512, None))
BWD_RAGGED = [
    (32, 4000, 77, 40, None), (64, 1000, 200, 80, 150), (8, 4096, 4096, 40, 3001),
    (8, 4000, 77, 40, 70), (1, 700, 4096, 512, 3000), (64, 300, 2000, 160, 1999),
    (20, 4000, 77, 64, 70), (40, 1000, 1100, 64, 1037),  # K8 and the pair at SDXL's D
]
# the SDXL training step at batch 2, 1024² (D = 64): the student's backward
# (BH 20 at 4096 tokens, 40 at 1024) and the GAN's teacher pass at 2B (40,
# 80), self-attention on the pair and cross-attention over the 77 text
# tokens on K8; the VAE decoder's mid-attention under the LPIPS loss
BWD_SHAPES_XL = [(bh, sq, kv, 64, None) for sq, bh in ((4096, 20), (1024, 40), (4096, 40), (1024, 80))
                 for kv in (sq, 77)]
BWD_SHAPES_XL.append((2, 4096, 4096, 512, None))
# the Pixart training step at batch 4, 512² (D = 72, padded to 80 in the
# pair): the student's self-attention backward (BH 64) and the GAN's
# teacher pass at 2B (BH 128) over 1024 tokens; its cross-attention carries
# the T5 mask bias and takes the plain path. Ragged: Sq and KV off the 64-
# and 128-row tiles, kv_valid < KV (k × 3, v + 1 past it)
BWD_SHAPES_PIXART = [(64, 1024, 1024, 72, None), (128, 1024, 1024, 72, None)]
BWD_RAGGED.append((16, 1000, 1100, 72, 1037))
# the SD3 training step at batch 2, 1024² (phase 9): the joint attention's
# backward over the 4352-row sequence masked at 4250 (k × 3, v + 1 past it;
# dk, dv exactly 0 there), the student's (BH 48) and the GAN's teacher pass
# at 2B (BH 96), timed against SDPA's backward under the same boolean key
# mask; and its 256² reference's (9b) at 410 of 512 keys, on the pair too
BWD_SHAPES_SD3 = [(48, 4352, 4352, 64, 4250), (96, 4352, 4352, 64, 4250)]
BWD_REFERENCES_SD3 = [(48, 512, 512, 64, 410), (96, 512, 512, 64, 410)]
# [B, C, H, W] of every GroupNorm of the paths at batch 4 (bf16): the SD1.5
# UNet's levels at 512², the SDXL UNet's at 1024², the SD VAE decoder at
# 512² (SD1.5) and at 1024² (SDXL, Pixart: the largest, [4, 128, 1024²]);
# ragged N (off the 16-byte step, odd, one element), C = 36 (channels-last
# rows off the 16-byte step) and fp32 (the discriminator's) besides. The training path's UNet runs the SD1.5 shapes
# at batch 4 and 8.
GN_SHAPES = [
    (4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 16, 16), (4, 1280, 8, 8),
    (4, 320, 128, 128), (4, 640, 64, 64), (4, 1280, 32, 32),
    (4, 512, 64, 64), (4, 512, 128, 128), (4, 512, 256, 256), (4, 256, 256, 256), (4, 256, 512, 512),
    (4, 128, 512, 512),
    (4, 512, 512, 512), (4, 256, 1024, 1024), (4, 128, 1024, 1024),
]
GN_RAGGED = [((3, 96, 37, 29), torch.bfloat16), ((2, 64, 4099, 1), torch.bfloat16), ((2, 32, 1, 1), torch.bfloat16),
             ((2, 36, 5, 7), torch.bfloat16), ((4, 512, 2, 2), torch.float32), ((2, 96, 37, 29), torch.float32)]
# the SDXL training step at 1024² (phase 5c): every UNet GroupNorm at batch
# 2 (the student) and 4 (the rollout, DMD's and the GAN's teacher), the up
# blocks' concatenated inputs (960–2560 channels) included; the VAE encoder
# over the 1024² images and the decoder over the LPIPS loss's 64² latent
# crops at batch 2 (bf16); the 256-feature discriminator's two GroupNorms
# (fp32, 4 groups) over SDXL's 32² mid features
GN_SHAPES_XL_TRAIN = [((b, c, hw, hw), torch.bfloat16, None) for b in (2, 4) for c, hw in (
    (320, 128), (640, 128), (960, 128), (320, 64), (640, 64), (960, 64), (1280, 64), (1920, 64),
    (640, 32), (1280, 32), (1920, 32), (2560, 32))]
GN_SHAPES_XL_TRAIN += [((2, c, hw, hw), torch.bfloat16, None) for c, hw in (
    (128, 1024), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128), (512, 64))]
GN_SHAPES_XL_TRAIN += [((2, 512, 8, 8), torch.float32, 4), ((2, 1024, 4, 4), torch.float32, 4)]
# the Pixart training step at 512² (phase 7c): the SD VAE encoder over 4
# images at 512² (bf16; its 128@512², 256@256², 512@128² and 512@64² levels
# are in GN_SHAPES, the decoder's), and the 64-feature discriminator's two
# GroupNorms (fp32, 4 groups) over the DiT's 64² output latents
GN_SHAPES_PIXART_TRAIN = [((4, 128, 256, 256), torch.bfloat16, None), ((4, 256, 128, 128), torch.bfloat16, None),
                          ((4, 128, 16, 16), torch.float32, 4), ((4, 256, 8, 8), torch.float32, 4)]
# the SD3 training step at 1024² (phase 9): its VAE encoder at batch 2 is
# SDXL training's (the same channels and groups); the 64-feature, 4-stage
# discriminator's three GroupNorms (fp32, 4 groups) over the MMDiT's 128²
# post-mid features, of which [2, 512, 8, 8] is SDXL's. Its 256² reference
# (9b): the VAE encoder over 2 images at 256² and the 3-stage
# discriminator's two GroupNorms over 32² features (gated untimed)
GN_SHAPES_SD3_TRAIN = [((2, 128, 32, 32), torch.float32, 4), ((2, 256, 16, 16), torch.float32, 4)]
GN_REFERENCES_SD3_TRAIN = [((2, c, hw, hw), torch.bfloat16, None) for c, hw in (
    (128, 256), (128, 128), (256, 128), (256, 64), (512, 64), (512, 32))]
GN_REFERENCES_SD3_TRAIN += [((2, 128, 8, 8), torch.float32, 4), ((2, 256, 4, 4), torch.float32, 4)]
# the SD1.5 training run (phase 10) at 512², batch 4: the rollout's, DMD's
# and the GAN's 2B = 8 forward (BH 64; 4 the eval pass's too) and the
# validation student at B = 2 (BH 16; its teacher at 2B = 4 is BH 32,
# sampling's), at every UNet level
ATTENTION_SHAPES_TRAIN_RUN = [(bh, sq, kv, d, None) for bh in (16, 64) for sq, kv, d in BWD_LEVELS]
LAYER_NORM_SHAPES_TRAIN_RUN = [(rows, c, torch.bfloat16) for rows, c in (
    (8 * 4096, 320), (2 * 4096, 320), (2 * 1024, 640), (8 * 64, 1280), (2 * 64, 1280))]
GN_SHAPES_TRAIN_RUN = [((b, c, hw, hw), torch.bfloat16, None) for b, c, hw in (
    (2, 320, 32), (2, 640, 16), (2, 960, 32), (2, 1280, 8), (2, 1280, 16), (2, 1920, 16), (2, 2560, 8),
    (2, 2560, 16), (4, 320, 32), (4, 640, 16), (4, 960, 32), (4, 1920, 16), (4, 2560, 8), (4, 2560, 16),
    (8, 320, 32), (8, 320, 64), (8, 640, 16), (8, 640, 32), (8, 640, 64), (8, 960, 32), (8, 960, 64),
    (8, 1280, 8), (8, 1280, 16), (8, 1280, 32), (8, 1920, 16), (8, 1920, 32), (8, 2560, 8), (8, 2560, 16))]
# the DPT's self-attention at 384² (phase 11c): ViT-L/16 over 576 patches
# and the class token, 16 heads of D = 64, one image a call; K1's one-shot
# plan at 64 q rows (align128(577) = 640 > 256 keeps it off the packed K4).
# The Canny adapter run (phase 11) launches the training run's shapes
ATTENTION_SHAPES_DPT = [(16, 577, 577, 64, None)]
# the Canny adapter's training reference at 256², batch 2 (phase 11b; gated
# and timed, outside the paths' sums): SD1.5's UNet at 32², 16², 8² and 4²
# latents in the student's B = 2 (BH 16) and the 2B = 4 passes (BH 32), the
# backward of both, their LayerNorms and GroupNorms; the rest of its shapes
# are the paths'
LEVELS_256 = ((1024, 1024, 40), (1024, 77, 40), (256, 256, 80), (256, 77, 80), (16, 16, 160), (16, 77, 160))
ATTENTION_REFERENCES_CANNY = [(bh, sq, kv, d, None) for bh in (16, 32) for sq, kv, d in LEVELS_256]
BWD_REFERENCES_CANNY = ATTENTION_REFERENCES_CANNY + [(16, 64, 64, 160, None), (16, 64, 77, 160, None)]
LAYER_NORM_REFERENCES_CANNY = [(rows, c, torch.bfloat16) for rows, c in (
    (4096, 320), (2048, 320), (1024, 640), (512, 640), (64, 1280), (32, 1280))]
GN_REFERENCES_CANNY = [((b, c, hw, hw), torch.bfloat16, None) for b in (2, 4) for c, hw in (
    (320, 16), (960, 16), (640, 8), (1920, 8), (1280, 4), (2560, 4))]
# the eval path (phase 12): CLIP ViT-L/14 at 224² over the eval batch of 4,
# 256 patches and the class token, 16 heads of D = 64 (align128(257) = 384 >
# 256 keeps it off the packed K4: K1's one-shot plan), its 50 LayerNorms a
# pass over [4·257, 1024] and the pooled [4, 1024]; [16, 257, 257, 64] is
# one image's. SD1.5 sampling at batch 4 launches phase 3's shapes, the
# CLIP text tower for CLIPScore phase 3's fp32 LayerNorm
EVAL_BATCH = 4
ATTENTION_SHAPES_EVAL = [(EVAL_BATCH * 16, 257, 257, 64, None)]
ATTENTION_EVAL_SINGLE = [(16, 257, 257, 64, None)]
LAYER_NORM_SHAPES_EVAL = [(EVAL_BATCH * 257, 1024, torch.bfloat16), (EVAL_BATCH, 1024, torch.bfloat16)]
# the toy proofs (phase 12b) under bf16 autocast: the toy UNet's attention,
# 2 heads of D = 32 over its 8² level, at batch 48 (teacher steps, the
# student, the evaluation's samples) and 2B = 96 (the rollout's, DMD's and
# the GAN's calls), forward and backward; in fp32, as autocast runs
# normalizations, its LayerNorms at width 64 and its GroupNorms (8 groups)
# over 32–128 channels at 16² and 8²
TOY_STEPS, TOY_BATCH = (20, 5), 48
TOY_BATCHES = (TOY_BATCH, 2 * TOY_BATCH)
ATTENTION_SHAPES_TOY = [(2 * b, 64, 64, 32, None) for b in TOY_BATCHES]
BWD_SHAPES_TOY = ATTENTION_SHAPES_TOY
LAYER_NORM_SHAPES_TOY = [(64 * b, 64, torch.float32) for b in TOY_BATCHES]
GN_SHAPES_TOY = [((b, c, hw, hw), torch.float32, 8) for b in TOY_BATCHES for c, hw in (
    (32, 16), (64, 16), (96, 16), (32, 8), (64, 8), (96, 8), (128, 8))]
# phase 9's sampling callback: SD3 at 1024², batch 1 (the joint attention
# at BH 24, the VAE decoder with its single-head mid-attention)
ATTENTION_SHAPES_SD3_SAMPLE = [(24, 4352, 4352, 64, 4250), (1, 16384, 16384, 512, None)]
LAYER_NORM_SHAPES_SD3_SAMPLE = [(4096, 1536, torch.bfloat16), (256, 1536, torch.bfloat16)]
GN_SHAPES_SD3_SAMPLE = [((1, c, hw, hw), torch.bfloat16, None) for c, hw in (
    (128, 1024), (256, 512), (256, 1024), (512, 128), (512, 256), (512, 512))]
# The paths' shapes of each check (timed), read at call time so that a
# caller may narrow the lists above; GroupNorm cases are (shape, dtype,
# the path's group count or None)
def attention_main():
    return (ATTENTION_SHAPES + ATTENTION_SHAPES_XL + ATTENTION_SHAPES_PIXART + ATTENTION_SHAPES_XL_TRAIN
            + ATTENTION_SHAPES_SD3 + ATTENTION_SHAPES_SD3_TRAIN + ATTENTION_SHAPES_SD3_SAMPLE
            + ATTENTION_SHAPES_TRAIN_RUN + ATTENTION_SHAPES_DPT + ATTENTION_SHAPES_EVAL + ATTENTION_SHAPES_TOY)


def layer_norm_main():
    return (LAYER_NORM_SHAPES + LAYER_NORM_SHAPES_XL + LAYER_NORM_SHAPES_PIXART + LAYER_NORM_SHAPES_SD3
            + LAYER_NORM_SHAPES_SD3_TRAIN + LAYER_NORM_SHAPES_SD3_SAMPLE + LAYER_NORM_SHAPES_TRAIN_RUN
            + LAYER_NORM_SHAPES_EVAL + LAYER_NORM_SHAPES_TOY)


def gn_main():
    return ([(s, torch.bfloat16, None) for s in GN_SHAPES] + GN_SHAPES_XL_TRAIN + GN_SHAPES_PIXART_TRAIN
            + GN_SHAPES_SD3_TRAIN + GN_SHAPES_SD3_SAMPLE + GN_SHAPES_TRAIN_RUN + GN_SHAPES_TOY)


def bwd_main():
    return BWD_SHAPES + BWD_SHAPES_XL + BWD_SHAPES_PIXART + BWD_SHAPES_SD3 + BWD_SHAPES_TOY


def references():
    """The small references' shapes (and the ragged joint length) phase 2
    times beside the kernel with the library call and the bound, printed,
    outside the paths' sums: SD3 sampling's 128² (8b, 8e), its training
    step's 256² (9b)."""
    return set(ATTENTION_REFERENCES_SD3 + ATTENTION_RAGGED_SD3 + ATTENTION_REFERENCES_SD3_TRAIN
               + LAYER_NORM_REFERENCES_SD3 + BWD_REFERENCES_SD3)


def int8_main():
    return INT8_SHAPES + INT8_SHAPES_PIXART + INT8_SHAPES_SD3


def attention_unmain():
    """The forward attention cases phase 2 checks untimed."""
    return ATTENTION_RAGGED + ATTENTION_V_SHIFTED + ATTENTION_REFERENCES + ATTENTION_REFERENCES_SD3 + \
        ATTENTION_RAGGED_SD3 + ATTENTION_REFERENCES_SD3_TRAIN + ATTENTION_REFERENCES_CANNY + ATTENTION_EVAL_SINGLE


def bwd_unmain():
    """The attention backward cases phase 2 checks outside the paths' sums."""
    return BWD_RAGGED + BWD_REFERENCES_SD3 + BWD_REFERENCES_CANNY


def layer_norm_unmain():
    """The LayerNorm cases phase 2 checks outside the paths' sums."""
    return LAYER_NORM_RAGGED + LAYER_NORM_REFERENCES_SD3 + LAYER_NORM_REFERENCES_CANNY


def gn_unmain():
    """The GroupNorm cases phase 2 checks untimed."""
    return [(shape, dtype, None) for shape, dtype in GN_RAGGED] + GN_REFERENCES_SD3_TRAIN + GN_REFERENCES_CANNY


def int8_extra():
    """The int8 cases phase 2 checks untimed (M, K, N, bias + gelu)."""
    return INT8_EXTRA + INT8_REFERENCES_SD3


def gn_groups(shape, groups=None):
    """The group count phase 2 checks a GroupNorm shape at: the path's own,
    else 32 where C allows, else the most that leave a group 32 elements (a
    group of a few elements can have var ≪ eps, and inv up to rsqrt(eps) ≈
    316, where the scale and shift rounded to bf16, JAX's rounding and the
    plain version's too, leave y off by an ulp of 316·x)."""
    c, n = shape[1], shape[2] * shape[3]
    return groups or next(k for k in (32, 16, 8, 4, 2, 1) if c % k == 0 and n * c // k >= 32)


def gated_shapes():
    """{kernel: the shape keys phase 2 checks it at}, in the keys of the
    ``LAUNCHES`` of ``ops/attention.py`` and ``ops/norms.py``; the GroupNorm's
    resident and statistics kernels with the group count (None: the
    statistics alone), the apply kernel without."""
    fwd = set(attention_main() + attention_unmain())
    bwd = set(bwd_main() + bwd_unmain())
    cases = gn_main() + gn_unmain()
    gn = {(shape, dtype, gn_groups(shape, groups)) for shape, dtype, groups in cases}
    gn_stats = gn | {(shape, dtype, None) for shape, dtype, _ in cases}
    gn_apply = {(shape, dtype) for shape, dtype, _ in cases}
    return {"flash_fwd_oneshot": fwd, "flash_fwd_stream": fwd,
            "flash_fwd_oneshot_packed": set(PACKED_SHAPES + PACKED_RAGGED),
            "flash_fwd_packed": set(PACKED_STREAM_SHAPES + PACKED_STREAM_RAGGED),
            "flash_bwd_oneshot": bwd, "flash_bwd_dkv": bwd, "flash_bwd_dq": bwd,
            "layer_norm": set(layer_norm_main() + layer_norm_unmain() + LAYER_NORM_SMALL_VAR),
            "group_norm_stats": gn_stats, "group_norm_apply": gn_apply, "group_norm_fused": gn,
            "int8_gemm": set(int8_main() + [case[:3] for case in int8_extra()])}


# the training phases: every step in stage 1 of the yaml's four
TRAIN_OVERRIDES = {"NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
# the training reference at 256²: one stage, at stage 1's loss scales. SD3's
# (phase 9b) holds a 3-stage discriminator, not the yaml's 4
# (``train._discriminator`` fits the stages to the image): its post-mid
# features are 32², and 4 stages reduce them to 2² before the 4×4 head
TRAIN_REF_OVERRIDES = {
    "IMAGE_SIZE": 256, "K": [4], "NUM_ITERATIONS_PER_K": [10], "MODE_PROBS": [[0.25] * 4],
    "LPIPS_CROP": 16, "DISTILL_LOSS_SCALE": 1.0, "DMD_LOSS_SCALE": 0.3, "ADVERSARIAL_LOSS_SCALE": 0.1,
}
TRAIN_REF_LORA_B_STD = 1e-3  # B ≠ 0, so that A has a gradient too
# phases 5d and 7d: the rollout start of the SDXL and Pixart references.
# SDXL: with lower_order_final a start at K − 2 runs only first-order steps,
# so K − 3: a first-order step, a second-order one, the final one. Pixart:
# K − 1, one noised DDPM step (K − 2's second such step cost the CPU copy
# time that phase 12 now takes). From its starts 0 and 1 (t = 999, 749) the
# random teacher's x̂₀ is (x − √(1−ᾱ)·ε)/√ᾱ with 1/√ᾱ = 156 and 17 on linear
# betas, and the DMD loss, a squared difference of two nearly equal bf16
# DiT forwards, then falls to ~2e-4 and differs from fp32 by ~0.13 relative:
# bf16 rounding at that conditioning, with or without a kernel
# SD3: K − 2, two flow-match Euler steps from the σ-interpolation (the
# rollout is deterministic, every step the same first-order step; start 0,
# pure noise, is held against JAX in tests/test_torch_sd3_train.py)
# SD1.5 with the Canny adapter (11b): K − 1, one noised DDPM step, to bound
# the CPU copy's time
TRAIN_REF_START = {"sdxl": 1, "pixart": 3, "sd3": 2, "sd15-canny": 3}
# phase 7d: the models whose reference holds the discriminator's outputs on
# the card's features (its inputs, each call's, handed to the CPU copy's
# discriminator, as 7d hands over the card's ``__conds``) and prints them
# end to end ungated. Pixart's discriminator reads the DiT's bf16 output
# latents, which differ from the fp32 copy's by ≈ 2% (printed), and its
# randomly initialised logits are small, so end to end they differ by
# several percent, about the 0.05 tolerance, from seed to seed, while the
# discriminator itself (cuDNN's fp32 convolutions, the fp32 GroupNorm
# kernels) agrees to fp32 rounding on the same inputs
DISC_ON_CARD_FEATURES = ("pixart",)
# phase 9b: the tolerance of SD3's distill and DMD losses against the fp32
# CPU copy (5b's is 0.05). bf16 itself puts them 4.6e-2–7.4e-2 (distill) and
# 5.3e-2–5.8e-2 (DMD) from fp32 at rollout starts 0, 1 and 3, with no kernel:
# the CPU copy in bf16 (the plain paths) sits there, and the card within
# 2.6e-3 of it (``train_ref_precision.py --model sd3 --starts 1 3 0``); the
# losses are squares of small differences of 24-block bf16 MMDiT outputs,
# the teacher's under CFG 3–7. 0.1 leaves 1.8× the floor at start 1
TRAIN_REF_LOSS_TOL = {"sd3": 0.1}
# LoRA pairs that no loss reaches, whose B stays at its 0 (their gradient is
# exactly 0, as in JAX): the MMDiT's final block runs context_pre_only, so
# its context queries (add_q_proj) feed only the context rows it drops
INERT_LORA = {"sd3": ("transformer_blocks.23.attn.add_q_proj",)}
# [M, K, N] of every int8 product of SDXL 1024² at batch 4, guidance 0:
# at the 64² level q/k/v/out, attn2 q/out and proj_in/proj_out, the
# cross-attention k/v over the 77 text tokens, ff.net.0.proj, ff.net.2;
# then the same at the 32² level and the mid block
INT8_SHAPES = [
    (16384, 640, 640), (308, 2048, 640), (16384, 640, 5120), (16384, 2560, 640),
    (4096, 1280, 1280), (308, 2048, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
]
# Pixart-α 1024² at batch 4 (phase 7e): q/k/v/out and attn2 q/out over
# 16384 tokens, attn2 k/v over 4 × 120 T5 tokens, ff.net.0.proj (its
# tanh-gelu a separate op, as in JAX) and ff.net.2
INT8_SHAPES_PIXART = [(16384, 1152, 1152), (480, 1152, 1152), (16384, 1152, 4608), (16384, 4608, 1152)]
# SD3-medium 1024² at batch 4 (phase 8e): q/k/v/out and ff.net.0.proj,
# ff.net.2 over the image stream's 16384 rows; to_add_out and the
# ff_context pair over the padded context stream's 1024 rows (q/k/v there
# are add_*_proj, which stay bf16); then the 128² reference's 64 and 192
# rows, untimed
INT8_SHAPES_SD3 = [(16384, 1536, 1536), (16384, 1536, 6144), (16384, 6144, 1536),
                   (1024, 1536, 1536), (1024, 1536, 6144), (1024, 6144, 1536)]
INT8_REFERENCES_SD3 = [(m, k, n, False) for m in (64, 192) for k, n in ((1536, 1536), (1536, 6144), (6144, 1536))]
# (M, K, N, bias + gelu): batch 1's k/v (M = 77), ragged M and N, the
# epilogue with bias and tanh-gelu, K not a multiple of the 64-byte step
INT8_EXTRA = [(77, 2048, 640, False), (4001, 1280, 1000, False), (4096, 1280, 10240, True),
              (300, 96, 130, True)]
# phase 6: the LoRA (B ~ N(0, 0.01) changes the attention and feed-forward
# weights by ~14%), the batcher's linger window (long enough for the 4
# clients a dispatch answers to send their next requests), and the load: 8
# clients in a closed loop, 8 requests each, so that p95 is a percentile of
# 64 latencies (the 61st) and not the slowest of a few
SERVE_LORA_RANK, SERVE_LORA_B_STD, SERVE_LINGER_MS = 64, 0.01, 1000.0
SERVE_CLIENTS, SERVE_REQUESTS_PER_CLIENT = 8, 8
SERVE_INT8_LAYERS = 722  # 70 transformer blocks × 10 + 11 spatial transformers × 2
PIXART_INT8_LAYERS = 280  # 28 DiT blocks × 10
SD3_INT8_LAYERS = 213  # 23 joint blocks × 9 + the final block's 6
# H100 SXM peaks (NVIDIA's data sheet; dense, at 700 W)
HBM_BYTES_PER_S, BF16_OPS_PER_S, FP32_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 67e12, 1979e12
# tolerances, kernel (bf16) vs plain (fp32): the attention forwards (K1,
# K2, K4, K5) are held to ops/attention.py attention_fwd_gate, LayerNorm
# (K3) to ops/norms.py layer_norm_gate, the whole GroupNorm to
# group_norm_gate
# GroupNorm statistics (fp32 sums in another order than the fp64 plain
# version): Σx to GN_STATS_TOL of Σ|x|, Σx² to GN_STATS_TOL relative
GN_STATS_TOL = 1e-5
# a request alone vs in slot 1 of a batch of 4: cuDNN's and cuBLAS's
# batch-size-dependent algorithms (measured on an H100: 9.2e-3 in bf16,
# 9.8e-3 in int8; the contract of FlashPipeline.generate)
BATCH_INVARIANCE_TOL = 1.5e-2
# phases 3c and 4c: the JAX package's opt-in kernel modes of SDXL, as (path,
# switches, the exact launches of a batch-4, 4-step 1024² generate: 70
# feed-forwards and 70 self-attentions a UNet call, the VAE's one K2 call)
SWITCHES = ("FLASH_TPU_ATTN_PACKED", "FLASH_TPU_FFN_FUSED", "FLASH_TPU_FFN_DOWN_GEMM")
SDXL_MODES = [
    ("sdxl_packed_fused", {"FLASH_TPU_ATTN_PACKED": "1", "FLASH_TPU_FFN_FUSED": "1"},
     {"geglu_gemm": 280, "flash_fwd_packed": 280, "gemm": 0, "flash_fwd_stream": 1}),
    ("sdxl_down_gemm", {"FLASH_TPU_FFN_DOWN_GEMM": "1"}, {"gemm": 280, "geglu_gemm": 0, "flash_fwd_packed": 0}),
]
# a mode's images vs the default mode's (same seeds): tanh-gelu rounded
# once, other sums and roundings (the default's own batch-size spread is
# 9.2e-3)
MODE_IMAGE_TOL = 5e-2
PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a raccoon reading a book in a library",
    "a bowl of ramen, studio lighting",
    "a lighthouse on a cliff at dusk",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 3, calls: int = 10) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, queued behind a GPU sleep so that host launch overhead does not
    show; the median over ``reps`` such runs, divided by ``calls``. After a
    warm-up call, one call queued the same way sets ``calls`` to 2 where it
    took 1 ms or more (the events' and the gaps' share is then below 0.1%)."""
    def queued(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of GPU cycles while the host queues the calls
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    fn()
    torch.cuda.synchronize()
    if queued(1) >= 1.0:
        calls = min(calls, 2)
    return statistics.median(queued(calls) for _ in range(reps))


def library_ms(make):
    """Device time of a PyTorch library call (a yardstick, never on the
    port's path): ``make()`` sets it up and returns the call. None, with the
    reason printed, where the library cannot run it at this shape."""
    try:
        return median_ms(make())
    except RuntimeError as e:
        print(f"  library call unavailable here: {str(e).splitlines()[0][:160]}")
        torch.cuda.empty_cache()
        return None


def bound(ops: float, nbytes: float, ops_per_s: float = BF16_OPS_PER_S):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def new_row(route, source, replaces):
    return dict(route=route, source=source, replaces=replaces, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                library_ms=0.0, bound_ms=0.0, bound_by={"bytes": 0.0, "operations": 0.0})


def add_times(r, ms, plain, library, bnd):
    """Adds one main-path shape's times to a kernel's row."""
    r["ms"] += ms
    r["plain_ms"] += plain
    r["library_ms"] = None if library is None or r["library_ms"] is None else r["library_ms"] + library
    r["bound_ms"] += bnd[0]
    r["bound_by"][bnd[1]] += bnd[0]


def fmt_ms(x):
    return "n/a" if x is None else f"{x:.4f}"


def check_attention(attention, results, timed=True):
    """K1 (``flash_fwd_oneshot``) and K2 (``flash_fwd_stream``) against the
    plain version in fp32 on the same bf16 inputs, every case printed, then
    a raise listing the failures. Both are held to ``attention_fwd_gate``
    (max|out err| ≤ 4e-3 + 2⁻⁸·max|ref|, |mean err| ≤ 5e-4, max|lse err| ≤
    5e-3). On the ragged cases the keys at or past ``kv_valid`` are
    k × 3 and v + 1, and ATTENTION_V_SHIFTED adds 1 to every v, so that a
    masked key, or a zero-filled padding row past KV, leaking into the
    softmax shows as a mean error. With ``timed``, the kernel's and the plain
    version's times, and at the paths' shapes the library's and the bound."""
    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    main_shapes, refs = attention_main(), references()
    for shape in main_shapes + attention_unmain():
        bh, sq, skv, d, kv_valid = shape
        q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, skv, skv))
        if kv_valid is not None:
            k[:, kv_valid:] *= 3
            v[:, kv_valid:] += 1
        if shape in ATTENTION_V_SHIFTED:
            v += 1
        scale = d ** -0.5
        kind = attention.attention_plan(kv_valid or skv, d)[0]
        out, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.attention_bhsd_reference(
            q.float(), k.float(), v.float(), scale, kv_valid)
        stats = attention.attention_fwd_errors(out, lse, ref_out, ref_lse)
        del ref_out, ref_lse
        ok, report = attention.attention_fwd_gate(stats)
        err = stats["max_err"]
        checks = f"{'pass' if ok else 'FAIL'}: {report}"
        main = shape in main_shapes
        times = ""
        if timed:
            ms = median_ms(lambda: attention.flash_attention_bhsd(q, k, v, scale, kv_valid))
            plain = median_ms(lambda: attention.attention_bhsd_reference(q, k, v, scale, kv_valid))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        # q, k, v, out in bf16 and the fp32 lse; q·kᵀ and p·v over the valid keys
        if timed and (main or shape in refs):
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=key_mask(skv, kv_valid), scale=scale))
            bnd = bound(4 * bh * sq * (kv_valid or skv) * d, 2 * bh * (2 * sq + 2 * skv) * d + 4 * bh * sq)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
            if main:
                add_times(results[kind], ms, plain, library, bnd)
        print(f"attention {kind:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} kv_valid={kv_valid}"
              f"{' (k x3, v +1 past it)' if kv_valid else ''}{' (v +1)' if shape in ATTENTION_V_SHIFTED else ''}: "
              f"{checks}{times}")
        if not ok:
            failed.append(shape)
        r = results[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del q, k, v, out, lse
    if failed:
        raise AssertionError(f"attention kernel disagrees with its plain version at {failed}")


def check_packed(attention, results, name, shapes, ragged, seed, timed=True):
    """A packed kernel (K4 ``flash_fwd_oneshot_packed``, K5
    ``flash_fwd_packed``) against the packed plain version (the function of
    both) in fp32 on the same bf16 inputs, every case printed, then a raise
    listing the failures. Both are held to ``attention_fwd_gate`` without
    its lse term (max|out err| ≤ 4e-3 + 2⁻⁸·max|ref|, rel. L2 ≤ 4e-3, |mean
    err| ≤ 5e-4); the ragged cases add 1 to every v, so that a zero-filled
    key past KV leaking into the softmax shows as a mean error. With
    ``timed``, the kernel's and the plain version's times, and at the
    paths' shapes the library's (``F.scaled_dot_product_attention`` on the
    [B, H, S, D] views of the same tensors, no copy) and the bound: q, k,
    v, out in bf16 once (no lse); q·kᵀ and p·v, 4·B·H·Sq·KV·D operations."""
    kernel = attention.flash_attention_packed_stream if name == "flash_fwd_packed" else attention.flash_attention_packed
    g = torch.Generator(device="cuda").manual_seed(seed)
    failed = []
    for b, sq, kv, h, d in shapes + ragged:
        main = (b, sq, kv, h, d) in shapes
        q, k, v = (torch.randn(b, s, h * d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, kv, kv))
        if not main:
            v += 1
        scale = d ** -0.5
        out = kernel(q, k, v, h, scale)
        torch.cuda.synchronize()
        ref = attention.attention_packed_reference(q.float(), k.float(), v.float(), h, scale)
        stats = attention.attention_fwd_errors(out, None, ref, None)
        del ref
        ok, report = attention.attention_fwd_gate(stats)
        times = ""
        if timed:
            ms = median_ms(lambda: kernel(q, k, v, h, scale))
            plain = median_ms(lambda: attention.attention_packed_reference(q, k, v, h, scale))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if timed and main:
            heads = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), scale=scale))
            bnd = bound(4 * b * h * sq * kv * d, 2 * b * (2 * sq + 2 * kv) * h * d)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
            add_times(results[name], ms, plain, library, bnd)
        print(f"attention {name} b={b} sq={sq:4d} kv={kv:4d} h={h:2d} d={d:3d}{'' if main else ' (v +1)'}: "
              f"{'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append((b, sq, kv, h, d))
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        del q, k, v, out
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{name} kernel disagrees with its plain version at {failed}")


def check_ffn_gemm(gemm, results, timed=True):
    """K12 and K10 against their plain versions in fp32, held to
    ``gemm_gate`` (|err| within 2^-8·|y| + 2^-8·max|y| at every element,
    relative L2 within 4e-3, mean signed error within 1e-4 of rms|y|), and
    the plain version on the kernel's own bf16 inputs (its rounding
    contract; printed); K10 also at its dW shapes. Every case printed, then
    a raise listing the failures. With ``timed``, the kernel's time, and at
    SDXL's shapes the plain version's, the library's (K10: ``F.linear(x, W,
    b)``; K12: no one PyTorch call computes it, so the unfused ``F.linear(a
    * F.gelu(g, "tanh"), W, b)``) and the bound: 2·M·K·N operations, or x
    (K12: a and g), W, b read and y written once in bf16."""
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(True, s) for s in FFN_SHAPES + FFN_RAGGED] + [(False, s) for s in FFN_SHAPES + FFN_RAGGED + FFN_DW_SHAPES]
    failed = []
    for geglu, (m, k, n) in cases:
        name = "geglu_gemm" if geglu else "gemm"
        kernel = gemm.geglu_gemm if geglu else gemm.gemm
        plain_fn = gemm.geglu_down_proj_reference if geglu else gemm.down_proj_gemm_reference
        x = torch.randn(m, 2 * k if geglu else k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(n, generator=g, device="cuda")).to(torch.bfloat16)
        y = kernel(x, w, b)
        torch.cuda.synchronize()
        ref = plain_fn(x.float(), w.float(), b.float())
        stats = gemm.gemm_errors(y, ref)
        ok, report = gemm.gemm_gate(stats)
        contract = (y.float() - plain_fn(x, w, b).float()).abs().max().item()
        del ref
        main = (m, k, n) in FFN_SHAPES
        dw = not geglu and (m, k, n) in FFN_DW_SHAPES
        times = ""
        if timed:
            ms = median_ms(lambda: kernel(x, w, b))
            times = f"; kernel {ms:.4f} ms"
        if timed and (main or dw):
            plain = median_ms(lambda: plain_fn(x, w, b))
            if geglu:
                library = library_ms(lambda: lambda: F.linear(
                    x[:, :k] * F.gelu(x[:, k:], approximate="tanh"), w, b))
            elif dw:  # dW = xᵀ·dy as one product (x here is xᵀ, w is dyᵀ)
                library = library_ms(lambda: lambda: torch.mm(x, w.t()))
            else:
                library = library_ms(lambda: lambda: F.linear(x, w, b))
            bnd = bound(2 * m * k * n, 2 * (x.numel() + w.numel() + n + m * n))
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        what = "dW " if dw else ""
        print(f"{name:10s} {what}M={m:5d} K={k:5d} N={n:4d}: {'pass' if ok else 'FAIL'}: {report}; "
              f"vs the plain version in bf16 {contract:.3e}{times}")
        if not ok:
            failed.append((name, m, k, n))
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        if timed and main:
            add_times(r, ms, plain, library, bnd)
        del x, w, b, y
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"feed-forward GEMM kernel disagrees with its plain version at {failed}")


def check_layer_norm(norms, results, timed=True):
    """K3 against its plain version in fp32 on the same inputs at every
    LayerNorm shape of the paths, ragged rows, and rows of small variance
    (x ~ 3e-3·N(0, 1): var ≈ eps, so that eps shows), held to
    ``layer_norm_gate`` (bf16: every element within 2⁻⁸·|y| + 2⁻¹⁶·max|y|,
    relative L2 within 4e-3, mean signed error within 1e-4·rms(y); fp32: the
    summation order, 1e-5·max|y|); every case printed, then a raise listing
    the failures. With ``timed``, the kernel's and the plain version's times,
    and at the paths' shapes the library's (``F.layer_norm``) and the bound
    (x read and y written once, the affine once)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    main_shapes, refs = layer_norm_main(), references()
    cases = [(s, 2.0, 0.5) for s in main_shapes + layer_norm_unmain()]
    cases += [(s, 3e-3, 0.0) for s in LAYER_NORM_SMALL_VAR]
    failed = []
    for (rows, c, dtype), scale, offset in cases:
        x = (torch.randn(rows, c, generator=g, device="cuda") * scale + offset).to(dtype)
        w = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        y = norms.layer_norm(x, w, b)
        torch.cuda.synchronize()
        stats = norms.layer_norm_errors(y, norms.layer_norm_reference(x.float(), w.float(), b.float()))
        ok, report = norms.layer_norm_gate(stats)
        main = (rows, c, dtype) in main_shapes and scale == 2.0
        ref = (rows, c, dtype) in refs and scale == 2.0
        times = ""
        if timed:
            ms = median_ms(lambda: norms.layer_norm(x, w, b))
            plain = median_ms(lambda: norms.layer_norm_reference(x, w, b))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        # x and y, weight and bias; Σx, Σx², centre, scale, affine: 7 fp32 ops an element
        if timed and (main or ref):
            library = library_ms(lambda: lambda: F.layer_norm(x, (c,), w, b, 1e-5))
            bnd = bound(7 * rows * c, (2 * rows * c + 2 * c) * x.element_size(), FP32_OPS_PER_S)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"layer_norm rows={rows:5d} C={c:4d} {str(dtype)[6:]:8s} x~{scale:g}·N(0,1)+{offset:g}: "
              f"{'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append((rows, c, dtype, scale))
        r = results["layer_norm"]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        if timed and main:
            add_times(r, ms, plain, library, bnd)
    if failed:
        raise AssertionError(f"LayerNorm kernel disagrees with its plain version at {failed}")


def check_group_norm(norms, results, timed=True):
    """The whole GroupNorm (``group_norm``: K9's statistics, the fold, the
    apply, SiLU or not) at every GroupNorm shape of the paths and the
    ragged ones, in both layouts the kernels take (contiguous NCHW and
    channels-last, the layout the paths' convolutions hand on), held to
    ``group_norm_gate``: y with and without SiLU against the plain version
    in fp32 from the same x, weight and bias (bf16: every element within
    2⁻⁸·|y| + 2⁻⁷·max|y|, relative L2 within 7.5e-3, mean signed error within
    2e-3·rms(y)), the per-group mean and inv within 1e-5 of fp64; y in x's
    layout; and exact: a sample alone equal to the same sample in its batch,
    and run to run. K9's own entry (``group_norm_stats``): Σx and Σx²
    against fp64 (GN_STATS_TOL), alone == batched and run == run. The apply
    kernel alone (``group_norm_apply``, SiLU) within one bf16 ulp of the
    plain apply on the same scale and shift. Every case printed, then a
    raise listing the failures. With ``timed``, at the paths' shapes in
    the paths' layout (channels-last): statistics, apply and the whole op's
    time (plain, library
    ``torch.var_mean`` and ``F.silu(F.group_norm(...))``), and the bounds:
    the statistics read x and write two [B, C] fp32, the apply reads x, w
    and shift and writes y, the whole op reads x and writes y at least once
    each. ``max_abs_err`` of the statistics row is that of Σx/N and Σx²/N,
    the mean and E[x²] the fold takes."""
    g = torch.Generator(device="cuda").manual_seed(6)
    failed = []
    main_cases = gn_main()
    for case in main_cases + gn_unmain():
        shape, dtype, groups = case
        main = case in main_cases
        b, c = shape[:2]
        n = shape[2] * shape[3]
        groups = gn_groups(shape, groups)  # the statistics check below holds the rows of one element
        x0 = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
        gw = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        gb = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        w = (1 + 0.1 * torch.randn(b, c, generator=g, device="cuda")).to(dtype)
        shift = (0.1 * torch.randn(b, c, generator=g, device="cuda")).to(dtype)
        rs, rss, mag = (torch.empty(b, c, dtype=torch.float64, device="cuda") for _ in range(3))
        for i in range(b):  # fp64 one sample at a time: a few GiB at the largest shapes
            xi = x0[i].double().reshape(c, n)
            rs[i], rss[i], mag[i] = xi.sum(-1), (xi * xi).sum(-1), xi.abs().sum(-1)
            del xi
        count = n * (c // groups)  # the per-group mean and inv in fp64, from the channel sums
        mean64 = rs.reshape(b, groups, -1).sum(-1) / count
        inv64 = torch.rsqrt(torch.clamp(rss.reshape(b, groups, -1).sum(-1) / count - mean64 * mean64, min=0.0) + 1e-5)
        want64 = (mean64, inv64)
        want = [norms.group_norm_reference(x0.float(), groups, gw.float(), gb.float(), 1e-5, act)[0]
                for act in (None, "silu")]
        for layout in ("NCHW", "NHWC"):
            x = x0 if layout == "NCHW" else x0.to(memory_format=torch.channels_last)
            y, mean, inv = norms.group_norm_forward(x, groups, gw, gb, 1e-5)
            y_act = norms.group_norm(x, groups, gw, gb, 1e-5, act="silu")
            again = norms.group_norm(x, groups, gw, gb, 1e-5, act="silu")
            alone = norms.group_norm(x[-1:], groups, gw, gb, 1e-5, act="silu")  # the last sample alone
            torch.cuda.synchronize()
            gn_exact = torch.equal(again, y_act) and torch.equal(alone[0], y_act[-1])
            layout_ok = y.stride() == x.stride() and y_act.stride() == x.stride()
            stats = norms.group_norm_errors((y, y_act, mean, inv), want, want64)
            gate_ok, report = norms.group_norm_gate(stats)
            kind = norms.group_norm_plan(x.shape, groups, layout == "NHWC", dtype)[0]
            del y, y_act, again, alone, mean, inv
            s, ss = norms.group_norm_stats(x)
            again = norms.group_norm_stats(x)
            alone = norms.group_norm_stats(x[-1:])
            torch.cuda.synchronize()
            exact = (torch.equal(again[0], s) and torch.equal(again[1], ss) and torch.equal(alone[0][0], s[-1])
                     and torch.equal(alone[1][0], ss[-1]))
            del again, alone
            stats_ok = bool(((s.double() - rs).abs() <= GN_STATS_TOL * mag).all()
                            and ((ss.double() - rss).abs() <= GN_STATS_TOL * rss).all())
            err = max((s.double() - rs).abs().max().item(), (ss.double() - rss).abs().max().item()) / n
            y = norms.group_norm_apply(x, w, shift, "silu")
            ref = norms.group_norm_apply_reference(x, w, shift, "silu")
            torch.cuda.synchronize()
            apply_ok = y.stride() == x.stride() and (within_bf16_ulp(y, ref) if dtype == torch.bfloat16 else bool(
                (y - ref).abs().le(1e-6 * ref.abs().clamp(min=1.0)).all()))
            apply_err = (y.float() - ref.float()).abs().max().item()
            del y, ref
            times = ""
            if timed and main and layout == "NHWC":  # the paths' layout: the rows of the kernels line
                ms_s = median_ms(lambda: norms.group_norm_stats(x))
                ms_a = median_ms(lambda: norms.group_norm_apply(x, w, shift, "silu"))
                whole = median_ms(lambda: norms.group_norm(x, groups, gw, gb, 1e-5, act="silu"))
                plain_s = median_ms(lambda: norms.group_norm_stats_reference(x))
                plain_a = median_ms(lambda: norms.group_norm_apply_reference(x, w, shift, "silu"))
                plain_w = median_ms(lambda: norms.group_norm_reference(x, groups, gw, gb, 1e-5, "silu"))
                times = (f"; statistics {ms_s:.4f} ms (plain {plain_s:.4f}), apply+SiLU {ms_a:.4f} ms "
                         f"(plain {plain_a:.4f}), kernel {whole:.4f} ms the whole group_norm+SiLU "
                         f"(plain {plain_w:.4f})")
                lib_s = library_ms(lambda: lambda: torch.var_mean(x.reshape(b, c, n), dim=-1))
                lib_a = library_ms(lambda: lambda: F.silu(F.group_norm(x, groups, gw, gb, 1e-5)))
                nbytes = x.numel() * x.element_size()
                b_s = bound(3 * x.numel(), nbytes + 8 * b * c, FP32_OPS_PER_S)
                b_a = bound(8 * x.numel(), 2 * nbytes + 2 * b * c * x.element_size(), FP32_OPS_PER_S)
                # the whole op: x read once (twice under plan (b)) and y written once
                reads = 1 if kind == "resident" else 2
                b_w = bound(11 * x.numel(), (reads + 1) * nbytes + 2 * c * x.element_size(), FP32_OPS_PER_S)
                add_times(results["group_norm_stats"], ms_s, plain_s, lib_s, b_s)
                add_times(results["group_norm_apply"], ms_a, plain_a, lib_a, b_a)
                if kind == "resident":
                    add_times(results["group_norm_fused"], whole, plain_w, lib_a, b_w)
                times += (f"; library var_mean {fmt_ms(lib_s)}, group_norm+silu {fmt_ms(lib_a)}; bound statistics "
                          f"{b_s[0]:.4f} ({b_s[1]}), apply {b_a[0]:.4f} ({b_a[1]}), whole {b_w[0]:.4f} ({b_w[1]})")
            ok = gate_ok and gn_exact and layout_ok and stats_ok and exact and apply_ok
            if kind == "resident":
                r = results["group_norm_fused"]
                r["max_abs_err"] = max(r["max_abs_err"], stats["y"]["max_err"], stats["silu"]["max_err"])
            print(f"group_norm {str(shape):21s} {str(dtype)[6:]:8s} {layout} G={groups} plan {kind}: "
                  f"{'pass' if ok else 'FAIL'}: "
                  f"{report}; alone == batched and run == run {gn_exact}, y in x's layout {layout_ok}; statistics: "
                  f"Σx, Σx² within {GN_STATS_TOL} {stats_ok} (mean/E[x²] max|err| {err:.3e}), alone == batched "
                  f"and run == run {exact}; apply within one ulp {apply_ok} (max|err| {apply_err:.3e}){times}")
            if not ok:
                failed.append((shape, str(dtype), layout))
            results["group_norm_stats"]["max_abs_err"] = max(results["group_norm_stats"]["max_abs_err"], err)
            results["group_norm_apply"]["max_abs_err"] = max(results["group_norm_apply"]["max_abs_err"],
                                                             apply_err)
            del x, s, ss
        del x0, w, shift, rs, rss, mag, want, want64, mean64, inv64
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"GroupNorm disagrees with its plain version at {failed}")


def within_bf16_ulp(got, want, floor=0.0) -> bool:
    """|got − want| ≤ one bf16 ulp of ``want`` (or ``floor``, where larger)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w), torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((got.float() - w).abs() <= torch.clamp(ulp, min=floor)).all())


def check_int8_gemm(gemm, results, timed=True):
    """K11 at every int8 shape of the SDXL path and the extra cases: its
    int32 sums (the raw-sums epilogue) equal the plain version's; its bf16
    output within one ulp of the plain version's (the epilogue runs in the
    same fp32 order, so exactly equal without gelu; with tanh-gelu, 1e-6
    absolute where 1 + tanh(u) cancels in the negative tail). Every case
    printed with its plan, then a raise listing the failures. With
    ``timed``, the kernel's time, and at the path's shapes the plain
    version's, the library's and the bound: 2·M·K·N int8 operations at
    1979 TOP/s, or xq, wq, the two scales read and the bf16 output written
    once at 3.35 TB/s."""
    g = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    for m, k, n, epilogue in [(*s, False) for s in int8_main()] + int8_extra():
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=g, device="cuda") * 1e-3 + 1e-5
        sw = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
        bias, act = (torch.randn(n, generator=g, device="cuda"), "gelu") if epilogue else (None, None)
        sums = gemm.int8_gemm(xq, None, wq, None, out_dtype=torch.int32)
        y = gemm.int8_gemm(xq, sx, wq, sw, bias, act)
        torch.cuda.synchronize()
        ref = gemm.int8_gemm_reference(xq, sx, wq, sw, bias, act)
        sums_equal = torch.equal(sums, gemm.int8_sums_reference(xq, wq))
        close = within_bf16_ulp(y, ref, 1e-6 if act else 0.0)
        err = (y.float() - ref.float()).abs().max().item()
        main = (m, k, n) in int8_main() and not epilogue
        plan = gemm.int8_gemm_plan(m, k, n, sms)
        times = f"; plan split {plan.split}"
        if timed:
            ms = median_ms(lambda: gemm.int8_gemm(xq, sx, wq, sw, bias, act))
            times += f"; kernel {ms:.4f} ms"
        if timed and main:
            plain = median_ms(lambda: gemm.int8_gemm_reference(xq, sx, wq, sw))
            library = library_ms(lambda: lambda: (torch._int_mm(xq, wq.t()).float() * sx[:, None] * sw).to(
                torch.bfloat16))
            bnd = bound(2 * m * k * n, m * k + k * n + 4 * (m + n) + 2 * m * n, INT8_OPS_PER_S)
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        ok = sums_equal and close
        print(f"int8_gemm M={m:5d} K={k:4d} N={n:5d}{' bias+gelu' if epilogue else ''}: {'pass' if ok else 'FAIL'}: "
              f"int32 sums equal {sums_equal}; bf16 max|err| {err:.3e} (within one ulp{' or 1e-6' if act else ''}: "
              f"{close}){times}")
        if not ok:
            failed.append((m, k, n, epilogue))
        r = results["int8_gemm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed and main:
            add_times(r, ms, plain, library, bnd)
        del xq, wq, sums, y, ref
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8 GEMM kernel disagrees with its plain version at {failed}")


def pair_kernels(attention, kernels, q, k, v, o, lse, do, scale, kv_valid):
    """K6 and K7 each alone, launched as ``flash_attention_bwd_bhsd``
    launches them (and not counted), for their separate times."""
    bh, sq, d = q.shape
    kv_len = kv_valid or k.shape[1]
    lib = kernels.library()
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (bh, sq, k.shape[1], d, kv_len, float(scale))
    ins = lambda: tuple(t.data_ptr() for t in (q, k, v, do, lse, delta))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dkv = lambda: kernels.check(lib.fdt_flash_bwd_dkv(*ins(), dk.data_ptr(), dv.data_ptr(), *dims, stream()),
                                "flash_bwd_dkv")
    dqk = lambda: kernels.check(lib.fdt_flash_bwd_dq(*ins(), dq.data_ptr(), *dims, stream()), "flash_bwd_dq")
    return dkv, dqk


def key_mask(skv, kv_valid):
    """SDPA's boolean key mask (True: attend) where ``kv_valid`` cuts the keys."""
    return None if kv_valid is None else (torch.arange(skv, device="cuda") < kv_valid)[None, None, None]


def sdpa_backward(q, k, v, do, scale, kv_valid=None):
    """The library yardstick of the backward: ``F.scaled_dot_product_attention``
    on [1, BH, S, D] (under the same key mask where ``kv_valid`` cuts the
    keys), its dq, dk, dv by ``torch.autograd.grad``."""
    qq, kk, vv = (t[None].detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=key_mask(k.shape[1], kv_valid), scale=scale)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), do[None], retain_graph=True)


def check_attention_bwd(attention, kernels, results, timed=True):
    """K6+K7 and K8 against ``attention_bwd_reference`` in fp32, held to
    ``attention_bwd_gate`` (for each of dq, dk, dv: max|err| ≤ 4e-3 +
    2⁻⁶·max|ref|, relative L2 ≤ 1e-2; dk and dv exactly 0 at rows past
    ``kv_valid``). On the ragged cases the keys at or past ``kv_valid`` are
    k × 3 and v + 1, so that any read of them shows. With ``timed``, at the
    training step's shapes also their times, the plain version's, the
    library's and the bound. Operations as the JAX ``pl.CostEstimate``
    counts them: 10·BH·Sq·KV·D for K8, 5·BH·Sq·KV·D each for K6 and K7
    (the kernels do 8 and 6: S and dP are recomputed in each). Bytes: K8's
    wrapper reads q, k, v, o, dO, lse and writes dq, dk, dv; K6 reads q, dO,
    k, v, lse, Δ and writes dk, dv; K7 the same, writing dq. Raises after
    the last shape if any failed."""
    g = torch.Generator(device="cuda").manual_seed(3)
    failed = []
    refs = references()
    for shape in bwd_main() + bwd_unmain():
        bh, sq, skv, d, kv_valid = shape
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                       for s in (sq, skv, skv, sq))
        if kv_valid is not None:
            k[:, kv_valid:] *= 3
            v[:, kv_valid:] += 1
        scale = d ** -0.5
        kv_len = kv_valid or skv
        route = attention.attention_bwd_plan(kv_len, d)[0]
        o, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        grads = attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid)
        torch.cuda.synchronize()
        stats = None
        step = max(1, 2 ** 26 // (sq * skv))  # the fp32 reference, a few GiB at a time
        for i in range(0, bh, step):
            sl = slice(i, i + step)
            ref = attention.attention_bwd_reference(
                *(t[sl].float() for t in (q, k, v, o)), lse[sl], do[sl].float(), scale, kv_valid)
            part = attention.attention_bwd_errors([t[sl] for t in grads], ref, kv_valid)
            stats = part if stats is None else attention.merge_bwd_errors(stats, part)
            del ref
        del grads
        ok, report = attention.attention_bwd_gate(stats)
        err = [s["max_err"] for s in stats]
        main = shape in bwd_main()
        times = ""
        if timed:
            ms = median_ms(lambda: attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid))
            times = f"; kernel {ms:.4f} ms"
        if timed and (main or shape in refs):
            plain = median_ms(lambda: attention.attention_bwd_reference(q, k, v, o, lse, do, scale, kv_valid))
            library = library_ms(lambda: sdpa_backward(q, k, v, do, scale, kv_valid))
            work = bh * sq * kv_len * d
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms"
            if route == "flash_bwd_oneshot":
                bnd = bound(10 * work, 2 * bh * (4 * sq + 4 * skv) * d + 4 * bh * sq)
                times += f", bound {bnd[0]:.4f} ms ({bnd[1]})"
                if main:
                    add_times(results[route], ms, plain, library, bnd)
            else:
                dkv, dqk = pair_kernels(attention, kernels, q, k, v, o, lse, do, scale, kv_valid)
                ms_dkv, ms_dq = median_ms(dkv), median_ms(dqk)
                b_dkv = bound(5 * work, 2 * bh * (2 * sq + 4 * skv) * d + 8 * bh * sq)
                b_dq = bound(5 * work, 2 * bh * (3 * sq + 2 * skv) * d + 8 * bh * sq)
                times += (f"; K6 alone {ms_dkv:.4f} ms (bound {b_dkv[0]:.4f} ms, {b_dkv[1]}), "
                          f"K7 alone {ms_dq:.4f} ms (bound {b_dq[0]:.4f} ms, {b_dq[1]})")
                if library:
                    times += f"; K6 + K7 / library {(ms_dkv + ms_dq) / library:.2f}x"
                if main:
                    add_times(results["flash_bwd_dkv"], ms_dkv, plain, library, b_dkv)
                    add_times(results["flash_bwd_dq"], ms_dq, plain, library, b_dq)
        print(f"attention backward {route:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} kv_valid={kv_valid}"
              f"{' (k x3, v +1 past it)' if kv_valid else ''}: {'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append(shape)
        if route == "flash_bwd_oneshot":
            rows = [(results[route], max(err))]
        else:
            rows = [(results["flash_bwd_dkv"], max(err[1:])), (results["flash_bwd_dq"], err[0])]
        for r, e in rows:
            r["max_abs_err"] = max(r["max_abs_err"], e)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attention backward disagrees with its plain version at {failed}")


def reset(counters):
    for d in counters:
        d.clear()


def totals(counters):
    """Every kernel's launches over its shapes, summed over the counters."""
    return sum((d.totals() for d in counters), collections.Counter())


def cpu_fp32_copy(state, meta_module: torch.nn.Module) -> torch.nn.Module:
    """``meta_module`` (the same architecture, built on the meta device) on
    the CPU with the weights of ``state``, a state dict: float tensors as
    fp32, int8 weights and their scales as they are, tensor by tensor, so
    that the host holds one fp32 copy and the card no second one."""
    from flash_diffusion_tpu_torch.quant import apply_weights

    meta_module.to_empty(device="cpu")
    apply_weights(meta_module, {k: v.cpu().float() if v.is_floating_point() else v.cpu()
                                for k, v in state.items()})
    return meta_module.eval()


def cpu_reference(pipe, model: str):
    """The pipeline's modules as an fp32 copy on the CPU (the plain paths),
    with the pipeline's served weights (int8 ones in int8 mode)."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.sample import build_modules, make_conditioner

    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("host memory (GiB) before the fp32 copy: " + " | ".join(free.splitlines()[:2]))
    with torch.device("meta"):
        unet, vae, conditioners, _, _ = build_modules(model)
    ref = FlashPipeline(
        cpu_fp32_copy(pipe.state, unet),
        cpu_fp32_copy(pipe.conditioner.state_dict(), make_conditioner(model, conditioners)),
        cpu_fp32_copy(pipe.vae.state_dict(), vae), pipe.tokenizer_fn, pipe.latent_shape,
        scheduler_config=pipe.sched_config, scheduler=pipe.scheduler_name,
    )
    ref.size_cond_fn = pipe.size_cond_fn
    return ref


def check_reference(pipe, model: str, label: str = ""):
    """The pipeline's own modules at 128² on one prompt: bf16 on the card
    through the kernels vs ``cpu_reference``."""
    ref = cpu_reference(pipe, model)
    g = torch.Generator().manual_seed(7)
    channels = pipe.latent_shape[-1]
    latents = torch.randn(1, 16, 16, channels, generator=g)
    noise = [torch.randn(1, 16, 16, channels, generator=g) for _ in range(4)]
    batch = dict(pipe.tokenizer_fn(PROMPTS[:1]))
    if pipe.size_cond_fn is not None:
        batch.update(pipe.size_cond_fn(1, 128, 128))
    with torch.inference_mode():
        c_dev, c_ref = pipe._embed(batch)["cond"], ref._embed(batch)["cond"]
    clip_errs = {k: ((c_dev[k].cpu() - v).norm() / v.norm()).item() for k, v in c_ref.items()}
    got = pipe.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128).cpu()
    want = ref.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128)
    img_err = ((got - want).norm() / want.norm()).item()
    errs = ", ".join(f"{k} {e:.3e}" for k, e in clip_errs.items())
    print(f"{label or model} reference at 128², 1 prompt: the conditioner (fp32 on the card) rel L2 err {errs} "
          f"(tol 1e-4); "
          f"images (bf16 on the card vs fp32 on the CPU) rel L2 err {img_err:.3e} (tol 0.1), "
          f"max|err| {(got - want).abs().max().item():.3e}")
    if not (max(clip_errs.values()) <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError(f"the card's {label or model} slice disagrees with the fp32 reference on a small input")


def check_mode_references(pipe, counters):
    """Phase 4c: each of ``SDXL_MODES`` at 512² (the least size whose
    640-channel level has 1024 tokens, M = 1024: all three kernels run), one
    prompt, one step (to bound the CPU's time), on the card against the
    fp32 CPU copy under the same switches (the plain versions), same
    latents and noise: images within 0.1, as 4b, and the mode's kernels
    launched on the card."""
    ref = cpu_reference(pipe, "sdxl")
    g = torch.Generator().manual_seed(12)
    latents = torch.randn(1, 64, 64, 4, generator=g)
    noise = [torch.randn(1, 64, 64, 4, generator=g)]
    kw = dict(latents=latents, noise=noise, num_inference_steps=1, height=512, width=512)
    for path, env, exact in SDXL_MODES:
        with switches(env):
            reset(counters)
            got = pipe.generate(PROMPTS[:1], **kw).cpu()
            torch.cuda.synchronize()
            launches = totals(counters)
            want = ref.generate(PROMPTS[:1], **kw)
        err = rel_l2(got, want)
        ran = {k: launches[k] for k, n in exact.items() if n}
        print(f"sdxl {path} reference at 512², 1 prompt, 1 step: images (bf16 on the card vs fp32 on the CPU, "
              f"same switches) rel L2 err {err:.3e} (tol 0.1), max|err| {(got - want).abs().max().item():.3e}; "
              f"the mode's kernels on the card {ran}")
        if not (err <= 0.1 and torch.isfinite(got).all() and all(ran.values())):
            raise AssertionError(f"the card's sdxl {path} mode disagrees with the fp32 reference at 512²")


def run_path(pipe, model, hw, counters, card, required):
    """One main path through ``generate``: counts reset just before and read
    just after, the launched kernels checked, then warm s/batch. Returns
    (launches, the images of the first run)."""
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=0)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = totals(counters)
    print(f"{model} generate (cold): {cold:.3f} s; launches {dict(launches)}")
    if tuple(images.shape) != (4, hw, hw, 3) or not torch.isfinite(images).all():
        raise AssertionError(f"bad {model} images: shape {tuple(images.shape)}, "
                             f"finite {torch.isfinite(images).all().item()}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {model} path never launched {missing}")
    warm = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=seed)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    per_batch = statistics.median(warm)
    print(f"{model} {hw}² 4-NFE batch 4 on {card}: warm {per_batch:.4f} s/batch (median of {warm}), "
          f"{4 / per_batch:.3f} images/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"image range [{images.min().item():.3f}, {images.max().item():.3f}]")
    return launches, images


@contextlib.contextmanager
def switches(env):
    """The JAX package's kernel switches set to ``env`` (the others unset)
    inside the block, as they were after it."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def run_modes(pipe, default_images, counters, card):
    """Phase 3c: SDXL 1024² ``generate`` in each of ``SDXL_MODES`` on the
    pipeline of phase 3b, through ``run_path`` (counts reset just before,
    warm s/batch after): the launch counts exact, the images within
    MODE_IMAGE_TOL of the default mode's. Returns {path: launches}."""
    by_path = {}
    for path, env, exact in SDXL_MODES:
        with switches(env):
            launches, images = run_path(pipe, f"sdxl {path}", 1024, counters, card, [k for k, n in exact.items() if n])
        err = rel_l2(images, default_images)
        wrong = {k: launches[k] for k, n in exact.items() if launches[k] != n}
        print(f"sdxl {path} ({' '.join(f'{k}={v}' for k, v in env.items())}): images vs the default mode's, rel "
              f"L2 {err:.3e} (tol {MODE_IMAGE_TOL}); launch counts {'exact' if not wrong else wrong} "
              f"(expected {exact})")
        if wrong or not err <= MODE_IMAGE_TOL:
            raise AssertionError(f"the sdxl {path} mode launched {wrong} or its images differ by {err:.3e}")
        by_path[path] = launches
        del images
    return by_path


def png_pixels(png: bytes):
    """(width, height, RGB rows) of a PNG from the port's writer (8-bit RGB,
    one IDAT, filter 0 on every row)."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", png[16:26])
    at = png.index(b"IDAT")
    raw = zlib.decompress(png[at + 4: at + 4 + struct.unpack(">I", png[at - 4: at])[0]])
    if (depth, color) != (8, 2) or len(raw) != height * (1 + 3 * width):
        raise AssertionError(f"not an 8-bit RGB PNG of {width}x{height}")
    return width, height


def write_peft(path: str, tree) -> str:
    """A PEFT adapter file of a port LoRA tree (A as [r, in], B as [out, r])."""
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_file({f"unet.{name}.lora_{x}.weight": ab[leaf].t().contiguous().cpu()
               for name, ab in tree.items() for x, leaf in (("A", "a"), ("B", "b"))}, path)
    return path


def run_int8_serving(counters, card, required):
    """Phase 6: SDXL 1024² int8 with a merged LoRA behind ``InferenceServer``:
    8 clients in a closed loop of HTTP requests, counts reset just before
    and read after. Returns (launches, the pipeline)."""
    from flash_diffusion_tpu_torch.lora import init_lora
    from flash_diffusion_tpu_torch.ops import gemm
    from flash_diffusion_tpu_torch.sample import build_pipeline
    from flash_diffusion_tpu_torch.serving import InferenceServer, ServingConfig

    t0 = time.perf_counter()
    pipe = build_pipeline("sdxl", device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(5)
    tree = init_lora(pipe.denoiser, SERVE_LORA_RANK, g, device="cuda")
    for ab in tree.values():
        ab["b"].normal_(0.0, SERVE_LORA_B_STD, generator=g)
    path = write_peft(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                                   "lora.safetensors"), tree)
    n_lora = len(tree)
    del tree
    t1 = time.perf_counter()
    pipe.load_lora(*pipe.lora_loader(path))
    pipe.quantize("int8")
    torch.cuda.synchronize()
    n_int8 = sum(t.dtype == torch.int8 for t in pipe.state.values())
    print(f"sdxl int8: build {t1 - t0:.2f} s, LoRA load (PEFT file, rank {SERVE_LORA_RANK}, "
          f"{n_lora} layers) + merge + quantize {time.perf_counter() - t1:.2f} s; "
          f"{n_int8} int8 layers; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_int8 != SERVE_INT8_LAYERS:
        raise AssertionError(f"quantize('int8') made {n_int8} int8 layers, not {SERVE_INT8_LAYERS}")
    server = InferenceServer(pipe, ServingConfig(port=0, max_batch=4, linger_ms=SERVE_LINGER_MS,
                                                 batch_sizes=(1, 4), prewarm=True))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        if not server.ready.wait(600):
            raise AssertionError("the server did not come up")
        url = f"http://127.0.0.1:{server.address[1]}"
        get = lambda p: json.loads(urllib.request.urlopen(url + p, timeout=60).read())
        n_req = SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT
        replies, client_s = [None] * n_req, [None] * n_req

        def client(c):
            for i in range(c * SERVE_REQUESTS_PER_CLIENT, (c + 1) * SERVE_REQUESTS_PER_CLIENT):
                body = json.dumps({"prompt": PROMPTS[i % 4], "seed": i, "format": "json"}).encode()
                req = urllib.request.Request(url + "/generate", data=body, method="POST")
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    replies[i] = json.loads(r.read())
                client_s[i] = time.perf_counter() - t

        reset(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        wall = time.perf_counter() - t0
        launches = totals(counters)
        metrics, health, loras = get("/metrics"), get("/healthz"), get("/loras")
    finally:
        server.shutdown()
        thread.join(60)
    print(f"sdxl int8 serving: {SERVE_CLIENTS} clients × {SERVE_REQUESTS_PER_CLIENT} requests in {wall:.3f} s; "
          f"launches {dict(launches)}; /metrics {metrics}; /healthz {health}; /loras {loras}")
    sizes = [png_pixels(base64.b64decode(p)) for r in replies if r for p in r["images_png_b64"]]
    if sizes != [(1024, 1024)] * n_req:
        raise AssertionError(f"expected {n_req} RGB PNGs of 1024x1024, got {len(sizes)}: {set(sizes)}")
    if (metrics["requests"], metrics["images_generated"], metrics["batches_dispatched"], metrics["errors"],
            metrics["batch_occupancy"]) != (n_req, n_req, n_req // 4, 0, 1.0):
        raise AssertionError(f"unexpected /metrics {metrics}")
    if not health["ok"] or list(loras["adapters"]) != ["default"]:
        raise AssertionError(f"unexpected /healthz {health} or /loras {loras}")
    per_dispatch = SERVE_INT8_LAYERS * 4
    if launches["int8_gemm"] != per_dispatch * metrics["batches_dispatched"]:
        raise AssertionError(f"int8 GEMM launched {launches['int8_gemm']} times, not {per_dispatch} per "
                             f"batch-4 dispatch")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the int8 serving path never launched {missing}")
    lat = sorted(client_s)
    q = lambda p: lat[min(n_req - 1, int(p * n_req))]
    warm = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, seed=[4 * seed + j for j in range(4)])
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    per_batch = statistics.median(warm)
    print(f"sdxl int8 + LoRA 1024² 4-NFE batch 4 on {card}: warm {per_batch:.4f} s/batch (median of {warm}), "
          f"{4 / per_batch:.3f} images/s; {wall / metrics['batches_dispatched']:.4f} s per dispatch under the "
          f"server; request latency over {n_req} requests ({SERVE_CLIENTS} clients in a closed loop): server p50 "
          f"{metrics['latency_p50_s']} s, p95 {metrics['latency_p95_s']} s; client (with PNG and HTTP) p50 "
          f"{q(0.5):.4f} s, p95 {q(0.95):.4f} s, min {lat[0]:.4f} s, max {lat[-1]:.4f} s; "
          f"int8 GEMM launches per batch-4 dispatch "
          f"{launches['int8_gemm'] // metrics['batches_dispatched']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, pipe


def check_batch_invariance(pipe):
    """Phase 6b's second half: a request alone and in a batch of 4 (each
    sample's own seed), at 128², held to the contract of
    ``FlashPipeline.generate`` (cuDNN's and cuBLAS's batch-size-dependent
    algorithms; the port's own ops are exact)."""
    alone = pipe.generate(PROMPTS[1:2], seed=[21], height=128, width=128)
    batch = pipe.generate(PROMPTS, seed=[20, 21, 22, 23], height=128, width=128)
    err = rel_l2(alone[0].float().cpu(), batch[1].float().cpu())
    other = rel_l2(batch[0].float().cpu(), batch[1].float().cpu())
    print(f"sdxl int8 at 128²: request alone vs slot 1 of a batch of 4, rel L2 {err:.3e} (tol "
          f"{BATCH_INVARIANCE_TOL}; another seed's image differs by {other:.3e})")
    if not err <= BATCH_INVARIANCE_TOL:
        raise AssertionError("a request's image depends on its batch beyond the contract")


class FixedConditioner(torch.nn.Module):
    """A conditioner that returns one conditioning, whatever the batch:
    phase 7b hands the card's T5 output to the CPU copy through it."""

    def __init__(self, cond):
        super().__init__()
        self.cond = cond

    def forward(self, batch, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": self.cond}


def check_pixart_reference(pipe, t5_check=True, label="pixart"):
    """Phase 7b: T5-XXL at full width and 2 layers on the card (fp32)
    against its CPU copy (rel. L2 1e-4) on 120 ids with a padded mask; then
    the pipeline's DiT and VAE at full size on one prompt at 128² (bf16,
    kernels) against an fp32 CPU copy (plain paths) with the pipeline's
    served weights (7e: its int8 ones), both on the card's T5 output and the
    same latents and step noise (images: rel. L2 0.1). Without
    ``t5_check``, the DiT and VAE alone."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.models import T5Encoder, t5_xxl_config
    from flash_diffusion_tpu_torch.sample import build_modules

    t5_err = 0.0
    if t5_check:
        cfg = t5_xxl_config(num_layers=2)
        with torch.random.fork_rng(devices=[0]):
            torch.manual_seed(3)
            with torch.device("cuda"):
                t5 = T5Encoder(cfg).eval()
        with torch.device("meta"):
            t5_ref = T5Encoder(cfg)
        t5_ref = cpu_fp32_copy(t5.state_dict(), t5_ref)
        g = torch.Generator().manual_seed(8)
        ids = torch.randint(0, cfg.vocab_size, (2, 120), generator=g)
        mask = (torch.arange(120)[None] < torch.tensor([[37], [120]])).long()
        with torch.inference_mode():
            t5_err = rel_l2(t5(ids.cuda(), mask.cuda()).cpu(), t5_ref(ids, mask))
        del t5, t5_ref
        torch.cuda.empty_cache()

    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("host memory (GiB) before the fp32 copy: " + " | ".join(free.splitlines()[:2]))
    with torch.device("meta"):
        dit, vae, _, _, _ = build_modules("pixart")
    batch = dict(pipe.tokenizer_fn(PROMPTS[:1]))
    batch.update(pipe.size_cond_fn(1, 128, 128))
    with torch.inference_mode():
        cond = pipe._embed(batch)["cond"]
    ref = FlashPipeline(cpu_fp32_copy(pipe.state, dit), FixedConditioner(to_cpu(cond)),
                        cpu_fp32_copy(pipe.vae.state_dict(), vae), pipe.tokenizer_fn, pipe.latent_shape,
                        scheduler_config=pipe.sched_config)
    ref.size_cond_fn = pipe.size_cond_fn
    g = torch.Generator().manual_seed(7)
    latents = torch.randn(1, 16, 16, 4, generator=g)
    noise = [torch.randn(1, 16, 16, 4, generator=g) for _ in range(4)]
    got = pipe.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128).cpu()
    want = ref.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128)
    img_err = rel_l2(got, want)
    t5_report = (f"T5-XXL at 2 layers (fp32 on the card vs the CPU) rel L2 err {t5_err:.3e} (tol 1e-4); "
                 if t5_check else "")
    print(f"{label} reference: {t5_report}DiT + VAE at 128², 1 prompt, on the card's T5 output: images (bf16 on "
          f"the card vs fp32 on the CPU, the same served weights) rel L2 err {img_err:.3e} (tol 0.1), max|err| "
          f"{(got - want).abs().max().item():.3e}")
    if not (t5_err <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError(f"the card's {label} slice disagrees with the fp32 reference on a small input")


def check_gated(label, counters, gated):
    """Every (kernel, shape) launched since the counters were reset must be
    among the shapes phase 2 checks its kernel at (``gated_shapes()``)."""
    launched = sorted({key for c in counters for key, n in c.items() if n}, key=str)
    for kernel in sorted({k for k, _ in launched}):
        print(f"  {kernel} launched at {sorted({str(shape) for k, shape in launched if k == kernel})}")
    ungated = [(k, shape) for k, shape in launched if shape not in gated.get(k, ())]
    print(f"{label}: {len(launched)} distinct (kernel, shape) launched, {len(launched) - len(ungated)} of them "
          f"gated in phase 2")
    if ungated:
        raise AssertionError(f"the {label} path launched shapes phase 2 does not gate: {ungated}")


def run_int8_path(pipe, model, n_layers, counters, card, required, gated):
    """Phases 7e and 8e: a bf16 pipeline switched to int8 W8A8
    (``quantize("int8")``: ``n_layers`` layers), then ``generate`` of 4
    prompts × 4 steps at 1024² through ``run_path``: K11 launched exactly
    ``n_layers`` × 4 times, every launched (kernel, shape) among phase 2's;
    warm s/batch."""
    t0 = time.perf_counter()
    pipe.quantize("int8")
    torch.cuda.synchronize()
    n_int8 = sum(t.dtype == torch.int8 for t in pipe.state.values())
    print(f"{model} int8: quantize {time.perf_counter() - t0:.2f} s; {n_int8} int8 layers; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_int8 != n_layers:
        raise AssertionError(f"quantize('int8') made {n_int8} int8 layers, not {n_layers}")
    launches, images = run_path(pipe, f"{model} int8", 1024, counters, card, required)
    if launches["int8_gemm"] != n_layers * 4:
        raise AssertionError(f"int8 GEMM launched {launches['int8_gemm']} times in a 4-step batch, not "
                             f"{n_layers * 4}")
    check_gated(f"{model} int8", counters, gated)
    del images
    return launches


def snapshot(modules):
    """Copies of the modules' state on the host (bit-identity checks)."""
    return [t.detach().cpu().clone() for m in modules for t in m.state_dict().values()]


def check_pngs(paths, logger, size):
    """Every sample PNG decodes (PIL) to a square of ``size`` a side per
    image, and no sample set had a value that is not finite."""
    from PIL import Image

    if not paths or logger.nonfinite:
        raise AssertionError(f"sample PNGs {paths}; sets with non-finite values {logger.nonfinite}")
    for path in paths:
        with Image.open(path) as im:
            pix = np.asarray(im.convert("RGB"), np.float32)
        if pix.shape[0] % size or pix.shape[1] % size or not np.isfinite(pix).all():
            raise AssertionError(f"{path}: {pix.shape}, not a grid of {size}² images")


class StepTimer:
    """A ``fit`` callback: each step's wall seconds (the device synchronized
    at both ends), printed with its stage, start index and losses; a step
    outside stage 1 (where ``TRAIN_OVERRIDES`` puts every step) or a
    non-finite loss fails."""

    def __init__(self, label):
        self.label, self.times = label, []
        self.mark()

    def mark(self):
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def __call__(self, trainer, aux, step):
        torch.cuda.synchronize()
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        self.times.append(dt)
        fl = trainer.model
        losses = {k: float(v) for k, v in aux.items()}
        stage = fl.stage_for_iteration(step)
        start = fl.stage_schedules[stage].timesteps.index(aux["start_timestep"])
        print(f"{self.label} step {step} (stage {stage}, start index {start}: {fl.config.K[stage] - start} teacher "
              f"forwards): {dt:.3f} s; " + ", ".join(f"{k} {v:.5g}" for k, v in losses.items()))
        if stage != 1 or not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"{self.label} step {step}: stage {stage}, losses {losses}")


class BurstWatch:
    """A ``fit`` callback's ``after_burst``: the seconds of the text towers'
    move to the card and the peak memory up to the end of the burst, then
    the peak reset, so that what follows is the training steps' own."""

    def __init__(self):
        self.moves, self.peaks = [], []

    def __call__(self, trainer, aux, step):
        pass

    def after_burst(self, trainer):
        torch.cuda.synchronize()
        self.moves.append(trainer.offload_moves[-1])
        self.peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()


def run_training(model, counters, card, required, gated=None):
    """Phases 5, 5c, 7c and 9: ``build_trainer(model)`` with its yaml, every
    step in stage 1, then one ``fit`` of 4 steps on synthetic batches of the
    yaml's batch size at its image size, 1 warm and 3 timed (a callback
    times each); counts reset just before the first step and read after the
    last. With ``gated``, every (kernel, shape) the steps launched must be
    among phase 2's. SD3 (phase 9) honours ``TEXT_ENCODER_OFFLOAD`` (4: one
    burst): the seconds of each move of the towers to the card, the peak
    memory over the whole phase and over the training steps alone (reset
    after the burst), then one ``SampleLogger`` call (the student, 4 steps,
    the yaml's first prompt) under ``sampling_frozen``, its PNG decoded and
    finite."""
    from flash_diffusion_tpu_torch.train import CONFIGS, build_trainer, load_config, make_tokenizer, synthetic_batches
    from flash_diffusion_tpu_torch.trainer import SampleLogger

    cfg = {**load_config(CONFIGS[model]), **TRAIN_OVERRIDES}
    batch, size = cfg["BATCH_SIZE"], cfg["IMAGE_SIZE"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = build_trainer(model, device="cuda", seed=0, config=cfg)
    fl = trainer.model
    print(f"build_trainer({model!r}): {time.perf_counter() - t0:.2f} s; teacher "
          f"{sum(p.numel() for p in fl.teacher_module.parameters())} parameters, {cfg['TEACHER_SCHEDULER']}; LoRA "
          f"{len(trainer.lora)} pairs of rank {cfg['LORA_RANK']}, "
          f"{sum(t.numel() for ab in trainer.lora.values() for t in ab.values())} parameters; discriminator "
          f"{fl.discriminator.config.num_stages} stages; text towers "
          + (f"offloaded (bursts of {cfg['TEXT_ENCODER_OFFLOAD']})" if trainer.text_encoder_offload else "resident"))
    frozen_modules = (fl.teacher_module, fl.vae, fl.conditioner)
    frozen = snapshot(frozen_modules)
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    disc = snapshot([fl.discriminator])
    data = synthetic_batches(batch, size, seed=0, model=model)
    timer, bursts = StepTimer(model), BurstWatch()
    reset(counters)
    torch.cuda.synchronize()
    timer.mark()
    trainer.fit(data, max_steps=4, callbacks=[bursts, timer])
    timed = timer.times[1:]
    train_peak = torch.cuda.max_memory_allocated()
    sampled = None
    if model == "sd3":
        prompts = cfg["VALIDATION_PROMPTS"][:1]
        tok = make_tokenizer(model, cfg)
        with tempfile.TemporaryDirectory() as out_dir:
            logger = SampleLogger(lambda: {"text": prompts, **tok(prompts)}, (size // 8, size // 8, 16),
                                  out_dir=out_dir, every_n_steps=1, num_steps=[4])
            t0 = time.perf_counter()
            logger(trainer, {}, trainer.step)
            torch.cuda.synchronize()
            pngs = [p for p in logger.written if p.endswith(".png")]
            check_pngs(pngs, logger, size)
        sampled = (time.perf_counter() - t0, pngs)
    launches = totals(counters)
    print(f"{model} training launches over 4 steps {dict(launches)} (the forward kernels' counts include the "
          f"recompute of remat and of the checkpointed LPIPS decode in the backward"
          + ("; and the sampling callback's" if sampled else "") + ")")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {model} training path never launched {missing}")
    if gated is not None:
        check_gated(f"{model} training", counters, gated)
    inert = INERT_LORA.get(model, ())
    if not all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items() if k not in inert):
        raise AssertionError("a LoRA B factor did not change")
    if any(trainer.lora[k]["b"].any() for k in inert):
        raise AssertionError(f"an inert LoRA pair's B moved: {inert}")
    if all(torch.equal(a, b) for a, b in zip(disc, snapshot([fl.discriminator]))):
        raise AssertionError("the discriminator did not change")
    if not all(torch.equal(a, b) for a, b in zip(frozen, snapshot(frozen_modules))):
        raise AssertionError("a frozen module (teacher, VAE or a text tower) changed")
    per_step = statistics.median(timed)
    print(f"{model} Flash distillation {size}² batch {batch} on {card}: warm {per_step:.4f} s/step (median of "
          f"{[round(dt, 4) for dt in timed]}), {batch / per_step:.3f} images/s; peak memory "
          f"{max([train_peak] + bursts.peaks) / 2**30:.2f} GiB")
    if trainer.text_encoder_offload:
        if len(bursts.moves) != 1:
            raise AssertionError(f"{model}: {len(bursts.moves)} encode bursts in 4 steps, not 1")
        print(f"{model} text-encoder offload: host → card moves of the towers {[round(t, 3) for t in trainer.offload_moves]} "
              f"s (the burst's, then the sampling callback's); peak memory over the whole phase "
              f"{max([train_peak, torch.cuda.max_memory_allocated()] + bursts.peaks) / 2**30:.2f} GiB, up to the end "
              f"of the burst {bursts.peaks[0] / 2**30:.2f} GiB, over the training steps alone {train_peak / 2**30:.2f} "
              f"GiB (towers on the host)")
    if sampled:
        print(f"{model} SampleLogger (student, 4 steps, 1 prompt, under sampling_frozen): {sampled[0]:.2f} s, "
              f"{len(sampled[1])} PNG of {size}², decoded")
    del trainer, fl, frozen_modules
    return launches


# phase 10: the SD1.5 training run's settings over flash_sd.yaml stage 1
RUN_OVERRIDES = {"EMA_DECAY": 0.999, "GRADIENT_ACCUMULATION_STEPS": 2, "VAL_EVERY_N_STEPS": 4,
                 "CKPT_EVERY_N_STEPS": 4}
RUN_SHARDS = (3, 12)  # training shards, samples in each; plus one eval shard of 8
RUN_RESUME_TOL = 1e-3  # the LoRA after the same steps, continuing vs resumed (rel. L2)


def write_run_shards(root, n_shards, per_shard, seed, first=0):
    """Webdataset shards of ``.jpg`` (random noise, 512–768 a side) and
    ``.json`` (``caption``, ``aesthetic_score``: every fourth below 6, the
    yaml's ``MIN_AESTHETIC_SCORE``) from ``seed``; returns (paths, kept,
    dropped)."""
    import io
    import tarfile

    from PIL import Image

    rng = np.random.default_rng(seed)
    paths, kept, idx = [], 0, first
    for s in range(n_shards):
        path = os.path.join(root, f"{s:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for _ in range(per_shard):
                h, w = (int(v) for v in rng.integers(512, 769, 2))
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=90)
                score = 4.5 if idx % 4 == 0 else 6.5
                kept += score >= 6.0
                meta = json.dumps({"caption": f"a photo, sample {idx}", "aesthetic_score": score}).encode()
                for name, payload in ((f"{idx:06d}.jpg", buf.getvalue()), (f"{idx:06d}.json", meta)):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
                idx += 1
        paths.append(path)
    return paths, kept, n_shards * per_shard - kept


def trainable_state(trainer):
    """The trainable state's tensors by name (LoRA, discriminator, EMA, both
    optimizers' slots, accumulators and counts, the step and the
    generator), copied."""
    out = {f"lora.{n}.{k}": v.detach().clone() for n, ab in trainer.lora.items() for k, v in ab.items()}
    out.update({f"disc.{k}": v.detach().clone() for k, v in trainer.model.discriminator.state_dict().items()})
    if trainer.ema is not None:
        out.update({f"ema.{n}.{k}": v.detach().clone() for n, ab in trainer.ema.items() for k, v in ab.items()})
    for which in ("opt_g", "opt_d"):
        st = getattr(trainer, which).state_dict()
        out.update({f"{which}.{slot}.{i}": t.detach().clone() for slot, ts in st["slots"].items()
                    for i, t in enumerate(ts)})
        out.update({f"{which}.acc.{i}": t.detach().clone() for i, t in enumerate(st["acc"])})
        out[f"{which}.counts"] = torch.tensor([st["count"], st["mini_step"]])
    out["step"] = torch.tensor(trainer.step)
    out["generator"] = trainer.generator.get_state().clone()
    return out


def moved(a, b, prefix):
    return any(not torch.equal(a[k], b[k]) for k in a if k.startswith(prefix))


def lora_vector(tree):
    return torch.cat([t.detach().float().reshape(-1) for ab in tree.values() for t in ab.values()])


def run_training_run(counters, card, required, gated, root):
    """Phase 10: the SD1.5 training run at 512² through the user's entry
    points: 3 training shards and 1 eval shard of JPEGs (512–768 a side,
    every fourth score below ``MIN_AESTHETIC_SCORE``) written from seed 0
    under ``root`` (``train/``, ``eval/``; phase 11 reads them again);
    ``build_trainer("sd15")`` with ``flash_sd.yaml`` stage 1 and
    ``RUN_OVERRIDES`` (EMA 0.999, accumulation 2, validation and
    checkpoints every 4 micro-steps); ``build_data`` (thread workers) and
    ``tokenize_batches`` behind ``prefetch_to_device``; ``fit`` of 4
    micro-steps with ``MetricLogger``, ``CheckpointCallback`` and a
    ``SampleLogger`` (the yaml's 2 prompts, 1, 2 and 4 steps, the teacher's
    Euler-ancestral samples at CFG 5) and ``eval_data``. Checks: after
    micro-step 1 the LoRA, the discriminator and the EMA are unchanged;
    after micro-step 2 all moved, EMA = 0.999·EMA₀ + 0.001·LoRA to fp32
    rounding; the validation finite; every sample PNG decodes; a checkpoint
    at step 4, which a fresh trainer restores bit for bit (the generator
    included); two more micro-steps (one update) on the continuing and the
    resumed trainer with the same batches draw the same starts and leave
    the LoRAs within ``RUN_RESUME_TOL``; two steps in the alternating mode
    (``"g"`` moves the LoRA only, ``"d"`` the discriminator only); the
    export read back equal to the EMA tree, and ``build_pipeline("sd15",
    lora=...)`` generating 4 finite images. Counts reset just before the
    first step; K1, K2, K3, K6, K7, K8 and the GroupNorm kernels launched
    and every launched (kernel, shape) among phase 2's."""
    from flash_diffusion_tpu_torch.data import prefetch_to_device
    from flash_diffusion_tpu_torch.lora import load_peft_safetensors, save_peft_safetensors
    from flash_diffusion_tpu_torch.sample import build_pipeline
    from flash_diffusion_tpu_torch.train import (
        CONFIGS,
        build_data,
        build_trainer,
        load_config,
        make_tokenizer,
        tokenize_batches,
    )
    from flash_diffusion_tpu_torch.trainer import (
        CheckpointCallback,
        MetricLogger,
        SampleLogger,
        export_lora,
        latest_step,
        restore_state,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "eval"))
    shards, kept, dropped = write_run_shards(os.path.join(root, "train"), *RUN_SHARDS, seed=0)
    eval_shards, e_kept, e_dropped = write_run_shards(os.path.join(root, "eval"), 1, 8, seed=1, first=1000)
    print(f"train run shards: {len(shards)} training shards, {kept} samples kept and {dropped} dropped by "
          f"MIN_AESTHETIC_SCORE; 1 eval shard, {e_kept} kept and {e_dropped} dropped "
          f"({time.perf_counter() - t0:.2f} s to write)")
    cfg = {**load_config(CONFIGS["sd15"]), **TRAIN_OVERRIDES, **RUN_OVERRIDES,
           "SHARDS_PATH_OR_URLS": [os.path.join(root, "train", "{000000..%06d}.tar" % (len(shards) - 1))]}
    size, batch = cfg["IMAGE_SIZE"], cfg["BATCH_SIZE"]
    t0 = time.perf_counter()
    trainer = build_trainer("sd15", device="cuda", seed=0, config=cfg)
    print(f"build_trainer('sd15') for the run: {time.perf_counter() - t0:.2f} s")
    tok = make_tokenizer("sd15", cfg)
    data = prefetch_to_device(tokenize_batches(build_data(cfg, num_workers=2), tok, "sd15", size))
    eval_pipe = build_data({**cfg, "SHARDS_PATH_OR_URLS": eval_shards}, num_workers=1)
    eval_data = lambda: tokenize_batches(eval_pipe.batches(epoch=0), tok, "sd15", size)
    prompts = cfg["VALIDATION_PROMPTS"]
    samples = SampleLogger(lambda: {"text": prompts, **tok(prompts)}, (size // 8, size // 8, 4),
                           out_dir=os.path.join(root, "samples"), every_n_steps=4, num_steps=cfg["NUM_STEPS"],
                           log_teacher_samples=True, teacher_guidance_scale=5.0)
    ckpt = os.path.join(root, "checkpoints")
    timer, metrics = StepTimer("sd15 run"), MetricLogger(1)
    callbacks = [timer, metrics, CheckpointCallback(ckpt, 4), samples]
    batches = iter(data)
    checked = []

    def fed():  # the batches fit takes, their scores checked against the filter
        for b in batches:
            if not all(float(v) >= cfg.get("MIN_AESTHETIC_SCORE", 6.0) for v in b["aesthetic_score"]):
                raise AssertionError(f"a batch kept scores below MIN_AESTHETIC_SCORE: {b['aesthetic_score']}")
            checked.append(len(b["text"]))
            yield b

    stream = fed()
    reset(counters)
    state0 = trainable_state(trainer)
    timer.mark()
    trainer.fit(stream, max_steps=1, callbacks=callbacks, eval_data=eval_data)
    state1 = trainable_state(trainer)
    if any(moved(state0, state1, p) for p in ("lora.", "disc.", "ema.")):
        raise AssertionError("micro-step 1 of 2 moved the LoRA, the discriminator or the EMA")
    trainer.fit(stream, max_steps=2, callbacks=callbacks, eval_data=eval_data)
    state2 = trainable_state(trainer)
    stuck = [p for p in ("lora.", "disc.", "ema.") if not moved(state1, state2, p)]
    if stuck:
        raise AssertionError(f"micro-step 2 (the first update) left {stuck} unchanged")
    ema_err = max(((e - (state1[f"ema.{n}.{k}"] * 0.999 + trainer.lora[n][k].detach() * (1.0 - 0.999))).abs()
                   / (e.abs() + 1e-30)).max().item() for n, ab in trainer.ema.items() for k, e in ab.items())
    if ema_err > 4 * 2.0 ** -23:
        raise AssertionError(f"EMA after the first update: max rel err {ema_err:.3e} from 0.999·EMA₀ + 0.001·LoRA")
    trainer.fit(stream, max_steps=4, callbacks=callbacks, eval_data=eval_data)
    val = dict(trainer.last_val)
    if not val or not all(map(math.isfinite, val.values())):
        raise AssertionError(f"validation at step 4: {val}")
    pngs = [p for p in samples.written if p.endswith(".png")]
    check_pngs(pngs, samples, size)
    if latest_step(ckpt) != 4:
        raise AssertionError(f"no checkpoint at step 4 under {ckpt}")
    fit_wait = trainer.data_wait_s
    # resume: a fresh trainer from the checkpoint, then two more micro-steps on both
    t0 = time.perf_counter()
    resumed = build_trainer("sd15", device="cuda", seed=0, config=cfg)
    restore_state(ckpt, resumed)
    saved, back = trainable_state(trainer), trainable_state(resumed)
    differ = [k for k in saved if not torch.equal(saved[k].cpu(), back[k].cpu())]
    if differ or saved.keys() != back.keys():
        raise AssertionError(f"the restored state differs from the saved one at {differ[:5]}")
    restore_s = time.perf_counter() - t0
    more = [next(stream), next(stream)]
    auxes = [tr.fit(iter(more), max_steps=6, callbacks=[MetricLogger(1)]) for tr in (trainer, resumed)]
    starts = [a["start_timestep"] for a in auxes]
    resume_err = rel_l2(lora_vector(resumed.lora), lora_vector(trainer.lora))
    print(f"sd15 run resume: state restored bit for bit ({len(saved)} tensors, the generator and counts included; "
          f"build + restore {restore_s:.2f} s); 2 more micro-steps: start timesteps {starts}, LoRA rel L2 "
          f"continuing vs resumed {resume_err:.3e} (tol {RUN_RESUME_TOL})")
    if starts[0] != starts[1] or not resume_err <= RUN_RESUME_TOL:
        raise AssertionError("the resumed run drew other starts or its LoRA left the continuing one's")
    path = os.path.join(root, "pytorch_lora_weights.safetensors")
    save_peft_safetensors(path, export_lora(trainer), prefix="unet")
    back_tree, scaling = load_peft_safetensors(path)
    if not all(torch.equal(back_tree[n][k], trainer.ema[n][k].cpu()) for n in trainer.ema for k in ("a", "b")):
        raise AssertionError("the exported PEFT file does not read back as the EMA tree")
    del resumed, trainer
    torch.cuda.empty_cache()
    # the alternating mode: "g" on step 0, "d" on step 1
    alt = build_trainer("sd15", device="cuda", seed=0, config={**cfg, "GAN_UPDATE_MODE": "alternating",
                                                                "GRADIENT_ACCUMULATION_STEPS": 1})
    a0 = trainable_state(alt)
    alt.fit(stream, max_steps=1)
    a1 = trainable_state(alt)
    alt.fit(stream, max_steps=2)
    a2 = trainable_state(alt)
    if not (moved(a0, a1, "lora.") and not moved(a0, a1, "disc.") and moved(a1, a2, "disc.")
            and not moved(a1, a2, "lora.")):
        raise AssertionError("alternating mode: the g step must move the LoRA only, the d step the "
                             "discriminator only")
    del alt
    stream.close()
    data.close()  # the prefetch thread, and with it the pipeline's workers
    torch.cuda.empty_cache()
    pipe = build_pipeline("sd15", device="cuda", seed=0, lora=path)
    images = pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=0)
    torch.cuda.synchronize()
    px = pipe.latent_shape[0] * pipe.vae_scale_factor
    if tuple(images.shape) != (4, px, px, 3) or not bool(torch.isfinite(images).all()):
        raise AssertionError(f"the LoRA pipeline's images: {tuple(images.shape)}, finite {torch.isfinite(images).all()}")
    del pipe, images
    launches = totals(counters)
    print(f"sd15 run launches {dict(launches)}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the sd15 training run never launched {missing}")
    check_gated("sd15 training run", counters, gated)
    timed = timer.times[1:]
    print(f"sd15 training run {size}² batch {batch} on {card}: warm {statistics.median(timed):.4f} s/micro-step "
          f"(median of {[round(t, 4) for t in timed]}; step 4 with the validation pass), {sum(checked)} images over "
          f"{len(checked)} batches; fit waited {fit_wait:.3f} s on the data iterator; validation "
          + ", ".join(f"{k} {v:.5g}" for k, v in val.items())
          + f"; {len(pngs)} sample grids; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


# phase 11: the sampled images at adapter_conditioning_scale 1 and 0 (same
# latents and noise) must differ by this relative L2 at least: the edge
# map conditions the student
CANNY_SCALE_MIN_DIFF = 1e-2


def busy_share(fn):
    """(wall seconds, device-busy seconds) of ``fn()`` under
    ``torch.profiler``: the kernels' summed device time (the port runs on
    one stream; ``profiling.py``'s count; the device activity alone, so that
    the host's own events neither slow the step nor the count), None where
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0 and str(e.device_type).endswith("CUDA")
               and not e.key.startswith("fdt.")) / 1e6
    return wall, busy or None


def run_canny_training(counters, card, required, gated, root):
    """Phase 11: the Canny T2I-Adapter distillation run at 512² through the
    user's entry points, on phase 10's JPEG shards under ``root``:
    ``build_trainer("sd15-canny")`` with ``flash_canny_adapter.yaml`` stage
    1, ``build_data`` with the Canny mapper (``train.data_mappers``) and the
    zero text ids behind ``prefetch_to_device``; ``fit`` of 4 steps (1 warm,
    3 timed), a 5th under the profiler (the busy time); the adapter
    unchanged and in no optimizer, the LoRA moved; the student's samples at
    ``adapter_conditioning_scale`` 1 and 0 apart; the PEFT export read back
    equal. Counts reset just before the first step and read after the
    export; the required kernels launched and every (kernel, shape) among
    phase 2's."""
    from flash_diffusion_tpu_torch.data import prefetch_to_device
    from flash_diffusion_tpu_torch.lora import load_peft_safetensors, save_peft_safetensors
    from flash_diffusion_tpu_torch.train import (
        CONFIGS,
        build_data,
        build_trainer,
        data_mappers,
        load_config,
        make_tokenizer,
        tokenize_batches,
    )
    from flash_diffusion_tpu_torch.trainer import export_lora

    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = {**load_config(CONFIGS["sd15-canny"]), **TRAIN_OVERRIDES,
           "SHARDS_PATH_OR_URLS": [os.path.join(root, "train", "{000000..%06d}.tar" % (RUN_SHARDS[0] - 1))]}
    size, batch = cfg["IMAGE_SIZE"], cfg["BATCH_SIZE"]
    t0 = time.perf_counter()
    trainer = build_trainer("sd15-canny", device="cuda", seed=0, config=cfg)
    fl = trainer.model
    adapter = fl.adapter
    print(f"build_trainer('sd15-canny'): {time.perf_counter() - t0:.2f} s; adapter "
          f"{sum(p.numel() for p in adapter.parameters())} parameters ({adapter.config.channels}, "
          f"{next(adapter.parameters()).dtype}), scale {fl.config.adapter_conditioning_scale}, input "
          f"{fl.config.adapter_input_key!r}; K = {fl.config.K[1]} {cfg['TEACHER_SCHEDULER']}; LoRA {len(trainer.lora)} "
          f"pairs of rank {cfg['LORA_RANK']}; discriminator {fl.discriminator.config.num_stages} stages")
    held = {id(p) for opt in (trainer.opt_g, trainer.opt_d) for p in opt.params}
    if held & {id(p) for p in adapter.parameters()} or any(p.requires_grad for p in adapter.parameters()):
        raise AssertionError("the adapter is trainable or held by an optimizer")
    frozen = snapshot([adapter])
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    canny = data_mappers("sd15-canny")[0]
    img = np.random.default_rng(0).uniform(-1.0, 1.0, (size, size, 3)).astype(np.float32)
    canny_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        canny({"image": img})
        canny_s.append(time.perf_counter() - t0)
    tok = make_tokenizer("sd15-canny", cfg)
    data = prefetch_to_device(tokenize_batches(build_data(cfg, data_mappers("sd15-canny"), num_workers=2), tok,
                                               "sd15-canny", size))
    stream = iter(data)
    timer = StepTimer("sd15-canny")
    reset(counters)
    timer.mark()
    trainer.fit(stream, max_steps=4, callbacks=[timer])
    timed, fit_wait = timer.times[1:], trainer.data_wait_s
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    profiled_s, busy = busy_share(lambda: trainer.fit(stream, max_steps=5))
    profiler_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(frozen, snapshot([adapter]))):
        raise AssertionError("the adapter changed")
    if not all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items()):
        raise AssertionError("a LoRA B factor did not change")
    host = next(stream)
    edge = np.asarray(host["edge"])
    if edge.shape != (batch, size, size, 3) or not set(np.unique(edge)) <= {0.0, 1.0} or not 0 < edge.mean() < 0.5:
        raise AssertionError(f"Canny edge maps {edge.shape}, values {np.unique(edge)[:4]}, mean {edge.mean():.3f}")
    t0 = time.perf_counter()
    staged = trainer.stage_batch(host)
    z = torch.randn((batch, size // 8, size // 8, 4), generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    images = [fl.sample(trainer.lora, z, staged, num_steps=4, generator=torch.Generator("cuda").manual_seed(4),
                        adapter_conditioning_scale=scale) for scale in (1.0, 0.0)]
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    diff = rel_l2(images[0].float(), images[1].float())
    print(f"sd15-canny samples (student, 4 steps, {batch} edge maps of {size}², edge density {edge.mean():.3f}): "
          f"scale 1 vs 0 rel L2 {diff:.3e} (at least {CANNY_SCALE_MIN_DIFF})")
    if not (all(tuple(im.shape) == (batch, size, size, 3) and bool(torch.isfinite(im).all()) for im in images)
            and diff >= CANNY_SCALE_MIN_DIFF):
        raise AssertionError("the adapter's samples are malformed, or scale 1 and 0 give the same images")
    t0 = time.perf_counter()
    path = os.path.join(root, "canny_lora.safetensors")
    save_peft_safetensors(path, export_lora(trainer), prefix="unet")
    back, _ = load_peft_safetensors(path)
    if not all(torch.equal(back[n][k], trainer.lora[n][k].detach().cpu()) for n in trainer.lora for k in ("a", "b")):
        raise AssertionError("the exported PEFT file does not read back as the LoRA")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data.close()
    close_s = time.perf_counter() - t0
    launches = totals(counters)
    print(f"sd15-canny launches {dict(launches)}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the sd15-canny run never launched {missing}")
    check_gated("sd15-canny training", counters, gated)
    per_step = statistics.median(timed)
    print(f"sd15-canny Flash distillation {size}² batch {batch} on {card}: warm {per_step:.4f} s/step (median of "
          f"{[round(t, 4) for t in timed]}), {batch / per_step:.3f} images/s; fit waited {fit_wait:.3f} s on data "
          f"over 4 steps (the Canny mapper alone: {1e3 * min(canny_s):.1f} ms a {size}² image on the host); peak "
          f"memory {peak / 2**30:.2f} GiB; step 5 under the profiler {profiled_s:.3f} s, device busy "
          + ("not measured" if busy is None else f"{busy:.3f} s ({100 * busy / profiled_s:.1f}% of it, "
             f"{100 * busy / per_step:.1f}% of the warm step)") + f" (with the profiler's work {profiler_s:.2f} s); "
          f"the two samples {sample_s:.2f} s; PEFT export {os.path.getsize(path) / 2**20:.1f} MiB, written and "
          f"read back in {export_s:.2f} s; the data pipeline closed in {close_s:.2f} s; "
          f"{time.perf_counter() - started:.1f} s")
    del trainer, fl, adapter, staged, images
    return launches


# phase 11c: the DPT in bf16 on the card against its fp32 CPU copy, then the
# depth maps' images. Random init leaves the DPT nearly inert where the
# check looks: the softmax near uniform over the 577 keys (where any
# attention gives about mean(v)) and the head's map flat to a few
# thousandths, which its ReLU cuts to 0 about half the time.
# ``calibrate_dpt`` scales q and k of every block by DPT_QK_SCALE, so that
# the attention is sharp as a trained ViT's, and the head's last 1×1 conv so
# that the map varies by about 1 around 3 on the check's image. What is
# compared is what varies: each hook tap (the backbone's tokens) less its
# mean over tokens, the depth map and the DepthMapper's map less their mean
# over pixels, as a relative L2 (``centered_rel_l2``), within
# DPT_REL_L2_TOL. The faults of DPT_FAULTS, run on the card, must fall
# outside it, so that the check is seen to fail a wrong attention
DPT_QK_SCALE = 3.0
DPT_REL_L2_TOL = 0.05
DPT_FAULTS = {
    "attention zeroed": lambda attend, q, k, v: torch.zeros_like(q),
    "values one key on": lambda attend, q, k, v: attend(q, k, v.roll(1, 1)),
}
DEPTH_IMAGES = 4


def calibrate_dpt(net, x):
    """Scale q and k of every block of ``net`` by ``DPT_QK_SCALE``, then its
    head's last 1×1 conv so that the map of ``x`` has mean 3 and std 1
    before the ReLU."""
    last = net.scratch.output_conv[4]
    feats = []
    handle = last.register_forward_hook(lambda _m, inputs, _out: feats.append(inputs[0]))
    with torch.inference_mode():
        for block in net.pretrained.model.blocks:
            block.attn.qkv.weight[:2 * net.dim] *= DPT_QK_SCALE
            block.attn.qkv.bias[:2 * net.dim] *= DPT_QK_SCALE
        try:
            net(x)
        finally:
            handle.remove()
        m = F.conv2d(feats[0].float(), last.weight.float())
        scale = 1.0 / m.std().item()
        last.weight *= scale
        last.bias.fill_(3.0 - m.mean().item() * scale)


def dpt_readings(net, x):
    """(the four hook taps [B, 577, dim], the depth map [B, H, W]) of ``net``
    on ``x``, fp32 on the CPU."""
    taps = []
    blocks = net.pretrained.model.blocks
    handles = [blocks[i].register_forward_hook(lambda _m, _a, out: taps.append(out.float().cpu()))
               for i in net.hooks]
    try:
        with torch.inference_mode():
            depth = net(x.to(next(net.parameters()).device)).cpu()
    finally:
        for h in handles:
            h.remove()
    return taps, depth


def centered_rel_l2(got, want, dims):
    """Relative L2 of what varies over ``dims``: each less its own mean there."""
    got, want = got - got.mean(dims, keepdim=True), want - want.mean(dims, keepdim=True)
    return ((got - want).norm() / want.norm()).item()


def dpt_errors(got, want):
    """{reading: centered relative L2 of ``got`` against ``want``}, both
    ``dpt_readings``: each tap over its tokens, the depth map over its pixels."""
    errs = {f"tap {i}": centered_rel_l2(g, w, 1) for i, (g, w) in enumerate(zip(got[0], want[0]))}
    errs["depth"] = centered_rel_l2(got[1], want[1], (1, 2))
    return errs


@contextlib.contextmanager
def dpt_attention_fault(fault):
    """The DPT's attention as ``fault(attend, q, k, v)`` inside the block."""
    from flash_diffusion_tpu_torch.models import depth

    attend = depth.dot_product_attention
    depth.dot_product_attention = lambda q, k, v: fault(attend, q, k, v)
    try:
        yield
    finally:
        depth.dot_product_attention = attend


def check_dpt(cpu_bf16=False):
    """Phase 11c's comparison: ``DPTDepth()`` (ViT-L/16 at 384², random
    weights from seed 0, ``calibrate_dpt``) in bf16 on the card against its
    fp32 CPU copy on one image, every reading of ``dpt_errors`` within
    ``DPT_REL_L2_TOL``, each fault of ``DPT_FAULTS`` outside it. With
    ``cpu_bf16`` (``train_ref_precision.py --model dpt``), also the CPU copy
    in bf16 (the plain attention, no kernel) against fp32 and the card
    against it, printed, ungated: the bf16 floor. Returns (the card's net,
    the fp32 copy)."""
    from flash_diffusion_tpu_torch.models import DPTDepth

    x = torch.rand((1, 384, 384, 3), generator=torch.Generator().manual_seed(0))
    with torch.random.fork_rng(devices=[0]):
        torch.manual_seed(0)
        with torch.device("cuda"):
            net = DPTDepth()
    net = net.to(torch.bfloat16).eval()
    calibrate_dpt(net, x.cuda())
    with torch.device("meta"):
        meta = DPTDepth()
    ref = cpu_fp32_copy(net.state_dict(), meta)
    got, want = dpt_readings(net, x), dpt_readings(ref, x)
    errs = dpt_errors(got, want)
    faulted = {}
    for name, fault in DPT_FAULTS.items():
        with dpt_attention_fault(fault):
            faulted[name] = dpt_errors(dpt_readings(net, x), want)
    fmt = lambda e: ", ".join(f"{k} {v:.3e}" for k, v in e.items())
    print(f"DPT (ViT-L/16, {sum(p.numel() for p in net.parameters())} parameters, q and k × {DPT_QK_SCALE}) at "
          f"384², 1 image: bf16 on the card vs fp32 on the CPU, centered rel L2 (tol {DPT_REL_L2_TOL}): "
          f"{fmt(errs)}; depth mean {want[1].mean().item():.4g}, std {want[1].std().item():.4g}, positive "
          f"{(want[1] > 0).float().mean().item():.4f}")
    for name, e in faulted.items():
        print(f"  the card with its attention faulted ({name}): {fmt(e)}")
    if cpu_bf16:
        low = dpt_readings(copy.deepcopy(ref).to(torch.bfloat16), x)
        print(f"  the CPU copy in bf16 (plain attention) vs fp32: {fmt(dpt_errors(low, want))}")
        print(f"  the card vs the CPU copy in bf16: {fmt(dpt_errors(got, low))}")
    if not (torch.isfinite(got[1]).all() and max(errs.values()) <= DPT_REL_L2_TOL):
        raise AssertionError("the card's DPT disagrees with its fp32 reference")
    passed = [name for name, e in faulted.items() if max(e.values()) <= DPT_REL_L2_TOL]
    if passed:
        raise AssertionError(f"the DPT check passes a faulted attention: {passed}")
    return net, ref


def check_depth(counters, card, required, gated):
    """Phase 11c: ``check_dpt``; then ``DepthMapper(make_depth_fn(...))``
    over ``DEPTH_IMAGES`` images of 512² (smooth gradients and discs with
    noise), counts reset just before and read just after: [512, 512, 3]
    maps in [0, 1], the first within ``DPT_REL_L2_TOL`` (centered) of the
    fp32 copy's, the required kernels launched, every (kernel, shape) among
    phase 2's; ms a map."""
    from flash_diffusion_tpu_torch.data import DepthMapper, DepthMapperConfig
    from flash_diffusion_tpu_torch.models import make_depth_fn

    started = time.perf_counter()
    net, ref = check_dpt()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:512]
    images = [np.clip(np.stack([xx * 0.4 + 40 * i, yy * 0.4, ((xx - 256 - 40 * i) ** 2 + (yy - 256) ** 2 < 150 ** 2)
                                * 200.0], -1) + rng.normal(0, 10, (512, 512, 3)), 0, 255).astype(np.float32)
              for i in range(DEPTH_IMAGES)]
    mapper = DepthMapper(DepthMapperConfig(), make_depth_fn(net))
    reset(counters)
    times, maps = [], []
    for img in images:
        t0 = time.perf_counter()
        maps.append(mapper({"image": img})["depth"])  # the map comes back to the host: synchronized
        times.append(time.perf_counter() - t0)
    launches = totals(counters)
    print(f"depth launches {dict(launches)}")
    if not all(m.shape == (512, 512, 3) and np.isfinite(m).all() and 0 <= m.min() and m.max() <= 1 for m in maps):
        raise AssertionError("a depth map is malformed")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the depth path never launched {missing}")
    check_gated("depth", counters, gated)
    want = DepthMapper(DepthMapperConfig(), make_depth_fn(ref))({"image": images[0]})["depth"]
    err = centered_rel_l2(torch.from_numpy(maps[0]), torch.from_numpy(want), (0, 1))
    print(f"DepthMapper's first map, the card vs the fp32 copy: centered rel L2 {err:.3e} (tol {DPT_REL_L2_TOL}); "
          f"its std {want.std():.4f}")
    if err > DPT_REL_L2_TOL:
        raise AssertionError("the card's depth map disagrees with its fp32 reference")
    print(f"DepthMapper(make_depth_fn(DPTDepth bf16)) on {card}: {DEPTH_IMAGES} images of 512², "
          f"{1e3 * statistics.median(times[1:]):.2f} ms a map warm (median of "
          f"{[round(1e3 * t, 2) for t in times[1:]]}; the first {1e3 * times[0]:.2f}); "
          f"{time.perf_counter() - started:.1f} s")
    del net, ref, mapper
    return launches


# phase 12: the eval path. The seeded CLIP-L/14 (both towers and both
# projections, transformers' names) has q and k of every vision layer × 3
# (as ``calibrate_dpt``: a random ViT's attention is near uniform over its
# 257 keys, where any attention gives about mean(v)); the seeded
# InceptionV3 (torchvision's names, pt_inception's file name: the FID
# blocks) has its BatchNorm statistics set from one batch of real images,
# so that every layer's output is O(1). The fidelity check compares the
# card's features with their fp32 CPU copies on one batch of 4 real images:
# the ViT's image_embeds in bf16 within VIT_REL_L2_TOL (this phase read
# 1.143e-02 on an H100, 8.782e-01 with the attention zeroed, which must
# fall outside it); InceptionV3's pool3 in fp32 (cuDNN's convolutions, TF32
# off: 8.735e-04) within INCEPTION_REL_L2_TOL
VIT_QK_SCALE = 3.0
VIT_REL_L2_TOL = 3e-2
INCEPTION_REL_L2_TOL = 1e-2
VIT_FAULTS = {"attention zeroed": lambda attend, q, k, v: torch.zeros_like(q)}


def write_eval_weights(root, real_images):
    """(weights root, Inception file) under ``root``: ``image_encoder/
    model.safetensors``, a full CLIP ViT-L/14 from seed 0 (q, k × 3), and
    ``pt_inception-2015-12-05-smoke.pth``, InceptionV3 from seed 0 with the
    FID blocks, BatchNorm statistics from ``real_images`` and a 1008-class
    fc beside, as the published file holds."""
    from safetensors.torch import save_file

    from flash_diffusion_tpu_torch.models import (
        CLIPTextModel, CLIPVisionModel, InceptionV3Pool3, clip_l_config, clip_vit_l14_config)
    from flash_diffusion_tpu_torch.models.inception import preprocess

    with torch.random.fork_rng(devices=[0]):
        torch.manual_seed(0)
        with torch.device("cuda"):
            vision, text = CLIPVisionModel(clip_vit_l14_config()), CLIPTextModel(clip_l_config(projection_dim=768))
            incep = InceptionV3Pool3(fid_variant=True)
    with torch.no_grad():
        for layer in vision.vision_model.encoder.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj):
                proj.weight *= VIT_QK_SCALE
                proj.bias *= VIT_QK_SCALE
        for m in incep.modules():  # one batch's statistics: momentum 1 keeps the last batch's
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = 1.0
        incep.train()
        incep(preprocess(real_images.cuda()))
        incep.eval()
    weights = os.path.join(root, "weights")
    os.makedirs(os.path.join(weights, "image_encoder"))
    clip = {k: v.contiguous() for k, v in {**vision.state_dict(), **text.state_dict()}.items()}
    save_file({**clip, "logit_scale": torch.tensor(4.6052)}, os.path.join(weights, "image_encoder/model.safetensors"))
    incep_file = os.path.join(weights, "pt_inception-2015-12-05-smoke.pth")
    torch.save({**incep.state_dict(), "fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)},
               incep_file)
    return weights, incep_file


@contextlib.contextmanager
def vit_attention_fault(fault):
    """The CLIP vision tower's attention as ``fault(attend, q, k, v)``."""
    from flash_diffusion_tpu_torch.models import vision

    attend = vision.dot_product_attention
    vision.dot_product_attention = lambda q, k, v: fault(attend, q, k, v)
    try:
        yield
    finally:
        vision.dot_product_attention = attend


def extractor_ms(embed, images, reps=5):
    """Warm ms an image of ``embed`` over ``images`` (host timing around a
    synchronized call: the preprocessing's resize included)."""
    embed(images)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embed(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times) / images.shape[0]


def check_eval_fidelity(weights, incep_file, real_images, card):
    """The card's CLIP image_embeds (bf16) and InceptionV3 pool3 (fp32) on
    ``real_images`` against their fp32 CPU copies from the same files, each
    within its tolerance; the ViT with its attention zeroed outside; the
    Fréchet distance of the card's features to the CPU's printed; ms an
    image of each extractor."""
    from flash_diffusion_tpu_torch.eval import clip_embed_fn, fid_from_features, inception_embed_fn
    from flash_diffusion_tpu_torch.eval_coco import clip_extractors
    from flash_diffusion_tpu_torch.models import load_inception_v3

    clip_file = os.path.join(weights, "image_encoder/model.safetensors")
    zeros = lambda texts: {"text_ids": np.zeros((len(texts), 77), np.int64)}
    vit = clip_extractors(clip_file, zeros, torch.device("cuda"))[0]
    vit_ref = clip_extractors(clip_file, zeros, torch.device("cpu"))[0]
    incep, incep_ref = (load_inception_v3(incep_file, True, dev) for dev in ("cuda", "cpu"))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 extractors would not run in fp32")
    feats = {}
    for name, embed, ref in (("clip", clip_embed_fn(vit), clip_embed_fn(vit_ref)),
                             ("inception", inception_embed_fn(incep), inception_embed_fn(incep_ref))):
        feats[name] = (embed(real_images).cpu(), ref(real_images))
        ms = extractor_ms(embed, real_images.cuda())
        print(f"  {name} extractor on {card}: {ms:.3f} ms an image warm, batch {real_images.shape[0]}")
    errs = {name: rel_l2(*pair) for name, pair in feats.items()}
    faulted = {}
    for name, fault in VIT_FAULTS.items():
        with vit_attention_fault(fault):
            faulted[name] = rel_l2(clip_embed_fn(vit)(real_images).cpu(), feats["clip"][1])
    fds = {name: fid_from_features(got.double().numpy(), want.double().numpy()) for name, (got, want) in feats.items()}
    tols = {"clip": VIT_REL_L2_TOL, "inception": INCEPTION_REL_L2_TOL}
    print("eval extractors, the card vs their fp32 CPU copies on 4 real images, rel L2 (tol): " + ", ".join(
        f"{k} {e:.3e} ({tols[k]})" for k, e in errs.items()) + "; Fréchet distance card vs CPU: " + ", ".join(
        f"{k} {v:.4g}" for k, v in fds.items()) + "; the ViT with its attention faulted: " + ", ".join(
        f"{k} {v:.3e}" for k, v in faulted.items()))
    if not all(math.isfinite(e) and e <= tols[k] for k, e in errs.items()):
        raise AssertionError("an eval extractor on the card disagrees with its fp32 reference")
    passed = [name for name, e in faulted.items() if e <= VIT_REL_L2_TOL]
    if passed:
        raise AssertionError(f"the ViT check passes a faulted attention: {passed}")
    return fds


def run_eval(counters, card, required, gated, root):
    """Phase 12: seeded extractor files (``write_eval_weights``), then
    ``eval_coco.main`` over phase 10's JPEG + caption shards under ``root``
    (``--model sd15 --random-init``, batch 4, 2 batches), counts reset just
    before and read just after: finite fid, clip_fid and clip_score in
    [0, 100] over 8 samples, the required kernels launched (K1 at the ViT's
    [64, 257, 257, 64], K3 at [1028, 1024]), every (kernel, shape) among
    phase 2's; then ``check_eval_fidelity``."""
    from flash_diffusion_tpu_torch import eval_coco
    from flash_diffusion_tpu_torch.data import DataModuleConfig, DataPipeline

    started = time.perf_counter()
    shards = sorted(os.path.join(root, "train", f) for f in os.listdir(os.path.join(root, "train")))
    data = DataPipeline(DataModuleConfig(shards_path_or_urls=shards, per_worker_batch_size=EVAL_BATCH,
                                         num_workers=1, shuffle_buffer_size=1, shuffle_shards=False),
                        eval_coco.data_chain(512))
    real = torch.from_numpy(np.asarray(next(iter(data.batches(epoch=0)))["image"]))
    weights, incep_file = write_eval_weights(root, real)
    print(f"eval weights written in {time.perf_counter() - started:.1f} s")
    reset(counters)
    t0 = time.perf_counter()
    metrics = eval_coco.main(["--model", "sd15", "--random-init", "--weights-root", weights, "--shards", *shards,
                              "--inception", incep_file, "--batch-size", str(EVAL_BATCH), "--max-batches", "2",
                              "--device", "cuda"])
    seconds = time.perf_counter() - t0
    launches = totals(counters)
    print(f"eval launches {dict(launches)}")
    ok = (metrics.get("num_samples") == 2 * EVAL_BATCH and all(
        math.isfinite(metrics.get(k, math.nan)) for k in ("fid", "clip_fid", "clip_score"))
        and 0 <= metrics["clip_score"] <= 100)
    if not ok:
        raise AssertionError(f"eval_coco printed a malformed result: {metrics}")
    missing = [k for k in required if launches[k] == 0]
    for kernel, shape in (("flash_fwd_oneshot", ATTENTION_SHAPES_EVAL[0]), ("layer_norm", LAYER_NORM_SHAPES_EVAL[0])):
        if counters[0 if kernel.startswith("flash") else 1][kernel, shape] == 0:
            missing.append(f"{kernel} at {shape}")
    if missing:
        raise AssertionError(f"the eval path never launched {missing}")
    check_gated("eval", counters, gated)
    fds = check_eval_fidelity(weights, incep_file, real, card)
    print(f"eval_coco (sd15 4 steps at 512², CLIP-L/14 bf16, InceptionV3 fp32) on {card}: {metrics}; "
          f"{seconds:.1f} s for {metrics['num_samples']} samples ({seconds / metrics['num_samples']:.3f} s a "
          f"sample, the pipeline's build included); real-vs-fake clip_fid {metrics['clip_fid']:.4g} and fid "
          f"{metrics['fid']:.4g} beside the card-vs-CPU {fds['clip']:.4g} and {fds['inception']:.4g}; "
          f"{time.perf_counter() - started:.1f} s")
    return launches


def run_toy(counters, card, required, gated):
    """Phase 12b: ``toy_quality.main`` and ``toy_quality_rf.main`` at
    ``TOY_STEPS`` teacher and distill steps, batch and n_eval
    ``TOY_BATCH``, counts reset just before the first and read after the
    second: every FD finite, the required kernels launched, every (kernel,
    shape) among phase 2's."""
    from flash_diffusion_tpu_torch import toy_quality, toy_quality_rf

    reset(counters)
    args = ["--teacher-steps", str(TOY_STEPS[0]), "--distill-steps", str(TOY_STEPS[1]), "--batch",
            str(TOY_BATCH), "--n-eval", str(TOY_BATCH), "--device", "cuda"]
    outs = {name: mod.main(args) for name, mod in (("eps", toy_quality), ("rf", toy_quality_rf))}
    launches = totals(counters)
    print(f"toy launches {dict(launches)}")
    for name, out in outs.items():
        print(f"toy proof {name} at {TOY_STEPS[0]}/{TOY_STEPS[1]} steps, batch and n_eval {TOY_BATCH} "
              f"on {card}: {out}")
        if not all(math.isfinite(v) for v in out.values()):
            raise AssertionError(f"the {name} toy proof gave an FD that is not finite: {out}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the toy proofs never launched {missing}")
    check_gated("toy", counters, gated)
    return launches


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float() if x.is_floating_point() else x.cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def num(v) -> float:
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def rel_l2(got, want):
    return ((got - want).norm() / want.norm()).item()


@contextlib.contextmanager
def t5_stand_in():
    """``build_modules("pixart")`` with a 1-layer, 64-wide T5 in place of
    T5-XXL inside the block: phase 7d's CPU copy never runs its conditioner
    (it is fed the card's staged ``__conds``, as 7b feeds the card's T5
    output), so it need not hold a 19 GB fp32 T5."""
    from flash_diffusion_tpu_torch import sample
    from flash_diffusion_tpu_torch.models.embedders import T5TextEmbedderConfig

    saved = sample.T5TextEmbedderConfig
    sample.T5TextEmbedderConfig = lambda **kw: T5TextEmbedderConfig(**kw, text_embedder_config=dict(
        d_model=64, d_ff=64, d_kv=8, num_layers=1, num_heads=8))
    try:
        yield
    finally:
        sample.T5TextEmbedderConfig = saved


@contextlib.contextmanager
def no_random_init():
    """Modules built without ``torch.nn.init``'s random fills (tens of
    seconds for a few billion parameters on the host): the training
    references' CPU copies, whose weights all come from the card's state
    dicts, or are never run."""
    saved = {name: getattr(torch.nn.init, name) for name in ("kaiming_uniform_", "uniform_", "normal_")}
    for name in saved:
        setattr(torch.nn.init, name, lambda tensor, *args, **kwargs: tensor)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.nn.init, name, fn)


def check_training_reference(model="sd15", start=None, cpu_bf16=False, counters=None, gated=None,
                             diagnostics=False):
    """Phases 5b, 5d, 7d, 9b and 11b: one ``losses`` and backward of the trainer
    at 256² on the card (bf16, kernels) vs an fp32 copy on the CPU (plain
    paths) with its state dicts, on the same staged batch (the conditioning
    the card's) and draws (SDXL, Pixart and SD3 from ``TRAIN_REF_START``,
    or from ``start``). With ``gated``, every (kernel, shape) the card's
    side launched (``counters`` reset before its staging) must be among
    phase 2's. With ``diagnostics`` (``train_ref_precision.py``), printed
    beside, ungated: the LoRA gradients' error of each scaled G term alone,
    and of the student's own backward (the gradient of a fixed random
    projection of its output).
    With ``cpu_bf16`` (``train_ref_precision.py``), also the losses of the
    CPU copy in bf16 (the plain paths, no kernel) on the same inputs,
    printed beside the card's, ungated: whether bf16 itself, kernels or not,
    puts a loss as far from fp32 as the card."""
    from flash_diffusion_tpu_torch.train import CONFIGS, build_trainer, load_config, synthetic_batches

    started = time.perf_counter()
    cfg = {**load_config(CONFIGS[model]), **TRAIN_REF_OVERRIDES}
    dev = build_trainer(model, device="cuda", seed=0, config=cfg)
    fed = model in ("pixart", "sd3")  # the CPU copy takes the card's __conds: a stand-in T5, never run
    with t5_stand_in() if fed else contextlib.nullcontext(), no_random_init():
        ref = build_trainer(model, device="cpu", seed=0, config=cfg)  # bf16 until the probe has run
    g = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for name in ("teacher_module", "vae", "conditioner", "lpips", "discriminator", "adapter"):
            if getattr(ref.model, name) is not None and not (name == "conditioner" and fed):
                getattr(ref.model, name).load_state_dict(getattr(dev.model, name).state_dict())
        for name, ab in dev.lora.items():
            ab["b"].normal_(0.0, TRAIN_REF_LORA_B_STD, generator=g)
            for k in ("a", "b"):
                ref.lora[name][k].copy_(ab[k])
    size = cfg["IMAGE_SIZE"]
    batch = next(synthetic_batches(2, size, seed=5, model=model))
    channels = dev.model.vae.config.latent_channels
    noise = torch.randn(2, size // 8, size // 8, channels, generator=g, device="cuda")
    if gated is not None:
        reset(counters)
    staged = dev.stage_batch(batch)
    draws = dev.model.draw(dev.generator, 0, staged["__z"])
    if start is not None or model in TRAIN_REF_START:  # and DDPM's posterior noise from there (DPM, SD3 draw none)
        draws["start_idx"] = start = TRAIN_REF_START[model] if start is None else start
        if dev.model._sched_stochastic:
            draws["rollout_noise"] = [torch.randn(staged["__z"].shape, generator=g, device="cuda")
                                      for _ in range(cfg["K"][0] - start)]
    lora = lambda tr: [f for ab in tr.lora.values() for f in ab.values()]
    flat = lambda gs: torch.cat([gr.detach().float().cpu().reshape(-1) for gr in gs])
    # the student's own backward: LoRA gradients of <student(x), w>, on the
    # card, then on the CPU in bf16 (plain paths) and in fp32
    x, w = (torch.randn(2, size // 8, size // 8, 4, generator=g, device="cuda") for _ in range(2))
    args = (x, torch.full((2,), 500, device="cuda"), staged["__conds"][1], w)

    def probe(tr, x, t, cond, w):
        out = tr.model._student_forward(x, t, cond).float()
        return flat(torch.autograd.grad((out * w).sum(), lora(tr), materialize_grads=True))

    probes = [probe(dev, *args), probe(ref, *to_cpu(args))] if diagnostics else []
    bf16_aux = None
    if cpu_bf16:  # the CPU copy's losses while it is still bf16
        with torch.no_grad():
            bf16_aux = ref.model.losses(to_cpu(staged), to_cpu(draws), 0)[1]
    ref.model.teacher_module.float()  # the student shares these parameters
    ref.model.vae.float()
    if ref.model.adapter is not None:
        ref.model.adapter.float()
    if diagnostics:
        probes.append(probe(ref, *to_cpu(args)))
    with torch.no_grad():
        image = torch.as_tensor(batch["image"])
        z_dev = dev.model._encode({"image": image.cuda()}, noise)
        z_ref = ref.model._encode({"image": image}, noise.cpu())
    # the discriminator's three calls: fake (G), fake (D), real; their inputs and outputs
    d_in, d_out = {id(dev): [], id(ref): []}, {id(dev): [], id(ref): []}

    def tap(key):
        def hook(_m, inputs, out):
            d_in[key].append(inputs[0].detach().float().cpu())
            d_out[key].append(out.detach().float().cpu())
        return hook

    hooks = [tr.model.discriminator.register_forward_hook(tap(id(tr))) for tr in (dev, ref)]
    mcfg = ref.model.config
    scales = {"loss/distill": mcfg.distill_loss_scale[0], "loss/dmd": mcfg.dmd_loss_scale[0],
              "loss/gan_g": mcfg.adversarial_loss_scale[0]}
    results = []
    for tr, args in ((dev, (staged, draws, 0)), (ref, (to_cpu(staged), to_cpu(draws), 0))):
        total, aux = tr.model.losses(*args)
        terms = {k: flat(torch.autograd.grad(sc * aux[k], lora(tr), retain_graph=True, materialize_grads=True))
                 for k, sc in scales.items()} if diagnostics else {}
        total.backward()
        results.append((aux, terms))
    for h in hooks:
        h.remove()
    (aux, terms), (ref_aux, ref_terms) = results
    if gated is not None:
        check_gated(f"{model} training reference", counters, gated)
    card_out = torch.cat(d_out[id(dev)])
    end_to_end = rel_l2(card_out, torch.cat(d_out[id(ref)]))
    with torch.no_grad():
        same_in = torch.cat([ref.model.discriminator(x) for x in d_in[id(dev)]])
    features = [rel_l2(a, b) for a, b in zip(d_in[id(dev)], d_in[id(ref)])]
    grads = lambda ps: flat([p.grad for p in ps])
    rel = lambda k: abs(num(aux[k]) - num(ref_aux[k])) / abs(num(ref_aux[k]))
    errs = {
        "loss/distill": rel("loss/distill"),
        "loss/dmd": rel("loss/dmd"),
        "loss/gan_d": rel("loss/gan_d"),
        "disc outputs": rel_l2(card_out, same_in) if model in DISC_ON_CARD_FEATURES else end_to_end,
        "lora grads": rel_l2(grads(lora(dev)), grads(lora(ref))),
        "disc grads": rel_l2(grads(dev.model.discriminator.parameters()),
                             grads(ref.model.discriminator.parameters())),
        "vae encode": rel_l2(z_dev.cpu(), z_ref),
    }
    tols = {"loss/distill": 0.05, "loss/dmd": 0.05, "loss/gan_d": 0.05, "disc outputs": 0.05,
            "lora grads": 0.1, "disc grads": 0.1, "vae encode": 0.1}
    if model in TRAIN_REF_LOSS_TOL:
        tols.update(dict.fromkeys(("loss/distill", "loss/dmd"), TRAIN_REF_LOSS_TOL[model]))
    print(f"{model} training reference at {size}², batch 2, {cfg['TEACHER_SCHEDULER']} from start index "
          f"{draws['start_idx']} of K = {cfg['K'][0]}, discriminator {dev.model.discriminator.config.num_stages} "
          f"stages: card " + ", ".join(f"{k} {num(v):.5g}" for k, v in aux.items()) + "; CPU fp32 "
          + ", ".join(f"{k} {num(v):.5g}" for k, v in ref_aux.items()) + "; errors (tol) "
          + ", ".join(f"{k} {e:.3e} ({tols[k]})" for k, e in errs.items())
          + f"; {time.perf_counter() - started:.1f} s")
    held = model in DISC_ON_CARD_FEATURES
    print(f"  {model} discriminator: its features (the denoiser's bf16 output) against the CPU copy's, rel L2 "
          + ", ".join(f"{e:.3e}" for e in features) + " (fake G, fake D, real); its outputs on the card's features "
          f"{rel_l2(card_out, same_in):.3e} ({'gated' if held else 'ungated'}), end to end on each side's own "
          f"features {end_to_end:.3e} ({'ungated' if held else 'gated'})")
    if bf16_aux is not None:
        loss_err = lambda a, b, k: abs(num(a[k]) - num(b[k])) / abs(num(b[k]))
        keys = ("loss/distill", "loss/dmd", "loss/gan_d")
        print(f"  {model} CPU copy in bf16 (plain paths, no kernel): " + ", ".join(
            f"{k} {num(bf16_aux[k]):.5g}" for k in keys) + "; rel err vs CPU fp32: CPU bf16 " + ", ".join(
            f"{k} {loss_err(bf16_aux, ref_aux, k):.3e}" for k in keys) + "; card (bf16, kernels) " + ", ".join(
            f"{k} {loss_err(aux, ref_aux, k):.3e}" for k in keys) + "; card vs CPU bf16 " + ", ".join(
            f"{k} {loss_err(aux, bf16_aux, k):.3e}" for k in keys))
    if diagnostics:
        print("  LoRA gradients by scaled G term, rel L2 err (|grad| fp32): " + ", ".join(
            f"{k} {rel_l2(terms[k], ref_terms[k]):.3e} ({ref_terms[k].norm().item():.4g})" for k in scales)
              + f"; the student's own backward against CPU fp32: card bf16 {rel_l2(probes[0], probes[2]):.3e}, "
              f"CPU bf16 (plain paths, no kernels) {rel_l2(probes[1], probes[2]):.3e}")
    if not all(math.isfinite(e) and e <= tols[k] for k, e in errs.items()):
        raise AssertionError(f"the card's {model} training step disagrees with the fp32 reference on a small input")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    for k in SWITCHES:  # each phase sets the modes it drives; the others run the port's defaults
        os.environ.pop(k, None)
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels, norms
    from flash_diffusion_tpu_torch.sample import build_pipeline

    # phase 1: device and build
    started = time.perf_counter()
    last = [started]

    def mark(phases):
        """Print the seconds since the previous mark, as the phases' own."""
        now = time.perf_counter()
        print(f"phase {phases}: {now - last[0]:.1f} s")
        last[0] = now
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc {kernels.BUILD_INFO['seconds']:.2f} s "
          f"-> {kernels.BUILD_INFO['path']}")
    entry, entries, spill_report, serialized = "", set(), [], []
    if kernels.BUILD_INFO["log"] == "(cached)":
        print("  no ptxas report: the library was built before this run (delete build/kernels to see it)")
    for line in kernels.BUILD_INFO["log"].splitlines():  # ptxas -v: one report per kernel
        if "Compiling entry function" in line:
            name = re.search(r"(?<=\d)(flash_(?:fwd|bwd)_\w+?_kernel|layer_norm_(?:rows|wide)_kernel|int8_gemm_kernel|"
                             r"gemm_sm90_kernel|geglu_gemm_kernel|"
                             r"gn_(?:stats|apply|resident)_n(?:chw|hwc)_kernel)(I\w+?E)?E", line)
            entry = name.group(1) + (name.group(2) or "") if name else line.split("'")[1]
            entries.add(entry)
        elif "wgmma" in line and "serializ" in line:  # products that ptxas could not keep in flight
            print(f"  ptxas {entry}: {line.strip()}")
            serialized.append(f"{entry}: {line.strip()}")
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            if "spill" in line and not re.search(r" 0 bytes spill stores, 0 bytes spill loads", line):
                spill_report.append(f"{entry}: {line.strip()}")
    for _, _, kv, d, _ in attention_main():  # the one-shot plan mirrors the kernel's layout
        kind, bq = attention.attention_plan(kv, d)
        kvp, dp = -(-kv // 16) * 16, -(-d // 16) * 16
        if kind == "flash_fwd_oneshot" and lib.fdt_attn_smem_bytes(bq, kvp, dp) != attention.smem_bytes(bq, kvp, dp):
            raise AssertionError(f"shared-memory plan and kernel layout disagree at kv={kv} d={d}")
    for _, _, kv, _, d in PACKED_SHAPES + PACKED_RAGGED:  # K4: K1's kernel at K1's plan
        bq, kvp = attention.packed_oneshot_tile(kv, d), -(-kv // 16) * 16
        if not lib.fdt_attn_smem_bytes(bq, kvp, d) == attention.smem_bytes(bq, kvp, d) <= attention._SMEM_LIMIT:
            raise AssertionError(f"K4 shared-memory plan and kernel layout disagree at kv={kv} d={d}")
    for d in range(8, 161, 8):  # K8's tiles, at every head dim and KV it could take
        for kv in range(1, 257):
            got = (ctypes.c_int * 5)()
            err = lib.fdt_flash_bwd_oneshot_tiles(kv, d, got)
            want = attention.bwd_oneshot_tiles(kv, d)
            if (err == 0) != (want is not None) or (want is not None and tuple(got) != tuple(want)):
                raise AssertionError(f"K8 tiles at kv={kv} d={d}: kernel {tuple(got)} (error {err}), plan {want}")
    for d in range(8, 513, 8):  # the pair's tiles, at every head dim it takes
        for which, want in enumerate(attention.bwd_pair_tiles(d)):
            got = (ctypes.c_int * 7)()
            kernels.check(lib.fdt_flash_bwd_pair_tiles(which, d, got), "fdt_flash_bwd_pair_tiles")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K{6 + which} tiles at d={d}: kernel {tuple(got)}, plan {tuple(want)}")
    for d in range(8, 513, 8):  # K2's tiles at every head dim: the wgmma kernel's up to 128, the other's above
        want, got = attention.stream_fwd_tiles(d), (ctypes.c_int * 6)()
        err = lib.fdt_flash_fwd_wgmma_tiles(d, got)
        if (err == 0) != (want.route == "wgmma") or (err == 0 and tuple(got) != (
                want.dp, want.bq, want.bkv, want.stages, want.threads, want.smem)):
            raise AssertionError(f"K2 tiles at d={d}: kernel {tuple(got)} (error {err}), plan {want}")
    for m, k, n in FFN_SHAPES + FFN_RAGGED + FFN_DW_SHAPES:  # K10's plan, and every tile width it is built for
        for bn in (None, 112, 128, 160, 224, 256):
            want, got = gemm.gemm_plan(k, n, bn), (ctypes.c_int * 4)()
            kernels.check(lib.fdt_gemm_plan(k, n, bn or 0, got), "fdt_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K10 plan at K={k} N={n} bn={bn}: kernel {tuple(got)}, plan {tuple(want)}")
        for bn, cluster in ((None, None), (160, 1), (128, 1)):  # K12's plan, and its other built variants
            want, got = gemm.geglu_gemm_plan(k, n, bn, cluster), (ctypes.c_int * 5)()
            kernels.check(lib.fdt_geglu_gemm_plan(k, n, bn or 0, cluster or 0, got), "fdt_geglu_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K12 plan at K={k} N={n} ({bn}, {cluster}): kernel {tuple(got)}, plan {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, *_ in [(*s, False) for s in int8_main()] + int8_extra():  # K11's plan, here and on 132 SMs
        for on, split in [(c, None) for c in (sms, 132)] + [(sms, s) for s in (1, 2, 4, 8)]:
            want, got = gemm.int8_gemm_plan(m, k, n, on, split), (ctypes.c_int * 6)()
            kernels.check(lib.fdt_int8_gemm_plan(m, n, k, on, split or 0, got), "fdt_int8_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K11 plan at {(m, k, n)} on {on} SMs (split {split}): kernel {tuple(got)}, "
                                     f"plan {want}")
    spills = [line for line in spill_report if any(k in line for k in (
        "flash_fwd_oneshot_kernel", "flash_fwd_wgmma_kernel", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_oneshot_kernel", "gemm_sm90_kernel", "int8_gemm_kernel"))]
    spills += [line for line in serialized if any(k in line for k in (
        "flash_fwd_wgmma_kernel", "gemm_sm90_kernel", "int8_gemm_kernel"))]
    # instantiations that must have a report of their own, by their template
    # arguments: the packed K4 and K5 (<DP, kPacked = true> of K1's and K2's
    # kernels), K12 (<BN, kCluster, kGeglu = true> of K10's) and K11
    # (<kSplit>)
    own = [f"{kernel}ILi{dp}ELb1E" for kernel in ("flash_fwd_oneshot_kernel", "flash_fwd_wgmma_kernel")
           for dp in (64, 128)]
    own += [f"gemm_sm90_kernelILi{bn}ELi{c}ELb1E" for bn, c in ((160, 8), (160, 4), (160, 1), (128, 1))]
    own += [f"int8_gemm_kernelILb{split}E" for split in (0, 1)]
    missing = [name for name in own if kernels.BUILD_INFO["log"] != "(cached)" and name not in entries]
    if spills or missing:
        raise AssertionError(f"K1/K2/K4/K5/K6/K7/K8/K10/K11/K12 instantiations spill registers, or K2/K5/K10/K11/K12 "
                             f"serialize their wgmma: {spills}; no ptxas report of {missing}")

    results = {
        "flash_fwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention.cu",
                                     "flash_diffusion_tpu/ops/attention.py:171"),
        # D ≤ 128 on the wgmma kernel, above (the VAE's D = 512) on the mma.sync one
        "flash_fwd_stream": dict(new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                         "flash_diffusion_tpu/ops/attention.py:85"),
                                 source_above_d128="flash_diffusion_tpu_torch/csrc/flash_fwd_mma.cu"),
        "layer_norm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/layer_norm.cu",
                              "flash_diffusion_tpu/ops/norms.py:317"),
        # K4 and K5: K1's and K2's kernels instantiated on the packed layout
        "flash_fwd_oneshot_packed": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention.cu",
                                            "flash_diffusion_tpu/ops/attention.py:292"),
        "flash_fwd_packed": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                    "flash_diffusion_tpu/ops/attention.py:223"),
        "flash_bwd_dkv": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                 "flash_diffusion_tpu/ops/attention.py:635"),
        "flash_bwd_dq": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                "flash_diffusion_tpu/ops/attention.py:703"),
        "flash_bwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd_oneshot.cu",
                                     "flash_diffusion_tpu/ops/attention.py:769"),
        "gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/gemm_sm90.cu", "flash_diffusion_tpu/ops/gemm.py:36"),
        "int8_gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/int8_gemm.cu",
                             "flash_diffusion_tpu/ops/gemm.py:171"),
        # K12: K10's kernel with the GEGLU producer (kGeglu = true)
        "geglu_gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/gemm_sm90.cu",
                              "flash_diffusion_tpu/ops/gemm.py:271"),
        "group_norm_stats": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "flash_diffusion_tpu/ops/norms.py:40"),
        # the port's own fused normalize pass: no TPU kernel (JAX leaves
        # x·ŵ + b̂ to XLA, which fuses it into the next convolution)
        "group_norm_apply": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "none (XLA-fused in JAX: flash_diffusion_tpu/ops/norms.py:166)"),
        # the resident GroupNorm: K9's statistics with the fold and the apply
        # that JAX leaves to XLA, in one launch
        "group_norm_fused": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "flash_diffusion_tpu/ops/norms.py:40 (K9, with the fold and apply of "
                                    "norms.py:137-149)"),
    }
    # phase 2: kernels vs plain at the main paths' shapes
    check_attention(attention, results)
    check_packed(attention, results, "flash_fwd_oneshot_packed", PACKED_SHAPES, PACKED_RAGGED, 2)
    check_packed(attention, results, "flash_fwd_packed", PACKED_STREAM_SHAPES, PACKED_STREAM_RAGGED, 10)
    check_layer_norm(norms, results)
    check_group_norm(norms, results)
    check_attention_bwd(attention, kernels, results)
    check_int8_gemm(gemm, results)
    check_ffn_gemm(gemm, results)
    torch.cuda.empty_cache()
    mark("1, 2")

    # phases 3 and 4: the SD1.5 path through the user's entry point, then
    # its agreement with the fp32 plain reference on a small input
    counters = (attention.LAUNCHES, norms.LAUNCHES, gemm.LAUNCHES)
    gn = ("group_norm_stats", "group_norm_apply", "group_norm_fused")
    pipe = build_pipeline("sd15", device="cuda", seed=0)
    by_path = {"sd15": run_path(pipe, "sd15", 512, counters, card,
                                ("flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", *gn))[0]}
    check_reference(pipe, "sd15")
    del pipe
    torch.cuda.empty_cache()
    mark("3, 4")

    # phases 3b and 4b: the SDXL path, then its reference; 3c and 4c: the
    # same pipeline in the JAX package's opt-in kernel modes (K5 and K12,
    # then K10), then their references
    pipe = build_pipeline("sdxl", device="cuda", seed=0)
    by_path["sdxl"], images = run_path(pipe, "sdxl", 1024, counters, card,
                                       ("flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", *gn))
    check_reference(pipe, "sdxl")
    by_path.update(run_modes(pipe, images, counters, card))
    del images
    check_mode_references(pipe, counters)
    del pipe
    torch.cuda.empty_cache()
    mark("3b, 4b, 3c, 4c")

    # phases 5 and 5b: the SD1.5 training step through the user's entry
    # point, then its agreement with the fp32 plain reference on a small
    # input; 5c and 5d: the same for SDXL, whose launched shapes must all be
    # among phase 2's
    by_path["train"] = run_training("sd15", counters, card, (
        "flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_oneshot", *gn))
    torch.cuda.empty_cache()
    check_training_reference("sd15")
    torch.cuda.empty_cache()
    mark("5, 5b")
    by_path["train_sdxl"] = run_training("sdxl", counters, card, (
        "flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", "flash_bwd_dkv",
        "flash_bwd_dq", "flash_bwd_oneshot", *gn), gated_shapes())
    torch.cuda.empty_cache()
    check_training_reference("sdxl")
    torch.cuda.empty_cache()
    mark("5c, 5d")

    # phases 6 and 6b: SDXL served over HTTP in int8 with a merged LoRA,
    # then its agreement with the fp32 plain reference and batch invariance
    by_path["sdxl_int8_serve"], pipe = run_int8_serving(counters, card, (
        "flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", "int8_gemm", *gn))
    check_reference(pipe, "sdxl", "sdxl int8 + LoRA")
    check_batch_invariance(pipe)
    del pipe
    torch.cuda.empty_cache()
    mark("6, 6b")

    # phases 7 and 7b: Pixart-α 1024² (T5-XXL in fp32, the DiT), then its
    # references: T5 at full width and 2 layers, the DiT and VAE at full
    # size at 128² on the same T5 output; 7e: the same pipeline in int8,
    # then its reference
    pipe = build_pipeline("pixart", device="cuda", seed=0)
    by_path["pixart"] = run_path(pipe, "pixart", 1024, counters, card, ("flash_fwd_stream", "layer_norm", *gn))[0]
    check_pixart_reference(pipe)
    by_path["pixart_int8"] = run_int8_path(pipe, "pixart", PIXART_INT8_LAYERS, counters, card, (
        "flash_fwd_stream", "layer_norm", "int8_gemm", *gn), gated_shapes())
    check_pixart_reference(pipe, t5_check=False, label="pixart int8")
    del pipe
    torch.cuda.empty_cache()
    mark("7, 7b, 7e")

    # phases 7c and 7d: the Pixart training step through the user's entry
    # point, its launched shapes all among phase 2's, then its agreement
    # with the fp32 plain reference on a small input
    by_path["train_pixart"] = run_training("pixart", counters, card, (
        "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq", *gn), gated_shapes())
    torch.cuda.empty_cache()
    check_training_reference("pixart")
    torch.cuda.empty_cache()
    mark("7c, 7d")

    # phases 8, 8b and 8e: SD3-medium 1024² (CLIP-L + CLIP-G, the MMDiT with
    # its joint attention masked at kv_valid, the 16-channel VAE), its
    # references at 128² (the conditioner; the MMDiT and VAE at full size),
    # then the same pipeline in int8 and its reference; 8t: SD3 with T5-XXL
    pipe = build_pipeline("sd3", device="cuda", seed=0)
    by_path["sd3"] = run_path(pipe, "sd3", 1024, counters, card, ("flash_fwd_stream", "layer_norm", *gn))[0]
    check_gated("sd3", counters, gated_shapes())
    mark("8")
    check_reference(pipe, "sd3")
    mark("8b")
    by_path["sd3_int8"] = run_int8_path(pipe, "sd3", SD3_INT8_LAYERS, counters, card, (
        "flash_fwd_stream", "layer_norm", "int8_gemm", *gn), gated_shapes())
    check_reference(pipe, "sd3", "sd3 int8")
    del pipe
    torch.cuda.empty_cache()
    mark("8e")
    pipe = build_pipeline("sd3", device="cuda", seed=0, t5=True)
    by_path["sd3_t5"] = run_path(pipe, "sd3 t5", 1024, counters, card, ("flash_fwd_stream", "layer_norm", *gn))[0]
    check_gated("sd3 t5", counters, gated_shapes())
    del pipe
    torch.cuda.empty_cache()
    mark("8t")

    # phases 9 and 9b: the SD3 training step through the user's entry point
    # (the joint attention's backward masked at kv_valid 4250), its launched
    # shapes all among phase 2's, then its agreement with the fp32 plain
    # reference on a small input, whose launched shapes are gated too
    by_path["train_sd3"] = run_training("sd3", counters, card, (
        "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq", *gn), gated_shapes())
    torch.cuda.empty_cache()
    mark("9")
    check_training_reference("sd3", counters=counters, gated=gated_shapes())
    torch.cuda.empty_cache()
    mark("9b")

    # phase 10: the SD1.5 training run through the user's entry points
    # (shards, EMA, accumulation, validation, samples, checkpoint and
    # resume, the alternating mode, the LoRA export served), every launched
    # shape among phase 2's
    run_root = tempfile.TemporaryDirectory()
    train_kernels = ("flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq",
                     "flash_bwd_oneshot", *gn)
    by_path["train_run"] = run_training_run(counters, card, train_kernels, gated_shapes(), run_root.name)
    torch.cuda.empty_cache()
    mark("10")

    # phases 11 and 11b: the Canny T2I-Adapter run on phase 10's shards
    # (the Canny mapper in the data chain, the frozen adapter's residuals
    # in every UNet call), every launched shape among phase 2's, then its
    # step against the fp32 plain reference on a small input; 11c: the DPT
    # depth model against its fp32 copy, then the depth mapper over 512²
    # images, its K1 launches at 577 keys gated
    by_path["train_canny"] = run_canny_training(counters, card, train_kernels, gated_shapes(), run_root.name)
    torch.cuda.empty_cache()
    mark("11")
    check_training_reference("sd15-canny", counters=counters, gated=gated_shapes())
    torch.cuda.empty_cache()
    mark("11b")
    by_path["depth"] = check_depth(counters, card, ("flash_fwd_oneshot",), gated_shapes())
    torch.cuda.empty_cache()
    mark("11c")

    # phase 12: the eval path through eval_coco over phase 10's shards
    # (SD1.5 samples, CLIP-FID, Inception FID, CLIPScore), every launched
    # shape among phase 2's, then the extractors against their fp32 copies;
    # 12b: the toy distillation proofs at a few steps
    by_path["eval"] = run_eval(counters, card, ("flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", *gn),
                               gated_shapes(), run_root.name)
    run_root.cleanup()
    torch.cuda.empty_cache()
    mark("12")
    by_path["toy"] = run_toy(counters, card, ("flash_fwd_oneshot", "flash_bwd_oneshot", "layer_norm",
                                              "group_norm_fused"), gated_shapes())
    torch.cuda.empty_cache()
    mark("12b")

    print(f"every phase passed in {time.perf_counter() - started:.1f} s (the kernels' build included)")
    for name, r in results.items():
        r["launches"] = sum(n[name] for n in by_path.values())
        r["launches_by_path"] = {path: n[name] for path, n in by_path.items()}
        r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get)
    print(json.dumps({"kernels": [{"name": n, **r} for n, r in results.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
